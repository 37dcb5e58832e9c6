"""Where the stem's bfloat16 conv forward and BN-pool (``csrc/stem.cu``
sections 6c and 6d) spend their time.

Builds edited copies of ``csrc/stem.cu`` into
``build/stem_fwd_variants/`` (one nvcc each, all started together) and
calls their C interface directly. Prints one JSON line per batch in
``--batches``, 256x256: CUDA-event ms of this checkout's conv forward
(with and without the statistics) and BN-pool and of each variant's, in
turns (this, variant, variant, this), whether each variant's act or
pooled is bitwise this checkout's, and the card's name and power limit.
The variants:

- ``no_store``: the conv forward stores no act (the statistics stay);
- ``word_stores``: act stored a word at a time from the MMA fragment,
  not staged into 16-byte rows;
- ``no_mma``: each MMA of the conv forward replaced by moves of its
  operands;
- ``one_cta``: one CTA of the conv forward per SM (two in this checkout);
- ``bp_ctas_2``, ``bp_ctas_8``: BN-pool's grid at 2 or 8 CTAs per SM
  (4 in this checkout);
- ``bp_ch_32``: BN-pool's units of 32 window rows (8 here).

    python tools/stem_bf16_fwd_variants.py

Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402
from raw2logit_tpu_torch.kernels import build as kbuild  # noqa: E402
from stem_bf16_ab import card_power, forward_operands  # noqa: E402

OUT_DIR = os.path.join(kbuild.BUILD_DIR, "stem_fwd_variants")
P, I32 = ctypes.c_void_p, ctypes.c_int
BF16 = torch.bfloat16

_MMA = """          if (s == 0)
            mma_bf16(acc[mt][nt], a[mt], b0, b1);
          else
            mma_bf16_acc(acc[mt][nt], a[mt], b0, b1);"""
# name: [(text of csrc/stem.cu, replacement)]
EDITS = {
    "no_store": [("""        const int v = ox0 + 8 * n;
        if (v < Wo)""", """        const int v = ox0 + 8 * n;
        if (v < 0)""")],
    "word_stores": [("vec_out = flags & 2;", "vec_out = false;")],
    "no_mma": [(_MMA, """#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mt][nt][q] =
                (s == 0 ? 0.f : acc[mt][nt][q]) +
                __uint_as_float(a[mt][q] ^ (q & 1 ? b1 : b0));""")],
    "one_cta": [("constexpr int CFM_CTAS = 2;",
                 "constexpr int CFM_CTAS = 1;")],
    **{f"bp_ctas_{n}": [("constexpr int BP_CTAS = 4;",
                         f"constexpr int BP_CTAS = {n};")] for n in (2, 8)},
    "bp_ch_32": [("constexpr int BP_CH = 8;", "constexpr int BP_CH = 32;")],
}
FORWARD = ("no_store", "word_stores", "no_mma", "one_cta")


def emit(row):
    print(json.dumps(row), flush=True)


def build_all(names):
    """{name: ctypes handle}: this checkout's stem.cu edited by EDITS[name]
    ("this" unedited)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(kbuild.CSRC, "stem.cu")) as fh:
        src = fh.read()
    sources = {"this": src}
    for name in names:
        text = src
        for old, new in EDITS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit does not apply: {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", kbuild.CSRC, "-o",
               lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        emit({"build": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                       if "Used" in ln or "spill" in ln]})
        lib = ctypes.CDLL(path)
        lib.r2l_stem_conv_fwd.argtypes = [P, P, P, P] + [I32] * 5 + [P]
        lib.r2l_stem_bnpool.argtypes = [P, P, P] + [I32] * 4 + [P]
        lib.r2l_stem_ctas.argtypes = [I32] * 5
        libs[name] = lib
    return libs


def forms(lib, device):
    """(conv forward (x, w, stats) -> act, BN-pool (act, alpha, shift) ->
    pooled) through ``lib``'s C interface."""
    sms = kbuild.sm_count(device.index or 0)
    stream = torch.cuda.current_stream(device).cuda_stream

    def fwd(x, w, stats=True):
        b, _, h, wd = x.shape
        ctas = lib.r2l_stem_ctas(5, b, h, wd, sms)
        act = torch.empty((b, 64, h // 2, wd // 2), dtype=BF16,
                          device=device)
        part = (torch.empty((ctas, 2, 64), dtype=torch.float64,
                            device=device) if stats else None)
        if lib.r2l_stem_conv_fwd(x.data_ptr(), w.data_ptr(), act.data_ptr(),
                                 None if part is None else part.data_ptr(),
                                 b, h, wd, ctas, 1, stream):
            raise RuntimeError("conv forward launch failed")
        return act

    def bnpool(act, alpha, shift):
        b, _, ho, wo = act.shape
        out = torch.empty((b, 64, ho // 2, wo // 2), dtype=BF16,
                          device=device)
        cf = torch.stack([alpha, shift]).contiguous()
        if lib.r2l_stem_bnpool(act.data_ptr(), cf.data_ptr(), out.data_ptr(),
                               b, ho, wo, 1, stream):
            raise RuntimeError("BN-pool launch failed")
        return out

    return fwd, bnpool


def times(libs, device, batch, iters):
    x, w, act, _, _, (alpha, shift) = forward_operands(
        device, (batch, 3, cs.SIZE, cs.SIZE))
    one = [None]
    row = {"batch": batch, "card": card_power()}
    this_fwd, this_pool = forms(libs["this"], device)
    want_act, want_pool = this_fwd(x, w), this_pool(act, alpha, shift)
    row["this"] = {
        "fwd_ms": cs.cuda_ms(lambda _: this_fwd(x, w), one, iters),
        "fwd_no_stats_ms": cs.cuda_ms(lambda _: this_fwd(x, w, False), one,
                                      iters),
        "bnpool_ms": cs.cuda_ms(lambda _: this_pool(act, alpha, shift), one,
                                iters)}
    for name, lib in libs.items():
        if name == "this":
            continue
        fwd, pool = forms(lib, device)
        conv = name in FORWARD
        run, this_run = ((lambda _: fwd(x, w)), (lambda _: this_fwd(x, w))
                         ) if conv else (
            (lambda _: pool(act, alpha, shift)),
            (lambda _: this_pool(act, alpha, shift)))
        got = {"this": [], name: []}
        for which, f in (("this", this_run), (name, run), (name, run),
                         ("this", this_run)):
            got[which].append(cs.cuda_ms(f, one, iters))
        same = (torch.equal(fwd(x, w), want_act) if conv
                else torch.equal(pool(act, alpha, shift), want_pool))
        row[name] = {"ms": got, "bitwise_this": same}
    emit(row)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[cs.SERVE_BATCH, cs.BIG_BATCH])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_all(list(EDITS))
    for b in args.batches:
        times(libs, device, b, args.iters)


if __name__ == "__main__":
    main()
