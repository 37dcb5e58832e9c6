"""Where the stem's bfloat16 dW and d_x (``csrc/stem.cu`` section 6) spend
their time, why they sum as they do, and how the tensor core rounds.

Builds edited copies of ``csrc/stem.cu`` into ``build/stem_variants/``
(one nvcc each, all started together) and calls their C interface
directly. Prints one JSON line per result:

- ``rounding``: mma.sync m16n8k16 bf16 -> float32 on chosen products: the
  sum 1 + 0.75 ulp, its negative, 1 - 2^-26 and 1 + 15 x 2^-26, exact
  and as the tensor core returns them;
- ``precision``: dW and d_x of this checkout and of the variants that
  change how they sum (``dw_chained``: dW's four k16 steps of a stage
  chained in the tensor core; ``dx_fresh``: d_x's taps each with a fresh
  accumulator), against the plain version and a float64 witness as
  ``chip_smoke.stem_bf16_agreement`` holds them (the ratio of distances
  from float64, at most STEM_F64_FACTOR), at ``--shapes``, on the ISP's
  outputs and on random inputs with planted ties;
- ``times``: CUDA-event ms at B = ``--batch``, 256x256, of this checkout
  and of each variant in turns (this, variant, variant, this), the
  variants above and ``no_formation`` (d_a is act, no BN arithmetic),
  ``no_mma`` (each MMA replaced by moves of its operands) and
  ``no_mma_adds`` (MMA results overwrite the sums, so nothing waits on
  them), with the card's name and power limit.

    python tools/stem_bf16_variants.py

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
from raw2logit_tpu_torch.kernels.stem import (  # noqa: E402
    batch_stats, bn_backward_coef, bn_fold, bn_input_cotangent, rounded,
    stem_bnpool, stem_conv, stem_conv_dw_reference, stem_conv_dx_reference,
    stem_pool_bwd)
from raw2logit_tpu_torch.ops.filters import full_float32  # noqa: E402
from stem_bf16_ab import card_power, operands  # noqa: E402

OUT_DIR = os.path.join(kbuild.BUILD_DIR, "stem_variants")
P, I32 = ctypes.c_void_p, ctypes.c_int

_FRESH_DW = """            float d[4];
            if (kNearest)
              mma_bf16_nearest(d, a[mi], b0, b1);
            else
              mma_bf16(d, a[mi], b0, b1);
            add4(st[mi][j], d, ks == 0);"""
_CHAINED_DX = """          if (sy == 0) {
            mma_bf16(acc[mi][0], a, bq[0], bq[1]);
            mma_bf16(acc[mi][1], a, bq[2], bq[3]);
          } else {
            mma_bf16_acc(acc[mi][0], a, bq[0], bq[1]);
            mma_bf16_acc(acc[mi][1], a, bq[2], bq[3]);
          }"""
_COT = "bn_input_cotangent(a2.{0}, n2.{0}, g1, c1, c2, mu, inv)"
_COT_DX = ("bn_input_cotangent(a2.{0}, n2.{0}, g1[q + h], c1[q + h],\n"
           "                                           c2[q + h], mu[q + h],"
           " inv[q + h])")
# name: [(text of csrc/stem.cu, replacement)]
EDITS = {
    "dw_chained": [(_FRESH_DW, """            float d[4];
            if (kNearest) {
              mma_bf16_nearest(d, a[mi], b0, b1);
              add4(st[mi][j], d, ks == 0);
            } else if (ks == 0) {
              mma_bf16(st[mi][j], a[mi], b0, b1);
            } else {
              mma_bf16_acc(st[mi][j], a[mi], b0, b1);
            }""")],
    "dx_fresh": [(_CHAINED_DX, """          float d0[4], d1[4];
          mma_bf16(d0, a, bq[0], bq[1]);
          mma_bf16(d1, a, bq[2], bq[3]);
          add4(acc[mi][0], d0, sy == 0);
          add4(acc[mi][1], d1, sy == 0);""")],
    "no_formation": [(_COT.format(c), f"a2.{c}") for c in "xy"]
                    + [(_COT_DX.format(c), f"a2.{c}") for c in "xy"],
    "no_mma": [(_FRESH_DW, """            float d[4] = {__uint_as_float(b0), __uint_as_float(b1),
                          __uint_as_float(a[mi][0] ^ a[mi][3]),
                          __uint_as_float(a[mi][1] ^ a[mi][2])};
            add4(st[mi][j], d, ks == 0);"""),
               (_CHAINED_DX, """          for (int nh = 0; nh < 2; ++nh)
            for (int q = 0; q < 4; ++q)
              acc[mi][nh][q] = (sy == 0 ? 0.f : acc[mi][nh][q]) +
                               __uint_as_float(a[q] ^ bq[2 * nh + q % 2]);""")],
    "no_mma_adds": [(_FRESH_DW, _FRESH_DW.replace("ks == 0);", "true);")),
                    (_CHAINED_DX, _CHAINED_DX.replace("if (sy == 0)",
                                                      "if (true)"))],
}
PRECISION = ("dw_chained", "dx_fresh")

PROBE = r"""
#include <cuda_bf16.h>
// one m16n8k16: a (16 x 16) and b (16 x 8) bf16 row-major, d (16 x 8)
__global__ void probe(const __nv_bfloat16* A, const __nv_bfloat16* B,
                      float* D, int n) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int c = blockIdx.x; c < n; c += gridDim.x) {
    const __nv_bfloat16* a = A + c * 256;
    const __nv_bfloat16* b = B + c * 128;
    auto pk = [](__nv_bfloat16 lo, __nv_bfloat16 hi) {
      __nv_bfloat162 v; v.x = lo; v.y = hi;
      return *reinterpret_cast<unsigned*>(&v); };
    unsigned a0 = pk(a[g * 16 + 2 * t], a[g * 16 + 2 * t + 1]);
    unsigned a1 = pk(a[(g + 8) * 16 + 2 * t], a[(g + 8) * 16 + 2 * t + 1]);
    unsigned a2 = pk(a[g * 16 + 2 * t + 8], a[g * 16 + 2 * t + 9]);
    unsigned a3 = pk(a[(g + 8) * 16 + 2 * t + 8],
                     a[(g + 8) * 16 + 2 * t + 9]);
    unsigned b0 = pk(b[(2 * t) * 8 + g], b[(2 * t + 1) * 8 + g]);
    unsigned b1 = pk(b[(2 * t + 8) * 8 + g], b[(2 * t + 9) * 8 + g]);
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    float* d = D + c * 128;
    d[g * 8 + 2 * t] = d0; d[g * 8 + 2 * t + 1] = d1;
    d[(g + 8) * 8 + 2 * t] = d2; d[(g + 8) * 8 + 2 * t + 1] = d3;
  }
}
extern "C" int run_probe(const void* A, const void* B, void* D, int n) {
  probe<<<n, 32>>>((const __nv_bfloat16*)A, (const __nv_bfloat16*)B,
                   (float*)D, n);
  return (int)cudaDeviceSynchronize();
}
"""


def emit(row):
    print(json.dumps(row), flush=True)


def build_all(names):
    """{name: ctypes handle}: this checkout's stem.cu edited by EDITS[name]
    ("this" unedited) and the rounding probe ("probe")."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(kbuild.CSRC, "stem.cu")) as fh:
        src = fh.read()
    sources = {"probe": PROBE, "this": src}
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
        lib = ctypes.CDLL(path)
        if name == "probe":
            lib.run_probe.argtypes = [P, P, P, I32]
        else:
            lib.r2l_stem_conv_dw.argtypes = [P, P, P, P, P] + [I32] * 5 + [P]
            lib.r2l_stem_conv_dx.argtypes = [P, P, P, P, P] + [I32] * 5 + [P]
            lib.r2l_stem_ctas.argtypes = [I32] * 5
        libs[name] = lib
    return libs


def rounding(lib, device):
    u = 2.0 ** -23
    cases = {"1+0.75ulp": [1, 0.75 * u], "-1-0.75ulp": [-1, -0.75 * u],
             "1-2^-25": [1, -2.0 ** -25], "1-2^-26": [1, -2.0 ** -26],
             "1+15x2^-26": [1] + [2.0 ** -26] * 15}
    n = len(cases)
    a = torch.zeros(n, 16, 16)
    b = torch.zeros(n, 16, 8)
    for i, terms in enumerate(cases.values()):
        a[i, 0, :len(terms)] = torch.tensor(terms, dtype=torch.float64).float()
        b[i, :len(terms), 0] = 1.0
    ab, bb = a.bfloat16(), b.bfloat16()
    if not (torch.equal(ab.float(), a) and torch.equal(bb.float(), b)):
        raise RuntimeError("probe terms are not bfloat16")
    ab, bb = ab.to(device), bb.to(device)
    d = torch.empty(n, 16, 8, device=device)
    if lib.run_probe(ab.data_ptr(), bb.data_ptr(), d.data_ptr(), n) != 0:
        raise RuntimeError("probe launch failed")
    for (name, terms), got in zip(cases.items(), d[:, 0, 0].tolist()):
        exact = sum(terms)
        emit({"rounding": name, "exact": exact.hex(), "tensor_core":
              got.hex(), "float32_nearest": float(torch.tensor(
                  exact, dtype=torch.float64).float()).hex()})


def forms(lib, device):
    sms = kbuild.sm_count(device.index or 0)

    def stream():
        return torch.cuda.current_stream(device).cuda_stream

    def coefs(coef):
        return torch.stack([c.reshape(64) for c in coef]).contiguous()

    def dw(x, act, d_n, coef):
        b, _, h, w = x.shape
        ctas = lib.r2l_stem_ctas(2, b, h, w, sms)
        part = torch.empty((ctas, 64 * 147), device=device)
        cf = coefs(coef)
        if lib.r2l_stem_conv_dw(x.data_ptr(), act.data_ptr(), d_n.data_ptr(),
                                cf.data_ptr(), part.data_ptr(), b, h, w, ctas,
                                1, stream()):
            raise RuntimeError("dW launch failed")
        return part.double().sum(0).float().reshape(64, 3, 7, 7)

    def dx(act, d_n, coef, w):
        b, _, ho, wo = act.shape
        ctas = lib.r2l_stem_ctas(4, b, 2 * ho, 2 * wo, sms)
        out = torch.empty((b, 3, 2 * ho, 2 * wo), device=device)
        cf = coefs(coef)
        if lib.r2l_stem_conv_dx(act.data_ptr(), d_n.data_ptr(),
                                cf.data_ptr(), w.data_ptr(), out.data_ptr(),
                                b, 2 * ho, 2 * wo, ctas, 1, stream()):
            raise RuntimeError("d_x launch failed")
        return out

    return dw, dx


def precision(libs, device, shapes):
    """Each form's distance from float64 over the plain version's, with
    chip_smoke.stem_bf16_agreement's inputs (act quantised with ties on
    the random inputs, the seeded pooled cotangent)."""
    bf16 = torch.bfloat16
    w, gamma, beta = cs.stem_params(device)
    for shape in shapes:
        for inputs, ties in (("isp", False), ("random", True)):
            x = cs.stem_input(device, shape, inputs)
            with torch.no_grad():
                act, s1, s2 = stem_conv(x, w, dtype=bf16)
                n = act.numel() // 64
                mean, var = batch_stats(s1, s2, n)
                inv, alpha, shift = bn_fold(gamma, beta, mean, var)
                if ties:
                    act = (torch.round(act.float() * 8) / 8).to(bf16)
                pooled = stem_bnpool(act, alpha, shift)
                gen = torch.Generator(device).manual_seed(cs.SEED)
                dp = torch.randn(pooled.shape, device=device,
                                 generator=gen).to(bf16)
                d_n, sd, sdx = stem_pool_bwd(act, dp, alpha, shift, mean,
                                                inv)
                coef = bn_backward_coef(gamma, mean, inv, sd, sdx, n)
            d_a = rounded(bn_input_cotangent(act.float(), d_n.float(),
                                                   coef), bf16).double()
            b, _, h, wd = x.shape
            with full_float32():
                dw64 = torch.nn.grad.conv2d_weight(
                    rounded(x, bf16).double(), (64, 3, 7, 7), d_a,
                    stride=2, padding=3)
                dx64 = torch.nn.grad.conv2d_input(
                    (b, 3, h, wd), rounded(w, bf16).double(), d_a,
                    stride=2, padding=3)
            plain = (stem_conv_dw_reference(x, act, d_n, coef),
                     stem_conv_dx_reference(act, d_n, coef, w))
            row = {"precision": list(shape), "inputs": inputs}
            for name, lib in libs.items():
                dw, dx = forms(lib, device)
                got = (dw(x, act, d_n, coef), dx(act, d_n, coef, w))
                ratios = []
                for g, p, wit in zip(got, plain, (dw64, dx64)):
                    stats, _ = cs.grad_agreement(g, g, p, wit)
                    ratios.append(stats["vs_float64"]
                                  / stats["plain_vs_float64"])
                row[name] = {"dw": ratios[0], "dx": ratios[1]}
            emit(row)


def times(libs, device, batch, iters):
    x, w, act, d_n, coef = operands(device, (batch, 3, cs.SIZE, cs.SIZE))
    one = [None]
    row = {"times": batch, "card": card_power()}
    this_dw, this_dx = forms(libs["this"], device)
    for name, lib in libs.items():
        if name == "this":
            continue
        dw, dx = forms(lib, device)
        got = {}
        for which, f_dw, f_dx in (("this", this_dw, this_dx),
                                  (name, dw, dx), (name, dw, dx),
                                  ("this", this_dw, this_dx)):
            got.setdefault(which, {"dw": [], "dx": []})
            got[which]["dw"].append(cs.cuda_ms(
                lambda _: f_dw(x, act, d_n, coef), one, iters))
            got[which]["dx"].append(cs.cuda_ms(
                lambda _: f_dx(act, d_n, coef, w), one, iters))
        row[name] = got
    emit(row)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="32,3,256,256;2,3,72,40;1,3,4,8;"
                    "1,3,36,68;4,3,64,64")
    ap.add_argument("--batch", type=int, default=cs.BIG_BATCH)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_all(list(EDITS))
    rounding(libs.pop("probe"), device)
    shapes = [tuple(int(v) for v in s.split(","))
              for s in args.shapes.split(";") if s]
    precision({k: libs[k] for k in ("this", *PRECISION)}, device, shapes)
    times(libs, device, args.batch, args.iters)


if __name__ == "__main__":
    main()
