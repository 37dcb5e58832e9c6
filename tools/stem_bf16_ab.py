"""The stem's bfloat16 forms on the card: this checkout's kernels against
another checkout's (a parent commit) on the same inputs, in one process,
on one card.

Builds ``<parent>/raw2logit_tpu_torch/csrc/stem.cu`` with nvcc into
``build/parent/`` and calls its C interface directly (its conv forward
grid kernel id 0, its dW partials two rows per CTA, its d_x grid kernel
id 3, as the wrapper of that time called them); this checkout's forms run
through the wrappers of ``kernels/stem.py``. Prints one JSON line per
check and per timing:

- check: this checkout's five bfloat16 forms against their plain versions
  and float64 witnesses under ``chip_smoke.stem_bf16_agreement``'s gates
  at ``--check-shapes``, on the ISP's outputs and on random inputs with
  planted ties; and the parent's BN-pool bitwise equal to this one's;
- times: CUDA-event ms of both checkouts' conv forward, BN-pool, dW and
  d_x, and of the nearest library call in bfloat16 (``F.conv2d``,
  cuDNN's wgrad and dgrad by ``aten.convolution_backward``; none for
  BN-pool) at B in ``--batches``, 256x256, in turns parent, this, this,
  parent, with the card's name and power limit.

    python tools/stem_bf16_ab.py --parent build/parent_tree

Exits 1 if a check fails. Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from chip_smoke import (BF16, SIZE, cuda_ms, stem_bf16_agreement,  # noqa: E402
                        stem_input, stem_params)
from raw2logit_tpu_torch.kernels import build as kbuild  # noqa: E402
from raw2logit_tpu_torch.kernels.stem import (  # noqa: E402
    bn_backward_coef, bn_fold, bn_input_cotangent, batch_stats, stem_bnpool,
    stem_conv, stem_conv_dw, stem_conv_dx, stem_pool_bwd)

C_OUT, TAPS = 64, 147


def emit(row):
    print(json.dumps(row), flush=True)


def card_power():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def parent_library(tree):
    """ctypes handle of the parent checkout's stem.cu, built here."""
    src = os.path.join(tree, "raw2logit_tpu_torch", "csrc", "stem.cu")
    out_dir = os.path.join(kbuild.BUILD_DIR, "parent")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libstem.so")
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.r2l_stem_conv_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                      i32, ptr]
    lib.r2l_stem_bnpool.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.r2l_stem_conv_dw.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     i32, i32, ptr]
    lib.r2l_stem_conv_dx.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     i32, i32, ptr]
    lib.r2l_stem_ctas.argtypes = [i32, i32, i32, i32, i32]
    for fn in (lib.r2l_stem_conv_fwd, lib.r2l_stem_bnpool,
               lib.r2l_stem_conv_dw, lib.r2l_stem_conv_dx,
               lib.r2l_stem_ctas):
        fn.restype = i32
    return lib


def parent_forms(lib, device):
    """{form: callable} of the parent's bfloat16 conv forward, BN-pool, dW
    and d_x, called as this checkout's wrappers are."""
    sms = kbuild.sm_count(device.index or 0)

    def stream():
        return torch.cuda.current_stream(device).cuda_stream

    def fwd(x, w):
        b, _, h, wd = x.shape
        ctas = lib.r2l_stem_ctas(0, b, h, wd, sms)
        act = torch.empty((b, C_OUT, h // 2, wd // 2), dtype=BF16,
                          device=device)
        part = torch.empty((ctas, 2, C_OUT), dtype=torch.float64,
                           device=device)
        rc = lib.r2l_stem_conv_fwd(x.data_ptr(), w.data_ptr(), act.data_ptr(),
                                   part.data_ptr(), b, h, wd, ctas, 1,
                                   stream())
        assert rc == 0, rc
        return act, part.sum(0)

    def bnpool(act, alpha, shift):
        b, _, ho, wo = act.shape
        out = torch.empty((b, C_OUT, ho // 2, wo // 2), dtype=BF16,
                          device=device)
        cf = torch.stack([alpha, shift]).contiguous()
        rc = lib.r2l_stem_bnpool(act.data_ptr(), cf.data_ptr(),
                                 out.data_ptr(), b, ho, wo, 1, stream())
        assert rc == 0, rc
        return out

    def dw(x, act, d_n, coef):
        b, _, h, w = x.shape
        ctas = lib.r2l_stem_ctas(2, b, h, w, sms)
        part = torch.empty((2 * ctas, C_OUT * TAPS), dtype=torch.float32,
                           device=device)
        cf = torch.stack([c.reshape(C_OUT) for c in coef]).contiguous()
        rc = lib.r2l_stem_conv_dw(x.data_ptr(), act.data_ptr(),
                                  d_n.data_ptr(), cf.data_ptr(),
                                  part.data_ptr(), b, h, w, ctas, 1, stream())
        assert rc == 0, rc
        return part.double().sum(0).float().reshape(C_OUT, 3, 7, 7)

    def dx(act, d_n, coef, w):
        b, _, ho, wo = act.shape
        ctas = lib.r2l_stem_ctas(3, b, 2 * ho, 2 * wo, sms)
        out = torch.empty((b, 3, 2 * ho, 2 * wo), dtype=torch.float32,
                          device=device)
        cf = torch.stack([c.reshape(C_OUT) for c in coef]).contiguous()
        rc = lib.r2l_stem_conv_dx(act.data_ptr(), d_n.data_ptr(),
                                  cf.data_ptr(), w.data_ptr(),
                                  out.data_ptr(), b, 2 * ho, 2 * wo, ctas, 1,
                                  stream())
        assert rc == 0, rc
        return out

    return {"fwd": fwd, "bnpool": bnpool, "dw": dw, "dx": dx}


THIS = {"fwd": lambda x, w: stem_conv(x, w, dtype=BF16),
        "bnpool": stem_bnpool, "dw": stem_conv_dw, "dx": stem_conv_dx}


def operands(device, shape, inputs="random"):
    """x, w, and the bfloat16 act, d_n and coefficients of the backward,
    as ``chip_smoke.stem_bf16_agreement`` makes them."""
    x, w, act, d_n, coef, _ = forward_operands(device, shape, inputs)
    return x, w, act, d_n, coef


def forward_operands(device, shape, inputs="random"):
    """``operands`` and the BN-pool's (alpha, shift)."""
    w, gamma, beta = stem_params(device)
    x = stem_input(device, shape, inputs)
    with torch.no_grad():
        act, s1, s2 = stem_conv(x, w, dtype=BF16)
        n = act.numel() // C_OUT
        mean, var = batch_stats(s1, s2, n)
        inv, alpha, shift = bn_fold(gamma, beta, mean, var)
        pooled = stem_bnpool(act, alpha, shift)
        gen = torch.Generator(device).manual_seed(0)
        dp = torch.randn(pooled.shape, device=device, generator=gen).to(BF16)
        d_n, sd, sdx = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
        coef = bn_backward_coef(gamma, mean, inv, sd, sdx, n)
    return x, w, act, d_n, coef, (alpha, shift)


def check(device, shapes, parent):
    ok_all = True
    w, gamma, beta = stem_params(device)
    for shape in shapes:
        for inputs, ties in (("isp", False), ("random", True)):
            x = stem_input(device, shape, inputs)
            for name, (stats, ok) in stem_bf16_agreement(
                    x, w, gamma, beta, ties).items():
                ok_all &= ok
                emit({"check": name, "shape": list(shape), "inputs": inputs,
                      "ok": ok, **stats})
            _, _, act, _, _, (alpha, shift) = forward_operands(
                device, shape, inputs)
            same = torch.equal(parent["bnpool"](act, alpha, shift),
                               stem_bnpool(act, alpha, shift))
            ok_all &= same
            emit({"check": "bnpool_parent_bitwise", "shape": list(shape),
                  "inputs": inputs, "ok": same})
            del x, act
    return ok_all


def times(device, batches, parent, iters):
    for b in batches:
        x, w, act, d_n, coef, (alpha, shift) = forward_operands(
            device, (b, 3, SIZE, SIZE))
        d_a = bn_input_cotangent(act.float(), d_n.float(), coef).to(BF16)
        xb, wb = x.to(BF16), w.to(BF16)
        one = [None]
        args = {"fwd": (x, w), "bnpool": (act, alpha, shift),
                "dw": (x, act, d_n, coef), "dx": (act, d_n, coef, w)}
        library = {
            "fwd": lambda _: torch.nn.functional.conv2d(xb, wb, stride=2,
                                                        padding=3),
            "bnpool": None,
            "dw": lambda _: torch.ops.aten.convolution_backward(
                d_a, xb, wb, None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1,
                [False, True, False]),
            "dx": lambda _: torch.ops.aten.convolution_backward(
                d_a, xb, wb, None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1,
                [True, False, False])}
        row = {"batch": b, "card": card_power()}
        with torch.no_grad():
            for name, a in args.items():
                runs = {"parent": lambda _, f=parent[name], a=a: f(*a),
                        "this": lambda _, f=THIS[name], a=a: f(*a)}
                got = {k: [] for k in runs}
                for which in ("parent", "this", "this", "parent"):
                    got[which].append(cuda_ms(runs[which], one, iters))
                lib = library[name]
                row[name] = {**got, "library_ms": (
                    None if lib is None else cuda_ms(lib, one, iters))}
        emit({"times": row})
        del x, act, d_n, d_a, xb


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--batches", type=int, nargs="*", default=[32, 256])
    ap.add_argument("--check-shapes", default="1,3,4,8;3,3,68,44;"
                    "2,3,100,140;1,3,36,68;1,3,68,96;32,3,256,256")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"build": kbuild.build(["stem"]),
          "occupancy": kbuild.kernel_info("stem")})
    parent = parent_forms(parent_library(args.parent), device)
    shapes = [tuple(int(v) for v in s.split(","))
              for s in args.check_shapes.split(";") if s]
    ok = check(device, shapes, parent)
    times(device, args.batches, parent, args.iters)
    emit({"ok": ok})
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
