"""What holds the ISP backward kernel's time on the card: a probe of
``csrc/fused_isp_bwd.cu`` through edited copies of its source.

    python3 -m raw2logit_tpu_torch.kernels.isp_bwd_probe [--batch 256]

It needs a CUDA device and nvcc. The copies are built into
``build/isp_bwd_probe/`` (nothing under ``csrc/`` changes), from seeded
256x256 mosaics through the residual forward. One JSON line each:

- ``stages``: an instrumented copy; thread 0 of every CTA adds the
  clock64 cycles of each stage of its walk (the wait for the copies, stages
  1-6, the flush and the loop) to a counter; cycles per tile by stage, for
  both variants. The instrumentation costs time of its own.
- ``ctas``: an instrumented copy that records each CTA's start and end
  (globaltimer) and SM: percentiles of the CTAs' durations, for the walk as
  built and for a walk with the stride of the grid.
- ``variants``: device ms of the residual and recompute variants (CUDA
  events, the mean of 10 launches after 2) as built and for each edited
  copy (``VARIANTS``), in turns, as built first and last.
- the card's name and power limit, as ``nvidia-smi`` gives them.
"""

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.kernels.build import (BUILD_DIR, CSRC, NVCC_FLAGS,
                                              _nvcc, sm_count)
from raw2logit_tpu_torch.kernels.fused_isp import _packed_on, fused_isp_train

SOURCE = os.path.join(CSRC, "fused_isp_bwd.cu")
OUT = os.path.join(BUILD_DIR, "isp_bwd_probe")

# The walk with the stride of the grid: CTA k takes tiles k, k + grid, ...
STRIDE_WALK = [
    ("  int t = first;\n", "  int t = blockIdx.x;\n"),
    ("  if (t < last) {", "  if (t < n_tiles) {"),
    ("  for (int n = 0; t < last; ++n, ++t) {",
     "  for (int n = 0; t < n_tiles; ++n, t += gridDim.x) {"),
    ("    const bool more = t + 1 < last;\n"
     "    const Tile nx = tile_at(more ? t + 1 : t, tiles_w, per_img);",
     "    const bool more = t + (int)gridDim.x < n_tiles;\n"
     "    const Tile nx = tile_at(more ? t + gridDim.x : t, tiles_w, "
     "per_img);"),
]
VARIANTS = {
    "stride_walk": STRIDE_WALK,
    # registers unbounded: one CTA per SM where they pass 128
    "no_min_ctas": [("__launch_bounds__(NTHREADS, CTAS_PER_SM)",
                     "__launch_bounds__(NTHREADS)")],
    "stage2_unroll2": [
        ("    const float inv_g = 1.0f / p[P_GAMMA];\n",
         "    const float inv_g = 1.0f / p[P_GAMMA];\n#pragma unroll 2\n")],
    "flush_every_tile": [("constexpr int FLUSH = 8;",
                          "constexpr int FLUSH = 1;")],
    "flush_every_16": [("constexpr int FLUSH = 8;",
                        "constexpr int FLUSH = 16;")],
}

_COUNTERS = '''#include "kernel_info.cuh"
__device__ unsigned long long g_probe[%d];
__device__ __forceinline__ unsigned long long probe_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int r2l_probe_read(unsigned long long* out, int reset) {
  static unsigned long long zero[%d];
  if (reset) return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
'''
N_STAGES = 8
MAX_CTAS = 4096
# thread 0's clock64 at each stage's end: 0 the wait for the copies, 1-6
# the stages, 7 the flush and the loop
_MARK = ("    if (threadIdx.x == 0) { long long now = clock64(); "
         "atomicAdd(&g_probe[%d], (unsigned long long)(now - mark)); "
         "mark = now; }\n")
STAGE_MARKS = [
    ('#include "kernel_info.cuh"\n', _COUNTERS % (N_STAGES, N_STAGES)),
    ("  for (int n = 0; t < last; ++n, ++t) {",
     "  long long mark = clock64();\n"
     "  for (int n = 0; t < last; ++n, ++t) {"),
    ("    cp_async_wait_all();\n    __syncthreads();\n",
     _MARK % 7 + "    cp_async_wait_all();\n    __syncthreads();\n"
     + _MARK % 0),
    *[(f"    // {k}. ", _MARK % (k - 1) + f"    // {k}. ")
      for k in range(2, 7)],
    ("    // Flush: the sums", _MARK % 6 + "    // Flush: the sums"),
]
# each CTA's start, end and SM
CTA_MARKS = [
    ('#include "kernel_info.cuh"\n', _COUNTERS % (3 * MAX_CTAS, 3 * MAX_CTAS)),
    ("  const int n_tiles = B * per_img;\n",
     "  const int n_tiles = B * per_img;\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned sm_id;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm_id));\n"
     "    g_probe[blockIdx.x] = probe_clock();\n"
     f"    g_probe[{2 * MAX_CTAS} + blockIdx.x] = sm_id;\n"
     "  }\n"),
    ("  for (int q = tid; q < N_PARTIALS; q += NTHREADS)\n    partials[",
     f"  if (threadIdx.x == 0) g_probe[{MAX_CTAS} + blockIdx.x] = "
     "probe_clock();\n"
     "  for (int q = tid; q < N_PARTIALS; q += NTHREADS)\n    partials["),
]


def edited(edits):
    src = open(SOURCE).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the probe's anchor occurs {src.count(old)} "
                               f"times in csrc/fused_isp_bwd.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build_all(copies):
    """{name: source} -> {name: ctypes handle}, one nvcc each, together."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, src in copies.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(OUT, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.r2l_fused_isp_bwd.argtypes = [p] * 6 + [i32] * 4 + [p]
        lib.r2l_fused_isp_bwd_ctas.argtypes = [i32] * 4
        libs[name] = lib
    return libs


class Launcher:
    """The kernel's arguments at B x 256 x 256: seeded mosaics, the default
    microscopy ISP, its residual planes and a positive cotangent."""

    def __init__(self, batch, seed=0):
        dev = torch.device("cuda")
        gen = torch.Generator(dev).manual_seed(seed)
        self.raw = torch.rand((batch, 256, 256), generator=gen, device=dev)
        params = ParametrizedProcessing(device=dev).kernel_params()
        with torch.no_grad():
            out, self.res = fused_isp_train(self.raw, params)
        self.g = (out * 0.5 + 0.1).contiguous()
        self.packed = _packed_on(self.raw, params)
        self.d_raw = torch.empty_like(self.raw)
        self.sms = sm_count(0)
        self.partials = None

    def __call__(self, lib, res=True):
        b, h, w = self.raw.shape
        ctas = lib.r2l_fused_isp_bwd_ctas(b, h, w, self.sms)
        if self.partials is None or self.partials.shape[0] < ctas:
            self.partials = torch.empty((ctas, 129), dtype=torch.float64,
                                        device=self.raw.device)
        rc = lib.r2l_fused_isp_bwd(
            self.raw.data_ptr(), self.g.data_ptr(),
            self.res.data_ptr() if res else None, self.packed.data_ptr(),
            self.d_raw.data_ptr(), self.partials.data_ptr(), b, h, w, ctas,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return ctas


def device_ms(launch, lib, res, n=10):
    for _ in range(2):
        launch(lib, res)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(n):
        launch(lib, res)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def read(lib, count):
    buf = (ctypes.c_ulonglong * count)()
    lib.r2l_probe_read(buf, 0)
    return np.array(buf, dtype=np.float64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    copies = {"as_built": edited([]), "stages": edited(STAGE_MARKS),
              "ctas": edited(CTA_MARKS),
              "ctas_stride_walk": edited(STRIDE_WALK + CTA_MARKS),
              **{name: edited(e) for name, e in VARIANTS.items()}}
    libs = build_all(copies)
    launch = Launcher(args.batch)
    tiles = args.batch * 64

    for res in (True, False):
        lib = libs["stages"]
        launch(lib, res)
        torch.cuda.synchronize()
        lib.r2l_probe_read(None, 1)
        ms = device_ms(launch, lib, res, n=5)
        cycles = read(lib, N_STAGES) / (7 * tiles)  # 2 warm-up + 5 timed
        print(json.dumps({
            "probe": "stages", "variant": "res" if res else "recompute",
            "batch": args.batch, "instrumented_ms": ms,
            "cycles_per_tile": dict(zip(
                ("wait", "s1", "s2", "s3", "s4", "s5", "s6", "flush_loop"),
                cycles.round(1).tolist())),
            "share": (cycles / cycles.sum()).round(4).tolist()}), flush=True)

    for name in ("ctas", "ctas_stride_walk"):
        lib = libs[name]
        ctas = launch(lib)
        torch.cuda.synchronize()
        buf = read(lib, 3 * MAX_CTAS)
        start, end = buf[:ctas], buf[MAX_CTAS:MAX_CTAS + ctas]
        sm = buf[2 * MAX_CTAS:2 * MAX_CTAS + ctas].astype(int)
        dur = (end - start) / 1e6
        print(json.dumps({
            "probe": "ctas", "walk": name, "batch": args.batch,
            "ctas": ctas, "span_ms": float((end.max() - start.min()) / 1e6),
            "latest_start_ms": float((start.max() - start.min()) / 1e6),
            "duration_ms_percentiles_0_25_50_75_100":
                np.percentile(dur, [0, 25, 50, 75, 100]).round(4).tolist(),
            "ctas_per_sm_max": int(np.bincount(sm).max())}), flush=True)

    names = ["as_built", *VARIANTS, "as_built"]
    timed = {name: [] for name in names}
    for name in names:
        timed[name].append({"res_ms": device_ms(launch, libs[name], True),
                            "recompute_ms": device_ms(launch, libs[name],
                                                      False)})
    print(json.dumps({"probe": "variants", "batch": args.batch,
                      "ms": timed}), flush=True)


if __name__ == "__main__":
    main()
