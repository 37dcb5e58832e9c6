"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/lib<name>-<hash>.so`` at the repository root (listed in
``.gitignore``), where ``<hash>`` is the source's content hash, so a
stale library is never loaded. The libraries are bound with ``ctypes``;
nothing here includes PyTorch's headers, which keeps a build to seconds.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise FileNotFoundError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to: the hash covers the source and
    every header in ``csrc/``."""
    digest = hashlib.sha1()
    for fname in [f"{name}.cu"] + sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names):
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` each, all started together. Returns {name: {"seconds",
    "ptxas"}} for the sources it compiled; ``ptxas`` holds the register,
    shared-memory and spill report. Raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln]}
    return report


def kernel_info(name):
    """[{"kernel", "registers", "ctas_per_sm", "smem_bytes"}] of each
    kernel of ``csrc/<name>.cu`` on the current card (its
    ``r2l_kernel_info``: the CUDA occupancy calculator at the launch's
    threads and shared memory)."""
    lib = load(name)
    fn = lib.r2l_kernel_info
    i32p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int, i32p, i32p, i32p]
    fn.restype = ctypes.c_char_p
    out = []
    while True:
        regs, ctas, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        kname = fn(len(out), regs, ctas, smem)
        if kname is None:
            return out
        out.append({"kernel": kname.decode(), "registers": regs.value,
                    "ctas_per_sm": ctas.value, "smem_bytes": smem.value})


@functools.cache
def sm_count(index):
    """SMs of CUDA device ``index``: the grids of the kernels that walk
    their tiles with a fixed number of CTAs are sized from it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def load(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built on first use."""
    build([name])
    return ctypes.CDLL(library_path(name))
