"""The benchmark of the PyTorch and CUDA port (``raw2logit_tpu_torch``)
on NVIDIA GPUs: one run of one cell.

    python3 h100_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix (``spec.py``), makes the
weights and inputs on the device from the seed, builds the port's
modules and step, warms up, measures for ``--seconds`` (``--trace 1``:
a short traced window instead, read into the per-layer metrics), then
compares what the timed path produced with the plain reference
(``reference/``) and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each compared number beside its limit (also the
last lines of standard error).

Exits non-zero without printing a result where there is no CUDA device,
fewer devices than the cell asks for, or where JAX, one of its
libraries or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed cache directories inside the checkout: only a checkout's first
# run of a cell builds and compiles
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(_var, os.path.join(ROOT, "build", "h100_bench",
                                             _sub))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from h100_bench import checks, costs, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "raw2logit_tpu")


class Result:
    """What a traffic kind's ``run`` hands back."""

    def __init__(self):
        self.e2e, self.values = {}, {}
        self.attempted = self.failed = 0
        self.view = None
        self.setup_s = self.memory_peak = self.window_peak = 0
        self.setup_parts = {}


class Context:
    """What a traffic kind's ``run`` is given: the cell's ``config`` and
    ``traffic``, the ``seed``, ``seconds``, ``trace`` flag, ``device``
    and the ``program`` adapter, and the harness's hooks around the
    window."""

    def __init__(self, cell, seed, seconds, trace_on, device, program,
                 t_start=None):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace_on
        self.device, self.program = device, program
        self.t_start = T_START if t_start is None else t_start
        self._peak_before = 0
        self.marks = {}

    def mark(self, label):
        """Seconds from the process's start to the end of a set-up part."""
        if self._cuda():
            torch.cuda.synchronize(self.device)
        self.marks[label] = time.perf_counter() - self.t_start

    def _cuda(self):
        return self.device.type == "cuda"

    def window_begins(self):
        """Set-up ends: its seconds are taken, the memory peak restarts."""
        res = Result()
        if self._cuda():
            torch.cuda.synchronize(self.device)
            self._peak_before = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        res.setup_s = time.perf_counter() - self.t_start
        res.setup_parts = dict(self.marks, window=res.setup_s)
        return res

    def window_ends(self, res):
        if self._cuda():
            torch.cuda.synchronize(self.device)
            res.window_peak = torch.cuda.max_memory_allocated(self.device)
            res.memory_peak = max(self._peak_before, res.window_peak)

    def traced(self, body, primer):
        records, host, window, units, launched = trace.trace_window(
            body, primer, self.program.launches, costs.port_kernel)
        return trace.TraceView(records, host, window, units, launched,
                               self.config, self.traffic,
                               torch.cuda.get_device_name(self.device))

    def free(self):
        """Release the program's memory before the reference runs."""
        gc.collect()
        if self._cuda():
            torch.cuda.empty_cache()


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def set_precision(config):
    """What the configuration states and nothing else: float32, with TF32
    on or off in both of torch's switches."""
    if config["dtype"] != "float32":
        raise ValueError(f"dtype {config['dtype']!r}: this harness runs "
                         f"float32 configurations")
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]


def run_cell(cell, seed, seconds, trace_on, device, program):
    """Run ``cell`` once; returns (Result, Context)."""
    set_precision(cell.config)
    ctx = Context(cell, seed, seconds, trace_on, device, program)
    ctx.mark("imports_cuda")
    res = cell.kind_module().run(ctx)
    return res, ctx


def result_line(cell, res, trace_on, device, chips):
    """The result's JSON object (the checks last)."""
    correct, checked = checks.judge(res.values, cell.limits)
    metrics = {}
    if trace_on:
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"])(res.view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = dict(res.e2e, setup_s=res.setup_s,
                        peak_mem_gib=res.window_peak / 2 ** 30)
        for m in cell.end_to_end:
            if m["name"] not in measured:
                raise KeyError(f"{cell.name} reports {m['name']}, which "
                               f"traffic kind {cell.traffic['kind']!r} does "
                               f"not measure")
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peak = costs.peaks(kind)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": chips, "memory_peak_bytes": res.memory_peak,
           "power_limit_w": power_limit_w() if device.type == "cuda"
           else None,
           "peak_f32_flops": peak[2] if peak else None}
    line = {"correct": correct and res.failed == 0,
            "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = res.view.busy_s()
        dev["window_s"] = res.view.window_s
        line["breakdown"] = trace.breakdown(res.view)
    line["setup_parts_s"] = res.setup_parts
    line["checks"] = checked
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from h100_bench import program
    device = torch.device("cuda", 0)
    res, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, program)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measured process: {found}", file=sys.stderr)
        return 3
    line = result_line(cell, res, bool(args.trace), device, chips)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
