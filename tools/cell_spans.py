"""One run of a benchmark cell (``h100_bench/``) with the port's spans on
(``raw2logit_tpu_torch/tracing.py``) from before set-up, on the card.

    python3 tools/cell_spans.py --workload cls_train --seed 7 \\
        --seconds 40 --trace <0|1>

Runs the cell as ``h100_bench/run.py`` runs it and prints its result
line with a ``spans`` object added:

- ``setup``: host seconds of the set-up spans (``r2l.setup.*``) and of
  the program's builders as the cell calls them (``build_isp``,
  ``build_model``, ``make_state_and_step``), with the number of modules
  that ``make_state_and_step`` imported first and torch's packages among
  them;
- ``host_ms``: host ms per step or call of each span over the window
  (the port's in-memory record);
- ``--trace 1``, from the traced window: ``device_ms`` (device ms per
  step or call of the records that belong to each span and its
  children), ``window_device_ms``
  and ``unattributed_ms`` (records in no span, or with no launch found),
  ``trace_host_ms`` (each span's host ms per unit in the trace), the
  per-layer readings named as the stage metrics would be
  (``process_device_ms.train`` ...), the idle gaps under the port's
  spans, and ``clock_offset_us``: [least, median, largest] of how far
  each span's profiler range starts after its start in the port's
  record (``start``), and ends before its end there (``end``).

Tracing on costs what it costs, so the rates of a ``--trace 0`` run here
are the cost of tracing on, beside ``run.py``'s with it off.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from h100_bench import run  # noqa: E402  (first: it starts set-up's clock)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from h100_bench import spans as port_spans  # noqa: E402
from h100_bench import spec  # noqa: E402
from raw2logit_tpu_torch import tracing  # noqa: E402

STAGES = {"train": ("process", "task", "aux", "backward", "optimizer"),
          "serve": ("copy_in", "process", "model")}
SPAN_OF = {"train": "r2l.step.{}", "serve": "r2l.serve.{}"}


class Kept(run.Context):
    """``run.Context`` that keeps the traced window's raw events and the
    window's start on the host clock, and leaves the spans' device-side
    records out of the view (every metric of the line reads it)."""

    events = ()
    window_ns = None

    def window_begins(self):
        res = super().window_begins()
        self.window_ns = time.time_ns()
        return res

    def traced(self, body, primer):
        kept = []
        real = torch.profiler.profile

        class Keeping(real):
            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                kept.append(self)
                return out

        torch.profiler.profile = Keeping
        try:
            view = super().traced(body, primer)
        finally:
            torch.profiler.profile = real
        self.events = kept[-1].profiler.kineto_results.events()
        return port_spans.without_annotations(view)


def timed(program, builders, imported):
    """Wrap ``program``'s builders with host timers into ``builders``;
    the top-level modules that ``make_state_and_step`` loads first go to
    ``imported``."""
    for name in ("build_isp", "build_model", "make_state_and_step"):
        fn = getattr(program, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            before = set(sys.modules)
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            builders[_name] = builders.get(_name, 0.0) + (
                time.perf_counter() - t0)
            if _name == "make_state_and_step":
                new = set(sys.modules) - before
                imported.append(len(new))
                imported.extend(sorted({".".join(m.split(".")[:2])
                                        for m in new
                                        if m.startswith("torch.")}))
            return out
        setattr(program, name, wrapped)


def host_ms(record, since, units):
    """{span: host ms per unit} of the record's spans from ``since``."""
    out = {}
    for s in record:
        if since is not None and s.start_ns >= since:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return {k: v / units for k, v in sorted(out.items())} if units else {}


def spread(values):
    """[least, median, largest] of ``values``, or None."""
    if not values:
        return None
    ordered = sorted(values)
    return [ordered[0], ordered[len(ordered) // 2], ordered[-1]]


def traced_summary(view, events, record, kind):
    """What the traced window says of the spans (see the module's doc)."""
    spans = port_spans.port_spans(events)
    launched = port_spans.launch_times(events)
    owned = port_spans.owners(view.records, launched, spans)
    names = sorted({s[0] for s in spans})
    units = view.units
    total = sum(r.end - r.start for r in view.records)
    free = sum(r.end - r.start for r, o in zip(view.records, owned)
               if o is None)
    lo, hi = view.window
    starts, ends = [], []
    for name, s, e in spans:
        if lo <= s < hi:
            mine = min((p for p in record if p.name == name),
                       key=lambda p: abs(p.start_ns - s), default=None)
            if mine is not None:
                starts.append((s - mine.start_ns) / 1e3)
                ends.append((mine.end_ns - e) / 1e3)
    out = {"device_ms": {n: port_spans.span_device_ms(view, owned, n)
                         for n in names},
           "trace_host_ms": {n: port_spans.span_host_ms(view, spans, n)
                             for n in names},
           "window_device_ms": total / 1e6 / units,
           "unattributed_ms": free / 1e6 / units,
           "no_launch_records": sum(1 for r in view.records
                                    if (r.name, r.start, r.end)
                                    not in launched),
           "records": len(view.records),
           "clock_offset_us": {"start": spread(starts),
                               "end": spread(ends)},
           "idle_gaps": port_spans.gap_breakdown(view, spans)}
    metrics = {}
    for stage in STAGES[kind]:
        span = SPAN_OF[kind].format(stage)
        value = port_spans.span_device_ms(view, owned, span)
        if value is not None:
            metrics[f"{stage}_device_ms.{kind}"] = value
    if kind == "serve":
        metrics["copy_in_host_ms.serve"] = port_spans.span_host_ms(
            view, spans, "r2l.serve.copy_in")
    out["stage_metrics"] = metrics
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from h100_bench import program
    builders, imported = {}, []
    timed(program, builders, imported)
    device = torch.device("cuda", 0)
    tracing.enable()
    run.set_precision(cell.config)
    ctx = Kept(cell, args.seed, args.seconds, bool(args.trace), device,
               program)
    ctx.mark("imports_cuda")
    res = cell.kind_module().run(ctx)
    record = tracing.disable()
    line = run.result_line(cell, res, bool(args.trace), device, 1)
    kind = cell.traffic["kind"]
    setup = {}
    for s in record:
        if s.name.startswith("r2l.setup."):
            setup[s.name] = setup.get(s.name, 0.0) + (
                s.end_ns - s.start_ns) / 1e9
    top = "r2l.step" if kind == "train" else "r2l.serve"
    units = sum(1 for s in record if s.name == top and ctx.window_ns
                and s.start_ns >= ctx.window_ns)
    out = {"setup_s": setup, "builders_s": builders,
           "state_imported": imported[:40],
           "host_ms": None if args.trace else host_ms(record, ctx.window_ns,
                                                      units),
           "window_units_in_record": units}
    if args.trace:
        out.update(traced_summary(res.view, ctx.events, record, kind))
    line["spans"] = out
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
