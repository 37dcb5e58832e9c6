"""The traced window: a ``torch.profiler`` trace of the device around the
harness's own ``record_function`` ranges, read into plain records.

The trace opens with two primers, as ``chip_smoke.py`` found it needs
(torch.profiler on the card has lost the first device records of a
trace): torch's spin kernel and one unmeasured call, each followed by
50 ms. The measured calls run inside the range ``bench.window``; only
device records that start inside it count. The ranges' own device-side
records (annotations) are left out. A trace whose port-kernel records
differ in number from the port's launch counters is taken again, up to
``ATTEMPTS`` times in all.
"""

import time

import torch

WINDOW = "bench.window"
RANGES = ("bench.window", "bench.batch", "bench.step", "bench.readback")
SETTLE_S, ATTEMPTS = 0.05, 3


class Record:
    """One device record: name, kind (kernel, memcpy, memset), start and
    end in ns."""

    __slots__ = ("name", "kind", "start", "end")

    def __init__(self, name, kind, start, end):
        self.name, self.kind, self.start, self.end = name, kind, start, end


def _kind(event):
    """kernel, memcpy, memset, or None for an annotation."""
    act = str(getattr(event, "activity_type", lambda: "")()).lower()
    name = event.name()
    if "annotation" in act or name in RANGES:
        return None
    if "memcpy" in act or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    return "kernel"


class TraceView:
    """What a per-layer metric reads: the device ``records`` that start
    in the window, the ``host`` ranges [(name, start, end)] of the
    harness, the ``window`` (start, end) in ns, the ``units`` (steps or
    calls) run in it, the port's ``launches`` in it by kernel, and the
    cell's ``config``, ``traffic`` and device ``kind``."""

    def __init__(self, records, host, window, units, launches, config,
                 traffic, kind):
        self.records, self.host, self.window = records, host, window
        self.units, self.launches = units, launches
        self.config, self.traffic, self.kind = config, traffic, kind

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self):
        """Seconds in which at least one device record ran: the union of
        their intervals, clipped to the window."""
        return union_ns(self.records, *self.window) / 1e9


def union_ns(records, lo, hi):
    """ns covered by the union of the records' intervals within [lo,
    hi]."""
    spans = sorted((max(r.start, lo), min(r.end, hi)) for r in records)
    total, end = 0, lo
    for s, e in spans:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(view):
    """[(host range, gap ns)] of every stretch inside the window where no
    device record ran, labelled by the innermost harness range that was
    open on the host when the device went idle."""
    lo, hi = view.window
    spans = sorted((r.start, r.end) for r in view.records)
    gaps, end = [], lo
    for s, e in spans + [(hi, hi)]:
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    out = []
    for a, b in gaps:
        if b <= a:
            continue
        label = "bench.window"
        best = None
        for name, s, e in view.host:
            if s <= a < e and name != WINDOW and (best is None or s > best):
                label, best = name, s
        out.append((label, b - a))
    return out


def breakdown(view):
    """The ``breakdown`` of the result's line: the ten device operations
    that took most time (seconds summed by name) and the idle time by
    what the host was doing (its longest gaps summed by range)."""
    ops = {}
    for r in view.records:
        ops[r.name] = ops.get(r.name, 0) + (r.end - r.start)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    by_range = {}
    for label, ns in idle_gaps(view):
        n, total, longest = by_range.get(label, (0, 0, 0))
        by_range[label] = (n + 1, total + ns, max(longest, ns))
    gaps = sorted(by_range.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name[:160], ns / 1e9] for name, ns in top],
            "idle_gaps": [[f"{label}: {n} gaps, longest "
                           f"{longest / 1e6:.4f} ms", total / 1e9]
                          for label, (n, total, longest) in gaps]}


def trace_window(run_window, primer_call, counters, port_kernel):
    """Trace ``run_window()`` (which runs the measured calls inside the
    ``bench.window`` range, each in its own harness range, and returns
    how many it ran) after the primers; ``counters()`` reads the port's
    launch counters, ``port_kernel(name)`` names a port kernel's record.
    Returns (records, host ranges, window, units, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
            primer_call()
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
            before = counters()
            units = run_window()
            after = counters()
            time.sleep(SETTLE_S)
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        events = prof.profiler.kineto_results.events()
        host = [(e.name(), e.start_ns(), e.end_ns()) for e in events
                if e.device_type() != DeviceType.CUDA and e.name() in RANGES]
        windows = [(s, e) for name, s, e in host if name == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no bench.window range")
        window = windows[-1]
        records = []
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                continue
            kind = _kind(e)
            if kind is None or "spin_kernel" in e.name():
                continue
            if window[0] <= e.start_ns() < window[1]:
                records.append(Record(e.name(), kind, e.start_ns(),
                                      e.end_ns()))
        recorded = {}
        for r in records:
            k = port_kernel(r.name)
            if k is not None:
                recorded[k] = recorded.get(k, 0) + 1
        if recorded == launched and records:
            break
    return records, host, window, units, launched
