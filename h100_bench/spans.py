"""The port's spans on a traced window's time line.

With its tracing on (``raw2logit_tpu_torch/tracing.py``), the port wraps
its train step, served call, loader wait and set-up in host ranges named
``r2l.``; a ``torch.profiler`` trace holds them as host events on the
clock of its device records. This module reads them from a trace's raw
(kineto) events beside the harness's ``trace.TraceView``:

* ``port_spans``: every ``r2l.`` host range [(name, start, end)], on any
  thread;
* ``without_annotations``: the view less the spans' own device-side
  records (each ``r2l.`` range also appears on the device's time line,
  spanning the kernels launched in it; ``trace._kind`` leaves such
  records out only where the profiler names their activity type, which
  torch 2.11's raw events do not, so there they would read as kernels
  and the gaps between kernels as busy);
* ``launch_times``: for each device record, the start of the host runtime
  or driver call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) with
  the same CUPTI correlation id, where the trace holds one;
* ``owners``: the span each device record belongs to, the innermost one
  whose interval holds its launch. Time, not thread, decides, so the
  autograd engine's backward launches, made on its own thread while
  ``r2l.step.backward`` is open on the caller's, belong to it;
* ``span_device_ms``: device ms per step or call of the records that
  belong to a span or its children;
* ``idle_gaps``: ``trace.idle_gaps`` labelled by the innermost range open
  on the host over the harness's ranges and the port's spans together
  (``bench.step > r2l.step.optimizer``).

Nothing here changes what ``trace.py`` records or what an existing metric
reads on a trace without spans.
"""

from torch.autograd import DeviceType

from h100_bench import trace

PREFIX = "r2l."


def _host(event):
    return event.device_type() != DeviceType.CUDA


def port_spans(events):
    """[(name, start ns, end ns)] of the port's host ranges, by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                   if _host(e) and e.name().startswith(PREFIX)),
                  key=lambda s: s[1])


def without_annotations(view):
    """``view`` with the records named ``r2l.`` (the spans' device-side
    records) left out."""
    return trace.TraceView(
        [r for r in view.records if not r.name.startswith(PREFIX)],
        view.host, view.window, view.units, view.launches, view.config,
        view.traffic, view.kind)


def launch_times(events):
    """{(name, start, end) of a device record: the start ns of its host
    launch}: the CUDA runtime or driver call (a host event named ``cu...``)
    with the record's correlation id, where there is one."""
    device = {}
    for e in events:
        if not _host(e):
            device.setdefault(e.correlation_id(), []).append(e)
    out = {}
    for e in events:
        if _host(e) and e.name().startswith("cu"):
            for d in device.get(e.correlation_id(), ()):
                out[(d.name(), d.start_ns(), d.end_ns())] = e.start_ns()
    return out


def _innermost(t, ranges):
    """The name of the range in ``ranges`` [(name, start, end)] that was
    opened last among those holding ``t``; None where none does."""
    best = None
    for name, s, e in ranges:
        if s <= t < e and (best is None or s > best[1]):
            best = (name, s)
    return best and best[0]


def owners(records, launched, spans):
    """The span each of ``records`` (``trace.Record``) belongs to, by the
    launch time ``launched`` maps it to; None without a launch or
    outside every span."""
    out = []
    for r in records:
        t = launched.get((r.name, r.start, r.end))
        out.append(None if t is None else _innermost(t, spans))
    return out


def _within(name, span):
    return name is not None and (name == span
                                 or name.startswith(span + "."))


def span_device_ms(view, owned, span):
    """Device ms per step or call of the window's records that belong to
    ``span`` or a span under it (``owned`` lists each record's span);
    None where none does."""
    ns = [r.end - r.start for r, o in zip(view.records, owned)
          if _within(o, span)]
    if not ns:
        return None
    return sum(ns) / 1e6 / view.units


def span_host_ms(view, spans, span):
    """Host ms per step or call of ``span``'s ranges that start inside
    the window; None where there are none."""
    lo, hi = view.window
    ns = [e - s for name, s, e in spans if name == span and lo <= s < hi]
    if not ns:
        return None
    return sum(ns) / 1e6 / view.units


def idle_gaps(view, spans):
    """``trace.idle_gaps(view)``, each gap labelled ``<harness range> >
    <port span>`` where a port span was the innermost range open on the
    host when the device went idle."""
    bench = trace.idle_gaps(view)
    both = trace.idle_gaps(trace.TraceView(
        view.records, view.host + list(spans), view.window, view.units,
        view.launches, view.config, view.traffic, view.kind))
    return [(h if p == h else f"{h} > {p}", ns)
            for (h, ns), (p, _) in zip(bench, both)]


def gap_breakdown(view, spans):
    """``trace.breakdown``'s ``idle_gaps`` under ``idle_gaps``'s labels:
    the ten labels with most idle time, their gaps and longest gap."""
    by_label = {}
    for label, ns in idle_gaps(view, spans):
        n, total, longest = by_label.get(label, (0, 0, 0))
        by_label[label] = (n + 1, total + ns, max(longest, ns))
    gaps = sorted(by_label.items(), key=lambda kv: -kv[1][1])[:10]
    return [[f"{label}: {n} gaps, longest {longest / 1e6:.4f} ms",
             total / 1e9] for label, (n, total, longest) in gaps]
