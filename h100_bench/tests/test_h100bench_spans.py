"""The port's spans against a traced window, on synthetic raw events and
records (``h100_bench/spans.py``): each device record belongs to the
innermost ``r2l.`` span holding its host launch, on whatever thread it
was launched; records without a launch or outside every span belong to
none; idle gaps carry the harness's range and the port's span; a span
that is absent reads None; and an ``r2l.`` range's device-side record is
no device record of the harness."""

import pytest
from torch.autograd import DeviceType

from h100_bench import spans, spec, trace
from h100_bench.tests import tiny

MS = 1_000_000
KIND = "NVIDIA H100 80GB HBM3"


class Event:
    """The part of a kineto event that ``spans`` and ``trace`` read; as
    torch 2.11's raw events, without ``activity_type`` unless ``act``
    gives one."""

    def __init__(self, name, start, end, device=False, act=None, corr=0):
        self.name = lambda: name
        self.start_ns = lambda: start
        self.end_ns = lambda: end
        self.device_type = lambda: (DeviceType.CUDA if device
                                    else DeviceType.CPU)
        self.correlation_id = lambda: corr
        if act is not None:
            self.activity_type = lambda: act


def step_trace():
    """One train step 10-90 ms inside ``bench.step``: its stages as port
    spans on thread 1, a kernel launched in each, the backward's launched
    on the autograd thread 2, one kernel launched outside every span (the
    harness's gather) and one device record with no launch found."""
    ms = MS
    host = [Event("r2l.step", 10 * ms, 90 * ms, corr=6),
            Event("r2l.step.process", 11 * ms, 20 * ms),
            Event("r2l.step.backward", 40 * ms, 70 * ms),
            Event("r2l.step.optimizer", 70 * ms, 88 * ms),
            # an aten op with the correlation id of a kernel: no launch
            Event("aten::index_select", 4 * ms, 7 * ms, corr=1),
            Event("cudaLaunchKernel", 5 * ms, 5 * ms + 10, corr=1),
            Event("cudaLaunchKernel", 12 * ms, 12 * ms + 10, corr=2),
            # launched on the autograd engine's thread
            Event("cudaLaunchKernel", 45 * ms, 45 * ms + 10, corr=3),
            Event("cuLaunchKernel", 75 * ms, 75 * ms + 10, corr=4),
            Event("cudaLaunchKernel", 89 * ms, 89 * ms + 10, corr=5)]
    device = [Event("gather", 6 * ms, 8 * ms, True, corr=1),
              Event("isp_fwd", 20 * ms, 30 * ms, True, corr=2),
              Event("wgrad", 50 * ms, 80 * ms, True, corr=3),
              Event("adam", 80 * ms, 84 * ms, True, corr=4),
              Event("fill", 90 * ms, 91 * ms, True, corr=5),
              Event("lost", 95 * ms, 96 * ms, True, corr=99),
              # the span's device-side record
              Event("r2l.step", 12 * ms, 89 * ms, True, corr=6)]
    return host + device


def harness_view(events, units=1, name="cls_train"):
    """The harness's view of ``events`` as ``trace.trace_window`` builds
    it: device records with ``trace._kind``, its own ranges."""
    records = [trace.Record(e.name(), trace._kind(e), e.start_ns(),
                            e.end_ns()) for e in events
               if e.device_type() == DeviceType.CUDA and trace._kind(e)]
    host = [("bench.window", 0, 100 * MS), ("bench.batch", 4 * MS, 9 * MS),
            ("bench.step", 9 * MS, 100 * MS)]
    cell = tiny.cell(name, size=256)
    return trace.TraceView(records, host, (0, 100 * MS), units, {},
                           cell.config, cell.traffic, KIND)


def view_of(events, units=1, name="cls_train"):
    """``harness_view`` less the spans' device-side records."""
    return spans.without_annotations(harness_view(events, units, name))


def attributed(events):
    view = view_of(events)
    found = spans.port_spans(events)
    return view, found, spans.owners(view.records, spans.launch_times(events),
                                     found)


def test_records_belong_to_the_innermost_span_of_their_launch():
    view, found, owned = attributed(step_trace())
    assert [n for n, _, _ in found] == ["r2l.step", "r2l.step.process",
                                        "r2l.step.backward",
                                        "r2l.step.optimizer"]
    assert dict(zip([r.name for r in view.records], owned)) == {
        "gather": None, "isp_fwd": "r2l.step.process",
        "wgrad": "r2l.step.backward", "adam": "r2l.step.optimizer",
        "fill": "r2l.step", "lost": None}
    # the device runs behind the host: wgrad ends after the backward's
    # span, and still belongs to it
    assert spans.span_device_ms(view, owned, "r2l.step.backward") == 30.0
    assert spans.span_device_ms(view, owned, "r2l.step") == 45.0
    assert spans.span_device_ms(view, owned, "r2l.step.process") == 10.0


@pytest.mark.parametrize("act", [None, "gpu_user_annotation"],
                         ids=["torch_2_11", "named_activity"])
def test_a_span_on_the_device_is_no_record(act):
    """A span's device-side record is left out of the records, whether
    the profiler names its activity type (``trace._kind`` then leaves it
    out) or not (``without_annotations`` does), so it never counts as
    busy or as a kernel."""
    events = [e for e in step_trace() if e.name() != "r2l.step"
              or e.device_type() != DeviceType.CUDA]
    events.append(Event("r2l.step", 12 * MS, 89 * MS, True, act=act,
                        corr=6))
    if act is None:
        assert trace._kind(events[-1]) == "kernel"
    view = view_of(events)
    assert "r2l.step" not in [r.name for r in view.records]
    assert view.busy_s() == pytest.approx(0.048)


@pytest.mark.parametrize("span", ["r2l.step.task", "r2l.step.aux",
                                  "r2l.serve.copy_in"])
def test_an_absent_span_reads_none(span):
    view, found, owned = attributed(step_trace())
    assert spans.span_device_ms(view, owned, span) is None
    assert spans.span_host_ms(view, found, span) is None


def test_a_trace_without_port_spans_owns_nothing():
    events = [e for e in step_trace() if not e.name().startswith("r2l.")]
    view, found, owned = attributed(events)
    assert found == [] and owned == [None] * len(view.records)
    assert spans.span_device_ms(view, owned, "r2l.step") is None
    assert spans.idle_gaps(view, found) == trace.idle_gaps(view)


def test_host_ms_per_unit():
    view, found, _ = attributed(step_trace())
    view.units = 2
    assert spans.span_host_ms(view, found, "r2l.step.backward") == 15.0


def test_idle_gaps_carry_the_harness_range_and_the_port_span():
    view, found, _ = attributed(step_trace())
    gaps = spans.idle_gaps(view, found)
    assert [ns for _, ns in gaps] == [ns for _, ns in trace.idle_gaps(view)]
    assert gaps == [("bench.window", 6 * MS), ("bench.batch", 12 * MS),
                    ("bench.step > r2l.step", 20 * MS),
                    ("bench.step > r2l.step.optimizer", 6 * MS),
                    ("bench.step", 4 * MS), ("bench.step", 4 * MS)]
    out = spans.gap_breakdown(view, found)
    assert out[0][0] == "bench.step > r2l.step: 1 gaps, longest 20.0000 ms"
    assert out[0][1] == pytest.approx(0.02)
    assert out[2][0].startswith("bench.step: 2 gaps")


def test_existing_metrics_read_the_same_beside_the_spans():
    """Every existing metric of ``cls_train`` reads a trace taken with
    the port's spans on, less their device-side records
    (``without_annotations``), as it reads the harness's own view of the
    same trace taken with them off: beyond those records the spans add
    nothing the harness reads. (The harness's own view of a trace with
    the spans keeps those records on torch 2.11;
    ``test_a_span_on_the_device_is_no_record``.)"""
    with_spans = view_of(step_trace())
    without = harness_view([e for e in step_trace()
                            if not e.name().startswith("r2l.")])
    cell = spec.Cell("cls_train")
    for m in cell.per_layer:
        read = cell.metric_reader(m["name"])
        assert read(with_spans) == read(without), m["name"]
