"""The trace's arithmetic on synthetic records: busy time as a union,
idle gaps by host range, the breakdown, and each per-layer reader."""

import pytest

from h100_bench import costs, spec, trace
from h100_bench.tests import tiny

MS = 1_000_000
KIND = "NVIDIA H100 80GB HBM3"


def _view(records, host, units, name="cls_train", batch=None):
    cell = tiny.cell(name, size=256)
    traffic = dict(cell.traffic)
    if batch:
        traffic["batch"] = batch
    return trace.TraceView(records, host, (0, 100 * MS), units, {},
                           cell.config, traffic, KIND)


def _read(metric, view):
    return spec.Cell("cls_train").metric_reader(metric)(view)


def test_union_counts_overlaps_once():
    r = [trace.Record("a", "kernel", 0, 10 * MS),
         trace.Record("b", "kernel", 5 * MS, 20 * MS),
         trace.Record("c", "memcpy", 30 * MS, 40 * MS),
         trace.Record("d", "kernel", 95 * MS, 120 * MS)]
    assert trace.union_ns(r, 0, 100 * MS) == 35 * MS
    view = _view(r, [], 1)
    assert view.busy_s() == pytest.approx(0.035)
    assert view.window_s == pytest.approx(0.1)
    assert _read("device_idle_share.train", view) == pytest.approx(65.0)


def test_idle_gaps_are_labelled_by_the_open_host_range():
    r = [trace.Record("a", "kernel", 10 * MS, 20 * MS),
         trace.Record("b", "kernel", 50 * MS, 100 * MS)]
    host = [("bench.window", 0, 100 * MS), ("bench.batch", 0, 12 * MS),
            ("bench.step", 12 * MS, 60 * MS)]
    gaps = trace.idle_gaps(_view(r, host, 1))
    assert gaps == [("bench.batch", 10 * MS), ("bench.step", 30 * MS)]
    out = trace.breakdown(_view(r, host, 1))
    assert out["device_ops"][0] == ["b", 0.05]
    assert out["idle_gaps"][0][0].startswith("bench.step: 1 gaps")
    assert out["idle_gaps"][0][1] == pytest.approx(0.03)


def test_port_roofline_is_least_time_over_device_time():
    b = 256
    r = [trace.Record("void fused_isp_fwd_kernel<true, true>(...)",
                      "kernel", 0, 2 * MS),
         trace.Record("void fused_isp_bwd_kernel<true>(...)", "kernel",
                      2 * MS, 6 * MS),
         trace.Record("cudnn_conv", "kernel", 6 * MS, 90 * MS)]
    pixels = b * 256 * 256
    bound = (costs.kernel_bound_s("fused_isp_fwd_train", pixels, KIND)
             + costs.kernel_bound_s("fused_isp_bwd_res", pixels, KIND))
    view = _view(r, [], 1, batch=b)
    assert _read("port_kernels_roofline.train", view) == pytest.approx(
        100 * bound / 0.006)
    assert _read("library_device_ms.train", view) == pytest.approx(84.0)
    # no port kernel in the window: nothing to read, never 0
    assert _read("port_kernels_roofline.train", _view(r[2:], [], 1)) is None


def test_step_mfu_and_h2d():
    view = _view([trace.Record("k", "kernel", 0, MS)], [], 4)
    flops = costs.step_flops(view.config, view.traffic) * 4
    assert _read("step_mfu.train", view) == pytest.approx(
        100 * flops / 0.1 / 67e12)
    assert _read("step_mfu.serve", view) is None
    serve = _view([trace.Record("Memcpy HtoD (Pageable -> Device)",
                                "memcpy", 0, 3 * MS),
                   trace.Record("Memcpy DtoH (Device -> Pageable)",
                                "memcpy", 3 * MS, 4 * MS)], [], 2,
                  name="cls_serve")
    assert _read("h2d_ms.serve", serve) == pytest.approx(1.5)
    assert _read("h2d_ms.serve", view) is None
