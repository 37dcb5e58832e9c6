"""What the per-layer metrics share: each metric is a file of its own,
``metrics/<name>.py``, whose ``read(view)`` takes a ``trace.TraceView``
and returns the metric's value, or None where the trace holds nothing
for it to read (the harness then leaves the metric out)."""

from h100_bench import costs


def kind_is(view, kind):
    return view.traffic["kind"] == kind


def step_mfu(view):
    """The task model's and the ISP's FLOPs of the window's steps (or
    served batches) over its seconds, as a share (%) of the device's
    float32 peak."""
    flops = costs.step_flops(view.config, view.traffic) * view.units
    return 100.0 * flops / view.window_s / costs.peaks(view.kind)[2]


def library_device_ms(view):
    """Device ms per step (or batch) of every kernel that is not the
    port's own: cuDNN, cuBLAS, aten and Adam's foreach kernels."""
    spans = [r.end - r.start for r in view.records
             if r.kind == "kernel" and costs.port_kernel(r.name) is None]
    if not spans:
        return None
    return sum(spans) / 1e6 / view.units


def port_kernels_roofline(view):
    """The port's kernels' least time over their device time (%), summed
    over the kernels that ran in the window, each launch's work counted
    from the cell's shapes; None where none ran."""
    size = view.config["image_size"]
    batch = view.traffic["batch"]
    bound = spent = 0.0
    for r in view.records:
        k = costs.port_kernel(r.name)
        if k is None:
            continue
        elements = costs.kernel_elements(k, batch, size, size)
        bound += costs.kernel_bound_s(k, elements, view.kind)
        spent += (r.end - r.start) / 1e9
    if spent == 0:
        return None
    return 100.0 * bound / spent


def device_idle_share(view):
    """1 minus the union of every device record's interval (kernels,
    copies, memsets) over the window, as a share (%)."""
    return 100.0 * (1.0 - view.busy_s() / view.window_s)


def h2d_ms(view):
    """Device ms of host-to-device copies per served batch."""
    spans = [r.end - r.start for r in view.records
             if r.kind == "memcpy" and "HtoD" in r.name]
    if not spans:
        return None
    return sum(spans) / 1e6 / view.units
