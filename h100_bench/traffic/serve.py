"""Traffic kind ``serve``: one closed-loop caller of the port's
``Predictor.__call__``, offline inference over a test set (drift
synthesis, ``predict_dir``). Set-up makes ``pool`` mosaics from the seed
and hands them to the host as float32 arrays of ``batch`` rows, in a
seeded order; the caller sends them in turn, each call timed from
handing over the host array to the logits on the host, and sends the
next when the last has come back.

The rate is all the window's images over all its time; the tail is the
95th percentile of every call in the window. Every call's logits are
compared, after the window, with the reference's logits of its batch.

A mix file ``traffic/<mix>.json`` gives ``batch``, ``pool``, ``warmup``
(calls in set-up) and ``trace_steps`` (calls in a traced window).
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from h100_bench import checks, data, spec
from h100_bench.reference import step as ref_step
from h100_bench.reference.isp import initial_params
from h100_bench.reference.models import model_spec


def _p95(values):
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def host_batches(config, traffic, seed, device):
    """The pool's mosaics as host float32 arrays of ``batch`` rows, in a
    seeded order (the pool's ragged tail left out)."""
    raw, _ = data.pool(config, traffic, seed, device)
    feed = data.EpochFeed([raw], traffic["batch"], seed, device)
    out = [np.ascontiguousarray(feed.next()[0].cpu().numpy())
           for _ in range(feed.per_epoch)]
    return out


def run(ctx):
    """One run of a serve cell: returns ``ctx.Result``."""
    config, traffic, device = ctx.config, ctx.traffic, ctx.device
    isp0, isp_buffers = initial_params(spec.camera(config),
                                       config["image_size"], False, device)
    model0 = data.weights(model_spec(config["model"]), ctx.seed, device)
    processor = ctx.program.build_isp(config, traffic, device)
    model = ctx.program.build_model(config, device)
    processor.load_state_dict({**isp0, **isp_buffers}, strict=True)
    model.load_state_dict(model0, strict=True)
    pred = ctx.program.predictor(processor, model, config, device)
    ctx.mark("modules")
    batches = host_batches(config, traffic, ctx.seed, device)
    ctx.mark("pool")
    for k in range(traffic["warmup"]):
        pred(batches[k % len(batches)]).cpu()
    ctx.mark("warmup")

    outputs, latencies = [], []

    def call(k):
        t0 = time.perf_counter()
        out = pred(batches[k]).cpu()
        latencies.append(time.perf_counter() - t0)
        outputs.append((k, out))

    res = ctx.window_begins()
    if ctx.trace:
        def traced_call(k):
            with record_function("bench.step"):
                out = pred(batches[k])
            with record_function("bench.readback"):
                outputs.append((k, out.cpu()))

        def body():
            with record_function("bench.window"):
                for i in range(traffic["trace_steps"]):
                    traced_call(i % len(batches))
            return traffic["trace_steps"]
        res.view = ctx.traced(body, lambda: pred(batches[0]).cpu())
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            call(len(outputs) % len(batches))
        elapsed = time.perf_counter() - t0
        res.e2e["serve_images_per_s"] = (len(outputs) * traffic["batch"]
                                         / elapsed)
        res.e2e["serve_batch_ms_p95"] = _p95(latencies) * 1e3
    ctx.window_ends(res)
    res.attempted = len(outputs)
    res.failed = sum(1 for _, out in outputs
                     if not bool(torch.isfinite(out).all()))

    del pred, processor, model
    ctx.free()
    ref = reference(ctx, isp0, model0, batches)
    res.values = {"logit_gap": checks.serve_gap(outputs, ref)}
    return res


def reference(ctx, isp0, model0, batches):
    """The reference's logits of each host batch, in the cell's reference
    dtype."""
    dtype = getattr(torch, ctx.cell.file["reference_dtype"])
    isp0, model0 = data.cast(isp0, dtype), data.cast(model0, dtype)
    return [ref_step.serve_batch(ctx.config, isp0, model0,
                                 torch.from_numpy(b).to(ctx.device, dtype))
            for b in batches]
