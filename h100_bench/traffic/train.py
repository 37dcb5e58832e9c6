"""Traffic kind ``train``: the port's one train step
(``make_train_step``) on batches gathered from a device-resident pool in
seeded epoch order, joint (ISP and task model both train) or adversarial
(drift forensics: the task model frozen, the ISP with its additive noise
layer attacked under an SSIM aux term).

Set-up builds the step and its state once and drives it through its
first three steps on three distinct batches; those steps are the
warm-up, and what they produce (the first step's RGB, each step's loss
and update, the first gradient as Adam holds it) is what the reference
is compared with, the reference taking each step from the state the
program started it from. The same state then runs the
window: steps dispatched back to back, closed by one synchronise. The
rate is all the window's images over all its time.

A mix file ``traffic/<mix>.json`` gives ``batch``, ``pool``, ``lr``,
``loss_weight``, ``trace_steps`` and, for drift forensics,
``adversarial`` and ``aux_weight``.
"""

import time

import torch
from torch.profiler import record_function

from h100_bench import checks, data, spec
from h100_bench.reference import step as ref_step
from h100_bench.reference.isp import initial_params
from h100_bench.reference.models import model_spec

CHECK_STEPS = 3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _named(module, prefix):
    return {f"{prefix}.{n}": p for n, p in module.named_parameters()}


def build(ctx):
    """The seeded weights, the program's modules holding them, its state
    and step, and the pool's feed."""
    config, traffic, device = ctx.config, ctx.traffic, ctx.device
    isp0, isp_buffers = initial_params(
        spec.camera(config), config["image_size"],
        traffic.get("adversarial", False), device)
    model0 = data.weights(model_spec(config["model"]), ctx.seed, device)
    processor = ctx.program.build_isp(config, traffic, device)
    model = ctx.program.build_model(config, device)
    processor.load_state_dict({**isp0, **isp_buffers}, strict=True)
    model.load_state_dict(model0, strict=True)
    state, step = ctx.program.make_state_and_step(config, traffic, processor,
                                                  model)
    ctx.mark("modules")
    raw, y = data.pool(config, traffic, ctx.seed, device)
    ctx.mark("pool")
    feed = data.EpochFeed([raw, y], traffic["batch"], ctx.seed, device,
                          keep=CHECK_STEPS)
    return isp0, model0, processor, model, state, step, feed


def check_steps(state, step, feed, processor, model, model0, adversarial):
    """Drive the step through its first three steps; return what they
    produced as ``reference.step.train_steps`` returns it: each step's
    loss, aux term, start (the trained parameters and Adam's moments
    before it) and update, the first step's RGB and the first gradient as
    Adam holds it after one step. The copies go to the host, so that the
    window's memory is the program's and the pool's."""
    captured = []
    hook = processor.register_forward_hook(
        lambda mod, args, out: captured.append(out[0].detach().cpu())
        if not captured else None)
    names = {k: p for k, p in {**_named(processor, "isp"),
                               **_named(model, "model")}.items()
             if p.requires_grad}
    opt = state.optimizer
    out = {"loss": [], "aux": [], "update": [], "starts": []}
    try:
        for t in range(1, CHECK_STEPS + 1):
            moments = {k: (opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])
                       for k, p in names.items() if p in opt.state}
            out["starts"].append(ref_step.clone_state(names, moments, "cpu"))
            raw, y = feed.next()
            mets = step(state, raw, y)
            out["loss"].append(float(mets["loss"]))
            out["aux"].append(float(mets["loss_aux"]))
            start = out["starts"][-1]["params"]
            with torch.no_grad():
                out["update"].append({
                    k: float(torch.linalg.vector_norm(p - start[k].to(p)))
                    for k, p in names.items()})
            if t == 1:
                beta1 = opt.param_groups[0]["betas"][0]
                out["grad"] = {
                    k: float(torch.linalg.vector_norm(
                        opt.state[p]["exp_avg"])) / (1 - beta1)
                    for k, p in names.items() if p in opt.state}
    finally:
        hook.remove()
    out["rgb"] = captured[0]
    if adversarial:
        frozen = model.state_dict()
        out["frozen_moved"] = max(
            float((frozen[k].double() - model0[k].double()).abs().max())
            for k in model0)
    return out


def window(feed, step, state, seconds, device):
    """Steps back to back for ``seconds`` of the host's clock, closed by
    one synchronise: (steps, elapsed seconds, the steps' losses)."""
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        raw, y = feed.next()
        losses.append(step(state, raw, y)["loss"])
    _sync(device)
    return len(losses), time.perf_counter() - t0, losses


def traced_window(feed, step, state, steps, device):
    """``steps`` steps inside the trace's window range, each batch and
    step in a range of its own."""
    def one():
        with record_function("bench.batch"):
            raw, y = feed.next()
        with record_function("bench.step"):
            return step(state, raw, y)["loss"]

    def run():
        with record_function("bench.window"):
            losses = [one() for _ in range(steps)]
            _sync(device)
        run.losses = losses
        return steps
    return one, run


def run(ctx):
    """One run of a train cell: returns ``ctx.Result``."""
    traffic, device = ctx.traffic, ctx.device
    adversarial = traffic.get("adversarial", False)
    isp0, model0, processor, model, state, step, feed = build(ctx)
    prog = check_steps(state, step, feed, processor, model, model0,
                       adversarial)
    ctx.mark("first_steps")
    res = ctx.window_begins()
    if ctx.trace:
        primer, body = traced_window(feed, step, state,
                                     traffic["trace_steps"], device)
        res.view = ctx.traced(body, primer)
        losses = body.losses
    else:
        steps, elapsed, losses = window(feed, step, state, ctx.seconds,
                                        device)
        res.e2e["train_images_per_s"] = steps * traffic["batch"] / elapsed
    ctx.window_ends(res)
    res.attempted = len(losses)
    res.failed = int((~torch.isfinite(torch.stack(losses))).sum())

    batches = [tuple(t.index_select(0, idx) for t in feed.tensors)
               for idx in feed.kept]
    del state, step, processor, model, feed
    ctx.free()
    ref = reference(ctx, isp0, model0, batches, prog["starts"])
    res.values = checks.train_gaps(prog, ref)
    return res


def reference(ctx, isp0, model0, batches, follow):
    """The reference's three steps on the same weights and batches, in the
    cell's reference dtype, each step from the state ``follow`` started
    it from (the program's, or the control's)."""
    dtype = getattr(torch, ctx.cell.file["reference_dtype"])
    return ref_step.train_steps(
        ctx.config, ctx.traffic, data.cast(isp0, dtype),
        data.cast(model0, dtype),
        [(raw.to(dtype), y.to(dtype) if y.is_floating_point() else y)
         for raw, y in batches], follow=follow)
