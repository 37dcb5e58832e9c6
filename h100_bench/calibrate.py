"""The readings that the limits of ``cells/<cell>.json`` are set from, on
the card at the cell's own size, many seeds in one process:

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 3] [--out file.jsonl]

For every seed it prints one JSON line with the program's numbers (the
lower readings: the timed path's first three train steps, or a short
window of served calls, against the reference in the cell's reference
dtype), and for the
first ``--control-seeds`` seeds also the control's (the reference in
TF32 in the program's place) and the planted faults' (train: half of
the batch left out, the mean taken over the rest; serve: one answer
altered, a row's logits handed back for another row). A state left
unchanged reads 1 on ``update_gap`` and needs no run. The benchmark's own
runs never run any of this.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from h100_bench import checks, data, run, spec  # noqa: E402
from h100_bench.reference import step as ref_step  # noqa: E402
from h100_bench.reference.isp import initial_params  # noqa: E402
from h100_bench.reference.models import model_spec  # noqa: E402
from h100_bench.traffic import serve as serve_kind  # noqa: E402
from h100_bench.traffic import train as train_kind  # noqa: E402


def _tf32(device, on):
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on


def worst_leaf(prog, ref, keep=None):
    """The leaf that sets ``checks.norm_gap``, with both norms."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return None
    med = statistics.median(ref[k] for k in names)
    k = max(names, key=lambda k: abs(prog.get(k, 0.0) - ref[k])
            / max(ref[k], med, 1e-30))
    return [k, prog.get(k, 0.0), ref[k], med]


def train_readings(ctx, controls):
    cell, device = ctx.cell, ctx.device
    adversarial = cell.traffic.get("adversarial", False)
    isp0, model0, processor, model, state, step, feed = train_kind.build(ctx)
    prog = train_kind.check_steps(state, step, feed, processor, model,
                                  model0, adversarial)
    batches = [tuple(t.index_select(0, idx) for t in feed.tensors)
               for idx in feed.kept]
    del state, step, processor, model, feed
    ctx.free()

    def gaps(side, against):
        """``checks.train_gaps``; the reference's sides never move the
        frozen task model."""
        if adversarial:
            side = dict(side, frozen_moved=side.get("frozen_moved", 0.0))
        return checks.train_gaps(side, against)

    ref = train_kind.reference(ctx, isp0, model0, batches, prog["starts"])
    out = {"program": checks.train_gaps(prog, ref),
           "program_worst": {
               "grad": worst_leaf(prog["grad"], ref["grad"],
                                  checks.gradient_leaves(ref["grad"])),
               "update": [worst_leaf(p, r, checks.live_leaves(g) & (
                   checks.gradient_leaves(g) if t else set(g)))
                   for t, (p, r, g) in enumerate(zip(
                       prog["update"], ref["update"], ref["grads"]))]},
           "losses": [prog["loss"], ref["loss"]],
           "aux": [prog["aux"], ref["aux"]]}
    if controls:
        # the control in the program's place: the reference in TF32 on its
        # own trajectory, which the reference then follows
        _tf32(device, True)
        ctl = ref_step.train_steps(cell.config, cell.traffic, isp0, model0,
                                   batches, tf32=True)
        _tf32(device, cell.config["tf32"])
        out["control"] = gaps(ctl, train_kind.reference(
            ctx, isp0, model0, batches, ctl["starts"]))
        half = [(raw[:len(raw) // 2], y[:len(y) // 2]) for raw, y in batches]
        bad = train_kind.reference(ctx, isp0, model0, half, None)
        out["half_batch"] = gaps(bad, train_kind.reference(
            ctx, isp0, model0, batches, bad["starts"]))
    return out


def serve_readings(ctx, controls):
    cell, device = ctx.cell, ctx.device
    res = serve_kind.run(ctx)
    out = {"program": res.values, "calls": res.attempted}
    if controls:
        config, traffic = cell.config, cell.traffic
        isp0, _ = initial_params(spec.camera(config), config["image_size"],
                                 False, device)
        model0 = data.weights(model_spec(config["model"]), ctx.seed, device)
        host = serve_kind.host_batches(config, traffic, ctx.seed, device)
        ref = serve_kind.reference(ctx, isp0, model0, host)
        _tf32(device, True)
        ctl = [(k, ref_step.serve_batch(config, isp0, model0,
                                        torch.from_numpy(b).to(device),
                                        tf32=True))
               for k, b in enumerate(host)]
        _tf32(device, config["tf32"])
        out["control"] = {"logit_gap": checks.serve_gap(ctl, ref)}
        altered = [(k, r.clone()) for k, r in enumerate(ref)]
        altered[0][1][0] = ref[0][1]
        out["altered_answer"] = {"logit_gap": checks.serve_gap(altered, ref)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    from h100_bench import program
    cell = spec.Cell(args.workload)
    device = torch.device("cuda", 0)
    run.set_precision(cell.config)
    fh = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = run.Context(cell, seed, args.seconds, False, device, program,
                          t_start=t0)
        reader = (serve_readings if cell.traffic["kind"] == "serve"
                  else train_readings)
        out = reader(ctx, i < args.control_seeds)
        line = json.dumps({"cell": cell.name, "seed": seed,
                           "seconds": time.perf_counter() - t0, **out},
                          default=float)
        print(line, flush=True)
        if fh:
            fh.write(line + "\n")
            fh.flush()
        ctx.free()
    if fh:
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
