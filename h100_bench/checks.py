"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the reference works out again from the same
seeded weights and inputs, each held to its limit from the cell's file.
"""

import math
import statistics

import torch

# leaves whose reference gradient is under this share of the median
# leaf's are nought to rounding (a bias under a batch norm), and move
# under Adam by round-off alone: they are left out of the updates
DEAD_LEAF = 1e-3


def max_rel_gap(prog, ref):
    """max |prog - ref| over max |ref|; inf where the shapes differ."""
    if tuple(prog.shape) != tuple(ref.shape):
        return math.inf
    prog = prog.to(ref.device, ref.dtype)
    return float((prog - ref).abs().max() / ref.abs().max())


def scalar_gap(prog, ref):
    """The widest |prog - ref| / |ref| over paired scalars (per-step
    losses); inf where a step is missing."""
    if len(prog) != len(ref):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def norm_gap(prog, ref, keep=None):
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's; a leaf the program lacks has norm 0. ``keep`` limits
    the leaves compared."""
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in names)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
               for k in names)


def live_leaves(ref_grad):
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= DEAD_LEAF * median}


def gradient_leaves(ref_grad):
    """The leaves whose gradient, and whose update after the first step,
    are compared: the task model's where it trains. Under the ISP's
    train-mode output batch norm the ISP's gradient is a small remainder
    of a sum that cancels, so badly conditioned in float32 that one ulp
    of noise on the input moves it by up to 17% (PERF.md), and Adam's
    later updates carry that on; the ISP's leaves are held by their first
    update (Adam's first step goes by the gradient's signs) and by the
    RGB. Where the task model is frozen (drift forensics) the ISP's leaves
    are all there is, and their gradient is well conditioned."""
    model = {k for k in ref_grad if k.startswith("model.")}
    return model or set(ref_grad)


def train_gaps(prog, ref):
    """{number: value} of a train cell: the first step's RGB, each step's
    loss (and aux term in adversarial mode), the first gradient's worst
    leaf, and each step's update's worst leaf (the leaves that step's
    reference gradient moves, after the first step those of
    ``gradient_leaves``)."""
    updates = []
    for t, (p, r, g) in enumerate(zip(prog["update"], ref["update"],
                                      ref["grads"])):
        keep = live_leaves(g)
        if t:
            keep &= gradient_leaves(g)
        updates.append(norm_gap(p, r, keep=keep))
    gaps = {"rgb_gap": max_rel_gap(prog["rgb"], ref["rgb"]),
            "loss_gap": scalar_gap(prog["loss"], ref["loss"]),
            "grad_gap": norm_gap(prog["grad"], ref["grad"],
                                 keep=gradient_leaves(ref["grad"])),
            "update_gap": (max(updates)
                           if len(updates) == len(ref["update"])
                           else math.inf)}
    if "frozen_moved" in prog:
        gaps["aux_gap"] = scalar_gap(prog["aux"], ref["aux"])
        gaps["frozen_moved"] = prog["frozen_moved"]
    return gaps


def serve_gap(outputs, ref):
    """The widest logit gap of any call: max |logits - reference| over
    max |reference| of its batch; inf for a call whose shape is wrong."""
    return max(max_rel_gap(torch.as_tensor(out), ref[k])
               for k, out in outputs)


def judge(values, limits):
    """(correct, {number: {"value", "limit"}}): correct where every number
    that the cell's file gives a limit is finite and within it (the
    others are readings that no limit can hold, PERF.md)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = values[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
