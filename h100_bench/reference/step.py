"""The reference's train steps and served batches.

A train step: ISP -> task model -> task loss (cross-entropy, or binary
soft-Dice over the whole batch) times the loss weight, plus, in
adversarial mode, the aux term ``aux_weight * SSIM(reference RGB, RGB)``
against the initial ISP's output; autograd; Adam (betas 0.9 and 0.999,
eps 1e-8, no weight decay) over the parameters that train. In joint
training the ISP's batch norm and the task model run in train mode; in
adversarial mode both run in eval mode, the task model is frozen, and
every ISP parameter trains.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.isp import isp_forward
from h100_bench.reference.models import model_forward
from h100_bench.reference.ops import conv2d

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2


def cross_entropy(logits, labels):
    return F.cross_entropy(logits, labels)


def dice_loss(logits, targets, eps=1e-7):
    """Binary soft-Dice on logits: one score over batch and space, zero
    where the whole batch's target is empty."""
    probs = torch.sigmoid(logits).reshape(-1)
    targets = targets.reshape(-1).to(probs.dtype)
    inter = torch.sum(probs * targets)
    card = torch.sum(probs + targets)
    score = 2.0 * inter / torch.clamp(card, min=eps)
    return (1.0 - score) * (targets.sum() > 0).to(probs.dtype)


def _gauss(window=11, sigma=1.5):
    x = np.arange(window, dtype=np.float64)
    g = np.exp(-((x - window // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(x, y, tf32=False):
    """Mean SSIM of two (B, C, H, W) batches: an 11-tap Gaussian window
    (sigma 1.5) applied per channel as a vertical then a horizontal pass,
    zero padding."""
    g = torch.tensor(_gauss(), device=x.device, dtype=x.dtype)
    c = x.shape[1]
    wv = g.reshape(1, 1, 11, 1).expand(c, 1, 11, 1).contiguous()
    wh = g.reshape(1, 1, 1, 11).expand(c, 1, 1, 11).contiguous()

    def win(img):
        img = conv2d(F.pad(img, (0, 0, 5, 5)), wv, tf32, groups=c)
        return conv2d(F.pad(img, (5, 5, 0, 0)), wh, tf32, groups=c)

    mu1, mu2 = win(x), win(y)
    s11 = win(x * x) - mu1 * mu1
    s22 = win(y * y) - mu2 * mu2
    s12 = win(x * y) - mu1 * mu2
    m = ((2 * mu1 * mu2 + SSIM_C1) * (2 * s12 + SSIM_C2)) / (
        (mu1 * mu1 + mu2 * mu2 + SSIM_C1) * (s11 + s22 + SSIM_C2))
    return m.mean()


def adam_step(params, grads, state, lr, t):
    """torch.optim.Adam's update (no weight decay, not amsgrad) at step
    ``t`` (from 1), in place on ``params``; ``state`` holds the moments."""
    b1, b2 = BETAS
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m, v = state.setdefault(name, (torch.zeros_like(p),
                                           torch.zeros_like(p)))
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-lr / bc1)


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v)) for k, v in tensors.items()}


def clone_state(params, moments, device=None):
    """Copies of the trained parameters and Adam's moments, on ``device``
    (default: where they are)."""
    def copy(t):
        return t.detach().to(device or t.device, copy=True)
    return {"params": {k: copy(p) for k, p in params.items()},
            "moments": {k: (copy(m), copy(v))
                        for k, (m, v) in moments.items()}}


def train_steps(config, traffic, isp0, model0, batches, tf32=False,
                follow=None):
    """Run the reference's steps on ``batches`` [(raw, y)] from the
    initial ISP parameters ``isp0`` and task-model state ``model0`` (name
    -> tensor, buffers included), in their dtype.

    Each step records where it started (``starts``: the trained
    parameters and Adam's moments before it). With ``follow``, another
    side's ``starts``, step t starts from that side's state instead of
    its own: the reference follows the program step by step, so that
    what one float32 step's rounding does to the next (a sign of Adam's
    first update, the trajectory at a large learning rate) does not
    count against the program. Returns {"loss", "aux": [per step],
    "rgb": the first step's RGB, "grad": {leaf: norm of the first
    gradient}, "grads", "update": [per step {leaf: norm of its gradient,
    of its update}], "starts"}; leaves are ``isp.<name>`` and
    ``model.<name>``."""
    adversarial = traffic.get("adversarial", False)
    model = config["model"]
    isp = {k: v.clone() for k, v in isp0.items()}
    net = {k: v.clone() for k, v in model0.items()}
    train_bn = not adversarial
    params = {f"isp.{k}": v for k, v in isp.items()}
    if not adversarial:
        params.update({f"model.{k}": v for k, v in net.items()
                       if v.is_floating_point()
                       and not k.endswith(("running_mean", "running_var"))})
    for p in params.values():
        p.requires_grad_(True)
    out = {"loss": [], "aux": [], "grads": [], "update": [], "starts": []}
    moments = {}
    for t, (raw, y) in enumerate(batches, start=1):
        if follow is not None:
            with torch.no_grad():
                for k, v in follow[t - 1]["params"].items():
                    params[k].copy_(v)
            moments = {k: (m.to(raw.device, raw.dtype, copy=True),
                           v.to(raw.device, raw.dtype, copy=True))
                       for k, (m, v) in follow[t - 1]["moments"].items()}
        out["starts"].append(clone_state(params, moments))
        rgb = isp_forward(isp, raw, train_bn, tf32)
        logits = model_forward(model, net, rgb, train_bn, tf32)
        if config["task"] == "classification":
            loss = traffic["loss_weight"] * cross_entropy(logits, y)
        else:
            loss = traffic["loss_weight"] * dice_loss(logits[:, 0], y)
        aux = torch.zeros((), device=raw.device)
        if adversarial:
            with torch.no_grad():
                ref = isp_forward(isp0, raw, False, tf32)
            aux = traffic["aux_weight"] * ssim(ref, rgb, tf32)
            loss = loss + aux
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        adam_step(params, grads, moments, traffic["lr"], t)
        out["loss"].append(float(loss.detach()))
        out["aux"].append(float(aux.detach()))
        out["grads"].append(_norms(grads))
        start = out["starts"][-1]["params"]
        out["update"].append(_norms({k: p.detach() - start[k]
                                     for k, p in params.items()}))
        if t == 1:
            out["rgb"] = rgb.detach()
    out["grad"] = out["grads"][0]
    return out


@torch.no_grad()
def serve_batch(config, isp0, model0, raw, tf32=False):
    """Logits of a served batch: the ISP and the task model in eval
    mode."""
    rgb = isp_forward(isp0, raw, False, tf32)
    return model_forward(config["model"], model0, rgb, False, tf32)
