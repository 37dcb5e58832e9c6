"""Two gloo ranks on the CPU, each stepping on 4 of 8 rows, against one
process on the 8 rows: the staged train step with and without
``fuse_opt``, and the adversarial staged step, in the pattern of
tests/test_torch_parallel.py (its tolerances). Imports no JAX (the
children import this module).
"""

import numpy as np
import torch

from raw2logit_tpu_torch.parallel import distributed
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_staged_train_step)
from test_torch_parallel import finish, grad_rel, reports, start
from test_torch_staged import (SIZE, modules,  # noqa: F401
                               one_torch_thread)

# two ranks against one (tests/test_torch_parallel.py)
STEP_REL, GRAD_REL = 1e-6, 1e-4

B = 8


def staged_report(grads=None):
    """The staged step with and without fuse_opt (the kernel-path ISP with
    its train-mode output BN in clf_grad_bn, a narrow ResNet, strong
    augmentation), and the adversarial SSIM staged step, on this process's
    rows of a seeded 8x32x32 batch: loss, metrics, parameter abs-sums and
    running statistics after the update; ``grads`` receives each step's
    gradients."""
    grads = {} if grads is None else grads
    distributed.initialize(backend="gloo")
    rng = np.random.default_rng(11)
    raw = torch.from_numpy(rng.uniform(size=(B, SIZE, SIZE)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 3, size=(B,)))
    out = {}
    for case, kw, fuse in (
            ("staged", dict(augmentation="strong"), False),
            ("fused", dict(augmentation="strong"), True),
            ("adversarial", dict(adv_training=True, freeze_classifier=True,
                                 loss_weight=-1.0, adv_aux_weight=-1.0),
             False)):
        proc, clf = modules("classification", True)
        cfg = TrainConfig(lr=1e-3, **kw)
        state = create_train_state(cfg, proc, clf, split_opt=fuse)
        mets = make_staged_train_step(cfg, proc, clf, fuse_opt=fuse)(
            state, distributed.shard(raw), distributed.shard(y),
            torch.Generator().manual_seed(3))
        out[case] = {k: float(v) for k, v in mets.items()}
        for m, module in (("isp", proc), ("clf", clf)):
            out[case][f"{m}_abs_sum"] = sum(
                float(p.detach().double().abs().sum())
                for p in module.parameters())
            out[case][f"{m}_stats"] = sum(
                float(b.double().abs().sum())
                for n, b in module.named_buffers() if "running" in n)
        grads[case] = {f"{m}.{n}": p.grad.detach().clone()
                       for m, module in (("isp", proc), ("clf", clf))
                       for n, p in module.named_parameters()
                       if p.grad is not None}
    out["world"] = list(distributed.world())
    return out


CHILD = """
import json, torch
torch.set_num_threads(2)
from raw2logit_tpu_torch.parallel import distributed
from test_torch_staged_parallel import staged_report
grads = {}
print("REPORT " + json.dumps(staged_report(grads)), flush=True)
torch.save(grads, f"grads{distributed.world()[0]}.pt")
distributed.shutdown()
"""


def test_two_ranks_staged_equal_one_rank(tmp_path_factory):
    """Two gloo ranks each stepping on 4 of 8 rows: the staged step, with
    and without fuse_opt, and the adversarial staged step equal the
    one-rank staged step on the 8 rows (loss, metrics, abs-sums, running
    statistics at 1e-6 relative; each rank's gradients leaf by leaf at
    1e-4), as tests/test_torch_parallel.py holds the one step."""
    cwds = [tmp_path_factory.mktemp(f"rank{r}") for r in range(2)]
    procs = start(CHILD, 2, cwds=cwds)
    one_grads = {}
    one = staged_report(one_grads)
    two = reports(finish(procs))
    assert [r["world"] for r in two] == [[0, 2], [1, 2]]
    for case in ("staged", "fused", "adversarial"):
        for key, want in one[case].items():
            for r in two:
                got = r[case][key]
                assert abs(got - want) <= STEP_REL * max(abs(want), 1e-12), (
                    case, key, got, want)
        for rank in range(2):
            grads = torch.load(cwds[rank] / f"grads{rank}.pt")
            assert grad_rel(grads[case], one_grads[case]) < GRAD_REL, (
                case, rank)
