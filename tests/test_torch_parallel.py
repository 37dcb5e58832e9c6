"""Data parallelism and the spatial and pipeline axes of the port
(``raw2logit_tpu_torch/parallel/``), on the CPU: two processes in a gloo
group each stepping on half of a global batch against one process on the
whole batch (tests/test_distributed.py's 1e-6 relative on the loss and
the parameter abs-sums), a two-process CLI run in which only rank 0
writes the run store, full frames split by rows against the unsplit run,
the pipeline grid against each pipeline alone, and a group of one that
calls no collective. Imports no JAX (the children import this module).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raw2logit_tpu_torch import losses
from raw2logit_tpu_torch.data import (DRONE_CAMERA_PARAMS,
                                      MICROSCOPY_CAMERA_PARAMS)
from raw2logit_tpu_torch.evaluation.abtesting import pipeline_grid
from raw2logit_tpu_torch.isp import ParametrizedProcessing, StaticPipeline
from raw2logit_tpu_torch.models import resnet_model
from raw2logit_tpu_torch.parallel import (distributed, make_mesh,
                                          process_full_frames,
                                          process_pipeline_grid, shard_batch)
from raw2logit_tpu_torch.parallel.spatial import row_blocks
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from raw2logit_tpu_torch.training import train as cli

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
B, SIZE, NCLS = 8, 32, 4
# tests/test_distributed.py holds JAX's two processes to one at 1e-6
# relative on the loss and the post-update parameter abs-sums; the BN
# running statistics at the same
STEP_REL = 1e-6
# the leaf gap measured on the CPU is at most 5.5e-6 (stem1); a gradient
# counted twice reads 1 on the leaves it touches
GRAD_REL = 1e-4


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def abssum(module):
    return sum(float(p.detach().double().abs().sum())
               for p in module.parameters())


def stats_sum(module):
    return sum(float(b.double().abs().sum())
               for n, b in module.named_buffers() if "running" in n)


def grads_of(*modules):
    """Each parameter's ``.grad`` (the all-reduced gradient that the
    optimizer stepped with), by module index and name."""
    return {f"{i}.{n}": p.grad.detach().clone()
            for i, m in enumerate(modules)
            for n, p in m.named_parameters() if p.grad is not None}


def grad_rel(got, want):
    """The largest over the leaves of |got - want| / |want| (L2 norms of
    the whole leaf). A gradient counted twice, on every leaf or on the
    BN's weights alone, reads 1."""
    assert got.keys() == want.keys(), set(got) ^ set(want)
    return max(float((got[k].double() - want[k].double()).norm())
               / max(float(want[k].double().norm()), 1e-30) for k in want)


def step_report(grads=None):
    """One train step of the parametrized ISP (the kernel path; its plain
    versions on the CPU) and ResNet-18, without and with the stem flag
    and strong augmentation, on this process's rows of a seeded 8x32x32
    batch; and the Dice loss and IoU with the loss's gradient. Under
    the environment's group, each rank takes its rows. ``grads``, a
    dict, receives each step's parameter gradients (``grads_of``)."""
    grads = {} if grads is None else grads
    distributed.initialize(backend="gloo")
    rng = np.random.default_rng(11)
    raw = torch.from_numpy(rng.uniform(size=(B, SIZE, SIZE)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, NCLS, size=(B,)))
    out = {}
    for stem, aug in ((False, "none"), (True, "strong")):
        proc = ParametrizedProcessing(MICROSCOPY_CAMERA_PARAMS,
                                      image_size=SIZE, use_kernel=True,
                                      device="cpu")
        clf = resnet_model("resnet18", fc_out_features=NCLS, device="cpu",
                           stem_kernel=stem)
        cfg = TrainConfig(lr=1e-3, augmentation=aug)
        state = create_train_state(cfg, proc, clf)
        mets = make_train_step(cfg, proc, clf)(
            state, distributed.shard(raw), distributed.shard(y),
            torch.Generator().manual_seed(3))
        out[f"stem{int(stem)}"] = {
            "loss": float(mets["loss"]), "accuracy": float(mets["accuracy"]),
            "isp_abs_sum": abssum(proc), "clf_abs_sum": abssum(clf),
            "isp_stats": stats_sum(proc), "clf_stats": stats_sum(clf)}
        grads[f"stem{int(stem)}"] = grads_of(proc, clf)
    # the adversarial step: the SSIM aux kernel's wrapper (its plain
    # version here) on the global batch, gamma alone trained
    proc = ParametrizedProcessing(MICROSCOPY_CAMERA_PARAMS, image_size=SIZE,
                                  use_kernel=True, device="cpu")
    clf = resnet_model("resnet18", fc_out_features=NCLS, device="cpu")
    cfg = TrainConfig(lr=1e-2, adv_training=True, freeze_classifier=True,
                      adv_aux_weight=-1.0, adv_parameters="gamma_correct",
                      loss_weight=-1.0)
    state = create_train_state(cfg, proc, clf)
    mets = make_train_step(cfg, proc, clf)(
        state, distributed.shard(raw), distributed.shard(y))
    out["adversarial"] = {"loss": float(mets["loss"]),
                          "loss_aux": float(mets["loss_aux"]),
                          "gamma": float(proc.gamma_correct.detach())}
    grads["adversarial"] = grads_of(proc, clf)
    logits = torch.from_numpy(rng.normal(size=(B, SIZE, SIZE)).astype(
        np.float32)).requires_grad_(True)
    masks = torch.from_numpy((rng.uniform(size=(B, SIZE, SIZE)) > 0.6)
                             .astype(np.float32))
    mine = distributed.shard(logits)
    dice = losses.dice_loss(mine, distributed.shard(masks))
    distributed.backward(dice)
    iou = losses.iou_score(torch.sigmoid(mine.detach()),
                           distributed.shard(masks))
    g = logits.grad
    if distributed.world()[1] > 1:  # each rank has its rows' gradient
        dist.all_reduce(g)
    out["dice"] = {"loss": float(dice.detach()), "iou": float(iou),
                   "grad_abs_sum": float(g.double().abs().sum())}
    out["world"] = list(distributed.world())
    return out


def start(code, n, cwds=None):
    """Start ``code`` in ``n`` processes of one gloo group."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
               NUM_PROCESSES=str(n))
    return [subprocess.Popen(
        [sys.executable, "-c", code], env=dict(env, PROCESS_ID=str(r)),
        cwd=(cwds[r] if cwds else None), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]


def finish(procs):
    """The stdouts of ``start``'s processes, each having exited with 0."""
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err[-3000:]}"
    return [out for out, _ in outs]


def reports(outs):
    return [json.loads(ln.split(" ", 1)[1]) for out in outs
            for ln in out.splitlines() if ln.startswith("REPORT ")]


CLI_ARGV = ["--dataset", "SyntheticMicroscopy", "--epochs", "2",
            "--batch_size", "4", "--test_run", "--device", "cpu",
            "--augmentation", "weak", "--experiment_name", "e",
            "--run_name", "r", "--track_processing"]
# each rank: step_report, then one CLI run in the same group, in its own
# working directory (16 32x32 SyntheticMicroscopy mosaics)
CHILD = f"""
import json, torch
torch.set_num_threads(2)
from raw2logit_tpu_torch.data import SyntheticRawClassification
from raw2logit_tpu_torch.parallel import distributed
from raw2logit_tpu_torch.training import train as cli
from test_torch_parallel import step_report
grads = {{}}
print("REPORT " + json.dumps(step_report(grads)), flush=True)
torch.save(grads, f"grads{{distributed.world()[0]}}.pt")
cli.get_dataset = lambda name, **kw: SyntheticRawClassification(
    n=16, h=32, w=32, seed=4)
(res,) = cli.main({CLI_ARGV!r})
print("RUN", res["run"] is None, flush=True)
distributed.shutdown()
"""


@pytest.fixture(scope="module")
def two_and_one(tmp_path_factory):
    """The two ranks' reports, stdouts and working directories, and the
    one-process report; then the ranks' and the one process's
    gradients."""
    cwds = [tmp_path_factory.mktemp(f"rank{r}") for r in range(2)]
    procs = start(CHILD, 2, cwds=cwds)
    one_grads = {}
    one = step_report(one_grads)  # while the two ranks run
    outs = finish(procs)
    two_grads = [torch.load(cwds[r] / f"grads{r}.pt") for r in range(2)]
    return reports(outs), one, outs, cwds, two_grads, one_grads


def test_two_ranks_agree_with_each_other(two_and_one):
    (r0, r1), *_ = two_and_one
    assert r0["world"] == [0, 2] and r1["world"] == [1, 2]
    assert {k: v for k, v in r0.items() if k != "world"} == {
        k: v for k, v in r1.items() if k != "world"}


@pytest.mark.parametrize("case", ["stem0", "stem1"])
def test_two_process_step_equals_one_process_step(two_and_one, case):
    """The train step (ISP, ResNet-18, Adam) on 2 x 4 rows equals the
    step on the 8 rows: loss, accuracy, parameter abs-sums after the
    update, running statistics. stem1: the stem flag (its float64 sums
    reduced over the ranks) and strong augmentation (drawn for the
    global batch)."""
    (two, _), one, *_ = two_and_one
    assert one["world"] == [0, 1]
    for key, want in one[case].items():
        assert rel(two[case][key], want) < STEP_REL, (key, two[case][key],
                                                      want)


def test_two_process_adversarial_step_equals_one_process_step(two_and_one):
    """The SSIM-regularised attack on gamma: the aux term is the global
    batch's mean SSIM, and gamma takes the one-process update."""
    (two, _), one, *_ = two_and_one
    for key, want in one["adversarial"].items():
        assert rel(two["adversarial"][key], want) < STEP_REL, key


@pytest.mark.parametrize("case", ["stem0", "stem1", "adversarial"])
def test_two_process_gradients_equal_one_process_gradients(two_and_one,
                                                           case):
    """The gradient that each rank's Adam steps with (after the
    all-reduce) against the one-process step's, leaf by leaf: the BN
    weights and biases, the stem's, the ISP's kernel-path parameters and
    the attack's gamma. Adam's first update is about lr sign(g), so the
    abs-sums above cannot see a gradient counted N times; this can."""
    *_, two_grads, one_grads = two_and_one
    for rank, grads in enumerate(two_grads):
        gap = grad_rel(grads[case], one_grads[case])
        assert gap < GRAD_REL, (rank, gap)


def test_two_process_dice_and_iou_are_the_global_batch_s(two_and_one):
    (two, _), one, *_ = two_and_one
    for key, want in one["dice"].items():
        assert rel(two["dice"][key], want) < STEP_REL, key


def test_two_process_cli_only_rank_0_writes(two_and_one):
    """CLI_ARGV in a two-process group: rank 0 writes the run store, the
    checkpoints and the tracked images, rank 1 (in its own directory)
    nothing."""
    _, _, outs, cwds, *_ = two_and_one
    assert "RUN False" in outs[0] and "RUN True" in outs[1]
    assert "data mesh: 2 device(s)" in outs[0]
    fold = cwds[0] / "results" / "runs" / "e" / "r" / "r_0"
    metrics = [json.loads(ln) for ln in open(fold / "metrics.jsonl")]
    assert [m["step"] for m in metrics] == [0, 0, 1, 1]
    assert {"classifier.pt", "processor.pt"} <= set(os.listdir(
        fold / "checkpoints"))
    assert "img_processing_0_demosaic.png" in os.listdir(fold / "results")
    assert not (cwds[1] / "results" / "runs").exists()


def test_n_devices_without_a_group_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="NUM_PROCESSES=2 PROCESS_ID"):
        cli.main(["--dataset", "SyntheticMicroscopy", "--device", "cpu",
                  "--n_devices", "2", "--batch_size", "4"])


def test_make_mesh_and_shards():
    assert make_mesh(kind="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="requested a 2-device mesh but "
                                         "only 1 device"):
        make_mesh(2, kind="cpu")
    x = torch.arange(6)
    assert shard_batch((x, {"y": x})) == (x, {"y": x})
    assert row_blocks(10, 3) == [(0, 2), (2, 6), (6, 10)]


def test_a_group_of_one_calls_no_collective(monkeypatch, tmp_path):
    """In a gloo group of one the step and the CLI's data-parallel setup
    run without a collective (every reduction is a no-op)."""
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, "gloo")
    try:
        def refuse(*a, **k):
            raise AssertionError("a collective in a group of one")
        for name in ("all_reduce", "broadcast", "all_gather", "barrier"):
            monkeypatch.setattr(dist, name, refuse)
        assert distributed.world() == (0, 1) and not distributed.active()
        proc = ParametrizedProcessing(MICROSCOPY_CAMERA_PARAMS,
                                      image_size=16, device="cpu")
        clf = resnet_model("resnet18", fc_out_features=2, device="cpu",
                           stem_kernel=True)
        cfg = TrainConfig(lr=1e-3, augmentation="strong")
        state = create_train_state(cfg, proc, clf)
        raw = torch.rand(4, 16, 16, generator=torch.Generator().manual_seed(0))
        mets = make_train_step(cfg, proc, clf)(
            state, raw, torch.tensor([0, 1, 0, 1]),
            torch.Generator().manual_seed(1))
        assert np.isfinite(float(mets["loss"]))
        args = cli.build_parser().parse_args(["--n_devices", "1",
                                              "--batch_size", "4"])
        assert cli.data_parallel_devices(args, torch.device("cpu")) == (
            1, torch.device("cpu"))
    finally:
        monkeypatch.undo()
        distributed.shutdown()


# --- the spatial axis -------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.uniform(0.05, 0.95, (2, 130, 48)).astype(
        np.float32))


SPLIT_TOL = 1e-6  # tests/test_spatial.py holds JAX's split to 1e-6


@pytest.mark.parametrize("pipe", [
    ("malvar2004", "sharpening_filter", "median_denoising"),
    ("malvar2004", "sharpening_filter", "gaussian_denoising"),
    ("menon2007", "unsharp_masking", "gaussian_denoising"),
    ("bilinear", "unsharp_masking", "fft_denoising")], ids="-".join)
def test_full_frames_split_match_unsplit(frames, pipe):
    p = StaticPipeline(DRONE_CAMERA_PARAMS, *pipe)
    want = p(frames)
    for devices in (["cpu", "cpu"], ["cpu"] * 3):
        got = process_full_frames(p, devices, frames)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=SPLIT_TOL)


def test_a_halo_too_small_differs(frames):
    """malvar2004 + sharpening + gaussian reach 5 rows: a 2-row halo moves
    the rows next to each cut."""
    p = StaticPipeline(DRONE_CAMERA_PARAMS, "malvar2004",
                       "sharpening_filter", "gaussian_denoising")
    assert p.halo_rows == 5
    err = (process_full_frames(p, ["cpu", "cpu"], frames, halo=2)
           - p(frames)).abs().amax(dim=(0, 1, 3))
    assert float(err.max()) > 1e-3
    assert float(err[:60].max()) == 0.0 and float(err[68:].max()) == 0.0


@pytest.mark.parametrize("bn", [False, True])
def test_parametrized_eval_split_matches(frames, bn):
    proc = ParametrizedProcessing(DRONE_CAMERA_PARAMS, image_size=None,
                                  batch_norm_output=bn, use_kernel=True,
                                  device="cpu").eval()
    with torch.no_grad():
        want = proc(frames)[0]
        got = process_full_frames(proc, ["cpu", "cpu"], frames)
    torch.testing.assert_close(got, want, rtol=0, atol=SPLIT_TOL)


def test_whole_frame_pipelines_raise(frames):
    proc = ParametrizedProcessing(DRONE_CAMERA_PARAMS, image_size=None,
                                  device="cpu").train()
    with pytest.raises(ValueError, match="whole frame"):
        process_full_frames(proc, ["cpu", "cpu"], frames)
    tv = StaticPipeline(DRONE_CAMERA_PARAMS, denoising="tv_chambolle")
    with pytest.raises(ValueError, match="whole frame"):
        process_full_frames(tv, ["cpu", "cpu"], frames)


# --- the pipeline axis ------------------------------------------------------


@pytest.mark.parametrize("n_devices", [2, 5])
def test_pipeline_grid_matches_each_pipeline(n_devices):
    """The 12 pipelines over 2 devices, and over 5 (not a divisor)."""
    raw = torch.rand(2, 32, 24, generator=torch.Generator().manual_seed(2))
    pipes = [StaticPipeline(MICROSCOPY_CAMERA_PARAMS, *p)
             for p in pipeline_grid()]
    got = process_pipeline_grid(pipes, ["cpu"] * n_devices, raw)
    assert got.shape == (12, 2, 3, 32, 24)
    for i, p in enumerate(pipes):
        torch.testing.assert_close(got[i], p(raw), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no pipelines"):
        process_pipeline_grid([], ["cpu"], raw)
