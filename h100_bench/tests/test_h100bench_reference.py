"""The reference against the port at a tiny size on the CPU: every cell
comes out correct; the control (the reference in TF32 in the program's
place) and each fault planted in the timed path come out not correct."""

import pytest
import torch

from h100_bench import checks, data, program, run, spec
from h100_bench.reference import step as ref_step
from h100_bench.reference.isp import initial_params
from h100_bench.reference.models import model_spec
from h100_bench.tests import tiny
from h100_bench.traffic import serve as serve_kind
from h100_bench.traffic import train as train_kind

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["cls_train", "cls_forensics", "cls_serve",
                                  "seg_train"])
def test_the_port_is_correct(name):
    line, _ = tiny.run_tiny(name, program)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def _train_control(name):
    """The gaps of the TF32 reference against the cell's reference on the
    tiny cell's first three batches."""
    cell = tiny.cell(name)
    config, traffic = cell.config, cell.traffic
    ctx = run.Context(cell, tiny.SEED, 0.1, False, CPU, program)
    isp0, _ = initial_params(spec.camera(config), config["image_size"],
                             traffic.get("adversarial", False), CPU)
    model0 = data.weights(model_spec(config["model"]), tiny.SEED, CPU)
    raw, y = data.pool(config, traffic, tiny.SEED, CPU)
    feed = data.EpochFeed([raw, y], traffic["batch"], tiny.SEED, CPU)
    batches = [tuple(feed.next()) for _ in range(3)]
    ctl = ref_step.train_steps(config, traffic, isp0, model0, batches,
                               tf32=True)
    ref = train_kind.reference(ctx, isp0, model0, batches, ctl["starts"])
    if traffic.get("adversarial"):
        ctl["frozen_moved"] = 0.0
    return cell, checks.train_gaps(ctl, ref)


@pytest.mark.parametrize("name", ["cls_train", "cls_forensics",
                                  "seg_train"])
def test_the_control_fails_a_train_cell(name):
    cell, gaps = _train_control(name)
    correct, checked = checks.judge(gaps, cell.limits)
    assert not correct, checked


def test_the_control_fails_the_serve_cell():
    cell = tiny.cell("cls_serve")
    config, traffic = cell.config, cell.traffic
    isp0, _ = initial_params(spec.camera(config), config["image_size"],
                             False, CPU)
    model0 = data.weights(model_spec(config["model"]), tiny.SEED, CPU)
    host = serve_kind.host_batches(config, traffic, tiny.SEED, CPU)
    ctx = run.Context(cell, tiny.SEED, 0.1, False, CPU, program)
    ref = serve_kind.reference(ctx, isp0, model0, host)
    ctl = [(k, ref_step.serve_batch(config, isp0, model0,
                                    torch.from_numpy(b), tf32=True))
           for k, b in enumerate(host)]
    correct, checked = checks.judge(
        {"logit_gap": checks.serve_gap(ctl, ref)}, cell.limits)
    assert not correct, checked


class _Broken:
    """The program with one fault planted in its timed path."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, name):
        return getattr(program, name)

    def make_state_and_step(self, config, traffic, processor, model):
        state, step = program.make_state_and_step(config, traffic,
                                                  processor, model)
        if self.fault == "unchanged":
            for opt in [state.optimizer]:
                opt.step = lambda *a, **k: None
            return state, step
        if self.fault == "half_batch":
            def half(state, raw, y, generator=None):
                n = len(raw) // 2
                return step(state, raw[:n], y[:n], generator)
            return state, half
        if self.fault == "altered":
            processor.register_forward_hook(
                lambda mod, args, out: (out[0] + 1e-2 * (
                    torch.arange(len(out[0])) == 0).float()[:, None, None,
                                                            None],
                    out[1]))
        return state, step

    def predictor(self, processor, model, config, device):
        pred = program.predictor(processor, model, config, device)
        if self.fault == "altered":
            def call(raw):
                out = pred(raw).clone()
                out[0] = out[1]
                return out
            return call
        if self.fault == "half_batch":
            return lambda raw: pred(raw[:len(raw) // 2])
        return pred


@pytest.mark.parametrize("name,fault", [
    ("cls_train", "unchanged"), ("cls_train", "half_batch"),
    ("cls_train", "altered"), ("seg_train", "unchanged"),
    ("seg_train", "half_batch"), ("cls_forensics", "unchanged"),
    ("cls_forensics", "half_batch"), ("cls_forensics", "altered"),
    ("cls_serve", "altered"), ("cls_serve", "half_batch")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    line, _ = tiny.run_tiny(name, _Broken(fault))
    assert not line["correct"], line["checks"]
