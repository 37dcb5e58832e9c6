"""The port's spans (``raw2logit_tpu_torch/tracing.py``) on the CPU: off
by default and then inert; on, the train step's, the served call's, the
loader's and the state set-up's spans, each stage inside its step's or
call's interval, on the profiler's clock; and a step with tracing on trains bit for bit as one
with it off."""

import threading

import numpy as np
import pytest
import torch

from raw2logit_tpu_torch import tracing
from raw2logit_tpu_torch.data import Loader
from raw2logit_tpu_torch.data.loader import ArrayDataset
from raw2logit_tpu_torch.serving import Predictor
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from test_torch_staged import (LR, modules, mosaics,  # noqa: F401
                               one_torch_thread)

STEP_CHILDREN = ["r2l.step.process", "r2l.step.task", "r2l.step.backward",
                 "r2l.step.optimizer"]
ADV = TrainConfig(lr=LR, adv_training=True, freeze_classifier=True,
                  loss_weight=-1.0, adv_aux_weight=-1.0)
CONFIGS = {"joint": (TrainConfig(lr=LR), False),
           "adversarial": (ADV, True)}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty record."""
    tracing.disable()
    yield
    tracing.disable()


def traced(fn):
    """(what ``fn()`` returns, the spans it recorded) with tracing on."""
    tracing.enable()
    try:
        out = fn()
    finally:
        spans = tracing.disable()
    return out, spans


def inside(spans, top):
    """The spans other than ``top`` whose interval lies in ``top``'s, in
    the order they started."""
    return sorted((s for s in spans if s is not top
                   and top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns),
                  key=lambda s: s.start_ns)


def setup(kind):
    cfg, noise = CONFIGS[kind]
    proc, clf = modules("classification", True, noise=noise)
    return cfg, proc, clf


def test_off_by_default_records_nothing():
    """Off, ``span`` is one shared no-op object, a wrapped function runs
    as it is, and a profile of a train step holds no ``r2l.`` range."""
    assert tracing.span("r2l.a") is tracing.span("r2l.b")
    assert tracing.span("r2l.a") is tracing.NOOP
    with tracing.span("r2l.a") as s:
        assert s is tracing.NOOP
    assert tracing.span("r2l.f", lambda x: x + 1)(1) == 2
    cfg, proc, clf = setup("joint")
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    raw, y = mosaics("classification")
    with torch.profiler.profile() as prof:
        step(state, raw, y)
    assert not [e.name for e in prof.events() if e.name.startswith("r2l.")]
    assert tracing.disable() == []


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_train_step_records_its_stages(kind):
    """Two steps: each an ``r2l.step`` whose interval holds its stages in
    order (``r2l.step.aux`` before the backward in adversarial mode), one
    after the other."""
    cfg, proc, clf = setup(kind)
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    raw, y = mosaics("classification")
    _, spans = traced(lambda: [step(state, raw, y) for _ in range(2)])
    steps = [s for s in spans if s.name == "r2l.step"]
    assert len(steps) == 2 and steps[0].end_ns <= steps[1].start_ns
    want = list(STEP_CHILDREN)
    if kind == "adversarial":
        want.insert(2, "r2l.step.aux")
    for top in steps:
        children = inside(spans, top)
        assert [s.name for s in children] == want
        assert all(a.end_ns <= b.start_ns
                   for a, b in zip(children, children[1:]))
    assert len(spans) == 2 * (1 + len(want))


def test_predictor_call_records_its_stages():
    proc, clf = modules("classification", True)
    pred = Predictor(proc, clf, device="cpu")
    raw, _ = mosaics("classification")
    batch = raw.numpy()
    _, spans = traced(lambda: [pred(batch), pred(batch)])
    calls = [s for s in spans if s.name == "r2l.serve"]
    assert len(calls) == 2 and len(spans) == 8
    for top in calls:
        assert [s.name for s in inside(spans, top)] == [
            "r2l.serve.copy_in", "r2l.serve.process", "r2l.serve.model"]


@pytest.mark.parametrize("split_opt", [False, True], ids=["joint", "split"])
def test_setup_records_the_state(split_opt):
    """``create_train_state`` (the reference copy and Adam's construction)
    records one ``r2l.setup.state``; building the step records nothing."""
    cfg, proc, clf = setup("adversarial")
    _, spans = traced(lambda: (
        create_train_state(cfg, proc, clf, split_opt=split_opt),
        make_train_step(cfg, proc, clf)))
    assert [s.name for s in spans] == ["r2l.setup.state"]
    assert spans[0].start_ns <= spans[0].end_ns


@pytest.mark.parametrize("prefetch", [True, False],
                         ids=["prefetch", "inline"])
@pytest.mark.parametrize("n, drop_last, batches",
                         [(10, False, 3), (10, True, 2), (3, True, 0)])
def test_loader_records_one_wait_per_batch(prefetch, n, drop_last,
                                           batches):
    data = ArrayDataset(np.arange(n * 4, dtype=np.float32).reshape(n, 2, 2),
                        np.arange(n))
    loader = Loader(data, 4, shuffle=True, drop_last=drop_last, seed=1,
                    prefetch=prefetch)
    got, spans = traced(lambda: list(loader))
    assert len(got) == len(loader) == batches
    assert [s.name for s in spans] == ["r2l.loader.wait"] * batches
    # the order is the loader's whether the waits are traced or not
    want = Loader(data, 4, shuffle=True, drop_last=drop_last, seed=1,
                  prefetch=prefetch)
    for (x, y), (wx, wy) in zip(got, list(want)):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_tracing_changes_nothing_trained(kind):
    """One step with tracing on and one with it off, each from the same
    seeded state: equal losses, parameters and Adam moments, bit for
    bit."""
    raw, y = mosaics("classification")
    out = []
    for on in (False, True):
        cfg, proc, clf = setup(kind)
        state = create_train_state(cfg, proc, clf)
        step = make_train_step(cfg, proc, clf)
        if on:
            mets, _ = traced(lambda: step(state, raw, y))
        else:
            mets = step(state, raw, y)
        params = [p.detach().clone() for m in (proc, clf)
                  for p in m.parameters()]
        moments = [t.clone() for st in state.optimizer.state.values()
                   for t in (st["exp_avg"], st["exp_avg_sq"])]
        out.append((mets, params, moments))
    (m0, p0, a0), (m1, p1, a1) = out
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert len(p0) == len(p1) and len(a0) == len(a1) > 0
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(a0, a1))


def test_spans_lie_on_the_profiler_clock():
    """Under ``torch.profiler`` every span is also a profiler range of
    its name, and the spans start within 1 ms of their ranges (the median
    over one step's spans, so that a thread preempted between the two
    stamps does not decide; one warm step first: the first range a
    process opens pays its set-up)."""
    cfg, proc, clf = setup("adversarial")
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    raw, y = mosaics("classification")
    traced(lambda: step(state, raw, y))

    def profiled():
        with torch.profiler.profile() as prof:
            step(state, raw, y)
        return prof
    prof, spans = traced(profiled)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("r2l.")}
    assert sorted(ranges) == sorted(s.name for s in spans)
    offsets = sorted(abs(ranges[s.name].start_ns() - s.start_ns)
                     for s in spans)
    assert offsets[len(offsets) // 2] < 1_000_000, offsets


def test_spans_on_another_thread_are_recorded():
    """A span opened and closed on another thread while one is open on
    this thread is recorded too, inside that one's interval."""
    def other():
        with tracing.span("r2l.other"):
            pass

    def body():
        with tracing.span("r2l.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    _, spans = traced(body)
    assert [s.name for s in spans] == ["r2l.other", "r2l.main"]
    assert [s.name for s in inside(spans, spans[1])] == ["r2l.other"]
