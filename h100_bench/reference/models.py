"""The task models of the reference, by a configuration's ``model.kind``:
``reference/kinds/<kind>.py`` (found by ``spec.model_kind``) holds the
kind's weight spec and forward pass in plain PyTorch over dicts of
tensors, under the port's state dict names."""

from h100_bench import spec


def model_spec(model):
    """[(state dict name, shape, kind)] of a configuration's ``model``
    entry, in the port's order of ``state_dict()``."""
    return spec.model_kind(model["kind"]).spec(model)


def model_forward(model, p, x, train, tf32=False):
    """The configuration's task model on ``x``."""
    return spec.model_kind(model["kind"]).forward(model, p, x, train, tf32)
