"""The reference side of the task-model kinds: ``<kind>.py`` holds a
kind's weight spec (``spec(model)``), its forward pass (``forward(model,
p, x, train, tf32)``) and its MACs per image from shapes (``macs(model,
height, width)``), in plain PyTorch; ``spec.model_kind`` finds it by a
configuration's ``model.kind``."""
