"""The paper's three experiment drivers on the port (ports of the
repository's ``examples/``), each ``python -m
raw2logit_tpu_torch.examples.<name>``: ``drift_forensics`` (the
adversarial ISP search), ``drift_optimization`` (frozen against joint
ISP training) and ``drift_cycle`` (train per static pipeline, then the
A/B table). Their reports go under ``results/torch/`` by default."""
