"""The figure CLIs: ``python -m raw2logit_tpu_torch.figures.ABtesting``
(the A/B and C tables and their images) and ``python -m
raw2logit_tpu_torch.figures.figures`` (stage GIFs, the loss scatter)."""
