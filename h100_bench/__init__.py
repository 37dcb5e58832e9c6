"""The benchmark of the PyTorch and CUDA port (``raw2logit_tpu_torch``):
``run.py`` runs one cell once. See ``PERF.md`` at the root of the
repository for the cells, the metrics and how ``correct`` is decided."""
