"""Evaluation: the corruption battery, confusion metrics, the A/B and C
tables (``abtesting``) and the figure tooling (``figures``)."""

from raw2logit_tpu_torch.evaluation.corruptions import (  # noqa: F401
    CORRUPTIONS, distort)
from raw2logit_tpu_torch.evaluation.metrics import (  # noqa: F401
    ConfusionMetrics, over_n_runs)
