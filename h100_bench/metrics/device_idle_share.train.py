"""``_shared.device_idle_share`` where the traffic kind is ``train``."""

from h100_bench.metrics import _shared


def read(view):
    if not _shared.kind_is(view, "train"):
        return None
    return _shared.device_idle_share(view)
