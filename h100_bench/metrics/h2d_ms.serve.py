"""``_shared.h2d_ms`` where the traffic kind is ``serve``."""

from h100_bench.metrics import _shared


def read(view):
    if not _shared.kind_is(view, "serve"):
        return None
    return _shared.h2d_ms(view)
