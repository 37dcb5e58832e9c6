"""``_shared.library_device_ms`` where the traffic kind is ``serve``."""

from h100_bench.metrics import _shared


def read(view):
    if not _shared.kind_is(view, "serve"):
        return None
    return _shared.library_device_ms(view)
