"""The data-parallel devices (port of ``raw2logit_tpu/parallel/mesh.py``).

JAX lays one process's chips out in a mesh and shards the batch over it;
torch runs one process per device, so the "mesh" is the list of the
ranks' devices and a rank's shard of a batch is its rows of it.
"""

import torch

from raw2logit_tpu_torch.parallel import distributed


def make_mesh(n_devices=None, kind="cuda"):
    """The devices of the group's ranks, rank r on ``cuda:<r % device
    count>`` (or the CPU for ``kind`` cpu), the first ``n_devices`` of
    them; raises, with the JAX package's message, past the ranks there
    are."""
    _, size = distributed.world()
    if n_devices is not None and n_devices > size:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {size} device(s) "
            f"are available")
    n = size if n_devices is None else n_devices
    if torch.device(kind).type != "cuda":
        return [torch.device(kind)] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


def shard_batch(batch):
    """This rank's rows of each array of a (nested) global batch."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x) for x in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v) for k, v in batch.items()}
    return distributed.shard(batch)
