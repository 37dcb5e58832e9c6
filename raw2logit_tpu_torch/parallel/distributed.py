"""Process groups for data-parallel training (port of
``raw2logit_tpu/parallel/distributed.py``).

torch's idiom is one process per device: N processes, each holding B/N
rows of every global batch, joined by a ``torch.distributed`` process
group. ``initialize`` starts that group from the JAX package's
environment names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``), and the reductions below give every step the global
batch's semantics: the batch-norm statistics and their cotangents, the
losses and metrics that reduce over the batch, and the parameter
gradients are summed over the ranks.

The reductions are the SPMD adjoints: ``global_sum`` sums its input
over the ranks and, in the backward, sums the cotangents over the ranks.
With every rank backpropagating ``loss / world_size`` (``backward``) the
sum of the ranks' objectives is the global loss, so the gradients are
counted once. Without a group, or in a group of one, every function
here calls no collective and does no extra work.
"""

import contextlib
import os
import threading

import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None):
    """Join the process group named by the arguments or, in their place,
    ``COORDINATOR_ADDRESS`` (host:port of rank 0), ``NUM_PROCESSES`` and
    ``PROCESS_ID``. A no-op returning False without an address, and when
    this process is in a group already returns True. ``backend`` defaults
    to ``nccl`` where CUDA is available and ``gloo`` otherwise; a CUDA
    rank is bound to ``device()`` first."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    size = int(num_processes if num_processes is not None
               else os.environ["NUM_PROCESSES"])
    rank = int(process_id if process_id is not None
               else os.environ["PROCESS_ID"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=size, rank=rank)
    return True


def shutdown():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world():
    """(rank, size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary():
    """True on the process that writes the run store, the checkpoints and
    the tracked images."""
    return world()[0] == 0


_local = threading.local()  # .replicated: inside ``replicated()``


def active():
    """True when the steps reduce over ranks: a group of two or more, and
    not inside ``replicated()`` on this thread."""
    return world()[1] > 1 and not getattr(_local, "replicated", False)


@contextlib.contextmanager
def replicated():
    """Within this context (on this thread) every rank computes on whole
    batches of its own and nothing is reduced: a validation batch with
    fewer rows than ranks, and the tracked images, which rank 0 alone
    computes."""
    was = getattr(_local, "replicated", False)
    _local.replicated = True
    try:
        yield
    finally:
        _local.replicated = was


def device(kind="cuda"):
    """This rank's device: ``cuda:<PROCESS_ID % device_count>`` (the
    group's rank where there is a group), or the CPU for ``kind`` cpu."""
    if torch.device(kind).type != "cuda":
        return torch.device(kind)
    rank = (world()[0] if dist.is_initialized()
            else int(os.environ.get("PROCESS_ID", 0)))
    return torch.device("cuda", rank % torch.cuda.device_count())


def rows(n):
    """[lo, hi) of this rank's rows of a global batch of ``n`` rows:
    rank r holds rows [r n / N, (r + 1) n / N)."""
    rank, size = world()
    return rank * n // size, (rank + 1) * n // size


def shard(x):
    """This rank's rows of a global batch (``x`` itself without a
    group)."""
    if world()[1] == 1:
        return x
    lo, hi = rows(len(x))
    return x[lo:hi]


def all_reduce_(t):
    """Sum ``t`` over the ranks in place (no autograd); returns it."""
    if active():
        dist.all_reduce(t)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return _GlobalSum.apply(g)


def global_sum(x):
    """``x`` summed over the ranks, differentiable: the backward sums the
    cotangents over the ranks (the adjoint of the sum). ``x`` itself
    outside ``active()``."""
    return _GlobalSum.apply(x) if active() else x


def global_mean(local_sum, n_local):
    """sum over ranks of ``local_sum`` / sum over ranks of ``n_local``:
    a mean over the global batch from each rank's sum over its rows."""
    n = torch.as_tensor(float(n_local), dtype=local_sum.dtype,
                        device=local_sum.device)
    tot = global_sum(torch.stack([local_sum, n]))
    return tot[0] / tot[1]


def batch_mean(value, n_local):
    """The global batch's mean from ``value``, a mean over this rank's
    ``n_local`` rows (``value`` itself outside ``active()``)."""
    return global_mean(value * n_local, n_local) if active() else value


def backward(loss):
    """``loss.backward()`` of a global loss, with each rank's objective
    its 1 / N share, so that the gradients summed by ``all_reduce_grads``
    count it once."""
    if active():
        loss = loss / world()[1]
    loss.backward()


def all_reduce_grads(params):
    """Sum the ``.grad`` of ``params`` over the ranks: one collective on
    one flat buffer per dtype."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in {g.dtype for g in grads}:
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of (B, C, ...) over the global batch:
    (y, mean, biased variance, float64 count). The statistics are summed over
    the ranks in float64; the backward sums sum(dy) and sum(dy xhat) over
    the ranks, and gives ``weight`` and ``bias`` this rank's share (the
    gradient all-reduce adds the rest)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.ndim))
        c, xd = x.shape[1], x.double()
        tot = all_reduce_(torch.cat([xd.sum(dims), (xd * xd).sum(dims),
                                     xd.new_full((1,), x.numel() // c)]))
        s1, s2, n = tot[:c], tot[c:2 * c], tot[2 * c]
        mean = s1 / n
        var = (s2 / n - mean * mean).clamp_min(0.0)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        r = torch.rsqrt(var + eps).float()
        xhat = (x - mean.float().view(shape)) * r.view(shape)
        y = xhat
        if weight is not None:
            y = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, r, weight)
        ctx.dims, ctx.n, ctx.shape = dims, n, shape
        mean, var = mean.float(), var.float()
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var, _d_n):
        xhat, r, weight = ctx.saved_tensors
        shape = ctx.shape
        dyd, c = dy.double(), xhat.shape[1]
        local = torch.cat([dyd.sum(ctx.dims),
                           (dyd * xhat.double()).sum(ctx.dims)])
        d_bias, d_weight = local[:c].float(), local[c:].float()
        tot = all_reduce_(local.clone()) / ctx.n
        m1, m2 = tot[:c].float(), tot[c:].float()
        scale = r if weight is None else r * weight
        dx = (dy - m1.view(shape) - xhat * m2.view(shape)) * scale.view(shape)
        if weight is None:
            return dx, None, None, None
        return dx, d_weight, d_bias, None


def sync_batch_norm(x, weight=None, bias=None, eps=1e-5):
    """Train-mode batch norm over the global batch: (y, batch mean, biased
    batch variance, global count), mean and variance in float32."""
    y, mean, var, n = _SyncBatchNorm.apply(x, weight, bias, eps)
    return y, mean, var, int(n)
