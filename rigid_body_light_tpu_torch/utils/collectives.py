"""The collectives of the distributed path on a ``torch.distributed``
process group — what ``lax.psum``, ``pmin`` / ``pmax``,
``all_gather(tiled=True)``, the ring's ``ppermute`` and ``axis_index``
are inside the JAX package's ``shard_map``.

Every function takes the group of one mesh dimension; ``None`` means one
device (``axis_name=None`` in the JAX package) and returns its input
unchanged.  Each call is one collective on that group, timed under the
``collective`` span of :class:`.profiling.StepTimer`.  The backend is the
group's own (NCCL for CUDA tensors, gloo for CPU tensors; gloo reduces
and gathers a CUDA tensor through the host, and the ring's send and
receive, which gloo does not carry for CUDA tensors, are staged through
the host here, so several gloo ranks can share one card): nothing here
picks another backend or falls back to the single-device path when a
collective fails.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from rigid_body_light_tpu_torch.utils import profiling


def rank(group) -> int:
    """This process's index in ``group`` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def size(group) -> int:
    """The number of processes in ``group`` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def _reduce(x, group, op):
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    with profiling.span("collective"):
        dist.all_reduce(y, op=op, group=group)
    return y


def psum(x, group):
    """Σ of ``x`` over the group (``lax.psum``), a new tensor."""
    return _reduce(x, group, dist.ReduceOp.SUM)


def pmin(x, group):
    """Elementwise minimum over the group (``lax.pmin``)."""
    return _reduce(x, group, dist.ReduceOp.MIN)


def pmax(x, group):
    """Elementwise maximum over the group (``lax.pmax``)."""
    return _reduce(x, group, dist.ReduceOp.MAX)


def all_gather(x, group, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``); every rank's ``x`` has the same
    shape."""
    if group is None:
        return x
    d = size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((d * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with profiling.span("collective"), warnings.catch_warnings():
        # newer releases rename it all_gather_single; the card's has only
        # this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def ring_shift(tensors, group):
    """Post the ring step of ``lax.ppermute`` with perm i → i + 1: send each
    tensor to rank (r + 1) % D and receive its like from (r − 1) % D, as
    one ``batch_isend_irecv``.  Returns (received tensors, wait): the
    receives are valid after ``wait()``, so the caller overlaps the
    transfer with work on the tensors it holds."""
    d, r = size(group), rank(group)
    peer_next = dist.get_global_rank(group, (r + 1) % d)
    peer_prev = dist.get_global_rank(group, (r - 1) % d)
    recv = [torch.empty_like(t) for t in tensors]
    host = tensors[0].is_cuda and dist.get_backend(group) == "gloo"
    with profiling.span("collective"):
        sends = [t.cpu() if host else t.contiguous() for t in tensors]
        bufs = [torch.empty_like(t) for t in sends] if host else recv
        ops = []
        for t, buf in zip(sends, bufs):
            ops.append(dist.P2POp(dist.isend, t, peer_next, group=group))
            ops.append(dist.P2POp(dist.irecv, buf, peer_prev, group=group))
        reqs = dist.batch_isend_irecv(ops)

    def wait():
        # ``sends`` stays referenced until the transfers are done
        with profiling.span("collective"):
            for q in reqs:
                q.wait()
            if host:
                for out, buf in zip(recv, bufs):
                    out.copy_(buf)
        sends.clear()
    return recv, wait
