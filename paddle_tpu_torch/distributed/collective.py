"""Collectives — port of ``paddle_tpu/distributed/collective.py``.

The reference's group is a named mesh axis: inside an SPMD trace its
collectives lower to ``lax.psum`` / ``lax.all_gather`` over the chips,
and eagerly with one participant they are identities (its world-size-1
fast path, ``collective.py:289-330``). The port's group is a
``torch.distributed`` process group, one process a rank: :class:`Group`
wraps a ``ProcessGroup`` and every function here calls the
``torch.distributed`` collective on it, in place where torch's is. With
one participant (no process group, or a group of one rank) each call is
the identity, as the reference's.

The reference's key-value-store plumbing for eager subgroups and
point-to-point traffic (``collective.py:113-281``, ``:550-600``) has no
counterpart: ``torch.distributed`` does that job itself.

Where a backend lacks an operation the rule is stated here, not found at
run time: ``reduce_scatter`` over ``gloo`` is an ``all_reduce`` of the
stacked inputs followed by this rank's slice; ``ReduceOp.AVG`` is a sum
divided by the group's size (``gloo`` has no average).

The model-parallel helpers of the reference (``_mp_allreduce``,
``_c_identity``, ``_c_concat``, ``_c_split``, ``collective.py:693-724``)
are the forward halves of Megatron's conjugate operators: an all-reduce,
the identity, an all-gather along the last axis and this rank's slice of
it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import env

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "broadcast", "reduce",
           "reduce_scatter", "scatter", "alltoall", "barrier", "send",
           "recv", "get_backend", "destroy_process_group", "wait",
           "is_available"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A communicator: ``pg`` the ``torch.distributed`` process group
    (None for a group of this process alone), ``ranks`` its global
    ranks, ``rank`` this process's rank in it (-1 outside it)."""

    _next_id = [1]

    def __init__(self, pg=None, ranks=None, gid=None):
        self.pg = pg
        if ranks is None:
            ranks = (list(range(dist.get_world_size(pg)))
                     if pg is not None else [0])
        self.ranks = list(ranks)
        self.id = gid if gid is not None else Group._next_id[0]
        Group._next_id[0] += 1

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self):
        if self.pg is None:
            return 0
        return dist.get_rank(self.pg)

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def backend(self):
        return "none" if self.pg is None else str(dist.get_backend(self.pg))

    def __repr__(self):
        return f"Group(id={self.id}, backend={self.backend}, " \
               f"ranks={self.ranks})"


_groups = {}


def _default_group():
    g = _groups.get(0)
    if env.is_initialized():
        if g is None or g.pg is None:
            g = _groups[0] = Group(dist.group.WORLD, gid=0)
    elif g is None or g.pg is not None:
        g = _groups[0] = Group(None, gid=0)
    return g


def _get_group(group):
    if group is None:
        return _default_group()
    if isinstance(group, int):
        return _default_group() if group == 0 else _groups[group]
    return group


def is_available():
    return dist.is_available()


def new_group(ranks=None, backend=None):
    """A group over ``ranks`` (default: every rank). Collective over the
    world when a process group exists: every rank calls it, in the same
    order."""
    if not env.is_initialized():
        g = Group(None)
    else:
        ranks = list(range(dist.get_world_size())) if ranks is None \
            else sorted(int(r) for r in ranks)
        g = Group(dist.new_group(ranks, backend=backend), ranks=ranks)
    _groups[g.id] = g
    return g


def get_group(gid=0):
    return _get_group(gid)


def _solo(g):
    return g.pg is None or g.nranks == 1


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place over the group; returns ``tensor``."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    dist.all_reduce(tensor, op=_TORCH_OPS[op], group=g.pg)
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's ``tensor`` into ``tensor_list`` (filled in place when
    it holds ``nranks`` tensors, else replaced); returns the list."""
    g = _get_group(group)
    if tensor_list is None:
        tensor_list = []
    if len(tensor_list) != g.nranks:
        tensor_list[:] = [torch.empty_like(tensor) for _ in range(g.nranks)]
    if _solo(g):
        tensor_list[0].copy_(tensor)
        return tensor_list
    dist.all_gather(tensor_list, tensor.contiguous(), group=g.pg)
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable ``obj`` into ``object_list``."""
    g = _get_group(group)
    if _solo(g):
        object_list[:] = [obj]
        return object_list
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.pg)
    object_list[:] = out
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s tensor into every rank's, in place."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    dist.broadcast(tensor, src=src, group=g.pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands in ``dst``'s tensor."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    dist.reduce(tensor, dst=dst, op=_TORCH_OPS[op], group=g.pg)
    if op == ReduceOp.AVG and dist.get_rank() == dst:
        tensor.div_(g.nranks)
    return tensor


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Reduce ``tensor_list`` (one tensor a rank) over the group; this
    rank's entry of the result lands in ``tensor``. Over ``gloo``: an
    all-reduce of the stacked list, then this rank's slice (the module
    docstring's rule)."""
    g = _get_group(group)
    if tensor_list is None:
        tensor_list = list(tensor.chunk(g.nranks))
    if _solo(g):
        tensor.copy_(tensor_list[0])
        return tensor
    if g.backend == "gloo":
        stacked = torch.stack([t.contiguous() for t in tensor_list])
        dist.all_reduce(stacked, op=_TORCH_OPS[op], group=g.pg)
        tensor.copy_(stacked[g.rank])
    else:
        dist.reduce_scatter(tensor, list(tensor_list), op=_TORCH_OPS[op],
                            group=g.pg)
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``src``'s ``tensor_list[r]`` into rank r's ``tensor``."""
    g = _get_group(group)
    if _solo(g):
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    dist.scatter(tensor, list(tensor_list) if dist.get_rank() == src
                 else None, src=src, group=g.pg)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """Rank r's ``in_tensor_list[q]`` lands in rank q's
    ``out_tensor_list[r]``; returns the output list."""
    g = _get_group(group)
    if out_tensor_list is None:
        out_tensor_list = []
    if len(out_tensor_list) != g.nranks:
        out_tensor_list[:] = [torch.empty_like(t) for t in in_tensor_list]
    if _solo(g):
        out_tensor_list[0].copy_(in_tensor_list[0])
        return out_tensor_list
    dist.all_to_all(out_tensor_list,
                    [t.contiguous() for t in in_tensor_list], group=g.pg)
    return out_tensor_list


def barrier(group=None):
    g = _get_group(group)
    if not _solo(g):
        dist.barrier(group=g.pg)


def send(tensor, dst=0, group=None, sync_op=True):
    g = _get_group(group)
    if not _solo(g):
        dist.send(tensor.contiguous(), dst=dst, group=g.pg)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    g = _get_group(group)
    if not _solo(g):
        dist.recv(tensor, src=src, group=g.pg)
    return tensor


def get_backend(group=None):
    """``"gloo"``, ``"nccl"``, or ``"none"`` for a group of one process."""
    return _get_group(group).backend


def wait(tensor, group=None, use_calc_stream=True):
    """The collectives here are synchronous on the host; on a CUDA tensor
    this waits for the device too."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


def destroy_process_group(group=None):
    """Leave ``group`` (default: the world, and every group)."""
    if not env.is_initialized():
        return
    if group is None:
        dist.destroy_process_group()
        _groups.clear()
        return
    g = _get_group(group)
    if g.pg is not None and g.pg is not dist.group.WORLD:
        dist.destroy_process_group(g.pg)
    _groups.pop(g.id, None)


# -- the model-parallel helpers (reference collective.py:693-724) -----------

def _mp_allreduce(tensor, group=None):
    """The row-parallel product's sum over the model-parallel ranks."""
    return all_reduce(tensor, group=group)


def _c_identity(tensor, group=None):
    """Forward identity (its backward would all-reduce the gradient)."""
    return tensor


def _c_concat(tensor, group=None):
    """Every rank's ``tensor`` concatenated along the last axis, in rank
    order."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    return torch.cat(all_gather(None, tensor, group=g), dim=-1)


def _c_split(tensor, group=None):
    """This rank's equal slice of the last axis."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    size = tensor.shape[-1] // g.nranks
    return tensor[..., g.rank * size:(g.rank + 1) * size].contiguous()
