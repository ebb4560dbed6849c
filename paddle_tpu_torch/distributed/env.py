"""The process environment — port of ``paddle_tpu/distributed/env.py``.

The reference's world is JAX's: one process drives all local chips, and
a multi-host run bootstraps ``jax.distributed`` from the launcher's
``PADDLE_*`` variables. The port's world is ``torch.distributed``: one
process a rank, joined in a process group. :func:`init_parallel_env`
joins the default group from the launcher's variables
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``, a
``host:port`` or a ``file://`` path; ``PADDLE_DIST_BACKEND``); with one
rank it joins nothing — world size 1 needs no process group, and every
collective of ``distributed/collective.py`` is then the identity.
``distributed/spawn.py`` starts ranks and joins them itself.
"""
from __future__ import annotations

import os

import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv"]


def is_initialized():
    """True once this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None):
    """This process's rank (in ``group``, a ``collective.Group``, when
    given); 0 outside a process group."""
    if group is not None:
        return group.rank
    if is_initialized():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None):
    """The ranks of ``group`` (default: the world); 1 outside a process
    group."""
    if group is not None:
        return group.nranks
    if is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def init_parallel_env(backend=None):
    """Join the default process group from the launcher's variables
    (reference ``init_parallel_env``). One rank, or a group already
    joined: nothing to do. ``backend`` (or ``PADDLE_DIST_BACKEND``)
    defaults to ``gloo``; the caller picks ``nccl`` where each rank has
    its own GPU (``spawn.choose_backend`` states the rule)."""
    nproc = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if is_initialized() or nproc <= 1:
        return
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    master = os.environ.get("PADDLE_MASTER") or \
        os.environ.get("MASTER_ENDPOINT")
    if not master:
        raise RuntimeError(
            "init_parallel_env: PADDLE_TRAINERS_NUM > 1 but no "
            "PADDLE_MASTER (host:port or file://path) to meet at")
    method = master if "://" in master else f"tcp://{master}"
    dist.init_process_group(
        backend or os.environ.get("PADDLE_DIST_BACKEND", "gloo"),
        init_method=method, rank=rank, world_size=nproc)


class ParallelEnv:
    """reference ``ParallelEnv``: this process's place in the world."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_rank()

    @property
    def device_id(self):
        return int(os.environ.get("PADDLE_LOCAL_DEVICE_ID", "0"))

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else ["127.0.0.1:0"]
