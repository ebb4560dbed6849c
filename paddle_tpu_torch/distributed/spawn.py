"""Start ranks — port of ``paddle_tpu/distributed/spawn.py``.

The reference runs one process over all local chips, so its ``spawn``
is mostly a launcher shim. The port runs one process a rank:
:func:`spawn` starts ``nprocs`` processes with ``torch.multiprocessing``
(start method ``spawn``: a child imports the target's module afresh, so
keep that module free of ``jax``), joins them in one process group over
a ``file://`` rendezvous in a fresh temporary directory (no TCP port, so
concurrent test workers cannot collide), calls ``func(rank, *args)`` in
each, and returns the ranks' return values in rank order. A rank's
exception is re-raised in the parent, naming the rank; when several
failed, the first to fail leads the message.

The backend rule, stated once (:func:`choose_backend`):

- ``nccl`` when the device is CUDA and the machine has at least
  ``nprocs`` GPUs; rank r runs on ``cuda:r``;
- ``gloo`` otherwise: on the CPU, or with every rank on one card
  (``cuda:0``; NCCL refuses two ranks on one GPU).

A caller may force a backend; a forced ``nccl`` that cannot start
raises in its ranks, and so in the parent. It never becomes ``gloo``.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn", "choose_backend", "RankInfo", "ERROR_STORE_ENV"]

# the path of the FileStore a spawned rank set shares for failure notes
# (inference/tp.py reads it: a leader names a failed follower)
ERROR_STORE_ENV = "PADDLE_TPU_TORCH_RANK_STORE"


@dataclass(frozen=True)
class RankInfo:
    """What a spawned function learns of its place: ``rank``,
    ``nprocs``, ``device`` (a ``torch.device``, explicit) and the
    process group's ``backend``."""
    rank: int
    nprocs: int
    device: torch.device
    backend: str


def choose_backend(device, nprocs):
    """``(backend, [device of each rank])`` by the module docstring's
    rule."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.is_available() and torch.cuda.device_count() >= nprocs:
            return "nccl", [torch.device("cuda", r) for r in range(nprocs)]
        return "gloo", [torch.device("cuda", 0)] * nprocs
    return "gloo", [dev] * nprocs


def _rank_main(rank, nprocs, backend, devices, tmp, timeout_s, func, args):
    """One rank: join the group, run ``func``, leave a result or an error
    file behind."""
    err_path = os.path.join(tmp, f"error_{rank}.txt")
    try:
        os.environ.update(PADDLE_TRAINER_ID=str(rank),
                          PADDLE_TRAINERS_NUM=str(nprocs),
                          PADDLE_DIST_BACKEND=backend,
                          **{ERROR_STORE_ENV: os.path.join(tmp, "store")})
        dev = devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rdzv"),
            rank=rank, world_size=nprocs,
            timeout=timedelta(seconds=timeout_s),
            **({"device_id": dev} if backend == "nccl" else {}))
        try:
            out = func(RankInfo(rank, nprocs, dev, backend), *args)
            # every rank done before any leaves: a rank tearing its
            # connections down under a peer still using them aborts it
            dist.barrier()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(err_path + ".tmp", "w") as f:
            f.write(f"{time.time():.6f}\n{traceback.format_exc()}")
        os.replace(err_path + ".tmp", err_path)
        raise SystemExit(1)


def spawn(func, args=(), nprocs=2, backend=None, device=None,
          timeout=600.0, grace=30.0):
    """Run ``func(rank_info, *args)`` on ``nprocs`` ranks (module
    docstring). ``device``: ``"cuda"`` (the default) or ``"cpu"``;
    ``backend`` forces the process group's (else :func:`choose_backend`);
    ``timeout`` bounds every collective and wait on the group (seconds:
    past it the waiting rank raises); ``grace``: how long the other ranks
    may still run after one has failed, before they are stopped. Returns
    the ranks' return values; raises ``RuntimeError`` naming the failed
    ranks."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; spawn runs its ranks on the "
                "GPU by default — pass device='cpu' to run on the CPU")
        device = "cuda"
    nprocs = int(nprocs)
    if nprocs < 1:
        raise ValueError("nprocs must be >= 1")
    chosen, devices = choose_backend(device, nprocs)
    if backend is not None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
        if backend == "nccl":
            devices = [torch.device("cuda", r) for r in range(nprocs)]
        chosen = backend
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_spawn_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, chosen, devices, tmp, float(timeout),
                               func, tuple(args)))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        failed_at = None
        while any(p.is_alive() for p in procs):
            if failed_at is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                failed_at = time.monotonic()
            if failed_at is not None and \
                    time.monotonic() - failed_at > grace:
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    t, _, tb = f.read().partition("\n")
                errors.append((float(t), r, tb))
            elif p.exitcode != 0:
                errors.append((float("inf"), r,
                               f"exited with code {p.exitcode}\n"))
        if errors:
            errors.sort()
            raise RuntimeError("spawned rank(s) failed: " + "; ".join(
                f"rank {r}" for _, r, _ in errors) + "\n" + "\n".join(
                f"--- rank {r} ---\n{tb}" for _, r, tb in errors))
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
