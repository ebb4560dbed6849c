"""Tensor-parallel serving — port of ``paddle_tpu/inference/tp.py``.

The reference runs one controller over an SPMD program: every serving
executable is one program over an ``mp`` mesh axis, GSPMD inserts the
collectives, and every chip emits the same stream. The port runs one
process a rank over ``torch.distributed`` (``distributed/spawn.py``),
and the programs call the collectives themselves:

- **layout** (Megatron, head-aligned): each rank holds the q, k and v
  columns of its ``NH / mp`` heads (the fused ``[H, 3H]`` weight is
  q|k|v-contiguous, so a flat column split would be wrong:
  :meth:`TPContext.prepare_params` takes the three ranges), the rows of
  the attention out-projection, the columns of ``fc_in`` and the rows of
  ``fc_out``; embeddings, layer norms and the tied head are replicated,
  so every rank computes the full logits;
- **collectives**: the two row-parallel products of a layer end in an
  ``all_reduce`` of the ``[positions, H]`` partial sum (the bias added
  once, after it); nothing else under ``kv_shard="heads"``, where each
  rank's pools hold its own heads. Under ``kv_shard="replicated"`` the
  pools are full on every rank: each rank computes K/V for its heads and
  one ``all_gather`` a layer completes them before the pool write; the
  attention then reads this rank's heads of the full pool at a head
  offset (``kernels/paged_attention.py``, ``h0``), never a copy;
- **int8 collective** (``collective_dtype="int8"``, reference
  ``tp.py:268-337``): each rank quantizes its ``[positions, H]`` partial
  symmetric-int8 with one float32 scale a position
  (``quantization/kv.py`` ``symmetric_int8``), one ``all_gather`` of the
  codes and one of the scales replace the all-reduce, and the
  dequantized partials are summed in float32 in rank order, then cast
  to the activation dtype.

Every collective goes through :meth:`TPContext._all_reduce` or
:meth:`TPContext._all_gather`, which count the payload of each op (the
bytes of its result, the reference's HLO-census convention) into an
armed census (:meth:`TPContext.census`): the engine arms it around each
eager program's first run, or a CUDA graph's capture alone, and keeps
the counts in ``engine.xla_costs``, where the reference keeps its HLO
census. The analytic prediction is
:meth:`TPContext.collective_payload_per_position`, the reference's
closed form.

Token identity with the single-card engine rests on every rank ending
each all-reduce with the same bits (a ring reduction gives every rank
the same sum; nothing here branches on the rank except which columns it
holds) and on every rank sampling from the same logits with the same
noise, which the engine's dispatch channel (:class:`DispatchChannel`)
carries from the leader.

The process model (one leader, ``mp - 1`` followers): rank 0 is the
engine, with the scheduler, the journal, telemetry and the ledger; the
other ranks hold their shards and run programs only. Before each program
call the leader broadcasts the program's key and its host inputs, and
the generator states any noise fill needs; every rank then runs the same
program over its shard. ``close()`` and a leader's fatal error send a
stop. A follower that fails writes its traceback to the rank set's
store before it exits; the leader's next collective then fails, and the
leader raises the follower's error, naming the rank. Every wait is
bounded by the process group's timeout (``spawn(timeout=)``), past which
it raises.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..distributed import collective as C
from ..distributed.spawn import ERROR_STORE_ENV
from ..quantization.kv import symmetric_int8
from ..quantization.weights import params_nbytes

__all__ = ["TPContext", "make_mesh", "Mesh", "KV_SHARD_MODES",
           "COLLECTIVE_DTYPES", "DispatchChannel"]

KV_SHARD_MODES = ("heads", "replicated")
COLLECTIVE_DTYPES = ("f32", "int8")


@dataclass
class Mesh:
    """The port's mesh handle: ``mp`` ranks of ``group`` (a
    ``distributed.collective.Group``; None for mp = 1 without a process
    group), this process's ``rank`` in it and its ``device`` (None: the
    engine's own ``device=`` decides)."""
    mp: int
    rank: int
    group: object = None
    device: object = None

    @property
    def backend(self):
        return "none" if self.group is None else self.group.backend


def make_mesh(mp, group=None, device=None):
    """A 1-axis mesh of the first ``mp`` ranks of ``group`` (default: the
    world). ``mp = 1`` needs no process group. Raises ``ValueError`` for
    ``mp < 1`` and for more ranks than the group has, as the
    reference's."""
    mp = int(mp)
    if mp < 1:
        raise ValueError("mp must be >= 1")
    g = C.get_group(0) if group is None else group
    if g.nranks < mp:
        raise ValueError(
            f"mesh needs {mp} ranks but the group has only {g.nranks} "
            "(start them with paddle_tpu_torch.distributed.spawn)")
    dev = None if device is None else torch.device(device)
    if mp == 1 and g.nranks == 1:
        return Mesh(1, 0, None, dev)
    if mp < g.nranks:       # collective: every rank of g calls make_mesh
        sub = C.new_group(g.ranks[:mp])
        rank = g.ranks.index(dist.get_rank()) if \
            dist.get_rank() in sub.ranks else -1
        return Mesh(mp, rank, sub if rank >= 0 else None, dev)
    return Mesh(mp, g.rank, g, dev)


class DispatchChannel:
    """The leader's messages to its followers: picklable objects
    broadcast over a ``gloo`` group of the mesh's ranks (the data
    collectives may ride NCCL; these ride the host). Also the rank set's
    failure notes, in the ``FileStore`` that ``distributed.spawn``
    names (none outside a spawned rank set)."""

    _ctrl = {}   # data group id -> its gloo control group

    def __init__(self, mesh):
        g = mesh.group
        ctrl = self._ctrl.get(g.id)
        if ctrl is None:
            ctrl = g if g.backend == "gloo" else \
                C.new_group(g.ranks, backend="gloo")
            self._ctrl[g.id] = ctrl
        self.ctrl = ctrl
        self.src = g.ranks[0]
        self.rank = mesh.rank
        self.mp = mesh.mp
        path = os.environ.get(ERROR_STORE_ENV)
        self.store = dist.FileStore(path, -1) if path else None

    def send(self, msg):
        dist.broadcast_object_list([msg], src=self.src, group=self.ctrl.pg)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.ctrl.pg)
        return box[0]

    def note_failure(self, text):
        """A follower's traceback, for the leader to raise."""
        if self.store is not None:
            self.store.set(f"tp_failure/{self.rank}", text)

    def failures(self):
        """``[(rank, traceback)]`` of the followers that noted one."""
        if self.store is None:
            return []
        out = []
        for r in range(1, self.mp):
            key = f"tp_failure/{r}"
            if self.store.check([key]):
                out.append((r, self.store.get(key).decode()))
        return out


def _cols(leaf, idx):
    """Columns ``idx`` of a weight (the last axis), or of an int8
    ``(codes, keepdims scale [1, N])`` pair, codes and scales alike."""
    if isinstance(leaf, tuple):
        return (leaf[0].index_select(-1, idx), leaf[1].index_select(-1, idx))
    return leaf.index_select(-1, idx)


def _rows(leaf, lo, hi):
    """Rows ``lo:hi`` of a weight, or of an int8 pair's codes (its
    per-output-channel scale spans the columns and stays whole)."""
    if isinstance(leaf, tuple):
        return (leaf[0][lo:hi].clone(), leaf[1])
    return leaf[lo:hi].clone()


class TPContext:
    """The engine's view of its mesh (reference ``TPContext``): the
    shard layout, the per-rank pool geometry, the layer hooks
    (:meth:`qkv_proj`, :meth:`attn_out`, :meth:`mlp_tail`) that
    ``models.gpt.make_layer_core(cfg, tp=)`` routes through, the int8
    collective (:meth:`qar`) and the collective census."""

    def __init__(self, mesh, cfg, kv_shard="heads", collective_dtype="f32"):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a make_mesh handle, got "
                            f"{type(mesh).__name__}")
        if kv_shard not in KV_SHARD_MODES:
            raise ValueError(f"unknown kv_shard {kv_shard!r} "
                             f"(one of {KV_SHARD_MODES})")
        if collective_dtype not in COLLECTIVE_DTYPES:
            raise ValueError(
                f"unknown collective_dtype {collective_dtype!r} "
                f"(one of {COLLECTIVE_DTYPES})")
        self.mesh = mesh
        self.mp = int(mesh.mp)
        self.rank = int(mesh.rank)
        self.group = mesh.group
        self.kv_shard = kv_shard
        self.collective_dtype = collective_dtype
        if getattr(cfg, "num_experts", 0):
            raise ValueError(
                "mesh serving does not support MoE blocks yet (the "
                "expert dim needs its own sharding story)")
        if cfg.num_heads % self.mp:
            raise ValueError(f"mp({self.mp}) must divide num_heads"
                             f"({cfg.num_heads})")
        if cfg.intermediate_size % self.mp:
            raise ValueError(f"mp({self.mp}) must divide intermediate_size"
                             f"({cfg.intermediate_size})")
        if self.mp > 1 and not 0 <= self.rank < self.mp:
            raise ValueError(f"this process (rank {self.rank}) is not in "
                             "the mesh")
        self.nh_local = cfg.num_heads // self.mp
        # the pools: this rank's heads, or all of them (then the
        # attention reads this rank's heads at an offset)
        self.pool_heads = cfg.num_heads if kv_shard == "replicated" \
            else self.nh_local
        self.h0 = self.rank * self.nh_local if kv_shard == "replicated" \
            else 0

    # -- the analytic payload and the counted census ------------------------
    def collective_payload_per_position(self, num_layers, hidden,
                                        act_bytes):
        """The collective payload one position pays per weight pass
        (reference ``tp.py:152-178``): ``f32``, the all-reduce pair
        ``2 * L * H * act_bytes``, doubled by the K/V all-gather under
        replicated pools; ``int8``, two all-gathers of int8 partials and
        their float32 scales, ``2 * L * mp * (H + 4)``, plus the K/V
        all-gather at the activation dtype under replicated pools."""
        L, H, ab = int(num_layers), int(hidden), int(act_bytes)
        if self.mp <= 1:
            return 0.0
        if self.collective_dtype == "int8":
            coll = L * 2.0 * self.mp * (H + 4)
            if self.kv_shard != "heads":
                coll += L * 2.0 * H * ab
            return coll
        ars = 2 if self.kv_shard == "heads" else 4
        return float(ars * L * H * ab)

    # the armed census: one program runs at a time in a process, and a
    # speculative engine's draft has a context of its own
    _armed = None

    class _Census:
        def __init__(self):
            self.by_op = {}

        def __enter__(self):
            TPContext._armed = self.by_op
            return self

        def __exit__(self, *exc):
            TPContext._armed = None

        @property
        def total(self):
            return sum(self.by_op.values())

    def census(self):
        """A context that counts every collective's payload by op
        (``"all-reduce"``, ``"all-gather"``) into ``.by_op``."""
        return TPContext._Census()

    @staticmethod
    def _count(op, nbytes):
        armed = TPContext._armed
        if armed is not None:
            armed[op] = armed.get(op, 0) + int(nbytes)

    def _all_reduce(self, t):
        t = t.contiguous()
        self._count("all-reduce", t.numel() * t.element_size())
        return C.all_reduce(t, group=self.group)

    def _all_gather(self, t):
        outs = C.all_gather(None, t.contiguous(), group=self.group)
        self._count("all-gather",
                    sum(o.numel() * o.element_size() for o in outs))
        return outs

    # -- the layer hooks -----------------------------------------------------
    def qkv_proj(self, core, lay, h):
        """This rank's heads of q, k and v (its q|k|v columns); under
        replicated pools k and v of every head, by one all-gather of
        ``[..., 2, NH / mp, HD]``."""
        qkv = h @ lay["qkv"][0] + lay["qkv"][1]
        q, k, v = qkv.split(core.NH * core.HD, dim=-1)
        shp = h.shape[:-1] + (core.NH, core.HD)
        q, k, v = q.reshape(shp), k.reshape(shp), v.reshape(shp)
        if self.kv_shard == "heads":
            return q, k, v
        kv = torch.cat(self._all_gather(torch.stack([k, v], -3)), dim=-2)
        return q, kv[..., 0, :, :], kv[..., 1, :, :]

    def qar(self, a, w):
        """The quantized row-parallel product (reference ``qar``): this
        rank's partial ``a @ w`` as symmetric int8 with one float32 scale
        a position, all-gathered, dequantized and summed in float32 in
        rank order, cast to ``a``'s dtype."""
        q, s = symmetric_int8(a @ w, -1)
        qs, ss = self._all_gather(q), self._all_gather(s)
        out = qs[0].float() * ss[0][..., None]
        for qi, si in zip(qs[1:], ss[1:]):
            out = out + qi.float() * si[..., None]
        return out.to(a.dtype)

    def attn_out(self, core, lay, x, o):
        """Residual add + the row-parallel out-projection (its bias added
        once, after the sum)."""
        if self.collective_dtype == "int8":
            return self.attn_out_q(core, lay, x, o)
        return x + self._all_reduce(o @ lay["proj"][0]) + lay["proj"][1]

    def attn_out_q(self, core, lay, x, o):
        """:meth:`attn_out` with the int8 collective."""
        return x + self.qar(o, lay["proj"][0]) + lay["proj"][1]

    def mlp_tail(self, core, lay, x):
        """ln2 + the column-parallel fc_in and gelu + the row-parallel
        fc_out + residual."""
        if self.collective_dtype == "int8":
            return self.mlp_tail_q(core, lay, x)
        g = self._mlp_in(core, lay, x)
        return x + (self._all_reduce(g @ lay["mlp"][2]) + lay["mlp"][3])

    def mlp_tail_q(self, core, lay, x):
        """:meth:`mlp_tail` with the int8 collective."""
        g = self._mlp_in(core, lay, x)
        return x + (self.qar(g, lay["mlp"][2]) + lay["mlp"][3])

    @staticmethod
    def _mlp_in(core, lay, x):
        import torch.nn.functional as F
        p = lay["mlp"]
        return F.gelu(core.ln(x, *lay["ln2"]) @ p[0] + p[1],
                      approximate="tanh")

    # -- the parameter shard --------------------------------------------------
    def prepare_params(self, params):
        """This rank's Megatron shard of a full parameter dict (plain,
        bf16-cast or the int8 artifact, whose scales are cut with their
        columns): the q, k and v columns of its heads, the rows of
        ``proj``, the columns of ``fc_in`` and the rows of ``fc_out``;
        embeddings, norms and biases of replicated outputs shared."""
        if self.mp <= 1:
            return params
        r, mp = self.rank, self.mp
        layers = []
        for lay in params["layers"]:
            w, b = lay["qkv"]
            H = b.shape[-1] // 3
            hl = H // mp
            dev = b.device
            base = torch.arange(r * hl, (r + 1) * hl, device=dev)
            idx = torch.cat([base, base + H, base + 2 * H])
            w1, b1, w2, b2 = lay["mlp"]
            il = b1.shape[-1] // mp
            fidx = torch.arange(r * il, (r + 1) * il, device=dev)
            layers.append(dict(
                ln1=lay["ln1"], ln2=lay["ln2"],
                qkv=(_cols(w, idx), b.index_select(-1, idx)),
                proj=(_rows(lay["proj"][0], r * hl, (r + 1) * hl),
                      lay["proj"][1]),
                mlp=(_cols(w1, fidx), b1.index_select(-1, fidx),
                     _rows(w2, r * il, (r + 1) * il), b2)))
        return dict(wte=params["wte"], wpe=params["wpe"], lnf=params["lnf"],
                    layers=layers)

    def param_bytes_per_chip(self, params):
        """Bytes of this rank's shard of the full dict ``params``."""
        return params_nbytes(self.prepare_params(params))

