"""GPT-2 — port of ``paddle_tpu/models/gpt.py``.

For the paged serving engine:

- :class:`GPTConfig`, :func:`gpt2_small`, :func:`gpt2_medium`,
  :func:`gpt2_tiny` — the configurations (dense models only: MoE layers
  are not ported yet).
- :func:`init_params` — random weights from a numpy seed, in the layout
  of the reference's ``_gen_params`` (``gpt.py:283``).
- :func:`params_from_numpy` — carries the reference's weights across:
  ``_gen_params(model)`` with every leaf passed through ``np.asarray``
  becomes the port's parameter dict, the same tree with torch leaves.
- :func:`make_layer_core` — the per-layer math of ``_make_layer_core``
  (``gpt.py:328``): ``ln``, ``qkv_proj``, ``attn_out``, the dense
  ``mlp_tail``, and the dense-cache ``step_layer`` and ``prefill_layer``
  (``gpt.py:385-419``) of :meth:`GPTForCausalLM.generate`.

For training (``gpt.py:74-251``): :class:`GPTAttention`,
:class:`GPTMLP`, :class:`GPTBlock`, :class:`GPTModel` and
:class:`GPTForCausalLM` (``forward`` and ``loss``), with parameter names
equal to the reference's; :meth:`GPTForCausalLM.load_reference_state`
takes the reference's ``named_parameters()`` as numpy arrays, and
:func:`gen_params` hands a (trained) model to the serving engine.

Dense KV-cache generation (``gpt.py:421-588``, ``_gen_decode_fn`` and
``_generate``): :meth:`GPTForCausalLM.generate` prefills the prompt in
one batched pass and then decodes token by token over per-layer caches
``[b, total, NH, HD]``. On CUDA the decode step is one captured
``GraphProgram`` (``inference/graphs.py``) per (batch, bucketed total
length, dtype, top-k), the port's counterpart of the reference's one
``jax.jit`` per total length; on the CPU it runs eagerly.

Layout kept from the reference: weights are ``[in, out]`` and applied
as ``h @ W``; the fused qkv projection splits ``[q|k|v]`` on the last
axis; the LM head is tied (``@ wte.T``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..device import resolve_device
from ..distributed.utils_recompute import recompute
from ..nn import functional as PF

__all__ = ["GPTConfig", "gpt2_small", "gpt2_medium", "gpt2_tiny",
           "init_params",
           "params_from_numpy", "make_layer_core", "tree_map",
           "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gen_params"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    intermediate_size: int = None  # default 4*hidden
    dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    num_experts: int = 0           # MoE: not ported; must stay 0
    # recompute the MLP half of each block in the backward (gpt.py:42)
    recompute: bool = False
    # sequence-chunked LM loss, tokens per chunk; 0 = off (gpt.py:45)
    ce_chunk: int = 0
    # one-kernel head + CE (gpt.py:50): the [tokens, vocab] logits never
    # reach device memory (kernels/fused_ce.py)
    fused_ce: bool = False
    # residual stream and sub-layer outputs in bf16, AMP or not
    # (gpt.py:55); on by default, as in the reference
    bf16_residual: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.num_experts:
            raise NotImplementedError(
                "MoE layers are not ported to paddle_tpu_torch yet")
        if self.fused_ce and self.ce_chunk:
            raise ValueError(
                "fused_ce and ce_chunk are mutually exclusive — the "
                "fused kernel already avoids materializing the logits")


def gpt2_small(**kw):
    return GPTConfig(num_layers=12, hidden_size=768, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTConfig(num_layers=24, hidden_size=1024, num_heads=16, **kw)


def gpt2_tiny(**kw):
    """Test-scale config (the reference's ``gpt2_tiny``)."""
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_position_embeddings", 128)
    return GPTConfig(**kw)


def _numpy_params(cfg, seed):
    """Random weights in the ``_gen_params`` layout: N(0, 0.02)
    matrices and embeddings, zero biases, unit LayerNorm gains."""
    rng = np.random.default_rng(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(0.02))

    def ln():
        return (np.ones(H, np.float32), np.zeros(H, np.float32))

    layers = [dict(ln1=ln(), ln2=ln(),
                   qkv=(w(H, 3 * H), np.zeros(3 * H, np.float32)),
                   proj=(w(H, H), np.zeros(H, np.float32)),
                   mlp=(w(H, I), np.zeros(I, np.float32),
                        w(I, H), np.zeros(H, np.float32)))
              for _ in range(cfg.num_layers)]
    return dict(wte=w(cfg.vocab_size, H),
                wpe=w(cfg.max_position_embeddings, H),
                lnf=ln(), layers=layers)


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a parameter tree (dicts, lists
    and tuples kept as they are)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device=None, dtype=torch.float32):
    """The reference's ``_gen_params`` tree, leaves as numpy arrays (or
    anything ``np.asarray`` takes), as the port's parameter dict: the
    same nesting — dicts, lists, tuples — with torch leaves of ``dtype``
    on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.asarray(x, np.float32)).to(
        device=dev, dtype=dtype), tree)


def init_params(cfg, seed=0, device=None, dtype=torch.float32):
    """Random weights for ``cfg`` from numpy seed ``seed`` (no JAX
    needed), as the port's parameter dict."""
    return params_from_numpy(_numpy_params(cfg, seed), device, dtype)


def make_layer_core(cfg, eps=None, tp=None):
    """Per-layer transformer math shared by the serving programs — the
    port of ``_make_layer_core`` (dense layers only). ``eps`` defaults
    to ``cfg.layer_norm_epsilon`` (the reference reads it from
    ``model.gpt.ln_f._epsilon``).

    ``tp`` (an ``inference.tp.TPContext``) makes it one rank's core of a
    tensor-parallel engine: ``NH`` is this rank's heads, and
    ``qkv_proj``, ``attn_out`` and ``mlp_tail`` are the context's hooks,
    which run the same math over the rank's weight shard and end the
    row-parallel products in a collective. ``H`` stays the model's
    width (the residual stream is whole on every rank). Without ``tp``
    the math is the single-card engine's."""
    H, NH = cfg.hidden_size, cfg.num_heads
    HD = H // NH
    if tp is not None:
        NH //= tp.mp
    scale = float(1.0 / np.sqrt(HD))
    eps = float(cfg.layer_norm_epsilon if eps is None else eps)

    def ln(x, g, b):
        # biased variance, eps inside the rsqrt (gpt.py:347-350)
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + eps) * g + b

    def qkv_proj(lay, h):
        """h [..., H] -> q, k, v each [..., NH, HD]."""
        qkv = h @ lay["qkv"][0] + lay["qkv"][1]
        q, k, v = qkv.split(H, dim=-1)
        shp = h.shape[:-1] + (NH, HD)
        return q.reshape(shp), k.reshape(shp), v.reshape(shp)

    def attn_out(lay, x, o):
        """Residual add + attention output projection; o [..., H]."""
        return x + o @ lay["proj"][0] + lay["proj"][1]

    def mlp_tail(lay, x):
        """ln2 + the dense gelu MLP (tanh approximation) + residual."""
        h2 = ln(x, *lay["ln2"])
        p = lay["mlp"]
        m = F.gelu(h2 @ p[0] + p[1], approximate="tanh") @ p[2] + p[3]
        return x + m

    def step_layer(lay, x, k_cache, v_cache, t):
        """One token a row through one block over the dense caches: x
        ``[b, H]``, caches ``[b, T, NH, HD]``, ``t`` the position (an int
        or a 0-d int64 tensor on x's device). Writes k and v at ``t`` in
        place (the reference's ``dynamic_update_slice``) and attends over
        the whole cache, masked to ``arange(T) <= t``. Returns ``(x,
        k_cache, v_cache)``."""
        h = ln(x, *lay["ln1"])
        q, k, v = qkv_proj(lay, h)                        # [b, NH, HD]
        at = torch.as_tensor(t, device=x.device).reshape(1)
        k_cache.index_copy_(1, at, k[:, None].to(k_cache.dtype))
        v_cache.index_copy_(1, at, v[:, None].to(v_cache.dtype))
        scores = torch.einsum("bhd,bthd->bht", q, k_cache) * scale
        mask = torch.arange(k_cache.shape[1], device=x.device) <= at
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bht,bthd->bhd", probs, v_cache).reshape(-1, H)
        x = attn_out(lay, x, o)
        return mlp_tail(lay, x), k_cache, v_cache

    def prefill_layer(lay, x):
        """The whole prompt through one block, causal; x ``[b, P, H]``.
        Returns ``(x, k [b, P, NH, HD], v)``."""
        b, P = x.shape[0], x.shape[1]
        h = ln(x, *lay["ln1"])
        q, k, v = qkv_proj(lay, h)                     # [b, P, NH, HD]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        causal = torch.ones(P, P, dtype=torch.bool, device=x.device).tril()
        scores = torch.where(causal, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, P, H)
        x = attn_out(lay, x, o)
        return mlp_tail(lay, x), k, v

    core = SimpleNamespace(H=H, NH=NH, HD=HD, scale=scale, ln=ln,
                           qkv_proj=qkv_proj, attn_out=attn_out,
                           mlp_tail=mlp_tail, step_layer=step_layer,
                           prefill_layer=prefill_layer)
    if tp is not None:
        core.qkv_proj = lambda lay, h: tp.qkv_proj(core, lay, h)
        core.attn_out = lambda lay, x, o: tp.attn_out(core, lay, x, o)
        core.mlp_tail = lambda lay, x: tp.mlp_tail(core, lay, x)
    return core


# -- training (gpt.py:74-251) -------------------------------------------------

class GPTAttention(torch.nn.Module):
    def __init__(self, cfg, *, rng=None, generator=None, device=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, rng=rng,
                             device=device)
        self.proj = nn.RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                         rng=rng, device=device)
        self.dropout = nn.Dropout(cfg.dropout, generator)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        out = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.dropout(self.proj(out.reshape(b, s, h)))


class GPTMLP(torch.nn.Module):
    def __init__(self, cfg, *, rng=None, generator=None, device=None):
        super().__init__()
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                               rng=rng, device=device)
        self.fc_out = nn.RowParallelLinear(cfg.intermediate_size,
                                           cfg.hidden_size, rng=rng,
                                           device=device)
        self.dropout = nn.Dropout(cfg.dropout, generator)

    def forward(self, x):
        return self.dropout(self.fc_out(PF.gelu(self.fc_in(x),
                                                approximate=True)))


class GPTBlock(torch.nn.Module):
    """Pre-LN block. Kept from the reference (``gpt.py:131-156``): with
    ``bf16_residual`` the stream and each sub-layer output are cast to
    bf16 even without AMP; recompute wraps the MLP half only."""

    def __init__(self, cfg, *, rng=None, generator=None, device=None):
        super().__init__()
        self._recompute = cfg.recompute
        self._bf16_res = cfg.bf16_residual
        self._rng = generator
        kw = dict(rng=rng, generator=generator, device=device)
        self.ln1 = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                                device=device)
        self.attn = GPTAttention(cfg, **kw)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                                device=device)
        self.mlp = GPTMLP(cfg, **kw)

    def _mlp_half(self, h):
        return self.mlp(self.ln2(h))

    def _mlp_out(self, x):
        if self._recompute:
            return recompute(self._mlp_half, x, rng=self._rng)
        return self._mlp_half(x)

    def forward(self, x):
        if self._bf16_res:
            # astype (a cast: no autocast) then elementwise_add, which
            # O2 casts to its low dtype (float16 rounds the bf16 stream)
            bf = torch.bfloat16
            x = PF.add(x.to(bf), self.attn(self.ln1(x)).to(bf))
            return PF.add(x, self._mlp_out(x).to(bf))
        x = PF.add(x, self.attn(self.ln1(x)))
        return PF.add(x, self._mlp_out(x))


class GPTModel(torch.nn.Module):
    def __init__(self, cfg, *, rng=None, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, rng=rng,
                                device=device)
        self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                cfg.hidden_size, rng=rng, device=device)
        self.drop = nn.Dropout(cfg.dropout, generator)
        self.blocks = torch.nn.ModuleList([
            GPTBlock(cfg, rng=rng, generator=generator, device=device)
            for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                                 device=device)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.drop(PF.add(self.wte(input_ids), self.wpe(pos)))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(torch.nn.Module):
    """The causal LM with its tied head. Weights are made on the host
    from numpy seed ``seed`` (XavierUniform matrices and embeddings, as
    the reference initialises them); dropout masks come from one
    ``torch.Generator`` on ``device`` seeded with ``seed``. Runs on CUDA
    unless ``device="cpu"``."""

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.gpt = GPTModel(cfg, rng=rng, generator=gen, device=dev)
        # generate()'s decode programs, keyed (batch, total, dtype,
        # top_k), and the graph pool they share on CUDA
        self._gen_programs = {}
        self._gen_pool = None

    def forward(self, input_ids):
        hidden = self.gpt(input_ids)
        # tied lm head: logits = hidden @ wte^T (white-listed matmul_v2)
        return PF.matmul(hidden, self.gpt.wte.weight, transpose_y=True)

    def _chunked_ce_loss(self, input_ids, labels, chunk):
        """CE summed over ``chunk``-token slices, each recomputed in the
        backward, divided by ``B * S`` (``gpt.py:197-221``)."""
        hidden = self.gpt(input_ids)
        b, s = input_ids.shape
        wte = self.gpt.wte.weight

        def chunk_ce(h_c, y_c):
            logits = PF.matmul(h_c, wte, transpose_y=True)
            return PF.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                    y_c.reshape(-1), reduction="sum")

        total = None
        for c0 in range(0, s, chunk):
            part = recompute(chunk_ce, hidden[:, c0:c0 + chunk],
                             labels[:, c0:c0 + chunk])
            total = part if total is None else total + part
        return total * (1.0 / (b * s))

    def loss(self, input_ids, labels):
        cfg = self.gpt.cfg
        chunk = int(cfg.ce_chunk or 0)
        if chunk > 0:
            return self._chunked_ce_loss(input_ids, labels, chunk)
        if cfg.fused_ce:
            # one-kernel head + CE (gpt.py:226-233): no [B*S, V] logits
            hidden = self.gpt(input_ids)
            d = hidden.shape[-1]
            return PF.fused_linear_cross_entropy(
                hidden.reshape(-1, d), self.gpt.wte.weight,
                labels.reshape(-1))
        logits = self(input_ids)
        return PF.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                labels.reshape(-1))

    def load_reference_state(self, named):
        """Copy ``{name: array}`` (the reference's ``named_parameters()``
        through ``np.asarray``) into the parameters of the same names;
        raises on a missing, extra or misshapen name."""
        nn.load_named_state(self, named)


def gen_params(model):
    """The live parameters of ``model`` as the tree the port's
    ``ServingEngine`` takes (the reference's ``_gen_params``,
    ``gpt.py:283``), detached: a trained model can be served."""
    g = model.gpt

    def a(p):
        return p.detach()

    layers = [dict(ln1=(a(b.ln1.weight), a(b.ln1.bias)),
                   ln2=(a(b.ln2.weight), a(b.ln2.bias)),
                   qkv=(a(b.attn.qkv.weight), a(b.attn.qkv.bias)),
                   proj=(a(b.attn.proj.weight), a(b.attn.proj.bias)),
                   mlp=(a(b.mlp.fc_in.weight), a(b.mlp.fc_in.bias),
                        a(b.mlp.fc_out.weight), a(b.mlp.fc_out.bias)))
              for b in g.blocks]
    return dict(wte=a(g.wte.weight), wpe=a(g.wpe.weight),
                lnf=(a(g.ln_f.weight), a(g.ln_f.bias)), layers=layers)


# -- dense KV-cache generation (gpt.py:421-588) -------------------------------

_GEN_BUCKET = 32   # the scan length is bucketed to a multiple of this


def _flat_params(params):
    """The parameter tree's leaves in a fixed order, and a function that
    rebuilds the tree from such a list."""
    leaves = []
    tree_map(leaves.append, params)

    def rebuild(flat):
        it = iter(flat)
        return tree_map(lambda _: next(it), params)
    return leaves, rebuild


class _DenseDecoder:
    """The decode step of one (batch, total length, dtype, top-k) as one
    program (the reference's ``_gen_decode_fn``, ``gpt.py:421``).

    Its fixed tensors keep their addresses for its lifetime: the weights
    at the decode dtype (each :meth:`run` copies the model's live
    weights in, so updates between calls are seen), the per-layer caches
    ``[b, total, NH, HD]``, which the eager prefill writes in place, the
    current tokens, the output ``[b, total]`` int64 and the temperature.
    The host input is the position ``t``; the step embeds the token at
    ``t``, writes k and v there, samples position ``t + 1``'s token into
    the tokens and the output. The Gumbel noise is a device buffer filled
    outside the program from the call's ``torch.Generator``. On CUDA the
    program is a captured ``GraphProgram`` (``capture_seconds`` its
    warm-up and capture); a capture that fails raises. On the CPU, and
    with ``capture=False`` (comparisons only), it is an
    ``EagerProgram``."""

    def __init__(self, cfg, params, b, total, dtype, top_k, device, pool,
                 capture=True):
        from ..inference.graphs import EagerProgram, GraphProgram
        self.core = make_layer_core(cfg)
        self.top_k = int(top_k)
        self.device = device
        NH, HD = self.core.NH, self.core.HD
        leaves, self._rebuild = _flat_params(params)
        self.weights = [torch.empty(p.shape, dtype=dtype, device=device)
                        for p in leaves]
        self.caches = [torch.zeros(b, total, NH, HD, dtype=dtype,
                                   device=device)
                       for _ in range(2 * cfg.num_layers)]
        self.tok = torch.zeros(b, dtype=torch.int64, device=device)
        self.out = torch.zeros(b, total, dtype=torch.int64, device=device)
        self.temp = torch.zeros((), dtype=torch.float32, device=device)
        self.noise = torch.zeros(b, cfg.vocab_size, dtype=torch.float32,
                                 device=device)
        self.load(params)
        fixed = (*self.weights, *self.caches, self.tok, self.out,
                 self.temp)
        self.capture_seconds = 0.0
        if device.type == "cuda" and capture:
            t0 = time.perf_counter()
            self.program = GraphProgram(pool, self._step, fixed,
                                        (np.zeros((), np.int64),),
                                        (self.noise,))
            torch.cuda.synchronize(device)
            self.capture_seconds = time.perf_counter() - t0
        else:
            self.program = EagerProgram(lambda: self._step, fixed, device,
                                        (self.noise,))

    @torch.no_grad()
    def load(self, params):
        leaves, _ = _flat_params(params)
        torch._foreach_copy_(self.weights, leaves)

    def _unpack(self, flat):
        nw, nc = len(self.weights), len(self.caches)
        params = self._rebuild(flat[:nw])
        caches = flat[nw:nw + nc]
        return params, list(zip(caches[0::2], caches[1::2])), flat[nw + nc:]

    def select(self, logits, temp, noise):
        """``temp > 0``: the Gumbel-max draw over the top-k-filtered,
        temperature-scaled logits; else argmax. Float32, as the
        reference samples (``gpt.py:467``)."""
        from ..inference import sampler
        lg = logits.float()
        drawn = torch.argmax(sampler.apply_top_k(
            sampler.scale_by_temp(lg, temp), self.top_k) + noise, dim=-1)
        return torch.where(temp > 0, drawn, sampler.greedy(lg))

    def _step(self, *args):
        params, caches, (tok, out, temp, pos, noise) = self._unpack(args)
        core = self.core
        wte = params["wte"]
        x = wte[tok] + params["wpe"].index_select(0, pos.reshape(1))
        for lay, (kc, vc) in zip(params["layers"], caches):
            x, _, _ = core.step_layer(lay, x, kc, vc, pos)
        logits = core.ln(x, *params["lnf"]) @ wte.T              # [b, V]
        nxt = self.select(logits, temp, noise)
        tok.copy_(nxt)
        out.index_copy_(1, (pos + 1).reshape(1), nxt[:, None])
        return nxt

    def _fill_noise(self, gen):
        from ..inference import sampler
        self.noise.copy_(sampler.gumbel_noise(self.noise.shape, gen,
                                              self.device))

    @torch.no_grad()
    def run(self, ids, n_total, temperature, seed):
        """Prefill ``ids`` ``[b, L0]`` (int64, on the device) eagerly
        into the caches, sample position L0, then decode up to position
        ``n_total - 1``. Returns ``[b, n_total]`` int64."""
        core = self.core
        L0 = ids.shape[1]
        params, caches, _ = self._unpack(self.weights + self.caches)
        sampled = temperature > 0
        self.temp.fill_(float(temperature))
        gen = None
        if sampled:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        wte = params["wte"]
        x = wte[ids] + params["wpe"][:L0][None]
        for lay, (kc, vc) in zip(params["layers"], caches):
            x, k, v = core.prefill_layer(lay, x)
            for cache, new in ((kc, k), (vc, v)):
                cache[:, :L0].copy_(new)
                cache[:, L0:].zero_()
        logits = core.ln(x[:, -1], *params["lnf"]) @ wte.T
        if sampled:
            self._fill_noise(gen)
        first = self.select(logits, self.temp, self.noise)
        self.out[:, :L0].copy_(ids)
        self.out[:, L0].copy_(first)
        self.tok.copy_(first)
        for t in range(L0, n_total - 1):
            if sampled:
                self._fill_noise(gen)
            self.program.replay(np.asarray(t, np.int64))
        return self.out[:, :n_total].clone()


def _gen_dtype(dtype, default):
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _generate(self, input_ids, max_new_tokens=32, temperature=0.0, top_k=0,
              seed=0, dtype=None, use_approx_topk=False, _capture=True):
    """Greedy (``temperature=0``) or sampled generation with dense KV
    caches (reference ``_generate``, ``gpt.py:524``): one batched prefill
    over the prompt, then one decode step a token. Returns ``[b,
    prompt_len + max_new_tokens]`` int64 on the model's device.

    ``dtype``: the decode's compute dtype (``"bfloat16"`` casts the
    floating weights; sampling stays float32); default the parameters'
    own. ``top_k``: exact top-k filter of the sampled draw;
    ``use_approx_topk=True`` raises (the TPU-native ``approx_max_k``,
    ROADMAP). The Gumbel noise comes from a ``torch.Generator`` seeded
    with ``seed``: sampled streams are not the reference's; greedy
    streams are. ``_capture=False`` (private) decodes eagerly on CUDA
    too, for comparisons with the captured program."""
    if use_approx_topk:
        raise NotImplementedError(
            "approx top-k is the TPU-native approx_max_k; the port "
            "implements exact top-k only")
    wte = self.gpt.wte.weight
    dev = wte.device
    ids = input_ids.detach().cpu().numpy() if isinstance(
        input_ids, torch.Tensor) else np.asarray(input_ids)
    ids = torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(dev)
    b, L0 = ids.shape
    req_new = int(max_new_tokens)
    req_total = L0 + req_new
    maxpos = self.gpt.cfg.max_position_embeddings
    if req_total > maxpos:
        raise ValueError(
            f"prompt_len({L0}) + max_new_tokens({max_new_tokens}) = "
            f"{req_total} exceeds max_position_embeddings({maxpos}) — "
            "the position table would silently clamp")
    if req_new == 0:
        return ids
    # the bucket (gpt.py:563): nearby lengths share one program; only
    # the requested positions are decoded
    bucket_new = min(-(-req_new // _GEN_BUCKET) * _GEN_BUCKET, maxpos - L0)
    total = L0 + bucket_new
    want = _gen_dtype(dtype, wte.dtype)
    key = (b, total, want, int(top_k), bool(_capture))
    progs = self._gen_programs
    if any(k[1] != total for k in progs):
        # one program set per total length, as the reference keeps one
        # jitted function per total length
        progs.clear()
    params = gen_params(self)
    dec = progs.get(key)
    if dec is None:
        if dev.type == "cuda" and self._gen_pool is None:
            from ..inference.graphs import GraphPool
            self._gen_pool = GraphPool(dev)
        dec = progs[key] = _DenseDecoder(self.gpt.cfg, params, b, total,
                                         want, top_k, dev, self._gen_pool,
                                         _capture)
    else:
        dec.load(params)
    return dec.run(ids, req_total, float(temperature), seed)


GPTForCausalLM.generate = _generate
