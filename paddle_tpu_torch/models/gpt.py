"""GPT-2 — port of ``paddle_tpu/models/gpt.py``.

For the paged serving engine:

- :class:`GPTConfig`, :func:`gpt2_small`, :func:`gpt2_tiny` — the
  configurations (dense models only: MoE layers are not ported yet).
- :func:`init_params` — random weights from a numpy seed, in the layout
  of the reference's ``_gen_params`` (``gpt.py:283``).
- :func:`params_from_numpy` — carries the reference's weights across:
  ``_gen_params(model)`` with every leaf passed through ``np.asarray``
  becomes the port's parameter dict, the same tree with torch leaves.
- :func:`make_layer_core` — the per-layer math of ``_make_layer_core``
  (``gpt.py:328``): ``ln``, ``qkv_proj``, ``attn_out`` and the dense
  ``mlp_tail``.

For training (``gpt.py:74-251``): :class:`GPTAttention`,
:class:`GPTMLP`, :class:`GPTBlock`, :class:`GPTModel` and
:class:`GPTForCausalLM` (``forward`` and ``loss``), with parameter names
equal to the reference's; :meth:`GPTForCausalLM.load_reference_state`
takes the reference's ``named_parameters()`` as numpy arrays, and
:func:`gen_params` hands a (trained) model to the serving engine.

Layout kept from the reference: weights are ``[in, out]`` and applied
as ``h @ W``; the fused qkv projection splits ``[q|k|v]`` on the last
axis; the LM head is tied (``@ wte.T``).
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..device import resolve_device
from ..distributed.utils_recompute import recompute
from ..nn import functional as PF

__all__ = ["GPTConfig", "gpt2_small", "gpt2_tiny", "init_params",
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


def make_layer_core(cfg, eps=None):
    """Per-layer transformer math shared by the serving programs — the
    port of ``_make_layer_core`` (dense layers only). ``eps`` defaults
    to ``cfg.layer_norm_epsilon`` (the reference reads it from
    ``model.gpt.ln_f._epsilon``)."""
    H, NH = cfg.hidden_size, cfg.num_heads
    HD = H // NH
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

    return SimpleNamespace(H=H, NH=NH, HD=HD, scale=scale, ln=ln,
                           qkv_proj=qkv_proj, attn_out=attn_out,
                           mlp_tail=mlp_tail)


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
            bf = torch.bfloat16
            x = x.to(bf) + self.attn(self.ln1(x)).to(bf)
            return x + self._mlp_out(x).to(bf)
        x = x + self.attn(self.ln1(x))
        return x + self._mlp_out(x)


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
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
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
