"""GPT-2 for the serving path — port of ``paddle_tpu/models/gpt.py``.

What the paged serving engine needs of the reference model:

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

from ..device import resolve_device

__all__ = ["GPTConfig", "gpt2_small", "gpt2_tiny", "init_params",
           "params_from_numpy", "make_layer_core", "tree_map"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    intermediate_size: int = None  # default 4*hidden
    layer_norm_epsilon: float = 1e-5
    num_experts: int = 0           # MoE: not ported; must stay 0

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.num_experts:
            raise NotImplementedError(
                "MoE layers are not ported to paddle_tpu_torch yet")


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
