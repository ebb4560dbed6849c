"""Weight-only int8 for the serving engine — port of
``paddle_tpu/quantization/weights.py``.

``quantize_weights_int8`` turns the port's parameter dict
(``models/gpt.py`` ``params_from_numpy``, the reference's
``_gen_params`` layout) into a serving artifact whose matmul weights are
``(int8 codes, f32 scale)`` tuples in place, one scale per output
channel of the consuming product, kept with ``keepdims`` so that
dequantization is one broadcast multiply whatever the rank:

- the fused qkv ``[H, 3H]``, the attention out-projection ``[H, H]``,
  the MLP ``fc_in``/``fc_out`` (dense ``[H, I]``/``[I, H]``; MoE expert
  stacks ``[E, H, I]``/``[E, I, H]`` per (expert, out-channel)), and the
  tied embedding / lm head ``wte`` ``[V, H]`` per row;
- biases, layer norms, the position table ``wpe`` and the MoE gate pass
  through untouched.

``dequantize_params`` is the inverse the serving programs run at every
dispatch's entry when ``weight_dtype="int8"``: the device holds the int8
artifact, and each dispatch widens it to float32. ``cast_params`` is
``weight_dtype="bf16"``; ``params_nbytes`` sizes either artifact.
"""
from __future__ import annotations

import torch

from ..models.gpt import tree_map
from .kv import symmetric_int8

__all__ = ["quantize_weights_int8", "dequantize_params", "cast_params",
           "params_nbytes", "is_quantized_params"]


def _qw(w, axis, expert_axis=None):
    """Symmetric int8 with one scale per ``axis`` channel (keepdims).
    ``expert_axis`` keeps a second axis in the scale grid, so an MoE
    expert stack quantizes per (expert, out-channel)."""
    keep = {axis % w.dim()}
    if expert_axis is not None:
        keep.add(expert_axis % w.dim())
    red = tuple(i for i in range(w.dim()) if i not in keep)
    return symmetric_int8(w, red, keepdims=True)


def _dq(leaf, dtype):
    """A quantized ``(q, s)`` pair back to ``dtype``; a plain leaf passes
    through."""
    if isinstance(leaf, tuple) and len(leaf) == 2:
        q, s = leaf
        return (q.float() * s).to(dtype)
    return leaf


def is_quantized_params(params):
    """True for a :func:`quantize_weights_int8` artifact (its wte slot
    holds a (q, scale) pair instead of a tensor)."""
    return isinstance(params.get("wte"), tuple)


def quantize_weights_int8(params):
    """Parameter dict -> the int8 serving artifact: matmul weights become
    ``(int8, per-output-channel f32 scale)`` pairs in place; biases,
    norms, ``wpe`` and the MoE gate pass through by reference."""
    layers = []
    for lay in params["layers"]:
        mlp = lay["mlp"]
        if len(mlp) == 5:     # MoE: (gate, w1 [E,H,I], b1, w2 [E,I,H], b2)
            mlp_q = (mlp[0], _qw(mlp[1], -1, expert_axis=0), mlp[2],
                     _qw(mlp[3], -1, expert_axis=0), mlp[4])
        else:                 # dense: (w1 [H,I], b1, w2 [I,H], b2)
            mlp_q = (_qw(mlp[0], 1), mlp[1], _qw(mlp[2], 1), mlp[3])
        layers.append(dict(
            ln1=lay["ln1"], ln2=lay["ln2"],
            qkv=(_qw(lay["qkv"][0], 1), lay["qkv"][1]),
            proj=(_qw(lay["proj"][0], 1), lay["proj"][1]),
            mlp=mlp_q))
    # wte [V, H]: the lm head's output channels (x @ wte.T) are its rows
    return dict(wte=_qw(params["wte"], 0), wpe=params["wpe"],
                lnf=params["lnf"], layers=layers)


def dequantize_params(params, dtype=torch.float32):
    """A quantized dict back to the plain layout with every weight
    widened to ``dtype``; a plain dict passes through untouched, so one
    call site serves both modes."""
    if not is_quantized_params(params):
        return params
    layers = []
    for lay in params["layers"]:
        mlp = lay["mlp"]
        if len(mlp) == 5:
            mlp_d = (mlp[0], _dq(mlp[1], dtype), mlp[2],
                     _dq(mlp[3], dtype), mlp[4])
        else:
            mlp_d = (_dq(mlp[0], dtype), mlp[1], _dq(mlp[2], dtype),
                     mlp[3])
        layers.append(dict(
            ln1=lay["ln1"], ln2=lay["ln2"],
            qkv=(_dq(lay["qkv"][0], dtype), lay["qkv"][1]),
            proj=(_dq(lay["proj"][0], dtype), lay["proj"][1]),
            mlp=mlp_d))
    return dict(wte=_dq(params["wte"], dtype), wpe=params["wpe"],
                lnf=params["lnf"], layers=layers)


def cast_params(params, dtype=torch.bfloat16):
    """``weight_dtype="bf16"``: every floating leaf cast to ``dtype``;
    integer leaves pass through."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    params)


def params_nbytes(params):
    """Resident bytes of a parameter dict, plain, cast or quantized
    (scales counted)."""
    total = []
    tree_map(lambda t: total.append(t.numel() * t.element_size()), params)
    return float(sum(total))
