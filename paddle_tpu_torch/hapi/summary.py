"""``summary`` and ``flops`` — port of ``paddle_tpu/hapi/summary.py``:
walk the module tree with forward hooks on every leaf module and collect
each one's output shape, parameter count and FLOPs (the reference's
``count_*`` rules by layer type name). The probe inputs are zeros made
on the network's device."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["summary", "flops"]


def _device(net):
    p = next(net.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def _make_inputs(input_size, dtypes, device):
    # input_size: tuple | [tuple] | tensor
    if isinstance(input_size, torch.Tensor):
        return [input_size]
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], (list, tuple)):
        sizes = list(input_size)
    else:
        sizes = [tuple(input_size)]
    dtypes = dtypes or ["float32"] * len(sizes)
    if not isinstance(dtypes, (list, tuple)):
        dtypes = [dtypes] * len(sizes)
    out = []
    for s, dt in zip(sizes, dtypes):
        s = tuple(1 if d is None or d == -1 else int(d) for d in s)
        out.append(torch.zeros(s, dtype=getattr(torch, str(dt)),
                               device=device))
    return out


def _param_count(layer, trainable_only=False):
    return sum(p.numel() for p in layer.parameters()
               if not trainable_only or p.requires_grad)


def _collect(net, inputs):
    """One forward with hooks on every leaf module; ``[(name, type,
    out_shape, params, module, inputs, output)]`` in call order."""
    rows = []
    handles = []

    def attach(name, layer):
        def hook(lyr, inp, out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            shp = list(o.shape) if isinstance(o, torch.Tensor) else None
            own = sum(p.numel() for p in lyr.parameters(recurse=False))
            rows.append((name, type(lyr).__name__, shp, own, lyr,
                         [i for i in inp if isinstance(i, torch.Tensor)], o))
        handles.append(layer.register_forward_hook(hook))

    for name, sub in net.named_modules():
        if name and not list(sub.children()):
            attach(name, sub)
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
    return rows


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Layer-by-layer table; returns ``{'total_params',
    'trainable_params'}``."""
    if input is not None:
        inputs = list(input) if isinstance(input, (list, tuple)) \
            else [input]
    else:
        inputs = _make_inputs(input_size, dtypes, _device(net))
    rows = _collect(net, inputs)
    header = f"{'Layer (type)':<28}{'Output Shape':<22}{'Param #':<12}"
    line = "-" * len(header)
    print(line)
    print(header)
    print(line)
    for name, tname, shp, own, *_ in rows:
        print(f"{name + ' (' + tname + ')':<28}{str(shp):<22}{own:<12}")
    total = _param_count(net)
    trainable = _param_count(net, trainable_only=True)
    print(line)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


# -- FLOPs (the reference's count rules) -------------------------------------

def _flops_of(layer, tname, ins, out):
    if not isinstance(out, torch.Tensor):
        return 0
    out_numel = int(np.prod(out.shape))
    if tname in ("Linear",):
        return out_numel * layer.weight.shape[0]     # weight [in, out]
    if tname in ("Conv2D", "Conv1D", "Conv3D", "Conv2DTranspose"):
        return out_numel * int(np.prod(layer.weight.shape[1:]))
    if tname in ("BatchNorm2D", "BatchNorm1D", "BatchNorm", "LayerNorm",
                 "InstanceNorm2D", "GroupNorm"):
        return 2 * out_numel
    if tname in ("ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "Softmax",
                 "LeakyReLU", "Hardswish", "Hardsigmoid", "SiLU"):
        return out_numel
    if tname in ("AvgPool2D", "MaxPool2D", "AdaptiveAvgPool2D",
                 "AdaptiveMaxPool2D"):
        return out_numel
    return 0


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """Multiply-accumulate count of one forward pass."""
    if inputs is None:
        inputs = _make_inputs(input_size, None, _device(net))
    elif not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    rows = _collect(net, list(inputs))
    total = 0
    details = []
    for name, tname, shp, own, layer, ins, out in rows:
        fl = None
        if custom_ops and type(layer) in custom_ops:
            fl = custom_ops[type(layer)](layer, ins, out)
        if fl is None:
            fl = _flops_of(layer, tname, ins, out)
        total += int(fl)
        details.append((name, tname, shp, int(fl)))
    if print_detail:
        for name, tname, shp, fl in details:
            print(f"{name:<28}{tname:<18}{str(shp):<22}{fl:,}")
        print(f"Total FLOPs: {total:,}")
    return total
