"""ResNet — port of ``paddle_tpu/vision/models/resnet.py``.

:class:`BasicBlock`, :class:`BottleneckBlock`, :class:`ResNet` and
``resnet18/34/50/101/152`` keep the reference's attribute names
(``conv1``, ``bn1``, ``layer1.0.downsample.1``, ``fc``, ...) and its
``data_format``: with ``"NHWC"`` the input is ``[N, H, W, C]`` and every
conv, batch norm and pool runs on a channels-last view of it. The
residual add and ``flatten(x, 1)`` are plain torch; under O1 the convs
and ``fc`` run in bf16 (white list) while batch norm keeps its input's
dtype and float32 statistics, as in the reference.

Weights are made on the host from numpy seed ``seed`` (KaimingUniform
convs, unit/zero batch norms, XavierUniform ``fc`` with a zero bias, as
the reference initialises them) and placed on ``device`` (CUDA unless
the caller asks for the CPU). ``pretrained=True`` raises: nothing is
downloaded.

:func:`reference_state` and :func:`load_reference_state` carry the
state across as the reference names it: ``named_parameters()`` (161 for
ResNet-50) and ``named_buffers()`` (106: each batch norm's
``_mean_buf`` and ``_variance_buf``), as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import nn
from ...device import resolve_device

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "reference_state", "load_reference_state"]


def _conv(cin, cout, k, ctx, **kw):
    return nn.Conv2D(cin, cout, k, bias_attr=False,
                     data_format=ctx["data_format"], rng=ctx["rng"],
                     device=ctx["device"], **kw)


def _bn(c, ctx):
    return nn.BatchNorm2D(c, data_format=ctx["data_format"],
                          device=ctx["device"])


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, *, ctx):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, ctx, stride=stride,
                           padding=1)
        self.bn1 = _bn(planes, ctx)
        self.relu = nn.ReLU()
        self.conv2 = _conv(planes, planes, 3, ctx, padding=1)
        self.bn2 = _bn(planes, ctx)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, *, ctx):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1, ctx)
        self.bn1 = _bn(width, ctx)
        self.conv2 = _conv(width, width, 3, ctx, padding=dilation,
                           stride=stride, groups=groups, dilation=dilation)
        self.bn2 = _bn(width, ctx)
        self.conv3 = _conv(width, planes * self.expansion, 1, ctx)
        self.bn3 = _bn(planes * self.expansion, ctx)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(torch.nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *,
                 device=None, seed=0):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        ctx = dict(data_format=data_format, rng=np.random.default_rng(seed),
                   device=resolve_device(device))
        self.inplanes = 64
        self.conv1 = _conv(3, self.inplanes, 7, ctx, stride=2, padding=3)
        self.bn1 = _bn(self.inplanes, ctx)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], ctx)
        self.layer2 = self._make_layer(block, 128, layers[1], ctx, stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], ctx, stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], ctx, stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                rng=ctx["rng"], device=ctx["device"])

    def _make_layer(self, block, planes, blocks, ctx, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                _conv(self.inplanes, planes * block.expansion, 1, ctx,
                      stride=stride),
                _bn(planes * block.expansion, ctx))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, ctx=ctx)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, ctx=ctx))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not downloaded "
                                  "by paddle_tpu_torch")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def reference_state(model):
    """``(params, buffers)``: the model's ``named_parameters()`` and
    ``named_buffers()`` as float32 numpy arrays (copies, which later steps
    leave alone), under the reference's names."""
    def arrays(named):
        return {n: t.detach().to("cpu", torch.float32, copy=True).numpy()
                for n, t in named}
    return arrays(model.named_parameters()), arrays(model.named_buffers())


def load_reference_state(model, params, buffers):
    """Copy the reference's ``named_parameters()`` and ``named_buffers()``
    (``{name: array}``) into ``model``; raises on a missing, extra or
    misshapen name."""
    nn.load_named_state(model, params, buffers)
