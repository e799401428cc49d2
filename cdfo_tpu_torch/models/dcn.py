"""Deformable-convolution modules (counterpart of ``cdfo_tpu/models/dcn.py``,
the reference binding layer `ops/dcn/deform_conv.py:190-337`) on the plain
``ops/deform_conv.deform_conv2d``. NHWC in and out; weights in the torch
layout under the reference's names. The weight is drawn uniform in
+-1/sqrt(Cin*k*k) (``_ref_weight_init``); the offset and mask heads' weights
start at zero (their biases torch-default, as ``cdfo_tpu``'s), so each op
starts as a convolution at a constant offset.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.deform_conv import deform_conv2d
from .layers import Conv2d, _fill_uniform


def _ref_weight_init(weight: torch.Tensor, in_channels: int,
                     generator: torch.Generator) -> None:
    """uniform(-stdv, stdv), stdv = 1 / sqrt(in_channels * kh * kw)."""
    kh, kw = weight.shape[-2:]
    _fill_uniform(weight, 1.0 / math.sqrt(in_channels * kh * kw), generator)


class ZeroConv2d(Conv2d):
    """A ``Conv2d`` whose weight starts at zero, its bias torch-default
    (the offset and mask heads; JAX ``kernel_init=zeros``)."""

    def init_parameters(self, generator: torch.Generator):
        super().init_parameters(generator)
        with torch.no_grad():
            self.weight.zero_()


class DeformConv(nn.Module):
    """v1: forward(x, offset); no bias (`deform_conv.py:204`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, deformable_groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_ch, self.stride, self.padding = in_ch, stride, padding
        self.dilation, self.groups = dilation, groups
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch // groups, kernel_size, kernel_size, dtype=dtype))

    def init_parameters(self, generator: torch.Generator):
        _ref_weight_init(self.weight, self.in_ch, generator)

    def forward(self, x, offset):
        return deform_conv2d(x.to(self.weight.dtype), offset, self.weight,
                             stride=self.stride, padding=self.padding,
                             dilation=self.dilation, groups=self.groups)


class DeformConvPack(nn.Module):
    """v1 pack: offsets from a zero-initialised conv of x."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, deformable_groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.conv_offset = ZeroConv2d(in_ch, deformable_groups * 2 * k * k,
                                      k, stride, padding, dtype=dtype)
        self.dc = DeformConv(in_ch, out_ch, k, stride, padding, dilation,
                             groups, deformable_groups, dtype=dtype)

    def forward(self, x):
        return self.dc(x, self.conv_offset(x))


class ModulatedDeformConv(nn.Module):
    """v2: forward(x, offset, mask), the mask already through its sigmoid."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, deformable_groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_ch, self.stride, self.padding = in_ch, stride, padding
        self.dilation, self.groups = dilation, groups
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch // groups, kernel_size, kernel_size, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_ch, dtype=dtype)) if bias
                     else None)

    def init_parameters(self, generator: torch.Generator):
        _ref_weight_init(self.weight, self.in_ch, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x, offset, mask):
        return deform_conv2d(x.to(self.weight.dtype), offset, self.weight,
                             self.bias, mask, self.stride, self.padding,
                             self.dilation, self.groups)


def split_offset_mask(out: torch.Tensor):
    """Pack head output (..., 3*G*K) -> (offset (..., 2*G*K), sigmoid mask).
    The torch pack chunks the channels into (o1, o2, m) and concatenates
    (o1, o2) (`deform_conv.py:331-334`); ``deform_conv2d`` then reads those
    channels as interleaved ``[dy, dx]`` pairs, as the CUDA op does."""
    gk = out.shape[-1] // 3
    return out[..., :2 * gk], torch.sigmoid(out[..., 2 * gk:])


class ModulatedDeformConvPack(nn.Module):
    """v2 pack (`deform_conv.py:311-337`): offsets and mask from a
    zero-initialised conv of x (or of ``extra_offset_input``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, deformable_groups: int = 1,
                 bias: bool = True, offset_in_ch: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.conv_offset_mask = ZeroConv2d(
            offset_in_ch or in_ch, deformable_groups * 3 * k * k, k, stride,
            padding, dtype=dtype)
        self.mdc = ModulatedDeformConv(in_ch, out_ch, k, stride, padding,
                                       dilation, groups, deformable_groups,
                                       bias, dtype=dtype)

    def forward(self, x, extra_offset_input=None):
        src = x if extra_offset_input is None else extra_offset_input
        offset, mask = split_offset_mask(self.conv_offset_mask(src))
        return self.mdc(x, offset, mask)
