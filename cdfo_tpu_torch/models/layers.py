"""Basic NHWC building blocks (PyTorch counterparts of
``cdfo_tpu/models/layers.py``).

Every public ``forward`` takes and returns channels-last (N, H, W, C)
tensors, as the JAX package does. A convolution permutes its input to an
NCHW *view* (``x.permute(0, 3, 1, 2)`` is zero-copy and channels-last
strided), so cuDNN runs its NHWC kernels and hands back an NHWC-strided
result.

Weights use the torch layouts and the reference ``state_dict`` names.
Convolution weights are stored in the compute dtype: ``cdfo_tpu`` keeps
float32 params and casts them at every use, and rounding once at load time
gives the same values. Initialisation reproduces torch's defaults
(kaiming-uniform with a=sqrt(5)) and the reference's 0.1-scaled
kaiming-normal for residual blocks, drawn from an explicit
``torch.Generator``; see :func:`init_weights`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _fill_uniform(p: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))


def _fill_normal(p: torch.Tensor, std: float, generator: torch.Generator):
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))


def check_device(device, what: str) -> None:
    """Raises if ``device`` is the card and there is none: the models build
    on the card unless the caller asks for the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the card by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions of the "
            "kernels on the CPU")


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of ``module`` from ``generator`` (a CPU
    generator; the draws happen on the CPU and are copied into place)."""
    for m in module.modules():
        init = getattr(m, "init_parameters", None)
        if init is not None:
            init(generator)
    return module


class Conv2d(nn.Module):
    """NHWC conv with torch-style int padding and torch default init.

    ``init_scale`` selects the reference's scaled kaiming-normal weight
    init (``std = sqrt(2 / fan_in) * init_scale``) instead of torch's
    default kaiming-uniform; the bias is torch-default either way.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1,
                 padding=0, groups: int = 1, bias: bool = True,
                 init_scale: float | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.groups = groups
        self.init_scale = init_scale
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kh, kw, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_ch, dtype=dtype))
                     if bias else None)

    def init_parameters(self, generator: torch.Generator):
        fan_in = self.weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in)
        if self.init_scale is None:
            _fill_uniform(self.weight, bound, generator)
        else:
            _fill_normal(self.weight,
                         math.sqrt(2.0 / fan_in) * self.init_scale, generator)
        if self.bias is not None:
            _fill_uniform(self.bias, bound, generator)

    def forward(self, x):
        x, padding = x.to(self.dtype), self.padding
        shard = spatial.split()
        if shard is not None and self.weight.shape[2] > 1:
            # H split over ranks: the rows the taps reach come as a halo
            x = spatial.conv_halo(x, self.weight.shape[2], self.stride[0],
                                  padding[0], shard)
            padding = (0, padding[1])
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.Module):
    """Exact ``torch.nn.ConvTranspose2d`` in NHWC. The weight is in torch
    layout (in, out, kh, kw), so unlike the JAX version (an input-dilated
    forward conv) no kernel flip is needed."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 2, output_padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            in_ch, out_ch, kernel_size, kernel_size, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_ch, dtype=dtype))

    def init_parameters(self, generator: torch.Generator):
        # torch computes fan_in of the (in, out, k, k) weight from dim 1
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _fill_uniform(self.weight, bound, generator)
        _fill_uniform(self.bias, bound, generator)

    def forward(self, x):
        if spatial.split() is not None:
            raise ValueError("ConvTranspose2d has no row split: run it whole "
                             "(spatial.gather_rows, spatial.sharded(None))")
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight, self.bias, self.stride,
                               self.padding, self.output_padding)
        return y.permute(0, 2, 3, 1)


def lrelu(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)


class ResidualBlockNoBN(nn.Module):
    """conv-ReLU-conv + identity, 0.1-scaled kaiming init."""

    def __init__(self, nf: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(nf, nf, 3, 1, 1, init_scale=0.1, dtype=dtype)
        self.conv2 = Conv2d(nf, nf, 3, 1, 1, init_scale=0.1, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x)))


class CALayer(nn.Module):
    """Channel attention: GAP -> 1x1 conv -> ReLU -> 1x1 conv -> sigmoid."""

    def __init__(self, channel: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype), nn.ReLU(),
            Conv2d(channel, channel, 1, dtype=dtype), nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(spatial.spatial_mean(x))


class SpatialAttention(nn.Module):
    """max/mean channel pool -> 7x7 conv -> sigmoid gate."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spatial = Conv2d(2, 1, 7, 1, 3, dtype=dtype)

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=-1, keepdim=True),
                            x.mean(dim=-1, keepdim=True)], dim=-1)
        return x * torch.sigmoid(self.spatial(pooled))


class DPConv(nn.Module):
    """Depthwise (k, stride, groups = C) then pointwise 1x1
    (`arch/SIDECVSR_our.py:37-59`); ``depth_conv`` and ``point_conv`` as
    the reference names them."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth_conv = Conv2d(in_ch, in_ch, kernel_size, stride,
                                 (kernel_size - 1) // 2, groups=in_ch,
                                 dtype=dtype)
        self.point_conv = Conv2d(in_ch, out_ch, 1, dtype=dtype)

    def forward(self, x):
        return self.point_conv(self.depth_conv(x))
