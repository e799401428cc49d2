"""LPIPS perceptual metric (``cdfo_tpu/metrics/lpips.py``; the reference
vendors richzhang's implementation: trunks in
`opt/lpips/pretrained_networks.py:5-180`, scoring in `opt/lpips/loss.py:
19-120`).

VGG16 / AlexNet / SqueezeNet 1.1 feature trunks on NCHW tensors, the
ImageNet shift and scale, per-tap unit normalisation (eps 1e-10), squared
differences, 1x1 linear heads, averaged over each tap's positions or (with
``spatial``) upsampled to the input size and summed. The convolutions are
``F.conv2d`` (plain XLA in ``cdfo_tpu``; no kernel of the port's).

Parameter names are torchvision's (``net.features.<index>...``, the
SqueezeNet fire modules' ``squeeze`` / ``expand1x1`` / ``expand3x3``) and
the richzhang heads' (``lin<i>.model.1.weight``), so
:func:`load_torch_weights` loads both files by name, every convolution of
every trunk. ``compat/lpips_params.py`` carries ``cdfo_tpu``'s flax
params across.

Where ``cdfo_tpu`` differs from those sources the port keeps it where it is
the metric's value and records it otherwise (ROADMAP Queue 3):
SqueezeNet's max pools floor (flax ``max_pool``) where torchvision's
``ceil_mode=True`` rounds up (equal where the sizes before each pool are
odd, as at 64 and 256); ``cdfo_tpu``'s ``spatial=True`` raises for every
trunk (it adds maps of different sizes), where the port upsamples each map
bilinearly to the input size, as the reference's ``spatial`` mode does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import check_device

# ImageNet scaling used by LPIPS (`opt/lpips/loss.py` ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision's vgg16 features: (index, out channels) of each conv; a max
# pool follows the convs at indices 2, 7, 14, 21 (and 28, after the last
# tap, which LPIPS never runs)
VGG16_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
               (14, 256), (17, 512), (19, 512), (21, 512), (24, 512),
               (26, 512), (28, 512))
VGG16_POOLS = (4, 9, 16, 23)
VGG16_TAPS = (3, 8, 15, 22, 29)   # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG16_CHS = (64, 128, 256, 512, 512)

# torchvision's alexnet features: (index, out, kernel, stride, padding)
ALEX_CONVS = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1),
              (8, 256, 3, 1, 1), (10, 256, 3, 1, 1))
ALEX_POOLS = (2, 5)
ALEX_TAPS = (1, 4, 7, 9, 11)
ALEX_CHS = (64, 192, 384, 256, 256)

# torchvision's squeezenet1_1 features: conv 0, fire modules (index,
# squeeze, expand), pools at 2, 5, 8
SQUEEZE_FIRES = ((3, 16, 64), (4, 16, 64), (6, 32, 128), (7, 32, 128),
                 (9, 48, 192), (10, 48, 192), (11, 64, 256), (12, 64, 256))
SQUEEZE_POOLS = (2, 5, 8)
SQUEEZE_TAPS = (1, 4, 7, 9, 10, 11, 12)
SQUEEZE_CHS = (64, 128, 256, 384, 384, 512, 512)

NETS = ("vgg", "alex", "squeeze")


class _Fire(nn.Module):
    """SqueezeNet Fire: squeeze 1x1 -> relu -> (expand1x1 | expand3x3) ->
    relu -> concat (torchvision squeezenet1_1 building block)."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)),
                          F.relu(self.expand3x3(x))], dim=1)


class _Trunk(nn.Module):
    """A torchvision ``features`` sequence run up to its last LPIPS tap:
    ``forward`` returns the activations after the tap indices."""

    def __init__(self, layers: dict, taps: tuple):
        super().__init__()
        self.taps = taps
        last = max(taps)
        self.features = nn.Sequential(*(layers[i] for i in range(last + 1)))

    def forward(self, x):
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                out.append(x)
        return out


class VGG16Features(_Trunk):
    def __init__(self):
        layers = {}
        cin = 3
        for i, ch in VGG16_CONVS:
            layers[i] = nn.Conv2d(cin, ch, 3, padding=1)
            layers[i + 1] = nn.ReLU()
            cin = ch
        for i in VGG16_POOLS:
            layers[i] = nn.MaxPool2d(2, 2)
        super().__init__(layers, VGG16_TAPS)


class AlexNetFeatures(_Trunk):
    def __init__(self):
        layers = {}
        cin = 3
        for i, ch, k, s, p in ALEX_CONVS:
            layers[i] = nn.Conv2d(cin, ch, k, stride=s, padding=p)
            layers[i + 1] = nn.ReLU()
            cin = ch
        for i in ALEX_POOLS:
            layers[i] = nn.MaxPool2d(3, 2)
        super().__init__(layers, ALEX_TAPS)


class SqueezeNetFeatures(_Trunk):
    """The 7 LPIPS taps of squeezenet1_1 (`opt/lpips/pretrained_networks.py:
    5-54` slicing); the pools floor, as ``cdfo_tpu``'s do."""

    def __init__(self):
        layers = {0: nn.Conv2d(3, 64, 3, stride=2), 1: nn.ReLU()}
        cin = 64
        for i, sq, ex in SQUEEZE_FIRES:
            layers[i] = _Fire(cin, sq, ex)
            cin = 2 * ex
        for i in SQUEEZE_POOLS:
            layers[i] = nn.MaxPool2d(3, 2)
        super().__init__(layers, SQUEEZE_TAPS)


TRUNKS = {"vgg": (VGG16Features, VGG16_CHS), "alex": (AlexNetFeatures, ALEX_CHS),
          "squeeze": (SqueezeNetFeatures, SQUEEZE_CHS)}


class _Head(nn.Module):
    """A 1x1 linear head under the richzhang name ``model.1`` (the
    reference's dropout in slot 0 is absent in ``cdfo_tpu``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(ch, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Each position's channel vector over its L2 norm (+ eps)."""
    return x / (x.square().sum(dim=1, keepdim=True).sqrt() + eps)


def seed_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` from ``generator`` (a CPU
    generator): uniform in +-1/sqrt(fan_in), torch's default bound, and
    the LPIPS heads in [0, 1/sqrt(fan_in)) (trained heads are non-negative)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            bound = 1.0 / math.sqrt(fan_in)
            draw = torch.empty(p.shape).uniform_(-bound, bound,
                                                 generator=generator)
            if name.startswith("lin"):
                draw = draw.abs()
            p.copy_(draw)


class LPIPS(nn.Module):
    """``forward(x, y)`` -> per-sample LPIPS distance (B,), or with
    ``spatial`` a (B, 1, H, W) map. x, y: (B, 3, H, W) RGB in [-1, 1]
    (``normalize_input=True`` for [0, 1] inputs). Built on ``device`` (the
    card unless the caller asks for the CPU), its weights drawn from
    ``generator`` (seed 0 if None) until loaded."""

    def __init__(self, net: str = "vgg", normalize_input: bool = False,
                 spatial: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if net not in TRUNKS:
            raise ValueError(f"net={net!r}: one of {NETS}")
        check_device(device, "LPIPS")
        self.net_name = net
        self.normalize_input = normalize_input
        self.spatial = spatial
        trunk, chs = TRUNKS[net]
        self.net = trunk()
        self.heads = len(chs)
        for i, ch in enumerate(chs):
            self.add_module(f"lin{i}", _Head(ch))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))
        seed_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def lins(self) -> list:
        return [getattr(self, f"lin{i}") for i in range(self.heads)]

    def layer_distances(self, x: torch.Tensor, y: torch.Tensor) -> list:
        """Each tap's head output, (B, 1, h_i, w_i)."""
        if self.normalize_input:
            x, y = 2 * x - 1, 2 * y - 1
        b = x.shape[0]
        taps = self.net((torch.cat([x, y]) - self.shift) / self.scale)
        return [lin((unit_normalize(t[:b]) - unit_normalize(t[b:])).square())
                for lin, t in zip(self.lins(), taps)]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        maps = self.layer_distances(x, y)
        if self.spatial:
            size = x.shape[2:]
            return sum(F.interpolate(m, size=size, mode="bilinear",
                                     align_corners=False) for m in maps)
        return sum(m.mean(dim=(1, 2, 3)) for m in maps)


def load_torch_weights(model: LPIPS, backbone_path: Optional[str] = None,
                       heads_path: Optional[str] = None) -> LPIPS:
    """Fill ``model`` from torch files, by name: a torchvision backbone
    ``state_dict`` (``vgg16-397923af.pth`` style: its ``features.*`` keys,
    every one of the trunk's convolutions, SqueezeNet's fire modules
    included) and richzhang's linear heads (``opt/weights/v0.1/vgg.pth``:
    keys ``lin<i>.model.1.weight``, those present). Returns ``model``."""
    if backbone_path:
        sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
        feats = {k[len("features."):]: v for k, v in sd.items()
                 if k.startswith("features.")}
        model.net.features.load_state_dict(feats)
    if heads_path:
        sd = torch.load(heads_path, map_location="cpu", weights_only=True)
        heads = {f"lin{i}.model.1.weight": sd[f"lin{i}.model.1.weight"]
                 for i in range(model.heads) if f"lin{i}.model.1.weight" in sd}
        model.load_state_dict(heads, strict=False)
    return model
