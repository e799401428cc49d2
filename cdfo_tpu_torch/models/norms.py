"""Channel LayerNorm (counterpart of ``cdfo_tpu/models/norms.py``).

In NHWC the channel axis is last, so the reference's WithBias_LayerNorm is
a plain last-axis norm: biased variance, eps=1e-5 under the sqrt, computed
in float32 and cast back. The parameters sit under ``body`` as in the
reference ``state_dict`` and stay float32, as the JAX math uses them.
"""
from __future__ import annotations

import torch
from torch import nn


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.body = nn.ParameterDict({
            "weight": nn.Parameter(torch.ones(dim)),
            "bias": nn.Parameter(torch.zeros(dim)),
        })

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + 1e-5) * self.body["weight"] \
            + self.body["bias"]
        return y.to(x.dtype)
