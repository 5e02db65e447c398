"""Parameter-holding layers that keep the flax scope and param names.

`Dense` (the counterpart of `clip_dplm_tpu/models/layers.py::_DenseParams`
and `nn.Dense`), `LayerNorm` and `Embed` name their parameters `kernel` /
`bias`, `scale` / `bias` and `embedding`, so a flax param tree maps onto a
`state_dict` key for key (utils/convert.py). Dense kernels are stored (out,
in), the transpose of flax's (in, out).

Dtype policy (the JAX package's): parameters are f32; a Dense computes in its
input's dtype (bf16 in the trunk, f32 for the DPLM head); LayerNorm computes
and returns f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(features, in_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal kernel (std 1/sqrt(fan_in)), zero bias."""
        with torch.no_grad():
            self.kernel.normal_(0.0, 1.0 / math.sqrt(self.kernel.shape[1]),
                                generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.eps)


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal with std 1/sqrt(features), as flax's default embed init."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(self.embedding.shape[1]),
                                   generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights for every layer of `module`, drawn from `generator`
    (which lives on the module's device)."""
    for m in module.modules():
        if isinstance(m, (Dense, LayerNorm, Embed)):
            m.reset_parameters(generator)
