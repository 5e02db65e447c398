"""Protein and gene projection heads over frozen ESM embeddings.

Counterpart of `clip_dplm_tpu/models/esm_projections.py`, in f32:
- `ResidualBlock`: x + Dense(ReLU(dropout(LN(Dense x))));
- `AttentionBlock`: LN(x + self-attention of x as one token), the
  attention flax's MultiHeadDotProductAttention (models/tong_encoders.py);
- `ProteinProjection`: Dense -> LN -> ReLU -> dropout -> ResidualBlock ->
  Dense -> LN (in_dim -> out_dim, 1280 -> 512 by default);
- `GeneProjection`: the same with an AttentionBlock in place of the
  residual block.
Parameter names are the flax modules' (`fc_in`, `ln_in`, `residual`,
`attention`, `fc_out`, `ln_out`); LayerNorm eps 1e-6; the output is f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.models.layers import FLAX_LN_EPS, Dense, LayerNorm, _dropout
from clip_dplm_tpu_torch.models.tong_encoders import MultiHeadAttention
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds


class ResidualBlock(nn.Module):
    def __init__(self, dim: int, dropout: float = 0.1, device=None):
        super().__init__()
        self.rate = dropout
        self.fc1 = Dense(dim, dim, device=device)
        self.ln = LayerNorm(dim, FLAX_LN_EPS, device=device)
        self.fc2 = Dense(dim, dim, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        h = F.relu(self.ln(self.fc1(x)).to(x.dtype))
        return x + self.fc2(_dropout(h, self.rate, deterministic, seeds))


class AttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, device=None):
        super().__init__()
        self.attn = MultiHeadAttention(dim, num_heads, device=device)
        self.ln = LayerNorm(dim, FLAX_LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]
        return self.ln(x + self.attn(h, h)[:, 0]).to(x.dtype)


class _Projection(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dropout: float, device=None):
        super().__init__()
        self.rate = dropout
        self.fc_in = Dense(in_dim, out_dim, device=device)
        self.ln_in = LayerNorm(out_dim, FLAX_LN_EPS, device=device)
        self.fc_out = Dense(out_dim, out_dim, device=device)
        self.ln_out = LayerNorm(out_dim, FLAX_LN_EPS, device=device)

    def _block(self, h, deterministic, seeds):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        dt = self.fc_in.kernel.dtype
        h = F.relu(self.ln_in(self.fc_in(x.to(dt))).to(dt))
        h = _dropout(h, self.rate, deterministic, seeds)
        h = self._block(h, deterministic, seeds)
        return self.ln_out(self.fc_out(h))


class ProteinProjection(_Projection):
    """in_dim -> out_dim protein-space head with a residual MLP block."""

    def __init__(self, in_dim: int = 1280, out_dim: int = 512, dropout: float = 0.1,
                 device=None):
        super().__init__(in_dim, out_dim, dropout, device)
        self.residual = ResidualBlock(out_dim, dropout, device=device)

    def _block(self, h, deterministic, seeds):
        return self.residual(h, deterministic, seeds)


class GeneProjection(_Projection):
    """in_dim -> out_dim gene-space head with a self-attention block."""

    def __init__(self, in_dim: int = 1280, out_dim: int = 512, num_heads: int = 8,
                 dropout: float = 0.1, device=None):
        super().__init__(in_dim, out_dim, dropout, device)
        self.attention = AttentionBlock(out_dim, num_heads, device=device)

    def _block(self, h, deterministic, seeds):
        return self.attention(h)
