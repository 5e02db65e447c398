"""The tong three-encoder stack of triple_flow.

Counterpart of `clip_dplm_tpu/models/tong_encoders.py`, in f32 as the JAX
package runs it:
- `MLPStack`: Dense -> LayerNorm -> GELU -> dropout, the last layer's
  LayerNorm optional (`final_ln`) and its GELU + dropout too (`final_act`);
  `create_projection_stack` is three such blocks of one width;
- `CellStateEncoder`: the expression MLP (g -> 2d -> d) plus the
  pseudotime MLP (1 -> time_dim -> d), the PiGNN over the kNN graph
  (models/gnn.py), then [h, its graph's mean] through `output_proj` with a
  residual;
- `PerturbationEncoder`: the ESM MLP and the DEG-value MLP, a cross-
  attention of the ESM latent (one query) over the value latent (one key),
  its LayerNorm, and [h_esm, h_att] through `output_proj` with a residual
  to h_esm;
- `ProteinEncoder`: an MLP over protein_hidden_dims + [latent], with a
  residual where the input is already latent wide.
`MultiHeadAttention` is flax's `MultiHeadDotProductAttention` (biased
`query`/`key`/`value`/`out` projections, q scaled by 1/sqrt(dh), softmax
over the keys in f32, no attention dropout); its Dense kernels are stored
(out, in) as (H*dh, d) and (d, H*dh), which utils/convert.py reshapes from
flax's (d, H, dh) and (H, dh, d). With one key the softmax is exactly 1, but
it is computed all the same, so that `query` and `key` get their exact zero
gradients, as in JAX. GELU is the tanh approximation, LayerNorm eps 1e-6,
dropout the hash dropout of models/layers.py in call order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from clip_dplm_tpu_torch.config import EncoderConfig
from clip_dplm_tpu_torch.models.gnn import MultiLayerPiGNN, gelu
from clip_dplm_tpu_torch.models.layers import FLAX_LN_EPS, Dense, LayerNorm, _dropout
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.ops.infonce import at_least_f32
from clip_dplm_tpu_torch.ops.segment import segment_mean


class MLPStack(nn.Module):
    """Dense `fc{i}` -> LayerNorm `ln{i}` -> GELU -> dropout per layer; the
    last layer's LayerNorm only with `final_ln`, its GELU and dropout only
    with `final_act`."""

    def __init__(self, in_dim: int, dims: Sequence[int], dropout: float = 0.1,
                 final_ln: bool = True, final_act: bool = False, device=None):
        super().__init__()
        self.dims, self.rate, self.final_act = tuple(dims), dropout, final_act
        for i, dim in enumerate(self.dims):
            self.add_module(f"fc{i}", Dense(in_dim if i == 0 else self.dims[i - 1], dim,
                                            device=device))
            if i < len(self.dims) - 1 or final_ln:
                self.add_module(f"ln{i}", LayerNorm(dim, FLAX_LN_EPS, device=device))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        n = len(self.dims)
        for i in range(n):
            x = getattr(self, f"fc{i}")(x)
            last = i == n - 1
            if hasattr(self, f"ln{i}"):
                x = getattr(self, f"ln{i}")(x).to(x.dtype)
            if not last or self.final_act:
                x = _dropout(gelu(x), self.rate, deterministic, seeds)
        return x


def create_projection_stack(in_dim: int, d_out: int, dropout: float = 0.1,
                            device=None) -> MLPStack:
    """Three Dense/LayerNorm/GELU/dropout blocks of width d_out, the last
    without GELU and dropout (tong projections.py semantics)."""
    return MLPStack(in_dim, (d_out, d_out, d_out), dropout=dropout, final_ln=True,
                    device=device)


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention over (B, Lq, d) queries and (B,
    Lk, d) keys/values: qkv_features = out_features = d."""

    def __init__(self, d: int, num_heads: int, device=None):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"width {d} is not a multiple of {num_heads} heads")
        self.h = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(d, d, device=device))

    def forward(self, xq: torch.Tensor, xkv: torch.Tensor) -> torch.Tensor:
        B, Lq, d = xq.shape
        H, dh = self.h, d // self.h
        q = self.query(xq).reshape(B, Lq, H, dh) / math.sqrt(dh)
        k = self.key(xkv).reshape(B, -1, H, dh)
        v = self.value(xkv).reshape(B, -1, H, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(at_least_f32(logits),
                          dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Lq, H * dh)
        return self.out(o)


class CellStateEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.gene_encoder = MLPStack(cfg.gene_dim, (2 * d, d), cfg.dropout, device=device)
        if cfg.use_time_encoding:
            self.time_encoder = MLPStack(1, (cfg.time_embed_dim, d), cfg.dropout,
                                         device=device)
        self.gnn = MultiLayerPiGNN(cfg.gnn, d, device=device)
        self.output_proj = MLPStack(2 * d, (d, d), cfg.dropout, final_ln=False, device=device)

    def forward(self, gene_expr: torch.Tensor, dpt: Optional[torch.Tensor],
                edge_index: torch.Tensor, batch_idx: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None,
                node_mask: Optional[torch.Tensor] = None, num_graphs: int = 1,
                deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """gene_expr (N, gene_dim), dpt (N,) or None, edge_index (2, E),
        batch_idx (N,) -> (N, latent_dim)."""
        dt = self._dtype()
        h = self.gene_encoder(gene_expr.to(dt), deterministic, seeds)
        if self.cfg.use_time_encoding and dpt is not None:
            h = h + self.time_encoder(dpt[:, None].to(dt), deterministic, seeds)
        h = self.gnn(h, edge_index, batch_idx, edge_mask, node_mask, num_graphs,
                     deterministic, seeds)
        h_global = segment_mean(h, batch_idx, num_graphs, mask=node_mask)
        h_cat = torch.cat([h, h_global[batch_idx.long()]], dim=-1)
        return self.output_proj(h_cat, deterministic, seeds) + h

    def _dtype(self) -> torch.dtype:
        return self.gene_encoder.fc0.kernel.dtype


class PerturbationEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.esm_encoder = MLPStack(cfg.esm_dim, (2 * d, d), cfg.dropout, device=device)
        self.value_encoder = MLPStack(cfg.n_perturb_genes, (d, d), cfg.dropout, device=device)
        if cfg.use_cross_attention:
            self.cross_attention = MultiHeadAttention(d, cfg.gnn.num_heads, device=device)
            self.attention_norm = LayerNorm(d, FLAX_LN_EPS, device=device)
        self.output_proj = MLPStack(2 * d, (d, d), cfg.dropout, final_ln=False, device=device)

    def forward(self, esm_embeddings: torch.Tensor, perturbation_values: torch.Tensor,
                deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """esm_embeddings (B, esm_dim) pooled over the perturbed genes,
        perturbation_values (B, n_perturb_genes) -> (B, latent_dim)."""
        dt = self.esm_encoder.fc0.kernel.dtype
        h_esm = self.esm_encoder(esm_embeddings.to(dt), deterministic, seeds)
        h_val = self.value_encoder(perturbation_values.to(dt), deterministic, seeds)
        if self.cfg.use_cross_attention:
            attn = self.cross_attention(h_esm[:, None, :], h_val[:, None, :])[:, 0]
            h_att = self.attention_norm(attn).to(dt)
        else:
            h_att = h_val
        out = self.output_proj(torch.cat([h_esm, h_att], dim=-1), deterministic, seeds)
        return out + h_esm


class ProteinEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dims = tuple(cfg.protein_hidden_dims) + (cfg.latent_dim,)
        self.encoder = MLPStack(cfg.esm_dim, dims, cfg.dropout, final_ln=False, device=device)

    def forward(self, protein_embedding: torch.Tensor, deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """(B, esm_dim) -> (B, latent_dim)."""
        x = protein_embedding.to(self.encoder.fc0.kernel.dtype)
        h = self.encoder(x, deterministic, seeds)
        if protein_embedding.shape[-1] == self.cfg.latent_dim:
            h = h + x
        return h
