"""PiGNN: the protein-informed graph network over the cell kNN graph.

Counterpart of `clip_dplm_tpu/models/gnn.py` (`PiGNNLayer`,
`MultiLayerPiGNN`), in f32 as the JAX package runs it: per-edge multi-head
attention whose softmax runs over the HEAD axis of each edge (heads compete
per edge, the reference's unusual choice, kept for parity), the edge MLP
over [h_src, e, h_dst] with its LayerNorm, the node MLP over [aggregated
messages, h] with a residual LayerNorm, the gating of every node by a
sigmoid MLP of its graph's mean, and the skip projection over every layer's
node state. Edges are padded to a static count and masked (padded edges
point at node 0); messages aggregate at their destination with
`ops/segment.py`. Parameter names are the flax modules' (`q_proj`,
`edge_mlp_fc0`, `gate_ln`, ...), so `utils/convert.py` loads a flax tree
key for key. LayerNorms take flax's eps 1e-6; GELU is the tanh
approximation; dropout is the hash dropout of models/layers.py, one seed
per site in call order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.config import GNNConfig
from clip_dplm_tpu_torch.models.layers import FLAX_LN_EPS, Dense, LayerNorm, _dropout
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.ops.segment import segment_mean, segment_sum


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's nn.gelu: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def add_mlp(owner: nn.Module, name: str, in_dim: int, dims: Sequence[int], device=None):
    """Register Dense layers `{name}_fc{i}` with a `{name}_ln{i}` after every
    one but the last on `owner` (the flax names); returns their (fc, ln or
    None) names for `run_mlp`."""
    names = []
    for i, dim in enumerate(dims):
        owner.add_module(f"{name}_fc{i}", Dense(in_dim if i == 0 else dims[i - 1], dim,
                                                device=device))
        ln = None
        if i < len(dims) - 1:
            ln = f"{name}_ln{i}"
            owner.add_module(ln, LayerNorm(dim, FLAX_LN_EPS, device=device))
        names.append((f"{name}_fc{i}", ln))
    return names


def run_mlp(owner: nn.Module, names, x, rate, deterministic, seeds):
    """The MLP of `add_mlp`: LayerNorm, GELU and dropout after every Dense
    but the last."""
    for fc, ln in names:
        x = getattr(owner, fc)(x)
        if ln is not None:
            x = gelu(getattr(owner, ln)(x).to(x.dtype))
            x = _dropout(x, rate, deterministic, seeds)
    return x


class PiGNNLayer(nn.Module):
    def __init__(self, d_emb: int, n_heads: int, dropout: float = 0.1, device=None):
        super().__init__()
        d = d_emb
        self.d, self.h, self.rate = d, n_heads, dropout
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, Dense(d, d, device=device))
        self._edge = add_mlp(self, "edge_mlp", 3 * d, (d, d), device)
        self.ln_edge = LayerNorm(d, FLAX_LN_EPS, device=device)
        self._node = add_mlp(self, "node_mlp", 2 * d, (2 * d, d), device)
        self.ln_node = LayerNorm(d, FLAX_LN_EPS, device=device)
        self.gate_fc0 = Dense(d, d, device=device)
        self.gate_ln = LayerNorm(d, FLAX_LN_EPS, device=device)
        self.gate_fc1 = Dense(d, d, device=device)

    def forward(self, h: torch.Tensor, e: torch.Tensor, edge_index: torch.Tensor,
                batch_idx: torch.Tensor, edge_mask: Optional[torch.Tensor] = None,
                node_mask: Optional[torch.Tensor] = None, num_graphs: int = 1,
                deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (N, d) nodes, e (E, d) edges, edge_index (2, E) src/dst ->
        (h', e')."""
        d, H = self.d, self.h
        dh = d // H
        src, dst = edge_index[0].long(), edge_index[1].long()
        q = self.q_proj(h)[dst].reshape(-1, H, dh)
        k = self.k_proj(h)[src].reshape(-1, H, dh)
        v = self.v_proj(h)[src].reshape(-1, H, dh)
        scores = torch.einsum("nhd,nhd->nh", q, k) / math.sqrt(float(dh))
        attn = torch.softmax(scores, dim=1)  # over the heads of each edge
        attn = _dropout(attn, self.rate, deterministic, seeds)
        msg = self.o_proj((attn[..., None] * v).reshape(-1, d))

        # the edge state reaches no node and no loss (JAX's jit drops this as
        # dead code); the port runs it, as a traced range for profile_step
        with torch.profiler.record_function("gnn.edge_update"):
            e_in = torch.cat([h[src], e, h[dst]], dim=-1)
            e_upd = run_mlp(self, self._edge, e_in, self.rate, deterministic, seeds)
            e = self.ln_edge(e + e_upd).to(h.dtype)

        agg = segment_sum(msg, dst, h.shape[0], mask=edge_mask)
        h_upd = run_mlp(self, self._node, torch.cat([agg, h], dim=-1), self.rate,
                         deterministic, seeds)
        h = self.ln_node(h + h_upd).to(e.dtype)

        h_global = segment_mean(h, batch_idx, num_graphs, mask=node_mask)
        g = gelu(self.gate_ln(self.gate_fc0(h_global)).to(h.dtype))
        g = torch.sigmoid(self.gate_fc1(g))
        return h * g[batch_idx.long()], e


class MultiLayerPiGNN(nn.Module):
    """cfg.num_layers PiGNN layers (`layer_{i}`); every layer's node state,
    concatenated, through `skip_proj`, added to the last and normalized
    (`ln_out`)."""

    def __init__(self, cfg: GNNConfig, latent_dim: int, device=None):
        super().__init__()
        self.cfg, self.latent_dim = cfg, latent_dim
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", PiGNNLayer(latent_dim, cfg.num_heads, cfg.dropout,
                                                     device=device))
        self.skip_proj = Dense(cfg.num_layers * latent_dim, latent_dim, device=device)
        self.ln_out = LayerNorm(latent_dim, FLAX_LN_EPS, device=device)

    def forward(self, h, edge_index, batch_idx, edge_mask=None, node_mask=None,
                num_graphs: int = 1, deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        e = h.new_zeros((edge_index.shape[1], self.latent_dim))
        states = []
        for i in range(self.cfg.num_layers):
            h, e = getattr(self, f"layer_{i}")(h, e, edge_index, batch_idx, edge_mask,
                                               node_mask, num_graphs, deterministic, seeds)
            states.append(h)
        h_skip = self.skip_proj(torch.cat(states, dim=-1))
        return self.ln_out(h + h_skip).to(h.dtype)
