"""Three-way TF CLIP: cell state <-> perturbation <-> protein.

Counterpart of `clip_dplm_tpu/models/tf_clip.py`: three encoders projected
into one space by `OptimizedProjectionHead`s, and a learned f32 logit scale;
the loss (train/trainer.py) sums the three pairs' symmetric InfoNCE.
- Cell tower: the batch of cells is ONE sequence, (1, B, d), under the
  degree mask `connectivity.sum(-1) > 0` (a cell without neighbours takes
  no attention); cell i's embedding is its own output token. From 256 cells
  on this is the flash kernel's shape, forward and backward.
- Perturbation tower: per-gene ESM projection plus value embedding over the
  top-DEG tokens (10 by default, the tiny-S kernel's shape), mean-pooled.
- Protein tower: the ESM vector as one token (S = 1: plain attention).
Each `_Encoder` is 3 pre-LN blocks of 8 heads, FFN 4x, dropout 0.1 (module
defaults, as in the reference), then a final f32 LayerNorm. Dense inputs are
bf16 (the compute dtype), head outputs f32. Parameter names follow the flax
modules, so `utils/convert.py` loads a flax tree key for key: `cell_in` is
Dense / LayerNorm / tanh-GELU / Dense with parameters under `layers_0`,
`layers_1` and `layers_3`, as flax's `nn.Sequential` names them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.models.layers import (
    FLAX_LN_EPS,
    Dense,
    LayerNorm,
    OptimizedProjectionHead,
    TransformerBlock,
)
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds


class _Encoder(nn.Module):
    """num_layers TransformerBlocks, then the final LayerNorm (f32 out)."""

    def __init__(self, d_model: int, num_layers: int = 3, num_heads: int = 8,
                 dropout: float = 0.1, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_model, num_heads, 4, dropout, dtype=dtype, device=device))
        self.final_ln = LayerNorm(d_model, FLAX_LN_EPS, device=device)

    def forward(self, x, mask=None, deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, mask, deterministic, seeds)
        return self.final_ln(x)


class _CellIn(nn.Module):
    """Dense -> LayerNorm (f32) -> tanh-GELU -> Dense, named as flax's
    nn.Sequential names its layers (the GELU at index 2 holds nothing)."""

    def __init__(self, in_dim: int, d: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.layers_0 = Dense(in_dim, d, device=device)
        self.layers_1 = LayerNorm(d, FLAX_LN_EPS, device=device)
        self.layers_3 = Dense(d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.layers_1(self.layers_0(x.to(self.dtype))), approximate="tanh")
        return self.layers_3(h.to(self.dtype))


class TFContrastiveModel(nn.Module):
    """cell <-> perturbation <-> protein three-tower CLIP (50.7M parameters
    at the default widths). `dtype` is the compute dtype (bf16 by default,
    f32 for tight parity checks)."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, enc = cfg.projection.dim, cfg.encoders
        self.cell_in = _CellIn(enc.gene_dim + 1, d, dtype, device)
        self.cell_encoder = _Encoder(d, dtype=dtype, device=device)
        self.esm_projection = Dense(enc.esm_dim, d, device=device)
        self.value_encoder = Dense(1, d, device=device)
        self.pert_encoder = _Encoder(d, dtype=dtype, device=device)
        self.protein_in = Dense(enc.esm_dim, d, device=device)
        self.protein_encoder = _Encoder(d, dtype=dtype, device=device)
        for name in ("cell", "pert", "protein"):
            self.add_module(f"{name}_projection",
                            OptimizedProjectionHead(cfg.projection, d, dtype, device))
        self.logit_scale = nn.Parameter(torch.tensor(
            float(cfg.contrastive.logit_scale_init), dtype=torch.float32, device=device))

    def reset_own_params(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.logit_scale.fill_(float(self.cfg.contrastive.logit_scale_init))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> Dict[str, torch.Tensor]:
        """batch {"cell_state" (B, gene_dim + 1), "connectivity" (B, B),
        "gene_esm" (B, T, esm_dim), "gene_values" (B, T), "protein_emb" (B,
        esm_dim)} -> cell_embed, pert_embed, protein_embed (B, dim) f32 and
        logit_scale. With deterministic=False the dropout sites draw their
        seeds from `seeds`, in call order."""
        dt = self.dtype
        cell_tokens = self.cell_in(batch["cell_state"])
        degree_mask = batch["connectivity"].sum(dim=-1) > 0
        cell_seq = self.cell_encoder(cell_tokens[None], degree_mask[None], deterministic,
                                     seeds)[0]
        tokens = (self.esm_projection(batch["gene_esm"].to(dt))
                  + self.value_encoder(batch["gene_values"][..., None].to(dt)))
        pert_pooled = self.pert_encoder(tokens, None, deterministic, seeds).mean(dim=1)
        prot_tok = self.protein_in(batch["protein_emb"].to(dt))
        prot_seq = self.protein_encoder(prot_tok[:, None, :], None, deterministic, seeds)[:, 0]
        return {
            "cell_embed": self.cell_projection(cell_seq, deterministic, seeds).float(),
            "pert_embed": self.pert_projection(pert_pooled, deterministic, seeds).float(),
            "protein_embed": self.protein_projection(prot_seq, deterministic, seeds).float(),
            "logit_scale": self.logit_scale,
        }
