"""Token-level transformer towers and the RNA<->RBP CLIP model.

Counterpart of `clip_dplm_tpu/models/token_towers.py`: transformer towers
(3 pre-LN blocks, 8 heads, 4x FFN by default) over variable-length per-token
embeddings (RNA motifs 120-d, RBP residues 1280-d) with (B, S) boolean masks,
CLS or masked-mean pooling, an `OptimizedProjectionHead` on each side into
the shared space, and a learned f32 logit scale. Under cls/first pooling the
last block keeps only row 0 after its attention core (`TransformerBlock.
out_rows`), which is exact: the FFN half and the final LayerNorm are
row-local. With `remat` (`precision.remat`) each block, the truncated last
one too, recomputes its forward in the backward (`layers.remat_call`), as
JAX's `nn.remat` on the block class. Parameter names follow the flax modules, so `utils/convert.py`
loads a flax tree key for key; `pos_embed` (1, max_len, d) and `cls_token`
(1, 1, d) copy as they are.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from clip_dplm_tpu_torch.config import Config, TransformerTowerConfig
from clip_dplm_tpu_torch.models.layers import (
    FLAX_LN_EPS,
    Dense,
    LayerNorm,
    OptimizedProjectionHead,
    TransformerBlock,
    remat_call,
)
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds

_LN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TokenTransformerTower(nn.Module):
    """(B, S, input_dim) token embeddings and a (B, S) validity mask ->
    pooled (B, d_model) f32."""

    def __init__(self, cfg: TransformerTowerConfig, dtype=torch.bfloat16, device=None,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if cfg.pooling not in ("cls", "first", "mean"):
            raise ValueError(f"unknown pooling {cfg.pooling!r}")
        if cfg.ln_dtype not in _LN_DTYPES:
            raise ValueError(f"unknown ln_dtype {cfg.ln_dtype!r}")
        self.cfg, self.dtype = cfg, dtype
        d = cfg.d_model
        self.input_proj = Dense(cfg.input_dim, d, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.max_len, d, dtype=torch.float32, device=device))
        if cfg.pooling == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=torch.float32,
                                                      device=device))
        pool_first = cfg.pooling in ("cls", "first")
        for i in range(cfg.num_layers):
            last = i == cfg.num_layers - 1
            self.add_module(f"block_{i}", TransformerBlock(
                d, cfg.num_heads, cfg.ffn_mult, cfg.dropout, dtype=dtype,
                ln_dtype=_LN_DTYPES[cfg.ln_dtype],
                out_rows=1 if (pool_first and last) else None, device=device))
        self.final_ln = LayerNorm(d, FLAX_LN_EPS, device=device)

    def reset_own_params(self, generator: torch.Generator) -> None:
        """normal(0.02) position table and CLS token, as the flax inits."""
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
            if self.cfg.pooling == "cls":
                self.cls_token.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        c = self.cfg
        B, S, _ = tokens.shape
        if S > c.max_len:
            raise ValueError(f"{S} tokens exceed max_len={c.max_len}")
        if mask is None:
            mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
        h = self.input_proj(tokens.to(self.dtype)) + self.pos_embed[:, :S].to(self.dtype)
        if c.pooling == "cls":
            h = torch.cat([self.cls_token.to(self.dtype).expand(B, 1, -1), h], dim=1)
            mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=mask.device), mask],
                             dim=1)
        for i in range(c.num_layers):
            block = getattr(self, f"block_{i}")
            if self.remat and torch.is_grad_enabled():
                h = remat_call(block, h, mask, deterministic, seeds)
            else:
                h = block(h, mask, deterministic, seeds)
        h = self.final_ln(h)
        if c.pooling in ("cls", "first"):
            return h[:, 0]
        w = mask[..., None].to(h.dtype)
        return (h * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)


class RNARBPCLIP(nn.Module):
    """Two token towers, an optimized projection head on each, and the
    learned logit scale (the reference's 71.6M-parameter configuration at
    the default widths). `dtype` is the compute dtype (bf16 by default, f32
    for tight parity checks)."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        remat = cfg.precision.remat
        self.rna_tower = TokenTransformerTower(cfg.rna_tower, dtype, device, remat)
        self.rbp_tower = TokenTransformerTower(cfg.rbp_tower, dtype, device, remat)
        self.rna_proj = OptimizedProjectionHead(cfg.projection, cfg.rna_tower.d_model, dtype,
                                                device)
        self.rbp_proj = OptimizedProjectionHead(cfg.projection, cfg.rbp_tower.d_model, dtype,
                                                device)
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
        """batch {"rna_tokens" (B, Sa, input_dim), "rna_mask" (B, Sa) bool,
        "rbp_tokens", "rbp_mask"} (masks optional) -> emb_a, emb_b (B, dim)
        f32 and logit_scale. With deterministic=False the dropout sites draw
        their seeds from `seeds`, in call order."""
        za = self.rna_proj(self.rna_tower(batch["rna_tokens"], batch.get("rna_mask"),
                                          deterministic, seeds), deterministic, seeds)
        zb = self.rbp_proj(self.rbp_tower(batch["rbp_tokens"], batch.get("rbp_mask"),
                                          deterministic, seeds), deterministic, seeds)
        return {"emb_a": za.float(), "emb_b": zb.float(), "logit_scale": self.logit_scale}
