"""RNA <-> protein CLIP with an ESM-2 tower trained end to end
(`experiment="esm_clip"`, BASELINE.json config 2).

Counterpart of `clip_dplm_tpu/models/protein_clip.py::ESMProteinCLIP`: the
RNA side is a `TokenTransformerTower` over per-token RNA embeddings, the
protein side an `ESMTower` over raw token ids with mean-residue pooling; an
`OptimizedProjectionHead` on each side projects into the shared space, and
a learned f32 logit scale. Parameter names are the flax module's
(`rna_tower`, `esm_tower`, `rna_proj`, `protein_proj`, `logit_scale`), so
`utils/convert.py` loads a flax tree key for key. With `esm.frozen` the
protein tower runs without a gradient (the reference's stop_gradient: its
output is detached) and train/state.py zeroes its subtree's update. With
`esm.lora_rank` > 0 the tower carries LoRA adapters (models/lora.py) and
runs with a gradient, which reaches only the adapters: the base weights are
detached at use, and train/state.py freezes the rest of the subtree.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.models.esm import ESMTower
from clip_dplm_tpu_torch.models.layers import OptimizedProjectionHead
from clip_dplm_tpu_torch.models.token_towers import TokenTransformerTower
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds


class ESMProteinCLIP(nn.Module):
    """RNA token tower <-> ESM-2 protein tower, projected to a shared space.
    `dtype` is the compute dtype (bf16 by default, f32 for tight parity
    checks)."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        remat = cfg.precision.remat
        self.rna_tower = TokenTransformerTower(cfg.rna_tower, dtype, device, remat)
        self.esm_tower = ESMTower(cfg.esm, dtype, device, remat)
        self.rna_proj = OptimizedProjectionHead(cfg.projection, cfg.rna_tower.d_model, dtype,
                                                device)
        self.protein_proj = OptimizedProjectionHead(cfg.projection, cfg.esm.d_model, dtype,
                                                    device)
        self.logit_scale = nn.Parameter(torch.tensor(
            float(cfg.contrastive.logit_scale_init), dtype=torch.float32, device=device))

    def reset_own_params(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.logit_scale.fill_(float(self.cfg.contrastive.logit_scale_init))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_protein(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       token_probs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) token ids (and optionally soft `token_probs`) -> the
        projected (B, dim) f32 protein embedding, deterministic: the protein
        side as a CLIP scorer reads it (models/guided_generation.py)."""
        pooled = self.esm_tower(tokens, mask, pooling="mean_residues", token_probs=token_probs)
        return self.protein_proj(pooled).float()

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> Dict[str, torch.Tensor]:
        """batch {"rna_tokens" (B, Sa, input_dim), "rna_mask" (B, Sa) bool,
        "protein_tokens" (B, Sb) int, "protein_mask" (B, Sb) bool} (masks
        optional) -> emb_a, emb_b (B, dim) f32 and logit_scale. With
        deterministic=False the dropout sites draw their seeds from `seeds`,
        in call order (the ESM tower has none)."""
        rna = self.rna_tower(batch["rna_tokens"], batch.get("rna_mask"), deterministic, seeds)
        # a frozen tower without adapters records nothing; with adapters the
        # gradient must reach them
        esm = self.cfg.esm
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and (not esm.frozen or esm.lora_rank > 0)):
            prot = self.esm_tower(batch["protein_tokens"], batch.get("protein_mask"),
                                  pooling="mean_residues")
        za = self.rna_proj(rna, deterministic, seeds)
        zb = self.protein_proj(prot, deterministic, seeds)
        return {"emb_a": za.float(), "emb_b": zb.float(), "logit_scale": self.logit_scale}
