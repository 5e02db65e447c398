"""Two-tower CLIP over precomputed embedding vectors.

Counterpart of `clip_dplm_tpu/models/clip.py::TwoTowerCLIP`: tower ->
projection head on each side, and a learned scalar logit scale (log(1/0.07)
at init). `forward` returns the unnormalized projections in f32; the loss
normalizes them. `dtype` is the compute dtype (bf16 by default; f32 for
tight parity checks), the flax module's `dtype` field.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.models.layers import make_projection, make_tower
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.ops.infonce import l2_normalize


class TwoTowerCLIP(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.tower_a = make_tower(cfg.tower_a, dtype, device)
        self.tower_b = make_tower(cfg.tower_b, dtype, device)
        self.proj_a = make_projection(cfg.projection, cfg.tower_a.hidden_size, dtype, device)
        self.proj_b = make_projection(cfg.projection, cfg.tower_b.hidden_size, dtype, device)
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
        """batch {"a": (B, input_dim_a), "b": (B, input_dim_b)} -> emb_a,
        emb_b (B, dim) f32 and logit_scale. With deterministic=False the
        dropout sites draw their seeds from `seeds`."""
        za = self.proj_a(self.tower_a(batch["a"], deterministic, seeds), deterministic, seeds)
        zb = self.proj_b(self.tower_b(batch["b"], deterministic, seeds), deterministic, seeds)
        return {"emb_a": za.float(), "emb_b": zb.float(), "logit_scale": self.logit_scale}

    def encode_a(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.proj_a(self.tower_a(x)))

    def encode_b(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.proj_b(self.tower_b(x)))
