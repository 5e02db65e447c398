"""DPLM discrete-diffusion protein LM: the trunk and the unguided sampler.

Counterpart of `clip_dplm_tpu/models/dplm.py`: an ESM-2-style bidirectional
trunk (EsmBlock) with an f32 final LayerNorm and LM head over the 33-token
ESM alphabet, and the confidence-remasking sampler (start fully masked; each
step Gumbel-samples residues at masked positions, then re-masks the
lowest-confidence fraction given by a cosine schedule). The reference's
`lax.scan` is a Python loop here, and `jax.random` keys are a
`torch.Generator` on the model's device; the loop never waits on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from clip_dplm_tpu_torch.config import DPLMConfig
from clip_dplm_tpu_torch.models.esm import EsmBlock
from clip_dplm_tpu_torch.models.layers import Dense, Embed, LayerNorm

MASK_IDX = 32
PAD_IDX = 1
CLS_IDX = 0
EOS_IDX = 2
# first/last real residue ids in the ESM alphabet (data/protein.py): L..C
RESIDUE_LO, RESIDUE_HI = 4, 23


class DPLM(nn.Module):
    """Bidirectional denoising trunk + LM head over token ids. `dtype` is
    the trunk's compute dtype; the final LayerNorm and head run in f32."""

    def __init__(self, cfg: DPLMConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embed_tokens = Embed(cfg.vocab_size, cfg.d_model, device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EsmBlock(
                cfg.d_model, cfg.num_heads, ln_eps=cfg.layer_norm_eps,
                device=device))
        self.final_ln = LayerNorm(cfg.d_model, cfg.layer_norm_eps, device=device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    def forward(self, tokens: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, vocab), f32."""
        if mask is None:
            mask = tokens != PAD_IDX
        h = self.embed_tokens(tokens)
        h = torch.where(mask[..., None], h, 0.0).to(self.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h, mask, positions)
        return self.lm_head(self.final_ln(h))


def _cosine_keep_schedule(step: float, num_steps: int) -> float:
    """Fraction of positions still masked after `step` (cosine, MaskGIT)."""
    return math.cos(0.5 * math.pi * (step + 1.0) / num_steps)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def sample(
    model: DPLM,
    generator: torch.Generator,
    batch_size: int,
    length: int,
    num_steps: Optional[int] = None,
    temperature: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate (B, length+2) token sequences ([cls] residues [eos]).

    `lengths` (optional, (B,) int): per-row residue counts for mixed-length
    batches, clamped to [1, length]; row i generates lengths[i] residues with
    <eos> at lengths[i]+1 and <pad> beyond. `generator` lives on the model's
    device. Returns (tokens, per-position logprob of the final choice; -inf
    outside the generated region)."""
    cfg = model.cfg
    dev = model.device
    num_steps = num_steps or cfg.num_diffusion_steps
    S = length + 2
    pos = torch.arange(S, device=dev)[None, :]
    if lengths is None:
        lengths = torch.full((batch_size,), length, dtype=torch.int64, device=dev)
    else:
        lengths = torch.as_tensor(lengths, dtype=torch.int64).to(dev)
        if tuple(lengths.shape) != (batch_size,):
            raise ValueError(f"lengths must be shape ({batch_size},), "
                             f"got {tuple(lengths.shape)}")
        # lengths[i] > length would place <eos> past the last position
        lengths = lengths.clamp(1, length)
    eos_pos = (lengths + 1)[:, None]
    gen_region = (pos >= 1) & (pos < eos_pos)
    valid = pos <= eos_pos
    tokens = torch.where(
        pos == 0, CLS_IDX,
        torch.where(pos == eos_pos, EOS_IDX,
                    torch.where(gen_region, MASK_IDX, PAD_IDX)))
    confidence = torch.full((batch_size, S), -math.inf, device=dev)

    # only real residues are sampleable
    vocab_bias = torch.full((cfg.vocab_size,), -1e30, device=dev)
    vocab_bias[RESIDUE_LO:RESIDUE_HI + 1] = 0.0
    n_gen = gen_region.sum(dim=-1).float()

    for step in range(num_steps):
        logits = model(tokens, valid) + vocab_bias
        logp = torch.log_softmax(logits / max(temperature, 1e-6), dim=-1)
        # exact Gumbel-max draw from softmax(logits / t)
        proposal = torch.argmax(
            logp + _gumbel(logp.shape, generator, dev), dim=-1)
        prop_logp = torch.gather(
            torch.log_softmax(logits, dim=-1), -1, proposal[..., None])[..., 0]

        fill = (tokens == MASK_IDX) & gen_region
        new_tokens = torch.where(fill, proposal, tokens)
        new_conf = torch.where(fill, prop_logp, confidence)

        if step == num_steps - 1:  # the last step re-masks nothing
            tokens, confidence = new_tokens, new_conf
            break
        # re-mask the lowest-confidence fraction, with annealed Gumbel
        # tie-breaking on confidences (MaskGIT choice_temperature)
        keep_ratio = _cosine_keep_schedule(step, num_steps)
        n_remask = torch.floor(keep_ratio * n_gen).long()
        noise = _gumbel(new_conf.shape, generator, dev)
        noisy_conf = torch.where(gen_region, new_conf + 0.1 * keep_ratio * noise,
                                 math.inf)
        ranks = torch.argsort(torch.argsort(noisy_conf, dim=-1), dim=-1)
        remask = (ranks < n_remask[:, None]) & gen_region
        tokens = torch.where(remask, MASK_IDX, new_tokens)
        confidence = torch.where(remask, -math.inf, new_conf)
    return tokens, confidence
