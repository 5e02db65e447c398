"""DPLM discrete-diffusion protein LM: the trunk, its training loss, the
warm start from ESM-2, the sampler and best-of-K CLIP-guided sampling.

Counterpart of `clip_dplm_tpu/models/dplm.py`: an ESM-2-style bidirectional
trunk (EsmBlock) with an f32 final LayerNorm and LM head over the 33-token
ESM alphabet; the absorbing-state diffusion loss (`corrupt` masks a t-
fraction of each row's residues, t ~ U(0.05, 1); `diffusion_loss` is the
1/t-weighted CE on the masked positions); `init_dplm_from_esm`; and the
confidence-remasking sampler (start fully masked; each step Gumbel-samples
residues at masked positions, then re-masks the lowest-confidence fraction
given by a cosine schedule; an optional logit bias steers each step), and
`clip_guided_sample`. The reference's `lax.scan` is a Python loop
here, and `jax.random` keys are a `torch.Generator` on the model's device;
the loop never waits on the host. The corruption's t and u cannot be
JAX's PRNG draws: they come from the dropout's counter hash
(ops/fused_dense.py::dropout_bits) keyed by the step's `DropoutSeeds`, so
the draw is a function of (state key, step), equal bit for bit on the CPU
and the card, and made on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clip_dplm_tpu_torch.config import DPLMConfig
from clip_dplm_tpu_torch.models.esm import EsmBlock
from clip_dplm_tpu_torch.models.layers import Dense, Embed, LayerNorm, remat_call
from clip_dplm_tpu_torch.models.lora import spec_from
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds, dropout_bits

MASK_IDX = 32
PAD_IDX = 1
CLS_IDX = 0
EOS_IDX = 2
# first/last real residue ids in the ESM alphabet (data/protein.py): L..C
RESIDUE_LO, RESIDUE_HI = 4, 23


class DPLM(nn.Module):
    """Bidirectional denoising trunk + LM head over token ids. `dtype` is
    the trunk's compute dtype; the final LayerNorm and head run in f32. With
    `cfg.lora_rank` the blocks carry LoRA adapters (models/lora.py)."""

    def __init__(self, cfg: DPLMConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None, remat: bool = False):
        super().__init__()
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        self.embed_tokens = Embed(cfg.vocab_size, cfg.d_model, device=device)
        lora = spec_from(cfg)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EsmBlock(
                cfg.d_model, cfg.num_heads, ln_eps=cfg.layer_norm_eps,
                device=device, lora=lora))
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
            block = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                h = remat_call(block, h, mask, positions)
            else:
                h = block(h, mask, positions)
        return self.lm_head(self.final_ln(h))


# ---------------------------------------------------------------------------
# training: absorbing-state diffusion loss
# ---------------------------------------------------------------------------

T_MIN = 0.05  # t ~ U(T_MIN, 1): no t = 0 (nothing to learn), 1/t bounded
_BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 hash values -> f32 in [0, 1), from their top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def corrupt(seeds: DropoutSeeds, tokens: torch.Tensor, valid: torch.Tensor):
    """Mask a t-fraction of the valid residue positions with <mask>: (x_t,
    corrupted (B, S) bool, t (B,) f32). t ~ U(0.05, 1) per row and u ~ U(0,
    1) per position come from the next two seeds of `seeds` through the
    counter hash of (seed, row, col), on the tokens' device; a position is
    corrupted where u < t. Special tokens (cls/eos/pad) never are."""
    B, S = tokens.shape
    t = T_MIN + (1.0 - T_MIN) * _uniform(dropout_bits(seeds.next(), B, 1, tokens.device)[:, 0])
    t = t.clamp(max=_BELOW_ONE)
    u = _uniform(dropout_bits(seeds.next(), B, S, tokens.device))
    corruptible = valid & (tokens != CLS_IDX) & (tokens != EOS_IDX)
    corrupted = corruptible & (u < t[:, None])
    return torch.where(corrupted, MASK_IDX, tokens), corrupted, t


def diffusion_loss_from_draw(model: nn.Module, tokens: torch.Tensor, valid: torch.Tensor,
                             x_t: torch.Tensor, corrupted: torch.Tensor,
                             t: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The RDM-weighted masked-token CE of one corruption: mean over rows of
    (Σ CE over the corrupted positions) / max(#corrupted, 1) / t, with the
    denoising accuracy over all corrupted positions and the mean t."""
    logits = model(x_t, valid)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_logp = torch.gather(logp, -1, tokens[..., None].long())[..., 0]
    per_seq = torch.where(corrupted, -tok_logp, 0.0).sum(dim=-1)
    n_corrupted = corrupted.sum(dim=-1).clamp(min=1)
    loss = (per_seq / n_corrupted / t).mean()
    hit = corrupted & (logits.argmax(dim=-1) == tokens)
    acc = hit.sum().float() / corrupted.sum().clamp(min=1).float()
    return loss, {"denoise_accuracy": acc, "mean_t": t.mean()}


def diffusion_loss(model: nn.Module, tokens: torch.Tensor, seeds: DropoutSeeds,
                   valid: Optional[torch.Tensor] = None):
    """E_t[(1/t) · CE(masked positions)] of one draw from `seeds`."""
    if valid is None:
        valid = tokens != PAD_IDX
    x_t, corrupted, t = corrupt(seeds, tokens, valid)
    return diffusion_loss_from_draw(model, tokens, valid, x_t, corrupted, t)


@torch.no_grad()
def init_dplm_from_esm(esm: nn.Module, dplm: DPLM, tie_lm_head: bool = True) -> DPLM:
    """Warm-start the DPLM trunk from an ESMTower, in place: the token
    embedding, the layers both have and the final LayerNorm take the ESM
    weights. With tie_lm_head the LM head is tied to the token embedding:
    its (out, in) kernel is the (vocab, d) embedding itself, its bias zero;
    otherwise it keeps its weights."""
    own = dplm.state_dict()
    for name, value in esm.state_dict().items():
        if name in own:
            if own[name].shape != value.shape:
                raise ValueError(f"{name}: ESM {tuple(value.shape)} vs DPLM "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(value)
    if tie_lm_head:
        dplm.lm_head.kernel.copy_(dplm.embed_tokens.embedding)
        dplm.lm_head.bias.zero_()
    return dplm


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
    logit_bias_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate (B, length+2) token sequences ([cls] residues [eos]).

    `logit_bias_fn(tokens, logits) -> bias` steers each step: the bias
    (broadcastable to the (B, S, vocab) logits) is added after the residue
    mask, before the proposal draw (soft CLIP guidance). The sampler runs
    without a gradient; a bias that needs one enables it itself
    (models/guided_generation.py). `lengths` (optional, (B,) int): per-row
    residue counts for mixed-length batches, clamped to [1, length]; row i
    generates lengths[i] residues with <eos> at lengths[i]+1 and <pad>
    beyond. `generator` lives on the model's device. Returns (tokens,
    per-position logprob of the final choice; -inf outside the generated
    region)."""
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
        if logit_bias_fn is not None:
            logits = logits + logit_bias_fn(tokens, logits)
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


def clip_guided_sample(
    model: DPLM,
    generator: torch.Generator,
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    batch_size: int,
    length: int,
    num_candidates: Optional[int] = None,
    num_steps: Optional[int] = None,
    temperature: float = 1.0,
    logit_bias_fn: Optional[Callable] = None,
    lengths: Optional[torch.Tensor] = None,
    flatten_chains: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-of-K CLIP-guided sampling: K independent denoising chains, and
    per output row the candidate maximizing `score_fn`. Returns (tokens (B,
    length+2), scores (B,)).

    `score_fn` takes the (K, B, S) candidates and returns (K, B) scores, the
    reference's score_fn vmapped over the candidates (models/
    guided_generation.py's scorers take any leading axes, so per-row
    conditioning (B, d) works unchanged). `flatten_chains=True` runs the K
    chains as one chain of K*B rows (every random draw of `sample` is per
    row, so the two forms agree in distribution, not bit for bit);
    `logit_bias_fn` then sees the (K, B, S) and (K, B, S, vocab) views of
    the flattened chain and its bias is broadcast back; otherwise the K
    chains of B rows run one after another, each with the (B, ...)
    contract."""
    K = num_candidates or model.cfg.num_candidates
    B = batch_size
    if flatten_chains:
        bias_f = None
        if logit_bias_fn is not None:
            def bias_f(tokens, logits):
                S, V = logits.shape[-2:]
                bias = logit_bias_fn(tokens.reshape(K, B, S), logits.reshape(K, B, S, V))
                return torch.broadcast_to(bias, (K, B, S, V)).reshape(K * B, S, V)
        lengths_f = None if lengths is None else torch.as_tensor(lengths).repeat(K)
        toks, _ = sample(model, generator, K * B, length, num_steps=num_steps,
                         temperature=temperature, logit_bias_fn=bias_f, lengths=lengths_f)
        candidates = toks.reshape(K, B, -1)
    else:
        candidates = torch.stack([
            sample(model, generator, B, length, num_steps=num_steps, temperature=temperature,
                   logit_bias_fn=logit_bias_fn, lengths=lengths)[0] for _ in range(K)])
    with torch.no_grad():
        scores = score_fn(candidates)
    best = scores.argmax(dim=0)
    rows = torch.arange(B, device=best.device)
    return candidates[best, rows], scores[best, rows]
