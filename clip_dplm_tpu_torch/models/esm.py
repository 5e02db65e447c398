"""ESM-2-style protein transformer in PyTorch.

Counterpart of `clip_dplm_tpu/models/esm.py`: pre-LN blocks with rotary
q/k, exact-GELU FFN, a final LayerNorm, ESM's token-dropout rescaling,
mean-residue / cls pooling, and the soft token path (`token_probs`) that
soft CLIP guidance differentiates through. Parameters keep the flax names
(`embed_tokens`, `layer_<i>/{ln_attn,q,k,v,out,ln_ffn,ffn_in,ffn_out}`,
`final_ln`), so `utils/convert.py` maps a flax tree onto the `state_dict`.
The trunk is always unrolled; a stacked (`scan_layers`) flax tree is
unstacked on conversion. With `cfg.lora_rank` the blocks carry LoRA adapters
(models/lora.py) beside the unchanged base tree. With `remat` each block
recomputes its forward in the backward (`layers.remat_call`), as JAX's
`nn.remat`. `convert_esm_torch_params` / `export_esm_torch_params` map an HF
`EsmModel` state_dict (ESM-2's published layout) onto the port's and back.

Attention dispatch follows the reference by shape: the packed-qkv kernel with
in-kernel RoPE for 64 <= S < 256, the flash kernel for S >= 256, plain
attention below 64 (ops/attention.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.config import ESMConfig
from clip_dplm_tpu_torch.models.layers import Dense, Embed, LayerNorm, numpy_f32, remat_call
from clip_dplm_tpu_torch.models.lora import LoRAPair, LoRASpec, is_lora_path, spec_from
from clip_dplm_tpu_torch.ops.attention import (
    attention_dispatch,
    merge_heads,
    packed_qkv_attention_proj,
    short_attn_packed_ok,
    split_heads,
)
from clip_dplm_tpu_torch.ops.short_attention import _rope_cos_sin, _rope_rot

# fraction of tokens masked during ESM-2 pretraining (0.15 * 0.8); used by
# the token-dropout rescaling at inference
_MASK_RATIO_TRAIN = 0.15 * 0.8

ESM2_SIZES = {
    "esm2_t6_8M": dict(num_layers=6, d_model=320, num_heads=20),
    "esm2_t12_35M": dict(num_layers=12, d_model=480, num_heads=20),
    "esm2_t30_150M": dict(num_layers=30, d_model=640, num_heads=20),
    "esm2_t33_650M": dict(num_layers=33, d_model=1280, num_heads=20),
    "esm2_t36_3B": dict(num_layers=36, d_model=2560, num_heads=40),
    "esm2_t48_15B": dict(num_layers=48, d_model=5120, num_heads=40),
}


def rotary_embed(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the head dim of (B, H, S, Dh), ESM-2
    convention (rotate-half pairing), f32 math, cast back to x's dtype."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1])
    return _rope_rot(x, cos, sin).to(x.dtype)


def rotary_embed_bsd(x: torch.Tensor, positions: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """rotary_embed in the head-major (B, S, D) layout, D = H * Dh."""
    B, S, D = x.shape
    Dh = D // num_heads
    cos, sin = _rope_cos_sin(positions, Dh)
    xh = x.reshape(B, S, num_heads, Dh)
    out = _rope_rot(xh, cos[:, None, :], sin[:, None, :])
    return out.reshape(B, S, D).to(x.dtype)


class EsmBlock(nn.Module):
    """Pre-LN transformer block with rotary q/k (ESM-2 layer semantics).

    `lora` (models/lora.py::LoRASpec, None disables) adds a `<site>_lora`
    pair beside each target; the base parameter tree is unchanged. With
    adapters the base weights are detached at use, the q, k
    and v deltas are added into the packed qkv slices (the separate route:
    to q, k and v), the `out` adapter is merged into the projection weight
    in f32 on both routes (its gradient reaches a and b through the packed
    kernel's dWo), and the FFN's deltas are added in activation space."""

    def __init__(self, d_model: int, num_heads: int, ffn_mult: int = 4,
                 ln_eps: float = 1e-5, device=None, lora: Optional[LoRASpec] = None):
        super().__init__()
        self.d_model, self.num_heads, self.lora = d_model, num_heads, lora
        D, F_ = d_model, ffn_mult * d_model
        self.ln_attn = LayerNorm(D, ln_eps, device=device)
        self.q = Dense(D, D, device=device)
        self.k = Dense(D, D, device=device)
        self.v = Dense(D, D, device=device)
        self.out = Dense(D, D, device=device)
        self.ln_ffn = LayerNorm(D, ln_eps, device=device)
        self.ffn_in = Dense(D, F_, device=device)
        self.ffn_out = Dense(F_, D, device=device)
        shapes = {"q": (D, D), "k": (D, D), "v": (D, D), "out": (D, D), "ffn_in": (D, F_),
                  "ffn_out": (F_, D)}
        for site in (lora.targets if lora is not None else ()):
            self.add_module(f"{site}_lora", LoRAPair(*shapes[site], lora.rank, lora.alpha,
                                                     device=device))

    def _site(self, name: str):
        """(kernel, bias) of a dense site, detached when the block carries
        adapters (the base is frozen)."""
        dense = getattr(self, name)
        if self.lora is not None:
            return dense.kernel.detach(), dense.bias.detach()
        return dense.kernel, dense.bias

    def _delta(self, site: str, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The site's adapter delta of x, or None without one."""
        if self.lora is None or site not in self.lora.targets:
            return None
        return getattr(self, f"{site}_lora")(x)

    def _linear(self, site: str, x: torch.Tensor) -> torch.Tensor:
        """x through a dense site, in x's dtype, plus its adapter delta."""
        w, b = self._site(site)
        y = F.linear(x, w.to(x.dtype), b.to(x.dtype))
        d = self._delta(site, x)
        return y if d is None else y + d

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) in the compute dtype; mask (B, S) bool."""
        dtype = x.dtype
        H, D = self.num_heads, self.d_model
        h = self.ln_attn(x).to(dtype)
        B, S, _ = h.shape
        wo, bo = self._site("out")
        if self.lora is not None and "out" in self.lora.targets:
            wo = wo + self.out_lora.weight().t()
        if short_attn_packed_ok((B, S, 3 * D), H, mask):
            # one qkv matmul, the q/k/v deltas added into its slices; RoPE,
            # attention and the out-projection in the packed kernel
            (wq, bq), (wk, bk), (wv, bv) = (self._site(n) for n in ("q", "k", "v"))
            qkv = F.linear(h, torch.cat([wq, wk, wv], 0).to(dtype),
                           torch.cat([bq, bk, bv]).to(dtype))
            deltas = [self._delta(t, h) for t in ("q", "k", "v")]
            if any(d is not None for d in deltas):
                parts = qkv.split(D, dim=-1)
                qkv = torch.cat([p if d is None else p + d for p, d in zip(parts, deltas)], -1)
            attn = packed_qkv_attention_proj(qkv, wo, bo, H, mask=mask, rope_positions=positions)
        else:
            qh = rotary_embed(split_heads(self._linear("q", h), H), positions)
            kh = rotary_embed(split_heads(self._linear("k", h), H), positions)
            vh = split_heads(self._linear("v", h), H)
            attn = F.linear(merge_heads(attention_dispatch(qh, kh, vh, mask=mask)),
                            wo.to(dtype), bo.to(dtype))
        x = x + attn
        h = self.ln_ffn(x).to(dtype)
        return x + self._linear("ffn_out", F.gelu(self._linear("ffn_in", h)))


def stack_esm_layers(params: Dict, num_layers: int) -> Dict:
    """Unrolled flax tree (layer_<i>/...) -> the scan_layers layout
    (layers/block/... stacked on axis 0), over nested dicts of arrays."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([np.asarray(t) for t in trees])

    rest = {k: v for k, v in params.items() if not k.startswith("layer_")}
    rest["layers"] = {"block": stack([params[f"layer_{i}"]
                                      for i in range(num_layers)])}
    return rest


def unstack_esm_layers(params: Dict, num_layers: int) -> Dict:
    """Inverse of `stack_esm_layers`."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    stacked = params["layers"]["block"]
    rest = {k: v for k, v in params.items() if k != "layers"}
    for i in range(num_layers):
        rest[f"layer_{i}"] = take(stacked, i)
    return rest


class ESMTower(nn.Module):
    """ESM-2 encoder over token ids (B, S) with a (B, S) validity mask.

    Token ids follow the ESM alphabet (data/protein.py): 0=<cls>, 1=<pad>,
    2=<eos>, 32=<mask>. `dtype` is the compute dtype of the trunk."""

    MASK_IDX = 32
    CLS_IDX = 0
    EOS_IDX = 2
    PAD_IDX = 1

    def __init__(self, cfg: ESMConfig, dtype: torch.dtype = torch.bfloat16,
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

    @property
    def blocks(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    def embed(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
              token_probs: Optional[torch.Tensor] = None):
        """Token embedding (hard, or soft from `token_probs`), token-dropout
        rescaling and pad zeroing. Returns (h, mask, positions)."""
        c = self.cfg
        B, S = tokens.shape
        if mask is None:
            mask = tokens != self.PAD_IDX
        table = self.embed_tokens.embedding
        if token_probs is None:
            emb = self.embed_tokens(tokens).float()
        else:
            emb = token_probs.float() @ table.float()
        if c.token_dropout:
            if token_probs is None:
                p_mask = (tokens == self.MASK_IDX).float()
                emb = torch.where((tokens == self.MASK_IDX)[..., None], 0.0, emb)
            else:
                # the expected <mask> row taken out: zeroing in the one-hot
                # limit, smooth in between
                p_mask = token_probs[..., self.MASK_IDX].float()
                emb = emb - p_mask[..., None] * table[self.MASK_IDX].float()
            n_real = mask.sum(dim=-1, keepdim=True).clamp(min=1)
            ratio = (p_mask * mask).sum(dim=-1, keepdim=True) / n_real
            scale = (1.0 - _MASK_RATIO_TRAIN) / (1.0 - ratio).clamp(min=1e-6)
            emb = emb * scale[..., None]
        emb = torch.where(mask[..., None], emb, 0.0)
        positions = torch.arange(S, device=tokens.device)
        return emb.to(self.dtype), mask, positions

    def head(self, h: torch.Tensor, tokens: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             pooling: str = "tokens") -> torch.Tensor:
        """Final LayerNorm (f32) + pooling."""
        if mask is None:
            mask = tokens != self.PAD_IDX
        h = self.final_ln(h)
        if pooling == "tokens":
            return h
        if pooling == "mean_residues":
            residue = mask & (tokens != self.CLS_IDX) & (tokens != self.EOS_IDX)
            w = residue[..., None].to(h.dtype)
            return (h * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
        if pooling == "cls":
            return h[:, 0]
        raise ValueError(f"unknown pooling {pooling!r}")

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pooling: str = "tokens",
                token_probs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`token_probs` (B, S, vocab): soft token distributions; the lookup
        becomes probs @ table, differentiable in probs (the relaxation behind
        soft CLIP guidance of the DPLM sampler), equal to the hard path at
        one-hot(tokens). `tokens` still gives the special-token positions for
        the mask and the pooling."""
        h, mask, positions = self.embed(tokens, mask, token_probs)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h = remat_call(block, h, mask, positions)
            else:
                h = block(h, mask, positions)
        return self.head(h, tokens, mask, pooling)


def esm_config_from_name(name: str, **overrides) -> ESMConfig:
    geom = ESM2_SIZES[name]
    return ESMConfig(name=name, **{**geom, **overrides})


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

# the port's per-block names -> HF `EsmModel` names under encoder.layer.<i>
_HF_ESM_BLOCK = {
    "ln_attn": "attention.LayerNorm", "q": "attention.self.query",
    "k": "attention.self.key", "v": "attention.self.value",
    "out": "attention.output.dense", "ln_ffn": "LayerNorm",
    "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
}
# leaf names: the port's Dense / LayerNorm -> torch Linear / LayerNorm
_HF_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}



def _esm_hf_names(cfg: ESMConfig) -> Dict[str, str]:
    """The port's ESMTower state_dict names -> HF `EsmModel` names, in the
    order the exporters write them."""
    names = {"embed_tokens.embedding": "embeddings.word_embeddings.weight",
             "final_ln.scale": "encoder.emb_layer_norm_after.weight",
             "final_ln.bias": "encoder.emb_layer_norm_after.bias"}
    for i in range(cfg.num_layers):
        for site, hf in _HF_ESM_BLOCK.items():
            for leaf in ("scale", "bias") if site.startswith("ln") else ("kernel", "bias"):
                names[f"layer_{i}.{site}.{leaf}"] = f"encoder.layer.{i}.{hf}.{_HF_LEAF[leaf]}"
    return names


def convert_esm_torch_params(state_dict, cfg: ESMConfig) -> Dict[str, torch.Tensor]:
    """An HF `EsmModel` state_dict (the rotary ESM-2 layout; torch tensors or
    numpy arrays) -> the `state_dict` of the port's ESMTower, f32 on the
    CPU. torch's Linear weight is (out, in), as the port's Dense kernel, so
    nothing is transposed. A DPLM takes it through `init_dplm_from_esm`."""
    return {k: torch.from_numpy(numpy_f32(state_dict[v])) for k, v in _esm_hf_names(cfg).items()}


def export_esm_torch_params(params, cfg: ESMConfig) -> Dict[str, np.ndarray]:
    """Inverse of `convert_esm_torch_params`: an ESMTower (or its
    state_dict) -> an HF `EsmModel` state_dict, numpy f32 in HF's key
    layout (load it with `strict=False`: HF also holds rotary buffers and a
    contact head), equal to the JAX package's `export_esm_torch_params` of
    the same weights. Unmerged LoRA adapters raise: fold them with
    models/lora.py::merge_lora first."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    if any(is_lora_path(k) for k in sd):
        raise ValueError("param tree still carries LoRA adapters: fold them with "
                         "models/lora.py::merge_lora before exporting")
    return {hf: numpy_f32(sd[name]) for name, hf in _esm_hf_names(cfg).items()}
