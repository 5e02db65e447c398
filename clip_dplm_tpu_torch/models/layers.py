"""Parameter-holding layers that keep the flax scope and param names, the
two-tower model's encoder towers and projection heads, and the token
towers' `TransformerBlock`.

`Dense` (the counterpart of `clip_dplm_tpu/models/layers.py::_DenseParams`
and `nn.Dense`), `LayerNorm` and `Embed` name their parameters `kernel` /
`bias`, `scale` / `bias` and `embedding`, so a flax param tree maps onto a
`state_dict` key for key (utils/convert.py). Dense kernels are stored (out,
in), the transpose of flax's (in, out).

Dtype policy (the JAX package's): parameters are f32; a Dense computes in its
input's dtype (bf16 in the trunk, f32 for the DPLM head); LayerNorm computes
and returns f32.

Towers and heads (`MLPTower`, `ResNetTower`, `VectorTransformerTower`,
`LinearProjection`, `ProjectionHead`, `OptimizedProjectionHead`;
counterparts in `clip_dplm_tpu/models/layers.py`) declare the same parameter
tree on the fused and the unfused path. With `fused_dense` a Dense+LN(+act+dropout)
block goes through `ops/fused_dense.py` (its CUDA kernels on the card, its
plain version on the CPU); without it the block is Dense / LayerNorm (eps
1e-6) / act / dropout. Both paths draw dropout masks from the same hash of
(seed, row, column), one seed per site from `DropoutSeeds` in call order.

`TransformerBlock` (counterpart of `clip_dplm_tpu/models/layers.py::
TransformerBlock`) routes its attention through `ops/attention.py`: the
CLS-query kernel when only row 0 is kept (`out_rows == 1`), else the packed
short-S kernel with the out-projection for 64 <= S < 256, the packed tiny-S
kernel with the out-projection for 2 <= S < 64, and `multihead_attention`
otherwise (the flash kernel from 256 keys on, the plain formulation for
S = 1).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from clip_dplm_tpu_torch.ops.fused_dense import (
    DropoutSeeds,
    fused_dense_norm_act,
    hash_dropout,
)
from clip_dplm_tpu_torch.ops.infonce import at_least_f32, l2_normalize

FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm's default, the towers' and heads' LNs


class Dense(nn.Module):
    """`init` picks the kernel's initializer: "lecun" (flax nn.Dense's
    default family) or "xavier" (xavier-uniform). `use_bias=False` leaves
    the bias out (flax's `use_bias=False`: T5's projections)."""

    def __init__(self, in_features: int, features: int, device=None,
                 init: str = "lecun", use_bias: bool = True):
        super().__init__()
        if init not in ("lecun", "xavier"):
            raise ValueError(f"unknown init {init!r}")
        self.init = init
        self.kernel = nn.Parameter(
            torch.empty(features, in_features, dtype=torch.float32, device=device))
        if use_bias:
            self.bias = nn.Parameter(
                torch.zeros(features, dtype=torch.float32, device=device))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal (std 1/sqrt(fan_in)) or xavier-uniform kernel, zero
        bias."""
        with torch.no_grad():
            fan_out, fan_in = self.kernel.shape
            if self.init == "xavier":
                a = math.sqrt(6.0 / (fan_in + fan_out))
                self.kernel.uniform_(-a, a, generator=generator)
            else:
                self.kernel.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.kernel.to(x.dtype), bias)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """In f32 (f64 for an f64 input, as the f64 reference runs of the
        f32 families take it)."""
        x = at_least_f32(x)
        return F.layer_norm(x, (x.shape[-1],), self.scale.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal with std 1/sqrt(features), as flax's default embed init."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(self.embedding.shape[1]),
                                   generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding)


def numpy_f32(t) -> np.ndarray:
    """A torch tensor (any device or dtype) or array-like as numpy f32: the
    HF converters' and the bundles' leaf format."""
    if torch.is_tensor(t):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights for every layer of `module`, drawn from `generator`
    (which lives on the module's device); modules with parameters of their
    own (a layer scale, a logit scale, a position table) reset them in
    `reset_own_params(generator)`."""
    for m in module.modules():
        if isinstance(m, (Dense, LayerNorm, Embed)):
            m.reset_parameters(generator)
        elif hasattr(m, "reset_own_params"):
            m.reset_own_params(generator)


# ---------------------------------------------------------------------------
# encoder towers and projection heads of the two-tower model
# ---------------------------------------------------------------------------

_ACTS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's default gelu
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def _activation(name: str):
    if name not in _ACTS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTS[name]


def _dropout(h: torch.Tensor, rate: float, deterministic: bool,
             seeds: Optional[DropoutSeeds]) -> torch.Tensor:
    """The unfused modules' dropout: the fused kernel's hash mask over the
    rows of h flattened to (rows, last dim), in h's dtype."""
    if deterministic or rate <= 0.0:
        return h
    return hash_dropout(h.reshape(-1, h.shape[-1]), _seed(seeds), rate).reshape(h.shape)


def remat_call(fn, *args):
    """fn(*args) with its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant): JAX's `nn.remat` on a block.
    A `DropoutSeeds` among the args draws its seeds in call order on the
    host, so the first forward and the recompute each run on a copy of it
    at the count the block starts from (the same masks both times), and
    the caller's seeds then stand where the block left them. Nothing in a
    block draws from torch's generators, so their states are not saved."""
    starts = [(i, a.count) for i, a in enumerate(args) if isinstance(a, DropoutSeeds)]
    ends = {}

    def run(*a):
        a = list(a)
        for i, count in starts:
            a[i] = DropoutSeeds(a[i].key, a[i].step)
            a[i].count = count
        out = fn(*a)
        ends.update((i, a[i].count) for i, _ in starts)
        return out

    out = torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                            preserve_rng_state=False)
    for i, _ in starts:
        args[i].count = ends[i]
    return out


def _seed(seeds: Optional[DropoutSeeds]) -> int:
    if seeds is None:
        raise ValueError("dropout with deterministic=False needs DropoutSeeds")
    return seeds.next()


def _fused_block(x, dense: Dense, ln: LayerNorm, *, order, act, rate, deterministic,
                 seeds, out_dtype, dtype, skip=None, layer_scale=None, l2=False):
    seed = _seed(seeds) if rate > 0.0 and not deterministic else None
    return fused_dense_norm_act(
        x, dense.kernel, dense.bias, ln.scale, ln.bias, order=order, act=act,
        dropout_rate=rate, dropout_seed=seed, deterministic=deterministic,
        out_dtype=out_dtype, compute_dtype=dtype, skip=skip, layer_scale=layer_scale,
        l2_normalize_out=l2)


class MLPTower(nn.Module):
    """num_hidden_layers Dense+act layers, then a LayerNorm; with fused_dense
    the last Dense+act+LN is one fused block (order act_ln)."""

    def __init__(self, cfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.hidden_size
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"dense_{i}", Dense(cfg.input_dim if i == 0 else d, d,
                                                device=device))
        self.LayerNorm_0 = LayerNorm(d, FLAX_LN_EPS, device=device)

    def forward(self, x, deterministic: bool = True, seeds=None) -> torch.Tensor:
        act = _activation(self.cfg.activation)
        n = self.cfg.num_hidden_layers
        h = x.to(self.dtype)
        for i in range(n - 1 if self.cfg.fused_dense else n):
            h = act(getattr(self, f"dense_{i}")(h))
        if self.cfg.fused_dense:
            return _fused_block(h, getattr(self, f"dense_{n - 1}"), self.LayerNorm_0,
                                order="act_ln", act=self.cfg.activation, rate=0.0,
                                deterministic=deterministic, seeds=seeds,
                                out_dtype=torch.float32, dtype=self.dtype)
        return self.LayerNorm_0(h)


class ResNetTower(nn.Module):
    """Residual MLP tower: in_proj, then pre-LN blocks h + fc2(act(fc1(LN(h)))),
    then a LayerNorm. Plain ops only."""

    def __init__(self, cfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.hidden_size
        self.in_proj = Dense(cfg.input_dim, d, device=device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"ln_{i}", LayerNorm(d, FLAX_LN_EPS, device=device))
            self.add_module(f"fc1_{i}", Dense(d, d, device=device))
            self.add_module(f"fc2_{i}", Dense(d, d, device=device))
        self.LayerNorm_0 = LayerNorm(d, FLAX_LN_EPS, device=device)

    def forward(self, x, deterministic: bool = True, seeds=None) -> torch.Tensor:
        act = _activation(self.cfg.activation)
        h = self.in_proj(x.to(self.dtype))
        for i in range(self.cfg.num_hidden_layers):
            r = getattr(self, f"ln_{i}")(h).to(self.dtype)
            r = getattr(self, f"fc2_{i}")(act(getattr(self, f"fc1_{i}")(r)))
            h = h + r
        return self.LayerNorm_0(h)


def make_tower(cfg, dtype=torch.bfloat16, device=None) -> nn.Module:
    if cfg.architecture == "mlp":
        return MLPTower(cfg, dtype, device)
    if cfg.architecture == "resnet":
        return ResNetTower(cfg, dtype, device)
    if cfg.architecture == "transformer":
        return VectorTransformerTower(cfg, dtype, device)
    raise ValueError(f"unknown tower architecture {cfg.architecture!r}")


class LinearProjection(nn.Module):
    """One Dense into the shared space."""

    def __init__(self, cfg, in_dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.Dense_0 = Dense(in_dim, cfg.dim, device=device)

    def forward(self, x, deterministic: bool = True, seeds=None) -> torch.Tensor:
        out = self.Dense_0(x.to(self.dtype))
        return l2_normalize(out) if self.cfg.l2_normalize_output else out


class ProjectionHead(nn.Module):
    """Linear -> LN -> act -> dropout -> Linear -> LN; the two blocks are
    fused (ln_act gelu with dropout, then ln_act none) when fused_dense and
    act == "gelu" (the fused kernel's gelu is the tanh approximation)."""

    def __init__(self, cfg, in_dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.fc1 = Dense(in_dim, cfg.dim, device=device)
        self.ln1 = LayerNorm(cfg.dim, FLAX_LN_EPS, device=device)
        self.fc2 = Dense(cfg.dim, cfg.dim, device=device)
        self.ln2 = LayerNorm(cfg.dim, FLAX_LN_EPS, device=device)

    def forward(self, x, deterministic: bool = True, seeds=None) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        if c.fused_dense and c.act == "gelu":
            h = _fused_block(x.to(dt), self.fc1, self.ln1, order="ln_act", act="gelu",
                             rate=c.dropout, deterministic=deterministic, seeds=seeds,
                             out_dtype=dt, dtype=dt)
            h = _fused_block(h, self.fc2, self.ln2, order="ln_act", act="none", rate=0.0,
                             deterministic=deterministic, seeds=seeds,
                             out_dtype=torch.float32, dtype=dt)
        else:
            h = self.ln1(self.fc1(x.to(dt))).to(dt)
            h = _dropout(_activation(c.act)(h), c.dropout, deterministic, seeds)
            h = self.ln2(self.fc2(h))
        return l2_normalize(h) if c.l2_normalize_output else h


class OptimizedProjectionHead(nn.Module):
    """skip Dense + layer_scale * deep projection (two Dense+LN+act+dropout
    blocks, then Dense+LN), xavier-uniform Dense kernels, layer scale
    initialised to layer_scale_init. With fused_dense and act == "gelu" the
    three blocks are fused, the last with the skip tail (and L2 normalize)."""

    def __init__(self, cfg, in_dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        hidden = cfg.hidden_dim or 4 * cfg.dim
        self.skip = Dense(in_dim, cfg.dim, device=device, init="xavier")
        self.fc0 = Dense(in_dim, hidden, device=device, init="xavier")
        self.ln0 = LayerNorm(hidden, FLAX_LN_EPS, device=device)
        self.fc1 = Dense(hidden, hidden, device=device, init="xavier")
        self.ln1 = LayerNorm(hidden, FLAX_LN_EPS, device=device)
        self.fc_out = Dense(hidden, cfg.dim, device=device, init="xavier")
        self.ln_out = LayerNorm(cfg.dim, FLAX_LN_EPS, device=device)
        self.layer_scale = nn.Parameter(torch.full(
            (1,), float(cfg.layer_scale_init), dtype=torch.float32, device=device))

    def reset_own_params(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.layer_scale.fill_(float(self.cfg.layer_scale_init))

    def forward(self, x, deterministic: bool = True, seeds=None) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        x = x.to(dt)
        skip = self.skip(x)
        h = x
        if c.fused_dense and c.act == "gelu":
            for i in range(2):
                h = _fused_block(h, getattr(self, f"fc{i}"), getattr(self, f"ln{i}"),
                                 order="ln_act", act="gelu", rate=c.dropout,
                                 deterministic=deterministic, seeds=seeds,
                                 out_dtype=dt, dtype=dt)
            return _fused_block(h, self.fc_out, self.ln_out, order="ln_act", act="none",
                                rate=0.0, deterministic=deterministic, seeds=seeds,
                                out_dtype=torch.float32, dtype=dt, skip=skip,
                                layer_scale=self.layer_scale, l2=c.l2_normalize_output)
        act = _activation(c.act)
        for i in range(2):
            h = getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(h)).to(dt)
            h = _dropout(act(h), c.dropout, deterministic, seeds)
        h = self.ln_out(self.fc_out(h))
        out = skip.float() + self.layer_scale * h
        return l2_normalize(out) if c.l2_normalize_output else out


def make_projection(cfg, in_dim: int, dtype=torch.bfloat16, device=None) -> nn.Module:
    cls = {"linear": LinearProjection, "base": ProjectionHead,
           "optimized": OptimizedProjectionHead}.get(cfg.kind)
    if cls is None:
        raise ValueError(f"unknown projection kind {cfg.kind!r}")
    return cls(cfg, in_dim, dtype, device)


# ---------------------------------------------------------------------------
# the token towers' transformer block
# ---------------------------------------------------------------------------


class TransformerBlock(nn.Module):
    """Pre-LN encoder block: x + dropout(attention(LN(x))), then
    x + dropout(ffn_out(gelu(ffn_in(LN(x))))), LayerNorm eps 1e-6 with its
    output in `ln_dtype`, tanh-GELU (flax's default), Dense layers in
    `dtype`. `qkv` is one Dense of width 3D in [q | k | v] layout.

    `out_rows` keeps only the first rows after the attention core (exact
    dead-code elimination when the pooling reads just those rows: the FFN
    half and the LNs are row-local); with `out_rows == 1` the attention
    itself is the CLS-query kernel, the (S, S) attention never happens."""

    def __init__(self, d_model: int, num_heads: int, ffn_mult: int = 4, dropout: float = 0.1,
                 dtype=torch.bfloat16, ln_dtype=torch.float32, out_rows: Optional[int] = None,
                 device=None):
        super().__init__()
        self.num_heads, self.dropout, self.out_rows = num_heads, dropout, out_rows
        self.dtype, self.ln_dtype = dtype, ln_dtype
        self.ln_attn = LayerNorm(d_model, FLAX_LN_EPS, device=device)
        self.qkv = Dense(d_model, 3 * d_model, device=device)
        self.out_proj = Dense(d_model, d_model, device=device)
        self.ln_ffn = LayerNorm(d_model, FLAX_LN_EPS, device=device)
        self.ffn_in = Dense(d_model, ffn_mult * d_model, device=device)
        self.ffn_out = Dense(ffn_mult * d_model, d_model, device=device)

    def _ln(self, ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return ln(x).to(self.ln_dtype).to(self.dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, seeds: Optional[DropoutSeeds] = None):
        from clip_dplm_tpu_torch.ops.attention import (
            cls_query_attention,
            multihead_attention,
            packed_qkv_attention_proj,
            packed_tiny_attention_proj,
            short_attn_packed_ok,
            tiny_attn_ok,
        )

        H, rows = self.num_heads, self.out_rows
        qkv = self.qkv(self._ln(self.ln_attn, x))
        short = short_attn_packed_ok(qkv.shape, H, mask)
        if rows == 1:
            attn = self.out_proj(cls_query_attention(qkv, H, mask=mask))
        elif short or tiny_attn_ok(qkv.shape, H, mask):
            packed = packed_qkv_attention_proj if short else packed_tiny_attention_proj
            attn = packed(qkv, self.out_proj.kernel, self.out_proj.bias, H, mask=mask)
            attn = attn if rows is None else attn[:, :rows]
        else:
            attn = multihead_attention(*qkv.chunk(3, dim=-1), H, mask=mask)
            attn = self.out_proj(attn if rows is None else attn[:, :rows])
        attn = _dropout(attn, self.dropout, deterministic, seeds)
        x = (x if rows is None else x[:, :rows]) + attn
        h = F.gelu(self.ffn_in(self._ln(self.ln_ffn, x)), approximate="tanh")
        h = _dropout(self.ffn_out(h), self.dropout, deterministic, seeds)
        return x + h


class VectorTransformerTower(nn.Module):
    """The `transformer` tower over one embedding vector: a Dense into
    NUM_TOKENS tokens of width hidden_size, a learned (1, NUM_TOKENS, d)
    position table (normal 0.02 init), num_hidden_layers TransformerBlocks
    with num_attention_heads heads (no mask: the tiny-S path at 8 tokens),
    then the LayerNorm of the token mean."""

    NUM_TOKENS = 8

    def __init__(self, cfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, n = cfg.hidden_size, self.NUM_TOKENS
        self.tokenize = Dense(cfg.input_dim, n * d, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, d, dtype=torch.float32, device=device))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d, cfg.num_attention_heads, 4, cfg.dropout, dtype=dtype, device=device))
        self.LayerNorm_0 = LayerNorm(d, FLAX_LN_EPS, device=device)

    def reset_own_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, deterministic: bool = True, seeds=None) -> torch.Tensor:
        h = self.tokenize(x.to(self.dtype)).reshape(x.shape[0], self.NUM_TOKENS, -1)
        h = h + self.pos_embed.to(self.dtype)
        for i in range(self.cfg.num_hidden_layers):
            h = getattr(self, f"block_{i}")(h, None, deterministic, seeds)
        return self.LayerNorm_0(h.mean(dim=1))
