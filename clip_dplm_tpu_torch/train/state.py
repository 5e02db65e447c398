"""Train state, learning-rate schedules and the fused AdamW.

Counterpart of `clip_dplm_tpu/train/state.py`. `TrainState` holds the model
(its parameters are the state's parameters), the optimizer, its moments,
the step and an integer dropout key; the dropout seeds of a step are hashed
from (key, step, site) on the host (ops/fused_dense.py::DropoutSeeds). With
`contrastive.use_cache` it also holds the hard-negative cache: `cache`
((cache_size, projection.dim) f32, zeros at first) and `cache_ptr` /
`cache_len`, int32 scalars on the model's device (ops/infonce.py::
update_cache); without it the three are None.

`FusedAdamW` is the reference's `fused_adamw`: AdamW with the global-norm
clip folded into the one per-tensor update, bias correction, decoupled
weight decay, moments optionally stored in bf16 (computed in f32), the
learning rate read at the count before the increment, and a `stale` clip
mode that clips with the previous step's norm. It updates the parameters in
place (the reference's state is immutable; here that saves a copy of every
parameter and moment) and never waits on the device. `freeze_subtrees`
zeroes the whole update of top-level subtrees; the `*_lora` adapter leaves
inside them (models/lora.py) still train, and where adapters are present
the frozen leaves get no Adam moments at all, and neither enter the global
norm (the reference's `optax.masked` inner optimizer).

`AdamWChain` (`optim.fused_update=false`) is the reference's unfused
optax chain, kept beside the fused update as JAX keeps it:
`clip_by_global_norm` (the clipped gradient is g, or (g / norm) · clip when
the norm reaches the clip), then `optax.adamw` with the schedule, `mu` in
`moment_dtype` and `nu` in f32, each step as optax orders its arithmetic
(the moments' decay products in the moment's dtype, the bias corrections
as divisions, the decay added before the learning rate). Its state has
`count`, `mu` and `nu`, and no `prev_norm`. It is written with the same
`torch._foreach_*` ops, not `torch.optim`, and takes `freeze_subtrees` as
the fused update does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from clip_dplm_tpu_torch.config import Config, OptimConfig
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.models.lora import has_lora_params, is_lora_path

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(float(count), float(decay_steps))
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def build_schedule(cfg: OptimConfig) -> Schedule:
    """optax's warmup_cosine_decay_schedule / cosine_decay_schedule /
    constant_schedule, evaluated on the host in double precision."""
    peak = cfg.learning_rate
    end = peak * cfg.min_lr_ratio
    if cfg.schedule == "warmup_cosine":
        warm = cfg.warmup_steps
        decay = max(cfg.total_steps, warm + 1)
        first = _linear(0.0, peak, warm)
        second = _cosine(peak, decay - warm, 0.0 if peak == 0.0 else end / peak)
        return lambda count: first(count) if count < warm else second(count - warm)
    if cfg.schedule == "cosine":
        return _cosine(peak, cfg.total_steps, cfg.min_lr_ratio)
    if cfg.schedule == "constant":
        return lambda count: peak
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    prev_norm: torch.Tensor  # previous step's global norm (stale mode); 0 = none yet


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32 (on the device)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass(frozen=True)
class FusedAdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 0.0
    moment_dtype: Optional[torch.dtype] = None
    clip_mode: str = "exact"
    # top-level parameter names (`tower_a`, ...) whose updates are zero, but
    # for their `*_lora` leaves
    frozen: Tuple[str, ...] = ()
    # the frozen leaves get no moments and stay out of the global norm
    mask_moments: bool = False

    def is_frozen(self, name: str) -> bool:
        return name.split(".", 1)[0] in self.frozen and not is_lora_path(name)

    def _moment_names(self, params) -> list:
        return [n for n in params if not (self.mask_moments and self.is_frozen(n))]

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)  # noqa: E731
        dev = next(iter(params.values())).device
        names = self._moment_names(params)
        return AdamWState(count=0, mu={k: zeros(params[k]) for k in names},
                          nu={k: zeros(params[k]) for k in names},
                          prev_norm=torch.zeros((), dtype=torch.float32, device=dev))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]) -> None:
        """One step: the moments in `state` and the parameters in place."""
        if self.clip_mode not in ("exact", "stale"):
            raise ValueError(f"unknown clip_mode {self.clip_mode!r}")
        dev = state.prev_norm.device
        names = self._moment_names(params)
        clipf = torch.ones((), dtype=torch.float32, device=dev)
        if self.clip_norm and self.clip_norm > 0:
            gnorm = global_norm([grads[n] for n in names])
            if self.clip_mode == "stale":
                prev = state.prev_norm
                clipf = torch.where(prev > 0, torch.clamp(self.clip_norm / prev, max=1.0), clipf)
                state.prev_norm = gnorm
            else:
                clipf = torch.clamp(self.clip_norm / gnorm, max=1.0)
        count_inc = state.count + 1
        # f32 bias corrections, as jnp.float32(b) ** count
        b1c = 1.0 - float(torch.tensor(self.b1, dtype=torch.float32) ** count_inc)
        b2c = 1.0 - float(torch.tensor(self.b2, dtype=torch.float32) ** count_inc)
        lr = float(self.schedule(state.count))
        idx = [i for i, n in enumerate(names) if not self.is_frozen(n)]
        # one multi-tensor op per line (torch._foreach_*), all in f32
        g = torch._foreach_mul([grads[n].float() for n in names], clipf)
        m = torch._foreach_mul([state.mu[n].float() for n in names], self.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - self.b1))
        v = torch._foreach_mul([state.nu[n].float() for n in names], self.b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        if idx:
            den = torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div([v[i] for i in idx], b2c)), self.eps)
            u = torch._foreach_div(torch._foreach_div([m[i] for i in idx], b1c), den)
            live = [params[names[i]] for i in idx]
            torch._foreach_add_(u, torch._foreach_mul([p.float() for p in live],
                                                      self.weight_decay))
            torch._foreach_add_(live, torch._foreach_mul(u, -lr))
        torch._foreach_copy_([state.mu[n] for n in names], m)
        torch._foreach_copy_([state.nu[n] for n in names], v)
        state.count = count_inc


@dataclasses.dataclass
class ChainState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWChain:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, mu_dtype=
    moment_dtype)), applied to the parameters in place."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 0.0
    moment_dtype: Optional[torch.dtype] = None
    frozen: Tuple[str, ...] = ()
    mask_moments: bool = False

    is_frozen = FusedAdamW.is_frozen
    _moment_names = FusedAdamW._moment_names

    def init(self, params: Dict[str, torch.Tensor]) -> ChainState:
        names = self._moment_names(params)
        return ChainState(
            count=0,
            mu={k: torch.zeros_like(params[k], dtype=self.moment_dtype or params[k].dtype)
                for k in names},
            nu={k: torch.zeros_like(params[k]) for k in names})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: ChainState,
               params: Dict[str, torch.Tensor]) -> None:
        """One step: the moments in `state` and the parameters in place."""
        names = self._moment_names(params)
        g = [grads[n].float() for n in names]
        if self.clip_norm and self.clip_norm > 0:
            gnorm = global_norm(g)
            keep = gnorm < self.clip_norm
            scaled = torch._foreach_mul(torch._foreach_div(g, gnorm), self.clip_norm)
            g = [torch.where(keep, a, b) for a, b in zip(g, scaled)]
        mu = [state.mu[n] for n in names]
        # b1 · mu in mu's dtype (optax's weakly typed scalar takes it)
        b1 = float(torch.tensor(self.b1, dtype=mu[0].dtype)) if mu else self.b1
        m = torch._foreach_add([t.float() for t in torch._foreach_mul(mu, b1)],
                               torch._foreach_mul(g, 1.0 - self.b1))
        v = torch._foreach_add(torch._foreach_mul([state.nu[n] for n in names], self.b2),
                               torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        count_inc = state.count + 1
        b1c = 1.0 - float(torch.tensor(self.b1, dtype=torch.float32) ** count_inc)
        b2c = 1.0 - float(torch.tensor(self.b2, dtype=torch.float32) ** count_inc)
        lr = float(torch.tensor(-float(self.schedule(state.count)), dtype=torch.float32))
        idx = [i for i, n in enumerate(names) if not self.is_frozen(n)]
        if idx:
            den = torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div([v[i] for i in idx], b2c)), self.eps)
            u = torch._foreach_div(torch._foreach_div([m[i] for i in idx], b1c), den)
            live = [params[names[i]] for i in idx]
            torch._foreach_add_(u, torch._foreach_mul([p.float() for p in live],
                                                      self.weight_decay))
            torch._foreach_add_(live, torch._foreach_mul(u, lr))
        torch._foreach_copy_(mu, m)
        torch._foreach_copy_([state.nu[n] for n in names], v)
        state.count = count_inc


def fused_adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.01, clip_norm: float = 0.0,
                moment_dtype: Optional[torch.dtype] = None,
                clip_mode: str = "exact") -> FusedAdamW:
    return FusedAdamW(schedule, b1, b2, eps, weight_decay, clip_norm, moment_dtype, clip_mode)


def build_optimizer(cfg: OptimConfig):
    """AdamW + global-norm clip + schedule: the fused update, or the optax
    chain under `fused_update=false`."""
    if cfg.moment_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown moment_dtype {cfg.moment_dtype!r}")
    if not cfg.fused_update:
        return AdamWChain(
            build_schedule(cfg), b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, clip_norm=cfg.grad_clip_norm or 0.0,
            moment_dtype=torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None)
    return fused_adamw(
        build_schedule(cfg), b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps,
        weight_decay=cfg.weight_decay, clip_norm=cfg.grad_clip_norm or 0.0,
        moment_dtype=torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None,
        clip_mode=cfg.clip_mode)


def freeze_subtrees(tx, params: Dict[str, torch.Tensor], frozen_keys):
    """Zero the whole update (decay included) of the top-level subtrees in
    `frozen_keys`: a zero gradient alone would still let weight decay shrink
    them; they stay bit-exact. `*_lora` leaves inside a frozen subtree
    train. When adapters are present the frozen leaves get no moments and
    stay out of the global norm; otherwise their moments are kept, as in
    the reference's chain."""
    tops = {k.split(".", 1)[0] for k in params}
    unknown = set(frozen_keys) - tops
    if unknown:
        raise KeyError(f"no parameter subtree named {sorted(unknown)}")
    return dataclasses.replace(tx, frozen=tuple(sorted(set(frozen_keys))),
                               mask_moments=has_lora_params(params))


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: Union[FusedAdamW, AdamWChain]
    opt_state: Union[AdamWState, ChainState]
    step: int
    key: int  # integer dropout key
    # the hard-negative ring (contrastive.use_cache), else None
    cache: Optional[torch.Tensor] = None
    cache_ptr: Optional[torch.Tensor] = None
    cache_len: Optional[torch.Tensor] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, cfg: Config, tx=None,
                       frozen_keys=(), init: bool = True) -> TrainState:
    """With `init`, random weights from a generator seeded by
    cfg.train.seed on the model's device; otherwise the model keeps its
    weights (loaded from a flax tree, say). Without a `tx` of the caller's
    and without `frozen_keys`, as the reference's create_train_state does:
    `esm.frozen` freezes an `esm_tower` subtree (esm_clip), and a DPLM with
    `dplm.lora_rank` freezes its `layer_*` blocks and `embed_tokens` (the
    adapters, final_ln and lm_head train)."""
    device = next(model.parameters()).device
    if init:
        init_params(model, torch.Generator(device=device).manual_seed(cfg.train.seed))
    params = dict(model.named_parameters())
    if tx is None:
        tx = build_optimizer(cfg.train.optim)
        if not frozen_keys and cfg.esm.frozen and any(k.startswith("esm_tower.")
                                                      for k in params):
            frozen_keys = ("esm_tower",)
        if not frozen_keys and cfg.experiment == "dplm" and cfg.dplm.lora_rank:
            tops = {k.split(".", 1)[0] for k in params}
            frozen_keys = tuple(sorted(t for t in tops
                                       if t.startswith("layer_") or t == "embed_tokens"))
    if frozen_keys:
        tx = freeze_subtrees(tx, params, frozen_keys)
    key = (cfg.train.seed * 0x9E3779B97F4A7C15 + 1) & ((1 << 64) - 1)
    state = TrainState(model=model, tx=tx, opt_state=tx.init(params), step=0, key=key)
    if cfg.contrastive.use_cache:
        state.cache = torch.zeros((cfg.contrastive.cache_size, cfg.projection.dim),
                                  dtype=torch.float32, device=device)
        state.cache_ptr = torch.zeros((), dtype=torch.int32, device=device)
        state.cache_len = torch.zeros((), dtype=torch.int32, device=device)
    return state
