"""LoRA adapters for the ESM-family trunks (ESMTower, DPLM).

Counterpart of `clip_dplm_tpu/models/lora.py`: low-rank fine-tuning of the
large frozen towers. An adapted dense site `<name>` gains a sibling module
`<name>_lora` holding `a` (in, r), He-uniform, and `b` (r, out), zeros, so
a LoRA model is exactly its base at init; its delta is
``scale * (x @ a) @ b`` with scale = alpha / r, in the compute dtype. `a`
and `b` keep flax's shapes (utils/convert.py transposes Dense kernels only),
so `layer_0.q_lora.a` in the port is `layer_0/q_lora/a` in a flax tree and
the two packages read each other's adapter files (`save_adapters_npz`: the
keys are the `/`-joined flax paths).

How the adapters meet the kernels (models/esm.py::EsmBlock): the q, k and v
deltas are added into the packed qkv slices; the `out` adapter merges into
the packed attention's weight operand, ``wo + scale * (a @ b)^T`` in f32,
and reaches a and b through that kernel's dWo; the FFN takes its manual
path. The base is frozen at use (detached), so no dW of a frozen site is
computed, and train/state.py keeps no Adam moments for it.

The helpers work on the port's flat parameter mappings (`dotted.name ->
tensor`, as `model.state_dict()` or `named_parameters()` give them):
`split_lora` / `merge_adapters` part and join base and adapters,
`merge_lora` folds the adapters into their kernels for the non-LoRA model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clip_dplm_tpu_torch.models.layers import numpy_f32

SITES = ("q", "k", "v", "out", "ffn_in", "ffn_out")


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    """Adapter spec: rank, alpha and the adapted sites. The base weights of
    an adapted block are always detached at use (their dW is never
    computed); the freeze itself is the optimizer's
    (train/state.py::freeze_subtrees)."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("q", "v")

    def __post_init__(self):
        bad = set(self.targets) - set(SITES)
        if bad:
            raise ValueError(f"unknown LoRA targets {sorted(bad)}; valid: {SITES}")
        if self.rank <= 0:
            raise ValueError("LoRA rank must be positive")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def spec_from(cfg) -> Optional[LoRASpec]:
    """The LoRASpec of a config with lora_rank / lora_alpha / lora_targets
    (ESMConfig, DPLMConfig); None when the rank is 0."""
    rank = getattr(cfg, "lora_rank", 0)
    if not rank:
        return None
    return LoRASpec(rank=rank, alpha=getattr(cfg, "lora_alpha", 16.0),
                    targets=tuple(getattr(cfg, "lora_targets", ("q", "v"))))


class LoRAPair(nn.Module):
    """The (a, b) pair of one dense site: `forward(x)` is the activation-space
    delta ``scale * (x @ a) @ b`` in x's dtype (both products rounded to it,
    as flax's bf16 matmuls are); `weight()` is the weight-space delta
    ``scale * a @ b`` in f32, (in, out)."""

    def __init__(self, in_features: int, features: int, rank: int, alpha: float,
                 device=None):
        super().__init__()
        self.scale = alpha / rank
        self.a = nn.Parameter(torch.empty(in_features, rank, dtype=torch.float32,
                                          device=device))
        self.b = nn.Parameter(torch.zeros(rank, features, dtype=torch.float32,
                                          device=device))

    def reset_own_params(self, generator: torch.Generator) -> None:
        """a He-uniform (flax's he_uniform: limit sqrt(6 / in)), b zeros."""
        with torch.no_grad():
            limit = math.sqrt(6.0 / self.a.shape[0])
            self.a.uniform_(-limit, limit, generator=generator)
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return ((x @ self.a.to(dt)) @ self.b.to(dt)) * torch.tensor(self.scale, dtype=dt)

    def weight(self) -> torch.Tensor:
        return (self.a @ self.b) * self.scale


def _segments(name) -> Tuple[str, ...]:
    return tuple(name.split(".")) if isinstance(name, str) else tuple(name)


def is_lora_path(name) -> bool:
    """True if a parameter name (dotted, or a tuple of segments) belongs to
    an adapter: any `<site>_lora` segment."""
    return any(seg.endswith("_lora") for seg in _segments(name))


def has_lora_params(params: Mapping) -> bool:
    return any(is_lora_path(k) for k in params)


def split_lora(params: Mapping) -> Tuple[Dict, Dict]:
    """(base, adapters) of a flat parameter mapping: `adapters` holds the
    `*_lora` leaves (the small artifact to save), `base` loads into the
    non-LoRA model."""
    base = {k: v for k, v in params.items() if not is_lora_path(k)}
    return base, {k: v for k, v in params.items() if is_lora_path(k)}


def merge_adapters(base: Mapping, adapters: Mapping) -> Dict:
    """Inverse of `split_lora`: the adapters grafted onto a base mapping
    (e.g. a loaded adapter file over pretrained weights)."""
    return {**base, **adapters}


def save_adapters_npz(path: str, params: Mapping) -> int:
    """Save only the adapter leaves to an .npz whose keys are the
    `/`-joined flax paths (`layer_0/q_lora/a`), f32 in flax's shapes; the
    JAX package's `load_adapters_npz` reads it. Returns the number of
    leaves saved."""
    _, ada = split_lora(params)
    flat = {k.replace(".", "/"): numpy_f32(v) for k, v in ada.items()}
    if not flat:
        raise ValueError("no *_lora adapters in these parameters")
    np.savez(path, **flat)
    return len(flat)


def load_adapters_npz(path: str) -> Dict[str, torch.Tensor]:
    """An adapter .npz (written by either package) -> {dotted name: f32
    tensor}, ready for `model.load_state_dict(adapters, strict=False)` or
    `merge_adapters`."""
    with np.load(path) as flat:
        return {k.replace("/", "."): torch.from_numpy(np.array(flat[k], dtype=np.float32))
                for k in flat.files}


def merge_lora(params: Mapping, spec: LoRASpec) -> Dict[str, torch.Tensor]:
    """Fold every adapter into its sibling kernel, ``kernel += scale * (a @
    b)^T`` (the port's kernels are (out, in)), and drop the `*_lora` leaves:
    the parameters of the non-LoRA model, whose forward equals the adapted
    one (the deploy and export form). An adapter without its base site
    raises."""
    out = {k: v for k, v in params.items() if not is_lora_path(k)}
    pairs = {k.rsplit(".", 1)[0] for k in params if is_lora_path(k)}
    for pair in sorted(pairs):
        site = pair[: -len("_lora")]
        kernel = f"{site}.kernel"
        if kernel not in out:
            raise ValueError(f"LoRA adapter {pair} has no base site {kernel}")
        a, b = params[f"{pair}.a"], params[f"{pair}.b"]
        delta = (a.float() @ b.float()) * spec.scale
        out[kernel] = out[kernel] + delta.t().to(out[kernel].dtype)
    return out
