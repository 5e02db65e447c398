"""Carry flax weights into the port's modules.

A flax param tree (nested mappings of arrays, as `model.init(...)["params"]`
or a checkpoint gives it) becomes a `state_dict` of the port's `DPLM`,
`ESMTower`, `TwoTowerCLIP` (any tower, the `transformer` one included),
`RNARBPCLIP`, `ESMProteinCLIP` (scopes `rna_tower`, `esm_tower`, `rna_proj`,
`protein_proj`) or `TFContrastiveModel`: the scope path joins with dots
(`layer_0/q/kernel` -> `layer_0.q.kernel`, `rna_tower/block_0/out_proj/kernel`
-> `rna_tower.block_0.out_proj.kernel`, `cell_in/layers_3/kernel` ->
`cell_in.layers_3.kernel`), Dense kernels (the packed attention's `out_proj`
included) are transposed from flax's (in, out) to the port's (out, in), every
other leaf keeps its shape (the 0-d `logit_scale`, the (1, max_len, d) or
(1, 8, d) `pos_embed`, the (1, 1, d) `cls_token`), and a stacked
`layers/block` tree (the `scan_layers` layout), at the top or in the
`esm_tower` scope, is unstacked to `layer_<i>` first. `state_dict_to_flax`
is the inverse (the unrolled layout): the flax tree of a port module's
weights, as numpy f32 (utils/pretrained.py writes it). The triple_flow
family's leaves (models/gnn.py, tong_encoders.py, flows.py,
triple_flow_model.py, icnn.py, esm_projections.py) map the same way, with
two layouts of their own: a flax `MultiHeadDotProductAttention` (scopes
`query`, `key`, `value`, `out`) keeps its kernels as (d, H, dh) and (H, dh,
d) and its q/k/v biases as (H, dh), which become the port's (H*dh, d) and
(d, H*dh) kernels and (H*dh,) biases (and back, given the module, which
knows H); the ICNN's raw `pos_weights` and `final_pos_weights` are (in,
out) in both and keep their shape. `load_cache` carries a train state's
hard-negative cache (`cache`, `cache_ptr`, `cache_len`, as numpy) into the
port's `TrainState`, and `load_flax_train_state` a whole JAX train state
(params, the fused AdamW's moments, the step, the cache).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from clip_dplm_tpu_torch.models.esm import unstack_esm_layers
from clip_dplm_tpu_torch.models.layers import numpy_f32


def _to_dict(tree):
    if isinstance(tree, Mapping):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def flax_to_state_dict(params: Mapping,
                       num_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Flax params of DPLM / ESMTower / TwoTowerCLIP / RNARBPCLIP /
    ESMProteinCLIP / TFContrastiveModel / TripleFlowModel (and the other
    triple_flow modules) -> the port's state_dict (f32, CPU).
    `num_layers` unstacks a top-level `layers/block` subtree (read from its
    leading dim when not given, as it always is for `esm_tower`'s); trees
    without one need nothing."""
    params = _to_dict(params)
    if "params" in params and len(params) == 1:
        params = params["params"]
    params = _unstacked(params, num_layers)
    if isinstance(params.get("esm_tower"), dict):
        params["esm_tower"] = _unstacked(params["esm_tower"], None)
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                arr = val
                if key == "kernel" and val.ndim == 3:  # attention's DenseGeneral
                    scope = prefix.rstrip(".").rsplit(".", 1)[-1]
                    arr = (val.reshape(-1, val.shape[-1]) if scope == "out"
                           else val.reshape(val.shape[0], -1))
                elif key == "bias" and val.ndim == 2:
                    arr = val.reshape(-1)
                arr = arr.T if key == "kernel" else arr
                sd[f"{prefix}{key}"] = torch.from_numpy(np.array(arr, order="C"))

    walk(params, "")
    return sd


def state_dict_to_flax(sd: Mapping) -> Dict:
    """A port state_dict (or a module) -> the flax param tree of the same
    weights, nested dicts of numpy f32, Dense kernels back to (in, out): the
    inverse of `flax_to_state_dict` in the unrolled layout. Given the
    module, its attention layers' leaves go back to flax's head layout;
    given a bare state_dict they stay 2-D."""
    heads = {}
    if isinstance(sd, nn.Module):
        from clip_dplm_tpu_torch.models.tong_encoders import MultiHeadAttention

        heads = {f"{name}.": m.h for name, m in sd.named_modules()
                 if isinstance(m, MultiHeadAttention)}
        sd = sd.state_dict()
    tree: Dict = {}
    for name, val in sd.items():
        *scopes, leaf = name.split(".")
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        arr = numpy_f32(val)
        arr = arr.T if leaf == "kernel" else arr
        mha = [(p, h) for p, h in heads.items() if name.startswith(p)
               and name[len(p):].count(".") == 1]
        if mha:
            H = mha[0][1]
            if leaf == "kernel":
                arr = (arr.reshape(H, -1, arr.shape[-1]) if scopes[-1] == "out"
                       else arr.reshape(arr.shape[0], H, -1))
            elif scopes[-1] != "out":
                arr = arr.reshape(H, -1)
        node[leaf] = np.array(arr, order="C")
    return tree


def _unstacked(params: Dict, num_layers: Optional[int]) -> Dict:
    """A tree with a stacked `layers/block` subtree and no `layer_0` in the
    unrolled layout; any other tree as it is."""
    if "layers" not in params or "layer_0" in params:
        return params
    if num_layers is None:
        num_layers = next(iter(_leaves(params["layers"]))).shape[0]
    return unstack_esm_layers(params, num_layers)


def _leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load flax params into a port DPLM / ESMTower / TwoTowerCLIP /
    RNARBPCLIP / ESMProteinCLIP / TFContrastiveModel / TripleFlowModel in
    place (strict: every key must match) and return it; a module with no
    `cfg` (the probe classifiers of models/classifiers.py) has no stacked
    layers to unstack."""
    sd = flax_to_state_dict(params, getattr(getattr(module, "cfg", None), "num_layers", None))
    module.load_state_dict(sd, strict=True)
    return module


def load_cache(state, cache, cache_ptr, cache_len):
    """Copy a hard-negative cache into the port's TrainState in place, onto
    its device: `cache` (cache_size, dim), `cache_ptr` and `cache_len`
    scalars, any array-likes (a JAX TrainState's fields through np.asarray,
    say). The state must have a cache of the same shape
    (contrastive.use_cache). Returns the state."""
    if state.cache is None:
        raise ValueError("the state has no hard-negative cache (contrastive.use_cache is off)")
    cache = np.array(cache, dtype=np.float32)
    if cache.shape != tuple(state.cache.shape):
        raise ValueError(f"cache of shape {cache.shape} does not fit the state's "
                         f"{tuple(state.cache.shape)}")
    state.cache.copy_(torch.from_numpy(cache))
    state.cache_ptr.fill_(int(np.asarray(cache_ptr)))
    state.cache_len.fill_(int(np.asarray(cache_len)))
    return state


def _field(tree, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _find_adam(opt_state):
    """The first node holding (count, mu, nu) in a JAX optimizer state,
    depth first: the FusedAdamWState, the optax chain's ScaleByAdamState,
    either inside `freeze_subtrees`' chain or its `optax.masked`; None when
    there is none."""
    fields = ("count", "mu", "nu")
    if all(hasattr(opt_state, f) for f in fields) or (
            isinstance(opt_state, Mapping) and set(fields) <= set(opt_state)):
        return opt_state
    if hasattr(opt_state, "inner_state"):  # optax.masked's MaskedState
        return _find_adam(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for node in opt_state:
            found = _find_adam(node)
            if found is not None:
                return found
    return None


def _has_prev_norm(node) -> bool:
    return hasattr(node, "prev_norm") or (isinstance(node, Mapping) and "prev_norm" in node)


def _adamw_state(opt_state, fused: bool):
    """The Adam state inside a JAX optimizer state that matches the port's
    optimizer: the fused AdamW's (count, mu, nu, prev_norm) when `fused`,
    else the optax chain's (count, mu, nu)."""
    node = _find_adam(opt_state)
    if node is None or _has_prev_norm(node) != fused:
        want = ("the fused AdamW's (count, mu, nu, prev_norm)" if fused
                else "the optax chain's (count, mu, nu) and no prev_norm")
        raise ValueError(f"no state of {want} in a {type(opt_state).__name__}: the JAX state "
                         "and the port's train.optim.fused_update must agree")
    return node


def _drop_masked(tree):
    """A moment tree without the leaves `optax.masked` leaves out (its
    `MaskedNode`, an empty tuple subclass), and without subtrees left empty."""
    if isinstance(tree, Mapping):
        kept = {k: _drop_masked(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None}
    if isinstance(tree, tuple) and not tree:
        return None
    return tree


def _moments(state, tree) -> Dict[str, torch.Tensor]:
    module = state.model
    sd = flax_to_state_dict(_drop_masked(tree), getattr(module.cfg, "num_layers", None))
    names = set(state.opt_state.mu)
    if set(sd) != names:
        raise KeyError(f"the JAX moments do not match the port's: missing "
                       f"{sorted(names - set(sd))}, extra {sorted(set(sd) - names)}")
    return sd


def load_flax_train_state(state, jax_state):
    """Carry a JAX TrainState (its fields as arrays, or a dict of them as
    `train/checkpoint.py::_arrays_only` gives) into the port's TrainState in
    place, onto its device, and return it: the params (`load_flax_params`),
    the fused AdamW's count, mu, nu (Dense kernels' moments transposed to
    (out, in) as the kernels are; stored in the port's moment dtype) and
    prev_norm, or the optax chain's count, mu and nu where the port's
    optimizer is the chain (`optim.fused_update=false`), found in the plain
    state, in `freeze_subtrees`' chain or under its `optax.masked` (LoRA:
    the frozen leaves have no moments on either side), the step, and the hard-negative cache (`load_cache`) when
    the state has one. The dropout key stays the port's: JAX's PRNG key
    cannot be carried into the port's hash (a step's dropout differs)."""
    load_flax_params(state.model, _field(jax_state, "params"))
    opt = state.opt_state
    fused = hasattr(opt, "prev_norm")
    adam = _adamw_state(_field(jax_state, "opt_state"), fused)
    with torch.no_grad():
        for attr in ("mu", "nu"):
            have = getattr(opt, attr)
            for k, v in _moments(state, _field(adam, attr)).items():
                have[k].copy_(v)
        if fused:
            opt.prev_norm.fill_(float(np.asarray(_field(adam, "prev_norm"))))
    opt.count = int(np.asarray(_field(adam, "count")))
    state.step = int(np.asarray(_field(jax_state, "step")))
    if state.cache is not None:
        load_cache(state, *(_field(jax_state, k) for k in ("cache", "cache_ptr", "cache_len")))
    return state
