"""Carry flax weights into the port's modules.

A flax param tree (nested mappings of arrays, as `model.init(...)["params"]`
or a checkpoint gives it) becomes a `state_dict` of the port's `DPLM` or
`ESMTower`: the scope path joins with dots (`layer_0/q/kernel` ->
`layer_0.q.kernel`), Dense kernels are transposed from flax's (in, out) to the
port's (out, in), and a stacked `layers/block` tree (the `scan_layers`
layout) is unstacked to `layer_<i>` first.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn

from clip_dplm_tpu_torch.models.esm import unstack_esm_layers


def _to_dict(tree):
    if isinstance(tree, Mapping):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def flax_to_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """Flax params of DPLM / ESMTower -> the port's state_dict (f32, CPU)."""
    params = _to_dict(params)
    if "params" in params and len(params) == 1:
        params = params["params"]
    if "layers" in params and "layer_0" not in params:
        params = unstack_esm_layers(params, num_layers)
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                arr = val.T if key == "kernel" else val
                sd[f"{prefix}{key}"] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, "")
    return sd


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load flax params into a port DPLM / ESMTower in place (strict: every
    key must match) and return it."""
    sd = flax_to_state_dict(params, module.cfg.num_layers)
    module.load_state_dict(sd, strict=True)
    return module
