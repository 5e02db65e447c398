"""Self-contained pretrained bundles: config + params in one directory.

Counterpart of `clip_dplm_tpu/utils/pretrained.py`, in the same layout, so a
bundle written by either package loads in the other:

- `params.npz`: the flax param tree of the weights (`utils/convert.py::
  state_dict_to_flax`: Dense kernels (in, out)), its paths joined by `::`,
  f32. The port writes it uncompressed (`np.savez`; numpy reads both).
- `config.yaml`: the `Config`. The port writes it as JSON text, which is
  YAML, so the JAX package's `load_config` reads it and the port needs no
  PyYAML for its own bundles. A block-YAML config (the JAX package's) is
  read with PyYAML where it is installed, and raises naming the module
  elsewhere.

Reading a config holds every field the port has not ported to the JAX
package's default (`_UNPORTED`): one that differs raises and names the field,
so nothing is silently ignored; `precision.compute_dtype` and
`precision.param_dtype` other than their defaults raise naming why (the JAX
package reads neither: its modules take their dtype from their own
attribute). `esm.scan_layers` and
`dplm.scan_layers` only set the layout of the params, which the converter
reads either way (the port's modules are unrolled), so they pass.

`load_pretrained` builds the model through the port's registry
(`experiments/registry.py::build_model`) when the params are that model's,
else the bare module they are: an ESM-2 tower (`ESMTower(cfg.esm)`) or a
DPLM trunk (`DPLM(cfg.dplm)`) whose params sit at the top, the bundles the
serve, embed and generate CLIs read. `esm_tower_of`, `dplm_of` and
`scorer_of` pick what those CLIs need out of either.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

_SEP = "::"

# the JAX package's defaults of every Config field the port does not have
# (clip_dplm_tpu/config.py): a bundle's value must equal them
_UNPORTED: Dict[str, Any] = {
    "contrastive": {"gather_global_batch": True},
    "encoders": {"gnn": {"hidden_dim": 512, "edge_dim": 16, "n_neighbors": 32}},
    "flow": {"sinkhorn_epsilon": 0.02},
    "icnn": {"input_dim": 512, "hessian_reg": 0.0001, "w2_weight": 1.0},
    "train": {
        "eval_every_steps": 100, "log_every_steps": 10, "checkpoint_every_steps": 1000,
        "preemption_poll_batches": 8, "rng_impl": "threefry2x32",
    },
    "precision": {"compute_dtype": "bfloat16", "param_dtype": "float32"},
    "mesh": {"data_axis": "data", "model_axis": "model", "model_parallel": 1},
    "data": {"num_workers": 0, "max_seq_len": 1024},
    "logging": {"csv_metrics": True},
}
# fields that only lay the params out (stacked or unrolled): any value passes
_LAYOUT_ONLY = {"esm.scan_layers", "dplm.scan_layers"}


# ---------------------------------------------------------------------------
# config.yaml
# ---------------------------------------------------------------------------


def config_to_dict(cfg) -> Dict[str, Any]:
    """The Config as nested plain values (tuples as lists), JSON-ready."""
    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return [plain(v) for v in x]
        return x

    return plain(dataclasses.asdict(cfg))


def _same(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


def _check_unported(path: str, value, default) -> None:
    if path in _LAYOUT_ONLY:
        return
    if path in ("precision.compute_dtype", "precision.param_dtype") and value != default:
        raise ValueError(f"{path}={value!r} is not ported: nothing of the JAX package reads it "
                         "(its modules take their dtype from their own attribute: bf16 "
                         f"compute, f32 params), so the port holds it to {default!r}")
    if isinstance(default, dict) and isinstance(value, dict):
        for k, v in value.items():
            if k not in default:
                raise KeyError(f"unknown config key {path}.{k}")
            _check_unported(f"{path}.{k}", v, default[k])
        return
    if not _same(value, default):
        raise ValueError(f"config field {path}={value!r} is not ported (the port runs only "
                         f"its default, {default!r})")


def _coerce(value, typ, path: str):
    if typing.get_origin(typ) is typing.Union:  # Optional[X]
        if value is None:
            return None
        (typ,) = [a for a in typing.get_args(typ) if a is not type(None)]
    if typing.get_origin(typ) is tuple:
        (inner, _) = typing.get_args(typ)
        return tuple(inner(v) for v in value)
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ in (int, float, str):
        return typ(value)
    raise TypeError(f"{path}: cannot read a value of type {typ}")


def config_from_dict(raw: Mapping, cls=Config, path: str = ""):
    """A nested mapping (a bundle's config, from either package) -> the
    port's dataclass `cls`; fields the port lacks must hold the JAX
    package's defaults (`_UNPORTED`)."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for key, value in raw.items():
        dotted = f"{path}{key}"
        if key not in hints:
            node = _UNPORTED
            for part in dotted.split("."):
                node = node.get(part, {}) if isinstance(node, dict) else {}
            if node == {} and dotted not in _LAYOUT_ONLY:
                raise KeyError(f"unknown config key {dotted}")
            _check_unported(dotted, value, node)
            continue
        typ = hints[key]
        if dataclasses.is_dataclass(typ):
            kwargs[key] = config_from_dict(value or {}, typ, dotted + ".")
        else:
            kwargs[key] = _coerce(value, typ, dotted)
    return cls(**kwargs)


def read_config(path: str) -> Config:
    """config.yaml of either package -> the port's Config: JSON text (the
    port's) directly, block YAML (the JAX package's) through PyYAML."""
    with open(path) as f:
        text = f.read()
    try:
        raw = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError as err:
            raise ImportError(f"{path} is block YAML (written by the JAX package): reading it "
                              "needs the PyYAML module (`yaml`), which is not installed") from err
        raw = yaml.safe_load(text)
    return config_from_dict(raw or {})


def write_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)
        f.write("\n")


# ---------------------------------------------------------------------------
# params.npz
# ---------------------------------------------------------------------------


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _unflatten(flat: Mapping) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *scopes, leaf = key.split(_SEP)
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def save_pretrained(directory: str, cfg: Config, params) -> None:
    """Write a bundle: `cfg` and the weights of `params` (a module or its
    state_dict) in the JAX layout."""
    os.makedirs(directory, exist_ok=True)
    write_config(cfg, os.path.join(directory, "config.yaml"))
    np.savez(os.path.join(directory, "params.npz"), **_flatten(state_dict_to_flax(params)))


def _bare_modules(cfg: Config):
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.models.dplm import DPLM
    from clip_dplm_tpu_torch.models.esm import ESMTower

    return (lambda device, dtype: build_model(cfg, device=device, dtype=dtype),
            lambda device, dtype: ESMTower(cfg.esm, dtype, device),
            lambda device, dtype: DPLM(cfg.dplm, dtype, device))


def load_pretrained(directory: str, device=None, dtype: torch.dtype = torch.bfloat16
                    ) -> Tuple[Config, nn.Module, Dict[str, torch.Tensor]]:
    """(config, model, state_dict) of a bundle written by either package:
    the model on `device` (the CPU by default) with the bundle's weights,
    `dtype` its compute dtype; the state_dict f32 on the CPU."""
    cfg = read_config(os.path.join(directory, "config.yaml"))
    with np.load(os.path.join(directory, "params.npz")) as z:
        sd = flax_to_state_dict(_unflatten({k: z[k] for k in z.files}))
    for make in _bare_modules(cfg):
        try:
            names = set(make("meta", dtype).state_dict())
        except (ValueError, KeyError, TypeError):
            continue  # the registry refuses the experiment; the bare modules may fit
        if names == set(sd):
            model = make(device, dtype)
            model.load_state_dict(sd, strict=True)
            return cfg, model, sd
    raise ValueError(f"{directory}: the params are neither those of experiment "
                     f"{cfg.experiment!r} nor of a bare ESMTower(esm) or DPLM(dplm)")


def esm_tower_of(model: nn.Module):
    """The ESM-2 tower of a loaded bundle's model: an ESMTower itself, or
    the `esm_tower` of an ESMProteinCLIP."""
    from clip_dplm_tpu_torch.models.esm import ESMTower

    tower = model if isinstance(model, ESMTower) else getattr(model, "esm_tower", None)
    if not isinstance(tower, ESMTower):
        raise ValueError(f"a {type(model).__name__} bundle holds no ESM-2 tower")
    return tower


def dplm_of(model: nn.Module):
    """The DPLM of a loaded bundle's model."""
    from clip_dplm_tpu_torch.models.dplm import DPLM

    if not isinstance(model, DPLM):
        raise ValueError(f"a {type(model).__name__} bundle holds no DPLM")
    return model



def scorer_of(model: nn.Module):
    """The protein scorer of a loaded bundle's model, (tokens, mask) ->
    (rows, d) embeddings: an ESMProteinCLIP's `encode_protein` (its ESM
    tower and protein projection, f32, the shared space), else an ESM-2
    tower's mean-residue embedding."""
    from clip_dplm_tpu_torch.models.protein_clip import ESMProteinCLIP

    model.eval()
    if isinstance(model, ESMProteinCLIP):
        return model.encode_protein
    tower = esm_tower_of(model)
    return lambda toks, mask: tower(toks, mask, pooling="mean_residues")
