"""Model configurations of the serving path: `ESMConfig` and `DPLMConfig`.

The frozen dataclasses of `clip_dplm_tpu/config.py`, without the yaml loader
(so the port imports no yaml) and with only the fields the port reads: the
reference's LoRA, guidance, freezing and `scan_layers` fields are left out
until the port has what they switch on, so passing one raises instead of
being ignored. The port's modules are always unrolled; utils/convert.py reads
both flax param layouts. Defaults are the reference's: the public ESM-2
geometry and the DPLM sampler's 640/12/10 trunk.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ESMConfig:
    """ESM-2-style protein transformer. Sizes follow the public ESM-2 family
    so torch checkpoints convert 1:1."""

    name: str = "esm2_t6_8M"
    vocab_size: int = 33
    d_model: int = 320
    num_layers: int = 6
    num_heads: int = 20
    max_len: int = 1024
    token_dropout: bool = True
    layer_norm_eps: float = 1e-5  # facebook/esm2 checkpoints use 1e-5


@dataclass(frozen=True)
class DPLMConfig:
    """Discrete-diffusion protein LM sampler."""

    vocab_size: int = 33
    d_model: int = 640
    num_layers: int = 12
    num_heads: int = 10
    max_len: int = 512
    num_diffusion_steps: int = 100
    layer_norm_eps: float = 1e-5  # matches ESM-2 checkpoints for warm-start
