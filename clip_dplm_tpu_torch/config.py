"""Configurations of the port: the serving path (`ESMConfig`, `DPLMConfig`)
and the train paths (`Config` and its leaves): the two-tower model
(`experiment="two_tower"`), the RNA<->RBP token transformer
(`experiment="rna_rbp"`), the RNA<->protein CLIP with an ESM-2 tower
(`experiment="esm_clip"`, `Config.esm`), the three-way cell <->
perturbation <-> protein CLIP (`experiment="tf_clip"`), the encoders with
OT-CFM flows between their latents (`experiment="triple_flow"`,
`Config.encoders`, `Config.flow`; `Config.icnn` configures the ICNN
transport maps) and the DPLM diffusion denoiser (`experiment="dplm"`,
`Config.dplm`).

The frozen dataclasses of `clip_dplm_tpu/config.py`, without the yaml loader
(so the port imports no yaml) and with only the fields the port reads: the
reference's `scan_layers` fields, the global-batch gather and the mesh are
left out until the port has what they switch on, and `precision.compute_dtype`,
`precision.param_dtype` and `data.num_workers` because nothing of the JAX
package reads them, so passing one raises instead of being ignored
(utils/pretrained.py reads a JAX-written config and holds each such field to
its default). `precision.remat` recomputes each tower block's forward in the
backward (`torch.utils.checkpoint`), as JAX's `nn.remat` does;
`train.steps_per_call` runs that many steps a call over stacked batches (the
ragged tail dropped) and `train.optim.fused_update=false` takes the unfused
optax chain (train/state.py::AdamWChain). The LoRA
fields of `esm` and `dplm` (`lora_rank`, `lora_alpha`, `lora_targets`,
models/lora.py) are ported: rank 0 disables them. `esm.frozen` freezes the
ESM tower of esm_clip. DPLM's `num_candidates` is
`clip_guided_sample`'s default K; its `guidance` and `guidance_scale` are
parsed so that a reference config loads, but no code of the port (nor of the
reference) reads them: soft guidance is asked for by passing a soft encoder
and its scale to models/guided_generation.py. The fused loss's saved raw similarity
(`contrastive.fused_materialize_raw`) is ported. The hard-negative cache
(`contrastive.use_cache`, `cache_size`) is ported: with
`contrastive.use_fused_kernel` it is the reference's `two_tower_optimized`
preset. The port's modules are always unrolled; utils/convert.py reads
both flax param layouts. Defaults are the reference's. `ProtT5Config` and
`RNABertConfig` configure the standalone ProtT5 and RNABERT encoders
(models/t5.py, models/rnabert.py). Checkpointing (`train.keep_checkpoints`,
`async_checkpoint`, `preemption_checkpoint`) and the `logging` section are
ported; the reference's step-interval fields (`eval_every_steps`,
`log_every_steps`, `checkpoint_every_steps`), which nothing of it reads, are
not.

`apply_overrides(cfg, ["a.b=c", ...])` replaces dotted fields, parsing each
value by the field's declared type (a tuple field from a JSON list, as the
reference parses it: `-o dplm.lora_targets='["q","k","v"]'`).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


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
    # esm_clip: the tower's output is detached and its subtree's update
    # zeroed (train/state.py::freeze_subtrees)
    frozen: bool = True
    # LoRA fine-tuning (models/lora.py): rank 0 disables. With rank > 0 the
    # base tower is frozen leaf by leaf (detached at use, no Adam moments)
    # and only the `<site>_lora` adapters train; targets are a subset of
    # {q, k, v, out, ffn_in, ffn_out}
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q", "v")


@dataclass(frozen=True)
class DPLMConfig:
    """Discrete-diffusion protein LM: the sampler's and the trainer's trunk
    (training reads the widths, max_len, layer_norm_eps and the LoRA fields)
    and the best-of-K of its guided sampler (`num_candidates`). `guidance`
    and `guidance_scale` are parsed for parity with the reference and read
    by nothing."""

    vocab_size: int = 33
    d_model: int = 640
    num_layers: int = 12
    num_heads: int = 10
    max_len: int = 512
    num_diffusion_steps: int = 100
    layer_norm_eps: float = 1e-5  # matches ESM-2 checkpoints for warm-start
    guidance_scale: float = 1.0
    guidance: str = "rerank"  # none | rerank | gradient
    num_candidates: int = 8  # best-of-K for rerank guidance
    # LoRA fine-tuning of the trunk (models/lora.py): rank 0 disables; with
    # rank > 0 the adapters, final_ln and lm_head train, the rest is frozen
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q", "v")


@dataclass(frozen=True)
class ProtT5Config:
    """ProtT5 encoder (the T5 v1.0 encoder stack of
    Rostlab/prot_t5_xl_half_uniref50-enc). Defaults are the xl geometry;
    models/t5.py::prot_t5_config_from_name has the published presets."""

    name: str = "prot_t5_xl"
    vocab_size: int = 128
    d_model: int = 1024
    d_ff: int = 16384
    num_layers: int = 24
    num_heads: int = 32
    d_kv: int = 128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    frozen: bool = True


@dataclass(frozen=True)
class RNABertConfig:
    """RNABERT-compatible RNA base encoder (models/rnabert.py). Defaults are
    the published RNABERT geometry: 120 wide, 6 post-LN layers of 12 heads,
    up to 440 bases."""

    name: str = "rnabert"
    vocab_size: int = 9
    d_model: int = 120
    num_layers: int = 6
    num_heads: int = 12
    d_ff: int = 40
    max_len: int = 440
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    frozen: bool = True


@dataclass(frozen=True)
class TowerConfig:
    """One encoder tower over a precomputed embedding vector."""

    input_dim: int = 158
    hidden_size: int = 512
    num_hidden_layers: int = 3
    num_attention_heads: int = 8  # transformer only
    architecture: str = "mlp"  # mlp | transformer | resnet
    activation: str = "relu"
    dropout: float = 0.1  # transformer only
    # the final Dense+act+LayerNorm through the fused kernel (ops/fused_dense.py;
    # on the card hidden_size a multiple of 8 up to its MAX_N = 65536)
    fused_dense: bool = False


@dataclass(frozen=True)
class ProjectionConfig:
    """Projection head into the shared space: `linear`, `base`
    (Linear-LN-GELU-Dropout-Linear-LN) or `optimized` (skip path + learnable
    layer scale, hidden = 4x dim by default)."""

    kind: str = "optimized"  # linear | base | optimized
    dim: int = 512
    hidden_dim: Optional[int] = None
    act: str = "gelu"  # gelu (tanh approximation) | gelu_exact | relu
    dropout: float = 0.1
    layer_scale_init: float = 1e-4
    # Dense+LN+GELU+dropout blocks through the fused kernel; act != "gelu"
    # takes the unfused modules. On the card its widths (hidden_dim and dim)
    # are multiples of 8 up to ops/fused_dense.MAX_N = 65536.
    fused_dense: bool = False
    l2_normalize_output: bool = False


@dataclass(frozen=True)
class ContrastiveConfig:
    """Symmetric InfoNCE with a learned (clamped) logit scale."""

    # infonce | flatnce | siglip | supcon (needs batch["labels"]); any other
    # value trains infonce, as in the JAX package
    loss_kind: str = "infonce"
    logit_scale_init: float = 2.6592  # == log(1/0.07)
    logit_scale_max: float = 100.0
    learned_temperature: bool = True
    temperature: float = 0.07  # used when not learned
    label_smoothing: float = 0.0
    use_fused_kernel: bool = False  # ops/fused_infonce.py
    # materialize the raw similarity (int16 fixed-point) in the fused forward
    # so the backward skips its recompute matmuls: "auto" | "always" | "never"
    fused_materialize_raw: str = "auto"
    cache_size: int = 8192  # hard-negative embedding cache (rows)
    use_cache: bool = False


@dataclass(frozen=True)
class TransformerTowerConfig:
    """Token-level transformer tower (rna_clip_codes.ipynb cell 28
    semantics): pre-LN blocks, 4x FFN, CLS or masked-mean pooling over padded
    variable-length token embeddings."""

    input_dim: int = 120
    d_model: int = 512
    num_layers: int = 3
    num_heads: int = 8
    ffn_mult: int = 4
    dropout: float = 0.1
    max_len: int = 512
    pooling: str = "cls"  # cls | first | mean
    # the blocks' LayerNorm output dtype; the stats are f32 either way
    ln_dtype: str = "float32"  # float32 | bfloat16


@dataclass(frozen=True)
class GNNConfig:
    """The PiGNN over the cell kNN graph (models/gnn.py): depth, heads and
    dropout (the layers are `encoders.latent_dim` wide, the edge state
    too)."""

    num_layers: int = 3
    num_heads: int = 8
    dropout: float = 0.1


@dataclass(frozen=True)
class EncoderConfig:
    """The encoders' widths. tf_clip reads `gene_dim` (the expression
    profile, plus a pseudotime column), `n_perturb_genes` (the top-DEG
    genes, each with its ESM embedding) and `esm_dim`; triple_flow's three
    encoders (models/tong_encoders.py) read every field."""

    latent_dim: int = 512
    gene_dim: int = 2000
    use_time_encoding: bool = True
    time_embed_dim: int = 128
    n_perturb_genes: int = 10
    esm_dim: int = 1280
    use_cross_attention: bool = True
    protein_hidden_dims: Tuple[int, ...] = (1024, 768)
    dropout: float = 0.1
    gnn: GNNConfig = field(default_factory=GNNConfig)


@dataclass(frozen=True)
class FlowConfig:
    """triple_flow's OT-CFM flows (models/flows.py): the pairing
    (`flow_type` exact_ot | sb | independent), the path's sigma, the vector
    field's widths and the regularizers (the `sb` pairing's entropic plan
    takes 2 sigma^2, as in the reference)."""

    flow_type: str = "exact_ot"  # exact_ot | sb | independent
    sigma: float = 0.1
    latent_dim: int = 512
    hidden_dim: int = 1024
    n_layers: int = 3
    dropout: float = 0.1
    use_time_embedding: bool = True
    time_embed_dim: int = 128
    use_path_length_reg: bool = True
    use_jacobian_reg: bool = False
    use_feature_mixing: bool = False
    sinkhorn_iters: int = 100


@dataclass(frozen=True)
class ICNNConfig:
    """Input-convex Brenier potentials and their transport maps
    (models/icnn.py; the maps take their widths from their inputs,
    `icnn_hessian` its `reg` from the caller)."""

    hidden_dims: Tuple[int, ...] = (512, 256, 128)
    activation: str = "softplus"  # softplus | celu
    use_layer_norm: bool = True
    # positive final weights and layer scales: Psi convex by construction
    strict_convex: bool = True
    init_scale: float = 0.1
    eps: float = 1e-6
    gradient_clip: float = 10.0
    sparsity_weight: float = 0.01
    consistency_weight: float = 0.1


@dataclass(frozen=True)
class LossWeights:
    """triple_flow's loss weights (models/triple_flow_model.py::
    compute_all_losses): the three-way InfoNCE, the flow-matching MSE and
    the flows' regularizers."""

    contrastive: float = 1.0
    flow: float = 1.0
    regularization: float = 0.1


@dataclass(frozen=True)
class OptimConfig:
    """Fused AdamW + global-norm clip + warmup-cosine / cosine / constant."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 1000
    total_steps: int = 100_000
    schedule: str = "warmup_cosine"  # warmup_cosine | cosine | constant
    min_lr_ratio: float = 0.0
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1
    moment_dtype: str = "float32"  # float32 | bfloat16
    clip_mode: str = "exact"  # exact | stale
    # the fused AdamW (default) or the optax chain clip -> adamw, kept for
    # equivalence (train/state.py::AdamWChain)
    fused_update: bool = True


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    num_epochs: int = 100
    # checkpoints kept in the checkpoint dir (the newest steps)
    keep_checkpoints: int = 3
    # copy the state to host memory and write it on a thread while training
    # goes on (train/checkpoint.py)
    async_checkpoint: bool = True
    # SIGTERM saves the live state at the step and ends training
    # (train/preemption.py)
    preemption_checkpoint: bool = True
    early_stopping_patience: int = 10
    seed: int = 42
    log_grad_norm: bool = False
    # train steps a call over a stacked group of batches; the ragged tail
    # group of an epoch is dropped (train/trainer.py)
    steps_per_call: int = 1
    loss_weights: LossWeights = field(default_factory=LossWeights)
    optim: OptimConfig = field(default_factory=OptimConfig)


@dataclass(frozen=True)
class PrecisionConfig:
    """`remat`: every tower block's forward is recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant), as JAX's `nn.remat` on the
    token towers' and ESM-2's blocks. The reference's `compute_dtype` and
    `param_dtype` are read by nothing there (its modules take their dtype
    from their own attribute), so the port holds them to their defaults
    (utils/pretrained.py::_UNPORTED)."""

    remat: bool = False


@dataclass(frozen=True)
class AugmentConfig:
    """Batch augmentation: triple_flow's gene dropout, edge dropout and
    perturbation-value noise (data/multimodal.py::DataAugmentation), and the
    Gaussian noise of two_tower's training rows with dataset=embeddings."""

    gene_dropout: float = 0.1
    edge_dropout: float = 0.15
    perturbation_noise: float = 0.05
    gaussian_noise: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    path: str = ""
    dataset: str = "synthetic"  # synthetic | embeddings (.npz with a, b)
    n_top_genes: int = 2000  # parsed; the synthetic cells take encoders.gene_dim genes
    augment: AugmentConfig = field(default_factory=AugmentConfig)


@dataclass(frozen=True)
class LoggingConfig:
    """Where the train CLI writes metrics.csv, train.log, config.yaml and
    (by default) ckpt/; wandb where it is installed; a torch.profiler trace
    of steps 11-15 into profile_dir (utils/logging.py)."""

    log_dir: str = "runs"
    use_wandb: bool = False
    profile: bool = False
    profile_dir: str = "runs/profile"


@dataclass(frozen=True)
class Config:
    """The experiments' configuration: `two_tower` reads tower_a/tower_b,
    `rna_rbp` the token towers rna_tower/rbp_tower, `esm_clip` rna_tower
    and esm, `tf_clip` encoders (its three encoders' depth, heads and
    dropout are module defaults, as in the reference), `triple_flow`
    encoders, flow, train.loss_weights and data.augment (and `icnn` for
    the transport maps of models/icnn.py), `dplm` the DPLM trunk."""

    experiment: str = "two_tower"  # two_tower | rna_rbp | esm_clip | tf_clip | triple_flow | dplm
    tower_a: TowerConfig = field(default_factory=TowerConfig)
    tower_b: TowerConfig = field(default_factory=lambda: TowerConfig(input_dim=1280))
    projection: ProjectionConfig = field(default_factory=ProjectionConfig)
    rna_tower: TransformerTowerConfig = field(default_factory=TransformerTowerConfig)
    rbp_tower: TransformerTowerConfig = field(
        default_factory=lambda: TransformerTowerConfig(input_dim=1280))
    esm: ESMConfig = field(default_factory=ESMConfig)
    encoders: EncoderConfig = field(default_factory=EncoderConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    icnn: ICNNConfig = field(default_factory=ICNNConfig)
    dplm: DPLMConfig = field(default_factory=DPLMConfig)
    contrastive: ContrastiveConfig = field(default_factory=ContrastiveConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)


def _parse(value: str, typ):
    if typ is bool:
        v = value.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {value!r}")
    if typ in (int, float, str):
        return typ(value)
    if typing.get_origin(typ) is tuple:  # Tuple[X, ...] from a JSON list
        items = json.loads(value)
        if not isinstance(items, list):
            raise ValueError(f"not a JSON list: {value!r}")
        (inner, _) = typing.get_args(typ)
        return tuple(inner(v) for v in items)
    if typing.get_origin(typ) is typing.Union:  # Optional[X]
        if value.strip().lower() in ("none", "null", ""):
            return None
        (inner,) = [a for a in typing.get_args(typ) if a is not type(None)]
        return _parse(value, inner)
    raise TypeError(f"cannot parse a value of type {typ}")


def replace_path(cfg, dotted: str, value: str):
    """Copy of `cfg` with the dotted field replaced by `value` (a string,
    parsed by the field's type). An unknown field raises KeyError."""
    head, _, rest = dotted.partition(".")
    hints = typing.get_type_hints(type(cfg))
    if head not in hints:
        raise KeyError(f"unknown config key {type(cfg).__name__}.{head}")
    if rest:
        sub = replace_path(getattr(cfg, head), rest, value)
    elif dataclasses.is_dataclass(hints[head]):
        raise KeyError(f"{dotted} is a section, not a field")
    else:
        sub = _parse(value, hints[head])
    return dataclasses.replace(cfg, **{head: sub})


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply overrides of the form `a.b.c=value` in order."""
    for item in overrides:
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not of the form key=value")
        cfg = replace_path(cfg, key.strip(), value.strip())
    return cfg


def create_experiment_configs(base: Config, sweep: str) -> List[Tuple[str, Config]]:
    """(name, config) of each variant of a named sweep, as the JAX package
    spawns them: embedding_sweep (projection.dim 32-512),
    architecture_search (both towers' architecture and depth: mlp 3,
    transformer 3, transformer 6, resnet 3), training_sweep (batch 32-256,
    then learning rate 1e-4, 3e-4, 1e-3) and temperature_sweep (a fixed
    temperature of 0.05, 0.07, 0.1, 0.2). An unknown sweep raises."""
    def put(cfg, dotted, value):
        return replace_path(cfg, dotted, str(value))

    out: List[Tuple[str, Config]] = []
    if sweep == "embedding_sweep":
        for dim in (32, 64, 128, 256, 512):
            out.append((f"proj_dim_{dim}", put(base, "projection.dim", dim)))
    elif sweep == "architecture_search":
        for arch, layers in (("mlp", 3), ("transformer", 3), ("transformer", 6), ("resnet", 3)):
            cfg = base
            for tower in ("tower_a", "tower_b"):
                cfg = put(cfg, f"{tower}.architecture", arch)
                cfg = put(cfg, f"{tower}.num_hidden_layers", layers)
            out.append((f"arch_{arch}_{layers}", cfg))
    elif sweep == "training_sweep":
        for bs in (32, 64, 128, 256):
            out.append((f"batch_{bs}", put(base, "train.batch_size", bs)))
        for lr in (1e-4, 3e-4, 1e-3):
            out.append((f"lr_{lr}", put(base, "train.optim.learning_rate", lr)))
    elif sweep == "temperature_sweep":
        for t in (0.05, 0.07, 0.1, 0.2):
            cfg = put(base, "contrastive.temperature", t)
            out.append((f"temp_{t}", put(cfg, "contrastive.learned_temperature", False)))
    else:
        raise ValueError(f"unknown sweep {sweep!r}")
    return out
