"""Train and eval steps of the port's models, and the Trainer loop: the pair
family (TwoTowerCLIP, RNARBPCLIP and ESMProteinCLIP: any model whose forward
returns emb_a, emb_b and logit_scale; with the plain InfoNCE unless
contrastive.use_fused_kernel, as the reference's trainer picks it), the three-way tf_clip model (cell_embed,
pert_embed, protein_embed: the sum of the three pairs' losses), triple_flow
(models/triple_flow_model.py::compute_all_losses over the encoders' latents
and the OT-CFM flows, whose draws take the step's seeds) and DPLM (the
absorbing-state diffusion loss over batch["tokens"] and batch["mask"]).

Counterpart of `clip_dplm_tpu/train/trainer.py` for those families:
`make_loss_fn` (the per-family loss), `make_train_step`
(gradient accumulation over micro-batches, the fused AdamW, the optional
gradient-norm metric, the hard-negative cache of the pair family),
`make_multi_train_step` (`train.steps_per_call` steps a call over a
stacked group), `make_eval_step`, `evaluate_retrieval` (the retrieval
metrics of a split)
and a `Trainer` with the epoch loop, validation, early stopping,
checkpoints of each new best (train/checkpoint.py), the SIGTERM preemption
save (train/preemption.py) and the profiler hook (utils/logging.py). With
`contrastive.use_cache` every micro-batch's a->b direction reads the
state's cache as extra negative columns (its unfilled tail
masked), and after the optimizer the cache takes the step's normalized emb_b,
every micro-batch's in order; tf_clip neither reads nor writes it. PyTorch
runs eagerly, so there is no jit and no mesh; a step returns its metrics as
device tensors and never waits on the device (the cache's pointer and fill
level stay on the device too).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.data.prefetch import DevicePrefetcher
from clip_dplm_tpu_torch.models.dplm import diffusion_loss
from clip_dplm_tpu_torch.ops import infonce, loss_variants
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.ops.fused_infonce import fused_clip_loss, fused_multiway_clip_loss
from clip_dplm_tpu_torch.train.state import TrainState, global_norm


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy (or torch) batch -> tensors on `device`, dtypes kept (bool
    masks stay bool); a plain int (a graph batch's `num_graphs`, a size)
    stays an int. The copy is from pageable host memory, so it is
    synchronous: only data/prefetch.py's copies, from pinned memory on a
    stream of their own, overlap a step. The eval loop and
    `evaluate_retrieval` feed through it; the Trainer's train steps never
    do."""
    return {k: v if isinstance(v, int) else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def stack_batches(batches):
    """Stack same-shaped host batches along a new leading axis (a plain int
    stays one int, which must agree across the group)."""
    out = {}
    for k, v in batches[0].items():
        if isinstance(v, int):
            if any(b[k] != v for b in batches):
                raise ValueError(f"{k}: the group's ints differ, so they cannot be stacked")
            out[k] = v
        else:
            out[k] = np.stack([np.asarray(b[k]) for b in batches])
    return out


def _logit_scale(cfg: Config, out) -> torch.Tensor:
    cc = cfg.contrastive
    if cc.learned_temperature:
        return out["logit_scale"]
    return torch.tensor(math.log(1.0 / cc.temperature), device=out["logit_scale"].device)


def _pair_loss_fn(cfg: Config):
    """(model, batch, seeds, cache, cache_len) -> (loss, (metrics, emb_b))
    of the two-tower families, by contrastive.loss_kind: "flatnce",
    "siglip" (ops/loss_variants.py, no logit bias), "supcon" (the
    cross-modal supervised loss over batch["labels"]), and any other value
    InfoNCE, as the JAX package's chain of ifs trains it: the fused loss
    (bf16 similarity operands) or the plain one, with the hard-negative
    cache's columns when contrastive.use_cache is set. The variants read no
    cache. emb_b is the batch's L2-normalized b embedding, detached, for the
    cache (None without one), whatever the kind."""
    cc = cfg.contrastive

    def loss_fn(model, batch, seeds: DropoutSeeds, cache=None, cache_len=None):
        if not cc.use_cache:
            cache = cache_len = None
        out = model(batch, deterministic=False, seeds=seeds)
        ls = _logit_scale(cfg, out)
        if cc.loss_kind == "supcon":
            if "labels" not in batch:
                raise ValueError("supcon loss requires `labels` in the batch")
            loss, metrics = loss_variants.supcon_pair_loss(
                out["emb_a"], out["emb_b"], batch["labels"], ls, max_scale=cc.logit_scale_max)
        elif cc.loss_kind == "flatnce":
            loss, metrics = loss_variants.flatnce_loss(out["emb_a"], out["emb_b"], ls,
                                                       max_scale=cc.logit_scale_max)
        elif cc.loss_kind == "siglip":
            loss, metrics = loss_variants.siglip_loss(out["emb_a"], out["emb_b"], ls,
                                                      max_scale=cc.logit_scale_max)
        elif cc.use_fused_kernel:
            loss, metrics = fused_clip_loss(
                out["emb_a"], out["emb_b"], ls, max_scale=cc.logit_scale_max,
                dot_dtype=torch.bfloat16, label_smoothing=cc.label_smoothing,
                assume_normalized=cfg.projection.l2_normalize_output,
                cache=cache, cache_len=cache_len, materialize_raw=cc.fused_materialize_raw)
        else:
            loss, metrics = infonce.clip_loss(out["emb_a"], out["emb_b"], ls,
                                              label_smoothing=cc.label_smoothing,
                                              max_scale=cc.logit_scale_max,
                                              cache=cache, cache_len=cache_len)
        emb_b = infonce.l2_normalize(out["emb_b"].detach()) if cc.use_cache else None
        return loss, (metrics, emb_b)

    return loss_fn


def _embeddings(out) -> Dict[str, torch.Tensor]:
    return {"cell": out["cell_embed"], "pert": out["pert_embed"],
            "protein": out["protein_embed"]}


def _multiway_loss_fn(cfg: Config):
    """(model, batch, seeds, cache, cache_len) -> (loss, (metrics, None)) of
    tf_clip: the sum of the pairwise symmetric losses over cell / pert /
    protein, fused (bf16 similarity operands) or plain, whatever
    contrastive.loss_kind says (as in the JAX package). The cache is not
    read, and nothing is given back for it."""
    cc = cfg.contrastive

    def loss_fn(model, batch, seeds: DropoutSeeds, cache=None, cache_len=None):
        del cache, cache_len
        out = model(batch, deterministic=False, seeds=seeds)
        ls = _logit_scale(cfg, out)
        if cc.use_fused_kernel:
            loss, metrics = fused_multiway_clip_loss(
                _embeddings(out), ls, max_scale=cc.logit_scale_max, dot_dtype=torch.bfloat16,
                label_smoothing=cc.label_smoothing, materialize_raw=cc.fused_materialize_raw)
        else:
            loss, metrics = infonce.multiway_clip_loss(
                _embeddings(out), ls, max_scale=cc.logit_scale_max,
                label_smoothing=cc.label_smoothing)
        return loss, (metrics, None)

    return loss_fn


def _dplm_loss_fn(cfg: Config):
    """(model, batch, seeds, cache, cache_len) -> (loss, (metrics, None)) of
    DPLM: the diffusion loss of one corruption drawn from the step's seeds
    (models/dplm.py::diffusion_loss). The cache is not read."""

    def loss_fn(model, batch, seeds: DropoutSeeds, cache=None, cache_len=None):
        del cache, cache_len
        loss, metrics = diffusion_loss(model, batch["tokens"], seeds, batch.get("mask"))
        return loss, (metrics, None)

    return loss_fn


def _triple_flow_loss_fn(cfg: Config):
    """(model, batch, seeds, cache, cache_len) -> (loss, (metrics, None)) of
    triple_flow: compute_all_losses over the model's training forward, whose
    dropout and flow draws take the step's seeds. The cache is not read."""
    from clip_dplm_tpu_torch.models.triple_flow_model import compute_all_losses

    def loss_fn(model, batch, seeds: DropoutSeeds, cache=None, cache_len=None):
        del cache, cache_len
        loss, metrics = compute_all_losses(model(batch, seeds, deterministic=False), cfg)
        return loss, (metrics, None)

    return loss_fn


def make_loss_fn(cfg: Config):
    """The experiment family's loss: (model, batch, seeds, cache=None,
    cache_len=None) -> (loss, (metrics, emb_b for the cache or None))."""
    if cfg.experiment == "tf_clip":
        return _multiway_loss_fn(cfg)
    if cfg.experiment == "triple_flow":
        return _triple_flow_loss_fn(cfg)
    if cfg.experiment == "dplm":
        return _dplm_loss_fn(cfg)
    return _pair_loss_fn(cfg)


def make_train_step(cfg: Config) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """step(state, batch) -> (state, metrics). With grad_accum_steps > 1 the
    batch is cut into that many micro-batches whose gradients, losses and
    metrics are averaged. Dropout seeds: (state.key, step * accum + micro).
    With contrastive.use_cache every micro-batch reads the cache as it was
    before the step, which then takes every micro-batch's normalized emb_b,
    in order, after the optimizer (ops/infonce.py::update_cache)."""
    loss_fn = make_loss_fn(cfg)
    accum = max(1, cfg.train.optim.grad_accum_steps)
    if accum > 1 and cfg.experiment == "triple_flow":
        raise ValueError("grad_accum_steps > 1 is not supported for triple_flow: its graph "
                         "batch cannot be cut into micro-batches along the first axis "
                         "(edge_index is (2, E) and indexes the whole batch's nodes)")
    log_grad_norm = cfg.train.log_grad_norm
    use_cache = cfg.contrastive.use_cache

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if use_cache and state.cache is None:
            raise ValueError("contrastive.use_cache is set but the state has no cache "
                             "(create it with create_train_state from this config)")
        model = state.model
        params = state.params()
        for p in params.values():
            p.grad = None
        B = next(iter(batch.values())).shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not divisible by grad_accum_steps={accum}")
        mb = B // accum
        loss_sum, metrics_sum, new_b = None, None, []
        for i in range(accum):
            micro = batch if accum == 1 else {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, (metrics, emb_b) = loss_fn(
                model, micro, DropoutSeeds(state.key, state.step * accum + i),
                state.cache, state.cache_len)
            if emb_b is not None:
                new_b.append(emb_b)
            loss.backward()
            loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
            if loss_sum is None:
                loss_sum, metrics_sum = loss, metrics
            else:
                loss_sum = loss_sum + loss
                metrics_sum = {k: metrics_sum[k] + v for k, v in metrics.items()}
        # a leaf the masked optimizer leaves out (a frozen LoRA base) and
        # that took no gradient needs no zeros either
        tx = state.tx
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()
                 if p.grad is not None or not (tx.mask_moments and tx.is_frozen(k))}
        if accum > 1:
            inv = 1.0 / accum
            grads = {k: g * inv for k, g in grads.items()}
            loss_sum = loss_sum * inv
            metrics_sum = {k: v * inv for k, v in metrics_sum.items()}
        state.tx.update(grads, state.opt_state, params)
        state.step += 1
        if use_cache and new_b:
            state.cache, state.cache_ptr, state.cache_len = infonce.update_cache(
                state.cache, state.cache_ptr, torch.cat(new_b), state.cache_len)
        metrics = dict(metrics_sum)
        metrics["loss"] = loss_sum
        if log_grad_norm:
            metrics["grad_norm"] = global_norm(grads.values())
        for p in params.values():
            p.grad = None
        return state, metrics

    return step


def make_multi_train_step(cfg: Config, steps_per_call: int
                          ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """multi(state, stacked) -> (state, metrics of the last step): the
    `steps_per_call` steps of a stacked group (`stack_batches`, leading
    axis = step) in turn, as the JAX package's `lax.scan` runs them."""
    step = make_train_step(cfg)

    def multi(state: TrainState, batches: Dict) -> Tuple[TrainState, Dict]:
        metrics = None
        for i in range(steps_per_call):
            state, metrics = step(state, {k: v if isinstance(v, int) else v[i]
                                          for k, v in batches.items()})
        return state, metrics

    return multi


def make_eval_step(cfg: Config) -> Callable[[TrainState, Dict], Dict]:
    """Deterministic forward and the loss (no label smoothing): InfoNCE
    whatever contrastive.loss_kind is, as the JAX package's eval computes
    it; tf_clip takes the plain multiway loss, as the reference's eval does. The fused loss
    saves no raw similarity here, nor the packed attention its
    probabilities: no backward would read them. DPLM's eval draws its
    corruption, and triple_flow's its flows' pairings and (t, eps), from the
    state's (key, step) without advancing the state, so both are
    deterministic given the state."""
    cc = cfg.contrastive

    @torch.no_grad()
    def step(state: TrainState, batch: Dict) -> Dict:
        if cfg.experiment == "dplm":
            loss, metrics = diffusion_loss(state.model, batch["tokens"],
                                           DropoutSeeds(state.key, state.step), batch.get("mask"))
            return {**metrics, "loss": loss}
        if cfg.experiment == "triple_flow":
            from clip_dplm_tpu_torch.models.triple_flow_model import compute_all_losses

            out = state.model(batch, DropoutSeeds(state.key, state.step), deterministic=True)
            loss, metrics = compute_all_losses(out, cfg)
            return {**metrics, "loss": loss}
        out = state.model(batch, deterministic=True)
        ls = _logit_scale(cfg, out)
        if cfg.experiment == "tf_clip":
            loss, metrics = infonce.multiway_clip_loss(_embeddings(out), ls,
                                                       max_scale=cc.logit_scale_max)
        elif cc.use_fused_kernel:
            loss, metrics = fused_clip_loss(
                out["emb_a"], out["emb_b"], ls, max_scale=cc.logit_scale_max,
                dot_dtype=torch.bfloat16,
                assume_normalized=cfg.projection.l2_normalize_output, materialize_raw=False)
        else:
            loss, metrics = infonce.clip_loss(out["emb_a"], out["emb_b"], ls,
                                              label_smoothing=0.0,
                                              max_scale=cc.logit_scale_max)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step


@torch.no_grad()
def evaluate_retrieval(model, batches: Iterable[Dict]) -> Dict[str, torch.Tensor]:
    """Retrieval metrics (train/metrics.py) of a pair model over a split:
    the deterministic emb_a and emb_b of every batch, concatenated, row i
    of one the positive of row i of the other."""
    from clip_dplm_tpu_torch.train.metrics import retrieval_metrics

    was_training = model.training
    model.eval()
    outs = [model(to_device(b, model.device), deterministic=True) for b in batches]
    model.train(was_training)
    if not outs:
        raise ValueError("no batch to evaluate")
    return retrieval_metrics(torch.cat([o["emb_a"] for o in outs]),
                             torch.cat([o["emb_b"] for o in outs]))


class EarlyStopping:
    """Patience-based early stopping on a value to minimise."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience, self.min_delta = patience, min_delta
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def update(self, value: float) -> bool:
        """True if `value` is a new best."""
        if self.best is None or value < self.best - self.min_delta:
            self.best, self.counter = value, 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.should_stop = True
        return False


class Trainer:
    """Epoch loop: train steps over fresh batch iterators, the mean train
    loss (one host read per epoch), validation, early stopping and a log
    callback (epoch, {train_loss, val_loss, epoch_seconds}), as the JAX
    package's Trainer. With a `checkpoint_dir` it saves the state at every
    new best of the monitored loss (validation, else train), keeping
    `train.keep_checkpoints` steps, written on a thread under
    `train.async_checkpoint`; with `train.preemption_checkpoint` too, SIGTERM
    saves the live state at the step and ends training. `logging.profile`
    traces steps 11-15 (utils/logging.py::ProfilerHook).

    Train batches always come through a `data/prefetch.py::DevicePrefetcher`
    (made each epoch, closed in a `finally`): the next batch is collated and
    copied on a background thread while the current step runs. With
    `train.steps_per_call` > 1 the batches are stacked in groups of that
    many (the ragged tail group dropped), each group is one call of
    `make_multi_train_step`, the epoch's train loss is the mean of each
    call's last-step loss and the Trainer's step count rises by the group's
    size. `prefetch_wait_seconds` sums the time the steps waited for a
    batch. Validation batches are copied serially (`to_device`), as the JAX
    package puts them."""

    def __init__(self, cfg: Config, state: TrainState,
                 checkpoint_dir: Optional[str] = None,
                 log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None):
        self.cfg, self.state, self.log_fn = cfg, state, log_fn
        self.device = state.model.device
        self.steps_per_call = max(1, cfg.train.steps_per_call)
        self.train_step = (make_multi_train_step(cfg, self.steps_per_call)
                           if self.steps_per_call > 1 else make_train_step(cfg))
        self.eval_step = make_eval_step(cfg)
        self.history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        self._ckpt = None
        if checkpoint_dir:
            from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(checkpoint_dir, keep=cfg.train.keep_checkpoints,
                                           async_save=cfg.train.async_checkpoint)
        self._profiler = None
        if cfg.logging.profile:
            from clip_dplm_tpu_torch.utils.logging import ProfilerHook

            self._profiler = ProfilerHook(cfg.logging.profile_dir)
        self._global_step = 0
        self.prefetch_wait_seconds = 0.0

    def _grouped(self, batches: Iterable):
        """Stacked groups of `steps_per_call` batches (the ragged tail group
        is dropped); the batches themselves when it is 1."""
        if self.steps_per_call <= 1:
            yield from batches
            return
        group = []
        for b in batches:
            group.append(b)
            if len(group) == self.steps_per_call:
                yield stack_batches(group)
                group = []

    def train(self, train_batches: Callable[[], Iterable],
              val_batches: Optional[Callable[[], Iterable]] = None,
              num_epochs: Optional[int] = None, preemption_guard=None) -> Dict[str, list]:
        """Run the epoch loop. With a checkpoint dir and
        `train.preemption_checkpoint`, SIGTERM makes one save of the live
        state at its step, appends the Trainer's step count to
        history["preempted_at_step"] and returns; `preemption_guard` (a
        PreemptionGuard of the caller's) replaces the installed one."""
        num_epochs = num_epochs or self.cfg.train.num_epochs
        stopper = EarlyStopping(self.cfg.train.early_stopping_patience)
        guard, installed = preemption_guard, False
        if guard is None and self._ckpt is not None and self.cfg.train.preemption_checkpoint:
            from clip_dplm_tpu_torch.train.preemption import PreemptionGuard

            guard, installed = PreemptionGuard().install(), True
        try:
            self._train_epochs(train_batches, val_batches, num_epochs, stopper, guard)
        finally:
            if installed:
                guard.uninstall()
            if self._profiler is not None:
                self._profiler.close()
            if self._ckpt is not None:
                self._ckpt.wait()  # an async save is on disk before training returns
        return self.history

    def _train_epochs(self, train_batches, val_batches, num_epochs, stopper, guard) -> None:
        for epoch in range(num_epochs):
            t0 = time.time()
            losses = []
            self.state.model.train()
            prefetcher = DevicePrefetcher(self._grouped(train_batches()), self.device, depth=2)
            try:
                for batch in prefetcher:
                    self.state, metrics = self.train_step(self.state, batch)
                    losses.append(metrics["loss"])
                    self._global_step += self.steps_per_call
                    if self._profiler is not None:
                        self._profiler.step(self._global_step)
                    if guard is not None and guard.requested_globally():
                        if self._ckpt is not None:
                            self._ckpt.save(self.state, self.state.step)
                        self.history.setdefault("preempted_at_step", []).append(
                            self._global_step)
                        return
            finally:
                # also on an exception out of a step: the worker would
                # otherwise hold `depth` device batches until it is reaped
                prefetcher.close()
                self.prefetch_wait_seconds += prefetcher.wait_seconds
            if not losses:
                raise ValueError("the training set gave no batch, or fewer than "
                                 "train.steps_per_call (batch_size larger than the set?)")
            train_loss = float(torch.stack(losses).mean())
            self.history["train_loss"].append(train_loss)
            val_loss = None
            if val_batches is not None:
                self.state.model.eval()
                vals = [self.eval_step(self.state, to_device(b, self.device))["loss"]
                        for b in val_batches()]
                if vals:
                    val_loss = float(torch.stack(vals).mean())
                    self.history["val_loss"].append(val_loss)
            if self.log_fn:
                self.log_fn(epoch, {
                    "train_loss": train_loss,
                    "val_loss": val_loss if val_loss is not None else float("nan"),
                    "epoch_seconds": time.time() - t0})
            is_best = stopper.update(val_loss if val_loss is not None else train_loss)
            if self._ckpt is not None and is_best:
                self._ckpt.save(self.state, self.state.step)
            if stopper.should_stop:
                break
