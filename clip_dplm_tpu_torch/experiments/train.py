"""Training CLI: `python -m clip_dplm_tpu_torch.experiments.train`.

Counterpart of `clip_dplm_tpu/experiments/train.py` for the experiments the
port has (two_tower, rna_rbp, esm_clip, tf_clip, triple_flow, dplm): dotted `-o a.b=c`
overrides on the default config (no yaml), then data -> model -> train
state -> Trainer on one device, the card unless `--device cpu` is given.
Prints one JSON line per epoch and a final summary line, and writes
`metrics.csv` (a row per epoch), `train.log` and `config.yaml` into
`logging.log_dir` (`runs` by default). The Trainer saves the state at each
new best epoch into `--checkpoint-dir` (`<log_dir>/ckpt` by default;
train/checkpoint.py), and at the step where SIGTERM stops it; `--resume`
restores the latest step there first (or trains fresh when there is none).
`-o logging.profile=true` writes a torch.profiler trace of steps 11-15 into
`logging.profile_dir`. `--retrieval`
prints the retrieval metrics of the validation split (R@1/5/10 both ways,
accuracy, mean rank; train/metrics.py) before training and after it.

  python -m clip_dplm_tpu_torch.experiments.train --epochs 3 \\
      -o tower_a.input_dim=256 -o tower_a.hidden_size=1024 \\
      -o tower_b.hidden_size=1024 -o train.batch_size=256
  python -m clip_dplm_tpu_torch.experiments.train --epochs 3 \\
      -o experiment=rna_rbp -o train.batch_size=256
  python -m clip_dplm_tpu_torch.experiments.train --epochs 3 \\
      -o experiment=tf_clip -o train.batch_size=256
  python -m clip_dplm_tpu_torch.experiments.train --epochs 3 -o experiment=dplm
  python -m clip_dplm_tpu_torch.experiments.train --epochs 3 \
      -o experiment=triple_flow -o train.batch_size=256 \
      -o contrastive.learned_temperature=false -o contrastive.temperature=0.1
  python -m clip_dplm_tpu_torch.experiments.train --epochs 3 --retrieval \
      -o experiment=esm_clip -o esm.frozen=false -o train.batch_size=64

LoRA fine-tuning (models/lora.py): `-o esm.lora_rank=8` (esm_clip) or
`-o dplm.lora_rank=8` (dplm) trains only the adapters (and DPLM's final_ln
and lm_head); `--save-adapters PATH` writes the adapter leaves alone to an
.npz after training, which the JAX package's `load_adapters_npz` reads:

  python -m clip_dplm_tpu_torch.experiments.train --epochs 3 -o experiment=dplm \
      -o dplm.lora_rank=8 -o 'dplm.lora_targets=["q","k","v","out"]' \
      --save-adapters adapters.npz

Resuming a run that stopped (preempted, or killed after a save):

  python -m clip_dplm_tpu_torch.experiments.train --epochs 10 \
      -o logging.log_dir=runs/cached -o contrastive.use_cache=true \
      -o contrastive.use_fused_kernel=true --resume
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--override", "-o", action="append", default=[],
                   help="dotted config override, e.g. -o train.batch_size=64")
    p.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--retrieval", action="store_true",
                   help="retrieval metrics of the validation split before and after "
                        "training (pair models)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="where checkpoints go (default <logging.log_dir>/ckpt)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in the checkpoint dir first")
    p.add_argument("--save-adapters", default=None, metavar="PATH",
                   help="after training, save only the LoRA adapter leaves to an .npz "
                        "(needs esm.lora_rank or dplm.lora_rank > 0)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, list]:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
    from clip_dplm_tpu_torch.train.trainer import Trainer, evaluate_retrieval
    from clip_dplm_tpu_torch.utils.logging import MetricLogger
    from clip_dplm_tpu_torch.utils.pretrained import write_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to train on the CPU)")
    cfg = apply_overrides(Config(), args.override)
    model = build_model(cfg, device=device)
    if args.save_adapters:
        from clip_dplm_tpu_torch.models.lora import has_lora_params

        if not has_lora_params(dict(model.named_parameters())):
            raise SystemExit("--save-adapters: the model has no LoRA adapters "
                             "(set esm.lora_rank or dplm.lora_rank)")
    state = create_train_state(model, cfg)
    log = MetricLogger(cfg.logging.log_dir, use_wandb=cfg.logging.use_wandb)
    write_config(cfg, os.path.join(cfg.logging.log_dir, "config.yaml"))
    n_params = sum(p.numel() for p in model.parameters())
    log.logger.info("experiment=%s device=%s parameters=%s", cfg.experiment, device,
                    f"{n_params:,}")
    print(json.dumps({"experiment": cfg.experiment, "device": str(device),
                      "parameters": n_params}), flush=True)
    train_batches, val_batches = build_data(cfg)
    ckpt_dir = args.checkpoint_dir or os.path.join(cfg.logging.log_dir, "ckpt")
    if args.resume:
        mgr = CheckpointManager(ckpt_dir)
        step = mgr.latest_step()
        if step is not None:
            t0 = time.perf_counter()
            mgr.restore(state, step)
            log.logger.info("resumed from step %d in %s", step, ckpt_dir)
            print(json.dumps({"resumed_from_step": step, "checkpoint_dir": ckpt_dir,
                              "restore_s": time.perf_counter() - t0}), flush=True)
        else:
            log.logger.info("no checkpoint to resume in %s; training fresh", ckpt_dir)
            print(json.dumps({"resumed_from_step": None, "checkpoint_dir": ckpt_dir}),
                  flush=True)

    def log_fn(epoch, m):
        print(json.dumps({"epoch": epoch, **m}), flush=True)
        log.log(epoch, m)

    trainer = Trainer(cfg, state, checkpoint_dir=ckpt_dir, log_fn=log_fn)
    rng = np.random.default_rng(cfg.train.seed)

    def retrieval(when):
        metrics = {k: float(v) for k, v in evaluate_retrieval(model, val_batches()).items()}
        print(json.dumps({"retrieval": when, **metrics}), flush=True)
        return metrics

    before = retrieval("untrained") if args.retrieval else None
    history = trainer.train(lambda: train_batches(seed=int(rng.integers(1 << 31))),
                            val_batches, num_epochs=args.epochs)
    if args.retrieval:
        history["retrieval_untrained"], history["retrieval"] = before, retrieval("trained")
    if args.save_adapters:
        from clip_dplm_tpu_torch.models.lora import save_adapters_npz

        n = save_adapters_npz(args.save_adapters, dict(model.named_parameters()))
        print(json.dumps({"adapters": args.save_adapters, "leaves": n}), flush=True)
    done = {"done": True, "train_loss": history["train_loss"],
            "val_loss": history["val_loss"], "step": trainer.state.step}
    if "preempted_at_step" in history:
        done["preempted_at_step"] = history["preempted_at_step"]
    log.logger.info("done at step %d: train_loss %s val_loss %s", trainer.state.step,
                    history["train_loss"][-1:], history["val_loss"][-1:])
    log.close()
    print(json.dumps(done), flush=True)
    return history


if __name__ == "__main__":
    main()
