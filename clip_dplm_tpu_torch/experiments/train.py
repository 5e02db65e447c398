"""Training CLI: `python -m clip_dplm_tpu_torch.experiments.train`.

Counterpart of `clip_dplm_tpu/experiments/train.py` for the experiments the
port has (two_tower, rna_rbp, esm_clip, tf_clip, triple_flow, dplm): dotted `-o a.b=c`
overrides on the default config (no yaml), then data -> model -> train
state -> Trainer on one device, the card unless `--device cpu` is given.
Prints one JSON line per epoch and a final summary line. `--retrieval`
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
"""

from __future__ import annotations

import argparse
import json
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
                   help="not ported yet: giving one raises")
    p.add_argument("--save-adapters", default=None, metavar="PATH",
                   help="after training, save only the LoRA adapter leaves to an .npz "
                        "(needs esm.lora_rank or dplm.lora_rank > 0)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, list]:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import Trainer, evaluate_retrieval

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
    n_params = sum(p.numel() for p in model.parameters())
    print(json.dumps({"experiment": cfg.experiment, "device": str(device),
                      "parameters": n_params}), flush=True)
    train_batches, val_batches = build_data(cfg)
    trainer = Trainer(cfg, state, checkpoint_dir=args.checkpoint_dir,
                      log_fn=lambda epoch, m: print(json.dumps({"epoch": epoch, **m}),
                                                    flush=True))
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
    print(json.dumps({"done": True, "train_loss": history["train_loss"],
                      "val_loss": history["val_loss"]}), flush=True)
    return history


if __name__ == "__main__":
    main()
