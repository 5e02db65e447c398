"""clip-dplm-tpu on PyTorch and CUDA: the port beside the JAX package.

Module paths mirror `clip_dplm_tpu/`, so each module names its reference:

  ops/         -- attention, fused Dense+LN, InfoNCE and their hand-written
                  Hopper kernels (csrc/*.cu), each with a plain PyTorch
                  version used for CPU tensors
  models/      -- ESM-2 tower, DPLM trunk + sampler, the CLIP models, LoRA
                  adapters, the ProtT5 and RNABERT encoders (torch.nn)
  data/        -- ESM and ProtT5 tokenizers, synthetic data (numpy)
  train/       -- train state, fused AdamW, train/eval steps, Trainer
  utils/       -- flax params <-> state_dict conversion, pretrained bundles
  serving.py   -- micro-batched embed / generate services + HTTP server
  experiments/ -- the serve, train, embed, generate and bench CLIs, the
                  experiment registry

The package imports torch and numpy, never jax, flax or yaml.
"""

import torch

# f32 matmuls and convolutions stay full f32 on the card (no TF32 rounding),
# as the reference's f32 paths are: the f32 DPLM head and the f32 parity
# runs depend on it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
