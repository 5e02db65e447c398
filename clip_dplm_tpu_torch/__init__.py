"""clip-dplm-tpu on PyTorch and CUDA: the port beside the JAX package.

Module paths mirror `clip_dplm_tpu/`, so each module names its reference:

  ops/         -- attention and its hand-written Hopper kernels (csrc/*.cu),
                  each with a plain PyTorch version used for CPU tensors
  models/      -- ESM-2 tower and DPLM trunk + sampler (torch.nn)
  data/        -- ESM alphabet tokenizer (numpy)
  utils/       -- flax params -> state_dict conversion
  serving.py   -- micro-batched embed / generate services + HTTP server
  experiments/ -- the serve CLI

The package imports torch and numpy, never jax, flax or yaml.
"""

import torch

# f32 matmuls and convolutions stay full f32 on the card (no TF32 rounding),
# as the reference's f32 paths are: the f32 DPLM head and the f32 parity
# runs depend on it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
