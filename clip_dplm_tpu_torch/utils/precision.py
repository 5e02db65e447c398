"""bf16 compute policy with explicit f32 islands.

Counterpart of `clip_dplm_tpu/utils/precision.py`, with torch dtypes: a
`Policy` names the dtype parameters are stored in and the dtype a module
computes in; `cast_to_compute` casts every floating tensor of a nested tree
(dicts, lists, tuples) to the compute dtype and leaves everything else (ints,
bools, non-tensors) as it is. bf16 shares f32's exponent range, so no loss
scaler is needed; the logit scale, the losses and the ICNN gradient stay f32
where the modules keep them.
"""

from __future__ import annotations

import dataclasses

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class Policy:
    """Casting policy for a module: params stored in param_dtype, compute in
    compute_dtype, losses and reductions in f32."""

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def compute(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def param(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def cast_to_compute(self, tree):
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [self.cast_to_compute(v) for v in tree]
            return type(tree)(out) if isinstance(tree, list) else tuple(out)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self.compute)
        return tree


FP32 = Policy(compute_dtype="float32", param_dtype="float32")
BF16 = Policy(compute_dtype="bfloat16", param_dtype="float32")
