"""The A/B harness of the package's GEMM (`experiments/gemm_ab.py`) on the
CPU: the plain product it holds both checkouts to rounds as each of the
GEMM's epilogues does, bit for bit as the package's own plain versions (the
fused Dense forward's u, the attention out-projection, the dO product), and
its shapes cover `chip_smoke.py`'s B=8192 Dense geometries in both
directions. Needs no card."""

import numpy as np
import torch

import chip_smoke
from clip_dplm_tpu_torch.experiments import gemm_ab
from clip_dplm_tpu_torch.ops import fused_dense as fd
from clip_dplm_tpu_torch.ops import short_attention as sa


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).bfloat16()


def test_plain_round_is_the_fused_dense_forward_product():
    """bf16(bf16(x·W^T) + b): the u the fused Dense block's plain forward
    saves (order ln_act, so u is the pre-activation)."""
    rng = np.random.default_rng(0)
    x, w, b = _bf16(rng, 40, 96), _bf16(rng, 136, 96, scale=0.1), _bf16(rng, 136)
    spec = fd._Spec("ln_act", "none", 0.0, 0, torch.bfloat16, torch.bfloat16, False)
    u = fd._plain_fwd(spec, x, w, b, torch.ones(136), torch.zeros(136), None, None)[1]
    assert torch.equal(gemm_ab.plain(x, w, b, False, "round"), u)


def test_plain_once_is_the_out_projection_reference():
    """bf16(o·Wo^T + bo) with one rounding."""
    rng = np.random.default_rng(1)
    o, wo, bo = _bf16(rng, 33, 64), _bf16(rng, 64, 64, scale=0.1), _bf16(rng, 64)
    assert torch.equal(gemm_ab.plain(o, wo, bo, False, "once"),
                       sa.out_projection_reference(o, wo, bo))


def test_plain_none_is_the_dout_product():
    """dO = bf16(dy·Wo), B row-major (MN-major), no bias."""
    rng = np.random.default_rng(2)
    dy, wo = _bf16(rng, 2, 17, 64), _bf16(rng, 64, 48, scale=0.1)
    assert torch.equal(gemm_ab.plain(dy.reshape(-1, 64), wo, None, True, "none"),
                       sa._dout(dy, wo).reshape(-1, 48))


def test_shapes_cover_the_smoke_dense_geometries_both_ways():
    shapes = {case[1:] for case in gemm_ab.SHAPES}
    big = [(B, K, N) for _, B, K, N, *_ in chip_smoke.FD_GEOMETRIES if B == 8192]
    assert len(big) == 4
    for B, K, N in big:
        assert (B, K, N, False, "round") in shapes  # u = x·W^T + b
        assert (B, N, K, True, "none") in shapes  # dx = du·W
