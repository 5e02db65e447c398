"""The port's CUDA kernels against their plain PyTorch versions on the card,
in bf16 at the JAX suite's bf16 bound (atol = rtol = 2e-2; gradients
divided by their largest entry first), with ragged and fully masked rows,
ragged batches and odd widths, and the dropout mask bit for bit; the
backward kernels on the plain forward's residuals and the autograd
Functions against autograd of the plain formulation; and the forward-only
kernels' refusal to run where autograd would record them. Every test here
needs an NVIDIA GPU and skips without one. The file imports no JAX, so on the card, which has none, it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import flash_attention as fa
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops import tiny_attention as ta
from clip_dplm_tpu_torch.ops.attention import (
    attention_dispatch,
    attention_reference,
    multihead_attention,
    split_heads,
)
from clip_dplm_tpu_torch.ops import fused_dense as fd
from clip_dplm_tpu_torch.ops import fused_infonce as fi
from clip_dplm_tpu_torch.ops.flash_attention import flash_attention
from clip_dplm_tpu_torch.ops.short_attention import (
    fused_short_attention_qkv_proj,
    fused_short_attention_qkv_proj_reference,
    out_projection,
    out_projection_reference,
    short_attention_qkv,
)

TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def np_rng():
    return np.random.default_rng(0)


def _ragged_mask(rng, B, S):
    lens = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    mask[-1] = False  # one row with no real key
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H", [(4, 128, 640, 10), (2, 100, 256, 2),
                                     (3, 64, 96, 4), (2, 200, 1280, 20),
                                     (2, 256, 1024, 8)])
def test_short_attention_matches_plain(cuda_device, np_rng, B, S, D, H):
    qkv = torch.from_numpy(np_rng.normal(size=(B, S, 3 * D)).astype(np.float32))
    wo = torch.from_numpy((np_rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32))
    bo = torch.from_numpy((np_rng.normal(size=(D,)) * 0.1).astype(np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    wo, bo = wo.to(cuda_device), bo.to(cuda_device)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    pos = torch.arange(S, device=cuda_device)
    before = _build.LAUNCHES.snapshot()
    got = fused_short_attention_qkv_proj(qkv, wo, bo, H, mask=mask,
                                         rope_positions=pos)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["short_attention"] == before["short_attention"] + 1
    assert after["short_attention_out_proj"] == before["short_attention_out_proj"] + 1
    want = fused_short_attention_qkv_proj_reference(qkv, wo, bo, H, mask=mask,
                                                    rope_positions=pos)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D", [(64, 64), (100, 104), (4096, 640), (33, 1280)])
def test_out_projection_matches_plain(cuda_device, np_rng, M, D):
    """The GEMM alone, at ragged M and a K that is no multiple of its 64-wide
    k step."""
    o = torch.from_numpy(np_rng.normal(size=(M, D)).astype(np.float32))
    wo = torch.from_numpy((np_rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32))
    bo = torch.from_numpy(np_rng.normal(size=(D,)).astype(np.float32))
    o, wo, bo = o.to(cuda_device, torch.bfloat16), wo.to(cuda_device), bo.to(cuda_device)
    got = out_projection(o, wo, bo)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), out_projection_reference(o, wo, bo).float(),
                               **TOL)


def _gemm_plain(a, b, bias, b_row, epilogue):
    """The GEMM's plain version: the product in f32, then the epilogue's
    roundings ("round": bf16(bf16(acc) + bias), "once": bf16(acc + bias),
    "none": bf16(acc))."""
    acc = a.float() @ (b.float() if b_row else b.float().t())
    if epilogue == "round":
        return (acc.bfloat16().float() + bias.float()).bfloat16()
    if epilogue == "once":
        return (acc + bias.float()).bfloat16()
    return acc.bfloat16()


def _gemm_launch(a, b, bias, n_cols, b_row, epilogue):
    """One launch through the C entry that has the epilogue: fused_dense_gemm
    (the bias added after a rounding, or none; either B layout), or
    short_attention_out_proj (one rounding; B K-major)."""
    if epilogue != "once":
        return fd._gemm(a, b, bias if epilogue == "round" else None, n_cols, b_row)
    assert not b_row
    c = torch.empty(a.shape[0], n_cols, dtype=torch.bfloat16, device=a.device)
    _build.launch("short_attention_out_proj", a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                  c.data_ptr(), a.shape[0], n_cols, a.shape[1], _build.stream_of(a))
    return c


# M, Kr, Nc, B row-major (MN-major) or given transposed (K-major), epilogue
GEMM_CASES = [
    # M under one warpgroup's 64 rows, ragged M, Kr no multiple of the 64-wide
    # k step, Nc no multiple of the 128-wide tile, each epilogue in each layout
    (1, 104, 640, False, "round"), (1, 1000, 520, True, "none"),
    (33, 1000, 640, False, "once"), (33, 104, 520, True, "round"),
    (1000, 104, 520, False, "none"), (1000, 1000, 640, True, "none"),
    (1000, 1000, 520, False, "once"), (1000, 104, 640, True, "round"),
    (64, 8, 136, False, "round"), (130, 72, 8, True, "none"),
] + [  # the smoke's FD_GEOMETRIES: u = x·W^T + b, then dx = du·W
    case for B, K, N in ((8192, 1024, 1024), (8192, 1024, 2048), (8192, 2048, 2048),
                         (8192, 2048, 512), (1000, 1024, 2048))
    for case in ((B, K, N, False, "round"), (B, N, K, True, "none"))
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kr,Nc,b_row,epilogue", GEMM_CASES)
def test_dense_gemm_matches_plain(cuda_device, np_rng, M, Kr, Nc, b_row, epilogue):
    """The GEMM against the f32 product rounded as its epilogue says, in both
    B layouts; two launches equal byte for byte; one launch counted a call."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(cuda_device)  # noqa: E731
    a = f(M, Kr).bfloat16()
    b = (f(Kr, Nc) if b_row else f(Nc, Kr)).div(np.sqrt(Kr)).bfloat16()
    bias = f(Nc).bfloat16()
    before = _build.LAUNCHES.snapshot()["fused_dense_gemm"]
    got = _gemm_launch(a, b, bias, Nc, b_row, epilogue)
    again = _gemm_launch(a, b, bias, Nc, b_row, epilogue)
    torch.cuda.synchronize()
    if epilogue != "once":
        assert _build.LAUNCHES.snapshot()["fused_dense_gemm"] == before + 2
    assert got.shape == (M, Nc) and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), _gemm_plain(a, b, bias, b_row, epilogue).float(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Sk,Dh,masked", [
    # the first five shapes (Dp = 64, 64, 64, 128, 256)
    (2, 4, 256, 256, 64, True), (2, 3, 300, 300, 40, True), (1, 2, 1000, 1000, 64, True),
    (1, 2, 333, 333, 128, True), (2, 2, 257, 257, 256, True),
    # ESM-2 8M, 35M and 150M head widths in the Dp = 64 template; Dh = 20
    # stages element by element
    (2, 3, 200, 200, 16, True), (2, 2, 150, 150, 20, True), (1, 4, 300, 300, 24, True),
    (2, 2, 260, 260, 32, True),
    # fewer query rows than a block; Sk != S both ways; no mask
    (3, 2, 1, 1, 64, True), (2, 2, 1, 300, 64, True), (2, 2, 70, 70, 64, True),
    (2, 2, 130, 300, 64, True), (1, 2, 500, 77, 128, True), (2, 2, 300, 300, 64, False),
    (1, 2, 190, 190, 200, False), (1, 2, 129, 129, 72, True)])
def test_flash_attention_matches_plain(cuda_device, np_rng, B, H, S, Sk, Dh, masked):
    """The forward's out and lse against the plain version; one row with no
    real key (uniform weights, lse near -1e30); two launches equal byte for
    byte."""
    q = torch.from_numpy(np_rng.normal(size=(B, H, S, Dh)).astype(np.float32))
    k, v = (torch.from_numpy(np_rng.normal(size=(B, H, Sk, Dh)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    mask = (torch.from_numpy(_ragged_mask(np_rng, B, Sk)).to(cuda_device) if masked
            else None)
    before = _build.LAUNCHES.snapshot()["flash_attention"]
    with torch.no_grad():
        got = flash_attention(q, k, v, mask=mask)
        again, lse = fa._flash_forward(q, k, v, mask, None)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot()["flash_attention"] == before + 2
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(),
                               attention_reference(q, k, v, mask=mask).float(), **TOL)
    torch.testing.assert_close(lse, fa.flash_lse_reference(q, k, mask), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_attention_misaligned_views_match_aligned(cuda_device, np_rng, Dh):
    """q, k, v as contiguous views whose base is off 16 bytes: the kernel
    stages them by elements instead of by TMA, into the same layout, so the
    output equals the aligned tensors' byte for byte."""
    B, H, S = 2, 3, 200
    n = B * H * S * Dh
    aligned = [torch.from_numpy(np_rng.normal(size=(B, H, S, Dh)).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3)]
    views = []
    for t in aligned:
        buf = torch.empty(n + 1, device=cuda_device, dtype=torch.bfloat16)
        view = buf[1:].view(B, H, S, Dh)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        views.append(view)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    with torch.no_grad():
        got, lse = fa._flash_forward(*views, mask, None)
        want, lse_want = fa._flash_forward(*aligned, mask, None)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(lse, lse_want)
    torch.testing.assert_close(got.float(), attention_reference(*aligned, mask=mask).float(),
                               **TOL)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    qkv = torch.zeros(2, 64, 3 * 64, device=cuda_device)  # f32: not bf16
    w, b = torch.zeros(64, 64, device=cuda_device), torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        fused_short_attention_qkv_proj(qkv, w, b, 2)
    q = torch.zeros(1, 1, 256, 512, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh <="):
        flash_attention(q, q, q)


def _grads_close(got, want, names):
    for name, a, b in zip(names, got, want):
        scale = max(b.abs().max().item(), 1e-30)
        torch.testing.assert_close(a.float() / scale, b.float() / scale, msg=name, **TOL)


def _fused_dense_run(fn, x, w, b, g, bt, skip, ls, dy, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, g, bt)]
    extra = [] if skip is None else [t.clone().requires_grad_(True) for t in (skip, ls)]
    kwx = dict(kw, skip=extra[0], layer_scale=extra[1]) if extra else kw
    y = fn(*leaves, **kwx)
    y.backward(dy.to(y.dtype))
    return y.detach(), [t.grad for t in leaves + extra]


FD_CASES = [  # B, K, N, order, act, rate, skip, l2
    (40, 96, 128, "ln_act", "gelu", 0.0, False, False),
    (1000, 96, 256, "ln_act", "gelu", 0.1, False, False),
    (40, 3, 128, "ln_act", "none", 0.0, False, False),
    (333, 200, 256, "ln_act", "relu", 0.0, False, False),
    (40, 96, 136, "ln_act", "silu", 0.0, False, False),
    (40, 96, 128, "ln_act", "tanh", 0.0, False, False),
    (40, 96, 128, "act_ln", "relu", 0.0, False, False),
    (257, 1024, 1024, "act_ln", "relu", 0.0, False, False),
    (40, 96, 128, "act_ln", "gelu", 0.0, False, False),
    (40, 96, 128, "act_ln", "silu", 0.0, False, False),
    (40, 96, 128, "act_ln", "tanh", 0.0, False, False),
    (40, 96, 128, "act_ln", "none", 0.0, False, False),
    (129, 256, 128, "ln_act", "none", 0.0, True, False),
    (129, 256, 128, "ln_act", "none", 0.0, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N,order,act,rate,skip,l2", FD_CASES)
def test_fused_dense_matches_plain(cuda_device, np_rng, B, K, N, order, act, rate, skip, l2):
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(cuda_device)  # noqa: E731
    x, w = f(B, K), f(N, K) / np.sqrt(K)
    b, bt = f(N) * 0.1, f(N) * 0.1
    g = 1.0 + 0.1 * f(N)
    sk, ls = (f(B, N), torch.tensor([0.3], device=cuda_device)) if skip else (None, None)
    out_dtype = torch.float32 if (skip or order == "act_ln") else torch.bfloat16
    dy = f(B, N)
    kw = dict(order=order, act=act, dropout_rate=rate, dropout_seed=12345,
              deterministic=rate == 0.0, out_dtype=out_dtype, l2_normalize_out=l2)
    before = _build.LAUNCHES.snapshot()
    y, grads = _fused_dense_run(fd.fused_dense_norm_act, x.bfloat16(), w, b, g, bt,
                                None if sk is None else sk.bfloat16(), ls, dy, **kw)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["fused_dense_gemm"] == before["fused_dense_gemm"] + 2  # u, then dx
    assert after["fused_dense_fwd_rows"] == before["fused_dense_fwd_rows"] + 1
    assert after["fused_dense_bwd_rows"] == before["fused_dense_bwd_rows"] + 1
    y_ref, grads_ref = _fused_dense_run(fd.fused_dense_reference, x.bfloat16(), w, b, g, bt,
                                        None if sk is None else sk.bfloat16(), ls, dy, **kw)
    assert y.dtype == out_dtype and y.shape == (B, N)
    if rate > 0.0:
        assert torch.equal(y == 0, y_ref == 0)  # the same mask, bit for bit
        keep = fd.dropout_bits(12345, B, N, cuda_device) >= fd.dropout_threshold(rate)
        assert torch.equal(y != 0, keep)
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL)
    _grads_close(grads, grads_ref, ["dx", "dW", "db", "dgamma", "dbeta", "dskip", "dls"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,d", [(136, 48), (1000, 512), (64, 128), (33, 200)])
def test_sym_infonce_matches_plain(cuda_device, np_rng, B, d):
    a, b = (torch.from_numpy(np_rng.normal(size=(B, d)).astype(np.float32)).to(cuda_device)
            for _ in range(2))
    a, b = torch.nn.functional.normalize(a, dim=-1), torch.nn.functional.normalize(b, dim=-1)
    scale = torch.tensor(14.3, device=cuda_device)

    def run(fn):
        ta, tb, ts = (t.clone().requires_grad_(True) for t in (a, b, scale))
        loss = fn(ta, tb, ts, torch.bfloat16)
        loss.backward()
        return loss.detach(), [ta.grad, tb.grad, ts.grad]

    before = _build.LAUNCHES.snapshot()
    loss, grads = run(fi.fused_symmetric_infonce)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["sym_infonce_lse"] == before["sym_infonce_lse"] + 1
    assert after["sym_infonce_grad"] == before["sym_infonce_grad"] + 2
    loss_ref, grads_ref = run(fi.fused_symmetric_infonce_reference)
    assert torch.isfinite(loss)
    torch.testing.assert_close(loss, loss_ref, **TOL)
    _grads_close(grads, grads_ref, ["da", "db", "dscale"])


@pytest.mark.cuda
def test_train_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(8, 64, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(128, 64, device=cuda_device)
    v = torch.zeros(128, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        fd.fused_dense_norm_act(x, w, v, v, v, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        fd.fused_dense_norm_act(x, w[:100], v[:100], v[:100], v[:100])
    a = torch.zeros(16, 640, device=cuda_device)
    s = torch.tensor(1.0, device=cuda_device)
    with pytest.raises(ValueError, match="d <="):
        fi.fused_symmetric_infonce(a, a, s, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        fi.fused_symmetric_infonce(a[:, :64], a[:, :64], s)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H,rope", [(2, 128, 512, 8, False), (3, 65, 64, 2, True),
                                          (2, 100, 256, 4, True), (2, 200, 640, 10, False),
                                          (3, 30, 96, 2, True)])
def test_short_attention_bwd_matches_plain(cuda_device, np_rng, B, S, D, H, rope):
    """The backward kernel against its plain version on the same residuals
    (qkv, the plain forward's o, a random dO)."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    qkv, dout = f(B, S, 3 * D), f(B, S, D)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    pos = torch.arange(S, device=cuda_device) if rope else None
    o = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
    before = _build.LAUNCHES.snapshot()["short_attention_bwd"]
    got = sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask, rope_positions=pos)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot()["short_attention_bwd"] == before + 1
    want = sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, mask=mask, rope_positions=pos)
    assert torch.isfinite(got).all()
    _grads_close([got[..., i * D:(i + 1) * D] for i in range(3)],
                 [want[..., i * D:(i + 1) * D] for i in range(3)], ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H,rope,saved", [
    (2, 128, 512, 8, False, True), (3, 65, 64, 2, True, True), (2, 255, 512, 8, True, True),
    (2, 255, 1024, 8, True, True), (3, 30, 96, 2, True, True), (256, 128, 640, 10, True, True),
    (2, 209, 128, 2, False, False), (2, 255, 512, 8, True, False),
    (2, 255, 1024, 8, False, False), (2, 128, 512, 8, True, False)])
def test_short_attention_bwd_lifted_and_saved_match_plain(cuda_device, np_rng, B, S, D, H, rope,
                                                          saved):
    """Both modes' backward kernels up to S = 255 at Dh = 64 and 128 (past
    the WMMA head kernel's bound, S <= 208 at Dh=64: the dQ and dK/dV pair;
    at S = 128 the one-block kernels) against their plain versions
    on the same residuals (the plain forward's o or bf16 probabilities), two
    launches equal byte for byte; in the saved mode the saving forward's o
    and probabilities against the plain ones too."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    qkv, dout = f(B, S, 3 * D), f(B, S, D)
    mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device)
    pos = torch.arange(S, device=cuda_device) if rope else None
    o, probs = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos,
                                                return_probs=True)
    before = _build.LAUNCHES.snapshot()
    if saved:
        o_k, p_k = sa.short_attention_qkv_save(qkv, H, mask=mask, rope_positions=pos)
        torch.testing.assert_close(o_k.float(), o.float(), **TOL)
        torch.testing.assert_close(p_k.float(), probs.float(), atol=1e-2, rtol=0)
        run = lambda: sa.short_attention_qkv_bwd_probs(dout, qkv, probs, H,  # noqa: E731
                                                       rope_positions=pos)
        want = sa.short_attention_qkv_bwd_probs_reference(dout, qkv, probs, H, rope_positions=pos)
        names = ("short_attention_save", "short_attention_bwd_probs")
    else:
        run = lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask,  # noqa: E731
                                                 rope_positions=pos)
        want = sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, mask=mask, rope_positions=pos)
        names = ("short_attention_bwd",)
    got, again = run(), run()
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after[names[-1]] == before[names[-1]] + 2
    if saved:
        assert after[names[0]] == before[names[0]] + 1
    assert torch.isfinite(got).all() and torch.equal(got, again)
    _grads_close([got[..., i * D:(i + 1) * D] for i in range(3)],
                 [want[..., i * D:(i + 1) * D] for i in range(3)], ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [8, 48, 64, 128])
def test_short_attention_bwd_smem_matches_the_mirror(cuda_device, Dh):
    """The launcher's shared memory (csrc::short_attention_bwd_smem) equals
    ops/short_attention.py::bwd_smem_bytes, and fits, over the forward's S;
    the WMMA head kernel's equals bwd_head_smem_bytes, the one-block kernel's
    bwd_saved_smem_bytes in saved mode and bwd_recompute_smem_bytes in
    recompute mode (0 past S = 128)."""
    lib = _build.LIBRARY.get()
    for S in (1, 16, 30, 64, 65, 128, 200, 208, 209, 240, 255, 256):
        for saved in (False, True):
            want = sa.bwd_smem_bytes(S, Dh, saved)
            got = tuple(lib.short_attention_bwd_smem(S, Dh, int(saved), k) for k in (0, 1))
            assert got == want and all(0 < b <= sa.MAX_SMEM for b in got), (S, saved)
        assert lib.short_attention_bwd_smem(S, Dh, 0, 2) == sa.bwd_head_smem_bytes(S, Dh), S
        saved_one = lib.short_attention_bwd_smem(S, Dh, 1, 3)
        assert saved_one == sa.bwd_saved_smem_bytes(S, Dh), S
        assert (0 < saved_one <= sa.MAX_SMEM) == (sa.bwd_saved_design(S, Dh) == "one block"), S
        recompute_one = lib.short_attention_bwd_smem(S, Dh, 0, 4)
        assert recompute_one == sa.bwd_recompute_smem_bytes(S, Dh), S
        assert (0 < recompute_one <= sa.MAX_SMEM) == (
            sa.bwd_recompute_design(S, Dh) == "one block"), S


SAVED_ONE_BLOCK_CASES = [  # B, S, D, H, entry, mask
    (256, 128, 640, 10, "packed rope", "ragged"),  # DPLM training
    (64, 128, 512, 8, "chunk", "ragged"),           # the flagship's chunk views
    (4, 64, 256, 4, "packed rope", "ragged"),       # S=64, Dh=64 (DPLM's CLI)
    (4, 64, 512, 4, "heads", "ragged"),             # S=64, Dh=128
    (3, 128, 256, 2, "chunk", None),                # S=128, Dh=128
    (4, 128, 256, 4, "packed", "ragged"),           # S=128, Dh=64
    (5, 65, 512, 8, "chunk", "ragged"),             # probabilities off 16 bytes: element loads
    (3, 65, 64, 2, "packed rope", "ragged"),        # the same, packed, Dh=32
    (4, 100, 640, 10, "packed rope", "dead row"),   # a batch row with no real key
    (3, 30, 96, 2, "packed rope", "dead row"),      # Dh=48, one key tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H,entry,masked", SAVED_ONE_BLOCK_CASES)
def test_short_attention_bwd_saved_one_block_matches_plain(cuda_device, np_rng, B, S, D, H,
                                                           entry, masked):
    """The one-block backward from the saved probabilities (S <= 128), through
    both saved entries, against its plain version on the plain forward's
    probabilities: packed qkv with and without RoPE, `qkv.chunk(3, -1)` views
    and head views; Dh = 32 to 128; S = 65, whose probabilities' rows are off
    16 bytes (element loads); a batch row whose keys are all masked. Two
    launches are equal byte for byte, each moves the counter once, and the C
    launcher counts both as one-block calls."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    assert sa.bwd_saved_design(S, D // H) == "one block"
    qkv, mask = f(B, S, 3 * D), None
    if masked == "ragged":
        mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device)
    elif masked == "dead row":
        mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    if entry.startswith("packed"):
        pos = torch.arange(S, device=cuda_device) if entry == "packed rope" else None
        dout = f(B, S, D)
        _, probs = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos,
                                                    return_probs=True)
        run = lambda: [sa.short_attention_qkv_bwd_probs(dout, qkv, probs, H,  # noqa: E731
                                                        rope_positions=pos)]
        want = sa.short_attention_qkv_bwd_probs_reference(dout, qkv, probs, H,
                                                          rope_positions=pos).chunk(3, dim=-1)
        name = "short_attention_bwd_probs"
    else:
        q, k, v = qkv.chunk(3, dim=-1)
        if entry == "heads":
            q, k, v = (split_heads(t, H) for t in (q, k, v))
        dout = f(*q.shape)
        _, probs = sa.short_attention_sep_reference(q, k, v, H, mask=mask, return_probs=True)
        run = lambda: list(sa.short_attention_sep_bwd_probs(dout, q, k, v, probs, H))  # noqa: E731
        want = sa.short_attention_sep_bwd_probs_reference(dout, q, k, v, probs, H)
        name = "short_attention_sep_bwd_probs"
    lib = _build.LIBRARY.get()
    designs = [lib.short_attention_saved_bwd_calls(i) for i in (0, 1)]
    before = _build.LAUNCHES.snapshot()[name]
    got = run()
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot()[name] == before + 1
    again = run()
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot()[name] == before + 2
    # both calls ran the one-block kernel, neither the dQ and dK/dV pair
    assert [lib.short_attention_saved_bwd_calls(i) for i in (0, 1)] == [designs[0] + 2, designs[1]]
    assert all(torch.isfinite(a).all() and torch.equal(a, b) for a, b in zip(got, again))
    if len(got) == 1:
        got = got[0].chunk(3, dim=-1)
    _grads_close(got, want, ["dq", "dk", "dv"])


RECOMPUTE_ONE_BLOCK_CASES = [  # B, S, D, H, entry, mask
    (256, 128, 640, 10, "packed rope", "ragged"),  # DPLM training's packed RoPE shape
    (64, 128, 512, 8, "chunk", "ragged"),           # the flagship's chunk views
    (64, 128, 512, 8, "packed", "ragged"),          # the flagship's packed call
    (4, 64, 256, 4, "packed rope", "ragged"),       # S=64, Dh=64 (DPLM's CLI)
    (4, 64, 512, 4, "heads", "ragged"),             # S=64, Dh=128 (o larger than the probs)
    (3, 128, 256, 2, "chunk", None),                # S=128, Dh=128
    (4, 128, 256, 4, "packed", "ragged"),           # S=128, Dh=64
    (5, 65, 512, 8, "chunk", "ragged"),             # S=65: padding rows and keys
    (3, 65, 64, 2, "packed rope", "ragged"),        # the same, packed, Dh=32
    (4, 100, 640, 10, "packed rope", "holes"),      # keys masked inside the rows
    (4, 100, 640, 10, "packed rope", "dead row"),   # a batch row with no real key
    (3, 30, 96, 2, "packed rope", "dead row"),      # Dh=48, one key tile
]


def _recompute_designs(lib):
    return [lib.short_attention_recompute_bwd_calls(i) for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H,entry,masked", RECOMPUTE_ONE_BLOCK_CASES)
def test_short_attention_bwd_recompute_one_block_matches_plain(cuda_device, np_rng, B, S, D, H,
                                                               entry, masked):
    """The one-block recompute backward (S <= 128: the scores and softmax
    recomputed on wgmma), through both recompute entries, against its plain
    version on the plain forward's o: packed qkv with and without RoPE,
    `qkv.chunk(3, -1)` views and head views; Dh = 32 to 128; S = 65, whose
    padding rows and keys must take ds = 0; keys masked inside the rows; a
    batch row whose keys are all masked. Two launches are equal byte for
    byte, each moves the counter once, and the C launcher counts both as
    one-block calls and none of the other designs."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    assert sa.bwd_recompute_design(S, D // H) == "one block"
    qkv, mask = f(B, S, 3 * D), None
    if masked in ("ragged", "holes"):
        mask_np = _key_mask(np_rng, B, S)
        if masked == "holes":
            mask_np[:, [1, S // 2]] = False
        mask = torch.from_numpy(mask_np).to(cuda_device)
    elif masked == "dead row":
        mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    if entry.startswith("packed"):
        pos = torch.arange(S, device=cuda_device) if entry == "packed rope" else None
        dout = f(B, S, D)
        o = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
        run = lambda: [sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask,  # noqa: E731
                                                  rope_positions=pos)]
        want = sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, mask=mask,
                                                    rope_positions=pos).chunk(3, dim=-1)
        name = "short_attention_bwd"
    else:
        q, k, v = qkv.chunk(3, dim=-1)
        if entry == "heads":
            q, k, v = (split_heads(t, H) for t in (q, k, v))
        dout = f(*q.shape)
        o = sa.short_attention_sep_reference(q, k, v, H, mask=mask)
        run = lambda: list(sa.short_attention_sep_bwd(dout, q, k, v, o, H,  # noqa: E731
                                                      mask=mask))
        want = sa.short_attention_sep_bwd_reference(dout, q, k, v, o, H, mask=mask)
        name = "short_attention_sep_bwd"
    lib = _build.LIBRARY.get()
    designs = _recompute_designs(lib)
    before = _build.LAUNCHES.snapshot()[name]
    got = run()
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot()[name] == before + 1
    again = run()
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot()[name] == before + 2
    # both calls ran the one-block kernel, neither the head kernel nor the pair
    assert _recompute_designs(lib) == [designs[0] + 2, designs[1], designs[2]]
    assert all(torch.isfinite(a).all() and torch.equal(a, b) for a, b in zip(got, again))
    if len(got) == 1:
        got = got[0].chunk(3, dim=-1)
    _grads_close(got, want, ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("S,Dh", [(65, 24), (128, 64), (100, 128)])
def test_short_attention_bwd_recompute_misaligned_operands_match_aligned(cuda_device, np_rng,
                                                                         S, Dh):
    """q, k, v (and o, dO) whose base is off 16 bytes (views one element
    into a wider buffer) stage by elements instead of TMA in the one-block
    recompute backward: the same dq, dk, dv, bit for bit, as contiguous
    copies of the same values, and close to the plain version."""
    B, H = 3, 2
    D = H * Dh
    wide = lambda n: torch.from_numpy(  # noqa: E731
        np_rng.normal(size=(B, S, n * D + 1)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = wide(3)[..., 1:].chunk(3, dim=-1)
    o, dout = wide(2)[..., 1:].chunk(2, dim=-1)
    assert q.data_ptr() % 16 != 0 and o.data_ptr() % 16 != 0
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    lib = _build.LIBRARY.get()
    designs = _recompute_designs(lib)
    got, want = (sa.short_attention_sep_bwd(*ops, H, mask=mask)
                 for ops in ((dout, q, k, v, o),
                             tuple(t.contiguous() for t in (dout, q, k, v, o))))
    torch.cuda.synchronize()
    assert _recompute_designs(lib) == [designs[0] + 2, designs[1], designs[2]]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _grads_close(got, sa.short_attention_sep_bwd_reference(dout, q, k, v, o, H, mask=mask),
                 ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H,design", [(2, 200, 640, 10, 1), (2, 255, 1024, 8, 2)])
def test_short_attention_bwd_recompute_past_one_block_counts_its_design(cuda_device, np_rng, B,
                                                                        S, D, H, design):
    """Past S = 128 the recompute backward keeps its WMMA head kernel (S =
    200 at Dh = 64: design 1) and the dQ and dK/dV pair (S = 255 at Dh =
    128: design 2); the launcher counts the call there and nowhere else."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    assert sa.bwd_recompute_design(S, D // H) == ("one block", "head", "pair")[design]
    qkv, dout = f(B, S, 3 * D), f(B, S, D)
    mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device)
    pos = torch.arange(S, device=cuda_device)
    o = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
    lib = _build.LIBRARY.get()
    designs = _recompute_designs(lib)
    got = sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask, rope_positions=pos)
    torch.cuda.synchronize()
    designs[design] += 1
    assert _recompute_designs(lib) == designs
    want = sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, mask=mask, rope_positions=pos)
    _grads_close(got.chunk(3, dim=-1), want.chunk(3, dim=-1), ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H", [(2, 128, 512, 8), (3, 65, 128, 2)])
def test_fused_short_attention_proj_grads_match_plain(cuda_device, np_rng, B, S, D, H):
    """The autograd Function on the card (attention, projection GEMM; dO
    GEMM, attention backward, f32 dWo/dbo) against autograd of the plain
    formulation, in the mode the rule picks at these shapes (saved) and with
    save_probs=False (recompute): each launches its own kernels only."""
    qkv = torch.from_numpy(np_rng.normal(size=(B, S, 3 * D)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    wo = torch.from_numpy((np_rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32))
    bo = torch.from_numpy((np_rng.normal(size=(D,)) * 0.1).astype(np.float32))
    wo, bo = wo.to(cuda_device), bo.to(cuda_device)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    dy = torch.from_numpy(np_rng.normal(size=(B, S, D)).astype(np.float32)).to(cuda_device)

    def run(fn, **kw):
        leaves = [t.clone().requires_grad_(True) for t in (qkv, wo, bo)]
        y = fn(*leaves, H, mask=mask, **kw)
        y.backward(dy.to(y.dtype))
        return y.detach(), [t.grad for t in leaves]

    assert sa.saves_probs(B, S, H)
    y_ref, grads_ref = run(fused_short_attention_qkv_proj_reference)
    for mode, launched, idle in ((None, ("short_attention_save", "short_attention_bwd_probs"),
                                  ("short_attention", "short_attention_bwd")),
                                 (False, ("short_attention", "short_attention_bwd"),
                                  ("short_attention_save", "short_attention_bwd_probs"))):
        before = _build.LAUNCHES.snapshot()
        y, grads = run(fused_short_attention_qkv_proj, save_probs=mode)
        torch.cuda.synchronize()
        after = _build.LAUNCHES.snapshot()
        for name in launched + ("short_attention_out_proj", "fused_dense_gemm"):
            assert after[name] == before[name] + 1, (mode, name)
        for name in idle:
            assert after[name] == before[name], (mode, name)
        assert grads[1].dtype == grads[2].dtype == torch.float32
        torch.testing.assert_close(y.float(), y_ref.float(), **TOL)
        _grads_close(grads, grads_ref, ["dqkv", "dwo", "dbo"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H", [(4, 128, 512, 8), (3, 65, 64, 2), (5, 33, 1280, 20),
                                     (2, 200, 128, 16), (1000, 65, 512, 8)])
def test_cls_attention_matches_plain(cuda_device, np_rng, B, S, D, H):
    qkv = torch.from_numpy(np_rng.normal(size=(B, S, 3 * D)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    dout = torch.from_numpy(np_rng.normal(size=(B, 1, D)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    before = _build.LAUNCHES.snapshot()
    leaf = qkv.clone().requires_grad_(True)
    got = sa.fused_cls_attention(leaf, H, mask=mask)
    got.backward(dout)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["cls_attention_fwd"] == before["cls_attention_fwd"] + 1
    assert after["cls_attention_bwd"] == before["cls_attention_bwd"] + 1
    want = sa.fused_cls_attention_reference(qkv, H, mask=mask)
    assert got.shape == (B, 1, D) and torch.isfinite(got).all()
    torch.testing.assert_close(got.detach().float(), want.float(), **TOL)
    want_g = sa.fused_cls_attention_bwd_reference(dout, qkv, H, mask=mask)
    assert torch.count_nonzero(leaf.grad[:, 1:, :D]) == 0
    _grads_close([leaf.grad[..., i * D:(i + 1) * D] for i in range(3)],
                 [want_g[..., i * D:(i + 1) * D] for i in range(3)], ["dq", "dk", "dv"])


def _cls_inputs(rng, dev, B, S, D):
    qkv = torch.from_numpy(rng.normal(size=(B, S, 3 * D)).astype(np.float32)).to(
        dev, torch.bfloat16)
    mask = torch.from_numpy(_ragged_mask(rng, B, S)).to(dev)
    dout = torch.from_numpy(rng.normal(size=(B, 1, D)).astype(np.float32)).to(dev, torch.bfloat16)
    return qkv, mask, dout


def _cls_bwd_launch(qkv, mask, dout, H):
    """dqkv of one launch of the CLS backward's C entry into a buffer filled
    with NaN first, so that an element left unwritten shows."""
    B, S, D3 = qkv.shape
    Dh = D3 // 3 // H
    dqkv = torch.full_like(qkv, float("nan"))
    _build.launch("cls_attention_bwd", qkv.data_ptr(), mask.data_ptr(), dout.data_ptr(),
                  dqkv.data_ptr(), B, S, H, Dh, 1.0 / Dh ** 0.5, _build.stream_of(qkv))
    torch.cuda.synchronize()
    return dqkv


def _cls_grads_close(dqkv, want, D):
    assert torch.isfinite(dqkv).all()
    assert torch.count_nonzero(dqkv[:, 1:, :D]) == 0
    _grads_close([dqkv[..., i * D:(i + 1) * D] for i in range(3)],
                 [want[..., i * D:(i + 1) * D] for i in range(3)], ["dq", "dk", "dv"])


# (B, S, D, H): the five shapes of test_cls_attention_matches_plain, the
# flagship at B=64, S=1, 32 and 64 (ESM-CLIP's lengths), the group design's
# cut (S=256) and one row past it, Dh=128, 12 heads of 8 (groups of 8 and 4
# heads), Dh=24 (three chunks a head), Dh=256 (one box of 256 columns), Dh=264
# (wider than a box: the row design), 128 heads of 8 at S=256 (past the row
# design's shared memory) and one head of 8 at S=95 and 96 (blocks of 128 and
# 256 threads); the last batch row has no real key
CLS_BWD_SHAPES = [(4, 128, 512, 8), (3, 65, 64, 2), (5, 33, 1280, 20), (2, 200, 128, 16),
                  (1000, 65, 512, 8), (64, 128, 512, 8), (6, 1, 512, 8), (8, 32, 512, 8),
                  (8, 64, 512, 8), (4, 256, 512, 8), (4, 257, 512, 8), (4, 128, 1024, 8),
                  (3, 40, 96, 12), (3, 50, 96, 4), (2, 64, 512, 2), (2, 64, 528, 2),
                  (2, 256, 1024, 128), (4, 95, 8, 1), (4, 96, 8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H", CLS_BWD_SHAPES)
def test_cls_bwd_designs_match_plain(cuda_device, np_rng, B, S, D, H):
    """Each launch moves the launcher's count of the design `cls_bwd_design`
    names by one; dqkv matches the plain backward with every element written
    and the q rows 1.. zero; two launches are equal byte for byte, and so is
    the wrapper's output; the C layout's bytes are the Python mirror's."""
    qkv, mask, dout = _cls_inputs(np_rng, cuda_device, B, S, D)
    lib = _build.LIBRARY.get()
    design = sa.cls_bwd_design(S, D, H)
    outs = []
    for _ in range(2):
        before = [lib.cls_attention_bwd_calls(d) for d in (0, 1)]
        outs.append(_cls_bwd_launch(qkv, mask, dout, H))
        moved = [lib.cls_attention_bwd_calls(d) - before[d] for d in (0, 1)]
        assert moved == [int(design == "group"), int(design == "row")], (design, moved)
    want = sa.fused_cls_attention_bwd_reference(dout, qkv, H, mask=mask)
    _cls_grads_close(outs[0], want, D)
    assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))
    got = sa.fused_cls_attention_bwd(dout, qkv, H, mask=mask)
    assert torch.equal(got.view(torch.int16), outs[0].view(torch.int16))
    assert lib.cls_attention_bwd_smem(S, H, D // H) == sa.cls_bwd_smem_bytes(S, D, H) > 0


@pytest.mark.cuda
def test_cls_attention_takes_operands_off_16_bytes(cuda_device, np_rng):
    """A contiguous qkv (and dout) two bytes past a 16-byte boundary gives
    the bytes of its aligned copy, forward and backward."""
    B, S, D, H = 4, 128, 512, 8
    qkv0, mask, dout0 = _cls_inputs(np_rng, cuda_device, B, S, D)
    qkv = torch.empty(qkv0.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(
        B, S, 3 * D)
    dout = torch.empty(dout0.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(
        B, 1, D)
    qkv.copy_(qkv0)
    dout.copy_(dout0)
    assert qkv.data_ptr() % 16 == 2 and dout.data_ptr() % 16 == 2
    with torch.no_grad():
        got, want = (sa.fused_cls_attention(x, H, mask=mask) for x in (qkv, qkv0))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    got, want = (sa.fused_cls_attention_bwd(d, x, H, mask=mask)
                 for d, x in ((dout, qkv), (dout0, qkv0)))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_forward_only_kernels_refuse_to_drop_gradients(cuda_device):
    """A CUDA launch that autograd would record without a backward raises;
    the same calls under no_grad run. flash_attention has its backward now
    and records the gradient; multi-head attention below 64 keys is the
    plain formulation on the card."""
    q = torch.zeros(1, 2, 256, 64, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    out = flash_attention(q, q, q)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    qkv = torch.zeros(2, 64, 3 * 64, device=cuda_device, dtype=torch.bfloat16,
                      requires_grad=True)
    with pytest.raises(NotImplementedError, match="fused_short_attention_qkv_proj"):
        short_attention_qkv(qkv, 2)
    o = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    w, b = torch.zeros(64, 64, device=cuda_device), torch.zeros(64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="fused_short_attention_qkv_proj"):
        out_projection(o, w, b)
    with pytest.raises(NotImplementedError, match="fused_tiny_attention_proj"):
        ta.tiny_attention(qkv[:, :10].contiguous(), 2)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape
        assert short_attention_qkv(qkv, 2).shape == (2, 64, 64)
        o_s, p_s = sa.short_attention_qkv_save(qkv, 2)
        assert o_s.shape == (2, 64, 64) and p_s.shape == (2, 2, 64, 64)
    x = torch.randn(2, 10, 64, device=cuda_device, dtype=torch.bfloat16)
    heads = x.reshape(2, 10, 2, 32).transpose(1, 2)
    want = attention_reference(heads, heads, heads).transpose(1, 2).reshape(2, 10, 64)
    torch.testing.assert_close(multihead_attention(x, x, x, 2), want)
    out = multihead_attention(o, o, o, 2)  # the short-S kernel over q, k, v records it
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="fused_short_attention"):
        sa.short_attention_sep(o, o, o, 2)
    with pytest.raises(NotImplementedError, match="fused_short_attention_qkv_proj"):
        sa.short_attention_qkv_save(qkv, 2)
    # S = 256 at Dh = 64 has its backward now (the one-block bound was S <= 208)
    big = torch.zeros(1, 256, 3 * 512, device=cuda_device, dtype=torch.bfloat16,
                      requires_grad=True)
    fused_short_attention_qkv_proj(big, w.new_zeros(512, 512), w.new_zeros(512), 8).sum().backward()
    assert big.grad is not None and torch.isfinite(big.grad).all()
    with pytest.raises(ValueError, match="up to 128 heads"):
        sa.fused_cls_attention(torch.zeros(1, 8, 3 * 8 * 130, device=cuda_device,
                                           dtype=torch.bfloat16), 130)
    wide = torch.zeros(1, 1, 256, 256, device=cuda_device, dtype=torch.bfloat16,
                       requires_grad=True)
    with pytest.raises(ValueError, match="Dh <= 128"):
        flash_attention(wide, wide, wide)


def _key_mask(rng, B, S):
    """A ragged key mask with no fully masked row (the lse of such a row
    rounds to -1e30 and its backward takes p = 1 per key)."""
    lens = rng.integers(S // 2, S + 1, B)
    return np.arange(S)[None, :] < lens[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H,masked", [(64, 10, 512, 8, False), (19, 10, 64, 4, True),
                                            (7, 33, 512, 8, True), (9, 8, 256, 4, False),
                                            (3, 63, 128, 2, True), (5, 2, 1024, 4, True)])
def test_tiny_attention_matches_plain(cuda_device, np_rng, B, S, D, H, masked):
    """Forward, then the backward kernel on the plain forward's residuals."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    qkv, dout = f(B, S, 3 * D), f(B, S, D)
    mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device) if masked else None
    before = _build.LAUNCHES.snapshot()
    with torch.no_grad():
        o = ta.tiny_attention(qkv, H, mask=mask)
    o_ref = ta.tiny_attention_reference(qkv, H, mask=mask)
    got = ta.tiny_attention_bwd(dout, qkv, o_ref, H, mask=mask)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["tiny_attention_fwd"] == before["tiny_attention_fwd"] + 1
    assert after["tiny_attention_bwd"] == before["tiny_attention_bwd"] + 1
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL)
    want = ta.tiny_attention_bwd_reference(dout, qkv, o_ref, H, mask=mask)
    assert torch.isfinite(got).all()
    _grads_close([got[..., i * D:(i + 1) * D] for i in range(3)],
                 [want[..., i * D:(i + 1) * D] for i in range(3)], ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H", [(32, 10, 512, 8), (6, 33, 64, 8)])
def test_fused_tiny_attention_proj_grads_match_plain(cuda_device, np_rng, B, S, D, H):
    qkv = torch.from_numpy(np_rng.normal(size=(B, S, 3 * D)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    wo = torch.from_numpy((np_rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32))
    bo = torch.from_numpy((np_rng.normal(size=(D,)) * 0.1).astype(np.float32))
    wo, bo = wo.to(cuda_device), bo.to(cuda_device)
    mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device)
    dy = torch.from_numpy(np_rng.normal(size=(B, S, D)).astype(np.float32)).to(cuda_device)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (qkv, wo, bo)]
        y = fn(*leaves, H, mask=mask)
        y.backward(dy.to(y.dtype))
        return y.detach(), [t.grad for t in leaves]

    before = _build.LAUNCHES.snapshot()
    y, grads = run(ta.fused_tiny_attention_proj)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    for name in ("tiny_attention_fwd", "short_attention_out_proj", "fused_dense_gemm",
                 "tiny_attention_bwd"):
        assert after[name] == before[name] + 1, name
    y_ref, grads_ref = run(ta.fused_tiny_attention_proj_reference)
    assert grads[1].dtype == grads[2].dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL)
    _grads_close(grads, grads_ref, ["dqkv", "dwo", "dbo"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Sk,Dh", [
    # the first five cases
    (1, 8, 4096, 4096, 64), (2, 3, 300, 300, 40), (1, 2, 333, 333, 128), (2, 2, 64, 64, 16),
    (3, 2, 257, 257, 64),
    # both templates (Dp = 64: Dh 20 by elements, 24 by TMA; Dp = 128: 72,
    # 128) at one tile, a tile and a row, two tiles, two and a row, four and
    # a row
    *[(2, 2, S, S, Dh) for Dh in (20, 24, 72, 128) for S in (64, 65, 128, 129, 257)],
    # fewer keys than query rows and more
    (2, 2, 130, 300, 64), (1, 2, 500, 77, 128), (2, 3, 65, 200, 40)])
def test_flash_attention_bwd_matches_plain(cuda_device, np_rng, B, H, S, Sk, Dh):
    """The forward's lse and the two backward kernels on the plain forward's
    residuals (out, lse); batch row 0 with its last whole 64-key tile masked
    (from Sk = 128 on), where dK and dV are zero exactly."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    q, k, v, dout = f(B, H, S, Dh), f(B, H, Sk, Dh), f(B, H, Sk, Dh), f(B, H, S, Dh)
    mask = _key_mask(np_rng, B, Sk)
    hi = Sk // 64 * 64
    if Sk >= 128:
        mask[0, hi - 64:hi] = False
    mask = torch.from_numpy(mask).to(cuda_device)
    with torch.no_grad():
        _, lse = fa._flash_forward(q, k, v, mask, None)
    out_ref = attention_reference(q, k, v, mask=mask)
    lse_ref = fa.flash_lse_reference(q, k, mask)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    before = _build.LAUNCHES.snapshot()
    got = fa.flash_attention_bwd(q, k, v, mask, out_ref, lse_ref, dout)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    want = fa.flash_attention_bwd_reference(q, k, v, mask, out_ref, lse_ref, dout)
    assert all(torch.isfinite(t).all() for t in got)
    _grads_close(got, want, ["dq", "dk", "dv"])
    if Sk >= 128:
        assert not got[1][0, :, hi - 64:hi].any() and not got[2][0, :, hi - 64:hi].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", [(1, 8, 1024, 64), (2, 3, 300, 128), (2, 2, 129, 20)])
def test_flash_attention_bwd_repeats_bit_for_bit(cuda_device, np_rng, B, H, S, Dh):
    """Two launches of each backward kernel on the same inputs give equal
    bytes: every sum is taken in one order, with no atomics."""
    q, k, v, dout = (torch.from_numpy(np_rng.normal(size=(B, H, S, Dh)).astype(np.float32))
                     .to(cuda_device, torch.bfloat16) for _ in range(4))
    mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device)
    out, lse = attention_reference(q, k, v, mask=mask), fa.flash_lse_reference(q, k, mask)
    first = fa.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    again = fa.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_attention_bwd_misaligned_views_match_aligned(cuda_device, np_rng, Dh):
    """q, k, v and dout as contiguous views whose base is off 16 bytes: the
    backward kernels stage them by elements instead of by TMA, into the same
    layout, so dq, dk and dv equal the aligned tensors' byte for byte."""
    B, H, S = 2, 3, 200
    n = B * H * S * Dh
    aligned = [torch.from_numpy(np_rng.normal(size=(B, H, S, Dh)).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(4)]
    views = []
    for t in aligned:
        buf = torch.empty(n + 1, device=cuda_device, dtype=torch.bfloat16)
        view = buf[1:].view(B, H, S, Dh)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        views.append(view)
    mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device)
    q, k, v, dout = aligned
    out, lse = attention_reference(q, k, v, mask=mask), fa.flash_lse_reference(q, k, mask)
    got = fa.flash_attention_bwd(*views[:3], mask, out, lse, views[3])
    want = fa.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name
    _grads_close(got, fa.flash_attention_bwd_reference(q, k, v, mask, out, lse, dout),
                 ["dq", "dk", "dv"])


@pytest.mark.cuda
def test_flash_attention_autograd_matches_plain(cuda_device, np_rng):
    """The autograd Function on the card against autograd of the plain
    formulation, at the tf_clip cell tower's shape class (one sequence)."""
    B, H, S, Dh = 1, 8, 512, 64
    qkv = [torch.from_numpy(np_rng.normal(size=(B, H, S, Dh)).astype(np.float32))
           .to(cuda_device, torch.bfloat16) for _ in range(3)]
    mask = torch.from_numpy(_key_mask(np_rng, B, S)).to(cuda_device)
    dout = torch.from_numpy(np_rng.normal(size=(B, H, S, Dh)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        y = fn(*leaves, mask=mask)
        y.backward(dout)
        return y.detach(), [t.grad for t in leaves]

    y, grads = run(flash_attention)
    y_ref, grads_ref = run(attention_reference)
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL)
    _grads_close(grads, grads_ref, ["dq", "dk", "dv"])


def _row_ce_inputs(rng, device, m, n, d=512):
    f = lambda *s: torch.nn.functional.normalize(  # noqa: E731
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device), dim=-1)
    return f(m, d), f(n, d), torch.tensor(14.3, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,n_valid,rows", [(1024, 2048, 1024 + 700, 1024), (512, 512, None, 512),
                                              (1000, 1777, 1400, 1777), (40, 136, 100, 64),
                                              (33, 200, 1, 200)])
def test_row_ce_kernels_match_plain(cuda_device, np_rng, m, n, n_valid, rows):
    """The row lse, P y with rowsum(p raw), and P^T x over the first `rows`
    rows of y, each against its plain version on the same inputs (the
    backward kernels on the plain lse); n_valid = 1 masks all but one column."""
    x, y, s = _row_ce_inputs(np_rng, cuda_device, m, n)
    xb, yb, s32 = x.bfloat16(), y.bfloat16(), s.reshape(1)
    nv = torch.tensor([n if n_valid is None else n_valid], dtype=torch.int32, device=cuda_device)
    before = _build.LAUNCHES.snapshot()
    lse = fi._kernel_row_lse(xb, yb, s32, nv)
    lse_ref = fi._plain_row_lse(xb, yb, s32, nv)
    got = fi._kernel_row_dx(xb, yb, s32, lse_ref, nv) + (fi._kernel_row_dy(xb, yb, s32, lse_ref,
                                                                           rows),)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    for name in ("row_ce_lse", "row_ce_dx", "row_ce_dy"):
        assert after[name] == before[name] + 1, name
    torch.testing.assert_close(lse, lse_ref, **TOL)
    want = fi._plain_row_dx(xb, yb, s32, lse_ref, nv) + (fi._plain_row_dy(xb, yb, s32, lse_ref,
                                                                          rows),)
    assert all(torch.isfinite(t).all() for t in got)
    _grads_close(got, want, ["P y", "rowdot", "P^T x"])


@pytest.mark.cuda
def test_fused_row_ce_matches_plain(cuda_device, np_rng):
    """The autograd Function on the card (three kernels and the tail) against
    its plain version: a ragged shape, shuffled labels, a partly valid y, dy
    formed for the first 1500 rows."""
    x, y, s = _row_ce_inputs(np_rng, cuda_device, 1000, 1777)
    labels = torch.from_numpy(np_rng.permutation(1400)[:1000]).to(cuda_device)
    nv = torch.tensor([1400], dtype=torch.int32, device=cuda_device)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, y, s)]
        loss = fn(*leaves, labels, nv, torch.bfloat16, grad_rows=1500)
        loss.backward()
        return loss.detach(), [t.grad for t in leaves]

    loss, grads = run(fi.fused_row_ce)
    loss_ref, grads_ref = run(fi.fused_row_ce_reference)
    torch.testing.assert_close(loss, loss_ref, **TOL)
    assert not grads[1][1500:].any()
    _grads_close(grads, grads_ref, ["dx", "dy", "dscale"])


@pytest.mark.cuda
def test_cached_fused_clip_loss_matches_plain(cuda_device, np_rng):
    """fused_clip_loss with a partly filled cache on the card against its CPU
    route on the same inputs."""
    a, b, _ = _row_ce_inputs(np_rng, cuda_device, 256, 256)
    cache, _, _ = _row_ce_inputs(np_rng, cuda_device, 1024, 1)
    ls = torch.tensor(2.6592, device=cuda_device)
    cache_len = torch.tensor(640, dtype=torch.int32, device=cuda_device)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [t.to(dev).clone().requires_grad_(True) for t in (a, b, ls)]
        loss, m = fi.fused_clip_loss(*leaves, dot_dtype=torch.bfloat16, cache=cache.to(dev),
                                     cache_len=cache_len.to(dev))
        loss.backward()
        out[dev.type] = [loss.detach().cpu(), m["loss_a"].detach().cpu()] + [
            t.grad.cpu() for t in leaves]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], **TOL)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], **TOL)
    _grads_close(out["cuda"][2:], out["cpu"][2:], ["da", "db", "dls"])


SAVED_RAW_KERNELS = ("sym_infonce_lse_save", "sym_infonce_grad_raw", "sym_infonce_grad_rawT",
                     "sym_infonce_grad_merged")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(1000, 1000, 512), (4096, 4096, 512), (300, 700, 96),
                                   (136, 136, 48), (520, 33, 200), (256, 256, 512),
                                   (200, 200, 512)])
def test_saved_raw_kernels_match_plain(cuda_device, np_rng, m, n, d):
    """The saving forward (lse and the int16 raw, |dq| <= 1 where the f32
    sums round differently), pass A, pass B and the merged kernel from the
    same raw and the plain lse, each against its plain version; merged
    against the two passes; two launches of each kernel equal byte for
    byte (no atomics)."""
    x, y, s = _row_ce_inputs(np_rng, cuda_device, m, n, d)
    xb, yb, s32 = x.bfloat16(), y.bfloat16(), s.reshape(1)
    before = _build.LAUNCHES.snapshot()
    *lse, raw_q = fi._kernel_lse_save(xb, yb, s32)
    *lse_ref, raw_ref = fi._plain_lse_save(xb, yb, s32)
    two = fi._kernel_grad_two_pass(raw_q, xb, yb, s32, *lse_ref)
    merged = fi._kernel_grad_merged(raw_q, xb, yb, s32, *lse_ref)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    for name in SAVED_RAW_KERNELS:
        assert after[name] == before[name] + 1, name
    torch.testing.assert_close(lse[0], lse_ref[0], **TOL)
    torch.testing.assert_close(lse[1], lse_ref[1], **TOL)
    assert raw_q.shape == (m, n) and raw_q.dtype == torch.int16
    assert (raw_q.int() - raw_ref.int()).abs().max().item() <= 1
    want = fi._plain_grad_from_raw(raw_q, xb, yb, s32, *lse_ref)
    for got in (two, merged):
        assert all(torch.isfinite(t).all() for t in got)
        _grads_close(got, want, ["acc_a", "rowdot", "acc_b"])
    _grads_close(merged, two, ["acc_a", "rowdot", "acc_b"])
    again = (fi._kernel_lse_save(xb, yb, s32),
             fi._kernel_grad_two_pass(raw_q, xb, yb, s32, *lse_ref),
             fi._kernel_grad_merged(raw_q, xb, yb, s32, *lse_ref))
    for first, second in zip(((*lse, raw_q), two, merged), again):
        assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("B,d", [(1000, 512), (256, 512), (136, 48), (64, 128)])
def test_saved_raw_sym_infonce_matches_plain(cuda_device, np_rng, B, d):
    """fused_symmetric_infonce(materialize_raw=True) on the card (the saving
    forward, the from-raw schedule the shape rule picks, no recompute pass)
    against its plain version: the loss, da, db and dscale."""
    a, b, s = _row_ce_inputs(np_rng, cuda_device, B, B, d)

    def run(fn):
        ta, tb, ts = (t.clone().requires_grad_(True) for t in (a, b, s))
        loss = fn(ta, tb, ts, torch.bfloat16, materialize_raw=True)
        loss.backward()
        return loss.detach(), [ta.grad, tb.grad, ts.grad]

    before = _build.LAUNCHES.snapshot()
    loss, grads = run(fi.fused_symmetric_infonce)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    merged = fi._from_raw_merged(B)
    assert after["sym_infonce_lse_save"] == before["sym_infonce_lse_save"] + 1
    assert after["sym_infonce_grad_merged"] == before["sym_infonce_grad_merged"] + merged
    assert after["sym_infonce_grad_raw"] == before["sym_infonce_grad_raw"] + (not merged)
    assert after["sym_infonce_grad_rawT"] == before["sym_infonce_grad_rawT"] + (not merged)
    assert after["sym_infonce_grad"] == before["sym_infonce_grad"]
    assert after["sym_infonce_lse"] == before["sym_infonce_lse"]
    loss_ref, grads_ref = run(fi.fused_symmetric_infonce_reference)
    assert torch.isfinite(loss)
    torch.testing.assert_close(loss, loss_ref, **TOL)
    _grads_close(grads, grads_ref, ["da", "db", "dscale"])


@pytest.mark.cuda
def test_saved_raw_refuses_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros(16, 640, device=cuda_device)
    s = torch.tensor(1.0, device=cuda_device)
    with pytest.raises(ValueError, match="d <="):
        fi.fused_symmetric_infonce(a, a, s, torch.bfloat16, materialize_raw=True)
    with pytest.raises(ValueError, match="bf16"):
        fi.fused_symmetric_infonce(a[:, :64], a[:, :64], s, materialize_raw=True)
    with pytest.raises(ValueError, match="d <="):
        fi.fused_clip_loss(a, a, s, dot_dtype=torch.bfloat16, materialize_raw="always")


SEP_CASES = [  # B, S, D, H, operands, masked
    (2, 128, 512, 8, "chunk", True), (4, 128, 640, 10, "heads", True),
    (1000, 65, 512, 8, "bsd", True), (2, 255, 512, 8, "heads", True),
    (2, 255, 1024, 8, "chunk", True), (3, 64, 96, 4, "bsd", False)]


def _sep_operands(rng, dev, B, S, D, H, operands):
    """q, k, v and dO: `qkv.chunk(3, -1)` views (row stride 3D), separate
    contiguous (B, S, D) tensors, or (B, H, S, Dh) head views of the chunks."""
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        dev, torch.bfloat16)
    q, k, v = f(B, S, 3 * D).chunk(3, dim=-1)
    if operands == "bsd":
        q, k, v = (t.contiguous() for t in (q, k, v))
    if operands == "heads":
        q, k, v = (split_heads(t, H) for t in (q, k, v))
    return q, k, v, f(*q.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H,operands,masked", SEP_CASES)
@pytest.mark.parametrize("saved", [False, True])
def test_short_attention_sep_matches_plain(cuda_device, np_rng, B, S, D, H, operands, masked,
                                           saved):
    """The four separate-operand launches (forward, saving forward, recompute
    backward, backward from the probabilities) against their plain versions
    on the same inputs (the backwards on the plain forward's residuals), in
    both layouts and on strided chunk views; two launches equal byte for
    byte."""
    q, k, v, dout = _sep_operands(np_rng, cuda_device, B, S, D, H, operands)
    mask = (torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device) if masked else None)
    o, probs = sa.short_attention_sep_reference(q, k, v, H, mask=mask, return_probs=True)
    before = _build.LAUNCHES.snapshot()
    if saved:
        fwd = lambda: sa.short_attention_sep_save(q, k, v, H, mask=mask)  # noqa: E731
        bwd = lambda: sa.short_attention_sep_bwd_probs(dout, q, k, v, probs, H)  # noqa: E731
        want = sa.short_attention_sep_bwd_probs_reference(dout, q, k, v, probs, H)
        names = ("short_attention_sep_save", "short_attention_sep_bwd_probs")
    else:
        fwd = lambda: (sa.short_attention_sep(q, k, v, H, mask=mask), None)  # noqa: E731
        bwd = lambda: sa.short_attention_sep_bwd(dout, q, k, v, o, H, mask=mask)  # noqa: E731
        want = sa.short_attention_sep_bwd_reference(dout, q, k, v, o, H, mask=mask)
        names = ("short_attention_sep", "short_attention_sep_bwd")
    (o_k, p_k), (o_k2, p_k2) = fwd(), fwd()
    grads, again = bwd(), bwd()
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert all(after[n] == before[n] + 2 for n in names)
    assert o_k.shape == q.shape and torch.equal(o_k, o_k2)
    torch.testing.assert_close(o_k.float(), o.float(), **TOL)
    if saved:
        assert torch.equal(p_k, p_k2)
        torch.testing.assert_close(p_k.float(), probs.float(), atol=1e-2, rtol=0)
    assert all(torch.isfinite(g).all() and torch.equal(g, h) for g, h in zip(grads, again))
    _grads_close(grads, want, ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H", [(2, 128, 512, 8), (3, 65, 128, 2), (2, 255, 1024, 8)])
def test_packed_kernels_after_the_descriptor_change(cuda_device, np_rng, B, S, D, H):
    """The packed entries, whose q, k, v are now operand descriptors into
    qkv, against their plain versions, and equal byte for byte to the
    separate entries on `qkv.chunk(3, -1)` views of the same qkv (no RoPE):
    one kernel, two sets of strides."""
    f = lambda *s: torch.from_numpy(np_rng.normal(size=s).astype(np.float32)).to(  # noqa: E731
        cuda_device, torch.bfloat16)
    qkv, dout = f(B, S, 3 * D), f(B, S, D)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    q, k, v = qkv.chunk(3, dim=-1)
    with torch.no_grad():
        o, probs = sa.short_attention_qkv_save(qkv, H, mask=mask)
        o_sep, probs_sep = sa.short_attention_sep_save(q, k, v, H, mask=mask)
        assert torch.equal(o, sa.short_attention_qkv(qkv, H, mask=mask))
        assert torch.equal(o_sep, sa.short_attention_sep(q, k, v, H, mask=mask))
    assert torch.equal(o, o_sep) and torch.equal(probs, probs_sep)
    o_ref, p_ref = sa.short_attention_qkv_reference(qkv, H, mask=mask, return_probs=True)
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL)
    torch.testing.assert_close(probs.float(), p_ref.float(), atol=1e-2, rtol=0)
    for packed, sep, want in (
            (sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask),
             sa.short_attention_sep_bwd(dout, q, k, v, o, H, mask=mask),
             sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, mask=mask)),
            (sa.short_attention_qkv_bwd_probs(dout, qkv, probs, H),
             sa.short_attention_sep_bwd_probs(dout, q, k, v, probs, H),
             sa.short_attention_qkv_bwd_probs_reference(dout, qkv, probs, H))):
        torch.cuda.synchronize()
        assert torch.equal(packed, torch.cat(sep, dim=-1))
        _grads_close(packed.chunk(3, dim=-1), want.chunk(3, dim=-1), ["dq", "dk", "dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("Dh", [24, 64, 128])
@pytest.mark.parametrize("S", [64, 65, 128, 129, 200, 255, 256])
def test_short_attention_fwd_matches_plain_in_both_modes(cuda_device, np_rng, S, Dh, masked, rope):
    """The forward at the sequence lengths its blocks treat differently (one
    block a head up to S=128 with one or two key tiles, two blocks and a
    recomputed score pass past it, a ragged last tile) and at Dh = 24 (one
    partial 64-column block; RoPE rotated element by element), 64 and 128:
    o and the probabilities against the plain version, with a row that has
    no real key where masked; o equal bit for bit with and without the
    probabilities, two launches equal byte for byte, and the packed entry
    equal bit for bit to the separate one on `qkv.chunk(3, -1)` views
    (without RoPE, which only the packed entry applies)."""
    B, H = 2, 3
    D = H * Dh
    qkv = torch.from_numpy(np_rng.normal(size=(B, S, 3 * D)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device) if masked else None
    pos = torch.arange(S, device=cuda_device) if rope else None
    kw = dict(mask=mask, rope_positions=pos)
    before = _build.LAUNCHES.snapshot()
    with torch.no_grad():
        o = sa.short_attention_qkv(qkv, H, **kw)
        o_save, probs = sa.short_attention_qkv_save(qkv, H, **kw)
        o_again, probs_again = sa.short_attention_qkv_save(qkv, H, **kw)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["short_attention"] == before["short_attention"] + 1
    assert after["short_attention_save"] == before["short_attention_save"] + 2
    o_ref, p_ref = sa.short_attention_qkv_reference(qkv, H, return_probs=True, **kw)
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL)
    torch.testing.assert_close(probs.float(), p_ref.float(), atol=1e-2, rtol=0)
    assert torch.equal(o, o_save) and torch.equal(o_save, o_again)
    assert torch.equal(probs, probs_again)
    if not rope:
        q, k, v = qkv.chunk(3, dim=-1)
        with torch.no_grad():
            o_sep = sa.short_attention_sep(q, k, v, H, mask=mask)
            o_sep_save, probs_sep = sa.short_attention_sep_save(q, k, v, H, mask=mask)
        assert torch.equal(o, o_sep) and torch.equal(o, o_sep_save)
        assert torch.equal(probs, probs_sep)


@pytest.mark.cuda
@pytest.mark.parametrize("S,Dh", [(65, 24), (128, 64), (200, 128)])
@pytest.mark.parametrize("saved", [False, True])
def test_short_attention_fwd_misaligned_operands_match_aligned(cuda_device, np_rng, S, Dh, saved):
    """Operands whose base is off 16 bytes (views one element into a wider
    buffer) stage by elements instead of TMA: the same o and probabilities,
    bit for bit, as contiguous copies of the same values."""
    B, H = 3, 2
    D = H * Dh
    wide = torch.from_numpy(np_rng.normal(size=(B, S, 3 * D + 1)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    q, k, v = wide[..., 1:].chunk(3, dim=-1)
    assert q.data_ptr() % 16 != 0
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    fn = sa.short_attention_sep_save if saved else sa.short_attention_sep
    with torch.no_grad():
        got, want = (fn(*ops, H, mask=mask) for ops in ((q, k, v), (q.contiguous(),
                                                                  k.contiguous(),
                                                                  v.contiguous())))
    torch.cuda.synchronize()
    got, want = ((t,) if torch.is_tensor(t) else t for t in (got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.testing.assert_close(got[0].float(), sa.short_attention_sep_reference(
        q, k, v, H, mask=mask).float(), **TOL)


@pytest.mark.cuda
def test_short_attention_fwd_refuses_past_its_bounds(cuda_device):
    """S <= 256, Dh a multiple of 8 up to 128 and B <= 65535, as before the
    redesign: each entry raises past them."""
    z = lambda *s: torch.zeros(*s, device=cuda_device, dtype=torch.bfloat16)  # noqa: E731
    with torch.no_grad():
        with pytest.raises(ValueError, match="S <= 256"):
            sa.short_attention_qkv(z(1, 257, 3 * 64), 1)
        with pytest.raises(ValueError, match="multiple of 8"):
            sa.short_attention_qkv_save(z(1, 64, 3 * 136), 1)
        with pytest.raises(ValueError, match="multiple of 8"):
            sa.short_attention_sep(z(1, 64, 12), z(1, 64, 12), z(1, 64, 12), 1)
        with pytest.raises(ValueError, match="B <= 65535"):
            t = z(65536, 1, 1, 8)
            sa.short_attention_sep_save(t, t, t, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["multihead_attention", "attention_dispatch"])
@pytest.mark.parametrize("save_rule", [True, False])
def test_attention_gates_take_the_sep_kernels(cuda_device, np_rng, monkeypatch, entry,
                                              save_rule):
    """`multihead_attention` and `attention_dispatch` in the band run only the
    separate-operand kernels on CUDA, in the mode the JAX rule picks (pinned
    here both ways), with gradients equal to autograd of the plain
    formulation; f32 and Dh > 128 raise with the kernel's bound."""
    monkeypatch.setattr(sa, "saves_probs", lambda *a: save_rule)
    B, S, D, H = 3, 100, 256, 4
    q, k, v, dout = _sep_operands(np_rng, cuda_device, B, S, D, H,
                                  "chunk" if entry == "multihead_attention" else "heads")
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    fn = ((lambda *t: multihead_attention(*t, H, mask=mask)) if entry == "multihead_attention"
          else (lambda *t: attention_dispatch(*t, mask=mask)))

    def run(plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        if plain:
            heads = [split_heads(t, H) if t.dim() == 3 else t for t in leaves]
            out = attention_reference(*heads, mask=mask)
            out = out.transpose(1, 2).reshape(B, S, D) if q.dim() == 3 else out
        else:
            out = fn(*leaves)
        out.backward(dout)
        return out.detach(), [t.grad for t in leaves]

    before = _build.LAUNCHES.snapshot()
    out, grads = run(False)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    ran = {n for n in after if after[n] != before[n]}
    assert ran == ({"short_attention_sep_save", "short_attention_sep_bwd_probs"} if save_rule
                   else {"short_attention_sep", "short_attention_sep_bwd"})
    want, want_grads = run(True)
    torch.testing.assert_close(out.float(), want.float(), **TOL)
    _grads_close(grads, want_grads, ["dq", "dk", "dv"])
    with pytest.raises(ValueError, match="bf16"):
        fn(*(t.float() for t in (q, k, v)))
    wide = torch.zeros(2, 2, S, 192, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 128, got 192"):
        attention_dispatch(wide, wide, wide)
