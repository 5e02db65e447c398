"""The port's fused row cross-entropy (clip_dplm_tpu_torch/ops/fused_infonce.py:
`fused_row_ce`, the plain versions of its three kernels) against the JAX
package's `fused_row_ce`, `_row_lse` and `_softmax_contractions` (Pallas in
interpret mode) on the same numpy inputs, at a non-square shape (m=40,
n=136, d=48) with shuffled labels, with and without a column-validity count:
the loss and dx, dy, dscale at the JAX suite's bounds (loss rtol 1e-5,
gradients atol 1e-5 / rtol 1e-4 in f32), and the train path's bf16 dot
dtype at the bf16 bound (loss rtol 1e-4, gradients atol 1e-4 / rtol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu.ops import infonce as jinf
from clip_dplm_tpu_torch.ops import fused_infonce as fi

F32_TOL = dict(loss_rtol=1e-5, atol=1e-5, rtol=1e-4)
BF16_TOL = dict(loss_rtol=1e-4, atol=1e-4, rtol=1e-3)
M, N, D = 40, 136, 48


def _inputs(n_valid, seed=0):
    """Normalized x (M, D), y (N, D), scale, and M distinct shuffled labels
    below n_valid (all of N when None)."""
    rng = np.random.default_rng(seed)
    x = np.array(jinf.l2_normalize(jnp.asarray(rng.normal(size=(M, D)).astype(np.float32))))
    y = np.array(jinf.l2_normalize(jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))))
    labels = rng.permutation(N if n_valid is None else n_valid)[:M].astype(np.int32)
    return x, y, np.float32(np.exp(2.3)), labels


def _jax_row_ce(x, y, scale, labels, n_valid, dot_dtype):
    nv = None if n_valid is None else jnp.int32(n_valid)

    def f(x, y, s):
        return jfi.fused_row_ce(x, y, s, jnp.asarray(labels), nv, dot_dtype)

    with pltpu.force_tpu_interpret_mode():
        loss, g = jax.value_and_grad(f, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale))
    return float(loss), [np.asarray(t) for t in g]


def _port_row_ce(fn, x, y, scale, labels, n_valid, dot_dtype, **kw):
    tx, ty, ts = (torch.tensor(v, requires_grad=True) for v in (x, y, scale))
    nv = None if n_valid is None else torch.tensor([n_valid], dtype=torch.int32)
    loss = fn(tx, ty, ts, torch.from_numpy(labels).long(), nv, dot_dtype, **kw)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in (tx, ty, ts)]


def _close(port, ref, loss_rtol, atol, rtol):
    np.testing.assert_allclose(port[0], ref[0], rtol=loss_rtol)
    for name, a, b in zip(("dx", "dy", "dscale"), port[1], ref[1]):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("n_valid", [None, 100])
@pytest.mark.parametrize("dot", ["f32", "bf16"])
def test_fused_row_ce_matches_jax(n_valid, dot):
    x, y, scale, labels = _inputs(n_valid)
    jdot, pdot, tol = ((None, None, F32_TOL) if dot == "f32"
                       else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    ref = _jax_row_ce(x, y, scale, labels, n_valid, jdot)
    _close(_port_row_ce(fi.fused_row_ce, x, y, scale, labels, n_valid, pdot), ref, **tol)


@pytest.mark.parametrize("n_valid", [None, 100])
def test_plain_kernel_versions_match_jax(n_valid):
    """The plain versions beside the kernels against the JAX functions that
    reach the Pallas kernels: the row lse, P y, rowsum(p raw), P^T x (bf16
    operands and p, f32 sums)."""
    x, y, scale, _ = _inputs(n_valid, seed=1)
    nv = None if n_valid is None else jnp.int32(n_valid)
    with pltpu.force_tpu_interpret_mode():
        lse = jfi._row_lse(jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale), n_valid=nv,
                           dot_dtype=jnp.bfloat16)
        py, rowdot, ptx = jfi._softmax_contractions(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale), lse, n_valid=nv,
            dot_dtype=jnp.bfloat16)
    tx, ty = (torch.from_numpy(v).bfloat16() for v in (x, y))
    ts = torch.tensor([scale])
    tnv = torch.tensor([N if n_valid is None else n_valid], dtype=torch.int32)
    got_lse = fi._plain_row_lse(tx, ty, ts, tnv)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, 0], rtol=1e-5, atol=1e-5)
    got_py, got_rowdot = fi._plain_row_dx(tx, ty, ts, got_lse, tnv)
    got_ptx = fi._plain_row_dy(tx, ty, ts, got_lse, N)
    for name, a, b in (("P y", got_py, py), ("rowdot", got_rowdot, np.asarray(rowdot)[:, 0]),
                       ("P^T x", got_ptx, ptx)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-3, err_msg=name)


def test_grad_rows_forms_the_leading_rows_only():
    """grad_rows = k: dy's first k rows are the full gradient's, the rest
    zero; the loss, dx and dscale do not change."""
    x, y, scale, labels = _inputs(100, seed=2)
    labels = labels % 64
    full = _port_row_ce(fi.fused_row_ce, x, y, scale, labels, 100, None)
    part = _port_row_ce(fi.fused_row_ce, x, y, scale, labels, 100, None, grad_rows=64)
    assert part[0] == full[0]
    np.testing.assert_array_equal(part[1][0], full[1][0])
    np.testing.assert_array_equal(part[1][2], full[1][2])
    np.testing.assert_allclose(part[1][1][:64], full[1][1][:64], rtol=1e-6, atol=1e-8)
    assert not part[1][1][64:].any()


def test_reference_matches_and_rejects():
    x, y, scale, labels = _inputs(None, seed=3)
    tx, ty, tl = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(labels).long()
    s, nv = torch.tensor(scale), torch.tensor([90], dtype=torch.int32)
    assert torch.equal(fi.fused_row_ce(tx, ty, s, tl, nv),
                       fi.fused_row_ce_reference(tx, ty, s, tl, nv))
    with pytest.raises(ValueError, match="labels"):
        fi.fused_row_ce(tx, ty, s, tl[:5])
    with pytest.raises(ValueError, match="grad_rows"):
        fi.fused_row_ce(tx, ty, s, tl, grad_rows=N + 1)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        fi.fused_row_ce(tx, ty[:, :8], s, tl)
    with pytest.raises(ValueError, match="no kernel"):
        fi.fused_row_ce(tx.to("meta"), ty.to("meta"), s.to("meta"), tl.to("meta"))
