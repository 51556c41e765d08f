"""Batched linear-algebra primitive tests (ops/linalg.py)."""

import numpy as np
import pytest

from quadraticprogramsolver_tpu.ops import linalg


def _spd(batch, n, seed=0, cond=None):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal(batch + (n, n))
    A = np.einsum("...ij,...kj->...ik", W, W) + n * 0.01 * np.eye(n)
    return A


@pytest.mark.parametrize("n", [16, 64, 96, 128, 256])
def test_spd_inverse_blocked_matches_numpy(n):
    A = _spd((3,), n)
    inv = np.asarray(linalg.spd_inverse(A))
    ref = np.linalg.inv(A)
    scale = np.abs(ref).max()
    assert np.abs(inv - ref).max() / scale <= 1e-9, n
    # Symmetric output.
    assert np.abs(inv - np.swapaxes(inv, -1, -2)).max() <= 1e-12


def test_spd_inverse_odd_size_falls_back():
    A = _spd((), 67)
    inv = np.asarray(linalg.spd_inverse(A))
    assert np.abs(inv @ A - np.eye(67)).max() <= 1e-7


def test_spd_inverse_ill_conditioned():
    # cond ~ 1e6 like the sigma-regularized normal matrix.
    rng = np.random.default_rng(1)
    n = 128
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.logspace(-6, 0, n)
    A = (Q * w) @ Q.T
    inv = np.asarray(linalg.spd_inverse(A))
    err = np.abs(inv @ A - np.eye(n)).max()
    assert err <= 1e-6, err


def test_inf_norm_empty():
    import jax.numpy as jnp

    assert float(linalg.inf_norm(jnp.zeros((3, 0)))[0]) == 0.0


def test_spd_inverse_blocked_accuracy():
    """Blocked-Schur inverse: refinement-recoverable f32 error."""
    import jax.numpy as jnp
    from quadraticprogramsolver_tpu.ops.linalg import spd_inverse

    rng = np.random.default_rng(1)
    n = 256
    W = rng.standard_normal((2, n, n)).astype(np.float32)
    M = np.einsum("bki,bkj->bij", W, W) + n * np.eye(n, dtype=np.float32)
    exact = np.linalg.inv(np.asarray(M, np.float64))
    got = np.asarray(spd_inverse(jnp.asarray(M)))
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert rel < 1e-4, rel
    # One refinement step contracts the residual: ||I - got@M|| must be << 1.
    resid = np.abs(np.eye(n) - got @ np.asarray(M, np.float64)).max()
    assert resid < 1e-2, resid


def test_spd_solve_dispatcher():
    M = _spd((2,), 64, seed=6)
    rng = np.random.default_rng(7)
    R = rng.standard_normal((2, 64, 5))
    X = np.asarray(linalg.spd_solve(M, R))
    ref = np.linalg.solve(M, R)
    assert np.abs(X - ref).max() / np.abs(ref).max() <= 1e-9


# The factor's real shapes: n up to the headline 512, RHS width 1 (g alone)
# and m + 1 = 257 ([A' q] at m=256), odd n (65: the blocked recursion's
# Cholesky fallback), and 0/1/2 batch axes.
SPD_N = [8, 64, 65, 128, 512]
SPD_BATCH = [(), (3,), (2, 3)]
SPD_DTYPE = [np.float32, np.float64]
#: Relative error bars: ~cond * eps for these well-conditioned matrices
#: (cond <= ~400 with the n * 0.01 shift and n <= 512).
SPD_TOL = {np.float32: 2e-4, np.float64: 1e-9}


def _spd_cast(batch, n, dtype, seed):
    # Normalized so the spectrum sits in [0.01, ~4] at every n.
    return (_spd(batch, n, seed=seed) / n).astype(dtype)


@pytest.mark.parametrize("dtype", SPD_DTYPE, ids=["f32", "f64"])
@pytest.mark.parametrize("batch", SPD_BATCH, ids=str)
@pytest.mark.parametrize("k", [1, 257])
@pytest.mark.parametrize("n", SPD_N)
def test_spd_solve_matches_numpy(n, k, batch, dtype):
    """Cholesky + cho_solve multi-RHS solve against numpy in f64."""
    import jax.numpy as jnp

    M = _spd_cast(batch, n, dtype, seed=n + k)
    R = np.random.default_rng(k).standard_normal(batch + (n, k)).astype(dtype)
    X = np.asarray(linalg.spd_solve(jnp.asarray(M), jnp.asarray(R)))
    assert X.shape == batch + (n, k) and X.dtype == dtype
    ref = np.linalg.solve(M.astype(np.float64), R.astype(np.float64))
    rel = np.abs(X - ref).max() / np.abs(ref).max()
    assert rel <= SPD_TOL[dtype], rel


@pytest.mark.parametrize("dtype", SPD_DTYPE, ids=["f32", "f64"])
@pytest.mark.parametrize("batch", SPD_BATCH, ids=str)
@pytest.mark.parametrize("n", SPD_N)
def test_spd_inverse_blocked_vs_numpy(n, batch, dtype):
    """Blocked-Schur inverse (recursion for even n > 64, Cholesky base
    otherwise) against numpy in f64; the result is exactly symmetric."""
    import jax.numpy as jnp

    M = _spd_cast(batch, n, dtype, seed=n)
    inv = np.asarray(linalg.spd_inverse_blocked(jnp.asarray(M)))
    assert inv.shape == batch + (n, n) and inv.dtype == dtype
    ref = np.linalg.inv(M.astype(np.float64))
    rel = np.abs(inv - ref).max() / np.abs(ref).max()
    assert rel <= SPD_TOL[dtype], rel
    assert np.array_equal(inv, np.swapaxes(inv, -1, -2))
