"""Small batched linear-algebra primitives shared by solvers and backends.

Everything here operates on arrays with arbitrary leading batch axes and
lowers to batched matmuls, factorizations and fused elementwise/reduction
kernels under XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matvec(M: jax.Array, v: jax.Array) -> jax.Array:
    """Batched M @ v: (*B, r, c) x (*B, c) -> (*B, r)."""
    return jnp.einsum("...ij,...j->...i", M, v)


def matvec_t(M: jax.Array, v: jax.Array) -> jax.Array:
    """Batched M.T @ v: (*B, r, c) x (*B, r) -> (*B, c)."""
    return jnp.einsum("...ij,...i->...j", M, v)


def inf_norm(v: jax.Array) -> jax.Array:
    """Batched infinity norm over the last axis; 0 for empty vectors."""
    if v.shape[-1] == 0:
        return jnp.zeros(v.shape[:-1], v.dtype)
    return jnp.max(jnp.abs(v), axis=-1)


def inf_norm_diff(a: jax.Array, b: jax.Array) -> jax.Array:
    """Fused ||a - b||_inf (reference `_NormInfDif`, ProxQP.jl:300-309)."""
    return inf_norm(a - b)


def batch_identity(batch_shape: tuple[int, ...], n: int, dtype) -> jax.Array:
    return jnp.broadcast_to(jnp.eye(n, dtype=dtype), batch_shape + (n, n))


def add_scaled_identity(M: jax.Array, s) -> jax.Array:
    """M + s*I on the last two axes; s scalar or batched (*B,)."""
    n = M.shape[-1]
    eye = jnp.eye(n, dtype=M.dtype)
    s = jnp.asarray(s, M.dtype)
    return M + s[..., None, None] * eye if s.ndim else M + s * eye


def sym(M: jax.Array) -> jax.Array:
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def spsd_sqrt(A: jax.Array, rank_tol: float = 1e-10) -> jax.Array:
    """Batched M with M'M = A for (possibly singular) symmetric PSD A.

    Role of the reference's `CalcSPSDSquareRoot` (SPSDMatSquareRoot.jl:63-118),
    which does pivoted-QR rank detection + reduced Cholesky (dense) or shifted
    Cholesky (sparse). The batched idiom is an eigendecomposition: with
    A = V diag(w) V', M = diag(sqrt(w_clipped)) V' satisfies M'M = A, and
    eigenvalues below rank_tol * max(w) are clipped to zero — the same
    numerical-rank cutoff as the reference's R-diagonal test (:100-101).
    Returns M of shape (*B, n, n) (rows beyond the rank are zero).
    """
    w, V = jnp.linalg.eigh(sym(A))
    w_max = jnp.max(jnp.abs(w), axis=-1, keepdims=True)
    w = jnp.where(w > rank_tol * w_max, w, 0.0)
    return jnp.sqrt(w)[..., None] * jnp.swapaxes(V, -1, -2)


def spd_inverse(M: jax.Array) -> jax.Array:
    """Batched SPD inverse (:func:`spd_inverse_blocked`).

    The explicit inverse turns every downstream solve into one batched
    matvec with no sequential triangular dependency — the analogue of the
    reference caching a CHOLMOD/QDLDL factorization and calling ldiv! per
    iteration (LinearSystemSolvers.jl:30-44). Combined with iterative
    refinement this recovers direct-solve accuracy.
    """
    return spd_inverse_blocked(M)


def spd_solve(M: jax.Array, R: jax.Array) -> jax.Array:
    """Batched SPD multi-RHS solve M X = R ((*B, n, n) x (*B, n, k)) without
    materializing M^{-1}: Cholesky factor, then two triangular solves
    (cuSOLVER and cuBLAS on the GPU)."""
    L = jnp.linalg.cholesky(M)
    return jax.scipy.linalg.cho_solve((L, True), R)


# Below this size the matmul recursion stops paying; use the LAPACK-style path.
_SPD_BASE_N = 64


def _spd_inverse_cholesky(M: jax.Array) -> jax.Array:
    L = jnp.linalg.cholesky(M)
    eye = batch_identity(M.shape[:-2], M.shape[-1], M.dtype)
    inv = jax.scipy.linalg.cho_solve((L, True), eye)
    return sym(inv)


def spd_inverse_blocked(M: jax.Array, split: bool = False) -> jax.Array:
    """Recursive blocked SPD inverse: with M = [[A, B'], [B, C]],

        S = C - B A^{-1} B'          (SPD Schur complement)
        M^{-1} = [[A^{-1} + W' S^{-1} W,  -W' S^{-1}],
                  [-S^{-1} W,              S^{-1}]],   W = B A^{-1}.

    Two half-size recursive inversions + four batched matmuls per level.
    Only the final result is symmetrized — intermediate blocks are
    symmetric up to roundoff by construction, and each extra sym() is a
    full memory pass over B*n^2.
    """
    return sym(_spd_inverse_blocked_raw(M))


def _spd_inverse_blocked_raw(M: jax.Array) -> jax.Array:
    n = M.shape[-1]
    if n <= _SPD_BASE_N or n % 2:
        return _spd_inverse_cholesky(M)
    h = n // 2
    A = M[..., :h, :h]
    B = M[..., h:, :h]
    C = M[..., h:, h:]
    A_inv = _spd_inverse_blocked_raw(A)
    W = jnp.einsum("...ij,...jk->...ik", B, A_inv)
    S = C - jnp.einsum("...ij,...kj->...ik", W, B)
    S_inv = _spd_inverse_blocked_raw(S)
    SW = jnp.einsum("...ij,...jk->...ik", S_inv, W)
    top_left = A_inv + jnp.einsum("...ji,...jk->...ik", W, SW)
    top = jnp.concatenate([top_left, -jnp.swapaxes(SW, -1, -2)], axis=-1)
    bot = jnp.concatenate([-SW, S_inv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)
