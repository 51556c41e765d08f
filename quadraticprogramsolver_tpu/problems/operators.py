"""Structured constraint/objective operators for application-level QPs.

Re-implements the operator builders of the reference's ProxQP demos
(`/root/reference/ProxQP002.jl:69-128`): finite-difference operators of a
given order (smoothing objectives) and piecewise-monotonicity constraint
operators (shape-constrained regression) — the building blocks of the
monotone-spline smoothing application (ProxQP002.jl:131-212).

Host-side numpy builders (these are problem-construction utilities; the
solve runs on the device with the resulting dense/batched operators).
"""

from __future__ import annotations

import numpy as np

# Central finite-difference stencils by derivative order (ProxQP002.jl:71-78).
_DIFF_COEFFS = {
    1: [-0.5, 0.0, 0.5],
    2: [1.0, -2.0, 1.0],
    3: [-0.5, 1.0, 0.0, -1.0, 0.5],
    4: [1.0, -4.0, 6.0, -4.0, 1.0],
    5: [-0.5, 2.0, -2.5, 0.0, 2.5, -2.0, 0.5],
    6: [1.0, -6.0, 15.0, -20.0, 15.0, -6.0, 1.0],
}


def difference_operator(order: int, num_samples: int) -> np.ndarray:
    """Dense (num_samples - 2r, num_samples) central-difference operator of
    the given derivative order (GenDiffOp, ProxQP002.jl:69-89)."""
    if order not in _DIFF_COEFFS:
        raise ValueError(f"order must be in {sorted(_DIFF_COEFFS)}; got {order}")
    c = np.asarray(_DIFF_COEFFS[order])
    radius = (len(c) - 1) // 2
    rows = num_samples - 2 * radius
    if rows <= 0:
        raise ValueError("num_samples too small for this stencil")
    D = np.zeros((rows, num_samples))
    for i in range(rows):
        D[i, i : i + len(c)] = c
    return D


def monotonicity_operator(ref_idx, ref_y) -> np.ndarray:
    """Piecewise-monotonicity constraint operator (GenMonoOp, ProxQP002.jl:91-128).

    For sorted reference indices ``ref_idx`` into the full length-N sample
    vector ``ref_y`` (the whole signal, matching GenMonoOp's vY), builds M
    such that
    ``M x <= 0`` forces x to be monotone on each segment, non-decreasing where
    the reference values increase and non-increasing where they decrease.
    Rows cover samples ref_idx[0] .. ref_idx[-1]-1; each row is
    +-(x_j - x_{j+1}).
    """
    ref_idx = np.asarray(ref_idx, int)
    ref_y = np.asarray(ref_y, float)
    if ref_idx.ndim != 1 or ref_idx.size < 2:
        raise ValueError("need at least two sorted reference indices")
    if np.any(np.diff(ref_idx) <= 0):
        raise ValueError("ref_idx must be strictly increasing")
    n = ref_idx.size
    if int(ref_idx[-1]) >= ref_y.size:
        raise ValueError("ref_idx exceeds the sample length")
    start, end = int(ref_idx[0]), int(ref_idx[-1])
    M = np.zeros((end - start, ref_y.size))
    for seg in range(n - 1):
        a, b = int(ref_idx[seg]), int(ref_idx[seg + 1])
        # Non-decreasing segment: x_j - x_{j+1} <= 0; flip sign if decreasing.
        sign = 1.0 if ref_y[a] <= ref_y[b] else -1.0
        for j in range(a, b):
            row = j - start
            M[row, j] = sign
            M[row, j + 1] = -sign
    return M


def monotone_smoothing_qp(y: np.ndarray, ref_idx, smooth_order: int = 2,
                          lam: float = 1.0):
    """Monotone-spline smoothing as a split-form QP (ProxQP002.jl:131-212):

        min_x 0.5||x - y||^2 + 0.5*lam*||D x||^2   s.t.  M x <= 0

    Returns (P, q, C, d) for the ProxQP front-end (no equality constraints).
    """
    y = np.asarray(y, float)
    n = y.size
    D = difference_operator(smooth_order, n)
    P = np.eye(n) + lam * (D.T @ D)
    q = -y
    C = monotonicity_operator(ref_idx, y)
    d = np.zeros(C.shape[0])
    return P, q, C, d


def difference_operator_sparse(order: int, num_samples: int):
    """Sparse CSR version of :func:`difference_operator` — the banded
    stencil matrix scales to n >= 1e5 where the dense builder would allocate
    O(n^2)."""
    import scipy.sparse as sp

    if order not in _DIFF_COEFFS:
        raise ValueError(f"order must be in {sorted(_DIFF_COEFFS)}; got {order}")
    c = np.asarray(_DIFF_COEFFS[order])
    radius = (len(c) - 1) // 2
    rows = num_samples - 2 * radius
    if rows <= 0:
        raise ValueError("num_samples too small for this stencil")
    return sp.diags([np.full(rows, ci) for ci in c],
                    offsets=list(range(len(c))),
                    shape=(rows, num_samples), format="csr")


def monotonicity_operator_sparse(ref_idx, ref_y):
    """Sparse CSR version of :func:`monotonicity_operator` (two nonzeros per
    row)."""
    import scipy.sparse as sp

    ref_idx = np.asarray(ref_idx, int)
    ref_y = np.asarray(ref_y, float)
    if ref_idx.ndim != 1 or ref_idx.size < 2:
        raise ValueError("need at least two sorted reference indices")
    if np.any(np.diff(ref_idx) <= 0):
        raise ValueError("ref_idx must be strictly increasing")
    if int(ref_idx[-1]) >= ref_y.size:
        raise ValueError("ref_idx exceeds the sample length")
    start, end = int(ref_idx[0]), int(ref_idx[-1])
    rows = end - start
    j = np.arange(start, end)
    # Segment sign per sample row: non-decreasing where the reference rises.
    seg = np.searchsorted(ref_idx, j, side="right") - 1
    sign = np.where(ref_y[ref_idx[seg]] <= ref_y[ref_idx[np.minimum(
        seg + 1, ref_idx.size - 1)]], 1.0, -1.0)
    data = np.concatenate([sign, -sign])
    rows_idx = np.concatenate([j - start, j - start])
    cols_idx = np.concatenate([j, j + 1])
    return sp.csr_matrix((data, (rows_idx, cols_idx)),
                         shape=(rows, ref_y.size))


def monotone_smoothing_sparse_qp(y: np.ndarray, ref_idx,
                                 smooth_order: int = 2, lam: float = 1.0):
    """Sparse version of :func:`monotone_smoothing_qp`: returns scipy-sparse
    (P, q, C, d) suitable for `make_sparse_proxqp` — the matrix-free ProxQP
    path for n >= 5e4 signals (ProxQP002.jl's application at scale)."""
    import scipy.sparse as sp

    y = np.asarray(y, float)
    n = y.size
    D = difference_operator_sparse(smooth_order, n)
    P = (sp.eye(n, format="csr") + lam * (D.T @ D)).tocsr()
    q = -y
    C = monotonicity_operator_sparse(ref_idx, y)
    d = np.zeros(C.shape[0])
    return P, q, C, d
