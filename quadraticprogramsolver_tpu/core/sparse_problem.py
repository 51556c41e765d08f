"""Sparse QP container for the large-problem matrix-free path (ELL format).

The reference routes large/sparse problems to PCG instead of factorizing
(`SolveQuadraticProgram.m:190-204`) and leans on MKL sparse matvecs
(`SolveQuadraticProgram.jl:5`). The batched analogue stores P and A in **ELL
format** — every row padded to the matrix's max nonzeros-per-row, giving a
(rows, k) value array and a (rows, k) column-index array — so a sparse
matvec is one XLA gather plus dense elementwise math:

    y = sum_k vals[:, k] * x[cols[:, k]]

Transposed products A'w avoid scatter entirely by
also storing A' in row-ELL (its own gather). P is stored once (symmetric).

An optional **BCOO storage** (``make_sparse_qp(..., storage="bcoo")``) keeps
the same operator protocol on `jax.experimental.sparse.BCOO` matrices.
ELL pays for padding every row to the max row count; BCOO does not, and is
what the n=1e5 smoke phase runs (chip_smoke.py phase 5). ELL remains the
container default; both are covered by tests.

SparseQP is unbatched by design: the fleet axis is for dense padded
instances; a single huge sparse QP scales via consensus block-splitting
(parallel/consensus.py) instead.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .pytree import pytree_dataclass as _pytree_dataclass


def _ell_matvec(vals: jax.Array, cols: jax.Array, v: jax.Array) -> jax.Array:
    """(rows, k) ELL x (n,) -> (rows,): gather + rowwise dot."""
    return jnp.sum(vals * v[cols], axis=-1)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class SparseQP:
    """Box-constrained QP with ELL-format matrices (single instance).

    ``P_*``: (n, kP) rows of P;  ``A_*``: (m, kA) rows of A;
    ``At_*``: (n, kAt) rows of A' (pre-transposed so A'w is also a gather).
    Padding entries carry value 0 and column 0. ``dP``/``dAtA`` are
    precomputed diagonals for the Jacobi preconditioner.
    """

    P_vals: jax.Array
    P_cols: jax.Array
    A_vals: jax.Array
    A_cols: jax.Array
    At_vals: jax.Array
    At_cols: jax.Array
    q: jax.Array       # (n,)
    l: jax.Array       # (m,)
    u: jax.Array       # (m,)
    dP: jax.Array      # (n,) diag(P)
    dAtA: jax.Array    # (n,) diag(A'A)
    #: Optional BCOO storage (storage="bcoo"): the ELL fields above are then
    #: None and the matvecs dispatch on these instead. At_bcoo is A'
    #: materialized (its own row-major BCOO) so A'w never transposes.
    P_bcoo: jax.Array | None = None
    A_bcoo: jax.Array | None = None
    At_bcoo: jax.Array | None = None

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def m(self) -> int:
        return self.l.shape[0]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return ()

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def is_dense(self) -> bool:
        return False

    # -- operator protocol --

    def matvec_P(self, v: jax.Array) -> jax.Array:
        if self.P_bcoo is not None:
            return self.P_bcoo @ v
        return _ell_matvec(self.P_vals, self.P_cols, v)

    def matvec_A(self, v: jax.Array) -> jax.Array:
        if self.A_bcoo is not None:
            return self.A_bcoo @ v
        return _ell_matvec(self.A_vals, self.A_cols, v)

    def matvec_At(self, w: jax.Array) -> jax.Array:
        if self.At_bcoo is not None:
            return self.At_bcoo @ w
        return _ell_matvec(self.At_vals, self.At_cols, w)

    def diag_P(self) -> jax.Array:
        return self.dP

    def diag_AtA(self) -> jax.Array:
        return self.dAtA

    def diag_AtWA(self, w: jax.Array) -> jax.Array:
        """diag(A' diag(w) A) = sum_k At_vals^2 * w[At_cols] per row."""
        if self.At_bcoo is not None:
            # sum over A' rows: (A'_{ij})^2 w_j — one BCOO matvec on w with
            # squared values (same sparsity).
            from jax.experimental import sparse as jsparse

            sq = jsparse.BCOO((self.At_bcoo.data ** 2, self.At_bcoo.indices),
                              shape=self.At_bcoo.shape)
            return sq @ w
        return jnp.sum(self.At_vals ** 2 * w[self.At_cols], axis=-1)

    def objective(self, x: jax.Array) -> jax.Array:
        return 0.5 * jnp.sum(x * self.matvec_P(x), axis=-1) + jnp.sum(self.q * x, axis=-1)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class SparseProxQP:
    """Equality/inequality-split QP with ELL-format matrices (single instance)
    for the matrix-free prox-ALM path.

    Sparse analogue of :class:`~..core.problem.ProxQPProblem` — the role of
    the reference's sparse ProxQP constructor + CHOLMOD in-place
    refactorization (`/root/reference/ProxQP.jl:95-115, 201-206`), except the
    batched path never factorizes: the inner solve is Jacobi-preconditioned CG on
    M = P + sigma*I + rho*(A'A + C'C), so a "refactor" on rho drift is just a
    diagonal refresh. Matrices are stored row-ELL with pre-transposed copies
    (see :class:`SparseQP` for the layout rationale).
    """

    P_vals: jax.Array
    P_cols: jax.Array
    A_vals: jax.Array      # (me, kA) equality rows
    A_cols: jax.Array
    At_vals: jax.Array     # (n, kAt) A' rows
    At_cols: jax.Array
    C_vals: jax.Array      # (mi, kC) inequality rows
    C_cols: jax.Array
    Ct_vals: jax.Array     # (n, kCt) C' rows
    Ct_cols: jax.Array
    q: jax.Array           # (n,)
    b: jax.Array           # (me,)
    d: jax.Array           # (mi,)
    dP: jax.Array          # (n,) diag(P)
    dAtA: jax.Array        # (n,) diag(A'A)
    dCtC: jax.Array        # (n,) diag(C'C)
    #: Optional BCOO storage (storage="bcoo"); see SparseQP.
    P_bcoo: jax.Array | None = None
    A_bcoo: jax.Array | None = None
    At_bcoo: jax.Array | None = None
    C_bcoo: jax.Array | None = None
    Ct_bcoo: jax.Array | None = None

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def n_eq(self) -> int:
        return self.b.shape[0]

    @property
    def n_ineq(self) -> int:
        return self.d.shape[0]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return ()

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def is_dense(self) -> bool:
        return False

    # -- operator protocol (same contract as ProxQPProblem) --

    def matvec_P(self, v: jax.Array) -> jax.Array:
        if self.P_bcoo is not None:
            return self.P_bcoo @ v
        return _ell_matvec(self.P_vals, self.P_cols, v)

    def matvec_A(self, v: jax.Array) -> jax.Array:
        if self.A_bcoo is not None:
            return self.A_bcoo @ v
        return _ell_matvec(self.A_vals, self.A_cols, v)

    def matvec_At(self, w: jax.Array) -> jax.Array:
        if self.At_bcoo is not None:
            return self.At_bcoo @ w
        return _ell_matvec(self.At_vals, self.At_cols, w)

    def matvec_C(self, v: jax.Array) -> jax.Array:
        if self.C_bcoo is not None:
            return self.C_bcoo @ v
        return _ell_matvec(self.C_vals, self.C_cols, v)

    def matvec_Ct(self, w: jax.Array) -> jax.Array:
        if self.Ct_bcoo is not None:
            return self.Ct_bcoo @ w
        return _ell_matvec(self.Ct_vals, self.Ct_cols, w)

    def diag_P(self) -> jax.Array:
        return self.dP

    def diag_AtA(self) -> jax.Array:
        return self.dAtA

    def diag_CtC(self) -> jax.Array:
        return self.dCtC


def _to_ell(M, dtype) -> tuple[np.ndarray, np.ndarray]:
    """scipy sparse -> (vals (rows, k), cols (rows, k)) with zero padding.

    Vectorized scatter (no per-row Python loop — at n=1e5 the loop costs
    seconds of setup): entry j of row i lands at flat position i*k + (j -
    indptr[i])."""
    import scipy.sparse as sp

    M = sp.csr_matrix(M)
    M.sort_indices()
    rows = M.shape[0]
    counts = np.diff(M.indptr)
    k = max(int(counts.max()) if rows else 0, 1)
    vals = np.zeros((rows, k), dtype)
    cols = np.zeros((rows, k), np.int32)
    if M.nnz:
        row_of = np.repeat(np.arange(rows), counts)
        offset = np.arange(M.nnz) - np.repeat(M.indptr[:-1], counts)
        vals[row_of, offset] = M.data
        cols[row_of, offset] = M.indices
    return vals, cols


def _to_bcoo(M, dtype):
    """scipy sparse -> row-major-sorted BCOO."""
    import scipy.sparse as sp
    from jax.experimental import sparse as jsparse

    M = sp.csr_matrix(M).astype(dtype)
    M.sort_indices()
    coo = M.tocoo()
    idx = np.stack([coo.row.astype(np.int32), coo.col.astype(np.int32)], 1)
    return jsparse.BCOO((jnp.asarray(coo.data), jnp.asarray(idx)),
                        shape=M.shape, indices_sorted=True,
                        unique_indices=True)


def make_sparse_qp(P, q, A, l, u, dtype=np.float32,
                   storage: str = "ell") -> SparseQP:
    """Build a SparseQP from scipy sparse matrices (host-side).

    ``storage``: "ell" (default) or "bcoo" — see the module docstring for
    the measured trade-off.
    """
    import scipy.sparse as sp

    P = sp.csr_matrix(P).astype(dtype)
    A = sp.csr_matrix(A).astype(dtype)
    dP = np.asarray(P.diagonal(), dtype)
    dAtA = np.asarray(A.multiply(A).sum(axis=0)).ravel().astype(dtype)
    common = dict(
        q=jnp.asarray(np.asarray(q, dtype)),
        l=jnp.asarray(np.asarray(l, dtype)),
        u=jnp.asarray(np.asarray(u, dtype)),
        dP=jnp.asarray(dP), dAtA=jnp.asarray(dAtA))
    if storage == "bcoo":
        return SparseQP(
            P_vals=None, P_cols=None, A_vals=None, A_cols=None,
            At_vals=None, At_cols=None,
            P_bcoo=_to_bcoo(P, dtype), A_bcoo=_to_bcoo(A, dtype),
            At_bcoo=_to_bcoo(A.T.tocsr(), dtype), **common)
    if storage != "ell":
        raise ValueError(f"storage must be 'ell' or 'bcoo'; got {storage!r}")
    Pv, Pc = _to_ell(P, dtype)
    Av, Ac = _to_ell(A, dtype)
    Atv, Atc = _to_ell(A.T.tocsr(), dtype)
    return SparseQP(
        P_vals=jnp.asarray(Pv), P_cols=jnp.asarray(Pc),
        A_vals=jnp.asarray(Av), A_cols=jnp.asarray(Ac),
        At_vals=jnp.asarray(Atv), At_cols=jnp.asarray(Atc), **common)


def make_sparse_proxqp(P, q, A, b, C, d, dtype=np.float32,
                       storage: str = "ell") -> SparseProxQP:
    """Build a SparseProxQP from scipy sparse matrices (host-side).

    Role of the reference's sparse ProxQP constructor (ProxQP.jl:95-115),
    minus the factorization — the matrix-free path needs only operators and
    Jacobi diagonals. ``storage``: "ell" (default) or "bcoo".
    """
    import scipy.sparse as sp

    P = sp.csr_matrix(P).astype(dtype)
    A = sp.csr_matrix(A).astype(dtype)
    C = sp.csr_matrix(C).astype(dtype)
    common = dict(
        q=jnp.asarray(np.asarray(q, dtype)),
        b=jnp.asarray(np.asarray(b, dtype)),
        d=jnp.asarray(np.asarray(d, dtype)),
        dP=jnp.asarray(np.asarray(P.diagonal(), dtype)),
        dAtA=jnp.asarray(np.asarray(A.multiply(A).sum(axis=0)).ravel().astype(dtype)),
        dCtC=jnp.asarray(np.asarray(C.multiply(C).sum(axis=0)).ravel().astype(dtype)))
    if storage == "bcoo":
        return SparseProxQP(
            P_vals=None, P_cols=None, A_vals=None, A_cols=None,
            At_vals=None, At_cols=None, C_vals=None, C_cols=None,
            Ct_vals=None, Ct_cols=None,
            P_bcoo=_to_bcoo(P, dtype), A_bcoo=_to_bcoo(A, dtype),
            At_bcoo=_to_bcoo(A.T.tocsr(), dtype), C_bcoo=_to_bcoo(C, dtype),
            Ct_bcoo=_to_bcoo(C.T.tocsr(), dtype), **common)
    if storage != "ell":
        raise ValueError(f"storage must be 'ell' or 'bcoo'; got {storage!r}")
    Pv, Pc = _to_ell(P, dtype)
    Av, Ac = _to_ell(A, dtype)
    Atv, Atc = _to_ell(A.T.tocsr(), dtype)
    Cv, Cc = _to_ell(C, dtype)
    Ctv, Ctc = _to_ell(C.T.tocsr(), dtype)
    return SparseProxQP(
        P_vals=jnp.asarray(Pv), P_cols=jnp.asarray(Pc),
        A_vals=jnp.asarray(Av), A_cols=jnp.asarray(Ac),
        At_vals=jnp.asarray(Atv), At_cols=jnp.asarray(Atc),
        C_vals=jnp.asarray(Cv), C_cols=jnp.asarray(Cc),
        Ct_vals=jnp.asarray(Ctv), Ct_cols=jnp.asarray(Ctc), **common)
