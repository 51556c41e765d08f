"""Canonical QP problem containers (device-side pytrees + host-side builders).

The canonical form matches the reference solver's
(`/root/reference/SolveQuadraticProgram.m:4-5`,
`/root/reference/SolveQuadraticProgram.jl:14`):

    min_x  0.5 x'Px + q'x   s.t.   l <= Ax <= u,   P PSD.

Design notes
------------
* Problems are stored **dense and batched**: every array carries an optional
  leading batch axis ``(B, ...)`` so thousands of independent QPs run as one
  XLA program (batched matmuls). The reference solves one sparse problem at
  a time on CPU; on an accelerator the dominant axis of scale is the fleet of
  independent instances (MPC/scenario batches), so batching is built into the
  problem type rather than bolted on via ``vmap`` of scalar code.
* Shapes are static. Fleets of mixed sizes are zero-padded to a common
  ``(n, m)`` by :func:`pad_qp` — padded rows use bounds ``(-inf, +inf)`` so
  they never constrain, and padded variables get an identity quadratic so the
  KKT system stays nonsingular.
* ``l``/``u`` may contain ``+/-inf`` exactly as the reference's generator
  emits for one-sided constraints (`GenerateQuadraticProgram.jl:60,75,91`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .pytree import pytree_dataclass as _pytree_dataclass


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class QP:
    """A (possibly batched) dense box-constrained QP.

    Shapes (``B`` = optional leading batch axes, possibly empty):
        P: (*B, n, n)   symmetric PSD quadratic term
        q: (*B, n)      linear term
        A: (*B, m, n)   constraint matrix
        l: (*B, m)      lower bounds (may be -inf)
        u: (*B, m)      upper bounds (may be +inf)
    """

    P: jax.Array
    q: jax.Array
    A: jax.Array
    l: jax.Array
    u: jax.Array

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.q.shape[:-1]

    @property
    def dtype(self):
        return self.P.dtype

    def astype(self, dtype) -> "QP":
        return QP(*(x.astype(dtype) for x in (self.P, self.q, self.A, self.l, self.u)))

    # -- operator protocol (shared with SparseQP; solvers program against it) --

    def matvec_P(self, v: jax.Array) -> jax.Array:
        return jnp.einsum("...ij,...j->...i", self.P, v)

    def matvec_A(self, v: jax.Array) -> jax.Array:
        return jnp.einsum("...ij,...j->...i", self.A, v)

    def matvec_At(self, v: jax.Array) -> jax.Array:
        return jnp.einsum("...ij,...i->...j", self.A, v)

    def diag_P(self) -> jax.Array:
        return jnp.diagonal(self.P, axis1=-2, axis2=-1)

    def diag_AtA(self) -> jax.Array:
        return jnp.sum(self.A * self.A, axis=-2)

    def diag_AtWA(self, w: jax.Array) -> jax.Array:
        """diag(A' diag(w) A) for per-row penalty weights w (*B, m)."""
        return jnp.einsum("...ki,...k->...i", self.A * self.A, w)

    @property
    def is_dense(self) -> bool:
        return True

    def objective(self, x: jax.Array) -> jax.Array:
        """0.5 x'Px + q'x, batched over leading axes."""
        return 0.5 * jnp.sum(x * self.matvec_P(x), axis=-1) + jnp.sum(self.q * x, axis=-1)


def validate_qp(qp: QP) -> None:
    """Host-side shape/symmetry validation.

    Mirrors the reference's error branches (`SolveQuadraticProgram.m:150-184`)
    but runs once at problem-build time rather than inside the solve.
    """
    n, m = qp.n, qp.m
    if qp.P.shape[-2:] != (n, n):
        raise ValueError(f"P must be square (n, n); got {qp.P.shape}")
    if qp.q.shape[-1] != n:
        raise ValueError(f"q must have {n} elements; got {qp.q.shape}")
    if qp.A.shape[-1] != n:
        raise ValueError(f"A must have n={n} columns; got {qp.A.shape}")
    if qp.l.shape[-1] != m or qp.u.shape[-1] != m:
        raise ValueError(f"l/u must have m={m} elements; got {qp.l.shape}/{qp.u.shape}")
    if qp.q.shape[:-1] != qp.P.shape[:-2]:
        raise ValueError("batch shapes of P and q disagree")
    P = np.asarray(qp.P)
    if not np.allclose(P, np.swapaxes(P, -1, -2), atol=1e-6 * (1.0 + np.abs(P).max())):
        raise ValueError("P must be symmetric")
    # OSQP validates l <= u at setup: inverted bounds make the box empty in a
    # way the §3.4 Farkas certificates cannot express (they presuppose l <= u),
    # so the solve would stall on clip(v, l, u) = u instead of flagging.
    if np.any(np.asarray(qp.l) > np.asarray(qp.u)):
        raise ValueError("bounds must satisfy l <= u elementwise")


def make_qp(P, q, A, l, u, dtype=None) -> QP:
    """Build a QP from array-likes (incl. scipy sparse), densifying as needed."""
    arrs = [_densify(x) for x in (P, q, A, l, u)]
    if dtype is not None:
        arrs = [np.asarray(x, dtype=dtype) for x in arrs]
    return QP(*(jnp.asarray(x) for x in arrs))


def _densify(x) -> np.ndarray:
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    return np.asarray(x)


def stack_qps(qps: list[QP], pad: bool = False) -> QP:
    """Stack QPs into one batched QP (leading axis = fleet).

    ``pad=True`` admits MIXED problem sizes: every instance is zero-padded
    (:func:`pad_qp` — inert variables/rows, provably non-binding) to the
    fleet's max (n, m) so heterogeneous problems share one executable —
    the SURVEY §7 size-bucketing discipline as an API. Callers slice each
    lane's solution back with its own n (``sol.x[i, :n_i]``).
    """
    if pad:
        n_max = max(q.n for q in qps)
        m_max = max(q.m for q in qps)
        qps = [pad_qp(q, n_max, m_max) for q in qps]
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *qps)


def pad_qp(qp: QP, n_pad: int, m_pad: int) -> QP:
    """Zero-pad a QP to static shape (n_pad, m_pad) without changing its solution.

    Padded variables get P[i,i]=1, q[i]=0 (their optimum is 0 and they couple
    to nothing); padded constraint rows are all-zero with bounds (-inf, +inf)
    so the projection never binds and the dual stays 0. This is the batched
    replacement for the reference's per-problem dynamic sizes — static shapes
    let fleets of heterogeneous QPs share one compiled executable.
    """
    n, m = qp.n, qp.m
    if n_pad < n or m_pad < m:
        raise ValueError(f"pad target ({n_pad},{m_pad}) smaller than problem ({n},{m})")
    if n_pad == n and m_pad == m:
        return qp
    dn, dm = n_pad - n, m_pad - m
    batch = qp.batch_shape
    dt = qp.dtype

    def bpad(x, pads):
        cfg = [(0, 0)] * len(batch) + pads
        return jnp.pad(x, cfg)

    P = bpad(qp.P, [(0, dn), (0, dn)])
    if dn:
        eye = jnp.zeros((n_pad, n_pad), dt).at[jnp.arange(n, n_pad), jnp.arange(n, n_pad)].set(1.0)
        P = P + jnp.broadcast_to(eye, P.shape)
    q = bpad(qp.q, [(0, dn)])
    A = bpad(qp.A, [(0, dm), (0, dn)])
    l = jnp.concatenate(
        [qp.l, jnp.full(batch + (dm,), -jnp.inf, dt)], axis=-1) if dm else qp.l
    u = jnp.concatenate(
        [qp.u, jnp.full(batch + (dm,), jnp.inf, dt)], axis=-1) if dm else qp.u
    return QP(P, q, A, l, u)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class ProxQPProblem:
    """Equality/inequality-split QP for the prox-ALM (ProxQP-style) solver.

        min 0.5 x'Px + q'x   s.t.  Ax = b,  Cx <= d

    Mirrors the reference's ProxQP struct fields (`/root/reference/ProxQP.jl:8-34`)
    as a dense batched pytree.
    Shapes: P (*B,n,n), q (*B,n), A (*B,me,n), b (*B,me), C (*B,mi,n), d (*B,mi).
    """

    P: jax.Array
    q: jax.Array
    A: jax.Array
    b: jax.Array
    C: jax.Array
    d: jax.Array

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def n_eq(self) -> int:
        return self.A.shape[-2]

    @property
    def n_ineq(self) -> int:
        return self.C.shape[-2]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.q.shape[:-1]

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def is_dense(self) -> bool:
        return True

    # -- operator protocol (same contract as SparseProxQP) --

    def matvec_P(self, v: jax.Array) -> jax.Array:
        return jnp.einsum("...ij,...j->...i", self.P, v)

    def matvec_A(self, v: jax.Array) -> jax.Array:
        return jnp.einsum("...ij,...j->...i", self.A, v)

    def matvec_At(self, w: jax.Array) -> jax.Array:
        return jnp.einsum("...ji,...j->...i", self.A, w)

    def matvec_C(self, v: jax.Array) -> jax.Array:
        return jnp.einsum("...ij,...j->...i", self.C, v)

    def matvec_Ct(self, w: jax.Array) -> jax.Array:
        return jnp.einsum("...ji,...j->...i", self.C, w)

    def diag_P(self) -> jax.Array:
        return jnp.diagonal(self.P, axis1=-2, axis2=-1)

    def diag_AtA(self) -> jax.Array:
        return jnp.sum(self.A * self.A, axis=-2)

    def diag_CtC(self) -> jax.Array:
        return jnp.sum(self.C * self.C, axis=-2)

    def to_box_qp(self) -> QP:
        """Lower onto the canonical l <= [A;C] x <= u box form.

        Equalities become l=u=b (the reference generator does the same for its
        equality class, `GenerateQuadraticProgram.jl:22-26`); inequalities get
        l=-inf, u=d.
        """
        A = jnp.concatenate([self.A, self.C], axis=-2)
        l = jnp.concatenate(
            [self.b, jnp.full(self.d.shape, -jnp.inf, self.d.dtype)], axis=-1)
        u = jnp.concatenate([self.b, self.d], axis=-1)
        return QP(self.P, self.q, A, l, u)


def make_proxqp(P, q, A, b, C, d, dtype=None) -> ProxQPProblem:
    arrs = [_densify(x) for x in (P, q, A, b, C, d)]
    if dtype is not None:
        arrs = [np.asarray(x, dtype=dtype) for x in arrs]
    return ProxQPProblem(*(jnp.asarray(x) for x in arrs))
