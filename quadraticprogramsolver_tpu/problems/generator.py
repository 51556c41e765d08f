"""Random QP generator — the reference's 9 OSQP-paper benchmark families.

Behavioral re-implementation of `/root/reference/GenerateQuadraticProgram.jl:6-115`
(enum at :6, families at :10-109). Distributions, default dimensions, density
factors, and the +/-inf one-sided bounds are preserved so fixtures and
benchmarks exercise the same problem statistics; bit-level RNG parity with
Julia is neither possible nor needed.

Quirk preserved for parity (documented, per SURVEY.md §7): in the generic
branch the reference sets masked *upper* bounds via ``vU[vI] .= vI[vI]``
(GenerateQuadraticProgram.jl:35), i.e. to 1.0 (a BitVector indexed by itself),
almost certainly intending ``vL[vI]``. We reproduce the 1.0 behavior.

The 9 families are generated host-side (numpy + scipy.sparse): problem
generation is test fixture/benchmark machinery, not solver compute. Use
:func:`generate_batch` to stack instances into a device-ready batched
:class:`~...core.problem.QP`, or :func:`device_random_qp_fleet` to draw a
large random-QP fleet directly on the device.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import scipy.sparse as sp


class ProblemClass(enum.Enum):
    """Mirrors `@enum ProblemClass` (GenerateQuadraticProgram.jl:6)."""

    RANDOM_QP = "random_qp"
    INEQUALITY_QP = "inequality_qp"
    EQUALITY_QP = "equality_qp"
    OPTIMAL_CONTROL = "optimal_control"
    PORTFOLIO = "portfolio"
    LASSO = "lasso"
    HUBER = "huber"
    SVM = "svm"
    ISOTONIC = "isotonic"


ALL_CLASSES = tuple(ProblemClass)


@dataclasses.dataclass
class QPData:
    """Host-side generated problem (sparse matrices + dense vectors)."""

    P: sp.csc_matrix
    q: np.ndarray
    A: sp.csc_matrix
    l: np.ndarray
    u: np.ndarray

    @property
    def n(self) -> int:
        return self.P.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[0]

    def dense(self, dtype=np.float64):
        return (
            np.asarray(self.P.toarray(), dtype),
            np.asarray(self.q, dtype),
            np.asarray(self.A.toarray(), dtype),
            np.asarray(self.l, dtype),
            np.asarray(self.u, dtype),
        )


def _sprandn(rng: np.random.Generator, rows: int, cols: int, density: float) -> sp.csc_matrix:
    """scipy analogue of Julia's ``sprandn`` (normal nonzeros)."""
    return sp.random(
        rows, cols, density=density, format="csc",
        random_state=np.random.default_rng(rng.integers(2**63)),
        data_rvs=lambda size: rng.standard_normal(size),
    )


def _speye(k: int, scale: float = 1.0) -> sp.csc_matrix:
    return sp.identity(k, format="csc") * scale


def generate_random_qp(
    problem_class: ProblemClass,
    num_elements: int = 1000,
    num_constraints: int = 0,
    seed: int | np.random.Generator = 0,
) -> QPData:
    """Generate one instance of the given family.

    ``num_constraints=0`` selects the OSQP-paper default ratio for the family,
    exactly as the reference (GenerateQuadraticProgram.jl:18,23,28,40,51,65,80).
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    n = num_elements
    mc = num_constraints

    generic = (
        ProblemClass.RANDOM_QP,
        ProblemClass.INEQUALITY_QP,
        ProblemClass.EQUALITY_QP,
        ProblemClass.OPTIMAL_CONTROL,
    )
    if problem_class in generic:
        # GenerateQuadraticProgram.jl:10-36
        density, alpha = 0.15, 1e-2
        M = _sprandn(rng, n, n, density)
        P = (M.T @ M + _speye(n, alpha)).tocsc()
        q = rng.standard_normal(n)
        if problem_class is ProblemClass.INEQUALITY_QP:
            m = mc or 10 * n
            A = _sprandn(rng, m, n, density)
            l = -rng.random(m)
            u = rng.random(m)
        elif problem_class is ProblemClass.EQUALITY_QP:
            m = mc or n // 2
            A = _sprandn(rng, m, n, density)
            l = rng.standard_normal(m)
            u = l.copy()
        else:  # RANDOM_QP and OPTIMAL_CONTROL share the masked-bounds branch (:27-36)
            m = mc or n // 2
            A = _sprandn(rng, m, n, density)
            l = -rng.random(m)
            u = rng.random(m)
            mask = rng.random(m) <= 0.15
            l[mask] = u[mask]
            mask = rng.random(m) <= 0.15
            u[mask] = 1.0  # reference quirk `vU[vI] .= vI[vI]` (:35), kept for parity
        return QPData(P, q, A.tocsc(), l, u)

    if problem_class is ProblemClass.PORTFOLIO:
        # GenerateQuadraticProgram.jl:37-47. Vars = [assets(n); factors(k)].
        density = 0.5
        k = mc or max(5, n // 100)
        D = sp.diags(rng.random(n) * np.sqrt(k), format="csc")
        P = sp.block_diag([D, _speye(k)], format="csc")
        q = np.concatenate([rng.standard_normal(n), np.zeros(k)])
        F = _sprandn(rng, n, k, density)
        A = sp.vstack(
            [
                sp.hstack([F.T, -_speye(k)]),
                sp.hstack([sp.csc_matrix(np.ones((1, n))), sp.csc_matrix((1, k))]),
                sp.hstack([_speye(n), sp.csc_matrix((n, k))]),
            ],
            format="csc",
        )
        l = np.concatenate([np.zeros(k), [1.0], np.zeros(n)])
        u = np.concatenate([np.zeros(k), [1.0], np.ones(n)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.LASSO:
        # GenerateQuadraticProgram.jl:48-61. Vars = [x(n); y(m); t(n)].
        density = 0.15
        m = mc or n * 100
        Ad = _sprandn(rng, m, n, density)
        x_true = (rng.standard_normal(n) / np.sqrt(n)) * (rng.random(n) > 0.5)
        b = Ad @ x_true + rng.standard_normal(m)
        lam = np.abs(Ad.T @ b).max() / 5.0
        P = sp.block_diag(
            [sp.csc_matrix((n, n)), _speye(m, 2.0), sp.csc_matrix((n, n))], format="csc")
        q = np.concatenate([np.zeros(n + m), lam * np.ones(n)])
        A = sp.vstack(
            [
                sp.hstack([Ad, -_speye(m), sp.csc_matrix((m, n))]),
                sp.hstack([_speye(n), sp.csc_matrix((n, m)), -_speye(n)]),
                sp.hstack([_speye(n), sp.csc_matrix((n, m)), _speye(n)]),
            ],
            format="csc",
        )
        l = np.concatenate([b, np.full(n, -np.inf), np.zeros(n)])
        u = np.concatenate([b, np.zeros(n), np.full(n, np.inf)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.HUBER:
        # GenerateQuadraticProgram.jl:62-76. Vars = [x(n); u(m); r(m); s(m)].
        density = 0.15
        m = mc or n * 100
        Ad = _sprandn(rng, m, n, density)
        x_true = rng.standard_normal(n) / np.sqrt(n)
        inlier = rng.random(m) < 0.95
        b = Ad @ x_true + 0.5 * inlier * rng.standard_normal(m) + 10.0 * (~inlier) * rng.random(m)
        P = sp.block_diag(
            [sp.csc_matrix((n, n)), _speye(m, 2.0), sp.csc_matrix((2 * m, 2 * m))],
            format="csc",
        )
        q = np.concatenate([np.zeros(n + m), 2.0 * np.ones(2 * m)])
        I_m = _speye(m)
        Z_mn = sp.csc_matrix((m, n + m))
        A = sp.vstack(
            [
                sp.hstack([Ad, -I_m, -I_m, I_m]),
                sp.hstack([Z_mn, I_m, sp.csc_matrix((m, m))]),
                sp.hstack([Z_mn, sp.csc_matrix((m, m)), I_m]),
            ],
            format="csc",
        )
        l = np.concatenate([b, np.zeros(2 * m)])
        u = np.concatenate([b, np.full(2 * m, np.inf)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.SVM:
        # GenerateQuadraticProgram.jl:77-92. Vars = [w(n); t(m)].
        density = 0.15
        m = mc or n * 100
        half = m // 2
        m = 2 * half
        lam = 1.0
        b = np.concatenate([np.ones(half), -np.ones(half)])
        Au = _sprandn(rng, half, n, density)
        Al = _sprandn(rng, half, n, density)
        upper = Au / np.sqrt(m) + (Au != 0).multiply(1.0 / m)
        lower = Al / np.sqrt(m) - (Al != 0).multiply(1.0 / m)
        Ad = sp.vstack([upper, lower], format="csc")
        P = sp.block_diag([_speye(n, 2.0), sp.csc_matrix((m, m))], format="csc")
        q = lam * np.concatenate([np.zeros(n), np.ones(m)])
        A = sp.vstack(
            [
                sp.hstack([sp.diags(b) @ Ad, -_speye(m)]),
                sp.hstack([sp.csc_matrix((m, n)), _speye(m)]),
            ],
            format="csc",
        )
        l = np.concatenate([np.full(m, -np.inf), np.zeros(m)])
        u = np.concatenate([-np.ones(m), np.full(m, np.inf)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.ISOTONIC:
        # GenerateQuadraticProgram.jl:93-109.
        density, alpha = 0.25, 1e-2
        M = _sprandn(rng, n, n, density)
        P = (M.T @ M + _speye(n, alpha)).tocsc()
        q = rng.standard_normal(n)
        ones = np.ones(n - 1)
        if rng.random() >= 0.5:  # monotone non-increasing
            A = sp.diags([ones, -ones], offsets=[0, 1], shape=(n - 1, n), format="csc")
        else:  # monotone non-decreasing
            A = sp.diags([-ones, ones], offsets=[0, 1], shape=(n - 1, n), format="csc")
        l = np.zeros(n - 1)
        u = 10.0 * np.ones(n - 1)
        return QPData(P, q, A, l, u)

    raise ValueError(f"unknown problem class {problem_class}")


def generate_large_sparse_qp(
    num_elements: int,
    num_constraints: int = 0,
    nnz_per_row: int = 3,
    seed: int = 0,
) -> QPData:
    """Large sparse feasible QP for the matrix-free PCG path (the n=1e5
    regime of BASELINE.md config 4; the reference routes this regime to PCG,
    SolveQuadraticProgram.m:190-204).

    P = I + B'B with B ~ sparse normal (nnz_per_row/n density, 1/sqrt(k)
    scaled) — SPD, well-conditioned, ~k^2 nnz per row. A ~ sparse normal
    rows; bounds bracket A @ x0 for a random x0, so the instance is feasible
    by construction (unlike the random families, which can emit infeasible
    instances at these sizes).
    """
    rng = np.random.default_rng(seed)
    n = num_elements
    m = num_constraints or n // 2
    k = nnz_per_row
    B = _sprandn(rng, n, n, k / n) / np.sqrt(k)
    P = (sp.identity(n) + B.T @ B).tocsc()
    q = rng.standard_normal(n)
    A = _sprandn(rng, m, n, k / n).tocsc()
    x0 = rng.standard_normal(n)
    Ax0 = A @ x0
    l = Ax0 - rng.random(m)
    u = Ax0 + rng.random(m)
    return QPData(P, q, A, l, u)


def generate_batch(
    problem_class: ProblemClass,
    batch: int,
    num_elements: int,
    num_constraints: int = 0,
    seed: int = 0,
    dtype=np.float32,
):
    """Generate ``batch`` same-shape instances and stack them into a batched QP.

    Returns a device :class:`QP` of shape (batch, ...). This is the fleet axis
    the solver shards/batches over — the reference has no analogue (it
    solves one instance per call).
    """
    from ..core.problem import make_qp

    rng = np.random.default_rng(seed)
    datas = [
        generate_random_qp(problem_class, num_elements, num_constraints, rng)
        for _ in range(batch)
    ]
    shapes = {(d.n, d.m) for d in datas}
    if len(shapes) != 1:
        raise ValueError(f"instances have inconsistent shapes: {shapes}")
    dense = [d.dense(dtype) for d in datas]
    P, q, A, l, u = (np.stack([inst[i] for inst in dense]) for i in range(5))
    return make_qp(P, q, A, l, u, dtype=dtype)


def device_random_qp_fleet(batch: int, n: int, m: int, seed: int):
    """On-device batched random_qp family (GenerateQuadraticProgram.jl:10-36).

    P = M'M + 1e-2 I with M ~ sparse(0.15) normal, q ~ N(0,1), A ~
    sparse(0.15) normal, l = -U(0,1), u = U(0,1), then 15% of rows get l=u
    (equality) and 15% get u=1.0 (the reference's vI[vI] quirk, see the
    module docstring). Same distribution as :func:`generate_random_qp`'s
    RANDOM_QP class with m rows, drawn with ``jax.random`` in float32 on the
    default device: host generation and transfer of thousands of dense
    n x n instances would dominate a benchmark's set-up time.
    """
    import jax
    import jax.numpy as jnp

    from ..core.problem import QP

    density, alpha = 0.15, 1e-2

    def masked_normal(k, r, c):
        mask = jax.random.uniform(jax.random.fold_in(k, 1),
                                  (batch, r, c)) < density
        return jax.random.normal(k, (batch, r, c), jnp.float32) * mask

    @jax.jit
    def make_P(k):
        Mm = masked_normal(k, n, n)
        return (jnp.einsum("bki,bkj->bij", Mm, Mm, precision="highest")
                + alpha * jnp.eye(n, dtype=jnp.float32))

    @jax.jit
    def make_rest(k):
        A = masked_normal(jax.random.fold_in(k, 2), m, n)
        k = jax.random.fold_in(k, 3)
        q = jax.random.normal(k, (batch, n), jnp.float32)
        # Explicit f32: under enable_x64 uniform() defaults to f64.
        l = -jax.random.uniform(jax.random.fold_in(k, 1), (batch, m),
                                jnp.float32)
        u = jax.random.uniform(jax.random.fold_in(k, 2), (batch, m),
                               jnp.float32)
        eq = jax.random.uniform(jax.random.fold_in(k, 3), (batch, m)) <= 0.15
        u1 = jax.random.uniform(jax.random.fold_in(k, 4), (batch, m)) <= 0.15
        l = jnp.where(eq, u, l)
        u = jnp.where(u1, 1.0, u)
        return q, A, l, u

    key = jax.random.PRNGKey(seed)
    P = make_P(key)
    q, A, l, u = make_rest(key)
    return QP(P=P, q=q, A=A, l=l, u=u)


def device_split_qp_fleet(batch: int, n: int, me: int, mi: int, seed: int):
    """On-device fleet of random split-form QPs (the prox-ALM family's shape,
    after the reference's ProxQP001.jl demo, :65-100): P = M'M/n + I with
    M ~ N(0,1), q ~ N(0,1), A (me x n) and C (mi x n) ~ N(0,1), and
    b = A x_f, d = C x_f + 1 for a random x_f, so every instance is
    feasible with a strictly interior inequality slack. float32, drawn on
    the default device.
    """
    import jax
    import jax.numpy as jnp

    from ..core.problem import ProxQPProblem

    @jax.jit
    def make(key):
        M = jax.random.normal(key, (batch, n, n), jnp.float32)
        P = (jnp.einsum("bki,bkj->bij", M, M, precision="highest") / n
             + jnp.eye(n, dtype=jnp.float32))
        A = jax.random.normal(jax.random.fold_in(key, 1), (batch, me, n),
                              jnp.float32)
        C = jax.random.normal(jax.random.fold_in(key, 2), (batch, mi, n),
                              jnp.float32)
        k = jax.random.fold_in(key, 3)
        xf = jax.random.normal(k, (batch, n), jnp.float32)
        q = jax.random.normal(jax.random.fold_in(k, 1), (batch, n),
                              jnp.float32)
        b = jnp.einsum("bij,bj->bi", A, xf, precision="highest")
        d = jnp.einsum("bij,bj->bi", C, xf, precision="highest") + 1.0
        return ProxQPProblem(P=P, q=q, A=A, b=b, C=C, d=d)

    return make(jax.random.PRNGKey(seed))
