"""KKT backend unit tests — kernels in isolation (the reference benchmarks its
backends standalone against a dense `\\` solve, LinearSystemSolversFunBenchmark.jl:100-107)."""

import jax.numpy as jnp
import numpy as np
import pytest

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.core.settings import KKTBackendKind
from quadraticprogramsolver_tpu.core.sparse_problem import make_sparse_qp
from quadraticprogramsolver_tpu.models import kkt
from quadraticprogramsolver_tpu.problems.generator import ProblemClass, generate_random_qp
from quadraticprogramsolver_tpu.utils.oracle import solve_qp_reference


def _random_qp(n=24, seed=0, batch=None, dtype=np.float64):
    data = generate_random_qp(ProblemClass.RANDOM_QP, n, seed=seed)
    qp = qps.make_qp(*data.dense(), dtype=dtype)
    if batch:
        import jax

        qp = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), qp)
    return data, qp


def _reference_kkt_solve(data, x, z, y, rho, sigma):
    """Dense f64 solve of [[P+sI, A'], [A, -I/rho]] v = [s*x-q; z-y/rho]."""
    P, q, A = data.P.toarray(), data.q, data.A.toarray()
    n, m = q.size, data.m
    K = np.block([[P + sigma * np.eye(n), A.T], [A, -np.eye(m) / rho]])
    rhs = np.concatenate([sigma * x - q, z - y / rho])
    v = np.linalg.solve(K, rhs)
    xx = v[:n]
    zz = z + (v[n:] - y) / rho
    return xx, zz


@pytest.mark.parametrize("kind", [KKTBackendKind.CHOLESKY, KKTBackendKind.KKT_LDL,
                                  KKTBackendKind.CG, KKTBackendKind.KKT_MINRES])
def test_backend_matches_dense_solve(kind):
    data, qp = _random_qp()
    st = qps.Settings(kkt_backend=kind, cg_eps=1e-12, cg_max_iterations=2000,
                      kkt_refinement_steps=1)
    backend = kkt.get_backend(kind, qp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(qp.n)
    z = rng.standard_normal(qp.m)
    y = rng.standard_normal(qp.m)
    rho = jnp.asarray(0.37, qp.dtype)[None][0] * jnp.ones(())
    rho_arr = jnp.full((), 0.37, qp.dtype)
    sigma = st.sigma
    cache = backend.init(qp, rho_arr, jnp.asarray(sigma, qp.dtype), st)
    xx, zz, _ = backend.solve(cache, qp, jnp.asarray(x), jnp.asarray(z),
                              jnp.asarray(y), rho_arr, st)
    xx_ref, zz_ref = _reference_kkt_solve(data, x, z, y, 0.37, sigma)
    assert np.abs(np.asarray(xx) - xx_ref).max() <= 1e-8
    assert np.abs(np.asarray(zz) - zz_ref).max() <= 1e-8


def test_ldl_factor_reconstructs():
    rng = np.random.default_rng(5)
    n, m = 12, 6
    Mx = rng.standard_normal((n, n))
    P = Mx @ Mx.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    rho = 0.5
    K = np.block([[P, A.T], [A, -np.eye(m) / rho]])
    L, d = kkt._ldl_factor(jnp.asarray(K))
    L, d = np.asarray(L), np.asarray(d)
    assert np.allclose(np.tril(L, -1) + np.eye(n + m), L)
    assert np.abs(L @ np.diag(d) @ L.T - K).max() <= 1e-9
    # Quasi-definite signature: n positive, m negative pivots.
    assert (d[:n] > 0).all() and (d[n:] < 0).all()


def test_ldl_backend_full_solve():
    data, _ = _random_qp(n=20, seed=3)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-9, eps_rel=1e-9, rho=0.1)
    assert ref.status == 3
    qp = qps.make_qp(*data.dense(), dtype=np.float64)
    st = qps.Settings(max_iterations=50_000, eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
                      adaptive_rho=True, kkt_backend=KKTBackendKind.KKT_LDL)
    sol = qps.solve_jit(qp, st)
    assert np.abs(np.asarray(sol.x) - ref.x).max() <= 1e-5


def test_sparse_qp_cg_path():
    import scipy.sparse as sp

    data = generate_random_qp(ProblemClass.RANDOM_QP, 200, seed=2)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-9, eps_rel=1e-9, rho=0.1)
    assert ref.status == 3
    sqp = make_sparse_qp(data.P, data.q, data.A, data.l, data.u, dtype=np.float64)
    st = qps.Settings(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
                      adaptive_rho=True, cg_eps=1e-10, cg_max_iterations=1000)
    # AUTO on sparse must resolve to CG.
    assert kkt.resolve_backend(KKTBackendKind.AUTO, sqp) is KKTBackendKind.CG
    sol = qps.solve_jit(sqp, st)
    assert int(sol.info.status) >= qps.Status.SOLVED_ADMM
    assert np.abs(np.asarray(sol.x) - ref.x).max() <= 1e-5


def test_sparse_operator_protocol_matches_dense():
    data = generate_random_qp(ProblemClass.ISOTONIC, 50, seed=1)
    sqp = make_sparse_qp(data.P, data.q, data.A, data.l, data.u, dtype=np.float64)
    dqp = qps.make_qp(*data.dense(), dtype=np.float64)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(sqp.n))
    w = jnp.asarray(rng.standard_normal(sqp.m))
    assert np.allclose(sqp.matvec_P(v), dqp.matvec_P(v), atol=1e-12)
    assert np.allclose(sqp.matvec_A(v), dqp.matvec_A(v), atol=1e-12)
    assert np.allclose(sqp.matvec_At(w), dqp.matvec_At(w), atol=1e-12)
    assert np.allclose(sqp.diag_P(), dqp.diag_P(), atol=1e-12)
    assert np.allclose(sqp.diag_AtA(), dqp.diag_AtA(), atol=1e-12)


def test_dense_backend_rejected_for_sparse():
    data = generate_random_qp(ProblemClass.RANDOM_QP, 20, seed=0)
    sqp = make_sparse_qp(data.P, data.q, data.A, data.l, data.u)
    with pytest.raises(ValueError, match="dense"):
        kkt.resolve_backend(KKTBackendKind.CHOLESKY, sqp)


def test_ldl_backend_batched():
    qp = qps.generate_batch(ProblemClass.RANDOM_QP, batch=4, num_elements=16,
                            seed=1, dtype=np.float64)
    st = qps.Settings(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
                      adaptive_rho=True, kkt_backend=KKTBackendKind.KKT_LDL)
    sol = qps.solve_jit(qp, st)
    ref = qps.solve_jit(qp, qps.Settings(max_iterations=20_000, eps_abs=1e-7,
                                         eps_rel=1e-7, rho=0.1, adaptive_rho=True))
    dev = np.abs(np.asarray(sol.x) - np.asarray(ref.x)).max()
    assert dev <= 1e-6, dev


def test_per_constraint_rho_equality_weighting():
    # rho_eq_scale (OSQP vector-rho / reference To-Do #1) must cut iterations
    # on equality-constrained problems and agree with the oracle solution.
    # seed 14: feasible instance (the generator's sparse A is often
    # rank-deficient at this size, making l=u infeasible).
    data = generate_random_qp(ProblemClass.EQUALITY_QP, 24, seed=14)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-10, eps_rel=1e-10, rho=0.1)
    assert ref.status == 3
    qp = qps.make_qp(*data.dense(), dtype=np.float64)
    base = qps.Settings(max_iterations=50_000, eps_abs=1e-8, eps_rel=1e-8,
                        rho=0.1, adaptive_rho=True)
    vec = qps.Settings(max_iterations=50_000, eps_abs=1e-8, eps_rel=1e-8,
                       rho=0.1, adaptive_rho=True, rho_eq_scale=1e3)
    s_base = qps.solve_jit(qp, base)
    s_vec = qps.solve_jit(qp, vec)
    assert np.abs(np.asarray(s_vec.x) - ref.x).max() <= 1e-6
    assert int(s_vec.info.iterations) <= int(s_base.info.iterations)


@pytest.mark.parametrize("kind", [KKTBackendKind.CHOLESKY, KKTBackendKind.KKT_LDL,
                                  KKTBackendKind.CG, KKTBackendKind.KKT_MINRES])
def test_per_constraint_rho_backends_agree(kind):
    # All backends must implement the weighted KKT system identically.
    data = generate_random_qp(ProblemClass.RANDOM_QP, 20, seed=4)
    qp = qps.make_qp(*data.dense(), dtype=np.float64)
    st = qps.Settings(max_iterations=30_000, eps_abs=1e-8, eps_rel=1e-8,
                      rho=0.1, adaptive_rho=True, rho_eq_scale=1e3,
                      kkt_backend=kind, cg_eps=1e-12, cg_max_iterations=2000)
    sol = qps.solve_jit(qp, st)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-10, eps_rel=1e-10, rho=0.1)
    assert ref.status == 3
    assert np.abs(np.asarray(sol.x) - ref.x).max() <= 1e-6, kind


def test_minres_backend_sparse_full_solve():
    # MINRES is the iterative backend that also accepts SparseQP (the CG
    # alternative on the quasi-definite KKT, LinearSystemSolversFun.jl:191-234).
    data = generate_random_qp(ProblemClass.RANDOM_QP, 100, seed=2)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-9, eps_rel=1e-9, rho=0.1)
    assert ref.status == 3
    sqp = make_sparse_qp(data.P, data.q, data.A, data.l, data.u, dtype=np.float64)
    st = qps.Settings(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
                      adaptive_rho=True, cg_eps=1e-10, cg_max_iterations=1000,
                      kkt_backend=KKTBackendKind.KKT_MINRES)
    sol = qps.solve_jit(sqp, st)
    assert int(sol.info.status) >= qps.Status.SOLVED_ADMM
    assert np.abs(np.asarray(sol.x) - ref.x).max() <= 1e-5


@pytest.mark.parametrize("rho_eq_scale", [1.0, 10.0])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("sigma_free", [False, True],
                         ids=["M_inv", "sigma_free"])
def test_cholesky_init_cache_contents(sigma_free, dtype, rho_eq_scale):
    """cholesky_init caches exactly {G = M^-1 A', g = M^-1 q} (sigma-free)
    or {M_inv} (otherwise), with M = P + sigma I + A' diag(rho w) A and the
    per-row weights w of rho_eq_scale, per lane."""
    data, qp = _random_qp(n=24, seed=3, batch=3, dtype=dtype)
    st = qps.Settings(sigma_free_rhs=sigma_free,
                      kkt_refinement_steps=0 if sigma_free else 1,
                      rho_eq_scale=rho_eq_scale)
    rho = np.array([0.1, 1.0, 10.0])
    sigma = st.sigma_for(dtype)
    cache = kkt.cholesky_init(qp, jnp.asarray(rho, dtype),
                              jnp.asarray(sigma, dtype), st)
    assert set(cache) == ({"G", "g"} if sigma_free else {"M_inv"})
    P, q, A = data.P.toarray(), data.q, data.A.toarray()
    l, u = data.l, data.u
    eq = (np.isfinite(l) & np.isfinite(u)
          & (np.abs(u - l) <= 1e-9 * np.maximum(1.0, np.abs(u))))
    w = np.where(eq, rho_eq_scale, 1.0)
    tol = 1e-3 if dtype == np.float32 else 1e-9
    for i, r in enumerate(rho):
        M_inv = np.linalg.inv(P + sigma * np.eye(data.n) + A.T @ (r * w[:, None] * A))
        if sigma_free:
            want = {"G": M_inv @ A.T, "g": M_inv @ q}
        else:
            want = {"M_inv": M_inv}
        for key, ref in want.items():
            got = np.asarray(cache[key][i], np.float64)
            assert got.shape == ref.shape, key
            rel = np.abs(got - ref).max() / np.abs(ref).max()
            assert rel <= tol, (key, i, rel)
