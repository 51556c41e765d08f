"""Execution-plan introspection (models/plan.py).

Plans are static, so most of these tests run against shape-only problems;
the property grid checks that the plan names the cache the solver actually
builds, and that every (shape, settings) pair solves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import kkt as kkt_mod
from quadraticprogramsolver_tpu.models import plan as plan_mod


def shape_qp(B, n, m, dtype=jnp.float32):
    """Shape-only QP: plan() reads shapes/dtypes, never values."""
    s = jax.ShapeDtypeStruct
    return qps.QP(P=s((B, n, n), dtype), q=s((B, n), dtype),
                  A=s((B, m, n), dtype), l=s((B, m), dtype),
                  u=s((B, m), dtype))


def shape_prox(B, n, me, mi, dtype=jnp.float32):
    s = jax.ShapeDtypeStruct
    return qps.ProxQPProblem(
        P=s((B, n, n), dtype), q=s((B, n), dtype), A=s((B, me, n), dtype),
        b=s((B, me), dtype), C=s((B, mi, n), dtype), d=s((B, mi), dtype))


def _smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestPlanAdmm:
    def test_default_settings_plan_xla(self):
        p = plan_mod.plan(shape_qp(8, 100, 50), qps.Settings())
        assert p.backend == "cholesky" and p.factor == "inverse"
        assert p.cache == "M_inv"

    def test_sparse_cg_plan(self):
        import scipy.sparse as sp

        from quadraticprogramsolver_tpu.core.sparse_problem import make_sparse_qp

        n = 32
        P = sp.identity(n).tocsr()
        A = sp.identity(n).tocsr()
        sqp = make_sparse_qp(P, np.ones(n), A, -np.ones(n), np.ones(n),
                             dtype=np.float32)
        p = plan_mod.plan(sqp, qps.Settings())
        assert p.backend == "cg" and p.factor == "jacobi_diag"

    def test_headline_stack_plans_cholesky_solve(self):
        """The tuned stack of chip_smoke.py phase 1 and bench.py factors
        by the Cholesky multi-RHS solve into the {G, g} cache."""
        p = plan_mod.plan(shape_qp(4096, 512, 256),
                          _smoke().headline_settings())
        assert (p.backend, p.factor, p.cache) == (
            "cholesky", "cholesky_solve", "G_g")


class TestPlanProx:
    def test_dense_m_inv_plan(self):
        p = plan_mod.plan_proxqp(shape_prox(4, 30, 4, 8),
                                 qps.ProxQPSettings())
        assert p.factor == "inverse" and p.cache == "M_inv"

    def test_headline_stack_plans_cholesky_solve(self):
        p = plan_mod.plan_proxqp(shape_prox(4096, 512, 128, 128),
                                 _smoke().prox_headline_settings())
        assert (p.backend, p.factor, p.cache) == (
            "prox_alm", "cholesky_solve", "Ga_Gc_g")


GRID_SHAPES = [(1, 128, 128), (4, 128, 128), (3, 100, 60), (2, 16, 8),
               (6, 128, 128), (2, 30, 0)]
_BASE = dict(max_iterations=300, eps_abs=1e-4, eps_rel=1e-4, rho=0.1)
GRID_STACKS = {
    "default": qps.Settings(**_BASE),
    "sigma_free_headline": dataclasses.replace(
        _smoke().headline_settings(), **_BASE),
    "kkt_ldl": qps.Settings(**_BASE, kkt_backend=qps.KKTBackendKind.KKT_LDL),
}
#: Cache leaves each planned layout holds.
CACHE_KEYS = {"G_g": {"G", "g"}, "M_inv": {"M_inv"}, "L_d": {"L", "d"}}


class TestPlanPropertyGrid:
    """Plan/solve consistency across a shape x settings grid."""

    @pytest.mark.parametrize(
        "shape,stack",
        [(shape, stack) for shape in GRID_SHAPES for stack in GRID_STACKS
         # An empty KKT block has no LDL factor; CHOLESKY covers m=0.
         if not (stack == "kkt_ldl" and shape[2] == 0)])
    def test_grid(self, shape, stack):
        """Plan/solve consistency: plan() never raises, names the cache the
        backend builds, and the solve ends with valid statuses and finite x."""
        B, n, m = shape
        st = GRID_STACKS[stack]
        rng = np.random.default_rng(0)
        M = rng.standard_normal((B, n, n)).astype(np.float32)
        P = (np.einsum("bki,bkj->bij", M, M) / n
             + 0.1 * np.eye(n, dtype=np.float32))
        A = rng.standard_normal((B, m, n)).astype(np.float32)
        l = -(rng.random((B, m)).astype(np.float32) + 0.5)
        u = rng.random((B, m)).astype(np.float32) + 0.5
        qp = qps.QP(P=jnp.asarray(P),
                    q=jnp.asarray(rng.standard_normal((B, n)).astype(np.float32)),
                    A=jnp.asarray(A), l=jnp.asarray(l), u=jnp.asarray(u))
        p = plan_mod.plan(qp, st)
        backend = kkt_mod.get_backend(st.kkt_backend, qp)
        rho = jnp.full((B,), st.rho, jnp.float32)
        sigma = jnp.asarray(st.sigma_for(jnp.float32), jnp.float32)
        assert set(backend.init(qp, rho, sigma, st)) == CACHE_KEYS[p.cache]
        sol = qps.solve_jit(qp, st)
        status = np.asarray(sol.info.status)
        assert ((status >= 1) & (status <= 5)).all(), (shape, stack)
        assert np.isfinite(np.asarray(sol.x)).all(), (shape, stack)
