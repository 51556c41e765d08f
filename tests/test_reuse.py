"""Factor-reuse API: prepare()/PreparedFactor, CachedQPSolver, and the
static-matrix sequence path.

The reuse contract (P/A fixed, q/l/u free, solve at the prepared rho)
mirrors the reference ProxQP's construct-once/solve-many split
(`/root/reference/ProxQP.jl:73-115` vs `:118-173`) and OSQP's
setup/update/solve. Correctness bar: a prepared solve must match the plain
solve — bitwise on the M^{-1} path (identical factor computation), to
solution tolerance on the sigma-free path (different but equivalent factor
algebra).
"""

import dataclasses

import numpy as np
import pytest

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.frontends.sequence import solve_sequence_jit
from quadraticprogramsolver_tpu.models import admm

SET = qps.Settings(max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                   adaptive_rho=False)


def fleet(batch=4, n=40, m=20, seed=0, dtype=np.float64):
    return qps.generate_batch(qps.ProblemClass.RANDOM_QP, batch=batch,
                              num_elements=n, num_constraints=m, seed=seed,
                              dtype=dtype)


class TestPreparedFactor:
    def test_matches_plain_solve_bitwise_minv_path(self):
        qp = fleet()
        plain = qps.solve_jit(qp, SET)
        prep = admm.prepare_jit(qp, SET)
        reused = qps.solve_jit(qp, SET, None, None, None, None, None, prep)
        # The caches are bitwise identical (asserted below); the trajectories
        # agree to program-reordering rounding (XLA fuses the two programs
        # differently — measured 4e-14 on f64).
        assert np.abs(np.asarray(plain.x) - np.asarray(reused.x)).max() < 1e-10
        assert np.array_equal(np.asarray(plain.info.iterations),
                              np.asarray(reused.info.iterations))
        assert np.array_equal(np.asarray(plain.info.status),
                              np.asarray(reused.info.status))
        import jax
        import jax.numpy as jnp

        from quadraticprogramsolver_tpu.models import kkt

        with jax.default_matmul_precision(SET.matmul_precision):
            backend = kkt.get_backend(SET.kkt_backend, qp)
            rho = jnp.full(qp.batch_shape, SET.rho, qp.dtype)
            sig = jnp.asarray(SET.sigma_for(qp.dtype), qp.dtype)
            plain_cache = backend.init(qp, rho, sig, SET)
        assert np.array_equal(np.asarray(plain_cache["M_inv"]),
                              np.asarray(prep.cache["M_inv"]))

    def test_adaptive_rho_refactors_in_loop(self):
        # rho0 far from optimal so adaptation must trip: the prepared solve
        # still converges to the same solution as the plain adaptive solve.
        st = dataclasses.replace(SET, adaptive_rho=True, rho=1e2)
        qp = fleet(seed=3)
        plain = qps.solve_jit(qp, st)
        prep = admm.prepare_jit(qp, st)
        reused = qps.solve_jit(qp, st, None, None, None, None, None, prep)
        assert np.array_equal(np.asarray(plain.x), np.asarray(reused.x))

    def test_sigma_free_prepared_matches_solution(self):
        st = dataclasses.replace(SET, sigma_free_rhs=True,
                                 kkt_refinement_steps=0)
        qp = fleet(dtype=np.float64)
        plain = qps.solve_jit(qp, st)
        prep = admm.prepare_jit(qp, st)
        reused = qps.solve_jit(qp, st, None, None, None, None, None, prep)
        # This family/seed leaves one lane unconverged at static rho=0.1
        # in both variants — statuses must agree lane-by-lane.
        status_p = np.asarray(plain.info.status)
        assert np.array_equal(status_p, np.asarray(reused.info.status))
        solved = status_p >= 2
        assert solved.sum() >= 3
        # Different factor algebra (gj sweep vs explicit inverse): compare
        # solutions on the solved lanes, not iterates.
        dev = np.abs(np.asarray(plain.x) - np.asarray(reused.x))[solved]
        assert dev.max() < 1e-6

    def test_sigma_free_g_refreshed_for_new_q(self):
        # The q-dependent g must be recomputed per solve: solving a problem
        # with a DIFFERENT q through the same prepared factor must match a
        # fresh solve of that problem.
        st = dataclasses.replace(SET, sigma_free_rhs=True,
                                 kkt_refinement_steps=0)
        qp = fleet()
        prep = admm.prepare_jit(qp, st)
        qp2 = dataclasses.replace(qp, q=2.5 * qp.q + 0.1)
        fresh = qps.solve_jit(qp2, st)
        reused = qps.solve_jit(qp2, st, None, None, None, None, None, prep)
        assert np.abs(np.asarray(fresh.x) - np.asarray(reused.x)).max() < 1e-6

    def test_prepared_sparse_cg(self):
        import scipy.sparse as sp

        from quadraticprogramsolver_tpu.core.sparse_problem import make_sparse_qp

        rng = np.random.default_rng(0)
        n = 64
        G = sp.random(n, n, density=0.1, random_state=rng,
                      data_rvs=rng.standard_normal, format="csr")
        P = (G.T @ G + 0.1 * sp.identity(n)).tocsr()
        A = sp.identity(n).tocsr()
        sqp = make_sparse_qp(P, rng.standard_normal(n), A, -np.ones(n),
                             np.ones(n), dtype=np.float64)
        plain = qps.solve_jit(sqp, SET)
        prep = admm.prepare_jit(sqp, SET)
        reused = qps.solve_jit(sqp, SET, None, None, None, None, None, prep)
        assert np.abs(np.asarray(plain.x) - np.asarray(reused.x)).max() < 1e-10

    def test_prepare_rejects_slab_and_scaling(self):
        qp = fleet(dtype=np.float32)
        with pytest.raises(ValueError, match="scaling"):
            admm.prepare(qp, dataclasses.replace(SET, scaling_iters=2))
        with pytest.raises(ValueError, match="scaling|equilibration"):
            qps.solve(qp, dataclasses.replace(SET, scaling_iters=2),
                      prepared=admm.prepare(qp, SET))


class TestPreparedProxFactor:
    def _prob(self, seed=0, dtype=np.float64):
        rng = np.random.default_rng(seed)
        n, me, mi = 24, 6, 10
        M = rng.standard_normal((n, n))
        P = M @ M.T + 0.5 * np.eye(n)
        A = rng.standard_normal((me, n))
        C = rng.standard_normal((mi, n))
        xf = rng.standard_normal(n)
        return qps.make_proxqp(P, rng.standard_normal(n), A, A @ xf, C,
                               C @ xf + rng.random(mi), dtype=dtype)

    ST = qps.ProxQPSettings(max_iterations=2000, eps_abs=1e-9, eps_rel=1e-9)

    def test_dense_matches_plain(self):
        from quadraticprogramsolver_tpu.models import proxqp

        prob = self._prob()
        plain = qps.solve_proxqp_jit(prob, self.ST)
        prep = proxqp.prepare_jit(prob, self.ST)
        reused = qps.solve_proxqp_jit(prob, self.ST, None, None, prep)
        assert bool(plain.info.converged) and bool(reused.info.converged)
        assert int(plain.info.iterations) == int(reused.info.iterations)
        assert np.abs(np.asarray(plain.x) - np.asarray(reused.x)).max() < 1e-9

    def test_sigma_free_new_q(self):
        from quadraticprogramsolver_tpu.models import proxqp

        st = dataclasses.replace(self.ST, sigma_free_rhs=True,
                                 kkt_refinement_steps=0, eps_abs=1e-8,
                                 eps_rel=1e-8)
        prob = self._prob(seed=2)
        prep = proxqp.prepare_jit(prob, st)
        prob2 = dataclasses.replace(prob, q=1.7 * prob.q - 0.2)
        fresh = qps.solve_proxqp_jit(prob2, st)
        reused = qps.solve_proxqp_jit(prob2, st, None, None, prep)
        assert bool(reused.info.converged)
        assert np.abs(np.asarray(fresh.x) - np.asarray(reused.x)).max() < 1e-6

    def test_matrix_free_diag(self):
        import scipy.sparse as sp

        from quadraticprogramsolver_tpu.models import proxqp

        rng = np.random.default_rng(5)
        n = 32
        P = sp.identity(n) * 2.0
        A = sp.random(2, n, density=0.5, random_state=rng,
                      data_rvs=rng.standard_normal)
        C = sp.identity(n)
        xf = rng.standard_normal(n)
        prob = qps.make_sparse_proxqp(P, rng.standard_normal(n), A,
                                      np.asarray(A @ xf).ravel(), C,
                                      xf + 0.5, dtype=np.float64)
        st = dataclasses.replace(self.ST, eps_abs=1e-8, eps_rel=1e-8)
        plain = qps.solve_proxqp_jit(prob, st)
        prep = proxqp.prepare_jit(prob, st)
        reused = qps.solve_proxqp_jit(prob, st, None, None, prep)
        assert np.abs(np.asarray(plain.x) - np.asarray(reused.x)).max() < 1e-8


class TestCachedQPSolver:
    def test_update_vectors_matches_fresh_solve(self):
        qp = fleet()
        solver = qps.CachedQPSolver(qp, SET)
        first = solver.solve()
        assert (np.asarray(first.info.status) >= 2).all()
        q2 = np.asarray(qp.q) * 0.5 + 0.2
        l2 = np.asarray(qp.l) - 0.3
        solver.update(q=q2, l=l2)
        reused = solver.solve()
        fresh = qps.solve_jit(dataclasses.replace(
            qp, q=qps.QP(qp.P, qp.q, qp.A, qp.l, qp.u).q * 0 + q2,
            l=qp.l * 0 + l2), SET)
        assert np.array_equal(np.asarray(fresh.x), np.asarray(reused.x))

    def test_warm_start_reuses_last_solution(self):
        qp = fleet(seed=7)
        solver = qps.CachedQPSolver(qp, SET)
        cold = solver.solve()
        warm = solver.solve(warm_start=True)
        # Warm start from the solution: re-verification converges at (or
        # near) the first check.
        assert (np.asarray(warm.info.iterations)
                <= np.asarray(cold.info.iterations)).all()
        assert np.abs(np.asarray(warm.x) - np.asarray(cold.x)).max() < 1e-5

    def test_update_rejects_shape_change(self):
        solver = qps.CachedQPSolver(fleet(), SET)
        with pytest.raises(ValueError, match="shape"):
            solver.update(q=np.zeros((4, 13)))

    def test_refactor_updates_matrices(self):
        # OSQP's update_P/update_A: new matrices re-factor; results match a
        # freshly-constructed solver on the new problem.
        qp = fleet(seed=11)
        solver = qps.CachedQPSolver(qp, SET)
        solver.solve()
        P2 = np.asarray(qp.P) + 0.05 * np.eye(qp.n)
        A2 = np.asarray(qp.A) * 1.1
        solver.refactor(P=P2, A=A2)
        got = solver.solve(warm_start=True)
        fresh = qps.CachedQPSolver(
            dataclasses.replace(qp, P=qp.P * 0 + P2, A=qp.A * 0 + A2),
            SET).solve()
        assert np.array_equal(np.asarray(got.info.status),
                              np.asarray(fresh.info.status))
        # Warm-started vs cold trajectories land within solve tolerance
        # (eps 1e-6 -> ~1e-5 solution agreement), not bitwise.
        dev = np.abs(np.asarray(got.x) - np.asarray(fresh.x)).max()
        assert dev < 1e-4, dev
        with pytest.raises(ValueError, match="shape"):
            solver.refactor(P=np.eye(3))


class TestMixedSizeFleet:
    def test_stack_qps_pad_solves_each_instance(self):
        # Heterogeneous sizes share one executable via stack_qps(pad=True);
        # each lane's sliced solution matches its standalone solve.
        sizes = [(24, 12), (40, 20), (16, 30)]
        singles = []
        for i, (n, m) in enumerate(sizes):
            singles.append(qps.generate_batch(
                qps.ProblemClass.RANDOM_QP, batch=1, num_elements=n,
                num_constraints=m, seed=20 + i, dtype=np.float64))
        import jax

        solos = [jax.tree.map(lambda x: x[0], s) for s in singles]
        mixed = qps.stack_qps(solos, pad=True)
        assert mixed.n == 40 and mixed.m == 30
        sol = qps.solve_jit(mixed, SET)
        for i, (n, m) in enumerate(sizes):
            ref = qps.solve_jit(solos[i], SET)
            dev = np.abs(np.asarray(sol.x[i, :n]) - np.asarray(ref.x)).max()
            assert dev < 1e-8, (i, dev)
            # Padded variables are inert at 0.
            if n < mixed.n:
                assert np.abs(np.asarray(sol.x[i, n:])).max() < 1e-10


class TestSequenceVectors:
    def test_matches_full_sequence_and_reuse_modes_agree(self):
        import jax.numpy as jnp

        from quadraticprogramsolver_tpu.frontends.sequence import (
            solve_sequence_jit, solve_sequence_vectors_jit)

        T, B, n, m = 4, 3, 24, 12
        qp0 = fleet(batch=B, n=n, m=m, seed=9)
        drift = jnp.linspace(0.0, 1.0, T)[:, None, None]
        q_seq = qp0.q * (1.0 + 0.25 * drift)
        # reuse on/off must agree exactly (same rho, same factor values).
        a = solve_sequence_vectors_jit(qp0, q_seq, None, None, SET, None, True)
        b = solve_sequence_vectors_jit(qp0, q_seq, None, None, SET, None,
                                       False)
        assert np.abs(np.asarray(a.x) - np.asarray(b.x)).max() < 1e-9
        assert np.array_equal(np.asarray(a.info.iterations),
                              np.asarray(b.info.iterations))
        # And match the tiled-matrix sequence front-end.
        qp_seq = qps.QP(
            P=jnp.broadcast_to(qp0.P, (T, B, n, n)), q=q_seq,
            A=jnp.broadcast_to(qp0.A, (T, B, m, n)),
            l=jnp.broadcast_to(qp0.l, (T, B, m)),
            u=jnp.broadcast_to(qp0.u, (T, B, m)))
        c = solve_sequence_jit(qp_seq, SET, None, False, False)
        assert np.abs(np.asarray(a.x) - np.asarray(c.x)).max() < 1e-9

    def test_bounds_sequences(self):
        import jax.numpy as jnp

        from quadraticprogramsolver_tpu.frontends.sequence import (
            solve_sequence_vectors_jit)

        T, B, n, m = 3, 2, 16, 8
        qp0 = fleet(batch=B, n=n, m=m, seed=4)
        q_seq = jnp.broadcast_to(qp0.q, (T, B, n))
        widen = jnp.asarray([0.0, 0.1, 0.2])[:, None, None]
        l_seq = qp0.l[None] - widen
        u_seq = qp0.u[None] + widen
        sols = solve_sequence_vectors_jit(qp0, q_seq, l_seq, u_seq, SET)
        assert (np.asarray(sols.info.status) >= 2).all()
        # Tick t must equal a standalone solve of its bounds (warm starts
        # change iterates' paths but not solutions at tight eps).
        last = qps.solve_jit(dataclasses.replace(
            qp0, l=l_seq[-1], u=u_seq[-1]), SET)
        assert np.abs(np.asarray(sols.x[-1]) - np.asarray(last.x)).max() < 1e-5


class TestSequenceStaticMatrices:
    def test_matches_per_tick_solves(self):
        import jax.numpy as jnp

        # A drifting-q sequence over static P/A: static_matrices must be
        # bitwise-identical to the plain sequence (carry_rho off; same rho,
        # same factor values).
        T, B, n, m = 5, 3, 24, 12
        qp0 = fleet(batch=B, n=n, m=m, seed=1)
        drift = jnp.linspace(0.0, 1.0, T)[:, None, None]
        qp_seq = qps.QP(
            P=jnp.broadcast_to(qp0.P, (T, B, n, n)),
            q=qp0.q * (1.0 + 0.3 * drift),
            A=jnp.broadcast_to(qp0.A, (T, B, m, n)),
            l=jnp.broadcast_to(qp0.l, (T, B, m)),
            u=jnp.broadcast_to(qp0.u, (T, B, m)),
        )
        plain = solve_sequence_jit(qp_seq, SET, None, False, False)
        fast = solve_sequence_jit(qp_seq, SET, None, False, True)
        assert np.abs(np.asarray(plain.x) - np.asarray(fast.x)).max() < 1e-9
        assert np.array_equal(np.asarray(plain.info.iterations),
                              np.asarray(fast.info.iterations))
