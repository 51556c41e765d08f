"""OSQP-ADMM solver parity tests vs the float64 oracle.

Reproduces the reference's test discipline (`/root/reference/RunTests.jl:62-99`):
sweep the problem families with seeded instances, solve at eps=1e-7, accept
`|x - x_ref|_inf <= 1e-5`. The external oracles (OSQP/Gurobi) are replaced by
the independent host-side f64 sparse-LU ADMM plus direct KKT-condition checks
(see quadraticprogramsolver_tpu/utils/oracle.py).

All problems are zero-padded to one shared (n=128, m=128) shape — the
framework's static-shape fleet mechanism — so the whole sweep shares a single
compiled executable (and the padding path itself is exercised everywhere).
Seeds are pinned to feasible instances: the reference generator's sparse A
can emit all-zero rows with l=u != 0 (infeasible), on which x-parity is
meaningless.
"""

import numpy as np
import pytest

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.core.settings import KKTBackendKind
from quadraticprogramsolver_tpu.problems.generator import ALL_CLASSES, ProblemClass
from quadraticprogramsolver_tpu.utils.oracle import kkt_optimality, solve_qp_reference

# Keep the non-box families small via explicit constraint counts so the dense
# f64 CI sweep stays fast; RunTests.jl uses n in {10,100} with paper defaults.
SMALL_M = {
    ProblemClass.LASSO: 30,
    ProblemClass.HUBER: 30,
    ProblemClass.SVM: 30,
    ProblemClass.INEQUALITY_QP: 30,
}

# Seeds with feasible, convergent instances at n=10 (probed against the oracle).
FEASIBLE_SEEDS = {
    ProblemClass.RANDOM_QP: (0, 3, 4),
    ProblemClass.INEQUALITY_QP: (0, 1, 2),
    ProblemClass.EQUALITY_QP: (6, 7),
    ProblemClass.OPTIMAL_CONTROL: (0, 3, 4),
    ProblemClass.PORTFOLIO: (0, 1, 2),
    ProblemClass.LASSO: (0, 1, 2),
    ProblemClass.HUBER: (0, 1, 2),
    ProblemClass.SVM: (0, 1, 2),
    ProblemClass.ISOTONIC: (0, 1, 2),
}

PAD_N, PAD_M = 128, 128

TEST_SETTINGS = qps.Settings(
    max_iterations=50_000,
    eps_abs=1e-7,
    eps_rel=1e-7,
    rho=0.1,
    adaptive_rho=True,
)
ABS_DEV_THR = 1e-5  # RunTests.jl:58


def _padded_qp(data, dtype=np.float64):
    return qps.pad_qp(qps.make_qp(*data.dense(), dtype=dtype), PAD_N, PAD_M)


def _solve_both(cls, n, seed, settings=TEST_SETTINGS):
    data = qps.generate_random_qp(cls, n, num_constraints=SMALL_M.get(cls, 0), seed=seed)
    ref = solve_qp_reference(
        data.P, data.q, data.A, data.l, data.u,
        eps_abs=1e-9, eps_rel=1e-9, rho=0.1)
    sol = qps.solve_jit(_padded_qp(data), settings)
    return data, ref, sol


@pytest.mark.parametrize("cls", ALL_CLASSES, ids=lambda c: c.value)
def test_parity_vs_oracle(cls):
    for seed in FEASIBLE_SEEDS[cls]:
        data, ref, sol = _solve_both(cls, 10, seed)
        assert ref.status == 3, f"oracle failed to converge on {cls} seed {seed}"
        assert int(sol.info.status) >= qps.Status.SOLVED_ADMM
        dev = np.abs(np.asarray(sol.x)[: data.n] - ref.x).max()
        assert dev <= ABS_DEV_THR, f"{cls} seed {seed}: |x-x_ref|_inf = {dev}"


@pytest.mark.parametrize("cls", [ProblemClass.RANDOM_QP, ProblemClass.PORTFOLIO],
                         ids=lambda c: c.value)
def test_parity_medium(cls):
    data, ref, sol = _solve_both(cls, 100, 7)
    assert ref.status == 3
    dev = np.abs(np.asarray(sol.x)[: data.n] - ref.x).max()
    assert dev <= ABS_DEV_THR, dev


def test_kkt_conditions_direct():
    # Independent optimality check, no oracle trajectory involved.
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 40, seed=9)
    sol = qps.solve_jit(_padded_qp(data), TEST_SETTINGS)
    rep = kkt_optimality(
        data.P, data.q, data.A, data.l, data.u,
        np.asarray(sol.x)[: data.n],
        np.asarray(sol.z)[: data.m],
        np.asarray(sol.y)[: data.m])
    assert rep.res_prim <= 1e-6
    assert rep.res_dual <= 1e-5
    assert rep.res_comp <= 1e-4


def test_batched_solve_matches_individual():
    qp = qps.generate_batch(ProblemClass.RANDOM_QP, batch=8, num_elements=20,
                            seed=3, dtype=np.float64)
    sol = qps.solve_jit(qp, TEST_SETTINGS)
    assert sol.x.shape == (8, 20)
    solo = [
        qps.solve_jit(qps.QP(*(leaf[i] for leaf in (qp.P, qp.q, qp.A, qp.l, qp.u))),
                      TEST_SETTINGS)
        for i in range(8)
    ]
    for i, si in enumerate(solo):
        dev = np.abs(np.asarray(sol.x[i]) - np.asarray(si.x)).max()
        assert dev <= 1e-6, f"lane {i} diverges from solo solve: {dev}"


def test_padding_preserves_solution():
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 20, seed=3)
    qp = qps.make_qp(*data.dense(), dtype=np.float64)
    plain = qps.solve_jit(qp, TEST_SETTINGS)
    padded = qps.solve_jit(qps.pad_qp(qp, PAD_N, PAD_M), TEST_SETTINGS)
    dev = np.abs(np.asarray(padded.x)[: data.n] - np.asarray(plain.x)).max()
    assert dev <= 1e-8, dev
    assert np.abs(np.asarray(padded.x)[data.n:]).max() <= 1e-8


def test_cg_backend_parity():
    st = qps.Settings(
        max_iterations=50_000, eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
        adaptive_rho=True, kkt_backend=KKTBackendKind.CG,
        cg_eps=1e-10, cg_max_iterations=500)
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 30, seed=4)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-9, eps_rel=1e-9, rho=0.1)
    assert ref.status == 3
    sol = qps.solve_jit(_padded_qp(data), st)
    dev = np.abs(np.asarray(sol.x)[: data.n] - ref.x).max()
    assert dev <= ABS_DEV_THR, dev


def test_float32_accuracy():
    # BASELINE.md target: 1e-4 accuracy in the f32 regime of the device.
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 50, seed=5)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-9, eps_rel=1e-9, rho=0.1)
    assert ref.status == 3
    st = qps.Settings(max_iterations=20_000, eps_abs=2e-5, eps_rel=2e-5,
                      rho=0.1, adaptive_rho=True)
    sol = qps.solve_jit(_padded_qp(data, dtype=np.float32), st)
    assert int(sol.info.status) >= qps.Status.SOLVED_ADMM
    dev = np.abs(np.asarray(sol.x)[: data.n] - ref.x).max()
    assert dev <= 1e-3, dev


def test_polish_improves_solution():
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 30, seed=6)
    loose = qps.Settings(max_iterations=500, eps_abs=1e-4, eps_rel=1e-4,
                         rho=0.1, adaptive_rho=True)
    polished = qps.Settings(max_iterations=500, eps_abs=1e-4, eps_rel=1e-4,
                            rho=0.1, adaptive_rho=True, polish_iterations=10)
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-10, eps_rel=1e-10, rho=0.1)
    qp = _padded_qp(data)
    base = qps.solve_jit(qp, loose)
    pol = qps.solve_jit(qp, polished)
    dev_base = np.abs(np.asarray(base.x)[: data.n] - ref.x).max()
    dev_pol = np.abs(np.asarray(pol.x)[: data.n] - ref.x).max()
    assert dev_pol <= dev_base + 1e-12
    assert dev_pol <= 1e-6, (dev_base, dev_pol)


def test_warm_start_reduces_iterations():
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 30, seed=8)
    qp = _padded_qp(data)
    cold = qps.solve_jit(qp, TEST_SETTINGS)
    warm = qps.solve_jit(qp, TEST_SETTINGS, cold.x)
    assert int(warm.info.iterations) <= int(cold.info.iterations)


def test_status_max_iterations():
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 20, seed=2)
    st = qps.Settings(max_iterations=25, eps_abs=1e-12, eps_rel=1e-12, rho=0.1)
    sol = qps.solve_jit(_padded_qp(data), st)
    assert int(sol.info.status) == qps.Status.MAX_ITERATIONS


def test_objective_reported():
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 15, seed=1)
    sol = qps.solve_jit(_padded_qp(data), TEST_SETTINGS)
    x = np.asarray(sol.x)[: data.n]
    P, q = data.P.toarray(), data.q
    obj = 0.5 * x @ P @ x + q @ x
    assert np.isclose(float(sol.info.objective), obj, rtol=1e-9, atol=1e-12)


def test_residual_history_recorded():
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 20, seed=3)
    st = qps.Settings(max_iterations=500, eps_abs=1e-8, eps_rel=1e-8, rho=0.1,
                      adaptive_rho=True, record_history=True)
    sol = qps.solve_jit(qps.make_qp(*data.dense(), dtype=np.float64), st)
    h = sol.info.history
    assert set(h) == {"res_prim", "res_dual", "rho"}
    rp = np.asarray(h["res_prim"])
    assert rp.shape == (st.num_checks,)
    k = int(sol.info.iterations) // st.check_interval
    assert np.isfinite(rp[:k]).all()
    assert np.isinf(rp[k:]).all()          # untouched after convergence
    # Final recorded residual matches the reported one.
    assert np.isclose(rp[k - 1], float(sol.info.res_prim))
    # History off by default.
    sol2 = qps.solve_jit(qps.make_qp(*data.dense(), dtype=np.float64), TEST_SETTINGS)
    assert sol2.info.history is None


def test_segmented_solve_matches_plain():
    from quadraticprogramsolver_tpu.models.admm import solve_segmented

    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 24, seed=3)
    qp = qps.make_qp(*data.dense(), dtype=np.float64)
    st = qps.Settings(max_iterations=2000, eps_abs=1e-8, eps_rel=1e-8, rho=0.1,
                      adaptive_rho=True)
    plain = qps.solve_jit(qp, st)
    seg = solve_segmented(qp, st, segment_iterations=50)
    assert int(seg.info.status) in (2, 3)
    dev = np.abs(np.asarray(seg.x) - np.asarray(plain.x)).max()
    assert dev <= 1e-7, dev
    # A budget-exhausting problem still reports MAX_ITERATIONS.
    tiny = qps.Settings(max_iterations=100, eps_abs=1e-14, eps_rel=1e-14,
                        rho=0.1, check_infeasibility=False)
    seg2 = solve_segmented(qp, tiny, segment_iterations=25)
    assert int(seg2.info.status) == qps.Status.MAX_ITERATIONS
    assert int(seg2.info.iterations) == 100


def test_f32_sigma_floor_on_degenerate_qp():
    # huber instances have zero-cost flat directions: lambda_min(M) collapses
    # to sigma, and at the reference's f64-era sigma=1e-6 the f32 KKT solve
    # has cond*eps > 1 (refinement diverges, residuals oscillate forever —
    # seeds 7/48 reproduce it). The dtype-aware sigma floor (settings.py:
    # SIGMA_F32_FLOOR) must make these converge.
    for seed in (7, 48):
        data = qps.generate_random_qp(ProblemClass.HUBER, 64,
                                      num_constraints=64, seed=seed)
        qp = qps.make_qp(*data.dense(), dtype=np.float32)
        st = qps.Settings(max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4,
                          rho=0.1, adaptive_rho=True, kkt_refinement_steps=2)
        sol = qps.solve_jit(qp, st)
        assert int(sol.info.status) in (2, 3), (seed, int(sol.info.status))
    # f64 must NOT be floored: sigma_for is identity there.
    assert qps.Settings().sigma_for(np.float64) == qps.Settings().sigma


def test_segmented_host_rho_adaptation():
    # Device programs run rho-static; the host applies the candidate +
    # hysteresis rule between segments (solve_segmented's host_rho_adaptation).
    # Must converge to the same solution as the in-program adaptive solve.
    from quadraticprogramsolver_tpu.models.admm import solve_segmented

    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 24, seed=3)
    sqp = qps.make_sparse_qp(data.P, data.q, data.A, data.l, data.u,
                             dtype=np.float64)
    st = qps.Settings(max_iterations=4000, eps_abs=1e-8, eps_rel=1e-8,
                      # rho far off so convergence genuinely needs adaptation
                      rho=100.0, adaptive_rho=True,
                      cg_eps=1e-12, cg_max_iterations=400)
    plain = qps.solve_jit(sqp, st)
    host = solve_segmented(sqp, st, segment_iterations=50,
                           host_rho_adaptation=True)
    assert int(host.info.status) in (2, 3)
    dev = np.abs(np.asarray(host.x) - np.asarray(plain.x)).max()
    assert dev <= 1e-6, dev
    # And the adaptation actually moved rho off its (bad) initial value.
    assert abs(float(host.info.rho) - 100.0) > 1.0


def test_bitwise_reproducibility():
    # SURVEY.md §5: in place of race detection (nothing races here), assert
    # cross-run determinism — two identical solves must agree bitwise.
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 24, seed=4)
    qp = qps.make_qp(*data.dense(), dtype=np.float64)
    a = qps.solve_jit(qp, TEST_SETTINGS)
    b = qps.solve_jit(qp, TEST_SETTINGS)
    assert np.array_equal(np.asarray(a.x), np.asarray(b.x))
    assert np.array_equal(np.asarray(a.y), np.asarray(b.y))
    assert np.array_equal(np.asarray(a.info.iterations), np.asarray(b.info.iterations))


def test_segmented_respects_budget_non_divisible():
    # total=100, segments of 40 (rounded to 50 by check_interval) must clamp
    # the last segment so exactly 100 iterations run.
    from quadraticprogramsolver_tpu.models.admm import solve_segmented

    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 16, seed=3)
    qp = qps.make_qp(*data.dense(), dtype=np.float64)
    st = qps.Settings(max_iterations=100, eps_abs=1e-14, eps_rel=1e-14,
                      rho=0.1, check_interval=25, check_infeasibility=False)
    seg = solve_segmented(qp, st, segment_iterations=40)
    assert int(seg.info.status) == qps.Status.MAX_ITERATIONS
    assert int(seg.info.iterations) == 100


def test_sigma_free_rhs_matches_default():
    """sigma_free_rhs (exact ADMM on P + sigma*I, G/g cache) reaches the same
    solution as the proximal default; at f64 with tiny sigma the two fixed
    points coincide to solver tolerance."""
    import dataclasses

    s_free = dataclasses.replace(
        TEST_SETTINGS, sigma_free_rhs=True, kkt_refinement_steps=0,
        sigma=1e-10, kkt_backend=KKTBackendKind.CHOLESKY)
    for cls in (ProblemClass.RANDOM_QP, ProblemClass.PORTFOLIO):
        seed = FEASIBLE_SEEDS[cls][0]
        data, ref, sol = _solve_both(cls, 10, seed, settings=s_free)
        assert ref.status == 3
        assert int(sol.info.status) >= qps.Status.SOLVED_ADMM
        dev = np.abs(np.asarray(sol.x)[: data.n] - ref.x).max()
        assert dev <= ABS_DEV_THR, f"{cls}: {dev}"


def test_sigma_free_rhs_guards():
    import dataclasses

    with pytest.raises(ValueError, match="refinement"):
        qps.Settings(sigma_free_rhs=True, kkt_refinement_steps=1)
    # Non-dense / iterative backends reject the flag at solve time.
    s = dataclasses.replace(TEST_SETTINGS, sigma_free_rhs=True,
                            kkt_refinement_steps=0,
                            kkt_backend=KKTBackendKind.CG)
    qp = _padded_qp(qps.generate_random_qp(ProblemClass.RANDOM_QP, 10, seed=0))
    with pytest.raises(ValueError, match="sigma_free_rhs"):
        qps.solve(qp, s)
