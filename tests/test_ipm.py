"""Interior-point (log-barrier) solver vs exact-QP DDP and scipy goldens.

The barrier solver is the IPOPT-method analogue (``solver/ipm.py``): it must
agree with the exact active-set DDP path on the reference's nu=2 problems to
within the barrier gap, and extend to nu > 2 (beyond the enumeration/Pallas
fast paths) where it is validated against a scipy L-BFGS-B golden.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mpc_verde_tpu as mv
from mpc_verde_tpu.models import unicycle
from mpc_verde_tpu.ops import rk4_step
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver
from mpc_verde_tpu.solver.ipm import make_barrier_solver

T, N = 0.2, 12


def _diffdrive_ocp():
    F = rk4_step(unicycle.f, T)
    Q = jnp.diag(jnp.array([1.0, 5.0, 0.1]))
    R = jnp.diag(jnp.array([0.5, 0.05]))

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    return mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l,
                  N=N, nx=3, nu=2, npar=3,
                  control_bounds=mv.box_bounds(
                      jnp.array([-1.0, -np.pi / 4]), jnp.array([1.0, np.pi / 4])))


@pytest.mark.slow
def test_barrier_matches_exact_ddp_on_diffdrive():
    ocp = _diffdrive_ocp()
    B = 6
    rng = np.random.default_rng(5)
    x0s = jnp.array(rng.uniform(-2, 2, (B, 3)))
    params = jnp.broadcast_to(jnp.array([5.0, 5.0, 0.0]), (B, N + 1, 3))
    us0 = jnp.zeros((B, N, 2))

    rd = jax.jit(make_batched_ilqr_solver(
        ocp, mv.ILQROptions(max_iters=80), backend="xla"))(x0s, params, us0)
    rb = make_barrier_solver(ocp, mv.ILQROptions(max_iters=80),
                             backend="xla")(x0s, params, us0)
    assert bool(rd.converged.all()) and bool(rb.converged.all())
    # active bounds must actually be exercised by this problem set
    at_bound = np.isclose(np.abs(np.array(rd.us[..., 0])), 1.0, atol=1e-6)
    assert at_bound.any()
    # with crossover the active sets pin exactly
    assert np.abs(np.array(rd.us) - np.array(rb.us)).max() < 1e-4
    assert np.allclose(np.array(rd.cost), np.array(rb.cost), rtol=1e-6)
    # the pure barrier iterate (no crossover) stays strictly interior and
    # lands within the flat-valley tolerance of the exact solution
    rp = make_barrier_solver(ocp, mv.ILQROptions(max_iters=80),
                             backend="xla", crossover=False)(x0s, params, us0)
    assert (np.array(rp.us[..., 0]) > -1.0).all()
    assert (np.array(rp.us[..., 0]) < 1.0).all()
    assert np.allclose(np.array(rd.cost), np.array(rp.cost), rtol=1e-5)
    assert np.abs(np.array(rd.us) - np.array(rp.us)).max() < 1e-2


@pytest.mark.slow
def test_barrier_solves_nu3_beyond_enumeration_fastpath():
    # 3-D single integrator with 3 box-bounded velocity controls: nu=3 is
    # past the Pallas kernel's nu<=2 and exercises the barrier path's
    # arbitrary-nu claim; golden = scipy L-BFGS-B on the numpy rollout
    nx = nu = 3
    Nh = 8
    dt = 0.25
    target = np.array([2.0, -1.5, 1.0])
    ub = np.array([0.8, 0.5, 0.6])
    lb = -ub
    Q = np.diag([1.0, 2.0, 1.5])
    R = 0.1 * np.eye(3)

    def np_cost(uflat):
        us = uflat.reshape(Nh, nu)
        x = np.zeros(nx)
        c = 0.0
        for k in range(Nh):
            u = np.clip(us[k], lb, ub)
            e = x - target
            c += e @ Q @ e + u @ R @ u
            x = x + dt * u
        e = x - target
        return c + 10.0 * e @ e

    from scipy.optimize import minimize
    gold = minimize(np_cost, np.zeros(Nh * nu), method="L-BFGS-B",
                    bounds=[(lb[i % nu], ub[i % nu]) for i in range(Nh * nu)],
                    options=dict(maxiter=3000, ftol=1e-15, gtol=1e-12))

    Qj, Rj = jnp.array(Q), jnp.array(R)
    tj = jnp.array(target)

    def l(x, u, p):
        e = x - tj
        return e @ Qj @ e + u @ Rj @ u

    ocp = mv.OCP(dynamics=lambda x, u, p: x + dt * u, stage_cost=l,
                 terminal_cost=lambda x, p: 10.0 * (x - tj) @ (x - tj),
                 N=Nh, nx=nx, nu=nu, npar=0,
                 control_bounds=mv.box_bounds(jnp.array(lb), jnp.array(ub)))
    # crossover=False: validate the PURE barrier path (the arbitrary-nu
    # capability) against the golden, not the DDP polish
    solve = make_barrier_solver(ocp, mv.ILQROptions(max_iters=100),
                                backend="xla", crossover=False)
    r = solve(jnp.zeros((1, nx)))
    assert bool(r.converged.all())
    rel = abs(float(r.cost[0]) - gold.fun) / (1.0 + gold.fun)
    assert rel < 1e-5, (float(r.cost[0]), gold.fun)
    # some bound must be active at the golden optimum for this to mean much
    assert np.isclose(np.abs(gold.x.reshape(Nh, nu)), ub, atol=1e-6).any()
    assert np.abs(np.array(r.us[0]) - gold.x.reshape(Nh, nu)).max() < 1e-3


def test_streaming_barrier_matches_exact_ddp():
    """VERDICT r3 #5: the streaming IPM (mu continuation as in-place slot
    rounds + structural mu=0 crossover) must land on the exact-QP DDP
    solution, with every queue member converged."""
    from mpc_verde_tpu.solver.ipm import make_streaming_barrier_solver

    ocp = _diffdrive_ocp()
    M = 8
    rng = np.random.default_rng(5)
    x0s = jnp.array(rng.uniform(-2, 2, (M, 3)))
    params = jnp.broadcast_to(jnp.array([5.0, 5.0, 0.0]), (M, N + 1, 3))
    us0 = jnp.zeros((M, N, 2))

    rd = jax.jit(make_batched_ilqr_solver(
        ocp, mv.ILQROptions(max_iters=80), backend="xla"))(x0s, params, us0)
    rs = jax.jit(make_streaming_barrier_solver(
        ocp, mv.ILQROptions(max_iters=80), backend="xla",
        batch_width=4, restarts=1))(x0s, params, us0)
    assert bool(rd.converged.all()) and bool(rs.converged.all())
    # the crossover round pins active bounds exactly
    at_bound = np.isclose(np.abs(np.array(rd.us[..., 0])), 1.0, atol=1e-6)
    assert at_bound.any()
    assert np.abs(np.array(rd.us) - np.array(rs.us)).max() < 1e-4
    assert np.allclose(np.array(rd.cost), np.array(rs.cost), rtol=1e-6)
    # iterations accumulate across the whole continuation
    assert (np.array(rs.iterations) > np.array(rd.iterations)).all()


def test_streaming_barrier_ddp_warmstart_hybrid():
    """warmstart='ddp': the DDP phase identifies the active set at DDP
    speed, then a single interior stage + mu=0 crossover recenters/polishes
    through the barrier — same optima as the cold continuation, measurably
    fewer total iterations (the cold path's schedule-invariant crawl to the
    active set is what the warm start removes; docs/design.md)."""
    from mpc_verde_tpu.solver.ipm import make_streaming_barrier_solver

    ocp = _diffdrive_ocp()
    M = 8
    rng = np.random.default_rng(5)
    x0s = jnp.array(rng.uniform(-2, 2, (M, 3)))
    params = jnp.broadcast_to(jnp.array([5.0, 5.0, 0.0]), (M, N + 1, 3))
    us0 = jnp.zeros((M, N, 2))

    opts = mv.ILQROptions(max_iters=80)
    cold = jax.jit(make_streaming_barrier_solver(
        ocp, opts, backend="xla", batch_width=4, restarts=1))(
        x0s, params, us0)
    hyb = jax.jit(make_streaming_barrier_solver(
        ocp, opts, backend="xla", mu_schedule=(1e-4,), batch_width=4,
        restarts=1, warmstart="ddp"))(x0s, params, us0)
    assert bool(hyb.converged.all())
    # same optima as the cold interior-point continuation
    assert np.allclose(np.array(hyb.cost), np.array(cold.cost), rtol=1e-6)
    assert np.abs(np.array(hyb.us) - np.array(cold.us)).max() < 1e-4
    # and genuinely cheaper: total passes (DDP phase INCLUDED) below cold
    assert float(hyb.iterations.mean()) < float(cold.iterations.mean())
    # the reported count includes the DDP phase (> any single-phase floor)
    rd = jax.jit(make_batched_ilqr_solver(ocp, opts, backend="xla"))(
        x0s, params, us0)
    assert (np.array(hyb.iterations) > np.array(rd.iterations)).all()


def test_barrier_term_boundary_semantics():
    """Regression (round-4 review): a control clipped exactly to the box
    must price +inf (rejection) at mu > 0 — the sentinel's SIGN is what
    implements the fraction-to-boundary rule; the inverted sign made
    saturated candidates infinitely attractive.  At mu = 0 the term and
    its gradient must be exactly zero even on the boundary."""
    from mpc_verde_tpu.solver.ipm import _barrier_term

    lb = np.array([-1.0, -0.5])
    ub = np.array([1.0, 0.5])
    interior = jnp.array([0.3, -0.2])
    on_bound = jnp.array([1.0, 0.0])   # first coordinate saturated
    outside = jnp.array([1.2, 0.0])

    assert np.isfinite(float(_barrier_term(interior, lb, ub, 1e-2)))
    assert float(_barrier_term(on_bound, lb, ub, 1e-2)) == np.inf
    assert float(_barrier_term(outside, lb, ub, 1e-2)) == np.inf
    # mu = 0 (crossover): exactly zero value AND gradient, boundary included
    for u in (interior, on_bound, outside):
        assert float(_barrier_term(u, lb, ub, 0.0)) == 0.0
        g = jax.grad(lambda uu: _barrier_term(uu, lb, ub, 0.0))(u)
        np.testing.assert_array_equal(np.array(g), 0.0)
    # and the line-search acceptance logic can never prefer an infeasible
    # candidate: +inf is worse than any finite cost
    assert not (float(_barrier_term(on_bound, lb, ub, 1e-2)) < 1e30)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_barrier_term_hessian_finite_on_bound(dtype):
    """The crossover round (mu = 0) linearizes at controls pinned on their
    bounds: the barrier's Hessian there must be exactly zero, not NaN — in
    f32 too, where a 1e-30 floor squared underflows to 0."""
    from mpc_verde_tpu.solver.ipm import _barrier_term

    lb = np.array([-1.0, -0.5])
    ub = np.array([1.0, 0.5])
    on_bound = jnp.array([1.0, 0.0], dtype)
    H = jax.hessian(lambda uu: _barrier_term(uu, lb, ub, dtype(0.0)))(
        on_bound)
    np.testing.assert_array_equal(np.array(H), 0.0)
    interior = jnp.array([0.3, -0.2], dtype)
    H = jax.hessian(lambda uu: _barrier_term(uu, lb, ub, dtype(1e-2)))(
        interior)
    assert np.isfinite(np.array(H)).all()


@pytest.mark.slow
def test_barrier_over_scan_backend_composes():
    """VERDICT r3 #7: the error message at batched.py's scan guard points
    bound problems at the IPM composition — prove it works: the barrier
    subproblems are unbounded, so backend="scan" (associative-scan
    backward) composes, and must agree with the xla path on an nu=3
    problem."""
    nx = nu = 3
    Nh = 8
    dt = 0.25
    target = jnp.array([2.0, -1.5, 1.0])
    ub = jnp.array([0.8, 0.5, 0.6])
    Qj = jnp.diag(jnp.array([1.0, 2.0, 1.5]))
    Rj = 0.1 * jnp.eye(3)

    def l(x, u, p):
        e = x - target
        return e @ Qj @ e + u @ Rj @ u

    ocp = mv.OCP(dynamics=lambda x, u, p: x + dt * u, stage_cost=l,
                 terminal_cost=lambda x, p: 10.0 * (x - target) @ (x - target),
                 N=Nh, nx=nx, nu=nu, npar=0,
                 control_bounds=mv.box_bounds(-ub, ub))
    opts = mv.ILQROptions(max_iters=100)
    r_x = make_barrier_solver(ocp, opts, backend="xla",
                              crossover=False)(jnp.zeros((2, nx)))
    r_s = make_barrier_solver(ocp, opts, backend="scan",
                              crossover=False)(jnp.zeros((2, nx)))
    assert bool(r_x.converged.all()) and bool(r_s.converged.all())
    assert np.allclose(np.array(r_x.cost), np.array(r_s.cost), rtol=1e-8)
    assert np.abs(np.array(r_x.us) - np.array(r_s.us)).max() < 1e-6


@pytest.mark.slow
def test_al_state_bounds_over_scan_backend():
    """VERDICT r3 #7 (second half): AL state bounds compose over
    backend="scan" — the augmented subproblems have no control bounds, so
    the scan backward applies; verify against the xla path."""
    F = rk4_step(unicycle.f, T)
    Q = jnp.diag(jnp.array([1.0, 5.0, 0.1]))
    R = jnp.diag(jnp.array([0.5, 0.05]))

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    ocp = mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l,
                 N=N, nx=3, nu=2, npar=3,
                 x_lb=jnp.array([-jnp.inf, -0.8, -jnp.inf]),
                 x_ub=jnp.array([jnp.inf, 0.8, jnp.inf]))
    # use_ddp=False for the xla reference: backend="scan" is Gauss-Newton by
    # construction, and on this nonconvex problem full DDP can land on a
    # different (worse) local optimum — method must match for parity.
    # B=2: smallest batch (quick-lane budget); al_iters=3 is needed for the
    # multipliers to tighten the box to the asserted tolerance
    opts = mv.ILQROptions(max_iters=60, al_iters=3, use_ddp=False)
    rng = np.random.default_rng(9)
    x0s = jnp.array(rng.uniform(-0.5, 0.5, (2, 3)))
    params = jnp.broadcast_to(jnp.array([2.0, 2.0, 0.0]), (2, N + 1, 3))
    us0 = jnp.zeros((2, N, 2))
    r_x = jax.jit(make_batched_ilqr_solver(ocp, opts, backend="xla"))(
        x0s, params, us0)
    r_s = jax.jit(make_batched_ilqr_solver(ocp, opts, backend="scan"))(
        x0s, params, us0)
    assert bool(r_x.converged.all()) and bool(r_s.converged.all())
    # the y box is enforced by both
    assert float(jnp.max(jnp.abs(r_s.xs[:, :, 1]))) <= 0.8 + 1e-2
    assert np.allclose(np.array(r_x.cost), np.array(r_s.cost), rtol=1e-6)
    assert np.allclose(np.array(r_x.max_violation),
                       np.array(r_s.max_violation), atol=1e-6)


def test_barrier_rejects_non_constant_or_pinned_boxes():
    ocp = _diffdrive_ocp()
    # stage-dependent (move-blocking style) bounds must be rejected
    lbs = np.tile(np.array([-1.0, -np.pi / 4]), (N, 1))
    ubs = np.tile(np.array([1.0, np.pi / 4]), (N, 1))
    ubs[N // 2:] = lbs[N // 2:]  # pinned tail
    import dataclasses
    bad = dataclasses.replace(ocp, control_bounds=mv.box_bounds(lbs, ubs))
    with pytest.raises(ValueError):
        make_barrier_solver(bad)
    with pytest.raises(ValueError):
        make_barrier_solver(dataclasses.replace(ocp, control_bounds=None))


def test_barrier_rejects_mid_horizon_varying_box():
    # a box that differs ONLY in interior stages (endpoints identical) must
    # still be rejected — the constancy probe covers every stage index
    ocp = _diffdrive_ocp()
    lbs = np.tile(np.array([-1.0, -np.pi / 4]), (N, 1))
    ubs = np.tile(np.array([1.0, np.pi / 4]), (N, 1))
    ubs[1:-1, 0] = 0.5  # tighter mid-horizon, same first/last stage
    import dataclasses
    bad = dataclasses.replace(ocp, control_bounds=mv.box_bounds(lbs, ubs))
    with pytest.raises(ValueError):
        make_barrier_solver(bad)


@pytest.mark.slow
def test_streaming_barrier_composes_with_al_state_bounds():
    """VERDICT r4 #5: state-box problems stream through the barrier solver —
    the AL (lam, mu_al) and barrier (mu) continuations ride the per-slot
    rounds machinery as a product schedule (the NotImplementedError is
    gone).  Parity reference is the direct AL-DDP path (the production
    semantics); the nested make_barrier_solver composition is also run as
    the IPOPT-family cross-check."""
    import dataclasses

    from mpc_verde_tpu.solver.ipm import make_streaming_barrier_solver

    ocp = dataclasses.replace(
        _diffdrive_ocp(),
        x_lb=jnp.array([-jnp.inf, -0.8, -jnp.inf]),
        x_ub=jnp.array([jnp.inf, 0.8, jnp.inf]))
    opts = mv.ILQROptions(max_iters=60, al_iters=3)
    rng = np.random.default_rng(9)
    B = 4
    x0s = jnp.array(rng.uniform(-0.5, 0.5, (B, 3)))
    params = jnp.broadcast_to(jnp.array([2.0, 2.0, 0.0]), (B, N + 1, 3))
    us0 = jnp.zeros((B, N, 2))

    r_ddp = jax.jit(make_batched_ilqr_solver(ocp, opts, backend="xla"))(
        x0s, params, us0)
    r_st = jax.jit(make_streaming_barrier_solver(
        ocp, opts, backend="xla", batch_width=2, restarts=1))(
        x0s, params, us0)
    assert bool(r_ddp.converged.all()) and bool(r_st.converged.all())
    # the y box binds on this problem (target y=2 vs box 0.8) and both
    # paths enforce it to AL tolerance
    assert float(jnp.max(r_st.xs[:, :, 1])) <= 0.8 + 1e-2
    assert float(r_st.max_violation.max()) < 1e-2
    # the direct path's AL endpoint is LOOSER than the streamed one here
    # (measured 0.011 vs 0.004) — it only bounds the comparison baseline
    assert float(r_ddp.max_violation.max()) < 2e-2
    # AL endpoints differ slightly between the interleaved and direct
    # paths (different final (lam, mu_al) -> different point on the
    # feasibility/cost tradeoff): parity to AL tolerance, not solver
    # tolerance (measured: streamed ends ~0.15% higher cost, ~10x tighter
    # constraint than the direct path)
    np.testing.assert_allclose(np.array(r_st.cost), np.array(r_ddp.cost),
                               rtol=5e-3)
    # slightly different constraint tightness -> slightly different optimal
    # steering mid-horizon (measured max 0.17 rad here); this bound only
    # catches gross divergence — cost/violation above are the real parity
    assert np.abs(np.array(r_st.us) - np.array(r_ddp.us)).max() < 0.3
    # nested composition (7-stage barrier, AL inside each stage) agrees too
    rb = make_barrier_solver(ocp, opts, backend="xla")(x0s, params, us0)
    np.testing.assert_allclose(np.array(rb.cost), np.array(r_ddp.cost),
                               rtol=1e-3)


@pytest.mark.slow
def test_streaming_barrier_inexact_subproblems():
    """VERDICT r4 #3: early barrier subproblems are solved inexactly (inner
    tolerance tied to mu, IPOPT-style).  The loosening must cut total
    iterations while the mu=0 crossover round's strict tolerance keeps the
    final answer on the exact-DDP optimum."""
    from mpc_verde_tpu.solver.ipm import make_streaming_barrier_solver

    ocp = _diffdrive_ocp()
    M = 8
    rng = np.random.default_rng(5)
    x0s = jnp.array(rng.uniform(-2, 2, (M, 3)))
    params = jnp.broadcast_to(jnp.array([5.0, 5.0, 0.0]), (M, N + 1, 3))
    us0 = jnp.zeros((M, N, 2))
    opts = mv.ILQROptions(max_iters=80)

    rd = jax.jit(make_batched_ilqr_solver(ocp, opts, backend="xla"))(
        x0s, params, us0)
    r_ex = jax.jit(make_streaming_barrier_solver(
        ocp, opts, backend="xla", batch_width=4, inexact_kappa=0.0))(
        x0s, params, us0)
    r_in = jax.jit(make_streaming_barrier_solver(
        ocp, opts, backend="xla", batch_width=4, inexact_kappa=10.0))(
        x0s, params, us0)
    assert bool(r_ex.converged.all()) and bool(r_in.converged.all())
    # inexact early rounds: strictly fewer (or equal) total iterations
    assert float(r_in.iterations.mean()) <= float(r_ex.iterations.mean())
    # ... at unchanged final accuracy (strict crossover round)
    assert np.abs(np.array(r_in.us) - np.array(rd.us)).max() < 1e-4
    np.testing.assert_allclose(np.array(r_in.cost), np.array(rd.cost),
                               rtol=1e-6)
