"""Condensed linear-MPC QP path (solver/condensed.py) vs scipy and DDP.

The condensed formulation eliminates states and optimizes the move-blocked
controls directly — the classical dense treatment of the reference's
``isQP=True`` pendulum family, as batched matrix algebra.
"""
import jax
import jax.numpy as jnp
import numpy as np

import mpc_verde_tpu as mv
from mpc_verde_tpu.ops import c2d
from mpc_verde_tpu.solver.condensed import (blocking_matrix, condense,
                                            prediction_matrices,
                                            solve_condensed, solve_dense_boxqp)


def _pendulum_lti():
    # the reference's cart-pendulum linearization
    # (Inverted_pendulum/inverted_pendulum_single_shooting_mpctools.py:19-24)
    Ac = np.array([[0.0, 1.0, 0.0, 0.0],
                   [0.0, -0.1, 3.0, 0.0],
                   [0.0, 0.0, 0.0, 1.0],
                   [0.0, -0.5, 30.0, 0.0]])
    Bc = np.array([[0.0], [2.0], [0.0], [5.0]])
    Ad, Bd = c2d(Ac, Bc, 0.05)
    return np.asarray(Ad), np.asarray(Bd)


def test_prediction_matrices_match_explicit_rollout():
    rng = np.random.default_rng(3)
    N, nx, nu = 6, 4, 2
    As = rng.normal(size=(N, nx, nx)) * 0.4 + np.eye(nx)
    Bs = rng.normal(size=(N, nx, nu))
    Sx, Su = prediction_matrices(jnp.array(As), jnp.array(Bs), N)
    x0 = rng.normal(size=nx)
    us = rng.normal(size=(N, nu))
    x = x0.copy()
    for k in range(N):
        x = As[k] @ x + Bs[k] @ us[k]
        pred = np.array(Sx[k]) @ x0 + sum(
            np.array(Su[k, j]) @ us[j] for j in range(k + 1))
        np.testing.assert_allclose(pred, x, rtol=1e-12, atol=1e-12)


def test_dense_boxqp_matches_scipy():
    rng = np.random.default_rng(7)
    n, B = 6, 5
    from scipy.optimize import minimize
    Hs, gs, sols = [], [], []
    for b in range(B):
        M = rng.normal(size=(n, n))
        H = M @ M.T + n * np.eye(n)
        g = rng.normal(size=n) * 3
        lb, ub = -0.3 * np.ones(n), 0.4 * np.ones(n)
        r = minimize(lambda v: 0.5 * v @ H @ v + g @ v, np.zeros(n),
                     jac=lambda v: H @ v + g, method="L-BFGS-B",
                     bounds=list(zip(lb, ub)),
                     options=dict(maxiter=2000, ftol=1e-16, gtol=1e-14))
        Hs.append(H); gs.append(g); sols.append(r.x)
    v = solve_dense_boxqp(jnp.array(Hs), jnp.array(gs),
                          jnp.full((B, n), -0.3), jnp.full((B, n), 0.4))
    assert np.abs(np.array(v) - np.array(sols)).max() < 1e-7
    # at least one bound active across the set, else the test is vacuous
    assert np.isclose(np.abs(np.array(sols)), 0.3).any() or \
        np.isclose(np.array(sols), 0.4).any()


def test_move_blocking_expands_constant_tail():
    Ad, Bd = _pendulum_lti()
    N, Ntu = 10, 3
    Q = np.diag([1.0, 0.0, 10.0, 0.0])
    R = 1e-3 * np.eye(1)
    data = condense(jnp.array(Ad), jnp.array(Bd), jnp.array(Q), jnp.array(R),
                    N, Ntu=Ntu, du_weight=0.1)
    x0 = jnp.array([0.2, 0.0, -0.1, 0.0])
    xref = jnp.zeros((N, 4))
    us, U = solve_condensed(data, x0, xref, u_prev=jnp.zeros(1),
                            u_lb=jnp.array([-5.0]), u_ub=jnp.array([5.0]))
    us = np.array(us)
    # first Ntu stages are the free moves; tail holds the last move exactly
    assert np.ptp(us[Ntu - 1:], axis=0).max() == 0.0
    assert np.abs(us).max() <= 5.0 + 1e-9
    # blocking matrix sanity
    T = np.array(blocking_matrix(N, Ntu))
    assert (T.sum(axis=1) == 1).all() and T[:Ntu].trace() == Ntu


def test_condensed_matches_ddp_on_pendulum_step():
    # same LQ problem solved by the condensed QP and by the batched DDP
    # solver (exact for LQ): controls must agree
    Ad, Bd = _pendulum_lti()
    N = 12
    Q = np.diag([1.0, 0.1, 10.0, 0.1])
    R = 0.01 * np.eye(1)
    ulim = 2.0

    data = condense(jnp.array(Ad), jnp.array(Bd), jnp.array(Q), jnp.array(R), N)
    B = 4
    rng = np.random.default_rng(11)
    x0s = jnp.array(rng.uniform(-0.3, 0.3, (B, 4)))
    xref = jnp.zeros((N, 4))
    us_qp, _ = solve_condensed(data, x0s, xref,
                               u_lb=jnp.array([-ulim]), u_ub=jnp.array([ulim]))

    Adj, Bdj, Qj, Rj = map(jnp.asarray, (Ad, Bd, Q, R))
    ocp = mv.OCP(dynamics=lambda x, u, p: Adj @ x + Bdj @ u,
                 stage_cost=lambda x, u, p: x @ Qj @ x + u @ Rj @ u,
                 N=N, nx=4, nu=1, npar=0,
                 control_bounds=mv.box_bounds(jnp.array([-ulim]),
                                              jnp.array([ulim])))
    from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver
    rd = jax.jit(make_batched_ilqr_solver(
        ocp, mv.ILQROptions(max_iters=40), backend="xla"))(
        x0s, None, jnp.zeros((B, N, 1)))
    assert bool(rd.converged.all())
    # NB stage-cost conventions: DDP cost counts x_0..x_{N-1} + terminal 0,
    # condensed counts x_1..x_N; for agreement, compare the *controls* of
    # the same optimization — they coincide when xref=0 and x0 cost is
    # control-independent (it is: stage 0 cost has no u coupling except R).
    # The condensed objective differs from DDP's by the (u-independent)
    # x_0 term and by the x_N term; to compare exactly, give DDP the
    # matching terminal cost and drop its x_0 advantage:
    ocp2 = mv.OCP(dynamics=lambda x, u, p: Adj @ x + Bdj @ u,
                  stage_cost=lambda x, u, p: x @ Qj @ x + u @ Rj @ u,
                  terminal_cost=lambda x, p: x @ Qj @ x,
                  N=N, nx=4, nu=1, npar=0,
                  control_bounds=mv.box_bounds(jnp.array([-ulim]),
                                               jnp.array([ulim])))
    rd2 = jax.jit(make_batched_ilqr_solver(
        ocp2, mv.ILQROptions(max_iters=40), backend="xla"))(
        x0s, None, jnp.zeros((B, N, 1)))
    assert bool(rd2.converged.all())
    # identical objective up to the constant x0'Qx0 -> identical argmin
    assert np.abs(np.array(us_qp) - np.array(rd2.us)).max() < 1e-6
    # bounds must be exercised
    assert np.isclose(np.abs(np.array(us_qp)), ulim, atol=1e-8).any()
