"""Pure-numpy golden solvers for validating the JAX stack.

The reference validates by comparing methods against each other and against
IPOPT/MATLAB runs (SURVEY.md §4).  IPOPT is not available in this image, so
goldens are produced by scipy (L-BFGS-B / SLSQP) on the *same* direct
single-shooting transcription the reference uses
(``Casadi/single_shooting_v1.py:100-147``): decision variables = controls,
states eliminated by rollout.  Pure numpy dynamics keep the goldens fast.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize as so


def rk4_np(rhs, dt, M=1):
    h = dt / M

    def step(x, u):
        for _ in range(M):
            k1 = rhs(x, u)
            k2 = rhs(x + 0.5 * h * k1, u)
            k3 = rhs(x + 0.5 * h * k2, u)
            k4 = rhs(x + h * k3, u)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    return step


def single_shooting_golden(step, stage_cost, term_cost, x0, N, nu,
                           u_lb=None, u_ub=None, u0=None, params=None,
                           tol=1e-16, maxiter=5000):
    """Solve min over u_{0..N-1} of the rolled-out cost with scipy L-BFGS-B.

    ``stage_cost(x, u, k)`` and ``term_cost(x)`` are numpy callables;
    ``params`` is threaded through via k if needed by the caller's closures.
    Returns (us, cost).
    """
    x0 = np.asarray(x0, dtype=float)

    def full_cost(z):
        us = z.reshape(N, nu)
        x = x0.copy()
        c = 0.0
        for k in range(N):
            c += stage_cost(x, us[k], k)
            x = step(x, us[k])
        c += term_cost(x)
        return c

    if u_lb is None:
        bounds = None
    else:
        lb = np.broadcast_to(np.asarray(u_lb, dtype=float), (N, nu))
        ub = np.broadcast_to(np.asarray(u_ub, dtype=float), (N, nu))
        bounds = [(lo if np.isfinite(lo) else None, hi if np.isfinite(hi) else None)
                  for lo, hi in zip(lb.ravel(), ub.ravel())]

    z0 = np.zeros(N * nu) if u0 is None else np.asarray(u0).ravel()
    res = so.minimize(full_cost, z0, method="L-BFGS-B", bounds=bounds,
                      options={"maxiter": maxiter, "maxfun": 200000,
                               "ftol": tol, "gtol": 1e-12})
    return res.x.reshape(N, nu), res.fun


def single_shooting_golden_cs(step, stage_cost, term_cost, x0, N, nu,
                              u_lb, u_ub, u0, tol=1e-16, maxiter=5000):
    """``single_shooting_golden`` with an exact gradient.

    Finite differences leave a gradient error of ~eps * |cost| / h, which
    at a cost scale of 1e4 moves the optimum of a flat valley by more than
    1e-3 in the controls.  Here the gradient is taken by complex-step
    differentiation, Im f(z + i h e_j) / h, exact to round-off for the
    real-analytic costs of the reference problems.  ``step(x, u)``,
    ``stage_cost(x, u, k)`` and ``term_cost(x)`` take a leading batch axis
    and complex inputs; all N * nu perturbations roll out at once.
    """
    x0 = np.asarray(x0, dtype=float)
    n = N * nu
    h = 1e-30

    def rollout(Z):
        us = Z.reshape(-1, N, nu)
        x = np.broadcast_to(x0, (us.shape[0], x0.size)).astype(Z.dtype)
        c = 0.0
        for k in range(N):
            c = c + stage_cost(x, us[:, k], k)
            x = step(x, us[:, k])
        return c + term_cost(x)

    def cost_and_grad(z):
        Z = z[None, :] + 1j * h * np.eye(n)
        return rollout(z[None, :])[0], rollout(Z).imag / h

    lb = np.broadcast_to(np.asarray(u_lb, dtype=float), (N, nu)).ravel()
    ub = np.broadcast_to(np.asarray(u_ub, dtype=float), (N, nu)).ravel()
    res = so.minimize(cost_and_grad, np.asarray(u0, dtype=float).ravel(),
                      jac=True, method="L-BFGS-B",
                      bounds=list(zip(lb, ub)),
                      options={"maxiter": maxiter, "ftol": tol,
                               "gtol": 1e-12})
    return res.x.reshape(N, nu), res.fun
