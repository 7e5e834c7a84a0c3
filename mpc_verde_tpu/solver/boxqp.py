"""Exact stage-wise box-constrained QP.

Solves  min_v  0.5 v'Hv + g'v   s.t.  lb <= v <= ub   with H positive definite.

This is the control-bounds core that replaces IPOPT's interior-point handling
of the box constraints the reference places on every problem (v/omega bounds at
``Casadi/single_shooting_v1.py:134-139``, steering bounds + Du move-blocking at
``Inverted_pendulum/...mpctools.py:34-42`` and
``Trajectory Tracking/Trajectory_tracking_le_LTI.py:66-74``).

Design (batch-first): the control dimension is tiny (nu <= 2 in every reference
family), so instead of an iterative active-set/interior-point method we
*enumerate all 3^nu active-set patterns* (each coordinate free / at lower / at
upper), solve each candidate's masked KKT system with closed-form tiny-matrix
inverses, and select the feasible-and-stationary candidate with the lowest
objective.  This is exact (finds the global optimum of the strictly convex QP),
completely branch-free, and vectorizes over patterns x stages x batch with no
data-dependent control flow — the shape XLA wants.
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.smallmat import small_solve

_BIG = 1e30


def _patterns(nu: int) -> np.ndarray:
    """All active-set patterns: 0 = free, 1 = at lower, 2 = at upper."""
    return np.array(list(itertools.product([0, 1, 2], repeat=nu)), dtype=np.int32)


def _eval_pattern(pattern, H, g, lb, ub, tol):
    m = (pattern == 0).astype(H.dtype)           # free mask
    at_lo = (pattern == 1)
    at_up = (pattern == 2)
    c = jnp.where(at_lo, lb, jnp.where(at_up, ub, 0.0))
    # A pattern clamping at an infinite bound is invalid.
    valid = jnp.all(jnp.isfinite(jnp.where(m > 0, 0.0, c)))
    c = jnp.where(jnp.isfinite(c), c, 0.0)

    # Masked KKT: free rows of H, identity on clamped rows.
    A = m[:, None] * H * m[None, :] + jnp.diag(1.0 - m)
    b = -m * (g + H @ ((1.0 - m) * c))
    v_free = small_solve(A, b)
    v = m * v_free + (1.0 - m) * c

    grad = g + H @ v
    feas = jnp.all(jnp.where(m > 0, (v >= lb - tol) & (v <= ub + tol), True))
    stat = jnp.all(
        jnp.where(at_lo, grad >= -tol, True)
        & jnp.where(at_up, grad <= tol, True)
    )
    obj = 0.5 * v @ H @ v + g @ v
    obj = jnp.where(valid & feas & stat, obj, _BIG)
    return v, m, obj


def solve_boxqp(H, g, lb, ub, tol: float = 1e-8):
    """Exact solve of the box QP by active-set enumeration.

    Args:
      H: (nu, nu) positive-definite Hessian.
      g: (nu,) gradient.
      lb, ub: (nu,) bounds; +-inf allowed.
      tol: feasibility/stationarity tolerance.

    Returns:
      v: (nu,) optimizer.
      free_mask: (nu,) float mask of coordinates strictly inside the box
        (used to restrict the Riccati feedback gain to the free subspace).
    """
    nu = H.shape[-1]
    if nu > 4:
        raise NotImplementedError(
            "active-set enumeration is intended for nu <= 4; "
            "use a projected-Newton stage QP for larger control dimensions"
        )
    pats = jnp.asarray(_patterns(nu))
    vs, ms, objs = jax.vmap(lambda p: _eval_pattern(p, H, g, lb, ub, tol))(pats)
    best = jnp.argmin(objs)
    return vs[best], ms[best]
