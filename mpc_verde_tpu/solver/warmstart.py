"""One-shot LQR warm start: cut cold-start DDP iterations, not iteration cost.

The streaming headline is ``W / (passes x body)``; rounds 1-4 attacked the
body.  This module attacks the *passes* factor: a cold queue problem starting
from ``us = 0`` pays ~15 DDP iterations at N=40, most of them spent
discovering the gross shape of the solution.  A time-invariant LQR policy
about the target — one horizon-length Riccati recursion plus one clipped
rollout, together roughly the cost of ONE DDP iteration — lands the initial
guess close enough that the solver only refines (measured study in
docs/design.md "Warm-start study").

This is the batched analogue of what the reference gets from IPOPT
warm starts between receding-horizon steps (``Casadi/single_shooting_v1.py:
17-27`` shifts the previous solution); for the *first* solve of a problem the
reference has nothing — it eats the full cold IPOPT solve.  Here the cold
path itself gets a model-based initial guess, computed on-device inside the
same dispatch as the solve (no extra host round trip, and the cost is
included in every benchmark timing that uses it).

Design notes:

  * The policy linearizes the dynamics about per-stage reference points
    ``(xref_k, uref_k)`` extracted from the parameter tensor and solves the
    finite-horizon time-VARYING LQ problem backward (plain Riccati — no
    constraints; the rollout clips to the control box instead).
  * For nonholonomic models (the diff-drive family), the linearization about
    a stationary target is structurally uncontrollable in the lateral
    direction (``B`` has a zero row at v = 0), so ``uref`` accepts a nonzero
    "rolling" bias: linearizing about a small forward velocity restores
    stabilizability and the clipped rollout turns into a drive-toward-target
    maneuver.  This is a warm start, not a solution — feasibility is exact
    (the rollout IS the dynamics), optimality is the solver's job.
  * Everything is ``vmap``/``scan`` code: one backward scan of (nx+nu)-sized
    small-matrix ops and one forward rollout scan, both batched over the
    queue — adds ~1 iteration-equivalent of device work per problem.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ocp.spec import OCP
from ..ops.linearize import linearize_dynamics, quadratize_cost
from ..ops.smallmat import small_solve


def make_lqr_warm_start(ocp: OCP,
                        xref_fn: Optional[Callable] = None,
                        uref: Optional[np.ndarray] = None):
    """Build ``warm(x0s, params) -> us_init`` for a batch/queue of problems.

    Args:
      ocp: the problem; ``dynamics``/``stage_cost`` are linearized about the
        per-stage reference points.
      xref_fn: ``p_k -> xref`` extracting the stage-k state reference from
        that stage's parameter vector (e.g. ``lambda p: p[:3]`` for the
        diff-drive point-stabilization layout, where params hold the target,
        ``Casadi/single_shooting_v1.py:97-105`` semantics).  Defaults to
        zeros (regulation problems whose reference is the origin).
      uref: (nu,) control linearization point.  Defaults to zeros; pass a
        small forward velocity for nonholonomic models (see module
        docstring).  The ROLLOUT uses the LQR policy about this point,
        clipped to the control box; uref itself need not be feasible or
        optimal.

    Returns a jittable ``warm(x0s (B, nx), params (B, N+1, npar)) ->
    us_init (B, N, nu)`` whose output is dynamically feasible by
    construction and strictly inside the control box after clipping.
    """
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    F = ocp.dynamics
    lin = linearize_dynamics(F)
    quad = quadratize_cost(ocp.stage_cost)
    npar = max(ocp.npar, 1)
    u_ref = np.zeros((nu,), dtype=np.float64) if uref is None \
        else np.asarray(uref, dtype=np.float64)

    if xref_fn is None:
        def xref_fn(p):
            return jnp.zeros((nx,), dtype=p.dtype)

    if ocp.control_bounds is None:
        def cb(x, p, k):
            return np.full((nu,), -np.inf), np.full((nu,), np.inf)
    else:
        cb = ocp.control_bounds

    ks = np.arange(N, dtype=np.int32)

    def warm1(x0, ps):
        dt = x0.dtype
        ur = u_ref.astype(dt)
        xr = jax.vmap(xref_fn)(ps[:N, :npar])               # (N, nx)

        def stage_mats(x_r, p):
            fx, fu = lin(x_r, ur, p[:npar])
            lx, lu, lxx, luu, lux = quad(x_r, ur, p[:npar])
            return fx, fu, lx, lu, lxx, luu, lux

        fx, fu, lx, lu, lxx, luu, lux = jax.vmap(stage_mats)(xr, ps[:N])

        # LQ backward: affine Riccati about the reference trajectory.  A
        # fixed Tikhonov reg keeps Quu definite when the quadratized cost
        # is only semidefinite at the reference point.
        reg = np.asarray(1e-6, dt) * np.eye(nu, dtype=np.float64).astype(dt)
        vzero = jnp.zeros((nx,), dt)
        vzxx = jnp.zeros((nx, nx), dt)

        def bwd(carry, inp):
            Vx, Vxx = carry
            fx_k, fu_k, lx_k, lu_k, lxx_k, luu_k, lux_k = inp
            Qx = lx_k + fx_k.T @ Vx
            Qu = lu_k + fu_k.T @ Vx
            Qxx = lxx_k + fx_k.T @ Vxx @ fx_k
            Quu = luu_k + fu_k.T @ Vxx @ fu_k + reg
            Qux = lux_k + fu_k.T @ Vxx @ fx_k
            kff = -small_solve(Quu, Qu)
            K = -small_solve(Quu, Qux)
            Vx_n = Qx + K.T @ Quu @ kff + K.T @ Qu + Qux.T @ kff
            Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            return (Vx_n, 0.5 * (Vxx_n + Vxx_n.T)), (kff, K)

        (_, _), (kffs, Ks) = jax.lax.scan(
            bwd, (vzero, vzxx), (fx, fu, lx, lu, lxx, luu, lux),
            reverse=True)

        # clipped policy rollout (exact nonlinear dynamics)
        def fwd(x, inp):
            x_r, k_ff, K, p, k = inp
            u = ur + k_ff + K @ (x - x_r)
            lb, ub = cb(x, p[:npar], k)
            u = jnp.clip(u, lb, ub)
            return F(x, u, p[:npar]), u

        _, us = jax.lax.scan(fwd, x0, (xr, kffs, Ks, ps[:N], ks))
        return us

    return jax.vmap(warm1)
