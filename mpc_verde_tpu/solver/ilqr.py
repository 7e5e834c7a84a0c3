"""Box-constrained iLQR / DDP — the JAX replacement for CasADi+IPOPT.

The reference solves every MPC step as a sparse NLP through
``ca.nlpsol('solver','ipopt',...)`` (``Casadi/single_shooting_v1.py:131``) or
``mpc.nmpc(...).solve()`` (``Trajectory Tracking/Trajectory_tracking.py:72,107``)
— a C++ interior-point iteration per control step, one problem at a time.

Here the NLP is solved by iterated LQ approximation:

  * rollout + stage linearization (``jax.jacfwd``) under ``lax.scan``/``vmap``;
  * a Riccati backward pass whose stage subproblems are *exact* box QPs
    (active-set enumeration, ``boxqp.py``) with the feedback gain restricted
    to the free subspace (control-limited DDP);
  * a parallel line search: all step lengths are rolled out simultaneously
    under ``vmap`` and the best accepted — trading a handful of cheap fused
    rollouts for the serial backtracking a CPU solver would do;
  * Levenberg-style regularization on Quu adapted on rejection;
  * optional augmented-Lagrangian outer loop for state box constraints
    (the x/y bounds of ``Trajectory_tracking.py:63-67``).

Everything is shape-static with no data-dependent Python control flow, so one
``jax.jit`` covers the entire solve and ``jax.vmap`` batches thousands of
independent MPC instances per chip (the parallelism axis the reference's
serial sweep ``Phiref.py:24-28`` begs for).
"""
from __future__ import annotations

import dataclasses
from functools import partial, wraps
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ocp.spec import OCP
from ..ops.linearize import linearize_trajectory
from ..ops.smallmat import small_solve
from .boxqp import _eval_pattern, _patterns


@dataclasses.dataclass(frozen=True)
class ILQROptions:
    """Static solver configuration (hashable; closed over by the jitted solve)."""

    max_iters: int = 60
    tol_grad: float = 1e-7
    tol_cost: float = 1e-9
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e10
    # aggressive escalation: on an f32-noise-scale problem the DDP curvature
    # can need reg ~1e2 to turn definite; x100 per rejection reaches that
    # within a stall window instead of wasting iterations (measured: takes
    # batch convergence 0.89 -> 1.00 at N=40 f32 with no x64 regression)
    reg_up: float = 100.0
    reg_down: float = 8.0
    n_alphas: int = 12
    alpha_decay: float = 0.5
    # consecutive failed line searches before declaring numerical stationarity
    # (long enough for the reg escalation above to act first)
    stall_iters: int = 8
    # full DDP (second-order dynamics terms in the backward pass): quadratic
    # local convergence; cheap at the tiny state dims of this model zoo
    use_ddp: bool = True
    # a stalled DDP line search falls back to Gauss-Newton only when the
    # projected gradient is still large (> ddp_fallback_factor * tol_grad);
    # small-gradient stalls are numerical stationarity and terminate
    ddp_fallback_factor: float = 1e3
    # multiple-shooting (FDDP) solver: defect-gap feasibility threshold and
    # the L-infinity defect-penalty weight of its line-search merit
    ms_gap_tol: float = 1e-5
    ms_merit_weight: float = 10.0
    # batch quorum (batched solver only): stop iterating once this fraction
    # of the batch is done, marking the stragglers unconverged.  1.0 (default)
    # waits for every member; serving deployments that prefer bounded latency
    # over the last <1% of convergences can set e.g. 0.995.  Wall time of a
    # batched while_loop is set by its slowest member, so this directly caps
    # the straggler tail.
    quorum: float = 1.0
    # Augmented Lagrangian (state bounds); al_iters=0 disables.
    al_iters: int = 0
    al_mu0: float = 10.0
    al_mu_factor: float = 10.0
    boxqp_tol: float = 1e-8
    # lax.scan unroll factor for the rollout / line-search forward scans
    # (batched + streaming solvers).  Numerics are identical (same op
    # order); the GPU optimum is not measured.
    ls_unroll: int = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ILQRResult:
    xs: jnp.ndarray          # (N+1, nx) optimal state trajectory
    us: jnp.ndarray          # (N, nu) optimal controls
    cost: jnp.ndarray        # scalar final (unaugmented) cost
    grad_norm: jnp.ndarray   # projected-gradient norm at the last backward
                             # pass (one iterate behind the returned xs/us)
    iterations: jnp.ndarray  # total inner iterations, accumulated across
                             # AL rounds (and in-place restarts for the
                             # streaming solver) — same meaning in every
                             # sibling solver
    converged: jnp.ndarray   # bool: tolerance/stationarity reached with a
                             # finite cost (False on divergence/NaN/reg-max)
    max_violation: jnp.ndarray  # state-bound violation (0 if no bounds);
                             # the multiple-shooting solver stores its
                             # dynamics-defect gap here instead


def pin_precision(solve):
    """Trace ``solve`` under the highest matmul precision.

    Every dot traced inside — the user's dynamics and costs and the
    solver's own Riccati products — then runs in full f32 (or f64): on a GPU
    an unpinned f32 product may run in TF32 (about three decimal digits),
    far looser than the solvers' cost and gradient tolerances.
    """
    @wraps(solve)
    def pinned(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return solve(*args, **kwargs)

    return pinned


def _stage_boxqp_with_gain(Quu, Qu, Qux, lb, ub, tol):
    """Solve the stage box QP and the free-subspace feedback gain.

    Returns (k_ff, K, free_mask).  K rows for clamped coordinates are zero —
    clamped controls don't react to state perturbations (control-limited DDP).
    """
    pats = jnp.asarray(_patterns(Quu.shape[-1]))
    vs, ms, objs = jax.vmap(lambda p: _eval_pattern(p, Quu, Qu, lb, ub, tol))(pats)
    best = jnp.argmin(objs)
    k_ff = vs[best]
    m = ms[best]
    A = m[:, None] * Quu * m[None, :] + jnp.diag(1.0 - m)
    K = -small_solve(A, m[:, None] * Qux)
    return k_ff, K, m


def make_ilqr_solver(ocp: OCP, options: ILQROptions = ILQROptions()):
    """Build the jitted solve function for a fixed OCP structure.

    Returns ``solve(x0, params, us_init) -> ILQRResult`` where
      x0: (nx,) initial state,
      params: (N+1, npar) per-stage parameters (row N feeds the terminal
        cost), or None when npar == 0,
      us_init: (N, nu) warm-start controls (``mpc.saveguess`` analogue).

    The returned function is pure: ``jax.vmap`` it over a leading batch axis
    for many-scenario solves and ``jax.jit``/``shard_map`` it for deployment.
    """
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    F = ocp.dynamics
    l = ocp.stage_cost
    lf = ocp.terminal_cost or (lambda x, p: jnp.zeros((), dtype=x.dtype))

    if ocp.control_bounds is None:
        def cb(x, p, k):
            big = jnp.inf
            return np.full((nu,), -big), np.full((nu,), big)
    else:
        cb = ocp.control_bounds

    has_xb = ocp.has_state_bounds
    al_iters = opt.al_iters if has_xb else 0
    x_low, x_high = ocp.state_box() if has_xb else (None, None)

    def _xviol(x):
        """Signed state-box constraint values c(x) >= 0 means violated."""
        lo = jnp.where(jnp.isfinite(x_low), x_low - x, -jnp.inf)
        hi = jnp.where(jnp.isfinite(x_high), x - x_high, -jnp.inf)
        return jnp.concatenate([lo, hi])

    def _al_penalty(x, lam, mu):
        """PHR augmented-Lagrangian term for c(x) <= 0."""
        c = _xviol(x)
        c = jnp.where(jnp.isfinite(c), c, -1.0)  # inactive rows
        t = jnp.maximum(0.0, lam + mu * c)
        return (jnp.sum(t * t) - jnp.sum(lam * lam)) / (2.0 * mu)

    def stage_cost_aug(x, u, p, lam, mu):
        c = l(x, u, p)
        if has_xb:
            c = c + _al_penalty(x, lam, mu)
        return c

    def term_cost_aug(x, p, lam, mu):
        c = lf(x, p)
        if has_xb:
            c = c + _al_penalty(x, lam, mu)
        return c

    ks = np.arange(N, dtype=np.int32)

    def rollout(x0, us, ps, lam, mu):
        """Clamped rollout: controls clipped into their (state-dependent) box."""
        def step(x, inp):
            u_raw, p, lam_k, k = inp
            lb, ub = cb(x, p, k)
            u = jnp.clip(u_raw, lb, ub)
            c = stage_cost_aug(x, u, p, lam_k, mu)
            x_next = F(x, u, p)
            return x_next, (x, u, c)

        xN, (xs, us_c, cs) = jax.lax.scan(step, x0, (us, ps[:N], lam[:N], ks))
        xs = jnp.concatenate([xs, xN[None]], axis=0)
        cost = jnp.sum(cs) + term_cost_aug(xN, ps[N], lam[N], mu)
        return xs, us_c, cost

    def true_cost(xs, us, ps):
        cs = jax.vmap(l)(xs[:N], us, ps[:N])
        return jnp.sum(cs) + lf(xs[N], ps[N])

    def backward(xs, us, ps, lam, mu, reg, ddp_scale):
        d = linearize_trajectory(
            lambda x, u, p_l: F(x, u, p_l[0]),
            lambda x, u, p_l: stage_cost_aug(x, u, p_l[0], p_l[1], mu),
            xs[:N], us, (ps[:N], lam[:N]),
            second_order=opt.use_ddp,
        )
        # Terminal value function.
        gN = jax.grad(lambda x: term_cost_aug(x, ps[N], lam[N], mu))(xs[N])
        HN = jax.jacfwd(jax.grad(lambda x: term_cost_aug(x, ps[N], lam[N], mu)))(xs[N])

        lbs, ubs = jax.vmap(lambda x, p, k: cb(x, p, k))(xs[:N], ps[:N], ks)
        dlb = lbs - us
        dub = ubs - us

        def stage(carry, inp):
            Vx, Vxx, dV1, dV2, gmax = carry
            if opt.use_ddp:
                fx, fu, lx, lu, lxx, luu, lux, fxx, fux, fuu, lo, hi = inp
            else:
                fx, fu, lx, lu, lxx, luu, lux, lo, hi = inp
            Qx = lx + fx.T @ Vx
            Qu = lu + fu.T @ Vx
            Qxx = lxx + fx.T @ Vxx @ fx
            Quu = luu + fu.T @ Vxx @ fu + reg * np.eye(nu).astype(lu.dtype)
            Qux = lux + fu.T @ Vxx @ fx
            if opt.use_ddp:
                # Full DDP: contract the value gradient with the dynamics
                # Hessians (Tassa-style second-order terms).  ``ddp_scale``
                # (1.0 or 0.0, traced) lets the iteration loop fall back to
                # Gauss-Newton when DDP curvature turns indefinite at long
                # horizons and the line search stalls.
                Qxx = Qxx + ddp_scale * jnp.einsum("i,ijk->jk", Vx, fxx)
                Qux = Qux + ddp_scale * jnp.einsum("i,ijk->jk", Vx, fux)
                Quu = Quu + ddp_scale * jnp.einsum("i,ijk->jk", Vx, fuu)
            k_ff, K, free = _stage_boxqp_with_gain(Quu, Qu, Qux, lo, hi, opt.boxqp_tol)
            dV1 = dV1 + k_ff @ Qu
            dV2 = dV2 + 0.5 * k_ff @ Quu @ k_ff
            Vx_n = Qx + K.T @ Quu @ k_ff + K.T @ Qu + Qux.T @ k_ff
            Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            Vxx_n = 0.5 * (Vxx_n + Vxx_n.T)
            # Projected-gradient KKT residual at the *nominal* point: zero iff
            # u_nom is stationary w.r.t. its box.  (|Qu| restricted to the
            # step's free set is NOT a valid measure: a step clamped at the
            # box edge would mask a large gradient.)
            pg = -jnp.clip(-Qu, lo, hi)
            gmax = jnp.maximum(gmax, jnp.max(jnp.abs(pg)))
            return (Vx_n, Vxx_n, dV1, dV2, gmax), (k_ff, K)

        # Varying-zero: derived from traced data so the scan carry has
        # consistent device-varying type under shard_map (a literal
        # jnp.zeros(()) would be replicated and fail the carry type check).
        vz = jnp.sum(gN) * 0.0
        init = (gN, HN, vz, vz, vz)
        if opt.use_ddp:
            inputs = (d["fx"], d["fu"], d["lx"], d["lu"], d["lxx"], d["luu"],
                      d["lux"], d["fxx"], d["fux"], d["fuu"], dlb, dub)
        else:
            inputs = (d["fx"], d["fu"], d["lx"], d["lu"], d["lxx"], d["luu"],
                      d["lux"], dlb, dub)
        (_, _, dV1, dV2, gmax), (kffs, Ks) = jax.lax.scan(
            stage, init, inputs, reverse=True)
        return kffs, Ks, dV1, dV2, gmax

    def forward(x0, xs, us, ps, lam, mu, kffs, Ks, alpha):
        def step(x, inp):
            x_nom, u_nom, k_ff, K, p, lam_k, k = inp
            u = u_nom + alpha * k_ff + K @ (x - x_nom)
            lb, ub = cb(x, p, k)
            u = jnp.clip(u, lb, ub)
            c = stage_cost_aug(x, u, p, lam_k, mu)
            return F(x, u, p), (x, u, c)

        xN, (xs_n, us_n, cs) = jax.lax.scan(
            step, x0, (xs[:N], us, kffs, Ks, ps[:N], lam[:N], ks))
        xs_n = jnp.concatenate([xs_n, xN[None]], axis=0)
        cost = jnp.sum(cs) + term_cost_aug(xN, ps[N], lam[N], mu)
        return xs_n, us_n, cost

    alphas = np.asarray(opt.alpha_decay ** np.arange(opt.n_alphas),
                        dtype=jnp.result_type(float))

    def inner_solve(x0, ps, us_init, lam, mu):
        xs0, us0, cost0 = rollout(x0, us_init, ps, lam, mu)

        def cond(carry):
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
            return jnp.logical_and(it < opt.max_iters, jnp.logical_not(done))

        def body(carry):
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
            kffs, Ks, dV1, dV2, gmax = backward(
                xs, us, ps, lam, mu, reg, ddp_on.astype(cost.dtype))

            xs_c, us_c, costs_c = jax.vmap(
                lambda a: forward(x0, xs, us, ps, lam, mu, kffs, Ks, a)
            )(alphas)
            best = jnp.argmin(costs_c)
            new_cost = costs_c[best]
            improved = new_cost < cost - 1e-12

            small_step = jnp.abs(cost - new_cost) < opt.tol_cost * (1.0 + jnp.abs(cost))
            stall_n = jnp.where(improved, 0, stall + 1)
            stalled = stall_n >= opt.stall_iters
            # DDP fallback: a stalled line search with second-order terms on
            # and a still-large gradient means indefinite DDP curvature (long
            # horizons), not stationarity — drop to Gauss-Newton and keep
            # iterating.  Small-gradient stalls terminate as converged.
            ddp_off_now = (stalled & ddp_on
                           & (gmax > opt.tol_grad * opt.ddp_fallback_factor))
            ddp_on_n = ddp_on & ~ddp_off_now
            stall_n = jnp.where(ddp_off_now, 0, stall_n)
            # Failure: regularization exhausted without progress WHILE the
            # gradient is still large, or the cost became non-finite
            # (diverged rollout / NaN dynamics).  Terminates the loop but is
            # NOT counted as convergence.  The small-gradient guard matters
            # for warm starts that are already optimal: no candidate can
            # improve, and reg reaches reg_max in exactly stall_iters
            # rejections (1e-6 * 100^8 = 1e10), so without it the fail path
            # outraces the documented stall-as-stationarity termination.
            new_fail = (((~improved) & (reg >= opt.reg_max) & ~ddp_off_now
                         & (gmax > opt.tol_grad * opt.ddp_fallback_factor))
                        | ~jnp.isfinite(cost))
            new_done = (
                (gmax < opt.tol_grad)
                | (improved & small_step)
                # line search can't improve despite growing regularization:
                # stationary to working precision (the practical f32 stop)
                | (stalled & ~ddp_off_now)
                | new_fail
            )

            # Per-element freeze: under vmap a converged batch member must be
            # a no-op (otherwise its `done` can flip back off and the whole
            # batched while_loop runs to max_iters for everyone).
            keep = done
            xs_n = jnp.where(keep, xs, jnp.where(improved, xs_c[best], xs))
            us_n = jnp.where(keep, us, jnp.where(improved, us_c[best], us))
            cost_n = jnp.where(keep, cost, jnp.where(improved, new_cost, cost))
            reg_n = jnp.where(
                keep, reg,
                jnp.where(improved,
                          jnp.maximum(reg / opt.reg_down, opt.reg_min),
                          jnp.minimum(reg * opt.reg_up, opt.reg_max)))
            # the stall that triggered the fallback inflated reg; fresh
            # Gauss-Newton steps should not start over-damped
            reg_n = jnp.where(ddp_off_now & ~keep,
                              jnp.asarray(opt.reg_init, reg.dtype), reg_n)
            it_n = jnp.where(keep, it, it + 1)
            stall_out = jnp.where(keep, stall, stall_n)
            done_n = done | new_done
            fail_n = fail | jnp.where(keep, False, new_fail)
            gnorm_n = jnp.where(keep, gnorm, gmax)
            ddp_out = jnp.where(keep, ddp_on, ddp_on_n)
            return (xs_n, us_n, cost_n, reg_n, it_n, done_n, gnorm_n,
                    stall_out, fail_n, ddp_out)

        # Varying-zero keeps while_loop carry types consistent under shard_map.
        vz = cost0 * 0.0
        viz = jnp.int32(0) + vz.astype(jnp.int32)
        reg0 = jnp.asarray(opt.reg_init, dtype=cost0.dtype) + vz
        carry0 = (xs0, us0, cost0, reg0, viz,
                  vz > 1.0, jnp.full((), jnp.inf, cost0.dtype) + vz, viz,
                  vz > 1.0, (vz < 1.0) if opt.use_ddp else (vz > 1.0))
        xs, us, cost, reg, it, done, gnorm, _, fail, _ = jax.lax.while_loop(
            cond, body, carry0)
        ok = done & ~fail & jnp.isfinite(cost)
        return xs, us, cost, it, gnorm, ok

    def solve(x0, params=None, us_init=None):
        dt_f = jnp.result_type(float)
        x0 = jnp.asarray(x0, dtype=dt_f)
        if params is None:
            ps = np.zeros((N + 1, max(ocp.npar, 1)), dtype=dt_f)
        else:
            ps = jnp.asarray(params, dtype=dt_f)
            if ps.ndim == 1:
                ps = jnp.broadcast_to(ps, (N + 1, ps.shape[0]))
        if us_init is None:
            us_init = np.zeros((N, nu), dtype=dt_f)
        us_init = jnp.asarray(us_init, dtype=dt_f)

        nlam = 2 * nx
        vz0 = jnp.sum(x0) * 0.0  # varying-zero (see inner_solve)
        lam0 = np.zeros((N + 1, nlam), dtype=dt_f) + vz0
        mu0 = jnp.asarray(opt.al_mu0, dtype=dt_f) + vz0

        if al_iters == 0:
            xs, us, cost, it, gnorm, done = inner_solve(x0, ps, us_init, lam0, mu0)
            if has_xb:
                # state bounds with no AL rounds: only the fixed quadratic
                # penalty applied — report the true violation, don't claim 0
                cviol = jax.vmap(_xviol)(xs)
                viol = jnp.max(jnp.maximum(
                    0.0, jnp.where(jnp.isfinite(cviol), cviol, 0.0)))
            else:
                viol = jnp.zeros((), dtype=dt_f)
        else:
            def al_round(carry, _):
                us_c, lam, mu = carry
                xs, us_n, cost, it, gnorm, done = inner_solve(x0, ps, us_c, lam, mu)
                cvals = jax.vmap(_xviol)(xs)
                cvals = jnp.where(jnp.isfinite(cvals), cvals, -1.0)
                lam_n = jnp.maximum(0.0, lam + mu * cvals)
                return (us_n, lam_n, mu * opt.al_mu_factor), (xs, cost, it, gnorm, done)

            (us, lam, mu), (xss, costs, its, gnorms, dones) = jax.lax.scan(
                al_round, (us_init, lam0, mu0), None, length=al_iters)
            xs = xss[-1]
            # iterations accumulate across AL rounds (ILQRResult contract)
            cost, it, gnorm, done = (costs[-1], jnp.sum(its, axis=0),
                                     gnorms[-1], dones[-1])
            cviol = jax.vmap(_xviol)(xs)
            viol = jnp.max(jnp.maximum(0.0, jnp.where(jnp.isfinite(cviol), cviol, 0.0)))

        final_cost = true_cost(xs, us, ps)
        converged = done
        return ILQRResult(
            xs=xs, us=us, cost=final_cost, grad_norm=gnorm,
            iterations=it, converged=converged, max_violation=viol,
        )

    return pin_precision(solve)
