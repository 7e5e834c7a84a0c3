"""Multiple-shooting (lifted, infeasible-start) Gauss-Newton solver.

The reference's second transcription lifts the states into decision variables
with defect equality constraints (``Casadi/multiple_shooting_casadi.py:
128-178``): IPOPT may iterate through *infeasible* trajectories, which helps
on poor initial guesses, and ``difference.py`` checks that single- and
multiple-shooting answers agree.

The equivalent here: a feasibility-gap DDP (FDDP-style).  The state
trajectory is kept as an iterate that need not satisfy the dynamics; each
backward pass processes the defect (gap) ``d_k = F(x_k, u_k) - x_{k+1}``
through the value-function recursion, and the forward pass contracts the gaps
with the step length (gaps close as alpha -> 1).  Same exact box-QP stages as
the single-shooting solver; same convergence machinery.

Use via ``make_ms_solver(ocp, options)``; it accepts an (N+1, nx) state
trajectory guess in addition to controls — e.g. a straight-line interpolation
(the reference warm-starts lifted states the same way, :274-287).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ocp.spec import OCP
from ..ops.linearize import linearize_trajectory
from .ilqr import ILQROptions, ILQRResult, _stage_boxqp_with_gain


def make_ms_solver(ocp: OCP, options: ILQROptions = ILQROptions()):
    """Build ``solve(x0, params, us_init, xs_init) -> ILQRResult``.

    ``xs_init`` is an optional (N+1, nx) lifted-state guess; defaults to a
    constant-x0 trajectory (maximally infeasible, as the reference's
    ``repmat(state_init)`` initialization — multiple_shooting_casadi.py:217).
    """
    if ocp.has_state_bounds:
        raise NotImplementedError("state bounds: use make_ilqr_solver (AL)")

    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    F = ocp.dynamics
    l = ocp.stage_cost
    lf = ocp.terminal_cost or (lambda x, p: jnp.zeros((), dtype=x.dtype))

    if ocp.control_bounds is None:
        def cb(x, p, k):
            return jnp.full((nu,), -jnp.inf), jnp.full((nu,), jnp.inf)
    else:
        cb = ocp.control_bounds

    ks = jnp.arange(N)

    def total_cost(xs, us, ps):
        cs = jax.vmap(l)(xs[:N], us, ps[:N])
        return jnp.sum(cs) + lf(xs[N], ps[N])

    def gaps(xs, us, ps):
        nexts = jax.vmap(F)(xs[:N], us, ps[:N])
        return nexts - xs[1:]

    def backward(xs, us, ps, d, reg, ddp_scale):
        der = linearize_trajectory(F, l, xs[:N], us, ps[:N],
                                   second_order=opt.use_ddp)
        gN = jax.grad(lambda x: lf(x, ps[N]))(xs[N])
        HN = jax.jacfwd(jax.grad(lambda x: lf(x, ps[N])))(xs[N])
        lbs, ubs = jax.vmap(cb)(xs[:N], ps[:N], ks)
        dlb = lbs - us
        dub = ubs - us

        def stage(carry, inp):
            Vx, Vxx, dV1, dV2, gmax = carry
            if opt.use_ddp:
                fx, fu, lx, lu, lxx, luu, lux, fxx, fux, fuu, dk, lo, hi = inp
            else:
                fx, fu, lx, lu, lxx, luu, lux, dk, lo, hi = inp
            # gap-aware expansion: the next-state value gradient is evaluated
            # at the gap-shifted point (FDDP): Vx_eff = Vx + Vxx d_k
            Vx_eff = Vx + Vxx @ dk
            Qx = lx + fx.T @ Vx_eff
            Qu = lu + fu.T @ Vx_eff
            Qxx = lxx + fx.T @ Vxx @ fx
            Quu = luu + fu.T @ Vxx @ fu + reg * jnp.eye(nu, dtype=lu.dtype)
            Qux = lux + fu.T @ Vxx @ fx
            if opt.use_ddp:
                Qxx = Qxx + ddp_scale * jnp.einsum("i,ijk->jk", Vx_eff, fxx)
                Qux = Qux + ddp_scale * jnp.einsum("i,ijk->jk", Vx_eff, fux)
                Quu = Quu + ddp_scale * jnp.einsum("i,ijk->jk", Vx_eff, fuu)
            kff, K, free = _stage_boxqp_with_gain(
                Quu, Qu, Qux, lo, hi, opt.boxqp_tol)
            dV1 = dV1 + kff @ Qu
            dV2 = dV2 + 0.5 * kff @ Quu @ kff
            Vx_n = Qx + K.T @ Quu @ kff + K.T @ Qu + Qux.T @ kff
            Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            pg = -jnp.clip(-Qu, lo, hi)
            gmax = jnp.maximum(gmax, jnp.max(jnp.abs(pg)))
            return (Vx_n, 0.5 * (Vxx_n + Vxx_n.T), dV1, dV2, gmax), (kff, K)

        vz = jnp.sum(gN) * 0.0
        init = (gN, HN, vz, vz, vz)
        if opt.use_ddp:
            inputs = (der["fx"], der["fu"], der["lx"], der["lu"], der["lxx"],
                      der["luu"], der["lux"], der["fxx"], der["fux"],
                      der["fuu"], d, dlb, dub)
        else:
            inputs = (der["fx"], der["fu"], der["lx"], der["lu"], der["lxx"],
                      der["luu"], der["lux"], d, dlb, dub)
        (_, _, dV1, dV2, gmax), (kffs, Ks) = jax.lax.scan(
            stage, init, inputs, reverse=True)
        return kffs, Ks, dV1, dV2, gmax

    def forward(x0, xs, us, ps, d, kffs, Ks, alpha):
        """Gap-contracting rollout: the new trajectory closes a (1 - alpha)
        fraction of each defect (FDDP step)."""

        def step(x, inp):
            x_nom, u_nom, k_ff, K, p, dk, k = inp
            u = u_nom + alpha * k_ff + K @ (x - x_nom)
            lb, ub = cb(x, p, k)
            u = jnp.clip(u, lb, ub)
            c = l(x, u, p)
            x_next = F(x, u, p) - (1.0 - alpha) * dk
            return x_next, (x, u, c)

        xN, (xs_n, us_n, cs) = jax.lax.scan(
            step, x0, (xs[:N], us, kffs, Ks, ps[:N], d, ks))
        xs_n = jnp.concatenate([xs_n, xN[None]], axis=0)
        return xs_n, us_n, jnp.sum(cs) + lf(xN, ps[N])

    alphas = opt.alpha_decay ** jnp.arange(opt.n_alphas)

    def solve(x0, params=None, us_init=None, xs_init=None):
        dt_f = jnp.result_type(float)
        x0 = jnp.asarray(x0, dtype=dt_f)
        if params is None:
            ps = jnp.zeros((N + 1, max(ocp.npar, 1)), dtype=dt_f)
        else:
            ps = jnp.asarray(params, dtype=dt_f)
            if ps.ndim == 1:
                ps = jnp.broadcast_to(ps, (N + 1, ps.shape[0]))
        us = (jnp.zeros((N, nu), dtype=dt_f) if us_init is None
              else jnp.asarray(us_init, dtype=dt_f))
        xs = (jnp.broadcast_to(x0, (N + 1, nx)).astype(dt_f)
              if xs_init is None else jnp.asarray(xs_init, dtype=dt_f))
        xs = xs.at[0].set(x0)

        cost0 = total_cost(xs, us, ps)
        gap0 = jnp.max(jnp.abs(gaps(xs, us, ps)))

        def merit(c, g):
            # L-infinity defect penalty with its own weight option (not the
            # unrelated AL parameter)
            return c + opt.ms_merit_weight * g

        def cond(carry):
            xs, us, cost, gap, reg, it, done, gnorm, stall, fail, ddp_on = carry
            return jnp.logical_and(it < opt.max_iters, jnp.logical_not(done))

        def body(carry):
            xs, us, cost, gap, reg, it, done, gnorm, stall, fail, ddp_on = carry
            d = gaps(xs, us, ps)
            kffs, Ks, dV1, dV2, gmax = backward(
                xs, us, ps, d, reg, ddp_on.astype(cost.dtype))
            xs_c, us_c, costs_c = jax.vmap(
                lambda a: forward(x0, xs, us, ps, d, kffs, Ks, a))(alphas)
            # by construction of the gap-contracting rollout the candidate
            # defect is exactly (1 - alpha) * d — no dynamics re-evaluation
            gaps_c = (1.0 - alphas) * jnp.max(jnp.abs(d))
            merits = merit(costs_c, gaps_c)
            best = jnp.argmin(merits)
            cur_merit = merit(cost, gap)
            improved = merits[best] < cur_merit - 1e-12

            small_step = jnp.abs(cur_merit - merits[best]) < opt.tol_cost * (
                1.0 + jnp.abs(cur_merit))
            stall_n = jnp.where(improved, 0, stall + 1)
            stalled = stall_n >= opt.stall_iters
            # DDP -> Gauss-Newton fallback on stalled line search (see ilqr.py)
            ddp_off_now = (stalled & ddp_on
                           & (gmax > opt.tol_grad * opt.ddp_fallback_factor))
            ddp_on_n = ddp_on & ~ddp_off_now
            stall_n = jnp.where(ddp_off_now, 0, stall_n)
            feasible = gap < opt.ms_gap_tol
            new_fail = (((~improved) & (reg >= opt.reg_max) & ~ddp_off_now)
                        | ~jnp.isfinite(cur_merit))
            new_done = (
                (feasible & (gmax < opt.tol_grad))
                | (feasible & improved & small_step)
                | (stalled & ~ddp_off_now)
                | new_fail)

            keep = done
            xs_n = jnp.where(keep | ~improved, xs, xs_c[best])
            us_n = jnp.where(keep | ~improved, us, us_c[best])
            cost_n = jnp.where(keep | ~improved, cost, costs_c[best])
            gap_n = jnp.where(keep | ~improved, gap, gaps_c[best])
            reg_n = jnp.where(
                keep, reg,
                jnp.where(improved,
                          jnp.maximum(reg / opt.reg_down, opt.reg_min),
                          jnp.minimum(reg * opt.reg_up, opt.reg_max)))
            # fresh Gauss-Newton steps start from reg_init (see ilqr.py)
            reg_n = jnp.where(ddp_off_now & ~keep,
                              jnp.asarray(opt.reg_init, reg.dtype), reg_n)
            it_n = jnp.where(keep, it, it + 1)
            stall_out = jnp.where(keep, stall, stall_n)
            done_n = done | new_done
            fail_n = fail | jnp.where(keep, False, new_fail)
            gnorm_n = jnp.where(keep, gnorm, gmax)
            ddp_out = jnp.where(keep, ddp_on, ddp_on_n)
            return (xs_n, us_n, cost_n, gap_n, reg_n, it_n, done_n, gnorm_n,
                    stall_out, fail_n, ddp_out)

        vz = cost0 * 0.0
        viz = jnp.int32(0) + vz.astype(jnp.int32)
        carry0 = (xs, us, cost0, gap0,
                  jnp.asarray(opt.reg_init, dt_f) + vz, viz, vz > 1.0,
                  jnp.full((), jnp.inf, dt_f) + vz, viz, vz > 1.0,
                  (vz < 1.0) if opt.use_ddp else (vz > 1.0))
        (xs, us, cost, gap, reg, it, done, gnorm, _, fail,
         _) = jax.lax.while_loop(cond, body, carry0)
        # max_violation carries the dynamics-defect gap here (this solver
        # rejects state-bounded OCPs, so the field is otherwise unused)
        return ILQRResult(
            xs=xs, us=us, cost=cost, grad_norm=gnorm, iterations=it,
            converged=done & ~fail & (gap < 10 * opt.ms_gap_tol)
            & jnp.isfinite(cost),
            max_violation=gap)

    return solve
