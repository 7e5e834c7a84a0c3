"""Batch-first box-DDP solver with a one-launch Riccati backward.

``make_ilqr_solver`` + ``jax.vmap`` is semantically perfect but leaves the
backward pass as N sequential XLA scan steps of tiny ops.  This module is
the batch-major variant: one solver instance owns the whole batch, the
forward/rollout/linearization stay as fused vmapped XLA, and on a GPU the
backward pass runs as the single-launch Pallas kernel
(``ops/pallas/riccati.py``) with one problem per thread.

Restrictions vs the per-problem solver: nu <= 4 on the kernel (3^nu static
active-set enumeration; ``backend="xla"`` handles any nu).  State box bounds
run the augmented-Lagrangian fast path (see ``_augment_ocp_al``), so every
reference family fits.

The iteration-body pieces (rollout / line search / backward / acceptance
logic) are factored out so the streaming refill solver
(``solver/streaming.py``) reuses them verbatim — both solvers run the exact
same per-iteration math; they differ only in what happens to finished batch
members.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ocp.spec import OCP
from ..ops.linearize import linearize_trajectory
from ..utils.platform import KERNEL_BACKEND, resolve_backend
from .ilqr import ILQROptions, ILQRResult, pin_precision


@dataclasses.dataclass
class _Parts:
    """Jittable building blocks of one batched DDP iteration."""

    rollout: callable      # (x0s, us, ps) -> xs, us_clipped, cost
    derivs: callable       # (xs, us, ps) -> d, gN, HN, dlb, dub
    backward: callable     # (d, gN, HN, dlb, dub, reg, ddp) -> kffs, Ks, dV1, dV2, gmax
    linesearch: callable   # (x0s, xs, us, ps, kffs, Ks) -> xs_b, us_b, new_cost


def _make_parts(ocp: OCP, opt: ILQROptions, backend: str,
                linesearch: str, interpret: bool = False) -> _Parts:
    """``backend`` is a resolved name (``utils.platform.resolve_backend``);
    ``interpret`` runs the kernel in the Pallas interpreter."""
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    F = ocp.dynamics
    l = ocp.stage_cost
    lf = ocp.terminal_cost or (lambda x, p: jnp.zeros((), dtype=x.dtype))

    if ocp.control_bounds is None:
        def cb(x, p, k):
            return np.full((nu,), -np.inf), np.full((nu,), np.inf)
    else:
        cb = ocp.control_bounds

    ks = np.arange(N, dtype=np.int32)

    def rollout1(x0, us, ps):
        def step(x, inp):
            u_raw, p, k = inp
            lb, ub = cb(x, p, k)
            u = jnp.clip(u_raw, lb, ub)
            c = l(x, u, p)
            return F(x, u, p), (x, u, c)

        xN, (xs, us_c, cs) = jax.lax.scan(step, x0, (us, ps[:N], ks),
                                          unroll=opt.ls_unroll)
        xs = jnp.concatenate([xs, xN[None]], axis=0)
        return xs, us_c, jnp.sum(cs) + lf(xN, ps[N])

    def forward1(x0, xs, us, ps, kffs, Ks, alpha):
        def step(x, inp):
            x_nom, u_nom, k_ff, K, p, k = inp
            u = u_nom + alpha * k_ff + K @ (x - x_nom)
            lb, ub = cb(x, p, k)
            u = jnp.clip(u, lb, ub)
            c = l(x, u, p)
            return F(x, u, p), (x, u, c)

        xN, (xs_n, us_n, cs) = jax.lax.scan(
            step, x0, (xs[:N], us, kffs, Ks, ps[:N], ks),
            unroll=opt.ls_unroll)
        xs_n = jnp.concatenate([xs_n, xN[None]], axis=0)
        return xs_n, us_n, jnp.sum(cs) + lf(xN, ps[N])

    def fwd_cost1(x0, xs, us, ps, kffs, Ks, alpha):
        """Cost of the alpha-step rollout without materializing it.

        Per-stage costs are scan *outputs* reduced by ``jnp.sum`` — the same
        pairwise summation as the materializing path — so line-search
        decisions agree across the two modes up to compile-level rounding.
        """
        def step(x, inp):
            x_nom, u_nom, k_ff, K, p, k = inp
            u = u_nom + alpha * k_ff + K @ (x - x_nom)
            lb, ub = cb(x, p, k)
            u = jnp.clip(u, lb, ub)
            return F(x, u, p), l(x, u, p)

        xN, cs = jax.lax.scan(
            step, x0, (xs[:N], us, kffs, Ks, ps[:N], ks),
            unroll=opt.ls_unroll)
        return jnp.sum(cs) + lf(xN, ps[N])

    def derivs1(xs, us, ps):
        d = linearize_trajectory(F, l, xs[:N], us, ps[:N],
                                 second_order=opt.use_ddp)
        gN = jax.grad(lambda x: lf(x, ps[N]))(xs[N])
        HN = jax.jacfwd(jax.grad(lambda x: lf(x, ps[N])))(xs[N])
        lbs, ubs = jax.vmap(cb)(xs[:N], ps[:N], ks)
        return d, gN, HN, lbs - us, ubs - us

    rollout = jax.vmap(rollout1)
    forward = jax.vmap(forward1, in_axes=(0, 0, 0, 0, 0, 0, None))
    # winner re-roll: per-problem step length (batch axis on alpha too)
    forward_ba = jax.vmap(forward1)
    # cost-only sweep -> (B, A); alpha rides the inner vmap so the scan
    # reads (B, ...) inputs once and broadcasts across alpha in-register
    fwd_costs = jax.vmap(
        jax.vmap(fwd_cost1, in_axes=(None,) * 6 + (0,)),
        in_axes=(0, 0, 0, 0, 0, 0, None))
    # Keep alpha as a broadcast axis, never a physical one: flattening the
    # sweep into one vmap over (B*A,) broadcast-materialized inputs reads
    # ~A x more device memory per scan step.
    derivs = jax.vmap(derivs1)
    alphas = np.asarray(opt.alpha_decay ** np.arange(opt.n_alphas),
                        dtype=jnp.result_type(float))

    if linesearch not in ("costonly", "materialize"):
        raise ValueError(f"unknown linesearch mode {linesearch!r}")
    if linesearch == "costonly":
        def ls(x0s, xs, us, ps, kffs, Ks):
            # sweep all alphas materialization-free, re-roll the winner
            costs_c = fwd_costs(x0s, xs, us, ps, kffs, Ks, alphas)  # (B,A)
            best = jnp.argmin(costs_c, axis=1)                     # (B,)
            return forward_ba(x0s, xs, us, ps, kffs, Ks,
                              jnp.take(jnp.asarray(alphas), best))
    else:
        def ls(x0s, xs, us, ps, kffs, Ks):
            B = x0s.shape[0]
            xs_c, us_c, costs_c = jax.vmap(
                lambda a: forward(x0s, xs, us, ps, kffs, Ks, a))(alphas)
            best = jnp.argmin(costs_c, axis=0)                     # (B,)
            bi = np.arange(B)
            new_cost = costs_c[best, bi]
            return xs_c[best, bi], us_c[best, bi], new_cost

    if backend == KERNEL_BACKEND:
        from ..ops.pallas.riccati import riccati_backward_pallas

        def backward(d, gN, HN, dlb, dub, reg, ddp_scale):
            return riccati_backward_pallas(
                d, dlb, dub, gN, HN, reg, ddp_scale, nx=nx, nu=nu,
                use_ddp=opt.use_ddp, tol=opt.boxqp_tol, interpret=interpret)
    elif backend == "scan":
        # associative-scan (parallel-in-N) backward: O(log N) sequential
        # depth instead of N scan steps — the long-horizon mode (SURVEY.md
        # §2.4/§5.7).  Gauss-Newton LQ subproblem only: no exact stage box
        # QPs (the solver's forward pass still clips, and AL/IPM outer
        # loops compose for constrained problems) and no second-order
        # dynamics terms (the Vx·fxx recursion is inherently sequential).
        from ..ops.parallel_riccati import lq_backward_parallel

        if ocp.control_bounds is not None:
            raise NotImplementedError(
                "backend='scan' solves the unbounded LQ subproblem; use "
                "the kernel or xla for exact control boxes, or compose bounds "
                "via the IPM/AL outer loops")

        def backward1(d, gN, HN, dlb, dub, reg, ddp_scale):
            return lq_backward_parallel(
                d["fx"], d["fu"], d["lx"], d["lu"], d["lxx"], d["luu"],
                d["lux"], gN, HN, reg)

        backward = jax.vmap(backward1)
    else:
        from .ilqr import _stage_boxqp_with_gain
        from ..ops.smallmat import small_solve

        # Unbounded controls (e.g. the barrier solver's subproblems): skip
        # the 3^nu active-set enumeration — the stage QP is a pure Newton
        # step, valid for ANY nu.
        unbounded = ocp.control_bounds is None

        def backward1(d, gN, HN, dlb, dub, reg, ddp_scale):
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
                    Qxx = Qxx + ddp_scale * jnp.einsum("i,ijk->jk", Vx, fxx)
                    Qux = Qux + ddp_scale * jnp.einsum("i,ijk->jk", Vx, fux)
                    Quu = Quu + ddp_scale * jnp.einsum("i,ijk->jk", Vx, fuu)
                if unbounded:
                    kff = -small_solve(Quu, Qu)
                    K = -small_solve(Quu, Qux)
                    pg = Qu
                else:
                    kff, K, free = _stage_boxqp_with_gain(
                        Quu, Qu, Qux, lo, hi, opt.boxqp_tol)
                    pg = -jnp.clip(-Qu, lo, hi)
                dV1 = dV1 + kff @ Qu
                dV2 = dV2 + 0.5 * kff @ Quu @ kff
                Vx_n = Qx + K.T @ Quu @ kff + K.T @ Qu + Qux.T @ kff
                Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
                gmax = jnp.maximum(gmax, jnp.max(jnp.abs(pg)))
                return (Vx_n, 0.5 * (Vxx_n + Vxx_n.T), dV1, dV2, gmax), (kff, K)

            # varying-zero derived from the stage derivatives, not gN: with a
            # zero terminal cost gN/HN are literal zeros, which shard_map
            # types as replicated and rejects as a scan carry (the stage
            # outputs are device-varying)
            vz = jnp.sum(d["lx"]) * 0.0
            init = (gN + vz, HN + vz, vz, vz, vz)
            if opt.use_ddp:
                inputs = (d["fx"], d["fu"], d["lx"], d["lu"], d["lxx"],
                          d["luu"], d["lux"], d["fxx"], d["fux"], d["fuu"],
                          dlb, dub)
            else:
                inputs = (d["fx"], d["fu"], d["lx"], d["lu"], d["lxx"],
                          d["luu"], d["lux"], dlb, dub)
            (_, _, dV1, dV2, gmax), (kffs, Ks) = jax.lax.scan(
                stage, init, inputs, reverse=True)
            return kffs, Ks, dV1, dV2, gmax

        backward = jax.vmap(backward1)

    return _Parts(rollout=rollout, derivs=derivs, backward=backward,
                  linesearch=ls)


def _al_cvals(ocp: OCP):
    """Signed state-box constraint values; c(x) > 0 means violated."""
    x_low, x_high = ocp.state_box()

    def cvals(x):
        lo = jnp.where(jnp.isfinite(x_low), x_low - x, -jnp.inf)
        hi = jnp.where(jnp.isfinite(x_high), x - x_high, -jnp.inf)
        return jnp.concatenate([lo, hi])

    return cvals


def _augment_ocp_al(ocp: OCP) -> OCP:
    """Rewrite a state-bounded OCP so AL multipliers ride the param tensor.

    The augmented problem has ``npar_aug = npar + 2*nx + 1`` per-stage
    parameters laid out ``[p, lam (2*nx), mu]`` and NO state bounds; its
    stage/terminal costs add the PHR augmented-Lagrangian penalty of
    ``solver/ilqr.py`` (same semantics, same multiplier update).  Because the
    multipliers are *data*, every fast-path part — the vmapped XLA pieces and
    the Riccati kernel — works on the augmented problem unchanged; the AL
    outer loop just rewrites the lam/mu columns between inner solves.
    """
    npar = max(ocp.npar, 1)
    nlam = 2 * ocp.nx
    cvals = _al_cvals(ocp)
    l = ocp.stage_cost
    lf = ocp.terminal_cost or (lambda x, p: jnp.zeros((), dtype=x.dtype))
    F = ocp.dynamics
    cb = ocp.control_bounds

    def penalty(x, lam, mu):
        c = cvals(x)
        c = jnp.where(jnp.isfinite(c), c, -1.0)  # inactive rows
        t = jnp.maximum(0.0, lam + mu * c)
        return (jnp.sum(t * t) - jnp.sum(lam * lam)) / (2.0 * mu)

    def sc(x, u, p):
        return l(x, u, p[:npar]) + penalty(x, p[npar:npar + nlam], p[-1])

    def tc(x, p):
        return lf(x, p[:npar]) + penalty(x, p[npar:npar + nlam], p[-1])

    def dyn(x, u, p):
        return F(x, u, p[:npar])

    cb_aug = None if cb is None else (lambda x, p, k: cb(x, p[:npar], k))
    return dataclasses.replace(
        ocp, dynamics=dyn, stage_cost=sc, terminal_cost=tc,
        control_bounds=cb_aug, npar=npar + nlam + 1, x_lb=None, x_ub=None)


def _broadcast_params(ocp: OCP, ps, B, dt_f):
    """Normalize a params argument to (B, N+1, npar)."""
    N = ocp.N
    if ps is None:
        return jnp.asarray(np.zeros((B, N + 1, max(ocp.npar, 1)), dtype=dt_f))
    ps = jnp.asarray(ps, dtype=dt_f)
    # broadcast conveniences, matching the sibling solvers: (npar,) shared
    # across stages+batch, or (N+1, npar) shared across batch
    if ps.ndim == 1:
        ps = jnp.broadcast_to(ps, (B, N + 1, ps.shape[0]))
    elif ps.ndim == 2:
        ps = jnp.broadcast_to(ps[None], (B,) + ps.shape)
    return ps


def _accept_and_update(opt: ILQROptions, carry, gmax, xs_b, us_b, new_cost,
                       fresh=None, tol_scale=None):
    """Shared per-iteration acceptance / convergence / freeze logic.

    ``carry`` is the 10-tuple (xs, us, cost, reg, it, done, gnorm, stall,
    fail, ddp_on), every leaf with a leading batch axis.  ``fresh`` (optional
    bool (B,)) marks streaming-solver slots whose "line search" this
    iteration was really the initial rollout of a just-loaded problem: they
    accept unconditionally and are exempt from convergence judgments.
    ``tol_scale`` (optional (B,) >= 1) loosens the convergence tolerances
    per batch member — runtime data, so continuation solvers (the streaming
    IPM) can solve early subproblems inexactly, IPOPT-style, without a
    recompile.  1.0 (or None) is the exact strict test.
    """
    xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
    B = cost.shape[0]
    improved = new_cost < cost - 1e-12

    tsc = 1.0 if tol_scale is None else tol_scale
    small_step = (jnp.abs(cost - new_cost)
                  < tsc * opt.tol_cost * (1.0 + jnp.abs(cost)))
    stall_n = jnp.where(improved, 0, stall + 1)
    stalled = stall_n >= opt.stall_iters
    # DDP -> Gauss-Newton fallback on stalled line search (see ilqr.py)
    ddp_off_now = (stalled & ddp_on
                   & (gmax > tsc * opt.tol_grad * opt.ddp_fallback_factor))
    ddp_on_n = ddp_on & ~ddp_off_now
    stall_n = jnp.where(ddp_off_now, 0, stall_n)
    # reg exhaustion is a FAILURE only while the gradient is still large;
    # with a small gradient it is numerical stationarity (same threshold as
    # the stall path) — critical for already-optimal warm starts, where no
    # candidate can improve and reg hits reg_max in exactly stall_iters
    # rejections, outracing the graceful stall termination (see ilqr.py)
    new_fail = (((~improved) & (reg >= opt.reg_max) & ~ddp_off_now
                 & (gmax > tsc * opt.tol_grad * opt.ddp_fallback_factor))
                | ~jnp.isfinite(cost))
    new_done = ((gmax < tsc * opt.tol_grad)
                | (improved & small_step)
                | (stalled & ~ddp_off_now)
                | new_fail)
    if fresh is not None:
        # a freshly refilled slot's first pass is its initial rollout:
        # always accept it, never judge convergence on stale-derivative gmax
        improved = improved | fresh
        new_done = new_done & ~fresh
        new_fail = new_fail & ~fresh

    keep = done
    sel = lambda old, new: jnp.where(
        keep.reshape((B,) + (1,) * (old.ndim - 1)), old, new)
    imp = improved.reshape((B,) + (1,) * (xs.ndim - 1))
    xs_n = sel(xs, jnp.where(imp, xs_b, xs))
    imp_u = improved.reshape((B,) + (1,) * (us.ndim - 1))
    us_n = sel(us, jnp.where(imp_u, us_b, us))
    cost_n = sel(cost, jnp.where(improved, new_cost, cost))
    reg_n = sel(reg, jnp.where(
        improved,
        jnp.maximum(reg / opt.reg_down, opt.reg_min),
        jnp.minimum(reg * opt.reg_up, opt.reg_max)))
    # fresh Gauss-Newton steps start from reg_init (see ilqr.py)
    reg_n = jnp.where(ddp_off_now & ~keep,
                      np.asarray(opt.reg_init, reg.dtype), reg_n)
    if fresh is not None:
        reg_n = jnp.where(fresh, np.asarray(opt.reg_init, reg.dtype), reg_n)
    it_n = jnp.where(keep, it, it + 1)
    stall_out = jnp.where(keep, stall, stall_n)
    done_n = done | new_done
    fail_n = fail | jnp.where(keep, False, new_fail)
    gnorm_n = jnp.where(keep, gnorm, gmax)
    ddp_out = jnp.where(keep, ddp_on, ddp_on_n)
    return (xs_n, us_n, cost_n, reg_n, it_n, done_n, gnorm_n,
            stall_out, fail_n, ddp_out)


def make_batched_ilqr_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                             backend: str | None = None,
                             linesearch: str = "materialize",
                             interpret: bool = False):
    """Build ``solve(x0s, params, us_init) -> ILQRResult`` over a batch.

    Args have a leading batch axis: x0s (B, nx), params (B, N+1, npar),
    us_init (B, N, nu).  ``backend`` selects the Riccati backward:
      * None (default) — chosen from the platform
                      (``utils.platform.resolve_backend``): the kernel on a
                      GPU for nu <= 2, "xla" otherwise.
      * "triton"    — the one-launch Pallas kernel (``ops/pallas/riccati.py``);
                      GPU only, nu <= 4.  ``interpret=True`` runs it in the
                      Pallas interpreter instead (tests).
      * "xla"       — vmapped XLA scan (any nu, any platform);
      * "scan"      — associative-scan parallel-in-N backward (O(log N)
                      depth; Gauss-Newton, unbounded controls — the
                      long-horizon *method* analogue).

    ``linesearch`` selects the line-search strategy:
      * "materialize" (default) — roll out and materialize every alpha
        candidate, then gather the argmin trajectory.  One N-step scan
        chain per iteration.
      * "costonly" — sweep all alphas with a cost-only scan, then re-roll
        only the winning alpha.  Writes ~A x fewer bytes but adds a second
        sequential scan chain.

    State box bounds (``ocp.x_lb``/``x_ub``) run the same augmented-
    Lagrangian outer loop as ``make_ilqr_solver`` (``options.al_iters``
    PHR rounds), with the multipliers flowing through the per-stage param
    tensor so every inner round is the unmodified fast path (the kernel
    included); see ``_augment_ocp_al``.  Every dot is traced at the highest
    matmul precision (``ilqr.pin_precision``).
    """
    backend = resolve_backend(backend, ocp.nu, interpret=interpret)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    if backend == "scan" and opt.use_ddp:
        # the parallel-scan backward is Gauss-Newton by construction (the
        # Vx·fxx second-order recursion is sequential); don't pay for
        # second-order derivative tensors it can't consume
        opt = dataclasses.replace(opt, use_ddp=False)
    has_xb = ocp.has_state_bounds
    al_iters = opt.al_iters if has_xb else 0
    if has_xb and al_iters == 0:
        raise ValueError(
            "batched solver with state bounds needs options.al_iters >= 1")
    ocp_in = ocp
    if has_xb:
        cvals = _al_cvals(ocp)
        ocp = _augment_ocp_al(ocp)
        nlam = 2 * nx
    parts = _make_parts(ocp, opt, backend, linesearch, interpret)

    def _inner(x0s, ps, us_init):
        """One full batched DDP solve at fixed multipliers (the round-1 loop)."""
        xs0, us0, cost0 = parts.rollout(x0s, us_init, ps)

        def cond(carry):
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
            running = jnp.any(jnp.logical_and(it < opt.max_iters,
                                              jnp.logical_not(done)))
            if opt.quorum >= 1.0:
                return running
            # quorum exit: the batch stops once `quorum` of it is done; the
            # running stragglers surface as converged=False in the result
            return jnp.logical_and(running, done.mean() < opt.quorum)

        def body(carry):
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
            d, gN, HN, dlb, dub = parts.derivs(xs, us, ps)
            kffs, Ks, dV1, dV2, gmax = parts.backward(
                d, gN, HN, dlb, dub, reg, ddp_on.astype(cost.dtype))
            xs_b, us_b, new_cost = parts.linesearch(x0s, xs, us, ps, kffs, Ks)
            return _accept_and_update(opt, carry, gmax, xs_b, us_b, new_cost)

        B_ = x0s.shape[0]
        dt_f = cost0.dtype
        reg0 = np.full((B_,), opt.reg_init, dtype=dt_f)
        carry0 = (xs0, us0, cost0, reg0,
                  np.zeros((B_,), np.int32),
                  np.zeros((B_,), bool),
                  np.full((B_,), np.inf, dt_f),
                  np.zeros((B_,), np.int32),
                  np.zeros((B_,), bool),
                  jnp.asarray(np.full((B_,), bool(opt.use_ddp))))
        xs, us, cost, reg, it, done, gnorm, _, fail, _ = jax.lax.while_loop(
            cond, body, carry0)
        return xs, us, cost, it, gnorm, done, fail

    def solve(x0s, params=None, us_init=None):
        dt_f = jnp.result_type(float)
        x0s = jnp.asarray(x0s, dtype=dt_f)
        B = x0s.shape[0]
        ps = _broadcast_params(ocp_in, params, B, dt_f)
        if us_init is None:
            us_init = np.zeros((B, N, nu), dtype=dt_f)
        us_init = jnp.asarray(us_init, dtype=dt_f)

        if not has_xb:
            xs, us, cost, it, gnorm, done, fail = _inner(x0s, ps, us_init)
            return ILQRResult(
                xs=xs, us=us, cost=cost, grad_norm=gnorm, iterations=it,
                converged=done & ~fail & jnp.isfinite(cost),
                max_violation=np.zeros((B,), dt_f))

        l, lf = ocp_in.stage_cost, ocp_in.terminal_cost
        lfv = lf or (lambda x, p: jnp.zeros((), dtype=x.dtype))

        def al_round(carry, _):
            us_c, lam, mu = carry
            ps_aug = jnp.concatenate(
                [ps, lam, jnp.broadcast_to(mu[:, None, None], (B, N + 1, 1))],
                axis=-1)
            xs, us_n, cost, it, gnorm, done, fail = _inner(x0s, ps_aug, us_c)
            c = jax.vmap(jax.vmap(cvals))(xs)           # (B, N+1, 2nx)
            c = jnp.where(jnp.isfinite(c), c, -1.0)
            lam_n = jnp.maximum(0.0, lam + mu[:, None, None] * c)
            ok = done & ~fail & jnp.isfinite(cost)
            return (us_n, lam_n, mu * opt.al_mu_factor), (xs, it, gnorm, ok)

        vz = jnp.sum(x0s) * 0.0
        lam0 = np.zeros((B, N + 1, 2 * nx), dtype=dt_f) + vz
        mu0 = np.full((B,), opt.al_mu0, dtype=dt_f) + vz
        (us, _, _), (xss, its, gnorms, oks) = jax.lax.scan(
            al_round, (us_init, lam0, mu0), None, length=al_iters)
        xs = xss[-1]

        def traj_cost(xs_1, us_1, ps_1):
            cs = jax.vmap(l)(xs_1[:N], us_1, ps_1[:N])
            return jnp.sum(cs) + lfv(xs_1[N], ps_1[N])

        cost = jax.vmap(traj_cost)(xs, us, ps)
        cv = jax.vmap(jax.vmap(cvals))(xs)
        viol = jnp.max(jnp.maximum(
            0.0, jnp.where(jnp.isfinite(cv), cv, 0.0)), axis=(1, 2))
        return ILQRResult(
            xs=xs, us=us, cost=cost, grad_norm=gnorms[-1],
            iterations=jnp.sum(its, axis=0),  # total across AL rounds
            converged=oks[-1], max_violation=viol)

    return pin_precision(solve)


def make_drained_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                        backend: str | None = None, quorum: float = 0.99,
                        drain_capacity: int = 256,
                        drain_max_iters: int | None = None):
    """Two-phase batched solve: quorum exit + straggler drain.

    SUPERSEDED for serving: the streaming solver with in-place restarts
    (``solver.streaming.make_streaming_solver(..., restarts=...)``) reaches
    100% convergence with zero extra host round-trips (docs/design.md).
    Kept as the fixed-batch ablation and for latency-bounded
    single-dispatch use where a queue does not fit.

    A batched ``while_loop``'s wall time is set by its *slowest* member: with
    ~1% of a 4096-problem batch crawling to ``max_iters``, the other 99%
    (done by the p99 iteration count) sit frozen while every loop iteration
    still pays full-batch rollout/linearization/Riccati cost.  This wrapper
    recovers that tail without giving up strict convergence semantics:

      phase 1 — the main batch solves with ``options.quorum = quorum``, so
        the compiled loop exits once that fraction is done;
      phase 2 — the few unconverged members are gathered into a fixed-size
        ``drain_capacity`` batch (warm-started from their phase-1 iterates,
        padded by repetition, chunked if overfull) and re-solved to full
        convergence with a larger iteration budget; results scatter back.

    The tradeoff: the drain phase is latency-bound (the while_loop body is
    a chain of ~80 sequential scan steps whatever the drain batch's size),
    so this mode costs throughput against the strict solver while lifting
    batch convergence from ~99% to ~100%.  Use it
    when every problem in the batch must converge (safety-critical serving);
    use the plain solver with ``quorum=1.0`` for maximum throughput with
    per-member ``converged`` flags, or ``quorum<1`` alone for bounded
    latency without the drain.  For *throughput*-oriented full-convergence
    serving over large problem queues, prefer
    ``solver.streaming.make_streaming_solver``, which pays mean- rather than
    max-iteration cost per problem.

    The orchestration is host-side (two persistent jitted executables, one
    per batch shape); call it outside ``jit``.  Semantics match
    ``make_batched_ilqr_solver`` with ``quorum=1.0``: every member is driven
    until converged or until its (enlarged) iteration budget is exhausted,
    and ``converged`` reports the truth per member.
    """
    import dataclasses as _dc

    if drain_max_iters is None:
        drain_max_iters = 2 * options.max_iters
    main_opts = _dc.replace(options, quorum=quorum)
    drain_opts = _dc.replace(options, quorum=1.0, max_iters=drain_max_iters)
    solve_main = jax.jit(make_batched_ilqr_solver(ocp, main_opts, backend))
    solve_drain = jax.jit(make_batched_ilqr_solver(ocp, drain_opts, backend))

    @jax.jit
    def _scatter(xs, us, cost, gnorm, it, convd, sel, rd):
        # duplicate (padding) indices write identical rows — safe
        xs = xs.at[sel].set(rd.xs)
        us = us.at[sel].set(rd.us)
        cost = cost.at[sel].set(rd.cost)
        gnorm = gnorm.at[sel].set(rd.grad_norm)
        it = it.at[sel].max(it[sel] + rd.iterations)  # phase-1 + drain
        convd = convd.at[sel].set(rd.converged)
        return xs, us, cost, gnorm, it, convd

    def solve(x0s, params=None, us_init=None):
        res = solve_main(x0s, params, us_init)
        conv = jax.device_get(res.converged)
        idx_all = jnp.flatnonzero(~jnp.asarray(conv))
        n_bad = int(idx_all.shape[0])
        if n_bad == 0:
            return res
        x0s = jnp.asarray(x0s, dtype=res.xs.dtype)
        B = x0s.shape[0]
        ps = _broadcast_params(ocp, params, B, res.xs.dtype)
        xs, us = res.xs, res.us
        cost, gnorm = res.cost, res.grad_norm
        it, convd = res.iterations, res.converged
        for s in range(0, n_bad, drain_capacity):
            chunk = idx_all[s:s + drain_capacity]
            # pad by repeating the first straggler so every drain call (and
            # the scatter below) has the same static shape -> one compile
            n = int(chunk.shape[0])
            sel = jnp.concatenate(
                [chunk, jnp.broadcast_to(chunk[:1], (drain_capacity - n,))])
            rd = solve_drain(x0s[sel], ps[sel], us[sel])
            xs, us, cost, gnorm, it, convd = _scatter(
                xs, us, cost, gnorm, it, convd, sel, rd)
        return ILQRResult(xs=xs, us=us, cost=cost, grad_norm=gnorm,
                          iterations=it, converged=convd,
                          max_violation=res.max_violation)

    return solve
