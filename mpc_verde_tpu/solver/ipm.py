"""Log-barrier interior-point solver: the IPOPT-method analogue.

The reference's every solve is an *interior-point* iteration (IPOPT via
``ca.nlpsol`` — ``Casadi/single_shooting_v1.py:131`` — and inside
``mpc.nmpc``).  The framework's primary path replaces it with box-DDP whose
stage box QPs are solved exactly by active-set enumeration
(``solver/ilqr.py``), which is the right batched design for the
reference's nu <= 2 problems — but the enumeration is 3^nu patterns and the
Riccati kernel is specialized to nu <= 4.

This module is the interior-point treatment of the same OCP, matching
IPOPT's algorithmic family and scaling to arbitrary nu:

  * control box constraints become log-barrier terms
    ``-mu * sum(log(u-lb) + log(ub-u))`` in the stage cost;
  * each barrier subproblem is solved by the unmodified batched DDP solver
    (barrier curvature rides the stage-cost Hessian; the backward pass's box
    QPs see unbounded controls and reduce to pure Newton steps);
  * ``mu`` is **data** (a per-stage parameter column), so the whole
    continuation mu_0 > mu_1 > ... > mu_K reuses ONE compiled executable,
    warm-starting each subproblem from the previous solution — the LTV
    "models are data, not recompilation" design applied to the barrier
    parameter;
  * iterates stay strictly interior for free: an infeasible line-search
    candidate has cost NaN (log of a negative) and is rejected by the
    solver's parallel line search, so small alphas take over near the
    boundary — the grid line search doubles as a fraction-to-boundary rule.

Limitations (by construction of the barrier): bounds must be constant boxes
with lb < ub strictly — equality-pinned controls (move blocking) and
state-dependent boxes (rate form) belong to the DDP path.

Accuracy vs the exact-QP DDP solution: the barrier optimum sits O(mu) inside
active bounds; with the default schedule ending at mu=1e-6 the control gap
is well below the 1e-3 acceptance bound of BASELINE.md (asserted in
tests/test_ipm.py).  The final stages of the continuation are warm-started
and typically converge in a handful of DDP iterations each.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ocp.spec import OCP
from .ilqr import ILQROptions, ILQRResult, pin_precision
from .batched import make_batched_ilqr_solver, _broadcast_params


def _constant_box(ocp: OCP):
    """Extract the (lb, ub) arrays of a constant control box."""
    if ocp.control_bounds is None:
        raise ValueError("barrier solver needs finite control bounds; "
                         "use the DDP solvers for unconstrained problems")
    zx = jnp.zeros((ocp.nx,))
    zp = jnp.zeros((max(ocp.npar, 1),))
    lb0, ub0 = ocp.control_bounds(zx, zp, 0)
    # probe EVERY stage index plus a shifted (x, p) point: a box that varies
    # only mid-horizon must be rejected, not silently mis-solved
    probes = [(zx + 1.0, zp + 1.0, 0)] + [(zx, zp, k) for k in range(1, ocp.N)]
    for px, pp, pk in probes:
        lbk, ubk = ocp.control_bounds(px, pp, pk)
        if not (bool(jnp.all(lb0 == lbk)) and bool(jnp.all(ub0 == ubk))):
            raise ValueError(
                "barrier solver requires constant control bounds "
                "(state/stage-dependent boxes belong to the DDP path)")
    if not (bool(jnp.all(jnp.isfinite(lb0))) and bool(jnp.all(jnp.isfinite(ub0)))
            and bool(jnp.all(ub0 > lb0))):
        raise ValueError("barrier solver requires finite boxes with lb < ub "
                         "strictly (move blocking belongs to the DDP path)")
    return lb0, ub0


def make_barrier_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                        backend: str = "xla",
                        mu_schedule: Sequence[float] = (1.0, 1e-1, 1e-2, 1e-3,
                                                        1e-4, 1e-5, 1e-6),
                        interior_margin: float = 1e-3,
                        crossover: bool = True):
    """Build a batch-major interior-point solve for ``ocp``.

    Returns ``solve(x0s, params, us_init) -> ILQRResult`` with the same
    calling convention as ``make_batched_ilqr_solver``.  ``us_init`` is
    projected ``interior_margin * (ub - lb)`` inside the box before the
    first barrier subproblem.  The returned ``cost`` is the TRUE (barrier-
    free) cost of the final iterate; ``iterations`` is the total across the
    continuation; ``converged`` is the final subproblem's flag.

    ``crossover=True`` (default) finishes with a few exact-boxQP DDP
    iterations warm-started from the barrier point — the QP analogue of LP
    interior-point crossover.  It pins active bounds exactly and removes the
    flat-valley wander near bang-bang switch stages (measured ~3e-3 control
    gap without it on the diff-drive problem, at 1e-6 relative cost).  Only
    available for nu <= 4 (the enumeration limit); beyond that the pure
    barrier answer is returned.

    ``backend`` follows the batched solver ("xla" everywhere; the kernel
    additionally needs a GPU and nu <= 4).
    """
    import warnings

    lb, ub = _constant_box(ocp)
    npar = max(ocp.npar, 1)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    l, lf, F = ocp.stage_cost, ocp.terminal_cost, ocp.dynamics

    def stage_b(x, u, p):
        mu = p[npar]
        base = l(x, u, p[:npar])
        barrier = jnp.sum(jnp.log(u - lb)) + jnp.sum(jnp.log(ub - u))
        return base - mu * barrier

    ocp_b = dataclasses.replace(
        ocp,
        stage_cost=stage_b,
        terminal_cost=(None if lf is None else (lambda x, p: lf(x, p[:npar]))),
        dynamics=lambda x, u, p: F(x, u, p[:npar]),
        control_bounds=None,
        npar=npar + 1,
    )
    solve_b = make_batched_ilqr_solver(ocp_b, options, backend=backend)
    mus = tuple(float(m) for m in mu_schedule)
    if crossover and nu > 4:
        # don't silently degrade: the pure-barrier answer can sit ~3e-3 off
        # in flat bang-bang valleys (docstring) — tell the user at build time
        warnings.warn(
            f"barrier crossover skipped: nu={nu} exceeds the exact-boxQP "
            "enumeration limit (4); returning the pure barrier optimum "
            "(~O(final mu) inside active bounds)", stacklevel=2)
    solve_x = (make_batched_ilqr_solver(ocp, options, backend=backend)
               if crossover and nu <= 4 else None)

    def _true_cost1(x0, us, ps):
        def step(x, inp):
            u, p = inp
            return F(x, u, p), l(x, u, p)

        xN, cs = jax.lax.scan(step, x0, (us, ps[:N]))
        c = jnp.sum(cs)
        if lf is not None:
            c = c + lf(xN, ps[N])
        return c

    true_cost = jax.vmap(_true_cost1)

    def solve(x0s, params=None, us_init=None):
        dt_f = jnp.result_type(float)
        x0s = jnp.asarray(x0s, dtype=dt_f)
        B = x0s.shape[0]
        ps = _broadcast_params(ocp, params, B, dt_f)
        if us_init is None:
            us_init = jnp.zeros((B, N, nu), dtype=dt_f)
        margin = interior_margin * (ub - lb)
        us = jnp.clip(jnp.asarray(us_init, dtype=dt_f), lb + margin, ub - margin)

        total_it = jnp.zeros((B,), jnp.int32)
        res = None
        for mu in mus:
            mu_col = jnp.full((B, N + 1, 1), mu, dtype=dt_f)
            res = solve_b(x0s, jnp.concatenate([ps, mu_col], axis=-1), us)
            us = res.us
            total_it = total_it + res.iterations
        if solve_x is not None:
            res = solve_x(x0s, ps, us)
            us = res.us
            total_it = total_it + res.iterations
        return ILQRResult(
            xs=res.xs, us=us, cost=true_cost(x0s, us, ps),
            grad_norm=res.grad_norm, iterations=total_it,
            converged=res.converged, max_violation=res.max_violation)

    return pin_precision(solve)


def _barrier_term(u, lb_np, ub_np, mu):
    """Log-barrier contribution ``-mu * sum(log(dist))`` with exact
    boundary semantics for the streaming continuation:

      * mu > 0, u strictly interior: the ordinary barrier value;
      * mu > 0, u on/outside the box (d <= 0): **+inf** — the log term is
        -inf, so -mu*log prices the candidate infinitely BAD and the
        parallel line search rejects it (fraction-to-boundary rule; the
        sentinel sign matters — an inf of the wrong sign would make
        saturated candidates infinitely attractive);
      * mu == 0 (the crossover round): exactly 0 with exactly-zero
        derivatives (the outer where/select masks the untaken branch even
        when it is +-inf), so the round IS plain exact-boxQP DDP.

    The log reads a safe 1 where d <= 0, so no derivative order divides by
    zero there: a floor such as max(d, 1e-30) squares to 0 in f32 and
    turns the masked second derivative into 0 * inf = NaN at every control
    pinned on its bound.
    """
    d = jnp.concatenate([u - lb_np.astype(u.dtype),
                         ub_np.astype(u.dtype) - u])
    inside = d > 0
    # d <= 0 -> log term -inf -> -mu * (-inf) = +inf (rejection)
    pen = jnp.sum(jnp.where(inside, jnp.log(jnp.where(inside, d, 1.0)),
                            -jnp.inf))
    return jnp.where(mu > 0, -mu * pen, 0.0)


def make_streaming_barrier_solver(
        ocp: OCP, options: ILQROptions = ILQROptions(),
        backend: str | None = None,
        mu_schedule: Sequence[float] = (1e-2, 1e-4),
        interior_margin: float = 1e-3,
        batch_width: int = 2048,
        restarts: int = 0,
        refill_every: int = 1,
        inexact_kappa: float = 10.0,
        warmstart: str | None = None):
    """Streaming (continuous-batching) interior-point solve.

    ``make_barrier_solver`` runs the mu continuation as K successive batched
    ``while_loop`` dispatches, each paying the *max*-iteration tail of its
    whole batch per stage — exactly the tail the streaming solver exists to
    kill.  Here the continuation rides the streaming solver's per-slot round
    machinery (the same mechanism as the AL outer loop): when a slot's
    barrier subproblem converges, its mu column advances in place and the
    slot restarts fresh — every problem pays its own *mean* iterations per
    mu stage, budget-capped/failed subproblems get the in-place ``restarts``
    allowance per stage, and the whole queue is ONE device dispatch.

    The crossover is structural: the schedule is extended with a final
    mu = 0 round, and — unlike ``make_barrier_solver``'s ocp_b — the control
    box STAYS on the OCP, so the backward pass solves exact stage box QPs
    throughout (interior iterates never touch the box while mu > 0; the
    mu = 0 round IS warm-started exact-boxQP DDP, pinning active bounds).
    The barrier term is ``where(mu > 0, -mu * sum(log(dist)), 0)`` so the
    mu = 0 round's cost/gradients are exactly the true ones — the loop's
    reported cost needs no recompute, and an out-of-box line-search
    candidate still prices +inf while mu > 0 (fraction-to-boundary rule).

    Consequently this path requires nu <= 4 on the kernel (the box-QP
    enumeration limit, like every DDP fast path); for wider control
    vectors use ``make_barrier_solver(backend="xla")`` or the unbounded-
    subproblem composition with ``backend="scan"``.

    The default ``mu_schedule`` is SHORTER than ``make_barrier_solver``'s
    (2 stages vs 7): in the streaming form every stage has the full
    per-round iteration budget plus the in-place ``restarts`` allowance,
    so the conservative continuation is unnecessary.  The round-5 sweep
    (N=40 diff-drive, docs/design.md "Streaming IPM") found the
    quality-safe frontier needs a final interior stage at mu <= 1e-4 —
    crossing over from mu >= 1e-3 lands a large fraction of problems in
    worse local optima (p99 relative cost regression 0.1-0.4) — and that
    total iterations plateau at ~43 across (1e-2..1e-3, 1e-4) schedules:
    the iterate's crawl toward its active set costs the same wherever the
    schedule places it.  (1e-2, 1e-4) + crossover with inexact_kappa=10
    keeps the relative-cost distribution at the exact-DDP noise floor.
    Pass a longer schedule for harder barrier geometry.

    ``inexact_kappa``: early barrier subproblems are solved INEXACTLY —
    the inner convergence tolerance at barrier parameter mu is
    ``max(kappa * mu, tol)`` (both tol_grad and tol_cost scale together).
    This is IPOPT's own barrier-tolerance strategy ("adaptive mu" /
    monotone mode with loose inner tolerance, the defaults behind
    ``ca.nlpsol`` at ``Casadi/single_shooting_v1.py:121-129``): there is
    no point polishing a subproblem whose optimum sits O(mu) away from the
    true one.  The mu = 0 crossover round always runs at the strict
    tolerance (the scale is ``max(kappa*0/tol, 1) = 1``), so final
    convergence semantics are unchanged.  0 disables (round-4 exact
    behavior).  The tolerance rides the per-slot mu column as runtime
    data — one executable either way.

    State box bounds (``ocp.x_lb``/``x_ub``) COMPOSE with the barrier: the
    augmented-Lagrangian state-penalty continuation (lam, mu_al) and the
    barrier continuation (mu) ride the SAME per-slot rounds machinery as a
    product schedule — each round advance steps the mu column down its
    schedule AND applies the PHR multiplier update, over
    ``max(len(mu_schedule) + 1, options.al_iters)`` rounds.  Semantically
    this interleaves the two outer loops instead of nesting them (the
    nested form — a full AL solve per mu stage — is what
    ``make_barrier_solver`` + the batched AL solver does; the interleaved
    form reaches the same KKT point in far fewer rounds, parity-tested in
    tests/test_ipm.py).  The reference's circular-track family (state
    boxes at ``Trajectory Tracking/Trajectory_tracking.py:63-67``) streams
    through this path.

    ``warmstart="ddp"``: run the streaming box-DDP solver first and start
    the barrier continuation from its solution (pulled ``interior_margin``
    inside the box) — the classic crossover-then-recenter hybrid, IPOPT's
    own warm-start regime.  The cold continuation spends most of its
    iterations walking the iterate to its active set through the barrier
    (measured ~42 mean iterations at N=40 vs the DDP path's ~15, a
    schedule-invariant plateau — docs/design.md "Streaming IPM"); the
    exact-boxQP DDP phase identifies the active set at DDP speed, and the
    interior stage(s) + mu = 0 crossover then verify/polish it through the
    barrier in a handful of iterations (measured: 16.3 barrier iterations
    from the warm start, 31.1 total INCLUDING the DDP phase — 26% below
    the cold continuation, identical optima distribution).  With a warm
    start, a single interior stage (``mu_schedule=(1e-4,)``) suffices.
    Reported ``iterations`` include the DDP phase's; both phases run in the
    one jitted program.  None (default) = cold interior-point continuation.

    Returns ``solve(x0s, params, us_init, max_iters=None, restarts_n=None)``
    with the streaming solver's calling convention; ``iterations`` is the
    total across the continuation (including the crossover round).
    """
    from .streaming import make_streaming_solver
    from .batched import _al_cvals, _augment_ocp_al

    lb, ub = _constant_box(ocp)
    lb_np = np.asarray(lb, dtype=np.float64)
    ub_np = np.asarray(ub, dtype=np.float64)
    npar = max(ocp.npar, 1)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    l = ocp.stage_cost
    opt = options
    has_xb = ocp.has_state_bounds
    if has_xb and opt.al_iters < 1:
        raise ValueError("streaming barrier solver with state bounds needs "
                         "options.al_iters >= 1")

    def stage_b(x, u, p):
        mu = p[npar]
        base = l(x, u, p[:npar])
        return base + _barrier_term(u, lb_np, ub_np, mu)

    lf = ocp.terminal_cost
    F = ocp.dynamics
    cb = ocp.control_bounds
    ocp_b = dataclasses.replace(
        ocp,
        stage_cost=stage_b,
        terminal_cost=(None if lf is None else (lambda x, p: lf(x, p[:npar]))),
        dynamics=lambda x, u, p: F(x, u, p[:npar]),
        control_bounds=lambda x, p, k: cb(x, p[:npar], k),
        npar=npar + 1,
    )
    # continuation: mu_schedule stages then the mu = 0 crossover round
    mus = np.asarray(tuple(float(m) for m in mu_schedule) + (0.0,))
    n_mu = len(mus)

    if has_xb:
        # Product composition with the AL state-bound continuation: augment
        # the barrier OCP with the PHR penalty (params [p, mu_b, lam (2nx),
        # mu_al]) and advance BOTH continuations at every round boundary.
        cvals = _al_cvals(ocp_b)            # same x_lb/x_ub as ocp
        ocp_run = _augment_ocp_al(ocp_b)    # strips state bounds
        nlam = 2 * nx
        # +1: the interleaved lam updates ride looser mid-continuation
        # iterates than the nested form's (inexact inner rounds), so one
        # extra strict round (mu already 0, lam from a converged solve)
        # recovers the plain AL path's constraint tightness — measured
        # ~6 extra iterations for a ~10x violation reduction
        n_rounds = max(n_mu, opt.al_iters) + 1
        npar_b = npar + 1
        # cap the penalty escalation at what options.al_iters rounds of the
        # plain AL path would reach: extra interleaved rounds keep updating
        # lam but must not push mu_al into ill-conditioning
        mu_al_cap = float(opt.al_mu0 * opt.al_mu_factor ** (opt.al_iters - 1))

        def advance(ps, xs, rnd):
            mu_next = jnp.take(mus.astype(ps.dtype),
                               jnp.clip(rnd + 1, 0, n_mu - 1))
            mu_col = jnp.broadcast_to(mu_next[:, None, None],
                                      ps.shape[:2] + (1,)).astype(ps.dtype)
            c = jax.vmap(jax.vmap(cvals))(xs)          # (B, N+1, 2nx)
            c = jnp.where(jnp.isfinite(c), c, -1.0)
            lam = ps[:, :, npar_b:npar_b + nlam]
            mu_al = ps[:, :, npar_b + nlam:]
            lam_n = jnp.maximum(0.0, lam + mu_al * c)
            mu_al_n = jnp.minimum(mu_al * opt.al_mu_factor, mu_al_cap)
            return jnp.concatenate(
                [ps[:, :, :npar], mu_col, lam_n, mu_al_n], axis=-1)
    else:
        ocp_run = ocp_b
        n_rounds = n_mu

        def advance(ps, xs, rnd):
            mu_next = jnp.take(mus.astype(ps.dtype),
                               jnp.clip(rnd + 1, 0, n_mu - 1))
            return jnp.concatenate(
                [ps[:, :, :npar],
                 jnp.broadcast_to(mu_next[:, None, None],
                                  ps.shape[:2] + (1,)).astype(ps.dtype)],
                axis=-1)

    tol_scale_fn = None
    if inexact_kappa > 0:
        kap = float(inexact_kappa)
        tg = float(opt.tol_grad)

        def tol_scale_fn(ps):
            # mu is constant across stages within a slot; read stage 0
            return jnp.maximum(kap * ps[:, 0, npar] / tg, 1.0)

    ssolve = make_streaming_solver(
        ocp_run, options, backend=backend, batch_width=batch_width,
        restarts=restarts, refill_every=refill_every,
        rounds=(n_rounds, advance), tol_scale_fn=tol_scale_fn)

    if warmstart not in (None, "ddp"):
        raise ValueError(f"unknown warmstart mode {warmstart!r}; "
                         "supported: None (cold continuation), 'ddp'")
    dsolve = None
    if warmstart == "ddp":
        # the DDP phase solves the ORIGINAL ocp (exact box QPs; AL handles
        # any state bounds natively) — its solution becomes the barrier
        # continuation's interior-projected starting point
        dsolve = make_streaming_solver(
            ocp, options, backend=backend, batch_width=batch_width,
            restarts=restarts, refill_every=refill_every)

    def solve(x0s, params=None, us_init=None, max_iters=None,
              restarts_n=None):
        dt_f = jnp.result_type(float)
        x0s = jnp.asarray(x0s, dtype=dt_f)
        M = x0s.shape[0]
        ps = _broadcast_params(ocp, params, M, dt_f)
        if us_init is None:
            us_init = jnp.zeros((M, N, nu), dtype=dt_f)
        it_warm = None
        if dsolve is not None:
            r0 = dsolve(x0s, ps, us_init, max_iters, restarts_n)
            us_init, it_warm = r0.us, r0.iterations
        margin = interior_margin * (ub_np - lb_np)
        us = jnp.clip(jnp.asarray(us_init, dtype=dt_f),
                      lb_np + margin, ub_np - margin)
        mu0 = jnp.full((M, N + 1, 1), float(mus[0]), dt_f)
        cols = [ps, mu0]
        if has_xb:
            cols += [jnp.zeros((M, N + 1, nlam), dt_f),
                     jnp.full((M, N + 1, 1), float(opt.al_mu0), dt_f)]
        res = ssolve(x0s, jnp.concatenate(cols, axis=-1), us,
                     max_iters, restarts_n)
        if it_warm is not None:
            # total passes across BOTH phases — the honest hybrid count
            res = ILQRResult(
                xs=res.xs, us=res.us, cost=res.cost,
                grad_norm=res.grad_norm,
                iterations=res.iterations + it_warm,
                converged=res.converged, max_violation=res.max_violation)
        if not has_xb:
            return res
        # the loop's stored cost is the AL-augmented one at the final
        # multipliers; report the true cost and the state-box violation
        lfv = lf or (lambda x, p: jnp.zeros((), dtype=x.dtype))

        def traj_cost(xs_1, us_1, ps_1):
            cs = jax.vmap(l)(xs_1[:N], us_1, ps_1[:N])
            return jnp.sum(cs) + lfv(xs_1[N], ps_1[N])

        cost_q = jax.vmap(traj_cost)(res.xs, res.us, ps)
        cv = jax.vmap(jax.vmap(cvals))(res.xs)
        viol_q = jnp.max(jnp.maximum(
            0.0, jnp.where(jnp.isfinite(cv), cv, 0.0)), axis=(1, 2))
        return ILQRResult(
            xs=res.xs, us=res.us, cost=cost_q, grad_norm=res.grad_norm,
            iterations=res.iterations, converged=res.converged,
            max_violation=viol_q)

    return pin_precision(solve)
