"""Streaming (persistent-batch) DDP solver: pay mean iterations, not max.

The batched solver's ``while_loop`` runs until its *slowest* member finishes:
at N=40 the iteration distribution is mean ~15 / p99 ~36 / cap 40, so every
batch pays ~40 iterations of full-batch work for ~15 iterations of useful
work per member (docs/design.md straggler study).  The quorum/drain modes
trade convergence or dispatch round-trips against that tail.

This module removes the tail structurally.  One compiled ``while_loop`` owns
a fixed-width slot batch and a *queue* of M problems in device memory:

  * every slot runs the exact same per-iteration math as
    ``make_batched_ilqr_solver`` (the body pieces are shared —
    ``batched._make_parts`` / ``batched._accept_and_update``);
  * when a slot's problem converges (or exhausts its budget), its result is
    scattered to the output buffers and the slot immediately reloads the
    next queued problem;
  * the queue is PRE-ROLLED: the initial rollout (trajectory + cost) of
    every queued problem is computed up front in ONE batched scan over the
    whole queue and stored in the packed queue row, so a refilled slot's
    very first pass is already a real DDP iteration (backward on a valid
    trajectory).  Round 4's alternative — a "fresh" pass whose zeroed gains
    turned the shared line search into the initial rollout — paid one full
    iteration body (backward + A-alpha line search) per problem for work
    that is a single rollout, embarrassingly parallel over the queue; the
    pre-roll moves it out of the loop.

Total device time is therefore ~(mean iterations x per-iteration cost x
M / B) instead of ~(max iterations x ...): the straggler tail of one batch
overlaps with fresh problems instead of blocking them.  Convergence
semantics per problem are identical to the strict batched solver (full
iteration budget, per-problem ``converged`` flags).

This is the batched-accelerator analogue of continuous batching in LLM
serving; the reference's one-IPOPT-process-per-problem model has no
counterpart (``Casadi/single_shooting_v1.py:174`` solves serially).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ocp.spec import OCP
from ..utils.platform import resolve_backend
from .ilqr import ILQROptions, ILQRResult, pin_precision
from .batched import (_make_parts, _accept_and_update, _broadcast_params,
                      _al_cvals, _augment_ocp_al)


def make_streaming_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                          backend: str | None = None,
                          batch_width: int = 2048,
                          linesearch: str = "materialize",
                          restarts: int = 0,
                          refill_every: int = 1,
                          rounds=None,
                          tol_scale_fn=None,
                          interpret: bool = False):
    """Build ``solve(x0s, params, us_init) -> ILQRResult`` over a problem queue.

    Args of the returned function have a leading *queue* axis of length M
    (any M >= 1): x0s (M, nx), params (M, N+1, npar) (or the broadcast
    conveniences of the batched solver), us_init (M, N, nu).  ``batch_width``
    is the number of resident slots B; throughput saturates once B fills the
    device and M >> B amortizes the pipeline head/tail.  ``backend`` and
    ``interpret`` are the batched solver's (None: chosen from the platform).

    The whole queue is solved in ONE device dispatch (one ``while_loop``);
    results come back in queue order with per-problem convergence flags,
    exactly like the batched solver's.

    ``restarts``: how many times a problem that exhausts its iteration
    budget is requeued *in place* — fresh solver state (regularization,
    stall counters, DDP mode), warm-started at its best iterate — before
    being reported unconverged.  A restart was measured to unstick
    virtually every budget-capped crawler (see docs/design.md straggler
    study).  Restart iterations count toward the reported per-problem
    ``iterations``.  With AL state bounds, the restart budget is *per AL
    round*: a round that fails or caps re-solves at the current multipliers
    (consuming that round's budget) before the multipliers advance, and the
    next round starts with the full budget again.

    ``refill_every``: run the scatter/refill block once per this many
    solver iterations instead of every iteration.  The block is the
    iteration body's glue — queue gathers, output scatters, slot-state
    resets — a fixed per-iteration latency; at cadence R a finished slot idles at most R-1 iterations
    (expected (R-1)/2 of mean ~15 useful iterations) while the glue cost
    drops R-fold.  Restarts and AL multiplier advances stay per-iteration
    (they are elementwise, not scatter/gather).  1 = the strict
    refill-every-iteration schedule.

    ``rounds``: optional ``(n_rounds, advance)`` continuation spec — the
    generalization of the AL outer loop to any per-slot parameter
    continuation (the streaming IPM rides this, ``ipm.py``).  A slot whose
    inner solve ends at round r < n_rounds-1 gets its param tensor rewritten
    by ``advance(ps, xs, r) -> ps_new`` ((B, N+1, npar), (B, N+1, nx),
    (B,) int32 -> ps) and restarts fresh in place, with the full per-round
    restart budget.  Mutually exclusive with state bounds (which install
    the AL spec internally).

    ``tol_scale_fn``: optional ``ps (B, N+1, npar) -> (B,)`` per-slot
    convergence-tolerance multiplier (>= 1), evaluated every iteration from
    the slot's CURRENT param tensor.  Continuation solvers use it to solve
    early rounds inexactly (IPOPT's inexact-barrier-subproblem strategy —
    the tolerance rides the continuation data, so no recompile); the final
    round's params must map to 1.0 for strict final convergence.
    """
    backend = resolve_backend(backend, ocp.nu, interpret=interpret)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    B = int(batch_width)
    R = int(refill_every)
    if R < 1:
        raise ValueError("refill_every must be >= 1")
    # State box bounds: the same PHR augmented-Lagrangian outer loop as
    # make_ilqr_solver, with the multipliers riding the per-slot param tensor
    # (see batched._augment_ocp_al).  A slot that finishes an inner round at
    # al_round < al_iters-1 updates its lam/mu columns in place and restarts
    # fresh — the AL outer loop IS the refill machinery, so state-bounded
    # problems stream at full speed instead of falling back to vmap.
    has_xb = ocp.has_state_bounds
    al_iters = opt.al_iters if has_xb else 0
    if has_xb and al_iters == 0:
        raise ValueError(
            "streaming solver with state bounds needs options.al_iters >= 1")
    ocp_in = ocp
    npar = max(ocp_in.npar, 1)
    if has_xb and rounds is not None:
        raise ValueError("rounds= cannot be combined with state bounds "
                         "(state bounds install the AL continuation spec)")
    if has_xb:
        cvals = _al_cvals(ocp)
        ocp = _augment_ocp_al(ocp)
        nlam = 2 * nx

        def _al_advance(ps, xs, alr):
            c = jax.vmap(jax.vmap(cvals))(xs)        # (B, N+1, 2nx)
            c = jnp.where(jnp.isfinite(c), c, -1.0)
            lam = ps[:, :, npar:npar + nlam]
            mu = ps[:, :, npar + nlam:]
            lam_n = jnp.maximum(0.0, lam + mu * c)
            return jnp.concatenate(
                [ps[:, :, :npar], lam_n, mu * opt.al_mu_factor], axis=-1)

        n_rounds, advance = al_iters, _al_advance
    elif rounds is not None:
        n_rounds, advance = int(rounds[0]), rounds[1]
        if n_rounds < 1:
            raise ValueError("rounds[0] must be >= 1")
    else:
        n_rounds, advance = 1, None
    parts = _make_parts(ocp, opt, backend, linesearch, interpret)

    # True cost of the CURRENT (xs, us) under a slot's CURRENT params —
    # elementwise over stages, no sequential scan.  Continuation advances
    # (AL multiplier update / IPM mu step) and in-place restarts use it to
    # re-base the acceptance cost without a re-roll: the accepted (xs, us)
    # are already the exact rollout of us (the line search materializes
    # them through the same dynamics), only the cost function changed.
    # Bitwise-identical to rollout1's reduction (same per-stage values,
    # same jnp.sum order).
    l_run = ocp.stage_cost
    lf_run = ocp.terminal_cost or (lambda x, p: jnp.zeros((), dtype=x.dtype))

    def _cost1(xs1, us1, ps1):
        cs = jax.vmap(l_run)(xs1[:N], us1, ps1[:N])
        return jnp.sum(cs) + lf_run(xs1[N], ps1[N])

    batch_cost = jax.vmap(_cost1)

    def solve(x0q, params=None, us_init=None, max_iters=None, restarts_n=None):
        """Solve the queue.  ``max_iters`` / ``restarts_n`` override the
        build-time per-problem iteration budget and in-place restart budget
        *as traced data*: one jitted executable serves every (budget,
        restart) serving mode — the fast path and the full-convergence path
        differ only in two scalars (restarts as data, not a second jit)."""
        mi = jnp.asarray(opt.max_iters if max_iters is None else max_iters,
                         jnp.int32)
        rs = jnp.asarray(restarts if restarts_n is None else restarts_n,
                         jnp.int32)
        dt_f = jnp.result_type(float)
        x0q = jnp.asarray(x0q, dtype=dt_f)
        M = x0q.shape[0]
        psq = _broadcast_params(ocp_in, params, M, dt_f)
        if has_xb:
            # extend every queue entry with fresh multipliers [lam=0, mu=mu0]
            psq = jnp.concatenate([
                psq, np.zeros((M, N + 1, nlam), dt_f),
                np.full((M, N + 1, 1), opt.al_mu0, dt_f)],
                axis=-1)
        # Varying-zero: under shard_map, literal-constant carry leaves are
        # typed "replicated" while the loop body produces device-varying
        # values; tying every carry leaf to the (varying) problem data keeps
        # the while_loop carry types consistent.  A no-op outside shard_map.
        # Non-finite queue entries are masked BEFORE the reduction — a single
        # NaN x0 (or an f32 overflow of the sum) must poison only its own
        # problem, never the shared zero.
        vz = jnp.sum(jnp.where(jnp.isfinite(x0q), x0q, 0.0) * 0.0)

        # The packed queue is tainted with the traced zero so
        # tracer-indexed gathers below see jax arrays even when the caller
        # passed None.
        if us_init is None:
            us_init = np.zeros((M, N, nu), dtype=dt_f)
        us0q = jnp.asarray(us_init, dt_f)

        npar_t = psq.shape[-1]
        sx, su = (N + 1) * nx, N * nu
        sp = (N + 1) * npar_t
        # PRE-ROLL the whole queue: one batched rollout (width M, the only
        # sequential axis is the horizon) yields every problem's initial
        # trajectory, clipped warm-start controls, and cost.  Refilled slots
        # then start mid-solve — their first pass is a real backward on a
        # valid trajectory instead of a rollout-only "fresh" pass, saving
        # one full iteration body per problem (docs/design.md).
        xs0q, usc0q, c0q = parts.rollout(x0q, us0q, psq)
        # ONE packed queue row per problem [x0 | ps | us0 | xs0 | cost0]:
        # refilling a slot costs a single gather instead of several (the
        # glue block's scatter/gather op count, not payload bytes, sets its
        # per-iteration fixed latency)
        qpk = jnp.concatenate(
            [x0q, psq.reshape(M, sp), usc0q.reshape(M, su),
             xs0q.reshape(M, sx), c0q[:, None]], axis=1)
        qpk = qpk + vz.astype(dt_f)

        idx0 = np.arange(B, dtype=np.int32)
        n0 = min(B, M)
        prob0 = np.where(idx0 < n0, idx0, M).astype(np.int32)
        active0 = idx0 < n0
        g0 = np.clip(prob0, 0, M - 1)

        def _vary(leaf):
            if leaf.dtype == jnp.bool_:
                return leaf ^ (vz > 1.0)
            return leaf + vz.astype(leaf.dtype)

        inf = np.asarray(np.inf, dt_f)
        state0 = (
            xs0q[g0],                            # xs (pre-rolled)
            usc0q[g0],                           # us (clipped warm start)
            c0q[g0],                             # cost (pre-rolled)
            np.full((B,), opt.reg_init, dt_f),   # reg
            np.zeros((B,), np.int32),            # it
            ~active0,                            # done (idle slots)
            np.full((B,), np.inf, dt_f),         # gnorm
            np.zeros((B,), np.int32),            # stall
            np.zeros((B,), bool),                # fail
            np.full((B,), bool(opt.use_ddp)),    # ddp_on
        )
        book0 = (
            x0q[g0],                             # x0s per slot
            psq[g0],                             # ps per slot
            prob0,                               # problem index (M = idle)
            np.zeros((B,), bool),                # capped flag
            np.zeros((B,), np.int32),            # restarts used
            np.zeros((B,), np.int32),            # iters before restart
            np.int32(n0),                        # queue pointer
            np.zeros((B,), np.int32),            # AL round (0 = no bounds)
        )
        # ONE packed output buffer [xs | us | cost gnorm it conv] per
        # problem; row M is the dummy target for idle-slot writes.  Packing
        # turns the refill block's six scatters into one (the scatter op —
        # not its payload bytes — is what costs fixed latency per iteration).
        out0 = jax.tree.map(_vary, np.zeros((M + 1, sx + su + 4), dt_f))
        state0 = jax.tree.map(_vary, state0)
        book0 = jax.tree.map(_vary, book0)

        def cond(carry):
            _, book, _ = carry
            return jnp.any(book[2] < M)

        def refill(state, book, out):
            """Scatter finished problems to the output, load next queued
            problems into their slots.  Pure glue: one packed scatter, one
            packed gather, one where-chain over the slot state."""
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = state
            x0s, ps, prob, capped, rst, iacc, nq, alr = book

            fin = done & (prob < M)
            widx = jnp.where(fin, prob, M)
            conv = ~fail & jnp.isfinite(cost) & ~capped
            row = jnp.concatenate(
                [xs.reshape(B, sx), us.reshape(B, su), cost[:, None],
                 gnorm[:, None],
                 (iacc + jnp.maximum(it, 0)).astype(dt_f)[:, None],
                 conv.astype(dt_f)[:, None]], axis=1)
            out = out.at[widx].set(row)

            rank = jnp.cumsum(fin.astype(jnp.int32)) - 1
            cand = nq + rank
            has = fin & (cand < M)
            gidx = jnp.clip(cand, 0, M - 1)
            qrow = qpk[gidx]
            selb = lambda new, old: jnp.where(
                has.reshape((B,) + (1,) * (new.ndim - 1)), new, old)
            x0s = selb(qrow[:, :nx], x0s)
            ps = selb(qrow[:, nx:nx + sp].reshape(B, N + 1, npar_t), ps)
            us = selb(qrow[:, nx + sp:nx + sp + su].reshape(B, N, nu), us)
            # the pre-rolled trajectory replaces whatever the dead problem
            # left in the slot (including NaNs — containment preserved: a
            # NaN queue entry pre-rolls to a NaN cost and fails only itself)
            xs = selb(qrow[:, nx + sp + su:nx + sp + su + sx]
                      .reshape(B, N + 1, nx), xs)
            cost = jnp.where(has, qrow[:, -1], cost)
            reg = jnp.where(has, np.asarray(opt.reg_init, dt_f), reg)
            it = jnp.where(has, 0, it)
            gnorm = jnp.where(has, inf, gnorm)
            stall = jnp.where(has, 0, stall)
            fail = jnp.where(has, False, fail)
            ddp_on = jnp.where(has, bool(opt.use_ddp), ddp_on)
            capped = jnp.where(has, False, capped)
            done = jnp.where(has, False, done)
            prob = jnp.where(has, cand, jnp.where(fin, M, prob))
            rst = jnp.where(has, 0, rst)
            iacc = jnp.where(has, 0, iacc)
            alr = jnp.where(has, 0, alr)
            nq = (nq + jnp.sum(has.astype(jnp.int32))).astype(jnp.int32)

            state = (xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on)
            book = (x0s, ps, prob, capped, rst, iacc, nq, alr)
            return state, book, out

        def compute(state, book):
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = state
            x0s, ps, prob, capped, rst, iacc, nq, alr = book

            # --- one shared solver iteration ------------------------------
            # (every slot's xs/cost are always consistent with its us and ps
            # — the pre-rolled queue, the cost re-base at continuation
            # advances, and the line search's materialized accepts maintain
            # the invariant — so every pass is a real DDP iteration)
            d, gN, HN, dlb, dub = parts.derivs(xs, us, ps)
            kffs, Ks, dV1, dV2, gmax = parts.backward(
                d, gN, HN, dlb, dub, reg, ddp_on.astype(dt_f))
            xs_b, us_b, new_cost = parts.linesearch(x0s, xs, us, ps, kffs, Ks)
            tsc = None if tol_scale_fn is None else tol_scale_fn(ps)
            st = _accept_and_update(
                opt, (xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on),
                gmax, xs_b, us_b, new_cost, tol_scale=tsc)
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = st

            # per-slot iteration budget (the batched solver's loop-level cap)
            newly_capped = ~done & (it >= mi)
            # Requeue in place: fresh solver state (regularization, stall
            # counters, DDP mode), warm-started at the best iterate — the
            # drain-restart that unsticks crawlers.  Covers BOTH exhausted
            # budgets and reg-exhaustion failures — a "failed" crawler
            # (regularization maxed out while still occasionally improving)
            # usually converges after a restart resets its reg/stall state
            # (measured: failures are ~all of the 0.5% full-mode
            # non-convergers at N=40, iters 20-47 << cap).  The slot's
            # (xs, us, cost) stay — they are the accepted consistent triple,
            # so no re-roll pass is needed (round 5).  With rs == 0 every
            # `redo` is False and this block is free elementwise arithmetic
            # — always compiled in, so the restart budget can be runtime
            # data.
            bad_now = newly_capped | (done & fail & (prob < M))
            redo = bad_now & (rst < rs)
            newly_capped = newly_capped & ~redo
            fail = jnp.where(redo, False, fail)
            done = jnp.where(redo, False, done)
            iacc = jnp.where(redo, iacc + it, iacc)
            rst = rst + redo.astype(jnp.int32)
            reg = jnp.where(redo, np.asarray(opt.reg_init, dt_f), reg)
            it = jnp.where(redo, 0, it)
            stall = jnp.where(redo, 0, stall)
            gnorm = jnp.where(redo, inf, gnorm)
            ddp_on = jnp.where(redo, bool(opt.use_ddp), ddp_on)
            done = done | newly_capped
            capped = capped | newly_capped

            if n_rounds > 1:
                # Continuation outer loop in place: a slot whose inner round
                # ended (converged, failed, or budget-capped — matching the
                # unconditional al_round scan of make_ilqr_solver) at
                # round < n_rounds-1 gets its param tensor rewritten by the
                # advance fn (AL multiplier update / IPM mu step) and starts
                # the next inner solve directly: (xs, us) are unchanged by
                # the advance, so the acceptance cost is just RE-BASED to
                # the new params elementwise (batch_cost) — no re-roll pass
                # (round 5; saves one iteration body per continuation round).
                adv = done & (prob < M) & (alr < n_rounds - 1)
                ps_n = advance(ps, xs, alr)
                a3 = adv.reshape((B, 1, 1))
                ps = jnp.where(a3, ps_n, ps)
                alr = alr + adv.astype(jnp.int32)
                iacc = jnp.where(adv, iacc + jnp.maximum(it, 0), iacc)
                cost = jnp.where(adv, batch_cost(xs, us, ps), cost)
                reg = jnp.where(adv, np.asarray(opt.reg_init, dt_f), reg)
                it = jnp.where(adv, 0, it)
                stall = jnp.where(adv, 0, stall)
                gnorm = jnp.where(adv, inf, gnorm)
                fail = jnp.where(adv, False, fail)
                ddp_on = jnp.where(adv, bool(opt.use_ddp), ddp_on)
                capped = jnp.where(adv, False, capped)
                # per-AL-round restart budget: each inner round gets the full
                # `restarts` allowance (a failed/capped round consumes from
                # its own round's budget before the multiplier advance)
                rst = jnp.where(adv, 0, rst)
                done = done & ~adv

            state = (xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on)
            book = (x0s, ps, prob, capped, rst, iacc, nq, alr)
            return (state, book)

        def body(carry):
            state, book, out = carry
            state, book, out = refill(state, book, out)
            # python-unrolled (NOT fori_loop): a fori_loop pays the same
            # loop turnaround as the outer while, so cadence only pays off
            # if the R compute iterations are straight-line code — R-fold
            # fewer loop turnarounds for an R-fold larger body program.
            for _ in range(R):
                state, book = compute(state, book)
            return (state, book, out)

        _, _, out = jax.lax.while_loop(cond, body, (state0, book0, out0))
        o = out[:M]
        xs_q = o[:, :sx].reshape(M, N + 1, nx)
        us_q = o[:, sx:sx + su].reshape(M, N, nu)
        cost_q = o[:, sx + su]
        o_gnorm = o[:, sx + su + 1]
        o_it = o[:, sx + su + 2].astype(jnp.int32)
        o_conv = o[:, sx + su + 3] > 0.5
        viol_q = np.zeros((M,), dt_f)
        if has_xb:
            # the loop's cost is the augmented one at the final multipliers;
            # report the true cost and the state-box violation instead (one
            # fused pass over the finished queue — negligible vs the solve)
            l = ocp_in.stage_cost
            lf = ocp_in.terminal_cost or (
                lambda x, p: jnp.zeros((), dtype=x.dtype))

            def traj_cost(xs_1, us_1, ps_1):
                cs = jax.vmap(l)(xs_1[:N], us_1, ps_1[:N, :npar])
                return jnp.sum(cs) + lf(xs_1[N], ps_1[N, :npar])

            cost_q = jax.vmap(traj_cost)(xs_q, us_q, psq)
            cv = jax.vmap(jax.vmap(cvals))(xs_q)
            viol_q = jnp.max(jnp.maximum(
                0.0, jnp.where(jnp.isfinite(cv), cv, 0.0)), axis=(1, 2))
        return ILQRResult(
            xs=xs_q, us=us_q, cost=cost_q, grad_norm=o_gnorm,
            iterations=o_it, converged=o_conv,
            max_violation=viol_q)

    return pin_precision(solve)
