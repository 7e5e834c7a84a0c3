"""Pallas kernel (Triton route): batched Riccati backward with exact box QPs.

The backward pass is N sequential stages of arithmetic on 3x3 / 2x2
per-problem matrices.  As vmapped XLA it is a ``lax.scan`` whose every stage
is its own handful of kernel launches.  This kernel runs the whole recursion
in one launch:

  * **Structure-of-arrays layout** ``(N, entries, B)``: problems sit on the
    contiguous axis, so the loads of one matrix entry by a warp coalesce.
    Every matrix operation of the recursion becomes a few elementwise vector
    operations over the program's block of problems (one problem per
    thread) — no tiny matmuls, far below what the tensor cores take.
  * **Stages as an in-kernel loop**: each program owns a power-of-two block
    of problems and walks the N stages in reverse with ``lax.fori_loop``.
    The value function (Vx, Vxx) and the dV1/dV2/gmax reductions are the
    loop carry and stay in registers.
  * **Exact stage box QP by active-set enumeration**: for nu <= 4 every
    one of the 3^nu patterns (which coordinates are clamped) is solved and
    the feasible minimum kept by a chain of selects — branch-free, exactly
    the enumeration of ``solver/boxqp.py``.  For nu <= 2 the patterns are
    unrolled with static closed forms (division / 2x2 adjugate); for
    nu = 3, 4 a loop over the pattern index solves each by masked no-pivot
    elimination (unrolled, 27-81 eliminations per stage take the GPU
    compiler minutes).

Semantics match ``solver/ilqr.py``'s backward pass (including full-DDP
second-order terms and the projected-gradient stationarity measure) to f32
round-off; see tests/test_pallas_riccati.py.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

# Problems per program and warps per program, chosen on an H100 at N=40,
# W=1024, (nx, nu) = (3, 2) (PERF.md): a block of 32 problems on one warp
# spreads a 1024-slot batch over 32 SMs; larger blocks or more warps were
# no faster, and two pipeline stages were ~4 % faster than one.
BLOCK = 32
NUM_WARPS = 1

_BIG = 1e30


def _max(a, b):
    """``jnp.maximum`` with XLA's NaN propagation.  A GPU's ``max.f32``
    returns the non-NaN operand, so a NaN stage gradient would vanish from
    gmax, which the solver's convergence tests read."""
    return jnp.where(jnp.isnan(a), a,
                     jnp.where(jnp.isnan(b), b, jnp.maximum(a, b)))


def _min(a, b):
    """``jnp.minimum`` with XLA's NaN propagation (see ``_max``)."""
    return jnp.where(jnp.isnan(a), a,
                     jnp.where(jnp.isnan(b), b, jnp.minimum(a, b)))


def _backward_stage(nx: int, nu: int, use_ddp: bool, tol: float, shape,
                    E, Vx, Vxx, rg, ds):
    """One Riccati stage of the backward recursion on vectors of problems.

    Args:
      shape: shape of every operand (the program's block of problems).
      E: accessor ``E(name, e) -> array`` for entry ``e`` of stage
        derivative ``name`` (fx, fu, lx, lu, lxx, luu, lux, fxx, fux, fuu,
        dlb, dub — flattened row-major).
      Vx, Vxx: value-function operands (sequences of nx / nx*nx).
      rg: regularization; ds: per-problem DDP on/off scale.

    Returns ``(kff [nu], K [nu][nx], Vx_n [nx], Vxx_n [nxx, symmetrized],
    dV1_inc, dV2_inc, pgmax_stage)``.
    """
    patterns = list(itertools.product((0, 1, 2), repeat=nu))

    # ---- Q expansion ---------------------------------------------
    Qx = [E("lx", i) + sum(E("fx", j * nx + i) * Vx[j] for j in range(nx))
          for i in range(nx)]
    Qu = [E("lu", a) + sum(E("fu", j * nu + a) * Vx[j] for j in range(nx))
          for a in range(nu)]
    VF = [[sum(Vxx[j * nx + k] * E("fx", k * nx + i) for k in range(nx))
           for i in range(nx)] for j in range(nx)]
    VFu = [[sum(Vxx[j * nx + k] * E("fu", k * nu + a) for k in range(nx))
            for a in range(nu)] for j in range(nx)]
    Qxx = [[E("lxx", i * nx + j)
            + sum(E("fx", k * nx + i) * VF[k][j] for k in range(nx))
            for j in range(nx)] for i in range(nx)]
    Quu = [[E("luu", a * nu + b)
            + sum(E("fu", k * nu + a) * VFu[k][b] for k in range(nx))
            for b in range(nu)] for a in range(nu)]
    Qux = [[E("lux", a * nx + i)
            + sum(E("fu", k * nu + a) * VF[k][i] for k in range(nx))
            for i in range(nx)] for a in range(nu)]

    if use_ddp:
        for i in range(nx):
            for j in range(nx):
                Qxx[i][j] = Qxx[i][j] + ds * sum(
                    Vx[m] * E("fxx", (m * nx + i) * nx + j)
                    for m in range(nx))
        for a in range(nu):
            for i in range(nx):
                Qux[a][i] = Qux[a][i] + ds * sum(
                    Vx[m] * E("fux", (m * nu + a) * nx + i)
                    for m in range(nx))
        for a in range(nu):
            for b in range(nu):
                Quu[a][b] = Quu[a][b] + ds * sum(
                    Vx[m] * E("fuu", (m * nu + a) * nu + b)
                    for m in range(nx))

    for a in range(nu):
        Quu[a][a] = Quu[a][a] + rg

    lo = [E("dlb", a) for a in range(nu)]
    hi = [E("dub", a) for a in range(nu)]

    # ---- exact box QP: static active-set enumeration --------------
    def solve_free(free, rhss):
        """Solve Quu[F,F] X = rhs for each rhs, F a static index set.

        k = 1, 2 use the closed forms (division / 2x2 adjugate).  rhss is a
        list of k-length lists.
        """
        if len(free) == 1:
            d = Quu[free[0]][free[0]]
            return [[r[0] / d] for r in rhss]
        f0, f1 = free
        det = Quu[f0][f0] * Quu[f1][f1] - Quu[f0][f1] * Quu[f1][f0]
        return [[(r[0] * Quu[f1][f1] - r[1] * Quu[f0][f1]) / det,
                 (r[1] * Quu[f0][f0] - r[0] * Quu[f1][f0]) / det]
                for r in rhss]

    def qp_candidate(pat):
        free = [a for a in range(nu) if pat[a] == 0]
        v = [None] * nu
        feas = None

        def AND(x, y):
            return y if x is None else jnp.logical_and(x, y)

        clamp_val = {}
        for a in range(nu):
            if pat[a] == 1:
                clamp_val[a] = lo[a]
            elif pat[a] == 2:
                clamp_val[a] = hi[a]
        for a, cv in clamp_val.items():
            v[a] = cv
            feas = AND(feas, jnp.isfinite(cv))

        K = [[jnp.zeros(shape, jnp.float32) for _ in range(nx)]
             for _ in range(nu)]
        if free:
            # kff: Quu_FF v_F = -(Qu_F + Quu_FC v_C);
            # K rows: Quu_FF K_F = -Qux_F (clamped rows stay zero —
            # clamped controls don't react to state perturbations)
            rhs_v = [-(Qu[f] + sum(Quu[f][c] * v[c]
                                   for c in clamp_val))
                     for f in free]
            rhs_K = [[-Qux[f][i] for f in free] for i in range(nx)]
            sols = solve_free(free, [rhs_v] + rhs_K)
            for j, f in enumerate(free):
                v[f] = sols[0][j]
            for i in range(nx):
                for j, f in enumerate(free):
                    K[f][i] = sols[1 + i][j]

        for a in free:
            feas = AND(feas, (v[a] >= lo[a] - tol) & (v[a] <= hi[a] + tol))
        grad = [Qu[a] + sum(Quu[a][b] * v[b] for b in range(nu))
                for a in range(nu)]
        for a in range(nu):
            if pat[a] == 1:
                feas = AND(feas, grad[a] >= -tol)
            elif pat[a] == 2:
                feas = AND(feas, grad[a] <= tol)
        if feas is None:
            feas = jnp.full(shape, True)

        obj = sum(0.5 * v[a] * Quu[a][b] * v[b]
                  for a in range(nu) for b in range(nu)) \
            + sum(Qu[a] * v[a] for a in range(nu))
        obj = jnp.where(feas, obj, _BIG)
        return v, K, obj

    def qp_pattern(p):
        """``qp_candidate`` of pattern index ``p`` (a traced scalar, digits
        base 3 in ``patterns`` order) with the pattern's structure as
        masks: the free block is solved by no-pivot elimination of the full
        system whose clamped rows and columns are replaced by the
        identity, so one loop body serves all 3^nu patterns (Quu is SPD +
        reg on every free block, so the pivots are positive)."""
        # lax.div/rem: p >= 0, and jnp's floor division does not lower to
        # Triton
        p = jnp.asarray(p, jnp.int32)
        st = [jax.lax.rem(jax.lax.div(p, jnp.int32(3 ** (nu - 1 - a))),
                          jnp.int32(3)) for a in range(nu)]
        free = [s == 0 for s in st]
        cv = [jnp.where(st[a] == 1, lo[a], jnp.where(st[a] == 2, hi[a], 0.0))
              for a in range(nu)]
        A = [[jnp.where(free[r] & free[c], Quu[r][c],
                        1.0 if r == c else 0.0) for c in range(nu)]
             for r in range(nu)]
        X = [[jnp.where(free[a], -(Qu[a] + sum(
                  jnp.where(free[c], 0.0, Quu[a][c] * cv[c])
                  for c in range(nu))), cv[a]) for a in range(nu)]]
        X += [[jnp.where(free[a], -Qux[a][i], 0.0) for a in range(nu)]
              for i in range(nx)]
        for q in range(nu):
            ip = 1.0 / A[q][q]
            for r in range(q + 1, nu):
                m = A[r][q] * ip
                for c in range(q + 1, nu):
                    A[r][c] = A[r][c] - m * A[q][c]
                for x in X:
                    x[r] = x[r] - m * x[q]
        for x in X:
            for r in reversed(range(nu)):
                acc = x[r]
                for c in range(r + 1, nu):
                    acc = acc - A[r][c] * x[c]
                x[r] = acc / A[r][r]
        v = X[0]
        K = [[X[1 + i][a] for i in range(nx)] for a in range(nu)]
        grad = [Qu[a] + sum(Quu[a][b] * v[b] for b in range(nu))
                for a in range(nu)]
        feas = None
        for a in range(nu):
            fa = jnp.where(
                free[a], (v[a] >= lo[a] - tol) & (v[a] <= hi[a] + tol),
                jnp.isfinite(cv[a]) & jnp.where(st[a] == 1, grad[a] >= -tol,
                                                grad[a] <= tol))
            feas = fa if feas is None else feas & fa
        obj = sum(0.5 * v[a] * Quu[a][b] * v[b]
                  for a in range(nu) for b in range(nu)) \
            + sum(Qu[a] * v[a] for a in range(nu))
        return v, K, jnp.where(feas, obj, _BIG)

    def keep_better(best, cand):
        (best_v, best_K, best_obj), (v, K, obj) = best, cand
        better = obj < best_obj
        return ([jnp.where(better, v[a], best_v[a]) for a in range(nu)],
                [[jnp.where(better, K[a][i], best_K[a][i])
                  for i in range(nx)] for a in range(nu)],
                jnp.where(better, obj, best_obj))

    if nu <= 2:
        # <= 9 patterns: unrolled, each with its static closed-form solve
        best = qp_candidate(patterns[0])
        for pat in patterns[1:]:
            best = keep_better(best, qp_candidate(pat))
    else:
        # 27 / 81 patterns: a loop, so the compiled stage stays small
        best = jax.lax.fori_loop(
            1, len(patterns), lambda p, b: keep_better(b, qp_pattern(p)),
            qp_pattern(0))
    kff, K, _ = best

    # ---- step-quality / stationarity increments -----------------------
    dV1_inc = sum(kff[a] * Qu[a] for a in range(nu))
    dV2_inc = sum(0.5 * kff[a] * Quu[a][b] * kff[b]
                  for a in range(nu) for b in range(nu))
    pgmax = None
    for a in range(nu):
        pg = jnp.abs(_min(_max(-Qu[a], lo[a]), hi[a]))
        pgmax = pg if pgmax is None else _max(pgmax, pg)

    # ---- value function update ----------------------------------------
    Quk = [sum(Quu[a][b] * kff[b] for b in range(nu)) for a in range(nu)]
    Vx_n = [Qx[i]
            + sum(K[a][i] * (Quk[a] + Qu[a]) for a in range(nu))
            + sum(Qux[a][i] * kff[a] for a in range(nu))
            for i in range(nx)]
    Vxx_n = [[Qxx[i][j]
              + sum(K[a][i] * Quu[a][b] * K[b][j]
                    for a in range(nu) for b in range(nu))
              + sum(K[a][i] * Qux[a][j] + Qux[a][i] * K[a][j]
                    for a in range(nu))
              for j in range(nx)] for i in range(nx)]
    nxx = nx * nx
    Vxx_sym = [0.5 * (Vxx_n[e // nx][e % nx] + Vxx_n[e % nx][e // nx])
               for e in range(nxx)]
    return kff, K, Vx_n, Vxx_sym, dV1_inc, dV2_inc, pgmax


_STAGE_INPUTS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux",
                 "fxx", "fux", "fuu", "dlb", "dub")


def _make_kernel(nx: int, nu: int, N: int, block: int, use_ddp: bool,
                 tol: float):
    """One program: ``block`` problems through all N stages, last first."""
    nxx = nx * nx
    shape = (block,)

    def kernel(*refs):
        stage = dict(zip(_STAGE_INPUTS, refs[:12]))
        gN, HN, reg, ddpf = refs[12:16]
        kff_o, K_o, dV1_o, dV2_o, gmax_o = refs[16:]
        rg = reg[...]
        ds = ddpf[...]

        def body(t, carry):
            Vx, Vxx, acc = carry
            k = N - 1 - t

            def E(name, e):
                return stage[name][k, e]

            kff, K, Vx, Vxx, dV1_inc, dV2_inc, pgmax = _backward_stage(
                nx, nu, use_ddp, tol, shape, E, Vx, Vxx, rg, ds)
            for a in range(nu):
                kff_o[k, a] = kff[a]
                for i in range(nx):
                    K_o[k, a * nx + i] = K[a][i]
            acc = (acc[0] + dV1_inc, acc[1] + dV2_inc,
                   _max(acc[2], pgmax))
            return tuple(Vx), tuple(Vxx), acc

        z = jnp.zeros(shape, jnp.float32)
        init = (tuple(gN[i] for i in range(nx)),
                tuple(HN[e] for e in range(nxx)), (z, z, z))
        _, _, acc = jax.lax.fori_loop(0, N, body, init)
        dV1_o[...] = acc[0]
        dV2_o[...] = acc[1]
        gmax_o[...] = acc[2]

    return kernel


@functools.partial(jax.jit, static_argnames=("nx", "nu", "use_ddp", "tol",
                                             "interpret"))
def riccati_backward_pallas(derivs: Dict[str, jnp.ndarray], dlb, dub, gN, HN,
                            reg, ddp_scale=None, *, nx: int, nu: int,
                            use_ddp: bool = True, tol: float = 1e-8,
                            interpret: bool = False):
    """Batched box-constrained Riccati backward pass (Triton route).

    Args:
      derivs: dict of (B, N, ...) stage derivatives (fx, fu, lx, lu, lxx,
        luu, lux [, fxx, fux, fuu]).
      dlb, dub: (B, N, nu) delta-control bounds (lb - u_nom, ub - u_nom).
      gN, HN: (B, nx), (B, nx, nx) terminal value gradient/Hessian.
      reg: (B,) per-problem Levenberg regularization added to Quu.
      ddp_scale: optional (B,) per-problem second-order on/off scale.
      nx, nu: static dims (nu <= 4).
      interpret: run the kernel in the Pallas interpreter (no GPU needed).

    Returns (kff (B, N, nu), K (B, N, nu, nx), dV1 (B,), dV2 (B,), gmax (B,)).

    B is padded internally to a multiple of ``BLOCK`` problems, the
    power-of-two batch of one program (``NUM_WARPS`` warps).
    """
    if nu > 4:
        raise NotImplementedError(
            "the Riccati kernel supports nu <= 4 (3^nu active-set "
            "enumeration); use backend='xla' (any nu) for wider control "
            "vectors")
    B0, N = derivs["fx"].shape[0], derivs["fx"].shape[1]
    B = -(-B0 // BLOCK) * BLOCK

    def soa(x, entries):
        """(B0, N, ...) -> (N, entries, B): problems on the minor axis."""
        x = x.astype(jnp.float32).reshape(B0, N, entries)
        return jnp.pad(x, ((0, B - B0), (0, 0), (0, 0))).transpose(1, 2, 0)

    def per_problem(x, entries, fill=0.0):
        """(B0, ...) -> (entries, B)."""
        x = x.astype(jnp.float32).reshape(B0, entries)
        return jnp.pad(x, ((0, B - B0), (0, 0)),
                       constant_values=fill).T

    nxx = nx * nx
    ddp_e = (nx * nxx, nx * nu * nx, nx * nu * nu) if use_ddp else (1, 1, 1)
    entries = (nxx, nx * nu, nx, nu, nxx, nu * nu, nu * nx) + ddp_e \
        + (nu, nu)
    if use_ddp:
        stage_in = [derivs[n] for n in _STAGE_INPUTS[:10]]
    else:
        z = jnp.zeros((B0, N, 1), jnp.float32)
        stage_in = [derivs[n] for n in _STAGE_INPUTS[:7]] + [z, z, z]
    stage_in += [dlb, dub]
    if ddp_scale is None:
        ddp_scale = jnp.ones((B0,), jnp.float32)
    # padded problems get reg = 1 so their (discarded) lanes stay finite
    args = [soa(x, e) for x, e in zip(stage_in, entries)] + [
        per_problem(gN, nx), per_problem(HN, nxx),
        per_problem(reg, 1, fill=1.0)[0], per_problem(ddp_scale, 1)[0]]

    def stage_spec(e):
        return pl.BlockSpec((N, e, BLOCK), lambda g: (0, 0, g))

    def static_spec(e):
        return pl.BlockSpec((e, BLOCK), lambda g: (0, g))

    vec_spec = pl.BlockSpec((BLOCK,), lambda g: (g,))
    in_specs = ([stage_spec(e) for e in entries]
                + [static_spec(nx), static_spec(nxx), vec_spec, vec_spec])
    out_specs = [stage_spec(nu), stage_spec(nu * nx),
                 vec_spec, vec_spec, vec_spec]
    out_shape = [
        jax.ShapeDtypeStruct((N, nu, B), jnp.float32),
        jax.ShapeDtypeStruct((N, nu * nx, B), jnp.float32),
        jax.ShapeDtypeStruct((B,), jnp.float32),
        jax.ShapeDtypeStruct((B,), jnp.float32),
        jax.ShapeDtypeStruct((B,), jnp.float32),
    ]
    kff_t, K_t, dV1, dV2, gmax = pl.pallas_call(
        _make_kernel(nx, nu, N, BLOCK, use_ddp, tol),
        grid=(B // BLOCK,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(num_warps=NUM_WARPS,
                                                    num_stages=2),
        interpret=interpret,
        name="riccati_backward",
    )(*args)

    kff = kff_t.transpose(2, 0, 1)[:B0]
    K = K_t.transpose(2, 0, 1)[:B0].reshape(B0, N, nu, nx)
    return kff, K, dV1[:B0], dV2[:B0], gmax[:B0]
