"""Parallel-in-horizon Riccati: associative-scan LQT backward pass.

SURVEY.md §2.4/§5.7 names stage-parallel Riccati as the long-horizon analogue
of sequence parallelism (PAPERS.md: "The Parallelization of Riccati
Recursion").  The sequential backward pass is O(N) depth; for horizons in the
thousands that dominates latency.  This module implements the
temporal-parallelization formulation (Särkkä & García-Fernández-style
five-tuple elements) so the whole backward pass runs in O(log N) depth under
``jax.lax.associative_scan``.

Problem class: linear-quadratic tracking (LQT)

    x_{k+1} = F_k x_k + c_k + L_k u_k
    cost    = sum_k 1/2 (x_k - r_k)' X_k (x_k - r_k) + 1/2 u_k' U_k u_k
              + 1/2 (x_N - r_N)' X_N (x_N - r_N)

General LQ subproblems (linear control cost, Qux cross terms) reduce to this
form by completing the square in u; box constraints are not handled here —
this is the unconstrained long-horizon engine (use the DDP solvers for
constrained problems at moderate N).

Each element e = (A, b, C, eta, J) represents the conditional value function
between two times; composition of adjacent spans is the associative rule

    A = A_j (I + C_i J_j)^{-1} A_i
    b = A_j (I + C_i J_j)^{-1} (b_i + C_i eta_j) + b_j
    C = A_j (I + C_i J_j)^{-1} C_i A_j' + C_j
    eta = A_i' (I + J_j C_i)^{-1} (eta_j - J_j b_i) + eta_i
    J = A_i' (I + J_j C_i)^{-1} J_j A_i + J_i

and a reverse scan yields the value function V_k(x) = 1/2 x'J_k x - eta_k'x
at every stage simultaneously; gains then come from one batched (parallel
over k) stage solve.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LQTElement(NamedTuple):
    A: jnp.ndarray    # (..., nx, nx)
    b: jnp.ndarray    # (..., nx)
    C: jnp.ndarray    # (..., nx, nx)
    eta: jnp.ndarray  # (..., nx)
    J: jnp.ndarray    # (..., nx, nx)


def _assoc_scan(fn, elems):
    """Inclusive prefix combine over the leading axis.

    Drop-in for ``jax.lax.associative_scan(fn, elems)``; ``fn(left,
    right)`` with left spanning earlier stages (the lax orientation).
    Two code paths:

      * parallel Hillis-Steele doubling (log2 N levels of shift +
        full-width combine + mask) — the deployment form: O(log N)
        sequential depth, O(N log N) combines (vs the recursive lax
        form's O(N) — noise at these element sizes);
      * a sequential ``lax.scan`` fold on the CPU x64 path ONLY, because
        this image's XLA:CPU backend miscompiles BOTH parallel
        formulations of this prefix in f64 (the lax form corrupts the
        glibc heap at compile time ~50%/process; the doubling form
        sporadically computes its deepest level wrong) while every
        sequential-scan f64 program and all f32 programs compile clean —
        measured, minimized, and recorded in docs/design.md "The x64
        associative-scan miscompile".  The fold runs the IDENTICAL
        combine, so f64 parity tests verify the same algebra.

    In the doubling path, combines are evaluated on garbage rows for
    k < d and masked out — safe because ``jnp.where`` selects values,
    and no gradient flows through this path.
    """
    leaves = jax.tree_util.tree_leaves(elems)
    n = leaves[0].shape[0]
    import numpy as _np

    if leaves[0].dtype == jnp.float64 and jax.default_backend() == "cpu":
        # The CPU x64 verification path folds SEQUENTIALLY.  Round-5
        # measurement: on this image, XLA:CPU miscompiles BOTH parallel
        # formulations of this prefix in f64 — the lax form corrupts the
        # heap at compile time (~50%/process), and the doubling form
        # (with or without per-level optimization_barrier fences)
        # sporadically computes the deepest level wrong (~10-40% of
        # compiles, ~0.1-scale errors in the earliest stages) — while
        # the f32 programs and every sequential-scan program in the
        # suite compile clean.  The fold below runs the IDENTICAL
        # five-tuple combine through ``lax.scan`` (the toolchain's
        # reliable path), so the f64 parity tests still verify the
        # element algebra exactly; only the depth bound changes, on a
        # path whose purpose is verification, not speed.  The parallel
        # doubling form below serves f32 and every non-CPU backend (the
        # deployment path: GPU, f32).  Full record in docs/design.md
        # "The x64 associative-scan miscompile".
        first = jax.tree_util.tree_map(lambda a: a[0], elems)
        rest = jax.tree_util.tree_map(lambda a: a[1:], elems)

        def step(carry, x):
            new = fn(carry, x)
            return new, new

        _, tail = jax.lax.scan(step, first, rest)
        return jax.tree_util.tree_map(
            lambda f0, r: jnp.concatenate([f0[None], r], axis=0),
            first, tail)

    acc = elems
    d = 1
    while d < n:
        shifted = jax.tree_util.tree_map(
            lambda a: jnp.concatenate([a[:d], a[:-d]], axis=0), acc)
        comb = fn(shifted, acc)
        mask = _np.arange(n) >= d
        acc = jax.tree_util.tree_map(
            lambda c, a: jnp.where(
                mask.reshape((n,) + (1,) * (a.ndim - 1)), c, a),
            comb, acc)
        d *= 2
    return acc


def _combine(ei: LQTElement, ej: LQTElement) -> LQTElement:
    """Associative composition: element i spans earlier stages than j."""
    nx = ei.A.shape[-1]
    I = jnp.eye(nx, dtype=ei.A.dtype)
    # (I + C_i J_j)^{-1}; with C and J symmetric, (I + J_j C_i)^{-1} is its
    # transpose — one solve serves both (this runs O(N log N) times)
    M = I + ei.C @ ej.J
    Minv = jnp.linalg.solve(M, I)
    Mtinv = jnp.swapaxes(Minv, -1, -2)

    A = ej.A @ Minv @ ei.A
    b = (ej.A @ Minv @ (ei.b[..., None] + ei.C @ ej.eta[..., None]))[..., 0] + ej.b
    C = ej.A @ Minv @ ei.C @ jnp.swapaxes(ej.A, -1, -2) + ej.C
    eta = (jnp.swapaxes(ei.A, -1, -2) @ Mtinv
           @ (ej.eta[..., None] - ej.J @ ei.b[..., None]))[..., 0] + ei.eta
    J = (jnp.swapaxes(ei.A, -1, -2) @ Mtinv @ ej.J @ ei.A) + ei.J
    return LQTElement(A, b, C, eta, J)


def lqt_backward_parallel(Fs, cs, Ls, Xs, rs, Us, XN, rN):
    """O(log N)-depth LQT backward pass.

    Args (stage-stacked, leading dim N):
      Fs (N, nx, nx), cs (N, nx), Ls (N, nx, nu): dynamics.
      Xs (N, nx, nx), rs (N, nx): state tracking cost per stage.
      Us (N, nu, nu): control cost.
      XN (nx, nx), rN (nx): terminal cost.

    Returns (Js, etas): value function V_k(x) = 1/2 x'J_k x - eta_k'x for
    k = 0..N (stacked N+1).
    """
    N, nx = Fs.shape[0], Fs.shape[-1]
    Uinv = jnp.linalg.solve(Us, jnp.broadcast_to(jnp.eye(Ls.shape[-1],
                                                         dtype=Ls.dtype),
                                                 Us.shape))
    Cs = Ls @ Uinv @ jnp.swapaxes(Ls, -1, -2)
    etas = (Xs @ rs[..., None])[..., 0]

    elems = LQTElement(A=Fs, b=cs, C=Cs, eta=etas, J=Xs)
    # terminal boundary element
    zerom = jnp.zeros((1, nx, nx), dtype=Fs.dtype)
    zerov = jnp.zeros((1, nx), dtype=Fs.dtype)
    term = LQTElement(A=zerom, b=zerov, C=zerom,
                      eta=(XN @ rN)[None], J=XN[None])
    elems = jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a, t], axis=0), elems, term)

    # reverse associative scan: result[k] spans stages k..N
    rev = jax.tree_util.tree_map(lambda a: jnp.flip(a, axis=0), elems)
    acc = _assoc_scan(
        lambda a, b: _combine(b, a), rev)  # note flipped order
    out = jax.tree_util.tree_map(lambda a: jnp.flip(a, axis=0), acc)
    return out.J, out.eta


def lqt_gains(Fs, cs, Ls, Us, Js, etas):
    """Per-stage affine control laws from the scanned value functions.

    u_k*(x) = -K_k x + k_k with
      S_k = U_k + L' J_{k+1} L
      K_k = S^{-1} L' J_{k+1} F
      k_k = S^{-1} L' (eta_{k+1} - J_{k+1} c_k)

    All stages evaluated in parallel (one batched solve).
    """
    Jn = Js[1:]
    en = etas[1:]
    Lt = jnp.swapaxes(Ls, -1, -2)
    S = Us + Lt @ Jn @ Ls
    K = jnp.linalg.solve(S, Lt @ Jn @ Fs)
    k = jnp.linalg.solve(
        S, (Lt @ (en[..., None] - Jn @ cs[..., None])))[..., 0]
    return K, k


def lq_backward_parallel(fxs, fus, lxs, lus, lxxs, luus, luxs, gN, HN, reg):
    """General-LQ backward pass in O(log N) depth — the DDP solvers'
    ``backend="scan"`` engine (long-horizon mode, SURVEY.md §2.4/§5.7).

    Solves the per-iteration LQ (Gauss-Newton) subproblem

        min sum_k lx'dx + lu'du + 1/2 dx'lxx dx + 1/2 du'luu du + du'lux dx
            + gN'dx_N + 1/2 dx_N' HN dx_N
        s.t. dx_{k+1} = fx dx_k + fu du_k,  dx_0 = 0

    by completing the square in du (eliminating the cross/linear control
    terms), running the associative-scan value-function recursion of
    ``lqt_backward_parallel`` (generalized to a direct (J, eta) element
    init), and recovering the affine stage policies.  Returns the sequential
    backward pass's exact contract:

        (kffs (N, nu), Ks (N, nu, nx), dV1, dV2, gmax)

    with du_k = kff_k + K_k dx_k, dV1/dV2 the expected-improvement terms
    sum kff'Qu / 0.5 sum kff'Quu kff, and gmax = max |Qu| (stationarity;
    controls are unbounded here — compose box constraints via the AL/IPM
    outer loops, or use the sequential backends for exact stage box QPs).

    ``reg`` is the Levenberg parameter added to luu (matching the
    sequential pass's Quu regularization).
    """
    N, nx = fxs.shape[0], fxs.shape[-1]
    nu = fus.shape[-1]
    dt = fxs.dtype
    I_u = jnp.eye(nu, dtype=dt)

    Luu = luus + reg * I_u
    luxT = jnp.swapaxes(luxs, -1, -2)
    sol = jnp.linalg.solve(
        Luu, jnp.concatenate([lus[..., None], luxs, jnp.swapaxes(fus, -1, -2)],
                             axis=-1))
    Li_lu = sol[..., 0]                      # Luu^{-1} lu        (N, nu)
    Li_lux = sol[..., 1:1 + nx]              # Luu^{-1} lux       (N, nu, nx)
    Li_fuT = sol[..., 1 + nx:]               # Luu^{-1} fu'       (N, nu, nx)

    # du = w - Luu^{-1}(lu + lux dx):  dynamics and cost in (dx, w)
    F = fxs - fus @ Li_lux
    c = -(fus @ Li_lu[..., None])[..., 0]
    Cs = fus @ Li_fuT                        # fu Luu^{-1} fu'
    X = lxxs - luxT @ Li_lux
    X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
    q = lxs - (luxT @ Li_lu[..., None])[..., 0]

    elems = LQTElement(A=F, b=c, C=Cs, eta=-q, J=X)
    term = LQTElement(A=jnp.zeros((1, nx, nx), dt), b=jnp.zeros((1, nx), dt),
                      C=jnp.zeros((1, nx, nx), dt), eta=-gN[None], J=HN[None])
    elems = jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a, t], axis=0), elems, term)
    rev = jax.tree_util.tree_map(lambda a: jnp.flip(a, axis=0), elems)
    acc = _assoc_scan(lambda a, b: _combine(b, a), rev)
    out = jax.tree_util.tree_map(lambda a: jnp.flip(a, axis=0), acc)
    Js, etas = out.J, out.eta

    # stage policies in w, then back-substitute to du
    Jn, en = Js[1:], etas[1:]
    fuT = jnp.swapaxes(fus, -1, -2)
    S = Luu + fuT @ Jn @ fus                 # == Quu at the nominal
    S = 0.5 * (S + jnp.swapaxes(S, -1, -2))
    rhs = jnp.concatenate(
        [(fuT @ (en[..., None] - Jn @ c[..., None])), fuT @ Jn @ F], axis=-1)
    sol2 = jnp.linalg.solve(S, rhs)
    kw = sol2[..., 0]
    Kw = sol2[..., 1:]
    kffs = kw - Li_lu
    Ks = -(Kw + Li_lux)

    # DDP-contract diagnostics at the nominal (dx = 0): Vx_{k+1} = -eta_{k+1}
    Qu = lus - (fuT @ en[..., None])[..., 0]
    dV1 = jnp.sum(kffs * Qu)
    dV2 = 0.5 * jnp.sum(kffs[..., None, :] @ S @ kffs[..., None])
    gmax = jnp.max(jnp.abs(Qu))
    return kffs, Ks, dV1, dV2, gmax


def lqt_solve_parallel(x0, Fs, cs, Ls, Xs, rs, Us, XN, rN):
    """Full parallel LQT solve: O(log N) backward + sequential rollout.

    Returns (xs (N+1, nx), us (N, nu)).
    """
    Js, etas = lqt_backward_parallel(Fs, cs, Ls, Xs, rs, Us, XN, rN)
    K, kff = lqt_gains(Fs, cs, Ls, Us, Js, etas)

    def step(x, inp):
        F, c, L, Kk, kk = inp
        u = kk - Kk @ x
        return F @ x + c + L @ u, (x, u)

    xN, (xs, us) = jax.lax.scan(step, x0, (Fs, cs, Ls, K, kff))
    xs = jnp.concatenate([xs, xN[None]], axis=0)
    return xs, us
