"""Condensed linear-MPC QP: the classical dense treatment, batched.

The reference's linear families solve their MPC steps as sparse QPs through
``mpc.nmpc(..., isQP=True)`` (the inverted pendulum,
``Inverted_pendulum/inverted_pendulum_single_shooting_mpctools.py:64``) or as
repeatedly rebuilt LTI/LTV problems (``Trajectory Tracking/*``).  The
framework's DDP path already solves these exactly (an LQ problem is one
Riccati pass); this module adds the *condensed* formulation — eliminate the
states, optimize over the (move-blocked) control moves only — because it maps
well onto an accelerator:

  * condensation is pure matrix algebra: ``x = Sx x0 + Su U`` with prediction
    matrices built once per (A, B, N); the Hessian ``H = Su'Q̄Su + R̄`` and
    gradient are batched GEMMs;
  * move blocking (``Ntu`` free moves, the pendulum's Du pinning at
    :34-42) is a column-blocking matrix folded into ``Su`` — the QP shrinks
    to ``Ntu*nu`` variables;
  * the box QP is solved exactly by Bertsekas projected-Newton active-set
    iteration — shape-static, batched over problems, finite termination
    (the active set is monotone-refined from the projected gradient).

For LTV problems, pass stage-varying ``(A_t, B_t)`` stacks; the prediction
matrices are built by a scan and remain data, so one jitted solver serves a
whole re-linearized closed loop (no per-step rebuilds — the anti-pattern of
``Trjectory_tracking_le_LTV.py:130-146``).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp


def blocking_matrix(N: int, Ntu: int, dtype=jnp.float32):
    """(N, Ntu) move-blocking matrix: u_k = U_min(k, Ntu-1).

    Columns distribute the Ntu free moves over the N-stage horizon with the
    last move held for the tail — exactly the reference's "Du pinned to zero
    after Ntu" semantics (``Inverted_pendulum/...mpctools.py:34-42``).
    """
    ks = jnp.arange(N)
    js = jnp.arange(Ntu)
    hold = jnp.minimum(ks, Ntu - 1)
    return (hold[:, None] == js[None, :]).astype(dtype)


def prediction_matrices(A, B, N: int):
    """Sx (N, nx, nx), Su (N, N, nu->...) for x_{k+1} = A_k x_k + B_k u_k.

    ``A``: (nx, nx) LTI or (N, nx, nx) LTV; ``B``: (nx, nu) or (N, nx, nu).
    Returns stacked predictions for x_1..x_N:
      x_{k+1} = Sx[k] @ x0 + sum_j Su[k, j] @ u_j   (Su[k, j] = 0 for j > k).
    Built with a scan over stages — O(N) matmuls, data not recompilation.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    nx = A.shape[-1]
    nu = B.shape[-1]
    if A.ndim == 2:
        A = jnp.broadcast_to(A, (N, nx, nx))
    if B.ndim == 2:
        B = jnp.broadcast_to(B, (N, nx, nu))

    def step(carry, AB):
        Phi, Gamma = carry          # Phi: (nx, nx) = prod A; Gamma: (N, nx, nu)
        Ak, Bk, k = AB
        Phi_n = Ak @ Phi
        Gamma_n = jnp.einsum("ij,njk->nik", Ak, Gamma)
        Gamma_n = Gamma_n.at[k].set(Bk)
        return (Phi_n, Gamma_n), (Phi_n, Gamma_n)

    Phi0 = jnp.eye(nx, dtype=A.dtype)
    Gamma0 = jnp.zeros((N, nx, nu), dtype=A.dtype)
    _, (Sx, Su) = jax.lax.scan(step, (Phi0, Gamma0),
                               (A, B, jnp.arange(N)))
    # Sx: (N, nx, nx); Su: (N, N, nx, nu) with Su[k, j] the j->k+1 map
    return Sx, Su


def condense(A, B, Q, R, N: int, QN=None, Ntu: Optional[int] = None,
             du_weight: float = 0.0):
    """Build the condensed QP data for a linear-quadratic MPC step.

    Cost: sum_{k=1..N} (x_k - xref_k)'Q(x_k - xref_k)
          + sum_{k=0..N-1} (u_k - uref_k)'R(u_k - uref_k)
          + du_weight * sum ||u_k - u_{k-1}||^2   (u_{-1} = u_prev)
    with x_N weighted by ``QN`` (defaults to Q) and controls move-blocked to
    ``Ntu`` free moves (default N).

    Returns a dict of static matrices; feed to :func:`solve_condensed`.
    """
    A = jnp.asarray(A)
    Q = jnp.asarray(Q)
    R = jnp.asarray(R)
    nx = A.shape[-1]
    nu = jnp.asarray(B).shape[-1]
    if QN is None:
        QN = Q
    Ntu = N if Ntu is None else Ntu

    Sx, Su = prediction_matrices(A, B, N)
    Tm = blocking_matrix(N, Ntu, dtype=Sx.dtype)       # (N, Ntu)
    # fold blocking into Su: Sub[k, m] = sum_j Su[k, j] * T[j, m]
    Sub = jnp.einsum("kjxu,jm->kmxu", Su, Tm)           # (N, Ntu, nx, nu)
    Qbar = jnp.concatenate(
        [jnp.broadcast_to(Q, (N - 1, nx, nx)), jnp.asarray(QN)[None]], axis=0)

    # H_uu = sum_k Sub[k]' Qbar[k] Sub[k]  -> (Ntu, nu, Ntu, nu)
    H = jnp.einsum("kmxu,kxy,knyv->munv", Sub, Qbar, Sub)
    # control cost: R on every stage; blocking makes T'T = diag(stage counts)
    w = Tm.sum(axis=0)                                  # (Ntu,) stage counts
    H = H + jnp.einsum("mn,m,uv->munv", jnp.eye(Ntu, dtype=Sx.dtype), w, R)
    # Delta-u cost: D = first-difference over the FREE moves (blocked tail
    # has du = 0 internally); u_prev enters the gradient
    if du_weight > 0.0:
        D = (jnp.eye(Ntu, dtype=Sx.dtype)
             - jnp.eye(Ntu, k=-1, dtype=Sx.dtype))      # (Ntu, Ntu)
        DtD = D.T @ D
        H = H + du_weight * jnp.einsum(
            "mn,uv->munv", DtD, jnp.eye(nu, dtype=Sx.dtype))

    n = Ntu * nu
    return dict(Sx=Sx, Sub=Sub, Qbar=Qbar, R=R, Tm=Tm, H=H.reshape(n, n),
                N=N, Ntu=Ntu, nx=nx, nu=nu, du_weight=du_weight, w=w)


def _proj(v, lb, ub):
    return jnp.clip(v, lb, ub)


@partial(jax.jit, static_argnames=("max_iters",))
def solve_dense_boxqp(H, g, lb, ub, max_iters: int = 30, tol: float = 1e-10):
    """Exact dense box QP by Bertsekas projected Newton (batched, jittable).

    min 0.5 v'Hv + g'v  s.t.  lb <= v <= ub, H positive definite.  All of
    (H, g, lb, ub) may carry leading batch axes.  Finite termination: the
    working set comes from the projected gradient at the current feasible
    point; free-subspace Newton steps are projected and accepted by an
    Armijo backtracking on the quadratic (evaluated exactly).
    """
    n = H.shape[-1]

    def solve_one(H, g, lb, ub):
        v0 = _proj(jnp.zeros_like(g), lb, ub)

        def body(carry):
            v, it, done = carry
            grad = H @ v + g
            # binding set: at a bound with gradient pushing outward
            at_lo = (v <= lb + 1e-12) & (grad > 0)
            at_up = (v >= ub - 1e-12) & (grad < 0)
            free = ~(at_lo | at_up)
            m = free.astype(v.dtype)
            Hf = m[:, None] * H * m[None, :] + jnp.diag(1.0 - m)
            step = -jnp.linalg.solve(Hf, m * grad)
            # projected line search on the quadratic (exact evaluation)
            def q(z):
                return 0.5 * z @ H @ z + g @ z
            alphas = 0.5 ** jnp.arange(12, dtype=v.dtype)
            cands = jax.vmap(lambda a: _proj(v + a * step, lb, ub))(alphas)
            qs = jax.vmap(q)(cands)
            best = jnp.argmin(qs)
            v_new = cands[best]
            improved = qs[best] < q(v) - 1e-15
            # converged: projected gradient ~ 0
            pg = jnp.where(free, grad,
                           jnp.where(at_lo, jnp.minimum(grad, 0.0),
                                     jnp.maximum(grad, 0.0)))
            done_n = (jnp.max(jnp.abs(pg)) < tol) | ~improved
            return (jnp.where(done, v, v_new), it + 1, done | done_n)

        def cond(carry):
            v, it, done = carry
            return (it < max_iters) & ~done

        v, it, done = jax.lax.while_loop(
            cond, body, (v0, jnp.zeros((), jnp.int32), jnp.zeros((), bool)))
        return v

    batch_dims = H.ndim - 2
    f = solve_one
    for _ in range(batch_dims):
        f = jax.vmap(f)
    lb = jnp.broadcast_to(lb, g.shape)
    ub = jnp.broadcast_to(ub, g.shape)
    return f(H, g, lb, ub)


def solve_condensed(data, x0, xref, uref=None, u_prev=None,
                    u_lb=None, u_ub=None, max_iters: int = 30):
    """Solve one condensed MPC step; batched over a leading axis of ``x0``.

    Args:
      data: output of :func:`condense`.
      x0: (nx,) or (B, nx) current state(s).
      xref: (N, nx) or (B, N, nx) state reference for stages 1..N.
      uref: optional (N, nu)/(B, N, nu) control reference.
      u_prev: optional (nu,)/(B, nu) previous control for the Delta-u cost.
      u_lb/u_ub: optional (nu,) control box (broadcast over moves).

    Returns (us (B?, N, nu) expanded over the blocking, Ufree (B?, Ntu*nu)).
    """
    Sub, Sx, Qbar = data["Sub"], data["Sx"], data["Qbar"]
    Tm, H = data["Tm"], data["H"]
    N, Ntu, nx, nu = data["N"], data["Ntu"], data["nx"], data["nu"]
    R, w, du_w = data["R"], data["w"], data["du_weight"]

    x0 = jnp.asarray(x0)
    squeeze = x0.ndim == 1
    if squeeze:
        x0 = x0[None]
    B = x0.shape[0]
    xref = jnp.broadcast_to(jnp.asarray(xref), (B, N, nx))
    if uref is None:
        uref = jnp.zeros((B, N, nu), x0.dtype)
    else:
        uref = jnp.broadcast_to(jnp.asarray(uref), (B, N, nu))
    if u_prev is None:
        u_prev = jnp.zeros((B, nu), x0.dtype)
    else:
        u_prev = jnp.broadcast_to(jnp.asarray(u_prev), (B, nu))

    # error of the zero-control prediction: e_k = Sx[k] x0 - xref_k
    e = jnp.einsum("kxy,by->bkx", Sx, x0) - xref        # (B, N, nx)
    g = jnp.einsum("kmxu,kxy,bky->bmu", Sub, Qbar, e)   # (B, Ntu, nu)
    # control-reference gradient: -R uref summed per blocked move
    g = g - jnp.einsum("km,bku->bmu", Tm, jnp.einsum("uv,bkv->bku", R, uref))
    if du_w > 0.0:
        gp = jnp.zeros((B, Ntu, nu), x0.dtype).at[:, 0].set(-du_w * u_prev)
        g = g + gp
    g = g.reshape(B, Ntu * nu)

    big = jnp.asarray(1e30, x0.dtype)
    lb = (jnp.broadcast_to(jnp.asarray(u_lb), (Ntu, nu)).reshape(-1)
          if u_lb is not None else jnp.full((Ntu * nu,), -big))
    ub = (jnp.broadcast_to(jnp.asarray(u_ub), (Ntu, nu)).reshape(-1)
          if u_ub is not None else jnp.full((Ntu * nu,), big))

    Hb = jnp.broadcast_to(H, (B,) + H.shape)
    U = solve_dense_boxqp(Hb, g, lb[None], ub[None], max_iters=max_iters)
    Uf = U.reshape(B, Ntu, nu)
    us = jnp.einsum("km,bmu->bku", Tm, Uf)              # expand blocking
    if squeeze:
        return us[0], U[0]
    return us, U
