"""General NLP solver: augmented Lagrangian + box-projected Newton.

The JAX replacement for the *generic* entry point of the reference's
solver stack — ``ca.nlpsol('solver', 'ipopt', {'f','x','g','p'}, opts)``
(``Casadi/single_shooting_v1.py:131``, ``Casadi/multiple_shooting_casadi.py:197``)
— for problems that are NOT expressed in optimal-control form.  (OCP-shaped
problems should use the structured ``solver/ilqr.py`` / ``multiple_shooting.py``
paths, which exploit the stage structure; this solver is the dense fallback
that makes hand-rolled NLP scripts portable, and the backend of
``compat.casadi.nlpsol``.)

Formulation solved:

    min_x  f(x, p)   s.t.  lbx <= x <= ubx,  lbg <= g(x, p) <= ubg

* General ``g`` bounds are handled by a Powell-Hestenes-Rockafellar
  augmented Lagrangian: each one-sided constraint contributes
  ``(1/2mu) (max(0, lam + mu*c)^2 - lam^2)``; an equality row
  (``lbg == ubg``) gets both sides and reduces to the classic
  multiplier-plus-quadratic-penalty term.
* The box on ``x`` is kept exact inside the inner solver: a projected
  Newton iteration with an active-set mask (clamped coordinates are frozen,
  the Newton system is solved on the free subspace via masked assembly — the
  same trick as ``solver/boxqp.py`` but at NLP scale), Levenberg
  regularization adapted on rejection, and a vmapped parallel backtracking
  line search.
* Derivatives are JAX autodiff (gradient + dense Hessian via
  forward-over-reverse), replacing CasADi's symbolic Jacobians/Hessians
  (SURVEY.md §2.3).  Dense Newton is the right call at reference scale
  (n <= a few hundred decision vars).

Everything is shape-static (``lax.while_loop`` control flow), so one ``jit``
covers the solve and ``jax.vmap`` batches independent problem instances —
the axis the reference's serial scripts never had.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class NLPOptions:
    """Static configuration (hashable; closed over by the jitted solve)."""

    max_outer: int = 25           # augmented-Lagrangian rounds
    max_inner: int = 60           # projected-Newton iterations per round
    tol: float = 1e-8             # projected-gradient (KKT) tolerance
    tol_con: float = 1e-8         # constraint-violation tolerance
    mu0: float = 10.0             # initial AL penalty
    mu_factor: float = 10.0       # escalation when violation stalls
    mu_max: float = 1e8
    viol_decrease: float = 0.25   # required per-round violation contraction
    reg_init: float = 1e-8
    reg_up: float = 10.0
    reg_down: float = 5.0
    reg_min: float = 1e-10
    reg_max: float = 1e10
    n_alphas: int = 16
    alpha_decay: float = 0.5
    active_tol: float = 1e-9      # bound-activity detection width


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NLPResult:
    x: jnp.ndarray            # (n,) primal solution
    f: jnp.ndarray            # objective at x
    g: jnp.ndarray            # (m,) constraint values at x
    lam_g: jnp.ndarray        # (m,) multiplier estimate (lamU - lamL)
    kkt: jnp.ndarray          # projected-gradient inf-norm of the Lagrangian
    viol: jnp.ndarray         # constraint violation inf-norm
    iterations: jnp.ndarray   # total inner Newton iterations
    converged: jnp.ndarray    # bool


def make_nlpsol(f: Callable, g: Optional[Callable], n: int, m: int,
                options: NLPOptions = NLPOptions()):
    """Build ``solve(x0, p, lbx, ubx, lbg, ubg) -> NLPResult`` (jittable).

    Args:
      f: objective ``f(x, p) -> scalar``.
      g: constraints ``g(x, p) -> (m,)`` or None (m must then be 0).
      n, m: static sizes of x and g.

    The returned solve takes all bounds as data; ±inf entries disable the
    respective side.  ``vmap``/``jit`` freely.
    """
    opt = options
    if g is None:
        g = lambda x, p: jnp.zeros((0,), dtype=x.dtype)

    def al_value(x, p, lamL, lamU, mu, lbg, ubg):
        """PHR augmented Lagrangian (box on x handled by projection)."""
        gv = g(x, p)
        cl = jnp.where(jnp.isfinite(lbg), lbg - gv, -1.0)   # <= 0 feasible
        cu = jnp.where(jnp.isfinite(ubg), gv - ubg, -1.0)
        tL = jnp.maximum(0.0, lamL + mu * cl)
        tU = jnp.maximum(0.0, lamU + mu * cu)
        pen = jnp.sum(tL ** 2 - lamL ** 2) + jnp.sum(tU ** 2 - lamU ** 2)
        return f(x, p) + pen / (2.0 * mu)

    al_grad = jax.grad(al_value)
    al_hess = jax.jacfwd(al_grad)

    alphas = opt.alpha_decay ** jnp.arange(opt.n_alphas)

    def inner_solve(x, p, lamL, lamU, mu, lbx, ubx, lbg, ubg, tol_inner):
        """Projected Newton on the AL within [lbx, ubx]."""

        def pg_norm(x, grad):
            pg = x - jnp.clip(x - grad, lbx, ubx)
            return jnp.max(jnp.abs(pg))

        def cond(c):
            x, reg, it, done = c
            return jnp.logical_and(it < opt.max_inner, jnp.logical_not(done))

        def body(c):
            x, reg, it, done = c
            L0 = al_value(x, p, lamL, lamU, mu, lbg, ubg)
            grad = al_grad(x, p, lamL, lamU, mu, lbg, ubg)
            H = al_hess(x, p, lamL, lamU, mu, lbg, ubg)

            at_lo = (x <= lbx + opt.active_tol) & (grad > 0)
            at_hi = (x >= ubx - opt.active_tol) & (grad < 0)
            free = jnp.logical_not(at_lo | at_hi).astype(x.dtype)

            # masked Newton system: clamped coords get identity rows
            Hm = (free[:, None] * H * free[None, :]
                  + jnp.diag(1.0 - free)
                  + reg * jnp.eye(n, dtype=x.dtype))
            d = -free * jnp.linalg.solve(Hm, free * grad)

            xc = jnp.clip(x[None] + alphas[:, None] * d[None], lbx, ubx)
            Lc = jax.vmap(
                lambda xx: al_value(xx, p, lamL, lamU, mu, lbg, ubg))(xc)
            best = jnp.argmin(Lc)
            x_new, L_new = xc[best], Lc[best]
            improved = L_new < L0 - 1e-16

            x_n = jnp.where(improved, x_new, x)
            reg_n = jnp.where(improved,
                              jnp.maximum(reg / opt.reg_down, opt.reg_min),
                              jnp.minimum(reg * opt.reg_up, opt.reg_max))
            g_n = al_grad(x_n, p, lamL, lamU, mu, lbg, ubg)
            done_n = ((pg_norm(x_n, g_n) < tol_inner)
                      | (~improved & (reg >= opt.reg_max)))
            return (x_n, reg_n, it + 1, done_n)

        x0c = jnp.clip(x, lbx, ubx)
        x_f, _, it_f, _ = jax.lax.while_loop(
            cond, body, (x0c, jnp.asarray(opt.reg_init, x.dtype),
                         jnp.zeros((), jnp.int32), jnp.zeros((), bool)))
        return x_f, it_f

    def solve(x0, p=None, lbx=None, ubx=None, lbg=None, ubg=None):
        dt_f = jnp.result_type(float)
        x0 = jnp.asarray(x0, dt_f).reshape(n)
        p = (jnp.zeros((0,), dt_f) if p is None
             else jnp.asarray(p, dt_f).reshape(-1))
        full = lambda v, s: jnp.full((s,), v, dt_f)
        lbx = full(-jnp.inf, n) if lbx is None else jnp.asarray(lbx, dt_f).reshape(n)
        ubx = full(jnp.inf, n) if ubx is None else jnp.asarray(ubx, dt_f).reshape(n)
        lbg = full(-jnp.inf, m) if lbg is None else jnp.broadcast_to(
            jnp.asarray(lbg, dt_f), (m,))
        ubg = full(jnp.inf, m) if ubg is None else jnp.broadcast_to(
            jnp.asarray(ubg, dt_f), (m,))

        def viol_of(gv):
            vl = jnp.maximum(0.0, jnp.where(jnp.isfinite(lbg), lbg - gv, 0.0))
            vu = jnp.maximum(0.0, jnp.where(jnp.isfinite(ubg), gv - ubg, 0.0))
            return jnp.max(jnp.abs(jnp.concatenate(
                [vl, vu, jnp.zeros((1,), dt_f)])))

        def kkt_of(x, lamL, lamU):
            # gradient of the true Lagrangian, projected on the x-box
            def lag(xx):
                gv = g(xx, p)
                return f(xx, p) + jnp.sum((lamU - lamL) * gv)
            gr = jax.grad(lag)(x)
            pg = x - jnp.clip(x - gr, lbx, ubx)
            return jnp.max(jnp.abs(jnp.concatenate(
                [pg, jnp.zeros((1,), dt_f)])))

        def cond(c):
            x, lamL, lamU, mu, viol, it, rounds, done = c
            return jnp.logical_and(rounds < opt.max_outer,
                                   jnp.logical_not(done))

        def body(c):
            x, lamL, lamU, mu, viol_prev, it, rounds, done = c
            # inner tolerance tightens with the penalty AND with the round
            # counter (so unconstrained/frozen-mu problems still reach the
            # final KKT tolerance instead of stalling at the loose level)
            if m == 0:
                tol_inner = jnp.asarray(opt.tol, dt_f)
            else:
                tol_inner = jnp.maximum(
                    opt.tol, (1e-3 / (mu * mu)) * 0.1 ** rounds)
            x_n, it_in = inner_solve(x, p, lamL, lamU, mu,
                                     lbx, ubx, lbg, ubg, tol_inner)
            gv = g(x_n, p)
            cl = jnp.where(jnp.isfinite(lbg), lbg - gv, -1.0)
            cu = jnp.where(jnp.isfinite(ubg), gv - ubg, -1.0)
            lamL_n = jnp.maximum(0.0, lamL + mu * cl)
            lamU_n = jnp.maximum(0.0, lamU + mu * cu)
            viol = viol_of(gv)
            mu_n = jnp.where(viol > opt.viol_decrease * viol_prev,
                             jnp.minimum(mu * opt.mu_factor, opt.mu_max), mu)
            kkt = kkt_of(x_n, lamL_n, lamU_n)
            # scale-relative stationarity (IPOPT-style): at objective scale
            # |f| the achievable f64 gradient floor is ~eps*|f|*cond, so an
            # absolute test would spuriously fail on well-solved problems
            fscale = 1.0 + jnp.abs(f(x_n, p))
            done_n = (viol < opt.tol_con) & (kkt < opt.tol * fscale)
            return (x_n, lamL_n, lamU_n, mu_n, viol, it + it_in,
                    rounds + 1, done_n)

        lam0 = jnp.zeros((m,), dt_f)
        c0 = (jnp.clip(x0, lbx, ubx), lam0, lam0,
              jnp.asarray(opt.mu0, dt_f), jnp.asarray(jnp.inf, dt_f),
              jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
              jnp.zeros((), bool))
        x_f, lamL, lamU, mu, viol, it, rounds, done = jax.lax.while_loop(
            cond, body, c0)

        gv = g(x_f, p)
        return NLPResult(
            x=x_f, f=f(x_f, p), g=gv, lam_g=lamU - lamL,
            kkt=kkt_of(x_f, lamL, lamU), viol=viol_of(gv),
            iterations=it, converged=done)

    return solve
