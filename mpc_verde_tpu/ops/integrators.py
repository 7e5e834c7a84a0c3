"""Fixed-step integrators and discretization utilities.

JAX replacements for the reference's discretization stack:
  * Euler propagation (``Casadi/single_shooting_v1.py:85-91``)
  * fixed-step RK4 with M substeps, optionally integrating a cost quadrature
    alongside the state (``Casadi/single_shooting_v2.py:100-113``,
    ``mpc.getCasadiFunc(..., rk4=True, Delta, M)`` at
    ``mpctools/multiple_shooting_mpctools.py:48``)
  * zero-order-hold ``c2d`` (``mpc.util.c2d`` at
    ``Inverted_pendulum/inverted_pendulum_single_shooting_mpctools.py:24``)
  * ``DiscreteSimulator`` plant stepper (``mpctools.tools.DiscreteSimulator``
    used at ``Trajectory Tracking/Trajectory_tracking.py:48,121``) — here a
    jittable RK4 substepped integrator so plant and controller models can
    differ, matching the reference's controller/plant split
    (``Trajectory_tracking_lateral_error.py:41-47,81``).

Everything is shape-static and traceable: substeps unroll (M is tiny), so XLA
fuses the whole step into one fused elementwise/matmul block.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl


def euler_step(f, dt: float):
    """Explicit Euler: the propagation used by single_shooting_v1 (:85-91) and
    its plant shift (:17-27)."""

    def step(x, u, p=None):
        return x + dt * f(x, u, p)

    return step


def rk4_step(f, dt: float, M: int = 1):
    """Classic RK4 with ``M`` equal substeps over ``dt``.

    Matches the loop at ``Casadi/single_shooting_v2.py:100-112`` and
    mpctools' ``rk4=True`` discretization.
    """
    h = dt / M

    def substep(x, u, p):
        k1 = f(x, u, p)
        k2 = f(x + 0.5 * h * k1, u, p)
        k3 = f(x + 0.5 * h * k2, u, p)
        k4 = f(x + h * k3, u, p)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def step(x, u, p=None):
        for _ in range(M):
            x = substep(x, u, p)
        return x

    return step


_DOPRI_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
             187 / 2100, 1 / 40)


def rk45_step(f, dt: float, rtol: float = 1e-8, atol: float = 1e-10,
              max_steps: int = 1000):
    """Adaptive embedded Dormand-Prince RK5(4) over one ``dt`` interval.

    The reference's plant simulator delegates to CasADi's adaptive
    integrators (``mpc.DiscreteSimulator`` — CVODES); this is the jittable
    equivalent: a tolerance-controlled embedded pair with a PI
    step controller inside a bounded ``lax.while_loop``.  Use it when the
    plant must be integrated to a *tolerance* rather than a step count
    (plant/controller fidelity contrast, stiff-ish LTV models); use
    ``rk4_step`` for the fixed-cost controller path.

    Returns ``step(x, u, p=None) -> x(dt)``.  Shape-static and vmappable:
    under ``vmap`` the batch runs lockstep until every member's interval is
    done.  ``max_steps`` bounds the substep count; on exhaustion the current
    (partially advanced) state is returned, matching the bounded-iteration
    semantics of the solvers.
    """
    dtf = float(dt)

    def step(x, u, p=None):
        dtype = jnp.result_type(x.dtype, jnp.result_type(float))
        x = jnp.asarray(x, dtype)

        def rhs(y):
            return jnp.asarray(f(y, u, p), dtype)

        def body(carry):
            t, y, h, k1, n = carry
            h = jnp.minimum(h, dtf - t)
            ks = [k1]
            for i in range(1, 7):
                yi = y + h * sum(a * k for a, k in zip(_DOPRI_A[i], ks))
                ks.append(rhs(yi))
            y5 = y + h * sum(b * k for b, k in zip(_DOPRI_B5, ks))
            y4 = y + h * sum(b * k for b, k in zip(_DOPRI_B4, ks))
            scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y5))
            err = jnp.sqrt(jnp.mean(((y5 - y4) / scale) ** 2))
            accept = err <= 1.0
            # PI-ish controller with the usual safety/clamp factors
            fac = jnp.clip(0.9 * (err + 1e-16) ** (-0.2), 0.2, 5.0)
            h_n = h * fac
            t_n = jnp.where(accept, t + h, t)
            y_n = jnp.where(accept, y5, y)
            # FSAL: stage 7 of an accepted step is k1 of the next
            k1_n = jnp.where(accept, ks[6], k1)
            return (t_n, y_n, h_n, k1_n, n + 1)

        def cond(carry):
            t, y, h, k1, n = carry
            return (t < dtf * (1.0 - 1e-12)) & (n < max_steps)

        k10 = rhs(x)
        t, y, h, k1, n = jax.lax.while_loop(
            cond, body,
            (jnp.zeros((), dtype), x, jnp.asarray(dtf, dtype), k10,
             jnp.zeros((), jnp.int32)))
        return y

    return step


def rk4_step_with_quadrature(f, l, dt: float, M: int = 1):
    """RK4 integrating state and running-cost quadrature jointly.

    Reproduces ``F(x0, p) -> (xf, qf)`` of ``Casadi/single_shooting_v2.py:100-113``:
    the Lagrange term ``l(x, u)`` is integrated with the same RK4 stages.
    """
    h = dt / M

    def step(x, u, p=None):
        q = jnp.zeros((), dtype=x.dtype)
        for _ in range(M):
            k1 = f(x, u, p)
            k1_q = l(x, u, p)
            k2 = f(x + 0.5 * h * k1, u, p)
            k2_q = l(x + 0.5 * h * k1, u, p)
            k3 = f(x + 0.5 * h * k2, u, p)
            k3_q = l(x + 0.5 * h * k2, u, p)
            k4 = f(x + h * k3, u, p)
            k4_q = l(x + h * k3, u, p)
            x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            q = q + (h / 6.0) * (k1_q + 2.0 * k2_q + 2.0 * k3_q + k4_q)
        return x, q

    return step


def discretize(model, dt: float, method: str = "rk4", M: int = 1):
    """Discretize a continuous `Model` (or bare RHS) into ``F(x,u,p) -> x_next``."""
    f = model.f if hasattr(model, "f") else model
    if method == "euler":
        return euler_step(f, dt)
    if method == "rk4":
        return rk4_step(f, dt, M=M)
    raise ValueError(f"unknown integration method: {method!r}")


def c2d(Ac, Bc, dt: float):
    """Zero-order-hold discretization via the augmented matrix exponential.

    Equivalent to ``mpc.util.c2d(Ac, Bc, Delta)``
    (``Inverted_pendulum/...mpctools.py:24``,
    ``Trajectory_tracking_lateral_error.py:40``): computes
    ``expm([[Ac, Bc], [0, 0]] * dt)`` and reads off (Ad, Bd).  Jittable, so
    LTV re-discretization runs inside the compiled loop rather than rebuilding
    solvers per step (cf. ``Trjectory_tracking_le_LTV.py:130``).
    """
    Ac = jnp.asarray(Ac)
    Bc = jnp.asarray(Bc)
    nx = Ac.shape[-1]
    nu = Bc.shape[-1]
    blk = jnp.zeros(Ac.shape[:-2] + (nx + nu, nx + nu), dtype=Ac.dtype)
    blk = blk.at[..., :nx, :nx].set(Ac)
    blk = blk.at[..., :nx, nx:].set(Bc)
    M = jsl.expm(blk * dt)
    return M[..., :nx, :nx], M[..., :nx, nx:]


class DiscreteSimulator:
    """Plant stepper decoupled from the controller model.

    Drop-in analogue of ``mpc.DiscreteSimulator(ode, Delta, [Nx, Nu(, Np)],
    ["x", "u"(, "p")])`` (``mpctools/multiple_shooting_mpctools.py:45``,
    ``test2.py:115``).  The reference delegates to CasADi integrators; here a
    substepped RK4 gives plant-vs-controller discretization contrast while
    remaining jittable (``.sim`` can sit inside a ``lax.scan``).
    """

    def __init__(self, ode, dt: float, sizes=None, names=None, M: int = 10,
                 method: str = "rk4", rtol: float = 1e-8, atol: float = 1e-10):
        f = ode.f if hasattr(ode, "f") else ode
        self.dt = float(dt)
        self.M = int(M)
        if method == "rk4":
            self._step = rk4_step(f, self.dt, M=self.M)
        elif method == "rk45":
            # tolerance-adaptive plant integration (the CVODES role)
            self._step = rk45_step(f, self.dt, rtol=rtol, atol=atol)
        else:
            raise ValueError(f"unknown DiscreteSimulator method {method!r}")

    def sim(self, x, u, p=None):
        return self._step(jnp.asarray(x), jnp.asarray(u), None if p is None else jnp.asarray(p))

    __call__ = sim
