"""Control-rate (Delta-u) reformulation.

``mpc.nmpc`` exposes rate constraints and rate costs through ``uprev=`` and
``"Du"`` bounds — used for move blocking (free Du for the first Ntu stages,
pinned to 0 after: ``Inverted_pendulum/...mpctools.py:34-42``,
``Trajectory_tracking_le_LTI.py:66-74``) and steering-rate limits
(``test2.py:44-48``), with Du appearing in stage costs
(``Inverted_pendulum/...mpctools.py:51-53``).

Treatment here: augment the state with the previous control,
``z = [x; u_prev]``, and make the *rate* the control, ``w = Du``:

    z_next = [ F(x, u_prev + w, p) ; u_prev + w ]

Then Du boxes are plain control boxes on ``w`` and the original u box becomes
a state-dependent box ``u_lb - u_prev <= w <= u_ub - u_prev`` — exactly what
``OCP.control_bounds(x, p, k)`` expresses.  Move blocking (Du == 0) is the
degenerate box lb = ub = 0, which the enumeration box-QP solves exactly, so a
horizon with control horizon Ntu costs the same compiled program as one
without.  This removes the extra decision variables mpctools introduces while
keeping the identical feasible set.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp

from .spec import OCP


def to_rate_form(
    dynamics: Callable,
    stage_cost: Callable,
    N: int,
    nx: int,
    nu: int,
    npar: int = 0,
    terminal_cost: Optional[Callable] = None,
    u_lb=None,
    u_ub=None,
    du_lb=None,
    du_ub=None,
    x_lb=None,
    x_ub=None,
) -> OCP:
    """Build the augmented-state OCP.

    Args:
      dynamics: ``F(x, u, p) -> x_next`` on the *original* state.
      stage_cost: ``l(x, u, p, du) -> scalar`` (du available, as in mpctools'
        ``largs = ["x", "u", "p", "Du"]``).
      u_lb, u_ub: (nu,) or (N, nu) control magnitude bounds.
      du_lb, du_ub: (nu,) or (N, nu) rate bounds (move blocking via 0/0 rows).
      x_lb, x_ub: optional original-state box.

    Returns an ``OCP`` over z = [x; u_prev] with control w = Du.  Solve it
    with initial state ``z0 = concat([x0, uprev])`` (uprev as in
    ``mpc.nmpc(..., uprev=np.array([0]))``).
    """
    dt_f = jnp.result_type(float)
    inf = jnp.inf

    def _stage_arr(b, default):
        if b is None:
            return jnp.full((N, nu), default, dtype=dt_f)
        b = jnp.asarray(b, dtype=dt_f)
        if b.ndim == 1:
            b = jnp.broadcast_to(b, (N, nu))
        return b

    ulb = _stage_arr(u_lb, -inf)
    uub = _stage_arr(u_ub, inf)
    dlb = _stage_arr(du_lb, -inf)
    dub = _stage_arr(du_ub, inf)

    def z_dynamics(z, w, p):
        x, u_prev = z[:nx], z[nx:]
        u = u_prev + w
        return jnp.concatenate([dynamics(x, u, p), u])

    def z_cost(z, w, p):
        x, u_prev = z[:nx], z[nx:]
        u = u_prev + w
        return stage_cost(x, u, p, w)

    z_terminal = None
    if terminal_cost is not None:
        def z_terminal(z, p):
            return terminal_cost(z[:nx], p)

    def w_bounds(z, p, k):
        u_prev = z[nx:]
        lb = jnp.maximum(dlb[k], ulb[k] - u_prev)
        ub = jnp.minimum(dub[k], uub[k] - u_prev)
        return lb, ub

    zx_lb = zx_ub = None
    if x_lb is not None or x_ub is not None:
        zx_lb = jnp.concatenate([
            jnp.asarray(x_lb, dtype=dt_f) if x_lb is not None else jnp.full((nx,), -inf),
            jnp.full((nu,), -inf),
        ])
        zx_ub = jnp.concatenate([
            jnp.asarray(x_ub, dtype=dt_f) if x_ub is not None else jnp.full((nx,), inf),
            jnp.full((nu,), inf),
        ])

    return OCP(
        dynamics=z_dynamics,
        stage_cost=z_cost,
        terminal_cost=z_terminal,
        N=N,
        nx=nx + nu,
        nu=nu,
        npar=npar,
        control_bounds=w_bounds,
        x_lb=zx_lb,
        x_ub=zx_ub,
    )
