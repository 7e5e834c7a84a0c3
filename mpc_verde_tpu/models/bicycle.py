"""Lateral-error bicycle models (LTI, LTV, dynamic 4-state).

References:
  * 3-state lateral-error model (y, phi, r) with one steering input:
    ``Trajectory Tracking/Trajectory_tracking_le_LTI.py:37-41`` —
    ``Ac = [[0, uref, 0], [0, 0, 1], [0, 0, ar]]``, ``Bc = [0, 0, br]``,
    with ``ar = -23.55``, ``br = 61.99``.
  * LTV variant rebuilds Ac each step from the time-varying speed ``c[t]``:
    ``Trajectory Tracking/Trjectory_tracking_le_LTV.py:126-128``; the
    ``leitura.py:140`` variant multiplies speed by the yaw reference.
  * 4-state dynamic bicycle (y, phi, v_lat, r) with physical parameters
    m=1200, a=1.5, b=2, Ca=55000, Jz=1350:
    ``Trajectory Tracking/Trajectory_tracking_dynamic_model.py:37-42,119-128``.

Design note: the reference reconstructs CasADi functions, c2d, and a
fresh IPOPT solver inside the simulation loop for every LTV step (an
anti-pattern called out in SURVEY.md §3.4).  Here the LTV matrices are *data*:
``*_coeffs`` functions are jittable maps ``speed -> (Ac, Bc)`` evaluated inside
the compiled receding-horizon scan, and the per-stage (A, B) feed a dynamics
function that reads them from the parameter vector.
"""
from __future__ import annotations

import jax.numpy as jnp

from .base import LinearModel, Model, linear_model

AR_DEFAULT = -23.55
BR_DEFAULT = 61.99


def lateral_error_lti(uref: float, ar: float = AR_DEFAULT, br: float = BR_DEFAULT) -> LinearModel:
    """LTI lateral-error model at fixed forward speed ``uref``."""
    Ac = [[0.0, float(uref), 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, float(ar)]]
    Bc = [[0.0], [0.0], [float(br)]]
    return linear_model(Ac, Bc, name="lateral_error_lti")


def lateral_error_ltv_coeffs(speed, ar: float = AR_DEFAULT, br: float = BR_DEFAULT,
                             yaw_scale=1.0):
    """Jittable ``speed -> (Ac, Bc)`` for the LTV lateral-error model.

    ``yaw_scale`` reproduces the ``leitura.py:140`` variant where
    ``Ac[0,1] = speed * phi_ref`` instead of plain speed (pass the per-step
    yaw reference as ``yaw_scale``).
    """
    speed = jnp.asarray(speed)
    z = jnp.zeros_like(speed)
    o = jnp.ones_like(speed)
    Ac = jnp.stack([
        jnp.stack([z, speed * yaw_scale, z]),
        jnp.stack([z, z, o]),
        jnp.stack([z, z, ar * o]),
    ])
    Bc = jnp.array([[0.0], [0.0], [br]], dtype=Ac.dtype)
    return Ac, Bc


def dynamic_bicycle_coeffs(vref, m=1200.0, a=1.5, b=2.0, Ca=55000.0, Jz=1350.0):
    """Jittable ``vref -> (Ac, Bc)`` for the 4-state dynamic bicycle.

    Coefficient formulas from
    ``Trajectory Tracking/Trajectory_tracking_dynamic_model.py:119-128``
    (including the reference's literal operator grouping for A34).
    """
    vref = jnp.asarray(vref)
    A33 = -4.0 * Ca / (m * vref)
    A34 = (2.0 * Ca * (b - a) / m * vref) - vref
    A43 = 2.0 * Ca * ((b - a) / (Jz * vref))
    A44 = -2.0 * Ca * (a * a + b * b) / (Jz * vref)
    B31 = 2.0 * Ca / m
    B41 = 2.0 * Ca * a / Jz
    z = jnp.zeros_like(vref)
    o = jnp.ones_like(vref)
    Ac = jnp.stack([
        jnp.stack([z, vref, o, z]),
        jnp.stack([z, z, z, o]),
        jnp.stack([z, z, A33, A34]),
        jnp.stack([z, z, A43, A44]),
    ])
    Bc = jnp.stack([z, z, B31 * o, B41 * o])[:, None]
    return Ac, Bc


def dynamic_bicycle_ltv(vref_nominal: float = 1.0, **params) -> LinearModel:
    """Dynamic bicycle frozen at a nominal speed (for LTI use/tests)."""
    Ac, Bc = dynamic_bicycle_coeffs(jnp.asarray(float(vref_nominal)), **params)
    return linear_model(Ac, Bc, name="dynamic_bicycle")
