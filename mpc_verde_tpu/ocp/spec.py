"""Optimal-control-problem specification.

This is the surface that replaces ``mpc.nmpc``'s implicit problem definition
(``mpctools/multiple_shooting_mpctools.py:62-64``): discrete dynamics, stage /
terminal costs, horizon, box bounds on controls (possibly stage- and
state-dependent), optional state box bounds, and a per-stage parameter vector
(the ``p`` tensor of ``Trajectory Tracking/Trajectory_tracking.py:54-72``).

Everything in the spec is either a static integer or a pure jittable callable,
so a spec compiles once and all per-step variation (references, LTV matrices,
targets) flows through the ``params`` array as data.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np


def box_bounds(lb, ub, N: Optional[int] = None):
    """Build a ``control_bounds(x, p, k) -> (lb, ub)`` callable from arrays.

    ``lb``/``ub`` may be shape (nu,) (constant, like v/omega limits at
    ``Casadi/single_shooting_v1.py:134-139``) or (N, nu) (per-stage, like the
    Du move-blocking vectors at ``Inverted_pendulum/...mpctools.py:34-42``).
    """
    # numpy (host) constants, pulled to the host once at build time: they
    # lower as literals of the traced program
    lb = np.atleast_1d(np.asarray(lb, dtype=jnp.result_type(float)))
    ub = np.atleast_1d(np.asarray(ub, dtype=lb.dtype))

    if lb.ndim == 1:
        def bounds(x, p, k):
            return lb, ub
    else:
        # k is traced inside scan bodies: numpy can't take a tracer index, so
        # re-wrap as a jnp constant *inside* the trace (still lowered locally
        # — the source array is host numpy, not a device buffer)
        def bounds(x, p, k):
            return jnp.asarray(lb)[k], jnp.asarray(ub)[k]

    return bounds


@dataclasses.dataclass(frozen=True)
class OCP:
    """Discrete-time OCP over horizon ``N``.

    Attributes:
      dynamics: ``F(x, u, p) -> x_next``.
      stage_cost: ``l(x, u, p) -> scalar`` for stages 0..N-1.
      terminal_cost: ``lf(x, p) -> scalar`` at stage N (may be ``None``).
      N, nx, nu, npar: static sizes (npar = per-stage parameter length).
      control_bounds: ``(x, p, k) -> (lb, ub)``, each (nu,).  State-dependent
        bounds let the rate-form transform express joint u/Du boxes exactly.
      x_lb, x_ub: optional (nx,) state box, enforced by the solver's augmented
        Lagrangian (cf. state bounds at ``Trajectory_tracking.py:63-67``).
    """

    dynamics: Callable
    stage_cost: Callable
    N: int
    nx: int
    nu: int
    npar: int = 0
    terminal_cost: Optional[Callable] = None
    control_bounds: Optional[Callable] = None
    x_lb: Optional[jnp.ndarray] = None
    x_ub: Optional[jnp.ndarray] = None

    @property
    def has_state_bounds(self) -> bool:
        return self.x_lb is not None or self.x_ub is not None

    def state_box(self):
        """State bounds as finite-or-inf (nx,) arrays."""
        lb = jnp.full((self.nx,), -jnp.inf) if self.x_lb is None else jnp.asarray(self.x_lb)
        ub = jnp.full((self.nx,), jnp.inf) if self.x_ub is None else jnp.asarray(self.x_ub)
        return lb, ub
