"""Receding-horizon closed-loop driver — one compiled scan, not a Python loop.

The reference's L3 layer is a Python ``while``/``for`` loop that, per control
step, injects parameters, calls IPOPT across the C++ boundary, applies the
first control, steps the plant, and warm-starts by shifting
(``Casadi/single_shooting_v1.py:164-214``,
``Trajectory Tracking/Trajectory_tracking.py:100-126``).

Here the entire closed loop is a single ``lax.scan`` whose body contains the
full iLQR solve: the solver's XLA executable stays resident on device for the
whole simulation, there is no host round-trip per step, and ``jax.vmap`` over
the driver batches whole closed-loop *simulations* (different initial states,
references, or tuning configs — the axis ``Phiref.py:24-28`` sweeps serially).

Warm starting mirrors the reference exactly: the previous solution shifted by
one stage with the last control repeated (``single_shooting_v1.py:17-27``,
``solver.saveguess()`` + ``fixvar("x", 0, var["x", 1])`` in the mpctools
scripts).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ocp.spec import OCP


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClosedLoopResult:
    xs: jnp.ndarray           # (Nsim+1, nx) closed-loop state trajectory
    us: jnp.ndarray           # (Nsim, nu) applied controls
    costs: jnp.ndarray        # (Nsim,) OCP cost per solve
    iterations: jnp.ndarray   # (Nsim,) solver iterations per step
    converged: jnp.ndarray    # (Nsim,) solver convergence flags
    predicted: Optional[jnp.ndarray] = None  # (Nsim, N+1, nx) horizons
    final_warm: Optional[jnp.ndarray] = None  # (N, nu) next warm start (resume)


def shift_warm_start(us):
    """Shift the control plan one stage, repeating the last control.

    Equivalent to ``shift_timestep``'s ``horzcat(u[:,1:], u[:,-1])``
    (``Casadi/single_shooting_v1.py:22-26``).
    """
    return jnp.concatenate([us[1:], us[-1:]], axis=0)


def make_receding_horizon(
    ocp: OCP,
    solve: Callable,
    plant_step: Callable,
    n_steps: int,
    record_predictions: bool = False,
):
    """Build the jitted closed-loop runner.

    Args:
      ocp: the OCP the solver was built for (for shapes).
      solve: ``solve(x0, params, us_init) -> ILQRResult`` from
        ``make_ilqr_solver``.
      plant_step: ``(x, u, p_plant) -> x_next`` — the *plant* integrator,
        deliberately separate from the controller model (the reference
        integrates the continuous model for the plant while the controller
        uses the discretized one, ``Trajectory_tracking_lateral_error.py:41-47``).
      n_steps: Nsim, number of closed-loop steps (static).
      record_predictions: also record each step's predicted horizon (the
        ``pred += [solver.var["x",:,:]]`` pattern).

    Returns ``run(x0, params_seq, plant_params, us_init) -> ClosedLoopResult``:
      params_seq: (Nsim, N+1, npar) per-step stage-parameter tensors — the
        ``par[:, k, t]`` tensor of ``Trajectory_tracking.py:84-97`` — or None.
      plant_params: (Nsim, ...) per-step plant parameters, or None.
    """
    N = ocp.N

    def run(x0, params_seq=None, plant_params=None, us_init=None):
        dt_f = jnp.result_type(float)
        x0 = jnp.asarray(x0, dtype=dt_f)
        if us_init is None:
            us_init = jnp.zeros((N, ocp.nu), dtype=dt_f)
        if params_seq is None:
            params_seq = jnp.zeros((n_steps, N + 1, max(ocp.npar, 1)), dtype=dt_f)
        if plant_params is None:
            plant_params = jnp.zeros((n_steps, 1), dtype=dt_f)

        def step(carry, inp):
            x, us_warm = carry
            params_t, pp_t = inp
            res = solve(x, params_t, us_warm)
            u0 = res.us[0]
            x_next = plant_step(x, u0, pp_t)
            us_next = shift_warm_start(res.us)
            out = (x, u0, res.cost, res.iterations, res.converged,
                   res.xs if record_predictions else jnp.zeros((0,), dtype=dt_f))
            return (x_next, us_next), out

        (xN, warmN), (xs, us, costs, iters, conv, preds) = jax.lax.scan(
            step, (x0, us_init), (params_seq, plant_params))
        xs = jnp.concatenate([xs, xN[None]], axis=0)
        return ClosedLoopResult(
            xs=xs, us=us, costs=costs, iterations=iters, converged=conv,
            predicted=preds if record_predictions else None,
            final_warm=warmN,
        )

    return run


def make_batched_receding_horizon(
    ocp: OCP,
    solve_batch: Callable,
    plant_step: Callable,
    n_steps: int,
    plant_params_per_plant: bool = False,
):
    """Batched closed-loop runner: B independent simulations in one scan.

    Unlike ``jax.vmap(make_receding_horizon(...))`` — which vmaps the
    *per-problem* solver — this drives a batch-major solver
    (``solver.batched.make_batched_ilqr_solver``) directly, so each control
    step's solve runs the batched fast path over the whole simulation
    batch.  This is the deployment shape for fleet
    simulation / scenario sweeps: the serial per-step loop of
    ``Casadi/single_shooting_v1.py:164-214`` becomes one compiled scan over
    steps x thousands of plants.

    Args:
      solve_batch: ``(x0s (B,nx), params (B,N+1,npar), us (B,N,nu)) ->
        ILQRResult`` with leading batch axes.
      plant_step: single-problem ``(x, u, p_plant) -> x_next``; vmapped here.

    Returns ``run(x0s, params_seq, plant_params, us_init) ->
    ClosedLoopResult`` with a batch axis after the time axis: xs is
    (Nsim+1, B, nx), us (Nsim, B, nu), costs/iterations/converged (Nsim, B).
    ``params_seq`` is (Nsim, B, N+1, npar), or (Nsim, N+1, npar) shared
    across the batch, or None; ``plant_params`` is (Nsim, ...) shared across
    the batch by default.  For *per-plant* plant parameters, pass
    ``plant_params_per_plant=True`` and shape them (Nsim, B, ...) — the
    per-step slice is then mapped over the batch axis alongside states and
    controls (shapes can't disambiguate the two conventions, e.g. a shared
    (Nsim, B) vector vs per-plant scalars, so the layout is an explicit
    build-time flag).
    """
    N = ocp.N
    plant_b = jax.vmap(
        plant_step, in_axes=(0, 0, 0 if plant_params_per_plant else None))

    def run(x0s, params_seq=None, plant_params=None, us_init=None):
        dt_f = jnp.result_type(float)
        x0s = jnp.asarray(x0s, dtype=dt_f)
        B = x0s.shape[0]
        if us_init is None:
            us_init = jnp.zeros((B, N, ocp.nu), dtype=dt_f)
        npar = max(ocp.npar, 1)
        if params_seq is None:
            params_seq = jnp.zeros((n_steps, B, N + 1, npar), dtype=dt_f)
        else:
            params_seq = jnp.asarray(params_seq, dtype=dt_f)
            if params_seq.ndim == 3:   # (Nsim, N+1, npar) shared across batch
                params_seq = jnp.broadcast_to(
                    params_seq[:, None], (n_steps, B, N + 1, npar))
        if plant_params is None:
            shape = (n_steps, B, 1) if plant_params_per_plant else (n_steps, 1)
            plant_params = jnp.zeros(shape, dtype=dt_f)

        def step(carry, inp):
            xs_t, warm = carry
            params_t, pp_t = inp
            res = solve_batch(xs_t, params_t, warm)
            u0 = res.us[:, 0]
            x_next = plant_b(xs_t, u0, pp_t)
            warm_n = jnp.concatenate([res.us[:, 1:], res.us[:, -1:]], axis=1)
            return (x_next, warm_n), (xs_t, u0, res.cost, res.iterations,
                                      res.converged)

        (xN, warmN), (xs, us, costs, iters, conv) = jax.lax.scan(
            step, (x0s, jnp.asarray(us_init, dtype=dt_f)),
            (params_seq, plant_params))
        xs = jnp.concatenate([xs, xN[None]], axis=0)
        return ClosedLoopResult(xs=xs, us=us, costs=costs, iterations=iters,
                                converged=conv, final_warm=warmN)

    return run
