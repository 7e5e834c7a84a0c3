"""Fleet closed-loop demo: B robots, one compiled scan — the flagship
serving workload.

The reference's headline scenario is ONE diff-drive robot driven to
(10, 10, 0) by a serial solve-per-step Python loop
(``Casadi/single_shooting_v1.py:164-214``, 84 steps to target).  The
batched deployment shape is the same receding-horizon loop over a fleet:
every MPC step solves all B problems at once on the batched fast path, and
the whole Nsim-step simulation is a single ``lax.scan`` — zero host
round-trips.  bench.py times it (``closedloop_*`` keys) against the
reference's T=0.2 s control period.

Fleet members start from randomized poses in a square around the origin (the
reference's single start is the batch mean); every robot must reach the
reference's own acceptance ball ||(x, y) - target|| < 0.1
(``single_shooting_v1.py:166``) within the run.
"""
from __future__ import annotations

import numpy as np

SPEC = dict(T=0.2, N=10, Nsim=150, B=1024, target=(10.0, 10.0, 0.0),
            v_max=1.0, omega_max=np.pi / 4,
            Q=(1.0, 5.0, 0.1), R=(0.5, 0.05),
            start_box=2.0, seed=0, tol=0.1)


def build_fleet(B: int = None, n_steps: int = None, backend: str = None,
                max_iters: int = 30):
    """Returns the compiled fleet runner + problem tensors.

    ``backend`` is the batched solver's (None: chosen from the platform).
    """
    import jax
    import jax.numpy as jnp

    import mpc_verde_tpu as mv
    from mpc_verde_tpu.models import unicycle
    from mpc_verde_tpu.ops import euler_step, rk4_step
    from mpc_verde_tpu.runtime import make_batched_receding_horizon
    from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver

    s = dict(SPEC)
    if B is not None:
        s["B"] = B
    if n_steps is not None:
        s["Nsim"] = n_steps
    T, N = s["T"], s["N"]
    F = rk4_step(unicycle.f, T)
    Q = np.diag(np.array(s["Q"], dtype=np.float32))
    R = np.diag(np.array(s["R"], dtype=np.float32))

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    ocp = mv.OCP(
        dynamics=lambda x, u, p: F(x, u, p), stage_cost=l,
        N=N, nx=3, nu=2, npar=3,
        control_bounds=mv.box_bounds(
            np.array([-s["v_max"], -s["omega_max"]], dtype=np.float32),
            np.array([s["v_max"], s["omega_max"]], dtype=np.float32)),
    )
    solve = make_batched_ilqr_solver(
        ocp, mv.ILQROptions(max_iters=max_iters), backend=backend)
    # plant = Euler step, exactly the reference's shift_timestep plant
    # (single_shooting_v1.py:17-27); controller model is RK4 — the
    # plant/controller split of SURVEY §4.5
    plant = euler_step(unicycle.f, T)
    run = jax.jit(make_batched_receding_horizon(
        ocp, solve, lambda x, u, pp: plant(x, u, None), s["Nsim"]))

    rng = np.random.default_rng(s["seed"])
    x0s = np.zeros((s["B"], 3), dtype=np.float32)
    x0s[:, :2] = rng.uniform(-s["start_box"], s["start_box"], (s["B"], 2))
    x0s[:, 2] = rng.uniform(-np.pi / 2, np.pi / 2, s["B"])
    params = np.broadcast_to(
        np.asarray(s["target"], dtype=np.float32),
        (s["Nsim"], N + 1, 3)).copy()
    return {"ocp": ocp, "run": run, "x0s": x0s, "params": params, "spec": s}


def run_fleet(built=None, **kw):
    """Run the fleet; returns per-robot final-error distribution metrics."""
    import jax.numpy as jnp

    if built is None:
        built = build_fleet(**kw)
    s = built["spec"]
    res = built["run"](jnp.asarray(built["x0s"]), jnp.asarray(built["params"]))
    xs = np.asarray(res.xs)                       # (Nsim+1, B, 3)
    tgt = np.asarray(s["target"][:2], dtype=np.float64)
    err_t = np.linalg.norm(xs[:, :, :2] - tgt, axis=-1)   # (Nsim+1, B)
    final_err = err_t[-1]
    # first step each robot enters the reference's acceptance ball (tol=0.1)
    inside = err_t < s["tol"]
    reached = inside.any(axis=0)
    t_first = np.where(reached, inside.argmax(axis=0), -1)
    return {
        "result": res,
        "final_err": final_err,
        "B": int(s["B"]),
        "n_steps": int(s["Nsim"]),
        "final_err_max": float(final_err.max()),
        "final_err_p99": float(np.percentile(final_err, 99)),
        "final_err_mean": float(final_err.mean()),
        "frac_reached": float(reached.mean()),
        "steps_to_ball_mean": float(t_first[reached].mean()) if reached.any()
        else float("nan"),
        "steps_to_ball_max": int(t_first.max()),
        "converged_frac": float(np.asarray(res.converged).mean()),
    }
