"""LTV lateral-error tracking — Trjectory_tracking_le_LTV.py, leitura.py.

The reference re-linearizes ``Ac`` with the time-varying speed ``c[t]`` and
*rebuilds CasADi functions, c2d, and the whole IPOPT solver inside the
simulation loop every step* (:124-146) — the dominant cost of that script.

The fix here (SURVEY.md §3.4): the per-step (Ad_t, Bd_t) are *data*.  All
Nsim discretizations are precomputed in one vectorized ``c2d`` call, the
matrices ride in the per-stage parameter vector, and a single compiled solver
handles every step.  Constants follow the LTI variant (Nt=5, Ntu=1,
Q=diag(10,1,0), R=0.01, delta_max=0.3491).
"""
from __future__ import annotations

import numpy as np

from .lane_change import SPEC as LTI_SPEC


def build_lane_change_ltv(path=None, n_steps=None, max_iters: int = 30,
                          unwrap: bool = False, yaw_scale_mode: bool = False):
    import jax
    import jax.numpy as jnp

    import mpc_verde_tpu as mv
    from mpc_verde_tpu.models import lateral_error_ltv_coeffs
    from mpc_verde_tpu.ops import c2d
    from mpc_verde_tpu.refgen import (lateral_error_references,
                                      stage_param_tensor, synthetic_lane_change)
    from mpc_verde_tpu.runtime import make_receding_horizon

    s = dict(LTI_SPEC)
    if path is None:
        path = synthetic_lane_change(n=500, dt=s["T"])
    Nsim = len(path["x"]) if n_steps is None else n_steps
    N, T = s["N"], s["T"]

    speeds = np.asarray(path["uref"][:Nsim], dtype=float)
    refs = lateral_error_references(path, T, s["ar"], s["br"], unwrap=unwrap)

    # per-step linearization, vectorized over the whole run (leitura.py:140
    # optionally scales by the yaw reference)
    yaw_scale = refs[:Nsim, 1] if yaw_scale_mode else 1.0
    Acs, Bc = lateral_error_ltv_coeffs(jnp.asarray(speeds), s["ar"], s["br"],
                                       yaw_scale=jnp.asarray(yaw_scale))
    Acs = jnp.moveaxis(Acs, -1, 0) if Acs.ndim == 3 else Acs  # (Nsim, 3, 3)
    Bcs = jnp.broadcast_to(jnp.asarray(Bc), (Nsim, 3, 1))
    Ads, Bds = jax.vmap(lambda A, B: c2d(A, B, T))(Acs, Bcs)

    Q = jnp.diag(jnp.array(s["Q"]))
    R, R_du = s["R"], s["R_du"]

    # params per stage: [y_ref, phi_ref, r_ref, delta_ref, vec(Ad) 9, Bd 3]
    def dyn(x, u, p):
        A = p[4:13].reshape(3, 3)
        B = p[13:16]
        return A @ x + B * u[0]

    def l(x, u, p, du):
        e = x - p[:3]
        return e @ Q @ e + R * (u[0] - p[3]) ** 2 + R_du * du[0] ** 2

    du_lb = np.zeros((N, 1)); du_ub = np.zeros((N, 1))
    du_lb[: s["Ntu"]] = -np.inf; du_ub[: s["Ntu"]] = np.inf

    ocp = mv.to_rate_form(
        dyn, l, N=N, nx=3, nu=1, npar=16,
        u_lb=jnp.array([-s["delta_max"]]), u_ub=jnp.array([s["delta_max"]]),
        du_lb=du_lb, du_ub=du_ub)
    solve = mv.make_ilqr_solver(ocp, mv.ILQROptions(max_iters=max_iters))

    ref_par = stage_param_tensor(refs, N + 1, Nsim)  # (Nsim, N+1, 4)
    mats = np.concatenate([
        np.asarray(Ads).reshape(Nsim, 9),
        np.asarray(Bds).reshape(Nsim, 3),
    ], axis=1)  # (Nsim, 12) — same matrices across the horizon of one step
    par = np.concatenate([
        ref_par, np.broadcast_to(mats[:, None, :], (Nsim, N + 1, 12))], axis=2)

    def plant(z, w, pp):
        # plant uses the same step's exact discretization (continuous model,
        # ZOH input), pp = flattened (Ad, Bd)
        x, u_prev = z[:3], z[3:]
        u = u_prev + w
        A = pp[:9].reshape(3, 3)
        B = pp[9:12]
        return jnp.concatenate([A @ x + B * u[0], u])

    run = jax.jit(make_receding_horizon(ocp, solve, plant, Nsim))
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s, "path": path,
            "params_seq": par, "plant_params": mats, "refs": refs,
            "n_steps": Nsim, "speeds": speeds}


def build_leitura(n_steps=None, max_iters: int = 30, csv_name: str = "traj5.csv"):
    """The ``leitura.py`` configuration: LTV controller on a generic recorded
    course (``traj5.csv``) with +2pi heading unwrap for loop-the-loop paths
    (:98-127).  Falls back to the synthetic extended course when the
    reference data directory is absent."""
    from mpc_verde_tpu.refgen import load_path_csv, extend_lane_change_course

    try:
        path = load_path_csv(csv_name)
    except FileNotFoundError:
        path = extend_lane_change_course()
    return build_lane_change_ltv(path=path, n_steps=n_steps,
                                 max_iters=max_iters, unwrap=True)


def run_lane_change_ltv(built=None, **kw):
    import jax.numpy as jnp

    if built is None:
        built = build_lane_change_ltv(**kw)
    s = built["spec"]
    Nsim = built["n_steps"]
    res = built["run"](jnp.zeros(4), jnp.asarray(built["params_seq"]),
                       jnp.asarray(built["plant_params"]))
    zs = np.array(res.xs)
    xs = zs[:, :3]
    dus = np.array(res.us)
    us = zs[:Nsim, 3] + dus[:, 0]

    refs = built["refs"][:Nsim]
    err = xs[:Nsim] - refs[:, :3]
    mse = float((np.linalg.norm(err[:, :2], axis=1) ** 2).mean())
    speeds = built["speeds"]
    xz = np.concatenate([[0.0], np.cumsum(speeds[:-1] * np.cos(xs[1:Nsim, 1]) * s["T"])])
    traj = np.stack([xz, xs[:Nsim, 0]])
    traje = np.stack([built["path"]["x"][:Nsim], built["path"]["y"][:Nsim]])
    dists = np.linalg.norm(traj - traje, axis=0)
    return {
        "result": res, "u": us, "x": xs,
        "mse": mse,
        "mean_path_dist": float(dists.mean()),
        "max_path_dist": float(dists.max()),
        "converged_frac": float(np.array(res.converged).mean()),
    }
