"""Smoke test of the batched MPC solver on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: every phase of the main path
    python chip_smoke.py --four   # four GPUs: the sharded streaming solver

One process drives the card(s); ``nvidia-smi`` is its only subprocess.  The
workload is bench.py's: the reference's diff-drive problem at N=40 in f32
with random initial states from a fixed seed.  Phases (one GPU):

  kernel     the Riccati kernel at N=40, W=1024 for (nx, nu) = (3, 2) and
             (3, 1) on random stage data, against the vmapped XLA backward
             (highest precision) at the interpret-mode tests' tolerances
             (nu = 3, 4 compile for minutes on the card and are not the
             platform default, so they are left out);
  streaming  the streaming solver over a 131072-problem queue in full
             (60 iterations + 2 restarts), fast (40 + 0) and warm modes;
             32 solutions against a float64 numpy/scipy golden;
  batched    the fixed-batch solver at B=2048 against the fast streaming
             mode, which has the same per-problem semantics;
  fleets     the N=10 fixed-start fleet (1024 plants, 84 steps) and the
             randomized N=40 streaming fleet (1024 plants, 125 steps);
  barrier    the cold and the DDP-warm-started streaming barrier solvers
             over a 16384-problem queue, and the cold one again with the
             XLA backward, whose iteration count the kernel must match.

Any failed check raises, so the script exits non-zero without its final
line.  It refuses to run without a GPU.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(AssertionError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- kernel --

def random_stage_data(rng, B, N, nx, nu):
    """Random well-posed stage derivatives (tests/test_pallas_riccati.py's
    distribution, with contracting dynamics so that the value function stays
    O(1) over N stages and the tests' absolute tolerances apply): a mix of
    active and inactive boxes and one pinned (lb = ub) final stage.
    Returns (d, dlb, dub, gN, HN, reg) in f32."""
    import jax.numpy as jnp
    import numpy as np

    eye = np.eye(nx)
    d = {
        "fx": rng.normal(size=(B, N, nx, nx)) * 0.3 / np.sqrt(nx) + 0.5 * eye,
        "fu": rng.normal(size=(B, N, nx, nu)) * 0.3,
        "lx": rng.normal(size=(B, N, nx)),
        "lu": rng.normal(size=(B, N, nu)),
        "lxx": 2 * eye + 0.1 * rng.normal(size=(B, N, nx, nx)),
        "luu": np.broadcast_to(np.eye(nu), (B, N, nu, nu)),
        "lux": 0.1 * rng.normal(size=(B, N, nu, nx)),
        "fxx": 0.05 * rng.normal(size=(B, N, nx, nx, nx)),
        "fux": 0.05 * rng.normal(size=(B, N, nx, nu, nx)),
        "fuu": 0.05 * rng.normal(size=(B, N, nx, nu, nu)),
    }
    d["lxx"] = 0.5 * (d["lxx"] + np.swapaxes(d["lxx"], -1, -2))
    dlb = np.full((B, N, nu), -0.7)
    dub = np.full((B, N, nu), 0.5)
    dlb[:, -1] = dub[:, -1] = 0.0
    gN = rng.normal(size=(B, nx))
    HN = np.broadcast_to(np.eye(nx), (B, nx, nx))
    reg = np.full((B,), 1e-6)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return ({k: f32(v) for k, v in d.items()}, f32(dlb), f32(dub), f32(gN),
            f32(HN), f32(reg))


def xla_backward(N, nx, nu):
    """The solver's vmapped XLA backward for an (nx, nu) box-bounded OCP."""
    import numpy as np

    import mpc_verde_tpu as mv
    from mpc_verde_tpu.solver.batched import _make_parts
    from mpc_verde_tpu.solver.ilqr import pin_precision

    ocp = mv.OCP(dynamics=lambda x, u, p: x, stage_cost=lambda x, u, p: 0.0,
                 N=N, nx=nx, nu=nu, npar=1,
                 control_bounds=mv.box_bounds(-np.ones(nu), np.ones(nu)))
    parts = _make_parts(ocp, mv.ILQROptions(), "xla", "materialize")
    return pin_precision(parts.backward)


def median_time(fn, args, reps=20):
    import jax
    import numpy as np

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_kernel(N=40, W=1024, shapes=((3, 2), (3, 1)), interpret=False):
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_verde_tpu.ops.pallas.riccati import riccati_backward_pallas

    rng = np.random.default_rng(0)
    for nx, nu in shapes:
        d, dlb, dub, gN, HN, reg = random_stage_data(rng, W, N, nx, nu)
        ones = jnp.ones((W,), jnp.float32)
        kern = jax.jit(functools.partial(
            riccati_backward_pallas, nx=nx, nu=nu, use_ddp=True,
            interpret=interpret))
        t0 = time.time()
        compiled = kern.lower(d, dlb, dub, gN, HN, reg, ones).compile()
        log(f"kernel ({nx},{nu}) compiled in {time.time() - t0:.1f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")
        ref = jax.jit(xla_backward(N, nx, nu))
        out_k = compiled(d, dlb, dub, gN, HN, reg, ones)
        out_x = ref(d, gN, HN, dlb, dub, reg, ones)
        names = ("kff", "K", "dV1", "dV2", "gmax")
        err = {n: float(jnp.max(jnp.abs(a - b)))
               for n, a, b in zip(names, out_k, out_x)}
        tol = {"kff": 2e-4, "K": 2e-3, "dV1": 1e-3, "gmax": 1e-4}
        for n, t in tol.items():
            check(err[n] <= t, f"kernel ({nx},{nu}) {n} error {err[n]} > {t}")
        t_k = median_time(compiled, (d, dlb, dub, gN, HN, reg, ones))
        t_x = median_time(ref, (d, gN, HN, dlb, dub, reg, ones))
        log(f"kernel ({nx},{nu}) N={N} W={W}: ok, max errors {err}; "
            f"kernel {t_k * 1e6:.1f} us, xla backward {t_x * 1e6:.1f} us "
            "(median of 20)")


# ------------------------------------------------------------- streaming --

def unicycle_golden(x0, us_start, N):
    """float64 numpy/scipy optimum of the bench OCP, started at us_start
    (the same local optimum): tests/golden.py with exact gradients."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from golden import single_shooting_golden_cs

    import bench

    q = np.array([1.0, 5.0, 0.1])
    r = np.array([0.5, 0.05])
    tgt = np.asarray(bench.TARGET)
    T = 0.2

    def rhs(x, u):
        return np.stack([u[:, 0] * np.cos(x[:, 2]), u[:, 0] * np.sin(x[:, 2]),
                         u[:, 1]], -1)

    def step(x, u):
        k1 = rhs(x, u)
        k2 = rhs(x + 0.5 * T * k1, u)
        k3 = rhs(x + 0.5 * T * k2, u)
        k4 = rhs(x + T * k3, u)
        return x + (T / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def stage(x, u, k):
        e = x - tgt
        return (e * e * q).sum(-1) + (u * u * r).sum(-1)

    def cost(us):
        x = np.asarray(x0, np.float64)[None]
        c = 0.0
        for k in range(N):
            c = c + stage(x, us[None, k], k)
            x = step(x, us[None, k])
        return float(c[0])

    ug, cg = single_shooting_golden_cs(
        step, stage, lambda x: 0.0, x0, N, 2, [-1.0, -np.pi / 4],
        [1.0, np.pi / 4], us_start)
    return ug, cg, cost


def phase_streaming(N=40, W=1024, M=131072, n_golden=32):
    """Returns the full-mode and fast-mode results for the batched phase."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from mpc_verde_tpu.solver.streaming import make_streaming_solver

    ocp = bench.build_ocp(N)
    x0q, psq, us0q = bench.make_queue(M, N)
    ssolve = jax.jit(make_streaming_solver(ocp, bench.bench_options(60),
                                           batch_width=W))
    t0 = time.time()
    full = jax.block_until_ready(ssolve(x0q, psq, us0q, 60, 2))
    t_full = time.time() - t0
    conv = float(full.converged.mean())
    check(conv == 1.0, f"streaming full: converged_frac {conv} != 1.0")
    check(bool(jnp.isfinite(full.us).all() & jnp.isfinite(full.cost).all()),
          "streaming full: non-finite result")
    log(f"streaming full N={N} W={W} M={M}: ok, converged_frac {conv}, "
        f"mean iterations {float(full.iterations.mean()):.2f}, "
        f"{t_full:.2f} s incl. compile")

    # f64 golden on the first n_golden problems.  The solver's contract is
    # its relative cost tolerance (1e-6): the f64 cost of the f32 controls
    # must be within it of the f64 optimum.  The controls themselves are
    # reported: in flat valleys of this problem f32 cost round-off (~eps *
    # 1e4) leaves them ~1e-2 from the f64 optimum on any f32 device.
    gaps, errs = [], []
    t0 = time.time()
    for i in range(n_golden):
        us = np.asarray(full.us[i], np.float64)
        ug, cg, cost = unicycle_golden(np.asarray(x0q[i], np.float64), us, N)
        gaps.append((cost(us) - cg) / (1.0 + abs(cg)))
        errs.append(float(np.abs(us - ug).max()))
    gap = max(gaps)
    check(gap <= 1e-6, f"streaming golden: relative cost gap {gap} > 1e-6")
    log(f"streaming golden ({n_golden} problems, float64 scipy): ok, max "
        f"relative cost gap {gap:.3e} (bound 1e-6); controls max |du| "
        f"{max(errs):.3e}, {sum(e > 1e-3 for e in errs)} of {n_golden} "
        f"above 1e-3; {time.time() - t0:.1f} s")

    fast = jax.block_until_ready(ssolve(x0q, psq, us0q, 40, 0))
    check(bool(jnp.isfinite(fast.cost).all()), "streaming fast: non-finite")
    # a problem that converges inside the fast budget takes the same path in
    # full mode (budgets only act at the cap): same cost
    fc = np.asarray(fast.converged)
    rel = np.abs(np.asarray(fast.cost) - np.asarray(full.cost)) / (
        1.0 + np.abs(np.asarray(full.cost)))
    dev = float(rel[fc].max()) if fc.any() else 0.0
    check(fc.mean() > 0.5, f"streaming fast: converged_frac {fc.mean()}")
    check(dev <= 1e-6, f"streaming fast vs full: relative cost gap {dev}")
    log(f"streaming fast: ok, converged_frac {fc.mean():.4f}, converged "
        f"problems match full mode (max relative cost gap {dev:.1e})")

    warm_us = jnp.concatenate([full.us[:, 1:], full.us[:, -1:]], axis=1)
    warm = jax.block_until_ready(
        ssolve(x0q + jnp.float32(0.02), psq, warm_us, 60, 2))
    wc = float(warm.converged.mean())
    check(wc == 1.0, f"streaming warm: converged_frac {wc} != 1.0")
    log(f"streaming warm: ok, converged_frac {wc}, mean iterations "
        f"{float(warm.iterations.mean()):.2f}")
    return x0q, psq, us0q, full, fast


def phase_batched(x0q, psq, us0q, fast, N=40, B=2048):
    import jax
    import numpy as np

    import bench
    from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver

    bsolve = jax.jit(make_batched_ilqr_solver(bench.build_ocp(N),
                                              bench.bench_options(40)))
    rb = jax.block_until_ready(bsolve(x0q[:B], psq[:B], us0q[:B]))
    cb = np.asarray(rb.converged)
    cf = np.asarray(fast.converged[:B])
    # the strict batched solver and the fast streaming mode (budget 40, no
    # restarts) have the same per-problem semantics
    check((cb == cf).all(), f"batched vs streaming fast: {int((cb != cf).sum())}"
          " convergence flags differ")
    rel = np.abs(np.asarray(rb.cost) - np.asarray(fast.cost[:B])) / (
        1.0 + np.abs(np.asarray(fast.cost[:B])))
    dev = float(rel[cb].max())
    check(dev <= 1e-6, f"batched vs streaming fast: relative cost gap {dev}")
    log(f"batched B={B}: ok, converged_frac {cb.mean():.4f}, matches the "
        f"streaming fast mode (max relative cost gap {dev:.1e})")


def phase_fleets(B=1024):
    import jax

    import bench

    t0 = time.time()
    run, x0c, psc, tgt = bench.make_fleet(10, B, 84, False, 20)
    err, _ = bench.fleet_metrics(jax.block_until_ready(run(x0c, psc)), tgt)
    check(err.max() <= 0.1, f"N=10 fleet: final error max {err.max()} > 0.1")
    log(f"fleet N=10 ({B} plants, 84 steps): ok, final error max "
        f"{err.max():.4f}; {time.time() - t0:.1f} s incl. compile")

    t0 = time.time()
    run, x0c, psc, tgt = bench.make_fleet(40, B, 125, True, 80, "streaming")
    err, conv = bench.fleet_metrics(jax.block_until_ready(run(x0c, psc)), tgt)
    check(err.max() <= 0.1, f"N=40 fleet: final error max {err.max()} > 0.1")
    check(conv.min() >= 0.99, f"N=40 fleet: step_conv_min {conv.min()}")
    log(f"fleet N=40 randomized ({B} plants, 125 steps): ok, final error max "
        f"{err.max():.4f}, step_conv_min {conv.min():.4f}; "
        f"{time.time() - t0:.1f} s incl. compile")


def phase_barrier(x0q, psq, us0q, N=40, W=1024, M=16384):
    import jax
    import jax.numpy as jnp

    import bench
    from mpc_verde_tpu.solver.ipm import make_streaming_barrier_solver

    ocp, opts = bench.build_ocp(N), bench.bench_options(60)
    mean_it = {}
    for name, kw in (("cold", {}),
                     ("hybrid", {"mu_schedule": (1e-4,),
                                 "warmstart": "ddp"}),
                     ("cold, xla backward", {"backend": "xla"})):
        t0 = time.time()
        solve = jax.jit(make_streaming_barrier_solver(
            ocp, opts, batch_width=W, **kw))
        r = jax.block_until_ready(solve(x0q[:M], psq[:M], us0q[:M], 60, 2))
        conv = float(r.converged.mean())
        check(conv == 1.0, f"barrier {name}: converged_frac {conv} != 1.0")
        check(bool(jnp.isfinite(r.cost).all()), f"barrier {name}: non-finite")
        mean_it[name] = float(r.iterations.mean())
        log(f"barrier {name} (queue {M}): ok, converged_frac {conv}, mean "
            f"iterations {mean_it[name]:.2f}; "
            f"{time.time() - t0:.1f} s incl. compile")
    # the barrier's iteration count is where a backward that differs from
    # the reference showed first: NaN stage gradients dropped from gmax by
    # the GPU's max.f32 cost +8 iterations on every problem
    gap = abs(mean_it["cold"] / mean_it["cold, xla backward"] - 1.0)
    check(gap <= 0.05, f"barrier: mean iterations with the default backward "
          f"differ from the XLA backward's by {gap:.1%} (> 5 %)")
    log(f"barrier default vs xla backward: ok, mean iterations differ by "
        f"{gap:.2%} (bound 5 %)")


# ------------------------------------------------------------ four GPUs --

def phase_sharded(n=4, N=40, W=1024, M=16384):
    """The sharded streaming solver over a 1-D batch mesh of n devices
    against the same queue solved on one device, shard by shard."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from mpc_verde_tpu.parallel import batch_mesh, make_sharded_solver
    from mpc_verde_tpu.solver.streaming import make_streaming_solver

    ocp = bench.build_ocp(N)
    x0q, psq, us0q = bench.make_queue(M, N)
    ssolve = make_streaming_solver(ocp, bench.bench_options(60),
                                   batch_width=W, restarts=2)
    sharded = make_sharded_solver(ssolve, batch_mesh(n), batched=True)
    t0 = time.time()
    res, stats = jax.block_until_ready(sharded(x0q, psq, us0q))
    log(f"sharded over {n} devices (queue {M}, W={W} each): "
        f"{int(stats.n_converged)}/{int(stats.n_total)} converged; "
        f"{time.time() - t0:.1f} s incl. compile")

    one = jax.jit(ssolve)
    q = M // n
    parts = [jax.block_until_ready(one(x0q[s:s + q], psq[s:s + q],
                                       us0q[s:s + q]))
             for s in range(0, M, q)]
    us1 = np.concatenate([np.asarray(p.us) for p in parts])
    conv1 = int(sum(int(p.converged.sum()) for p in parts))
    du = float(np.abs(np.asarray(res.us) - us1).max())
    check(int(stats.n_total) == M, f"sharded n_total {int(stats.n_total)}")
    check(int(stats.n_converged) == conv1,
          f"sharded n_converged {int(stats.n_converged)} != one-device "
          f"{conv1}")
    check(du <= 1e-6, f"sharded vs one device: controls differ by {du}")
    check(bool(jnp.isfinite(res.cost).all()), "sharded: non-finite cost")
    log(f"sharded vs one device: ok, psum'd counts equal ({conv1}/{M}), "
        f"controls max |du| {du:.1e} (bound 1e-6)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded phase, on four GPUs")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
                 f"{devs[0].platform!r}")
    need = 4 if args.four else 1
    if len(devs) < need:
        sys.exit(f"chip_smoke.py --four needs 4 GPUs; JAX found {len(devs)}")
    sys.path.insert(0, ROOT)
    import bench
    from mpc_verde_tpu.utils import resolve_backend, use_compile_cache

    log(f"gpu: {bench.gpu_info()}")
    log(f"jax {jax.__version__}; devices {len(devs)} x {devs[0].device_kind}")
    log(f"compile cache: {use_compile_cache()}")
    log(f"riccati backend: {resolve_backend(None, 2)}")
    t_start = time.time()
    if args.four:
        phase_sharded(n=4)
    else:
        phase_kernel()
        x0q, psq, us0q, full, fast = phase_streaming()
        phase_batched(x0q, psq, us0q, fast)
        phase_fleets()
        phase_barrier(x0q, psq, us0q)
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
