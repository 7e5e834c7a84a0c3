"""Sharded batched solve on a virtual 8-device CPU mesh.

SURVEY.md §4(d): multi-chip tests fake the mesh with
``--xla_force_host_platform_device_count=8`` and assert numerics identical to
the single-chip path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mpc_verde_tpu as mv
from mpc_verde_tpu.models import unicycle
from mpc_verde_tpu.ops import rk4_step
from mpc_verde_tpu.parallel import batch_mesh, make_sharded_solver

T, N = 0.2, 8
TARGET = jnp.array([5.0, 5.0, 0.0])


def _ocp():
    F = rk4_step(unicycle.f, T)
    Q = jnp.diag(jnp.array([1.0, 5.0, 0.1]))
    R = jnp.diag(jnp.array([0.5, 0.05]))

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    return mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l,
                  N=N, nx=3, nu=2, npar=3,
                  control_bounds=mv.box_bounds(
                      jnp.array([-1.0, -np.pi / 4]),
                      jnp.array([1.0, np.pi / 4])))


def _solver():
    return mv.make_ilqr_solver(_ocp())


def test_mesh_has_8_devices():
    mesh = batch_mesh()
    assert mesh.devices.size == 8


def test_sharded_solve_matches_vmap():
    solve = _solver()
    mesh = batch_mesh()
    B = 16
    rng = np.random.default_rng(7)
    x0s = jnp.array(rng.uniform(-1, 1, (B, 3)))
    params = jnp.broadcast_to(TARGET, (B, N + 1, 3))
    us0 = jnp.zeros((B, N, 2))

    sharded = make_sharded_solver(solve, mesh)
    res_s, stats = sharded(x0s, params, us0)

    res_v = jax.jit(jax.vmap(solve))(x0s, params, us0)
    assert np.allclose(np.array(res_s.us), np.array(res_v.us), atol=1e-12)
    assert np.allclose(np.array(res_s.cost), np.array(res_v.cost), atol=1e-12)
    assert int(stats.n_total) == B
    assert int(stats.n_converged) == int(res_v.converged.sum())
    assert float(stats.mean_cost) == pytest.approx(float(res_v.cost.mean()), rel=1e-12)


def test_sharded_streaming_matches_unsharded():
    # the streaming (continuous-batching) solver under shard_map: each shard
    # owns a slot batch + queue partition, no collectives inside the solve;
    # per-problem results must match the unsharded solve exactly
    from mpc_verde_tpu.solver.streaming import make_streaming_solver

    ssolve = make_streaming_solver(_ocp(), mv.ILQROptions(max_iters=60),
                                   backend="xla", batch_width=3, restarts=1)
    mesh = batch_mesh()
    solve_batch = make_sharded_solver(ssolve, mesh, batched=True)

    M = 24  # 3 problems per shard
    rng = np.random.default_rng(17)
    x0s = jnp.array(rng.uniform(-1, 1, (M, 3)), jnp.float32)
    params = jnp.broadcast_to(TARGET.astype(jnp.float32), (M, N + 1, 3))
    us0 = jnp.zeros((M, N, 2), jnp.float32)

    res, stats = solve_batch(x0s, params, us0)
    assert int(stats.n_total) == M
    assert int(stats.n_converged) == M
    ref = jax.jit(ssolve)(x0s, params, us0)
    np.testing.assert_array_equal(np.array(ref.cost), np.array(res.cost))
    np.testing.assert_array_equal(np.array(ref.us), np.array(res.us))


def test_sharded_streaming_with_kernel_matches_unsharded():
    """The Riccati kernel (interpreted here) inside shard_map: it carries no
    varying-axes typing, which the sharded solver must accept."""
    from mpc_verde_tpu.solver.streaming import make_streaming_solver

    ssolve = make_streaming_solver(_ocp(), mv.ILQROptions(max_iters=60),
                                   backend="triton", interpret=True,
                                   batch_width=2, restarts=1)
    solve_batch = make_sharded_solver(ssolve, batch_mesh(), batched=True)

    M = 16  # 2 problems per shard
    rng = np.random.default_rng(29)
    x0s = jnp.array(rng.uniform(-1, 1, (M, 3)), jnp.float32)
    params = jnp.broadcast_to(TARGET.astype(jnp.float32), (M, N + 1, 3))
    us0 = jnp.zeros((M, N, 2), jnp.float32)

    res, stats = solve_batch(x0s, params, us0)
    assert int(stats.n_total) == M
    assert int(stats.n_converged) == M
    ref = jax.jit(ssolve)(x0s, params, us0)
    np.testing.assert_array_equal(np.array(ref.cost), np.array(res.cost))
    np.testing.assert_array_equal(np.array(ref.us), np.array(res.us))


def test_sharded_streaming_barrier_matches_unsharded():
    """The streaming IPM (rounds continuation + packed refill) under
    shard_map: the mu-column concat and the per-slot round machinery must
    be shard-invariant — per-problem results match the unsharded solve."""
    from mpc_verde_tpu.solver.ipm import make_streaming_barrier_solver

    isolve = make_streaming_barrier_solver(
        _ocp(), mv.ILQROptions(max_iters=60), backend="xla",
        batch_width=2, restarts=1)
    mesh = batch_mesh()
    solve_batch = make_sharded_solver(isolve, mesh, batched=True)

    M = 16  # 2 problems per shard
    rng = np.random.default_rng(23)
    x0s = jnp.array(rng.uniform(-1, 1, (M, 3)), jnp.float32)
    params = jnp.broadcast_to(TARGET.astype(jnp.float32), (M, N + 1, 3))
    us0 = jnp.zeros((M, N, 2), jnp.float32)

    res, stats = solve_batch(x0s, params, us0)
    assert int(stats.n_converged) == M
    ref = jax.jit(isolve)(x0s, params, us0)
    np.testing.assert_array_equal(np.array(ref.cost), np.array(res.cost))
    np.testing.assert_array_equal(np.array(ref.us), np.array(res.us))
