"""Worker process for the two-process distributed solve test.

Each process owns 4 virtual CPU devices (8 global).  The batch of MPC
problems is sharded over the GLOBAL mesh: every process feeds its host-local
shard, `shard_map` + `psum` run across process boundaries (here the local TCP
coordinator), and process 0 writes the gathered result for the
parent test to compare against a single-process solve.

Usage: python tests/_dist_worker.py <coordinator> <num_procs> <pid> <outfile>
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coord, nproc, pid, outfile = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    import jax

    # the parent's XLA_FLAGS (8 virtual devices) are inherited; the config
    # value sets this process's own count
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import mpc_verde_tpu as mv
    from mpc_verde_tpu.models import unicycle
    from mpc_verde_tpu.ops import rk4_step
    from mpc_verde_tpu.parallel import make_sharded_solver
    from mpc_verde_tpu.parallel.mesh import BATCH_AXIS

    assert jax.device_count() == 4 * nproc, jax.devices()
    assert jax.process_count() == nproc

    T, N = 0.2, 8
    F = rk4_step(unicycle.f, T)
    Q = jnp.diag(jnp.array([1.0, 5.0, 0.1], jnp.float32))
    R = jnp.diag(jnp.array([0.5, 0.05], jnp.float32))

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    ocp = mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l,
                 N=N, nx=3, nu=2, npar=3,
                 control_bounds=mv.box_bounds(
                     jnp.array([-1.0, -np.pi / 4]), jnp.array([1.0, np.pi / 4])))
    solve = mv.make_ilqr_solver(ocp, mv.ILQROptions(max_iters=60))

    mesh = Mesh(np.array(jax.devices()), (BATCH_AXIS,))
    solve_batch = make_sharded_solver(solve, mesh)

    # the full problem set is deterministic on every process; each process
    # CONTRIBUTES only its host-local shard, as a real pod job would
    B = 16
    rng = np.random.default_rng(11)
    x0s_full = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    tgt = np.array([5.0, 5.0, 0.0], np.float32)
    ps_full = np.broadcast_to(tgt, (B, N + 1, 3)).astype(np.float32)
    us_full = np.zeros((B, N, 2), np.float32)

    shard = B // nproc
    lo = pid * shard
    to_global = lambda a: multihost_utils.host_local_array_to_global_array(
        a[lo:lo + shard], mesh, P(BATCH_AXIS))
    res, stats = solve_batch(to_global(x0s_full), to_global(ps_full),
                             to_global(us_full))

    # global stats are replicated; gather the sharded outputs to every host
    us = multihost_utils.process_allgather(res.us, tiled=True)
    cost = multihost_utils.process_allgather(res.cost, tiled=True)
    if pid == 0:
        np.savez(outfile, us=np.asarray(us), cost=np.asarray(cost),
                 n_converged=int(stats.n_converged), n_total=int(stats.n_total))
    multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
