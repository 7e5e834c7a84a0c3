"""Sharded batched solves: shard_map over the batch mesh + psum reductions.

Replaces the reference's serial sweep loops (``Phiref.py:24-28`` runs horizon/
weight configs one IPOPT instance at a time) with a data-parallel program: the
batch of MPC problems is sharded over the mesh, each chip vmaps its shard, and
the only cross-chip traffic is ``psum`` of scalar solve statistics — the
pattern SURVEY.md §5.8 prescribes (collectives ride ICI, scaling stays
near-linear because no per-problem data ever crosses chips).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import BATCH_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Global (cross-chip) statistics of a batched solve — the batched
    analogue of IPOPT's per-step status string
    (``Trajectory_tracking.py:110``): one failing batch member must be
    visible without poisoning the batch."""

    n_total: jnp.ndarray
    n_converged: jnp.ndarray
    mean_cost: jnp.ndarray
    max_grad_norm: jnp.ndarray
    max_iterations: jnp.ndarray


def make_sharded_solver(solve: Callable, mesh: Mesh, axis_name: str = BATCH_AXIS,
                        batched: bool = False):
    """Wrap a solver into a mesh-sharded batched solve.

    ``solve`` is a single-problem ``solve(x0, params, us_init)`` (vmapped per
    chip) or, with ``batched=True``, an already batch-major solver from
    ``make_batched_ilqr_solver`` (e.g. the Pallas-backward fast path) applied
    to each chip's shard directly.

    Returns ``solve_batch(x0s, params, us_inits) -> (ILQRResult, BatchStats)``
    where the leading batch axis of every argument/result is sharded over
    ``mesh``.  The batch size must be divisible by the mesh size.

    Per-chip work is vmap/kernel; cross-chip reductions are ``psum`` —
    compiled by XLA into ICI collectives on a pod slice.
    """
    vsolve = solve if batched else jax.vmap(solve)

    def _shard_body(x0s, params, us_inits):
        res = vsolve(x0s, params, us_inits)
        n_conv = jax.lax.psum(jnp.sum(res.converged.astype(jnp.int32)), axis_name)
        n_tot = jax.lax.psum(jnp.asarray(res.converged.shape[0], jnp.int32), axis_name)
        cost_sum = jax.lax.psum(jnp.sum(res.cost), axis_name)
        gmax = jax.lax.pmax(jnp.max(res.grad_norm), axis_name)
        imax = jax.lax.pmax(jnp.max(res.iterations), axis_name)
        stats = BatchStats(
            n_total=n_tot, n_converged=n_conv,
            mean_cost=cost_sum / n_tot.astype(cost_sum.dtype),
            max_grad_norm=gmax, max_iterations=imax,
        )
        return res, stats

    # check_vma=False: a Pallas kernel inside the solve (the GPU Riccati
    # backward) has no varying-axes typing; the stats are psum'd, so they
    # are replicated as out_specs P() says
    sharded = jax.shard_map(
        _shard_body, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P()), check_vma=False,
    )

    @jax.jit
    def solve_batch(x0s, params, us_inits):
        return sharded(x0s, params, us_inits)

    return solve_batch
