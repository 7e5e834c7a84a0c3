"""Device mesh construction and multi-host init.

The reference is strictly single-process CPU (SURVEY.md §2.4); the rebuild's
scale axis is a 1-D ``batch`` mesh: thousands of independent MPC instances
sharded across devices, with only scalar reductions (convergence counts,
merit sums) crossing the interconnect (NVLink between the GPUs of a host,
the network across hosts), all inserted by XLA from ``shard_map``/``psum``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


BATCH_AXIS = "batch"


def batch_mesh(n_devices: Optional[int] = None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available; "
                "for CPU testing set XLA_FLAGS=--xla_force_host_platform_device_count=N"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host startup (``jax.distributed.initialize``).

    Pass the arguments explicitly where no cluster environment provides
    them.  Safe to call when already initialized.
    """
    try:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)
    except RuntimeError:
        pass  # already initialized
