"""mpc_verde_tpu — a batched nonlinear-MPC framework on JAX.

A from-scratch rebuild of the capabilities of ``gabrielhaj/mpc-verde``
(receding-horizon MPC for differential-drive robots, an inverted pendulum on a
cart, and bicycle-model trajectory tracking), replacing its CasADi + IPOPT +
MPCTools stack with JAX/XLA: ``lax.scan`` rollouts, autodiff linearization, a
box-constrained iLQR/Riccati solver, a Pallas Riccati kernel for NVIDIA GPUs,
and ``shard_map`` batch parallelism over device meshes.

Layer map (mirrors SURVEY.md §1):
  L0 autodiff/tracing      -> JAX itself
  L1 dynamics/integrators  -> mpc_verde_tpu.models, mpc_verde_tpu.ops
  L2 OCP + solver          -> mpc_verde_tpu.ocp, mpc_verde_tpu.solver
  L3 closed-loop driver    -> mpc_verde_tpu.runtime
  L4 references/viz/bench  -> mpc_verde_tpu.refgen, mpc_verde_tpu.viz
  parallel scale-out       -> mpc_verde_tpu.parallel
  mpctools-style API       -> mpc_verde_tpu.compat
"""

__version__ = "0.1.0"

from . import models, ops, ocp, solver
from .ocp import OCP, box_bounds, to_rate_form
from .solver import ILQROptions, ILQRResult, make_ilqr_solver
