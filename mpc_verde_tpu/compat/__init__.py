"""mpctools-compatible API surface.

Lets code written against the reference's MPCTools contract (SURVEY.md §2.2)
run on the JAX stack with the same call shapes:

    import mpc_verde_tpu.compat as mpc
    f = mpc.getCasadiFunc(ode, [Nx, Nu], ["x", "u"], rk4=True, Delta=dt)
    solver = mpc.nmpc(f, l, N, x0, lb, ub, p=p, uprev=uprev, funcargs=...)
    solver.fixvar("x", 0, x0); solver.solve(); u0 = solver.var["u", 0, :]
"""
from .nmpc import (
    NMPCSolver,
    callSolver,
    getCasadiFunc,
    nmpc,
    util,
    DiscreteSimulator,
    mtimes,
)
from . import plots

# CasADi-compatible symbolic layer (SX/DM/Function/nlpsol):
#   import mpc_verde_tpu.compat.casadi as ca
from . import casadi
