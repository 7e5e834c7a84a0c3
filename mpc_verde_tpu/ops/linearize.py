"""Stage-wise linearization / quadratization via JAX autodiff.

Replaces CasADi's symbolic Jacobian/Hessian machinery (the exact derivatives
IPOPT consumes through ``ca.nlpsol`` — SURVEY.md §2.3): ``jax.jacfwd`` on the
discrete dynamics and a forward-over-reverse Hessian of the stage cost, both
``vmap``-ed over the horizon so the whole trajectory linearizes as one fused
batched kernel.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def linearize_dynamics(F: Callable):
    """Return ``(x, u, p) -> (fx, fu)``, Jacobians of the discrete step.

    Forward-mode is optimal here: nx+nu tangents of a cheap function, and the
    result feeds the Riccati recursion as (nx, nx) / (nx, nu) blocks.
    """

    def lin(x, u, p):
        fx = jax.jacfwd(lambda xx: F(xx, u, p))(x)
        fu = jax.jacfwd(lambda uu: F(x, uu, p))(u)
        return fx, fu

    return lin


def quadratize_cost(l: Callable):
    """Return ``(x, u, p) -> (lx, lu, lxx, luu, lux)`` for a stage cost.

    ``lux`` has shape (nu, nx) — d²l/du dx — matching the Riccati convention
    ``Qux = lux + fu^T Vxx fx``.
    """

    def quad(x, u, p):
        nx = x.shape[-1]
        z = jnp.concatenate([x, u])

        def lz(zz):
            return l(zz[:nx], zz[nx:], p)

        g = jax.grad(lz)(z)
        H = jax.jacfwd(jax.grad(lz))(z)
        lx, lu = g[:nx], g[nx:]
        lxx = H[:nx, :nx]
        luu = H[nx:, nx:]
        lux = H[nx:, :nx]
        return lx, lu, lxx, luu, lux

    return quad


def dynamics_hessians(F: Callable):
    """Return ``(x, u, p) -> (fxx, fux, fuu)`` — second derivatives of the
    discrete step, for full DDP backward passes.

    Shapes: fxx (nx, nx, nx) with fxx[i, j, k] = d2 F_i / dx_j dx_k;
    fux (nx, nu, nx); fuu (nx, nu, nu).  At nx <= 6 these are a handful of
    extra fused HLOs per stage — cheap elementwise work, and they buy quadratic
    local convergence (iLQR's Gauss-Newton tail is what stalls on
    unicycle-type problems).
    """

    def hess(x, u, p):
        nx = x.shape[-1]
        z = jnp.concatenate([x, u])

        def Fz(zz):
            return F(zz[:nx], zz[nx:], p)

        H = jax.jacfwd(jax.jacfwd(Fz))(z)  # (nx_out, nz, nz)
        fxx = H[:, :nx, :nx]
        fux = H[:, nx:, :nx]
        fuu = H[:, nx:, nx:]
        return fxx, fux, fuu

    return hess


def linearize_trajectory(F: Callable, l: Callable, xs, us, ps,
                         second_order: bool = False):
    """Linearize dynamics + quadratize cost along a trajectory.

    Args:
      F: discrete dynamics ``(x, u, p) -> x_next``.
      l: stage cost ``(x, u, p) -> scalar``.
      xs: (N, nx) states at stages 0..N-1.
      us: (N, nu) controls.
      ps: (N, np) per-stage parameters (or None).
      second_order: also return dynamics Hessians (DDP).

    Returns dict of stage-stacked derivative tensors.
    """
    lin = linearize_dynamics(F)
    quad = quadratize_cost(l)
    fx, fu = jax.vmap(lin)(xs, us, ps)
    lx, lu, lxx, luu, lux = jax.vmap(quad)(xs, us, ps)
    out = {"fx": fx, "fu": fu, "lx": lx, "lu": lu, "lxx": lxx, "luu": luu,
           "lux": lux}
    if second_order:
        fxx, fux, fuu = jax.vmap(dynamics_hessians(F))(xs, us, ps)
        out.update({"fxx": fxx, "fux": fux, "fuu": fuu})
    return out
