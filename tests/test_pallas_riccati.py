"""Pallas Riccati backward kernel vs the jnp reference.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``);
the compiled Triton kernel is checked by the ``gpu``-marked test here and by
``chip_smoke.py`` on the card.  Parametrized over nu = 1..4: nu <= 2
exercises the closed-form free-subspace solves, nu = 3, 4 the unrolled
Gaussian-elimination path (3^nu static active-set patterns — 27 / 81
candidates per stage).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mpc_verde_tpu as mv
from mpc_verde_tpu.models import unicycle
from mpc_verde_tpu.ops import rk4_step
from mpc_verde_tpu.ops.pallas.riccati import BLOCK, riccati_backward_pallas
from mpc_verde_tpu.ops.smallmat import small_solve
from mpc_verde_tpu.solver.boxqp import _eval_pattern, _patterns
from mpc_verde_tpu.solver.streaming import make_streaming_solver

N, B = 6, 4  # tiny shapes; the kernel pads the batch to its block


def _reference_backward(d, dlb, dub, gN, HN, reg, nx, nu, use_ddp=True):
    """Same math as solver/ilqr.py backward, per problem."""
    pats = jnp.asarray(_patterns(nu))

    def one(d1, dlb1, dub1, gN1, HN1, reg1):
        def stage(carry, inp):
            Vx, Vxx, dV1, dV2, gmax = carry
            fx, fu, lx, lu, lxx, luu, lux, fxx, fux, fuu, lo, hi = inp
            Qx = lx + fx.T @ Vx
            Qu = lu + fu.T @ Vx
            Qxx = lxx + fx.T @ Vxx @ fx
            Quu = luu + fu.T @ Vxx @ fu + reg1 * jnp.eye(nu, dtype=lu.dtype)
            Qux = lux + fu.T @ Vxx @ fx
            if use_ddp:
                Qxx = Qxx + jnp.einsum("i,ijk->jk", Vx, fxx)
                Qux = Qux + jnp.einsum("i,ijk->jk", Vx, fux)
                Quu = Quu + jnp.einsum("i,ijk->jk", Vx, fuu)
            vs, ms, objs = jax.vmap(
                lambda p: _eval_pattern(p, Quu, Qu, lo, hi, 1e-8))(pats)
            b = jnp.argmin(objs)
            kff, m = vs[b], ms[b]
            A = m[:, None] * Quu * m[None, :] + jnp.diag(1.0 - m)
            K = -small_solve(A, m[:, None] * Qux)
            dV1 = dV1 + kff @ Qu
            dV2 = dV2 + 0.5 * kff @ Quu @ kff
            Vx_n = Qx + K.T @ Quu @ kff + K.T @ Qu + Qux.T @ kff
            Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            pg = -jnp.clip(-Qu, lo, hi)
            gmax = jnp.maximum(gmax, jnp.max(jnp.abs(pg)))
            return (Vx_n, 0.5 * (Vxx_n + Vxx_n.T), dV1, dV2, gmax), (kff, K)

        z = jnp.zeros(())
        init = (gN1, HN1, z, z, z)
        inputs = (d1["fx"], d1["fu"], d1["lx"], d1["lu"], d1["lxx"],
                  d1["luu"], d1["lux"], d1["fxx"], d1["fux"], d1["fuu"],
                  dlb1, dub1)
        (_, _, dV1, dV2, gmax), (kffs, Ks) = jax.lax.scan(
            stage, init, inputs, reverse=True)
        return kffs, Ks, dV1, dV2, gmax

    return jax.vmap(one)(d, dlb, dub, gN, HN, reg)


def _random_problem(rng, nx, nu, B=B):
    d = {
        "fx": rng.normal(size=(B, N, nx, nx)) * 0.3 + np.eye(nx),
        "fu": rng.normal(size=(B, N, nx, nu)) * 0.3,
        "lx": rng.normal(size=(B, N, nx)),
        "lu": rng.normal(size=(B, N, nu)),
        "lxx": np.tile(2 * np.eye(nx), (B, N, 1, 1))
               + 0.1 * rng.normal(size=(B, N, nx, nx)),
        "luu": np.tile(np.eye(nu), (B, N, 1, 1)),
        "lux": 0.1 * rng.normal(size=(B, N, nu, nx)),
        "fxx": 0.05 * rng.normal(size=(B, N, nx, nx, nx)),
        "fux": 0.05 * rng.normal(size=(B, N, nx, nu, nx)),
        "fuu": 0.05 * rng.normal(size=(B, N, nx, nu, nu)),
    }
    d["lxx"] = 0.5 * (d["lxx"] + d["lxx"].transpose(0, 1, 3, 2))
    dlb = np.full((B, N, nu), -0.7)
    dub = np.full((B, N, nu), 0.5)
    # a mix of active/inactive boxes and an equality (move-blocked) stage
    dlb[:, -1, :] = 0.0
    dub[:, -1, :] = 0.0
    gN = rng.normal(size=(B, nx))
    HN = np.tile(np.eye(nx), (B, 1, 1))
    reg = np.full((B,), 1e-6)
    return d, dlb, dub, gN, HN, reg


def _check(nx, nu, d, dlb, dub, gN, HN, reg, **kw):
    """Kernel vs reference in f32 at the kernel's tolerances."""
    f32 = lambda t: jnp.asarray(t, jnp.float32)
    d32 = {k: f32(v) for k, v in d.items()}
    kff_r, K_r, dV1_r, dV2_r, gmax_r = _reference_backward(
        d32, f32(dlb), f32(dub), f32(gN), f32(HN), f32(reg), nx, nu)
    kff_p, K_p, dV1_p, dV2_p, gmax_p = riccati_backward_pallas(
        d32, f32(dlb), f32(dub), f32(gN), f32(HN), f32(reg),
        nx=nx, nu=nu, use_ddp=True, **kw)
    assert kff_p.shape == kff_r.shape and K_p.shape == K_r.shape
    assert dV1_p.shape == dV2_p.shape == gmax_p.shape == (d["fx"].shape[0],)
    assert np.allclose(np.array(kff_p), np.array(kff_r), atol=2e-4), (
        np.abs(np.array(kff_p) - np.array(kff_r)).max())
    assert np.allclose(np.array(K_p), np.array(K_r), atol=2e-3), (
        np.abs(np.array(K_p) - np.array(K_r)).max())
    assert np.allclose(np.array(dV1_p), np.array(dV1_r), atol=1e-3)
    assert np.allclose(np.array(gmax_p), np.array(gmax_r), atol=1e-4)


@pytest.mark.parametrize("nx,nu", [
    (3, 1), (3, 2),
    pytest.param(4, 3, marks=pytest.mark.slow),
    pytest.param(5, 4, marks=pytest.mark.slow),
])
def test_kernel_matches_reference_interpret(rng, nx, nu):
    _check(nx, nu, *_random_problem(rng, nx, nu), interpret=True)


@pytest.mark.parametrize("batch", [BLOCK + 5, 2 * BLOCK - 1])
def test_kernel_pads_ragged_batch(rng, batch):
    """A batch that is not a multiple of the block: the padded problems
    must neither leak into the real ones nor change the output shapes."""
    _check(3, 2, *_random_problem(rng, 3, 2, B=batch), interpret=True)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(rng, gpu):
    with jax.default_device(gpu):
        _check(3, 2, *_random_problem(rng, 3, 2, B=2 * BLOCK + 3))


def test_nu5_rejected():
    with pytest.raises(NotImplementedError):
        riccati_backward_pallas({"fx": jnp.zeros((1, 2, 3, 3))}, None, None,
                                None, None, None, nx=3, nu=5)


def test_streaming_solve_with_kernel_matches_xla():
    """The whole streaming solve with the kernel (interpreted) as its
    backward lands on the XLA backward's optimum."""
    T, Nh = 0.2, 8
    F = rk4_step(unicycle.f, T)
    Q = np.diag([1.0, 5.0, 0.1])
    R = np.diag([0.5, 0.05])

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    ocp = mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l,
                 N=Nh, nx=3, nu=2, npar=3,
                 control_bounds=mv.box_bounds(np.array([-1.0, -np.pi / 4]),
                                              np.array([1.0, np.pi / 4])))
    opts = mv.ILQROptions(max_iters=60)
    M = 6
    x0s = np.random.default_rng(3).uniform(-1, 1, (M, 3))
    ps = np.broadcast_to(np.array([5.0, 5.0, 0.0]), (M, Nh + 1, 3))
    us0 = np.zeros((M, Nh, 2))
    rx = jax.jit(make_streaming_solver(ocp, opts, backend="xla",
                                       batch_width=4))(x0s, ps, us0)
    rk = jax.jit(make_streaming_solver(ocp, opts, backend="triton",
                                       batch_width=4, interpret=True))(
        x0s, ps, us0)
    assert bool(rx.converged.all()) and bool(rk.converged.all())
    # the kernel's gains are f32: the optimum agrees to f32 round-off
    np.testing.assert_allclose(np.array(rk.us), np.array(rx.us), atol=1e-4)
    np.testing.assert_allclose(np.array(rk.cost), np.array(rx.cost),
                               rtol=1e-6)
