"""Platform plumbing: the backend choice, the compile cache, the precision
pin and the result pytrees."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import mpc_verde_tpu as mv
from mpc_verde_tpu.models import unicycle
from mpc_verde_tpu.ops import rk4_step
from mpc_verde_tpu.parallel.batch import BatchStats
from mpc_verde_tpu.runtime.receding import ClosedLoopResult
from mpc_verde_tpu.solver.ilqr import ILQRResult
from mpc_verde_tpu.solver.nlp import NLPResult
from mpc_verde_tpu.solver.streaming import make_streaming_solver
from mpc_verde_tpu.utils import (KERNEL_BACKEND, resolve_backend,
                                 use_compile_cache)

N = 4


def _ocp():
    F = rk4_step(unicycle.f, 0.2)
    Q = np.diag([1.0, 5.0, 0.1])
    R = np.diag([0.5, 0.05])

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    return mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l,
                  N=N, nx=3, nu=2, npar=3,
                  control_bounds=mv.box_bounds(np.array([-1.0, -np.pi / 4]),
                                               np.array([1.0, np.pi / 4])))


@pytest.mark.parametrize("platform,nu,want", [
    ("cpu", 2, "xla"),
    ("gpu", 2, KERNEL_BACKEND),
    ("gpu", 3, "xla"),          # the kernel's nu = 3, 4 compile is too slow
    ("gpu", 5, "xla"),          # wider than the kernel's enumeration
])
def test_default_backend_follows_platform(platform, nu, want):
    assert resolve_backend(None, nu, platform=platform) == want
    assert resolve_backend("xla", nu, platform=platform) == "xla"


def test_kernel_request_without_gpu_raises():
    with pytest.raises(ValueError, match="GPU"):
        resolve_backend(KERNEL_BACKEND, 2, platform="cpu")
    # the builders resolve on the platform they run on: this one is a CPU
    with pytest.raises(ValueError, match="GPU"):
        make_streaming_solver(_ocp(), backend=KERNEL_BACKEND)
    with pytest.raises(NotImplementedError):
        resolve_backend(KERNEL_BACKEND, 5, platform="gpu")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas_bw", 2, platform="gpu")
    # the interpreter is an explicit request and needs no GPU
    assert resolve_backend(KERNEL_BACKEND, 2, platform="cpu",
                           interpret=True) == KERNEL_BACKEND


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, from_env):
    before = jax.config.jax_compilation_cache_dir
    try:
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert use_compile_cache() == str(tmp_path)
            # the variable is JAX's own: nothing else is set
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            want = os.path.join(root, ".jax_cache")
            assert use_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_lowered_streaming_solve_pins_highest_precision():
    """Every dot of the solve — the user's cost, the linearization and the
    Riccati products — asks for HIGHEST, so TF32 never enters a solve."""
    M = 3
    solve = jax.jit(make_streaming_solver(_ocp(), mv.ILQROptions(max_iters=5),
                                          backend="xla", batch_width=2))
    text = solve.lower(np.zeros((M, 3)),
                       np.zeros((M, N + 1, 3)),
                       np.zeros((M, N, 2))).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots
    for ln in dots:
        assert re.search(r"precision\s*=\s*\[HIGHEST,\s*HIGHEST\]", ln), ln


def _results(B):
    z = jnp.zeros((B,))
    zi = jnp.zeros((B,), jnp.int32)
    zb = jnp.zeros((B,), bool)
    return [
        ILQRResult(xs=jnp.zeros((B, N + 1, 3)), us=jnp.zeros((B, N, 2)),
                   cost=z, grad_norm=z, iterations=zi, converged=zb,
                   max_violation=z),
        NLPResult(x=jnp.zeros((B, 2)), f=z, g=jnp.zeros((B, 1)),
                  lam_g=jnp.zeros((B, 1)), kkt=z, viol=z, iterations=zi,
                  converged=zb),
        ClosedLoopResult(xs=jnp.zeros((B, 3)), us=jnp.zeros((B, 2)),
                         costs=z, iterations=zi, converged=zb),
        BatchStats(n_total=zi, n_converged=zi, mean_cost=z,
                   max_grad_norm=z, max_iterations=zi),
    ]


@pytest.mark.parametrize("k", range(4), ids=["ILQRResult", "NLPResult",
                                             "ClosedLoopResult", "BatchStats"])
def test_result_dataclasses_are_pytrees(k):
    n = len(jax.devices())
    r = _results(n)[k]

    def bump(t):
        return jax.tree.map(lambda a: a + 1, t)

    want = bump(r)
    for out in (jax.jit(bump)(r), jax.vmap(bump)(r),
                jax.shard_map(bump, mesh=Mesh(np.array(jax.devices()), ("b",)),
                              in_specs=P("b"), out_specs=P("b"))(r)):
        assert type(out) is type(r)
        assert jax.tree.structure(out) == jax.tree.structure(r)
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
