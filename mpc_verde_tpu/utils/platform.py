"""Platform helpers: CPU pinning, the solver's kernel choice, compile cache."""
from __future__ import annotations

import os

# the Riccati backward kernel (``ops/pallas/riccati.py``, Pallas on the
# Triton route); it compiles for NVIDIA GPUs only
KERNEL_BACKEND = "triton"
_BACKENDS = ("xla", "scan", KERNEL_BACKEND)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def force_cpu(n_virtual_devices: int | None = None) -> None:
    """Pin JAX to the host CPU, optionally as ``n`` virtual devices.

    Call before any JAX computation: the platform and the CPU device count
    are fixed when the first backend starts.
    """
    import jax

    jax.config.update("jax_platforms", "cpu")
    if n_virtual_devices is not None:
        jax.config.update("jax_num_cpu_devices", n_virtual_devices)


def resolve_backend(backend: str | None, nu: int, platform: str | None = None,
                    interpret: bool = False) -> str:
    """The Riccati backward a solver uses on ``platform``.

    ``None`` picks from the platform (default: JAX's default backend): the
    Triton kernel on ``"gpu"`` for nu <= 2, the vmapped XLA scan everywhere
    else.  The kernel also takes nu = 3, 4, but on an H100 it compiles for
    ~12 minutes at (nx, nu) = (5, 4) against ~12 s at (3, 2) (PERF.md), so
    only an explicit request gets it there.  An explicit ``"xla"`` or
    ``"scan"`` is taken as given.  An explicit kernel request raises where
    the kernel cannot compile (no GPU, nu > 4) unless ``interpret`` asks for
    the Pallas interpreter.
    """
    if platform is None:
        import jax

        platform = jax.default_backend()
    if backend is None:
        return KERNEL_BACKEND if platform == "gpu" and nu <= 2 else "xla"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose one of "
                         f"{_BACKENDS} or None (from the platform)")
    if backend == KERNEL_BACKEND:
        if nu > 4:
            raise NotImplementedError(
                "the Riccati kernel supports nu <= 4; use backend='xla' for "
                "wider control vectors")
        if platform != "gpu" and not interpret:
            raise ValueError(
                f"backend={KERNEL_BACKEND!r} compiles for a GPU only (this "
                f"platform is {platform!r}); pass interpret=True to run it in "
                "the Pallas interpreter")
    return backend


def use_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as JAX reads it, and no
    other directory is set.  Otherwise the cache is ``<repo>/.jax_cache``: a
    fixed path, since the path is part of the cache key.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
