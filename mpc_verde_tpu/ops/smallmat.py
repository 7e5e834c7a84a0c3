"""Closed-form solves for tiny matrices.

The Riccati/box-QP inner loops only ever invert ``nu x nu`` systems (nu <= 2
in every reference problem family; <= 4 anywhere sensible).  ``jnp.linalg.solve``
lowers to pivoted LU, which is scalar-heavy and slow for batched tiny
matrices; adjugate/cofactor formulas keep everything as fused elementwise
math and vectorize perfectly under ``vmap``.
"""
from __future__ import annotations

import jax.numpy as jnp


def small_inv(A):
    """Closed-form inverse for static n in {1, 2, 3}; falls back to
    ``jnp.linalg.inv`` for larger n."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv = jnp.stack([
            jnp.stack([d, -b], axis=-1),
            jnp.stack([-c, a], axis=-1),
        ], axis=-2)
        return inv / det[..., None, None]
    if n == 3:
        m = A
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        adj = jnp.stack([
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ], axis=-2)
        return adj / det[..., None, None]
    return jnp.linalg.inv(A)


def small_solve(A, b):
    """Solve ``A x = b`` with the closed-form inverse for tiny static n.

    ``b`` may be a vector (..., n) or matrix (..., n, m).
    """
    n = A.shape[-1]
    if n <= 3:
        Ainv = small_inv(A)
        if b.ndim == A.ndim - 1:
            return jnp.einsum("...ij,...j->...i", Ainv, b)
        return Ainv @ b
    if b.ndim == A.ndim - 1:
        return jnp.linalg.solve(A, b[..., None])[..., 0]
    return jnp.linalg.solve(A, b)
