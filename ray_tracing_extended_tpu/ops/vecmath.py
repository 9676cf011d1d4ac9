"""Vector math helpers matching HLSL intrinsic semantics.

Everything operates on ``(..., 3)`` float32 arrays and is pure
element-wise work that XLA fuses into surrounding kernels.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def dot(a, b):
    """Row-wise dot product over the trailing axis."""
    return jnp.sum(a * b, axis=-1)


def normalize(v):
    """HLSL ``normalize``: ``v * rsqrt(dot(v, v))`` (inf/nan for zero vectors,
    matching the shader rather than guarding)."""
    return v * lax.rsqrt(jnp.sum(v * v, axis=-1, keepdims=True))


def reflect(i, n):
    """HLSL ``reflect``: ``i - 2 * dot(i, n) * n``."""
    return i - 2.0 * dot(i, n)[..., None] * n


def lerp(a, b, t):
    """HLSL ``lerp``: ``a + t * (b - a)`` (t may broadcast)."""
    return a + t * (b - a)


def cross(a, b):
    """Cross product over the trailing axis (explicit, fusion-friendly)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def smoothstep(lo, hi, x):
    """HLSL ``smoothstep``: cubic Hermite of the clamped normalized input."""
    t = jnp.clip((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def saturate(x):
    """HLSL ``saturate``: clamp to [0, 1]."""
    return jnp.clip(x, 0.0, 1.0)
