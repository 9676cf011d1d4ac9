"""Counter-free PCG-hash RNG, bit-exact to the reference shader.

The reference threads a single ``uint`` state per pixel through every sample
of that pixel (seeded as ``pixelIndex + frame * 719393``) and draws from it
with a PCG output hash. We reproduce the integer recurrence exactly in uint32
so renders are cross-implementation deterministic: the same (pixel, frame)
consumes the identical random stream as the HLSL shader.

Reference semantics: ``Assets/Scripts/Shaders/RayTracing.shader:193-230``
(NextRandom / RandomValue / RandomValueNormalDistribution / RandomDirection /
RandomPointInCircle) and the seed layout at ``RayTracing.shader:358-362``.

All functions are shape-polymorphic: ``state`` may be any uint32 array and
every sampler returns ``(new_state, value)`` with value broadcast to the
state's shape (vector samplers stack on a trailing axis).

Everything here is pure element-wise math on uint32/f32 -
wraparound multiply/add, shifts, xor, and a handful of transcendentals
(cos/log/sqrt). No gathers, no dynamic shapes; fuses into surrounding kernels.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# PCG constants (RayTracing.shader:195-197).
_MUL = jnp.uint32(747796405)
_INC = jnp.uint32(2891336453)
_OUT_MUL = jnp.uint32(277803737)

# Frame-seed stride (RayTracing.shader:362).
FRAME_SEED_STRIDE = 719393

# The shader's low-precision PI (RayTracing.shader:35) used by
# RandomPointInCircle, and the higher-precision one used by Box-Muller
# (RayTracing.shader:210).
PI_LOWP = jnp.float32(3.1415)
PI_BOXMULLER = jnp.float32(3.1415926)

# 2^32 - 1 as an f32 literal; rounds to 2^32, matching the HLSL float literal.
_INV_U32_MAX = jnp.float32(1.0) / jnp.float32(4294967295.0)


def seed(pixel_index, frame):
    """Per-pixel RNG seed: ``pixelIndex + frame * 719393`` in uint32 wraparound.

    ``pixel_index = y * width + x`` with row 0 at the image bottom (Unity UV
    origin). Reference: RayTracing.shader:358-362.
    """
    pixel_index = jnp.asarray(pixel_index).astype(jnp.uint32)
    frame = jnp.asarray(frame).astype(jnp.uint32)
    return pixel_index + frame * jnp.uint32(FRAME_SEED_STRIDE)


def next_random(state):
    """One PCG step. Returns ``(new_state, uint32 output)``.

    Bit-exact to RayTracing.shader:193-199.
    """
    state = state * _MUL + _INC
    shift = (state >> jnp.uint32(28)) + jnp.uint32(4)
    result = ((state >> shift) ^ state) * _OUT_MUL
    result = (result >> jnp.uint32(22)) ^ result
    return state, result


def random_value(state):
    """Uniform f32 in [0, 1]: ``NextRandom / (2^32 - 1)``.

    Reference: RayTracing.shader:201-204.
    """
    state, bits = next_random(state)
    return state, bits.astype(jnp.float32) * _INV_U32_MAX


def random_value_normal(state):
    """Standard normal via Box-Muller (cos branch), consuming two draws.

    Reference: RayTracing.shader:207-213. Note the reference takes
    ``log(RandomValue)`` which is -inf with probability 2^-32; we reproduce
    that behavior rather than clamping.
    """
    state, r1 = random_value(state)
    state, r2 = random_value(state)
    theta = jnp.float32(2.0) * PI_BOXMULLER * r1
    rho = jnp.sqrt(jnp.float32(-2.0) * jnp.log(r2))
    return state, rho * jnp.cos(theta)


def random_direction(state):
    """Uniform unit vector: normalized 3D Gaussian, consuming six draws.

    Returns ``(state, (..., 3))``. Reference: RayTracing.shader:216-223.
    """
    state, x = random_value_normal(state)
    state, y = random_value_normal(state)
    state, z = random_value_normal(state)
    v = jnp.stack([x, y, z], axis=-1)
    inv_len = lax.rsqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return state, v * inv_len


def random_point_in_circle(state):
    """Uniform point in the unit disc, consuming two draws.

    angle = U * 2 * PI (shader's 3.1415), radius = sqrt(U).
    Returns ``(state, (..., 2))``. Reference: RayTracing.shader:225-230.
    """
    state, r1 = random_value(state)
    angle = r1 * jnp.float32(2.0) * PI_LOWP
    state, r2 = random_value(state)
    radius = jnp.sqrt(r2)
    return state, jnp.stack(
        [jnp.cos(angle) * radius, jnp.sin(angle) * radius], axis=-1
    )
