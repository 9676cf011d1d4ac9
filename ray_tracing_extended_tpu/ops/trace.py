"""The path-tracing bounce loop: an iterative, masked, fixed-shape rewrite of
the reference's per-thread shader loop (Trace, RayTracing.shader:300-352).

Mapping: the reference relies on per-thread early exit (Russian-roulette
break, miss break). XLA wants dense fixed-shape work, so every lane iterates
under an ``alive`` mask and per-lane state (origin, direction, throughput,
RNG) only advances where the mask allows - crucially the PCG state, so a
masked lane's random stream is frozen exactly like a returned HLSL thread's.
The loop is a ``lax.while_loop`` that also terminates early once *all* lanes
in the batch are dead (common for low bounce counts / env-off scenes), which
XLA compiles to a device-side loop with no host sync.

Per-bounce semantics, in reference order (RayTracing.shader:305-349):
  1. closest hit over the whole scene
  2. checker / invisible-light flag handling
  3. specular-lottery scatter (1 + 6 random draws)
  4. emission accumulate, throughput multiply
  5. Russian roulette every bounce: survive iff U < max(rgb(throughput)),
     boost by 1/p (1 draw)
  6. on miss: add environment light, die
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
from jax import lax

from ..models.geometry import Scene
from . import rng as rng_ops
from . import vecmath as vm
from .environment import environment_light
from .intersect import HitRecord, closest_hit_bruteforce
from .materials import checker_colour, passthrough_mask, scatter

# Invisible-light passthrough origin advance (RayTracing.shader:320).
PASSTHROUGH_EPS = jnp.float32(0.001)


def trace(
    state,
    origin,
    direction,
    scene: Scene,
    max_bounce: int,
    intersect_fn: Callable[..., HitRecord] | None = None,
    with_bounce_counts: bool = False,
):
    """Trace a batch of rays to completion.

    Args:
      state: (B,) uint32 per-ray PCG states (threaded through, like the
        shader's ``inout rngState``).
      origin, direction: (B, 3) f32, unit directions.
      scene: device scene.
      max_bounce: static; the loop runs ``bounce <= max_bounce`` inclusive
        (RayTracing.shader:305).
      intersect_fn: closest-hit implementation ``(o, d, scene) -> HitRecord``
        (defaults to the brute-force scan; the BVH traversal slots in
        here).

    Returns ``(state, incoming_light, segments)`` with incoming_light (B, 3)
    and segments (B,) int32 = number of rays actually traced per lane (each
    scene intersection of a live lane counts one - the honest denominator
    for Mrays/s). With ``with_bounce_counts`` a fourth element is returned:
    (max_bounce + 1,) int32 live-lane counts per bounce index (the
    alive-fraction-per-bounce observability signal, SURVEY.md section 5).
    """
    if intersect_fn is None:
        intersect_fn = closest_hit_bruteforce

    b = origin.shape[0]
    incoming = jnp.zeros((b, 3), jnp.float32)
    colour = jnp.ones((b, 3), jnp.float32)
    alive = jnp.ones((b,), bool)
    segments = jnp.zeros((b,), jnp.int32)
    counts = jnp.zeros((max_bounce + 1,), jnp.int32)
    bounce0 = jnp.int32(0)

    def cond(carry):
        bounce_idx, _, _, _, _, _, alive, _, _ = carry
        return (bounce_idx <= max_bounce) & jnp.any(alive)

    def body(carry):
        (bounce_idx, state, o, d, incoming, colour, alive, segments,
         counts) = carry
        segments = segments + alive.astype(jnp.int32)
        if with_bounce_counts:
            counts = counts.at[bounce_idx].add(
                jnp.sum(alive, dtype=jnp.int32)
            )
        # Park dead lanes far outside every scene bound, pointing away: a
        # BVH traversal then rejects them at the root box, so dead rays stop
        # paying for node visits (brute force costs the same either way).
        o_live = jnp.where(alive[..., None], o, jnp.float32(1.0e9))
        d_live = jnp.where(
            alive[..., None],
            d,
            jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
        )
        hit = intersect_fn(o_live, d_live, scene)
        did_hit = hit.hit & alive
        mat = scene.materials.take(hit.mat_idx)

        base_colour = checker_colour(mat, hit.point)
        passthru = passthrough_mask(mat, bounce_idx, did_hit)
        scattering = did_hit & ~passthru

        new_state, new_o, new_d, is_spec = scatter(
            state, d, hit.point, hit.normal, mat
        )
        emitted = mat.emission_colour * mat.emission_strength[..., None]
        inc_hit = incoming + emitted * colour
        col_hit = colour * vm.lerp(
            base_colour, mat.specular_colour, is_spec[..., None]
        )
        # Russian roulette (RayTracing.shader:337-342). The 1/p boost uses a
        # tiny-clamped denominator purely to keep dead lanes NaN-free under
        # jax_debug_nans; surviving lanes have p > U >= 0.
        p = jnp.max(col_hit, axis=-1)
        new_state, u_rr = rng_ops.random_value(new_state)
        survive = u_rr < p
        col_boosted = col_hit * (1.0 / jnp.maximum(p, jnp.float32(1e-30)))[
            ..., None
        ]

        missed = alive & ~hit.hit
        inc_miss = incoming + environment_light(d, scene.env) * colour

        sc3 = scattering[..., None]
        o_next = jnp.where(
            passthru[..., None],
            hit.point + d * PASSTHROUGH_EPS,
            jnp.where(sc3, new_o, o),
        )
        d_next = jnp.where(sc3, new_d, d)
        incoming_next = jnp.where(
            sc3, inc_hit, jnp.where(missed[..., None], inc_miss, incoming)
        )
        colour_next = jnp.where(sc3 & survive[..., None], col_boosted, colour)
        state_next = jnp.where(scattering, new_state, state)
        alive_next = passthru | (scattering & survive)
        return (
            bounce_idx + 1,
            state_next,
            o_next,
            d_next,
            incoming_next,
            colour_next,
            alive_next,
            segments,
            counts,
        )

    carry = (
        bounce0, state, origin, direction, incoming, colour, alive,
        segments, counts,
    )
    _, state, _, _, incoming, _, _, segments, counts = lax.while_loop(
        cond, body, carry
    )
    if with_bounce_counts:
        return state, incoming, segments, counts
    return state, incoming, segments
