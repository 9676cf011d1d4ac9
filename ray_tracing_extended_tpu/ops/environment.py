"""Procedural sky / ground / sun environment light.

Reproduces GetEnvironmentLight (RayTracing.shader:238-251) exactly:

  skyGradientT = pow(smoothstep(0, 0.4, dir.y), 0.35)
  groundToSkyT = smoothstep(-0.01, 0, dir.y)
  skyGradient  = lerp(horizon, zenith, skyGradientT)
  sun          = pow(max(0, dot(dir, sunDir)), sunFocus) * sunIntensity
  out          = lerp(ground, skyGradient, groundToSkyT) + sun * (groundToSkyT >= 1)

including the quirk that the sun term only lights directions with
``dir.y >= 0`` (the ``groundToSkyT >= 1`` gate, SURVEY.md section 5 quirk 4).
Pure element-wise math; XLA fuses it into the trace loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.geometry import Environment
from . import vecmath as vm


def environment_light(d, env: Environment):
    """Environment radiance for ray directions ``d`` (B, 3) -> (B, 3)."""
    dy = d[..., 1]
    sky_t = jnp.power(vm.smoothstep(0.0, 0.4, dy), jnp.float32(0.35))
    ground_t = vm.smoothstep(-0.01, 0.0, dy)
    sky = vm.lerp(
        env.sky_colour_horizon[None, :],
        env.sky_colour_zenith[None, :],
        sky_t[..., None],
    )
    sun = (
        jnp.power(
            jnp.maximum(vm.dot(d, env.sun_dir[None, :]), 0.0), env.sun_focus
        )
        * env.sun_intensity
    )
    composite = vm.lerp(env.ground_colour[None, :], sky, ground_t[..., None])
    composite = composite + (sun * (ground_t >= 1.0))[..., None]
    return composite * env.enabled
