"""Material response: checker/invisible-light flags, diffuse/specular
scatter, Russian roulette support math, and the dielectric extension.

Reference semantics (Trace, RayTracing.shader:309-342):

  * CheckerPattern (flag 1): swap colour -> emissionColour on odd parity of
    ``mod2(floor(hitPoint.xz), 2)`` (RayTracing.shader:313-317).
  * InvisibleLightSource (flag 2): camera rays (bounce 0) pass through,
    advancing the origin by ``dir * 0.001`` and consuming NO randoms
    (RayTracing.shader:318-322).
  * Scatter: ``isSpecular = specularProbability >= U``; diffuse direction is
    cosine-weighted ``normalize(normal + randomUnitVector)``; specular is the
    mirror reflection; the final direction lerps between them by
    ``smoothness * isSpecular`` (RayTracing.shader:325-330).
  * Throughput: ``+= emissionColour * emissionStrength * rayColour`` then
    ``*= lerp(colour, specularColour, isSpecular)`` (RayTracing.shader:333-335).

Dielectric extension (flag 3 - NOT in the reference shader; required by the
BASELINE.json Cornell-box/RTIOW configs; see SURVEY.md section 5 quirk 6):
classic RTIOW glass. Reuses the specular-lottery draw as the Fresnel
(Schlick) reflect-vs-refract choice so every scattering lane consumes the
same number of randoms per bounce (keeps the per-pixel PCG streams in
lockstep under the masked bounce loop). Because refracted rays continue *into*
the surface, the origin is nudged by ``dir * 1e-4`` (the same trick the
reference uses for invisible lights at RayTracing.shader:320) to avoid the
t=0 self-hit that its epsilon-free sphere test would otherwise produce.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.geometry import (
    FLAG_CHECKER,
    FLAG_DIELECTRIC,
    FLAG_INVISIBLE_LIGHT,
    Materials,
)
from . import rng as rng_ops
from . import vecmath as vm

DIELECTRIC_EPS = jnp.float32(1e-4)


def checker_colour(mat: Materials, point):
    """Apply the checker flag: returns the effective base colour (B, 3).

    ``c = mod2(floor(p.xz), 2); colour = (c.x == c.y) ? colour :
    emissionColour`` (RayTracing.shader:313-317, mod2 at :232-235).
    """
    fx = jnp.floor(point[..., 0])
    fz = jnp.floor(point[..., 2])
    cx = fx - 2.0 * jnp.floor(fx / 2.0)
    cz = fz - 2.0 * jnp.floor(fz / 2.0)
    swap = (mat.flag == FLAG_CHECKER) & (cx != cz)
    return jnp.where(swap[..., None], mat.emission_colour, mat.colour)


def _refract_dir(d, normal, ior, u_fresnel):
    """RTIOW dielectric direction for unit incident ``d`` against shading
    ``normal`` (oriented outward from the surface)."""
    entering = vm.dot(d, normal) < 0.0
    n_eff = jnp.where(entering[..., None], normal, -normal)
    eta = jnp.where(entering, 1.0 / ior, ior)
    cos_t = jnp.minimum(-vm.dot(d, n_eff), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot_refract = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * jnp.power(1.0 - cos_t, jnp.float32(5.0))
    do_reflect = cannot_refract | (schlick > u_fresnel)

    r_perp = eta[..., None] * (d + cos_t[..., None] * n_eff)
    k = jnp.maximum(1.0 - vm.dot(r_perp, r_perp), 0.0)
    refracted = r_perp - jnp.sqrt(k)[..., None] * n_eff
    reflected = vm.reflect(d, n_eff)
    return jnp.where(do_reflect[..., None], reflected, refracted)


def scatter(state, d, point, normal, mat: Materials):
    """Sample the outgoing ray for scattering lanes.

    Consumes exactly 7 draws per lane (1 specular lottery + 6 for the unit
    vector), matching the reference's order (RayTracing.shader:325-330).
    Returns ``(state, new_origin, new_dir, is_specular)`` where
    ``is_specular`` is the f32 lottery outcome used in the throughput lerp.
    """
    state, u_spec = rng_ops.random_value(state)
    is_specular = (mat.specular_probability >= u_spec).astype(jnp.float32)

    state, unit = rng_ops.random_direction(state)
    diffuse_dir = vm.normalize(normal + unit)
    specular_dir = vm.reflect(d, normal)
    surface_dir = vm.normalize(
        vm.lerp(
            diffuse_dir,
            specular_dir,
            (mat.smoothness * is_specular)[..., None],
        )
    )

    is_dielectric = mat.flag == FLAG_DIELECTRIC
    glass_dir = _refract_dir(d, normal, mat.ior, u_spec)
    new_dir = jnp.where(is_dielectric[..., None], glass_dir, surface_dir)
    new_origin = point + jnp.where(
        is_dielectric[..., None], new_dir * DIELECTRIC_EPS, 0.0
    )
    # Dielectrics are tinted by colour only (no specular lerp).
    is_specular = jnp.where(is_dielectric, 0.0, is_specular)
    return state, new_origin, new_dir, is_specular


def passthrough_mask(mat: Materials, bounce_idx, did_hit):
    """Invisible-light camera-ray passthrough lanes
    (RayTracing.shader:318-322)."""
    return did_hit & (mat.flag == FLAG_INVISIBLE_LIGHT) & (bounce_idx == 0)
