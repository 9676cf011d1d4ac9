"""Ray-primitive intersection as dense (rays x primitives) contractions.

The reference's intersector is a per-thread linear scan over all spheres and
all chunk triangles (CalculateRayCollision, RayTracing.shader:256-297) with
scalar quadratic / Moller-Trumbore tests (RayTracing.shader:120-174). Here
the formulation is dense (rays x primitives) batches where the
dot-product-heavy part of every test is a K=3 contraction (``dot_general``)
followed by a short element-wise tail that XLA fuses:

* ray-sphere: with ``oc = o - c`` and unit ``d``,
  ``dot(oc, d) = dot(o, d) - o @ C^T-row`` and
  ``dot(oc, oc) = |o|^2 - 2 * (o @ C^T) + |c|^2`` - two (B,3)x(3,S) matmuls.

* ray-triangle (Moller-Trumbore, backface-culled): every quantity the test
  needs is LINEAR in the per-ray feature vector ``[o, d, cross(o, d)]``:

    det      = -dot(d, n)
    t * det  =  dot(o, n) - dot(A, n)
    u * det  =  dot(cross(o,d), eAC) - dot(d, cross(eAC, A))
    v * det  = -dot(cross(o,d), eAB) + dot(d, cross(eAB, A))

  (identities from the scalar triple product; per-triangle constant vectors
  are precomputed at scene build, see models/geometry.py). Because the
  reference requires ``det >= 1e-6`` (RayTracing.shader:169), all sign tests
  (t, u, v, w >= 0) can be done on the *products* without dividing; a single
  division recovers t for the closest-hit reduction.

Numerical parity note: the decomposed dot products round differently from the
reference's scalar forms at the ULP level; renders agree within Monte-Carlo
statistics (the parity tests in tests/ compare distributions, and the unit
tests here compare against closed-form oracles with tolerances).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..models.geometry import Scene, Spheres, Triangles
from ..utils.pytree import pytree_dataclass
from . import vecmath as vm

# f32 +inf stands in for the shader's 1.#INF miss distance
# (RayTracing.shader:260).
INF = jnp.float32(jnp.inf)

# Backface-cull / degeneracy threshold (RayTracing.shader:169).
DET_EPS = jnp.float32(1e-6)

# Contraction precision for every float32 product in the renderer. HIGHEST
# keeps full f32: on a GPU the default precision may round the operands to
# TF32 (10 mantissa bits, ~3 decimal digits), which would move hit distances
# and camera rays at the fourth digit.
MATMUL_PRECISION = lax.Precision.HIGHEST


def _dots(a, b_t):
    """(B, 3) x (T, 3) -> (B, T) row-pair dot products."""
    return lax.dot_general(
        a,
        b_t,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=MATMUL_PRECISION,
        preferred_element_type=jnp.float32,
    )


@pytree_dataclass
class HitRecord:
    """Closest-hit result for a batch of rays (HitInfo,
    RayTracing.shader:100-107, with the embedded material replaced by an
    index into the scene material table)."""

    hit: jnp.ndarray  # (B,) bool
    t: jnp.ndarray  # (B,) f32 (+inf on miss)
    point: jnp.ndarray  # (B, 3) f32
    normal: jnp.ndarray  # (B, 3) f32
    mat_idx: jnp.ndarray  # (B,) int32 (0 on miss; gated by ``hit``)


def ray_spheres_t(o, d, spheres: Spheres):
    """Hit distances for all (ray, sphere) pairs. Returns (B, S) f32, +inf on
    miss.

    Semantics of RaySphere (RayTracing.shader:120-146): nearest quadratic
    root only, accepted iff the discriminant is >= 0 and t >= 0 (no epsilon,
    no inside-hit second root). Padding spheres (radius <= 0) never hit.
    """
    c = spheres.center  # (S, 3)
    r = spheres.radius  # (S,)
    # b = dot(oc, d) = dot(o, d) - dot(c, d)   [half the shader's b]
    b = vm.dot(o, d)[:, None] - _dots(d, c)  # (B, S)
    # cc = dot(oc, oc) - r^2 = |o|^2 - 2 dot(o, c) + |c|^2 - r^2
    cc = (
        vm.dot(o, o)[:, None]
        - 2.0 * _dots(o, c)
        + (vm.dot(c, c) - r * r)[None, :]
    )
    disc = b * b - cc
    t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    valid = (disc >= 0.0) & (t >= 0.0) & (r > 0.0)[None, :]
    return jnp.where(valid, t, INF)


def ray_triangles_t(o, d, tris: Triangles):
    """Hit distances for all (ray, triangle) pairs. Returns (B, T) f32, +inf
    on miss.

    Semantics of RayTriangle (RayTracing.shader:150-174): backface-culled
    Moller-Trumbore; hit iff det >= 1e-6, t >= 0 and barycentric
    u, v, w >= 0.
    """
    co = vm.cross(o, d)  # (B, 3)
    det = -_dots(d, tris.n)  # (B, T)
    t_det = _dots(o, tris.n) - tris.n_dot_a[None, :]
    u_det = _dots(co, tris.edge_ac) - _dots(d, tris.cross_eac_a)
    v_det = -_dots(co, tris.edge_ab) + _dots(d, tris.cross_eab_a)
    w_det = det - u_det - v_det
    hit = (
        (det >= DET_EPS)
        & (t_det >= 0.0)
        & (u_det >= 0.0)
        & (v_det >= 0.0)
        & (w_det >= 0.0)
    )
    # det >= 1e-6 wherever hit, so the division is safe on selected lanes.
    t = t_det / jnp.where(det >= DET_EPS, det, jnp.float32(1.0))
    return jnp.where(hit, t, INF)


def ray_aabb(o, d, bounds_min, bounds_max):
    """Branchless slab test for all (ray, box) pairs -> (B, C) bool.

    Matches RayBoundingBox (RayTracing.shader:177-187): passes iff
    tNear <= tFar, with NO tFar >= 0 requirement (boxes fully behind the ray
    pass - conservative, reproduced for parity). Division by zero direction
    components yields +/-inf which min/max handle like HLSL.
    """
    inv_d = 1.0 / d  # (B, 3)
    t0 = (bounds_min[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bounds_max[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return t_near <= t_far


def _triangle_normal_at(o, d, tris: Triangles, idx):
    """Interpolated shading normal for one gathered triangle per ray
    (RayTracing.shader:161-171), recomputed post-selection so the pairwise
    pass never materializes barycentrics."""
    pa = tris.pos_a[idx]
    e_ab = tris.edge_ab[idx]
    e_ac = tris.edge_ac[idx]
    n = tris.n[idx]
    ao = o - pa
    dao = vm.cross(ao, d)
    det = -vm.dot(d, n)
    inv_det = 1.0 / jnp.where(det == 0.0, jnp.float32(1.0), det)
    u = vm.dot(e_ac, dao) * inv_det
    v = -vm.dot(e_ab, dao) * inv_det
    w = 1.0 - u - v
    raw = (
        tris.normal_a[idx] * w[:, None]
        + tris.normal_b[idx] * u[:, None]
        + tris.normal_c[idx] * v[:, None]
    )
    return vm.normalize(raw)


def closest_hit_bruteforce(o, d, scene: Scene) -> HitRecord:
    """Closest hit over every sphere and every triangle, mirroring the
    reference's exhaustive scan (CalculateRayCollision,
    RayTracing.shader:256-297). Tie-break: strictly-closer wins, first
    primitive in (spheres, then triangles) order on exact ties - matching the
    shader's ``dst < closestHit.dst`` scan order via argmin's
    first-occurrence rule.

    o, d: (B, 3) f32 with unit d. Returns a HitRecord batch.
    """
    s = scene.spheres.count
    t_sph = ray_spheres_t(o, d, scene.spheres)  # (B, S)
    t_tri = ray_triangles_t(o, d, scene.triangles)  # (B, T)
    t_all = jnp.concatenate([t_sph, t_tri], axis=1)
    best = jnp.argmin(t_all, axis=1).astype(jnp.int32)  # first min
    t = jnp.min(t_all, axis=1)
    hit = jnp.isfinite(t)

    point = o + d * jnp.where(hit, t, 0.0)[:, None]

    is_sphere = best < s
    sph_idx = jnp.minimum(best, s - 1)
    tri_idx = jnp.clip(best - s, 0, scene.triangles.count - 1)

    # Sphere outward normal (RayTracing.shader:142).
    n_sph = vm.normalize(point - scene.spheres.center[sph_idx])
    n_tri = _triangle_normal_at(o, d, scene.triangles, tri_idx)
    normal = jnp.where(is_sphere[:, None], n_sph, n_tri)

    mat_idx = jnp.where(
        is_sphere,
        scene.spheres.mat_idx[sph_idx],
        scene.triangles.mat_idx[tri_idx],
    )
    mat_idx = jnp.where(hit, mat_idx, 0)
    return HitRecord(hit=hit, t=t, point=point, normal=normal, mat_idx=mat_idx)
