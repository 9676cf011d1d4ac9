"""Device-side scene geometry: struct-of-array pytrees.

The reference binds three structured buffers to the shader - ``Spheres``,
``Triangles`` and ``AllMeshInfo`` (RayTracing.shader:110-115) - each an
array-of-structs with a full material embedded per record
(Sphere.cs:3-8, Triangle.cs:5-24, MeshInfo.cs:3-20). Here we instead use
struct-of-arrays so every field is a dense f32/int32 array, and we factor
materials out into one flat table indexed by primitive: gathers stay small
and the intersection hot loop touches only geometry.

All arrays are padded at build time (see ``models/scene.py``) to stable
sizes; padding records are constructed to be un-hittable (radius <= 0 spheres,
degenerate zero triangles whose Moller-Trumbore determinant is 0).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass

# Material flags (RayTracing.shader:57-58 and RayTracingMaterial.cs:6-11).
FLAG_NONE = 0
FLAG_CHECKER = 1
FLAG_INVISIBLE_LIGHT = 2
# Framework extension (documented in SURVEY.md section 5 quirk 6 and
# BASELINE.json configs 2-3): dielectric/refractive material. Not present in
# the reference shader; needed for the Cornell-box-with-glass and RTIOW
# benchmark configs.
FLAG_DIELECTRIC = 3


@pytree_dataclass
class Materials:
    """Flat material table, SoA. One row per unique material slot.

    Mirrors ``RayTracingMaterial`` (RayTracingMaterial.cs:13-19 /
    RayTracing.shader:67-76) plus the dielectric extension's ``ior``.
    Colors are stored as (M, 3) rgb; the reference's alpha channel is unused
    by the shader's lighting math.
    """

    colour: jnp.ndarray  # (M, 3) f32
    emission_colour: jnp.ndarray  # (M, 3) f32
    specular_colour: jnp.ndarray  # (M, 3) f32
    emission_strength: jnp.ndarray  # (M,) f32
    smoothness: jnp.ndarray  # (M,) f32
    specular_probability: jnp.ndarray  # (M,) f32
    flag: jnp.ndarray  # (M,) int32
    ior: jnp.ndarray  # (M,) f32 (dielectric extension; 1.0 elsewhere)

    def take(self, idx):
        """Gather material rows by index (any index shape)."""
        return Materials(
            colour=self.colour[idx],
            emission_colour=self.emission_colour[idx],
            specular_colour=self.specular_colour[idx],
            emission_strength=self.emission_strength[idx],
            smoothness=self.smoothness[idx],
            specular_probability=self.specular_probability[idx],
            flag=self.flag[idx],
            ior=self.ior[idx],
        )

    @property
    def count(self):
        return self.colour.shape[0]


@pytree_dataclass
class Spheres:
    """Sphere buffer (Sphere.cs:3-8): position + radius + material index.

    Padding spheres have ``radius <= 0`` and are rejected in the intersector.
    """

    center: jnp.ndarray  # (S, 3) f32
    radius: jnp.ndarray  # (S,) f32
    mat_idx: jnp.ndarray  # (S,) int32 into the Materials table

    @property
    def count(self):
        return self.center.shape[0]


@pytree_dataclass
class Triangles:
    """Global flat triangle buffer (Triangle.cs:5-24), SoA, with per-triangle
    precomputed Moller-Trumbore terms.

    The reference stores raw vertices and recomputes edges/normal per ray
    (RayTracing.shader:150-174). Here the intersector is formulated as a
    handful of (rays, 3) x (3, tris) contractions (see ``ops/intersect.py``),
    so we precompute the per-triangle constant vectors once at scene build:

      n            = cross(edgeAB, edgeAC)          (geometric normal, unnormalized)
      n_dot_a      = dot(n, posA)
      cross_eac_a  = cross(edgeAC, posA)
      cross_eab_a  = cross(edgeAB, posA)

    Padding triangles are all-zero => n = 0 => determinant 0 => never hit
    (the reference requires det >= 1e-6, RayTracing.shader:169).
    """

    pos_a: jnp.ndarray  # (T, 3) f32
    edge_ab: jnp.ndarray  # (T, 3) f32
    edge_ac: jnp.ndarray  # (T, 3) f32
    normal_a: jnp.ndarray  # (T, 3) f32 per-vertex shading normals
    normal_b: jnp.ndarray  # (T, 3) f32
    normal_c: jnp.ndarray  # (T, 3) f32
    n: jnp.ndarray  # (T, 3) f32
    n_dot_a: jnp.ndarray  # (T,) f32
    cross_eac_a: jnp.ndarray  # (T, 3) f32
    cross_eab_a: jnp.ndarray  # (T, 3) f32
    mat_idx: jnp.ndarray  # (T,) int32 into the Materials table

    @property
    def count(self):
        return self.pos_a.shape[0]


@pytree_dataclass
class MeshChunks:
    """Per-chunk records mirroring ``MeshInfo`` (MeshInfo.cs:3-20): a slice of
    the global triangle buffer plus a world AABB - the data-model parity
    artifact for the reference's per-chunk records.

    The runtime does not consume these variable-size chunks: the
    brute-force path scans every triangle (semantically equivalent to the
    reference's chunk AABB gate, RayTracing.shader:279-281 - the slab test
    is conservative), and large meshes get an LBVH (accel/bvh.py)."""

    first_tri: jnp.ndarray  # (C,) int32
    num_tris: jnp.ndarray  # (C,) int32
    bounds_min: jnp.ndarray  # (C, 3) f32
    bounds_max: jnp.ndarray  # (C, 3) f32
    mat_idx: jnp.ndarray  # (C,) int32

    @property
    def count(self):
        return self.first_tri.shape[0]


@pytree_dataclass
class Environment:
    """Sky/ground/sun settings (EnvironmentSettings.cs:3-12 and the uniforms
    at RayTracing.shader:49-54). ``sun_dir`` is the unit vector pointing
    toward the sun (the shader reads it from ``_WorldSpaceLightPos0``,
    RayTracing.shader:247)."""

    enabled: jnp.ndarray  # () f32 (0.0 / 1.0)
    ground_colour: jnp.ndarray  # (3,) f32
    sky_colour_horizon: jnp.ndarray  # (3,) f32
    sky_colour_zenith: jnp.ndarray  # (3,) f32
    sun_focus: jnp.ndarray  # () f32
    sun_intensity: jnp.ndarray  # () f32
    sun_dir: jnp.ndarray  # (3,) f32

    @staticmethod
    def disabled():
        # host numpy leaves: the scene builder fingerprints the host env
        # (a jnp scalar here would cost a device sync per float() read)
        # and uploads once at build()
        import numpy as _np

        z3 = _np.zeros(3, _np.float32)
        return Environment(
            enabled=_np.float32(0.0),
            ground_colour=z3,
            sky_colour_horizon=z3,
            sky_colour_zenith=z3,
            sun_focus=_np.float32(1.0),
            sun_intensity=_np.float32(0.0),
            sun_dir=_np.array([0.0, 1.0, 0.0], _np.float32),
        )


@pytree_dataclass
class BVH:
    """Flat LBVH over primitives (net-new vs the reference, which only has a
    flat chunk list - SURVEY.md section 2.2 MeshSplitter). Built host-side in
    ``accel/bvh.py`` (Morton-code sort + top-down radix splits); traversed on
    device with a fixed-size per-ray stack.

    Fixed-width leaves: every leaf owns exactly ``leaf_width``
    slots in ``leaf_prims``; unused slots hold a sentinel primitive index that
    points into the scene's padded (never-hit) primitive region, so the
    traversal kernel gathers and tests a constant-shape block per leaf with no
    per-lane count masking. Root is node 0.
    """

    bounds_min: jnp.ndarray  # (N, 3) f32 node AABB
    bounds_max: jnp.ndarray  # (N, 3) f32
    left: jnp.ndarray  # (N,) int32 child index (undefined for leaves)
    right: jnp.ndarray  # (N,) int32
    leaf_row: jnp.ndarray  # (N,) int32 row into leaf_prims, -1 for internal
    leaf_prims: jnp.ndarray  # (L, leaf_width) int32 primitive indices


@pytree_dataclass
class Scene:
    """Complete device-side scene: the analog of the reference's bound
    buffers + uniforms (RayTracingManager.cs:111-124,159-163,184-186)."""

    spheres: Spheres
    triangles: Triangles
    chunks: MeshChunks
    materials: Materials
    env: Environment
    # Optional acceleration structures (None => brute force / chunk scan).
    tri_bvh: BVH | None = None
    sphere_bvh: BVH | None = None
