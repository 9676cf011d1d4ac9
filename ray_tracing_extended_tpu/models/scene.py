"""Host-side scene construction: the analog of the reference's scene scan +
buffer upload (RayTracingManager.CreateSpheres/CreateMeshes,
RayTracingManager.cs:135-187).

``SceneBuilder`` collects spheres and triangle meshes (chunked with the
octree splitter, like RayTracedMesh.GetSubMeshes -> MeshSplitter), then
``build()`` flattens everything into lane-padded SoA device arrays:

  * spheres padded to a multiple of 128 with radius -1 (never hit);
  * the global triangle buffer (one flat list across all chunks, mirroring
    RayTracingManager.cs:150-151) padded to a multiple of 128 with degenerate
    zero triangles (Moller-Trumbore det = 0 => never hit);
  * one flat material table (sphere materials first, then per-chunk
    materials, in insertion order - preserving the reference's
    spheres-then-meshes closest-hit tie-break order).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import jax.numpy as jnp

from ..accel.chunks import MAX_TRIS_PER_CHUNK, create_chunks
from .geometry import (
    FLAG_NONE,
    BVH,
    Environment,
    Materials,
    MeshChunks,
    Scene,
    Spheres,
    Triangles,
)

# Per-mesh triangle budget of the reference (RayTracingManager.cs:9). We keep
# the constant for parity checks but do NOT enforce it: the BVH path is built
# for far larger meshes (BASELINE.json config 4).
REFERENCE_TRIANGLE_LIMIT = 1500

# Primitive counts are padded to a multiple of this, so an animated scene
# keeps stable array shapes (and one compiled program) across rebuilds
# that add or drop a few primitives.
_PAD = 128


@dataclasses.dataclass
class Material:
    """Host material with the reference's defaults
    (RayTracingMaterial.SetDefaultValues, RayTracingMaterial.cs:21-28).
    Note the parity trap: default specularProbability is 1, so throughput
    multiplies specularColour for default materials (SURVEY.md section 5
    quirk 5)."""

    colour: tuple = (1.0, 1.0, 1.0)
    emission_colour: tuple = (1.0, 1.0, 1.0)
    specular_colour: tuple = (1.0, 1.0, 1.0)
    emission_strength: float = 0.0
    smoothness: float = 0.0
    specular_probability: float = 1.0
    flag: int = FLAG_NONE
    ior: float = 1.0  # dielectric extension (flag 3)

    @staticmethod
    def lambertian(colour, smoothness: float = 0.0):
        """Convenience: plain diffuse (specular lottery never fires)."""
        return Material(
            colour=tuple(colour), specular_probability=0.0, smoothness=smoothness
        )

    @staticmethod
    def metal(colour, smoothness: float = 1.0, specular_colour=None):
        return Material(
            colour=tuple(colour),
            specular_colour=tuple(specular_colour or colour),
            specular_probability=1.0,
            smoothness=smoothness,
        )

    @staticmethod
    def emissive(colour, strength: float):
        return Material(
            colour=(0.0, 0.0, 0.0),
            emission_colour=tuple(colour),
            emission_strength=strength,
            specular_probability=0.0,
        )

    @staticmethod
    def dielectric(ior: float = 1.5, colour=(1.0, 1.0, 1.0)):
        from .geometry import FLAG_DIELECTRIC

        return Material(colour=tuple(colour), flag=FLAG_DIELECTRIC, ior=ior)


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


class SceneBuilder:
    """Mutable host scene. ``build()`` is the reference's per-frame scene
    re-scan + buffer re-upload (RayTracingManager.InitFrame ->
    CreateSpheres/CreateMeshes, RayTracingManager.cs:95-109): it may be
    called once for a static scene or once per frame for animation -
    ``set_sphere`` / ``set_mesh_transform`` between builds move objects,
    exactly like mutating a Unity Transform between frames
    (RayTracedMesh.cs:42-51 re-transforms every triangle to world space
    each frame)."""

    def __init__(self, env: Environment | None = None):
        self._sphere_center: list = []
        self._sphere_radius: list = []
        self._sphere_mat: list[Material] = []
        # Ordered triangle-chunk sources, preserving insertion order (the
        # material table and the spheres-then-chunks closest-hit tie-break
        # depend on it):  ("raw", tri_pos, tri_normal, bmin, bmax, Material)
        # for pre-chunked soups, ("mesh", i) for self._meshes[i].
        self._sources: list = []
        # Mesh records keep LOCAL-space geometry so the world transform can
        # be changed between builds; _cache memoizes the world-space chunks
        # per transform so a static mesh costs nothing on rebuild.
        self._meshes: list[dict] = []
        self.env = env if env is not None else Environment.disabled()

    def add_sphere(self, center, radius: float, material: Material):
        """One sphere record (Sphere.cs:3-8 / RayTracingManager.cs:167-187)."""
        self._sphere_center.append(np.asarray(center, np.float32))
        self._sphere_radius.append(np.float32(radius))
        self._sphere_mat.append(material)
        return self

    def set_sphere(self, index: int, center=None, radius=None, material=None):
        """Move/resize/re-skin sphere ``index`` (in ``add_sphere`` order)
        before the next ``build()`` - the analog of mutating a Unity
        sphere's Transform between frames (the reference re-reads
        ``s.transform.position`` every frame, RayTracingManager.cs:178)."""
        if not 0 <= index < len(self._sphere_center):
            raise IndexError(
                f"sphere index {index} out of range "
                f"[0, {len(self._sphere_center)})"
            )
        if center is not None:
            self._sphere_center[index] = np.asarray(center, np.float32)
        if radius is not None:
            self._sphere_radius[index] = np.float32(radius)
        if material is not None:
            self._sphere_mat[index] = material
        return self

    def add_mesh(
        self,
        vertices: np.ndarray,
        indices: np.ndarray,
        material: Material,
        normals: np.ndarray | None = None,
        transform: np.ndarray | None = None,
        max_tris_per_chunk: int = MAX_TRIS_PER_CHUNK,
        chunked: bool = True,
    ):
        """Add a triangle mesh, world-transformed and octree-chunked.

        vertices: (V, 3); indices: (F, 3) int; normals: (V, 3) or None
        (face normals are derived, giving flat shading); transform: optional
        (4, 4) local-to-world.
        """
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        if normals is None:
            normals = _vertex_normals(vertices, indices)
        normals = np.asarray(normals, np.float32)
        self._meshes.append(
            {
                "vertices": vertices,
                "indices": indices,
                "normals": normals,
                "material": material,
                "transform": None
                if transform is None
                else np.asarray(transform, np.float32),
                "max_tris": max_tris_per_chunk,
                "chunked": chunked,
                "local_chunks": None,  # [(tri_pos, tri_normal)] local space
                "cache": None,  # (transform_bytes, [chunk tuples])
            }
        )
        self._sources.append(("mesh", len(self._meshes) - 1))
        return self

    def set_mesh_transform(self, index: int, transform):
        """Re-pose mesh ``index`` (in ``add_mesh`` order) before the next
        ``build()``: the analog of moving a RayTracedMesh's Transform -
        the reference re-runs the local->world transform over every
        triangle each frame (RayTracedMesh.cs:42-51)."""
        if not 0 <= index < len(self._meshes):
            raise IndexError(
                f"mesh index {index} out of range [0, {len(self._meshes)})"
            )
        self._meshes[index]["transform"] = (
            None if transform is None else np.asarray(transform, np.float32)
        )
        return self

    def _mesh_chunks(self, rec: dict) -> list:
        """World-space chunk tuples for one mesh record.

        The octree split runs ONCE in LOCAL space (cached on the record)
        and each build only re-transforms the cached chunks' triangles and
        recomputes tight world AABBs from the transformed vertices - the
        reference's exact scheme (MeshSplitter splits the local mesh once,
        RayTracedMesh.cs:24-29 caches localChunks; GetSubMeshes re-runs
        UpdateWorldChunkFromLocal per frame, whose bounds are the tight
        min/max over the transformed vertices, RayTracedMesh.cs:60-84 -
        the octant-grown bounds exist only on the LOCAL chunks). Chunk
        count and triangle membership are therefore pose-invariant:
        animating via set_mesh_transform keeps the scene's pytree
        shapes stable across builds (required by
        render_progressive(scenes=...)), where chunking the world-space
        triangles per pose redistributed triangles across octants on any
        rotation/scale. World chunks stay memoized per transform (a
        static mesh costs nothing on animated rebuilds)."""
        transform = rec["transform"]
        key = b"id" if transform is None else transform.tobytes()
        if rec["cache"] is not None and rec["cache"][0] == key:
            return rec["cache"][1]
        if rec["local_chunks"] is None:
            indices = rec["indices"]
            tri_pos_l = rec["vertices"][indices]  # (F, 3, 3)
            tri_nrm_l = rec["normals"][indices]
            if rec["chunked"]:
                rec["local_chunks"] = [
                    (ch.tri_pos, ch.tri_normal)
                    for ch in create_chunks(
                        tri_pos_l, tri_nrm_l, max_tris=rec["max_tris"]
                    )
                ]
            else:
                rec["local_chunks"] = [(tri_pos_l, tri_nrm_l)]
        material = rec["material"]
        if transform is not None:
            r = transform[:3, :3]
            t = transform[:3, 3]
            # Normal matrix = inverse-transpose of the linear part
            # (the reference transforms normals by TransformDirection which
            # assumes uniform scale; we handle general affine).
            n_mat = np.linalg.inv(r).T
        out = []
        for tri_pos, tri_normal in rec["local_chunks"]:
            if transform is not None:
                tri_pos = tri_pos @ r.T + t
                tri_normal = tri_normal @ n_mat.T
                tri_normal = tri_normal / np.maximum(
                    np.linalg.norm(tri_normal, axis=2, keepdims=True),
                    1e-20,
                )
                tri_pos = np.ascontiguousarray(tri_pos, np.float32)
                tri_normal = np.ascontiguousarray(tri_normal, np.float32)
            # Tight world bounds from the (transformed) vertices,
            # matching UpdateWorldChunkFromLocal (RayTracedMesh.cs:60-84).
            flat = tri_pos.reshape(-1, 3)
            out.append(
                (tri_pos, tri_normal, flat.min(axis=0), flat.max(axis=0),
                 material)
            )
        rec["cache"] = (key, out)
        return out

    def add_triangles(
        self, tri_pos: np.ndarray, tri_normal: np.ndarray, material: Material
    ):
        """Add a raw pre-chunked triangle soup as a single chunk."""
        tri_pos = np.asarray(tri_pos, np.float32)
        tri_normal = np.asarray(tri_normal, np.float32)
        bmin = tri_pos.reshape(-1, 3).min(axis=0)
        bmax = tri_pos.reshape(-1, 3).max(axis=0)
        self._sources.append(("raw", tri_pos, tri_normal, bmin, bmax, material))
        return self

    def _iter_chunks(self):
        """All chunk tuples in insertion order (raw soups + mesh expansions)."""
        for src in self._sources:
            if src[0] == "raw":
                yield src[1:]
            else:
                yield from self._mesh_chunks(self._meshes[src[1]])

    @property
    def num_spheres(self) -> int:
        return len(self._sphere_center)

    @property
    def num_meshes(self) -> int:
        return len(self._meshes)

    @property
    def num_triangles(self) -> int:
        total = 0
        for src in self._sources:
            if src[0] == "raw":
                total += src[1].shape[0]
            else:
                total += self._meshes[src[1]]["indices"].shape[0]
        return total

    def build(self, build_bvh: str | None = None) -> Scene:
        """Flatten to device arrays.

        build_bvh: None, "tri", "sphere", or "both" - attach LBVHs for the
        large-scene traversal path (accel/bvh.py).
        """
        s = len(self._sphere_center)
        # +1 guarantees at least one padding slot: BVH leaf sentinels point at
        # the first padding primitive (never-hit by construction).
        s_pad = _round_up(s + 1, _PAD)
        centers = np.zeros((s_pad, 3), np.float32)
        # Padding spheres sit at the origin with radius -1: the intersector
        # rejects radius <= 0, and keeping coordinates small avoids f32
        # overflow (and NaNs) in the pairwise quadratic terms.
        radii = np.full((s_pad,), -1.0, np.float32)
        if s:
            centers[:s] = np.stack(self._sphere_center)
            radii[:s] = np.array(self._sphere_radius, np.float32)

        mats: list[Material] = list(self._sphere_mat)
        sphere_mat_idx = np.arange(s, dtype=np.int32)

        chunk_first = []
        chunk_count = []
        chunk_bmin = []
        chunk_bmax = []
        chunk_mat_idx = []
        tri_pos_all = []
        tri_nrm_all = []
        tri_mat_idx = []
        cursor = 0
        for tri_pos, tri_nrm, bmin, bmax, mat in self._iter_chunks():
            mats.append(mat)
            midx = len(mats) - 1
            n = tri_pos.shape[0]
            chunk_first.append(cursor)
            chunk_count.append(n)
            chunk_bmin.append(bmin)
            chunk_bmax.append(bmax)
            chunk_mat_idx.append(midx)
            tri_pos_all.append(tri_pos)
            tri_nrm_all.append(tri_nrm)
            tri_mat_idx.append(np.full((n,), midx, np.int32))
            cursor += n

        t = cursor
        t_pad = _round_up(t + 1, _PAD)
        pos = np.zeros((t_pad, 3, 3), np.float32)
        nrm = np.zeros((t_pad, 3, 3), np.float32)
        tmat = np.zeros((t_pad,), np.int32)
        if t:
            pos[:t] = np.concatenate(tri_pos_all)
            nrm[:t] = np.concatenate(tri_nrm_all)
            tmat[:t] = np.concatenate(tri_mat_idx)

        c = len(chunk_first)
        c_pad = max(1, c)
        chunks = MeshChunks(
            first_tri=np.array(chunk_first + [0] * (c_pad - c), np.int32),
            num_tris=np.array(chunk_count + [0] * (c_pad - c), np.int32),
            bounds_min=np.array(
                chunk_bmin + [[1e30] * 3] * (c_pad - c), np.float32
            ),
            bounds_max=np.array(
                chunk_bmax + [[1e30] * 3] * (c_pad - c), np.float32
            ),
            mat_idx=np.array(chunk_mat_idx + [0] * (c_pad - c), np.int32),
        )

        if not mats:
            mats = [Material()]
            sphere_mat_idx = np.zeros((0,), np.int32)

        materials = _materials_soa(mats)
        smat = np.zeros((s_pad,), np.int32)
        if s:
            smat[:s] = sphere_mat_idx

        # Build-time OOB guard (SURVEY section 5 sanitizer row): every
        # material index the device-side gathers (ops/trace.py
        # materials.take, accel/bvh.py mat_idx reads) will ever load must
        # be a real material row, and every chunk's triangle range must
        # lie inside the flat triangle buffer. The device code relies on
        # clamp conventions only, so a builder bug here would silently
        # shade with the wrong material - fail loudly at build instead.
        n_mats = len(mats)
        assert smat.min() >= 0 and smat.max() < n_mats, (
            f"sphere mat_idx out of range [0, {n_mats})"
        )
        assert tmat.min() >= 0 and tmat.max() < n_mats, (
            f"triangle mat_idx out of range [0, {n_mats})"
        )
        assert all(0 <= m < n_mats for m in chunk_mat_idx), (
            f"chunk mat_idx out of range [0, {n_mats})"
        )
        assert all(
            0 <= f and f + n <= t_pad
            for f, n in zip(chunk_first, chunk_count)
        ), "chunk triangle range exceeds the flat triangle buffer"

        spheres = Spheres(center=centers, radius=radii, mat_idx=smat)
        triangles = _triangles_soa(pos, nrm, tmat)

        tri_bvh = sphere_bvh = None
        if build_bvh in ("tri", "both") and t:
            from ..accel.bvh import build_lbvh

            tri_bvh = build_lbvh(
                pos[:t].min(axis=1), pos[:t].max(axis=1), sentinel=t
            )
        if build_bvh in ("sphere", "both") and s:
            from ..accel.bvh import build_lbvh

            sphere_bvh = build_lbvh(
                centers[:s] - radii[:s, None],
                centers[:s] + radii[:s, None],
                sentinel=s,
            )

        # Fingerprint the HOST-side (numpy) scene, THEN upload once.
        host = Scene(
            spheres=spheres,
            triangles=triangles,
            chunks=chunks,
            materials=materials,
            env=self.env,
            tri_bvh=None,
            sphere_bvh=None,
        )
        import jax as _jax

        scene = _jax.tree_util.tree_map(jnp.asarray, host)
        scene = dataclasses.replace(
            scene, tri_bvh=tri_bvh, sphere_bvh=sphere_bvh
        )
        # Exact content fingerprint from the HOST arrays (free), attached
        # as a plain attribute - deliberately NOT a pytree aux (that would
        # key the jit cache on scene content and recompile per scene).
        # Consumed by utils/checkpoint.state_hash; jax tree ops drop the
        # attribute, in which case state_hash recomputes the IDENTICAL
        # hash from the device leaves (slower, same digest).
        from ..utils.checkpoint import hash_tree

        object.__setattr__(scene, "content_hash", hash_tree(host))
        return scene


def _vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for meshes that ship without them."""
    v0, v1, v2 = (vertices[indices[:, i]] for i in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(out, indices[:, i], face_n)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def _materials_soa(mats: Sequence[Material]) -> Materials:
    def arr(get, d=1):
        # host numpy: build() fingerprints these before the device upload
        return np.array([get(m) for m in mats], np.float32)

    return Materials(
        colour=arr(lambda m: m.colour[:3]),
        emission_colour=arr(lambda m: m.emission_colour[:3]),
        specular_colour=arr(lambda m: m.specular_colour[:3]),
        emission_strength=arr(lambda m: m.emission_strength),
        smoothness=arr(lambda m: m.smoothness),
        specular_probability=arr(lambda m: m.specular_probability),
        flag=np.array([m.flag for m in mats], np.int32),
        ior=arr(lambda m: m.ior),
    )


def _triangles_soa(pos: np.ndarray, nrm: np.ndarray, mat_idx: np.ndarray) -> Triangles:
    """Precompute the per-triangle Moller-Trumbore constants
    (see models/geometry.py Triangles docstring)."""
    a, b, c = pos[:, 0], pos[:, 1], pos[:, 2]
    e_ab = b - a
    e_ac = c - a
    n = np.cross(e_ab, e_ac)
    # host numpy leaves: build() fingerprints these before the one device
    # upload (jitted consumers convert numpy on call anyway)
    return Triangles(
        pos_a=a,
        edge_ab=e_ab,
        edge_ac=e_ac,
        normal_a=nrm[:, 0].copy(),
        normal_b=nrm[:, 1].copy(),
        normal_c=nrm[:, 2].copy(),
        n=n,
        n_dot_a=np.sum(n * a, axis=1),
        cross_eac_a=np.cross(e_ac, a),
        cross_eab_a=np.cross(e_ab, a),
        mat_idx=np.asarray(mat_idx),
    )
