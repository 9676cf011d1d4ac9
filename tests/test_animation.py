"""Per-frame scene mutation (VERDICT round 3 item 5): moving/animated
objects through the public API.

The reference re-scans and re-uploads the whole scene every frame
(RayTracingManager.cs:95-109 InitFrame -> CreateSpheres/CreateMeshes;
RayTracedMesh.cs:42-51 re-transforms every triangle to world space per
frame), so objects may move under accumulation - the running average
keeps folding into stale history (ghosting by design, like a moving
camera). Here: SceneBuilder.set_sphere / set_mesh_transform mutate the
host scene between build() calls, and render_progressive(scenes=[...])
renders one Scene per frame through the single compiled program.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ray_tracing_extended_tpu.models.presets import three_sphere_scene
from ray_tracing_extended_tpu.models.scene import Material, SceneBuilder
from ray_tracing_extended_tpu.models.geometry import Environment
from ray_tracing_extended_tpu.ops.accumulate import accumulate
from ray_tracing_extended_tpu.ops.camera import look_at
from ray_tracing_extended_tpu.progressive import render_progressive
from ray_tracing_extended_tpu.render import render_frame
from ray_tracing_extended_tpu.utils.config import RenderConfig


def _animated_builder():
    b = SceneBuilder(env=Environment.disabled())
    b.add_sphere((0.0, 0.0, 0.0), 0.5, Material.emissive((1.0, 1.0, 1.0), 2.0))
    return b


def _cam():
    return look_at((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), fov_y_deg=45.0)


def _cube(side=1.0):
    s = side / 2.0
    v = np.array(
        [
            [-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        ],
        np.float32,
    )
    f = np.array(
        [
            [0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
            [0, 4, 5], [0, 5, 1], [3, 2, 6], [3, 6, 7],
            [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2],
        ],
        np.int64,
    )
    return v, f


def _translation(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def test_rebuild_is_deterministic_and_tracks_mutation():
    b = _animated_builder()
    s0 = b.build()
    s0_again = b.build()
    assert s0.content_hash == s0_again.content_hash

    b.set_sphere(0, center=(0.5, 0.0, 0.0))
    s1 = b.build()
    assert s1.content_hash != s0.content_hash
    assert np.asarray(s1.spheres.center)[0, 0] == np.float32(0.5)

    # moving back reproduces the original scene bit-for-bit
    b.set_sphere(0, center=(0.0, 0.0, 0.0))
    assert b.build().content_hash == s0.content_hash


def test_set_sphere_validates_index():
    b = _animated_builder()
    with pytest.raises(IndexError):
        b.set_sphere(1, center=(0.0, 0.0, 0.0))
    with pytest.raises(IndexError):
        b.set_mesh_transform(0, np.eye(4, dtype=np.float32))


def test_set_mesh_transform_matches_fresh_build():
    v, f = _cube()
    t1 = _translation((0.3, -0.2, 0.1))
    mat = Material.lambertian((0.7, 0.3, 0.2))

    fresh = SceneBuilder().add_mesh(v, f, mat, transform=t1).build()

    b = SceneBuilder()
    b.add_mesh(v, f, mat, transform=_translation((5.0, 0.0, 0.0)))
    b.build()  # bake once at the old pose (fills the chunk cache)
    b.set_mesh_transform(0, t1)
    moved = b.build()

    assert moved.content_hash == fresh.content_hash
    np.testing.assert_array_equal(
        np.asarray(moved.triangles.pos_a), np.asarray(fresh.triangles.pos_a)
    )
    np.testing.assert_array_equal(
        np.asarray(moved.chunks.bounds_min), np.asarray(fresh.chunks.bounds_min)
    )


def test_mesh_chunk_cache_reuses_static_pose():
    v, f = _cube()
    b = SceneBuilder()
    b.add_mesh(v, f, Material.lambertian((0.5, 0.5, 0.5)))
    s0 = b.build()
    cache0 = b._meshes[0]["cache"]
    s1 = b.build()  # unchanged transform: chunks must come from the cache
    assert b._meshes[0]["cache"] is cache0
    assert s0.content_hash == s1.content_hash


def _grid_mesh(n=8, side=2.0):
    """(n+1)^2-vertex XY grid, 2*n^2 triangles (>48 so the octree splits)."""
    xs = np.linspace(-side / 2, side / 2, n + 1, dtype=np.float32)
    v = np.array(
        [[x, y, 0.0] for y in xs for x in xs], np.float32
    )
    f = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            b = a + 1
            c = a + n + 1
            d = c + 1
            f.append([a, b, d])
            f.append([a, d, c])
    return v, np.array(f, np.int64)


def _rotation_z(deg):
    r = np.deg2rad(deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = np.cos(r)
    m[0, 1] = -np.sin(r)
    m[1, 0] = np.sin(r)
    return m


def test_chunk_topology_is_pose_invariant(tmp_path):
    """Chunking runs once in LOCAL space (MeshSplitter semantics), so a
    rotation/scale between builds must keep chunk count and triangle
    membership - and therefore every scene pytree shape - identical
    (ADVICE round 4: world-space re-chunking redistributed triangles
    across octants per pose, breaking render_progressive(scenes=...)
    for rotating chunked meshes)."""
    import jax

    v, f = _grid_mesh()  # 128 tris: the octree genuinely splits
    mat = Material.lambertian((0.6, 0.6, 0.6))
    b = SceneBuilder(env=Environment.disabled())
    b.add_mesh(v, f, mat)
    scenes = []
    for deg in (0.0, 33.0, 61.0):
        b.set_mesh_transform(0, _rotation_z(deg))
        scenes.append(b.build())
    shapes = [
        [(x.shape, x.dtype) for x in jax.tree_util.tree_leaves(s)]
        for s in scenes
    ]
    assert shapes[1] == shapes[0] and shapes[2] == shapes[0]
    # chunk membership itself is pose-invariant: per-chunk triangle
    # counts are equal across poses (only positions/bounds move)
    np.testing.assert_array_equal(
        np.asarray(scenes[0].chunks.num_tris),
        np.asarray(scenes[1].chunks.num_tris),
    )
    # and the animated-progressive path accepts the sequence end to end
    cam = _cam()
    cfg = RenderConfig(width=32, height=32, max_bounce=1, spp=1)
    out = render_progressive(
        scenes[0], cam, cfg, frames=3, scenes=scenes
    )
    assert out.shape == (32, 32, 3)
    assert not np.isnan(out).any()


def test_world_chunk_bounds_are_tight_vertex_bounds():
    """World chunk AABBs are the tight min/max over the (transformed)
    triangle vertices - UpdateWorldChunkFromLocal semantics
    (RayTracedMesh.cs:60-84); octant-grown bounds exist only on the
    local chunks."""
    v, f = _grid_mesh()
    b = SceneBuilder(env=Environment.disabled())
    b.add_mesh(v, f, Material.lambertian((0.5, 0.5, 0.5)))
    chunks = b._mesh_chunks(b._meshes[0])
    assert len(chunks) > 1
    for tri_pos, _, bmin, bmax, _ in chunks:
        flat = tri_pos.reshape(-1, 3)
        np.testing.assert_array_equal(bmin, flat.min(axis=0))
        np.testing.assert_array_equal(bmax, flat.max(axis=0))


def test_progressive_scenes_ghosting_matches_manual_fold():
    """Two frames with a moved sphere under accumulation == the manual
    per-frame fold (the reference's ghosting: both poses visible at half
    weight in the average)."""
    # emission 0.8 keeps every value below the accumulator's per-frame
    # saturate (emission 2.0 would fold as saturate(2.0 * 0.5) = 1.0 and
    # hide the half-weighting); disjoint poses in opposite image halves
    # keep the two frames' footprints from overlapping
    b = SceneBuilder(env=Environment.disabled())
    b.add_sphere(
        (-1.2, 0.0, 0.0), 0.5, Material.emissive((1.0, 1.0, 1.0), 0.8)
    )
    s0 = b.build()
    b.set_sphere(0, center=(1.2, 0.0, 0.0))
    s1 = b.build()
    cam = _cam()
    cfg = RenderConfig(width=64, height=32, max_bounce=2, spp=1)

    out = render_progressive(s0, cam, cfg, frames=2, scenes=[s0, s1])

    f0 = render_frame(s0, cam, cfg, jnp.uint32(0))
    f1 = render_frame(s1, cam, cfg, jnp.uint32(1))
    manual = accumulate(
        jnp.zeros_like(f0), f0, 0, clamp=cfg.clamp_accumulate
    )
    manual = accumulate(manual, f1, 1, clamp=cfg.clamp_accumulate)
    np.testing.assert_array_equal(out, np.asarray(manual))

    # ghosting: the emissive sphere lights BOTH poses at half weight -
    # each pose's brightest accumulated pixel is half its single-frame
    # value (no clamping at emission 0.8) but clearly nonzero
    m0 = float(np.asarray(f0).max())
    m1 = float(np.asarray(f1).max())
    left = float(out[:, : out.shape[1] // 2].max())
    right = float(out[:, out.shape[1] // 2 :].max())
    assert abs(left - 0.5 * m0) < 1e-5, (left, m0)
    assert abs(right - 0.5 * m1) < 1e-5, (right, m1)
    assert left > 0.1 and right > 0.1


def test_progressive_scenes_validation():
    scene, cam, cfg = three_sphere_scene(width=64, height=32, spp=1)
    with pytest.raises(ValueError, match="scenes covers"):
        render_progressive(scene, cam, cfg, frames=3, scenes=[scene, scene])
    with pytest.raises(ValueError, match="batch=1"):
        render_progressive(
            scene, cam, cfg, frames=2, scenes=[scene, scene], batch=2
        )

    # changed object count => different shapes => refused (one compiled
    # program serves the whole animation)
    b = _animated_builder()
    s0 = b.build()
    big = SceneBuilder(env=Environment.disabled())
    for i in range(130):  # crosses the 128-lane pad boundary
        big.add_sphere((float(i), 0.0, 0.0), 0.1, Material.lambertian((1, 1, 1)))
    s_big = big.build()
    with pytest.raises(ValueError, match="structure or shapes"):
        render_progressive(s0, cam, cfg, frames=2, scenes=[s0, s_big])


def test_progressive_scenes_checkpoint_fingerprint(tmp_path):
    """Resuming an animation against a DIFFERENT scene path is refused."""
    b = _animated_builder()
    s0 = b.build()
    b.set_sphere(0, center=(0.6, 0.0, 0.0))
    s1 = b.build()
    cam = _cam()
    cfg = RenderConfig(width=64, height=32, max_bounce=2, spp=1)
    ck = tmp_path / "anim.npz"

    straight = render_progressive(s0, cam, cfg, frames=2, scenes=[s0, s1])
    render_progressive(
        s0, cam, cfg, frames=1, scenes=[s0, s1], checkpoint_path=str(ck)
    )
    resumed = render_progressive(
        s0, cam, cfg, frames=1, scenes=[s0, s1],
        checkpoint_path=str(ck), resume=True,
    )
    np.testing.assert_allclose(resumed, straight, atol=1e-6)

    with pytest.raises(ValueError, match="fingerprint mismatch"):
        render_progressive(
            s0, cam, cfg, frames=1, scenes=[s0, s0],
            checkpoint_path=str(ck), resume=True,
        )
