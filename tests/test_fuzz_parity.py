"""Randomized brute-force-vs-BVH parity: seeded random scenes (sphere
counts, a huge ground sphere whose box contains every other primitive,
mixed sphere/triangle scenes, emissive/specular spreads, material flags)
that hand-written presets cannot cover. Brute force is the semantic
reference; the BVH traversal must agree except where its different
evaluation order rounds a knife-edge path the other way. The material-flag
scene is also held to the scalar oracle (tests/reference_tracer.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from ray_tracing_extended_tpu.models.scene import Material, SceneBuilder
from ray_tracing_extended_tpu.ops.camera import look_at
from ray_tracing_extended_tpu.render import render_frame_with_stats
from ray_tracing_extended_tpu.utils.config import RenderConfig


def _random_scene(seed: int, with_ground: bool, with_tris: bool,
                  with_flags: bool = False, dielectric: bool = True):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    n = int(rng.integers(30, 70))
    for _ in range(n):
        pos = rng.uniform([-6, 0.2, -6], [6, 2.5, 6])
        # with_flags sprinkles the material FLAG paths (checker /
        # invisible-light / dielectric) so their shading branches get
        # fuzzed, not just the preset coverage
        flag = int(rng.choice([0, 0, 1, 2, 3])) if with_flags else 0
        if flag == 3 and not dielectric:  # same draws, oracle-known flag
            flag = 0
        mat = Material(
            colour=tuple(rng.uniform(0.05, 1.0, 3)),
            emission_colour=tuple(rng.uniform(0, 1, 3)),
            emission_strength=float(rng.choice([0.0, 0.0, 2.0])),
            specular_colour=tuple(rng.uniform(0.5, 1.0, 3)),
            smoothness=float(rng.uniform(0, 1)),
            specular_probability=float(rng.uniform(0, 1)),
            flag=flag,
            ior=1.5 if flag == 3 else 1.0,
        )
        b.add_sphere(tuple(pos), float(rng.uniform(0.1, 0.6)), mat)
    if with_ground:
        # dwarfs the rest -> one huge BVH leaf box over every node
        b.add_sphere((0.0, -500.0, 0.0), 500.0,
                     Material.lambertian((0.5, 0.5, 0.5)))
    if with_tris:
        a = rng.uniform([-5, 0, -5], [5, 3, 5], size=(40, 1, 3))
        pos = np.concatenate(
            [a, a + rng.uniform(-1, 1, (40, 1, 3)),
             a + rng.uniform(-1, 1, (40, 1, 3))], axis=1
        ).astype(np.float32)  # (40, 3 verts, 3)
        e1 = pos[:, 1] - pos[:, 0]
        e2 = pos[:, 2] - pos[:, 0]
        n = np.cross(e1, e2)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-8)
        normals = np.repeat(n[:, None, :], 3, axis=1)
        b.add_triangles(pos, normals, Material.lambertian(
            tuple(rng.uniform(0.2, 1.0, 3))))
    scene = b.build(build_bvh="both")
    cam = look_at((0, 2.5, -10), (0, 1, 0), fov_y_deg=45)
    cfg = RenderConfig(width=48, height=32, max_bounce=3, spp=1,
                       clamp_accumulate=False)
    return scene, cam, cfg


def _render(scene, cam, cfg, intersector, frame):
    c = dataclasses.replace(cfg, intersector=intersector)
    img, segs = render_frame_with_stats(scene, cam, c, jnp.uint32(frame))
    return np.asarray(img), int(segs)


def _check(seed, with_ground, with_tris, with_flags=False):
    scene, cam, cfg = _random_scene(seed, with_ground, with_tris, with_flags)
    assert scene.sphere_bvh is not None
    assert (scene.tri_bvh is not None) == with_tris
    a, segs_a = _render(scene, cam, cfg, "bruteforce", seed)
    b, segs_b = _render(scene, cam, cfg, "bvh", seed)
    assert not np.isnan(b).any()
    assert segs_a > 0 and segs_b > 0
    d = np.abs(a - b).max(axis=-1)
    frac = (d < 1e-3).mean()
    assert frac > 0.99, f"seed {seed}: only {frac:.3f} pixels tight"
    assert np.abs(a - b).mean() < 2e-3
    return scene, cam, cfg, a


def test_fuzz_spheres_with_hoisted_ground():
    _check(7, True, False)


def test_fuzz_mixed_spheres_tris():
    _check(11, False, True)


def test_fuzz_material_flags():
    """Checker / invisible-light / dielectric flags randomly mixed: BVH
    and brute force agree; and with the dielectrics (an extension the
    oracle lacks) made plain, brute force matches the scalar oracle by
    the parity test's criteria."""
    import reference_tracer as ref
    from test_render_parity import _assert_parity

    scene, _, _, _ = _check(31, False, False, with_flags=True)
    assert {1, 2, 3} <= set(np.asarray(scene.materials.flag).tolist())

    scene, cam, cfg = _random_scene(31, False, False, True, dielectric=False)
    img, _ = _render(scene, cam, cfg, "bruteforce", 31)
    m = {k: np.asarray(v) for k, v in scene.materials.__dict__.items()}
    live = np.asarray(scene.spheres.radius) > 0
    spheres = [
        ref.Sph(
            np.asarray(scene.spheres.center)[i],
            np.float32(np.asarray(scene.spheres.radius)[i]),
            ref.Mat(
                colour=m["colour"][j],
                emission_colour=m["emission_colour"][j],
                specular_colour=m["specular_colour"][j],
                emission_strength=m["emission_strength"][j],
                smoothness=m["smoothness"][j],
                specular_probability=m["specular_probability"][j],
                flag=int(m["flag"][j]),
            ),
        )
        for i, j in enumerate(np.asarray(scene.spheres.mat_idx))
        if live[i]
    ]
    img_ref = ref.render(
        spheres, [], ref.Env(enabled=False), np.asarray(cam.position),
        np.asarray(cam.rotation), float(cam.fov_y_deg),
        np.float32(cam.focus_distance), float(cam.defocus_strength),
        float(cam.diverge_strength), cfg.width, cfg.height, cfg.max_bounce,
        cfg.spp, 31,
    )
    _assert_parity(img, img_ref)
