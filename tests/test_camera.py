"""Camera ray generation against a float64 NumPy transcription of the
reference's frag setup (RayTracing.shader:364-382), and the precision the
camera product asks for (a float32 product on a GPU may otherwise run in
TF32 and bend every primary ray at the fourth digit)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracing_extended_tpu.ops import rng as rng_ops
from ray_tracing_extended_tpu.ops.camera import (
    focus_points,
    generate_rays,
    look_at,
)

CAMERAS = [
    dict(position=(0, 1, -4), target=(0, 0, 0), fov_y_deg=60,
         focus_distance=1.0, defocus_strength=0.0, diverge_strength=0.3),
    dict(position=(13, 2, 3), target=(0, 0, 0), fov_y_deg=20,
         focus_distance=10.0, defocus_strength=60.0, diverge_strength=1.0),
    dict(position=(-2, 5, 7), target=(1, 0, -1), fov_y_deg=95,
         focus_distance=3.5, defocus_strength=5.0, diverge_strength=0.0),
]


def _reference_rays(cam, x, y, width, height, discs):
    """float64 transcription: focus point, defocus origin, AA jitter."""
    rot = np.asarray(cam.rotation, np.float64)
    pos = np.asarray(cam.position, np.float64)
    f = float(cam.focus_distance)
    plane_h = f * math.tan(float(cam.fov_y_deg) * math.pi / 360.0) * 2.0
    plane_w = plane_h * width / height
    u = (x + 0.5) / width
    v = (y + 0.5) / height
    local = np.stack(
        [(u - 0.5) * plane_w, (v - 0.5) * plane_h, np.full_like(u, f)], -1
    )
    fp = pos + local @ rot.T
    right, up = rot[:, 0], rot[:, 1]
    dfc, jit = discs
    origin = pos + (right * dfc[:, :1] + up * dfc[:, 1:]) * (
        float(cam.defocus_strength) / width
    )
    target = fp + (right * jit[:, :1] + up * jit[:, 1:]) * (
        float(cam.diverge_strength) / width
    )
    d = target - origin
    return fp, origin, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("params", CAMERAS)
def test_generate_rays_matches_float64(params):
    params = dict(params)
    cam = look_at(params.pop("position"), params.pop("target"), **params)
    width, height = 96, 54
    pix = np.arange(0, width * height, 7, dtype=np.int32)
    x, y = pix % width, pix // width
    state = rng_ops.seed(jnp.asarray(pix), jnp.uint32(5))
    fp = focus_points(cam, jnp.asarray(x), jnp.asarray(y), width, height)
    _, origin, direction = generate_rays(state, cam, fp, width)
    # the same two disc draws generate_rays consumes
    s, dfc = rng_ops.random_point_in_circle(state)
    _, jit = rng_ops.random_point_in_circle(s)
    ref_fp, ref_o, ref_d = _reference_rays(
        cam, x.astype(np.float64), y.astype(np.float64), width, height,
        (np.asarray(dfc, np.float64), np.asarray(jit, np.float64)),
    )
    scale = max(1.0, float(np.abs(ref_fp).max()))
    np.testing.assert_allclose(np.asarray(fp), ref_fp, rtol=0,
                               atol=4e-6 * scale)
    np.testing.assert_allclose(np.asarray(origin), ref_o, rtol=0,
                               atol=4e-6 * scale)
    np.testing.assert_allclose(np.asarray(direction), ref_d, rtol=0,
                               atol=2e-6 * scale)


def test_camera_product_requests_highest_precision():
    cam = look_at((0, 1, -4), (0, 0, 0))
    jaxpr = jax.make_jaxpr(
        lambda x, y: focus_points(cam, x, y, 16, 8)
    )(jnp.arange(4), jnp.arange(4))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, "focus_points no longer has a product to check"
    for e in dots:
        assert "HIGHEST" in str(e.params["precision"]), e.params["precision"]
