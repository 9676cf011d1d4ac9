"""Camera model and per-pixel ray generation.

Mirrors UpdateCameraParams (RayTracingManager.cs:126-133) and the ray setup
in frag (RayTracing.shader:364-382):

  planeHeight = focusDistance * tan(fovY / 2) * 2
  planeWidth  = planeHeight * aspect
  focusPoint  = cam * ((uv - 0.5) * (planeW, planeH), focusDistance)
  per sample: defocus-disc origin jitter (DefocusStrength / width) and
  anti-alias target-disc jitter (DivergeStrength / width), both in the
  camera right/up plane; direction = normalize(focusPoint' - origin).

Pixel convention: row 0 is the image BOTTOM (Unity UV origin), pixel centers
at (x + 0.5) / width. ``pixel_index = y * width + x`` seeds the RNG
(RayTracing.shader:358-362).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from . import rng as rng_ops
from . import vecmath as vm
from .intersect import MATMUL_PRECISION


@pytree_dataclass
class Camera:
    """Pinhole + thin-lens camera. ``rotation`` is local-to-world with
    columns (right, up, forward), matching Unity's transform matrix use at
    RayTracing.shader:366-368. All fields are traced arrays so camera motion
    (fly-throughs) does not recompile."""

    position: jnp.ndarray  # (3,) f32
    rotation: jnp.ndarray  # (3, 3) f32
    fov_y_deg: jnp.ndarray  # () f32 vertical field of view
    focus_distance: jnp.ndarray  # () f32 (RayTracingManager.cs:16)
    defocus_strength: jnp.ndarray  # () f32 (RayTracingManager.cs:14)
    diverge_strength: jnp.ndarray  # () f32 (RayTracingManager.cs:15)


def look_at(
    position,
    target,
    up=(0.0, 1.0, 0.0),
    fov_y_deg=60.0,
    focus_distance=1.0,
    defocus_strength=0.0,
    diverge_strength=0.3,
) -> Camera:
    """Build a camera looking from ``position`` toward ``target``.

    Default knob values mirror the manager's inspector defaults
    (RayTracingManager.cs:12-16).
    """
    # host numpy: cameras are tiny and jitted consumers convert on call;
    # keeping them off-device makes checkpoint fingerprints and host-side
    # camera math free of device round-trips
    import numpy as _np

    position = _np.asarray(position, _np.float32)
    target = _np.asarray(target, _np.float32)
    up_hint = _np.asarray(up, _np.float32)

    def _nrm(v):
        n = float(_np.linalg.norm(v))
        if n < 1e-12:
            raise ValueError(
                "look_at: degenerate basis (is `up` parallel to the view "
                "direction?)"
            )
        return v / n

    fwd = _nrm(target - position)
    right = _nrm(_np.cross(up_hint, fwd))
    up_v = _np.cross(fwd, right)
    rotation = _np.stack([right, up_v, fwd], axis=-1).astype(_np.float32)
    return Camera(
        position=position,
        rotation=rotation,
        fov_y_deg=_np.float32(fov_y_deg),
        focus_distance=_np.float32(focus_distance),
        defocus_strength=_np.float32(defocus_strength),
        diverge_strength=_np.float32(diverge_strength),
    )


def camera_from_matrix(
    position,
    rotation,
    fov_y_deg=60.0,
    focus_distance=1.0,
    defocus_strength=0.0,
    diverge_strength=0.3,
) -> Camera:
    """Camera from an explicit local-to-world rotation (scene-file ports).
    Host numpy leaves, same as look_at (checkpoint fingerprints and other
    host reads stay free of device round-trips)."""
    import numpy as _np

    return Camera(
        position=_np.asarray(position, _np.float32),
        rotation=_np.asarray(rotation, _np.float32),
        fov_y_deg=_np.float32(fov_y_deg),
        focus_distance=_np.float32(focus_distance),
        defocus_strength=_np.float32(defocus_strength),
        diverge_strength=_np.float32(diverge_strength),
    )


def focus_points(cam: Camera, pix_x, pix_y, width: int, height: int):
    """World-space focus-plane points for pixel coordinates (B,) -> (B, 3).

    RayTracing.shader:365-366 with the plane size math of
    RayTracingManager.cs:128-131.
    """
    u = (pix_x.astype(jnp.float32) + 0.5) / jnp.float32(width)
    v = (pix_y.astype(jnp.float32) + 0.5) / jnp.float32(height)
    half_fov = cam.fov_y_deg * jnp.float32(math.pi / 360.0)
    plane_h = cam.focus_distance * jnp.tan(half_fov) * 2.0
    plane_w = plane_h * jnp.float32(width / height)
    local = jnp.stack(
        [
            (u - 0.5) * plane_w,
            (v - 0.5) * plane_h,
            jnp.broadcast_to(cam.focus_distance, u.shape),
        ],
        axis=-1,
    )
    return cam.position[None, :] + jnp.matmul(
        local, cam.rotation.T, precision=MATMUL_PRECISION
    )


def generate_rays(state, cam: Camera, focus_point, width: int):
    """One ray per lane with defocus + anti-aliasing jitter, consuming four
    draws per lane (RayTracing.shader:377-382).

    Returns ``(state, origin (B,3), dir (B,3))``.
    """
    right = cam.rotation[:, 0]
    up = cam.rotation[:, 1]
    inv_w = 1.0 / jnp.float32(width)

    state, defocus = rng_ops.random_point_in_circle(state)
    defocus = defocus * (cam.defocus_strength * inv_w)
    origin = (
        cam.position[None, :]
        + right[None, :] * defocus[..., 0:1]
        + up[None, :] * defocus[..., 1:2]
    )

    state, jitter = rng_ops.random_point_in_circle(state)
    jitter = jitter * (cam.diverge_strength * inv_w)
    target = (
        focus_point
        + right[None, :] * jitter[..., 0:1]
        + up[None, :] * jitter[..., 1:2]
    )
    direction = vm.normalize(target - origin)
    return state, origin, direction
