"""ray_tracing_extended_tpu: a progressive Monte-Carlo path tracer in JAX.

A ground-up JAX/XLA re-design of the capabilities of the Unity/HLSL
reference renderer MaxLayar/Ray-Tracing-Extended (see SURVEY.md): per-pixel
PCG RNG, thin-lens camera with defocus/anti-alias jitter, sphere + triangle
scenes with diffuse/specular/emissive materials (checker and invisible-light
flags, plus a dielectric extension), procedural sky/sun environment,
Russian-roulette path termination, and progressive multi-frame accumulation -
all on device, with image blocks sharded across GPUs.

Quick start::

    import ray_tracing_extended_tpu as rte

    scene = rte.SceneBuilder().add_sphere((0, 0, 3), 1.0,
        rte.Material.lambertian((0.8, 0.2, 0.2))).build()
    cam = rte.look_at((0, 0, 0), (0, 0, 1), fov_y_deg=60)
    cfg = rte.RenderConfig(width=320, height=180, max_bounce=4, spp=16)
    img = rte.render_frame(scene, cam, cfg, frame=0)
"""

from .models.geometry import (
    BVH,
    FLAG_CHECKER,
    FLAG_DIELECTRIC,
    FLAG_INVISIBLE_LIGHT,
    FLAG_NONE,
    Environment,
    Materials,
    MeshChunks,
    Scene,
    Spheres,
    Triangles,
)
from .models.scene import Material, SceneBuilder
from .ops.camera import Camera, camera_from_matrix, look_at
from .ops.accumulate import accumulate
from .progressive import render_progressive
from .render import (
    render_and_accumulate,
    render_frames_and_accumulate,
    render_frame,
    render_frame_with_stats,
)
from .utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "BVH",
    "Camera",
    "Environment",
    "FLAG_CHECKER",
    "FLAG_DIELECTRIC",
    "FLAG_INVISIBLE_LIGHT",
    "FLAG_NONE",
    "Material",
    "Materials",
    "MeshChunks",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "Spheres",
    "Triangles",
    "accumulate",
    "camera_from_matrix",
    "look_at",
    "render_and_accumulate",
    "render_frames_and_accumulate",
    "render_frame",
    "render_frame_with_stats",
    "render_progressive",
]
