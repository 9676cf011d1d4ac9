"""Frame rendering driver: the analog of RayTracingManager.OnRenderImage.

The reference launches one fragment thread per pixel (Graphics.Blit,
RayTracingManager.cs:76) then averages frames (accumulate pass, :79-81). Here
a frame render is a single jitted program: pixels are flattened, padded to a
whole number of blocks, and processed as dense (block,) batches - each block
runs the spp loop (sequential, because the reference threads ONE RNG state
through all of a pixel's samples, RayTracing.shader:374-385) around the
masked bounce loop (ops/trace.py). Blocks are mapped with ``lax.map`` to
bound the (rays x primitives) intermediate footprint; multi-chip sharding
splits the same block axis across devices (parallel/sharding.py) with zero
hot-loop collectives.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from .models.geometry import Scene
from .ops import rng as rng_ops
from .ops.accumulate import accumulate
from .ops.camera import Camera, focus_points, generate_rays
from .ops.intersect import HitRecord
from .ops.trace import trace
from .utils.config import RenderConfig


def _resolve_intersector(
    scene: Scene, cfg: RenderConfig
) -> Callable[..., HitRecord] | None:
    if cfg.intersector == "auto":
        if scene.tri_bvh is not None or scene.sphere_bvh is not None:
            from .accel.bvh import closest_hit_bvh

            return closest_hit_bvh
        return None  # trace() defaults to brute force
    if cfg.intersector == "bruteforce":
        return None
    if cfg.intersector == "bvh":
        from .accel.bvh import closest_hit_bvh

        return closest_hit_bvh
    raise ValueError(f"unknown intersector {cfg.intersector!r}")


def render_block(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame,
    pix_idx,
    intersect_fn=None,
    with_bounce_counts: bool = False,
):
    """Render one flat block of pixels -> (B, 3) linear radiance.

    ``pix_idx`` is (B,) int32 global pixel index (y * width + x, row 0 at the
    bottom). Padding indices (>= the pixel count) render the last pixel -
    valid rays, cheaper than masking inside the hot loop - and the caller
    discards their radiance; their segments are not counted.
    """
    width = cfg.width
    pix_idx = pix_idx.astype(jnp.int32)
    real = pix_idx < cfg.num_pixels
    pix_idx = jnp.minimum(pix_idx, cfg.num_pixels - 1)
    x = pix_idx % width
    y = pix_idx // width
    state = rng_ops.seed(pix_idx, frame)
    fp = focus_points(camera, x, y, width, cfg.height)

    def spp_body(_, carry):
        state, total, segs, counts = carry
        state, origin, direction = generate_rays(state, camera, fp, width)
        out = trace(
            state,
            origin,
            direction,
            scene,
            cfg.max_bounce,
            intersect_fn=intersect_fn,
            with_bounce_counts=with_bounce_counts,
        )
        if with_bounce_counts:
            state, light, s, c = out
            counts = counts + c
        else:
            state, light, s = out
        return state, total + light, segs + s, counts

    init = (
        state,
        jnp.zeros((pix_idx.shape[0], 3), jnp.float32),
        jnp.zeros((pix_idx.shape[0],), jnp.int32),
        jnp.zeros((cfg.max_bounce + 1,), jnp.int32),
    )
    _, total, segs, counts = lax.fori_loop(0, cfg.spp, spp_body, init)
    segs = jnp.where(real, segs, 0)
    if with_bounce_counts:
        return total / jnp.float32(cfg.spp), segs, counts
    return total / jnp.float32(cfg.spp), segs


# Elements of one (pixels x primitives) brute-force matrix in a block. The
# bounce step keeps up to ~5 such f32 matrices live at once (Chess, 6k
# triangles: 42 GB of temporaries at 2^31 elements per matrix on an H100),
# so 2^30 holds a block's working set near 20 GB.
BRUTE_FORCE_ELEMENTS = 1 << 30

# Block size when RenderConfig.block_size is None. Each block's bounce loop
# runs until its slowest path ends, so deep scenes want small blocks that
# exit early, and shallow ones want few large blocks (fewer launches). On an
# H100, whole-frame blocks against 32,768 pixels: RTIOW 1080p depth 4
# 987 vs 1215 ms (700 W card); Cornell 512^2 depth 8 53 vs 62 ms, the 70k
# mesh depth 4 507 vs 812 ms, Chess 720p depth 15 7389 vs 4904 ms, Balls
# Outdoors 720p depth 30 4554 vs 2488 ms (400 W card). The cut-off lies
# somewhere between depth 8 and 15: no depth from 9 to 14 was measured, and
# the two readings came from cards of different power limits. Placing it is
# for a benchmark cell at an intermediate depth.
SHALLOW_MAX_BOUNCE = 8
DEEP_BLOCK = 32768


def _brute_force_width(scene: Scene, cfg: RenderConfig) -> int:
    """Primitives every ray tests by brute force: the width of the (pixels
    x primitives) matrices. Primitives under a BVH the intersector
    traverses do not count."""
    bvh = _resolve_intersector(scene, cfg) is not None
    width = 0
    if not (bvh and scene.sphere_bvh is not None):
        width += scene.spheres.count
    if not (bvh and scene.tri_bvh is not None):
        width += scene.triangles.count
    return max(width, 1)


def _padded_pixel_blocks(cfg: RenderConfig, width: int = 1, n_shards: int = 1):
    """Static (nb, block) pixel-index grid covering the image in equal
    blocks, with ``nb`` a multiple of ``n_shards`` (the mesh's 'tiles'
    axis) and fewer than ``nb`` padding indices (>= the pixel count). No
    block exceeds ``cfg.block_size`` (default: by bounce depth, see
    SHALLOW_MAX_BOUNCE) nor the brute-force memory bound for ``width``
    primitives."""
    import numpy as np

    n = cfg.num_pixels
    cap = cfg.block_size
    if cap is None:
        cap = n if cfg.max_bounce <= SHALLOW_MAX_BOUNCE else DEEP_BLOCK
    cap = max(1, min(cap, BRUTE_FORCE_ELEMENTS // width))
    nb = _round_up(-(-n // cap), n_shards)
    block = -(-n // nb)
    return np.arange(nb * block, dtype=np.int32).reshape(nb, block)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.jit, static_argnames=("cfg", "bounce_stats")
)
def render_frame_with_stats(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame,
    bounce_stats: bool = False,
):
    """Render one full frame -> ((H, W, 3) f32 linear radiance, total ray
    segments traced (uint32 scalar) - the Mrays/s numerator).

    ``frame`` is a traced uint32 scalar (progressive accumulation advances it
    without recompiling). Row 0 of the output is the image BOTTOM.
    With ``bounce_stats`` a third element is returned: (max_bounce + 1,)
    int32 live-path counts per bounce index (normalise by counts[0] for the
    alive fraction - SURVEY.md section 5 observability).
    """
    blocks = jnp.asarray(
        _padded_pixel_blocks(cfg, _brute_force_width(scene, cfg))
    )
    intersect_fn = _resolve_intersector(scene, cfg)

    def run(block_idx):
        out = render_block(
            scene, camera, cfg, frame, block_idx,
            intersect_fn=intersect_fn, with_bounce_counts=bounce_stats,
        )
        if bounce_stats:
            img, segs, counts = out
            return img, jnp.sum(segs, dtype=jnp.uint32), counts
        img, segs = out
        return img, jnp.sum(segs, dtype=jnp.uint32)

    if blocks.shape[0] == 1:
        out = run(blocks[0])
        flat, total_segs = out[0], out[1]
        counts = out[2] if bounce_stats else None
    else:
        out = lax.map(run, blocks)
        flat = out[0].reshape(-1, 3)
        total_segs = jnp.sum(out[1], dtype=jnp.uint32)
        counts = jnp.sum(out[2], axis=0) if bounce_stats else None
    flat = flat[: cfg.num_pixels]
    img = flat.reshape(cfg.height, cfg.width, 3)
    if bounce_stats:
        return img, total_segs, counts
    return img, total_segs


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig, frame):
    """Render one full frame -> (H, W, 3) f32 linear radiance."""
    img, _ = render_frame_with_stats(scene, camera, cfg, frame)
    return img


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_frames"), donate_argnums=(3,)
)
def render_frames_and_accumulate(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    accum,
    frame0,
    n_frames: int = 1,
):
    """``n_frames`` progressive steps fused into one dispatch -> (accum',
    total ray segments uint32).

    Frames ``frame0 .. frame0 + n_frames - 1`` are rendered and folded in
    order with the reference weighting, exactly like ``n_frames`` calls of
    ``render_and_accumulate``. The frames are a ``lax.fori_loop``, so the
    program holds one bounce loop whatever ``n_frames`` is."""
    frame0 = jnp.asarray(frame0, jnp.uint32)

    def body(k, carry):
        accum, total = carry
        f = frame0 + k.astype(jnp.uint32)
        cur, segs = render_frame_with_stats(scene, camera, cfg, f)
        accum = accumulate(accum, cur, f, clamp=cfg.clamp_accumulate)
        return accum, total + segs

    return lax.fori_loop(0, n_frames, body, (accum, jnp.uint32(0)))


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(3,))
def render_and_accumulate(
    scene: Scene, camera: Camera, cfg: RenderConfig, accum, frame
):
    """One progressive step: render frame ``frame`` and fold it into the
    running average (the Blit-accumulate-Blit sequence of
    RayTracingManager.cs:69-84, fused on device; the accumulation buffer is
    donated so the image never round-trips to host)."""
    cur = render_frame(scene, camera, cfg, frame)
    return accumulate(accum, cur, frame, clamp=cfg.clamp_accumulate)
