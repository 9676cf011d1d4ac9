"""Frame driver: block layout, padding, block-size invariance, and the fused
K-frame step ``render_frames_and_accumulate``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracing_extended_tpu.models.presets import three_sphere_scene
from ray_tracing_extended_tpu.render import (
    BRUTE_FORCE_ELEMENTS,
    DEEP_BLOCK,
    _brute_force_width,
    _padded_pixel_blocks,
    render_and_accumulate,
    render_frame,
    render_frame_with_stats,
    render_frames_and_accumulate,
)
from ray_tracing_extended_tpu.utils.config import RenderConfig


def test_xla_block_size_invariant():
    """XLA-path renders are bit-identical across block_size: per-pixel
    seeds are global, so re-batching the pixel axis only re-orders work
    (the fragment-shader independence property, SURVEY section 4)."""
    scene, cam, cfg = three_sphere_scene(width=64, height=36, spp=1)
    a = render_frame(
        scene, cam, dataclasses.replace(cfg, block_size=256), jnp.uint32(2)
    )
    b = render_frame(
        scene, cam, dataclasses.replace(cfg, block_size=1000),
        jnp.uint32(2),
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_frames_and_accumulate_xla_path():
    """The public fused progressive step matches render_and_accumulate
    exactly."""
    scene, cam, cfg = three_sphere_scene(width=32, height=16, spp=2)
    acc = jnp.zeros((16, 32, 3), jnp.float32)
    for f in range(2):
        acc = render_and_accumulate(scene, cam, cfg, acc, jnp.uint32(f))
    acc_b, segs = render_frames_and_accumulate(
        scene, cam, cfg, jnp.zeros((16, 32, 3), jnp.float32),
        jnp.uint32(0), 2,
    )
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_b))
    assert int(segs) > 0


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_render_frames_and_accumulate_matches_sequential(k, clamp):
    """K fused frames from frame0 = 3 onto an existing average equal K
    sequential render + fold steps, and count the same segments."""
    scene, cam, cfg = three_sphere_scene(width=24, height=12, spp=1)
    cfg = dataclasses.replace(cfg, clamp_accumulate=clamp)
    start = jnp.full((12, 24, 3), 0.5, jnp.float32)
    acc, segs_seq = start, 0
    for f in range(3, 3 + k):
        acc = render_and_accumulate(scene, cam, cfg, acc, jnp.uint32(f))
        _, s = render_frame_with_stats(scene, cam, cfg, jnp.uint32(f))
        segs_seq += int(s)
    acc_b, segs = render_frames_and_accumulate(
        scene, cam, cfg, jnp.full((12, 24, 3), 0.5, jnp.float32),
        jnp.uint32(3), k,
    )
    np.testing.assert_allclose(
        np.asarray(acc_b), np.asarray(acc), rtol=0, atol=2e-6
    )
    assert int(segs) == segs_seq


def _bounce_loops(k):
    scene, cam, cfg = three_sphere_scene(width=16, height=8, spp=1)
    jaxpr = jax.make_jaxpr(
        lambda acc: render_frames_and_accumulate(
            scene, cam, cfg, acc, jnp.uint32(0), k
        )
    )(jnp.zeros((8, 16, 3), jnp.float32))
    return str(jaxpr).count("while[")


@pytest.mark.parametrize("k", [2, 8])
def test_render_frames_and_accumulate_one_bounce_loop(k):
    """The K frames are a loop, not K unrolled copies of the trace: the
    program holds as many while-loops for K frames as for one."""
    assert _bounce_loops(k) == _bounce_loops(1) >= 1


@pytest.mark.parametrize(
    "width,height,block,prims,n_shards",
    [(64, 36, 32768, 1, 1), (64, 36, 500, 1, 1), (64, 36, 32768, 1, 4),
     (30, 7, 16, 1, 8), (64, 36, 32768, BRUTE_FORCE_ELEMENTS // 100, 1)],
)
def test_padded_pixel_blocks(width, height, block, prims, n_shards):
    """The block grid covers every pixel once in order, its block count
    divides the shard count, blocks never exceed block_size nor the
    brute-force memory bound, and no shard is left holding only padding
    when the image could fill it."""
    cfg = RenderConfig(width=width, height=height, block_size=block)
    grid = _padded_pixel_blocks(cfg, prims, n_shards)
    n = width * height
    nb, b = grid.shape
    assert nb % n_shards == 0 and b <= block
    assert b * prims <= BRUTE_FORCE_ELEMENTS
    np.testing.assert_array_equal(grid.reshape(-1)[:n], np.arange(n))
    assert (grid.reshape(-1)[n:] >= n).all()
    assert grid.size - n < b * n_shards  # less than one block per shard


@pytest.mark.parametrize("max_bounce,blocks", [(4, 1), (8, 1), (15, 29)])
def test_default_block_by_bounce_depth(max_bounce, blocks):
    """block_size=None: shallow scenes run as one block, deep ones in
    blocks of at most DEEP_BLOCK pixels (720p -> 29 equal blocks)."""
    cfg = RenderConfig(width=1280, height=720, max_bounce=max_bounce)
    assert cfg.block_size is None
    grid = _padded_pixel_blocks(cfg, 1)
    assert grid.shape[0] == blocks and grid.shape[1] <= (
        1280 * 720 if blocks == 1 else DEEP_BLOCK
    )


def test_brute_force_width_skips_bvh_primitives():
    """Only primitives the intersector scans by brute force size the
    blocks: a BVH takes its primitive type out unless brute force is
    forced."""
    from ray_tracing_extended_tpu.models.presets import rtiow_final_scene

    scene, _, cfg = rtiow_final_scene(width=8, height=8, build_bvh="sphere")
    s, t = scene.spheres.count, scene.triangles.count
    assert _brute_force_width(scene, cfg) == t
    bf = dataclasses.replace(cfg, intersector="bruteforce")
    assert _brute_force_width(scene, bf) == s + t


def test_padding_segments_not_counted():
    """Padding lanes re-render the last pixel but add no segments: the
    count is the same whatever padding the block size leaves."""
    scene, cam, cfg = three_sphere_scene(width=20, height=10, spp=1)
    counts = {
        int(render_frame_with_stats(
            scene, cam, dataclasses.replace(cfg, block_size=b),
            jnp.uint32(0),
        )[1])
        for b in (200, 64, 7)
    }
    assert len(counts) == 1
