"""Multi-device rendering: image-tile and spp sharding over a JAX device mesh.

The reference's only parallelism is per-pixel SIMT on one GPU
(Graphics.Blit, RayTracingManager.cs:76; SURVEY.md section 2.5). The
scale-out axes across devices are:

  * ``tiles`` - pixel-block data parallelism: the flattened, padded pixel
    blocks (see render.py) are sharded across devices; the scene (the analog
    of structured buffers bound to every GPU wavefront) is replicated. Zero
    collectives in the hot loop, and the accumulation buffer stays sharded
    in block layout between steps.

  * ``spp`` - sample parallelism: each 'spp' row renders the full image with
    a different frame seed, and one ``all_gather`` over the interconnect
    hands every row's frames to the fold - the multi-device generalization
    of the reference's accumulate pass (Accumulate.shader:48-50). This is
    the ONLY collective in the system besides the segment-count ``psum``.

Both compose in a single 2D mesh: ``Mesh(devices, ('spp', 'tiles'))``. Step
``s`` renders frames ``[s * spp_size, (s + 1) * spp_size)`` and folds them in
frame order with the reference weighting, so a sharded progressive render
equals the single-device sequence over the same frame indices.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.geometry import Scene
from ..ops.accumulate import accumulate
from ..ops.camera import Camera
from ..render import (
    _brute_force_width,
    _padded_pixel_blocks,
    _resolve_intersector,
    render_block,
)
from ..utils.config import RenderConfig


def make_mesh(
    devices: Sequence[jax.Device] | None = None,
    spp_parallel: int = 1,
) -> Mesh:
    """Build a 2D ('spp', 'tiles') mesh over the given (default: all)
    devices. ``spp_parallel`` chips cooperate per pixel; the rest shard
    tiles."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % spp_parallel != 0:
        raise ValueError(
            f"spp_parallel={spp_parallel} does not divide device count {n}"
        )
    arr = np.array(devices).reshape(spp_parallel, n // spp_parallel)
    return Mesh(arr, ("spp", "tiles"))


def _blocks(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> np.ndarray:
    """Pixel blocks whose count divides the 'tiles' axis."""
    return _padded_pixel_blocks(
        cfg, _brute_force_width(scene, cfg), mesh.shape["tiles"]
    )


def _render_shard(scene, camera, cfg, blocks_local, frame):
    """Inside ``shard_map``: this device's blocks of frame ``frame + row``
    (row = its 'spp' index) -> (every row's frames (spp_size, nb_local, B,
    3), total live segments over the mesh)."""
    intersect_fn = _resolve_intersector(scene, cfg)
    row = lax.axis_index("spp").astype(jnp.uint32)

    def run(block_idx):
        img, segs = render_block(
            scene, camera, cfg, frame + row, block_idx,
            intersect_fn=intersect_fn,
        )
        return img, jnp.sum(segs, dtype=jnp.uint32)

    flat, segs = lax.map(run, blocks_local)  # (nb_local, B, 3)
    frames = lax.all_gather(flat, axis_name="spp")
    segs = lax.psum(jnp.sum(segs, dtype=jnp.uint32), ("spp", "tiles"))
    return frames, segs


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh", "n_steps"), donate_argnums=(3,)
)
def render_step_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    accum,
    frame,
    mesh: Mesh,
    n_steps: int = 1,
    weight0=None,
):
    """``n_steps`` multi-device progressive steps fused into one dispatch.

    Step i renders frames ``frame + i * spp_size + r`` (r = 'spp' row) and
    folds them into ``accum`` (block layout, donated) in frame order with
    the reference weighting - per-frame clamp included, so parity mode is
    exact. Frame ``frame + j`` folds with weight index ``weight0 + j``
    (default ``weight0 = frame``); ``reset_on_move`` restarts the weights
    without restarting the RNG frames. Every block runs the same program as
    a single-device frame. Returns (accum', total live segments uint32)."""
    k = mesh.shape["spp"]
    blocks = jnp.asarray(_blocks(scene, cfg, mesh))
    frame = jnp.asarray(frame, jnp.uint32)
    weight0 = frame if weight0 is None else jnp.asarray(weight0, jnp.uint32)

    def shard_fn(blocks_local, accum_local, frame, weight0):
        def step(i, carry):
            acc, total = carry
            j = i.astype(jnp.uint32) * jnp.uint32(k)
            frames, segs = _render_shard(
                scene, camera, cfg, blocks_local, frame + j
            )
            for r in range(k):
                acc = accumulate(
                    acc, frames[r], weight0 + j + jnp.uint32(r),
                    clamp=cfg.clamp_accumulate,
                )
            return acc, total + segs

        return lax.fori_loop(
            0, n_steps, step, (accum_local, jnp.uint32(0))
        )

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("tiles"), P("tiles"), P(), P()),
        out_specs=(P("tiles"), P()),
        check_vma=False,
    )(blocks, accum, frame, weight0)


def init_accum_blocks(scene: Scene, cfg: RenderConfig, mesh: Mesh):
    """Zero accumulation buffer in sharded block layout (nb, B, 3), placed
    with blocks sharded over 'tiles' and replicated over 'spp'."""
    return image_to_blocks(
        np.zeros((cfg.height, cfg.width, 3), np.float32), scene, cfg, mesh
    )


def image_to_blocks(img, scene: Scene, cfg: RenderConfig, mesh: Mesh):
    """(H, W, 3) image -> the block layout the sharded renders of ``scene``
    use (the inverse of ``blocks_to_image``; padding pixels are zero)."""
    nb, block = _blocks(scene, cfg, mesh).shape
    flat = np.zeros((nb * block, 3), np.float32)
    flat[: cfg.num_pixels] = np.asarray(img, np.float32).reshape(-1, 3)
    return jax.device_put(
        flat.reshape(nb, block, 3), NamedSharding(mesh, P("tiles"))
    )


def blocks_to_image(accum_blocks, cfg: RenderConfig):
    """Gather the sharded block layout back into an (H, W, 3) image."""
    flat = np.asarray(accum_blocks).reshape(-1, 3)[: cfg.num_pixels]
    return flat.reshape(cfg.height, cfg.width, 3)

