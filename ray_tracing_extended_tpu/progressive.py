"""Progressive multi-frame renderer: the frame loop of the reference's
OnRenderImage (RayTracingManager.cs:49-93) as a production driver with
checkpoint/resume and structured metrics (both absent in the reference -
SURVEY.md section 5).

Per frame: render, fold into the running average
with the reference's 1/(frame+1) weighting, optionally checkpoint
(atomically) and emit one JSONL metrics line (Mrays/s from live segment
counts, spp/s, convergence delta).
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from .models.geometry import Scene
from .ops.accumulate import accumulate
from .ops.camera import Camera
from .render import render_frame_with_stats
from .utils import checkpoint as ckpt
from .utils.config import RenderConfig
from .utils.metrics import FrameMetrics, MetricsLogger


def render_progressive(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frames: int,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    metrics: MetricsLogger | None = None,
    cameras=None,
    scenes=None,
    mesh=None,
    batch: int = 1,
    reset_on_move: bool = False,
):
    """Accumulate ``frames`` frames and return the (H, W, 3) average.

    ``batch``: frames fused per dispatch (static camera only): each chunk
    of ``batch`` frames is one ``render_frames_and_accumulate`` call, with
    the same estimator and fold as the per-frame loop. Per-frame
    alive_frac/accum_var metrics are unavailable (one JSONL line per chunk
    instead).

    ``cameras``: optional per-frame Camera sequence (fly-throughs,
    BASELINE config 5). With a static camera the running average converges
    to the scene's radiance; with per-frame cameras each frame still folds
    with the reference weighting (matching its behavior when the camera
    moves - SURVEY.md section 3.4: the reference keeps averaging into
    stale history, ghosting by design).

    ``scenes``: optional per-frame Scene sequence (animated/moving
    objects). Frame f renders scenes[f]; every scene must share the
    first frame's pytree structure and shapes (same object counts), so
    the whole animation reuses one compiled program. This is the
    reference's per-frame scene re-scan + re-upload
    (RayTracingManager.cs:95-109 InitFrame -> CreateSpheres/CreateMeshes;
    RayTracedMesh.cs:42-51): build each frame's Scene by mutating one
    SceneBuilder (set_sphere / set_mesh_transform) and calling build()
    again. Accumulation keeps folding into stale history while objects
    move - the reference's ghosting-by-design, same as a moving camera.

    ``reset_on_move``: opt-out of that ghosting (extension; requires
    ``cameras``): whenever the camera differs from the previous frame's,
    the running average restarts, so the result is the converged average
    of the TRAILING run of identical cameras. Frames within a run fold
    with the same weights as a fresh static render (the per-frame clamp
    included), and the Welford variance signal restarts with the run.

    ``mesh``: optional jax.sharding.Mesh ('spp', 'tiles') - each step
    renders multi-device (pixel blocks over 'tiles', zero hot-loop
    collectives; 'spp' rows render extra frame seeds - parallel/sharding.py)
    and folds its ``spp_size`` frames in frame order, so the result equals
    the single-device render of the same frame indices. On a mesh,
    ``frames`` counts steps of ``spp_size`` frames and ``cameras`` holds one
    camera per step. ``batch`` > 1 fuses that many steps per dispatch;
    ``reset_on_move`` restarts at step granularity.
    """
    if reset_on_move and cameras is None:
        raise ValueError("reset_on_move requires a cameras sequence")
    if scenes is not None:
        if mesh is not None:
            raise ValueError(
                "per-frame scenes are single-chip only for now (the "
                "sharded path renders spp_size frame seeds of ONE scene "
                "per step)"
            )
        if batch > 1:
            raise ValueError(
                "batch > 1 fuses frames into one launch over a single "
                "scene; per-frame scenes need batch=1"
            )
        struct0 = jax.tree_util.tree_structure(scenes[0])
        shapes0 = [
            (x.shape, x.dtype)
            for x in jax.tree_util.tree_leaves(scenes[0])
        ]
        for i, sc in enumerate(scenes[1:], 1):
            if (
                jax.tree_util.tree_structure(sc) != struct0
                or [
                    (x.shape, x.dtype)
                    for x in jax.tree_util.tree_leaves(sc)
                ]
                != shapes0
            ):
                raise ValueError(
                    f"scenes[{i}] differs in pytree structure or shapes "
                    "from scenes[0]; animated scenes must keep object "
                    "counts fixed (pad with never-hit primitives) so the "
                    "compiled program is reused"
                )
    if batch > 1 and cameras is not None:
        raise ValueError(
            "batch > 1 fuses frames into one dispatch under a single "
            "camera; per-frame cameras need batch=1"
        )
    if mesh is not None:
        return _render_progressive_sharded(
            scene, camera, cfg, frames, mesh,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
            resume=resume, metrics=metrics, cameras=cameras,
            batch=batch, reset_on_move=reset_on_move,
        )
    start_frame = 0
    accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    fingerprint = None
    if checkpoint_path is not None:
        # Fold the full camera path into the fingerprint: resuming a
        # fly-through against a checkpoint made with a different path must
        # be refused, exactly like a changed static camera.
        fingerprint = ckpt.state_hash(
            scene, cameras if cameras is not None else camera, cfg
        )
        if scenes is not None:
            # Fold the full animation into the fingerprint (content_hash
            # is precomputed at build, so this is free): resuming an
            # animated render against a different scene path must be
            # refused, exactly like a changed camera path.
            import hashlib

            hs = hashlib.sha256()
            for sc in scenes:
                part = getattr(sc, "content_hash", None)
                if part is None:
                    import dataclasses as _dc

                    part = ckpt.hash_tree(
                        _dc.replace(sc, tri_bvh=None, sphere_bvh=None)
                    )
                hs.update(part.encode())
            fingerprint += ":scenes:" + hs.hexdigest()[:16]
        if reset_on_move:
            # run-relative weights are a different accumulation scheme:
            # resuming a reset_on_move checkpoint without the flag (or
            # vice versa) would silently blend incompatible weightings
            fingerprint += ":reset_on_move"
        if resume and os.path.exists(checkpoint_path):
            accum_np, start_frame = ckpt.load(checkpoint_path, fingerprint)
            accum = jnp.asarray(accum_np)
    if cameras is not None and len(cameras) < start_frame + frames:
        raise ValueError(
            f"cameras covers {len(cameras)} frames; rendering frames "
            f"[{start_frame}, {start_frame + frames}) needs "
            f"{start_frame + frames}"
        )
    if scenes is not None and len(scenes) < start_frame + frames:
        raise ValueError(
            f"scenes covers {len(scenes)} frames; rendering frames "
            f"[{start_frame}, {start_frame + frames}) needs "
            f"{start_frame + frames}"
        )
    if batch > 1:
        from .render import render_frames_and_accumulate

        f = start_frame
        end = start_frame + frames
        while f < end:
            k = min(batch, end - f)
            t0 = time.perf_counter()
            accum, segs = render_frames_and_accumulate(
                scene, camera, cfg, accum, jnp.uint32(f), k
            )
            segs = int(segs)  # one host sync per chunk
            wall = time.perf_counter() - t0
            f += k
            if metrics is not None:
                metrics.log(
                    FrameMetrics(
                        frame=f - 1,
                        wall_s=wall,
                        rays=segs,
                        pixels=cfg.num_pixels,
                        spp=cfg.spp * k,
                        extra={"batched_frames": k},
                    )
                )
            if _crossed(f - k, f, checkpoint_path, checkpoint_every):
                ckpt.save(checkpoint_path, np.asarray(accum), f, fingerprint)
        if checkpoint_path is not None:
            ckpt.save(checkpoint_path, np.asarray(accum), end, fingerprint)
        return np.asarray(accum)

    # seg0 = first frame of the current same-camera run (reset_on_move)
    seg0 = _run_start(cameras, start_frame) if reset_on_move else start_frame

    # Welford running second moment across frames: var(mean) ~= mean(M2) /
    # (n (n - 1)) is the MC convergence signal promised in SURVEY section 5.
    m2 = jnp.zeros_like(accum)
    want_stats = metrics is not None
    for f in range(start_frame, start_frame + frames):
        cam = cameras[f] if cameras is not None else camera
        sc = scenes[f] if scenes is not None else scene
        if reset_on_move and f > start_frame and not _same_cam(
            cameras[f - 1], cam
        ):
            seg0 = f
            m2 = jnp.zeros_like(accum)
        t0 = time.perf_counter()
        out = render_frame_with_stats(
            sc, cam, cfg, jnp.uint32(f), bounce_stats=want_stats
        )
        cur, segs = out[0], out[1]
        prev = accum
        # reset_on_move folds with run-relative weights (a fresh render
        # of the run); otherwise the reference's global 1/(f+1)
        wf = (f - seg0) if reset_on_move else f
        accum = accumulate(accum, cur, wf, clamp=cfg.clamp_accumulate)
        # Welford step; skipped on a weight-0 fold (fresh sequence):
        # M2 is identically 0 at n=1, and with the per-frame clamp prev
        # is stale (zeros, or the previous camera run's average), whose
        # cross-term against (cur - saturate(cur)) would corrupt the
        # restarted variance signal on >1-radiance scenes
        if not (reset_on_move and f == seg0):
            m2 = m2 + (cur - prev) * (cur - accum)
        segs = int(segs)  # blocks until the frame is done
        wall = time.perf_counter() - t0
        if metrics is not None:
            counts = np.asarray(out[2])
            paths = max(int(counts[0]), 1)
            extra = {
                "alive_frac": [round(c / paths, 4) for c in counts.tolist()],
            }
            # frames covered by m2: since the last camera move (reset
            # mode) or since this invocation started (resume restarts
            # the variance signal, not the average)
            n = f - max(seg0, start_frame) + 1 if reset_on_move else (
                f - start_frame + 1
            )
            if n >= 2:
                extra["accum_var"] = float(
                    jnp.mean(m2) / (n * (n - 1))
                )
            metrics.log(
                FrameMetrics(
                    frame=f,
                    wall_s=wall,
                    rays=segs,
                    pixels=cfg.num_pixels,
                    spp=cfg.spp,
                    extra=extra,
                )
            )
        if _crossed(f, f + 1, checkpoint_path, checkpoint_every):
            ckpt.save(checkpoint_path, np.asarray(accum), f + 1, fingerprint)

    if checkpoint_path is not None:
        ckpt.save(
            checkpoint_path,
            np.asarray(accum),
            start_frame + frames,
            fingerprint,
        )
    return np.asarray(accum)


def _same_cam(a, b) -> bool:
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb)
    )


def _run_start(cameras, i: int) -> int:
    """First index of the same-camera run holding ``i`` (reset_on_move).
    On resume this back-scan keeps mid-run checkpoints at exact weights."""
    while i > 0 and _same_cam(cameras[i - 1], cameras[i]):
        i -= 1
    return i


def _crossed(prev: int, cur: int, checkpoint_path, every: int) -> bool:
    """True when advancing from ``prev`` to ``cur`` frames (or steps) passes
    a multiple of ``every`` - a periodic checkpoint is due."""
    return (
        checkpoint_path is not None
        and bool(every)
        and cur // every > prev // every
    )


def _render_progressive_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frames: int,
    mesh,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    metrics: MetricsLogger | None = None,
    cameras=None,
    batch: int = 1,
    reset_on_move: bool = False,
):
    """Multi-device progressive driver: step s renders frames
    ``[s * spp_size, (s + 1) * spp_size)`` under ``cameras[s]`` (or the
    static camera) and folds them in frame order. Each dispatch is one
    ``render_step_sharded`` call (``batch`` steps under a static camera, else
    one) on the donated accumulator, which lives in the sharded block layout
    (parallel/sharding.py) and is gathered to an image only for checkpoints
    and the result. ``frames`` counts steps, and checkpoints record steps.

    ``reset_on_move`` (requires ``cameras``): when cameras[s] differs from
    cameras[s-1] the running average restarts, so the result is the fresh
    average of the trailing run of identical cameras."""
    from .parallel.sharding import (
        blocks_to_image,
        image_to_blocks,
        init_accum_blocks,
        render_step_sharded,
    )

    spp_size = mesh.shape["spp"]
    start_step = 0
    accum = init_accum_blocks(scene, cfg, mesh)
    fingerprint = None
    if checkpoint_path is not None:
        fingerprint = ckpt.state_hash(
            scene, cameras if cameras is not None else camera, cfg
        )
        if spp_size > 1:
            # the checkpoint counts steps of spp_size frames
            fingerprint += f":spp{spp_size}"
        if reset_on_move:
            fingerprint += ":reset_on_move"
        if resume and os.path.exists(checkpoint_path):
            img, start_step = ckpt.load(checkpoint_path, fingerprint)
            accum = image_to_blocks(img, scene, cfg, mesh)
    end = start_step + frames
    if cameras is not None and len(cameras) < end:
        raise ValueError(
            f"cameras covers {len(cameras)} steps; rendering steps "
            f"[{start_step}, {end}) needs {end} (one camera per step - "
            f"each step renders {spp_size} frame seeds under it)"
        )

    seg0 = _run_start(cameras, start_step) if reset_on_move else start_step
    s = start_step
    while s < end:
        n = min(batch, end - s)  # batch > 1 only with a static camera
        cam = cameras[s] if cameras is not None else camera
        if reset_on_move and s > start_step and not _same_cam(
            cameras[s - 1], cam
        ):
            seg0 = s
        # reset_on_move folds with run-relative weights
        w0 = (s - seg0 if reset_on_move else s) * spp_size
        t0 = time.perf_counter()
        accum, segs = render_step_sharded(
            scene, cam, cfg, accum, jnp.uint32(s * spp_size), mesh,
            n_steps=n, weight0=jnp.uint32(w0),
        )
        segs = int(segs)  # one host sync per dispatch
        wall = time.perf_counter() - t0
        s += n
        if metrics is not None:
            extra = {"mesh": dict(mesh.shape)}
            if batch > 1:
                extra["batched_frames"] = n
            metrics.log(
                FrameMetrics(
                    frame=s - 1,
                    wall_s=wall,
                    rays=segs,
                    pixels=cfg.num_pixels,
                    spp=cfg.spp * spp_size * n,
                    extra=extra,
                )
            )
        if _crossed(s - n, s, checkpoint_path, checkpoint_every):
            ckpt.save(
                checkpoint_path, blocks_to_image(accum, cfg), s, fingerprint
            )

    out = blocks_to_image(accum, cfg)
    if checkpoint_path is not None:
        ckpt.save(checkpoint_path, out, end, fingerprint)
    return out
