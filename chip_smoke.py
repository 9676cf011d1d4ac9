#!/usr/bin/env python3
"""On-card smoke test: drives the path tracer's main path on one GPU through
the entry points a user calls, at the sizes users run, and checks the
results against the repository's plain references.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded fly-through

Phases (one card): device, rtiow, cornell, mesh, cli, agree. With
``--four-cards`` only the four-card phase runs. Every phase runs, any
failure exits non-zero, and the last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``. Without
a GPU the script exits non-zero before any phase.

Everything runs in this one process (a JAX process reserves most of a
card's memory when it starts); ``nvidia-smi`` runs in a child that does not
import JAX, and the CLI is driven in-process through ``cli.main``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PHASES = ("rtiow", "cornell", "mesh", "cli", "agree")
FOUR_CARD_PHASES = ("four_cards",)

# Image-mean sanity bands (linear radiance). Each is about +-20-25% around
# the scene's converged mean; a black, saturated or garbage frame falls far
# outside, while Monte-Carlo noise of the image mean at these sizes is
# under 2%.
RTIOW_MEAN = (0.30, 0.46)
CORNELL_MEAN = (0.35, 0.70)
MESH_MEAN = (0.35, 0.57)
CHESS_MEAN = (0.35, 0.65)

# Agreement bars for two renders of one frame by two paths that share the
# RNG streams but round differently: (median per-pixel relative difference,
# mean |difference|, image-mean relative difference). Most pixels follow
# identical paths, so the median pixel agrees exactly; a knife-edge pixel
# flips to another sample of the same integral and moves the means a
# little. The bars sit well above the readings on an H100 (NVIDIA H100
# 80GB HBM3, 700 W) and below what a wrong material, a broken traversal
# or bent primary rays move: with the camera product at DEFAULT precision
# (TF32; NVIDIA H100 80GB HBM3, 400 W) device vs CPU read mean |d| 1.7e-4
# and 4.5e-3, mean rel 1.9e-5 and 3.1e-3, and failed. They hold at the
# sizes named in ``phase_agree``; at 1/s of the pixels one flipped pixel
# moves the means s times as much, so a smaller check scales the two mean
# bars by s.
AGREE_BARS = {
    # GPU vs CPU transcendentals. Readings: median 0.0, mean |d| 3.9e-7
    # and 7.4e-11, mean rel 6.6e-7 and 1.5e-10 (three-sphere, Cornell).
    "device_vs_cpu": (1e-6, 1e-4, 1e-4),
    # brute force vs BVH hit order on near-ties. Readings: median 0.0,
    # mean |d| 6.0e-4 and 2.8e-12, mean rel 6.0e-5 and 6.1e-12 (RTIOW
    # sphere BVH, 70k-triangle mesh).
    "bvh_vs_bruteforce": (1e-6, 5e-3, 1e-3),
}


def select_phases(four_cards: bool) -> tuple:
    return FOUR_CARD_PHASES if four_cards else PHASES


def log(phase: str, **values) -> None:
    items = " ".join(f"{k}={v}" for k, v in values.items())
    print(f"[{phase}] {items}", flush=True)


def _check_image(phase, img, shape, band):
    img = np.asarray(img)
    mean = float(img.mean())
    if img.shape != shape:
        raise AssertionError(f"{phase}: image shape {img.shape} != {shape}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{phase}: non-finite values in the image")
    if not band[0] <= mean <= band[1]:
        raise AssertionError(
            f"{phase}: image mean {mean:.5f} outside the band {band}"
        )
    return mean


def _process_peak_bytes():
    """The process's peak device memory so far: a phase's own only for the
    first phase (rtiow); the others report ``program_bytes``."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def _block_grid(scene, cfg) -> str:
    """'<blocks>x<pixels per block>' as the renderer lays out this frame."""
    from ray_tracing_extended_tpu.render import (
        _brute_force_width,
        _padded_pixel_blocks,
    )

    nb, b = _padded_pixel_blocks(cfg, _brute_force_width(scene, cfg)).shape
    return f"{nb}x{b}"


def _read_metrics(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def card_info() -> str:
    """Card name and power limit, read by a child that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def phase_rtiow(width=1920, height=1080, spp=16, frames=3):
    """RTIOW final scene (~490 spheres, brute force) through
    render_progressive: compile time, steady frame time, live-segment
    rate and peak device memory."""
    import jax.numpy as jnp

    from ray_tracing_extended_tpu.models.presets import rtiow_final_scene
    from ray_tracing_extended_tpu.progressive import render_progressive
    from ray_tracing_extended_tpu.render import render_frame_with_stats
    from ray_tracing_extended_tpu.utils.metrics import MetricsLogger
    from ray_tracing_extended_tpu.utils.profiling import program_bytes

    scene, cam, cfg = rtiow_final_scene(
        width=width, height=height, max_bounce=4, spp=spp
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "m.jsonl"
        logger = MetricsLogger(str(path))
        img = render_progressive(scene, cam, cfg, frames, metrics=logger)
        logger.close()
        lines = _read_metrics(path)
    steady = lines[1:] or lines
    frame_s = float(np.median([m["wall_s"] for m in steady]))
    mean = _check_image("rtiow", img, (height, width, 3), RTIOW_MEAN)
    log(
        "rtiow", size=f"{width}x{height}", spp=spp, frames=frames,
        blocks=_block_grid(scene, cfg),
        compile_and_first_frame_s=lines[0]["wall_s"],
        compile_s=round(lines[0]["wall_s"] - frame_s, 3),
        steady_frame_ms=round(frame_s * 1e3, 3),
        mrays_per_s=float(np.median([m["mrays_per_s"] for m in steady])),
        rays_per_path=lines[-1]["rays_per_path"],
        process_peak_bytes=_process_peak_bytes(),
        program_bytes=program_bytes(
            render_frame_with_stats, scene, cam, cfg, jnp.uint32(0),
            bounce_stats=True,
        ),
        image_mean=mean,
    )


def phase_cornell(width=512, height=512, frames=3):
    """Cornell box (triangles, dielectric, emissive; depth 8): frames fused
    per dispatch through render_frames_and_accumulate, as --batch does."""
    import jax.numpy as jnp

    from ray_tracing_extended_tpu.models.presets import cornell_box_scene
    from ray_tracing_extended_tpu.render import render_frames_and_accumulate
    from ray_tracing_extended_tpu.utils.profiling import program_bytes

    scene, cam, cfg = cornell_box_scene(width=width, height=height)

    def run(acc, frame0):
        t0 = time.perf_counter()
        acc, segs = render_frames_and_accumulate(
            scene, cam, cfg, acc, jnp.uint32(frame0), frames
        )
        acc.block_until_ready()
        return acc, int(segs), time.perf_counter() - t0

    acc, _, first_s = run(jnp.zeros((height, width, 3), jnp.float32), 0)
    acc, segs, wall = run(acc, frames)  # frames 0 .. 2 * frames - 1
    mean = _check_image("cornell", acc, (height, width, 3), CORNELL_MEAN)
    log(
        "cornell", size=f"{width}x{height}", blocks=_block_grid(scene, cfg),
        max_bounce=cfg.max_bounce,
        spp=cfg.spp, frames_per_dispatch=frames,
        compile_s=round(first_s - wall, 3),
        steady_frame_ms=round(wall / frames * 1e3, 3),
        mrays_per_s=segs / wall / 1e6,
        program_bytes=program_bytes(
            render_frames_and_accumulate, scene, cam, cfg, acc,
            jnp.uint32(0), frames,
        ),
        image_mean=mean,
    )


def phase_mesh(width=1280, height=720, target_tris=None):
    """The ~70k-triangle procedural mesh on the BVH path: one frame after
    a warm-up frame."""
    import jax.numpy as jnp

    from ray_tracing_extended_tpu.models.presets import mesh_scene
    from ray_tracing_extended_tpu.render import render_frame_with_stats
    from ray_tracing_extended_tpu.utils.profiling import program_bytes

    kw = {} if target_tris is None else {"target_tris": target_tris}
    scene, cam, cfg = mesh_scene(width=width, height=height, **kw)
    assert scene.tri_bvh is not None, "mesh preset must carry a BVH"
    t0 = time.perf_counter()
    img, segs = render_frame_with_stats(scene, cam, cfg, jnp.uint32(0))
    img.block_until_ready()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, segs = render_frame_with_stats(scene, cam, cfg, jnp.uint32(1))
    img.block_until_ready()
    wall = time.perf_counter() - t0
    mean = _check_image("mesh", img, (height, width, 3), MESH_MEAN)
    log(
        "mesh", size=f"{width}x{height}", blocks=_block_grid(scene, cfg),
        triangles=int(scene.triangles.count), spp=cfg.spp,
        compile_s=round(first_s - wall, 3), frame_ms=round(wall * 1e3, 3),
        mrays_per_s=int(segs) / wall / 1e6,
        program_bytes=program_bytes(
            render_frame_with_stats, scene, cam, cfg, jnp.uint32(0)
        ),
        image_mean=mean,
    )


def phase_cli(width=1280, height=720, frames=2):
    """The CLI's render command on Chess (5.9k triangles, brute force):
    the largest (rays x triangles) intermediates of any shipped scene."""
    from ray_tracing_extended_tpu.cli import main as cli_main
    from ray_tracing_extended_tpu.utils.image import load_png

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "chess.png"
        metrics = Path(tmp) / "chess.jsonl"
        rc = cli_main([
            "render", "--scene", str(ROOT / "scenes" / "chess.json"),
            "--width", str(width), "--height", str(height),
            "--frames", str(frames), "--out", str(out),
            "--metrics", str(metrics),
        ])
        if rc != 0:
            raise AssertionError(f"cli: render returned {rc}")
        img = load_png(out)
        lines = _read_metrics(metrics)
    if len(lines) != frames:
        raise AssertionError(f"cli: {len(lines)} metrics lines != {frames}")
    mean = _check_image("cli", img, (height, width, 3), CHESS_MEAN)
    log(
        "cli", scene="chess.json", size=f"{width}x{height}", frames=frames,
        frame_wall_s=[m["wall_s"] for m in lines],
        mrays_per_s=lines[-1]["mrays_per_s"], png_mean_linear=mean,
    )


def agreement(a, b) -> dict:
    """Median per-pixel relative difference, mean |difference| and image
    mean relative difference of two renders of one frame."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    rel = (d / (1.0 + np.abs(b))).max(axis=-1)
    return {
        "median_rel": float(np.median(rel)),
        "mean_abs_diff": float(d.mean()),
        "mean_rel": float(abs(a.mean() - b.mean()) / max(b.mean(), 1e-9)),
        "nan": bool(np.isnan(a).any() or np.isnan(b).any()),
    }


def _assert_agree(what, stats, scale=1):
    median_bar, abs_bar, mean_bar = AGREE_BARS[what.split(":")[0]]
    ok = (
        not stats["nan"]
        and stats["median_rel"] < median_bar
        and stats["mean_abs_diff"] < abs_bar * scale
        and stats["mean_rel"] < mean_bar * scale
    )
    log("agree", check=what, **stats, ok=ok)
    if not ok:
        raise AssertionError(f"agree: {what} outside the bars: {stats}")


def phase_agree(small=False):
    """Agreement with the plain references:
    (a) the same frame on this device and on the host CPU;
    (b) the scalar oracle tests/reference_tracer.py by test_render_parity's
        own criteria;
    (c) the stored goldens by test_golden's tolerance;
    (d) brute force against BVH on the same scene."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ray_tracing_extended_tpu.models.presets import (
        cornell_box_scene,
        mesh_scene,
        rtiow_final_scene,
        three_sphere_scene,
    )
    from ray_tracing_extended_tpu.render import render_frame

    sys.path.insert(0, str(ROOT / "tests"))
    import test_golden
    import test_render_parity

    def frame(scene, cam, cfg, f=0, device=None):
        if device is not None:
            scene, cam = jax.device_put((scene, cam), device)
        return np.asarray(render_frame(scene, cam, cfg, jnp.uint32(f)))

    # (a) this device vs the host CPU
    cpu = jax.devices("cpu")[0]
    div = 4 if small else 1
    cases = [
        ("three_sphere", three_sphere_scene(width=320 // div,
                                            height=180 // div)),
        ("cornell", cornell_box_scene(width=128 // div, height=128 // div,
                                      spp=16)),
    ]
    for name, (scene, cam, cfg) in cases:
        _assert_agree(
            f"device_vs_cpu:{name}:{cfg.width}x{cfg.height}",
            agreement(frame(scene, cam, cfg), frame(scene, cam, cfg,
                                                    device=cpu)),
            scale=div * div,
        )

    # (b) scalar oracle, by the parity test's own criteria
    for f in (0, 7):
        img_dev, img_ref = test_render_parity._render_both(frame=f)
        stats = test_render_parity.parity_stats(img_dev, img_ref)
        log("agree", check=f"oracle:frame{f}", **stats)
        test_render_parity._assert_parity(img_dev, img_ref)

    # (c) goldens, by the golden test's tolerance
    for name, make, f in test_golden.GOLDENS:
        scene, cam, cfg = make()
        mean_d, frac_drift = test_golden.golden_drift(
            name, frame(scene, cam, cfg, f)
        )
        log("agree", check=f"golden:{name}", mean_drift=mean_d,
            frac_pixels_drifted=frac_drift)
        test_golden.assert_golden(name, mean_d, frac_drift)

    # (d) brute force vs BVH on one scene
    cases = [
        ("rtiow_sphere_bvh", rtiow_final_scene(
            width=480 // div, height=270 // div, max_bounce=4, spp=4,
            build_bvh="sphere")),
        ("mesh_tri_bvh", mesh_scene(
            width=160 // div, height=90 // div,
            **({"target_tris": 2000} if small else {}))),
    ]
    for name, (scene, cam, cfg) in cases:
        bvh = frame(scene, cam, dataclasses.replace(cfg, intersector="bvh"))
        # block bounds the (rays x triangles) matrices of the 70k mesh
        bf_cfg = dataclasses.replace(
            cfg, intersector="bruteforce", block_size=4096
        )
        _assert_agree(
            f"bvh_vs_bruteforce:{name}:{cfg.width}x{cfg.height}",
            agreement(bvh, frame(scene, cam, bf_cfg)),
            scale=div * div,
        )


def phase_four_cards(width=3840, height=2160, steps=4, devices=None):
    """The 4K depth-of-field fly-through over a 1x4 ('spp', 'tiles') mesh
    and a 2x2 mesh, each against one card rendering the same frame
    indices: once with a camera per step (one step per dispatch), once
    with the first camera held and every step fused into one dispatch
    (``batch``). Every block runs the same program and the frames fold in
    the same order with a fold that no compiler contraction can move, so
    all four are expected bit-identical to one card; the 2x2 bar allows
    1e-6 relative in case its gathered frames fold with other rounding."""
    import jax

    from ray_tracing_extended_tpu.models.presets import flythrough_cameras
    from ray_tracing_extended_tpu.parallel.sharding import make_mesh
    from ray_tracing_extended_tpu.progressive import render_progressive

    devices = list(devices if devices is not None else jax.devices())
    if len(devices) < 4:
        raise AssertionError(f"four_cards: {len(devices)} devices < 4")
    devices = devices[:4]
    scene, cams, cfg = flythrough_cameras(steps, width=width, height=height)
    assert not cfg.clamp_accumulate  # the fly-through accumulates in HDR

    def timed(**kw):
        render_progressive(scene, cams[0], cfg, **kw)  # compile + warm
        t0 = time.perf_counter()
        img = render_progressive(scene, cams[0], cfg, **kw)
        return img, time.perf_counter() - t0

    for spp_rows in (1, 2):
        mesh = make_mesh(devices, spp_parallel=spp_rows)
        n_steps = steps // spp_rows
        step_cams = cams[:n_steps]
        frame_cams = [c for c in step_cams for _ in range(spp_rows)]
        runs = {
            "cameras": (dict(frames=n_steps, cameras=step_cams),
                        dict(frames=steps, cameras=frame_cams)),
            "batch": (dict(frames=n_steps, batch=n_steps),
                      dict(frames=steps, batch=steps)),
        }
        for mode, (mesh_kw, ref_kw) in runs.items():
            img, wall = timed(mesh=mesh, **mesh_kw)
            with jax.default_device(devices[0]):
                ref, ref_wall = timed(**ref_kw)
            d = np.abs(img - ref)
            max_rel = float((d / np.maximum(np.abs(ref), 1.0)).max())
            tol = 0.0 if spp_rows == 1 else 1e-6
            ok = bool(np.isfinite(img).all() and max_rel <= tol)
            log(
                "four_cards", mesh=f"{spp_rows}x{4 // spp_rows}", mode=mode,
                size=f"{width}x{height}", frames=steps,
                mesh_ms_per_frame=round(wall / steps * 1e3, 3),
                one_card_ms_per_frame=round(ref_wall / steps * 1e3, 3),
                bit_identical=bool((d == 0).all()),
                max_abs_diff=float(d.max()), max_rel_diff=max_rel,
                tolerance=tol, image_mean=float(img.mean()), ok=ok,
            )
            if not ok:
                raise AssertionError(
                    f"four_cards: {spp_rows}x{4 // spp_rows} mesh ({mode}) "
                    f"differs from one card (max rel {max_rel:.3e} > {tol})"
                )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card sharded fly-through phase",
    )
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke: no GPU - JAX found {dev.platform!r} devices only",
            file=sys.stderr,
        )
        return 1
    from ray_tracing_extended_tpu.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    count = 4 if args.four_cards else 1
    log(
        "device", platform=dev.platform, kind=repr(dev.device_kind),
        visible=len(jax.devices()), used=count, jax=jax.__version__,
        compile_cache=cache_dir,
    )
    print(card_info(), flush=True)

    phases = {
        "rtiow": phase_rtiow, "cornell": phase_cornell, "mesh": phase_mesh,
        "cli": phase_cli, "agree": phase_agree,
        "four_cards": phase_four_cards,
    }
    for name in select_phases(args.four_cards):
        t0 = time.perf_counter()
        phases[name]()
        log(name, phase_wall_s=round(time.perf_counter() - t0, 3))

    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
