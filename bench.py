"""Benchmark: per-frame time and live-segment rate of the XLA render path on
one GPU, for the RTIOW final scene at 1080p (headline) and the other
shipped configurations.

Counts rays honestly: the numerator is the number of scene intersections of
LIVE path segments (dead masked lanes and padding pixels excluded), taken
from the renderer's per-lane segment counters - not pixels x spp x depth,
which would overstate throughput once Russian roulette / env misses
terminate paths.

Each cell is compiled and warmed first (compile time is reported as
set-up), then timed over interleaved repetitions that each end in
``block_until_ready``; the value is the median, with the min-max spread.
Every line names the device kind, the device count and the card's power
limit. Without a GPU the bench exits non-zero and measures nothing.

Prints one JSON line per cell, the RTIOW headline LAST.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def _power_limit() -> str:
    """Card name and power limit from nvidia-smi (a child without JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_cell(name, scene, camera, cfg, device, n_runs=5, frames=1):
    """Compile + warm, then ``n_runs`` timed repetitions of ``frames``
    frames each -> one JSON line."""
    import jax.numpy as jnp

    from ray_tracing_extended_tpu.render import (
        _brute_force_width,
        _padded_pixel_blocks,
        render_frame_with_stats,
    )
    from ray_tracing_extended_tpu.utils.profiling import program_bytes

    state = {"frame": 0}

    def run():
        total = 0
        t0 = time.perf_counter()
        for _ in range(frames):
            img, segs = render_frame_with_stats(
                scene, camera, cfg, jnp.uint32(state["frame"])
            )
            state["frame"] += 1
            total += int(segs)  # host sync: the frame has finished
        img.block_until_ready()
        return total, time.perf_counter() - t0

    t0 = time.perf_counter()
    run()
    setup_s = time.perf_counter() - t0
    walls, segs = [], []
    for _ in range(n_runs):
        s, w = run()
        segs.append(s)
        walls.append(w)
    frame_ms = np.asarray(walls) / frames * 1e3
    mrays = np.asarray(segs) / np.asarray(walls) / 1e6
    line = {
        "metric": name,
        "frame_ms": float(np.median(frame_ms)),
        "frame_ms_spread": [float(frame_ms.min()), float(frame_ms.max())],
        "mrays_per_s": float(np.median(mrays)),
        "mrays_per_s_spread": [float(mrays.min()), float(mrays.max())],
        "spp_per_s": float(cfg.spp / np.median(frame_ms) * 1e3),
        "rays_per_path": float(
            np.median(segs) / (frames * cfg.num_pixels * cfg.spp)
        ),
        "n_runs": n_runs,
        "frames_per_run": frames,
        "setup_s_compile_and_first_run": setup_s,
        "program_bytes": program_bytes(
            render_frame_with_stats, scene, camera, cfg, jnp.uint32(0)
        ),
        "config": {"width": cfg.width, "height": cfg.height,
                   "spp": cfg.spp, "max_bounce": cfg.max_bounce,
                   "blocks": list(_padded_pixel_blocks(
                       cfg, _brute_force_width(scene, cfg)).shape),
                   "bvh": scene.tri_bvh is not None
                   or scene.sphere_bvh is not None},
        **device,
    }
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU - JAX found {dev.platform!r} devices only",
              file=sys.stderr)
        return 1
    from ray_tracing_extended_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    from ray_tracing_extended_tpu.models.presets import (
        cornell_box_scene,
        mesh_scene,
        rtiow_final_scene,
    )
    from ray_tracing_extended_tpu.scene.json_scene import load_json_scene

    device = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": _power_limit(),
    }
    cells = [
        ("Cornell box 512x512 depth-8", cornell_box_scene(), 3),
        ("mesh_scene 70k tris BVH 1280x720", mesh_scene(), 3),
        ("Balls Outdoors 1280x720 30x30", load_json_scene(
            ROOT / "scenes" / "balls_outdoors.json",
            overrides=dict(width=1280, height=720)), 3),
        ("Chess 1280x720 3x15 DoF", load_json_scene(
            ROOT / "scenes" / "chess.json",
            overrides=dict(width=1280, height=720)), 3),
        ("RTIOW final scene 1920x1080 4-bounce 16 spp", rtiow_final_scene(
            width=1920, height=1080, max_bounce=4, spp=16), 5),
    ]
    for name, (scene, cam, cfg), n_runs in cells:
        _time_cell(name, scene, cam, cfg, device, n_runs=n_runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
