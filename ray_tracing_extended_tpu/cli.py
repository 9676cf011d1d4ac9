"""Command-line entry points: render / benchmark / compare.

    python -m ray_tracing_extended_tpu.cli render --scene preset:three_sphere \\
        --frames 16 --out out.png --metrics metrics.jsonl
    python -m ray_tracing_extended_tpu.cli render --scene Chess.unity \\
        --width 1920 --height 1080 --frames 64 \\
        --checkpoint chess.npz --resume
    python -m ray_tracing_extended_tpu.cli benchmark
    python -m ray_tracing_extended_tpu.cli compare --scene preset:mesh \\
        --a bvh --b bruteforce

Scene specs: ``preset:{three_sphere|rtiow|cornell|mesh}``, a ``.unity``
scene (the reference's own files load directly), a ``.json`` scene
(scene/json_scene.py schema), or a ``.obj`` mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .utils.config import INTERSECTORS


def _load_scene(spec: str, args):
    overrides = {}
    for k in ("width", "height", "spp", "max_bounce"):
        v = getattr(args, k, None)
        if v is not None:
            overrides[k] = v
    if getattr(args, "intersector", None):
        overrides["intersector"] = args.intersector
    if getattr(args, "hdr", False):
        overrides["clamp_accumulate"] = False

    if spec.startswith("preset:"):
        from .models import presets

        name = spec.split(":", 1)[1]
        table = {
            "three_sphere": presets.three_sphere_scene,
            "rtiow": presets.rtiow_final_scene,
            "cornell": presets.cornell_box_scene,
            "mesh": presets.mesh_scene,
        }
        fn = table.get(name)
        if fn is None:
            raise SystemExit(
                f"unknown preset {name!r}; available: {sorted(table)}"
            )
        scene, cam, cfg = fn()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return scene, cam, cfg.validate()
    if spec.endswith(".unity"):
        from .scene.unity import load_unity_scene

        return load_unity_scene(spec, overrides=overrides)
    if spec.endswith(".json"):
        from .scene.json_scene import load_json_scene

        return load_json_scene(spec, overrides=overrides)
    if spec.endswith(".obj"):
        from .models.presets import mesh_scene

        scene, cam, cfg = mesh_scene(obj_path=spec)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return scene, cam, cfg.validate()
    raise SystemExit(f"unrecognized scene spec: {spec}")


def _parse_mesh(spec):
    """'SPPxTILES' (e.g. '1x4', '2x4') -> jax.sharding.Mesh over the
    available devices (the renderer's DP axes, parallel/sharding.py)."""
    import jax

    from .parallel.sharding import make_mesh

    try:
        spp_s, tiles_s = spec.lower().split("x")
        spp_n, tiles_n = int(spp_s), int(tiles_s)
    except ValueError:
        raise SystemExit(
            f"--mesh expects SPPxTILES (e.g. 1x4, 2x4), got {spec!r}"
        )
    need = spp_n * tiles_n
    have = len(jax.devices())
    if need > have:
        raise SystemExit(
            f"--mesh {spec} needs {need} devices, only {have} visible "
            "(hint: XLA_FLAGS=--xla_force_host_platform_device_count=N "
            "JAX_PLATFORMS=cpu simulates an N-device mesh)"
        )
    return make_mesh(jax.devices()[:need], spp_parallel=spp_n)


def cmd_render(args):
    from .progressive import render_progressive
    from .utils.metrics import MetricsLogger

    scene, cam, cfg = _load_scene(args.scene, args)
    cameras = None
    if args.flythrough:
        # BASELINE config 5: circular dolly path with defocus (the
        # per-frame OnRenderImage loop under camera motion,
        # RayTracingManager.cs:49-93). The path is scene-independent but
        # scaled for RTIOW-sized scenes (preset:rtiow).
        from .models.presets import flythrough_cameras

        _, cameras, fcfg = flythrough_cameras(
            args.flythrough, width=cfg.width, height=cfg.height
        )
        # `--spp 0` is an explicit (invalid, caught by RenderConfig
        # validation) request, not "unset" - test identity, not truthiness
        if args.spp is None:
            cfg = dataclasses.replace(cfg, spp=fcfg.spp)
        if args.frames is not None and args.frames != args.flythrough:
            raise SystemExit(
                f"--frames {args.frames} conflicts with --flythrough "
                f"{args.flythrough}: the fly-through renders one frame "
                "per camera; drop --frames"
            )
        args.frames = args.flythrough
        cam = cameras[0]
    elif args.frames is None:
        args.frames = 1
    mesh = _parse_mesh(args.mesh) if args.mesh else None
    if args.reset_on_move and cameras is None:
        raise SystemExit("--reset-on-move needs --flythrough N")
    if cam is None:
        raise SystemExit("scene has no camera; pass a preset or add one")
    metrics = MetricsLogger(args.metrics, echo=args.verbose)
    import contextlib

    prof = contextlib.nullcontext()
    if args.profile:
        from .utils.profiling import trace

        prof = trace(args.profile)
    with prof:
        img = render_progressive(
            scene,
            cam,
            cfg,
            frames=args.frames,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            metrics=metrics,
            cameras=cameras,
            mesh=mesh,
            batch=args.batch,
            reset_on_move=args.reset_on_move,
        )
    metrics.close()
    if args.out:
        if args.out.endswith(".npy"):
            # raw linear radiance (HDR workflows; --hdr keeps it unclamped)
            import numpy as np

            np.save(args.out, np.asarray(img, np.float32))
        else:
            from .utils.image import save_png

            save_png(args.out, img, tone=args.tone, exposure=args.exposure)
        print(f"wrote {args.out} ({cfg.width}x{cfg.height}, "
              f"{args.frames} frames x {cfg.spp} spp)")
    return 0


def cmd_benchmark(args):
    import bench  # repo-root benchmark

    return bench.main()


def cmd_compare(args):
    """Render the same frame with two intersectors and report agreement -
    the MC-statistical pixel comparison of SURVEY.md section 4.

    The paths share bit-exact integer RNG but round their geometry math
    differently, which decorrelates knife-edge paths - a large share of
    pixels on a scene of hundreds of spheres - while both remain
    estimators of the same integral. The verdict therefore keys on the
    MEDIAN pixel and the image mean, which move far outside these bands
    on any real defect (wrong material, broken traversal), not on a
    per-pixel tight fraction that scene complexity alone can push past
    any fixed cutoff."""
    import numpy as np
    import jax.numpy as jnp

    from .render import render_frame

    scene, cam, cfg = _load_scene(args.scene, args)
    imgs = {}
    for which in (args.a, args.b):
        c = dataclasses.replace(cfg, intersector=which)
        imgs[which] = np.asarray(
            render_frame(scene, cam, c, jnp.uint32(args.frame))
        )
    a, b = imgs[args.a], imgs[args.b]
    d = np.abs(a - b)
    rel = (d / (1.0 + np.abs(b))).max(axis=-1)
    med = float(np.median(rel))
    mean_rel = abs(a.mean() - b.mean()) / max(b.mean(), 1e-9)
    print(
        f"{args.a} vs {args.b}: median_rel={med:.3e} mean|d|={d.mean():.3e} "
        f"max|d|={d.max():.3e} frac(rel<3e-3)={(rel < 3e-3).mean():.4f} "
        f"means {a.mean():.5f}/{b.mean():.5f} (rel {mean_rel:.4f})"
    )
    ok = (
        not np.isnan(a).any()
        and not np.isnan(b).any()
        and med < 2e-3
        and d.mean() < 0.1
        and mean_rel < 0.03
    )
    print("AGREE" if ok else "DISAGREE")
    return 0 if ok else 1


def main(argv=None):
    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="ray_tracing_extended_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_scene_args(sp):
        sp.add_argument("--scene", required=True)
        sp.add_argument("--width", type=int)
        sp.add_argument("--height", type=int)
        sp.add_argument("--spp", type=int)
        sp.add_argument("--max-bounce", dest="max_bounce", type=int)
        sp.add_argument("--intersector", choices=INTERSECTORS)
        sp.add_argument("--hdr", action="store_true",
                        help="unclamped accumulation (reference clamps)")

    r = sub.add_parser("render", help="progressive render")
    add_scene_args(r)
    r.add_argument(
        "--frames", type=int, default=None,
        help="frames to accumulate (default 1; implied by --flythrough N)",
    )
    r.add_argument(
        "--batch", type=int, default=1, metavar="K",
        help="frames fused per dispatch (static camera; the same "
        "estimator and fold as per-frame rendering, one metrics line "
        "per chunk)",
    )
    r.add_argument(
        "--flythrough", type=int, default=0, metavar="N",
        help="render an N-frame config-5 camera fly-through (circular "
             "dolly with defocus; scaled for preset:rtiow)")
    r.add_argument(
        "--reset-on-move", dest="reset_on_move", action="store_true",
        help="restart accumulation when the fly-through camera moves "
             "(extension; default reproduces the reference's "
             "ghosting-by-design averaging)")
    r.add_argument(
        "--mesh", default=None, metavar="SPPxTILES",
        help="multi-device mesh, e.g. 1x4 (4 devices shard the pixel "
             "blocks) or 2x4 (8 devices: 2 frame seeds x 4 tiles)")
    r.add_argument("--out", default=None)
    r.add_argument("--tone", default="none",
                   choices=["none", "reinhard", "aces"])
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--resume", action="store_true")
    r.add_argument("--metrics", default=None)
    r.add_argument("--profile", default=None,
                   help="dump a jax.profiler trace (xplane) to this dir")
    r.add_argument("--verbose", action="store_true")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("benchmark", help="canonical Mrays/s benchmark")
    b.set_defaults(fn=cmd_benchmark)

    c = sub.add_parser("compare", help="cross-intersector agreement check")
    add_scene_args(c)
    c.add_argument("--a", default="auto", choices=INTERSECTORS)
    c.add_argument("--b", default="bruteforce", choices=INTERSECTORS)
    c.add_argument("--frame", type=int, default=0)
    c.set_defaults(fn=cmd_compare)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
