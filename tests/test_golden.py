"""Golden-image regression tests (SURVEY.md section 4): small deterministic
renders compared against stored goldens. Catches any semantic drift in the
full pipeline (RNG, camera, intersection, shading, accumulation).

Regenerate (only after an INTENDED behavior change) with:
    RTE_REGEN_GOLDENS=1 python -m pytest tests/test_golden.py
"""

import os
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from ray_tracing_extended_tpu.models.presets import (
    cornell_box_scene,
    three_sphere_scene,
)
from ray_tracing_extended_tpu.render import render_frame

GOLDEN_DIR = Path(__file__).parent / "goldens"

# (golden name, scene factory, frame index); chip_smoke.py checks the same
# goldens on the GPU.
GOLDENS = [
    ("three_sphere_96x54_s4_f0",
     lambda: three_sphere_scene(width=96, height=54, spp=4), 0),
    ("cornell_64x64_s2_f1",
     lambda: cornell_box_scene(width=64, height=64, max_bounce=6, spp=2), 1),
]

# f16 storage quantization + transcendental ulps across backends flip a
# few knife-edge pixels; a semantic change moves the mean far more.
MEAN_DRIFT = 2e-3
PIXEL_DRIFT = 0.05
MAX_FRAC_DRIFTED = 0.005


def golden_drift(name, img):
    """(mean |img - golden|, fraction of pixels off by >= PIXEL_DRIFT)."""
    golden = np.load(GOLDEN_DIR / f"{name}.npz")["img"].astype(np.float32)
    d = np.abs(np.asarray(img) - golden)
    return float(d.mean()), float((d.max(axis=-1) >= PIXEL_DRIFT).mean())


def assert_golden(name, mean_drift, frac_drifted):
    assert mean_drift < MEAN_DRIFT, f"{name}: mean drift {mean_drift:.2e}"
    assert frac_drifted < MAX_FRAC_DRIFTED, (
        f"{name}: {100 * frac_drifted:.2f}% pixels drifted"
    )


def _check(index):
    name, make, frame = GOLDENS[index]
    scene, cam, cfg = make()
    img = np.asarray(render_frame(scene, cam, cfg, jnp.uint32(frame)))
    if os.environ.get("RTE_REGEN_GOLDENS"):
        GOLDEN_DIR.mkdir(exist_ok=True)
        np.savez_compressed(
            GOLDEN_DIR / f"{name}.npz", img=img.astype(np.float16)
        )
        return
    assert_golden(name, *golden_drift(name, img))


def test_golden_three_sphere():
    _check(0)


def test_golden_cornell():
    _check(1)
