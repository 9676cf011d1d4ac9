"""Progressive accumulation: running average across frames.

Reproduces the Accumulate pass (Accumulate.shader:43-53):

  weight = 1 / (frame + 1)
  out    = saturate(prev * (1 - weight) + cur * weight)

The per-frame ``saturate`` clamps the accumulated value to [0, 1] BEFORE it is
averaged into later frames - an LDR clamp that tone-limits fireflies and is
observable in the reference's output (SURVEY.md section 5 quirk 2). Parity
mode reproduces it; HDR mode (``clamp=False``) accumulates unclamped radiance
and is the benchmark/production default for downstream tone-mapping.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import vecmath as vm


def accumulate(prev, cur, frame, clamp: bool = True):
    """Fold frame ``frame``'s render ``cur`` into the running average
    ``prev``. ``frame`` counts from 0; at frame 0 the weight is 1 so any
    ``prev`` content is discarded (mirrors RayTracingManager.cs:74-81 where
    the first accumulate sees an undefined prev texture)."""
    n = jnp.asarray(frame, jnp.float32) + 1.0
    # prev + (cur/n - prev/n) is prev*(1 - w) + cur*w with w = 1/n, written
    # with no product feeding an add. Fused into a larger program (K frames
    # per dispatch, a sharded step, the render that made ``cur``), such a
    # pair may be contracted into one FMA, which rounds once and moves the
    # last bit; divisions and adds give the same bits in every program.
    out = jnp.where(n == 1.0, cur, prev + (cur / n - prev / n))
    return vm.saturate(out) if clamp else out
