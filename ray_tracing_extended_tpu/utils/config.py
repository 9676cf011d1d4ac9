"""Render configuration: the analog of the manager's inspector knobs.

Mirrors the serialized settings at RayTracingManager.cs:12-17 plus framework
knobs (block size, accumulation clamp mode). Static/hashable: these values
select compiled programs (loop trip counts, shapes), so they are jit cache
keys, unlike the traced Camera/Environment arrays.

``validate()`` applies the reference's OnValidate clamps
(RayTracingManager.cs:196-203).
"""

from __future__ import annotations

import dataclasses

INTERSECTORS = ("auto", "bruteforce", "bvh")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 320
    height: int = 180
    # [Range(0, 32)] maxBounceCount, default 4 (RayTracingManager.cs:12).
    max_bounce: int = 4
    # [Range(0, 64)] numRaysPerPixel, default 2 (RayTracingManager.cs:13).
    spp: int = 2
    # Parity mode: reference's per-frame saturate in the accumulator
    # (Accumulate.shader:50). False = HDR accumulation (extension).
    clamp_accumulate: bool = True
    # Upper bound on the pixels rendered per block of the frame's
    # ``lax.map``; the renderer lowers it further so that no (rays x
    # primitives) brute-force matrix exceeds render.BRUTE_FORCE_ELEMENTS.
    # None: the whole frame for scenes of max_bounce <= 8, else 32,768
    # pixels (render.SHALLOW_MAX_BOUNCE has the readings behind it).
    block_size: int | None = None
    # Intersector selection: "auto" picks BVH when present else brute force.
    intersector: str = "auto"

    def validate(self) -> "RenderConfig":
        """Clamp like OnValidate (RayTracingManager.cs:196-203) and check
        framework invariants."""
        cfg = dataclasses.replace(
            self,
            max_bounce=max(0, self.max_bounce),
            spp=max(1, self.spp),
        )
        if cfg.width <= 0 or cfg.height <= 0:
            raise ValueError("image dimensions must be positive")
        if cfg.block_size is not None and cfg.block_size <= 0:
            raise ValueError("block_size must be positive or None")
        if cfg.intersector not in INTERSECTORS:
            raise ValueError(
                f"intersector must be one of {INTERSECTORS}, got "
                f"{cfg.intersector!r}"
            )
        return cfg

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
