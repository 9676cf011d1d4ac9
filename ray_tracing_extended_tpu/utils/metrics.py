"""Per-frame render metrics: structured JSONL observability.

The reference exposes only three inspector counters (numRenderedFrames /
numMeshChunks / numTriangles, RayTracingManager.cs:26-28). This framework
emits one JSON object per frame with throughput and convergence stats
(SURVEY.md section 5 'Metrics / logging'): Mrays/s (live segments / wall),
spp/s, rays per path, plus - via the ``extra`` dict filled by
``progressive.render_progressive`` - ``alive_frac`` (live-path fraction per
bounce index, from the renderers' per-bounce counters) and ``accum_var``
(Welford running variance of the accumulated image / n(n-1), the MC
convergence signal).
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class FrameMetrics:
    frame: int
    wall_s: float
    rays: int
    pixels: int
    spp: int
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "frame": self.frame,
            "wall_s": round(self.wall_s, 5),
            # 6 digits: a tiny test frame on a heavily loaded host can
            # legitimately run below 0.001 Mrays/s, and rounding that to
            # 0.0 destroys the "throughput is positive" invariant
            "mrays_per_s": round(self.rays / self.wall_s / 1e6, 6)
            if self.wall_s > 0
            else None,
            "spp_per_s": round(self.spp / self.wall_s, 3)
            if self.wall_s > 0
            else None,
            "rays_per_path": round(self.rays / (self.pixels * self.spp), 4),
        }
        d.update(self.extra)
        return d


class MetricsLogger:
    """Writes one JSON line per frame to a file and/or stdout."""

    def __init__(self, path=None, echo: bool = False):
        self._fh = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.perf_counter()

    def log(self, m: FrameMetrics) -> None:
        line = json.dumps(m.to_dict())
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
