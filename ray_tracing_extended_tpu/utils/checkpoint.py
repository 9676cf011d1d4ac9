"""Checkpoint / resume for progressive renders.

The reference's only cross-frame state is the accumulated image + frame
counter (RayTracingManager.cs:33,26), never persisted (it resets on Start,
:43-46 - SURVEY.md section 5). Here that state is first-class: the
(accumulation image, frame index, config hash) tuple serializes to a single
.npz, and ``resume`` continues the running average exactly (the weighting
1/(frame+1) of Accumulate.shader:48 makes the average independent of where
it was interrupted).

A config hash guards against resuming with a different scene/camera/config,
which would silently average unrelated images (the reference HAS this bug:
moving the camera keeps averaging into stale history - we refuse instead).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import jax

from .config import RenderConfig


def hash_tree(tree) -> str:
    """Exact byte hash over a pytree's leaves (dtype, shape, raw bytes).

    THE one fingerprint primitive: SceneBuilder.build() applies it to the
    host-side scene (free) and stores the result as scene.content_hash;
    state_hash applies the identical function in its fallback, so the
    two paths produce the SAME digest for the same content. Device-array
    leaves cost one device-to-host copy each - hence the build-time
    precompute."""
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(tree):
        a = np.asarray(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


def state_hash(scene, camera, cfg: RenderConfig) -> str:
    """Stable fingerprint of everything that determines frame content
    (scheme v2, round 2: scene content via hash_tree over the BASE scene
    - BVHs derive deterministically and are excluded -
    plus camera leaves and the config dict; checkpoints written by older
    builds no longer match).

    SceneBuilder.build() precomputes the scene part from host arrays
    (free) as scene.content_hash; a scene that lost the attribute to a
    jax tree transform falls back to the identical hash_tree over its
    (device) leaves - same digest, slower (host pulls)."""
    import dataclasses as _dc

    h = hashlib.sha256()
    h.update(json.dumps(cfg.__dict__, sort_keys=True).encode())
    scene_part = getattr(scene, "content_hash", None)
    if scene_part is None:
        scene_part = hash_tree(
            _dc.replace(scene, tri_bvh=None, sphere_bvh=None)
        )
    h.update(scene_part.encode())
    h.update(hash_tree(camera).encode())
    return h.hexdigest()[:32]


def save(path, accum, frame: int, fingerprint: str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            accum=np.asarray(accum),
            frame=np.int64(frame),
            fingerprint=np.bytes_(fingerprint.encode()),
        )
    tmp.replace(path)  # atomic: a crash never leaves a torn checkpoint


def load(path, fingerprint: str | None = None):
    """Returns (accum (H, W, 3) np.float32, frame int). Raises ValueError on
    fingerprint mismatch (resuming a different render)."""
    with np.load(path) as z:
        accum = z["accum"].astype(np.float32)
        frame = int(z["frame"])
        saved_fp = bytes(z["fingerprint"]).decode()
    if fingerprint is not None and saved_fp != fingerprint:
        raise ValueError(
            "checkpoint fingerprint mismatch: the checkpoint was produced by "
            "a different scene/camera/config (refusing to average unrelated "
            f"renders; saved={saved_fp}, current={fingerprint}). NOTE: the "
            "fingerprint scheme changed in round 2 - checkpoints written by "
            "older builds cannot be resumed even for identical scenes."
        )
    return accum, frame
