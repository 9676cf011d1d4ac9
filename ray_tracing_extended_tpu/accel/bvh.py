"""LBVH: Morton-sorted binary BVH build (host, NumPy) + masked stack
traversal (device, JAX).

Net-new design vs the reference, whose only acceleration structure is a flat
per-chunk AABB list (MeshSplitter.cs; SURVEY.md section 7 item 7): required
for the ~70k-triangle BASELINE config 4, where an exhaustive (rays x tris)
scan is off the table.

Build (host, at scene-construction time - mirroring the reference's host-side
chunking precedent): primitive centroids are quantized to a 2^10 grid and
interleaved into 30-bit Morton codes; primitives are sorted by code; the tree
is built top-down by splitting each range at the highest differing Morton bit
(median fallback), leaves holding up to ``leaf_width`` primitives. Leaves are
FIXED-WIDTH: unused slots point at the scene's padded never-hit primitive
region, so device traversal tests constant-shape blocks.

Traversal (device): vectorized per-ray stack in a ``lax.while_loop``. Every
iteration pops one node per lane (lanes with empty stacks idle under masks),
slab-tests it against the ray and current best-t, tests ``leaf_width``
primitives when it is a leaf, and pushes surviving children near-child-first.
All memory access is row gathers into the flat node/primitive arrays - a
fixed-shape, masked expression of an inherently divergent algorithm. The pruned
slab test requires ``t_far >= 0 and t_near <= min(t_far, best_t)``, which is
exact for closest-hit: it can only skip nodes that cannot contain a closer
valid (t >= 0) hit.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..models.geometry import BVH, Scene
from ..ops import vecmath as vm
from ..ops.intersect import (
    DET_EPS,
    INF,
    HitRecord,
    _triangle_normal_at,
)

LEAF_WIDTH = 4
STACK_DEPTH = 48  # fits any split-balanced tree of < 2^47 prims


# ------------------------------------------------------------- build -------
def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit integer coords (P, 3) -> 30-bit Morton codes."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (
        (expand(x[:, 0]) << 2) | (expand(x[:, 1]) << 1) | expand(x[:, 2])
    )


def _assert_traversable(left: np.ndarray, right: np.ndarray) -> None:
    """Build-time guard for the fixed traversal stack: the device kernel
    clamps pushes to STACK_DEPTH-1, so a deeper tree would silently drop
    subtrees (missed intersections with no error). Depth can exceed the
    Morton-split bound for long runs of equal codes, so measure the actual
    tree instead of trusting the bound (ADVICE round-1)."""
    n = len(left)
    depth = np.zeros(n, np.int32)
    stack = [0]
    max_depth = 0
    while stack:
        node = stack.pop()
        d = depth[node]
        max_depth = max(max_depth, int(d))
        l, r = int(left[node]), int(right[node])
        if l >= 0:
            depth[l] = d + 1
            stack.append(l)
        if r >= 0:
            depth[r] = d + 1
            stack.append(r)
    # traversal pushes at most one node per level beyond the current one
    if max_depth + 1 > STACK_DEPTH:
        raise ValueError(
            f"LBVH depth {max_depth + 1} exceeds the device traversal "
            f"stack ({STACK_DEPTH}); rebuild with a larger leaf_width or "
            "raise STACK_DEPTH"
        )


def build_lbvh(
    prim_bmin: np.ndarray,
    prim_bmax: np.ndarray,
    sentinel: int,
    leaf_width: int = LEAF_WIDTH,
) -> BVH:
    """Build an LBVH over primitive AABBs.

    sentinel: primitive index used to pad fixed-width leaves; must reference
    a never-hit (padding) primitive in the scene arrays.
    """
    prim_bmin = np.asarray(prim_bmin, np.float32)
    prim_bmax = np.asarray(prim_bmax, np.float32)
    p = prim_bmin.shape[0]
    centroid = (prim_bmin + prim_bmax) * 0.5

    # Native (C++) build path: bit-identical to the NumPy code below,
    # ~100x faster for production-scale meshes (utils/native.py).
    from ..utils.native import lbvh_build as _native_build
    from ..utils.native import morton_codes as _native_codes

    native_codes = _native_codes(centroid)
    if native_codes is not None:
        from ..utils.native import argsort_u64

        order = argsort_u64(native_codes)
        sorted_codes = native_codes[order]
        built = _native_build(
            prim_bmin, prim_bmax, order, sorted_codes, leaf_width, sentinel
        )
        if built is not None:
            nb_min, nb_max, left, right, leaf_row, leaf_prims = built
            _assert_traversable(left, right)
            return BVH(
                bounds_min=jnp.asarray(nb_min),
                bounds_max=jnp.asarray(nb_max),
                left=jnp.asarray(left),
                right=jnp.asarray(right),
                leaf_row=jnp.asarray(leaf_row),
                leaf_prims=jnp.asarray(leaf_prims),
            )

    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    denom = np.where(hi > lo, hi - lo, 1.0)
    scale = np.where(hi > lo, 1023.0 / denom, 0.0)
    q = np.clip(((centroid - lo) * scale), 0, 1023).astype(np.uint32)
    codes = _morton3(q)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    codes = codes[order]

    # Top-down build over the sorted range, splitting at the highest
    # differing Morton bit (median fallback for equal codes).
    bounds_min, bounds_max = [], []
    left, right, leaf_row = [], [], []
    leaf_prims: list[np.ndarray] = []

    def new_node():
        bounds_min.append(None)
        bounds_max.append(None)
        left.append(-1)
        right.append(-1)
        leaf_row.append(-1)
        return len(left) - 1

    def node_bounds(node, s, e):
        idx = order[s:e]
        bounds_min[node] = prim_bmin[idx].min(axis=0)
        bounds_max[node] = prim_bmax[idx].max(axis=0)

    def split_pos(s, e):
        first, last = int(codes[s]), int(codes[e - 1])
        if first == last:
            return (s + e) // 2
        top_bit = 63 - _clz64(first ^ last)
        mask = 1 << top_bit
        # first index in [s, e) whose bit ``top_bit`` is set
        return s + int(np.searchsorted(codes[s:e] & mask, 1))

    # iterative stack to avoid Python recursion limits
    root = new_node()
    work = [(root, 0, p)]
    while work:
        node, s, e = work.pop()
        node_bounds(node, s, e)
        if e - s <= leaf_width:
            row = len(leaf_prims)
            slots = np.full(leaf_width, sentinel, np.int32)
            slots[: e - s] = order[s:e]
            leaf_prims.append(slots)
            leaf_row[node] = row
        else:
            m = split_pos(s, e)
            l_node = new_node()
            r_node = new_node()
            left[node] = l_node
            right[node] = r_node
            # push right first so the left subtree is processed first -
            # node/leaf numbering then matches the native (C++) recursive
            # builder exactly (tests assert bit-identical trees)
            work.append((r_node, m, e))
            work.append((l_node, s, m))

    _assert_traversable(np.array(left, np.int32), np.array(right, np.int32))
    # OOB guard (SURVEY section 5 sanitizer row): every leaf slot the
    # device traversal gathers (closest_hit_bvh's leaf_prims rows) must be
    # a real primitive index or the sentinel padding slot - the device
    # side has no bounds checks, so a builder bug would read garbage rows.
    lp = np.stack(leaf_prims)
    assert lp.min() >= 0 and lp.max() <= sentinel, (
        f"leaf_prims slot out of range [0, {sentinel}]"
    )
    return BVH(
        bounds_min=jnp.asarray(np.stack(bounds_min)),
        bounds_max=jnp.asarray(np.stack(bounds_max)),
        left=jnp.asarray(np.array(left, np.int32)),
        right=jnp.asarray(np.array(right, np.int32)),
        leaf_row=jnp.asarray(np.array(leaf_row, np.int32)),
        leaf_prims=jnp.asarray(np.stack(leaf_prims)),
    )


def _clz64(x: int) -> int:
    return 64 - x.bit_length()


# ---------------------------------------------------------- traversal ------
def _slab(o, d_inv, bmin, bmax):
    """Per-lane slab test -> (t_near, t_far). Shapes (B, 3) -> (B,)."""
    t0 = (bmin - o) * d_inv
    t1 = (bmax - o) * d_inv
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return t_near, t_far


def _sphere_t_one(o, d, scene: Scene, idx):
    """Hit distance for one gathered sphere per lane (RaySphere semantics,
    RayTracing.shader:120-146)."""
    c = scene.spheres.center[idx]
    r = scene.spheres.radius[idx]
    oc = o - c
    b = vm.dot(oc, d)
    cc = vm.dot(oc, oc) - r * r
    disc = b * b - cc
    t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    valid = (disc >= 0.0) & (t >= 0.0) & (r > 0.0)
    return jnp.where(valid, t, INF)


def _triangle_t_one(o, d, scene: Scene, idx):
    """Hit distance for one gathered triangle per lane (RayTriangle
    semantics, RayTracing.shader:150-174)."""
    tris = scene.triangles
    pa = tris.pos_a[idx]
    e_ab = tris.edge_ab[idx]
    e_ac = tris.edge_ac[idx]
    n = tris.n[idx]
    ao = o - pa
    dao = vm.cross(ao, d)
    det = -vm.dot(d, n)
    t_det = vm.dot(ao, n)
    u_det = vm.dot(e_ac, dao)
    v_det = -vm.dot(e_ab, dao)
    w_det = det - u_det - v_det
    hit = (
        (det >= DET_EPS)
        & (t_det >= 0.0)
        & (u_det >= 0.0)
        & (v_det >= 0.0)
        & (w_det >= 0.0)
    )
    t = t_det / jnp.where(det >= DET_EPS, det, jnp.float32(1.0))
    return jnp.where(hit, t, INF)


def _traverse(o, d, bvh: BVH, prim_t_fn, best_t, best_idx):
    """Generic masked stack traversal. prim_t_fn(o, d, idx) -> (B,) t."""
    b = o.shape[0]
    d_inv = 1.0 / d
    leaf_width = bvh.leaf_prims.shape[1]
    n_nodes = bvh.left.shape[0]

    stack = jnp.zeros((b, STACK_DEPTH), jnp.int32)
    # Everyone starts with the root on the stack.
    ptr = jnp.ones((b,), jnp.int32)
    rows = jnp.arange(b)

    def cond(carry):
        _, _, ptr, it = carry
        return jnp.any(ptr > 0) & (it < 4 * n_nodes)

    def body(carry):
        (best_t, best_idx), stack, ptr, it = carry
        has = ptr > 0
        p = jnp.maximum(ptr - 1, 0)
        node = jnp.where(has, stack[rows, p], 0)
        ptr = jnp.where(has, p, ptr)

        t_near, t_far = _slab(
            o, d_inv, bvh.bounds_min[node], bvh.bounds_max[node]
        )
        visit = has & (t_far >= 0.0) & (t_near <= jnp.minimum(t_far, best_t))
        row = bvh.leaf_row[node]
        is_leaf = row >= 0
        do_leaf = visit & is_leaf

        prims = bvh.leaf_prims[jnp.maximum(row, 0)]  # (B, leaf_width)
        for j in range(leaf_width):
            pidx = prims[:, j]
            t_j = prim_t_fn(o, d, pidx)
            better = do_leaf & (t_j < best_t)
            best_t = jnp.where(better, t_j, best_t)
            best_idx = jnp.where(better, pidx, best_idx)

        # Internal: slab-test both children, push survivors far-first.
        do_int = visit & ~is_leaf
        l_node = bvh.left[node]
        r_node = bvh.right[node]
        tn_l, tf_l = _slab(
            o, d_inv, bvh.bounds_min[l_node], bvh.bounds_max[l_node]
        )
        tn_r, tf_r = _slab(
            o, d_inv, bvh.bounds_min[r_node], bvh.bounds_max[r_node]
        )
        hit_l = do_int & (tf_l >= 0.0) & (tn_l <= jnp.minimum(tf_l, best_t))
        hit_r = do_int & (tf_r >= 0.0) & (tn_r <= jnp.minimum(tf_r, best_t))
        both = hit_l & hit_r
        l_is_near = tn_l <= tn_r
        near = jnp.where(l_is_near, l_node, r_node)
        far = jnp.where(l_is_near, r_node, l_node)
        any_push = hit_l | hit_r
        first = jnp.where(both, far, jnp.where(hit_l, l_node, r_node))
        second = near

        stack = stack.at[rows, jnp.minimum(ptr, STACK_DEPTH - 1)].set(
            jnp.where(any_push, first, stack[rows, jnp.minimum(ptr, STACK_DEPTH - 1)])
        )
        p1 = jnp.minimum(ptr + 1, STACK_DEPTH - 1)
        stack = stack.at[rows, p1].set(
            jnp.where(both, second, stack[rows, p1])
        )
        ptr = ptr + any_push.astype(jnp.int32) + both.astype(jnp.int32)
        return (best_t, best_idx), stack, ptr, it + 1

    carry = ((best_t, best_idx), stack, ptr, jnp.int32(0))
    (best_t, best_idx), _, _, _ = lax.while_loop(cond, body, carry)
    return best_t, best_idx


def closest_hit_bvh(o, d, scene: Scene) -> HitRecord:
    """Closest hit using BVHs where present (triangles and/or spheres),
    falling back to the brute-force pairwise scan for the primitive type
    without one. Matches ``closest_hit_bruteforce`` semantics."""
    from ..ops.intersect import ray_spheres_t, ray_triangles_t

    b = o.shape[0]
    best_t = jnp.full((b,), INF)
    # Track (type, idx): encode spheres as idx, triangles as S + idx, like
    # the brute-force concat order (spheres first - preserving the
    # reference's scan-order tie-break).
    s = scene.spheres.count
    best_enc = jnp.zeros((b,), jnp.int32)

    if scene.sphere_bvh is not None:
        t_s, i_s = _traverse(
            o,
            d,
            scene.sphere_bvh,
            lambda o_, d_, idx: _sphere_t_one(o_, d_, scene, idx),
            jnp.full((b,), INF),
            jnp.zeros((b,), jnp.int32),
        )
    else:
        t_all = ray_spheres_t(o, d, scene.spheres)
        i_s = jnp.argmin(t_all, axis=1).astype(jnp.int32)
        t_s = jnp.min(t_all, axis=1)
    better = t_s < best_t
    best_t = jnp.where(better, t_s, best_t)
    best_enc = jnp.where(better, i_s, best_enc)

    if scene.tri_bvh is not None:
        t_t, i_t = _traverse(
            o,
            d,
            scene.tri_bvh,
            lambda o_, d_, idx: _triangle_t_one(o_, d_, scene, idx),
            jnp.full((b,), INF),
            jnp.zeros((b,), jnp.int32),
        )
    else:
        t_all = ray_triangles_t(o, d, scene.triangles)
        i_t = jnp.argmin(t_all, axis=1).astype(jnp.int32)
        t_t = jnp.min(t_all, axis=1)
    # Strict < : spheres win exact ties (reference scan order).
    better = t_t < best_t
    best_t = jnp.where(better, t_t, best_t)
    best_enc = jnp.where(better, s + i_t, best_enc)

    hit = jnp.isfinite(best_t)
    point = o + d * jnp.where(hit, best_t, 0.0)[:, None]
    is_sphere = best_enc < s
    sph_idx = jnp.minimum(best_enc, s - 1)
    tri_idx = jnp.clip(best_enc - s, 0, scene.triangles.count - 1)
    n_sph = vm.normalize(point - scene.spheres.center[sph_idx])
    n_tri = _triangle_normal_at(o, d, scene.triangles, tri_idx)
    normal = jnp.where(is_sphere[:, None], n_sph, n_tri)
    mat_idx = jnp.where(
        is_sphere,
        scene.spheres.mat_idx[sph_idx],
        scene.triangles.mat_idx[tri_idx],
    )
    mat_idx = jnp.where(hit, mat_idx, 0)
    return HitRecord(
        hit=hit, t=best_t, point=point, normal=normal, mat_idx=mat_idx
    )
