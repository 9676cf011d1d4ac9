"""Scalar NumPy reference path tracer: a direct, independent transcription of
the reference shader's semantics (RayTracing.shader frag/Trace/intersectors
and Accumulate.shader), used as the parity oracle for the JAX renderer.

Deliberately written in the most literal scalar style (per-pixel Python
loops, f32 everywhere, uint32 integer RNG) so it is easy to audit against the
HLSL line by line. Slow - only run on tiny images in tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

F = np.float32
U32 = 0xFFFFFFFF

FLAG_NONE = 0
FLAG_CHECKER = 1
FLAG_INVISIBLE_LIGHT = 2

PI_LOWP = F(3.1415)  # RayTracing.shader:35
PI_BM = F(3.1415926)  # RayTracing.shader:210


# ---------------------------------------------------------------- RNG ------
def next_random(state: int):
    """RayTracing.shader:193-199, pure integer semantics."""
    state = (state * 747796405 + 2891336453) & U32
    shift = ((state >> 28) + 4) & 31
    result = (((state >> shift) ^ state) * 277803737) & U32
    result = ((result >> 22) ^ result) & U32
    return state, result


def random_value(state: int):
    state, r = next_random(state)
    return state, F(r) / F(4294967295.0)


def random_normal(state: int):
    state, r1 = random_value(state)
    state, r2 = random_value(state)
    theta = F(2.0) * PI_BM * r1
    rho = np.sqrt(F(-2.0) * np.log(r2))
    return state, F(rho * np.cos(theta))


def random_direction(state: int):
    state, x = random_normal(state)
    state, y = random_normal(state)
    state, z = random_normal(state)
    v = np.array([x, y, z], F)
    return state, (v / np.sqrt(v @ v)).astype(F)


def random_point_in_circle(state: int):
    state, r1 = random_value(state)
    angle = r1 * F(2.0) * PI_LOWP
    state, r2 = random_value(state)
    rad = np.sqrt(r2)
    return state, np.array([np.cos(angle) * rad, np.sin(angle) * rad], F)


# ------------------------------------------------------------- scene -------
@dataclasses.dataclass
class Mat:
    colour: np.ndarray
    emission_colour: np.ndarray
    specular_colour: np.ndarray
    emission_strength: float
    smoothness: float
    specular_probability: float
    flag: int = FLAG_NONE


@dataclasses.dataclass
class Sph:
    center: np.ndarray
    radius: float
    mat: Mat


@dataclasses.dataclass
class Tri:
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    na: np.ndarray
    nb: np.ndarray
    nc: np.ndarray
    mat: Mat


@dataclasses.dataclass
class Env:
    enabled: bool = False
    ground: np.ndarray = None
    horizon: np.ndarray = None
    zenith: np.ndarray = None
    sun_focus: float = 1.0
    sun_intensity: float = 0.0
    sun_dir: np.ndarray = None


def _norm(v):
    return (v / np.sqrt(F(v @ v))).astype(F)


def _smoothstep(lo, hi, x):
    t = np.clip((x - lo) / (hi - lo), F(0), F(1))
    return F(t * t * (F(3) - F(2) * t))


# --------------------------------------------------------- intersect -------
def ray_sphere(o, d, center, radius):
    """RayTracing.shader:120-146. Returns (hit, dst, point, normal)."""
    oc = (o - center).astype(F)
    a = F(d @ d)
    b = F(2.0) * F(oc @ d)
    c = F(oc @ oc) - F(radius * radius)
    disc = F(b * b - F(4.0) * a * c)
    if disc >= 0:
        dst = F((-b - np.sqrt(disc)) / (F(2.0) * a))
        if dst >= 0:
            p = (o + d * dst).astype(F)
            return True, dst, p, _norm(p - center)
    return False, F(np.inf), None, None


def ray_triangle(o, d, tri: Tri):
    """RayTracing.shader:150-174."""
    e_ab = (tri.b - tri.a).astype(F)
    e_ac = (tri.c - tri.a).astype(F)
    n = np.cross(e_ab, e_ac).astype(F)
    ao = (o - tri.a).astype(F)
    dao = np.cross(ao, d).astype(F)
    det = F(-(d @ n))
    inv_det = F(1.0) / det if det != 0 else F(np.inf)
    dst = F((ao @ n) * inv_det)
    u = F((e_ac @ dao) * inv_det)
    v = F(-(e_ab @ dao) * inv_det)
    w = F(1.0) - u - v
    hit = det >= F(1e-6) and dst >= 0 and u >= 0 and v >= 0 and w >= 0
    if not hit:
        return False, F(np.inf), None, None
    p = (o + d * dst).astype(F)
    normal = _norm(tri.na * w + tri.nb * u + tri.nc * v)
    return True, dst, p, normal


def ray_aabb(o, d, bmin, bmax):
    """RayTracing.shader:177-187."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = F(1.0) / d
        t0 = (bmin - o) * inv
        t1 = (bmax - o) * inv
    tn = np.max(np.minimum(t0, t1))
    tf = np.min(np.maximum(t0, t1))
    return tn <= tf


def calculate_ray_collision(o, d, spheres, tris):
    """RayTracing.shader:256-297 (chunk AABB gate omitted: it is conservative
    and never changes the closest hit; materials are per-triangle here)."""
    best = (False, F(np.inf), None, None, None)
    for s in spheres:
        hit, dst, p, n = ray_sphere(o, d, s.center, s.radius)
        if hit and dst < best[1]:
            best = (True, dst, p, n, s.mat)
    for t in tris:
        hit, dst, p, n = ray_triangle(o, d, t)
        if hit and dst < best[1]:
            best = (True, dst, p, n, t.mat)
    return best


# ------------------------------------------------------------ shading ------
def environment_light(d, env: Env):
    """RayTracing.shader:238-251."""
    if not env.enabled:
        return np.zeros(3, F)
    sky_t = F(_smoothstep(F(0), F(0.4), d[1]) ** F(0.35))
    ground_t = _smoothstep(F(-0.01), F(0), d[1])
    sky = env.horizon + (env.zenith - env.horizon) * sky_t
    sun = F(max(F(0), F(d @ env.sun_dir)) ** env.sun_focus * env.sun_intensity)
    comp = env.ground + (sky - env.ground) * ground_t
    comp = comp + sun * F(1.0 if ground_t >= 1 else 0.0)
    return comp.astype(F)


def trace(o, d, state, spheres, tris, env, max_bounce):
    """RayTracing.shader:300-352."""
    incoming = np.zeros(3, F)
    colour = np.ones(3, F)
    bounce = 0
    while bounce <= max_bounce:
        hit, dst, p, n, mat = calculate_ray_collision(o, d, spheres, tris)
        if hit:
            base = mat.colour.copy()
            if mat.flag == FLAG_CHECKER:
                fx, fz = np.floor(p[0]), np.floor(p[2])
                cx = fx - 2 * np.floor(fx / 2)
                cz = fz - 2 * np.floor(fz / 2)
                base = mat.colour if cx == cz else mat.emission_colour
            elif mat.flag == FLAG_INVISIBLE_LIGHT and bounce == 0:
                o = (p + d * F(0.001)).astype(F)
                bounce += 1
                continue
            state, u_spec = random_value(state)
            is_spec = F(1.0 if mat.specular_probability >= u_spec else 0.0)
            o = p
            state, unit = random_direction(state)
            diffuse = _norm(n + unit)
            specular = (d - F(2.0) * F(d @ n) * n).astype(F)
            d = _norm(diffuse + (specular - diffuse) * F(mat.smoothness * is_spec))
            emitted = mat.emission_colour * F(mat.emission_strength)
            incoming = (incoming + emitted * colour).astype(F)
            colour = (
                colour * (base + (mat.specular_colour - base) * is_spec)
            ).astype(F)
            pmax = F(max(colour[0], max(colour[1], colour[2])))
            state, u_rr = random_value(state)
            if u_rr >= pmax:
                break
            colour = (colour * (F(1.0) / pmax)).astype(F)
        else:
            incoming = (
                incoming + environment_light(d, env) * colour
            ).astype(F)
            break
        bounce += 1
    return state, incoming


def render(
    spheres,
    tris,
    env: Env,
    cam_pos,
    cam_rot,
    fov_y_deg,
    focus_distance,
    defocus_strength,
    diverge_strength,
    width,
    height,
    max_bounce,
    spp,
    frame,
):
    """frag (RayTracing.shader:356-389). Returns (H, W, 3), row 0 = bottom."""
    cam_pos = np.asarray(cam_pos, F)
    cam_rot = np.asarray(cam_rot, F)
    right, up = cam_rot[:, 0], cam_rot[:, 1]
    plane_h = F(focus_distance * np.tan(F(fov_y_deg) * F(np.pi) / F(360.0)) * 2)
    plane_w = F(plane_h * (width / height))
    img = np.zeros((height, width, 3), F)
    for y in range(height):
        for x in range(width):
            pixel_index = y * width + x
            state = (pixel_index + frame * 719393) & U32
            u = F((x + 0.5) / width)
            v = F((y + 0.5) / height)
            local = np.array(
                [(u - F(0.5)) * plane_w, (v - F(0.5)) * plane_h, focus_distance], F
            )
            focus_point = (cam_pos + cam_rot @ local).astype(F)
            total = np.zeros(3, F)
            for _ in range(spp):
                state, dj = random_point_in_circle(state)
                dj = dj * F(defocus_strength / width)
                o = (cam_pos + right * dj[0] + up * dj[1]).astype(F)
                state, jj = random_point_in_circle(state)
                jj = jj * F(diverge_strength / width)
                fp = (focus_point + right * jj[0] + up * jj[1]).astype(F)
                d = _norm(fp - o)
                state, light = trace(
                    o, d, state, spheres, tris, env, max_bounce
                )
                total += light
            img[y, x] = total / F(spp)
    return img


def accumulate(prev, cur, frame, clamp=True):
    """Accumulate.shader:43-53."""
    w = F(1.0) / F(frame + 1)
    out = prev * (F(1) - w) + cur * w
    return np.clip(out, 0, 1) if clamp else out
