"""Environment light, checker flag, scatter distribution, accumulate."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import reference_tracer as ref
from ray_tracing_extended_tpu.models.geometry import (
    FLAG_CHECKER,
    Environment,
)
from ray_tracing_extended_tpu.models.scene import Material, _materials_soa
from ray_tracing_extended_tpu.ops import rng
from ray_tracing_extended_tpu.ops.accumulate import accumulate
from ray_tracing_extended_tpu.ops.environment import environment_light
from ray_tracing_extended_tpu.ops.materials import checker_colour, scatter


def _env():
    return Environment(
        enabled=jnp.float32(1.0),
        ground_colour=jnp.asarray([0.35, 0.3, 0.35], jnp.float32),
        sky_colour_horizon=jnp.asarray([1.0, 1.0, 1.0], jnp.float32),
        sky_colour_zenith=jnp.asarray([0.08, 0.37, 0.73], jnp.float32),
        sun_focus=jnp.float32(500.0),
        sun_intensity=jnp.float32(200.0),
        sun_dir=jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
    )


def _ref_env():
    return ref.Env(
        enabled=True,
        ground=np.array([0.35, 0.3, 0.35], np.float32),
        horizon=np.array([1.0, 1.0, 1.0], np.float32),
        zenith=np.array([0.08, 0.37, 0.73], np.float32),
        sun_focus=500.0,
        sun_intensity=200.0,
        sun_dir=np.array([0.0, 1.0, 0.0], np.float32),
    )


def test_environment_matches_scalar_canonical_dirs():
    dirs = np.array(
        [
            [0, 1, 0],  # zenith + full sun
            [0, -1, 0],  # straight down: ground colour
            [1, 0, 0],  # horizon: dir.y = 0 => groundToSkyT = 1 (sun gate on)
            [0.6, 0.8, 0],
            [0.8, -0.005, 0.6],  # in the ground-blend band
            [0.70710678, 0.70710678, 0.0],
        ],
        np.float32,
    )
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    out = np.asarray(environment_light(jnp.asarray(dirs), _env()))
    for i, d in enumerate(dirs):
        expected = ref.environment_light(d, _ref_env())
        assert np.allclose(out[i], expected, rtol=1e-4, atol=1e-5), (
            d, out[i], expected)


def test_environment_disabled_is_black():
    out = np.asarray(
        environment_light(
            jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), Environment.disabled()
        )
    )
    assert (out == 0).all()


def test_sun_only_above_horizon():
    env = _env()
    # slightly below horizon: groundToSkyT < 1 => no sun term
    d = jnp.asarray([[0.0005, -0.001, 0.0]], jnp.float32)
    d = d / jnp.linalg.norm(d)
    below = np.asarray(environment_light(d, env))
    assert below.max() < 2.0  # no 200-strength sun contribution


def test_checker_swap_parity():
    mats = _materials_soa(
        [Material(colour=(1, 0, 0), emission_colour=(0, 0, 1), flag=FLAG_CHECKER)]
    )
    m = mats.take(jnp.zeros(4, jnp.int32))
    pts = jnp.asarray(
        [
            [0.5, 0.0, 0.5],  # floor (0,0): parity equal -> colour
            [1.5, 0.0, 0.5],  # (1,0): swap
            [1.5, 0.0, 1.5],  # (1,1): equal -> colour
            [-0.5, 0.0, 0.5],  # (-1,0): mod2 -> (1,0): swap
        ],
        jnp.float32,
    )
    out = np.asarray(checker_colour(m, pts))
    assert np.allclose(out[0], [1, 0, 0])
    assert np.allclose(out[1], [0, 0, 1])
    assert np.allclose(out[2], [1, 0, 0])
    assert np.allclose(out[3], [0, 0, 1])


def test_diffuse_scatter_is_cosine_weighted():
    n = 8192
    state = jnp.asarray(
        (np.arange(n, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(
            np.uint32
        )
    )
    mats = _materials_soa([Material.lambertian((0.5, 0.5, 0.5))])
    m = mats.take(jnp.zeros(n, jnp.int32))
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (n, 1))
    d_in = jnp.tile(
        jnp.asarray([[0.70710678, -0.70710678, 0.0]], jnp.float32), (n, 1)
    )
    point = jnp.zeros((n, 3), jnp.float32)
    _, _, d_out, is_spec = scatter(state, d_in, point, normal, m)
    d_out = np.asarray(d_out)
    assert np.asarray(is_spec).max() == 0.0  # lottery never fires at p=0
    cos = d_out[:, 1]
    assert (cos > -1e-3).mean() > 0.999  # hemisphere
    # cosine-weighted: E[cos theta] = 2/3
    assert abs(cos.mean() - 2.0 / 3.0) < 0.02


def test_mirror_scatter():
    state = jnp.asarray(np.array([1], np.uint32))
    mats = _materials_soa([Material.metal((1, 1, 1), smoothness=1.0)])
    m = mats.take(jnp.zeros(1, jnp.int32))
    normal = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    d_in = jnp.asarray([[0.70710678, -0.70710678, 0.0]], jnp.float32)
    _, _, d_out, is_spec = scatter(
        state, d_in, jnp.zeros((1, 3), jnp.float32), normal, m
    )
    assert float(is_spec[0]) == 1.0
    assert np.allclose(
        np.asarray(d_out)[0], [0.70710678, 0.70710678, 0.0], atol=1e-5
    )


def test_dielectric_straight_through_and_tir():
    mats = _materials_soa([Material.dielectric(ior=1.5)])
    m = mats.take(jnp.zeros(1, jnp.int32))
    # normal incidence from outside: refracts straight through
    # (Schlick at cos=1 is r0=0.04; pick a state whose first draw > 0.04)
    state = jnp.asarray(np.array([3], np.uint32))
    _, u = rng.random_value(state)
    assert float(u[0]) > 0.04
    normal = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    d_in = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    _, o_out, d_out, _ = scatter(
        state, d_in, jnp.zeros((1, 3), jnp.float32), normal, m
    )
    assert np.allclose(np.asarray(d_out)[0], [0, 0, 1], atol=1e-5)
    # origin nudged along the new direction (self-hit guard)
    assert float(o_out[0, 2]) > 0
    # total internal reflection: inside the glass (travelling -z toward the
    # -z-facing surface means dot(d, normal) > 0 => exiting), grazing angle
    # with eta * sin = 1.5 * 0.9 > 1 => must reflect back inside (+z).
    d_in = jnp.asarray([[0.9, 0.0, -0.43588989]], jnp.float32)
    _, _, d_out, _ = scatter(
        state, d_in, jnp.zeros((1, 3), jnp.float32), normal, m
    )
    d_out = np.asarray(d_out)[0]
    assert d_out[2] > 0 and np.isclose(d_out[0], 0.9, atol=1e-5)


def test_accumulate_running_average_and_clamp():
    rs = np.random.RandomState(0)
    frames = [rs.uniform(0, 2, (4, 4, 3)).astype(np.float32) for _ in range(5)]
    acc = jnp.zeros((4, 4, 3), jnp.float32)
    acc_ref = np.zeros((4, 4, 3), np.float32)
    for i, f in enumerate(frames):
        acc = accumulate(acc, jnp.asarray(f), i, clamp=True)
        acc_ref = ref.accumulate(acc_ref, f, i, clamp=True)
    assert np.allclose(np.asarray(acc), acc_ref, atol=1e-6)
    # HDR mode = exact running mean
    acc = jnp.zeros((4, 4, 3), jnp.float32)
    for i, f in enumerate(frames):
        acc = accumulate(acc, jnp.asarray(f), i, clamp=False)
    assert np.allclose(np.asarray(acc), np.mean(frames, axis=0), atol=1e-5)


@pytest.mark.parametrize("clamp", [False, True])
def test_accumulate_same_bits_fused_with_its_producer(clamp):
    """The fold inside a compiled program, fused with the op that made the
    frame, gives the bits of the eager fold: no product feeds an add, so no
    FMA contraction can move the last bit."""
    rs = np.random.RandomState(1)
    prev = jnp.asarray(rs.uniform(0, 2, (64, 64, 3)).astype(np.float32))
    total = jnp.asarray(rs.uniform(0, 6, (64, 64, 3)).astype(np.float32))
    fused = jax.jit(
        lambda p, t, f: accumulate(p, t / jnp.float32(3.0), f, clamp=clamp)
    )
    for f in range(6):
        cur = jax.jit(lambda t: t / jnp.float32(3.0))(total)
        eager = accumulate(prev, cur, f, clamp=clamp)
        np.testing.assert_array_equal(
            np.asarray(fused(prev, total, jnp.uint32(f))), np.asarray(eager)
        )
