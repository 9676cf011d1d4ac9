"""chip_smoke.py off the card: it refuses to run without a GPU, selects its
phases as documented, and each phase passes at a tiny size on the CPU (the
card runs them at full size)."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu_devices(smoke, argv, capsys):
    assert smoke.main(argv) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("four_cards", [False, True])
def test_phase_selection(smoke, four_cards):
    phases = smoke.select_phases(four_cards)
    if four_cards:
        assert phases == ("four_cards",)
    else:
        assert phases == ("rtiow", "cornell", "mesh", "cli", "agree")
    for name in phases:
        assert callable(getattr(smoke, f"phase_{name}"))


TINY = {
    "rtiow": dict(width=64, height=36, spp=2, frames=2),
    "cornell": dict(width=32, height=32, frames=2),
    "mesh": dict(width=48, height=27, target_tris=2000),
    "cli": dict(width=32, height=18, frames=1),
    "agree": dict(small=True),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_at_tiny_size(smoke, name, capsys):
    getattr(smoke, f"phase_{name}")(**TINY[name])
    out = capsys.readouterr().out
    assert f"[{name}]" in out


def test_four_cards_phase_at_tiny_size(smoke, capsys):
    smoke.phase_four_cards(
        width=48, height=24, steps=4, devices=jax.devices()[:4]
    )
    out = capsys.readouterr().out
    assert out.count("bit_identical=True") == 4
