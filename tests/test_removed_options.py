"""Options of the removed sampler and scheduler variants are refused with a
clear error instead of being ignored; the .unity loader names its optional
dependency."""

import builtins
import json

import pytest

from ray_tracing_extended_tpu.cli import main
from ray_tracing_extended_tpu.utils.config import RenderConfig


@pytest.mark.parametrize(
    "flag",
    [["--adaptive-spp"], ["--fast-scatter"], ["--intersector", "mega"]],
)
def test_cli_removed_flags_rejected(flag, capsys):
    with pytest.raises(SystemExit) as e:
        main(["render", "--scene", "preset:three_sphere", *flag])
    assert e.value.code == 2  # argparse usage error
    err = capsys.readouterr().err
    assert flag[-1] in err


@pytest.mark.parametrize("key", ["adaptiveSpp", "fastScatter"])
def test_json_removed_settings_rejected(tmp_path, key):
    from ray_tracing_extended_tpu.scene.json_scene import load_json_scene

    path = tmp_path / "s.json"
    path.write_text(json.dumps({
        "settings": {"maxBounceCount": 2, key: True},
        "spheres": [{"position": [0, 0, 3], "radius": 1.0}],
    }))
    with pytest.raises(ValueError, match=key):
        load_json_scene(str(path))


@pytest.mark.parametrize(
    "field",
    ["adaptive_spp", "fast_scatter"],
)
def test_render_config_removed_fields(field):
    with pytest.raises(TypeError, match=field):
        RenderConfig(**{field: 1})


def test_render_config_rejects_unknown_intersector():
    with pytest.raises(ValueError, match="intersector"):
        RenderConfig(intersector="mega").validate()


def test_unity_loader_without_yaml_names_the_extra(monkeypatch, tmp_path):
    from ray_tracing_extended_tpu.scene import unity

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ImportError, match="PyYAML"):
        unity._parse_unity_yaml("--- !u!1 &1\nGameObject: {}\n")
