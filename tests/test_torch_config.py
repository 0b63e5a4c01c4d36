"""The port's configuration tree against the JAX package's: every
dataclass's fields and defaults equal, a JAX ``AppConfig`` carried across by
``interop.app_config_from_jax_fields``, and the configs exported from the
package root."""
import dataclasses

import pytest

import volumerenderer_tpu.config as JCFG
import volumerenderer_tpu_torch as P
import volumerenderer_tpu_torch.config as TCFG
from volumerenderer_tpu.camera import Camera as JCamera
from volumerenderer_tpu_torch import interop

NAMES = ["RenderConfig", "CodecConfig", "DatasetConfig", "DistributedConfig", "AppConfig"]


def _plain(x):
    """A config as nested dicts, tuples kept, so the two packages compare."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults_equal_jax(name):
    j, t = getattr(JCFG, name), getattr(TCFG, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen
    for a, b in zip(tf, jf):
        assert str(a.type) == str(b.type), a.name
    assert _plain(t()) == _plain(j())


@pytest.mark.parametrize("kwargs", [
    {},
    {"render": {"camera": {"position": (0.1, -0.2, -0.9), "width": 24, "height": 16},
                "render_mode": "isosurface", "max_samples": 48, "use_pallas_kernel": False,
                "iso_value": 0.25, "wrap": "repeat"},
     "codec": {"codec": "hashed", "tolerance": 2, "max_epochs": 1, "cut_depth": 9},
     "dataset": {"source": "rm_bricks", "top_dir": "bricks", "load_grid": (2, 2, 2),
                 "num_bricks": 8, "timestep": 270, "synthetic_dims": (16, 16, 16)},
     "distributed": {"dp": 2, "prefetch_timesteps": 2}, "tree_path": "t.bin"},
])
def test_app_config_from_jax_fields(kwargs):
    def build(mod, camera_cls):
        parts = {}
        for key, cls in (("render", "RenderConfig"), ("codec", "CodecConfig"),
                         ("dataset", "DatasetConfig"), ("distributed", "DistributedConfig")):
            sub = dict(kwargs.get(key, {}))
            if "camera" in sub:
                sub["camera"] = camera_cls(**sub["camera"])
            parts[key] = getattr(mod, cls)(**sub)
        return mod.AppConfig(**parts, **{k: v for k, v in kwargs.items() if k == "tree_path"})

    jax_cfg = build(JCFG, JCamera)
    want = build(TCFG, P.Camera)
    got = interop.app_config_from_jax_fields(**dataclasses.asdict(jax_cfg))
    assert got == want
    assert isinstance(got.render.camera, P.Camera)


def test_app_config_from_jax_fields_rejects_unknown_fields():
    fields = dataclasses.asdict(JCFG.AppConfig())
    fields["render"]["shader"] = "x"
    with pytest.raises(TypeError):
        interop.app_config_from_jax_fields(**fields)


def test_configs_exported_from_package_root():
    for name in NAMES:
        assert getattr(P, name) is getattr(TCFG, name) and name in P.__all__
