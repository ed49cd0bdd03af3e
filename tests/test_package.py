"""The package imports with only its required dependencies, and its former
name stays an alias of it."""

import os
import subprocess
import sys

import pytest

import stepth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OLD_NAME = "stepth_tpu"  # the package's name before the GPU translation


@pytest.mark.parametrize("name", ["stepth", OLD_NAME])
def test_imports_without_flax_or_pillow(name):
    """flax and Pillow blocked: the package imports, a pyramid model runs,
    and image I/O reports the missing decoder instead of failing at import."""
    code = f"""
import sys
sys.modules["flax"] = None
sys.modules["PIL"] = None
import numpy as np
import {name} as pkg
from {name}.config import MatchConfig, PyramidConfig
from {name}.models import StereoModel
from {name}.core import io
m = StereoModel(backend="hierarchical", match=MatchConfig(num_disparities=16),
                pyramid=PyramidConfig(levels=2, coarsest_disparities=8))
x = np.random.default_rng(0).uniform(0, 255, (32, 128)).astype(np.float32)
assert m(x, x).disparity.shape == (32, 128)
try:
    io.open_rgb("missing.png")
except io.ImageIOError as e:
    assert "PIL" in str(e)
else:
    raise AssertionError("image I/O without Pillow did not raise")
print("ok", pkg.__version__)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == f"ok {stepth.__version__}"


def test_former_name_is_the_same_package():
    import importlib

    with pytest.warns(DeprecationWarning):
        old = importlib.reload(importlib.import_module(OLD_NAME))
    stereo = importlib.import_module(OLD_NAME + ".models.stereo")
    cli = importlib.import_module(OLD_NAME + ".cli")

    from stepth import cli as new_cli
    from stepth.models import StereoModel, stereo as new_stereo

    assert stereo is new_stereo and cli is new_cli
    assert old.DepthFrame is stepth.DepthFrame
    assert importlib.import_module(OLD_NAME + ".models").StereoModel is StereoModel
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(OLD_NAME + ".no_such_module")
