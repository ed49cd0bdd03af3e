"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding logic (Mesh / shard_map / halo exchange) is exercised with
XLA's fake-device trick (SURVEY.md §4): 8 host-platform devices in one process.
Must set the flags before jax initializes. The platform is the CPU unless
``JAX_PLATFORMS`` names another: ``JAX_PLATFORMS=cuda python -m pytest tests/
-m gpu`` runs the tests that need a GPU on one.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from stepth.utils import scenes  # noqa: E402


ASSETS = scenes.reference_assets_dir()


def require_assets():
    """Skip the calling test unless the reference's bundled photographs are
    present (``$STEPTH_ASSETS``, else ``assets/`` in the checkout). Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    if not scenes.reference_assets_available():
        pytest.skip(f"reference assets not found in {scenes.reference_assets_dir()}")


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream regardless
    # of which other tests ran (selection/order independence)
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def asset_pair():
    """The reference's bundled 600x400 stereo-ish pair, decoded to RGB arrays."""
    from stepth.core import io

    require_assets()
    assets = scenes.reference_assets_dir()
    main = io.open_rgb(os.path.join(assets, "main.jpg"))
    add = io.open_rgb(os.path.join(assets, "additional.jpg"))
    return main, add


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module. With 220+ tests the
    in-process XLA CPU compiler state grows unboundedly and eventually
    SEGFAULTS compiling a late shard_map program (deterministically in
    test_sgm_sharded::test_warmup_mode_close when the whole suite precedes
    it; the same tests pass in any smaller grouping). Dropping executable
    caches at module boundaries keeps the compiler healthy; re-compiles
    within a module are unaffected."""
    yield
    jax.clear_caches()
