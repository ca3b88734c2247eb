"""Test configuration.

Tests run on the CPU backend with a virtual 8-device mesh so multi-chip
sharding is exercised without several GPUs (the standard JAX pattern;
SURVEY §4 item 4).  Must set flags before JAX initializes.  Tests that
need the GPU take the ``gpu`` fixture (marker ``gpu``): on a machine
with one, ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` runs
them; here they skip.
"""

import os
import pathlib

# CPU unless the caller names platforms (the GPU tests run with
# JAX_PLATFORMS=cuda,cpu); the environment may import jax before this
# file runs, so jax.config.update below is authoritative
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

DEJAVU = str(pathlib.Path(__file__).resolve().parents[1]
             / "data" / "fonts" / "DejaVuSans.ttf")
DEJAVU_SERIF = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"
DEJAVU_MONO = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"


@pytest.fixture(scope="session")
def dejavu():
    from fontrx.font.font import Font

    return Font.open(DEJAVU)


@pytest.fixture(scope="session")
def dejavu_serif():
    from fontrx.font.font import Font

    return Font.open(DEJAVU_SERIF)


@pytest.fixture
def gpu():
    """The first GPU; skips when JAX has none (decided here, at test
    time, never at import: workers must collect the same tests)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/ on a machine with one")
    return devices[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
