"""Test configuration.

Tests run on CPU with an 8-device virtual topology so multi-device sharding paths
are exercised without a multi-GPU host (the moral equivalent of the
fake-backend testing the reference lacks — SURVEY.md section 4). The platform
must be chosen before JAX is imported; when JAX is already running (chip_smoke.py
runs the ``gpu``-marked tests in its own process, on the card), it is left as it
is.
"""

import os
import sys

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from swift3drenderer_tpu.utils.compare import (  # noqa: E402,F401
    pixel_mismatch_fraction,
)

# -- quick tier ---------------------------------------------------------------
# `pytest -m quick` runs a <60 s core-parity subset (unit math, IO round-trips,
# app shell, golden-oracle spot checks) so kernel iteration doesn't pay the
# full suite's ~9 min. The full suite (ci.sh) stays the merge gate.
_QUICK_MODULES = {
    "test_camera", "test_databin", "test_ripmap", "test_native",
    "test_joystick", "test_app", "test_golden",
}
# Individually fast core-parity tests from otherwise-slow modules.
_QUICK_TESTS = {
    "test_tetrahedron_fixed_camera",            # device-vs-golden render
    "test_depth_is_one_over_z",
    "test_binning_partition_matches_stable_argsort",
    "test_bin_segments_partition_matches_touch_sets",
}
# Slow outliers inside quick modules.
_SLOW_TESTS = {
    "test_clip_prepass_matches_golden_on_random_triangles",  # ~18 s
}


def pytest_collection_modifyitems(items):
    for item in items:
        name = item.name.split("[")[0]
        module = item.module.__name__.rsplit(".", 1)[-1]
        if name in _SLOW_TESTS:
            continue
        if module in _QUICK_MODULES or name in _QUICK_TESTS:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session", autouse=True)
def build_native():
    """Build libs3dnative.so once per session, before ANY test runs.

    test_app's elastic-fallback test (and anything else touching the native
    backend) runs alphabetically before test_native; on a fresh tree the
    library doesn't exist yet and those tests would fail on ordering alone.
    A no-op rebuild costs ~50 ms. On machines without the C toolchain the
    build failure is recorded instead of hard-failing the whole session:
    only tests that actually load the native library skip (via the
    ``native_lib`` fixture); the rest of the suite still runs."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        subprocess.run(["make", "-C", os.path.join(repo, "native")],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        _NATIVE_BUILD_ERROR.append(
            f"native build failed: {e} {detail.decode(errors='replace')[-500:]}")


_NATIVE_BUILD_ERROR: list = []


@pytest.fixture()
def gpu():
    """Skip the requesting test unless JAX runs on a GPU (the ``gpu`` marker's
    tests: kernels compiled for the card, which has no CPU interpreter)."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {jax.default_backend()!r}")


@pytest.fixture()
def native_lib():
    """Skip the requesting test when libs3dnative.so could not be built."""
    if _NATIVE_BUILD_ERROR:
        pytest.skip(_NATIVE_BUILD_ERROR[0])

