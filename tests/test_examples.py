"""Smoke tests: the examples/ scripts must run end-to-end.

The examples are user-facing documentation; these subprocess runs keep them
from bit-rotting as the APIs they demonstrate evolve.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _run(script, args, cwd):
    # Run on the CPU like the rest of the suite; runpy keeps the script's
    # __main__ semantics.
    preamble = (
        "import runpy, sys; sys.argv = sys.argv[1:];"
        "runpy.run_path(sys.argv[0], run_name='__main__')"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-c", preamble, os.path.join(EXAMPLES, script), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_capture_flight(tmp_path):
    res = _run("capture_flight.py", ["tetrahedron", "xla", "192x128", "6"],
               cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "flight_final.ppm").exists()
    assert (tmp_path / "flight_frames").is_dir()


def test_compare_backends(tmp_path):
    res = _run("compare_backends.py", ["tetrahedron", "192x128"], cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    for backend in ("golden", "xla", "pallas", "native"):
        assert backend in out, out
    # Every available backend must agree with the oracle; "unavailable" is
    # tolerated only for native (the .so may not be built in a fresh checkout).
    for line in out.splitlines():
        if "unavailable" in line:
            if not line.startswith("native"):
                pytest.fail(line)
        elif "pixel mismatch vs golden:" in line:
            frac = float(line.rsplit(":", 1)[1].strip().rstrip("%"))
            assert frac < 1.0, line
