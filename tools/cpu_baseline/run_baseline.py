"""Measure the reference C++ -O2 CPU renderer at the five BASELINE.json configs.

Builds per-config scene data.bin files with the framework's generator (the same
scenes the device bench renders), runs the headless harness, and prints a BASELINE.md
table plus a JSON blob. Run from the repo root:

    python tools/cpu_baseline/run_baseline.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from swift3drenderer_tpu.models import SCENES  # noqa: E402
from swift3drenderer_tpu.utils.databin import dump_scene  # noqa: E402

CONFIGS = [
    # (name, scene, width, height, fly, frames)
    ("tetrahedron-640x480", "tetrahedron", 640, 480, False, 60),
    ("icosahedron-1920x1080-fly", "icosahedron", 1920, 1080, True, 30),
    ("anisotropic-1920x1080", "anisotropic", 1920, 1080, False, 30),
    ("clipping-1920x1080-fly", "clipping", 1920, 1080, True, 30),
    ("full-3840x2160", "default", 3840, 2160, False, 15),
    ("full-1920x1080", "default", 1920, 1080, False, 30),
]


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    harness = os.path.join(here, "build", "cpu_baseline")
    if not os.path.exists(harness):
        subprocess.run([os.path.join(here, "build.sh")], check=True)
    results = {}
    for name, scene_name, w, h, fly, frames in CONFIGS:
        rundir = os.path.join(here, "build", name)
        os.makedirs(rundir, exist_ok=True)
        binpath = os.path.join(rundir, "cpu_baseline")
        shutil.copy2(harness, binpath)
        dump_scene(SCENES[scene_name](seed=0), os.path.join(rundir, "data.bin"))
        cmd = [binpath, str(w), str(h), str(frames)] + (["--fly"] if fly else [])
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        r = json.loads(out.stdout)
        tris = SCENES[scene_name](seed=0).num_triangles
        r["triangles"] = tris
        r["Mpix_per_s"] = round(w * h * r["fps"] / 1e6, 2)
        results[name] = r
        print(f"{name:28s} {r['ms_per_frame']:9.2f} ms  {r['fps']:8.2f} fps  "
              f"{r['Mpix_per_s']:8.1f} Mpix/s  ({tris} tris)")
    out_path = os.path.join(here, "results.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nwrote {out_path}")


if __name__ == "__main__":
    main()
