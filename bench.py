"""Benchmark entry point — prints ONE JSON line with the headline metric.

Headline: frames/sec at 1920x1080 on the full mixed scene, one GPU. Every frame
(a distinct camera pose) is rendered on the device and waited for with
``block_until_ready``; the figure is the median over the frames after a
warm-up that compiles. ``vs_baseline`` is the speedup over the reference C++
-O2 CPU renderer at the same config (tools/cpu_baseline/results.json), where
that config was measured. The output names the device, its kind and its
power limit.

Runs only on a GPU: on any other platform it exits non-zero and prints no
result.

    python bench.py                      # headline
    python bench.py --all-configs        # the scene-family table
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Reference C++ core rows of tools/cpu_baseline/results.json, by config.
_CPU_BASELINE_KEYS = {
    ("tetrahedron", 640, 480): "tetrahedron-640x480",
    ("icosahedron", 1920, 1080): "icosahedron-1920x1080-fly",
    ("anisotropic", 1920, 1080): "anisotropic-1920x1080",
    ("clipping", 1920, 1080): "clipping-1920x1080-fly",
    ("default", 1920, 1080): "full-1920x1080",
    ("default", 3840, 2160): "full-3840x2160",
}

# The --all-configs rows: (scene, width, height, cameras per launch, objects).
# The 4-triangle tetrahedron frame is too small to fill the card alone, so it
# is measured as the serving batch of 8 cameras.
ALL_CONFIGS = [
    ("tetrahedron", 640, 480, 8, None),
    ("icosahedron", 1920, 1080, 1, None),
    ("anisotropic", 1920, 1080, 1, None),
    ("clipping", 1920, 1080, 1, None),
    ("default", 1920, 1080, 1, None),
    ("default", 3840, 2160, 1, None),
    ("stress", 1920, 1080, 1, 840),
    ("stress100k", 1920, 1080, 1, None),
]


def cpu_baseline_fps(scene: str, width: int, height: int):
    key = _CPU_BASELINE_KEYS.get((scene, width, height))
    if key is None:
        return None
    with open(os.path.join(REPO, "tools", "cpu_baseline",
                           "results.json")) as f:
        return json.load(f)[key]["fps"]


def measure(scene_name: str, width: int, height: int, frames: int,
            backend: str, batch: int = 1, objects: int | None = None,
            interpret: bool = False) -> dict:
    """Median wall-clock time per frame over ``frames`` launches of
    ``batch`` cameras each (``utils.profiling.median_ms``: compile and warm
    up first), cycling through ``frames`` distinct camera poses.

    ``interpret`` runs the pallas backend in the interpreter on the CPU (the
    tests' path); main() refuses any platform but the GPU.
    """
    import jax.numpy as jnp

    from swift3drenderer_tpu.camera import Camera, Input
    from swift3drenderer_tpu.models import SCENES
    from swift3drenderer_tpu.renderer import Renderer
    from swift3drenderer_tpu.utils.profiling import median_ms

    scene = SCENES[scene_name](seed=0, **({"objects": objects} if objects
                                          else {}))
    renderer = Renderer(scene, backend=backend, interpret=interpret)
    cam = Camera()
    mats = np.stack([
        cam.update(Input(up=1.0, mouse=(2.0 * i, 0.0)), force_update=(i == 0)).copy()
        for i in range(frames * batch)
    ]).reshape(frames, batch, 3, 4)
    mats = [jnp.asarray(m, jnp.float32) for m in mats]

    if batch > 1:
        def launch(m):
            return renderer.render_batch(m, width, height)
    else:
        def launch(m):
            return renderer.render_device(m[0], width, height)

    poses = itertools.cycle(mats)
    ms = median_ms(lambda: launch(next(poses)), reps=frames) / batch
    return dict(frame_ms=ms, fps=1e3 / ms, tris=scene.num_triangles,
                pixels=width * height, batch=batch)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="default")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--backend", default="pallas")
    p.add_argument("--batch", type=int, default=1,
                   help="serving mode: cameras per launch")
    p.add_argument("--objects", type=int, default=None,
                   help="object count for --scene stress (840 = the 10,083-"
                        "triangle large-scene config)")
    p.add_argument("--all-configs", action="store_true",
                   help="print a table over the scene families instead")
    p.add_argument("--out", default="bench_all_configs.json",
                   help="JSON artifact path for --all-configs results")
    args = p.parse_args(argv)

    import jax

    from swift3drenderer_tpu.utils.compile_cache import enable_compile_cache
    from swift3drenderer_tpu.utils.profiling import (card_power_line,
                                                     device_summary)

    device = device_summary()
    if device["platform"] != "gpu":
        print(f"bench: needs a GPU, found platform {device['platform']!r} "
              f"({jax.devices()[0].device_kind}); no result", file=sys.stderr)
        return 2
    enable_compile_cache()
    device["power"] = card_power_line()

    if args.all_configs:
        rows = []
        for name, w, h, batch, objects in ALL_CONFIGS:
            r = measure(name, w, h, args.frames, args.backend, batch=batch,
                        objects=objects)
            base = cpu_baseline_fps(name, w, h)
            rows.append({
                "config": name, "width": w, "height": h, "batch": batch,
                "frame_ms": r["frame_ms"], "fps": r["fps"],
                "Mpix_per_s": r["pixels"] * r["fps"] / 1e6,
                "Mtri_per_s": r["tris"] * r["fps"] / 1e6,
                "triangles": r["tris"],
                "vs_baseline": r["fps"] / base if base else None,
            })
            note = f"  (B={batch} per launch)" if batch > 1 else ""
            print(f"{name:14s} {w}x{h}: {r['frame_ms']:8.3f} ms  "
                  f"{r['fps']:9.1f} fps  ({r['tris']} tris){note}")
        with open(args.out, "w") as f:
            json.dump({"backend": args.backend, "frames": args.frames,
                       "device": device, "rows": rows}, f, indent=2)
        print(f"wrote {args.out}")
        return 0

    r = measure(args.scene, args.width, args.height, args.frames,
                args.backend, batch=args.batch, objects=args.objects)
    base = cpu_baseline_fps(args.scene, args.width, args.height)
    tag = f" batch={args.batch}" if args.batch > 1 else ""
    print(json.dumps({
        "metric": f"fps@{args.width}x{args.height} {args.scene} scene "
                  f"({args.backend}{tag})",
        "value": r["fps"],
        "unit": "frames/sec",
        "vs_baseline": r["fps"] / base if base else None,
        "device": device,
        "extra": {"frame_ms": r["frame_ms"],
                  "Mpix_per_s": r["pixels"] * r["fps"] / 1e6,
                  "Mtri_per_s": r["tris"] * r["fps"] / 1e6,
                  "triangles": r["tris"],
                  **({"batch": args.batch} if args.batch > 1 else {})},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
