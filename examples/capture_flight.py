"""Capture a scripted camera flight to PPM frames + a final PNG.

Usage:
    python examples/capture_flight.py [scene] [backend] [WxH] [frames]

Scenes: any of swift3drenderer_tpu.models.SCENES, a data.bin path, or an OBJ.
Backends: xla (default; portable), pallas (the tile kernel; needs a GPU), native
(C++ CPU).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swift3drenderer_tpu.app import run_headless
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.utils.databin import load_scene
from swift3drenderer_tpu.utils.objio import load_obj
from swift3drenderer_tpu.utils.ppm import unpack_rgb_words, write_ppm


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "default"
    backend = sys.argv[2] if len(sys.argv) > 2 else "xla"
    wh = sys.argv[3] if len(sys.argv) > 3 else "640x400"
    frames = int(sys.argv[4]) if len(sys.argv) > 4 else 90
    width, height = (int(x) for x in wh.split("x"))
    if name.endswith(".obj"):
        scene = load_obj(name, offset=(0, 0, -8))
    elif os.path.exists(name):
        scene = load_scene(name)
    else:
        scene = SCENES[name](seed=0)
    if frames < 1:
        raise SystemExit("frames must be >= 1")
    third = max(frames // 3, 1)
    # Last leg absorbs the remainder so the script covers exactly `frames`.
    last = max(frames - 2 * third, 0)
    script = f"{third}:w;{third}:w mx2" + (f";{last}:s mx-2" if last else "")
    pixels, stats = run_headless(
        scene, width=width, height=height, frames=frames,
        script=script, backend=backend,
        out_dir="flight_frames", out_every=15)
    write_ppm("flight_final.ppm", unpack_rgb_words(pixels))
    print("wrote flight_frames/ and flight_final.ppm")


if __name__ == "__main__":
    main()
