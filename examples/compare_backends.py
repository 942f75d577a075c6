"""Render the same frame on every backend and report agreement + speed.

Usage: python examples/compare_backends.py [scene] [WxH]

On a CPU the pallas backend runs in the Pallas interpreter (and says so): its
time there is the interpreter's, not the kernel's.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.renderer import Renderer


def mismatch(a, b, tol=1):
    def ch(p):
        p = p.astype(np.int64)
        return np.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], -1)
    return float((np.abs(ch(a) - ch(b)).max(-1) > tol).mean())


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "default"
    wh = sys.argv[2] if len(sys.argv) > 2 else "640x480"
    w, h = (int(x) for x in wh.split("x"))
    scene = SCENES[name](seed=0)
    m = Camera().update(Input(), force_update=True)

    t0 = time.perf_counter()
    golden_px, _ = golden_render(scene, m, w, h)
    print(f"golden (NumPy oracle): {(time.perf_counter() - t0) * 1e3:8.1f} ms")

    interpret = jax.default_backend() == "cpu"
    for backend in ("xla", "pallas", "native"):
        label = backend
        if backend == "pallas" and interpret:
            label = "pallas (interpreter)"
        try:
            r = Renderer(scene, backend=backend,
                         interpret=(backend == "pallas" and interpret))
            r.render(m, w, h)  # warm up / compile
            t0 = time.perf_counter()
            px, _ = r.render(m, w, h)
            dt = (time.perf_counter() - t0) * 1e3
            frac = mismatch(golden_px, px)
            print(f"{label:22s} {dt:8.1f} ms   "
                  f"pixel mismatch vs golden: {frac * 100:.3f}%")
        except Exception as exc:
            print(f"{backend:22s} unavailable: {type(exc).__name__}: {exc}")


if __name__ == "__main__":
    main()
