"""Smoke run of the renderer on an NVIDIA GPU through its normal entry points.

    python chip_smoke.py                # one GPU: phases 0-4
    python chip_smoke.py --four-cards   # the multi-device paths on four GPUs

Phases (one process holds the card; each phase prints one line per item):

0. the device: the card's name and power limit, and JAX's device;
1. every scene family at the bench sizes through ``Renderer(backend="pallas")``
   with the kernel compiled (never interpreted): pixel mismatch against the
   golden NumPy oracle and against the plain XLA path on the same card, depth
   agreement, and kernel and XLA milliseconds per frame;
2. serving: a ``render_batch`` of 8 cameras equals 8 single renders;
3. the app: ``FrameLoop`` on the clipping scene for 30 frames of a flight
   script with one bucketed resize and no fallback backend;
4. the ``gpu``-marked tests, run by pytest in this process.

With ``--four-cards`` only the multi-device phase runs: the camera batch over
(1, 4) and (2, 2) meshes and the triangle-sharded composite over four cards,
each compared with one card's render.

Off the GPU, or when any check fails, it exits non-zero and prints no result.
The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Allowed share of pixels off by more than 1 in any channel, against golden
# and against the XLA path on the same card.
PIXEL_TOL = 0.002
# Depth (1/z) on pixels both renders cover, relative. The closed-form edge
# functions w00 + px*dx + py*dy cancel: for small, distant triangles w00 is
# thousands of times the result, so the card's fused multiply-adds (in the
# XLA front-end and in the kernel alike) and golden's unfused NumPy differ by
# up to ulp(w00)/w — a few 1e-4 at the 10k-triangle stress field. The share
# of pixels past 1e-6 is printed beside the check. Against the XLA path on
# the same card the depth is expected to agree to 1e-6.
GOLDEN_DEPTH_RTOL = 1e-3
XLA_DEPTH_RTOL = 1e-6


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def flight_matrix(steps: int, **inp) -> np.ndarray:
    from swift3drenderer_tpu.camera import Camera, Input

    cam = Camera()
    m = cam.update(Input(), force_update=True)
    for _ in range(steps):
        m = cam.update(Input(**inp))
    return m


def depth_stats(depth, ref):
    both = (ref > 0) & (depth > 0)
    rel = np.abs(depth[both] - ref[both]) / ref[both]
    if rel.size == 0:
        return 0.0, 0.0
    return float(rel.max()), float((rel > 1e-6).mean())


# name, scene, scene kwargs, width, height, cameras per launch, sampling,
# golden size (None = the frame size), flight steps and input.
FAMILIES = [
    ("tetrahedron", "tetrahedron", {}, 640, 480, 8, "nearest", None,
     (1, dict(up=1.0))),
    ("icosahedron", "icosahedron", {}, 1920, 1080, 1, "nearest", None,
     (3, dict(up=1.0, mouse=(4.0, 0.0)))),
    ("icosahedron-bilinear", "icosahedron", {}, 1920, 1080, 1, "bilinear",
     None, (3, dict(up=1.0, mouse=(4.0, 0.0)))),
    ("anisotropic", "anisotropic", {}, 1920, 1080, 1, "nearest", None,
     (0, {})),
    ("clipping", "clipping", {}, 1920, 1080, 1, "nearest", None,
     (6, dict(up=2.0))),
    ("default", "default", {}, 1920, 1080, 1, "nearest", None,
     (2, dict(up=1.0, mouse=(2.0, 0.0)))),
    ("default-4k", "default", {}, 3840, 2160, 1, "nearest", None,
     (2, dict(up=1.0, mouse=(2.0, 0.0)))),
    ("stress", "stress", {"objects": 840}, 1920, 1080, 1, "nearest", None,
     (2, dict(up=1.0))),
    ("stress100k", "stress100k", {}, 1920, 1080, 1, "nearest", (320, 240),
     (2, dict(up=1.0))),
]


def phase_families(scenes_cache: dict) -> None:
    from swift3drenderer_tpu.config import DEFAULT_CONFIG
    from swift3drenderer_tpu.golden import render_frame as golden_render
    from swift3drenderer_tpu.models import SCENES
    from swift3drenderer_tpu.ops.raster_pallas import kernel_mode
    from swift3drenderer_tpu.renderer import Renderer
    from swift3drenderer_tpu.utils.compare import pixel_mismatch_fraction
    from swift3drenderer_tpu.utils.profiling import median_ms

    for (name, scene_name, kw, w, h, batch, sampling, gsize,
         (steps, inp)) in FAMILIES:
        cfg = dataclasses.replace(DEFAULT_CONFIG, sampling=sampling)
        key = (scene_name, tuple(sorted(kw.items())))
        if key not in scenes_cache:
            scenes_cache[key] = SCENES[scene_name](seed=0, **kw)
        scene = scenes_cache[key]
        kern = Renderer(scene, config=cfg, backend="pallas")
        check(kernel_mode(kern.interpret) is False,
              f"{name}: the kernel would run in the interpreter")
        xla = Renderer(scene, config=cfg, backend="xla")
        m0 = flight_matrix(steps, **inp)
        if batch > 1:
            ms = np.stack([flight_matrix(steps + i, **inp)
                           for i in range(batch)])
            px, d = (np.asarray(a) for a in kern.render_batch(ms, w, h))
            xpx, xd = (np.asarray(a) for a in xla.render_batch(ms, w, h))
            golden = [golden_render(scene, ms[b], w, h, config=cfg)
                      for b in range(batch)]
            gmis = max(pixel_mismatch_fraction(g[0], px[b])
                       for b, g in enumerate(golden))
            drel = [depth_stats(d[b], g[1]) for b, g in enumerate(golden)]
            dmax, dshare = max(r[0] for r in drel), max(r[1] for r in drel)
            xmis = max(pixel_mismatch_fraction(xpx[b], px[b])
                       for b in range(batch))
            xdmax = max(depth_stats(d[b], xd[b])[0] for b in range(batch))
            k_ms = median_ms(lambda: kern.render_batch(ms, w, h)) / batch
            x_ms = median_ms(lambda: xla.render_batch(ms, w, h),
                             reps=5) / batch
        else:
            px, d = kern.render(m0, w, h)
            xpx, xd = xla.render(m0, w, h)
            gw, gh = gsize or (w, h)
            gp, gd = golden_render(scene, m0, gw, gh, config=cfg)
            if gsize:
                spx, sd = kern.render(m0, gw, gh)
            else:
                spx, sd = px, d
            gmis = pixel_mismatch_fraction(gp, spx)
            dmax, dshare = depth_stats(sd, gd)
            xmis = pixel_mismatch_fraction(xpx, px)
            xdmax = depth_stats(d, xd)[0]
            k_ms = median_ms(lambda: kern.render_device(m0, w, h))
            heavy = scene.num_triangles > 1000
            x_ms = median_ms(lambda: xla.render_device(m0, w, h),
                             reps=3 if heavy else 5)
        golden_at = f"{gsize[0]}x{gsize[1]}" if gsize else f"{w}x{h}"
        print(f"family {name} {w}x{h} B={batch} tris={scene.num_triangles} "
              f"golden@{golden_at}_mismatch={gmis:.6f} "
              f"xla_mismatch={xmis:.6f} depth_max_rel={dmax:.3e} "
              f"depth_share_gt_1e-6={dshare:.6f} xla_depth_max_rel="
              f"{xdmax:.3e} kernel_ms={k_ms:.4f} xla_ms={x_ms:.4f}",
              flush=True)
        check(gmis <= PIXEL_TOL, f"{name}: golden mismatch {gmis}")
        check(xmis <= PIXEL_TOL, f"{name}: XLA mismatch {xmis}")
        check(dmax <= GOLDEN_DEPTH_RTOL, f"{name}: depth differs from golden")
        check(xdmax <= XLA_DEPTH_RTOL, f"{name}: depth differs from XLA")


def phase_resize(scenes_cache: dict) -> None:
    from swift3drenderer_tpu.golden import render_frame as golden_render
    from swift3drenderer_tpu.models import SCENES
    from swift3drenderer_tpu.renderer import Renderer, _render_frame_bucketed
    from swift3drenderer_tpu.utils.compare import pixel_mismatch_fraction
    from swift3drenderer_tpu.utils.profiling import median_ms

    scene = scenes_cache.setdefault(("default", ()), SCENES["default"](seed=0))
    r = Renderer(scene, backend="pallas")
    m = flight_matrix(2, up=1.0, mouse=(2.0, 0.0))
    start = _render_frame_bucketed._cache_size()
    for w, h in ((1000, 600), (1090, 613), (1366, 768)):
        px, _ = r.render(m, w, h, bucketed=True)
        exact, _ = r.render(m, w, h)
        gp, _ = golden_render(scene, m, w, h)
        gmis = pixel_mismatch_fraction(gp, px)
        b_ms = median_ms(lambda: r.render(m, w, h, bucketed=True), reps=5)
        print(f"family resize {w}x{h} bucketed golden_mismatch={gmis:.6f} "
              f"equal_to_exact={bool(np.array_equal(px, exact))} "
              f"host_ms_with_readback={b_ms:.4f}", flush=True)
        check(np.array_equal(px, exact), f"resize {w}x{h}: bucket != exact")
        check(gmis <= PIXEL_TOL, f"resize {w}x{h}: golden mismatch {gmis}")
    compiles = _render_frame_bucketed._cache_size() - start
    print(f"resize compiles={compiles}", flush=True)


def phase_serving(scenes_cache: dict) -> None:
    from swift3drenderer_tpu.models import SCENES
    from swift3drenderer_tpu.renderer import Renderer

    scene = scenes_cache.setdefault(("default", ()), SCENES["default"](seed=0))
    r = Renderer(scene, backend="pallas")
    ms = np.stack([flight_matrix(1 + i, up=1.0, mouse=(3.0, 0.0))
                   for i in range(8)])
    bpx, bd = (np.asarray(a) for a in r.render_batch(ms, 1920, 1080))
    same_px = same_d = True
    for b in range(8):
        px, d = r.render(ms[b], 1920, 1080)
        same_px &= bool(np.array_equal(bpx[b], px))
        same_d &= bool(np.array_equal(bd[b], d))
    print(f"serving render_batch B=8 1920x1080 equals_singles pixels={same_px} "
          f"depth={same_d}", flush=True)
    check(same_px and same_d, "render_batch differs from single renders")


def phase_app() -> None:
    from swift3drenderer_tpu.app import FrameLoop, scripted_inputs
    from swift3drenderer_tpu.camera import Camera
    from swift3drenderer_tpu.golden import render_frame as golden_render
    from swift3drenderer_tpu.models import SCENES
    from swift3drenderer_tpu.utils.compare import pixel_mismatch_fraction

    scene = SCENES["clipping"](seed=0)
    loop = FrameLoop(scene, 1280, 720, backend="pallas", bucketed=True)
    check(loop.fallback_backend is None, "FrameLoop has a fallback backend")
    inputs = list(scripted_inputs("15:w;15:w+mx2", 30))
    cam = Camera()
    for i, inp in enumerate(inputs):
        if i == 15:
            loop.resize(1100, 620)
        px = loop.step(inp)
        m = cam.update(inp, force_update=(i == 0))
        check(px.shape == (loop.height, loop.width), "FrameLoop frame shape")
    gp, _ = golden_render(scene, m, loop.width, loop.height)
    gmis = pixel_mismatch_fraction(gp, px)
    print(f"app FrameLoop clipping frames={loop.frame_index} bucketed=True "
          f"resized_to={loop.width}x{loop.height} failed_over="
          f"{loop.failed_over} backend={loop.renderer.backend} "
          f"last_frame_golden_mismatch={gmis:.6f}", flush=True)
    check(loop.frame_index == 30 and not loop.failed_over
          and loop.renderer.backend == "pallas", "FrameLoop run")
    check(gmis <= PIXEL_TOL, f"FrameLoop last frame golden mismatch {gmis}")


def phase_card_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    print(f"card tests pytest exit={int(rc)}", flush=True)
    check(int(rc) == 0, "gpu-marked tests failed")


def phase_four_cards() -> None:
    import jax

    from swift3drenderer_tpu.models import SCENES
    from swift3drenderer_tpu.parallel.sharding import (ShardedRenderer,
                                                       make_mesh,
                                                       render_scene_sharded)
    from swift3drenderer_tpu.renderer import Renderer
    from swift3drenderer_tpu.utils.compare import pixel_mismatch_fraction
    from swift3drenderer_tpu.utils.profiling import median_ms

    check(len(jax.devices()) >= 4, "--four-cards needs four GPUs")
    scene = SCENES["default"](seed=0)
    ms = np.stack([flight_matrix(1 + i, up=1.0, mouse=(3.0, 0.0))
                   for i in range(8)])
    one = Renderer(scene, backend="pallas")
    spx, sd = (np.asarray(a) for a in one.render_batch(ms, 1920, 1080))
    one_ms = median_ms(lambda: one.render_batch(ms, 1920, 1080), reps=5)
    print(f"four-cards one-card render_batch B=8 1920x1080 on "
          f"{one.dev['vert_c'].devices()} ms={one_ms:.4f}", flush=True)
    for shape in ((1, 4), (2, 2)):
        sr = ShardedRenderer(scene, mesh=make_mesh(*shape), backend="pallas")
        px, d = sr.render_batch(ms, 1920, 1080)
        where_in = sorted(dv.id for dv in sr.dev["vert_c"].devices())
        where_out = sorted((s.device.id, str(s.index)) for s in
                           px.addressable_shards)
        mis = max(pixel_mismatch_fraction(np.asarray(px)[b], spx[b])
                  for b in range(8))
        exact = bool(np.array_equal(np.asarray(px), spx)
                     and np.array_equal(np.asarray(d), sd))
        t_ms = median_ms(lambda: sr.render_batch(ms, 1920, 1080), reps=5)
        print(f"four-cards render_batch_sharded mesh(frame,fb)={shape} B=8 "
              f"1920x1080 scene_on_devices={where_in} output_shards="
              f"{where_out} bit_exact={exact} mismatch={mis:.6f} "
              f"ms={t_ms:.4f}", flush=True)
        check(mis <= PIXEL_TOL, f"render_batch_sharded {shape}: {mis}")

    big = SCENES["stress100k"](seed=0)
    m = flight_matrix(2, up=1.0)
    single = Renderer(big, backend="pallas")
    px1, d1 = single.render(m, 1920, 1080)
    s1_ms = median_ms(lambda: single.render_device(m, 1920, 1080), reps=5)
    mesh = make_mesh(1, 4)
    sr = ShardedRenderer(big, mesh=mesh, backend="pallas")

    def composite():
        return render_scene_sharded(sr.dev, jax.numpy.asarray(m, "float32"),
                                    width=1920, height=1080, mesh=mesh)

    px4, d4 = composite()
    exact = bool(np.array_equal(np.asarray(px4), px1)
                 and np.array_equal(np.asarray(d4), d1))
    t_ms = median_ms(composite, reps=5)
    print(f"four-cards render_scene_sharded stress100k 1920x1080 mesh=(1,4) "
          f"butterfly composite output_sharding={px4.sharding} "
          f"bit_exact_with_one_card={exact} ms={t_ms:.4f} "
          f"one_card_ms={s1_ms:.4f}", flush=True)
    check(exact, "triangle-sharded composite is not bit-exact")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device phase, on four GPUs")
    args = p.parse_args(argv)

    import jax

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found platform "
              f"{dev0.platform!r} ({dev0.device_kind}); no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from swift3drenderer_tpu.utils.compile_cache import enable_compile_cache
    from swift3drenderer_tpu.utils.profiling import (card_power_line,
                                                     device_summary)

    enable_compile_cache()
    print(card_power_line(), flush=True)
    device = device_summary()
    print(f"device platform={device['platform']} kind={device['kind']} "
          f"count={device['count']}", flush=True)
    try:
        if args.four_cards:
            phase_four_cards()
        else:
            scenes: dict = {}
            phase_families(scenes)
            phase_resize(scenes)
            phase_serving(scenes)
            phase_app()
            phase_card_tests()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
