"""Bucketed live-resize tests (reference main.swift:101-105,156-165: realloc and
keep rendering at any size every frame; here: compile per geometric resolution
bucket, render padded, crop — a drag-resize sweep compiles log-many times)."""

import numpy as np

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.models import default_scene, tetrahedron_scene
from swift3drenderer_tpu.renderer import Renderer, bucket_dims, _render_frame_bucketed


def test_bucket_dims_monotonic_and_log_many():
    last = 0
    buckets = set()
    for w in range(100, 4000, 10):
        bw, _ = bucket_dims(w, 64)
        assert bw >= w
        assert bw >= last
        last = bw
        buckets.add(bw)
    # Geometric growth: the whole 100..4000 range maps to log-many buckets.
    assert len(buckets) <= 16


def test_bucketed_matches_exact():
    from conftest import pixel_mismatch_fraction

    scene = default_scene(seed=0)
    r = Renderer(scene)
    cam = Camera()
    m = cam.update(Input(), force_update=True)
    for w, h in [(320, 240), (300, 200), (333, 217), (512, 384)]:
        exact_px, exact_d = r.render(m, w, h)
        buck_px, buck_d = r.render(m, w, h, bucketed=True)
        assert buck_px.shape == (h, w)
        # The bucket program is a different XLA compilation; fusion/FMA
        # choices may flip an isolated depth-tie edge pixel — same tolerance
        # class as the pallas<->xla drift.
        assert pixel_mismatch_fraction(buck_px, exact_px, tol=1) < 5e-4
        np.testing.assert_allclose(buck_d, exact_d, rtol=1e-6)


def test_resize_sweep_compiles_log_many():
    scene = tetrahedron_scene(seed=0)
    r = Renderer(scene)
    cam = Camera()
    m = cam.update(Input(), force_update=True)
    start = _render_frame_bucketed._cache_size()
    # 50-step drag-resize sweep: 300x200 -> 790x445.
    for i in range(50):
        w, h = 300 + 10 * i, 200 + 5 * i
        px, _ = r.render(m, w, h, bucketed=True)
        assert px.shape == (h, w)
    compiles = _render_frame_bucketed._cache_size() - start
    assert compiles <= 4, f"resize sweep compiled {compiles} times"


def test_bucketed_pallas_backend():
    scene = tetrahedron_scene(seed=0)
    r = Renderer(scene, backend="pallas", interpret=True)
    cam = Camera()
    m = cam.update(Input(), force_update=True)
    exact_px, _ = r.render(m, 320, 250)
    buck_px, _ = r.render(m, 320, 250, bucketed=True)
    np.testing.assert_array_equal(buck_px, exact_px)
