"""Randomized differential fuzzing: random seeded scenes and random camera poses,
golden oracle vs device (XLA) and native backends. Catches numerics drift the
hand-picked configs miss."""

import numpy as np
import pytest

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.renderer import Renderer

from conftest import pixel_mismatch_fraction


def random_pose(rng):
    cam = Camera()
    cam.update(Input(), force_update=True)
    for _ in range(rng.integers(1, 6)):
        cam.update(Input(
            up=float(rng.uniform(0, 2)), down=float(rng.uniform(0, 1)),
            left=float(rng.uniform(0, 1)), right=float(rng.uniform(0, 1)),
            mouse=(float(rng.uniform(-120, 120)), float(rng.uniform(-80, 80))),
        ))
    return cam.matrix


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_golden_vs_device(trial):
    rng = np.random.default_rng(1000 + trial)
    name = list(SCENES)[int(rng.integers(0, len(SCENES)))]
    scene = SCENES[name](seed=int(rng.integers(0, 100)))
    m = random_pose(rng)
    w = int(rng.integers(9, 40)) * 8
    h = int(rng.integers(7, 30)) * 8
    gp, gd = golden_render(scene, m, w, h)
    px, d = Renderer(scene).render(m, w, h)
    frac = pixel_mismatch_fraction(gp, px, tol=1)
    assert frac < 0.005, (name, w, h, frac)


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_golden_vs_native(trial):
    native = pytest.importorskip("swift3drenderer_tpu.native")
    if not native.native_available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(2000 + trial)
    name = list(SCENES)[int(rng.integers(0, len(SCENES)))]
    scene = SCENES[name](seed=int(rng.integers(0, 100)))
    m = random_pose(rng)
    gp, _ = golden_render(scene, m, 200, 152)
    px, _ = native.NativeRenderer(scene).render(m, 200, 152)
    frac = pixel_mismatch_fraction(gp, px, tol=1)
    assert frac < 0.005, (name, frac)


@pytest.mark.parametrize("trial", range(2))
def test_fuzz_golden_vs_pallas(trial):
    rng = np.random.default_rng(3000 + trial)
    name = list(SCENES)[int(rng.integers(0, len(SCENES)))]
    scene = SCENES[name](seed=int(rng.integers(0, 100)))
    m = random_pose(rng)
    gp, _ = golden_render(scene, m, 160, 96)
    px, _ = Renderer(scene, backend="pallas", interpret=True).render(
        m, 160, 96)
    frac = pixel_mismatch_fraction(gp, px, tol=1)
    assert frac < 0.005, (name, frac)


@pytest.mark.parametrize("trial", range(2))
def test_fuzz_golden_vs_pallas_segmented(trial):
    # Pinned to the 1,850-triangle regular floor so the per-tile segments
    # of the binner (many small slots, few broadband ones) get fuzzed at
    # random poses — the generic pallas fuzz above can land on scenes of a
    # few large triangles that all go through the broadband list.
    rng = np.random.default_rng(6000 + trial)
    scene = SCENES["regular_floor"](seed=int(rng.integers(0, 100)))
    m = random_pose(rng)
    gp, _ = golden_render(scene, m, 160, 96)
    px, _ = Renderer(scene, backend="pallas", interpret=True).render(
        m, 160, 96)
    frac = pixel_mismatch_fraction(gp, px, tol=1)
    assert frac < 0.005, frac


@pytest.mark.parametrize("trial", range(2))
def test_fuzz_bucketed_matches_exact(trial):
    # Bucketed live-resize path at random non-bucket sizes.
    rng = np.random.default_rng(4000 + trial)
    name = list(SCENES)[int(rng.integers(0, len(SCENES)))]
    scene = SCENES[name](seed=int(rng.integers(0, 100)))
    m = random_pose(rng)
    w = int(rng.integers(130, 400))
    h = int(rng.integers(70, 300))
    r = Renderer(scene)
    exact, _ = r.render(m, w, h)
    buck, _ = r.render(m, w, h, bucketed=True)
    assert buck.shape == (h, w)
    frac = pixel_mismatch_fraction(exact, buck, tol=1)
    assert frac < 5e-4, (name, w, h, frac)


def test_fuzz_batch_matches_singles():
    # Batched kernel grid: every frame of a random camera batch must equal
    # its single-frame render bit-for-bit (same program structure per frame).
    rng = np.random.default_rng(5000)
    scene = SCENES["default"](seed=3)
    ms = np.stack([random_pose(rng) for _ in range(3)])
    r = Renderer(scene, backend="pallas", interpret=True)
    batch_px, batch_d = r.render_batch(ms, 160, 96)
    for b in range(3):
        px, d = r.render(ms[b], 160, 96)
        np.testing.assert_array_equal(np.asarray(batch_px[b]), px)
        np.testing.assert_array_equal(np.asarray(batch_d[b]), d)


def test_batch_matches_singles_segmented():
    # Batch of a scene whose slots mostly bin per tile (the regular floor).
    # Winners must be bit-identical to single-frame renders; the DEPTH plane
    # is only ULP-bounded: the batch compiles a different front-end program
    # (vmapped transforms), and XLA's FMA-contraction choices may differ
    # between the two programs — the same drift class as pallas-vs-xla.
    rng = np.random.default_rng(5100)
    scene = SCENES["regular_floor"](seed=0)
    ms = np.stack([random_pose(rng) for _ in range(2)])
    r = Renderer(scene, backend="pallas", interpret=True)
    batch_px, batch_d = r.render_batch(ms, 160, 96)
    for b in range(2):
        px, d = r.render(ms[b], 160, 96)
        np.testing.assert_array_equal(np.asarray(batch_px[b]), px)
        np.testing.assert_allclose(np.asarray(batch_d[b]), d, rtol=2e-5)
