"""Bilinear sampling option (framework extension; BASELINE config 2 exercises it):
golden/XLA/Pallas agreement, smoothness vs nearest, and sampler unit behavior."""

import dataclasses

import numpy as np

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG, RenderConfig
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import anisotropic_scene, icosahedron_scene
from swift3drenderer_tpu.renderer import Renderer
from swift3drenderer_tpu.utils.ppm import pack_rgb_words
from swift3drenderer_tpu.utils.ripmap import (
    level_offset,
    sample_ripmap,
    sample_ripmap_bilinear,
)

from conftest import pixel_mismatch_fraction

BILINEAR = dataclasses.replace(DEFAULT_CONFIG, sampling="bilinear")


def identity_camera():
    return Camera().update(Input(), force_update=True)


def test_sampler_blends_neighbors():
    # Level-4 block with a step: left half 0, right half 200 in red.
    atlas = np.zeros((512, 512, 3), np.uint8)
    off = level_offset(4)
    atlas[off: off + 4, off: off + 2, 0] = 0
    atlas[off: off + 4, off + 2: off + 4, 0] = 200
    words = pack_rgb_words(atlas)
    lv = np.array([[4.0, 4.0]], np.float32)
    # At u exactly between texels 1 and 2 the blend is 50/50.
    uv = np.array([[0.5, 0.5]], np.float32)  # texel coord 2.0 - 0.5 = 1.5
    rgb = sample_ripmap_bilinear(words, uv, lv)
    assert abs(rgb[0, 0] - 100.0) < 1e-3
    # At a texel center it matches nearest.
    uv_c = np.array([[(0.5 + 1) / 4, (0.5 + 1) / 4]], np.float32)
    near = sample_ripmap(words, uv_c, lv)
    bil = sample_ripmap_bilinear(words, uv_c, lv)
    np.testing.assert_allclose(bil, near, atol=1e-4)


def test_sampler_wraps():
    atlas = np.zeros((512, 512, 3), np.uint8)
    off = level_offset(2)
    atlas[off: off + 2, off, 1] = 100
    atlas[off: off + 2, off + 1, 1] = 200
    words = pack_rgb_words(atlas)
    lv = np.array([[2.0, 2.0]], np.float32)
    # u just below 0 wraps to blend texels 1 and 0.
    rgb = sample_ripmap_bilinear(words, np.array([[0.0, 0.25]], np.float32), lv)
    assert abs(rgb[0, 1] - 150.0) < 1e-3  # midpoint between the two texels


def test_golden_bilinear_smoother_than_nearest():
    scene = anisotropic_scene()
    m = identity_camera()
    near_px, _ = golden_render(scene, m, 160, 120, config=DEFAULT_CONFIG)
    bil_px, _ = golden_render(scene, m, 160, 120, config=BILINEAR)
    assert not np.array_equal(near_px, bil_px)

    def roughness(px):
        rgb = np.stack([(px >> 16) & 255, (px >> 8) & 255, px & 255], -1)
        return np.abs(np.diff(rgb.astype(np.int64), axis=1)).mean()

    assert roughness(bil_px) < roughness(near_px)


def test_backends_match_golden_bilinear():
    scene = icosahedron_scene(seed=0)
    m = identity_camera()
    gp, _ = golden_render(scene, m, 160, 120, config=BILINEAR)
    for backend in ("xla", "pallas"):
        px, _ = Renderer(scene, config=BILINEAR, backend=backend,
                         interpret=(backend == "pallas")).render(m, 160, 120)
        frac = pixel_mismatch_fraction(gp, px, tol=1)
        assert frac < 0.003, (backend, frac)


def test_pallas_bilinear_large_scene():
    # Bilinear on a 1,539-triangle field: most textured floor pixels sit
    # behind per-tile binned objects, so the four-texel fetch runs on
    # winners found through both bin lists.
    from swift3drenderer_tpu.models import stress_scene

    scene = stress_scene(seed=0, objects=128)
    m = identity_camera()
    gp, _ = golden_render(scene, m, 160, 120, config=BILINEAR)
    px, _ = Renderer(scene, config=BILINEAR, backend="pallas",
                     interpret=True).render(m, 160, 120)
    frac = pixel_mismatch_fraction(gp, px, tol=1)
    assert frac < 0.004, frac
