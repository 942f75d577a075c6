"""Tests that only the card can run: the tile kernel compiled through Triton
for the GPU, which has no CPU interpreter path. They skip elsewhere and run on
the card from chip_smoke.py (phase 4), in the process that holds the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import default_scene
from swift3drenderer_tpu.ops import raster_pallas as rp
from swift3drenderer_tpu.renderer import Renderer, scene_to_device

from conftest import pixel_mismatch_fraction
from test_pallas import _GOLDEN_CASES, _setup_batch, identity_camera

pytestmark = pytest.mark.gpu


def test_kernel_is_compiled_on_gpu(gpu):
    assert rp.kernel_mode(True) is False
    dev = scene_to_device(default_scene(seed=0))
    hlo = rp.render_frame_pallas.lower(
        dev, jnp.asarray(identity_camera()), width=64, height=32).as_text()
    assert hlo.count("__gpu$xla.gpu.triton") == 1


@pytest.mark.parametrize("case", ["clipping_flight", "odd_123x97",
                                  "frame_1x1", "tile_edges", "bilinear",
                                  "textures_100", "stress_840"])
def test_compiled_kernel_matches_golden(gpu, case):
    make_scene, camera, w, h, cfg, tol = _GOLDEN_CASES[case]
    scene = make_scene()
    m = camera()
    gp, gd = golden_render(scene, m, w, h, config=cfg)
    px, depth = Renderer(scene, config=cfg, backend="pallas").render(m, w, h)
    assert pixel_mismatch_fraction(gp, px, tol=1) <= tol, case
    both = (gd > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], gd[both], rtol=1e-4)


def test_compiled_tie_band_and_gid(gpu):
    # The depth-tie rule, the band offset and the gid base on the card: a
    # doubled slot table keeps the first copy's pixels, a band equals the
    # full frame's rows bit for bit, and gid_base shifts the winner ids.
    scene = default_scene(seed=0)
    w, h = 200, 120
    dev, setup = _setup_batch(scene, identity_camera(), w, h)
    bg = 0x1E1E1E

    def raster(st, **kw):
        return rp.rasterize(st, dev["textures"], width=w, height=kw.pop(
            "height", h), background=bg, **kw)

    pix, ooz, gid = raster(setup, gid_base=0)
    doubled = {k: jnp.concatenate(
        [setup[k], setup[k] * 0.5 if k == "attrp" else setup[k]], axis=1)
        for k in setup}
    pix2, _, gid2 = raster(doubled, gid_base=0)
    np.testing.assert_array_equal(np.asarray(pix2), np.asarray(pix))
    g2 = np.asarray(gid2)
    assert (g2[g2 != rp.NO_WINNER] < setup["live"].shape[1]).all()
    band_px, band_d = raster(setup, height=40, y_offset=37)
    np.testing.assert_array_equal(np.asarray(band_px[0]),
                                  np.asarray(pix[0, 37:77]))
    np.testing.assert_array_equal(np.asarray(band_d[0]),
                                  np.asarray(ooz[0, 37:77]))
    _, _, gid7 = raster(setup, gid_base=700)
    won = np.asarray(ooz) > 0
    np.testing.assert_array_equal(np.asarray(gid7)[won],
                                  np.asarray(gid)[won] + 700)


def test_compiled_batch_equals_singles(gpu):
    scene = default_scene(seed=0)
    r = Renderer(scene, backend="pallas")
    cam = Camera()
    ms = np.stack([cam.update(Input(up=1.0, mouse=(5.0 * i, 0.0)),
                              force_update=(i == 0)).copy()
                   for i in range(3)])
    bpx, bd = jax.block_until_ready(r.render_batch(ms, 320, 240))
    for b in range(3):
        px, d = r.render(ms[b], 320, 240)
        np.testing.assert_array_equal(np.asarray(bpx[b]), px)
        np.testing.assert_array_equal(np.asarray(bd[b]), d)
