"""Pallas tile rasterizer tests (interpret mode on the CPU): binning, pixel
parity with the golden oracle and the XLA backend, winner ids, the depth-tie
rule, band offsets, the platform dispatch and the Triton lowering."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import (
    SCENES,
    clipping_scene,
    default_scene,
    icosahedron_scene,
    stress_scene,
    tetrahedron_scene,
)
from swift3drenderer_tpu.ops import raster_pallas as rp
from swift3drenderer_tpu.ops.binning import SEG_K, bin_segments
from swift3drenderer_tpu.renderer import Renderer, build_setup, scene_to_device

from conftest import pixel_mismatch_fraction

BILINEAR = dataclasses.replace(DEFAULT_CONFIG, sampling="bilinear")


def identity_camera():
    return Camera().update(Input(), force_update=True)


def flight_camera(steps=1, **inp):
    cam = Camera()
    m = cam.update(Input(), force_update=True)
    for _ in range(steps):
        m = cam.update(Input(**inp))
    return m


def _touch_sets(xmin, xmax, ymin, ymax, live, ntx, nty, tile_h, tile_w,
                height):
    """Per-tile sets of the live slots whose bbox touches the tile, and each
    slot's covered tile count (the binner's rule, written out in NumPy)."""
    txmin = np.clip(xmin // tile_w, 0, ntx - 1)
    txmax = np.clip(xmax // tile_w, 0, ntx - 1)
    tymin = np.clip(ymin // tile_h, 0, nty - 1)
    tymax = np.clip(ymax // tile_h, 0, nty - 1)
    vis = live & (ymax >= 0) & (ymin < height)
    area = (txmax - txmin + 1) * (tymax - tymin + 1)
    sets = [{s for s in np.nonzero(vis)[0]
             if txmin[s] <= t % ntx <= txmax[s]
             and tymin[s] <= t // ntx <= tymax[s]}
            for t in range(ntx * nty)]
    return sets, vis, area


def _random_setup(rng, s, w, h):
    xmin = rng.integers(-64, w, s)
    xmax = xmin + rng.integers(0, 300, s)
    ymin = rng.integers(-32, h, s)
    ymax = ymin + rng.integers(0, 90, s)
    live = rng.random(s) < 0.8
    setup = {k: jnp.asarray(v.astype(np.int32)) for k, v in
             dict(xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax).items()}
    setup["live"] = jnp.asarray(live)
    return setup, (xmin, xmax, ymin, ymax, live)


def test_binning_partition_matches_stable_argsort():
    # The segment arrays partition the sorted entries: starts are the running
    # sum of counts, every tile's segment lists each of its small slots
    # exactly once, and no entry past the last segment is reachable.
    rng = np.random.default_rng(42)
    w, h, tile_h, tile_w = 256, 64, 8, 32
    ntx, nty = w // tile_w, h // tile_h
    for _ in range(10):
        setup, (xmin, xmax, ymin, ymax, live) = _random_setup(rng, 48, w, h)
        ids, starts, counts, _, _ = bin_segments(
            setup, width=w, height=h, tile_h=tile_h, tile_w=tile_w)
        ids, starts, counts = map(np.asarray, (ids, starts, counts))
        np.testing.assert_array_equal(
            starts, np.concatenate([[0], np.cumsum(counts)[:-1]]))
        sets, _, area = _touch_sets(xmin, xmax, ymin, ymax, live, ntx, nty,
                                    tile_h, tile_w, h)
        for t in range(ntx * nty):
            seg = ids[starts[t]: starts[t] + counts[t]]
            assert len(seg) == len(set(seg)), t
            assert set(seg) == {s for s in sets[t] if area[s] <= SEG_K}, t


def test_binning_covers_live_triangles():
    # On a real scene every live slot reaches exactly the tiles its bbox
    # touches: through the tile's segment or through the broadband list
    # (whose slots are tested against the tile rectangle in the kernel).
    scene = default_scene(seed=0)
    dev = scene_to_device(scene)
    m = jnp.asarray(identity_camera())
    w, h, tile_h, tile_w = 256, 192, 16, 32
    setup = build_setup(dev, m, width=w, height=h, config=DEFAULT_CONFIG)
    ids, starts, counts, bb, bb_cnt = map(np.asarray, bin_segments(
        setup, width=w, height=h, tile_h=tile_h, tile_w=tile_w))
    live = np.asarray(setup["live"])
    xmin, xmax, ymin, ymax = (np.asarray(setup[k])
                              for k in ("xmin", "xmax", "ymin", "ymax"))
    broadband = set(bb[:int(bb_cnt)])
    ntx = w // tile_w
    for t in range(len(starts)):
        listed = set(ids[starts[t]: starts[t] + counts[t]])
        x0, y0 = (t % ntx) * tile_w, (t // ntx) * tile_h
        reach = listed | {s for s in broadband
                          if xmax[s] >= x0 and xmin[s] < x0 + tile_w
                          and ymax[s] >= y0 and ymin[s] < y0 + tile_h}
        touching = {s for s in np.nonzero(live)[0]
                    if xmin[s] // tile_w <= t % ntx <= xmax[s] // tile_w
                    and ymin[s] // tile_h <= t // ntx <= ymax[s] // tile_h}
        assert reach == touching, t
        assert not listed & set(np.nonzero(~live)[0])


def test_bin_segments_partition_matches_touch_sets():
    # Segment ∪ broadband must equal each tile's exact touching set, with
    # broadband = exactly the slots whose bbox covers more than SEG_K tiles
    # (ascending), on random setups that also reach outside the frame.
    rng = np.random.default_rng(7)
    w, h, tile_h, tile_w = 512, 128, 16, 64
    ntx, nty = w // tile_w, h // tile_h
    for _ in range(10):
        setup, (xmin, xmax, ymin, ymax, live) = _random_setup(rng, 160, w, h)
        ids, starts, counts, bb, bb_cnt = map(np.asarray, bin_segments(
            setup, width=w, height=h, tile_h=tile_h, tile_w=tile_w))
        bb_list = bb[: int(bb_cnt)]
        assert np.all(np.diff(bb_list) > 0) or len(bb_list) <= 1
        sets, vis, area = _touch_sets(xmin, xmax, ymin, ymax, live, ntx,
                                      nty, tile_h, tile_w, h)
        big = set(np.nonzero(vis & (area > SEG_K))[0])
        assert set(bb_list) == big
        for t in range(ntx * nty):
            seg = set(ids[starts[t]: starts[t] + counts[t]])
            assert seg == sets[t] - big, t
            assert (sets[t] & big) <= set(bb_list)


def _replicate_textures(scene, n):
    from swift3drenderer_tpu.models.textures import default_texture_words
    reps = np.concatenate([default_texture_words(2)] * (n // 2))
    big = dataclasses.replace(scene, textures=reps)
    # Spread the textured attributes across ALL n textures, so the fetch
    # addresses every atlas.
    tex = big.attr_tex.copy()
    tri_tex = big.attribute_indices.reshape(-1, 3)
    for t, corners in enumerate(tri_tex):
        for a in corners:
            if tex[a] >= 0:
                tex[a] = t % n
    big.attr_tex = tex
    big.validate()
    return big


def test_pallas_matches_golden_tetrahedron():
    scene = tetrahedron_scene(seed=0)
    m = identity_camera()
    gp, gd = golden_render(scene, m, 320, 240)
    px, depth = Renderer(scene, backend="pallas", interpret=True).render(
        m, 320, 240)
    assert pixel_mismatch_fraction(gp, px, tol=1) < 0.002
    both = (gd > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], gd[both], rtol=2e-3)


def test_pallas_matches_xla():
    # Same formulas and dtype; each program's FMA contraction still perturbs
    # a handful of edge pixels, so allow a tiny mismatch fraction.
    m = identity_camera()
    for name in ("default", "tetrahedron", "icosahedron", "anisotropic",
                 "clipping"):
        scene = SCENES[name](seed=0)
        px_x, d_x = Renderer(scene, backend="xla").render(m, 320, 240)
        px_p, d_p = Renderer(scene, backend="pallas", interpret=True).render(
            m, 320, 240)
        assert pixel_mismatch_fraction(px_p, px_x, tol=1) < 5e-4, name
        both = (d_x > 0) & (d_p > 0)
        np.testing.assert_allclose(d_p[both], d_x[both], rtol=1e-4,
                                   err_msg=name)


def test_pallas_clipping_flight():
    scene = clipping_scene(seed=0)
    cam = Camera()
    r = Renderer(scene, backend="pallas", interpret=True)
    for step in range(8):
        m = cam.update(Input(up=2.0), force_update=(step == 0))
        gp, _ = golden_render(scene, m, 160, 120)
        px, _ = r.render(m, 160, 120)
        assert pixel_mismatch_fraction(gp, px, tol=1) < 0.004, step


def test_pallas_non_tile_aligned_resolution():
    scene = tetrahedron_scene(seed=0)
    m = identity_camera()
    px_x, _ = Renderer(scene, backend="xla").render(m, 123, 97)
    px_p, _ = Renderer(scene, backend="pallas", interpret=True).render(
        m, 123, 97)
    assert pixel_mismatch_fraction(px_p, px_x, tol=1) < 1e-3


def test_pallas_render_batch():
    scene = tetrahedron_scene(seed=0)
    m = identity_camera()
    ms = np.stack([m, m])
    r = Renderer(scene, backend="pallas", interpret=True)
    px, d = r.render_batch(ms, 128, 96)
    assert px.shape == (2, 96, 128)
    single, _ = r.render(m, 128, 96)
    np.testing.assert_array_equal(np.asarray(px[0]), single)


def test_pallas_many_textures_in_kernel():
    scene = _replicate_textures(icosahedron_scene(seed=0), 32)
    m = identity_camera()
    gp, _ = golden_render(scene, m, 128, 96)
    px, _ = Renderer(scene, backend="pallas", interpret=True).render(
        m, 128, 96)
    assert pixel_mismatch_fraction(gp, px, tol=1) < 0.003


# (scene factory, camera, width, height, config, allowed mismatch). Textured
# frames of a few thousand pixels allow 0.4%: golden's NumPy texel addressing
# rounds differently from any device program on a few pixel rows where the
# ripmap level or texel index sits on a boundary (the XLA backend misses the
# same pixels).
_GOLDEN_CASES = {
    "tetrahedron": (lambda: tetrahedron_scene(seed=0), identity_camera,
                    160, 120, DEFAULT_CONFIG, 0.002),
    "default": (lambda: default_scene(seed=0), identity_camera,
                160, 120, DEFAULT_CONFIG, 0.002),
    "icosahedron": (lambda: icosahedron_scene(seed=0), identity_camera,
                    160, 120, DEFAULT_CONFIG, 0.002),
    "anisotropic": (lambda: SCENES["anisotropic"](seed=0), identity_camera,
                    160, 120, DEFAULT_CONFIG, 0.002),
    "clipping_flight": (lambda: clipping_scene(seed=0),
                        lambda: flight_camera(5, up=2.0), 160, 120,
                        DEFAULT_CONFIG, 0.004),
    "odd_123x97": (lambda: default_scene(seed=0), identity_camera,
                   123, 97, DEFAULT_CONFIG, 0.002),
    "frame_1x1": (lambda: default_scene(seed=0), identity_camera,
                  1, 1, DEFAULT_CONFIG, 0.0),
    "frame_2x2": (lambda: default_scene(seed=0), identity_camera,
                  2, 2, DEFAULT_CONFIG, 0.0),
    # Frames a few pixels past whole tiles, seen from a turned camera, put
    # triangle edges across tile borders in both directions.
    "tile_edges": (lambda: default_scene(seed=1),
                   lambda: flight_camera(3, up=1.0, mouse=(9.0, -4.0)),
                   3 * rp.TILE_W + 5, 5 * rp.TILE_H + 3, DEFAULT_CONFIG,
                   0.002),
    "bilinear": (lambda: icosahedron_scene(seed=0), identity_camera,
                 160, 120, BILINEAR, 0.003),
    "bilinear_anisotropic": (lambda: SCENES["anisotropic"](seed=0),
                             identity_camera, 160, 120, BILINEAR, 0.003),
    "textures_100": (
        lambda: _replicate_textures(icosahedron_scene(seed=0), 100),
        identity_camera, 128, 96, DEFAULT_CONFIG, 0.004),
    "stress_840": (lambda: stress_scene(seed=0, objects=840),
                   lambda: flight_camera(2, up=1.0), 128, 96,
                   DEFAULT_CONFIG, 0.004),
}


@pytest.mark.parametrize("case", list(_GOLDEN_CASES))
def test_kernel_matches_golden(case):
    make_scene, camera, w, h, cfg, tol = _GOLDEN_CASES[case]
    scene = make_scene()
    m = camera()
    gp, gd = golden_render(scene, m, w, h, config=cfg)
    px, depth = Renderer(scene, config=cfg, backend="pallas",
                         interpret=True).render(m, w, h)
    assert px.shape == (h, w) and px.dtype == np.uint32
    assert pixel_mismatch_fraction(gp, px, tol=1) <= tol, case
    both = (gd > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], gd[both], rtol=1e-4)


def test_kernel_batch_of_three_matches_golden():
    # B=3 distinct cameras ride the grid's batch axis in one launch.
    scene = default_scene(seed=0)
    cam = Camera()
    ms = [cam.update(Input(up=1.0, mouse=(6.0 * i, 0.0)),
                     force_update=(i == 0)).copy() for i in range(3)]
    px, _ = Renderer(scene, backend="pallas", interpret=True).render_batch(
        np.stack(ms), 96, 64)
    assert px.shape == (3, 64, 96)
    for b, m in enumerate(ms):
        gp, _ = golden_render(scene, m, 96, 64)
        assert pixel_mismatch_fraction(gp, np.asarray(px[b]), tol=1) < 0.004


def test_kernel_bucketed_resize_matches_exact():
    # The bucketed path renders at the bucket extent with the true size
    # traced; the crop must equal the exact-size render and golden.
    scene = default_scene(seed=0)
    m = identity_camera()
    r = Renderer(scene, backend="pallas", interpret=True)
    for w, h in ((150, 101), (230, 171)):
        exact, _ = r.render(m, w, h)
        buck, _ = r.render(m, w, h, bucketed=True)
        np.testing.assert_array_equal(buck, exact)
        gp, _ = golden_render(scene, m, w, h)
        assert pixel_mismatch_fraction(gp, buck, tol=1) < 0.004


def _setup_batch(scene, m, w, h):
    dev = scene_to_device(scene)
    setup = build_setup(dev, jnp.asarray(m, jnp.float32), width=w, height=h,
                        config=DEFAULT_CONFIG)
    return dev, jax.tree.map(lambda a: a[None], setup)


def _raster(setup, dev, w, h, **kw):
    return rp.rasterize(setup, dev["textures"], width=w, height=h,
                        background=DEFAULT_CONFIG.background_packed,
                        interpret=True, **kw)


def test_winner_ids_match_golden_winners():
    # The gid plane names, at every pixel, the slot of greatest 1/z among
    # the slots that cover it (ties to the smaller slot) — computed here by
    # brute force over the setup table in NumPy — and that slot's 1/z is
    # golden's depth.
    scene = default_scene(seed=0)
    m = flight_camera(2, up=1.0, mouse=(4.0, 0.0))
    w, h = 80, 60
    dev, setup = _setup_batch(scene, m, w, h)
    pix, ooz, gid = _raster(setup, dev, w, h, gid_base=0)
    st = {k: np.asarray(v[0]) for k, v in setup.items()}
    py, px = np.mgrid[0:h, 0:w].astype(np.float32)
    best = np.zeros((h, w), np.float32)
    win = np.full((h, w), rp.NO_WINNER, np.int64)
    for s in np.nonzero(st["live"])[0]:
        wgt = [st["w00"][s, k] + px * st["dx"][s, k] + py * st["dy"][s, k]
               for k in range(3)]
        cover = ((wgt[0] >= 0) & (wgt[1] >= 0) & (wgt[2] >= 0)
                 & (px >= st["xmin"][s]) & (px <= st["xmax"][s])
                 & (py >= st["ymin"][s]) & (py <= st["ymax"][s]))
        z = sum(wgt[k] * st["rvz"][s, k] for k in range(3))
        upd = cover & (z > best)
        best = np.where(upd, z, best)
        win = np.where(upd, s, win)
    gid = np.asarray(gid[0])
    assert (gid != rp.NO_WINNER).any()
    assert (gid == win).mean() > 0.998
    _, gd = golden_render(scene, m, w, h)
    np.testing.assert_array_equal(gid != rp.NO_WINNER, gd > 0)
    covered = gd > 0
    np.testing.assert_allclose(np.asarray(ooz[0])[covered], gd[covered],
                               rtol=1e-4)


def test_equal_depth_tie_goes_to_smaller_slot():
    # Two copies of every slot at identical depth; the second copy is
    # recolored. The smaller slot wins everywhere, whether the copies are
    # binned per tile or through the broadband list, so the pixels are those
    # of the first copy.
    scene = default_scene(seed=0)
    m = identity_camera()
    w, h = 96, 64
    dev, setup = _setup_batch(scene, m, w, h)
    s = setup["live"].shape[1]
    recolored = dict(setup, attrp=setup["attrp"] * 0.5)
    doubled = {k: jnp.concatenate([setup[k], recolored[k]], axis=1)
               for k in setup}
    pix1, ooz1 = _raster(setup, dev, w, h)
    pix2, ooz2, gid2 = _raster(doubled, dev, w, h, gid_base=0)
    np.testing.assert_array_equal(np.asarray(pix2), np.asarray(pix1))
    np.testing.assert_array_equal(np.asarray(ooz2), np.asarray(ooz1))
    g = np.asarray(gid2)
    assert (g[g != rp.NO_WINNER] < s).all()


def test_gid_base_offsets_winner_ids():
    scene = stress_scene(seed=1, objects=64)
    m = flight_camera(1, up=1.0)
    w, h = 96, 64
    dev, setup = _setup_batch(scene, m, w, h)
    px0, d0, g0 = _raster(setup, dev, w, h, gid_base=0)
    px7, d7, g7 = _raster(setup, dev, w, h, gid_base=700)
    np.testing.assert_array_equal(np.asarray(px0), np.asarray(px7))
    won = np.asarray(d0) > 0
    assert won.any()
    np.testing.assert_array_equal(np.asarray(g7)[won],
                                  np.asarray(g0)[won] + 700)
    assert (np.asarray(g7)[~won] == rp.NO_WINNER).all()


@pytest.mark.parametrize("y0", [0, 5, rp.TILE_H, 37])
def test_band_offset_renders_rows_of_full_frame(y0):
    # A band of rows [y0, y0 + 24) rendered with the y offset equals the same
    # rows of the full frame, bit for bit (the fb-sharded path's contract).
    scene = default_scene(seed=0)
    m = identity_camera()
    w, h, band = 96, 72, 24
    dev, setup = _setup_batch(scene, m, w, h)
    full_px, full_d = _raster(setup, dev, w, h)
    px, d = _raster(setup, dev, w, band, y_offset=y0)
    np.testing.assert_array_equal(np.asarray(px[0]),
                                  np.asarray(full_px[0, y0: y0 + band]))
    np.testing.assert_array_equal(np.asarray(d[0]),
                                  np.asarray(full_d[0, y0: y0 + band]))


def test_pallas_on_cpu_without_interpret_raises():
    scene = tetrahedron_scene(seed=0)
    with pytest.raises(ValueError, match="'cpu'"):
        Renderer(scene, backend="pallas")
    with pytest.raises(ValueError, match="'cpu'"):
        rp.render_frame_pallas(scene_to_device(scene),
                               jnp.asarray(identity_camera()),
                               width=32, height=32)


def test_sharded_pallas_on_cpu_without_interpret_raises():
    from swift3drenderer_tpu.parallel.sharding import (ShardedRenderer,
                                                       make_mesh)

    with pytest.raises(ValueError, match="interpret=True"):
        ShardedRenderer(tetrahedron_scene(seed=0), mesh=make_mesh(1, 2),
                        backend="pallas")


# (scene factory, width, height, sampling)
_LOWERING_CASES = {
    "default_1080p": (lambda: default_scene(seed=0), 1920, 1080, "nearest"),
    "bilinear_1080p": (lambda: SCENES["anisotropic"](seed=0), 1920, 1080,
                       "bilinear"),
    "stress100k_1080p": (lambda: SCENES["stress100k"](seed=0), 1920, 1080,
                         "nearest"),
    "textures_100": (
        lambda: _replicate_textures(icosahedron_scene(seed=0), 100),
        640, 480, "nearest"),
}


@pytest.mark.parametrize("case", list(_LOWERING_CASES))
def test_frame_lowers_to_one_triton_launch(case):
    # Lowered for CUDA (no card needed), a whole frame holds exactly one
    # Triton kernel: any slot count and any texture count render in one
    # launch, and every operation of the kernel has a Triton lowering.
    make_scene, w, h, sampling = _LOWERING_CASES[case]
    dev = scene_to_device(make_scene())
    cfg = dataclasses.replace(DEFAULT_CONFIG, sampling=sampling)

    def frame(dev, m):
        setup = build_setup(dev, m, width=w, height=h, config=cfg)
        return rp.rasterize(
            jax.tree.map(lambda a: a[None], setup), dev["textures"],
            width=w, height=h, background=cfg.background_packed,
            sampling=sampling, interpret=False)

    m = jnp.asarray(identity_camera(), jnp.float32)
    hlo = jax.jit(frame).trace(dev, m).lower(
        lowering_platforms=("cuda",)).as_text()
    assert hlo.count("__gpu$xla.gpu.triton") == 1
