"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md section 4: the fake-backend equivalent)."""

import jax
import numpy as np
import pytest

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import default_scene, tetrahedron_scene
from swift3drenderer_tpu.parallel.sharding import ShardedRenderer, make_mesh
from swift3drenderer_tpu.renderer import Renderer

from conftest import pixel_mismatch_fraction


def _cameras(n):
    ms = []
    cam = Camera()
    for i in range(n):
        ms.append(cam.update(Input(right=float(i % 2)), force_update=(i == 0)).copy())
    return np.stack(ms)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_fb_sharded_matches_single_device():
    scene = tetrahedron_scene(seed=0)
    mesh = make_mesh(n_frame=1, n_fb=8)
    sr = ShardedRenderer(scene, mesh=mesh)
    m = _cameras(1)
    px, depth = sr.render_batch(m, 256, 192)
    single_px, single_d = Renderer(scene).render(m[0], 256, 192)
    assert pixel_mismatch_fraction(np.asarray(px[0]), single_px, tol=0) == 0.0
    np.testing.assert_array_equal(np.asarray(depth[0]), single_d)


def test_frame_and_fb_sharded():
    scene = default_scene(seed=0)
    mesh = make_mesh(n_frame=2, n_fb=4)
    sr = ShardedRenderer(scene, mesh=mesh)
    ms = _cameras(4)  # batch 4 over frame axis 2
    px, depth = sr.render_batch(ms, 128, 96)
    assert px.shape == (4, 96, 128)
    # Every frame matches the golden oracle.
    for b in range(4):
        gp, _ = golden_render(scene, ms[b], 128, 96)
        frac = pixel_mismatch_fraction(np.asarray(px[b]), gp, tol=1)
        assert frac < 0.002, (b, frac)


def test_output_sharding_layout():
    scene = tetrahedron_scene(seed=0)
    mesh = make_mesh(n_frame=2, n_fb=4)
    sr = ShardedRenderer(scene, mesh=mesh)
    px, _ = sr.render_batch(_cameras(2), 128, 96)
    # Output is sharded over (frame, fb): each device holds a (1, 24, 128) block.
    shards = px.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape == (1, 24, 128)


def test_indivisible_height_rejected():
    scene = tetrahedron_scene(seed=0)
    sr = ShardedRenderer(scene, mesh=make_mesh(1, 8))
    with pytest.raises(ValueError, match="not divisible"):
        sr.render_batch(_cameras(1), 128, 100)


def test_pallas_backend_sharded_matches_golden():
    # The Pallas tile rasterizer under shard_map (interpret mode on the CPU
    # mesh): fb-sharded output must match the golden oracle.
    scene = tetrahedron_scene(seed=0)
    mesh = make_mesh(n_frame=1, n_fb=4)
    sr = ShardedRenderer(scene, mesh=mesh, backend="pallas",
                         interpret=True)
    m = _cameras(1)
    px, depth = sr.render_batch(m, 256, 192)
    gp, _ = golden_render(scene, m[0], 256, 192)
    assert pixel_mismatch_fraction(np.asarray(px[0]), gp, tol=1) < 0.002


def test_pallas_backend_sharded_multitile_bands():
    # Regression: each fb shard's band spans MULTIPLE kernel tile rows
    # (local_h=512 > tile_h=64) with a nonzero y_offset on the second shard.
    # Binning must be band-relative or shards with y_offset > 0 render
    # background only.
    scene = default_scene(seed=0)
    mesh = make_mesh(n_frame=1, n_fb=2)
    sr = ShardedRenderer(scene, mesh=mesh, backend="pallas",
                         interpret=True)
    m = _cameras(1)
    px, depth = sr.render_batch(m, 256, 1024)
    gp, _ = golden_render(scene, m[0], 256, 1024)
    # Both bands must contain non-background pixels and match golden.
    bg = 0x001E1E1E
    assert (np.asarray(px[0][:512]) != bg).any()
    assert (np.asarray(px[0][512:]) != bg).any()
    assert pixel_mismatch_fraction(np.asarray(px[0]), gp, tol=1) < 0.002


def test_pallas_backend_sharded_segmented_scene():
    # fb-band sharding x per-tile segments: bin_segments must bin on
    # band-relative rows (nonzero y_offset on the second shard), like the
    # regression above — here with the regular floor's many small slots,
    # which bin per tile rather than through the broadband list. The camera
    # pitches down so the floor spans BOTH bands (content rows ~97-231 of
    # 384).
    from swift3drenderer_tpu.camera import Camera, Input
    from swift3drenderer_tpu.models import SCENES

    scene = SCENES["regular_floor"](seed=0)
    cam = Camera()
    cam.update(Input(), force_update=True)
    m = cam.update(Input(mouse=(0.0, -60.0)))
    mesh = make_mesh(n_frame=1, n_fb=2)
    sr = ShardedRenderer(scene, mesh=mesh, backend="pallas",
                         interpret=True)
    px, _ = sr.render_batch(np.asarray(m)[None], 256, 384)
    gp, _ = golden_render(scene, m, 256, 384)
    bg = 0x001E1E1E
    assert (np.asarray(px[0][:192]) != bg).any()
    assert (np.asarray(px[0][192:]) != bg).any()
    assert pixel_mismatch_fraction(np.asarray(px[0]), gp, tol=1) < 0.005


def test_triangle_sharded_matches_single_device():
    # Scene (model) parallelism: slots sharded across 8 devices, frames
    # depth-composited by the (1/z, global-id) merge. Must match the
    # single-device pallas render exactly (tie order included).
    from swift3drenderer_tpu.parallel.sharding import render_scene_sharded

    scene = default_scene(seed=0)
    mesh = make_mesh(n_frame=1, n_fb=8)
    m = _cameras(1)[0]
    import jax.numpy as jnp
    from swift3drenderer_tpu.renderer import scene_to_device
    dev = scene_to_device(scene)
    px, depth = render_scene_sharded(
        dev, jnp.asarray(m, jnp.float32), width=256, height=192, mesh=mesh,
        backend="pallas", interpret=True)
    single_px, single_d = Renderer(scene, backend="pallas",
                                  interpret=True).render(m, 256, 192)
    np.testing.assert_array_equal(np.asarray(px), single_px)
    np.testing.assert_array_equal(np.asarray(depth), single_d)


def test_triangle_sharded_10k_kernel_parity_bit_exact():
    # Kernel parity for the triangle-sharded path: each shard runs the same
    # kernel over its slot slice while writing global winner ids. A
    # 10,083-triangle scene across 4 shards (5,042 slots each) must stay
    # bit-identical to the single-device render — depth plane included.
    import jax.numpy as jnp
    from swift3drenderer_tpu.models import stress_scene
    from swift3drenderer_tpu.parallel.sharding import render_scene_sharded
    from swift3drenderer_tpu.renderer import Renderer, scene_to_device

    scene = stress_scene(seed=0, objects=840)
    assert scene.num_triangles > 10_000
    mesh = make_mesh(n_frame=1, n_fb=4)
    m = _cameras(1)[0]
    dev = scene_to_device(scene)
    px, depth = render_scene_sharded(
        dev, jnp.asarray(m, jnp.float32), width=160, height=120, mesh=mesh,
        backend="pallas", interpret=True)
    single_px, single_d = Renderer(scene, backend="pallas",
                                  interpret=True).render(m, 160, 120)
    np.testing.assert_array_equal(np.asarray(px), single_px)
    np.testing.assert_array_equal(np.asarray(depth), single_d)


def test_triangle_sharded_xla_matches_golden():
    from swift3drenderer_tpu.parallel.sharding import render_scene_sharded

    import jax.numpy as jnp
    from swift3drenderer_tpu.renderer import scene_to_device

    scene = tetrahedron_scene(seed=0)
    mesh = make_mesh(n_frame=2, n_fb=4)  # 2D mesh: rank spans both axes
    m = _cameras(1)[0]
    dev = scene_to_device(scene)
    px, _ = render_scene_sharded(
        dev, jnp.asarray(m, jnp.float32), width=256, height=192, mesh=mesh,
        backend="xla")
    gp, _ = golden_render(scene, m, 256, 192)
    assert pixel_mismatch_fraction(np.asarray(px), gp, tol=1) < 0.002


def test_pallas_backend_sharded_alignment_check():
    scene = tetrahedron_scene(seed=0)
    sr = ShardedRenderer(scene, mesh=make_mesh(1, 4), backend="pallas",
                         interpret=True)
    # The kernel masks nothing by band size: 9-row shards (no tile of any
    # height divides them) render and match golden like aligned ones.
    m = _cameras(1)
    px, _ = sr.render_batch(m, 128, 4 * 9)
    gp, _ = golden_render(scene, m[0], 128, 4 * 9)
    assert pixel_mismatch_fraction(np.asarray(px[0]), gp, tol=1) < 0.002


def test_triangle_sharded_nonpow2_axis_fallback():
    # A 6-device fb axis has no XOR butterfly partners; render_scene_sharded
    # must take the all_gather + serial-scan composite and still match the
    # single-device render exactly.
    from swift3drenderer_tpu.parallel.sharding import render_scene_sharded

    scene = default_scene(seed=0)
    mesh = make_mesh(n_frame=1, n_fb=6)
    m = _cameras(1)[0]
    import jax.numpy as jnp
    from swift3drenderer_tpu.renderer import scene_to_device
    dev = scene_to_device(scene)
    px, depth = render_scene_sharded(
        dev, jnp.asarray(m, jnp.float32), width=256, height=192, mesh=mesh,
        backend="pallas", interpret=True)
    single_px, single_d = Renderer(scene, backend="pallas",
                                  interpret=True).render(m, 256, 192)
    np.testing.assert_array_equal(np.asarray(px), single_px)
    np.testing.assert_array_equal(np.asarray(depth), single_d)
