"""Ripmap atlas layout and sampler addressing tests (the ``511 & ~(2L-1)`` table,
reference render/render.swift:94-111)."""

import numpy as np

from swift3drenderer_tpu.utils.ppm import pack_rgb_words, unpack_rgb_words
from swift3drenderer_tpu.utils.ripmap import (
    LEVELS,
    build_ripmap_atlas,
    level_offset,
    next_power_of_two,
    sample_ripmap,
)


def test_level_offsets():
    expected = {256: 0, 128: 256, 64: 384, 32: 448, 16: 480, 8: 496, 4: 504,
                2: 508, 1: 510}
    for level, off in expected.items():
        assert level_offset(level) == off
    # Levels pack the 512-texel axis exactly: offset(L) + 2L == 512 for L < 256.
    for level in LEVELS[1:]:
        assert level_offset(level) + 2 * level == 512


def test_next_power_of_two_truncates_first():
    # Reference truncates the float to Int before the bit trick (render.swift:95).
    assert next_power_of_two(1.0) == 1
    assert next_power_of_two(1.9) == 1
    assert next_power_of_two(2.0) == 2
    assert next_power_of_two(3.7) == 4
    assert next_power_of_two(4.999) == 4
    assert next_power_of_two(5.0) == 8
    assert next_power_of_two(256.0) == 256


def test_atlas_blocks_disjoint_and_filled():
    base = np.zeros((256, 256, 3), np.uint8)
    base[:, :, 0] = 200  # constant red
    atlas = build_ripmap_atlas(base)
    # Every level block of a constant image is that constant.
    for ly in LEVELS:
        for lx in LEVELS:
            oy, ox = level_offset(ly), level_offset(lx)
            block = atlas[oy : oy + ly, ox : ox + lx]
            assert np.all(block[:, :, 0] == 200) and np.all(block[:, :, 1:] == 0)


def test_sampler_fetches_expected_level():
    # Mark each level block with a distinct value, then sample at chosen levels.
    atlas = np.zeros((512, 512, 3), np.uint8)
    for ly in LEVELS:
        for lx in LEVELS:
            oy, ox = level_offset(ly), level_offset(lx)
            atlas[oy : oy + ly, ox : ox + lx, 0] = (ly.bit_length() * 16
                                                    + lx.bit_length())
    words = pack_rgb_words(atlas)
    uv = np.array([[0.25, 0.75]], np.float32)
    for lx in (1.0, 2.0, 16.0, 256.0):
        for ly in (1.0, 8.0, 256.0):
            rgb = sample_ripmap(words, uv, np.array([[lx, ly]], np.float32))
            expect = int(ly).bit_length() * 16 + int(lx).bit_length()
            assert rgb[0, 0] == expect, (lx, ly)


def test_sampler_level_clamped():
    atlas = np.zeros((512, 512, 3), np.uint8)
    atlas[510, 510, 1] = 99  # the 1x1 level block
    words = pack_rgb_words(atlas)
    # Level below 1 clamps to 1 -> the 1x1 block regardless of uv.
    rgb = sample_ripmap(words, np.array([[0.9, 0.1]], np.float32),
                        np.array([[0.01, 0.5]], np.float32))
    assert rgb[0, 1] == 99


def test_sampler_negative_uv_wraps_like_reference():
    # fmod keeps the sign; Int() truncates toward zero; +511 & mask wraps into
    # the level block (render.swift:107-108).
    atlas = np.arange(512 * 512 * 3, dtype=np.uint32).reshape(512, 512, 3) % 256
    words = pack_rgb_words(atlas.astype(np.uint8))
    uv = np.array([[-0.3, -1.7]], np.float32)
    lv = np.array([[4.0, 4.0]], np.float32)
    # Manual reference computation: t + (511 & ~(2L-1)) — Swift's & binds at
    # multiplication precedence (render.swift:107, render.cpp:128).
    lp = 4
    tx = int(np.fmod(-0.3, 1.0) * lp)       # toward zero
    ty = int(np.fmod(-1.7, 1.0) * lp)
    x = tx + (511 & ~(2 * lp - 1))
    y = ty + (511 & ~(2 * lp - 1))
    expect = words[y, x]
    got = sample_ripmap(words, uv, lv)
    packed = ((got[..., 0].astype(np.uint32) << 16)
              | (got[..., 1].astype(np.uint32) << 8)
              | got[..., 2].astype(np.uint32))
    assert packed[0] == expect


def test_pack_unpack_words():
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3)).astype(np.uint8)
    assert np.array_equal(unpack_rgb_words(pack_rgb_words(img)), img)


def test_photo_texture_words():
    # Real-imagery atlases: built from sample photographs bundled
    # with installed packages (sklearn/matplotlib) via build_ripmap_atlas —
    # the non-copied analog of the reference's painting scans (README.md:21).
    from swift3drenderer_tpu.models.textures import photo_texture_words
    tw = photo_texture_words(2)
    assert tw.shape == (2, 512, 512) and tw.dtype == np.uint32
    # A photograph's base level has rich content (not a flat fill).
    assert len(np.unique(tw[0, :256, :256])) > 1000
    # The two atlases come from different photographs.
    assert not np.array_equal(tw[0], tw[1])
    # Deterministic across calls (no RNG involved).
    np.testing.assert_array_equal(tw, photo_texture_words(2))
