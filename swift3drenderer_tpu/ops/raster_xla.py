"""XLA rasterizer backend: band-looped visibility resolve + deferred shading.

The reference walks each triangle's bbox serially with incremental edge functions
(render/render.swift:320-342). This backend evaluates coverage for *chunks of
triangles at once* over *bands of pixel rows*, resolving the depth test as a
running max over 1/z (exactly the reference's ``oneOverZ > depth`` test with
0-cleared depth, render.swift:323-325), then shades each pixel once from its
winning triangle's setup row — deferred shading, so the expensive lighting and
texture math runs once per pixel instead of once per covered fragment.

Tie behavior matches the sequential reference: strictly-greater depth updates keep
the earliest triangle, and within a chunk ``argmax`` picks the lowest slot id.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from .texture import sample_ripmap, sample_ripmap_bilinear

_SETUP_KEYS = ("live", "w00", "dx", "dy", "rvz", "cvp", "np", "attrp", "tex",
               "is_tex", "tpp", "dzv", "xmin", "xmax", "ymin", "ymax")


def _pad_setup(setup: Dict[str, jnp.ndarray], multiple: int) -> Dict[str, jnp.ndarray]:
    s = setup["live"].shape[0]
    pad = (-s) % multiple
    if pad == 0:
        return setup
    out = {}
    for k in _SETUP_KEYS:
        v = setup[k]
        width = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
        out[k] = jnp.pad(v, width)  # padded slots have live == False
    return out


def _normalize(v: jnp.ndarray) -> jnp.ndarray:
    return v * jax.lax.rsqrt((v * v).sum(axis=-1, keepdims=True))


def shade_pixels(
    win: jnp.ndarray,        # (..., ) int32 winning slot id, -1 = background
    ooz: jnp.ndarray,        # (..., ) float32 winning 1/z
    px: jnp.ndarray,         # (..., ) float32 pixel x index
    py: jnp.ndarray,         # (..., ) float32 pixel y index
    setup: Dict[str, jnp.ndarray],
    textures: jnp.ndarray,
    background: int,
    sampling: str = "nearest",
) -> jnp.ndarray:
    """Deferred shading (render.swift:326-331 + texture path :312-316)."""
    wid = jnp.maximum(win, 0)

    def g(k):
        return setup[k][wid]

    w = g("w00") + px[..., None] * g("dx") + py[..., None] * g("dy")
    wt = w / ooz[..., None]  # perspective-correct weights w / (1/z)

    point = -_normalize((wt[..., None] * g("cvp")).sum(axis=-2))
    normal = _normalize((wt[..., None] * g("np")).sum(axis=-2))
    halfway = _normalize(point + normal)
    shade = (halfway * normal).sum(axis=-1)

    interp = (wt[..., None] * g("attrp")).sum(axis=-2)  # (..., 3)
    mapping = interp[..., :2]
    level = ooz[..., None] / jnp.abs(g("tpp") - mapping * g("dzv"))
    sampler = sample_ripmap_bilinear if sampling == "bilinear" else sample_ripmap
    tex_color = sampler(textures, g("tex"), mapping, level) \
        if textures.shape[0] else jnp.zeros_like(interp)
    color = jnp.where(g("is_tex")[..., None], tex_color, interp)

    shaded = shade[..., None] * color
    packed = (
        (shaded[..., 0].astype(jnp.uint32) << 16)
        | (shaded[..., 1].astype(jnp.uint32) << 8)
        | shaded[..., 2].astype(jnp.uint32)
    )
    return jnp.where(win < 0, jnp.uint32(background), packed)


@partial(jax.jit, static_argnames=("width", "height", "background", "band_rows",
                                   "chunk", "sampling"))
def rasterize(
    setup: Dict[str, jnp.ndarray],
    textures: jnp.ndarray,
    *,
    width: int,
    height: int,
    background: int,
    band_rows: int = 32,
    chunk: int = 16,
    y_offset: jnp.ndarray | int = 0,
    sampling: str = "nearest",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rasterize the setup table; returns (pixels (H, W) uint32, depth (H, W) f32).

    ``height`` rows starting at global row ``y_offset`` are produced — the hook for
    sharding the framebuffer across devices (each device rasterizes its band with
    the full, replicated setup table). Memory is bounded to one
    (chunk, band_rows, W, 3) coverage block at a time.
    """
    setup = _pad_setup(setup, chunk)
    s = setup["live"].shape[0]
    nchunks = s // chunk
    chunked = {k: setup[k].reshape((nchunks, chunk) + setup[k].shape[1:])
               for k in _SETUP_KEYS}
    slot_ids = jnp.arange(s, dtype=jnp.int32).reshape(nchunks, chunk)

    nbands = -(-height // band_rows)
    px = jnp.arange(width, dtype=jnp.float32)[None, :]           # (1, W)
    pxi = jnp.arange(width, dtype=jnp.int32)[None, :]

    y_offset = jnp.asarray(y_offset, jnp.int32)

    def band_fn(b):
        y0 = y_offset + b * band_rows
        py = (y0 + jnp.arange(band_rows, dtype=jnp.int32))[:, None]  # (band, 1)
        pyf = py.astype(jnp.float32)

        def step(carry, ch):
            best, win = carry
            c, ids = ch
            # w[k, j, i, :] = w00 + px * dx + py * dy for triangle k at pixel
            # (i, j + y0); centers are at +0.5, folded into w00 (setup.py).
            w = (c["w00"][:, None, None, :]
                 + px[None, :, :, None] * c["dx"][:, None, None, :]
                 + pyf[None, :, :, None] * c["dy"][:, None, None, :])
            inside = (w >= 0).all(axis=-1)
            in_bbox = (
                (pxi[None] >= c["xmin"][:, None, None])
                & (pxi[None] <= c["xmax"][:, None, None])
                & (py[None] >= c["ymin"][:, None, None])
                & (py[None] <= c["ymax"][:, None, None])
            )
            cover = inside & in_bbox & c["live"][:, None, None]
            ooz = (w * c["rvz"][:, None, None, :]).sum(axis=-1)
            ooz = jnp.where(cover, ooz, 0.0)
            cbest = ooz.max(axis=0)
            cwin = ids[ooz.argmax(axis=0)]
            upd = cbest > best  # strict: earlier triangle wins ties
            return (jnp.where(upd, cbest, best), jnp.where(upd, cwin, win)), None

        # Zero depth = cleared depth buffer (render.swift:244); -1 = no winner.
        # The zero-valued terms derived from setup and y0 give the carry the same
        # varying-axis type as the scan body's output under shard_map (the body
        # depends on both the camera-varying setup and the fb-varying y0).
        vzero_i = setup["xmin"][0] * 0 + (y0 - y0)
        vzero_f = vzero_i.astype(jnp.float32)
        init = (jnp.zeros((band_rows, width), jnp.float32) + vzero_f,
                jnp.full((band_rows, width), -1, jnp.int32) + vzero_i)
        (best, win), _ = jax.lax.scan(step, init, (chunked, slot_ids))
        pixels = shade_pixels(win, best, jnp.broadcast_to(px, best.shape),
                              jnp.broadcast_to(pyf, best.shape), setup, textures,
                              background, sampling=sampling)
        return pixels, best

    pixels, depth = jax.lax.map(band_fn, jnp.arange(nbands))
    pixels = pixels.reshape(nbands * band_rows, width)[:height]
    depth = depth.reshape(nbands * band_rows, width)[:height]
    return pixels, depth
