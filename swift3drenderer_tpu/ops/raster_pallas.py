"""Pallas tile rasterizer for the GPU (Triton route) — the performance backend.

The reference renders each triangle by walking its bbox serially
(render/render.swift:320-342). Here one Triton program owns one
``TILE_H`` x ``TILE_W`` pixel tile of one frame; programs run in any order
and share nothing. Each program:

1. **Visibility** — walks the broadband slots whose bbox touches the tile,
   then the tile's own segment of binned slots (ops/binning.py), with a
   dynamic trip count. A running (best 1/z, winner slot) pair per pixel stays
   in registers. Greater 1/z wins and equal 1/z goes to the smaller slot id:
   the reference's ``oneOverZ > depth`` test with 0-cleared depth and
   earlier-triangle-wins ties (render.swift:323-325), made independent of the
   order in which slots are visited.
2. **Shade** — once per pixel, by gathering the winner's setup row:
   perspective-correct weights, halfway-vector headlight
   (render.swift:326-331) and the flat color or the ripmap coordinates.
3. **Texel fetch** — straight from the ``(NT, 512, 512)`` atlas in device
   memory: one load for nearest, four for bilinear, addressed as in
   ops/texture.py.

Setup tables, bin lists and the atlas stay in device memory (L2 keeps the
hot rows), so any slot count and any texture count render in one launch per
frame. The camera batch is a grid axis; the band row offset ``y0`` is a
traced input for the framebuffer-sharded path. The edge and shade math is
f32 multiply-add with no matrix product.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import DEFAULT_CONFIG, RenderConfig
from .binning import bin_segments
from .texture import ATLAS_EDGE

# Pixel tile of one program and the warps that run it, picked on an H100
# (docs/KERNEL.md). Triton needs power-of-two block shapes.
TILE_H, TILE_W = 16, 32
NUM_WARPS = 4

# Column offsets of the per-slot f32 setup row: barycentric w00/dx/dy, the
# corners' 1/z, the 1/z-premultiplied camera position, normal and attribute
# (corner-major, 3 x 3 each) and the ripmap level constants.
_W00, _DX, _DY, _RVZ = 0, 3, 6, 9
_CVP, _NP, _ATTRP = 12, 21, 30
_TPP, _DZV = 39, 41
_NF = 43
# Columns of the per-slot int32 row: the clamped integer bbox and the texture
# index (-1 for a flat-colored slot).
_XMIN, _XMAX, _YMIN, _YMAX, _TEX = 0, 1, 2, 3, 4
_NI = 5

# Global slot id written where a pixel has no winner: the identity of the
# (max 1/z, min id) composite of the triangle-sharded path.
NO_WINNER = 2 ** 30


def kernel_mode(interpret: bool) -> bool:
    """The one platform dispatch of the pallas backend: returns whether the
    kernel runs in the Pallas interpreter.

    On ``gpu`` the kernel is always compiled through Triton. On ``cpu`` it
    runs in the interpreter only when the caller asks for it with
    ``interpret=True`` (the tests). Anything else raises."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu" and interpret:
        return True
    raise ValueError(
        f"backend='pallas' has no compiled kernel for platform {platform!r}; "
        "it compiles for 'gpu', and runs in the Pallas interpreter on 'cpu' "
        "only with interpret=True")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_setup_tables(setup: Dict[str, jnp.ndarray]):
    """One frame's setup table as row-major (S, 43) f32 and (S, 5) int32."""
    f32 = jnp.concatenate([
        setup["w00"], setup["dx"], setup["dy"], setup["rvz"],
        setup["cvp"].reshape(-1, 9), setup["np"].reshape(-1, 9),
        setup["attrp"].reshape(-1, 9), setup["tpp"], setup["dzv"],
    ], axis=1).astype(jnp.float32)
    i32 = jnp.stack([
        setup["xmin"], setup["xmax"], setup["ymin"], setup["ymax"],
        jnp.where(setup["is_tex"], setup["tex"], -1),
    ], axis=1).astype(jnp.int32)
    return f32, i32


def _pow2_level(lv):
    """Ripmap level: clamp to [1, 256], truncate, round up to a power of two
    (render.swift:95-101)."""
    i = jnp.clip(lv, 1.0, 256.0).astype(jnp.int32) - 1
    i = i | (i >> 1)
    i = i | (i >> 2)
    i = i | (i >> 4)
    return i + 1


def _raster_kernel(*, tile_h: int, tile_w: int, ntx: int, nty: int,
                   slots: int, entries: int, background: int, bilinear: bool,
                   with_gid: bool):
    """Kernel factory. Refs hold whole arrays in device memory, flattened;
    the outputs are this program's (tile_h, tile_w) blocks."""

    def kernel(y0_ref, base_ref, bbn_ref, bb_ref, starts_ref, counts_ref,
               ids_ref, trf_ref, tri_ref, atlas_ref, pix_ref, ooz_ref,
               *gid_ref):
        b = pl.program_id(0)
        ty = pl.program_id(1)
        tx = pl.program_id(2)
        tile = (b * nty + ty) * ntx + tx
        y_top = y0_ref[0] + ty * tile_h          # global row of the tile top
        x_left = tx * tile_w
        pyi = y_top + jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
        pxi = x_left + jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
        pyf = pyi.astype(jnp.float32)
        pxf = pxi.astype(jnp.float32)
        frame = b * slots

        def fval(slot, k):
            return trf_ref[(frame + slot) * _NF + k]

        def ival(slot, k):
            return tri_ref[(frame + slot) * _NI + k]

        # ---- visibility ----
        def visit(slot, carry):
            best, win = carry
            w = [fval(slot, _W00 + k) + pxf * fval(slot, _DX + k)
                 + pyf * fval(slot, _DY + k) for k in range(3)]
            cover = ((w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0)
                     & (pxi >= ival(slot, _XMIN)) & (pxi <= ival(slot, _XMAX))
                     & (pyi >= ival(slot, _YMIN)) & (pyi <= ival(slot, _YMAX)))
            ooz = (w[0] * fval(slot, _RVZ) + w[1] * fval(slot, _RVZ + 1)
                   + w[2] * fval(slot, _RVZ + 2))
            ooz = jnp.where(cover, ooz, 0.0)
            upd = (ooz > best) | ((ooz == best) & (ooz > 0.0) & (slot < win))
            return jnp.where(upd, ooz, best), jnp.where(upd, slot, win)

        def broadband(i, carry):
            slot = bb_ref[frame + i]
            touches = ((ival(slot, _XMAX) >= x_left)
                       & (ival(slot, _XMIN) < x_left + tile_w)
                       & (ival(slot, _YMAX) >= y_top)
                       & (ival(slot, _YMIN) < y_top + tile_h))
            return jax.lax.cond(touches, partial(visit, slot),
                                lambda c: c, carry)

        carry = (jnp.zeros((tile_h, tile_w), jnp.float32),
                 jnp.full((tile_h, tile_w), -1, jnp.int32))
        carry = jax.lax.fori_loop(0, bbn_ref[b], broadband, carry)
        start = starts_ref[tile]
        seg = b * entries + start
        carry = jax.lax.fori_loop(
            0, counts_ref[tile],
            lambda i, c: visit(ids_ref[seg + i], c), carry)
        best, win = carry

        # ---- shade: one gather of the winner's setup row per pixel ----
        has = win >= 0
        wid = jnp.maximum(win, 0)
        rowf = (frame + wid) * _NF
        rowi = (frame + wid) * _NI

        def g(k):
            return plgpu.load(trf_ref.at[rowf + k])

        w = [g(_W00 + k) + pxf * g(_DX + k) + pyf * g(_DY + k)
             for k in range(3)]
        wt = [wk / best for wk in w]         # perspective-correct weights

        def interp3(off):
            return [g(off + c) * wt[0] + g(off + 3 + c) * wt[1]
                    + g(off + 6 + c) * wt[2] for c in range(3)]

        def normalize(v):
            r = jax.lax.rsqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
            return [x * r for x in v]

        point = normalize([-x for x in interp3(_CVP)])
        normal = normalize(interp3(_NP))
        halfway = normalize([p + n for p, n in zip(point, normal)])
        shade = (halfway[0] * normal[0] + halfway[1] * normal[1]
                 + halfway[2] * normal[2])
        color = interp3(_ATTRP)

        # ---- texel fetch from the atlas in device memory ----
        tex = plgpu.load(tri_ref.at[rowi + _TEX])
        textured = has & (tex >= 0)
        u, v = color[0], color[1]
        lu = _pow2_level(best / jnp.abs(g(_TPP) - u * g(_DZV)))
        lv = _pow2_level(best / jnp.abs(g(_TPP + 1) - v * g(_DZV + 1)))
        offx = 511 & ~(2 * lu - 1)
        offy = 511 & ~(2 * lv - 1)
        tex_base = jnp.maximum(tex, 0) * (ATLAS_EDGE * ATLAS_EDGE)

        def fetch(x, y):
            word = plgpu.load(
                atlas_ref.at[jnp.where(textured,
                                       tex_base + y * ATLAS_EDGE + x, 0)],
                mask=textured, other=0)
            return [((word >> sh) & 0xFF).astype(jnp.float32)
                    for sh in (16, 8, 0)]

        if not bilinear:
            # Reference-exact nearest fetch; the clamp keeps uv < 0 inside
            # this texture's 512 x 512 block.
            x = jnp.clip((jnp.fmod(u, 1.0) * lu).astype(jnp.int32) + offx,
                         0, ATLAS_EDGE - 1)
            y = jnp.clip((jnp.fmod(v, 1.0) * lv).astype(jnp.int32) + offy,
                         0, ATLAS_EDGE - 1)
            texel = fetch(x, y)
        else:
            # Bilinear within the level (framework extension): texel centers
            # at integer + 0.5, repeat wrap.
            tu = jnp.mod(u, 1.0) * lu - 0.5
            tv = jnp.mod(v, 1.0) * lv - 0.5
            x0 = jnp.floor(tu).astype(jnp.int32)
            y0 = jnp.floor(tv).astype(jnp.int32)
            fx = tu - x0.astype(jnp.float32)
            fy = tv - y0.astype(jnp.float32)

            def wrap(i, lp, off):
                return jnp.clip(jnp.mod(i, lp) + off, 0, ATLAS_EDGE - 1)

            xa, xb = wrap(x0, lu, offx), wrap(x0 + 1, lu, offx)
            ya, yb = wrap(y0, lv, offy), wrap(y0 + 1, lv, offy)
            c00, c10 = fetch(xa, ya), fetch(xb, ya)
            c01, c11 = fetch(xa, yb), fetch(xb, yb)
            texel = [(1 - fx) * (1 - fy) * c00[c] + fx * (1 - fy) * c10[c]
                     + (1 - fx) * fy * c01[c] + fx * fy * c11[c]
                     for c in range(3)]
        color = [jnp.where(textured, t, c) for t, c in zip(texel, color)]

        # Channels are in [0, 255]; truncation matches the reference's UInt8
        # cast (render.swift:84-87).
        packed = (((shade * color[0]).astype(jnp.int32) << 16)
                  | ((shade * color[1]).astype(jnp.int32) << 8)
                  | (shade * color[2]).astype(jnp.int32))
        pix_ref[...] = jnp.where(has, packed, jnp.int32(background))
        ooz_ref[...] = best
        if with_gid:
            gid_ref[0][...] = jnp.where(has, win + base_ref[0],
                                        jnp.int32(NO_WINNER))

    return kernel


def rasterize(setup: Dict[str, jnp.ndarray], textures: jnp.ndarray, *,
              width: int, height: int, background: int,
              sampling: str = "nearest", y_offset=0, gid_base=None,
              interpret: bool = False):
    """Rasterize a batch of setup tables in ONE kernel launch.

    ``setup`` arrays carry a leading camera-batch axis B. Returns pixels
    (B, H, W) uint32 and depth (B, H, W) f32 — rows ``y_offset ..
    y_offset + height`` of each frame — plus, when ``gid_base`` is given,
    each pixel's winning global slot id ``gid_base + slot`` (``NO_WINNER``
    where there is none). ``interpret`` is the value from ``kernel_mode``.
    """
    tile_h, tile_w = TILE_H, TILE_W
    bsz, s = setup["live"].shape
    ntx, nty = _cdiv(width, tile_w), _cdiv(height, tile_h)
    ids, starts, counts, bb, bb_cnt = jax.vmap(partial(
        bin_segments, width=width, height=height, tile_h=tile_h,
        tile_w=tile_w, y_offset=y_offset))(setup)
    trf, tri = jax.vmap(pack_setup_tables)(setup)
    nt = textures.shape[0]
    atlas = (jax.lax.bitcast_convert_type(textures, jnp.int32).reshape(-1)
             if nt else jnp.zeros((1,), jnp.int32))
    with_gid = gid_base is not None
    y0 = jnp.asarray(y_offset, jnp.int32).reshape(1)
    base = jnp.asarray(0 if gid_base is None else gid_base,
                       jnp.int32).reshape(1)

    out_block = pl.BlockSpec((None, tile_h, tile_w), lambda b, i, j: (b, i, j))
    padded = (bsz, nty * tile_h, ntx * tile_w)
    dtypes = (jnp.int32, jnp.float32) + ((jnp.int32,) if with_gid else ())
    outs = pl.pallas_call(
        _raster_kernel(tile_h=tile_h, tile_w=tile_w, ntx=ntx, nty=nty,
                       slots=s, entries=ids.shape[1], background=background,
                       bilinear=(sampling == "bilinear"), with_gid=with_gid),
        grid=(bsz, nty, ntx),
        out_specs=[out_block] * len(dtypes),
        out_shape=[jax.ShapeDtypeStruct(padded, dt) for dt in dtypes],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="raster_tile",
    )(y0, base, bb_cnt, bb.reshape(-1), starts.reshape(-1),
      counts.reshape(-1), ids.reshape(-1), trf.reshape(-1), tri.reshape(-1),
      atlas)
    outs = [o[:, :height, :width] for o in outs]
    outs[0] = outs[0].astype(jnp.uint32)
    return tuple(outs)


@partial(jax.jit, static_argnames=("width", "height", "config", "interpret"))
def render_frame_pallas(
    dev: Dict[str, jnp.ndarray],
    m: jnp.ndarray,
    *,
    width: int,
    height: int,
    config: RenderConfig = DEFAULT_CONFIG,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full frame: geometry front-end, binning and the tile kernel."""
    from ..renderer import build_setup

    setup = build_setup(dev, m, width=width, height=height, config=config)
    pix, ooz = rasterize(
        jax.tree.map(lambda a: a[None], setup), dev["textures"],
        width=width, height=height, background=config.background_packed,
        sampling=config.sampling, interpret=kernel_mode(interpret))
    return pix[0], ooz[0]


@partial(jax.jit, static_argnames=("width", "height", "config", "interpret"))
def render_batch_pallas(
    dev: Dict[str, jnp.ndarray],
    ms: jnp.ndarray,  # (B, 3, 4) camera batch
    *,
    width: int,
    height: int,
    config: RenderConfig = DEFAULT_CONFIG,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """A camera batch in ONE kernel launch: the batch is a grid axis."""
    from ..renderer import build_setup

    setup = jax.vmap(lambda m: build_setup(
        dev, m, width=width, height=height, config=config))(ms)
    return rasterize(
        setup, dev["textures"], width=width, height=height,
        background=config.background_packed, sampling=config.sampling,
        interpret=kernel_mode(interpret))
