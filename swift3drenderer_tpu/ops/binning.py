"""Tile binning — which setup slots each framebuffer tile has to test.

The reference walks every triangle's bounding box serially
(render/render.swift:320-342). The tile rasterizer inverts that loop: the
framebuffer is cut into tiles, and this prepass lists, per tile, the slots
whose bounding box touches it. It is plain XLA (one key-value sort), so the
shapes are static and there is no cap on the slot count:

* a slot whose bbox covers at most ``SEG_K`` tiles is expanded into one
  (tile, slot) entry per covered tile; one sort over all K*S entries groups
  them into per-tile *segments*;
* a slot that covers more tiles (floor quads, triangles near the camera)
  goes to one shared *broadband* list that every tile walks, testing the
  slot's bbox against its own rectangle first.

Entries of a segment are in no particular slot order. The kernel's depth
test is order-independent (greater 1/z wins; equal 1/z goes to the smaller
slot id), which is the reference's earlier-triangle-wins rule
(render.swift:323-325) restated so that any visiting order gives the same
winner.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

# Bbox cells a slot may cover and still be binned per tile; larger slots go to
# the broadband list. Picked on an H100 with the 16 x 32 tile (docs/KERNEL.md).
SEG_K = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bin_segments(setup: Dict[str, jnp.ndarray], *, width: int, height: int,
                 tile_h: int, tile_w: int, y_offset: jnp.ndarray | int = 0,
                 ) -> Tuple[jnp.ndarray, ...]:
    """Bin one frame's setup table into ``tile_h`` x ``tile_w`` tiles.

    ``y_offset`` is the first framebuffer row of this band (nonzero when the
    framebuffer is split into row bands across devices): setup bboxes are in
    global rows, the tile grid is band-local, and slots outside the band drop
    out.

    Returns ``(ids, starts, counts, bb, bb_cnt)``:

    * ``ids`` (K*S,) int32: slot ids grouped by tile, tile-major; tile ``t``
      owns ``ids[starts[t]: starts[t] + counts[t]]``;
    * ``starts``, ``counts`` (ntiles,) int32;
    * ``bb`` (S,) int32: the broadband slots, ascending, in its first
      ``bb_cnt`` entries (the rest are valid slot ids that are never read).

    Counts come from a binary search over the sorted tile keys, so they are
    exact integers at any scene size.
    """
    ntx, nty = _cdiv(width, tile_w), _cdiv(height, tile_h)
    ntiles = ntx * nty
    y0 = jnp.asarray(y_offset, jnp.int32)
    ymin_rel = setup["ymin"] - y0
    ymax_rel = setup["ymax"] - y0
    txmin = jnp.clip(setup["xmin"] // tile_w, 0, ntx - 1)
    txmax = jnp.clip(setup["xmax"] // tile_w, 0, ntx - 1)
    tymin = jnp.clip(ymin_rel // tile_h, 0, nty - 1)
    tymax = jnp.clip(ymax_rel // tile_h, 0, nty - 1)
    live = setup["live"] & (ymax_rel >= 0) & (ymin_rel < height)
    s = live.shape[0]
    wx = jnp.maximum(txmax - txmin + 1, 1)
    area = wx * jnp.maximum(tymax - tymin + 1, 1)
    small = live & (area <= SEG_K)
    big = live & (area > SEG_K)

    # One (tile, slot) entry per covered cell of each small slot; entries
    # that do not exist get the key ``ntiles`` and sort past every tile.
    slot = jnp.arange(s, dtype=jnp.int32)
    keys = []
    for e in range(SEG_K):
        dy = e // wx
        tile_e = (tymin + dy) * ntx + txmin + (e - dy * wx)
        keys.append(jnp.where(small & (e < area), tile_e, ntiles))
    sorted_keys, ids = jax.lax.sort(
        (jnp.concatenate(keys), jnp.tile(slot, SEG_K)), num_keys=1)
    bounds = jnp.searchsorted(sorted_keys,
                              jnp.arange(ntiles + 1, dtype=jnp.int32),
                              method="scan_unrolled").astype(jnp.int32)
    starts = bounds[:-1]
    counts = bounds[1:] - starts

    bb = jnp.sort(jnp.where(big, slot, slot + s)) % s
    return ids, starts, counts, bb, big.sum(dtype=jnp.int32)
