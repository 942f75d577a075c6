"""Near-plane clip prepass — the reference's mid-frame triangle append recast as a
fixed-shape, fully vectorized transform.

The reference clips lazily inside the triangle loop and *appends* split triangles to
the live scene arrays, growing the loop bound mid-frame (render/render.swift:177-227,
consumed at :260). That dynamic growth is hostile to XLA's static shapes, but the
reference itself bounds it: every triangle emits at most 2 triangles (its arrays are
allocated at exactly 2x, render.swift:147-148). So the prepass maps T input triangles
to exactly 2T output slots with a validity mask:

  slot 2t   — the "primary": the original triangle, shrunk in place (one corner in
              front) or with one corner replaced by a crossing point (two in front)
  slot 2t+1 — the "appended" split triangle; valid only in the two-in-front case

Crossing points are lerped at ``a = (near - z_i) / (z_next - z_i)`` and their raster
vertex recomputed at depth == near (render.swift:187-189).
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

Corners = Dict[str, jnp.ndarray]


def clip_prepass(
    cv: jnp.ndarray,    # (T, 3, 3) camera-space corner positions
    rv: jnp.ndarray,    # (T, 3, 3) raster corners (screen x, y, view depth)
    attr: jnp.ndarray,  # (T, 3, 3) RGB or (u, v, 0)
    n: jnp.ndarray,     # (T, 3, 3) camera-space corner normals
    tex: jnp.ndarray,   # (T,) texture index or -1
    near: float,
    factor: float,
    half_w: float,
    half_h: float,
) -> Corners:
    """Returns corner arrays with leading dim 2T plus a ``valid`` mask (2T,)."""
    t = cv.shape[0]
    z = rv[..., 2]                       # (T, 3) view depths
    front = z > near                     # (T, 3)
    num_front = front.sum(axis=1)        # (T,)
    all_behind = num_front == 0          # render.swift:269 cull
    all_front = num_front == 3
    straddle = ~all_behind & ~all_front

    # The unique same-side edge s: front[s] == front[s+1] (render.swift:181-185).
    def rot1(x):
        """``x[:, [1, 2, 0]]`` as a slice+concat: two contiguous copies
        instead of a gather op."""
        return jnp.concatenate([x[:, 1:], x[:, :1]], axis=1)

    same = front == rot1(front)          # (T, 3)
    s = jnp.argmax(same, axis=1).astype(jnp.int32)          # (T,)
    nxt = (s + 1) % 3
    prc = (s + 2) % 3

    def sel_corner(arr, idx):
        """``arr[t, idx[t], ...]`` for idx in [0, 3) as 3 masked selects
        instead of a per-row dynamic gather: pure elementwise work that XLA
        fuses with the rest of the prepass."""
        expand = (slice(None),) + (None,) * (arr.ndim - 2)
        out = jnp.zeros_like(arr[:, 0])
        for k in range(3):
            out = jnp.where((idx == k)[expand], arr[:, k], out)
        return out

    two_front = straddle & sel_corner(front, s)             # newTriangle flag

    # All three edge crossings, computed unconditionally (render.swift:186-199).
    z_next = rot1(z)
    a = (near - z) / (z_next - z)                            # (T, 3)
    a3 = a[..., None]
    xcv = cv * (1 - a3) + rot1(cv) * a3                 # (T, 3, 3)
    xattr = attr * (1 - a3) + rot1(attr) * a3
    xn = n * (1 - a3) + rot1(n) * a3
    xrv = jnp.stack(
        [xcv[..., 0] * factor / near + half_w,
         -xcv[..., 1] * factor / near + half_h,
         jnp.full(xcv.shape[:2], near, dtype=cv.dtype)], axis=-1)

    corner = jnp.arange(3, dtype=jnp.int32)[None, :]         # (1, 3)
    is_s = corner == s[:, None]
    is_nxt = corner == nxt[:, None]
    is_prc = corner == prc[:, None]

    # Primary slot: per-corner source index and orig-vs-crossing selector.
    use_x = (
        (two_front[:, None] & is_prc)                         # -> crossing[nxt]
        | ((straddle & ~two_front)[:, None] & (is_s | is_nxt))
    )
    src = jnp.broadcast_to(corner, (t, 3))
    src = jnp.where(two_front[:, None] & is_prc, nxt[:, None], src)
    one_front = straddle & ~two_front
    src = jnp.where(one_front[:, None] & is_s, prc[:, None], src)
    src = jnp.where(one_front[:, None] & is_nxt, nxt[:, None], src)

    def gather3(arr, idx):
        """``arr[t, idx[t, c], :]`` as masked selects (see sel_corner)."""
        out = jnp.zeros_like(arr)
        for k in range(3):
            out = jnp.where((idx == k)[..., None], arr[:, k][:, None, :], out)
        return out

    def pick(orig, crossing):
        return jnp.where(use_x[..., None], gather3(crossing, src),
                         gather3(orig, src))

    prim = {k: pick(o, x) for k, (o, x) in
            dict(cv=(cv, xcv), rv=(rv, xrv), attr=(attr, xattr), n=(n, xn)).items()}

    # Appended slot: corners [orig s, crossing nxt, crossing prc]
    # (render.swift:202-222).
    sec_src = jnp.stack([s, nxt, prc], axis=1)               # (T, 3)
    sec_use_x = jnp.array([False, True, True])[None, :]

    def pick_sec(orig, crossing):
        return jnp.where(sec_use_x[..., None], gather3(crossing, sec_src),
                         gather3(orig, sec_src))

    sec = {k: pick_sec(o, x) for k, (o, x) in
           dict(cv=(cv, xcv), rv=(rv, xrv), attr=(attr, xattr), n=(n, xn)).items()}

    # Interleave: slot 2t = primary, 2t+1 = appended.
    out = {}
    for k in ("cv", "rv", "attr", "n"):
        out[k] = jnp.stack([prim[k], sec[k]], axis=1).reshape(2 * t, 3, 3)
    out["tex"] = jnp.stack([tex, tex], axis=1).reshape(2 * t)
    valid = jnp.stack([~all_behind, two_front], axis=1).reshape(2 * t)
    out["valid"] = valid
    return out
