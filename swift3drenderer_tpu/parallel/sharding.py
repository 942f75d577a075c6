"""Multi-chip SPMD rendering over a device mesh.

The reference is strictly single-threaded (SURVEY.md section 2: no parallelism of any
kind), so the distribution strategy here is designed for the device mesh rather than
ported:

* axis ``frame`` — data parallelism over a batch of cameras (independent frames:
  multi-view rendering, or the serving analog of batch inference);
* axis ``fb`` — the framebuffer sharded by horizontal row bands (the renderer's
  sequence/spatial parallelism: each device rasterizes its band against the full,
  replicated triangle setup table — triangle setup is tiny, pixels are the work).

Geometry (vertex transform, clip prepass, setup) is recomputed per device instead of
communicated: for this workload it is ~10^4 flops vs ~10^8 pixel-flops, so replicating
it avoids all gather traffic; the only cross-device "communication" is the implicit
output layout (each device owns its band, no collective needed in the forward path).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULT_CONFIG, RenderConfig
from ..renderer import build_setup


def make_mesh(n_frame: int = 1, n_fb: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a (frame, fb) mesh from the first n_frame * n_fb visible devices."""
    devices = devices if devices is not None else jax.devices()
    if n_fb is None:
        n_fb = len(devices) // n_frame
    n = n_frame * n_fb
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.asarray(devices[:n]).reshape(n_frame, n_fb)
    return Mesh(grid, axis_names=("frame", "fb"))


@partial(jax.jit, static_argnames=("width", "height", "config", "mesh",
                                   "band_rows", "chunk", "backend", "interpret"))
def render_batch_sharded(
    dev: Dict[str, jnp.ndarray],
    matrices: jnp.ndarray,     # (B, 3, 4) camera batch, B % mesh.frame == 0
    *,
    width: int,
    height: int,
    config: RenderConfig = DEFAULT_CONFIG,
    mesh: Mesh,
    band_rows: int = 8,
    chunk: int = 16,
    backend: str = "xla",
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render a camera batch over the mesh; returns (pixels (B, H, W) uint32,
    depth (B, H, W) f32), sharded P('frame', 'fb', None)."""
    from ..ops import raster_pallas
    from ..ops.raster_xla import rasterize

    n_fb = mesh.shape["fb"]
    n_frame = mesh.shape["frame"]
    if height % n_fb:
        raise ValueError(f"height {height} not divisible by fb axis {n_fb}")
    if matrices.shape[0] % n_frame:
        raise ValueError(
            f"camera batch {matrices.shape[0]} not divisible by frame axis {n_frame}")
    local_h = height // n_fb

    def shard_fn(dev_rep, m_local):
        y0 = jax.lax.axis_index("fb") * local_h

        if backend == "pallas":
            # The local camera batch rides the kernel grid.
            setup = jax.vmap(lambda m: build_setup(
                dev_rep, m, width=width, height=height, config=config))(m_local)
            return raster_pallas.rasterize(
                setup, dev_rep["textures"], width=width, height=local_h,
                background=config.background_packed, y_offset=y0,
                sampling=config.sampling,
                interpret=raster_pallas.kernel_mode(interpret))

        def one_frame(m):
            setup = build_setup(dev_rep, m, width=width, height=height,
                                config=config)
            return rasterize(
                setup, dev_rep["textures"], width=width, height=local_h,
                background=config.background_packed, band_rows=band_rows,
                chunk=chunk, y_offset=y0, sampling=config.sampling,
            )

        return jax.vmap(one_frame)(m_local)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), dev), P("frame")),
        out_specs=P("frame", "fb", None),
        # pallas_call outputs carry no varying-mesh-axis annotation; skip the
        # vma check (outputs are explicitly laid out by out_specs anyway).
        check_vma=False,
    )
    return fn(dev, matrices)


@partial(jax.jit, static_argnames=("width", "height", "config", "mesh",
                                   "backend", "interpret"))
def render_scene_sharded(
    dev: Dict[str, jnp.ndarray],
    m: jnp.ndarray,            # (3, 4) single camera
    *,
    width: int,
    height: int,
    config: RenderConfig = DEFAULT_CONFIG,
    mesh: Mesh,
    backend: str = "pallas",
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Triangle-sharded rendering — the scene (model) parallelism axis.

    Each device rasterizes an equal slice of the setup-table slots over the
    FULL framebuffer, then frames merge across the mesh by depth: a local
    (1/z, global-id) lexicographic reduce. Ties resolve to the smallest global
    slot id — the reference's earlier-triangle-wins order (render.swift:324)
    independent of the shard split — so the composite is bit-identical to a
    one-device render. Complements the fb/frame axes in
    render_batch_sharded: use this when the TRIANGLE COUNT is the scaling
    dimension (pixels are replicated work).

    Every device builds the full setup table (the same program as the
    one-device front-end) and slices its slot range; the pallas kernel then
    writes each pixel's winning global slot id beside it. The xla backend
    merges on strictly-greater depth (ties then favor lower-ranked devices,
    which hold lower slot ranges — still reference order).

    The composite is a butterfly (recursive-doubling) ppermute reduce when
    every mesh axis is a power of two — each device exchanges the
    (pix, 1/z, gid) planes log2(n) times, 12*log2(n) bytes/pixel, against
    the all_gather fallback's 12*(n-1). The merge key (max 1/z, then min
    global id) is a total order per pixel, so any reduction order yields
    the same pixels; the non-power-of-two fallback keeps the gather+scan
    form.
    """
    from ..ops import raster_pallas
    from ..ops.raster_xla import rasterize

    n = mesh.devices.size
    axes = tuple(mesh.axis_names)
    t = dev["vi"].shape[0]      # triangles
    s_pad = 2 * (-(-t // n) * n)  # slots, dead-padded to a device multiple
    local = s_pad // n

    def shard_fn(dev_rep, m_rep):
        rank = jax.lax.axis_index(axes[0])
        if len(axes) > 1:
            rank = rank * mesh.shape[axes[1]] + jax.lax.axis_index(axes[1])
        setup = build_setup(dev_rep, m_rep, width=width, height=height,
                            config=config)
        if s_pad != 2 * t:
            setup = {k: jnp.pad(
                v, ((0, s_pad - 2 * t),) + ((0, 0),) * (v.ndim - 1))
                for k, v in setup.items()}  # pads live=False slots
        lo = rank * local
        sub = {k: jax.lax.dynamic_slice_in_dim(v, lo, local, axis=0)
               for k, v in setup.items()}
        if backend == "pallas":
            pix, ooz, gid = raster_pallas.rasterize(
                jax.tree.map(lambda a: a[None], sub), dev_rep["textures"],
                width=width, height=height,
                background=config.background_packed,
                sampling=config.sampling, gid_base=lo,
                interpret=raster_pallas.kernel_mode(interpret))
            pix, ooz, gid = pix[0], ooz[0], gid[0]
        else:
            pix, ooz = rasterize(
                sub, dev_rep["textures"], width=width, height=height,
                background=config.background_packed, sampling=config.sampling)
            gid = jnp.where(ooz > 0, lo, jnp.int32(raster_pallas.NO_WINNER))

        # Depth-composite across the mesh by (max 1/z, then min global id).
        if all(mesh.shape[ax] & (mesh.shape[ax] - 1) == 0 for ax in axes):
            # Butterfly ppermute reduce: log2(n) pairwise exchanges per axis
            # (the key is a total order per pixel, so per-axis reduction
            # composes and any order is bit-identical to the gather+scan).
            fpix, fooz, _ = _butterfly_merge(pix, ooz, gid, axes, mesh)
            return fpix, fooz

        # Fallback (non-power-of-two axis): gather every shard's frame and
        # reduce locally.
        parts_pix = jax.lax.all_gather(pix, axes)   # (n, H, W)
        parts_ooz = jax.lax.all_gather(ooz, axes)
        parts_gid = jax.lax.all_gather(gid, axes)
        bg = jnp.uint32(config.background_packed)

        def merge(carry, part):
            cpix, cooz, cgid = carry
            ppix, pooz, pgid = part
            upd = (pooz > cooz) | ((pooz == cooz) & (pooz > 0)
                                   & (pgid < cgid))
            return (jnp.where(upd, ppix, cpix), jnp.where(upd, pooz, cooz),
                    jnp.where(upd, pgid, cgid)), None

        (fpix, fooz, _), _ = jax.lax.scan(
            merge,
            (jnp.full((height, width), bg, jnp.uint32),
             jnp.zeros((height, width), jnp.float32),
             jnp.full((height, width), raster_pallas.NO_WINNER, jnp.int32)),
            (parts_pix, parts_ooz, parts_gid))
        return fpix, fooz

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), dev), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(dev, m)


def _butterfly_merge(pix, ooz, gid, axes, mesh):
    """Recursive-doubling depth composite: every device ends with the full
    merged frame after sum(log2(size)) pairwise (1/z, gid) exchanges.

    The per-pixel merge key is a lexicographic max over (1/z, -gid) — an
    associative, commutative reduction — so reducing each mesh axis in turn
    with XOR-partner butterflies produces the same winner as any other order.
    Requires every axis size to be a power of two (XOR partners must exist).
    """
    for ax in axes:
        size = mesh.shape[ax]
        k = 1
        while k < size:
            perm = [(i, i ^ k) for i in range(size)]
            opix = jax.lax.ppermute(pix, ax, perm)
            oooz = jax.lax.ppermute(ooz, ax, perm)
            ogid = jax.lax.ppermute(gid, ax, perm)
            upd = (oooz > ooz) | ((oooz == ooz) & (oooz > 0) & (ogid < gid))
            pix = jnp.where(upd, opix, pix)
            ooz = jnp.where(upd, oooz, ooz)
            gid = jnp.where(upd, ogid, gid)
            k *= 2
    return pix, ooz, gid


class ShardedRenderer:
    """Multi-device front-end mirroring Renderer's API for camera batches."""

    def __init__(self, scene, config: RenderConfig = DEFAULT_CONFIG,
                 mesh: Optional[Mesh] = None, backend: str = "xla",
                 interpret: bool = False) -> None:
        from ..renderer import scene_to_device

        scene.validate()
        self.config = config
        self.backend = backend
        self.interpret = interpret
        if backend == "pallas":
            from ..ops.raster_pallas import kernel_mode

            kernel_mode(interpret)  # fail fast on a platform with no kernel
        self.mesh = mesh if mesh is not None else make_mesh(1, len(jax.devices()))
        self.dev = scene_to_device(scene)

    def render_batch(self, matrices: np.ndarray, width: int, height: int):
        return render_batch_sharded(
            self.dev, jnp.asarray(matrices, jnp.float32),
            width=width, height=height, config=self.config, mesh=self.mesh,
            backend=self.backend, interpret=self.interpret,
        )
