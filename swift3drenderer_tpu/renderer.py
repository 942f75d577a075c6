"""Device renderer — the whole frame as one jitted XLA dispatch.

Pipeline (recast of reference render/render.swift:229-344):

  host: camera update (~30 flops, NumPy)   ->  (3, 4) matrix to device
  device, one jit: vertex + normal transforms -> fixed-shape near-plane clip
  prepass -> triangle setup table -> visibility resolve (running max over
  1/z) -> deferred shading -> (H, W) u32 pixels

Scene arrays are uploaded to device memory once at construction (the analog
of the reference's one-time data.bin load, render.swift:137-175); per frame
only the camera matrix crosses host->device and the pixel/depth buffers cross
back.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig
from .ops.clip import clip_prepass
from .ops.setup import triangle_setup
from .ops.vertex import project, transform_normals, transform_points
from .utils.databin import Scene


def scene_to_device(scene: Scene) -> Dict[str, jnp.ndarray]:
    """Upload a host Scene to device memory in structure-of-arrays form.

    The triangle topology is static, so the corner gathers (``vertices[vi]``
    etc.) are done ONCE here on the host, corner-major, and the per-frame
    front-end is gather-free matmul/elementwise work. The corner-major
    duplication is a few hundred KB at 10k triangles; the flat vertex/
    normal/attribute arrays are not uploaded (no render path reads them —
    ``vi``/``ai`` ride along for topology checks and the triangle count)."""
    vi = scene.vertex_indices.reshape(-1, 3).astype(np.int32)
    ai = scene.attribute_indices.reshape(-1, 3).astype(np.int32)
    verts = scene.vertices.astype(np.float32)
    norms = scene.normals.astype(np.float32)
    attrs = scene.attr_vec.astype(np.float32)
    return dict(
        vi=jnp.asarray(vi),
        ai=jnp.asarray(ai),
        textures=jnp.asarray(scene.textures, jnp.uint32),
        vert_c=jnp.asarray(verts[vi]),                       # (T, 3, 4)
        norm_c=jnp.asarray(norms[ai]),                       # (T, 3, 4)
        attr_c=jnp.asarray(attrs[ai]),                       # (T, 3, 3)
        tex_c=jnp.asarray(scene.attr_tex[ai[:, 0]], jnp.int32),  # (T,)
    )


def build_setup(dev: Dict[str, jnp.ndarray], m: jnp.ndarray, *, width,
                height, config: RenderConfig,
                proj=None) -> Dict[str, jnp.ndarray]:
    """Geometry front-end: transforms, corner gather, clip prepass, setup table.

    ``width``/``height`` may be traced scalars (bucketed live resize); pass the
    host-computed projection constants via ``proj = (factor, half_w, half_h)``
    then, so the arithmetic is bit-identical to the exact-size compile.
    """
    if proj is None:
        factor = config.factor(height)
        half_w, half_h = width / 2.0, height / 2.0
    else:
        factor, half_w, half_h = proj
    # Corner-major pre-gathered arrays (scene_to_device): the per-frame
    # front-end is gather-free — transforms run directly on (T*3, 4) rows.
    t = dev["vert_c"].shape[0]
    cv_c = transform_points(dev["vert_c"].reshape(-1, 4), m)
    rv_c = project(cv_c, factor, half_w, half_h)
    nrm_c = transform_normals(dev["norm_c"].reshape(-1, 4), m)
    corners = clip_prepass(
        cv=cv_c.reshape(t, 3, -1), rv=rv_c.reshape(t, 3, -1),
        attr=dev["attr_c"],
        n=nrm_c.reshape(t, 3, -1),
        tex=dev["tex_c"],
        near=config.near, factor=factor, half_w=half_w, half_h=half_h,
    )
    return triangle_setup(corners, width, height, config.min_area)


@partial(jax.jit, static_argnames=("width", "height", "config", "band_rows",
                                   "chunk"))
def render_frame_xla(
    dev: Dict[str, jnp.ndarray],
    m: jnp.ndarray,
    *,
    width: int,
    height: int,
    config: RenderConfig = DEFAULT_CONFIG,
    band_rows: int = 32,
    chunk: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    from .ops.raster_xla import rasterize

    setup = build_setup(dev, m, width=width, height=height, config=config)
    return rasterize(
        setup, dev["textures"], width=width, height=height,
        background=config.background_packed, band_rows=band_rows, chunk=chunk,
        sampling=config.sampling,
    )


def _bucket_dim(x: int, step: int, lo: int = 128, growth: float = 1.4) -> int:
    b = lo
    while b < x:
        b = -(-int(b * growth) // step) * step
    return b


def bucket_dims(width: int, height: int) -> Tuple[int, int]:
    """Geometric compile-size buckets for live resize: a drag-resize sweep
    recompiles at most log-many times (the reference keeps rendering at every
    size every frame, main.swift:156-165; XLA needs static raster extents, so
    we compile at the bucket size and mask/crop to the true size)."""
    return _bucket_dim(width, 128), _bucket_dim(height, 64)


@partial(jax.jit, static_argnames=("bw", "bh", "config", "backend",
                                   "interpret"))
def _render_frame_bucketed(
    dev: Dict[str, jnp.ndarray],
    m: jnp.ndarray,
    dims: jnp.ndarray,  # (5,) f32: width, height, factor, half_w, half_h
    *,
    bw: int,
    bh: int,
    config: RenderConfig = DEFAULT_CONFIG,
    backend: str = "xla",
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render at bucket raster extent (bw, bh) with the TRUE frame dimensions
    traced: projection and coverage clamps use the true size (host-computed
    constants in ``dims`` keep the arithmetic bit-identical to an exact-size
    compile), so rows/cols beyond the true size stay background and the caller
    crops. Compiles once per (bw, bh) bucket instead of per exact size."""
    setup = build_setup(dev, m, width=dims[0], height=dims[1], config=config,
                        proj=(dims[2], dims[3], dims[4]))
    if backend == "pallas":
        from .ops.raster_pallas import kernel_mode, rasterize

        pix, ooz = rasterize(
            jax.tree.map(lambda a: a[None], setup), dev["textures"],
            width=bw, height=bh, background=config.background_packed,
            sampling=config.sampling, interpret=kernel_mode(interpret))
        return pix[0], ooz[0]
    from .ops.raster_xla import rasterize

    return rasterize(
        setup, dev["textures"], width=bw, height=bh,
        background=config.background_packed, sampling=config.sampling)


class Renderer:
    """Host-side frame orchestrator.

    Caches the compiled executable per (width, height); the scene is resident on
    device for the renderer's lifetime. ``backend`` selects the rasterizer:
    'xla' (banded scan), 'pallas' (the GPU tile kernel, the perf path), or
    'native' (the C++ CPU core via ctypes — the analog of the reference
    swapping its Swift core for the render.dylib one, reference
    main.swift:96-98).

    ``interpret=True`` lets the 'pallas' backend run in the Pallas
    interpreter on the CPU (tests); on the GPU the kernel is always compiled,
    and on a CPU without it construction raises (ops.raster_pallas.
    kernel_mode).
    """

    def __init__(self, scene: Scene, config: RenderConfig = DEFAULT_CONFIG,
                 backend: str = "xla", interpret: bool = False) -> None:
        scene.validate()
        self.config = config
        self.backend = backend
        self.interpret = interpret
        if backend == "pallas":
            from .ops.raster_pallas import kernel_mode

            kernel_mode(interpret)  # fail fast on a platform with no kernel
        if backend == "native":
            from .native import NativeRenderer

            self._native = NativeRenderer(scene, config=config)
            self.dev = None
        else:
            self.dev = scene_to_device(scene)
            # Host-side topology for update_scene: the indices are immutable
            # for this Renderer's lifetime, so keeping them here avoids a
            # device->host roundtrip on every animation call.
            self._host_vi = scene.vertex_indices.reshape(-1, 3).astype(np.int32)
            self._host_ai = scene.attribute_indices.reshape(-1, 3).astype(np.int32)
            self._flat_shapes = {"vertices": scene.vertices.shape,
                                 "normals": scene.normals.shape,
                                 "attr_vec": scene.attr_vec.shape}

    def render(self, camera_matrix: np.ndarray, width: int,
               height: int, bucketed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Render one frame; returns host (pixels (H, W) uint32, depth f32).

        ``bucketed=True`` compiles per resolution *bucket* instead of per exact
        size (live-resize friendly, see bucket_dims); output is cropped to the
        requested size and pixel-identical to the exact-size path."""
        if self.backend == "native":
            return self._native.render(camera_matrix, width, height)
        if bucketed:
            bw, bh = bucket_dims(width, height)
            dims = jnp.asarray(
                [width, height, self.config.factor(height),
                 width / 2.0, height / 2.0], jnp.float32)
            pixels, depth = _render_frame_bucketed(
                self.dev, jnp.asarray(camera_matrix, jnp.float32), dims,
                bw=bw, bh=bh, config=self.config, backend=self.backend,
                interpret=self.interpret)
            return (np.asarray(pixels)[:height, :width],
                    np.asarray(depth)[:height, :width])
        pixels, depth = self.render_device(camera_matrix, width, height)
        return np.asarray(pixels), np.asarray(depth)

    def render_device(self, camera_matrix, width: int, height: int):
        """Render, leaving results on device (for benchmarking / presentation)."""
        if self.backend == "native":
            raise ValueError("the native backend renders on host; use render()")
        m = jnp.asarray(camera_matrix, jnp.float32)
        if self.backend == "xla":
            return render_frame_xla(self.dev, m, width=width, height=height,
                                    config=self.config)
        if self.backend == "pallas":
            from .ops.raster_pallas import render_frame_pallas

            return render_frame_pallas(self.dev, m, width=width, height=height,
                                       config=self.config,
                                       interpret=self.interpret)
        raise ValueError(f"unknown backend {self.backend!r}")

    def update_scene(self, vertices: Optional[np.ndarray] = None,
                     normals: Optional[np.ndarray] = None,
                     attr_vec: Optional[np.ndarray] = None) -> None:
        """Animate the scene: swap per-vertex/attribute data in place.

        Shapes must match the bound scene (everything stays statically shaped,
        so no recompilation happens — the next render just reads the new
        arrays). Topology (indices, texture set) is fixed per Renderer; build a
        new Renderer to change it. The reference has no animation at all (its
        scene is immutable after data.bin load, render.swift:137-175).
        """
        if self.backend == "native":
            raise ValueError("scene animation requires a device backend")
        # The render path reads the corner-major pre-gathers; the host gather
        # over the cached immutable indices is trivial.
        for name, arr, cname, idx in (
                ("vertices", vertices, "vert_c", self._host_vi),
                ("normals", normals, "norm_c", self._host_ai),
                ("attr_vec", attr_vec, "attr_c", self._host_ai)):
            if arr is None:
                continue
            arr = np.asarray(arr, np.float32)
            if arr.shape != self._flat_shapes[name]:
                raise ValueError(
                    f"{name} shape {arr.shape} != bound "
                    f"{self._flat_shapes[name]}")
            self.dev[cname] = jnp.asarray(arr[idx])

    def render_batch(self, matrices: np.ndarray, width: int, height: int):
        """Render a batch of camera poses on one device — the serving path
        (for multi-device batches see parallel.sharding.ShardedRenderer).
        Returns device arrays (B, H, W) pixels and depth.

        The XLA backend vmaps; the Pallas backend folds the batch into the
        kernel grid (B, nty, ntx) — one launch renders all B frames."""
        ms = jnp.asarray(matrices, jnp.float32)
        if self.backend == "pallas":
            from .ops.raster_pallas import render_batch_pallas

            return render_batch_pallas(self.dev, ms, width=width,
                                       height=height, config=self.config,
                                       interpret=self.interpret)
        fn = partial(render_frame_xla, self.dev, width=width, height=height,
                     config=self.config)
        return jax.vmap(fn)(ms)
