"""Vertex and normal stages — batched matmuls.

The reference transforms vertices and normals in scalar loops
(render/render.swift:248-255); here both stages are single ``(N, 4) @ (4, 3)``
matmuls over the whole scene, plus an elementwise projection.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# These matmuls are tiny (V x 4 @ 4 x 3); full f32 precision costs nothing and is
# required for pixel parity with the f32 CPU oracle — on the GPU an f32 matmul
# may otherwise run in TF32 (about three decimal digits), which visibly shifts
# raster vertices and barycentric weights.
_PRECISION = jax.lax.Precision.HIGHEST


def transform_points(vertices: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Camera-space positions: ``cv = M . v`` (render.swift:249).

    vertices: (V, 4) with w == 1; m: (3, 4) row-major view matrix.
    """
    return jnp.dot(vertices, m.T, preferred_element_type=jnp.float32,
                   precision=_PRECISION)


def project(cv: jnp.ndarray, factor: float, half_w: float,
            half_h: float) -> jnp.ndarray:
    """Raster vertices (render.swift:251): screen xy from the pinhole
    ``(x, -y) * factor / -z`` plus screen center; rv.z holds the view depth -z."""
    z = -cv[..., 2]
    sx = cv[..., 0] * factor / z + half_w
    sy = -cv[..., 1] * factor / z + half_h
    return jnp.stack([sx, sy, z], axis=-1)


def transform_normals(normals: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Camera-space normals ``n = M . normal`` with w == 0 so translation drops
    out (render.swift:254)."""
    return jnp.dot(normals, m.T, preferred_element_type=jnp.float32,
                   precision=_PRECISION)
