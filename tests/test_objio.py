"""OBJ import tests (framework extension: arbitrary meshes into the pipeline)."""

import numpy as np
import pytest

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.renderer import Renderer
from swift3drenderer_tpu.utils.databin import dump_scene, load_scene
from swift3drenderer_tpu.utils.objio import load_obj

from conftest import pixel_mismatch_fraction

# A unit cube with quads (exercises fan triangulation), normals, and groups.
CUBE_OBJ = """
# unit cube
o cube
v -1 -1 -1
v  1 -1 -1
v  1  1 -1
v -1  1 -1
v -1 -1  1
v  1 -1  1
v  1  1  1
v -1  1  1
vn  0  0 -1
vn  0  0  1
f 1//1 2//1 3//1 4//1
f 5//2 8//2 7//2 6//2
f 1 4 8 5
f 2 6 7 3
f 4 3 7 8
f 1 5 6 2
"""

TEX_TRI_OBJ = """
v 0 0 0
v 1 0 0
v 0 1 0
vt 0 0
vt 1 0
vt 0 1
f 1/1 2/2 3/3
"""


def test_load_cube():
    scene = load_obj(CUBE_OBJ, scale=2.0, offset=(0, 0, -8))
    assert scene.num_vertices == 8
    assert scene.num_triangles == 12  # 6 quads fan-triangulated
    # Explicit vn respected on the first two faces.
    np.testing.assert_allclose(scene.normals[0, :3], [0, 0, -1], atol=1e-6)
    # Faces without vn get flat face normals (unit length).
    norms = np.linalg.norm(scene.normals[:, :3], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    # data.bin round trip.
    s2 = load_scene(dump_scene(scene))
    assert s2.num_triangles == 12


def test_negative_indices_and_comments():
    obj = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1  # face\n"
    scene = load_obj(obj)
    assert scene.num_triangles == 1
    np.testing.assert_array_equal(scene.vertex_indices, [0, 1, 2])


def test_textured_obj():
    from swift3drenderer_tpu.models.textures import default_texture_words
    scene = load_obj(TEX_TRI_OBJ, offset=(0, 0, -5), texture=0,
                     textures=default_texture_words(1))
    assert scene.attr_tex.tolist() == [0, 0, 0]
    # OBJ v axis points up; stored uv is flipped.
    np.testing.assert_allclose(scene.attr_vec[0][:2], [0.0, 1.0])


def test_obj_renders_on_all_backends():
    scene = load_obj(CUBE_OBJ, scale=1.5, offset=(0, 0, -6))
    m = Camera().update(Input(), force_update=True)
    gp, gd = golden_render(scene, m, 160, 120)
    assert (gd > 0).sum() > 300  # cube visible
    for backend in ("xla", "pallas"):
        px, _ = Renderer(scene, backend=backend,
                         interpret=(backend == "pallas")).render(m, 160, 120)
        assert pixel_mismatch_fraction(gp, px, tol=1) < 0.003, backend


def test_empty_obj_rejected():
    with pytest.raises(ValueError, match="no faces"):
        load_obj("v 0 0 0\nv 1 0 0\n")
