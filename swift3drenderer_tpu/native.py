"""ctypes bindings for the native host runtime (native/ -> libs3dnative.so).

The reference loads its C++ render core as a dylib at runtime
(reference main.swift:96-98); this framework mirrors that: the native library is
an optional, dlopen'd CPU twin of the device pipeline used for host-side fallback
rendering, fast scene IO, and cross-checking. Build it with ``make -C native``;
``load_native()`` raises a clear error when the library is absent.
"""

from __future__ import annotations

import ctypes as C
import os
from typing import Tuple

import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig
from .utils.databin import Scene

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "native", "build",
                 "libs3dnative.so"),
    "libs3dnative.so",
]


class S3DInput(C.Structure):
    _fields_ = [("up", C.c_float), ("down", C.c_float), ("left", C.c_float),
                ("right", C.c_float), ("mouse_x", C.c_float),
                ("mouse_y", C.c_float)]


class S3DFramebuffer(C.Structure):
    _fields_ = [("pixels", C.POINTER(C.c_uint32)),
                ("depth", C.POINTER(C.c_float)),
                ("width", C.c_uint32), ("height", C.c_uint32)]


class S3DConfig(C.Structure):
    _fields_ = [("near_plane", C.c_float), ("fov", C.c_float),
                ("speed", C.c_float), ("rotation_speed", C.c_float),
                ("min_area", C.c_float), ("background", C.c_uint32),
                ("bilinear", C.c_int)]


class S3DCamera(C.Structure):
    _fields_ = [("position", C.c_float * 3), ("axis_x", C.c_float * 3),
                ("axis_y", C.c_float * 3), ("axis_z", C.c_float * 3),
                ("mouse", C.c_float * 2), ("matrix", C.c_float * 12)]


_lib = None


def native_available() -> bool:
    try:
        load_native()
        return True
    except OSError:
        return False


def load_native() -> C.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    last = None
    for path in _LIB_PATHS:
        try:
            lib = C.CDLL(path)
            break
        except OSError as e:
            last = e
    else:
        raise OSError(
            f"libs3dnative.so not found (build with 'make -C native'): {last}")

    lib.s3d_scene_load.restype = C.c_void_p
    lib.s3d_scene_load.argtypes = [C.c_char_p]
    lib.s3d_scene_from_memory.restype = C.c_void_p
    lib.s3d_scene_from_memory.argtypes = [C.c_char_p, C.c_size_t]
    lib.s3d_scene_create.restype = C.c_void_p
    lib.s3d_scene_create.argtypes = [
        C.POINTER(C.c_float), C.c_int64,
        C.POINTER(C.c_int64), C.c_int64,
        C.POINTER(C.c_float), C.POINTER(C.c_float), C.POINTER(C.c_int64),
        C.c_int64, C.POINTER(C.c_int64), C.POINTER(C.c_uint32), C.c_int64]
    lib.s3d_scene_save.restype = C.c_int
    lib.s3d_scene_save.argtypes = [C.c_void_p, C.c_char_p]
    lib.s3d_scene_free.argtypes = [C.c_void_p]
    for fn in ("s3d_scene_vertex_count", "s3d_scene_triangle_count",
               "s3d_scene_texture_count"):
        getattr(lib, fn).restype = C.c_int64
        getattr(lib, fn).argtypes = [C.c_void_p]
    lib.s3d_last_error.restype = C.c_char_p
    lib.s3d_renderer_create.restype = C.c_void_p
    lib.s3d_renderer_create.argtypes = [C.c_void_p]
    lib.s3d_renderer_free.argtypes = [C.c_void_p]
    lib.s3d_render.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                               C.POINTER(S3DConfig), C.POINTER(S3DFramebuffer)]
    lib.s3d_config_default.argtypes = [C.POINTER(S3DConfig)]
    lib.s3d_camera_init.argtypes = [C.POINTER(S3DCamera)]
    lib.s3d_camera_update.argtypes = [C.POINTER(S3DCamera), C.POINTER(S3DInput),
                                      C.POINTER(S3DConfig), C.c_int]
    lib.s3d_now.restype = C.c_double
    _lib = lib
    return lib


def _config_struct(config: RenderConfig) -> S3DConfig:
    c = S3DConfig()
    load_native().s3d_config_default(C.byref(c))
    c.near_plane = config.near
    c.fov = config.fov
    c.speed = config.speed
    c.rotation_speed = config.rotation_speed
    c.min_area = config.min_area
    c.background = config.background_packed
    c.bilinear = 1 if config.sampling == "bilinear" else 0
    return c


class NativeRenderer:
    """CPU renderer backed by the native library; Renderer-compatible API."""

    def __init__(self, scene: Scene, config: RenderConfig = DEFAULT_CONFIG) -> None:
        lib = load_native()
        self._lib = lib
        self.config = config
        v = np.ascontiguousarray(scene.vertices, np.float32)
        vi = np.ascontiguousarray(scene.vertex_indices, np.int64)
        n = np.ascontiguousarray(scene.normals, np.float32)
        av = np.ascontiguousarray(scene.attr_vec, np.float32)
        at = np.ascontiguousarray(scene.attr_tex, np.int64)
        ai = np.ascontiguousarray(scene.attribute_indices, np.int64)
        tx = np.ascontiguousarray(scene.textures, np.uint32)
        self._scene = lib.s3d_scene_create(
            v.ctypes.data_as(C.POINTER(C.c_float)), scene.num_vertices,
            vi.ctypes.data_as(C.POINTER(C.c_int64)), vi.shape[0],
            n.ctypes.data_as(C.POINTER(C.c_float)),
            av.ctypes.data_as(C.POINTER(C.c_float)),
            at.ctypes.data_as(C.POINTER(C.c_int64)), scene.num_attributes,
            ai.ctypes.data_as(C.POINTER(C.c_int64)),
            tx.ctypes.data_as(C.POINTER(C.c_uint32)), scene.num_textures)
        if not self._scene:
            raise ValueError(lib.s3d_last_error().decode())
        self._renderer = lib.s3d_renderer_create(self._scene)

    def render(self, camera_matrix: np.ndarray, width: int,
               height: int) -> Tuple[np.ndarray, np.ndarray]:
        pixels = np.empty((height, width), np.uint32)
        depth = np.zeros((height, width), np.float32)
        fb = S3DFramebuffer(
            pixels.ctypes.data_as(C.POINTER(C.c_uint32)),
            depth.ctypes.data_as(C.POINTER(C.c_float)), width, height)
        m = np.ascontiguousarray(camera_matrix, np.float32).reshape(12)
        cfg = _config_struct(self.config)
        self._lib.s3d_render(self._renderer, m.ctypes.data_as(C.POINTER(C.c_float)),
                             C.byref(cfg), C.byref(fb))
        return pixels, depth

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if getattr(self, "_renderer", None):
            lib.s3d_renderer_free(self._renderer)
        if getattr(self, "_scene", None):
            lib.s3d_scene_free(self._scene)


def load_scene_native(path: str) -> int:
    """Load a data.bin through the native parser; returns the opaque handle.
    Raises ValueError with the native error message on malformed input."""
    lib = load_native()
    handle = lib.s3d_scene_load(path.encode())
    if not handle:
        raise ValueError(lib.s3d_last_error().decode())
    return handle


class NativeCamera:
    """Camera driven by the native library (twin of camera.Camera)."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG) -> None:
        self._lib = load_native()
        self._cfg = _config_struct(config)
        self._cam = S3DCamera()
        self._lib.s3d_camera_init(C.byref(self._cam))

    def update(self, up=0.0, down=0.0, left=0.0, right=0.0,
               mouse=(0.0, 0.0), force_update: bool = False) -> np.ndarray:
        inp = S3DInput(up, down, left, right, mouse[0], mouse[1])
        self._lib.s3d_camera_update(C.byref(self._cam), C.byref(inp),
                                    C.byref(self._cfg), 1 if force_update else 0)
        return np.array(self._cam.matrix, np.float32).reshape(3, 4)
