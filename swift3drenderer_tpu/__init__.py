"""swift3drenderer_tpu — a 3D rendering framework in JAX for the GPU.

A brand-new JAX/XLA/Pallas implementation of the capabilities of
sarastro-nl/Swift3DRenderer (a CPU software rasterizer): perspective fly-around
camera, near-plane clipping with triangle split, edge-function rasterization with
1/z depth buffering, perspective-correct interpolation, flat-color and anisotropic
ripmap-textured shading, and the reference's exact ``data.bin`` scene format.

The compute path is recast for an accelerator: vertex transforms as batched
matmuls, a fixed-shape clip prepass instead of mid-frame appends, and tiled
rasterization (a Pallas kernel for the GPU, and a plain XLA backend) instead of
the reference's scalar edge walk.
"""

from .camera import Camera, Input, KeyboardState
from .config import DEFAULT_CONFIG, RenderConfig
from .utils.databin import Scene, dump_scene, load_scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Input",
    "KeyboardState",
    "RenderConfig",
    "DEFAULT_CONFIG",
    "Scene",
    "load_scene",
    "dump_scene",
    "__version__",
]
