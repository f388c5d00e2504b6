"""raytracing_tpu_torch: the PyTorch/CUDA port of the path tracer's forward
render.

Scenes, camera and renderer follow ``raytracing_tpu`` module for module;
the block megakernel (K1) is a hand-written CUDA kernel for sm_90a
(``csrc/megakernel_block.cu``) with a plain PyTorch version beside it
(``ops/megakernel_block.py``). Tensors on the CPU run the plain version;
tensors on a CUDA device run the kernel. The package imports torch and
numpy, never JAX.
"""

__version__ = "0.1.0"

from .render.camera import CameraConfig, CameraParams
from .render.renderer import Renderer, RenderResult, render
from .scene.builder import SceneBuilder
from .scene.types import Scene
from .models.scenes import SCENES, build

__all__ = [
    "CameraConfig",
    "CameraParams",
    "Renderer",
    "RenderResult",
    "render",
    "SceneBuilder",
    "Scene",
    "SCENES",
    "build",
]
