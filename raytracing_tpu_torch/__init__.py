"""raytracing_tpu_torch: the PyTorch/CUDA port of the path tracer: the
forward render, the fwd+bwd gradient path and the differentiable-rendering
API (``diff``).

Scenes, camera, integrator and renderer follow ``raytracing_tpu`` module
for module. The kernels the JAX package wrote in Pallas are hand-written
CUDA kernels for sm_90a (``csrc/``: K1 and K5, the megakernels; K3 and K2,
the replay; K4, the table gather), each with a plain PyTorch version beside
its wrapper. Tensors on the CPU run the plain version; tensors on a CUDA
device run the kernel. The package imports torch and numpy, never JAX.
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
