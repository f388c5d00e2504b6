"""Camera model: static config, pose parameters as tensors, the derived
viewport and batched ray generation. The arithmetic follows
``raytracing_tpu.render.camera`` op for op, so both packages generate the
same rays from the same (pixel, sample, seed).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ..core import rng as rng_mod
from ..core.device import DEFAULT_DEVICE, resolve


@dataclass(frozen=True)
class CameraConfig:
    """Static render configuration; the pose fields are the defaults for
    :meth:`CameraParams.from_config`."""
    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 10
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vfov: float = 90.0
    lookfrom: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0

    @property
    def image_height(self) -> int:
        return max(1, int(self.image_width / self.aspect_ratio))

    @property
    def n_pixels(self) -> int:
        return self.image_width * self.image_height


@dataclass
class CameraParams:
    """Camera pose and optics as f32 tensors."""
    lookfrom: torch.Tensor       # (3,)
    lookat: torch.Tensor         # (3,)
    vup: torch.Tensor            # (3,)
    vfov: torch.Tensor           # ()
    defocus_angle: torch.Tensor  # ()
    focus_dist: torch.Tensor     # ()

    @classmethod
    def from_config(cls, cfg: CameraConfig, device=DEFAULT_DEVICE) -> "CameraParams":
        device = resolve(device)
        def t(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return cls(lookfrom=t(cfg.lookfrom), lookat=t(cfg.lookat), vup=t(cfg.vup),
                   vfov=t(cfg.vfov), defocus_angle=t(cfg.defocus_angle),
                   focus_dist=t(cfg.focus_dist))


@dataclass
class DerivedCamera:
    """Viewport basis derived from :class:`CameraParams`."""
    center: torch.Tensor          # (3,)
    pixel00: torch.Tensor         # (3,)
    pixel_delta_u: torch.Tensor   # (3,)
    pixel_delta_v: torch.Tensor   # (3,)
    defocus_disk_u: torch.Tensor  # (3,)
    defocus_disk_v: torch.Tensor  # (3,)
    defocus_angle: torch.Tensor   # ()


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v))


def derive(cfg: CameraConfig, params: CameraParams) -> DerivedCamera:
    """Viewport derivation (f32 throughout, as in the JAX package)."""
    w_img = cfg.image_width
    h_img = cfg.image_height

    theta = params.vfov * (math.pi / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h * params.focus_dist
    viewport_width = viewport_height * (w_img / h_img)

    w = _unit(params.lookfrom - params.lookat)
    u = _unit(torch.linalg.cross(params.vup, w))
    v = torch.linalg.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * (-v)
    pixel_delta_u = viewport_u / w_img
    pixel_delta_v = viewport_v / h_img
    upper_left = params.lookfrom - params.focus_dist * w - viewport_u / 2 - viewport_v / 2
    pixel00 = upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = params.focus_dist * torch.tan(params.defocus_angle * (math.pi / 180.0) / 2.0)
    return DerivedCamera(
        center=params.lookfrom,
        pixel00=pixel00,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        defocus_angle=params.defocus_angle,
    )


# DerivedCamera's vectors in the packed camera's order (csrc/rt_camera.cuh CAM_*)
CAMERA_VECTORS = ("pixel00", "pixel_delta_u", "pixel_delta_v", "center", "defocus_disk_u",
                  "defocus_disk_v")
CAMERA_F = 3 * len(CAMERA_VECTORS)
CAMERA_DEFOCUS, CAMERA_MOTION = 1, 2  # csrc/rt_camera.cuh camera flags


def generate_rays(cfg: CameraConfig, cam: DerivedCamera, pixel_ids: torch.Tensor,
                  sample_ids: torch.Tensor, seed, motion_blur: bool = True):
    """Batched camera rays: AA jitter in [-0.5, 0.5)², optional defocus
    disk origin, U[0,1) ray time drawn from STREAM_TIME. Directions are
    left unnormalized.

    Returns (origin (B, 3), direction (B, 3), time (B,))."""
    return _rays([getattr(cam, f) for f in CAMERA_VECTORS], cfg.image_width,
                 cfg.defocus_angle > 0.0, pixel_ids, sample_ids, seed, motion_blur)


def _rays(vectors, width: int, defocus: bool, pixel_ids, sample_ids, seed, motion_blur):
    pixel00, pixel_delta_u, pixel_delta_v, center, defocus_disk_u, defocus_disk_v = vectors
    i = (pixel_ids % width).to(torch.float32)
    j = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)

    u4 = rng_mod.uniform4(pixel_ids, sample_ids, rng_mod.STREAM_RAYGEN, seed)
    offset = rng_mod.square_offset(u4)
    pixel_sample = (
        pixel00[None, :]
        + (i + offset[:, 0])[:, None] * pixel_delta_u[None, :]
        + (j + offset[:, 1])[:, None] * pixel_delta_v[None, :]
    )
    if defocus:
        disk = rng_mod.unit_disk(u4[:, 2:4])
        origin = (
            center[None, :]
            + disk[:, 0:1] * defocus_disk_u[None, :]
            + disk[:, 1:2] * defocus_disk_v[None, :]
        )
    else:
        origin = center[None, :].expand(pixel_sample.shape)
    direction = pixel_sample - origin
    if motion_blur:
        time = rng_mod.uniform4(pixel_ids, sample_ids, rng_mod.STREAM_TIME, seed)[:, 0]
    else:
        time = torch.zeros(pixel_ids.shape, dtype=torch.float32, device=pixel_ids.device)
    return origin, direction, time


def pack_camera(cam: DerivedCamera) -> torch.Tensor:
    """The camera as the kernels read it (``csrc/rt_camera.cuh``): the
    vectors of :data:`CAMERA_VECTORS` as one ``(CAMERA_F,)`` f32 tensor,
    built on the camera's device from its own tensors."""
    return torch.cat([getattr(cam, f).detach() for f in CAMERA_VECTORS]).to(torch.float32)


@dataclass(frozen=True)
class CameraStart:
    """Camera rays computed where they are used, in place of ray tensors:
    the packed camera (:func:`pack_camera`, on the device, so a replayed
    program reads the pose its state holds), the image width and the two
    flags :func:`generate_rays` takes from the config and its caller. K1
    starts a trace's first phase from it
    (``ops.megakernel_block.trace_block(camera=...)``) and the gradient
    replay's rays come from it in one launch
    (``diff.replay_kernel.replay_rays``), both bit-equal to
    :func:`generate_rays`; on CPU tensors they run :meth:`rays`."""
    camera: torch.Tensor  # (CAMERA_F,) f32
    width: int
    defocus: bool
    motion_blur: bool

    @classmethod
    def of(cls, cfg: CameraConfig, camera: torch.Tensor, motion_blur: bool) -> "CameraStart":
        return cls(camera, cfg.image_width, cfg.defocus_angle > 0.0, bool(motion_blur))

    @property
    def flags(self) -> int:
        return (CAMERA_DEFOCUS if self.defocus else 0) | (CAMERA_MOTION if self.motion_blur else 0)

    def rays(self, pixel_ids: torch.Tensor, sample_ids: torch.Tensor, seed):
        """:func:`generate_rays` from the packed camera: (o, d, time)."""
        return _rays(self.camera.view(len(CAMERA_VECTORS), 3).unbind(0), self.width,
                     self.defocus, pixel_ids, sample_ids, seed, self.motion_blur)

    def check(self, device) -> None:
        """Raise unless the packed camera is a contiguous ``(CAMERA_F,)``
        f32 tensor on ``device``."""
        c = self.camera
        if c.shape != (CAMERA_F,) or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError(f"the packed camera must be a contiguous ({CAMERA_F},) float32 "
                             f"tensor, got {tuple(c.shape)} {c.dtype}")
        if c.device != torch.device(device):
            raise ValueError(f"the packed camera lies on {c.device}, the rays on {device}")
