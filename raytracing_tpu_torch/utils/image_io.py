"""Image output, the counterpart of ``raytracing_tpu.utils.image_io``: PPM
(the reference's only format, src/common/color.hpp:26-58 + camera.hpp:36-37)
and PNG (through PIL where it is installed).

The gamma/quantize pass is the port's ``core.color.to_u8_image``; the host
only serializes bytes, through the native C++ writer
(native/rt_native.cpp) when it is built, else NumPy. Either way the file is
byte-equal to the JAX package's for the same radiance.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.color import to_u8_image


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


def _u8(radiance) -> np.ndarray:
    return to_u8_image(torch.as_tensor(radiance, dtype=torch.float32).cpu()).numpy()


def write_ppm(path: str, radiance) -> None:
    """Write mean radiance (H, W, 3) (a numpy array or a tensor) as ASCII
    P3 PPM with the reference's exact header and quantization semantics
    (camera.hpp:36-37, color.hpp:26-58)."""
    from ..native import rt_native

    img = _u8(radiance)
    _ensure_dir(path)
    if rt_native.write_ppm(path, img):
        return
    h, w, _ = img.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.writelines(f"{r} {g} {b}\n" for r, g, b in img.reshape(-1, 3))


def write_png(path: str, radiance) -> None:
    """PNG output (not in the reference). Needs PIL (Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("write_png needs PIL (Pillow), which is not installed here; "
                          "write a .ppm instead") from e
    img = _u8(radiance)
    _ensure_dir(path)
    Image.fromarray(img).save(path)


def write_image(path: str, radiance) -> None:
    """Dispatch by extension: ``.png`` through PIL, anything else PPM."""
    if os.path.splitext(path)[1].lower() == ".png":
        write_png(path, radiance)
    else:
        write_ppm(path, radiance)
