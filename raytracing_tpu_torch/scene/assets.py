"""Host-side image assets, the counterpart of
``raytracing_tpu.scene.assets`` (NumPy only, kept as the port's own copy).

Decoding happens once, when a scene is built: a dependency-free PPM
reader, and PIL for other formats where it is installed. Texels then live
on the device in the scene's :class:`ImageAtlas`. Paths are probed in the
reference's order, without its walk up the parent directories: a render
reads no file from outside the working directory and this repository.
So ``$RTW_IMAGES`` first, then the file name as given, then ``images/``
under the working directory, then the repository's own ``images/``. A
failed load gives the magenta sentinel texel and a warning on stderr, as
the reference does.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

MAGENTA = np.array([[[1.0, 0.0, 1.0]]], dtype=np.float32)  # 1x1 sentinel


def _decode(path: str) -> Optional[np.ndarray]:
    """An image file as float32 RGB in [0, 1], or None."""
    if path.lower().endswith((".ppm", ".pnm")):
        try:
            return read_ppm(path).astype(np.float32) / 255.0
        except Exception:
            return None
    try:
        from PIL import Image  # optional: without it only PPM decodes

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    except Exception:
        return None


def find_image(filename: str) -> Optional[str]:
    """The first existing path for ``filename`` in the reference's probe
    order less its ``../`` levels, or None."""
    candidates = []
    env_dir = os.environ.get("RTW_IMAGES")
    if env_dir:
        candidates.append(os.path.join(env_dir, filename))
    candidates += [filename, "images/" + filename]
    # the repository's images/, so scenes load from any working directory
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(repo_root, "images", filename))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def load_image(filename: str) -> np.ndarray:
    """An RGB image as float32 in [0, 1], (H, W, 3), its texels rounded
    through u8 as the reference converts them (float → byte → float)."""
    path = find_image(filename)
    if path is None:
        print(f"WARNING: could not load image file '{filename}'.", file=sys.stderr)
        return MAGENTA.copy()
    arr = _decode(path)
    if arr is None:
        print(f"WARNING: could not decode image file '{path}'.", file=sys.stderr)
        return MAGENTA.copy()
    q = np.clip(arr, 0.0, 1.0)
    q = np.floor(q * 255.0 + 0.5).astype(np.uint8)
    return q.astype(np.float32) / 255.0


def read_ppm(path: str) -> np.ndarray:
    """A binary (P6) or ASCII (P3) PPM as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []  # magic, width, height, maxval; comments skipped
    i = 0
    while len(tokens) < 4 and i < len(data):
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P6":
        i += 1  # the single whitespace after maxval
        img = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=i).reshape(h, w, 3)
    elif magic == b"P3":
        vals = np.array(data[i:].split(), dtype=np.int32)[:w * h * 3]
        img = vals.reshape(h, w, 3).astype(np.uint8)
    else:
        raise ValueError(f"unsupported PPM magic {magic!r}")
    if maxval != 255:
        img = (img.astype(np.float32) * (255.0 / maxval)).astype(np.uint8)
    return img


def generate_earthlike(height: int = 90, width: int = 180, seed: int = 7) -> np.ndarray:
    """A procedural earth-like equirectangular texture, float32 in [0, 1]:
    the stand-in for the reference's ``earthmap.jpg`` when no image file is
    found. Cosine bumps on the sphere make continents; a shore band and
    polar ice follow. Texels are rounded through u8 like a loaded image."""
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.linspace(0, np.pi, height), np.linspace(0, 2 * np.pi, width),
                       indexing="ij")
    xyz = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)], axis=-1)
    field = np.zeros((height, width))
    for k in range(24):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        freq = rng.uniform(1.0, 6.0)
        phase = rng.uniform(0, 2 * np.pi)
        field += np.cos(freq * (xyz @ d) * np.pi + phase) / (k + 2.0)
    land = field > np.quantile(field, 0.62)
    ocean = np.array([0.05, 0.18, 0.45])
    shore = np.array([0.75, 0.70, 0.45])
    green = np.array([0.13, 0.42, 0.18])
    ice = np.array([0.92, 0.95, 0.97])
    img = np.where(land[..., None], green, ocean)
    depth = np.abs(field - np.quantile(field, 0.62))
    img = np.where((land & (depth < 0.02))[..., None], shore, img)
    polar = (v < 0.22) | (v > np.pi - 0.22)
    img = np.where(polar[..., None], ice, img)
    u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    return u8.astype(np.float32) / np.float32(255.0)
