"""The C++ ground-truth comparison through the port, the counterpart of
``tools/cpp_compare.py``.

It renders the four configurations ``CPP_COMPARE.json`` stores
(``CONFIGS``, ``tools/cpp_compare.py:171-176``: quads, checkered_spheres,
cornell_box, simple_light) with the port's default ``Renderer`` and
compares image statistics (``stats``: per-channel u8 means and the
non-black pixel fraction, ``:113-121``) with the C++ reference's under
the file's own tolerances. Statistics, not pixels: the two renderers
share every formula but not the RNG engine (``std::rand`` against
counter-based PCG4D) or the precision (f64 against f32), so at equal spp
the per-channel means estimate the same integral.

The C++ renderer writes its aspect ratio as a float literal (16.0f/9.0f),
so its height is ``int(w / float32(aspect))``: one row fewer than the
exact 16/9 at some widths (400x224, not 400x225). The port's render
re-derives its height from the float32-rounded aspect (``:145-151``), so
the two cover the same pixel grid.

The yardstick is the ``cpp`` statistics stored in ``CPP_COMPARE.json``
(read as data). The reference source is not part of this repository:
given its ``src`` directory (``--reference-src DIR``, or the
``RT_REFERENCE_SRC`` environment variable), the tool builds and runs it
live instead (``build_reference``, ``:67-97``: the source copied, its
scene and camera constants patched, ``stb_image`` stubbed, ``g++ -O2``),
as the JAX tool does.

    python -m raytracing_tpu_torch.cpp_compare [--quick] [--out FILE]
        [--reference-src DIR] [--device cpu]

prints one JSON line per configuration and exits non-zero if any is
outside its tolerance.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .core.device import DEFAULT_DEVICE

STORED = Path(__file__).resolve().parent.parent / "CPP_COMPARE.json"

# (scene, width, spp, depth, mean tolerance in u8 levels, non-black tolerance)
CONFIGS = [
    ("quads", 128, 32, 8, 3.0, 0.01),
    ("checkered_spheres", 128, 32, 16, 3.0, 0.01),
    ("cornell_box", 96, 64, 16, 5.0, 0.03),
    ("simple_light", 128, 48, 16, 3.0, 0.03),
]
QUICK = [("quads", 64, 8, 4, 4.0, 0.02)]

SCENE_IDS = {"quads": 5, "cornell_box": 7, "checkered_spheres": 2, "simple_light": 6}

STB_STUB = """\
#ifndef STB_STUB_H
#define STB_STUB_H
#include <cstdlib>
#define STBI_FREE(p) free(p)
// stb_image stub: none of the compared scenes loads an image
static inline float *stbi_loadf(const char *, int *, int *, int *, int) { return 0; }
static inline void stbi_image_free(void *) {}
#define STBI_FAILURE_REASON
static inline const char *stbi_failure_reason(void) { return "stubbed"; }
#endif
"""


def stats(img) -> dict:
    """Per-channel u8 means, the non-black pixel fraction and the shape."""
    img = np.asarray(img)
    return dict(mean=[round(float(m), 3) for m in img.reshape(-1, 3).mean(axis=0)],
                nonblack=round(float((img.max(axis=-1) > 0).mean()), 4),
                shape=list(img.shape[:2]))


def stored(path: Path = STORED) -> dict:
    """``CPP_COMPARE.json``'s configurations keyed by (scene, width, spp,
    depth)."""
    with open(path) as f:
        doc = json.load(f)
    return {(c["scene"], c["width"], c["spp"], c["depth"]): c for c in doc["configs"]}


def build_reference(ref_src: str, workdir: str, scene: str, width: int, spp: int,
                    depth: int) -> str:
    """Copy the C++ reference's source, patch its scene id and camera
    constants, build it with a stubbed ``stb_image``; the executable's
    path."""
    src = os.path.join(workdir, "src")
    shutil.copytree(ref_src, src)
    stubdir = os.path.join(workdir, "stb")
    os.makedirs(stubdir, exist_ok=True)
    with open(os.path.join(stubdir, "stb_image.h"), "w") as f:
        f.write(STB_STUB)
    main = os.path.join(src, "main.cpp")
    with open(main) as f:
        text = f.read()
    text = text.replace("switch (7)", f"switch ({SCENE_IDS[scene]})")
    text = re.sub(r"cam\.image_width = \d+;", f"cam.image_width = {width};", text)
    text = re.sub(r"cam\.samples_per_pixel = \d+;", f"cam.samples_per_pixel = {spp};", text)
    text = re.sub(r"cam\.max_depth = \d+;", f"cam.max_depth = {depth};", text)
    with open(main, "w") as f:
        f.write(text)
    exe = os.path.join(workdir, "raytracer")
    subprocess.run(["g++", "-O2", "-std=c++11", f"-I{src}", f"-I{stubdir}", main, "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


def read_ppm_ascii(path: str) -> np.ndarray:
    """The reference's P3 PPM → (H, W, 3) uint8."""
    with open(path) as f:
        tok = f.read().split()
    if tok[0] != "P3" or int(tok[3]) != 255:
        raise ValueError(f"{path}: not an 8-bit P3 PPM")
    w, h = int(tok[1]), int(tok[2])
    return np.array(tok[4:4 + w * h * 3], dtype=np.int64).reshape(h, w, 3).astype(np.uint8)


def cpp_stats(scene: str, width: int, spp: int, depth: int,
              ref_src: Optional[str] = None, timeout: int = 900) -> dict:
    """The C++ renderer's statistics: rendered live from ``ref_src``, else
    the ones ``CPP_COMPARE.json`` stores (ValueError for a configuration
    it does not hold, such as ``QUICK``'s)."""
    if ref_src is None:
        held = stored()
        if (scene, width, spp, depth) not in held:
            raise ValueError(f"CPP_COMPARE.json holds no {scene} at {width} px, {spp} spp, "
                             f"depth {depth}: give the reference source to render it live")
        return held[(scene, width, spp, depth)]["cpp"]
    with tempfile.TemporaryDirectory() as wd:
        exe = build_reference(ref_src, wd, scene, width, spp, depth)
        out = os.path.join(wd, "out.ppm")
        subprocess.run([exe, out], check=True, timeout=timeout, capture_output=True)
        return stats(read_ppm_ascii(out))


def port_image(scene: str, width: int, spp: int, depth: int, seed: int = 7,
               device=DEFAULT_DEVICE) -> np.ndarray:
    """The port's u8 image of a configuration through the default
    ``Renderer``, on the C++ renderer's pixel grid."""
    from .models.scenes import build
    from .render.renderer import Renderer

    sc, cfg = build(scene, device=device, image_width=width, samples_per_pixel=spp,
                    max_depth=depth)
    cpp_aspect = float(np.float32(cfg.aspect_ratio))
    if cpp_aspect != cfg.aspect_ratio:
        sc, cfg = build(scene, device=device, image_width=width, samples_per_pixel=spp,
                        max_depth=depth, aspect_ratio=cpp_aspect)
    return Renderer(cfg).render(sc, seed=seed).image_u8


def run_config(scene: str, width: int, spp: int, depth: int, mtol: float, nbtol: float,
               seed: int = 7, ref_src: Optional[str] = None, device=DEFAULT_DEVICE) -> dict:
    """One configuration, both renderers' statistics and the verdict."""
    ref = cpp_stats(scene, width, spp, depth, ref_src)
    ours = stats(port_image(scene, width, spp, depth, seed, device))
    if ours["shape"] != ref["shape"]:
        raise ValueError(f"{scene}: pixel grids differ, port {ours['shape']} and C++ "
                         f"{ref['shape']}")
    mean_diff = max(abs(a - b) for a, b in zip(ours["mean"], ref["mean"]))
    nb_diff = abs(ours["nonblack"] - ref["nonblack"])
    return dict(scene=scene, width=width, spp=spp, depth=depth, cpp=ref, port=ours,
                cpp_source="live" if ref_src else "CPP_COMPARE.json",
                mean_abs_diff_u8=round(mean_diff, 3), nonblack_abs_diff=round(nb_diff, 4),
                tol=dict(mean=mtol, nonblack=nbtol),
                **{"pass": bool(mean_diff <= mtol and nb_diff <= nbtol)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracing_tpu_torch.cpp_compare")
    ap.add_argument("--quick", action="store_true",
                    help="one small configuration (needs the reference source)")
    ap.add_argument("--out", default=None, help="also write the results to this JSON file")
    ap.add_argument("--reference-src", default=os.environ.get("RT_REFERENCE_SRC"),
                    help="the C++ reference's src directory, built and run live")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    results = []
    for scene, w, spp, d, mtol, nbtol in (QUICK if args.quick else CONFIGS):
        r = run_config(scene, w, spp, d, mtol, nbtol, ref_src=args.reference_src,
                       device=args.device)
        print(json.dumps(r), flush=True)
        results.append(r)
    ok = all(r["pass"] for r in results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=str(args.device), all_pass=ok, configs=results), f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
