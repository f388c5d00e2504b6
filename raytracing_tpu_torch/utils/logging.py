"""Structured logging, the counterpart of ``raytracing_tpu.utils.logging``:
JSONL event records (scene compile stats, per-render rays/s) with a console
mirror on stderr."""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Optional, TextIO


class JsonlLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._fh: Optional[TextIO] = open(path, "a") if path else None
        self.echo = echo

    def log(self, event: str, **fields: Any) -> None:
        line = json.dumps({"ts": time.time(), "event": event, **fields})
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def scene_stats(scene) -> dict:
    """Compile-time stats of a scene (the JAX package's dict, key for key)."""
    stats = {
        "n_spheres": int(scene.n_spheres),
        "n_quads": int(scene.n_quads),
        "n_materials": int(scene.materials.mtype.shape[0]),
        "n_textures": int(scene.textures.ttype.shape[0]),
        "has_bvh": scene.bvh is not None,
        "flags": dict(scene.flags._asdict()),
    }
    if scene.bvh is not None:
        prim = scene.bvh.prim
        stats["bvh_nodes"] = int(prim.shape[0])
        stats["bvh_leaves"] = int((prim >= 0).sum())
    return stats
