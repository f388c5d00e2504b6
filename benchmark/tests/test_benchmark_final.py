"""The cells with participating media and through the pool, at small sizes on
the CPU: each run is correct, and the trace run reads the per-layer
metrics its cell lists (the media's share of segments above 0)."""
import json
import shutil

import pytest

from small import ROOT, SMALL, run_small, small_copy

SMALL_FINAL = {
    "final_800": dict(image_width=24, samples_per_pixel=4, max_depth=12, check_pixels=10**6,
                      trace_items=1),
    "final_render_pool": dict(SMALL["final_render"]),
}


@pytest.mark.parametrize("cell", ["next_week_final.final_800",
                                  "bouncing_spheres.final_render_pool"])
def test_small_runs_are_correct_and_read_their_metrics(tmp_path, cell):
    bench = small_copy(tmp_path)
    shutil.copytree(ROOT / "images", tmp_path / "images")  # the earth's texels
    mix = cell.split(".")[1]
    p = bench / "traffic" / f"{mix}.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **SMALL_FINAL[mix]}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in spec["per_layer"] if cell in m.get("workloads", [cell])}
    for trace in (False, True):
        out = run_small(bench, cell, trace=trace)
        assert out["correct"], out["checks"]
        if trace:
            # the device-trace metrics read nothing on the CPU
            read = set(out["metrics"])
            assert read <= listed and "k1_launches_per_image.render" in read
            if cell.startswith("next_week_final"):
                assert out["metrics"]["medium_segment_pct.final"]["value"] > 0
        else:
            assert set(out["metrics"]) == {"render_samples_per_s", "setup_s"}
