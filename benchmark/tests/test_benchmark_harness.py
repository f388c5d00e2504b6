"""The harness on the CPU: the import guard, the byte counts, discovery by
name, the result line's schema, the refusal without a card, and planted
faults in the timed path that the check must catch."""
import json
import math
import subprocess
import sys

import pytest
import torch

from benchmark.common import guard, harness, roofline
from small import ROOT, run_small, small_copy

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["raytracing_tpu.x", "raytracing_tpu_torch.x", "os"]) == [
        "raytracing_tpu.x"]
    assert guard.forbidden(["raytracing_tpu_torch", "raytracing_tpu_torch.render.graphs",
                            "jaxtyping", "flaxen"]) == []
    assert guard.forbidden(["jax.numpy", "jaxlib", "flax.linen", "raytracing_tpu"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "raytracing_tpu"]


def test_byte_counts_follow_the_shapes():
    B, D = 360_448, 20
    out = 4 * D * roofline.NG * B
    assert out == 547_880_960
    assert roofline.k2_bytes(B, D, 0, 512) - roofline.k2_bytes(B, D, 0, 512) + out == out
    total = roofline.k2_bytes(B, D, 968_783, roofline.table_rows(486, 0))
    assert total == out + B * 56 + 4 * 968_783 + 4 * 512 * 23
    assert abs(total / roofline.PEAK_BYTES_PER_S * 1e3 - 0.1707) < 5e-4
    assert roofline.table_rows(486, 0) == 512 and roofline.table_rows(0, 18) == 128
    assert roofline.fold_bytes(979_968, 512) == 4 * (979_968 * 20 + 512 * 19)
    assert roofline.share_pct(roofline.PEAK_BYTES_PER_S, 2.0) == 50.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_every_metric_has_a_reader_that_agrees_with_benchmark_json():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_file("metrics", m["name"]).read), m["name"]
    for w in spec["workloads"]:
        cell = harness.Cell(spec, w["name"])
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)


def test_a_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and a cell that exist only
    as new files and entries in a copy are run by name."""
    bench = small_copy(tmp_path)
    conf = json.loads((bench / "configs" / "cornell_box.json").read_text())
    conf["name"] = "cornell_copy"
    (bench / "configs" / "cornell_copy.json").write_text(json.dumps(conf))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(dict(
        job="render", image_width=16, samples_per_pixel=2, max_depth=5, renderer={},
        check_pixels=10**6, trace_items=1)))
    (bench / "metrics" / "images_in_window.py").write_text(
        'def read(ctx):\n    return float(ctx["items"])\n')
    (bench / "limits" / "cornell_copy.tiny.json").write_text(
        (bench / "limits" / "cornell_box.render.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="cornell_copy", source="x", file="benchmark/configs/"
                                "cornell_copy.json", reduced=[], why="test"))
    spec["workloads"].append(dict(name="cornell_copy.tiny", config="cornell_copy",
                                  traffic="tiny", chips=1, why="test"))
    for m in spec["end_to_end"]:
        if m["name"] == "render_samples_per_s":
            m["workloads"].append("cornell_copy.tiny")
    spec["per_layer"].append(dict(name="images_in_window", unit="count", better="higher",
                                  source="host_clock", layer="end to end",
                                  moves="render_samples_per_s",
                                  workloads=["cornell_copy.tiny"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for trace in (False, True):
        out = run_small(bench, "cornell_copy.tiny", trace=trace)
        assert all(k in out for k in KEYS) and list(out)[-1] == "checks"
        assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
        if trace:
            assert out["metrics"]["images_in_window"]["value"] == out["attempted"]
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(out["metrics"]) == {"render_samples_per_s", "setup_s"}
        json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("cell", ["bouncing_spheres.final_render", "cornell_box.render",
                                  "bouncing_spheres.grad_sweep", "bouncing_spheres.final_grad"])
def test_sound_small_runs_are_correct(tmp_path, cell):
    out = run_small(small_copy(tmp_path), cell)
    assert out["correct"], out["checks"]


def test_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device: exit code 2 and no result; so also in a directory
    that holds only BENCHMARK.json and benchmark/ (no port to import)."""
    small_copy(tmp_path)
    for cwd in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "bouncing_spheres.grad_sweep", "--seed", str(2**40), "--seconds", "1",
                            "--trace", "0"], cwd=cwd, capture_output=True, text=True)
        if torch.cuda.is_available() and cwd == ROOT:
            continue
        assert r.returncode != 0 and r.stdout.strip() == "", (r.stdout, r.stderr)


# faults planted in the timed path, each of which the check must catch
def _render_fault(kind):
    from raytracing_tpu_torch.render import renderer

    orig = renderer.trace_megakernel

    def broken(mega, o, d, t, pix, smp, *a, **kw):
        out = list(orig(mega, o, d, t, pix, smp, *a, **kw))
        rad = out[0]
        if kind == "state_unchanged":      # a launch adds nothing to the image
            rad = torch.zeros_like(rad)
        elif kind == "half_the_batch":     # odd samples dropped, the rest doubled
            rad = torch.where((smp % 2 == 0)[:, None], 2 * rad, 0.0)
        elif kind == "answer_altered":     # sample 0's radiance altered where it is made
            rad = torch.where((smp == 0)[:, None], rad + 0.25, rad)
        out[0] = rad
        return tuple(out)

    return renderer, "trace_megakernel", broken


def _grad_fault(kind):
    from raytracing_tpu_torch import bench
    from raytracing_tpu_torch.render import graphs

    if kind == "answer_altered":           # the table's cotangent altered where it is made
        orig = bench.replay_grads_sorted

        def broken(*a, **kw):
            tbar, ok = orig(*a, **kw)
            return tbar * 1.01, ok

        return bench, "replay_grads_sorted", broken
    orig = graphs.over_chunks

    def broken(slot, key, make_state, step, first, n, device, fused):
        if key[0] != "sweep":
            return orig(slot, key, make_state, step, first, n, device, fused)
        if kind == "state_unchanged":      # no chunk updates the sums
            return orig(slot, key, make_state, step, first, 0, device, fused)
        st, spent = orig(slot, key, make_state, step, first, n // 2, device, fused)
        for v in st.values():              # half the chunks, scaled to the whole
            if v.is_floating_point():
                v.mul_(2.0)
        return st, spent

    return graphs, "over_chunks", broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["bouncing_spheres.final_render", "cornell_box.render",
                                  "bouncing_spheres.grad_sweep", "bouncing_spheres.final_grad"])
def test_a_fault_in_the_timed_path_reads_not_correct(tmp_path, monkeypatch, cell, kind):
    bench = small_copy(tmp_path)
    module, name, broken = (_grad_fault if "grad" in cell else _render_fault)(kind)
    monkeypatch.setattr(module, name, broken)
    out = run_small(bench, cell)
    assert out["correct"] is False and out["failed"] == out["attempted"], out["checks"]
    assert any(not math.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in out["checks"].values())
