"""The port's CLI (``python -m raytracing_tpu_torch.cli``) and ``entry()``
against the JAX package's: a ``render`` on the CPU whose PPM matches the
JAX CLI's at the same flags (brute force; mean |Δ| ≤ 1 level), its log
and checkpoint, ``scenes``, the refused flags, ``--devices`` against the
single-device command, and ``entry()``."""
import json
import os

import numpy as np
import pytest
import torch

from raytracing_tpu.cli import main as jmain
from raytracing_tpu_torch import cli
from raytracing_tpu_torch.entry import entry
from raytracing_tpu_torch.scene.assets import read_ppm
from raytracing_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)
FLAGS = ["--scene", "three_spheres", "--width", "32", "--spp", "2", "--depth", "3",
         "--seed", "4", "--hit", "brute", "--mode", "scan"]


def test_render_matches_jax_cli(tmp_path, capsys):
    """``render --device cpu`` writes a PPM within one level of the JAX
    CLI's on average, logs its segments and prints the countdown."""
    out, ref = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
    log = str(tmp_path / "log.jsonl")
    assert cli.main(["render", *FLAGS, "--out", out, "--device", "cpu", "--log", log]) == 0
    assert jmain(["render", *FLAGS, "--out", ref]) == 0
    img, img_ref = read_ppm(out), read_ppm(ref)
    assert img.shape == img_ref.shape == (18, 32, 3)
    assert float(np.abs(img.astype(np.int32) - img_ref.astype(np.int32)).mean()) <= 1.0
    assert 10 < float(img.mean()) < 245
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [r["event"] for r in recs] == ["scene_compiled", "render_done"]
    assert recs[1]["segments"] > 0 and recs[1]["hit_method"] == "brute"
    assert recs[0]["n_spheres"] == 8 and recs[0]["has_bvh"] is False
    printed = capsys.readouterr().out
    assert "sample chunks remaining: 0" in printed and "Done." in printed


def test_render_checkpoint_and_auto_prefix(tmp_path):
    """``--checkpoint`` writes the state after every sample chunk; a rerun
    resumes from it (here: nothing left to trace) and writes the same
    image. ``--auto-prefix`` plans prefixes on the megakernel's phased
    launches and renders the image it renders without them."""
    ck, a, b = (str(tmp_path / n) for n in ("ck.npz", "a.ppm", "b.ppm"))
    args = ["render", "--scene", "single_sphere", "--width", "16", "--spp", "3", "--depth",
            "14", "--device", "cpu", "--checkpoint", ck]
    assert cli.main([*args, "--out", a]) == 0
    state = ckpt.load_render_state(ck)
    assert state["schunk"] == 1 and state["accum"].shape == (1024, 3)
    assert cli.main([*args, "--out", b]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    c = str(tmp_path / "c.ppm")
    assert cli.main(["render", "--scene", "single_sphere", "--width", "16", "--spp", "3",
                     "--depth", "14", "--device", "cpu", "--auto-prefix", "--out", c]) == 0
    np.testing.assert_array_equal(read_ppm(c), read_ppm(a))


def test_scenes_lists_the_jax_names(capsys):
    """Every JAX scene, and the port's own next_week_final (participating
    media, which the JAX package does not have)."""
    from raytracing_tpu.models.scenes import SCENES as JSCENES

    assert cli.main(["scenes"]) == 0
    assert capsys.readouterr().out.split() == sorted([*JSCENES, "next_week_final"])


@pytest.mark.parametrize("flags,why", [
    (["--clusters", "slab"], "cluster culling"),
    (["--sort-regions", "4"], "regional"),
    (["--ray-order", "pixel"], "sample-major"),
    (["--spp-chunk", "2"], "sample-major"),
    (["--devices", "2", "--schedule", "pool"], "single-device Renderer"),
])
def test_refused_flags(tmp_path, capsys, flags, why):
    """Flags for what the port leaves out exit non-zero, saying why, and
    render nothing."""
    out = str(tmp_path / "x.ppm")
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--scene", "single_sphere", "--device", "cpu", "--out", out,
                  *flags])
    assert e.value.code != 0
    assert why in capsys.readouterr().err
    assert not os.path.exists(out)


def test_devices_matches_single_device(tmp_path):
    """``--devices 2`` on the CPU (two gloo ranks, a dp mesh) writes the
    PPM the single-device command writes, byte for byte, and logs the
    backend and the same segments."""
    args = ["render", "--scene", "three_spheres", "--width", "32", "--spp", "2", "--depth",
            "4", "--seed", "3", "--device", "cpu"]
    one, two = str(tmp_path / "one.ppm"), str(tmp_path / "two.ppm")
    log1, log2 = str(tmp_path / "one.jsonl"), str(tmp_path / "two.jsonl")
    assert cli.main([*args, "--out", one, "--log", log1]) == 0
    assert cli.main([*args, "--devices", "2", "--out", two, "--log", log2]) == 0
    assert open(one, "rb").read() == open(two, "rb").read()
    with open(log1) as f1, open(log2) as f2:
        done1, done2 = (json.loads(f.readlines()[-1]) for f in (f1, f2))
    assert done2["segments"] == done1["segments"] > 0
    assert (done2["devices"], done2["backend"], done2["hit_method"]) == (2, "gloo", "mega")


def test_entry_cpu():
    """``entry()``: bouncing_spheres through ``render_once``, finite, with
    autograd to the scene; the card is the default device."""
    forward, (scene, params) = entry(device="cpu", image_width=16)
    img = forward(scene, params)
    assert img.shape == (9, 16, 3) and bool(torch.isfinite(img).all())
    assert 0.05 < float(img.mean()) < 1.0
    rgb = scene.textures.rgb.clone().requires_grad_()
    scene.textures.rgb = rgb
    forward(scene, params).mean().backward()
    assert rgb.grad is not None and float(rgb.grad.abs().sum()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
