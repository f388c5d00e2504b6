"""raytracing_tpu_torch scenes against raytracing_tpu: the port's builder
and flatten must produce exactly the JAX package's arrays and K1 tables,
both for scenes built by the port's registry and for JAX-built scenes
converted through scene_from_arrays."""
import numpy as np
import pytest
import torch

from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.ops.megakernel import build_mega_scene as jmega
from raytracing_tpu.scene import assets as jassets
from raytracing_tpu.scene import flatten as jfl
from raytracing_tpu_torch.models.scenes import build as pbuild
from raytracing_tpu_torch.ops.megakernel import build_mega_scene as pmega
from raytracing_tpu_torch.scene import assets as passets
from raytracing_tpu_torch.scene import flatten as pfl
from raytracing_tpu_torch.scene.builder import SceneBuilder
from torch_parity import port_scene, scene_arrays

torch.set_num_threads(2)
SCENES = ["bouncing_spheres", "three_spheres", "checkered_spheres", "quads",
          "cornell_box", "single_sphere", "perlin_sphere", "simple_light", "earth"]


def _tables(flatten, scene):
    sph, quad, ns, nq, ns_pad = flatten.sweep_tables(scene)
    table, ns_pad_u, nq_u, supported = flatten.unified_table(scene)
    return dict(sph=sph, quad=quad, counts=np.array([ns, nq, ns_pad, ns_pad_u, nq_u]),
                resolve=table[:pfl.RESOLVE_FIELDS], table=table,
                supported=np.array(supported), kid=flatten.global_id_map(scene))


@pytest.mark.parametrize("name", SCENES)
def test_tables_equal_jax(name):
    sj, cfg_j = jbuild(name)
    sp, cfg_p = pbuild(name, device="cpu")
    assert cfg_p == type(cfg_p)(**vars(cfg_j))
    ref = _tables(jfl, sj)
    # the port's own builder: the same scene arrays ...
    arrays_j = scene_arrays(sj)
    for key, value in scene_arrays(sp).items():
        np.testing.assert_array_equal(value, arrays_j[key], err_msg=key)
    assert sp.flags == type(sp.flags)(*sj.flags)
    # ... and the same tables, from its own scene and from the JAX scene
    for scene in (sp, port_scene(sj)):
        out = _tables(pfl, scene)
        for key in ref:
            np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box"])
def test_mega_scene_matches_jax_kernel_tables(name):
    """K1's inputs: sweep tables as in the JAX MegaScene, and the plain
    resolve table equal to one row of each field of its ×8 replicated
    table (spheres are not reordered in these small scenes)."""
    sj, _ = jbuild(name)
    mj = jmega(sj)
    mp = pmega(port_scene(sj))
    np.testing.assert_array_equal(mp.sph_sweep.numpy(), np.asarray(mj.sph_sweep))
    np.testing.assert_array_equal(mp.quad_sweep.numpy(), np.asarray(mj.quad_sweep))
    p = mp.resolve.shape[1]
    rep = np.asarray(mj.tabt_rep)[: 8 * pfl.RESOLVE_FIELDS: 8, :p]
    np.testing.assert_array_equal(mp.resolve.numpy(), rep)
    assert (mp.n_sph, mp.n_quad, mp.n_sph_pad) == (mj.n_sph, mj.n_quad, mj.n_sph_pad)


@pytest.mark.parametrize("name", ["perlin_sphere", "earth"])
def test_kernel_texture_tables_equal_jax(name):
    """The kernels' marble and image tables: the JAX package's Perlin rows
    and atlas rows (R, G, B of the row-major texels) without their
    padding; the MegaScene carries them."""
    sj, _ = jbuild(name)
    sp, _ = pbuild(name, device="cpu")
    perm_j, vec_j = jfl.perlin_tables(sj)
    perm, vec = pfl.perlin_tables(sp)
    np.testing.assert_array_equal(perm, perm_j[:3].astype(np.int32))
    np.testing.assert_array_equal(vec, vec_j[:3].T)
    atlas = pfl.atlas_texels(sp)
    mega = pmega(sp)
    if name == "earth":
        ref, bases, ok = jfl.atlas_table(sj, max_texels=1 << 24)
        assert ok and bases == [0] and atlas.shape == (1024 * 512, 3)
        np.testing.assert_array_equal(atlas.T, ref[:3, :atlas.shape[0]])
        np.testing.assert_array_equal(mega.atlas.numpy(), atlas)
        assert mega.has_image and not mega.has_noise
    else:
        np.testing.assert_array_equal(mega.perm.numpy(), perm)
        np.testing.assert_array_equal(mega.grad.numpy(), vec)
        assert mega.has_noise and not mega.has_image


def test_atlas_base_limit(monkeypatch):
    """An atlas whose base texels an f32 column cannot hold is refused
    (from 2^24 texels; lowered here to 16)."""
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(np.zeros((4, 4, 3), np.float32))))
    scene = b.compile(device="cpu")
    assert pfl.atlas_texels(scene).shape == (16, 3)
    monkeypatch.setattr(pfl, "MAX_ATLAS_TEXELS", 16)
    with pytest.raises(ValueError, match="atlas"):
        pmega(scene)


def test_assets_equal_jax(tmp_path, capsys):
    """The port's copy of the asset loader: the same probe, PPM decode, u8
    round trip, generator stream and magenta sentinel as the JAX
    package's."""
    for shape in ((90, 180), (16, 24)):
        np.testing.assert_array_equal(passets.generate_earthlike(*shape),
                                      jassets.generate_earthlike(*shape))
    path = passets.find_image("earthmap.ppm")
    assert path is not None and path == jassets.find_image("earthmap.ppm")
    img = passets.load_image("earthmap.ppm")
    assert img.shape == (512, 1024, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, jassets.load_image("earthmap.ppm"))
    ascii_ppm = tmp_path / "tiny.ppm"
    ascii_ppm.write_text("P3\n# two texels\n2 1\n255\n255 0 0  0 128 255\n")
    np.testing.assert_array_equal(passets.read_ppm(str(ascii_ppm)),
                                  jassets.read_ppm(str(ascii_ppm)))
    missing = passets.load_image("no_such_image.jpg")
    np.testing.assert_array_equal(missing, jassets.MAGENTA)
    assert "could not load image file" in capsys.readouterr().err
    b = SceneBuilder()
    tex = b.image("earthmap.ppm")  # a file name, probed and decoded
    assert b.tex_image[tex] == 0
    np.testing.assert_array_equal(b.images[0], img)


def test_find_image_stays_in_its_directories(tmp_path, monkeypatch):
    """The port drops the reference's walk up to 6 parent ``images/``
    directories: an image above the working directory is not found, one in
    its ``images/`` or under ``$RTW_IMAGES`` is, and the repository's
    ``images/`` serves any working directory."""
    (tmp_path / "images").mkdir()
    (tmp_path / "images" / "above.ppm").write_text("P3\n1 1\n255\n1 2 3\n")
    work = tmp_path / "a" / "b"
    (work / "images").mkdir(parents=True)
    (work / "images" / "here.ppm").write_text("P3\n1 1\n255\n4 5 6\n")
    monkeypatch.chdir(work)
    monkeypatch.delenv("RTW_IMAGES", raising=False)
    assert passets.find_image("above.ppm") is None
    assert passets.find_image("here.ppm") == "images/here.ppm"
    assert passets.find_image("earthmap.ppm").endswith("images/earthmap.ppm")
    monkeypatch.setenv("RTW_IMAGES", str(tmp_path / "images"))
    assert passets.find_image("above.ppm") == str(tmp_path / "images" / "above.ppm")


def test_translate_box_and_noise_flags():
    b = SceneBuilder()
    white = b.lambertian((0.7, 0.7, 0.7))
    with b.translate((130, 0, 65)):
        b.box((0, 0, 0), (165, 165, 165), white)
        with b.translate((1, 2, 3)):
            b.sphere((0, 0, 0), 1.0, b.lambertian(b.noise(4.0)), center2=(0, 1, 0))
    scene = b.compile(device="cpu")
    assert scene.n_quads == 8 and b.n_quads == 6
    np.testing.assert_array_equal(scene.quads.q[0].numpy(), [130, 0, 230])
    np.testing.assert_array_equal(scene.spheres.center[0].numpy(), [131, 2, 68])
    assert scene.flags.has_noise and scene.flags.has_moving
    mega = pmega(scene)
    assert mega.has_noise and mega.moving


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point builds on the card unless told otherwise: where
    CUDA is unavailable, a call with no device raises instead of falling
    back to the CPU."""
    from raytracing_tpu_torch.render.camera import CameraParams
    from raytracing_tpu_torch.scene.convert import camera_params_from_arrays, scene_from_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sj, cfg = jbuild("three_spheres")
    calls = [lambda: pbuild("three_spheres"), lambda: SceneBuilder().compile(),
             lambda: CameraParams.from_config(cfg),
             lambda: scene_from_arrays(scene_arrays(sj)),
             lambda: camera_params_from_arrays({k: getattr(cfg, k) for k in (
                 "lookfrom", "lookat", "vup", "vfov", "defocus_angle", "focus_dist")})]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            call()
    scene, _ = pbuild("three_spheres", device="cpu")
    assert scene.spheres.center.device.type == "cpu"
