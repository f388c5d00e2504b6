"""The port's wavefront integrator against the JAX package's: the K4 table
lookup (its plain version on the CPU), the Perlin tables and marble
noise, textures, the brute-force closest hit, ``trace`` and the
integrator's decision pass, at the JAX tests' sizes.

Bars. XLA on the CPU contracts multiply-adds into FMAs in jitted code and
the port does not, and XLA's and PyTorch's sin, cos and atan2 differ by
an ulp: the closest hit, textures and noise are held at a few float32
ulps. Inside ``trace`` and ``record_decisions`` a
grazing ray then takes another path. They are held at ROADMAP's parity bar: mean
|Δ| < 1e-3 (2e-3 on bouncing_spheres), segments within max(4, s/200),
winner ids on at most 1% of live slots (tests/test_replay.py); and on
cornell_box and three_spheres max |Δ| < 1e-5 on all but max(4, B/200)
rays (three_spheres: one of 1,152 rays takes another path under FMA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.diff.replay import record_decisions as jrecord
from raytracing_tpu.models.scenes import build as jbuild
from raytracing_tpu.ops import intersect as jint
from raytracing_tpu.ops.table_gather import table_lookup as jlookup
from raytracing_tpu.render.integrator import trace as jtrace
from raytracing_tpu.scene import perlin as jperlin
from raytracing_tpu.scene import textures as jtex
from raytracing_tpu.scene.builder import SceneBuilder as JBuilder
from raytracing_tpu_torch.diff.replay import record_decisions as precord
from raytracing_tpu_torch.ops import intersect as pint
from raytracing_tpu_torch.ops import table_gather as tg
from raytracing_tpu_torch.render import camera as pcam
from raytracing_tpu_torch.render.integrator import trace as ptrace
from raytracing_tpu_torch.scene import perlin as pperlin
from raytracing_tpu_torch.scene import textures as ptex
from raytracing_tpu_torch.scene.builder import SceneBuilder as PBuilder
from torch_parity import FAST_COMPILE, jit_run, port_scene, segments_close, t

torch.set_num_threads(2)
SEED = 3
DEPTH = 6
# name, mean bar, exact (max |Δ| < 1e-5)
TRACE_SCENES = [("three_spheres", 1e-3, True), ("cornell_box", 1e-3, True),
                ("bouncing_spheres", 2e-3, False), ("perlin_sphere", 1e-3, False),
                ("simple_light", 1e-3, False)]
DECISION_SCENES = ["three_spheres", "cornell_box", "bouncing_spheres"]


def camera_rays(scene, cfg, seed=SEED):
    """Camera rays of the whole image, spp samples, made by the port (its
    camera is held to the JAX package's in tests/test_torch_core.py) and
    fed to both packages: (o, d, t, pix, smp) as JAX arrays."""
    n, spp = cfg.n_pixels, cfg.samples_per_pixel
    pix = torch.arange(n, dtype=torch.int32).repeat(spp)
    smp = torch.arange(spp, dtype=torch.int32).repeat_interleave(n)
    cfg_p = pcam.CameraConfig(**vars(cfg))
    o, d, tm = pcam.generate_rays(cfg_p, pcam.derive(cfg_p, pcam.CameraParams.from_config(
        cfg_p, "cpu")), pix, smp, seed, motion_blur=scene.flags.has_moving)
    return tuple(jnp.asarray(x.numpy()) for x in (o, d, tm, pix, smp))


def _pad_tables(scene, n_tex, n_mat):
    """A JAX scene with unused texture and material rows appended up to
    ``n_tex`` and ``n_mat`` rows: the same render, other table shapes."""
    tex, mats = scene.textures, scene.materials

    def pad(a, n, fill=0):
        return jnp.concatenate([a, jnp.full((n - a.shape[0], *a.shape[1:]), fill, a.dtype)])

    return scene.replace(
        textures=tex.replace(ttype=pad(tex.ttype, n_tex), rgb=pad(tex.rgb, n_tex),
                             scale=pad(tex.scale, n_tex), child=pad(tex.child, n_tex),
                             image_id=pad(tex.image_id, n_tex)),
        materials=mats.replace(mtype=pad(mats.mtype, n_mat), tex_id=pad(mats.tex_id, n_mat),
                               fuzz=pad(mats.fuzz, n_mat), ior=pad(mats.ior, n_mat, 1)))


@pytest.fixture(scope="module")
def jax_runs():
    """Per scene: the JAX scene, config, rays and ``trace`` output, and on
    the DECISION_SCENES its recorded ids with the live mask; computed once
    for the module."""
    out = {}
    # the scene is an argument: perlin_sphere, padded to simple_light's
    # table sizes, shares its compilation (the noise makes it the costly one)
    run_trace = jax.jit(lambda scene, bg, *rays: jtrace(scene, *rays, bg, DEPTH,
                                                       jnp.uint32(SEED), remat=False))
    for name, _, _ in TRACE_SCENES:
        sj, cfg = jbuild(name, image_width=24, samples_per_pixel=2, max_depth=DEPTH)
        if name == "perlin_sphere":
            sj = _pad_tables(sj, n_tex=2, n_mat=3)
        rays = camera_rays(sj, cfg)
        bg = jnp.asarray(cfg.background, jnp.float32)
        rad, seg = run_trace.lower(sj, bg, *rays).compile(compiler_options=FAST_COMPILE)(
            sj, bg, *rays)
        out[name] = dict(scene=sj, cfg=cfg, rays=[t(x) for x in rays], rad=np.asarray(rad),
                         seg=int(seg))
        if name in DECISION_SCENES:
            ids, act = jit_run(lambda *a: jrecord(sj, *a, bg, DEPTH, jnp.uint32(SEED),
                                                  return_active=True), *rays)
            out[name].update(ids=np.asarray(ids), act=np.asarray(act))
    return out


# ---------------------------------------------------------------- K4 (plain)

def test_table_lookup_forward_matches_jax():
    before_tg = int(tg.launches)
    rs = np.random.RandomState(0)
    table = rs.rand(128, 5).astype(np.float32)
    ids = rs.randint(-3, 140, 2048).astype(np.int32)  # out-of-range ids clip
    want = np.stack(jlookup(jnp.asarray(table), jnp.asarray(ids)), axis=0)
    got = tg.table_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.shape == (5, 2048)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tg.gather(torch.from_numpy(table), torch.from_numpy(ids)),
                                  want)
    assert int(tg.launches) == before_tg  # CPU tensors run the plain version


def test_table_lookup_backward_matches_jax():
    rs = np.random.RandomState(2)
    table = rs.rand(128, 4).astype(np.float32)
    ids = rs.randint(0, 128, 1024).astype(np.int32)
    w = rs.rand(4, 1024).astype(np.float32)
    g_jax = jax.grad(lambda tb: jnp.sum(jnp.stack(jlookup(tb, jnp.asarray(ids))) * w))(
        jnp.asarray(table))
    tb = torch.from_numpy(table).requires_grad_(True)
    (tg.table_lookup(tb, torch.from_numpy(ids)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(g_jax), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- Perlin and textures

@pytest.mark.parametrize("seed", [0, 11])
def test_perlin_tables_and_marble_match_jax(seed):
    tj, tp = jperlin.make_tables(seed), pperlin.make_tables(seed, device="cpu")
    for f in ("randvec", "perm_x", "perm_y", "perm_z"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(tj, f)))
    p = (np.random.default_rng(seed).normal(size=(512, 3)) * 6.0).astype(np.float32)
    scale = np.float32(4.0)
    np.testing.assert_allclose(pperlin.marble(tp, t(p), torch.tensor(scale)).numpy(),
                               np.asarray(jperlin.marble(tj, jnp.asarray(p), scale)),
                               atol=1e-6)


def _texture_scene(builder, bilinear):
    """Solid, a checker of checkers and an image (marble is held above)."""
    b = builder()
    img = np.random.default_rng(5).random((6, 9, 3)).astype(np.float32)
    inner = b.checker(0.5, (0.1, 0.2, 0.3), (0.9, 0.8, 0.7))
    b.sphere((0, 0, -1), 0.5, b.lambertian(b.checker(2.0, inner, (0.4, 0.5, 0.6))))
    b.sphere((2, 0, -1), 0.5, b.lambertian(b.image(img)))
    b.sphere((3, 0, -1), 0.5, b.lambertian((0.2, 0.7, 0.1)))
    if builder is JBuilder:
        return b.compile(use_bvh=False, image_bilinear=bilinear)
    return b.compile(device="cpu", image_bilinear=bilinear)


@pytest.mark.parametrize("bilinear", [False, True])
def test_eval_texture_matches_jax(bilinear):
    sj, sp = _texture_scene(JBuilder, bilinear), _texture_scene(PBuilder, bilinear)
    rng = np.random.default_rng(7)
    B = 600
    tex = rng.integers(0, int(sp.textures.ttype.shape[0]), B).astype(np.int32)
    u, v = rng.random(B).astype(np.float32), rng.random(B).astype(np.float32)
    p = (rng.normal(size=(B, 3)) * 3.0).astype(np.float32)
    want = np.asarray(jit_run(lambda *a: jtex.eval_texture(sj, *a),
                              *(jnp.asarray(x) for x in (tex, u, v, p))))
    got = ptex.eval_texture(sp, *(t(x) for x in (tex, u, v, p))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------- closest hit

@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_closest_hit_matches_jax(name):
    """Random rays through the scene's bounding region: the same winners,
    t and attributes."""
    sj, _ = jbuild(name)
    sp = port_scene(sj)
    rng = np.random.default_rng(1)
    B = 512
    if name == "cornell_box":
        o = rng.uniform(50, 500, (B, 3)).astype(np.float32)
    else:
        o = np.concatenate([rng.uniform(-8, 8, (B, 1)), rng.uniform(0.5, 3, (B, 1)),
                            rng.uniform(-8, 8, (B, 1))], 1).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    tm = rng.random(B).astype(np.float32)
    hj = jit_run(lambda *a: jint.closest_hit_brute(sj, *a),
                 *(jnp.asarray(x) for x in (o, d, tm)))
    hp = pint.closest_hit_brute(sp, t(o), t(d), t(tm))
    assert hp.valid.float().mean() > 0.3
    # the same winner on all but max(4, B/200) rays: a ray through a quad's
    # edge or grazing a sphere can flip on XLA's FMA rounding
    same = (hp.prim_id.numpy() == np.asarray(hj.prim_id))
    assert (~same).sum() <= max(4, B // 200), (~same).sum()
    np.testing.assert_array_equal(hp.mat_id.numpy()[same], np.asarray(hj.mat_id)[same])
    # XLA's FMA contraction rounds the discriminant differently; a grazing
    # hit amplifies that (t within 1e-5 relative), and bouncing_spheres'
    # r = 1000 ground sphere (id 0) cancels ~3 digits in |oc|² - r² (1e-4)
    ground = (hp.prim_id == 0).numpy() if name == "bouncing_spheres" else np.zeros(B, bool)
    for sel, rtol in ((same & ~ground, 2e-5), (same & ground, 2e-4)):
        np.testing.assert_allclose(hp.t.numpy()[sel], np.asarray(hj.t)[sel], rtol=rtol)
    # the attributes from the same t and winners (XLA fuses p = o + t·d into
    # an FMA; the normal (p - c)/r scales that ulp by 1/r = 5 on r = 0.2)
    ha = pint.hit_attributes(sp, t(o), t(d), t(tm), t(hj.t), t(hj.prim_id))
    np.testing.assert_array_equal(ha.front_face.numpy(), np.asarray(hj.front_face))
    np.testing.assert_allclose(ha.p.numpy(), np.asarray(hj.p), rtol=1e-6,
                               atol=1e-6 * float(np.abs(o).max()))
    for f in ("normal", "u", "v"):
        np.testing.assert_allclose(getattr(ha, f).numpy(), np.asarray(getattr(hj, f)),
                                   atol=1e-5, err_msg=f)


def test_closest_hit_ties_take_the_lowest_index():
    """Coincident spheres: every ray's winner is the first of them, as
    ``jnp.argmin`` picks the first of equal minima."""
    scenes = []
    for builder in (JBuilder, PBuilder):
        b = builder()
        for k in range(3):
            b.sphere((0.0, 0.0, -3.0), 1.0, b.lambertian((0.2 * k, 0.5, 0.5)))
        scenes.append(b.compile(use_bvh=False) if builder is JBuilder else
                      b.compile(device="cpu"))
    rng = np.random.default_rng(3)
    d = np.concatenate([rng.uniform(-0.2, 0.2, (64, 2)), -np.ones((64, 1))], 1).astype(
        np.float32)
    o, tm = np.zeros((64, 3), np.float32), np.zeros(64, np.float32)
    hj = jit_run(lambda *a: jint.closest_hit_brute(scenes[0], *a),
                 *(jnp.asarray(x) for x in (o, d, tm)))
    hp = pint.closest_hit_brute(scenes[1], t(o), t(d), t(tm))
    assert bool(hp.valid.all()) and bool((hp.prim_id == 0).all())
    np.testing.assert_array_equal(hp.prim_id.numpy(), np.asarray(hj.prim_id))


# ---------------------------------------------------- trace and decisions

@pytest.mark.parametrize("name,mean_bar,exact", TRACE_SCENES)
def test_trace_matches_jax(jax_runs, name, mean_bar, exact):
    r = jax_runs[name]
    sp = port_scene(r["scene"])
    rad, seg = ptrace(sp, *r["rays"], r["cfg"].background, DEPTH, SEED)
    assert seg.dtype == torch.int64 and seg.dim() == 0, seg
    assert segments_close(r["seg"], int(seg)), (r["seg"], int(seg))
    diff = np.abs(rad.numpy() - r["rad"])
    assert diff.mean() < mean_bar, diff.mean()
    if exact:
        assert diff.max() < 1e-5, diff.max()


@pytest.mark.parametrize("name", DECISION_SCENES)
def test_record_decisions_match_jax(jax_runs, name):
    r = jax_runs[name]
    sp = port_scene(r["scene"])
    ids, act = precord(sp, *r["rays"], r["cfg"].background, DEPTH, SEED, return_active=True)
    assert ids.dtype == torch.int32 and ids.shape == r["ids"].shape
    live = r["act"] & act.numpy()
    mismatch = ((ids.numpy() != r["ids"]) & live).sum()
    assert mismatch <= max(4, int(0.01 * live.sum())), (mismatch, live.sum())


def test_trace_modes_and_active0(jax_runs):
    """``mode="while"`` stops early with the same result; dead rays in
    ``active0`` trace nothing and add nothing."""
    r = jax_runs["cornell_box"]
    sp = port_scene(r["scene"])
    args = (sp, *r["rays"], r["cfg"].background, DEPTH, SEED)
    rad, seg = ptrace(*args)
    rad_w, seg_w = ptrace(*args, mode="while")
    assert torch.equal(rad, rad_w) and int(seg) == int(seg_w)
    alive = torch.arange(rad.shape[0]) % 3 != 0
    rad_a, seg_a = ptrace(*args, active0=alive)
    assert torch.equal(rad_a[alive], rad[alive]) and not rad_a[~alive].any()
    assert int(seg_a) < int(seg)
