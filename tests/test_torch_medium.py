"""The port's participating media against the JAX package's: the media
tables of the scene build, the phase functions, the medium queries and
tracking loops, and the path tracer in media.

Tables and world bounds bit for bit (the bounds grow by a medium box that
sticks out of the geometry). Phase functions and medium queries at rtol
1e-5 / atol 1e-6 on seeded inputs; the delta- and ratio-tracking loops
(sample_distance, transmittance) give RNG states and interaction masks bit
for bit, and t, p and weights at that tolerance, for a homogeneous fog, a
density grid and two overlapping volumes. pt_radiance in fog returns the
RNG states bit for bit.

The path tracer mirrors tests/test_media.py's seven cases on the slab
scene (absorption, chromatic absorption, a grid against the homogeneous
medium, a zero-density grid, scattering in the furnace, single scattering,
the HG phase) pass for pass against the JAX PathTracer: the film within a
mean relative error of 0.5% (test_torch_path.py's bound: float drift can
flip a rare roulette or tracking draw), then the JAX test's own physical
check on the port's image where it is cheap. Their live-ray counts are not
compared: the black emitter's NEE samples points in the hit's own plane.
The two scattering slabs hold the film's mean instead (COUPLED says why). The slice itself: PathTracer
on fog_cornell 16x16, depth 6, 2 passes, against the JAX PathTracer, with
the live-ray counts within 0.1%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import medium as jmed
from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.models import phase as jphase
from cudatracerlib_tpu.models import tracer as jtracer
from cudatracerlib_tpu.scene import host as jhost, schema as jschema
from cudatracerlib_tpu.scene import sensors as jsensors, shapes as jshapes
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import medium as tmed
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import phase as tphase
from cudatracerlib_tpu_torch.models import tracer as ttracer
from cudatracerlib_tpu_torch.scene import host as thost, schema as tschema
from cudatracerlib_tpu_torch.scene import sensors as tsensors, shapes as tshapes
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
N = 4096
JPKG = (jhost, jschema, jsensors, jshapes, jtf, jscenes)
TPKG = (thost, tschema, tsensors, tshapes, ttf, tscenes)


def _slab(pkg, sigma_a, sigma_s, g=0.0, density=None, emitter_radiance=2.0,
          size=24):
    """tests/test_media.py's _slab_scene: camera -> a 1-unit-thick medium
    slab -> an emissive wall."""
    host, schema, sensors, shapes, tf, _ = pkg
    sc = host.DynamicScene()
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(shapes.rectangle(), black,
                   tf.compose(tf.translate([0, 0, 2]), tf.rotate_deg([0, 1, 0], 180),
                              tf.scale(8)),
                   emission=(emitter_radiance,) * 3)
    m2w = tf.compose(tf.translate([-2, -2, 0]), tf.scale([4, 4, 1]))
    if density is None:
        sc.add_homogeneous_medium(sigma_a, sigma_s, m2w, phase_g=g)
    else:
        sc.add_grid_medium(density, sigma_a, sigma_s, m2w, phase_g=g)
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0, -2], [0, 0, 1]),
        fov_x_deg=20, film_w=size, film_h=size))
    return sc


def _furnace(pkg):
    """tests/test_media.py's scattering furnace: a purely scattering cube
    inside the furnace, the probe sphere removed."""
    _, _, _, _, tf, scenes = pkg
    sc = scenes.furnace(24, 24, albedo=0.0)
    m2w = tf.compose(tf.translate([-1.5, -1.5, -1.5]), tf.scale(3.0))
    sc.add_homogeneous_medium((0, 0, 0), (1.2, 1.2, 1.2), m2w, phase_g=0.3)
    sc._nodes = [n for n in sc._nodes if n.name != "probe"]
    return sc


def _overlap(pkg):
    """Two overlapping volumes, a grid and a homogeneous box that sticks out
    of the Cornell box (the world bounds grow)."""
    host, schema, sensors, shapes, tf, scenes = pkg
    sc = scenes.cornell_box(16, 16, spheres=False)
    dens = np.random.default_rng(3).random((5, 6, 7)).astype(np.float32) * 2.0
    sc.add_grid_medium(dens, (0.1, 0.2, 0.3), (0.5, 0.4, 0.3),
                       tf.compose(tf.translate([-0.8, -0.9, -0.7]), tf.scale(1.5)),
                       phase_type=0, phase_g=0.4)
    sc.add_homogeneous_medium((0.05,) * 3, (0.2, 0.3, 0.4),
                              tf.compose(tf.translate([-0.3, -0.4, -2.5]),
                                         tf.scale([0.9, 0.8, 3.0])),
                              phase_type=3)
    return sc


GRID = np.random.default_rng(11).random((6, 5, 4)).astype(np.float32) * 1.5
SCENES = {
    "fog": lambda pkg: pkg[5].fog_cornell(16, 16),
    "grid_slab": lambda pkg: _slab(pkg, (0.3, 0.2, 0.1), (0.6, 0.5, 0.4), g=0.5,
                                   density=GRID),
    "overlap": _overlap,
}


def _both(name):
    return SCENES[name](JPKG).build(), SCENES[name](TPKG).build("cpu")


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_media_tables(name):
    jsc, tsc = _both(name)
    for f in jsc.media._fields:
        a, b = _np(getattr(jsc.media, f)), getattr(tsc.media, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    jm = jschema.host_meta(jsc)
    for k in ("world_lo", "world_hi", "n_media"):
        np.testing.assert_array_equal(tsc.host[k], jm[k])
    np.testing.assert_array_equal(tsc.world_lo.numpy(), _np(jsc.world_lo))
    np.testing.assert_array_equal(tsc.world_hi.numpy(), _np(jsc.world_hi))
    np.testing.assert_array_equal(tsc.lights.params.numpy(), _np(jsc.lights.params))
    if name == "overlap":   # the homogeneous box sticks out in -z
        assert float(tsc.world_lo[2]) == pytest.approx(-2.5)


@pytest.mark.parametrize("ptype", [0, 1, 2, 3])
def test_phase(ptype):
    r = np.random.default_rng(ptype)
    wi = r.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo = r.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    g = r.uniform(-0.9, 0.9, N).astype(np.float32)
    g[:64] = r.uniform(-5e-4, 5e-4, 64)        # HG's isotropic branch
    u = r.random((N, 2)).astype(np.float32)
    pt = np.full(N, ptype, np.int32)
    J = [jnp.asarray(x) for x in (pt, g, wi, wo, u)]
    T = [torch.from_numpy(x) for x in (pt, g, wi, wo, u)]
    for fn in ("eval_phase", "pdf_phase"):
        np.testing.assert_allclose(getattr(tphase, fn)(*T[:4]).numpy(),
                                   _np(getattr(jphase, fn)(*J[:4])), err_msg=fn, **TOL)
    tw = tphase.sample_phase(T[0], T[1], T[2], T[4])
    jw = jphase.sample_phase(J[0], J[1], J[2], J[4])
    for a, b, what in zip(tw, jw, ("wo", "weight", "pdf")):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=what)


def test_hg_forward_peaked_and_consistent():
    """test_media.py's HG case on the port: mean cosine = +g, forward
    lobe, eval equal to pdf at the sampled directions."""
    B = 50000
    r = np.random.default_rng(0)
    d_in = torch.tensor([[0.0, 0.0, 1.0]]).expand(B, 3)
    g = torch.full((B,), 0.6)
    pt = torch.zeros(B, dtype=torch.int32)
    u = torch.from_numpy(r.random((B, 2)).astype(np.float32))
    wo, w, pdf = tphase.sample_phase(pt, g, d_in, u)
    assert abs(float(wo[:, 2].mean()) - 0.6) < 0.02
    fwd = float(tphase.eval_phase(pt[:1], g[:1], d_in[:1], torch.tensor([[0., 0., 1.]]))[0])
    bwd = float(tphase.eval_phase(pt[:1], g[:1], d_in[:1], torch.tensor([[0., 0., -1.]]))[0])
    assert fwd > bwd * 10
    np.testing.assert_allclose(tphase.eval_phase(pt, g, d_in, wo).numpy(),
                               pdf.numpy(), rtol=1e-4)


def _segments(seed, lo=-1.3, hi=1.3):
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:32] = [0.0, 0.0, 1.0]                  # axis-aligned: dl == 0 on two axes
    t0 = r.uniform(0.0, 0.5, N).astype(np.float32)
    t1 = (t0 + r.uniform(0.0, 4.0, N)).astype(np.float32)
    t1[:16] = 1e7                             # escaping rays
    state = r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    active = r.random(N) < 0.8
    return o, d, t0, t1, state, active


@pytest.mark.parametrize("name", sorted(SCENES))
def test_medium_queries(name):
    jsc, tsc = _both(name)
    o, d, t0, t1, _, _ = _segments(5)
    jm, tm = jsc.media, tsc.media
    for a, b in zip(jmed.media_aabb(jm), tmed.media_aabb(tm)):
        np.testing.assert_allclose(b.numpy(), _np(a), **TOL)
    np.testing.assert_allclose(float(tmed.majorant(tm)), float(jmed.majorant(jm)), **TOL)
    for a, b in zip(jmed.sigma_at(jm, jnp.asarray(o)), tmed.sigma_at(tm, torch.from_numpy(o))):
        np.testing.assert_allclose(b.numpy(), _np(a), **TOL)
    np.testing.assert_allclose(
        tmed.tau_segment(tm, *(torch.from_numpy(x) for x in (o, d, t0, t1))).numpy(),
        _np(jmed.tau_segment(jm, *(jnp.asarray(x) for x in (o, d, t0, t1)))),
        rtol=1e-5, atol=1e-5)
    if name == "grid_slab":
        pl = np.random.default_rng(6).uniform(-0.1, 1.1, (N, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tmed._density_at(tm, 0, torch.from_numpy(pl)).numpy(),
            _np(jmed._density_at(jm, 0, jnp.asarray(pl))), **TOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tracking_loops(name):
    """sample_distance and transmittance: the states after the loop depend
    on its iteration count (every lane draws in every iteration), so equal
    states show the loops ran equally long."""
    jsc, tsc = _both(name)
    o, d, _, t1, state, active = _segments(7)
    J = [jnp.asarray(x) for x in (o, d, t1, state, active)]
    T = [torch.from_numpy(x) for x in (o, d, t1, state.astype(np.int64), active)]
    reads = tmed.host_reads
    jms, jst = jmed.sample_distance(jsc.media, *J)
    tms, tst = tmed.sample_distance(tsc.media, *T)
    assert tmed.host_reads > reads
    np.testing.assert_array_equal(tst.numpy(), _np(jst).astype(np.int64))
    for f in ("valid", "ptype"):
        np.testing.assert_array_equal(getattr(tms, f).numpy(), _np(getattr(jms, f)))
    for f in ("t", "p", "weight", "g"):
        np.testing.assert_allclose(getattr(tms, f).numpy(), _np(getattr(jms, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert bool(tms.valid.any()) and bool((active & ~tms.valid.numpy()).any())
    jT, jst2 = jmed.transmittance(jsc.media, *J)
    tT, tst2 = tmed.transmittance(tsc.media, *T)
    np.testing.assert_array_equal(tst2.numpy(), _np(jst2).astype(np.int64))
    np.testing.assert_allclose(tT.numpy(), _np(jT), **TOL)
    # no active lane: no iteration, no draw
    none = torch.zeros(N, dtype=torch.bool)
    _, st0 = tmed.transmittance(tsc.media, *T[:4], none)
    np.testing.assert_array_equal(st0.numpy(), T[3].numpy())


def test_pt_radiance_in_fog_states():
    """pt_radiance on fog_cornell's camera rays (the unmerged NEE route with
    ratio-tracked shadow rays): the RNG states bit for bit, L at 1e-4."""
    jsc, tsc = _both("fog")
    pix = np.arange(256, dtype=np.int32)
    jr, *_, jst, _ = jtracer.gen_camera_rays(jsc, jnp.asarray(pix), 0, 3, 16, 16)
    tr, *_, tst, _ = ttracer.gen_camera_rays(tsc, torch.from_numpy(pix), 0, 3, 16, 16)
    types = tpath.scene_active_types(tsc)
    jL, jst2 = jax.jit(lambda r, s: jpath.pt_radiance(
        jsc, r, s, max_depth=4, active_types=types))(jr, jst)
    tL, tst2 = tpath.pt_radiance(tsc, tr, tst, max_depth=4, active_types=types)
    np.testing.assert_array_equal(tst2.numpy(), _np(jst2).astype(np.int64))
    np.testing.assert_allclose(tL.numpy(), _np(jL), rtol=1e-4, atol=1e-5)


def _pass_for_pass(jsc, tsc, w, depth, passes, count_rays=True, coupled=False):
    jtr = jpath.PathTracer(jsc, w, w, max_depth=depth)
    ttr = tpath.PathTracer(tsc, w, w, max_depth=depth)
    for _ in range(passes):
        jtr.do_pass()
        ttr.do_pass()
        j_rgb, t_rgb = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        if coupled:
            rel = abs(t_rgb.mean() - j_rgb.mean()) / j_rgb.mean()
            assert rel < 0.01, rel
        else:
            rel = np.abs(t_rgb - j_rgb).mean() / max(j_rgb.mean(), 1e-6)
            assert rel < 0.005, rel
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        j_rays, t_rays = jtr.rays_traced_live, ttr.rays_traced_live
        if count_rays:
            assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert ttr._ovf_dev.tolist() == [0, 0]
    return ttr


def test_fog_cornell_pass_for_pass():
    jsc, tsc = _both("fog")
    ttr = _pass_for_pass(jsc, tsc, 16, 6, 2)
    img = tfilm.develop(ttr.film).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05


DENS1 = np.ones((8, 8, 8), np.float32)
# The scattering slabs couple every lane's RNG stream to one rounding
# flip: a tracking loop runs while any lane of the batch is undone, so its
# iteration count, and with it every lane's later draws, changes when one
# lane joins or leaves it. On the slab's black emitter NEE samples points
# in the hit's own plane, and whether that lane traces a shadow ray (and
# joins the transmittance loop) turns on a cosine of rounding size, which
# XLA's FMA contraction and PyTorch's separate rounding give opposite
# signs on some lanes. From that bounce on the two renders draw different
# paths, so these cases hold the film's mean (readings over 16 passes at
# 24x24: within 0.44% single scatter, 0.19% HG) under 1% instead of every
# pixel.
COUPLED = ("single_scatter", "hg_phase")
MEDIA_CASES = {
    # name: (scene kwargs or "furnace", depth, passes, check on the port image)
    "beer_lambert": (dict(sigma_a=(0.8,) * 3, sigma_s=(0, 0, 0)), 8, 2, None),
    "chromatic_absorption": (dict(sigma_a=(1.5, 0.5, 0.1), sigma_s=(0, 0, 0)), 8, 2,
                             None),
    "grid_matches_homogeneous": (dict(sigma_a=(0.7,) * 3, sigma_s=(0, 0, 0),
                                      density=DENS1), 8, 2, None),
    "zero_density_grid": (dict(sigma_a=(5.0,) * 3, sigma_s=(0, 0, 0),
                               density=np.zeros((4, 4, 4), np.float32)), 8, 2,
                          lambda img: np.testing.assert_allclose(
                              img[10:14, 10:14].mean(), 2.0, rtol=0.03)),
    "scattering_furnace": ("furnace", 12, 2, None),
    "single_scatter": (dict(sigma_a=(0.0,) * 3, sigma_s=(0.6,) * 3), 8, 2,
                       lambda img: img.mean() > 0.1 and np.isfinite(img).all()),
    "hg_phase": (dict(sigma_a=(0.05,) * 3, sigma_s=(0.8,) * 3, g=0.6), 8, 2, None),
}


@pytest.mark.parametrize("case", sorted(MEDIA_CASES))
def test_media_cases_pass_for_pass(case):
    kw, depth, passes, check = MEDIA_CASES[case]
    if kw == "furnace":
        jsc, tsc = _furnace(JPKG).build(), _furnace(TPKG).build("cpu")
    else:
        jsc, tsc = _slab(JPKG, **kw).build(), _slab(TPKG, **kw).build("cpu")
    # no ray counts: on the slab's black emitter, NEE samples points in the
    # hit's own plane, and whether a shadow ray is traced (a cosine of
    # rounding-noise size, zero contribution either way) differs by FMA
    # contraction
    ttr = _pass_for_pass(jsc, tsc, 24, depth, passes, count_rays=False,
                         coupled=case in COUPLED)
    if check is not None:
        res = check(tfilm.develop(ttr.film).numpy())
        assert res is None or res
