"""Path regularization in the port's PathTracer, pt_radiance and
WavefrontPT against the JAX package's.

Once a path has taken a smooth (non-delta) bounce, regularization turns its
smooth dielectrics and conductors into their rough counterparts with a
roughness of at least 0.08 (bsdf.regularize_ctx), so that NEE connects
through otherwise-delta chains. The lane state that carries it is
had_smooth; a WavefrontPT lane refilled from the path queue starts with it
false.

- chip_smoke.py's materials.xml (all 16 BSDF types) at 32x32, depth 5,
  regularized, pass for pass against the JAX PathTracer (one JAX render,
  compiled once in a module fixture; the unregularized pass is held in
  tests/test_torch_loader.py): the film within a mean relative error of
  0.5% and the live rays within 0.1%, as tests/test_torch_path.py holds
  the Cornell box.
- tests/test_path_tracer.py's glass-sphere scene at 24x24, depth 6, plain
  and regularized, pass for pass against JAX the same way, and the two
  images within that test's 25% of each other.
- WavefrontPT(regularize=True) against the port's chunked PathTracer on
  both scenes: the same sample set, so the images within
  tests/test_wavefront.py's rtol 1e-5 / atol 1e-7 and the live rays
  identical. WavefrontPT, as the JAX package's, does not widen its active
  types by the rough ones (PathTracer does), so on the glass scene it is
  given PathTracer's widened types explicitly.
- WavefrontPT(regularize=True) against the JAX one pass for pass on the
  glass scene, which has no rough type: with the default active types (a
  regularized delta lane ends its path in both) and with the widened types
  passed to both."""
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from cudatracerlib_tpu.core import rough_transmittance as jrt
from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.models import wavefront as jwf
from cudatracerlib_tpu.scene import host as jhost
from cudatracerlib_tpu.scene import native_bvh as jnative
from cudatracerlib_tpu.scene import schema as jschema
from cudatracerlib_tpu.scene import shapes as jshapes
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.scene.loader import mitsuba as jmitsuba
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.models import bsdf as tbsdf
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import wavefront as twf
from cudatracerlib_tpu_torch.scene import host as thost
from cudatracerlib_tpu_torch.scene import native_bvh as tnative
from cudatracerlib_tpu_torch.scene import schema as tschema
from cudatracerlib_tpu_torch.scene import shapes as tshapes
from cudatracerlib_tpu_torch.scene.loader import mitsuba as tmitsuba
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)
JAX = (jscenes, jhost, jschema, jshapes, jtf)
PORT = (tscenes, thost, tschema, tshapes, ttf)


def glass_scene(m):
    """tests/test_path_tracer.py:88-106: a glass sphere over the Cornell
    box's floor, lit by its small area light."""
    scenes, host, schema, shapes, tf = m
    sc = scenes.cornell_box(24, 24, spheres=False)
    glass = sc.add_material(host.MaterialSpec(bsdf_type=schema.BSDF_DIELECTRIC,
                                              eta=1.5, two_sided=False))
    sc.create_node(shapes.sphere(radius=0.3, n_theta=12, n_phi=24), glass,
                   tf.translate([0, -0.6, 0]))
    return sc


def assert_pass_for_pass(ttr, jtr, passes):
    for _ in range(passes):
        jtr.do_pass()
        ttr.do_pass()
        j_rgb, t_rgb = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        rel = np.abs(t_rgb - j_rgb).mean() / j_rgb.mean()
        assert rel < 0.005, rel
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        j_rays, t_rays = jtr.rays_traced_live, ttr.rays_traced_live
        assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert np.isfinite(t_rgb).all() and t_rgb.mean() > 0.0
    assert ttr._ovf_dev.tolist() == [0, 0]


@pytest.fixture(scope="module")
def materials(tmp_path_factory):
    """materials.xml at 32x32 loaded and built by both packages (the JAX
    build without its disk caches), and the JAX regularized PathTracer's
    first two passes."""
    d = tmp_path_factory.mktemp("materials")
    path = str(d / "materials.xml")
    with open(path, "w") as fh:
        fh.write(chip_smoke.materials_xml(32))
    tables = {(k, round(float(e), 3)): jrt._compute_table(k, e)
              for k in (0, 1) for e in jrt._ETA_KNOTS}
    with mock.patch.object(jnative, "_load", tnative._load), \
            mock.patch.object(jnative, "_build_cache_path",
                              lambda v0, v1, v2: str(d / "bvh8.npz")), \
            mock.patch.object(jtreelet, "partition_cached",
                              lambda table, **kw: jtreelet.partition(table, **kw)), \
            mock.patch.object(jrt, "_CACHE", tables):
        t = tmitsuba.load_mitsuba(path)[0].build("cpu")
        j = jmitsuba.load_mitsuba(path)[0].build()
        jtr = jpath.PathTracer(j, 32, 32, max_depth=5, regularize=True)
        films = []
        for _ in range(2):
            jtr.do_pass()
            films.append((np.asarray(jtr.film.rgb), np.asarray(jtr.film.weight),
                          jtr.rays_traced_live))
    return dict(t=t, films=films)


def test_materials_regularized_pass_for_pass(materials):
    ttr = tpath.PathTracer(materials["t"], 32, 32, max_depth=5, regularize=True)
    assert ttr.active_types == tuple(range(16))
    for j_rgb, j_w, j_rays in materials["films"]:
        ttr.do_pass()
        t_rgb = ttr.film.rgb.numpy()
        rel = np.abs(t_rgb - j_rgb).mean() / j_rgb.mean()
        assert rel < 0.005, rel
        np.testing.assert_array_equal(ttr.film.weight.numpy(), j_w)
        t_rays = ttr.rays_traced_live
        assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert np.isfinite(t_rgb).all() and t_rgb.mean() > 0.0


@pytest.mark.parametrize("regularize", [False, True], ids=["plain", "regularized"])
def test_glass_pass_for_pass(regularize):
    jtr = jpath.PathTracer(glass_scene(JAX).build(), 24, 24, max_depth=6,
                           regularize=regularize)
    ttr = tpath.PathTracer(glass_scene(PORT).build("cpu"), 24, 24, max_depth=6,
                           regularize=regularize)
    assert ttr.active_types == jtr.active_types
    assert ttr.active_types == ((0, 2, 4, 6) if regularize else (0, 2))
    assert_pass_for_pass(ttr, jtr, 2)


def test_regularized_glass_stays_close_to_plain():
    """tests/test_path_tracer.py's check at its 12 passes: regularization's
    bias moves the image's mean by under 25%."""
    scene = glass_scene(PORT).build("cpu")
    plain = tpath.PathTracer(scene, 24, 24, max_depth=6).render(12).numpy()
    reg = tpath.PathTracer(scene, 24, 24, max_depth=6, regularize=True).render(12).numpy()
    assert np.isfinite(reg).all()
    assert abs(reg.mean() - plain.mean()) / plain.mean() < 0.25
    assert not np.array_equal(reg, plain)


def test_first_bounce_is_never_regularized():
    """A camera ray's first hit has had no smooth bounce: with depth 1 the
    regularized render equals the plain one (the glass sphere stays
    delta)."""
    scene = glass_scene(PORT).build("cpu")
    plain = tpath.PathTracer(scene, 24, 24, max_depth=1).render(2).numpy()
    reg = tpath.PathTracer(scene, 24, 24, max_depth=1, regularize=True).render(2).numpy()
    np.testing.assert_array_equal(reg, plain)


@pytest.mark.parametrize("lanes", [576, 200])
def test_wavefront_regularized_matches_pt_glass(lanes):
    scene = glass_scene(PORT).build("cpu")
    pt = tpath.PathTracer(scene, 24, 24, max_depth=6, regularize=True, chunk_size=24 * 24)
    wf = twf.WavefrontPT(scene, 24, 24, max_depth=6, regularize=True, lanes=lanes,
                         active_types=pt.active_types)
    assert wf.active_types == pt.active_types == (0, 2, 4, 6)
    i1, i2 = pt.render(2).numpy(), wf.render(2).numpy()
    assert np.isfinite(i2).all() and i2.mean() > 0
    np.testing.assert_allclose(i2, i1, rtol=1e-5, atol=1e-7)
    assert wf.rays_traced_live == pt.rays_traced_live


def test_wavefront_regularized_matches_pt_materials(materials):
    scene = materials["t"]
    pt = tpath.PathTracer(scene, 32, 32, max_depth=5, regularize=True, chunk_size=32 * 32)
    wf = twf.WavefrontPT(scene, 32, 32, max_depth=5, regularize=True, lanes=700)
    i1, i2 = pt.render(1).numpy(), wf.render(1).numpy()
    np.testing.assert_allclose(i2, i1, rtol=1e-5, atol=1e-7)
    assert wf.rays_traced_live == pt.rays_traced_live


def test_wavefront_regularized_matches_jax():
    """Both WavefrontPTs given the widened active types, at 16x16, pass for
    pass."""
    types = tpath.regularized_types((0, 2))
    jtr = jwf.WavefrontPT(glass_scene(JAX).build(), 16, 16, max_depth=5, lanes=256,
                          regularize=True, active_types=types)
    ttr = twf.WavefrontPT(glass_scene(PORT).build("cpu"), 16, 16, max_depth=5,
                          lanes=256, regularize=True, active_types=types)
    assert ttr.active_types == types
    assert_pass_for_pass(ttr, jtr, 2)


def test_wavefront_regularized_default_matches_jax():
    """Both WavefrontPTs with their default active types, the scene's (no
    rough type), at 16x16, pass for pass; the regularized image differs
    from the widened one, where those lanes go on."""
    jtr = jwf.WavefrontPT(glass_scene(JAX).build(), 16, 16, max_depth=5, lanes=256,
                          regularize=True)
    scene = glass_scene(PORT).build("cpu")
    ttr = twf.WavefrontPT(scene, 16, 16, max_depth=5, lanes=256, regularize=True)
    assert ttr.active_types == jtr.active_types == (0, 2)
    assert_pass_for_pass(ttr, jtr, 2)
    wide = twf.WavefrontPT(scene, 16, 16, max_depth=5, lanes=256, regularize=True,
                           active_types=tpath.regularized_types((0, 2)))
    assert not np.array_equal(wide.render(2).numpy(), tfilm.develop(ttr.film).numpy())


def test_pt_radiance_regularize_argument():
    """pt_radiance regularizes where PathTracer passes it on; with the
    rough types active it differs from the plain estimate past depth 1."""
    from cudatracerlib_tpu_torch.models import tracer as ttracer
    scene = glass_scene(PORT).build("cpu")
    pix = torch.arange(24 * 24, dtype=torch.int32)
    rays, _, _, state, _ = ttracer.gen_camera_rays(scene, pix, 0, 0, 24, 24)
    types = tpath.regularized_types((0, 2))
    plain, s1 = tpath.pt_radiance(scene, rays, state.clone(), 6, active_types=types)
    reg, s2 = tpath.pt_radiance(scene, rays, state.clone(), 6, active_types=types,
                                regularize=True, regularize_alpha=0.2)
    assert torch.isfinite(reg).all() and not torch.equal(reg, plain)
    assert tbsdf.REGULARIZE_EXTRA_TYPES == (tschema.BSDF_ROUGHDIELECTRIC,
                                            tschema.BSDF_ROUGHCONDUCTOR)
