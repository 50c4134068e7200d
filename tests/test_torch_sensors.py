"""The port's sensors against the JAX package's: all five types.

``sample_ray`` (spherical, perspective, thin lens, orthographic,
telecentric) and ``sample_direct`` (the thin lens connects as the pinhole
does) on 4,096 seeded film points, lens uniforms and scene points, some
behind the camera and outside the film: floats at rtol 1e-5 / atol 1e-5
(arccos and arctan2 round differently on the CPU; the telecentric anchor
solve divides by the focus distance), directions to the lens within 1e-5
plus 1e-6 over the point's distance (they normalise a difference of
points, some 0.01 from the lens), validity bit for bit where the film
point lies more than 1e-3 inside the film (a point on a film edge may
round to either side). The spherical film x is a floor-mod in both
packages (``jnp.mod``, ``torch.remainder``), held equal at negative values.

Then the port's counterpart of tests/test_lighttracer.py's
test_lt_matches_pt_all_sensors at 32x32 (the light tracer's mean within
0.2 of the path tracer's under the spherical, orthographic and telecentric
sensors), and a thin-lens path-tracing pass for pass against the JAX
package at 16x16, under test_torch_path.py's rule: the film within a mean
relative error of 0.5% (float drift can flip a rare roulette draw or
shadow test), the weights equal and the live rays within 0.1%."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.scene import schema as jschema, sensors as jsensors
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.models import lighttracer as tlt
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.scene import host as thost, schema as tschema
from cudatracerlib_tpu_torch.scene import sensors as tsensors, shapes as tshapes
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)
N = 4096
W, H = 32, 24
TOL = dict(rtol=1e-5, atol=1e-5)
TYPES = {"spherical": tschema.SENSOR_SPHERICAL,
         "perspective": tschema.SENSOR_PERSPECTIVE,
         "thinlens": tschema.SENSOR_THINLENS,
         "orthographic": tschema.SENSOR_ORTHOGRAPHIC,
         "telecentric": tschema.SENSOR_TELECENTRIC}
KW = dict(fov_x_deg=50.0, film_w=W, film_h=H, aperture_radius=0.05,
          focus_distance=2.5, ortho_scale=(2.0, 1.5))


def _sensors(st):
    to_world = np.asarray(jtf.look_at([0, 0.6, -2.5], [0, -0.6, 0]), np.float32)
    return (jsensors.make_sensor(st, to_world, **KW),
            tsensors.make_sensor(st, to_world, **KW))


def _inside(p_film):
    """Film points more than 1e-3 inside the film."""
    x, y = p_film[:, 0], p_film[:, 1]
    return (x > 1e-3) & (x < W - 1e-3) & (y > 1e-3) & (y < H - 1e-3)


@pytest.mark.parametrize("name", list(TYPES))
def test_sample_ray(name):
    js, ts = _sensors(TYPES[name])
    r = np.random.default_rng(3)
    pf = np.stack([r.uniform(0, W, N), r.uniform(0, H, N)], 1).astype(np.float32)
    u = r.random((N, 2)).astype(np.float32)
    want = jsensors.sample_ray(js, jnp.asarray(pf), jnp.asarray(u))
    got = tsensors.sample_ray(ts, torch.from_numpy(pf), torch.from_numpy(u))
    for k in ("o", "d", "weight"):
        g = getattr(got, k)
        assert g.shape == (N, 3) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, k)),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.d.numpy(), axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", list(TYPES))
@pytest.mark.parametrize("lens", ["none", "uniforms"])
def test_sample_direct(name, lens):
    js, ts = _sensors(TYPES[name])
    r = np.random.default_rng(4)
    p = r.uniform((-2.0, -2.0, -3.5), (2.0, 2.0, 4.0), (N, 3)).astype(np.float32)
    u = r.random((N, 2)).astype(np.float32) if lens == "uniforms" else None
    want = jsensors.sample_direct(js, jnp.asarray(p), None if u is None else jnp.asarray(u))
    got = tsensors.sample_direct(ts, torch.from_numpy(p),
                                 None if u is None else torch.from_numpy(u))
    valid = np.asarray(want.valid)
    for k in ("p_film", "d", "dist", "weight"):
        g, j = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape == j.shape and g.dtype == np.float32
        # p_film of points behind a pinhole is huge and meaningless
        m = valid if k == "p_film" else np.ones(N, bool)
        if k == "d":
            # a unit vector from a point to the lens: the points' rounding
            # (~1e-7) over the distance, which is 0.01 for some points
            dist = np.asarray(want.dist)
            err = np.abs(g - j).max(axis=1)
            assert (err <= 1e-5 + 1e-6 / np.abs(dist)).all(), err.max()
            continue
        np.testing.assert_allclose(g[m], j[m], err_msg=k, **TOL)
    inside = _inside(got.p_film.numpy()) & _inside(np.asarray(want.p_film))
    np.testing.assert_array_equal(got.valid.numpy()[inside], valid[inside])
    assert np.isfinite(got.weight.numpy()).all()
    assert 0.05 < valid.mean() <= 1.0


def test_spherical_film_x_is_a_floor_mod():
    x = np.array([-33.5, -3.25, -1e-6, 0.0, 5.5, 31.999, 32.0, 70.0], np.float32)
    np.testing.assert_array_equal(torch.remainder(torch.from_numpy(x), 32.0).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(x), 32.0)))


def _sensor_scene(sensor_type, **kw):
    """tests/test_lighttracer.py's scene: a floor under a small area light."""
    sc = thost.DynamicScene()
    white = sc.add_material(thost.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    black = sc.add_material(thost.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(tshapes.rectangle(), white,
                   ttf.compose(ttf.translate([0, -1, 0]), ttf.rotate_deg([1, 0, 0], -90),
                               ttf.scale(3)))
    sc.create_node(tshapes.rectangle(), black,
                   ttf.compose(ttf.translate([0, 1.5, 0]), ttf.rotate_deg([1, 0, 0], 90),
                               ttf.scale(0.5)), emission=(8.0, 8.0, 8.0))
    sc.set_sensor(tsensors.make_sensor(sensor_type,
                                       ttf.look_at([0, 0.6, -2.5], [0, -0.6, 0]),
                                       fov_x_deg=50, film_w=32, film_h=32, **kw))
    return sc.build("cpu")


@pytest.mark.parametrize("st,kw", [
    (tschema.SENSOR_SPHERICAL, {}),
    (tschema.SENSOR_ORTHOGRAPHIC, dict(ortho_scale=(2.0, 2.0))),
    (tschema.SENSOR_TELECENTRIC, dict(ortho_scale=(2.0, 2.0), aperture_radius=0.05,
                                      focus_distance=2.5))],
    ids=["spherical", "orthographic", "telecentric"])
def test_lt_matches_pt_all_sensors(st, kw):
    scene = _sensor_scene(st, **kw)
    img_pt = tpath.PathTracer(scene, 32, 32, max_depth=3).render(32).numpy()
    img_lt = tlt.LightTracer(scene, 32, 32, max_depth=3).render(64).numpy()
    m_pt, m_lt = img_pt.mean(), img_lt.mean()
    assert np.isfinite(img_lt).all() and m_lt > 0, f"sensor {st}: no splats"
    assert abs(m_pt - m_lt) / (m_pt + 1e-9) < 0.2, (st, m_pt, m_lt)


def test_thinlens_pt_pass_for_pass():
    kw = dict(fov_x_deg=32.0, film_w=16, film_h=16, aperture_radius=0.08,
              focus_distance=3.0)
    to_world = np.asarray(jtf.look_at([0, 0, -3.5], [0, 0, 0]), np.float32)
    jsc = jscenes.cornell_box(16, 16)
    jsc.set_sensor(jsensors.make_sensor(jschema.SENSOR_THINLENS, to_world, **kw))
    tsc = tscenes.cornell_box(16, 16)
    tsc.set_sensor(tsensors.make_sensor(tschema.SENSOR_THINLENS, to_world, **kw))
    jtr = jpath.PathTracer(jsc.build(), 16, 16, max_depth=3)
    ttr = tpath.PathTracer(tsc.build("cpu"), 16, 16, max_depth=3)
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j, t = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        assert np.abs(t - j).mean() / np.abs(j).mean() < 0.005
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        j_rays = float(jtr._rays_dev)
        assert abs(ttr.rays_traced_live - j_rays) <= 1e-3 * j_rays
