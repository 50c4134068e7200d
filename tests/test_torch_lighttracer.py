"""The port's light tracer and what it needs (emission rays of every light
type, the sensor's direct sampling, film splats) against the JAX package's.

Emission rays: RNG states and light indices bit for bit, floats at rtol
1e-5 / atol 1e-6, for a scene of each light type (point, spot, distant,
area, environment) and one holding all five; directions at atol 1e-5
(the cosine-hemisphere warp's z = sqrt(1 - x^2 - y^2) magnifies a one-ulp
difference near the rim, see test_torch_core.py). Sensor connections: the
same tolerance on random points in and around the Cornell box, validity
bit for bit away from the frustum's edges. Splats: the film equals the
JAX film.

LightTracer on Cornell 32x32, depth 4, pass for pass against JAX: the
splat film within a mean relative error of 0.5% (float drift can flip a
rare roulette draw or a near-tie triangle, as in test_torch_path.py), the
weights equal. The JAX light tracer keeps no ray count, so the port's
int64 count is held to its own definition: the sum over the pass of the
walk's live lanes and the splats' shadow rays. Then the 12-pass render
against tests/goldens/cornell_32_lt.npz at test_goldens_family.py's
tolerance (mean relative error < 0.02)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import lighttracer as jlt
from cudatracerlib_tpu.models import lights as jlights
from cudatracerlib_tpu.scene import host as jhost, schema as jschema
from cudatracerlib_tpu.scene import sensors as jsensors, shapes as jshapes
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.core import rng as trng
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import lighttracer as tlt
from cudatracerlib_tpu_torch.models import lights as tlights
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.scene import host as thost, schema as tschema
from cudatracerlib_tpu_torch.scene import sensors as tsensors, shapes as tshapes
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_32_lt.npz")
TOL = dict(rtol=1e-5, atol=1e-6)
DIR_TOL = dict(rtol=1e-5, atol=1e-5)
N = 4096
KINDS = ("point", "spot", "distant", "area", "env", "all")


def _light_scene(pkg, kind):
    """A floor and a back wall lit by `kind` (every kind for "all")."""
    host, schema, sensors, shapes, tf, scenes = pkg
    sc = host.DynamicScene()
    m = sc.add_material(host.MaterialSpec(reflectance=(0.6, 0.5, 0.4)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0.0, 0.0, 0.0)))
    sc.create_node(shapes.rectangle(), m,
                   tf.compose(tf.translate([0, -0.5, 1.5]),
                              tf.rotate_deg([1, 0, 0], -90), tf.scale(3)))
    sc.create_node(shapes.rectangle(), m,
                   tf.compose(tf.translate([0, 0.5, 2.5]),
                              tf.rotate_deg([0, 1, 0], 180), tf.scale(1.5)))
    if kind in ("point", "all"):
        sc.add_point_light([0.5, 1.5, 0.5], (4.0, 3.5, 3.0))
    if kind in ("spot", "all"):
        sc.add_spot_light([0.5, 1.5, 0.5], [-0.3, -1, 0.5], (6.0, 5.5, 5.0),
                          cutoff_deg=40)
    if kind in ("distant", "all"):
        sc.add_distant_light([-0.3, -1, 0.4], (1.5, 1.4, 1.2))
    if kind in ("area", "all"):
        sc.create_node(shapes.rectangle(), black,
                       tf.compose(tf.translate([0, 1.5, 1.0]),
                                  tf.rotate_deg([1, 0, 0], 90), tf.scale(0.5)),
                       emission=(8.0, 7.0, 6.0))
    if kind in ("env", "all"):
        sc.set_environment(scenes._sky_envmap(32, 64))
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0.3, -2], [0, 0, 1.5]),
        fov_x_deg=50, film_w=24, film_h=24))
    return sc


JPKG = (jhost, jschema, jsensors, jshapes, jtf, jscenes)
TPKG = (thost, tschema, tsensors, tshapes, ttf, tscenes)


def _state(seed):
    ids = np.arange(N, dtype=np.int32)
    return np.asarray(trng.seed(torch.from_numpy(ids), 3, seed)).astype(np.int64)


@pytest.mark.parametrize("kind", KINDS)
def test_sample_emitter_ray(kind):
    jsc = _light_scene(JPKG, kind).build()
    tsc = _light_scene(TPKG, kind).build("cpu")
    state = _state(0x9E3779B9)
    ter, tst = tlights.sample_emitter_ray(tsc, torch.from_numpy(state))
    jer, jst = jlights.sample_emitter_ray(jsc, jnp.asarray(state.astype(np.uint32)))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst).astype(np.int64))
    np.testing.assert_array_equal(ter.light_idx.numpy(), np.asarray(jer.light_idx))
    for name in ("o", "d", "n", "power", "pdf_pos", "pdf_dir", "le"):
        np.testing.assert_allclose(getattr(ter, name).numpy(),
                                   np.asarray(getattr(jer, name)), err_msg=name,
                                   **(DIR_TOL if name == "d" else TOL))
    types = tsc.lights.light_type[ter.light_idx.long()]
    assert ter.light_idx.dtype == torch.int32
    if kind == "all":
        assert set(types.tolist()) == set(range(5))     # every type drawn
    assert np.isfinite(ter.power.numpy()).all() and float(ter.power.abs().max()) > 0


def test_sample_direct():
    """The pinhole's direct sampling on points in and around the Cornell
    box, some behind the camera (z < near) and some outside the frustum."""
    jsc = jscenes.cornell_box(32, 24).build()
    tsc = tscenes.cornell_box(32, 24).build("cpu")
    r = np.random.default_rng(8)
    p = r.uniform((-1.2, -1.2, -4.0), (1.2, 1.2, 1.0), (N, 3)).astype(np.float32)
    got = tsensors.sample_direct(tsc.sensor, torch.from_numpy(p), None)
    want = jsensors.sample_direct(jsc.sensor, jnp.asarray(p), None)
    for name in ("p_film", "d", "dist", "weight"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), err_msg=name,
                                   rtol=1e-5, atol=1e-5)
    pf = got.p_film.numpy()
    edge = (np.minimum(np.abs(pf[:, 0]), np.abs(pf[:, 0] - 32)) < 1e-3) | (
        np.minimum(np.abs(pf[:, 1]), np.abs(pf[:, 1] - 24)) < 1e-3)
    np.testing.assert_array_equal(got.valid.numpy()[~edge], np.asarray(want.valid)[~edge])
    assert 0.1 < got.valid.float().mean() < 0.9
    # every sensor type connects (the other four: test_torch_sensors.py)
    sph = tsensors.sample_direct(tsc.sensor._replace(sensor_type=tschema.SENSOR_SPHERICAL),
                                 torch.from_numpy(p), None)
    assert bool(sph.valid.all()) and np.isfinite(sph.weight.numpy()).all()


def test_splat():
    """Masked splats with non-finite values and repeated pixels."""
    r = np.random.default_rng(6)
    px = r.integers(0, 8, 512).astype(np.int32)
    py = r.integers(0, 6, 512).astype(np.int32)
    val = r.normal(size=(512, 3)).astype(np.float32)
    val[:4] = (np.nan, np.inf, 1.0)
    mask = r.random(512) < 0.7
    tf_ = tfilm.splat(tfilm.new_film(8, 6, "cpu"), torch.from_numpy(px),
                      torch.from_numpy(py), torch.from_numpy(val), torch.from_numpy(mask))
    jf = jfilm.splat(jfilm.new_film(8, 6), jnp.asarray(px), jnp.asarray(py),
                     jnp.asarray(val), jnp.asarray(mask))
    np.testing.assert_allclose(tf_.splat.numpy(), np.asarray(jf.splat), rtol=1e-6,
                               atol=1e-6)
    assert np.isfinite(tf_.splat.numpy()).all() and float(tf_.rgb.abs().sum()) == 0


def test_lt_pass_for_pass():
    jtr = jlt.LightTracer(jscenes.cornell_box(32, 32).build(), 32, 32, max_depth=4)
    ttr = tlt.LightTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32, max_depth=4)
    before = traversal8.intersect_wide_cuda.launches
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j_sp, t_sp = np.asarray(jtr.film.splat), ttr.film.splat.numpy()
        rel = np.abs(t_sp - j_sp).mean() / j_sp.mean()
        assert rel < 0.005, rel
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        assert float(ttr.film.rgb.abs().sum()) == 0.0
    assert ttr._rays_dev.dtype == torch.int64
    # one pass: at most 1 + 2 * depth wavefronts of 32 * 32 rays
    assert 32 * 32 < ttr.rays_traced_live < 2 * (1 + 2 * 4) * 32 * 32
    np.testing.assert_allclose(tfilm.develop(ttr.film).numpy(),
                               np.asarray(jfilm.develop(jtr.film)), rtol=0,
                               atol=0.01 * float(np.asarray(jfilm.develop(jtr.film)).max()))
    assert traversal8.intersect_wide_cuda.launches == before    # CPU tensors only
    s = ttr.status()
    assert s["passes"] == 2 and set(s) == set(jtr.status())


def test_lt_pass_path_ids():
    """lt_pass returns the film alone, as the JAX pass does, and two shards
    of path ids with the global path count splat what the whole pass does
    (the same RNG stream per path; the splats' sums in another order, so
    within rtol 1e-5)."""
    sc = tscenes.cornell_box(16, 16).build("cpu")
    types = tlt.LightTracer(sc, 16, 16).active_types
    full = tlt.lt_pass(sc, tfilm.new_film(16, 16, "cpu"), 3, 256, 3, types)
    assert isinstance(full, tfilm.Film)
    ids = torch.arange(256, dtype=torch.int32)
    film = tfilm.new_film(16, 16, "cpu")
    for part in (ids[:100], ids[100:]):
        film = tlt.lt_pass(sc, film, 3, 256, 3, types, path_ids=part, total_paths=256)
    assert float(full.splat.sum()) > 0
    np.testing.assert_allclose(film.splat.numpy(), full.splat.numpy(), rtol=1e-5,
                               atol=1e-6 * float(full.splat.max()))


def test_lt_golden():
    img = tlt.LightTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32,
                          max_depth=4).render(12).numpy()
    ref = np.load(GOLDEN)["img"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.02, f"golden drift {rel:.4f}"
