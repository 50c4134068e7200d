"""The port's volumetric photon-mapping estimators against the JAX
package's, on tests/test_vol_estimators.py's scattering slab (24x24, a
4x4x1 slab before an emissive wall, 4,096 photons, depth 5, radius 0.25).

The beam radiance estimate's transmittance through the slab against
exp(-sigma_t * 1) (the JAX test's case) and against the JAX estimator.
Each of the three estimators ("point", "beamgrid", "beambeam") on the
slab's camera segments, from the same photon rows and beams in both
packages: the grids bit for bit, the radiance at rtol 1e-4 / atol 1e-6
(sums of up to 16 x 96 kernel-weighted photons), the transmittance at rtol
1e-5 / atol 1e-6. The eye pass with the point and beambeam estimators
(PPMTracer runs beamgrid by default; test_torch_ppm.py holds that route):
the film within a mean relative error of 0.5%, the weights equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import ppm as jppm
from cudatracerlib_tpu.models import vol_estimators as jve
from cudatracerlib_tpu.ops import dda as jdda
from cudatracerlib_tpu.scene import host as jhost, schema as jschema
from cudatracerlib_tpu.scene import sensors as jsensors, shapes as jshapes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import ppm as tppm
from cudatracerlib_tpu_torch.models import tracer as ttracer
from cudatracerlib_tpu_torch.models import vol_estimators as tve
from cudatracerlib_tpu_torch.ops import dda as tdda, traversal8
from cudatracerlib_tpu_torch.scene import host as thost, schema as tschema
from cudatracerlib_tpu_torch.scene import sensors as tsensors, shapes as tshapes
from cudatracerlib_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
JPKG = (jhost, jschema, jsensors, jshapes, jtf, None)
TPKG = (thost, tschema, tsensors, tshapes, ttf, None)


def _np(x):
    return np.asarray(x)


def _rel(a, b):
    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-9))


def _same_grid(tg, jg):
    np.testing.assert_array_equal(tg.cell_ids.numpy(), _np(jg.cell_ids))
    np.testing.assert_array_equal(tg.data.numpy(), _np(jg.data))
    np.testing.assert_array_equal(tg.dims.numpy(), _np(jg.dims))
    np.testing.assert_array_equal(tg.inv_cell.numpy(), _np(jg.inv_cell))


def _slab(pkg):
    """tests/test_vol_estimators.py's slab: a scattering 4x4x1 slab before
    an emissive wall (test_media._slab_scene)."""
    host, schema, sensors, shapes, tf, _ = pkg
    sc = host.DynamicScene()
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(shapes.rectangle(), black,
                   tf.compose(tf.translate([0, 0, 2]), tf.rotate_deg([0, 1, 0], 180),
                              tf.scale(8)), emission=(3.0,) * 3)
    sc.add_homogeneous_medium((0.05,) * 3, (0.8,) * 3,
                              tf.compose(tf.translate([-2, -2, 0]), tf.scale([4, 4, 1])))
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0, -2], [0, 0, 1]),
        fov_x_deg=20, film_w=24, film_h=24))
    return sc


@pytest.fixture(scope="module")
def slab():
    """The slab in both packages, its camera rays with their segment ends,
    and the port's photon rows and beams (depth 5, 4,096 photons), which
    both packages' grids are built from."""
    jsc, tsc = _slab(JPKG).build(), _slab(TPKG).build("cpu")
    types = tpath.scene_active_types(tsc)
    (rows, valid, beams, bvalid), _ = tppm._photon_walk(
        tsc, 4096, 0, 0x9907, 5, types, store_medium=True, collect_beams=True)
    pix = torch.arange(24 * 24, dtype=torch.int32)
    rays = ttracer.gen_camera_rays(tsc, pix, 0, 0, 24, 24)[0]
    hit = traversal8.intersect_scene(tsc.geom, rays)
    t_seg = torch.where(hit.valid, hit.t, 100.0)
    return jsc, tsc, types, rows, valid, beams, bvalid, rays, t_seg


def test_beamgrid_transmittance_matches_analytic(slab):
    jsc, tsc = slab[:2]
    B = 8
    rows = torch.zeros((B, 12))
    grid = tdda.build_ball_grid(rows, rows[:, 0:3], torch.zeros(B, dtype=torch.bool),
                                torch.tensor(0.2), tsc.world_lo, tsc.world_hi)
    o = torch.tensor([[0.0, 0.0, -0.5]]).expand(B, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(B, 3).contiguous()
    t1 = torch.full((B,), 2.2)
    _, Tr = tve.radiance_beamgrid(tsc, grid, o, d, t1, torch.tensor(0.2), max_cells=96)
    np.testing.assert_allclose(Tr.numpy()[:, 0], np.exp(-0.85), rtol=0.08)
    jgrid = jdda.build_ball_grid(jnp.zeros((B, 12)), jnp.zeros((B, 3)), jnp.zeros(B, bool),
                                 jnp.float32(0.2), jsc.world_lo, jsc.world_hi)
    _, jTr = jve.radiance_beamgrid(jsc, jgrid, jnp.asarray(o.numpy()),
                                   jnp.asarray(d.numpy()), jnp.asarray(t1.numpy()),
                                   jnp.float32(0.2), max_cells=96)
    np.testing.assert_allclose(Tr.numpy(), _np(jTr), **TOL)


@pytest.mark.parametrize("est", ["point", "beamgrid", "beambeam"])
def test_estimators_on_slab(slab, est):
    """Each volumetric estimator on the slab's camera segments, from the
    same photon rows in both packages (the grids bit for bit)."""
    jsc, tsc, types, rows, valid, beams, bvalid, rays, t_seg = slab
    lo, hi = tsc.world_lo, tsc.world_hi
    J = lambda x: jnp.asarray(x.numpy())
    r = 0.25
    if est == "point":
        tg = tppm._build_vol_grid_point(rows, valid, lo, hi, torch.tensor(2 * r))
        jg = jppm._build_vol_grid_point(J(rows), J(valid), J(lo), J(hi), jnp.float32(2 * r))
    elif est == "beamgrid":
        tg = tppm._build_vol_grid_ball(rows, valid, torch.tensor(r), lo, hi)
        jg = jppm._build_vol_grid_ball(J(rows), J(valid), jnp.float32(r), J(lo), J(hi))
    else:
        tg = tve.build_beam_cells(beams, bvalid, torch.tensor(r), lo, hi)
        jg = jve.build_beam_cells(J(beams), J(bvalid), jnp.float32(r), J(lo), J(hi))
    _same_grid(tg, jg)
    args = (rays.o, rays.d, t_seg)
    if est == "point":
        tL = tppm.volumetric_radiance(tsc, tg, *args, torch.tensor(r))
        jL = jppm.volumetric_radiance(jsc, jg, *map(J, args), jnp.float32(r))
        tT = tppm.transmittance_det(tsc, *args)
        jT = jppm.transmittance_det(jsc, *map(J, args))
    else:
        fn = "radiance_beamgrid" if est == "beamgrid" else "radiance_beambeam"
        tL, tT = getattr(tve, fn)(tsc, tg, *args, torch.tensor(r), max_per_cell=24)
        jL, jT = getattr(jve, fn)(jsc, jg, *map(J, args), jnp.float32(r), max_per_cell=24)
    assert float(tL.mean()) > 0
    np.testing.assert_allclose(tL.numpy(), _np(jL), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tT.numpy(), _np(jT), **TOL)


@pytest.mark.parametrize("est", ["point", "beambeam"])
def test_eye_pass_on_slab(slab, est):
    """The eye pass with the point and beambeam estimators on the slab
    (tests/test_vol_estimators.py's case, depth 5); the beamgrid route
    runs in the tracer test below."""
    jsc, tsc, types, rows, valid, beams, bvalid, _, _ = slab
    lo, hi = tsc.world_lo, tsc.world_hi
    J = lambda x: jnp.asarray(x.numpy())
    r = 0.25
    tg = tppm._build_surface_grid(rows, valid, lo, hi, torch.tensor(2 * r))
    jg = jppm._build_surface_grid(J(rows), J(valid), J(lo), J(hi), jnp.float32(2 * r))
    if est == "point":
        tv = tppm._build_vol_grid_point(rows, valid, lo, hi, torch.tensor(2 * r))
        jv = jppm._build_vol_grid_point(J(rows), J(valid), J(lo), J(hi), jnp.float32(2 * r))
    else:
        tv = tve.build_beam_cells(beams, bvalid, torch.tensor(r), lo, hi)
        jv = jve.build_beam_cells(J(beams), J(bvalid), jnp.float32(r), J(lo), J(hi))
    kw = dict(w=24, h=24, radius=r, n_emitted=4096.0, max_depth=5, active_types=types,
              with_volume=True, vol_est=est, vol_max_per_cell=24)
    tf_ = tppm.eye_pass(tsc, tfilm.new_film(24, 24, "cpu"), tg, tv, 1, **kw)
    jf_ = jppm.eye_pass(jsc, jfilm.new_film(24, 24), jg, jv, 1, **kw)
    assert _rel(tf_.rgb.numpy(), _np(jf_.rgb)) < 0.005
    np.testing.assert_array_equal(tf_.weight.numpy(), _np(jf_.weight))
