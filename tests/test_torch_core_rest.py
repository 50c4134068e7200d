"""The last of the port's core/, the binary-BVH traversal and the BVH and
treelet helpers against the JAX package's.

- core/vecmath (vec3, distance, lerp, saturate, select, the spherical
  coordinates, the 4x4 helpers, transform_normal, look_at): equal to the
  JAX functions at rtol 1e-6 / atol 1e-6 (rtol 1e-5 where a
  transcendental or a matrix inverse is involved), and
  tests/test_core_math.py's transform and look-at cases.
- core/spectrum: RGBE and the 8-bit RGBA words bit for bit (the JAX
  uint32 words equal the port's int64 ones), their decodes exactly, the
  Yxy round trip (test_core_math.py's atol 1e-4) and the JAX values at
  rtol 1e-6; core/frame.same_hemisphere; the five records' fields.
- ops/traversal (intersect_bvh, occluded, intersect_bruteforce,
  moller_trumbore, pack_tris) on tests/test_bvh.py's random soups and
  rays: the BVH against brute force as test_bvh.py holds JAX's (hit masks
  equal, t within rtol 1e-4 / atol 1e-5, ids equal on more than 99% of
  hits), any-hit against closest-hit, tmax respected, axis-aligned rays;
  and against the JAX intersect_bvh: hit masks equal, t at rtol 1e-5,
  ids equal where t is separated from the next triangle's (both packages
  round the same Moller-Trumbore test, the JAX one with XLA's fused
  cross products).
- scene/bvh.flatten_leaf_stats equal to JAX's on the same build;
  scene/treelet.unified_equivalent byte for byte JAX's on the Cornell box
  partitioned with tests/test_treelet.py's small limits, and traversing it
  gives the unsplit table's hits (test_treelet.py:55's case).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import frame as jframe
from cudatracerlib_tpu.core import records as jrecords
from cudatracerlib_tpu.core import spectrum as jspec
from cudatracerlib_tpu.core import vecmath as jvm
from cudatracerlib_tpu.ops import traversal as jtrv
from cudatracerlib_tpu.scene import bvh as jbvh
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.core import frame as tframe
from cudatracerlib_tpu_torch.core import records as trecords
from cudatracerlib_tpu_torch.core import spectrum as tspec
from cudatracerlib_tpu_torch.core import vecmath as tvm
from cudatracerlib_tpu_torch.ops import traversal as ttrv
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.scene import bvh as tbvh
from cudatracerlib_tpu_torch.scene import treelet as ttreelet
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _v(n, seed, d=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_vecmath_elementwise_as_jax():
    a, b, t = _v(200, 1), _v(200, 2), np.random.default_rng(3).random(200).astype(np.float32)
    n = (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    mask = t > 0.5
    for name, args in (("distance", (a, b)), ("distance_sqr", (a, b)),
                       ("lerp", (a, b, t[:, None])), ("saturate", (a,)),
                       ("select", (mask, a, b))):
        got = getattr(tvm, name)(*map(_t, args)).numpy()
        want = np.asarray(getattr(jvm, name)(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    np.testing.assert_array_equal(tvm.vec3(1.0, _t(t), 3).numpy(),
                                  np.asarray(jvm.vec3(1.0, jnp.asarray(t), 3)))
    st, ct, phi = np.sin(t * 3), np.cos(t * 3), t * 6
    np.testing.assert_allclose(
        tvm.spherical_direction(*map(_t, (st, ct, phi))).numpy(),
        np.asarray(jvm.spherical_direction(*map(jnp.asarray, (st, ct, phi)))),
        rtol=1e-5, atol=1e-6)
    for name in ("spherical_theta", "spherical_phi"):
        np.testing.assert_allclose(getattr(tvm, name)(_t(n)).numpy(),
                                   np.asarray(getattr(jvm, name)(jnp.asarray(n))),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert tvm.EPS == jvm.EPS and tvm.INF == float(jvm.INF)


def test_mat4_as_jax_and_test_core_math():
    pairs = [(tvm.mat4_identity(), jvm.mat4_identity()),
             (tvm.mat4_translate([1, 2, 3]), jvm.mat4_translate([1, 2, 3])),
             (tvm.mat4_scale(2.0), jvm.mat4_scale(2.0)),
             (tvm.mat4_scale([1.0, 2.0, 3.0]), jvm.mat4_scale([1.0, 2.0, 3.0])),
             (tvm.mat4_rotate([1, 2, 3], 0.7), jvm.mat4_rotate([1, 2, 3], 0.7)),
             (tvm.look_at([1, 2, -3], [0, 0, 5], [0, 1, 0]),
              jvm.look_at([1, 2, -3], [0, 0, 5], [0, 1, 0]))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    m = tvm.mat4_mul(tvm.mat4_translate([1, 2, 3]), tvm.mat4_scale(2.0))
    p = torch.tensor([1.0, 1.0, 1.0])
    np.testing.assert_allclose(tvm.transform_point(m, p).numpy(), [3, 4, 5], atol=1e-6)
    np.testing.assert_allclose(tvm.transform_vector(m, p).numpy(), [2, 2, 2], atol=1e-6)
    minv = tvm.mat4_inverse(m)
    np.testing.assert_allclose(tvm.transform_point(minv, tvm.transform_point(m, p)).numpy(),
                               p.numpy(), atol=1e-5)
    la = tvm.look_at([0, 0, 0], [0, 0, 5], [0, 1, 0])
    np.testing.assert_allclose(tvm.transform_vector(la, torch.tensor([0., 0., 1.])).numpy(),
                               [0, 0, 1], atol=1e-6)
    rot = tvm.mat4_rotate([0.3, -1, 2], 1.1)
    nrm = _v(50, 4)
    np.testing.assert_allclose(
        tvm.transform_normal(tvm.mat4_inverse(rot), _t(nrm)).numpy(),
        np.asarray(jvm.transform_normal(jnp.linalg.inv(jnp.asarray(rot.numpy())),
                                        jnp.asarray(nrm))), rtol=1e-5, atol=1e-5)


def test_rgbe_and_rgbcol_bit_for_bit():
    r = np.random.default_rng(7)
    rgb = (r.random((1000, 3)) * 100.0).astype(np.float32)
    rgb[:3] = [[0, 0, 0], [1e-40, 0, 0], [-1, 2, 0.5]]
    got, want = tspec.to_rgbe(_t(rgb)), np.asarray(jspec.to_rgbe(jnp.asarray(rgb)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(tspec.from_rgbe(got).numpy(),
                                  np.asarray(jspec.from_rgbe(jnp.asarray(want))))
    # test_core_math.py's round trip on the random colours
    dec = tspec.from_rgbe(got).numpy()[3:]
    tol = np.max(rgb[3:], axis=-1, keepdims=True) / 128.0
    assert np.all(np.abs(dec - rgb[3:]) <= tol)
    c = (r.random((500, 3)) * 1.4 - 0.2).astype(np.float32)
    got, want = tspec.to_rgbcol(_t(c)), np.asarray(jspec.to_rgbcol(jnp.asarray(c)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(tspec.from_rgbcol(got).numpy(),
                                  np.asarray(jspec.from_rgbcol(jnp.asarray(want))))


def test_yxy_as_jax():
    xyz = np.random.default_rng(6).random((100, 3)).astype(np.float32) + 0.01
    yxy = tspec.xyz_to_yxy(_t(xyz))
    np.testing.assert_allclose(yxy.numpy(), np.asarray(jspec.xyz_to_yxy(jnp.asarray(xyz))),
                               **TOL)
    np.testing.assert_allclose(tspec.yxy_to_xyz(yxy).numpy(), xyz, atol=1e-4)
    np.testing.assert_allclose(tspec.yxy_to_xyz(yxy).numpy(),
                               np.asarray(jspec.yxy_to_xyz(jnp.asarray(yxy.numpy()))), **TOL)


def test_same_hemisphere_and_records():
    a, b = _v(100, 8), _v(100, 9)
    a[0, 2] = 0.0
    np.testing.assert_array_equal(tframe.same_hemisphere(_t(a), _t(b)).numpy(),
                                  np.asarray(jframe.same_hemisphere(jnp.asarray(a),
                                                                    jnp.asarray(b))))
    for name in ("PositionSample", "DirectionSample", "DirectSample", "BSDFSample",
                 "PhaseSample"):
        assert getattr(trecords, name)._fields == getattr(jrecords, name)._fields, name


def _random_soup(n_tris, seed=0, spread=4.0):
    r = np.random.default_rng(seed)
    base = (r.random((n_tris, 3)) - 0.5) * spread
    v1 = base + (r.random((n_tris, 3)) - 0.5) * 0.7
    v2 = base + (r.random((n_tris, 3)) - 0.5) * 0.7
    return base.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32)


def _random_rays(n, seed=1, spread=4.0):
    r = np.random.default_rng(seed)
    o = ((r.random((n, 3)) - 0.5) * spread * 1.5).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _both(o, d, tmax=1e10):
    n = o.shape[0]
    t = ttrv.Rays(_t(o), _t(d), torch.full((n,), 1e-4), torch.full((n,), tmax))
    j = jtrv.Rays(jnp.asarray(o), jnp.asarray(d), jnp.full(n, 1e-4, jnp.float32),
                  jnp.full(n, tmax, jnp.float32))
    return t, j


def _soup(n_tris, seed):
    v0, v1, v2 = _random_soup(n_tris, seed=seed)
    b = tbvh.build_bvh(v0, v1, v2)
    tris = ttrv.pack_tris(v0, v1, v2)
    np.testing.assert_array_equal(tris, jtrv.pack_tris(v0, v1, v2))
    return b, tris, (v0, v1, v2)


@pytest.mark.parametrize("n_tris,n_rays,seed", [(64, 256, 2), (2000, 512, 3)])
def test_bvh_matches_bruteforce_and_jax(n_tris, n_rays, seed):
    b, tris, verts = _soup(n_tris, seed)
    jb = jbvh.build_bvh(*verts)
    np.testing.assert_array_equal(b.nodes, jb.nodes)
    assert tbvh.flatten_leaf_stats(b) == jbvh.flatten_leaf_stats(jb)
    trays, jrays = _both(*_random_rays(n_rays, seed=seed + 100))
    h = ttrv.intersect_bvh(_t(b.nodes), _t(tris), _t(b.tri_order), trays)
    ref = ttrv.intersect_bruteforce(_t(tris), trays)
    hit = (h.tri >= 0).numpy()
    np.testing.assert_array_equal(hit, (ref.tri >= 0).numpy())
    np.testing.assert_allclose(h.t.numpy()[hit], ref.t.numpy()[hit], rtol=1e-4, atol=1e-5)
    assert (h.tri == ref.tri).numpy()[hit].mean() > 0.99
    assert hit.mean() > 0.01
    jh = jtrv.intersect_bvh(jnp.asarray(b.nodes), jnp.asarray(tris),
                            jnp.asarray(b.tri_order), jrays)
    jref = jtrv.intersect_bruteforce(jnp.asarray(tris), jrays)
    np.testing.assert_array_equal(hit, np.asarray(jh.tri) >= 0)
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=1e-5)
    np.testing.assert_allclose(ref.t.numpy(), np.asarray(jref.t), rtol=1e-5)
    # ids where the nearest hit is clearly separated from every other
    # triangle's on the ray (brute force over the soup, in float64)
    v0, v1, v2 = (x.astype(np.float64) for x in verts)
    o, d = (np.asarray(x, np.float64) for x in (jrays.o, jrays.d))
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d[:, None], e2[None])
    det = (e1[None] * p).sum(-1)
    tv = o[:, None] - v0[None]
    q = np.cross(tv, e1[None])
    with np.errstate(divide="ignore", invalid="ignore"):
        u, v, tt = ((tv * p).sum(-1) / det, (d[:, None] * q).sum(-1) / det,
                    (e2[None] * q).sum(-1) / det)
    tt = np.where((u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 1e-4), tt, np.inf)
    two = np.sort(tt, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):
        sep = hit & (two[:, 1] - two[:, 0] > 1e-4 * np.maximum(two[:, 0], 1.0))
    np.testing.assert_array_equal(h.tri.numpy()[sep], np.asarray(jh.tri)[sep])


def test_any_hit_tmax_and_axis_aligned_rays():
    b, tris, _ = _soup(500, 4)
    args = (_t(b.nodes), _t(tris), _t(b.tri_order))
    trays, _ = _both(*_random_rays(512, seed=5))
    h = ttrv.intersect_bvh(*args, trays)
    np.testing.assert_array_equal(ttrv.occluded(*args, trays).numpy(), (h.tri >= 0).numpy())
    # a single triangle at z = 5: hit with tmax 10, missed with tmax 4
    v0 = np.array([[-1, -1, 5.0]], np.float32)
    v1 = np.array([[1, -1, 5.0]], np.float32)
    v2 = np.array([[0, 1, 5.0]], np.float32)
    b1 = tbvh.build_bvh(v0, v1, v2)
    one = (_t(b1.nodes), _t(ttrv.pack_tris(v0, v1, v2)), _t(b1.tri_order))
    for tmax, want in ((10.0, 0), (4.0, -1)):
        r = ttrv.Rays(torch.zeros(1, 3), torch.tensor([[0., 0., 1.]]),
                      torch.tensor([1e-4]), torch.tensor([tmax]))
        hh = ttrv.intersect_bvh(*one, r)
        assert int(hh.tri[0]) == want
        if want == 0:
            assert abs(float(hh.t[0]) - 5.0) < 1e-4
    # rays with zero direction components: the safe-reciprocal path
    b2, tris2, _ = _soup(200, 6)
    n = 128
    o = np.zeros((n, 3), np.float32)
    o[:, 0], o[:, 2] = np.linspace(-2, 2, n), -5.0
    d = np.tile(np.array([[0., 0., 1.]], np.float32), (n, 1))
    trays, _ = _both(o, d)
    hb = ttrv.intersect_bvh(_t(b2.nodes), _t(tris2), _t(b2.tri_order), trays)
    hr = ttrv.intersect_bruteforce(_t(tris2), trays)
    hit = (hb.tri >= 0).numpy()
    np.testing.assert_array_equal(hit, (hr.tri >= 0).numpy())
    np.testing.assert_allclose(hb.t.numpy()[hit], hr.t.numpy()[hit], rtol=1e-4, atol=1e-5)


def test_moller_trumbore_as_jax():
    (v0, v1, v2), (o, d) = _random_soup(300, seed=11), _random_rays(300, seed=12, spread=0.5)
    args = (v0, v1 - v0, v2 - v0, o, d, np.full(300, 1e-4, np.float32),
            np.full(300, 1e10, np.float32))
    tv, tt, tu, tvv = ttrv.moller_trumbore(*map(_t, args))
    jv, jt, ju, jvv = jtrv.moller_trumbore(*map(jnp.asarray, args))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for a, b in ((tt, jt), (tu, ju), (tvv, jvv)):
        np.testing.assert_allclose(a.numpy()[tv.numpy()], np.asarray(b)[tv.numpy()],
                                   rtol=1e-4, atol=1e-5)


def test_unified_equivalent_as_jax():
    """tests/test_treelet.py:55's case on the port's partition."""
    jsc = jscenes.cornell_box(64, 64).build()
    tsc = tscenes.cornell_box(64, 64).build("cpu")
    table = tsc.geom.wide.numpy()
    np.testing.assert_array_equal(table, np.asarray(jsc.geom.wide))
    tpart = ttreelet.partition(table, treelet_rows=128, max_top_rows=256)
    jpart = jtreelet.partition(np.asarray(jsc.geom.wide), treelet_rows=128,
                               max_top_rows=256)
    giant = ttreelet.unified_equivalent(tpart)
    np.testing.assert_array_equal(giant, jtreelet.unified_equivalent(jpart))
    from cudatracerlib_tpu_torch.models import tracer as ttracer
    pix = torch.arange(2048, dtype=torch.int32) * 2
    rays = ttracer.gen_camera_rays(tsc, pix, 0, 0, 64, 64)[0]
    h_ref = traversal8.intersect_wide(tsc.geom.wide, rays)
    h_eq = traversal8.intersect_wide(_t(giant), rays)
    np.testing.assert_allclose(h_eq.t.numpy(), h_ref.t.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(h_eq.tri.numpy(), h_ref.tri.numpy())
