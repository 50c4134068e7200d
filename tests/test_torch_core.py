"""Core math of the port against the JAX package on random inputs.

Tolerance: rtol 1e-6, with atol 1e-6 for values near zero (cancellation in
cross products and frame changes). Neither side is exact: XLA on the CPU may
contract a*b+c into an FMA where PyTorch rounds twice. `refract` is held
to one ulp of its operands, the sRGB transfer functions to two ulp.

The shared inputs are made read-only and each test gets its own copies, so
no test can change what another one reads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import frame as jframe, mis as jmis
from cudatracerlib_tpu.core import fresnel as jfresnel, spectrum as jspectrum
from cudatracerlib_tpu.core import vecmath as jvm, warp as jwarp
from cudatracerlib_tpu_torch.core import frame as tframe, mis as tmis
from cudatracerlib_tpu_torch.core import fresnel as tfresnel, spectrum as tspectrum
from cudatracerlib_tpu_torch.core import vecmath as tvm, warp as twarp

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)
N = 4096


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.fixture(scope="module")
def shared_data():
    r = np.random.default_rng(5)
    a = r.normal(size=(N, 3)).astype(np.float32)
    b = r.normal(size=(N, 3)).astype(np.float32)
    n = a / np.linalg.norm(a, axis=1, keepdims=True)
    u2 = r.random((N, 2), dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3] = r.normal(size=(3, 4)).astype(np.float32)
    out = (a, b, n, u2, m)
    for x in out:
        x.setflags(write=False)
    return out


@pytest.fixture
def data(shared_data):
    return tuple(x.copy() for x in shared_data)


@pytest.mark.parametrize("name", ["dot", "cross", "normalize", "length",
                                  "reflect", "coordinate_system"])
def test_vecmath(data, name):
    a, b, n, _, _ = data
    ta, tb, tn = map(torch.from_numpy, (a, b, n))
    if name == "coordinate_system":
        for x, y in zip(tvm.coordinate_system(tn), jvm.coordinate_system(jnp.asarray(n))):
            _close(x, y)
        return
    args = {"dot": (a, b), "cross": (a, b), "normalize": (a,),
            "length": (a,), "reflect": (a, n)}[name]
    _close(getattr(tvm, name)(*map(torch.from_numpy, args)),
           getattr(jvm, name)(*map(jnp.asarray, args)))
    del ta, tb


def test_transforms(data):
    a, _, _, _, m = data
    _close(tvm.transform_vector(torch.from_numpy(m), torch.from_numpy(a)),
           jvm.transform_vector(jnp.asarray(m), jnp.asarray(a)))
    _close(tvm.transform_point(torch.from_numpy(m), torch.from_numpy(a)),
           jvm.transform_point(jnp.asarray(m), jnp.asarray(a)))


def test_frame(data):
    a, _, n, _, _ = data
    tf = tframe.Frame.from_normal(torch.from_numpy(n))
    jf = jframe.Frame.from_normal(jnp.asarray(n))
    loc = tf.to_local(torch.from_numpy(a))
    _close(loc, jf.to_local(jnp.asarray(a)))
    _close(tf.to_world(loc), jf.to_world(jf.to_local(jnp.asarray(a))))
    tfn = tframe.Frame.from_tn(torch.from_numpy(a), torch.from_numpy(n))
    jfn = jframe.Frame.from_tn(jnp.asarray(a), jnp.asarray(n))
    for x, y in zip(tfn, jfn):
        _close(x, y)
    for name in ["cos_theta", "abs_cos_theta", "sin_theta2", "sin_theta",
                 "tan_theta", "tan_theta2", "sin_phi", "cos_phi"]:
        _close(getattr(tframe, name)(torch.from_numpy(n)),
               getattr(jframe, name)(jnp.asarray(n)))


@pytest.mark.parametrize("name", [
    "square_to_uniform_sphere", "square_to_uniform_hemisphere",
    "square_to_uniform_disk",
    "square_to_uniform_disk_concentric", "square_to_uniform_triangle",
    "square_to_std_normal", "square_to_tent"])
def test_warp(data, name):
    u2 = data[3]
    _close(getattr(twarp, name)(torch.from_numpy(u2)),
           getattr(jwarp, name)(jnp.asarray(u2)))


def test_warp_cosine_hemisphere(data):
    # z = sqrt(1 - x^2 - y^2) magnifies one-ulp differences of sin/cos near
    # the rim, so z is compared through z^2, which has no such magnification
    u2 = data[3]
    t = twarp.square_to_cosine_hemisphere(torch.from_numpy(u2))
    j = np.asarray(jwarp.square_to_cosine_hemisphere(jnp.asarray(u2)))
    _close(t[:, :2], j[:, :2])
    _close(t[:, 2] ** 2, j[:, 2] ** 2)


def test_warp_cone_and_pdfs(data):
    u2, n = data[3], data[2]
    cc = np.linspace(-0.5, 0.99, N).astype(np.float32)
    _close(twarp.square_to_uniform_cone(torch.from_numpy(u2), torch.from_numpy(cc)),
           jwarp.square_to_uniform_cone(jnp.asarray(u2), jnp.asarray(cc)))
    _close(twarp.square_to_uniform_cone_pdf(torch.from_numpy(cc)),
           jwarp.square_to_uniform_cone_pdf(jnp.asarray(cc)))
    _close(twarp.square_to_cosine_hemisphere_pdf(torch.from_numpy(n)),
           jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(n)))


def test_mis(data):
    r = np.random.default_rng(9)
    pa, pb = (r.random(N, dtype=np.float32) * 10 for _ in range(2))
    pb[:16] = 0.0
    for name in ["balance_heuristic", "power_heuristic"]:
        _close(getattr(tmis, name)(torch.from_numpy(pa), torch.from_numpy(pb)),
               getattr(jmis, name)(jnp.asarray(pa), jnp.asarray(pb)))
    d2, c = pa + 0.1, pb - 5.0
    for name in ["pdf_area_to_solid_angle", "pdf_solid_angle_to_area"]:
        _close(getattr(tmis, name)(torch.from_numpy(pa), torch.from_numpy(d2),
                                   torch.from_numpy(c)),
               getattr(jmis, name)(jnp.asarray(pa), jnp.asarray(d2), jnp.asarray(c)))


def test_refract(data):
    """The refracted direction, both sides fed the same signed transmitted
    cosine (from the port's Fresnel term) at eta 1.1-2.5 and its inverse,
    incident from both sides: within one ulp of the operands (unit
    vectors, eta up to 2.5, so 3 ulp of 1.0 in absolute terms)."""
    a, b, n, _, _ = data
    r = np.random.default_rng(13)
    w = b / np.linalg.norm(b, axis=1, keepdims=True)
    eta = r.uniform(1.1, 2.5, N).astype(np.float32)
    eta[::2] = 1.0 / eta[::2]
    cos_i = np.sum(w * n, axis=1).astype(np.float32)
    _, cos_t = tfresnel.fresnel_dielectric_ext(torch.from_numpy(cos_i), torch.from_numpy(eta))
    cos_t = cos_t.numpy()
    got = tvm.refract(*map(torch.from_numpy, (w, n, eta, cos_t))).numpy()
    want = np.asarray(jvm.refract(*map(jnp.asarray, (w, n, eta, cos_t))))
    np.testing.assert_allclose(got, want, rtol=0, atol=3 * np.finfo(np.float32).eps)
    # the refracted direction is a unit vector on the far side
    ok = cos_t != 0
    np.testing.assert_allclose(np.linalg.norm(got[ok], axis=1), 1.0, atol=1e-5)
    assert (np.sign(np.sum(got * n, axis=1))[ok] == -np.sign(cos_i[ok])).all()
    _close(tfresnel.fresnel_dielectric_ext(torch.from_numpy(cos_i), torch.from_numpy(eta))[0],
           jfresnel.fresnel_dielectric_ext(jnp.asarray(cos_i), jnp.asarray(eta))[0])


@pytest.mark.parametrize("name", ["linear_to_srgb", "srgb_to_linear"])
def test_srgb_transfer(name):
    """Both transfer functions on [-0.1, 4] with both branches' ends:
    within two ulp. XLA's CPU pow and PyTorch's round the last bit
    differently, and the affine step around it (1.055 * p - 0.055, or
    (c + 0.055) / 1.055 before a pow of 2.4) can carry that into a second
    ulp of the result; on the branch ends the two sides are equal."""
    x = np.concatenate([np.linspace(-0.1, 4.0, N, dtype=np.float32),
                        np.float32([0.0, 0.0031308, 0.04045, 1.0])])
    got = getattr(tspectrum, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jspectrum, name)(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    np.testing.assert_array_equal(got[-4:], want[-4:])


# ---- the rest of core/: aabb, compression, dispersion, spline, quadrature --

from cudatracerlib_tpu.core import aabb as jaabb, compression as jcomp  # noqa: E402
from cudatracerlib_tpu.core import dispersion as jdisp, quadrature as jquad  # noqa: E402
from cudatracerlib_tpu.core import spline as jspline  # noqa: E402
from cudatracerlib_tpu_torch.core import aabb as taabb, compression as tcomp  # noqa: E402
from cudatracerlib_tpu_torch.core import dispersion as tdisp, quadrature as tquad  # noqa: E402
from cudatracerlib_tpu_torch.core import spline as tspline  # noqa: E402


def test_aabb(data):
    a, b, n, _, _ = data
    lo_np, hi_np = np.minimum(a, b), np.maximum(a, b)
    t = taabb.AABB(torch.from_numpy(lo_np), torch.from_numpy(hi_np))
    j = jaabb.AABB(jnp.asarray(lo_np), jnp.asarray(hi_np))
    p = n * 0.5
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    for name in ("center", "extents", "surface_area", "radius"):
        _close(getattr(t, name)(), getattr(j, name)())
    np.testing.assert_array_equal(t.contains(tp).numpy(), np.asarray(j.contains(jp)))
    for tb, jb in ((t.union(t.extend(tp)), j.union(j.extend(jp))),
                   (taabb.AABB.empty((4,)), jaabb.AABB.empty((4,)))):
        _close(tb.lo, jb.lo)
        _close(tb.hi, jb.hi)
    inv_d = 1.0 / np.where(np.abs(b) < 1e-6, 1e-6, b).astype(np.float32)
    th, tn = taabb.ray_aabb(t.lo, t.hi, tp, torch.from_numpy(inv_d), 0.0, 1e9)
    jh, jn = jaabb.ray_aabb(j.lo, j.hi, jp, jnp.asarray(inv_d), 0.0, 1e9)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    _close(tn, jn)
    assert bool(th.any()) and not bool(th.all())


def test_compression(data):
    _, _, n, u2, _ = data
    q = tcomp.normal_to_uint16(torch.from_numpy(n))
    jq = jcomp.normal_to_uint16(jnp.asarray(n))
    assert q.dtype == torch.uint16
    # a quantisation step decides each code: agree on all but rounding ties
    assert (q.to(torch.int32).numpy() != np.asarray(jq).astype(np.int32)).sum() <= 4
    dec = tcomp.uint16_to_normal(q)
    _close(dec, jcomp.uint16_to_normal(jnp.asarray(q.to(torch.int32).numpy()).astype(jnp.uint16)))
    assert float((dec * torch.from_numpy(n)).sum(-1).min()) > 0.99
    h = tcomp.f32_to_half(torch.from_numpy(u2))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jcomp.f32_to_half(jnp.asarray(u2))))
    np.testing.assert_array_equal(tcomp.half_to_f32(h).numpy(),
                                  np.asarray(jcomp.half_to_f32(jnp.asarray(h.numpy()))))
    np.testing.assert_array_equal(tcomp.uv_to_half2(torch.from_numpy(u2)).numpy(),
                                  np.asarray(jcomp.uv_to_half2(jnp.asarray(u2))))


def test_dispersion():
    r = np.random.default_rng(8)
    M = 64
    params = np.stack([r.uniform(1.3, 1.7, M), r.uniform(0.001, 0.02, M),
                       r.uniform(0.0, 1.0, M), r.uniform(0.001, 0.01, M),
                       r.uniform(0.01, 0.05, M), r.uniform(50, 150, M)], -1).astype(np.float32)
    dt = (np.arange(M) % 3).astype(np.int32)
    lam = r.uniform(0.38, 0.78, M).astype(np.float32)
    tp, jp = torch.from_numpy(params), jnp.asarray(params)
    _close(tdisp.eval_ior(torch.from_numpy(dt), tp, torch.from_numpy(lam)),
           jdisp.eval_ior(jnp.asarray(dt), jp, jnp.asarray(lam)))
    iors = tdisp.rgb_iors(torch.from_numpy(dt), tp)
    _close(iors, jdisp.rgb_iors(jnp.asarray(dt), jp))
    # shorter wavelengths bend more (Cauchy rows: B > 0)
    assert bool((iors[dt == 0, 2] > iors[dt == 0, 0]).all())


def test_spline():
    r = np.random.default_rng(9)
    vals = r.normal(size=33).astype(np.float32)
    table = r.normal(size=(17, 23)).astype(np.float32)
    x = r.uniform(-0.1, 1.1, 500).astype(np.float32)
    y = r.uniform(-0.1, 1.1, 500).astype(np.float32)
    _close(tspline.eval_1d(torch.from_numpy(vals), torch.from_numpy(x)),
           jspline.eval_1d(jnp.asarray(vals), jnp.asarray(x)))
    _close(tspline.eval_2d(torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(y)),
           jspline.eval_2d(jnp.asarray(table), jnp.asarray(x), jnp.asarray(y)))
    # the knots interpolate exactly
    knots = torch.arange(33, dtype=torch.float32) / 32
    torch.testing.assert_close(tspline.eval_1d(torch.from_numpy(vals), knots),
                               torch.from_numpy(vals), rtol=1e-6, atol=1e-6)
    # a scalar pair through the 1-D branch of eval_2d
    _close(tspline.eval_2d(torch.from_numpy(table), torch.tensor(0.37), torch.tensor(0.61)),
           jspline.eval_2d(jnp.asarray(table), jnp.float32(0.37), jnp.float32(0.61)))


@pytest.mark.parametrize("n", [4, 16])
def test_quadrature(n):
    x, w = tquad.gauss_legendre(n)
    jx, jw = jquad.gauss_legendre(n)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    a = np.linspace(-1.0, 0.5, 7).astype(np.float32)
    b = a + np.linspace(0.1, 2.0, 7).astype(np.float32)
    for f_t, f_j in ((lambda t: t ** 3 - 2 * t, lambda t: t ** 3 - 2 * t),
                     (torch.cos, jnp.cos)):
        _close(tquad.integrate(f_t, torch.from_numpy(a), torch.from_numpy(b), n=n),
               jquad.integrate(f_j, jnp.asarray(a), jnp.asarray(b), n=n))
        _close(tquad.integrate_lobatto7(f_t, torch.from_numpy(a), torch.from_numpy(b)),
               jquad.integrate_lobatto7(f_j, jnp.asarray(a), jnp.asarray(b)))
    # exact on a cubic
    exact = (b ** 4 - a ** 4) / 4 - (b ** 2 - a ** 2)
    got = tquad.integrate(lambda t: t ** 3 - 2 * t, torch.from_numpy(a),
                          torch.from_numpy(b), n=n)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
