"""The port's Fresnel terms, microfacet distributions and conductor BSDFs
against the JAX package's, on the same seeded inputs.

Integer outputs (sampled types, the RNG state after sampling) match bit for
bit. Floats match to rtol 1e-5 / atol 1e-6, as in the other port tests:
XLA on the CPU contracts a*b+c into FMAs where PyTorch rounds twice, and
their transcendental functions may differ in the last bit. Where D or G is
large, rtol widens to 1e-4: at alpha 0.005 a GGX D reaches ~1.3e4 near the
half vector's peak, and D's ~(1 + e)^-2 falloff amplifies a one-ulp
difference in e (a sum of squares divided by cos^2, contracted differently
on each side) by up to ~4 e / (1 + e), about 40x ulp at the steepest point.
Sampled micronormals and directions get atol 1e-5: at small alpha their
sin(theta) = sqrt(1 - cos^2) cancels (cos within 2e-4 of 1), which
amplifies a one-ulp difference of cos by 1 / (1 - cos^2), up to ~6e-6 in
the small x and y components of a unit vector. A quantity evaluated at a
sampled direction (its pdf, its weight) then differs through the direction:
at alpha 0.005 a shift of 1e-5 moves D by ~1e-3. So the sampled direction
is held to JAX's, and what each side computes at it is held to what the
other side computes at the port's own direction."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import fresnel as jfresnel
from cudatracerlib_tpu.core import microfacet as jmf
from cudatracerlib_tpu.models import bsdf as jbsdf
from cudatracerlib_tpu_torch.core import fresnel as tfresnel
from cudatracerlib_tpu_torch.core import microfacet as tmf
from cudatracerlib_tpu_torch.core import records
from cudatracerlib_tpu_torch.models import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene import schema

torch.set_num_threads(2)
N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
PEAK_TOL = dict(rtol=1e-4, atol=1e-6)   # large D or G: see the module note
DIR_TOL = dict(rtol=1e-4, atol=1e-5)    # sampled directions: see the module note
TYPES = (schema.BSDF_DIFFUSE, schema.BSDF_CONDUCTOR, schema.BSDF_ROUGHCONDUCTOR)


def _close(t, j, tol=TOL, err_msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=err_msg, **tol)


def _unit(r, n, up_share):
    v = r.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    flip = r.random(n) < up_share
    v[:, 2] = np.where(flip, np.abs(v[:, 2]), -np.abs(v[:, 2]))
    return v


@pytest.fixture(scope="module")
def data():
    return _make_data()


def _make_data():
    r = np.random.default_rng(11)
    wi, wo = _unit(r, N, 0.9), _unit(r, N, 0.9)
    u = r.random((N, 3), dtype=np.float32)
    dist = r.integers(0, 3, N).astype(np.int32)
    ax = np.exp(r.uniform(np.log(0.005), np.log(0.6), N)).astype(np.float32)
    ay = np.where(r.random(N) < 0.5, ax,
                  np.exp(r.uniform(np.log(0.005), np.log(0.6), N))).astype(np.float32)
    params = np.zeros((N, schema.N_MAT_PARAMS), np.float32)
    params[:, 0:3] = r.random((N, 3))
    params[:, 5] = r.integers(0, 2, N)        # Beckmann or GGX (the scenes use GGX)
    params[:, 6], params[:, 7] = ax, ay
    params[:, 8:11] = r.uniform(0.1, 1.5, (N, 3))
    params[:, 11:14] = r.uniform(1.0, 4.0, (N, 3))
    params[:, 22] = (r.random(N) < 0.8).astype(np.float32)
    mat = np.array(TYPES, np.int32)[r.integers(0, 3, N)]
    c0 = r.random((N, 3)).astype(np.float32)
    state = r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    return dict(wi=wi, wo=wo, u=u, dist=dist, ax=ax, ay=ay, params=params,
                mat=mat, c0=c0, state=state)


def _ctx(mod, d, lib):
    a = (lambda x: torch.from_numpy(np.ascontiguousarray(x))) if lib == "torch" else jnp.asarray
    z = np.zeros(N, np.int32)
    return mod.BsdfCtx(mat_type=a(d["mat"]), params=a(d["params"]), c0=a(d["c0"]),
                       c1=a(d["c0"]), n_type=a(z), n_params=a(d["params"]),
                       n_c0=a(d["c0"]), n_c1=a(d["c0"]), n2_type=a(z),
                       n2_params=a(d["params"]), n2_c0=a(d["c0"]), n2_c1=a(d["c0"]))


def test_fresnel(data):
    r = np.random.default_rng(3)
    cos = r.uniform(-1.0, 1.0, N).astype(np.float32)
    eta = r.uniform(0.5, 2.5, N).astype(np.float32)
    eta[:64] = 1.0                              # the eta == 1 branch
    ft, ct = tfresnel.fresnel_dielectric_ext(torch.from_numpy(cos), torch.from_numpy(eta))
    fj, cj = jfresnel.fresnel_dielectric_ext(jnp.asarray(cos), jnp.asarray(eta))
    _close(ft, fj)
    _close(ct, cj)
    _close(tfresnel.fresnel_dielectric(torch.from_numpy(cos), 1.5),
           jfresnel.fresnel_dielectric(jnp.asarray(cos), 1.5))
    p = data["params"]
    _close(tfresnel.fresnel_conductor_exact(torch.from_numpy(cos), torch.from_numpy(p[:, 8:11]),
                                            torch.from_numpy(p[:, 11:14])),
           jfresnel.fresnel_conductor_exact(jnp.asarray(cos), jnp.asarray(p[:, 8:11]),
                                            jnp.asarray(p[:, 11:14])))
    _close(tfresnel.fresnel_diffuse_reflectance(torch.from_numpy(eta)),
           jfresnel.fresnel_diffuse_reflectance(jnp.asarray(eta)))


@pytest.mark.parametrize("dist", [jmf.BECKMANN, jmf.GGX, jmf.PHONG])
def test_microfacet(data, dist):
    d = data
    dist_a = np.full(N, dist, np.int32)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items() if k != "params"}
    j = {k: jnp.asarray(v) for k, v in d.items() if k != "params"}
    td, jd = torch.from_numpy(dist_a), jnp.asarray(dist_a)
    m_t = torch.nn.functional.normalize(t["wi"] + t["wo"], dim=-1)
    m_j = jnp.asarray(m_t.numpy())
    _close(tmf.eval_d(td, t["ax"], t["ay"], m_t), jmf.eval_d(jd, j["ax"], j["ay"], m_j),
           PEAK_TOL)
    _close(tmf._project_roughness(t["ax"], t["ay"], t["wi"]),
           jmf._project_roughness(j["ax"], j["ay"], j["wi"]))
    _close(tmf.smith_g1(td, t["ax"], t["ay"], t["wi"], m_t),
           jmf.smith_g1(jd, j["ax"], j["ay"], j["wi"], m_j))
    _close(tmf.smith_g(td, t["ax"], t["ay"], t["wi"], t["wo"], m_t),
           jmf.smith_g(jd, j["ax"], j["ay"], j["wi"], j["wo"], m_j))
    _close(tmf.pdf(td, t["ax"], t["ay"], t["wi"], m_t),
           jmf.pdf(jd, j["ax"], j["ay"], j["wi"], m_j), PEAK_TOL)
    _close(tmf.pdf_visible(td, t["ax"], t["ay"], t["wi"], m_t),
           jmf.pdf_visible(jd, j["ax"], j["ay"], j["wi"], m_j), PEAK_TOL)
    u2t, u2j = t["u"][:, 1:3].contiguous(), j["u"][:, 1:3]
    for vis in (True, False):
        mt, pt = tmf.sample(td, t["ax"], t["ay"], t["wi"], u2t, sample_visible=vis)
        mj, _ = jmf.sample(jd, j["ax"], j["ay"], j["wi"], u2j, sample_visible=vis)
        _close(mt, mj, DIR_TOL)
        # the sample's pdf is the pdf at its micronormal
        _close(pt, jmf.pdf(jd, j["ax"], j["ay"], j["wi"], jnp.asarray(mt.numpy()),
                           sample_visible=vis), PEAK_TOL)


def test_conductor_evaluate(data):
    tl = tbsdf.evaluate(_ctx(tbsdf, data, "torch"), torch.from_numpy(data["wi"]),
                        torch.from_numpy(data["wo"]), TYPES)
    jl = jbsdf.evaluate(_ctx(jbsdf, data, "jax"), jnp.asarray(data["wi"]),
                        jnp.asarray(data["wo"]), TYPES)
    _close(tl.f, jl.f, PEAK_TOL)
    _close(tl.pdf, jl.pdf, PEAK_TOL)
    # the smooth conductor is a pure delta: nothing to evaluate
    cond = data["mat"] == schema.BSDF_CONDUCTOR
    assert cond.any() and float(tl.f[torch.from_numpy(cond)].abs().max()) == 0.0
    rough = torch.from_numpy(data["mat"] == schema.BSDF_ROUGHCONDUCTOR)
    assert float(tl.pdf[rough].max()) > 0.0


def test_conductor_sample(data):
    tctx, jctx = _ctx(tbsdf, data, "torch"), _ctx(jbsdf, data, "jax")
    ts, tstate = tbsdf.sample_with_rng(tctx, torch.from_numpy(data["wi"]),
                                       torch.from_numpy(data["state"].astype(np.int64)),
                                       TYPES)
    js, jstate = jbsdf.sample_with_rng(jctx, jnp.asarray(data["wi"]),
                                       jnp.asarray(data["state"]), TYPES)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate).astype(np.int64))
    np.testing.assert_array_equal(ts.sampled_type.numpy(), np.asarray(js.sampled_type))
    _close(ts.wo, js.wo, DIR_TOL, err_msg="wo")
    for name in ("weight", "pdf", "eta"):
        _close(getattr(ts, name), getattr(js, name), PEAK_TOL, err_msg=name)
    # every lane sampled its own material's lobe
    want = {schema.BSDF_DIFFUSE: records.T_DIFFUSE_REFLECTION,
            schema.BSDF_CONDUCTOR: records.T_DELTA_REFLECTION,
            schema.BSDF_ROUGHCONDUCTOR: records.T_GLOSSY_REFLECTION}
    for t, kind in want.items():
        assert set(ts.sampled_type[torch.from_numpy(data["mat"] == t)].tolist()) == {kind}


def test_unported_bsdf_types_still_raise(data):
    """Every BSDF type is ported (the name is kept from when some raised):
    evaluate over all 16 types runs and gives finite lobes; the new types
    are held to JAX in tests/test_torch_bsdf_types.py."""
    params = data["params"].copy()
    params[:, 4] = 1.5                          # eta
    params[:, 15] = 30.0                        # the Phong exponent
    params[:, 17] = 1.0                         # the HK slab's thickness
    params[:, 18] = 0.5                         # the blend weight
    ctx = _ctx(tbsdf, dict(data, params=params), "torch")
    assert tbsdf.PORTED_TYPES == tbsdf.ALL_TYPES == tuple(range(16))
    mats = torch.from_numpy(np.resize(np.arange(16, dtype=np.int32), N))
    lob = tbsdf.evaluate(ctx._replace(mat_type=mats), torch.from_numpy(data["wi"]),
                         torch.from_numpy(data["wo"]), tbsdf.ALL_TYPES)
    assert lob.f.isfinite().all() and lob.pdf.isfinite().all()
    assert float(lob.pdf[mats == schema.BSDF_ROUGHDIFFUSE].max()) > 0.0


# the only type of its lanes: every other type's closed forms would run on
# all 2^19 lanes and be masked away
ROUGH_ONLY = (schema.BSDF_ROUGHCONDUCTOR,)


@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.3])
def test_roughconductor_sample_matches_evaluate(alpha):
    """The rough conductor's albedo two ways, with GGX and the veach bars'
    eta_c and k_c: the mean weight of sampled directions, and the
    uniform-hemisphere integral of evaluate()'s f * cos. They agree within
    3% (the Monte Carlo noise of 2^19 uniform directions at alpha 0.05), so
    the sampler and the evaluation that MIS weighs against it describe one
    lobe."""
    n = 1 << 19
    gen = torch.Generator().manual_seed(5)
    p = torch.zeros(n, schema.N_MAT_PARAMS)
    p[:, 5] = 1.0                                # GGX
    p[:, 6] = p[:, 7] = alpha
    p[:, 8:11] = torch.tensor([0.2, 0.92, 1.1])
    p[:, 11:14] = torch.tensor([3.9, 2.45, 2.14])
    c0 = torch.ones(n, 3)
    z = torch.zeros(n, dtype=torch.int32)
    ctx = tbsdf.BsdfCtx(mat_type=torch.full((n,), schema.BSDF_ROUGHCONDUCTOR,
                                            dtype=torch.int32),
                        params=p, c0=c0, c1=c0, n_type=z, n_params=p, n_c0=c0,
                        n_c1=c0, n2_type=z, n2_params=p, n2_c0=c0, n2_c1=c0)
    for cos_i in (0.9, 0.5, 0.2):
        wi = torch.tensor([(1.0 - cos_i ** 2) ** 0.5, 0.0, cos_i]).expand(n, 3).contiguous()
        sampled = tbsdf.sample(ctx, wi, torch.rand(n, 3, generator=gen),
                               ROUGH_ONLY).weight.mean(0)
        u = torch.rand(n, 2, generator=gen)
        r, phi = (1.0 - u[:, 0] ** 2).clamp_min(0.0).sqrt(), 2.0 * np.pi * u[:, 1]
        wo = torch.stack([r * phi.cos(), r * phi.sin(), u[:, 0]], 1)
        uniform = tbsdf.evaluate(ctx, wi, wo, ROUGH_ONLY).f.mean(0) * (2.0 * np.pi)
        np.testing.assert_allclose(sampled.numpy(), uniform.numpy(), rtol=0.03,
                                   err_msg=f"alpha {alpha}, cos_i {cos_i}")


# the smooth dielectric and the thin dielectric at chosen incident
# directions: (cos theta range, sign) of wi.z per case; with eta 1.5 (and
# eta 1.3-1.8 (and the dispersive channels' eta above it), inside-out lanes
# with |cos| < 0.63 meet total internal reflection
WI_CASES = {"normal": (0.999, 1.0, 1.0), "grazing": (1e-4, 0.02, 1.0),
            "inside_out": (0.75, 1.0, -1.0), "tir": (1e-3, 0.6, -1.0)}
DELTA_TYPES = (schema.BSDF_DIFFUSE, schema.BSDF_DIELECTRIC,
               schema.BSDF_THINDIELECTRIC)


def _dielectric_data(case, dispersive):
    lo, hi, sign = WI_CASES[case]
    r = np.random.default_rng(21 + 2 * list(WI_CASES).index(case) + dispersive)
    cos = r.uniform(lo, hi, N).astype(np.float32)
    phi = r.uniform(0.0, 2.0 * np.pi, N)
    sin = np.sqrt(np.maximum(1.0 - cos.astype(np.float64) ** 2, 0.0))
    wi = np.stack([sin * np.cos(phi), sin * np.sin(phi), sign * cos], 1).astype(np.float32)
    if case == "normal":
        wi[:16] = (0.0, 0.0, sign)           # exactly along the normal
    params = np.zeros((N, schema.N_MAT_PARAMS), np.float32)
    params[:, 4] = r.uniform(1.3, 1.8, N)
    params[:4096 // 2, 4] = 1.5
    params[:, 22] = 1.0                      # two-sided: ignored by transmissive types
    if dispersive:
        params[:, 23] = r.uniform(0.002, 0.01, N)
    mat = np.array(DELTA_TYPES, np.int32)[r.integers(0, 3, N)]
    c0 = r.random((N, 3)).astype(np.float32)
    state = r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    return dict(wi=wi, wo=wi, params=params, mat=mat, c0=c0, state=state)


@pytest.mark.parametrize("dispersive", [False, True], ids=["rgb", "dispersive"])
@pytest.mark.parametrize("case", list(WI_CASES))
def test_dielectric_sample(case, dispersive):
    """The dielectric and thin-dielectric samplers (through sample_with_rng,
    beside diffuse lanes): the RNG state after sampling and the sampled
    types bit for bit; wo at DIR_TOL (near the critical angle refraction's
    cos_t = sqrt(1 - eta^2 sin^2) cancels); weight, pdf and eta at TOL."""
    d = _dielectric_data(case, dispersive)
    ts, tstate = tbsdf.sample_with_rng(_ctx(tbsdf, d, "torch"),
                                       torch.from_numpy(d["wi"]),
                                       torch.from_numpy(d["state"].astype(np.int64)),
                                       DELTA_TYPES)
    js, jstate = jbsdf.sample_with_rng(_ctx(jbsdf, d, "jax"), jnp.asarray(d["wi"]),
                                       jnp.asarray(d["state"]), DELTA_TYPES)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate).astype(np.int64))
    np.testing.assert_array_equal(ts.sampled_type.numpy(), np.asarray(js.sampled_type))
    _close(ts.wo, js.wo, DIR_TOL, err_msg="wo")
    for name in ("weight", "pdf", "eta"):
        _close(getattr(ts, name), getattr(js, name), TOL, err_msg=name)
    st = ts.sampled_type.numpy()
    diel = d["mat"] == schema.BSDF_DIELECTRIC
    if case == "tir":
        # total internal reflection: every dielectric lane reflects
        assert (st[diel] == records.T_DELTA_REFLECTION).all()
    else:
        assert (st[diel] == records.T_DELTA_TRANSMISSION).any()
    refr = diel & (st == records.T_DELTA_TRANSMISSION)
    # refraction crosses the boundary
    assert (np.sign(ts.wo.numpy()[refr, 2]) == -np.sign(d["wi"][refr, 2])).all()
    if dispersive and case != "tir":
        # a refracted dispersive path carries one channel (x3), the others 0
        w = ts.weight.numpy()[refr]
        assert ((w > 0).sum(1) <= 1).all() and (w > 0).any()


def test_delta_types_are_zero_lobes_and_delta_only():
    d = _dielectric_data("normal", False)
    r = np.random.default_rng(4)
    wo = _unit(r, N, 0.5)
    tl = tbsdf.evaluate(_ctx(tbsdf, d, "torch"), torch.from_numpy(d["wi"]),
                        torch.from_numpy(wo), DELTA_TYPES)
    jl = jbsdf.evaluate(_ctx(jbsdf, d, "jax"), jnp.asarray(d["wi"]), jnp.asarray(wo),
                        DELTA_TYPES)
    _close(tl.f, jl.f)
    _close(tl.pdf, jl.pdf)
    delta = d["mat"] != schema.BSDF_DIFFUSE
    assert float(tl.f[torch.from_numpy(delta)].abs().max()) == 0.0
    mats = np.arange(16, dtype=np.int32)
    d = dict(d, mat=np.resize(mats, N))
    np.testing.assert_array_equal(tbsdf.is_delta_only(_ctx(tbsdf, d, "torch")).numpy(),
                                  np.asarray(jbsdf.is_delta_only(_ctx(jbsdf, d, "jax"))))
    assert tbsdf.is_delta_only(_ctx(tbsdf, d, "torch"))[:16].tolist() == [
        t in (2, 3, 5, 15) for t in range(16)]
    assert set(DELTA_TYPES) <= set(tbsdf.PORTED_TYPES)


def test_dielectric_spectral_branch_raises():
    """The dielectric's hero-wavelength branch (spectral transport, ported
    since it first raised here): the continuous Cauchy eta at each lane's
    wavelength, no channel roulette; held to the JAX branch as
    test_dielectric_sample holds the RGB one."""
    for case in ("normal", "inside_out", "tir"):
        d = _dielectric_data(case, True)
        lam = np.random.default_rng(9).uniform(0.38, 0.72, N).astype(np.float32)
        u = np.random.default_rng(10).random((N, 3)).astype(np.float32)
        ts = tbsdf.sample(_ctx(tbsdf, d, "torch")._replace(lam_um=torch.from_numpy(lam)),
                          torch.from_numpy(d["wi"]), torch.from_numpy(u), DELTA_TYPES)
        js = jbsdf.sample(_ctx(jbsdf, d, "jax")._replace(lam_um=jnp.asarray(lam)),
                          jnp.asarray(d["wi"]), jnp.asarray(u), DELTA_TYPES)
        np.testing.assert_array_equal(ts.sampled_type.numpy(), np.asarray(js.sampled_type))
        _close(ts.wo, js.wo, DIR_TOL, err_msg="wo")
        for name in ("weight", "pdf", "eta"):
            _close(getattr(ts, name), getattr(js, name), TOL, err_msg=name)
        # no channel isolation: a dispersive dielectric lane keeps its channels
        diel = torch.from_numpy(d["mat"] == schema.BSDF_DIELECTRIC)
        assert ((ts.weight[diel] > 0).sum(1) == 3).all()
