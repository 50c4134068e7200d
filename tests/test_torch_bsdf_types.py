"""The port's other 11 BSDF types (rough diffuse, rough dielectric, plastic,
rough plastic, Phong, Ward, Hanrahan-Krueger, null, and the nested coating,
rough coating and blend), the rough transmittance tables and path
regularization against the JAX package's, on the same seeded inputs.

For each type, evaluate, pdf and sample run on 4,096 seeded lanes of that
type (a coating's or a blend's nested BSDFs drawn from the simple types),
and once more on lanes of all 16 types mixed, with every type active. The
tolerances are tests/test_torch_bsdf.py's, for the reasons its module note
gives: TOL for floats, PEAK_TOL where a microfacet D or G peaks, DIR_TOL
for sampled directions. Where a value is outside PEAK_TOL of JAX's (a
narrow lobe's peak, where one ulp of the half vector's normalisation or
of the sampled direction moves D past it), the port's and JAX's values
must each lie within the lane's own bound of the port's closed forms in
float64: PEAK_TOL plus four times the value's measured sensitivity to
one ulp (_eval64, _held). A smooth sample there must also equal the
port's own evaluation at the sampled direction bit for bit. Sampled types, the RNG state after sampling and is_delta_only
match bit for bit.

The JAX package's rough transmittance tables are filled in its in-process
cache from its own _compute_table (through monkeypatch), so its disk cache
is neither read nor written. The port's tables are bit-identical to JAX's,
its trilinear lookup within 1e-6, and regularize_ctx exact.

tests/test_bsdf.py's checks (sample against evaluate, the pdf's
normalisation, energy conservation) run on the port for the new types,
with that file's specs and bounds."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import rough_transmittance as jrt
from cudatracerlib_tpu.models import bsdf as jbsdf
from cudatracerlib_tpu_torch.core import records
from cudatracerlib_tpu_torch.core import rough_transmittance as trt
from cudatracerlib_tpu_torch.core import vecmath as tvm
from cudatracerlib_tpu_torch.core import warp as twarp
from cudatracerlib_tpu_torch.models import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene import host as thost
from cudatracerlib_tpu_torch.scene import schema

torch.set_num_threads(2)
N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
PEAK_TOL = dict(rtol=1e-4, atol=1e-6)
DIR_TOL = dict(rtol=1e-4, atol=1e-5)
NEW_TYPES = (schema.BSDF_ROUGHDIFFUSE, schema.BSDF_ROUGHDIELECTRIC,
             schema.BSDF_PLASTIC, schema.BSDF_ROUGHPLASTIC, schema.BSDF_PHONG,
             schema.BSDF_WARD, schema.BSDF_HK, schema.BSDF_NULL,
             schema.BSDF_COATING, schema.BSDF_ROUGHCOATING, schema.BSDF_BLEND)
NESTED = (schema.BSDF_COATING, schema.BSDF_ROUGHCOATING, schema.BSDF_BLEND)
SIMPLE = tuple(t for t in range(16) if t not in NESTED)
NAMES = {schema.BSDF_ROUGHDIFFUSE: "roughdiffuse", schema.BSDF_ROUGHDIELECTRIC:
         "roughdielectric", schema.BSDF_PLASTIC: "plastic", schema.BSDF_ROUGHPLASTIC:
         "roughplastic", schema.BSDF_PHONG: "phong", schema.BSDF_WARD: "ward",
         schema.BSDF_HK: "hk", schema.BSDF_NULL: "null", schema.BSDF_COATING: "coating",
         schema.BSDF_ROUGHCOATING: "roughcoating", schema.BSDF_BLEND: "blend"}


@pytest.fixture(scope="module", autouse=True)
def jax_tables():
    """JAX's rough transmittance tables in its in-process cache, computed by
    its own _compute_table: get_table then never touches its disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        cache = {(d, round(float(e), 3)): jrt._compute_table(d, e)
                 for d in (0, 1) for e in jrt._ETA_KNOTS}
        mp.setattr(jrt, "_CACHE", cache)
        yield


def _close(t, j, tol=TOL, err_msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=err_msg, **tol)


def _unit(r, n, up_share):
    v = r.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    flip = r.random(n) < up_share
    v[:, 2] = np.where(flip, np.abs(v[:, 2]), -np.abs(v[:, 2]))
    return v


def _params(r):
    """One random material row per lane, every field in its type's range."""
    p = np.zeros((N, schema.N_MAT_PARAMS), np.float32)
    p[:, 0:3] = r.random((N, 3))
    p[:, 3] = r.uniform(0.0, 1.0, N)                     # roughdiffuse alpha
    p[:, 4] = r.uniform(1.05, 2.4, N)                    # eta
    p[:, 5] = r.integers(0, 3, N)                        # Beckmann, GGX, Phong
    p[:, 6] = np.exp(r.uniform(np.log(0.005), np.log(0.8), N))
    p[:, 7] = np.where(r.random(N) < 0.5, p[:, 6],
                       np.exp(r.uniform(np.log(0.005), np.log(0.8), N)))
    p[:, 8:11] = r.uniform(0.1, 1.5, (N, 3))
    p[:, 11:14] = r.uniform(1.0, 4.0, (N, 3))
    p[:, 14] = r.random(N) < 0.5                         # plastic nonlinear
    p[:, 15] = np.exp(r.uniform(0.0, np.log(300.0), N))  # Phong exponent
    p[:, 16] = r.uniform(-0.9, 0.9, N)                   # HK phase g
    p[:, 17] = r.uniform(0.05, 3.0, N)                   # thickness
    p[:, 18] = r.random(N)                               # blend weight
    p[:, 19:22] = r.random((N, 3))
    p[:, 22] = r.random(N) < 0.8                         # two-sided
    return p


def _make_data(seed, types):
    r = np.random.default_rng(seed)
    d = dict(wi=_unit(r, N, 0.9), wo=_unit(r, N, 0.9),
             u=r.random((N, 3), dtype=np.float32),
             mat=np.asarray(types, np.int32)[r.integers(0, len(types), N)],
             params=_params(r), c0=r.random((N, 3)).astype(np.float32),
             c1=r.random((N, 3)).astype(np.float32),
             n_type=np.asarray(SIMPLE, np.int32)[r.integers(0, len(SIMPLE), N)],
             n_params=_params(r), n_c0=r.random((N, 3)).astype(np.float32),
             n_c1=r.random((N, 3)).astype(np.float32),
             n2_type=np.asarray(SIMPLE, np.int32)[r.integers(0, len(SIMPLE), N)],
             n2_params=_params(r), n2_c0=r.random((N, 3)).astype(np.float32),
             n2_c1=r.random((N, 3)).astype(np.float32),
             state=r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32))
    return d


def _ctx(mod, d, lib):
    a = (lambda x: torch.from_numpy(np.ascontiguousarray(x))) if lib == "torch" else jnp.asarray
    return mod.BsdfCtx(mat_type=a(d["mat"]), params=a(d["params"]), c0=a(d["c0"]),
                       c1=a(d["c1"]), n_type=a(d["n_type"]), n_params=a(d["n_params"]),
                       n_c0=a(d["n_c0"]), n_c1=a(d["n_c1"]), n2_type=a(d["n2_type"]),
                       n2_params=a(d["n2_params"]), n2_c0=a(d["n2_c0"]),
                       n2_c1=a(d["n2_c1"]))


@pytest.fixture(scope="module")
def by_type():
    return {t: _make_data(100 + t, (t,)) for t in NEW_TYPES}


@pytest.fixture(scope="module")
def mixed():
    return _make_data(7, tuple(range(16)))


def _evaluate(d, types):
    tl = tbsdf.evaluate(_ctx(tbsdf, d, "torch"), torch.from_numpy(d["wi"]),
                        torch.from_numpy(d["wo"]), types)
    jl = jbsdf.evaluate(_ctx(jbsdf, d, "jax"), jnp.asarray(d["wi"]),
                        jnp.asarray(d["wo"]), types)
    return tl, jl


_FLOAT_FIELDS = ("params", "c0", "c1", "n_params", "n_c0", "n_c1", "n2_params",
                 "n2_c0", "n2_c1")
_ULP = 2.0 ** -23


def _eval64(d, wo, types):
    """The port's closed forms in float64 at (wi, wo): columns f (3), pdf,
    weight f / pdf (3). And each value's sensitivity: the largest change of
    it (four random sign patterns) when wi, wo and every vector the closed
    forms normalise (the half vectors) move by one float32 ulp per
    component. At a narrow lobe's peak cos(theta_h) sits next to 1, where
    one ulp of it is a large step of D; this measures that conditioning
    for any type, nesting and distribution."""
    c = _ctx(tbsdf, d, "torch")
    c = c._replace(**{k: getattr(c, k).double() for k in _FLOAT_FIELDS})
    wi = torch.from_numpy(d["wi"]).double()
    wo = torch.as_tensor(np.array(wo)).double()

    def ev(a, b):
        lob = tbsdf.evaluate(c, a, b, types)
        return torch.cat([lob.f, lob.pdf[:, None],
                          lob.f / lob.pdf.clamp_min(1e-12)[:, None]], 1)
    ref = ev(wi, wo)
    g = torch.Generator().manual_seed(0)

    def nudge(x):
        return x * (1 + _ULP * (2 * torch.randint(0, 2, x.shape, generator=g) - 1))
    normalize = tvm.normalize
    sens = torch.zeros_like(ref)
    with mock.patch.object(tvm, "normalize", lambda a: nudge(normalize(a))):
        for _ in range(4):
            sens = torch.maximum(sens, (ev(nudge(wi), nudge(wo)) - ref).abs())
    return ref.numpy(), sens.numpy()


def _held(name, got, want, ref, sens, want_ref=None, want_sens=None, tol=PEAK_TOL):
    """The port's values `got` against JAX's `want` at tol. Where a value is
    outside it, the port's and JAX's must each lie within the lane's bound
    of the float64 value at their own direction: tol plus four times the
    value's sensitivity (_eval64's columns; about the ulps a normalised
    half vector carries). want_ref, want_sens: the float64 values at JAX's
    sampled direction (a sample); the port's otherwise. Returns the number
    of such values."""
    g, j = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    off = ~np.isclose(g, j, **tol)
    if not off.any():
        return 0
    want_ref = ref if want_ref is None else want_ref
    want_sens = sens if want_sens is None else want_sens
    for v, r, sn, what in ((g, ref, sens, "port"), (j, want_ref, want_sens, "JAX")):
        bound = tol["atol"] + tol["rtol"] * np.abs(r) + 4 * sn
        err = np.abs(v - r)
        assert (err <= bound)[off].all(), (
            f"{name}: {int((err > bound)[off].sum())} {what} values are up to "
            f"{np.max((err - bound)[off])} past their float64 bound")
    return int(off.sum())


def _check_sample(d, types):
    tctx, jctx = _ctx(tbsdf, d, "torch"), _ctx(jbsdf, d, "jax")
    ts, tstate = tbsdf.sample_with_rng(tctx, torch.from_numpy(d["wi"]),
                                       torch.from_numpy(d["state"].astype(np.int64)),
                                       types)
    js, jstate = jbsdf.sample_with_rng(jctx, jnp.asarray(d["wi"]),
                                       jnp.asarray(d["state"]), types)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate).astype(np.int64))
    np.testing.assert_array_equal(ts.sampled_type.numpy(), np.asarray(js.sampled_type))
    _close(ts.wo, js.wo, DIR_TOL, err_msg="wo")
    _close(ts.eta, js.eta, TOL, err_msg="eta")
    # the weight and pdf against JAX's at PEAK_TOL. A smooth sample may sit
    # where its lobe is ill-conditioned: at a narrow peak one ulp of the
    # half vector's normalisation (rsqrt rounds differently on each side),
    # or the one-ulp difference of the two sampled directions (a Phong
    # distribution's cos^(1 / (e + 2)) at e ~ 10^4), moves D past PEAK_TOL.
    # There the sample must equal the port's own evaluation at its
    # direction (f / pdf, pdf) bit for bit, and _held must explain it
    tw, tp = ts.weight.numpy(), ts.pdf.numpy()
    off = ~(np.isclose(tw, np.asarray(js.weight), **PEAK_TOL).all(1)
            & np.isclose(tp, np.asarray(js.pdf), **PEAK_TOL))
    if off.any():
        smooth = (ts.sampled_type.numpy() & records.T_DELTA) == 0
        assert smooth[off].all(), "a delta sample's weight or pdf differs"
        tl = tbsdf.evaluate(tctx, torch.from_numpy(d["wi"]), ts.wo, types)
        np.testing.assert_array_equal(
            tw[off], (tl.f / tl.pdf.clamp_min(1e-12)[:, None]).numpy()[off])
        np.testing.assert_array_equal(np.maximum(tp[off], 1e-12),
                                      tl.pdf.clamp_min(1e-12).numpy()[off])
        ref, sens = _eval64(d, ts.wo, types)
        jref, jsens = _eval64(d, np.asarray(js.wo), types)
        _held("weight", ts.weight, js.weight, ref[:, 4:], sens[:, 4:],
              jref[:, 4:], jsens[:, 4:])
        _held("pdf", ts.pdf, js.pdf, ref[:, 3], sens[:, 3], jref[:, 3], jsens[:, 3])
    return ts


@pytest.mark.parametrize("t", NEW_TYPES, ids=[NAMES[t] for t in NEW_TYPES])
def test_evaluate(by_type, t):
    d = by_type[t]
    tl, jl = _evaluate(d, (t,))
    ref, sens = _eval64(d, d["wo"], (t,))
    _held("f", tl.f, jl.f, ref[:, :3], sens[:, :3])
    _held("pdf", tl.pdf, jl.pdf, ref[:, 3], sens[:, 3])
    assert tl.f.isfinite().all() and tl.pdf.isfinite().all()
    if t != schema.BSDF_NULL:       # null is a pure delta: a zero lobe
        assert float(tl.pdf.max()) > 0.0


@pytest.mark.parametrize("t", NEW_TYPES, ids=[NAMES[t] for t in NEW_TYPES])
def test_pdf(by_type, t):
    d = by_type[t]
    args = (torch.from_numpy(d["wi"]), torch.from_numpy(d["wo"]), (t,))
    tp = tbsdf.pdf(_ctx(tbsdf, d, "torch"), *args)
    jp = jbsdf.pdf(_ctx(jbsdf, d, "jax"), jnp.asarray(d["wi"]), jnp.asarray(d["wo"]), (t,))
    ref, sens = _eval64(d, d["wo"], (t,))
    _held("pdf", tp, jp, ref[:, 3], sens[:, 3])
    np.testing.assert_array_equal(tp.numpy(), tbsdf.evaluate(_ctx(tbsdf, d, "torch"),
                                                             *args).pdf.numpy())


@pytest.mark.parametrize("t", NEW_TYPES, ids=[NAMES[t] for t in NEW_TYPES])
def test_sample(by_type, t):
    ts = _check_sample(by_type[t], (t,))
    assert ts.weight.isfinite().all() and ts.pdf.isfinite().all()


def test_all_types_mixed(mixed):
    """Lanes of all 16 types with every type active: evaluate, pdf, sample
    and is_delta_only against JAX."""
    tl, jl = _evaluate(mixed, tbsdf.ALL_TYPES)
    ref, sens = _eval64(mixed, mixed["wo"], tbsdf.ALL_TYPES)
    _held("f", tl.f, jl.f, ref[:, :3], sens[:, :3])
    _held("pdf", tl.pdf, jl.pdf, ref[:, 3], sens[:, 3])
    ts = _check_sample(mixed, tbsdf.ALL_TYPES)
    assert set(np.unique(mixed["mat"]).tolist()) == set(range(16))
    np.testing.assert_array_equal(tbsdf.is_delta_only(_ctx(tbsdf, mixed, "torch")).numpy(),
                                  np.asarray(jbsdf.is_delta_only(_ctx(jbsdf, mixed, "jax"))))
    # a lane whose type is not active samples nothing
    part = tbsdf.sample(_ctx(tbsdf, mixed, "torch"), torch.from_numpy(mixed["wi"]),
                        torch.from_numpy(mixed["u"]), (schema.BSDF_DIFFUSE,))
    off = torch.from_numpy(mixed["mat"] != schema.BSDF_DIFFUSE)
    assert float(part.weight[off].abs().max()) == 0.0
    assert ts.sampled_type[off].any()


@pytest.mark.parametrize("dist", [0, 1, 2])
def test_compute_table_bit_identical(dist):
    for eta in (1.1, 1.5):
        t, j = trt._compute_table(dist, eta), jrt._compute_table(dist, eta)
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


def test_get_table_caches_in_process(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trt, "_CACHE", {})
    a = trt.get_table(1, 1.3)
    assert trt.get_table(1, 1.3004) is a          # the key rounds eta to 3 places
    assert list(tmp_path.iterdir()) == []


def test_eval_specular_albedo_eta():
    r = np.random.default_rng(3)
    eta = r.uniform(0.9, 2.4, N).astype(np.float32)
    eta[:5] = np.asarray(trt._ETA_KNOTS, np.float32)      # on the knots
    cos = r.uniform(-1.0, 1.0, N).astype(np.float32)
    alpha = r.uniform(0.0, 1.2, N).astype(np.float32)
    for dist in (0, 1):
        t = trt.eval_specular_albedo_eta(dist, torch.from_numpy(eta), torch.from_numpy(cos),
                                         torch.from_numpy(alpha))
        j = jrt.eval_specular_albedo_eta(dist, jnp.asarray(eta), jnp.asarray(cos),
                                         jnp.asarray(alpha))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
        t1 = trt.eval_specular_albedo(dist, 1.5, torch.from_numpy(cos),
                                      torch.from_numpy(alpha))
        j1 = jrt.eval_specular_albedo(dist, 1.5, jnp.asarray(cos), jnp.asarray(alpha))
        np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=0, atol=1e-6)


def test_regularize_ctx(mixed):
    r = np.random.default_rng(8)
    do_reg = r.random(N) < 0.5
    for alpha_min in (0.08, 0.3):
        t = tbsdf.regularize_ctx(_ctx(tbsdf, mixed, "torch"), torch.from_numpy(do_reg),
                                 alpha_min)
        j = jbsdf.regularize_ctx(_ctx(jbsdf, mixed, "jax"), jnp.asarray(do_reg), alpha_min)
        np.testing.assert_array_equal(t.mat_type.numpy(), np.asarray(j.mat_type))
        np.testing.assert_array_equal(t.params.numpy(), np.asarray(j.params))
        assert t.mat_type.dtype == torch.int32
    assert tbsdf.REGULARIZE_EXTRA_TYPES == jbsdf.REGULARIZE_EXTRA_TYPES
    # the caller's params are left as they were
    np.testing.assert_array_equal(_ctx(tbsdf, mixed, "torch").params.numpy(),
                                  mixed["params"])


def test_nested_ctx(mixed):
    t, j = _ctx(tbsdf, mixed, "torch"), _ctx(jbsdf, mixed, "jax")
    for name in ("nested_ctx", "nested2_ctx"):
        tn, jn = getattr(t, name)(), getattr(j, name)()
        for field in ("mat_type", "params", "c0", "c1", "n_type", "n2_type"):
            np.testing.assert_array_equal(getattr(tn, field).numpy(),
                                          np.asarray(getattr(jn, field)), err_msg=field)


# ---------------------------------------------------------------------------
# tests/test_bsdf.py's checks on the port, for the new types
# ---------------------------------------------------------------------------

SMOOTH_SPECS = {
    "roughdiffuse": thost.MaterialSpec(bsdf_type=schema.BSDF_ROUGHDIFFUSE,
                                       reflectance=(0.6, 0.6, 0.6), alpha=0.3),
    "roughdielectric": thost.MaterialSpec(bsdf_type=schema.BSDF_ROUGHDIELECTRIC,
                                          alpha=0.3, eta=1.5, reflectance=(1, 1, 1),
                                          transmittance=(1, 1, 1), distribution=1),
    "plastic": thost.MaterialSpec(bsdf_type=schema.BSDF_PLASTIC, reflectance=(1, 1, 1),
                                  transmittance=(0.5, 0.2, 0.1), eta=1.49),
    "roughplastic": thost.MaterialSpec(bsdf_type=schema.BSDF_ROUGHPLASTIC, alpha=0.3,
                                       reflectance=(1, 1, 1), transmittance=(0.5, 0.2, 0.1),
                                       eta=1.49, distribution=1),
    "phong": thost.MaterialSpec(bsdf_type=schema.BSDF_PHONG, reflectance=(0.4, 0.4, 0.4),
                                transmittance=(0.3, 0.3, 0.3), exponent=40.0),
    "ward": thost.MaterialSpec(bsdf_type=schema.BSDF_WARD, reflectance=(0.4, 0.4, 0.4),
                               transmittance=(0.3, 0.3, 0.3), alpha=0.25, alpha_v=0.15),
    "coating": thost.MaterialSpec(
        bsdf_type=schema.BSDF_COATING, eta=1.49,
        transmittance=(0.1, 0.1, 0.1), thickness=1.0, reflectance=(1, 1, 1),
        nested=thost.MaterialSpec(bsdf_type=schema.BSDF_DIFFUSE,
                                  reflectance=(0.6, 0.4, 0.3))),
    "roughcoating": thost.MaterialSpec(
        bsdf_type=schema.BSDF_ROUGHCOATING, eta=1.49, alpha=0.25,
        distribution=1, transmittance=(0.1, 0.1, 0.1), thickness=1.0,
        reflectance=(1, 1, 1),
        nested=thost.MaterialSpec(bsdf_type=schema.BSDF_DIFFUSE,
                                  reflectance=(0.6, 0.4, 0.3))),
    "blend": thost.MaterialSpec(
        bsdf_type=schema.BSDF_BLEND, blend_weight=0.4,
        nested=thost.MaterialSpec(bsdf_type=schema.BSDF_DIFFUSE, reflectance=(0.8, 0.2, 0.2)),
        nested2=thost.MaterialSpec(bsdf_type=schema.BSDF_ROUGHCONDUCTOR,
                                   reflectance=(1, 1, 1), alpha=0.3)),
}
# the scene loader's hk defaults (sigmaS 2, sigmaA 0.05, thickness 1) and null
DELTA_SPECS = {
    "hk": thost.MaterialSpec(bsdf_type=schema.BSDF_HK, reflectance=(2.0, 2.0, 2.0),
                             transmittance=(0.05, 0.05, 0.05), thickness=1.0,
                             phase_g=0.0, two_sided=False),
    "null": thost.MaterialSpec(bsdf_type=schema.BSDF_NULL, two_sided=False),
}


def _make_ctx(spec, B):
    """tests/test_bsdf.py's _make_ctx on the port's material packing."""
    mats, texs = [], []
    thost._pack_material(spec, mats, texs)
    row = mats[-1]

    def lanes(r):
        p = torch.from_numpy(r["params"]).expand(B, -1).contiguous()
        return (torch.full((B,), r["mat_type"], dtype=torch.int32), p,
                p[:, 0:3].contiguous(), p[:, 19:22].contiguous())
    t, p, c0, c1 = lanes(row)
    zero = (torch.zeros(B, dtype=torch.int32), p * 0, c0 * 0, c1 * 0)
    n = lanes(mats[row["nested"]]) if row["nested"] >= 0 else zero
    n2 = lanes(mats[row["nested2"]]) if row["nested2"] >= 0 else zero
    return tbsdf.BsdfCtx(t, p, c0, c1, *n, *n2)


def _wi(B, z=0.6):
    return torch.tensor([[np.sqrt(1 - z * z), 0.0, z]], dtype=torch.float32).expand(B, 3)


@pytest.mark.parametrize("name", list(SMOOTH_SPECS) + ["hk"])
def test_sample_pdf_eval_consistency(name):
    """weight == f/pdf and pdf(sample.wo) == sample.pdf for smooth samples."""
    B = 8192
    spec = (SMOOTH_SPECS | DELTA_SPECS)[name]
    ctx = _make_ctx(spec, B)
    wi = _wi(B)
    u = torch.from_numpy(np.random.default_rng(1).random((B, 3)).astype(np.float32))
    at = (spec.bsdf_type,)
    s = tbsdf.sample(ctx, wi, u, active_types=at)
    lob = tbsdf.evaluate(ctx, wi, s.wo, active_types=at)
    smooth = (((s.sampled_type & 0b110000) == 0) & (s.pdf > 1e-5)).numpy()
    w_direct = s.weight.numpy()[smooth]
    w_ratio = (lob.f / lob.pdf.clamp_min(1e-12)[:, None]).numpy()[smooth]
    frac_bad = (np.abs(w_direct - w_ratio) > 0.02 * (1 + np.abs(w_ratio))).mean()
    assert frac_bad < 0.02, f"{name}: weight!=f/pdf for {frac_bad:.1%}"
    p_direct, p_eval = s.pdf.numpy()[smooth], lob.pdf.numpy()[smooth]
    frac_bad = (np.abs(p_direct - p_eval) > 0.02 * (1 + p_eval)).mean()
    assert frac_bad < 0.02, f"{name}: pdf mismatch for {frac_bad:.1%}"


@pytest.mark.parametrize("name", list(SMOOTH_SPECS) + ["hk"])
def test_pdf_normalization(name):
    """int pdf(wo) dwo == 1 - P(delta) over the sphere (MC, uniform)."""
    B = 200_000
    spec = (SMOOTH_SPECS | DELTA_SPECS)[name]
    ctx = _make_ctx(spec, B)
    wi = _wi(B)
    at = (spec.bsdf_type,)
    u = torch.from_numpy(np.random.default_rng(2).random((B, 2)).astype(np.float32))
    wo = twarp.square_to_uniform_sphere(u)
    integral = float(tbsdf.pdf(ctx, wi, wo, active_types=at).mean()) * 4.0 * np.pi
    # mass pdf() does not see: delta components, and samples the sampler
    # rejects (a micronormal that maps below the horizon: zero weight)
    us = torch.from_numpy(np.random.default_rng(3).random((B, 3)).astype(np.float32))
    s = tbsdf.sample(ctx, wi, us, active_types=at)
    hidden = float((((s.sampled_type & 0b110000) != 0)
                    | (s.weight == 0.0).all(-1)).float().mean())
    np.testing.assert_allclose(integral + hidden, 1.0, atol=0.06, err_msg=name)


@pytest.mark.parametrize("name", list(SMOOTH_SPECS) + list(DELTA_SPECS))
def test_energy_conservation(name):
    """E[weight] <= 1 per channel (no energy creation), over random wi."""
    B = 100_000
    spec = (SMOOTH_SPECS | DELTA_SPECS)[name]
    ctx = _make_ctx(spec, B)
    r = np.random.default_rng(4)
    z = r.random(B) * 0.98 + 0.01
    phi = r.random(B) * 2 * np.pi
    s_ = np.sqrt(1 - z * z)
    wi = torch.from_numpy(np.stack([s_ * np.cos(phi), s_ * np.sin(phi), z], -1)
                          .astype(np.float32))
    u = torch.from_numpy(r.random((B, 3)).astype(np.float32))
    mean_w = tbsdf.sample(ctx, wi, u, active_types=(spec.bsdf_type,)).weight.mean(0).numpy()
    assert (mean_w < 1.02).all(), f"{name}: creates energy {mean_w}"
    assert (mean_w > 0.01).all(), f"{name}: black {mean_w}"
