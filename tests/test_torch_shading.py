"""Shading, BSDF and emitter functions of the port against the JAX package.

Both sides get the same hits (the port's traversal of rays from inside the
Cornell box) and the same RNG states. Floats agree within rtol 1e-5 /
atol 1e-6 (XLA on the CPU contracts a*b+c into FMAs; PyTorch rounds twice);
RNG states out, integer ids and flags must be bit-exact. The scene with
extra point, spot and distant lights exercises every branch of the
emitter sampling and the power-CDF light selection."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import bsdf as jbsdf, lights as jlights
from cudatracerlib_tpu.ops import shading as jshading, traversal as jtrav
from cudatracerlib_tpu.core import rng as jrng
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.core import rng as trng
from cudatracerlib_tpu_torch.models import bsdf as tbsdf, lights as tlights
from cudatracerlib_tpu_torch.ops import shading as tshading, traversal8
from cudatracerlib_tpu_torch.ops.traversal import Hit, Rays
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
N = 4096 + 513


def _close(t, j, **kw):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    if t.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **{**TOL, **kw})


def _add_lights(sc):
    sc.add_point_light((0.3, 0.8, -0.2), (2.0, 2.0, 2.0))
    sc.add_spot_light((-0.5, 0.9, 0.0), (0.2, -1.0, 0.1), (5.0, 4.0, 3.0),
                      cutoff_deg=30.0)
    sc.add_distant_light((0.3, -1.0, 0.4), (0.5, 0.5, 0.6))
    return sc


@pytest.fixture(scope="module", params=["cornell", "cornell_4_lights"])
def setup(request):
    extra = request.param == "cornell_4_lights"
    jb, tb = jscenes.cornell_box(32, 32), tscenes.cornell_box(32, 32)
    if extra:
        jb, tb = _add_lights(jb), _add_lights(tb)
    jsc, tsc = jb.build(), tb.build("cpu")
    r = np.random.default_rng(3)
    o = r.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    trays = Rays(torch.from_numpy(o), torch.from_numpy(d),
                 torch.full((N,), 1e-4), torch.full((N,), 1e9))
    jrays = jtrav.Rays(jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(trays.tmin.numpy()), jnp.asarray(trays.tmax.numpy()))
    th = traversal8.intersect_scene(tsc.geom, trays)
    jh = jtrav.Hit(*(jnp.asarray(x.numpy()) for x in th[:4]))
    ids = np.arange(N, dtype=np.int64) * 7919
    return dict(jsc=jsc, tsc=tsc, trays=trays, jrays=jrays, th=th, jh=jh,
                tstate=trng.seed(torch.from_numpy(ids), 5, 1),
                jstate=jrng.seed(jnp.asarray(ids.astype(np.uint32)), 5, 1),
                wo=r.normal(size=(N, 3)).astype(np.float32))


def _dg(s, flip):
    return (tshading.fill_dg(s["tsc"].geom, s["trays"], s["th"], flip_to_ray=flip),
            jshading.fill_dg(s["jsc"].geom, s["jrays"], s["jh"], flip_to_ray=flip))


@pytest.mark.parametrize("flip", [False, True])
def test_fill_dg(setup, flip):
    ti, ji = _dg(setup, flip)
    assert bool(ti.valid.float().mean() > 0.8)
    for f in ti._fields:
        _close(getattr(ti, f), getattr(ji, f))


def _ctx(s):
    ti, ji = _dg(s, False)
    tctx = tbsdf.gather_ctx(s["tsc"], ti.mat_id, ti.uv, active_types=(0,),
                            with_textures=0)
    jctx = jbsdf.gather_ctx(s["jsc"], ji.mat_id, ji.uv, active_types=(0,),
                            with_textures=0)
    return ti, ji, tctx, jctx


def test_gather_ctx(setup):
    _, _, tctx, jctx = _ctx(setup)
    for f in ["mat_type", "params", "c0", "c1", "n_type", "n2_type"]:
        _close(getattr(tctx, f), getattr(jctx, f))


def test_evaluate_and_sample_with_rng(setup):
    s = setup
    ti, ji, tctx, jctx = _ctx(s)
    wi_t = ti.frame().to_local(ti.wi)
    wi_j = ji.frame().to_local(ji.wi)
    wo = s["wo"] / np.linalg.norm(s["wo"], axis=1, keepdims=True)
    tl = tbsdf.evaluate(tctx, wi_t, torch.from_numpy(wo), (0,))
    jl = jbsdf.evaluate(jctx, wi_j, jnp.asarray(wo), (0,))
    _close(tl.f, jl.f)
    _close(tl.pdf, jl.pdf)
    ts, tst = tbsdf.sample_with_rng(tctx, wi_t, s["tstate"], (0,))
    js, jst = jbsdf.sample_with_rng(jctx, wi_j, s["jstate"], (0,))
    np.testing.assert_array_equal(tst.numpy().astype(np.uint32), np.asarray(jst))
    for f in ts._fields:
        _close(getattr(ts, f), getattr(js, f))


def test_sample_emitter_direct(setup):
    s = setup
    ti, ji = _dg(s, False)
    te, tst = tlights.sample_emitter_direct(s["tsc"], ti.p, s["tstate"])
    je, jst = jlights.sample_emitter_direct(s["jsc"], ji.p, s["jstate"])
    np.testing.assert_array_equal(tst.numpy().astype(np.uint32), np.asarray(jst))
    for f in te._fields:
        # rop = Le / pdf grows as 1/dist^2 near the lights: relative only
        _close(getattr(te, f), getattr(je, f),
               **({"atol": 0.0} if f == "radiance_over_pdf" else {}))
    n_types = len(np.unique(np.asarray(s["jsc"].lights.light_type)[np.asarray(je.light_idx)]))
    assert n_types == s["tsc"].num_lights


def test_hit_emitter(setup):
    s = setup
    ti, ji = _dg(setup, False)
    o_t, o_j = s["trays"].o, s["jrays"].o
    _close(tlights.eval_hit_emitter(s["tsc"], ti.light_id, ti.ng, ti.wi),
           jlights.eval_hit_emitter(s["jsc"], ji.light_id, ji.ng, ji.wi))
    tp = tlights.pdf_hit_emitter_direct(s["tsc"], ti.light_id, o_t, ti.p, ti.ng)
    jp = jlights.pdf_hit_emitter_direct(s["jsc"], ji.light_id, o_j, ji.p, ji.ng)
    assert bool((tp > 0).any())
    _close(tp, jp)
    _close(tlights.eval_environment(s["tsc"], ti.wi),
           jlights.eval_environment(s["jsc"], ji.wi))
    _close(tlights.pdf_env_direct(s["tsc"], ti.wi),
           jlights.pdf_env_direct(s["jsc"], ji.wi))
