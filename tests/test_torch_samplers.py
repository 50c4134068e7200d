"""The port's sequence samplers and reconstruction filters against the JAX
package's.

Bit for bit: the Sobol' direction table, the Owen scramble on edge values
(0, 1, 0xFFFFFFFF and random ones, under seeds up to 0xFFFFFFFF, where the
Laine-Karras products pass 2^63), every sampler (independent, stratified,
Sobol') for dimensions 0-70 with the sample index a Python int (the
tracers' host path) and a per-lane tensor, and the camera rays' RNG states
and pixels under every sampler and filter. The camera rays' origins and
directions agree within 1e-6 (XLA contracts FMAs on the CPU where PyTorch
rounds twice).

PathTracer with the stratified and Sobol' samplers is held to the JAX
PathTracer pass for pass on Cornell 16x16, depth 4: the film's mean
relative error under 0.5% (a rounding flip can move a rare roulette draw,
as in test_torch_path.py), the weights equal, the live rays within 0.1%.
Then tests/test_samplers_wired.py's and tests/test_framework.py's sampler
cases on the port, at their sizes (the slow Cornell RMSE case excepted)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.models import samplers as jsamp
from cudatracerlib_tpu.models import tracer as jtracer
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import samplers as tsamp
from cudatracerlib_tpu_torch.models import tracer as ttracer
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
U32 = 0xFFFFFFFF


def _t(a):
    """uint32 numpy values -> the port's int64 representation."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def test_sobol_table_matches_jax():
    j = np.asarray(jsamp._sobol_directions())
    t = tsamp._sobol_directions()
    assert t.shape == j.shape == (tsamp.SOBOL_DIMS, 32) and t.dtype == np.uint32
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1, U32, 0xDEADBEEF, 0x9E3779B9])
def test_owen_scramble_edge_values(seed):
    x = np.concatenate([[0, 1, U32, 0x80000000, 0x7FFFFFFF],
                        np.random.default_rng(seed & 0xFFFF).integers(
                            0, 1 << 32, 59, dtype=np.uint64)]).astype(np.uint32)
    s = np.full(x.shape, seed, np.uint32)
    j = np.asarray(jsamp.owen_scramble(jnp.asarray(x), jnp.asarray(s)))
    t = tsamp.owen_scramble(_t(x), _t(s))
    assert t.dtype == torch.int64 and int(t.min()) >= 0 and int(t.max()) <= U32
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
    # the split multiply against numpy's wrapping uint32 product
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        np.testing.assert_array_equal(tsamp._mul32(_t(x), c).numpy(),
                                      (x * np.uint32(c)).astype(np.int64))
    np.testing.assert_array_equal(
        tsamp._reverse_bits32(_t(x)).numpy(),
        np.asarray(jsamp._reverse_bits32(jnp.asarray(x))).astype(np.int64))


@pytest.mark.parametrize("sampler", [jsamp.INDEPENDENT, jsamp.STRATIFIED, jsamp.SOBOL])
def test_samplers_match_jax_dims_0_to_70(sampler):
    pix = (np.arange(257, dtype=np.int32) * 7919) % 65536
    sidx_lanes = np.random.default_rng(3).integers(0, 1 << 20, 257).astype(np.int32)
    jp, tp = jnp.asarray(pix), torch.from_numpy(pix)
    for dim in range(71):
        for sidx in (0, 7, 123457):
            j = np.asarray(jsamp.sample_1d_dyn(sampler, jp, sidx, jnp.uint32(dim)))
            np.testing.assert_array_equal(
                tsamp.sample_1d_dyn(sampler, tp, sidx, dim).numpy(), j,
                err_msg=f"sampler {sampler} dim {dim} sample {sidx}")
            np.testing.assert_array_equal(
                tsamp.sample_1d(sampler, tp, sidx, dim).numpy(),
                np.asarray(jsamp.sample_1d(sampler, jp, sidx, dim)))
        j = np.asarray(jsamp.sample_1d(sampler, jp, jnp.asarray(sidx_lanes), dim))
        np.testing.assert_array_equal(
            tsamp.sample_1d(sampler, tp, torch.from_numpy(sidx_lanes), dim).numpy(), j,
            err_msg=f"sampler {sampler} dim {dim}, per-lane sample index")
    np.testing.assert_array_equal(
        tsamp.sample_2d(sampler, tp, 5, 2).numpy(),
        np.asarray(jsamp.sample_2d(sampler, jp, 5, 2)))


@pytest.mark.parametrize("sampler,filt", [(0, 1), (0, 2), (1, 0), (2, 0), (2, 1), (1, 2)])
def test_camera_rays_match_jax(sampler, filt):
    jsc = jscenes.cornell_box(16, 16).build()
    tsc = tscenes.cornell_box(16, 16).build("cpu")
    pix = np.arange(256, dtype=np.int32)
    j = jtracer.gen_camera_rays(jsc, jnp.asarray(pix), 3, 2, 16, 16,
                                filter_type=filt, sampler_type=sampler)
    t = ttracer.gen_camera_rays(tsc, torch.from_numpy(pix), 3, 2, 16, 16,
                                filter_type=filt, sampler_type=sampler)
    for k in (1, 2):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]).astype(np.int64))
    for name in ("o", "d"):
        np.testing.assert_allclose(getattr(t[0], name).numpy(),
                                   np.asarray(getattr(j[0], name)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t[4].numpy(), np.asarray(j[4]), rtol=1e-6)


def test_filter_jitter_matches_jax():
    u = np.random.default_rng(5).random((4096, 2)).astype(np.float32)
    for ft in (0, 1, 2):
        j = np.asarray(jtracer._filter_jitter(ft, jnp.asarray(u)))
        t = ttracer._filter_jitter(ft, torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
        assert np.abs(t).max() <= (0.5, 1.0, 2.0)[ft]


@pytest.mark.parametrize("sampler", [jsamp.STRATIFIED, jsamp.SOBOL])
def test_pt_sequence_samplers_pass_for_pass(sampler):
    jtr = jpath.PathTracer(jscenes.cornell_box(16, 16).build(), 16, 16,
                           max_depth=4, sampler_type=sampler)
    ttr = tpath.PathTracer(tscenes.cornell_box(16, 16).build("cpu"), 16, 16,
                           max_depth=4, sampler_type=sampler)
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j, t = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        assert np.abs(t - j).mean() / j.mean() < 0.005
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        assert abs(ttr.rays_traced_live - jtr.rays_traced_live) <= 1e-3 * jtr.rays_traced_live


# --- tests/test_samplers_wired.py's cases on the port ---

def test_sampler_streams_differ():
    scene = tscenes.cornell_box(16, 16).build("cpu")
    imgs = [tpath.PathTracer(scene, 16, 16, max_depth=3, sampler_type=st)
            .render(6).numpy() for st in (0, 1, 2)]
    assert not np.allclose(imgs[0], imgs[1])
    assert not np.allclose(imgs[0], imgs[2])
    ms = [i.mean() for i in imgs]
    assert max(ms) / min(ms) < 1.3, ms


def test_sobol_64_dims_stratified_and_decorrelated():
    idx = torch.arange(64)
    for d in (9, 16, 40, 63):
        u = tsamp.sobol_sample(idx, d, torch.full((64,), 0xC0FFEE)).numpy()
        assert (np.bincount((u * 64).astype(int), minlength=64) == 1).all(), d
    pix = torch.full((4096,), 11, dtype=torch.int32)
    sidx = torch.arange(4096)

    def dyn(d):
        return tsamp.sample_1d_dyn(tsamp.SOBOL, pix, sidx, d).numpy()
    for a_d, b_d in ((16, 22), (8, 72), (15, 23)):
        assert abs(np.corrcoef(dyn(a_d), dyn(b_d))[0, 1]) < 0.06, (a_d, b_d)
    hist = np.histogram2d(dyn(16), dyn(19), bins=16, range=((0, 1), (0, 1)))[0]
    chi2 = float((((hist - 16.0) ** 2) / 16.0).sum())
    assert chi2 < 255 + 6 * 22.6, chi2


def test_sobol_deep_dims_cut_integration_rmse_at_16spp():
    si = torch.arange(16)

    def estimates(stype):
        out = []
        for p in range(256):
            pv = torch.full((16,), p, dtype=torch.int32)
            us = [tsamp.sample_1d_dyn(stype, pv, si, 10 + j).numpy() for j in range(4)]
            out.append(np.prod(us, axis=0).mean())
        return np.array(out)
    rmse = {st: float(np.sqrt(((estimates(st) - 1 / 16) ** 2).mean()))
            for st in (tsamp.INDEPENDENT, tsamp.SOBOL)}
    assert rmse[tsamp.SOBOL] < rmse[tsamp.INDEPENDENT], rmse


# --- tests/test_framework.py's TestSamplers on the port ---

def test_uniform_range():
    pix = torch.arange(4096, dtype=torch.int32)
    for st in (tsamp.INDEPENDENT, tsamp.STRATIFIED, tsamp.SOBOL):
        u = tsamp.sample_1d(st, pix, 3, dim=0).numpy()
        assert u.min() >= 0 and u.max() < 1
        assert abs(u.mean() - 0.5) < 0.02, (st, u.mean())


def test_stratified_better_than_independent():
    pix = torch.zeros(1, dtype=torch.int32)
    u_s = np.array([float(tsamp.sample_1d(tsamp.STRATIFIED, pix, i, 0)[0]) for i in range(256)])
    u_i = np.array([float(tsamp.sample_1d(tsamp.INDEPENDENT, pix, i, 0)[0]) for i in range(256)])
    cnt_s = np.histogram(u_s, bins=16, range=(0, 1))[0]
    cnt_i = np.histogram(u_i, bins=16, range=(0, 1))[0]
    assert cnt_s.var() <= cnt_i.var()


def test_sobol_first_dims_lowdisc():
    pix = torch.zeros(1, dtype=torch.int32)
    pts = np.array([[float(tsamp.sample_1d(tsamp.SOBOL, pix, i, 0)[0]),
                     float(tsamp.sample_1d(tsamp.SOBOL, pix, i, 1)[0])] for i in range(64)])
    cnt = np.histogram2d(pts[:, 0], pts[:, 1], bins=8, range=((0, 1), (0, 1)))[0]
    assert (cnt > 0).mean() > 0.9
