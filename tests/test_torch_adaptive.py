"""The port's block sampler, adaptive path tracer and image pipeline
against the JAX package's.

The variance buffer's update is a scatter: a pixel named twice in one pass
updates from one old mean, in the JAX order (counts, means, m2); it is held
to the JAX update on duplicate pixels (counts equal, the rest within rtol
1e-5), and the statistics read from it (variance, split-buffer error,
block weights in all four modes) within rtol 1e-5 on the same buffer.
Block choice under the CDF rule: the CDFs within 1e-6, and the block ids
equal wherever the uniform lies farther than 1e-6 from every CDF step (the
skipped lanes are counted and must be few). AdaptivePathTracer on Cornell 32x32 (no
spheres, depth 3, 6 blocks a pass: blocks repeat within a pass), in all
four modes, pass for pass over 6 passes: the film's mean relative error
under 1e-5, the weights equal, the live rays equal. The pipeline: the
filter kernels bit for bit, the filters, the tonemap and NLM within 1e-6.
Then tests/test_framework.py's block-sampler, adaptive and pipeline cases
on the port at their sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import adaptive as jad
from cudatracerlib_tpu.models import blocksampler as jbs
from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import pipeline as jpipe
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import adaptive as tad
from cudatracerlib_tpu_torch.models import blocksampler as tbs
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import pipeline as tpipe
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _vb_pair(w, h):
    return jbs.VarianceBuffer.new(w, h), tbs.VarianceBuffer.new(w, h, "cpu")


def _vb_close(t, j):
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    for f in ("mean", "m2", "half"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   err_msg=f, **TOL)


def _fill(seed=0, w=32, h=32, passes=5):
    """Both buffers after `passes` updates with duplicate pixels."""
    r = np.random.default_rng(seed)
    jv, tv = _vb_pair(w, h)
    for i in range(passes):
        n = 700
        px = r.integers(0, w, n).astype(np.int32)
        py = r.integers(0, h, n).astype(np.int32)
        px[:100], py[:100] = px[100:200], py[100:200]     # duplicates
        val = r.gamma(1.0, 1.0, (n, 3)).astype(np.float32)
        mask = r.random(n) < 0.9
        par = np.full(n, i, np.int32)
        jv = jbs.add_samples(jv, jnp.asarray(px), jnp.asarray(py), jnp.asarray(val),
                             jnp.asarray(par), jnp.asarray(mask))
        tv = tbs.add_samples(tv, torch.from_numpy(px), torch.from_numpy(py),
                             torch.from_numpy(val), torch.from_numpy(par),
                             torch.from_numpy(mask))
    return jv, tv


def _as_torch(jv):
    """The JAX buffer's values as the port's buffer: the statistics below
    divide by small means, so each is held to the JAX function on the same
    buffer (the two scatters' sums differ in the last bits)."""
    return tbs.VarianceBuffer(*(torch.from_numpy(np.array(x)) for x in jv))


def test_add_samples_duplicates_match_jax():
    jv, tv = _fill()
    _vb_close(tv, jv)
    assert tv.count.max() >= 3
    tj = _as_torch(jv)
    np.testing.assert_allclose(tbs.pixel_variance(tj).numpy(),
                               np.asarray(jbs.pixel_variance(jv)), **TOL)
    np.testing.assert_allclose(tbs.halfbuffer_error(tj).numpy(),
                               np.asarray(jbs.halfbuffer_error(jv)), **TOL)


@pytest.mark.parametrize("mode,rect", [(jbs.B_UNIFORM, None), (jbs.B_VARIANCE, None),
                                       (jbs.B_DIFFERENCE, None),
                                       (jbs.B_SELECT, (16, 0, 48, 32)),
                                       (jbs.B_SELECT, None)])
def test_block_weights_match_jax(mode, rect):
    jv, _ = _fill(1, 64, 64)
    j = np.asarray(jbs.block_weights(jv, 64, 64, mode, rect))
    t = tbs.block_weights(_as_torch(jv), 64, 64, mode, rect).numpy()
    assert t.shape == (4, 4)
    np.testing.assert_allclose(t, j, **TOL)


def _cdf_rule(w, n_det, n_wt, pass_idx):
    """choose_blocks both ways; the CDFs within 1e-6; block ids equal where
    u is farther than 1e-6 from every step. Returns the lanes skipped."""
    j = np.asarray(jbs.choose_blocks(jnp.asarray(w), n_det, n_wt, pass_idx,
                                     jnp.uint32(tad.CHOOSE_SEED)))
    t = tbs.choose_blocks(torch.from_numpy(w), n_det, n_wt, pass_idx,
                          tad.CHOOSE_SEED).numpy()
    np.testing.assert_array_equal(t[:n_det], j[:n_det])
    fw = np.maximum(w.reshape(-1), np.float32(1e-6))
    jc = np.asarray(jnp.cumsum(jnp.asarray(fw)))
    tc = torch.cumsum(torch.from_numpy(fw), 0).numpy()
    np.testing.assert_allclose(tc / tc[-1], jc / jc[-1], rtol=0, atol=1e-6)
    from cudatracerlib_tpu_torch.core import rng
    _, u = rng.next_float(rng.seed(torch.arange(n_wt, dtype=torch.int32), pass_idx,
                                   tad.CHOOSE_SEED))
    near = (np.abs(u.numpy()[:, None] - (tc / tc[-1])[None, :]) <= 1e-6).any(1)
    np.testing.assert_array_equal(t[n_det:][~near], j[n_det:][~near])
    assert t.dtype == np.int32 and t.min() >= 0 and t.max() < w.size
    return int(near.sum())


@pytest.mark.parametrize("pass_idx", [0, 1, 7])
def test_choose_blocks_cdf_rule(pass_idx):
    r = np.random.default_rng(pass_idx)
    skipped = 0
    for w in (r.gamma(1.0, 1.0, (8, 8)).astype(np.float32),
              np.ones((4, 4), np.float32),
              np.where(r.random((16, 16)) < 0.1, 50.0, 0.01).astype(np.float32)):
        skipped += _cdf_rule(w, 40, 600, pass_idx)
    assert skipped <= 6, skipped


def test_choose_blocks_nan_weights():
    """A NaN weight (see blocksampler.choose_blocks) sends every weighted
    slot to block 0, as XLA's search does."""
    w = np.ones((4, 4), np.float32)
    w[2, 1] = np.nan
    _cdf_rule(w, 3, 50, 2)
    assert (tbs.choose_blocks(torch.from_numpy(w), 3, 50, 2, 1)[3:] == 0).all()


def test_block_pixels_match_jax():
    ids = np.array([0, 5, 5, 17, 63], np.int32)
    np.testing.assert_array_equal(
        tbs.block_pixels(torch.from_numpy(ids), 128).numpy(),
        np.asarray(jbs.block_pixels(jnp.asarray(ids), 128)))


@pytest.mark.parametrize("mode", [jbs.B_UNIFORM, jbs.B_VARIANCE, jbs.B_DIFFERENCE,
                                  jbs.B_SELECT])
def test_adaptive_pass_for_pass(mode):
    rect = (0, 0, 16, 32) if mode == jbs.B_SELECT else None
    jtr = jad.AdaptivePathTracer(jscenes.cornell_box(32, 32, spheres=False).build(),
                                 32, 32, max_depth=3, mode=mode, blocks_per_pass=6,
                                 select_rect=rect)
    ttr = tad.AdaptivePathTracer(tscenes.cornell_box(32, 32, spheres=False).build("cpu"),
                                 32, 32, max_depth=3, mode=mode, blocks_per_pass=6,
                                 select_rect=rect)
    rays = []
    for _ in range(6):
        jtr.do_pass()
        ttr.do_pass()
        j, t = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        assert np.abs(t - j).mean() / j.mean() < 1e-5
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        np.testing.assert_array_equal(ttr.vb.count.numpy(), np.asarray(jtr.vb.count))
        np.testing.assert_allclose(ttr.vb.mean.numpy(), np.asarray(jtr.vb.mean), **TOL)
        rays.append(ttr.rays_traced_live)
    assert ttr._rays_dev.dtype == torch.int64 and rays[0] > 6 * 256
    np.testing.assert_allclose(ttr.error_map().numpy(), np.asarray(jtr.error_map()),
                               rtol=1e-4, atol=1e-5)


def test_adaptive_rejects_partial_blocks():
    with pytest.raises(ValueError):
        tad.AdaptivePathTracer(tscenes.cornell_box(8, 8).build("cpu"), 24, 24)


def test_filter_kernels_bit_equal():
    for ft in range(5):
        for radius, taps in ((2.0, 5), (1.5, 7), (3.0, 3)):
            np.testing.assert_array_equal(tpipe.filter_kernel_1d(ft, radius, taps),
                                          jpipe.filter_kernel_1d(ft, radius, taps))


def test_pipeline_matches_jax():
    r = np.random.default_rng(4)
    img = (r.gamma(1.0, 1.0, (32, 48, 3)) * 3).astype(np.float32)
    var = (r.random((32, 48)) * 0.05).astype(np.float32)
    ti, ji = torch.from_numpy(img), jnp.asarray(img)
    for ft in range(5):
        np.testing.assert_allclose(tpipe.apply_filter(ti, ft).numpy(),
                                   np.asarray(jpipe.apply_filter(ji, ft)), **TOL)
    np.testing.assert_allclose(tpipe.tonemap_reinhard05(ti).numpy(),
                               np.asarray(jpipe.tonemap_reinhard05(ji)), **TOL)
    # the JAX NLM jitted: eagerly its ~2,400 dispatches take ~24 s
    jnlm = jax.jit(jpipe.nlm_denoise, static_argnames=("search_radius",))
    np.testing.assert_allclose(tpipe.nlm_denoise(ti).numpy(),
                               np.asarray(jnlm(ji)), **TOL)
    np.testing.assert_allclose(
        tpipe.nlm_denoise(ti, torch.from_numpy(var), search_radius=2).numpy(),
        np.asarray(jnlm(ji, jnp.asarray(var), search_radius=2)), **TOL)
    # the whole pipeline on a film with its variance buffer
    jv, _ = _fill(2, 48, 32)
    tv = _as_torch(jv)
    jf = jfilm.new_film(48, 32)._replace(rgb=ji, weight=jnp.full((32, 48), 2.0),
                                          n_passes=jnp.float32(2))
    tf = tfilm.new_film(48, 32, "cpu")._replace(rgb=ti, weight=torch.full((32, 48), 2.0),
                                                 n_passes=2.0)
    jpipeline = jax.jit(jpipe.apply_pipeline, static_argnums=(1, 2, 3))
    for ft, tm, dn in ((jpipe.F_GAUSSIAN, True, True), (jpipe.F_MITCHELL, True, False)):
        np.testing.assert_allclose(
            tpipe.apply_pipeline(tf, ft, tm, dn, tv).numpy(),
            np.asarray(jpipeline(jf, ft, tm, dn, jv)), **TOL)


# --- tests/test_framework.py's cases on the port ---

def test_welford():
    vb = tbs.VarianceBuffer.new(4, 4, "cpu")
    vals = np.random.default_rng(0).normal(2.0, 0.5, size=(100, 3)).astype(np.float32)
    for i, v in enumerate(vals):
        vb = tbs.add_samples(vb, torch.tensor([1]), torch.tensor([2]),
                             torch.from_numpy(v)[None], torch.tensor([i]),
                             torch.tensor([True]))
    assert abs(float(vb.mean[2, 1, 0]) - vals[:, 0].mean()) < 1e-3
    assert abs(float(vb.m2[2, 1, 0]) / 99 - vals[:, 0].var(ddof=1)) < 2e-2


def test_block_weights_concentrate():
    vb = tbs.VarianceBuffer.new(64, 64, "cpu")
    px = torch.from_numpy(np.tile(np.arange(8) + 16, 50).astype(np.int32))
    py = torch.from_numpy(np.tile(np.arange(8) + 32, 50).astype(np.int32))
    r = np.random.default_rng(1)
    for i in range(20):
        vals = torch.from_numpy(r.normal(1, 2.0, size=(400, 3)).astype(np.float32))
        vb = tbs.add_samples(vb, px, py, vals, torch.full((400,), i),
                             torch.ones(400, dtype=torch.bool))
    allp = torch.arange(64 * 64, dtype=torch.int32)
    for i in range(3):
        vb = tbs.add_samples(vb, allp % 64, allp // 64, torch.ones((64 * 64, 3)),
                             torch.full((64 * 64,), i),
                             torch.ones(64 * 64, dtype=torch.bool))
    w = tbs.block_weights(vb, 64, 64, tbs.B_VARIANCE).numpy()
    assert w[32 // tbs.BLOCK, 16 // tbs.BLOCK] >= w.mean()


def test_adaptive_matches_uniform():
    scene = tscenes.cornell_box(32, 32, spheres=False).build("cpu")
    img = tad.AdaptivePathTracer(scene, 32, 32, max_depth=3,
                                 mode=tbs.B_VARIANCE).render(12).numpy()
    ref = tpath.PathTracer(scene, 32, 32, max_depth=3).render(12).numpy()
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.15


def test_filters_preserve_mean():
    img = torch.from_numpy(np.random.default_rng(0).random((32, 32, 3)).astype(np.float32))
    for ft in (tpipe.F_GAUSSIAN, tpipe.F_MITCHELL, tpipe.F_TRIANGLE, tpipe.F_LANCZOS):
        assert abs(float(tpipe.apply_filter(img, ft).mean()) - float(img.mean())) < 0.02


def test_tonemap_compresses():
    img = torch.from_numpy((np.random.default_rng(1).random((16, 16, 3)) * 50)
                           .astype(np.float32))
    out = tpipe.tonemap_reinhard05(img).numpy()
    assert out.max() <= 50 and np.isfinite(out).all()


def test_nlm_reduces_noise():
    r = np.random.default_rng(2)
    clean = np.zeros((32, 32, 3), np.float32)
    clean[:, 16:] = 1.0
    noisy = clean + r.normal(0, 0.25, clean.shape).astype(np.float32)
    den = tpipe.nlm_denoise(torch.from_numpy(noisy), torch.full((32, 32), 0.25 ** 2)).numpy()
    assert np.abs(den - clean).mean() < np.abs(noisy - clean).mean() * 0.6
