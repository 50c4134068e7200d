"""The port's regenerating wavefront path tracer.

Against the port's chunked PathTracer on the Cornell box 32x32, depth 4,
2 passes, with a pool of 1,024 lanes (every path at once) and of 768 (fewer
lanes than paths and not a divisor of them: several regeneration waves, a
drain tail): the same sample set per pixel, so the images within
tests/test_wavefront.py's rtol 1e-5 / atol 1e-7 (the film adds a pixel's
samples in another order) and the live-ray counts identical. Against the
JAX package's WavefrontPT at 16x16, depth 3, 256 lanes, 2 passes: the film
within a mean relative error of 0.5% (float drift can flip a rare roulette
draw, as in test_torch_path.py), the weights equal, the live rays within
0.1%. The capped and overflowed counts are 0; the loop reads one exit test
back per iteration, plus the last; a fog scene raises (alpha, bump and
parallax scenes are ported: test_torch_texture_features; regularization:
test_torch_regularize).
"""
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import wavefront as jwf
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import wavefront as twf
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.scene import host as thost, schema as tschema
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)


@pytest.mark.parametrize("lanes", [1024, 768])
def test_wavefront_matches_pt(lanes):
    scene = tscenes.cornell_box(32, 32).build("cpu")
    pt = tpath.PathTracer(scene, 32, 32, max_depth=4, chunk_size=32 * 32)
    wf = twf.WavefrontPT(scene, 32, 32, max_depth=4, lanes=lanes)
    i1, i2 = pt.render(2).numpy(), wf.render(2).numpy()
    assert np.isfinite(i2).all() and i2.mean() > 0
    np.testing.assert_allclose(i2, i1, rtol=1e-5, atol=1e-7)
    assert wf._rays_dev.dtype == torch.int64
    assert wf.rays_traced_live == pt.rays_traced_live
    assert int(wf._iters_dev) == int(wf._rows_dev) > 0
    # more regeneration waves with fewer lanes
    assert wf.last_pass_iters >= 5 + (lanes < 1024)


def test_wavefront_matches_jax():
    jtr = jwf.WavefrontPT(jscenes.cornell_box(16, 16).build(), 16, 16, max_depth=3,
                          lanes=256)
    ttr = twf.WavefrontPT(tscenes.cornell_box(16, 16).build("cpu"), 16, 16,
                          max_depth=3, lanes=256)
    before = traversal8.intersect_wide_cuda.launches
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j, t = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        assert np.abs(t - j).mean() / np.abs(j).mean() < 0.005
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        j_rays = jtr.rays_traced_live
        assert abs(ttr.rays_traced_live - j_rays) <= 1e-3 * j_rays
    assert traversal8.intersect_wide_cuda.launches == before    # CPU tensors only


def test_wavefront_overflow_counter_zero():
    tr = twf.WavefrontPT(tscenes.cornell_box(16, 16).build("cpu"), 16, 16,
                         max_depth=3, lanes=256)
    tr.render(1)
    assert tr._ovf_dev.tolist() == [0, 0]


@pytest.mark.parametrize("lanes", [256, 100])
def test_host_reads_per_pass(lanes):
    """One exit test a loop iteration, and the last one that ends it."""
    tr = twf.WavefrontPT(tscenes.cornell_box(16, 16).build("cpu"), 16, 16,
                         max_depth=3, lanes=lanes)
    for _ in range(2):
        reads0 = twf.host_reads
        tr.do_pass()
        assert tr.last_pass_host_reads == tr.last_pass_iters + 1
        assert twf.host_reads - reads0 == tr.last_pass_host_reads
        # 256 paths over `lanes` lanes of <= depth + 1 iterations each
        assert 4 <= tr.last_pass_iters <= (256 // lanes + 2) * 5


def test_unported_scenes_raise():
    fog = tscenes.fog_cornell(8, 8).build("cpu")
    with pytest.raises(ValueError):
        twf.WavefrontPT(fog, 8, 8)
    sc = tscenes.cornell_box(8, 8)
    sc.add_material(thost.MaterialSpec(alpha_mode=tschema.ALPHA_LUMINANCE))
    assert twf.WavefrontPT(sc.build("cpu"), 8, 8)._kw["with_alpha"]
    # regularization is ported: a finite pass (held to the chunked tracer
    # in tests/test_torch_regularize.py)
    wf = twf.WavefrontPT(tscenes.cornell_box(8, 8).build("cpu"), 8, 8, regularize=True)
    assert wf.render(1).isfinite().all()
