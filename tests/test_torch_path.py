"""The port's path-tracing pass against the JAX package's, and the golden.

Pass for pass on Cornell 32x32 at depth 4: the film's mean relative error
stays under 0.5% and the live-ray counters agree within 0.1%. The bound is
not exact because float drift (XLA's FMA contraction on the CPU) can flip a
rare Russian-roulette draw or a near-tie triangle. The 16-pass render is
then held to tests/goldens/cornell_32_pt.npz at test_golden.py's tolerance
(mean relative error < 0.02)."""
import os

import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_32_pt.npz")


def test_pt_chunk_pass_for_pass():
    jtr = jpath.PathTracer(jscenes.cornell_box(32, 32).build(), 32, 32, max_depth=4)
    ttr = tpath.PathTracer(tscenes.cornell_box(32, 32).build(), 32, 32, max_depth=4)
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j_rgb = np.asarray(jtr.film.rgb)
        t_rgb = ttr.film.rgb.numpy()
        rel = np.abs(t_rgb - j_rgb).mean() / j_rgb.mean()
        assert rel < 0.005, rel
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        j_rays, t_rays = jtr.rays_traced_live, ttr.rays_traced_live
        assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert ttr._rays_dev.dtype == ttr._iters_dev.dtype == torch.int64
    assert ttr._ovf_dev.tolist() == [0, 0]
    assert int(ttr._iters_dev) == int(ttr._rows_dev) > t_rays


def test_cornell_golden():
    before = traversal8.intersect_wide_cuda.launches
    tr = tpath.PathTracer(tscenes.cornell_box(32, 32).build(), 32, 32,
                          max_depth=4, spp_per_pass=1)
    img = tr.render(16).numpy()
    ref = np.load(GOLDEN)["img"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.02, f"golden drift {rel:.4f}"
    # on the CPU the pass never touches the CUDA kernel
    assert traversal8.intersect_wide_cuda.launches == before


def test_unported_features_raise():
    sc = tscenes.cornell_box(8, 8).build()
    with pytest.raises(NotImplementedError):
        tpath.PathTracer(sc, 8, 8, sampler_type=2)
    with pytest.raises(NotImplementedError):
        tpath.PathTracer(sc, 8, 8, active_types=(0, 5)).render(1)
