"""The port's path-tracing pass against the JAX package's, and the golden.

Pass for pass on Cornell 32x32 at depth 4: the film's mean relative error
stays under 0.5% and the live-ray counters agree within 0.1%. The bound is
not exact because float drift (XLA's FMA contraction on the CPU) can flip a
rare Russian-roulette draw or a near-tie triangle. The 16-pass render is
then held to tests/goldens/cornell_32_pt.npz at test_golden.py's tolerance
(mean relative error < 0.02).

The San Miguel stand-in (20,000 triangles: native BVH, treelet split, an
image and a checkerboard texture, a distant light and the sky map) is held
to the JAX PathTracer the same way at 32x32, depth 3. On the CPU the JAX
package traverses the single table while the port runs the plain versions
of its treelet path (K2, K3, K1 fallback), so the comparison also holds
the treelet path to the single-table traversal end to end.

veach-mis (four GGX rough-conductor bars, alpha 0.005-0.1, and four sphere
lights as emissive meshes) is held to the JAX PathTracer pass for pass at
32x32, depth 5, 2 passes, at the same bars; on the pass's camera rays the
pool traversal (K4's plain version on the CPU) gives K1's hits, step
counts and flags."""
import os

import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.scene import native_bvh as jnative
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import tracer as ttracer
from cudatracerlib_tpu_torch.ops import traversal8, traversal_tt
from cudatracerlib_tpu_torch.scene import native_bvh as tnative
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_32_pt.npz")


def test_pt_chunk_pass_for_pass():
    jtr = jpath.PathTracer(jscenes.cornell_box(32, 32).build(), 32, 32, max_depth=4)
    ttr = tpath.PathTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32, max_depth=4)
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


def test_san_miguel_pass_for_pass(monkeypatch, tmp_path):
    # the JAX build's caches bypassed; its native builder runs the library
    # the port compiled from the same source (no racing `make` into native/)
    monkeypatch.setattr(jnative, "_load", tnative._load)
    monkeypatch.setattr(jnative, "_build_cache_path",
                        lambda v0, v1, v2: str(tmp_path / "bvh8.npz"))
    monkeypatch.setattr(jtreelet, "partition_cached",
                        lambda table, **kw: jtreelet.partition(table, **kw))
    jsc = jscenes.san_miguel_stand_in(32, 32, target_tris=20000).build()
    tsc = tscenes.san_miguel_stand_in(32, 32, target_tris=20000).build("cpu")
    assert traversal8.treelet_would_dispatch(tsc.geom)
    jtr = jpath.PathTracer(jsc, 32, 32, max_depth=3)
    ttr = tpath.PathTracer(tsc, 32, 32, max_depth=3)
    calls = traversal_tt.top_visits.cuda_calls
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j_rgb = np.asarray(jtr.film.rgb)
        t_rgb = ttr.film.rgb.numpy()
        rel = np.abs(t_rgb - j_rgb).mean() / j_rgb.mean()
        assert rel < 0.005, rel
        j_rays, t_rays = jtr.rays_traced_live, ttr.rays_traced_live
        assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert np.isfinite(t_rgb).all() and t_rgb.mean() > 0
    assert ttr._ovf_dev.tolist() == [0, 0]
    assert int(ttr._iters_dev) == int(ttr._rows_dev) > t_rays
    assert traversal_tt.top_visits.cuda_calls == calls     # CPU tensors only


def test_cornell_golden():
    before = traversal8.intersect_wide_cuda.launches
    tr = tpath.PathTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32,
                          max_depth=4, spp_per_pass=1)
    img = tr.render(16).numpy()
    ref = np.load(GOLDEN)["img"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.02, f"golden drift {rel:.4f}"
    # on the CPU the pass never touches the CUDA kernel
    assert traversal8.intersect_wide_cuda.launches == before


def test_unported_features_raise():
    """Path regularization, the other BSDF types and the sequence samplers
    are ported (the name is kept from when they raised): each renders a
    finite film. Regularization is held to JAX in
    tests/test_torch_regularize.py, the samplers in
    tests/test_torch_samplers.py."""
    sc = tscenes.cornell_box(8, 8).build("cpu")
    tr = tpath.PathTracer(sc, 8, 8, regularize=True)
    assert set(tr.active_types) >= {4, 6}    # the rough dielectric and conductor
    assert tr.render(1).isfinite().all()
    assert tpath.PathTracer(sc, 8, 8, active_types=(0, 7)).render(1).isfinite().all()
    assert tpath.PathTracer(sc, 8, 8, sampler_type=2).render(1).isfinite().all()


def test_veach_mis_pass_for_pass():
    jtr = jpath.PathTracer(jscenes.veach_mis(32, 32).build(), 32, 32, max_depth=5)
    sc = tscenes.veach_mis(32, 32).build("cpu")
    ttr = tpath.PathTracer(sc, 32, 32, max_depth=5)
    assert ttr.active_types == (0, 6)     # diffuse and rough conductor
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
    assert np.isfinite(t_rgb).all() and t_rgb.mean() > 0
    assert ttr._ovf_dev.tolist() == [0, 0]
    # the pool traversal (on the CPU K1's plain version) gives K1's result
    # on the pass's camera rays, half of them any-hit
    pix = torch.arange(32 * 32, dtype=torch.int32)
    rays = ttracer.gen_camera_rays(sc, pix, 0, 0, 32, 32)[0]
    rays = rays._replace(o=rays.o.contiguous())
    amask = pix % 2 == 0
    k4 = traversal8.intersect_wide_pool(sc.geom.wide, rays, with_iters=True,
                                        any_mask=amask)
    k1 = traversal8.intersect_scene(sc.geom, rays, with_iters=True, any_mask=amask)
    for x, y in zip((*k4[0][:4], k4[1].sum(dtype=torch.int64)), (*k1[0][:4], k1[1])):
        assert torch.equal(x, y)
    assert int(k4[2].ne(0).sum()) == 0 and k1[3].tolist() == [0, 0]
