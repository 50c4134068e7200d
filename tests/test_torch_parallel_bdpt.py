"""The port's sharded BDPT and VCM passes (parallel/render.py) against the
JAX package's sharded passes and against the port's single-device passes.
Kept apart from test_torch_parallel.py so that the two files' JAX compiles
land on different workers.

One launch of ``run_jobs`` on 2 gloo ranks (join timeout LAUNCH_TIMEOUT
seconds) renders every port case at 16x16, depth 3 (16x15 where the height
does not divide the mesh); the JAX side runs on conftest's virtual CPU
devices with ``make_mesh(2)``, one compilation per family.

- Against the JAX sharded pass, with test_torch_bdpt.py's and
  test_torch_vcm.py's tolerance: the film's rgb and splat buffers within a
  mean relative error of 0.5%, the weights equal. VCM at a merge radius of
  0.25, where grid cells hold more photons than a gather reads (asserted):
  both packages gather the photon rows shard-major, so this is the
  comparison that holds where a cell overflows, and the port's rgb lies
  at least 10x closer to the JAX sharded pass than to its own
  single-device pass there. The ranks run while the
  JAX package compiles (the launch waits in a thread).
- BDPT against the port's single-device pass within 1e-6 relative (rtol
  1e-6, atol 1e-6 of the image's maximum): splat parts and row film, the
  per-pass all-reduce, and the ShardedBDPT class over 2 passes.
- The ShardedBDPT and ShardedVCM classes' render() (the film developed
  without the splat parts, as the JAX package's) and develop() (parts
  folded) against the JAX tracers', within 0.5%.
- VCM against the port's single-device pass by the image mean within 1e-3
  (tests/test_parallel.py's VCM case allows as much: the shard-major photon
  order re-associates the merge sums), with splat parts, with the per-pass
  all-reduce, and the ShardedVCM class over 2 passes.
"""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.parallel import render as jpr
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import bdpt as tbdpt
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import vcm as tvcm
from cudatracerlib_tpu_torch.ops import hashgrid as thg
from cudatracerlib_tpu_torch.parallel import render as tpr
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
LAUNCH_TIMEOUT = 120
N, DEPTH = 16, 3
BOX = ("cornell_box", N, N)
ODD = ("cornell_box", N, N - 1)
RADII = (0.05, 0.25)
JOBS = [
    ("bdpt_parts", BOX, "sharded_bdpt_pass", dict(max_depth=DEPTH, splat_parts=True)),
    ("bdpt_psum", BOX, "sharded_bdpt_pass", dict(max_depth=DEPTH)),
    ("bdpt_odd_height", ODD, "sharded_bdpt_pass", dict(max_depth=DEPTH)),
    *((f"vcm_{r}", BOX, "sharded_vcm_pass", dict(max_depth=DEPTH, radius=r,
                                                  splat_parts=True)) for r in RADII),
    ("vcm_psum", BOX, "sharded_vcm_pass", dict(max_depth=DEPTH, radius=RADII[0])),
    ("ShardedBDPT", BOX, "ShardedBDPT", dict(max_depth=DEPTH, passes=2)),
    ("ShardedVCM", BOX, "ShardedVCM", dict(max_depth=DEPTH, passes=2)),
]


@pytest.fixture(scope="module", autouse=True)
def _ranks2_running(tmp_path_factory):
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(tpr.launch, tpr.run_jobs, 2, args=(JOBS,), device="cpu",
                          timeout=LAUNCH_TIMEOUT,
                          tmpdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def ranks2(_ranks2_running):
    return _ranks2_running.result()


@pytest.fixture(scope="module")
def jax_box():
    mesh = jpr.make_mesh(2)
    return jpr.replicate_scene(jscenes.cornell_box(N, N).build(), mesh), mesh


def _rel(t, j):
    return np.abs(t - j).mean() / max(np.abs(j).mean(), 1e-9)


def _close(t, ref):
    np.testing.assert_allclose(t, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    assert np.isfinite(t).all() and t.mean() > 0


def _assert_film_matches_jax(got, film, parts, mesh):
    film = jpr.fold_splat_parts(film, parts)
    for buf in ("rgb", "splat"):
        assert _rel(got[buf], np.asarray(getattr(film, buf))) < 0.005, buf
    np.testing.assert_array_equal(got["weight"], np.asarray(film.weight))


def test_bdpt_matches_jax_sharded(ranks2, jax_box):
    scene, mesh = jax_box
    film, parts = jpr.sharded_bdpt_pass(scene, jfilm.new_film(N, N), jnp.int32(0),
                                        mesh, N, N, max_depth=DEPTH,
                                        splat_parts=jpr.new_splat_parts(mesh, N, N))
    _assert_film_matches_jax(ranks2["bdpt_parts"], film, parts, mesh)


def test_vcm_matches_jax_sharded(ranks2, jax_box):
    """Within the tolerance, and in the JAX pass's photon order: the rgb
    buffer lies at least 10x closer to the JAX sharded pass than to the
    port's single-device pass, whose depth-major rows fill the overflowing
    cells with other photons (1.3e-5 apart at this size; a port that
    gathered in that order lies as far from the JAX pass)."""
    scene, mesh = jax_box
    radius = RADII[1]
    film, parts = jpr.sharded_vcm_pass(scene, jfilm.new_film(N, N), jnp.int32(0),
                                       mesh, N, N, radius=radius, max_depth=DEPTH,
                                       splat_parts=jpr.new_splat_parts(mesh, N, N))
    got = ranks2[f"vcm_{radius}"]
    _assert_film_matches_jax(got, film, parts, mesh)
    sc = tscenes.cornell_box(N, N).build("cpu")
    single, _ = tvcm.vcm_pass(sc, tfilm.new_film(N, N, "cpu"), 0, N, N, DEPTH,
                              tpath.scene_active_types(sc), radius)
    assert 10 * _rel(got["rgb"], np.asarray(film.rgb)) < _rel(got["rgb"], single.rgb.numpy())


@pytest.mark.parametrize("name", ["ShardedBDPT", "ShardedVCM"])
def test_tracer_render_matches_jax_sharded(ranks2, jax_box, name):
    """render() and develop() of the port's sharded tracer (2 gloo ranks, 2
    passes) against the JAX one's on 2 virtual devices: render() develops
    the film without the splat parts, as the JAX TracerBase.render does
    (ROADMAP queue 3, item 7); develop() folds them. Images within 0.5%
    mean relative error, and render() lacks the splats (darker)."""
    _, mesh = jax_box
    jtr = getattr(jpr, name)(jscenes.cornell_box(N, N).build(), N, N, mesh=mesh,
                             max_depth=DEPTH)
    jrender, jdevelop = np.asarray(jtr.render(2)), np.asarray(jtr.develop())
    got = ranks2[name]
    assert _rel(got["render"], jrender) < 0.005
    assert _rel(got["img"], jdevelop) < 0.005
    assert got["render"].mean() < got["img"].mean()


def test_vcm_cells_overflow_at_the_larger_radius():
    sc = tscenes.cornell_box(N, N).build("cpu")
    _, st = tvcm.vcm_pass(sc, tfilm.new_film(N, N, "cpu"), 0, N, N, DEPTH,
                          tpath.scene_active_types(sc), RADII[1])
    ids = st.grid.cell_ids[st.grid.cell_ids != thg.INT32_MAX]
    assert int(torch.unique(ids, return_counts=True)[1].max()) > 16


def _bdpt_single(spec, passes=1):
    _, w, h = spec
    return tbdpt.BDPT(tscenes.cornell_box(w, h).build("cpu"), w, h,
                      max_depth=DEPTH).render(passes).numpy()


@pytest.mark.parametrize("tag,spec,passes", [
    ("bdpt_parts", BOX, 1), ("bdpt_psum", BOX, 1), ("bdpt_odd_height", ODD, 1),
    ("ShardedBDPT", BOX, 2)])
def test_bdpt_matches_single_device(ranks2, tag, spec, passes):
    _close(ranks2[tag]["img"], _bdpt_single(spec, passes))


@pytest.mark.parametrize("tag,passes", [(f"vcm_{RADII[0]}", 1), ("vcm_psum", 1),
                                        ("ShardedVCM", 2)])
def test_vcm_matches_single_device_mean(ranks2, tag, passes):
    sc = tscenes.cornell_box(N, N).build("cpu")
    if passes == 1:
        film, _ = tvcm.vcm_pass(sc, tfilm.new_film(N, N, "cpu"), 0, N, N, DEPTH,
                                tpath.scene_active_types(sc), RADII[0])
        ref = tfilm.develop(film._replace(n_passes=1.0)).numpy()
    else:
        ref = tvcm.VCM(sc, N, N, max_depth=DEPTH).render(passes).numpy()
    got = ranks2[tag]["img"]
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()
