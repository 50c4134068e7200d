"""The port's sharded PT, LT and PPM passes (parallel/render.py) against the
JAX package's sharded passes and against the port's single-device passes.

The port runs its ranks as spawned processes over gloo (parallel.render.
launch, as the CLI's --devices does); each family of one world size is one
launch of ``run_jobs``, 2 ranks for every case and 4 ranks for one PT and
one PPM case, with a join timeout of LAUNCH_TIMEOUT seconds and a FileStore
under the test's temporary directory; the ranks run while the JAX
package compiles (the launches wait in a thread). The JAX side runs on conftest's
virtual CPU devices with ``make_mesh(2)``. Every case is 16x16 (16x15 for
the reduce_film fallback), depth 3.

- Against the JAX sharded pass, on the same seeds, with the tolerance of
  the family's single-device comparison: the film's rgb (PT, PPM) or splat
  (LT) buffer within a mean relative error of 0.5% (test_torch_path.py,
  test_torch_lighttracer.py, test_torch_ppm.py: float drift can flip a
  rare roulette draw), the weights equal.
- Against the port's single-device pass or tracer: within 1e-6 relative
  (rtol 1e-6, atol 1e-6 of the image's maximum); the only difference is
  the order of the splat sums.
- PPM with more photons than a grid cell's budget (beamgrid: 16, beambeam:
  24, asserted on the single-device grids): the sharded pass restores the
  single-device row order of the gathered photon rows (gather_exact), so
  the same photons survive and the images agree as above.
- The sharded tracer classes' render() (the film developed without the
  splat parts, as the JAX package's) and develop() (parts folded) against
  the JAX tracers', within 0.5%; the light tracer's render() is black on
  both sides.
- Adaptive radii: the per-pixel r2 after 2 passes equals the single-device
  tracer's (tests/test_parallel.py's case for JAX), and after one pass
  the image and r2 match the JAX ShardedPPMTracer's at
  test_torch_ppm_adaptive.py's tolerance.
"""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.parallel import render as jpr
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import lighttracer as tlt
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import ppm as tppm
from cudatracerlib_tpu_torch.ops import hashgrid as thg
from cudatracerlib_tpu_torch.parallel import render as tpr
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
LAUNCH_TIMEOUT = 120
N, DEPTH = 16, 3
BOX = ("cornell_box", N, N)
FOG = ("fog_cornell", N, N)
PPM_PHOTONS = 2048
FOG_R = 0.12
PPM_KW = dict(max_depth=DEPTH, radius=FOG_R, n_photons=PPM_PHOTONS, with_volume=True)
BEAMGRID = dict(PPM_KW, vol_est="beamgrid", vol_max_per_cell=16)
BEAMBEAM = dict(PPM_KW, vol_est="beambeam", vol_max_per_cell=24)
ADAPT_KW = dict(max_depth=DEPTH, initial_radius=0.08, adaptive_radii=True)

JOBS2 = [
    ("pt_rows", BOX, "sharded_pt_pass", dict(max_depth=DEPTH)),
    ("pt_reduce", BOX, "sharded_pt_pass", dict(max_depth=DEPTH, reduce_film=True)),
    ("pt_odd_height", ("cornell_box", N, N - 1), "sharded_pt_pass",
     dict(max_depth=DEPTH)),
    ("lt_parts", BOX, "sharded_lt_pass", dict(max_depth=DEPTH, splat_parts=True)),
    ("lt_psum", BOX, "sharded_lt_pass", dict(max_depth=DEPTH)),
    ("ppm_beamgrid", FOG, "sharded_ppm_pass", BEAMGRID),
    ("ppm_beambeam", FOG, "sharded_ppm_pass", BEAMBEAM),
    ("ppm_surface", BOX, "sharded_ppm_pass", dict(max_depth=DEPTH, radius=0.08)),
    ("ShardedPathTracer", BOX, "ShardedPathTracer", dict(max_depth=DEPTH, passes=2)),
    ("ShardedLightTracer", BOX, "ShardedLightTracer", dict(max_depth=DEPTH, passes=2)),
    ("ShardedPPMTracer", BOX, "ShardedPPMTracer", dict(ADAPT_KW, passes=2)),
    ("ShardedPPMTracer_1", BOX, "ShardedPPMTracer", dict(ADAPT_KW, passes=1)),
]
JOBS4 = [("pt_rows_4", BOX, "sharded_pt_pass", dict(max_depth=DEPTH)),
         ("ppm_beamgrid_4", FOG, "sharded_ppm_pass", BEAMGRID)]


def _launch(jobs, n, tmp_path_factory):
    return tpr.launch(tpr.run_jobs, n, args=(jobs,), device="cpu",
                      timeout=LAUNCH_TIMEOUT,
                      tmpdir=str(tmp_path_factory.mktemp(f"ranks{n}")))


@pytest.fixture(scope="module", autouse=True)
def _ranks_running(tmp_path_factory):
    """Both launches, run one after the other in a thread while the JAX
    package compiles."""
    with ThreadPoolExecutor(1) as pool:
        yield {n: pool.submit(_launch, jobs, n, tmp_path_factory)
               for n, jobs in ((2, JOBS2), (4, JOBS4))}


@pytest.fixture(scope="module")
def ranks2(_ranks_running):
    return _ranks_running[2].result()


@pytest.fixture(scope="module")
def ranks4(_ranks_running):
    return _ranks_running[4].result()


def _rel(t, j):
    return np.abs(t - j).mean() / max(np.abs(j).mean(), 1e-9)


def _close(t, ref):
    np.testing.assert_allclose(t, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    assert np.isfinite(t).all() and t.mean() > 0


@pytest.fixture(scope="module")
def jax_mesh():
    return jpr.make_mesh(2)


def _jax_scene(spec, mesh):
    name, w, h = spec
    return jpr.replicate_scene(getattr(jscenes, name)(w, h).build(), mesh)


def _port_scene(spec):
    name, w, h = spec
    return getattr(tscenes, name)(w, h).build("cpu")


def test_pt_matches_jax_sharded(ranks2, jax_mesh):
    film = jpr.sharded_pt_pass(_jax_scene(BOX, jax_mesh), jfilm.new_film(N, N),
                               jnp.int32(0), jax_mesh, N, N, max_depth=DEPTH)
    got = ranks2["pt_rows"]
    assert _rel(got["rgb"], np.asarray(film.rgb)) < 0.005
    np.testing.assert_array_equal(got["weight"], np.asarray(film.weight))


def test_lt_matches_jax_sharded(ranks2, jax_mesh):
    parts = jpr.sharded_lt_pass(_jax_scene(BOX, jax_mesh), jfilm.new_film(N, N),
                                jnp.int32(0), jax_mesh, N, N, max_depth=DEPTH,
                                splat_parts=jpr.new_splat_parts(jax_mesh, N, N))
    film = jpr.fold_splat_parts(jfilm.new_film(N, N), parts)
    assert _rel(ranks2["lt_parts"]["splat"], np.asarray(film.splat)) < 0.005


def test_ppm_matches_jax_sharded(ranks2, jax_mesh):
    """Beamgrid on the fog box with overflowing cells."""
    film = jpr.sharded_ppm_pass(_jax_scene(FOG, jax_mesh), jfilm.new_film(N, N),
                                jnp.int32(0), jax_mesh, N, N, **BEAMGRID)
    got = ranks2["ppm_beamgrid"]
    assert _rel(got["rgb"], np.asarray(film.rgb)) < 0.005
    np.testing.assert_array_equal(got["weight"], np.asarray(film.weight))


def _single(tag):
    """The port's single-device counterpart of a job: its image."""
    if tag.startswith("pt"):
        spec = ("cornell_box", N, N - 1) if tag == "pt_odd_height" else BOX
        return tpath.PathTracer(_port_scene(spec), spec[1], spec[2],
                                max_depth=DEPTH).render(1).numpy()
    if tag.startswith("lt"):
        return tlt.LightTracer(_port_scene(BOX), N, N, max_depth=DEPTH).render(1).numpy()
    if tag == "ppm_surface":
        return tppm.PPMTracer(_port_scene(BOX), N, N, max_depth=DEPTH,
                              initial_radius=0.08).render(1).numpy()
    kw = BEAMGRID if "beamgrid" in tag else BEAMBEAM
    return tppm.PPMTracer(_port_scene(FOG), N, N, max_depth=DEPTH,
                          initial_radius=FOG_R, n_photons=PPM_PHOTONS,
                          vol_estimator=kw["vol_est"],
                          vol_max_per_cell=kw["vol_max_per_cell"]).render(1).numpy()


@pytest.mark.parametrize("tag", ["pt_rows", "pt_reduce", "pt_odd_height",
                                 "lt_parts", "lt_psum", "ppm_beamgrid",
                                 "ppm_beambeam", "ppm_surface"])
def test_pass_matches_single_device(ranks2, tag):
    _close(ranks2[tag]["img"], _single(tag))


@pytest.mark.parametrize("tag", ["pt_rows_4", "ppm_beamgrid_4"])
def test_four_ranks_match_single_device(ranks4, tag):
    _close(ranks4[tag]["img"], _single(tag[:-2]))


@pytest.mark.parametrize("kw", [BEAMGRID, BEAMBEAM], ids=["beamgrid", "beambeam"])
def test_ppm_cells_overflow(kw):
    """The single-device volume grid of the PPM cases holds cells with more
    rows than the estimator reads, so the row order decides what they
    keep."""
    sc = _port_scene(FOG)
    tr = tppm.PPMTracer(sc, N, N, max_depth=DEPTH, initial_radius=FOG_R,
                        n_photons=PPM_PHOTONS, vol_estimator=kw["vol_est"])
    rows, valid, *beams = tppm.trace_photons(
        sc, PPM_PHOTONS, 0, 0x9907, DEPTH, tr.active_types, store_medium=True,
        collect_beams=kw["vol_est"] == "beambeam")
    r = torch.tensor(FOG_R)
    if beams:
        from cudatracerlib_tpu_torch.models import vol_estimators as tve
        grid = tve.build_beam_cells(beams[0], beams[1], r, sc.world_lo, sc.world_hi)
    else:
        grid = tppm._build_vol_grid_ball(rows, valid, r, sc.world_lo, sc.world_hi)
    ids = grid.cell_ids[grid.cell_ids != thg.INT32_MAX]
    assert int(torch.unique(ids, return_counts=True)[1].max()) > kw["vol_max_per_cell"]


def test_tracer_classes_match_single_device(ranks2):
    scene = _port_scene(BOX)
    for name, single in (("ShardedPathTracer", tpath.PathTracer(scene, N, N, max_depth=DEPTH)),
                         ("ShardedLightTracer", tlt.LightTracer(scene, N, N, max_depth=DEPTH))):
        _close(ranks2[name]["img"], single.render(2).numpy())


@pytest.mark.parametrize("name", ["ShardedPathTracer", "ShardedLightTracer"])
def test_tracer_render_matches_jax_sharded(ranks2, jax_mesh, name):
    """render() and develop() of the port's sharded tracer (2 gloo ranks, 2
    passes) against the JAX one's on 2 virtual devices: render() develops
    the film without the splat parts, as the JAX TracerBase.render does
    (ROADMAP queue 3, item 7), so the light tracer's is black on both
    sides; develop() folds them. Images within 0.5% mean relative error."""
    jtr = getattr(jpr, name)(jscenes.cornell_box(N, N).build(), N, N, mesh=jax_mesh,
                             max_depth=DEPTH)
    jrender = np.asarray(jtr.render(2))
    jdevelop = np.asarray(jtr.develop() if hasattr(jtr, "develop")
                          else jfilm.develop(jtr.film))
    got = ranks2[name]
    if name == "ShardedLightTracer":
        assert not jrender.any() and not got["render"].any()
    else:
        assert _rel(got["render"], jrender) < 0.005
    assert _rel(got["img"], jdevelop) < 0.005 and jdevelop.mean() > 0


def test_ppm_adaptive_radii_match_jax_sharded(ranks2, jax_mesh):
    """ShardedPPMTracer with adaptive radii, one pass (each JAX pass
    compiles anew), against the JAX one on 2 devices: the image within
    test_torch_ppm_adaptive.py's 0.5% mean relative error, the per-pixel
    r2 at its rtol 1e-4 / atol 1e-6."""
    jtr = jpr.ShardedPPMTracer(jscenes.cornell_box(N, N).build(), N, N, mesh=jax_mesh,
                               **ADAPT_KW)
    img = np.asarray(jtr.render(1))
    got = ranks2["ShardedPPMTracer_1"]
    assert _rel(got["img"], img) < 0.005
    np.testing.assert_allclose(got["r2"], np.asarray(jtr._ppm_state.r2), rtol=1e-4,
                               atol=1e-6)


def test_ppm_adaptive_radii_match_single_device(ranks2):
    tr = tppm.PPMTracer(_port_scene(BOX), N, N, **ADAPT_KW)
    img = tr.render(2).numpy()
    got = ranks2["ShardedPPMTracer"]
    np.testing.assert_array_equal(got["r2"], tr._ppm_state.r2.numpy())
    _close(got["img"], img)


def test_make_mesh_needs_launch_for_several_ranks():
    with pytest.raises(ValueError):
        tpr.make_mesh(2, device="cpu")


def test_launch_timeout_kills_the_ranks(tmp_path, ranks2, ranks4):
    """A launch still running at its timeout raises; its ranks are gone
    (the spawned ranks cannot even import within 0.5 s). The module's own
    launches have ended before."""
    with pytest.raises(TimeoutError):
        tpr.launch(tpr.run_jobs, 2, args=(JOBS4,), device="cpu", timeout=0.5,
                   tmpdir=str(tmp_path))
    import multiprocessing
    assert not multiprocessing.active_children()
