"""The port's VCM against the JAX package's.

``vcm_pass`` pass for pass at 16x16, depth 3, on the Cornell box and the
glass Cornell box (BASELINE config 4's scene), 2 passes each, with the
radius each tracer's schedule gives: the RNG state after every BSDF
sample (5 light-walk and 3 camera-walk draws) and the photon rows' valid
masks bit for bit; where valid, the photon rows' position, power,
direction and normal at rtol 1e-4 / atol 1e-5 (they went through a
traversal) and their three MIS quantities at rtol 1e-3 (each a product of
up to five ratios of pdfs, cosines and squared distances); the film's rgb and splat
buffers within a mean relative error of 0.5% (float drift can flip a rare
roulette draw or Fresnel coin, as in test_torch_bdpt.py), the weights
equal. One JAX compilation per scene: the jitted JAX pass returns what the
patched ``bsdf.sample_with_rng`` and ``hashgrid.build_grid`` saw.

Then: the initial radius, the radius schedule r_i = r_0 i^((alpha-1)/2)
and eta_vcm = pi r^2 n_paths exactly; the port's 4-pass render against
tests/goldens/cornell_32_vcm.npz (test_goldens_family.py's bound, mean
relative error < 0.02); ``photon_gather_axis`` taking a mesh of
parallel/render.py (on a gloo world of one, the gathered pass equals the
ungathered one; tests/test_torch_parallel_bdpt.py holds 2 ranks to JAX)."""
import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import bsdf as jbsdf
from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import vcm as jvcm
from cudatracerlib_tpu.ops import hashgrid as jhg
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import bsdf as tbsdf
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import vcm as tvcm
from cudatracerlib_tpu_torch.ops import hashgrid as thg
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_32_vcm.npz")
SIZE, DEPTH = 16, 3
SCENES = ("cornell_box", "cornell_glass")


@contextlib.contextmanager
def _capture(bsdf_mod, grid_mod, states, grids):
    """Record the state each sample_with_rng returns and the rows and valid
    mask build_grid receives."""
    sample, build = bsdf_mod.sample_with_rng, grid_mod.build_grid

    def sample_rec(*a, **k):
        s, state = sample(*a, **k)
        states.append(state)
        return s, state

    def build_rec(data, positions, valid, *a, **k):
        grids.append((data, valid))
        return build(data, positions, valid, *a, **k)
    with mock.patch.object(bsdf_mod, "sample_with_rng", sample_rec), \
            mock.patch.object(grid_mod, "build_grid", build_rec):
        yield


@pytest.fixture(scope="module")
def jax_pass():
    """{scene: jitted JAX vcm_pass returning (film, states, rows, valid)}."""
    fns = {}

    def get(name, types):
        if name not in fns:
            def run(scene, film, pass_idx, radius):
                states, grids = [], []
                with _capture(jbsdf, jhg, states, grids):
                    film = jvcm.vcm_pass(scene, film, pass_idx, SIZE, SIZE, DEPTH,
                                         types, radius)
                return film, jnp.stack(states), grids[0][0], grids[0][1]
            fns[name] = jax.jit(run)
        return fns[name]
    return get


def _rel(t, j):
    return np.abs(t - j).mean() / max(np.abs(j).mean(), 1e-9)


@pytest.mark.parametrize("name", SCENES)
def test_vcm_pass_for_pass(name, jax_pass):
    jsc = getattr(jscenes, name)(SIZE, SIZE).build()
    tsc = getattr(tscenes, name)(SIZE, SIZE).build("cpu")
    jtr = jvcm.VCM(jsc, SIZE, SIZE, max_depth=DEPTH)
    ttr = tvcm.VCM(tsc, SIZE, SIZE, max_depth=DEPTH)
    assert ttr.active_types == jtr.active_types
    fn = jax_pass(name, jtr.active_types)
    jf = jfilm.new_film(SIZE, SIZE)
    before = traversal8.intersect_wide_cuda.launches
    for k in range(2):
        # JAX VCM.render_pass's schedule
        radius = jtr.initial_radius * (max(k + 1, 1) ** ((jtr.alpha - 1.0) / 2.0))
        jf, jstates, jrows, jvalid = fn(jsc, jf, jnp.int32(k), jnp.float32(radius))
        states, grids = [], []
        stored0 = ttr.photons_stored
        with _capture(tbsdf, thg, states, grids):
            ttr.do_pass()
        assert ttr.radius == radius
        assert len(states) == tvcm.NUM_LIGHT_V + DEPTH == jstates.shape[0]
        np.testing.assert_array_equal(torch.stack(states).numpy(),
                                      np.asarray(jstates).astype(np.int64))
        rows, valid = grids[0]
        assert rows.shape == (tvcm.NUM_LIGHT_V * SIZE * SIZE, tvcm.PHOTON_K)
        v = np.asarray(jvalid)
        np.testing.assert_array_equal(valid.numpy(), v)
        assert ttr.photons_stored - stored0 == v.sum()
        t_rows, j_rows = rows.numpy()[v], np.asarray(jrows)[v]
        np.testing.assert_allclose(t_rows[:, :12], j_rows[:, :12], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t_rows[:, 12:], j_rows[:, 12:], rtol=1e-3, atol=1e-5)
        for buf in ("rgb", "splat"):
            j, t = np.asarray(getattr(jf, buf)), getattr(ttr.film, buf).numpy()
            assert _rel(t, j) < 0.005, (buf, _rel(t, j))
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jf.weight))
    img = tfilm.develop(ttr.film).numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    assert ttr._rays_dev.dtype == ttr._stored_dev.dtype == torch.int64
    assert ttr.rays_traced_live > 2 * SIZE * SIZE and ttr.photons_stored > 0
    assert ttr.last_grid.data.shape == rows.shape
    assert traversal8.intersect_wide_cuda.launches == before    # CPU tensors only


@pytest.mark.parametrize("name", SCENES)
def test_radius_schedule_and_eta(name, monkeypatch):
    """The initial radius (0.005 x the world diagonal), the radius each
    pass receives and eta_vcm, against the JAX package's formulas."""
    jtr = jvcm.VCM(getattr(jscenes, name)(8, 8).build(), 8, 8)
    ttr = tvcm.VCM(getattr(tscenes, name)(8, 8).build("cpu"), 8, 8)
    assert ttr.initial_radius == jtr.initial_radius and ttr.alpha == jtr.alpha
    got = []

    def fake_pass(scene, film, pass_idx, w, h, max_depth, types, radius, **kw):
        got.append((pass_idx, radius))
        z = torch.zeros((), dtype=torch.int64)
        return film, tvcm.PassStats(rays=z, photons=z, grid=None)
    monkeypatch.setattr(tvcm, "vcm_pass", fake_pass)
    ttr.render(6)
    for k, (pass_idx, radius) in enumerate(got):
        want = jtr.initial_radius * (max(k + 1, 1) ** ((jtr.alpha - 1.0) / 2.0))
        assert pass_idx == k and radius == want
        for n in (64.0, 256.0, 65536.0):
            eta = tvcm.eta_vcm(torch.tensor(radius, dtype=torch.float32), n)
            j_eta = jnp.pi * jnp.float32(radius) * jnp.float32(radius) * n
            assert eta.dtype == torch.float32
            np.testing.assert_array_equal(eta.numpy(), np.asarray(j_eta))


def test_vcm_golden():
    img = tvcm.VCM(tscenes.cornell_box(32, 32).build("cpu"), 32, 32,
                   max_depth=4).render(4).numpy()
    ref = np.load(GOLDEN)["img"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.02, f"golden drift {rel:.4f}"


def test_photon_gather_axis_raises():
    """photon_gather_axis no longer raises: it takes a Mesh and gathers the
    photon rows over it (the name stays from when it raised)."""
    import torch.distributed as dist
    from cudatracerlib_tpu_torch.parallel import render as tpr
    sc = tscenes.cornell_box(8, 8).build("cpu")
    try:
        mesh = tpr.make_mesh(1, device="cpu")
        got, st = tvcm.vcm_pass(sc, tfilm.new_film(8, 8, "cpu"), 0, 8, 8, 2, (0,), 0.01,
                                photon_gather_axis=mesh)
    finally:
        dist.destroy_process_group()
    want, st1 = tvcm.vcm_pass(sc, tfilm.new_film(8, 8, "cpu"), 0, 8, 8, 2, (0,), 0.01)
    for buf in ("rgb", "weight", "splat"):
        torch.testing.assert_close(getattr(got, buf), getattr(want, buf), rtol=0, atol=0)
    assert int(st.photons) == int(st1.photons) > 0
