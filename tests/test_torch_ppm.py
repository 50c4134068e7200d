"""The port's photon mapping against the JAX package's: the smoothing
kernels, the hash grid, the DDA walk and the PPM tracer in fog.

Bit for bit: the boundary-correction tables, the float-to-int32 cell
conversion (rays that miss a grid reach cell coordinates near +-1e12;
XLA saturates and sends NaN to 0, ``hashgrid.to_int32`` does the same),
the sorted cell ids and row orders of the photon grid, the ball grid and
the beam grid (a stable sort, as JAX's), the query ranges and neighbor
cells, the DDA walk's visits, and the photon pass's valid masks. Kernel
weights and gathered sums at rtol 1e-5 / atol 1e-6; photon rows, which
went through a tracking loop and a traversal, at rtol 1e-4 / atol 1e-5.
The DDA walk stops once every lane is dead (tests/test_vol_estimators.py's
early-exit case) and counts its host reads.

PPMTracer (beamgrid) on fog_cornell 16x16, depth 4, pass for pass against
the JAX tracer: images within a mean relative error of 0.5% (float drift
can flip a rare roulette or tracking draw, as in test_torch_path.py), the
radius schedule and photon counts equal. Then the port's 6-pass Cornell
render against tests/goldens/cornell_32_ppm.npz (mean relative error
< 0.02, test_goldens_family.py's bound). The estimators are in
test_torch_vol_estimators.py, the media-free cases of tests/test_ppm.py
and tests/test_ppm_adaptive.py in test_torch_ppm_adaptive.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import kernels as jkern
from cudatracerlib_tpu.models import ppm as jppm
from cudatracerlib_tpu.models import vol_estimators as jve
from cudatracerlib_tpu.ops import dda as jdda, hashgrid as jhg
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.core import kernels as tkern
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import ppm as tppm
from cudatracerlib_tpu_torch.models import vol_estimators as tve
from cudatracerlib_tpu_torch.ops import dda as tdda, hashgrid as thg
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_32_ppm.npz")
TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(a, b):
    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-9))


def test_to_int32_saturates_like_xla():
    x = np.array([1e12, -1e12, np.inf, -np.inf, np.nan, 3.7, -3.7, 0.0,
                  2147483520.0, 2147483648.0, -2147483648.0, -2147483904.0],
                 np.float32)
    got = thg.to_int32(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(jnp.asarray(x).astype(jnp.int32)))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernels(dim):
    r = np.random.default_rng(dim)
    t = r.uniform(0.0, 1.2, 4096).astype(np.float32)
    rad = r.uniform(0.01, 1.0, 4096).astype(np.float32)
    for kt in (jkern.UNIFORM, jkern.PERLIN):
        np.testing.assert_allclose(tkern.k(kt, _t(t), _t(rad), dim).numpy(),
                                   _np(jkern.k(kt, jnp.asarray(t), jnp.asarray(rad), dim)),
                                   **TOL)
    np.testing.assert_allclose(tkern.perlin_k(_t(t), _t(rad), dim).numpy(),
                               _np(jkern.perlin_k(jnp.asarray(t), jnp.asarray(rad), dim)),
                               **TOL)
    np.testing.assert_allclose(tkern.uniform_k(_t(t), _t(rad), dim).numpy(),
                               _np(jkern.uniform_k(jnp.asarray(t), jnp.asarray(rad), dim)),
                               **TOL)
    np.testing.assert_array_equal(getattr(tkern, f"_FRAC_{dim}D"),
                                  getattr(jkern, f"_FRAC_{dim}D"))
    b = r.uniform(-0.1, 1.2, 4096).astype(np.float32)
    np.testing.assert_allclose(tkern.boundary_frac(_t(b), _t(rad), dim).numpy(),
                               _np(jkern.boundary_frac(jnp.asarray(b), jnp.asarray(rad), dim)),
                               **TOL)


def _photons(n=4000, seed=0, lo=-2.0, hi=2.0):
    r = np.random.default_rng(seed)
    pos = (r.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    rows = np.concatenate([pos, r.random((n, 9)).astype(np.float32)], 1)
    valid = r.random(n) < 0.9
    return pos, rows, valid


def _same_grid(tg, jg):
    np.testing.assert_array_equal(tg.cell_ids.numpy(), _np(jg.cell_ids))
    np.testing.assert_array_equal(tg.data.numpy(), _np(jg.data))
    np.testing.assert_array_equal(tg.dims.numpy(), _np(jg.dims))
    np.testing.assert_array_equal(tg.inv_cell.numpy(), _np(jg.inv_cell))
    assert tg.cell_ids.dtype == tg.dims.dtype == torch.int32
    assert tg.data_t is None


def test_hashgrid_query():
    """tests/test_ppm.py's grid case: the grid bit for bit, and the gathered
    counts equal to JAX's and to brute force."""
    pos, rows, valid = _photons()
    lo, hi, radius = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32), 0.15
    jg = jhg.build_grid(jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(valid),
                        jnp.asarray(lo), jnp.asarray(hi), jnp.float32(2 * radius))
    tg = thg.build_grid(_t(rows), _t(pos), _t(valid), _t(lo), _t(hi),
                        torch.tensor(2 * radius, dtype=torch.float32))
    _same_grid(tg, jg)
    q = np.random.default_rng(1).random((64, 3)).astype(np.float32) * 3 - 1.5
    q[:4] = [[1e12, 0, 0], [-1e12, 5, 5], [9, -9, 9], [0, 0, 0]]   # outside
    rq = np.full(64, radius, np.float32)
    np.testing.assert_array_equal(
        thg.neighbor_cells(tg, _t(q), _t(rq)).numpy(),
        _np(jhg.neighbor_cells(jg, jnp.asarray(q), jnp.asarray(rq))))
    np.testing.assert_array_equal(thg.cell_of(tg, _t(q)).numpy(),
                                  _np(jhg.cell_of(jg, jnp.asarray(q))))
    cells = np.arange(-2, int(_np(jg.dims).prod()) + 2, dtype=np.int32)
    for a, b in zip(thg.query_ranges(tg, _t(cells)), jhg.query_ranges(jg, jnp.asarray(cells))):
        np.testing.assert_array_equal(a.numpy(), _np(b))

    def t_acc(carry, rows_, mask):
        return carry + mask.to(torch.float32).sum(1)

    def j_acc(carry, rows_, mask):
        return carry + jnp.sum(mask.astype(jnp.float32), axis=1)

    cnt = thg.gather_neighbors(tg, _t(q), _t(rq), t_acc, torch.zeros(64), max_per_cell=64)
    jcnt = jhg.gather_neighbors(jg, jnp.asarray(q), jnp.asarray(rq), j_acc,
                                jnp.zeros(64), max_per_cell=64)
    np.testing.assert_array_equal(cnt.numpy(), _np(jcnt))
    brute = ((np.linalg.norm(pos[valid][None] - q[:, None], axis=-1) <= radius).sum(1))
    np.testing.assert_array_equal(cnt.numpy().astype(int), brute)


def test_ball_and_beam_grids():
    pos, rows, valid = _photons(3000, seed=2, lo=-1.0, hi=1.0)
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    for radius in (0.004, 0.05, 0.3):    # cell from the extent, then from 2r
        jg = jdda.build_ball_grid(jnp.asarray(rows[:, :9]), jnp.asarray(pos),
                                  jnp.asarray(valid), jnp.float32(radius),
                                  jnp.asarray(lo), jnp.asarray(hi))
        tg = tdda.build_ball_grid(_t(rows[:, :9]), _t(pos), _t(valid),
                                  torch.tensor(radius), _t(lo), _t(hi))
        _same_grid(tg, jg)
    r = np.random.default_rng(4)
    beams = np.zeros((500, 16), np.float32)
    beams[:, 0:3] = r.uniform(-1, 1, (500, 3))
    d = r.normal(size=(500, 3))
    beams[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    beams[:, 6] = r.uniform(0, 1.5, 500)
    beams[:, 7:13] = r.random((500, 6))
    bvalid = r.random(500) < 0.9
    jb = jve.build_beam_cells(jnp.asarray(beams), jnp.asarray(bvalid), jnp.float32(0.05),
                              jnp.asarray(lo), jnp.asarray(hi))
    tb = tve.build_beam_cells(_t(beams), _t(bvalid), torch.tensor(0.05), _t(lo), _t(hi))
    _same_grid(tb, jb)


def test_dda_walk_early_exit_matches_full_trip():
    """tests/test_vol_estimators.py's early-exit case on the port, each
    budget's visits equal to the JAX walk's, rays that miss the grid
    included; the walk reads back one exit test per step, plus the last."""
    rng = np.random.default_rng(7)
    N, B = 512, 64
    pos = rng.random((N, 3), np.float32)
    data = np.concatenate([pos, rng.random((N, 9), np.float32)], 1)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    o = rng.random((B, 3), np.float32)
    o[:6] = [[5, 5, 5], [-3, 0.5, 0.5], [0.5, 7, 0.5], [2, 2, -2], [0.5, 0.5, 0.5],
             [0.2, 0.3, 0.4]]
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[:6] = [[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1], [1e-13, 1, 0]]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t1 = np.where(rng.random(B) < 0.3, 0.0, rng.random(B) * 3.0).astype(np.float32)
    t1[:6] = 10.0
    jg = jhg.build_grid(jnp.asarray(data), jnp.asarray(pos), jnp.ones(N, bool),
                        jnp.asarray(lo), jnp.asarray(hi), jnp.float32(0.125))
    tg = thg.build_grid(_t(data), _t(pos), torch.ones(N, dtype=torch.bool), _t(lo),
                        _t(hi), torch.tensor(0.125))
    _same_grid(tg, jg)

    def visit(hg, xp, grid):
        def f(carry, flat_cell, t_enter, t_exit, alive):
            s, cnt, cells = carry
            _, count = hg.query_ranges(grid, flat_cell)
            contrib = (t_exit - t_enter) * count.astype(xp.float32) if xp is jnp \
                else (t_exit - t_enter) * count.to(torch.float32)
            s = s + xp.where(alive, contrib, 0.0)
            cnt = cnt + (alive.astype(jnp.int32) if xp is jnp else alive.to(torch.int32))
            cells = cells + xp.where(alive, flat_cell + 1, 0)
            return s, cnt, cells
        return f

    res = {}
    for mc in (8, 256, 4096):
        jr = jdda.dda_walk(jg, jnp.asarray(o), jnp.asarray(d), jnp.zeros(B), jnp.asarray(t1),
                           visit(jhg, jnp, jg), (jnp.zeros(B), jnp.zeros(B, jnp.int32),
                                                 jnp.zeros(B, jnp.int32)), max_cells=mc)
        reads, steps = tdda.host_reads, tdda.iterations
        tr = tdda.dda_walk(tg, _t(o), _t(d), torch.zeros(B), _t(t1),
                           visit(thg, torch, tg),
                           (torch.zeros(B), torch.zeros(B, dtype=torch.int32),
                            torch.zeros(B, dtype=torch.int32)), max_cells=mc)
        n_steps = tdda.iterations - steps
        assert tdda.host_reads - reads == n_steps + (n_steps < mc)
        np.testing.assert_allclose(tr[0].numpy(), _np(jr[0]), **TOL)
        np.testing.assert_array_equal(tr[1].numpy(), _np(jr[1]))
        np.testing.assert_array_equal(tr[2].numpy(), _np(jr[2]))
        res[mc] = (tr, n_steps)
    np.testing.assert_array_equal(res[256][0][0].numpy(), res[4096][0][0].numpy())
    np.testing.assert_array_equal(res[256][0][1].numpy(), res[4096][0][1].numpy())
    assert res[256][1] == res[4096][1] < 256          # stopped early
    assert np.any(res[8][0][1].numpy() != res[256][0][1].numpy())
    dead = t1 == 0.0
    np.testing.assert_array_equal(res[256][0][1].numpy()[dead], 0)
    assert res[256][0][1].numpy()[0] == 0       # starts outside, moving away


def test_fog_cornell_pass_for_pass():
    """PPMTracer, default beamgrid, on fog_cornell 16x16, depth 4: the
    photon pass's rows and masks against the JAX pass's, then two passes
    of both tracers, with the counters."""
    jsc, tsc = jscenes.fog_cornell(16, 16).build(), tscenes.fog_cornell(16, 16).build("cpu")
    jtr = jppm.PPMTracer(jsc, 16, 16, max_depth=4)
    ttr = tppm.PPMTracer(tsc, 16, 16, max_depth=4)
    assert ttr.with_volume and ttr.vol_est == "beamgrid"
    jrows, jvalid = jtr._trace_jit(jsc, pass_idx=jnp.int32(0))
    trows, tvalid = tppm.trace_photons(tsc, 256, 0, 0x9907, 4, ttr.active_types,
                                       store_medium=True)
    np.testing.assert_array_equal(tvalid.numpy(), _np(jvalid))
    v = tvalid.numpy()
    np.testing.assert_allclose(trows.numpy()[v], _np(jrows)[v], rtol=1e-4, atol=1e-5)
    for i in range(2):
        jtr.do_pass()
        ttr.do_pass()
        assert _rel(ttr.develop().numpy(), _np(jtr.develop())) < 0.005
        np.testing.assert_array_equal(ttr.film.weight.numpy(), _np(jtr.film.weight))
        assert ttr.radius == jtr.radius
    js, ts = jtr.status(), ttr.status()
    assert ts["photons_emitted"] == js["photons_emitted"] == 512
    assert ts["photons_per_second"] > 0
    surf, med = ttr.photons_stored
    assert surf > 0 and med > 0 and ttr._stored_dev.dtype == torch.int64
    assert ttr._rays_dev.dtype == torch.int64 and ttr.rays_traced_live > 512
    assert ttr.last_pass_host_reads["tracking"] > 0 and ttr.last_pass_host_reads["dda"] > 0
    assert len(ttr.last_pass_dda_steps) == 4 and ttr.last_pass_dda_steps[0] > 0
    assert ttr.last_vol_grid["rows"] == 8 * 2 * 4 * 256


def test_one_beamgrid_route():
    """The port's render pass (ball grid built beside the eye pass) equals
    the eye pass on a prebuilt ball grid (tests/test_ppm.py's fused vs
    unfused case; eager PyTorch has one route)."""
    tsc = tscenes.fog_cornell(16, 16).build("cpu")
    tr = tppm.PPMTracer(tsc, 16, 16, max_depth=3)
    r, cell = tr.radius, torch.tensor(2.0 * tr.radius)
    rows, valid = tppm.trace_photons(tsc, 256, 0, 0x9907, 3, tr.active_types,
                                     store_medium=True)
    grid = tppm._build_surface_grid(rows, valid, tsc.world_lo, tsc.world_hi, cell)
    vol = tppm._build_vol_grid_ball(rows, valid, torch.tensor(r), tsc.world_lo,
                                    tsc.world_hi)
    f = tppm.eye_pass(tsc, tfilm.new_film(16, 16, "cpu"), grid, vol, 0, 16, 16, r,
                      256.0, 3, tr.active_types, with_volume=True)
    tr.do_pass()
    np.testing.assert_array_equal(tr.film.rgb.numpy(), f.rgb.numpy())


def test_ppm_golden():
    tr = tppm.PPMTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32, max_depth=4,
                        initial_radius=0.08)
    img = tr.render(6).numpy()
    ref = np.load(GOLDEN)["img"]
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.02, f"golden drift {rel:.4f}"
