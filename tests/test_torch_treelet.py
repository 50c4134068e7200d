"""The port's treelet split and two-phase traversal against the JAX package's.

The partition is numpy on both sides and must be byte-identical. The
traversal runs the port's plain versions of K2 and K3 (the CUDA kernels'
CPU path) against the JAX ``intersect_treelet``, whose two Pallas kernels
run in interpret mode on the CPU, and the port's exact path (with its K1
fallback) against the JAX single-table loop ``intersect_wide``.

Inputs: the Cornell box at 64x64, split with treelet_rows=128 and
max_top_rows=256 (as tests/test_treelet.py does), and 2,048 camera rays
(every other pixel), made once by the port and handed to both as numpy.
Comparison rules (ROADMAP queue 3): integer outputs bit for bit; t within
rtol 1e-5 / atol 1e-6 and u, v within atol 1e-5 (XLA's FMA contraction on
the CPU against PyTorch's separate roundings); a closest-hit triangle may
differ only where the two t agree to 1e-5 (a tie between triangles); on
any-hit lanes, hit against no-hit only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.ops import traversal as jtrav
from cudatracerlib_tpu.ops import traversal8 as jtrav8
from cudatracerlib_tpu.ops import traversal_tt as jtt
from cudatracerlib_tpu.scene import native_bvh as jnative
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import tracer as ttracer
from cudatracerlib_tpu_torch.ops import traversal8, traversal_tt
from cudatracerlib_tpu_torch.scene import native_bvh as tnative
from cudatracerlib_tpu_torch.scene import treelet
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
N_RAYS = 2048
MODES = ["closest", "any_hit", "mixed"]


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def assert_partitions_equal(p, j):
    np.testing.assert_array_equal(bits(p.top), bits(j.top))
    np.testing.assert_array_equal(bits(p.slabs), bits(j.slabs))
    np.testing.assert_array_equal(p.vid_map, j.vid_map)
    np.testing.assert_array_equal(p.root_top, j.root_top)
    assert (p.n_treelets, p.treelet_rows) == (j.n_treelets, j.treelet_rows)


@pytest.fixture(scope="module")
def setup():
    tsc = tscenes.cornell_box(64, 64).build("cpu")
    jsc = jscenes.cornell_box(64, 64).build()
    kw = dict(treelet_rows=128, max_top_rows=256)
    part = treelet.partition(tsc.geom.wide.numpy(), **kw)
    jpart = jtreelet.partition(np.asarray(jsc.geom.wide), **kw)
    top_t, slabs_t = jtreelet.prep_device(jpart)
    pix = torch.arange(N_RAYS, dtype=torch.int32) * 2
    tr = ttracer.gen_camera_rays(tsc, pix, 0, 0, 64, 64)[0]
    jr = jtrav.Rays(*(jnp.asarray(x.numpy()) for x in tr))
    amask = np.random.default_rng(5).random(N_RAYS) < 0.5
    return dict(tsc=tsc, jsc=jsc, part=part, jpart=jpart, tr=tr, jr=jr,
                amask=amask, top=torch.from_numpy(part.top),
                slabs=torch.from_numpy(part.slabs),
                jtop=jnp.asarray(top_t), jslabs=jnp.asarray(slabs_t),
                jvid=jnp.asarray(jpart.vid_map), jref={})


def _kw(mode, amask, lib):
    if mode == "any_hit":
        return dict(any_hit=True)
    if mode == "mixed":
        return dict(any_mask=jnp.asarray(amask) if lib == "jax" else torch.from_numpy(amask))
    return {}


def _any_lanes(mode, amask):
    return (np.ones(N_RAYS, bool) if mode == "any_hit"
            else amask if mode == "mixed" else np.zeros(N_RAYS, bool))


def _check_hits(port, ref, any_lane):
    p_tri, r_tri = port.tri.numpy(), np.asarray(ref.tri)
    np.testing.assert_array_equal(p_tri >= 0, r_tri >= 0)
    cl = ~any_lane
    p_t, r_t = port.t.numpy(), np.asarray(ref.t)
    np.testing.assert_allclose(p_t[cl], r_t[cl], rtol=1e-5, atol=1e-6)
    differ = cl & (p_tri != r_tri)
    assert np.all(np.abs(p_t[differ] - r_t[differ]) <= 1e-5 * np.abs(r_t[differ]))
    same = cl & (p_tri == r_tri) & (p_tri >= 0)
    np.testing.assert_allclose(port.u.numpy()[same], np.asarray(ref.u)[same], atol=1e-5)
    np.testing.assert_allclose(port.v.numpy()[same], np.asarray(ref.v)[same], atol=1e-5)
    return int(differ.sum())


def test_partition_byte_identical_cornell(setup):
    s = setup
    assert_partitions_equal(s["part"], s["jpart"])
    assert s["part"].n_treelets > 1 and s["part"].top.shape[0] > 1
    # the JAX device layout converts back to the port's
    top, slabs = treelet.from_jax_layout(np.asarray(s["jtop"]), np.asarray(s["jslabs"]))
    np.testing.assert_array_equal(bits(top), bits(s["part"].top))
    np.testing.assert_array_equal(bits(slabs), bits(s["part"].slabs))
    # a table within the top-table cap is not split
    assert treelet.partition(s["tsc"].geom.wide.numpy()) is None


def test_partition_byte_identical_san_miguel(monkeypatch, tmp_path):
    # the JAX build's caches bypassed; its native builder runs the library
    # the port compiled from the same source (no racing `make` into native/)
    monkeypatch.setattr(jnative, "_load", tnative._load)
    monkeypatch.setattr(jnative, "_build_cache_path",
                        lambda v0, v1, v2: str(tmp_path / "bvh8.npz"))
    monkeypatch.setattr(jtreelet, "partition_cached",
                        lambda table, **kw: jtreelet.partition(table, **kw))
    jsc = jscenes.san_miguel_stand_in(32, 32, target_tris=20000).build()
    wide = np.asarray(jsc.geom.wide)
    assert wide.shape[0] == 2389
    part = treelet.partition(wide)
    assert_partitions_equal(part, jtreelet.partition(wide))
    # 6 slabs and a one-row top (the JAX device layout pads the top to 128
    # rows and appends an inert pad slab: 7 slabs)
    assert part.slabs.shape == (6, 512, 128) and part.top.shape == (1, 128)
    top_t, slabs_t = jtreelet.prep_device(part)
    assert top_t.shape == (128, 128) and slabs_t.shape == (7, 128, 512)


@pytest.mark.parametrize("V", [6, 3, 1])
@pytest.mark.parametrize("mode", MODES)
def test_treelet_traversal_matches_jax(setup, mode, V):
    s = setup
    any_lane = _any_lanes(mode, s["amask"])
    hit, ovf = traversal_tt.intersect_treelet(
        s["top"], s["slabs"], s["tr"], V=V, with_overflow=True,
        **_kw(mode, s["amask"], "torch"))
    jhit, jovf = jtt.intersect_treelet(
        s["jtop"], s["jslabs"], s["jvid"], s["jr"], V=V, with_overflow=True,
        **_kw(mode, s["amask"], "jax"))
    _check_hits(hit, jhit, any_lane)
    # the overflow gate compares the smallest dropped slab-entry t with the
    # hit t; a wall lying on a box face makes the two equal, and then the
    # last ulp decides: the masks may differ only on such lanes
    mdrop = traversal_tt.top_visits(s["top"], s["tr"], V,
                                    **_kw(mode, s["amask"], "torch"))[4].numpy()
    flip = ovf.numpy() != np.asarray(jovf)
    t = hit.t.numpy()
    assert np.all(np.abs(mdrop[flip] - t[flip]) <= 1e-5 * np.abs(t[flip])), \
        (mdrop[flip], t[flip])
    assert flip.sum() <= 4
    if V == 1 and mode != "any_hit":
        assert int(ovf.sum()) > 0          # V=1 forces the fallback

    # the exact path (treelet + K1 fallback) against the JAX single-table loop
    if mode not in s["jref"]:
        s["jref"][mode] = jtrav8.intersect_wide(
            s["jsc"].geom.wide, s["jr"], **_kw(mode, s["amask"], "jax"))
    geom = s["tsc"].geom._replace(tt_top=s["top"], tt_slabs=s["slabs"],
                                  tt_vid=torch.from_numpy(s["part"].vid_map))
    ex, iters, rows, flags = traversal8.intersect_treelet_exact(
        geom, s["tr"], coherent=False, with_iters=True,
        **_kw(mode, s["amask"], "torch"))
    ties = _check_hits(ex, s["jref"][mode], any_lane)
    assert ties <= 2
    assert flags.tolist() == [0, 0] and int(iters) == int(rows) > N_RAYS


@pytest.mark.parametrize("V", [3, 1])
def test_count_dropped_visits_matches_jax(setup, V):
    s = setup
    total, dropped = traversal_tt.count_dropped_visits(s["top"], s["tr"], V=V)
    jtotal, jdropped = jtt.count_dropped_visits(
        s["jtop"], s["jpart"].n_treelets, s["jr"], V=V)
    assert (int(total), int(dropped)) == (int(jtotal), int(jdropped))
    assert total.dtype == torch.int64 and int(total) > 0
    if V == 1:
        assert int(dropped) > 0


def test_phase1_keeps_the_nearest_visits(setup):
    """K2's plain version keeps each ray's V nearest visits by entry t: the
    kept entries are the V smallest of all the ray's visits (from a run
    with room for every visit), and min-dropped is the next one."""
    s = setup
    _, vids8, vent8, vcnt8, _, _, _ = traversal_tt.top_visits(s["top"], s["tr"], V=8)
    assert int(vcnt8.max()) <= 8
    _, vids, vent, vcnt, mdrop, _, _ = traversal_tt.top_visits(s["top"], s["tr"], V=2)
    torch.testing.assert_close(vcnt, vcnt8, rtol=0, atol=0)
    allt = torch.where(torch.arange(8)[None] < vcnt8[:, None], vent8, float("inf"))
    srt = allt.sort(dim=1).values
    kept = torch.where(torch.arange(2)[None] < vcnt[:, None], vent, float("inf"))
    torch.testing.assert_close(kept.sort(dim=1).values, srt[:, :2], rtol=0, atol=0)
    torch.testing.assert_close(mdrop, srt[:, 2], rtol=0, atol=0)
    # every kept id is one of the ray's visits
    many = vcnt >= 2
    assert bool((vids[many][:, :, None] == vids8[many][:, None, :]).any(-1).all())


def test_flags_of_the_plain_phases(setup):
    s = setup
    _, _, _, _, _, steps, flags = traversal_tt.top_visits(s["top"], s["tr"], V=3)
    assert int(flags.sum()) == 0
    cap = int(steps.max()) - 1
    _, _, _, _, _, steps_c, flags_c = traversal_tt.top_visits(
        s["top"], s["tr"], V=3, max_iters=cap)
    capped = (flags_c & traversal8.FLAG_CAPPED) != 0
    assert torch.equal(capped, steps > cap) and int(steps_c.max()) == cap
    hit1, vids, _, vcnt, _, _, _ = traversal_tt.top_visits(s["top"], s["tr"], V=3)
    valid, keys, order, t_prune = traversal_tt.visit_slots(
        hit1, vids, vcnt, s["part"].n_treelets,
        torch.zeros(N_RAYS, dtype=torch.bool))
    _, st, fl = traversal_tt.treelet_hits(s["slabs"], s["tr"], t_prune, keys,
                                          order, 3, stack_depth=1)
    assert int(((fl & traversal8.FLAG_OVERFLOW) != 0).sum()) > 0
    # invalid slots do not run
    assert int(st.reshape(N_RAYS, 3)[~valid].sum()) == 0


def test_kernel_wrappers_reject_cpu_tensors(setup):
    s = setup
    with pytest.raises(ValueError):
        traversal_tt.top_visits_cuda(s["top"], s["tr"], 3)
    keys = torch.zeros(N_RAYS * 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        traversal_tt.treelet_hits_cuda(s["slabs"], s["tr"], s["tr"].tmax, keys,
                                       keys, 3)
    assert traversal_tt.top_visits_cuda.launches == 0
    assert traversal_tt.treelet_hits_cuda.launches == 0
