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
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.scene import native_bvh as tnative
from cudatracerlib_tpu_torch.scene import treelet
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import schedule_probe as probe

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


@pytest.mark.parametrize("scene", ["cornell_split", "san_miguel"])
def test_top_table_variant_rule(setup, scene, monkeypatch, tmp_path):
    """K2's variant follows the top table's size, by its own rule
    (``traversal_tt.top_variant``): the top tables of the split Cornell
    box (this file's split) and of the 20,000-triangle San Miguel stand-in
    fit an H100 block's shared memory (at full size San Miguel's top has
    240 rows); a top table at the partition's cap (2,048 rows) does not,
    and takes the split variant, as K1's rule would take its global
    variant."""
    if scene == "cornell_split":
        top = setup["part"].top
    else:
        top = tscenes.san_miguel_stand_in(32, 32, target_tris=20000) \
            .build("cpu").geom.tt_top
    assert 1 <= top.shape[0] <= 454
    assert traversal8.table_variant(top.shape[0], 232448) == "shared"
    assert traversal8.table_variant(treelet.MAX_TOP_ROWS, 232448) == "global"
    assert traversal_tt.top_variant(top.shape[0], 232448) == "shared"
    assert traversal_tt.top_variant(treelet.MAX_TOP_ROWS, 232448) == "split"


def test_kernel_wrappers_reject_cpu_tensors(setup):
    s = setup
    with pytest.raises(ValueError):
        traversal_tt.top_visits_cuda(s["top"], s["tr"], 3)
    keys = torch.zeros(N_RAYS * 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        traversal_tt.treelet_hits_cuda(s["slabs"], s["tr"], s["tr"].tmax, keys,
                                       keys, 3)
    assert traversal_tt.top_visits_cuda.launches == 0
    assert set(traversal_tt.top_visits_cuda.launches_by_variant.values()) == {0}
    assert traversal_tt.treelet_hits_cuda.launches == 0


# the probe's cluster design: blocks per cluster from the slab's rows
# against an H100's opt-in limit (232,448 bytes, 454 rows a block):
# (rows, cluster_max, blocks; 0 when no cluster holds the slab)
@pytest.mark.parametrize("rows,cluster_max,blocks", [
    (128, 8, 1), (454, 8, 1), (455, 8, 2), (512, 8, 2), (908, 8, 2),
    (909, 8, 4), (1024, 8, 4), (2048, 8, 8), (8 * 454, 8, 8),
    (8 * 454 + 1, 8, 0), (4096, 8, 0), (2048, 4, 0)])
def test_slab_variant_rule(rows, cluster_max, blocks):
    assert probe.slab_variant(rows, 232448, cluster_max) == blocks


@pytest.fixture(scope="module")
def sm_slots():
    """The 20,000-triangle San Miguel stand-in at 32x32 and phase 2's
    inputs for its camera rays at V=3, from the plain phase 1."""
    sc = tscenes.san_miguel_stand_in(32, 32, target_tris=20000).build("cpu")
    pix = torch.arange(1024, dtype=torch.int32)
    rays = ttracer.gen_camera_rays(sc, pix, 0, 0, 32, 32)[0]
    hit1, vids, _, vcnt, _, _, _ = traversal_tt.top_visits(sc.geom.tt_top, rays, 3)
    n_tt = sc.geom.tt_slabs.shape[0]
    valid, keys, order, _ = traversal_tt.visit_slots(
        hit1, vids, vcnt, n_tt, torch.zeros(1024, dtype=torch.bool))
    return dict(slabs=sc.geom.tt_slabs, keys=keys, n_tt=n_tt,
                n_valid=int(valid.sum()))


def test_slab_variant_on_san_miguel_slabs(sm_slots):
    """The stand-in's slabs have 512 rows, as at full size: the cluster
    design spreads one over 2 blocks; re-split into 1,024-row slabs over
    4; the whole 2,389-row table would need 8 blocks of 299 rows."""
    rows = sm_slots["slabs"].shape[1]
    assert rows == 512
    assert probe.slab_variant(rows, 232448) == 2
    assert probe.slab_variant(2 * rows, 232448) == 4
    assert probe.slab_variant(2389, 232448) == 8


@pytest.mark.parametrize("chunk,min_stage", [(64, 8), (256, 100), (4096, 1),
                                             (4096, 4096)])
def test_treelet_segments_model(sm_slots, chunk, min_stage):
    """The plain model of the K3 designs' work split, on the sorted keys of
    the stand-in's slots: every valid slot lies in exactly one segment, no
    invalid slot in any; a segment is one treelet's run within one chunk;
    the staged count follows the rule, counted here by a loop."""
    keys, n_tt = sm_slots["keys"], sm_slots["n_tt"]
    start, end, tid, staged = probe.treelet_segments(keys, n_tt, chunk,
                                                     min_stage)
    S = keys.shape[0]
    cover = torch.zeros(S, dtype=torch.int64)
    for a, b in zip(start.tolist(), end.tolist()):
        assert a < b and a // chunk == (b - 1) // chunk
        cover[a:b] += 1
    slot_tid = keys.long() >> 14
    valid = slot_tid < n_tt
    assert int(valid.sum()) == sm_slots["n_valid"] > 0
    assert torch.equal(cover, valid.long())
    for a, b, t in zip(start.tolist(), end.tolist(), tid.tolist()):
        assert bool((slot_tid[a:b] == t).all())
    runs = []   # (chunk, tid, length) of the valid runs, by a plain loop
    for i, t in enumerate(slot_tid.tolist()):
        if t >= n_tt:
            continue
        if runs and tuple(runs[-1][:2]) == (i // chunk, t):
            runs[-1][2] += 1
        else:
            runs.append([i // chunk, t, 1])
    assert len(runs) == start.shape[0]
    assert int(staged.sum()) == sum(n >= min_stage for _, _, n in runs)
    assert torch.equal(staged, (end - start) >= min_stage)


def test_k3_wrappers_raise(sm_slots):
    """K3's wrapper and the probe's raise on CPU tensors and on a V K3 is
    not built for, and the probe on an unknown design, before any launch
    or build."""
    slabs, keys = sm_slots["slabs"], sm_slots["keys"]
    rays = Rays(o=torch.zeros(1024, 3), d=torch.ones(1024, 3),
                tmin=torch.zeros(1024), tmax=torch.ones(1024))
    order = torch.arange(keys.shape[0], dtype=torch.int32)
    tp = torch.ones(1024)
    with pytest.raises(ValueError, match="CUDA"):
        traversal_tt.treelet_hits_cuda(slabs, rays, tp, keys, order, 3)
    with pytest.raises(ValueError, match="V in"):
        traversal_tt.treelet_hits_cuda(slabs, rays, tp, keys, order, 4)
    for design in probe.K3_DESIGNS:
        with pytest.raises(ValueError, match="CUDA"):
            probe.treelet_hits(slabs, rays, tp, keys, order, 3, design)
    with pytest.raises(ValueError, match="V in"):
        probe.treelet_hits(slabs, rays, tp, keys, order, 4, "cluster")
    with pytest.raises(ValueError, match="no K3 design"):
        probe.treelet_hits(slabs, rays, tp, keys, order, 3, "global")
    assert traversal_tt.treelet_hits_cuda.launches == 0
