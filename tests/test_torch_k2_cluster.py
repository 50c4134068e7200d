"""K2 on top tables over one block's shared memory, and P1's modes: the
pure-Python parts on the CPU.

- K2's variant rule (``ops/traversal_tt.top_variant``): a top table of up
  to 454 fat rows (an H100 block's 227 KB) takes the shared variant, a
  larger one the split variant; the probe's cluster design takes 2, 4 or
  8 blocks (``utils/schedule_probe.slab_variant``); K1 keeps its own
  rule.
- A top table over 454 rows, built on the CPU: the 800,000-triangle San
  Miguel stand-in split with 128-row treelets (568 rows), byte-identical
  between the port and the JAX package; on it, the port's plain K2
  (``top_visits``, the CUDA kernels' CPU path) against the JAX package's
  phase 1 (``_top_kernel`` through ``pl.pallas_call`` in interpret mode,
  as the JAX package's own tests run it) on 512 rays from the courtyard,
  closest / any-hit / mixed, V = 3 and 6. Comparison rules (ROADMAP queue
  3): integer outputs (visit keys, counts) bit for bit; t, entry t and the
  smallest dropped entry t within rtol 1e-5 / atol 1e-6; u, v within atol
  1e-5 (XLA's FMA contraction on the CPU against PyTorch's separate
  roundings); a closest-hit triangle may differ only where the two t agree
  to 1e-5; on any-hit lanes, hit against no-hit only.
- The wrappers refuse CPU tensors and unknown variants and count no
  launch; P1's argument checks and the chain floor's choice of reading
  (a node step's read, the lowest over the tables measured up to the
  call's size; the split design's staged and other rows apart).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cudatracerlib_tpu.ops import traversal_tt as jtt
from cudatracerlib_tpu.scene import native_bvh as jnative
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.ops import traversal8, traversal_tt
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.scene import native_bvh as tnative
from cudatracerlib_tpu_torch.scene import treelet
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import microbench as mb
from cudatracerlib_tpu_torch.utils import schedule_probe as probe

torch.set_num_threads(2)
H100_SHARED_OPTIN = 232448     # bytes a block may opt in to: 454 rows
N_RAYS = 512
MODES = ["closest", "any_hit", "mixed"]


@pytest.mark.parametrize("rows,variant", [
    (240, ("shared", 1)), (433, ("shared", 1)), (454, ("shared", 1)),
    (455, ("split", 2)), (908, ("split", 2)), (909, ("split", 4)),
    (998, ("split", 4)), (2048, ("split", 8))])
def test_top_variant_rule(rows, variant):
    """(K2's variant, the probe's cluster design's blocks) by top rows."""
    assert traversal_tt.top_variant(rows, H100_SHARED_OPTIN) == variant[0]
    assert probe.slab_variant(rows, H100_SHARED_OPTIN) == variant[1]


def test_k1_keeps_its_rule():
    """cornell.xml's 612-row table keeps K1's per-table rule (the global
    variant, one thread per ray); a top at the partition's cap takes the
    split variant, and 8 blocks in the probe's cluster design; no cluster
    of 8 blocks holds a larger one."""
    assert traversal8.table_variant(612, H100_SHARED_OPTIN) == "global"
    assert traversal_tt.top_variant(treelet.MAX_TOP_ROWS, H100_SHARED_OPTIN) == "split"
    assert probe.slab_variant(treelet.MAX_TOP_ROWS, H100_SHARED_OPTIN) == 8
    assert probe.slab_variant(8 * 454 + 1, H100_SHARED_OPTIN) == 0


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.fixture(scope="module")
def big_top(tmp_path_factory):
    """The 800,000-triangle stand-in built by both packages (the JAX
    build's disk caches bypassed, its native builder the library the port
    compiled from the same source), each table split with 128-row
    treelets."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_load", tnative._load)
    cache = str(tmp_path_factory.mktemp("bvh") / "bvh8.npz")
    mp.setattr(jnative, "_build_cache_path", lambda v0, v1, v2: cache)
    mp.setattr(jtreelet, "partition_cached",
               lambda table, **kw: jtreelet.partition(table, **kw))
    try:
        tsc = tscenes.san_miguel_stand_in(32, 32, target_tris=800_000).build("cpu")
        jsc = jscenes.san_miguel_stand_in(32, 32, target_tris=800_000).build()
    finally:
        mp.undo()
    wide, jwide = tsc.geom.wide.numpy(), np.asarray(jsc.geom.wide)
    part = treelet.partition(wide, treelet_rows=128)
    jpart = jtreelet.partition(jwide, treelet_rows=128)
    r = np.random.default_rng(21)
    o = r.uniform([-16, 0.3, -10], [16, 5, 10], (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (o, d, np.full(N_RAYS, 1e-4, np.float32), np.full(N_RAYS, 1e9, np.float32))
    return dict(wide=wide, jwide=jwide, part=part, jpart=jpart, rays=rays,
                amask=r.random(N_RAYS) < 0.5, jtop=jnp.asarray(jtreelet.prep_device(jpart)[0]))


def test_big_top_byte_identical(big_top):
    s = big_top
    np.testing.assert_array_equal(bits(s["wide"]), bits(s["jwide"]))
    p, j = s["part"], s["jpart"]
    np.testing.assert_array_equal(bits(p.top), bits(j.top))
    np.testing.assert_array_equal(bits(p.slabs), bits(j.slabs))
    np.testing.assert_array_equal(p.vid_map, j.vid_map)
    assert p.top.shape[0] > H100_SHARED_OPTIN // 512
    assert traversal_tt.top_variant(p.top.shape[0], H100_SHARED_OPTIN) == "split"
    assert probe.slab_variant(p.top.shape[0], H100_SHARED_OPTIN) == 2


@partial(jax.jit, static_argnames=("V", "any_hit"))
def _jax_phase1(top_t, o, d, tmin, tmax, any_mask, V, any_hit):
    """The JAX package's phase 1 alone, as its intersect_treelet launches
    it (interpret mode on the CPU): (t, tri, u, v, visit keys (N, V),
    entry ts (N, V), visit counts, smallest dropped entry t)."""
    K, G, LANES = jtt.DEFAULT_K, jtt.DEFAULT_G, jtt.LANES
    n_top = top_t.shape[1]
    N = o.shape[0]
    block = K * G * LANES
    Np = -(-N // block) * block
    r0 = jnp.zeros(N, jnp.int32)
    if any_mask is not None:
        r0 = jnp.where(any_mask, ~r0, r0)
    attrs = jtt._pack_attrs(o, d, tmin, tmax, r0, Np)
    B1 = Np // K
    attrs = attrs.reshape(12, K, B1)
    kern = partial(jtt._top_kernel, n_slabs=n_top // LANES, n_top=n_top,
                   any_hit=any_hit, K=K, G=G, V=V, max_iters=4096)
    out1, vis, vist = pl.pallas_call(
        kern, grid=(B1 // (G * LANES),),
        out_shape=(jax.ShapeDtypeStruct((5, K, B1), jnp.float32),
                   jax.ShapeDtypeStruct((K * V + K, B1), jnp.int32),
                   jax.ShapeDtypeStruct((K * V + K, B1), jnp.float32)),
        in_specs=[pl.BlockSpec((128, n_top), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((12, K, G * LANES), lambda i: (0, 0, i),
                               memory_space=pltpu.VMEM)],
        out_specs=(pl.BlockSpec((5, K, G * LANES), lambda i: (0, 0, i),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((K * V + K, G * LANES), lambda i: (0, i),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((K * V + K, G * LANES), lambda i: (0, i),
                                memory_space=pltpu.VMEM)),
        interpret=True)(top_t, attrs)
    per_ray = lambda x: x.reshape(Np)[:N]
    per_visit = lambda x: x.reshape(K, V, B1).transpose(0, 2, 1).reshape(Np, V)[:N]
    return (per_ray(out1[0]), jtt._i32(per_ray(out1[1])), per_ray(out1[2]),
            per_ray(out1[3]), per_visit(vis[:K * V]), per_visit(vist[:K * V]),
            per_ray(vis[K * V:]), per_ray(vist[K * V:]))


@pytest.mark.parametrize("V", [6, 3])
@pytest.mark.parametrize("mode", MODES)
def test_plain_k2_matches_jax_phase1(big_top, mode, V):
    s = big_top
    o, d, tmin, tmax = s["rays"]
    any_hit, amask = mode == "any_hit", s["amask"] if mode == "mixed" else None
    jt, jtri, ju, jv, jvids, jvent, jvcnt, jmdrop = (np.asarray(x) for x in _jax_phase1(
        s["jtop"], *(jnp.asarray(x) for x in (o, d, tmin, tmax)),
        None if amask is None else jnp.asarray(amask), V=V, any_hit=any_hit))
    kw = dict(any_hit=True) if any_hit else {} if amask is None else \
        dict(any_mask=torch.from_numpy(amask))
    hit, vids, vent, vcnt, mdrop, steps, flags = traversal_tt.top_visits(
        torch.from_numpy(s["part"].top), Rays(*(torch.from_numpy(x) for x in s["rays"])),
        V, **kw)
    # JAX's virtual ids count from its padded top; the keys are the same
    # packed (treelet id << 14 | root) values
    np.testing.assert_array_equal(vcnt.numpy(), jvcnt)
    kept = np.arange(V)[None, :] < np.minimum(jvcnt, V)[:, None]
    np.testing.assert_array_equal(np.where(kept, vids.numpy(), -1),
                                  np.where(kept, jvids, -1))
    np.testing.assert_allclose(np.where(kept, vent.numpy(), 0), np.where(kept, jvent, 0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mdrop.numpy(), jmdrop, rtol=1e-5, atol=1e-6)
    any_lane = np.full(N_RAYS, any_hit) if amask is None else amask
    tri = hit.tri.numpy()
    np.testing.assert_array_equal(tri >= 0, jtri >= 0)
    cl = ~any_lane
    np.testing.assert_allclose(hit.t.numpy()[cl], jt[cl], rtol=1e-5, atol=1e-6)
    differ = cl & (tri != jtri)
    assert np.all(np.abs(hit.t.numpy()[differ] - jt[differ]) <= 1e-5 * np.abs(jt[differ]))
    same = cl & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(hit.u.numpy()[same], ju[same], atol=1e-5)
    np.testing.assert_allclose(hit.v.numpy()[same], jv[same], atol=1e-5)
    assert int(vcnt.sum()) > 0 and int(flags.sum()) == 0 and int(steps.min()) >= 1
    if mode == "closest":
        assert int((vcnt > V).sum()) > 0     # the budget drops visits here


def test_k2_wrapper_refusals():
    """The wrapper and the probe refuse CPU tensors and an unknown variant,
    design or cluster size, and count no launch for them."""
    K2 = traversal_tt.top_visits_cuda
    top = torch.zeros(4, 128)
    rays = Rays(torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2), torch.ones(2))
    before = (K2.launches, dict(K2.launches_by_variant), dict(K2.launches_by_v))
    for kw in ({}, dict(_variant="split"), dict(_variant="texture"),
               dict(_variant="global")):
        with pytest.raises(ValueError):
            K2(top, rays, 3, **kw)
    for variant in ("texture", "global", "cluster"):
        with pytest.raises(ValueError):
            traversal_tt.launch_top_variant(top, variant)
    for args in (("cluster",), ("cluster", 4), ("walk",), ("cluster", 3),
                 ("stride", 2), ("global",), ("global", 2)):
        with pytest.raises(ValueError):
            probe.top_visits(top, rays, 3, *args)
    assert (K2.launches, K2.launches_by_variant, K2.launches_by_v) == before
    assert set(K2.launches_by_variant) == {"shared", "split"}
    assert traversal_tt.launch_top_variant(top, "split") == "split"


# P1's checks: (mode, param, lanes, threads, rows, the filled (param,
# lanes) or the error)
@pytest.mark.parametrize("mode,param,lanes,threads,rows,want", [
    ("thread", None, None, 128, 211592, (0, 1)),
    ("shared", None, None, 128, 454, (0, 1)),
    ("shared", None, None, 128, 455, ValueError),
    ("group", None, None, 128, 998, (16, 16)),
    ("group", 8, 32, 32, 998, (8, 32)),
    ("group", 12, None, 128, 998, ValueError),
    ("group", 16, 8, 128, 998, ValueError),
    ("cluster", None, None, 128, 998, (4, 1)),
    ("cluster", 2, 32, 32, 908, (2, 32)),
    ("cluster", 2, None, 128, 909, ValueError),
    ("cluster", 3, None, 128, 100, ValueError),
    ("cluster", None, None, 128, 8 * 454 + 1, ValueError),
    ("bulk", None, None, 64, 211592, (0, 1)),
    ("bulk", None, 3, 128, 331, ValueError),
    ("thread", None, None, 256, 331, ValueError),
    ("thread", None, None, 48, 331, ValueError),
    ("texture", None, None, 128, 331, ValueError)])
def test_p1_checks(mode, param, lanes, threads, rows, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            mb.check_chase(mode, param, lanes, threads, rows, H100_SHARED_OPTIN)
    else:
        assert mb.check_chase(mode, param, lanes, threads, rows, H100_SHARED_OPTIN) == want


@pytest.mark.parametrize("words,ok", [(14, True), (32, True), (13, False), (16, False)])
def test_p1_read_width(words, ok):
    """A P1 step reads a node step's 14 float4 or the whole row's 32."""
    if ok:
        assert mb.check_chase("group", None, None, 128, 998, H100_SHARED_OPTIN,
                              words) == (16, 16)
    else:
        with pytest.raises(ValueError, match="float4"):
            mb.check_chase("thread", None, None, 128, 998, H100_SHARED_OPTIN, words)


def test_p1_wrapper_refuses_cpu_tensors():
    table = torch.zeros(8, 128)
    before = (mb.chase_rows_cuda.launches, dict(mb.chase_rows_cuda.launches_by_mode))
    for mode in mb.CHASE_MODES:
        with pytest.raises(ValueError):
            mb.chase_rows_cuda(table, torch.zeros(4, dtype=torch.int32), 3, mode)
    assert (mb.chase_rows_cuda.launches, mb.chase_rows_cuda.launches_by_mode) == before


def _entry(rows, mode, param, occupancy, ns, words=mb.NODE_WORDS):
    return dict(rows=rows, mode=mode, param=param, occupancy=occupancy,
                ns_per_dependent_row=ns, words=words)


P1_ENTRIES = [
    _entry(256, "thread", 0, "warp", 650.0), _entry(256, "thread", 0, "warp", 100.0, 32),
    _entry(331, "thread", 0, "warp", 600.0), _entry(998, "thread", 0, "warp", 610.0),
    _entry(211592, "thread", 0, "warp", 900.0), _entry(331, "thread", 0, "chains", 1300.0),
    _entry(331, "group", 16, "warp", 500.0), _entry(211592, "group", 16, "warp", 800.0),
    _entry(331, "shared", 0, "warp", 60.0),
    _entry(331, "cluster", 2, "warp", 250.0), _entry(998, "cluster", 4, "warp", 260.0),
    _entry(998, "cluster", 8, "warp", 255.0), _entry(331, "cluster", 4, "warp", 240.0)]


# (design, rows, blocks, the chosen entry's (rows, mode, param)): a node
# step's read, the lowest over the tables measured up to the call's rows
# (the smallest measured table where none is that small)
@pytest.mark.parametrize("design,rows,blocks,want", [
    ("thread", 211592, None, (331, "thread", 0)),
    ("thread", 1057031, None, (331, "thread", 0)),
    ("thread", 612, None, (331, "thread", 0)),
    ("thread", 100, None, (256, "thread", 0)),
    ("global", 998, None, (331, "thread", 0)),
    ("group", 211592, None, (331, "group", 16)),
    ("group", 63492, None, (331, "group", 16)),
    ("shared", 240, None, (331, "shared", 0)),
    ("split", 998, None, (331, "shared", 0)),
    ("cluster", 998, 4, (331, "cluster", 4)),
    ("cluster", 998, 8, (998, "cluster", 8)),
    ("cluster", 998, 2, (331, "cluster", 2)),
    ("cluster", 998, None, (331, "cluster", 4)),
    ("cluster", 568, 2, (331, "cluster", 2))])
def test_chain_floor_reading(design, rows, blocks, want):
    e = mb.floor_entry(P1_ENTRIES, design, rows, blocks)
    assert (e["rows"], e["mode"], e["param"]) == want
    assert e["occupancy"] == "warp" and e["words"] == mb.NODE_WORDS


def test_chain_floor_unmeasured_mode():
    assert mb.floor_entry([e for e in P1_ENTRIES if e["mode"] != "group"],
                          "group", 211592) is None
    assert set(mb.DESIGN_READS) >= {"thread", "group", "shared", "cluster",
                                    "global", "split"}
    # the whole row's reading only where it is asked for
    e = mb.floor_entry(P1_ENTRIES, "thread", 998, words=mb.ROW_WORDS)
    assert (e["rows"], e["ns_per_dependent_row"]) == (256, 100.0)


@pytest.mark.parametrize("near_far,want", [
    ([(10, 0), (4, 3), (0, 5)], 5 * 600.0),
    ([(30, 0), (1, 2)], 30 * 60.0),
    ([(12, 2)], 12 * 60.0 + 2 * 600.0),
    ([], None)])
def test_split_floor(near_far, want):
    """The split design's floor: a lane's reads of its staged rows at the
    shared reading (60 ns), of the others at the thread reading (600 ns),
    the most over the lanes."""
    ms, entries = mb.split_floor(P1_ENTRIES, 998, near_far)
    if want is None:
        assert (ms, entries) == (None, None)
        return
    assert ms == pytest.approx(want / 1e6)
    assert [e["mode"] for e in entries] == ["shared", "thread"]
    assert mb.split_floor([e for e in P1_ENTRIES if e["mode"] != "shared"], 998,
                          near_far) == (None, None)
