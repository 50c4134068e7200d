"""K1's global variant in its group design (csrc/traversal8.cu), on the CPU:
the rules it rests on, proven on the plain version ``intersect_wide``,
which stays the spec, and on the JAX package's ``intersect_wide``.

The group design writes a dead lane's outputs without reading the table
and traverses the live lanes from a queue. A lane is dead when
!(tmin <= tmax) (a NaN included), it starts on a node row and max_iters >= 1
(``traversal8.live_lanes`` is the plain model of the queue: the lanes it
holds). Such a lane takes one step in the plain version and ends with
t = tmax, tri -1, u = v = 0, one step, no flag, whatever the table. A lane
with tmin = tmax may descend the boxes that hold its origin, so it is
live: the counterexample below takes more than one step.

Inputs: the 20,000-triangle San Miguel stand-in's unsplit table (32x32;
2,389 rows, the global variant by the size rule), 4,096+513 rays from a
seed with numpy, origins in the scene's box, each case in the three modes
(closest, any-hit, mixed). The wrapper's checks of the internal `_design`
argument run before any device is touched, and the flat treelet fallback
asks for the group design on a CUDA table, the instanced one (per-lane
roots) for none (its call recorded here on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.ops import traversal as jtrav
from cudatracerlib_tpu.ops import traversal8 as jtrav8
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import schedule_probe

torch.set_num_threads(2)
N_RAYS = 4096 + 513
MODES = ["closest", "any_hit", "mixed"]
CASES = ["tmax_minus_1", "nan", "roots"]


@pytest.fixture(scope="module")
def sm():
    r = np.random.default_rng(21)
    o = r.uniform([-16, 0.3, -10], [16, 5, 10], (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sc = tscenes.san_miguel_stand_in(32, 32, target_tris=20000).build("cpu")
    table = sc.geom.wide
    links = table[0, 48:56].contiguous().view(torch.int32)
    starts = np.concatenate([[0], links[links >= 0].numpy()]).astype(np.int32)
    return dict(sc=sc, table=table, o=o, d=d, rng=r, starts=starts,
                amask=r.random(N_RAYS) < 0.5)


def _case(sm, case):
    """(tmin, tmax, roots) numpy arrays: a third of the lanes dead by
    tmax -1; NaN tmin on a third and NaN tmax on another; per-lane roots
    (row 0 or a node child of it) with half the lanes dead."""
    r = np.random.default_rng(CASES.index(case))
    tmin = np.full(N_RAYS, 1e-4, np.float32)
    tmax = np.full(N_RAYS, 1e9, np.float32)
    roots = None
    if case == "tmax_minus_1":
        tmax[r.random(N_RAYS) < 1 / 3] = -1.0
    elif case == "nan":
        third = r.integers(0, 3, N_RAYS)
        tmin[third == 1] = np.nan
        tmax[third == 2] = np.nan
    else:
        roots = sm["starts"][r.integers(0, len(sm["starts"]), N_RAYS)]
        tmax[r.random(N_RAYS) < 0.5] = -1.0
    return tmin, tmax, roots


def _port(sm, tmin, tmax, roots, mode, **kw):
    rays = Rays(torch.from_numpy(sm["o"]), torch.from_numpy(sm["d"]),
                torch.from_numpy(tmin), torch.from_numpy(tmax))
    mkw = (dict(any_hit=True) if mode == "any_hit" else
           dict(any_mask=torch.from_numpy(sm["amask"])) if mode == "mixed" else {})
    rt = None if roots is None else torch.from_numpy(roots)
    return rays, rt, traversal8.intersect_wide(sm["table"], rays, roots=rt,
                                               with_iters=True, **mkw, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_dead_lane_rule_on_plain(sm, case, mode):
    """Every lane outside the live model takes one step and ends with
    t = tmax (a NaN tmax as NaN), tri -1, u = v = 0, no flag; the model
    leaves such lanes out and keeps the rest."""
    tmin, tmax, roots = _case(sm, case)
    rays, rt, (hit, steps, flags) = _port(sm, tmin, tmax, roots, mode)
    live = traversal8.live_lanes(rays, roots=rt)
    dead = ~live
    assert 0 < int(dead.sum()) < N_RAYS
    np.testing.assert_array_equal(hit.t[dead].numpy(), tmax[dead.numpy()])
    assert bool((hit.tri[dead] == -1).all())
    assert bool((hit.u[dead] == 0).all()) and bool((hit.v[dead] == 0).all())
    assert bool((steps[dead] == 1).all()) and bool((flags[dead] == 0).all())
    # the live lanes do real work: some take more than one step
    assert int((steps[live] > 1).sum()) > 0


@pytest.mark.parametrize("case", CASES)
def test_dead_lanes_as_jax(sm, case):
    """The JAX package's intersect_wide gives the dead lanes the same hits
    (closest-hit mode, the same table and rays)."""
    tmin, tmax, roots = _case(sm, case)
    rays, rt, (hit, _, _) = _port(sm, tmin, tmax, roots, "closest")
    jtable = jscenes.san_miguel_stand_in(32, 32, target_tris=20000).build().geom.wide
    np.testing.assert_array_equal(np.asarray(jtable), sm["table"].numpy())
    jr = jtrav.Rays(o=jnp.asarray(sm["o"]), d=jnp.asarray(sm["d"]),
                    tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax))
    jh = jtrav8.intersect_wide(jtable, jr, roots=None if roots is None
                               else jnp.asarray(roots))
    dead = (~traversal8.live_lanes(rays, roots=rt)).numpy()
    np.testing.assert_array_equal(np.asarray(jh.t)[dead], hit.t.numpy()[dead])
    np.testing.assert_array_equal(np.asarray(jh.tri)[dead], hit.tri.numpy()[dead])
    np.testing.assert_array_equal(np.asarray(jh.u)[dead], 0.0)
    np.testing.assert_array_equal(np.asarray(jh.v)[dead], 0.0)


@pytest.mark.parametrize("mode", MODES)
def test_dead_lane_rule_at_one_step_and_a_small_stack(sm, mode):
    """max_iters = 1 and a 2-entry stack change nothing for a dead lane."""
    tmin, tmax, roots = _case(sm, "tmax_minus_1")
    rays, rt, (hit, steps, flags) = _port(sm, tmin, tmax, roots, mode,
                                          max_iters=1, stack_depth=2)
    dead = ~traversal8.live_lanes(rays, max_iters=1)
    assert bool((steps[dead] == 1).all()) and bool((flags[dead] == 0).all())
    np.testing.assert_array_equal(hit.t[dead].numpy(), tmax[dead.numpy()])
    # the live lanes hit the cap
    assert bool((flags[~dead] & traversal8.FLAG_CAPPED).any())


def test_tmin_equal_tmax_lanes_are_not_dead(sm):
    """tmin = tmax = 0: the lanes whose origins lie in boxes descend them,
    so such a lane is live (ROADMAP queue 2, follow-up 5)."""
    zero = np.zeros(N_RAYS, np.float32)
    rays, _, (hit, steps, flags) = _port(sm, zero, zero.copy(), None, "closest")
    assert bool(traversal8.live_lanes(rays).all())
    assert int((steps > 1).sum()) > 0 and int(steps.max()) > 2
    assert bool((hit.tri == -1).all()) and bool((flags == 0).all())


@pytest.mark.parametrize("what", ["nan_tmin", "nan_tmax", "negative_root",
                                  "overflowing_root", "no_steps", "equal"])
def test_live_model(what):
    """The live model's edges: a NaN on either side is dead; a start that is
    not a node row (a negative root, or one whose (root << 8) | 0xFF
    overflows int32) and a zero-step cap are live (the plain version does
    not take the one node step there); tmin = tmax is live."""
    o = torch.zeros(1, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]])
    tmin, tmax, roots, max_iters, live = (torch.tensor([1e-4]), torch.tensor([-1.0]),
                                          None, traversal8.MAX_ITERS, True)
    if what == "nan_tmin":
        tmin, tmax, live = torch.tensor([float("nan")]), torch.tensor([1.0]), False
    elif what == "nan_tmax":
        tmax, live = torch.tensor([float("nan")]), False
    elif what == "negative_root":
        roots = torch.tensor([-1], dtype=torch.int32)
    elif what == "overflowing_root":
        roots = torch.tensor([1 << 23], dtype=torch.int32)
    elif what == "no_steps":
        max_iters = 0
    else:
        tmin = tmax = torch.tensor([0.5])
    got = traversal8.live_lanes(Rays(o, d, tmin, tmax), max_iters, roots)
    assert bool(got[0]) == live


def test_design_argument_checks(sm):
    """`_design` is checked before the tensors' device; the group design's
    names; the probe's group designs; CPU tensors never reach a kernel."""
    rays = Rays(torch.from_numpy(sm["o"]), torch.from_numpy(sm["d"]),
                torch.full((N_RAYS,), 1e-4), torch.full((N_RAYS,), 1e9))
    with pytest.raises(ValueError, match="no design 'warp'"):
        traversal8.intersect_wide_cuda(sm["table"], rays, _design="warp")
    with pytest.raises(ValueError, match="CUDA tensor"):
        traversal8.intersect_wide_cuda(sm["table"], rays, _design="group")
    with pytest.raises(ValueError, match="no group design 'g12'"):
        schedule_probe.traverse8_group(sm["table"], rays, "g12")
    assert traversal8.GLOBAL_DESIGNS == ("thread", "group")
    assert traversal8.FALLBACK_DESIGN == "group"
    assert set(traversal8.intersect_wide_cuda.launches_by_design) == {"thread", "group"}
    assert list(schedule_probe.GROUP_DESIGNS) == ["g8", "g32", "g16p"]
    work = traversal8.group_work(5, "cpu")
    assert work.dtype == torch.int32 and work.shape == (traversal8.GROUP_WORK + 5,)
    assert not work.any()   # a new work area's counters start at zero


class _CudaTable:
    """A stand-in for a CUDA table: the fallback's dispatch reads is_cuda."""
    is_cuda = True

    def __init__(self, table):
        self.table = table


@pytest.mark.parametrize("instanced", [False, True], ids=["flat", "roots"])
def test_treelet_fallback_asks_for_the_group_design(sm, monkeypatch, instanced):
    """On a CUDA table the flat treelet path's fallback calls K1 with
    _design="group"; with per-lane roots (the instanced visits) it asks for
    no design, so K1 runs one thread per ray; on a CPU table it calls the
    plain version, which takes no such argument (recorded here with the
    plain version standing in for the kernel). All give the same hits."""
    geom = sm["sc"].geom
    pix = torch.arange(1024, dtype=torch.int32)
    from cudatracerlib_tpu_torch.models import tracer as ttracer
    cam = ttracer.gen_camera_rays(sm["sc"], pix, 0, 0, 32, 32)[0]
    cam = Rays(*(x.contiguous() for x in cam))
    kw = {}
    if instanced:   # every lane from the roots of the whole table
        zero = torch.zeros(1024, dtype=torch.int32)
        kw = dict(roots=zero, roots_top=zero)
    want = traversal8.intersect_treelet_exact(geom, cam, coherent=True, **kw)
    seen = []

    def wide_fn(table, pool=False):
        def k1(table, rays, **kw_):
            seen.append(kw_.pop("_design", None))
            return traversal8.intersect_wide(table.table, rays, **kw_)
        return k1
    monkeypatch.setattr(traversal8, "_wide_fn", wide_fn)
    got = traversal8.intersect_treelet_exact(
        geom._replace(wide=_CudaTable(geom.wide)), cam, coherent=True, **kw)
    assert seen == [None if instanced else "group"]
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
