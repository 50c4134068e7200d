"""The lane-utilization count (``with_util``) of K1 and K4, on the CPU.

The JAX kernels' ``with_util`` returns ``act_sum``, the lane steps a launch
ran while a lane's ray was active, beside the lockstep slots; the port
returns ``slots``, an int64 scalar, beside ``(hit, steps, flags)``, and the
utilization is ``steps.sum() / slots``. On a CPU table every wrapper runs
the plain version, whose slots are K1's static schedule's: each warp runs
32 consecutive rays to the end of the slowest (``static_slots``), held here
to a numpy loop. The port's ``steps.sum()`` is held to the JAX ``act_sum``
of ``intersect_pallas`` and ``intersect_pallas_pool``, run interpreted on
``test_torch_pool.py``'s 4,609 Cornell rays: the JAX wrappers pad the rays
to a multiple of K * G * 128 with lanes of tmax -1, each of which takes
exactly one step, and no ray's steps differ, so ``act_sum`` is the port's
sum plus the pad's lane count, exactly.

K4 writes a dead ray's outputs at fetch without a row read: t = tmax,
tri -1, u = v = 0, one step, no flag. Those are the plain version's
outputs on every lane with !(tmin <= tmax) (NaN tmin or tmax, tmin > tmax)
on the Cornell table, in the three modes; the lanes with tmin = tmax stay
live. The wrappers of K4 and its probe designs reject an unknown design
and CPU tensors before any library is built, and a work area of the
wrong size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.ops import traversal_pl
from cudatracerlib_tpu.ops.traversal import Rays as JRays
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import schedule_probe

torch.set_num_threads(2)
MODES = ["closest", "any_hit", "mixed"]
N = 4096 + 513


@pytest.fixture(scope="module")
def setup():
    # the rays of tests/test_pool_kernel.py and tests/test_torch_pool.py
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    o = np.array(jax.random.uniform(k1, (N, 3), minval=0.05, maxval=0.95))
    d = np.asarray(jax.random.normal(k2, (N, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jsc = jscenes.cornell_box(64, 64).build()
    tsc = tscenes.cornell_box(64, 64).build("cpu")
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d), tmin=jnp.full(N, 1e-4),
               tmax=jnp.full(N, 1e9))
    tr = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d),
              tmin=torch.full((N,), 1e-4), tmax=torch.full((N,), 1e9))
    return dict(jsc=jsc, tsc=tsc, jr=jr, tr=tr, mask=(np.arange(N) % 3) == 0, o=o, d=d)


def _kw(mode, mask, lib):
    if mode == "any_hit":
        return dict(any_hit=True)
    if mode == "mixed":
        return dict(any_mask=jnp.asarray(mask) if lib == "jax" else torch.from_numpy(mask))
    return {}


def _numpy_slots(steps):
    """32 x the sum over 32-ray groups (the last one short) of the largest
    step count, by a loop."""
    return sum(32 * int(steps[g:g + 32].max()) for g in range(0, len(steps), 32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wrapper", ["intersect_wide", "intersect_wide_pool"])
def test_with_util_on_cpu_is_the_static_schedule(setup, mode, wrapper):
    """with_util on a CPU table: the plain version's (hit, steps, flags) and
    the static schedule's slots, an int64 scalar, equal to a numpy loop over
    the steps; without with_iters the hit alone, as in the JAX wrappers."""
    s = setup
    fn = getattr(traversal8, wrapper)
    kw = _kw(mode, s["mask"], "torch")
    hit, steps, flags, slots = fn(s["tsc"].geom.wide, s["tr"], with_iters=True,
                                  with_util=True, **kw)
    ref = traversal8.intersect_wide(s["tsc"].geom.wide, s["tr"], with_iters=True, **kw)
    for x, y in zip((*hit[:4], steps, flags), (*ref[0][:4], ref[1], ref[2])):
        assert torch.equal(x, y)
    assert slots.dtype == torch.int64 and slots.shape == ()
    assert int(slots) == _numpy_slots(steps.numpy())
    assert int(slots) % 32 == 0 and int(slots) >= int(steps.sum())
    only = fn(s["tsc"].geom.wide, s["tr"], with_util=True, **kw)
    assert isinstance(only, traversal8.Hit) and torch.equal(only.t, hit.t)


@pytest.mark.parametrize("B", [0, 1, 31, 32, 33, 100])
def test_static_slots_edges(B):
    """Empty batches, one ray, exact and ragged groups."""
    steps = torch.from_numpy(np.random.default_rng(B).integers(0, 40, B).astype(np.int32))
    got = traversal8.static_slots(steps)
    assert got.dtype == torch.int64 and int(got) == _numpy_slots(steps.numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", ["intersect_pallas", "intersect_pallas_pool"])
def test_steps_sum_is_jax_act_sum(setup, mode, kernel):
    """The port's summed steps against the JAX kernels' act_sum
    (with_util=True), interpreted on the CPU: equal but for the pad lanes'
    one step each."""
    s = setup
    out = getattr(traversal_pl, kernel)(
        traversal_pl.prep_table_jnp(s["jsc"].geom.wide), s["jr"], with_iters=True,
        with_util=True, **_kw(mode, s["mask"], "jax"))
    act_sum = float(out[3])
    block = traversal_pl.DEFAULT_K * traversal_pl.DEFAULT_G * traversal_pl.LANES
    pad = -N % block
    _, steps, flags, _ = traversal8.intersect_wide_pool(
        s["tsc"].geom.wide, s["tr"], with_iters=True, with_util=True,
        **_kw(mode, s["mask"], "torch"))
    assert int(flags.sum()) == 0   # no ray capped: the two counts compare
    assert act_sum == int(steps.sum()) + pad
    # the JAX kernels' lockstep slots never fall below their active steps
    assert float(out[2]) >= act_sum


def _dead_rays(s, kind):
    """The Cornell rays with a third of the lanes dead of `kind`: NaN tmin,
    NaN tmax, or tmin > tmax > 0; and a third at tmin = tmax (live)."""
    r = np.random.default_rng(["nan_tmin", "nan_tmax", "tmin_over_tmax"].index(kind))
    third = r.integers(0, 3, N)
    tmin = np.full(N, 1e-4, np.float32)
    tmax = np.full(N, 1e9, np.float32)
    if kind == "nan_tmin":
        tmin[third == 0] = np.nan
    elif kind == "nan_tmax":
        tmax[third == 0] = np.nan
    else:
        tmin[third == 0] = r.uniform(2.0, 4.0, int((third == 0).sum()))
        tmax[third == 0] = r.uniform(0.1, 1.9, int((third == 0).sum()))
    tmin[third == 1] = tmax[third == 1] = 0.5
    return Rays(torch.from_numpy(s["o"]), torch.from_numpy(s["d"]),
                torch.from_numpy(tmin), torch.from_numpy(tmax)), third


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["nan_tmin", "nan_tmax", "tmin_over_tmax"])
def test_dead_lane_outputs_as_k4_writes_them(setup, kind, mode):
    """K4's fixed outputs of a dead ray are the plain version's: t = tmax (a
    NaN tmax as NaN), tri -1, u = v = 0, one step, no flag; the model calls
    exactly those lanes dead, and none at tmin = tmax."""
    s = setup
    rays, third = _dead_rays(s, kind)
    hit, steps, flags = traversal8.intersect_wide_pool(
        s["tsc"].geom.wide, rays, with_iters=True, **_kw(mode, s["mask"], "torch"))
    dead = ~traversal8.live_lanes(rays)
    np.testing.assert_array_equal(dead.numpy(), third == 0)
    np.testing.assert_array_equal(hit.t[dead].numpy(), rays.tmax[dead].numpy())
    assert bool((hit.tri[dead] == -1).all())
    assert bool((hit.u[dead] == 0).all()) and bool((hit.v[dead] == 0).all())
    assert bool((steps[dead] == 1).all()) and bool((flags[dead] == 0).all())
    assert int((steps[~dead] > 1).sum()) > 0


def test_pool_wrappers_reject_bad_designs_and_cpu_tensors(setup):
    """An unknown design or variant is refused by name, CPU tensors before
    any library is built (no nvcc here), and a work area of the wrong size
    or type; no launch is counted."""
    s = setup
    table = s["tsc"].geom.wide
    before = traversal8.intersect_wide_pool_cuda.launches
    assert list(schedule_probe.POOL_DESIGNS) == ["first", "f1", "f8", "f16", "r1", "r2"]
    for design in ("f4", "k4", "pr2"):
        with pytest.raises(ValueError, match=f"no K4 design '{design}'"):
            schedule_probe.traverse_pool(table, s["tr"], design)
    with pytest.raises(ValueError, match="CUDA tensor"):
        schedule_probe.traverse_pool(table, s["tr"], "f8", with_util=True)
    for kw in ({}, dict(with_iters=True, with_util=True), dict(_variant="shared")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            traversal8.intersect_wide_pool_cuda(table, s["tr"], **kw)
    with pytest.raises(ValueError, match="no K1/K2 variant 'pool'"):
        traversal8.launch_variant(table, "pool")
    with pytest.raises(ValueError, match="CUDA tensor"):
        traversal8.intersect_wide_cuda(table, s["tr"], with_iters=True, with_util=True)
    assert traversal8.intersect_wide_pool_cuda.launches == before
    work = traversal8.group_work(0, "cpu")
    assert traversal8._work_area(5, torch.device("cpu"), False, work) == (work, 0)
    with pytest.raises(ValueError, match="_scratch must have shape"):
        traversal8._work_area(5, torch.device("cpu"), True, work)
    with pytest.raises(ValueError, match="_scratch must be torch.int32"):
        traversal8._work_area(5, torch.device("cpu"), False, work.long())


def test_work_area_layout():
    """The two counter sets split GROUP_WORK words; each counter sits on its
    own 128-byte line; the int64 counters read through work_util in either
    set, and a new area's are zero."""
    half = traversal8.GROUP_WORK // 2
    words = [*traversal8.GROUP_COUNTERS, *traversal8.UTIL_COUNTERS]
    assert len({w // 32 for w in words}) == len(words) and max(words) + 2 <= half
    work = traversal8.group_work(3, "cpu")
    assert work.shape == (traversal8.GROUP_WORK + 3,)
    assert traversal8.work_util(work).tolist() == [0, 0]
    for count_set in (0, 1):
        base = count_set * half
        for k, w in enumerate(traversal8.UTIL_COUNTERS):
            work[base + w:base + w + 2].view(torch.int64)[0] = (5 + k) << 33
        assert traversal8.work_util(work, count_set).tolist() == [5 << 33, 6 << 33]


@pytest.mark.parametrize("warps", [1, 3])
def test_pool_model_edges(warps):
    """K4's schedule model (schedule_probe.pool_model): a threshold of 32
    idle lanes on one warp is K1's static schedule; its lane steps are the
    rays' steps, a dead ray's one step included, at every threshold; unit
    steps fill every slot but the last iteration's."""
    r = np.random.default_rng(warps)
    steps = r.integers(1, 30, 1000).astype(np.int32)
    dead = r.random(1000) < 0.3
    steps[dead] = 1
    no_dead = np.zeros(1000, bool)
    if warps == 1:
        slots, active = schedule_probe.pool_model(steps, no_dead, 1, 32)
        assert slots == int(traversal8.static_slots(torch.from_numpy(steps)))
    for F in (1, 8, 16, 32):
        for d in (dead, no_dead):
            slots, active = schedule_probe.pool_model(steps, d, warps, F)
            assert active == int(steps.sum()) and slots % 32 == 0 and slots >= active
    assert schedule_probe.pool_model(np.ones(70, np.int32), np.zeros(70, bool), 1, 1) \
        == (96, 70)
