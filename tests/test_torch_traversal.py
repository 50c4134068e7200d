"""The port's traversal (plain PyTorch version of the CUDA kernel) against
the JAX package's Pallas kernel, run interpreted on the CPU, and its XLA loop.

Rays start inside the Cornell box (origins uniform in [0.05, 0.95]^3,
normalised Gaussian directions), 4096+513 of them.

Closest-hit lanes: the triangle must agree wherever the two nearest hits
(from a float64 brute force) are more than 1e-5 apart in relative t; t, u
and v agree within rtol 1e-5 / atol 1e-6, because XLA on the CPU contracts
a*b+c into FMAs where PyTorch rounds twice. For grazing rays the
Moller-Trumbore dot products cancel: each of t, u, v is a three-term dot
product divided by det, whose rounding error is bounded by a few ulps of
kappa = sum|terms| / |det|. The bound therefore adds 4 * eps32 * kappa,
computed per lane in float64. Any-hit lanes report the first occluder met,
which depends on traversal order, so only hit versus no-hit is compared
there."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.ops import traversal as jtrav
from cudatracerlib_tpu.ops import traversal8 as jtrav8
from cudatracerlib_tpu.ops import traversal_pl
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
N_RAYS = 4096 + 513
MODES = ["closest", "any_hit", "mixed"]


def _brute_two_nearest(wide, o, d, tmin):
    """Two smallest hit distances per ray over every leaf triangle (float64)."""
    leaves = wide[wide[:, 120] > 0].astype(np.float64)
    ids = wide[wide[:, 120] > 0][:, 108:120].view(np.int32)
    keep = ids.reshape(-1) >= 0
    tri = lambda a: leaves[:, 12 * a:12 * a + 12].reshape(-1)[keep]
    v0 = np.stack([tri(0), tri(1), tri(2)], 1)
    e1 = np.stack([tri(3), tri(4), tri(5)], 1)
    e2 = np.stack([tri(6), tri(7), tri(8)], 1)
    best = np.full((o.shape[0], 2), np.inf)
    for s in range(0, o.shape[0], 512):
        oo, dd = o[s:s + 512, None].astype(np.float64), d[s:s + 512, None].astype(np.float64)
        p = np.cross(dd, e2[None])
        det = (e1[None] * p).sum(-1)
        inv = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
        tv = oo - v0[None]
        u = (tv * p).sum(-1) * inv
        q = np.cross(tv, e1[None])
        v = (dd * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
        ok = (np.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin)
        best[s:s + 512] = np.sort(np.where(ok, t, np.inf), axis=1)[:, :2]
    return best


def _conditioning(wide, tri, o, d):
    """Per-lane kappa of t, u, v for the hit triangle (float64)."""
    leaves = wide[wide[:, 120] > 0].astype(np.float64)
    ids = wide[wide[:, 120] > 0][:, 108:120].view(np.int32)
    row_of, slot_of = {}, {}
    for r_, k_ in zip(*np.nonzero(ids >= 0)):
        row_of[ids[r_, k_]], slot_of[ids[r_, k_]] = r_, k_
    rows = np.array([row_of[x] for x in tri], np.int64)
    slots = np.array([slot_of[x] for x in tri], np.int64)
    g = lambda a: leaves[rows, 12 * a + slots]
    v0 = np.stack([g(0), g(1), g(2)], 1)
    e1 = np.stack([g(3), g(4), g(5)], 1)
    e2 = np.stack([g(6), g(7), g(8)], 1)
    o, d = o.astype(np.float64), d.astype(np.float64)
    p = np.cross(d, e2)
    det = np.abs((e1 * p).sum(1))
    tv = o - v0
    q = np.cross(tv, e1)
    return (np.abs(e2 * q).sum(1) / det, np.abs(tv * p).sum(1) / det,
            np.abs(d * q).sum(1) / det)


@pytest.fixture(scope="module")
def setup():
    r = np.random.default_rng(7)
    o = r.uniform(0.05, 0.95, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    amask = r.random(N_RAYS) < 0.5
    tmin, tmax = np.float32(1e-4), np.float32(1e9)
    jsc = jscenes.cornell_box(32, 32).build()
    tsc = tscenes.cornell_box(32, 32).build("cpu")
    jr = jtrav.Rays(o=jnp.asarray(o), d=jnp.asarray(d),
                    tmin=jnp.full(N_RAYS, tmin), tmax=jnp.full(N_RAYS, tmax))
    tr = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d),
              tmin=torch.full((N_RAYS,), float(tmin)),
              tmax=torch.full((N_RAYS,), float(tmax)))
    two = _brute_two_nearest(tsc.geom.wide.numpy(), o, d, float(tmin))
    return dict(jsc=jsc, tsc=tsc, jr=jr, tr=tr, amask=amask, two=two, o=o, d=d)


def _kw(mode, amask, lib):
    if mode == "any_hit":
        return dict(any_hit=True)
    if mode == "mixed":
        return dict(any_mask=jnp.asarray(amask) if lib == "jax" else torch.from_numpy(amask))
    return {}


def _check(port, ref, mode, s):
    amask, two = s["amask"], s["two"]
    p_tri, r_tri = port.tri.numpy(), np.asarray(ref.tri)
    any_lane = np.ones(N_RAYS, bool) if mode == "any_hit" else (
        amask if mode == "mixed" else np.zeros(N_RAYS, bool))
    np.testing.assert_array_equal(p_tri[any_lane] >= 0, r_tri[any_lane] >= 0)
    cl = ~any_lane
    np.testing.assert_array_equal(p_tri[cl] >= 0, r_tri[cl] >= 0)
    with np.errstate(invalid="ignore"):  # inf - inf on rays with no hit
        separated = ((two[:, 1] - two[:, 0]) > 1e-5 * np.abs(two[:, 0])) | (
            ~np.isfinite(two[:, 1]))
    np.testing.assert_array_equal(p_tri[cl & separated], r_tri[cl & separated])
    np.testing.assert_allclose(port.t.numpy()[cl], np.asarray(ref.t)[cl],
                               rtol=1e-5, atol=1e-6)
    same = cl & (p_tri == r_tri) & (p_tri >= 0)
    if not same.any():
        return int(cl.sum()), int((cl & separated).sum())
    kappas = _conditioning(s["tsc"].geom.wide.numpy(), p_tri[same],
                           s["o"][same], s["d"][same])
    eps32 = float(np.finfo(np.float32).eps)
    for a, b, kappa in zip((port.t, port.u, port.v), (ref.t, ref.u, ref.v), kappas):
        a, b = a.numpy()[same], np.asarray(b)[same]
        bound = 1e-6 + 1e-5 * np.abs(b) + 4 * eps32 * kappa
        assert np.all(np.abs(a - b) <= bound), np.max(np.abs(a - b) - bound)
    return int(cl.sum()), int((cl & separated).sum())


@pytest.mark.parametrize("mode", MODES)
def test_against_pallas_kernel_interpreted(setup, mode):
    s = setup
    hit, iters, rows, ovf = traversal8.intersect_scene(
        s["tsc"].geom, s["tr"], with_iters=True,
        **_kw(mode, s["amask"], "torch"))
    assert ovf.tolist() == [0, 0]          # no capped, no overflowed rays
    assert int(iters) == int(rows) > N_RAYS
    ref = traversal_pl.intersect_pallas(
        traversal_pl.prep_table_jnp(s["jsc"].geom.wide), s["jr"],
        **_kw(mode, s["amask"], "jax"))
    n_cl, n_sep = _check(hit, ref, mode, s)
    if mode == "closest":
        assert n_sep > 0.95 * n_cl


@pytest.mark.parametrize("mode", MODES)
def test_against_xla_loop(setup, mode):
    s = setup
    hit = traversal8.intersect_scene(s["tsc"].geom, s["tr"],
                                     **_kw(mode, s["amask"], "torch"))
    ref = jtrav8.intersect_wide(s["jsc"].geom.wide, s["jr"],
                                **_kw(mode, s["amask"], "jax"))
    _check(hit, ref, mode, s)


def test_steps_cap_and_stack_overflow_flags(setup):
    s = setup
    table = s["tsc"].geom.wide
    full, steps, flags = traversal8.intersect_wide(table, s["tr"], with_iters=True)
    assert int(flags.sum()) == 0 and int(steps.min()) >= 1
    # a cap below the longest ray flags exactly the rays that needed more
    cap = int(steps.max()) - 1
    _, steps_c, flags_c = traversal8.intersect_wide(table, s["tr"], max_iters=cap,
                                                    with_iters=True)
    capped = (flags_c & traversal8.FLAG_CAPPED) != 0
    assert torch.equal(capped, steps > cap) and int(capped.sum()) > 0
    assert int(steps_c.max()) == cap
    # a one-entry stack drops entries: flagged, and the hit may be missed
    h1, _, flags_1 = traversal8.intersect_wide(table, s["tr"], stack_depth=1,
                                               with_iters=True)
    ovf = (flags_1 & traversal8.FLAG_OVERFLOW) != 0
    assert int(ovf.sum()) > 0
    assert torch.equal(h1.tri[~ovf], full.tri[~ovf])


def test_kernel_wrapper_rejects_cpu_tensors(setup):
    s = setup
    with pytest.raises(ValueError):
        traversal8.intersect_wide_cuda(s["tsc"].geom.wide, s["tr"])
    assert traversal8.intersect_wide_cuda.launches == 0
    assert set(traversal8.intersect_wide_cuda.launches_by_variant.values()) == {0}


# an H100's cudaDevAttrMaxSharedMemoryPerBlockOptin (227 KB): 454 fat rows
H100_SHARED_OPTIN = 232448


@pytest.fixture(scope="module")
def scene_tables():
    """The flat tables K1 traverses on the main path, at test size: Cornell,
    veach-mis and the 20,000-triangle San Miguel stand-in's unsplit table
    (at full size 211,592 rows)."""
    return dict(
        cornell=tscenes.cornell_box(32, 32).build("cpu").geom.wide,
        veach_mis=tscenes.veach_mis(32, 32).build("cpu").geom.wide,
        san_miguel=tscenes.san_miguel_stand_in(32, 32, target_tris=20000)
        .build("cpu").geom.wide)


@pytest.mark.parametrize("scene,rows,variant", [
    ("cornell", 317, "shared"), ("veach_mis", 331, "shared"),
    ("san_miguel", 2389, "global")])
def test_variant_rule_on_the_scene_tables(scene_tables, scene, rows, variant):
    """K1's variant follows the table's size against the card's shared
    memory: Cornell and veach-mis fit an H100 block, San Miguel does not."""
    table = scene_tables[scene]
    assert table.shape == (rows, 128)
    assert traversal8.table_variant(table.shape[0], H100_SHARED_OPTIN) == variant


@pytest.mark.parametrize("rows,limit,variant", [
    (454, H100_SHARED_OPTIN, "shared"), (455, H100_SHARED_OPTIN, "global"),
    (2048, H100_SHARED_OPTIN, "global"),      # the largest unsplit table
    (317, 166912, "shared"), (331, 166912, "global"),   # a 163 KB opt-in
    (96, 49152, "shared"), (97, 49152, "global"),       # 48 KB, no opt-in
    (1, 0, "global")])
def test_variant_rule_at_the_limit(rows, limit, variant):
    assert traversal8.table_variant(rows, limit) == variant


def test_forced_variant_is_checked(setup):
    table = setup["tsc"].geom.wide
    assert traversal8.launch_variant(table, "global") == "global"
    assert traversal8.launch_variant(table, "shared") == "shared"
    with pytest.raises(ValueError):
        traversal8.launch_variant(table, "texture")


@pytest.mark.parametrize("variant,shape", [("shared", (1,)), ("global", None)])
def test_only_the_shared_variant_gets_a_queue_counter(variant, shape):
    counter = traversal8.queue_counter(variant, "cpu")
    assert (counter is None) if shape is None else (
        counter.shape == shape and counter.dtype == torch.int32)


def test_schedule_probe_rejects_cpu_tensors(setup):
    """The probe's designs run only on a card: CPU tensors raise before
    anything is built."""
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe
    table = setup["tsc"].geom.wide
    for design in probe.DESIGNS:
        with pytest.raises(ValueError):
            probe.traverse8(table, setup["tr"], design)
        with pytest.raises(ValueError):
            probe.top_visits(table, setup["tr"], 3, design)


@pytest.mark.parametrize("report", [None, "ptxas info    : Used 86 registers"])
def test_a_built_kernel_loads_with_or_without_its_ptxas_report(
        report, monkeypatch, tmp_path):
    """A library built earlier loads whether or not its ptxas report was
    kept beside it (a report is a diagnostic, never a condition)."""
    from cudatracerlib_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "build_log", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("lib", path))
    lib_path = cuda_build._lib_path("traversal8.cu")
    os.makedirs(os.path.dirname(lib_path))
    open(lib_path, "wb").close()
    if report is not None:
        with open(lib_path + ".ptxas", "w") as f:
            f.write(report)
    assert cuda_build.load_library("traversal8.cu") == ("lib", lib_path)
    assert cuda_build.build_log["traversal8.cu"]["ptxas"] == (report or "")


def test_intersect_scene_hands_the_kernels_contiguous_rays(setup, monkeypatch):
    """Camera rays share one origin through a stride-0 view; the kernel
    wrappers refuse non-contiguous rays, so intersect_scene passes a
    contiguous copy (a path traced without NEE sends camera rays straight
    to the traversal)."""
    s = setup
    seen = []
    plain = traversal8.intersect_wide

    def spy(table, rays, **kw):
        seen.append(all(x.is_contiguous() for x in rays))
        return plain(table, rays, **kw)
    monkeypatch.setattr(traversal8, "intersect_wide", spy)
    tr = s["tr"]
    rays = Rays(o=tr.o[:1].expand(N_RAYS, 3), d=tr.d, tmin=tr.tmin, tmax=tr.tmax)
    assert not rays.o.is_contiguous()
    hit = traversal8.intersect_scene(s["tsc"].geom, rays)
    assert seen == [True]
    ref = plain(s["tsc"].geom.wide, Rays(rays.o.contiguous(), *rays[1:]))
    assert torch.equal(hit.tri, ref.tri) and torch.equal(hit.t, ref.t)
