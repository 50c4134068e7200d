"""The plain versions of the microbenchmarks P1-P3 (utils/microbench.py)
against numpy loops written out row by row, at tiny sizes. All their
outputs are integers, copied rows or float32 chains computed op for op, so
they must match exactly. P2's gather of runs is also held to the JAX
package's hash-grid neighbourhood gather (``cudatracerlib_tpu.ops.hashgrid
.gather_neighbors``, its rows captured through accum_fn), and step_only's
first step to the plain traversal's (``ops/traversal8._lockstep``). Their
kernels run only on the card (chip_smoke.py holds them to these plain
versions there); here the wrappers refuse CPU tensors and unknown
designs. Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.ops import hashgrid as jhg
from cudatracerlib_tpu_torch.ops import hashgrid as thg, traversal8
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.utils import microbench as mb

ROWS = 37


def _table(seed=0):
    r = np.random.default_rng(seed)
    bits = r.integers(-2 ** 31, 2 ** 31 - 1, (ROWS, 128), dtype=np.int64).astype(np.int32)
    return bits, torch.from_numpy(bits.view(np.float32).copy())


def _xor(row_bits):
    h = 0
    for w in row_bits:
        h ^= int(w) & 0xFFFFFFFF
    return h


def test_chase_rows_matches_numpy_loop():
    bits, table = _table(1)
    idx0 = np.random.default_rng(2).integers(0, ROWS, 23).astype(np.int32)
    got = mb.chase_rows(table, torch.from_numpy(idx0), 9).numpy()
    for c, start in enumerate(idx0):
        idx = int(start)
        for s in range(9):
            idx = ((_xor(bits[idx]) + s * 0x9E3779B9) % 2 ** 32) % ROWS
        assert got[c] == idx
    assert got.dtype == np.int32


def test_chase_rows_node_step_matches_numpy_loop():
    """With words=14 a step's row value is the xor of its first 56 words
    (what a traversal's node step reads)."""
    bits, table = _table(5)
    idx0 = np.random.default_rng(6).integers(0, ROWS, 19).astype(np.int32)
    got = mb.chase_rows(table, torch.from_numpy(idx0), 7, words=mb.NODE_WORDS).numpy()
    for c, start in enumerate(idx0):
        idx = int(start)
        for s in range(7):
            idx = ((_xor(bits[idx][:4 * mb.NODE_WORDS]) + s * 0x9E3779B9) % 2 ** 32) % ROWS
        assert got[c] == idx


def test_gather_rows_matches_numpy_loop():
    bits, table = _table(3)
    idx = np.random.default_rng(4).integers(0, ROWS, 101).astype(np.int32)
    got = mb.gather_rows(table, torch.from_numpy(idx)).numpy()
    want = np.array([_xor(bits[i]) for i in idx], np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_loop_only_matches_numpy_loop():
    x0 = np.random.default_rng(5).random(16, dtype=np.float32)
    x = x0.copy()
    for _ in range(300):
        x = (x * np.float32(mb.LOOP_FACTOR)).astype(np.float32) + np.float32(1.0)
    np.testing.assert_array_equal(mb.loop_only(torch.from_numpy(x0), 300).numpy(), x)


@pytest.mark.parametrize("n,warps", [(1, 1), (31, 1), (1000, 4), (4097, 3)])
def test_queue_fetch_hands_out_every_item_once(n, warps):
    counts = mb.queue_fetch(n, warps)
    assert counts.dtype == torch.int32 and counts.shape == (n,)
    # the warp queue as a numpy loop: warps in turn claim 32 items each
    want, counter = np.zeros(n, np.int32), 0
    while counter < n:
        for _ in range(warps):
            for lane in range(32):
                if counter + lane < n:
                    want[counter + lane] += 1
            counter += 32
    np.testing.assert_array_equal(counts.numpy(), want)
    assert (want == 1).all()


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = mb.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = mb.bound_ms(1.0, 67e9)
    assert by == "operations" and abs(ms - 1.0) < 1e-12


def _grid(seed=3, n=700):
    """A photon grid of n rows of 12 float32 (position, payload) built by
    both packages from the same numpy inputs, and 37 query points."""
    r = np.random.default_rng(seed)
    pos = (r.random((n, 3)) * 3 - 1.5).astype(np.float32)
    rows = np.concatenate([pos, r.random((n, 9))], 1).astype(np.float32)
    valid = np.ones(n, bool)    # every row valid: the last cells' runs reach the end
    lo, hi, radius = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32), 0.2
    jg = jhg.build_grid(jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(valid),
                        jnp.asarray(lo), jnp.asarray(hi), jnp.float32(2 * radius))
    tg = thg.build_grid(*(torch.from_numpy(x) for x in (rows, pos, valid, lo, hi)),
                        torch.tensor(2 * radius, dtype=torch.float32))
    q = (r.random((37, 3)) * 3.2 - 1.6).astype(np.float32)
    q[:2] = [[1.9, 1.9, 1.9], [-1.9, -1.9, -1.9]]     # runs clamped at the end
    return jg, tg, q, np.full(37, radius, np.float32)


def test_gather_of_runs_matches_numpy_and_jax():
    """P2 (a)'s plain gather on the hash grid's index stream (8 runs of 16
    rows from each query cell's start, clamped to the last row): equal to a
    numpy loop, and to the rows the JAX package's gather_neighbors hands
    its accum_fn."""
    jg, tg, q, rq = _grid()
    cells = thg.neighbor_cells(tg, torch.from_numpy(q), torch.from_numpy(rq))
    start = thg.query_ranges(tg, cells.reshape(-1))[0].reshape(-1, mb.RUNS)
    n, data = tg.data.shape[0], tg.data
    idx = mb.run_index(start, n)
    got = mb.gather_take(data, idx).reshape(37, mb.RUNS * mb.RUN_ROWS, 12)
    want = np.zeros(got.shape, np.float32)
    for b in range(37):
        for j in range(mb.RUNS):
            for k in range(mb.RUN_ROWS):
                want[b, j * mb.RUN_ROWS + k] = data[min(int(start[b, j]) + k, n - 1)].numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    assert (start.numpy() + mb.RUN_ROWS > n).any()      # a clamped run is in the stream
    jrows = jhg.gather_neighbors(jg, jnp.asarray(q), jnp.asarray(rq),
                                 lambda carry, rows, mask: rows, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrows))
    assert idx.dtype == torch.int32 and got.dtype == torch.float32


def _step_rays(rows, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return mb.step_rays(rows, n, gen)


def test_step_only_first_step_matches_lockstep():
    """step_only's first step against the plain traversal's first step on
    the same rows and rays: a leaf step's best hit (t, triangle, u, v), and
    a node step's next state and entry t, read from a second step that
    visits the chosen child as a virtual leaf (every link of the node row
    points past n_real, so _lockstep records the visit and its entry t)."""
    r = np.random.default_rng(8)
    rows = mb.synthetic_step_rows(torch.Generator().manual_seed(int(r.integers(1 << 30))),
                                  "cpu")
    rows[0, 48:56] = torch.tensor([-3 - j for j in range(7)] + [traversal8.DONE],
                                  dtype=torch.int32).view(torch.float32)
    rays = _step_rays(rows, 301, 4)
    B = rays.o.shape[0]
    for any_hit in (False, True):
        anyh = torch.full((B,), any_hit)
        hit, steps, _, _ = traversal8._lockstep(
            rows[1:2], rays, torch.full((B,), -2, dtype=torch.int32), rays.tmax, anyh,
            traversal8.STACK_DEPTH, 1)
        want = (hit.t.view(torch.int32) ^ hit.tri ^ hit.u.view(torch.int32)
                ^ hit.v.view(torch.int32))
        od, acc = mb.step_only(rows, rays, 1, node=False, any_hit=any_hit)
        assert torch.equal(acc, want) and (steps == 1).all()
        assert (hit.tri >= 0).any() and (hit.tri < 0).any()
        h = (want & 1)[:, None]
        assert torch.equal(od.view(torch.int32),
                           torch.cat([rays.o, rays.d], 1).view(torch.int32) ^ h)
    hit, steps, _, (vids, vent, vcnt, _) = traversal8._lockstep(
        rows[0:1], rays, torch.full((B,), 0xFF, dtype=torch.int32), rays.tmax,
        torch.zeros(B, dtype=torch.bool), traversal8.STACK_DEPTH, 2, n_real=1, V=1)
    took = vcnt > 0
    nxt = torch.where(took, -2 - (1 + vids[:, 0]), traversal8.DONE)
    want = nxt ^ torch.where(took, vent[:, 0], 0.0).view(torch.int32)
    assert took.any() and (~took).any()
    for any_hit in (False, True):
        assert torch.equal(mb.step_only(rows, rays, 1, node=True, any_hit=any_hit)[1], want)


def _np_step(row, o, d, inv, tmn, tmax, node):
    """One step of one lane in numpy float32, written out child by child
    and triangle by triangle: its result word."""
    f = np.float32
    if node:
        best_t, best_j = f(np.inf), 0
        links = row[48:56].view(np.int32)
        for j in range(8):
            t0 = [(row[8 * a + j] - o[a]) * inv[a] for a in range(3)]
            t1 = [(row[24 + 8 * a + j] - o[a]) * inv[a] for a in range(3)]
            tn = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])), max(min(t0[2], t1[2]), tmn))
            tf = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])), min(max(t0[2], t1[2]), tmax))
            if tn <= tf and links[j] != -1 and tn < best_t:
                best_t, best_j = tn, j
        if best_t < np.inf:
            link = int(links[best_j])
            nxt = ((link << 8) | 0xFF) if link >= 0 else link
            return np.int32(nxt) ^ np.array(best_t, np.float32).view(np.int32)
        return np.int32(-1) ^ np.array(f(0), np.float32).view(np.int32)
    hit = (tmax, -1, f(0), f(0))
    for k in range(12):
        v0, e1, e2 = ([row[12 * (3 * g + a) + k] for a in range(3)] for g in range(3))
        p = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
             d[0] * e2[1] - d[1] * e2[0]]
        det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
        inv_det = f(0) if abs(det) < f(1e-12) else f(1) / det
        t_ = [o[a] - v0[a] for a in range(3)]
        u = (t_[0] * p[0] + t_[1] * p[1] + t_[2] * p[2]) * inv_det
        qv = [t_[1] * e1[2] - t_[2] * e1[1], t_[2] * e1[0] - t_[0] * e1[2],
              t_[0] * e1[1] - t_[1] * e1[0]]
        v = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv_det
        t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det
        tri = int(row[108 + k:109 + k].view(np.int32)[0])
        if (tri != -1 and abs(det) >= f(1e-12) and u >= 0 and v >= 0 and u + v <= 1
                and tmn < t < tmax and t < hit[0]):
            hit = (t, tri, u, v)
    word = lambda x: np.array(x, np.float32).view(np.int32)
    return word(hit[0]) ^ np.int32(hit[1]) ^ word(hit[2]) ^ word(hit[3])


@pytest.mark.parametrize("node", [True, False], ids=["node", "leaf"])
def test_step_only_matches_numpy_loop(node):
    """step_only over 6 steps (its ray's bits flipped by each step's
    result) against a numpy loop, lane by lane."""
    rows = mb.synthetic_step_rows(torch.Generator().manual_seed(11), "cpu")
    rays = _step_rays(rows, 40, 12)
    od, acc = mb.step_only(rows, rays, 6, node=node)
    row = rows[0 if node else 1].numpy()
    inv_all = mb._safe_inv(rays.d).numpy()
    results = set()
    for b in range(40):
        o, d = rays.o[b].numpy().copy(), rays.d[b].numpy().copy()
        a = np.int32(0)
        for _ in range(6):
            res = _np_step(row, o, d, inv_all[b], rays.tmin[b].numpy(),
                           rays.tmax[b].numpy(), node)
            results.add(int(res))
            a ^= res
            h = np.int32(res & 1)
            o = (o.view(np.int32) ^ h).view(np.float32)
            d = (d.view(np.int32) ^ h).view(np.float32)
        assert acc[b].item() == int(a)
        np.testing.assert_array_equal(od[b].numpy(), np.concatenate([o, d]))
    assert len(results) > 3


@pytest.mark.parametrize("n,dead", [(1, 0.0), (777, 0.4), (4096, 1.0)])
def test_queue_threshold_form_payload(n, dead):
    """P3's threshold form's plain version: every item once, and out the
    numpy payload (tmax for a dead item, written at fetch; else tmin + its
    busy steps), whatever the order of the fetches."""
    r = np.random.default_rng(n)
    steps = r.integers(0, 50, n).astype(np.int32)
    tmin = r.random(n).astype(np.float32)
    tmax = np.where(r.random(n) < dead, -1.0, 1e30).astype(np.float32)
    tmax[::97] = np.nan                              # NaN: dead, as K4 takes it
    counts, out = mb.queue_threshold(*(torch.from_numpy(x) for x in (steps, tmin, tmax)))
    want = np.empty(n, np.float32)
    for i in range(n):
        want[i] = tmax[i] if not tmin[i] <= tmax[i] else tmin[i] + np.float32(steps[i])
    np.testing.assert_array_equal(out.numpy(), want)
    assert counts.dtype == torch.int32 and (counts.numpy() == 1).all()


def test_synthetic_inputs_and_table_rows():
    """The random inputs measure() takes at a small size: the run stream
    equals run_index of its starts, the step rows are a node and a leaf
    row whose links and ids are what the kernels read, and table_step_rows
    finds a table's root and a leaf under it."""
    gen = torch.Generator().manual_seed(2)
    calls = mb.synthetic_take_calls(gen, "cpu", queries=9, rows=50)
    table, idx = calls["runs"]
    assert table.shape == (50, mb.TAKE_WIDTH) and idx.shape == (9 * 8 * 16,)
    assert int(idx.max()) == 49 and int(idx.min()) >= 0
    runs = idx.reshape(9 * 8, 16)
    step = runs[:, 1:] - runs[:, :-1]
    assert bool(((step == 1) | ((step == 0) & (runs[:, 1:] == 49))).all())
    rows = mb.synthetic_step_rows(gen, "cpu")
    links = rows[0, 48:56].view(torch.int32)
    assert (links == traversal8.DONE).sum() == 1 and (links <= -2).sum() == 4
    assert rows[1, 119:120].view(torch.int32).item() == -1
    t = torch.zeros((4, 128))
    t[0, 48:56] = torch.tensor([-1, 2, -1, -1, -1, -1, -1, -1], dtype=torch.int32).view(torch.float32)
    t[2, 48:56] = torch.tensor([-1, -1, -5, -1, -1, -1, -1, -1], dtype=torch.int32).view(torch.float32)
    t[3, 0] = 7.0
    got = mb.table_step_rows(t).view(torch.int32)     # links -1 are NaN as float32
    assert torch.equal(got[0], t[0].view(torch.int32))
    assert torch.equal(got[1], t[3].view(torch.int32))
    s, tmin, tmax = mb.synthetic_queue_items(1000, gen, "cpu")
    assert s.dtype == torch.int32 and 300 < int((tmax < tmin).sum()) < 500


def test_split_floor_adds_the_step_arithmetic():
    """A floor adds step_arith_ns (the smallest step_only reading at one
    warp an SM; a group lane's share of it with per_lane) to every row
    read: the split design's staged and other reads alike."""
    p1 = [dict(mode="shared", occupancy="warp", words=mb.NODE_WORDS, rows=331, param=0,
               ns_per_dependent_row=100.0),
          dict(mode="thread", occupancy="warp", words=mb.NODE_WORDS, rows=331, param=0,
               ns_per_dependent_row=250.0)]
    steps = [dict(kind=k, any_hit=a, occupancy=o, ns_per_step=ns)
             for k, a, o, ns in (("node", False, "warp", 40.0), ("leaf", False, "warp", 90.0),
                                 ("node", False, "full", 2.0))]
    arith, e = mb.step_arith_ns(steps)
    assert arith == 40.0 and e["kind"] == "node"
    assert mb.step_arith_ns([])[0] == 0.0
    # a group lane's share: one child of a node step, one triangle of a leaf
    assert mb.step_arith_ns(steps, per_lane=True)[0] == 40.0 / 8
    ms, _ = mb.split_floor(p1, 999, [(3, 1), (0, 2)], arith)
    assert abs(ms - max(3 * 140 + 290, 2 * 290) / 1e6) < 1e-15
    assert mb.split_floor(p1, 999, [(3, 1), (0, 2)])[0] < ms


def test_wrappers_refuse_cpu_tensors():
    _, table = _table()
    idx = torch.zeros(4, dtype=torch.int32)
    before = [k.launches for k in mb.KERNELS]
    with pytest.raises(ValueError):
        mb.chase_rows_cuda(table, idx, 3)
    with pytest.raises(ValueError):
        mb.gather_rows_cuda(table, idx)
    with pytest.raises(ValueError):
        mb.loop_only_cuda(torch.ones(4), 3)
    with pytest.raises(ValueError):
        mb.queue_fetch_cuda(8, "cpu")
    rows = mb.synthetic_step_rows(torch.Generator().manual_seed(0), "cpu")
    tab = torch.zeros((16, 12))
    for design in mb.TAKE_DESIGNS:
        with pytest.raises(ValueError):
            mb.gather_take_cuda(tab, idx, design)
    with pytest.raises(ValueError):
        mb.step_only_cuda(rows, _step_rays(rows, 4, 0), 3, node=True)
    for form in mb.QUEUE_FORMS:
        with pytest.raises(ValueError):
            mb.queue_fetch_cuda(8, "cpu", form)
    assert [k.launches for k in mb.KERNELS] == before


@pytest.mark.parametrize("call", [
    lambda: mb.gather_take_cuda(torch.zeros((16, 12)), torch.zeros(4, dtype=torch.int32),
                                "tma"),
    lambda: mb.queue_fetch_cuda(8, "cuda", "atomic"),
    lambda: mb.queue_fetch_cuda(8, "cuda", "memset", "half"),
    lambda: mb.queue_fetch_cuda(8, "cuda", "threshold"),
    lambda: mb.queue_fetch_cuda(8, "cuda", "work", items=(None, None, None)),
], ids=["gather_design", "queue_form", "queue_occupancy", "threshold_without_items",
        "items_without_threshold"])
def test_wrappers_refuse_unknown_designs(call):
    """Unknown designs, forms and occupancies, and items given to the wrong
    form, are refused before anything reaches a card."""
    before = [k.launches for k in mb.KERNELS]
    with pytest.raises(ValueError):
        call()
    assert [k.launches for k in mb.KERNELS] == before
