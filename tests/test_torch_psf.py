"""ops/psf.py, the game frame's path-space filter gather, on the CPU.

For CPU tensors ``psf.psf_gather`` takes its plain version: on a Cornell
32x32 frame's recorded grid and queries it equals, bit for bit, the gather
and accumulation the game tracer ran before the kernel
(``hashgrid.gather_neighbors`` with the accumulation written out below),
and launches nothing. ``chip_smoke.psf_walk`` models the kernel's walk
(cell-major slots k < min(count, MAX_PER_CELL), the hard tests in its
expression order, sums in slot order); it agrees with the plain version on
the edge cases the card test runs (cells with no row and with more than 16,
queries clipped at the grid's border, dead pixels, distances and normals
exactly on the tests' thresholds). Inputs of another dtype, shape or layout
raise.

The file imports no JAX: ``tests/test_torch_gpu.py`` takes its inputs and
helpers from here on the card's machine."""
import numpy as np
import pytest
import torch

import chip_smoke
from cudatracerlib_tpu_torch.models import game as tgame
from cudatracerlib_tpu_torch.ops import hashgrid, psf
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)

ACC_RTOL = 1e-6      # the kernel's slot-order float32 sums against the plain's


def game_frame_inputs(size, dev, frames=2):
    """(grid, p, ns, radius) of the last of `frames` GameTracer frames on
    the Cornell box at size x size on `dev`."""
    tr = tgame.GameTracer(tscenes.cornell_box(size, size).build(dev), size, size)
    with chip_smoke.RecordPsf(psf) as rec:
        tr.render(frames)
    return rec.calls[-1]


def edge_case_inputs(dev):
    """{name: (grid, p, ns, radius)}, seeded, on `dev`: a grid of 4,000 rows
    (300 invalid) over a 12^3 box in cells of 1, half the rows crowded into
    six cells (over 16 rows each), and queries that reach them
    ("overfull"), that reach only empty cells ("empty"), that lie up to
    0.3 outside the box, are clipped to its border cells and reach rows
    within 0.15 of its faces ("border"), at dead pixels
    (positions inf, -inf and NaN, the largest radius; "dead"), and rows
    placed exactly on the tests' thresholds: a row at distance r along an
    axis (d^2 == r^2, inside) and normals whose dot is 0.8 (outside) or
    just over ("exact")."""
    r = np.random.default_rng(20)
    n_rows, n_bad = 4000, 300
    pos = r.uniform(0.0, 12.0, (n_rows, 3)).astype(np.float32)
    hot = r.uniform(1.0, 11.0, (6, 3)).astype(np.float32)
    pos[: n_rows // 2] = (hot[r.integers(0, 6, n_rows // 2)]
                          + r.uniform(-0.3, 0.3, (n_rows // 2, 3))).astype(np.float32)
    pos[:, 2] = np.where(pos[:, 2] > 9.0, 9.0, pos[:, 2])   # z in [9, 12): no row
    pos[n_rows // 2: n_rows // 2 + 40] = r.uniform(0.0, 1.0, (40, 3))  # the corner
    nrm = r.normal(size=(n_rows, 3)).astype(np.float32)
    nrm[: n_rows // 2] = np.abs(nrm[: n_rows // 2]) * [0.1, 0.1, 1.0]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    # 200 rows within 0.15 of the faces x = 0, x = 12, y = 0, y = 12 and
    # z = 0, facing out of the box
    rb, n_face, face_rows = np.random.default_rng(21), 200, slice(2040, 2240)
    face = rb.integers(0, 5, n_face)
    axis, high = np.int64([0, 0, 1, 1, 2])[face], np.bool_([0, 1, 0, 1, 0])[face]
    at = np.arange(n_face)
    fpos = rb.uniform(1.0, 8.0, (n_face, 3))
    depth = rb.uniform(0.0, 0.15, n_face)
    fpos[at, axis] = np.where(high, 12.0 - depth, depth)
    out = np.zeros((n_face, 3))
    out[at, axis] = np.where(high, 1.0, -1.0)
    pos[face_rows], nrm[face_rows] = fpos, out
    li = r.uniform(0.0, 4.0, (n_rows, 3)).astype(np.float32)
    # the exact rows: at x + 0.5 of the query at (6.25, 6.25, 6.25), radius 0.5
    q0 = np.float32([6.25, 6.25, 6.25])
    pos[-4:] = q0 + np.float32([[0.5, 0, 0], [-0.5, 0, 0], [0, 0.5, 0], [0, 0, -0.25]])
    nrm[-4:] = np.float32([[0.8, 0.6, 0], [0.6, 0.8, 0], [1, 0, 0], [0.8, 0, 0.6]])
    valid = np.ones(n_rows, bool)
    valid[r.choice(n_rows - 4, n_bad, replace=False)] = False
    rows = np.concatenate([pos, li, nrm, np.zeros((n_rows, 3), np.float32)], 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    grid = hashgrid.build_grid(t(rows), t(pos), t(valid), t(np.zeros(3, np.float32)),
                               t(np.full(3, 12.0, np.float32)),
                               torch.tensor(1.0, device=dev))

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    nq = 1000
    # each border query lies 0.01-0.3 outside the face of a face row, at
    # most 0.1 beside it along the face: within 0.48 of the row
    src = rb.integers(0, n_face, nq)
    bq = fpos[src] + rb.uniform(-0.1, 0.1, (nq, 3)) * (out[src] == 0)
    u = rb.uniform(0.01, 0.3, nq)
    bq[np.arange(nq), axis[src]] = np.where(high[src], 12.0 + u, -u)
    cases = {
        "overfull": (hot[r.integers(0, 6, nq)] + r.uniform(-0.25, 0.25, (nq, 3)),
                     np.abs(r.normal(size=(nq, 3))) * [0.1, 0.1, 1.0],
                     r.uniform(0.2, 0.5, nq)),
        "empty": (r.uniform(0.5, 11.5, (nq, 3)) * [1, 1, 0] + [0, 0, 10.7],
                  r.normal(size=(nq, 3)), r.uniform(0.05, 0.5, nq)),
        "border": (bq, out[src] + rb.normal(0.0, 0.1, (nq, 3)),
                   rb.uniform(0.48, 0.5, nq)),
        "dead": (r.choice(np.float32([np.inf, -np.inf, np.nan]), (nq, 3)),
                 r.normal(size=(nq, 3)), np.full(nq, 0.5)),
        "exact": (np.repeat(q0[None], 4, 0),
                  np.float32([[1, 0, 0], [0, 1, 0], [0.8, 0.6, 0], [1, 0, 0]]),
                  np.float32([0.5, 0.5, 0.5, 0.25])),
    }
    return {name: (grid, t(np.asarray(p, np.float32)),
                   t(unit(np.asarray(n, np.float32)) if name != "exact"
                     else np.asarray(n, np.float32)), t(np.asarray(rad, np.float32)))
            for name, (p, n, rad) in cases.items()}


def assert_sums_agree(acc, cnt, ref_acc, ref_cnt, near, what=""):
    """cnt equal away from the tests' thresholds; acc within ACC_RTOL of
    the reference there (an exact 0 where the reference is 0)."""
    far = ~near
    assert torch.equal(cnt[far], ref_cnt[far]), what
    diff = (acc - ref_acc)[far].abs()
    assert bool((diff <= ACC_RTOL * ref_acc[far].abs()).all()), \
        (what, float(diff.max()) if diff.numel() else 0.0)


def old_game_gather(grid, p, ns, radius):
    """The game tracer's gather before ops/psf.py: hashgrid.gather_neighbors
    with models/game.py's accumulation, as it was written there."""
    B = p.shape[0]

    def accum(carry, prows, mask):
        acc, cnt = carry
        ok = mask & ((prows[..., 6:9] * ns[:, None, :]).sum(-1) > 0.8)
        return (acc + torch.where(ok[..., None], prows[..., 3:6], 0.0).sum(1),
                cnt + ok.to(torch.float32).sum(1))
    zero = torch.zeros(B, dtype=torch.float32)
    return hashgrid.gather_neighbors(grid, p, radius, accum,
                                     (torch.zeros((B, 3), dtype=torch.float32), zero))


def test_psf_gather_equals_old_path_cpu():
    """A Cornell 32x32 frame's recorded grid and queries: the wrapper on
    the CPU gives the old path's sums and counts bit for bit."""
    grid, p, ns, r = game_frame_inputs(32, "cpu")
    acc, cnt = psf.psf_gather(grid, p, ns, r)
    ref_acc, ref_cnt = old_game_gather(grid, p, ns, r)
    assert torch.equal(acc, ref_acc) and torch.equal(cnt, ref_cnt)
    assert float(cnt.sum()) > 1000      # the frame's queries find rows


def test_psf_gather_launches_nothing_on_cpu():
    before = psf.psf_gather.launches
    for grid, p, ns, r in edge_case_inputs("cpu").values():
        psf.psf_gather(grid, p, ns, r)
    game_frame_inputs(16, "cpu")
    assert psf.psf_gather.launches == before


@pytest.mark.parametrize("case", ["overfull", "empty", "border", "dead", "exact",
                                  "cornell"])
def test_kernel_walk_matches_plain(case):
    """The kernel's walk, modelled, against the plain version: counts equal
    and sums within ACC_RTOL (no query here lies near a threshold but the
    exact rows, which both decide alike); each case reaches what it is
    for."""
    grid, p, ns, r = (game_frame_inputs(32, "cpu") if case == "cornell"
                      else edge_case_inputs("cpu")[case])
    acc, cnt, near, slots = chip_smoke.psf_walk(grid, p, ns, r, psf)
    ref_acc, ref_cnt = psf.psf_gather_plain(grid, p, ns, r)
    assert torch.equal(cnt, ref_cnt)
    assert_sums_agree(acc, cnt, ref_acc, ref_cnt, torch.zeros_like(near), case)
    _, count = psf.neighbor_ranges(grid, p, r)
    if case == "overfull":
        assert float((count > 16).any(1).float().mean()) > 0.9
        assert float((cnt > 0).float().mean()) > 0.5
    elif case == "empty":
        assert int(slots.max()) == 0 and float(cnt.max()) == 0
    elif case == "border":
        outside = ((p < 0) | (p > 12)).any(1)
        assert bool(outside.all()) and int(slots.min()) > 0
        assert float((cnt > 0).float().mean()) > 0.5
    elif case == "dead":
        assert int(slots.max()) > 0 and float(cnt.max()) == 0
    elif case == "exact":
        # rows exactly at the radius and normal dots of exactly 0.8: both
        # walks decide them alike, and `near` flags them
        assert bool(near.any())
        assert cnt.tolist() == ref_cnt.tolist()
    else:
        assert float(cnt.mean()) > 0.5


@pytest.mark.parametrize("case", ["p_not_contiguous", "ns_float64", "radius_int",
                                  "radius_shape", "rows_of_16", "no_rows"])
def test_psf_gather_refuses(case):
    grid, p, ns, r = edge_case_inputs("cpu")["overfull"]
    if case == "p_not_contiguous":
        p = torch.cat([p, p], 1)[:, ::2]
    elif case == "ns_float64":
        ns = ns.double()
    elif case == "radius_int":
        r = r.to(torch.int32)
    elif case == "radius_shape":
        r = r[:, None]
    elif case == "rows_of_16":
        grid = grid._replace(data=torch.cat([grid.data, grid.data[:, :4]], 1))
    elif case == "no_rows":
        grid = grid._replace(data=grid.data[:0])
    with pytest.raises(ValueError):
        psf.psf_gather(grid, p, ns, r)
