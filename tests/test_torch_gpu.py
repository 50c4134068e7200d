"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
on the card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) The
kernels are built with -fmad=false and must agree with their plain
versions bit for bit: hits, visit lists, counts, step counts and flags.
K4, the pool traversal, must equal K1 on every field, for any order of
the rays. PrimTracer, LightTracer, BDPT, PPM and the volumetric path
tracer run on the card at 16x16 and are held to the same render on the
CPU; PPM's and VCM's 32x32 renders to their goldens. VCM, the light
tracer and the path tracer under the non-perspective sensors are held to
the CPU, WavefrontPT to the chunked path tracer on the card. The scenes
chip_smoke.py writes for the loader (cornell.xml, materials.xml with all
16 BSDF types, plain and regularized) load through the port's Mitsuba
loader and render on the card as on the CPU."""
import numpy as np
import pytest
import torch

from cudatracerlib_tpu_torch.models import tracer as ttracer
from cudatracerlib_tpu_torch.ops import traversal8, traversal_tt
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

N_RAYS = 4096 + 513


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


def _equal(a, b):
    pairs = [(x, y) for x, y in zip(a, b) if x is not None or y is not None]
    assert all(torch.equal(x, y) for x, y in pairs)


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(dev):
    """K1 on the Cornell table, rays inside the box."""
    r = np.random.default_rng(7)
    o = r.uniform(0.05, 0.95, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.full((N_RAYS,), 1e-4, device=dev),
                torch.full((N_RAYS,), 1e9, device=dev))
    amask = torch.from_numpy(r.random(N_RAYS) < 0.5).to(dev)
    table = tscenes.cornell_box(32, 32).build(dev).geom.wide
    for kw in ({}, dict(any_hit=True), dict(any_mask=amask)):
        a = traversal8.intersect_wide_cuda(table, rays, with_iters=True, **kw)
        b = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
        _equal((*a[0], a[1], a[2]), (*b[0], b[1], b[2]))


@pytest.mark.gpu
def test_treelet_kernels_match_plain_on_gpu(dev):
    """K2 and K3 on the 20,000-triangle San Miguel stand-in, camera rays,
    closest / any-hit / mixed, V = 6 and 3; K3's probe designs (cluster,
    split, walk), each at the probe's chunk and staging threshold and at
    chunks of 256 slots staging every segment, with its count of staged
    segments against the plain model's, and the cluster design again on
    the slots shuffled; then the whole treelet path (with its K1 fallback)
    against K1 on the unsplit table; last the cluster design on the table
    re-split into 256-, 1,024- and 2,048-row slabs (clusters of 1, 4 and 8
    blocks)."""
    from cudatracerlib_tpu_torch.scene import treelet
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe
    sc = tscenes.san_miguel_stand_in(64, 64, target_tris=20000).build(dev)
    geom = sc.geom
    top, slabs = geom.tt_top, geom.tt_slabs
    pix = torch.arange(4096, dtype=torch.int32, device=dev)
    # the wrappers take contiguous rays (camera rays share one origin view)
    rays = Rays(*(x.contiguous() for x in ttracer.gen_camera_rays(sc, pix, 0, 0, 64, 64)[0]))
    amask = torch.from_numpy(np.random.default_rng(1).random(4096) < 0.5).to(dev)
    splits = [(probe.CHUNK, probe.MIN_STAGE), (256, 1)]
    for kw in ({}, dict(any_hit=True), dict(any_mask=amask)):
        anyh = traversal8.any_lanes(4096, kw.get("any_hit", False),
                                    kw.get("any_mask"), dev)
        for V in (6, 3):
            k2 = traversal_tt.top_visits_cuda(top, rays, V, **kw)
            p2 = traversal_tt.top_visits(top, rays, V, **kw)
            _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
            _, keys, order, t_prune = traversal_tt.visit_slots(
                k2[0], k2[1], k2[3], slabs.shape[0], anyh)
            k3 = traversal_tt.treelet_hits_cuda(slabs, rays, t_prune, keys, order, V, **kw)
            p3 = traversal_tt.treelet_hits(slabs, rays, t_prune, keys, order, V, **kw)
            _equal((*k3[0], *k3[1:]), (*p3[0], *p3[1:]))
            for design in probe.K3_DESIGNS:
                for split in splits:
                    scratch = torch.empty(2, dtype=torch.int32, device=dev)
                    k3 = probe.treelet_hits(slabs, rays, t_prune, keys, order, V,
                                            design, *split, _scratch=scratch, **kw)
                    _equal((*k3[0], *k3[1:]), (*p3[0], *p3[1:]))
                    staged = probe.treelet_segments(keys, slabs.shape[0], *split)[3]
                    assert int(scratch[1]) == int(staged.sum())
            perm = torch.from_numpy(np.random.default_rng(V).permutation(
                keys.shape[0])).to(dev)
            k3 = probe.treelet_hits(slabs, rays, t_prune, keys[perm].contiguous(),
                                    order[perm].contiguous(), V, "cluster",
                                    256, 1, **kw)
            _equal((*k3[0], *k3[1:]), (*p3[0], *p3[1:]))
        ref = traversal8.intersect_wide_cuda(geom.wide, rays, **kw)
        for coherent in (True, False):
            ex = traversal8.intersect_treelet_exact(geom, rays, coherent=coherent, **kw)
            assert torch.equal(ex.tri >= 0, ref.tri >= 0)
            assert torch.equal(ex.t[~anyh], ref.t[~anyh])
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    wide = geom.wide.cpu().numpy()
    no_any = torch.zeros(4096, dtype=torch.bool, device=dev)
    for rows, blocks in ((256, 1), (1024, 4), (2048, 8)):
        part = treelet.partition(wide, treelet_rows=rows)
        assert part.slabs.shape[1] == rows
        assert probe.slab_variant(rows, limit) == blocks
        top_r = torch.from_numpy(part.top).to(dev)
        slabs_r = torch.from_numpy(part.slabs).to(dev)
        k2 = traversal_tt.top_visits_cuda(top_r, rays, 3)
        _, keys, order, t_prune = traversal_tt.visit_slots(
            k2[0], k2[1], k2[3], slabs_r.shape[0], no_any)
        p3 = traversal_tt.treelet_hits(slabs_r, rays, t_prune, keys, order, 3)
        for split in splits:
            k3 = probe.treelet_hits(slabs_r, rays, t_prune, keys, order, 3,
                                    "cluster", *split)
            _equal((*k3[0], *k3[1:]), (*p3[0], *p3[1:]))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_path_without_nee_on_gpu(dev):
    """Without NEE the camera rays (one shared origin view) go straight to
    the traversal kernels; the pass must run and match the CPU pass (mean
    relative error 1e-3: the card's transcendental functions may round a
    last bit differently and flip a rare roulette draw)."""
    from cudatracerlib_tpu_torch.models import path as tpath
    imgs = []
    for d in (dev, torch.device("cpu")):
        sc = tscenes.cornell_box(16, 16).build(d)
        imgs.append(tpath.PathTracer(sc, 16, 16, max_depth=3, use_nee=False)
                    .render(1).cpu())
    rel = float((imgs[0] - imgs[1]).abs().mean() / imgs[1].mean())
    assert rel < 1e-3, rel


@pytest.mark.gpu
def test_pool_kernel_matches_k1_on_gpu(dev):
    """K4 and the probe's K4 designs (thresholds 1, 8 and 16 idle lanes;
    K4's first design) against K1 and the plain version on veach-mis camera
    rays and random rays, a third of them dead (tmax -1), closest / any-hit
    / mixed, from both row sources (the table in shared memory by the size
    rule, and forced from device memory), and on the rays shuffled; each
    launch's lane steps (work_util) equal the steps' sum, its slots a
    multiple of 32 and no fewer, the rays it classified all of them and
    its live rays the plain model's (all of them for the first design, which
    steps the dead ones); K1's slots are the static schedule's."""
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe
    sc = tscenes.veach_mis(64, 64).build(dev)
    table = sc.geom.wide
    assert traversal8.launch_variant(table) == "shared"
    pix = torch.arange(4096, dtype=torch.int32, device=dev)
    cam = ttracer.gen_camera_rays(sc, pix, 0, 0, 64, 64)[0]
    r = np.random.default_rng(3)
    o = r.uniform(-3, 3, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = 4096 + N_RAYS
    tmax = torch.where(torch.from_numpy(r.random(B) < 1 / 3).to(dev), -1.0, 1e30)
    rays = Rays(torch.cat([cam.o, torch.from_numpy(o).to(dev)]),
                torch.cat([cam.d, torch.from_numpy(d).to(dev)]),
                torch.full((B,), 1e-4, device=dev), tmax.contiguous())
    live = int(traversal8.live_lanes(rays).sum())
    amask = torch.from_numpy(r.random(B) < 0.5).to(dev)
    perm = torch.from_numpy(r.permutation(B)).to(dev)
    shuffled = Rays(*(x[perm].contiguous() for x in rays))
    K4 = traversal8.intersect_wide_pool_cuda

    def designs():
        for variant in (None, "global"):
            yield f"k4 {variant}", lambda rr, kw, work=None, v=variant: K4(
                table, rr, with_iters=True, with_util=True, _variant=v,
                _scratch=work, **kw)
        for design in probe.POOL_DESIGNS:
            yield design, lambda rr, kw, work=None, d=design: probe.traverse_pool(
                table, rr, d, with_iters=True, with_util=True, _scratch=work, **kw)
    for kw, kw_s in (({}, {}), (dict(any_hit=True), dict(any_hit=True)),
                     (dict(any_mask=amask), dict(any_mask=amask[perm]))):
        k1 = traversal8.intersect_wide_cuda(table, rays, with_iters=True,
                                            with_util=True, **kw)
        p = traversal8.intersect_wide(table, rays, with_iters=True, with_util=True, **kw)
        _equal((*k1[0], k1[1], k1[2], k1[3]), (*p[0], p[1], p[2], p[3]))
        steps = int(p[1].sum())
        for name, run in designs():
            work = traversal8.group_work(0, dev)
            k4 = run(rays, kw, work)
            _equal((*k4[0], k4[1], k4[2]), (*p[0], p[1], p[2]))
            slots, active = traversal8.work_util(work).tolist()
            counts = [int(work[k]) for k in traversal8.GROUP_COUNTERS]
            assert active == steps and int(k4[3]) == slots, name
            assert slots % 32 == 0 and slots >= steps, name
            assert counts[3] == B and counts[1] == (B if name == "first" else live), name
            assert not work[traversal8.GROUP_WORK // 2:].any(), name
            ks = run(shuffled, kw_s)
            un = [None if x is None else torch.empty_like(x).index_copy_(0, perm, x)
                  for x in (*ks[0], ks[1], ks[2])]
            _equal(un, (*p[0], p[1], p[2]))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_microbench_kernels_match_plain_on_gpu(dev):
    from cudatracerlib_tpu_torch.utils import microbench as mb
    res = mb.measure(dev, table_rows=(331, 4096), gathers=65536, loop_steps=512,
                     queue_items=(65536,), step_iters=32)
    assert mb.max_abs_err(res) == 0, res


@pytest.mark.gpu
def test_p2_gather_designs_match_plain_on_gpu(dev):
    """P2 (a)'s designs (thread, flat, bulk) against the port's own gather
    bit for bit: the hash grid's run stream (clamped runs included) and a
    random stream at rows of 12 float32, whole and cut to lengths that are
    not a multiple of the bulk design's 128-row tiles (4,097, 1, none);
    rows of 4, 8 and 16 float32, which every design refuses; each
    launch counted under its design (an empty index launches nothing)."""
    from cudatracerlib_tpu_torch.utils import microbench as mb
    gen = torch.Generator(device=dev).manual_seed(9)
    before = dict(mb.gather_take_cuda.launches_by_design)
    for name, (table, idx) in mb.synthetic_take_calls(gen, dev, queries=777,
                                                      rows=5000).items():
        for n in (idx.shape[0], 4097, 1, 0):
            i = idx[:n]
            ref = mb.gather_take(table, i)
            for design in mb.TAKE_DESIGNS:
                got = mb.gather_take_cuda(table, i, design)
                assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
                    (name, n, design)
    for W in (4, 8, 16):
        table = torch.rand((3000, W), generator=gen, device=dev)
        i = torch.randint(0, 3000, (1000,), generator=gen, dtype=torch.int32, device=dev)
        for design in mb.TAKE_DESIGNS:
            with pytest.raises(ValueError):
                mb.gather_take_cuda(table, i, design)
    after = mb.gather_take_cuda.launches_by_design
    assert [after[d] - before[d] for d in mb.TAKE_DESIGNS] == [6, 6, 6]
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_step_only_matches_plain_on_gpu(dev):
    """P2 (b)'s kernel, a traversal step on a row held in registers, in
    every kind (node or leaf row, closest or any-hit) against the plain
    version bit for bit (each lane's last origin and direction, the xor of
    its steps' results), in blocks of 32 and 128 threads, on random rows
    and on the Cornell table's root and a leaf row under it, 1,000 lanes
    of 33 steps; other block sizes are refused."""
    from cudatracerlib_tpu_torch.utils import microbench as mb
    gen = torch.Generator(device=dev).manual_seed(6)
    table = tscenes.cornell_box(32, 32).build(dev).geom.wide
    for rows in (mb.synthetic_step_rows(gen, dev), mb.table_step_rows(table)):
        rays = mb.step_rays(rows, 1000, gen)
        for kind, any_hit in mb.STEP_KINDS:
            node = kind == "node"
            ref = mb.step_only(rows, rays, 33, node, any_hit)
            for threads in (32, 128):
                od, acc = mb.step_only_cuda(rows, rays, 33, node, any_hit, threads)
                assert torch.equal(od.view(torch.int32), ref[0].view(torch.int32)), kind
                assert torch.equal(acc, ref[1]), (kind, any_hit, threads)
        assert mb.step_only_blocks(True, False) > 0 and mb.step_only_blocks(False, True) > 0
    with pytest.raises(ValueError):
        mb.step_only_cuda(rows, rays, 3, True, threads=64)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_p3_forms_match_plain_on_gpu(dev, monkeypatch):
    """P3 in every form and occupancy: every item handed out once, and the
    threshold form's payload equal to queue_threshold's, on queues of 1,
    31, 1,000 and 131,073 items (the threshold form with no, 40% and all
    items dead); the set of the stream's work area that the next launch
    takes is zero after each launch. A launch the card refuses (a stand-in
    library that returns an error) drops the stream's work area, so the
    next launch starts on zeros and hands every item out once."""
    from cudatracerlib_tpu_torch.utils import microbench as mb
    gen = torch.Generator(device=dev).manual_seed(4)
    half = traversal8.GROUP_WORK // 2
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    for occupancy in mb.QUEUE_OCCUPANCIES:
        for n in (1, 31, 1000, 131073):
            for form in ("memset", "work"):
                counts, out, claims, stats = mb.queue_fetch_cuda(n, dev, form, occupancy)
                assert torch.equal(counts, torch.ones_like(counts)), (form, occupancy, n)
                assert out is None and stats is None and int(claims) >= -(-n // 32)
            for dead in (0.0, 0.4, 1.0):
                items = mb.synthetic_queue_items(n, gen, dev, dead)
                counts, out, claims, stats = mb.queue_fetch_cuda(n, dev, "threshold",
                                                                 occupancy, items)
                want_counts, want = mb.queue_threshold(*items)
                assert torch.equal(counts, want_counts), (occupancy, n, dead)
                assert torch.equal(out.view(torch.int32), want.view(torch.int32))
                assert int(stats[0]) == int(claims) > 0
                assert 0 < int(stats[1]) <= int(stats[2])
            work, next_set = traversal8._group_work[key]
            assert not work[next_set * half:(next_set + 1) * half].any()
    real = mb._lib()

    class Refusing:
        def __getattr__(self, name):
            return getattr(real, name)

        def ctl_queue_fetch(self, *args):
            return 1    # cudaErrorInvalidValue: the launch did not run

    monkeypatch.setattr(mb, "_lib", lambda: Refusing())
    with pytest.raises(RuntimeError):
        mb.queue_fetch_cuda(64, dev, "work")
    assert key not in traversal8._group_work
    monkeypatch.undo()
    counts = mb.queue_fetch_cuda(4099, dev, "work")[0]
    assert torch.equal(counts, torch.ones_like(counts))
    torch.cuda.synchronize()


def _big_top(dev):
    """(top table over one block's shared memory, the scene): the
    800,000-triangle San Miguel stand-in's table split with 128-row
    treelets, which gives a 568-row top (K2's split variant)."""
    from cudatracerlib_tpu_torch.scene import treelet
    sc = tscenes.san_miguel_stand_in(64, 64, target_tris=800_000).build(dev)
    part = treelet.partition(sc.geom.wide.cpu().numpy(), treelet_rows=128)
    return torch.from_numpy(part.top).to(dev), sc


@pytest.mark.gpu
def test_k2_cluster_designs_match_plain_on_gpu(dev):
    """Every K2 design on a top table of over 454 rows against the plain
    version bit for bit (hits, visit lists, counts, min-dropped t, steps,
    flags), closest / any-hit / mixed, at V = 6 and 3, with per-lane roots
    (row 0 or one of its node children) and a third of the lanes dead
    (tmax -1): the split variant the rule picks, the probe's cluster design
    over 2, 4 and 8 blocks, and the probe's global design (one thread per
    ray). One block cannot hold the table: the cluster design forced onto
    one, or the shared variant's designs, raise. The rule's launches count
    under "split"."""
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe
    top, _ = _big_top(dev)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert top.shape[0] > limit // 512
    assert traversal_tt.launch_top_variant(top) == "split"
    assert traversal_tt.top_variant(top.shape[0], limit) == "split"
    assert probe.slab_variant(top.shape[0], limit) == 2
    r = np.random.default_rng(17)
    o = r.uniform([-16, 0.3, -10], [16, 5, 10], (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(N_RAYS) % 3 == 1, -1.0, 1e9).astype(np.float32)
    rays = Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.full((N_RAYS,), 1e-4, device=dev), torch.from_numpy(tmax).to(dev))
    links = top[0, 48:56].contiguous().view(torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), links[links >= 0]])
    roots = starts[torch.from_numpy(r.integers(0, starts.numel(), N_RAYS)).to(dev)]
    amask = torch.from_numpy(r.random(N_RAYS) < 0.5).to(dev)
    K2 = traversal_tt.top_visits_cuda
    before = dict(K2.launches_by_variant)
    for kw in ({}, dict(any_hit=True), dict(any_mask=amask)):
        for V in (6, 3):
            for rk in ({}, dict(roots=roots.contiguous())):
                p2 = traversal_tt.top_visits(top, rays, V, **kw, **rk)
                runs = [K2(top, rays, V, **kw, **rk),
                        probe.top_visits(top, rays, V, "global", **kw, **rk)]
                runs += [probe.top_visits(top, rays, V, "cluster", n, **kw, **rk)
                         for n in (None, 4, 8)]
                for k2 in runs:
                    _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
    assert K2.launches_by_variant["split"] - before["split"] == 12
    with pytest.raises(RuntimeError):
        probe.top_visits(top, rays, 3, "cluster", 1)
    with pytest.raises(RuntimeError):
        probe.top_visits(top, rays, 3, "stride")
    # a refused launch zeroed no counter set: the set the stream's next
    # launch takes is still zero (a group-design launch that started on
    # counts would skip rays or wait for ever)
    half = traversal8.GROUP_WORK // 2
    for work, count_set in traversal8._group_work.values():
        assert not work[count_set * half:(count_set + 1) * half].any()
    k2, p2 = K2(top, rays, 3), traversal_tt.top_visits(top, rays, 3)
    _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_p1_modes_match_plain_on_gpu(dev):
    """P1 in every mode (thread, shared, group with 8, 16 and 32 lanes,
    cluster over 1, 2, 4 and 8 blocks, bulk), reading whole rows and a node
    step's 14 float4, against the plain chase_rows, at both occupancies
    and at an odd chain count, on tables of 331 and 998 rows (shared and
    1-2 block clusters refuse 998 rows)."""
    from cudatracerlib_tpu_torch.utils import microbench as mb
    gen = torch.Generator(device=dev).manual_seed(5)
    runs = [("thread", None), ("shared", None), ("bulk", None)] \
        + [("group", g) for g in mb.GROUP_LANES] \
        + [("cluster", n) for n in mb.CLUSTER_BLOCKS]
    for rows in (331, 998):
        table = mb._random_table(rows, gen, dev)
        for chains, lanes, threads in ((1024, None, 128), (133, 32, 32), (77, None, 64)):
            idx0 = mb._random_idx(chains, rows, gen, dev)
            for words in (mb.ROW_WORDS, mb.NODE_WORDS):
                ref = mb.chase_rows(table, idx0, 37, words=words)
                for mode, param in runs:
                    fits = not (mode == "shared" and rows > 454) and not (
                        mode == "cluster" and -(-rows // param) > 454)
                    if not fits:
                        with pytest.raises(ValueError):
                            mb.chase_rows_cuda(table, idx0, 37, mode, param, lanes,
                                               threads, words)
                        continue
                    got = mb.chase_rows_cuda(table, idx0, 37, mode, param, lanes,
                                             threads, words)
                    assert torch.equal(got, ref), (rows, chains, mode, param, words)
    entries = mb.chase_entries(mb._random_table(998, gen, dev), gen, 132)
    assert {e["mode"] for e in entries} == set(mb.CHASE_MODES) - {"shared"}
    assert {e["words"] for e in entries} == {mb.ROW_WORDS, mb.NODE_WORDS}
    assert max(e["max_abs_err"] for e in entries) == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_table_variants_match_plain_on_gpu(dev):
    """K1's variants (shared table, forced global), K2's (shared table,
    forced split) and the designs of utils/schedule_probe.py (static
    stride, stacks in shared memory; for K2 also a cluster of one block and
    one thread per ray) against the plain versions, closest / any-hit /
    mixed: K1 on the Cornell table (shared by the size rule) and on the
    20,000-triangle San Miguel table (global by the rule, refused when
    forced shared), K2 on that scene's top table at V = 6 and 3."""
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe
    r = np.random.default_rng(11)
    o = r.uniform(0.05, 0.95, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.full((N_RAYS,), 1e-4, device=dev),
                torch.full((N_RAYS,), 1e9, device=dev))
    amask = torch.from_numpy(r.random(N_RAYS) < 0.5).to(dev)
    cornell = tscenes.cornell_box(32, 32).build(dev).geom.wide
    geom = tscenes.san_miguel_stand_in(64, 64, target_tris=20000).build(dev).geom
    assert traversal8.launch_variant(cornell) == "shared"
    assert traversal8.launch_variant(geom.wide) == "global"
    assert traversal8.launch_variant(geom.tt_top) == "shared"
    K1, K2 = traversal8.intersect_wide_cuda, traversal_tt.top_visits_cuda
    for kw in ({}, dict(any_hit=True), dict(any_mask=amask)):
        for table in (cornell, geom.wide):
            p = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
            for variant in (None, "global"):
                k = K1(table, rays, with_iters=True, _variant=variant, **kw)
                _equal((*k[0], k[1], k[2]), (*p[0], p[1], p[2]))
            if table is cornell:
                for design in probe.DESIGNS:
                    k = probe.traverse8(table, rays, design, with_iters=True, **kw)
                    _equal((*k[0], k[1], k[2]), (*p[0], p[1], p[2]))
        for V in (6, 3):
            p2 = traversal_tt.top_visits(geom.tt_top, rays, V, **kw)
            for variant in (None, "split"):
                k2 = K2(geom.tt_top, rays, V, _variant=variant, **kw)
                _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
            for design in probe.TOP_DESIGNS:
                k2 = probe.top_visits(geom.tt_top, rays, V, design, **kw)
                _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
    with pytest.raises(RuntimeError):
        K1(geom.wide, rays, _variant="shared")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_k1_global_design_matches_plain_on_gpu(dev):
    """K1's global variant in both designs (one thread per ray; dead lanes
    written without a row read and live rays from a queue, one group of
    lanes each: 16 as kept, 8 and 32 through utils/schedule_probe.py)
    against the plain version, closest / any-hit / mixed, on the
    20,000-triangle San Miguel table (global by the size rule), on
    chip_smoke.py's edge batches: every lane dead, one live lane in 65,536,
    NaN tmin or tmax, tmin = tmax = 0, a 2-entry stack that overflows, a
    5-step and a 0-step cap, one ray, per-lane roots with half the lanes
    dead. The group design's live count equals the plain model's
    (traversal8.live_lanes); the probe also runs 16 lanes with an L2
    prefetch of eligible children. Then the treelet path's fallback takes
    the group design."""
    import chip_smoke
    r = np.random.default_rng(13)
    o = r.uniform([-16, 0.3, -10], [16, 5, 10], (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.full((N_RAYS,), 1e-4, device=dev),
                torch.full((N_RAYS,), 1e9, device=dev))
    sc = tscenes.san_miguel_stand_in(64, 64, target_tris=20000).build(dev)
    table = sc.geom.wide
    assert traversal8.launch_variant(table) == "global"
    K1 = traversal8.intersect_wide_cuda
    run = chip_smoke.k1_global_runner(K1, traversal8)
    for name, rr, kw in chip_smoke.k1_edge_batches(table, rays, 65536, seed=3):
        errs = chip_smoke.check_edge_batch(name, table, rr, kw, K1, traversal8, run)
        assert max(errs.values()) == 0.0, name
    # the stream's work area: the counter set its next launch takes is zero
    for work, count_set in traversal8._group_work.values():
        half = traversal8.GROUP_WORK // 2
        assert not work[count_set * half:(count_set + 1) * half].any()
    before = dict(K1.launches_by_design)
    pix = torch.arange(4096, dtype=torch.int32, device=dev)
    cam = ttracer.gen_camera_rays(sc, pix, 0, 0, 64, 64)[0]
    cam = Rays(*(x.contiguous() for x in cam))
    traversal8.intersect_treelet_exact(sc.geom, cam, coherent=True)
    assert K1.launches_by_design["group"] == before["group"] + 1
    assert K1.launches_by_design["thread"] == before["thread"]
    torch.cuda.synchronize()


def _card_and_cpu(tracer_cls, scene_fn, size, passes, **kw):
    """The same tracer run on the card and on the CPU: (card image, CPU
    image, K1 launches on the card)."""
    imgs = []
    for d in (torch.device("cuda"), torch.device("cpu")):
        before = traversal8.intersect_wide_cuda.launches
        tr = tracer_cls(scene_fn(size, size).build(d), size, size, **kw)
        imgs.append(tr.render(passes).cpu().numpy())
        if d.type == "cuda":
            launches = traversal8.intersect_wide_cuda.launches - before
    return imgs[0], imgs[1], launches


def _rel(a, b):
    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-9))


@pytest.mark.gpu
def test_prim_on_gpu(dev):
    """PrimTracer in a first-hit and a first-non-delta mode: one K1 launch
    per pass for the first, seven for the walk through the glass; the card
    image within 1e-5 of the CPU image."""
    from cudatracerlib_tpu_torch.models import prim as tprim
    for mode, launches in ((tprim.D_NORMAL_SHADE, 1), (tprim.D_ND_DEPTH, 7)):
        card, cpu, n = _card_and_cpu(tprim.PrimTracer, tscenes.cornell_glass, 16, 1,
                                     draw_mode=mode)
        assert n == launches and np.isfinite(card).all()
        assert _rel(card, cpu) < 1e-5, (mode, _rel(card, cpu))


@pytest.mark.gpu
def test_light_tracer_on_gpu(dev):
    """LightTracer, 16x16, depth 4, 2 passes: 1 + 2 * 4 K1 launches per
    pass; the card image within a mean relative error of 1e-5 of the CPU
    image, as chip_smoke.py holds it (CARD_CPU_LIMIT: the splats' atomic
    adds run in any order; the readings there lie near 1e-7)."""
    from cudatracerlib_tpu_torch.models import lighttracer as tlt
    card, cpu, n = _card_and_cpu(tlt.LightTracer, tscenes.cornell_glass, 16, 2,
                                 max_depth=4)
    assert n == 2 * (1 + 2 * 4) and np.isfinite(card).all() and card.mean() > 0
    assert _rel(card, cpu) < 1e-5, _rel(card, cpu)


@pytest.mark.gpu
def test_bdpt_on_gpu(dev):
    """BDPT on the glass Cornell box, 16x16, depth 3, 2 passes: 10 + 7 * 3
    K1 launches per pass; the card image within a mean relative error of
    1e-5 of the CPU image (as the light tracer's)."""
    from cudatracerlib_tpu_torch.models import bdpt as tbdpt
    card, cpu, n = _card_and_cpu(tbdpt.BDPT, tscenes.cornell_glass, 16, 2, max_depth=3)
    assert n == 2 * (2 * tbdpt.NUM_LIGHT_V + (2 + tbdpt.NUM_LIGHT_V) * 3)
    assert np.isfinite(card).all() and card.mean() > 0
    assert _rel(card, cpu) < 1e-5, _rel(card, cpu)


# the fog renders' card-vs-CPU limits, as chip_smoke.py's (PPM's gather
# kernels follow the card's camera rays, within 1.8e-7 of the CPU's)
PPM_LIMIT = 1e-4
PT_LIMIT = 1e-5
# the game tracer's limit: a neighbour crossing one of its hard tests moves
# its pixel by ~1/30 of itself, 1/256 of the image at 16x16 (chip_smoke.py
# holds 1e-4 at 32x32); the adaptive tracer's is the path tracer's, as
# chip_smoke.py's ADAPT_CARD_CPU_LIMIT
GAME_LIMIT = 1e-3
ADAPT_LIMIT = 1e-5


@pytest.mark.gpu
def test_ppm_golden_on_gpu(dev):
    """PPM on Cornell 32x32, depth 4, 6 passes against
    tests/goldens/cornell_32_ppm.npz (mean relative error < 0.02); 2 * 4
    closest-hit K1 launches per pass."""
    import os
    from cudatracerlib_tpu_torch.models import ppm as tppm
    before = traversal8.intersect_wide_cuda.launches
    tr = tppm.PPMTracer(tscenes.cornell_box(32, 32).build(dev), 32, 32, max_depth=4,
                        initial_radius=0.08)
    img = tr.render(6).cpu().numpy()
    assert traversal8.intersect_wide_cuda.launches - before == 6 * 8
    ref = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                               "cornell_32_ppm.npz"))["img"]
    assert _rel(img, ref) < 0.02, _rel(img, ref)


@pytest.mark.gpu
def test_media_on_gpu(dev):
    """PPM (beamgrid) and the volumetric path tracer on fog_cornell 16x16,
    depth 4, 2 passes: K1 launches per pass as the code traces them (PPM 2 *
    4 closest-hit; the path tracer 4 closest-hit and 4 any-hit); the card
    images within PPM_LIMIT and PT_LIMIT of the CPU images."""
    from cudatracerlib_tpu_torch.models import path as tpath
    from cudatracerlib_tpu_torch.models import ppm as tppm
    for cls, limit in ((tppm.PPMTracer, PPM_LIMIT), (tpath.PathTracer, PT_LIMIT)):
        card, cpu, n = _card_and_cpu(cls, tscenes.fog_cornell, 16, 2, max_depth=4)
        assert n == 2 * 8 and np.isfinite(card).all() and card.mean() > 0
        assert _rel(card, cpu) < limit, (cls.__name__, _rel(card, cpu))


# VCM's card-vs-CPU limit at 16x16: its merge counts a photon by a hard
# radius test, and a camera hit that moves by ~1e-6 on the card can carry
# one photon across it. chip_smoke.py read one pixel moved by 2.3% at
# 32x32 (1.99e-5 of the image); at 16x16 such a pixel is ~1e-4 of the
# image, so the limit allows ~10 such crossings
VCM_LIMIT = 1e-3


@pytest.mark.gpu
def test_vcm_on_gpu(dev):
    """VCM on Cornell 32x32, depth 4, 4 passes against
    tests/goldens/cornell_32_vcm.npz (mean relative error < 0.02) with
    (5 + 4) + (5 + 4 * 6) K1 launches per pass; on the glass Cornell box
    16x16, depth 3, 2 passes, within VCM_LIMIT of the CPU image."""
    import os
    from cudatracerlib_tpu_torch.models import vcm as tvcm
    before = traversal8.intersect_wide_cuda.launches
    img = tvcm.VCM(tscenes.cornell_box(32, 32).build(dev), 32, 32,
                   max_depth=4).render(4).cpu().numpy()
    assert traversal8.intersect_wide_cuda.launches - before == 4 * (9 + 29)
    ref = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                               "cornell_32_vcm.npz"))["img"]
    assert _rel(img, ref) < 0.02, _rel(img, ref)
    card, cpu, n = _card_and_cpu(tvcm.VCM, tscenes.cornell_glass, 16, 2, max_depth=3)
    assert n == 2 * (2 * tvcm.NUM_LIGHT_V + (2 + tvcm.NUM_LIGHT_V) * 3)
    assert np.isfinite(card).all() and card.mean() > 0
    assert _rel(card, cpu) < VCM_LIMIT, _rel(card, cpu)


@pytest.mark.gpu
def test_wavefront_on_gpu(dev):
    """WavefrontPT on Cornell 32x32, depth 4, 768 lanes, 2 passes, against
    the chunked PathTracer on the card: the images within rtol 1e-5 / atol
    1e-7, the live rays equal, one K1 launch per loop iteration and one
    host read per iteration plus the last."""
    from cudatracerlib_tpu_torch.models import film as tfilm
    from cudatracerlib_tpu_torch.models import path as tpath
    from cudatracerlib_tpu_torch.models import wavefront as twf
    scene = tscenes.cornell_box(32, 32).build(dev)
    pt = tpath.PathTracer(scene, 32, 32, max_depth=4, chunk_size=32 * 32)
    i1 = pt.render(2).cpu().numpy()
    wf = twf.WavefrontPT(scene, 32, 32, max_depth=4, lanes=768)
    wf.do_pass()
    before = traversal8.intersect_wide_cuda.launches
    wf.do_pass()
    assert traversal8.intersect_wide_cuda.launches - before == wf.last_pass_iters
    assert wf.last_pass_host_reads == wf.last_pass_iters + 1
    i2 = tfilm.develop(wf.film).cpu().numpy()
    np.testing.assert_allclose(i2, i1, rtol=1e-5, atol=1e-7)
    assert wf.rays_traced_live == pt.rays_traced_live
    assert wf._ovf_dev.tolist() == [0, 0]


def _sensor_scene(sensor_type, size, **kw):
    """tests/test_lighttracer.py's sensor scene: a floor under a small area
    light."""
    from cudatracerlib_tpu_torch.scene import host, sensors, shapes
    from cudatracerlib_tpu_torch.utils import transforms as tf
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(shapes.rectangle(), white,
                   tf.compose(tf.translate([0, -1, 0]), tf.rotate_deg([1, 0, 0], -90),
                              tf.scale(3)))
    sc.create_node(shapes.rectangle(), black,
                   tf.compose(tf.translate([0, 1.5, 0]), tf.rotate_deg([1, 0, 0], 90),
                              tf.scale(0.5)), emission=(8.0, 8.0, 8.0))
    sc.set_sensor(sensors.make_sensor(sensor_type, tf.look_at([0, 0.6, -2.5], [0, -0.6, 0]),
                                      fov_x_deg=50, film_w=size, film_h=size, **kw))
    return sc


@pytest.mark.gpu
def test_sensors_on_gpu(dev):
    """The light tracer and the path tracer at 16x16, depth 3, 2 passes,
    under the spherical, orthographic, telecentric and thin-lens sensors:
    the card images within 1e-5 of the CPU images (the light tracer's
    limit)."""
    from cudatracerlib_tpu_torch.models import lighttracer as tlt
    from cudatracerlib_tpu_torch.models import path as tpath
    from cudatracerlib_tpu_torch.scene import schema
    for st, kw in ((schema.SENSOR_SPHERICAL, {}),
                   (schema.SENSOR_ORTHOGRAPHIC, dict(ortho_scale=(2.0, 2.0))),
                   (schema.SENSOR_TELECENTRIC, dict(ortho_scale=(2.0, 2.0),
                                                    aperture_radius=0.05,
                                                    focus_distance=2.5)),
                   (schema.SENSOR_THINLENS, dict(aperture_radius=0.05,
                                                 focus_distance=2.5))):
        for cls in (tlt.LightTracer, tpath.PathTracer):
            card, cpu, n = _card_and_cpu(
                cls, lambda w, h: _sensor_scene(st, w, **kw), 16, 2, max_depth=3)
            assert n > 0 and np.isfinite(card).all() and card.mean() > 0
            assert _rel(card, cpu) < 1e-5, (st, cls.__name__, _rel(card, cpu))


@pytest.mark.gpu
def test_game_on_gpu(dev):
    """GameTracer on Cornell 16x16, 3 frames: two K1 launches a frame
    (camera rays, shadow rays) and one psf_gather launch; the card image
    within GAME_LIMIT of the CPU image."""
    from cudatracerlib_tpu_torch.models import game as tgame
    from cudatracerlib_tpu_torch.ops import psf
    before = psf.psf_gather.launches
    card, cpu, n = _card_and_cpu(tgame.GameTracer, tscenes.cornell_box, 16, 3)
    assert n == 2 * 3 and np.isfinite(card).all() and card.mean() > 0
    assert psf.psf_gather.launches - before == 3      # one filter launch a frame
    assert _rel(card, cpu) < GAME_LIMIT, _rel(card, cpu)


@pytest.mark.gpu
def test_psf_gather_matches_plain_on_gpu(dev):
    """csrc/psf_gather.cu against its plain version on the card, on the
    edge cases of tests/test_torch_psf.py (cells with no row and with more
    than 16, queries clipped at the grid's border, dead pixels, rows
    exactly on the hard tests' thresholds) and a Cornell 64x64 frame's
    recorded grid and queries: counts equal where no walked slot lies
    within 2 ulp of a threshold (everywhere on the exact rows, whose tests
    no order of the sums moves), sums within ACC_RTOL relative there; one
    launch a call."""
    from cudatracerlib_tpu_torch.ops import psf
    import chip_smoke
    from test_torch_psf import assert_sums_agree, edge_case_inputs, game_frame_inputs
    before = psf.psf_gather.launches
    cases = dict(edge_case_inputs(dev), cornell_64=game_frame_inputs(64, dev))
    assert psf.psf_gather.launches - before == 2          # the frame's two passes
    for name, (grid, p, ns, r) in cases.items():
        acc, cnt = psf.psf_gather(grid, p, ns, r)
        ref_acc, ref_cnt = psf.psf_gather_plain(grid, p, ns, r)
        near = chip_smoke.psf_walk(grid, p, ns, r, psf)[2]
        assert_sums_agree(acc, cnt, ref_acc, ref_cnt, near, name)
        if name == "exact":
            assert torch.equal(cnt, ref_cnt)
        if name in ("overfull", "border", "cornell_64"):
            assert float(ref_cnt.sum()) > 0, name
    assert psf.psf_gather.launches - before == 2 + len(cases)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_adaptive_on_gpu(dev):
    """AdaptivePathTracer on veach-mis 16x16 (one block), 4 blocks a pass
    (the block repeats: duplicate pixels in the film and the variance
    buffer), depth 3, 4 passes: 4 K1 launches a pass; the card image within
    ADAPT_LIMIT of the CPU image."""
    from cudatracerlib_tpu_torch.models import adaptive as tad
    card, cpu, n = _card_and_cpu(tad.AdaptivePathTracer, tscenes.veach_mis, 16, 4,
                                 max_depth=3, blocks_per_pass=4)
    assert n == 4 * 4 and np.isfinite(card).all() and card.mean() > 0
    assert _rel(card, cpu) < ADAPT_LIMIT, _rel(card, cpu)


@pytest.mark.gpu
def test_sequence_samplers_on_gpu(dev):
    """PathTracer with the stratified and Sobol' samplers on Cornell
    16x16, depth 4, 2 passes: the card image within 1e-5 of the CPU
    image."""
    from cudatracerlib_tpu_torch.models import path as tpath
    for st in (1, 2):
        card, cpu, n = _card_and_cpu(tpath.PathTracer, tscenes.cornell_box, 16, 2,
                                     max_depth=4, sampler_type=st)
        assert n == 2 * 5 and np.isfinite(card).all() and card.mean() > 0
        assert _rel(card, cpu) < PT_LIMIT, (st, _rel(card, cpu))


def _inst_scene(size, n_spheres=5):
    """tests/test_instancing.py `_scene` (five nodes sharing one sphere: a
    two-level scene of six instances) through the port."""
    from cudatracerlib_tpu_torch.scene import host, schema, sensors, shapes
    from cudatracerlib_tpu_torch.utils import transforms as tf
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    red = sc.add_material(host.MaterialSpec(reflectance=(0.6, 0.1, 0.1)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    rect = shapes.rectangle()
    sc.create_node(rect, white, tf.compose(tf.translate([0, -1, 0]),
                                           tf.rotate_deg([1, 0, 0], -90), tf.scale(4.0)))
    sc.create_node(rect, black, tf.compose(tf.translate([0, 2.5, 0]),
                                           tf.rotate_deg([1, 0, 0], 90)),
                   emission=(10.0, 10.0, 10.0))
    ball = shapes.sphere(radius=0.4, n_theta=12, n_phi=24)
    for i in range(n_spheres):
        sc.create_node(ball, red if i % 2 else white,
                       tf.compose(tf.translate([-1.6 + i * 0.8, -0.6, 0.3 * (i % 3)]),
                                  tf.scale(0.8 + 0.1 * i)))
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0.5, -4.5], [0, -0.3, 0]),
        fov_x_deg=40.0, film_w=size, film_h=size))
    return sc


def _forest(scene, dev):
    """The instanced scene's BLAS forest split under forced small limits
    (max_top_rows=16, treelet_rows=128), with each instance's top-local
    root: the treelet BLAS route on a small scene."""
    from cudatracerlib_tpu_torch.scene import treelet
    geom = scene.geom
    roots = geom.inst.root.cpu().numpy()
    uroots = tuple(int(r) for r in np.unique(roots))
    part = treelet.partition(geom.wide.cpu().numpy(), treelet_rows=128,
                             max_top_rows=16, roots=uroots)
    r2t = {r: int(t) for r, t in zip(uroots, part.root_top)}
    root_top = torch.tensor([r2t[int(r)] for r in roots], dtype=torch.int32, device=dev)
    return geom._replace(tt_top=torch.from_numpy(part.top).to(dev),
                         tt_slabs=torch.from_numpy(part.slabs).to(dev),
                         tt_vid=torch.from_numpy(part.vid_map).to(dev),
                         inst=geom.inst._replace(root_top=root_top)), part


@pytest.mark.gpu
def test_instanced_golden_on_gpu(dev):
    """The instanced golden (tests/goldens/instanced_48_pt.npz, < 0.02) from
    the card, and the instanced path tracer at 16x16 within PT_LIMIT of the
    CPU: K1 with per-lane roots, six launches (one per instance) per
    traversal."""
    import os
    from cudatracerlib_tpu_torch.models import path as tpath
    inst = _inst_scene(48).build(dev)
    assert inst.geom.inst is not None and inst.geom.inst.tlas is None
    img = tpath.PathTracer(inst, 48, 48, max_depth=4).render(8).cpu().numpy()
    ref = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                               "instanced_48_pt.npz"))["img"]
    assert _rel(img, ref) < 0.02, _rel(img, ref)
    card, cpu, n = _card_and_cpu(tpath.PathTracer, lambda w, h: _inst_scene(w), 16, 2,
                                 max_depth=4)
    # 4 merged traversals and one shadow flush a pass, 6 instances each
    assert n == 2 * 5 * 6 and np.isfinite(card).all() and card.mean() > 0
    assert _rel(card, cpu) < PT_LIMIT, _rel(card, cpu)


@pytest.mark.gpu
def test_wavefront_instanced_on_gpu(dev):
    """WavefrontPT on the instanced scene at 16x16, depth 4, 192 lanes, 2
    passes: within PT_LIMIT of the CPU, and against the chunked PathTracer
    on the card within rtol 1e-5 / atol 1e-7 with the live rays equal."""
    from cudatracerlib_tpu_torch.models import path as tpath
    from cudatracerlib_tpu_torch.models import wavefront as twf
    card, cpu, n = _card_and_cpu(twf.WavefrontPT, lambda w, h: _inst_scene(w), 16, 2,
                                 max_depth=4, lanes=192)
    assert n > 0 and np.isfinite(card).all() and card.mean() > 0
    assert _rel(card, cpu) < PT_LIMIT, _rel(card, cpu)
    scene = _inst_scene(16).build(dev)
    pt = tpath.PathTracer(scene, 16, 16, max_depth=4, chunk_size=16 * 16)
    wf = twf.WavefrontPT(scene, 16, 16, max_depth=4, lanes=192)
    np.testing.assert_allclose(wf.render(2).cpu().numpy(), pt.render(2).cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    assert wf.rays_traced_live == pt.rays_traced_live


@pytest.mark.gpu
def test_k2_roots_match_plain_on_gpu(dev):
    """K2 with per-lane top-local roots, both variants and the probe's
    global design (one thread per ray), against its plain
    version bit for bit, on the instanced scene's forced-split forest;
    roots of zeros equal the rootless launch; the treelet BLAS route on the
    card (K2 with roots, K3, the K1 fallback with global roots) equals the
    same route on the CPU."""
    from cudatracerlib_tpu_torch.ops import instanced
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe
    sc = _inst_scene(32).build(dev)
    geom_tt, part = _forest(sc, dev)
    top = geom_tt.tt_top
    pix = torch.arange(1024, dtype=torch.int32, device=dev)
    rays = Rays(*(x.contiguous() for x in ttracer.gen_camera_rays(sc, pix, 0, 0, 32, 32)[0]))
    B = 1024
    roots = torch.from_numpy(np.where(np.arange(B) % 3 == 0, part.root_top[0],
                                      part.root_top[-1]).astype(np.int32)).to(dev)
    amask = torch.from_numpy(np.random.default_rng(3).random(B) < 0.5).to(dev)
    K2 = traversal_tt.top_visits_cuda
    for kw in ({}, dict(any_hit=True), dict(any_mask=amask)):
        for V in (6, 3):
            p2 = traversal_tt.top_visits(top, rays, V, roots=roots, **kw)
            for variant in ("shared", "split"):
                k2 = K2(top, rays, V, roots=roots, _variant=variant, **kw)
                _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
            k2 = probe.top_visits(top, rays, V, "global", roots=roots, **kw)
            _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
            z = K2(top, rays, V, roots=torch.zeros(B, dtype=torch.int32, device=dev), **kw)
            _equal((*z[0], *z[1:]), (*K2(top, rays, V, **kw)[0], *K2(top, rays, V, **kw)[1:]))
        card = traversal8.intersect_scene(geom_tt, rays, **kw)
        cpu_geom = type(geom_tt)(*(x.cpu() if isinstance(x, torch.Tensor) else x
                                   for x in geom_tt))
        cpu_geom = cpu_geom._replace(inst=type(geom_tt.inst)(
            *(None if x is None else x.cpu() for x in geom_tt.inst)))
        cpu = traversal8.intersect_scene(cpu_geom, Rays(*(x.cpu() for x in rays)),
                                         **{k: v.cpu() if isinstance(v, torch.Tensor) else v
                                            for k, v in kw.items()})
        _equal(tuple(x.cpu() for x in card), cpu)
    assert instanced.dropped_visits == 0 or int(instanced.dropped_visits) == 0
    torch.cuda.synchronize()


def _card_vs_cpu(make, load, dev, passes=2, limit=1e-5):
    """The same tracer on a scene loaded for the card and for the CPU,
    pass by pass: mean relative error under `limit`, finite and non-black."""
    trs = [make(load().build(d)) for d in (dev, "cpu")]
    for _ in range(passes):
        card, cpu = (tr.render(1).cpu().numpy() for tr in trs)
        assert np.isfinite(card).all() and card.mean() > 0
        assert np.abs(card - cpu).mean() / cpu.mean() < limit
    return trs


@pytest.mark.gpu
def test_loaded_cornell_on_gpu(dev, tmp_path):
    """chip_smoke.py's cornell.xml through the port's loader at 16x16: the
    path tracer and the PrimTracer on the card against the CPU."""
    import chip_smoke
    from cudatracerlib_tpu_torch.models import path as tpath, prim as tprim
    from cudatracerlib_tpu_torch.scene.loader import mitsuba
    p = tmp_path / "cornell.xml"
    p.write_text(chip_smoke.cornell_xml(16))
    load = lambda: mitsuba.load_mitsuba(str(p))[0]
    _card_vs_cpu(lambda s: tpath.PathTracer(s, 16, 16, max_depth=6), load, dev)
    _card_vs_cpu(lambda s: tprim.PrimTracer(s, 16, 16, draw_mode=tprim.D_NORMAL_SHADE),
                 load, dev, passes=1)


@pytest.mark.gpu
@pytest.mark.parametrize("regularize", [False, True], ids=["plain", "regularized"])
def test_loaded_materials_on_gpu(dev, tmp_path, regularize):
    """chip_smoke.py's materials.xml (all 16 BSDF types) at 16x16: the path
    tracer and WavefrontPT on the card against the CPU, plain and
    regularized."""
    import chip_smoke
    from cudatracerlib_tpu_torch.models import path as tpath, wavefront as twf
    from cudatracerlib_tpu_torch.scene.loader import mitsuba
    p = tmp_path / "materials.xml"
    p.write_text(chip_smoke.materials_xml(16))
    load = lambda: mitsuba.load_mitsuba(str(p))[0]
    _card_vs_cpu(lambda s: tpath.PathTracer(s, 16, 16, max_depth=5,
                                            regularize=regularize), load, dev)
    _card_vs_cpu(lambda s: twf.WavefrontPT(s, 16, 16, max_depth=5, lanes=200,
                                           regularize=regularize), load, dev)


@pytest.mark.gpu
def test_rough_transmittance_on_gpu(dev):
    """The rough transmittance lookup on the card against the CPU."""
    from cudatracerlib_tpu_torch.core import rough_transmittance as rt
    r = np.random.default_rng(2)
    eta, cos, alpha = (torch.from_numpy(r.uniform(lo, hi, 4096).astype(np.float32))
                       for lo, hi in ((0.9, 2.4), (-1.0, 1.0), (0.0, 1.2)))
    for dist in (0, 1):
        cpu = rt.eval_specular_albedo_eta(dist, eta, cos, alpha)
        card = rt.eval_specular_albedo_eta(dist, eta.to(dev), cos.to(dev), alpha.to(dev))
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_sharded_world_of_one_on_gpu(dev):
    """A world of one rank through NCCL (make_mesh without a process group:
    an in-process HashStore): ShardedPathTracer (the row film) and
    ShardedBDPT (the row film and splat parts) at 32x32, 2 passes, against
    the unsharded tracers on the card, within 1e-5: develop() (the parts
    folded) against render(); the sharded render() is the film developed
    without the parts, as the JAX package's (ROADMAP queue 3, item 7)."""
    import torch.distributed as dist
    from cudatracerlib_tpu_torch.models import bdpt as tbdpt
    from cudatracerlib_tpu_torch.models import film as tfilm
    from cudatracerlib_tpu_torch.models import path as tpath
    from cudatracerlib_tpu_torch.parallel import render as prender
    try:
        mesh = prender.make_mesh(1, device=dev)
        assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
        scene = tscenes.cornell_box(32, 32).build(dev)
        for sharded, single in ((prender.ShardedPathTracer, tpath.PathTracer),
                                (prender.ShardedBDPT, tbdpt.BDPT)):
            tr = sharded(scene, 32, 32, mesh=mesh, max_depth=4)
            r = tr.render(2).cpu().numpy()
            a = tr.develop().cpu().numpy()
            single_tr = single(scene, 32, 32, max_depth=4)
            b = single_tr.render(2).cpu().numpy()
            assert np.isfinite(a).all() and a.mean() > 0
            assert _rel(a, b) < 1e-5, sharded.__name__
            no_splat = tfilm.develop(single_tr.film._replace(
                splat=torch.zeros_like(single_tr.film.splat))).cpu().numpy()
            assert _rel(r, no_splat) < 1e-5, sharded.__name__
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_two_ranks_on_one_card_refused(dev, tmp_path):
    """launch refuses more ranks than cards, and make_mesh in a rank whose
    card does not exist raises (a subprocess joins a world of cards + 1
    ranks as its last rank, through a FileStore; NCCL starts lazily, so
    nothing waits for the other ranks)."""
    import os
    import subprocess
    import sys
    from cudatracerlib_tpu_torch.parallel import render as prender
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="cards"):
        prender.launch(prender.run_jobs, n, args=([],), device="cuda")
    code = ("import torch.distributed as dist\n"
            "from cudatracerlib_tpu_torch.parallel import render as prender\n"
            f"dist.init_process_group('nccl', store=dist.FileStore({str(tmp_path / 's')!r}, {n}),"
            f" rank={n - 1}, world_size={n})\n"
            f"prender.make_mesh({n}, device='cuda')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "would share a card" in p.stderr, p.stderr[-2000:]


@pytest.mark.gpu
def test_stage_spans_on_gpu(dev, monkeypatch):
    """Under the profiler on the card, a Sobol' PT pass (veach-mis 32²,
    depth 3) and a game frame (Cornell 32²) time their spans with CUDA
    events: each stage under ``ctl.pass`` lasts a positive time on the
    device's clock, and together they last at most the pass."""
    from torch.profiler import ProfilerActivity, profile
    from cudatracerlib_tpu_torch.models import game as tgame
    from cudatracerlib_tpu_torch.models import path as tpath
    from cudatracerlib_tpu_torch.utils import timers
    rec = timers.PerformanceTimer()
    monkeypatch.setattr(timers, "RECORDER", rec)
    for tr in (tpath.PathTracer(tscenes.veach_mis(32, 32).build(dev), 32, 32, max_depth=3,
                                sampler_type=2),
               tgame.GameTracer(tscenes.cornell_box(32, 32).build(dev), 32, 32)):
        tr.do_pass()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            tr.do_pass()
        (p,) = [s for s in rec.spans if s.name == "ctl.pass"]
        stages = [s for s in rec.spans if s.parent is p]
        assert len(stages) >= 4 and all(s.device_s() > 0 for s in stages)
        assert sum(s.device_s() for s in stages) <= p.device_s()
