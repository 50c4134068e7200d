"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
on the card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) The
kernels are built with -fmad=false and must agree with their plain
versions bit for bit: hits, visit lists, counts, step counts and flags.
K4, the pool traversal, must equal K1 on every field, for any order of
the rays. PrimTracer, LightTracer and BDPT run on the card at 16x16 and
are held to the same render on the CPU."""
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
    """K4 against K1 and the plain version on veach-mis camera rays and
    random rays, closest / any-hit / mixed, and on the rays shuffled."""
    sc = tscenes.veach_mis(64, 64).build(dev)
    table = sc.geom.wide
    pix = torch.arange(4096, dtype=torch.int32, device=dev)
    cam = ttracer.gen_camera_rays(sc, pix, 0, 0, 64, 64)[0]
    r = np.random.default_rng(3)
    o = r.uniform(-3, 3, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = 4096 + N_RAYS
    rays = Rays(torch.cat([cam.o, torch.from_numpy(o).to(dev)]),
                torch.cat([cam.d, torch.from_numpy(d).to(dev)]),
                torch.full((B,), 1e-4, device=dev), torch.full((B,), 1e30, device=dev))
    amask = torch.from_numpy(r.random(B) < 0.5).to(dev)
    perm = torch.from_numpy(r.permutation(B)).to(dev)
    shuffled = Rays(*(x[perm].contiguous() for x in rays))
    for kw, kw_s in (({}, {}), (dict(any_hit=True), dict(any_hit=True)),
                     (dict(any_mask=amask), dict(any_mask=amask[perm]))):
        k4 = traversal8.intersect_wide_pool_cuda(table, rays, with_iters=True, **kw)
        k1 = traversal8.intersect_wide_cuda(table, rays, with_iters=True, **kw)
        p = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
        _equal((*k4[0], k4[1], k4[2]), (*k1[0], k1[1], k1[2]))
        _equal((*k4[0], k4[1], k4[2]), (*p[0], p[1], p[2]))
        ks = traversal8.intersect_wide_pool_cuda(table, shuffled, with_iters=True, **kw_s)
        un = [None if x is None else torch.empty_like(x).index_copy_(0, perm, x)
              for x in (*ks[0], ks[1], ks[2])]
        _equal(un, (*k1[0], k1[1], k1[2]))


@pytest.mark.gpu
def test_microbench_kernels_match_plain_on_gpu(dev):
    from cudatracerlib_tpu_torch.utils import microbench as mb
    res = mb.measure(dev, table_rows=(331, 4096), gathers=65536, loop_steps=512,
                     queue_items=(65536,))
    assert mb.max_abs_err(res) == 0, res


@pytest.mark.gpu
def test_table_variants_match_plain_on_gpu(dev):
    """K1's and K2's variants (shared table, forced global) and the two
    designs of utils/schedule_probe.py (static stride, stacks in shared
    memory) against the plain versions, closest / any-hit / mixed: K1 on
    the Cornell table (shared by the size rule) and on the 20,000-triangle
    San Miguel table (global by the rule, refused when forced shared), K2
    on that scene's top table at V = 6 and 3."""
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
            for variant in (None, "global"):
                k2 = K2(geom.tt_top, rays, V, _variant=variant, **kw)
                _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
            for design in probe.DESIGNS:
                k2 = probe.top_visits(geom.tt_top, rays, V, design, **kw)
                _equal((*k2[0], *k2[1:]), (*p2[0], *p2[1:]))
    with pytest.raises(RuntimeError):
        K1(geom.wide, rays, _variant="shared")
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
