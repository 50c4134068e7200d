"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
on the card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) The
kernels are built with -fmad=false and must agree with their plain
versions bit for bit: hits, visit lists, counts, step counts and flags.
K4, the pool traversal, must equal K1 on every field, for any order of
the rays."""
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
    closest / any-hit / mixed, V = 6 and 3; then the whole treelet path
    (with its K1 fallback) against K1 on the unsplit table."""
    sc = tscenes.san_miguel_stand_in(64, 64, target_tris=20000).build(dev)
    geom = sc.geom
    top, slabs = geom.tt_top, geom.tt_slabs
    pix = torch.arange(4096, dtype=torch.int32, device=dev)
    # the wrappers take contiguous rays (camera rays share one origin view)
    rays = Rays(*(x.contiguous() for x in ttracer.gen_camera_rays(sc, pix, 0, 0, 64, 64)[0]))
    amask = torch.from_numpy(np.random.default_rng(1).random(4096) < 0.5).to(dev)
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
        ref = traversal8.intersect_wide_cuda(geom.wide, rays, **kw)
        for coherent in (True, False):
            ex = traversal8.intersect_treelet_exact(geom, rays, coherent=coherent, **kw)
            assert torch.equal(ex.tri >= 0, ref.tri >= 0)
            assert torch.equal(ex.t[~anyh], ref.t[~anyh])


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
