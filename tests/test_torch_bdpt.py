"""The port's BDPT against the JAX package's.

Pass for pass, as tests/test_torch_path.py holds the path tracer: after
each of 2 passes the film's rgb and splat buffers within a mean relative
error of 0.5% (float drift can flip a rare roulette draw, Fresnel coin or
near-tie triangle), the weights equal, and the live-ray counts (the JAX
package's float32, the port's int64) within 0.1%. Three configurations,
one JAX compilation each: the Cornell box at 24x24, depth 4; the glass
Cornell box (BASELINE config 4's scene: a smooth dielectric sphere) at
24x24, depth 5; the Cornell box at 16x16, depth 2, with force_s=1 (NEE
only). Then, on the port alone: the 6-pass render against
tests/goldens/cornell_32_bdpt.npz at test_goldens_family.py's tolerance
(mean relative error < 0.02); the strategy families of force_s summing to
the full render (they mask contributions and consume one RNG stream); and
_emission_pdfs against the JAX package's for every light type."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import bdpt as jbdpt
from cudatracerlib_tpu.models import lights as jlights
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import bdpt as tbdpt
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import lights as tlights
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from test_torch_lighttracer import JPKG, TPKG, _light_scene, _state

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_32_bdpt.npz")
CONFIGS = {"cornell_24_d4": ("cornell_box", 24, 4, {}),
           "glass_24_d5": ("cornell_glass", 24, 5, {}),
           "cornell_16_d2_s1": ("cornell_box", 16, 2, dict(force_s=1))}


def _rel(t, j):
    return np.abs(t - j).mean() / max(np.abs(j).mean(), 1e-9)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bdpt_pass_for_pass(name):
    scene, size, depth, kw = CONFIGS[name]
    jtr = jbdpt.BDPT(getattr(jscenes, scene)(size, size).build(), size, size,
                     max_depth=depth, **kw)
    ttr = tbdpt.BDPT(getattr(tscenes, scene)(size, size).build("cpu"), size, size,
                     max_depth=depth, **kw)
    before = traversal8.intersect_wide_cuda.launches
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        for buf in ("rgb", "splat"):
            j, t = np.asarray(getattr(jtr.film, buf)), getattr(ttr.film, buf).numpy()
            if kw.get("force_s") == 1 and buf == "splat":
                assert not t.any() and not j.any()    # no t=1 splats under s=1
                continue
            assert _rel(t, j) < 0.005, (buf, _rel(t, j))
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        j_rays, t_rays = float(jtr._rays_dev), ttr.rays_traced_live
        assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert ttr._rays_dev.dtype == torch.int64
    img = tfilm.develop(ttr.film).numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    assert traversal8.intersect_wide_cuda.launches == before    # CPU tensors only


def test_bdpt_golden():
    img = tbdpt.BDPT(tscenes.cornell_box(32, 32).build("cpu"), 32, 32,
                     max_depth=4).render(6).numpy()
    ref = np.load(GOLDEN)["img"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.02, f"golden drift {rel:.4f}"


def test_force_s_families_sum_to_the_full_render():
    """At depth 2 the families s = 0 .. NUM_LIGHT_V + 1 cover every
    strategy; their films add up to the full pass's (float rounding of the
    different summation orders aside)."""
    sc = tscenes.cornell_glass(16, 16).build("cpu")
    full = tbdpt.BDPT(sc, 16, 16, max_depth=2)
    full.do_pass()
    parts = []
    for s in range(tbdpt.NUM_LIGHT_V + 2):
        tr = tbdpt.BDPT(sc, 16, 16, max_depth=2, force_s=s)
        tr.do_pass()
        parts.append(tr)
        assert tr.rays_traced_live == full.rays_traced_live    # same code ran
    for buf in ("rgb", "splat"):
        total = sum(getattr(p.film, buf) for p in parts).numpy()
        np.testing.assert_allclose(total, getattr(full.film, buf).numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["point", "spot", "distant", "area", "env", "all"])
def test_emission_pdfs(kind):
    """_emission_pdfs on each NEE record of sample_emitter_direct, from
    random points above the floor."""
    jsc = _light_scene(JPKG, kind).build()
    tsc = _light_scene(TPKG, kind).build("cpu")
    r = np.random.default_rng(12)
    p = r.uniform((-1.0, -0.45, 0.5), (1.0, 0.4, 2.4), (4096, 3)).astype(np.float32)
    state = _state(0xB0)
    ted, _ = tlights.sample_emitter_direct(tsc, torch.from_numpy(p), torch.from_numpy(state))
    jed, _ = jlights.sample_emitter_direct(jsc, jnp.asarray(p),
                                           jnp.asarray(state.astype(np.uint32)))
    np.testing.assert_array_equal(ted.light_idx.numpy(), np.asarray(jed.light_idx))
    for got, want, what in zip(tbdpt._emission_pdfs(tsc, ted),
                               jbdpt._emission_pdfs(jsc, jed),
                               ("direct_w", "emission", "cos_l")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=what)
        assert np.isfinite(got.numpy()).all()
