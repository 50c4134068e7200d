"""The port's PrimTracer, film output helpers and tracer status against the
JAX package's.

Every draw mode renders one pass of the Cornell box at 32x32 (modes 0-11)
or of the glass Cornell box (modes 12-14: the first-non-delta AOVs walk
through the glass sphere's refractions) in both packages on the same scene.
The images agree to a mean relative error of 1e-5 and a largest difference
of 1e-4: XLA on the CPU contracts a*b+c into FMAs where PyTorch rounds
twice, and barycentrics and uv cancel near triangle edges. The assertions
of tests/test_prim.py (at 64x64 there) then hold for the port at 32x32.
The JAX pass runs eagerly, op by op, not through its jitted PrimTracer:
XLA's compile of the first-non-delta walk (six bounces over all 16 BSDF
types) takes minutes on the CPU, the eager pass seconds.
The sRGB conversion equals the JAX package's but for values within two ulp
of a step of 1/255 (see test_torch_core.py's sRGB note)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import prim as jprim
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import prim as tprim
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
W = H = 32


@pytest.fixture(scope="module")
def scenes():
    return {name: (getattr(jscenes, name)(W, H).build(),
                   getattr(tscenes, name)(W, H).build("cpu"))
            for name in ("cornell_box", "cornell_glass")}


def _mode_scene(mode):
    return "cornell_glass" if mode in tprim.D_ND_MODES else "cornell_box"


def _jax_render(jsc, mode):
    """One JAX pass of `mode`, eagerly (what PrimTracer.render(1) jits)."""
    film, _, _ = jprim._prim_pass(jsc, jfilm.new_film(W, H), 0, draw_mode=mode,
                                  w=W, h=H)
    return np.asarray(jfilm.develop(film._replace(n_passes=1.0)))


@pytest.mark.parametrize("mode", range(15))
def test_draw_mode_matches_jax(scenes, mode):
    jsc, tsc = scenes[_mode_scene(mode)]
    want = _jax_render(jsc, mode)
    before = traversal8.intersect_wide_cuda.launches
    tr = tprim.PrimTracer(tsc, W, H, draw_mode=mode)
    got = tr.render(1).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).mean() <= 1e-5 * max(np.abs(want).mean(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(want).max() > 0
    assert tr._iters_dev.dtype == tr._rows_dev.dtype == torch.int64
    assert int(tr._iters_dev) == int(tr._rows_dev) >= W * H
    assert traversal8.intersect_wide_cuda.launches == before    # CPU tensors only


def test_first_non_delta_walks_through_glass(scenes):
    """Through the glass sphere the first-non-delta depth exceeds the
    first-hit depth, and the walk traverses more rows."""
    _, tsc = scenes["cornell_glass"]
    first = tprim.PrimTracer(tsc, W, H, draw_mode=tprim.D_LINEAR_DEPTH)
    nd = tprim.PrimTracer(tsc, W, H, draw_mode=tprim.D_ND_DEPTH)
    d0, d1 = first.render(1).numpy(), nd.render(1).numpy()
    assert (d1 >= d0 - 1e-6).all() and (d1 > d0 + 1e-3).mean() > 0.02
    assert int(nd._iters_dev) > int(first._iters_dev)


def test_prim_assertions_of_the_jax_tests(scenes):
    """tests/test_prim.py's checks (64x64 there, scaled to 32x32)."""
    _, tsc = scenes["cornell_box"]
    img = tprim.PrimTracer(tsc, W, H, draw_mode=tprim.D_LINEAR_DEPTH).render(1).numpy()
    assert img[16, 16, 0] > 0.1 and (img[..., 0] > 0).mean() > 0.99
    img = tprim.PrimTracer(tsc, W, H, draw_mode=tprim.D_NORMAL_SHADE).render(1).numpy()
    assert img[16, 1, 0] > 0.9 and abs(img[16, 1, 1] - 0.5) < 0.1
    assert img[16, 30, 0] < 0.1 and img[30, 16, 1] > 0.9
    img = tprim.PrimTracer(tsc, W, H, draw_mode=tprim.D_LIGHT_LE).render(1).numpy()
    assert img.max() > 10.0 and (img.sum(-1) > 0).mean() < 0.1
    img = tprim.PrimTracer(tsc, W, H, draw_mode=tprim.D_ALBEDO).render(1).numpy()
    np.testing.assert_allclose(img[16, 1], [0.63, 0.065, 0.05], atol=0.02)


def test_debug_pixel_and_status(scenes):
    jsc, tsc = scenes["cornell_box"]
    jt = jprim.PrimTracer(jsc, W, H, draw_mode=jprim.D_NORMAL_GEO)
    tt = tprim.PrimTracer(tsc, W, H, draw_mode=tprim.D_NORMAL_GEO)
    want, got = jt.debug_pixel(16, 16), tt.debug_pixel(16, 16)
    assert set(got) == set(want)
    assert int(got["tri"][0]) == int(want["tri"][0]) >= 0
    assert int(got["mat"][0]) == int(want["mat"][0])
    for k in ("ray_o", "ray_d", "t", "p", "ns", "uv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    jt.render(2)
    tt.render(2)
    js, ts = jt.status(), tt.status()
    assert set(ts) == set(js) == {"passes", "spp", "seconds", "spp_per_second"}
    assert (ts["passes"], ts["spp"]) == (js["passes"], js["spp"]) == (2, 2)
    assert ts["seconds"] > 0 and ts["spp_per_second"] > 0
    assert tprim.PrimTracer.progressive is False and jprim.PrimTracer.progressive is False


def test_film_output_helpers(tmp_path):
    """to_srgb_u8 against the JAX package's; save_png and save_hdr_npz
    round trips."""
    r = np.random.default_rng(2)
    hdr = (r.random((W, H, 3)) * 1.5 - 0.1).astype(np.float32)
    hdr[0, 0] = (np.nan, np.inf, -np.inf)
    got = tfilm.to_srgb_u8(torch.from_numpy(hdr)).numpy()
    want = np.asarray(jfilm.to_srgb_u8(jnp.asarray(hdr)))
    assert got.dtype == want.dtype == np.uint8
    ok = np.isfinite(hdr)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff[ok].max() <= 1 and (diff[ok] == 0).mean() > 0.999
    from PIL import Image
    tfilm.save_png(torch.from_numpy(hdr), str(tmp_path / "a.png"))
    png = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(png[1:], got[1:])
    tfilm.save_hdr_npz(torch.from_numpy(hdr), str(tmp_path / "a.npz"))
    back = np.load(tmp_path / "a.npz")["hdr"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, hdr)
