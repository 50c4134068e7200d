"""The port's environment light against the JAX package's.

A Cornell box (area light) with a distant light and the San Miguel sky
map as environment (scaled and rotated), built by both packages: the light
table must be byte-identical. ``eval_environment`` and ``pdf_env_direct``
run on 4,096 directions and ``sample_emitter_direct`` on 4,096 reference
points from one RNG state, all made from a numpy seed and handed to both.
Integer outputs (the chosen light, the RNG state) match bit for bit;
floats within rtol 1e-5 / atol 1e-6 (XLA's einsum and trigonometric
functions round differently from PyTorch's). A direction whose equirect
coordinate falls within 1e-4 of a pixel boundary may land on the
neighbouring pixel on one side, so those few lanes are left out of the
lookup comparisons."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import rng as jrng
from cudatracerlib_tpu.models import lights as jlights
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.core import rng as trng
from cudatracerlib_tpu_torch.models import lights as tlights
from cudatracerlib_tpu_torch.scene import schema
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
B = 4096
ROT = jtf.rotate_deg([0.3, 1.0, 0.2], 35.0)


def _scene(scenes, *device):
    sc = scenes.cornell_box(8, 8)
    sc.set_environment(scenes._sky_envmap(), scale=(1.0, 0.9, 0.8), to_world=ROT)
    sc.add_distant_light(direction=(-0.45, -0.75, 0.49), radiance=(2.0, 1.8, 1.5))
    return sc.build(*device)


@pytest.fixture(scope="module")
def scenes():
    return _scene(jscenes), _scene(tscenes, "cpu")


def _dirs():
    d = np.random.default_rng(21).normal(size=(B, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _off_boundary(d, He, We):
    """Lanes whose env pixel is not within 1e-4 of a pixel edge (float64)."""
    dl = d.astype(np.float64) @ np.linalg.inv(ROT)[:3, :3].T
    u = (np.arctan2(dl[:, 0], -dl[:, 2]) + np.pi) / (2 * np.pi)
    v = np.arccos(np.clip(dl[:, 1], -1, 1)) / np.pi
    near = lambda x: np.abs(x - np.round(x)) < 1e-4
    return ~(near(u * We) | near(v * He))


def test_light_table_byte_identical(scenes):
    jsc, tsc = scenes
    for name in schema.LightTable._fields:
        a = getattr(tsc.lights, name).numpy()
        b = np.asarray(getattr(jsc.lights, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=name)
    np.testing.assert_array_equal(tsc.host["light_type"], jsc.host["light_type"])
    assert tsc.host["light_type"].tolist() == [
        schema.LIGHT_DISTANT, schema.LIGHT_DIFFUSE, schema.LIGHT_INFINITE]
    assert tlights.has_env_static(tsc.lights)


def test_eval_environment_and_pdf_match_jax(scenes):
    jsc, tsc = scenes
    d = _dirs()
    ok = _off_boundary(d, *tsc.lights.env_map.shape[:2])
    assert ok.mean() > 0.99
    le = tlights.eval_environment(tsc, torch.from_numpy(d)).numpy()
    jle = np.asarray(jlights.eval_environment(jsc, jnp.asarray(d)))
    np.testing.assert_allclose(le[ok], jle[ok], rtol=1e-5, atol=1e-6)
    pdf = tlights.pdf_env_direct(tsc, torch.from_numpy(d)).numpy()
    jpdf = np.asarray(jlights.pdf_env_direct(jsc, jnp.asarray(d)))
    np.testing.assert_allclose(pdf[ok], jpdf[ok], rtol=1e-5, atol=1e-6)
    assert le.max() > 1.0 and (pdf > 0).all()     # the sun and a full pmf


def test_sample_emitter_direct_matches_jax(scenes):
    jsc, tsc = scenes
    p = np.random.default_rng(4).uniform(-0.9, 0.9, (B, 3)).astype(np.float32)
    pix = np.arange(B, dtype=np.int32)
    ed, state = tlights.sample_emitter_direct(
        tsc, torch.from_numpy(p), trng.seed(torch.from_numpy(pix), 3, 1))
    jed, jstate = jlights.sample_emitter_direct(
        jsc, jnp.asarray(p), jrng.seed(jnp.asarray(pix), 3, 1))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    np.testing.assert_array_equal(ed.light_idx.numpy(), np.asarray(jed.light_idx))
    np.testing.assert_array_equal(ed.is_delta.numpy(), np.asarray(jed.is_delta))
    for name in ("p", "d", "dist", "n", "radiance_over_pdf", "pdf"):
        np.testing.assert_allclose(getattr(ed, name).numpy(),
                                   np.asarray(getattr(jed, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # all three lights were drawn, the environment among them
    assert set(ed.light_idx.tolist()) == {0, 1, 2}
