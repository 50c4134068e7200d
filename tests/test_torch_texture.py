"""The port's textures against the JAX package's: the texture table its
host build makes (mip chains, quad-packed texel pool, offsets) byte for
byte, and ``eval_texture`` for every texture type with images filtered
bilinearly (mip 0), trilinearly (ray-cone footprint) and by EWA taps.

The inputs are made from a numpy seed and handed to both: 4,096 lanes with
texture ids over every row (and -1, the untextured default), uvs in
[-2, 3) so that wrapping is exercised, footprints from 1e-4 to 1 uv units
(levels 0 to 6 of a 48x80 image), random major-axis directions and
lengths. Colours agree within rtol 1e-5 / atol 1e-6: XLA contracts
uv * scale + offset into an FMA on the CPU and rounds log2 its own way,
which moves a bilinear weight or a mip blend in the last bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import bsdf as jbsdf
from cudatracerlib_tpu.ops import texture as jtex
from cudatracerlib_tpu.scene import host as jhost
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import bsdf as tbsdf
from cudatracerlib_tpu_torch.ops import texture as ttex
from cudatracerlib_tpu_torch.scene import host as thost
from cudatracerlib_tpu_torch.scene import schema
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)
B = 4096


def _specs(host):
    rng = np.random.default_rng(11)
    img_a = rng.random((48, 80, 3)).astype(np.float32)
    T = host.TextureSpec
    return [
        T(tex_type=schema.TEX_CONSTANT, value=(0.3, 0.6, 0.9)),
        T(tex_type=schema.TEX_CHECKERBOARD, value=(0.6, 0.5, 0.4),
          value1=(0.1, 0.2, 0.3), uv_scale=(4.0, 3.0), uv_offset=(0.25, 0.1)),
        T(tex_type=schema.TEX_BILERP, value=(0.9, 0.1, 0.5), value1=(0.2, 0.8, 0.4),
          uv_scale=(2.0, 5.0)),
        T(tex_type=schema.TEX_IMAGE, image=img_a, uv_scale=(1.5, -2.0),
          uv_offset=(0.3, 0.7)),
        T(tex_type=schema.TEX_IMAGE, image=jscenes._noise_texture(32), uv_scale=(12.0, 12.0)),
        T(tex_type=schema.TEX_UV, uv_scale=(3.0, 2.0)),
        T(tex_type=schema.TEX_WIREFRAME, value=(1.0, 1.0, 1.0), value1=(0.0, 0.1, 0.0),
          uv_scale=(8.0, 8.0)),
        T(tex_type=schema.TEX_EXTRADATA, value=(0.5, 2.0, 1.0)),
    ]


def _scene(scenes, host, *device):
    sc = scenes.cornell_box(8, 8)
    for spec in _specs(host):
        sc.add_material(host.MaterialSpec(reflectance=(0.5, 0.5, 0.5),
                                          tex_reflectance=spec))
    return sc.build(*device)


@pytest.fixture(scope="module")
def tables():
    jsc, tsc = _scene(jscenes, jhost), _scene(tscenes, thost, "cpu")
    rng = np.random.default_rng(3)
    n_tex = tsc.textures.tex_type.shape[0]
    fp = np.exp(rng.uniform(np.log(1e-4), 0.0, B)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, B)
    inputs = dict(
        tex_id=rng.integers(-1, n_tex, B).astype(np.int32),
        uv=rng.uniform(-2.0, 3.0, (B, 2)).astype(np.float32),
        default=rng.random((B, 3)).astype(np.float32),
        footprint=fp,
        ewa_dir=np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32),
        ewa_major=(fp * rng.uniform(1.0, 12.0, B)).astype(np.float32),
        extra=rng.random(B).astype(np.float32))
    return jsc, tsc, inputs


def test_texture_table_byte_identical(tables):
    jsc, tsc, _ = tables
    for name in schema.TextureTable._fields:
        a = getattr(tsc.textures, name).numpy()
        b = np.asarray(getattr(jsc.textures, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=name)
    assert tsc.textures.img_nmips.tolist() == [6, 6]   # 48x80 and 32x32 chains
    np.testing.assert_array_equal(tsc.host["mat_tex"], jsc.host["mat_tex"])


@pytest.mark.parametrize("filt", ["bilinear", "trilinear", "ewa"])
def test_eval_texture_matches_jax(tables, filt):
    jsc, tsc, x = tables
    kw = {}
    if filt != "bilinear":
        kw["uv_footprint"] = x["footprint"]
    if filt == "ewa":
        kw.update(ewa_dir=x["ewa_dir"], ewa_major=x["ewa_major"])
    args = (x["tex_id"], x["uv"], x["default"])
    got = ttex.eval_texture(tsc.textures, *(torch.from_numpy(a) for a in args),
                            extra=torch.from_numpy(x["extra"]),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    ref = jtex.eval_texture(jsc.textures, *(jnp.asarray(a) for a in args),
                            extra=jnp.asarray(x["extra"]),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # every type was drawn, and untextured lanes keep their default
    assert set(range(-1, 8)) <= set(x["tex_id"].tolist())
    off = x["tex_id"] < 0
    np.testing.assert_array_equal(got.numpy()[off], x["default"][off])


def test_gather_ctx_textures_match_jax(tables):
    """The textured branch of gather_ctx, with the footprint and EWA axis
    the path tracer passes, for lanes over every material."""
    jsc, tsc, x = tables
    n_mat = tsc.materials.mat_type.shape[0]
    mat = (np.arange(B) % n_mat).astype(np.int32)
    ewa = (x["ewa_dir"], x["ewa_major"])
    got = tbsdf.gather_ctx(tsc, torch.from_numpy(mat), torch.from_numpy(x["uv"]),
                           torch.from_numpy(x["footprint"]), active_types=(0,),
                           with_textures=tbsdf.scene_texture_mask(tsc),
                           ewa=tuple(torch.from_numpy(a) for a in ewa),
                           extra=torch.from_numpy(x["extra"]))
    ref = jbsdf.gather_ctx(jsc, jnp.asarray(mat), jnp.asarray(x["uv"]),
                           jnp.asarray(x["footprint"]), active_types=(0,),
                           with_textures=jbsdf.scene_texture_mask(jsc),
                           ewa=tuple(jnp.asarray(a) for a in ewa),
                           extra=jnp.asarray(x["extra"]))
    assert tbsdf.scene_texture_mask(tsc) == jbsdf.scene_texture_mask(jsc) == 1
    for name in ("c0", "c1", "params"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.mat_type.numpy(), np.asarray(ref.mat_type))


def test_parallax_cone_maps_raise():
    """A parallax material's cone map, which raised before it was ported,
    now builds into the texel pool (byte for byte against the JAX build in
    tests/test_torch_texture_features.py)."""
    sc = tscenes.cornell_box(8, 8)
    img = np.ones((8, 8, 3), np.float32)
    sc.add_material(thost.MaterialSpec(
        parallax_scale=0.05,
        tex_bump=thost.TextureSpec(tex_type=schema.TEX_IMAGE, image=img)))
    tex = sc.build("cpu").textures
    off = int(tex.img_cone[0])
    assert off >= 0
    # a flat height map rises nowhere: every cone ratio is the window clamp
    np.testing.assert_array_equal(tex.texels[off:off + 64].numpy(),
                                  np.full((64, 3), 7 / 8, np.float32))
