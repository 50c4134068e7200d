"""Alpha masks, bump and parallax mapping, cone maps, BSSRDF and spectral
transport in the port, against the JAX package.

Bit for bit: the cone maps and the texture table of a parallax scene (every
field byte-identical to the JAX build), the marble scene's material table,
the alpha tests' binary modes, and the RNG states after a pass. The
surface helpers (eval_alpha, apply_bump, apply_parallax in both its
cone-step and its linear branch) within 1e-5. The renders pass for pass
against the JAX tracers: PathTracer on the alpha (continuous and binary),
bump, parallax, BSSRDF (tests/test_bssrdf.py's marble shrunk to 16x16) and
spectral (C=4: Cornell, and the dispersive glass slab of
tests/test_texture_features.py) scenes, WavefrontPT on the alpha, bump and
parallax scenes; the film's mean relative error under 0.5% and the weights
equal. The live rays agree within 0.1%, or 1% where a pass traces only a
few hundred rays and single rays part: on the alpha scenes a lane on the
emissive wall samples a point of the same wall, a shadow direction whose z
is 0 in the port and ~2e-8 under XLA's FMAs, which puts the offset origin
on the other side (a ray traced in one package and not in the other, its
contribution 0 in both); through the marble and the glass slab a
refraction rounds across a boundary (1-3 rays of 590-1,110 a pass). Then
the JAX tests' own cases on the port: test_texture_features.py's alpha,
bump, parallax and spectral cases, test_bssrdf.py at 16x16 and
test_spectral.py; and film.add_samples_range and PathTracer._debug_lane
against the JAX ones."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import spectrum as jspec
from cudatracerlib_tpu.models import bsdf as jbsdf
from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.models import wavefront as jwf
from cudatracerlib_tpu.ops import shading as jshading
from cudatracerlib_tpu.scene import conemap as jcone
from cudatracerlib_tpu.scene import host as jhost, schema as jschema
from cudatracerlib_tpu.scene import sensors as jsensors, shapes as jshapes
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.core import spectrum as tspec
from cudatracerlib_tpu_torch.models import bsdf as tbsdf
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import wavefront as twf
from cudatracerlib_tpu_torch.ops import shading as tshading
from cudatracerlib_tpu_torch.scene import conemap as tcone
from cudatracerlib_tpu_torch.scene import host as thost, schema as tschema
from cudatracerlib_tpu_torch.scene import sensors as tsensors, shapes as tshapes
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)
JAX = (jhost, jschema, jsensors, jshapes, jtf)
TORCH = (thost, tschema, tsensors, tshapes, ttf)


def _build(sc, m):
    return sc.build() if m is JAX else sc.build("cpu")


def _mask_scene(m, alpha=0.25, mode=0, test=0.5, checker=False):
    """tests/test_texture_features.py's masked occluder before an emissive
    wall (16x16); `checker` makes the mask a checkerboard of alpha and
    1 - alpha."""
    host, schema, sensors, shapes, tf = m
    sc = host.DynamicScene()
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(shapes.rectangle(), black,
                   tf.compose(tf.translate([0, 0, 2]), tf.rotate_deg([0, 1, 0], 180),
                              tf.scale(4)), emission=(2.0, 2.0, 2.0))
    mask = (host.TextureSpec(tex_type=schema.TEX_CHECKERBOARD, value=(alpha,) * 3,
                             value1=(1.0 - alpha,) * 3, uv_scale=(4.0, 4.0))
            if checker else
            host.TextureSpec(tex_type=schema.TEX_CONSTANT, value=(alpha,) * 3))
    occ = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0), tex_alpha_mask=mask,
                                            alpha_mode=mode, alpha_test=test))
    sc.create_node(shapes.rectangle(), occ,
                   tf.compose(tf.translate([0, 0, 1]), tf.rotate_deg([0, 1, 0], 180),
                              tf.scale(4)))
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0, -2], [0, 0, 1]),
        fov_x_deg=20, film_w=16, film_h=16))
    return _build(sc, m)


def _height_image():
    yy, xx = np.meshgrid(np.linspace(0, 6 * np.pi, 32), np.linspace(0, 6 * np.pi, 32),
                         indexing="ij")
    height = (0.5 + 0.5 * np.sin(xx) * np.sin(yy)).astype(np.float32)
    return np.repeat(height[..., None], 3, -1)


def _bump_scene(m, with_bump=True, parallax=0.0, size=16):
    """tests/test_texture_features.py's bump-mapped plane under a point
    light; with parallax > 0 the height map also drives parallax mapping."""
    host, schema, sensors, shapes, tf = m
    sc = host.DynamicScene()
    bump = (host.TextureSpec(tex_type=schema.TEX_IMAGE, image=_height_image())
            if with_bump else None)
    mat = sc.add_material(host.MaterialSpec(reflectance=(0.8, 0.8, 0.8), tex_bump=bump,
                                            parallax_scale=parallax))
    sc.create_node(shapes.rectangle(), mat, tf.compose(tf.rotate_deg([1, 0, 0], -90),
                                                       tf.scale(2)))
    sc.add_point_light((1.5, 2, 0), (6, 6, 6))
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 2.5, -2.5], [0, 0, 0]),
        fov_x_deg=40, film_w=size, film_h=size))
    return _build(sc, m)


def _marble_scene(m, sigma_s=(3.0, 3.0, 3.0), sigma_a=(0.05, 0.1, 0.15), glass=False):
    """tests/test_bssrdf.py's marble sphere (or clear glass) at 16x16."""
    host, schema, sensors, shapes, tf = m
    sc = host.DynamicScene()
    kw = {} if glass else dict(bssrdf_sigma_a=sigma_a, bssrdf_sigma_s=sigma_s,
                               bssrdf_g=0.3)
    marble = sc.add_material(host.MaterialSpec(bsdf_type=schema.BSDF_DIELECTRIC,
                                               eta=1.3, **kw))
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(shapes.sphere(radius=0.5, n_theta=24, n_phi=48), marble)
    sc.create_node(shapes.rectangle(), black,
                   tf.compose(tf.translate([0, 1.8, 0]), tf.rotate_deg([1, 0, 0], 90),
                              tf.scale(0.8)), emission=(12.0,) * 3)
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0.4, -2.4], [0, 0, 0]),
        fov_x_deg=35, film_w=16, film_h=16))
    return _build(sc, m)


def _glass_slab_scene(m):
    """tests/test_texture_features.py's dispersive slab before an emitter."""
    host, schema, sensors, shapes, tf = m
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.8, 0.8, 0.8)))
    glass = sc.add_material(host.MaterialSpec(bsdf_type=schema.BSDF_DIELECTRIC, eta=1.45,
                                              dispersion_b=0.05, two_sided=False))
    sc.create_node(shapes.rectangle(), white,
                   tf.compose(tf.translate([0, 0, 3]), tf.rotate_deg([0, 1, 0], 180),
                              tf.scale(6)), emission=(4.0, 4.0, 4.0))
    sc.create_node(shapes.rectangle(), glass,
                   tf.compose(tf.translate([0, 0, 1]), tf.rotate_deg([0, 1, 0], 160),
                              tf.scale(4)))
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0, -2], [0, 0, 1]),
        fov_x_deg=30, film_w=16, film_h=16))
    return _build(sc, m)


def _pass_for_pass(jtr, ttr, passes=2, rays_tol=1e-3):
    for _ in range(passes):
        jtr.do_pass()
        ttr.do_pass()
        j, t = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        assert np.isfinite(t).all() and j.mean() > 0
        assert np.abs(t - j).mean() / j.mean() < 0.005
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        assert abs(ttr.rays_traced_live - jtr.rays_traced_live) <= \
            rays_tol * jtr.rays_traced_live


# --- the surface helpers ---

def _si(mod, lib, B, uv, wi):
    a = (lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))) \
        if lib == "torch" else (lambda x: jnp.asarray(x, jnp.float32))
    ai = (lambda x: torch.from_numpy(np.asarray(x, np.int32))) \
        if lib == "torch" else (lambda x: jnp.asarray(x, jnp.int32))
    tile = lambda v: np.tile(np.asarray([v], np.float32), (B, 1))
    return mod.SurfaceInteraction(
        valid=a(np.ones(B)) > 0, p=a(np.zeros((B, 3))), t=a(np.ones(B)),
        ng=a(tile([0., 0., 1.])), ns=a(tile([0., 0., 1.])), uv=a(uv),
        frame_t=a(tile([1., 0., 0.])), frame_s=a(tile([0., 1., 0.])),
        bary=a(np.zeros((B, 2))), mat_id=ai(np.zeros(B)), light_id=ai(np.full(B, -1)),
        tri=ai(np.zeros(B)), wi=a(wi), flipped=a(np.zeros(B)) > 0,
        uv_density=a(np.ones(B)))


def _parallax_plane(m, img, scale):
    host, schema, sensors, shapes, tf = m
    sc = host.DynamicScene()
    sc.add_material(host.MaterialSpec(
        reflectance=(1, 1, 1),
        tex_bump=host.TextureSpec(tex_type=schema.TEX_IMAGE, image=img,
                                  uv_scale=(2.0, 1.5), uv_offset=(0.1, -0.2)),
        parallax_scale=scale))
    sc.create_node(shapes.rectangle(), 0)
    sc.set_sensor(sensors.make_sensor(schema.SENSOR_PERSPECTIVE,
                                      tf.look_at([0, 0, -3], [0, 0, 0]),
                                      film_w=4, film_h=4))
    return _build(sc, m)


def _bumpy_height():
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, 32, endpoint=False),
                         np.linspace(0, 2 * np.pi, 32, endpoint=False), indexing="ij")
    hm = (0.5 + 0.25 * np.sin(2 * xx) * np.cos(3 * yy)).astype(np.float32)
    return np.repeat(hm[..., None], 3, axis=-1)


def test_cone_maps_and_texture_table_byte_identical():
    img = _bumpy_height()
    hm = np.random.default_rng(1).random((24, 40)).astype(np.float32)
    for window in (12, 3):
        np.testing.assert_array_equal(tcone.build_cone_map(hm, window),
                                      jcone.build_cone_map(hm, window))
    jt = _parallax_plane(JAX, img, 0.15).textures
    tt = _parallax_plane(TORCH, img, 0.15).textures
    assert int(tt.img_cone[0]) >= 0
    for f in jt._fields:
        assert np.asarray(getattr(jt, f)).tobytes() == getattr(tt, f).numpy().tobytes(), f


@pytest.mark.parametrize("branch", ["cone", "linear"])
def test_apply_parallax_matches_jax(branch):
    img = _bumpy_height()
    jsc, tsc = _parallax_plane(JAX, img, 0.15), _parallax_plane(TORCH, img, 0.15)
    if branch == "linear":
        jsc = jsc._replace(textures=jsc.textures._replace(img_cone=None))
        tsc = tsc._replace(textures=tsc.textures._replace(img_cone=None))
    B = 256
    r = np.random.default_rng(3)
    ang = r.uniform(0, 2 * np.pi, B)
    wi = np.stack([0.6 * np.cos(ang), 0.6 * np.sin(ang), np.full(B, 0.8)], -1)
    wi[:8, 2] = 0.05                             # grazing: vz clamps to 0.2
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    uv = r.uniform(-0.5, 1.5, (B, 2))
    for n_steps, n_refine in ((8, 4), (8, 8)):
        j = jbsdf.apply_parallax(jsc, _si(jshading, "jax", B, uv, wi), n_steps, n_refine)
        t = tbsdf.apply_parallax(tsc, _si(tshading, "torch", B, uv, wi), n_steps, n_refine)
        np.testing.assert_allclose(t.uv.numpy(), np.asarray(j.uv), rtol=1e-5, atol=1e-5)
        assert np.abs(t.uv.numpy() - uv).max() > 0.01


def test_apply_bump_matches_jax():
    jsc, tsc = _bump_scene(JAX), _bump_scene(TORCH)
    B = 512
    r = np.random.default_rng(4)
    uv = r.random((B, 2))
    wi = np.tile([[0.0, 0.6, 0.8]], (B, 1))
    j = jbsdf.apply_bump(jsc, _si(jshading, "jax", B, uv, wi))
    t = tbsdf.apply_bump(tsc, _si(tshading, "torch", B, uv, wi))
    for f in ("ns", "frame_t", "frame_s"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-5, atol=2e-5, err_msg=f)
    assert (t.ns.numpy()[:, 2] < 0.999).mean() > 0.5
    assert tbsdf.scene_has_bump(tsc) and not tbsdf.scene_has_parallax(tsc)


def _alpha_eval(m, spec_kw, uv=(0.5, 0.5)):
    host, schema, sensors, shapes, tf = m
    sc = host.DynamicScene()
    mat = sc.add_material(host.MaterialSpec(**spec_kw(host, schema)))
    sc.create_node(shapes.rectangle(), mat)
    sc.set_sensor(sensors.make_sensor(schema.SENSOR_PERSPECTIVE,
                                      tf.look_at([0, 0, -2], [0, 0, 1]), film_w=4, film_h=4))
    scene = _build(sc, m)
    uvs = np.tile(np.asarray([uv], np.float32), (4, 1))
    if m is JAX:
        out = jbsdf.eval_alpha(scene, jnp.full(4, mat, jnp.int32), jnp.asarray(uvs))
        return float(np.asarray(out)[0]), scene
    out = tbsdf.eval_alpha(scene, torch.full((4,), mat, dtype=torch.int32),
                           torch.from_numpy(uvs))
    return float(out[0]), scene


def _const(host, schema, v):
    return host.TextureSpec(tex_type=schema.TEX_CONSTANT, value=v)


ALPHA_CASES = {   # tests/test_texture_features.py's TestAlphaBlendModes
    "mode0": (lambda h, s: dict(tex_alpha_mask=_const(h, s, (0.25,) * 3)), 0.25),
    "lum_bright": (lambda h, s: dict(tex_alpha_mask=_const(h, s, (0.9,) * 3),
                                     alpha_mode=s.ALPHA_LUMINANCE, alpha_test=0.5), 1.0),
    "lum_dark": (lambda h, s: dict(tex_alpha_mask=_const(h, s, (0.1,) * 3),
                                   alpha_mode=s.ALPHA_LUMINANCE, alpha_test=0.5), 0.0),
    "alpha_pass": (lambda h, s: dict(tex_alpha_mask=_const(h, s, (0.6, 0, 0)),
                                     alpha_mode=s.ALPHA_ALPHA, alpha_test=0.5), 1.0),
    "alpha_fail": (lambda h, s: dict(tex_alpha_mask=_const(h, s, (0.4, 0, 0)),
                                     alpha_mode=s.ALPHA_ALPHA, alpha_test=0.5), 0.0),
    "color_match": (lambda h, s: dict(tex_alpha_mask=_const(h, s, (0.2, 0.8, 0.3)),
                                      alpha_mode=s.ALPHA_COLOR, alpha_test=0.05,
                                      alpha_test_color=(0.2, 0.8, 0.3)), 1.0),
    "color_miss": (lambda h, s: dict(tex_alpha_mask=_const(h, s, (0.9, 0.1, 0.1)),
                                     alpha_mode=s.ALPHA_COLOR, alpha_test=0.05,
                                     alpha_test_color=(0.2, 0.8, 0.3)), 0.0),
    "reflectance_src": (lambda h, s: dict(
        tex_reflectance=_const(h, s, (0.9,) * 3),
        alpha_mode=s.ALPHA_LUMINANCE | s.ALPHA_SRC_REFLECTANCE, alpha_test=0.5), 1.0),
}


@pytest.mark.parametrize("case", list(ALPHA_CASES))
def test_eval_alpha_modes(case):
    spec_kw, want = ALPHA_CASES[case]
    t, scene = _alpha_eval(TORCH, spec_kw)
    j, _ = _alpha_eval(JAX, spec_kw)
    assert t == j
    np.testing.assert_allclose(t, want, atol=1e-5)
    assert tbsdf.scene_has_alpha(scene)      # mode != 0 counts even without a mask


# --- renders against the JAX tracers ---

@pytest.mark.parametrize("mode", ["continuous", "luminance"])
def test_alpha_pass_for_pass(mode):
    # the continuous mask passes 75% of the lanes, the binary checkerboard
    # the squares whose luminance 0.2 fails the test 0.5
    kw = dict(alpha=0.25) if mode == "continuous" else dict(
        alpha=0.2, mode=jschema.ALPHA_LUMINANCE, test=0.5, checker=True)
    _pass_for_pass(jpath.PathTracer(_mask_scene(JAX, **kw), 16, 16, max_depth=4),
                   tpath.PathTracer(_mask_scene(TORCH, **kw), 16, 16, max_depth=4),
                   rays_tol=0.01)


def test_bump_and_parallax_pass_for_pass():
    for parallax in (0.0, 0.1):
        _pass_for_pass(jpath.PathTracer(_bump_scene(JAX, parallax=parallax), 16, 16,
                                        max_depth=3),
                       tpath.PathTracer(_bump_scene(TORCH, parallax=parallax), 16, 16,
                                        max_depth=3))


@pytest.mark.parametrize("scene", ["alpha", "bump", "parallax"])
def test_wavefront_features_pass_for_pass(scene):
    make = {"alpha": lambda m: _mask_scene(m),
            "bump": lambda m: _bump_scene(m),
            "parallax": lambda m: _bump_scene(m, parallax=0.1)}[scene]
    jtr = jwf.WavefrontPT(make(JAX), 16, 16, max_depth=4, lanes=200)
    ttr = twf.WavefrontPT(make(TORCH), 16, 16, max_depth=4, lanes=200)
    assert ttr._kw["with_" + scene]
    _pass_for_pass(jtr, ttr, rays_tol=0.01 if scene == "alpha" else 1e-3)


def test_bssrdf_pass_for_pass():
    jsc, tsc = _marble_scene(JAX), _marble_scene(TORCH)
    for f in jsc.materials._fields:
        assert np.asarray(getattr(jsc.materials, f)).tobytes() == \
            getattr(tsc.materials, f).numpy().tobytes(), f
    np.testing.assert_array_equal(tsc.materials.params[0, 25:32].numpy(),
                                  np.float32([0.05, 0.1, 0.15, 3.0, 3.0, 3.0, 0.3]))
    ttr = tpath.PathTracer(tsc, 16, 16, max_depth=12)
    assert ttr.with_bssrdf and tbsdf.scene_has_bssrdf(tsc)
    _pass_for_pass(jpath.PathTracer(jsc, 16, 16, max_depth=12), ttr, rays_tol=0.01)


@pytest.mark.parametrize("scene", ["cornell", "glass_slab"])
def test_spectral_pass_for_pass(scene):
    make = {"cornell": lambda m: _build(
        (jscenes if m is JAX else tscenes).cornell_box(16, 16), m),
        "glass_slab": _glass_slab_scene}[scene]
    _pass_for_pass(jpath.PathTracer(make(JAX), 16, 16, max_depth=4, spectral=4),
                   tpath.PathTracer(make(TORCH), 16, 16, max_depth=4, spectral=4),
                   rays_tol=0.01)


def test_spectral_helpers_match_jax():
    r = np.random.default_rng(6)
    rgb = r.random((64, 3)).astype(np.float32)
    u = r.random(64).astype(np.float32)
    L = r.gamma(1.0, 1.0, (64, 4)).astype(np.float32)
    jl, jp = jspec.sample_hero_wavelengths(jnp.asarray(u), 4)
    tl, tp = tspec.sample_hero_wavelengths(torch.from_numpy(u), 4)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tp == jp
    for f in ("rgb_to_spectral", "rgb_to_spectral_smits"):
        np.testing.assert_allclose(getattr(tspec, f)(torch.from_numpy(rgb), tl).numpy(),
                                   np.asarray(getattr(jspec, f)(jnp.asarray(rgb), jl)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(tspec.cie_xyz_cmf(tl).numpy(),
                               np.asarray(jspec.cie_xyz_cmf(jl)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tspec.spectral_to_rgb(torch.from_numpy(L), tl, 340.0).numpy(),
                               np.asarray(jspec.spectral_to_rgb(jnp.asarray(L), jl, 340.0)),
                               rtol=1e-5, atol=1e-6)
    for f in ("luminance", "rgb_to_xyz", "xyz_to_rgb"):
        np.testing.assert_allclose(getattr(tspec, f)(torch.from_numpy(rgb)).numpy(),
                                   np.asarray(getattr(jspec, f)(jnp.asarray(rgb))),
                                   rtol=1e-6, atol=1e-7, err_msg=f)


def test_add_samples_range_matches_jax():
    r = np.random.default_rng(7)
    # 900 clamps into the film; -5 counts from its end, then clamps
    for start in (0, 37, 900, -5, -300):
        val = r.random((200, 3)).astype(np.float32)
        val[3] = np.inf
        wgt = r.random(200).astype(np.float32)
        for w in (None, wgt):
            j = jfilm.add_samples_range(jfilm.new_film(32, 32), start, jnp.asarray(val),
                                        None if w is None else jnp.asarray(w))
            t = tfilm.add_samples_range(tfilm.new_film(32, 32, "cpu"), start,
                                        torch.from_numpy(val),
                                        None if w is None else torch.from_numpy(w))
            np.testing.assert_array_equal(t.rgb.numpy(), np.asarray(j.rgb))
            np.testing.assert_array_equal(t.weight.numpy(), np.asarray(j.weight))


def test_debug_lane_matches_jax():
    jtr = jpath.PathTracer(jscenes.cornell_box(16, 16).build(), 16, 16, max_depth=4)
    ttr = tpath.PathTracer(tscenes.cornell_box(16, 16).build("cpu"), 16, 16, max_depth=4)
    for x, y in ((3, 5),):
        j, t = jtr.debug_pixel(x, y), ttr.debug_pixel(x, y)
        for k in ("ray_o", "ray_d", "L"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# --- the JAX tests' own cases on the port ---

def test_alpha_mask_transmits_fraction():
    img = tpath.PathTracer(_mask_scene(TORCH, 0.25), 16, 16, max_depth=4).render(96).numpy()
    np.testing.assert_allclose(img[6:10, 6:10].mean(), 2.0 * 0.75, rtol=0.1)


def test_alpha_opaque_blocks():
    img = tpath.PathTracer(_mask_scene(TORCH, 1.0), 16, 16, max_depth=4).render(8).numpy()
    assert img[6:10, 6:10].mean() < 0.05


def test_bump_changes_shading():
    flat = tpath.PathTracer(_bump_scene(TORCH, False, size=24), 24, 24,
                            max_depth=2).render(12).numpy()
    bumped = tpath.PathTracer(_bump_scene(TORCH, True, size=24), 24, 24,
                              max_depth=2).render(12).numpy()
    assert np.isfinite(bumped).all()
    diff = np.abs(bumped - flat)[8:20, 4:20].mean()
    assert diff > 0.05 * flat[8:20, 4:20].mean()


def test_parallax_occlusion_shift():
    img = np.full((8, 8, 3), 0.25, np.float32)
    host, schema, sensors, shapes, tf = TORCH
    sc = host.DynamicScene()
    sc.add_material(host.MaterialSpec(
        reflectance=(1, 1, 1),
        tex_bump=host.TextureSpec(tex_type=schema.TEX_IMAGE, image=img),
        parallax_scale=0.1))
    sc.create_node(shapes.rectangle(), 0)
    sc.set_sensor(sensors.make_sensor(schema.SENSOR_PERSPECTIVE,
                                      tf.look_at([0, 0, -3], [0, 0, 0]), film_w=4, film_h=4))
    scene = sc.build("cpu")
    assert tbsdf.scene_has_parallax(scene)
    uv = np.full((4, 2), 0.5)
    out = tbsdf.apply_parallax(scene, _si(tshading, "torch", 4, uv,
                                          np.tile([[0.6, 0.0, 0.8]], (4, 1))))
    np.testing.assert_allclose(0.5 - float(out.uv[0, 0]), 0.075 * 0.75, rtol=0.2)
    assert abs(float(out.uv[0, 1]) - 0.5) < 1e-4


def test_cone_step_parallax_matches_dense_march():
    host, schema, sensors, shapes, tf = TORCH
    sc = host.DynamicScene()
    sc.add_material(host.MaterialSpec(
        reflectance=(1, 1, 1),
        tex_bump=host.TextureSpec(tex_type=schema.TEX_IMAGE, image=_bumpy_height()),
        parallax_scale=0.15))
    sc.create_node(shapes.rectangle(), 0)
    sc.set_sensor(sensors.make_sensor(schema.SENSOR_PERSPECTIVE,
                                      tf.look_at([0, 0, -3], [0, 0, 0]), film_w=4, film_h=4))
    scene = sc.build("cpu")
    B = 64
    ang = np.linspace(0, 2 * np.pi, B, endpoint=False)
    wi = np.stack([0.55 * np.cos(ang), 0.55 * np.sin(ang), np.full(B, 0.835)], -1)
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    uv0 = np.random.default_rng(3).random((B, 2)).astype(np.float32)
    out = tbsdf.apply_parallax(scene, _si(tshading, "torch", B, uv0, wi), 8, 8)
    d_cone = np.linalg.norm(out.uv.numpy() - uv0, axis=1)
    from cudatracerlib_tpu_torch.ops import texture as texmod
    slope = wi[:, :2] / wi[:, 2:3] * 0.15
    zero3 = torch.zeros((B, 3))
    d_ref = np.ones(B, np.float32)
    found = np.zeros(B, bool)
    for k in range(1, 257):
        d = k / 256.0
        hgt = texmod.eval_texture(scene.textures, torch.zeros(B, dtype=torch.int32),
                                  torch.from_numpy(uv0 - slope * d), zero3)[:, 0].numpy()
        below = d >= 1.0 - hgt
        d_ref = np.where(below & ~found, d, d_ref)
        found |= below
    d_exp = d_ref * np.linalg.norm(slope, axis=1)
    np.testing.assert_allclose(d_cone, d_exp, atol=0.01)
    assert (d_cone <= d_exp + 0.005).all()


def test_bssrdf_scatters_light():
    """tests/test_bssrdf.py's case at 16x16 (center: the middle 4x4)."""
    scene = _marble_scene(TORCH)
    img = tpath.PathTracer(scene, 16, 16, max_depth=12).render(24).numpy()
    assert np.isfinite(img).all()
    assert img[6:10, 6:10].mean() > 0.05
    glass = tpath.PathTracer(_marble_scene(TORCH, glass=True), 16, 16,
                             max_depth=12).render(24).numpy()
    assert img.mean() > 3.0 * glass.mean(), (img.mean(), glass.mean())


def test_bssrdf_absorption_tints():
    scene = _marble_scene(TORCH, sigma_a=(0.02, 0.6, 1.2))
    c = tpath.PathTracer(scene, 16, 16, max_depth=12).render(16).numpy()[6:10, 6:10]
    c = c.mean(axis=(0, 1))
    assert c[0] > c[1] > c[2], c


def test_hero_wavelength_dispersion_continuous():
    B = 256
    lam_nm = np.linspace(380.0, 720.0, B).astype(np.float32)
    params = np.zeros((B, tschema.N_MAT_PARAMS), np.float32)
    params[:, 4], params[:, 23] = 1.45, 0.02
    c = torch.ones((B, 3))
    z = torch.zeros(B, dtype=torch.int32)
    p = torch.from_numpy(params)
    ctx = tbsdf.BsdfCtx(mat_type=torch.full((B,), tschema.BSDF_DIELECTRIC, dtype=torch.int32),
                        params=p, c0=c, c1=c, n_type=z, n_params=p, n_c0=c, n_c1=c,
                        n2_type=z, n2_params=p, n2_c0=c, n2_c1=c,
                        lam_um=torch.from_numpy(lam_nm) * 1e-3)
    wi = torch.tensor([[0.6, 0.0, 0.8]]).expand(B, 3)
    u = torch.tensor([[0.999, 0.5, 0.5]]).expand(B, 3)
    s = tbsdf.sample(ctx, wi, u, (tschema.BSDF_DIELECTRIC,))
    wo = s.wo.numpy()
    assert (wo[:, 2] < 0).all()
    assert (np.diff(np.abs(wo[:, 0])) > 0).all()
    assert abs(wo[-1, 0]) - abs(wo[0, 0]) > 0.01
    assert ((s.weight.numpy() > 0).sum(1) == 3).all()


def test_spectral_dispersion_renders_rainbow():
    scene = _glass_slab_scene(TORCH)
    img = tpath.PathTracer(scene, 16, 16, max_depth=4, chunk_size=256,
                           spectral=4).render(8).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    rgb = tpath.PathTracer(scene, 16, 16, max_depth=4, chunk_size=256).render(8).numpy()
    assert abs(img.mean() - rgb.mean()) / rgb.mean() < 0.3


def test_spectral_round_trips():
    """tests/test_spectral.py's round trips, CMF shape and hero strata."""
    lam = torch.linspace(380.0, 719.9, 2048)[None, :]
    for v in (1.0, 0.5, 0.18, 0.0):
        back = tspec.spectral_to_rgb(tspec.rgb_to_spectral(torch.full((1, 3), v), lam),
                                     lam, 340.0)[0].numpy()
        np.testing.assert_allclose(back, v, atol=1e-3)
    for rgb in ([0.8, 0.2, 0.1], [0.1, 0.5, 0.9], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]):
        r = torch.tensor([rgb])
        s = tspec.rgb_to_spectral(r, lam)
        assert float(s.min()) >= 0.0
        np.testing.assert_allclose(tspec.spectral_to_rgb(s, lam, 340.0)[0].numpy(), rgb,
                                   atol=2e-3)
        np.testing.assert_allclose(tspec.spectral_to_rgb(
            tspec.rgb_to_spectral_smits(r, lam), lam, 340.0)[0].numpy(), rgb, atol=0.15)
    lam1 = torch.linspace(380.0, 720.0, 1000)
    cmf = tspec.cie_xyz_cmf(lam1).numpy()
    for k, peak in ((0, 599.0), (1, 555.0), (2, 446.0)):
        assert abs(lam1.numpy()[cmf[:, k].argmax()] - peak) < 10
    lam4, pdf = tspec.sample_hero_wavelengths(torch.tensor([0.0, 0.25, 0.999]), 4)
    d = np.sort((lam4.numpy()[1] - 380.0) % 340.0)
    np.testing.assert_allclose(np.diff(d), 85.0, atol=1e-3)
    assert abs(pdf - 1.0 / 340.0) < 1e-9


def test_spectral_pt_matches_rgb_on_cornell():
    """tests/test_spectral.py's bound at its size (24x24, 24 passes)."""
    scene = tscenes.cornell_box(24, 24).build("cpu")
    im1 = tpath.PathTracer(scene, 24, 24, max_depth=4, chunk_size=576).render(24).numpy()
    im2 = tpath.PathTracer(scene, 24, 24, max_depth=4, chunk_size=576,
                           spectral=4).render(24).numpy()
    assert np.isfinite(im2).all()
    np.testing.assert_allclose(im2.mean((0, 1)), im1.mean((0, 1)), rtol=0.12)
    assert abs(im2.mean() - im1.mean()) / im1.mean() < 0.08
