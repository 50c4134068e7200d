"""The port's scene loading against the JAX package's: the Mitsuba XML
loader with its OBJ, PLY, serialized and image files, the sun-and-sky
environment, the blackbody spectrum, shapes.disk and the asset cache.

tests/test_mitsuba_loader.py's cases run on the same tmp_path files
through both packages, whose arrays must be equal. Scenes loaded by both
are built on the CPU and compared table by table, byte for byte (uint32
views; the JAX treelet tables taken to the port's layout by
treelet.from_jax_layout): tests/test_mitsuba_loader.py's SCENE_XML, a shapegroup instanced
five times (the instanced tables of build(instancing="auto")), a sun-and-sky
scene with a blackbody light, and chip_smoke.py's materials.xml (all 16
BSDF types, 63,492 triangles). `blackbody` values may differ by 2 ulp: exp
rounds its own way on each side. Scenes of 4,096+ triangles take the
native builder: the JAX package's disk caches are bypassed and its builder
runs the library the port compiled from the same source.

The materials scene is also rendered by both PathTracers at 32x32, depth
5, pass for pass (one JAX render, compiled once in a module fixture): the
film's mean relative error under 0.5% and the live rays within 0.1%, as
tests/test_torch_path.py holds the Cornell box. The PNG and EXR paths run
where PIL and imageio are installed (where no backend decodes EXR,
both packages must raise the same IOError)."""
import os
import struct
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from cudatracerlib_tpu.core import rough_transmittance as jrt
from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.scene import asset_cache as jcache
from cudatracerlib_tpu.scene import native_bvh as jnative
from cudatracerlib_tpu.scene import shapes as jshapes
from cudatracerlib_tpu.scene import sunsky as jsunsky
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.scene.loader import images as jimages
from cudatracerlib_tpu.scene.loader import mitsuba as jmitsuba
from cudatracerlib_tpu.scene.loader import obj as jobj
from cudatracerlib_tpu.scene.loader import ply as jply
from cudatracerlib_tpu.scene.loader import serialized as jser
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.scene import asset_cache as tcache
from cudatracerlib_tpu_torch.scene import native_bvh as tnative
from cudatracerlib_tpu_torch.scene import shapes as tshapes
from cudatracerlib_tpu_torch.scene import sunsky as tsunsky
from cudatracerlib_tpu_torch.scene import treelet as ttreelet
from cudatracerlib_tpu_torch.scene.loader import images as timages
from cudatracerlib_tpu_torch.scene.loader import mitsuba as tmitsuba
from cudatracerlib_tpu_torch.scene.loader import obj as tobj
from cudatracerlib_tpu_torch.scene.loader import ply as tply
from cudatracerlib_tpu_torch.scene.loader import serialized as tser
from test_mitsuba_loader import MTL_FILE, OBJ_FILE, SCENE_XML
from test_torch_scene import bits, flatten

torch.set_num_threads(2)


def assert_builds_equal(t, j, ulp_keys=()):
    """Every table of the two builds byte for byte (the JAX treelet tables
    in the port's row-major layout); the keys of `ulp_keys` within 2 ulp
    (as int32 views of float32 of one sign)."""
    ta, ja = flatten(t), flatten(j)
    assert set(ta) == set(ja), set(ta) ^ set(ja)
    if "geom.tt_top" in ja:
        ja["geom.tt_top"], ja["geom.tt_slabs"] = ttreelet.from_jax_layout(
            np.asarray(ja["geom.tt_top"]), np.asarray(ja["geom.tt_slabs"]))
    for k in ta:
        tv, jv = ta[k], np.asarray(ja[k])
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, k
        if k in ulp_keys:
            d = np.abs(tv.view(np.int32).astype(np.int64) - jv.view(np.int32))
            assert d.max() <= 2, (k, d.max())
        else:
            np.testing.assert_array_equal(bits(tv), bits(jv), err_msg=k)
    for k in ("mat_type", "mat_tex", "light_type", "world_lo", "world_hi"):
        np.testing.assert_array_equal(t.host[k], j.host[k], err_msg=k)


def assert_mesh_equal(t, j):
    for f in ("v", "f", "n", "uv"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture
def jax_native(monkeypatch, tmp_path):
    """The JAX build without its disk caches, on the port's native library."""
    monkeypatch.setattr(jnative, "_load", tnative._load)
    monkeypatch.setattr(jnative, "_build_cache_path",
                        lambda v0, v1, v2: str(tmp_path / "bvh8.npz"))
    monkeypatch.setattr(jtreelet, "partition_cached",
                        lambda table, **kw: jtreelet.partition(table, **kw))


def load_both(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return tmitsuba.load_mitsuba(str(p)), jmitsuba.load_mitsuba(str(p))


# ----------------------------------------------------------- mesh files --

def test_obj_negative_indices(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ_FILE)
    (tmp_path / "test.mtl").write_text(MTL_FILE)
    ts = tobj.load_obj(str(tmp_path / "test.obj"))
    js = jobj.load_obj(str(tmp_path / "test.obj"))
    assert len(ts) == len(js) == 1
    assert ts[0].mesh.f.shape == (2, 3)
    assert vars(ts[0].material) == vars(js[0].material)
    assert ts[0].material.kd == (0.2, 0.4, 0.6)
    assert_mesh_equal(ts[0].mesh, js[0].mesh)
    np.testing.assert_allclose(ts[0].mesh.n[0], [0, 0, 1], atol=1e-6)


def test_obj_fan_materials_and_generated_normals(tmp_path):
    """A pentagon (fan-triangulated), two usemtl groups, no normals (they
    are generated), a missing mtllib (default materials)."""
    (tmp_path / "p.obj").write_text(
        "mtllib none.mtl\nv 0 0 0\nv 1 0 0\nv 1.5 1 0\nv 0.5 1.6 0\nv -0.5 1 0\n"
        "v 0 0 1\nvt 0 0\nvt 1 1\nusemtl a\nf 1/1 2/2 3/1 4/2 5/1\nusemtl b\n"
        "f 1 2 6\n")
    ts = tobj.load_obj(str(tmp_path / "p.obj"))
    js = jobj.load_obj(str(tmp_path / "p.obj"))
    assert [s.mesh.f.shape[0] for s in ts] == [3, 1]
    for t, j in zip(ts, js):
        assert vars(t.material) == vars(j.material)
        assert_mesh_equal(t.mesh, j.mesh)


PLY_ASCII = """ply
format ascii 1.0
element vertex 3
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
0 1 0
3 0 1 2
"""


def test_ascii_ply(tmp_path):
    p = tmp_path / "t.ply"
    p.write_text(PLY_ASCII)
    t, j = tply.load_ply(str(p)), jply.load_ply(str(p))
    assert t.v.shape == (3, 3) and t.f.shape == (1, 3)
    assert_mesh_equal(t, j)


def _binary_ply(path, counts, endian="<"):
    """A binary PLY with normals and uv: a 6 x 6 vertex grid, and one face
    per entry of `counts` (its vertex count) over consecutive vertices."""
    r = np.random.default_rng(len(counts))
    n_v = 36
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    head = (f"ply\nformat {fmt} 1.0\nelement vertex {n_v}\nproperty float x\n"
            "property float y\nproperty float z\nproperty float nx\nproperty float ny\n"
            "property float nz\nproperty float u\nproperty float v\n"
            f"element face {len(counts)}\nproperty list uchar uint vertex_indices\n"
            "end_header\n").encode()
    vert = r.random((n_v, 8)).astype(endian + "f4")
    body = vert.tobytes()
    for k, c in enumerate(counts):
        body += struct.pack(endian + "B", c)
        body += np.asarray([(k + i) % n_v for i in range(c)], endian + "u4").tobytes()
    path.write_bytes(head + body)


@pytest.mark.parametrize("counts", [[3], [3] * 40, [4] * 25, [3, 4, 5, 3, 6], [5] * 7],
                         ids=["one", "tris", "quads", "mixed", "pentagons"])
@pytest.mark.parametrize("endian", ["<", ">"], ids=["le", "be"])
def test_binary_ply(tmp_path, counts, endian):
    """Binary face lists of triangles, quads and mixed polygons, fan
    triangulated as the JAX package does, in both byte orders."""
    p = tmp_path / "t.ply"
    _binary_ply(p, counts, endian)
    t, j = tply.load_ply(str(p)), jply.load_ply(str(p))
    assert t.f.shape == (sum(c - 2 for c in counts), 3)
    assert_mesh_equal(t, j)


def test_binary_ply_of_the_jax_test(tmp_path):
    head = (b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
            b"property float x\nproperty float y\nproperty float z\nelement face 1\n"
            b"property list uchar uint vertex_indices\nend_header\n")
    body = struct.pack("<9f", 0, 0, 0, 1, 0, 0, 0, 1, 0) + struct.pack("<B3I", 3, 0, 1, 2)
    p = tmp_path / "t.ply"
    p.write_bytes(head + body)
    t, j = tply.load_ply(str(p)), jply.load_ply(str(p))
    assert t.v.shape == (3, 3) and t.f.shape == (1, 3)
    assert_mesh_equal(t, j)


def test_serialized_v3_roundtrip(tmp_path):
    blob = struct.pack("<I", 0x1000) + struct.pack("<QQ", 3, 1)
    blob += struct.pack("<9f", 0, 0, 0, 1, 0, 0, 0, 1, 0) + struct.pack("<3I", 0, 1, 2)
    data = struct.pack("<HH", 0x041C, 3) + zlib.compress(blob)
    data += struct.pack("<I", 0) + struct.pack("<I", 1)
    p = tmp_path / "m.serialized"
    p.write_bytes(data)
    t, j = tser.load_serialized(str(p)), jser.load_serialized(str(p))
    assert t.v.shape == (3, 3) and t.f.shape == (1, 3)
    assert_mesh_equal(t, j)
    assert tser.count_shapes(str(p)) == 1


def test_serialized_v4_meshes(tmp_path):
    """chip_smoke.py's writer (version 4: names, normals and uv, one zlib
    stream per mesh): every mesh read back as written, by both packages."""
    r = np.random.default_rng(2)
    meshes = []
    for n_v, n_f in ((5, 4), (40, 70), (3, 1)):
        n = r.normal(size=(n_v, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        meshes.append((r.random((n_v, 3)).astype(np.float32),
                       r.integers(0, n_v, (n_f, 3)).astype(np.int32), n,
                       r.random((n_v, 2)).astype(np.float32)))
    p = str(tmp_path / "m.serialized")
    chip_smoke.write_serialized(p, meshes)
    assert tser.count_shapes(p) == 3
    for k, (v, f, n, uv) in enumerate(meshes):
        t, j = tser.load_serialized(p, k), jser.load_serialized(p, k)
        assert_mesh_equal(t, j)
        for a, b in ((t.v, v), (t.f, f), (t.n, n), (t.uv, uv)):
            np.testing.assert_array_equal(a, b)


def test_hdr_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((8, 16, 3)).astype(np.float32) * 10
    img[0, 0] = 0.0                                   # the zero-exponent texel
    p = str(tmp_path / "t.hdr")
    timages.write_hdr(p, img)
    q = str(tmp_path / "j.hdr")
    jimages.write_hdr(q, img)
    assert open(p, "rb").read() == open(q, "rb").read()
    back = timages.load_hdr(p)
    assert back.shape == img.shape and np.abs(back - img).max() / img.max() < 0.02
    np.testing.assert_array_equal(back, jimages.load_hdr(p))
    np.testing.assert_array_equal(timages.load_image(p), back)


def test_hdr_rle_scanlines(tmp_path):
    """A run-length-encoded Radiance file (runs and literals per channel)."""
    H, W = 3, 10
    data = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()
    for y in range(H):
        data += bytes([2, 2, 0, W])
        for c in range(4):
            vals = [(y * 40 + c * 7 + x) % 250 for x in range(4)] + [128 + c] * (W - 4)
            data += bytes([4]) + bytes(vals[:4]) + bytes([128 + W - 4, vals[4]])
    p = tmp_path / "rle.hdr"
    p.write_bytes(data)
    t = timages.load_hdr(str(p))
    assert t.shape == (H, W, 3)
    np.testing.assert_array_equal(t, jimages.load_hdr(str(p)))


def test_png_through_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    arr = np.random.default_rng(1).integers(0, 256, (6, 9, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(arr).save(p)
    for gamma in (True, False):
        t = timages.load_image(p, gamma=gamma)
        np.testing.assert_array_equal(t, jimages.load_image(p, gamma=gamma))
    np.testing.assert_allclose(timages.load_image(p, gamma=False), arr / 255.0, atol=1e-7)


def _write_exr(path, img):
    """A minimal OpenEXR file: one part, scanline, uncompressed, float
    R, G and B channels (what OpenEXR's readers accept as the plainest
    layout)."""
    H, W = img.shape[:2]

    def attr(name, kind, data):
        return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(data)) + data
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1)
                      for c in "BGR") + b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    head = (struct.pack("<ii", 20000630, 2) + attr("channels", "chlist", chlist)
            + attr("compression", "compression", b"\0") + attr("dataWindow", "box2i", box)
            + attr("displayWindow", "box2i", box) + attr("lineOrder", "lineOrder", b"\0")
            + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
            + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    lines = [struct.pack("<ii", y, 3 * 4 * W) + b"".join(
        np.ascontiguousarray(img[y, :, c], "<f4").tobytes() for c in (2, 1, 0))
        for y in range(H)]
    offset = len(head) + 8 * H
    table = b""
    for ln in lines:
        table += struct.pack("<Q", offset)
        offset += len(ln)
    with open(path, "wb") as fh:
        fh.write(head + table + b"".join(lines))


def test_exr_path(tmp_path):
    """An EXR goes through imageio, then cv2, as in the JAX package: the
    same image where a backend decodes it, the same IOError where none
    does."""
    pytest.importorskip("imageio.v3")
    img = np.random.default_rng(3).random((5, 7, 3)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    _write_exr(p, img)
    try:
        want = jimages.load_image(p)
    except IOError:
        with pytest.raises(IOError, match="cannot decode EXR"):
            timages.load_image(p)
        return
    got = timages.load_image(p)
    np.testing.assert_array_equal(got, want)
    assert got.shape == img.shape


# -------------------------------------------------------- small pieces --

@pytest.mark.parametrize("sun,turbidity,with_sun,res", [
    ((0.35, 0.7, 0.45), 3.0, True, 128), ((0.45, 0.75, -0.49), 2.2, True, 64),
    ((-0.2, 0.05, 0.9), 6.0, False, 32), ((0.0, 1.0, 0.0), 4.0, True, 48)])
def test_preetham_sky_bit_identical(sun, turbidity, with_sun, res):
    kw = dict(turbidity=turbidity, resolution=res, with_sun=with_sun,
              sky_scale=1.5, sun_scale=0.7)
    t, j = tsunsky.preetham_sky(sun, **kw), jsunsky.preetham_sky(sun, **kw)
    assert t.dtype == np.float32 and t.shape == (res, 2 * res, 3)
    np.testing.assert_array_equal(bits(t), bits(j))


def test_disk_and_surface_areas():
    for n_seg in (64, 7):
        t, j = tshapes.disk(n_seg), jshapes.disk(n_seg)
        assert_mesh_equal(t, j)
    area = tshapes.disk(64).surface_areas()
    np.testing.assert_array_equal(area, jshapes.disk(64).surface_areas())
    np.testing.assert_allclose(area.sum(), 0.5 * 64 * np.sin(2 * np.pi / 64), rtol=1e-6)
    sph = tshapes.sphere(0.5)
    np.testing.assert_array_equal(sph.surface_areas(), jshapes.sphere(0.5).surface_areas())


# ---------------------------------------------------------- asset cache --

@pytest.mark.parametrize("kind", ["obj", "ply", "serialized"])
def test_load_mesh_cached(tmp_path, kind):
    src = tmp_path / f"m.{kind}"
    if kind == "obj":
        src.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3\n")
    elif kind == "ply":
        _binary_ply(src, [4] * 5)
    else:
        v = np.random.default_rng(4).random((6, 3)).astype(np.float32)
        n = np.tile(np.float32([[0, 0, 1]]), (6, 1))
        chip_smoke.write_serialized(str(src), [(v, np.int32([[0, 1, 2], [3, 4, 5]]), n,
                                                np.zeros((6, 2), np.float32))])
    tdir, jdir = tmp_path / "tcache", tmp_path / "jcache"
    m1 = tcache.load_mesh_cached(str(src), cache_dir=str(tdir))
    assert len(list(tdir.glob("*.npz"))) == 1
    m2 = tcache.load_mesh_cached(str(src), cache_dir=str(tdir))   # from the cache
    assert_mesh_equal(m1, m2)
    assert_mesh_equal(m1, jcache.load_mesh_cached(str(src), cache_dir=str(jdir)))
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())


def test_film_checkpoint(tmp_path):
    """The port's checkpoint round trip (film on the CPU when asked), and
    files written by either package loaded by the other."""
    f = tfilm.new_film(8, 8, "cpu")
    f = tfilm.add_samples(f, torch.tensor([1]), torch.tensor([2]),
                          torch.tensor([[1.0, 2.0, 3.0]]))
    f = f._replace(n_passes=3.0)
    p = str(tmp_path / "ckpt.npz")
    tcache.save_film_checkpoint(p, f, 7)
    f2, pi = tcache.load_film_checkpoint(p, device="cpu")
    assert pi == 7 and f2.n_passes == 3.0 and f2.rgb.device.type == "cpu"
    for name in ("rgb", "weight", "splat"):
        np.testing.assert_array_equal(getattr(f2, name).numpy(), getattr(f, name).numpy())
    jf, jpi = jcache.load_film_checkpoint(p)
    assert jpi == 7
    np.testing.assert_array_equal(np.asarray(jf.rgb), f.rgb.numpy())
    q = str(tmp_path / "jax.npz")
    jcache.save_film_checkpoint(q, jfilm.new_film(4, 4), 2)
    f3, pi3 = tcache.load_film_checkpoint(q, device="cpu")
    assert pi3 == 2 and f3.rgb.shape == (4, 4, 3)


def test_film_checkpoint_defaults_to_the_card(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    tcache.save_film_checkpoint(p, tfilm.new_film(4, 4, "cpu"), 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcache.load_film_checkpoint(p)


# ---------------------------------------------------- scenes, both builds --

def test_scene_xml_builds_byte_identical(tmp_path):
    (tsc, tset), (jsc, jset) = load_both(tmp_path, "scene.xml", SCENE_XML)
    assert vars(tset) == vars(jset)
    assert tset.max_depth == 5 and tset.width == 48 and tset.spp == 8
    t, j = tsc.build("cpu"), jsc.build()
    assert_builds_equal(t, j)
    lt = t.lights.light_type.numpy()
    assert (lt == 1).sum() == 1 and (lt == 4).sum() == 1


INSTANCE_XML = """<scene version="0.5.0">
  <sensor type="perspective"><float name="fov" value="45"/>
    <transform name="toWorld"><lookat origin="0, 3, -9" target="0, 0, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="24"/><integer name="height" value="24"/></film>
  </sensor>
  <shape type="shapegroup" id="ball">
    <shape type="sphere"><float name="radius" value="0.6"/>
      <bsdf type="roughplastic"><float name="alpha" value="0.2"/></bsdf></shape>
  </shape>
  <shape type="instance"><ref id="ball"/><transform name="toWorld"><translate x="-2"/></transform></shape>
  <shape type="instance"><ref id="ball"/><transform name="toWorld"><translate x="0"/></transform></shape>
  <shape type="instance"><ref id="ball"/><transform name="toWorld"><scale value="0.5"/><translate x="2"/></transform></shape>
  <shape type="instance"><ref id="ball"/><transform name="toWorld"><rotate y="1" angle="30"/><translate z="2"/></transform></shape>
  <shape type="instance"><ref id="ball"/><transform name="toWorld"><translate y="1.5"/></transform></shape>
  <shape type="rectangle"><transform name="toWorld"><scale value="5"/><rotate x="1" angle="-90"/><translate y="-0.6"/></transform></shape>
  <shape type="disk"><transform name="toWorld"><rotate x="1" angle="90"/><translate y="4"/></transform>
    <emitter type="area"><rgb name="radiance" value="8, 8, 8"/></emitter></shape>
</scene>
"""


def test_instanced_xml_builds_byte_identical(tmp_path, jax_native):
    """A shapegroup instanced five times: five nodes sharing one mesh,
    which build(instancing="auto") makes one BLAS with instance rows."""
    (tsc, tset), (jsc, jset) = load_both(tmp_path, "inst.xml", INSTANCE_XML)
    assert vars(tset) == vars(jset)
    assert len({id(n.mesh) for n in tsc._nodes if n.name == "instance:ball"}) == 1
    t, j = tsc.build("cpu"), jsc.build()
    assert t.geom.inst is not None and t.geom.inst.root.shape[0] == 6
    assert_builds_equal(t, j)


SUNSKY_XML = """<scene version="0.5.0">
  <sensor type="thinlens"><float name="fov" value="50"/><float name="apertureRadius" value="0.05"/>
    <float name="focusDistance" value="4"/>
    <transform name="toWorld"><lookat origin="0, 1, -4" target="0, 0.5, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="16"/><integer name="height" value="12"/></film>
  </sensor>
  <bsdf type="coating" id="coat"><float name="intIOR" value="1.6"/>
    <bsdf type="roughconductor"><string name="material" value="ag"/></bsdf></bsdf>
  <shape type="cube"><ref id="coat"/></shape>
  <shape type="cylinder"><float name="radius" value="0.3"/><point name="p1" x="0" y="2" z="0"/>
    <bsdf type="blendbsdf"><float name="weight" value="0.3"/><bsdf type="ward"/><bsdf type="phong"/></bsdf></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1" angle="90"/><translate y="3"/></transform>
    <emitter type="area"><blackbody name="radiance" temperature="3200"/></emitter></shape>
  <shape type="sphere"><float name="radius" value="0.25"/><point name="center" x="1" y="0" z="0"/>
    <bsdf type="diffuse"><blackbody name="reflectance" temperature="9000"/></bsdf></shape>
  <emitter type="sunsky"><vector name="sunDirection" x="0.2" y="0.6" z="-0.5"/>
    <float name="turbidity" value="4"/><float name="scale" value="0.8"/></emitter>
  <emitter type="point"><point name="position" x="1" y="2" z="-1"/><rgb name="intensity" value="3, 3, 3"/></emitter>
</scene>
"""


def test_sunsky_blackbody_builds_equal(tmp_path):
    """The sun-and-sky map bit for bit; the blackbody colours (a light's
    radiance, a material's reflectance) within 2 ulp, everything else byte
    for byte."""
    (tsc, tset), (jsc, jset) = load_both(tmp_path, "sky.xml", SUNSKY_XML)
    assert vars(tset) == vars(jset)
    np.testing.assert_array_equal(bits(tsc._env["image"]), bits(jsc._env["image"]))
    t, j = tsc.build("cpu"), jsc.build()
    assert_builds_equal(t, j, ulp_keys=("lights.params", "materials.params"))


def test_envmap_fallbacks_as_jax(tmp_path):
    """An envmap or bitmap the loader cannot read becomes a grey 0.5 image
    and an OBJ map_kd it cannot read is dropped: the JAX package's
    semantics, kept; an envmap that exists loads as written."""
    img = np.random.default_rng(6).random((4, 8, 3)).astype(np.float32) * 3
    timages.write_hdr(str(tmp_path / "sky.hdr"), img)
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                    "usemtl t\nf 1 2 3\n")
    (tmp_path / "m.mtl").write_text("newmtl t\nKd 0.3 0.3 0.3\nmap_Kd nothere.png\n")
    for env, want in (("sky.hdr", timages.load_hdr(str(tmp_path / "sky.hdr"))),
                      ("missing.hdr", np.full((2, 2, 3), 0.5, np.float32))):
        xml = (f'<scene version="0.5.0"><sensor type="perspective"/><emitter '
               f'type="envmap"><string name="filename" value="{env}"/></emitter><shape type="obj"><string name="filename" '
               f'value="m.obj"/></shape><shape type="rectangle"><bsdf type="diffuse">'
               f'<texture type="bitmap" name="reflectance"><string name="filename" '
               f'value="nothere.png"/></texture></bsdf></shape></scene>')
        (tsc, _), (jsc, _) = load_both(tmp_path, "env.xml", xml)
        np.testing.assert_array_equal(tsc._env["image"], want)
        np.testing.assert_array_equal(tsc._env["image"], jsc._env["image"])
        assert tsc._materials[0]["tex"].tolist() == [-1, -1, -1, -1]   # map_kd dropped
        np.testing.assert_array_equal(tsc._textures[0].image, np.full((2, 2, 3), 0.5))
        assert_builds_equal(tsc.build("cpu"), jsc.build())


@pytest.fixture(scope="module")
def materials(tmp_path_factory):
    """chip_smoke.py's materials.xml at 32x32, loaded and built by both
    packages (the JAX build without its disk caches, its rough transmittance
    tables computed in process), and the JAX PathTracer's first two passes."""
    d = tmp_path_factory.mktemp("materials")
    path = str(d / "materials.xml")
    with open(path, "w") as fh:
        fh.write(chip_smoke.materials_xml(32))
    tables = {(k, round(float(e), 3)): jrt._compute_table(k, e)
              for k in (0, 1) for e in jrt._ETA_KNOTS}
    with mock.patch.object(jnative, "_load", tnative._load), \
            mock.patch.object(jnative, "_build_cache_path",
                              lambda v0, v1, v2: str(d / "bvh8.npz")), \
            mock.patch.object(jtreelet, "partition_cached",
                              lambda table, **kw: jtreelet.partition(table, **kw)), \
            mock.patch.object(jrt, "_CACHE", tables):
        tsc, tset = tmitsuba.load_mitsuba(path)
        jsc, jset = jmitsuba.load_mitsuba(path)
        t, j = tsc.build("cpu"), jsc.build()
        jtr = jpath.PathTracer(j, 32, 32, max_depth=5)
        films = []
        for _ in range(2):
            jtr.do_pass()
            films.append((np.asarray(jtr.film.rgb), np.asarray(jtr.film.weight),
                          jtr.rays_traced_live))
    return dict(t=t, j=j, tset=tset, jset=jset, films=films)


def test_materials_xml_builds_byte_identical(materials):
    t, j = materials["t"], materials["j"]
    assert vars(materials["tset"]) == vars(materials["jset"])
    assert tpath.scene_active_types(t) == tuple(range(16))
    assert t.num_tris == 63492 and t.geom.tt_top is not None
    assert_builds_equal(t, j, ulp_keys=("lights.params",))


def test_materials_pt_pass_for_pass(materials):
    """The port's PathTracer on the loaded all-types scene against the JAX
    one: the JAX package's tables, carried across, and the port's own
    build give the same passes."""
    ttr = tpath.PathTracer(materials["t"], 32, 32, max_depth=5)
    for j_rgb, j_w, j_rays in materials["films"]:
        ttr.do_pass()
        t_rgb = ttr.film.rgb.numpy()
        rel = np.abs(t_rgb - j_rgb).mean() / j_rgb.mean()
        assert rel < 0.005, rel
        np.testing.assert_array_equal(ttr.film.weight.numpy(), j_w)
        t_rays = ttr.rays_traced_live
        assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert ttr._ovf_dev.tolist() == [0, 0]
    assert np.isfinite(t_rgb).all() and t_rgb.mean() > 0.0
