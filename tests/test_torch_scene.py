"""The port's own scene build against the JAX package's.

The Cornell box (2,232 triangles) stays under the JAX build's 4,096-triangle
switch to its native builder and disk cache, so both sides run the same
numpy binned-SAH build; every table must be byte-identical (compared as
uint32 views, which also covers the int32 ids bitcast into float32).

The 20,000-triangle San Miguel stand-in takes the native builder on both
sides (the port compiles its own copy of native/bvh_builder.cpp) and the
treelet split; the JAX package's disk caches are bypassed in the test, and
its native builder runs the library the port compiled from the same source
with the Makefile's flags.
The builder's threads share one spatial-split duplication budget, so two
builds could differ once it runs out; this scene stays well inside it
(asserted), and its tables are compared byte for byte."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudatracerlib_tpu.scene import native_bvh as jnative
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.scene import native_bvh as tnative
from cudatracerlib_tpu_torch.scene import schema as tschema
from cudatracerlib_tpu_torch.scene import treelet as ttreelet
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)


def flatten(tree, prefix=""):
    """NamedTuple tree -> {dotted leaf name: numpy array}, None leaves dropped."""
    out = {}
    for name in tree._fields:
        leaf = getattr(tree, name)
        key = f"{prefix}{name}"
        if leaf is None or isinstance(leaf, dict):
            continue
        if hasattr(leaf, "_fields"):
            out.update(flatten(leaf, key + "."))
        elif isinstance(leaf, torch.Tensor):
            out[key] = leaf.cpu().numpy()
        elif isinstance(leaf, int):
            out[key] = np.asarray(leaf, np.int32)
        else:
            out[key] = np.asarray(leaf)
    return out


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.fixture(scope="module")
def builds():
    jsc = jscenes.cornell_box(32, 32).build()
    tsc = tscenes.cornell_box(32, 32).build("cpu")
    return jsc, tsc


TABLES = ["geom.wide", "geom.shade", "geom.nodes", "geom.tri_order",
          "materials.", "lights.", "sensor.", "textures.", "media.",
          "world_lo", "world_hi"]


def test_cornell_build_byte_identical(builds):
    jsc, tsc = builds
    ja, ta = flatten(jsc), flatten(tsc)
    checked = 0
    for key in sorted(ta):
        if not any(key.startswith(p) for p in TABLES):
            continue
        assert key in ja, key
        jv, tv = np.asarray(ja[key]), ta[key]
        assert jv.shape == tv.shape, key
        assert jv.dtype == tv.dtype, key
        np.testing.assert_array_equal(bits(tv), bits(jv), err_msg=key)
        checked += 1
    assert checked >= 40
    assert tsc.geom.wide.dtype == torch.float32 and tsc.geom.wide.shape[1] == 128
    assert tsc.num_tris == jsc.num_tris == 2232


def test_host_meta_matches(builds):
    jsc, tsc = builds
    jm = jsc.host
    for k in ["mat_type", "mat_tex", "mat_alpha_mode", "world_lo",
              "world_hi", "light_type"]:
        np.testing.assert_array_equal(tsc.host[k], jm[k], err_msg=k)
    assert tsc.host["n_media"] == jm["n_media"] == 0


def test_scene_from_numpy_equals_port_build(builds):
    jsc, tsc = builds
    ja = {k: np.asarray(v) for k, v in flatten(jsc).items()}
    sc = tschema.scene_from_numpy(ja, jsc.host, "cpu")
    fa, ta = flatten(sc), flatten(tsc)
    assert set(fa) == set(ta)
    for k in ta:
        assert fa[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(bits(fa[k]), bits(ta[k]), err_msg=k)
    # the bitcast id columns arrive as bits, not converted values
    mat = sc.geom.shade[:, 23].view(torch.int32)
    assert int(mat.min()) == 0 and int(mat.max()) == 3
    assert sc.sensor.sensor_type == tschema.SENSOR_PERSPECTIVE


@pytest.fixture(scope="module")
def sm_builds(tmp_path_factory):
    cache = tmp_path_factory.mktemp("bvh8")
    with pytest.MonkeyPatch.context() as mp:
        # the JAX build's disk caches are bypassed, and its native builder
        # runs the library the port compiled from the same source with the
        # Makefile's flags (the JAX package would `make` it into native/,
        # which races between test workers)
        mp.setattr(jnative, "_load", tnative._load)
        mp.setattr(jnative, "_build_cache_path",
                   lambda v0, v1, v2: str(cache / "bvh8.npz"))
        mp.setattr(jtreelet, "partition_cached",
                   lambda table, **kw: jtreelet.partition(table, **kw))
        jsc = jscenes.san_miguel_stand_in(32, 32, target_tris=20000).build()
    tsc = tscenes.san_miguel_stand_in(32, 32, target_tris=20000).build("cpu")
    return jsc, tsc


def test_san_miguel_build_byte_identical(sm_builds):
    jsc, tsc = sm_builds
    ja, ta = flatten(jsc), flatten(tsc)
    checked = 0
    for key in sorted(ta):
        if key.startswith("geom.tt_") or not any(key.startswith(p) for p in TABLES):
            continue
        jv, tv = np.asarray(ja[key]), ta[key]
        assert jv.shape == tv.shape and jv.dtype == tv.dtype, key
        np.testing.assert_array_equal(bits(tv), bits(jv), err_msg=key)
        checked += 1
    assert checked >= 40
    # the treelet tables: the port keeps them row-major and unpadded
    top, slabs = ttreelet.from_jax_layout(ja["geom.tt_top"], ja["geom.tt_slabs"])
    np.testing.assert_array_equal(bits(ta["geom.tt_top"]), bits(top))
    np.testing.assert_array_equal(bits(ta["geom.tt_slabs"]), bits(slabs))
    np.testing.assert_array_equal(ta["geom.tt_vid"], ja["geom.tt_vid"])
    assert tsc.num_tris == jsc.num_tris > 19000
    assert tsc.geom.wide.shape == (2389, 128) and tsc.geom.tt_slabs.shape[0] == 6
    assert tsc.textures.texels.shape[0] == 87381        # 256^2 noise, full mip chain
    for k in ["mat_type", "mat_tex", "world_lo", "world_hi", "light_type"]:
        np.testing.assert_array_equal(tsc.host[k], jsc.host[k], err_msg=k)
    assert tsc.host["light_type"].tolist() == [tschema.LIGHT_DISTANT,
                                               tschema.LIGHT_INFINITE]
    # the builder stayed inside its duplication budget (refs < 1.4 T), so
    # its threads could not race for it: the build is deterministic
    wide = ta["geom.wide"]
    refs = int((wide[wide[:, 120] > 0][:, 108:120].view(np.int32) >= 0).sum())
    assert refs < 1.4 * tsc.num_tris - 1


def test_san_miguel_rebuild_and_bridge(sm_builds):
    jsc, tsc = sm_builds
    again = tscenes.san_miguel_stand_in(32, 32, target_tris=20000).build("cpu")
    np.testing.assert_array_equal(bits(again.geom.wide.numpy()),
                                  bits(tsc.geom.wide.numpy()))
    # the bridge carries the JAX build across, treelet tables included
    ja = {k: np.asarray(v) for k, v in flatten(jsc).items()}
    sc = tschema.scene_from_numpy(ja, jsc.host, "cpu")
    fa, ta = flatten(sc), flatten(tsc)
    assert set(fa) == set(ta)
    for k in ta:
        assert fa[k].dtype == ta[k].dtype and fa[k].shape == ta[k].shape, k
        np.testing.assert_array_equal(bits(fa[k]), bits(ta[k]), err_msg=k)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cudatracerlib_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cudatracerlib_tpu' or m.startswith('cudatracerlib_tpu.')]\n"
        "n = sum(m.startswith('cudatracerlib_tpu_torch.') for m in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["veach_mis", "veach_mis_anchor"])
def test_veach_build_byte_identical(name):
    """veach-mis (2,164 triangles) and its anchor variant (532) stay under
    the 4,096-triangle switch, so both packages run the numpy builder:
    geometry, fat rows, the rough-conductor materials (eta_c, k_c, alpha,
    distribution) and the area-light rows must be byte-identical."""
    jsc = getattr(jscenes, name)(32, 32).build()
    tsc = getattr(tscenes, name)(32, 32).build("cpu")
    ja, ta = flatten(jsc), flatten(tsc)
    checked = 0
    for key in sorted(ta):
        if not any(key.startswith(p) for p in TABLES):
            continue
        jv, tv = np.asarray(ja[key]), ta[key]
        assert jv.shape == tv.shape and jv.dtype == tv.dtype, key
        np.testing.assert_array_equal(bits(tv), bits(jv), err_msg=key)
        checked += 1
    assert checked >= 40
    for k in ["mat_type", "mat_tex", "world_lo", "world_hi", "light_type"]:
        np.testing.assert_array_equal(tsc.host[k], jsc.host[k], err_msg=k)
    assert tsc.host["mat_type"].tolist().count(tschema.BSDF_ROUGHCONDUCTOR) == 4
    assert tsc.host["light_type"].tolist() == [tschema.LIGHT_DIFFUSE] * 4
    if name == "veach_mis":
        assert tsc.num_tris == 2164 and tsc.geom.wide.shape == (331, 128)
        assert tsc.geom.tt_top is None


def test_entry_points_default_to_the_card(monkeypatch):
    """build(), sensor_data(), new_film() and scene_from_numpy() target the
    card unless asked for the CPU, and raise without one: nothing falls
    back to the CPU."""
    from cudatracerlib_tpu_torch.models import film as tfilm
    from cudatracerlib_tpu_torch.models import path as tpath
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tscenes.cornell_box(8, 8)
    for call in (sc.build, sc.sensor_data, lambda: tfilm.new_film(8, 8),
                 lambda: tschema.scene_from_numpy({}, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.build(torch.device("cuda", 0))
    built = sc.build("cpu")
    assert built.device.type == "cpu" and sc.sensor_data("cpu").params.device.type == "cpu"
    assert tfilm.new_film(8, 8, "cpu").rgb.device.type == "cpu"
    # the tracer and the example scenes take the device of the scene
    tr = tpath.PathTracer(built, 8, 8, max_depth=1)
    assert tr.film.rgb.device.type == "cpu"
    assert tscenes.veach_mis(8, 8).build(device="cpu").device.type == "cpu"
