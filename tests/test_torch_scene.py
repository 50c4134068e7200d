"""The port's own scene build against the JAX package's.

The Cornell box (2,232 triangles) stays under the JAX build's 4,096-triangle
switch to its native builder and disk cache, so both sides run the same
numpy binned-SAH build; every table must be byte-identical (compared as
uint32 views, which also covers the int32 ids bitcast into float32)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.scene import schema as tschema
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
    tsc = tscenes.cornell_box(32, 32).build()
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
