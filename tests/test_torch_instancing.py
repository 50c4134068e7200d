"""The port's two-level instancing against the JAX package's.

Scenes: the JAX tests' instanced scene (tests/test_instancing.py `_scene`:
a floor, an emissive light and five nodes sharing one 12x24 sphere; six
instances, the dense route) and its 529-instance grid (one 6x12 sphere
shared by a 23x23 grid; the TLAS route), built by both packages from the
same calls. Camera rays are made once by the port and handed to both as
numpy.

Bit for bit: the instanced build (`wide`, `shade`, the lights and every
InstanceTable field with `tlas` and `tlas_order`), `build_tlas8`,
`tlas_visits`, the InstanceTable after one `update_transforms` move,
`instancing="off"` against the flat build, a removed node.
Comparison rules for traversals (ROADMAP queue 3): validity identical;
t within rtol 1e-5 (XLA's FMA contraction on the CPU against PyTorch's
separate roundings); triangle and instance ids identical except where two
candidates tie in t (within 1e-5); u, v within atol 1e-4 (each package
rounds the ray's transform into local space its own way, and a small
triangle's barycentrics scale that up; tests/test_instancing.py holds
shading to 1e-4); any-hit lanes hit against no-hit only.
An instanced hit carries a LOCAL triangle id, so it is held to the
flattened build through t, validity and the scene node it lands on.
The treelet BLAS route runs under forced small partition limits
(max_top_rows=16, treelet_rows=128, as tests/test_instancing.py does),
JAX's Pallas kernels in interpret mode. The path tracer is held to the
JAX one pass for pass (< 0.5% mean relative error) and to the instanced
golden (< 0.02).
"""
import os
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import bdpt as jbdpt
from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.models import wavefront as jwf
from cudatracerlib_tpu.ops import instanced as jinst
from cudatracerlib_tpu.ops import shading as jshading
from cudatracerlib_tpu.ops import traversal as jtrav
from cudatracerlib_tpu.ops import traversal8 as jtrav8
from cudatracerlib_tpu.ops import traversal_tt as jtt
from cudatracerlib_tpu.scene import bvh8 as jbvh8
from cudatracerlib_tpu.scene import host as jhost
from cudatracerlib_tpu.scene import schema as jschema
from cudatracerlib_tpu.scene import sensors as jsensors
from cudatracerlib_tpu.scene import shapes as jshapes
from cudatracerlib_tpu.scene import treelet as jtreelet
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import transforms as jtf
from cudatracerlib_tpu_torch.models import bdpt as tbdpt
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.models import tracer as ttracer
from cudatracerlib_tpu_torch.models import wavefront as twf
from cudatracerlib_tpu_torch.ops import instanced as tinst
from cudatracerlib_tpu_torch.ops import shading as tshading
from cudatracerlib_tpu_torch.ops import traversal8, traversal_tt
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.scene import bvh8 as tbvh8
from cudatracerlib_tpu_torch.scene import host as thost
from cudatracerlib_tpu_torch.scene import schema as tschema
from cudatracerlib_tpu_torch.scene import sensors as tsensors
from cudatracerlib_tpu_torch.scene import shapes as tshapes
from cudatracerlib_tpu_torch.scene import treelet as ttreelet
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "instanced_48_pt.npz")
JAX = SimpleNamespace(host=jhost, schema=jschema, sensors=jsensors,
                      shapes=jshapes, tf=jtf)
PORT = SimpleNamespace(host=thost, schema=tschema, sensors=tsensors,
                       shapes=tshapes, tf=ttf)
MODES = ["closest", "any_hit", "mixed"]


def inst_scene(m, n_spheres=5, size=48):
    """tests/test_instancing.py `_scene` through the modules of `m`."""
    sc = m.host.DynamicScene()
    white = sc.add_material(m.host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    red = sc.add_material(m.host.MaterialSpec(reflectance=(0.6, 0.1, 0.1)))
    black = sc.add_material(m.host.MaterialSpec(reflectance=(0, 0, 0)))
    rect = m.shapes.rectangle()
    tf = m.tf
    sc.create_node(rect, white,
                   tf.compose(tf.translate([0, -1, 0]), tf.rotate_deg([1, 0, 0], -90),
                              tf.scale(4.0)), name="floor")
    sc.create_node(rect, black,
                   tf.compose(tf.translate([0, 2.5, 0]), tf.rotate_deg([1, 0, 0], 90),
                              tf.scale(1.0)), emission=(10.0, 10.0, 10.0), name="light")
    ball = m.shapes.sphere(radius=0.4, n_theta=12, n_phi=24)  # ONE mesh object
    for i in range(n_spheres):
        x = -1.6 + i * 0.8
        sc.create_node(ball, red if i % 2 else white,
                       tf.compose(tf.translate([x, -0.6, 0.3 * (i % 3)]),
                                  tf.scale(0.8 + 0.1 * i)), name=f"ball{i}")
    sc.set_sensor(m.sensors.make_sensor(
        m.schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0.5, -4.5], [0, -0.3, 0]),
        fov_x_deg=40.0, film_w=size, film_h=size))
    return sc


def grid_scene(m):
    """tests/test_instancing.py's 529-instance scene (the TLAS route)."""
    sc = m.host.DynamicScene()
    white = sc.add_material(m.host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    black = sc.add_material(m.host.MaterialSpec(reflectance=(0, 0, 0)))
    rect = m.shapes.rectangle()
    tf = m.tf
    sc.create_node(rect, white,
                   tf.compose(tf.translate([0, -1, 0]),
                              tf.rotate_deg([1, 0, 0], -90), tf.scale(40.0)),
                   name="floor")
    sc.create_node(rect, black,
                   tf.compose(tf.translate([0, 6, 0]),
                              tf.rotate_deg([1, 0, 0], 90), tf.scale(2.0)),
                   emission=(30.0, 30.0, 30.0), name="light")
    ball = m.shapes.sphere(radius=0.3, n_theta=6, n_phi=12)  # ONE mesh
    for gx in range(23):
        for gz in range(23):
            sc.create_node(ball, white,
                           tf.compose(tf.translate([(gx - 11) * 0.9, -0.7,
                                                    (gz - 11) * 0.9]),
                                      tf.scale(1.0)), name=f"b{gx}_{gz}")
    sc.set_sensor(m.sensors.make_sensor(
        m.schema.SENSOR_PERSPECTIVE, tf.look_at([0, 3.0, -14.0], [0, -0.5, 0]),
        fov_x_deg=50.0, film_w=32, film_h=32))
    return sc


SCENES = {"dense": (inst_scene, 48), "tlas": (grid_scene, 32)}


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def assert_tables_equal(port, ref, what):
    for f in port._fields:
        p, r = getattr(port, f), getattr(ref, f)
        if isinstance(p, (int, dict)):
            continue
        assert (p is None) == (r is None), f"{what}.{f}"
        if hasattr(p, "_fields"):
            assert_tables_equal(p, r, f"{what}.{f}")
        elif p is not None:
            np.testing.assert_array_equal(bits(p.cpu().numpy()), bits(np.asarray(r)),
                                          err_msg=f"{what}.{f}")


@pytest.fixture(scope="module")
def builds():
    out = {}
    with mock.patch.object(jtreelet, "partition_cached",
                           lambda table, **kw: jtreelet.partition(table, **kw)):
        for name, (make, size) in SCENES.items():
            tsc = make(PORT)
            t = tsc.build("cpu")
            j = make(JAX).build()
            pix = torch.arange(size * size, dtype=torch.int32)
            tr = ttracer.gen_camera_rays(t, pix, 0, 0, size, size)[0]
            jr = jtrav.Rays(*(jnp.asarray(x.numpy()) for x in tr))
            amask = np.random.default_rng(7).random(size * size) < 0.5
            out[name] = dict(tsc=tsc, t=t, j=j, tr=tr, jr=jr, amask=amask)
    return out


@pytest.fixture(scope="module")
def flats(builds):
    """The port's flattened builds of both scenes (the grid's 63,480
    triangles take the native builder)."""
    return {name: b["tsc"].build("cpu", instancing="off") for name, b in builds.items()}


def _kw(mode, amask, lib):
    if mode == "any_hit":
        return dict(any_hit=True)
    if mode == "mixed":
        return dict(any_mask=jnp.asarray(amask) if lib == "jax"
                    else torch.from_numpy(amask))
    return {}


def _any_lanes(mode, amask):
    return (np.ones(amask.shape, bool) if mode == "any_hit"
            else amask if mode == "mixed" else np.zeros(amask.shape, bool))


def check_hits(port, ref, any_lane, ids=("tri", "inst")):
    """The comparison rules above; returns the count of closest-hit lanes
    whose ids differ on a t-tie."""
    p_ok, r_ok = port.tri.numpy() >= 0, np.asarray(ref.tri) >= 0
    np.testing.assert_array_equal(p_ok, r_ok)
    cl = ~any_lane & p_ok
    p_t, r_t = port.t.numpy(), np.asarray(ref.t)
    np.testing.assert_allclose(p_t[cl], r_t[cl], rtol=1e-5, atol=1e-6)
    differ = np.zeros_like(cl)
    for f in ids:
        differ |= cl & (getattr(port, f).numpy() != np.asarray(getattr(ref, f)))
    assert np.all(np.abs(p_t[differ] - r_t[differ]) <= 1e-5 * np.abs(r_t[differ]))
    same = cl & ~differ
    np.testing.assert_allclose(port.u.numpy()[same], np.asarray(ref.u)[same], atol=1e-4)
    np.testing.assert_allclose(port.v.numpy()[same], np.asarray(ref.v)[same], atol=1e-4)
    return int(differ.sum())


def node_of(scene, hit):
    """The scene node each hit lands on (-1 for a miss): the instance's node,
    or for the flat part (node -1) the triangle's own."""
    tid = hit.tri.clamp_min(0).long()
    tri_node = scene.geom.shade[tid, 25].view(torch.int32)
    if hit.inst is None:
        node = tri_node
    else:
        inode = scene.geom.inst.node_id[hit.inst.clamp_min(0).long()]
        node = torch.where(inode >= 0, inode, tri_node)
    return torch.where(hit.tri >= 0, node, -1)


# ------------------------------------------------------------- the build --

@pytest.mark.parametrize("name", list(SCENES))
def test_instanced_build_byte_identical(builds, name):
    b = builds[name]
    t, j = b["t"], b["j"]
    assert t.geom.inst is not None and (t.geom.inst.tlas is not None) == (name == "tlas")
    assert_tables_equal(t.geom._replace(inst=None), j.geom._replace(inst=None), "geom")
    assert_tables_equal(t.geom.inst, j.geom.inst, "inst")
    assert_tables_equal(t.lights, j.lights, "lights")
    assert_tables_equal(t.materials, j.materials, "materials")
    np.testing.assert_array_equal(t.world_lo.numpy(), np.asarray(j.world_lo))
    np.testing.assert_array_equal(t.world_hi.numpy(), np.asarray(j.world_hi))
    for k in ("mat_type", "mat_tex", "world_lo", "world_hi", "light_type"):
        np.testing.assert_array_equal(t.host[k], j.host[k], err_msg=k)
    # the instance rows: the flat part (floor and light) first, with its
    # sentinels, then one row per sphere node in node order
    inst = t.geom.inst
    assert inst.node_id[0] == -1 and inst.mat_id[0] == -1 and inst.light_id[0] == -2
    n = inst.root.shape[0] - 1
    assert inst.node_id[1:].tolist() == list(range(2, 2 + n))
    assert b["tsc"]._inst_of_node == {node: node - 1 for node in range(2, 2 + n)}


def test_build_tlas8_byte_identical():
    rng = np.random.default_rng(11)
    lo = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2.0, (200, 3)).astype(np.float32)
    table, order = tbvh8.build_tlas8(lo, hi)
    jtable, jorder = jbvh8.build_tlas8(lo, hi)
    np.testing.assert_array_equal(bits(table), bits(jtable))
    np.testing.assert_array_equal(order, jorder)
    links = table[:, 48:56].view(np.int32)
    assert (links <= -2).any() and (links >= 0).any()


@pytest.mark.parametrize("scene", ["inst", "cornell"])
def test_instancing_off_is_the_flat_build(scene):
    """instancing="off" gives the flat build, byte for byte the JAX one;
    the Cornell box's shared rectangles save too few triangles to be
    instanced, so "auto" flattens it too."""
    if scene == "inst":
        t = inst_scene(PORT).build("cpu", instancing="off")
        j = inst_scene(JAX).build(instancing="off")
    else:
        t = tscenes.cornell_box(32, 32).build("cpu")
        j = jscenes.cornell_box(32, 32).build(instancing="off")
        off = tscenes.cornell_box(32, 32).build("cpu", instancing="off")
        assert_tables_equal(t.geom, off.geom, "geom")
    assert t.geom.inst is None
    assert_tables_equal(t.geom, j.geom, "geom")
    assert_tables_equal(t.lights, j.lights, "lights")
    with pytest.raises(ValueError):
        inst_scene(PORT).build("cpu", instancing="on")


def test_scene_from_numpy_instanced(builds):
    """A JAX instanced scene flattened to numpy comes back with its
    InstanceTable, equal to the port's own build."""
    def flatten(tree, prefix=""):
        out = {}
        for f in tree._fields:
            leaf = getattr(tree, f)
            if leaf is None or isinstance(leaf, dict):
                continue
            if hasattr(leaf, "_fields"):
                out.update(flatten(leaf, f"{prefix}{f}."))
            else:
                out[f"{prefix}{f}"] = np.asarray(leaf)
        return out
    j, t = builds["tlas"]["j"], builds["tlas"]["t"]
    sc = tschema.scene_from_numpy(flatten(j), jschema.host_meta(j), "cpu")
    assert sc.geom.inst is not None
    assert_tables_equal(sc.geom.inst, t.geom.inst, "inst")
    assert_tables_equal(sc.geom._replace(inst=None), t.geom._replace(inst=None), "geom")


def test_remove_node_compacts_as_jax():
    t, j = inst_scene(PORT), inst_scene(JAX)
    for sc in (t, j):
        sc.remove_node(3)
    ts, js = t.build("cpu"), j.build()
    assert_tables_equal(ts.geom._replace(inst=None), js.geom._replace(inst=None), "geom")
    assert_tables_equal(ts.geom.inst, js.geom.inst, "inst")
    assert ts.geom.inst.root.shape[0] == 5


# --------------------------------------------------------- the traversal --

def test_tlas_visits_match_jax(builds):
    b = builds["tlas"]
    inst, jinst_t = b["t"].geom.inst, b["j"].geom.inst
    reads = tinst.host_reads
    visits, counts, dropped, steps = tinst.tlas_visits(inst.tlas, inst.tlas_order,
                                                       b["tr"], with_iters=True)
    jv, jc, jd = jinst.tlas_visits(jinst_t.tlas, jinst_t.tlas_order, b["jr"])
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert int(dropped) == int(jd) == 0
    assert visits.shape == (tinst.TLAS_VISITS, 32 * 32) and int(counts.max()) >= 1
    # one exit test read back per step and one for the exit
    assert 2 <= tinst.host_reads - reads <= tinst.TLAS_MAX_ITERS + 1
    assert steps.dtype == torch.int64 and int(steps) > 0
    # a budget of 1 drops visits, counted
    _, c1, d1 = tinst.tlas_visits(inst.tlas, inst.tlas_order, b["tr"], max_visits=1)
    _, _, jd1 = jinst.tlas_visits(jinst_t.tlas, jinst_t.tlas_order, b["jr"], max_visits=1)
    assert int(d1) == int(jd1) > 0 and int(c1.max()) == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SCENES))
def test_intersect_instanced_matches_jax(builds, name, mode):
    b = builds[name]
    any_lane = _any_lanes(mode, b["amask"])
    hit, iters, rows, ovf = traversal8.intersect_scene(
        b["t"].geom, b["tr"], with_iters=True, **_kw(mode, b["amask"], "torch"))
    jhit = jtrav8.intersect_scene(b["j"].geom, b["jr"], **_kw(mode, b["amask"], "jax"))
    assert hit.inst is not None and hit.inst.dtype == torch.int32
    ties = check_hits(hit, jhit, any_lane)
    assert ties <= 4
    assert int(iters) == int(rows) > 0 and ovf.tolist() == [0, 0]


@pytest.mark.parametrize("name", list(SCENES))
def test_instanced_matches_flattened(builds, flats, name):
    """The two-level build against the flattened build of the same scene
    (the port's, both ways): hits, the node each lands on and the shading
    frames (tests/test_instancing.py's tolerances)."""
    b = builds[name]
    flat = flats[name]
    hf = traversal8.intersect_scene(flat.geom, b["tr"])
    hi = traversal8.intersect_scene(b["t"].geom, b["tr"])
    assert torch.equal(hf.valid, hi.valid)
    both = hf.valid
    torch.testing.assert_close(hi.t[both], hf.t[both], rtol=1e-5, atol=1e-5)
    assert torch.equal(node_of(b["t"], hi), node_of(flat, hf))
    sif = tshading.fill_dg(flat.geom, b["tr"], hf, flip_to_ray=False)
    sii = tshading.fill_dg(b["t"].geom, b["tr"], hi, flip_to_ray=False)
    for f in ("p", "ns", "ng", "uv", "frame_t"):
        torch.testing.assert_close(getattr(sii, f)[both], getattr(sif, f)[both],
                                   rtol=0, atol=1e-4, msg=f)
    assert torch.equal(sii.mat_id[both], sif.mat_id[both])
    assert torch.equal(sii.light_id[both], sif.light_id[both])
    # shadow rays: hit against no-hit
    assert torch.equal(traversal8.intersect_scene(flat.geom, b["tr"], any_hit=True).valid,
                       traversal8.intersect_scene(b["t"].geom, b["tr"], any_hit=True).valid)
    assert int(flat.geom.wide.shape[0]) > 2 * int(b["t"].geom.wide.shape[0])


def test_any_mask_instanced(builds):
    """tests/test_any_mask.py:113-134 on the port: a mixed call through the
    two-level path gives the closest-hit result on closest lanes (ids
    included) and the any-hit verdict on masked lanes."""
    b = builds["dense"]
    B = 1024
    tr = Rays(*(x[::2][:B].contiguous() for x in b["tr"]))
    mask = torch.from_numpy(np.arange(B) % 2 == 1)
    geom = b["t"].geom
    h_mixed = traversal8.intersect_scene(geom, tr, any_mask=mask)
    h_c = traversal8.intersect_scene(geom, tr)
    h_a = traversal8.intersect_scene(geom, tr, any_hit=True)
    cl = ~mask
    for f in ("t", "tri", "u", "v", "inst"):
        assert torch.equal(getattr(h_mixed, f)[cl], getattr(h_c, f)[cl]), f
    assert torch.equal(h_mixed.valid[mask], h_a.valid[mask])
    assert bool(h_c.valid.any()) and bool((h_mixed.valid & mask).any())


@pytest.fixture(scope="module")
def forest(builds):
    """The dense scene's BLAS forest split under forced small limits, as
    tests/test_instancing.py:180-215 does, with each instance's top-local
    root; the same geometry for both packages."""
    b = builds["dense"]
    geom = b["t"].geom
    table = geom.wide.numpy()
    roots_np = geom.inst.root.numpy()
    uroots = tuple(int(r) for r in np.unique(roots_np))
    assert len(uroots) >= 2
    part = ttreelet.partition(table, treelet_rows=128, max_top_rows=16, roots=uroots)
    jpart = jtreelet.partition(table, treelet_rows=128, max_top_rows=16, roots=uroots)
    np.testing.assert_array_equal(bits(part.top), bits(jpart.top))
    np.testing.assert_array_equal(part.root_top, jpart.root_top)
    r2t = {r: int(t) for r, t in zip(uroots, part.root_top)}
    root_top = np.asarray([r2t[int(r)] for r in roots_np], np.int32)
    geom_tt = geom._replace(
        tt_top=torch.from_numpy(part.top), tt_slabs=torch.from_numpy(part.slabs),
        tt_vid=torch.from_numpy(part.vid_map),
        inst=geom.inst._replace(root_top=torch.from_numpy(root_top)))
    top_t, slabs_t = jtreelet.prep_device(jpart)
    jgeom = b["j"].geom
    jgeom_tt = jgeom._replace(
        tt_top=jnp.asarray(top_t), tt_slabs=jnp.asarray(slabs_t),
        tt_vid=jnp.asarray(jpart.vid_map),
        inst=jgeom.inst._replace(root_top=jnp.asarray(root_top)))
    # 1,024 rays (every other pixel of the first half): JAX interprets its
    # Pallas kernels on the CPU
    sel = slice(0, 2048, 2)
    tr = Rays(*(x[sel].contiguous() for x in b["tr"]))
    jr = jtrav.Rays(*(jnp.asarray(x.numpy()) for x in tr))
    return dict(geom=geom, geom_tt=geom_tt, jgeom_tt=jgeom_tt, part=part,
                jpart=jpart, tr=tr, jr=jr, amask=b["amask"][sel],
                root_top=root_top, jtop=jnp.asarray(top_t),
                jslabs=jnp.asarray(slabs_t), jvid=jnp.asarray(jpart.vid_map))


@pytest.mark.parametrize("mode", ["closest", "any_hit"])
def test_treelet_blas_route(forest, mode):
    """The treelet BLAS route (K2 from top-local roots, K3, the K1 fallback
    from global roots; their plain versions here) against the port's plain
    instanced route (K1 with roots) and against the JAX treelet route."""
    f = forest
    any_lane = _any_lanes(mode, f["amask"])
    calls = []
    orig = traversal_tt.top_visits

    def spy(*a, **kw):
        calls.append(kw.get("roots"))
        return orig(*a, **kw)
    with mock.patch.object(traversal_tt, "top_visits", spy):
        h_tt, iters, _, ovf = traversal8.intersect_scene(
            f["geom_tt"], f["tr"], with_iters=True, **_kw(mode, f["amask"], "torch"))
    # one phase 1 per instance visit (dense route: I visits), each with roots
    I = f["geom"].inst.root.shape[0]
    assert len(calls) == I and all(r is not None for r in calls)
    h_ref = traversal8.intersect_scene(f["geom"], f["tr"], **_kw(mode, f["amask"], "torch"))
    if mode == "closest":
        for fld in ("t", "tri", "inst", "u", "v"):
            assert torch.equal(getattr(h_tt, fld), getattr(h_ref, fld)), fld
    else:
        assert torch.equal(h_tt.valid, h_ref.valid)
    assert ovf.tolist() == [0, 0] and int(iters) > 0
    jax.clear_caches()   # FORCE_TREELET is outside jit cache keys
    with mock.patch.object(jtrav8, "FORCE_TREELET", True):
        jh = jtrav8.intersect_scene(f["jgeom_tt"], f["jr"], **_kw(mode, f["amask"], "jax"))
    jax.clear_caches()
    check_hits(h_tt, jh, any_lane)


def test_top_visits_roots_match_jax(forest):
    """K2's plain version with per-lane top-local roots against JAX's phase 1
    (intersect_treelet cut after phase 1), rays split between the two BLAS
    roots; roots of zeros are the rootless call, bit for bit."""
    f = forest
    top = torch.from_numpy(f["part"].top)
    B = f["tr"].o.shape[0]
    root_top = f["part"].root_top
    roots = torch.from_numpy(np.where(np.arange(B) % 3 == 0, root_top[0],
                                      root_top[-1]).astype(np.int32))
    for V in (3, 6):
        hit1, vids, vent, vcnt, mdrop, steps, flags = traversal_tt.top_visits(
            top, f["tr"], V, roots=roots)
        jh = jtt.intersect_treelet(f["jtop"], f["jslabs"], f["jvid"], f["jr"], V=V,
                                   _stage=1, roots=jnp.asarray(roots.numpy()))
        check_hits(hit1, jh, np.zeros(B, bool), ids=("tri",))
        assert int(flags.sum()) == 0 and int(vcnt.sum()) > 0
        z = traversal_tt.top_visits(top, f["tr"], V, roots=torch.zeros(B, dtype=torch.int32))
        plain = traversal_tt.top_visits(top, f["tr"], V)
        for a, c in zip((*z[0], *z[1:]), (*plain[0], *plain[1:])):
            if a is not None:
                assert torch.equal(a, c)


def test_fill_dg_instanced_matches_jax(builds):
    b = builds["dense"]
    hit = traversal8.intersect_scene(b["t"].geom, b["tr"])
    jhit = jtrav8.intersect_scene(b["j"].geom, b["jr"])
    same = (hit.tri.numpy() == np.asarray(jhit.tri)) & (hit.inst.numpy() == np.asarray(jhit.inst))
    same &= hit.tri.numpy() >= 0
    assert same.sum() > 1000
    for flip in (True, False):
        si = tshading.fill_dg(b["t"].geom, b["tr"], hit, flip_to_ray=flip)
        ji = jshading.fill_dg(b["j"].geom, b["jr"], jhit, flip_to_ray=flip)
        for f in ("p", "ns", "ng", "uv", "frame_t", "frame_s", "uv_density"):
            np.testing.assert_allclose(getattr(si, f).numpy()[same],
                                       np.asarray(getattr(ji, f))[same],
                                       rtol=1e-4, atol=1e-4, err_msg=f)
        for f in ("mat_id", "light_id", "flipped"):
            np.testing.assert_array_equal(getattr(si, f).numpy()[same],
                                          np.asarray(getattr(ji, f))[same], err_msg=f)
    # the per-instance material overrides: red and white spheres
    assert len(set(si.mat_id[hit.inst >= 1].tolist())) == 2


# ------------------------------------------------------------- updates --

@pytest.mark.parametrize("name", list(SCENES))
def test_update_transforms_instance_rows_match_jax(builds, name):
    make, _ = SCENES[name]
    tsc, jsc = make(PORT), make(JAX)
    t0, j0 = tsc.build("cpu"), jsc.build()
    before = t0.geom.inst.l2w.clone()
    nid = 3
    m_t = ttf.compose(ttf.translate([1.5, -0.2, -0.5]), ttf.scale(0.9))
    m_j = jtf.compose(jtf.translate([1.5, -0.2, -0.5]), jtf.scale(0.9))
    t1 = tsc.update_transforms(t0, {nid: m_t})
    j1 = jsc.update_transforms(j0, {nid: m_j})
    assert_tables_equal(t1.geom.inst, j1.geom.inst, "inst")
    np.testing.assert_array_equal(t1.world_lo.numpy(), np.asarray(j1.world_lo))
    np.testing.assert_array_equal(t1.world_hi.numpy(), np.asarray(j1.world_hi))
    # the old scene is untouched, the tables other than the instances shared
    assert torch.equal(t0.geom.inst.l2w, before)
    assert t1.geom.wide is t0.geom.wide
    # and it equals a fresh build at the new transform
    assert_tables_equal(t1.geom.inst, tsc.build("cpu").geom.inst, "fresh")
    # moving a node of the flattened part rebuilds
    t2 = tsc.update_transforms(t1, {0: ttf.translate([0, -1.1, 0])})
    assert_tables_equal(t2.geom, tsc.build("cpu").geom, "rebuild")


def _flat_refit(tsc, jsc, moves):
    t0, j0 = tsc.build("cpu", instancing="off"), jsc.build(instancing="off")
    t1 = tsc.update_transforms(t0, {n: m for n, (m, _) in moves.items()})
    j1 = jsc.update_transforms(j0, {n: m for n, (_, m) in moves.items()})
    return t0, t1, j1


def test_flat_refit_matches_jax():
    """The flat branch: refit_wide's table, the repacked shade rows, the
    area lights' rows (the light node moves too) and the bounds, bit for
    bit; traversal of the refit table matches a fresh build's hits."""
    tsc, jsc = inst_scene(PORT), inst_scene(JAX)
    moves = {3: (ttf.translate([0.2, 0.3, -0.4]), jtf.translate([0.2, 0.3, -0.4])),
             1: (ttf.compose(ttf.translate([0.3, 2.4, 0]), ttf.rotate_deg([1, 0, 0], 90)),
                 jtf.compose(jtf.translate([0.3, 2.4, 0]), jtf.rotate_deg([1, 0, 0], 90)))}
    t0, t1, j1 = _flat_refit(tsc, jsc, moves)
    for f in ("wide", "shade"):
        np.testing.assert_array_equal(bits(getattr(t1.geom, f).numpy()),
                                      bits(np.asarray(getattr(j1.geom, f))), err_msg=f)
    np.testing.assert_array_equal(bits(t1.lights.al_rows.numpy()),
                                  bits(np.asarray(j1.lights.al_rows)))
    assert not torch.equal(t1.lights.al_rows, t0.lights.al_rows)
    np.testing.assert_array_equal(t1.world_lo.numpy(), np.asarray(j1.world_lo))
    assert t1.host["world_hi"].tolist() == t1.world_hi.tolist()
    # hits on the refit table against a fresh flat build at the new pose
    fresh = tsc.build("cpu", instancing="off")
    pix = torch.arange(48 * 48, dtype=torch.int32)
    tr = ttracer.gen_camera_rays(fresh, pix, 0, 0, 48, 48)[0]
    hr = traversal8.intersect_scene(t1.geom, tr)
    hf = traversal8.intersect_scene(fresh.geom, tr)
    assert torch.equal(hr.valid, hf.valid)
    torch.testing.assert_close(hr.t[hf.valid], hf.t[hf.valid], rtol=1e-5, atol=1e-5)


def test_flat_refit_refreshes_treelets(monkeypatch):
    """A split flat table's refit repacks its treelet tables, byte for byte
    the JAX package's (both splits forced at 128 top rows, as
    tests/test_refit_treelet.py does)."""
    tpart, jpart = ttreelet.partition, jtreelet.partition
    monkeypatch.setattr(thost.treeletmod, "partition",
                        lambda table, **kw: tpart(table, max_top_rows=128, **kw))
    monkeypatch.setattr(jtreelet, "partition_cached",
                        lambda table, **kw: jpart(table, max_top_rows=128, **kw))
    tsc, jsc = inst_scene(PORT), inst_scene(JAX)
    moves = {4: (ttf.translate([0.0, 0.5, 0.0]), jtf.translate([0.0, 0.5, 0.0]))}
    t0, t1, j1 = _flat_refit(tsc, jsc, moves)
    assert t0.geom.tt_slabs is not None
    top, slabs = ttreelet.from_jax_layout(np.asarray(j1.geom.tt_top),
                                          np.asarray(j1.geom.tt_slabs))
    np.testing.assert_array_equal(bits(t1.geom.tt_top.numpy()), bits(top))
    np.testing.assert_array_equal(bits(t1.geom.tt_slabs.numpy()), bits(slabs))
    np.testing.assert_array_equal(t1.geom.tt_vid.numpy(), np.asarray(j1.geom.tt_vid))
    assert not torch.equal(t1.geom.tt_slabs, t0.geom.tt_slabs)


# ------------------------------------------------------------ the tracers --

def test_pt_instanced_pass_for_pass():
    jtr = jpath.PathTracer(inst_scene(JAX, size=32).build(), 32, 32, max_depth=4)
    ttr = tpath.PathTracer(inst_scene(PORT, size=32).build("cpu"), 32, 32, max_depth=4)
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j_rgb = np.asarray(jtr.film.rgb)
        t_rgb = ttr.film.rgb.numpy()
        rel = np.abs(t_rgb - j_rgb).mean() / j_rgb.mean()
        assert rel < 0.005, rel
        j_rays, t_rays = jtr.rays_traced_live, ttr.rays_traced_live
        assert abs(t_rays - j_rays) <= 1e-3 * j_rays, (t_rays, j_rays)
    assert ttr._ovf_dev.tolist() == [0, 0]


@pytest.mark.parametrize("name", ["dense", "tlas"])
def test_wavefront_instanced_matches_pt(name):
    """WavefrontPT on the instanced scenes against the port's chunked
    PathTracer (one chunk), as tests/test_torch_wavefront.py holds it on
    the Cornell box: 768 lanes for 1,024 paths (several regeneration
    waves), the images within rtol 1e-5 / atol 1e-7, the live rays equal.
    A hit that lost its instance id through the wavefront's merged split
    would shade with local triangle ids and fail this."""
    fn, _ = SCENES[name]
    scene = (fn(PORT, size=32) if name == "dense" else fn(PORT)).build("cpu")
    pt = tpath.PathTracer(scene, 32, 32, max_depth=4, chunk_size=32 * 32)
    wf = twf.WavefrontPT(scene, 32, 32, max_depth=4, lanes=768)
    i1, i2 = pt.render(2).numpy(), wf.render(2).numpy()
    assert np.isfinite(i2).all() and i2.mean() > 0
    np.testing.assert_allclose(i2, i1, rtol=1e-5, atol=1e-7)
    assert wf.rays_traced_live == pt.rays_traced_live
    assert wf._ovf_dev.tolist() == [0, 0]


def test_wavefront_instanced_matches_jax():
    """WavefrontPT on the six-instance scene at 32x32, depth 4, 768 lanes,
    2 passes, against the JAX package's: the film within a mean relative
    error of 0.5%, the weights equal, the live rays within 0.1%, the size
    and limits of test_pt_instanced_pass_for_pass. (At 16x16, depth 3,
    the port traces 562 live rays to JAX's 558: bounces off the light
    that leave along its plane get d.y exactly 0 from XLA and -3e-7 from
    PyTorch; at depth 2 the flat build differs the same way, 529 to 528.)"""
    jtr = jwf.WavefrontPT(inst_scene(JAX, size=32).build(), 32, 32, max_depth=4,
                          lanes=768)
    ttr = twf.WavefrontPT(inst_scene(PORT, size=32).build("cpu"), 32, 32,
                          max_depth=4, lanes=768)
    for _ in range(2):
        jtr.do_pass()
        ttr.do_pass()
        j, t = np.asarray(jtr.film.rgb), ttr.film.rgb.numpy()
        assert np.abs(t - j).mean() / np.abs(j).mean() < 0.005
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        j_rays = jtr.rays_traced_live
        assert abs(ttr.rays_traced_live - j_rays) <= 1e-3 * j_rays


def test_instanced_golden():
    """tests/test_goldens_family.py's instanced golden on the port."""
    inst = inst_scene(PORT).build("cpu")
    img = tpath.PathTracer(inst, 48, 48, max_depth=4, spp_per_pass=1).render(8).numpy()
    ref = np.load(GOLDEN)["img"]
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.02, f"golden drift {rel:.4f}"


def test_bdpt_instanced_pass():
    """One 16x16 BDPT pass on the instanced scene: the light-path
    integrators reach two-level scenes through the same traversal."""
    j = jbdpt.BDPT(inst_scene(JAX, size=16).build(), 16, 16, max_depth=4)
    t = tbdpt.BDPT(inst_scene(PORT, size=16).build("cpu"), 16, 16, max_depth=4)
    j_img = np.asarray(j.render(1))
    t_img = t.render(1).numpy()
    assert np.isfinite(t_img).all() and t_img.mean() > 0
    rel = np.abs(t_img - j_img).mean() / j_img.mean()
    assert rel < 0.005, rel
