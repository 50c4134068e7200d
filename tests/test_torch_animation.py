"""The port's scene/animation.py against the JAX package's.

`refit_wide`, `compose_pose`, the MD5 loaders and `pose_at_frame` are numpy
on both sides and must agree bit for bit; `skin_vertices` is torch against
jnp within 1e-6 (an einsum's summation order). Inputs: a seeded triangle
soup deformed by a stretch and a shift (tests/test_native_anim.py's
refit case), seeded random skins, and the JAX test's inline MD5 files
(tests/test_native_anim.py:154-199).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.scene import animation as janim
from cudatracerlib_tpu.scene import bvh8 as jbvh8
from cudatracerlib_tpu.ops import traversal8 as jtrav8
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.scene import animation as tanim
from cudatracerlib_tpu_torch.scene import bvh8 as tbvh8

sys.path.insert(0, os.path.dirname(__file__))
from test_native_anim import MD5ANIM, MD5MESH  # noqa: E402

torch.set_num_threads(2)


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _soup(n, seed=0, spread=6.0):
    r = np.random.default_rng(seed)
    base = (r.random((n, 3)) - 0.5).astype(np.float32) * spread
    return (base,
            base + (r.random((n, 3)).astype(np.float32) - 0.5) * 0.5,
            base + (r.random((n, 3)).astype(np.float32) - 0.5) * 0.5)


def test_refit_wide_matches_jax():
    v0, v1, v2 = _soup(3000, 3)
    b = tbvh8.build_bvh8(v0, v1, v2)
    jb = jbvh8.build_bvh8(v0, v1, v2)
    np.testing.assert_array_equal(bits(b.nodes), bits(jb.nodes))
    table = traversal8.pack_unified(b.nodes, b.leaves)

    def deform(v):
        return (v * np.array([1.2, 0.8, 1.0]) + np.array([0.3, -0.2, 0.5])).astype(np.float32)
    w0, w1, w2 = deform(v0), deform(v1), deform(v2)
    refit = tanim.refit_wide(table, b.nodes.shape[0], w0, w1, w2)
    jrefit = janim.refit_wide(jtrav8.pack_unified(jb.nodes, jb.leaves),
                              jb.nodes.shape[0], w0, w1, w2)
    np.testing.assert_array_equal(bits(refit), bits(jrefit))
    assert not np.array_equal(refit, table)          # the input stays as it was
    # the refit table traverses like a fresh build of the deformed soup
    r = np.random.default_rng(4)
    B = 512
    o = (r.random((B, 3)).astype(np.float32) - 0.5) * 9
    d = r.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.full((B,), 1e-4),
                torch.full((B,), 1e10))
    fresh = tbvh8.build_bvh8(w0, w1, w2)
    h_r = traversal8.intersect_wide(torch.from_numpy(refit), rays)
    h_f = traversal8.intersect_wide(torch.from_numpy(
        traversal8.pack_unified(fresh.nodes, fresh.leaves)), rays)
    assert torch.equal(h_r.valid, h_f.valid) and int(h_r.valid.sum()) > 50
    torch.testing.assert_close(h_r.t[h_r.valid], h_f.t[h_f.valid], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K", [1, 4])
def test_skin_vertices_matches_jax(K):
    rng = np.random.default_rng(21 + K)
    V, J = 257, 9
    pos = rng.normal(size=(V, 3)).astype(np.float32)
    ids = rng.integers(0, J, (V, K)).astype(np.int32)
    wts = rng.random((V, K)).astype(np.float32)
    wts /= wts.sum(1, keepdims=True)
    mats = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    mats[:, :3, :] += 0.3 * rng.normal(size=(J, 3, 4)).astype(np.float32)
    out = tanim.skin_vertices(*(torch.from_numpy(a) for a in (pos, ids, wts, mats)))
    ref = np.asarray(janim.skin_vertices(*(jnp.asarray(a) for a in (pos, ids, wts, mats))))
    assert out.dtype == torch.float32 and out.shape == (V, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_skinning_two_bones():
    """tests/test_native_anim.py::test_skinning on the port."""
    V = 8
    pos = np.stack([np.linspace(0, 7, V), np.zeros(V), np.zeros(V)], -1).astype(np.float32)
    bone_ids = np.zeros((V, 4), np.int32)
    bone_wts = np.zeros((V, 4), np.float32)
    bone_ids[:, 0] = (pos[:, 0] >= 4).astype(np.int32)
    bone_wts[:, 0] = 1.0
    mats = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    mats[1][:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    out = tanim.skin_vertices(*(torch.from_numpy(a) for a in
                                (pos, bone_ids, bone_wts, mats))).numpy()
    np.testing.assert_allclose(out[:4], pos[:4], atol=1e-5)          # bone 0 fixed
    np.testing.assert_allclose(out[4:, 1], pos[4:, 0], atol=1e-5)    # rotated x->y


def test_compose_pose_matches_jax():
    rng = np.random.default_rng(5)
    J = 7
    parents = np.array([-1, 0, 1, 1, 0, 4, -1], np.int32)
    local = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    local[:, :3, :] += 0.2 * rng.normal(size=(J, 3, 4)).astype(np.float32)
    bind_inv = np.linalg.inv(local).astype(np.float32)
    out = tanim.compose_pose(parents, local, bind_inv)
    np.testing.assert_array_equal(bits(out), bits(janim.compose_pose(parents, local, bind_inv)))
    assert out.dtype == np.float32


@pytest.fixture()
def md5(tmp_path):
    mp, ap = tmp_path / "m.md5mesh", tmp_path / "a.md5anim"
    mp.write_text(MD5MESH)
    ap.write_text(MD5ANIM)
    return str(mp), str(ap)


def test_md5_loaders_match_jax(md5):
    mp, ap = md5
    mesh, skel = tanim.load_md5mesh(mp)
    jmesh, jskel = janim.load_md5mesh(mp)
    for f in mesh._fields:
        np.testing.assert_array_equal(getattr(mesh, f), getattr(jmesh, f), err_msg=f)
    for f in skel._fields:
        np.testing.assert_array_equal(getattr(skel, f), getattr(jskel, f), err_msg=f)
    anim, janim_ = tanim.load_md5anim(ap), janim.load_md5anim(ap)
    for f in anim._fields:
        np.testing.assert_array_equal(getattr(anim, f), getattr(janim_, f), err_msg=f)
    assert anim.n_frames == 2 and anim.frame_rate == 24
    for frame in range(3):   # frames wrap around
        np.testing.assert_array_equal(
            bits(tanim.pose_at_frame(anim, skel, frame)),
            bits(janim.pose_at_frame(janim_, jskel, frame)))


def test_md5_skinning(md5):
    """tests/test_native_anim.py::test_md5_mesh_and_anim on the port: the
    bind pose skins to the rest positions; frame 1 lifts the arm's
    vertices by (0, 1, 0)."""
    mesh, skel = tanim.load_md5mesh(md5[0])
    anim = tanim.load_md5anim(md5[1])
    np.testing.assert_allclose(mesh.rest_pos[2], [2, 0, 0], atol=1e-6)
    args = [torch.from_numpy(np.asarray(a)) for a in (mesh.rest_pos, mesh.bone_ids,
                                                       mesh.bone_wts)]
    out0 = tanim.skin_vertices(*args, torch.from_numpy(tanim.pose_at_frame(anim, skel, 0)))
    np.testing.assert_allclose(out0.numpy(), mesh.rest_pos, atol=1e-5)
    out1 = tanim.skin_vertices(*args, torch.from_numpy(tanim.pose_at_frame(anim, skel, 1)))
    np.testing.assert_allclose(out1.numpy()[0], mesh.rest_pos[0], atol=1e-5)
    np.testing.assert_allclose(out1.numpy()[2], mesh.rest_pos[2] + [0, 1, 0], atol=1e-5)
