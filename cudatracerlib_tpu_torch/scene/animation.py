"""Skeletal animation: skinning and acceleration-structure refit.

Port of ``cudatracerlib_tpu/scene/animation.py``. Reference:
``Engine/AnimatedMesh.*`` (MD5 skeletal animation, up to 8 bone weights
per vertex, skinning kernels, then a BVH refit) and
``Engine/MeshLoader/MD5Parser``. Skinning is one gather and one einsum
over bone matrices, in torch on the tensors' device; the fat-row refit is
a backward numpy sweep over the unified table (children rows always follow
their parent row, so one sweep suffices). The host code and the MD5
parsers are carried over verbatim.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor


class SkinnedMesh(NamedTuple):
    rest_pos: np.ndarray    # (V, 3) bind-pose positions
    faces: np.ndarray       # (F, 3)
    bone_ids: np.ndarray    # (V, K) int32
    bone_wts: np.ndarray    # (V, K) f32 (rows sum to 1)
    uv: Optional[np.ndarray]


class Skeleton(NamedTuple):
    parents: np.ndarray     # (J,) int32, -1 for roots
    bind_inv: np.ndarray    # (J, 4, 4) inverse bind matrices


def skin_vertices(mesh_pos: Tensor, bone_ids: Tensor, bone_wts: Tensor,
                  bone_mats: Tensor) -> Tensor:
    """Linear-blend skinning: (V,3) = sum_k w_k * (M_{b_k} @ p).

    bone_mats: (J, 4, 4) object-space bone matrices (already composed with
    the inverse bind pose); every tensor on one device, the result on it
    too. One gather and one einsum.
    """
    mats = bone_mats[bone_ids.long()]                     # (V, K, 4, 4)
    p_h = torch.cat([mesh_pos, torch.ones_like(mesh_pos[:, :1])], -1)  # (V,4)
    transformed = torch.einsum("vkij,vj->vki", mats, p_h)[..., :3]
    return torch.sum(transformed * bone_wts[..., None], dim=1)


def compose_pose(parents: np.ndarray, local_mats: np.ndarray,
                 bind_inv: np.ndarray) -> np.ndarray:
    """Walk the hierarchy: global_j = global_parent @ local_j; returns the
    skinning matrices global @ bind_inv (host-side, tiny)."""
    J = parents.shape[0]
    glob = np.zeros_like(local_mats)
    for j in range(J):
        if parents[j] < 0:
            glob[j] = local_mats[j]
        else:
            glob[j] = glob[parents[j]] @ local_mats[j]
    return (glob @ bind_inv).astype(np.float32)


# ---------------------------------------------------------------------------
# fat-row BVH refit
# ---------------------------------------------------------------------------

def refit_wide(table: np.ndarray, n_node_rows: int, v0: np.ndarray,
               v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Refit the unified fat-row table in place for deformed vertices.

    Leaf rows are rebuilt from the stored triangle ids; node child-AABB slots
    are recomputed from their linked rows in one backward sweep (children rows
    always have larger indices than their parent)."""
    table = table.copy()
    e1 = v1 - v0
    e2 = v2 - v0
    # 1) rebuild leaf rows + compute their bounds
    n_rows = table.shape[0]
    leaf_bounds = np.zeros((n_rows, 6), np.float32)
    for row in range(n_node_rows, n_rows):
        r = table[row]
        ids = r[108:120].view(np.int32)
        k = int(r[120])
        tri = ids[:k]
        r[0:0 + k] = v0[tri, 0]; r[12:12 + k] = v0[tri, 1]; r[24:24 + k] = v0[tri, 2]
        r[36:36 + k] = e1[tri, 0]; r[48:48 + k] = e1[tri, 1]; r[60:60 + k] = e1[tri, 2]
        r[72:72 + k] = e2[tri, 0]; r[84:84 + k] = e2[tri, 1]; r[96:96 + k] = e2[tri, 2]
        pts = np.concatenate([v0[tri], v1[tri], v2[tri]], 0)
        leaf_bounds[row, 0:3] = pts.min(0)
        leaf_bounds[row, 3:6] = pts.max(0)
    # 2) backward sweep over node rows
    node_bounds = np.zeros((n_node_rows, 6), np.float32)
    for row in range(n_node_rows - 1, -1, -1):
        r = table[row]
        links = r[48:56].view(np.int32)
        lo_all = np.full(3, np.inf, np.float32)
        hi_all = np.full(3, -np.inf, np.float32)
        for slot in range(8):
            l = links[slot]
            if l == -1:
                continue
            if l <= -2:
                b = leaf_bounds[-2 - l]
            else:
                b = node_bounds[l]
            r[0 + slot] = b[0]; r[8 + slot] = b[1]; r[16 + slot] = b[2]
            r[24 + slot] = b[3]; r[32 + slot] = b[4]; r[40 + slot] = b[5]
            lo_all = np.minimum(lo_all, b[0:3])
            hi_all = np.maximum(hi_all, b[3:6])
        node_bounds[row, 0:3] = lo_all
        node_bounds[row, 3:6] = hi_all
    return table


# ---------------------------------------------------------------------------
# MD5 loader (md5mesh + md5anim)
# ---------------------------------------------------------------------------

def load_md5mesh(path: str):
    """Parse an id Tech 4 .md5mesh into (SkinnedMesh, Skeleton)."""
    text = open(path, "r", errors="replace").read()
    joints = []
    m = re.search(r"joints\s*\{(.*?)\}", text, re.S)
    for line in m.group(1).splitlines():
        jm = re.match(r'\s*"([^"]*)"\s+(-?\d+)\s*\(\s*([^)]*)\)\s*\(\s*([^)]*)\)', line)
        if jm:
            name, parent = jm.group(1), int(jm.group(2))
            pos = np.array([float(x) for x in jm.group(3).split()])
            q = np.array([float(x) for x in jm.group(4).split()])
            joints.append((name, parent, pos, q))
    J = len(joints)
    parents = np.array([j[1] for j in joints], np.int32)

    def quat_mat(qx, qy, qz, pos):
        t = 1.0 - qx * qx - qy * qy - qz * qz
        qw = -np.sqrt(max(t, 0.0))  # md5 convention: w <= 0
        m = np.eye(4, dtype=np.float32)
        x, y, z, w = qx, qy, qz, qw
        m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
        m[:3, 3] = pos
        return m

    bind = np.stack([quat_mat(*j[3], j[2]) for j in joints])
    bind_inv = np.linalg.inv(bind).astype(np.float32)

    verts_uv, weight_specs, tris = [], [], []
    for mesh_m in re.finditer(r"mesh\s*\{(.*?)\n\}", text, re.S):
        body = mesh_m.group(1)
        base_v = len(verts_uv)
        base_w = len(weight_specs)
        for vm in re.finditer(r"vert\s+\d+\s*\(\s*([^\)]*)\)\s+(\d+)\s+(\d+)", body):
            u, v = (float(x) for x in vm.group(1).split())
            verts_uv.append((u, v, base_w + int(vm.group(2)), int(vm.group(3))))
        for tm in re.finditer(r"tri\s+\d+\s+(\d+)\s+(\d+)\s+(\d+)", body):
            tris.append([base_v + int(tm.group(k)) for k in (1, 2, 3)])
        for wm in re.finditer(r"weight\s+\d+\s+(\d+)\s+([\d.eE+-]+)\s*\(\s*([^\)]*)\)", body):
            jid = int(wm.group(1))
            bias = float(wm.group(2))
            off = np.array([float(x) for x in wm.group(3).split()])
            weight_specs.append((jid, bias, off))

    V = len(verts_uv)
    K = 4  # keep the strongest 4 of up-to-8 weights (reference packs 8)
    pos = np.zeros((V, 3), np.float32)
    bone_ids = np.zeros((V, K), np.int32)
    bone_wts = np.zeros((V, K), np.float32)
    uv = np.zeros((V, 2), np.float32)
    for i, (u, v, wstart, wcount) in enumerate(verts_uv):
        ws = weight_specs[wstart:wstart + wcount]
        p = np.zeros(3)
        for (jid, bias, off) in ws:
            p += bias * (bind[jid][:3, :3] @ off + bind[jid][:3, 3])
        pos[i] = p
        uv[i] = (u, v)
        ws_sorted = sorted(ws, key=lambda t: -t[1])[:K]
        tot = sum(t[1] for t in ws_sorted) or 1.0
        for k, (jid, bias, off) in enumerate(ws_sorted):
            bone_ids[i, k] = jid
            bone_wts[i, k] = bias / tot

    mesh = SkinnedMesh(rest_pos=pos, faces=np.asarray(tris, np.int32),
                       bone_ids=bone_ids, bone_wts=bone_wts, uv=uv)
    return mesh, Skeleton(parents=parents, bind_inv=bind_inv)


def _quat_w(q3):
    t = 1.0 - float(np.dot(q3, q3))
    return -np.sqrt(max(t, 0.0))


def _quat_to_mat(q3, pos):
    x, y, z = q3
    w = _quat_w(q3)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    m[:3, 3] = pos
    return m


class MD5Anim(NamedTuple):
    frame_rate: float
    parents: np.ndarray          # (J,)
    base_pos: np.ndarray         # (J, 3)
    base_quat: np.ndarray        # (J, 3)
    flags: np.ndarray            # (J,)
    start_index: np.ndarray      # (J,)
    frames: np.ndarray           # (F, n_components)

    @property
    def n_frames(self):
        return self.frames.shape[0]

    def joint_locals(self, frame: int) -> np.ndarray:
        """(J, 4, 4) local joint matrices for one frame."""
        comp = self.frames[frame % self.n_frames]
        J = self.parents.shape[0]
        mats = np.zeros((J, 4, 4), np.float32)
        for j in range(J):
            pos = self.base_pos[j].copy()
            q = self.base_quat[j].copy()
            idx = int(self.start_index[j])
            fl = int(self.flags[j])
            for bit, target in ((0, ("p", 0)), (1, ("p", 1)), (2, ("p", 2)),
                                (3, ("q", 0)), (4, ("q", 1)), (5, ("q", 2))):
                if fl & (1 << bit):
                    kind, c = target
                    if kind == "p":
                        pos[c] = comp[idx]
                    else:
                        q[c] = comp[idx]
                    idx += 1
            mats[j] = _quat_to_mat(q, pos)
        return mats


def load_md5anim(path: str) -> MD5Anim:
    """Parse an id Tech 4 .md5anim (hierarchy, baseframe, frames)."""
    text = open(path, "r", errors="replace").read()
    frame_rate = float(re.search(r"frameRate\s+(\d+)", text).group(1))
    parents, flags, starts = [], [], []
    hm = re.search(r"hierarchy\s*\{(.*?)\}", text, re.S)
    for line in hm.group(1).splitlines():
        m = re.match(r'\s*"[^"]*"\s+(-?\d+)\s+(\d+)\s+(\d+)', line)
        if m:
            parents.append(int(m.group(1)))
            flags.append(int(m.group(2)))
            starts.append(int(m.group(3)))
    bm = re.search(r"baseframe\s*\{(.*?)\}", text, re.S)
    base_pos, base_quat = [], []
    for m in re.finditer(r"\(\s*([^\)]*)\)\s*\(\s*([^\)]*)\)", bm.group(1)):
        base_pos.append([float(x) for x in m.group(1).split()])
        base_quat.append([float(x) for x in m.group(2).split()])
    frames = []
    for fm in re.finditer(r"frame\s+\d+\s*\{(.*?)\}", text, re.S):
        frames.append([float(x) for x in fm.group(1).split()])
    return MD5Anim(frame_rate=frame_rate,
                   parents=np.asarray(parents, np.int32),
                   base_pos=np.asarray(base_pos, np.float32),
                   base_quat=np.asarray(base_quat, np.float32),
                   flags=np.asarray(flags, np.int32),
                   start_index=np.asarray(starts, np.int32),
                   frames=np.asarray(frames, np.float32) if frames else
                   np.zeros((1, 0), np.float32))


def pose_at_frame(anim: MD5Anim, skeleton: Skeleton, frame: int) -> np.ndarray:
    """Skinning matrices (J, 4, 4) for an animation frame."""
    locals_ = anim.joint_locals(frame)
    return compose_pose(anim.parents, locals_, skeleton.bind_inv)
