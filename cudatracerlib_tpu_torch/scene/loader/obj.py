"""Wavefront OBJ + MTL loader (host side, numpy).

Verbatim port of ``cudatracerlib_tpu/scene/loader/obj.py``: polygon fan
triangulation, negative indices, per-`usemtl` submeshes and smooth-normal
generation.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import shapes


@dataclass
class ObjMaterial:
    name: str = ""
    kd: Tuple[float, float, float] = (0.7, 0.7, 0.7)
    ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ke: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ns: float = 10.0
    ni: float = 1.5
    d: float = 1.0
    illum: int = 2
    map_kd: Optional[str] = None
    map_bump: Optional[str] = None
    map_d: Optional[str] = None


@dataclass
class ObjSubMesh:
    mesh: shapes.TriMesh
    material: ObjMaterial


def load_mtl(path: str) -> Dict[str, ObjMaterial]:
    mats: Dict[str, ObjMaterial] = {}
    cur: Optional[ObjMaterial] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = ObjMaterial(name=" ".join(parts[1:]))
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                cur.kd = tuple(float(x) for x in parts[1:4])
            elif key == "ks" and len(parts) >= 4:
                cur.ks = tuple(float(x) for x in parts[1:4])
            elif key == "ke" and len(parts) >= 4:
                cur.ke = tuple(float(x) for x in parts[1:4])
            elif key == "ns":
                cur.ns = float(parts[1])
            elif key == "ni":
                cur.ni = float(parts[1])
            elif key in ("d",):
                cur.d = float(parts[1])
            elif key == "tr":
                cur.d = 1.0 - float(parts[1])
            elif key == "illum":
                cur.illum = int(parts[1])
            elif key == "map_kd":
                cur.map_kd = parts[-1]
            elif key in ("map_bump", "bump"):
                cur.map_bump = parts[-1]
            elif key == "map_d":
                cur.map_d = parts[-1]
    return mats


def load_obj(path: str, generate_normals: bool = True) -> List[ObjSubMesh]:
    """Parse an OBJ file into per-material submeshes."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    mats: Dict[str, ObjMaterial] = {}
    default_mat = ObjMaterial(name="default")

    # corners keyed per active material
    by_mat: Dict[str, List[Tuple[int, int, int]]] = {}
    active = "default"
    base_dir = os.path.dirname(path)

    def _idx(tok: str, n_items: int, slot: int) -> Tuple[int, int, int]:
        comps = tok.split("/")
        vi = int(comps[0]) if comps[0] else 0
        ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
        ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
        return vi, ti, ni

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vn":
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vt":
                texcoords.append((float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0))
            elif key == "f":
                corners = [_idx(tok, len(positions), i) for i, tok in enumerate(parts[1:])]
                lst = by_mat.setdefault(active, [])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    lst += [corners[0], corners[k], corners[k + 1]]
            elif key == "usemtl":
                active = " ".join(parts[1:])
            elif key == "mtllib":
                mats.update(load_mtl(os.path.join(base_dir, " ".join(parts[1:]))))

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm = np.asarray(normals, np.float32).reshape(-1, 3) if normals else None
    uvs = np.asarray(texcoords, np.float32).reshape(-1, 2) if texcoords else None

    out: List[ObjSubMesh] = []
    for mat_name, corners in by_mat.items():
        arr = np.asarray(corners, np.int64).reshape(-1, 3, 3)  # (F, corner, v/t/n)
        vi = arr[..., 0]
        vi = np.where(vi < 0, vi + len(positions), vi - 1)
        ti = arr[..., 1]
        ti = np.where(ti < 0, ti + len(texcoords), ti - 1)
        ni = arr[..., 2]
        ni = np.where(ni < 0, ni + len(normals), ni - 1)

        # split corners into unique (v,t,n) vertices
        keys = np.stack([vi, np.where(arr[..., 1] != 0, ti, -1),
                         np.where(arr[..., 2] != 0, ni, -1)], axis=-1).reshape(-1, 3)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        v = pos[uniq[:, 0]]
        n = nrm[np.maximum(uniq[:, 2], 0)] if nrm is not None else None
        if n is not None:
            n = np.where((uniq[:, 2] >= 0)[:, None], n, 0.0).astype(np.float32)
            if (uniq[:, 2] < 0).any():
                n = None  # mixed; regenerate below
        uv = uvs[np.maximum(uniq[:, 1], 0)] if uvs is not None else None
        if uv is not None:
            uv = np.where((uniq[:, 1] >= 0)[:, None], uv, 0.0).astype(np.float32)
        faces = inverse.reshape(-1, 3).astype(np.int32)
        mesh = shapes.TriMesh(v.astype(np.float32), faces, n, uv)
        if mesh.n is None and generate_normals:
            mesh = shapes.compute_vertex_normals(mesh)
        out.append(ObjSubMesh(mesh=mesh, material=mats.get(mat_name, default_mat)))
    return out
