"""Mitsuba `.serialized` mesh loader.

Verbatim port of ``cudatracerlib_tpu/scene/loader/serialized.py``.
Format (Mitsuba 0.5):
  u16 format_id = 0x041C, u16 version (3 or 4), then a zlib stream per mesh.
  The file ends with a dictionary: u64 offsets per mesh + u32 mesh count.
  Inflated stream: u32 flags, [name string (v>=4, null-terminated)],
  u64 n_verts, u64 n_tris, then positions / normals / texcoords / colors and
  u32 (or u64 for huge meshes) triangle indices.
Flags: 0x0001 normals, 0x0002 texcoords, 0x0008 colors, 0x0010 face normals,
0x1000 single precision, 0x2000 double precision.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import shapes

MTS_FILEFORMAT_HEADER = 0x041C
F_HAS_NORMALS = 0x0001
F_HAS_TEXCOORDS = 0x0002
F_HAS_COLORS = 0x0008
F_FACE_NORMALS = 0x0010
F_SINGLE = 0x1000
F_DOUBLE = 0x2000


def load_serialized(path: str, shape_index: int = 0) -> shapes.TriMesh:
    with open(path, "rb") as f:
        data = f.read()
    fmt_id, version = struct.unpack_from("<HH", data, 0)
    assert fmt_id == MTS_FILEFORMAT_HEADER, f"bad serialized header {fmt_id:#x}"

    n_meshes = struct.unpack_from("<I", data, len(data) - 4)[0]
    if version >= 4:
        table = struct.unpack_from(f"<{n_meshes}Q", data, len(data) - 4 - 8 * n_meshes)
    else:
        table = struct.unpack_from(f"<{n_meshes}I", data, len(data) - 4 - 4 * n_meshes)
    assert 0 <= shape_index < n_meshes, f"shape index {shape_index} of {n_meshes}"
    start = table[shape_index] + 4  # skip per-mesh header (u16 id + u16 version)
    blob = zlib.decompress(data[start:])

    off = 0
    flags = struct.unpack_from("<I", blob, off)[0]; off += 4
    if version >= 4:
        end = blob.index(b"\x00", off)
        off = end + 1
    n_verts, n_tris = struct.unpack_from("<QQ", blob, off); off += 16

    dt = np.dtype("<f8") if flags & F_DOUBLE else np.dtype("<f4")

    def read(n):
        nonlocal off
        arr = np.frombuffer(blob, dt, n, off)
        off += dt.itemsize * n
        return arr

    v = read(n_verts * 3).reshape(-1, 3).astype(np.float32)
    n = None
    if flags & F_HAS_NORMALS:
        n = read(n_verts * 3).reshape(-1, 3).astype(np.float32)
    uv = None
    if flags & F_HAS_TEXCOORDS:
        uv = read(n_verts * 2).reshape(-1, 2).astype(np.float32)
    if flags & F_HAS_COLORS:
        read(n_verts * 3)  # vertex colors unused for now
    idx_dt = np.dtype("<u4") if n_verts <= 0xFFFFFFFF else np.dtype("<u8")
    f_arr = np.frombuffer(blob, idx_dt, n_tris * 3, off).reshape(-1, 3).astype(np.int32)

    mesh = shapes.TriMesh(v=v, f=f_arr, n=n, uv=uv)
    if mesh.n is None or flags & F_FACE_NORMALS:
        mesh = shapes.TriMesh(v=v, f=f_arr, n=None, uv=uv)
        mesh = shapes.compute_vertex_normals(mesh)
    return mesh


def count_shapes(path: str) -> int:
    with open(path, "rb") as f:
        f.seek(-4, 2)
        return struct.unpack("<I", f.read(4))[0]
