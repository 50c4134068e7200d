"""PLY mesh loader (ascii + binary little/big endian).

Verbatim port of ``cudatracerlib_tpu/scene/loader/ply.py`` (numpy
structured dtypes; a binary face list is read face by face).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import shapes

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> shapes.TriMesh:
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header")
    assert head_end >= 0, "not a PLY file"
    header = data[:head_end].decode("ascii", errors="replace").splitlines()
    body = data[head_end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "ascii"
    elements: List[Tuple[str, int, list]] = []  # (name, count, [(prop, type, is_list, idx_type)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], True, parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], False, None))

    endian = "<" if "little" in fmt else ">"
    verts = norms = uvs = None
    faces = []

    if fmt == "ascii":
        toks = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.asarray(toks[pos:pos + count * width], dtype=np.float64)
                arr = arr.reshape(count, width)
                pos += count * width
                cols = {p[0]: i for i, p in enumerate(props)}
                verts = arr[:, [cols["x"], cols["y"], cols["z"]]]
                if "nx" in cols:
                    norms = arr[:, [cols["nx"], cols["ny"], cols["nz"]]]
                if "u" in cols:
                    uvs = arr[:, [cols["u"], cols["v"]]]
                elif "s" in cols:
                    uvs = arr[:, [cols["s"], cols["t"]]]
            elif name == "face":
                for _ in range(count):
                    n = int(toks[pos]); pos += 1
                    idx = [int(t) for t in toks[pos:pos + n]]; pos += n
                    for k in range(1, n - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            else:
                # skip unknown ascii elements conservatively
                width = len(props)
                pos += count * width
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(not p[2] for p in props):
                dt = np.dtype([(p[0], endian + _PLY_TYPES[p[1]]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float64)
                if "nx" in dt.names:
                    norms = np.stack([arr["nx"], arr["ny"], arr["nz"]], -1).astype(np.float64)
                for (a, b) in (("u", "v"), ("s", "t")):
                    if a in dt.names:
                        uvs = np.stack([arr[a], arr[b]], -1).astype(np.float64)
                        break
            elif name == "face":
                # variable-length lists: parse sequentially (fast enough with
                # memoryview; San-Miguel-class meshes ship as obj/serialized)
                lp = props[0]
                cnt_dt = np.dtype(endian + _PLY_TYPES[lp[3]])
                idx_dt = np.dtype(endian + _PLY_TYPES[lp[1]])
                mv = body
                for _ in range(count):
                    n = int(np.frombuffer(mv, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(mv, idx_dt, n, off)
                    off += idx_dt.itemsize * n
                    for k in range(1, n - 1):
                        faces.append([int(idx[0]), int(idx[k]), int(idx[k + 1])])

    assert verts is not None, "PLY has no vertex element"
    mesh = shapes.TriMesh(
        v=verts.astype(np.float32),
        f=np.asarray(faces, np.int32).reshape(-1, 3),
        n=norms.astype(np.float32) if norms is not None else None,
        uv=uvs.astype(np.float32) if uvs is not None else None)
    if mesh.n is None:
        mesh = shapes.compute_vertex_normals(mesh)
    return mesh
