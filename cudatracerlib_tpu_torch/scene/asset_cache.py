"""Compiled-asset cache.

Port of ``cudatracerlib_tpu/scene/asset_cache.py``: parsed meshes are cached
as `.npz` files keyed by (path, mtime, size), so loading a cached mesh skips
the parsers; a progressive render's film is checkpointed to `.npz` and
loaded back as a torch Film.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from . import shapes


def _cache_path(src: str, cache_dir: Optional[str]) -> str:
    st = os.stat(src)
    key = hashlib.sha1(f"{os.path.abspath(src)}|{st.st_mtime_ns}|{st.st_size}"
                       .encode()).hexdigest()[:16]
    d = cache_dir or os.path.join(os.path.dirname(os.path.abspath(src)), ".meshcache")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{os.path.basename(src)}.{key}.npz")


def load_mesh_cached(path: str, cache_dir: Optional[str] = None,
                     sub_index: int = 0) -> shapes.TriMesh:
    """Load a mesh with compile caching (obj/ply/serialized)."""
    cp = _cache_path(path, cache_dir)
    if os.path.exists(cp):
        z = np.load(cp, allow_pickle=False)
        return shapes.TriMesh(
            v=z["v"], f=z["f"],
            n=z["n"] if "n" in z.files else None,
            uv=z["uv"] if "uv" in z.files else None)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        from .loader import obj as objmod
        subs = objmod.load_obj(path)
        mesh = shapes.merge([s.mesh for s in subs]) if len(subs) > 1 else subs[0].mesh
    elif ext == ".ply":
        from .loader import ply as plymod
        mesh = plymod.load_ply(path)
    elif ext == ".serialized":
        from .loader import serialized as sermod
        mesh = sermod.load_serialized(path, sub_index)
    else:
        raise ValueError(f"unknown mesh format {ext}")
    data = dict(v=mesh.v, f=mesh.f)
    if mesh.n is not None:
        data["n"] = mesh.n
    if mesh.uv is not None:
        data["uv"] = mesh.uv
    np.savez_compressed(cp, **data)
    return mesh


def save_film_checkpoint(path: str, film, pass_idx: int, extra: dict = None):
    """Persist progressive render state: the film's buffers (copied to the
    host), its pass count and the next pass index."""
    np.savez_compressed(path,
                        rgb=film.rgb.cpu().numpy(), weight=film.weight.cpu().numpy(),
                        splat=film.splat.cpu().numpy(),
                        n_passes=np.asarray(film.n_passes),
                        pass_idx=np.asarray(pass_idx),
                        **(extra or {}))


def load_film_checkpoint(path: str, device="cuda"):
    """(Film on `device`, pass index) from save_film_checkpoint's file; the
    film lands on the card unless the caller asks for the CPU."""
    import torch
    from ..models import film as filmmod
    from . import schema
    device = schema.resolve_device(device)
    z = np.load(path)
    film = filmmod.Film(rgb=torch.from_numpy(z["rgb"]).to(device),
                        weight=torch.from_numpy(z["weight"]).to(device),
                        splat=torch.from_numpy(z["splat"]).to(device),
                        n_passes=float(z["n_passes"]))
    return film, int(z["pass_idx"])
