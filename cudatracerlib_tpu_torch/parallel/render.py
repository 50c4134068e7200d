"""Multi-device rendering: image-plane sharding over torch.distributed ranks.

Port of ``cudatracerlib_tpu/parallel/render.py``. The JAX package drives a
device mesh from one process with ``shard_map``; the port follows PyTorch's
idiom instead, one process per device (a rank) under ``torch.distributed``.
Every rank holds the whole scene on its device, traces its shard of the
lanes and keeps the JAX package's data layout and data order:

- ``make_mesh`` returns a ``Mesh``: the process group, this rank, the world
  size, the rank's device and the axis name. On the card the backend is
  NCCL and rank k owns ``cuda:k``; on the CPU, when the caller asks for it,
  gloo. Nothing falls back from one to the other.
- Pixel, path and photon ids (``P(axis)``): rank k takes the k-th
  contiguous block of ``arange(n)``.
- The row-sharded film (``_film_specs``, ``_local_rows``): each rank's Film
  holds its h/S rows, sliced from a full-height local film.
- ``psum`` is ``all_reduce(SUM)``, ``pmax`` ``all_reduce(MAX)``, and an
  ``all_gather`` concatenates the ranks' tensors in rank order.
- ``new_splat_parts``: each rank holds its own (1, h, w, 3) slice of the
  JAX package's (n_dev, h, w, 3) parts; ``fold_splat_parts`` all-reduces
  it once per develop.
- ``launch`` starts N ranks as spawned processes that meet through a
  FileStore in a temporary directory (the CLI's ``--devices N``).

The sharded tracers' ``develop()`` gathers the film's rows and folds the
splat parts, so that every rank then holds the whole image, as a sharded
``jax.Array`` read back to the host does.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models import bdpt as bdptmod
from ..models import film as filmmod
from ..models import lighttracer as ltmod
from ..models import path as pathmod
from ..models import ppm as ppmmod
from ..models import tracer
from ..models import vcm as vcmmod
from ..models import vol_estimators as ve
from ..scene import schema

Tensor = torch.Tensor


class Mesh(NamedTuple):
    """A 1-D mesh of ranks: what ``jax.sharding.Mesh`` is to the JAX passes."""
    group: object          # the torch.distributed process group
    rank: int
    size: int
    device: torch.device   # this rank's device
    axis: str = "tiles"

    def all_reduce(self, x: Tensor, op: str = "sum") -> Tensor:
        """psum ("sum") or pmax ("max") over the mesh, into a new tensor."""
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.group)
        return y

    def all_gather(self, x: Tensor) -> Tensor:
        """Every rank's x concatenated on dim 0 in rank order (shard-major,
        as ``jax.lax.all_gather`` followed by a reshape)."""
        if x.dtype == torch.bool:
            return self.all_gather(x.to(torch.uint8)).bool()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, 0)


def make_mesh(n_devices: int | None = None, axis: str = "tiles",
              device="cuda") -> Mesh:
    """The mesh of the running world: the card (NCCL, rank k on cuda:k)
    unless the caller asks for the CPU (gloo).

    Without an initialised process group this makes a world of one (an
    in-process HashStore: no network); a world of several ranks is started
    by ``launch``, and n_devices must then equal its size. Raises if two
    ranks would share one card or if the backend cannot start (a first
    all-reduce runs here)."""
    kind = schema.resolve_device(device).type
    backend = "nccl" if kind == "cuda" else "gloo"
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}): a world of several ranks "
                             "is started by launch(); alone, make_mesh makes "
                             "a world of one")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) in a world of {size} ranks")
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {kind} mesh needs the {backend} backend, the "
                           f"world runs {dist.get_backend()}")
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if rank >= cards:
            raise RuntimeError(f"rank {rank} of {size} would share a card: "
                               f"this machine has {cards}")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    mesh = Mesh(dist.group.WORLD, rank, size, dev, axis)
    mesh.all_reduce(torch.zeros(1, device=dev))
    return mesh


def _shard_ids(mesh: Mesh, n: int) -> Tensor:
    """This rank's block of arange(n) (the JAX package's P(axis) ids)."""
    if n % mesh.size:
        raise ValueError(f"{n} ids do not divide a mesh of {mesh.size}")
    b = n // mesh.size
    return torch.arange(mesh.rank * b, (mesh.rank + 1) * b, dtype=torch.int32,
                        device=mesh.device)


def _local_rows(x: Tensor, mesh: Mesh) -> Tensor:
    """This rank's row block of a full-height accumulation buffer.
    Pixel-sharded passes only ever write their own rows, so the slice loses
    nothing."""
    hl = x.shape[0] // mesh.size
    return x[mesh.rank * hl:(mesh.rank + 1) * hl]


def _film_specs(film: filmmod.Film, mesh: Mesh) -> filmmod.Film:
    """The row-sharded film layout: this rank's h/S rows of every
    accumulation buffer (a copy); n_passes stays replicated."""
    return film._replace(**{k: _local_rows(getattr(film, k), mesh).clone()
                            for k in ("rgb", "weight", "splat")})


def gather_film(film: filmmod.Film, mesh: Mesh) -> filmmod.Film:
    """A row-sharded film's rows gathered from every rank: the full film."""
    return film._replace(**{k: mesh.all_gather(getattr(film, k))
                            for k in ("rgb", "weight", "splat")})


def new_splat_parts(mesh: Mesh, w: int, h: int, axis: str = "tiles") -> Tensor:
    """This rank's full-film splat accumulator, (1, h, w, 3): its slice of
    the JAX package's (n_dev, h, w, 3) parts. Splats (light tracing, BDPT
    t=1) can land on any pixel, so they cannot ride the row-sharded film;
    each rank accumulates into its own slice across passes with zero
    collectives, and ``fold_splat_parts`` reduces once per develop."""
    return torch.zeros((1, h, w, 3), dtype=torch.float32, device=mesh.device)


def fold_splat_parts(film: filmmod.Film, parts: Tensor, mesh: Mesh) -> filmmod.Film:
    """The once-per-develop reduce of the splat parts over the mesh, added
    to a full-height film. The Mesh, an argument the JAX function does not
    take, names the process group."""
    return film._replace(splat=film.splat + mesh.all_reduce(parts.sum(0)))


def sharded_pt_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
                    mesh: Mesh, w: int, h: int, max_depth: int = 6,
                    spp: int = 1, active_types: Sequence[int] = None,
                    axis: str = "tiles",
                    reduce_film: bool | None = None) -> filmmod.Film:
    """One progressive PT pass with pixels sharded over the mesh.

    Default layout (reduce_film None or False): `film` is this rank's
    row-sharded film and the rank adds only its own pixel rows, with no
    collective. reduce_film=True keeps the full film on every rank and
    all-reduces the pass (the default when h does not divide the mesh).
    `axis` is the JAX signature's; the Mesh carries its own."""
    if active_types is None:
        active_types = pathmod.scene_active_types(scene)
    pixel_idx = _shard_ids(mesh, w * h)
    if reduce_film is None:
        reduce_film = h % mesh.size != 0
    local = filmmod.new_film(w, h, mesh.device)
    for s_i in range(spp):
        rays, px, py, state, wt = tracer.gen_camera_rays(
            scene, pixel_idx, pass_idx * spp + s_i, pass_idx, w, h)
        L, state = pathmod.pt_radiance(scene, rays, state, max_depth,
                                       active_types=tuple(active_types))
        local = filmmod.add_samples(local, px, py, L * wt)
    if reduce_film:
        return film._replace(rgb=film.rgb + mesh.all_reduce(local.rgb),
                             weight=film.weight + mesh.all_reduce(local.weight))
    return film._replace(rgb=film.rgb + _local_rows(local.rgb, mesh),
                         weight=film.weight + _local_rows(local.weight, mesh))


def sharded_lt_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
                    mesh: Mesh, w: int, h: int, max_depth: int = 8,
                    n_paths: int = None, active_types: Sequence[int] = None,
                    axis: str = "tiles", splat_parts: Tensor = None):
    """One light-tracing pass with light paths sharded over the mesh: each
    rank walks its own path-id range and splats into a local film.

    With splat_parts (``new_splat_parts``) each rank adds into its own
    parts with no collective and returns them; the caller folds once per
    develop. Without, the pass's splats are all-reduced into the full film,
    which is returned."""
    if active_types is None:
        active_types = pathmod.scene_active_types(scene)
    n_paths = n_paths or (w * h)
    path_ids = _shard_ids(mesh, n_paths)
    local = ltmod.lt_pass(scene, filmmod.new_film(w, h, mesh.device), pass_idx,
                          n_paths=n_paths, max_depth=max_depth,
                          active_types=tuple(active_types), path_ids=path_ids,
                          total_paths=n_paths)
    if splat_parts is not None:
        return splat_parts + local.splat[None]
    return film._replace(splat=film.splat + mesh.all_reduce(local.splat),
                         weight=torch.ones_like(film.weight))


def _check_rows(h: int, mesh: Mesh):
    if h % mesh.size:
        raise ValueError(f"a row-sharded film needs h % n_dev == 0 ({h}, {mesh.size})")


def sharded_bdpt_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
                      mesh: Mesh, w: int, h: int, max_depth: int = 6,
                      active_types: Sequence[int] = None,
                      axis: str = "tiles", splat_parts: Tensor = None):
    """One BDPT pass with pixels (and their paired light sub-paths) sharded
    over the mesh; total_paths keeps the t=1 splat normalization global.

    With splat_parts, rgb and weight go to the row-sharded `film` (the s>=2
    strategies only write a pixel's own row) and the t=1 splats, which land
    anywhere, to this rank's parts: no collective; returns (film, parts).
    Without, rgb, weight and splat of the full film are all-reduced."""
    if active_types is None:
        active_types = pathmod.scene_active_types(scene)
    pixel_idx = _shard_ids(mesh, w * h)
    if splat_parts is not None:
        _check_rows(h, mesh)
    local, _ = bdptmod.bdpt_pass(
        scene, filmmod.new_film(w, h, mesh.device), pass_idx, w=w, h=h,
        max_depth=max_depth, active_types=tuple(active_types),
        pixel_idx=pixel_idx, total_paths=w * h)
    return _add_pass(film, local, mesh, splat_parts)


def _add_pass(film, local, mesh, splat_parts):
    """A BDPT or VCM pass's local film added into the caller's layout."""
    if splat_parts is not None:
        film = film._replace(rgb=film.rgb + _local_rows(local.rgb, mesh),
                             weight=film.weight + _local_rows(local.weight, mesh))
        return film, splat_parts + local.splat[None]
    return film._replace(rgb=film.rgb + mesh.all_reduce(local.rgb),
                         weight=film.weight + mesh.all_reduce(local.weight),
                         splat=film.splat + mesh.all_reduce(local.splat))


def sharded_vcm_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
                     mesh: Mesh, w: int, h: int, radius,
                     max_depth: int = 6, active_types: Sequence[int] = None,
                     axis: str = "tiles", splat_parts: Tensor = None):
    """One vertex-connection-and-merging pass over the mesh: pixels and
    their paired light sub-paths are sharded, each rank's photon rows are
    all-gathered (shard-major, as the JAX pass's) so that every rank merges
    against the full photon map, and eta_vcm and the t=1 splat
    normalization stay global through total_paths. The layouts are
    sharded_bdpt_pass's; the photon all-gather is the only collective of a
    pass with splat_parts."""
    if active_types is None:
        active_types = pathmod.scene_active_types(scene)
    pixel_idx = _shard_ids(mesh, w * h)
    if splat_parts is not None:
        _check_rows(h, mesh)
    local, _ = vcmmod.vcm_pass(
        scene, filmmod.new_film(w, h, mesh.device), pass_idx, w=w, h=h,
        max_depth=max_depth, active_types=tuple(active_types), radius=radius,
        pixel_idx=pixel_idx, total_paths=w * h, photon_gather_axis=mesh)
    return _add_pass(film, local, mesh, splat_parts)


def sharded_ppm_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
                     mesh: Mesh, w: int, h: int, radius, n_photons: int = None,
                     max_depth: int = 6, active_types: Sequence[int] = None,
                     axis: str = "tiles", with_volume: bool = False,
                     vol_est: str = "beamgrid", vol_max_per_cell: int = 16,
                     ppm_state=None, alpha: float = 2.0 / 3.0,
                     final_gather: bool = False):
    """One progressive-photon-mapping pass over the mesh: each rank walks
    its own photon shard, the photon rows (surface and medium photons, and
    the photon beams) are all-gathered in the single-device row order so
    that every rank builds the full map's grids, and the eye pass shards
    the pixels.

    `film` is row-sharded when h divides the mesh (no film collective),
    else full and all-reduced. ppm_state (PixelStats) holds this rank's
    pixel block of the adaptive-radius statistics; the grid cell must cover
    the largest radius on any rank, one all-reduce(MAX). Returns film, or
    (film, new_ppm_state) when adaptive."""
    if active_types is None:
        active_types = pathmod.scene_active_types(scene)
    n_photons = n_photons or (w * h)
    photon_ids = _shard_ids(mesh, n_photons)
    pixel_idx = _shard_ids(mesh, w * h)
    adaptive = ppm_state is not None
    collect_beams = with_volume and vol_est == ve.VOL_BEAMBEAM
    traced = ppmmod.trace_photons(
        scene, n_photons=photon_ids.shape[0], pass_idx=pass_idx,
        state_seed=0x9907, max_depth=max_depth, active_types=tuple(active_types),
        store_medium=with_volume, collect_beams=collect_beams,
        photon_ids=photon_ids, total_photons=n_photons)
    Bl = photon_ids.shape[0]

    def gather_exact(x):
        """all_gather, then the single-device row order. trace_photons
        emits rows depth-major: the global row is (depth, photon) with
        photon = rank * Bl + lane, while a plain gather is rank-major, which
        would change which photons a full grid cell keeps."""
        g = mesh.all_gather(x)
        g = g.reshape((mesh.size, x.shape[0] // Bl, Bl) + x.shape[1:])
        return g.transpose(0, 1).reshape((-1,) + x.shape[1:])

    rows, valid = gather_exact(traced[0]), gather_exact(traced[1])
    r = torch.as_tensor(radius, dtype=torch.float32, device=mesh.device)
    if adaptive:
        cell = 2.0 * torch.sqrt(mesh.all_reduce(ppm_state.r2.amax(), op="max"))
    else:
        cell = 2.0 * r
    grid = ppmmod._build_surface_grid(rows, valid, scene.world_lo,
                                      scene.world_hi, cell)
    if not with_volume:
        vol_grid = None
    elif vol_est == ve.VOL_BEAMGRID:
        vol_grid = ppmmod._build_vol_grid_ball(rows, valid, r, scene.world_lo,
                                               scene.world_hi)
    elif vol_est == ve.VOL_BEAMBEAM:
        vol_grid = ve.build_beam_cells(gather_exact(traced[2]),
                                       gather_exact(traced[3]), r,
                                       scene.world_lo, scene.world_hi)
    else:
        vol_grid = ppmmod._build_vol_grid_point(rows, valid, scene.world_lo,
                                                scene.world_hi, cell)
    del rows, valid, traced
    out = ppmmod.eye_pass(
        scene, filmmod.new_film(w, h, mesh.device), grid, vol_grid, pass_idx,
        w=w, h=h, radius=r, n_emitted=float(n_photons), max_depth=max_depth,
        active_types=tuple(active_types), with_volume=with_volume,
        vol_est=vol_est, vol_max_per_cell=vol_max_per_cell,
        ppm_state=ppm_state, alpha=alpha, final_gather=final_gather,
        pixel_idx=pixel_idx)
    local, new_state = out if adaptive else (out, None)
    if h % mesh.size == 0:
        out_film = film._replace(rgb=film.rgb + _local_rows(local.rgb, mesh),
                                 weight=film.weight + _local_rows(local.weight, mesh))
    else:
        out_film = film._replace(rgb=film.rgb + mesh.all_reduce(local.rgb),
                                 weight=film.weight + mesh.all_reduce(local.weight))
    return (out_film, new_state) if adaptive else out_film


def _to(x, device):
    if isinstance(x, Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    return x


def replicate_scene(scene: schema.SceneData, mesh: Mesh) -> schema.SceneData:
    """Every scene tensor on this rank's device: each rank holds the whole
    scene."""
    return _to(scene, mesh.device)


class _Sharded:
    """What the sharded tracers share: the mesh, the film layout (rows when
    `rows`, else the full film), the splat parts where there are any, and
    a develop() through which every rank gets the whole image."""

    _splat_parts = None

    def _shard(self, mesh: Mesh, rows: bool):
        self.mesh = mesh
        self._rows = rows
        if rows:
            self.film = _film_specs(self.film, mesh)

    def gathered_film(self, parts: bool = True) -> filmmod.Film:
        """The whole film on every rank: rows gathered, and with `parts` the
        splat parts folded (collectives: every rank must call it)."""
        film = gather_film(self.film, self.mesh) if self._rows else self.film
        if parts and self._splat_parts is not None:
            film = fold_splat_parts(film, self._splat_parts, self.mesh)
        return film

    def develop(self) -> Tensor:
        """The whole image, the splat parts folded in."""
        return filmmod.develop(self.gathered_film())

    def render(self, n_passes: int = 1) -> Tensor:
        """As the JAX package's: `n_passes` passes, then the gathered film
        developed without the splat parts. The JAX tracers inherit
        TracerBase.render, which develops self.film while their develop()
        folds the parts, so a sharded BDPT or VCM image lacks its splats
        and a sharded light tracer's is black (ROADMAP queue 3, item 7);
        develop() gives the whole image."""
        for _ in range(n_passes):
            self.do_pass()
        return filmmod.develop(self.gathered_film(parts=False))


def _mesh_for(scene, mesh):
    return make_mesh(device=scene.device) if mesh is None else mesh


class ShardedPathTracer(_Sharded, pathmod.PathTracer):
    """PathTracer whose passes run over a mesh of ranks: pixels sharded,
    the film row-sharded when the height divides the mesh (else all-reduced
    each pass). Like the JAX package's, the pass takes max_depth,
    spp_per_pass and the active types from the tracer, and pt_radiance's
    defaults for the rest."""

    def __init__(self, scene, width, height, mesh: Mesh = None, **kw):
        mesh = _mesh_for(scene, mesh)
        super().__init__(replicate_scene(scene, mesh), width, height, **kw)
        self._shard(mesh, height % mesh.size == 0)

    def render_pass(self, scene, film, pass_idx):
        return sharded_pt_pass(scene, film, pass_idx, self.mesh, self.width,
                               self.height, max_depth=self.max_depth,
                               spp=self.spp_per_pass,
                               active_types=self.active_types,
                               reduce_film=not self._rows)


class ShardedBDPT(_Sharded, bdptmod.BDPT):
    """BDPT over a mesh: the row-sharded film and per-rank splat parts,
    folded once per develop; a full film all-reduced each pass when the
    height does not divide the mesh."""

    def __init__(self, scene, width, height, mesh: Mesh = None, **kw):
        mesh = _mesh_for(scene, mesh)
        super().__init__(replicate_scene(scene, mesh), width, height, **kw)
        rows = height % mesh.size == 0
        self._shard(mesh, rows)
        if rows:
            self._splat_parts = new_splat_parts(mesh, width, height)

    def render_pass(self, scene, film, pass_idx):
        out = sharded_bdpt_pass(scene, film, pass_idx, self.mesh, self.width,
                                self.height, max_depth=self.max_depth,
                                active_types=self.active_types,
                                splat_parts=self._splat_parts)
        if self._splat_parts is not None:
            film, self._splat_parts = out
            return film
        return out


class ShardedLightTracer(_Sharded, ltmod.LightTracer):
    """LightTracer with light paths sharded over a mesh: per-rank splat
    parts accumulated across passes, reduced once per develop."""

    def __init__(self, scene, width, height, mesh: Mesh = None, **kw):
        mesh = _mesh_for(scene, mesh)
        super().__init__(replicate_scene(scene, mesh), width, height, **kw)
        self._shard(mesh, False)
        self._splat_parts = new_splat_parts(mesh, width, height)

    def render_pass(self, scene, film, pass_idx):
        self._splat_parts = sharded_lt_pass(
            scene, film, pass_idx, self.mesh, self.width, self.height,
            max_depth=self.max_depth, n_paths=self.n_paths,
            active_types=self.active_types, splat_parts=self._splat_parts)
        return film._replace(weight=torch.ones_like(film.weight))


class ShardedPPMTracer(_Sharded, ppmmod.PPMTracer):
    """PPM over a mesh: photon shards all-gathered, pixels (and the
    per-pixel adaptive-radius statistics, pixel-local by construction)
    sharded, the volumetric estimators as the single-device PPMTracer's."""

    def __init__(self, scene, width, height, mesh: Mesh = None, **kw):
        mesh = _mesh_for(scene, mesh)
        super().__init__(replicate_scene(scene, mesh), width, height, **kw)
        self._shard(mesh, height % mesh.size == 0)
        if self._ppm_state is not None:
            block = _shard_ids(mesh, width * height).long()
            self._ppm_state = ppmmod.PixelStats(*(x[block] for x in self._ppm_state))

    def render_pass(self, scene, film, pass_idx):
        out = sharded_ppm_pass(scene, film, pass_idx, self.mesh, self.width,
                               self.height, radius=self.radius,
                               n_photons=self.n_photons, max_depth=self.max_depth,
                               active_types=self.active_types,
                               with_volume=self.with_volume, vol_est=self.vol_est,
                               vol_max_per_cell=self.vol_max_per_cell,
                               ppm_state=self._ppm_state, alpha=self.alpha,
                               final_gather=self.final_gather)
        if self._ppm_state is not None:
            film, self._ppm_state = out
        else:
            film = out
        i = self.pass_idx + 1.0
        self.radius = float(self.radius * ((i + self.alpha) / (i + 1.0)) ** 0.5)
        self.photons_emitted += self.n_photons
        return film

    def gathered_state(self):
        """The adaptive-radius statistics of every pixel (collectives)."""
        if self._ppm_state is None:
            return None
        return ppmmod.PixelStats(*(self.mesh.all_gather(x) for x in self._ppm_state))

    def develop(self) -> Tensor:
        return ppmmod.develop_image(self.gathered_film(), self.gathered_state(),
                                    self.pass_idx, self.width, self.height)

    def render(self, n_passes: int = 1) -> Tensor:
        """The JAX PPMTracer's: passes, then develop() (no splat parts)."""
        return ppmmod.PPMTracer.render(self, n_passes)


class ShardedVCM(_Sharded, vcmmod.VCM):
    """VCM with pixels sharded and the photon map all-gathered: the
    row-sharded film and splat parts folded at develop when the height
    divides the mesh."""

    def __init__(self, scene, width, height, mesh: Mesh = None, **kw):
        mesh = _mesh_for(scene, mesh)
        super().__init__(replicate_scene(scene, mesh), width, height, **kw)
        rows = height % mesh.size == 0
        self._shard(mesh, rows)
        if rows:
            self._splat_parts = new_splat_parts(mesh, width, height)

    def render_pass(self, scene, film, pass_idx):
        i = max(self.pass_idx + 1, 1)
        self.radius = self.initial_radius * (i ** ((self.alpha - 1.0) / 2.0))
        out = sharded_vcm_pass(scene, film, pass_idx, self.mesh, self.width,
                               self.height, radius=self.radius,
                               max_depth=self.max_depth,
                               active_types=self.active_types,
                               splat_parts=self._splat_parts)
        if self._splat_parts is not None:
            film, self._splat_parts = out
            return film
        return out


# --------------------------------------------------------------------------
# N ranks: spawned processes that meet through a FileStore
# --------------------------------------------------------------------------

def launch(fn, n_ranks: int, args=(), device="cuda", timeout: float = None,
           tmpdir: str = None):
    """Run ``fn(mesh, *args)`` on n_ranks ranks, one spawned process each,
    and return rank 0's result. `fn` must be importable by name (a
    module-level function); the children import torch and this package.

    device "cuda": NCCL, rank k on cuda:k, and n_ranks greater than the
    number of cards raises; "cpu": gloo. The ranks meet through a FileStore
    in a new temporary directory (under `tmpdir` if given). With a timeout
    in seconds, ranks still running at its end are killed and TimeoutError
    is raised; a rank that raises fails the launch with its traceback."""
    kind = schema.resolve_device(device).type
    if n_ranks < 1:
        raise ValueError(f"{n_ranks} ranks")
    if kind == "cuda" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(f"{n_ranks} ranks need {n_ranks} cards: this "
                           f"machine has {torch.cuda.device_count()}")
    threads = max(1, torch.get_num_threads() // n_ranks)
    with tempfile.TemporaryDirectory(dir=tmpdir) as d:
        ctx = mp.start_processes(_rank_main, args=(n_ranks, d, kind, threads,
                                                   fn, tuple(args)),
                                 nprocs=n_ranks, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        with open(os.path.join(d, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _rank_main(rank, n_ranks, workdir, kind, threads, fn, args):
    """One rank of ``launch``: join the world, make the mesh, run fn; rank 0
    writes fn's result for the parent."""
    torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(workdir, "store"), n_ranks)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=store,
                            rank=rank, world_size=n_ranks)
    try:
        out = fn(make_mesh(n_ranks, device=kind), *args)
        if rank == 0:
            with open(os.path.join(workdir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_PASSES = ("sharded_pt_pass", "sharded_lt_pass", "sharded_bdpt_pass",
           "sharded_vcm_pass", "sharded_ppm_pass")
_TRACERS = ("ShardedPathTracer", "ShardedBDPT", "ShardedLightTracer",
            "ShardedPPMTracer", "ShardedVCM")


def run_jobs(mesh: Mesh, jobs):
    """Render each job on this rank of the mesh; a function for ``launch``.

    A job is (tag, (example scene, w, h), name, kw): `name` is one of this
    module's sharded passes or tracers. A tracer renders kw.pop("passes",
    1) passes; the result holds render()'s image, develop()'s (`img`),
    and for an adaptive PPM tracer the per-pixel r2. A pass runs that many
    passes on a fresh film in the layout its arguments give (rows where
    the pass adds rows; kw "splat_parts": True makes the parts) and the
    result holds the gathered film's rgb, weight and splat (parts folded)
    and its developed image.
    Returns {tag: {name: numpy array}} (every rank; rank 0's is launch's)."""
    from ..utils import example_scenes
    out = {}
    for tag, (scene_name, w, h), name, kw in jobs:
        kw = dict(kw)
        passes = kw.pop("passes", 1)
        scene = getattr(example_scenes, scene_name)(w, h).build(mesh.device)
        if name in _TRACERS:
            tr = globals()[name](scene, w, h, mesh=mesh, **kw)
            res = dict(render=tr.render(passes), img=tr.develop())
            if name == "ShardedPPMTracer" and tr._ppm_state is not None:
                res["r2"] = tr.gathered_state().r2
        elif name in _PASSES:
            res = _pass_job(name, scene, mesh, w, h, passes, kw)
        else:
            raise ValueError(f"no sharded pass or tracer {name!r}")
        out[tag] = {k: v.cpu().numpy() for k, v in res.items()}
    return out


def _pass_job(name, scene, mesh, w, h, passes, kw):
    parts = new_splat_parts(mesh, w, h) if kw.pop("splat_parts", False) else None
    rows = {"sharded_pt_pass": not kw.get("reduce_film") and h % mesh.size == 0,
            "sharded_lt_pass": False,
            "sharded_bdpt_pass": parts is not None,
            "sharded_vcm_pass": parts is not None,
            "sharded_ppm_pass": h % mesh.size == 0}[name]
    film = filmmod.new_film(w, h, mesh.device)
    if rows:
        film = _film_specs(film, mesh)
    fn = globals()[name]
    for i in range(passes):
        res = fn(scene, film, i, mesh, w, h, splat_parts=parts, **kw) \
            if parts is not None else fn(scene, film, i, mesh, w, h, **kw)
        if isinstance(res, filmmod.Film):
            film = res
        elif isinstance(res, Tensor):
            parts = res
        else:
            film, parts = res
        film = film._replace(n_passes=film.n_passes + 1.0)
    if rows:
        film = gather_film(film, mesh)
    if parts is not None:
        film = fold_splat_parts(film, parts, mesh)
    return dict(rgb=film.rgb, weight=film.weight, splat=film.splat,
                img=filmmod.develop(film))
