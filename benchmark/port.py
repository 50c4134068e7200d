"""The benchmark's calls into the system under test, the PyTorch and CUDA
port (``cudatracerlib_tpu_torch``): its kernel loader, its scene API and
its tracers. Nothing else of the benchmark imports the port."""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .scenes import common

KERNEL_SOURCES = ("traversal8.cu", "traversal_tt.cu")


def load_kernels():
    """Build (first run in a checkout) or load the traversal kernels."""
    from cudatracerlib_tpu_torch.ops import cuda_build
    cuda_build.build(*KERNEL_SOURCES)


def _texture(host, schema, tex):
    if tex is None:
        return None
    if tex[0] == "image":
        return host.TextureSpec(tex_type=schema.TEX_IMAGE, image=tex[1],
                                uv_scale=tuple(tex[2]))
    if tex[0] == "checker":
        return host.TextureSpec(tex_type=schema.TEX_CHECKERBOARD, value=tuple(tex[1]),
                                value1=tuple(tex[2]), uv_scale=tuple(tex[3]))
    raise ValueError(f"unknown texture {tex[0]!r}")


def build_scene(desc: common.Scene, device):
    """Hand the frozen description to the port's DynamicScene and build it
    on `device`. Returns the port's SceneData."""
    from cudatracerlib_tpu_torch.scene import host, schema, sensors, shapes
    sc = host.DynamicScene()
    for m in desc.materials:
        kw = dict(reflectance=tuple(m.reflectance), two_sided=True,
                  tex_reflectance=_texture(host, schema, m.texture))
        if m.kind == "roughconductor":
            kw.update(bsdf_type=schema.BSDF_ROUGHCONDUCTOR, alpha=m.alpha,
                      distribution=1, eta_c=tuple(m.eta_c), k_c=tuple(m.k_c))
        elif m.kind != "diffuse":
            raise ValueError(f"unknown material {m.kind!r}")
        sc.add_material(host.MaterialSpec(**kw))
    for node in desc.nodes:
        mesh = shapes.TriMesh(node.mesh.v, node.mesh.f, node.mesh.n, node.mesh.uv)
        sc.create_node(mesh, node.material, node.to_world, emission=node.emission)
    if desc.env_image is not None:
        sc.set_environment(desc.env_image, scale=(1.0, 1.0, 1.0))
    for d, rad in desc.distant:
        sc.add_distant_light(direction=d, radiance=rad)
    sc.set_sensor(sensors.make_sensor(schema.SENSOR_PERSPECTIVE, desc.camera_to_world,
                                      fov_x_deg=desc.fov_x_deg, film_w=desc.width,
                                      film_h=desc.height))
    return sc.build(device)


def scene_diagonal(desc: common.Scene) -> float:
    arr = [n.mesh.transformed(n.to_world).v for n in desc.nodes]
    v = np.concatenate(arr)
    return float(np.linalg.norm(v.max(0) - v.min(0)))


def make_tracer(scene, desc: common.Scene, traffic: dict, seed: int):
    """The traffic mix's tracer over the built scene. `seed` goes to the
    tracer's seed argument, or, for a tracer without one, to its starting
    pass index (seed << 16, the offset the seeded tracers apply)."""
    mod_name, cls_name = traffic["tracer"].split(":")
    cls = getattr(importlib.import_module(f"cudatracerlib_tpu_torch.{mod_name}"), cls_name)
    kw = dict(traffic.get("kwargs", {}))
    if "radius_of_diagonal" in traffic:
        kw["radius"] = traffic["radius_of_diagonal"] * scene_diagonal(desc)
    if traffic["seed"] == "kwarg":
        tracer = cls(scene, desc.width, desc.height, seed=seed, **kw)
    elif traffic["seed"] == "pass_offset":
        tracer = cls(scene, desc.width, desc.height, **kw)
        tracer.pass_idx = seed << 16
    else:
        raise ValueError(f"unknown seed rule {traffic['seed']!r}")
    return tracer


def counters(tracer) -> dict:
    """The tracer's int64 device counters that exist (rays traced, traversal
    steps), read back."""
    out = {}
    for key, attr in (("rays", "_rays_dev"), ("steps", "_iters_dev")):
        t = getattr(tracer, attr, None)
        if isinstance(t, torch.Tensor):
            out[key] = int(t)
    return out


def traversal_table_bytes(scene) -> int:
    g = scene.geom
    return int(sum(t.numel() * t.element_size()
                   for t in (g.wide, g.tt_top, g.tt_slabs, g.tt_vid) if t is not None))


def build_seconds(scene) -> float:
    return float(sum(scene.host.get("build_seconds", {}).values()))
