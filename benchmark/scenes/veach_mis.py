"""Veach's multiple importance sampling scene (Veach 1997, thesis Fig. 9.2):
four rough-conductor plates of rising roughness under four sphere lights of
equal power and rising size, a fill light and a diffuse floor. The lights
and the camera are the source's; the plates are flat bars aimed so that
each mirrors the camera onto the light row (the configuration's
``assumed``)."""
from __future__ import annotations

import numpy as np

from . import common as c


def plate_tilt_deg(center, camera, aim) -> float:
    """The rotation about x that turns a bar's +y onto the bisector of the
    directions to the camera and to the aim point."""
    p = np.asarray(center, np.float64)
    to_cam = np.asarray(camera, np.float64) - p
    to_aim = np.asarray(aim, np.float64) - p
    n = to_cam / np.linalg.norm(to_cam) + to_aim / np.linalg.norm(to_aim)
    return float(np.degrees(np.arctan2(n[2], n[1])))


def make(cfg: dict) -> c.Scene:
    sc = c.Scene(cfg["width"], cfg["height"])
    fl = cfg["floor"]
    floor_m = sc.add_material(c.Material(reflectance=(fl["reflectance"],) * 3))
    black = sc.add_material(c.Material(reflectance=(0.0, 0.0, 0.0)))
    sc.add_node(c.rectangle(), floor_m, c.compose(c.translate([0, fl["y"], 0]),
                                                  c.rotate_deg([1, 0, 0], -90),
                                                  c.scale(fl["half_size"])))
    pl = cfg["plates"]
    for a, center in zip(cfg["plate_alphas"], pl["centers"]):
        m = sc.add_material(c.Material(kind="roughconductor",
                                       reflectance=(cfg["plate_specular_reflectance"],) * 3,
                                       alpha=a, eta_c=tuple(cfg["eta_c"]),
                                       k_c=tuple(cfg["k_c"])))
        tilt = plate_tilt_deg(center, cfg["camera_origin"], pl["aim"])
        sc.add_node(c.cube(), m, c.compose(c.translate(center), c.rotate_deg([1, 0, 0], tilt),
                                           c.scale(pl["half_size"])))
    n_theta, n_phi = cfg["sphere_tessellation"]
    spheres = list(zip(cfg["light_centers"], cfg["light_radii"], cfg["light_radiance"]))
    spheres.append((cfg["fill_light_center"], cfg["fill_light_radius"],
                    cfg["fill_light_radiance"]))
    for center, r, le in spheres:
        sc.add_node(c.sphere(radius=r, n_theta=n_theta, n_phi=n_phi), black,
                    c.translate(center), emission=(le, le, le))
    sc.camera_to_world = c.look_at(cfg["camera_origin"], cfg["camera_target"],
                                   cfg["camera_up"])
    sc.fov_x_deg = cfg["fov_deg"]
    return sc
