"""Procedural example scenes (port of ``cudatracerlib_tpu/utils/example_scenes.py``)."""
from __future__ import annotations

import numpy as np

from ..scene import host, schema, sensors, shapes
from . import transforms as tf


def cornell_box(width: int = 256, height: int = 256, spheres: bool = True):
    """Classic Cornell box: white room, red/green walls, area light, two objects."""
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.725, 0.71, 0.68)))
    red = sc.add_material(host.MaterialSpec(reflectance=(0.63, 0.065, 0.05)))
    green = sc.add_material(host.MaterialSpec(reflectance=(0.14, 0.45, 0.091)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0.0, 0.0, 0.0)))

    rect = shapes.rectangle()
    sc.create_node(rect, white, tf.compose(tf.translate([0, -1, 0]), tf.rotate_deg([1, 0, 0], -90)), name="floor")
    sc.create_node(rect, white, tf.compose(tf.translate([0, 1, 0]), tf.rotate_deg([1, 0, 0], 90)), name="ceiling")
    sc.create_node(rect, white, tf.compose(tf.translate([0, 0, 1]), tf.rotate_deg([0, 1, 0], 180)), name="back")
    sc.create_node(rect, red, tf.compose(tf.translate([-1, 0, 0]), tf.rotate_deg([0, 1, 0], 90)), name="left")
    sc.create_node(rect, green, tf.compose(tf.translate([1, 0, 0]), tf.rotate_deg([0, 1, 0], -90)), name="right")

    # area light: small rectangle near the ceiling, facing down
    sc.create_node(rect, black,
                   tf.compose(tf.translate([0, 0.995, 0]), tf.rotate_deg([1, 0, 0], 90),
                              tf.scale(0.25)),
                   emission=(17.0, 12.0, 4.0), name="light")

    if spheres:
        sc.create_node(shapes.sphere(radius=0.35, center=(0, 0, 0), n_theta=24, n_phi=48),
                       white, tf.translate([-0.4, -0.65, 0.3]), name="sphere")
        sc.create_node(shapes.cube(), white,
                       tf.compose(tf.translate([0.45, -0.7, -0.2]),
                                  tf.rotate_deg([0, 1, 0], 20), tf.scale([0.25, 0.3, 0.25])),
                       name="box")

    cam = sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE,
        tf.look_at([0, 0, -3.5], [0, 0, 0]),
        fov_x_deg=32.0, film_w=width, film_h=height)
    sc.set_sensor(cam)
    return sc


def veach_mis(width: int = 512, height: int = 512):
    """Veach MIS scene: four glossy bars of increasing roughness lit by four
    sphere lights of increasing size and equal power (BASELINE config 2)."""
    sc = host.DynamicScene()
    floor_m = sc.add_material(host.MaterialSpec(reflectance=(0.4, 0.4, 0.4)))
    back_m = sc.add_material(host.MaterialSpec(reflectance=(0.25, 0.25, 0.25)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0.0, 0.0, 0.0)))

    rect = shapes.rectangle()
    sc.create_node(rect, floor_m,
                   tf.compose(tf.translate([0, -2, 0]), tf.rotate_deg([1, 0, 0], -90),
                              tf.scale(12.0)), name="floor")
    sc.create_node(rect, back_m,
                   tf.compose(tf.translate([0, 2, 6]), tf.rotate_deg([0, 1, 0], 180),
                              tf.scale(12.0)), name="back")

    # four bars: thin slabs tilted toward the camera, roughness ramp
    alphas = (0.005, 0.02, 0.05, 0.1)
    for i, a in enumerate(alphas):
        m = sc.add_material(host.MaterialSpec(
            bsdf_type=schema.BSDF_ROUGHCONDUCTOR, alpha=a, distribution=1,
            eta_c=(0.2, 0.92, 1.1), k_c=(3.9, 2.45, 2.14)))
        y = -1.7 + i * 0.5
        z = 2.0 - i * 0.7
        sc.create_node(shapes.cube(), m,
                       tf.compose(tf.translate([0, y, z]),
                                  tf.rotate_deg([1, 0, 0], -25),
                                  tf.scale([4.0, 0.03, 0.35])),
                       name=f"bar{i}")

    # four sphere lights, equal power: radiance ~ 1/r^2
    radii = (0.035, 0.09, 0.25, 0.6)
    xs = (-3.0, -1.0, 1.0, 3.0)
    power = 3.0
    for i, (r, x) in enumerate(zip(radii, xs)):
        le = power / (r * r * 4 * np.pi * np.pi)
        sc.create_node(shapes.sphere(radius=r, n_theta=12, n_phi=24), black,
                       tf.translate([x, 2.2, 2.0]),
                       emission=(le, le, le), name=f"light{i}")

    cam = sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE,
        tf.look_at([0, 0.8, -7.5], [0, 0.0, 2.0]),
        fov_x_deg=38.0, film_w=width, film_h=height)
    sc.set_sensor(cam)
    return sc


def veach_mis_anchor(width: int = 48, height: int = 48):
    """Low-tessellation veach-mis variant for the external RMSE anchor
    (tools/ref_renderer.py): same four-bar/four-sphere-light MIS setup, but
    sphere lights at 6x12 tessellation so the brute-force (no-BVH) reference
    renderer converges in minutes on one CPU core.  Geometry is shared data
    between both renderers; everything else about them is independent."""
    sc = host.DynamicScene()
    floor_m = sc.add_material(host.MaterialSpec(reflectance=(0.4, 0.4, 0.4)))
    back_m = sc.add_material(host.MaterialSpec(reflectance=(0.25, 0.25, 0.25)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0.0, 0.0, 0.0)))
    rect = shapes.rectangle()
    sc.create_node(rect, floor_m,
                   tf.compose(tf.translate([0, -2, 0]), tf.rotate_deg([1, 0, 0], -90),
                              tf.scale(12.0)), name="floor")
    sc.create_node(rect, back_m,
                   tf.compose(tf.translate([0, 2, 6]), tf.rotate_deg([0, 1, 0], 180),
                              tf.scale(12.0)), name="back")
    for i, a in enumerate((0.005, 0.02, 0.05, 0.1)):
        m = sc.add_material(host.MaterialSpec(
            bsdf_type=schema.BSDF_ROUGHCONDUCTOR, alpha=a, distribution=1,
            eta_c=(0.2, 0.92, 1.1), k_c=(3.9, 2.45, 2.14)))
        sc.create_node(shapes.cube(), m,
                       tf.compose(tf.translate([0, -1.7 + i * 0.5, 2.0 - i * 0.7]),
                                  tf.rotate_deg([1, 0, 0], -25),
                                  tf.scale([4.0, 0.03, 0.35])),
                       name=f"bar{i}")
    radii = (0.035, 0.09, 0.25, 0.6)
    xs = (-3.0, -1.0, 1.0, 3.0)
    for i, (r, x) in enumerate(zip(radii, xs)):
        le = 3.0 / (r * r * 4 * np.pi * np.pi)
        sc.create_node(shapes.sphere(radius=r, n_theta=6, n_phi=12), black,
                       tf.translate([x, 2.2, 2.0]),
                       emission=(le, le, le), name=f"light{i}")
    cam = sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE,
        tf.look_at([0, 0.8, -7.5], [0, 0.0, 2.0]),
        fov_x_deg=38.0, film_w=width, film_h=height)
    sc.set_sensor(cam)
    return sc


def cornell_glass(width: int = 256, height: int = 256):
    """Cornell variant with a glass sphere (caustics): the BDPT config
    (BASELINE config 4)."""
    sc = cornell_box(width, height, spheres=False)
    glass = sc.add_material(host.MaterialSpec(
        bsdf_type=schema.BSDF_DIELECTRIC, eta=1.5))
    diffuse = sc.add_material(host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    sc.create_node(shapes.sphere(radius=0.35, n_theta=24, n_phi=48), glass,
                   tf.translate([-0.4, -0.55, 0.2]), name="glass")
    sc.create_node(shapes.cube(), diffuse,
                   tf.compose(tf.translate([0.45, -0.7, -0.2]),
                              tf.rotate_deg([0, 1, 0], 20),
                              tf.scale([0.25, 0.3, 0.25])), name="box")
    return sc


def fog_cornell(width: int = 256, height: int = 256, sigma_s: float = 0.35,
                sigma_a: float = 0.03):
    """Cornell filled with homogeneous scattering fog: the PPM + volumetric
    config (BASELINE config 5)."""
    sc = cornell_glass(width, height)
    # the medium fills the unit cube under to_world; map it over the whole box
    m = tf.compose(tf.translate([-1.0, -1.0, -1.0]), tf.scale(2.0))
    sc.add_homogeneous_medium(sigma_a=(sigma_a,) * 3, sigma_s=(sigma_s,) * 3,
                              to_world=m)
    return sc


def furnace(width: int = 64, height: int = 64, albedo=0.7, radiance=1.0,
            mat_spec: "host.MaterialSpec" = None):
    """White furnace: a sphere inside a large emissive sphere. For an
    albedo-a surface under uniform illumination L, the exact reflected +
    direct radiance seen by the camera is L (energy conservation): any leak
    shows as bias."""
    sc = host.DynamicScene()
    if mat_spec is None:
        mat_spec = host.MaterialSpec(reflectance=(albedo,) * 3)
    m = sc.add_material(mat_spec)
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(shapes.sphere(radius=1.0, n_theta=32, n_phi=64), m, name="probe")
    env = shapes.sphere(radius=50.0, n_theta=16, n_phi=32)
    # flip faces inward
    env = shapes.TriMesh(env.v, env.f[:, ::-1], -env.n if env.n is not None else None,
                         env.uv)
    sc.create_node(env, black, emission=(radiance,) * 3, name="furnace")
    cam = sensors.make_sensor(schema.SENSOR_PERSPECTIVE,
                              tf.look_at([0, 0, -4], [0, 0, 0]),
                              fov_x_deg=30.0, film_w=width, film_h=height)
    sc.set_sensor(cam)
    return sc


def _noise_texture(n: int = 256, seed: int = 7) -> np.ndarray:
    """Multi-octave value-noise RGB image (keeps the image-texture path hot
    without any external asset)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n, 3), np.float32)
    for octv in (4, 8, 16, 32):
        g = rng.random((octv, octv, 3)).astype(np.float32)
        reps = n // octv
        up = np.kron(g, np.ones((reps, reps, 1), np.float32))
        img += up / octv * 8.0
    img /= img.max()
    return 0.15 + 0.7 * img


def _sky_envmap(h: int = 64, w: int = 128) -> np.ndarray:
    """Simple clear-sky gradient + sun disc equirect env map."""
    v = (np.arange(h, dtype=np.float32) + 0.5) / h            # 0 = up
    u = (np.arange(w, dtype=np.float32) + 0.5) / w
    vv, uu = np.meshgrid(v, u, indexing="ij")
    horizon = np.clip(1.0 - np.abs(vv - 0.5) * 2.0, 0.0, 1.0)
    zenith = np.clip(1.0 - vv * 2.0, 0.0, 1.0)
    sky = (zenith[..., None] * np.array([0.2, 0.35, 0.9])
           + horizon[..., None] * np.array([0.7, 0.75, 0.8]))
    sun_u, sun_v = 0.72, 0.22
    d2 = (uu - sun_u) ** 2 + (vv - sun_v) ** 2
    sky += np.exp(-d2 / 0.0004)[..., None] * np.array([40.0, 36.0, 30.0])
    return np.where(vv[..., None] < 0.52, sky, 0.08 * sky).astype(np.float32)


def san_miguel_stand_in(width: int = 1024, height: int = 1024,
                        target_tris: int = 1_200_000, seed: int = 3):
    """San-Miguel-class procedural stand-in: a courtyard with a colonnade,
    dense foliage (leaf quads), textured ground, env-map sky + sun
    (BASELINE config 3: multi-M tri BVH, textured materials, env light).

    No external asset needed; the triangle mass lives in the tree canopies
    like the real San Miguel."""
    rng = np.random.default_rng(seed)
    sc = host.DynamicScene()

    ground_tex = host.TextureSpec(tex_type=schema.TEX_IMAGE,
                                  image=_noise_texture(256),
                                  uv_scale=(12.0, 12.0))
    ground_m = sc.add_material(host.MaterialSpec(
        reflectance=(0.45, 0.4, 0.33), tex_reflectance=ground_tex))
    wall_m = sc.add_material(host.MaterialSpec(
        reflectance=(0.55, 0.45, 0.35),
        tex_reflectance=host.TextureSpec(tex_type=schema.TEX_CHECKERBOARD,
                                         value=(0.6, 0.5, 0.4),
                                         value1=(0.45, 0.37, 0.3),
                                         uv_scale=(16.0, 8.0))))
    leaf_m = sc.add_material(host.MaterialSpec(reflectance=(0.12, 0.35, 0.08)))
    trunk_m = sc.add_material(host.MaterialSpec(reflectance=(0.25, 0.16, 0.1)))

    # ground: tessellated grid with uv (40x40m)
    n = 96
    xs = np.linspace(-20, 20, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.12 * np.sin(gx * 0.6) * np.cos(gz * 0.7)
    gv = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    guv = np.stack([(gx + 20) / 40, (gz + 20) / 40], -1).reshape(-1, 2)
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    q00, q10 = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    q01, q11 = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    gf = np.concatenate([np.stack([q00, q10, q11], -1),
                         np.stack([q00, q11, q01], -1)]).astype(np.int32)
    ground = shapes.compute_vertex_normals(
        shapes.TriMesh(gv.astype(np.float32), gf, None, guv.astype(np.float32)))
    sc.create_node(ground, ground_m, name="ground")

    # colonnade: two rows of cylindrical columns
    cols = []
    for i in range(10):
        for side in (-1, 1):
            x = -18 + i * 4.0
            c = shapes.cylinder(p0=(x, 0, side * 12.0), p1=(x, 5.0, side * 12.0),
                                radius=0.45, n_seg=48)
            cols.append(c)
    sc.create_node(shapes.merge(cols), wall_m, name="colonnade")

    # walls
    wall = shapes.rectangle()
    for ang, pos in ((0, [0, 4, 14.5]), (180, [0, 4, -14.5])):
        sc.create_node(wall, wall_m,
                       tf.compose(tf.translate(pos), tf.rotate_deg([0, 1, 0], ang + 180),
                                  tf.scale([21.0, 5.0, 1.0])), name=f"wall{ang}{pos[2]}")

    # foliage: the triangle mass. K trees; leaf quads in ellipsoid canopies.
    used = 2 * gf.shape[0] // 2 + sum(c.f.shape[0] for c in cols)
    n_trees = 14
    leaves_per_tree = max((target_tris - used) // (2 * n_trees), 1)
    tree_pos = np.stack([rng.uniform(-16, 16, n_trees),
                         np.zeros(n_trees),
                         rng.uniform(-9, 9, n_trees)], -1)
    leaf_meshes = []
    trunk_meshes = []
    for tp in tree_pos:
        trunk_meshes.append(shapes.cylinder(
            p0=tuple(tp), p1=(tp[0] + rng.uniform(-0.5, 0.5), 3.2 + rng.uniform(0, 1),
                              tp[2] + rng.uniform(-0.5, 0.5)),
            radius=0.22, n_seg=16))
        K = leaves_per_tree
        # canopy ellipsoid
        u = rng.normal(size=(K, 3)).astype(np.float32)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        rad = rng.uniform(0.4, 1.0, (K, 1)).astype(np.float32) ** 0.4
        centers = (tp + np.array([0, 4.2, 0]) +
                   u * rad * np.array([2.4, 1.6, 2.4])).astype(np.float32)
        # leaf quad: two random tangent vectors, ~6cm leaves
        t1 = rng.normal(size=(K, 3)).astype(np.float32)
        t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
        t2 = np.cross(u, t1); t2 /= np.linalg.norm(t2, axis=1, keepdims=True)
        s = rng.uniform(0.03, 0.07, (K, 1)).astype(np.float32)
        v0 = centers - t1 * s - t2 * s
        v1 = centers + t1 * s - t2 * s
        v2 = centers + t1 * s + t2 * s
        v3 = centers - t1 * s + t2 * s
        verts = np.concatenate([v0, v1, v2, v3]).astype(np.float32)
        i0 = np.arange(K, dtype=np.int32)
        faces = np.concatenate([np.stack([i0, i0 + K, i0 + 2 * K], -1),
                                np.stack([i0, i0 + 2 * K, i0 + 3 * K], -1)])
        leaf_meshes.append(shapes.TriMesh(verts, faces.astype(np.int32), None, None))
    sc.create_node(shapes.merge(trunk_meshes), trunk_m, name="trunks")
    sc.create_node(shapes.compute_vertex_normals(shapes.merge(leaf_meshes)),
                   leaf_m, name="foliage")

    sc.set_environment(_sky_envmap(), scale=(1.0, 1.0, 1.0))
    sc.add_distant_light(direction=(-0.45, -0.75, 0.49), radiance=(12.0, 11.0, 9.0))

    cam = sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE,
        tf.look_at([8.0, 2.3, -13.2], [-6.0, 2.8, 8.0]),
        fov_x_deg=55.0, film_w=width, film_h=height)
    sc.set_sensor(cam)
    return sc
