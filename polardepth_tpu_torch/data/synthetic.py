"""Synthetic HAMMER-like scenes with physically consistent polarization
(a copy of polardepth_tpu/data/synthetic.py; the same seed gives the same
bytes).

The real HAMMER dataset is not distributable with the framework, so tests,
overfit smoke runs and benchmarks use generated scenes in which every
quantity is derived from a common ground-truth geometry:

  world     : a tilted background plane + material spheres (HAMMER id scheme
              20..200), one fixed world per sample index
  camera    : a smooth trajectory T(frame) (cam-to-world), so temporal
              neighbours at +-offset exist with known relative poses — this
              exercises the pose / reprojection / cost-volume paths
  depth     : exact ray-plane / ray-sphere intersections per pixel
  normals   : analytic surface normals
  DoLP/AoLP : diffuse Fresnel curve at the view-zenith angle; azimuth
  pol       : I(a) = Iun * (1 + rho * cos(2a - 2phi)) at 0/45/90/135 deg
  rgb       : Lambertian shading

Because the forward model uses the same Fresnel curves the network's priors
invert, the XOLP/normals encoders receive real signal — an overfit run must
drive the supervised losses toward zero (the reference's own smoke test,
--overfit, options.py:205-212).

`write_synthetic_scene` dumps the exact on-disk layout the HAMMER loader
scans (<scene>/polarization/{rgb,pol00,pol01,pol10,pol11,_instance,_gt,
_pose}/%06d.png|txt + intrinsics.txt), so the real loader is testable
without the real dataset.
"""

from __future__ import annotations

import os

import numpy as np

from polardepth_tpu_torch.ops.fresnel import _diffuse_curve

MATERIAL_IDS = {
    "box": 20, "bottle": 40, "can": 60, "cup": 80, "remote": 100,
    "teapot": 120, "cutlery": 140, "glass": 160, "table": 180, "wall": 200,
}


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


class SyntheticHammer:
    """In-memory generator of HAMMER-schema samples.

    Each sample dict (numpy, NHWC, host dtypes ready for device upload):
      color     (H, W, 3) uint8        rgb render
      pol       (H, W, 4) uint8        captures at [0, 45, 90, 135] deg
      depth     (H, W, 1) float32      supervision depth (m)
      depth_gt  (H, W, 1) float32      ground-truth depth (m)
      mask      (H, W, 1) int32        instance/material ids
      K, inv_K  (4, 4)    float32      scale-0 intrinsics
      pose      (4, 4)    float32      cam-to-world at this frame
    """

    def __init__(self, height: int = 320, width: int = 480, n: float = 1.5,
                 num_objects: int = 4, seed: int = 0,
                 degenerate_materials: tuple = (),
                 transmissive_materials: tuple = ()):
        """degenerate_materials: material NAMES (keys of MATERIAL_IDS, e.g.
        ("glass", "cutlery")) rendered as *photometrically degenerate*
        specular surfaces — the regime the reference was built for (its 10
        household glass/metal items, manydepth/evaluation.py:242-264):

          * RGB: flat untextured mid-gray — no Lambertian term, no texture,
            so intensity carries NO geometry signal on these pixels;
          * polarization: the SPECULAR Fresnel DoLP curve (strong response,
            saturating near Brewster) with the specular AoLP convention
            (polarization axis perpendicular to the plane of incidence,
            i.e. azimuth + 90 deg) — the exact physics the network's
            two-branch specular priors invert (ops/fresnel.py).

        transmissive_materials: material names rendered as thin TRANSPARENT
        surfaces.  Textureless-but-opaque turned out to be *easy* for
        RGB-only supervised depth (contour + context pin the shape —
        ATTENTION_SWEEP_DEGEN.md analysis); what defeats RGB on real glass
        is photometry that is MISLEADING, not missing: the camera sees the
        background *through* the object while the true surface sits closer.
        Transmissive pixels therefore render:

          * RGB: the background plane's shading+texture continued along the
            ray past the object (thin-surface approximation — no refractive
            bend, x0.82 transmission loss), so intensity cues point at the
            BACKGROUND depth while depth_gt stays at the surface;
          * polarization: transmitted (background) intensity, but DoLP/AoLP
            from the SURFACE's specular Fresnel reflection — the one channel
            that still carries surface-true geometry, as in the reference's
            glass regime (BASELINE.md slides 33/39).

        Default () keeps the legacy all-diffuse corpus (golden tests /
        convergence baselines unchanged)."""
        self.height = height
        self.width = width
        self.n = n
        self.num_objects = num_objects
        self.seed = seed
        rho_d, theta_d = _diffuse_curve(n)
        self._rho_of_theta = (theta_d, rho_d)
        # forward specular rho_s(theta) (the UNsplit curve; the two-branch
        # split in ops/fresnel is for the inverse problem only)
        theta = np.linspace(0.0, np.pi / 2, 1000)
        s = np.sin(theta)
        rho_s = (2.0 * s ** 2 * np.cos(theta) * np.sqrt(n ** 2 - s ** 2)) / (
            n ** 2 - s ** 2 - n ** 2 * s ** 2 + 2.0 * s ** 4)
        self._rho_spec_of_theta = (theta, rho_s)
        unknown = [m for m in (tuple(degenerate_materials)
                               + tuple(transmissive_materials))
                   if m not in MATERIAL_IDS]
        if unknown:
            raise ValueError(f"unknown degenerate materials {unknown}")
        # transmissive ids are a degenerate subclass: both use the specular
        # polarization model; they differ only in the RGB branch
        self.transmissive_ids = np.array(
            [MATERIAL_IDS[m] for m in transmissive_materials], np.int32)
        self.degenerate_ids = np.unique(np.concatenate([
            np.array([MATERIAL_IDS[m] for m in degenerate_materials],
                     np.int32), self.transmissive_ids])).astype(np.int32)
        # Normalized intrinsics follow the HAMMER convention
        # (indoor_dataset.py:262-275): fx=0.58W, fy=0.60H, c=(0.5W, 0.5H).
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = 0.58 * width
        K[1, 1] = 0.60 * height
        K[0, 2] = 0.5 * width
        K[1, 2] = 0.5 * height
        self.K = K
        self.inv_K = np.linalg.pinv(K).astype(np.float32)

    # -- world ---------------------------------------------------------------

    def _world(self, index: int):
        """Fixed world geometry for a sample index (shared by all frames)."""
        rng = np.random.default_rng(self.seed * 100003 + index)
        tilt = rng.uniform(-0.25, 0.25, size=2)
        n_bg = np.array([tilt[0], tilt[1], 1.0])
        n_bg /= np.linalg.norm(n_bg)
        d_bg = rng.uniform(1.4, 1.9)
        if len(self.degenerate_ids):
            # guarantee every scene contains the degenerate objects (the
            # slice under study must exist in every eval frame)
            pool = [m for m in list(MATERIAL_IDS.values())[:8]
                    if m not in self.degenerate_ids]
            n_rest = max(self.num_objects - len(self.degenerate_ids), 0)
            ids = np.concatenate([
                self.degenerate_ids,
                rng.choice(pool, n_rest, replace=False)])[:self.num_objects]
        else:
            ids = rng.choice(list(MATERIAL_IDS.values())[:8],
                             self.num_objects, replace=False)
        spheres = [(np.array([rng.uniform(-0.35, 0.35),
                              rng.uniform(-0.25, 0.25),
                              rng.uniform(0.7, 1.2)]),
                    rng.uniform(0.08, 0.18), int(mid)) for mid in ids]
        return rng, (n_bg, d_bg), spheres

    def pose(self, index: int, frame: int = 0) -> np.ndarray:
        """Cam-to-world pose along a smooth per-scene trajectory."""
        rng = np.random.default_rng(self.seed * 100003 + index + 777)
        vel = rng.uniform(-0.004, 0.004, 3)
        yaw_rate = rng.uniform(-0.0015, 0.0015)
        T = np.eye(4)
        T[:3, :3] = _rot_y(yaw_rate * frame)
        T[:3, 3] = vel * frame
        return T.astype(np.float32)

    def relative_pose(self, index: int, frame: int, center: int) -> np.ndarray:
        """inv(inv(T_center) @ T_frame) — the reference's convention
        (hammer_dataset.py:104-132)."""
        T_c = self.pose(index, center).astype(np.float64)
        T_s = self.pose(index, frame).astype(np.float64)
        return np.linalg.inv(np.linalg.inv(T_c) @ T_s).astype(np.float32)

    # -- rendering -----------------------------------------------------------

    def _render_geometry(self, index: int, frame: int):
        h, w = self.height, self.width
        K = self.K
        rng, (n_bg, d_bg), spheres = self._world(index)
        T = self.pose(index, frame).astype(np.float64)
        R, t = T[:3, :3], T[:3, 3]

        u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                           np.arange(h, dtype=np.float64))
        d_cam = np.stack([(u - K[0, 2]) / K[0, 0],
                          (v - K[1, 2]) / K[1, 1],
                          np.ones_like(u)], axis=-1)
        d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
        d_w = d_cam @ R.T                      # world-frame ray directions
        o_w = t                                # camera origin in world

        # background plane n.p = d
        denom = d_w @ n_bg
        s_bg = (d_bg - o_w @ n_bg) / np.where(np.abs(denom) > 1e-6, denom,
                                              1e-6)
        s_bg = np.where(s_bg > 0, s_bg, 1e6)
        s_hit = s_bg
        normals_w = np.broadcast_to(n_bg, (h, w, 3)).copy()
        mask = np.full((h, w), MATERIAL_IDS["table"], np.int32)

        for c, r, mid in spheres:
            oc = o_w - c
            b = -(d_w @ oc)
            disc = b * b - (oc @ oc - r * r)
            hit = disc > 0
            s = b - np.sqrt(np.maximum(disc, 0.0))
            closer = hit & (s > 0.05) & (s < s_hit)
            p_w = o_w + d_w * s[..., None]
            n_sph = (p_w - c) / r
            s_hit = np.where(closer, s, s_hit)
            normals_w = np.where(closer[..., None], n_sph, normals_w)
            mask = np.where(closer, mid, mask)

        depth = s_hit * d_cam[..., 2]          # z in camera frame
        normals_cam = normals_w @ R            # world -> cam rotation (R^T)^T
        p_w = o_w + d_w * s_hit[..., None]     # world hit points (texture anchor)
        # see-through anchor: where the ray meets the background plane —
        # what a transmissive surface shows (thin-surface approximation;
        # occluding spheres behind glass are ignored)
        p_bg = o_w + d_w * s_bg[..., None]
        return rng, depth, normals_cam, normals_w, d_cam, mask, p_w, \
            (p_bg, n_bg)

    @staticmethod
    def _tex(p_w):
        """World-anchored procedural texture: gives photometric matching
        something to lock onto (view-consistent by construction)."""
        return (0.85 + 0.08 * np.sin(37.0 * p_w[..., 0])
                * np.sin(31.0 * p_w[..., 1])
                + 0.07 * np.sin(53.0 * (p_w[..., 0] + p_w[..., 2])))

    def _polarize(self, rng, normals_cam, normals_w, d_cam, p_w, mask=None,
                  bg=None):
        """Fresnel forward model -> 4 uint8 captures + shading.

        Lambertian shading uses the WORLD-frame light direction so multiple
        views of a surface are photometrically consistent (required for the
        reprojection / cost-volume paths to have signal); the polarization
        state uses camera-frame normals — view-dependent by physics.

        Pixels whose material id is in self.degenerate_ids switch to the
        photometrically degenerate specular model; ids in
        self.transmissive_ids additionally replace the RGB/intensity with
        the see-through background render (see __init__).  bg is the
        (p_bg, n_bg) see-through anchor from _render_geometry.
        """
        cos_t = np.clip(np.abs((normals_cam * -d_cam).sum(-1)), 0.0, 1.0)
        theta = np.arccos(cos_t)
        theta_lut, rho_lut = self._rho_of_theta
        rho = np.interp(theta, theta_lut, rho_lut)
        phi = np.arctan2(normals_cam[..., 1], normals_cam[..., 0])
        phi = np.arctan(np.tan(phi + 1e-9))    # fold to (-pi/2, pi/2]

        light = np.array([0.3, -0.5, -0.8])
        light /= np.linalg.norm(light)
        shade = np.clip((normals_w * -light).sum(-1), 0.15, 1.0)
        shade = shade * self._tex(p_w)

        deg = trans = None
        if mask is not None and len(self.degenerate_ids):
            deg = np.isin(mask, self.degenerate_ids)
            # specular DoLP (strong, Brewster-saturating) with the specular
            # AoLP convention (perpendicular to the plane of incidence)
            theta_s_lut, rho_s_lut = self._rho_spec_of_theta
            rho = np.where(deg, np.interp(theta, theta_s_lut, rho_s_lut),
                           rho)
            phi_s = np.arctan(np.tan(phi + np.pi / 2 + 1e-9))
            phi = np.where(deg, phi_s, phi)
            # RGB degeneracy: flat mid-gray — no Lambert, no texture; the
            # intensity image carries zero shape information here
            shade = np.where(deg, 0.55, shade)
        if mask is not None and len(self.transmissive_ids) and bg is not None:
            trans = np.isin(mask, self.transmissive_ids)
            p_bg, n_bg = bg
            # transmitted radiance: the background plane's Lambert+texture
            # continued along the ray, x0.82 transmission loss.  This drives
            # BOTH the RGB and the polarization captures' total intensity —
            # only DoLP/AoLP (already specular-surface above) keep surface
            # geometry, exactly the misleading-photometry glass regime.
            bg_shade = np.clip(float(-(n_bg @ light)), 0.15, 1.0)
            shade = np.where(trans, 0.82 * bg_shade * self._tex(p_bg), shade)
        iun = 40.0 + 170.0 * shade

        angles = np.deg2rad([0.0, 45.0, 90.0, 135.0])
        pol = np.stack([iun * (1.0 + rho * np.cos(2 * a - 2 * phi)) / 1.8
                        for a in angles], axis=-1)
        pol = np.clip(pol + rng.normal(0, 1.0, pol.shape), 0, 255)

        albedo = np.stack([0.9 * shade, 0.75 * shade + 0.05,
                           0.6 * shade + 0.1], axis=-1)
        if deg is not None:
            # neutral gray: no color cue either (transmissive pixels keep
            # the background's colored texture instead — the misleading cue)
            flat = deg if trans is None else (deg & ~trans)
            albedo = np.where(flat[..., None], 0.55, albedo)
        rgb = np.clip(albedo * 255.0, 0, 255)
        return pol.astype(np.uint8), rgb.astype(np.uint8)

    def sample(self, index: int, frame: int = 0) -> dict:
        rng, depth, normals_cam, normals_w, d_cam, mask, p_w, bg = \
            self._render_geometry(index, frame)
        pol, rgb = self._polarize(rng, normals_cam, normals_w, d_cam, p_w,
                                  mask, bg)
        d32 = depth.astype(np.float32)[..., None]
        return {
            "color": rgb,
            "pol": pol,
            "depth": d32,
            "depth_gt": d32.copy(),
            "mask": mask[..., None].astype(np.int32),
            "K": self.K,
            "inv_K": self.inv_K,
            "pose": self.pose(index, frame),
        }

    def batch(self, batch_size: int, start: int = 0) -> dict:
        samples = [self.sample(start + i) for i in range(batch_size)]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def batch_frames(self, batch_size: int, frame_ids=(0, -1, 1),
                     offset: int = 10, start: int = 0) -> dict:
        """Multi-frame batch for the self-supervised / cost-volume paths.

        Adds: color_frames (B, F, H, W, 3) uint8 in frame_ids order and
        rel_poses (B, F, 4, 4) (identity at frame 0; reference pose
        convention for neighbours)."""
        base = self.batch(batch_size, start)
        frames = []
        rels = []
        for b in range(batch_size):
            idx = start + b
            fr = [self.sample(idx, frame=f * offset)["color"]
                  for f in frame_ids]
            rel = [self.relative_pose(idx, f * offset, 0) if f else
                   np.eye(4, dtype=np.float32) for f in frame_ids]
            frames.append(np.stack(fr))
            rels.append(np.stack(rel))
        base["color_frames"] = np.stack(frames)
        base["rel_poses"] = np.stack(rels)
        return base


def write_synthetic_scene(root: str, scene: str, num_frames: int = 12,
                          height: int = 320, width: int = 480,
                          seed: int = 0,
                          degenerate_materials: tuple = (),
                          transmissive_materials: tuple = ()) -> str:
    """Dump a synthetic scene in the on-disk HAMMER layout so HammerIndex /
    HammerLoader can be exercised without the real dataset.  All frames view
    world #0 from the per-frame trajectory pose."""
    import cv2

    gen = SyntheticHammer(height, width, seed=seed,
                          degenerate_materials=degenerate_materials,
                          transmissive_materials=transmissive_materials)
    base = os.path.join(root, scene, "polarization")
    subdirs = ["rgb", "pol00", "pol01", "pol10", "pol11", "_instance",
               "_gt", "_pose"]
    for d in subdirs:
        os.makedirs(os.path.join(base, d), exist_ok=True)
    # intrinsics.txt holds the *normalized* 3x3 (indoor_dataset.py:262-275)
    Kn = gen.K.copy()
    Kn[0, :] /= width
    Kn[1, :] /= height
    with open(os.path.join(base, "intrinsics.txt"), "w") as f:
        f.write(" ".join(str(x) for x in Kn[:3, :3].reshape(-1)))

    for i in range(num_frames):
        s = gen.sample(0, frame=i)
        name = f"{i:06d}.png"
        cv2.imwrite(os.path.join(base, "rgb", name),
                    cv2.cvtColor(s["color"], cv2.COLOR_RGB2BGR))
        # quad-mosaic convention: pol00=0deg, pol01=45, pol10=90, pol11=135
        for d, ch in (("pol00", 0), ("pol01", 1), ("pol10", 2), ("pol11", 3)):
            cv2.imwrite(os.path.join(base, d, name), s["pol"][..., ch])
        cv2.imwrite(os.path.join(base, "_instance", name),
                    s["mask"][..., 0].astype(np.uint8))
        depth_mm = (s["depth_gt"][..., 0] * 1000.0).astype(np.uint16)
        cv2.imwrite(os.path.join(base, "_gt", name), depth_mm)
        with open(os.path.join(base, "_pose", f"{i:06d}.txt"), "w") as f:
            f.write(" ".join(str(x) for x in s["pose"].reshape(-1)))
    return base
