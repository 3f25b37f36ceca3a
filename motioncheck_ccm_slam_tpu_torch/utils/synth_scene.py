"""Synthetic renderable scene for end-to-end runs of the command line.

A copy of ``tests/synth_scene.py`` (the JAX package's test scene, which
``motioncheck_ccm_slam_tpu/cli.py`` imports from ``tests/``) inside the
port, so the port's CLI needs nothing outside its package. The rendering
is the same numpy; ``SynthScene.pose`` takes ``se3_exp``, a float32 numpy
copy of the port's ``ops/lie.se3_exp``, in place of JAX's.

Renders a cloud of bright/dark blobs (stable ORB targets) onto a virtual
camera moving along a known trajectory — the deterministic stand-in for EuRoC
replay (SURVEY.md §4 test strategy).
"""
import numpy as np

from ..config import Config

_F32 = np.float32


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """A float32 numpy copy of ``ops/lie.se3_exp`` for one tangent (6,).

    The scene's yaw is ~0.01 rad, where (theta - sin theta) / theta^3 and
    (1 - cos theta) / theta^2 cancel to a few significant bits in float32:
    a one-ulp difference in sin or cos moves the pose by up to ~1e-5. numpy's
    float32 sin and cos are correctly rounded on these inputs, as JAX's are,
    and torch's cos is not always, so the ground truth takes numpy's."""
    xi = np.asarray(xi, _F32)
    w, v = xi[:3], xi[3:]
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = theta2 < _F32(1e-8)
    t2 = _F32(1.0) if small else theta2
    theta = np.sqrt(t2)
    if small:
        a = _F32(1.0) - theta2 / _F32(6.0)
        b = _F32(0.5) - theta2 / _F32(24.0)
        c = _F32(1.0) / _F32(6.0) - theta2 / _F32(120.0)
    else:
        a = np.sin(theta) / theta
        b = (_F32(1.0) - np.cos(theta)) / t2
        c = (theta - np.sin(theta)) / (t2 * theta)
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], _F32)
    W2 = W @ W
    eye = np.eye(3, dtype=_F32)
    T = np.eye(4, dtype=_F32)
    T[:3, :3] = eye + a * W + b * W2
    T[:3, 3] = (eye + b * W + c * W2) @ v
    return T


class SynthScene:
    def __init__(self, config: Config, n_points=600, seed=0, depth=6.0,
                 spread=8.0, speed=0.9):
        rng = np.random.default_rng(seed)
        self.config = config
        self.speed = speed
        # points ON (slightly proud of) the textured wall plane at z=7.5 —
        # like markings on a surface. Floating points far in front of the
        # background would make every feature's BRIEF context shift by tens
        # of pixels over the run (unrealistic appearance churn; real corners
        # live on surfaces).
        self.pts = np.stack(
            [
                rng.uniform(-spread, spread, n_points),
                rng.uniform(-spread * 0.6, spread * 0.6, n_points),
                7.5 - rng.uniform(0.0, 0.9, n_points),
            ],
            -1,
        ).astype(np.float32)
        self.radii = rng.integers(2, 4, n_points)
        # continuous brightness spread keeps descriptors distinctive (two
        # appearance classes would alias every blob with every other)
        lo = rng.uniform(20.0, 90.0, n_points)
        hi = rng.uniform(140.0, 250.0, n_points)
        self.bright = np.where(rng.random(n_points) < 0.4, lo, hi)
        self.K = config.camera.K()
        # static low-frequency background texture gives each blob a unique
        # neighborhood; project it from the dominant scene plane
        bg_cells = rng.uniform(70.0, 150.0, size=(24, 38)).astype(np.float32)
        self.bg_cells = bg_cells

    def _render_background(self, Tcw: np.ndarray, h: int, w: int) -> np.ndarray:
        """Project the static wall texture (plane z=depth in world) so the
        background moves consistently with the camera."""
        K = self.K
        Twc = np.linalg.inv(Tcw)
        yy, xx = np.mgrid[0:h, 0:w]
        rays = np.stack(
            [
                (xx + 0.5 - K[0, 2]) / K[0, 0],
                (yy + 0.5 - K[1, 2]) / K[1, 1],
                np.ones_like(xx, np.float32),
            ],
            -1,
        ).astype(np.float32)
        rays_w = rays @ Twc[:3, :3].T
        C = Twc[:3, 3]
        depth_plane = 7.5
        s = (depth_plane - C[2]) / np.maximum(rays_w[..., 2], 1e-6)
        px = C[0] + s * rays_w[..., 0]
        py = C[1] + s * rays_w[..., 1]
        gh, gw = self.bg_cells.shape
        u = np.clip((px + 10.0) / 20.0 * (gw - 1), 0, gw - 1.001)
        v = np.clip((py + 6.0) / 12.0 * (gh - 1), 0, gh - 1.001)
        u0 = u.astype(np.int32)
        v0 = v.astype(np.int32)
        fu = u - u0
        fv = v - v0
        c = self.bg_cells
        return (
            c[v0, u0] * (1 - fu) * (1 - fv)
            + c[v0, u0 + 1] * fu * (1 - fv)
            + c[v0 + 1, u0] * (1 - fu) * fv
            + c[v0 + 1, u0 + 1] * fu * fv
        ).astype(np.float32)

    def pose(self, t: float) -> np.ndarray:
        """Ground-truth Tcw at time t: sideways translation + slight yaw.

        Speed matches the EuRoC MAV operating point (~1.4 m/s at 20 fps ->
        ~5px/frame optical flow at 6m depth); much slower motion leaves
        per-keyframe parallax too weak to constrain landmark depths.
        """
        xi = np.array(
            [0.0, 0.012 * np.sin(t * 0.7), 0.0, self.speed * t,
             0.03 * np.sin(t), 0.0],
            np.float32,
        )
        return se3_exp(xi)

    def render(self, Tcw: np.ndarray) -> np.ndarray:
        cam = self.config.camera
        h, w = cam.height, cam.width
        # background: sample the wall-plane texture through the camera (the
        # wall is at z = depth in the world; rays through each pixel hit it at
        # world x,y which index the texture) — smooth bilinear look-up
        img = self._render_background(Tcw, h, w)
        R, tr = Tcw[:3, :3], Tcw[:3, 3]
        pc = self.pts @ R.T + tr
        z = pc[:, 2]
        vis = z > 0.2
        u = self.K[0, 0] * pc[:, 0] / z + self.K[0, 2]
        v = self.K[1, 1] * pc[:, 1] / z + self.K[1, 2]
        yy, xx = np.mgrid[0:h, 0:w]
        for i in np.flatnonzero(vis):
            ui, vi = u[i], v[i]
            if not (-8 < ui < w + 8 and -8 < vi < h + 8):
                continue
            r = max(2.0, self.radii[i] * 6.0 / z[i])
            ri = int(np.ceil(r)) + 2
            x0, x1 = max(0, int(ui) - ri), min(w, int(ui) + ri + 1)
            y0, y1 = max(0, int(vi) - ri), min(h, int(vi) + ri + 1)
            if x0 >= x1 or y0 >= y1:
                continue
            patch_y = yy[y0:y1, x0:x1]
            patch_x = xx[y0:y1, x0:x1]
            # anti-aliased disc: 1px feathered edge so feature positions move
            # smoothly with subpixel motion (hard-edged discs quantize corner
            # locations to whole pixels and wreck pose estimation)
            d = np.sqrt((patch_y - vi) ** 2 + (patch_x - ui) ** 2)
            alpha = np.clip(r + 0.5 - d, 0.0, 1.0)
            img[y0:y1, x0:x1] = (
                img[y0:y1, x0:x1] * (1 - alpha) + self.bright[i] * alpha
            )
        return img

    def sequence(self, n_frames: int, fps: float = 20.0):
        for i in range(n_frames):
            t = i / fps
            Tcw = self.pose(t)
            yield t, Tcw, self.render(Tcw)


class RingScene(SynthScene):
    """Corridor-loop world: blobs on a cylindrical band, camera on an inner
    circle facing outward. A full revolution organically revisits the start
    — the trajectory shape behind EuRoC-style loop closures — and agents
    started at different angles of the SAME ring overlap pairwise, driving
    cross-map matches, cascaded merges, and post-merge loop closures.

    ``start_deg`` offsets the agent's start angle; ``omega`` (rad/s) sets
    angular speed (0.26 ~= 1.3 m/s at radius 5, the EuRoC MAV operating
    point; one revolution ~= 480 frames at 20 fps).
    """

    RING_BG = 12.0       # background cylinder radius
    RING_BAND = 11.0     # landmark band radius
    CAM_R = 5.0          # camera circle radius

    def __init__(self, config: Config, n_points=1400, seed=0,
                 start_deg: float = 0.0, omega: float = 0.26):
        super().__init__(config, n_points=n_points, seed=seed)
        rng = np.random.default_rng(seed + 17)
        self.start = np.deg2rad(start_deg)
        self.omega = omega
        th = rng.uniform(0, 2 * np.pi, n_points)
        r = self.RING_BAND + rng.uniform(-0.7, 0.7, n_points)
        y = rng.uniform(-2.2, 2.2, n_points)
        self.pts = np.stack(
            [r * np.cos(th), y, r * np.sin(th)], -1
        ).astype(np.float32)
        # angular background texture (indexed by azimuth, height)
        self.bg_cells = rng.uniform(70.0, 150.0, size=(24, 96)).astype(
            np.float32)

    def pose(self, t: float) -> np.ndarray:
        th = self.start + self.omega * t
        y = 0.25 * np.sin(3.0 * th)      # vertical bob: non-planar motion
        C = np.array([self.CAM_R * np.cos(th), y,
                      self.CAM_R * np.sin(th)], np.float32)
        fwd = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        x = np.cross(up, fwd)
        x /= np.linalg.norm(x)
        yax = np.cross(fwd, x)
        R_wc = np.stack([x, yax, fwd], -1)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = R_wc.T
        Tcw[:3, 3] = -R_wc.T @ C
        return Tcw

    def _render_background(self, Tcw: np.ndarray, h: int, w: int):
        """Rays hit the background CYLINDER x^2 + z^2 = R^2; texture is
        indexed by (azimuth, world y) so it scrolls consistently."""
        K = self.K
        Twc = np.linalg.inv(Tcw)
        yy, xx = np.mgrid[0:h, 0:w]
        rays = np.stack(
            [
                (xx + 0.5 - K[0, 2]) / K[0, 0],
                (yy + 0.5 - K[1, 2]) / K[1, 1],
                np.ones_like(xx, np.float32),
            ],
            -1,
        ).astype(np.float32)
        d = rays @ Twc[:3, :3].T
        C = Twc[:3, 3]
        a = d[..., 0] ** 2 + d[..., 2] ** 2
        b = 2.0 * (C[0] * d[..., 0] + C[2] * d[..., 2])
        c = C[0] ** 2 + C[2] ** 2 - self.RING_BG ** 2
        disc = np.maximum(b * b - 4 * a * c, 0.0)
        s = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-9)
        px = C[0] + s * d[..., 0]
        py = C[1] + s * d[..., 1]
        pz = C[2] + s * d[..., 2]
        az = np.arctan2(pz, px)                       # [-pi, pi]
        gh, gw = self.bg_cells.shape
        u = (az + np.pi) / (2 * np.pi) * gw           # wraps
        v = np.clip((py + 6.0) / 12.0 * (gh - 1), 0, gh - 1.001)
        u0 = u.astype(np.int32) % gw
        u1 = (u0 + 1) % gw
        v0 = v.astype(np.int32)
        fu = u - np.floor(u)
        fv = v - v0
        cgrid = self.bg_cells
        return (
            cgrid[v0, u0] * (1 - fu) * (1 - fv)
            + cgrid[v0, u1] * fu * (1 - fv)
            + cgrid[np.minimum(v0 + 1, gh - 1), u0] * (1 - fu) * fv
            + cgrid[np.minimum(v0 + 1, gh - 1), u1] * fu * fv
        ).astype(np.float32)
