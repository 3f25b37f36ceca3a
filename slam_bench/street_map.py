"""The loop cell's map: one agent's street drive at server capacity, made
on the device from the seed.

A car drives the traffic file's ``map.legs`` over a street grid of
``block_m`` blocks (90-degree turns on arcs of ``turn_radius_m``), its
camera ``camera_height_m`` above the road looking forward, one keyframe
every ``kf_step_m`` of road. Facade points stand ``facade_offset_m`` to
either side of every street driven and ``facade_height_m`` high, in sight
only from their own street (the camera within ``sight_corridor_m`` of its
centre line: the buildings hide the others); each keyframe observes up to
``extractor.n_features`` of those inside its image
(``border_px`` in) at ``depth_m`` depth, drawn at random, with
``obs_noise_px`` of Gaussian noise on the true projection. Each world
point has a random 256-bit descriptor; each landmark and each observation
carries it with 0-``desc_flip_max`` bits flipped.

A keyframe that passes within ``0.75 * kf_step_m`` of an earlier one
(``revisit_gap_m`` of road before it or more) in the same direction
(within 30 degrees) revisits it. The route holds three revisits: the first
two are closed loops (their landmarks are the first pass's, their poses
the truth, ``loop_edge`` set on their third keyframe and its match), the
last re-drives the street where the drive began and ends the drive. From
the end of the second revisit on, the map carries a Sim3 drift that grows
linearly with the road driven and reaches ``drift_scale`` and
``drift_yaw_deg`` (about the vertical) where the last revisit begins:
each step of the drifted stretch is scaled and turned by the drift at its
start, so the map stays locally consistent and the error accumulates, as
a monocular map's does. Keyframes of the drifted stretch pose as the drift
moves them; the poses and landmarks carry no other error, and the
observations carry ``obs_noise_px``. Before the drift a world point is one landmark however often
it is seen (the closed loops fused their copies); from the drift on, each
visit of a point (a run of observers with gaps under ``revisit_gap_m``)
that starts in the drifted stretch makes a landmark of its own, moved by
the drift of its first observer, as a monocular map holds before a loop
closes: the last revisit sees a second, drifted copy of the first
street.

The route and the drift are geometry (numpy on the host, a few thousand
poses); everything drawn from the seed is made on the device by one
``torch.Generator``. Nothing here imports the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CHUNK_KFS = 128
FLIP_CHUNK = 1 << 18
COPIES = 8          # landmarks a world point may have: one a visit in the drift
DIRS = {"E": (1.0, 0.0), "N": (0.0, 1.0), "W": (-1.0, 0.0), "S": (0.0, -1.0)}


class StreetScene(NamedTuple):
    Tcw: torch.Tensor        # (NK, 4, 4) f32 map poses (the drift applied)
    Tcw_true: torch.Tensor   # (NK, 4, 4) f64 true poses
    kf_id: torch.Tensor      # (NK,) i32
    timestamp: torch.Tensor  # (NK,) f32
    xy: torch.Tensor         # (NK, F, 2) f32 noisy projections
    desc: torch.Tensor       # (NK, F, 8) i32 observation descriptors
    mp_idx: torch.Tensor     # (NK, F) i32 landmark per feature slot or -1
    loop_edge: torch.Tensor  # (NK,) i32 the closed loops' pairs, else -1
    Xw: torch.Tensor         # (NM, 3) f32 landmarks (drifted where made drifted)
    mp_desc: torch.Tensor    # (NM, 8) i32
    normal: torch.Tensor     # (NM, 3) f32 unit direction from the first observer
    dist_ref: torch.Tensor   # (NM,) f32 distance from the first observer
    ref_kf: torch.Tensor     # (NM,) i32 first observing keyframe or -1
    mp_valid: torch.Tensor   # (NM,) bool observed by some keyframe
    route: dict              # host numpy: positions, headings, revisits, drift


def _tilt() -> np.ndarray:
    """The rotation that takes the vertical (0, 0, 1) to (1, 1, 1)/sqrt(3)."""
    n = np.ones(3) / np.sqrt(3.0)
    axis = np.cross([0.0, 0.0, 1.0], n)
    ang = np.arccos(n[2])
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    K /= np.linalg.norm(axis)
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _rz(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def path(m: dict):
    """The route as primitives: ("line", start (2,), direction (2,),
    length) and ("arc", centre (2,), radius, start angle, sweep)."""
    b, r = m["block_m"], m["turn_radius_m"]
    corners = [np.zeros(2)]
    dirs = []
    for d, n in m["legs"]:
        dirs.append(np.asarray(DIRS[d]))
        corners.append(corners[-1] + dirs[-1] * n * b)
    prims = []
    start = corners[0]
    for i, d in enumerate(dirs):
        end = corners[i + 1]
        nxt = dirs[i + 1] if i + 1 < len(dirs) else None
        cut = r if nxt is not None and abs(float(d @ nxt)) < 0.5 else 0.0
        if nxt is not None and float(d @ nxt) < -0.5:
            raise ValueError("a leg may not reverse the one before it")
        line_end = end - d * cut
        prims.append(("line", start, d, float(np.linalg.norm(line_end - start))))
        if cut:
            left = np.array([-d[1], d[0]])
            turn = 1.0 if float(left @ nxt) > 0 else -1.0
            centre = line_end + left * turn * r
            a0 = np.arctan2(*(line_end - centre)[::-1])
            prims.append(("arc", centre, r, a0, turn * np.pi / 2))
            start = end + nxt * cut
        else:
            start = end
    return prims


def sample(prims, n: int, step: float):
    """(positions (n, 2), headings (n,), road driven (n,)) every ``step``."""
    lengths = [p[3] if p[0] == "line" else abs(p[4]) * p[2] for p in prims]
    cum = np.concatenate([[0.0], np.cumsum(lengths)])
    s = np.arange(n) * step
    if s[-1] > cum[-1]:
        raise ValueError(f"the route's {cum[-1]:.0f} m hold fewer than {n} keyframes")
    pos, hd = np.zeros((n, 2)), np.zeros(n)
    which = np.minimum(np.searchsorted(cum, s, side="right") - 1, len(prims) - 1)
    for k, (i, sk) in enumerate(zip(which, s)):
        p, u = prims[i], sk - cum[i]
        if p[0] == "line":
            pos[k] = p[1] + p[2] * u
            hd[k] = np.arctan2(p[2][1], p[2][0])
        else:
            _, c, r, a0, sweep = p
            a = a0 + np.sign(sweep) * u / r
            pos[k] = c + r * np.array([np.cos(a), np.sin(a)])
            hd[k] = a + np.sign(sweep) * np.pi / 2
    return pos, hd, s


def street_edges(m: dict) -> np.ndarray:
    """(E, 2, 2) unit grid edges driven, each once (as lattice corners)."""
    node = np.zeros(2, np.int64)
    edges = set()
    for d, n in m["legs"]:
        step = np.asarray(DIRS[d], np.int64)
        for _ in range(int(n)):
            a, b = tuple(node), tuple(node + step)
            edges.add((min(a, b), max(a, b)))
            node = node + step
    return np.asarray(sorted(edges), np.float64)


def camera_poses(pos: np.ndarray, hd: np.ndarray, height: float) -> np.ndarray:
    """(n, 4, 4) world-to-camera poses: z forward along the heading, x to the
    right, y down; the world's z is up."""
    n = pos.shape[0]
    z = np.stack([np.cos(hd), np.sin(hd), np.zeros(n)], -1)
    x = np.stack([np.sin(hd), -np.cos(hd), np.zeros(n)], -1)
    y = np.broadcast_to([0.0, 0.0, -1.0], (n, 3))
    R_wc = np.stack([x, y, z], -1)
    C = np.concatenate([pos, np.full((n, 1), height)], -1)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R_wc.transpose(0, 2, 1)
    T[:, :3, 3] = -np.einsum("nji,nj->ni", R_wc, C)
    return T


def revisits(pos, hd, step: float, gap_m: float):
    """Each keyframe's match: the nearest keyframe at least ``gap_m`` of
    road earlier within 0.75 steps and 30 degrees of heading, or -1; and the
    revisits as (first, last) keyframe runs."""
    n = pos.shape[0]
    gap = int(np.ceil(gap_m / step))
    match = np.full(n, -1, np.int64)
    for k in range(gap, n):
        d = np.linalg.norm(pos[:k - gap + 1] - pos[k], axis=-1)
        dh = np.abs(np.angle(np.exp(1j * (hd[:k - gap + 1] - hd[k]))))
        d = np.where(dh < np.deg2rad(30.0), d, np.inf)
        j = int(np.argmin(d))
        if d[j] < 0.75 * step:
            match[k] = j
    runs, k = [], 0
    while k < n:
        if match[k] >= 0:
            a = k
            while k + 1 < n and match[k + 1] >= 0:
                k += 1
            runs.append((a, k))
        k += 1
    return match, runs


def drift(pos3: np.ndarray, s: np.ndarray, first: int, full: int, scale: float,
          yaw_deg: float):
    """Each keyframe's Sim3 from the true world to the map's, (n,) scales,
    (n, 3, 3) rotations and (n, 3) translations: the identity up to
    ``first``, then each step scaled and turned by the drift at its start,
    the drift growing linearly with the road to (scale, yaw) at ``full``."""
    n = pos3.shape[0]
    f = np.clip((s - s[first]) / (s[full] - s[first]), 0.0, 1.0)
    f[:first] = 0.0
    sc = 1.0 + (scale - 1.0) * f
    R = np.stack([_rz(np.deg2rad(yaw_deg) * fk) for fk in f])
    P = pos3.copy()
    for k in range(first, n - 1):
        P[k + 1] = P[k] + sc[k] * R[k] @ (pos3[k + 1] - pos3[k])
    t = P - sc[:, None] * np.einsum("nij,nj->ni", R, pos3)
    return sc, R, t


def drifted_poses(T_true: np.ndarray, sc, R, t) -> np.ndarray:
    """Poses in the drifted map: the camera centre moved by the keyframe's
    drift, its axes turned with it (SE3, the scale in the translation)."""
    Rc, tc = T_true[:, :3, :3], T_true[:, :3, 3]
    Rd = Rc @ R.transpose(0, 2, 1)
    out = np.tile(np.eye(4), (T_true.shape[0], 1, 1))
    out[:, :3, :3] = Rd
    out[:, :3, 3] = sc[:, None] * tc - np.einsum("nij,nj->ni", Rd, t)
    return out


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 words that hold their bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def flipped(desc: torch.Tensor, n_max: int, gen) -> torch.Tensor:
    """(M, 8) int32 descriptors, each with 0..n_max random bits flipped
    (two draws of one bit flip it back)."""
    out = torch.empty_like(desc)
    dev = desc.device
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    for a in range(0, desc.shape[0], FLIP_CHUNK):
        d = desc[a:a + FLIP_CHUNK]
        M = d.shape[0]
        n = torch.randint(0, n_max + 1, (M,), generator=gen, device=dev)
        pos = torch.randint(0, 256, (M, max(n_max, 1)), generator=gen, device=dev)
        act = (torch.arange(pos.shape[1], device=dev)[None] < n[:, None]).to(torch.int32)
        cnt = torch.zeros((M, 256), dtype=torch.int32, device=dev).scatter_add_(1, pos, act)
        bits = (cnt % 2).view(M, 8, 32).to(torch.int64)
        out[a:a + FLIP_CHUNK] = d ^ wrap32((bits << shifts).sum(-1))
    return out


@torch.no_grad()
def build(m: dict, camera: dict, extractor: dict, n_kfs: int, n_mps: int, n_feat: int,
          seed: int, device) -> StreetScene:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    f64 = torch.float64

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f64)

    # ---- the route, its revisits and the drift (host geometry)
    step = m["kf_step_m"]
    pos, hd, s = sample(path(m), n_kfs, step)
    match, runs = revisits(pos, hd, step, m["revisit_gap_m"])
    if len(runs) != 3 or runs[-1][1] != n_kfs - 1:
        raise ValueError(f"the route's revisits {runs} are not two closed loops and a last "
                         "revisit that ends the drive")
    first, full = runs[1][1] + 1, runs[2][0]
    if n_kfs - full < m["min_final_kfs"]:
        raise ValueError(f"the last revisit holds {n_kfs - full} keyframes, under "
                         f"{m['min_final_kfs']}")
    pos3 = np.concatenate([pos, np.full((n_kfs, 1), m["camera_height_m"])], -1)
    T_true = camera_poses(pos, hd, m["camera_height_m"])
    sc, Rd, td = drift(pos3, s, first, full, m["drift_scale"], m["drift_yaw_deg"])
    # the map's poses as drifted
    T_map = torch.from_numpy(drifted_poses(T_true, sc, Rd, td)).to(dev)
    C = -torch.einsum("nij,ni->nj", T_map[:, :3, :3], T_map[:, :3, 3])
    loop_edge = np.full(n_kfs, -1, np.int64)
    for a, _ in runs[:2]:
        cur = a + 2
        loop_edge[cur], loop_edge[match[cur]] = match[cur], cur

    # ---- facade points on every street driven, with their descriptors
    edges = street_edges(m)
    E = edges.shape[0]
    per = np.full(E, n_mps // E)
    per[:n_mps % E] += 1
    e_of = torch.from_numpy(np.repeat(np.arange(E), per)).to(dev)
    a_pt = torch.from_numpy(edges[:, 0] * m["block_m"]).to(dev)[e_of]
    b_pt = torch.from_numpy(edges[:, 1] * m["block_m"]).to(dev)[e_of]
    along = (b_pt - a_pt) / torch.linalg.norm(b_pt - a_pt, dim=-1, keepdim=True)
    side = torch.stack([-along[:, 1], along[:, 0]], -1)
    lo, hi = m["facade_offset_m"]
    sign = torch.where(rand(n_mps) < 0.5, -1.0, 1.0).to(f64)
    off = (lo + (hi - lo) * rand(n_mps)) * sign
    ground = a_pt + (b_pt - a_pt) * rand(n_mps)[:, None] + side * off[:, None]
    h0, h1 = m["facade_height_m"]
    pts = torch.cat([ground, (h0 + (h1 - h0) * rand(n_mps))[:, None]], -1)     # (P, 3)
    # a facade is in sight from its own street only: across (x for a
    # street running north, y for one running east) the camera stands
    # within sight_corridor_m of the street's centre line
    across = (along[:, 0].abs() >= 0.5).long()      # the coordinate across: 0 x, 1 y
    line = a_pt.gather(1, across[:, None])[:, 0]
    cam_xy = torch.from_numpy(pos).to(dev)
    words = torch.randint(0, 1 << 32, (n_mps, 8), generator=gen, device=dev,
                          dtype=torch.int64)
    pt_desc = wrap32(words)

    # ---- every (keyframe, point) pair in view, on the true poses
    Tt = torch.from_numpy(T_true).to(dev)
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    w, h, bd = camera["width"], camera["height"], m["border_px"]
    z0, z1 = m["depth_m"]
    ks, ps = [], []
    for a in range(0, n_kfs, CHUNK_KFS):
        T = Tt[a:a + CHUNK_KFS]
        pc = torch.einsum("kij,lj->kli", T[:, :3, :3], pts) + T[:, None, :3, 3]
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        cam_across = cam_xy[a:a + CHUNK_KFS][:, across]               # (k, P)
        vis = ((pc[..., 2] >= z0) & (pc[..., 2] <= z1) & (u >= bd) & (u < w - bd)
               & ((cam_across - line).abs() < m["sight_corridor_m"])
               & (v >= bd) & (v < h - bd))
        k, p = torch.nonzero(vis, as_tuple=True)
        ks.append(k + a)
        ps.append(p)
    k_vis, p_vis = torch.cat(ks), torch.cat(ps)

    # ---- visits: a point's run of observers with gaps under revisit_gap_m.
    # Before the drift every visit sees the point's one landmark (the
    # closed loops fused theirs); each visit that starts in the drifted
    # stretch sees a landmark of its own, made when it began
    gap = int(np.ceil(m["revisit_gap_m"] / step))
    order = torch.argsort(p_vis * n_kfs + k_vis)
    ko, po = k_vis[order], p_vis[order]
    new = torch.ones_like(ko, dtype=torch.bool)
    new[1:] = (po[1:] != po[:-1]) | (ko[1:] - ko[:-1] > gap)
    idx = torch.arange(ko.shape[0], device=dev)
    start_at = torch.cummax(torch.where(new, idx, 0), 0)[0]
    first_of_point = torch.cummax(torch.where(torch.cat([new[:1], po[1:] != po[:-1]]), idx, 0),
                                  0)[0]
    ordinal = torch.cumsum(new.long(), 0) - torch.cumsum(new.long(), 0)[first_of_point]
    copy = torch.where(ko[start_at] >= first, torch.clamp_max(ordinal, COPIES - 1), 0)
    key = torch.empty_like(ko)
    key[order] = po * COPIES + copy                                   # landmark key per pair
    has = torch.zeros(COPIES * n_mps, dtype=torch.bool, device=dev)
    has[key] = True
    copies = has.view(n_mps, COPIES).sum(1)
    # the points kept: a random order's prefix whose landmarks fit
    perm = torch.randperm(n_mps, generator=gen, device=dev)
    fits = torch.cumsum(copies[perm], 0) <= n_mps
    kept = torch.zeros(n_mps, dtype=torch.bool, device=dev)
    kept[perm[fits]] = True
    lm_of_key = torch.cumsum((has & kept.repeat_interleave(COPIES)).long(), 0) - 1

    # ---- each keyframe's observations: up to n_obs of its pairs, at random
    n_obs = min(int(extractor["n_features"]), n_feat)
    sel = kept[p_vis]
    k_s, p_s, key_s = k_vis[sel], p_vis[sel], key[sel]
    r = torch.argsort(rand(k_s.shape[0]))
    r = r[torch.argsort(k_s[r], stable=True)]
    k_s, p_s, key_s = k_s[r], p_s[r], key_s[r]
    rank = torch.arange(k_s.shape[0], device=dev) - torch.searchsorted(k_s, k_s)
    take = rank < n_obs
    k_o, p_o, slot_o = k_s[take], p_s[take], rank[take]
    lm_o = lm_of_key[key_s[take]]
    pc = torch.einsum("oij,oj->oi", Tt[k_o, :3, :3], pts[p_o]) + Tt[k_o, :3, 3]
    uv = torch.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
    uv = uv + m["obs_noise_px"] * randn(*uv.shape)
    xy = torch.zeros((n_kfs, n_feat, 2), dtype=torch.float32, device=dev)
    xy[k_o, slot_o] = uv.float()
    mp_idx = torch.full((n_kfs, n_feat), -1, dtype=torch.int32, device=dev)
    mp_idx[k_o, slot_o] = lm_o.int()
    desc = torch.zeros((n_kfs, n_feat, 8), dtype=torch.int32, device=dev)
    desc[k_o, slot_o] = flipped(pt_desc[p_o], m["desc_flip_max"], gen)

    # ---- landmarks: placed by their first observer's drift
    nm_used = int(lm_of_key[-1]) + 1
    ref = torch.full((n_mps,), n_kfs, dtype=torch.int64, device=dev)
    ref.scatter_reduce_(0, lm_o, k_o, reduce="amin")
    valid = ref < n_kfs
    ref_c = torch.clamp_max(ref, n_kfs - 1)
    pt_of = torch.zeros(n_mps, dtype=torch.int64, device=dev)
    keys_used = torch.nonzero(has & kept.repeat_interleave(COPIES))[:, 0]
    pt_of[:nm_used] = keys_used // COPIES
    sc_t, R_t, t_t = (torch.from_numpy(x).to(dev) for x in (sc, Rd, td))
    X = (sc_t[ref_c, None] * torch.einsum("lij,lj->li", R_t[ref_c], pts[pt_of])
         + t_t[ref_c])
    v = X - C[ref_c]
    dist = torch.linalg.norm(v, dim=-1)
    # the map's frame: the street's turned so that the vertical lies along
    # (1, 1, 1)/sqrt(3), as the server map's scene is, so that each of
    # Motion Check's per-plane tests sees the drive's turns
    Q = torch.from_numpy(_tilt()).to(dev)
    Qh = torch.eye(4, dtype=f64, device=dev)
    Qh[:3, :3] = Q.T
    X, v = X @ Q.T, v @ Q.T
    T_map, Tt = T_map @ Qh, Tt @ Qh
    Xw = torch.where(valid[:, None], X, 0.0).float()
    mp_desc = torch.where(valid[:, None], flipped(pt_desc[pt_of], m["desc_flip_max"], gen), 0)
    normal = torch.where(valid[:, None], v / torch.clamp_min(dist, 1e-9)[:, None], 0.0).float()
    t_s = torch.from_numpy(s / m["speed_mps"]).float().to(dev)
    route = {"pos": pos, "heading": hd, "revisits": runs, "drift_first": first,
             "final_first": full, "drift_scale": sc}
    return StreetScene(
        Tcw=T_map.float(), Tcw_true=Tt,
        kf_id=torch.arange(n_kfs, dtype=torch.int32, device=dev), timestamp=t_s, xy=xy,
        desc=desc, mp_idx=mp_idx, loop_edge=torch.from_numpy(loop_edge).int().to(dev), Xw=Xw,
        mp_desc=mp_desc, normal=normal, dist_ref=torch.where(valid, dist, 0.0).float(),
        ref_kf=torch.where(valid, ref, -1).int(), mp_valid=valid, route=route)
