"""Tile-stream GBA kernels K3-K9 as CUDA C++ for Hopper.

Counterpart of ``motioncheck_ccm_slam_tpu/ops/schur_pallas.py``. The
kernels live in ``csrc/schur.cu`` (plain C interface), are built with
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at first use and
loaded with ``ctypes``.

Observations lie in landmark-aligned tiles (``build_schur_plan``): tile t
holds the padded slots of landmarks [128t, 128t+128), ``TP`` slots a tile,
``OP = ntl * TP`` slots in all. Per-slot streams are (rows, OP) or (OP,)
tensors; landmark-side arrays are (rows, L_pad); camera-side arrays are
(C, rows), unpacked (the Pallas kernels' 128-lane camera groups, one-hot
gathers and bf16 splits are TPU layout and are not carried over).

- ``d1_assemble`` (K3): one linearisation pass: the W stream, per-slot
  rho / inlier / chi2, per-landmark Hll + bl, per-camera Hcc + bc.
- ``s_apply`` (K4): the fused PCG product sum W Hll^-1 W^T v per camera.
- ``d2_precond`` (K5): per-camera upper triangle of sum W Hll^-1 W^T.
- ``apply_a_raw`` (K6): u = Hll^-1 sum W^T v[cam] per landmark.
- ``apply_b_raw`` (K7): per-camera sum of W u[lm].
- ``d0_cost`` (K8): the robust cost of a state, one scalar (K3's per-slot
  projection and Huber cost, reduced).
- ``expand_sorted_streams`` (K9): per slot the camera's R and t and the
  landmark's X, the matrix-free GBA's landmark-side streams.
- ``apply_a``, ``apply_b``, ``schur_apply``: the plan-form wrappers of the
  matrix-free GBA; they take a ``SchurPlan`` on the device and launch K6's
  and K7's kernels (``schur_apply``: K6 then K7).

Each wrapper has a plain torch version beside it (``*_ref``: per-slot
tensor arithmetic plus ``index_add_``). A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. ``launches`` on each
wrapper counts kernel launches (never plain-version calls). Camera-side
sums (K3, K4, K5, K7) are taken by shared-memory atomics in no fixed order
into a camera table in each block, whose rows a finishing pass adds in
block order (``camera_reduction_geometry`` sizes these launches), so
kernel and plain version agree to f32 rounding of sums, not bitwise.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda_build
from ..solvers.ba_core import CHI2_MONO, HUBER_DELTA

LM_BLOCK = 128          # landmarks per tile
PAIRS6 = [(i, j) for i in range(6) for j in range(i, 6)]   # Hcc upper triangle
IU6 = np.array([p[0] for p in PAIRS6])
JU6 = np.array([p[1] for p in PAIRS6])
D1_CAM_ROWS = len(PAIRS6) + 6      # 21 Hcc + 6 bc
D2_CAM_ROWS = len(PAIRS6)          # 21 S66

SOURCE = os.path.join(cuda_build.CSRC_DIR, "schur.cu")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class SchurPlan(NamedTuple):
    """Host-built static plan of the landmark-aligned tile stream.

    ``perm`` maps tile slots to positions in the landmark-sorted
    observation stream; pad slots map to O (one past the end). Pad slots
    have camera 0 and tile-local landmark 0.
    """

    ntl: int                # number of landmark tiles (L_pad / 128)
    TP: int                 # padded slots per tile, a multiple of 128
    L_pad: int              # L rounded up to a multiple of 128
    perm: np.ndarray        # (ntl*TP,) i64 into the sorted stream (pad -> O)
    camid: np.ndarray       # (ntl*TP,) i32, pad -> 0
    lmloc: np.ndarray       # (ntl*TP,) i32 tile-local landmark id, pad -> 0

    def to(self, device) -> "SchurPlan":
        """The plan with its index arrays as tensors on ``device`` (perm
        i64, camid and lmloc i32): the form the plan-form wrappers take."""
        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        return self._replace(perm=t(self.perm, torch.int64), camid=t(self.camid, torch.int32),
                             lmloc=t(self.lmloc, torch.int32))


def build_schur_plan(lm_sorted, cam_sorted, L: int, valid_sorted=None,
                     lpad_multiple: int = 1) -> SchurPlan:
    """Numpy copy of the JAX package's plan builder.

    lm_sorted: (O,) landmark id per sorted-stream position (nondecreasing);
    cam_sorted: (O,) camera id per sorted position; valid_sorted: optional
    (O,) bool: invalid observations are left out of the plan (their weights
    are zero). ``lpad_multiple``: L_pad is a multiple of LM_BLOCK *
    lpad_multiple, so that the tiles split into that many equal contiguous
    ranges (one a shard); with 1 the plan is the one-device plan. The
    kernels loop over a tile's slots, so no tile width is too wide and the
    plan always exists.
    """
    lm_sorted = np.asarray(lm_sorted, np.int64)
    cam_sorted = np.asarray(cam_sorted, np.int64)
    O = lm_sorted.shape[0]
    if valid_sorted is not None:
        keep = np.flatnonzero(np.asarray(valid_sorted, bool))
    else:
        keep = np.arange(O, dtype=np.int64)
    lm_k = lm_sorted[keep]
    cam_k = cam_sorted[keep]
    L_pad = _round_up(max(L, 1), LM_BLOCK * max(lpad_multiple, 1))
    ntl = L_pad // LM_BLOCK
    counts = np.bincount(lm_k, minlength=L_pad)
    bounds = np.zeros(L_pad + 1, np.int64)
    bounds[1:] = np.cumsum(counts)
    tile_counts = bounds[LM_BLOCK::LM_BLOCK] - bounds[:-LM_BLOCK:LM_BLOCK]
    TP = int(_round_up(max(int(tile_counts.max()) if ntl else 1, 1), 128))
    perm = np.full((ntl, TP), O, np.int64)
    camid = np.zeros((ntl, TP), np.int32)
    lmloc = np.zeros((ntl, TP), np.int32)
    for t in range(ntl):
        s, e = bounds[t * LM_BLOCK], bounds[(t + 1) * LM_BLOCK]
        n = e - s
        perm[t, :n] = keep[s:e]
        camid[t, :n] = cam_k[s:e]
        lmloc[t, :n] = lm_k[s:e] - t * LM_BLOCK
    return SchurPlan(ntl=ntl, TP=TP, L_pad=L_pad,
                     perm=perm.reshape(-1), camid=camid.reshape(-1),
                     lmloc=lmloc.reshape(-1))


def sym6_from_tri(tri: torch.Tensor) -> torch.Tensor:
    """(C, 21) upper-triangle rows in PAIRS6 order -> (C, 6, 6) symmetric."""
    C = tri.shape[0]
    H = torch.zeros((C, 6, 6), dtype=tri.dtype, device=tri.device)
    H[:, IU6, JU6] = tri
    H[:, JU6, IU6] = tri
    return H


# ---------------------------------------------------------------------------
# Build, load, argument checks
# ---------------------------------------------------------------------------

def library_path() -> str:
    return cuda_build.library_path(SOURCE)


def build() -> str:
    """Compile csrc/schur.cu with nvcc unless already built; returns the
    compiler's output (ptxas report), or "" if it was already there."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(SOURCE, {
        "mcs_d1_assemble": [p] * 9 + [i, i] + [p] * 4 + [i] * 4 + [p, p],
        "mcs_s_apply": [p] * 5 + [i, i, p] + [i] * 8 + [p, p],
        "mcs_s_apply_active_clusters": [i, i],
        "mcs_d2_precond": [p] * 4 + [i, i, p] + [i] * 4 + [p, p],
        "mcs_apply_a": [p] * 5 + [i, i, p, p],
        "mcs_apply_b": [p] * 4 + [i, i, p] + [i] * 4 + [p, p],
        "mcs_d0_cost": [p] * 8 + [i, i, p, p, p],
        "mcs_expand_streams": [p] * 4 + [i, i, p, p],
    })


def _check(t, name: str, dtype, shape, device: Optional[torch.device] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_vector_aligned(name: str, pose, uv) -> None:
    """The pose table is read by 16-byte loads and uv by 8-byte loads."""
    if pose.data_ptr() % 16 or uv.data_ptr() % 8:
        raise ValueError(f"{name}: pose must be 16-byte and uv 8-byte aligned (vector loads)")


def _check_ids(camid, lmloc, TP: int) -> int:
    """Checks the slot ids; returns ntl."""
    if not isinstance(camid, torch.Tensor) or camid.dim() != 1:
        raise ValueError("camid: expected a 1-D (OP,) tensor")
    OP = camid.shape[0]
    if TP <= 0 or OP == 0 or OP % TP or TP % 128:
        raise ValueError(f"OP={OP} must be a positive multiple of TP={TP}, "
                         "itself a multiple of 128")
    _check(camid, "camid", torch.int32, (OP,))
    _check(lmloc, "lmloc", torch.int32, (OP,), camid.device)
    return OP // TP


def _check_plan(plan) -> int:
    """Checks a plan's device index arrays; returns ntl."""
    if not isinstance(plan.camid, torch.Tensor):
        raise TypeError("plan: expected index tensors (SchurPlan.to(device))")
    ntl = _check_ids(plan.camid, plan.lmloc, plan.TP)
    if ntl != plan.ntl or plan.L_pad != ntl * LM_BLOCK:
        raise ValueError(f"plan: {ntl} tiles of {plan.TP} slots do not match "
                         f"ntl={plan.ntl}, L_pad={plan.L_pad}")
    return ntl


def _slot_lm(lmloc: torch.Tensor, TP: int) -> torch.Tensor:
    """(OP,) global landmark id of each slot."""
    tiles = torch.arange(lmloc.shape[0], device=lmloc.device) // TP
    return tiles * LM_BLOCK + lmloc.long()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K3: one linearisation pass
# ---------------------------------------------------------------------------

def _project_ref(camid, lmloc, uv, is2, valid, kp, pose, X, TP: int):
    """Plain torch version of the per-slot stage K3 and K8 share: p_c =
    R X + t, the depth guard, the residual, chi2, the Huber weight and the
    robust cost. Returns a dict of (OP,) rows plus R (OP, 3, 3)."""
    cam = camid.long()
    T = pose[cam]                                    # (OP, 12)
    R = T[:, :9].reshape(-1, 3, 3)
    Xs = X[_slot_lm(lmloc, TP)]
    pc = (R * Xs[:, None, :]).sum(-1) + T[:, 9:]     # (OP, 3)
    pc0, pc1, pc2 = pc.unbind(1)
    fx, fy, cx, cy = kp.unbind(0)
    front = pc2 > 1e-6
    iz = 1.0 / torch.where(front, pc2, torch.ones_like(pc2))
    rx = uv[:, 0] - (fx * pc0 * iz + cx)
    ry = uv[:, 1] - (fy * pc1 * iz + cy)
    chi2 = (rx * rx + ry * ry) * is2
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    d = HUBER_DELTA
    core = e <= d
    hw = torch.where(core, torch.ones_like(e), d / e)
    return dict(R=R, pc0=pc0, pc1=pc1, pc2=pc2, front=front, iz=iz, rx=rx, ry=ry,
                chi2=chi2, w=is2 * hw * valid * front.float(),
                rho=torch.where(core, chi2, 2.0 * d * e - d * d) * valid)


def d1_assemble_ref(camid, lmloc, uv, is2, valid, free, kp, pose, X, *, TP: int):
    """Plain torch version of K3 (the arithmetic of the Pallas kernel's
    ``_project`` and ``_d1_kernel``, slot by slot)."""
    OP = camid.shape[0]
    L_pad = OP // TP * LM_BLOCK
    C = pose.shape[0]
    cam = camid.long()
    lm = _slot_lm(lmloc, TP)
    p = _project_ref(camid, lmloc, uv, is2, valid, kp, pose, X, TP)
    R, pc0, pc1, pc2, iz = p["R"], p["pc0"], p["pc1"], p["pc2"], p["iz"]
    rx, ry, chi2, w, rho = p["rx"], p["ry"], p["chi2"], p["w"], p["rho"]
    fx, fy = kp[0], kp[1]
    inlier = valid * p["front"].float() * (chi2 <= CHI2_MONO).float()
    a00, a02 = fx * iz, -fx * pc0 * iz * iz
    a11, a12 = fy * iz, -fy * pc1 * iz * iz
    zero = torch.zeros_like(a00)
    Jc0 = torch.stack([-(a02 * pc1), -(a00 * pc2 - a02 * pc0), a00 * pc1,
                       -a00, zero, -a02])                       # (6, OP)
    Jc1 = torch.stack([a11 * pc2 - a12 * pc1, a12 * pc0, -a11 * pc0,
                       zero, -a11, -a12])
    Rt = R.permute(1, 2, 0)                                     # (3, 3, OP)
    Jl0 = -(a00 * Rt[0] + a02 * Rt[2])                          # (3, OP)
    Jl1 = -(a11 * Rt[1] + a12 * Rt[2])
    wf = w * free
    W18 = (wf * (Jc0[None] * Jl0[:, None] + Jc1[None] * Jl1[:, None])).reshape(18, OP)
    aux = torch.stack([rho, inlier, chi2])
    lm9 = w * (Jl0[:, None] * Jl0[None] + Jl1[:, None] * Jl1[None])   # (3, 3, OP)
    bl = -w * (Jl0 * rx + Jl1 * ry)
    lm_rows = torch.cat([lm9.reshape(9, OP), bl])               # (12, OP)
    hllbl = torch.zeros((L_pad, 12), dtype=X.dtype, device=X.device)
    hllbl.index_add_(0, lm, lm_rows.T)
    iu = torch.as_tensor(IU6, device=X.device)
    ju = torch.as_tensor(JU6, device=X.device)
    hcc = w * (Jc0[iu] * Jc0[ju] + Jc1[iu] * Jc1[ju])            # (21, OP)
    bc = -w * (Jc0 * rx + Jc1 * ry)                             # (6, OP)
    cam27 = torch.zeros((C, D1_CAM_ROWS), dtype=X.dtype, device=X.device)
    cam27.index_add_(0, cam, torch.cat([hcc, bc]).T)
    return W18.contiguous(), aux, hllbl.T.contiguous(), cam27


def d1_assemble(camid, lmloc, uv, is2, valid, free, kp, pose, X, *, TP: int):
    """K3: one fused linearisation pass over the tile stream. A persistent
    grid keeps each tile whole in one block, its landmark sums in shared
    memory, and adds the camera sums into a camera table in each block's
    shared memory (no global atomic per slot).

    camid, lmloc (OP,) i32; uv (OP, 2); is2, valid, free (OP,) f32 (valid
    and free are 0/1); kp (4,) = fx, fy, cx, cy; pose (C, 12) = R row-major
    then t per camera; X (L_pad, 3). Returns W18 (18, OP) in J-major rows
    (row j*6+i = W[i, j], masked by free), aux (3, OP) = rho / inlier /
    chi2, hllbl (12, L_pad) = 9 Hll rows (j*3+k) + 3 bl rows, cam27 (C, 27)
    = 21 Hcc upper-triangle rows (PAIRS6) + 6 bc rows.
    """
    ntl = _check_ids(camid, lmloc, TP)
    OP, L_pad, dev = camid.shape[0], ntl * LM_BLOCK, camid.device
    f32 = torch.float32
    _check(uv, "uv", f32, (OP, 2), dev)
    for name, t in (("is2", is2), ("valid", valid), ("free", free)):
        _check(t, name, f32, (OP,), dev)
    _check(kp, "kp", f32, (4,), dev)
    if not isinstance(pose, torch.Tensor) or pose.dim() != 2:
        raise ValueError("pose: expected a (C, 12) tensor")
    C = pose.shape[0]
    _check(pose, "pose", f32, (C, 12), dev)
    _check(X, "X", f32, (L_pad, 3), dev)
    if dev.type == "cpu":
        return d1_assemble_ref(camid, lmloc, uv, is2, valid, free, kp, pose, X, TP=TP)
    _check_vector_aligned("d1_assemble", pose, uv)
    lib = _library()
    geo = launch_geometry("d1_assemble", C, TP, ntl, dev)
    with torch.cuda.device(dev):
        W18 = torch.empty((18, OP), dtype=f32, device=dev)
        aux = torch.empty((3, OP), dtype=f32, device=dev)
        hllbl = torch.empty((12, L_pad), dtype=f32, device=dev)
        cam27 = torch.empty((C, D1_CAM_ROWS), dtype=f32, device=dev)
        partial = torch.empty((geo.grid, C, D1_CAM_ROWS), dtype=f32, device=dev)
        err = lib.mcs_d1_assemble(
            camid.data_ptr(), lmloc.data_ptr(), uv.data_ptr(), is2.data_ptr(),
            valid.data_ptr(), free.data_ptr(), kp.data_ptr(), pose.data_ptr(),
            X.data_ptr(), ntl, TP, W18.data_ptr(), aux.data_ptr(),
            hllbl.data_ptr(), cam27.data_ptr(), C, geo.grid, geo.cam_range,
            geo.shared_bytes, partial.data_ptr(), _stream())
    cuda_build.check_launch(err, "d1_assemble")
    d1_assemble.launches += 1
    return W18, aux, hllbl, cam27


d1_assemble.launches = 0


# ---------------------------------------------------------------------------
# The camera reduction of K3, K4, K5 and K7: launch geometry
# ---------------------------------------------------------------------------

SHARED_BYTES_MAX = 232_448      # dynamic shared memory a block may have (sm_90)
MAX_CLUSTER = 8                 # the portable thread-block cluster size
CAM_ROW_BYTES = 24              # a camera's 6 f32 sums in K4's and K7's tables
# a camera's row in each kernel's table: K3's 27 and K5's 21 f32 sums
ROW_BYTES = {"s_apply": CAM_ROW_BYTES, "apply_b": CAM_ROW_BYTES,
             "d1_assemble": 4 * D1_CAM_ROWS, "d2_precond": 4 * D2_CAM_ROWS}
D1_FIXED_BYTES = 2 * 9 * LM_BLOCK * 4           # K3's two (9, 128) landmark tables
STAGE_SLOT_BYTES = 80           # a slot staged by K4: 18 W floats, camid, lmloc
STAGE_TILE_BYTES = 9 * LM_BLOCK * 4             # and its tile's H9
K4_FIXED_BYTES = 9 * LM_BLOCK * 4 + 8           # K4's two u_part, u_s, its mbarrier
K4_TABLE_BYTES_MAX = SHARED_BYTES_MAX // 2      # the rest is left to staging


class CameraReduction(NamedTuple):
    """Launch geometry of K3 (``d1_assemble``), K4 (``s_apply``), K5
    (``d2_precond``) or K7 (``apply_b``) in csrc/schur.cu. Block (x, y) of
    the grid takes the work ``work_range(x)`` (tiles for K3 and K4, slots
    for K5 and K7) and the cameras ``cameras(y)``; K4's cluster rank r
    takes the slots ``slots(r)`` of each of its tiles and stages the first
    ``staged`` of them; with ``v_shared`` each K4 block keeps v (C, 6) in
    shared memory."""

    kernel: str
    work: int               # K3, K4: tiles (ntl); K5, K7: slots (OP)
    TP: int
    C: int
    grid: int               # blocks along x: rows of the (grid, C, k) partial sums
    cluster: int            # blocks a cluster (K4; 1 for the others)
    cam_range: int          # cameras in one block's table
    share: int              # K4: slots of a tile each cluster rank takes
    staged: int             # K4: of those, how many it keeps in shared memory
    v_shared: bool          # K4: v in shared memory (else gathered from L2)
    shared_bytes: int       # dynamic shared memory a block

    @property
    def row_bytes(self) -> int:
        """Bytes of a camera's row in the kernel's table."""
        return ROW_BYTES[self.kernel]

    @property
    def ranges(self) -> int:
        """Blocks along y: camera ranges."""
        return -(-self.C // self.cam_range)

    def work_range(self, x: int) -> range:
        """Tiles (K3, K4) or slots (K5, K7) of block x, as the kernel
        computes them."""
        parts, p = self.grid // self.cluster, x // self.cluster
        return range(self.work * p // parts, self.work * (p + 1) // parts)

    def cameras(self, y: int) -> range:
        return range(y * self.cam_range, min(self.C, (y + 1) * self.cam_range))

    def slots(self, rank: int) -> range:
        """Tile-local slots of K4's cluster rank ``rank``."""
        k0 = min(rank * self.share, self.TP)
        return range(k0, min(k0 + self.share, self.TP))


def _cam_range(C: int, table_bytes_max: int, row_bytes: int = CAM_ROW_BYTES) -> int:
    """Cameras a table holds: C, or C split evenly into the fewest ranges
    whose tables, row_bytes a camera, fit ``table_bytes_max``."""
    ranges = -(-C // (table_bytes_max // row_bytes))
    return -(-C // ranges)


def _k4_staging(TP: int, room: int, v_bytes: int):
    """(cluster, share, staged, v_shared) of K4 for tiles of TP slots, with
    ``room`` bytes of shared memory left beside the camera table and v_bytes
    for v: the smallest cluster whose share fits, with v in shared memory
    where it fits too (gathering v from L2 costs more than a smaller
    cluster saves), else without; else 8 blocks staging what fits."""
    shares = [_round_up(-(-TP // k), 32) for k in range(1, MAX_CLUSTER + 1)]
    for v_shared in (True, False):
        left = room - (v_bytes if v_shared else 0)
        for k, share in enumerate(shares, 1):
            if share * STAGE_SLOT_BYTES + STAGE_TILE_BYTES <= left:
                return k, share, share, v_shared
    staged = (room - STAGE_TILE_BYTES) // STAGE_SLOT_BYTES // 32 * 32
    return MAX_CLUSTER, shares[-1], staged, False


@functools.lru_cache(maxsize=256)
def camera_reduction_geometry(kernel: str, C: int, TP: int, ntl: int, n_sm: int,
                              max_clusters: Optional[int] = None) -> CameraReduction:
    """The launch geometry of ``kernel`` ("d1_assemble" for K3, "s_apply"
    for K4, "d2_precond" for K5, "apply_b" for K7) on C cameras and ntl
    tiles of TP slots, on a card of n_sm SMs.

    K5 and K7: one block an SM (split between the camera ranges), each
    over an even share of the OP slots (a block may get none); the camera
    table may fill the block's whole shared memory. K3: likewise, over an
    even share of the tiles (no block without one), the table beside K3's
    two landmark tables. None of the four has static shared memory, so
    ``shared_bytes`` is all a block takes. K4: the camera table takes at
    most half the block's shared memory; the cluster size, the staging and
    whether v is kept in shared memory come from ``_k4_staging``; clusters
    take even shares of the tiles, as many as the card holds at once
    (``max_clusters``, by default one block an SM).
    """
    if C <= 0 or TP <= 0 or ntl <= 0 or n_sm <= 0:
        raise ValueError(f"no geometry for C={C}, TP={TP}, ntl={ntl}, n_sm={n_sm}")
    if kernel not in ROW_BYTES:
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel != "s_apply":
        k3, row = kernel == "d1_assemble", ROW_BYTES[kernel]
        fixed = D1_FIXED_BYTES if k3 else 0
        cam_range = _cam_range(C, SHARED_BYTES_MAX - fixed, row)
        grid = max(1, n_sm // -(-C // cam_range))
        return CameraReduction(kernel, ntl if k3 else ntl * TP, TP, C,
                               min(grid, ntl) if k3 else grid, 1, cam_range, 0, 0, False,
                               fixed + cam_range * row)
    cam_range = _cam_range(C, K4_TABLE_BYTES_MAX)
    ranges = -(-C // cam_range)
    table = cam_range * CAM_ROW_BYTES
    v_bytes = C * CAM_ROW_BYTES
    k, share, staged, v_shared = _k4_staging(
        TP, SHARED_BYTES_MAX - K4_FIXED_BYTES - table, v_bytes)
    clusters = n_sm // k if max_clusters is None else max_clusters
    grid = k * max(1, min(ntl, clusters // ranges))
    return CameraReduction(kernel, ntl, TP, C, grid, k, cam_range, share, staged, v_shared,
                           K4_FIXED_BYTES + table + v_shared * v_bytes
                           + staged * STAGE_SLOT_BYTES + STAGE_TILE_BYTES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_geometry(kernel: str, C: int, TP: int, ntl: int, dev) -> CameraReduction:
    """``camera_reduction_geometry`` on the card of CUDA device ``dev``;
    K4's clusters capped at what the card holds at once."""
    n_sm = _sm_count(dev.index or 0)
    geo = camera_reduction_geometry(kernel, C, TP, ntl, n_sm)
    if kernel == "s_apply":
        geo = camera_reduction_geometry(kernel, C, TP, ntl, n_sm,
                                        s_apply_active_clusters(geo.cluster, geo.shared_bytes))
    return geo


@functools.lru_cache(maxsize=64)
def s_apply_active_clusters(cluster: int, shared_bytes: int) -> int:
    """How many of K4's clusters of ``cluster`` blocks with ``shared_bytes``
    each the card holds at once (the CUDA occupancy query)."""
    n = _library().mcs_s_apply_active_clusters(cluster, shared_bytes)
    if n <= 0:
        raise RuntimeError(f"s_apply: no cluster of {cluster} blocks with {shared_bytes} B "
                           f"of shared memory fits the card (occupancy query: {n})")
    return n


# ---------------------------------------------------------------------------
# K6 / K7: the two halves of the Schur product; K4 fuses them
# ---------------------------------------------------------------------------

def apply_a_raw_ref(camid, lmloc, W18, v, H9, *, TP: int):
    """Plain torch version of K6: u (3, L_pad) = Hll^-1 sum_obs W^T v[cam]."""
    OP, L_pad = camid.shape[0], H9.shape[1]
    W = W18.reshape(3, 6, OP)                                   # [j, i]
    wtv = (W * v[camid.long()].T[None]).sum(1)                  # (3, OP)
    u_part = torch.zeros((L_pad, 3), dtype=v.dtype, device=v.device)
    u_part.index_add_(0, _slot_lm(lmloc, TP), wtv.T)
    H = H9.T.reshape(L_pad, 3, 3)
    return torch.einsum("lij,lj->il", H, u_part).contiguous()


def apply_b_raw_ref(camid, lmloc, W18, u, C: int, *, TP: int):
    """Plain torch version of K7: (C, 6) per-camera sums of W u[lm]."""
    OP = camid.shape[0]
    W = W18.reshape(3, 6, OP)
    ug = u[:, _slot_lm(lmloc, TP)]                              # (3, OP)
    rows6 = (W * ug[:, None]).sum(0)                            # (6, OP)
    out = torch.zeros((C, 6), dtype=u.dtype, device=u.device)
    out.index_add_(0, camid.long(), rows6.T)
    return out


def s_apply_ref(camid, lmloc, W18, v, H9, *, TP: int):
    """Plain torch version of K4: K7 after K6."""
    u = apply_a_raw_ref(camid, lmloc, W18, v, H9, TP=TP)
    return apply_b_raw_ref(camid, lmloc, W18, u, v.shape[0], TP=TP)


def _check_w(camid, lmloc, W18, TP: int):
    ntl = _check_ids(camid, lmloc, TP)
    _check(W18, "W18", torch.float32, (18, camid.shape[0]), camid.device)
    return ntl


def _check_v(v, dev):
    if not isinstance(v, torch.Tensor) or v.dim() != 2:
        raise ValueError("v: expected a (C, 6) tensor")
    _check(v, "v", torch.float32, (v.shape[0], 6), dev)
    return v.shape[0]


def _k6(camid, lmloc, W18, v, H9, ntl: int, TP: int) -> torch.Tensor:
    """Launches K6 on checked CUDA arguments: u (3, L_pad)."""
    dev = camid.device
    lib = _library()
    with torch.cuda.device(dev):
        u = torch.empty((3, ntl * LM_BLOCK), dtype=torch.float32, device=dev)
        err = lib.mcs_apply_a(camid.data_ptr(), lmloc.data_ptr(), W18.data_ptr(),
                              v.data_ptr(), H9.data_ptr(), ntl, TP, u.data_ptr(),
                              _stream())
    cuda_build.check_launch(err, "apply_a")
    return u


def _k7(camid, lmloc, W18, u, C: int, ntl: int, TP: int) -> torch.Tensor:
    """Launches K7 (and its finishing pass) on checked CUDA arguments:
    (C, 6)."""
    dev = camid.device
    lib = _library()
    geo = launch_geometry("apply_b", C, TP, ntl, dev)
    with torch.cuda.device(dev):
        out = torch.empty((C, 6), dtype=torch.float32, device=dev)
        partial = torch.empty((geo.grid, C, 6), dtype=torch.float32, device=dev)
        err = lib.mcs_apply_b(camid.data_ptr(), lmloc.data_ptr(), W18.data_ptr(),
                              u.data_ptr(), ntl, TP, out.data_ptr(), C, geo.grid,
                              geo.cam_range, geo.shared_bytes, partial.data_ptr(),
                              _stream())
    cuda_build.check_launch(err, "apply_b")
    return out


def apply_a_raw(camid, lmloc, W18, v, H9, *, TP: int):
    """K6: u (3, L_pad) = Hll^-1[l] @ sum_{obs of l} W^T v[cam], with H9
    (9, L_pad) holding Hll^-1 rows i*3+j."""
    ntl = _check_w(camid, lmloc, W18, TP)
    dev, L_pad = camid.device, ntl * LM_BLOCK
    _check_v(v, dev)
    _check(H9, "H9", torch.float32, (9, L_pad), dev)
    if dev.type == "cpu":
        return apply_a_raw_ref(camid, lmloc, W18, v, H9, TP=TP)
    u = _k6(camid, lmloc, W18, v, H9, ntl, TP)
    apply_a_raw.launches += 1
    return u


apply_a_raw.launches = 0


def apply_b_raw(camid, lmloc, W18, u, C: int, *, TP: int):
    """K7: (C, 6) per-camera sums of W u[lm], u (3, L_pad)."""
    ntl = _check_w(camid, lmloc, W18, TP)
    dev, L_pad = camid.device, ntl * LM_BLOCK
    _check(u, "u", torch.float32, (3, L_pad), dev)
    if dev.type == "cpu":
        return apply_b_raw_ref(camid, lmloc, W18, u, C, TP=TP)
    out = _k7(camid, lmloc, W18, u, C, ntl, TP)
    apply_b_raw.launches += 1
    return out


apply_b_raw.launches = 0


def s_apply(camid, lmloc, W18, v, H9, *, TP: int):
    """K4: one fused W Hll^-1 W^T v product -> (C, 6) per-camera sums. A
    cluster of blocks stages each tile's W rows and ids in shared memory, so
    each is read from device memory once (where the tile fits 8 blocks'
    shared memory), and u never leaves shared memory. The caller forms
    S v = Hcc_d v - result."""
    ntl = _check_w(camid, lmloc, W18, TP)
    dev, L_pad = camid.device, ntl * LM_BLOCK
    C = _check_v(v, dev)
    _check(H9, "H9", torch.float32, (9, L_pad), dev)
    if dev.type == "cpu":
        return s_apply_ref(camid, lmloc, W18, v, H9, TP=TP)
    for name, t in (("camid", camid), ("lmloc", lmloc), ("W18", W18), ("H9", H9)):
        if t.data_ptr() % 16:
            raise ValueError(f"s_apply: {name} must be 16-byte aligned (TMA bulk copies)")
    lib = _library()
    geo = launch_geometry("s_apply", C, TP, ntl, dev)
    with torch.cuda.device(dev):
        out = torch.empty((C, 6), dtype=torch.float32, device=dev)
        partial = torch.empty((geo.grid, C, 6), dtype=torch.float32, device=dev)
        err = lib.mcs_s_apply(camid.data_ptr(), lmloc.data_ptr(), W18.data_ptr(),
                              v.data_ptr(), H9.data_ptr(), ntl, TP, out.data_ptr(), C,
                              geo.grid, geo.cluster, geo.cam_range, geo.share,
                              geo.staged, int(geo.v_shared), geo.shared_bytes,
                              partial.data_ptr(), _stream())
    cuda_build.check_launch(err, "s_apply")
    s_apply.launches += 1
    return out


s_apply.launches = 0


# ---------------------------------------------------------------------------
# K5: the true-Schur block-Jacobi preconditioner
# ---------------------------------------------------------------------------

def d2_precond_ref(camid, lmloc, W18, H9, C: int, *, TP: int):
    """Plain torch version of K5: (C, 21) upper triangles of
    sum_obs W Hll^-1[l] W^T."""
    OP = camid.shape[0]
    Wm = W18.reshape(3, 6, OP).permute(1, 0, 2)                # [i, j] = W[i, j]
    G = H9[:, _slot_lm(lmloc, TP)].reshape(3, 3, OP)
    WG = torch.einsum("ijo,jko->iko", Wm, G)
    S = torch.einsum("iko,jko->ijo", WG, Wm)                    # (6, 6, OP)
    rows = S[torch.as_tensor(IU6, device=S.device), torch.as_tensor(JU6, device=S.device)]
    out = torch.zeros((C, D2_CAM_ROWS), dtype=W18.dtype, device=W18.device)
    out.index_add_(0, camid.long(), rows.T)
    return out


def d2_precond(camid, lmloc, W18, H9, C: int, *, TP: int):
    """K5: (C, 21) per-camera upper triangle (PAIRS6) of sum W Hll^-1 W^T,
    summed into a camera table in each block's shared memory as K7's."""
    ntl = _check_w(camid, lmloc, W18, TP)
    dev, L_pad = camid.device, ntl * LM_BLOCK
    _check(H9, "H9", torch.float32, (9, L_pad), dev)
    if dev.type == "cpu":
        return d2_precond_ref(camid, lmloc, W18, H9, C, TP=TP)
    lib = _library()
    geo = launch_geometry("d2_precond", C, TP, ntl, dev)
    with torch.cuda.device(dev):
        out = torch.empty((C, D2_CAM_ROWS), dtype=torch.float32, device=dev)
        partial = torch.empty((geo.grid, C, D2_CAM_ROWS), dtype=torch.float32, device=dev)
        err = lib.mcs_d2_precond(camid.data_ptr(), lmloc.data_ptr(), W18.data_ptr(),
                                 H9.data_ptr(), ntl, TP, out.data_ptr(), C, geo.grid,
                                 geo.cam_range, geo.shared_bytes, partial.data_ptr(),
                                 _stream())
    cuda_build.check_launch(err, "d2_precond")
    d2_precond.launches += 1
    return out


d2_precond.launches = 0


# ---------------------------------------------------------------------------
# K8: the robust cost of a state
# ---------------------------------------------------------------------------

def d0_cost_ref(camid, lmloc, uv, is2, valid, kp, pose, X, *, TP: int):
    """Plain torch version of K8: the sum of K3's per-slot robust cost."""
    return torch.sum(_project_ref(camid, lmloc, uv, is2, valid, kp, pose, X, TP)["rho"])


def d0_cost(camid, lmloc, uv, is2, valid, kp, pose, X, *, TP: int):
    """K8: the robust cost of the state (pose (C, 12), X (L_pad, 3)) over
    the tile stream, a 0-d f32 tensor. Arguments as ``d1_assemble``'s
    without ``free``. Slots with valid = 0 (pads, invalid observations) add
    nothing. The kernel sums in a fixed order (a partial a tile, added in
    tile order by a second, one-block launch), so two calls on one state
    give the same bits; it agrees with the plain version to f32 rounding of
    the sum."""
    ntl = _check_ids(camid, lmloc, TP)
    OP, L_pad, dev = camid.shape[0], ntl * LM_BLOCK, camid.device
    f32 = torch.float32
    _check(uv, "uv", f32, (OP, 2), dev)
    for name, t in (("is2", is2), ("valid", valid)):
        _check(t, name, f32, (OP,), dev)
    _check(kp, "kp", f32, (4,), dev)
    if not isinstance(pose, torch.Tensor) or pose.dim() != 2:
        raise ValueError("pose: expected a (C, 12) tensor")
    _check(pose, "pose", f32, (pose.shape[0], 12), dev)
    _check(X, "X", f32, (L_pad, 3), dev)
    if dev.type == "cpu":
        return d0_cost_ref(camid, lmloc, uv, is2, valid, kp, pose, X, TP=TP)
    _check_vector_aligned("d0_cost", pose, uv)
    lib = _library()
    with torch.cuda.device(dev):
        out = torch.empty((), dtype=f32, device=dev)
        partial = torch.empty(ntl, dtype=f32, device=dev)
        err = lib.mcs_d0_cost(camid.data_ptr(), lmloc.data_ptr(), uv.data_ptr(),
                              is2.data_ptr(), valid.data_ptr(), kp.data_ptr(),
                              pose.data_ptr(), X.data_ptr(), ntl, TP, partial.data_ptr(),
                              out.data_ptr(), _stream())
    cuda_build.check_launch(err, "d0_cost")
    d0_cost.launches += 1
    return out


d0_cost.launches = 0


# ---------------------------------------------------------------------------
# The matrix-free GBA's plan form: K9 and the plan-form Schur products
# ---------------------------------------------------------------------------

def pose_table(Tcw: torch.Tensor) -> torch.Tensor:
    """(C, 4, 4) -> (C, 12): R row-major, then t."""
    C = Tcw.shape[0]
    return torch.cat([Tcw[:, :3, :3].reshape(C, 9), Tcw[:, :3, 3]], 1).contiguous()


def _split_streams(out: torch.Tensor):
    OP = out.shape[1]
    return out[0:9].reshape(3, 3, OP), out[9:12], out[12:15]


def expand_sorted_streams_ref(plan: SchurPlan, Tcw, Xw):
    """Plain torch version of K9: two indexing gathers."""
    tab = pose_table(Tcw)[plan.camid.long()]                   # (OP, 12)
    X = Xw[_slot_lm(plan.lmloc, plan.TP)]                      # (OP, 3)
    return _split_streams(torch.cat([tab.T, X.T], 0))


def expand_sorted_streams(plan: SchurPlan, Tcw, Xw):
    """K9: (C, 4, 4) poses and (L, 3) landmarks -> the per-slot streams of
    the plan: R (3, 3, OP) row-major, t (3, OP) and X (3, OP), views of one
    (15, OP) tensor. Pad slots read camera 0 and their tile's first
    landmark (their weights are zeroed downstream). Pure data movement:
    bitwise equal to the plain version."""
    ntl = _check_plan(plan)
    dev = plan.camid.device
    if not isinstance(Tcw, torch.Tensor) or Tcw.dim() != 3:
        raise ValueError("Tcw: expected a (C, 4, 4) tensor")
    _check(Tcw, "Tcw", torch.float32, (Tcw.shape[0], 4, 4), dev)
    if not isinstance(Xw, torch.Tensor) or Xw.dim() != 2:
        raise ValueError("Xw: expected an (L, 3) tensor")
    L = Xw.shape[0]
    if not (ntl - 1) * LM_BLOCK < L <= plan.L_pad:
        raise ValueError(f"Xw: {L} landmarks do not fill the plan's {ntl} tiles")
    _check(Xw, "Xw", torch.float32, (L, 3), dev)
    if dev.type == "cpu":
        return expand_sorted_streams_ref(plan, Tcw, Xw)
    tab = pose_table(Tcw)
    lib = _library()
    with torch.cuda.device(dev):
        out = torch.empty((15, plan.camid.shape[0]), dtype=torch.float32, device=dev)
        err = lib.mcs_expand_streams(plan.camid.data_ptr(), plan.lmloc.data_ptr(),
                                     tab.data_ptr(), Xw.data_ptr(), ntl, plan.TP,
                                     out.data_ptr(), _stream())
    cuda_build.check_launch(err, "expand_sorted_streams")
    expand_sorted_streams.launches += 1
    return _split_streams(out)


expand_sorted_streams.launches = 0


def apply_a_ref(plan: SchurPlan, Wp, v, H9):
    """Plain torch version of the plan-form K6."""
    return apply_a_raw_ref(plan.camid, plan.lmloc, Wp, v, H9, TP=plan.TP)


def apply_b_ref(plan: SchurPlan, Wp, u, C: int):
    """Plain torch version of the plan-form K7."""
    return apply_b_raw_ref(plan.camid, plan.lmloc, Wp, u, C, TP=plan.TP)


def schur_apply_ref(plan: SchurPlan, Wp, v, H9):
    """Plain torch version of ``schur_apply``."""
    return apply_b_ref(plan, Wp, apply_a_ref(plan, Wp, v, H9), v.shape[0])


def _check_plan_w(plan, Wp):
    ntl = _check_plan(plan)
    _check(Wp, "Wp", torch.float32, (18, plan.camid.shape[0]), plan.camid.device)
    return ntl


def apply_a(plan: SchurPlan, Wp, v, H9):
    """K6 on a plan: u (3, L_pad) = Hll^-1 sum_obs W^T v[cam], with Wp the
    (18, OP) J-major W stream and H9 (9, L_pad) Hll^-1 rows i*3+j."""
    ntl = _check_plan_w(plan, Wp)
    dev = plan.camid.device
    _check_v(v, dev)
    _check(H9, "H9", torch.float32, (9, plan.L_pad), dev)
    if dev.type == "cpu":
        return apply_a_ref(plan, Wp, v, H9)
    u = _k6(plan.camid, plan.lmloc, Wp, v, H9, ntl, plan.TP)
    apply_a.launches += 1
    return u


apply_a.launches = 0


def apply_b(plan: SchurPlan, Wp, u, C: int):
    """K7 on a plan: (C, 6) per-camera sums of W u[lm], u (3, L_pad)."""
    ntl = _check_plan_w(plan, Wp)
    dev = plan.camid.device
    _check(u, "u", torch.float32, (3, plan.L_pad), dev)
    if dev.type == "cpu":
        return apply_b_ref(plan, Wp, u, C)
    out = _k7(plan.camid, plan.lmloc, Wp, u, C, ntl, plan.TP)
    apply_b.launches += 1
    return out


apply_b.launches = 0


def schur_apply(plan: SchurPlan, Wp, v, H9):
    """One W Hll^-1 W^T v product on a plan -> (C, 6) per-camera sums: K6
    then K7, two kernel launches counted as one. The caller forms
    S v = Hcc_d v - result."""
    ntl = _check_plan_w(plan, Wp)
    dev = plan.camid.device
    C = _check_v(v, dev)
    _check(H9, "H9", torch.float32, (9, plan.L_pad), dev)
    if dev.type == "cpu":
        return schur_apply_ref(plan, Wp, v, H9)
    u = _k6(plan.camid, plan.lmloc, Wp, v, H9, ntl, plan.TP)
    out = _k7(plan.camid, plan.lmloc, Wp, u, C, ntl, plan.TP)
    schur_apply.launches += 1
    return out


schur_apply.launches = 0
