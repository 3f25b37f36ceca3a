"""State across the numpy boundary: numpy <-> torch on a given device.

Descriptors are (N, 8) uint32 words in numpy (and in the JAX package) and
the same bits viewed as int32 in the port; integer index fields widen to
int64 in the port where they index tensors. Any object with the right
field names (a JAX ``MPBlock``/``OrbFeatures`` included) converts from
numpy; ``*_to_numpy`` returns the port's NamedTuple holding numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.map_state import MPBlock
from .ops.orb import OrbFeatures
from .solvers.ba_core import BAObservations


def desc_from_numpy(desc, device) -> torch.Tensor:
    """(N, 8) uint32 -> (N, 8) int32 tensor of the same bits."""
    a = np.ascontiguousarray(np.asarray(desc), dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 tensor -> (N, 8) uint32 of the same bits."""
    return desc.detach().cpu().to(torch.int32).numpy().view(np.uint32)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def pose_from_numpy(T, device) -> torch.Tensor:
    """(..., 4, 4) pose -> float32 tensor on ``device``."""
    return _tensor(T, torch.float32, device)


def pose_to_numpy(T: torch.Tensor) -> np.ndarray:
    return T.detach().cpu().numpy().astype(np.float32)


_MP_DTYPES = dict(
    mp_id=torch.int32, client_id=torch.int32, unique_id=torch.int32,
    Xw=torch.float32, normal=torch.float32, min_dist=torch.float32,
    max_dist=torch.float32, ref_kf=torch.int32, first_kf_id=torch.int32,
    n_visible=torch.int32, n_found=torch.int32, valid=torch.bool,
)


def mp_block_from_numpy(mp, device) -> MPBlock:
    fields = {k: _tensor(getattr(mp, k), dt, device) for k, dt in _MP_DTYPES.items()}
    return MPBlock(desc=desc_from_numpy(mp.desc, device), **fields)


def mp_block_to_numpy(mp: MPBlock) -> MPBlock:
    return MPBlock(**{
        k: desc_to_numpy(v) if k == "desc" else v.detach().cpu().numpy()
        for k, v in mp._asdict().items()
    })


def orb_features_from_numpy(feats, device) -> OrbFeatures:
    return OrbFeatures(
        xy=_tensor(feats.xy, torch.float32, device),
        response=_tensor(feats.response, torch.float32, device),
        angle=_tensor(feats.angle, torch.float32, device),
        octave=_tensor(feats.octave, torch.int64, device),
        desc=desc_from_numpy(feats.desc, device),
        valid=_tensor(feats.valid, torch.bool, device),
    )


def ba_observations_from_numpy(obs, device) -> BAObservations:
    """A JAX ``BAObservations`` (or any object with its fields) -> the
    port's, index fields widened to int64."""
    return BAObservations(
        cam_idx=_tensor(obs.cam_idx, torch.int64, device),
        lm_idx=_tensor(obs.lm_idx, torch.int64, device),
        uv=_tensor(obs.uv, torch.float32, device),
        inv_sigma2=_tensor(obs.inv_sigma2, torch.float32, device),
        valid=_tensor(obs.valid, torch.bool, device),
    )


def gba_state_from_numpy(Tcw, Xw, K, fixed_cam, fixed_lm, device):
    """The GBA state (Tcw (C, 4, 4), Xw (L, 3), K (3, 3), fixed_cam (C,),
    fixed_lm (L,)) as tensors on ``device``."""
    return (_tensor(Tcw, torch.float32, device), _tensor(Xw, torch.float32, device),
            _tensor(K, torch.float32, device), _tensor(fixed_cam, torch.bool, device),
            _tensor(fixed_lm, torch.bool, device))


def orb_features_to_numpy(feats: OrbFeatures) -> OrbFeatures:
    return OrbFeatures(
        xy=feats.xy.detach().cpu().numpy(),
        response=feats.response.detach().cpu().numpy(),
        angle=feats.angle.detach().cpu().numpy(),
        octave=feats.octave.detach().cpu().numpy().astype(np.int32),
        desc=desc_to_numpy(feats.desc),
        valid=feats.valid.detach().cpu().numpy(),
    )
