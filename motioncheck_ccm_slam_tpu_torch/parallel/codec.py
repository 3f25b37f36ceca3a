"""Binary codec for MapMsg — the wire schema of the transport layer.

A copy of ``motioncheck_ccm_slam_tpu/parallel/codec.py`` over the port's
``parallel/comm`` messages, whose payloads are numpy as the JAX package's:
the same message gives the same bytes in both packages, so an agent of one
and a server of the other talk over one socket.

The JAX codec replaces the reference's ROS message (de)serialization of
cslam_msgs/msg/{Map,KF,KFred,MP,MPred}.msg with a compact little-endian
binary layout over numpy buffers, framed + CRC'd by the native wire runtime
(native/wire.cpp). Deterministic and version-tagged so multi-host deployments
can evolve the schema.
"""
from __future__ import annotations

import io
import struct

import numpy as np

from ..utils import native
from . import comm as comm_mod

VERSION = 3   # v3: KfMsg carries the mTcpar parent-relative fallback


def _w_arr(buf: io.BytesIO, arr: np.ndarray, dtype):
    a = np.ascontiguousarray(arr, dtype=dtype)
    buf.write(struct.pack("<I", a.size))
    buf.write(a.tobytes())


def _r_arr(mv: memoryview, off: int, dtype, shape=None):
    (n,) = struct.unpack_from("<I", mv, off)
    off += 4
    itemsize = np.dtype(dtype).itemsize
    a = np.frombuffer(mv, dtype=dtype, count=n, offset=off).copy()
    off += n * itemsize
    if shape is not None:
        a = a.reshape(shape)
    return a, off


def encode(msg: comm_mod.MapMsg) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<IiIIII", VERSION, msg.sender_client_id,
                          len(msg.keyframes), len(msg.keyframes_red),
                          len(msg.map_points), len(msg.map_points_red)))
    buf.write(struct.pack("<qqqB", msg.weak_ack_kf, msg.weak_ack_mp,
                          msg.closest_kf_id, int(msg.agent_done)))
    _w_arr(buf, np.asarray(msg.acks_kf, np.int64), np.int64)
    _w_arr(buf, np.asarray(msg.acks_mp, np.int64), np.int64)
    for k in msg.keyframes:
        buf.write(struct.pack("<iidii", k.kf_id, k.client_id, k.timestamp,
                              k.pred_id, k.parent_id))
        _w_arr(buf, k.Tcp, np.float32)
        buf.write(struct.pack("<B", int(k.Tcpar is not None)))
        if k.Tcpar is not None:
            _w_arr(buf, k.Tcpar, np.float32)
        _w_arr(buf, k.xy, np.float32)
        _w_arr(buf, k.angle, np.float32)
        _w_arr(buf, k.octave, np.int32)
        _w_arr(buf, k.desc, np.uint32)
        _w_arr(buf, k.feat_valid, np.uint8)
        _w_arr(buf, k.mp_ids, np.int64)
    for r in msg.keyframes_red:
        buf.write(struct.pack("<iii", r.kf_id, r.client_id, r.pred_id))
        _w_arr(buf, r.Tcp, np.float32)
    for p in msg.map_points:
        buf.write(struct.pack("<iiiff", p.mp_id, p.client_id, p.ref_kf_id,
                              p.min_dist, p.max_dist))
        _w_arr(buf, p.pos_ref, np.float32)
        _w_arr(buf, p.desc, np.uint32)
        _w_arr(buf, p.normal, np.float32)
    for q in msg.map_points_red:
        buf.write(struct.pack("<iii", q.mp_id, q.client_id, q.ref_kf_id))
        _w_arr(buf, q.pos_ref, np.float32)
    return buf.getvalue()


def decode(payload: bytes) -> comm_mod.MapMsg:
    mv = memoryview(payload)
    off = 0
    version, sender, n_kf, n_kfr, n_mp, n_mpr = struct.unpack_from(
        "<IiIIII", mv, off
    )
    off += struct.calcsize("<IiIIII")
    if version != VERSION:
        raise ValueError(f"codec version mismatch: {version}")
    wak, wam, closest, done = struct.unpack_from("<qqqB", mv, off)
    off += struct.calcsize("<qqqB")
    acks_kf, off = _r_arr(mv, off, np.int64)
    acks_mp, off = _r_arr(mv, off, np.int64)
    msg = comm_mod.MapMsg(
        sender_client_id=sender, weak_ack_kf=wak, weak_ack_mp=wam,
        closest_kf_id=closest, agent_done=bool(done),
        acks_kf=[int(x) for x in acks_kf],
        acks_mp=[int(x) for x in acks_mp],
    )
    for _ in range(n_kf):
        kf_id, cid, ts, pred, parent = struct.unpack_from("<iidii", mv, off)
        off += struct.calcsize("<iidii")
        Tcp, off = _r_arr(mv, off, np.float32, (4, 4))
        (has_par,) = struct.unpack_from("<B", mv, off)
        off += 1
        Tcpar = None
        if has_par:
            Tcpar, off = _r_arr(mv, off, np.float32, (4, 4))
        xy, off = _r_arr(mv, off, np.float32)
        xy = xy.reshape(-1, 2)
        angle, off = _r_arr(mv, off, np.float32)
        octave, off = _r_arr(mv, off, np.int32)
        desc, off = _r_arr(mv, off, np.uint32)
        desc = desc.reshape(-1, 8)
        feat_valid, off = _r_arr(mv, off, np.uint8)
        mp_ids, off = _r_arr(mv, off, np.int64)
        msg.keyframes.append(comm_mod.KfMsg(
            kf_id=kf_id, client_id=cid, timestamp=ts, Tcp=Tcp,
            pred_id=pred, parent_id=parent, xy=xy, angle=angle,
            octave=octave, desc=desc, feat_valid=feat_valid.astype(bool),
            mp_ids=mp_ids, Tcpar=Tcpar,
        ))
    for _ in range(n_kfr):
        kf_id, cid, pred = struct.unpack_from("<iii", mv, off)
        off += struct.calcsize("<iii")
        Tcp, off = _r_arr(mv, off, np.float32, (4, 4))
        msg.keyframes_red.append(comm_mod.KfRedMsg(
            kf_id=kf_id, client_id=cid, Tcp=Tcp, pred_id=pred
        ))
    for _ in range(n_mp):
        mp_id, cid, ref, mind, maxd = struct.unpack_from("<iiiff", mv, off)
        off += struct.calcsize("<iiiff")
        pos_ref, off = _r_arr(mv, off, np.float32)
        desc, off = _r_arr(mv, off, np.uint32)
        normal, off = _r_arr(mv, off, np.float32)
        msg.map_points.append(comm_mod.MpMsg(
            mp_id=mp_id, client_id=cid, pos_ref=pos_ref, ref_kf_id=ref,
            desc=desc, normal=normal, min_dist=mind, max_dist=maxd,
        ))
    for _ in range(n_mpr):
        mp_id, cid, ref = struct.unpack_from("<iii", mv, off)
        off += struct.calcsize("<iii")
        pos_ref, off = _r_arr(mv, off, np.float32)
        msg.map_points_red.append(comm_mod.MpRedMsg(
            mp_id=mp_id, client_id=cid, pos_ref=pos_ref, ref_kf_id=ref
        ))
    return msg


def encode_framed(msg: comm_mod.MapMsg) -> bytes:
    """Codec + native length/CRC framing — the on-wire bytes."""
    return native.frame(encode(msg))


def decode_framed(data: bytes) -> comm_mod.MapMsg:
    hdr = native.parse_header(data)
    if hdr is None:
        raise ValueError("short frame")
    n, crc = hdr
    payload = data[native.HEADER_SIZE: native.HEADER_SIZE + n]
    if not native.check(payload, crc):
        raise ValueError("frame CRC mismatch")
    return decode(payload)
