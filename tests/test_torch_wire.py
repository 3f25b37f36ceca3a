"""Port parity: utils/native.py, parallel/codec.py and parallel/transport.py
against the JAX package.

- The native wire runtime: ``crc32``, ``frame``, ``parse_header`` (short
  buffer, bad magic) and ``check`` equal the JAX package's and ``zlib`` on
  seeded payloads, the empty one included. The port builds
  ``native/wire.cpp`` under ``build/torch_kernels/`` and never writes the
  tracked ``native/libwire.so``.
- The codec: ``encode`` gives the JAX codec's bytes for the same message
  (``tests/test_transport.make_msg`` at F=16, its layout at F=1024, with
  and without ``Tcpar`` and ``agent_done``), and each side decodes the
  other's bytes.
- TCP: a port client and a port server round-trip; a JAX ``ClientTransport``
  talks to a port ``ServerTransport`` and the reverse; a corrupted frame
  raises the CRC error; the server's endpoint drops what it sends to an
  agent that has hung up; the agent-done flag arms FINALBA on the port's
  ``ServerComm`` (test_transport's last case).
"""
import ctypes
import hashlib
import os
import shutil
import socket
import time
import zlib

import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.parallel import codec as jcodec, comm as jcomm
from motioncheck_ccm_slam_tpu.parallel import transport as jtransport
from motioncheck_ccm_slam_tpu.utils import native as jnative
from motioncheck_ccm_slam_tpu_torch import config as tconfig
from motioncheck_ccm_slam_tpu_torch.models import map_state as tms
from motioncheck_ccm_slam_tpu_torch.parallel import codec as tcodec, comm as tcomm
from motioncheck_ccm_slam_tpu_torch.parallel import transport as ttransport
from motioncheck_ccm_slam_tpu_torch.system.server import ServerClientHandler
from motioncheck_ccm_slam_tpu_torch.utils import native as tnative

from test_transport import make_msg
import torch_one_thread  # noqa: F401 (torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBWIRE = os.path.join(ROOT, "native", "libwire.so")


def payloads():
    rng = np.random.default_rng(0)
    return [b"", b"\x00", b"the quick brown fox" * 100] + [
        rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1, 7, 4096, 100_003)]


@pytest.mark.parametrize("i", range(7))
def test_native_matches_jax_and_zlib(i):
    data = payloads()[i]
    crc = zlib.crc32(data) & 0xFFFFFFFF
    assert tnative.crc32(data) == jnative.crc32(data) == crc
    framed = tnative.frame(data)
    assert framed == jnative.frame(data)
    assert framed[tnative.HEADER_SIZE:] == data
    assert tnative.parse_header(framed) == jnative.parse_header(framed) == (len(data), crc)
    assert tnative.check(data, crc) and jnative.check(data, crc)
    assert not tnative.check(data, crc ^ 1) and not jnative.check(data, crc ^ 1)


def test_parse_header_short_buffer_and_bad_magic():
    assert (tnative.MAGIC, tnative.HEADER_SIZE) == (jnative.MAGIC, jnative.HEADER_SIZE)
    framed = tnative.frame(b"payload")
    for n in range(tnative.HEADER_SIZE):
        assert tnative.parse_header(framed[:n]) is None
        assert jnative.parse_header(framed[:n]) is None
    bad = b"XXXX" + framed[4:]
    for mod in (tnative, jnative):
        with pytest.raises(ValueError, match="magic"):
            mod.parse_header(bad)


def _stamp(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest(), os.stat(path).st_mtime_ns


def test_wire_library_builds_under_build_and_leaves_libwire_untouched(tmp_path, monkeypatch):
    """The port compiles native/wire.cpp into build/torch_kernels/ under a
    name hashed from the source and the flags, and never writes the
    tracked libwire.so beside the source: a fresh build from a copy of
    native/ keeps the copy's libwire.so bytes and mtime. The repo's own
    libwire.so is held unchanged across the port's build too, unless it is
    older than wire.cpp: the JAX package's native.get_lib rebuilds it then
    (in any test process), which is not the port's doing."""
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "torch_kernels")
    assert os.path.basename(path).startswith("libmcs_wire_")
    jax_rebuilds = os.path.getmtime(LIBWIRE) < os.path.getmtime(tnative.SOURCE)
    before = _stamp(LIBWIRE)
    tnative.get_lib()
    assert os.path.exists(path)
    if not jax_rebuilds:
        assert _stamp(LIBWIRE) == before
    # a fresh build from a copy of native/ (wire.cpp the newer file)
    native_copy = tmp_path / "native"
    native_copy.mkdir()
    shutil.copy2(LIBWIRE, native_copy / "libwire.so")
    time.sleep(0.01)
    shutil.copy(tnative.SOURCE, native_copy / "wire.cpp")
    copy_before = _stamp(native_copy / "libwire.so")
    monkeypatch.setattr(tnative, "SOURCE", str(native_copy / "wire.cpp"))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    built = tnative.build()
    assert os.path.dirname(built) == str(tmp_path / "build") and os.path.exists(built)
    assert os.path.basename(built) == os.path.basename(path)   # same source, same name
    lib = ctypes.CDLL(built)
    lib.wire_crc32.restype = ctypes.c_uint32
    lib.wire_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    assert lib.wire_crc32(b"abc", 3) == zlib.crc32(b"abc")
    assert not [n for n in os.listdir(tmp_path / "build") if n.endswith(".tmp")]
    assert _stamp(native_copy / "libwire.so") == copy_before


def test_wire_build_raises_with_compiler_errors(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises with g++'s stderr."""
    src = tmp_path / "broken.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(tnative, "SOURCE", str(src))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken"):
        tnative.build()


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def make_jax_msg(n_feat: int, tcpar: bool, done: bool, seed: int = 0):
    """tests/test_transport.make_msg at F=16; its layout at another F."""
    if n_feat == 16:
        msg = make_msg(seed=seed)
    else:
        rng = np.random.default_rng(seed)
        msg = jcomm.MapMsg(sender_client_id=1, weak_ack_kf=7, weak_ack_mp=42,
                           acks_kf=[1, 2, 3], acks_mp=[9])
        for i in range(2):
            msg.keyframes.append(jcomm.KfMsg(
                kf_id=10 + i, client_id=1, timestamp=1.5 + i,
                Tcp=rng.normal(size=(4, 4)).astype(np.float32), pred_id=9 + i, parent_id=8,
                xy=rng.uniform(0, 700, (n_feat, 2)).astype(np.float32),
                angle=rng.uniform(-3, 3, n_feat).astype(np.float32),
                octave=rng.integers(0, 8, n_feat).astype(np.int32),
                desc=rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32),
                feat_valid=rng.random(n_feat) > 0.3,
                mp_ids=rng.integers(-1, 100, n_feat).astype(np.int64)))
            msg.keyframes_red.append(jcomm.KfRedMsg(
                kf_id=i, client_id=1, Tcp=rng.normal(size=(4, 4)).astype(np.float32),
                pred_id=i - 1))
        for i in range(3):
            msg.map_points.append(jcomm.MpMsg(
                mp_id=100 + i, client_id=1, pos_ref=rng.normal(size=3).astype(np.float32),
                ref_kf_id=10, desc=rng.integers(0, 2**32, 8, dtype=np.uint32),
                normal=rng.normal(size=3).astype(np.float32), min_dist=0.5, max_dist=5.0))
            msg.map_points_red.append(jcomm.MpRedMsg(
                mp_id=i, client_id=1, pos_ref=rng.normal(size=3).astype(np.float32),
                ref_kf_id=3))
    rng = np.random.default_rng(seed + 100)
    if tcpar:
        for k in msg.keyframes[::2]:          # one keyframe with, one without
            k.Tcpar = rng.normal(size=(4, 4)).astype(np.float32)
    msg.agent_done = done
    msg.closest_kf_id = 5
    return msg


def to_port(msg: jcomm.MapMsg) -> tcomm.MapMsg:
    """The same message as the port's dataclasses (field by field)."""
    return tcomm.MapMsg(
        sender_client_id=msg.sender_client_id,
        keyframes=[tcomm.KfMsg(**vars(k)) for k in msg.keyframes],
        keyframes_red=[tcomm.KfRedMsg(**vars(k)) for k in msg.keyframes_red],
        map_points=[tcomm.MpMsg(**vars(p)) for p in msg.map_points],
        map_points_red=[tcomm.MpRedMsg(**vars(p)) for p in msg.map_points_red],
        acks_kf=list(msg.acks_kf), acks_mp=list(msg.acks_mp), weak_ack_kf=msg.weak_ack_kf,
        weak_ack_mp=msg.weak_ack_mp, closest_kf_id=msg.closest_kf_id,
        agent_done=msg.agent_done)


def assert_same_msg(a, b):
    """Every field equal, arrays bitwise with their dtypes."""
    def fields(m):
        return {k: v for k, v in vars(m).items()
                if k not in ("keyframes", "keyframes_red", "map_points", "map_points_red")}

    assert fields(a) == fields(b)
    for name in ("keyframes", "keyframes_red", "map_points", "map_points_red"):
        la, lb = getattr(a, name), getattr(b, name)
        assert len(la) == len(lb), name
        for ea, eb in zip(la, lb):
            va, vb = vars(ea), vars(eb)
            assert va.keys() == vb.keys()
            for k in va:
                if isinstance(va[k], np.ndarray) or isinstance(vb[k], np.ndarray):
                    assert (va[k] is None) == (vb[k] is None), (name, k)
                    assert va[k].dtype == vb[k].dtype and va[k].shape == vb[k].shape, (name, k)
                    np.testing.assert_array_equal(va[k], vb[k], err_msg=f"{name}.{k}")
                else:
                    assert va[k] == vb[k], (name, k)


@pytest.mark.parametrize("n_feat", [16, 1024])
@pytest.mark.parametrize("tcpar", [False, True])
@pytest.mark.parametrize("done", [False, True])
def test_codec_bytes_identical_and_cross_decode(n_feat, tcpar, done):
    jmsg = make_jax_msg(n_feat, tcpar, done)
    tmsg = to_port(jmsg)
    jbytes = jcodec.encode(jmsg)
    tbytes = tcodec.encode(tmsg)
    assert tcodec.VERSION == jcodec.VERSION == 3
    assert tbytes == jbytes
    assert tcodec.encode_framed(tmsg) == jcodec.encode_framed(jmsg)
    from_jax = tcodec.decode(jbytes)
    assert isinstance(from_jax, tcomm.MapMsg)
    assert_same_msg(from_jax, jcodec.decode(jbytes))
    assert tcodec.encode(from_jax) == jbytes
    from_port = jcodec.decode(tbytes)
    assert isinstance(from_port, jcomm.MapMsg)
    assert_same_msg(from_port, tcodec.decode(tbytes))
    assert_same_msg(tcodec.decode_framed(jcodec.encode_framed(jmsg)), from_jax)
    assert from_jax.agent_done is done
    assert [k.Tcpar is not None for k in from_jax.keyframes] == \
        [tcpar and i % 2 == 0 for i in range(len(jmsg.keyframes))]


def test_codec_rejects_a_corrupted_frame_and_another_version():
    framed = bytearray(tcodec.encode_framed(to_port(make_msg(seed=1))))
    framed[tnative.HEADER_SIZE + 5] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        tcodec.decode_framed(bytes(framed))
    payload = bytearray(tcodec.encode(to_port(make_msg(seed=1))))
    payload[0] = 2
    with pytest.raises(ValueError, match="version"):
        tcodec.decode(bytes(payload))


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------

def _poll(fn, timeout_s: float = 5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        out = fn()
        if out is not None:
            return out
        time.sleep(0.01)
    return None


@pytest.mark.parametrize("pair", ["port-port", "jax-client-port-server", "port-client-jax-server"])
def test_tcp_roundtrip_across_packages(pair):
    server_mod = jtransport if pair == "port-client-jax-server" else ttransport
    client_mod = jtransport if pair == "jax-client-port-server" else ttransport
    server = server_mod.ServerTransport(host="127.0.0.1")
    client = client_mod.ClientTransport("127.0.0.1", server.port, client_id=3)
    try:
        ep = server.wait_for(3)
        up = make_jax_msg(1024, True, False, seed=2)
        client.client_send(up if client_mod is jtransport else to_port(up))
        got = _poll(ep.server_recv)
        assert got is not None
        assert_same_msg(got, jcodec.decode(jcodec.encode(up)) if server_mod is jtransport
                        else tcodec.decode(jcodec.encode(up)))
        assert not ep.pending_to_server()
        down = make_jax_msg(16, False, True, seed=3)
        ep.server_send(down if server_mod is jtransport else to_port(down))
        got2 = _poll(client.client_recv)
        assert got2 is not None
        assert (client_mod is jtransport) == isinstance(got2, jcomm.MapMsg)
        assert client_mod.codec.encode(got2) == jcodec.encode(down)
        assert got2.agent_done is True
    finally:
        client.close()
        server.close()


def test_tcp_corrupted_frame_raises_crc_error():
    a, b = socket.socketpair()
    try:
        framed = bytearray(tcodec.encode_framed(to_port(make_msg(seed=4))))
        framed[-3] ^= 0x10
        a.sendall(bytes(framed))
        with pytest.raises(ValueError, match="CRC"):
            ttransport._recv_frame(b)
        a.sendall(tcodec.encode_framed(to_port(make_msg(seed=4))))
        assert_same_msg(ttransport._recv_frame(b), to_port(make_msg(seed=4)))
        a.close()
        assert ttransport._recv_frame(b) is None       # the peer hung up
    finally:
        b.close()


def test_server_send_to_a_hung_up_agent_is_dropped():
    """An agent closes its socket after its goodbye while the server still
    ticks its handler: the replies are dropped, not raised."""
    server = ttransport.ServerTransport(host="127.0.0.1")
    client = ttransport.ClientTransport("127.0.0.1", server.port, client_id=0)
    try:
        ep = server.wait_for(0)
        client.client_send(tcomm.MapMsg(sender_client_id=0, agent_done=True))
        assert _poll(ep.server_recv).agent_done is True
        client.close()
        for _ in range(50):                  # the first sends may still be buffered
            ep.server_send(tcomm.MapMsg(sender_client_id=-1, acks_kf=[1]))
            if ep.hung_up:
                break
            time.sleep(0.02)
        assert ep.hung_up
        ep.server_send(tcomm.MapMsg(sender_client_id=-1))
    finally:
        server.close()


def test_agent_done_roundtrip_and_finalba_arming():
    """The end-of-stream flag survives the wire and arms FINALBA on the
    port's ServerComm at once (test_transport's last case)."""
    out = tcodec.decode(tcodec.encode(tcomm.MapMsg(sender_client_id=0, agent_done=True)))
    assert out.agent_done is True
    assert tcodec.decode(tcodec.encode(to_port(make_msg()))).agent_done is False
    cfg = tconfig.Config()
    ch = tcomm.Channel()
    h = ServerClientHandler(config=cfg, client_id=0,
                            map=tms.MapState.create(cfg, server=False, device="cpu"), channel=ch)
    assert h.map.device == torch.device("cpu")
    assert not h.comm.agent_finished
    client = tcomm.ClientComm(config=cfg, channel=ch, client_id=0)
    client.send_goodbye()
    h.comm.tick()
    assert h.comm.agent_said_done
    assert h.comm.agent_finished
