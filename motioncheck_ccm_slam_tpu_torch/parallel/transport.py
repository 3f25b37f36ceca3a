"""TCP transport: agents and server as separate processes/hosts.

A copy of ``motioncheck_ccm_slam_tpu/parallel/transport.py`` over the
port's codec, whose frames are byte-identical to the JAX package's, so the
two packages' endpoints interoperate. One change: the server's endpoint
drops what it sends to an agent that has hung up, instead of raising.

The JAX transport replaces the reference's ROS pub/sub network layer
(TCPROS) for true multi-process deployment: the server listens, each agent
connects; MapMsg payloads travel as native-framed (length + CRC) codec
buffers. The resulting objects implement the same duplex interface as
``comm.Channel``, so ``ClientComm`` / ``ServerComm`` work unchanged over DCN.
"""
from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Dict, Optional

from ..utils import native
from . import codec
from .comm import MapMsg

_HELLO_FMT = "<I"  # client id announcement


def _send_frame(sock: socket.socket, msg: MapMsg):
    data = codec.encode_framed(msg)
    sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Optional[MapMsg]:
    hdr = _recv_exact(sock, native.HEADER_SIZE)
    if hdr is None:
        return None
    parsed = native.parse_header(hdr)
    if parsed is None:
        return None
    n, crc = parsed
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    if not native.check(payload, crc):
        raise ValueError("frame CRC mismatch")
    return codec.decode(payload)


class ClientTransport:
    """Agent-side channel endpoint (duplex, Channel-compatible subset)."""

    def __init__(self, host: str, port: int, client_id: int,
                 timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.settimeout(None)
        self.sock.sendall(struct.pack(_HELLO_FMT, client_id))
        self._inbox: "queue.Queue[MapMsg]" = queue.Queue()
        self._alive = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self):
        try:
            while self._alive:
                msg = _recv_frame(self.sock)
                if msg is None:
                    break
                self._inbox.put(msg)
        except OSError:
            pass

    # Channel-compatible client interface
    def client_send(self, msg: MapMsg):
        _send_frame(self.sock, msg)

    def client_recv(self) -> Optional[MapMsg]:
        try:
            return self._inbox.get_nowait()
        except queue.Empty:
            return None

    def close(self):
        self._alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class ServerTransport:
    """Server-side listener producing one Channel-compatible endpoint per
    connected agent."""

    class _AgentEndpoint:
        def __init__(self, sock):
            self.sock = sock
            self.inbox: "queue.Queue[MapMsg]" = queue.Queue()
            self.hung_up = False

        # Channel-compatible server interface
        def server_send(self, msg: MapMsg):
            """Send to the agent; once the agent has hung up (it closes its
            socket after its goodbye, while the server goes on ticking its
            handler until every agent is done) the message is dropped: the
            JAX transport raises BrokenPipeError there, and the server
            process dies with the other agents' maps unfinished."""
            if self.hung_up:
                return
            try:
                _send_frame(self.sock, msg)
            except (BrokenPipeError, ConnectionResetError):
                self.hung_up = True

        def server_recv(self) -> Optional[MapMsg]:
            try:
                return self.inbox.get_nowait()
            except queue.Empty:
                return None

        def pending_to_server(self) -> bool:
            return not self.inbox.empty()

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen(8)
        self.port = self.listener.getsockname()[1]
        self.endpoints: Dict[int, "ServerTransport._AgentEndpoint"] = {}
        self._alive = True
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._acceptor.start()

    def _accept_loop(self):
        while self._alive:
            try:
                sock, _ = self.listener.accept()
            except OSError:
                break
            hello = _recv_exact(sock, struct.calcsize(_HELLO_FMT))
            if hello is None:
                sock.close()
                continue
            (client_id,) = struct.unpack(_HELLO_FMT, hello)
            ep = ServerTransport._AgentEndpoint(sock)
            self.endpoints[client_id] = ep
            threading.Thread(
                target=self._read_loop, args=(ep,), daemon=True
            ).start()

    def _read_loop(self, ep: "_AgentEndpoint"):
        try:
            while self._alive:
                msg = _recv_frame(ep.sock)
                if msg is None:
                    break
                ep.inbox.put(msg)
        except OSError:
            pass

    def wait_for(self, client_id: int, timeout_s: float = 10.0):
        import time

        t0 = time.monotonic()
        while client_id not in self.endpoints:
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"agent {client_id} never connected")
            time.sleep(0.01)
        return self.endpoints[client_id]

    def close(self):
        self._alive = False
        try:
            self.listener.close()
        except OSError:
            pass
        for ep in self.endpoints.values():
            try:
                ep.sock.close()
            except OSError:
                pass
