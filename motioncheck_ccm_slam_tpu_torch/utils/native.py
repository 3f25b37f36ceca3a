"""Native wire runtime: length + CRC32 framing over ctypes.

Counterpart of ``motioncheck_ccm_slam_tpu/utils/native.py``, with the same
C interface (``native/wire.cpp``), ``MAGIC`` and ``HEADER_SIZE``. The
source builds at first use, never at import, with ``g++ -O3 -shared
-fPIC`` into ``build/torch_kernels/``, under a name made of a hash of the
source and the flags; the compiler writes a file of its own process and
``os.replace`` moves it into place, so several processes may build at
once. The tracked ``native/libwire.so`` is never written. There is no
fallback: if the compiler fails, the first use raises with its stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from ..ops.cuda_build import BUILD_DIR

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "wire.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

MAGIC = 0x4D435357
HEADER_SIZE = 12

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Path of the built wire library for the current source and flags."""
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmcs_wire_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``native/wire.cpp`` unless already built; returns the
    library's path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.wire_crc32.restype = ctypes.c_uint32
            lib.wire_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.wire_frame.restype = ctypes.c_uint64
            lib.wire_frame.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.wire_parse_header.restype = ctypes.c_int64
            lib.wire_parse_header.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                              ctypes.POINTER(ctypes.c_uint32)]
            lib.wire_check.restype = ctypes.c_int32
            lib.wire_check.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
            _lib = lib
        return _lib


def crc32(payload: bytes) -> int:
    return get_lib().wire_crc32(payload, len(payload))


def frame(payload: bytes) -> bytes:
    """Length+CRC framed message."""
    out = ctypes.create_string_buffer(len(payload) + HEADER_SIZE)
    n = get_lib().wire_frame(out, payload, len(payload))
    return out.raw[:n]


def parse_header(buf: bytes):
    """-> (payload_len, crc), None on a short buffer; raises ValueError on
    bad magic."""
    if len(buf) < HEADER_SIZE:
        return None
    crc = ctypes.c_uint32(0)
    n = get_lib().wire_parse_header(buf, len(buf), ctypes.byref(crc))
    if n == -1:
        raise ValueError("bad frame magic")
    if n == -2:
        return None
    return int(n), crc.value


def check(payload: bytes, crc: int) -> bool:
    return bool(get_lib().wire_check(payload, len(payload), crc))
