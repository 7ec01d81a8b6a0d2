"""Trajectory I/O — the port of ``rigid_body_light_tpu/runtime/trajectory.py``.

The native writer (``csrc/traj_writer.cpp``, the port's own copy of the
JAX package's) writes frames from a background thread through a bounded
queue, so a run's ``append`` is a memcpy and the device never waits on the
disk.  It is built with the host's ``g++`` at first use into
``rigid_body_light_tpu_torch/build/`` (gitignored), named by a hash of its
source and flags and written atomically.  A failed build raises; the
synchronous Python writer (the same bytes) runs only when the caller asks
for it with ``force_python=True``.

File format (little endian), the JAX package's: a 32-byte header, magic
``RBLT`` | u32 version 1 | u32 n_bodies | u32 dtype (0 float32, 1 float64)
| 3 × u32 reserved; then per frame u64 step | f64 time | X (n, 3) | Q (n, 4)
in the dtype.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Tuple

import numpy as np

MAGIC = 0x544C4252  # "RBLT"
VERSION = 1
HEADER_BYTES = 32
_DTYPES = {0: np.float32, 1: np.float64}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "traj_writer.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libtraj_writer_{h.hexdigest()[:16]}.so")


def _load_native() -> ctypes.CDLL:
    """Build the writer (if its build is not current) and load it; raises
    if ``g++`` fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *_GXX_FLAGS, _SRC, "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"traj_writer.cpp: g++ failed "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.rblt_tw_open.restype = ctypes.c_void_p
        lib.rblt_tw_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                     ctypes.c_uint32, ctypes.c_uint32,
                                     ctypes.c_uint32]
        lib.rblt_tw_append.restype = ctypes.c_int
        lib.rblt_tw_append.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_double, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.rblt_tw_flush.argtypes = [ctypes.c_void_p]
        lib.rblt_tw_frames.restype = ctypes.c_uint64
        lib.rblt_tw_frames.argtypes = [ctypes.c_void_p]
        lib.rblt_tw_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the native writer builds and loads here."""
    try:
        _load_native()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


class TrajectoryWriter:
    """Append (step, time, X, Q) frames to a binary trajectory file.

    append=True continues an existing file whose header matches (a resume)
    and counts its frames; else the file is created or truncated.
    force_python=True writes synchronously from Python instead of the
    native writer thread (the same bytes).
    """

    def __init__(self, path: str, n_bodies: int, dtype=np.float32,
                 queue_capacity: int = 64, force_python: bool = False,
                 append: bool = False):
        self.path = path
        self.n_bodies = int(n_bodies)
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {dtype}")
        self._code = _DTYPE_CODES[self.dtype]
        self._handle = None
        self._file = None
        append = append and os.path.exists(path)
        existing_frames = 0
        if append:
            with open(path, "rb") as f:
                magic, _, nb, code = struct.unpack("<4I", f.read(16))
            if magic != MAGIC or nb != self.n_bodies or code != self._code:
                raise RuntimeError(
                    f"cannot append to {path}: header mismatch (bodies "
                    f"{nb} vs {self.n_bodies}, dtype code {code} vs "
                    f"{self._code})")
            frame_size = 16 + self.n_bodies * 7 * self.dtype.itemsize
            existing_frames = (os.path.getsize(path)
                               - HEADER_BYTES) // frame_size
        if force_python:
            self._file = open(path, "ab" if append else "wb")
            if not append:
                self._file.write(struct.pack("<8I", MAGIC, VERSION,
                                             self.n_bodies, self._code,
                                             0, 0, 0, 0))
        else:
            self._lib = _load_native()
            self._handle = self._lib.rblt_tw_open(
                path.encode(), self.n_bodies, self._code, queue_capacity,
                1 if append else 0)
            if not self._handle:
                raise OSError(f"native trajectory writer failed to open "
                              f"{path}")
        self._frames = existing_frames

    def append(self, step: int, sim_time: float, X, Q) -> None:
        X = np.ascontiguousarray(
            np.asarray(X, self.dtype).reshape(self.n_bodies, 3))
        Q = np.ascontiguousarray(
            np.asarray(Q, self.dtype).reshape(self.n_bodies, 4))
        if self._handle is not None:
            rc = self._lib.rblt_tw_append(
                self._handle, int(step), float(sim_time),
                X.ctypes.data_as(ctypes.c_void_p),
                Q.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise OSError("trajectory append failed (disk error?)")
        else:
            self._file.write(struct.pack("<Qd", int(step), float(sim_time)))
            self._file.write(X.tobytes())
            self._file.write(Q.tobytes())
        self._frames += 1

    def flush(self) -> None:
        """Block until every appended frame is written and flushed."""
        if self._handle is not None:
            self._lib.rblt_tw_flush(self._handle)
        elif self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.rblt_tw_close(self._handle)
            self._handle = None
        elif self._file is not None:
            self._file.close()
            self._file = None

    @property
    def frames(self) -> int:
        """Frames in the file: those found on append plus those appended."""
        return self._frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trajectory(path: str
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read a trajectory file → (steps (T,), times (T,), X (T, B, 3),
    Q (T, B, 4)); a partly written last frame is dropped."""
    with open(path, "rb") as f:
        header = f.read(HEADER_BYTES)
    magic, version, n_bodies, code = struct.unpack("<4I", header[:16])
    if magic != MAGIC:
        raise RuntimeError(f"{path} is not an RBLT trajectory (bad magic)")
    if version > VERSION:
        raise RuntimeError(f"{path}: format v{version} newer than supported "
                           f"v{VERSION}")
    dtype = np.dtype(_DTYPES[code])
    frame_size = 16 + n_bodies * 7 * dtype.itemsize
    data = np.fromfile(path, dtype=np.uint8, offset=HEADER_BYTES)
    n_frames = data.size // frame_size
    data = data[: n_frames * frame_size].reshape(n_frames, frame_size)
    steps = data[:, 0:8].copy().view(np.uint64).reshape(n_frames)
    times = data[:, 8:16].copy().view(np.float64).reshape(n_frames)
    payload = data[:, 16:].copy().view(dtype).reshape(n_frames, n_bodies * 7)
    X = payload[:, : n_bodies * 3].reshape(n_frames, n_bodies, 3)
    Q = payload[:, n_bodies * 3:].reshape(n_frames, n_bodies, 4)
    return steps, times, X, Q

