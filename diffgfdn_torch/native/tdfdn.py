"""ctypes bindings for the native streaming GFDN renderer (port of
``diffgfdn_tpu/native/tdfdn.py``; ``tdfdn.cpp`` is a copy of its source).

Compiles ``tdfdn.cpp`` with ``g++ -O3`` on first use into
``build/diffgfdn_torch_native/libtdfdn-<digest>.so`` under the checkout
(listed in ``.gitignore``; the digest covers the source, the flags and the
target that ``-march=native`` resolves to on this host, so an edited source
or another CPU rebuilds rather than loading a library it cannot run) and exposes a stateful :class:`NativeGFDNRenderer`
for host-side real-time rendering without any device. It runs the same
recursion as ``kernels/tdgfdn.py`` (kernel B7 on the card) and shares none
of its code.
"""

import ctypes
import functools
import hashlib
import logging
import os
from pathlib import Path
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("diffgfdn_torch")

_SRC = Path(__file__).with_name("tdfdn.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diffgfdn_torch_native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


@functools.lru_cache(maxsize=None)
def _native_target() -> bytes:
    """The machine and g++'s target options under ``-march=native`` on this
    host (the instruction sets the library may use)."""
    query = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                           check=True, capture_output=True)
    return platform.machine().encode() + query.stdout


def library_path() -> Path:
    """Where the shared library of ``tdfdn.cpp`` is (or will be) built on
    this host."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(GXX_FLAGS).encode() + _native_target()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libtdfdn-{digest}.so"


def _build_library() -> Path:
    """g++ the shared library into BUILD_DIR (idempotent)."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique temp name and os.replace into place:
    # another process dlopening a half-written .so loads garbage (the
    # in-process _LOCK cannot guard concurrent pytest workers / jobs)
    tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp_path)]
    logger.info("building native renderer: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp_path, lib_path)  # atomic on POSIX
    finally:
        tmp_path.unlink(missing_ok=True)
    return lib_path


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_library()))
            lib.tdfdn_create.restype = ctypes.c_void_p
            lib.tdfdn_create.argtypes = [
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ]
            lib.tdfdn_destroy.restype = None
            lib.tdfdn_destroy.argtypes = [ctypes.c_void_p]
            lib.tdfdn_reset.restype = None
            lib.tdfdn_reset.argtypes = [ctypes.c_void_p]
            lib.tdfdn_set_absorption_sos.restype = None
            lib.tdfdn_set_absorption_sos.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int,
            ]
            lib.tdfdn_process.restype = None
            lib.tdfdn_process.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_long,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int,
                ctypes.c_float,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    """True if the native renderer can be built/loaded on this host."""
    try:
        _load()
    except (OSError, subprocess.CalledProcessError) as exc:
        logger.warning("native renderer unavailable: %s", exc)
        return False
    return True


class NativeGFDNRenderer:
    """Stateful streaming GFDN: feed blocks, receive rendered audio.

    Args mirror the time-domain core (kernels/tdgfdn.py): ``delays`` in
    samples, ``gains`` whole-delay absorption gains, ``feedback_matrix``
    (N, N), ``input_gains`` (N,). ``sos_coeffs`` (N, S, 3, 2) installs
    per-line SOS absorption cascades instead of the scalar gains (the GEQ
    fits from ops/absorption.py) — frequency-dependent decay in the
    streaming path, sample-exact vs the block recursion's state-space
    filtering.
    """

    def __init__(
        self, delays, gains, feedback_matrix, input_gains, sos_coeffs=None
    ):
        lib = _load()
        self._lib = lib
        self.n = len(delays)
        self._delays = np.ascontiguousarray(delays, np.int32)
        if gains is None:
            gains = np.ones(self.n, np.float32)
        self._gains = np.ascontiguousarray(gains, np.float32)
        self._a = np.ascontiguousarray(feedback_matrix, np.float32).reshape(
            self.n, self.n
        )
        self._b = np.ascontiguousarray(input_gains, np.float32)
        if self._gains.shape != (self.n,) or self._b.shape != (self.n,):
            raise ValueError(f"gains {self._gains.shape} and input gains {self._b.shape}: "
                             f"want ({self.n},)")
        self._handle = lib.tdfdn_create(
            self.n, self._delays, self._gains, self._a, self._b
        )
        self._sos = None
        if sos_coeffs is not None:
            self.set_absorption_sos(sos_coeffs)

    def set_absorption_sos(self, sos_coeffs: np.ndarray) -> None:
        """Install (N, S, 3, 2) absorption cascades (num/den on last axis)."""
        sos = np.asarray(sos_coeffs, np.float64)
        n, s = sos.shape[:2]
        if n != self.n:
            raise ValueError(f"absorption cascades for {n} lines, the renderer has {self.n}")
        # (N, S, 6): b0 b1 b2 a0 a1 a2
        packed = np.concatenate([sos[..., 0], sos[..., 1]], axis=-1)
        self._sos = np.ascontiguousarray(packed, np.float32)
        self._lib.tdfdn_set_absorption_sos(self._handle, self._sos, int(s))

    def process(
        self,
        signal: np.ndarray,
        output_gains: np.ndarray,
        direct_gain: float = 0.0,
    ) -> np.ndarray:
        """Render a block: (T,) input -> (n_outs, T) outputs (stateful)."""
        sig = np.ascontiguousarray(signal, np.float32)
        c = np.ascontiguousarray(np.atleast_2d(output_gains), np.float32)
        if sig.ndim != 1 or c.shape[1] != self.n:
            raise ValueError(f"signal {sig.shape}, output gains {c.shape}: want (T,), "
                             f"(n_outs, {self.n})")
        n_outs = c.shape[0]
        out = np.empty((n_outs, sig.shape[0]), np.float32)
        self._lib.tdfdn_process(
            self._handle, sig, sig.shape[0], c, n_outs,
            np.float32(direct_gain), out,
        )
        return out

    def reset(self):
        self._lib.tdfdn_reset(self._handle)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tdfdn_destroy(handle)
            self._handle = None
