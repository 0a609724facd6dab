"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/diffgfdn_torch_kernels/<name>-<digest>.so`` under the checkout
(listed in ``.gitignore``); the digest covers the source and the flags, so an
edited source rebuilds and an unchanged one is reused. :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, because a refused launch never runs
and ``torch.cuda.synchronize()`` does not report it.
"""

import ctypes
import hashlib
import os
from pathlib import Path
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diffgfdn_torch_kernels"
SOURCES = ("cinv", "sos", "lu")
# --fmad=false keeps every product and sum separately rounded, as the plain
# PyTorch versions compute them, so pivot choices agree bit for bit
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is (or will be) built."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns {name: compiler output} (ptxas resource usage; empty for a
    library that was already built). Raises RuntimeError naming each
    source that failed, with the compiler's output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            tmp,
            out,
        )
    logs = {name: "" for name in names}
    failed: List[str] = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"csrc/{name}.cu (nvcc exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; set each C function's
    ``argtypes`` from ``signatures`` and its ``restype`` to int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
