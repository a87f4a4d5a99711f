"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/sr_torch_kernels/`` at the root of the checkout. The library's file
name carries a hash of its source and the compiler flags, so an edited source
builds anew and an unchanged one is reused. :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for them.

No PyTorch headers are compiled: the wrappers pass raw pointers and the CUDA
stream as integers, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sr_torch_kernels"
SOURCES = ("depth_to_space", "fused_resblock")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from the CUDA toolkit's usual prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
            "the sr_torch CUDA kernels are built on a machine with the "
            "CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict[str, str]:
    """Compile every library in ``names`` that is missing, in parallel.

    Returns ``{name: compiler output}`` for the sources it compiled (empty
    when everything was built already). ``verbose`` adds ``-Xptxas=-v`` so
    the output lists each kernel's registers, shared memory and spills.
    Raises ``RuntimeError`` with the compiler's output if a build fails.
    """
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        extra = ["-Xptxas=-v"] if verbose else []
        jobs = []
        for name in todo:
            target = library_path(name)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, target, tmp, proc))
        logs, failed = {}, []
        for name, target, tmp, proc in jobs:
            logs[name], _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, target)
            else:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.sr_error_string.argtypes = [ctypes.c_int]
                lib.sr_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.sr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
