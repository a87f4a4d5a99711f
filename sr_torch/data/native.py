"""ctypes bindings for the port's native host-side data-prep library.

Port of ``sr/data/native.py``. ``sr_torch/data/csrc/srnative.cpp`` (the
port's own copy of ``native/srnative.cpp``) implements the Pillow-exact
bicubic resampler and the mean squared error of two Y planes in C++. This
module builds it at first use with ``native/Makefile``'s flags into
``build/sr_torch_native/`` at the root of the checkout, loads it, and falls
back to the numpy versions when no compiler exists. Both paths give the
same bits; :func:`available` says which one runs.

The library's file name carries a hash of its source, the flags and the
target that ``-march=native`` resolves to, so an edited source, or a copy of
the build directory on another CPU, builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "srnative.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sr_torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _target_flags(cxx: str) -> str:
    """The machine flags ``-march=native`` expands to on this CPU."""
    out = subprocess.run([cxx, "-march=native", "-E", "-v", "-x", "c++",
                          os.devnull], capture_output=True, text=True,
                         timeout=60, check=True)
    return " ".join(t for line in out.stderr.splitlines() if "cc1" in line
                    for t in line.split() if t.startswith("-m"))


def _build() -> Path | None:
    """Compile the library unless it exists; its path, or None when no
    compiler is found or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    try:
        key = SOURCE.read_bytes() + " ".join(
            (cxx, *CXX_FLAGS, _target_flags(cxx))).encode()
        target = BUILD_DIR / (
            f"libsrnative-{hashlib.sha256(key).hexdigest()[:16]}.so")
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, target)  # atomic: concurrent builds agree
        return target
    except (OSError, subprocess.SubprocessError):
        return None


def load() -> ctypes.CDLL | None:
    """The native library, built on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sr_resize_bicubic_u8.argtypes = ([u8p] + [ctypes.c_int] * 3
                                             + [u8p] + [ctypes.c_int] * 2)
        lib.sr_resize_bicubic_u8.restype = ctypes.c_int
        lib.sr_mse_y_u8.argtypes = [u8p, u8p] + [ctypes.c_int] * 3
        lib.sr_mse_y_u8.restype = ctypes.c_double
        lib.sr_native_abi_version.argtypes = []
        lib.sr_native_abi_version.restype = ctypes.c_int
        if lib.sr_native_abi_version() != 2:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library runs, False when numpy does."""
    return load() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_bicubic_u8(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Pillow-exact bicubic resize of a uint8 (H, W) or (H, W, C) image,
    native when available."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f"resize_bicubic_u8 takes a uint8 (H, W[, C]) image, "
                        f"got {img.dtype} {img.shape}")
    lib = load()
    if lib is None:
        from sr_torch.kernels.bicubic import pil_resize_exact_u8

        return pil_resize_exact_u8(img, out_hw)
    squeeze = img.ndim == 2
    x = np.ascontiguousarray(img[:, :, None] if squeeze else img)
    h, w, c = x.shape
    oh, ow = out_hw
    out = np.empty((oh, ow, c), dtype=np.uint8)
    rc = lib.sr_resize_bicubic_u8(_u8ptr(x), h, w, c, _u8ptr(out), oh, ow)
    if rc != 0:
        raise ValueError(f"sr_resize_bicubic_u8 failed (rc={rc})")
    return out[:, :, 0] if squeeze else out


def psnr_y_u8(a: np.ndarray, b: np.ndarray, border: int = 0) -> float:
    """PSNR of two uint8 (H, W) planes after shaving ``border`` pixels.

    The library sums the squared errors (exactly: they are integers); the
    PSNR is finished in numpy as ``sr_torch.eval.metrics.psnr`` finishes
    it, so both paths return the same bits."""
    from sr_torch.eval.metrics import psnr, psnr_from_mse

    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"psnr_y_u8 takes two equal (H, W) planes, got "
                         f"{a.shape} and {b.shape}")
    lib = load()
    if lib is None:
        return psnr(a.astype(np.float64), b.astype(np.float64), border=border)
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    h, w = a.shape
    return psnr_from_mse(lib.sr_mse_y_u8(_u8ptr(a), _u8ptr(b), h, w, border))
