"""ctypes binding of the native C++ IO library (native/phenaki_io.cpp), the
port's own copy of phenaki_tpu/data/native.py.

The library decodes and encodes GIFs and loads a batch of GIFs on a thread
pool straight into one float32 buffer (decode, short-side bilinear resize,
centre crop, optional horizontal flip, frame-count cast). It is host IO, not
a device kernel. It is built with `make -C native` at first use; where the
build or the load fails, `available()` is False and the callers
(`codecs.py`, `datasets.py`) take the PIL route, which has the same Python
interface.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libphenaki_io.so"
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_intp = ctypes.POINTER(ctypes.c_int)
_c_int = ctypes.c_int
SIGNATURES = {
    "io_gif_probe": ([ctypes.c_char_p, _intp, _intp, _intp], ctypes.c_int),
    "io_gif_decode": ([ctypes.c_char_p, _u8p], ctypes.c_int),
    "io_gif_encode": ([ctypes.c_char_p, _u8p] + [_c_int] * 5, ctypes.c_int),
    "io_load_gif_batch": ([ctypes.POINTER(ctypes.c_char_p)] + [_c_int] * 4 + [_u8p, _f32p, _c_int],
                          ctypes.c_int),
    "io_transform_image": ([_u8p, _c_int, _c_int, _f32p, _c_int, _c_int, _c_int], None),
}


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where it is unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.exists() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native IO library {_LIB_PATH} is unavailable")
    return lib


def gif_decode(path: str) -> np.ndarray:
    """GIF file -> (frames, H, W, 3) uint8, each frame the full composited canvas."""
    lib = _require()
    w, h, f = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.io_gif_probe(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(f))
    if rc != 0:
        raise ValueError(f"failed to parse gif {path!r} (rc={rc})")
    out = np.empty((f.value, h.value, w.value, 3), np.uint8)
    rc = lib.io_gif_decode(path.encode(), out.ctypes.data_as(_u8p))
    if rc != 0:
        raise ValueError(f"failed to decode gif {path!r} (rc={rc})")
    return out


def gif_encode(path: str, frames: np.ndarray, *, delay_ms: int = 120, loop: int = 0) -> None:
    """(frames, H, W, 3) uint8 -> animated GIF file."""
    lib = _require()
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (frames, H, W, 3) uint8, got {frames.shape}")
    F, H, W, _ = frames.shape
    rc = lib.io_gif_encode(path.encode(), frames.ctypes.data_as(_u8p), F, H, W, delay_ms, loop)
    if rc != 0:
        raise IOError(f"failed to write gif {path!r} (rc={rc})")


def load_gif_batch(paths: Sequence[str], *, num_frames: int, height: int, width: int,
                   hflip: Optional[np.ndarray] = None, num_threads: int = 0) -> np.ndarray:
    """Decode and transform a batch of GIFs on the library's thread pool into
    (n, num_frames, height, width, 3) float32 in [0, 1]. Short videos are
    zero-padded, long ones truncated (`cast_num_frames`); a file that fails
    to decode gives zeros. `hflip` is one flag a path."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, num_frames, height, width, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    flip_ptr = None
    if hflip is not None:
        hflip = np.ascontiguousarray(hflip, np.uint8)
        if hflip.shape != (n,):
            raise ValueError(f"hflip has shape {hflip.shape}, expected ({n},)")
        flip_ptr = hflip.ctypes.data_as(_u8p)
    lib.io_load_gif_batch(c_paths, n, num_frames, height, width, flip_ptr, out.ctypes.data_as(_f32p),
                          num_threads)
    return out


def transform_image(img: np.ndarray, *, height: int, width: int, hflip: bool = False) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (height, width, 3): short-side bilinear
    resize, centre crop, optional horizontal flip, scaled to [0, 1]."""
    lib = _require()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    sh, sw, _ = img.shape
    out = np.empty((height, width, 3), np.float32)
    lib.io_transform_image(img.ctypes.data_as(_u8p), sh, sw, out.ctypes.data_as(_f32p), height, width,
                           1 if hflip else 0)
    return out
