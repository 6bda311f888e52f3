"""Host JPEG decode: the front end of the serving path (port of the decode
half of ``vit_tpu/data.py``).

Raw JPEG bytes become a fixed-size ``[N, S, S, 3]`` uint8 batch on the host
through the native multithreaded libjpeg decoder (``native/jpeg_decoder.cpp``,
ctypes-bound, GIL-free), built on demand with ``make -C native``; PIL is the
fallback where the library cannot be built. Resize, crop and normalize then
run on the card (``vit_tpu_torch.pipeline``).

The binding is the same C ABI that ``vit_tpu/data.py`` uses; it is repeated
here because importing ``vit_tpu`` imports JAX and flax, which the port's
machine does not have.
"""

from __future__ import annotations

import ctypes
import io
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvitjpeg.so")

# Decode flags and ABI version (must mirror native/jpeg_decoder.cpp).
_FLAG_DCT_SCALE = 1
_ABI_VERSION = 2


def _open_lib(path: str = _LIB_PATH) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    try:
        if lib.vt_api_version() != _ABI_VERSION:
            return None
    except AttributeError:  # pre-versioning binary
        return None
    return lib


def _open_rebuilt_lib() -> Optional[ctypes.CDLL]:
    """Load a just-rebuilt library through a unique temporary path: dlopen
    caches by path name, so reopening ``_LIB_PATH`` could return the stale
    mapping."""
    try:
        fd, tmp = tempfile.mkstemp(prefix="libvitjpeg-", suffix=".so")
        os.close(fd)
        shutil.copy2(_LIB_PATH, tmp)
    except OSError:
        return _open_lib()
    try:
        return _open_lib(tmp)
    finally:
        os.unlink(tmp)  # the mapping survives the unlink


def _load_native() -> Optional[ctypes.CDLL]:
    lib = _open_lib() if os.path.exists(_LIB_PATH) else None
    if lib is None:
        try:  # (re)build on demand; a machine without libjpeg falls back to PIL
            subprocess.run(["make", "-C", _NATIVE_DIR, "clean", "all"],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        lib = _open_rebuilt_lib()
        if lib is None:
            return None
    lib.vt_decode_jpeg_batch.restype = ctypes.c_int
    lib.vt_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # data
        ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
        ctypes.c_int,                     # n
        ctypes.c_int,                     # out_size
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.POINTER(ctypes.c_int64),   # status [n]
        ctypes.c_int,                     # n_threads
        ctypes.c_int,                     # flags
    ]
    return lib


_lib_lock = threading.Lock()
_lib_state: dict = {}


def _native_lib() -> Optional[ctypes.CDLL]:
    with _lib_lock:
        if "lib" not in _lib_state:
            _lib_state["lib"] = _load_native()
        return _lib_state["lib"]


class JpegDecoder:
    """Batch JPEG -> uint8 RGB ``[N, size, size, 3]`` with a host bilinear
    resize (half-pixel centers). Native multithreaded decode when the
    library is available, PIL otherwise (``.backend`` says which).
    ``fast=True`` lets the IDCT downscale by a power of two first.

    The library is looked up on the first decode, so a server fed only
    pre-decoded arrays never builds or loads it."""

    def __init__(self, size: int = 256, threads: Optional[int] = None, fast: bool = False):
        self.size = size
        self.threads = threads or min(32, os.cpu_count() or 8)
        self.fast = fast

    @property
    def backend(self) -> str:
        return "native" if _native_lib() is not None else "pil"

    def __call__(self, jpegs: Sequence[bytes]) -> np.ndarray:
        lib = _native_lib()
        if lib is not None:
            return self._decode_native(lib, jpegs)
        return self._decode_pil(jpegs)

    def _decode_native(self, lib, jpegs: Sequence[bytes]) -> np.ndarray:
        n = len(jpegs)
        data = np.frombuffer(b"".join(jpegs), np.uint8)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(j) for j in jpegs], out=offsets[1:])
        out = np.empty((n, self.size, self.size, 3), np.uint8)
        status = np.zeros(n, np.int64)
        failures = lib.vt_decode_jpeg_batch(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, self.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.threads, _FLAG_DCT_SCALE if self.fast else 0,
        )
        if failures:
            bad = np.nonzero(status)[0].tolist()
            raise ValueError(f"{failures} corrupt JPEG(s) at indices {bad[:8]}")
        return out

    def _decode_pil(self, jpegs: Sequence[bytes]) -> np.ndarray:
        from PIL import Image

        out = np.empty((len(jpegs), self.size, self.size, 3), np.uint8)
        for i, raw in enumerate(jpegs):
            img = Image.open(io.BytesIO(raw))
            if self.fast:
                img.draft("RGB", (self.size, self.size))
            out[i] = _resize_bilinear_u8(np.asarray(img.convert("RGB")), self.size)
        return out


def _resize_bilinear_u8(arr: np.ndarray, size: int) -> np.ndarray:
    """Numpy mirror of the native resize (half-pixel centers), so the PIL
    fallback agrees with the native path."""
    h, w, _ = arr.shape
    if h == size and w == size:
        return arr
    fy = np.clip((np.arange(size) + 0.5) * (h / size) - 0.5, 0, h - 1)
    fx = np.clip((np.arange(size) + 0.5) * (w / size) - 0.5, 0, w - 1)
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    a = arr.astype(np.float32)
    top = a[y0][:, x0] + (a[y0][:, x1] - a[y0][:, x0]) * wx
    bot = a[y1][:, x0] + (a[y1][:, x1] - a[y1][:, x0]) * wx
    return (top + (bot - top) * wy + 0.5).astype(np.uint8)


def classify_jpegs(pipeline, jpegs: List[bytes], *, decoder: Optional[JpegDecoder] = None):
    """JPEG bytes -> logits through an ``InferencePipeline``: native decode
    on the host, resize / crop / normalize and the model on the card."""
    decoder = decoder or JpegDecoder()
    return pipeline(decoder(jpegs))
