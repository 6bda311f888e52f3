"""On-demand build of the Hopper kernels and their launch counters.

``vit_tpu_torch/csrc/*.cu`` compile with ``nvcc`` into one shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so
the build takes seconds). The library is named by a hash of the sources and
flags, so an edit rebuilds; it lives in ``vit_tpu_torch/_build/``, which git
ignores. Nothing is built or loaded until the first kernel launch.

Mirrors the on-demand native build of ``vit_tpu/data.py:_load_native``, with
one difference: a failed build raises. A CUDA tensor never falls back to a
plain PyTorch path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points (csrc/*.cu) and their argument types. Every pointer and the
# stream are c_void_p: ctypes would pass a bare Python int as a 32-bit int.
_SIGNATURES = {
    "vt_attention_block": [
        _P, _I,              # x, x_is_fp32
        _P, _P,              # ln_scale, ln_bias (fp32)
        _P, _P, _P,          # wqkv, wout (bf16), bout (fp32)
        _P,                  # out (x's dtype)
        _P, _P, _P,          # scratch: xn, qkv, attn (bf16)
        _I, _I, _I, _I, _I,  # B, N, D, heads, dim_head
        _F, _F,              # scale, ln_eps
        _I, _I,              # true_n, block_tokens
        _P,                  # cudaStream_t
    ],
    "vt_fused_mlp": [
        _P, _I,              # x, x_is_fp32
        _P, _P,              # ln_scale (NULL = no LN), ln_bias (NULL = 0)
        _P, _P, _P, _P,      # w1, b1 (NULL = 0), w2, b2 (NULL = 0)
        _P,                  # out (x's dtype)
        _P, _P,              # scratch: xn, h (bf16)
        _I, _I, _I,          # T, D, F
        _I, _I,              # activation, residual
        _F,                  # ln_eps
        _P,                  # cudaStream_t
    ],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); cannot build the Hopper kernels")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvit_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vt_error_string.argtypes = [ctypes.c_int]
            lib.vt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.vt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# -- launch counters ---------------------------------------------------------

KERNELS = ("attention_block", "fused_mlp")
_counts = collections.Counter()
_counts_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _counts_lock:
        _counts[name] += 1


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    with _counts_lock:
        return {k: _counts[k] for k in KERNELS}


def reset_launch_counts() -> None:
    with _counts_lock:
        _counts.clear()
