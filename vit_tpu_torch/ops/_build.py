"""On-demand build of the Hopper kernels and their launch counters.

Each ``vit_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc``, all of
them at once, and the objects link into one shared library with a plain C
interface, loaded through ``ctypes`` (no PyTorch headers, so the build
takes seconds). The library is named by a hash of the sources and
flags, so an edit rebuilds; it lives in ``vit_tpu_torch/_build/``, which git
ignores. Nothing is built or loaded until the first kernel launch.

Each launch site is also a ``torch.library`` operator in the
``vit_tpu_torch`` namespace (``define_op``), defined in Python: its CUDA
implementation is the kernel wrapper, its CPU implementation the kernel's
plain twin, and its fake implementation gives the output's shape, dtype and
strides without touching data, so that ``torch.export`` records the launch
as one node of the graph (``ops._route`` says when an entry calls it).
Defining the operators builds and loads nothing.

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

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

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
    "vt_gemm_bf16_sm90": [
        _P, _P, _P,          # a [M, K], b [K, N] (bf16), c [M, N]
        _P, _P,              # bias (fp32 [N], NULL = none), residual (c's dtype, NULL = none)
        _I,                  # activation (gemm.cuh Act: 0 none)
        _I,                  # out_is_fp32
        _I, _I, _I,          # M, N, K
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
    "vt_fused_mlp_route_wgmma": [
        _I, _I,              # D, F: 1 when both products run on the wgmma GEMM
    ],
    "vt_talking_heads_block": [
        _P, _I,              # x, x_is_fp32
        _P, _P,              # ln_scale, ln_bias (fp32)
        _P, _P, _P,          # wqkv, wout (bf16), bout (fp32)
        _P, _P,              # mix_pre, mix_post (fp32 [H, H])
        _P,                  # out (x's dtype)
        _P, _P, _P,          # scratch: xn, qkv, attn (bf16)
        _P, _P,              # NULL or fp32 [B, H, N, N]: mixed scores, post-mixed P
        _I, _I, _I, _I, _I,  # B, N, D, heads, dim_head
        _F, _F, _I, _I,      # scale, ln_eps, residual, true_n
        _P,                  # cudaStream_t
    ],
    "vt_reattention_block": [
        _P, _I,              # x, x_is_fp32
        _P, _P,              # ln_scale, ln_bias (fp32)
        _P, _P, _P,          # wqkv, wout (bf16), bout (fp32)
        _P, _P, _P,          # mix (fp32 [H, H]), rln_scale, rln_bias (fp32 [H])
        _P,                  # out (x's dtype)
        _P, _P, _P,          # scratch: xn, qkv, attn (bf16)
        _P, _P,              # NULL or fp32 [B, H, N, N]: mixed softmax r, normalised r'
        _I, _I, _I, _I, _I,  # B, N, D, heads, dim_head
        _F, _F, _F, _I,      # scale, ln_eps, reattn_eps, true_n
        _P,                  # cudaStream_t
    ],
    "vt_qkv_attention": [
        _P,                  # qkv (bf16)
        _P, _I, _I,          # bias (fp32, NULL = none), bias_b, bias_h (axis is full)
        _P,                  # out (bf16)
        _I, _I, _I, _I,      # B, N, heads, dim_head
        _F,                  # scale
        _P,                  # cudaStream_t
    ],
    "vt_flash_attention": [
        _P, _L, _L, _L,      # q (bf16) and its batch, head, row strides (elements)
        _P, _L, _L, _L,      # k
        _P, _L, _L, _L,      # v
        _P, _L, _L, _L,      # out (bf16)
        _I, _I, _I, _I,      # B, heads, Nq, Nk
        _I, _I, _F,          # D, Dv, scale
        _P, _I, _I,          # bias (fp32, NULL = none), bias_b, bias_h (axis is full)
        _I,                  # mask_self
        _P,                  # cudaStream_t
    ],
    "vt_attention_sm90_warps": [
        _I, _I, _I, _I, _I, _I,  # B, heads, Nq, Nk, D, Dv: warps a block of kernels 3 and 4
    ],
    "vt_flash_attention_kv_blocked": [
        _P, _L, _L, _L,      # q (bf16) and its batch, head, row strides (elements)
        _P, _L, _L, _L,      # k
        _P, _L, _L, _L,      # v
        _P, _L, _L, _L,      # out (bf16)
        _I, _I, _I, _I,      # B, heads, Nq, Nk
        _I, _I, _F,          # D, Dv, scale
        _P, _I, _I,          # bias (fp32, NULL = none), bias_b, bias_h (axis is full)
        _I,                  # mask_self
        _P,                  # scratch: the padded q, k, v rows (bf16)
        _P,                  # cudaStream_t
    ],
    "vt_kv_blocked_plan": [
        _I, _I, _I,          # Nk, D, Dv
        _P,                  # int[5]: variant, warps, query rows, stages, shared-memory bytes
    ],
    "vt_window_attention_block": [
        _P, _I,              # xw, x_is_fp32
        _P, _P,              # ln_scale, ln_bias (fp32)
        _P, _P, _P,          # wqkv, wout (bf16), bout (fp32)
        _P, _I,              # bias (fp32 [1|H, S, S], NULL = none), bias_h (per head)
        _P,                  # out (xw's dtype)
        _P, _P, _P,          # scratch: xn, qkv, attn (bf16; NULL on the fused variants)
        _I, _I, _I, _I, _I,  # NW, S, C, heads, dim_head
        _F, _F,              # scale, ln_eps
        _P,                  # cudaStream_t
    ],
    "vt_window_attention_plan": [
        _I, _I, _I, _I,      # S, C, heads, dim_head
        _P,                  # int[3]: variant, windows a block, shared-memory bytes
    ],
    "vt_quant_attention_block": [
        _P, _I,              # x, x_is_fp32
        _P, _P,              # ln_scale, ln_bias (fp32)
        _P, _P, _P, _P,      # wqkv [3*H*Dh, D] (int8, K-major), sqkv (fp32), wout [D, H*Dh], sout
        _P,                  # bout (fp32)
        _P,                  # out (x's dtype)
        _P, _P, _P, _P,      # scratch: xq (int8), s_row (fp32), qkv (x's dtype), attn (fp32)
        _P, _P,              # scratch: aq (int8), s_row2 (fp32)
        _I, _I, _I, _I, _I,  # B, N, D, heads, dim_head
        _F, _F, _I,          # scale, ln_eps, true_n
        _P,                  # cudaStream_t
    ],
    "vt_quant_mlp": [
        _P, _I,              # x, x_is_fp32
        _P, _P,              # ln_scale, ln_bias (fp32)
        _P, _P, _P,          # w1 [F, D] (int8, K-major), s1, b1 (fp32)
        _P, _P, _P,          # w2 [D, F] (int8, K-major), s2, b2 (fp32)
        _P,                  # out (x's dtype)
        _P, _P, _P, _P, _P,  # scratch: xq (int8), s_row, h (fp32), hq (int8), s_row2
        _P,                  # scratch: the hidden's partial row maxes [T, ceil(F / 128)] (fp32)
        _I, _I, _I,          # T, D, F
        _I, _F,              # activation, ln_eps
        _P,                  # cudaStream_t
    ],
    "vt_quant_rows": [
        _P, _P, _P,          # v [rows, K] fp32, codes [rows, K] int8, row scales fp32
        _I, _I,              # rows, K
        _P,                  # cudaStream_t
    ],
    "vt_quant_rows_parts": [
        _P, _P, _I,          # v [rows, K] fp32, partial row maxes [rows, parts] fp32, parts
        _P, _P,              # codes [rows, K] int8, row scales fp32
        _I, _I,              # rows, K
        _P,                  # cudaStream_t
    ],
    "vt_gemm_s8_sm90_i32": [
        _P, _P, _P,          # a [M, K] int8, b [N, K] int8 (K-major), c [M, N] int32
        _I, _I, _I,          # M, N, K
        _P,                  # cudaStream_t
    ],
    "vt_gemm_s8_sm90_f32": [
        _P, _P, _P,          # a [M, K] int8, b [N, K] int8 (K-major), c [M, N] fp32
        _P, _P, _P,          # s_row [M], s_col [N], bias [N] (fp32; bias NULL = none)
        _I,                  # activation (gemm.cuh Act: 0 none)
        _P,                  # partial row maxes [M, ceil(N / 128)] fp32 (NULL = none)
        _I, _I, _I,          # M, N, K
        _P,                  # cudaStream_t
    ],
    "vt_head_mix_plan": [
        _I, _I, _I,          # N, heads, dim_head
        _P,                  # int[4]: resident, slab tiles, ring stages, shared-memory bytes
    ],
    # the fp32 routes of kernels 7, 8 and 2 (x, weights, scratch and out fp32)
    "vt_talking_heads_block_f32": [
        _P, _P, _P,          # x, ln_scale, ln_bias
        _P, _P, _P,          # wqkv, wout, bout
        _P, _P,              # mix_pre, mix_post ([H, H])
        _P,                  # out
        _P, _P, _P,          # scratch: xn, qkv, attn
        _P, _P,              # NULL or [B, H, N, N]: mixed scores, post-mixed P
        _I, _I, _I, _I, _I,  # B, N, D, heads, dim_head
        _F, _F, _I, _I,      # scale, ln_eps, residual, true_n
        _P,                  # cudaStream_t
    ],
    "vt_reattention_block_f32": [
        _P, _P, _P,          # x, ln_scale, ln_bias
        _P, _P, _P,          # wqkv, wout, bout
        _P, _P, _P,          # mix ([H, H]), rln_scale, rln_bias ([H])
        _P,                  # out
        _P, _P, _P,          # scratch: xn, qkv, attn
        _P, _P,              # NULL or [B, H, N, N]: mixed softmax r, normalised r'
        _I, _I, _I, _I, _I,  # B, N, D, heads, dim_head
        _F, _F, _F, _I,      # scale, ln_eps, reattn_eps, true_n
        _P,                  # cudaStream_t
    ],
    "vt_head_mix_plan_f32": [
        _I, _I,              # N, heads
        _P,                  # int[4]: as vt_head_mix_plan's
    ],
    "vt_fused_mlp_f32": [
        _P,                  # x
        _P, _P,              # ln_scale (NULL = no LN), ln_bias (NULL = 0)
        _P, _P, _P, _P,      # w1, b1 (NULL = 0), w2, b2 (NULL = 0)
        _P,                  # out
        _P, _P,              # scratch: xn, h
        _I, _I, _I,          # T, D, F
        _I, _I,              # activation, residual
        _F,                  # ln_eps
        _P,                  # cudaStream_t
    ],
    # the fp32 routes of kernels 1, 3, 4 and 6 on the fp32 core (csrc/attention_f32.cuh)
    "vt_attention_block_f32": [
        _P, _P, _P,          # x, ln_scale, ln_bias
        _P, _P, _P,          # wqkv, wout, bout
        _P,                  # out
        _P, _P, _P,          # scratch: xn, qkv, attn
        _I, _I, _I, _I, _I,  # B, N, D, heads, dim_head
        _F, _F,              # scale, ln_eps
        _I, _I,              # true_n, block_tokens
        _P,                  # cudaStream_t
    ],
    "vt_qkv_attention_f32": [
        _P,                  # qkv
        _P, _I, _I,          # bias (NULL = none), bias_b, bias_h (axis is full)
        _P,                  # out
        _I, _I, _I, _I,      # B, N, heads, dim_head
        _F,                  # scale
        _P,                  # cudaStream_t
    ],
    "vt_flash_attention_f32": [
        _P, _L, _L, _L,      # q and its batch, head, row strides (elements)
        _P, _L, _L, _L,      # k
        _P, _L, _L, _L,      # v
        _P, _L, _L, _L,      # out
        _I, _I, _I, _I,      # B, heads, Nq, Nk
        _I, _I, _F,          # D, Dv, scale
        _P, _I, _I,          # bias (NULL = none), bias_b, bias_h (axis is full)
        _I,                  # mask_self
        _P,                  # cudaStream_t
    ],
    "vt_window_attention_block_f32": [
        _P,                  # xw
        _P, _P,              # ln_scale, ln_bias
        _P, _P, _P,          # wqkv, wout, bout
        _P, _I,              # bias ([1|H, S, S], NULL = none), bias_h (per head)
        _P,                  # out
        _P, _P, _P,          # scratch: xn, qkv, attn
        _I, _I, _I, _I, _I,  # NW, S, C, heads, dim_head
        _F, _F,              # scale, ln_eps
        _P,                  # cudaStream_t
    ],
    # the fp32 route of kernel 5 (csrc/flash_attention_kv_blocked.cu section 4)
    "vt_flash_attention_kv_blocked_f32": [
        _P, _L, _L, _L,      # q and its batch, head, row strides (elements)
        _P, _L, _L, _L,      # k
        _P, _L, _L, _L,      # v
        _P, _L, _L, _L,      # out
        _I, _I, _I, _I,      # B, heads, Nq, Nk
        _I, _I, _F,          # D, Dv, scale
        _P, _I, _I,          # bias (NULL = none), bias_b, bias_h (axis is full)
        _I,                  # mask_self
        _P,                  # scratch: p and alpha of the two-phase plan (NULL in one pass)
        _P,                  # cudaStream_t
    ],
    "vt_kv_blocked_plan_f32": [
        _I, _I, _I,          # Nk, D, Dv
        _P,                  # int[5]: as vt_kv_blocked_plan's
    ],
    "vt_attention_f32_plan": [
        _I, _I, _I,          # Nk, D, Dv
        _P,                  # int[3]: query rows a block, threads, shared-memory bytes
    ],
    "vt_gemm_f32": [
        _P, _P, _P,          # a [M, K], b [K, N], c [M, N] (fp32)
        _P, _P,              # bias [N], residual [M, N] (NULL = none)
        _I,                  # activation (gemm.cuh Act: 0 none)
        _I, _I, _I,          # M, N, K
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
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link. The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="obj-"))
    nvcc = _nvcc()
    try:
        jobs = []
        for src in cu:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmpdir / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        tmp_so = tmpdir / "lib.so"
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp_so), *(str(tmpdir / f"{s.stem}.o") for s in cu)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        so.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed (its first errors; all in {so.with_suffix('.log')}):"
                               f"\n{failed[0][:4000]}")
        os.replace(tmp_so, so)  # atomic: a concurrent process never loads half a file
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return so


NVJPEG_SRC = SRC_DIR / "jpeg_nvjpeg.cpp"
NVJPEG_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_nvjpeg() -> Path:
    """Compile the nvJPEG decoder (``csrc/jpeg_nvjpeg.cpp``, host code only,
    linked with the toolkit's ``libnvjpeg``) unless the library for this
    source exists; returns its path. ``vit_tpu_torch/data.py`` loads it
    where ``native/`` does not build. Raises where ``nvcc`` is missing or the
    build fails (its output beside the library as ``<name>.log``)."""
    h = hashlib.sha256(" ".join(NVJPEG_FLAGS).encode())
    h.update(NVJPEG_SRC.read_bytes())
    so = BUILD_DIR / f"libvit_nvjpeg_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix="nvjpeg-", suffix=".so")
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVJPEG_FLAGS, "-o", tmp, str(NVJPEG_SRC), "-lnvjpeg"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {NVJPEG_SRC.name}:\n{proc.stderr[:4000]}")
        os.replace(tmp, so)
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


# -- the operator namespace ---------------------------------------------------

LIB = torch.library.Library("vit_tpu_torch", "DEF")


def define_op(schema: str, *, cuda, cpu, fake):
    """Define ``vit_tpu_torch::<name>`` from ``schema`` (``"<name>(Tensor x,
    ...) -> Tensor"``) with its CUDA implementation (the kernel wrapper), its
    CPU one (the twin) and its fake, each taking the schema's arguments
    positionally. Returns the operator's overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"vit_tpu_torch::{name}", fake, lib=LIB)
    return getattr(torch.ops.vit_tpu_torch, name).default


def contiguous_like(x, *_):
    """Fake output of an operator whose output is a new contiguous tensor of
    ``x``'s shape and dtype."""
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.vt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# -- launch counters ---------------------------------------------------------

KERNELS = ("attention_block", "fused_mlp", "qkv_attention", "quant_attention_block", "quant_mlp",
           "talking_heads_block", "reattention_block", "flash_attention", "window_attention_block",
           "flash_attention_kv_blocked")
# the kernels whose wrappers have an autograd Function (ops/__init__.py)
DIFFERENTIABLE = ("attention_block", "fused_mlp", "qkv_attention", "flash_attention",
                  "window_attention_block", "flash_attention_kv_blocked", "talking_heads_block",
                  "reattention_block")
# the raw wrappers of kernels 3-8, each with the ops entry that runs it
# through its autograd Function under grad
GRAD_ENTRIES = {"fused_qkv_attention": "ops.qkv_attention (QkvAttentionFn)",
                "flash_attention": "ops.attention (FlashAttentionFn)",
                "flash_attention_kv_blocked": "ops.attention (FlashAttentionFn)",
                "fused_window_attention_block":
                    "ops.window_attention_block (WindowAttentionBlockFn)",
                "talking_heads_block": "ops.talking_heads_block (TalkingHeadsBlockFn)",
                "reattention_block": "ops.reattention_block (ReattentionBlockFn)"}
# the kernels with an fp32 route (fp32 operands and weights, or an fp32 stream
# beside the int8 weights of kernels 9 and 10; no bf16 rounding)
FP32_ROUTES = ("attention_block", "fused_mlp", "qkv_attention", "talking_heads_block",
               "reattention_block", "flash_attention", "window_attention_block",
               "flash_attention_kv_blocked", "quant_attention_block", "quant_mlp")
_counts = collections.Counter()
_fp32_counts = collections.Counter()
_recomputes = collections.Counter()
_counts_lock = threading.Lock()


def count_launch(name: str, fp32: bool = False) -> None:
    """One launch of kernel ``name``; ``fp32``: on its fp32 route (counted
    in ``launch_counts`` too)."""
    with _counts_lock:
        _counts[name] += 1
        if fp32:
            _fp32_counts[name] += 1


def count_recompute(name: str) -> None:
    with _counts_lock:
        _recomputes[name] += 1


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    with _counts_lock:
        return {k: _counts[k] for k in KERNELS}


def fp32_launch_counts() -> dict:
    """Launches of each kernel's fp32 route (``FP32_ROUTES``) since the last
    reset."""
    with _counts_lock:
        return {k: _fp32_counts[k] for k in FP32_ROUTES}


def recompute_counts() -> dict:
    """Backward passes of each kernel's autograd Function since the last
    reset: each recomputes the kernel's plain twin and differentiates it
    (kernels 4 and 5: the Q-chunked flash backward)."""
    with _counts_lock:
        return {k: _recomputes[k] for k in DIFFERENTIABLE}


def reset_launch_counts() -> None:
    with _counts_lock:
        _counts.clear()
        _fp32_counts.clear()
        _recomputes.clear()


def needs_grad(*operands) -> bool:
    """Whether autograd would record an op on these operands: grad mode on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in operands)


def refuse_grad(name: str, *operands) -> None:
    """Raise where an autograd graph would be cut: a kernel wrapper writes
    its output through raw pointers, so under grad mode an operand that
    requires grad would get no gradient, silently. Kernels 3-8 are
    differentiated by the Functions their ops entries run (``GRAD_ENTRIES``);
    kernels 9 and 10 (the int8 blocks) and ``gemm_sm90`` have none: the int8
    kernels are inference only, in ``vit_tpu`` too. Silent under
    ``torch.no_grad()`` and ``torch.inference_mode()``."""
    if needs_grad(*operands):
        entry = GRAD_ENTRIES.get(name)
        where = (f"under grad call {entry}, which differentiates it" if entry else
                 "it has no autograd Function (kernels 9 and 10 are inference only)")
        raise NotImplementedError(
            f"{name} writes its output outside the autograd graph: {where}; or call it under "
            "torch.no_grad() or torch.inference_mode(), or on CPU tensors (its plain twin). "
            "Kernels 1-8 train through autograd Functions; what is left of training is "
            "ROADMAP.md Queue 1 item 7")
