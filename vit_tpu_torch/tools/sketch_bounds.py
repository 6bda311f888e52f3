"""Bounds on the H100 of the TPU sketch kernels S1-S7 (the Pallas kernels in
``scripts/`` that ``vit_tpu`` keeps as tuning experiments), at each
script's own shapes.

Each bound is the larger of two times, as chip_smoke.py's ``bound``: the
kernel's tensor-core operations over the card's peak rate for their type,
and the bytes it must move (each input read once, each output written once)
over the memory rate. Nothing here runs on a card: the numbers are computed,
not measured. Run: ``python vit_tpu_torch/tools/sketch_bounds.py``.
"""

from __future__ import annotations

# H100 SXM5 peaks (NVIDIA data sheet, dense), as in chip_smoke.py.
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def bound(bf16_flops=0.0, int8_ops=0.0, nbytes=0.0):
    t_ops = bf16_flops / PEAK_BF16 + int8_ops / PEAK_INT8
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def attention_block(b, n, dim, heads, d, *, int8=False):
    """LN -> qkv GEMM -> per-head softmax(q k^T) v -> out GEMM (+ bias, x):
    the ViT-L attention block of S1-S4 (bf16) and S6 (int8 GEMMs, bf16
    attention). x is read and the output written in bf16; the weights are
    read once."""
    m, hd = b * n, heads * d
    gemm = 2 * m * dim * 3 * hd + 2 * m * hd * dim
    attn = 4 * b * heads * n * n * d
    weights = (dim * 3 * hd + hd * dim) * (1 if int8 else 2)
    nbytes = 2 * m * dim * 2 + weights
    if int8:
        return bound(bf16_flops=attn, int8_ops=gemm, nbytes=nbytes)
    return bound(bf16_flops=gemm + attn, nbytes=nbytes)


def mlp(rows, dim, f, *, int8=False):
    """LN -> x W1 + b1 -> gelu -> h W2 + b2 (+ x) over ``rows`` tokens."""
    ops = 4 * rows * dim * f
    nbytes = 2 * rows * dim * 2 + 2 * dim * f * (1 if int8 else 2)
    return bound(int8_ops=ops, nbytes=nbytes) if int8 else bound(bf16_flops=ops, nbytes=nbytes)


def rows():
    """(row, what, (bound ms, bound by)) for S1-S7 at their scripts' shapes."""
    vit_l = dict(b=128, n=208, dim=1024, heads=16, d=64)  # N = 197 padded to 208
    block = attention_block(**vit_l)
    layer_ms = block[0] + mlp(128 * 208, 1024, 4096)[0]
    i8_mm = 2 * 4096 * 1024 * 1024
    return [
        ("S1", "scripts/tune_attn_core_r3.py: ViT-L attention block, B 128, N 208", block),
        ("S2", "scripts/tune_attn_core_r3b.py: the same block", block),
        ("S3", "scripts/tune_block_schedule.py: the block without its LN", block),
        ("S4", "scripts/tune_mixed_r3b.py: the block, phase 'full'", block),
        ("S5", "scripts/tune_mixed_r4.py: block + MLP (F 4096) in one kernel",
         (layer_ms, "operations")),
        ("S6", "scripts/tune_quant_r3.py: int8 attention block, B 128, N 224",
         attention_block(128, 224, 1024, 16, 64, int8=True)),
        ("S6", "scripts/tune_quant_r3.py: int8 MLP (inline), 128 x 224 rows, F 4096",
         mlp(128 * 224, 1024, 4096, int8=True)),
        ("S7", "scripts/probe_int8.py: int8 dot 4096 x 1024 x 1024 -> int32",
         bound(int8_ops=i8_mm, nbytes=4096 * 1024 + 1024 * 1024 + 4 * 4096 * 1024)),
    ]


def main() -> None:
    print("H100 bounds of the TPU sketch kernels (computed, not measured; "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s bf16, {PEAK_INT8 / 1e12:.0f} TOP/s int8, "
          f"{PEAK_BYTES / 1e12:.2f} TB/s)")
    for row, what, (ms, by) in rows():
        print(f"{row}  {ms:.4f} ms ({by})  {what}")


if __name__ == "__main__":
    main()
