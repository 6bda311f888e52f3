"""Post-training W8A8 quantization of the ViT encoder (port of
``vit_tpu/utils/quantize.py``: ``quantize_vit``, ``resolve_quant_mode``,
``vit_apply_w8a8`` and the helpers they share).

``quantize_vit(model)`` turns a ``ViT`` into a ``QuantViT``: the four
encoder GEMM weights of every layer become int8 buffers with one fp32 scale
per output channel (``ops/quant.py``); LayerNorms, biases, the patch embed,
the class token, the positions and the head stay fp32 parameters.
``QuantViT(mode=...)`` is the counterpart of ``vit_apply_w8a8``:

- ``"w8"``: weight-only; each weight is dequantized into the stream dtype
  and the product is an fp32 sum of dtype-rounded operands, the bias added
  before the one rounding;
- ``"w8a8"``: the four GEMMs as ``int8_matmul`` (dynamic per-row int8
  activations, exact int32 sums), attention through ``ops.qkv_attention``;
- ``"w8a8_kernel"``: each layer is two fused ops, ``ops.quant_attention_block``
  and ``ops.quant_mlp``;
- ``"auto"`` (the default): the mode ``resolve_quant_mode`` picks for the
  batch size.

As in the JAX package, the stream is the model's ``dtype`` (fp32 when
None); a ``residual_dtype`` of the float model is ignored. The JAX kernel
mode pads the stream to the Mosaic int8 tile (32 rows) and masks the padded
keys; the port runs at the real token count, which gives the same rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed
from vit_tpu_torch.ops.block_attention import _ln_f32, _mm
from vit_tpu_torch.ops.fused_mlp import _activate
from vit_tpu_torch.ops.quant import dequantize, int8_matmul, quantize_channelwise
from vit_tpu_torch.ops.quant_block import kmajor

# The JAX package's threshold, measured on a TPU v5e (vit_tpu/utils/quantize.py:84-94):
# the fused-kernel encoder from batch 8 up, XLA int8 at 2-7, weight-only at 1.
# Kept as it is; chip_smoke.py times every mode at batch 1, 8 and 128 on the card.
W8A8_KERNEL_MIN_BATCH = 8

MODES = ("w8", "w8a8", "w8a8_kernel")

# (module, weight) of the four int8 GEMM weights of a layer; each has a
# ``<weight>_scale`` buffer [1, N] beside it.
QUANT_WEIGHTS = (("attn", "qkv_kernel"), ("attn", "out_kernel"), ("ff", "w1"), ("ff", "w2"))


def resolve_quant_mode(batch: int) -> str:
    """The mode ``"auto"`` runs at a batch size."""
    if batch >= W8A8_KERNEL_MIN_BATCH:
        return "w8a8_kernel"
    if batch > 1:
        return "w8a8"
    return "w8"


def _make_qmm(mode: str, dtype):
    if mode == "w8a8":
        return int8_matmul

    def qmm(x, w_i8, w_scale, bias=None, out_dtype=None):
        out = _mm(x.to(dtype), dequantize(w_i8, w_scale, dtype))
        if bias is not None:
            out = out + bias.float()
        return out.to(out_dtype or x.dtype)

    return qmm


def _int8_buffer(module: nn.Module, name: str, k: int, n: int, device) -> None:
    module.register_buffer(name, torch.zeros(k, n, dtype=torch.int8, device=device))
    module.register_buffer(f"{name}_scale", torch.ones(1, n, device=device))


def _refresh_kmajor(module: "_KMajorCodes", incompatible_keys) -> None:
    module.refresh_kmajor()


class _KMajorCodes(nn.Module):
    """A module whose int8 weights (``[in, out]``) the W8A8 kernels read
    K-major: ``keep_kmajor`` gives each a non-persistent copy
    ``<name>_kmajor`` (``[out, in]``), derived now and again after every
    ``load_state_dict``, so that the state dict keeps vit_tpu's layout and no
    forward transposes a weight."""

    def keep_kmajor(self, *names: str) -> None:
        self.kmajor_names = names
        for name in names:
            self.register_buffer(f"{name}_kmajor", kmajor(getattr(self, name)), persistent=False)
        self.register_load_state_dict_post_hook(_refresh_kmajor)

    @torch.no_grad()
    def refresh_kmajor(self) -> None:
        """Derive the K-major copies from the ``[in, out]`` codes (after an
        in-place write of a weight)."""
        for name in self.kmajor_names:
            getattr(self, f"{name}_kmajor").copy_(getattr(self, name).t())


class QuantAttention(_KMajorCodes):
    """The attention half of a quantized layer: fp32 ``norm_scale``,
    ``norm_bias``, ``out_bias``; int8 ``qkv_kernel`` ``[D, 3*H*Dh]`` and
    ``out_kernel`` ``[H*Dh, D]`` with their scales.

    The attention-block kernel reads the two int8 weights K-major (Hopper's
    8-bit wgmma takes no transposed operand), so the module keeps
    ``qkv_kernel_kmajor`` ``[3*H*Dh, D]`` and ``out_kernel_kmajor`` ``[D,
    H*Dh]`` beside them (``_KMajorCodes``). Code that writes ``qkv_kernel``
    or ``out_kernel`` in place otherwise calls ``refresh_kmajor``."""

    def __init__(self, dim: int, heads: int, dim_head: int, *, device="cuda"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.norm_scale = p(dim, fill=1.0)
        self.norm_bias = p(dim)
        self.out_bias = p(dim)
        _int8_buffer(self, "qkv_kernel", dim, 3 * inner, device)
        _int8_buffer(self, "out_kernel", inner, dim, device)
        self.keep_kmajor("qkv_kernel", "out_kernel")


class QuantFeedForward(_KMajorCodes):
    """The MLP half of a quantized layer: fp32 ``ln_scale``, ``ln_bias``,
    ``b1``, ``b2``; int8 ``w1`` ``[D, F]`` and ``w2`` ``[F, D]`` with their
    scales.

    The MLP kernel reads both int8 weights K-major too, so the module keeps
    ``w1_kmajor`` ``[F, D]`` and ``w2_kmajor`` ``[D, F]`` beside them
    (``_KMajorCodes``)."""

    def __init__(self, dim: int, hidden_dim: int, *, device="cuda"):
        super().__init__()
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.ln_scale = p(dim, fill=1.0)
        self.ln_bias = p(dim)
        self.b1 = p(hidden_dim)
        self.b2 = p(dim)
        _int8_buffer(self, "w1", dim, hidden_dim, device)
        _int8_buffer(self, "w2", hidden_dim, dim, device)
        self.keep_kmajor("w1", "w2")


class QuantEncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *, device="cuda"):
        super().__init__()
        self.attn = QuantAttention(dim, heads, dim_head, device=device)
        self.ff = QuantFeedForward(dim, mlp_dim, device=device)

    def forward(self, x, mode: str, dtype, eps: float, activation: str):
        a, f = self.attn, self.ff
        scale = a.dim_head**-0.5
        if mode == "w8a8_kernel":
            x = ops.quant_attention_block(
                x, a.norm_scale, a.norm_bias, a.qkv_kernel, a.qkv_kernel_scale,
                a.out_kernel, a.out_kernel_scale, a.out_bias, a.heads, scale=scale, ln_eps=eps,
                kmajor=(a.qkv_kernel_kmajor, a.out_kernel_kmajor),
            ).to(dtype)
            return ops.quant_mlp(
                x, f.ln_scale, f.ln_bias, f.w1, f.w1_scale, f.b1, f.w2, f.w2_scale, f.b2,
                activation=activation, ln_eps=eps, kmajor=(f.w1_kmajor, f.w2_kmajor),
            ).to(dtype)
        qmm = _make_qmm(mode, dtype)
        xn = _ln_f32(x.float(), a.norm_scale, a.norm_bias, eps).to(dtype)
        qkv = qmm(xn, a.qkv_kernel, a.qkv_kernel_scale, out_dtype=dtype)
        ctx = ops.qkv_attention(qkv, a.heads, scale=scale)
        out = qmm(ctx, a.out_kernel, a.out_kernel_scale, bias=a.out_bias, out_dtype=torch.float32)
        x = (x.float() + out).to(dtype)
        xn = _ln_f32(x.float(), f.ln_scale, f.ln_bias, eps).to(dtype)
        h = qmm(xn, f.w1, f.w1_scale, bias=f.b1, out_dtype=torch.float32)
        h = _activate(h, activation).to(dtype)
        out = qmm(h, f.w2, f.w2_scale, bias=f.b2, out_dtype=torch.float32)
        return (x.float() + out).to(dtype)


class QuantViT(nn.Module):
    """W8A8 ViT: ``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    Takes ``ViT``'s arguments (less ``residual_dtype``) and ``mode``.
    ``dtype`` is the stream dtype (None: fp32). Parameters and buffers are
    built on the card unless ``device`` says otherwise; build one with
    ``quantize_vit`` or load ``from_jax_quant``'s state dict."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 channels: int = 3, activation: str = "gelu", norm_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, mode: str = "auto", device="cuda"):
        super().__init__()
        if mode != "auto" and mode not in MODES:
            raise ValueError(f"mode must be 'auto' or one of {MODES}, got {mode!r}")
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw or ph != pw:
            raise ValueError("square patches that divide the image only")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.mode, self.pool, self.dtype = mode, pool, dtype
        self.activation, self.norm_eps = activation, norm_eps
        num_patches = (ih // ph) * (iw // pw)
        self.patch_embed = PatchEmbed(dim, ph, channels, device=device)  # parameters only
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(
            QuantEncoderBlock(dim, heads, dim_head, mlp_dim, device=device) for _ in range(depth)
        )
        self.head_norm = LayerNorm(dim, eps=norm_eps, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` images -> the encoder's input ``[B, N, D]`` in
        the stream dtype."""
        dtype = self.dtype or torch.float32
        # patch embed: fp32 product of dtype-rounded operands, rounded once
        proj = self.patch_embed.proj
        x = ops.patchify(img, self.patch_embed.patch_size)
        x = (_mm(x.to(dtype), proj.kernel.to(dtype)) + proj.bias).to(dtype)
        b, _, dim = x.shape
        cls = self.cls.to(dtype).expand(b, 1, dim)
        return torch.cat([cls, x], dim=1) + self.pos_embedding.to(dtype)

    def forward(self, img: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        mode = mode or self.mode
        if mode == "auto":
            mode = resolve_quant_mode(img.shape[0])
        if mode not in MODES:
            raise ValueError(f"mode must be 'auto' or one of {MODES}, got {mode!r}")
        dtype = self.dtype or torch.float32
        x = self.embed(img)
        for block in self.encoder.blocks:
            x = block(x, mode, dtype, self.norm_eps, self.activation)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return self.head(self.head_norm(x))


def quantize_vit(model: nn.Module, *, mode: str = "auto") -> QuantViT:
    """Quantize a ``vit_tpu_torch.models.ViT`` into a ``QuantViT`` on the
    same device: every encoder GEMM weight per output channel
    (``quantize_channelwise``), everything else copied. The model is not
    changed."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    depth = len(model.encoder.blocks)
    for i in range(depth):
        for mod, name in QUANT_WEIGHTS:
            key = f"encoder.blocks.{i}.{mod}.{name}"
            state[key], state[f"{key}_scale"] = quantize_channelwise(state[key])
    device = next(model.parameters()).device
    qmodel = QuantViT(**model.config, mode=mode, device=device)
    qmodel.load_state_dict(state, strict=True)
    return qmodel.eval()
