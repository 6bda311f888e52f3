"""Int8 quantization (port of ``vit_tpu/utils/quantize.py``): the W8A8
encoder of ViT and SimpleViT (``quantize_vit``, ``resolve_quant_mode``,
``vit_apply_w8a8`` and ``simple_vit_apply_w8a8``), and the weight-only
transforms of every family (``quantize_weights``, ``fake_quantize_weights``,
``dequantize_weights``, ``quantized_apply``, ``tree_nbytes``).

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

A ViT with a qkv bias (a Hugging Face or timm checkpoint, ``utils.interop``)
quantizes to a ``QuantViT(qkv_bias=True)``: each layer keeps its fp32
``qkv_bias``, added in fp32 to the qkv product before its one rounding, as
``_encoder_w8a8`` adds it (vit_tpu/utils/quantize.py:276-285). The W8A8
attention-block kernel has no bias input, so ``"w8a8_kernel"`` raises for
such a model and ``"auto"`` runs ``"w8a8"`` where it would pick the kernel
mode (:270-283): kernel 3 (``ops.qkv_attention``) at every batch.

The weight-only transforms work on a model's ``state_dict`` and group the
int8 scales as ``vit_tpu``'s ``_quantize_leaf`` (:383-395) does on the same
leaf in ``vit_tpu``'s layout: one scale per trailing-axis channel, and per
leading-axis slice where that leaf has 3 or more axes. A layer of a scanned
stack (``model.jax_stages``) is a slice of a stacked leaf there, and a conv
kernel (OIHW here) is HWIO there, so the port maps each tensor's axes to
``vit_tpu``'s before it chooses them, and measures ``min_size`` on the
stacked leaf.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed, mean_tokens
from vit_tpu_torch.ops.block_attention import _ln_f32, _mm
from vit_tpu_torch.ops.fused_mlp import _activate
from vit_tpu_torch.ops.quant import (
    dequantize,
    int8_matmul,
    quantize_channelwise,
    quantize_symmetric,
)
from vit_tpu_torch.ops.quant_block import kmajor

# The JAX package's threshold, measured on a TPU v5e (vit_tpu/utils/quantize.py:84-94):
# the fused-kernel encoder from batch 8 up, XLA int8 at 2-7, weight-only at 1.
# Kept as it is; chip_smoke.py times every mode at batch 1, 8 and 128 on the card.
W8A8_KERNEL_MIN_BATCH = 8

MODES = ("w8", "w8a8", "w8a8_kernel")

# (module, weight) of the four int8 GEMM weights of a layer; each has a
# ``<weight>_scale`` buffer [1, N] beside it.
QUANT_WEIGHTS = (("attn", "qkv_kernel"), ("attn", "out_kernel"), ("ff", "w1"), ("ff", "w2"))

# vit_tpu/utils/quantize.py:80-83: the fused kernel has no qkv-bias input.
QKV_BIAS_KERNEL_ERROR = (
    "mode='w8a8_kernel' requires the raw-param layout without a qkv "
    "bias (the fused kernel has no bias input); this tree came from "
    "a qkv_bias=True model (HF/timm import) — use mode='w8a8'/'w8'/"
    "'auto' instead"
)

# The flax branch's attention names (a ViT with a qkv bias) -> the raw names
# of QuantAttention, as vit_tpu's quantize_vit renames them (:55-70).
_FLAX_ATTENTION = {"norm.scale": "norm_scale", "norm.bias": "norm_bias",
                   "to_qkv.kernel": "qkv_kernel", "to_qkv.bias": "qkv_bias",
                   "to_out.kernel": "out_kernel", "to_out.bias": "out_bias"}


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
    ``norm_bias``, ``out_bias`` (and ``qkv_bias`` ``[3*H*Dh]`` with
    ``qkv_bias=True``); int8 ``qkv_kernel`` ``[D, 3*H*Dh]`` and
    ``out_kernel`` ``[H*Dh, D]`` with their scales.

    The attention-block kernel reads the two int8 weights K-major (Hopper's
    8-bit wgmma takes no transposed operand), so the module keeps
    ``qkv_kernel_kmajor`` ``[3*H*Dh, D]`` and ``out_kernel_kmajor`` ``[D,
    H*Dh]`` beside them (``_KMajorCodes``). Code that writes ``qkv_kernel``
    or ``out_kernel`` in place otherwise calls ``refresh_kmajor``."""

    def __init__(self, dim: int, heads: int, dim_head: int, *, qkv_bias: bool = False,
                 device="cuda"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.norm_scale = p(dim, fill=1.0)
        self.norm_bias = p(dim)
        self.qkv_bias = p(3 * inner) if qkv_bias else None
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
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 qkv_bias: bool = False, device="cuda"):
        super().__init__()
        self.attn = QuantAttention(dim, heads, dim_head, qkv_bias=qkv_bias, device=device)
        self.ff = QuantFeedForward(dim, mlp_dim, device=device)

    def forward(self, x, mode: str, dtype, eps: float, activation: str):
        a, f = self.attn, self.ff
        scale = a.dim_head**-0.5
        if mode == "w8a8_kernel":
            if a.qkv_bias is not None:
                raise ValueError(QKV_BIAS_KERNEL_ERROR)
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
        qkv = qmm(xn, a.qkv_kernel, a.qkv_kernel_scale, bias=a.qkv_bias, out_dtype=dtype)
        ctx = ops.qkv_attention(qkv, a.heads, scale=scale)
        out = qmm(ctx, a.out_kernel, a.out_kernel_scale, bias=a.out_bias, out_dtype=torch.float32)
        x = (x.float() + out).to(dtype)
        xn = _ln_f32(x.float(), f.ln_scale, f.ln_bias, eps).to(dtype)
        h = qmm(xn, f.w1, f.w1_scale, bias=f.b1, out_dtype=torch.float32)
        h = _activate(h, activation).to(dtype)
        out = qmm(h, f.w2, f.w2_scale, bias=f.b2, out_dtype=torch.float32)
        return (x.float() + out).to(dtype)


def _check_mode(mode: str) -> None:
    if mode != "auto" and mode not in MODES:
        raise ValueError(f"mode must be 'auto' or one of {MODES}, got {mode!r}")


def _resolve(mode: str, batch: int, qkv_bias: bool) -> str:
    """The mode a forward runs: ``"auto"`` resolved by the batch size, and
    off the kernel mode for a qkv bias (vit_tpu/utils/quantize.py:276-285)."""
    if mode == "auto":
        mode = resolve_quant_mode(batch)
        if mode == "w8a8_kernel" and qkv_bias:
            mode = "w8a8"
    _check_mode(mode)
    if mode == "w8a8_kernel" and qkv_bias:
        raise ValueError(QKV_BIAS_KERNEL_ERROR)
    return mode


def _patch_embed_gemm(patch_embed: PatchEmbed, img: torch.Tensor, dtype) -> torch.Tensor:
    """Patchify and the patch-embed product: an fp32 sum of dtype-rounded
    operands plus the fp32 bias, rounded once to ``dtype``
    (vit_tpu/utils/quantize.py:_patch_embed_gemm)."""
    proj = patch_embed.proj
    x = ops.patchify(img, patch_embed.patch_size)
    return (_mm(x.to(dtype), proj.kernel.to(dtype)) + proj.bias).to(dtype)


class QuantViT(nn.Module):
    """W8A8 ViT: ``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    Takes ``ViT``'s arguments (less ``residual_dtype``) and ``mode``.
    ``dtype`` is the stream dtype (None: fp32). ``qkv_bias``: each layer
    carries its fp32 qkv bias (``w8a8_kernel`` then raises; ``auto`` runs
    ``w8a8`` from batch 2). Parameters and buffers are built on the card
    unless ``device`` says otherwise; build one with ``quantize_vit`` or
    load ``from_jax_quant``'s state dict."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 channels: int = 3, qkv_bias: bool = False, activation: str = "gelu",
                 norm_eps: float = 1e-6, dtype: Optional[torch.dtype] = None, mode: str = "auto",
                 device="cuda"):
        super().__init__()
        _check_mode(mode)
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw or ph != pw:
            raise ValueError("square patches that divide the image only")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.mode, self.pool, self.dtype, self.qkv_bias = mode, pool, dtype, qkv_bias
        self.activation, self.norm_eps = activation, norm_eps
        num_patches = (ih // ph) * (iw // pw)
        self.patch_embed = PatchEmbed(dim, ph, channels, device=device)  # parameters only
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(
            QuantEncoderBlock(dim, heads, dim_head, mlp_dim, qkv_bias=qkv_bias, device=device)
            for _ in range(depth)
        )
        self.head_norm = LayerNorm(dim, eps=norm_eps, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` images -> the encoder's input ``[B, N, D]`` in
        the stream dtype."""
        dtype = self.dtype or torch.float32
        x = _patch_embed_gemm(self.patch_embed, img, dtype)
        b, _, dim = x.shape
        cls = self.cls.to(dtype).expand(b, 1, dim)
        return torch.cat([cls, x], dim=1) + self.pos_embedding.to(dtype)

    def forward(self, img: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        mode = _resolve(mode or self.mode, img.shape[0], self.qkv_bias)
        dtype = self.dtype or torch.float32
        x = self.embed(img)
        for block in self.encoder.blocks:
            x = block(x, mode, dtype, self.norm_eps, self.activation)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return self.head(self.head_norm(x))


class QuantSimpleViT(nn.Module):
    """W8A8 SimpleViT (the model of ``simple_vit_apply_w8a8``,
    vit_tpu/utils/quantize.py:514-546): the patch embedding as
    ``QuantViT``'s, plus the fixed sin-cos positions in the stream dtype; the
    quantized encoder at LayerNorm eps 1e-5 with the tanh GELU; the mean of
    the tokens; the head LayerNorm without bias (eps 1e-5) and the head in
    fp32. Takes ``SimpleViT``'s arguments and ``mode``; build one with
    ``quantize_vit``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, channels: int = 3, dim_head: int = 64,
                 channels_first: bool = False, dtype: Optional[torch.dtype] = None,
                 mode: str = "auto", device="cuda"):
        super().__init__()
        _check_mode(mode)
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw or ph != pw:
            raise ValueError("square patches that divide the image only")
        self.mode, self.dtype, self.channels_first = mode, dtype, channels_first
        self.patch_embed = PatchEmbed(dim, ph, channels, device=device)  # parameters only
        self.register_buffer("pos_sincos", ops.posemb_sincos_2d(
            ih // ph, iw // pw, dim, dtype=dtype or torch.float32).to(device), persistent=False)
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(
            QuantEncoderBlock(dim, heads, dim_head, mlp_dim, device=device) for _ in range(depth)
        )
        self.head_norm = LayerNorm(dim, eps=1e-5, use_bias=False, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        mode = _resolve(mode or self.mode, img.shape[0], False)
        dtype = self.dtype or torch.float32
        if self.channels_first:
            img = img.permute(0, 2, 3, 1)
        x = _patch_embed_gemm(self.patch_embed, img, dtype)
        x = x + self.pos_sincos.to(x.dtype)
        for block in self.encoder.blocks:
            x = block(x, mode, dtype, 1e-5, "gelu")
        return self.head(self.head_norm(mean_tokens(x)))


def quantize_vit(model: nn.Module, *, mode: str = "auto") -> nn.Module:
    """Quantize a ``vit_tpu_torch.models.ViT`` into a ``QuantViT`` (a
    ``SimpleViT`` into a ``QuantSimpleViT``) on the same device: every
    encoder GEMM weight per output channel (``quantize_channelwise``),
    everything else copied. A ViT with a qkv bias keeps it, under
    ``QuantAttention``'s raw names, as vit_tpu's ``quantize_vit`` renames
    the flax branch's (vit_tpu/utils/quantize.py:55-70). The model is not
    changed."""
    from vit_tpu_torch.models import SimpleViT

    state = {}
    for key, value in model.state_dict().items():
        head, _, leaf = key.partition(".attn.")
        state[f"{head}.attn.{_FLAX_ATTENTION.get(leaf, leaf)}" if leaf else key] = value.detach()
    depth = len(model.encoder.blocks)
    for i in range(depth):
        for mod, name in QUANT_WEIGHTS:
            key = f"encoder.blocks.{i}.{mod}.{name}"
            state[key], state[f"{key}_scale"] = quantize_channelwise(state[key])
    device = next(model.parameters()).device
    cls = QuantSimpleViT if isinstance(model, SimpleViT) else QuantViT
    qmodel = cls(**model.config, mode=mode, device=device)
    qmodel.load_state_dict(state, strict=True)
    return qmodel.eval()


def simple_vit_apply_w8a8(qmodel: QuantSimpleViT, img: torch.Tensor,
                          mode: str = "w8a8") -> torch.Tensor:
    """The quantized SimpleViT forward (vit_tpu/utils/quantize.py:514-546)
    of ``qmodel = quantize_vit(simple_vit)`` in ``mode``: ``"w8"``,
    ``"w8a8"``, ``"w8a8_kernel"`` (kernels 9 and 10 on the card; SimpleViT
    has no qkv bias) or ``"auto"``. The JAX function takes the float model
    and the quantized tree apart; ``QuantSimpleViT`` holds both."""
    if not isinstance(qmodel, QuantSimpleViT):
        raise TypeError(f"simple_vit_apply_w8a8 takes a QuantSimpleViT, got {type(qmodel)}")
    return qmodel(img, mode=mode)


# -- generic weight-only compression (every family) ----------------------------------

# vit_tpu/utils/quantize.py:378: the leaf names quantize_weights compresses.
W8_KEYS = ("kernel", "w1", "w2", "qkv_kernel", "out_kernel", "q_kernel", "k_kernel",
           "v_kernel")
_CONV_TO_HWIO = (2, 3, 1, 0)  # the port's OIHW axes in vit_tpu's HWIO order


def _stacked_depth(key: str, stages: Mapping[str, int]) -> Optional[int]:
    """The depth of the scanned stack whose layer holds ``key`` in
    ``vit_tpu``'s tree (None where ``vit_tpu`` keeps the leaf unstacked): a
    stage of ``model.jax_stages`` deeper than 1."""
    for stage, depth in stages.items():
        prefix = stage.replace("/", ".") + "."
        if key.startswith(prefix) and key[len(prefix):].split(".", 1)[0].isdigit():
            return depth if depth > 1 else None
    return None


def _w8_plan(state: Mapping[str, torch.Tensor], stages, min_size: int, keys) -> Dict[str, tuple]:
    """The leaves ``vit_tpu``'s ``quantize_weights`` compresses, each with
    the port axes to reduce for its scale: ``_quantize_leaf``'s axes
    (1 if ndim >= 3 else 0) .. ndim - 2 of the leaf in ``vit_tpu``'s layout,
    where the size ``min_size`` is measured too. That layout puts a 4-D
    ``kernel`` (a conv, OIHW here) in HWIO order, and a stacked layer's
    leaf behind the stack's depth axis (``None`` below)."""
    plan = {}
    for key, t in state.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf not in keys or not torch.is_floating_point(t):
            continue
        order = _CONV_TO_HWIO if leaf == "kernel" and t.dim() == 4 else tuple(range(t.dim()))
        depth = _stacked_depth(key, stages)
        axes = (() if depth is None else (None,)) + order
        if len(axes) < 2 or t.numel() * (depth or 1) < min_size:
            continue
        reduce = axes[1 if len(axes) >= 3 else 0:len(axes) - 1]
        if None in reduce:
            raise NotImplementedError(f"{key}: vit_tpu's scale would span the layers of a stack")
        plan[key] = tuple(reduce)
    return plan


def quantize_weights(model: nn.Module, *, min_size: int = 16384,
                     keys=W8_KEYS) -> Dict[str, Any]:
    """Weight-only int8 of any family (vit_tpu/utils/quantize.py:398-432):
    ``model``'s ``state_dict`` with every float weight named in ``keys``, of
    2 or more axes and ``min_size`` values in ``vit_tpu``'s layout (the
    stages of ``model.jax_stages`` stacked), replaced by ``{"__w8__": int8
    codes, "__scale__": fp32 scales}`` (the scales keep the reduced axes as
    size 1). Norms, biases, BatchNorm statistics, tokens and small layers
    stay as they are. The codes and scales are ``vit_tpu``'s, axes permuted
    and layers unstacked as ``from_jax_params`` does."""
    state = model.state_dict()
    plan = _w8_plan(state, getattr(model, "jax_stages", {}), min_size, keys)
    out = {}
    for key, t in state.items():
        if key in plan:
            codes, scale = quantize_symmetric(t.detach(), plan[key])
            out[key] = {"__w8__": codes, "__scale__": scale}
        else:
            out[key] = t
    return out


def fake_quantize_weights(model: nn.Module, *, min_size: int = 16384,
                          keys=W8_KEYS) -> Dict[str, torch.Tensor]:
    """The straight-through view of ``model``'s parameters for weight-only
    QAT (vit_tpu/utils/quantize.py:435-471): each weight ``quantize_weights``
    would compress becomes ``w + (qdq(w) - w).detach()``, whose value is the
    deployed ``quantized_apply`` weight bit for bit (``w + (q - w)`` is exact
    in fp32: q lies within half a scale step of w) and whose gradient is the
    identity; every other parameter is itself. By name, as
    ``named_parameters`` gives them."""
    params = dict(model.named_parameters())
    plan = _w8_plan({k: p.detach() for k, p in params.items()},
                    getattr(model, "jax_stages", {}), min_size, keys)
    out = {}
    for key, w in params.items():
        if key in plan:
            codes, scale = quantize_symmetric(w.detach(), plan[key])
            out[key] = w + ((codes.float() * scale).to(w.dtype) - w).detach()
        else:
            out[key] = w
    return out


@contextlib.contextmanager
def fake_quantized(model: nn.Module, **kw):
    """Inside the scope, ``model``'s compressible weights are their
    ``fake_quantize_weights`` views (forward and backward: a remat
    recompute in the backward reads the same views); the gradients reach the
    float parameters. ``kw``: ``fake_quantize_weights``'s."""
    views = {k: t for k, t in fake_quantize_weights(model, **kw).items()
             if not isinstance(t, nn.Parameter)}
    saved = []
    try:
        for key, t in views.items():
            owner, _, leaf = key.rpartition(".")
            mod = model.get_submodule(owner)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield views
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


def dequantize_weights(qstate: Mapping[str, Any], dtype=torch.float32) -> Dict[str, Any]:
    """Inverse of ``quantize_weights``: a state dict with each compressed
    weight ``(codes * scale)`` in fp32, cast to ``dtype``."""
    return {k: (v["__w8__"].float() * v["__scale__"]).to(dtype)
            if isinstance(v, Mapping) and "__w8__" in v else v for k, v in qstate.items()}


def quantized_apply(model: nn.Module, qstate: Mapping[str, Any], *args, dtype=torch.float32,
                    **kwargs):
    """``model(*args, **kwargs)`` with the weights of a ``quantize_weights``
    state (vit_tpu/utils/quantize.py:488-497): the int8 tables stay
    resident and each call dequantizes them into a transient float state
    (``torch.func.functional_call``), so each family's kernels run as with
    the float model. The model's own parameters are not read or changed."""
    return torch.func.functional_call(model, dequantize_weights(qstate, dtype), args, kwargs)


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree`` (nested mappings, as
    ``quantize_weights`` gives them; a module counts its ``state_dict``)."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0
