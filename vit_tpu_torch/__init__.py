"""vit-tpu-torch: the PyTorch / CUDA port of ``vit_tpu``, for NVIDIA Hopper.

The JAX package ``vit_tpu`` stays the reference; this package mirrors its
layout and names so each module has an obvious counterpart:

- ``vit_tpu_torch.ops``      — hand-written Hopper kernels (``csrc/*.cu``,
                               built with ``nvcc`` at first use) beside their
                               plain PyTorch twins, and the dispatch between
                               them (CPU tensor -> twin, CUDA tensor -> kernel).
- ``vit_tpu_torch.nn``       — patch embedding, attention (the fused
                               self-attention blocks, with CaiT's talking
                               heads or DeepViT's re-attention, CaiT's class
                               cross-attention, ``mha_tokens``), feed-forward
                               block, the routed expert MLP (MoE), encoder
                               stack, conv modules (PEG, patch embedding,
                               conv MLP).
- ``vit_tpu_torch.models``   — the 18 families of ``vit_tpu/models`` and
                               ``ViTMoE``; ``MODEL_REGISTRY`` (tiny configs),
                               ``REFERENCE_PRESETS`` and ``create``.
- ``vit_tpu_torch.utils``    — ``from_jax_params`` / ``from_jax_quant``:
                               ``vit_tpu`` trees -> this package's
                               ``state_dict``; ``quantize_vit`` -> ``QuantViT``,
                               the int8 (W8A8) ViT; ``fold_batch_norm``;
                               position-table resizing (``pos_embed``).
- ``python -m vit_tpu_torch`` — ``list``, ``smoke``, ``version``.
- ``vit_tpu_torch.pipeline`` — on-device preprocess + bucketed batches.
- ``vit_tpu_torch.data``     — native JPEG decode front-end.
- ``vit_tpu_torch.serving``  — dynamic request batching.

Models are built on the card unless the caller passes ``device="cpu"``.
Importing the package builds and loads no CUDA code, and never imports JAX.
"""

from vit_tpu_torch.models import CaiT, DeepViT, T2TViT, TwinsSVT, ViT  # noqa: F401

__version__ = "0.1.0"
