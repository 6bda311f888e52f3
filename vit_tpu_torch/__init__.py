"""vit-tpu-torch: the PyTorch / CUDA port of ``vit_tpu``, for NVIDIA Hopper.

The JAX package ``vit_tpu`` stays the reference; this package mirrors its
layout and names so each module has an obvious counterpart:

- ``vit_tpu_torch.ops``      — hand-written Hopper kernels (``csrc/*.cu``,
                               built with ``nvcc`` at first use) beside their
                               plain PyTorch twins, and the dispatch between
                               them (CPU tensor -> twin, CUDA tensor -> kernel).
- ``vit_tpu_torch.nn``       — patch embedding, fused self-attention block,
                               feed-forward block, encoder stack.
- ``vit_tpu_torch.models``   — ``ViT``.
- ``vit_tpu_torch.utils``    — ``from_jax_params``: ``vit_tpu`` variables ->
                               this package's ``state_dict``.
- ``vit_tpu_torch.pipeline`` — on-device preprocess + bucketed batches.
- ``vit_tpu_torch.data``     — native JPEG decode front-end.
- ``vit_tpu_torch.serving``  — dynamic request batching.

Importing the package builds and loads no CUDA code, and never imports JAX.
"""

from vit_tpu_torch.models import ViT  # noqa: F401

__version__ = "0.1.0"
