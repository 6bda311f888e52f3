"""Module layer of the port (mirrors ``vit_tpu/nn``)."""

from vit_tpu_torch.nn.attention import Attention  # noqa: F401
from vit_tpu_torch.nn.blocks import EncoderBlock, FeedForward, Transformer  # noqa: F401
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed  # noqa: F401
