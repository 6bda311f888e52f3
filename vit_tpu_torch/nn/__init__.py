"""Module layer of the port (mirrors ``vit_tpu/nn``)."""

from vit_tpu_torch.nn.attention import Attention, mha_tokens  # noqa: F401
from vit_tpu_torch.nn.bias import (  # noqa: F401
    DynamicPositionBias,
    LeViTAttentionBias,
    ReferenceWindowRelPosBias,
    WindowRelPosBias,
)
from vit_tpu_torch.nn.blocks import EncoderBlock, FeedForward, Transformer  # noqa: F401
from vit_tpu_torch.nn.conv import (  # noqa: F401
    PEG,
    Aggregate,
    Conv,
    ConvMLP,
    CrossEmbedLayer,
    DepthWiseConv2d,
    Downsample,
    PatchEmbedding,
    Pool,
)
from vit_tpu_torch.nn.embed import (  # noqa: F401
    SPT,
    BatchNorm,
    Dense,
    LayerNorm,
    PatchEmbed,
    PatchMerger,
    ProjectInOut,
    mean_tokens,
)
from vit_tpu_torch.nn.identity import Identity  # noqa: F401
from vit_tpu_torch.nn.moe import MoEFeedForward  # noqa: F401
