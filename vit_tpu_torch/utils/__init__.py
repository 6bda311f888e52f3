"""Utilities of the port."""

from vit_tpu_torch.utils.bn_folding import fold_batch_norm  # noqa: F401
from vit_tpu_torch.utils.convert import from_jax_params, from_jax_quant  # noqa: F401
from vit_tpu_torch.utils.init import init_params  # noqa: F401
from vit_tpu_torch.utils.pos_embed import (  # noqa: F401
    adapt_vit_resolution,
    interpolate_pos_embedding,
)
from vit_tpu_torch.utils.quantize import (  # noqa: F401
    W8A8_KERNEL_MIN_BATCH,
    QuantViT,
    quantize_vit,
    resolve_quant_mode,
)
