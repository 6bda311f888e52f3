"""Utilities of the port."""

from vit_tpu_torch.utils.aot import (  # noqa: F401
    ExportedServing,
    export_forward,
    export_serving,
    load_forward,
)
from vit_tpu_torch.utils.bn_folding import fold_batch_norm, fold_batch_norm_state  # noqa: F401
from vit_tpu_torch.utils.convert import from_jax_params, from_jax_quant  # noqa: F401
from vit_tpu_torch.utils.debug import checked, debug_nans, kernel_sanitizer  # noqa: F401
from vit_tpu_torch.utils.health import memory_stats, probe_devices, with_retry  # noqa: F401
from vit_tpu_torch.utils.importer import (  # noqa: F401
    import_reference_cait_params,
    import_reference_cross_vit_params,
    import_reference_crossformer_params,
    import_reference_cvt_params,
    import_reference_deepvit_params,
    import_reference_levit_params,
    import_reference_lsa_params,
    import_reference_nest_params,
    import_reference_parallel_vit_params,
    import_reference_patch_merger_params,
    import_reference_pit_params,
    import_reference_region_vit_params,
    import_reference_scalable_vit_params,
    import_reference_simple_vit_params,
    import_reference_t2t_params,
    import_reference_twins_params,
    import_reference_vit_params,
)
from vit_tpu_torch.utils.init import init_params  # noqa: F401
from vit_tpu_torch.utils.interop import (  # noqa: F401
    export_vit_to_hf,
    hf_vit_config,
    import_hf_vit_params,
    vit_from_hf,
)
from vit_tpu_torch.utils.parity import fp64_vit_forward, max_logit_err  # noqa: F401
from vit_tpu_torch.utils.pos_embed import (  # noqa: F401
    adapt_vit_resolution,
    interpolate_pos_embedding,
)
from vit_tpu_torch.utils.quantize import (  # noqa: F401
    W8A8_KERNEL_MIN_BATCH,
    QuantSimpleViT,
    QuantViT,
    dequantize_weights,
    fake_quantize_weights,
    quantize_vit,
    quantize_weights,
    quantized_apply,
    resolve_quant_mode,
    simple_vit_apply_w8a8,
    tree_nbytes,
)
