"""Utilities of the port."""

from vit_tpu_torch.utils.convert import from_jax_params  # noqa: F401
