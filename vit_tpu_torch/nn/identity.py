"""Identity module (port of ``vit_tpu/nn/identity.py``: the reference's
``IdentityLayer``, a stage or branch placeholder)."""

from torch import nn


class Identity(nn.Module):
    """Returns its input; takes and ignores any other arguments."""

    def forward(self, x, *args, **kwargs):
        return x
