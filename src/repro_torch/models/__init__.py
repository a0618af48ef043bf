"""The LM stack's models (the port of ``repro.models``): ``nn.Module``s
for the weights and the reference's functions on tensors."""

from .blocks import init_caches  # noqa: F401
from .convert import copy_tree, from_reference, to_reference  # noqa: F401
from .model import (  # noqa: F401
    LM,
    decode_step,
    forward,
    init_model,
    lm_loss,
    prefill,
    replicated_over_model,
)
