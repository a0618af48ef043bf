from .adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from .compress import (  # noqa: F401
    compressed_psum,
    ef_roundtrip,
    ef_state_init,
    int8_compress,
    int8_decompress,
    topk_compress,
    topk_decompress,
)
