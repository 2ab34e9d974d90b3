from .common import (KVCache, ModelConfig, forward,  # noqa: F401
                     forward_paged, init_kv_cache)
from . import llama  # noqa: F401
