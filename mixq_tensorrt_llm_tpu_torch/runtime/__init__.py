from .sampler import SamplingConfig  # noqa: F401
from .kv_cache import BlockManager, PagedKVState, init_paged_kv  # noqa: F401
from .scheduler import Executor, Request  # noqa: F401
from .session import GenerationOutput, GenerationSession  # noqa: F401
from .medusa import MedusaStats, build_tree, medusa_generate  # noqa: F401
from .redrafter import (ReDrafterStats, init_random_drafter,  # noqa: F401
                        redrafter_generate)
