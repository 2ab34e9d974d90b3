from .sampler import SamplingConfig  # noqa: F401
from .kv_cache import BlockManager, PagedKVState, init_paged_kv  # noqa: F401
from .scheduler import Executor, Request  # noqa: F401
from .session import GenerationOutput, GenerationSession  # noqa: F401
