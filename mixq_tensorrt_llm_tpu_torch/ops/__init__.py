from . import ref  # noqa: F401
from . import norm_quant  # noqa: F401
from . import mixed_matmul  # noqa: F401
from . import wo_matmul  # noqa: F401
from . import dispatch  # noqa: F401
from . import paged_write  # noqa: F401
from . import paged_attention  # noqa: F401
from . import attention  # noqa: F401
