from .from_jax import params_from_numpy  # noqa: F401
from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
