from .from_jax import params_from_numpy  # noqa: F401
from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .calibrate import (calibrate_act_scales, load_act_scales,  # noqa: F401
                        save_act_scales)
from .hf import quantize_hf_model, load_hf_state_dict  # noqa: F401
from .from_float import requantize  # noqa: F401
from .lora import (attach_lora, build_lora_stack,  # noqa: F401
                   merge_lora_into_state_dict)
