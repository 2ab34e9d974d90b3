"""act_scales calibration: per-input-channel activation absmax capture.
Counterpart of mixq_tensorrt_llm_tpu/convert/calibrate.py.

The float model runs ``models.common.forward(collect_stats=True,
full_prefill=True)`` over calibration batches (on the card in the model's
dtype, K14 for an MHA prefill); the running per-channel absmax is keyed as
the reference's calibration artifact (``model.layers.{i}.{module}``, its
``act_scales/*.pt`` files), so artifacts interchange with it and with the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..models import common as mcommon
from ..models.common import ModelConfig

# the port's fused-module stats -> the reference's per-module key names;
# the fused inputs are shared (qkv <- q/k/v, gate_up <- gate/up), so one
# capture covers them all
_KEY_MAP = {
    "qkv_proj": ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
    "o_proj": ("self_attn.o_proj",),
    "gate_up_proj": ("mlp.gate_proj", "mlp.up_proj"),
    "down_proj": ("mlp.down_proj",),
}


def calibrate_act_scales(params_float: Dict, cfg: ModelConfig,
                         token_batches: Iterable,
                         max_seq_len: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """Float-model forwards over calibration batches (each (B, S) or (S,)
    token ids) on the params' device -> {"model.layers.{i}.{module}": f32
    absmax (in,)} on the CPU."""
    if cfg.quant.enabled:
        raise ValueError("calibrate on the float (unquantized) model")
    if cfg.arch in mcommon.RECURRENT_ARCHS:
        # the JAX package's recurrent-state forward asserts on collect_stats
        raise NotImplementedError(
            f"{cfg.arch}: act_scales calibration is not supported for the "
            "recurrent-state models (their forward collects no stats)")
    dev = params_float["embed"]["w"].device
    running: Optional[Dict[str, torch.Tensor]] = None
    for batch in token_batches:
        batch = np.asarray(batch, np.int32)
        if batch.ndim == 1:
            batch = batch[None]
        if max_seq_len:
            batch = batch[:, :max_seq_len]
        b, s = batch.shape
        tokens = torch.from_numpy(batch).to(dev)
        cache = mcommon.init_kv_cache(cfg, b, s, device=dev)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        # the head runs on one position only: stats do not read the logits
        _, _, stats = mcommon.forward(params_float, cfg, tokens, pos, cache,
                                      lens, collect_stats=True,
                                      full_prefill=True, last_pos=lens - 1)
        running = stats if running is None else {
            m: torch.maximum(running[m], st) for m, st in stats.items()}
    if running is None:
        raise ValueError("no calibration batches given")
    out: Dict[str, torch.Tensor] = {}
    for module, stacked in running.items():
        arr = stacked.float().cpu()                 # (L, in)
        for i in range(cfg.num_layers):
            for ref_key in _KEY_MAP[module]:
                out[f"model.layers.{i}.{ref_key}"] = arr[i]
    return out


def load_act_scales(path: str) -> Dict[str, torch.Tensor]:
    """An act_scales artifact (.pt torch dict, the reference's, or .npz) ->
    {key: f32 CPU tensor}."""
    if path.endswith(".pt"):
        d = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in d.items()}
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k].astype(np.float32))
                for k in data.files}


def save_act_scales(scales: Mapping, path: str) -> None:
    """{key: (in,) tensor or array} -> an .npz of f32 arrays."""
    if not path.endswith(".npz"):
        raise ValueError(f"act_scales are saved as .npz, not {path}")
    np.savez(path, **{k: np.asarray(torch.as_tensor(v).float().cpu(),
                                    np.float32)
                      for k, v in scales.items()})
