"""Medusa decoding: self-drafting heads verified with tree attention.
Counterpart of runtime/medusa.py.

The tree is static per call: one verify forward runs every node at once
under an explicit ancestor mask (``models.common.forward(attn_mask=...)``)
with the nodes' true positions for RoPE (``rope_pos``), while their KV goes
to consecutive cache slots. Acceptance is the greedy walk (a node's token
must equal the argmax of its parent's logits), so the output equals plain
greedy decoding whatever the heads propose; trained heads only change how
far each step advances. The accepted path's KV rows are then moved from
their tree slots to consecutive positions (``compact``).

On the card the verify's rows (11 for the default tree) take the mixed
path (K1 -> K2) and the prefill K14 (``full_prefill``); the masked
attention over the dense cache is plain torch, as the JAX package leaves
it to XLA. Medusa is greedy only, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import common as mcommon
from ..models.common import KVCache, ModelConfig
from ..quant import core as qcore
from .beam import _top_k
from .scheduler import read_back

# a small default tree: 4 heads, 10 nodes (chains plus first-level
# branching)
DEFAULT_CHOICES = [
    (0,), (0, 0), (0, 0, 0), (0, 0, 0, 0),
    (1,), (1, 0), (2,), (0, 1), (0, 1, 0), (0, 0, 1),
]


@dataclass(frozen=True)
class MedusaTree:
    """Static tree: per node its 1-based depth, parent (-1 = the root),
    branch index at its level; per head the candidates it must give."""
    depths: np.ndarray
    parents: np.ndarray
    branch: np.ndarray
    topks: np.ndarray
    num_heads: int

    @property
    def num_nodes(self) -> int:
        return len(self.depths)


def build_tree(choices: Sequence[Tuple[int, ...]]) -> MedusaTree:
    """choices: paths of per-level branch indices. The nodes are their
    unique prefixes, in BFS order."""
    prefixes = set()
    for path in choices:
        for d in range(1, len(path) + 1):
            prefixes.add(tuple(path[:d]))
    nodes = sorted(prefixes, key=lambda p: (len(p), p))
    index = {p: i for i, p in enumerate(nodes)}
    depths = np.array([len(p) for p in nodes], np.int32)
    parents = np.array([index[p[:-1]] if len(p) > 1 else -1 for p in nodes],
                       np.int32)
    branch = np.array([p[-1] for p in nodes], np.int32)
    num_heads = int(depths.max())
    topks = np.zeros((num_heads,), np.int32)
    for p in nodes:
        topks[len(p) - 1] = max(topks[len(p) - 1], p[-1] + 1)
    return MedusaTree(depths, parents, branch, topks, num_heads)


def init_random_heads(cfg: ModelConfig, generator: torch.Generator,
                      num_heads: int, num_layers: int = 1,
                      device: DeviceLike = "cuda") -> Dict:
    """Random Medusa heads (the reference MedusaHead's shapes), f32, drawn
    from ``generator`` (a CPU generator: the draws do not depend on the
    device)."""
    dev = resolve_device(device)
    h, v = cfg.hidden_size, cfg.vocab_size

    def randn(*shape):
        return (torch.randn(shape, generator=generator) * 0.02).to(dev)

    return {"blocks": {"w": randn(num_heads, num_layers, h, h),
                       "b": torch.zeros((num_heads, num_layers, h),
                                        device=dev)},
            "lm_head": {"w": randn(num_heads, h, v)}}


def _hf_tensor(sd, key: str, prefixes: Sequence[str]) -> torch.Tensor:
    """``sd[prefix + key]`` for the first prefix present, as an f32 CPU
    tensor (numpy arrays and tensors alike)."""
    for pre in prefixes:
        if pre + key in sd:
            return torch.as_tensor(np.asarray(sd[pre + key])).float()
    raise KeyError(key)


def heads_from_hf(sd, num_heads: int, num_layers: int = 1,
                  device: DeviceLike = "cuda") -> Dict:
    """A Medusa checkpoint's state dict -> heads: per head ``k`` the
    ResBlocks ``{k}.{l}.linear.weight/bias`` and the lm_head
    ``{k}.{num_layers}.weight``, under ``medusa_head.`` or bare."""
    dev = resolve_device(device)
    pre = ("medusa_head.", "")

    def get(key, transpose):
        x = _hf_tensor(sd, key, pre)
        return x.T if transpose else x

    def per_layer(name, transpose):
        return torch.stack([
            torch.stack([get(f"{k}.{l}.linear.{name}", transpose)
                         for l in range(num_layers)])
            for k in range(num_heads)]).to(dev)

    return {"blocks": {"w": per_layer("weight", True),
                       "b": per_layer("bias", False)},
            "lm_head": {"w": torch.stack([
                get(f"{k}.{num_layers}.weight", True)
                for k in range(num_heads)]).to(dev)}}


def head_logits(heads: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """hidden (B, H) -> per-head logits (K, B, V), f32: residual blocks
    x + silu(x W + b), then the head's own lm_head."""
    w = heads["blocks"]["w"].float()
    b = heads["blocks"]["b"].float()
    x = hidden.float()[None].expand(w.shape[0], -1, -1)
    for l in range(w.shape[1]):
        x = x + torch.nn.functional.silu(torch.bmm(x, w[:, l])
                                         + b[:, l, None])
    return torch.bmm(x, heads["lm_head"]["w"].float())


@dataclass
class MedusaStats:
    steps: int = 0
    tokens: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.tokens / max(self.steps, 1)


def prefill(params, cfg: ModelConfig, cache: KVCache, prompt: Sequence[int]):
    """The prompt through ``full_prefill`` (K14 on the card for MHA).
    Returns (last logits (V,), last pre-norm hidden (1, H))."""
    dev = cache.k.device
    s0 = len(prompt)
    tok = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    pos = torch.arange(s0, dtype=torch.int32, device=dev)[None]
    last = torch.full((1,), s0 - 1, dtype=torch.int32, device=dev)
    logits, _, hidden = mcommon.forward(
        params, cfg, tok, pos, cache, last + 1, full_prefill=True,
        return_hidden=True, last_pos=last)
    return logits[0, 0], hidden[:, -1]


def ancestor_mask(parents_of_row: Sequence[Sequence[int]]) -> np.ndarray:
    """(R, R) bool: row r sees itself, the root row 0 and the rows listed
    for it."""
    r = len(parents_of_row)
    anc = np.zeros((r, r), bool)
    anc[:, 0] = True
    for i, ps in enumerate(parents_of_row):
        anc[i, i] = True
        anc[i, list(ps)] = True
    return anc


def verify_layout(tree: MedusaTree):
    """The verify's rows for ``tree``: row 0 the committed next token,
    node i at row i + 1. Returns (the ancestor mask (R, R) bool, each
    row's depth (R,) int32)."""
    parents_of_row = [[]]
    for i in range(tree.num_nodes):
        ps, p = [], tree.parents[i]
        while p >= 0:
            ps.append(p + 1)
            p = tree.parents[p]
        parents_of_row.append(ps)
    return (ancestor_mask(parents_of_row),
            np.concatenate([[0], tree.depths]).astype(np.int32))


def tree_verify(params, cfg: ModelConfig, cache: KVCache, rows: np.ndarray,
                depths: np.ndarray, anc: torch.Tensor, t: int):
    """One verify forward of R rows (1, R) written at slots t..t+R-1, at
    positions t + depths for RoPE, each row seeing the committed history
    (slots below t) and the rows ``anc`` (R, R) allows it. Returns
    (logits (1, R, V), hidden (1, R, H))."""
    dev = cache.k.device
    r = rows.shape[1]
    smax = cache.k.shape[2]
    slots = t + torch.arange(r, dtype=torch.int32, device=dev)[None]
    pos = t + torch.as_tensor(depths, dtype=torch.int32, device=dev)[None]
    mask = torch.zeros((1, 1, r, smax), dtype=torch.bool, device=dev)
    mask[..., :t] = True
    mask[0, 0, :, t:t + r] = anc
    logits, _, hidden = mcommon.forward(
        params, cfg, torch.as_tensor(rows, device=dev), slots, cache,
        torch.full((1,), t + r, dtype=torch.int32, device=dev),
        attn_mask=mask, return_hidden=True, rope_pos=pos)
    return logits, hidden


def compact(cache: KVCache, slot_path: Sequence[int], t: int,
            width: int) -> None:
    """Move the accepted rows' KV (slot offsets ``slot_path`` from t, the
    root first) to slots t, t+1, ... in place, in every layer and in the
    scales too. ``width`` entries are moved, the path padded with 0 (the
    root row): rows past the path are overwritten by later steps and never
    attended, since the history mask cuts at the committed length. All
    rows are gathered before any is written."""
    idx = np.zeros((width,), np.int64)
    idx[:len(slot_path)] = slot_path
    src = torch.as_tensor(idx + t, device=cache.k.device)
    for a in cache:
        if a is None:
            continue
        a = qcore.raw(a)
        a[:, :, t:t + width] = a[:, :, src]


def medusa_generate(params: Dict, cfg: ModelConfig, heads: Optional[Dict],
                    prompt: Sequence[int], max_new_tokens: int,
                    choices: Sequence[Tuple[int, ...]] = None,
                    max_seq_len: int = 0,
                    head_logits_fn: Optional[Callable] = None,
                    device: DeviceLike = "cuda"
                    ) -> Tuple[List[int], MedusaStats]:
    """Greedy Medusa decoding of one sequence.

    head_logits_fn(hidden (1, H), step) -> (K, 1, V) replaces the heads
    (an oracle in tests). Returns (prompt + generated tokens, stats)."""
    dev = resolve_device(device)
    tree = build_tree(tuple(tuple(c) for c in (choices or DEFAULT_CHOICES)))
    n = tree.num_nodes
    s0 = len(prompt)
    smax = max_seq_len or s0 + max_new_tokens + n + 2
    assert smax >= s0 + max_new_tokens + n + 1
    cache = mcommon.init_kv_cache(cfg, 1, smax, device=dev)
    anc, depths = verify_layout(tree)
    anc = torch.as_tensor(anc, device=dev)
    kmax = int(tree.topks.max())

    logits, hidden = prefill(params, cfg, cache, prompt)
    committed: List[int] = list(prompt)
    next_tok = int(read_back(logits.argmax()[None])[0][0])
    t = s0                      # next write slot and absolute position
    stats = MedusaStats()
    hfn = head_logits_fn or (lambda hid, step: head_logits(heads, hid))

    while len(committed) - s0 < max_new_tokens:
        stats.steps += 1
        # the heads read the post-final-norm hidden (the reference applies
        # them after the transformer's final norm)
        hn = mcommon.block_norm(cfg, hidden, params["final_norm"])
        hl = torch.as_tensor(hfn(hn, stats.steps), device=dev)
        (cand,) = read_back(_top_k(hl[:, 0].float(), kmax)[1])
        node_tokens = np.array([cand[tree.depths[i] - 1, tree.branch[i]]
                                for i in range(n)], np.int32)
        rows = np.concatenate([[next_tok], node_tokens])[None].astype(
            np.int32)
        logits, hidden_all = tree_verify(params, cfg, cache, rows, depths,
                                         anc, t)
        (lg,) = read_back(logits[0].argmax(-1))

        # the greedy walk down the tree
        path_slots, accepted = [0], [next_tok]
        cur, expect = -1, lg[0]
        while True:
            child = next((i for i in range(n)
                          if tree.parents[i] == cur
                          and node_tokens[i] == expect), None)
            if child is None:
                break
            path_slots.append(child + 1)
            accepted.append(int(node_tokens[child]))
            expect = lg[child + 1]
            cur = child
        bonus = int(expect)     # the argmax at the deepest accepted node

        room = max_new_tokens - (len(committed) - s0)
        accepted = accepted[:room]
        path_slots = path_slots[:len(accepted)]
        compact(cache, path_slots, t, n + 1)
        committed.extend(accepted)
        stats.tokens += len(accepted)
        t += len(accepted)
        next_tok = bonus
        hidden = hidden_all[:, path_slots[len(accepted) - 1]]

    return committed, stats
