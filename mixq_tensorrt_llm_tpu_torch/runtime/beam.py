"""Beam search over the dense KV cache and over the paged pool with
copy-on-write block sharing. Counterpart of runtime/beam.py.

Beams are a flattened batch of B*K lanes. ``beam_search`` runs over the
dense ``KVCache`` (the reference the paged path is held to);
``paged_beam_search`` writes each prompt's KV once into the paged pool,
forks its blocks to the K beams by reference count, and copies a shared
page only where a beam writes into it (``BlockManager.fork`` /
``ensure_exclusive``).

``burst=1`` decodes one host-paced step at a time through
``forward_paged`` (on the card K5 writes, K7 attends). ``burst=k > 1`` runs
k steps a call with the pool only read: each step attends over [pool
prefix | a dense per-lane tail] (``models.common._attention_paged_tail``:
K10 on the prefix, merged exactly with the tail's softmax stats), then
reorders the block tables, lane ids and tails with the beams; the call
ends by copying each lane's boundary page from its ancestor's (copy-on-
write) and flushing the tails into pages the host preallocated. The host
reads back once a call, folds the ancestry and redoes the block lists.

On the card each burst is one replay of a CUDA graph, one graph a burst
key (the JAX package memoizes one program a key), made at first use by a
warm pass and a capture into one graph memory pool. A graph holds the
storage of the pool and the params, so a ``BeamEngine`` keeps the pool,
the graphs and their static inputs alive between calls: the Executor owns
one for ``run_beams`` / ``warmup_beams``, the GenerationSession one for
``generate``. On the CPU the same bookkeeping runs eagerly. Prefill chunks
and the per-step path run eagerly on both.

Top-k follows ``jax.lax.top_k``'s order: among equal scores the lower
index comes first (a stable descending sort). Finished beams make many
equal candidates, so the order decides which survive.

Runtime LoRA: ``lora_ids`` gives each request's adapter (0 = the base
model); its K beams share it, in the prefill, every step and every burst
(a burst's lane ids are one of its static inputs).

Not ported: meshes (tp / pp beams), the compact flush (its reason is
XLA's whole-pool transposed copy, which an ``index_put_`` does not make,
so one exact flush serves) and the MIXQ_BEAM_TRACE timing prints.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import common as mcommon
from ..models import moe
from ..models.common import KVCache, ModelConfig
from ..ops import _build
from ..ops.paged_attention import check_kernel_geometry
from ..quant import core as qcore
from ..utils import compile_watch
from . import kv_cache as pkv
from .sampler import BW_PAD, ban_bad_words
from .scheduler import StaticInputs, capture_graph, read_back

NEG_INF = -1e9

# processor history window: the Executor's, so a processor sees the same
# right-aligned history on both surfaces
PROC_HIST_W = 64

# memoized beam programs (prefill, per-step) and each engine's bursts:
# processors enter the keys by identity, so per-call lambdas would grow
# them without bound; past the cap the oldest entry goes (it is made again
# at its next use)
_MEMO_CAP = 128

_CTRL_FIELDS = ("min_lanes", "bw", "stops", "stop_len", "proc_masks")


def _pack_lora(lora_ids, k: int):
    """Per-request adapter ids -> ((B,) prefill ids, (B*K,) lane ids) int32
    numpy, each request's id repeated over its k beams; (None, None) when
    every request runs the base model."""
    if lora_ids is None or not any(lora_ids):
        return None, None
    req = np.asarray([i or 0 for i in lora_ids], np.int32)
    return req, np.repeat(req, k)


@dataclasses.dataclass
class BeamResult:
    sequences: List[List[int]]      # best hypothesis per input (incl prompt)
    scores: List[float]             # sum logprob / length_penalty
    peak_blocks: Optional[int] = None   # paged path: peak pool pages used


@dataclasses.dataclass(frozen=True)
class BeamControls:
    """Per-lane logits controls inside beam search (min_new_tokens, bad
    words, stop sequences, named processors). Every array is per lane (B*K
    rows: the K beams of a request share its controls); numpy as packed,
    tensors once moved (``to``). ``hist_w`` is the width of the rolling
    history the beam step carries, reorders with the beam parents and
    shifts left to append the chosen token."""
    hist_w: int
    min_lanes: Optional[object]     # (N,) int32 min_new_tokens, 0 = none
    bw: Optional[object]            # (N, nw, lw) packed bad words
    stops: Optional[object]         # (N, ns, ls) right-aligned, -1 pad
    stop_len: Optional[object]      # (N, ns) int32, 0 = unused row
    proc_masks: Optional[object] = None   # (N, P) bool lane masks
    procs: tuple = ()               # P static (name, fn) pairs

    def key(self):
        # processors enter the key as the (name, fn) pairs themselves:
        # names alone would let two callables under one name share a
        # program
        sh = (lambda a: None if a is None else tuple(a.shape))
        return (self.hist_w, sh(self.min_lanes), sh(self.bw),
                sh(self.stops), tuple(self.procs))

    def arrays(self):
        return tuple(getattr(self, f) for f in _CTRL_FIELDS)

    def to(self, device) -> "BeamControls":
        """The packed numpy arrays as tensors on ``device`` (bad words as
        int64, as ban_bad_words takes them)."""
        out = {}
        for f, a in zip(_CTRL_FIELDS, self.arrays()):
            if a is not None:
                a = torch.as_tensor(np.asarray(a), device=device)
                out[f] = a.long() if f == "bw" else a
        return dataclasses.replace(self, **out)


def _p2(n: int, lo: int = 1) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _pack_beam_controls(prompts, k: int, min_new_tokens, bad_words,
                        stop_sequences, procs=(),
                        proc_masks=None) -> Optional[BeamControls]:
    """Per-request controls packed into per-lane numpy arrays; None when
    no request carries any. procs: static (name, fn) pairs; proc_masks
    (b, P) bool per-request masks (every request when None). Every packed
    width (word count and length, stop count and length, history) is
    rounded up to a power of two, so batches of similar controls share
    their programs; the pad rows and columns are inert."""
    b = len(prompts)
    if min_new_tokens is not None:
        min_new_tokens = [m or 0 for m in min_new_tokens]
    has_min = min_new_tokens is not None and any(min_new_tokens)
    has_bw = bad_words is not None and any(w for w in bad_words if w)
    has_stop = (stop_sequences is not None
                and any(s for s in stop_sequences if s))
    if procs and proc_masks is None:
        proc_masks = np.ones((b, len(procs)), bool)
    has_proc = (len(procs) > 0 and proc_masks is not None
                and bool(np.asarray(proc_masks).any()))
    if not (has_min or has_bw or has_stop or has_proc):
        return None
    min_lanes = None
    w_need = 1 if not has_proc else PROC_HIST_W
    if has_min:
        min_lanes = np.repeat(np.asarray(min_new_tokens, np.int32), k)
    bw = None
    if has_bw:
        words = [t for ws in bad_words if ws for t in ws]
        nw = _p2(max(len(ws or []) for ws in bad_words))
        lw = _p2(max(2, max(len(t) for t in words)), 2)
        arr = np.full((b, nw, lw), BW_PAD, np.int32)
        for i, ws in enumerate(bad_words):
            for j, t in enumerate(ws or []):
                arr[i, j, lw - len(t):] = t
        bw = np.repeat(arr, k, axis=0)
        w_need = max(w_need, lw - 1)
    stops = stop_len = None
    if has_stop:
        seqs = [s for ss in stop_sequences if ss for s in ss]
        ns = _p2(max(len(ss or []) for ss in stop_sequences))
        ls = _p2(max(len(s) for s in seqs))
        arr = np.full((b, ns, ls), -1, np.int32)
        lens = np.zeros((b, ns), np.int32)
        for i, ss in enumerate(stop_sequences):
            for j, s in enumerate(ss or []):
                arr[i, j, ls - len(s):] = s
                lens[i, j] = len(s)
        stops = np.repeat(arr, k, axis=0)
        stop_len = np.repeat(lens, k, axis=0)
        w_need = max(w_need, ls)
    pm = None
    if has_proc:
        pm = np.repeat(np.asarray(proc_masks, bool), k, axis=0)
    return BeamControls(_p2(int(w_need), 8), min_lanes, bw, stops,
                        stop_len, pm, tuple(procs) if has_proc else ())


def _init_hist(prompts, k: int, w: int) -> np.ndarray:
    """(B*K, w) right-aligned prompt tails, -1 padded: the bad-words
    prefix window spans the prompt, as the Executor's history does."""
    b = len(prompts)
    out = np.full((b * k, w), -1, np.int32)
    for i, p in enumerate(prompts):
        tail = list(p)[-w:]
        if tail:
            out[i * k:(i + 1) * k, w - len(tail):] = tail
    return out


def _ban_logits(raw, hist, ctrl: BeamControls, gen_next, eos: int):
    """The pre-softmax controls of one beam step. raw (N, V); hist (N, W);
    gen_next: the 1-based index, in generated output, of the token being
    chosen (an int or a device tensor). EOS is banned while gen_next <=
    min_new_tokens. Named processors run first, on the raw logits."""
    for pi, (_, f) in enumerate(ctrl.procs):
        raw = torch.where(ctrl.proc_masks[:, pi][:, None], f(raw, hist),
                          raw)
    if ctrl.bw is not None:
        raw = ban_bad_words(raw, hist, ctrl.bw)
    if ctrl.min_lanes is not None and eos >= 0:
        ban = gen_next <= ctrl.min_lanes                 # (N,)
        v = raw.shape[-1]
        hit = torch.arange(v, device=raw.device)[None, :] == eos
        raw = torch.where(ban[:, None] & hit, NEG_INF, raw)
    return raw


def _stop_hits(hist_new, ctrl: BeamControls, gen_next):
    """(N,) bool: the token just appended to hist_new completes a stop
    sequence lying entirely within the generated output."""
    if ctrl.stops is None:
        return None
    ls = ctrl.stops.shape[2]
    tail = hist_new[:, hist_new.shape[1] - ls:]          # (N, ls)
    ok = (ctrl.stops == -1) | (tail[:, None, :] == ctrl.stops)
    m = (ok.all(dim=-1) & (ctrl.stop_len > 0)
         & (gen_next >= ctrl.stop_len))
    return m.any(dim=-1)


def _ban_step0(logits0, ctrl: BeamControls, prompts, k: int, eos: int):
    """First-token controls on the prefill output, then log_softmax.
    ``ctrl`` holds tensors on logits0's device. With named processors
    logits0 must be the raw last-token logits; without, log-probs do (a
    ban then log_softmax is shift-invariant)."""
    hist = torch.as_tensor(_init_hist(prompts, 1, ctrl.hist_w),
                           device=logits0.device)
    per_req = {f: getattr(ctrl, f)[::k] for f in
               ("min_lanes", "bw", "proc_masks")
               if getattr(ctrl, f) is not None}
    req = dataclasses.replace(ctrl, stops=None, stop_len=None, **per_req)
    raw = _ban_logits(logits0, hist, req, 1, eos)
    return torch.log_softmax(raw, dim=-1)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis in
    jax.lax.top_k's order: descending, the lower index first among equal
    values (a stable sort; torch.topk promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_select(raw, b: int, k: int, scores, fin, hist,
                 ctrl: Optional[BeamControls], gen_next, eos: int):
    """One beam step from the raw logits (B*K, V) f32: the controls, the
    finished beams' frozen scores (only token 0 continues them, at no
    cost), top-k over K*V, the finished flags and the history carried
    with the parents. Returns (new scores (B, K), parents (B, K), tokens
    (B, K), finished (B, K), history, lane rows (B*K,) of the parents)."""
    if ctrl is not None:
        raw = _ban_logits(raw, hist, ctrl, gen_next, eos)
    logp = torch.log_softmax(raw, dim=-1)
    v = logp.shape[-1]
    logp = logp.view(b, k, v)
    cont = torch.where(fin[:, :, None], NEG_INF, logp)
    cont[:, :, 0] = torch.where(fin, 0.0, cont[:, :, 0])
    total = scores[:, :, None] + cont
    new_scores, idx = _top_k(total.reshape(b, k * v), k)
    parent = idx // v
    token = idx % v
    rows = (torch.arange(b, device=raw.device)[:, None] * k
            + parent).reshape(b * k)
    fin = torch.gather(fin, 1, parent)
    if eos >= 0:
        fin = fin | (token == eos)
    if ctrl is not None:
        hist = torch.cat([hist[rows][:, 1:],
                          token.reshape(b * k, 1).to(hist.dtype)], dim=1)
        sh = _stop_hits(hist, ctrl, gen_next)
        if sh is not None:
            fin = fin | sh.view(b, k)
    return new_scores, parent, token, fin, hist, rows


def _tile_cache(cache: KVCache, k: int) -> KVCache:
    """Each batch row of the dense cache repeated k times (axis 1)."""
    return KVCache(*(None if x is None else
                     qcore.raw(x).repeat_interleave(k, dim=1).view(x.dtype)
                     for x in cache))


def _reorder_cache(cache: KVCache, rows: torch.Tensor) -> KVCache:
    return KVCache(*(None if x is None else
                     qcore.raw(x).index_select(1, rows).view(x.dtype)
                     for x in cache))


def beam_search(params, cfg: ModelConfig, prompts: Sequence[Sequence[int]],
                max_new_tokens: int, num_beams: int = 4,
                length_penalty: float = 1.0,
                eos_token_id: Optional[int] = None,
                max_seq_len: int = 2048,
                min_new_tokens=None, bad_words=None,
                stop_sequences=None, lora_ids=None,
                logits_processors=(), proc_masks=None,
                device: DeviceLike = "cuda") -> BeamResult:
    """Batched beam search over the dense KV cache, K lanes a prompt (the
    cache tiled K times after the prefill, reordered by a gather each
    step); returns the best hypothesis per prompt.

    min_new_tokens / bad_words / stop_sequences: optional per-request
    controls (ints / lists of token-id sequences), see BeamControls.
    logits_processors: static (name, fn) pairs, torch callables
    ``(logits (N, V), history (N, W)) -> logits``, with proc_masks (b, P)
    per-request masks. lora_ids: per-request runtime adapter ids (0 = the
    base model)."""
    dev = resolve_device(device)
    b, k = len(prompts), num_beams
    ctrl = _pack_beam_controls(prompts, k, min_new_tokens, bad_words,
                               stop_sequences, logits_processors,
                               proc_masks)
    ctrl_d = None if ctrl is None else ctrl.to(dev)
    lora_req, lora_lane = (None if a is None else torch.as_tensor(a).to(dev)
                           for a in _pack_lora(lora_ids, k))
    eos_i = -1 if eos_token_id is None else int(eos_token_id)
    lens_list = [len(p) for p in prompts]
    max_prompt = max(lens_list)
    if max_prompt + max_new_tokens > max_seq_len:
        raise ValueError(f"prompt ({max_prompt}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds max_seq_len "
                         f"({max_seq_len})")
    tokens = np.zeros((b, max_prompt), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lens = torch.as_tensor(np.asarray(lens_list, np.int32), device=dev)
    cache = mcommon.init_kv_cache(cfg, b, max_seq_len, device=dev)
    pos = torch.arange(max_prompt, dtype=torch.int32,
                       device=dev)[None].expand(b, max_prompt)
    logits, cache = mcommon.forward(params, cfg,
                                    torch.as_tensor(tokens, device=dev),
                                    pos, cache, lens, last_pos=lens - 1,
                                    lora_ids=lora_req)
    # processors see raw logits (they are not shift-invariant as bans are)
    logp0 = logits[:, 0]
    if ctrl is None or not ctrl.procs:
        logp0 = torch.log_softmax(logp0, dim=-1)
    if ctrl is not None:
        logp0 = _ban_step0(logp0, ctrl_d, prompts, k, eos_i)

    scores, top_tok = _top_k(logp0, k)                   # (B, K)
    cache = _tile_cache(cache, k)                        # rows = B*K
    cur = top_tok.reshape(b * k)
    (tok_np,) = read_back(top_tok)
    beam_tokens = [tok_np.reshape(b * k)]
    beam_parents: List[np.ndarray] = []
    cur_lens = lens.repeat_interleave(k)
    finished = np.zeros((b, k), bool)
    if eos_token_id is not None:
        finished |= tok_np == eos_token_id
    hist = None
    if ctrl is not None:
        hist = torch.as_tensor(_init_hist(prompts, k, ctrl.hist_w),
                               device=dev)
        hist = torch.cat([hist[:, 1:], cur[:, None].int()], dim=1)
        sh = _stop_hits(hist, ctrl_d, 1)
        if sh is not None:
            finished |= read_back(sh)[0].reshape(b, k).astype(bool)

    for _ in range(max_new_tokens - 1):
        if finished.all():
            break
        gen0 = len(beam_tokens)
        logits, cache = mcommon.forward(params, cfg, cur[:, None],
                                        cur_lens[:, None], cache,
                                        cur_lens + 1, lora_ids=lora_lane)
        scores, parent, token, fin, hist, rows = _beam_select(
            logits[:, 0].float(), b, k, scores,
            torch.as_tensor(finished, device=dev), hist, ctrl_d, gen0 + 1,
            eos_i)
        cache = _reorder_cache(cache, rows)
        parent_np, token_np, fin_np = read_back(parent, token, fin)
        finished = fin_np.astype(bool)
        beam_parents.append(parent_np)
        beam_tokens.append(token_np.reshape(b * k))
        cur = token.reshape(b * k)
        cur_lens = cur_lens + 1

    return _backtrack(prompts, k, beam_tokens, beam_parents,
                      read_back(scores)[0], length_penalty, eos_token_id,
                      stop_sequences)


def _backtrack(prompts, k: int, beam_tokens, beam_parents, scores_np,
               length_penalty: float, eos_token_id,
               stop_sequences=None) -> BeamResult:
    """The best hypothesis per prompt, traced through the parent chain.

    beam_tokens: per-step (B*K,) chosen tokens; beam_parents: per-step
    (B, K) parent beam index (one entry fewer). A hypothesis is cut after
    the first eos or completed stop suffix (the suffix kept)."""
    b = len(prompts)
    gen_len = len(beam_tokens)
    norm = scores_np / (gen_len ** length_penalty)
    best = norm.argmax(axis=1)                          # (B,)
    sequences, out_scores = [], []
    for i in range(b):
        beam = int(best[i])
        toks = []
        for t in range(gen_len - 1, -1, -1):
            toks.append(int(beam_tokens[t][i * k + beam]))
            if t > 0:
                beam = int(beam_parents[t - 1][i, beam])
        toks.reverse()
        cut = None
        if eos_token_id is not None and eos_token_id in toks:
            cut = toks.index(eos_token_id) + 1
        stops_i = stop_sequences[i] if stop_sequences else None
        if stops_i:
            for n in range(1, (len(toks) if cut is None else cut) + 1):
                if any(n >= len(ss)
                       and toks[n - len(ss):n] == list(ss)
                       for ss in stops_i):
                    cut = n if cut is None else min(cut, n)
                    break
        if cut is not None:
            toks = toks[:cut]
        sequences.append(list(prompts[i]) + toks)
        out_scores.append(float(norm[i, best[i]]))
    return BeamResult(sequences, out_scores)


# ---------------------------------------------------------------------------
# Paged beam search: KV blocks shared across beams by fork + copy-on-write
# ---------------------------------------------------------------------------

def _copy_pages(pools: dict, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Pool rows dst[i] <- src[i], in place: each field's sources are all
    gathered before any destination is written, so a row that is one
    lane's source and another's destination is read first. Padding copies
    the trash row onto itself."""
    for p in pools.values():
        p = qcore.raw(p)
        rows = p[src]
        p[dst] = rows


_PREFILL_FNS: dict = {}
_STEP_FNS: dict = {}


def _memo_put(d: dict, key, val):
    if len(d) >= _MEMO_CAP:
        d.pop(next(iter(d)))
    d[key] = val
    return val


def _make_beam_prefill(cfg: ModelConfig, raw: bool = False):
    """The prefill chunk, one lane a prompt (memoized; a miss is a program
    made, utils/compile_watch). raw=True keeps the last-token raw logits
    instead of log-probs (named processors are not shift-invariant)."""
    key = (cfg, raw)
    hit = _PREFILL_FNS.get(key)
    if hit is not None:
        return hit

    def prefill_chunk(params, tokens_c, state, table, start, lens, logp,
                      lora=None):
        c = tokens_c.shape[1]
        pos_c = start + torch.arange(c, dtype=torch.int32,
                                     device=start.device)[None, :]
        valid = torch.minimum(lens, start[:, 0] + c)
        idx = torch.clamp(lens - 1 - start[:, 0], 0, c - 1)
        logits, state = mcommon.forward_paged(params, cfg, tokens_c, pos_c,
                                              state, table, valid,
                                              last_pos=idx, lora_ids=lora)
        last = logits[:, 0]
        hit_ = (lens - 1 >= start[:, 0]) & (lens - 1 < start[:, 0] + c)
        out = last if raw else torch.log_softmax(last, dim=-1)
        return torch.where(hit_[:, None], out, logp), state

    compile_watch.note_program()
    return _memo_put(_PREFILL_FNS, key, prefill_chunk)


def _make_beam_step(cfg: ModelConfig, b: int, k: int, eos_i: int, ctrl):
    """One host-paced beam step over the paged pool (memoized as the
    prefill is): forward_paged writes the lanes' tokens (K5) and attends
    (K7), then _beam_select."""
    key = (cfg, b, k, eos_i, None if ctrl is None else ctrl.key())
    hit = _STEP_FNS.get(key)
    if hit is not None:
        return hit

    def step(params, cur, state, table, cur_lens, beam_scores, finished,
             hist, gen0, ctrl_d, lora=None):
        logits, state = mcommon.forward_paged(
            params, cfg, cur[:, None], cur_lens[:, None], state, table,
            cur_lens + 1, lora_ids=lora)
        scores, parent, token, fin, hist, _ = _beam_select(
            logits[:, 0].float(), b, k, beam_scores, finished, hist, ctrl_d,
            gen0 + 1, eos_i)
        return state, scores, parent, token, fin, hist

    compile_watch.note_program()
    return _memo_put(_STEP_FNS, key, step)


# ---------------------------------------------------------------------------
# Device-paced bursts: k steps a call, reorder and copy-on-write inside it
# ---------------------------------------------------------------------------

def _init_tail(cfg: ModelConfig, n_lanes: int, kmax: int, quantized: bool,
               device, nl: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Dense burst tails for every layer, stacked on a leading layer axis:
    k / v (L, N, kmax, Hkv, D) in the pool's dtype (+ k_scale / v_scale
    (L, N, kmax, Hkv) f32 for int8 and e4m3 pools). The burst's new KV
    stays here until the burst's flush, so the pool is only read during
    the steps."""
    shape = (nl or cfg.num_layers, n_lanes, kmax, cfg.num_kv_heads,
             cfg.head_dim)
    if quantized:
        qdt = mcommon.kv_dtype(cfg)
        return {"k": torch.zeros(shape, dtype=qdt, device=device),
                "v": torch.zeros(shape, dtype=qdt, device=device),
                "k_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                      device=device),
                "v_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                      device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _forward_with_tail(params, cfg: ModelConfig, cur, pools: dict, table,
                       bpos, prefix_len, tails: dict, tidx: int,
                       lora_ids=None):
    """One decode forward of a burst: attention over [pool prefix | dense
    tail] (models.common._attention_paged_tail), the new token's K/V
    written into each layer's tail at slot ``tidx`` in place, the pool
    only read. cur (N,) at position prefix_len + tidx; table (N, MB)
    per-layer page ids; lora_ids (N,) the lanes' adapters. Returns the
    logits (N, 1, V) f32. ALiBi and windows are refused, as in the JAX
    package (its beam.py:872, models/common.py:577-580)."""
    pos = (prefix_len + tidx)[:, None]
    sin, cos, alibi = mcommon._positional_arrays(cfg, pos)
    if alibi is not None:
        raise NotImplementedError("beam bursts do not support ALiBi")
    x = mcommon._embed(params, cfg, cur[:, None], pos)
    nb = pools["k"].shape[0] // len(params["layers"])
    for li, lp in enumerate(params["layers"]):
        attend = partial(mcommon._attention_paged_tail, cfg, pools=pools,
                         tail={n: a[li] for n, a in tails.items()},
                         tail_idx=tidx, block_table=table + li * nb,
                         prefix_len=prefix_len, block_pos=bpos)
        x = mcommon.decoder_layer(cfg, lp, x, sin, cos, attend,
                                  lora_ids=lora_ids)
    return mcommon._head(params, cfg, x).float()


def _flush_tail(pools: dict, tails: dict, rows: torch.Tensor,
                offs: torch.Tensor) -> None:
    """Write the burst tails into their pool pages in place, one
    index_put_ a field. rows (L, N, k) global page rows; offs (N, k)
    in-page slots (the same on every layer)."""
    offs = offs.long()[None].expand(rows.shape)
    for name, tail in tails.items():
        qcore.raw(pools[name])[rows, :, offs] = qcore.raw(tail)


@dataclasses.dataclass
class _Burst:
    """A k_eff-step burst program: its static inputs and, on the card, its
    graph, the graph's output and the launches its capture recorded,
    which every replay adds to ``ops._build.LAUNCHES``."""
    inputs: StaticInputs
    graph: Optional[object] = None
    out: Optional[torch.Tensor] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


class BeamEngine:
    """What paged beam search keeps between calls on one model: the KV pool
    (grown when a call needs more, never shrunk), the burst programs with
    their static inputs, and on the card their CUDA graphs, one graph
    memory pool for all. A graph holds the storage of the pool and the
    params, so the engine holds both: replacing the pool drops every
    graph over it, and a call with other params raises. Stale pool
    contents past a lane's length are masked, as on the Executor's path.

    graphs=False runs the bursts eagerly on the card too (what replays are
    held to). Counters: ``bursts`` (burst calls), ``burst_steps``,
    ``graph_replays`` (== ``bursts`` on the card), ``readbacks`` (every
    host readback of a call's results: one at the prefill, one a step or
    a burst), ``peak_blocks`` (the most pool blocks a call held),
    ``prefill_s`` (host wall of the prefills, through their readback)."""

    def __init__(self, params, cfg: ModelConfig, device: DeviceLike = "cuda",
                 graphs: bool = True):
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.graphs = graphs and self.device.type == "cuda"
        self.state: Optional[pkv.PagedKVState] = None
        self._bursts: Dict[tuple, _Burst] = {}
        self._graph_pool = None
        self.bursts = self.burst_steps = self.graph_replays = 0
        self.readbacks = self.peak_blocks = 0
        self.prefill_s = 0.0

    def read_back(self, *ts: torch.Tensor) -> List[np.ndarray]:
        """scheduler.read_back, counted."""
        self.readbacks += 1
        return read_back(*ts)

    def pool(self, num_blocks: int, block_size: int) -> pkv.PagedKVState:
        """The pool, with at least ``num_blocks`` blocks a layer."""
        s, nl = self.state, len(self.params["layers"])
        if (s is None or s.block_size != block_size
                or s.num_pages < nl * num_blocks):
            self._bursts.clear()
            self.state = None
            self.state = pkv.init_paged_kv(self.cfg, num_blocks, block_size,
                                           device=self.device)
        return self.state

    def _inputs(self, n: int, b: int, k: int, mb: int, k_eff: int,
                ctrl: Optional[BeamControls], lora: bool) -> StaticInputs:
        shapes = {"table": (n, mb), "bpos": (n, mb), "cur": (n,),
                  "prefix_len": (n,), "scores": (b, k), "fin": (b, k),
                  "cow_src_own": (n,), "cow_dst": (n,),
                  "flush_blk": (n, k_eff), "flush_off": (n, k_eff),
                  "gen0": (1,)}
        if lora:
            shapes["lora"] = (n,)
        if ctrl is not None:
            shapes["hist"] = (n, ctrl.hist_w)
            shapes.update({f: a.shape for f, a in
                           zip(_CTRL_FIELDS, ctrl.arrays())
                           if a is not None})
        return StaticInputs(shapes, self.device, ("scores",))

    def _body(self, g: _Burst, b: int, k: int, k_eff: int, eos: int,
              do_cow: bool, ctrl: Optional[BeamControls]) -> torch.Tensor:
        """``_steps`` with every MoE layer on its all-rows route (a graph
        body: no host readback, static shapes)."""
        with moe.static_shapes():
            return self._steps(g, b, k, k_eff, eos, do_cow, ctrl)

    def _steps(self, g: _Burst, b: int, k: int, k_eff: int, eos: int,
               do_cow: bool, ctrl: Optional[BeamControls]) -> torch.Tensor:
        """k_eff beam steps from the static inputs, which it only reads,
        then the epilogue that commits the burst to the pool: each lane's
        boundary page copied from its burst-final ancestor's
        (``cow_src_own`` of the ancestor into ``cow_dst``; row 0 where
        nothing is copied) and the tails flushed into ``flush_blk`` /
        ``flush_off``. Returns one int32 tensor: parents, tokens, scores
        (bit-cast) and finished flags (k_eff, B, K) each, then the final
        history (N, W) where controls are on."""
        d = g.inputs.dev
        params, cfg, dev = self.params, self.cfg, self.device
        pools = self.state.pools()
        nl = len(params["layers"])
        nb = pools["k"].shape[0] // nl
        n = b * k
        c = None
        if ctrl is not None:
            views = {f: d[f] for f in _CTRL_FIELDS if f in d}
            if "bw" in views:
                views["bw"] = views["bw"].long()
            if "proc_masks" in views:
                views["proc_masks"] = views["proc_masks"] != 0
            c = dataclasses.replace(ctrl, **views)
        tails = _init_tail(cfg, n, k_eff, self.state.quantized, dev, nl)
        cur, table, bpos = d["cur"], d["table"], d["bpos"]
        lane_ids = torch.arange(n, device=dev)
        scores, fin, hist = d["scores"], d["fin"] != 0, d.get("hist")
        steps = []
        for t in range(k_eff):
            logits = _forward_with_tail(params, cfg, cur, pools, table, bpos,
                                        d["prefix_len"], tails, t,
                                        lora_ids=d.get("lora"))
            scores, parent, token, fin, hist, rows = _beam_select(
                logits[:, 0], b, k, scores, fin, hist, c, d["gen0"] + t + 1,
                eos)
            # the beams' reorder: tables, ancestry and the tails' filled
            # slots follow the parents
            table = table[rows]
            lane_ids = lane_ids[rows]
            for a in tails.values():
                a = qcore.raw(a)
                a[:, :, :t + 1] = a[:, rows, :t + 1]
            cur = token.reshape(n)
            steps.append((parent, token, scores, fin))
        lrows = torch.arange(nl, device=dev)[:, None] * nb       # (L, 1)
        if do_cow:
            src = lrows + d["cow_src_own"][lane_ids][None]
            _copy_pages(pools, src.reshape(-1),
                        (lrows + d["cow_dst"][None]).reshape(-1))
        _flush_tail(pools, tails, lrows[:, :, None] + d["flush_blk"][None],
                    d["flush_off"])
        parts = [torch.stack([s[i] for s in steps]) for i in range(4)]
        parts[2] = parts[2].view(torch.int32)
        if hist is not None:
            parts.append(hist)
        return torch.cat([p.int().reshape(-1) for p in parts])

    def run_burst(self, b: int, k: int, k_eff: int, eos: int, do_cow: bool,
                  ctrl: Optional[BeamControls], mb: int,
                  fill: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """One burst call with the host inputs ``fill`` (and the packed
        control arrays of ``ctrl``; ``fill`` holds "lora", the lanes'
        adapter ids, where adapters are served): made at the key's first
        use (a
        program, utils/compile_watch; on the card a warm pass whose
        epilogue writes only the trash row, then a capture), then run,
        replayed on the card, and read back once. Returns numpy parents,
        tokens, scores, fin (k_eff, B, K) and hist (N, W) or None."""
        n = b * k
        key = (b, k, k_eff, eos, do_cow, mb,
               None if ctrl is None else ctrl.key(), "lora" in fill)
        g = self._bursts.get(key)
        h_fill = dict(fill)
        if ctrl is not None:
            h_fill.update({f: a for f, a in zip(_CTRL_FIELDS, ctrl.arrays())
                           if a is not None})
        if g is None:
            g = _Burst(self._inputs(n, b, k, mb, k_eff, ctrl,
                                    "lora" in fill))
            body = partial(self._body, g, b, k, k_eff, eos, do_cow, ctrl)
            if self.graphs:
                self._capture(g, body, h_fill,
                              f"beam burst b={b} k={k} k_eff={k_eff}")
            compile_watch.note_program()
            _memo_put(self._bursts, key, g)
        h = g.inputs.host
        for name, a in h_fill.items():
            h[name][...] = a
        g.inputs.upload()
        if g.graph is None:
            out = self._body(g, b, k, k_eff, eos, do_cow, ctrl)
        else:
            g.graph.replay()
            _build.add_launches(g.launches)
            self.graph_replays += 1
            out = g.out
        self.bursts += 1
        self.burst_steps += k_eff
        self.readbacks += 1
        flat = out.cpu().numpy()
        m = k_eff * n
        res = {name: flat[i * m:(i + 1) * m].reshape(k_eff, b, k)
               for i, name in enumerate(("parents", "tokens", "scores",
                                         "fin"))}
        res["scores"] = res["scores"].view(np.float32)
        res["fin"] = res["fin"].astype(bool)
        res["hist"] = (flat[4 * m:].reshape(n, ctrl.hist_w)
                       if ctrl is not None else None)
        return res

    def _capture(self, g: _Burst, body, h_fill: dict, what: str) -> None:
        """Capture ``body`` into the engine's graph pool. The warm pass
        runs it on this call's inputs with the epilogue's page rows set to
        the trash row: it must not commit anything, since the replay that
        follows reads the same pool."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        h = g.inputs.host

        def warm():
            for name, a in h_fill.items():
                h[name][...] = a
            for name in ("cow_src_own", "cow_dst", "flush_blk"):
                h[name][...] = 0
            g.inputs.upload()
            body()
            # the host buffer is refilled after this pass: its copy must
            # have landed first
            torch.cuda.current_stream(self.device).synchronize()

        g.graph, g.out, g.launches = capture_graph(
            body, self.device, self._graph_pool, what, warm=warm)


def _step_decode_loop(engine: BeamEngine, bm, mb: int, b: int, k: int,
                      burst: int, max_new_tokens: int, eos_token_id,
                      cur: np.ndarray, cur_lens: np.ndarray,
                      beam_scores: np.ndarray, finished: np.ndarray,
                      beam_tokens, beam_parents, peak_blocks: int,
                      ctrl: Optional[BeamControls] = None,
                      hist: Optional[np.ndarray] = None,
                      lora: Optional[np.ndarray] = None):
    """Drive the beam decode one host-paced step at a time (burst 1): each
    lane's write block made exclusive (copy-on-write) and the pages
    copied, one step (``_make_beam_step``: K5 writes, K7 attends), one
    readback, and the beams' reorder as block-list forks on the host.
    Arguments and result as ``_burst_decode_loop``'s."""
    params, cfg, dev = engine.params, engine.cfg, engine.device
    n_lanes = b * k
    eos_i = -1 if eos_token_id is None else int(eos_token_id)
    step = _make_beam_step(cfg, b, k, eos_i, ctrl)
    state = engine.state
    nl = len(params["layers"])
    nb = state.num_pages // nl
    all_lanes = list(range(n_lanes))
    pools = state.pools()

    def t_(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    ctrl_d = None if ctrl is None else ctrl.to(dev)
    lora_t = None if lora is None else t_(lora)
    scores = t_(beam_scores)
    cur_t = t_(cur)
    hist_t = None if hist is None else t_(hist)
    for _ in range(max_new_tokens - 1):
        if finished.all():
            break
        # copy-on-write: every lane's write block made exclusive first
        pairs = []
        for lane in all_lanes:
            pos_w = bm.seqs[lane].length
            bm.extend(lane, 1)
            dup = bm.ensure_exclusive(lane, pos_w)
            if dup is not None:
                pairs.append(dup)
        if pairs:
            src, dst = (np.asarray(x, np.int64) for x in zip(*pairs))
            lrows = np.arange(nl)[:, None] * nb
            _copy_pages(pools, t_((lrows + src[None]).reshape(-1)),
                        t_((lrows + dst[None]).reshape(-1)))
        peak_blocks = max(peak_blocks, bm.num_blocks - bm.num_free)
        table = t_(bm.block_table(all_lanes, mb))
        state, scores, parent, token, fin_d, hist_t = step(
            params, cur_t, state, table, t_(cur_lens.astype(np.int32)),
            scores, t_(finished), hist_t, len(beam_tokens), ctrl_d, lora_t)
        parent_np, token_np, fin_np, beam_scores = engine.read_back(
            parent, token, fin_d, scores)

        # the beams' reorder on the host: each new lane adopts its
        # parent's block list (a ref-counted fork), the old lists go
        tmp_base = n_lanes
        for i in range(b):
            for j in range(k):
                bm.fork(i * k + int(parent_np[i, j]), tmp_base + i * k + j)
        for lane in all_lanes:
            bm.free_sequence(lane)
        for lane in all_lanes:
            sb = bm.seqs.pop(tmp_base + lane)
            sb.seq_id = lane
            bm.seqs[lane] = sb

        finished = fin_np.astype(bool)
        beam_parents.append(parent_np)
        beam_tokens.append(token_np.reshape(n_lanes))
        cur_t = token.reshape(n_lanes)
        cur_lens = cur_lens + 1
    return beam_scores, finished, peak_blocks


def _burst_decode_loop(engine: BeamEngine, bm, mb: int, b: int, k: int,
                       burst: int, max_new_tokens: int, eos_token_id,
                       cur: np.ndarray, cur_lens: np.ndarray,
                       beam_scores: np.ndarray, finished: np.ndarray,
                       beam_tokens, beam_parents, peak_blocks: int,
                       ctrl: Optional[BeamControls] = None,
                       hist: Optional[np.ndarray] = None,
                       lora: Optional[np.ndarray] = None):
    """Drive the beam decode in k_eff-step bursts (``BeamEngine.run_burst``).

    Per burst: preallocate each lane's write pages on the host, one burst
    call (k_eff steps with the pool only read, then the copy-on-write of
    the boundary pages and the flush of the tails), ONE readback, the
    ancestry folded on the host, and the block lists redone once. The
    steps are folded exactly as far as the per-step loop would run
    (finished.all() checked before each step), so the length
    normalization sees the same number of tokens.

    A lane's partial boundary page is its own from the second burst on
    (the surgery adopts only an ancestor's full pages; partial pages are
    written fresh), so copy-on-write takes a fresh page only while the
    boundary is still shared by beams: the first burst after the prompt
    fork, where a prompt is not page-aligned."""
    n_lanes = b * k
    all_lanes = list(range(n_lanes))
    eos = -1 if eos_token_id is None else int(eos_token_id)
    bs = bm.block_size
    cur_lens = np.asarray(cur_lens, np.int64)
    steps_left = max_new_tokens - 1
    gen_count = len(beam_tokens)   # tokens emitted before this burst

    while steps_left > 0 and not finished.all():
        # the final burst is the pow2 ceiling of what is left: its
        # overshoot steps are discarded on the host and write inside the
        # pool's burst slack
        if steps_left >= burst:
            k_eff = burst
        else:
            k_eff = min(1 << (steps_left - 1).bit_length(), burst)
        real = min(k_eff, steps_left)

        # --- this burst's write pages, preallocated on the host ---
        base = cur_lens.astype(np.int64)
        do_cow = bool(np.any(base % bs != 0))
        cow_src_own = np.zeros((n_lanes,), np.int32)
        cow_dst = np.zeros((n_lanes,), np.int32)    # 0 == trash (no copy)
        flush_blk = np.zeros((n_lanes, k_eff), np.int32)
        flush_off = ((base[:, None] + np.arange(k_eff)) % bs
                     ).astype(np.int32)
        new_pages = []   # per lane: pages for positions >= boundary page
        for lane in all_lanes:
            b0 = int(base[lane])
            bi = b0 // bs
            sb = bm.seqs[lane]
            lane_pages = []
            if b0 % bs:
                # a partial boundary page: its contents are copied from
                # the burst-final ancestor's inside the burst; the target
                # is the lane's own page when exclusive, else a fresh one
                own = sb.blocks[bi]
                cow_src_own[lane] = own
                if bm.ref_counts[own] > 1:
                    dst = bm._take_free()
                    bm.ref_counts[dst] += 1
                    lane_pages.append((bi, dst, True))
                else:
                    dst = own
                    lane_pages.append((bi, own, False))
                cow_dst[lane] = dst
            first_fresh = bi + 1 if b0 % bs else bi
            for pi in range(first_fresh, (b0 + k_eff - 1) // bs + 1):
                pg = bm._take_free()
                bm.ref_counts[pg] += 1
                lane_pages.append((pi, pg, True))
            new_pages.append(lane_pages)
            page_of = {pi: pg for pi, pg, _ in lane_pages}
            pos = b0 + np.arange(k_eff)
            flush_blk[lane] = [page_of[p // bs] for p in pos]
        peak_blocks = max(peak_blocks, bm.num_blocks - bm.num_free)

        fill = {"table": bm.block_table(all_lanes, mb),
                "bpos": bm.block_pos(all_lanes, mb), "cur": cur,
                "prefix_len": cur_lens, "scores": beam_scores,
                "fin": finished, "cow_src_own": cow_src_own,
                "cow_dst": cow_dst, "flush_blk": flush_blk,
                "flush_off": flush_off, "gen0": [gen_count]}
        if ctrl is not None:
            fill["hist"] = hist
        if lora is not None:
            fill["lora"] = lora
        res = engine.run_burst(b, k, k_eff, eos, do_cow, ctrl, mb, fill)
        parents_np, tokens_np = res["parents"], res["tokens"]
        hist = res["hist"]

        anc = np.tile(np.arange(k), (b, 1))
        done_early = False
        folded = 0
        for t in range(real):
            if finished.all():
                done_early = True
                break
            p_t = parents_np[t]
            anc = np.take_along_axis(anc, p_t, axis=1)
            finished = res["fin"][t]
            beam_parents.append(p_t)
            beam_tokens.append(tokens_np[t].reshape(n_lanes))
            folded = t + 1
        gen_count += k_eff
        # the scores at the last folded step: overshoot must not leak into
        # the length-normalized ranking
        beam_scores = res["scores"][folded - 1]
        steps_left -= real
        if done_early or finished.all() or steps_left <= 0:
            break   # no more KV needed; skip the surgery

        # block-list surgery once a burst (the page contents were
        # committed inside the burst): final lane j of request i descends
        # from burst-start lane anc[i, j]; its list is the ancestor's full
        # prefix pages + its own preallocated write pages
        new_sbs = {}
        for i in range(b):
            for j in range(k):
                lane = i * k + j
                a = i * k + int(anc[i, j])
                src = bm.seqs[a]
                bi = int(base[lane]) // bs
                blocks = src.blocks[:bi] + [pg for _, pg, _
                                            in new_pages[lane]]
                for blk in blocks:
                    bm.ref_counts[blk] += 1
                new_sbs[lane] = pkv.SequenceBlocks(
                    lane, blocks, [pi * bs for pi in range(len(blocks))],
                    int(base[lane]) + k_eff)
        for lane in all_lanes:
            bm.free_sequence(lane)
            bm.seqs[lane] = new_sbs[lane]
        # drop the prealloc's temporary reference on fresh pages (now held
        # through the lane lists); a reused own boundary page took none
        for lane in all_lanes:
            for _, pg, fresh in new_pages[lane]:
                if fresh:
                    bm.ref_counts[pg] -= 1
                    if bm.ref_counts[pg] == 0:
                        bm.free.append(pg)

        cur = tokens_np[-1].reshape(n_lanes)
        cur_lens = cur_lens + k_eff

    return beam_scores, finished, peak_blocks


def paged_beam_search(params, cfg: ModelConfig,
                      prompts: Sequence[Sequence[int]],
                      max_new_tokens: int, num_beams: int = 4,
                      length_penalty: float = 1.0,
                      eos_token_id: Optional[int] = None,
                      max_seq_len: int = 2048,
                      block_size: int = 64,
                      burst: int = 1,
                      min_new_tokens=None, bad_words=None,
                      stop_sequences=None, lora_ids=None,
                      logits_processors=(), proc_masks=None,
                      prefill_bucket: bool = True,
                      device: DeviceLike = "cuda",
                      engine: Optional[BeamEngine] = None) -> BeamResult:
    """Beam search over the paged KV pool with block sharing.

    All beams of a prompt share its pages (written once, forked by
    reference count); a shared page is duplicated only where a beam
    writes into it, and the beams' reorder is block-list surgery on the
    host. burst > 1 decodes in device-paced bursts (``_burst_decode_loop``).
    min_new_tokens / bad_words / stop_sequences / logits_processors with
    proc_masks: per-request controls, as in ``beam_search``. ``engine``
    keeps the pool and the burst graphs between calls (a fresh one per
    call when None, on ``device``); it must have been made for these
    params. lora_ids: per-request runtime adapter ids (0 = the base
    model)."""
    if engine is None:
        engine = BeamEngine(params, cfg, device)
    elif engine.params is not params or engine.cfg != cfg:
        raise ValueError("this BeamEngine was made for other params")
    dev = engine.device
    if dev.type == "cuda":
        check_kernel_geometry(block_size, cfg.head_dim)
    b, k = len(prompts), num_beams
    ctrl = _pack_beam_controls(prompts, k, min_new_tokens, bad_words,
                               stop_sequences, logits_processors,
                               proc_masks)
    ctrl_d = None if ctrl is None else ctrl.to(dev)
    lora_req, lora_lane = _pack_lora(lora_ids, k)
    eos_i = -1 if eos_token_id is None else int(eos_token_id)
    lens_list = [len(p) for p in prompts]
    max_prompt = max(lens_list)
    if prefill_bucket:
        # pow2 prompt widths: a bounded, warmable set of programs; the
        # padded positions are masked by the lanes' true lengths
        bkt = 8
        while bkt < max_prompt:
            bkt *= 2
        if bkt + max_new_tokens <= max_seq_len:
            max_prompt = bkt
    if max_prompt + max_new_tokens > max_seq_len:
        raise ValueError(f"prompt ({max_prompt}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds max_seq_len "
                         f"({max_seq_len})")
    # the pool: prompts cost their pages once; each lane's divergent tail
    # spans the pages from its prompt's last to the final token, plus one
    # copy-on-write duplicate of a shared partial prompt page where some
    # prompt is not page-aligned; the final pow2 burst may write up to
    # burst - 1 positions past max_new_tokens
    cow_margin = 0 if all(ln % block_size == 0 for ln in lens_list) else 1
    slack = burst if burst > 1 else 1
    per_lane = (-(-(max_prompt + max_new_tokens + slack) // block_size)
                - max_prompt // block_size + cow_margin)
    bm = pkv.BlockManager(
        num_blocks=1 + b * (-(-max_prompt // block_size)) + b * k * per_lane,
        block_size=block_size)
    mb = -(-(max_prompt + max_new_tokens + slack) // block_size)
    if prefill_bucket and mb > 1:
        # pow2 table width (padding entries repeat the last real page and
        # are masked by their PAD_POS base)
        mb = 1 << (mb - 1).bit_length()
    state = engine.pool(bm.num_blocks, block_size)

    def t_(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    # ---- prefill: one lane a prompt (lane i*k), its pages written once
    for i in range(b):
        bm.add_sequence(i * k, lens_list[i])
    tokens = np.zeros((b, max_prompt), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lens = t_(np.asarray(lens_list, np.int32))
    table_p = t_(bm.block_table([i * k for i in range(b)], mb))
    chunk = min(512, max_prompt)
    if max_prompt % chunk:
        chunk = max_prompt   # a ragged width: one call
    wants_raw = ctrl is not None and bool(ctrl.procs)
    prefill_chunk = _make_beam_prefill(cfg, raw=wants_raw)
    # the range closes after the step-0 readback, so a profile can tell
    # every kernel the prefill queued from the decode's
    t0 = time.perf_counter()
    with torch.profiler.record_function("phase::prefill"):
        logp0 = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                            device=dev)
        for c0 in range(0, max_prompt, chunk):
            start = torch.full((b, 1), c0, dtype=torch.int32, device=dev)
            logp0, state = prefill_chunk(
                params, t_(tokens[:, c0:c0 + chunk]), state, table_p, start,
                lens, logp0, None if lora_req is None else t_(lora_req))
        if ctrl is not None:
            logp0 = _ban_step0(logp0, ctrl_d, prompts, k, eos_i)
        scores, top_tok = _top_k(logp0, k)               # (B, K)
        tok_np, scores_np = engine.read_back(top_tok, scores)
    engine.prefill_s += time.perf_counter() - t0

    # ---- fork: beams share every prompt block (ref-counted, no copies)
    for i in range(b):
        for j in range(1, k):
            bm.fork(i * k, i * k + j)
    peak_blocks = bm.num_blocks - bm.num_free

    n_lanes = b * k
    beam_tokens = [tok_np.reshape(n_lanes)]
    beam_parents: List[np.ndarray] = []
    cur = tok_np.reshape(n_lanes)
    cur_lens = np.repeat(np.asarray(lens_list, np.int64), k)
    finished = np.zeros((b, k), bool)
    if eos_token_id is not None:
        finished |= tok_np == eos_token_id
    hist = None
    if ctrl is not None:
        hist = _init_hist(prompts, k, ctrl.hist_w)
        hist = np.concatenate([hist[:, 1:], cur[:, None]], axis=1)
        sh = _stop_hits(torch.from_numpy(hist), ctrl.to("cpu"), 1)
        if sh is not None:
            finished |= sh.numpy().reshape(b, k)

    loop = _burst_decode_loop if burst > 1 else _step_decode_loop
    scores_np, finished, peak_blocks = loop(
        engine, bm, mb, b, k, burst, max_new_tokens, eos_token_id, cur,
        cur_lens, scores_np, finished, beam_tokens, beam_parents,
        peak_blocks, ctrl=ctrl, hist=hist, lora=lora_lane)
    result = _backtrack(prompts, k, beam_tokens, beam_parents, scores_np,
                        length_penalty, eos_token_id, stop_sequences)
    result.peak_blocks = peak_blocks
    engine.peak_blocks = max(engine.peak_blocks, peak_blocks)
    return result
