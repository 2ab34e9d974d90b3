"""Continuous-batching executor over the paged KV cache.
Counterpart of the single-device Executor of runtime/scheduler.py.

A host-side scheduler admits requests between steps; each step advances
every in-flight prefill by one chunk (chunked, non-blocking prefill), then
runs one batched decode step over all slots. Inactive slots point at the
trash block with length 1, so their lanes stay finite and harmless. Under
KV pressure (``max_kv_tokens``) the lowest-priority request is preempted
back to the queue and its committed tokens replay through prefill.

On CUDA the prefill chunk is rounded up to a multiple of the block size,
so every chunk takes the page-aligned chunk-write kernel (K6), and the
block size must be one the CUDA kernels take (16..256 in steps of 16).

Every decode forward is one call of a decode *rung*: k decode steps (k = 1
for ``step()``, k >= 2 for ``step_burst``) with the tokens, lengths,
history and ``min_new_tokens`` countdown carried on the device and one
host readback at the end (the JAX package's ``decode_fn`` and
``make_burst_fn(k)``). On the card a rung is a captured CUDA graph, keyed
by k and the ``MIXQ_KV_SPLITS`` value in force (read while capturing and
baked in); its first use runs the body once eagerly on a side stream (to
build kernels, grow the split kernels' scratch and set up cuBLAS; the
replay rewrites every KV slot that pass wrote), captures it into the one
graph memory pool all rungs share, and replays it; every later call
replays it. A failed capture or replay raises: there is no eager retry.
The host copies every input it changes into one static buffer before
each replay, and the graphs hold the params' and the KV pools' storage,
so neither may be replaced while the Executor lives. On the CPU the same
rungs run eagerly. ``run(burst, mixed_burst)``, ``step_serving`` and
``warmup`` drive them as the JAX Executor drives its programs;
``compiles_since_warmup`` counts rungs and kernel builds made after
warmup (utils/compile_watch). Prefill chunks and the speculative rounds
run eagerly.

``run_speculative`` is in-flight speculative decoding with a paged draft
pool: a draft model proposes gamma tokens per lane, the target verifies
them in one (gamma+1)-row forward (K9), and the rounds run device-paced
(``rounds_per_call`` rounds, one host readback) where the context cap
allows. ``MIXQ_KV_SPLITS`` > 1 sends every decode step's attention through
the split kernel (K11).

``run_beams`` serves the queue with paged beam search (runtime/beam.py)
in batches of up to max_batch requests, through a BeamEngine the Executor
keeps: a pool of its own and, on the card, one CUDA graph a burst key,
each burst a replay; ``warmup_beams`` makes that set beforehand, and
``compiles_since_warmup`` counts the beam programs and graphs too.

Not ported yet: the dense-cache draft (``paged_draft=False``, which needs
the dense forward), snapshot/restore, meshes, LoRA, prefix reuse, bad
words, logits processors, ``max_queue_size`` and iteration stats.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import common as mcommon
from ..models.common import ModelConfig
from ..ops import _build
from ..ops.paged_attention import check_kernel_geometry
from ..utils import compile_watch
from .kv_cache import PAD_POS, BlockManager, PagedKVState, init_paged_kv
from .sampler import (SamplingConfig, SamplingParams, batch_params,
                      sample_batched)

HISTORY_W = 64   # repetition-penalty window (recent tokens per lane)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n <= 1 -> 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n must be >= 1)."""
    return 1 << (n.bit_length() - 1)


class StaticInputs:
    """Every input the host changes between calls of a captured graph, in
    one int32 buffer (the ``floats`` fields bit-cast) that one copy moves
    to the device (pinned on the host, so the copy is asynchronous).
    ``host`` holds numpy views to fill, ``dev`` the tensor views the graph
    reads; each field starts 16 bytes in. On the CPU the two are one
    buffer."""

    def __init__(self, shapes: Dict[str, tuple], device: torch.device,
                 floats: Sequence[str] = ()):
        spans, n = {}, 0
        for name, shape in shapes.items():
            size = int(np.prod(shape))
            spans[name] = (n, size)
            n += -(-size // 4) * 4
        cuda = device.type == "cuda"
        self.buf_host = torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
        self.buf_dev = (torch.zeros((n,), dtype=torch.int32, device=device)
                        if cuda else self.buf_host)
        flat = self.buf_host.numpy()
        self.host, self.dev = {}, {}
        for name, (o, size) in spans.items():
            self.host[name] = flat[o:o + size].reshape(shapes[name])
            self.dev[name] = self.buf_dev[o:o + size].view(shapes[name])
            if name in floats:
                self.host[name] = self.host[name].view(np.float32)
                self.dev[name] = self.dev[name].view(torch.float32)

    def upload(self) -> None:
        if self.buf_dev is not self.buf_host:
            self.buf_dev.copy_(self.buf_host, non_blocking=True)


class _DecodeInputs(StaticInputs):
    """The decode rungs' static inputs."""

    def __init__(self, b: int, mb: int, device: torch.device):
        super().__init__(
            {"tokens": (b, 1), "lens": (b,), "sup_tok": (b,),
             "min_left": (b,), "top_k": (b,), "greedy": (b,),
             "temperature": (b,), "top_p": (b,), "penalty": (b,),
             "table": (b, mb), "bpos": (b, mb), "history": (b, HISTORY_W)},
            device, ("temperature", "top_p", "penalty"))

    def sampling(self) -> SamplingParams:
        d = self.dev
        return SamplingParams(temperature=d["temperature"],
                              top_k=d["top_k"].long(), top_p=d["top_p"],
                              greedy=d["greedy"] != 0,
                              repetition_penalty=d["penalty"])


def capture_graph(body, device: torch.device, pool, what: str, warm=None,
                  generator: Optional[torch.Generator] = None):
    """Capture ``body()`` as a CUDA graph into the graph memory pool
    ``pool``. A warm pass (``warm()``, by default ``body()``) runs first,
    eagerly on a side stream: it builds kernels, grows the split kernels'
    scratch and sets up cuBLAS, none of which may happen while capturing.
    ``generator`` is registered with the graph, so each replay draws anew.
    The launches counted while capturing are taken back out of LAUNCHES
    and returned as the graph's per-replay counts. Returns (graph, body's
    output, launches); a failed capture raises."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        (warm or body)()
    cur.wait_stream(side)
    mark = dict(_build.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = body()
    except Exception as e:
        raise RuntimeError(f"{what}: CUDA graph capture failed ({e})") from e
    finally:
        launches = {n: c - mark.get(n, 0)
                    for n, c in _build.LAUNCHES.items()
                    if c != mark.get(n, 0)}
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(mark)
    return graph, out, launches


def read_back(*ts: torch.Tensor) -> List[np.ndarray]:
    """The int / bool / float device tensors ``ts`` on the host in ONE
    copy (the floats as f32 bit-cast through int32): as numpy arrays of
    int32, or f32 for the floating ones."""
    parts = [(t.float() if t.is_floating_point() else t.int())
             .reshape(-1).view(torch.int32) for t in ts]
    flat = (parts[0] if len(parts) == 1
            else torch.cat(parts)).cpu().numpy()
    out, o = [], 0
    for t in ts:
        a = flat[o:o + t.numel()].reshape(tuple(t.shape))
        o += t.numel()
        out.append(a.view(np.float32) if t.is_floating_point() else a)
    return out


@dataclasses.dataclass
class _Rung:
    """A decode program of k steps. On the card: its graph, the graph's
    output ((B, 2k) int32: the tokens, then the log-probabilities bit-cast)
    and the kernel launches its capture recorded, which every replay adds
    to ``ops._build.LAUNCHES``."""
    k: int
    graph: Optional[object] = None
    out: Optional[torch.Tensor] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    sampling: Optional[SamplingConfig] = None   # None = executor default
    min_new_tokens: int = 0
    priority: float = 0.5                       # 0..1, higher admits first
    stop_sequences: Optional[List[List[int]]] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_time: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    prefill_pos: int = 0                # tokens already prefilled
    # preemption: (orig_prompt_len, prior_generated, prior_logprobs,
    # orig_max, orig_min) riding the request until _finish unstitches it
    resume: Optional[tuple] = None

    @property
    def sequence(self) -> List[int]:
        return self.prompt + self.generated


class Executor:
    """Submit token requests; step() advances everything one decode step."""

    def __init__(self, params, cfg: ModelConfig, max_batch: int = 8,
                 max_seq_len: int = 2048, block_size: int = 64,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: int = 256, prefill_lanes: int = 4,
                 sampling: SamplingConfig = SamplingConfig(),
                 sink_blocks: int = 0, window_blocks: Optional[int] = None,
                 max_kv_tokens: int = 0, seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_kernel_geometry(block_size, cfg.head_dim)
            # page-aligned chunks take the chunk-write kernel
            prefill_chunk = -(-prefill_chunk // block_size) * block_size
        window_blocks = window_blocks or None   # 0 == unwindowed
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.max_blocks_per_seq = -(-max_seq_len // block_size)
        if max_kv_tokens and num_blocks is None:
            # pool sized to a KV-token budget; decode-time exhaustion
            # preempts (see _preempt). +1: the trash block
            num_blocks = -(-max_kv_tokens // block_size) + 1
        num_blocks = num_blocks or (max_batch * self.max_blocks_per_seq + 1)
        self.state: PagedKVState = init_paged_kv(cfg, num_blocks, block_size,
                                                 device=self.device)
        self.bm = BlockManager(num_blocks, block_size,
                               sink_blocks=sink_blocks,
                               window_blocks=window_blocks)
        self._win_tokens = (window_blocks * block_size) if window_blocks \
            else 0
        self._sink_tokens = sink_blocks * block_size
        self.sampling = sampling
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.prefilling: List[Request] = []   # admitted, pages held
        self._next_id = 0
        self.finished: Dict[int, Request] = {}
        self.preemptions = 0
        self.prefill_chunk = prefill_chunk
        self.prefill_lanes = max(1, min(prefill_lanes, max_batch))
        self._dec = _DecodeInputs(max_batch, self.max_blocks_per_seq,
                                  self.device)
        self._rungs: Dict[Tuple[int, int], _Rung] = {}
        self._graph_pool = None
        # decode calls (one rung each), the steps they ran, the graphs
        # replayed (the card only), the host readbacks of sampled tokens
        self.decode_calls = self.decode_steps = self.graph_replays = 0
        self.readbacks = 0
        self._warm_compile_mark: Optional[int] = None
        self._warm_cache_mark: Optional[int] = None
        self._beams = None   # runtime.beam.BeamEngine of run_beams

    # ------------------------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor, reqs, configs, sup_tok,
                sup_flag):
        """Sample one token per lane; returns (tokens, logprobs) tensors."""
        samp = batch_params(configs, device=self.device)
        tok = sample_batched(logits, self.generator, samp,
                             history=self._t(self._history(reqs)),
                             suppress_token=self._t(sup_tok),
                             suppress_flag=self._t(sup_flag))
        lp = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                          tok[:, None])[:, 0]
        return tok, lp

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None,
               sampling: Optional[SamplingConfig] = None,
               min_new_tokens: int = 0,
               stop_sequences: Optional[Sequence[Sequence[int]]] = None,
               priority: float = 0.5) -> int:
        """Queue a request; returns its id. ``sampling`` overrides the
        executor default for this request; stop_sequences are token-id
        suffixes that end it (kept in the output)."""
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"> max_seq_len ({self.max_seq_len})")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(
            rid, list(prompt), max_new_tokens, eos_token_id,
            sampling=sampling, min_new_tokens=min_new_tokens,
            priority=priority,
            stop_sequences=[list(w) for w in stop_sequences]
            if stop_sequences else None))
        return rid

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.prefilling) or self.num_active > 0

    def _free_slots(self) -> int:
        return self.max_batch - self.num_active - len(self.prefilling)

    def _admit(self) -> None:
        """Move queued requests into the prefilling set (pages reserved),
        priority first, then FIFO; the head waits for pages rather than
        being skipped."""
        while (self.queue and self._free_slots() > 0
               and len(self.prefilling) < self.prefill_lanes):
            req = max(self.queue, key=lambda r: (r.priority, -r.req_id))
            if not self.bm.can_allocate(len(req.prompt) + 1):
                break
            self.queue.remove(req)
            self.bm.add_sequence(req.req_id, len(req.prompt))
            self.prefilling.append(req)

    def _history(self, reqs: Sequence[Optional[Request]]) -> np.ndarray:
        """(len(reqs), HISTORY_W) recent tokens, right-aligned, -1 padded."""
        out = np.full((len(reqs), HISTORY_W), -1, np.int32)
        for i, req in enumerate(reqs):
            if req is None:
                continue
            tail = req.sequence[-HISTORY_W:]
            out[i, HISTORY_W - len(tail):] = tail
        return out

    def _step_prefill(self) -> None:
        """Advance every in-flight prefill by one chunk (one batched call).
        The chunk is the smallest power-of-two multiple of the block size
        covering the lanes' remaining prompt, capped at prefill_chunk; the
        lane count is the smallest power of two covering the lanes."""
        if not self.prefilling:
            return
        lanes = self.prefilling[:self.prefill_lanes]
        p = min(self.prefill_lanes, pow2_ceil(len(lanes)))
        lane_rows: List[Optional[Request]] = \
            list(lanes) + [None] * (p - len(lanes))
        rem = max(len(r.prompt) - r.prefill_pos for r in lanes)
        c_eff = self.block_size
        while c_eff < min(rem, self.prefill_chunk):
            c_eff *= 2
        chunk = min(self.prefill_chunk, c_eff)
        mbs = self.max_blocks_per_seq
        tokens = np.zeros((p, chunk), np.int32)
        start = np.zeros((p,), np.int32)
        length = np.zeros((p,), np.int32)   # 0 disables the lane
        table = np.zeros((p, mbs), np.int32)
        bpos = np.full((p, mbs), PAD_POS, np.int32)
        sup_tok = np.full((p,), -1, np.int32)
        sup_flag = np.zeros((p,), np.int32)
        for i, req in enumerate(lanes):
            c0 = req.prefill_pos
            piece = req.prompt[c0: c0 + chunk]
            tokens[i, :len(piece)] = piece
            start[i] = c0
            length[i] = min(len(req.prompt), c0 + chunk)
            table[i] = self.bm.block_table([req.req_id], mbs)[0]
            bpos[i] = self.bm.block_pos([req.req_id], mbs)[0]
            if req.eos_token_id is not None and req.min_new_tokens > 0:
                sup_tok[i] = req.eos_token_id
                sup_flag[i] = 1
        start_t, length_t = self._t(start), self._t(length)
        pos = start_t[:, None] + torch.arange(chunk, dtype=torch.int32,
                                              device=self.device)[None, :]
        logits, self.state = mcommon.forward_paged(
            self.params, self.cfg, self._t(tokens), pos, self.state,
            self._t(table), length_t, block_pos=self._t(bpos),
            window=self._win_tokens, sink=self._sink_tokens,
            last_pos=torch.clamp(length_t - start_t - 1, 0, chunk - 1))
        finishing = [int(length[i]) >= len(req.prompt)
                     for i, req in enumerate(lanes)]
        tok_np = lp_np = None
        if any(finishing):
            # mid-prompt chunks discard the sample: no readback for them
            tok, lp = self._sample(
                logits[:, 0], lane_rows,
                [r.sampling or self.sampling if r is not None else None
                 for r in lane_rows], sup_tok, sup_flag)
            tok_np, lp_np = self._readback(tok, lp)
        for i, req in enumerate(lanes):
            req.prefill_pos = int(length[i])
            if finishing[i]:
                self.prefilling.remove(req)
                self.slots[self.slots.index(None)] = req
                req.first_token_time = time.perf_counter()
                self._append_token(req, int(tok_np[i]), float(lp_np[i]))

    def _append_token(self, req: Request, tok: int,
                      logprob: Optional[float] = None) -> None:
        req.generated.append(tok)
        if logprob is not None:
            req.logprobs.append(logprob)
        hit_eos = (req.eos_token_id is not None and tok == req.eos_token_id
                   and len(req.generated) > req.min_new_tokens)
        hit_stop = False
        if req.stop_sequences and not hit_eos:
            # tokens generated before a preemption count as output
            gen = req.resume[1] + req.generated if req.resume \
                else req.generated
            hit_stop = any(len(gen) >= len(ss) and gen[-len(ss):] == ss
                           for ss in req.stop_sequences)
        if hit_eos or hit_stop or len(req.generated) >= req.max_new_tokens:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.done = True
        req.finish_time = time.perf_counter()
        if req.resume is not None:
            # preempted request: re-split the replayed prompt and stitch
            # the earlier output back so callers see ONE generation
            plen, old_gen, old_lp, omax, omin = req.resume
            req.prompt = req.prompt[:plen]
            req.generated = old_gen + req.generated
            req.logprobs = old_lp + req.logprobs
            req.max_new_tokens, req.min_new_tokens = omax, omin
            req.resume = None
        self.bm.free_sequence(req.req_id)
        self.finished[req.req_id] = req
        self.slots[self.slots.index(req)] = None

    def _pick_victim(self) -> Optional[Request]:
        """Lowest priority, then most recently submitted."""
        cands = [r for r in self.slots if r is not None]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.req_id))

    def _preempt(self, req: Request) -> None:
        """Evict an active request back to the queue under KV pressure,
        freeing its pages; its committed tokens replay through chunked
        prefill on re-admission."""
        self.preemptions += 1
        self.bm.free_sequence(req.req_id)
        self.slots[self.slots.index(req)] = None
        if req.resume is None:
            req.resume = (len(req.prompt), [], [], req.max_new_tokens,
                          req.min_new_tokens)
        plen, old_gen, old_lp, omax, omin = req.resume
        req.resume = (plen, old_gen + req.generated,
                      old_lp + req.logprobs, omax, omin)
        done_tokens = len(req.resume[1])
        req.prompt = req.prompt + req.generated
        req.max_new_tokens = omax - done_tokens
        req.min_new_tokens = max(0, omin - done_tokens)
        req.generated, req.logprobs = [], []
        req.prefill_pos = 0
        self.queue.append(req)

    def _secure_pages(self, k: int) -> None:
        """Preempt lowest-priority actives until every decode lane can
        extend by k tokens (a lane crossing a page boundary needs a fresh
        block). Windowed managers recycle in place and never run dry."""
        if self.bm.window_blocks:
            return
        bs = self.block_size
        while True:
            lanes = [r for r in self.slots if r is not None]
            if not lanes:
                return
            need = 0
            for r in lanes:
                ln = max(len(r.sequence) - 1, 1)
                need += (ln + k + bs - 1) // bs - (ln + bs - 1) // bs
            if need <= self.bm.num_free:
                return
            if len(lanes) == 1:
                raise RuntimeError(
                    "KV pool exhausted: the single active request cannot "
                    f"extend by {k} tokens (free {self.bm.num_free} blocks);"
                    " size the pool larger (max_kv_tokens)")
            self._preempt(self._pick_victim())

    def _decode_body(self, k: int) -> torch.Tensor:
        """k decode steps from the static inputs (``_DecodeInputs.dev``),
        which it only reads: the tokens, lengths, history and min_new
        countdown are carried as new tensors, as the JAX burst's scan
        carries them. Returns (B, 2k) int32: the tokens, then the
        log-probabilities bit-cast."""
        d = self._dec.dev
        samp = self._dec.sampling()
        tok, lens, hist, min_left = (d["tokens"], d["lens"], d["history"],
                                     d["min_left"])
        toks, lps = [], []
        for j in range(k):
            logits, _ = mcommon.forward_paged(
                self.params, self.cfg, tok, lens[:, None], self.state,
                d["table"], torch.clamp(lens + 1, min=1),
                block_pos=d["bpos"], window=self._win_tokens,
                sink=self._sink_tokens)
            last = logits[:, 0]
            t = sample_batched(last, self.generator, samp, history=hist,
                               suppress_token=d["sup_tok"],
                               suppress_flag=(min_left > 0).int())
            toks.append(t.int())
            lps.append(torch.gather(torch.log_softmax(last, dim=-1), 1,
                                    t[:, None])[:, 0])
            if j + 1 < k:
                tok = toks[-1][:, None]
                lens = lens + 1
                hist = torch.cat([hist[:, 1:], tok], dim=1)
                min_left = torch.clamp(min_left - 1, min=0)
        return torch.cat([torch.stack(toks, dim=1),
                          torch.stack(lps, dim=1).view(torch.int32)], dim=1)

    def _rung(self, k: int) -> _Rung:
        """The k-step decode rung under the MIXQ_KV_SPLITS value in force,
        made at first use (a program made: compile_watch)."""
        key = (k, mcommon._kv_splits())
        rung = self._rungs.get(key)
        if rung is None:
            rung = self._capture(k) if self.device.type == "cuda" \
                else _Rung(k)
            compile_watch.note_program()
            self._rungs[key] = rung
        return rung

    def _capture(self, k: int) -> _Rung:
        """The k-step body captured into the shared graph pool, with the
        Executor's generator registered so that each replay draws anew."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph, out, launches = capture_graph(
            lambda: self._decode_body(k), self.device, self._graph_pool,
            f"decode rung k={k}", generator=self.generator)
        return _Rung(k, graph, out, launches)

    def _decode(self, k: int, active) -> Tuple[np.ndarray, np.ndarray]:
        """One call of the k-step rung over the (slot, request) pairs
        ``active`` (pages already extended by k): fill and upload the
        static inputs, run (replay on the card), read back once. Returns
        (tokens (B, k) int32, log-probabilities (B, k) f32)."""
        h = self._dec.host
        b = self.max_batch
        table, bpos = self._lane_tables(active)
        h["tokens"][:] = 0
        h["lens"][:] = 0
        h["sup_tok"][:] = -1
        h["min_left"][:] = 0
        h["table"][:], h["bpos"][:] = table, bpos
        h["history"][:] = self._history(self.slots)
        configs: List[SamplingConfig] = [SamplingConfig()] * b
        for i, req in active:
            # the incoming token is the last generated one, at position
            # seq_len - 1 (everything before it is in the cache)
            h["tokens"][i, 0] = req.generated[-1]
            h["lens"][i] = len(req.prompt) + len(req.generated) - 1
            configs[i] = req.sampling or self.sampling
            if req.eos_token_id is not None:
                h["sup_tok"][i] = req.eos_token_id
                h["min_left"][i] = max(0, req.min_new_tokens
                                       - len(req.generated))
        for name, attr in (("temperature", "temperature"),
                           ("top_k", "top_k"), ("top_p", "top_p"),
                           ("greedy", "is_greedy"),
                           ("penalty", "repetition_penalty")):
            h[name][:] = [getattr(c, attr) for c in configs]
        self._dec.upload()
        rung = self._rung(k)
        if rung.graph is None:
            out = self._decode_body(k)
        else:
            rung.graph.replay()
            _build.add_launches(rung.launches)
            self.graph_replays += 1
            out = rung.out
        self.decode_calls += 1
        self.decode_steps += k
        (a,) = self._readback(out)
        return a[:, :k], a[:, k:].view(np.float32)

    def step(self) -> int:
        """Admit + one prefill chunk + one batched decode step (rung 1).
        Returns tokens produced (decode lanes + completed prefills)."""
        self._admit()
        produced_before = sum(len(r.generated) for r in self.slots
                              if r is not None)
        n_fin_before = len(self.finished)
        self._step_prefill()
        produced_prefill = (sum(len(r.generated) for r in self.slots
                                if r is not None) - produced_before
                            + (len(self.finished) - n_fin_before))
        self._secure_pages(1)   # may preempt under KV pressure
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return produced_prefill
        for _, req in active:
            self.bm.extend(req.req_id, 1)
        tok_np, lp_np = self._decode(1, active)
        for i, req in active:
            self._append_token(req, int(tok_np[i, 0]), float(lp_np[i, 0]))
        return len(active) + produced_prefill

    def step_burst(self, k: int) -> int:
        """k decode steps in ONE rung call (one host readback). Caller
        guarantees no queued/prefilling work. Tokens a lane produces after
        its own eos/max_new are discarded host-side; their page writes
        land in pre-extended (soon freed) or trash pages. Returns 0 (the
        caller single-steps) when pages for k tokens cannot be reserved or
        a recycling window is active (mid-burst block recycling would mask
        still-visible tokens)."""
        if self.num_active == 0 or self.bm.window_blocks:
            return 0
        try:
            self._secure_pages(k)   # may preempt under KV pressure
        except RuntimeError:
            return 0                # caller single-steps
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        for _, req in active:
            self.bm.extend(req.req_id, k)    # pages for the whole burst
        toks_np, lps_np = self._decode(k, active)
        produced = 0
        for i, req in active:
            for j in range(k):
                if req.done:
                    break
                self._append_token(req, int(toks_np[i, j]),
                                   float(lps_np[i, j]))
                produced += 1
        return produced

    # ------------------------------------------------------------------
    # in-flight speculative decoding (runtime/scheduler.py:527-926)
    # ------------------------------------------------------------------
    def _readback(self, *ts: torch.Tensor) -> List[np.ndarray]:
        """``read_back(*ts)``, counted: a call's only host sync."""
        self.readbacks += 1
        return read_back(*ts)

    def _draft_prefill(self, dp, dcfg: ModelConfig, dstate: PagedKVState,
                       tokens, lens, table, bpos) -> PagedKVState:
        """Write the draft's KV of every lane's committed tokens but the
        newest (positions 0..len-1); the head runs on one position only,
        its logits unused."""
        b, s = tokens.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device)[None].expand(b, s)
        _, dstate = mcommon.forward_paged(
            dp, dcfg, tokens, pos, dstate, table, lens, block_pos=bpos,
            last_pos=torch.zeros((b,), dtype=torch.int32,
                                 device=self.device))
        return dstate

    def _draft_propose(self, dp, dcfg: ModelConfig, dstate: PagedKVState,
                       tok, pos, table, bpos, gamma: int):
        """gamma greedy draft steps from the newest token ``tok`` (B,) at
        ``pos`` (B,); returns (proposals (B, gamma) int32, draft state)."""
        props = []
        for _ in range(gamma):
            logits, dstate = mcommon.forward_paged(
                dp, dcfg, tok[:, None], pos[:, None], dstate, table, pos + 1,
                block_pos=bpos, window=self._win_tokens,
                sink=self._sink_tokens)
            tok = torch.argmax(logits[:, 0], dim=-1).int()
            props.append(tok)
            pos = pos + 1
        return torch.stack(props, dim=1), dstate

    def _verify(self, rows, start, length, table, bpos):
        """The target forward over [newest token | gamma drafts] (B, g1) at
        start..start+gamma: (greedy predictions (B, g1) int32, their
        log-probabilities (B, g1) f32)."""
        g1 = rows.shape[1]
        pos = start[:, None] + torch.arange(g1, dtype=torch.int32,
                                            device=self.device)[None]
        logits, self.state = mcommon.forward_paged(
            self.params, self.cfg, rows, pos, self.state, table, length,
            block_pos=bpos, window=self._win_tokens, sink=self._sink_tokens)
        preds = torch.argmax(logits, dim=-1)
        lp = torch.gather(torch.log_softmax(logits, dim=-1), 2,
                          preds[..., None])[..., 0]
        return preds.int(), lp

    def _spec_device_rounds(self, dp, dcfg: ModelConfig,
                            dstate: PagedKVState, gamma: int, rounds: int,
                            table, bpos, tok, pos, remaining, done, eos):
        """``rounds`` x [gamma-step draft + (gamma+1)-row verify + accept]
        with the accept / eos / budget bookkeeping in device tensors and no
        host sync (the JAX package's _make_spec_burst round_body). A done
        lane commits cnt = 0 and rewrites positions that were already
        pre-extended, so running every round gives JAX's tokens where its
        while_loop stops early. Returns (draft state, accepted (R, B, g1),
        committed counts (R, B), log-probabilities (R, B, g1), accepted
        draft tokens (B,), proposals made (B,))."""
        g1 = gamma + 1
        jidx = torch.arange(g1, dtype=torch.int32, device=self.device)[None]
        accs, cnts, lps = [], [], []
        n_acc = torch.zeros_like(tok)
        n_prop = torch.zeros_like(tok)
        for _ in range(rounds):
            props, dstate = self._draft_propose(dp, dcfg, dstate, tok, pos,
                                                table, bpos, gamma)
            rows = torch.cat([tok[:, None], props], dim=1)
            preds, lp = self._verify(rows, pos, pos + g1, table, bpos)
            eq = (props == preds[:, :gamma]).int()
            m = torch.cumprod(eq, dim=1).sum(dim=1).int()           # (B,)
            bonus = torch.gather(preds, 1, m[:, None].long())[:, 0]
            props_pad = torch.cat([props, torch.zeros_like(tok)[:, None]],
                                  dim=1)
            acc = torch.where(jidx < m[:, None], props_pad, bonus[:, None])
            cnt = torch.minimum(m + 1, remaining)
            hit = ((acc == eos[:, None]) & (jidx < cnt[:, None])
                   & (eos[:, None] >= 0))
            has_eos = hit.any(dim=1)
            eos_idx = torch.argmax(hit.int(), dim=1).int()
            cnt = torch.where(has_eos, torch.minimum(cnt, eos_idx + 1), cnt)
            cnt = torch.where(done, 0, cnt)
            n_acc = n_acc + torch.where(done, 0, m)
            n_prop = n_prop + (~done).int() * gamma
            newtok = torch.gather(acc, 1, torch.clamp(cnt - 1, min=0)[:, None]
                                  .long())[:, 0]
            tok = torch.where(cnt > 0, newtok, tok)
            done = done | has_eos | (remaining - cnt <= 0)
            pos = pos + cnt
            remaining = remaining - cnt
            accs.append(acc)
            cnts.append(cnt)
            lps.append(lp)
        return (dstate, torch.stack(accs), torch.stack(cnts),
                torch.stack(lps), n_acc, n_prop)

    def _lane_tables(self, lanes) -> Tuple[np.ndarray, np.ndarray]:
        """(max_batch, MB) block tables and base positions of the (slot,
        request) pairs ``lanes``; other slots: the trash block at
        PAD_POS."""
        mbs = self.max_blocks_per_seq
        table = np.zeros((self.max_batch, mbs), np.int32)
        bpos = np.full((self.max_batch, mbs), PAD_POS, np.int32)
        for i, r in lanes:
            table[i] = self.bm.block_table([r.req_id], mbs)[0]
            bpos[i] = self.bm.block_pos([r.req_id], mbs)[0]
        return table, bpos

    def _spec_call(self, dp, dcfg: ModelConfig, dstate: PagedKVState,
                   gamma: int, rounds: int) -> PagedKVState:
        """One call of ``rounds`` speculative rounds (1: host-paced, the
        JAX Executor's per-round loop; more: its device-paced burst): pre-
        extend every lane's pages for the call's worst case, run the rounds,
        read the committed tokens back once, append them (host-side stop /
        eos unstitching via _append_token), rewind to the manager's rest
        state."""
        g1 = gamma + 1
        b = self.max_batch
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        tok0 = np.zeros((b,), np.int32)
        pos0 = np.full((b,), self.max_seq_len - rounds * g1 - 2, np.int32)
        remaining = np.zeros((b,), np.int32)
        done = np.ones((b,), bool)
        eos = np.full((b,), -1, np.int32)
        for i, r in active:
            self.bm.extend(r.req_id, rounds * g1)
            tok0[i] = r.sequence[-1]
            pos0[i] = len(r.sequence) - 1
            remaining[i] = r.max_new_tokens - len(r.generated)
            done[i] = False
            if r.eos_token_id is not None:
                eos[i] = r.eos_token_id
        table, bpos = self._lane_tables(active)
        self.spec_calls += 1
        dstate, accs, cnts, lps, n_acc, n_prop = self._spec_device_rounds(
            dp, dcfg, dstate, gamma, rounds, self._t(table), self._t(bpos),
            self._t(tok0), self._t(pos0), self._t(remaining), self._t(done),
            self._t(eos))
        self.spec_readbacks += 1
        toks_np, cnts_np, lps_np, acc_np, prop_np = self._readback(
            accs, cnts, lps, n_acc, n_prop)
        # a round ran for JAX's while_loop iff some lane committed in it
        self.spec_rounds += int((cnts_np.sum(axis=1) > 0).sum())
        self.spec_accepted += int(acc_np.sum())
        self.spec_proposed += int(prop_np.sum())
        for ridx in range(rounds):
            for i, r in active:
                for j in range(int(cnts_np[ridx, i])):
                    if r.done:
                        break
                    self._append_token(r, int(toks_np[ridx, i, j]),
                                       float(lps_np[ridx, i, j]))
        for i, r in active:
            if not r.done:
                # manager rest state: the newest token's page is allocated
                # by the NEXT round's extend
                self.bm.rewind(r.req_id, len(r.sequence) - 1)
        return dstate

    def run_speculative(self, draft_params, draft_cfg: ModelConfig,
                        gamma: int = 4, paged_draft: bool = True,
                        rounds_per_call: int = 8) -> Dict[int, Request]:
        """Drive all submitted work with in-flight speculative decoding:
        a draft model (its own paged KV pool, the same block tables: one
        allocator, two pools) proposes gamma greedy tokens per lane, one
        (gamma+1)-row target forward verifies them, and each lane commits
        the agreeing prefix plus the target's next token. Greedy requests
        only: the outputs equal run()'s. Queued requests are admitted and
        prefilled through step() first; lanes that finish mid-flight run on
        as masked lanes until the batch drains.

        rounds_per_call > 1 runs that many rounds per call with the
        bookkeeping on the device and one host readback at the end; a lane
        within gamma tokens of the context cap finishes with plain step()s.
        Counters: ``spec_rounds`` (as the JAX Executor's), ``spec_accepted``
        / ``spec_proposed`` (draft tokens), ``spec_calls`` /
        ``spec_readbacks`` (host syncs)."""
        if not paged_draft:
            raise NotImplementedError(
                "paged_draft=False needs the dense forward and KVCache, "
                "which come with the dense-forward slice of the port")
        assert gamma >= 1 and gamma + 1 < self.block_size, \
            "gamma+1 must stay below the page size (unaligned chunk rows)"
        assert not self.bm.window_blocks, \
            "speculative rewind unsupported with windowed KV"
        self.spec_rounds = self.spec_accepted = self.spec_proposed = 0
        self.spec_calls = self.spec_readbacks = 0
        while self.queue or self.prefilling:
            self.step()
        if self.num_active == 0:
            return self.finished
        for r in self.slots:
            if r is not None:
                assert (r.sampling or self.sampling).is_greedy, \
                    "speculative decoding is greedy-only"
                assert r.min_new_tokens == 0, \
                    "min_new_tokens unsupported in spec mode"

        # prefill the draft with every lane's committed tokens EXCEPT the
        # newest (the round feeds it, as the target's rounds do)
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        bucket = max(8, pow2_ceil(max(len(r.sequence) - 1
                                      for _, r in active)))
        toks = np.zeros((self.max_batch, bucket), np.int32)
        lens = np.ones((self.max_batch,), np.int32)
        for i, r in active:
            toks[i, :len(r.sequence) - 1] = r.sequence[:-1]
            lens[i] = len(r.sequence) - 1
        table, bpos = self._lane_tables(active)
        dstate = init_paged_kv(draft_cfg, self.bm.num_blocks,
                               self.block_size, device=self.device)
        dstate = self._draft_prefill(draft_params, draft_cfg, dstate,
                                     self._t(toks), self._t(lens),
                                     self._t(table), self._t(bpos))

        g1 = gamma + 1
        while self.num_active > 0:
            live = [r for r in self.slots if r is not None]
            if any(len(r.sequence) + gamma > self.max_seq_len
                   for r in live):
                # a lane within gamma tokens of the context cap cannot
                # absorb a whole verify chunk: finish it with plain steps
                self.step()
                continue
            # device-paced where every lane has room for the call's rounds
            maxlen = max(len(r.sequence) for r in live)
            room = (self.max_seq_len - maxlen) // g1 >= rounds_per_call
            rounds = rounds_per_call if rounds_per_call > 1 and room else 1
            dstate = self._spec_call(draft_params, draft_cfg, dstate, gamma,
                                     rounds)
        return self.finished

    @property
    def compiles_since_warmup(self) -> Optional[int]:
        """Programs made since warmup() or warmup_beams() finished (None
        before either): rungs and beam programs (prefill, step, burst; a
        burst's graph on the card) used for the first time and kernel
        libraries built. Serving makes none iff this stays 0."""
        if self._warm_compile_mark is None:
            return None
        return compile_watch.compile_count() - self._warm_compile_mark

    @property
    def cache_loads_since_warmup(self) -> Optional[int]:
        """Kernel libraries loaded without a build since warmup() finished
        (None before warmup)."""
        if self._warm_cache_mark is None:
            return None
        return compile_watch.cache_hit_count() - self._warm_cache_mark

    def warmup(self, prompt_len: Optional[int] = None, burst: int = 1
               ) -> None:
        """Make the decode rungs and build the kernels before real
        traffic. Runs one dummy request end to end and discards it; with
        burst > 1 its budget is sized so that the rung LADDER (burst,
        burst/2, ..., 2: run()'s tail and mixed bursts) is made too, each
        rung by a request of budget k+2 (the prefill emits one token and
        the admission step may decode one more, leaving at least k). Then
        a pass for every prefill lane count up to prefill_lanes."""
        if self.has_work:
            raise RuntimeError("warmup() on an idle executor only")
        try:
            budget = burst + 1 if burst <= 1 else 2 * burst
            n = prompt_len or min(self.prefill_chunk, self.max_seq_len // 2)
            n = min(n, self.max_seq_len - budget - 2)
            rid = self.submit([1] * max(n, 1), max_new_tokens=budget)
            self.run(burst=burst)
            self.finished.pop(rid, None)
            k = burst // 2
            while k >= 2:
                rid = self.submit([1] * max(n, 1), max_new_tokens=k + 2)
                self.run(burst=k)
                self.finished.pop(rid, None)
                k //= 2
            if burst > 1:
                # the choreography above must have made every rung: fail
                # here rather than mid-serving
                want = {burst}
                k = burst // 2
                while k >= 2:
                    want.add(k)
                    k //= 2
                splits = mcommon._kv_splits()
                missing = sorted(k for k in want
                                 if (k, splits) not in self._rungs)
                if missing:
                    raise RuntimeError(
                        f"warmup failed to make burst rungs {missing}")
            # the lane counts _step_prefill can take: powers of two, and
            # prefill_lanes itself
            cs = [c for c in (2, 4, 8, 16, 32, 64)
                  if c < self.prefill_lanes] + [self.prefill_lanes]
            for c in cs:
                if c < 2 or c > self.max_batch:
                    continue
                rids = [self.submit([1] * max(n, 1), max_new_tokens=1)
                        for _ in range(c)]
                self.run()
                for r in rids:
                    self.finished.pop(r, None)
        finally:
            self._warm_compile_mark = compile_watch.compile_count()
            self._warm_cache_mark = compile_watch.cache_hit_count()

    @property
    def beam_engine(self):
        """The BeamEngine run_beams and warmup_beams serve through (made at
        first use): its pool, burst programs and graphs, and counters."""
        if self._beams is None:
            from .beam import BeamEngine
            self._beams = BeamEngine(self.params, self.cfg, self.device)
        return self._beams

    def warmup_beams(self, num_beams: int = 4, burst: int = 16,
                     prompt_bucket: int = 512, max_new_tokens: int = 64,
                     eos_token_id: Optional[int] = None) -> None:
        """Make the beam-serving programs of (max_batch, num_beams, burst,
        prompt_bucket, max_new_tokens) before real traffic: the prefill,
        the burst keys that budget produces (full bursts and one pow2
        ceiling tail) and both copy-on-write variants, by one run with
        page-aligned prompts and one with an unaligned lane, each a full
        batch of dummy requests. The unaligned run goes first: its pool is
        the larger (a copy-on-write page a lane), so the aligned run's
        graphs are made over the pool that serving keeps. Full batches in
        the same prompt bucket with the same eos then make no program; a
        partial final batch is its own geometry. Requests with
        min_new_tokens or stop sequences change the burst key and are
        made at first sight."""
        from .beam import paged_beam_search
        b = self.max_batch
        pb = min(prompt_bucket, self.max_seq_len - max_new_tokens)
        p2 = 8
        while p2 * 2 <= pb:
            p2 *= 2
        pb = min(p2, pb)   # pow2: both variants land in one bucket
        variants = []
        if pb > 1:
            variants.append([pb - 1] + [pb] * (b - 1))
        variants.append([pb] * b)
        for plens in variants:
            paged_beam_search(
                self.params, self.cfg, [[1] * n for n in plens],
                max_new_tokens, num_beams=num_beams,
                eos_token_id=eos_token_id, max_seq_len=self.max_seq_len,
                block_size=self.block_size, burst=burst,
                engine=self.beam_engine)
        self._warm_compile_mark = compile_watch.compile_count()
        self._warm_cache_mark = compile_watch.cache_hit_count()

    def run_beams(self, num_beams: int = 4, length_penalty: float = 1.0,
                  burst: int = 16) -> Dict[int, Request]:
        """Serve every queued request with paged copy-on-write beam search
        (runtime.beam.paged_beam_search): FIFO batches of up to max_batch,
        each request's prompt KV written once and shared by its beams; the
        best hypothesis lands in Request.generated. The beam configuration
        is uniform: every queued request must share max_new_tokens and
        eos_token_id. min_new_tokens and stop_sequences apply inside the
        beam step, per request."""
        from .beam import paged_beam_search
        if self.num_active or self.prefilling:
            raise RuntimeError("run_beams drives queued work only (drain "
                               "decode work first)")
        if not self.queue:
            return self.finished
        budgets = {r.max_new_tokens for r in self.queue}
        eoses = {r.eos_token_id for r in self.queue}
        if len(budgets) != 1 or len(eoses) != 1:
            raise ValueError(
                "run_beams needs uniform max_new_tokens and eos across the "
                f"queue (got budgets {budgets}, eos {eoses})")
        n, eos = budgets.pop(), eoses.pop()
        while self.queue:
            batch = [self.queue.popleft()
                     for _ in range(min(self.max_batch, len(self.queue)))]
            res = paged_beam_search(
                self.params, self.cfg, [r.prompt for r in batch], n,
                num_beams=num_beams, length_penalty=length_penalty,
                eos_token_id=eos, max_seq_len=self.max_seq_len,
                block_size=self.block_size, burst=burst,
                min_new_tokens=[r.min_new_tokens for r in batch],
                stop_sequences=[r.stop_sequences for r in batch],
                engine=self.beam_engine)
            for r, seq in zip(batch, res.sequences):
                r.generated = list(seq[len(r.prompt):])
                r.done = True
                r.finish_time = time.perf_counter()
                self.finished[r.req_id] = r
        return self.finished

    def _burst_k(self, burst: int) -> int:
        """Burst length for the current decode lanes: full `burst` while
        every lane has that much budget left, else ONE pow2-CEILING burst
        for the batch tail (overshoot discarded host-side): a descending
        ladder would pay a host readback per rung. The ceiling must still
        fit the lanes' page capacity, else it floors to what does."""
        lanes = [r for r in self.slots if r is not None]
        rem = min(r.max_new_tokens - len(r.generated) for r in lanes)
        if rem >= burst:
            return burst
        k = min(pow2_ceil(rem), burst)
        cap = self.max_seq_len - max(len(r.sequence) for r in lanes)
        if k > cap:
            k = pow2_floor(max(rem, 1))
        return k

    def run(self, burst: int = 1, mixed_burst: int = 1) -> Dict[int, Request]:
        """Drive until all submitted work is finished.

        burst > 1 decodes in k-step rungs (greedy outputs identical to
        burst=1; stochastic streams differ by draw order only), sized by
        _burst_k (full-size until the batch tail, then one pow2-ceiling
        burst): O(log burst) rungs. mixed_burst > 1 also lets decode lanes
        ride short bursts behind a prefill chunk while requests are queued
        or prefilling: one host readback covers a prefill chunk plus
        mixed_burst decode tokens a lane (continuous-arrival serving;
        drain-style batch runs are better off with the default 1, since
        bursting behind admission waves desyncs lane budgets)."""
        while self.has_work:
            produced = self.step_serving(burst, mixed_burst)
            if produced == 0 and self.queue and not self.prefilling:
                raise RuntimeError(
                    "scheduler stalled: queue non-empty but nothing "
                    "admittable (KV pool too small for the next request)")
        return self.finished

    def step_serving(self, burst: int = 1, mixed_burst: int = 8) -> int:
        """One scheduling iteration, the loop body of run(), for external
        drivers: burst decode when nothing is queued/prefilling, admit +
        prefill chunk + mixed burst otherwise, plain step() as the
        fallback. Returns tokens produced (0 also covers a pure-prefill
        advance)."""
        if burst > 1 and self.num_active > 0:
            if not self.queue and not self.prefilling:
                k = self._burst_k(burst)
                produced = self.step_burst(k) if k > 1 else 0
                if produced:
                    return produced
            elif mixed_burst > 1:
                self._admit()
                self._step_prefill()
                # floor to a pow2: a non-pow2 mixed_burst would make its
                # own (unwarmed) rung
                k = min(self._burst_k(burst), pow2_floor(mixed_burst))
                produced = self.step_burst(k) if k > 1 else 0
                if produced:
                    return produced
        return self.step()
