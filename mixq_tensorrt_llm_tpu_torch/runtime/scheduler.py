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

``run_speculative`` is in-flight speculative decoding: a draft model,
over a paged pool of its own (``paged_draft``) or a dense cache,
proposes gamma tokens per lane, the target verifies them in one
(gamma+1)-row forward (K9), and the rounds run device-paced
(``rounds_per_call`` rounds, one host readback) where the context cap
allows. ``MIXQ_KV_SPLITS`` > 1 sends every decode step's attention through
the split kernel (K11).

``run_beams`` serves the queue with paged beam search (runtime/beam.py)
in batches of up to max_batch requests, through a BeamEngine the Executor
keeps: a pool of its own and, on the card, one CUDA graph a burst key,
each burst a replay; ``warmup_beams`` makes that set beforehand, and
``compiles_since_warmup`` counts the beam programs and graphs too.

The serving surface: per-request bad words and named logits processors
(torch callables ``(logits (B, V), history (B, W)) -> logits``, the set
fixed per Executor) in the prefill sample and inside every rung (a lane's
bad words go into a static buffer of their (N, L) bucket, N and L
powers of two, and each bucket is its own rung key: a bad-words-free
batch replays the same graphs as before), prefix reuse (``enable_block_reuse``: a request adopts the
cached full blocks its prompt starts with and prefills after them),
``cancel``, ``max_queue_size`` (``QueueFullError``), ``on_token``
streaming, ``IterationStats`` and ``get_kv_cache_stats``, and
``snapshot`` / ``restore`` (JSON, key for key the JAX Executor's, so a
snapshot of either package restores in the other).

Runtime-adaptive outliers (``cfg.quant.dynamic_outliers`` on a mix
algo): ``ostate`` (quant/dynamic.init_model_state) is seeded at
construction, threaded through every prefill call and replaced by its
result, as the JAX Executor does; decode rungs never touch it (decode is
weight-only), nor do snapshots, stats or beams. ``warmup``'s own requests
are prefills too, so they move the state, as in JAX.

Runtime LoRA (convert/lora.attach_lora): ``submit(lora_id=n)`` serves a
request with adapter n; the lanes' ids go into every prefill call, into
each decode rung's static inputs (filled before each replay, as the tokens
are) and into the speculative verifies.

Not ported yet: meshes and dp lane groups (parallel/).
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
from ..models import moe
from ..models.common import ModelConfig
from ..ops import _build
from ..quant import dynamic as qdyn
from ..ops.paged_attention import check_kernel_geometry
from ..utils import compile_watch
from .kv_cache import PAD_POS, BlockManager, PagedKVState, init_paged_kv
from .sampler import (BW_PAD, SamplingConfig, SamplingParams, batch_params,
                      sample_batched)

HISTORY_W = 64   # repetition-penalty window (recent tokens per lane)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n <= 1 -> 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n must be >= 1)."""
    return 1 << (n.bit_length() - 1)


class QueueFullError(RuntimeError):
    """submit() backpressure: the queue holds max_queue_size requests."""


@dataclasses.dataclass
class IterationStats:
    """One scheduling iteration's telemetry (``get_latest_iteration_stats``).
    kv_total_blocks counts the pool's blocks, kv_trash_blocks those no
    sequence can hold (the block manager's ``num_trash``)."""
    iter_id: int
    timestamp: float
    step_time_s: float
    num_active: int
    num_queued: int
    num_prefilling: int
    tokens_produced: int
    kv_free_blocks: int
    kv_total_blocks: int
    kv_trash_blocks: int

    @property
    def kv_cache_usage(self) -> float:
        """The held share of the blocks a sequence can hold."""
        usable = max(self.kv_total_blocks - self.kv_trash_blocks, 1)
        return 1.0 - self.kv_free_blocks / usable


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
    """The decode rungs' static inputs; with ``procs`` logits processors
    registered, their (procs, B) lane masks too; with ``lora``, the lanes'
    adapter ids."""

    def __init__(self, b: int, mb: int, device: torch.device,
                 procs: int = 0, lora: bool = False):
        shapes = {"tokens": (b, 1), "lens": (b,), "sup_tok": (b,),
                  "min_left": (b,), "top_k": (b,), "greedy": (b,),
                  "temperature": (b,), "top_p": (b,), "penalty": (b,),
                  "table": (b, mb), "bpos": (b, mb),
                  "history": (b, HISTORY_W)}
        if procs:
            shapes["proc_masks"] = (procs, b)
        if lora:
            shapes["lora"] = (b,)
        super().__init__(shapes, device, ("temperature", "top_p",
                                          "penalty"))

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
    lora_id: int = 0                            # 0 = base model
    min_new_tokens: int = 0
    priority: float = 0.5                       # 0..1, higher admits first
    bad_words: Optional[List[List[int]]] = None  # banned token sequences
    logits_processor: Optional[str] = None       # name registered on Executor
    stop_sequences: Optional[List[List[int]]] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_time: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    on_token: Optional[object] = None   # streaming callback(req, token)
    prefill_pos: int = 0                # tokens already prefilled
    # preemption or restore: (orig_prompt_len, prior_generated,
    # prior_logprobs, orig_max, orig_min) riding the request until _finish
    # unstitches it; prior_generated counts as output for stop sequences
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
                 logits_processors: Optional[Dict[str, object]] = None,
                 enable_block_reuse: bool = False, max_queue_size: int = 0,
                 max_kv_tokens: int = 0, seed: int = 0,
                 device: DeviceLike = "cuda"):
        if cfg.arch in mcommon.RECURRENT_ARCHS:
            raise NotImplementedError(
                f"{cfg.arch} carries recurrent state: use GenerationSession "
                "(the dense path); the Executor's paged pool has nothing "
                "to page")
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
        if enable_block_reuse and window_blocks:
            raise ValueError("block reuse with windows is unsupported")
        self.block_reuse = enable_block_reuse
        self.max_queue_size = max_queue_size   # 0 = unbounded
        # named logits processors, the set fixed per Executor (the rungs
        # capture it); a request selects one by name, applied to its lane
        self._proc_names = tuple(sorted(logits_processors or ()))
        self._proc_fns = tuple((logits_processors or {})[n]
                               for n in self._proc_names)
        self.sampling = sampling
        from ..convert.lora import has_lora
        self.has_lora = has_lora(params)
        # the dynamic outlier state: every prefill call reads and replaces
        # it; decode (weight-only) passes it by
        self.ostate = None
        if cfg.quant.dynamic_outliers and cfg.quant.algo.is_mix:
            self.ostate = qdyn.init_model_state(params, cfg)
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
                                  self.device, len(self._proc_names),
                                  lora=self.has_lora)
        # rungs by (k, MIXQ_KV_SPLITS, bad-words bucket (N, L) or None);
        # each bucket's static (B, N, L) buffer
        self._rungs: Dict[tuple, _Rung] = {}
        self._bw_inputs: Dict[Tuple[int, int], StaticInputs] = {}
        self._graph_pool = None
        # decode calls (one rung each), the steps they ran, the graphs
        # replayed (the card only), the host readbacks of sampled tokens
        self.decode_calls = self.decode_steps = self.graph_replays = 0
        self.readbacks = 0
        # prompt tokens run through prefill, and blocks adopted from the
        # prefix cache at admission
        self.prefill_tokens = self.reused_blocks = 0
        self.iteration_stats: deque = deque(maxlen=1000)
        self._iter_id = 0
        self._warm_compile_mark: Optional[int] = None
        self._warm_cache_mark: Optional[int] = None
        self._beams = None   # runtime.beam.BeamEngine of run_beams

    # ------------------------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _lora_ids(self, reqs: Sequence[Optional[Request]]
                  ) -> Optional[torch.Tensor]:
        """The lanes' adapter ids (0 for an empty lane) as a device tensor,
        or None when no adapters are attached."""
        if not self.has_lora:
            return None
        return self._t(np.asarray([r.lora_id if r is not None else 0
                                   for r in reqs], np.int32))

    def _apply_procs(self, logits: torch.Tensor, history: torch.Tensor,
                     masks: torch.Tensor) -> torch.Tensor:
        """Each registered processor on the lanes of its mask row."""
        for pi, f in enumerate(self._proc_fns):
            logits = torch.where(masks[pi][:, None], f(logits, history),
                                 logits)
        return logits

    def _sample(self, logits: torch.Tensor, reqs, configs, sup_tok,
                sup_flag):
        """Sample one token per lane after the lanes' processors and bad
        words; returns (tokens, logprobs) tensors."""
        samp = batch_params(configs, device=self.device)
        hist = self._t(self._history(reqs))
        masks = self._proc_masks(reqs)
        if masks is not None:
            logits = self._apply_procs(logits, hist, self._t(masks))
        bw = self._bad_words(reqs)
        tok = sample_batched(logits, self.generator, samp, history=hist,
                             suppress_token=self._t(sup_tok),
                             suppress_flag=self._t(sup_flag),
                             bad_words=None if bw is None
                             else self._t(bw).long())
        lp = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                          tok[:, None])[:, 0]
        return tok, lp

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None,
               sampling: Optional[SamplingConfig] = None,
               min_new_tokens: int = 0, lora_id: int = 0,
               bad_words: Optional[Sequence[Sequence[int]]] = None,
               logits_processor: Optional[str] = None,
               stop_sequences: Optional[Sequence[Sequence[int]]] = None,
               priority: float = 0.5, on_token=None) -> int:
        """Queue a request; returns its id. ``sampling`` overrides the
        executor default for this request; stop_sequences are token-id
        suffixes that end it (kept in the output); bad_words are token-id
        sequences it may never emit; logits_processor names a processor
        registered at construction, applied to its lane only;
        on_token(request, token) is called for every generated token;
        lora_id selects a runtime adapter attached with
        convert.lora.attach_lora (0 = the base model).
        Raises QueueFullError when max_queue_size requests are queued."""
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"> max_seq_len ({self.max_seq_len})")
        if self.max_queue_size and len(self.queue) >= self.max_queue_size:
            raise QueueFullError(
                f"queue full ({self.max_queue_size}); retry later")
        # the id is taken before the checks below, as in the JAX package
        rid = self._next_id
        self._next_id += 1
        if lora_id and not self.has_lora:
            raise ValueError("lora_id set but no adapters attached "
                             "(convert.lora.attach_lora)")
        if logits_processor is not None and \
                logits_processor not in self._proc_names:
            raise ValueError(f"unknown logits_processor {logits_processor!r};"
                             f" registered: {list(self._proc_names)}")
        if bad_words:
            longest = max(len(w) for w in bad_words)
            if longest - 1 > HISTORY_W:
                raise ValueError(f"bad word of {longest} tokens exceeds the "
                                 f"{HISTORY_W}-token match window")
        self.queue.append(Request(
            rid, list(prompt), max_new_tokens, eos_token_id,
            sampling=sampling, lora_id=lora_id,
            min_new_tokens=min_new_tokens, priority=priority,
            bad_words=[list(w) for w in bad_words] if bad_words else None,
            logits_processor=logits_processor,
            stop_sequences=[list(w) for w in stop_sequences]
            if stop_sequences else None,
            on_token=on_token))
        return rid

    def cancel(self, req_id: int) -> bool:
        """Cancel a queued or in-flight request; it is finished with the
        tokens it has and its blocks go back to the pool. Returns whether
        anything was cancelled (finished requests cannot be)."""
        for req in self.queue:
            if req.req_id == req_id:
                self.queue.remove(req)
                self._close(req)
                return True
        for req in self.prefilling:
            if req.req_id == req_id:
                self.prefilling.remove(req)
                self.bm.free_sequence(req_id)
                self._close(req)
                return True
        for req in self.slots:
            if req is not None and req.req_id == req_id:
                self._finish(req)
                return True
        return False

    def _close(self, req: Request) -> None:
        req.done = True
        req.finish_time = time.perf_counter()
        self.finished[req.req_id] = req

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Every request's state as JSON-serializable data, for restarting
        a crashed server (the JAX Executor's format, key for key). The
        device KV is not saved: restore() replays each pending request's
        committed tokens through prefill. on_token callbacks are
        dropped."""
        def ser(r: Request) -> dict:
            # a restored or preempted request carries its original shape
            # in ``resume``: serialize that, so snapshots of snapshots
            # stay stable
            if r.resume is not None:
                plen, old_gen, old_lp, omax, omin = r.resume
            else:
                plen, old_gen, old_lp, omax, omin = (
                    len(r.prompt), [], [], r.max_new_tokens,
                    r.min_new_tokens)
            return {
                "req_id": r.req_id, "prompt": list(r.prompt[:plen]),
                "generated": list(old_gen) + list(r.generated),
                "logprobs": list(old_lp) + list(r.logprobs),
                "max_new_tokens": omax, "min_new_tokens": omin,
                "eos_token_id": r.eos_token_id,
                "sampling": dataclasses.asdict(r.sampling)
                if r.sampling is not None else None,
                "lora_id": r.lora_id, "priority": r.priority,
                "bad_words": r.bad_words,
                "logits_processor": r.logits_processor,
                "stop_sequences": r.stop_sequences,
                "done": r.done,
            }
        pending = ([ser(r) for r in self.queue]
                   + [ser(r) for r in self.prefilling]
                   + [ser(r) for r in self.slots if r is not None])
        return {"pending": pending,
                "finished": [ser(r) for r in self.finished.values()],
                "next_id": self._next_id}

    def restore(self, snap: dict) -> None:
        """Take a snapshot's work onto this fresh Executor (the same model
        and processors): finished results reappear in ``finished``; each
        pending request's committed tokens join its prompt and replay
        through prefill, so greedy requests finish as the uninterrupted
        run would (stochastic ones draw anew)."""
        if self.has_work or self.finished:
            raise RuntimeError("restore() needs a fresh executor")

        def req(d, gen):
            n = len(gen)
            return Request(
                d["req_id"], list(d["prompt"]) + gen,
                d["max_new_tokens"] - n, d["eos_token_id"],
                SamplingConfig(**d["sampling"]) if d["sampling"] else None,
                d["lora_id"], max(0, d["min_new_tokens"] - n),
                d["priority"], d["bad_words"], d["logits_processor"],
                d["stop_sequences"])

        for d in snap["finished"]:
            r = req(d, [])
            r.generated = list(d["generated"])
            r.logprobs = list(d["logprobs"])
            r.done = True
            self.finished[r.req_id] = r
        for d in snap["pending"]:
            gen = list(d["generated"])
            if len(d["prompt"]) + d["max_new_tokens"] > self.max_seq_len:
                raise ValueError(
                    f"snapshot request {d['req_id']} needs "
                    f"{len(d['prompt']) + d['max_new_tokens']} tokens > "
                    f"max_seq_len {self.max_seq_len}")
            r = req(d, gen)
            if gen:
                r.resume = (len(d["prompt"]), gen, list(d["logprobs"]),
                            d["max_new_tokens"], d["min_new_tokens"])
            self.queue.append(r)
        self._next_id = max(snap["next_id"], self._next_id)

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
        being skipped. With block reuse a request adopts the cached blocks
        its prompt starts with and its prefill starts after them."""
        while (self.queue and self._free_slots() > 0
               and len(self.prefilling) < self.prefill_lanes):
            req = max(self.queue, key=lambda r: (r.priority, -r.req_id))
            if not self.bm.can_allocate(len(req.prompt) + 1):
                break
            self.queue.remove(req)
            if self.block_reuse:
                _, cached = self.bm.add_sequence_cached(req.req_id,
                                                        req.prompt)
                req.prefill_pos = cached
                self.reused_blocks += cached // self.block_size
            else:
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

    def _bad_words(self, reqs: Sequence[Optional[Request]]
                   ) -> Optional[np.ndarray]:
        """(len(reqs), N, L) int32 packed per-lane bad words (right-aligned,
        BW_PAD padded), or None when no lane has any. N and L (the longest
        word, at least 2) round up to powers of two, L at most the match
        window, so the buckets, and the decode rungs each one makes, stay
        few. A left pad matches any history token, so padding a word
        changes nothing it bans."""
        words = [r.bad_words for r in reqs if r is not None and r.bad_words]
        if not words:
            return None
        n = pow2_ceil(max(len(w) for w in words))
        lmax = min(pow2_ceil(max(2, max(len(t) for w in words for t in w))),
                   HISTORY_W + 1)
        out = np.full((len(reqs), n, lmax), BW_PAD, np.int32)
        for i, r in enumerate(reqs):
            if r is None or not r.bad_words:
                continue
            for j, t in enumerate(r.bad_words):
                out[i, j, lmax - len(t):] = t
        return out

    def _proc_masks(self, reqs: Sequence[Optional[Request]]
                    ) -> Optional[np.ndarray]:
        """(processors, len(reqs)) bool lane masks, or None when no
        processor is registered."""
        if not self._proc_names:
            return None
        out = np.zeros((len(self._proc_names), len(reqs)), bool)
        for i, r in enumerate(reqs):
            if r is not None and r.logits_processor is not None:
                out[self._proc_names.index(r.logits_processor), i] = True
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
        res = mcommon.forward_paged(
            self.params, self.cfg, self._t(tokens), pos, self.state,
            self._t(table), length_t, block_pos=self._t(bpos),
            window=self._win_tokens, sink=self._sink_tokens,
            last_pos=torch.clamp(length_t - start_t - 1, 0, chunk - 1),
            outlier_state=self.ostate, lora_ids=self._lora_ids(lane_rows))
        logits, self.state = res[:2]
        if self.ostate is not None:
            self.ostate = res[2]
        self.prefill_tokens += int((length - start)[:len(lanes)].sum())
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
            if self.block_reuse:
                # the chunk's KV is written: its full prompt blocks are
                # now adoptable
                self.bm.register_prefix(req.req_id, req.prompt,
                                        upto=req.prefill_pos)
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
        if req.on_token is not None:
            req.on_token(req, tok)
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
            # preempted or restored request: re-split the replayed prompt
            # and stitch the earlier output back so callers see ONE
            # generation
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
        block). Cached blocks that only the prefix cache holds count as
        free: ``bm.extend`` evicts them on demand. (The JAX package counts
        the free list alone, so a reuse pool full of cached blocks
        preempts, or raises for a lone request, where one eviction would
        do.) Windowed managers recycle in place and never run dry."""
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
            avail = self.bm.num_free + self.bm._evictable()
            if need <= avail:
                return
            if len(lanes) == 1:
                raise RuntimeError(
                    "KV pool exhausted: the single active request cannot "
                    f"extend by {k} tokens ({avail} free or evictable "
                    "blocks); size the pool larger (max_kv_tokens)")
            self._preempt(self._pick_victim())

    def _decode_body(self, k: int, bw_key: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
        """k decode steps from the static inputs (``_DecodeInputs.dev``
        and, with a bad-words bucket ``bw_key``, that bucket's buffer),
        which it only reads: the tokens, lengths, history and min_new
        countdown are carried as new tensors, as the JAX burst's scan
        carries them. Returns (B, 2k) int32: the tokens, then the
        log-probabilities bit-cast."""
        d = self._dec.dev
        samp = self._dec.sampling()
        masks = d["proc_masks"] != 0 if self._proc_names else None
        bw = (self._bw_inputs[bw_key].dev["bw"].long()
              if bw_key is not None else None)
        tok, lens, hist, min_left = (d["tokens"], d["lens"], d["history"],
                                     d["min_left"])
        lora = d.get("lora")
        toks, lps = [], []
        for j in range(k):
            with moe.static_shapes():       # a graph body on the card
                logits, _ = mcommon.forward_paged(
                    self.params, self.cfg, tok, lens[:, None], self.state,
                    d["table"], torch.clamp(lens + 1, min=1),
                    block_pos=d["bpos"], window=self._win_tokens,
                    sink=self._sink_tokens, lora_ids=lora)
            last = logits[:, 0]
            if masks is not None:
                last = self._apply_procs(last, hist, masks)
            t = sample_batched(last, self.generator, samp, history=hist,
                               suppress_token=d["sup_tok"],
                               suppress_flag=(min_left > 0).int(),
                               bad_words=bw)
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

    def _rung(self, k: int, bw_key: Optional[Tuple[int, int]] = None
              ) -> _Rung:
        """The k-step decode rung of bad-words bucket ``bw_key`` under the
        MIXQ_KV_SPLITS value in force, made at first use (a program made:
        compile_watch)."""
        key = (k, mcommon._kv_splits(), bw_key)
        rung = self._rungs.get(key)
        if rung is None:
            rung = self._capture(k, bw_key) if self.device.type == "cuda" \
                else _Rung(k)
            compile_watch.note_program()
            self._rungs[key] = rung
        return rung

    def _capture(self, k: int, bw_key: Optional[Tuple[int, int]]) -> _Rung:
        """The k-step body captured into the shared graph pool, with the
        Executor's generator registered so that each replay draws anew."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph, out, launches = capture_graph(
            lambda: self._decode_body(k, bw_key), self.device,
            self._graph_pool, f"decode rung k={k}, bad words {bw_key}",
            generator=self.generator)
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
        if self._proc_names:
            h["proc_masks"][:] = self._proc_masks(self.slots)
        if self.has_lora:
            h["lora"][:] = [r.lora_id if r is not None else 0
                            for r in self.slots]
        self._dec.upload()
        bw = self._bad_words(self.slots)
        bw_key = None if bw is None else (bw.shape[1], bw.shape[2])
        if bw_key is not None:
            inp = self._bw_inputs.get(bw_key)
            if inp is None:
                inp = self._bw_inputs[bw_key] = StaticInputs(
                    {"bw": (b,) + bw_key}, self.device)
            inp.host["bw"][:] = bw
            inp.upload()
        rung = self._rung(k, bw_key)
        if rung.graph is None:
            out = self._decode_body(k, bw_key)
        else:
            rung.graph.replay()
            _build.add_launches(rung.launches)
            self.graph_replays += 1
            out = rung.out
        self.decode_calls += 1
        self.decode_steps += k
        (a,) = self._readback(out)
        return a[:, :k], a[:, k:].view(np.float32)

    def _record_stats(self, t0: float, produced: int) -> None:
        self._iter_id += 1
        self.iteration_stats.append(IterationStats(
            iter_id=self._iter_id, timestamp=time.time(),
            step_time_s=time.perf_counter() - t0,
            num_active=self.num_active, num_queued=len(self.queue),
            num_prefilling=len(self.prefilling),
            tokens_produced=produced,
            kv_free_blocks=self.bm.num_free,
            kv_total_blocks=self.bm.num_blocks,
            kv_trash_blocks=self.bm.num_trash))

    def get_latest_iteration_stats(self, n: int = 1) -> List[IterationStats]:
        """The last n IterationStats (one per step, step_burst or
        step_serving call)."""
        return list(self.iteration_stats)[-n:]

    def get_kv_cache_stats(self) -> dict:
        """Pool accounting: the blocks a sequence can hold (the trash
        block left out), free, used and held by the prefix cache, and
        tokens a block."""
        total = self.bm.num_blocks - self.bm.num_trash
        free = self.bm.num_free
        cached = self.bm.prefix_cache_size if self.block_reuse else 0
        return {"max_num_blocks": total,
                "free_num_blocks": free,
                "used_num_blocks": total - free - cached,
                "cached_num_blocks": cached,
                "tokens_per_block": self.block_size}

    def step(self) -> int:
        """Admit + one prefill chunk + one batched decode step (rung 1).
        Returns tokens produced (decode lanes + completed prefills)."""
        t0 = time.perf_counter()
        produced = self._step()
        self._record_stats(t0, produced)
        return produced

    def _step(self) -> int:
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
        t0 = time.perf_counter()
        produced = self._step_burst(k)
        self._record_stats(t0, produced)
        return produced

    def _step_burst(self, k: int) -> int:
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

    def _draft_prefill(self, dp, dcfg: ModelConfig, dstate,
                       tokens, lens, table, bpos):
        """Write the draft's KV of every lane's committed tokens but the
        newest (positions 0..len-1); the head runs on one position only,
        its logits unused. A paged draft state goes through forward_paged
        and the lanes' tables; a dense ``KVCache`` through ``full_prefill``
        (K14 on the card for MHA), as the JAX package's dense draft."""
        b, s = tokens.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device)[None].expand(b, s)
        first = torch.zeros((b,), dtype=torch.int32, device=self.device)
        if isinstance(dstate, mcommon.KVCache):
            _, dstate = mcommon.forward(dp, dcfg, tokens, pos, dstate, lens,
                                        full_prefill=True, last_pos=first)
            return dstate
        _, dstate = mcommon.forward_paged(
            dp, dcfg, tokens, pos, dstate, table, lens, block_pos=bpos,
            last_pos=first)
        return dstate

    def _draft_propose(self, dp, dcfg: ModelConfig, dstate,
                       tok, pos, table, bpos, gamma: int):
        """gamma greedy draft steps from the newest token ``tok`` (B,) at
        ``pos`` (B,) over the paged draft pool or the dense draft cache;
        returns (proposals (B, gamma) int32, draft state)."""
        props = []
        for _ in range(gamma):
            if isinstance(dstate, mcommon.KVCache):
                logits, dstate = mcommon.forward(
                    dp, dcfg, tok[:, None], pos[:, None], dstate, pos + 1)
            else:
                logits, dstate = mcommon.forward_paged(
                    dp, dcfg, tok[:, None], pos[:, None], dstate, table,
                    pos + 1, block_pos=bpos, window=self._win_tokens,
                    sink=self._sink_tokens)
            tok = torch.argmax(logits[:, 0], dim=-1).int()
            props.append(tok)
            pos = pos + 1
        return torch.stack(props, dim=1), dstate

    def _verify(self, rows, start, length, table, bpos, lora):
        """The target forward over [newest token | gamma drafts] (B, g1) at
        start..start+gamma with the lanes' adapters ``lora``: (greedy
        predictions (B, g1) int32, their log-probabilities (B, g1) f32)."""
        g1 = rows.shape[1]
        pos = start[:, None] + torch.arange(g1, dtype=torch.int32,
                                            device=self.device)[None]
        logits, self.state = mcommon.forward_paged(
            self.params, self.cfg, rows, pos, self.state, table, length,
            block_pos=bpos, window=self._win_tokens, sink=self._sink_tokens,
            lora_ids=lora)
        preds = torch.argmax(logits, dim=-1)
        lp = torch.gather(torch.log_softmax(logits, dim=-1), 2,
                          preds[..., None])[..., 0]
        return preds.int(), lp

    def _spec_device_rounds(self, dp, dcfg: ModelConfig, dstate,
                            gamma: int, rounds: int, table, bpos, tok, pos,
                            remaining, done, eos, lora):
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
            preds, lp = self._verify(rows, pos, pos + g1, table, bpos, lora)
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

    def _spec_call(self, dp, dcfg: ModelConfig, dstate, gamma: int,
                   rounds: int):
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
            self._t(eos), self._lora_ids(self.slots))
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
        a draft model proposes gamma greedy tokens per lane, one
        (gamma+1)-row target forward verifies them, and each lane commits
        the agreeing prefix plus the target's next token. Greedy requests
        only: the outputs equal run()'s. Queued requests are admitted and
        prefilled through step() first; lanes that finish mid-flight run on
        as masked lanes until the batch drains. The verify serves each
        lane's LoRA adapter; the draft runs without adapters.

        paged_draft=True gives the draft its own paged KV pool (the same
        block tables: one allocator, two pools, the draft config's KV
        quantization); False a dense KVCache of max(max_seq_len, prefill
        bucket) slots a lane, prefilled with full_prefill (JAX
        runtime/scheduler.py:570-595).

        rounds_per_call > 1 runs that many rounds per call with the
        bookkeeping on the device and one host readback at the end; a lane
        within gamma tokens of the context cap finishes with plain step()s.
        Counters: ``spec_rounds`` (as the JAX Executor's), ``spec_accepted``
        / ``spec_proposed`` (draft tokens), ``spec_calls`` /
        ``spec_readbacks`` (host syncs)."""
        if self.ostate is not None:
            raise ValueError("speculative decoding with dynamic outliers "
                             "is unsupported (as in the JAX Executor)")
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
                assert not r.bad_words and r.logits_processor is None \
                    and r.min_new_tokens == 0, \
                    "per-request logits controls (bad_words/processors/" \
                    "min_new_tokens) unsupported in spec mode"

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
        if paged_draft:
            dstate = init_paged_kv(draft_cfg, self.bm.num_blocks,
                                   self.block_size, device=self.device)
        else:
            # the bucket may pass max_seq_len: its padding slots are
            # written and never read (JAX drops writes past its cache)
            dstate = mcommon.init_kv_cache(
                draft_cfg, self.max_batch, max(self.max_seq_len, bucket),
                device=self.device)
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
        # warmup's own requests must not meet the client backpressure
        mqs, self.max_queue_size = self.max_queue_size, 0
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
                                 if (k, splits, None) not in self._rungs)
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
            self.max_queue_size = mqs
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
        eos_token_id. min_new_tokens, bad_words, stop_sequences and named
        logits processors apply inside the beam step, per request."""
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
        procs = tuple(zip(self._proc_names, self._proc_fns))
        while self.queue:
            batch = [self.queue.popleft()
                     for _ in range(min(self.max_batch, len(self.queue)))]
            pm = None
            if procs and any(r.logits_processor for r in batch):
                pm = np.zeros((len(batch), len(procs)), bool)
                for i, r in enumerate(batch):
                    if r.logits_processor is not None:
                        pm[i, self._proc_names.index(
                            r.logits_processor)] = True
            res = paged_beam_search(
                self.params, self.cfg, [r.prompt for r in batch], n,
                num_beams=num_beams, length_penalty=length_penalty,
                eos_token_id=eos, max_seq_len=self.max_seq_len,
                block_size=self.block_size, burst=burst,
                min_new_tokens=[r.min_new_tokens for r in batch],
                bad_words=[r.bad_words for r in batch],
                stop_sequences=[r.stop_sequences for r in batch],
                logits_processors=procs if pm is not None else (),
                proc_masks=pm, lora_ids=[r.lora_id for r in batch],
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
        advance); records one IterationStats."""
        t0 = time.perf_counter()
        produced = self._step_serving(burst, mixed_burst)
        self._record_stats(t0, produced)
        return produced

    def _step_serving(self, burst: int, mixed_burst: int) -> int:
        if burst > 1 and self.num_active > 0:
            if not self.queue and not self.prefilling:
                k = self._burst_k(burst)
                produced = self._step_burst(k) if k > 1 else 0
                if produced:
                    return produced
            elif mixed_burst > 1:
                self._admit()
                self._step_prefill()
                # floor to a pow2: a non-pow2 mixed_burst would make its
                # own (unwarmed) rung
                k = min(self._burst_k(burst), pow2_floor(mixed_burst))
                produced = self._step_burst(k) if k > 1 else 0
                if produced:
                    return produced
        return self._step()
