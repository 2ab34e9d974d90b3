"""Paged KV cache: the flat block pool, the host-side block manager, and
the paged write/gather. Counterpart of runtime/kv_cache.py.

The pool is FLAT over layers: (L * num_blocks, Hkv, block_size, D) with
(L * num_blocks, Hkv, block_size) f32 scales for int8 or e4m3 KV; layer
l's block b is page row l * num_blocks + b. Sequences address it through int32 block
tables; each table entry also carries an absolute base position
(``block_pos``), so attention masks stay right when a sliding window
recycles a page in place (its stale tail slots land in the causal future).

The block manager is host-side Python, the same logic as the JAX
package's (block 0 is the reserved trash block), with its prefix cache
(``enable_block_reuse``): full prompt blocks are registered under chain
keys that commit to the whole prefix, and a later request adopts the
cached blocks its prompt starts with.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.common import ModelConfig, kv_dtype
from ..ops import _build
from ..ops import paged_attention as pattn
from ..ops import paged_write as pwrite
from ..ops import ref as ops_ref
from ..quant import core as qcore

# base position of a padded block_pos entry: beyond any real position, so
# kernels and masks treat the slot as causally unreachable
PAD_POS = np.int32(pattn.PAD_POS)


class PagedKVState(NamedTuple):
    """Device-side pool, flat over layers; the int8 and e4m3 modes carry
    scales."""

    k: torch.Tensor                        # (L*NB, Hkv, BS, D)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (L*NB, Hkv, BS) f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[0]

    def pools(self) -> Dict[str, torch.Tensor]:
        """The pool tensors as the dict the paged ops update in place."""
        out = {"k": self.k, "v": self.v}
        if self.quantized:
            out.update(k_scale=self.k_scale, v_scale=self.v_scale)
        return out


def init_paged_kv(cfg: ModelConfig, num_blocks: int, block_size: int = 64,
                  device: DeviceLike = "cuda") -> PagedKVState:
    dev = resolve_device(device)
    shape = (cfg.num_layers * num_blocks, cfg.num_kv_heads, block_size,
             cfg.head_dim)
    qdt = kv_dtype(cfg)
    if qdt is not None:
        sshape = shape[:-1]
        return PagedKVState(
            k=torch.zeros(shape, dtype=qdt, device=dev),
            v=torch.zeros(shape, dtype=qdt, device=dev),
            k_scale=torch.ones(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.ones(sshape, dtype=torch.float32, device=dev))
    return PagedKVState(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                        v=torch.zeros(shape, dtype=cfg.dtype, device=dev))


@dataclasses.dataclass
class SequenceBlocks:
    seq_id: int
    blocks: List[int]
    bases: List[int]       # absolute base position of each block
    length: int = 0        # tokens currently stored


class BlockManager:
    """Host-side free list + per-sequence block accounting, with ref counts
    (prefix sharing, beam forks), the prefix cache, StreamingLLM
    sink/window recycling and rewind. Block 0 is reserved as the trash
    block for masked writes (``num_trash``)."""

    num_trash = 1   # blocks of the pool no sequence can hold

    def __init__(self, num_blocks: int, block_size: int,
                 sink_blocks: int = 0, window_blocks: Optional[int] = None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free: List[int] = list(range(1, num_blocks))
        self.ref_counts = np.zeros((num_blocks,), np.int32)
        self.seqs: Dict[int, SequenceBlocks] = {}
        self.sink_blocks = sink_blocks
        self.window_blocks = window_blocks   # max non-sink blocks per seq
        # chain key -> block. A registered block holds one ref count owned
        # by the cache; insertion order is the eviction order (a dict, so
        # eviction matches the JAX package's)
        self.prefix_cache: Dict[tuple, int] = {}
        self._prefix_of_block: Dict[int, tuple] = {}

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def _evictable(self) -> int:
        """Cached blocks that only the cache holds (ref count 1): the ones
        eviction can return to the free list."""
        return sum(1 for b in self._prefix_of_block
                   if self.ref_counts[b] == 1)

    def can_allocate(self, num_tokens: int) -> bool:
        return (len(self.free) + self._evictable()
                >= self.blocks_needed(num_tokens))

    def _take_free(self) -> int:
        """Pop a free block, evicting the oldest cached prefix block when
        the free list is empty."""
        if not self.free:
            self._reclaim(1)
        if not self.free:
            raise RuntimeError("KV pool exhausted")
        return self.free.pop()

    def _reclaim(self, n: int) -> None:
        """Evict up to n blocks that only the cache holds, oldest first;
        a cached block a live sequence shares stays (evicting it would
        free nothing)."""
        for key in list(self.prefix_cache):
            if n <= 0:
                break
            b = self.prefix_cache[key]
            if self.ref_counts[b] != 1:
                continue
            del self.prefix_cache[key]
            self._prefix_of_block.pop(b, None)
            self.ref_counts[b] = 0
            self.free.append(b)
            n -= 1

    @property
    def prefix_cache_size(self) -> int:
        return len(self.prefix_cache)

    def _keys_for(self, tokens: List[int]) -> List[tuple]:
        """The chain key of each FULL block of ``tokens``: block i's key
        commits to the whole prefix, so equal keys mean equal KV."""
        keys, prev = [], ()
        bs = self.block_size
        for i in range(len(tokens) // bs):
            prev = (prev, tuple(tokens[i * bs:(i + 1) * bs]))
            keys.append(prev)
        return keys

    def add_sequence_cached(self, seq_id: int, tokens: List[int]
                            ) -> Tuple[SequenceBlocks, int]:
        """add_sequence that adopts the cached blocks ``tokens`` starts
        with; returns (blocks, cached token count). Adopted blocks are
        shared read-only: writes land past them. At least one token stays
        uncached, so the prefill yields the last position's logits."""
        if seq_id in self.seqs:
            raise ValueError(f"sequence {seq_id} already active")
        adopted: List[int] = []
        for key in self._keys_for(tokens[:len(tokens) - 1]):
            b = self.prefix_cache.get(key)
            if b is None:
                break
            adopted.append(b)
        need = self.blocks_needed(max(len(tokens), 1)) - len(adopted)
        if len(self.free) + self._evictable() < need:
            raise RuntimeError("KV pool exhausted")
        for b in adopted:
            self.ref_counts[b] += 1
        blocks = adopted + [self._take_free() for _ in range(need)]
        for b in blocks[len(adopted):]:
            self.ref_counts[b] += 1
        sb = SequenceBlocks(seq_id, blocks,
                            [i * self.block_size for i in range(len(blocks))],
                            len(tokens))
        self.seqs[seq_id] = sb
        return sb, len(adopted) * self.block_size

    def register_prefix(self, seq_id: int, tokens: List[int],
                        upto: int) -> None:
        """Cache the sequence's full blocks covering tokens[:upto]; call
        once their KV is written."""
        sb = self.seqs[seq_id]
        for i, key in enumerate(self._keys_for(list(tokens)[:upto])):
            b = sb.blocks[i]
            if key in self.prefix_cache or b in self._prefix_of_block:
                continue
            self.prefix_cache[key] = b
            self._prefix_of_block[b] = key
            self.ref_counts[b] += 1

    def add_sequence(self, seq_id: int, num_tokens: int) -> SequenceBlocks:
        if seq_id in self.seqs:
            raise ValueError(f"sequence {seq_id} already active")
        n = self.blocks_needed(max(num_tokens, 1))
        if not self.can_allocate(max(num_tokens, 1)):
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, have {len(self.free)}")
        blocks = [self._take_free() for _ in range(n)]
        for b in blocks:
            self.ref_counts[b] += 1
        sb = SequenceBlocks(seq_id, blocks,
                            [i * self.block_size for i in range(n)],
                            num_tokens)
        self.seqs[seq_id] = sb
        return sb

    def extend(self, seq_id: int, new_tokens: int = 1) -> SequenceBlocks:
        """Grow a sequence; allocates (or recycles, when windowed) blocks."""
        sb = self.seqs[seq_id]
        target = sb.length + new_tokens
        while sb.bases[-1] + self.block_size < target:
            next_base = sb.bases[-1] + self.block_size
            if self.window_blocks is not None and \
                    len(sb.blocks) >= self.sink_blocks + self.window_blocks:
                # recycle the oldest non-sink block in place; it moves to
                # the tail with a fresh base position
                blk = sb.blocks.pop(self.sink_blocks)
                sb.bases.pop(self.sink_blocks)
                sb.blocks.append(blk)
                sb.bases.append(next_base)
                continue
            blk = self._take_free()
            self.ref_counts[blk] += 1
            sb.blocks.append(blk)
            sb.bases.append(next_base)
        sb.length = target
        return sb

    def rewind(self, seq_id: int, new_length: int) -> SequenceBlocks:
        """Shrink a sequence to new_length tokens, freeing tail blocks that
        lie entirely beyond it. Not with windows (pages recycle)."""
        if self.window_blocks is not None:
            raise ValueError("rewind is unsupported with windows")
        sb = self.seqs[seq_id]
        if not 1 <= new_length <= sb.length:
            raise ValueError(f"rewind to {new_length} of {sb.length}")
        while len(sb.blocks) > 1 and sb.bases[-1] >= new_length:
            b = sb.blocks.pop()
            sb.bases.pop()
            self.ref_counts[b] -= 1
            if self.ref_counts[b] == 0:
                self.free.append(b)
        sb.length = new_length
        return sb

    def free_sequence(self, seq_id: int) -> None:
        sb = self.seqs.pop(seq_id)
        for b in sb.blocks:
            self.ref_counts[b] -= 1
            if self.ref_counts[b] == 0:
                self.free.append(b)

    def fork(self, src_seq_id: int, dst_seq_id: int) -> SequenceBlocks:
        """Share all of a sequence's blocks with a new one (a beam fork);
        the caller makes a shared block exclusive (``ensure_exclusive``)
        before writing into it."""
        src = self.seqs[src_seq_id]
        for b in src.blocks:
            self.ref_counts[b] += 1
        sb = SequenceBlocks(dst_seq_id, list(src.blocks), list(src.bases),
                            src.length)
        self.seqs[dst_seq_id] = sb
        return sb

    def ensure_exclusive(self, seq_id: int, pos: int
                         ) -> Optional[Tuple[int, int]]:
        """Copy-on-write: make the block covering absolute position ``pos``
        owned by ``seq_id`` alone. Returns (source block, fresh block)
        when the page's contents must be copied on the device, else
        None."""
        sb = self.seqs[seq_id]
        for j in range(len(sb.blocks) - 1, -1, -1):
            if sb.bases[j] <= pos < sb.bases[j] + self.block_size:
                break
        else:
            raise ValueError(f"position {pos} not covered by seq {seq_id}")
        blk = sb.blocks[j]
        if self.ref_counts[blk] <= 1:
            return None
        if not self.free:
            raise RuntimeError("KV pool exhausted during copy-on-write")
        new = self.free.pop()
        self.ref_counts[new] += 1
        self.ref_counts[blk] -= 1
        sb.blocks[j] = new
        return (blk, new)

    def block_table(self, seq_ids: List[int], max_blocks: int) -> np.ndarray:
        """(len(seq_ids), max_blocks) int32; padding repeats the last real
        block (its block_pos entry is PAD_POS, so it is skipped)."""
        out = np.zeros((len(seq_ids), max_blocks), np.int32)
        for i, sid in enumerate(seq_ids):
            blocks = self.seqs[sid].blocks
            if len(blocks) > max_blocks:
                raise ValueError(f"{len(blocks)} blocks > {max_blocks}")
            out[i, :len(blocks)] = blocks
            if blocks:
                out[i, len(blocks):] = blocks[-1]
        return out

    def block_pos(self, seq_ids: List[int], max_blocks: int) -> np.ndarray:
        """(len(seq_ids), max_blocks) int32 base positions, PAD_POS padded."""
        out = np.full((len(seq_ids), max_blocks), PAD_POS, np.int32)
        for i, sid in enumerate(seq_ids):
            bases = self.seqs[sid].bases
            out[i, :len(bases)] = bases
        return out

    @property
    def num_free(self) -> int:
        return len(self.free)


# ---------------------------------------------------------------------------
# Device-side paged ops
# ---------------------------------------------------------------------------

def _locate(block_table: torch.Tensor, write_pos: torch.Tensor, bs: int,
            block_pos: Optional[torch.Tensor],
            valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(page row, in-page slot) per token, invalid/unfound -> page 0."""
    mb = block_table.shape[1]
    wp = write_pos.long()
    if block_pos is None:
        blk_idx = torch.clamp(wp // bs, 0, mb - 1)
        found = None
    else:
        want = (wp // bs) * bs
        eq = block_pos.long()[:, None, :] == want[:, :, None]   # (B, S, MB)
        blk_idx = torch.argmax(eq.to(torch.int8), dim=-1)
        found = eq.any(dim=-1)
    blk = torch.gather(block_table.long(), 1, blk_idx)
    if found is not None:
        blk = torch.where(found, blk, 0)
    if valid is not None:
        blk = torch.where(valid, blk, 0)
    return blk, wp % bs


def paged_write(pools: dict, block_table: torch.Tensor,
                write_pos: torch.Tensor, new_k: torch.Tensor,
                new_v: torch.Tensor, valid: Optional[torch.Tensor] = None,
                block_pos: Optional[torch.Tensor] = None,
                kv_valid_len: Optional[torch.Tensor] = None) -> dict:
    """Write new K/V (B, S, H, D) at absolute positions (B, S) into the
    pool, in place. block_table holds GLOBAL page rows (layer offset
    folded in); invalid writes go to the trash block 0; block_pos = None
    means the identity layout (entry j covers [j*BS, (j+1)*BS)). A token
    is invalid where ``valid`` (B, S) is False or its position is at or
    past ``kv_valid_len`` (B,), when given.

    On the card this is one launch (ops/paged_write.paged_write_located:
    the kernel locates each token itself): S % BS == 0 above 8 tokens ->
    K6 (the executor's page-aligned chunks, with the JAX kernel's drop
    rule); anything else -> K5, every column in the launch. Unquantized
    pools take K5p / K6p. On the CPU: paged_write_plain. An e4m3 pool
    takes the JAX package's route on every device (its write kernels
    quantize to int8 only): quantize_kv's e4m3 cast and a scatter of every
    token, the invalid ones into the trash block."""
    if pools["k"].dtype == qcore.FP8:
        blk, off = _located(pools, block_table, write_pos, valid, block_pos,
                            kv_valid_len)
        b, s, h, d = new_k.shape
        return pwrite.paged_write_token_plain(
            pools, blk.reshape(-1), off.reshape(-1), new_k.reshape(-1, h, d),
            new_v.reshape(-1, h, d))
    if new_k.is_cuda:
        return pwrite.paged_write_located(pools, block_table, write_pos,
                                          new_k, new_v, valid=valid,
                                          block_pos=block_pos,
                                          kv_valid_len=kv_valid_len)
    return paged_write_plain(pools, block_table, write_pos, new_k, new_v,
                             valid=valid, block_pos=block_pos,
                             kv_valid_len=kv_valid_len)


def _located(pools: dict, block_table, write_pos, valid, block_pos,
             kv_valid_len):
    """``_locate`` with ``kv_valid_len`` folded into ``valid``."""
    if kv_valid_len is not None:
        below = write_pos < kv_valid_len[:, None]
        valid = below if valid is None else valid & below
    return _locate(block_table, write_pos, pools["k"].shape[2], block_pos,
                   valid)


def paged_write_plain(pools: dict, block_table: torch.Tensor,
                      write_pos: torch.Tensor, new_k: torch.Tensor,
                      new_v: torch.Tensor,
                      valid: Optional[torch.Tensor] = None,
                      block_pos: Optional[torch.Tensor] = None,
                      kv_valid_len: Optional[torch.Tensor] = None) -> dict:
    """paged_write in torch ops, as the JAX package routes it: _locate,
    then the chunk's drop rule on K6's route or a scatter of every token
    (the JAX package's token kernel, its columns and its scatter agree
    outside the trash row)."""
    blk, off = _located(pools, block_table, write_pos, valid, block_pos,
                        kv_valid_len)
    b, s, h, d = new_k.shape
    if pwrite.chunk_route(s, pools["k"].shape[2]):
        return pwrite.paged_write_chunk_plain(pools, blk, off, new_k, new_v)
    return pwrite.paged_write_token_plain(
        pools, blk.reshape(-1), off.reshape(-1), new_k.reshape(-1, h, d),
        new_v.reshape(-1, h, d))


def paged_gather(pools: dict, block_table: torch.Tensor, dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize (B, MB*BS, H, D) K/V views of each lane's pages,
    dequantized to ``dtype`` for quantized pools. The route of e4m3 pools
    and ALiBi models only: each call on the card counts one
    ``paged_gather`` in ops._build.LAUNCHES (a route count, not a kernel;
    a captured graph's replay adds it too), so a run can show that the
    int8 and bf16 pools of RoPE models never take it."""
    if pools["k"].is_cuda:
        _build.count_launch("paged_gather")
    return (pattn.gather_pages(pools["k"], pools.get("k_scale"),
                               block_table, dtype),
            pattn.gather_pages(pools["v"], pools.get("v_scale"),
                               block_table, dtype))


def paged_attention(q: torch.Tensor, pools: dict, block_table: torch.Tensor,
                    q_pos: torch.Tensor, lens: torch.Tensor, scale: float,
                    block_pos: Optional[torch.Tensor] = None, window: int = 0,
                    sink: int = 0, softcap: float = 0.0, kv_splits: int = 0,
                    stats: bool = False, alibi=None):
    """Attention of q (B, S, Hq, D) at absolute positions q_pos (B, S) over
    each lane's pages below lens (B,), in q's dtype.

    int8 and bf16 pools: S == 1 -> K7 (paged_decode_attention), or K11
    (paged_decode_attention_split) when kv_splits > 1; 1 < S <= 8 -> K9
    (paged_verify_attention) from q_pos[:, 0]; longer chunks -> K8
    (paged_prefill_attention). ``stats`` (S == 1) returns (out (B, 1, Hq,
    D) f32, m, l (B, Hq, 1)) through K10, for an exact merge with keys
    held elsewhere. A CUDA tensor launches the kernel; on the CPU each
    route takes its plain version.

    e4m3 pools and ALiBi models (``alibi`` (Hq,) slopes) take the JAX
    package's route on every device, since it hands neither fp8 pages nor
    an additive bias to its paged kernels (models/common.py:502, :627):
    ``paged_gather``, then masked ops.ref.attention (or attention_stats),
    with ALiBi's slope_h * kv_pos on the logits. No K7-K11 launch."""
    if pools["k"].dtype == qcore.FP8 or alibi is not None:
        k_all, v_all = paged_gather(pools, block_table, q.dtype)
        bs = pools["k"].shape[2]
        keep = pattn.keep_mask(block_table, block_pos, bs, q_pos, lens,
                               window, sink)
        if alibi is None:
            attend = ops_ref.attention_stats if stats else ops_ref.attention
            return attend(q, k_all, v_all, mask=keep, scale=scale,
                          softcap=softcap)
        if stats:
            raise NotImplementedError("beam bursts do not support ALiBi")
        bpos = (block_pos if block_pos is not None
                else pattn.identity_block_pos(block_table, bs))
        kv_pos = (bpos.float()[:, :, None] + torch.arange(
            bs, device=q.device)).reshape(q.shape[0], 1, 1, -1)
        return ops_ref.attention(q, k_all, v_all, mask=keep, scale=scale,
                                 softcap=softcap,
                                 bias=alibi[None, :, None, None] * kv_pos)
    args = (pools["k"], pools["v"], pools.get("k_scale"),
            pools.get("v_scale"), block_table)
    kw = dict(scale=scale, block_pos=block_pos, window=window, sink=sink,
              softcap=softcap)
    s = q.shape[1]
    if stats:
        out, m, l = pattn.paged_decode_attention(q[:, 0], *args, lens,
                                                 stats=True, **kw)
        return out[:, None], m[..., None], l[..., None]
    if s == 1:
        if kv_splits > 1:
            return pattn.paged_decode_attention_split(
                q[:, 0], *args, lens, kv_splits=kv_splits, **kw)[:, None]
        return pattn.paged_decode_attention(q[:, 0], *args, lens,
                                            **kw)[:, None]
    if s <= pattn.MAX_VERIFY_ROWS:
        return pattn.paged_verify_attention(q, *args, lens, q_pos[:, 0],
                                            **kw)
    return pattn.paged_prefill_attention(q, *args, q_pos[:, 0], lens, **kw)
