"""Port parity of the Executor's serving surface: on the CPU the port's
Executor gives the JAX Executor's greedy tokens (f32 tiny Llama of
test_block_reuse.py's widths, int8_mix with int8 KV) with prefix reuse
(adopted-block counts, eviction when the pool runs dry, preemption, block
conservation after drain), per-request bad words and a named logits
processor (at ``step``, ``run(burst=4)`` and mixed bursts), ``cancel``,
``max_queue_size`` and ``on_token``; ``get_kv_cache_stats``,
``snapshot()`` and the iteration stats equal JAX's, and a snapshot of
either package restores in the other. Log-probabilities agree within
5e-4 (int8 KV, as test_torch_beam.py's scores). Also: ``run_speculative``
refusing controls and, with reuse, giving a cold run's tokens;
``run_beams`` with per-request bad words; ``compiles_since_warmup``
counting exactly the rungs a new bad-words bucket makes.

The JAX Executors are made once per configuration and reset between
cases (block manager, ids, finished requests, stats): each new JAX
Executor compiles its programs anew."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu.runtime.scheduler import \
    QueueFullError as JQueueFull
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import (Executor,
                                                           IterationStats,
                                                           QueueFullError)

LP_TOL = 5e-4
# one configuration for every JAX Executor (each compiles its programs):
# 11 usable blocks of 8 tokens, so the pool runs dry and preempts
BASE = dict(max_batch=2, max_seq_len=64, block_size=8, prefill_chunk=8,
            num_blocks=12)


def _no_repeat_jax(logits, history):
    """Bans each lane's newest token (reads the history)."""
    last = jnp.maximum(history[:, -1], 0)
    return logits.at[jnp.arange(logits.shape[0]), last].set(-1e9)


def _no_repeat_torch(logits, history):
    last = history[:, -1:].clamp(min=0).long()
    return logits.scatter(1, last, -1e9)


@pytest.fixture(scope="module")
def model():
    jcfg = JConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=128, dtype=jnp.float32,
                   quant=JQuant(algo=JAlgo.INT8_MIX, num_outliers=8,
                                kv_cache=JKV.INT8))
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 64), ("self_attn.o_proj", 64),
                     ("mlp.gate_proj", 64), ("mlp.down_proj", 128))}
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(0),
                                   act_scales=acts)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp, {}


def _jax(model, kw, reuse=False, queue=0):
    """The configuration's JAX Executor, reset to a fresh one's host
    state (its compiled programs kept)."""
    jcfg, jp, _, _, cache = model
    key = tuple(sorted(kw.items()))
    if key not in cache:
        cache[key] = JExecutor(jp, jcfg, seed=0, logits_processors={
            "no_repeat": _no_repeat_jax}, **kw)
    ex = cache[key]
    ex.queue.clear()
    ex.prefilling.clear()
    ex.slots = [None] * ex.max_batch
    ex.bm = type(ex.bm)(ex.bm.num_blocks, ex.block_size)
    ex.finished, ex._next_id, ex.preemptions = {}, 0, 0
    ex.iteration_stats.clear()
    ex._iter_id = 0
    ex.key = jax.random.PRNGKey(0)
    ex.block_reuse, ex.max_queue_size = reuse, queue
    return ex


def _port(model, kw, reuse=False, queue=0):
    return Executor(model[3], model[2], seed=0, device="cpu",
                    logits_processors={"no_repeat": _no_repeat_torch},
                    enable_block_reuse=reuse, max_queue_size=queue, **kw)


def _record_adoptions(ex):
    """Wrap the manager's add_sequence_cached to record the cached token
    count of every admission."""
    seen, inner = [], ex.bm.add_sequence_cached

    def rec(seq_id, tokens):
        out = inner(seq_id, tokens)
        seen.append(out[1])
        return out
    ex.bm.add_sequence_cached = rec
    return seen


def _same_logprobs(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=LP_TOL)


def _ragged(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, n).tolist() for n in lens]


# ---------------------------------------------------------------------------
# the block manager's prefix cache against the JAX package's Python one
# ---------------------------------------------------------------------------

def _script_adopt(bm):
    toks = list(range(11))                       # 2 full blocks + tail
    bm.add_sequence(1, len(toks))
    bm.register_prefix(1, toks, upto=11)
    sb, cached = bm.add_sequence_cached(2, toks + [42])
    out = [cached, len(bm.prefix_cache), sb.blocks,
           int(bm.ref_counts[sb.blocks[0]])]
    bm.free_sequence(1)
    bm.free_sequence(2)
    return out + [int(bm.ref_counts[sb.blocks[0]]), sorted(bm.free)]


def _script_divergent(bm):
    toks = list(range(12))
    bm.add_sequence(1, 12)
    bm.register_prefix(1, toks, upto=12)
    _, cached = bm.add_sequence_cached(2, toks[:4] + [99] + toks[5:])
    return [cached, bm.prefix_cache_size]


def _script_evict(bm):
    bm.add_sequence(1, 8)
    bm.register_prefix(1, list(range(8)), upto=8)
    bm.free_sequence(1)                          # the cache owns 2 blocks
    out = [len(bm.free), bm._evictable(), bm.can_allocate(12)]
    bm.add_sequence(2, 12)                       # needs 3: evicts one
    return out + [bm.seqs[2].blocks, bm.prefix_cache_size, sorted(bm.free)]


def _script_keep_one(bm):
    toks = list(range(8))                        # exactly 2 blocks
    bm.add_sequence(1, 8)
    bm.register_prefix(1, toks, upto=8)
    _, cached = bm.add_sequence_cached(2, toks)
    return [cached]


def _script_shared_stays(bm):
    """Eviction skips a cached block a live sequence shares, and rewind
    and fork keep the cache's ref count."""
    bm.add_sequence(1, 9)
    bm.register_prefix(1, list(range(9)), upto=9)
    bm.add_sequence(5, 8)
    bm.register_prefix(5, list(range(100, 108)), upto=8)
    bm.free_sequence(5)                 # its 2 blocks: the cache's alone
    bm.fork(1, 3)
    bm.extend(3, 8)                     # the last free block, then evicts
    bm.rewind(3, 9)
    bm.free_sequence(1)
    out = [bm._evictable(), list(bm.ref_counts), sorted(bm.free)]
    bm.add_sequence(2, 12)              # evicts the other one
    return out + [bm.seqs[2].blocks, bm.prefix_cache_size,
                  list(bm.ref_counts)]


SCRIPTS = {"adopt": (10, _script_adopt), "divergent": (10,
                                                       _script_divergent),
           "evict": (4, _script_evict), "keep_one": (10, _script_keep_one),
           "shared_stays": (7, _script_shared_stays)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_prefix_cache_matches_jax_manager(name):
    nb, script = SCRIPTS[name]
    got = script(tkv.BlockManager(nb, 4))
    want = script(jkv.BlockManager(nb, 4))
    assert json.loads(json.dumps(got, default=int)) == \
        json.loads(json.dumps(want, default=int))


def test_iteration_stats_usage_counts_the_pools_trash():
    """kv_cache_usage over the blocks a sequence can hold: 0.0 on an
    empty pool, 1.0 when every usable block is held (the trash count taken
    from the manager, not a literal)."""
    bm = tkv.BlockManager(9, 4)
    assert bm.num_trash == 1

    def stats(free):
        return IterationStats(0, 0.0, 0.0, 0, 0, 0, 0, free, bm.num_blocks,
                              bm.num_trash)
    assert stats(bm.num_free).kv_cache_usage == 0.0
    bm.add_sequence(1, 4 * (bm.num_blocks - bm.num_trash))
    assert bm.num_free == 0 and stats(bm.num_free).kv_cache_usage == 1.0
    two = IterationStats(0, 0.0, 0.0, 0, 0, 0, 0, 0, 10, 2)
    assert two.kv_cache_usage == 1.0


# ---------------------------------------------------------------------------
# prefix reuse through the Executor
# ---------------------------------------------------------------------------

P1 = list(np.arange(1, 21) % 50)                # 20 tokens = 2.5 blocks
R41, R30 = _ragged(1, [41, 30])
# waves of (prompt, max_new), run one after the other
REUSE = {
    "identical": [[(P1, 6)], [(P1, 6)]],
    "divergent_tail": [[(P1, 4)], [(P1[:16] + [7, 9, 11], 6)]],
    "shared_batch": [[(P1, 3)], [(P1[:16] + [5], 5), (P1[:8] + [6, 6], 5),
                                 (P1, 4)]],
    # the second wave's admission evicts the first prompt's oldest block
    # and its decode runs in a pool of cached blocks: the port evicts
    # where the JAX package preempts (it counts the free list alone); the
    # first prompt adopts nothing
    "evict": [[(P1, 4)], [(R41, 8), (R30, 8)], [(R41[:30], 2)], [(P1, 4)]],
    # two lanes sharing a prefix preempt each other; the preempted
    # request re-admits over its own cached prefix
    "preempt": [[(P1, 3)], [(P1 + [3], 34), (P1[:16] + [9, 9, 9], 34)]],
}
# cases where the JAX Executor preempts only because its decode counts the
# free list alone (ROADMAP queue 3, known reference faults): its schedule,
# and so its adoptions, cache and preemption count, are not the port's
JAX_EVICTION_FAULT = {"evict"}


@pytest.mark.parametrize("case", sorted(REUSE))
def test_reuse_matches_jax(model, case):
    kw, waves = BASE, REUSE[case]
    runs = []
    for ex in (_jax(model, kw, reuse=True), _port(model, kw, reuse=True)):
        adopted = _record_adoptions(ex)
        toks, lps, stats = [], [], []
        for wave in waves:
            ids = [ex.submit(p, max_new_tokens=n) for p, n in wave]
            done = ex.run()
            toks.append([done[r].generated for r in ids])
            lps += [done[r].logprobs for r in ids]
            stats.append((ex.get_kv_cache_stats(), ex.bm.prefix_cache_size))
        runs.append((toks, lps, stats, adopted, ex.preemptions, ex))
    (jt, jl, js, ja, jpre, _), (tt, tl, ts, ta, tpre, tex) = runs
    assert tt == jt
    _same_logprobs(tl, jl)
    assert sum(ta) > 0                           # something was adopted
    if case in JAX_EVICTION_FAULT:
        assert jpre > 0 and tpre == 0            # evicted, not preempted
    else:
        assert ts == js and ta == ja and tpre == jpre
    if case == "preempt":
        assert tpre > 0
    if case == "evict":
        assert ta[-1] == 0                       # the first prefix went
    # cold: the same waves without reuse give the same tokens
    cold = _port(model, kw)
    assert [[cold.run()[r].generated for r in
             [cold.submit(p, max_new_tokens=n) for p, n in wave]]
            for wave in waves] == tt
    assert tex.prefill_tokens < cold.prefill_tokens
    # drained: every block is free or held once by the cache alone
    bm = tex.bm
    held = [b for b in range(1, bm.num_blocks) if bm.ref_counts[b]]
    assert sorted(held) == sorted(bm.prefix_cache.values())
    assert all(bm.ref_counts[b] == 1 for b in held)
    assert bm.num_free + bm.prefix_cache_size == bm.num_blocks - 1


def test_lone_request_decodes_in_a_pool_of_cached_blocks(model):
    """Distinct prompts fill the pool with cached blocks; a lone request
    that then decodes across page boundaries evicts them and finishes
    with the tokens of a run without reuse (the JAX Executor raises "KV
    pool exhausted" here)."""
    fill = _ragged(21, [17] * 5)            # 2 cached blocks each
    lone = ([3, 1, 4, 1, 5, 9], 12)         # 18 tokens: crosses two pages
    runs = {}
    for name, ex in (("jax", _jax(model, BASE, reuse=True)),
                     ("port", _port(model, BASE, reuse=True))):
        for p in fill:
            ex.submit(p, max_new_tokens=1)
        ex.run()
        assert ex.bm.prefix_cache_size == 10 and ex.bm.num_free == 1
        rid = ex.submit(lone[0], max_new_tokens=lone[1])
        if name == "jax":
            with pytest.raises(RuntimeError, match="KV pool exhausted"):
                ex.run()
            continue
        runs[name] = ex.run()[rid].generated
        assert ex.preemptions == 0
        assert ex.bm.num_free + ex.bm.prefix_cache_size == \
            BASE["num_blocks"] - 1
    cold = _jax(model, BASE)
    rid = cold.submit(lone[0], max_new_tokens=lone[1])
    assert runs["port"] == cold.run()[rid].generated
    assert len(runs["port"]) == lone[1]


def test_reuse_refused_with_windows(model):
    with pytest.raises(ValueError, match="windows"):
        Executor(model[3], model[2], window_blocks=2, enable_block_reuse=True,
                 device="cpu", **BASE)


# ---------------------------------------------------------------------------
# per-request bad words, a named processor, on_token
# ---------------------------------------------------------------------------

MODES = {"step": {}, "burst4": dict(burst=4),
         "mixed4": dict(burst=4, mixed_burst=4)}


def _controls_requests(banned):
    """(prompt, max_new, request kwargs): a lane banning the free run's
    token and a two-token word, a processor lane, a lane with bad words
    and the processor, a plain lane (every word list in one (2, 2)
    bucket)."""
    p = _ragged(7, [5, 11, 3, 17])
    return [(p[0], 10, dict(bad_words=[[banned[0]], banned[1:3]])),
            (p[1], 10, dict(logits_processor="no_repeat")),
            (p[2], 9, dict(bad_words=[[banned[3]], [5, 6]],
                           logits_processor="no_repeat")),
            (p[3], 8, {})]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_controls_match_jax(model, mode):
    run_kw = MODES[mode]
    free = _port(model, BASE)
    rid = free.submit(_ragged(7, [5])[0], max_new_tokens=10)
    banned = free.run()[rid].generated[:4]
    requests = _controls_requests(banned)
    out = []
    for ex in (_jax(model, BASE), _port(model, BASE)):
        streamed = {}
        ids = [ex.submit(p, max_new_tokens=n, on_token=lambda r, t:
                         streamed.setdefault(r.req_id, []).append(t), **kw)
               for p, n, kw in requests]
        done = ex.run(**run_kw)
        reqs = [done[r] for r in ids]
        assert all(streamed[r.req_id] == r.generated for r in reqs)
        out.append(([r.generated for r in reqs], [r.logprobs for r in reqs],
                    ex.get_kv_cache_stats()))
    (jt, jl, jk), (tt, tl, tk) = out
    assert tt == jt
    _same_logprobs(tl, jl)
    assert tk == jk
    assert banned[0] not in tt[0]
    assert all([a, b] != banned[1:3] for a, b in zip(tt[0], tt[0][1:]))
    assert banned[3] not in tt[2]
    for g in (tt[1], tt[2]):                     # no token twice in a row
        assert all(a != b for a, b in zip(g, g[1:]))


def test_submit_checks(model):
    for ex, full in ((_jax(model, BASE, queue=2), JQueueFull),
                     (_port(model, BASE, queue=2), QueueFullError)):
        with pytest.raises(ValueError, match="unknown logits_processor"):
            ex.submit([1, 2], 2, logits_processor="nope")
        with pytest.raises(ValueError, match="match window"):
            ex.submit([1, 2], 2, bad_words=[list(range(66))])
        ex.submit([1, 2], max_new_tokens=2)
        ex.submit([3], max_new_tokens=2)
        with pytest.raises(full):
            ex.submit([4], max_new_tokens=2)
        assert ex._next_id == 4     # refused checks took an id, as in JAX
        ex.run()
    # runtime LoRA is ported; an id without attached adapters raises as in
    # the JAX Executor
    for ex in (_jax(model, BASE), _port(model, BASE)):
        with pytest.raises(ValueError, match="no adapters attached"):
            ex.submit([1, 2], 2, lora_id=1)


# ---------------------------------------------------------------------------
# cancel
# ---------------------------------------------------------------------------

def _cancel_script(ex):
    """Cancel one request in the queue, one mid-prefill and one
    mid-decode; the rest run to the end. Returns (generated, done flags,
    free blocks after each cancel, kv stats)."""
    p = _ragged(11, [30, 6, 4, 5])
    ids = [ex.submit(q, max_new_tokens=12) for q in p]
    frees = [ex.cancel(ids[3]), ex.bm.num_free]          # queued
    ex.step()                    # 30-token prompt mid-prefill, 6 done
    assert any(r.req_id == ids[0] for r in ex.prefilling)
    frees += [ex.cancel(ids[0]), ex.bm.num_free]
    for _ in range(3):
        ex.step()
    frees += [ex.cancel(ids[1]), ex.bm.num_free, ex.cancel(ids[1]),
              ex.cancel(99)]
    done = ex.run()
    return ([done[r].generated for r in ids], [done[r].done for r in ids],
            frees, ex.get_kv_cache_stats())


def test_cancel_matches_jax(model):
    want = _cancel_script(_jax(model, BASE))
    got = _cancel_script(_port(model, BASE))
    assert got == want
    gen, _, frees, kv = got
    assert gen[3] == [] and gen[0] == [] and 0 < len(gen[1]) < 12
    assert len(gen[2]) == 12
    assert frees[-2:] == [False, False]
    assert kv["free_num_blocks"] == kv["max_num_blocks"]


# ---------------------------------------------------------------------------
# iteration stats
# ---------------------------------------------------------------------------

STAT_FIELDS = ("num_active", "num_queued", "num_prefilling",
               "tokens_produced", "kv_free_blocks", "kv_total_blocks")


def test_iteration_stats_match_jax(model):
    out = []
    for ex in (_jax(model, BASE), _port(model, BASE)):
        for p in _ragged(13, [12, 3, 7]):
            ex.submit(p, max_new_tokens=5)
        ex.run()
        st = ex.get_latest_iteration_stats(1000)
        out.append(([tuple(getattr(s, f) for f in STAT_FIELDS) for s in st],
                    [s.iter_id for s in st], st[-1]))
    (jv, jids, jlast), (tv, tids, tlast) = out
    assert tv == jv and tids == jids
    import dataclasses
    assert {f.name for f in dataclasses.fields(jlast)} <= \
        {f.name for f in dataclasses.fields(tlast)}
    assert tlast.kv_cache_usage == 0.0 and tlast.step_time_s > 0
    assert len(_port(model, BASE).get_latest_iteration_stats()) == 0


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------

SNAP_JOBS = [dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=12),
             dict(prompt=[2, 7, 2, 8], max_new_tokens=9,
                  bad_words=[[9]]),
             dict(prompt=[6] * 20, max_new_tokens=5,
                  logits_processor="no_repeat")]


def _snap_at(ex, jobs, steps, stop=None):
    ids = [ex.submit(**j) for j in jobs]
    for _ in range(steps):
        ex.step()
    return ids, json.loads(json.dumps(ex.snapshot()))


def _strip(snap):
    """The snapshot without log-probabilities (compared within LP_TOL)."""
    out = json.loads(json.dumps(snap))
    lps = []
    for part in ("pending", "finished"):
        for d in out[part]:
            lps.append(d.pop("logprobs"))
    return out, lps


def test_snapshot_equals_jax_and_restores_across(model):
    plain = _jax(model, BASE)
    ids = [plain.submit(**j) for j in SNAP_JOBS]
    done = plain.run()
    want = [done[r].generated for r in ids]
    jids, jsnap = _snap_at(_jax(model, BASE), SNAP_JOBS, 5)
    tids, tsnap = _snap_at(_port(model, BASE), SNAP_JOBS, 5)
    (js, jl), (ts, tl) = _strip(jsnap), _strip(tsnap)
    assert ts == js and tids == jids
    _same_logprobs(tl, jl)
    assert js["pending"] and any(d["generated"] for d in js["pending"])
    for restore_into, snap in ((_port(model, BASE), jsnap),
                               (_jax(model, BASE), tsnap)):
        restore_into.restore(snap)
        done = restore_into.run()
        assert [done[r].generated for r in ids] == want
        assert [done[r].prompt for r in ids] == \
            [j["prompt"] for j in SNAP_JOBS]


def test_stop_sequence_spans_restart_both_ways(model):
    """A 2-token stop whose first token came before the snapshot fires on
    the first token after the restore, whichever package took it."""
    base = _port(model, BASE)
    rid = base.submit([3, 1, 4], max_new_tokens=10)
    gen = base.run()[rid].generated
    stop = gen[3:5]
    job = [dict(prompt=[3, 1, 4], max_new_tokens=10, stop_sequences=[stop])]
    for src, dst in (("jax", "port"), ("port", "jax")):
        src, dst = [_jax(model, BASE) if p == "jax" else _port(model, BASE)
                    for p in (src, dst)]
        src.submit(**job[0])
        while True:
            src.step()
            live = [r for r in src.slots if r is not None]
            if live and len(live[0].generated) == 4:
                break
        dst.restore(json.loads(json.dumps(src.snapshot())))
        assert dst.run()[0].generated == gen[:5]


def test_finished_and_queue_survive(model):
    ex = _port(model, BASE)
    a = ex.submit([3, 1, 4], max_new_tokens=3)
    ex.run()
    b = ex.submit([2, 7], max_new_tokens=5)
    snap = ex.snapshot()
    ex2 = _port(model, BASE)
    ex2.restore(snap)
    assert ex2.finished[a].generated == ex.finished[a].generated
    with pytest.raises(RuntimeError, match="fresh"):
        ex2.restore(snap)
    assert ex2.run()[b].generated == _fresh_tokens(model, [2, 7], 5)
    assert ex2.submit([9, 9], max_new_tokens=2) > max(a, b)


def _fresh_tokens(model, prompt, n):
    ex = _port(model, BASE)
    rid = ex.submit(prompt, max_new_tokens=n)
    return ex.run()[rid].generated


# ---------------------------------------------------------------------------
# run_speculative, run_beams, compiles_since_warmup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plen", [11, 16])
def test_speculative_with_reuse_is_a_cold_run(model, plen):
    """A cached-prefix re-run under run_speculative (a draft of the first
    layer) gives the cold plain run's tokens; rewinds keep every cached
    block; controls are refused."""
    _, _, cfg, tp, _ = model
    import dataclasses
    dp, dcfg = dict(tp, layers=tp["layers"][:1]), dataclasses.replace(
        cfg, num_layers=1)
    prompt = [(i * 7 + 3) % 100 for i in range(plen)]
    want = _fresh_tokens(model, prompt, 9)
    ex = _port(model, BASE, reuse=True)
    a = ex.submit(prompt, max_new_tokens=9)
    assert ex.run_speculative(dp, dcfg, gamma=3)[a].generated == want
    assert ex.bm.prefix_cache_size >= plen // BASE["block_size"]
    b = ex.submit(prompt, max_new_tokens=9)
    assert ex.run_speculative(dp, dcfg, gamma=3)[b].generated == want
    assert ex.reused_blocks >= (plen - 1) // BASE["block_size"]
    assert ex.bm.num_free + ex.bm.prefix_cache_size == BASE["num_blocks"] - 1
    for kw in (dict(bad_words=[[3]]), dict(logits_processor="no_repeat")):
        ex.submit(prompt, max_new_tokens=4, **kw)
        with pytest.raises(AssertionError, match="controls"):
            ex.run_speculative(dp, dcfg, gamma=3)
        ex.run()


def test_run_beams_controls(model):
    """run_beams passes each request's bad words and processor on: the
    banned request's best sequence lacks the token its free twin emits,
    the processor's never repeats a token."""
    ex = _port(model, BASE)
    p = [3, 1, 4, 1, 5]
    free = ex.submit(p, max_new_tokens=6)
    tok = ex.run_beams(num_beams=2, burst=4)[free].generated[1]
    ids = [ex.submit(p, max_new_tokens=6, bad_words=[[tok]]),
           ex.submit(p, max_new_tokens=6),
           ex.submit(p, max_new_tokens=6, logits_processor="no_repeat")]
    done = ex.run_beams(num_beams=2, burst=4)
    banned, twin, proc = [done[r].generated for r in ids]
    assert twin == ex.finished[free].generated
    assert tok not in banned and tok in twin
    assert all(a != b for a, b in zip(proc, proc[1:]))


def test_long_bad_word_pads_to_a_pow2_bucket(model):
    """A word of 5 tokens (the greedy run's own first tokens) goes into a
    bucket of L = 8; the left pad changes nothing: the tokens equal the
    JAX Executor's, and the word's last token is banned where the run
    would have emitted it."""
    prompt, n = [3, 1, 4, 1, 5], 8
    jex = _jax(model, BASE)
    rid = jex.submit(prompt, max_new_tokens=n)
    word = jex.run()[rid].generated[:5]
    got = []
    for ex in (_jax(model, BASE), _port(model, BASE)):
        rid = ex.submit(prompt, max_new_tokens=n, bad_words=[word])
        got.append(ex.run()[rid].generated)
    assert got[0] == got[1]
    assert got[1][:4] == word[:-1] and got[1][4] != word[-1]
    assert {key[2] for key in ex._rungs} == {(1, 8)}


def test_bad_words_bucket_widths(model):
    """N and L round up to powers of two; L stops at the match window."""
    ex = _port(model, BASE)
    req = ex.queue[ex.submit([1, 2], max_new_tokens=2)]
    for words, bucket in (([[5]], (1, 2)), ([[5], [6, 7, 8]], (2, 4)),
                          ([[1] * 5] * 3, (4, 8)), ([[2] * 33], (1, 64)),
                          ([[3] * 65], (1, 65))):
        req.bad_words = words
        assert ex._bad_words([req, None]).shape == (2,) + bucket


def test_bad_words_bucket_rungs_counted(model):
    """After warmup(burst=4), bad-words-free traffic makes no program; a
    request with bad words makes one rung for each k it uses in its (N,
    L) bucket, and a second request in that bucket makes none."""
    kw = dict(BASE, max_seq_len=128)
    ex = _port(model, kw)
    ex.warmup(burst=4)
    plain = set(ex._rungs)
    for p in _ragged(17, [5, 12]):
        ex.submit(p, max_new_tokens=9, logits_processor="no_repeat")
    ex.run(burst=4)
    assert ex.compiles_since_warmup == 0 and set(ex._rungs) == plain
    ex.submit([1, 2, 3], max_new_tokens=9, bad_words=[[4], [5, 6]])
    ex.run(burst=4)
    new = set(ex._rungs) - plain
    assert new and {key[2] for key in new} == {(2, 2)}
    assert ex.compiles_since_warmup == len(new)
    ex.submit([7, 8], max_new_tokens=9, bad_words=[[9], [4, 4]])
    ex.run(burst=4)
    assert ex.compiles_since_warmup == len(new)
