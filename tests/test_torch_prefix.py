"""The port's radix prefix cache, copy-on-write and host tier against the
JAX reference, on the CPU.

Host logic must match exactly: ``PrefixCache`` (with and without the
host tier wired in) and ``HostBlockStore`` make the same decisions as
the reference's on one seeded operation stream; ``partial_copy_block``
lands the same bytes in fp32, int8 and int4 pools; the three metrics
blocks are the same from the same counters.

The engine with ``prefix_cache`` on serves the same requests to the same
results as the reference engine (``COMPARED``: tokens, statuses,
dispatch shapes and counts, the prefix and tier blocks, peak blocks),
under the port's ``gather`` and ``cuda`` lowerings (the kernel's plain
version on CPU tensors): v1 with a copy-on-write and a trie eviction, v2
(``prefix_gen``) with a follow-up turn from ``loadgen`` and a mid-block
miss, and the host tier in fp32 and int8 pools with a demotion and a
promotion whose bytes round-trip exactly.  Every case ends with the pool
empty once the trie lets go.  ``python -m mpi_tensorflow_torch.serving``
serves with the cache and the tier on.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving_cases import (JAX_TINY, assert_quiescent,
                                  assert_same_result, fast_compile,
                                  jax_engine_for, np_params,
                                  port_engine_for, requests)
from mpi_tensorflow_tpu.serving import loadgen as jax_loadgen
from mpi_tensorflow_tpu.serving import paged_cache as jax_cache
from mpi_tensorflow_tpu.serving import prefix_cache as jax_prefix
from mpi_tensorflow_tpu.serving import scheduler as jax_sched
from mpi_tensorflow_tpu.utils import metrics_writer as jax_metrics
from mpi_tensorflow_torch.models import bert
from mpi_tensorflow_torch.serving import loadgen, paged_cache, prefix_cache
from mpi_tensorflow_torch.serving import scheduler as sched
from mpi_tensorflow_torch.utils import metrics_writer

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ host logic

def _trie(cache):
    def walk(node):
        return sorted((k, c.block, c.last_used, walk(c))
                      for k, c in node.children.items())
    return walk(cache._root)


@pytest.mark.parametrize("tier", [False, True])
def test_prefix_cache_decisions_identical(tier):
    """A seeded stream of admissions (match, share, fill the tail,
    insert), partial matches, releases and evictions over a 4-token
    vocabulary (prompts collide often) through a 20-block pool: both
    caches return the same values and hold the same trie, allocator and
    (with the tier) host store after every call."""
    rng = np.random.default_rng(0)
    bs = 3
    pair = []
    for alloc_mod, cache_mod, store_mod in (
            (paged_cache, prefix_cache, paged_cache),
            (jax_cache, jax_prefix, jax_cache)):
        alloc = alloc_mod.BlockAllocator(20)
        cache = cache_mod.PrefixCache(alloc, bs)
        log = []
        if tier:
            cache.tier = store_mod.HostBlockStore()
            cache.demote_fetch = lambda blk: [{"k": ("bytes of", blk)}]
            cache.promote_put = (lambda leaves, blk, log=log:
                                 log.append((leaves, blk)))
        pair.append((alloc, cache, log))
    held = []                          # references the "sequences" hold

    def both(fn):
        out = [fn(cache) for _alloc, cache, _log in pair]
        assert out[0] == out[1]
        return out[0]

    for _ in range(300):
        op = rng.integers(0, 4)
        prompt = [int(t) for t in rng.integers(0, 4, rng.integers(1, 13))]
        if op == 0:
            ids, cached = both(lambda c: c.match_and_share(prompt))
            need = paged_cache.blocks_for(len(prompt), bs) - len(ids)
            if need > 0 and pair[0][0].can_alloc(need):
                new = both(lambda c: c.allocator.alloc(need))
                ids = ids + new
                both(lambda c: c.insert(prompt, ids))
            held.extend(ids)
        elif op == 1:
            depth = int(rng.integers(0, 3))
            got = both(lambda c: c.match_partial(prompt, depth))
            if got is not None:
                held.append(got[0])
        elif op == 2 and held:
            blk = held.pop(int(rng.integers(len(held))))
            both(lambda c: c.allocator.release([blk]))
        else:
            want = int(rng.integers(1, 4))
            both(lambda c: c.evict(want))
        both(lambda c: (_trie(c), c.stats(), c.num_blocks,
                        c.allocator._free, dict(c.allocator._ref)))
        if tier:
            both(lambda c: ({k: v for k, v in c.tier.stats().items()
                             if k != "dropped"}, list(c.tier._store)))
        for _alloc, cache, _log in pair:
            cache.check()
            cache.allocator.check()
    assert pair[0][2] == pair[1][2]                 # promotions
    stats = pair[0][1].stats()
    assert stats["evicted"] > 5 and stats["inserted"] > 10
    if tier:
        assert stats["promoted"] > 0


def test_host_block_store_matches_reference():
    """put (with overwrites), pop (hits and misses) and membership, the
    counters included, against the reference's store as its engine
    builds it (unbounded: the port has no capacity bound, so the
    reference's ``dropped`` stays 0 and is not compared)."""
    rng = np.random.default_rng(1)
    port = paged_cache.HostBlockStore()
    ref = jax_cache.HostBlockStore()
    for i in range(200):
        key = ((int(rng.integers(0, 7)),),)
        if rng.random() < 0.6:
            port.put(key, [{"k": torch.full((2,), i)}])
            ref.put(key, [{"k": np.full((2,), i)}])
        else:
            got, want = port.pop(key), ref.pop(key)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got[0]["k"].numpy(),
                                              want[0]["k"])
        assert (len(port), key in port) == (len(ref), key in ref)
        assert list(port._store) == list(ref._store)
        want = ref.stats()
        assert want.pop("dropped") == 0
        assert port.stats() == want
    assert port.promotions > 0 and port.host_blocks_peak == 7


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "int4"])
def test_partial_copy_block_matches_reference(kv_dtype):
    """Random pool content, then partial copies of 0, 1, 3 and 4 rows:
    the port's in-place copy leaves the same bytes as the reference's
    functional one, codes and scales alike."""
    rng = np.random.default_rng(2)
    cfg = bert.BERT_TINY
    jcfg = JAX_TINY
    port = paged_cache.init_pools(cfg, 6, 4, torch.device("cpu"), kv_dtype,
                                  8)
    ref = jax_cache.init_pools(jcfg, 6, 4, kv_dtype, 8)
    for pl, jl in zip(port, ref):
        for key, leaf in pl.items():
            if leaf.dtype == torch.float32:
                vals = rng.normal(size=leaf.shape).astype(np.float32)
            else:
                info = np.iinfo(np.int8 if leaf.dtype == torch.int8
                                else np.uint8)
                vals = rng.integers(info.min, info.max + 1,
                                    leaf.shape).astype(info.dtype)
            leaf.copy_(torch.from_numpy(vals))
            jl[key] = jnp.asarray(vals)
    for src, dst, n in ((1, 2, 3), (3, 4, 1), (5, 1, 0), (2, 5, 4)):
        paged_cache.partial_copy_block(port, src, dst, n)
        ref = jax_cache.partial_copy_block(ref, src, dst, n)
        for pl, jl in zip(port, ref):
            assert set(pl) == set(jl)
            for key in pl:
                np.testing.assert_array_equal(pl[key].numpy(),
                                              np.asarray(jl[key]))


def test_metrics_blocks_match_reference():
    """The prefix, speculation and tier blocks from the same seeded
    counters, and in their disabled forms."""
    rng = np.random.default_rng(3)
    names = ("prefix_hit_tokens", "prefix_prompt_tokens",
             "prefix_partial_copy_tokens", "prefix_shared_blocks",
             "prefix_cow_copies", "prefix_trie_evictions",
             "prefix_hit_admissions", "prefix_gen_inserted_blocks",
             "spec_drafted", "spec_accepted", "spec_verify_forwards",
             "spec_emitted", "spec_k_sum", "spec_k_steps")
    for trial in range(20):
        counters = ({} if trial == 0 else
                    {k: int(rng.integers(0, 50)) for k in names})
        kw = dict(enabled=trial > 0, trie_blocks=trial)
        assert metrics_writer.prefix_block(counters, **kw) \
            == jax_metrics.prefix_block(counters, **kw)
        kw = dict(enabled=trial > 0, mode="ngram", draft_k=4,
                  draft_auto="on")
        assert metrics_writer.speculation_block(counters, **kw) \
            == jax_metrics.speculation_block(counters, **kw)
        kw = dict(enabled=True, mode="host", demotions=trial,
                  promotions=int(rng.integers(0, 5)), host_blocks=2,
                  host_blocks_peak=3, promote_ms_total=float(rng.random()),
                  block_size=16)
        assert metrics_writer.tier_block(**kw) == jax_metrics.tier_block(**kw)
    assert metrics_writer.tier_block() == jax_metrics.tier_block()


# ---------------------------------------------------------------- engine

RNG = np.random.default_rng(3)
SHARED = [int(t) for t in RNG.integers(0, 1024, 8)]


def _tail(n):
    return [int(t) for t in RNG.integers(0, 1024, n)]


# v1: five prompts share two full blocks; request 2 is those 8 tokens
# alone (fully cached, an exact block multiple: the copy-on-write
# trigger); the 9-block pool under two slots evicts a trie leaf
V1 = dict(serve=dict(num_blocks=10, block_size=4, max_slots=2,
                     max_seq_len=16, prefill_chunk=4, prefix_cache="on"),
          turns=[[(SHARED + _tail(3), 4), (SHARED + _tail(2), 4),
                  (SHARED, 4), (_tail(12), 4), (_tail(11), 3),
                  (SHARED + _tail(1), 3)]])
# v2: turn 1 of a loadgen trace; turn 2 is its follow-up turn (prior
# prompt + answer + suffix); turn 3 shares 6 tokens of a cached prompt,
# a miss in the middle of its second block
V2_SPEC = dict(num_requests=3, rate_rps=1000.0, prompt_max=10,
               output_max=8, vocab_size=1024, seed=4, followup_turns=1)
V2_SERVE = dict(num_blocks=64, block_size=4, max_slots=2, max_seq_len=32,
                prefill_chunk=4, prefix_cache="on", prefix_gen="on")
# the host tier: three 12-token prompts through 9 usable blocks at one
# slot demote the LRU leaf; then the deepest demoted path is re-sent
TIER_PROMPTS = [[int(t) for t in row] for row in
                np.random.default_rng(5).integers(0, 1024, (3, 12))]


def _tier_serve(kv_dtype):
    return dict(num_blocks=10, block_size=4, max_slots=1, max_seq_len=32,
                prefill_chunk=4, prefix_cache="on", kv_tier="host",
                kv_dtype=kv_dtype)


def _v2_turns(mod, lg, run_turn1):
    """Turn 1 from the loadgen trace, then its follow-up turn built from
    turn 1's answers by the same package's loadgen, then the mid-block
    miss; every arrival at 0."""
    trace = lg.build_trace(lg.WorkloadSpec(**V2_SPEC))
    first = requests(mod, zip(trace.prompts, map(int, trace.outputs)))
    out1 = run_turn1(first)
    follow = trace.followup_requests(1, trace.requests(), out1["outputs"],
                                     id_base=10)
    follow = [mod.Request(r.id, r.prompt, r.max_new_tokens)
              for r in follow]
    miss = [mod.Request(20, trace.prompts[0][:6] + [5, 6, 7], 3)]
    return out1, follow, miss


def _deepest_demoted(eng):
    return sorted(eng.tier._store, key=len, reverse=True)[0]


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX engine's results per case, computed once per module."""
    params = np_params(1)
    out = {}
    with fast_compile():
        eng = jax_engine_for(params, V1["serve"])
        out["v1"] = [eng.run(requests(jax_sched, t)) for t in V1["turns"]]
        eng = jax_engine_for(params, V2_SERVE)
        r1, follow, miss = _v2_turns(jax_sched, jax_loadgen, eng.run)
        out["v2"] = [r1, eng.run(follow), eng.run(miss)]
        out["v2_follow"] = [r.prompt for r in follow]
        for kv_dtype in ("fp32", "int8"):
            eng = jax_engine_for(params, _tier_serve(kv_dtype))
            r1 = eng.run(requests(jax_sched, [(p, 2) for p in TIER_PROMPTS]))
            key = _deepest_demoted(eng)
            out["tier_key", kv_dtype] = key
            prompt = [t for chunk in key for t in chunk]
            out["tier", kv_dtype] = [r1, eng.run(
                [jax_sched.Request(99, prompt, 4)])]
    return params, out


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_prefix_v1_matches_reference(reference_runs, kernel):
    params, runs = reference_runs
    eng = port_engine_for(params, V1["serve"], kernel)
    for turn, want in zip(V1["turns"], runs["v1"]):
        got = eng.run(requests(sched, turn))
        assert_same_result(got, want)
    p = got["prefix"]
    assert p["enabled"] and p["hit_tokens"] > 0
    assert p["cow_copies"] >= 1 and p["trie_evictions"] >= 1
    assert set(got["statuses"].values()) == {"ok"}
    assert_quiescent(eng)


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_prefix_v2_matches_reference(reference_runs, kernel):
    params, runs = reference_runs
    eng = port_engine_for(params, V2_SERVE, kernel)
    r1, follow, miss = _v2_turns(sched, loadgen, eng.run)
    assert [r.prompt for r in follow] == runs["v2_follow"]
    for got, want in zip([r1, eng.run(follow), eng.run(miss)], runs["v2"]):
        assert_same_result(got, want)
    p = got["prefix"]
    assert p["gen_inserted_blocks"] > 0 and p["partial_copy_tokens"] > 0
    assert p["prefill_tokens_saved"] > p["hit_tokens"] > 0
    assert_quiescent(eng)


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_host_tier_matches_reference(reference_runs, kv_dtype, kernel):
    """Demotion under pressure, then a prompt that promotes the deepest
    demoted block (and copy-on-writes it: the prompt is an exact block
    multiple): the results are the reference's, and the promoted block
    holds exactly the bytes that were demoted."""
    params, runs = reference_runs
    eng = port_engine_for(params, _tier_serve(kv_dtype), kernel)
    got = [eng.run(requests(sched, [(p, 2) for p in TIER_PROMPTS]))]
    key = _deepest_demoted(eng)
    assert key == runs["tier_key", kv_dtype]
    saved = [{name: t.clone() for name, t in layer.items()}
             for layer in eng.tier._store[key]]
    assert all(t.device.type == "cpu" for layer in saved
               for t in layer.values())
    prompt = [t for chunk in key for t in chunk]
    got.append(eng.run([sched.Request(99, prompt, 4)]))
    for g, w in zip(got, runs["tier", kv_dtype]):
        assert_same_result(g, w)
    tier = got[-1]["tier"]
    assert tier["demotions"] > 0 and tier["promotions"] > 0
    assert got[-1]["prefix"]["cow_copies"] >= 1
    assert key not in eng.tier
    node = eng.prefix_cache._root
    for chunk in key:
        node = node.children[chunk]
    for layer, host in zip(eng.pools, saved):
        assert set(layer) == set(host)
        for name in host:
            assert torch.equal(layer[name][node.block], host[name]), name
    assert_quiescent(eng)


def test_entry_point_serves_prefix_and_tier():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tensorflow_torch.serving",
         "--serve-tiny", "--device", "cpu", "--requests", "3",
         "--prompt-len", "8", "--new-tokens", "8", "--arrival-rate",
         "1000", "--serve-block-size", "4", "--serve-pool-blocks", "12",
         "--serve-prefix-cache", "on", "--serve-prefix-gen", "on",
         "--serve-kv-tier", "host"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["ok_requests"] == res["requests"] == 6
    assert res["prefix"]["enabled"] and res["prefix"]["hit_tokens"] > 0
    assert res["tier"]["demotions"] > 0 and res["tier"]["promotions"] > 0
    assert 0 < res["dispatches_per_token"] <= 2
    assert not res["speculation"]["enabled"]
