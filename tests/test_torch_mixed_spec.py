"""The port's mixed batching and speculative decoding against the JAX
reference, on the CPU.

Host logic must match exactly: ``NgramDrafter`` drafts the reference's
tokens on seeded contexts.  The engine serves the same requests to the
same results as the reference engine (``COMPARED``: tokens, statuses,
dispatch shapes and counts, the speculation and prefix blocks, peak
blocks) under the port's ``gather`` and ``cuda`` lowerings (the
kernel's plain version on CPU tensors):

- mixed batching with ``prefill_budget`` (3) below ``prefill_chunk``
  (4), with the prefix cache on (its copy-on-write and trie insertion
  run inside the fused step): the tokens also equal the port's run with
  both off;
- ngram speculation at ``draft_k`` 4, ``draft_auto`` off and on, on a
  rope model (an untrained model with learned positions never repeats
  itself, so no draft would ever land);
- draft-model speculation with the target as its own drafter (every
  draft accepted: the tokens equal the port's speculation-off run) and
  with a small draft model whose weights are carried across from the
  JAX side (accepts and rejections, the rollback with them).

A mixed step writes nothing outside the rows it feeds: with the null
block poisoned before every step, each step changes only the cache rows
its valid lanes own, and the tokens stay the reference's.  Every case
ends with the pool (and the draft pool) empty.  ``python -m
mpi_tensorflow_torch.serving`` serves mixed and speculative runs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_serving_cases import (JAX_TINY, assert_quiescent,
                                  assert_same_result, fast_compile,
                                  jax_engine_for, no_prewarm, np_params,
                                  port_engine_for, port_model, pos_kind,
                                  requests)
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.serving import scheduler as jax_sched
from mpi_tensorflow_tpu.serving import speculative as jax_spec
from mpi_tensorflow_torch.serving import scheduler as sched
from mpi_tensorflow_torch.serving import speculative

REPO = Path(__file__).resolve().parents[1]
# the reference's cheap pre-warm: 2 slots, 4 blocks of 4 a sequence,
# chunks of 4 (18 mixed shapes, 6 verify shapes)
BASE = dict(num_blocks=40, block_size=4, max_slots=2, max_seq_len=16,
            prefill_chunk=4)
MIXED = dict(BASE, mixed_batch="on", prefill_budget=3, prefix_cache="on")

RNG = np.random.default_rng(5)


def _tokens(n):
    return [int(t) for t in RNG.integers(0, 1024, n)]


_SHARED = _tokens(8)
# mixed: two prompts share two full blocks, one is just those blocks
# (the copy-on-write trigger), the rest differ in length and budget
MIXED_TRACE = [(_tokens(9), 5), (_SHARED + _tokens(3), 4), (_tokens(7), 4),
               (_SHARED, 5), (_tokens(11), 3), (_tokens(5), 6)]
# speculation: rope-model streams that loop, plus two prompts that end
# in the start of a loop the model emits (found by serving the first
# four with speculation off), so the ngram drafter has something to find
SPEC_TRACE = [(_tokens(5), 10), (_tokens(4), 11), (_tokens(6), 9),
              (_tokens(3), 12)]
SPEC_TRACE += [(SPEC_TRACE[3][0] + [558, 677, 488, 177, 372, 87], 7),
               (SPEC_TRACE[0][0] + [342, 928, 63, 1022, 928, 63], 5)]
SPEC = dict(BASE, draft_k=4)
SPEC_CASES = {
    "ngram": dict(speculative="ngram"),
    "ngram_auto": dict(speculative="ngram", draft_auto="on"),
    "self_draft": dict(speculative="draft-model"),
    "draft_model": dict(speculative="draft-model"),
}


def _draft_params(params):
    """A small draft model near the target: its weights plus 2 % noise,
    so drafts land sometimes and miss sometimes."""
    rng = np.random.default_rng(7)
    return jax.tree.map(
        lambda x: (x * (1 + 0.02 * rng.normal(size=x.shape))).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX engine's results per case, computed once per module."""
    params = np_params(1)
    out = {}
    with fast_compile(), no_prewarm():
        eng = jax_engine_for(params, MIXED)
        out["mixed"] = eng.run(requests(jax_sched, MIXED_TRACE))
        donor = None
        for name, kw in SPEC_CASES.items():
            extra = {}
            if name == "self_draft":
                extra = dict(draft_model=jax_gpt.CausalLm(
                    pos_kind(JAX_TINY, "rope")), draft_params=params)
            elif name == "draft_model":
                extra = dict(draft_model=jax_gpt.CausalLm(
                    pos_kind(JAX_TINY, "rope")),
                    draft_params=_draft_params(params))
            eng = jax_engine_for(params, dict(SPEC, **kw), kind="rope",
                                 donor=donor, **extra)
            out[name] = eng.run(requests(jax_sched, SPEC_TRACE))
            if donor is None or name == "self_draft":
                donor = eng       # the first with a draft model's feed
    return params, out


def test_ngram_drafts_match_reference():
    """Seeded contexts over small vocabularies (repeats are common),
    every window 1..5, and the degenerate inputs."""
    rng = np.random.default_rng(0)
    port, ref = speculative.NgramDrafter(), jax_spec.NgramDrafter()
    hits = 0
    for _ in range(400):
        ctx = [int(t) for t in rng.integers(0, int(rng.integers(2, 9)),
                                            rng.integers(0, 30))]
        k = int(rng.integers(0, 6))
        got = port.draft(0, ctx, k)
        assert got == ref.draft(0, ctx, k)
        hits += bool(got)
    assert hits > 100


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_mixed_batch_matches_reference(reference_runs, kernel):
    params, runs = reference_runs
    eng = port_engine_for(params, MIXED, kernel)
    got = eng.run(requests(sched, MIXED_TRACE))
    assert_same_result(got, runs["mixed"])
    kinds = {shape[0] for shape in got["dispatch_shapes"]}
    assert kinds == {"mixed"}
    # a step fused several rows, and one had lanes of prefill (S > 1)
    assert any(b > 1 and s > 1 for _, b, s, _ in got["dispatch_shapes"])
    assert got["prefix"]["cow_copies"] >= 1
    assert_quiescent(eng)
    off = port_engine_for(params, BASE, kernel)
    plain = off.run(requests(sched, MIXED_TRACE))
    assert got["outputs"] == plain["outputs"]
    assert got["forward_dispatches"] < plain["forward_dispatches"]


def _spec_engine(params, name, kernel):
    extra = {}
    if name == "self_draft":
        extra = dict(draft_model=port_model(params, "rope"))
    elif name == "draft_model":
        extra = dict(draft_model=port_model(_draft_params(params), "rope"))
    return port_engine_for(params, dict(SPEC, **SPEC_CASES[name]), kernel,
                           kind="rope", **extra)


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_speculation_matches_reference(reference_runs, name, kernel):
    params, runs = reference_runs
    eng = _spec_engine(params, name, kernel)
    got = eng.run(requests(sched, SPEC_TRACE))
    assert_same_result(got, runs[name])
    spec = got["speculation"]
    assert spec["enabled"] and spec["accepted_tokens"] > 0
    assert {s[0] for s in got["dispatch_shapes"]} <= {"prefill", "verify"}
    if name == "self_draft":
        assert spec["accept_rate"] == 1.0
    if name == "draft_model":
        assert 0 < spec["accept_rate"] < 1
        assert eng.drafter.feeds > 0
    assert_quiescent(eng)
    if name in ("self_draft", "ngram"):
        off = port_engine_for(params, BASE, kernel, kind="rope")
        assert off.run(requests(sched, SPEC_TRACE))["outputs"] \
            == got["outputs"]


def test_mixed_step_writes_only_its_rows(reference_runs):
    """Drive the mixed engine step by step with the null block set to
    1e30 before every step: each step changes exactly the (block, slot)
    rows of its rows' valid lanes (taken from the dispatch's own rows:
    position ``start + lane`` through the row's block table), nothing
    in another live or free block, and the run's tokens stay the
    reference's."""
    params, runs = reference_runs
    serve = dict(MIXED, prefix_cache="off")
    eng = port_engine_for(params, serve, "cuda")
    for req in requests(sched, MIXED_TRACE):
        assert eng.sched.submit(req) is None
    bs = eng.serve.block_size
    owned = set()
    dispatch = eng._dispatch_lanes

    def recording(rows, width):
        for _slot, seq, lanes, start in rows:
            owned.update((seq.block_ids[pos // bs], pos % bs)
                         for pos in range(start, start + len(lanes)))
        return dispatch(rows, width)

    eng._dispatch_lanes = recording
    outputs = {}
    steps = 0
    while not eng.sched.all_done():
        for layer in eng.pools:
            for leaf in layer.values():
                leaf[0] = 1e30
        before = [{k: v.clone() for k, v in layer.items()}
                  for layer in eng.pools]
        owned.clear()
        for rid, tok in eng.step():
            outputs.setdefault(rid, []).append(tok)
        steps += 1
        changed = set()
        for layer, old in zip(eng.pools, before):
            for key, leaf in layer.items():
                d = leaf[1:] != old[key][1:]            # (N-1, H, bs, D)
                rows = d.reshape(d.shape[:3] + (-1,)).any(-1).any(1)
                changed |= {(blk + 1, slot)
                            for blk, slot in rows.nonzero().tolist()}
        assert changed == owned, (sorted(changed - owned),
                                  sorted(owned - changed))
    assert outputs == runs["mixed"]["outputs"]
    assert steps > 5
    assert_quiescent(eng)


@pytest.mark.parametrize("flags", [
    ["--serve-mixed-batch", "on", "--serve-prefill-budget", "4"],
    ["--serve-speculative", "ngram", "--serve-draft-auto", "on"],
], ids=["mixed", "ngram"])
def test_entry_point_serves_the_feature(flags):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tensorflow_torch.serving",
         "--serve-tiny", "--device", "cpu", "--requests", "3",
         "--prompt-len", "8", "--new-tokens", "8", "--arrival-rate",
         "1000", "--serve-block-size", "4", *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["ok_requests"] == res["requests"] == 3
    assert res["tokens"] > 0 and res["dispatches_per_token"] > 0
    assert res["speculation"]["enabled"] == ("--serve-speculative" in flags)
    if "--serve-speculative" in flags:
        assert res["speculation"]["verify_forwards"] > 0
