"""The port's serving stack against the JAX reference, on the CPU.

Host logic must match exactly: the same ``loadgen`` spec gives a
byte-identical trace, and the block allocator and the scheduler make the
same decisions on the same randomized operation stream.  The engine on
``device="cpu"`` serves the same requests with the same parameters to
the same tokens, statuses, dispatch shapes and dispatch count as the
reference engine on its ``xla`` lowering — with the port's ``gather``
lowering and with its ``cuda`` lowering (the kernel's plain version on
CPU tensors), and through a pool small enough to force an eviction —
with the pool in the compute dtype, and quantized to int8 and to int4
(quantization is per token row or group, so an eviction replay writes
the same bytes and the tokens stay identical).

Also pinned: ``ServeConfig`` takes the features the port serves with
the reference's validation, the fleet's (ROADMAP item 6) among them;
``cuda`` without a card raises instead of running on the CPU; ``python
-m mpi_tensorflow_torch.serving`` prints
its JSON line; and no module of the port, nor ``chip_smoke.py``, imports
JAX or the JAX package (an AST scan: this image imports JAX at start-up,
so an import check would prove nothing).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving_cases import COMPARED, JAX_TINY
from _torch_serving_cases import fast_compile as _fast_compile
from _torch_serving_cases import np_params as _np_params
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.serving import engine as jax_engine
from mpi_tensorflow_tpu.serving import loadgen as jax_loadgen
from mpi_tensorflow_tpu.serving import paged_cache as jax_cache
from mpi_tensorflow_tpu.serving import scheduler as jax_sched
from mpi_tensorflow_torch.models import bert, convert, gpt
from mpi_tensorflow_torch.serving import engine, loadgen, paged_cache
from mpi_tensorflow_torch.serving import scheduler as sched

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- loadgen

@pytest.mark.parametrize("workload", jax_loadgen.WORKLOADS)
def test_trace_byte_identical_to_reference(workload):
    """The bench's default spec (24 requests at 4 rps, prompts <= 32,
    outputs <= 128, BERT_BASE vocabulary, seed 0) for every workload."""
    kw = dict(workload=workload, num_requests=24, rate_rps=4.0,
              prompt_max=32, output_max=128, vocab_size=30522, seed=0)
    want = jax_loadgen.build_trace(jax_loadgen.WorkloadSpec(**kw))
    got = loadgen.build_trace(loadgen.WorkloadSpec(**kw))
    assert got.prompts == want.prompts
    assert got.outputs == want.outputs
    assert got.arrivals.dtype == want.arrivals.dtype
    assert got.arrivals.tobytes() == want.arrivals.tobytes()
    assert (got.tenants, got.slos_ms, got.sessions) \
        == (want.tenants, want.slos_ms, want.sessions)
    assert [dataclasses.asdict(r) for r in got.requests()] \
        == [dataclasses.asdict(r) for r in want.requests()]


# ------------------------------------------------- allocator + scheduler

def test_block_allocator_decisions_identical():
    rng = np.random.default_rng(0)
    a, b = paged_cache.BlockAllocator(17), jax_cache.BlockAllocator(17)
    held = []
    for _ in range(400):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 5))
            assert a.can_alloc(n) == b.can_alloc(n)
            if a.can_alloc(n):
                ids = a.alloc(n)
                assert ids == b.alloc(n)
                held.extend(ids)
        elif op == 1 and held:
            blk = held[int(rng.integers(len(held)))]
            a.share([blk])
            b.share([blk])
            held.append(blk)
        elif op == 2 and held:
            blk = held.pop(int(rng.integers(len(held))))
            a.release([blk])
            b.release([blk])
        assert (a.num_free, a.num_used) == (b.num_free, b.num_used)
        assert a._free == b._free and a._ref == b._ref
        a.check()
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc(a.num_free + 1)
    assert paged_cache.blocks_for(33, 16) == jax_cache.blocks_for(33, 16)


def _sched_state(s):
    return ([None if q is None else (q.request.id, tuple(q.block_ids),
                                     q.prefilled, tuple(q.generated))
             for q in s.slots],
            [r.id for r in s.waiting], dict(s.statuses), dict(s.counters),
            s.evictions, list(s.evicted_ids), s.allocator._free,
            s.allocator._ref, s.prefill_backlog_tokens)


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decisions_identical(seed):
    """A randomized stream of arrivals (some with deadlines), admissions,
    prefill progress, token records (with an EOS id), deadline sweeps and
    failures through a pool tight enough to evict: both schedulers must
    return the same values and hold the same state after every call."""
    rng = np.random.default_rng(seed)
    kw = dict(queue_depth=6, max_evictions=3, starvation_steps=4)
    port = sched.Scheduler(paged_cache.BlockAllocator(14), 3, 2, 8, **kw)
    ref = jax_sched.Scheduler(jax_cache.BlockAllocator(14), 3, 2, 8, **kw)
    rid = 0
    for step in range(160):
        now = step * 0.01
        for _ in range(int(rng.integers(0, 3))):
            prompt = [int(t) for t in rng.integers(0, 50,
                                                   rng.integers(1, 14))]
            dl = now + float(rng.uniform(0.05, 1.0)) \
                if rng.random() < 0.3 else None
            args = (rid, prompt, int(rng.integers(1, 8)), now, dl)
            got = port.submit(sched.Request(*args))
            want = ref.submit(jax_sched.Request(*args))
            assert (got is None) == (want is None)
            if got is not None:
                assert got.reason == want.reason
            rid += 1
        assert port.expire_deadlines(now) == ref.expire_deadlines(now)
        assert port.admit() == ref.admit()
        for s in (port, ref):
            for q in s.slots:
                if q is not None:          # the engine prefills a chunk
                    q.prefilled = min(len(q.request.prompt),
                                      q.prefilled + 4)
        for slot in port.live_slots():
            q = port.slots[slot]
            if q is None or q.prefilled < len(q.request.prompt):
                continue
            ok = port.ensure_block(slot)
            assert ok == ref.ensure_block(slot)
            if not ok:
                port.fail_live(slot, "rejected")
                ref.fail_live(slot, "rejected")
            elif port.slots[slot] is not None:
                tok = int(rng.integers(0, 50))
                port.record_token(slot, tok, 7)
                ref.record_token(slot, tok, 7)
        assert _sched_state(port) == _sched_state(ref)
        port.evicted_ids.clear()
        ref.evicted_ids.clear()
    assert port.evictions > 0 and len(port.statuses) > 10


# ---------------------------------------------------------------- engine

ENGINE_CASES = {
    # five mixed requests through 3 slots: chunked prefill, recycling
    "mixed": dict(serve=dict(num_blocks=40, block_size=4, max_slots=3,
                             max_seq_len=24, prefill_chunk=8),
                  requests=[(3, 6), (11, 2), (5, 8), (13, 4), (4, 1)]),
    # a pool tight enough to evict the youngest sequence mid-prefill
    "eviction": dict(serve=dict(num_blocks=9, block_size=2, max_slots=2,
                                max_seq_len=12, prefill_chunk=2),
                     requests=[(2, 10), (11, 1)]),
}
def _requests(mod, lens, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, [int(t) for t in rng.integers(0, 1024, n)], m)
            for i, (n, m) in enumerate(lens)]


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX engine's result per case, computed once per module."""
    out = {}
    params = _np_params(1)
    model = jax_gpt.CausalLm(JAX_TINY)
    with _fast_compile():
        for name, case in ENGINE_CASES.items():
            eng = jax_engine.PagedDecodeEngine(
                model, jax.tree.map(jnp.asarray, params),
                jax_engine.ServeConfig(kernel="xla", **case["serve"]))
            out[name] = eng.run(_requests(jax_sched, case["requests"], 2))
    return params, out


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference(reference_runs, case, kernel):
    params, runs = reference_runs
    want = runs[case]
    model = gpt.CausalLm(bert.BERT_TINY, convert.params_from_jax(params))
    eng = engine.PagedDecodeEngine(
        model, engine.ServeConfig(kernel=kernel, **ENGINE_CASES[case]["serve"]),
        device="cpu")
    got = eng.run(_requests(sched, ENGINE_CASES[case]["requests"], 2))
    for key in COMPARED:
        assert got[key] == want[key], key
    assert got["kernel"] == kernel and got["device"] == "cpu"
    if case == "eviction":
        assert got["evictions"] >= 1
    assert len({t for toks in got["outputs"].values() for t in toks}) > 3
    eng.allocator.check()
    assert eng.allocator.num_used == 0


@pytest.fixture(scope="module")
def quant_reference_runs():
    """The JAX engine's int8 and int4 results per case, computed once per
    module."""
    params = _np_params(1)
    model = jax_gpt.CausalLm(JAX_TINY)
    out = {}
    with _fast_compile():
        for kv_dtype in ("int8", "int4"):
            for name, case in ENGINE_CASES.items():
                eng = jax_engine.PagedDecodeEngine(
                    model, jax.tree.map(jnp.asarray, params),
                    jax_engine.ServeConfig(kernel="xla", kv_dtype=kv_dtype,
                                           **case["serve"]))
                out[kv_dtype, name] = eng.run(
                    _requests(jax_sched, case["requests"], 2))
    return params, out


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_engine_matches_reference(quant_reference_runs, kv_dtype,
                                            case, kernel):
    params, runs = quant_reference_runs
    want = runs[kv_dtype, case]
    model = gpt.CausalLm(bert.BERT_TINY, convert.params_from_jax(params))
    eng = engine.PagedDecodeEngine(
        model, engine.ServeConfig(kernel=kernel, kv_dtype=kv_dtype,
                                  **ENGINE_CASES[case]["serve"]),
        device="cpu")
    assert eng.pools[0]["k"].dtype == {"int8": torch.int8,
                                       "int4": torch.uint8}[kv_dtype]
    got = eng.run(_requests(sched, ENGINE_CASES[case]["requests"], 2))
    for key in COMPARED:
        assert got[key] == want[key], key
    assert (got["kernel"], got["kv_dtype"]) == (kernel, kv_dtype)
    if case == "eviction":
        assert got["evictions"] >= 1
    assert len({t for toks in got["outputs"].values() for t in toks}) > 3
    eng.allocator.check()
    assert eng.allocator.num_used == 0


def test_pow2_ceil_and_bucket_match_reference():
    for n in range(1, 70):
        assert engine.pow2_ceil(n) == jax_engine.pow2_ceil(n)
        assert engine._bucket(n, 8) == jax_engine._bucket(n, 8)


# ------------------------------------------------------------ ServeConfig

@pytest.mark.parametrize("field,value,item", [
    ("prefix_route", "on", "fleet routing"),
    ("tp", 2, "tensor parallelism"),
    ("trace", "on", "tracing"),
])
def test_serve_config_refuses_what_is_not_ported(field, value, item):
    """``ServeConfig`` refused these values, naming ROADMAP item 6
    (``item``), until the fleet slice was ported; it now takes them as
    the reference does, and raises for none of them."""
    kw = {field: value}
    if field == "prefix_route":
        kw["prefix_cache"] = "on"              # its own precondition
    got = dataclasses.asdict(engine.ServeConfig(**kw))
    want = dataclasses.asdict(jax_engine.ServeConfig(**kw))
    assert got.pop("kernel") == "auto" and want.pop("kernel") == "auto"
    assert got == want and got[field] == value


@pytest.mark.parametrize("kw", [
    dict(prefix_cache="on"), dict(prefix_cache="on", prefix_gen="on"),
    dict(prefix_cache="on", kv_tier="host"), dict(mixed_batch="on"),
    dict(mixed_batch="on", prefill_budget=8), dict(speculative="ngram"),
    dict(speculative="draft-model", draft_k=2, draft_auto="on"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_serve_config_accepts_the_ported_features(kw):
    got = dataclasses.asdict(engine.ServeConfig(**kw))
    want = dataclasses.asdict(jax_engine.ServeConfig(**kw))
    assert got.pop("kernel") == "auto" and want.pop("kernel") == "auto"
    assert got == want


@pytest.mark.parametrize("bad", [
    dict(block_size=0), dict(num_blocks=1), dict(kv_dtype="fp8"), dict(deadline_ms=0.0), dict(queue_depth=0),
    dict(num_blocks=10, max_seq_len=512), dict(prefix_gen="on"),
    dict(trace_out="t.json"), dict(kv_tier="host"), dict(draft_auto="on"),
    dict(mixed_batch="on", speculative="ngram"), dict(prefill_budget=0),
    dict(draft_k=0), dict(prefix_route="on"), dict(speculative="eagle"),
])
def test_serve_config_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        engine.ServeConfig(**bad)
    with pytest.raises(ValueError):
        jax_engine.ServeConfig(**bad)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "triton"])
def test_serve_config_takes_only_the_port_kernel_names(kernel):
    with pytest.raises(ValueError, match="auto|gather|cuda"):
        engine.ServeConfig(kernel=kernel)


def test_serve_config_from_config_defaults_match_reference():
    from mpi_tensorflow_torch.config import Config

    from mpi_tensorflow_tpu.config import Config as JaxConfig

    got = dataclasses.asdict(engine.ServeConfig.from_config(Config()))
    want = dataclasses.asdict(jax_engine.ServeConfig.from_config(JaxConfig()))
    assert got.pop("kernel") == "auto" and want.pop("kernel") == "auto"
    assert got == want


def test_serve_config_from_config_bridges_kv_knobs():
    from mpi_tensorflow_torch.config import Config

    from mpi_tensorflow_tpu.config import Config as JaxConfig

    kw = dict(serve_kv_dtype="int4", serve_kv_group=16)
    got = engine.ServeConfig.from_config(Config(**kw))
    want = jax_engine.ServeConfig.from_config(JaxConfig(**kw))
    assert (got.kv_dtype, got.kv_group) == (want.kv_dtype, want.kv_group) \
        == ("int4", 16)
    with pytest.raises(ValueError, match="kv_group"):
        engine.ServeConfig(kv_group=0)


def test_serve_config_from_config_bridges_feature_knobs():
    from mpi_tensorflow_torch.config import Config

    from mpi_tensorflow_tpu.config import Config as JaxConfig

    kw = dict(serve_prefix_cache="on", serve_prefix_gen="on",
              serve_kv_tier="host", serve_speculative="draft-model",
              serve_draft_k=3, serve_draft_auto="on",
              serve_prefill_budget=16)
    got = dataclasses.asdict(engine.ServeConfig.from_config(Config(**kw)))
    want = dataclasses.asdict(
        jax_engine.ServeConfig.from_config(JaxConfig(**kw)))
    assert got.pop("kernel") == "auto" and want.pop("kernel") == "auto"
    assert got == want
    mixed = engine.ServeConfig.from_config(Config(serve_mixed_batch="on"))
    assert mixed.mixed_batch == "on"


# ---------------------------------------------------- device + entry point

def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is served, not refused")
    model = gpt.CausalLm.from_seed(bert.BERT_TINY)
    with pytest.raises(RuntimeError, match="no card"):
        engine.PagedDecodeEngine(model, engine.ServeConfig(
            num_blocks=40, max_seq_len=64))
    assert model.device.type == "cpu"       # nothing moved or ran


def test_chip_smoke_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""


def test_entry_point_prints_one_json_line():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tensorflow_torch.serving",
         "--serve-tiny", "--device", "cpu", "--requests", "2",
         "--prompt-len", "8", "--new-tokens", "4", "--arrival-rate", "1000"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["kernel"] == "gather" and res["device"] == "cpu"
    assert res["launches"] == 0 and res["ok_requests"] == 2
    assert res["tokens"] > 0 and res["tokens_per_sec"] > 0
    for key in ("p50_token_latency_ms", "p99_token_latency_ms"):
        assert res[key] >= 0


def test_entry_point_serves_an_int4_pool():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tensorflow_torch.serving",
         "--serve-tiny", "--device", "cpu", "--requests", "2",
         "--prompt-len", "8", "--new-tokens", "4", "--arrival-rate", "1000",
         "--serve-kv-dtype", "int4", "--serve-kv-group", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["kv_dtype"] == "int4" and res["ok_requests"] == 2
    assert res["tokens"] > 0


# ------------------------------------------------------------------ rules

def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "mpi_tensorflow_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        bad = {"jax", "jaxlib", "mpi_tensorflow_tpu"} \
            & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"
        assert "importlib" not in path.read_text(), path
