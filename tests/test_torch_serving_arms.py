"""The serving bench's remaining arms against the JAX reference's bench,
on the CPU: the static-batch arm, ``--serve-kernel-ab``,
``--serve-kv-ab`` (int8 and int4), ``--serve-spec-ab`` (ngram) and
``--serve-mixed-ab``; their exclusions; and ``--serve-tp 2`` with a
fleet, a journal and the prefix route.

The same tiny trace (BERT_TINY, fp32, 3 requests, prompts <= 8, outputs
<= 5) goes through the port's ``measure_serving`` and the root
``bench.measure_serving``, both models on the same weights (the
reference's ``init`` and the port's ``from_seed`` both give the serving
tests' numpy draw, ``_torch_serving_cases.np_params``).  The arrival
rate is 1e9 requests a second, so every request has arrived at the
first iteration on either side and the schedule does not depend on the
wall clock.  Held EQUAL (host and integer keys; no float is compared):

- every engine run's tokens, in order (each arm's warmup and timed
  runs), and the arms' token-identity flags;
- ``kv_quant``: ``token_match_rate``, ``capacity_multiplier``, the
  matched and compared tokens, the bytes a block and a decode token,
  the peak-live-blocks delta;
- ``dispatches_per_token`` and ``forward_dispatches`` of the timed arm,
  and per arm under ``--serve-mixed-ab``;
- the static arm's groups (rows, padded prompt, budget, cache length:
  the reference's ``generate`` calls, recorded in place of running
  them) and its useful-token count.

Every A/B exclusion of the reference (its command line's and its
``measure_serving``'s) is refused by the port's flag check under the
same flags.  The reference's engines share their compiled steps (one
compile a model and lowering) and skip their pre-warm dispatches
(``_torch_serving_cases``), so a file of five benches compiles each
step shape once.

``--serve-tp 2`` runs on two gloo ranks (``tests/_torch_tp_fleet_worker.py``):
2 replicas through a fault, 2 journaled replicas and their relaunch on
the same journals, the prefix route, and one engine journaled through
``run_with_replay``'s ``journal_path``; every run serves the tp 1
engine's tokens, and a journal's files hold each request once.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import _torch_tp_fleet_worker as worker
import bench as ref_bench
from _torch_serving_cases import (JIT_STEPS, fast_compile, no_prewarm,
                                  np_params)
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.serving import engine as jax_engine
from mpi_tensorflow_torch.models import convert, gpt
from mpi_tensorflow_torch.parallel import mesh
from mpi_tensorflow_torch.serving import engine, harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's seeded weights, as the harness draws them (the fixture
# below patches ``from_seed`` for the arms compared with the reference)
SEEDED = gpt.CausalLm.from_seed
TRACE = dict(num_requests=3, rate_rps=1e9, prompt_max=8, output_max=5,
             precision="fp32", tiny=True)
ARGV = ["--serve-tiny", "--device", "cpu", "--requests", "3",
        "--prompt-len", "8", "--new-tokens", "5", "--arrival-rate", "1e9"]
ARMS = {
    "kernel_ab": (["--serve-kernel-ab"], dict(kernel_ab=True)),
    "kv_ab_int8": (["--serve-kv-ab"], dict(kv_ab=True)),
    "kv_ab_int4": (["--serve-kv-ab", "--serve-kv-dtype", "int4"],
                   dict(kv_ab=True, kv_dtype="int4")),
    "spec_ab": (["--serve-speculative", "ngram", "--serve-spec-ab"],
                dict(speculative="ngram", spec_ab=True)),
    "mixed_ab": (["--serve-mixed-batch", "on", "--serve-mixed-ab"],
                 dict(mixed="on", mixed_ab=True)),
}
KV_KEYS = ("token_match_rate", "capacity_multiplier", "matched_tokens",
           "compared_tokens", "block_bytes", "block_bytes_ref",
           "bytes_per_decode_token", "bytes_per_decode_token_ref",
           "peak_live_blocks_delta", "kv_dtype")


def _keyed(outputs):
    return {int(k): list(v) for k, v in outputs.items()}


def _port_args(argv):
    return worker.parse(argv)


@pytest.fixture(scope="module")
def weights():
    return np_params(3)


@pytest.fixture(scope="module")
def patched(weights):
    """Both models on ``weights``; every engine run's tokens recorded;
    the reference's engines sharing their compiled steps by model and
    lowering, its static arm's ``generate`` calls recorded in place of
    run."""
    rec = {"ref": [], "port": [], "static": []}
    donors = {}
    jparams = jax.tree.map(jnp.asarray, weights)
    tparams = convert.params_from_jax(weights)
    ref_init, ref_run = (jax_engine.PagedDecodeEngine.__init__,
                         jax_engine.PagedDecodeEngine.run)
    port_run = engine.PagedDecodeEngine.run

    def init(self, *a, **kw):
        ref_init(self, *a, **kw)
        key = (self.model.cfg, self.kernel)
        donor = donors.setdefault(key, self)
        for name in JIT_STEPS:
            setattr(self, name, getattr(donor, name))

    def recorder(run, side):
        def wrapped(self, *a, **kw):
            res = run(self, *a, **kw)
            rec[side].append(_keyed(res["outputs"]))
            return res
        return wrapped

    def generate(self, params, prompt, n, *, cache_len=None, **kw):
        rec["static"].append([int(prompt.shape[0]), int(prompt.shape[1]),
                              int(n), int(cache_len)])
        return jnp.zeros((prompt.shape[0], prompt.shape[1] + n), jnp.int32)

    with pytest.MonkeyPatch.context() as mp, fast_compile(), no_prewarm():
        mp.setattr(jax_gpt.CausalLm, "init", lambda self, key: jparams)
        mp.setattr(jax_gpt.CausalLm, "generate", generate)
        mp.setattr(jax_engine.PagedDecodeEngine, "__init__", init)
        mp.setattr(jax_engine.PagedDecodeEngine, "run",
                   recorder(ref_run, "ref"))
        mp.setattr(jax_engine.PagedDecodeEngine, "prewarm_decode",
                   lambda self: None)
        mp.setattr(engine.PagedDecodeEngine, "run",
                   recorder(port_run, "port"))
        mp.setattr(gpt.CausalLm, "from_seed", classmethod(
            lambda cls, cfg, seed=0: cls(cfg, tparams)))
        yield rec


@pytest.fixture(scope="module")
def arms(patched):
    out = {}
    for name, (argv, kw) in ARMS.items():
        for side in ("ref", "port", "static"):
            patched[side].clear()
        want = ref_bench.measure_serving(**TRACE, **kw)
        got = harness.measure_serving(_port_args(ARGV + argv))
        out[name] = dict(want=want, got=got, ref_runs=list(patched["ref"]),
                         port_runs=list(patched["port"]),
                         static=list(patched["static"]))
    return out


@pytest.mark.parametrize("name", list(ARMS))
def test_arm_serves_the_reference_tokens(arms, name):
    a = arms[name]
    assert len(a["port_runs"]) == len(a["ref_runs"]) == 4
    assert a["port_runs"] == a["ref_runs"]
    got, want = a["got"], a["want"]
    assert got["dispatches_per_token"] == want["dispatches_per_token"]
    assert got["forward_dispatches"] == want["forward_dispatches"]
    assert got["ok_requests"] == 3


@pytest.mark.parametrize("name", list(ARMS))
def test_static_arm_groups_match_reference(arms, name):
    a = arms[name]
    static = a["got"]["static_batch"]
    # the reference compiles once a shape: its recorded calls are the
    # distinct groups of its warm pass
    assert static["groups"] == a["static"]
    trace = ref_bench.make_serving_spec(
        num_requests=3, rate_rps=1e9, prompt_max=8, output_max=5,
        vocab_size=1024)
    from mpi_tensorflow_tpu.serving import loadgen as jax_loadgen
    assert static["useful_tokens"] == sum(
        jax_loadgen.build_trace(trace).outputs)
    assert a["got"]["speedup_vs_static"] > 0


def test_kernel_ab_block(arms):
    got, want = arms["kernel_ab"]["got"], arms["kernel_ab"]["want"]
    ab, wab = got["kernel_ab"], want["kernel_ab"]
    assert ab["kernels"] == ["cuda", "gather"]
    assert wab["kernels"] == ["pallas", "xla"]
    assert ab["token_identical"] is True
    assert set(ab["tokens_per_sec"]) == {"cuda", "gather"}
    assert ab["cuda_speedup_vs_gather"] > 0 and ab["ab_zero_recompile"] is None
    assert ab["forward_dispatches"]["cuda"] == \
        ab["forward_dispatches"]["gather"] == want["forward_dispatches"]


@pytest.mark.parametrize("name", ["kv_ab_int8", "kv_ab_int4"])
def test_kv_ab_block_matches_reference(arms, name):
    got, want = arms[name]["got"]["kv_quant"], arms[name]["want"]["kv_quant"]
    for key in KV_KEYS:
        assert got[key] == want[key], key
    assert got["peak_live_blocks_delta"] == 0
    assert set(got["tokens_per_sec"]) == set(want["tokens_per_sec"])


def test_spec_ab_block_matches_reference(arms):
    got, want = arms["spec_ab"]["got"], arms["spec_ab"]["want"]
    assert got["speculation"]["token_identical_vs_off"] is \
        want["speculation"]["token_identical_vs_off"] is True
    for key in ("drafted_tokens", "accepted_tokens", "verify_steps"):
        if key in want["speculation"]:
            assert got["speculation"][key] == want["speculation"][key], key
    assert set(got["spec_ab"]["arms"]) == set(want["spec_ab"]["arms"])
    assert got["spec_ab"]["spec_speedup_vs_off"] > 0


def test_mixed_ab_block_matches_reference(arms):
    got, want = arms["mixed_ab"]["got"], arms["mixed_ab"]["want"]
    m, wm = got["mixed_ab"], want["mixed_ab"]
    assert m["dispatches_per_token"] == wm["dispatches_per_token"]
    assert m["dispatch_reduction"] == wm["dispatch_reduction"]
    assert m["token_identical_vs_off"] is wm["token_identical_vs_off"]
    assert set(m["ttft_p99_ms"]) == {"mixed", "off"}
    assert m["prefill_budget"] == wm["prefill_budget"]


EXCLUSIONS = [
    (["--serve-kernel-ab", "--serve-journal", "j"], dict(kernel_ab=True,
                                                         journal="j")),
    (["--serve-kernel-ab", "--serve-prefix-cache", "on"],
     dict(kernel_ab=True, prefix_cache="on")),
    (["--serve-kernel-ab", "--serve-speculative", "ngram"],
     dict(kernel_ab=True, speculative="ngram")),
    (["--serve-kernel-ab", "--serve-replicas", "2"],
     dict(kernel_ab=True, replicas=2)),
    (["--serve-spec-ab"], dict(spec_ab=True)),
    (["--serve-spec-ab", "--serve-speculative", "ngram", "--serve-journal",
      "j"], dict(spec_ab=True, speculative="ngram", journal="j")),
    (["--serve-spec-ab", "--serve-kernel-ab", "--serve-speculative",
      "ngram"], dict(spec_ab=True, kernel_ab=True, speculative="ngram")),
    (["--serve-spec-ab", "--serve-speculative", "ngram",
      "--serve-replicas", "2"],
     dict(spec_ab=True, speculative="ngram", replicas=2)),
    (["--serve-kv-ab", "--serve-journal", "j"], dict(kv_ab=True,
                                                     journal="j")),
    (["--serve-kv-ab", "--serve-kernel-ab"], dict(kv_ab=True,
                                                  kernel_ab=True)),
    (["--serve-kv-ab", "--serve-replicas", "2"], dict(kv_ab=True,
                                                      replicas=2)),
    (["--serve-kv-ab", "--serve-prefix-cache", "on"],
     dict(kv_ab=True, prefix_cache="on")),
    (["--serve-kv-ab", "--serve-speculative", "ngram"],
     dict(kv_ab=True, speculative="ngram")),
    (["--serve-mixed-ab"], dict(mixed_ab=True)),
    (["--serve-mixed-ab", "--serve-mixed-batch", "on", "--serve-journal",
      "j"], dict(mixed_ab=True, mixed="on", journal="j")),
    (["--serve-mixed-ab", "--serve-mixed-batch", "on", "--serve-kv-ab"],
     dict(mixed_ab=True, mixed="on", kv_ab=True)),
    (["--serve-mixed-ab", "--serve-mixed-batch", "on", "--serve-replicas",
      "2"], dict(mixed_ab=True, mixed="on", replicas=2)),
    (["--serve-mixed-ab", "--serve-mixed-batch", "on",
      "--serve-prefix-cache", "on"],
     dict(mixed_ab=True, mixed="on", prefix_cache="on")),
]


@pytest.mark.parametrize("argv,kw", EXCLUSIONS)
def test_exclusions_refused_as_the_reference_refuses(patched, argv, kw):
    with pytest.raises(ValueError):
        ref_bench.measure_serving(**TRACE, **kw)
    with pytest.raises(SystemExit):
        _port_args(ARGV + argv)


def test_allowed_combinations_pass_the_check(patched):
    """What the reference allows, the port's check lets through: the
    spec A/B beside the prefix cache, and tensor parallelism with a
    fleet, a journal, the prefix route and prefix-gen."""
    for argv in (["--serve-spec-ab", "--serve-speculative", "ngram",
                  "--serve-prefix-cache", "on"],
                 ["--serve-tp", "2", "--serve-replicas", "2",
                  "--serve-journal", "j"],
                 ["--serve-tp", "2", "--serve-prefix-cache", "on",
                  "--serve-prefix-route", "on", "--serve-prefix-gen", "on"]):
        _port_args(ARGV + argv)


# ----------------------------------------------------- tp 2, the fleet

@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tpfleet")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in mesh.LAUNCH_ENV:
        env.pop(k, None)
    port = mesh.free_port()
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), "2", str(port),
         str(workdir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        # the tp 1 engine's tokens, meanwhile: the plain trace and the
        # one with the 8-token shared prompt
        one = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gpt.CausalLm, "from_seed", classmethod(
                lambda cls, cfg, seed=0: SEEDED(cfg, seed)))
            runs = []
            run = engine.PagedDecodeEngine.run
            mp.setattr(engine.PagedDecodeEngine, "run",
                       lambda self, *a, **kw: runs.append(
                           run(self, *a, **kw)) or runs[-1])
            for case in ("fault", "route"):
                runs.clear()
                harness.measure_serving(_port_args(
                    worker.case_args(case, str(workdir / "tp1"))))
                one[case] = {str(k): v for k, v in
                             runs[1]["outputs"].items()}
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        log.seek(0)
        assert rc == 0, f"rank {r} exited {rc}:\n{log.read()[-4000:]}"
        log.close()
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(2)]
    return one, ranks


@pytest.mark.parametrize("case", list(worker.CASES))
def test_tp2_fleet_serves_the_tp1_tokens(tp_world, case):
    one, ranks = tp_world
    want = one["route" if case == "route" else "fault"]
    for r in ranks:
        got = r[case]
        for outputs in got["fleet_runs"]:
            assert outputs == want
        if got["outputs"] is not None:
            assert got["outputs"] == want
        assert got["statuses"] == {"ok": 2}
    for key in ("fleet_runs", "outputs", "dispatches", "fleet_faults"):
        assert ranks[0][case][key] == ranks[1][case][key], key
    if case == "fault":
        assert ranks[0][case]["fleet_faults"]["failovers"] == 1
    if case == "resume":
        # the relaunch found every request ended in rank 0's journals,
        # and every rank from their records: nothing was served again
        assert ranks[0]["journal"]["dispatches"] > 0
        assert ranks[0]["resume"]["dispatches"] == 0
    if case == "route":
        assert ranks[0][case]["route"]["token_identical_vs_single"]
    if case in ("journal", "replay"):
        # rank 0's files hold each request once: the other rank recorded
        # into its mirror in memory, not into the files
        tokens = ranks[0][case]["tokens"]
        assert ranks[0][case]["journal_records"] == {
            "submit": 2, "tok": tokens, "end": 2}
