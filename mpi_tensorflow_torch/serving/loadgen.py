"""Trace-driven load generation for the serving entry point.

Counterpart of ``mpi_tensorflow_tpu/serving/loadgen.py`` (pure numpy,
ported whole): ``WorkloadSpec`` describes a synthetic trace,
``build_trace`` turns spec + seed into a ``Trace``, and
``per_request_rows`` joins a trace with a run's result into the rows
``metrics_writer.goodput_block`` aggregates.  ONE
``np.random.default_rng(seed)`` drives every draw in a fixed order, so
the same spec gives a byte-identical trace here and in the reference
(pinned by tests/test_torch_serving.py) — and the same requests across
warmup, timed and cross-check runs.

Workload matrix (``workload``):

==============  ==========================  =========================
workload        arrivals                    lengths / extras
==============  ==========================  =========================
poisson         exponential gaps            uniform [min(8,max), max]
bursty          2-state MMPP: baseline      spec ``length_dist``
                rate / rate*burst_boost,
                exponential phase dwells
diurnal         raised-cosine envelope      spec ``length_dist``
                [floor*rate, rate] via
                Lewis–Shedler thinning
multi-tenant    MMPP (bursty arrivals)      per-tenant length caps,
                                            SLOs and sticky sessions
==============  ==========================  =========================
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from mpi_tensorflow_torch.serving.scheduler import Request

#: the workload enum
WORKLOADS = ("poisson", "bursty", "multi-tenant", "diurnal")
#: prompt/output length distributions ("uniform" is the historical one)
LENGTH_DISTS = ("uniform", "lognormal", "zipf")


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One named tenant in a multi-tenant mix.  ``share`` is the mix
    weight (normalized over the spec's tenants); None length/SLO knobs
    inherit the spec's.  ``session_len`` > 1 groups the tenant's
    requests into multi-turn sessions (geometric lengths) whose shared
    ``Request.session`` key feeds the router's sticky placement."""
    name: str
    share: float
    prompt_max: Optional[int] = None
    output_max: Optional[int] = None
    slo_ms: Optional[float] = None
    session_len: int = 1

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant class needs a non-empty name")
        if not self.share > 0:
            raise ValueError(f"tenant {self.name!r} share must be > 0, "
                             f"got {self.share}")
        for k in ("prompt_max", "output_max"):
            v = getattr(self, k)
            if v is not None and v < 1:
                raise ValueError(f"tenant {self.name!r} {k} must be "
                                 f">= 1, got {v}")
        if self.slo_ms is not None and not self.slo_ms > 0:
            raise ValueError(f"tenant {self.name!r} slo_ms must be > 0, "
                             f"got {self.slo_ms}")
        if self.session_len < 1:
            raise ValueError(f"tenant {self.name!r} session_len must be "
                             f">= 1, got {self.session_len}")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything that shapes a synthetic serving trace.  (spec, seed)
    is the reproducibility key: the same pair builds the exact same
    request list (arrival stamps, token content, deadlines, sessions).

    The defaults ARE the historical bench trace: ``poisson`` arrivals,
    ``uniform`` lengths, no prefix, no SLO — ``build_trace`` on a
    default spec replays bench.py's original inline generator
    byte-for-byte (the refactor pin)."""
    workload: str = "poisson"
    num_requests: int = 24
    rate_rps: float = 4.0
    prompt_max: int = 32
    output_max: int = 128
    vocab_size: int = 32000
    prefix_tokens: int = 0        # shared system prompt prepended to
                                  # every request (0 = all-unique; the
                                  # prefix draw must not advance the rng)
    length_dist: str = "uniform"
    slo_ms: Optional[float] = None  # per-request latency budget; stamped
                                  # as Request.deadline = arrival + slo
    seed: int = 0
    # bursty / multi-tenant arrivals: 2-state MMPP — a baseline phase at
    # rate_rps and a burst phase at rate_rps * burst_boost, phase dwell
    # times exponential with these means
    burst_on_s: float = 0.5
    burst_off_s: float = 2.0
    burst_boost: float = 8.0
    # diurnal envelope: peak rate_rps, trough diurnal_floor * rate_rps,
    # raised-cosine period diurnal_period_s (thinned Poisson)
    diurnal_period_s: float = 4.0
    diurnal_floor: float = 0.1
    # multi-tenant mix; () under workload="multi-tenant" uses
    # default_tenants() (interactive-vs-batch)
    tenants: Tuple[TenantClass, ...] = ()
    session_len: int = 1          # non-tenant workloads: mean multi-turn
                                  # session length (1 = no sessions)
    followup_turns: int = 0       # seeded follow-up-turn mode (prefix
                                  # v2 bench): each extra turn replays
                                  # every request as prior prompt +
                                  # ANSWER + a pre-drawn unique suffix
                                  # (Trace.followup_requests); 0 draws
                                  # nothing — the default trace stays
                                  # byte-identical

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(
                f"--serve-workload must be one of "
                f"{'|'.join(WORKLOADS)}, got {self.workload!r}")
        if self.num_requests < 1 or self.prompt_max < 1 \
                or self.output_max < 1:
            raise ValueError(
                f"serving trace needs >= 1 request/prompt/output token, "
                f"got requests={self.num_requests} "
                f"prompt_max={self.prompt_max} "
                f"output_max={self.output_max}")
        if not self.rate_rps > 0:
            raise ValueError(f"arrival rate must be > 0 req/s, got "
                             f"{self.rate_rps}")
        if self.vocab_size < 1:
            raise ValueError(f"vocab_size must be >= 1, got "
                             f"{self.vocab_size}")
        if self.prefix_tokens < 0:
            raise ValueError(f"--serve-prefix-tokens must be >= 0, got "
                             f"{self.prefix_tokens}")
        if self.length_dist not in LENGTH_DISTS:
            raise ValueError(
                f"length_dist must be one of {'|'.join(LENGTH_DISTS)}, "
                f"got {self.length_dist!r}")
        if self.slo_ms is not None and not self.slo_ms > 0:
            raise ValueError(f"--serve-slo-ms must be > 0, got "
                             f"{self.slo_ms}")
        if not self.burst_on_s > 0 or not self.burst_off_s > 0:
            raise ValueError(
                f"MMPP phase dwell means must be > 0 s, got "
                f"on={self.burst_on_s} off={self.burst_off_s}")
        if self.burst_boost < 1:
            raise ValueError(f"burst_boost must be >= 1 (the burst phase "
                             f"is the fast one), got {self.burst_boost}")
        if not self.diurnal_period_s > 0:
            raise ValueError(f"diurnal_period_s must be > 0, got "
                             f"{self.diurnal_period_s}")
        if not 0 < self.diurnal_floor <= 1:
            raise ValueError(f"diurnal_floor must be in (0, 1], got "
                             f"{self.diurnal_floor}")
        if self.tenants and self.workload != "multi-tenant":
            raise ValueError(
                f"tenant classes only apply under workload "
                f"'multi-tenant', got {self.workload!r} with "
                f"{len(self.tenants)} tenants")
        if self.session_len < 1:
            raise ValueError(f"session_len must be >= 1, got "
                             f"{self.session_len}")
        if self.followup_turns < 0:
            raise ValueError(f"followup_turns must be >= 0, got "
                             f"{self.followup_turns}")


def default_tenants(spec: WorkloadSpec) -> Tuple[TenantClass, ...]:
    """The built-in multi-tenant mix: a chatty interactive class (short
    outputs, tight SLO, 3-turn sticky sessions) against a batch class
    (full-length outputs, 4x looser SLO, no affinity) — the
    interference regime multi-tenant serving is graded on."""
    return (
        TenantClass("interactive", share=0.7,
                    output_max=max(1, spec.output_max // 4),
                    slo_ms=spec.slo_ms, session_len=3),
        TenantClass("batch", share=0.3,
                    output_max=spec.output_max,
                    slo_ms=(spec.slo_ms * 4
                            if spec.slo_ms is not None else None),
                    session_len=1),
    )


@dataclasses.dataclass
class Trace:
    """A built trace: per-request content + the SLO/tenant metadata the
    goodput report joins against.  ``requests()`` materializes fresh
    ``Request`` objects each call — bench replays the same trace
    through warmup, timed, A/B, and routed arms."""
    spec: WorkloadSpec
    prompts: List[List[int]]
    outputs: List[int]
    arrivals: np.ndarray
    tenants: List[str]
    slos_ms: List[Optional[float]]
    sessions: List[Optional[str]]
    # follow-up-turn mode (spec.followup_turns > 0): per-turn pre-drawn
    # unique suffixes and arrival gaps — the seeded half of a follow-up
    # prompt; the other half (the ANSWER) only exists after a run, so
    # followup_requests() joins them post hoc
    followup_suffixes: List[List[List[int]]] = \
        dataclasses.field(default_factory=list)
    followup_gaps: List[np.ndarray] = \
        dataclasses.field(default_factory=list)

    def requests(self) -> List[Request]:
        return [
            Request(i, self.prompts[i], self.outputs[i],
                    float(self.arrivals[i]),
                    deadline=(float(self.arrivals[i])
                              + self.slos_ms[i] / 1e3
                              if self.slos_ms[i] is not None else None),
                    session=self.sessions[i])
            for i in range(len(self.prompts))]

    def followup_requests(self, turn: int, prev_requests: List[Request],
                          outputs: dict, *, id_base: int,
                          arrival_base: float = 0.0) -> List[Request]:
        """Materialize follow-up turn ``turn`` (1-based, up to
        ``spec.followup_turns``): request ``i``'s new prompt is the
        prior turn's FULL prompt + its generated answer (``outputs``
        keyed by the prior request id — an engine/router run's
        ``outputs`` dict) + this turn's pre-drawn unique suffix.  The
        multi-turn regime generated-block caching exists for: everything
        up to the suffix re-prefills on a v1 cache but maps straight out
        of the trie under --serve-prefix-gen.  Ids start at ``id_base``
        (distinct from every prior turn's); arrivals replay the turn's
        seeded exponential gaps from ``arrival_base``."""
        if not 1 <= turn <= len(self.followup_suffixes):
            raise ValueError(
                f"follow-up turn {turn} out of range: trace has "
                f"{len(self.followup_suffixes)} "
                f"(spec.followup_turns={self.spec.followup_turns})")
        suffixes = self.followup_suffixes[turn - 1]
        arr = arrival_base + np.cumsum(self.followup_gaps[turn - 1])
        reqs = []
        for i, prev in enumerate(prev_requests):
            answer = list(outputs.get(prev.id, ()))
            prompt = list(prev.prompt) + answer + suffixes[i]
            a = float(arr[i])
            reqs.append(Request(
                id_base + i, prompt, self.outputs[i], a,
                deadline=(a + self.slos_ms[i] / 1e3
                          if self.slos_ms[i] is not None else None),
                session=self.sessions[i]))
        return reqs


def _mmpp_arrivals(rng, n: int, spec: WorkloadSpec) -> np.ndarray:
    """2-state Markov-modulated Poisson arrivals: a baseline phase at
    ``rate_rps`` and a burst phase at ``rate_rps * burst_boost``, with
    exponential phase dwells.  Restarting the gap draw at each phase
    boundary is exact (exponentials are memoryless)."""
    rate = {False: spec.rate_rps,
            True: spec.rate_rps * spec.burst_boost}
    t, on = 0.0, False
    phase_end = rng.exponential(spec.burst_off_s)
    out: List[float] = []
    while len(out) < n:
        gap = rng.exponential(1.0 / rate[on])
        if t + gap >= phase_end:
            t = phase_end
            on = not on
            phase_end = t + rng.exponential(
                spec.burst_on_s if on else spec.burst_off_s)
            continue
        t += gap
        out.append(t)
    arr = np.asarray(out)
    arr[0] = 0.0
    return arr


def _diurnal_arrivals(rng, n: int, spec: WorkloadSpec) -> np.ndarray:
    """Non-homogeneous Poisson arrivals under a raised-cosine rate
    envelope swinging between ``diurnal_floor * rate_rps`` (trough) and
    ``rate_rps`` (peak), via Lewis–Shedler thinning against the peak."""
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / spec.rate_rps)
        phase = 0.5 * (1.0 - math.cos(
            2.0 * math.pi * t / spec.diurnal_period_s))
        accept = spec.diurnal_floor + (1.0 - spec.diurnal_floor) * phase
        if rng.random() <= accept:
            out.append(t)
    arr = np.asarray(out)
    arr[0] = 0.0
    return arr


def _sample_len(rng, dist: str, lo: int, hi: int) -> int:
    """One prompt/output length in [lo, hi].  ``uniform`` is the
    historical distribution; the heavy-tailed options put the median
    near ``lo`` with a tail clamped at ``hi`` (lognormal body, bounded
    Zipf) — the mixed-length regime continuous batching exists for."""
    if hi <= lo:
        return hi
    if dist == "uniform":
        return int(rng.integers(lo, hi + 1))
    if dist == "lognormal":
        return max(lo, min(hi, int(round(lo * rng.lognormal(0.0, 1.0)))))
    return max(lo, min(hi, lo - 1 + int(rng.zipf(1.5))))   # zipf


def build_trace(spec: WorkloadSpec) -> Trace:
    """Build the full trace for ``spec`` from ONE seeded generator.

    Draw order is part of the contract: shared prefix (only when
    ``prefix_tokens`` > 0 — a zero prefix must not advance the rng),
    tenant assignment (only under a tenant mix), prompt lengths +
    tokens, output budgets, arrivals, then sessions.  On a default
    Poisson/uniform spec the first four stages are literally the
    historical bench.measure_serving code, so the default trace is
    byte-identical to the pre-loadgen inline generator."""
    rng = np.random.default_rng(spec.seed)
    n = spec.num_requests
    p_lo = min(8, spec.prompt_max)
    o_lo = min(8, spec.output_max)
    # shared-prefix workload: one common N-token system prompt replayed
    # in front of every request's unique tail (prefix_tokens=0 keeps
    # the original all-unique trace byte-for-byte)
    shared = (list(map(int, rng.integers(0, spec.vocab_size,
                                         spec.prefix_tokens)))
              if spec.prefix_tokens else [])  # 0: do not advance the rng

    tenants = spec.tenants
    if spec.workload == "multi-tenant" and not tenants:
        tenants = default_tenants(spec)
    if tenants:
        shares = np.asarray([t.share for t in tenants], float)
        picks = rng.choice(len(tenants), size=n, p=shares / shares.sum())
        assigned: List[TenantClass] = [tenants[int(j)] for j in picks]
        prompts, outputs = [], []
        for t in assigned:
            p_hi = t.prompt_max or spec.prompt_max
            o_hi = t.output_max or spec.output_max
            plen = _sample_len(rng, spec.length_dist,
                               min(8, p_hi), p_hi)
            prompts.append(shared + list(map(int, rng.integers(
                0, spec.vocab_size, plen))))
            outputs.append(_sample_len(rng, spec.length_dist,
                                       min(8, o_hi), o_hi))
        tenant_names = [t.name for t in assigned]
        slos = [t.slo_ms if t.slo_ms is not None else spec.slo_ms
                for t in assigned]
    elif spec.length_dist == "uniform":
        # THE historical draw order (bench.measure_serving pre-loadgen):
        # one vectorized length draw, per-prompt token draws in request
        # order, one vectorized output draw — byte-identical by test pin
        prompts = [shared + list(map(int, rng.integers(
            0, spec.vocab_size, int(ln))))
            for ln in rng.integers(p_lo, spec.prompt_max + 1, n)]
        outputs = [int(ln) for ln in rng.integers(
            o_lo, spec.output_max + 1, n)]
        tenant_names = ["default"] * n
        slos = [spec.slo_ms] * n
    else:
        prompts = []
        for _ in range(n):
            plen = _sample_len(rng, spec.length_dist, p_lo,
                               spec.prompt_max)
            prompts.append(shared + list(map(int, rng.integers(
                0, spec.vocab_size, plen))))
        outputs = [_sample_len(rng, spec.length_dist, o_lo,
                               spec.output_max) for _ in range(n)]
        tenant_names = ["default"] * n
        slos = [spec.slo_ms] * n

    if spec.workload == "poisson":
        arrivals = np.cumsum(rng.exponential(1.0 / spec.rate_rps, n))
        arrivals[0] = 0.0
    elif spec.workload == "diurnal":
        arrivals = _diurnal_arrivals(rng, n, spec)
    else:                          # bursty and multi-tenant ride MMPP
        arrivals = _mmpp_arrivals(rng, n, spec)

    # multi-turn sessions: geometric run lengths per tenant, assigned in
    # arrival order so a session's turns are consecutive requests — the
    # affinity stream the router's sticky placement serves from one
    # replica's warm prefix/drafter state.  Mean 1 = no sessions (and
    # no rng draws: the default trace stays byte-identical).
    sessions: List[Optional[str]] = [None] * n
    per_tenant_mean = {t.name: t.session_len for t in tenants}
    state: dict = {}
    for i in range(n):
        mean = per_tenant_mean.get(tenant_names[i], spec.session_len)
        if mean <= 1:
            continue
        key = tenant_names[i]
        sid, left = state.get(key, (0, 0))
        if left == 0:
            sid += 1
            left = int(rng.geometric(1.0 / mean))
        sessions[i] = f"{key}:{sid}"
        state[key] = (sid, left - 1)

    # follow-up-turn draws come LAST (0 turns draws nothing, so every
    # pre-followup trace — including the pinned default — stays
    # byte-identical): per turn, n short suffix lengths + tokens, then
    # n exponential arrival gaps
    followup_suffixes: List[List[List[int]]] = []
    followup_gaps: List[np.ndarray] = []
    for _ in range(spec.followup_turns):
        lens = rng.integers(1, p_lo + 1, n)
        followup_suffixes.append(
            [list(map(int, rng.integers(0, spec.vocab_size, int(ln))))
             for ln in lens])
        followup_gaps.append(rng.exponential(1.0 / spec.rate_rps, n))

    return Trace(spec=spec, prompts=prompts, outputs=outputs,
                 arrivals=arrivals, tenants=tenant_names, slos_ms=slos,
                 sessions=sessions, followup_suffixes=followup_suffixes,
                 followup_gaps=followup_gaps)


def per_request_rows(trace: Trace, result: dict) -> List[dict]:
    """Join the trace's SLO/tenant metadata with a run result into the
    per-request rows ``metrics_writer.goodput_block`` aggregates.

    ``attained_ms`` is final-token emit time minus arrival on the run
    clock (``result["request_finish_s"]`` — engine.run/router.run), the
    whole-request latency a client experienced; None when the request
    never finished on this run.  A request MEETS its SLO iff it
    completed ``ok`` within its budget — the deadline sweep fails late
    work as ``deadline_exceeded``, and the attained-time check also
    catches a completion that slipped past its budget between sweeps."""
    finish = result.get("request_finish_s") or {}
    first = result.get("request_first_token_s") or {}
    statuses = result.get("statuses") or {}
    outputs = result.get("outputs") or {}
    # with tracing on the run result carries lifecycle spans
    # (serving/tracing) — join the phase attribution onto each row so
    # a per-tenant SLO miss can be read as queueing vs prefill vs
    # decode without opening the Chrome trace
    spans = (result.get("trace") or {}).get("spans") or {}
    rows = []
    for i in range(len(trace.prompts)):
        status = statuses.get(i, "missing")
        f = finish.get(i)
        attained = ((f - float(trace.arrivals[i])) * 1e3
                    if f is not None and status == "ok" else None)
        # time-to-first-token on the same clock — unlike attained_ms
        # it is kept for any request that streamed at least one token
        # (a deadline-failed request still made its client wait)
        t = first.get(i)
        ttft = ((t - float(trace.arrivals[i])) * 1e3
                if t is not None else None)
        row = {
            "tenant": trace.tenants[i],
            "status": status,
            "tokens": len(outputs.get(i, ())),
            "attained_ms": attained,
            "ttft_ms": ttft,
            "slo_ms": trace.slos_ms[i],
        }
        sp = spans.get(i)
        if sp is not None:
            row["queue_ms"] = sp["queue_s"] * 1e3
            row["prefill_ms"] = sp["prefill_s"] * 1e3
            row["decode_ms"] = sp["decode_s"] * 1e3
        rows.append(row)
    return rows
