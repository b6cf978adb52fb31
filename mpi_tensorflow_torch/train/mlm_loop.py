"""Host loop for the transformer families (BASELINE config 5), on one
device or data-parallel over the ranks of a ``torch.distributed`` world.

Counterpart of ``mpi_tensorflow_tpu/train/mlm_loop.py``'s ``train_mlm``
for ``model`` ``"bert_base"`` (``BertMlm``) and ``"gpt_base"``
(``models/gpt.TrainableCausalLm``: the causal mask, the next-token loss
through the chunked CE) on a ``data`` mesh of W ranks (W = 1 without a
process group):

- the synthetic MLM stream (every rank makes the whole of it from the
  seed), the global batch ``b = batch_size * W`` and the wraparound
  window ``lo = (t*b) % max(train_n - b, 1)`` over it; rank r feeds its
  rows of each of the ``grad_accum`` global microbatches
  (``rank_rows``), and the step (``train.gspmd``, in the layout of
  ``param_sharding``) reduces over the ranks;
- the reference's checks: zero1/fsdp without a data axis larger than 1
  raise, as does a global batch that does not split into ``grad_accum``
  microbatches; the port also needs each microbatch to split evenly
  over the ranks (GSPMD would re-lay an uneven one out);
- the held-out error trace at the log cadence, its window of the
  global ``b`` capped at 4 batches, off the timed path: each rank
  predicts its ``batch_size`` rows of every window, then one host
  gather, and the error is counted over the window's real rows as the
  reference counts it: at the masked positions (MLM), or of position t
  predicting token t + 1 (causal; the causal family trains on the
  stream's input tokens, as the reference's does);
- rank 0 prints (the reference's one process of a W-device mesh);
  ``tokens_per_sec = b*seq_len/sec`` with the global ``b``, and
  ``num_devices = W``;
- checkpoints, resume and preemption at the reference's call sites
  (``train.ckpt_hooks``): a sharded checkpoint queued at each trace
  point (under zero1 and fsdp each rank writes its slices), ``resume``
  from the latest committed one, a stop at the step a signal lands in
  (one rank) or agreed at the next trace point (several).  Dropout is
  seeded by the step, so a resumed run repeats the uninterrupted one;
- with ``metrics_dir``, rank 0 writes ``eval/heldout_error_pct`` and
  ``train/loss`` at each trace point and ``perf/tokens_per_sec`` at the
  end.

The MoE and encoder-decoder families are not ported yet (ROADMAP
Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import bert, gpt
from mpi_tensorflow_torch.parallel import collectives, mesh as meshlib
from mpi_tensorflow_torch.train import gspmd
from mpi_tensorflow_torch.train import optimizer as opt_lib
from mpi_tensorflow_torch.train.ckpt_hooks import CheckpointHooks
from mpi_tensorflow_torch.utils import logging as logs
from mpi_tensorflow_torch.utils import metrics_writer
from mpi_tensorflow_torch.utils.device import resolve_device
from mpi_tensorflow_torch.utils.profiling import StepTimer


@dataclasses.dataclass
class MlmResult:
    state: Any
    history: list              # [(step, masked error %)]
    final_error: float
    final_loss: float          # the last train step's loss
    tokens_per_sec: float
    step_time_seconds: float
    num_devices: int
    num_steps: int


def window(t: int, b: int, train_n: int) -> int:
    """First row of train step ``t``'s batch: the reference's wraparound
    window over the train split."""
    return (t * b) % max(train_n - b, 1)


def rank_rows(lo: int, b: int, accum: int, rank: int,
              world: int) -> np.ndarray:
    """The train rows rank ``rank`` of ``world`` feeds for the global
    window ``[lo, lo + b)``: global microbatch i is rows ``[lo + i*b/A,
    lo + (i+1)*b/A)`` (A = ``accum``), spread over the ranks in rank
    order, and the rank's rows of each follow one another, microbatches
    in order."""
    m = b // accum
    per = m // world
    return (lo + np.arange(accum)[:, None] * m + rank * per
            + np.arange(per)[None, :]).reshape(-1)


def eval_windows(test_n: int, b: int):
    """``(row indices (b,), rows that count)`` over the sampled test
    window, capped at 4 batches; a partial tail wrap-pads to b rows."""
    n = min(test_n, 4 * b)
    for i in range(0, n, b):
        take = min(b, n - i)
        yield np.resize(np.arange(i, i + take), b), take


def train_mlm(config: Config, bert_cfg: Optional[bert.BertConfig] = None,
              seq_len: int = 128, train_n: int = 4096, test_n: int = 512,
              learning_rate: float = 1e-4,
              lr_schedule: str = "warmup_linear", verbose: bool = True,
              device="cuda") -> MlmResult:
    """Train ``BertMlm`` (``gpt_base``: ``TrainableCausalLm``; weights
    drawn from ``config.seed``) on the synthetic MLM stream on ``device`` (``cuda`` unless the caller asks
    for the CPU), over every rank of the process group that is up.
    ``bert_cfg`` defaults to ``BERT_BASE`` in the config's compute
    dtype, with 512 positions as the reference's default: pass a config
    with ``max_positions >= seq_len`` for longer sequences."""
    if config.model in ("moe_bert", "encdec_t5"):
        raise NotImplementedError(
            f"model {config.model!r} is not ported yet: ROADMAP Queue 1 "
            f"item 13")
    if config.model not in ("bert_base", "gpt_base"):
        raise ValueError(f"train_mlm trains the transformer families, got "
                         f"model {config.model!r}")
    world = meshlib.data_axis_size(meshlib.make_mesh(config.mesh_shape))
    rank = meshlib.process_index()
    say = verbose and rank == 0
    dev = resolve_device(device)
    if bert_cfg is None:
        bert_cfg = dataclasses.replace(bert.BERT_BASE,
                                       dtype=config.compute_dtype)

    tokens, targets, mask = synthetic.mlm_batches(
        train_n, seq_len=seq_len, vocab_size=bert_cfg.vocab_size,
        seed=config.seed)
    ts_tokens, ts_targets, ts_mask = synthetic.mlm_batches(
        test_n, seq_len=seq_len, vocab_size=bert_cfg.vocab_size,
        seed=config.seed + 1)

    bs = config.batch_size
    b = bs * world
    num_steps = config.epochs * (train_n // b)
    if num_steps == 0:
        raise ValueError(
            f"train split ({train_n} sequences) is smaller than one global "
            f"batch ({b}); lower --batch-size or provide more data")
    accum = config.grad_accum
    if b % accum:
        raise ValueError(f"batch dim {b} not divisible by grad_accum "
                         f"{accum}")
    if bs % accum:
        raise ValueError(
            f"a microbatch of {b // accum} rows does not split evenly over "
            f"{world} ranks: --batch-size {bs} must be divisible by "
            f"--grad-accum {accum}")

    tx = opt_lib.transformer_tx(learning_rate, num_steps,
                                schedule=lr_schedule,
                                optimizer=config.optimizer)
    causal = config.model == "gpt_base"
    family = gpt.TrainableCausalLm if causal else bert.BertMlm
    model = family.from_seed(bert_cfg, config.seed).to(dev)
    state = gspmd.init_for(config.param_sharding, model, tx)
    train_step = gspmd.make_train_step(tx, grad_accum=accum)
    eval_step = gspmd.make_eval_step()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def masked_error() -> float:
        windows = list(eval_windows(test_n, b))
        # this rank's rows of each window, then one gather
        preds = np.stack([eval_step(state, put(
            ts_tokens[idx[rank * bs:(rank + 1) * bs]])).argmax(-1).cpu()
            .numpy() for idx, _ in windows])
        if world > 1:
            preds = collectives.host_allgather(preds).transpose(1, 0, 2, 3)
        errs, tot = 0, 0
        for (idx, take), pred in zip(windows, preds.reshape(
                len(windows), b, seq_len)):
            real = idx[:take]
            if causal:
                tgt = ts_tokens[real]
                errs += int((pred[:take, :-1] != tgt[:, 1:]).sum())
                tot += tgt[:, 1:].size
                continue
            m = ts_mask[real]
            errs += int(((pred[:take] != ts_targets[real]) & m).sum())
            tot += int(m.sum())
        return 100.0 * errs / max(tot, 1)

    timer = StepTimer(warmup_steps=1, device=dev)
    history = []
    pending = 0
    metrics = {}
    hooks = CheckpointHooks(config.checkpoint_dir, verbose=verbose,
                            device=dev)
    mw = metrics_writer.for_process(config.metrics_dir, rank)
    try:
        start_step = 0
        if config.resume:
            state, start_step = hooks.resume(state)
        if say:
            logs.session_start(0)
        timer.start()
        for t in range(start_step, num_steps):
            rows = rank_rows(window(t, b, train_n), b, accum, rank, world)
            batch = {"tokens": put(tokens[rows]), "mask": put(mask[rows])}
            gens = ([gspmd.step_generator(config.seed + 2, t, dev, rank, i)
                     for i in range(accum)] if bert_cfg.dropout > 0.0
                    else None)
            state, metrics = train_step(state, batch, put(targets[rows]),
                                        gens)
            pending += 1
            if hooks.stop_now(t):
                hooks.preempt_save(state, t)
                break
            last = t == num_steps - 1
            if (t > 0 and t % config.log_every == 0) or last:
                timer.stop(pending)
                pending = 0
                err = masked_error()
                history.append((t, err))
                mw.scalar("eval/heldout_error_pct", err, t)
                mw.scalar("train/loss", float(metrics["loss"]), t)
                if say:
                    logs.step_trace(0, t, err)
                hooks.save_async(state, t)
                if not last and hooks.stop_agreed(t):
                    hooks.preempt_save(state, t, already_queued=True)
                    break
                timer.start()
        sec = timer.mean_step_seconds
        tps = b * seq_len / sec if sec == sec and sec > 0 else float("nan")
        if tps == tps:
            mw.scalar("perf/tokens_per_sec", tps, num_steps)
    finally:
        hooks.close()
        mw.close()
    final_err = history[-1][1] if history else float("nan")
    if say:
        logs.timing_summary(tps, sec * 1e3, world)
    return MlmResult(state=state, history=history, final_error=final_err,
                     final_loss=float(metrics["loss"]) if metrics
                     else float("nan"), tokens_per_sec=tps,
                     step_time_seconds=sec, num_devices=world,
                     num_steps=num_steps)
