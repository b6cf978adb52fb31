"""Host loop for the masked-LM family (BASELINE config 5) on one device.

Counterpart of ``mpi_tensorflow_tpu/train/mlm_loop.py``'s ``train_mlm``
for ``model == "bert_base"``: the synthetic MLM stream, the wraparound
batch window ``lo = (t*b) % max(train_n - b, 1)``, the held-out
masked-error trace at the log cadence (its window capped at 4 batches,
off the timed path), and ``tokens_per_sec = b*seq_len/sec``.  The other
transformer families, checkpointing and the metrics sink are not ported
yet (ROADMAP Queue 1 items 13 and 15).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import bert
from mpi_tensorflow_torch.train import gspmd
from mpi_tensorflow_torch.train import optimizer as opt_lib
from mpi_tensorflow_torch.utils import logging as logs
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
    """Train ``BertMlm`` (weights drawn from ``config.seed``) on the
    synthetic MLM stream on one device (``cuda`` unless the caller asks
    for the CPU).  ``bert_cfg`` defaults to ``BERT_BASE`` in the
    config's compute dtype, with 512 positions as the reference's
    default: pass a config with ``max_positions >= seq_len`` for longer
    sequences."""
    if config.model in ("moe_bert", "gpt_base", "encdec_t5"):
        raise NotImplementedError(
            f"model {config.model!r} is not ported yet: ROADMAP Queue 1 "
            f"item 13")
    if config.model != "bert_base":
        raise ValueError(f"train_mlm trains the transformer families, got "
                         f"model {config.model!r}")
    dev = resolve_device(device)
    if bert_cfg is None:
        bert_cfg = dataclasses.replace(bert.BERT_BASE,
                                       dtype=config.compute_dtype)
    model = bert.BertMlm.from_seed(bert_cfg, config.seed).to(dev)

    tokens, targets, mask = synthetic.mlm_batches(
        train_n, seq_len=seq_len, vocab_size=bert_cfg.vocab_size,
        seed=config.seed)
    ts_tokens, ts_targets, ts_mask = synthetic.mlm_batches(
        test_n, seq_len=seq_len, vocab_size=bert_cfg.vocab_size,
        seed=config.seed + 1)

    b = config.batch_size
    num_steps = config.epochs * (train_n // b)
    if num_steps == 0:
        raise ValueError(
            f"train split ({train_n} sequences) is smaller than one global "
            f"batch ({b}); lower --batch-size or provide more data")

    tx = opt_lib.transformer_tx(learning_rate, num_steps,
                                schedule=lr_schedule,
                                optimizer=config.optimizer)
    state = gspmd.init_state(model, tx)
    train_step = gspmd.make_train_step(tx)
    eval_step = gspmd.make_eval_step()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def masked_error() -> float:
        errs, tot = 0, 0
        for idx, take in eval_windows(test_n, b):
            pred = eval_step(state, put(ts_tokens[idx])).argmax(-1)
            pred = pred[:take].cpu().numpy()
            real = idx[:take]
            m = ts_mask[real]
            errs += int(((pred != ts_targets[real]) & m).sum())
            tot += int(m.sum())
        return 100.0 * errs / max(tot, 1)

    timer = StepTimer(warmup_steps=1, device=dev)
    history = []
    if verbose:
        logs.session_start(0)
    pending = 0
    metrics = {}
    timer.start()
    for t in range(num_steps):
        lo = window(t, b, train_n)
        batch = {"tokens": put(tokens[lo:lo + b]),
                 "mask": put(mask[lo:lo + b])}
        gen = (gspmd.step_generator(config.seed + 2, t, dev)
               if bert_cfg.dropout > 0.0 else None)
        state, metrics = train_step(state, batch, put(targets[lo:lo + b]),
                                    gen)
        pending += 1
        last = t == num_steps - 1
        if (t > 0 and t % config.log_every == 0) or last:
            timer.stop(pending)
            pending = 0
            err = masked_error()
            history.append((t, err))
            if verbose:
                logs.step_trace(0, t, err)
            timer.start()
    final_err = history[-1][1] if history else float("nan")
    sec = timer.mean_step_seconds
    tps = b * seq_len / sec if sec == sec and sec > 0 else float("nan")
    if verbose:
        logs.timing_summary(tps, sec * 1e3, 1)
    return MlmResult(state=state, history=history, final_error=final_err,
                     final_loss=float(metrics["loss"]), tokens_per_sec=tps,
                     step_time_seconds=sec, num_devices=1,
                     num_steps=num_steps)
