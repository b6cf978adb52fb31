"""Host loop for the transformer families (BASELINE config 5), on one
device or over the ranks of a ``torch.distributed`` world laid out as
``config.mesh_shape`` (``data``, and for bert_base and gpt_base the
``model`` and ``seq`` axes).

Counterpart of ``mpi_tensorflow_tpu/train/mlm_loop.py``'s ``train_mlm``
for ``model`` ``"bert_base"`` (``BertMlm``), ``"moe_bert"``
(``models/moe.MoeBertMlm``: routed expert MLPs, the load-balance loss),
``"gpt_base"`` (``models/gpt.TrainableCausalLm``: the causal mask, the
next-token loss through the chunked CE) and ``"encdec_t5"``
(``models/encdec.EncDecLm``) on a ``data`` mesh of W ranks (W = 1
without a process group):

- the data: the synthetic MLM stream; the reversal pairs of
  ``synthetic.seq2seq_batches`` for the enc-dec family (``text_file``
  refused); or, with ``text_file``, its rows (``data/corpus``: masked
  for the MLM families, ``load_causal`` for the causal one; byte-level,
  or WordPiece with ``vocab_file``, whose size the model adopts), the
  trailing 10 % held out.  Every rank makes the whole of it from the
  seed; the global batch ``b = batch_size * W`` and the wraparound
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
  predicting token t + 1 (causal, on the stream's input tokens, as the
  reference trains it; enc-dec, on the target side);
- under ``model`` and ``seq`` axes (``models/bert.py``): the global
  batch is ``batch_size`` x the data axis' size, each data rank's rows
  as above, and each seq rank feeds its block of every row's positions
  (``seq_len`` must divide by the seq axis); the ranks of a model axis
  feed the same batch and draw the same dropout masks (the generator is
  keyed on the rank's index over ``data`` x ``seq``); the held-out
  argmax is taken over the whole vocabulary (``model.vocab_argmax``) and the
  predictions gathered by each rank's mesh coordinates;
- rank 0 prints (the reference's one process of a W-device mesh);
  ``tokens_per_sec = b*seq_len/sec`` with the global ``b``, and
  ``num_devices`` the mesh's size;
- checkpoints, resume and preemption at the reference's call sites
  (``train.ckpt_hooks``): a sharded checkpoint queued at each trace
  point (under zero1 and fsdp each rank writes its slices), ``resume``
  from the latest committed one, a stop at the step a signal lands in
  (one rank) or agreed at the next trace point (several).  Dropout is
  seeded by the step, so a resumed run repeats the uninterrupted one;
- with ``metrics_dir``, rank 0 writes ``eval/heldout_error_pct`` and
  ``train/loss`` at each trace point and ``perf/tokens_per_sec`` at the
  end;
- ``config.remat`` recomputes every layer in the backward (the default
  ``bert_cfg``'s; a given one keeps its own), and ``lr_schedule`` names
  the warmup schedule (``warmup_linear`` or ``warmup_cosine``) of adamw
  or lamb (``config.optimizer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import corpus, synthetic
from mpi_tensorflow_torch.models import bert, encdec, gpt, moe
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


def place_predictions(parts, mesh, bs: int, s_loc: int) -> np.ndarray:
    """Every rank's eval predictions laid out whole: ``parts`` (world,
    W, bs, s_loc) in rank order, as ``host_allgather`` returns them, into
    (W, bs * data, s_loc * seq), rank r's block at its coordinates on
    ``mesh`` (``np.unravel_index(r, sizes)``, ``make_mesh``'s layout).
    The ranks of a model axis hold the same ids; model coordinate 0's
    are read."""
    shape = dict(mesh)
    out = np.empty((parts.shape[1], bs * shape.get("data", 1),
                    s_loc * shape.get("seq", 1)), parts.dtype)
    for r, part in enumerate(parts):
        at = dict(zip(shape, np.unravel_index(r, tuple(shape.values()))))
        if at.get("model", 0) == 0:
            d, q = at.get("data", 0), at.get("seq", 0)
            out[:, d * bs:(d + 1) * bs, q * s_loc:(q + 1) * s_loc] = part
    return out


FAMILIES = {"bert_base": bert.BertMlm, "moe_bert": moe.MoeBertMlm,
            "gpt_base": gpt.TrainableCausalLm, "encdec_t5": encdec.EncDecLm}


def load_data(config: Config, bert_cfg: bert.BertConfig, seq_len: int,
              train_n: int, test_n: int):
    """``(bert_cfg, train, test)``: each split a dict of ``inputs``
    (the tokens, or the enc-dec family's sources), ``targets`` and
    ``mask`` (None for the enc-dec family, whose every target position
    carries loss); ``bert_cfg`` takes a WordPiece vocabulary's size."""
    def split(inputs, targets, mask):
        return {"inputs": inputs, "targets": targets, "mask": mask}

    if config.model == "encdec_t5":
        if config.text_file:
            raise ValueError(
                "--text-file is a single-stream input; the encoder-decoder "
                "family trains on (src, tgt) pairs (synthetic reversal "
                "task)")
        # tgt = BOS + reverse(src): the decoder must read the encoder
        pairs = [synthetic.seq2seq_batches(
            n, src_len=seq_len, tgt_len=seq_len,
            vocab_size=bert_cfg.vocab_size, seed=seed)
            for n, seed in ((train_n, config.seed), (test_n, config.seed + 1))]
        return bert_cfg, *(split(s, t, None) for s, t in pairs)
    if not config.text_file:
        return bert_cfg, *(split(*synthetic.mlm_batches(
            n, seq_len=seq_len, vocab_size=bert_cfg.vocab_size, seed=seed))
            for n, seed in ((train_n, config.seed),
                            (test_n, config.seed + 1)))
    vocab = None
    if config.vocab_file:
        vocab = corpus.WordPieceVocab.from_file(config.vocab_file)
        bert_cfg = dataclasses.replace(bert_cfg, vocab_size=vocab.size)
    if config.model == "gpt_base":
        rows = corpus.load_causal(config.text_file, seq_len=seq_len,
                                  vocab_file=vocab)
        inp, tgt, msk = rows, rows, np.ones(rows.shape, bool)
    else:
        inp, tgt, msk = corpus.load_mlm(config.text_file, seq_len=seq_len,
                                        seed=config.seed, vocab_file=vocab)
    n_test = max(len(inp) // 10, 1)
    n = len(inp) - n_test
    return (bert_cfg, split(inp[:n], tgt[:n], msk[:n]),
            split(inp[n:], tgt[n:], msk[n:]))


def train_mlm(config: Config, bert_cfg: Optional[bert.BertConfig] = None,
              seq_len: int = 128, train_n: int = 4096, test_n: int = 512,
              learning_rate: float = 1e-4,
              lr_schedule: str = "warmup_linear", verbose: bool = True,
              device="cuda") -> MlmResult:
    """Train ``config.model``'s family (``FAMILIES``; weights drawn from
    ``config.seed``) on ``device`` (``cuda`` unless the caller asks for
    the CPU), over every rank of the process group that is up.
    ``bert_cfg`` defaults to ``BERT_BASE`` in the config's compute dtype
    with ``config.remat``, with 512 positions as the reference's
    default: pass a config with ``max_positions >= seq_len`` for longer
    sequences."""
    if config.model not in FAMILIES:
        raise ValueError(f"train_mlm trains the transformer families, got "
                         f"model {config.model!r}")
    mesh = meshlib.make_mesh(config.mesh_shape)
    ndev = meshlib.process_count()
    world, rank = mesh.axis_size("data"), mesh.axis_index("data")
    n_seq = mesh.axis_size("seq")
    if seq_len % n_seq:
        raise ValueError(f"seq_len {seq_len} does not split evenly over the "
                         f"{n_seq} ranks of the seq axis (mesh {dict(mesh)})")
    s_loc = seq_len // n_seq
    cols = slice(mesh.axis_index("seq") * s_loc,
                 (mesh.axis_index("seq") + 1) * s_loc)
    # the ranks of a model axis draw the same dropout masks
    drop_rank = mesh.group("data", "seq").index
    say = verbose and meshlib.process_index() == 0
    dev = resolve_device(device)
    if bert_cfg is None:
        bert_cfg = dataclasses.replace(bert.BERT_BASE,
                                       dtype=config.compute_dtype,
                                       remat=config.remat)
    bert_cfg, train, test = load_data(config, bert_cfg, seq_len, train_n,
                                      test_n)
    train_n, test_n = len(train["inputs"]), len(test["inputs"])
    enc_dec = config.model == "encdec_t5"

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
    model = FAMILIES[config.model].from_seed(bert_cfg, config.seed,
                                             mesh=mesh).to(dev)
    state = gspmd.init_for(config.param_sharding, model, tx)
    train_step = gspmd.make_train_step(tx, grad_accum=accum)
    eval_step = gspmd.make_eval_step()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def batch_of(split, rows):
        """The model's input dict for ``rows`` of a split (this rank's
        block of their positions)."""
        if enc_dec:
            return {"src": put(split["inputs"][rows]),
                    "tgt": put(split["targets"][rows])}
        return {"tokens": put(split["inputs"][rows][:, cols]),
                "mask": put(split["mask"][rows][:, cols])}

    def masked_error() -> float:
        windows = list(eval_windows(test_n, b))
        # this rank's rows (and positions) of each window, then one
        # gather of every rank's, laid out by its mesh coordinates
        preds = []
        for idx, _ in windows:
            own = idx[rank * bs:(rank + 1) * bs]
            inputs = batch_of(test, own) if enc_dec \
                else put(test["inputs"][own][:, cols])
            preds.append(state.model.vocab_argmax(
                eval_step(state, inputs)).cpu().numpy())
        preds = np.stack(preds)
        if ndev > 1:
            preds = place_predictions(collectives.host_allgather(preds),
                                      mesh, bs, s_loc)
        errs, tot = 0, 0
        for (idx, take), pred in zip(windows, preds.reshape(
                len(windows), b, seq_len)):
            real = idx[:take]
            if causal or enc_dec:
                # position t predicts token t + 1 of the sequence (the
                # enc-dec family's target side)
                tgt = test["targets" if enc_dec else "inputs"][real]
                errs += int((pred[:take, :-1] != tgt[:, 1:]).sum())
                tot += tgt[:, 1:].size
                continue
            m = test["mask"][real]
            errs += int(((pred[:take] != test["targets"][real]) & m).sum())
            tot += int(m.sum())
        return 100.0 * errs / max(tot, 1)

    timer = StepTimer(warmup_steps=1, device=dev)
    history = []
    pending = 0
    metrics = {}
    hooks = CheckpointHooks(config.checkpoint_dir, verbose=verbose,
                            device=dev)
    mw = metrics_writer.for_process(config.metrics_dir,
                                    meshlib.process_index())
    try:
        start_step = 0
        if config.resume:
            state, start_step = hooks.resume(state)
        if say:
            logs.session_start(0)
        timer.start()
        for t in range(start_step, num_steps):
            rows = rank_rows(window(t, b, train_n), b, accum, rank, world)
            batch = batch_of(train, rows)
            gens = ([gspmd.step_generator(config.seed + 2, t, dev, drop_rank,
                                          i)
                     for i in range(accum)] if bert_cfg.dropout > 0.0
                    else None)
            state, metrics = train_step(state, batch,
                                        put(train["targets"][rows][:, cols]),
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
        logs.timing_summary(tps, sec * 1e3, ndev)
    return MlmResult(state=state, history=history, final_error=final_err,
                     final_loss=float(metrics["loss"]) if metrics
                     else float("nan"), tokens_per_sec=tps,
                     step_time_seconds=sec, num_devices=ndev,
                     num_steps=num_steps)
