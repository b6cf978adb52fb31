"""The port's benchmark: ``python -m mpi_tensorflow_torch.bench``.

``--mode train``: the counterpart of the one-step arm of ``bench.py
--mode train`` (the JAX package's bench): the train step of an image
model at a per-card batch, on random-normal x 0.3 batches with random
labels in 4 rotating banks (so steps do not alias one input), the LR
schedule's ``decay_steps`` at 50000, the CNN's dropout on.  The input
geometry, classes and defaults are the JAX bench's ``MODEL_SPECS``
(``IMAGE_SPECS``): ``mnist_cnn`` 64 x 28x28x1, 10 classes; ``resnet20``
128 x 32x32x3, 10 classes; ``resnet50`` 32 x 224x224x3, 1000 classes;
``vit`` (ViT-Tiny, 4 px patches, dropout on) 128 x 32x32x3, 10 classes,
its flops ``utils/flops.image_train_flops`` of its configuration.
``--warmup`` steps run first and are not timed; the card is
synchronised before and after the ``--steps`` timed steps.  Prints one
JSON line: images/sec (and per card), step ms, model-FLOP utilisation
against the card's peak for the precision (``utils/flops.py``), the
card's peak allocated GiB, and the card's name and power limit.

    python -m mpi_tensorflow_torch.bench --mode train
    python -m mpi_tensorflow_torch.bench --mode train --precision bf16
    python -m mpi_tensorflow_torch.bench --mode train --model resnet50 \\
        --precision bf16
    python -m mpi_tensorflow_torch.bench --mode train --model vit \\
        [--precision bf16]
    python -m mpi_tensorflow_torch.bench --mode train --device cpu \\
        --steps 20 --warmup 2

``--mode allreduce``: the counterpart of ``bench.py --mode allreduce``,
BASELINE's "allreduce step-time": a float32 payload of ``--payload-mb``
MB (default 25.4) on each rank, ``chain`` = 32 data-dependent
``all_reduce(SUM)`` calls, each followed by a rescale by 1/W, timed
between two synchronisations of the card; the median over ``dispatches``
= 7 chains, divided by the chain.  Under ``torchrun`` it runs over the
launched world (one rank per card); without a launcher it makes a world
of one on a free localhost port, where NCCL times its launch and a copy
on the card, not a link.  Prints one JSON line (``allreduce_ms``,
``algbw_gbps`` = payload / time, the world size, the backend and the
card's line):

    python -m mpi_tensorflow_torch.bench --mode allreduce
    torchrun --nproc_per_node 4 -m mpi_tensorflow_torch.bench \\
        --mode allreduce

``--mode train --model bert_base`` (or ``gpt_base``, ``moe_bert``,
``encdec_t5``): the counterpart of the one-step arm of the reference's
``measure_bert``: the BERT-base MLM train step (``gpt_base``: the causal
LM's next-token step, the causal flash kernels at ``--seq-len 4096`` and
the chunked CE; ``moe_bert``: routed experts on every other layer, its
flops the dense formula's, one expert of the dense width a token;
``encdec_t5``: the encoder-decoder on the reversal pairs, source and
target both ``--seq-len`` long; ``--remat`` with ``--remat-policy
full|dots`` recomputes each layer in the backward)
(``train.gspmd``, adamw through ``transformer_tx`` at a constant 1e-4,
dropout 0.1) at ``--batch-size`` sequences per card of ``--seq-len``
tokens (``max_positions`` raised to it), ``--grad-accum`` microbatches
and the ``--param-sharding`` layout, on the synthetic MLM stream in 4
rotating banks of the global batch, each rank feeding its rows.  Under
``torchrun`` it runs over the launched world; without a launcher on one
card with no process group.  The mean over ``--steps`` timed steps
(default 20, after 3 untimed) between two synchronisations of rank 0's
card; prints one JSON line from rank 0: tokens/sec per card, step ms,
MFU (``utils/flops.py``, the per-card batch; ``mfu_bf16`` against the
bf16 peak whatever the precision), the card's peak allocated GiB and
this rank's bytes at rest, the remat policy, the world size, and the
card's line.  The reference bench's levers, each with its checks:
``--fused-qkv`` (q, k, v from one stacked product a layer),
``--params-bf16`` (bfloat16 live parameters with float32 masters in the
optimizer; needs ``--precision bf16``, and refused beside
``--param-sharding zero1|fsdp``, which slice the masters' leaves),
``--ce auto|dense|chunked`` with ``--ce-chunk`` (the loss's CE over the
vocabulary) and ``--flash-min-seq`` (the length at which the card takes
the flash kernels; 0: always); the line carries ``ce_impl``,
``ce_chunk``, ``params_bf16``, ``fused_qkv`` and ``flash_min_seq``.
The reference's bench runs ``optax.adamw(1e-4)`` without clipping; the
port's runs the trainer's optimizer, one global norm more a step, in
every arm (the masters of ``--params-bf16`` are clipped alike):

    python -m mpi_tensorflow_torch.bench --mode train --model bert_base \\
        --seq-len 4096 --batch-size 4 --precision bf16
    python -m mpi_tensorflow_torch.bench --mode train --model gpt_base \\
        --seq-len 4096 --batch-size 4 --precision bf16
    python -m mpi_tensorflow_torch.bench --mode train --model encdec_t5 \\
        --seq-len 4096 --batch-size 4 --precision bf16 --remat \\
        [--remat-policy dots]
    python -m mpi_tensorflow_torch.bench --mode train --model bert_base \\
        --seq-len 4096 --batch-size 4 --precision bf16 [--fused-qkv] \\
        [--params-bf16] [--ce chunked] [--flash-min-seq 0]
    torchrun --nproc_per_node 4 -m mpi_tensorflow_torch.bench --mode train \\
        --model bert_base --seq-len 4096 --batch-size 4 --precision bf16 \\
        [--grad-accum 2] [--param-sharding zero1|fsdp]

``--mode hostio``: the counterpart of ``bench.py --mode hostio``: the
host's window assembly alone, for ResNet-50-shaped rows (224x224x3
float32) in a memory-mapped ``.npy`` written under ``--hostio-dir``
(the ``imagenet_npy`` storage format; removed after), through the
inline gather (``prefetch.assemble_window``) and the background thread
(``ThreadPrefetcher``, timed from its construction, since it starts
assembling there): sustained images/sec each, the page cache warm (one
inline pass first).  The native arm (the C++ worker) prints ``null``
and names ROADMAP Queue 1 item 15c.  The rate to beat is the card's:
``--demand-images-per-sec`` takes the ResNet-50 trainer's images/sec
measured on this card in the same run (``chip_smoke.py`` phase 14a
passes it); without it, and on the CPU, the demand and the headroom are
``null``:

    python -m mpi_tensorflow_torch.bench --mode hostio --device cpu
    python -m mpi_tensorflow_torch.bench --mode hostio \\
        --demand-images-per-sec 880 --batch-size 64 --window-k 11

``--mode serving``: the counterpart of ``bench.py --mode serving``
(``measure_serving``), with the flags of ``python -m
mpi_tensorflow_torch.serving`` and the same implementation
(``serving/harness.measure_serving``): the timed engine arm, and the
fleet (``--serve-replicas N``, with ``--serve-fault-*``), prefix-route,
journaled (``--serve-journal``) and traced (``--serve-trace on``) arms.
Prints the reference's metric line, the harness's dict as its
``detail``:

    python -m mpi_tensorflow_torch.bench --mode serving --serve-tiny \
        --device cpu --requests 4 --prompt-len 8 --new-tokens 8 \
        --arrival-rate 1000 --serve-replicas 2 --serve-fault-replica 0 \
        --serve-fault-step 3

The static-batch arm (``generate`` on arrival-order groups,
``speedup_vs_static``) and the A/B arms (``--serve-kernel-ab``,
``--serve-kv-ab``, ``--serve-spec-ab``, ``--serve-mixed-ab``) run as the
reference's do.

``--mode decode``: the counterpart of ``bench.py --mode decode``
(``measure_decode``): ``CausalLm.generate`` (greedy) or, with
``--num-beams K``, ``beam_search`` at ``BERT_BASE`` widths, random
weights from seed 0, ``--batch-size`` 8 prompts of ``--prompt-len`` 32
tokens.  The per-token time is the slope between two lengths,
``n_short = max(8, new_tokens // 8)`` and ``n_short + --new-tokens``
(128), both on one cache capacity, each the median of ``--steps`` (5)
timed calls after one untimed; tokens/sec counts the batch's tokens
(the beams are the search's price).  ``roofline_min_per_token_ms`` is
the weights a decode step reads over the card's 3.35 TB/s (0 off the
card), and a slope at or below it is flagged ``timing_degenerate``:

    python -m mpi_tensorflow_torch.bench --mode decode [--num-beams 4]
    python -m mpi_tensorflow_torch.bench --mode decode --device cpu \\
        --batch-size 2 --prompt-len 8 --new-tokens 8 --steps 1

``--scan-steps K`` (train mode): the reference's scanned arm, K train
steps a dispatch, the default its ``MODEL_SPECS`` K per model
(``mnist_cnn`` 400, ``resnet20`` 50, ``resnet50`` 8, ``vit`` 20, each
transformer family 4), capped at ``min(K, steps)``: the K steps of
``step.make_multi_train_step`` (``gspmd.make_multi_step``) over K
batches staged on the device (the banks in turn), which on the card
are one CUDA graph replay (``train.graphs``).  The time is the
reference's: the median over ``max(1, steps // K)`` dispatches, each
closed by a synchronisation and the last loss read, after ``max(1,
warmup // K) + 1`` untimed ones (the first captures the graph), divided
by K; the line's ``scan_steps`` is K, its ``steps`` the timed steps.
``--scan-steps 0`` times the one-step arm above (``scan_steps`` 0).
``--mode allreduce`` runs its chain of 32 as one graph replay on the
card (``graph_replay``), as the reference runs it in one dispatch.
``--mode decode`` times ``generate`` and ``beam_search``, one graph
replay a call on the card (``models/gpt.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.parallel import collectives, mesh as meshlib
from mpi_tensorflow_torch.train import graphs as graphs_lib
from mpi_tensorflow_torch.train import gspmd, loop, mlm_loop
from mpi_tensorflow_torch.train import optimizer as opt_lib
from mpi_tensorflow_torch.train import step as step_lib
from mpi_tensorflow_torch.train.gspmd import step_generator
from mpi_tensorflow_torch.utils import flops
from mpi_tensorflow_torch.utils.device import (card_line, device_name,
                                               resolve_device)

N_BANKS = 4
# per image model: the input (H, W, C), the classes, the defaults of
# --batch-size, --steps and --warmup, and the reference's scan window
IMAGE_SPECS = {
    "mnist_cnn": dict(shape=(28, 28, 1), classes=10, defaults=(64, 1000, 50),
                      scan=400),
    "resnet20": dict(shape=(32, 32, 3), classes=10, defaults=(128, 500, 20),
                     scan=50),
    "resnet50": dict(shape=(224, 224, 3), classes=1000,
                     defaults=(32, 48, 5), scan=8),
    "vit": dict(shape=(32, 32, 3), classes=10, defaults=(128, 200, 20),
                dataset="cifar10", scan=20),
}
TRANSFORMER_SCAN = 4            # the reference's K for every family


def scan_width(scan_steps: Optional[int], default: int, steps: int) -> int:
    """K for ``--scan-steps`` (None: the model's default), capped at the
    requested steps; 0 is the one-step arm."""
    k = default if scan_steps is None else int(scan_steps)
    if k < 0:
        raise ValueError(f"--scan-steps must be >= 0, got {k}")
    return min(k, steps)


def time_scanned(multi, steps: int, warmup: int, K: int, sync) -> tuple:
    """The reference's ``_measure_scanned``: ``(seconds a step, the last
    loss)``, the median over ``max(1, steps // K)`` calls of ``multi() ->
    losses (K,)``, each closed by ``sync`` and the last loss read, after
    ``max(1, warmup // K) + 1`` untimed ones."""
    for _ in range(max(1, warmup // K) + 1):
        float(multi()[-1])
    times = []
    for _ in range(max(1, steps // K)):
        t0 = time.perf_counter()
        last = multi()[-1]
        sync()
        loss = float(last)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] / K, loss


def measure_train(model_name: str = "mnist_cnn", batch_size: int = 64,
                  precision: str = "fp32", steps: int = 1000,
                  warmup: int = 50, device="cuda",
                  remat: bool = False,
                  scan_steps: Optional[int] = None) -> dict:
    """Mean time of one train step after ``warmup`` untimed ones, or with
    ``scan_steps`` K > 0 (default the model's K) the scanned arm's time
    (module note)."""
    spec = IMAGE_SPECS[model_name]
    cfg = Config(model=model_name, batch_size=batch_size,
                 precision=precision, num_classes=spec["classes"],
                 image_size=spec["shape"][0],
                 dataset=spec.get("dataset", "mnist"), remat=remat)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.empty(0, device=dev)      # the allocator up, for its stats
        torch.cuda.reset_peak_memory_stats(dev)
    model = loop.build_model(cfg).to(dev)
    state = step_lib.init_state(model)
    train_step = step_lib.make_train_step(model, cfg, 1, decay_steps=50000)
    rng = np.random.default_rng(0)
    shape = (batch_size, *spec["shape"])
    batches = [torch.from_numpy(
        (rng.normal(size=shape) * 0.3).astype(np.float32)).to(dev)
        for _ in range(N_BANKS)]
    labels = [torch.from_numpy(rng.integers(
        0, cfg.num_classes, size=batch_size).astype(np.int64)).to(dev)
        for _ in range(N_BANKS)]
    dropout = getattr(model, "dropout_rate", 0.0) > 0.0
    K = scan_width(scan_steps, spec["scan"], steps)

    def run(i):
        gen = step_generator(cfg.seed + 1, i, dev) if dropout else None
        return train_step(state, batches[i % N_BANKS], labels[i % N_BANKS],
                          gen)[1]["loss"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if K > 0:
        calls = max(1, warmup // K) + 1 + max(1, steps // K)
        multi = step_lib.make_multi_train_step(model, cfg, 1, 50000,
                                               horizon=calls * K)
        xs = torch.stack([batches[i % N_BANKS] for i in range(K)])
        ys = torch.stack([labels[i % N_BANKS] for i in range(K)])

        def scanned():
            return multi(state, xs, ys)[1]["loss"]
        sec, loss = time_scanned(scanned, steps, warmup, K, sync)
        steps = max(1, steps // K) * K
    else:
        for i in range(warmup):
            run(i)
        sync()
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            loss = run(i)
        sync()
        sec = (time.perf_counter() - t0) / steps
    step_flops = flops.image_train_flops(model_name, batch_size,
                                         getattr(model, "cfg", None))
    mfu = (flops.mfu(step_flops, sec, precision)
           if step_flops and dev.type == "cuda" else None)
    return {
        "mode": "train", "model": model_name,
        "images_per_sec": batch_size / sec,
        "images_per_sec_per_chip": batch_size / sec,
        "step_time_ms": sec * 1e3,
        "model_flops_per_step": step_flops,
        "mfu_pct": None if mfu is None else 100.0 * mfu,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None),
        "num_devices": 1, "batch_size_per_chip": batch_size,
        "image_shape": list(spec["shape"]), "num_classes": cfg.num_classes,
        "precision": precision, "remat": remat, "steps": steps,
        "warmup": warmup, "scan_steps": K,
        "final_loss": float(loss), "device": device_name(dev),
        "card": card_line(dev),
    }


def measure_bert(batch_size: int = 4, seq_len: int = 128,
                 precision: str = "fp32", grad_accum: int = 1,
                 param_sharding: str = "replicated", steps: int = 20,
                 warmup: int = 3, device="cuda",
                 model_name: str = "bert_base", remat: bool = False,
                 remat_policy: str = "full", ce_impl: str = "auto",
                 ce_chunk: int = 2048, fused_qkv: bool = False,
                 params_bf16: bool = False,
                 flash_min_seq: Optional[int] = None,
                 scan_steps: Optional[int] = None) -> dict:
    """Mean time of one BERT-base MLM (``gpt_base``: causal LM;
    ``moe_bert``; ``encdec_t5``) train step over the process group that
    is up (none: one card), after ``warmup`` untimed ones, or with
    ``scan_steps`` K > 0 (default 4) the scanned arm's; the levers as the
    module note says."""
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import bert

    dev = resolve_device(device)
    world, rank = meshlib.process_count(), meshlib.process_index()
    causal = model_name == "gpt_base"
    enc_dec = model_name == "encdec_t5"
    cfg = Config(model=model_name, batch_size=batch_size,
                 precision=precision, grad_accum=grad_accum,
                 param_sharding=param_sharding, remat=remat)
    bcfg = dataclasses.replace(
        bert.BERT_BASE, dtype=cfg.compute_dtype, remat=remat,
        remat_policy=remat_policy, ce_impl=ce_impl, ce_chunk=ce_chunk,
        fused_qkv=fused_qkv,
        max_positions=max(bert.BERT_BASE.max_positions, seq_len),
        **({} if flash_min_seq is None
           else {"flash_min_seq": flash_min_seq}))
    b = batch_size * world
    if batch_size % grad_accum:
        raise ValueError(f"--batch-size {batch_size} is not divisible by "
                         f"--grad-accum {grad_accum}")
    if dev.type == "cuda":
        torch.empty(0, device=dev)      # the allocator up, for its stats
        torch.cuda.reset_peak_memory_stats(dev)
    model = mlm_loop.FAMILIES[model_name].from_seed(bcfg, cfg.seed).to(dev)
    K = scan_width(scan_steps, TRANSFORMER_SCAN, steps)
    calls = max(1, warmup // K) + 1 + max(1, steps // K) if K else 0
    tx = opt_lib.transformer_tx(1e-4, max(warmup + steps, calls * K),
                                schedule="constant")
    state = gspmd.init_for(param_sharding, model, tx,
                           torch.bfloat16 if params_bf16 else None)
    train_step = gspmd.make_train_step(tx, grad_accum=grad_accum)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    banks = []
    if enc_dec:
        src, tgts = synthetic.seq2seq_batches(
            N_BANKS * b, src_len=seq_len, tgt_len=seq_len,
            vocab_size=bcfg.vocab_size, seed=0)
    else:
        toks, tgts, mask = synthetic.mlm_batches(
            N_BANKS * b, seq_len=seq_len, vocab_size=bcfg.vocab_size, seed=0)
    for k in range(N_BANKS):
        rows = mlm_loop.rank_rows(k * b, b, grad_accum, rank, world)
        inputs = ({"src": put(src[rows]), "tgt": put(tgts[rows])} if enc_dec
                  else {"tokens": put(toks[rows]), "mask": put(mask[rows])})
        banks.append((inputs, put(tgts[rows])))

    def run(i):
        gens = [step_generator(cfg.seed + 2, i, dev, rank, j)
                for j in range(grad_accum)]
        return train_step(state, *banks[i % N_BANKS], gens)[1]["loss"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if K > 0:
        multi = gspmd.make_multi_step(tx, grad_accum=grad_accum,
                                      seed=cfg.seed + 2, rank=rank,
                                      horizon=calls * K)
        window = {k: torch.stack([banks[i % N_BANKS][0][k]
                                  for i in range(K)]) for k in banks[0][0]}
        targets = torch.stack([banks[i % N_BANKS][1] for i in range(K)])

        def scanned():
            return multi(state, window, targets)[1]["loss"]
        sec, loss = time_scanned(scanned, steps, warmup, K, sync)
        steps = max(1, steps // K) * K
    else:
        for i in range(warmup):
            run(i)
        sync()
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            loss = run(i)
        sync()
        sec = (time.perf_counter() - t0) / steps
    # the causal family puts every position through the head; the MoE
    # keeps the dense formula (one expert of the dense width a token)
    if enc_dec:
        step_flops = flops.encdec_train_flops(bcfg, model.n_dec, batch_size,
                                              seq_len, seq_len)
    else:
        step_flops = flops.transformer_train_flops(
            bcfg, batch_size, seq_len,
            head_positions=seq_len if causal else None)
    on_card = dev.type == "cuda"
    mfu = flops.mfu(step_flops, sec, precision) if on_card else None
    return {
        "mode": "train", "model": model_name,
        "tokens_per_sec": b * seq_len / sec,
        "tokens_per_sec_per_chip": batch_size * seq_len / sec,
        "step_time_ms": sec * 1e3,
        "model_flops_per_step": step_flops,
        "mfu_pct": None if mfu is None else 100.0 * mfu,
        "mfu_bf16": flops.mfu(step_flops, sec, "bf16") if on_card else None,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if on_card else None),
        "bytes_at_rest": gspmd.bytes_at_rest(state),
        "remat": remat, "remat_policy": remat_policy if remat else None,
        "ce_impl": ce_impl, "ce_chunk": ce_chunk,
        "params_bf16": params_bf16, "fused_qkv": fused_qkv,
        "flash_min_seq": bcfg.flash_min_seq,
        "num_devices": world, "batch_size_per_chip": batch_size,
        "seq_len": seq_len, "grad_accum": grad_accum,
        "param_sharding": param_sharding, "precision": precision,
        "steps": steps, "warmup": warmup, "scan_steps": K,
        "final_loss": float(loss),
        "device": device_name(dev), "card": card_line(dev),
    }


def measure_allreduce(payload_mb: float = 25.4, chain: int = 32,
                      dispatches: int = 7, device="cuda") -> dict:
    """The median time of one all-reduce of ``payload_mb`` MB of float32
    on each rank over the process group that is up (without one, every
    all-reduce is the identity and nothing is launched)."""
    dev = resolve_device(device)
    world = meshlib.process_count()
    n = int(payload_mb * 1e6 / 4)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=n).astype(
        np.float32) * 1e-3).to(dev)
    scale = 1.0 / world

    def run_chain():
        for _ in range(chain):
            # sum then rescale: the magnitudes stay put, and every call
            # depends on the one before it
            collectives.allreduce_sum(x).mul_(scale)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run_chain()                     # warm-up: the communicator, buffers
    sync()
    graphed = graphs_lib.use_graphs(dev) and meshlib.active()
    if graphed:                     # the chain as one replay
        replay = graphs_lib.Graphs(dev).capture(
            run_chain, [], preserve=graphs_lib.snapshot([x]))
        run_chain = replay.replay
    times = []
    for _ in range(dispatches):
        t0 = time.perf_counter()
        run_chain()
        sync()
        times.append(time.perf_counter() - t0)
    if not torch.isfinite(x).all():
        raise AssertionError("the chained all-reduce went non-finite")
    sec = sorted(times)[len(times) // 2] / chain
    return {
        "mode": "allreduce", "allreduce_ms": sec * 1e3,
        "payload_mb": payload_mb, "algbw_gbps": (payload_mb / 1e3) / sec,
        "chain": chain, "dispatches": dispatches, "num_devices": world,
        "graph_replay": graphed,
        "backend": str(dist.get_backend()) if meshlib.active() else None,
        "device": device_name(dev), "card": card_line(dev),
    }


def measure_hostio(batch_size: int = 32, window_k: int = 4,
                   windows: int = 12, image_size: int = 224,
                   train_n: int = 512, demand: Optional[float] = None,
                   directory: str = "build",
                   card: Optional[str] = None) -> dict:
    """Host window-assembly images/sec, inline and on the thread, over a
    memory-mapped ``.npy`` of ``train_n`` rows (module note)."""
    import os
    import shutil
    import tempfile

    from mpi_tensorflow_torch.data import prefetch as pf

    if batch_size >= train_n:
        # assemble_window's wraparound is offset % (local_n - batch)
        raise ValueError(f"--batch-size {batch_size} must be < the hostio "
                         f"dataset size {train_n}")
    os.makedirs(directory, exist_ok=True)
    d = tempfile.mkdtemp(prefix="hostio-", dir=directory)
    try:
        path = os.path.join(d, "train_images.npy")
        arr = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float32,
            shape=(1, train_n, image_size, image_size, 3))
        row = np.linspace(0, 1, image_size * image_size * 3,
                          dtype=np.float32).reshape(image_size, image_size,
                                                    3)
        for i in range(train_n):
            arr[0, i] = row * ((i % 13) + 1)
        arr.flush()
        del arr
        tr_d = np.load(path, mmap_mode="r")
        tr_l = (np.arange(train_n, dtype=np.int64) % 1000)[None, :]
        starts = np.arange(windows) * window_k
        widths = np.full(windows, window_k)
        n_imgs = windows * window_k * batch_size

        def run(arm):
            t0 = time.perf_counter()
            if arm == "inline":
                for t, w in zip(starts, widths):
                    pf.assemble_window(tr_d, tr_l, int(t), int(w),
                                       window_k, batch_size)
                return n_imgs / (time.perf_counter() - t0)
            p = pf.make_prefetcher(tr_d, tr_l, starts, widths, window_k,
                                   batch_size, force=arm)
            try:
                while p.next() is not None:
                    pass
                return n_imgs / (time.perf_counter() - t0)
            finally:
                p.close()

        run("inline")                        # the page cache warm
        out = {"host_images_per_sec_inline": run("inline"),
               "host_images_per_sec_thread": run("thread")}
        try:
            out["host_images_per_sec_native"] = run("native")
        except RuntimeError as e:
            out["host_images_per_sec_native"] = None
            out["native_error"] = str(e)[:200]
        best = max(v for k, v in out.items()
                   if k.startswith("host_images") and v)
        out.update(
            host_images_per_sec=best, device_demand_img_s=demand,
            device_demand_source=("the ResNet-50 trainer on this card, "
                                  "passed in" if demand else None),
            feed_headroom_x=best / demand if demand else None,
            batch_size=batch_size, window_k=window_k, windows=windows,
            image_size=image_size, card=card,
            note="page-cache-warm mmap reads; steady-state epoch>1 bound")
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def decode_weight_bytes(model) -> int:
    """The bytes of weights one decode step reads: every parameter as
    stored, the tied logits product's compute-dtype copy of the token
    embedding in place of the float32 table (the embedding gathers B
    rows of it)."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    if model.tok_emb_dt is not None:
        e = model.tok_emb
        total += (model.tok_emb_dt.numel() * model.tok_emb_dt.element_size()
                  - e.numel() * e.element_size())
    return total


def measure_decode(batch_size: int = 8, prompt_len: int = 32,
                   new_tokens: int = 128, precision: str = "bf16",
                   iters: int = 5, num_beams: int = 0,
                   device="cuda") -> dict:
    """Decode tokens/sec of ``CausalLm.generate`` (greedy) or, with
    ``num_beams > 0``, ``beam_search``, from the slope between two
    generation lengths on one cache capacity (module note)."""
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.models.gpt import CausalLm

    dev = resolve_device(device)
    cfg = Config(precision=precision)
    bcfg = dataclasses.replace(bert.BERT_BASE, dtype=cfg.compute_dtype)
    model = CausalLm.from_seed(bcfg, 0).to(dev)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, bcfg.vocab_size, (batch_size, prompt_len))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def median_time(fn):
        fn()                                  # warmup
        sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    # the slope between two lengths: both pay the same prefill and
    # launch overheads, which cancel in the difference; both pin one
    # cache capacity, since a step attends over the whole cache
    n_short = max(8, new_tokens // 8)
    n_long = n_short + new_tokens
    L = prompt_len + n_long
    cache0 = model.init_cache(batch_size, L)
    if num_beams > 0:
        def gen(n):
            return model.beam_search(prompt, n, num_beams=num_beams,
                                     cache_len=L)
    else:
        def gen(n):
            return model.generate(prompt, n, cache_len=L)
    with torch.no_grad():
        prefill_sec = median_time(
            lambda: model.forward_with_cache(prompt, cache0, 0))
    short_sec = median_time(lambda: gen(n_short))
    long_sec = median_time(lambda: gen(n_long))
    per_tok = (long_sec - short_sec) / new_tokens
    # a decode step reads every weight at least once, so a slope below
    # weight bytes / HBM rate is a measurement artifact, never a rate
    param_bytes = decode_weight_bytes(model)
    min_per_tok = (param_bytes / (flops.HBM_TBPS * 1e12)
                   if dev.type == "cuda" else 0.0)
    degenerate = per_tok <= min_per_tok
    return {
        "mode": "decode", "model": "gpt_base",
        "decode_tokens_per_sec": (batch_size / per_tok if not degenerate
                                  else float("nan")),
        "per_token_ms": per_tok * 1e3,
        "roofline_min_per_token_ms": min_per_tok * 1e3,
        "param_bytes": param_bytes,
        "timing_degenerate": degenerate,
        "decode_lengths": [n_short, n_long],
        "gen_short_ms": short_sec * 1e3,
        "gen_long_ms": long_sec * 1e3,
        "prefill_ms": prefill_sec * 1e3,
        "batch_size": batch_size, "prompt_len": prompt_len,
        "new_tokens": new_tokens, "num_beams": num_beams,
        "precision": precision,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": device_name(dev), "card": card_line(dev),
    }


def decode_main(argv) -> int:
    """``--mode decode``: its flags and run, printed as the reference's
    metric line."""
    ap = argparse.ArgumentParser(prog="mpi_tensorflow_torch.bench "
                                      "--mode decode")
    ap.add_argument("--mode", choices=["decode"], default="decode")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    ap.add_argument("--steps", type=int, default=5,
                    help="timed calls an arm (the median is kept)")
    ap.add_argument("--num-beams", type=int, default=0,
                    help="0: greedy generate; K: beam search of K beams")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    args = ap.parse_args(argv)
    if args.num_beams < 0:
        ap.error(f"--num-beams must be >= 0, got {args.num_beams}")
    d = measure_decode(args.batch_size, args.prompt_len, args.new_tokens,
                       args.precision, max(1, args.steps), args.num_beams,
                       args.device)
    kind = f"beam-{args.num_beams}" if args.num_beams > 0 else "greedy"
    v = d["decode_tokens_per_sec"]
    print(json.dumps({
        "metric": f"GPT-base {kind} decode throughput (KV cache)",
        "value": round(v, 1) if v == v else None,
        "unit": "tokens/sec", "vs_baseline": None, "detail": d}),
        flush=True)
    return 0


def serving_main(argv) -> int:
    """``--mode serving``: the serving entry point's flags and run
    (``serving/harness``), printed as the reference's metric line."""
    from mpi_tensorflow_torch.serving import harness

    ap = argparse.ArgumentParser(prog="mpi_tensorflow_torch.bench "
                                      "--mode serving")
    ap.add_argument("--mode", choices=["serving"], default="serving")
    harness.add_serving_args(ap)
    args = ap.parse_args(argv)
    harness.check_serving_args(ap, args)
    det = harness.measure_serving(args)
    if det["rank"] == 0:
        print(json.dumps(harness.bench_line(det)), flush=True)
    return 0


def main(argv=None) -> int:
    ap0 = argparse.ArgumentParser(add_help=False)
    ap0.add_argument("--mode", default="train")
    mode = ap0.parse_known_args(argv)[0].mode
    if mode == "serving":
        return serving_main(argv)
    if mode == "decode":
        return decode_main(argv)
    ap = argparse.ArgumentParser(prog="mpi_tensorflow_torch.bench")
    # --mode serving and decode leave before this parser (above)
    ap.add_argument("--mode", choices=["train", "allreduce", "hostio"],
                    default="train")
    ap.add_argument("--model", default="mnist_cnn",
                    choices=["mnist_cnn", "resnet20", "resnet50", "vit",
                             *mlm_loop.FAMILIES])
    ap.add_argument("--batch-size", type=int, default=None,
                    help="per-card batch (default: mnist_cnn 64, resnet20 "
                         "128, resnet50 32, vit 128, the transformers 4)")
    ap.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed train steps (default: mnist_cnn 1000, "
                         "resnet20 500, resnet50 48, vit 200, bert_base "
                         "20)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="untimed steps before the timed ones (default: "
                         "mnist_cnn 50, resnet20 20, resnet50 5, vit 20, "
                         "bert_base 3)")
    ap.add_argument("--seq-len", type=int, default=128,
                    help="transformers: tokens per sequence")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="transformers: microbatches per step")
    ap.add_argument("--param-sharding", default="replicated",
                    choices=["replicated", "zero1", "fsdp"],
                    help="transformers: the state's layout over "
                         "the ranks")
    ap.add_argument("--remat", action="store_true",
                    help="train: recompute each transformer layer "
                         "(ResNet block) in the backward")
    ap.add_argument("--remat-policy", choices=["full", "dots"],
                    default="full",
                    help="what a rematted transformer layer saves: full "
                         "= nothing, dots = the products without batch "
                         "dimensions (the weight projections)")
    ap.add_argument("--ce", choices=["auto", "dense", "chunked"],
                    default="auto",
                    help="transformers: the loss's CE (models/bert.py "
                         "ce_impl): chunked = vocabulary tiles, never the "
                         "(B, S, V) float32 logits")
    ap.add_argument("--ce-chunk", type=int, default=2048,
                    help="vocabulary tile width for --ce chunked")
    ap.add_argument("--flash-min-seq", type=int, default=None,
                    help="transformers: take the flash kernels at seq_len "
                         ">= this (default: models/bert.py flash_min_seq, "
                         "4096; 0 = always)")
    ap.add_argument("--fused-qkv", action="store_true",
                    help="transformers: q, k, v from one stacked (E, 3HD) "
                         "product a layer instead of three")
    ap.add_argument("--params-bf16", action="store_true",
                    help="transformers: bfloat16 live parameters with "
                         "float32 masters in the optimizer (needs "
                         "--precision bf16)")
    ap.add_argument("--scan-steps", type=int, default=None,
                    help="train: steps a dispatch (one CUDA graph replay "
                         "on the card; default the model's K: mnist_cnn "
                         "400, resnet20 50, resnet50 8, vit 20, the "
                         "transformers 4); 0 = one step at a time")
    ap.add_argument("--payload-mb", type=float, default=25.4,
                    help="allreduce: float32 MB on each rank")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the rank's own card under "
                         "torchrun) or cpu; cuda without a card fails")
    ap.add_argument("--demand-images-per-sec", type=float, default=None,
                    help="hostio: the card's images/sec to compare the "
                         "feed with (none on the CPU)")
    ap.add_argument("--window-k", type=int, default=4,
                    help="hostio: steps a window")
    ap.add_argument("--windows", type=int, default=12,
                    help="hostio: windows assembled per arm")
    ap.add_argument("--hostio-dir", default="build",
                    help="hostio: where the temporary .npy is written")
    args = ap.parse_args(argv)
    # the reference bench's checks
    if args.remat_policy != "full" and not args.remat:
        ap.error("--remat-policy only applies with --remat")
    if args.remat_policy != "full" and (
            args.mode != "train" or args.model not in mlm_loop.FAMILIES):
        ap.error("--remat-policy applies to the transformer families in "
                 "train mode only: other paths would silently ignore it")
    transformer_train = (args.mode == "train"
                         and args.model in mlm_loop.FAMILIES)
    if args.fused_qkv and not transformer_train:
        ap.error("--fused-qkv applies to the transformer families in train "
                 "mode only: other paths would silently ignore it")
    if args.flash_min_seq is not None and not transformer_train:
        ap.error("--flash-min-seq applies to the transformer families in "
                 "train mode only: other paths would silently ignore it")
    if args.params_bf16 and args.precision != "bf16":
        ap.error("--params-bf16 requires --precision bf16 (fp32 compute "
                 "with bf16-truncated weights is not the fp32 baseline)")
    if args.params_bf16 and args.model not in mlm_loop.FAMILIES:
        ap.error(f"--params-bf16 is implemented for the transformer "
                 f"families ({', '.join(mlm_loop.FAMILIES)}) only: the "
                 f"image paths would silently ignore it")
    if args.params_bf16 and args.param_sharding != "replicated":
        ap.error(f"--params-bf16 keeps float32 masters of whole leaves; "
                 f"--param-sharding {args.param_sharding} slices the "
                 f"leaves over the ranks, and the reference's bench, which "
                 f"has no sharding axis, never pairs the two")
    if args.scan_steps is not None and args.mode != "train":
        ap.error("--scan-steps applies to train mode only")
    if args.mode == "hostio":
        on_card = torch.device(args.device).type == "cuda"
        print(json.dumps(measure_hostio(
            args.batch_size or 32, args.window_k, args.windows,
            demand=args.demand_images_per_sec if on_card else None,
            directory=args.hostio_dir,
            card=card_line(torch.device(args.device)) if on_card
            else None)), flush=True)
        return 0
    defaults = (4, 20, 3) if transformer_train else \
        IMAGE_SPECS.get(args.model, IMAGE_SPECS["mnist_cnn"])["defaults"]
    batch, steps, warmup = (d if v is None else v for v, d in zip(
        (args.batch_size, args.steps, args.warmup), defaults))
    if args.mode == "train" and not transformer_train:
        print(json.dumps(measure_train(args.model, batch, args.precision,
                                       steps, warmup, args.device,
                                       args.remat, args.scan_steps)),
              flush=True)
        return 0
    dev = meshlib.rank_device(args.device)
    if transformer_train:   # the launcher's world, else none
        joined = meshlib.initialize_distributed(dev)
        try:
            res = measure_bert(batch, args.seq_len, args.precision,
                               args.grad_accum, args.param_sharding, steps,
                               warmup, dev, args.model, args.remat,
                               args.remat_policy, args.ce, args.ce_chunk,
                               args.fused_qkv, args.params_bf16,
                               args.flash_min_seq, args.scan_steps)
            if meshlib.process_index() == 0:
                print(json.dumps(res), flush=True)
        finally:
            if joined:
                meshlib.shutdown()
        return 0
    # the launcher's world, else a world of one made here
    joined = meshlib.initialize_distributed(dev) or \
        meshlib.initialize_distributed(
            dev, init_method=f"tcp://127.0.0.1:{meshlib.free_port()}",
            rank=0, world_size=1)
    try:
        res = measure_allreduce(args.payload_mb, device=dev)
        if meshlib.process_index() == 0:
            print(json.dumps(res), flush=True)
    finally:
        if joined:
            meshlib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
