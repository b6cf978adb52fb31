"""One rank of the 2-rank gloo world of ``tests/test_torch_lamb_corpus.py``.

    python tests/_torch_lamb_worker.py RANK WORLD PORT WORKDIR

Imports torch, numpy and ``mpi_tensorflow_torch`` only (no JAX, no
conftest), with the inputs, the model and the batches of
``tests/_torch_tdp_worker.py``: this rank joins the world at
``tcp://127.0.0.1:PORT`` over gloo, on one thread, takes ``tdp.STEPS``
LAMB steps (the warmup-cosine schedule) of BERT_TINY at one layer in
the zero1 and the fsdp layout, feeding its rows of every global batch,
and writes the losses and the parameters after them to
``WORKDIR/rank<RANK>.npz``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

import _torch_tdp_worker as tdp

KINDS = ("zero1", "fsdp")


def lamb_steps(kind: str, inputs, rank: int, world: int, out: dict) -> None:
    from mpi_tensorflow_torch.train import gspmd, mlm_loop, optimizer

    tx = optimizer.transformer_tx(tdp.LR, tdp.NUM_STEPS, optimizer="lamb",
                                  schedule="warmup_cosine")
    state = gspmd.init_for(kind, tdp._model(inputs), tx)
    step = gspmd.make_train_step(tx)
    rows = mlm_loop.rank_rows(0, tdp.GLOBAL_B, 1, rank, world)
    out[f"{kind}/losses"] = np.array([
        float(step(state, *tdp._batch(inputs, t, rows))[1]["loss"])
        for t in range(tdp.STEPS)])
    out.update(tdp.flatten(tdp._params(state), f"{kind}/params"))


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    workdir = sys.argv[4]
    torch.set_num_threads(1)
    from mpi_tensorflow_torch.parallel import mesh

    mesh.initialize_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    try:
        for kind in KINDS:
            lamb_steps(kind, inputs, rank, world, out)
    finally:
        mesh.shutdown()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
