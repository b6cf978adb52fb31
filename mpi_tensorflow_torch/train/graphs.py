"""CUDA graphs: the port's counterpart of the JAX package's scanned
dispatches.

Where the JAX package runs K train steps (or K forwards) in one
``lax.scan`` dispatch, the port records the same K eager steps once into
one ``torch.cuda.CUDAGraph`` and then launches the whole window with one
replay.  The device decides, as ``ops`` kernels' ``resolve_kernel``
does: on a CUDA tensor the step runs graphed (``use_graphs``), on a CPU
tensor eagerly, one step after another.  Nothing falls back: a capture
or a replay that fails raises.

``Graphs`` holds what the graphs of one run share: one memory pool and
one capture stream.  ``Graphs.capture`` records one call of a function:

- **inputs** are static buffers the caller owns (a ``(K, B, ...)``
  window); ``Replay.replay`` copies each new input into its buffer
  before the launch (nothing when the caller wrote the buffer itself);
- **state** is updated in place: the captured function must leave every
  tensor the next replay reads in the storage it read it from;
- **warm-up**: the function runs once eagerly on the capture stream
  before the capture (cuDNN and cuBLAS handles, the kernels' build and
  load, autograd's lazy state).  ``preserve`` snapshots what that run
  and the capture's Python side effects change (device tensors, host
  counters) and is restored after them, so capturing does not advance
  the run;
- **dropout generators** are registered with the graph
  (``CUDAGraph.register_generator_state``) and reseeded before each
  replay, so a replay draws what the same steps would draw eagerly from
  freshly seeded generators;
- **launch counts**: a capture launches nothing, so the hand kernels'
  ``launches`` counters are put back after it, and each replay adds the
  launches the graph holds.

The outputs a captured function returns are the graph's own tensors:
each replay overwrites them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from mpi_tensorflow_torch.parallel import mesh as meshlib


def use_graphs(device) -> bool:
    """Whether steps on ``device`` run as graph replays: on a CUDA
    device with no process group, or one whose CUDA collectives go to
    NCCL (``nccl``, ``cpu:gloo,cuda:nccl``); gloo's run on the host and
    cannot be captured."""
    if torch.device(device).type != "cuda":
        return False
    if not meshlib.active():
        return True
    backend = str(dist.get_backend())
    return backend == "nccl" or "cuda:nccl" in backend.split(",")


def step_seed(seed: int, step: int, rank: int = 0, micro: int = 0) -> int:
    """The seed of the dropout generator of one microbatch of one train
    step of one rank; rank 0's first microbatch is the one-process
    run's."""
    return (int(seed) * 1_000_003 + int(step) + (int(rank) << 40)
            + (int(micro) << 52))


def step_generator(seed: int, step: int, device, rank: int = 0,
                   micro: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded by ``step_seed``."""
    return torch.Generator(device=device).manual_seed(
        step_seed(seed, step, rank, micro))


def kernel_counters() -> list:
    """Every hand kernel's wrapper, each with its ``launches`` count."""
    from mpi_tensorflow_torch.ops import flash_attention as fa
    from mpi_tensorflow_torch.ops import fused
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

    return [fa.flash_fwd, fa.flash_dq, fa.flash_dkdv,
            fused.layer_norm_forward, fused.online_logsumexp,
            pk.paged_attention_kernel]


class Replay:
    """One captured call: ``replay(*inputs, seeds=...)`` launches it."""

    def __init__(self, graph, static: Sequence[torch.Tensor], out,
                 generators: Sequence[torch.Generator], held: list):
        self.graph = graph
        self.static = list(static)
        self.out = out
        self.generators = list(generators)
        self.held = held            # launches of each kernel_counters()

    def replay(self, *inputs, seeds: Optional[Sequence[int]] = ()):
        """Copy ``inputs`` into the static buffers (in order; a buffer
        passed as itself is not copied), reseed the generators (None:
        the caller set their states), launch.  Returns the captured
        outputs (overwritten by the next replay)."""
        if seeds is not None and len(seeds) != len(self.generators):
            raise ValueError(f"{len(seeds)} seeds for "
                             f"{len(self.generators)} generators")
        for buf, x in zip(self.static, inputs):
            if x is not buf:
                buf.copy_(x)
        for gen, seed in zip(self.generators, seeds or ()):
            gen.manual_seed(int(seed))
        self.graph.replay()
        for fn, n in zip(kernel_counters(), self.held):
            fn.launches += n
        return self.out


class Graphs:
    """The graphs of one run on ``device``: one memory pool, one capture
    stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)

    def capture(self, fn: Callable, static: Sequence[torch.Tensor], *,
                generators: Sequence[torch.Generator] = (),
                preserve: Optional[Callable[[], Callable[[], None]]] = None
                ) -> Replay:
        """``fn(*static)`` warmed up once, then captured (module note).
        ``preserve()`` snapshots the state and returns its restore,
        called after the capture."""
        restore = preserve() if preserve is not None else None
        graph = torch.cuda.CUDAGraph()
        counters = kernel_counters()
        try:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                fn(*static)                         # the warm-up
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            warmed = [f.launches for f in counters]
            for gen in generators:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = fn(*static)
            held = [f.launches - w for f, w in zip(counters, warmed)]
            for f, w in zip(counters, warmed):
                f.launches = w                      # a capture launches none
        finally:
            if restore is not None:
                restore()
        return Replay(graph, static, out, generators, held)


def snapshot(tensors: Sequence[torch.Tensor], get_host: Callable = None,
             set_host: Callable = None):
    """A ``preserve`` for ``Graphs.capture``: copies of ``tensors`` (and
    ``get_host()``), put back in place (``set_host(saved)``)."""
    def preserve():
        saved = [t.detach().clone() for t in tensors]
        host = get_host() if get_host is not None else None

        def restore():
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            if set_host is not None:
                set_host(host)
        return restore
    return preserve


def graphed_call(owner, key, fn: Callable, inputs: Sequence[torch.Tensor],
                 generator: Optional[torch.Generator] = None):
    """``fn(*inputs, gen)`` as one replay of a graph captured at the
    first call with ``key`` (kept on ``owner``, with one memory pool for
    all of its graphs); the result is cloned out of the graph.  With a
    ``generator`` the graph draws from a generator of its own that each
    replay starts at ``generator``'s state and, after it, hands its
    state back: ``generator`` advances as the eager call advances it.
    Without one, ``gen`` is None."""
    graphs = owner.__dict__.setdefault("_call_graphs", {})
    if key not in graphs:
        if None not in graphs:
            graphs[None] = Graphs(inputs[0].device)
        g = graphs[None]
        gen = torch.Generator(device=g.device) if generator is not None \
            else None
        static = [x.clone() for x in inputs]
        graphs[key] = (g.capture(lambda *a: fn(*a, gen), static,
                                 generators=[gen] if gen else []), gen)
    replay, gen = graphs[key]
    if gen is not None:
        gen.set_state(generator.get_state())
    out = replay.replay(*inputs, seeds=None)
    if gen is not None:
        generator.set_state(gen.get_state())
    if isinstance(out, tuple):
        return tuple(o.clone() for o in out)
    return out.clone()
