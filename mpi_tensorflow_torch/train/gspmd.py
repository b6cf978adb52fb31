"""The transformer train and eval steps, on one device or across the
ranks of a mesh.

Counterpart of ``init_gspmd_state``, ``init_zero1_state``,
``init_fsdp_state``, ``make_gspmd_train_step``,
``make_gspmd_multi_step`` (``make_multi_step``: K steps a call, one
CUDA graph replay on the card) and ``make_gspmd_eval_step`` in
``mpi_tensorflow_tpu/train/gspmd.py``: one rank per card, the mesh the
model carries (``parallel.mesh``; without one, a ``data`` axis over the
whole ``torch.distributed`` world).  The model places its own
``model`` and ``seq`` collectives (``models/bert.py``); GSPMD inserts
the rest of the reference's from the placement, and here the step
places them by hand over the ``data`` x ``seq`` axes, never over
``model`` (its ranks hold the same replicated leaves, with the same
gradients, and each its own block of the sharded ones).  Without a
process group each collective is the identity:

- **the loss** of a microbatch is its CE summed over this rank's rows'
  supervised positions (``model.loss_weights``: the masked positions of
  the MLM family, B x (S - 1) shifted targets of the causal one and of
  the enc-dec family's target side) divided by their count over the
  microbatch's GLOBAL rows (the counts of all microbatches all-reduced
  in one call before the forward), so the sum over the ranks is the
  reference's global mean, not a mean of per-rank means; plus the
  model's auxiliary loss (the MoE's load balance) at its weight, each
  rank's over the world size, so the sum is the ranks' mean (each rank
  routes its own rows: ROADMAP Queue 3);
- **the batch** is ``{"tokens", "mask"}`` (the MLM and causal families)
  or ``{"src", "tgt"}`` (the enc-dec family, labels the targets), each
  (B, S) and split into microbatches alike;
- **accumulation** (``grad_accum`` = A): the rank's batch holds A
  microbatches, microbatch i being this rank's rows of the global
  microbatch i (``train.mlm_loop.rank_rows``: the reference reshapes
  the GLOBAL batch, ``x.reshape(accum, B/accum, ...)``).  Their
  gradients add up in ``.grad``, then one reduction, then the division
  by A, and the loss is the sum of the microbatch losses over A
  (``gspmd.py:223-226``);
- **the reduction**: ``replicated``: one all-reduce of every gradient and
  the loss, packed in one flat buffer; ``zero1`` and ``fsdp``: one
  reduce-scatter over the data axis of the sharded leaves' gradients,
  packed by ``parallel.fsdp.FlatLayout``, which leaves each rank the
  sum of its slices (then summed over the seq axis), and one all-reduce
  of the replicated leaves' gradients (the leaves under
  ``fsdp.DEFAULT_MIN_SIZE`` elements) and the loss;
- **the update**: ``TransformerTx.update`` on the whole leaves or on this
  rank's slices, the global norm summing each sliced or model-sharded
  leaf's squares over its axes and counting each replicated leaf once;
- **zero1 / fsdp under a model axis** slice each leaf of this rank's
  block over the data axis along the dimension the reference's
  ``augment_spec`` picks on the whole shape, one the rules left to no
  axis;
- **bfloat16 parameters** (``init_state(param_dtype=torch.bfloat16)``,
  the reference's ``init_gspmd_state(param_dtype=)``): every floating
  leaf of the model is stored in that dtype, and the optimizer state is
  a ``MasterOpt``: float32 masters, the moments on them.  The step
  accumulates the microbatches' gradients in float32 (the reference's
  ``grad_accum_dtype``), updates the masters, and copies them back into
  the live parameters, cast: after every step the live parameters are
  the masters rounded to the live dtype.  Replicated only (the
  reference's bench, the one caller, has no sharding axis);
- **zero1**: parameters whole on every rank, moments sliced; the updated
  slices are all-gathered back into the parameters.  **fsdp**:
  parameters and moments sliced between steps; the train and eval
  steps all-gather the parameters for use (one flat buffer) and release
  them after (``full_params``).  ``bytes_at_rest`` counts what stays.

Overlapping the reduction with the backward is not done: the step
reduces once, after the last microbatch.  zero1 and fsdp need a world
of more than one rank (the reference's ``ValueError``,
``mlm_loop.py:173-182``).  Every rank builds the same parameters from
the seed, as every device of the reference's replicated placement holds
the same.

Where the reference folds its rng with the step and the microbatch
(``fold_in(fold_in(rng, step), i)``), the port draws each microbatch's
dropout masks from a ``torch.Generator`` seeded by ``(seed, step, rank,
microbatch)`` (``step_generator``), the rank being the index on the
``data`` x ``seq`` axes (``mesh.group("data", "seq").index``): the
ranks of a model axis draw the same masks for the replicated residual
stream they all hold, and each seq rank its own block's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch

from mpi_tensorflow_torch.models.bert import BertMlm
from mpi_tensorflow_torch.parallel import collectives, fsdp
from mpi_tensorflow_torch.parallel import mesh as meshlib
from mpi_tensorflow_torch.parallel import sharding_rules
from mpi_tensorflow_torch.train import graphs as graphs_lib
from mpi_tensorflow_torch.train.graphs import step_generator, step_seed
from mpi_tensorflow_torch.train.optimizer import (AdamWState, MasterOpt,
                                                  TransformerTx)
from mpi_tensorflow_torch.train.step import flat_buffer
from mpi_tensorflow_torch.utils import tree as tree_lib

@dataclasses.dataclass
class Sharding:
    """How a zero1 or fsdp state splits its leaves over the data axis."""
    kind: str                     # "zero1" | "fsdp"
    shapes: list                  # every leaf's shape whole over the data
                                  # axis (this rank's block of a model-
                                  # sharded one), leaf order
    dims: list                    # fsdp.shard_dim of each leaf
    layout: fsdp.FlatLayout
    rank: int                     # this rank's index on the data axis
    world: int                    # the data axis' size
    axis: Optional[meshlib.Axis] = None     # the data axis (None: the
                                            # world)
    shards: Optional[torch.Tensor] = None   # fsdp: this rank's chunk of
                                            # the sharded parameters


def _axes(model):
    """``(reduce, data)``: the axis a step's gradients, loss and counts
    reduce over (``data`` x ``seq``: never ``model``, whose ranks hold
    the same replicated leaves and each its own block of the sharded
    ones) and the axis zero1 and fsdp slice over; both None (the world)
    for a model without a mesh."""
    mesh = model.mesh
    if mesh is None:
        return None, None
    return mesh.group("data", "seq"), mesh.group("data")


def _size(axis) -> int:
    return meshlib.process_count() if axis is None else axis.size


def _norm_axes(model, sharding: Optional[Sharding]):
    """Per leaf, the axis its squares are summed over for the global norm
    (and LAMB's leaf norms): None for a leaf whole on every rank, the
    ``model`` axis for a model-sharded one, the data axis for a zero1 /
    fsdp slice (True: the world), both axes for both; None for the whole
    list when every leaf is whole."""
    n = len(_params(model))
    tp = [bool(sp) for sp in model.leaf_specs()]
    sl = [False] * n if sharding is None else \
        [d is not None for d in sharding.dims]
    if not any(tp) and not any(sl):
        return None
    mesh = model.mesh
    out = []
    for t, d in zip(tp, sl):
        if t and d:
            out.append(mesh.group("model", "data"))
        elif t:
            out.append(mesh.group("model"))
        elif d:
            out.append(True if sharding.axis is None else sharding.axis)
        else:
            out.append(None)
    return out


@dataclasses.dataclass
class TrainState:
    """Parameters (in ``model``), optimizer state and step count.  The
    step updates the model's parameters and ``opt`` in place.  With
    ``sharding`` the moments of the sharded leaves are this rank's
    slices, and under fsdp so are their parameters (``sharding.shards``)
    while the model holds none of them between steps."""
    model: BertMlm
    opt: AdamWState | MasterOpt
    step: int = 0
    sharding: Optional[Sharding] = None


def _params(model) -> list:
    return tree_lib.leaves(model.param_tree())


def _replace_leaves(tree, new: dict):
    """``tree`` with leaf i (in tree order) replaced by ``new[i]`` where
    given."""
    return tree_lib.unflatten(tree, [new.get(i, leaf) for i, leaf in
                                     enumerate(tree_lib.leaves(tree))])


def _opt_tree(state: TrainState):
    """The tree the optimizer updates: the parameter tree with each
    sharded leaf replaced by this rank's slice of it."""
    sh, model = state.sharding, state.model
    if sh is None:
        return model.param_tree()
    if sh.kind == "fsdp":
        return _replace_leaves(model.param_tree(), sh.layout.views(sh.shards))
    params = _params(model)
    return _replace_leaves(model.param_tree(), {
        i: fsdp.shard(params[i], d, sh.rank, sh.world)
        for i, d in enumerate(sh.dims) if d is not None})


def init_state(model: BertMlm, tx: TransformerTx,
               param_dtype: Optional[torch.dtype] = None) -> TrainState:
    """Every leaf whole on every rank (``init_gspmd_state``).  With
    ``param_dtype`` the model's floating leaves are cast to it in place
    and the optimizer keeps float32 masters (module note)."""
    tree = model.param_tree()
    if param_dtype is None:
        return TrainState(model, tx.init(tree))
    leaves = tree_lib.leaves(tree)
    master = [p.detach().to(torch.float32).clone() for p in leaves]
    for p in leaves:
        if p.is_floating_point():
            p.data = p.data.to(param_dtype)
    return TrainState(model, MasterOpt(master, tx.init(master)))


def _sharding(model: BertMlm, kind: str, min_size: int) -> Sharding:
    _, data = _axes(model)
    world = _size(data)
    if world <= 1:
        # the reference's check: without a data axis larger than 1 the
        # placement shards nothing, and the run would go on replicated
        # while the user believes the ZeRO sharding engaged
        mesh = model.mesh
        shape = dict(mesh) if mesh is not None else {"data": world}
        raise ValueError(
            f"--param-sharding {kind} shards over the 'data' mesh axis, "
            f"but this mesh has none (mesh {shape}); add data=N or drop "
            f"the flag")
    shapes = [tuple(p.shape) for p in _params(model)]
    specs = model.leaf_specs()
    # augment_spec on the whole shape, past the dimensions the rules
    # gave the model axis (a model-sharded dimension is never sliced)
    dims = []
    for shape, spec in zip(shapes, specs):
        whole = [n * (model.mesh.axis_size(spec[d]) if d < len(spec)
                      and spec[d] else 1) for d, n in enumerate(shape)]
        dims.append(fsdp.shard_dim(whole, world, min_size, taken={
            d for d, ax in enumerate(spec) if ax}))
    rank = meshlib.process_index() if data is None else data.index
    return Sharding(kind, shapes, dims, fsdp.FlatLayout(shapes, dims, world),
                    rank, world, data)


def init_zero1_state(model: BertMlm, tx: TransformerTx,
                     min_size: int = fsdp.DEFAULT_MIN_SIZE) -> TrainState:
    """ZeRO-1: the parameters whole on every rank, each sharded leaf's
    moments this rank's slice (``init_zero1_state``)."""
    state = TrainState(model, None, sharding=_sharding(model, "zero1",
                                                       min_size))
    state.opt = tx.init(_opt_tree(state))
    return state


def init_fsdp_state(model: BertMlm, tx: TransformerTx,
                    min_size: int = fsdp.DEFAULT_MIN_SIZE) -> TrainState:
    """FSDP: each sharded leaf's parameter and moments this rank's slice
    (``init_fsdp_state``); the model keeps the replicated leaves only."""
    sh = _sharding(model, "fsdp", min_size)
    params = _params(model)
    sh.shards = sh.layout.pack_own(params, sh.rank, torch.empty(
        sh.layout.chunk, dtype=torch.float32, device=params[0].device))
    state = TrainState(model, None, sharding=sh)
    state.opt = tx.init(_opt_tree(state))
    _release(state)
    return state


def init_for(param_sharding: str, model: BertMlm, tx: TransformerTx,
             param_dtype: Optional[torch.dtype] = None) -> TrainState:
    """The state in ``param_sharding``'s layout: replicated, zero1 or
    fsdp; ``param_dtype`` (replicated only) as ``init_state``'s."""
    inits = {"replicated": init_state, "zero1": init_zero1_state,
             "fsdp": init_fsdp_state}
    if param_sharding not in inits:
        raise ValueError(f"unknown param_sharding {param_sharding!r}")
    if param_dtype is not None:
        if param_sharding != "replicated":
            raise ValueError(
                f"param_dtype keeps float32 masters of whole leaves; "
                f"{param_sharding} slices them over the ranks")
        return init_state(model, tx, param_dtype)
    return inits[param_sharding](model, tx)


def _gather(state: TrainState) -> None:
    """fsdp: every sharded parameter made whole in the model, from one
    all-gather of the ranks' chunks."""
    sh = state.sharding
    whole = sh.layout.whole(collectives.allgather(sh.shards, tiled=True,
                                                  axis=sh.axis))
    for i, p in enumerate(_params(state.model)):
        if i in whole:
            p.data = whole[i]


def _release(state: TrainState) -> None:
    """fsdp: the model's sharded parameters (and gradients) freed."""
    sh = state.sharding
    for p, d in zip(_params(state.model), sh.dims):
        if d is not None:
            p.data = p.data.new_empty(0)
            p.grad = None


@contextlib.contextmanager
def full_params(state: TrainState):
    """The model with every parameter whole for the duration (under fsdp
    gathered on entry and released on exit; otherwise as it is).  Every
    rank enters together."""
    fsdp_state = state.sharding is not None and state.sharding.kind == "fsdp"
    if fsdp_state:
        _gather(state)
    try:
        yield state.model
    finally:
        if fsdp_state:
            _release(state)


def bytes_at_rest(state: TrainState) -> dict:
    """The bytes this rank holds between steps: ``params`` (the model's
    parameters, and under fsdp this rank's chunk), ``masters`` (the
    float32 copies of a ``MasterOpt``, else 0) and ``moments`` (adamw's
    two), with what a whole float32 replica would hold beside them."""
    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    params = size(_params(state.model))
    shapes = [p.shape for p in _params(state.model)]
    if state.sharding is not None:
        shapes = state.sharding.shapes
        if state.sharding.shards is not None:
            params += size([state.sharding.shards])
    whole = sum(4 * math.prod(s) for s in shapes)
    master = isinstance(state.opt, MasterOpt)
    opt = state.opt.inner if master else state.opt
    return {"params": params,
            "masters": size(state.opt.master) if master else 0,
            "moments": size(opt.mu + opt.nu),
            "replica_params": whole, "replica_moments": 2 * whole}


def _generators(generator, accum: int) -> list:
    if generator is None:
        return [None] * accum
    gens = [generator] if isinstance(generator, torch.Generator) \
        else list(generator)
    if len(gens) != accum:
        raise ValueError(f"{len(gens)} dropout generators for {accum} "
                         f"microbatches")
    return gens


def _packed(tensors: list, loss: torch.Tensor):
    """``(buffer, views)``: ``tensors`` then ``loss`` in one float32
    buffer, and a view of it shaped like each tensor."""
    buf, views = flat_buffer(tensors, extra=1)
    torch.cat([t.reshape(-1) for t in tensors] + [loss.reshape(1)], out=buf)
    return buf, views


def _reduce(state: TrainState, grads: list, loss: torch.Tensor,
            accum: int, across: bool):
    """The gradients and the loss summed over the reduce axis (module
    note) and divided by ``accum``: ``(tree to update, its gradients,
    each leaf's norm axis, loss)``."""
    sh = state.sharding
    model = state.model
    red, _ = _axes(model)
    if sh is None:
        if across:
            buf, grads = _packed(grads, loss)
            collectives.allreduce_sum(buf, red)
            loss = buf[-1]
        if accum > 1:
            torch._foreach_div_(grads, accum)
            loss = loss / accum
        return model.param_tree(), grads, _norm_axes(model, None), loss
    lay = sh.layout
    chunk = collectives.reduce_scatter(lay.pack(grads, torch.empty(
        lay.world * lay.chunk, dtype=torch.float32, device=loss.device)),
        sh.axis)
    mesh = model.mesh
    if mesh is not None:
        # the slices' sums over the data axis, then over the seq axis
        collectives.allreduce_sum(chunk, mesh.group("seq"))
    whole = [i for i, d in enumerate(sh.dims) if d is None]
    buf, views = _packed([grads[i] for i in whole], loss)
    collectives.allreduce_sum(buf, red)
    if accum > 1:
        chunk.div_(accum)
        buf.div_(accum)
    out = {**lay.views(chunk), **dict(zip(whole, views))}
    return (_opt_tree(state), [out[i] for i in range(len(grads))],
            _norm_axes(model, sh), buf[-1])


def _float32_grads(params: list) -> list:
    """Each parameter's gradient in float32 (zeros where it has none),
    every ``.grad`` cleared."""
    out = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           if p.grad is None else p.grad.to(torch.float32) for p in params]
    for p in params:
        p.grad = None
    return out


def make_train_step(tx: TransformerTx, grad_accum: int = 1,
                    across_ranks: Optional[bool] = None):
    """``train_step(state, batch, labels, generator) -> (state, {"loss":
    float32 scalar tensor})``: ``batch`` holds ``tokens`` and ``mask``
    (B, S) (the causal family reads ``tokens`` alone; the enc-dec family
    ``src`` and ``tgt``), this rank's rows of ``grad_accum`` microbatches
    in order;
    ``labels`` (B, S); ``generator`` feeds dropout: one
    ``torch.Generator`` a microbatch (a list, or one generator when
    ``grad_accum`` is 1), None when ``cfg.dropout == 0``.  Across the
    ranks of the process group (``across_ranks``, default: whether one is
    up) the loss and gradients are the global batch's (module note).
    The loss stays on the device: nothing here waits for the card."""
    accum = int(grad_accum)
    if accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(state: TrainState, batch: dict, labels,
                   generator=None):
        across = meshlib.active() if across_ranks is None else across_ranks
        sh = state.sharding
        if sh is not None and not across:
            raise ValueError(f"a {sh.kind} state steps across the ranks")
        gens = _generators(generator, accum)
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"batch dim {n} not divisible by grad_accum "
                             f"{accum}")
        m = n // accum
        model = state.model
        if sh is not None and sh.kind == "fsdp":
            _gather(state)
        params = _params(model)
        red, _ = _axes(model)
        # each microbatch's supervised positions over the global batch
        counts = model.loss_weights(batch).reshape(accum, -1).sum(1)
        if across:
            collectives.allreduce_sum(counts, red)
        aux_w = model.aux_weight() / (_size(red) if across else 1)
        master = state.opt if isinstance(state.opt, MasterOpt) else None
        for p in params:
            p.grad = None
        loss = acc = None
        for i in range(accum):
            rows = slice(i * m, (i + 1) * m)
            ce, aux = model.loss_terms(
                {k: v[rows] for k, v in batch.items()}, labels[rows],
                train=True, generator=gens[i])
            part = ce / torch.clamp(counts[i], min=1.0) + aux_w * aux
            part.backward()
            loss = part.detach() if loss is None else loss + part.detach()
            if master is not None:
                # low-precision gradients add up in float32
                with torch.no_grad():
                    g = _float32_grads(params)
                    acc = g if acc is None else torch._foreach_add(acc, g)
        with torch.no_grad():
            # a leaf the loss does not read (pos_emb under rope) has a
            # zero gradient, as jax.grad gives it
            grads = acc if master is not None else [
                torch.zeros_like(p) if p.grad is None else p.grad
                for p in params]
            tree, grads, sharded, loss = _reduce(state, grads, loss, accum,
                                                 across)
            if master is None:
                tx.update(tree, grads, state.opt, sharded=sharded)
            else:
                tx.update(tree_lib.unflatten(tree, master.master), grads,
                          master.inner, sharded=sharded)
                torch._foreach_copy_(params, master.master)
            del tree, grads
            for p in params:
                p.grad = None
            if sh is not None and sh.kind == "zero1":
                own = sh.layout.pack_own(params, sh.rank, torch.empty(
                    sh.layout.chunk, dtype=torch.float32,
                    device=loss.device))
                sh.layout.unpack(collectives.allgather(
                    own, tiled=True, axis=sh.axis), params)
            elif sh is not None:
                _release(state)
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_eval_step():
    """``eval_step(state, inputs) -> float32 logits (B, S, V)``: the
    forward in eval mode (no dropout), without gradients; ``inputs`` are
    the tokens (B, S), or the enc-dec family's ``{"src", "tgt"}`` pair
    (logits over the target positions).  Under a model axis each rank's
    vocabulary slice."""

    @torch.no_grad()
    def eval_step(state: TrainState, inputs):
        with full_params(state):
            return state.model.apply(inputs, train=False)

    return eval_step


def gathered_params(state: TrainState) -> dict:
    """Every parameter whole, in the reference's tree (copies): fsdp's
    slices gathered over the data axis, a model axis' blocks over it.
    A collective: every rank of the mesh calls it."""
    with torch.no_grad(), full_params(state) as model:
        tree = tree_lib.map_leaves(lambda _, v: v.detach().clone(),
                                   model.param_tree())
        if model.tp is not None:
            tree = sharding_rules.gather_tree(tree, model.logical_axes(),
                                              model.mesh)
        return tree


def state_tensors(state: TrainState) -> list:
    """Every device tensor a train step updates in place: the model's
    parameters, the moments, the float32 masters, fsdp's own chunk."""
    master = isinstance(state.opt, MasterOpt)
    opt = state.opt.inner if master else state.opt
    out = _params(state.model) + opt.mu + opt.nu
    if master:
        out += state.opt.master
    if state.sharding is not None and state.sharding.shards is not None:
        out.append(state.sharding.shards)
    return out


def make_multi_step(tx: TransformerTx, grad_accum: int = 1,
                    across_ranks: Optional[bool] = None,
                    seed: Optional[int] = None, rank: int = 0,
                    horizon: int = 0):
    """``multi_step(state, batches, labels) -> (state, {"loss": (K,)})``:
    K train steps of ``make_train_step``'s function over ``batches`` (a
    dict of (K, B, S) tensors) and ``labels`` (K, B, S), the
    counterpart of ``make_gspmd_multi_step`` (``gspmd.py:253-279``), in
    every layout and at any ``grad_accum``.  With ``seed`` (and a model
    with dropout) step t's microbatch i draws from
    ``step_generator(seed, t, device, rank, i)``, t read from
    ``state.step``.

    On the CPU the K steps run one after another, each through the
    function ``make_train_step`` returns (the module attribute).  On a
    CUDA device (``graphs.use_graphs``) the K steps are one replay of a
    graph captured at the first call of that K: the window's generators
    registered with it and reseeded before each replay, the LR and
    bias corrections read from the optimizer's ``StepTable`` (rows up
    to ``horizon`` steps), the host counters (``state.step``, the
    optimizer's ``count``) advanced by K after it."""
    one = make_train_step(tx, grad_accum, across_ranks)
    accum = int(grad_accum)
    graphs, replays = None, {}

    def dropout(state) -> bool:
        return seed is not None and getattr(state.model.cfg, "dropout",
                                            0.0) > 0.0

    def opt_of(state):
        return state.opt.inner if isinstance(state.opt, MasterOpt) \
            else state.opt

    def capture(state, batches, labels, dev):
        nonlocal graphs
        n = labels.shape[0]
        if graphs is None:
            graphs = graphs_lib.Graphs(dev)
        keys = sorted(batches)
        static = [torch.zeros_like(batches[k]) for k in keys] \
            + [torch.zeros_like(labels)]
        gens = [torch.Generator(device=dev) for _ in range(n * accum)] \
            if dropout(state) else []

        def window(*xs):
            losses = []
            for j in range(n):
                _, m = one(state, {k: x[j] for k, x in zip(keys, xs)},
                           xs[-1][j], gens[j * accum:(j + 1) * accum] or None)
                losses.append(m["loss"])
            return torch.stack(losses).float()

        def get_host():
            return state.step, opt_of(state).count

        def set_host(host):
            state.step, opt_of(state).count = host

        tx.table(dev).freeze(max(horizon, opt_of(state).count + n))
        return graphs.capture(
            window, static, generators=gens,
            preserve=graphs_lib.snapshot(state_tensors(state), get_host,
                                         set_host))

    def multi_step(state: TrainState, batches: dict, labels):
        K = labels.shape[0]
        dev = labels.device
        if not graphs_lib.use_graphs(dev):
            losses = []
            for j in range(K):
                gens = None
                if dropout(state):
                    gens = [step_generator(seed, state.step, dev, rank, i)
                            for i in range(accum)]
                state, m = one(state, {k: v[j] for k, v in batches.items()},
                               labels[j], gens)
                losses.append(m["loss"])
            return state, {"loss": torch.stack(losses).float()}
        if K not in replays:
            replays[K] = capture(state, batches, labels, dev)
        r = replays[K]
        opt = opt_of(state)
        tx.table(dev).seek(opt.count)
        seeds = [step_seed(seed, state.step + j, rank, i)
                 for j in range(K) for i in range(accum)] \
            if dropout(state) else []
        loss = r.replay(*[batches[k] for k in sorted(batches)], labels,
                        seeds=seeds).clone()
        state.step += K
        opt.count += K
        return state, {"loss": loss}

    multi_step.replays = replays
    return multi_step
