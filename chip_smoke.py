#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``mpi_tensorflow_torch`` (never JAX, never ``mpi_tensorflow_tpu``)
on the card and fails, with a nonzero exit, on the first phase that
fails:

1. card and build — prints the card's name and power limit
   (``nvidia-smi``), builds every CUDA kernel of the port from the
   sources in the checkout and prints the seconds it took;
2. kernel against its plain version — ``paged_attention_kernel`` against
   ``paged_attention_reference`` at the serving shapes (H=12, D=64,
   bs=16, every S in 1, 2, 4, ..., 64, B in {1, 8}, NB up to 32, plus
   BERT_TINY's H=4, D=16, and at both the widths 3, 5, 6 that do not
   divide the 8-query tile (B=8; 5 is speculation's verify), and at H=6
   and H=3 (a tensor-parallel rank's heads of BERT_BASE under tp 2 and
   4) at S in 1, 5, 16; float32 and bfloat16; ragged rows, a
   bucket-slack row, poisoned null-block and dead lanes; and at S = 1 and
   8 the edge rows of ``EDGE_LENS``: live lengths that are not a multiple
   of bs, one live block, a query's own column on either side of a block
   boundary), then times it at the decode shape (beside PERF.md's earlier
   time), the plain version, ``F.scaled_dot_product_attention`` on a
   pre-gathered view (the
   yardstick only: the port never calls it) and its memory bound;
2b. the same for the quantized modes — int8, int4 (g = 32; g = 16 at
   H=4, D=16) and int4 with the residual lane, float32 and bfloat16, the
   widths 3, 5, 6 too, the null block's and dead lanes' scales poisoned
   to 1e30, the edge rows
   too (in int4 + residual the self column at a block boundary) — then
   each mode timed at the decode shape beside its plain version, SDPA on a
   pre-gathered, pre-dequantized view, the fp-mode kernel on the same
   blocks and its memory bound;
3. full-width serving — a seeded Poisson trace (24 requests at 4 rps,
   prompts <= 32, outputs <= 128 tokens, seed 0) through
   ``PagedDecodeEngine`` at ``BERT_BASE`` geometry in bfloat16 with
   ``kernel="cuda"``; the kernel's launch count must equal layers x
   forward dispatches;
3b. the serving bench's ``--serve-kernel-ab`` and ``--serve-kv-ab`` at
   full width: the harness's A/B blocks on phase 3's engine and timed
   run, the gather path and the int8 pool each after its own warmup
   replay, each arm's launches counted alone (layers x its dispatches,
   0 on gather); then the int4 pool (no warmup replay); every request
   ``ok``, the
   ``kv_quant`` block against phase 3's run (capacity multipliers
   exactly 1.8824 and 3.2; the token match rate is printed, not held:
   random weights cannot judge quality);
4. cross-check — a short trace in float32 at 2 layers (full width)
   served with ``kernel="cuda"`` and with ``kernel="gather"``: the greedy
   tokens must be identical to each other and to ``CausalLm.generate``;
4b. the same two lowerings from an int8 and from an int4 pool: identical
   greedy tokens;
15. (run after 16, before phase 2's timing and any ``torch.profiler``
   session, as phase 3 is; no warmup replays) the serving features
   at phase 3's setup (``BERT_BASE``, bf16, ``kernel="cuda"``): every
   request ``ok``, and the paged
   kernel's launches == layers x forward dispatches (+ the draft model's
   layers x its feeds) — 15a: the prefix cache on phase 3's trace with
   a shared 64-token prompt: hit tokens > 0 and fewer prefill dispatches
   than the same trace with the cache off; 15b: prefix v2 and the host
   tier on a 12-request trace with its follow-up turn through a 40-block
   pool: gen-inserted blocks, demotions and promotions > 0, the landed
   promotion ms printed; 15c: mixed batching on phase 3's trace, then
   both loops replayed on one virtual clock (the trace's first 12
   requests): mixed dispatches per token
   below the mixed-off loop's; 15d: ngram (12 requests) and
   draft-model speculation (4 requests), each beside a control with
   speculation off, acceptance
   rate printed; 15e: float32, 2 layers
   at full width, 2 slots, a 32-token shared prompt: prefix + mixed and
   prefix + the target as its own drafter, served with ``cuda`` and
   ``gather``: greedy tokens identical to each other and to the
   feature-off ``cuda`` run;
5. flash kernels against their plain versions — ``flash_fwd`` (out and
   lse), ``flash_dq`` and ``flash_dkdv`` against
   ``flash_forward_reference`` / ``flash_backward_reference`` at every S
   in 1, 17, 64, 128, 255, 512, 1000, (B, H) in {(1, 1), (2, 3)}, D in
   {16, 20, 40, 64, 128} (20: rows not 16-byte aligned, loaded element
   by element; 40: not a multiple of the 16-wide k step), float32 (the
   CUDA-core kernels) and bfloat16 (the tensor-core kernels), causal and
   not; then the
   ``flash_attention`` autograd function's gradients against autograd
   through ``dense_attention`` at S = 256 in float32;
6. flash at the training shape (B=4, H=12, S=4096, D=64, bf16, causal
   and not): each kernel against its plain version on the same inputs
   (the errors join the kernel's ``max_abs_err``; the share of elements
   that differ at all is printed), then its device time (beside PERF.md's
   earlier one),
   achieved TFLOP/s and percentage of its bound beside its plain
   version's,
   ``F.scaled_dot_product_attention``'s forward and backward on the same
   tensors (the yardstick only: the port never calls it) and its bound;
7. full-width training — ``train_mlm`` at ``BERT_BASE`` widths in
   bfloat16, S = 4096, batch 4, dropout 0.1, 8 steps with a held-out
   eval at steps 4 and 7: the loss must be finite, the forward kernel
   launched 12 x (train steps + eval forwards) times and dq, dk/dv 12 x
   train steps;
8. cross-check — float32, 2 layers at full width, S = 512, B = 2,
   dropout 0, three train steps with ``attention="flash"`` and with
   ``"dense"``: loss, gradients and parameters must agree;
9. fused kernels — ``layer_norm_forward`` and ``online_logsumexp``
   against their plain versions: the LayerNorm at N in {1, 7, 4096} on
   both of its routes, each case's route held and logged — the
   warp-per-row kernel at F in {16, 768, 1000, 1024} and bf16's 2048
   (its widest rows), the general CTA-per-row kernel at F = 1001, one
   16-byte vector past the widest row (and float32's 2048) and a view
   one element off alignment — plus float32 rows of 64 + randn; the
   logsumexp at V in {1, 511, 30522} with logits of +-1e4; float32 and
   bfloat16; ``softmax_cross_entropy``'s gradient against autograd
   through the plain version; then their device times at (4096, 768)
   and (16384, 768) bf16 and (4096, 30522) float32 beside ``F.layer_norm``
   / ``torch.logsumexp`` (yardsticks only), the bound and the
   LayerNorm's earlier time.  No path runs these two kernels (the JAX
   package's models do not call them either), so their main-path
   launches are 0;
10. the zero-flag CNN trainer (the reference's own job; no hand kernel
   lies on it) — 10a: ``MnistCnn``, dropout 0, 20 train steps over the
   first batches of the synthetic train split, float32 and bf16, each
   step on the card from the CPU's state before it: the loss and the
   gradient (the median over the steps of the largest relative
   difference) within ``CNN_TOL`` of the CPU's, and a control at the
   wrong precision (TF32 on; bf16 against float32) outside it; 10b:
   ``cli.main(["--data-dir", "build/mnist"])`` as ``python -m
   mpi_tensorflow_torch`` runs it (synthetic MNIST, 2 epochs of batch 64,
   1562 steps, 32 trace lines at t = 50, 100, ..., 1550, 1561, the 10 000
   test rows in 157 windows): the trace in the reference's format, a
   finite loss, a final test error below 30 % and no higher than the
   first trace point's, the card named in the result; images/sec, step
   ms, MFU and the test-error history printed beside the card's name and
   power limit (the bf16 epoch that followed is cut for the script's
   time: 10a holds bf16 steps, 13e times them); 10c: every hand
   kernel's launch count (paged, flash, fused) set to 0 before 10b and
   still 0 after it (its bench lines: 13e);
11. the data axis over ``torch.distributed`` (no hand kernel lies on it;
   each case runs in processes of its own, through ``torchrun`` or the
   bench, with this file as the worker: ``chip_smoke.py --worker NAME
   BACKEND``) — 11a: NCCL at world size 1 (the machine has one card):
   ``torchrun --nproc_per_node 1 -m mpi_tensorflow_torch --epochs 1``,
   781 steps, 16 trace lines in phase 10's format and cadence, final
   error < 30 % and <= the first, images/sec and step ms beside 10b's;
   then 20 psum steps of ``MnistCnn`` (dropout 0,
   float32, cuDNN's deterministic algorithms), each from a common state,
   across the ranks against the plain step: loss and gradient within
   ``CNN_TOL``, bit-equality printed beside the plain step's own
   repeatability, and a profiled step of each (kernels, device ms, the
   collective's ms); 11b: two ranks on ``cuda:0`` over gloo (a
   check-only world: NCCL refuses two ranks on one card) — the same 20
   psum steps against the in-process two-shard step, within ``CNN_TOL``;
   then ``--sync avg50 --epochs 1`` through ``cli.main`` in both ranks,
   390 steps, 8 trace points of 2 lines, every average watched: the
   replicas apart before it, bit-identical after it, and within 1 ulp of
   the mean of the gathered replicas; final error < 30 % and <= the
   first (both worlds side by side with 13d's three); 11c: ``python -m
   mpi_tensorflow_torch.bench --mode allreduce`` (a world of one over
   NCCL: a launch and a copy on the card, not a link), its line printed
   (run through ``bench.main`` in 13e's bench child);
12. data-parallel BERT-base MLM training (``train.gspmd`` across the
   ranks; each case in processes of its own, as in phase 11) — 12a: NCCL
   at world size 1, ``cli.main`` in a torchrun rank as ``torchrun
   --nproc_per_node 1 -m mpi_tensorflow_torch --model bert_base
   --seq-len 4096 --batch-size 4 --precision bf16`` runs it, at phase
   7's 8 steps and trace points, plain and with ``--grad-accum 2``: each
   flash kernel's launches counted from 0 (12 layers x steps x
   microbatches, the forward's eval forwards too), a finite loss, the
   reference's trace and ``[timing]`` lines; tokens/s, step ms, MFU,
   peak GiB and bytes at rest beside phase 7's; then the step across the
   one rank against the one-process step (float32, 2 layers at full
   width, S = 512 with the flash kernels, 3 steps from the seed-0
   state) within ``DP_TOL``, bit-equality printed; 12b: two ranks on
   ``cuda:0`` over gloo, the same 3 steps in each layout of
   ``DP_CASES`` (replicated, ``grad_accum`` 2, zero1, fsdp), each rank
   feeding its rows of every global batch, against the one-process step
   on the global rows and (zero1, fsdp) against replicated, within
   ``DP_TOL``; each rank's bytes at rest: zero1's moments and fsdp's
   parameters + moments 0.50-0.51 of a replica's, every leaf that stays
   whole under 1024 elements; 12c: the bench's transformer lines run
   under ``torchrun --nproc_per_node 1`` in 13e's child, each joining
   the launcher's world over NCCL (recorded and checked there).

13. ResNet-20 and ResNet-50 training (no hand kernel lies on it: conv,
   pool, BatchNorm and the fc are PyTorch's) — 13a: single float32
   steps on the card (TF32 off, cuDNN's deterministic algorithms), 5 of
   ResNet-20 at batch 128 and 2 of ResNet-50 at batch 4 x 224x224, each
   from the CPU's state before it: loss, gradient and new BatchNorm
   state within the model's ``RESNET_TOL`` of the CPU's step, and the
   control with TF32 on outside the gradient's and the state's bounds;
   in bf16 (``RESNET_BF16_EVAL_TOL``, ``RESNET50_FIT_*``) each model's
   evaluation-mode logits within 2^-5 x max|logit| of the card's
   float32 logits (the training-mode forward, the control, outside),
   and ResNet-50's bf16 step descending on its batch: 8 steps on one
   batch of 8 bring its cross-entropy to at most half its start, while
   8 steps on another batch (the control) do not;
   13b:
   ``cli.main`` as ``python -m mpi_tensorflow_torch --model resnet20
   --dataset cifar10 --batch-size 128`` runs it (the synthetic CIFAR-10,
   1 epoch, 358 steps, trace every 50), fp32 and bf16, and ``--model
   resnet50 --dataset imagenet_synthetic --num-classes 1000 --batch-size
   64 --log-every 10`` (1 epoch, 29 steps), bf16 (its fp32 epoch is cut
   for the script's time: 13e times its fp32 step): the trace in
   the reference's format, the ``[timing]`` line, a finite loss, and
   for ResNet-20 a final test error no higher than the first trace
   point's (ResNet-50's, at chance on 1000 synthetic classes, printed);
   images/s, step ms, MFU and peak GiB printed beside the
   card's name and power limit; 13c: every hand kernel's launch count 0
   before 13b and still 0 after it (the ``launches_resnet`` of the
   kernels line); 13d: ResNet-20 fp32 psum through ``torchrun
   --nproc_per_node 1 -m mpi_tensorflow_torch`` (``cli.main`` joins
   the launcher's world over NCCL, recorded) on 14b's 13 000 rows (93
   steps, a trace every 10, cuDNN deterministic; its full epoch is cut
   for the script's time, 13b runs it without a world): the trace in
   the reference's format, the error not rising, and 14b holds the
   trace to its own run's without a world; two ranks on ``cuda:0`` over
   gloo: 3 psum steps
   against the in-process two-shard step (parameters and BatchNorm
   state within ``RESNET_DP_TOL``), and an avg50 run (the first 13 000
   rows, 46 steps, 4 averages) with every average watched: replicas
   (their BatchNorm statistics too) apart before it, bit-identical
   after it, within 1 ulp of the gathered mean (the three worlds run
   beside 11b's); 13e: the bench's
   one-card lines, ``torchrun --nproc_per_node 1 -m
   mpi_tensorflow_torch.bench --mode train`` through ``bench.main`` in
   one child process under torchrun (``--worker bench_lines``, no
   profiler session before it; each transformer line joins the
   launcher's world over NCCL, each image line none, and the image
   lines run first): the CNN (200 timed steps), ResNet-20 (30) and
   ResNet-50 (8), fp32 and bf16, BERT_BASE at S = 4096 bf16 (10), each
   line printed.
14. the trainers' long-run services (no kernel is added; 14c runs the
   flash kernels) — 14a: 13b's ResNet-50 bf16 trainer, ResNet-20 fp32
   and the CNN through ``cli.main``, each with ``--prefetch`` off, then
   thread, in a process of their own (no ``torch.profiler`` session
   before them; cuDNN's deterministic algorithms in all), the trace
   lines identical in every run, images/s and step ms of each run
   printed; then, in that process, ``bench --mode hostio`` with
   ResNet-50's thread rate as the card's demand; 14b:
   ResNet-20 fp32 psum through ``cli.main`` on 13d's 13 000 rows (93
   steps, a trace every 10; cuDNN deterministic) with
   ``--checkpoint-dir`` and ``--metrics-dir``, stopped by
   ``request_stop`` after step 25 and
   ``--resume``d: the trace lines and the final parameters, velocity and
   BatchNorm state the uninterrupted run's (bit-equal when two
   uninterrupted runs are, else within twice their distance), the
   metrics' tags; the checkpoint's bytes, the ``save_async`` stalls and
   the restore's ms printed; 14c: phase 7's BERT_BASE bf16 run (S = 4096,
   batch 4, 8 steps) uninterrupted, then stopped at its trace point 4
   (the checkpoint queued there, the stop agreed) and resumed in a fresh
   ``train_mlm``: the trace and losses the uninterrupted run's, the
   parameters within 1e-5, each flash kernel's launches in the resumed
   run counted from 0 (the ``launches_resumed`` of the kernels line);
   the checkpoint's GiB, save and restore ms printed; 14d: zero1 and
   fsdp checkpoints of ``dp_bert_cfg`` after 2 steps on two gloo ranks
   on ``cuda:0`` (each rank its slices; that world runs beside 12b's),
   each restored at world 1 in this process and, at once, at world 1
   over NCCL (torchrun), the third step within ``DP_TOL`` of the
   uninterrupted one-process step.
16. (run right after 4, before any ``torch.profiler`` session: 15 and
   then phase 2's timing follow it) the serving fleet (``serving/router``,
   ``recovery``, ``tracing``, ``tp``), each fleet run's paged-kernel
   launches counted from 0 and equal to layers x forward dispatches
   summed over the replicas, every request ``ok`` — 16a: two replicas of
   phase 3's engine on ``cuda:0`` (one CUDA stream each, the model
   shared), phase 3's trace sequentially: tokens/s, p50, p99 and
   ``speedup_vs_single_replica`` beside phase 3's run (the threaded run
   at full width, a thread a replica, is cut for the script's time: the
   float32 check runs both modes); then float32, 2 layers at full
   width, 6 requests at once: the
   fleet's tokens (both modes) == the single engine's; 16b: that check
   with a transient fault at replica 0's tick 3 (outputs == the
   unfaulted fleet's, one failover, the replica probed back to
   ``healthy``) and with a permanent one (``dead``, every request still
   served); 16c: a child ``python -m mpi_tensorflow_torch.bench --mode
   serving --precision fp32 --requests 8 --arrival-rate 8
   --serve-journal`` SIGKILLed once its journal holds 8 token records,
   relaunched on the journal: its outputs == an unfaulted run's; 16d:
   phase 3's trace through a traced fleet (tokens/s beside 16a's
   untraced sequential run: the tracer's cost; every span's phases sum
   to its wall time within 1e-6 s; the Chrome trace parses, one pid a
   replica), and 16a's float32 check traced: the untraced tokens; 16e:
   16a's float32 check through a tensor-parallel engine, ``torchrun
   --nproc_per_node 2 chip_smoke.py --worker tp_serve gloo`` (two gloo
   ranks on ``cuda:0``; NCCL refuses two ranks on one card) and at
   world 1 over NCCL: the single engine's tokens, the pools at H / tp
   heads, launches == layers x dispatches on rank 0.
17. (after 15, before phase 2's timing and any ``torch.profiler``
   session) decoding and the serving bench's remaining arms — 17a:
   float32, 2 layers at full width: ``generate`` with top_k = 1 ==
   greedy == the paged engine's tokens (launches == layers x
   dispatches), ``beam_search`` with 1 beam == greedy, and 4 beams'
   scores == a full-forward rescoring within ``BEAM_RESCORE_TOL``;
   17e (beside 17a): two tensor-parallel replicas behind the router,
   journaled, ``torchrun --nproc_per_node 2 chip_smoke.py --worker
   tp_fleet gloo`` on ``cuda:0``: the tp 1 engine's float32 tokens on
   the arms' trace, launches == layers x dispatches summed over the
   replicas; 17b: ``bench --mode decode`` (``measure_decode``) at
   ``BERT_BASE`` bf16, batch 8, prompt 32, 128 new tokens, greedy and 4
   beams, the slope not degenerate (``DECODE_ITERS`` timed pairs a
   length, a cut of the bench's 5); 17c: the static-batch arm on phase
   3's engine and trace, ``speedup_vs_static``; 17d (check only, nothing
   of it timed): ``--serve-kernel-ab``, ``--serve-kv-ab`` (int8),
   ``--serve-spec-ab`` (ngram) and ``--serve-mixed-ab`` through
   ``harness.measure_serving`` in float32 at 2 layers on ``ARMS_TRACE``
   (a cut of phase 3's trace): the tokens identical where the reference
   holds them so (cuda == gather, speculation and mixed batching ==
   off), every arm's paged launches == layers x its dispatches (0 on
   gather); 17f, the spec and mixed arms timed at full width, is cut
   for the script's time (15c and 15d time the same comparisons at
   phase 3's setup);
18. gpt_base next-token training — 18a: phase 6's causal kernels at
   the training shape logged beside SDPA's causal forward and backward
   (their bound at half the product flops); 18b: phase 8's check for
   ``TrainableCausalLm`` (flash against dense, both causal); 18c:
   ``train_mlm`` with ``model="gpt_base"`` at phase 7's shape (BERT_BASE
   bf16, S = 4096, batch 4, 8 steps): losses finite and falling (the last
   two steps' mean below the first's), the flash launches as phase 7's
   (the causal mode), tokens/s, MFU (every position through the head)
   and peak GiB printed.
19. The rest of transformer training (after 18): 19a phase 8's check
   for ``MoeBertMlm`` and ``EncDecLm``; 19b remat ``full`` and ``dots``
   against remat off at dropout 0.1 (fp32, 2 layers, flash forced, 3
   steps, BERT and enc-dec) and one fp32 ResNet-20 step (cuDNN
   deterministic), each bit-equal; 19c ``train_mlm`` with
   ``moe_bert`` at phase 7's shape (flash launches as phase 7's, losses
   finite, the dropped share of the last forward); 19d ``encdec_t5`` at
   S = T = 4096 with remat (the encoder's bidirectional and the
   decoder's causal flash calls counted, each forward twice a step, its
   loss falling); 19e config 5 with remat ``full`` and ``dots``; 19f
   config 5 with LAMB under warmup-cosine; 19g ``python -m
   mpi_tensorflow_torch --model bert_base --text-file F --vocab-file
   V`` on a corpus and vocabulary written here.  Each run's step ms,
   tokens/s, MFU and peak GiB printed beside phase 7's; the ``kernels``
   line's flash rows gain ``launches_moe``, ``launches_encdec``,
   ``launches_remat`` and ``launches_lamb``.
20. ViT and the reference bench's levers (20e right after 17, on phase
   3's engine; 20a-d after 14, the profile last) — 20a: ``VIT_TINY_CIFAR``
   at batch 128, float32, ``VIT_STEPS`` image steps each on the card
   from the CPU's state, the loss and the whole update within
   ``VIT_TOL`` (a few times the CPU's own distance from float64,
   ``scripts/torch_vit_conditioning.py``), TF32 on outside it; bf16
   evaluation logits within ``VIT_BF16_EVAL_TOL`` of the card's float32
   by |bf16 - float32| / |float32| (twice the CPU's own bf16 distance,
   2.27e-2), and the control, every parameter through float8 e4m3
   first, outside it;
   remat on bit-equal to off at dropout 0.1; 20b: ``cli.main`` with
   ``--model vit --dataset cifar10`` on 13 000 rows (93 steps, the
   reference's trace lines; errors printed, not held: the reference's
   ViT stays at chance), no hand kernel launched (``launches_vit``),
   the bench's ViT lines fp32 and bf16 (13e's child), and a profiled
   window of each precision (idle share); 20c: config 5's bench line
   with ``--fused-qkv``, ``--params-bf16`` and ``--ce chunked`` beside
   the plain one (flash launches 12 x the steps each line launched,
   ``bench_steps_launched``), phase 8's check of fused
   against three products, and ``--params-bf16``'s live parameters ==
   its masters cast after each of 3 steps; 20d: BERT_BASE bf16 at S =
   1024, batch 16, at the default ``flash_min_seq`` (dense, no flash
   launch) and at 0 (flash launches 12 x its steps): tokens/s of each;
   20e:
   ``--serve-queue-depth 1 --serve-deadline-ms 3000
   --serve-max-evictions 3 --serve-failover-backoff-ms 75``, then
   ``--serve-drain-ms 300`` with a stop at 3 s, each through the
   harness's parser and ``harness.build_serving`` at phase 3's cell
   (its trace; the engine's policy the flags') on a virtual clock:
   every status counted (shed, ``deadline_exceeded`` and ``drained`` >
   0 where their flag is set), paged launches == layers x dispatches.
   Cut for this phase's time: 10b's bf16 epoch, 13b's ResNet-50 fp32
   epoch, 13d's torchrun ResNet-20 epoch (93 of its 358 steps run), 16a's
   threaded fleet at full width and 17f (the spec and mixed arms timed
   at full width), each noted where it ran.
21. The scanned arm (right after 20e; every trainer, bench train line,
   evaluation, all-reduce chain and decode call of the phases above
   already runs as CUDA graph replays, the bench lines' flash launches
   counted through them) — 21a: K graphed steps of
   ``step.make_multi_train_step`` / ``gspmd.make_multi_step`` against K
   eager steps of the same function from the same seeded state, bit for
   bit (or within a second eager run's distance, where they differ;
   cuDNN deterministic, TF32 off): the CNN with dropout, ResNet-20 with
   its BatchNorm state, ViT fp32 and bf16, config 5 at S = 4096 with
   remat ``full`` and dropout (the flash kernels in the graph), gpt_base
   causal, the MoE and the enc-dec family (S = 1024, ``flash_min_seq``
   0); the graphed runs' flash launches (``launches_graphed``); 21b
   (right after 10b, whose run it reuses, under cuDNN's deterministic
   algorithms): the zero-flag trainer, graphed windows against
   ``--fused-steps 1``: 32 identical trace lines and an identical state;
   21c: 14b's stop,
   asked for inside a graphed window, checkpointed at the window's end
   and resumed; 21d: ``generate`` greedy and sampled, ``beam_search`` of
   4 and the enc-dec ``generate``, each a graph replay, against their
   eager loops, tokens identical; 21e-f (run alone, not by ``main``:
   ~120-160 s, past this script's time; ``python3 -c "import chip_smoke
   as c; c.scan_timing_phase(c.card_line())"``, a child process of its
   own): graphed against eager step times (CNN, ResNet-20, ResNet-50
   bf16, ViT fp32 and bf16, config 5 and BASELINE's config 5 shape,
   batch 64 at S = 128, K = 4), decode per-token ms by the bench's
   slope, the all-reduce chain in a world of one over NCCL, each with
   its idle share from a profiled window.
22. Tensor and sequence parallelism (the ``model`` and ``seq`` mesh
   axes), in check-only worlds of ranks on ``cuda:0`` over gloo (NCCL
   refuses two ranks on one card) started beside 12b's — 22a: float32,
   2 layers at full width (E 768, H 12), S = 512, global batch 2, 3
   steps from the seed-0 state against the one-process step within
   ``DP_TOL``: two ranks on ``{model: 2}``, ``{seq: 2}`` ring,
   ``{seq: 2}`` Ulysses with ``attention="flash"`` (the kernels on 6
   heads at the full S) and gpt_base on ``{seq: 2}`` ring; four ranks on
   ``{model: 2, seq: 2}``, ring and Ulysses; each rank's flash launches
   (2 layers x 3 steps on the Ulysses and model paths, 0 on a ring);
   22b: config 5 (BERT_BASE bf16, S = 4096, batch 4, dropout 0.1)
   through ``train_mlm`` on two ranks, ``{seq: 2}`` Ulysses, ``{seq: 2}``
   ring and ``{model: 2}``: 3 steps and one eval, finite losses, each
   rank's flash launches == 12 x (steps + evals) forwards and 12 x steps
   backwards (0 on the ring), each rank's peak GiB beside phase 7's, the
   leaves every rank holds whole identical over the ranks (dropout keyed
   on the data x seq index), and a dropout-0 first step against the
   one-process step (first moments within 5e-2 relative; the next
   batch's one-process step, the control, outside it).  Step times there
   are host-staged gloo transfers, not a link.

Prints one ``kernels`` JSON line, then the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a card it
prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): memory bandwidth, and the
# operation rate per dtype — bf16 on the tensor cores, float32 outside
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

H, D, BS = 12, 64, 16                    # BERT_BASE heads, head dim, block
POISON = 1e30
# kernel vs plain version: float32 sums in another order (~1e-6 seen);
# bfloat16 adds one rounding of the output (2^-8 relative) and of each
# probability before P.V, so allow 1e-2 absolute + 1e-2 relative
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 1e-2)}


# The kernels' earlier device ms at the shapes the phases below time,
# from PERF.md's table (NVIDIA H100 80GB HBM3, 700 W): the paged kernel's
# sequential walk, the flash forward on the CUDA cores and the LayerNorm's
# CTA-per-row kernel at (4096, 768) bf16, before their current designs;
# dq and dk/dv in their current design.
PREVIOUS_MS = {
    "paged_attention": 0.0468, "int8": 0.0381, "int4": None,
    "int4_res": 0.0439,
    ("flash_fwd", False): 9.774, ("flash_fwd", True): 5.415,
    ("flash_dq", False): 1.4786, ("flash_dq", True): 0.8455,
    ("flash_dkdv", False): 2.2676, ("flash_dkdv", True): 1.3155,
    "layer_norm": 0.0151, "logsumexp": None,
}


def previous_ms(key) -> str:
    ms = PREVIOUS_MS[key]
    return ("" if ms is None else
            f" (PERF.md's earlier run: {ms} ms)")


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()


def phase(name: str) -> None:
    """Log where the script stands: the phase that begins and the
    seconds since the script started (the run has a time limit)."""
    log(f"[phase] {name} begins at {time.perf_counter() - _T0:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def host_line() -> str:
    """The host: its CPU (``/proc/cpuinfo``'s model name, or its
    implementer and part codes where there is none), the cores this
    process may use, and the ms a fixed pure-Python loop takes here.  The
    script's time follows the host (the trainers' steps are host-paced),
    so each run records the host it had."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    cpu = fields.get("model name") or (
        f"implementer {fields.get('CPU implementer', '?')} part "
        f"{fields.get('CPU part', '?')}")
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    loop_ms = 1e3 * (time.perf_counter() - t0)
    return (f"{platform.machine()} {cpu}; {len(os.sched_getaffinity(0))} "
            f"of {os.cpu_count()} cores usable; a 2e6-step Python loop "
            f"{loop_ms:.1f} ms")


# ---------------------------------------------------------------- phase 1

def build() -> None:
    from mpi_tensorflow_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {sorted(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "smem", "Performance Loss")):
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 2

def paged_case(rng, B: int, NB: int, S: int, dtype, dev, H=H, D=D,
               lens=None):
    """Rows cycle through a full table and a ragged partial table with a
    null-block tail; row 1 starts at length 0 (a first prefill chunk);
    with B > 2 the last row is bucket slack (all-null table, length 0).
    ``lens`` instead gives the first rows' lengths (the rest are slack).
    The null block and every lane past a row's length + S hold 1e30, so
    a masking error shows as a huge error, not a small one."""
    nblocks = 1 + B * NB
    kp = rng.normal(size=(nblocks, H, BS, D)).astype(np.float32)
    vp = rng.normal(size=(nblocks, H, BS, D)).astype(np.float32)
    bt = np.zeros((B, NB), np.int32)
    lens_given, lens = lens, np.zeros((B,), np.int32)
    live_rows = []
    nxt = 1
    for b in range(B):
        if lens_given is not None:
            if b >= len(lens_given):
                continue
            lens[b] = lens_given[b]
        elif b == B - 1 and B > 2:
            continue
        elif b == 1:
            lens[b] = 0
        elif b % 2 == 1:
            lens[b] = int(rng.integers(0, (NB - 1) * BS - S + 1))
        else:
            lens[b] = NB * BS - S
        n = max(1, -(-(int(lens[b]) + S) // BS))
        bt[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
        live_rows.append(b)
    kp[0] = vp[0] = POISON
    for b in live_rows:
        for j in range(NB):
            if bt[b, j]:
                first_dead = max(0, int(lens[b]) + S - j * BS)
                kp[bt[b, j], :, first_dead:] = POISON
                vp[bt[b, j], :, first_dead:] = POISON
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)

    def put(a, dt=None):
        t = torch.from_numpy(a).to(dev)
        return t.to(dt) if dt is not None else t

    return ((put(q, dtype), put(kp, dtype), put(vp, dtype), put(bt),
             put(lens)), live_rows)


# Rows whose lengths put the kernel's edges in play, and a bucket-slack
# row after them: live lengths that are not a multiple of bs (37 + S,
# 5 + S, 47 + S), at S = 1 one live block (length 0, and 15: the query's
# own column on the block's last lane), the query's own column on a
# block's first lane (16), and at S = 8 chunks that cross a block
# boundary (12, 15) -- there each early query's own column lies in a
# block before the last.
EDGE_LENS = (37, 0, 15, 16, 5, 12, 47)
# query widths that are not powers of two (the verify dispatch is 5 wide)
ODD_WIDTHS = (3, 5, 6)
# BERT_BASE's heads on one rank under tp 2 and 4 (phase 16e)
TP_HEADS = (H // 2, H // 4)
EDGE_SHAPES = [(S, len(EDGE_LENS) + 1, 8, H, D) for S in (1, 8)]


def check_kernel(dev) -> dict:
    """Kernel vs plain version at every serving shape (BERT_BASE heads,
    and BERT_TINY's H=4, D=16 at a few S) and at the edge rows; returns
    the max absolute error per dtype."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

    rng = np.random.default_rng(0)
    shapes = [(S, B, NB, H, D, None) for S in (1, 2, 4, 8, 16, 32, 64)
              for B, NB in ((1, 16), (8, 32))]
    shapes += [(S, 8, 8, 4, 16, None) for S in (1, 8, 64)]
    # widths that do not divide the kernel's 8-query tile: speculation's
    # verify dispatch (draft_k + 1 = 5) and mixed rows' chunks
    shapes += [(S, 8, NB, h, d, None) for S in ODD_WIDTHS
               for NB, h, d in ((32, H, D), (8, 4, 16))]
    # a tensor-parallel rank's head shard of BERT_BASE: H / 2 and H / 4
    shapes += [(S, 8, 16, h, D, None) for h in TP_HEADS for S in (1, 5, 16)]
    shapes += [(*shape, EDGE_LENS) for shape in EDGE_SHAPES]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        worst[dtype] = 0.0
        for S, B, NB, h, d, lens in shapes:
            args, live = paged_case(rng, B, NB, S, dtype, dev, h, d, lens)
            got = pk.paged_attention_kernel(*args)
            torch.cuda.synchronize(dev)
            want = pk.paged_attention_reference(*args)
            g = got[live].float()
            w = want[live].float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"non-finite kernel output: {dtype} "
                                     f"S={S} B={B} H={h} D={d}")
            err = (g - w).abs()
            worst[dtype] = max(worst[dtype], float(err.max()))
            if bool((err > atol + rtol * w.abs()).any()):
                raise AssertionError(
                    f"kernel disagrees with its plain version: {dtype} "
                    f"S={S} B={B} NB={NB} H={h} D={d} "
                    f"max|err|={float(err.max())} "
                    f"(tolerance {atol} + {rtol}*|want|)")
        log(f"[kernel] {str(dtype)[6:]}: max|kernel - plain| = "
            f"{worst[dtype]:.3e} over {len(shapes)} shapes: S=1..64 and "
            f"{ODD_WIDTHS}, B in (1, 8), H={H} D={D}, H=4 D=16, the head "
            f"shards H in {TP_HEADS} at S in (1, 5, 16), and the edge rows "
            f"{EDGE_LENS} at S in (1, 8) (tolerance {atol} abs + {rtol} "
            f"rel)")
    return worst


def bound(nbytes: int, ops: float, dtype) -> tuple:
    """The least time the card could take: bytes over the memory rate or
    operations over the dtype's peak, whichever is longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wall_ms(fn, inputs, reps: int) -> float:
    """Mean time per call of ``fn(*x)``, back to back, over ``reps``
    passes through ``inputs`` (CUDA events around the whole loop, after
    a warm pass): device time, or the host's launch time where that is
    longer."""
    for x in inputs:
        fn(*x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for x in inputs:
            fn(*x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(inputs))


# calls that keep the card busy this long are timed by CUDA events alone
LONG_CALL_MS = 0.2


def device_ms(fn, inputs, reps: int, kernels_per_call=None) -> float:
    """Mean device time per call of ``fn(*x)`` over ``reps`` passes
    through ``inputs``.  Rotating through input sets larger than the
    50 MB L2 finds every set's data cold, as the model finds each
    layer's.

    A call of ``LONG_CALL_MS`` or more keeps the card busy while the
    host queues the next, so CUDA events around the back-to-back passes
    (``wall_ms``) read the card's busy time; ``torch.profiler`` is not
    used for those (on an H100 that had profiled for minutes it recorded
    one of every three 10 ms launches of a pass).  A shorter call is
    timed by the durations of the kernels it launched, from
    ``torch.profiler`` (after a pass the profiler records and discards,
    ``profiled_kernels``), which leaves out the host's launch gaps.
    ``kernels_per_call``: the number of kernels one call launches,
    checked against the kernels recorded.  A recording that holds no
    device time or the wrong number of kernels is taken again, up to
    three times in all.  After the third, a one-kernel call whose last
    recording kept some of its launches and lost the rest is timed by
    the mean of those it kept (each is one whole call); any other call
    falls back to the CUDA-event time, which holds the host's launch
    gaps.  The log says which."""
    from mpi_tensorflow_torch.utils.profiling import profiled_kernels

    event_ms = wall_ms(fn, inputs, reps)
    if event_ms >= LONG_CALL_MS:
        return event_ms

    def one_pass():
        for x in inputs:
            fn(*x)

    def measured():
        for _ in range(reps):
            one_pass()

    calls = reps * len(inputs)
    for attempt in range(3):
        kernels = profiled_kernels(one_pass, measured)
        us = sum(e.time_range.end - e.time_range.start for e in kernels)
        if us > 0 and (kernels_per_call is None
                       or len(kernels) == kernels_per_call * calls):
            return us / 1e3 / calls
        log(f"[profiler] recording {attempt + 1} of 3 held {len(kernels)} "
            f"kernels ({us} us) for {calls} calls; recording again")
    if kernels_per_call == 1 and 0 < len(kernels) < calls and us > 0:
        log(f"[profiler] no full recording: {us / 1e3 / len(kernels):.4f} "
            f"ms per call, the mean of the {len(kernels)} of {calls} "
            f"launches the last recording kept (CUDA events: "
            f"{event_ms:.4f} ms with the launch gaps)")
        return us / 1e3 / len(kernels)
    log(f"[profiler] no full recording: {event_ms:.4f} ms per call from "
        f"CUDA events instead (device time plus launch gaps)")
    return event_ms


def time_decode(dev) -> dict:
    """The decode shape of the serving run: B=8 rows of 160 live tokens
    (10 blocks), a 16-wide table bucket, bfloat16 pools."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
    from mpi_tensorflow_torch.ops.paged_attention import gather_kv

    B, S, NB, live = 8, 1, 16, 160
    dt = torch.bfloat16
    nblocks = 1 + B * NB
    g = torch.Generator(device=dev).manual_seed(0)
    sets, lib_sets = [], []
    for _ in range(12):                  # 12 x 6.3 MB of pools > L2
        q = torch.randn((B, H, S, D), generator=g, device=dev).to(dt)
        kp = torch.randn((nblocks, H, BS, D), generator=g,
                         device=dev).to(dt)
        vp = torch.randn((nblocks, H, BS, D), generator=g,
                         device=dev).to(dt)
        bt = torch.zeros((B, NB), dtype=torch.int32, device=dev)
        nlive = live // BS
        bt[:, :nlive] = 1 + torch.randperm(
            B * NB, generator=g, device=dev)[:B * nlive].view(B, nlive).to(
                torch.int32)
        lens = torch.full((B,), live - S, dtype=torch.int32, device=dev)
        sets.append((q, kp, vp, bt, lens))
        # the library call reads a pre-gathered (B, H, 160, D) view
        lib_sets.append((q, gather_kv(kp, bt[:, :nlive]),
                         gather_kv(vp, bt[:, :nlive])))
    kern = pk.paged_attention_kernel
    before = kern.launches
    ms = device_ms(kern, sets, reps=20, kernels_per_call=1)
    call_ms = wall_ms(kern, sets, reps=20)
    kern.launches = before                # timing is not the main path
    # the plain version is a Python loop of small launches: its time is
    # the wall time of a call
    plain_ms = wall_ms(pk.paged_attention_reference, sets[:2], reps=2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(sdpa, lib_sets, reps=20)
    library_call_ms = wall_ms(sdpa, lib_sets, reps=20)
    esize = torch.finfo(dt).bits // 8
    nbytes = (2 * B * H * S * D * esize            # q in, out
              + 2 * B * H * live * D * esize       # live K and V
              + B * NB * 4 + B * 4)                # table, lengths
    ops = 4 * B * H * S * live * D                 # QK^T and P.V
    bound_ms, bound_by = bound(nbytes, ops, dt)
    log(f"[kernel] decode B={B} S={S} H={H} D={D} live={live} bf16: "
        f"kernel {ms:.4f} ms on the device{previous_ms('paged_attention')} "
        f"({call_ms:.4f} ms per call "
        f"back to back), plain {plain_ms:.4f} ms per call, sdpa on the "
        f"gathered view {library_ms:.4f} ms on the device "
        f"({library_call_ms:.4f} ms per call), bound {bound_ms:.5f} ms "
        f"({bound_by}: {nbytes} B, {ops} ops)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "call_ms": call_ms, "library_call_ms": library_call_ms}


# --------------------------------------------------------------- phase 2b

QUANT_MODES = ("int8", "int4", "int4_res")
QUANT_GROUP = 32                         # the serving default kv_group


def quantize_case(args, mode: str, group: int, gen):
    """Quantize the pools of ``args`` (q, pools, table, lengths on the
    card) for ``mode``: codes and scales from the port's quantizers, then
    every scale of a row that held the 1e30 poison set to 1e30 itself;
    the residual mode
    adds random ``k_new``/``v_new`` in q's dtype.  Returns
    ``(positional args, keyword args)`` of the kernel wrapper."""
    from mpi_tensorflow_torch.ops import paged_attention as ops

    q, kp, vp, bt, lens = args
    quant = (ops.quantize_kv if mode == "int8"
             else lambda x: ops.quantize_kv_int4(x, group))
    kw = {}
    pools = []
    for name, pool in (("k", kp), ("v", vp)):
        codes, scale = quant(pool)
        dead = (pool == POISON).all(-1)              # (N, H, bs)
        scale[dead if scale.ndim == 3 else dead[..., None].expand_as(
            scale)] = POISON
        pools.append(codes)
        kw[f"{name}_scale"] = scale
    if mode == "int4_res":
        kw["k_new"], kw["v_new"] = (
            torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
            for _ in range(2))
    return (q, pools[0], pools[1], bt, lens), kw


def check_kernel_quant(dev) -> dict:
    """The quantized modes against the plain version at phase 2's shapes
    (BERT_BASE heads with g = 32, BERT_TINY's H=4 D=16 with g = 16);
    returns the max absolute error per (mode, dtype)."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [(S, B, NB, H, D, QUANT_GROUP, None)
              for S in (1, 2, 4, 8, 16, 32, 64)
              for B, NB in ((1, 16), (8, 32))]
    shapes += [(S, 8, 8, 4, 16, 16, None) for S in (1, 8, 64)]
    shapes += [(S, 8, NB, h, d, g, None) for S in ODD_WIDTHS
               for NB, h, d, g in ((32, H, D, QUANT_GROUP), (8, 4, 16, 16))]
    shapes += [(*shape, QUANT_GROUP, EDGE_LENS) for shape in EDGE_SHAPES]
    worst = {}
    for mode in QUANT_MODES:
        for dtype in (torch.float32, torch.bfloat16):
            atol, rtol = TOL[dtype]
            worst[mode, dtype] = 0.0
            for S, B, NB, h, d, g, lens in shapes:
                args, live = paged_case(rng, B, NB, S, torch.float32, dev,
                                        h, d, lens)
                args = (args[0].to(dtype),) + args[1:]
                pos, kw = quantize_case(args, mode, g, gen)
                got = pk.paged_attention_kernel(*pos, **kw)
                torch.cuda.synchronize(dev)
                want = pk.paged_attention_reference(*pos, **kw)
                worst[mode, dtype] = max(worst[mode, dtype], check_close(
                    got[live], want[live], atol, rtol,
                    f"paged {mode} {str(dtype)[6:]} S={S} B={B} NB={NB} "
                    f"H={h} D={d} g={g}"))
            log(f"[kernel {mode}] {str(dtype)[6:]}: max|kernel - plain| = "
                f"{worst[mode, dtype]:.3e} over {len(shapes)} shapes: "
                f"S=1..64 and {ODD_WIDTHS}, B in (1, 8), H={H} D={D} "
                f"g={QUANT_GROUP}, "
                f"H=4 D=16 g=16, and the edge rows (tolerance {atol} abs "
                f"+ {rtol} rel)")
    return worst


def time_decode_quant(dev) -> dict:
    """Each quantized mode at phase 2's decode shape (B=8 rows of 160 live
    tokens, a 16-wide table bucket, bfloat16 q), on the pools of the
    fp-mode kernel's own inputs, quantized: device ms beside the fp-mode
    kernel on the same blocks, the plain version, SDPA on a pre-gathered,
    pre-dequantized view (yardstick only) and the memory bound — codes,
    scales, q and out (and the residual lane's k_new/v_new)."""
    from mpi_tensorflow_torch.ops import paged_attention as ops
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

    B, S, NB, live = 8, 1, 16, 160
    dt = torch.bfloat16
    nlive = live // BS
    gen = torch.Generator(device=dev).manual_seed(3)
    fp_sets, sets = [], {m: [] for m in QUANT_MODES}
    lib_sets = {m: [] for m in QUANT_MODES}
    for _ in range(12):                  # 12 x 6.3 MB of bf16 pools > L2
        q = torch.randn((B, H, S, D), generator=gen, device=dev).to(dt)
        kp, vp = (torch.randn((1 + B * NB, H, BS, D), generator=gen,
                              device=dev).to(dt) for _ in range(2))
        bt = torch.zeros((B, NB), dtype=torch.int32, device=dev)
        bt[:, :nlive] = 1 + torch.randperm(
            B * NB, generator=gen, device=dev)[:B * nlive].view(
                B, nlive).to(torch.int32)
        lens = torch.full((B,), live - S, dtype=torch.int32, device=dev)
        fp_sets.append(((q, kp, vp, bt, lens), {}))
        for mode in QUANT_MODES:
            pos, kw = quantize_case(fp_sets[-1][0], mode, QUANT_GROUP, gen)
            sets[mode].append((pos, kw))
            lib_sets[mode].append((q, *(
                ops._gather_kv_dequant(pool, kw[f"{name}_scale"],
                                       bt[:, :nlive], dt)
                for name, pool in (("k", pos[1]), ("v", pos[2])))))
    kern = pk.paged_attention_kernel
    call = lambda pos, kw: kern(*pos, **kw)
    plain = lambda pos, kw: pk.paged_attention_reference(*pos, **kw)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    before = kern.launches
    fp_ms = device_ms(call, fp_sets, reps=20, kernels_per_call=1)
    res = {}
    esize = torch.finfo(dt).bits // 8
    for mode in QUANT_MODES:
        ms = device_ms(call, sets[mode], reps=20, kernels_per_call=1)
        call_ms = wall_ms(call, sets[mode], reps=20)
        plain_ms = wall_ms(plain, sets[mode][:2], reps=2)
        library_ms = device_ms(sdpa, lib_sets[mode], reps=20)
        row = D + 4 if mode == "int8" else D // 2 + 4 * (D // QUANT_GROUP)
        nbytes = (2 * B * H * S * D * esize            # q in, out
                  + 2 * B * H * live * row             # K and V codes+scales
                  + B * NB * 4 + B * 4)                # table, lengths
        if mode == "int4_res":
            nbytes += 2 * B * H * S * D * esize        # k_new, v_new
        ops_n = 4 * B * H * S * live * D
        bound_ms, bound_by = bound(nbytes, ops_n, dt)
        res[mode] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "fp_kernel_ms": fp_ms}
        log(f"[kernel {mode}] decode B={B} S={S} H={H} D={D} live={live} "
            f"bf16 q: kernel {ms:.4f} ms on the device{previous_ms(mode)} "
            f"({call_ms:.4f} ms "
            f"per call back to back), fp-mode kernel on the same blocks "
            f"{fp_ms:.4f} ms, plain {plain_ms:.4f} ms per call, sdpa on "
            f"the gathered, dequantized view {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {nbytes} B, {ops_n} ops)")
    kern.launches = before                # timing is not the main path
    return res


# ---------------------------------------------------------------- phase 3

def serve_features(dev, label: str, *, warm: bool = True,
                   two_turn: bool = False, built=None,
                   watch_tier: bool = False, **kw) -> dict:
    """One serving run through ``build_serving`` (bf16, the CUDA kernel
    unless ``kw`` says otherwise; phases 3 and 15): a warmup replay
    (unless ``warm`` is False), then the replay whose paged-kernel
    launches are counted from 0 and must equal layers x forward
    dispatches, plus the draft model's layers x its feeds under
    draft-model speculation.  Every request must end
    ``ok`` with a full budget of in-vocabulary tokens.  ``two_turn``
    replays ``harness.two_turn_requests`` (prefix v2's follow-up turn).
    ``built`` serves a given ``(engine, trace)`` instead of building
    one from ``kw``; ``watch_tier`` holds every promotion's bytes to
    the block's bytes at its demotion (``TierWatch``).  Returns the
    result with ``launches``, ``prefill_dispatches``, ``draft_feeds``,
    the engine, the trace and the watch."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
    from mpi_tensorflow_torch.serving import harness

    kw = {"precision": "bf16", "kernel": "cuda", **kw}
    engine, trace = built or harness.build_serving(device=dev, **kw)
    watch = TierWatch(engine) if watch_tier else None
    if two_turn:
        turns = harness.two_turn_requests(engine, trace)
        requests = lambda: [dataclasses.replace(r) for r in turns]
    else:
        requests = trace.requests
    if warm:
        engine.run(requests())
    engine.reset()
    prefill = [0]
    impl = engine._prefill_impl

    def counted(*a):
        prefill[0] += 1
        return impl(*a)

    engine._prefill_impl = counted
    drafter = engine.drafter
    feeds0 = getattr(drafter, "feeds", 0)
    torch.cuda.synchronize(dev)
    pk.paged_attention_kernel.launches = 0
    res = engine.run(requests())
    torch.cuda.synchronize(dev)
    launches = pk.paged_attention_kernel.launches
    feeds = getattr(drafter, "feeds", 0) - feeds0
    cfg = engine.model.cfg
    want = cfg.layers * res["forward_dispatches"]
    if feeds:
        want += drafter.model.cfg.layers * feeds
    if launches != want or launches == 0:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"layers x forward dispatches (+ the draft "
                             f"model's layers x feeds) = {want}")
    reqs = requests()
    bad = {i: st for i, st in res["statuses"].items() if st != "ok"}
    if bad or len(res["outputs"]) != len(reqs):
        raise AssertionError(f"{label}: requests not served: {bad}")
    for r in reqs:
        toks = res["outputs"][r.id]
        if len(toks) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{label} request {r.id}: bad output "
                                 f"{toks[:8]}...")
    return {**res, "launches": launches, "prefill_dispatches": prefill[0],
            "draft_feeds": feeds, "engine": engine, "trace": trace,
            "tier_watch": watch}


def serve_full_width(dev, kv_dtype: str = "fp32", warm: bool = True):
    """BERT_BASE, bf16, the CUDA kernel, the bench's default trace, the
    pool in ``kv_dtype``, a warmup replay before the measured one unless
    ``warm`` is False (``serve_features`` with no feature on).  Returns
    ``(launches of the measured run, its result, the engine, the
    trace)``."""
    res = serve_features(dev, kv_dtype, warm=warm, kv_dtype=kv_dtype)
    cfg = res["engine"].model.cfg
    log("[serve] " + json.dumps({
        "layers": cfg.layers, "hidden": cfg.hidden, "heads": cfg.heads,
        "vocab": cfg.vocab_size, "precision": "bf16",
        "kernel": res["kernel"], "kv_dtype": res["kv_dtype"],
        "requests": len(res["statuses"]),
        "tokens": res["tokens"], "elapsed_s": res["elapsed_s"],
        "tokens_per_sec": res["tokens_per_sec"],
        "p50_token_latency_ms": res["p50_token_latency_ms"],
        "p99_token_latency_ms": res["p99_token_latency_ms"],
        "forward_dispatches": res["forward_dispatches"],
        "dispatch_shapes": len(res["dispatch_shapes"]),
        "peak_live_blocks": res["peak_live_blocks"],
        "launches": res["launches"], "device": res["device"]}))
    return res["launches"], res, res["engine"], res["trace"]


# --------------------------------------------------------------- phase 3b

CAPACITY = {"int8": 1.8824, "int4": 3.2}     # 256/136 and 256/80 bytes


@contextlib.contextmanager
def recorded_arms():
    """Every ``harness.control_arm`` result inside the block, in order:
    ``(the timed run's result, its paged launches, the engine)``."""
    from mpi_tensorflow_torch.serving import harness

    orig, arms = harness.control_arm, []

    def control_arm(*a, **kw):
        arms.append(orig(*a, **kw))
        return arms[-1]

    harness.control_arm = control_arm
    try:
        yield arms
    finally:
        harness.control_arm = orig


def check_arm_launches(label: str, block: dict, layers: int) -> None:
    """An A/B block's paged launches == layers x each arm's forward
    dispatches (0 on the gather path)."""
    for arm, n in block["launches"].items():
        want = 0 if arm == "gather" else layers * block[
            "forward_dispatches"][arm]
        if n != want:
            raise AssertionError(f"{label} arm {arm}: paged launches {n} "
                                 f"!= {want}")


def serve_quant(dev, card: str, ref: dict, ref_launches: int, ref_engine,
                trace) -> dict:
    """Phase 3b: the serving bench's ``--serve-kernel-ab`` and
    ``--serve-kv-ab`` at full width: ``harness.kernel_ab_block`` and
    ``kv_ab_block`` on phase 3's engine and timed run ``ref`` (the first
    arm ``measure_serving`` would build and time at these settings), the
    gather path and the int8 pool each served on phase 3's trace after
    its own untimed warmup replay; then the int4 pool (no warmup replay).
    Each quantized run is held against ``ref`` by the ``kv_quant``
    block.  The gather arm's match rate against ``ref`` is printed
    beside them: on random weights greedy tokens part at any rounding
    difference, and that rate is the floor the weights set.  Returns the
    launches per ``kv_dtype`` and the two A/B blocks."""
    from mpi_tensorflow_torch.serving import harness

    layers = ref_engine.model.cfg.layers
    with recorded_arms() as arms:
        kernel_ab = harness.kernel_ab_block(ref_engine, trace.requests, ref,
                                            ref_launches)
        kv_ab = harness.kv_ab_block(ref_engine, trace, trace.requests, ref,
                                    ref_launches)
    (gather, _, gather_engine), (int8, _, int8_engine) = arms
    floor = harness.kv_quant_report(ref, gather, gather_engine, trace)
    runs = {"int8": (int8, harness.kv_quant_report(ref, int8, int8_engine,
                                                   trace))}
    del arms[:], gather_engine, int8_engine
    check_arm_launches("3b kernel_ab", kernel_ab, layers)
    check_arm_launches("3b kv_ab", kv_ab, layers)
    for name, block in (("kernel_ab", kernel_ab), ("kv_ab", kv_ab)):
        log(f"[arms {name}] BERT_BASE bf16, phase 3's trace: "
            + json.dumps(block) + f"; {card}")
    launches = {"int8": kv_ab["launches"]["int8"]}
    for kv_dtype in ("int4",):
        # no warmup replay: phase 3 left nothing to build or grow
        launches[kv_dtype], res, engine, trace = serve_full_width(
            dev, kv_dtype, warm=False)
        runs[kv_dtype] = (res, harness.kv_quant_report(ref, res, engine,
                                                       trace))
        del engine
    for kv_dtype, (res, block) in runs.items():
        log(f"[serve {kv_dtype}] " + json.dumps({
            "tokens_per_sec": res["tokens_per_sec"],
            "tokens_per_sec_ref": ref["tokens_per_sec"],
            "p50_token_latency_ms": res["p50_token_latency_ms"],
            "p99_token_latency_ms": res["p99_token_latency_ms"],
            "p50_token_latency_ms_ref": ref["p50_token_latency_ms"],
            "p99_token_latency_ms_ref": ref["p99_token_latency_ms"],
            "token_match_rate_gather_vs_cuda_same_pool":
                floor["token_match_rate"],
            "kv_quant": block}))
        if block["capacity_multiplier"] != CAPACITY[kv_dtype]:
            raise AssertionError(
                f"{kv_dtype} capacity multiplier "
                f"{block['capacity_multiplier']} != {CAPACITY[kv_dtype]}")
    return {"launches": launches, "kernel_ab": kernel_ab, "kv_ab": kv_ab}


# ---------------------------------------------------------------- phase 4

def cross_check(dev) -> None:
    """fp32, 2 layers at full width: cuda and gather serve identical
    greedy tokens, and both equal the contiguous-cache ``generate``."""
    from mpi_tensorflow_torch.serving.harness import build_serving

    outs = {}
    for kernel in ("cuda", "gather"):
        engine, trace = build_serving(
            num_requests=6, rate_rps=1000.0, prompt_max=32, output_max=16,
            precision="fp32", layers=2, kernel=kernel, device=dev)
        res = engine.run(trace.requests())
        assert res["kernel"] == kernel
        outs[kernel] = res["outputs"]
    if outs["cuda"] != outs["gather"]:
        raise AssertionError(f"cuda and gather tokens differ: "
                             f"{outs['cuda']} vs {outs['gather']}")
    model = engine.model
    for i, prompt in enumerate(trace.prompts):
        p = torch.tensor(np.asarray(prompt)[None], dtype=torch.int64,
                         device=dev)
        ref = model.generate(p, int(trace.outputs[i]))[0, len(prompt):]
        if ref.tolist() != outs["cuda"][i]:
            raise AssertionError(f"request {i}: engine tokens differ from "
                                 f"generate: {outs['cuda'][i]} vs "
                                 f"{ref.tolist()}")
    log(f"[cross-check] fp32, 2 layers, {len(trace.prompts)} requests: "
        f"cuda == gather == generate "
        f"({sum(len(v) for v in outs['cuda'].values())} tokens)")


# --------------------------------------------------------------- phase 4b

def cross_check_quant(dev) -> None:
    """fp32, 2 layers at full width, phase 4's trace, from an int8 and
    from an int4 pool: ``cuda`` and ``gather`` serve identical greedy
    tokens."""
    from mpi_tensorflow_torch.serving.harness import build_serving

    for kv_dtype in ("int8", "int4"):
        outs = {}
        for kernel in ("cuda", "gather"):
            engine, trace = build_serving(
                num_requests=6, rate_rps=1000.0, prompt_max=32,
                output_max=16, precision="fp32", layers=2, kernel=kernel,
                kv_dtype=kv_dtype, device=dev)
            res = engine.run(trace.requests())
            assert (res["kernel"], res["kv_dtype"]) == (kernel, kv_dtype)
            outs[kernel] = res["outputs"]
        if outs["cuda"] != outs["gather"]:
            raise AssertionError(f"{kv_dtype}: cuda and gather tokens "
                                 f"differ: {outs['cuda']} vs "
                                 f"{outs['gather']}")
        log(f"[cross-check {kv_dtype}] fp32, 2 layers, "
            f"{len(trace.prompts)} requests: cuda == gather "
            f"({sum(len(v) for v in outs['cuda'].values())} tokens)")


# --------------------------------------------------------------- phase 15

def feature_line(label: str, res: dict, ref: dict, card: str) -> None:
    """Log a phase 15 run beside phase 3's (``ref``)."""
    log(f"[serve {label}] " + json.dumps({
        "tokens_per_sec": res["tokens_per_sec"],
        "p50_token_latency_ms": res["p50_token_latency_ms"],
        "p99_token_latency_ms": res["p99_token_latency_ms"],
        "tokens_per_sec_phase3": ref["tokens_per_sec"],
        "p50_token_latency_ms_phase3": ref["p50_token_latency_ms"],
        "p99_token_latency_ms_phase3": ref["p99_token_latency_ms"],
        "tokens": res["tokens"], "requests": len(res["statuses"]),
        "forward_dispatches": res["forward_dispatches"],
        "prefill_dispatches": res["prefill_dispatches"],
        "dispatches_per_token": res["dispatches_per_token"],
        "dispatch_shapes": len(res["dispatch_shapes"]),
        "launches": res["launches"], "draft_feeds": res["draft_feeds"],
        "peak_live_blocks": res["peak_live_blocks"],
        "evictions": res["evictions"],
        "prefix": res["prefix"], "speculation": res["speculation"],
        "tier": res["tier"]}) + f"; {card}")


class TierWatch:
    """Wraps an engine's tier hooks (before its ``reset``, which wires
    them into the prefix cache): each demotion keeps a card-side clone
    of the block beside the host copy it made, and each promotion holds
    the block it landed in, byte for byte, to that clone.  So a
    promotion is checked through the whole trip, card to host tensors in
    the pool's dtype and back.  ``checked`` counts the promotions held;
    ``host_dtypes`` the dtypes the host copies were kept in."""

    def __init__(self, engine):
        self.engine = engine
        self.kept = {}
        self.checked = 0
        self.host_dtypes = set()
        fetch, put = engine._demote_fetch, engine._promote_put

        def demote_fetch(block):
            host = fetch(block)
            self.host_dtypes |= {str(t.dtype) for layer in host
                                 for t in layer.values()}
            if any(t.device.type != "cpu" for layer in host
                   for t in layer.values()):
                raise AssertionError("15b: a demoted block left the card "
                                     "for somewhere other than host RAM")
            self.kept[id(host)] = (host, [
                {k: leaf[block].clone() for k, leaf in layer.items()}
                for layer in engine.pools])
            return host

        def promote_put(leaves, block):
            put(leaves, block)
            _host, want = self.kept.pop(id(leaves))
            for layer, saved in zip(engine.pools, want):
                for k, t in saved.items():
                    got = layer[k][block]
                    if not torch.equal(got.view(torch.uint8),
                                       t.view(torch.uint8)):
                        raise AssertionError(
                            f"15b: promoted block {block} leaf {k} differs "
                            f"from its bytes at demotion")
            self.checked += 1

        engine._demote_fetch = demote_fetch
        engine._promote_put = promote_put


class VirtualClock:
    """A run clock that advances ``step_s`` at each reading, for replays
    whose dispatch counts must not depend on how fast the host is."""

    def __init__(self, step_s: float):
        self.step_s = step_s
        self.now = 0.0

    def __call__(self) -> float:
        self.now += self.step_s
        return self.now


# 15c: the engine loop reads the clock three times an iteration, so an
# iteration is 30 ms of virtual time (a BERT_BASE dispatch takes ~18 ms
# on the card: phase 3's 537 in 9.58 s); a longer iteration overlaps
# more requests and so replays in fewer dispatches
MIXED_STEP_S = 0.01
# ... over the trace's first 12 requests (cut for the script's time)
MIXED_VIRTUAL_REQUESTS = 12
# 15d: the draft model's run (a synchronised small forward a drafted
# token) on a 4-request trace of phase 3's spec and seed (cut for the
# script's time)
DRAFT_TRACE = dict(num_requests=4)
# 15d: ngram speculation and its control on a 12-request trace of phase
# 3's spec and seed (cut for the script's time)
NGRAM_TRACE = dict(num_requests=12)


# 15b: a short trace whose follow-up turn meets a pool too small to keep
# turn 1's trie: 12 requests at 32 rps (prompts <= 32, outputs <= 32),
# sequences of up to 128 tokens (8 blocks), 40 blocks for 8 slots
TIER_TRACE = dict(num_requests=12, rate_rps=32.0, prompt_max=32,
                  output_max=32, pool_blocks=40)
# 15e: phase 4's short trace, float32, 2 layers at full width, a 32-token
# shared prompt (two blocks of 16), two slots so later requests find the
# trie filled; the tier arm's pool of 12 blocks cannot keep turn 1's trie
CROSS_TRACE = dict(num_requests=6, rate_rps=1000.0, prompt_max=32,
                   output_max=16, precision="fp32", layers=2,
                   prefix_tokens=32, max_slots=2)
CROSS_SHARED = 32
CROSS_TIER_BLOCKS = 12


def cross_extra_requests(reqs: list, vocab: int) -> list:
    """15e's two requests after ``reqs``: the shared prompt alone (a
    fully cached exact block multiple: its last position is recomputed
    into a shared block, the copy-on-write trigger) and the shared prompt
    + the first 8 tokens of the third block of the last prompt in
    ``reqs`` that fills it + 8 tokens of its own (a mid-block miss:
    prefix v2 copies the 8 matching rows from the trie, where the tier
    arm's recent blocks still are)."""
    from mpi_tensorflow_torch.serving.scheduler import Request

    shared = list(reqs[0].prompt[:CROSS_SHARED])
    long = next(r.prompt for r in reversed(reqs)
                if len(r.prompt) >= CROSS_SHARED + 16)
    own = [int(t) for t in np.random.default_rng(15).integers(0, vocab, 8)]
    arrival = max(r.arrival for r in reqs)
    return [Request(len(reqs), shared, 8, arrival),
            Request(len(reqs) + 1, list(long[:CROSS_SHARED + 8]) + own, 8,
                    arrival)]


def features_cross_check(dev) -> dict:
    """15e: the features against the feature-off run, in float32 on the
    cuda and gather lowerings: prefix + mixed batching (a prefill budget
    below the chunk), prefix + speculation with the target as its own
    drafter, and prefix v2 + the host tier on the follow-up turn through
    a pool too small for turn 1's trie.  Each replays its requests, plus
    ``cross_extra_requests``, on a ``VirtualClock`` (so the schedule,
    and with it every cache decision, is the one the CPU makes).  The
    greedy tokens must be identical across the lowerings and to the
    feature-off ``cuda`` run of the same model (rope under speculation,
    as the harness serves it); every arm must copy-on-write, and the
    tier arm must also copy partial blocks, demote and promote."""
    from mpi_tensorflow_torch.serving.engine import PagedDecodeEngine
    from mpi_tensorflow_torch.serving.harness import (build_serving,
                                                      two_turn_requests)

    arms = {"prefix+mixed": dict(prefix_cache="on", mixed_batch="on",
                                 prefill_budget=32),
            "prefix+self-draft": dict(prefix_cache="on",
                                      speculative="draft-model"),
            "prefix v2+host tier": dict(prefix_cache="on", prefix_gen="on",
                                        kv_tier="host",
                                        pool_blocks=CROSS_TIER_BLOCKS)}
    out = {}
    for name, feat in arms.items():
        engine, trace = build_serving(kernel="cuda", device=dev,
                                      **CROSS_TRACE, **feat)
        model, serve = engine.model, engine.serve
        reqs = (two_turn_requests(engine, trace) if "prefix_gen" in feat
                else trace.requests())
        reqs += cross_extra_requests(reqs, model.cfg.vocab_size)
        requests = lambda: [dataclasses.replace(r) for r in reqs]
        del engine
        draft = model if "speculative" in feat else None
        off = PagedDecodeEngine(model, dataclasses.replace(
            serve, prefix_cache="off", prefix_gen="off", kv_tier="off",
            mixed_batch="off", speculative="off"), device=dev)
        want = off.run(requests(), time_fn=VirtualClock(MIXED_STEP_S))
        want = want["outputs"]
        del off
        for kernel in ("cuda", "gather"):
            engine = PagedDecodeEngine(
                model, dataclasses.replace(serve, kernel=kernel),
                device=dev, draft_model=draft)
            res = engine.run(requests(), time_fn=VirtualClock(MIXED_STEP_S))
            if res["outputs"] != want:
                raise AssertionError(
                    f"15e {name} {kernel}: tokens differ from the "
                    f"feature-off cuda run: {res['outputs']} vs {want}")
            pb, tb = res["prefix"], res["tier"]
            if pb["cow_copies"] < 1 or "prefix_gen" in feat and not (
                    pb["partial_copy_tokens"] > 0 and tb["demotions"] > 0
                    and tb["promotions"] > 0):
                raise AssertionError(f"15e {name} {kernel}: the arm's "
                                     f"copies did not run: prefix {pb}, "
                                     f"tier {tb}")
            out[name, kernel] = {"prefix": pb, "tier": tb,
                                 "speculation": res["speculation"]}
            del engine
        log(f"[cross-check {name}] fp32, 2 layers, {len(want)} requests "
            f"with a {CROSS_SHARED}-token shared prompt, 2 slots: cuda == "
            f"gather == feature off "
            f"({sum(len(v) for v in want.values())} tokens); "
            f"{json.dumps(out[name, 'cuda'])}")
    return out


def feature_phase(dev, card: str, ref: dict, ref_engine, trace) -> dict:
    """Phase 15: the serving features at full width (``BERT_BASE``,
    bf16, the CUDA kernel), each beside phase 3's run ``ref`` (of
    ``ref_engine`` on ``trace``).  15a: the prefix cache on phase 3's
    trace with a shared 64-token system prompt, against the same trace
    with the cache off (hit tokens > 0, fewer prefill dispatches); 15b:
    prefix v2 and the host tier (a follow-up turn, a tight pool:
    demotions and promotions > 0); 15c: mixed batching on phase 3's
    trace (dispatches per token below the mixed-off loop's, both on one
    virtual clock); 15d: ngram and draft-model speculation (the
    acceptance rate printed); 15e: the float32 cross-check.  Returns each
    run's paged kernel launches."""
    launches = {}
    phase("15a")
    # no warmup replays in phase 15 (cut for the script's time): phase 3
    # left nothing to build
    on = serve_features(dev, "prefix", warm=False, prefix_cache="on",
                        prefix_tokens=64)
    off = serve_features(dev, "prefix off", warm=False, prefix_tokens=64)
    feature_line("prefix", on, ref, card)
    # bf16 tokens may part where a request's batch differs (arrivals are
    # wall-clock), so they are counted, not held: 15e holds float32
    same = sum(on["outputs"][i] == off["outputs"][i] for i in off["outputs"])
    log(f"[serve prefix off] the same trace with the cache off: "
        f"{off['prefill_dispatches']} prefill dispatches, "
        f"{off['forward_dispatches']} forward dispatches, "
        f"{off['tokens_per_sec']} tokens/s; {same} of {len(off['outputs'])} "
        f"requests' bf16 tokens identical to the cache-on run")
    if not (on["prefix"]["hit_tokens"] > 0
            and on["prefill_dispatches"] < off["prefill_dispatches"]):
        raise AssertionError(
            f"15a: hits {on['prefix']['hit_tokens']}, prefill dispatches "
            f"{on['prefill_dispatches']} vs {off['prefill_dispatches']} "
            f"with the cache off")
    launches["15a"] = on["launches"]
    del on, off
    phase("15b")
    tier = serve_features(dev, "prefix v2 + host tier", two_turn=True,
                          warm=False, watch_tier=True, prefix_cache="on",
                          prefix_gen="on", kv_tier="host", **TIER_TRACE)
    feature_line("prefix v2 + host tier", tier, ref, card)
    t, watch = tier["tier"], tier["tier_watch"]
    if not (t["demotions"] > 0 and t["promotions"] > 0
            and tier["prefix"]["gen_inserted_blocks"] > 0):
        raise AssertionError(f"15b: tier {t}, prefix {tier['prefix']}")
    if watch.checked < t["promotions"] or \
            watch.host_dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"15b: {watch.checked} promotions held to "
                             f"their demoted bytes of {t['promotions']}, "
                             f"host copies in {watch.host_dtypes}")
    log(f"[serve tier] {t['promotions']} promotions, "
        f"{t['promote_latency_ms_total']} ms of landed host-to-card "
        f"copies in all ({t['promote_latency_ms_mean']} ms each, the "
        f"stream synchronised around each); {watch.checked} promotions "
        f"(discovery, warmup and measured replays) bit-equal to the "
        f"block at its demotion, host copies in "
        f"{sorted(watch.host_dtypes)}; {card}")
    launches["15b"] = tier["launches"]
    del tier
    phase("15c")
    mixed = serve_features(dev, "mixed", warm=False, mixed_batch="on")
    feature_line("mixed", mixed, ref, card)
    launches["15c"] = mixed["launches"]
    # dispatches per token follow the step time on a wall-clock trace
    # (a slower step overlaps more requests), so the two loops are held
    # to each other on phase 3's trace replayed against one virtual
    # clock: the same arrivals for both, whatever each step costs
    virtual = {}
    for arm, engine in (("off", ref_engine), ("mixed", mixed["engine"])):
        engine.reset()
        res = engine.run(trace.requests()[:MIXED_VIRTUAL_REQUESTS],
                         time_fn=VirtualClock(MIXED_STEP_S))
        virtual[arm] = res["dispatches_per_token"]
    log(f"[serve mixed] dispatches per token on the wall clock "
        f"(the card's effect, not held): {mixed['dispatches_per_token']} "
        f"(phase 3, mixed off: {ref['dispatches_per_token']}); the "
        f"host-logic check on a virtual clock of {MIXED_STEP_S * 1e3} ms "
        f"a call: mixed {virtual['mixed']}, off {virtual['off']}")
    if not virtual["mixed"] < virtual["off"]:
        raise AssertionError(f"15c: dispatches per token on the virtual "
                             f"clock {virtual}")
    del mixed
    phase("15d")
    from mpi_tensorflow_torch.serving.engine import PagedDecodeEngine
    from mpi_tensorflow_torch.serving.harness import build_serving

    for mode, trace_kw in (("ngram", NGRAM_TRACE),
                           ("draft-model", DRAFT_TRACE)):
        # no warmup replay: phase 3 left nothing to build or grow, and
        # the draft model's feeds are one forward each.  The control is
        # the same rope model on the same trace with speculation off,
        # served just before
        engine, trace15 = build_serving(precision="bf16", kernel="cuda",
                                        speculative=mode, device=dev,
                                        **trace_kw)
        control = serve_features(dev, f"{mode} control", warm=False, built=(
            PagedDecodeEngine(engine.model, dataclasses.replace(
                engine.serve, speculative="off"), device=dev), trace15))
        del control["engine"]
        spec = serve_features(dev, mode, warm=False,
                              built=(engine, trace15))
        del engine
        feature_line(f"speculative {mode}", spec, ref, card)
        sb = spec["speculation"]
        log(f"[serve speculative {mode}] acceptance rate "
            f"{sb['accept_rate']} ({sb['accepted_tokens']} of "
            f"{sb['draft_tokens']} drafted), {sb['verify_forwards']} "
            f"verify forwards for {sb['emitted_tokens']} tokens; "
            f"{spec['tokens_per_sec']} tokens/s, p50 "
            f"{spec['p50_token_latency_ms']} ms, p99 "
            f"{spec['p99_token_latency_ms']} ms against the control (the "
            f"same rope model and trace, speculation off): "
            f"{control['tokens_per_sec']} tokens/s, p50 "
            f"{control['p50_token_latency_ms']} ms, p99 "
            f"{control['p99_token_latency_ms']} ms, "
            f"{control['forward_dispatches']} forward dispatches against "
            f"{spec['forward_dispatches']}; {card}")
        if not (sb["enabled"] and sb["verify_forwards"] > 0):
            raise AssertionError(f"15d {mode}: {sb}")
        launches["15d " + mode] = spec["launches"]
        launches["15d control " + mode] = control["launches"]
        del spec, control
    phase("15e")
    cross = features_cross_check(dev)
    return {"launches": launches, "cross_check": cross}


# ---------------------------------------------------------------- phase 5

FLASH = ("flash_fwd", "flash_dq", "flash_dkdv")
FLASH_REPLACES = {
    "flash_fwd": "mpi_tensorflow_tpu/ops/flash_attention.py:109",
    "flash_dq": "mpi_tensorflow_tpu/ops/flash_attention.py:246",
    "flash_dkdv": "mpi_tensorflow_tpu/ops/flash_attention.py:278",
}


def flash_counts() -> dict:
    from mpi_tensorflow_torch.ops import flash_attention as fa

    return {name: getattr(fa, name).launches for name in FLASH}


def set_flash_counts(counts: dict) -> None:
    from mpi_tensorflow_torch.ops import flash_attention as fa

    for name in FLASH:
        getattr(fa, name).launches = counts[name]


def check_close(got, want, atol, rtol, what) -> float:
    g, w = got.detach().float(), want.detach().float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"non-finite kernel output: {what}")
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(
            f"kernel disagrees with its plain version: {what} "
            f"max|err|={float(err.max())} (tolerance {atol} + "
            f"{rtol}*|want|)")
    return float(err.max())


def check_flash(dev) -> dict:
    """Each flash kernel against its plain version on the same inputs;
    returns the max absolute error per kernel and dtype.  lse is held to
    the float32 tolerance in both dtypes (it is float32 either way)."""
    from mpi_tensorflow_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    dtypes = (torch.float32, torch.bfloat16)
    worst = {(k, dt): 0.0 for k in FLASH for dt in dtypes}
    cases = list(itertools.product(dtypes, (1, 17, 64, 128, 255, 512, 1000),
                                   ((1, 1), (2, 3)), (16, 20, 40, 64, 128),
                                   (False, True)))
    for dtype, S, (B, Hh), Dd, causal in cases:
        atol, rtol = TOL[dtype]
        what = f"{str(dtype)[6:]} S={S} B={B} H={Hh} D={Dd} causal={causal}"
        q, k, v, do = (torch.randn((B, Hh, S, Dd), generator=g,
                                   device=dev).to(dtype) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize(dev)
        r_out, r_lse = fa.flash_forward_reference(q, k, v, causal=causal)
        delta = (do.float() * r_out.float()).sum(-1)
        dq = fa.flash_dq(q, k, v, do, r_lse, delta, causal=causal)
        dk, dv = fa.flash_dkdv(q, k, v, do, r_lse, delta, causal=causal)
        torch.cuda.synchronize(dev)
        r_dq, r_dk, r_dv = fa.flash_backward_reference(
            q, k, v, do, r_lse, delta, causal=causal)
        errs = {
            "flash_fwd": (check_close(out, r_out, atol, rtol,
                                      "flash_fwd out " + what),
                          check_close(lse, r_lse, *TOL[torch.float32],
                                      "flash_fwd lse " + what)),
            "flash_dq": (check_close(dq, r_dq, atol, rtol,
                                     "flash_dq " + what),),
            "flash_dkdv": (check_close(dk, r_dk, atol, rtol,
                                       "flash_dkdv dk " + what),
                           check_close(dv, r_dv, atol, rtol,
                                       "flash_dkdv dv " + what))}
        for name, e in errs.items():
            worst[name, dtype] = max(worst[name, dtype], *e)
    n = len(cases)
    for dtype in (torch.float32, torch.bfloat16):
        log(f"[flash] {str(dtype)[6:]}: max|kernel - plain| fwd "
            f"{worst['flash_fwd', dtype]:.3e}, dq "
            f"{worst['flash_dq', dtype]:.3e}, dkdv "
            f"{worst['flash_dkdv', dtype]:.3e} over {n // 2} cases "
            f"(tolerance {TOL[dtype][0]} abs + {TOL[dtype][1]} rel; lse "
            f"{TOL[torch.float32][0]} abs)")
    return worst


def check_flash_grads(dev) -> None:
    """``flash_attention``'s autograd gradients against autograd through
    ``dense_attention`` (float32, S = 256, B = 2, H = 3, D = 64)."""
    from mpi_tensorflow_torch.ops.flash_attention import flash_attention
    from mpi_tensorflow_torch.parallel.ring import dense_attention

    g = torch.Generator(device=dev).manual_seed(1)
    for causal in (False, True):
        x = [torch.randn((2, 3, 256, 64), generator=g, device=dev)
             for _ in range(4)]
        grads = []
        for fn in (flash_attention, dense_attention):
            q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
            out = (fn(q, k, v, causal) if fn is flash_attention
                   else fn(q, k, v, causal=causal))
            grads.append((out, *torch.autograd.grad(out, (q, k, v), x[3])))
        errs = [check_close(a, b, 1e-4, 0.0, f"flash_attention {name} "
                            f"vs dense autograd, causal={causal}")
                for name, a, b in zip(("out", "dq", "dk", "dv"), *grads)]
        log(f"[flash] autograd vs dense_attention, fp32 S=256 "
            f"causal={causal}: max|err| out/dq/dk/dv "
            f"{' '.join(f'{e:.3e}' for e in errs)} (tolerance 1e-4)")


# ---------------------------------------------------------------- phase 6

def check_flash_at(inputs, causal: bool) -> dict:
    """The kernels against their plain versions on one input set of the
    training shape (``time_flash``'s first): ``out`` and ``lse`` come
    from ``flash_fwd``, the backward kernels read the plain lse and
    delta.  Returns the max absolute error per kernel."""
    from mpi_tensorflow_torch.ops import flash_attention as fa

    q, k, v, do, out, lse, _ = inputs
    atol, rtol = TOL[q.dtype]
    B, Hh, S, Dd = q.shape
    what = f"{str(q.dtype)[6:]} S={S} B={B} H={Hh} D={Dd} causal={causal}"
    r_out, r_lse = fa.flash_forward_reference(q, k, v, causal=causal)
    delta = (do.float() * r_out.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, r_lse, delta, causal=causal)
    dk, dv = fa.flash_dkdv(q, k, v, do, r_lse, delta, causal=causal)
    torch.cuda.synchronize(q.device)
    r_dq, r_dk, r_dv = fa.flash_backward_reference(
        q, k, v, do, r_lse, delta, causal=causal)
    tol, tol32 = (atol, rtol), TOL[torch.float32]
    pairs = {"flash_fwd": (("out", out, r_out, tol),
                           ("lse", lse, r_lse, tol32)),
             "flash_dq": (("dq", dq, r_dq, tol),),
             "flash_dkdv": (("dk", dk, r_dk, tol), ("dv", dv, r_dv, tol))}
    errs, notes = {}, []
    for name, parts in pairs.items():
        errs[name] = max(check_close(got, want, *t, f"{name} {part} {what}")
                         for part, got, want, t in parts)
        # how many elements differ at all, and the size of what is held
        notes += [f"{part} {int((got != want).sum())} of {got.numel()} "
                  f"({100 * float((got != want).float().mean()):.4f} %) "
                  f"differ, max|plain| {float(want.float().abs().max()):.3g}"
                  for part, got, want, _ in parts]
    log(f"[flash] {what}: " + "; ".join(notes))
    return errs


def time_flash(dev) -> dict:
    """Each flash kernel at the training shape (B=4, H=12, S=4096, D=64,
    bf16), causal and not: held against its plain version on the first
    input set (``check_flash_at``), then device ms over 3 rotating input
    sets (100 MB each, past the 50 MB L2) and ms per call back to back
    (CUDA events), the plain version's wall ms, SDPA's forward and
    backward device ms, and the bound.  Returns {kernel: {causal:
    numbers}}."""
    from mpi_tensorflow_torch.ops import flash_attention as fa

    B, Hh, S, Dd = 4, 12, 4096, 64
    dt = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(2)
    saved = flash_counts()
    res = {k: {} for k in FLASH}
    for causal in (False, True):
        sets = []
        for _ in range(3):
            q, k, v, do = (torch.randn((B, Hh, S, Dd), generator=g,
                                       device=dev).to(dt) for _ in range(4))
            out, lse = fa.flash_fwd(q, k, v, causal=causal)
            delta = (do.float() * out.float()).sum(-1)
            sets.append((q, k, v, do, out, lse, delta))
        errs = check_flash_at(sets[0], causal)
        calls = {
            "flash_fwd": (lambda q, k, v, do, out, lse, delta:
                          fa.flash_fwd(q, k, v, causal=causal)),
            "flash_dq": (lambda q, k, v, do, out, lse, delta:
                         fa.flash_dq(q, k, v, do, lse, delta,
                                     causal=causal)),
            "flash_dkdv": (lambda q, k, v, do, out, lse, delta:
                           fa.flash_dkdv(q, k, v, do, lse, delta,
                                         causal=causal)),
        }
        # the plain backward computes dq, dk and dv in one call: its time
        # stands beside both backward kernels
        plain_fwd = wall_ms(lambda q, k, v, *_: fa.flash_forward_reference(
            q, k, v, causal=causal), sets[:1], reps=1)
        plain_bwd = wall_ms(
            lambda q, k, v, do, out, lse, delta: fa.flash_backward_reference(
                q, k, v, do, lse, delta, causal=causal), sets[:1], reps=1)
        plain = {"flash_fwd": plain_fwd, "flash_dq": plain_bwd,
                 "flash_dkdv": plain_bwd}
        # the yardstick: SDPA's forward, and its backward from a saved
        # forward (one call computes dq, dk and dv together)
        lib_fwd = device_ms(lambda q, k, v, *_: sdpa(q, k, v,
                                                     is_causal=causal),
                            sets, reps=2)
        graphs = []
        for q_, k_, v_, do_, *_ in sets:
            xs = [t.detach().clone().requires_grad_(True)
                  for t in (q_, k_, v_)]
            graphs.append((sdpa(*xs, is_causal=causal), xs, do_))
        lib_bwd = device_ms(lambda o, xs, do_: torch.autograd.grad(
            o, xs, do_, retain_graph=True), graphs, reps=2)
        del graphs
        esize = 2
        bhsd, bhs = B * Hh * S * Dd * esize, B * Hh * S * 4
        io = {"flash_fwd": 4 * bhsd + bhs,            # q k v in, out, lse
              "flash_dq": 5 * bhsd + 2 * bhs,         # q k v dO in, dq
              "flash_dkdv": 6 * bhsd + 2 * bhs}       # ... dk, dv out
        # flops of the function's products, 2 B H S^2 D each (forward 2,
        # dq 3, dk/dv 4); the bf16 kernels' split of ds adds one product
        # each that these counts leave out
        mults = {"flash_fwd": 4, "flash_dq": 6, "flash_dkdv": 8}
        for name in FLASH:
            ops = mults[name] * B * Hh * S * S * Dd / (2 if causal else 1)
            bound_ms, bound_by = bound(io[name], ops, dt)
            ms = device_ms(calls[name], sets, reps=2, kernels_per_call=1)
            res[name][causal] = {
                "ms": ms,
                "tflops": ops / ms / 1e9,
                "pct_of_bound": 100 * bound_ms / ms,
                "call_ms": wall_ms(calls[name], sets, reps=2),
                "plain_ms": plain[name],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_fwd if name == "flash_fwd" else None,
                "library_bwd_ms": lib_bwd,
                "max_abs_err_train_shape": errs[name]}
            r = res[name][causal]
            log(f"[flash] {name} B={B} H={Hh} S={S} D={Dd} bf16 "
                f"causal={causal}: max|kernel - plain| {errs[name]:.3e} "
                f"(tolerance {TOL[dt][0]} abs + {TOL[dt][1]} rel; lse "
                f"{TOL[torch.float32][0]} abs); "
                f"kernel {r['ms']:.4f} ms on the device"
                f"{previous_ms((name, causal))} "
                f"({r['call_ms']:.4f} ms per call back to back; "
                f"{r['tflops']:.2f} TFLOP/s, {r['pct_of_bound']:.2f} % of "
                f"bound), plain "
                f"{r['plain_ms']:.3f} ms per call, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {io[name]} B, {ops:.4g} "
                f"ops); sdpa forward {lib_fwd:.4f} ms, sdpa backward "
                f"(dq, dk, dv together) {lib_bwd:.4f} ms on the device")
        del sets
    set_flash_counts(saved)              # timing is not the main path
    return res


# ---------------------------------------------------------------- phase 7

TRAIN_SEQ, TRAIN_BATCH, TRAIN_N, TEST_N, LOG_EVERY = 4096, 4, 32, 8, 4


def train_full_width(dev, model: str = "bert_base", *,
                     remat=None, optimizer: str = "adamw",
                     schedule: str = "warmup_linear", label: str = "") -> tuple:
    """BERT_BASE widths, bf16, S=4096, batch 4, dropout 0.1, through
    ``train_mlm`` (``model``: ``bert_base``, phase 7, or ``gpt_base``,
    phase 18: the causal kernels and the chunked CE, its loss falling
    from the first step to the last two; phase 19: ``moe_bert``,
    ``encdec_t5`` (S = T = 4096, its loss falling too), and config 5
    with ``remat`` "full" or "dots" or with ``optimizer`` "lamb" under
    ``schedule`` "warmup_cosine").  Under remat every layer's flash
    forward runs again in its backward.  Returns the flash launches of
    the run and its numbers."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import gspmd, mlm_loop
    from mpi_tensorflow_torch.utils import flops

    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                              max_positions=TRAIN_SEQ,
                              remat=remat is not None,
                              remat_policy=remat or "full")
    config = Config(model=model, dataset="mlm_synthetic", epochs=1,
                    batch_size=TRAIN_BATCH, log_every=LOG_EVERY,
                    precision="bf16", optimizer=optimizer)
    enc_dec = model == "encdec_t5"
    torch.cuda.reset_peak_memory_stats(dev)
    set_flash_counts({k: 0 for k in FLASH})
    losses = []
    calls = {False: 0, True: 0}          # flash calls, by causal
    make, flash = gspmd.make_train_step, bert.flash_attention

    def recording(*a, **kw):
        step = make(*a, **kw)

        def call(*args):
            state, metrics = step(*args)
            losses.append(metrics["loss"])   # stays on the card
            return state, metrics
        return call

    def counted(q, k, v, causal):
        calls[causal] += 1
        return flash(q, k, v, causal)

    gspmd.make_train_step, bert.flash_attention = recording, counted
    try:
        res = mlm_loop.train_mlm(config, cfg, seq_len=TRAIN_SEQ,
                                 train_n=TRAIN_N, test_n=TEST_N, device=dev,
                                 lr_schedule=schedule)
    finally:
        gspmd.make_train_step, bert.flash_attention = make, flash
    torch.cuda.synchronize(dev)
    launches = flash_counts()
    losses = [float(x) for x in losses]
    steps = res.num_steps
    eval_forwards = len(res.history) * -(-min(TEST_N, 4 * TRAIN_BATCH)
                                         // TRAIN_BATCH)
    # each stack's layers; a rematted layer runs its forward twice a step
    stack = cfg.layers
    fwd = stack * ((2 if remat else 1) * steps + eval_forwards)
    want = {"flash_fwd": fwd * (2 if enc_dec else 1),
            "flash_dq": stack * steps * (2 if enc_dec else 1),
            "flash_dkdv": stack * steps * (2 if enc_dec else 1)}
    causal = model in ("gpt_base", "encdec_t5")
    want_calls = {False: 0 if model == "gpt_base" else fwd,
                  True: fwd if causal else 0}
    if launches != want or calls != want_calls:
        raise AssertionError(
            f"flash launches {launches} != {want}, calls by causal "
            f"{calls} != {want_calls} ({stack} layers a stack, {steps} "
            f"steps, {eval_forwards} eval forwards, remat {remat})")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss {losses}")
    if causal and not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"the {model} loss did not fall: {losses}")
    if [t for t, _ in res.history] != [4, 7]:
        raise AssertionError(f"unexpected history {res.history}")
    if enc_dec:
        model_flops = flops.encdec_train_flops(
            cfg, res.state.model.n_dec, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ)
    else:
        model_flops = flops.transformer_train_flops(
            cfg, TRAIN_BATCH, TRAIN_SEQ,
            head_positions=TRAIN_SEQ if model == "gpt_base" else None)
    stats = {
        "model": model, "causal": causal, "remat": remat,
        "optimizer": optimizer, "schedule": schedule,
        "layers": cfg.layers, "hidden": cfg.hidden, "heads": cfg.heads,
        "vocab": cfg.vocab_size, "precision": "bf16", "seq_len": TRAIN_SEQ,
        "batch": TRAIN_BATCH, "dropout": cfg.dropout, "steps": steps,
        "history": res.history, "final_loss": res.final_loss,
        "losses": losses,
        "step_ms": res.step_time_seconds * 1e3,
        "tokens_per_sec": res.tokens_per_sec,
        "model_flops_per_step": model_flops,
        "mfu_bf16": flops.mfu(model_flops, res.step_time_seconds, "bf16"),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": launches,
        "flash_calls": {"bidirectional": calls[False],
                        "causal": calls[True]}}
    if model == "moe_bert":
        # the last forward's (the final trace point's eval batch)
        stats["dropped_share"] = res.state.model.dropped_share()
    log(f"[train {label or model}] " + json.dumps(stats))
    return launches, stats


# ---------------------------------------------------------------- phase 8

def train_batches(dev, family, cfg, n: int = 3, seq: int = 512, B: int = 2,
                  seed: int = 5) -> list:
    """``n`` batches of ``B`` rows at ``seq`` for ``family``: the
    synthetic MLM stream, or the enc-dec family's reversal pairs."""
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import encdec

    put = lambda a: torch.from_numpy(a).to(dev)
    rows = [slice(i * B, (i + 1) * B) for i in range(n)]
    if issubclass(family, encdec.EncDecLm):
        src, tgt = synthetic.seq2seq_batches(
            n * B, src_len=seq, tgt_len=seq, vocab_size=cfg.vocab_size,
            seed=seed)
        return [({"src": put(src[r]), "tgt": put(tgt[r])}, put(tgt[r]))
                for r in rows]
    tokens, targets, mask = synthetic.mlm_batches(
        n * B, seq_len=seq, vocab_size=cfg.vocab_size, seed=seed)
    return [({"tokens": put(tokens[r]), "mask": put(mask[r])},
             put(targets[r])) for r in rows]


def cross_check_train(dev, family=None, label: str = "mlm",
                      arms=None) -> None:
    """float32, 2 layers at full width, S=512, B=2, dropout 0: the loss
    and gradients at the start, and the losses and parameters of three
    train steps, of the first of ``arms`` against the second (each
    ``name: (attention, config changes)``; default ``attention="flash"``
    against ``"dense"``); ``family``: ``BertMlm`` (phase 8),
    ``TrainableCausalLm`` (phase 18b: both routes causal),
    ``MoeBertMlm`` or ``EncDecLm`` (phase 19a: its encoder
    bidirectional, its decoder causal; the cross-attention dense on both
    routes); phase 20c's arms are ``fused_qkv`` on and off."""
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import gspmd, optimizer

    family = family or bert.BertMlm
    arms = arms or {"flash": ("flash", {}), "dense": ("dense", {})}
    a_name, b_name = arms

    cfg = dataclasses.replace(bert.BERT_BASE, layers=2, dropout=0.0)
    batches = train_batches(dev, family, cfg)
    saved = flash_counts()
    runs = {}
    for arm, (attention, changes) in arms.items():
        model = family.from_seed(dataclasses.replace(cfg, **changes), 0,
                                 attention).to(dev)
        loss = model.loss(*batches[0], train=True)
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        tx = optimizer.transformer_tx(1e-4, 3)
        state = gspmd.init_state(model, tx)
        step = gspmd.make_train_step(tx)
        losses = [float(step(state, *b)[1]["loss"]) for b in batches]
        runs[arm] = (loss.item(), grads, losses,
                     [p.detach() for p in model.parameters()],
                     [n for n, _ in model.named_parameters()])
    set_flash_counts(saved)
    (l_f, g_f, ls_f, p_f, names), (l_d, g_d, ls_d, p_d, _) = (
        runs[a_name], runs[b_name])
    vs = f"{a_name} vs {b_name}"
    if abs(l_f - l_d) > 1e-4 or max(abs(a - b)
                                    for a, b in zip(ls_f, ls_d)) > 1e-4:
        raise AssertionError(f"{vs} losses differ: {l_f} "
                             f"{ls_f} vs {l_d} {ls_d} (tolerance 1e-4)")
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_f, g_d))
    if g_err > 1e-4:
        raise AssertionError(f"{vs} gradients differ by {g_err} "
                             f"(tolerance 1e-4)")
    # bk's gradient is zero in exact arithmetic (the softmax ignores a
    # per-query constant): adamw normalises each side's float noise, so
    # bk is held to the steps' reach, 3 x lr; every other leaf to 1e-5
    p_err, bk_err = 0.0, 0.0
    for name, a, b in zip(names, p_f, p_d):
        e = float((a - b).abs().max())
        if name.endswith((".bk", ".xbk")):
            bk_err = max(bk_err, e)
        else:
            p_err = max(p_err, e)
    if p_err > 1e-5 or bk_err > 3e-4:
        raise AssertionError(f"{vs} parameters differ by {p_err} "
                             f"(bk {bk_err}) after 3 steps")
    log(f"[train cross-check {label}] {vs}, fp32, 2 layers, S=512, B=2: "
        f"loss "
        f"{l_f:.6f} vs {l_d:.6f}, step losses max|diff| "
        f"{max(abs(a - b) for a, b in zip(ls_f, ls_d)):.3e}, gradients "
        f"max|diff| {g_err:.3e} (tolerance 1e-4), parameters after 3 "
        f"steps max|diff| {p_err:.3e} (tolerance 1e-5; bk {bk_err:.3e}, "
        f"tolerance 3e-4)")


# ---------------------------------------------------------------- phase 9

FUSED_REPLACES = {"layer_norm": "mpi_tensorflow_tpu/ops/fused.py:56",
                  "logsumexp": "mpi_tensorflow_tpu/ops/fused.py:123"}
# the logsumexp is float32 for either input type; rows of +-1e4 make it
# ~1e4, where one float32 ulp is ~1e-3, hence the relative part
LSE_TOL = (1e-4, 1e-6)


# LayerNorm widths per dtype that take each route (fused.layer_norm_route):
# the fast path ("rows") takes F in multiples of a 16-byte vector up to
# 1024 float32 / 2048 bf16 values; 1028 / 2056 are one vector past that,
# 1001 is no multiple, and they take the general path ("block")
LN_ROUTE_F = {torch.float32: ((16, 768, 1000, 1024), (1001, 1028, 2048)),
              torch.bfloat16: ((16, 768, 1000, 1024, 2048), (1001, 2056))}


def layer_norm_cases(dtype):
    """(N, F, kind, route) of the LayerNorm checks in ``dtype``: rows of
    3 randn + 1 at widths that take each route, a contiguous view one
    element off 16-byte alignment (``misaligned``), and float32 rows of
    64 + randn (``offset``), where a one-pass E[x^2] - E[x]^2 would
    cancel."""
    fast, general = LN_ROUTE_F[dtype]
    cases = [(N, F, "randn", route) for N in (1, 7, 4096)
             for route, widths in (("rows", fast), ("block", general))
             for F in widths]
    cases += [(N, 768, "misaligned", "block") for N in (7, 4096)]
    if dtype == torch.float32:
        cases += [(4096, F, "offset", "rows") for F in (768, 1000, 1024)]
        cases += [(4096, 1001, "offset", "block")]
    return cases


def check_fused(dev) -> dict:
    """``layer_norm_forward`` and ``online_logsumexp`` against their plain
    versions, and ``softmax_cross_entropy``'s gradient against autograd
    through the plain version.  Each LayerNorm case must take the route
    it is meant to exercise (``fused.layer_norm_route``).  Returns the
    max absolute error per kernel and dtype."""
    from mpi_tensorflow_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(4)
    dtypes = (torch.float32, torch.bfloat16)
    worst = {(k, dt): 0.0 for k in FUSED_REPLACES for dt in dtypes}
    offset_worst = 0.0
    routes = {"rows": [], "block": []}
    for dtype in dtypes:
        dt = str(dtype)[6:]
        for N, F, kind, route in layer_norm_cases(dtype):
            z = torch.randn((N * F + 1,), generator=gen, device=dev)
            buf = ((64 + z) if kind == "offset" else (3 * z + 1)).to(dtype)
            x = (buf[1:] if kind == "misaligned" else buf[:-1]).view(N, F)
            scale, bias = (torch.randn((F,), generator=gen, device=dev)
                           for _ in range(2))
            what = f"layer_norm {dt} N={N} F={F} {kind}"
            took = fused.layer_norm_route(x, scale, bias)
            if took != route:
                raise AssertionError(f"{what} took the {took} route, not "
                                     f"{route}")
            routes[route].append(f"{dt} {N}x{F}"
                                 + ("" if kind == "randn" else f" {kind}"))
            got = fused.layer_norm_forward(x, scale, bias)
            torch.cuda.synchronize(dev)
            want = fused.layer_norm_reference(x, scale, bias)
            err = check_close(got, want, *TOL[dtype], what)
            worst["layer_norm", dtype] = max(worst["layer_norm", dtype], err)
            if kind == "offset":
                offset_worst = max(offset_worst, err)
        for N, V in itertools.product((1, 7, 4096), (1, 511, 30522)):
            x = 4 * torch.randn((N, V), generator=gen, device=dev)
            x[0] = torch.where(torch.rand((V,), generator=gen, device=dev)
                               < 0.5, -1e4, 1e4)
            if N > 1:
                x[1] = 1e4 + torch.randn((V,), generator=gen, device=dev)
            x = x.to(dtype)
            got = fused.online_logsumexp(x)
            torch.cuda.synchronize(dev)
            want = fused.logsumexp_reference(x)
            worst["logsumexp", dtype] = max(
                worst["logsumexp", dtype], check_close(
                    got, want, *LSE_TOL, f"logsumexp {dt} N={N} V={V}"))
    logits = 4 * torch.randn((64, 30522), generator=gen, device=dev)
    labels = torch.randint(0, 30522, (64,), generator=gen, device=dev)
    g = torch.randn((64,), generator=gen, device=dev)
    grads = []
    for ce in (fused.softmax_cross_entropy,
               lambda lg, lb: fused.logsumexp_reference(lg) - torch.gather(
                   lg, -1, lb[:, None])[:, 0]):
        lg = logits.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(ce(lg, labels), lg, g)[0])
    ce_err = check_close(grads[0], grads[1], 1e-5, 0.0,
                         "softmax_cross_entropy gradient")
    for route, done in routes.items():
        log(f"[fused] layer_norm route {route} ({len(done)} cases): "
            + ", ".join(done))
    log(f"[fused] max|kernel - plain|: layer_norm, both routes, float32 "
        f"{worst['layer_norm', torch.float32]:.3e} (rows of 64 + randn "
        f"{offset_worst:.3e}), bfloat16 "
        f"{worst['layer_norm', torch.bfloat16]:.3e} (tolerance as phase "
        f"2); logsumexp "
        f"{max(worst['logsumexp', dt] for dt in dtypes):.3e} (V in 1, 511, "
        f"30522, rows of +-1e4; "
        f"tolerance {LSE_TOL[0]} abs + {LSE_TOL[1]} rel); "
        f"softmax_cross_entropy gradient vs autograd through the plain "
        f"version, (64, 30522) float32: {ce_err:.3e} (tolerance 1e-5)")
    return worst


def time_fused(dev) -> dict:
    """Device ms of each fused kernel at the BERT-base shapes — LayerNorm
    over (4096, 768) bf16 activations and over the S = 4096 batch-4
    step's (16384, 768), logsumexp over (4096, 30522) float32 logits —
    beside its plain version, the PyTorch call that computes the same
    function (yardstick only) and the bound.  The (16384, 768) LayerNorm
    goes under the (4096, 768) one's ``n16384`` key."""
    from mpi_tensorflow_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(5)
    dt = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def layer_norm_case(N, F, count):
        sets = [(randn(N, F).to(dt), randn(F), randn(F))
                for _ in range(count)]
        return ("layer_norm", f"({N}, {F}) bf16", fused.layer_norm_forward,
                fused.layer_norm_reference, sets, "F.layer_norm",
                lambda x, s, b: torch.nn.functional.layer_norm(
                    x, (F,), s, b, 1e-12),
                [(x, s.to(dt), b.to(dt)) for x, s, b in sets],
                2 * N * F * 2 + 2 * F * 4, 8 * N * F, 20)

    N, V = 4096, 30522
    lse_sets = [(randn(N, V),) for _ in range(2)]      # 500 MB each
    cases = [layer_norm_case(4096, 768, 12),           # 12 x 6.3 MB > L2
             layer_norm_case(16384, 768, 4),           # 4 x 25 MB
             ("logsumexp", f"({N}, {V}) float32", fused.online_logsumexp,
              fused.logsumexp_reference, lse_sets, "torch.logsumexp",
              lambda x: torch.logsumexp(x, -1), lse_sets,
              N * V * 4 + N * 4, 4 * N * V, 5)]
    res = {}
    for (name, what, kern, plain, sets, lib_name, lib, lsets, nbytes, ops_n,
         reps) in cases:
        ms = device_ms(kern, sets, reps=reps, kernels_per_call=1)
        call_ms = wall_ms(kern, sets, reps=reps)
        plain_ms = wall_ms(plain, sets[:1], reps=2)
        library_ms = device_ms(lib, lsets, reps=reps)
        bound_ms, bound_by = bound(nbytes, ops_n, torch.float32)
        r = {"ms": ms, "pct_of_bound": 100 * bound_ms / ms,
             "call_ms": call_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": bound_ms,
             "bound_by": bound_by}
        earlier = previous_ms(name) if name not in res else ""
        if name in res:
            res[name]["n16384"] = r
        else:
            res[name] = r
        log(f"[fused] {name} {what}: kernel {ms:.4f} ms on the device"
            f"{earlier} ({r['pct_of_bound']:.2f} % of bound; "
            f"{call_ms:.4f} ms per call back to back), plain "
            f"{plain_ms:.4f} ms per call, {lib_name} {library_ms:.4f} ms "
            f"on the device, bound {bound_ms:.5f} ms "
            f"({bound_by}: {nbytes} B, {ops_n} ops)")
    return res


def fused_counts() -> dict:
    from mpi_tensorflow_torch.ops import fused

    return {"layer_norm": fused.layer_norm_forward.launches,
            "logsumexp": fused.online_logsumexp.launches}


# --------------------------------------------------------------- phase 10

CNN_DATA_DIR = "build/mnist"     # git-ignored; the synthetic set's home
# 10a: each of CNN_STEPS train steps on the card from the CPU's state
# before it, against the CPU's step: the loss (the largest difference)
# and the gradient the step adds to the same velocity (the largest
# relative difference over the parameters, its median over the steps).
# One step at a time, and the median, since a difference of one rounding
# can flip a ReLU or a max-pool choice: the free-running trajectory
# stays within ~1e-7 on some runs and parts far past 1e-4 on others,
# and a step with a flip moves a gradient by up to ~5e-4.  float32 with
# TF32 off on the card: cuDNN and the CPU sum in another order.  bf16 on
# both: the same rounding points, a sum in another order may round a
# bf16 value the other way.  The control at the wrong precision must
# miss each bound: the card's float32 with TF32 on, and its bf16 step
# against the CPU's float32 one.
CNN_TOL = {"fp32": {"loss": 1e-5, "grad": 1e-5},
           "bf16": {"loss": 1e-3, "grad": 1e-3}}
CNN_STEPS = 20
TRACE_LINE = re.compile(r"0  process at  (\d+) with test error: "
                        r"(\d+\.\d)%")


class _Tee(io.StringIO):
    """A copy of what is written, passed on to ``out``."""

    def __init__(self, out):
        super().__init__()
        self._out = out

    def write(self, text):
        self._out.write(text)
        return super().write(text)


def hand_kernel_counts() -> dict:
    """The launch counts of every hand kernel of the port."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

    return {"paged_attention": pk.paged_attention_kernel.launches,
            **flash_counts(), **fused_counts()}


def set_hand_kernel_counts(counts: dict) -> None:
    from mpi_tensorflow_torch.ops import fused
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

    pk.paged_attention_kernel.launches = counts["paged_attention"]
    set_flash_counts(counts)
    fused.layer_norm_forward.launches = counts["layer_norm"]
    fused.online_logsumexp.launches = counts["logsumexp"]


def cnn_model_step(params, velocity, count, batch, dev, dtype,
                   tf32: bool = False):
    """One train step of ``MnistCnn`` (dropout 0) in compute dtype
    ``dtype`` on ``dev`` from parameters ``params``, velocity
    ``velocity`` and step counter ``count``, TF32 as asked: ``(loss,
    parameters, velocity)`` after it, on the CPU."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import cnn
    from mpi_tensorflow_torch.train import optimizer, step

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = cnn.MnistCnn(dict(zip(cnn.NAMES, params)), dropout_rate=0.0,
                             compute_dtype=dtype).to(dev)
        state = step.init_state(model)
        state.opt = optimizer.MomentumState(
            [v.to(dev, copy=True) for v in velocity], count)
        train_step = step.make_train_step(model, Config(dropout_rate=0.0),
                                          1, decay_steps=50000)
        x, y = batch
        state, m = train_step(state, torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev))
        return (float(m["loss"]),
                [p.detach().cpu() for p in model.param_tree().values()],
                [v.cpu() for v in state.opt.velocity])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def cnn_trajectory(params, batches, dtype, dev=torch.device("cpu")
                   ) -> list:
    """``CNN_STEPS`` steps in ``dtype`` on ``dev`` (the CPU unless
    asked) from ``params``: the state ``(parameters, velocity,
    counter)`` before each step and ``(loss, parameters, velocity)``
    after it."""
    from mpi_tensorflow_torch.models import cnn

    p = [torch.as_tensor(params[k]) for k in cnn.NAMES]
    v = [torch.zeros_like(t) for t in p]
    out = []
    for t, batch in enumerate(batches):
        before = (p, v, np.float32(t))
        after = cnn_model_step(p, v, np.float32(t), batch, dev, dtype)
        out.append((before, after))
        _, p, v = after
    return out


def cnn_cross_check(dev) -> dict:
    """10a: ``MnistCnn`` from one set of parameters, dropout 0, over the
    first ``CNN_STEPS`` batches of the synthetic train split in float32
    and in bf16: each step on the card from the CPU's state before it,
    its loss and its gradient (the velocity it leaves; the median over
    the steps) within ``CNN_TOL`` of the CPU's at the same precision,
    and each bound missed by its control (TF32 on; the bf16 step
    against float32)."""
    from mpi_tensorflow_torch.data import mnist
    from mpi_tensorflow_torch.models import cnn

    mnist.ensure_data(CNN_DATA_DIR)
    splits = mnist.load_splits(CNN_DATA_DIR)
    b = 64
    batches = [(splits.train_data[i * b:(i + 1) * b],
                splits.train_labels[i * b:(i + 1) * b])
               for i in range(CNN_STEPS)]
    params = cnn.init_params(torch.Generator().manual_seed(3))
    f32, bf16 = torch.float32, torch.bfloat16
    cpu = {"fp32": cnn_trajectory(params, batches, f32),
           "bf16": cnn_trajectory(params, batches, bf16)}

    def apart(ref, dtype, tf32=False):
        """The card's steps in ``dtype`` from the CPU trajectory
        ``ref``'s states: the largest loss difference, and the median
        and the largest over the steps of a step's largest relative
        velocity difference."""
        loss_err, grad_err = 0.0, []
        for (p, v, count), (loss, _, vel) in cpu[ref]:
            got, _, got_v = cnn_model_step(p, v, count, batches[int(count)],
                                           dev, dtype, tf32)
            loss_err = max(loss_err, abs(got - loss))
            grad_err.append(max(float((a - w).norm() / w.norm())
                                for a, w in zip(got_v, vel)))
        return {"loss": loss_err, "grad": float(np.median(grad_err)),
                "grad_max": max(grad_err)}

    # not gated: the free-running trajectories, card against CPU
    free = {}
    for prec, dtype in (("fp32", f32), ("bf16", bf16)):
        card = cnn_trajectory(params, batches, dtype, dev)
        free[prec] = max(float((a - w).abs().max()) for a, w in zip(
            card[-1][1][1], cpu[prec][-1][1][1]))
    log(f"[cnn cross-check] free-running {CNN_STEPS} steps, card vs CPU "
        f"(not gated): parameters part by {free['fp32']:.3e} (fp32), "
        f"{free['bf16']:.3e} (bf16)")
    out = {"free_running_param_diff": free}
    for prec, dtype, control, ctl_args in (
            ("fp32", f32, "card fp32 with TF32 on", ("fp32", f32, True)),
            ("bf16", bf16, "card bf16 from the CPU's fp32 steps",
             ("fp32", bf16))):
        tol = CNN_TOL[prec]
        got, ctl = apart(prec, dtype), apart(*ctl_args)
        losses = [after[0] for _, after in cpu[prec]]
        moved = min(float((a - torch.as_tensor(params[k])).abs().max())
                    for k, a in zip(cnn.NAMES, cpu[prec][-1][1][1]))
        log(f"[cnn cross-check] {prec}, {CNN_STEPS} steps of batch {b}, "
            f"each from the CPU's state: CPU losses {losses[0]:.6f} -> "
            f"{losses[-1]:.6f}; card vs CPU max loss diff "
            f"{got['loss']:.3e}, gradient rel. diff median "
            f"{got['grad']:.3e} (max {got['grad_max']:.3e}) (tolerance "
            f"{tol}); control, {control}: loss {ctl['loss']:.3e}, "
            f"gradient median {ctl['grad']:.3e} (max "
            f"{ctl['grad_max']:.3e})")
        if not np.isfinite(losses).all() or moved == 0.0 \
                or any(got[k] > tol[k] for k in tol):
            raise AssertionError(
                f"CNN {prec} card vs CPU: {got} (tolerance {tol}); least "
                f"parameter move {moved}")
        if any(ctl[k] <= tol[k] for k in tol):
            raise AssertionError(
                f"CNN {prec}: the control ({control}) reads {ctl}, inside "
                f"the tolerance {tol}: the bound does not tell the "
                f"precisions apart")
        out[prec] = {"loss_err": got["loss"], "grad_rel_err": got["grad"],
                     "grad_rel_err_max": got["grad_max"], "tol": tol,
                     "control": control, "control_loss_err": ctl["loss"],
                     "control_grad_rel_err": ctl["grad"],
                     "control_grad_rel_err_max": ctl["grad_max"]}
    return out


def cnn_zero_flag(dev, card: str, argv, want_steps: int,
                  want_trace: list) -> dict:
    """10b: ``cli.main(argv)`` as ``python -m mpi_tensorflow_torch`` runs
    it, on the card: the steps, the trace lines in the reference's
    format, a finite loss, a final test error below 30 % and no higher
    than the first trace point's, and the card named in the result.  The
    result is read from the ``loop.train`` call ``cli.main`` makes."""
    from mpi_tensorflow_torch import cli
    from mpi_tensorflow_torch.data import mnist
    from mpi_tensorflow_torch.train import loop
    from mpi_tensorflow_torch.utils import flops

    results = []
    real_train = loop.train

    def recorded_train(*a, **kw):
        results.append(real_train(*a, **kw))
        return results[-1]

    out = _Tee(sys.stdout)
    loop.train = recorded_train
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        loop.train = real_train
    wall = time.perf_counter() - t0
    (res,) = results
    lines = out.getvalue().splitlines()
    trace = [TRACE_LINE.fullmatch(ln) for ln in lines]
    trace = [(int(m[1]), float(m[2])) for m in trace if m]
    test_n = mnist.load_splits(CNN_DATA_DIR).test_labels.shape[0]
    windows = -(-test_n // 64)      # eval_in_batches: full ones + the tail
    errs = [e for _, e in res.history]
    problems = []
    if rc != 0 or res.device != torch.cuda.get_device_name(dev):
        problems.append(f"rc {rc}, device {res.device!r}")
    if res.num_steps != want_steps or [t for t, _ in trace] != want_trace \
            or [t for t, _ in res.history] != want_trace:
        problems.append(f"{res.num_steps} steps, trace steps "
                        f"{[t for t, _ in trace]}")
    if not lines or not any(ln.startswith("[timing]") for ln in lines):
        problems.append("no [timing] line")
    if not np.isfinite(res.final_loss) or not res.final_test_error < 30.0 \
            or res.final_test_error > errs[0]:
        problems.append(f"loss {res.final_loss}, errors {errs}")
    if problems:
        raise AssertionError(f"zero-flag run {argv}: {problems}")
    config = cli.config_from_args(cli.build_parser().parse_args(argv))
    step_flops = flops.image_train_flops(config.model, config.batch_size)
    summary = {
        "argv": argv, "card": card, "device": res.device,
        "precision": config.precision, "steps": res.num_steps,
        "trace_lines": len(trace), "test_rows": test_n,
        "eval_windows": windows,
        "images_per_sec": res.images_per_sec,
        "step_ms": res.step_time_seconds * 1e3,
        "mfu_pct": 100.0 * flops.mfu(step_flops, res.step_time_seconds,
                                     config.precision),
        "peak_tflops": flops.PEAK_TFLOPS[config.precision],
        "final_loss": res.final_loss, "history": res.history,
        "wall_s": wall}
    log("[cnn] " + json.dumps(summary))
    # 21b holds this run against --fused-steps 1
    return {**summary, "result": res, "lines": lines}


def bench_steps_launched(line: dict) -> int:
    """The train steps a bench line launched: the one-step arm's warm-up
    and timed steps; the scanned arm's (``scan_steps`` K) untimed and
    timed dispatches of K steps and the capture's warm-up window (on the
    card each dispatch is one graph replay of K steps)."""
    K = line["scan_steps"]
    if not K:
        return line["warmup"] + line["steps"]
    return (max(1, line["warmup"] // K) + 1 + line["steps"] // K + 1) * K


def bench_main_line(argv) -> dict:
    """``python -m mpi_tensorflow_torch.bench`` with ``argv``, run in this
    process (``bench.main``): its JSON line."""
    from mpi_tensorflow_torch import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(list(argv))
    return json.loads(out.getvalue().strip().splitlines()[-1])


# the bench's one-card lines, all in one child process with no
# torch.profiler session before it (13e; one launch for phases 10, 11c,
# 12c, 13e and 20, for the script's time): the image lines first, before
# any world is joined (no world's threads beside a host-paced step): the
# zero-flag CNN's step (200 timed after 20), ResNet-20 (30 after 3) and
# ResNet-50 (8 after 2), fp32 and bf16, and phase 20's ViT (30 after 3,
# a cut of the bench's 200 after 20: ~85 ms a step), fp32 and bf16
# (20b); then the transformer lines, each in the launcher's world:
# BERT_BASE at S = 4096 bf16 (10 after 3), config 5 with each reference
# lever (20c), and BERT_BASE bf16 at S = 1024, batch 16, at the default
# flash_min_seq and at 0 (20d); after them 11c's allreduce bench
CONFIG5_BENCH = ["--model", "bert_base", "--seq-len", "4096", "--batch-size",
                 "4", "--precision", "bf16", "--steps", "10", "--warmup", "3"]
CROSSOVER_BENCH = ["--model", "bert_base", "--seq-len", "1024",
                   "--batch-size", "16", "--precision", "bf16", "--steps",
                   "10", "--warmup", "3"]
LEVERS = {"fused_qkv": ["--fused-qkv"], "params_bf16": ["--params-bf16"],
          "ce chunked": ["--ce", "chunked"]}
BENCH_LINES = tuple(
    [(f"cnn {p}", ["--precision", p, "--steps", "200", "--warmup", "20"])
     for p in ("fp32", "bf16")]
    + [(f"{m} {p}", ["--model", m, "--precision", p, "--steps", n,
                     "--warmup", w])
       for m, n, w in (("resnet20", "30", "3"), ("resnet50", "8", "2"))
       for p in ("fp32", "bf16")]
    + [(f"vit {p}", ["--model", "vit", "--precision", p, "--steps", "30",
                      "--warmup", "3"])
       for p in ("fp32", "bf16")]
    + [("bert_base bf16", CONFIG5_BENCH)]
    + [(f"bert_base bf16 {k}", CONFIG5_BENCH + v) for k, v in LEVERS.items()]
    + [("bert_base bf16 S=1024", CROSSOVER_BENCH),
       ("bert_base bf16 S=1024 flash_min_seq 0",
        CROSSOVER_BENCH + ["--flash-min-seq", "0"])])


@contextlib.contextmanager
def recorded_joins():
    """The worlds ``mesh.initialize_distributed`` creates inside the
    block (the yielded list): each one's backend and size, and whether
    a launcher's environment described it."""
    import torch.distributed as dist

    from mpi_tensorflow_torch.parallel import mesh

    real, worlds = mesh.initialize_distributed, []

    def join(*a, **kw):
        joined = real(*a, **kw)
        if joined:
            worlds.append({"backend": str(dist.get_backend()),
                           "size": dist.get_world_size(),
                           "launched": kw.get("init_method") is None})
        return joined

    mesh.initialize_distributed = join
    try:
        yield worlds
    finally:
        mesh.initialize_distributed = real


def joined_launch(worlds) -> bool:
    """``recorded_joins``' list holds one world: the launcher's world of
    one, over NCCL."""
    return len(worlds) == 1 and "nccl" in worlds[0]["backend"] \
        and worlds[0]["size"] == 1 and worlds[0]["launched"]


def worker_bench_lines(_backend: str) -> None:
    """13e, in a torchrun world of one: each of ``BENCH_LINES`` through
    ``bench.main``, each line's flash launches counted from 0
    (``flash_launches``) and the worlds it joined (``worlds``: the
    transformer lines join the launcher's, over NCCL), then 11c's
    allreduce bench."""
    lines = {}
    for label, argv in BENCH_LINES + (("allreduce", None),):
        set_flash_counts({k: 0 for k in FLASH})
        with recorded_joins() as worlds:
            lines[label] = bench_main_line(
                ["--mode", "train", *argv] if argv else
                ["--mode", "allreduce"])
        torch.cuda.synchronize()
        lines[label].update(flash_launches=flash_counts(), worlds=worlds)
    print(DP_RESULT + json.dumps({"case": "bench_lines", "lines": lines}),
          flush=True)


def cnn_phase(dev, card: str) -> dict:
    """Phase 10: the zero-flag CNN trainer.  10a holds the card's float32
    training against the CPU's; 10b runs ``python -m
    mpi_tensorflow_torch``'s zero-flag path (2 epochs, 1562 steps, 32
    trace lines); 10c checks that no hand kernel launched on it (its
    bench lines: 13e)."""
    cross = cnn_cross_check(dev)
    phase("10b")
    saved = hand_kernel_counts()
    set_hand_kernel_counts({k: 0 for k in saved})
    every50 = lambda n: [t for t in range(1, n) if t % 50 == 0] + [n - 1]
    # the bf16 epoch is cut for the script's time: 10a holds bf16 steps
    # to the CPU's, 13e times its step, and 13b and 14a run the loop in
    # bf16
    # cuDNN deterministic: 21b holds this graphed run against the eager
    # one bit for bit
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {"fp32": cnn_zero_flag(dev, card, ["--data-dir",
                                                  CNN_DATA_DIR],
                                      1562, every50(1562))}
    finally:
        torch.backends.cudnn.deterministic = saved_det
    torch.cuda.synchronize(dev)
    moved = {k: v for k, v in hand_kernel_counts().items() if v}
    set_hand_kernel_counts(saved)
    if moved:
        raise AssertionError(f"the CNN path launched hand kernels: {moved}")
    log("[cnn] no hand kernel launched on the CNN path (paged, flash and "
        "fused counts all 0)")
    return {"cross_check": cross, "runs": runs}


# --------------------------------------------------------------- phase 11

# each distributed case runs in processes of its own (torchrun, or the
# bench), so this process's CUDA context is untouched; rank 0 of a
# worker prints its result as one line after this tag
DP_RESULT = "[dp-result] "


def run_sub(cmd, timeout: float, env=None) -> str:
    """``cmd``'s standard output (in ``env``, default this process's);
    its whole process group is killed at ``timeout``, and a nonzero exit
    raises with the end of its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env=env)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"{cmd} exited {proc.returncode}:\n"
                             f"{out[-6000:]}")
    return out


def torchrun(nproc: int, args, timeout: float) -> str:
    """``args`` under ``torchrun --nproc_per_node nproc`` on a free
    localhost port."""
    from mpi_tensorflow_torch.parallel import mesh

    return run_sub([sys.executable, "-m", "torch.distributed.run",
                    f"--nproc_per_node={nproc}", "--master_addr=127.0.0.1",
                    f"--master_port={mesh.free_port()}", *args], timeout)


def start_torchruns(jobs) -> list:
    """Each ``(nproc, args)`` of ``jobs`` under torchrun, all started at
    once, each on a localhost port of its own, their output to files (a
    blocked pipe could stall a world): worlds that only check, run side
    by side to save the script's time.  ``finish_torchruns`` collects
    them."""
    import tempfile

    from mpi_tensorflow_torch.parallel import mesh

    root = os.path.dirname(os.path.abspath(__file__))
    ports, started = set(), []
    try:
        for nproc, args in jobs:
            port = mesh.free_port()
            while port in ports:
                port = mesh.free_port()
            ports.add(port)
            out = tempfile.TemporaryFile("w+")
            started.append((subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 f"--nproc_per_node={nproc}", "--master_addr=127.0.0.1",
                 f"--master_port={port}", *args], cwd=root, stdout=out,
                stderr=subprocess.STDOUT, text=True,
                start_new_session=True), out, args))
    except BaseException:
        finish_torchruns(started, 0.0)
        raise
    return started


def finish_torchruns(started, timeout: float) -> list:
    """The standard outputs of ``start_torchruns``' worlds, in order,
    once each has exited.  At ``timeout`` seconds from now every process
    group still running is killed; a nonzero exit raises with the end of
    its output."""
    try:
        deadline = time.monotonic() + timeout
        for proc, _, _ in started:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, _, _ in started:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    outs = []
    for proc, out, args in started:
        out.seek(0)
        text = out.read()
        out.close()
        if proc.returncode != 0:
            raise AssertionError(f"torchrun {args} exited "
                                 f"{proc.returncode}:\n{text[-6000:]}")
        outs.append(text)
    return outs


def torchrun_all(jobs, timeout: float) -> list:
    """``start_torchruns(jobs)``, then their outputs, in order."""
    return finish_torchruns(start_torchruns(jobs), timeout)


def dp_result(out: str) -> dict:
    (line,) = [ln for ln in out.splitlines() if ln.startswith(DP_RESULT)]
    return json.loads(line[len(DP_RESULT):])


def join_world(backend: str):
    """A worker's rank device and world: ``nccl`` is the CLI's own choice
    (the rank's card, ``cpu:gloo,cuda:nccl``); ``gloo`` is the check-only
    world of several ranks on ``cuda:0``, the card this machine has
    (NCCL refuses two ranks on one card)."""
    from mpi_tensorflow_torch.parallel import mesh
    from mpi_tensorflow_torch.utils.device import resolve_device

    if backend == "nccl":
        dev = mesh.rank_device("cuda")
        mesh.initialize_distributed(dev)
    else:
        dev = torch.device("cuda", 0)
        mesh.initialize_distributed(dev, backend="gloo")
    return resolve_device(dev), mesh.process_index(), mesh.process_count()


def worker_psum_steps(backend: str) -> None:
    """11a / 11b: ``CNN_STEPS`` psum steps of ``MnistCnn`` (dropout 0,
    float32), each from the common state of a reference trajectory: the
    step across the ranks (one shard of 64 rows each, the all-reduce)
    against the in-process step over the world's shards concatenated."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.data import mnist, prefetch
    from mpi_tensorflow_torch.models import cnn
    from mpi_tensorflow_torch.parallel import collectives, mesh
    from mpi_tensorflow_torch.train import optimizer, step

    dev, rank, world = join_world(backend)
    # cuDNN's default algorithms are not bit-repeatable (the plain step
    # differs from itself): deterministic ones, in both arms, let the
    # bit-equality of the one-rank all-reduce show
    torch.backends.cudnn.deterministic = True
    mnist.ensure_data(CNN_DATA_DIR, verbose=False)
    splits = mnist.load_splits(CNN_DATA_DIR, num_shards=world)
    local_n = splits.train_labels.shape[0] // world
    tr_d = splits.train_data[:local_n * world].reshape(
        world, local_n, *splits.train_data.shape[1:])
    tr_l = splits.train_labels[:local_n * world].reshape(world, local_n)
    b = 64
    bs, ls = prefetch.assemble_window(tr_d, tr_l, 0, CNN_STEPS, CNN_STEPS, b)
    cfg = Config(dropout_rate=0.0)
    params = [t.to(dev) for t in cnn.init_params(
        torch.Generator().manual_seed(3)).values()]
    vel = [torch.zeros_like(t) for t in params]

    def same(a, b):
        (la, pa, va), (lb, pb, vb) = a, b
        return bool(torch.equal(la, lb)) and all(
            torch.equal(x, y) for x, y in zip(pa + va, pb + vb))

    def one_step(p, v, count, x, y, shards, across):
        model = cnn.MnistCnn(dict(zip(cnn.NAMES, p)), dropout_rate=0.0).to(
            dev)
        state = step.init_state(model)
        state.opt = optimizer.MomentumState([t.clone() for t in v], count)
        train_step = step.make_train_step(model, cfg, shards, local_n,
                                          across_ranks=across)
        state, m = train_step(state, torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev))
        return (m["loss"], [t.detach() for t in model.param_tree().values()],
                state.opt.velocity)

    loss_err, grad_err, losses = 0.0, [], []
    bit_equal = repeatable = True
    mine = slice(rank * b, (rank + 1) * b)
    for t in range(CNN_STEPS):
        for x in params + vel:              # one common state
            collectives.pbroadcast(x)
        count = np.float32(t)
        want_loss, want_p, want_v = one_step(params, vel, count, bs[t],
                                             ls[t], world, False)
        loss, got_p, got_v = one_step(params, vel, count, bs[t][mine],
                                      ls[t][mine], 1, True)
        loss_err = max(loss_err, abs(float(loss) - float(want_loss)))
        grad_err.append(max(float((a - w).norm() / w.norm())
                            for a, w in zip(got_v, want_v)))
        bit_equal = bit_equal and same((loss, got_p, got_v),
                                       (want_loss, want_p, want_v))
        # the control: the in-process step again, from the same state
        repeatable = repeatable and same(one_step(
            params, vel, count, bs[t], ls[t], world, False),
            (want_loss, want_p, want_v))
        losses.append(float(want_loss))
        params, vel = want_p, want_v
    # launches and device time a step, plain and across the ranks
    profile = {"plain": profile_psum_step(dev, params, bs[0][mine],
                                          ls[0][mine], local_n, False),
               "across_ranks": profile_psum_step(
                   dev, params, bs[0][mine], ls[0][mine], local_n, True)}
    if rank == 0:
        print(DP_RESULT + json.dumps({
            "case": "psum_steps", "backend": backend, "world": world,
            "profile": profile,
            "device": str(dev), "steps": CNN_STEPS, "loss_err": loss_err,
            "grad_rel_err": float(np.median(grad_err)),
            "grad_rel_err_max": max(grad_err), "bit_equal": bit_equal,
            "reference_repeatable": repeatable,
            "losses": [losses[0], losses[-1]]}), flush=True)
    mesh.shutdown()


PROFILED_STEPS = 20


def profile_psum_step(dev, params, x, y, decay_steps: int,
                      across: bool) -> dict:
    """One rank's psum step of 64 rows (float32, dropout 0), plain or
    across the ranks, under ``torch.profiler`` for ``PROFILED_STEPS``
    steps: kernels (memory copies included) and device busy ms a step,
    and the collective's share: NCCL's kernels and gloo's copies."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import cnn
    from mpi_tensorflow_torch.train import step
    from mpi_tensorflow_torch.utils import profiling

    model = cnn.MnistCnn(dict(zip(cnn.NAMES, params)), dropout_rate=0.0).to(
        dev)
    state = step.init_state(model)
    train_step = step.make_train_step(model, Config(dropout_rate=0.0), 1,
                                      decay_steps, across_ranks=across)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def run():
        for _ in range(PROFILED_STEPS):
            train_step(state, x, y)

    kernels = profiling.profiled_kernels(run, run)
    summary = profiling.device_summary(kernels)
    comm = [e for e in kernels if any(k in e.name.lower()
                                      for k in ("nccl", "memcpy"))]
    return {
        "kernels_a_step": len(kernels) / PROFILED_STEPS,
        "device_busy_ms_a_step": summary["device_busy_ms"] / PROFILED_STEPS,
        "collective_ms_a_step": sum(
            e.time_range.end - e.time_range.start for e in comm)
        / 1e3 / PROFILED_STEPS,
        "collective_kernels": sorted({e.name[:60] for e in comm})}


AVG50_ARGS = ["--data-dir", CNN_DATA_DIR, "--epochs", "1"]


def worker_avg50_epoch(backend: str, argv=AVG50_ARGS, load=None) -> None:
    """11b: ``python -m mpi_tensorflow_torch --sync avg50 --epochs 1``'s
    path (``cli.main`` in this rank, in the world joined here), every
    average step watched: the replicas gathered before it (they must
    differ) and after it (bit-identical), and the average against the
    mean of the gathered replicas, in ulps (13d: the same for a ResNet,
    its BatchNorm state's ulps also alone, on the splits ``load`` gives
    in place of ``loop.load_dataset``'s)."""
    from mpi_tensorflow_torch import cli
    from mpi_tensorflow_torch.parallel import collectives, mesh
    from mpi_tensorflow_torch.train import loop, step
    from mpi_tensorflow_torch.utils import tree as tree_lib

    dev, rank, world = join_world(backend)
    checks = []
    make_average = step.make_average_step

    def flat(state):
        """Parameters and velocity, then the model state."""
        tensors = tree_lib.leaves(state.model.param_tree())
        head = torch.cat([t.detach().reshape(-1) for t in
                          tensors + state.opt.velocity]).cpu().numpy()
        leaves = tree_lib.leaves(state.model_state)
        tail = torch.cat([t.reshape(-1) for t in leaves]).cpu().numpy() \
            if leaves else np.zeros(0, np.float32)
        return np.concatenate([head, tail]), head.size

    def watched_average(state):
        average = make_average(state)

        def call(state):
            before, n = flat(state)
            before = collectives.host_allgather(before)
            state = average(state)
            after = collectives.host_allgather(flat(state)[0])
            mean = (before[0] + before[1]) / np.float32(2) if world == 2 \
                else before.mean(0, dtype=np.float32)
            ulp = np.abs(after[rank] - mean) / np.spacing(np.abs(mean))
            checks.append({
                "differ_before": not np.array_equal(before[0], before[1]),
                "identical_after": all(np.array_equal(after[0], a)
                                       for a in after),
                "max_ulp": float(ulp.max()),
                "state_values": int(ulp.size - n),
                "state_differ_before": not np.array_equal(
                    before[0][n:], before[1][n:]),
                "state_max_ulp": float(ulp[n:].max()) if ulp.size > n
                else None})
            return state
        return call

    results = []
    real_train = loop.train

    def recorded_train(*a, **kw):
        results.append(real_train(*a, **kw))
        return results[-1]

    real_load = loop.load_dataset
    step.make_average_step, loop.train = watched_average, recorded_train
    loop.load_dataset = load or real_load
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.main([*argv, "--sync", "avg50", "--device", str(dev)])
    finally:
        step.make_average_step, loop.train = make_average, real_train
        loop.load_dataset = real_load
    (res,) = results
    if rank == 0:
        print(out.getvalue(), end="")
        print(DP_RESULT + json.dumps({
            "case": "avg50_epoch", "backend": backend, "world": world,
            "device": str(dev), "steps": res.num_steps,
            "history": res.history, "final_test_error": res.final_test_error,
            "final_loss": res.final_loss,
            "images_per_sec": res.images_per_sec,
            "step_ms": res.step_time_seconds * 1e3, "averages": checks,
            "lines": out.getvalue().splitlines()}), flush=True)
    mesh.shutdown()


WORKERS = {"psum_steps": worker_psum_steps,
           "avg50_epoch": worker_avg50_epoch}


def check_psum_steps(res: dict) -> None:
    """The psum steps across the ranks within ``CNN_TOL`` (float32) of
    the in-process step; bit-equality is printed beside the in-process
    step's own repeatability (cuDNN may pick a non-deterministic
    algorithm unless asked for a deterministic one), not held."""
    tol = CNN_TOL["fp32"]
    log(f"[dp] psum, {res['world']} rank(s) over {res['backend']} on "
        f"{res['device']}: {res['steps']} steps, each from a common state, "
        f"against the in-process step over {res['world']} shard(s): loss "
        f"diff {res['loss_err']:.3e}, gradient rel. diff median "
        f"{res['grad_rel_err']:.3e} (max {res['grad_rel_err_max']:.3e}) "
        f"(tolerance {tol}); bit-equal: {res['bit_equal']} (the "
        f"in-process step bit-equal to itself: "
        f"{res['reference_repeatable']}); losses "
        f"{res['losses'][0]:.6f} -> {res['losses'][1]:.6f}; a step of 64 "
        f"rows on rank 0, plain / across the ranks: "
        f"{json.dumps(res['profile'])}")
    if res["loss_err"] > tol["loss"] or res["grad_rel_err"] > tol["grad"]:
        raise AssertionError(f"distributed psum step: {res}")


def trainer_timing(lines) -> dict:
    """images/sec and step ms of a ``[timing]`` line."""
    (ln,) = [ln for ln in lines if ln.startswith("[timing]")]
    m = re.match(r"\[timing\] ([\d,.]+) images/sec .*\| step ([\d.]+) ms",
                 ln)
    return {"images_per_sec": float(m[1].replace(",", "")),
            "step_ms": float(m[2])}


def check_trace(lines, world: int, want_steps: list, what: str) -> list:
    """The trace lines: ``world`` lines a trace point in rank order, at
    the steps ``want_steps``; ``[(step, rank 0's error)]``."""
    pat = re.compile(r"(\d+)  process at  (\d+) with test error: "
                     r"(\d+\.\d)%")
    trace = [pat.fullmatch(ln) for ln in lines]
    trace = [(int(m[1]), int(m[2]), float(m[3])) for m in trace if m]
    want = [(r, t) for t in want_steps for r in range(world)]
    if [(r, t) for r, t, _ in trace] != want \
            or lines.count("Process ID: 0  training session starts!") != 1:
        raise AssertionError(f"{what}: trace {[(r, t) for r, t, _ in trace]}"
                             f", want {want}")
    return [(t, e) for r, t, e in trace if r == 0]


def dp_phase(card: str, cnn: dict) -> dict:
    """Phase 11: the data axis over ``torch.distributed``.  11a: NCCL at
    world size 1 — the zero-flag trainer for one epoch through torchrun,
    and the psum step across the ranks against the plain one; 11b: two
    ranks on ``cuda:0`` over gloo — psum steps against the in-process
    two-shard step, and one avg50 epoch with every average watched;
    11c: the allreduce bench at world size 1 over NCCL (in 13e's bench
    child).  Returns, besides, 13d's three worlds' results."""
    every50 = lambda n: [t for t in range(1, n) if t % 50 == 0] + [n - 1]
    me = os.path.abspath(__file__)
    phase("11a")
    # cut for the script's time: 11a's NCCL psum check runs in 11b's
    # batch of check worlds, side by side with them (its profile then
    # shares the card, as 11b's gloo one does)
    t0 = time.perf_counter()
    out = torchrun(1, ["-m", "mpi_tensorflow_torch", "--data-dir",
                       CNN_DATA_DIR, "--epochs", "1"], 600)
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    trace = check_trace(lines, 1, every50(781), "torchrun, 1 rank")
    if not trace[-1][1] < 30.0 or trace[-1][1] > trace[0][1]:
        raise AssertionError(f"torchrun, 1 rank: errors {trace}")
    one = trainer_timing(lines)
    ref = cnn["runs"]["fp32"]
    log(f"[dp] torchrun --nproc_per_node 1 -m mpi_tensorflow_torch --epochs"
        f" 1 (NCCL, world 1): 781 steps, {len(trace)} trace points, "
        f"errors {trace[0][1]} -> {trace[-1][1]} %; "
        f"{one['images_per_sec']} images/s, step {one['step_ms']} ms beside"
        f" phase 10b's {ref['images_per_sec']:.1f} images/s, "
        f"{ref['step_ms']:.3f} ms (no process group); wall {wall:.1f} s; "
        f"{card}")
    phase("11b")
    # the check-only worlds side by side, 11a's NCCL psum world and 13d's
    # three ResNet worlds with them (for the script's time): 13d reads
    # their results
    nccl_steps, gloo_steps, avg, *resnet_worlds = map(dp_result, torchrun_all(
        [(1, [me, "--worker", "psum_steps", "nccl"]),
         (2, [me, "--worker", "psum_steps", "gloo"]),
         (2, [me, "--worker", "avg50_epoch", "gloo"]),
         (2, [me, "--worker", "resnet_psum_steps", "gloo"]),
         (2, [me, "--worker", "resnet_avg50", "gloo"]),
         (1, [me, "--worker", "resnet_nccl", "nccl"])], 900))
    check_psum_steps(nccl_steps)
    check_psum_steps(gloo_steps)
    trace = check_trace(avg["lines"], 2, every50(390), "avg50, 2 ranks")
    errs = [e for _, e in avg["history"]]
    checks = avg["averages"]
    problems = []
    if [t for t, _ in avg["history"]] != every50(390) \
            or len(checks) != len(every50(390)) - 1:
        problems.append(f"history {avg['history']}, {len(checks)} averages")
    if not all(c["differ_before"] and c["identical_after"]
               and c["max_ulp"] <= 1.0 for c in checks):
        problems.append(f"averages {checks}")
    if not avg["final_test_error"] < 30.0 or errs[-1] > errs[0]:
        problems.append(f"errors {errs}")
    if problems:
        raise AssertionError(f"avg50, 2 ranks over gloo: {problems}")
    log(f"[dp] avg50, 2 ranks on cuda:0 over gloo, one epoch: "
        f"{avg['steps']} steps, {len(trace)} trace points x 2 lines, "
        f"{len(checks)} averages: replicas apart before each and "
        f"bit-identical after each, the average within "
        f"{max(c['max_ulp'] for c in checks)} ulp of the gathered mean; "
        f"test error {errs[0]} -> {errs[-1]} %; rank 0: "
        f"{avg['images_per_sec']:.1f} images/s, step {avg['step_ms']:.3f} "
        f"ms (two ranks share the card, beside the psum check's world); "
        f"{card}")
    # 11c, the allreduce bench, runs in 13e's bench child
    return {"nccl_world1": one, "nccl_steps": nccl_steps,
            "gloo_steps": gloo_steps, "avg50": avg,
            "resnet_worlds": resnet_worlds}


# --------------------------------------------------------------- phase 12

# 12a: the data-parallel BERT trainer through the CLI in a torchrun rank,
# at phase 7's shape and cadence: 8 steps (32 train rows, batch 4), trace
# points at steps 4 and 7 (the timer skips the first span, so one point
# would leave no step timed), 2 held-out forwards of 4 rows at each
DP_BERT_ARGS = ["--model", "bert_base", "--seq-len", str(TRAIN_SEQ),
                "--batch-size", str(TRAIN_BATCH), "--precision", "bf16",
                "--epochs", "1", "--train-n", str(TRAIN_N), "--test-n",
                str(TEST_N), "--log-every", str(LOG_EVERY)]
DP_BERT_STEPS, DP_BERT_EVALS = TRAIN_N // TRAIN_BATCH, 4
# 12a's world-1 check and 12b: float32, 2 layers at full width, S = 512
# with the flash kernels taken from there (the CUDA-core kernels in
# float32), dropout 0, global batch 4, 3 steps of transformer_tx(1e-4)
# from a common state (phase 8's recipe and tolerances: a loss within
# 1e-4, every parameter within 1e-5, bk within 3 x lr -- its gradient is
# zero in exact arithmetic and adamw normalises each run's float noise)
DP_SEQ, DP_GLOBAL_B, DP_STEPS, DP_LR = 512, 4, 3, 1e-4
DP_TOL = {"loss": 1e-4, "param": 1e-5, "bk": 3 * DP_LR}
DP_CASES = (("replicated", "replicated", 1), ("accum2", "replicated", 2),
            ("zero1", "zero1", 1), ("fsdp", "fsdp", 1))


def dp_bert_cfg():
    from mpi_tensorflow_torch.models import bert

    return dataclasses.replace(bert.BERT_BASE, layers=2, dropout=0.0,
                               flash_min_seq=DP_SEQ)


def dp_bert_batches():
    """``DP_STEPS`` global batches of ``DP_GLOBAL_B`` rows (numpy)."""
    from mpi_tensorflow_torch.data import synthetic

    tokens, targets, mask = synthetic.mlm_batches(
        DP_STEPS * DP_GLOBAL_B, seq_len=DP_SEQ,
        vocab_size=dp_bert_cfg().vocab_size, seed=5)
    shape = (DP_STEPS, DP_GLOBAL_B, DP_SEQ)
    return tokens.reshape(shape), targets.reshape(shape), mask.reshape(shape)


def dp_bert_run(dev, kind: str, accum: int, rows, across: bool) -> dict:
    """``DP_STEPS`` steps of ``dp_bert_cfg`` from the seed-0 state in
    ``kind``'s layout, feeding ``rows`` of each global batch: the losses,
    the whole parameters after them (on the card) and the bytes at rest.
    """
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import gspmd, optimizer

    tokens, targets, mask = dp_bert_batches()
    model = bert.BertMlm.from_seed(dp_bert_cfg(), 0).to(dev)
    tx = optimizer.transformer_tx(DP_LR, DP_STEPS)
    state = gspmd.init_for(kind, model, tx)
    step = gspmd.make_train_step(tx, grad_accum=accum, across_ranks=across)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
    losses = []
    for t in range(DP_STEPS):
        state, m = step(state, {"tokens": put(tokens[t]),
                                "mask": put(mask[t])}, put(targets[t]))
        losses.append(m["loss"])
    with gspmd.full_params(state) as whole:
        params = {n: p.detach().clone() for n, p in whole.named_parameters()}
    return {"losses": torch.stack(losses), "params": params,
            "bytes": gspmd.bytes_at_rest(state)}


def dp_bert_diff(got: dict, want: dict) -> dict:
    """The largest differences of two ``dp_bert_run`` results, and
    whether they are bit-equal."""
    loss = float((got["losses"] - want["losses"]).abs().max())
    param, bk = 0.0, 0.0
    for n, p in got["params"].items():
        e = float((p - want["params"][n]).abs().max())
        if n.endswith(".bk"):
            bk = max(bk, e)
        else:
            param = max(param, e)
    equal = bool(torch.equal(got["losses"], want["losses"])) and all(
        torch.equal(p, want["params"][n]) for n, p in got["params"].items())
    return {"loss": loss, "param": param, "bk": bk, "bit_equal": equal}


def dp_bert_within(diff: dict) -> bool:
    return all(diff[k] <= DP_TOL[k] for k in DP_TOL)


def worker_bert_train(backend: str) -> None:
    """12a: ``python -m mpi_tensorflow_torch --model bert_base``'s path
    (``cli.main`` in this rank, in the world joined here) at phase 7's
    shape, with each flash kernel's launches counted, plain and with
    ``--grad-accum 2``; then the step across the ranks against the
    one-process step from the seed-0 state."""
    from mpi_tensorflow_torch import cli
    from mpi_tensorflow_torch.parallel import mesh
    from mpi_tensorflow_torch.train import gspmd, mlm_loop
    from mpi_tensorflow_torch.utils import flops

    dev, rank, world = join_world(backend)
    torch.empty(0, device=dev)           # the allocator up, for its stats
    runs = {}
    real_train = mlm_loop.train_mlm
    for accum in (1, 2):
        results = []

        def recorded(*a, **kw):
            results.append(real_train(*a, **kw))
            return results[-1]

        mlm_loop.train_mlm = recorded
        torch.cuda.reset_peak_memory_stats(dev)
        set_flash_counts({k: 0 for k in FLASH})
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                cli.main([*DP_BERT_ARGS, "--grad-accum", str(accum),
                          "--device", str(dev)])
        finally:
            mlm_loop.train_mlm = real_train
        torch.cuda.synchronize(dev)
        (res,) = results
        model_flops = flops.transformer_train_flops(
            res.state.model.cfg, TRAIN_BATCH, TRAIN_SEQ)
        runs[accum] = {
            "launches": flash_counts(), "steps": res.num_steps,
            "history": res.history, "final_loss": res.final_loss,
            "step_ms": res.step_time_seconds * 1e3,
            "tokens_per_sec": res.tokens_per_sec,
            "mfu_bf16": flops.mfu(model_flops, res.step_time_seconds,
                                  "bf16"),
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "bytes_at_rest": gspmd.bytes_at_rest(res.state),
            "num_devices": res.num_devices,
            "lines": out.getvalue().splitlines()}
        del res, results
    rows = np.arange(DP_GLOBAL_B)
    across = dp_bert_run(dev, "replicated", 1, rows, True)
    plain = dp_bert_run(dev, "replicated", 1, rows, False)
    again = dp_bert_run(dev, "replicated", 1, rows, False)
    if rank == 0:
        print(DP_RESULT + json.dumps({
            "case": "bert_train", "backend": backend, "world": world,
            "device": str(dev), "runs": runs,
            "dp_vs_plain": dp_bert_diff(across, plain),
            "plain_repeatable": dp_bert_diff(again, plain)["bit_equal"]}),
            flush=True)
    mesh.shutdown()


def worker_bert_steps(backend: str) -> None:
    """12b: ``DP_STEPS`` steps of each layout of ``DP_CASES`` across the
    ranks, each rank feeding its rows of every global batch, against the
    one-process step on the whole global batch (with the same
    accumulation), and zero1 and fsdp against replicated; each rank's
    bytes at rest."""
    from mpi_tensorflow_torch.parallel import collectives, fsdp, mesh
    from mpi_tensorflow_torch.train import mlm_loop

    dev, rank, world = join_world(backend)
    whole = np.arange(DP_GLOBAL_B)
    runs, plain = {}, {}
    t0 = time.perf_counter()
    for name, kind, accum in DP_CASES:
        rows = mlm_loop.rank_rows(0, DP_GLOBAL_B, accum, rank, world)
        runs[name] = dp_bert_run(dev, kind, accum, rows, True)
    sec = time.perf_counter() - t0
    bytes_at_rest = collectives.host_allgather(np.array(
        [[runs[n]["bytes"][k] for k in ("params", "moments",
                                         "replica_params",
                                         "replica_moments")]
         for n, _, _ in DP_CASES], dtype=np.int64)).tolist()
    if rank != 0:
        mesh.shutdown()
        return
    for accum in (1, 2):         # rank 0 alone: no collective
        plain[accum] = dp_bert_run(dev, "replicated", accum, whole, False)
    shapes = {n: tuple(p.shape) for n, p in
              runs["replicated"]["params"].items()}
    counts = dp_bert_batches()[2].reshape(DP_STEPS, world, -1).sum(-1)
    print(DP_RESULT + json.dumps({
        "case": "bert_steps", "backend": backend, "world": world,
        "device": str(dev), "seconds": sec,
        "masked_counts_by_rank": counts.tolist(),
        "vs_plain": {name: dp_bert_diff(runs[name], plain[accum])
                     for name, _, accum in DP_CASES},
        "vs_replicated": {name: dp_bert_diff(runs[name],
                                             runs["replicated"])
                          for name in ("zero1", "fsdp")},
        "losses": runs["replicated"]["losses"].tolist(),
        "bytes": bytes_at_rest,
        "replicated_leaves": sorted(
            int(np.prod(s)) for s in shapes.values()
            if fsdp.shard_dim(s, world) is None)}), flush=True)
    mesh.shutdown()


WORKERS.update(bert_train=worker_bert_train, bert_steps=worker_bert_steps)


def bert_dp_phase(card: str, phase7: dict, beside=()) -> dict:
    """Phase 12: data-parallel BERT-base training.  12a: NCCL at world
    size 1 through the CLI, the flash kernels counted, beside phase 7;
    12b: two ranks on ``cuda:0`` over gloo, every layout against the
    one-process step (12c, the bench under torchrun: 13e's child).
    ``beside``: more check-only worlds (``(nproc, args)``) run beside
    12b's; their outputs are returned under ``"beside"``."""
    me = os.path.abspath(__file__)
    phase("12a")
    res = dp_result(torchrun(1, [me, "--worker", "bert_train", "nccl"], 600))
    problems = []
    for accum, run in res["runs"].items():
        accum = int(accum)
        steps = run["steps"]
        want = {"flash_fwd": 12 * (steps * accum + DP_BERT_EVALS),
                "flash_dq": 12 * steps * accum,
                "flash_dkdv": 12 * steps * accum}
        if steps != DP_BERT_STEPS or run["launches"] != want:
            problems.append(f"grad_accum {accum}: {steps} steps, flash "
                            f"launches {run['launches']} != {want}")
        trace = check_trace(run["lines"], 1, [LOG_EVERY, DP_BERT_STEPS - 1],
                            f"torchrun BERT, grad_accum {accum}")
        if not np.isfinite(run["final_loss"]) or run["num_devices"] != 1 \
                or not any(ln.startswith("[timing]") and
                           ln.endswith("| 1 device(s)")
                           for ln in run["lines"]):
            problems.append(f"grad_accum {accum}: loss {run['final_loss']}, "
                            f"lines {run['lines']}")
        log(f"[dp bert] torchrun --nproc_per_node 1 -m mpi_tensorflow_torch "
            f"{' '.join(DP_BERT_ARGS)} --grad-accum {accum} (NCCL, world "
            f"1): {steps} steps, trace {trace}, final loss "
            f"{run['final_loss']:.4f}; flash launches {run['launches']} "
            f"(12 layers x {steps} steps x {accum} microbatch(es), fwd + "
            f"{DP_BERT_EVALS} eval forwards); {run['tokens_per_sec']:.1f} "
            f"tokens/s, step {run['step_ms']:.3f} ms, MFU "
            f"{100 * run['mfu_bf16']:.2f} %, peak "
            f"{run['peak_memory_gib']:.3f} GiB, at rest "
            f"{json.dumps(run['bytes_at_rest'])}; phase 7's one-process run "
            f"in this call: {phase7['tokens_per_sec']:.1f} tokens/s, step "
            f"{phase7['step_ms']:.3f} ms, MFU {100 * phase7['mfu_bf16']:.2f}"
            f" %, peak {phase7['peak_memory_gib']:.3f} GiB; {card}")
    diff = res["dp_vs_plain"]
    log(f"[dp bert] the step across 1 rank (NCCL) against the one-process "
        f"step, float32, 2 layers at full width, S={DP_SEQ}, B="
        f"{DP_GLOBAL_B}, {DP_STEPS} steps from the seed-0 state: "
        f"{json.dumps(diff)} (tolerance {DP_TOL}); the one-process step "
        f"bit-equal to itself: {res['plain_repeatable']}")
    if not dp_bert_within(diff):
        problems.append(f"world-1 step against the one-process step: "
                        f"{diff}")
    if problems:
        raise AssertionError(f"phase 12a: {problems}")
    phase("12b")
    # 14d's two-rank save runs beside this check-only world (for the
    # script's time); 14d restores what it saved
    shutil.rmtree(os.path.join(CKPT_DIR, "dp"), ignore_errors=True)
    outs = torchrun_all([(2, [me, "--worker", "bert_steps", "gloo"]),
                         (2, [me, "--worker", "ckpt_save", "gloo"]),
                         *beside], 900)
    steps, ckpt_save = map(dp_result, outs[:2])
    bad = {n: d for n, d in {**steps["vs_plain"],
                             **{f"{n} vs replicated": d for n, d in
                                steps["vs_replicated"].items()}}.items()
           if not dp_bert_within(d)}
    shares = {}
    for r, per_rank in enumerate(steps["bytes"]):
        for (name, _, _), (p, m, rp, rm) in zip(DP_CASES, per_rank):
            shares[name, r] = {"params": p / rp, "moments": m / rm,
                               "params+moments": (p + m) / (rp + rm),
                               "bytes": p + m}
    for r in range(2):
        zero1, fsdp_share = shares["zero1", r], shares["fsdp", r]
        if not (zero1["params"] == 1.0 and 0.5 <= zero1["moments"] < 0.51
                and 0.5 <= fsdp_share["params+moments"] < 0.51
                and shares["replicated", r]["params+moments"] == 1.0):
            bad[f"bytes at rest, rank {r}"] = {
                n: shares[n, r] for n, _, _ in DP_CASES}
    if max(steps["replicated_leaves"]) >= 1024:
        bad["replicated leaves"] = steps["replicated_leaves"]
    log(f"[dp bert] 2 ranks on cuda:0 over gloo, float32, 2 layers at full "
        f"width, S={DP_SEQ}, global batch {DP_GLOBAL_B} (masked positions "
        f"by step and rank {steps['masked_counts_by_rank']}), {DP_STEPS} "
        f"steps each: against the one-process step on the global rows "
        f"{json.dumps(steps['vs_plain'])}; zero1 and fsdp against "
        f"replicated {json.dumps(steps['vs_replicated'])} (tolerance "
        f"{DP_TOL}); losses {steps['losses']}; the four layouts "
        f"{steps['seconds']:.1f} s (two ranks share the card)")
    log(f"[dp bert] bytes at rest (parameters + moments) per rank, share "
        f"of a replica: " + "; ".join(
            f"{n} rank {r}: params {s['params']:.4f}, moments "
            f"{s['moments']:.4f}, both {s['params+moments']:.4f} "
            f"({s['bytes']} B)" for (n, r), s in shares.items())
        + f"; {len(steps['replicated_leaves'])} leaves stay whole, the "
          f"largest of {max(steps['replicated_leaves'])} elements")
    if bad:
        raise AssertionError(f"phase 12b: {bad}")
    # 12c, the bench's transformer lines under torchrun, runs in 13e's
    # child (one launch for all of the bench's lines)
    return {"bert_train": res, "bert_steps": steps, "ckpt_save": ckpt_save,
            "beside": outs[2:]}


# --------------------------------------------------------------- phase 22

# 22a: the model and seq axes against the one-process step, at 12b's
# recipe (float32, 2 layers at full width, S = 512 with the flash
# kernels from there, dropout 0, 3 steps of transformer_tx(1e-4) from the
# seed-0 state, DP_TOL) on a global batch of 2; ranks on cuda:0 over
# gloo.  (name, mesh, family, sp_impl, attention): the Ulysses cases
# take "flash", whose kernels run on the H / N heads a rank holds after
# its all-to-all; the model axis takes them on its H / M heads ("auto"
# at S = flash_min_seq); the ring runs no hand kernel.
TPSP_B = 2
TPSP_TWO = (("model", {"model": 2}, "bert_base", "ring", "auto"),
            ("seq_ring", {"seq": 2}, "bert_base", "ring", "auto"),
            ("seq_ulysses", {"seq": 2}, "bert_base", "ulysses", "flash"),
            ("gpt_seq_ring", {"seq": 2}, "gpt_base", "ring", "auto"))
TPSP_FOUR = (("model_seq_ring", {"model": 2, "seq": 2}, "bert_base", "ring",
              "auto"),
             ("model_seq_ulysses", {"model": 2, "seq": 2}, "bert_base",
              "ulysses", "flash"))
# 22b: config 5 (BERT_BASE bf16, S = 4096, batch 4, dropout 0.1) through
# train_mlm on two gloo ranks: 3 steps and one eval forward
TPSP5 = (("seq_ulysses", {"seq": 2}, "ulysses"),
         ("seq_ring", {"seq": 2}, "ring"),
         ("model", {"model": 2}, "ring"))
TPSP5_STEPS, TPSP5_EVALS = 3, 1
# the dropout-0 first step against the one-process step, both bf16: the
# relative distance of the first moments (the clipped gradient x 0.1)
# and of the losses; the control (the one-process step on the next
# batch) must land outside both bounds.  The sharded runs read <= 8.1e-5
# in the loss and the control 1.96e-2 (H100 80GB HBM3, 700 W)
TPSP5_TOL = {"moments": 5e-2, "loss": 2e-3}


def _named(tree) -> dict:
    """``{"layers.0.wq": leaf, ...}`` of a parameter tree."""
    from mpi_tensorflow_torch.utils import tree as tree_lib

    return {".".join(map(str, p)): v
            for p, v in tree_lib.leaves_with_path(tree)}


def tpsp_run(dev, case, rows, steps: int = DP_STEPS) -> dict:
    """22a: ``steps`` steps of ``case`` (a ``TPSP_TWO`` / ``TPSP_FOUR``
    entry; its mesh None: the one-process step) on ``rows`` of each
    global batch: the losses, the parameters gathered whole, each flash
    kernel's launches on this rank."""
    from mpi_tensorflow_torch.parallel import mesh as meshlib
    from mpi_tensorflow_torch.train import gspmd, mlm_loop, optimizer

    _, shape, family, sp_impl, attention = case
    mesh = meshlib.make_mesh(shape) if shape else None
    tokens, targets, mask = dp_bert_batches()
    cfg = dataclasses.replace(dp_bert_cfg(), sp_impl=sp_impl)
    model = mlm_loop.FAMILIES[family].from_seed(cfg, 0, attention,
                                                mesh=mesh).to(dev)
    tx = optimizer.transformer_tx(DP_LR, DP_STEPS)
    state = gspmd.init_for("replicated", model, tx)
    step = gspmd.make_train_step(tx, across_ranks=mesh is not None)
    n = DP_SEQ // (mesh.axis_size("seq") if mesh else 1)
    q = mesh.axis_index("seq") if mesh else 0
    put = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[rows][:, q * n:(q + 1) * n])).to(dev)
    set_flash_counts({k: 0 for k in FLASH})
    losses = []
    for t in range(steps):
        state, m = step(state, {"tokens": put(tokens[t]),
                                "mask": put(mask[t])}, put(targets[t]))
        losses.append(m["loss"])
    torch.cuda.synchronize(dev)
    launches = flash_counts()
    return {"losses": torch.stack(losses),
            "params": _named(gspmd.gathered_params(state)),
            "launches": launches}


def worker_tpsp_steps(backend: str) -> None:
    """22a: each case of ``TPSP_TWO`` (two ranks) or ``TPSP_FOUR`` (four)
    across the world, then on rank 0 alone the one-process step of each
    family against them."""
    from mpi_tensorflow_torch.parallel import mesh

    dev, rank, world = join_world(backend)
    cases = TPSP_TWO if world == 2 else TPSP_FOUR
    rows = np.arange(TPSP_B)
    t0 = time.perf_counter()
    runs = {c[0]: tpsp_run(dev, c, rows) for c in cases}
    sec = time.perf_counter() - t0
    launches = {c[0]: runs[c[0]]["launches"] for c in cases}
    if rank != 0:
        mesh.shutdown()
        return
    plain = {}
    for _, _, family, _, _ in cases:
        if family not in plain:
            plain[family] = tpsp_run(dev, ("plain", None, family, "ring",
                                           "auto"), rows)
    print(DP_RESULT + json.dumps({
        "case": "tpsp_steps", "world": world, "seconds": sec,
        "vs_plain": {c[0]: dp_bert_diff(runs[c[0]], plain[c[2]])
                     for c in cases},
        "launches": launches,
        "plain_launches": {f: p["launches"] for f, p in plain.items()},
        "losses": {c[0]: runs[c[0]]["losses"].tolist() for c in cases}}),
        flush=True)
    mesh.shutdown()


def _leaf_hash(x) -> int:
    """An exact fingerprint of a float32 tensor's bytes."""
    return int(x.detach().contiguous().view(torch.int32).to(
        torch.int64).sum())


def tpsp5_first_step(dev, shape, sp_impl, batch: int) -> dict:
    """22b: one dropout-0 step of config 5 on the global batch ``batch``
    (mesh ``shape``; None: one process): the loss and the first moments
    gathered whole and flattened (float32, on the card)."""
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.parallel import mesh as meshlib
    from mpi_tensorflow_torch.parallel import sharding_rules
    from mpi_tensorflow_torch.train import gspmd, optimizer
    from mpi_tensorflow_torch.utils import tree as tree_lib

    mesh = meshlib.make_mesh(shape) if shape else None
    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                              max_positions=TRAIN_SEQ, dropout=0.0,
                              sp_impl=sp_impl)
    model = bert.BertMlm.from_seed(cfg, 0, mesh=mesh).to(dev)
    tx = optimizer.transformer_tx(1e-4, TPSP5_STEPS)
    state = gspmd.init_for("replicated", model, tx)
    step = gspmd.make_train_step(tx, across_ranks=mesh is not None)
    tokens, targets, mask = synthetic.mlm_batches(
        2 * TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size,
        seed=9)
    rows = slice(batch * TRAIN_BATCH, (batch + 1) * TRAIN_BATCH)
    n = TRAIN_SEQ // (mesh.axis_size("seq") if mesh else 1)
    q = mesh.axis_index("seq") if mesh else 0
    put = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[rows, q * n:(q + 1) * n])).to(dev)
    _, m = step(state, {"tokens": put(tokens), "mask": put(mask)},
                put(targets))
    mu = tree_lib.unflatten(model.param_tree(), state.opt.mu)
    if model.tp is not None:
        mu = sharding_rules.gather_tree(mu, model.logical_axes(), mesh)
    flat = torch.cat([x.reshape(-1) for x in tree_lib.leaves(mu)])
    loss = float(m["loss"])
    del model, state, mu
    return {"loss": loss, "moments": flat}


def worker_tpsp_config5(backend: str) -> None:
    """22b: each case of ``TPSP5`` through ``train_mlm`` on this world
    (each rank's flash launches, peak GiB, step ms of the host-staged
    transfers, the losses; the leaves whole on every rank fingerprinted
    and compared over the ranks), then its dropout-0 first step; on
    rank 0 alone after the world, the one-process first steps (the
    batch and the control's next batch) against them."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.parallel import collectives, mesh
    from mpi_tensorflow_torch.train import gspmd, mlm_loop
    from mpi_tensorflow_torch.utils import tree as tree_lib

    dev, rank, world = join_world(backend)
    torch.empty(0, device=dev)
    runs, firsts = {}, {}
    times, make = [], gspmd.make_train_step

    def timed(*a, **kw):
        # each train step's wall time, the card synchronised around it
        # (train_mlm's own timer skips its first window, here the only one)
        step = make(*a, **kw)

        def call(*args):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t)
            return out
        return call
    for name, shape, sp_impl in TPSP5:
        cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                                  max_positions=TRAIN_SEQ, sp_impl=sp_impl)
        config = Config(model="bert_base", dataset="mlm_synthetic",
                        epochs=1, batch_size=TRAIN_BATCH, log_every=100,
                        precision="bf16", mesh_shape=shape)
        torch.cuda.reset_peak_memory_stats(dev)
        set_flash_counts({k: 0 for k in FLASH})
        t0 = time.perf_counter()
        times.clear()
        gspmd.make_train_step = timed
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                res = mlm_loop.train_mlm(
                    config, cfg, seq_len=TRAIN_SEQ,
                    train_n=TPSP5_STEPS * TRAIN_BATCH, test_n=TRAIN_BATCH,
                    device=dev)
        finally:
            gspmd.make_train_step = make
        torch.cuda.synchronize(dev)
        sec = time.perf_counter() - t0
        model = res.state.model
        whole = [sp == () for sp in model.leaf_specs()]
        hashes = np.array([_leaf_hash(p) if w else 0 for p, w in zip(
            tree_lib.leaves(model.param_tree()), whole)], np.int64)
        every = collectives.host_allgather(hashes)
        runs[name] = {
            "launches": flash_counts(), "steps": res.num_steps,
            "evals": len(res.history), "final_loss": res.final_loss,
            "step_ms": [t * 1e3 for t in times],
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "whole_leaves": int(sum(whole)),
            "whole_leaves_identical": bool((every == every[0]).all()),
            "seconds": sec}
        del res, model
        firsts[name] = tpsp5_first_step(dev, shape, sp_impl, 0)
        torch.cuda.empty_cache()
    per_rank = collectives.host_allgather(np.array(
        [[runs[n]["peak_memory_gib"], runs[n]["launches"]["flash_fwd"],
          runs[n]["launches"]["flash_dq"], runs[n]["launches"]["flash_dkdv"]]
         for n, _, _ in TPSP5], np.float64)).tolist()
    if rank != 0:
        mesh.shutdown()
        return
    mesh.shutdown()
    torch.cuda.reset_peak_memory_stats(dev)
    plain = tpsp5_first_step(dev, None, "ring", 0)
    plain_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    control = tpsp5_first_step(dev, None, "ring", 1)

    def apart(got):
        ref = plain["moments"]
        return {"moments": float((got["moments"] - ref).norm() / ref.norm()),
                "loss": abs(got["loss"] - plain["loss"])}

    print(DP_RESULT + json.dumps({
        "case": "tpsp_config5", "world": world, "runs": runs,
        "per_rank": per_rank, "first_step": {
            n: apart(f) for n, f in firsts.items()},
        "control": apart(control), "plain_loss": plain["loss"],
        "plain_first_step_peak_gib": plain_peak}), flush=True)


WORKERS.update(tpsp_steps=worker_tpsp_steps,
               tpsp_config5=worker_tpsp_config5)


def tpsp_jobs() -> list:
    """Phase 22's worlds: 22a's two and four ranks, 22b's two."""
    me = os.path.abspath(__file__)
    return [(2, [me, "--worker", "tpsp_steps", "gloo"]),
            (4, [me, "--worker", "tpsp_steps", "gloo"]),
            (2, [me, "--worker", "tpsp_config5", "gloo"])]


def tpsp_phase(card: str, phase7: dict, outs) -> dict:
    """Phase 22: the model and seq mesh axes (tensor and sequence
    parallelism) on ranks of ``cuda:0`` over gloo (check-only worlds:
    NCCL refuses two ranks on one card).  ``outs``: the standard outputs
    of ``tpsp_jobs``' worlds.  22a: each sharded step against the
    one-process step within ``DP_TOL``; 22b: config 5 through
    ``train_mlm``, flash launches per rank, peak GiB per rank beside
    phase 7's, the whole leaves identical over the ranks, the dropout-0
    first step against the one-process one."""
    two, four, c5 = map(dp_result, outs)
    bad = {}
    for res, cases in ((two, TPSP_TWO), (four, TPSP_FOUR)):
        for name, shape, family, sp_impl, attention in cases:
            diff = res["vs_plain"][name]
            # the ring runs no hand kernel; without a seq axis the model
            # axis takes them ("auto" at S = flash_min_seq)
            flash = attention == "flash" or "seq" not in shape
            want = {k: 2 * DP_STEPS if flash else 0 for k in FLASH}
            if not dp_bert_within(diff) or res["launches"][name] != want:
                bad[name] = {"diff": diff, "launches": res["launches"][name],
                             "want": want}
            log(f"[tp/sp] {family} on {shape} ({sp_impl}, attention "
                f"{attention}), {len(res['losses'][name])} steps on "
                f"cuda:0 over gloo, float32, 2 layers at full width, "
                f"S={DP_SEQ}, global batch {TPSP_B}: against the "
                f"one-process step {json.dumps(diff)} (tolerance "
                f"{DP_TOL}); flash launches per rank {res['launches'][name]}"
                f"; losses {res['losses'][name]}")
        log(f"[tp/sp] the {res['world']}-rank world took "
            f"{res['seconds']:.1f} s (ranks share the card; host-staged "
            f"transfers)")
    for name, shape, sp_impl in TPSP5:
        run = c5["runs"][name]
        flash = sp_impl == "ulysses" or "model" in shape
        want = {"flash_fwd": 12 * (TPSP5_STEPS + TPSP5_EVALS),
                "flash_dq": 12 * TPSP5_STEPS,
                "flash_dkdv": 12 * TPSP5_STEPS} if flash \
            else {k: 0 for k in FLASH}
        ranks = [{"peak_gib": p[0], "launches": dict(zip(FLASH, map(
            int, p[1:4])))} for p in (
            row[TPSP5.index((name, shape, sp_impl))]
            for row in c5["per_rank"])]
        first = c5["first_step"][name]
        problems = []
        if any(r["launches"] != want for r in ranks):
            problems.append(f"launches {ranks} != {want}")
        if not np.isfinite(run["final_loss"]) or run["steps"] != TPSP5_STEPS \
                or run["evals"] != TPSP5_EVALS:
            problems.append(f"run {run}")
        if not run["whole_leaves_identical"]:
            problems.append("whole leaves differ over the ranks")
        if not all(first[k] <= TPSP5_TOL[k] for k in TPSP5_TOL):
            problems.append(f"first step {first}")
        if problems:
            bad[f"22b {name}"] = problems
        log(f"[tp/sp] config 5 (BERT_BASE bf16, S={TRAIN_SEQ}, batch "
            f"{TRAIN_BATCH}, dropout 0.1) on {shape} ({sp_impl}) through "
            f"train_mlm, 2 ranks on cuda:0 over gloo: {run['steps']} steps "
            f"+ {run['evals']} eval, final loss {run['final_loss']:.4f}; "
            f"per rank peak GiB "
            f"{[round(r['peak_gib'], 3) for r in ranks]} (phase 7, one "
            f"process: {phase7['peak_memory_gib']:.3f}), flash launches "
            f"{[r['launches'] for r in ranks]} (want {want}); "
            f"{run['whole_leaves']} leaves whole on every rank, identical "
            f"over the ranks: {run['whole_leaves_identical']}; steps "
            f"{[round(t, 1) for t in run['step_ms']]} ms on rank 0 "
            f"(host-staged gloo transfers, not a link), {run['seconds']:.1f}"
            f" s in all; dropout-0 first step against "
            f"one process: {json.dumps(first)} (bound {TPSP5_TOL}); {card}")
    control = c5["control"]
    log(f"[tp/sp] control: the one-process first step on the next batch "
        f"{json.dumps(control)} (must miss both bounds {TPSP5_TOL}); "
        f"one-process loss {c5['plain_loss']:.5f}, its first step's peak "
        f"{c5['plain_first_step_peak_gib']:.3f} GiB")
    if any(control[k] <= TPSP5_TOL[k] for k in TPSP5_TOL):
        bad["22b control"] = control
    if bad:
        raise AssertionError(f"phase 22: {bad}")
    return {"two": two, "four": four, "config5": c5}


# --------------------------------------------------------------- phase 13

# the ResNets' data directory holds neither CIFAR-10's binary files nor
# ImageNet shards, so the loaders take their synthetic sets (nothing is
# written there)
RESNET_DATA_DIR = "build/resnet_data"
# 13a: ResNet-20 at batch 128 for 5 steps and ResNet-50 at batch 4 for 2
# (224x224), float32, TF32 off, cuDNN's deterministic algorithms; each
# step on the card from the CPU's state before it: the loss (the largest
# difference), the gradient (the whole update the step leaves in the
# velocity: its relative difference, the median over the steps; the
# worst parameter's is printed) and the new BatchNorm state (the worst
# leaf's relative difference, the median over the steps).  BatchNorm's
# backward subtracts means from the upstream gradient and the weight
# gradients sum over N x H x W, so float32 alone leaves the gradient far
# from float64: on the CPU (scripts/torch_resnet_conditioning.py, 8
# threads) ResNet-20's lies 6.09e-4 from it (the worst parameter 5.0e-3,
# the state 2.6e-6), ResNet-50's at batch 4 2.60e-2 (state 7.2e-6), and
# the card's float32 is no nearer, so each bound allows a few times the
# CPU's own distance; TF32 (emulated there) moves them 2.0e-2 / 8.8e-4
# and 0.64 / 6.5e-3.  The control, the card with TF32 on, must miss the
# gradient's and the state's bounds (the loss sits at ~ln(classes) + the
# L2 term whatever the logits' last bits, so its bound cannot tell the
# two apart).
RESNET_TOL = {"resnet20": {"loss": 1e-5, "grad": 5e-3, "state": 3e-5},
              "resnet50": {"loss": 1e-4, "grad": 0.1, "state": 1e-4}}
RESNET_STEP_CASES = (("resnet20", 10, 128, 32, 5), ("resnet50", 1000, 4, 224, 2))
# 13b: the runs through cli.main.  ResNet-20's synthetic CIFAR-10 is
# learnt within its epoch (test error 80 % at step 50, 0 % by 350), so
# its final error is held to the first trace point's; ResNet-50's 1000
# synthetic classes, ~2 train images each, leave its test error at
# chance (99.6-100.0 % at steps 10, 20 and 28, up or down by a row of
# the 512), so its errors are printed, not held: 13a (in float32 and in
# bf16, its step descending on a fixed batch) and the CPU parity tests
# hold its arithmetic
RESNET20_ARGS = ["--model", "resnet20", "--dataset", "cifar10",
                 "--data-dir", RESNET_DATA_DIR, "--epochs", "1",
                 "--batch-size", "128"]
RESNET50_ARGS = ["--model", "resnet50", "--dataset", "imagenet_synthetic",
                 "--num-classes", "1000", "--data-dir", RESNET_DATA_DIR,
                 "--epochs", "1", "--batch-size", "64", "--log-every", "10"]
# 13d: two gloo ranks, 3 psum steps of ResNet-20 at 64 rows a rank
# against the in-process two-shard step, chained from the seed-0 state;
# float32 sums in another order (the shards' gradients summed by the
# all-reduce, not in one backward)
RESNET_DP_ROWS, RESNET_DP_STEPS = 64, 3
RESNET_DP_TOL = {"loss": 1e-5, "param": 1e-5, "state": 1e-5}
# the avg50 run: the first 13 000 rows of the synthetic CIFAR-10 (11 917
# train rows after the validation split: 46 steps of 128 a rank), a
# trace every 10 steps (4 averages), 2000 test rows
RESNET_AVG50_ARGS = ["--model", "resnet20", "--dataset", "cifar10",
                     "--data-dir", RESNET_DATA_DIR, "--epochs", "1",
                     "--batch-size", "128", "--log-every", "10"]
RESNET_AVG50_ROWS = (13000, 2000)
# 13a in bf16.  A training step cannot be held to the CPU's in bf16: a
# channel whose spread lies below the bf16 resolution of its mean is
# renormalised by BatchNorm's batch statistics, so one conv output
# rounded the other way moves the step a long way.  On the CPU
# (scripts/torch_resnet_conditioning.py, 8 threads against 1: one
# oneDNN against itself) ResNet-50's training-mode logits at batch 4
# part by 6.6 % of max|logit| and its gradient by 113 %, nearly as far
# as bf16 lies from float32 (9.9 %, 132 %); ResNet-20's by 0.87 % and
# 5.4 % (against 0.98 %, 6.6 %).  Nor does the card's bf16 round as the
# CPU's: ResNet-20's evaluation-mode logits lie 4.95e-3 of max|logit|
# from the CPU's bf16 ones, half as far as the card's float32 (1.08e-2;
# this phase's output).  So in bf16 the script holds (1) the forward in
# evaluation (the running statistics: 8 threads and 1 agree to the bit
# there) to the card's float32 forward of the same weights and
# statistics, within RESNET_BF16_EVAL_TOL x max|logit| (on the CPU bf16
# lies 5.1e-3 / 6.6e-3 from float32, ResNet-20 / ResNet-50), from the
# CPU's state after the float32 steps above; the control, the bf16
# forward in training mode (batch statistics in place of the running
# ones), must miss; the distances to the CPU's bf16 logits are printed,
# not held; and (2) that ResNet-50's bf16 step descends:
# RESNET50_FIT_STEPS steps on one fixed batch A of RESNET50_FIT_BATCH
# rows from the seed-0 weights must bring A's cross-entropy (a
# training-mode forward, the L2 term left out) to at most
# RESNET50_FIT_RATIO of its start; the control, the same steps on
# another batch B, must leave it above (on the card: 6.96 -> 2.05
# trained on A, -> 30.9 trained on B)
RESNET_BF16_EVAL_TOL = 2 ** -5
RESNET50_FIT_BATCH, RESNET50_FIT_STEPS, RESNET50_FIT_RATIO = 8, 8, 0.5


def rel_diff(got, want) -> float:
    """The largest over matching tensors of |got - want| / |want| (norms)."""
    return max(float((a - w).norm() / w.norm().clamp_min(1e-30))
               for a, w in zip(got, want))


def whole_rel_diff(got, want) -> float:
    """|got - want| / |want| over all the tensors at once."""
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    return rel_diff([flat(got)], [flat(want)])


def resnet_model_step(name, classes, before, batch, dev, tf32=False):
    """One float32 psum step of ``name`` on ``dev`` from ``before`` =
    (parameters, velocity, counter, model state) (CPU tensors), TF32 as
    asked: ``(loss, parameters, velocity, model state)`` after it, on
    the CPU."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import resnet
    from mpi_tensorflow_torch.train import optimizer, step
    from mpi_tensorflow_torch.utils import tree as tree_lib

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    try:
        params, velocity, count, model_state = before
        model = resnet.ResNet(resnet.geometry(name, classes), params).to(dev)
        state = step.init_state(model)
        state.opt = optimizer.MomentumState(
            [v.to(dev, copy=True) for v in velocity], count)
        state.model_state = tree_lib.map_leaves(
            lambda _, t: t.to(dev, copy=True), model_state)
        train_step = step.make_train_step(model, Config(batch_size=batch[1]
                                                        .shape[0]), 1,
                                          decay_steps=50000)
        x, y = batch
        state, m = train_step(state, torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev))
        cpu = lambda tree: tree_lib.map_leaves(
            lambda _, t: t.detach().cpu(), tree)
        return (float(m["loss"]), cpu(model.param_tree()),
                [v.cpu() for v in state.opt.velocity],
                cpu(state.model_state))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def resnet_bf16_forward(dev, name, classes, params, model_state, x) -> dict:
    """13a in bf16: the forward of ``params`` / ``model_state`` (CPU
    tensors) on ``x``, relative to its max|logit|: the card's bf16
    logits in evaluation against the card's float32 ones (``held``), the
    bf16 logits in training mode against the same (``control``), and
    the card's bf16 and float32 logits in evaluation against the CPU's
    bf16 (``cpu_bf16``, ``cpu_bf16_vs_fp32``)."""
    from mpi_tensorflow_torch.models import base, resnet
    from mpi_tensorflow_torch.utils import tree as tree_lib

    geo = resnet.geometry(name, classes)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def logits(dev_, dtype, train=False):
            model = resnet.ResNet(geo, params, compute_dtype=dtype).to(dev_)
            state = tree_lib.map_leaves(lambda _, t: t.to(dev_), model_state)
            with torch.no_grad():
                out, _ = base.run_model(model, state, torch.from_numpy(x)
                                        .to(dev_), train=train)
            return out.double().cpu()

        want = logits(dev, torch.float32)
        bf16 = logits(dev, torch.bfloat16)
        cpu = logits(torch.device("cpu"), torch.bfloat16)
        apart = lambda a, b: float((a - b).abs().max() / b.abs().max())
        return {"held": apart(bf16, want),
                "control": apart(logits(dev, torch.bfloat16, True), want),
                "cpu_bf16": apart(bf16, cpu),
                "cpu_bf16_vs_fp32": apart(want, cpu)}
    finally:
        torch.backends.cudnn.deterministic = saved


def resnet50_bf16_fit(dev) -> dict:
    """13a in bf16: ResNet-50's bf16 step on the card descends on its
    batch (``RESNET50_FIT_*``), and steps on another batch do not."""
    import torch.nn.functional as F

    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import base, resnet
    from mpi_tensorflow_torch.train import step

    b = RESNET50_FIT_BATCH
    data = synthetic.image_classification(3 * b, 1, size=224, channels=3,
                                          num_classes=1000, seed=7)
    batch = lambda i: (torch.from_numpy(data.train_data[i * b:(i + 1) * b])
                       .to(dev), torch.from_numpy(
                           data.train_labels[i * b:(i + 1) * b]).to(dev))
    a = batch(0)

    def ce_of_a(model, state):
        with torch.no_grad():
            out, _ = base.run_model(model, state.model_state, a[0],
                                    train=True)
            return float(F.cross_entropy(out, a[1].long()))

    out = {}
    for name, fed in (("fit", a), ("control", batch(1))):
        model = resnet.build("resnet50", 1000,
                             compute_dtype=torch.bfloat16).to(dev)
        state = step.init_state(model)
        train = step.make_train_step(model, Config(batch_size=b), 1,
                                     decay_steps=50000)
        curve = [ce_of_a(model, state)]
        for _ in range(RESNET50_FIT_STEPS):
            state, _ = train(state, *fed)
            curve.append(ce_of_a(model, state))
        out[name] = curve
    return out


def resnet_cross_check(dev) -> dict:
    """13a: each ``RESNET_STEP_CASES`` model from its seed-0 weights,
    float32, on synthetic batches: every step on the card from the CPU's
    state before it, within its ``RESNET_TOL`` of the CPU's step, and
    the TF32 control outside the gradient's and the state's bounds."""
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import resnet
    from mpi_tensorflow_torch.utils import tree as tree_lib

    out = {}
    for name, classes, b, side, steps in RESNET_STEP_CASES:
        data = synthetic.image_classification(
            b * steps * 12 // 11 + 12, 1, size=side, channels=3,
            num_classes=classes, seed=7)
        batches = [(data.train_data[i * b:(i + 1) * b],
                    data.train_labels[i * b:(i + 1) * b])
                   for i in range(steps)]
        model = resnet.build(name, classes)
        p, ms = model.param_tree(), model.init_state()
        # the velocity in the parameters' own order (the optimizer's)
        v = [torch.zeros_like(t) for t in tree_lib.leaves(p)]
        cpu, t0 = [], time.perf_counter()
        for t, batch in enumerate(batches):
            before = (p, v, np.float32(t), ms)
            after = resnet_model_step(name, classes, before, batch,
                                      torch.device("cpu"))
            cpu.append((before, after))
            _, p, v, ms = after
        cpu_s = time.perf_counter() - t0

        def apart(tf32):
            loss, grad, worst, state = 0.0, [], [], []
            for (before, (c_loss, _, c_v, c_ms)), batch in zip(cpu, batches):
                g_loss, _, g_v, g_ms = resnet_model_step(
                    name, classes, before, batch, dev, tf32)
                loss = max(loss, abs(g_loss - c_loss))
                grad.append(whole_rel_diff(g_v, c_v))
                worst.append(rel_diff(g_v, c_v))
                state.append(rel_diff(tree_lib.leaves(g_ms),
                                      tree_lib.leaves(c_ms)))
            return {"loss": loss, "grad": float(np.median(grad)),
                    "grad_max": max(grad),
                    "worst_param": float(np.median(worst)),
                    "state": float(np.median(state)),
                    "state_max": max(state)}

        got, ctl = apart(False), apart(True)
        tol = RESNET_TOL[name]
        losses = [after[0] for _, after in cpu]
        log(f"[resnet cross-check] {name}, {steps} steps of batch {b} at "
            f"{side}x{side}, float32, each from the CPU's state (CPU "
            f"{cpu_s:.1f} s): CPU losses {losses[0]:.6f} -> "
            f"{losses[-1]:.6f}; card vs CPU: loss {got['loss']:.3e}, "
            f"gradient rel. median {got['grad']:.3e} (max "
            f"{got['grad_max']:.3e}; the worst parameter's median "
            f"{got['worst_param']:.3e}), BatchNorm state rel. median "
            f"{got['state']:.3e} (max {got['state_max']:.3e}) (tolerance "
            f"{tol}); control, TF32 on: loss {ctl['loss']:.3e}, gradient "
            f"{ctl['grad']:.3e} (max {ctl['grad_max']:.3e}; worst "
            f"parameter {ctl['worst_param']:.3e}), state "
            f"{ctl['state']:.3e} (max {ctl['state_max']:.3e})")
        if not np.isfinite(losses).all() \
                or any(got[k] > tol[k] for k in tol):
            raise AssertionError(f"{name} card vs CPU: {got} (tolerance "
                                 f"{tol})")
        if any(ctl[k] <= tol[k] for k in ("grad", "state")):
            raise AssertionError(
                f"{name}: the TF32 control reads {ctl}, inside the "
                f"tolerance {tol}: the bound does not tell the precisions "
                f"apart")
        # bf16: the forward from the CPU's state after the steps
        _, p_end, _, ms_end = cpu[-1][1]
        bf16 = resnet_bf16_forward(dev, name, classes, p_end, ms_end,
                                   batches[0][0])
        log(f"[resnet cross-check] {name} bf16 forward on the card, batch "
            f"{b}, from the CPU's state after the steps, |bf16 - float32| / "
            f"max|logit| in evaluation: {bf16['held']:.3e} (tolerance "
            f"{RESNET_BF16_EVAL_TOL:.3e}); control, bf16 in training mode: "
            f"{bf16['control']:.3e}; against the CPU's bf16 logits, not "
            f"held: the card's bf16 {bf16['cpu_bf16']:.3e}, its float32 "
            f"{bf16['cpu_bf16_vs_fp32']:.3e}")
        if not bf16["held"] <= RESNET_BF16_EVAL_TOL:
            raise AssertionError(f"{name} bf16 forward: {bf16}")
        if not bf16["control"] > RESNET_BF16_EVAL_TOL:
            raise AssertionError(
                f"{name}: the training-mode control reads {bf16}, inside "
                f"the tolerance {RESNET_BF16_EVAL_TOL}")
        out[name] = {"card_vs_cpu": got, "control_tf32": ctl, "tol": tol,
                     "cpu_losses": losses, "bf16_forward": bf16}
    fit = resnet50_bf16_fit(dev)
    bound = RESNET50_FIT_RATIO * fit["fit"][0]
    log(f"[resnet cross-check] resnet50 bf16 on the card, "
        f"{RESNET50_FIT_STEPS} steps of batch {RESNET50_FIT_BATCH} from the "
        f"seed-0 weights: batch A's cross-entropy trained on A "
        f"{[round(c, 4) for c in fit['fit']]}, bound {bound:.4f}; control, "
        f"trained on batch B {[round(c, 4) for c in fit['control']]}")
    if not (np.isfinite(fit["fit"]).all() and fit["fit"][-1] <= bound):
        raise AssertionError(f"resnet50 bf16 step does not descend: {fit}")
    if not fit["control"][-1] > bound:
        raise AssertionError(f"resnet50 bf16: the control reads {fit}, "
                             f"inside the bound {bound}")
    out["resnet50_bf16_fit"] = fit
    return out


def resnet_cli(dev, card: str, argv, want_steps: int, want_trace: list,
               gate_error: bool, label: str = "resnet") -> dict:
    """13b (and 20b, the ViT): ``cli.main(argv)`` as ``python -m
    mpi_tensorflow_torch`` runs it, on the card: the steps, the trace
    lines in the reference's format, the ``[timing]`` line, a finite
    loss and the card named in the result; with ``gate_error``, a final
    test error no higher than the first trace point's.  Images/s, step
    ms, MFU and peak GiB are printed beside the card's name and power
    limit."""
    from mpi_tensorflow_torch import cli
    from mpi_tensorflow_torch.train import loop
    from mpi_tensorflow_torch.utils import flops

    results = []
    real_train = loop.train

    def recorded_train(*a, **kw):
        results.append(real_train(*a, **kw))
        return results[-1]

    out = _Tee(sys.stdout)
    loop.train = recorded_train
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        loop.train = real_train
    wall = time.perf_counter() - t0
    (res,) = results
    lines = out.getvalue().splitlines()
    trace = [TRACE_LINE.fullmatch(ln) for ln in lines]
    trace = [(int(m[1]), float(m[2])) for m in trace if m]
    errs = [e for _, e in res.history]
    problems = []
    if rc != 0 or res.device != torch.cuda.get_device_name(dev):
        problems.append(f"rc {rc}, device {res.device!r}")
    if res.num_steps != want_steps or [t for t, _ in trace] != want_trace \
            or [t for t, _ in res.history] != want_trace:
        problems.append(f"{res.num_steps} steps, trace steps "
                        f"{[t for t, _ in trace]}")
    if not any(ln.startswith("[timing]") for ln in lines):
        problems.append("no [timing] line")
    if not np.isfinite(res.final_loss) \
            or (gate_error and res.final_test_error > errs[0]):
        problems.append(f"loss {res.final_loss}, errors {errs}")
    if problems:
        raise AssertionError(f"{label} run {argv}: {problems}")
    config = cli.config_from_args(cli.build_parser().parse_args(argv))
    step_flops = flops.image_train_flops(
        config.model, config.batch_size,
        getattr(res.state.model, "cfg", None))
    summary = {
        "argv": argv, "card": card, "device": res.device,
        "model": config.model, "precision": config.precision,
        "steps": res.num_steps, "trace_lines": len(trace),
        "images_per_sec": res.images_per_sec,
        "step_ms": res.step_time_seconds * 1e3,
        "mfu_pct": 100.0 * flops.mfu(step_flops, res.step_time_seconds,
                                     config.precision),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "final_loss": res.final_loss, "history": res.history,
        "wall_s": wall}
    log(f"[{label}] " + json.dumps(summary))
    return summary


def worker_resnet_psum_steps(backend: str) -> None:
    """13d: ``RESNET_DP_STEPS`` psum steps of ResNet-20 (float32, cuDNN's
    deterministic algorithms) from its seed-0 state, each rank feeding
    its ``RESNET_DP_ROWS`` rows, against the in-process step over the
    world's shards concatenated (each shard normalised on its own)."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import resnet
    from mpi_tensorflow_torch.parallel import mesh
    from mpi_tensorflow_torch.train import step
    from mpi_tensorflow_torch.utils import tree as tree_lib

    dev, rank, world = join_world(backend)
    torch.backends.cudnn.deterministic = True
    b = RESNET_DP_ROWS
    data = synthetic.image_classification(
        RESNET_DP_STEPS * world * b * 12 // 11 + 12, 1, size=32, channels=3,
        num_classes=10, seed=8)
    cfg = Config(batch_size=b)

    def run(shards, across, rows):
        model = resnet.build("resnet20", seed=0).to(dev)
        state = step.init_state(model)
        train = step.make_train_step(model, cfg, shards, 50000,
                                     across_ranks=across)
        losses = []
        for t in range(RESNET_DP_STEPS):
            x = data.train_data[t * world * b:(t + 1) * world * b][rows]
            y = data.train_labels[t * world * b:(t + 1) * world * b][rows]
            state, m = train(state, torch.from_numpy(x).to(dev),
                             torch.from_numpy(y).to(dev))
            losses.append(float(m["loss"]))
        return (np.array(losses),
                [t.detach() for t in tree_lib.leaves(model.param_tree())],
                tree_lib.leaves(state.model_state))

    across = run(1, True, slice(rank * b, (rank + 1) * b))
    plain = run(world, False, slice(None))
    diff = {"loss": float(np.abs(across[0] - plain[0]).max()),
            "param": max(float((a - w).abs().max())
                         for a, w in zip(across[1], plain[1])),
            "state": max(float((a - w).abs().max())
                         for a, w in zip(across[2], plain[2]))}
    if rank == 0:
        print(DP_RESULT + json.dumps({
            "case": "resnet_psum_steps", "backend": backend, "world": world,
            "device": str(dev), "diff": diff,
            "losses": plain[0].tolist()}), flush=True)
    mesh.shutdown()


def resnet_avg50_splits(config, num_shards, verbose=True):
    """13d's avg50 run: the first ``RESNET_AVG50_ROWS`` rows of the
    synthetic CIFAR-10 in ``config.data_dir``."""
    from mpi_tensorflow_torch.data import cifar

    return cifar.load_splits(config.data_dir, *RESNET_AVG50_ROWS)


def worker_resnet_nccl(_backend: str) -> None:
    """13d: ``torchrun --nproc_per_node 1 -m mpi_tensorflow_torch`` with
    14b's ResNet-20 fp32 psum arguments: ``cli.main`` in this rank, which
    joins the launcher's world over NCCL (recorded), on 14b's
    ``RESNET_AVG50_ROWS`` rows with cuDNN's deterministic algorithms, as
    14b runs it without a world: its printed lines."""
    from mpi_tensorflow_torch import cli
    from mpi_tensorflow_torch.train import loop

    torch.backends.cudnn.deterministic = True
    loop.load_dataset = resnet_avg50_splits
    out = io.StringIO()
    with recorded_joins() as worlds, contextlib.redirect_stdout(out):
        rc = cli.main(CKPT_IMAGE_ARGS)
    print(out.getvalue(), end="")
    print(DP_RESULT + json.dumps({
        "case": "resnet_nccl", "rc": rc, "worlds": worlds,
        "lines": out.getvalue().splitlines()}), flush=True)


WORKERS.update(resnet_psum_steps=worker_resnet_psum_steps,
               resnet_avg50=lambda backend: worker_avg50_epoch(
                   backend, RESNET_AVG50_ARGS, load=resnet_avg50_splits),
               resnet_nccl=worker_resnet_nccl)


def resnet_phase(dev, card: str, resnet_worlds) -> dict:
    """Phase 13: ResNet-20 and ResNet-50 training.  13a: single steps on
    the card against the CPU's; 13b: one epoch of each through
    ``cli.main`` (ResNet-50 in bf16 only); 13c: no hand kernel launched
    on 13b's runs; 13d: two gloo ranks on ``cuda:0``: psum steps against
    the in-process two-shard step, and an avg50 run with every average
    watched (``resnet_worlds``,
    their results: the worlds ran beside 11b's); 13e: the bench's lines
    and 11c's allreduce line."""
    from mpi_tensorflow_torch.train import loop

    phase("13a")
    cross = resnet_cross_check(dev)
    # 13b, 13c: each synthetic set made once for both precisions
    phase("13b")
    cache, real_load = {}, loop.load_dataset

    def cached_load(config, num_shards, *a, **kw):
        key = (config.dataset, num_shards, repr(a), repr(sorted(kw.items())))
        if key not in cache:
            cache[key] = real_load(config, num_shards, *a, **kw)
        return cache[key]

    every = lambda n, k: [t for t in range(1, n) if t % k == 0] + [n - 1]
    saved = hand_kernel_counts()
    set_hand_kernel_counts({k: 0 for k in saved})
    loop.load_dataset = cached_load
    try:
        runs = {}
        # ResNet-50 in bf16 only: its fp32 epoch is cut for the script's
        # time (13e times its fp32 step; this run's checks are the bf16
        # run's)
        for name, argv, steps, k in (("resnet20", RESNET20_ARGS, 358, 50),
                                     ("resnet50", RESNET50_ARGS, 29, 10)):
            for prec in (("fp32", "bf16") if name == "resnet20"
                         else ("bf16",)):
                runs[name, prec] = resnet_cli(
                    dev, card, argv + ["--precision", prec], steps,
                    every(steps, k), gate_error=name == "resnet20")
    finally:
        loop.load_dataset = real_load
        cache.clear()
    torch.cuda.synchronize(dev)
    launched = hand_kernel_counts()
    set_hand_kernel_counts(saved)
    if any(launched.values()):
        raise AssertionError(f"the ResNet path launched hand kernels: "
                             f"{launched}")
    log("[resnet] no hand kernel launched on the ResNet runs (paged, flash "
        "and fused counts all 0)")
    phase("13d")
    # the three worlds ran beside 11b's.  ResNet-20 through torchrun at
    # world 1 over NCCL runs 14b's 93 steps on 13 000 rows (its full
    # epoch is cut for the script's time: 13b runs it without a process
    # group); 14b holds its trace to its own run's without a world
    psum, avg, nccl = resnet_worlds
    want_nccl = every(93, 10)
    nccl_trace = check_trace(nccl["lines"], 1, want_nccl,
                             "torchrun ResNet-20 (NCCL)")
    joined = nccl["worlds"]
    if nccl["rc"] != 0 or nccl_trace[-1][1] > nccl_trace[0][1] \
            or not joined_launch(joined):
        raise AssertionError(f"torchrun ResNet-20 (NCCL): {nccl_trace}, "
                             f"worlds {joined}, rc {nccl['rc']}")
    log(f"[resnet dp] torchrun --nproc_per_node 1 -m mpi_tensorflow_torch "
        f"{' '.join(CKPT_IMAGE_ARGS)} on the first {RESNET_AVG50_ROWS[0]} "
        f"rows (psum; the launcher's world over {joined[0]['backend']}, "
        f"world 1; cuDNN deterministic): {len(nccl_trace)} trace points, "
        f"errors {nccl_trace[0][1]} -> {nccl_trace[-1][1]} %; "
        f"{json.dumps(trainer_timing(nccl['lines']))} (beside 11b's "
        f"worlds); {card}")
    log(f"[resnet dp] psum, 2 ranks on cuda:0 over gloo, ResNet-20 float32, "
        f"{RESNET_DP_STEPS} steps of {RESNET_DP_ROWS} rows a rank from the "
        f"seed-0 state against the in-process two-shard step: "
        f"{json.dumps(psum['diff'])} (tolerance {RESNET_DP_TOL}); losses "
        f"{psum['losses']}")
    if any(psum["diff"][k] > RESNET_DP_TOL[k] for k in RESNET_DP_TOL):
        raise AssertionError(f"ResNet psum across ranks: {psum}")
    want_trace = every(avg["steps"], 10)
    trace = check_trace(avg["lines"], 2, want_trace, "ResNet avg50, 2 ranks")
    checks = avg["averages"]
    if len(checks) != len(want_trace) - 1 or not all(
            c["differ_before"] and c["identical_after"]
            and c["state_differ_before"] and c["max_ulp"] <= 1.0
            and c["state_max_ulp"] <= 1.0 for c in checks) \
            or not np.isfinite(avg["final_loss"]):
        raise AssertionError(f"ResNet avg50, 2 ranks over gloo: {checks}, "
                             f"loss {avg['final_loss']}")
    log(f"[resnet dp] avg50, 2 ranks on cuda:0 over gloo, ResNet-20: "
        f"{avg['steps']} steps, {len(trace)} trace points x 2 lines, "
        f"{len(checks)} averages of {checks[0]['state_values']} BatchNorm "
        f"values with the parameters and velocity: replicas apart before "
        f"each (their statistics too) and bit-identical after each, within "
        f"{max(c['max_ulp'] for c in checks)} ulp of the gathered mean "
        f"(the statistics {max(c['state_max_ulp'] for c in checks)} ulp); "
        f"test error {trace[0][1]} -> {trace[-1][1]} %; {card}")
    phase("13e")
    me = os.path.abspath(__file__)
    # the bench's lines under torchrun --nproc_per_node 1 (the bench's
    # multi-card entry): each transformer line joins the launcher's
    # world over NCCL (12c), the image lines join none
    benches = dp_result(torchrun(1, [me, "--worker", "bench_lines",
                                     "none"], 600))["lines"]
    allreduce = benches.pop("allreduce")
    if not (allreduce["num_devices"] == 1 and allreduce["allreduce_ms"] > 0
            and "nccl" in allreduce["backend"]
            and joined_launch(allreduce["worlds"])):
        raise AssertionError(f"allreduce bench: {allreduce}")
    log(f"[dp bench] 11c: {json.dumps(allreduce)}")
    for label, line in benches.items():
        rate = line.get("images_per_sec", line.get("tokens_per_sec"))
        world = (joined_launch(line["worlds"]) if "tokens_per_sec" in line
                 else line["worlds"] == [])
        if not (rate and rate > 0 and np.isfinite(line["final_loss"])
                and line["num_devices"] == 1 and world):
            raise AssertionError(f"bench {label}: {line}")
        log(f"[bench] {label}: {json.dumps(line)}")
    return {"cross_check": cross, "runs": runs, "launches": launched,
            "psum": psum, "avg50": avg, "nccl_trace": nccl_trace,
            "bench": benches}


# --------------------------------------------------------------- phase 14

# 14a: each image trainer through cli.main, --prefetch off, then thread
# (the first run of a trainer pays its warm-up: cuDNN plans, the
# allocator's growth, so the pair leans toward thread); cuDNN's
# deterministic algorithms in every run (the trace lines are compared:
# the default algorithms move ResNet-50's test error by a row between
# runs), all in a process with no torch.profiler session: 13b's
# ResNet-50 bf16 epoch (29 steps), ResNet-20 fp32 on 13d's 13 000 rows
# (93 steps) and phase 10's CNN fp32 epoch (781 steps)
PREFETCH_ARGS = RESNET50_ARGS + ["--precision", "bf16"]
# one pair each (cut for the script's time)
PREFETCH_PAIRS = ("off", "thread")
PREFETCH_TRAINERS = (("resnet50_bf16", PREFETCH_ARGS, PREFETCH_PAIRS),
                     ("resnet20_fp32", RESNET20_ARGS + ["--precision",
                                                        "fp32"],
                      PREFETCH_PAIRS),
                     ("cnn_fp32", ["--data-dir", CNN_DATA_DIR, "--epochs",
                                   "1"], PREFETCH_PAIRS))
# then the host feed alone: 64 rows a step, windows of 11 (the trainer's)
HOSTIO_ARGS = ["--batch-size", "64", "--window-k", "11", "--windows", "6",
               "--hostio-dir", "build"]
# 14b (and 21c): ResNet-20 fp32 psum on the first 13 000 rows of the
# synthetic CIFAR-10 (93 steps of 128, a trace every 10: windows of 11
# steps, then 10), stopped by request_stop during the window of steps
# 21-30, which holds STOP_IMAGE: a replay runs its window to the end, so
# the loop checkpoints step 30 (STOP_IMAGE_END) and stops before that
# trace point's evaluation (the reference's scanned loop does the same);
# resumed;
# cuDNN's deterministic algorithms, so that two uninterrupted runs can be
# bit-equal
CKPT_DIR = "build/ckpt14"            # git-ignored; removed at the end
CKPT_IMAGE_ARGS = RESNET_AVG50_ARGS + ["--precision", "fp32"]
STOP_IMAGE, STOP_IMAGE_END = 25, 30
# 14c: phase 7's BERT_BASE bf16 S = 4096 batch 4 run (8 steps, trace
# points 4 and 7), stopped at the trace point 4 and resumed for 5-7
STOP_MLM = 4
# 14d: dp_bert_cfg's state after DP_STEPS - 1 steps on two gloo ranks,
# saved in each of these layouts, restored at world 1 for the last step
CKPT_DP_KINDS = ("zero1", "fsdp")


@contextlib.contextmanager
def stopping(step, at_trace: bool = False):
    """Runs in the block record their checkpoint hooks (the yielded
    list); with ``step``, each asks its guard to stop as the image
    loop's window holding train step ``step`` is launched (one graph
    replay on the card: the loop stops at the window's end, step
    ``window_end(step)``), a transformer run once its state has taken
    train step ``step``, or with
    ``at_trace`` once it has queued the checkpoint of trace point
    ``step`` (the loop stops there, the stop agreed).  Each hook's
    ``preempt_save`` is timed into its ``flush_s``."""
    from mpi_tensorflow_torch.train import ckpt_hooks, gspmd, loop
    from mpi_tensorflow_torch.train import mlm_loop, step as step_lib

    made = []

    class Hooks(ckpt_hooks.CheckpointHooks):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.flush_s = []
            made.append(self)

        def preempt_save(self, *a, **kw):
            t0 = time.perf_counter()
            super().preempt_save(*a, **kw)
            self.flush_s.append(time.perf_counter() - t0)

        def save_async(self, state, t):
            super().save_async(state, t)
            if at_trace and t == step:
                self.guard.request_stop()

    def wrap(make, count):
        def made_step(*a, **kw):
            fn = make(*a, **kw)

            def train_step(state, *rest):
                out = fn(state, *rest)
                if step is not None and not at_trace \
                        and count(state) == step + 1:
                    made[-1].guard.request_stop()
                return out
            return train_step
        return made_step

    def wrap_multi(make):
        # the image loop's windows: a replay cannot stop inside its
        # window, so the stop is asked for as the window holding step
        # ``step`` is launched, and lands at its end
        def made_multi(*a, **kw):
            fn = make(*a, **kw)

            def multi_step(state, batches, labels, n_valid=None, stop=None):
                t0 = int(state.opt.step)
                n = batches.shape[0] if n_valid is None else n_valid
                if step is not None and not at_trace \
                        and t0 <= step < t0 + n:
                    made[-1].guard.request_stop()
                return fn(state, batches, labels, n_valid, stop)
            multi_step.prepare = fn.prepare
            return multi_step
        return made_multi

    real = (loop.CheckpointHooks, mlm_loop.CheckpointHooks,
            step_lib.make_multi_train_step, gspmd.make_train_step)
    loop.CheckpointHooks = mlm_loop.CheckpointHooks = Hooks
    step_lib.make_multi_train_step = wrap_multi(real[2])
    gspmd.make_train_step = wrap(real[3], lambda s: int(s.step))
    try:
        yield made
    finally:
        (loop.CheckpointHooks, mlm_loop.CheckpointHooks,
         step_lib.make_multi_train_step, gspmd.make_train_step) = real


def cli_run(argv, train_fn="loop"):
    """``cli.main(argv)`` on the card: ``(the trainer's result, the
    printed lines but the [timing] line)``, the output passed on."""
    from mpi_tensorflow_torch import cli
    from mpi_tensorflow_torch.train import loop, mlm_loop

    mod = loop if train_fn == "loop" else mlm_loop
    name = "train" if train_fn == "loop" else "train_mlm"
    real, results = getattr(mod, name), []

    def recorded(*a, **kw):
        results.append(real(*a, **kw))
        return results[-1]

    out = _Tee(sys.stdout)
    setattr(mod, name, recorded)
    try:
        with contextlib.redirect_stdout(out):
            if cli.main(argv) != 0:
                raise AssertionError(f"cli.main({argv}) failed")
    finally:
        setattr(mod, name, real)
    (res,) = results
    return res, [ln for ln in out.getvalue().splitlines()
                 if not ln.startswith("[timing]")]


def _joined(*runs):
    """The lines of consecutive runs as one run prints them (the
    checkpoint notices and the repeated session header dropped)."""
    out = []
    for lines in runs:
        for ln in lines:
            if ln.startswith(("[checkpoint]", "[preemption]")) or (
                    out and ln.startswith("Process ID")):
                continue
            out.append(ln)
    return out


def _dir_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def _image_state(res) -> list:
    """An image run's parameters, velocity and BatchNorm state, on the
    card, in the checkpoint's leaf order."""
    from mpi_tensorflow_torch.train import state_io

    return [p.data for p in state_io.parts(res.state)
            if isinstance(p.data, torch.Tensor)]


def _apart(a: list, b: list) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def worker_prefetch_arms(_backend: str) -> None:
    """14a's runs in a process of their own (no torch.profiler session
    before them): each of ``PREFETCH_TRAINERS`` through cli.main in its
    ``--prefetch`` order, each synthetic set made once."""
    from mpi_tensorflow_torch.data import mnist
    from mpi_tensorflow_torch.train import loop
    from mpi_tensorflow_torch.utils.device import resolve_device

    resolve_device(torch.device("cuda", 0))
    # written before the first run, so that no run prints its notice
    mnist.ensure_data(CNN_DATA_DIR, verbose=False)
    cache, real_load = {}, loop.load_dataset

    def cached_load(config, num_shards, *a, **kw):
        if config.dataset not in cache:
            load = (resnet_avg50_splits if config.dataset == "cifar10"
                    else real_load)
            cache[config.dataset] = load(config, num_shards, *a, **kw)
        return cache[config.dataset]

    torch.backends.cudnn.deterministic = True
    loop.load_dataset = cached_load
    arms = {}
    for name, argv, order in PREFETCH_TRAINERS:
        arms[name] = []
        for mode in order:
            with contextlib.redirect_stdout(io.StringIO()):
                res, lines = cli_run(argv + ["--prefetch", mode])
            arms[name].append({
                "prefetch": mode, "images_per_sec": res.images_per_sec,
                "step_ms": res.step_time_seconds * 1e3,
                "steps": res.num_steps, "history": res.history,
                "final_loss": res.final_loss, "lines": lines})
    # the host feed alone (``bench --mode hostio`` run in this process),
    # with ResNet-50's thread rate as the card's demand
    thread = [r["images_per_sec"] for r in arms["resnet50_bf16"]
              if r["prefetch"] == "thread"]
    demand = sum(thread) / len(thread)
    hostio = bench_main_line(["--mode", "hostio", "--demand-images-per-sec",
                              repr(demand), *HOSTIO_ARGS])
    print(DP_RESULT + json.dumps({"case": "prefetch_arms", "arms": arms,
                                  "demand": demand, "hostio": hostio}),
          flush=True)


WORKERS.update(prefetch_arms=worker_prefetch_arms,
               bench_lines=worker_bench_lines)


def prefetch_phase(card: str) -> dict:
    """14a: each image trainer with --prefetch off and thread in a child
    process (the trace identical in every run; images/s and step ms of
    each run), then, in the same child, the hostio bench with this card's
    ResNet-50 thread rate as the demand."""
    me = os.path.abspath(__file__)
    res = dp_result(run_sub([sys.executable, me, "--worker",
                             "prefetch_arms", "none"], 600))
    arms, demand, hostio = res["arms"], res["demand"], res["hostio"]
    for name, runs in arms.items():
        if any(r["lines"] != runs[0]["lines"]
               or not np.isfinite(r["final_loss"]) for r in runs):
            raise AssertionError(f"14a {name}: the trace differs between "
                                 f"--prefetch runs: {runs}")
        pairs = [runs[i:i + 2] for i in range(0, len(runs), 2)]
        log(f"[prefetch] {name} through cli.main, {runs[0]['steps']} "
            f"steps a run (cuDNN deterministic, a process of their own), "
            f"{len(runs[0]['lines']) - 1} trace lines identical in all "
            f"{len(runs)} runs; " + "; ".join(
                "pair " + str(k + 1) + ": " + ", ".join(
                    f"{r['prefetch']} {r['step_ms']:.3f} ms a step "
                    f"({r['images_per_sec']:.1f} images/s)" for r in pair)
                for k, pair in enumerate(pairs)) + f"; {card}")
    if not (hostio["host_images_per_sec_inline"] > 0
            and hostio["host_images_per_sec_thread"] > 0
            and hostio["host_images_per_sec_native"] is None
            and hostio["device_demand_img_s"] == demand):
        raise AssertionError(f"14a hostio: {hostio}")
    log(f"[prefetch] bench --mode hostio: {json.dumps(hostio)}")
    return {"arms": {k: [{kk: v for kk, v in r.items() if kk != "lines"}
                         for r in runs] for k, runs in arms.items()},
            "hostio": hostio}


def ckpt_image_phase(dev, card: str, nccl_trace) -> dict:
    """14b: ResNet-20 fp32 psum through cli.main with --checkpoint-dir and
    --metrics-dir, stopped by request_stop during the graphed window
    holding STOP_IMAGE (checkpointed at its end, STOP_IMAGE_END: 21c)
    and resumed:
    the trace, parameters, velocity and BatchNorm state of the
    uninterrupted run (bit-equal if two uninterrupted runs are, else
    within twice their distance), and the metrics' tags; the
    uninterrupted run's trace is 13d's run's at world 1 over NCCL
    (``nccl_trace``: its all-reduces over one rank change no value)."""
    from mpi_tensorflow_torch.train import checkpoint, loop

    cache = {}

    def load(config, num_shards, verbose=True):
        if "c" not in cache:
            cache["c"] = resnet_avg50_splits(config, num_shards)
        return cache["c"]

    real_load = loop.load_dataset
    loop.load_dataset = load
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    d = os.path.join(CKPT_DIR, "image")
    shutil.rmtree(d, ignore_errors=True)
    try:
        full = [cli_run(CKPT_IMAGE_ARGS) for _ in range(2)]
        with stopping(STOP_IMAGE) as hooks:
            _, stop_lines = cli_run(CKPT_IMAGE_ARGS + [
                "--checkpoint-dir", d, "--metrics-dir", d])
        stop_hooks = hooks[0]
        ckpt_bytes = _dir_bytes(checkpoint.step_path(d, STOP_IMAGE_END)
                                + ".sharded")
        with stopping(None) as hooks:
            res, res_lines = cli_run(CKPT_IMAGE_ARGS + [
                "--checkpoint-dir", d, "--metrics-dir", d, "--resume"])
        res_hooks = hooks[0]
    finally:
        loop.load_dataset = real_load
        torch.backends.cudnn.deterministic = saved
        cache.clear()
    want = [full[0][1], full[1][1]]
    own = _apart(_image_state(full[0][0]), _image_state(full[1][0]))
    got = _apart(_image_state(res), _image_state(full[0][0]))
    tags = [json.loads(ln) for ln in open(os.path.join(d, "metrics.jsonl"))]
    evals = [(m["step"]) for m in tags if m["tag"] == "eval/test_error_pct"]
    want_steps = [t for t, _ in full[0][0].history]
    problems = []
    if want[0] != want[1]:
        problems.append(f"two uninterrupted runs trace differently: {want}")
    if check_trace(want[0], 1, want_steps, "14b") != nccl_trace:
        problems.append(f"13d's run at world 1 over NCCL traced "
                        f"{nccl_trace}, this run {want[0]}")
    # the stop lands on the trace step that ends its window: the loop
    # checkpoints that step and stops before its evaluation, as the
    # reference's scanned loop does, so that one trace line is missing
    at_stop = f"0  process at  {STOP_IMAGE_END} with test error:"
    want_joined = [ln for ln in want[0] if not ln.startswith(at_stop)]
    if _joined(stop_lines, res_lines) != want_joined \
            or len(want_joined) != len(want[0]) - 1:
        problems.append(f"stopped + resumed trace {stop_lines} + "
                        f"{res_lines} != {want_joined}")
    if checkpoint.latest_step(d) != res.num_steps - 1 or not any(
            f"checkpointed step {STOP_IMAGE_END}" in ln
            for ln in stop_lines):
        problems.append(f"checkpoints {sorted(os.listdir(d))}")
    if got > 2 * own or (own == 0.0 and got != 0.0):
        problems.append(f"resumed state {got} from the uninterrupted "
                        f"run's, which differ by {own} among themselves")
    if evals != [t for t in want_steps if t != STOP_IMAGE_END] \
            or tags[-1]["tag"] != "perf/images_per_sec":
        problems.append(f"metrics {tags}")
    if problems:
        raise AssertionError(f"14b: {problems}")
    out = {"card": card, "checkpoint_bytes": ckpt_bytes,
           "save_async_stall_ms": [1e3 * s for s in stop_hooks.stalls
                                   + res_hooks.stalls],
           "preempt_flush_ms": [1e3 * s for s in stop_hooks.flush_s],
           "restore_ms": 1e3 * res_hooks.restore_seconds,
           "bit_equal": own == 0.0, "resumed_vs_full": got,
           "full_vs_full": own, "trace_points": want_steps,
           "metrics_tags": sorted({m["tag"] for m in tags})}
    held = ("bit-equal (two uninterrupted runs are bit-equal)"
            if own == 0.0 else f"within {got:.3e}, the uninterrupted runs "
            f"{own:.3e} apart (bound: twice that)")
    log(f"[checkpoint] 14b (21c) ResNet-20 fp32 psum, stopped during the "
        f"graphed window holding step {STOP_IMAGE}, checkpointed at its end "
        f"(step {STOP_IMAGE_END}) and resumed: trace identical (and the "
        f"uninterrupted "
        f"run's identical to 13d's at world 1 over NCCL); state {held}; "
        f"{json.dumps(out)}")
    shutil.rmtree(d, ignore_errors=True)
    return out


def ckpt_mlm_phase(dev, card: str, phase7: dict) -> dict:
    """14c: phase 7's BERT_BASE bf16 S = 4096 run, uninterrupted, then
    stopped at its trace point STOP_MLM (checkpointed) and resumed in a
    fresh train_mlm: the resumed run's losses the uninterrupted run's,
    its parameters within phase 8's 1e-5, and its flash launches counted
    from 0."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import checkpoint, mlm_loop

    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                              max_positions=TRAIN_SEQ)
    d = os.path.join(CKPT_DIR, "mlm")
    shutil.rmtree(d, ignore_errors=True)

    def run(**kw):
        config = Config(model="bert_base", dataset="mlm_synthetic", epochs=1,
                        batch_size=TRAIN_BATCH, log_every=LOG_EVERY,
                        precision="bf16", **kw)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = mlm_loop.train_mlm(config, cfg, seq_len=TRAIN_SEQ,
                                     train_n=TRAIN_N, test_n=TEST_N,
                                     device=dev)
        torch.cuda.synchronize(dev)
        return res, [ln for ln in out.getvalue().splitlines()
                     if not ln.startswith("[timing]")]

    def loss_of(mdir, step):
        (v,) = [json.loads(ln)["value"] for ln in open(os.path.join(
            mdir, "metrics.jsonl")) if json.loads(ln)["tag"] == "train/loss"
            and json.loads(ln)["step"] == step]
        return v

    full, full_lines = run(metrics_dir=os.path.join(d, "full"))
    full_params = {n: p.detach().clone()
                   for n, p in full.state.model.named_parameters()}
    del full
    with stopping(STOP_MLM, at_trace=True) as hooks:
        _, stop_lines = run(checkpoint_dir=os.path.join(d, "ck"),
                            metrics_dir=os.path.join(d, "ck"))
    stop_hooks = hooks[0]
    ckpt_bytes = _dir_bytes(checkpoint.step_path(os.path.join(d, "ck"),
                                                 STOP_MLM) + ".sharded")
    saved = flash_counts()
    set_flash_counts({k: 0 for k in FLASH})
    with stopping(None) as hooks:
        res, res_lines = run(checkpoint_dir=os.path.join(d, "ck"),
                             metrics_dir=os.path.join(d, "ck"),
                             resume=True)
    launches = flash_counts()
    set_flash_counts(saved)
    res_hooks = hooks[0]
    steps = res.num_steps - STOP_MLM - 1
    evals = len(res.history) * -(-min(TEST_N, 4 * TRAIN_BATCH)
                                 // TRAIN_BATCH)
    want_launches = {"flash_fwd": cfg.layers * (steps + evals),
                     "flash_dq": cfg.layers * steps,
                     "flash_dkdv": cfg.layers * steps}
    losses = {t: (loss_of(os.path.join(d, "ck"), t),
                  loss_of(os.path.join(d, "full"), t))
              for t in (STOP_MLM, res.num_steps - 1)}
    param = 0.0
    for n, p in res.state.model.named_parameters():
        if not n.endswith(".bk"):
            param = max(param, float((p.detach() - full_params[n])
                                     .abs().max()))
    problems = []
    if _joined(stop_lines, res_lines) != full_lines:
        problems.append(f"trace {stop_lines} + {res_lines} != {full_lines}")
    if any(a != b for a, b in losses.values()):
        problems.append(f"losses (resumed, uninterrupted) {losses}")
    if param > 1e-5:
        problems.append(f"parameters {param:.3e} apart")
    if launches != want_launches:
        problems.append(f"flash launches {launches} != {want_launches}")
    if problems:
        raise AssertionError(f"14c: {problems}")
    out = {"card": card, "checkpoint_gib": ckpt_bytes / 2**30,
           "save_async_stall_ms": [1e3 * s for s in stop_hooks.stalls],
           "preempt_flush_ms": [1e3 * s for s in stop_hooks.flush_s],
           "restore_ms": 1e3 * res_hooks.restore_seconds,
           "resumed_save_ms": [1e3 * s for s in res_hooks.stalls],
           "losses": losses, "param_apart": param,
           "launches_resumed": launches, "phase7_step_ms": phase7["step_ms"]}
    log(f"[checkpoint] 14c BERT_BASE bf16 S={TRAIN_SEQ} batch "
        f"{TRAIN_BATCH}, stopped at step {STOP_MLM}, resumed for steps "
        f"{STOP_MLM + 1}-{res.num_steps - 1}: losses equal, parameters "
        f"within {param:.3e}; {json.dumps(out)}")
    shutil.rmtree(d, ignore_errors=True)
    return out


def dp_bert_continue(dev, state, across: bool):
    """The last of ``DP_STEPS`` steps from a restored replicated state on
    the global batch: ``(loss, whole parameters)``."""
    from mpi_tensorflow_torch.train import gspmd, optimizer

    tokens, targets, mask = dp_bert_batches()
    tx = optimizer.transformer_tx(DP_LR, DP_STEPS)
    step = gspmd.make_train_step(tx, across_ranks=across)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    t = DP_STEPS - 1
    state, m = step(state, {"tokens": put(tokens[t]), "mask": put(mask[t])},
                    put(targets[t]))
    return float(m["loss"]), {n: p.detach().clone()
                              for n, p in state.model.named_parameters()}


def dp_restore_check(dev, across: bool) -> dict:
    """14d's restore: each saved layout into a fresh replicated state at
    world 1, then the last step, against the one-process run of all
    ``DP_STEPS`` steps."""
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import checkpoint, gspmd, optimizer
    from mpi_tensorflow_torch.train import state_io

    plain = dp_bert_run(dev, "replicated", 1, np.arange(DP_GLOBAL_B), False)
    out = {}
    for kind in CKPT_DP_KINDS:
        model = bert.BertMlm.from_seed(dp_bert_cfg(), 7).to(dev)
        state = gspmd.init_state(model, optimizer.transformer_tx(DP_LR,
                                                                 DP_STEPS))
        t0 = time.perf_counter()
        arrays, meta = checkpoint.restore_sharded(checkpoint.step_path(
            os.path.join(CKPT_DIR, "dp", kind), DP_STEPS - 2),
            state_io.parts(state))
        state_io.load(state, arrays)
        sec = time.perf_counter() - t0
        loss, params = dp_bert_continue(dev, state, across)
        param, bk = 0.0, 0.0
        for n, p in params.items():
            e = float((p - plain["params"][n]).abs().max())
            if n.endswith(".bk"):
                bk = max(bk, e)
            else:
                param = max(param, e)
        out[kind] = {"loss": abs(loss - float(plain["losses"][-1])),
                     "param": param, "bk": bk, "restore_ms": 1e3 * sec,
                     "saved_world": meta["extra"].get("world")}
    return out


def worker_ckpt_save(backend: str) -> None:
    """14d: ``DP_STEPS - 1`` steps of ``dp_bert_cfg`` from the seed-0
    state in each of ``CKPT_DP_KINDS`` across the ranks, saved sharded
    (each rank its slices)."""
    from mpi_tensorflow_torch.parallel import mesh
    from mpi_tensorflow_torch.train import checkpoint, gspmd, mlm_loop
    from mpi_tensorflow_torch.train import optimizer, state_io
    from mpi_tensorflow_torch.models import bert

    dev, rank, world = join_world(backend)
    tokens, targets, mask = dp_bert_batches()
    rows = mlm_loop.rank_rows(0, DP_GLOBAL_B, 1, rank, world)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
    saved = {}
    for kind in CKPT_DP_KINDS:
        model = bert.BertMlm.from_seed(dp_bert_cfg(), 0).to(dev)
        tx = optimizer.transformer_tx(DP_LR, DP_STEPS)
        state = gspmd.init_for(kind, model, tx)
        step = gspmd.make_train_step(tx, across_ranks=True)
        for t in range(DP_STEPS - 1):
            state, _ = step(state, {"tokens": put(tokens[t]),
                                    "mask": put(mask[t])}, put(targets[t]))
        path = checkpoint.step_path(os.path.join(CKPT_DIR, "dp", kind),
                                    DP_STEPS - 2)
        t0 = time.perf_counter()
        checkpoint.save_sharded(path, state_io.parts(state),
                                step=DP_STEPS - 2, extra={"world": world})
        # rank 0 returns once it has committed; the others may return
        # while it writes meta.json, so rank 0 alone counts the bytes
        saved[kind] = {"save_ms": 1e3 * (time.perf_counter() - t0),
                       "bytes": _dir_bytes(path + ".sharded")
                       if rank == 0 else None}
    if rank == 0:
        print(DP_RESULT + json.dumps({"case": "ckpt_save", "world": world,
                                      "saved": saved}), flush=True)
    mesh.shutdown()


def worker_ckpt_restore(backend: str) -> None:
    """14d: ``dp_restore_check`` in a world of one rank (NCCL)."""
    from mpi_tensorflow_torch.parallel import mesh

    dev, rank, world = join_world(backend)
    out = dp_restore_check(dev, True)
    print(DP_RESULT + json.dumps({"case": "ckpt_restore", "world": world,
                                  "backend": backend, "diff": out}),
          flush=True)
    mesh.shutdown()


WORKERS.update(ckpt_save=worker_ckpt_save,
               ckpt_restore=worker_ckpt_restore)


def ckpt_dp_phase(dev, card: str, save: dict) -> dict:
    """14d: zero1 and fsdp checkpoints of two gloo ranks on ``cuda:0``
    (``save``: their world's result; it ran beside 12b's), each restored
    at world 1 (no process group, in this process) and at world 1 over
    NCCL (torchrun), the continued step within ``DP_TOL`` of the
    uninterrupted one-process step."""
    me = os.path.abspath(__file__)
    # the world-1 NCCL restore in its child while this process restores
    # (both only check)
    started = start_torchruns([(1, [me, "--worker", "ckpt_restore",
                                    "nccl"])])
    try:
        plain = dp_restore_check(dev, False)
    finally:
        (out,) = finish_torchruns(started, 600)
    nccl = dp_result(out)["diff"]
    bad = {(w, k): v for w, res in (("world1", plain), ("nccl1", nccl))
           for k, v in res.items()
           if not (dp_bert_within(v) and v["saved_world"] == 2)}
    out = {"card": card, "saved": save["saved"], "world1": plain,
           "world1_nccl": nccl}
    log(f"[checkpoint] 14d zero1 / fsdp of 2 gloo ranks restored at world "
        f"1 and at world 1 over NCCL, the last of {DP_STEPS} steps against "
        f"the uninterrupted one-process step (tolerance {DP_TOL}): "
        f"{json.dumps(out)}")
    if bad:
        raise AssertionError(f"14d: {bad}")
    shutil.rmtree(os.path.join(CKPT_DIR, "dp"), ignore_errors=True)
    return out


def ckpt_phase(dev, card: str, phase7: dict, save: dict,
               nccl_trace) -> dict:
    """Phase 14: the long-run services (module note); ``save``: 14d's
    two-rank save, run beside 12b; ``nccl_trace``: 13d's ResNet-20 run
    at world 1 over NCCL."""
    out = {}
    for name, run in (("14a", lambda: prefetch_phase(card)),
                      ("14b", lambda: ckpt_image_phase(dev, card,
                                                       nccl_trace)),
                      ("14c", lambda: ckpt_mlm_phase(dev, card, phase7)),
                      ("14d", lambda: ckpt_dp_phase(dev, card, save))):
        phase(name)
        out[name] = run()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


# --------------------------------------------------------------- phase 16

FLEET_DIR = "build/fleet16"
# the fp32 checks (16a-16e): phase 4's short trace, 2 layers at full
# width, every request arriving at once, so the first routing pass
# splits the burst 3 / 3 and a fault at replica 0's tick 3 lands
# mid-decode
FLEET_CHECK = dict(num_requests=6, rate_rps=1e6, prompt_max=32,
                   output_max=16, precision="fp32", layers=2, kernel="cuda")
# 16b: a 5 ms backoff, so the faulted replica is probed back mid-run
FLEET_BACKOFF_MS = 5.0
# 16c: the journaled child's trace (float32: the replayed prefill of
# prompt + delivered must give the tokens the lost decode steps would)
RECOVERY = dict(num_requests=8, rate_rps=8.0, prompt_max=32,
                output_max=64, precision="fp32")
RECOVERY_KILL_TOKS = 8


def fleet_run(r, requests, label: str, exact: bool = True, **kw) -> dict:
    """``r.run(requests, **kw)`` with the paged kernel's launches counted
    from 0: they must equal layers x forward dispatches summed over the
    replicas, and every request must end ``ok``.  ``exact`` False: a
    replica was reset mid-run (a transient fault's probe), and its
    dispatches before the reset are not in the sum, so the launches may
    exceed it by whole layers' worth."""
    from mpi_tensorflow_torch.serving import harness

    res, launches = harness.counted(lambda: r.run(requests, **kw))
    layers = r.engines[0].model.cfg.layers
    want = layers * res["forward_dispatches"]
    if (launches != want if exact else
            launches < want or launches % layers) or launches == 0:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"layers x forward dispatches "
                             f"{layers} x {res['forward_dispatches']}")
    bad = {i: s for i, s in res["statuses"].items() if s != "ok"}
    if bad or len(res["statuses"]) != len(requests):
        raise AssertionError(f"{label}: requests not served: {bad}")
    return {**res, "launches": launches}


def fleet_line(label: str, res: dict, single: dict) -> None:
    log(f"[fleet {label}] " + json.dumps({
        "replicas": len(res["replicas"]), "parallel": res["parallel"],
        "tokens_per_sec": res["tokens_per_sec"],
        "p50_token_latency_ms": res["p50_token_latency_ms"],
        "p99_token_latency_ms": res["p99_token_latency_ms"],
        "single_tokens_per_sec": single["tokens_per_sec"],
        "single_p50_token_latency_ms": single["p50_token_latency_ms"],
        "single_p99_token_latency_ms": single["p99_token_latency_ms"],
        "speedup_vs_single_replica":
            res["tokens_per_sec"] / single["tokens_per_sec"],
        "launches": res["launches"],
        "forward_dispatches": res["forward_dispatches"],
        "per_replica_tokens": [p["tokens"] for p in res["replicas"]],
        "fleet_faults": res["fleet_faults"], "health": res["health"]}))


def check_spans(spans: dict, label: str) -> None:
    """Every finished single-incarnation span: queue + prefill + decode
    == terminal - arrive within 1e-6 s."""
    worst = 0.0
    for sp in spans.values():
        if sp["status"] != "ok" or sp["incarnations"] != 1:
            continue
        total = sp["queue_s"] + sp["prefill_s"] + sp["decode_s"]
        worst = max(worst, abs(total - (sp["terminal"] - sp["arrive"])))
    if worst > 1e-6 or not spans:
        raise AssertionError(f"{label}: phase sums off by {worst} s")
    log(f"[fleet trace] {label}: {len(spans)} spans, phases sum to the "
        f"wall time within {worst:.3e} s")


def worker_tp_serve(backend: str) -> None:
    """16e: one rank of a tensor-parallel engine (``tp`` = the world
    size) serving ``FLEET_CHECK`` on the card; rank 0 reports its
    tokens, the paged kernel's launches counted from 0 and the heads its
    pools hold."""
    from mpi_tensorflow_torch.parallel import mesh
    from mpi_tensorflow_torch.serving import harness

    dev, rank, world = join_world(backend)
    engine, trace = harness.build_serving(**FLEET_CHECK, tp=world,
                                          device=dev)
    res, launches = harness.counted(lambda: engine.run(trace.requests()))
    if rank == 0:
        print(DP_RESULT + json.dumps({
            "world": world, "backend": backend, "device": str(dev),
            "outputs": res["outputs"], "statuses": res["statuses"],
            "launches": launches,
            "forward_dispatches": res["forward_dispatches"],
            "layers": engine.model.cfg.layers,
            "heads": engine.model.cfg.heads,
            "pool_heads": int(engine.pools[0]["k"].shape[1]),
            "tokens_per_sec": res["tokens_per_sec"]}), flush=True)
    mesh.shutdown()


WORKERS.update(tp_serve=worker_tp_serve)


def recovery_check(dev) -> dict:
    """16c: a child ``bench --mode serving --serve-journal`` killed by
    SIGKILL once its journal holds ``RECOVERY_KILL_TOKS`` token records,
    relaunched on the same journal: its outputs must equal an unfaulted
    run of the same trace, served here."""
    from mpi_tensorflow_torch.serving import harness

    os.makedirs(FLEET_DIR, exist_ok=True)
    path = os.path.join(FLEET_DIR, "journal.jsonl")
    if os.path.exists(path):
        os.remove(path)
    cmd = [sys.executable, "-m", "mpi_tensorflow_torch.bench", "--mode",
           "serving", "--precision", RECOVERY["precision"], "--requests",
           str(RECOVERY["num_requests"]), "--arrival-rate",
           str(RECOVERY["rate_rps"]), "--prompt-len",
           str(RECOVERY["prompt_max"]), "--new-tokens",
           str(RECOVERY["output_max"]), "--device", dev.type,
           *(["--serve-tiny"] if RECOVERY.get("tiny") else []),
           "--serve-journal", path]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=root, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL,
                             start_new_session=True)
    toks = 0
    try:
        while time.perf_counter() - t0 < 300 and child.poll() is None:
            if os.path.exists(path):
                with open(path) as f:
                    toks = f.read().count('"tok"')
                if toks >= RECOVERY_KILL_TOKS:
                    break
            time.sleep(0.005)
        if child.poll() is not None:
            raise AssertionError(f"16c: the child ended (exit "
                                 f"{child.returncode}) before the kill, "
                                 f"{toks} token records")
        os.killpg(child.pid, 9)
        child.wait()
    finally:
        if child.poll() is None:
            os.killpg(child.pid, 9)
            child.wait()
    with open(path) as f:
        killed = f.read()
    killed_toks = killed.count('"tok"')
    ended = killed.count('"end"')
    out = run_sub(cmd, 300)
    det = json.loads(out.strip().splitlines()[-1])["detail"]
    engine, trace = harness.build_serving(**RECOVERY, device=dev)
    want = engine.run(trace.requests())["outputs"]
    got = {int(k): v for k, v in det["outputs"].items()}
    if got != want:
        bad = [i for i in want if got.get(i) != want[i]]
        raise AssertionError(f"16c: the resumed outputs differ from the "
                             f"unfaulted run's for requests {bad}")
    if det["status_counts"] != {"ok": len(want)}:
        raise AssertionError(f"16c: statuses {det['status_counts']}")
    res = {"killed_at_token_records": killed_toks,
           "ended_before_kill": ended,
           "resumed_tokens": det["tokens"],
           "delivered_tokens": det["delivered_tokens"],
           "seconds": time.perf_counter() - t0}
    log(f"[fleet recovery] {engine.model.cfg.layers} layers of width "
        f"{engine.model.cfg.hidden}, {RECOVERY['precision']}, "
        f"{len(want)} requests: the "
        f"journaled child SIGKILLed at {killed_toks} token records "
        f"({ended} requests ended), relaunched on the journal: outputs == "
        f"the unfaulted run's; " + json.dumps(res))
    os.remove(path)
    return res


def fleet_phase(dev, card: str, ref: dict, ref_engine, trace) -> dict:
    """Phase 16: the serving fleet (module note).  ``ref``, ``ref_engine``
    and ``trace``: phase 3's timed run, its (warm) engine and trace, the
    single engine the fleet is held beside."""
    from mpi_tensorflow_torch.serving import harness, router
    from mpi_tensorflow_torch.serving import tracing as tracing_lib
    from mpi_tensorflow_torch.utils.metrics_writer import breakdown_block

    out = {}
    phase("16a")
    r = router.ReplicaRouter(harness.fleet_of(ref_engine, 2))
    seq = fleet_run(r, trace.requests(), "16a sequential", parallel=False)
    fleet_line("bf16 sequential", seq, ref)
    # cut for the script's time: the threaded (parallel) fleet's timed run
    # at full width; the fp32 check below runs both modes, its tokens and
    # launches held
    out["launches_fleet"] = {"sequential": seq["launches"]}
    eng32, tr32 = harness.build_serving(**FLEET_CHECK, device=dev)
    single = eng32.run(tr32.requests())
    r32 = router.ReplicaRouter(harness.fleet_of(eng32, 2))
    fl = fleet_run(r32, tr32.requests(), "16a fp32", parallel=False)
    r32.reset()
    fl_par = fleet_run(r32, tr32.requests(), "16a fp32 parallel",
                       parallel=True)
    if not fl["outputs"] == fl_par["outputs"] == single["outputs"]:
        raise AssertionError("16a: fp32 fleet outputs differ from the "
                             "single engine's")
    log(f"[fleet] fp32, 2 layers, {len(single['outputs'])} requests: "
        f"fleet (sequential and parallel) == single engine, placements "
        f"{fl['placements']}")

    phase("16b")
    rf = router.ReplicaRouter(harness.fleet_of(
        eng32, 2, failover_backoff_ms=FLEET_BACKOFF_MS))
    trans = fleet_run(rf, tr32.requests(), "16b transient", exact=False,
                      parallel=False, fault_plan=router.FaultPlan(
                          [router.ReplicaFault(0, 3)]))
    ff = trans["fleet_faults"]
    if trans["outputs"] != fl["outputs"] or ff["failovers"] != 1 \
            or ff["readmissions"] != 1 or trans["health"][0] != "healthy":
        raise AssertionError(f"16b transient: {ff}, health "
                             f"{trans['health']}, outputs equal: "
                             f"{trans['outputs'] == fl['outputs']}")
    rf.reset()
    perm = fleet_run(rf, tr32.requests(), "16b permanent", parallel=False,
                     fault_plan=router.FaultPlan([router.ReplicaFault(
                         0, 3, kind="permanent")]))
    if perm["outputs"] != fl["outputs"] or perm["health"][0] != "dead" \
            or perm["fleet_faults"]["failovers"] != 1:
        raise AssertionError(f"16b permanent: {perm['fleet_faults']}, "
                             f"health {perm['health']}")
    for label, res in (("transient", trans), ("permanent", perm)):
        log(f"[fleet failover] {label} fault at replica 0, tick 3: outputs "
            f"== the unfaulted fleet's, health {res['health']}, "
            f"fleet_faults {json.dumps(res['fleet_faults'])}")

    phase("16c")
    out["recovery"] = recovery_check(dev)

    phase("16d")
    rt = router.ReplicaRouter(harness.fleet_of(ref_engine, 2,
                                               trace="on"))
    traced = fleet_run(rt, trace.requests(), "16d traced", parallel=False)
    check_spans(traced["trace"]["spans"], "bf16 fleet")
    os.makedirs(FLEET_DIR, exist_ok=True)
    chrome = os.path.join(FLEET_DIR, "trace.json")
    tracing_lib.write_chrome_trace(chrome, traced["trace"]["replicas"])
    with open(chrome) as f:
        pids = {e["pid"] for e in json.load(f)["traceEvents"]}
    if pids != {0, 1}:
        raise AssertionError(f"16d: Chrome trace pids {pids}")
    log(f"[fleet trace] bf16 fleet traced: {traced['tokens_per_sec']:.2f} "
        f"tokens/s against {seq['tokens_per_sec']:.2f} untraced (16a "
        f"sequential), p50 {traced['p50_token_latency_ms']:.3f} / "
        f"{seq['p50_token_latency_ms']:.3f} ms; breakdown " + json.dumps(
            breakdown_block(traced["trace"], stamped_first_s=traced[
                "request_first_token_s"])))
    rt32 = router.ReplicaRouter(
        harness.fleet_of(eng32, 2, trace="on"))
    t32 = fleet_run(rt32, tr32.requests(), "16d fp32 traced",
                    parallel=False)
    if t32["outputs"] != fl["outputs"]:
        raise AssertionError("16d: traced fp32 tokens differ from "
                             "untraced")
    check_spans(t32["trace"]["spans"], "fp32 fleet")
    out["trace_cost"] = {"on": traced["tokens_per_sec"],
                         "off": seq["tokens_per_sec"]}
    shutil.rmtree(FLEET_DIR, ignore_errors=True)

    phase("16e")
    me = os.path.abspath(__file__)
    out["launches_tp"] = {}
    # the two worlds side by side (their tokens/s share the card)
    worlds = torchrun_all([(2, [me, "--worker", "tp_serve", "gloo"]),
                           (1, [me, "--worker", "tp_serve", "nccl"])], 300)
    for res in map(dp_result, worlds):
        backend = res["backend"]
        got = {int(k): v for k, v in res["outputs"].items()}
        want_heads = res["heads"] // res["world"]
        want_launches = res["layers"] * res["forward_dispatches"]
        if got != single["outputs"] or res["pool_heads"] != want_heads \
                or res["launches"] != want_launches:
            raise AssertionError(f"16e tp={res['world']} over {backend}: "
                                 f"tokens equal {got == single['outputs']}, "
                                 f"pool heads {res['pool_heads']}, launches "
                                 f"{res['launches']} (want {want_launches})")
        out["launches_tp"][f"tp{res['world']}_{backend}"] = res["launches"]
        log(f"[fleet tp] tp={res['world']} over {backend} on "
            f"{res['device']}: tokens == the tp=1 engine's, the paged "
            f"kernel at H={res['pool_heads']} of {res['heads']}, launches "
            f"{res['launches']} == {res['layers']} x "
            f"{res['forward_dispatches']} on rank 0, "
            f"{res['tokens_per_sec']:.2f} tokens/s")
    return out


# --------------------------------------------------------------- phase 17

ARMS_DIR = "build/arms17"               # git-ignored; emptied before
                                        # 17e and removed after
# the A/B arms' and the tensor-parallel fleet's trace, at 2 layers of
# full width in float32 (phase 4's fp32 checks): a cut of phase 3's (8
# requests of at most 32 tokens, all arriving at once, against 24 of at
# most 128 at 4 rps), so the four arms' eight replays stay short
ARMS_TRACE = dict(num_requests=8, rate_rps=1000.0, prompt_max=32,
                  output_max=32, precision="fp32")
ARMS_LAYERS = 2
ARMS_ARGV = ["--requests", "8", "--arrival-rate", "1000", "--prompt-len",
             "32", "--new-tokens", "32", "--precision", "fp32"]
AB_ARMS = {"kernel_ab": ["--serve-kernel-ab"],
           "kv_ab": ["--serve-kv-ab"],
           "spec_ab": ["--serve-speculative", "ngram", "--serve-spec-ab"],
           "mixed_ab": ["--serve-mixed-batch", "on", "--serve-mixed-ab"]}
DECODE_CHECK = dict(batch=4, prompt=16, new=16, beams=4)
# 17b's timed pairs a decode length (a cut for the script's time: the
# bench's default is 5)
DECODE_ITERS = 3
BEAM_RESCORE_TOL = 1e-4


@contextlib.contextmanager
def serving_layers(n: int):
    """The serving harness's engines at ``n`` layers (full widths): the
    float32 checks' depth (phase 4), where greedy tokens do not part at
    a rounding."""
    import functools

    from mpi_tensorflow_torch.serving import harness

    orig = harness.build_serving
    harness.build_serving = functools.partial(orig, layers=n)
    try:
        yield
    finally:
        harness.build_serving = orig


def serving_args(argv):
    import argparse

    from mpi_tensorflow_torch.serving import harness

    ap = argparse.ArgumentParser()
    harness.add_serving_args(ap)
    args = ap.parse_args(argv)
    harness.check_serving_args(ap, args)
    return args


def decode_checks(dev) -> dict:
    """17a: float32, 2 layers at full width: ``generate`` with top_k = 1
    (sampling at temperature 0.8 from a card generator) == greedy ==
    the paged engine's tokens (its launches == layers x dispatches);
    ``beam_search`` with 1 beam == greedy; the 4-beam search's scores
    == a full-forward rescoring of its sequences within
    ``BEAM_RESCORE_TOL``."""
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.models.gpt import CausalLm
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
    from mpi_tensorflow_torch.serving import engine as eng_lib

    c = DECODE_CHECK
    cfg = dataclasses.replace(bert.BERT_BASE, layers=ARMS_LAYERS)
    model = CausalLm.from_seed(cfg, 0).to(dev)
    g = torch.Generator().manual_seed(17)
    prompt = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt"]),
                           generator=g).to(dev)
    greedy = model.generate(prompt, c["new"])
    top1 = model.generate(prompt, c["new"], temperature=0.8, top_k=1,
                          generator=torch.Generator(device=dev)
                          .manual_seed(0))
    if top1.tolist() != greedy.tolist():
        raise AssertionError("17a: top_k = 1 sampling != greedy")
    engine = eng_lib.PagedDecodeEngine(model, eng_lib.ServeConfig(
        num_blocks=c["batch"] * 4 + 1, block_size=16, max_slots=c["batch"],
        max_seq_len=64, kernel="cuda"), device=dev)
    pk.paged_attention_kernel.launches = 0
    res = engine.run([eng_lib.sched_lib.Request(
        i, prompt[i].tolist(), c["new"]) for i in range(c["batch"])])
    torch.cuda.synchronize(dev)
    launches = pk.paged_attention_kernel.launches
    if launches != cfg.layers * res["forward_dispatches"]:
        raise AssertionError(f"17a: paged launches {launches} != "
                             f"{cfg.layers} x {res['forward_dispatches']}")
    if [res["outputs"][i] for i in range(c["batch"])] != \
            greedy[:, c["prompt"]:].tolist():
        raise AssertionError("17a: the paged engine's tokens != greedy")
    one, _ = model.beam_search(prompt, c["new"], num_beams=1)
    if one[:, 0].tolist() != greedy.tolist():
        raise AssertionError("17a: beam_search with 1 beam != greedy")
    seqs, scores = model.beam_search(prompt, c["new"],
                                     num_beams=c["beams"])
    worst = 0.0
    S0, T = c["prompt"], c["new"]
    with torch.no_grad():
        for b in range(c["beams"]):
            seq = seqs[:, b]
            logits = model.forward_with_cache(
                seq, model.init_cache(c["batch"], S0 + T), 0)
            logp = torch.log_softmax(logits[:, S0 - 1:-1], -1)
            rescored = torch.gather(logp, -1,
                                    seq[:, S0:, None])[..., 0].sum(-1)
            worst = max(worst, float((rescored - scores[:, b]).abs().max()))
    if worst > BEAM_RESCORE_TOL:
        raise AssertionError(f"17a: beam scores differ from a full-forward "
                             f"rescoring by {worst}")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise AssertionError("17a: beams not sorted best first")
    out = {"launches": launches, "beam_rescore_max_abs_err": worst}
    log(f"[decode] fp32, {cfg.layers} layers of width {cfg.hidden}, "
        f"{c['batch']} prompts of {c['prompt']}, {c['new']} new tokens: "
        f"top_k=1 sampling == greedy == the paged engine's tokens "
        f"(launches {launches} == {cfg.layers} x "
        f"{res['forward_dispatches']}); 1-beam search == greedy; "
        f"{c['beams']}-beam scores vs a full-forward rescoring max|err| "
        f"{worst:.3e} (tolerance {BEAM_RESCORE_TOL})")
    return out


def worker_tp_fleet(backend: str) -> None:
    """17e: one rank of 2 tensor-parallel replicas behind the router,
    journaled (``--serve-tp 2 --serve-replicas 2 --serve-journal``), on
    the arms' trace; rank 0 reports the merged outputs, the paged
    kernel's launches counted from 0 and the forward dispatches."""
    from mpi_tensorflow_torch.parallel import mesh
    from mpi_tensorflow_torch.serving import harness

    dev, rank, world = join_world(backend)
    journal = os.path.join(ARMS_DIR, "tp_fleet.jsonl")
    args = serving_args(ARMS_ARGV + [
        "--serve-tp", str(world), "--serve-replicas", "2",
        "--serve-journal", journal])
    with serving_layers(ARMS_LAYERS):
        det = harness._measure(args, dev, world, 2)
    if rank == 0:
        print(DP_RESULT + json.dumps({
            "world": world, "backend": backend, "device": str(dev),
            "outputs": det["outputs"], "statuses": det["status_counts"],
            "launches": det["launches"],
            "forward_dispatches": det["forward_dispatches"],
            "tokens_per_sec": det["tokens_per_sec"]}), flush=True)
    mesh.shutdown()


WORKERS.update(tp_fleet=worker_tp_fleet)


def decode_arms_phase(dev, card: str, ref: dict, ref_engine, trace) -> dict:
    """Phase 17: decoding and the serving bench's remaining arms (module
    note).  ``ref``, ``ref_engine``, ``trace``: phase 3's timed run, its
    engine and trace (the static arm's baseline)."""
    from mpi_tensorflow_torch import bench
    from mpi_tensorflow_torch.serving import harness

    out = {}
    # journals a killed run left would let 17e resume instead of serve
    shutil.rmtree(ARMS_DIR, ignore_errors=True)
    os.makedirs(ARMS_DIR)
    me = os.path.abspath(__file__)
    # 17e's check-only world runs beside 17a's checks (nothing timed)
    world = start_torchruns([(2, [me, "--worker", "tp_fleet", "gloo"])])
    try:
        phase("17a")
        out["decode"] = decode_checks(dev)
        phase("17e")
        with serving_layers(ARMS_LAYERS):
            engine, tr = harness.build_serving(**ARMS_TRACE, device=dev)
            want = engine.run(tr.requests())["outputs"]
            del engine
    finally:
        res = dp_result(finish_torchruns(world, 300)[0])
    got = {int(k): v for k, v in res["outputs"].items()}
    if got != want or res["statuses"] != {"ok": len(want)} \
            or res["launches"] != ARMS_LAYERS * res["forward_dispatches"]:
        raise AssertionError(f"17e: tp 2 fleet tokens equal "
                             f"{got == want}, statuses {res['statuses']}, "
                             f"launches {res['launches']} (want "
                             f"{ARMS_LAYERS} x {res['forward_dispatches']})")
    out["launches_tp_fleet"] = res["launches"]
    log(f"[arms tp] 2 replicas of a tp 2 engine over gloo on "
        f"{res['device']}, journaled: tokens == the tp 1 engine's "
        f"({len(want)} requests), launches {res['launches']} == "
        f"{ARMS_LAYERS} x {res['forward_dispatches']} summed over the "
        f"replicas on rank 0")
    shutil.rmtree(ARMS_DIR, ignore_errors=True)

    phase("17b")
    out["decode_bench"] = {}
    for beams in (0, 4):
        d = bench.measure_decode(num_beams=beams, iters=DECODE_ITERS,
                                 device=dev)
        if d["timing_degenerate"] or not d["per_token_ms"] > 0:
            raise AssertionError(f"17b: decode beams={beams} degenerate: "
                                 f"{d}")
        out["decode_bench"][beams] = d
        log(f"[decode bench] " + json.dumps(d))

    phase("17c")
    static = harness.static_block(ref_engine, trace)
    out["speedup_vs_static"] = ref["tokens_per_sec"] / static[
        "tokens_per_sec"]
    log(f"[static] phase 3's trace through generate on arrival-order "
        f"groups {static['groups']} (rows, padded prompt, budget, cache): "
        f"{static['tokens_per_sec']:.2f} tokens/s against phase 3's "
        f"{ref['tokens_per_sec']:.2f}: speedup_vs_static "
        f"{out['speedup_vs_static']:.3f}; {card}")

    phase("17d")
    out["launches_arms"] = {}
    with serving_layers(ARMS_LAYERS):
        for name, flags in AB_ARMS.items():
            det = harness.measure_serving(serving_args(
                ARMS_ARGV + flags + ["--device", "cuda"]))
            block = det[{"kv_ab": "kv_quant"}.get(name, name)]
            check_arm_launches(f"17d {name}", block, ARMS_LAYERS)
            launches = block["launches"]
            if name == "kernel_ab" and not block["token_identical"]:
                raise AssertionError("17d: cuda and gather tokens differ")
            if name == "spec_ab" and not det["speculation"][
                    "token_identical_vs_off"]:
                raise AssertionError("17d: speculation changed the tokens")
            if name == "mixed_ab" and not block["token_identical_vs_off"]:
                raise AssertionError("17d: mixed batching changed the "
                                     "tokens")
            if det["ok_requests"] != ARMS_TRACE["num_requests"]:
                raise AssertionError(f"17d {name}: {det['status_counts']}")
            out["launches_arms"][name] = launches
            log(f"[arms {name} check] fp32, {ARMS_LAYERS} layers (cut: "
                f"{ARMS_TRACE['num_requests']} requests <= "
                f"{ARMS_TRACE['output_max']} tokens, all at once; its "
                f"times judge nothing): " + json.dumps(block))

    # 17f (spec_ab and mixed_ab timed at full width through
    # measure_serving) is cut for the script's time: each replayed phase
    # 3's trace four times to time what 15d (ngram against its control,
    # the same rope model and trace) and 15c (mixed batching beside phase
    # 3's run of the same trace) time; 17d runs both arms' code and holds
    # their tokens and launches
    return out


# --------------------------------------------------------------- phase 18

def gpt_train_phase(dev, card: str, flash_timing: dict) -> dict:
    """Phase 18: gpt_base next-token training.  18a: the causal kernels
    at the training shape are phase 6's (held against their plain
    versions there; logged here beside SDPA's causal times); 18b: the
    fp32 causal model, flash forced, against dense after 3 steps; 18c:
    ``train_mlm`` with ``model="gpt_base"`` at BERT_BASE widths, bf16,
    S = 4096, batch 4, 8 steps."""
    from mpi_tensorflow_torch.models import gpt

    phase("18a")
    sdpa_fwd = flash_timing["flash_fwd"][True]["library_ms"]
    for name in FLASH:
        t = flash_timing[name][True]
        log(f"[gpt kernels] {name} causal B=4 H=12 S=4096 D=64 bf16: "
            f"{t['ms']:.4f} ms ({t['pct_of_bound']:.2f} % of its bound "
            f"{t['bound_ms']:.4f} ms at half the product flops), "
            f"max|kernel - plain| {t['max_abs_err_train_shape']:.3e}; "
            f"sdpa is_causal forward {sdpa_fwd:.4f} ms, backward "
            f"{t['library_bwd_ms']:.4f} ms; {card}")
    phase("18b")
    cross_check_train(dev, gpt.TrainableCausalLm, "causal")
    phase("18c")
    launches, stats = train_full_width(dev, model="gpt_base")
    return {"launches": launches, "stats": stats}


# --------------------------------------------------------------- phase 19

REMAT_POLICIES = ("full", "dots")
CORPUS_DIR = "build/corpus19"            # git-ignored; removed after
CORPUS_WORDS = ("the quick brown fox jumps over a lazy dog while seven "
                "wizards quietly hex jovial bakers and some running "
                "jumped unbelievable").split()
CORPUS_ARGS = ["--model", "bert_base", "--epochs", "1", "--batch-size", "8",
               "--seq-len", "128", "--log-every", "4", "--precision", "bf16"]


def remat_check(dev) -> dict:
    """19b: float32, 2 layers at full width, dropout 0.1, flash forced,
    S=512, B=2: three train steps with remat "full" and "dots" against
    remat off, for BERT and the enc-dec family, losses and parameters
    bit-equal (the flash backward has no atomics, and a rematted layer
    draws the forward's masks again); then one float32 ResNet-20 step
    (batch 128, cuDNN deterministic) with remat against one without, the
    update and the BatchNorm state bit-equal."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import bert, encdec, resnet
    from mpi_tensorflow_torch.train import gspmd, optimizer
    from mpi_tensorflow_torch.train import step as step_lib
    from mpi_tensorflow_torch.utils import tree as tree_lib

    saved = flash_counts()
    cfg = dataclasses.replace(bert.BERT_BASE, layers=2, dropout=0.1)
    out = {}
    for name, family in (("bert", bert.BertMlm), ("encdec", encdec.EncDecLm)):
        batches = train_batches(dev, family, cfg, seed=6)
        runs = {}
        for policy in (None, *REMAT_POLICIES):
            c = dataclasses.replace(cfg, remat=policy is not None,
                                    remat_policy=policy or "full")
            model = family.from_seed(c, 0, "flash").to(dev)
            tx = optimizer.transformer_tx(1e-4, 3)
            state = gspmd.init_state(model, tx)
            step = gspmd.make_train_step(tx)
            losses = torch.stack([step(state, b, y, gspmd.step_generator(
                3, t, dev))[1]["loss"] for t, (b, y) in enumerate(batches)])
            runs[policy] = (losses.cpu(), [p.detach().clone()
                                           for p in model.parameters()])
        for policy in REMAT_POLICIES:
            same_loss = torch.equal(runs[policy][0], runs[None][0])
            same = [torch.equal(a, b) for a, b in zip(runs[policy][1],
                                                      runs[None][1])]
            if not (same_loss and all(same)):
                diff = max(float((a - b).abs().max()) for a, b in
                           zip(runs[policy][1], runs[None][1]))
                raise AssertionError(
                    f"{name} remat {policy} is not bit-equal to remat off: "
                    f"losses {runs[policy][0].tolist()} vs "
                    f"{runs[None][0].tolist()}, parameters max|diff| {diff}")
        out[name] = runs[None][0].tolist()
        log(f"[remat check {name}] fp32, 2 layers, dropout 0.1, flash, "
            f"S=512, B=2: remat full and dots bit-equal to remat off over 3 "
            f"steps (losses {out[name]})")
    set_flash_counts(saved)
    deterministic = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.normal(size=(128, 32, 32, 3)).astype(
            np.float32) * 0.3).to(dev)
        y = torch.from_numpy(rng.integers(0, 10, 128)).to(dev)
        steps = {}
        for remat in (False, True):
            model = resnet.build("resnet20", 10, seed=0, remat=remat).to(dev)
            state = step_lib.init_state(model)
            step = step_lib.make_train_step(
                model, Config(model="resnet20", batch_size=128), 1, 50000)
            loss = step(state, x, y, None)[1]["loss"]
            steps[remat] = [loss] + [p.detach().clone() for p in
                                     model.parameters()] \
                + tree_lib.leaves(state.model_state)
        if not all(torch.equal(a, b) for a, b in zip(*steps.values())):
            raise AssertionError("ResNet-20's remat step is not bit-equal "
                                 "to its plain step (update or BatchNorm "
                                 "state)")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = deterministic
    out["resnet20_loss"] = float(steps[True][0])
    log(f"[remat check resnet20] fp32 batch 128, cuDNN deterministic: the "
        f"remat step's loss, {len(steps[True]) - 1} parameters and "
        f"statistics bit-equal to the plain step's (loss "
        f"{out['resnet20_loss']:.6f})")
    return out


def corpus_run(card: str) -> dict:
    """19g: ``python -m mpi_tensorflow_torch --model bert_base
    --text-file F --vocab-file V`` for one short epoch on a corpus and a
    WordPiece vocabulary written here: the reference's trace lines at
    its cadence.  Cut for the script's time: the entry point's
    ``cli.main`` runs in this process (``cli_run``), not in a child."""
    from mpi_tensorflow_torch.data import corpus

    shutil.rmtree(CORPUS_DIR, ignore_errors=True)
    os.makedirs(CORPUS_DIR)
    text, vocab = (os.path.join(CORPUS_DIR, n) for n in ("corpus.txt",
                                                         "vocab.txt"))
    rng = np.random.default_rng(19)
    with open(text, "w") as f:
        f.write("\n".join(" ".join(rng.choice(CORPUS_WORDS, 16))
                          for _ in range(900)))
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                           "un", "##believ", "##able", "##ning", "##ed",
                           *sorted(set(CORPUS_WORDS))]))
    try:
        rows = len(corpus.load_mlm(text, seq_len=128, vocab_file=vocab)[0])
        train = rows - max(rows // 10, 1)
        steps = train // 8
        want = [t for t in range(steps) if (t > 0 and t % 4 == 0)
                or t == steps - 1]
        res, lines = cli_run([*CORPUS_ARGS, "--text-file", text,
                              "--vocab-file", vocab], train_fn="mlm")
        trace = check_trace(lines, 1, want, "19g --text-file")
        timing = {"step_ms": res.step_time_seconds * 1e3,
                  "tokens_per_sec": res.tokens_per_sec}
    finally:
        shutil.rmtree(CORPUS_DIR, ignore_errors=True)
    res = {"rows": rows, "steps": steps, "trace": trace, **timing}
    log(f"[corpus] bert_base bf16 --text-file (WordPiece, {rows} rows of "
        f"128, {steps} steps of 8): trace {trace}, step "
        f"{timing['step_ms']:.3f} ms; {card}")
    return res


def training_rest_phase(dev, card: str, phase7: dict) -> dict:
    """Phase 19: the rest of transformer training.  19a: phase 8's
    check for the MoE and the enc-dec family; 19b: remat bit-equality
    (``remat_check``); 19c: ``train_mlm`` with ``moe_bert`` at phase 7's
    shape; 19d: ``encdec_t5`` at S = T = 4096 with remat; 19e: config 5
    with remat full and dots; 19f: config 5 with LAMB under
    warmup-cosine; 19g: the ``--text-file`` CLI run."""
    from mpi_tensorflow_torch.models import encdec, moe

    out = {}
    phase("19a")
    cross_check_train(dev, moe.MoeBertMlm, "moe")
    cross_check_train(dev, encdec.EncDecLm, "encdec")
    phase("19b")
    out["remat_check"] = remat_check(dev)
    phase("19c")
    out["moe"] = train_full_width(dev, "moe_bert")
    phase("19d")
    out["encdec"] = train_full_width(dev, "encdec_t5", remat="full")
    phase("19e")
    for policy in REMAT_POLICIES:
        out[f"remat_{policy}"] = train_full_width(
            dev, remat=policy, label=f"bert_base remat {policy}")
    phase("19f")
    out["lamb"] = train_full_width(dev, optimizer="lamb",
                                   schedule="warmup_cosine",
                                   label="bert_base lamb warmup_cosine")
    phase("19g")
    out["corpus"] = corpus_run(card)
    for key in ("moe", "encdec", "remat_full", "remat_dots", "lamb"):
        st = out[key][1]
        log(f"[rest of training] {key}: {st['step_ms']:.3f} ms a step "
            f"(config 5, phase 7: {phase7['step_ms']:.3f}), "
            f"{st['tokens_per_sec']:.1f} tokens/s, MFU "
            f"{100 * st['mfu_bf16']:.3f} % of bf16 peak, peak "
            f"{st['peak_memory_gib']:.3f} GiB (phase 7: "
            f"{phase7['peak_memory_gib']:.3f})"
            + (f", dropped share {st['dropped_share']:.5f}"
               if "dropped_share" in st else "") + f"; {card}")
    return out


# --------------------------------------------------------------- phase 20

# 20a: VIT_TINY_CIFAR (12 layers of width 192, 4 px patches), dropout
# off, at batch VIT_BATCH of the synthetic CIFAR-10, float32 with TF32
# off: VIT_STEPS image steps, each on the card from the CPU's state
# before it.  scripts/torch_vit_conditioning.py (the CPU, 8 threads):
# the CPU's float32 update (the velocity a step leaves, |delta| / |v|
# over every parameter) lies 3.09e-7 and 2.63e-7 from float64's at these
# two steps, its loss 0.0 (the head's LayerNorm and the loss are
# float32 on both sides); the bounds allow about 5x the update's
# distance and 4 float32 ulps of the loss (ln 10 ~ 2.3); the control,
# TF32 on, must miss the update's.  In bf16 the evaluation logits are
# held to the card's float32 ones by |bf16 - float32| / |float32| over
# the whole (batch, classes) block, within VIT_BF16_EVAL_TOL: the script
# above reads 2.27e-2 on the CPU (12 post-LN layers round the residual
# stream to bf16; the largest difference over max|logit|, 3.19e-2 at
# this state's small logits, max ~0.46, is printed beside it), so the
# bound is twice that; the control, the same bf16 path with every
# parameter rounded through float8 e4m3 first, reads 6.44e-2 there and
# must miss it (the head's LayerNorm in bf16 reads 2.34e-2, which no
# bound on the logits can tell from bf16 itself); remat on must be
# bit-equal to off at dropout 0.1
VIT_STEPS, VIT_BATCH = 2, 128
VIT_TOL = {"loss": 1e-6, "update": 1.6e-6}
VIT_BF16_EVAL_TOL = 4.5e-2
# 20b: the trainer through cli.main on the first VIT_ROWS rows of the
# synthetic CIFAR-10 (13d's 13 000; cut for the script's time: 93 steps
# of 128, a trace every 10).  The reference's ViT under momentum SGD
# stays at chance (docs/convergence_trace_vit_sgd_floor.txt), so its
# errors are printed, not held; then a profiled window of VIT_PROFILE
# steps in each precision (the last thing the script times: a profiler
# session slows later launches)
VIT_ARGS = ["--model", "vit", "--dataset", "cifar10", "--data-dir",
            RESNET_DATA_DIR, "--epochs", "1", "--batch-size",
            str(VIT_BATCH), "--log-every", "10"]
VIT_ROWS = (13000, 2000)
VIT_PROFILE = 5
# 20c: config 5's bench lines with each lever (13e's child), beside its
# plain line; fused_qkv against three products in phase 8's check;
# params_bf16's live parameters == its masters cast to bf16 after each
# of PARAMS_BF16_STEPS steps (BERT_BASE widths, 2 layers, S = 512, B = 2)
PARAMS_BF16_STEPS = 3
# 20e: the admission flags at phase 3's cell (BERT_BASE bf16, the CUDA
# kernel, 24 requests): each argv parsed by the serving entry points'
# parser and its checks, the engine built by ``harness.build_serving``
# from the parsed policy as ``measure_serving`` builds it, each replay
# on a virtual clock of ADMISSION_STEP_S a reading (~30 ms an iteration)
# so its statuses are the scheduler's whatever the card's speed: a
# queue of depth 1 with a 3000 ms deadline (shed and deadline_exceeded;
# the failover backoff and the eviction cap carried, a single engine
# neither fails over nor runs out of blocks), then a stop at
# DRAIN_STOP_S of the clock with a 300 ms drain budget (shed and
# drained); every status counted, summing to the requests
SERVE_CELL = {"precision": "bf16", "kernel": "cuda", "kv_dtype": "fp32"}
ADMISSION_ARGV = ["--serve-queue-depth", "1", "--serve-deadline-ms", "3000",
                  "--serve-max-evictions", "3",
                  "--serve-failover-backoff-ms", "75"]
DRAIN_ARGV = ["--serve-drain-ms", "300"]
ADMISSION_STEP_S, DRAIN_STOP_S = 0.01, 3.0


class ClockStop:
    """A drain guard: ``should_stop`` once ``clock`` reads ``at`` s."""

    def __init__(self, clock, at: float):
        self.clock, self.at = clock, at

    @property
    def should_stop(self) -> bool:
        return self.clock.now >= self.at


def admission_phase(dev, card: str, trace) -> dict:
    """20e (module note): each argv through the serving entry points'
    parser (``harness.add_serving_args``, its checks), the engine built
    at phase 3's cell (``trace``: phase 3's, which the build must
    repeat) from the parsed policy (``harness.admission_policy``)."""
    from collections import Counter

    from mpi_tensorflow_torch.serving import harness

    out = {}
    for name, argv, want in (
            ("admission", ADMISSION_ARGV, ("shed", "deadline_exceeded")),
            ("drain", DRAIN_ARGV, ("shed", "drained"))):
        args = serving_args(argv)
        policy = harness.admission_policy(args)
        engine, tr = harness.build_serving(**SERVE_CELL, **policy,
                                           device=dev)
        serve = engine.serve
        carried = {k: getattr(serve, k) for k in policy}
        if tr.prompts != trace.prompts or any(
                v is not None and carried[k] != v
                for k, v in policy.items()):
            raise AssertionError(f"20e {name}: the engine's policy "
                                 f"{carried} for the flags {policy}, or "
                                 f"not phase 3's trace")
        clock = VirtualClock(ADMISSION_STEP_S)
        guard = ClockStop(clock, DRAIN_STOP_S) if name == "drain" else None
        res, launches = harness.counted(lambda: engine.run(
            tr.requests(), time_fn=clock, guard=guard))
        counts = dict(Counter(res["statuses"].values()))
        layers = engine.model.cfg.layers
        log(f"[admission {name}] {' '.join(argv)} at phase 3's cell "
            f"(harness.build_serving, the engine's policy "
            f"{json.dumps(carried)}) on a virtual clock of "
            f"{ADMISSION_STEP_S * 1e3:g} ms a reading: statuses "
            f"{json.dumps(counts)} of {len(tr.prompts)} requests; faults "
            f"{json.dumps(res['faults'])}; drain {json.dumps(res['drain'])};"
            f" {res['tokens']} tokens, paged launches {launches} == "
            f"{layers} x {res['forward_dispatches']}; {card}")
        if sum(counts.values()) != len(tr.prompts) \
                or any(counts.get(k, 0) < 1 for k in want) \
                or launches != layers * res["forward_dispatches"]:
            raise AssertionError(f"20e {name}: statuses {counts} (want "
                                 f"{want} > 0), launches {launches}")
        out[name] = {"statuses": counts, "launches": launches,
                     "policy": carried}
        del engine
    return out


def vit_model_step(cfg, before, batch, dev, tf32: bool = False,
                   seed: int = 1):
    """One image step of a ViT of ``cfg`` on ``dev`` from ``before`` =
    (parameter tree, velocity, counter) (CPU tensors), TF32 as asked, its
    dropout (``cfg.dropout``) drawn from the step's generator: ``(loss,
    parameter tree, velocity)`` after it, on the CPU."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import vit
    from mpi_tensorflow_torch.train import optimizer, step
    from mpi_tensorflow_torch.train.gspmd import step_generator
    from mpi_tensorflow_torch.utils import tree as tree_lib

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        params, velocity, count = before
        model = vit.VisionTransformer(cfg, params).to(dev)
        state = step.init_state(model)
        state.opt = optimizer.MomentumState(
            [v.to(dev, copy=True) for v in velocity], count)
        x, y = batch
        train = step.make_train_step(model, Config(batch_size=len(y)), 1,
                                     decay_steps=50000)
        gen = (step_generator(seed, int(count), dev) if cfg.dropout > 0
               else None)
        state, m = train(state, torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev), gen)
        return (float(m["loss"]), tree_lib.map_leaves(
            lambda _, t: t.detach().cpu(), model.param_tree()),
            [v.cpu() for v in state.opt.velocity])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def vit_cross_check(dev) -> dict:
    """20a (module note)."""
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import vit
    from mpi_tensorflow_torch.utils import tree as tree_lib

    cfg = dataclasses.replace(vit.VIT_TINY_CIFAR, dropout=0.0)
    b = VIT_BATCH
    data = synthetic.image_classification(b * VIT_STEPS * 12 // 11 + 12, 1,
                                          size=32, channels=3,
                                          num_classes=10, seed=7)
    batches = [(data.train_data[i * b:(i + 1) * b],
                data.train_labels[i * b:(i + 1) * b])
               for i in range(VIT_STEPS)]
    p = vit.VisionTransformer.from_seed(cfg, 0).param_tree()
    p = tree_lib.map_leaves(lambda _, t: t.detach().clone(), p)
    v = [torch.zeros_like(t) for t in tree_lib.leaves(p)]
    cpu, t0 = [], time.perf_counter()
    for t, batch in enumerate(batches):
        before = (p, v, np.float32(t))
        after = vit_model_step(cfg, before, batch, torch.device("cpu"))
        cpu.append((before, after))
        _, p, v = after
    cpu_s = time.perf_counter() - t0

    def apart(tf32):
        loss, update = 0.0, []
        for (before, (c_loss, _, c_v)), batch in zip(cpu, batches):
            g_loss, _, g_v = vit_model_step(cfg, before, batch, dev, tf32)
            loss = max(loss, abs(g_loss - c_loss))
            update.append(whole_rel_diff(g_v, c_v))
        return {"loss": loss, "update": max(update)}

    got, ctl = apart(False), apart(True)
    losses = [after[0] for _, after in cpu]
    log(f"[vit cross-check] VIT_TINY_CIFAR, {VIT_STEPS} steps of batch {b} "
        f"at 32x32x3, float32, each from the CPU's state (CPU {cpu_s:.1f} "
        f"s): CPU losses {losses}; card vs CPU: loss {got['loss']:.3e}, "
        f"update rel. {got['update']:.3e} (tolerance {VIT_TOL}); control, "
        f"TF32 on: loss {ctl['loss']:.3e}, update {ctl['update']:.3e}")
    if not np.isfinite(losses).all() \
            or any(got[k] > VIT_TOL[k] for k in VIT_TOL):
        raise AssertionError(f"20a: ViT card vs CPU {got} (tolerance "
                             f"{VIT_TOL})")
    if not ctl["update"] > VIT_TOL["update"]:
        raise AssertionError(f"20a: the TF32 control reads {ctl}, inside "
                             f"the tolerance {VIT_TOL}")
    # bf16: evaluation logits from the CPU's state after the steps, and
    # the control's (every parameter through float8 e4m3 first)
    x = torch.from_numpy(batches[0][0]).to(dev)
    fp8 = tree_lib.map_leaves(
        lambda _, t: t.to(torch.float8_e4m3fn).to(torch.float32), p)
    with torch.no_grad():
        logits = {name: vit.VisionTransformer(
            dataclasses.replace(cfg, dtype=dt), tree).to(dev)(x).double()
            for name, dt, tree in (("fp32", torch.float32, p),
                                   ("bf16", torch.bfloat16, p),
                                   ("fp8", torch.bfloat16, fp8))}
    want = logits["fp32"]
    bf16, ctl8 = ({"rel": float((logits[k] - want).norm() / want.norm()),
                   "maxrel": float((logits[k] - want).abs().max()
                                   / want.abs().max())}
                  for k in ("bf16", "fp8"))
    log(f"[vit cross-check] bf16 evaluation logits on the card, batch {b}, "
        f"from the CPU's state after the steps: |bf16 - float32| / "
        f"|float32| {bf16['rel']:.3e} (tolerance {VIT_BF16_EVAL_TOL:.3e}; "
        f"max|diff| / max|logit| {bf16['maxrel']:.3e}, max|logit| "
        f"{float(want.abs().max()):.3e}); control, parameters through "
        f"float8 e4m3: {ctl8['rel']:.3e} (max {ctl8['maxrel']:.3e})")
    if not bf16["rel"] <= VIT_BF16_EVAL_TOL:
        raise AssertionError(f"20a: ViT bf16 logits {bf16}")
    if not ctl8["rel"] > VIT_BF16_EVAL_TOL:
        raise AssertionError(f"20a: the float8 control reads {ctl8}, "
                             f"inside the tolerance {VIT_BF16_EVAL_TOL}")
    # remat on the card, dropout 0.1: bit-equal to remat off
    runs = {}
    for remat in (False, True):
        rcfg = dataclasses.replace(vit.VIT_TINY_CIFAR, remat=remat)
        runs[remat] = vit_model_step(rcfg, (p, v, np.float32(VIT_STEPS)),
                                     batches[0], dev)
    same = runs[False][0] == runs[True][0] and all(
        torch.equal(a, c) for a, c in zip(
            tree_lib.leaves(runs[False][1]) + runs[False][2],
            tree_lib.leaves(runs[True][1]) + runs[True][2]))
    log(f"[vit cross-check] remat on vs off on the card, dropout 0.1, one "
        f"step: loss, parameters and velocity bit-equal: {same}")
    if not same:
        raise AssertionError("20a: ViT remat changed the step")
    return {"card_vs_cpu": got, "control_tf32": ctl, "bf16_eval": bf16,
            "control_fp8": ctl8, "cpu_losses": losses}


def vit_profile(dev, card: str) -> dict:
    """20b's profiled window: ``VIT_PROFILE`` bench steps of the ViT at
    batch 128 in each precision (``profiling.device_summary``)."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.train import loop, step
    from mpi_tensorflow_torch.train.gspmd import step_generator
    from mpi_tensorflow_torch.utils import profiling

    out = {}
    for prec in ("fp32", "bf16"):
        cfg = Config(model="vit", dataset="cifar10", image_size=32,
                     batch_size=VIT_BATCH, precision=prec)
        model = loop.build_model(cfg).to(dev)
        state = step.init_state(model)
        train = step.make_train_step(model, cfg, 1, decay_steps=50000)
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(VIT_BATCH, 32, 32, 3, device=dev, generator=g) * 0.3
        y = torch.randint(0, 10, (VIT_BATCH,), device=dev, generator=g)

        def window():
            for i in range(VIT_PROFILE):
                train(state, x, y, step_generator(2, i, dev))

        summary = profiling.device_summary(profiling.profiled_kernels(
            window, window))
        summary["kernels_a_step"] = summary["kernel_events"] / VIT_PROFILE
        log(f"[vit profile] {prec}, batch {VIT_BATCH}, {VIT_PROFILE} steps: "
            + json.dumps(summary) + f"; {card}")
        out[prec] = summary
        del model, state
    return out


def vit_lever_phase(dev, card: str, bench_lines: dict) -> dict:
    """Phase 20a-d (module note): the ViT's checks, its trainer run, its
    and the levers' bench lines (13e's child), the levers' checks, and
    the ViT's profiled window.  Every hand kernel's count is 0 before
    20a and must be 0 after 20b (the ViT launches none)."""
    from mpi_tensorflow_torch.data import cifar
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import gspmd, loop, optimizer
    from mpi_tensorflow_torch.utils import tree as tree_lib

    out = {}
    saved = hand_kernel_counts()
    set_hand_kernel_counts({k: 0 for k in saved})
    phase("20a")
    out["cross_check"] = vit_cross_check(dev)
    phase("20b")
    every = [t for t in range(10, 93, 10)] + [92]
    real_load = loop.load_dataset
    loop.load_dataset = lambda config, num_shards, *a, **kw: \
        cifar.load_splits(config.data_dir, *VIT_ROWS)
    try:
        out["cli"] = resnet_cli(dev, card, VIT_ARGS, 93, every,
                                gate_error=False, label="vit")
    finally:
        loop.load_dataset = real_load
    torch.cuda.synchronize(dev)
    launched = hand_kernel_counts()
    set_hand_kernel_counts(saved)
    if any(launched.values()):
        raise AssertionError(f"the ViT path launched hand kernels: "
                             f"{launched}")
    out["launches"] = launched
    for prec in ("fp32", "bf16"):
        line = bench_lines[f"vit {prec}"]
        if any(line["flash_launches"].values()):
            raise AssertionError(f"20b: the ViT bench launched flash: "
                                 f"{line}")
        log(f"[vit bench] {prec}: {line['images_per_sec']:.1f} images/s, "
            f"step {line['step_time_ms']:.3f} ms, MFU "
            f"{line['mfu_pct']:.3f} %, peak {line['peak_memory_gib']:.3f} "
            f"GiB (13e's line); no hand kernel launched; {card}")
    phase("20c")
    base = bench_lines["bert_base bf16"]
    out["levers"] = {}
    for name in LEVERS:
        line = bench_lines[f"bert_base bf16 {name}"]
        want = {k: 12 * bench_steps_launched(line) for k in FLASH}
        if line["flash_launches"] != want \
                or line["flash_launches"] != base["flash_launches"]:
            raise AssertionError(f"20c {name}: flash launches "
                                 f"{line['flash_launches']} (want {want})")
        out["levers"][name] = line
        log(f"[lever {name}] config 5 (BERT_BASE bf16, S = 4096, batch 4): "
            f"step {line['step_time_ms']:.3f} ms against "
            f"{base['step_time_ms']:.3f} ms plain, peak "
            f"{line['peak_memory_gib']:.3f} against "
            f"{base['peak_memory_gib']:.3f} GiB, bytes at rest "
            f"{json.dumps(line['bytes_at_rest'])}, flash launches "
            f"{json.dumps(line['flash_launches'])}; {card}")
    cross_check_train(dev, label="fused_qkv", arms={
        "fused": ("flash", {"fused_qkv": True}), "unfused": ("flash", {})})
    # params_bf16: the live parameters are the masters cast, every step
    cfg = dataclasses.replace(bert.BERT_BASE, layers=2, dtype=torch.bfloat16)
    batches = train_batches(dev, bert.BertMlm, cfg, n=PARAMS_BF16_STEPS)
    model = bert.BertMlm.from_seed(cfg, 0).to(dev)
    tx = optimizer.transformer_tx(1e-4, PARAMS_BF16_STEPS)
    state = gspmd.init_state(model, tx, param_dtype=torch.bfloat16)
    train = gspmd.make_train_step(tx)
    leaves = tree_lib.leaves(model.param_tree())
    losses = []
    for i, batch in enumerate(batches):
        gen = gspmd.step_generator(3, i, dev)
        state, m = train(state, *batch, gen)
        losses.append(float(m["loss"]))
        if not all(p.dtype == torch.bfloat16 and mp.dtype == torch.float32
                   and torch.equal(p, mp.to(torch.bfloat16))
                   for p, mp in zip(leaves, state.opt.master)):
            raise AssertionError(f"20c: after step {i} the live "
                                 f"parameters are not the masters cast")
    log(f"[lever params_bf16] 2 layers at full width, bf16, S=512, B=2, "
        f"{PARAMS_BF16_STEPS} steps: live (bf16) == masters (float32) cast "
        f"after each; losses {losses}; bytes at rest "
        f"{json.dumps(gspmd.bytes_at_rest(state))}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"20c params_bf16 losses {losses}")
    del model, state
    phase("20d")
    dense = bench_lines["bert_base bf16 S=1024"]
    flash = bench_lines["bert_base bf16 S=1024 flash_min_seq 0"]
    want = {k: 12 * bench_steps_launched(flash) for k in FLASH}
    if any(dense["flash_launches"].values()) \
            or flash["flash_launches"] != want \
            or flash["flash_min_seq"] != 0 \
            or dense["flash_min_seq"] != bert.BERT_BASE.flash_min_seq:
        raise AssertionError(f"20d: dense {dense['flash_launches']}, flash "
                             f"{flash['flash_launches']} (want {want})")
    out["crossover"] = {"dense": dense, "flash": flash,
                        "flash_over_dense": flash["tokens_per_sec"]
                        / dense["tokens_per_sec"]}
    log(f"[crossover] BERT_BASE bf16, S = 1024, batch 16: dense "
        f"{dense['tokens_per_sec']:.1f} tokens/s ({dense['step_time_ms']:.3f}"
        f" ms, peak {dense['peak_memory_gib']:.3f} GiB), flash "
        f"(--flash-min-seq 0) {flash['tokens_per_sec']:.1f} tokens/s "
        f"({flash['step_time_ms']:.3f} ms, peak "
        f"{flash['peak_memory_gib']:.3f} GiB): flash / dense "
        f"{out['crossover']['flash_over_dense']:.4f}; flash launches "
        f"{json.dumps(flash['flash_launches'])}; {card}")
    phase("20b profile")
    out["profile"] = vit_profile(dev, card)
    return out


# --------------------------------------------------------------- phase 21

# 21a: K graphed steps (one replay of ``step.make_multi_train_step`` /
# ``gspmd.make_multi_step``) against K eager steps of the same function
# (``train.graphs.use_graphs`` answering False), each from the same
# seeded state: bit for bit, or, where they differ, within the distance
# of a second eager run from the first (cuDNN deterministic, TF32 off)
SCAN_IMAGE_CASES = (("cnn fp32 dropout", "mnist_cnn", "fp32", 64, 5),
                    ("resnet20 fp32", "resnet20", "fp32", 128, 3),
                    ("vit fp32", "vit", "fp32", 128, 3),
                    ("vit bf16", "vit", "bf16", 128, 3))
# (label, family, S, batch, K, BertConfig changes): config 5 with remat
# full and dropout at S = 4096 (the flash kernels in the graph), the
# causal LM there too, the MoE and the enc-dec family at S = 1024 with
# flash_min_seq 0 (the flash kernels at a quarter of the time)
SCAN_LM_CASES = (("config 5 remat", "bert_base", 4096, 4, 2,
                  dict(remat=True)),
                 ("gpt_base", "gpt_base", 4096, 4, 2, {}),
                 ("moe_bert", "moe_bert", 1024, 4, 2, dict(flash_min_seq=0)),
                 ("encdec_t5", "encdec_t5", 1024, 4, 2,
                  dict(flash_min_seq=0)))
SCAN_SEED = 5
# 21f, in a child process (no profiler session before its timing): the
# graphed dispatch beside K eager steps of the same function on the same
# state, each the median of SCAN_TIMED_CALLS calls after two, then each
# profiled (a second pass, after every timing) for its idle share
# (label, kind, arm arguments, the bench's K, the profiled window's
# steps, short: the profiler handles every kernel event on the host); an
# eager image call runs at most SCAN_EAGER_STEPS of its K steps
SCAN_TIMED = (("cnn fp32", "image", ("mnist_cnn", "fp32", 64), 400, 20),
              ("resnet20 fp32", "image", ("resnet20", "fp32", 128), 50, 4),
              ("resnet50 bf16", "image", ("resnet50", "bf16", 32), 8, 2),
              ("vit fp32", "image", ("vit", "fp32", 128), 20, 2),
              ("vit bf16", "image", ("vit", "bf16", 128), 20, 2),
              ("config 5", "lm", ("bert_base", 4096, 4, {}), 4, 1),
              ("config 5 BASELINE shape", "lm", ("bert_base", 128, 64, {}),
               4, 1))
SCAN_TIMED_CALLS = 3
SCAN_EAGER_STEPS = 10
# decode: the bench's slope between 8 and 72 new tokens (its default
# lengths are 16 and 144), a profile of 4 tokens
SCAN_DECODE = dict(batch=8, prompt=32, new=64, profiled=4)


@contextlib.contextmanager
def eager_only():
    """Every graphed path of the port runs its eager loop inside the
    block (the control of phase 21)."""
    from mpi_tensorflow_torch.train import graphs

    real = graphs.use_graphs
    graphs.use_graphs = lambda device: False
    try:
        yield
    finally:
        graphs.use_graphs = real


def scan_image_arm(dev, name: str, prec: str, B: int, K: int,
                   horizon: int):
    """``(multi(n=K) -> losses (K,), tensors())``: the image multi-step
    of ``name`` over the first n of one seeded window of K batches, and
    the state's parameters, velocity and BatchNorm state."""
    from mpi_tensorflow_torch import bench
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.train import loop, step
    from mpi_tensorflow_torch.utils import tree as tree_lib

    spec = bench.IMAGE_SPECS[name]
    cfg = Config(model=name, batch_size=B, precision=prec,
                 num_classes=spec["classes"], image_size=spec["shape"][0],
                 dataset=spec.get("dataset", "mnist"))
    model = loop.build_model(cfg).to(dev)
    state = step.init_state(model)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((K, B, *spec["shape"]), device=dev, generator=g) * 0.3
    y = torch.randint(0, cfg.num_classes, (K, B), device=dev, generator=g)
    multi = step.make_multi_train_step(model, cfg, 1, 50000,
                                       horizon=horizon)

    def tensors():
        return [t.detach().clone() for t in list(model.parameters())
                + state.opt.velocity + tree_lib.leaves(state.model_state)]
    return (lambda n=None: multi(state, x, y, n)[1]["loss"]), tensors


def scan_lm_arm(dev, family: str, S: int, B: int, K: int, extra: dict,
                horizon: int, dropout: float = 0.1, model=None):
    """``(multi(n=K) -> losses (n,), tensors())`` for a transformer
    family at BERT_BASE widths in bf16 over the first n of one window of
    K batches (``model``: one built for the same arguments, reused)."""
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import gspmd, mlm_loop, optimizer
    from mpi_tensorflow_torch.utils import tree as tree_lib

    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                              dropout=dropout,
                              max_positions=max(512, S), **extra)
    if model is None:
        model = mlm_loop.FAMILIES[family].from_seed(cfg, 0).to(dev)
    tx = optimizer.transformer_tx(1e-4, horizon)
    state = gspmd.init_state(model, tx)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(
        K, B, S)).to(dev)
    if family == "encdec_t5":
        src, tgt = synthetic.seq2seq_batches(K * B, src_len=S, tgt_len=S,
                                             vocab_size=cfg.vocab_size,
                                             seed=0)
        batch, labels = {"src": put(src), "tgt": put(tgt)}, put(tgt)
    else:
        tok, tgt, mask = synthetic.mlm_batches(K * B, seq_len=S,
                                               vocab_size=cfg.vocab_size,
                                               seed=0)
        batch, labels = {"tokens": put(tok), "mask": put(mask)}, put(tgt)
    multi = gspmd.make_multi_step(tx, seed=SCAN_SEED, horizon=horizon)

    def tensors():
        return [t.detach().clone() for t in
                tree_lib.leaves(model.param_tree())]

    def run(n=None):
        return multi(state, {k: v[:n] for k, v in batch.items()},
                     labels[:n])[1]["loss"]
    run.model = model
    return run, tensors


def _scan_distance(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def scan_bit_phase(dev, card: str) -> dict:
    """21a: each case's graphed run against an eager run (module note);
    the flash launches of the graphed transformer runs counted
    from 0 (the capture's warm-up window and the replay)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out, launches = {}, {}
    try:
        cases = [(label, "image", args, args[-1]) for label, *args in
                 SCAN_IMAGE_CASES] + [
            (label, "lm", args, args[3]) for label, *args in SCAN_LM_CASES]
        for label, kind, args, K in cases:
            runs, built = {}, {}

            def run(arm):
                if kind == "image":
                    multi, tensors = scan_image_arm(dev, *args[:3], K, K)
                else:           # one build a case, its parameters put back
                    model = built.get("model")
                    if model is not None:
                        with torch.no_grad():
                            for p, p0 in zip(model.parameters(),
                                             built["init"]):
                                p.copy_(p0)
                    multi, tensors = scan_lm_arm(dev, args[0], args[1],
                                                 args[2], K, args[4], K,
                                                 model=model)
                    if model is None:
                        built["model"] = multi.model
                        built["init"] = [p.detach().clone() for p in
                                         multi.model.parameters()]
                set_flash_counts({k: 0 for k in FLASH})
                with eager_only() if arm != "graphed" \
                        else contextlib.nullcontext():
                    losses = multi()
                torch.cuda.synchronize(dev)
                runs[arm] = [losses.detach().clone()] + tensors()
                torch.cuda.empty_cache()
                return flash_counts()

            run("eager")
            counts = run("graphed")
            dist = _scan_distance(runs["graphed"], runs["eager"])
            spread = 0.0
            if dist:        # the bound: two eager runs' distance
                run("eager again")
                spread = _scan_distance(runs["eager again"], runs["eager"])
            if not all(torch.isfinite(t.float()).all()
                       for t in runs["graphed"]):
                raise AssertionError(f"21a {label}: non-finite")
            if dist > spread:
                raise AssertionError(
                    f"21a {label}: graphed against eager {dist}, two eager "
                    f"runs {spread} apart")
            if kind == "lm":
                # the warm-up window's launches and the replay's, alike:
                # the forward twice a layer under remat
                launches[label] = counts
                per = 2 if args[4].get("remat") else 1
                dq = counts["flash_dq"]
                if dq == 0 or dq % (2 * K) or counts["flash_fwd"] != per * dq \
                        or counts["flash_dkdv"] != dq:
                    raise AssertionError(f"21a {label}: flash launches "
                                         f"{counts}")
            out[label] = {"K": K, "graphed_vs_eager": dist,
                          "eager_vs_eager": spread,
                          "bit_equal": dist == 0.0,
                          "losses": runs["graphed"][0].float().tolist()}
            held = f" (two eager runs {spread} apart)" if dist \
                else ": bit for bit"
            log(f"[scan 21a] {label}: {K} graphed steps against {K} eager "
                f"ones: max|diff| {dist}{held}; flash "
                f"launches of the graphed run (warm-up window + replay) "
                f"{json.dumps(counts)}; {card}")
    finally:
        torch.backends.cudnn.deterministic = saved
    return {"cases": out, "launches": launches}


def scan_trainer_phase(dev, card: str, graphed: dict) -> dict:
    """21b: the zero-flag CNN trainer (graphed windows of 51 steps, the
    evaluation one replay; 10b's run, ``graphed``) against ``--fused-steps
    1`` (one eager step at a time): the 32 trace lines and the
    parameters and velocity identical (cuDNN deterministic in both)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        eager, e_lines = cli_run(["--data-dir", CNN_DATA_DIR,
                                  "--fused-steps", "1"])
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = saved
    res = graphed["result"]
    dist = _apart(_image_state(res), _image_state(eager))
    g_lines, e_lines = ([ln for ln in lines if TRACE_LINE.fullmatch(ln)]
                        for lines in (graphed["lines"], e_lines))
    if g_lines != e_lines or len(g_lines) != 32 or dist != 0.0:
        raise AssertionError(f"21b: graphed trace {g_lines[-3:]} against "
                             f"eager {e_lines[-3:]}, state {dist} apart")
    out = {"steps": res.num_steps, "trace_lines": len(g_lines),
           "graphed_wall_s": graphed["wall_s"], "eager_wall_s": wall,
           "graphed_step_ms": res.step_time_seconds * 1e3,
           "eager_step_ms": eager.step_time_seconds * 1e3}
    log(f"[scan 21b] zero-flag CNN trainer, graphed windows (10b's run) "
        f"against --fused-steps 1: trace lines and state identical; "
        f"{json.dumps(out)}; {card}")
    return out


def scan_decode_phase(dev, card: str) -> dict:
    """21d: ``generate`` (greedy; sampled at temperature 0.8, top-k 50,
    one seed), ``beam_search`` (4 beams) and the enc-dec ``generate``,
    each one graph replay, against their eager loops at BERT_BASE bf16:
    tokens (and beam scores, and the sampling generator's state after
    the call) identical, at the capture and at a second replay."""
    from mpi_tensorflow_torch.models import bert, encdec
    from mpi_tensorflow_torch.models.gpt import CausalLm

    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16)
    model = CausalLm.from_seed(cfg, 0).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), device=dev,
                           generator=g)
    n = 16
    out = {}
    for rep in range(2):
        want = model.decode_loop(prompt, n)
        if not torch.equal(model.generate(prompt, n), want):
            raise AssertionError(f"21d greedy (call {rep})")
        ga, gb = (torch.Generator(device=dev).manual_seed(7 + rep)
                  for _ in range(2))
        got = model.generate(prompt, n, temperature=0.8, top_k=50,
                             generator=ga)
        want = model.decode_loop(prompt, n, temperature=0.8, top_k=50,
                                 generator=gb)
        if not torch.equal(got, want) or not torch.equal(
                ga.get_state(), gb.get_state()):
            raise AssertionError(f"21d sampled (call {rep})")
        seqs, scores = model.beam_search(prompt, n, num_beams=4)
        wseqs, wscores = model.beam_loop(prompt, n, num_beams=4)
        if not (torch.equal(seqs, wseqs) and torch.equal(scores, wscores)):
            raise AssertionError(f"21d beams (call {rep})")
    out["causal"] = {"graphs": len(model._call_graphs) - 1}
    del model
    ed = encdec.EncDecLm.from_seed(cfg, 0).to(dev)
    src = torch.randint(0, cfg.vocab_size, (4, 32), device=dev, generator=g)
    for rep in range(2):
        if not torch.equal(ed.generate(src, n), ed.decode_loop(src, n)):
            raise AssertionError(f"21d enc-dec (call {rep})")
    log(f"[scan 21d] decode at BERT_BASE bf16, batch 4, prompt 16, {n} "
        f"tokens: generate greedy and sampled (seed 7, 8; the generator's "
        f"state after the call too), beam_search of 4 and the enc-dec "
        f"generate, each one graph replay, identical to their eager loops "
        f"at the capture's call and a replay; {card}")
    return out


def _scan_timed_arm(dev, kind, args, K, horizon):
    """``multi(n=K)``: the image or transformer arm's first n steps of
    its window of K, graphed (one graph a width) or under
    ``eager_only`` eager."""
    if kind == "image":
        return scan_image_arm(dev, *args, K, horizon)[0]
    family, S, B, extra = args
    return scan_lm_arm(dev, family, S, B, K, extra, horizon)[0]


def _median_ms(fn, calls: int, per: int, warm: int = 2) -> float:
    """The median ms of ``calls`` calls of ``fn`` (each closed by a
    synchronisation), after ``warm``, divided by ``per``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3 / per


def worker_scan_timing(_backend: str) -> None:
    """21e-f in a process of its own (no profiler session before the
    timing): each of ``SCAN_TIMED`` graphed (one replay of K steps)
    beside eager (K steps of the same function), decode (the bench's
    ``measure_decode``, graphed and eager) and the all-reduce chain (the
    bench's, in a world of one over NCCL, graphed and eager); after every
    timing, one call of each arm profiled on the same graphs for its
    idle share, over ``K_p`` steps (decode: ``profiled`` tokens).
    Progress lines
    ``[scan-t]``."""
    from mpi_tensorflow_torch import bench
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.models.gpt import CausalLm
    from mpi_tensorflow_torch.parallel import collectives
    from mpi_tensorflow_torch.parallel import mesh as meshlib
    from mpi_tensorflow_torch.train import graphs
    from mpi_tensorflow_torch.utils import profiling
    from mpi_tensorflow_torch.utils.device import resolve_device

    dev = resolve_device(torch.device("cuda", 0))
    t_start = time.perf_counter()

    def say(what):
        print(f"[scan-t] {what} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    lines, arms = {}, {}
    for label, kind, args, K, K_p in SCAN_TIMED:
        multi = _scan_timed_arm(dev, kind, args, K, 64 * K)
        n = min(K, SCAN_EAGER_STEPS) if kind == "image" else K
        graphed_ms = _median_ms(multi, SCAN_TIMED_CALLS, K)
        with eager_only():
            eager_ms = _median_ms(lambda: multi(n), SCAN_TIMED_CALLS, n,
                                  warm=1)
        lines[label] = {"K": K, "graphed_step_ms": graphed_ms,
                        "eager_step_ms": eager_ms, "eager_steps_a_call": n}
        arms[label] = (multi, K_p)
        say(label)
    dec = SCAN_DECODE
    lines["decode"] = {"graphed": bench.measure_decode(
        dec["batch"], dec["prompt"], dec["new"], "bf16", 3, device=dev)}
    with eager_only():          # two timed calls a length (~2 s each)
        lines["decode"]["eager"] = bench.measure_decode(
            dec["batch"], dec["prompt"], dec["new"], "bf16", 2, device=dev)
    say("decode")
    meshlib.initialize_distributed(
        dev, init_method=f"tcp://127.0.0.1:{meshlib.free_port()}", rank=0,
        world_size=1)
    try:
        lines["allreduce"] = {"graphed": bench.measure_allreduce(device=dev)}
        with eager_only():
            lines["allreduce"]["eager"] = bench.measure_allreduce(
                device=dev)
        say("allreduce")
        # the profiles, after every timing: one call of each arm
        x = torch.ones(int(25.4e6 / 4), device=dev)

        def chain():
            for _ in range(32):
                collectives.allreduce_sum(x).mul_(1.0)
        replay = graphs.Graphs(dev).capture(chain, [])
        lines["allreduce"]["idle"] = {
            "graphed": profiling.device_summary(profiling.profiled_kernels(
                replay.replay, replay.replay))["device_idle_share"],
            "eager": profiling.device_summary(profiling.profiled_kernels(
                chain, chain))["device_idle_share"]}
    finally:
        meshlib.shutdown()
    for label, (multi, K_p) in arms.items():
        idle = {}
        multi(K_p)                  # its graph of K_p steps captured
        for arm in ("graphed", "eager"):
            ctx = eager_only() if arm == "eager" else contextlib.nullcontext()
            with ctx:
                s = profiling.device_summary(profiling.profiled_kernels(
                    lambda: multi(K_p), lambda: multi(K_p)))
            idle[arm] = {"device_idle_share": s["device_idle_share"],
                         "device_busy_ms_a_step": s["device_busy_ms"] / K_p,
                         "kernels_a_step": s["kernel_events"] / K_p,
                         "steps": K_p}
        lines[label]["profile"] = idle
        say(f"{label} profiled")
    del arms
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16)
    model = CausalLm.from_seed(cfg, 0).to(dev)
    prompt = torch.randint(0, cfg.vocab_size, (dec["batch"], dec["prompt"]),
                           device=dev)
    n = dec["profiled"]
    model.generate(prompt, n)
    idle = {}
    for arm, fn in (("graphed", lambda: model.generate(prompt, n)),
                    ("eager", lambda: model.decode_loop(prompt, n))):
        s = profiling.device_summary(profiling.profiled_kernels(fn, fn))
        idle[arm] = {"device_idle_share": s["device_idle_share"],
                     "device_busy_ms_a_token": s["device_busy_ms"] / n,
                     "kernels_a_token": s["kernel_events"] / n}
    lines["decode"]["profile"] = idle
    say("decode profiled")
    print(DP_RESULT + json.dumps({"case": "scan_timing", "lines": lines}),
          flush=True)


WORKERS.update(scan_timing=worker_scan_timing)


def scan_timing_phase(card: str) -> dict:
    """21e-f: ``worker_scan_timing``'s lines, printed."""
    out = run_sub([sys.executable, os.path.abspath(__file__), "--worker",
                   "scan_timing", "none"], timeout=600)
    for ln in out.splitlines():
        if ln.startswith("[scan-t]"):
            log(ln)
    lines = dp_result(out)["lines"]
    for label, line in lines.items():
        if label in ("decode", "allreduce"):
            continue
        p = line["profile"]
        log(f"[scan timing] {label}: graphed {line['graphed_step_ms']:.4f} "
            f"ms a step (idle {p['graphed']['device_idle_share']}, busy "
            f"{p['graphed']['device_busy_ms_a_step']:.4f} ms, "
            f"{p['graphed']['kernels_a_step']:.1f} kernels a step), eager "
            f"{line['eager_step_ms']:.4f} ms (idle "
            f"{p['eager']['device_idle_share']}, busy "
            f"{p['eager']['device_busy_ms_a_step']:.4f} ms); K "
            f"{line['K']}; {card}")
    d = lines["decode"]
    log(f"[scan timing] decode (BERT_BASE bf16, batch "
        f"{SCAN_DECODE['batch']}, the bench's slope): graphed "
        f"{d['graphed']['per_token_ms']:.4f} ms a token, eager "
        f"{d['eager']['per_token_ms']:.4f} ms; idle "
        f"{json.dumps(d['profile'])}; roofline "
        f"{d['graphed']['roofline_min_per_token_ms']:.4f} ms; {card}")
    a = lines["allreduce"]
    if not a["graphed"]["graph_replay"] or a["eager"]["graph_replay"]:
        raise AssertionError(f"21e: allreduce arms {a}")
    log(f"[scan timing] all-reduce chain of 32, 25.4 MB, world of one over "
        f"NCCL: graphed {a['graphed']['allreduce_ms']:.4f} ms an "
        f"all-reduce, eager {a['eager']['allreduce_ms']:.4f} ms; idle "
        f"{json.dumps(a['idle'])}; {card}")
    return lines


def scan_phase(dev, card: str) -> dict:
    """Phase 21a and 21d: the scanned arm's checks on the card (module
    note; 21b runs after 10b, 21c is 14b's stop; 21e-f's timing is run
    alone: ``scan_timing_phase``)."""
    phase("21a")
    bits = scan_bit_phase(dev, card)
    phase("21d")
    decode = scan_decode_phase(dev, card)
    return {"bits": bits, "decode": decode, "launches": bits["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda reports no card; nothing was run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(f"[host] {host_line()}")
    from mpi_tensorflow_torch.utils.device import resolve_device

    resolve_device(dev)                  # TF32 off for float32 products
    torch.empty(0, device=dev)           # the allocator up, for its stats
    phase("1 build")
    build()
    phase("2 paged kernel")
    worst = check_kernel(dev)
    quant_worst = check_kernel_quant(dev)
    phase("3 serving")
    launches, ref, engine, trace = serve_full_width(dev)
    quant = serve_quant(dev, card, ref, launches, engine, trace)
    quant_launches = quant["launches"]
    phase("4 cross-checks")
    cross_check(dev)
    cross_check_quant(dev)
    # every serving timing before any torch.profiler session (phase 2's
    # timing opens one, and a profile slows later launches)
    phase("16 serving fleet")
    fleet = fleet_phase(dev, card, ref, engine, trace)
    phase("15 serving features")
    features = feature_phase(dev, card, ref, engine, trace)
    phase("17 decoding and the serving bench's arms")
    arms = decode_arms_phase(dev, card, ref, engine, trace)
    phase("20e the admission flags")
    admission = admission_phase(dev, card, trace)
    del engine
    phase("21 the scanned arm")
    scan = scan_phase(dev, card)
    phase("2 paged kernel timing")
    timing = time_decode(dev)
    quant_timing = time_decode_quant(dev)
    phase("5-6 flash kernels")
    flash_worst = check_flash(dev)
    check_flash_grads(dev)
    flash_timing = time_flash(dev)
    phase("7-8 training")
    flash_launches, phase7 = train_full_width(dev)
    cross_check_train(dev)
    phase("18 gpt_base training")
    gpt_train = gpt_train_phase(dev, card, flash_timing)
    phase("19 the rest of transformer training")
    rest = training_rest_phase(dev, card, phase7)
    # no path runs the fused kernels: their counts stay at 0 through
    # every main path above, and the comparison launches below are reset
    fused_launches = fused_counts()
    if any(fused_launches.values()):
        raise AssertionError(f"a main path launched a fused kernel: "
                             f"{fused_launches}")
    phase("9 fused kernels")
    fused_worst = check_fused(dev)
    fused_timing = time_fused(dev)
    from mpi_tensorflow_torch.ops import fused

    fused.layer_norm_forward.launches = fused_launches["layer_norm"]
    fused.online_logsumexp.launches = fused_launches["logsumexp"]
    phase("10 CNN trainer")
    cnn = cnn_phase(dev, card)
    phase("21b the zero-flag trainer graphed against eager")
    scan_trainer_phase(dev, card, cnn["runs"]["fp32"])
    phase("11 data axis")
    dp = dp_phase(card, cnn)
    phase("12 data-parallel BERT")
    # phase 22's check-only worlds run beside 12b's (for the script's time)
    bert_phase = bert_dp_phase(card, phase7, beside=tpsp_jobs())
    bert_dp = bert_phase["bert_train"]["runs"]
    phase("22 tensor and sequence parallelism")
    tpsp = tpsp_phase(card, phase7, bert_phase["beside"])
    phase("13 ResNets")
    resnet = resnet_phase(dev, card, dp["resnet_worlds"])
    resnet_launches = resnet["launches"]
    long_run = ckpt_phase(dev, card, phase7, bert_phase["ckpt_save"],
                          resnet["nccl_trace"])
    phase("20 ViT and the bench's levers")
    vit_levers = vit_lever_phase(dev, card, resnet["bench"])
    phase("the kernels line")
    paged_src = "mpi_tensorflow_torch/ops/csrc/paged_attention.cu"
    paged_replaces = "mpi_tensorflow_tpu/ops/paged_attention_kernel.py:90"
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": paged_src,
        "replaces": paged_replaces,
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "max_abs_err_fp32": worst[torch.float32],
        "max_abs_err_bf16": worst[torch.bfloat16],
        # phase 15: each feature's timed run, counted from 0 (15d
        # draft-model: the target's and the draft model's launches)
        "launches_features": features["launches"],
        # phase 16: the 2-replica fleet's timed runs (summed over the
        # replicas) and rank 0 of the tensor-parallel engines
        "launches_fleet": fleet["launches_fleet"],
        "launches_tp": fleet["launches_tp"],
        # phase 17: each A/B arm's check runs, counted from 0 (2 fp32
        # layers), the paged engine beside generate, and rank 0 of the
        # tensor-parallel fleet
        "launches_arms": arms["launches_arms"],
        # phase 3b: the A/B arms' timed runs at full width (BERT_BASE
        # bf16, phase 3's trace), each arm counted from 0
        "launches_arms_full_width": {
            "kernel_ab": quant["kernel_ab"]["launches"],
            "kv_ab": quant["kv_ab"]["launches"]},
        "launches_decode_check": arms["decode"]["launches"],
        "launches_tp_fleet": arms["launches_tp_fleet"],
        # phase 20e: the admission and drain replays, each from 0
        "launches_admission": {k: v["launches"]
                               for k, v in admission.items()},
        **timing,
    }]
    for kv_dtype, modes, timed in (("int8", ("int8",), "int8"),
                                   ("int4", ("int4", "int4_res"),
                                    "int4_res")):
        errs = {dt: max(quant_worst[m, dt] for m in modes)
                for dt in (torch.float32, torch.bfloat16)}
        kernels.append({
            "name": f"paged_attention_{kv_dtype}", "route": "cuda",
            "source": paged_src, "replaces": paged_replaces,
            "mode": "+".join(modes), "launches": quant_launches[kv_dtype],
            "max_abs_err": max(errs.values()),
            "max_abs_err_fp32": errs[torch.float32],
            "max_abs_err_bf16": errs[torch.bfloat16],
            **quant_timing[timed]})
    for name in FLASH:
        t = flash_timing[name]
        flash_worst[name, torch.bfloat16] = max(
            flash_worst[name, torch.bfloat16],
            *(t[c]["max_abs_err_train_shape"] for c in (False, True)))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mpi_tensorflow_torch/ops/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": flash_launches[name],
            # phase 12a: the data-parallel trainer, plain and at
            # grad_accum 2, each counted from 0
            "launches_dp": bert_dp["1"]["launches"][name],
            "launches_dp_accum2": bert_dp["2"]["launches"][name],
            # phase 14c: the resumed BERT run, counted from 0
            "launches_resumed": long_run["14c"]["launches_resumed"][name],
            # phase 18: gpt_base, the causal mode, counted from 0
            "launches_gpt_causal": gpt_train["launches"][name],
            # phase 19, each run counted from 0: the MoE (19c), the
            # enc-dec family with remat (19d: its encoder's and decoder's
            # layers, each forward twice a step), config 5 with remat
            # (19e) and with LAMB (19f)
            "launches_moe": rest["moe"][0][name],
            "launches_encdec": rest["encdec"][0][name],
            "launches_remat": {p: rest[f"remat_{p}"][0][name]
                               for p in REMAT_POLICIES},
            "launches_lamb": rest["lamb"][0][name],
            # phase 21a: each graphed transformer run (the capture's
            # warm-up window and one replay of K steps), from 0
            "launches_graphed": {k: v[name]
                                 for k, v in scan["launches"].items()},
            # phase 20c-d, the bench lines (13e's child), each from 0:
            # config 5 with each lever, and BERT_BASE at S = 1024 with
            # --flash-min-seq 0 (the default line takes dense: 0)
            "launches_levers": {
                k: v["flash_launches"][name]
                for k, v in vit_levers["levers"].items()},
            "launches_crossover": {
                arm: vit_levers["crossover"][arm]["flash_launches"][name]
                for arm in ("dense", "flash")},
            # phase 22, rank 0 of each world, each case from 0: 22a (2
            # fp32 layers, 3 steps) and 22b (config 5, 3 steps + 1
            # eval); the ring cases launch none (no hand kernel lies on
            # the ring)
            "launches_tp_sp": {
                **{f"22a {c}": n[name] for w in ("two", "four")
                   for c, n in tpsp[w]["launches"].items()},
                **{f"22b {c}": int(tpsp["config5"]["per_rank"][0][i][
                    1 + FLASH.index(name)])
                   for i, (c, _, _) in enumerate(TPSP5)}},
            "max_abs_err": max(flash_worst[name, torch.float32],
                               flash_worst[name, torch.bfloat16]),
            "max_abs_err_fp32": flash_worst[name, torch.float32],
            "max_abs_err_bf16": flash_worst[name, torch.bfloat16],
            # phase 7's path is not causal; phase 18's is, at the
            # numbers of the causal block
            **t[False],
            "causal": t[True]})
    for name in FUSED_REPLACES:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mpi_tensorflow_torch/ops/csrc/fused.cu",
            "replaces": FUSED_REPLACES[name], "on_path": False,
            "launches": fused_launches[name],
            "max_abs_err": max(fused_worst[name, torch.float32],
                               fused_worst[name, torch.bfloat16]),
            "max_abs_err_fp32": fused_worst[name, torch.float32],
            "max_abs_err_bf16": fused_worst[name, torch.bfloat16],
            **fused_timing[name]})
    for k in kernels:           # phase 13c: the ResNet runs, counted from 0
        key = "paged_attention" if k["name"].startswith("paged") \
            else k["name"]
        k["launches_resnet"] = resnet_launches[key]
        # phase 20a-b: the ViT's checks and trainer run, from 0
        k["launches_vit"] = vit_levers["launches"][key]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:     # a rank of phase 11 or 12
        WORKERS[sys.argv[2]](sys.argv[3])
        sys.exit(0)
    sys.exit(main())
