#!/usr/bin/env python3
"""Run the port's live-market selection path, its LM serving path and its
LM training path on one CUDA card and check them.

    python3 chip_smoke.py [--seed N]

Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, one
   process per source, all started together (``-Xptxas -v`` registers,
   shared memory and spills printed, and each source's build time; the
   tensor-core forward and backward, bf16 and fp32 on three bf16 pieces,
   must not spill), and read the tensor-core backward's passes with
   ``cuobjdump -sass``: each must issue wgmma (``HGMMA``) at every head
   size and operand dtype it is built for;
2. hold every ``rank_delta`` kernel against its plain PyTorch version on
   the card: the tick's price ``scatter`` (bitwise, C = 1 to 100,000, n =
   0 to C, each case scattered twice back to back); ``rowmin`` and the
   one-block-a-row ``rowmin_row`` it replaced, bitwise, at C = 1 to
   10,001 around its 4,096-column chunk (``ROWMIN_EDGES``) and 100 times
   in a row on one scratch; ragged shapes, fully masked rows, a member
   with fewer profiled configs than k, an identity tick (bitwise), 1%
   and 30% changed columns, the fold twice on the same inputs (bitwise) and
   against the column-per-thread ``fold_col`` it replaced, the
   two-stage ``select`` at its cap (256), ``select_sort`` one past it
   and at k = C on one row, the k-round ``select_rounds`` (the
   yardstick) past its old cap, and the fleet's own shapes — then time
   each kernel, its plain version, the kernel it replaced
   (``rowmin_row``, ``fold_col``, ``select_rounds``) and, where one
   exists, the one PyTorch call that computes the same thing; and
   ``scatter`` at 10,000 and 100,000 columns and a 1% tick beside its
   plain version, the PyTorch scatter;
3. run :class:`TorchFusedRankState` at 64 jobs x 10,000 configs x 16
   members for 100 ticks (1% of prices per tick) and at 64 x 100,000 for
   10 (cut from 20 to leave room for the LM phases), holding every member
   against the float64 ``rank_dense`` under the score contract, the fused
   heads against ``ranking()[:10]``, a tick bit for bit against the
   dense path it replaced (the whole (1, C) price and changed vectors
   built on the host and uploaded), and timing the tick and its host
   step through both paths in turns;
3b. the sharded fleet (``torch_sharded``) with every shard on the one
   card: a 1% tick at 64 x 100,000 x 16 and at 64 x 100,003 split by
   columns 2, 3 and 4 ways (``row_minima`` a block, the min across
   blocks, ``fold_scores`` a block), bitwise against one
   ``fused_reprice``; :class:`TorchShardedRankState` at 1, 2 and 4 shards
   beside a :class:`TorchFusedRankState` for 10 ticks of 1% at 64 x
   100,000 x 16 — the same handoff counts, scores within the contract,
   the 10-heads naming the fused fleet's configs, one ``scatter``,
   ``rowmin`` and ``fold`` a shard a tick and one ``select`` a shard a
   ``heads`` call, every member within the contract of ``rank_dense``'s
   float64 scores on two ticks, the 1,000-head ``ranking()[:1000]`` —
   the tick timed in turns with the fused fleet's (host clock) with the
   combine's share (where the machine has several cards, a fleet with one
   shard a card joins every check and the turns); then phase 4's
   service and daemon on ``torch_sharded`` at 2 shards (1,000 events,
   audit-clean) read through the launch counters, and the kernels held
   against their plain versions on a shard of its fleet;
4. serve a ``SelectionService(backend="torch_fused")`` over a 64 x 10,000
   store through a ``SelectionDaemon`` for 1,000 events and audit its
   journal with ``JournalReplayer`` — the selection path, read through
   the kernels' launch counters: one ``scatter``, one ``rowmin`` and one
   ``fold`` a tick, ``select`` for the k-heads, no ``rowmin_row``,
   ``select_sort``, ``fold_col`` or ``select_rounds`` — then hold each
   kernel against its plain version at the shapes that path gave it and
   time it there, and time the k-head at k = 65 to 10,000 on one member
   row and at k = 1,000 on the 64 x 100,000 fleet's 16 rows
   (``HEAD_SHAPES``) beside ``torch.topk`` and, up to k = 1,000 on one
   row, the k-round kernel; and the kernels' device guard: its host cost
   around a no-op beside ``torch.cuda.device``'s, and ``select`` on the
   member row in turns with the guard and without it;
5. serve phase 4's store and catalog through the front-end
   (``ServeFrontend``, ``torch_fused``, ``serve_top_k=10``) at 1 and 4
   workers and through the daemon, on one recorded 100-tick market (1% of
   prices a tick) and 1,000 submissions, each decision followed by a
   1 ms modelled client reply: zero shed, every submission journaled,
   ``shutdown`` raising nothing, each merged journal audit-clean, one
   ``scatter``, ``rowmin`` and ``fold`` a fleet tick and at most one
   ``select`` a published snapshot plus one a forwarded submission (never
   one a route), read through the launch counters around each
   front-end run.  Submissions/s of all three, the speed-up and scaling
   efficiency beside the reference benchmark's claims (recorded, not
   gated), and the snapshot build's heads in turns: one ``select`` for
   every route against one a route;
6. the reference turbulence benchmark's universe (the paper's trace at
   seed 0, 18 jobs x 10 configs), 400 events: the calm preset regenerates
   ``examples/data/gcp_spot_prices.csv`` byte for byte, the calm fixture's
   mean deviation stays <= 0.0645 on numpy, on ``torch_fused`` and on
   ``torch_sharded`` at 2 shards (there equal to numpy's), every preset's
   point on the three backends audits clean (``scatter``, ``rowmin`` and
   ``fold`` once a fleet tick, once a shard on ``torch_sharded``, at
   C = 10), a stubbed
   ``PollingPriceFeed`` evaluates as the recorded feed on ``torch_fused``,
   and the quickstart's picks through the port's Flora (class A -> #9,
   class B -> #1, Flora the best row of Table IV);
7. hold the flash-attention kernels and the WKV6 kernel against their
   plain versions: the tensor-core kernel (bf16) and the split one (fp32
   on three bf16 pieces); causal, windowed and bidirectional (also held
   to a relative L2 limit, ``ATTN_REL_L2``); GQA and MQA; ragged T;
   head sizes 16 to 256, with D = 80 (a 64-column block and a 16-column
   tail) also at stablelm-3b's prefill shape, GQA, T = 1, 100, 129 and a
   windowed T = 1,000, and D = 256 (its own block shape) at
   recurrentgemma-9b's prefill shape (MQA), its 4,096-token prompt past
   the 2,048 window, GQA, T = 1, 100, 129 and a windowed T = 1,000, and
   bidirectional calls with Tq != Tk at seamless-m4t-large-v2's encoder
   (4 x 4,096 over 4,096), cross prefill (1,024 over 4,096) and cross
   decode (1 over 4,096) shapes, a ragged source (7 over 1,000), Tk < Tq
   (100 over 37), one token at D = 256 and 129 over 300 at D = 80, and
   D = 160 (the 64-row block, two 64-column blocks and a 32-column tail)
   at pixtral-12b's prefill shape (4 x 2,048, 32 over 8), GQA, T = 1,
   65, 100, a windowed T = 1,000 and 129 over 300 bidirectional; for
   WKV6 a decode step,
   ragged T, one step past the split kernel's chunk, RWKV-6's strong
   decays (w = exp(-exp(x)), x in [-8, 2]) and a two-call state carry;
8. the dry run (``[dryrun]`` lines): the port's CLI
   (``python -m repro_torch.launch.dryrun``) writes the report of
   qwen3-1.7b, stablelm-3b and rwkv6-3b x ``train_4k`` and ``decode_32k``
   x the four splits of ``mesh_options(256)``, one process a split, all
   started together and with the card hidden, and a fifth counts the
   card's own training step (qwen3-1.7b at full width and depth, 4 x
   1,024 tokens, AdamW, remat, the same vocabulary chunks) on a (1, 1)
   mesh; beside them, one process a split, qwen3-moe-30b-a3b's
   ``train_4k`` and ``decode_32k`` cells (expert parallelism; ``[dryrun]
   moe`` lines, not in the report); the decode fleet's mesh is planned through the port's selection
   service from that report, on ``torch_fused`` and ``numpy`` (the same
   decision), with every cell's dominant term logged; the training
   launcher (``--auto-mesh --report``) prints its ``[flora]`` line and
   trains a reduced model 2 steps; after phase 9b the card cell's count
   is held within 1% of ``FlopCounterMode`` around one real training
   step (the kernels counted through their counting forms), at least
   ``train_flops``, and its roofline step at most the measured step;
9. serve ``qwen3-1.7b``, ``stablelm-3b``, ``rwkv6-3b``, ``deepseek-7b``,
   ``granite-20b``, ``qwen3-moe-30b-a3b``, ``recurrentgemma-9b``,
   ``seamless-m4t-large-v2`` and ``pixtral-12b`` at full width and depth
   (random bf16 weights, and for seamless random bf16 source frames, for
   pixtral random bf16 patch embeddings, from the seed; each model freed
   before the next is drawn): 8 requests of 1,024-token prompts over 4
   slots, 32 new tokens each, seamless's each with 4,096 source frames,
   pixtral's each after 1,024 patches — the LM path, read through the
   kernels' launch counters (28, 32, 30, 52, 48, 12 and 40
   flash-attention launches per prefill, one an attention layer, every
   one the tensor-core kernel, also counted by (Tq, Tk, causal): pixtral's
   causal over 2,048 positions;
   for seamless 72 a prefill, 24 bidirectional over the frames, 24
   causal and 24 cross, and 24 a decode step, cross decode, counted by
   (Tq, Tk, causal) too; 32 WKV6 launches per prefill and per decode
   step) — after a warm-up at the traffic's shapes, and once more for
   the spread.  Then: all logits finite; the first wave's prefill
   logits against a pass whose kernel is swapped for its plain version
   (for the MoE model also the share of (token, k) routes the two passes
   agree on, layer by layer); for attention, the first wave's prefill
   timed in turns with the tensor-core kernel and with the scalar one it
   replaced; prefill + decode against ``forward`` at full width, 4
   layers, fp32 (every attention launch the split kernel; MoE at capacity factor
   64; recurrentgemma-9b's rec, rec, attn, rec with a 2,100-token
   prompt and 8 steps past its window; seamless at 2 encoder and 2
   decoder layers, 100 source frames, a 6-token prompt and 8 steps;
   pixtral with 100 patches ahead of a 6-token prompt, decoding at 100 +
   t); for recurrentgemma-9b a 1 x
   4,096-token prefill past its window and 8 decode steps, through the
   kernel and the plain version (``[window]``); and the kernels at the shapes the path gave them, against their
   plain versions and timed beside their bounds, the kernel they
   replaced (the scalar attention kernel, bf16; the sequential WKV6
   kernel) and, for attention, ``scaled_dot_product_attention``, and
   at qwen3-1.7b's, recurrentgemma-9b's and pixtral-12b's shapes in fp32
   the split kernel beside the scalar one, both held against the plain
   version and logged by their distance from a float64 run; for
   WKV6 also the decode step back to back and from a CUDA graph.  Then
   ``llama4-maverick-400b-a17b`` at full width over 2 layers (one dense,
   one MoE; the whole model does not fit one card): a 2 x 1,024-token
   prefill through the kernel and the plain version (relative L2 < 0.1,
   finite, one tensor-core launch a layer, the routes' agreement), 4
   decode steps, finite, and the kernel at its prefill shape;
9b. train (before the profiled phases): the attention backward
   (``flash_attention_bwd.cu``) against ``attention_bwd_ref`` at every
   head size in bf16 and fp32 (``BWD_CASES``: causal, a window,
   bidirectional with Tq != Tk and fully masked rows, GQA R = 1, 2, 4,
   48, ragged T, Tq = 1; each of dq, dk, dv within relative L2 1e-5 in
   fp32 and 1e-2 in bf16): the variant ``bwd_variant`` names (the
   tensor-core kernel for bf16 at every head size, the split one for fp32
   at every head size, column pairs at D = 160 and 256, each of whose
   second calls must give the same bits) and the scalar yardstick too;
   with a planted fault (the last 64 keys' contribution dropped) that the
   check must refuse; held the same way at the path's shapes
   (seamless-m4t-large-v2's three in bf16 and fp32, qwen3-1.7b's in fp32,
   pixtral-12b's and recurrentgemma-9b's and a 4,096-position one where
   the 2,048 window binds in bf16 and fp32, each a second call bitwise
   and the kernel with the planted fault refused, and in bf16 where each
   is timed, ``BWD_TIMED``: the tensor-core kernel beside the scalar
   yardstick, the plain version, SDPA's backward and its bound; in fp32
   at qwen3-1.7b's, pixtral-12b's and recurrentgemma-9b's shapes,
   ``FP32_BWD_TIMED``, the split kernel beside the scalar one, SDPA's
   fp32 backward and both bounds, each kernel's distance from a float64
   run logged beside the plain version's); qwen3-1.7b at full width and depth for 10 steps of
   4 x 1,024 tokens through ``make_train_step`` and ``train_loop``
   (AdamW, the reference's ``TrainConfig`` defaults, remat, vocab chunks
   of 16,384; batches from the port's ``TokenStream``): finite losses,
   the last below the first, 56 forward and 28 backward launches every
   step, all 28 on the tensor cores (none in the serving phases), step
   time, tokens/s, TFLOP/s, peak
   memory and the backward's share of a step; a checkpoint after step 5
   restored into a new model and optimizer, whose steps 6 and 7 equal
   the uninterrupted run within relative 1e-5; one step's gradients with
   the kernels against plain attention, bf16 over all 28 layers within
   relative L2 0.1 over the whole gradient and 0.05 on each leaf, and
   with the planted fault in the last layer, which the leaf limit must
   refuse; fp32 over 4 layers within 1e-3 and 1e-4 (the split backward,
   one launch a layer, the scalar one none); seamless-m4t-large-v2
   at 2 + 2 layers, full width, one bf16 step over 2 x 4,096 frames and
   2 x 512 tokens (the backward bidirectional, causal and in cross mode,
   counted by shape), its gradients held the same way; then rwkv6-3b:
   WKV6's forward with its checkpoints against ``wkv6_fwd_ref`` and its
   backward (``wkv6_bwd`` in ``wkv6_scan.cu``) against ``wkv6_bwd_ref``
   over ``WKV_BWD_CASES`` and the training shape (4 x 1,024, 40 heads,
   N = 64), strong decays, nonzero s0 and dsT, bf16 and fp32 (each of
   dr, dk, dv, dw, du and ds0 within relative L2 1e-5 in fp32 and 1e-2 in
   bf16), a second call bitwise, and a planted fault (dS not carried
   across the middle chunk boundary) that the check must refuse; the
   backward timed beside the forward with and without its checkpoints,
   the plain version and the bound; rwkv6-3b at full width and depth
   for 8 steps of 4 x 1,024 tokens as qwen3's (finite losses, the last
   below the first, 64 forward and 32 backward WKV6 launches every step
   and no attention launch, step time, tokens/s, peak memory, the
   backward's share of a step); a full-depth bf16 step whose every WKV6
   backward launch is held against the plain version on its own inputs
   (``BWD_LIMIT``), and again with the planted fault (dS carried across
   no chunk boundary) in the last layer's, which must fail it; one
   step's gradients with the kernels against plain WKV6 (autograd of
   ``wkv6_scan_ref``'s loop) at ``RWKV_GRAD_LAYERS`` (deeper, two plain
   versions differ by more than the limits): bf16 over 2 layers within
   0.1 and 0.05 a leaf, with the planted fault in the last layer, which
   the limits must refuse, and fp32 over 1 layer within 1e-3 and 1e-4
   (one backward launch); then recurrentgemma-9b at 9 layers (three
   cycles of rec, rec, attn) and pixtral-12b at 8, full width (one card
   holds neither at full depth with AdamW), 6 steps each of 4 x 1,024
   tokens (pixtral's each after 1,024 random patch embeddings labelled
   -1) as qwen3's: finite losses that fall, 6 and 16 forward and 3 and 8
   backward launches a step, every backward on the tensor cores (D = 256
   and 160), step time, positions/s, peak memory and the backward's
   share; every attention backward launch of a step held against the
   plain version on its own inputs; one step's gradients against plain
   attention at one cycle and at 2 layers, with the planted fault in the
   last attention layer, which the limits must refuse, in bf16 and in
   fp32 (within 1e-3 and 1e-4 a leaf, the split backward launched once
   an attention layer, 1 and 2, the scalar one never); then
   qwen3-moe-30b-a3b at 8 of 48 layers, full width (one card cannot hold
   its 30.5 B parameters' training state), Adafactor at its peak rate
   from the first step, 4 steps of 4 x 1,024 tokens: finite losses that
   fall, 16 forward and 8 backward launches a step, all on the tensor
   cores, none scalar; every attention backward launch of a bf16 step
   held against the plain version on its own inputs; one step's
   gradients against plain attention at 2 layers, in bf16 with the
   routes pinned to the kernels' pass's (within 0.1 and 0.05 a leaf) and
   in fp32 with the routes free (within 1e-3 and 1e-4, 2 split launches);
9c. sharded training (after phase 9b): an NCCL group of one rank, a 1 x 1
   (data, model) mesh, and qwen3-1.7b at full width and depth trained 3
   steps of 4 x 1,024 tokens as DTensors through the sharded step (its
   weights drawn leaf by leaf and placed, ``sharding.place.init_placed``;
   its batches from ``PrefetchIterator(shardings=)``; the step inside
   ``ctx.use(rules, mesh)``), held against phase 9b's first 3 steps from
   the same seed: each loss and weight leaf within relative 1e-5 (bitwise
   recorded), 56 tensor-core forward and 28 tensor-core backward
   attention launches a step, none scalar; the group is destroyed after.
   Where the machine has 2 or more cards, one process a card
   (``--mesh-rank``, NCCL; any rank that fails fails the run):
   qwen3-1.7b at 2 x 2 and 4 x 1 (2 x 1 on two cards), its first step
   against the one-card step (loss within relative 1e-2, gradients within
   the bf16 limits), each rank's parameter bytes ``bytes_per_device``,
   and at 2 x 2 again with the head over vocabulary chunks of 16,384
   split over the model axis, held to the one-card step and to the
   plain-head run;
   the int8 compressed all-reduce over NCCL (``compressed_psum`` and a
   step with ``make_compressed_allreduce``, within n scale / 2); a save on
   the first mesh restored on the second (qwen3-1.7b at full width, 2
   layers, float32: steps 3 and 4 within relative 1e-5 of the run that
   saved); recurrentgemma-9b (38 layers) and pixtral-12b (40, after 1,024
   patches) at full width and depth on the (cards) x 1 mesh, 4 steps:
   finite losses that fall, every rank's peak under 75 GiB, every
   attention backward on the tensor cores; qwen3-moe-30b-a3b at full
   width and depth (48 layers, 128 experts split over the model axis) on
   2 x 2 and 1 x 4, Adafactor, 4 steps, as those two, and at 1 x 4 again
   with the chunked head, held to the plain-head run's first loss and
   gradients and to the one-card model's first loss (its weights fill a
   card; no gradient); qwen3-moe-30b-a3b
   at 2 fp32 layers on 2 x 2 against the one-card fp32 step (loss within
   relative 1e-5, gradients within 1e-3 and 1e-4 a leaf, every backward
   the split kernel); seamless-m4t-large-v2 at full depth (24 + 24,
   4,096 source frames a sequence) on 2 x 2, 4 steps, against the
   one-card step within the bf16 limits, 72 tensor-core backward
   launches a step; step ms, positions/s, every rank's peak GiB and the
   collectives' share of a profiled step (``[mesh]`` lines);
9d. the head over a split vocabulary:
   qwen3-1.7b's head at full width (4 x 1,024 tokens, d 2,048, V
   151,936, chunks of 16,384), random weights in fp32 and bf16, through
   the plain head, the one-process chunked head and the split path's
   local pass and combine over 2 and over 4 slices of the table (as the
   ranks of a model axis run it): (lse, ll) and the gradients of the
   hidden states and the table within relative L2 1e-5 in fp32 and 1e-2
   in bf16 of the other two heads, labels on every slice's and chunk's
   edge; each head's peak memory over forward and backward (``[head]``
   lines);
10. last, the profiled phases: a second 1,000-event daemon on phase 4's
    service under ``torch.profiler`` (the card's busy share), then each
    served model's first-wave prefill and 8 decode steps (device time by
    kernel, busy share), and for recurrentgemma-9b the RG-LRU scan's and
    its fp32 gate products' share of a prefill wave; then one qwen3-1.7b
    training step (device time by kernel and by group: the backward
    kernel, the forward attention kernel, matrix products, the rest) and
    its AdamW update alone, and the same for rwkv6-3b (the backward
    kernel there WKV6's), recurrentgemma-9b at 9 layers and pixtral-12b
    at 8; then the tensor-core backward's and SDPA's
    backward's device time a call at each timed shape, and the backend
    that serves SDPA's fp32 yardstick, from the kernels' names.

Every phase runs on every call.  Every check that fails exits non-zero.
The last three lines are the ``{"kernels": [...]}`` record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  In the
record, ``earlier_ms`` is the time, on the same inputs in the same run,
of the kernel the entry's function ran on before this kernel (the
one-block-a-row ``rowmin``, the k-round ``select``, the column-per-thread
fold, the scalar attention kernel in bf16, the sequential WKV6 kernel);
null where the kernel is the one that was there.  The k-head, ``rowmin``
and ``fold`` entries add ``device_ms`` (and the k-heads
``library_device_ms``): the same calls replayed from a CUDA graph, the
card's time without the host's (``earlier_device_ms`` the earlier
kernel's).  The ``scatter``, ``rowmin``, ``fold`` and ``select`` entries add
``frontend_launches`` (phase 5's 4-worker front-end run),
``turbulence_launches`` (phase 6's sweep, its ``torch_sharded`` fleets'
shards included) and ``sharded_launches`` (phase 3b's 2-shard service).
``rank_delta_scatter`` is the price scatter at the service's C = 10,000
(``rank_delta_scatter_100000`` at 100,000), a 1% tick;
``rank_delta_rowmin_64x*`` and ``rank_delta_fold_64x*`` are
``rowmin`` and the fold at 16 members on the two fleet shapes;
``rank_delta_khead_<rows>x<columns>_k<k>`` the k-head at each timed
shape, with the ``kernel`` that k takes.
``wkv6`` adds the decode step's times (``decode_ms`` back to back,
``decode_graph_ms`` from a CUDA graph, ``decode_earlier_ms`` and
``decode_earlier_graph_ms`` the sequential kernel) and its bound.
``flash_attention`` (qwen3-1.7b, D = 128), ``flash_attention_d80``
(stablelm-3b, D = 80), ``flash_attention_mha128`` (deepseek-7b),
``flash_attention_mqa`` (granite-20b), ``flash_attention_d64``
(qwen3-moe-30b-a3b), ``flash_attention_d256`` (recurrentgemma-9b) and
``flash_attention_d160`` (pixtral-12b, D = 160, 2,048 positions a
sequence) add ``wave_ms`` and ``wave_earlier_ms``: the first wave's
prefill with the tensor-core kernel and with the scalar one.
``flash_attention_split``, ``flash_attention_split_d256`` and
``flash_attention_split_d160`` are the split kernel (fp32 on three bf16
pieces) at qwen3-1.7b's, recurrentgemma-9b's and pixtral-12b's shapes,
their launches those models' fp32 4-layer checks', their
``earlier_ms`` the scalar kernel's; ``flash_attention_scalar``,
``flash_attention_scalar_d256`` and ``flash_attention_scalar_d160`` the
scalar kernel in fp32 at the same shapes, by name (no launch on a path).
These six add ``ffma_bound_ms`` (``bound_ms`` is six bf16 products a
product at the bf16 peak, this the scalar FFMAs' at the fp32 peak),
``rel_l2_float64`` and ``plain_rel_l2_float64`` (the kernel's and the
plain version's distance from a float64 run) and ``library_backend``
(the backend that served SDPA's fp32 call).
``flash_attention_enc``, ``flash_attention_dec``, ``flash_attention_cross``
and ``flash_attention_xdec`` are the tensor-core kernel at
seamless-m4t-large-v2's encoder (bidirectional, 4 x 4,096 over 4,096),
decoder self-attention (causal, 4 x 1,024), cross prefill (1,024 over
4,096) and cross decode (1 over 4,096) shapes, each with its own
launches on the path (``library_ms`` SDPA with ``is_causal`` as the
call's); ``flash_attention_enc`` adds the first wave's ``wave_ms``.
``flash_attention_llama4`` is the kernel at the llama4 check's shape,
its launches that check's one prefill.  ``flash_attention_bwd`` is the
tensor-core attention backward at qwen3-1.7b's training shape (bf16, 4
x 1,024, 16 heads over 8, D = 128, causal), its launches the 10-step
run's, its ``earlier_ms`` the scalar backward's, its ``library_ms``
SDPA's backward alone; it adds the run's median ``step_ms`` and the
kernel's ``step_share``.  ``flash_attention_bwd_enc``, ``_dec`` and
``_cross`` are the same kernel at seamless-m4t-large-v2's training
shapes (bidirectional 2 x 4,096 over 4,096, causal 2 x 512, 512 over
4,096; D = 64), their launches its one step's.
``flash_attention_bwd_d64`` is the same kernel at qwen3-moe-30b-a3b's
training shape (4 x 1,024, 32 heads over 4, D = 64, causal), its
launches phase 9b's 4 MoE steps, with their ``step_ms`` and the
kernel's ``step_share``; ``flash_attention_d64`` adds
``train_launches``, the same steps' forward launches (its serving
prefill shape is this training shape).
``flash_attention_bwd_d160`` and ``_d256`` are the same kernel at
pixtral-12b's (4 x 2,048, 32 heads over 8, D = 160, causal) and
recurrentgemma-9b's (4 x 1,024, 16 heads on one, D = 256, causal, window
2,048) training shapes, their launches the cut-depth runs' 6 steps,
their ``earlier_ms`` the scalar backward's; they add the run's
``step_ms``, the kernel's ``step_share``, and the profiled step's busy
share ``step_busy`` and the backward's share of its device time
``step_backward_share``.  These seven add ``device_ms`` and
``library_device_ms``: the kernel's and SDPA's backward's device time a
call from the profiler, without the host's, and ``device_pass_ms``, the
kernel's by pass ({kernel: ms}).
``flash_attention_bwd_scalar`` is the scalar backward, the yardstick, at
qwen3-1.7b's shape in bf16; ``flash_attention_bwd_split_fp32`` the split
backward at that shape in fp32, its launches the fp32 gradient check's,
its ``earlier_ms`` the scalar backward's, ``library_ms`` SDPA's fp32
backward; ``flash_attention_bwd_scalar_fp32`` the scalar backward there
by name (no launch on a path); ``flash_attention_bwd_split_fp32_d160``
and ``_d256`` the split backward (column pairs) at pixtral-12b's and
recurrentgemma-9b's training shapes, their launches the cut models' fp32
gradient checks' (2 and 1), and ``flash_attention_bwd_scalar_fp32_d160``
and ``_d256`` the scalar backward there by name; these six add the keys
of the fp32 forward entries.
``flash_attention`` and ``flash_attention_bwd`` add ``mesh_launches``:
the tensor-core forward's and backward's launches in phase 9c's steps on
the one-card mesh.
``wkv6_bwd`` is WKV6's backward at rwkv6-3b's training shape (bf16 r,
k, v; 4 x 1,024, 40 heads, N = 64; no dsT, no ds0), its launches the
8-step run's, ``library_ms`` null (no one PyTorch call computes it); it
adds ``forward_ckpt_ms`` and ``forward_ms`` (the split kernel with and
without the checkpoints the backward reads), the run's median
``step_ms`` and the kernel's ``step_share``.
Without a CUDA device the script exits non-zero before printing any
result.  Some functions are not run by it, each called alone on the
card: ``rwkv_grad_witness`` (rwkv6-3b's gradients by depth against a
float64 run) and ``tree_turns`` (the training steps and serving decode
of qwen3-1.7b and rwkv6-3b, ``train_steps`` and ``serve_steps``, for the
package of this tree and another in turns, a process a turn).  It
imports ``torch``, ``numpy``, the standard library and the port
(``src/repro_torch``), nothing else.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet) for the bounds: the dry
#: run's roofline reads the same numbers
from repro_torch.launch.roofline import (  # noqa: E402
    FP32_FLOPS as FP32_FLOPS_PER_S, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S)
REL_TOL, ABS_TOL = 1e-4, 1e-6
SOURCE = "src/repro_torch/csrc/rank_delta.cu"
#: what each CUDA kernel replaces on the main path: the reference's host
#: densify of a tick's prices (``_dense_tick``, numpy, no Pallas kernel)
#: for ``scatter``; the fused Pallas body (``_make_kernel``) for ``rowmin``
#: and ``fold``; for ``select``, the
#: ``jax.lax.top_k`` that the reference fleet's ``top_k`` serves from
#: (the service calls ``top_k``, never ``reprice_with_heads``)
REPLACES = {"scatter": "src/repro/selector/pallas_rank.py:248",
            "scatter_pageable": "src/repro/selector/pallas_rank.py:248",
            "rowmin": "src/repro/kernels/rank_delta.py:69",
            "rowmin_row": "src/repro/kernels/rank_delta.py:69",
            "fold": "src/repro/kernels/rank_delta.py:69",
            "fold_col": "src/repro/kernels/rank_delta.py:69",
            "select": "src/repro/selector/rank.py:1218",
            "select_sort": "src/repro/selector/rank.py:1218",
            "select_rounds": "src/repro/selector/rank.py:1218"}
#: the k-heads also port the Pallas kernel's in-kernel top-k tail, which
#: only ``fused_reprice_heads`` runs (phases 2 and 3, not the service)
ALSO_REPLACES = {"select": "src/repro/kernels/rank_delta.py:157",
                 "select_sort": "src/repro/kernels/rank_delta.py:157",
                 "select_rounds": "src/repro/kernels/rank_delta.py:157"}
KERNELS = ("scatter", "scatter_pageable", "rowmin", "rowmin_row", "fold",
           "fold_col", "select", "select_sort", "select_rounds")
#: the kernels the selection path launches (its k is 10: ``select_sort``
#: serves only k above ``rank_delta.SELECT_CAP``)
PATH_KERNELS = ("scatter", "rowmin", "fold", "select")
#: the k-head's timed (rows, columns, k): one member row of the service's
#: 64 x 10,000 fleet and the 64 x 100,000 fleet's 16 member rows
HEAD_SHAPES = ((1, 10_000, 65), (1, 10_000, 256), (1, 10_000, 257),
               (1, 10_000, 1_000), (1, 10_000, 10_000), (16, 100_000, 1_000))
#: the largest k at which the k-round kernel is timed beside a k-head
ROUNDS_MAX_K = 1_000
SOURCES = ("rank_delta", "flash_attention", "flash_attention_bwd",
           "wkv6_scan")
#: rowmin's edge shapes (J, C): one column, C not a multiple of 4 (scalar
#: loads), one short of, at and one past 2,048 and 4,096 columns (the
#: kernel's chunk, ``rank_delta.ROWMIN_CHUNK``), the fleet's C (vector
#: loads) and one past it (scalar loads)
ROWMIN_EDGES = tuple((J, C) for J in (1, 64)
                     for C in (1, 3, 2_047, 2_048, 2_049, 4_095, 4_096,
                               4_097, 10_000, 10_001))


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up; inputs stay resident in L2 as on the tick
    path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of ``fn`` per call with the host out of the way:
    ``calls`` calls captured in one CUDA graph, replayed.  Where a call's
    host work outlasts its kernels, ``time_ms`` reads the host and this
    reads the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream, where rowmin's scratch already exists
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * calls)


# --- phase 1 --------------------------------------------------------------------

def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()

    def timed(name):
        t = time.perf_counter()
        lib, out = _build.build(name)
        return lib, out, time.perf_counter() - t

    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        built = dict(zip(SOURCES, pool.map(timed, SOURCES)))
    log(f"[build] nvcc {', '.join(s + '.cu' for s in SOURCES)} in "
        f"parallel: {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR} ("
        + ", ".join(f"{s}.cu {built[s][2]:.2f} s" for s in SOURCES) + ")")
    for name in SOURCES:
        for line in built[name][1].splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling entry" in line
                                         or "smem" in line) \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    fwd_spills(built["flash_attention"][1])
    bwd_spills(built["flash_attention_bwd"][1])
    sass_wgmma(built["flash_attention_bwd"][0])
    log(f"[build] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "float32 matmuls must not run in TF32")


#: the tensor-core backward's passes, each of which must run wgmma (the
#: names match their two-warpgroup forms, bwd_dq_tc2 and bwd_dkdv_tc2,
#: and their fp32 instantiations on three bf16 pieces too)
BWD_TC_PASSES = ("bwd_stats_tc", "bwd_dq_tc", "bwd_dkdv_tc")
#: the tensor-core forward, bf16 and fp32 (three pieces), which may not
#: spill either
FWD_TC_KERNELS = ("flash_fwd_sm90",)


def ptxas_spills(out) -> dict:
    """The functions that spill in ``-Xptxas -v`` output: {name: (bytes
    of spill stores, bytes of spill loads)}, each spill line read against
    the "Compiling entry function" or "Function properties for" line
    before it.  ``name`` is short where it is an attention kernel
    (``bwd_dq<bf16, 32>``, ``bwd_dkdv_tc2<256>``, ``bwd_dq_tc<128, 3>``,
    ``flash_fwd_sm90<256, 3>`` and ``bwd_dkdv_tc<256, 3, 2>``: head size,
    operand pieces and the blocks a column pair takes), else ptxas's
    own."""
    import re
    spills, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'"
                      r"|Function properties for (\S+)", line)
        if m:
            fn = m.group(1) or m.group(2)
            k = re.search(r"\d((?:bwd|flash_fwd)_\w+?)I(13__nv_bfloat16|f)?"
                          r"Li(\d+)E(?:Li(\d+)E)?(?:Li(\d+)E)?", fn)
            if k:
                dtype = {"f": "fp32 ", "13__nv_bfloat16": "bf16 "}.get(
                    k.group(2), "")
                more = "".join(f" {g}" for g in k.groups()[3:] if g)
                fn = f"{k.group(1)}<{dtype}{k.group(3)}{more}>".replace(
                    " ", ", ")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None and (int(m.group(1)) or int(m.group(2))):
            spills[fn] = (int(m.group(1)), int(m.group(2)))
    return spills


def bwd_spills(out) -> dict:
    """The backward source's functions that spill (:func:`ptxas_spills`
    of its build output), logged by name; a tensor-core pass
    (:data:`BWD_TC_PASSES`, their two-warpgroup forms too) among them
    fails the check."""
    spills = ptxas_spills(out)
    log("[build] flash_attention_bwd spills (bytes stored/loaded): "
        + (", ".join(f"{fn} {st}/{ld}" for fn, (st, ld) in spills.items())
           or "none"))
    tc = {fn: n for fn, n in spills.items()
          if any(name in fn for name in BWD_TC_PASSES)}
    check(not tc, f"tensor-core backward passes spill to local memory: {tc}")
    return spills


def fwd_spills(out) -> dict:
    """The forward source's functions that spill (:func:`ptxas_spills` of
    its build output), logged by name; the tensor-core kernel
    (:data:`FWD_TC_KERNELS`, its bf16 and its fp32 instantiations) among
    them fails the check."""
    spills = ptxas_spills(out)
    log("[build] flash_attention spills (bytes stored/loaded): "
        + (", ".join(f"{fn} {st}/{ld}" for fn, (st, ld) in spills.items())
           or "none"))
    tc = {fn: n for fn, n in spills.items()
          if any(name in fn for name in FWD_TC_KERNELS)}
    check(not tc, f"tensor-core forward kernels spill to local memory: {tc}")
    return spills


def sass_wgmma(lib) -> None:
    """``cuobjdump -sass`` of the built backward library: the wgmma
    instructions (``HGMMA``) in each tensor-core pass at each head size it
    is built for, bf16 and fp32 (three pieces), one quoted; a pass
    without one fails the check."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, quoted, fn = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts.setdefault(fn, 0)
        elif "HGMMA" in line and fn is not None:
            counts[fn] += 1
            if quoted is None and "bwd_dkdv_tc" in fn:
                quoted = line.split("*/", 1)[-1].split(";")[0].strip()
    built = len(fa.BWD_TC_HEAD_DIMS) + len(fa.BWD_SPLIT_HEAD_DIMS)
    for name in BWD_TC_PASSES:
        by_d = {fn: n for fn, n in counts.items() if name in fn}
        check(len(by_d) == built and all(n > 0 for n in by_d.values()),
              f"{name}: HGMMA counts {by_d}")
        log(f"[build] sass {name}: HGMMA instructions in each of its "
            f"{len(by_d)} instantiations (bf16 and fp32 by head size): "
            f"{sorted(by_d.values())}")
    log(f"[build] sass bwd_dkdv_tc, first HGMMA: {quoted}")


# --- phase 2 --------------------------------------------------------------------

def make_universe(torch, np, rng, J, C, S, frac, *, dev, masked_rows=(),
                  sparse_member=False, identity=False):
    """A masked universe mid-stream: settled row minima and accumulators
    plus one tick's new prices (as the fleet holds them)."""
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    for r in masked_rows:
        mask[r] = False
    if sparse_member:
        mask[J - 1] = False
        mask[J - 1, rng.choice(C, 3, replace=False)] = True
    hours = np.where(mask, hours, 1.0).astype(np.float32)
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = oldp.copy()
    changed = np.zeros((1, C), np.float32)
    if not identity:
        n = max(1, int(round(frac * C)))
        cols = rng.choice(C, n, replace=False)
        newp[0, cols] = (newp[0, cols] * rng.uniform(0.4, 1.6, n)
                         ).astype(np.float32)
        changed[0, cols] = 1.0
    rm = (rng.random((S, J)) > 0.5).astype(np.float32)
    if sparse_member:
        rm[S - 1] = 0.0
        rm[S - 1, J - 1] = 1.0
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        hours=hours, mask=mask, oldp=oldp, newp=newp, changed=changed,
        rm=rm).items()}
    inf = torch.tensor(float("inf"), device=dev)
    t["rb"] = torch.where(t["mask"], t["hours"] * t["oldp"], inf).amin(
        dim=1, keepdim=True)
    zero = torch.zeros((), device=dev)
    norm = torch.where(t["mask"], (t["hours"] * t["oldp"]) / t["rb"], zero)
    t["scores"] = t["rm"] @ norm
    t["finite"] = (t["rm"] @ t["mask"].float()) > 0
    return t


def within(torch, a, b) -> bool:
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    err = (a - b).abs()
    tol = ABS_TOL + REL_TOL * torch.maximum(a.abs(), b.abs())
    return bool(((err <= tol) | both_inf).all())


def bitwise(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_err(torch, a, b) -> float:
    same = (a == b)
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def check_select(torch, scores, finite, k, label, errs,
                 kernel="select") -> None:
    """The k-head kernel ``k`` takes (``select``; ``select_sort`` past the
    cap) against the plain stable sort: the same indices and values, bit
    for bit, and every head k distinct configs."""
    from repro_torch.kernels import rank_delta as rd
    check(rd._select_plan(*scores.shape, k).kernel == kernel,
          f"{label}: k={k} is not {kernel}'s")
    before = dict(rd.LAUNCHES)
    ti_k, tv_k = rd._launch_select(scores, finite, k)
    check({n: rd.LAUNCHES[n] - before[n] for n in before}
          == {n: int(n == kernel) for n in before},
          f"{label}: {kernel} did not launch alone")
    ti_p, tv_p = rd.select_heads_plain(scores, finite, k)
    check(torch.equal(ti_k, ti_p), f"{label}: {kernel} indices differ from "
          f"the stable sort")
    check(torch.equal(tv_k.view(torch.int32), tv_p.view(torch.int32)),
          f"{label}: {kernel} values differ")
    rows = ti_k.cpu().numpy()
    check(all(len(set(r)) == len(r) for r in rows),
          f"{label}: a head repeats a config")
    errs[kernel] = max(errs[kernel], max_err(torch, tv_k, tv_p))


def check_kernels(torch, t, label, k, errs, identity=False) -> None:
    """Every kernel against its plain version on the tick ``t``: row
    minima and moved bitwise, scores within the contract, heads equal to
    the stable sort, an identity tick bitwise unchanged, and the whole-tick
    wrappers equal to their parts."""
    from repro_torch.kernels import rank_delta as rd
    J, C = t["hours"].shape
    S = t["rm"].shape[0]
    args = (t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
            t["rb"], t["rm"], t["scores"])
    rb_k, moved_k = rd._launch_rowmin(t["hours"], t["mask"], t["newp"],
                                      t["rb"])
    rb_r, moved_r = rd._launch_rowmin(t["hours"], t["mask"], t["newp"],
                                      t["rb"], variant="rowmin_row")
    rb_p, moved_p = rd.rowmin_plain(t["hours"], t["mask"], t["newp"],
                                    t["rb"])
    check(bitwise(torch, rb_k, rb_p) and bitwise(torch, rb_r, rb_p),
          f"{label}: row minima not bitwise equal")
    check(int(moved_k) == int(moved_p) == int(moved_r), f"{label}: moved "
          f"{int(moved_k)} (rowmin_row {int(moved_r)}) != {int(moved_p)}")
    fold_args = args[:6] + (rb_k, t["rm"], t["scores"])
    s_k = rd._launch_fold(*fold_args)
    s_p = rd.fold_plain(*fold_args)
    check(within(torch, s_k, s_p), f"{label}: fold outside rel "
          f"{REL_TOL}/abs {ABS_TOL}")
    again = rd._launch_fold(*fold_args)
    check(torch.equal(again.view(torch.int32), s_k.view(torch.int32)),
          f"{label}: two folds of the same inputs differ")
    s_col = rd._launch_fold(*fold_args, variant="fold_col")
    check(within(torch, s_k, s_col), f"{label}: fold and fold_col differ "
          f"beyond rel {REL_TOL}/abs {ABS_TOL}")
    if identity:
        check(torch.equal(s_k, t["scores"]) and torch.equal(rb_k, t["rb"])
              and int(moved_k) == 0,
              f"{label}: identity tick not bitwise unchanged")
    kk = min(k, C)
    check_select(torch, s_k, t["finite"], kk, label, errs,
                 rd._select_plan(S, C, kk).kernel)
    if C > rd.SELECT_CAP:       # the cap, one past it, and k = C on a row
        check_select(torch, s_k, t["finite"], rd.SELECT_CAP,
                     label + " k = cap", errs)
        check_select(torch, s_k, t["finite"], rd.SELECT_CAP + 1,
                     label + " k = cap + 1", errs, "select_sort")
        check_select(torch, s_k[:1], t["finite"][:1], C, label + " k = C",
                     errs, "select_sort")
        # the yardstick the timings compare with, past the old cap of 64
        kr = rd.SELECT_CAP + 1
        ti_r, tv_r = rd._launch_select_rounds(s_k, t["finite"], kr)
        ti_p, tv_p = rd.select_heads_plain(s_k, t["finite"], kr)
        check(torch.equal(ti_r, ti_p) and torch.equal(tv_r, tv_p),
              f"{label}: select_rounds differs from the stable sort")
        errs["select_rounds"] = max(errs["select_rounds"],
                                    max_err(torch, tv_r, tv_p))
    out, rb, moved, ti, _ = rd.fused_reprice_heads(*args, t["finite"], k=kk)
    ti_k, _ = rd.select_heads_plain(s_k, t["finite"], kk)
    check(torch.equal(out, s_k) and torch.equal(rb, rb_k)
          and torch.equal(ti, ti_k), f"{label}: fused wrapper differs")
    torch.cuda.synchronize()
    errs["rowmin"] = max(errs["rowmin"], max_err(torch, rb_k, rb_p))
    errs["rowmin_row"] = max(errs["rowmin_row"], max_err(torch, rb_r, rb_p))
    errs["fold"] = max(errs["fold"], max_err(torch, s_k, s_p))
    errs["fold_col"] = max(errs["fold_col"], max_err(torch, s_col, s_p))
    log(f"[parity] {label}: J={J} C={C} S={S} moved={int(moved_k)} "
        f"fold max|err|={max_err(torch, s_k, s_p):.3g} ok")


def parity_case(torch, np, rng, label, J, C, S, frac, k, errs, **kw):
    t = make_universe(torch, np, rng, J, C, S, frac,
                      dev=torch.device("cuda"), **kw)
    check_kernels(torch, t, label, k, errs, identity=kw.get("identity",
                                                             False))
    return t


def rowmin_case(torch, np, rng, J, C, dev):
    """Hours, mask, old and new prices and the settled row minima at (J,
    C); from J = 3 a fully masked row (0), a row whose one profiled cell
    is the last column (1: the last chunk) and a row of zero hours (2)."""
    from repro_torch.kernels import rank_delta as rd
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    if J >= 3:
        mask[0] = False
        mask[1] = False
        mask[1, C - 1] = True
        hours[2] = 0.0
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = (oldp * rng.uniform(0.5, 1.5, (1, C))).astype(np.float32)
    h, m, po, pn = (torch.from_numpy(a).to(dev)
                    for a in (hours, mask, oldp, newp))
    rb, _ = rd.rowmin_plain(h, m, po, torch.zeros((J, 1), device=dev))
    return h, m, po, pn, rb


def check_rowmin_edges(torch, np, rng, errs) -> None:
    """``rowmin`` at :data:`ROWMIN_EDGES` against the plain version and the
    yardstick ``rowmin_row``, minima and moved bit for bit: twice in a
    row, and an identity tick (moved 0); then 100 launches in a row on the
    same scratch at the fleet's 64 x 10,000, over three price vectors,
    each held against the plain version (the arrival counters reset)."""
    from repro_torch.kernels import rank_delta as rd
    dev = torch.device("cuda")
    for J, C in ROWMIN_EDGES:
        h, m, po, pn, rb = rowmin_case(torch, np, rng, J, C, dev)
        want = rd.rowmin_plain(h, m, pn, rb)
        runs = [rd._launch_rowmin(h, m, pn, rb),
                rd._launch_rowmin(h, m, pn, rb),
                rd._launch_rowmin(h, m, pn, rb, variant="rowmin_row")]
        ident = rd._launch_rowmin(h, m, po, rb)
        for rb_k, mv_k in runs:
            check(bitwise(torch, rb_k, want[0])
                  and int(mv_k) == int(want[1]),
                  f"rowmin {J} x {C}: differs from the plain version")
            errs["rowmin"] = max(errs["rowmin"],
                                 max_err(torch, rb_k, want[0]))
        check(bitwise(torch, ident[0], rb) and int(ident[1]) == 0,
              f"rowmin {J} x {C}: identity tick moved")
    h, m, po, pn, rb = rowmin_case(torch, np, rng, 64, 10_000, dev)
    prices = [pn, po, (pn * 0.75).contiguous()]
    got = [rd._launch_rowmin(h, m, prices[i % 3], rb) for i in range(100)]
    wants = [rd.rowmin_plain(h, m, p, rb) for p in prices]
    bad = [i for i, (rb_k, mv_k) in enumerate(got)
           if not (bitwise(torch, rb_k, wants[i % 3][0])
                   and int(mv_k) == int(wants[i % 3][1]))]
    check(not bad, f"rowmin: launches {bad[:5]} of 100 on one scratch "
          f"differ from the plain version")
    log(f"[parity] rowmin: {len(ROWMIN_EDGES)} edge shapes (C = 1 to "
        f"10,001, J = 1 and 64), twice, identity, rowmin_row, and 100 "
        f"launches in a row: bitwise ok")


def make_pairs(np, rng, C, n):
    """n distinct (int32 column, float32 price) pairs over C columns."""
    return (rng.choice(C, n, replace=False).astype(np.int32),
            rng.uniform(0.5, 20.0, n).astype(np.float32))


def check_scatter(torch, np, rng, errs) -> None:
    """``scatter`` against its plain version (``index_copy`` and
    ``index_fill_``), new prices and flags bit for bit: C = 1, 3, 10,000
    and 100,000; n = 0, 1, 1% and every column; two scatters back to back
    through the public wrapper; the pageable yardstick by name; then the
    staged launch captured once a C into a CUDA graph and replayed with n
    changing between replays (0, 1, 1%, C, 1, 0)."""
    from repro_torch.kernels import rank_delta as rd
    dev = torch.device("cuda")
    cases = replays = 0
    for C in (1, 3, 10_000, 100_000):
        prices = torch.from_numpy(rng.uniform(0.5, 20.0, (1, C)).astype(
            np.float32)).to(dev)
        ns = sorted({0, 1, max(1, C // 100), C})
        for n in ns:
            pairs = [make_pairs(np, rng, C, n) for _ in range(2)]
            got = [rd.scatter_prices(*p, prices) for p in pairs]
            got.append(rd._launch_scatter_pageable(*pairs[0], prices))
            for name, p, out in zip(("scatter", "scatter",
                                     "scatter_pageable"),
                                    pairs + pairs[:1], got):
                want = rd.scatter_prices_plain(*p, prices)
                check(all(bitwise(torch, a, b) for a, b in zip(out, want)),
                      f"{name} C={C} n={n}: differs from the plain "
                      f"version")
                errs[name] = max(errs[name], max_err(torch, out[0], want[0]))
            cases += 1
        staging = rd.PairStaging(C, dev)
        new_p, changed = torch.empty_like(prices), torch.empty_like(prices)
        graph = rd.capture(lambda: rd._launch_scatter_staged(
            staging, 0, prices, new_p, changed), dev)
        for n in ns + [1, 0]:
            p = make_pairs(np, rng, C, n)
            staging.fill(0, *p)
            rd.replay(graph, ("scatter",))
            staging.release(0)
            staging.wait(0)
            want = rd.scatter_prices_plain(*p, prices)
            check(bitwise(torch, new_p, want[0])
                  and bitwise(torch, changed, want[1]),
                  f"scatter C={C} n={n}: a graph replay differs from the "
                  f"plain version")
            replays += 1
    log(f"[parity] scatter: {cases} cases (C = 1 to 100,000, n = 0 to C, "
        f"twice back to back, and scatter_pageable), {replays} replays of "
        f"one graph a C with n changing: bitwise ok")


def in_turns(torch, a, b, iters=100):
    """``time_ms`` of ``a`` and of ``b`` in turns (a, b, b, a): each the
    mean of its two turns."""
    ms = {"a": 0.0, "b": 0.0}
    for key, fn in (("a", a), ("b", b), ("b", b), ("a", a)):
        ms[key] += time_ms(torch, fn, iters=iters) / 2
    return ms["a"], ms["b"]


def time_scatter(torch, np, rng, C, frac=0.01):
    """``scatter`` at C columns and a tick of ``frac`` of them, back to
    back through the public wrapper (the pairs packed into the next
    staging slot and one queued call: what the sharded fleet pays) in
    turns with the pageable yardstick it replaced (``earlier_ms``; it
    refuses a graph), and the staged call alone replayed from a CUDA graph
    (the card's time: the copy, the clear and the kernel's reads over
    PCIe), beside the plain version (``index_copy``, ``zeros_like``,
    ``index_fill_``).  Also the kernel's fixed grid from a graph at three
    sizes: sized for C, :data:`rank_delta.SCATTER_BLOCKS` (the wrapper's
    cap) and 8.  Returns the records of ``scatter`` and
    ``scatter_pageable``."""
    from repro_torch.kernels import rank_delta as rd
    dev = torch.device("cuda")
    n = max(1, int(round(frac * C)))
    prices = torch.from_numpy(rng.uniform(0.5, 20.0, (1, C)).astype(
        np.float32)).to(dev)
    cols, new = make_pairs(np, rng, C, n)
    staging = rd.PairStaging(C, dev)
    staging.fill(0, cols, new)
    new_p, changed = torch.empty_like(prices), torch.empty_like(prices)

    def staged(blocks=None):
        return lambda: rd._launch_scatter_staged(staging, 0, prices, new_p,
                                                 changed, blocks)

    ms, pageable_ms = in_turns(
        torch, lambda: rd._launch_scatter(cols, new, prices),
        lambda: rd._launch_scatter_pageable(cols, new, prices))
    r = dict(ms=ms, device_ms=graph_ms(torch, staged()),
             earlier_ms=pageable_ms,
             plain_ms=time_ms(torch, lambda: rd.scatter_prices_plain(
                 cols, new, prices)),
             library_ms=None, bound=bound_ms(12 * C + 8 * n, n))
    log_time("scatter", r, f"C={C}, n={n}")
    grids = {b: graph_ms(torch, staged(b)) for b in sorted(
        {-(-C // rd.SCATTER_THREADS), rd.SCATTER_BLOCKS, 8})}
    log(f"[time] scatter grid at C={C}, n={n} (graph): " + ", ".join(
        f"{b} blocks {t:.4f} ms" for b, t in grids.items()))
    pageable = dict(ms=pageable_ms, plain_ms=r["plain_ms"], library_ms=None,
                    bound=r["bound"])
    return r, pageable


def phase_parity(torch, np, seed):
    rng = np.random.default_rng(seed)
    errs = {name: 0.0 for name in KERNELS}
    check_scatter(torch, np, rng, errs)
    check_rowmin_edges(torch, np, rng, errs)
    parity_case(torch, np, rng, "ragged 1%", 61, 1000, 5, 0.01, 10, errs,
                masked_rows=(3, 40), sparse_member=True)
    parity_case(torch, np, rng, "ragged 30%", 37, 777, 19, 0.30, 25, errs,
                masked_rows=(0,), sparse_member=True)
    parity_case(torch, np, rng, "identity", 61, 1000, 5, 0.0, 10, errs,
                masked_rows=(7,), identity=True)
    parity_case(torch, np, rng, "small, k = C", 9, 20, 3, 0.3, 20, errs,
                sparse_member=True)
    parity_case(torch, np, rng, "fleet 64x10k identity", 64, 10_000, 16,
                0.0, 10, errs, identity=True)
    parity_case(torch, np, rng, "fleet 64x100k identity", 64, 100_000, 16,
                0.0, 10, errs, identity=True)
    big = parity_case(torch, np, rng, "fleet 64x100k 1%", 64, 100_000, 16,
                      0.01, 10, errs, sparse_member=True)
    main = parity_case(torch, np, rng, "fleet 64x10k 1%", 64, 10_000, 16,
                       0.01, 10, errs, sparse_member=True)
    return errs, main, big


def head_bound(R, C, k):
    """The k-head's bound: each score and flag read once, each head entry
    written once; one compare a cell."""
    return bound_ms(R * C * 5 + R * k * 8, R * C)


def time_head(torch, scores, finite, k, rounds=True):
    """The k-head ``k`` takes on ``(scores, finite)``, timed back to back
    and replayed from a CUDA graph, beside the plain stable sort,
    ``torch.topk`` (both ways) and, where ``rounds``, the k-round kernel
    it replaced (``earlier_ms``)."""
    from repro_torch.kernels import rank_delta as rd
    R, C = scores.shape
    inf = torch.tensor(float("inf"), device=scores.device)
    masked = torch.where(finite, scores, inf)
    r = dict(
        kernel=rd._select_plan(R, C, k).kernel,
        ms=time_ms(torch, lambda: rd._launch_select(scores, finite, k)),
        device_ms=graph_ms(torch, lambda: rd._launch_select(scores, finite,
                                                            k)),
        plain_ms=time_ms(torch, lambda: rd.select_heads_plain(
            scores, finite, k), iters=20),
        library_ms=time_ms(torch, lambda: torch.topk(
            masked, k, dim=1, largest=False)),
        library_device_ms=graph_ms(torch, lambda: torch.topk(
            masked, k, dim=1, largest=False)),
        bound=head_bound(R, C, k))
    if rounds:
        r["earlier_ms"] = time_ms(torch, lambda: rd._launch_select_rounds(
            scores, finite, k), iters=10, warmup=2)
    return r


def log_time(name, r, shape) -> None:
    """One ``[time]`` line; "graph" is the same call replayed from a CUDA
    graph (the card's time without the host's)."""
    def ms(key):
        return f"{r[key]:.4f}" if r.get(key) is not None else "null"

    kernel = ms("ms") + (f" (graph {ms('device_ms')})"
                         if "device_ms" in r else "")
    earlier = f", earlier kernel {ms('earlier_ms')}" + (
        f" (graph {ms('earlier_device_ms')})"
        if "earlier_device_ms" in r else "") + " ms" \
        if "earlier_ms" in r else ""
    lib = ms("library_ms") + (f" (graph {ms('library_device_ms')})"
                              if "library_device_ms" in r else "")
    log(f"[time] {name}: kernel {kernel} ms{earlier}, plain "
        f"{ms('plain_ms')} ms, library {lib} ms, bound "
        f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) at {shape}")


def time_kernels(torch, t, k=10, heads=None):
    """Each kernel, its plain version, the kernel it replaced and the
    library call on the tick ``t``.  The k-heads run on ``heads``
    (``(scores, finite)``) when given — the one member row the service's
    ``top_k`` serves — else on every member row of ``t`` (the fused heads
    tick): ``select`` at ``k`` and the k-round kernel at 65, one past its
    old cap (``select_sort`` is timed by :func:`time_heads`)."""
    from repro_torch.kernels import rank_delta as rd
    J, C = t["hours"].shape
    S = t["rm"].shape[0]
    sel_scores, sel_finite = heads if heads else (t["scores"], t["finite"])
    R = sel_scores.shape[0]
    rb_new, _ = rd.rowmin_plain(t["hours"], t["mask"], t["newp"], t["rb"])
    fold_args = (t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
                 t["rb"], rb_new, t["rm"], t["scores"])
    inf = torch.tensor(float("inf"), device=sel_scores.device)
    masked = torch.where(sel_finite, sel_scores, inf)
    kr = min(65, C)

    def fold(variant):
        return lambda: rd._launch_fold(*fold_args, variant=variant)

    def rowmin(variant="rowmin"):
        return lambda: rd._launch_rowmin(t["hours"], t["mask"], t["newp"],
                                         t["rb"], variant=variant)

    res = {
        "rowmin": dict(
            ms=time_ms(torch, rowmin()),
            earlier_ms=time_ms(torch, rowmin("rowmin_row")),
            device_ms=graph_ms(torch, rowmin()),
            earlier_device_ms=graph_ms(torch, rowmin("rowmin_row")),
            plain_ms=time_ms(torch, lambda: rd.rowmin_plain(
                t["hours"], t["mask"], t["newp"], t["rb"])),
            library_ms=None),
        "fold": dict(
            ms=time_ms(torch, fold("fold")),
            earlier_ms=time_ms(torch, fold("fold_col")),
            device_ms=graph_ms(torch, fold("fold")),
            earlier_device_ms=graph_ms(torch, fold("fold_col")),
            plain_ms=time_ms(torch, lambda: rd.fold_plain(*fold_args)),
            library_ms=None),
        "select": time_head(torch, sel_scores, sel_finite, k),
        # the k-round kernel where it served: k one past its old cap of 64
        "select_rounds": dict(
            ms=time_ms(torch, lambda: rd._launch_select_rounds(
                sel_scores, sel_finite, kr), iters=20),
            plain_ms=time_ms(torch, lambda: rd.select_heads_plain(
                sel_scores, sel_finite, kr), iters=20),
            library_ms=time_ms(torch, lambda: torch.topk(
                masked, kr, dim=1, largest=False))),
    }
    res["rowmin_row"] = dict(ms=res["rowmin"]["earlier_ms"],
                             device_ms=res["rowmin"]["earlier_device_ms"],
                             plain_ms=res["rowmin"]["plain_ms"],
                             library_ms=None)
    res["fold_col"] = dict(ms=res["fold"]["earlier_ms"],
                           device_ms=res["fold"]["earlier_device_ms"],
                           plain_ms=res["fold"]["plain_ms"], library_ms=None)
    mask = t["mask"]
    nnz = float(mask.sum())
    member_cells = float((t["rm"] @ mask.float().sum(dim=1,
                                                     keepdim=True)).sum())
    res["rowmin"]["bound"] = res["rowmin_row"]["bound"] = bound_ms(
        J * C * 5 + C * 4 + J * 8 + 4, 2 * nnz)
    res["fold"]["bound"] = res["fold_col"]["bound"] = bound_ms(
        J * C * 5 + 3 * C * 4 + 2 * J * 4 + S * J * 4 + 2 * S * C * 4,
        5 * nnz + 4 * member_cells)
    res["select_rounds"]["bound"] = head_bound(R, C, kr)
    tick = f"J={J} C={C} S={S}"
    for name in ("rowmin", "rowmin_row", "fold", "fold_col"):
        log_time(name, res[name], tick)
    for name, kk in (("select", k), ("select_rounds", kr)):
        log_time(name, res[name], f"{R} x {C}, k={kk}")
    return res


def time_heads(torch, row, big):
    """The k-head at every (rows, columns, k) of :data:`HEAD_SHAPES`: the
    service's member row (1 x 10,000) and the 64 x 100,000 fleet's rows;
    the k-round kernel beside it on one row up to :data:`ROUNDS_MAX_K`."""
    rows = {1: row, 16: big}
    out = {}
    for R, C, k in HEAD_SHAPES:
        scores, finite = rows[R]
        check(tuple(scores.shape) == (R, C), f"k-head rows {scores.shape} "
              f"are not {R} x {C}")
        r = time_head(torch, scores, finite, k,
                      rounds=R == 1 and k <= ROUNDS_MAX_K)
        log_time(f"k-head ({r['kernel']})", r, f"{R} x {C}, k={k}")
        out[(R, C, k)] = r
    return out


# --- phase 3 --------------------------------------------------------------------

def assert_member(state, key, hours, mask, rows, live, ids, contract,
                  rank_dense) -> None:
    cold = rank_dense(hours[rows], mask[rows], live, ids)
    got = state.ranking(key)
    check(contract.winner_matches(got[0].config_id, cold),
          f"member {key}: winner {got[0]} vs cold {cold[0]}")
    ref = {r.config_id: r.score for r in cold}
    bad = [r for r in got if not contract.scores_match(r.score,
                                                       ref[r.config_id])]
    check(not bad, f"member {key}: {len(bad)} scores outside the contract, "
          f"first {bad[:1]} vs {ref[bad[0].config_id] if bad else None}")


def dense_densify(np, state, deltas):
    """The host step of the tick the pair path replaced: ids resolved and
    prices checked with a Python step per delta, then the whole (1, C)
    price vector and a dense changed vector built on the host."""
    table = dict(deltas)
    cols = np.asarray([state._pos[c] for c in table], dtype=np.int32)
    prices = np.asarray(list(table.values()), dtype=np.float64)
    check(bool((np.isfinite(prices) & (prices > 0)).all()),
          "dense tick: a price is not positive and finite")
    newp = state._host_prices.copy()
    newp[0, cols] = prices.astype(np.float32)
    changed = np.zeros_like(newp)
    changed[0, cols] = 1.0
    return newp, changed


def pairs_host_step(state, deltas) -> None:
    """The host step of the pair path: the deltas validated into pairs
    (distinct columns in range by construction) and packed into a staging
    slot as the tick packs them."""
    from repro_torch.kernels import rank_delta as rd
    cols, prices = state._pairs(deltas)
    rd.pack_pairs(state._staging.slots[1 - state._cur], cols, prices)


def dense_tick(torch, np, state, deltas) -> int:
    """One tick of ``state`` through the dense path (the yardstick): the
    densify, both (1, C) vectors uploaded from pageable memory, the two
    kernels and the handoff count read back."""
    from repro_torch.kernels import rank_delta as rd
    newp, changed = dense_densify(np, state, deltas)
    d_newp = torch.tensor(newp, device=state.device)
    state.d_scores, state.d_row_best, moved = rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, d_newp,
        torch.tensor(changed, device=state.device), state.d_row_best,
        state.d_row_masks, state.d_scores)
    state.d_prices, state._host_prices = d_newp, newp
    return int(moved.item())


def fleet_universe(np, seed, J, C, S):
    """A fleet's universe from the seed: ``(rng, hours, mask, prices, ids,
    members)`` with S members ("all" and S - 1 random row subsets)."""
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.05, 10.0, (J, C))
    mask = rng.random((J, C)) > 0.15
    mask[np.arange(J), rng.integers(0, C, J)] = True
    prices = rng.uniform(0.5, 20.0, C)
    ids = [f"c{i}" for i in range(C)]
    members = {"all": list(range(J))}
    for m in range(S - 1):
        size = int(rng.integers(1, J))
        members[f"m{m}"] = sorted(int(i) for i in
                                  rng.choice(J, size, replace=False))
    return rng, hours, mask, prices, ids, members


def phase_fleet(torch, np, seed, J, C, S, ticks, check_every, label,
                card="", device="cuda"):
    from repro_torch.kernels import rank_delta as rd
    from repro_torch.selector import (TorchFusedRankState, rank_dense,
                                      score_contract)
    from repro_torch.selector.fused_rank import GRAPHS
    graphs0 = dict(GRAPHS)
    rng, hours, mask, prices, ids, members = fleet_universe(np, seed, J, C,
                                                            S)
    contract = score_contract("torch_fused")
    state = TorchFusedRankState(hours, mask, prices, ids, capacity=S,
                                device=device)
    for key, rows in members.items():
        state.add_state(key, rows=rows)
    live = state.prices.copy()          # the float32 quotes, lifted
    n_chg = max(1, C // 100)

    def next_deltas():
        cols = rng.choice(C, n_chg, replace=False)
        new = (live[cols] * rng.uniform(0.7, 1.3, n_chg)).astype(np.float32)
        return {ids[c]: float(p) for c, p in zip(cols, new)}, cols, new

    k = 10
    for tick in range(1, ticks + 1):
        deltas, cols, new = next_deltas()
        if tick % 2:
            state.reprice(deltas)
            heads = None
        else:
            _, heads = state.reprice_with_heads(deltas, k)
        live[cols] = new
        verify = tick % check_every == 0
        if heads is not None:
            for key in members:
                check(heads[key] == state.ranking(key)[:k],
                      f"{label} tick {tick}: head of {key} differs from "
                      f"ranking()[:{k}]")
        if verify:
            for key, rows in members.items():
                assert_member(state, key, hours, mask, rows, live, ids,
                              contract, rank_dense)
            log(f"[fleet] {label} tick {tick}: {len(members)} members "
                f"within contract")
    check(state.dispatches == state.reprices == ticks,
          f"{label}: dispatches {state.dispatches} != ticks {ticks}")
    # an identity tick on the live, mid-stream fleet: bitwise unchanged
    zeros = torch.zeros_like(state.d_prices)
    out, rb, moved = rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, state.d_prices, zeros,
        state.d_row_best, state.d_row_masks, state.d_scores)
    check(torch.equal(out, state.d_scores)
          and torch.equal(rb, state.d_row_best) and int(moved) == 0,
          f"{label}: identity tick changed the fleet")
    # the pair path against the dense path it replaced, on the same deltas
    # from the same state: scores, row minima, prices and moved bit for
    # bit.  The state's tensors are its own buffers, rewritten two ticks
    # later, so the results are cloned; assigning the saved ones back is
    # an assignment from outside, which the next tick rebinds
    def snapshot():
        return (state.d_scores.clone(), state.d_row_best.clone(),
                state.d_prices.clone(), state._host_prices.copy())

    def restore(saved):
        (state.d_scores, state.d_row_best, state.d_prices,
         state._host_prices) = (saved[0], saved[1], saved[2],
                                saved[3].copy())

    before = snapshot()
    d = next_deltas()[0]
    m_pairs = state.reprice(d)
    pairs = snapshot()[:3]
    restore(before)
    m_dense = dense_tick(torch, np, state, d)
    check(m_pairs == m_dense and all(
        bitwise(torch, a, b) for a, b in zip(pairs, (
            state.d_scores, state.d_row_best, state.d_prices))),
        f"{label}: the pair tick differs from the dense tick")
    # the graphed tick against the eager one (the same launches, queued one
    # by one), on the same deltas from the same state, both directions
    for _ in range(2):
        before = snapshot()
        d = next_deltas()[0]
        m_graph = state.reprice(d)
        graphed = snapshot()[:3]
        restore(before)
        m_eager = state._reprice(d, graph=False)
        check(m_graph == m_eager and all(
            bitwise(torch, a, b) for a, b in zip(graphed, (
                state.d_scores, state.d_row_best, state.d_prices))),
            f"{label}: the graphed tick differs from the eager tick")
    # the tick's time, after warm-up, through each path in turns (dense,
    # eager, graph, graph, eager, dense; 25 ticks a turn): the host step +
    # the scatter + the two kernels + the handoff count read back
    order = ("dense", "eager", "graph", "graph", "eager", "dense")
    batches = [next_deltas()[0] for _ in range(15 + 25 * len(order))]
    ticks_by = {"graph": state.reprice,
                "eager": lambda d: state._reprice(d, graph=False),
                "dense": lambda d: dense_tick(torch, np, state, d)}
    for i, d in enumerate(batches[:15]):
        ticks_by[("dense", "eager", "graph")[i % 3]](d)
    host_ms = dict.fromkeys(ticks_by, 0.0)
    dev_ms = dict.fromkeys(ticks_by, 0.0)
    turns = []
    for turn, path in enumerate(order):
        part = batches[15 + 25 * turn:40 + 25 * turn]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for d in part:
            ticks_by[path](d)
        stop.record()
        torch.cuda.synchronize()
        turns.append((time.perf_counter() - t0) * 1e3 / 25)
        host_ms[path] += turns[-1] / 2
        dev_ms[path] += start.elapsed_time(stop) / 50
    log(f"[fleet] {label}: per tick by turn (host ms): " + ", ".join(
        f"{path} {ms:.4f}" for path, ms in zip(order, turns)))
    tick_bytes = (J * C * 5 + C * 4 + J * 8) + (
        J * C * 5 + 3 * C * 4 + 2 * J * 4 + S * J * 4 + 2 * S * C * 4)
    log(f"[fleet] {label}: {ticks} ticks, one dispatch each; per tick "
        f"{dev_ms['graph']:.4f} ms (CUDA events) / {host_ms['graph']:.4f} "
        f"ms (host) through the graph, {dev_ms['eager']:.4f} / "
        f"{host_ms['eager']:.4f} ms eager "
        f"({host_ms['graph'] / host_ms['eager']:.2f} x by the host clock, "
        f"in turns), bound "
        f"{tick_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms ({tick_bytes} bytes "
        f"at 3.35 TB/s) on {card}")
    # where the tick's time goes: the host step alone (validation and
    # checks; for the dense path the densify), the two kernels alone on the
    # fleet's own tensors replayed from a CUDA graph (the card's time), and
    # the fleet's own tick graph replayed back to back (CUDA events: its
    # copy, clear, scatter, rowmin, fold and handoff copy); the rest is the
    # launches' or the replay's host work and the handoff count read back
    host_step = {"graph": lambda d: pairs_host_step(state, d),
                 "eager": lambda d: pairs_host_step(state, d),
                 "dense": lambda d: dense_densify(np, state, d)}
    step_ms = dict.fromkeys(ticks_by, 0.0)
    for path in order:
        t0 = time.perf_counter()
        for d in batches[15:65]:
            host_step[path](d)
        step_ms[path] += (time.perf_counter() - t0) * 1e3 / 100
    kernels_ms = graph_ms(torch, lambda: rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, state.d_prices, zeros,
        state.d_row_best, state.d_row_masks, state.d_scores))
    # (a rehearsal on the CPU keeps no graph: nothing to replay or count)
    on_card = state.device.type == "cuda"
    tick_graph = state._graphs[state._cur]
    check(tick_graph is not None or not on_card,
          f"{label}: the fleet holds no tick graph")
    graph_card_ms = time_ms(torch, tick_graph.replay) if on_card else None
    # one replay and its wait, by the host clock: the graph's launch and
    # card time when nothing is queued behind it, as a tick sees them
    replay_ms = None
    if on_card:
        t0 = time.perf_counter()
        for _ in range(100):
            tick_graph.replay()
            torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3 / 100
    for path in ("graph", "eager", "dense"):
        log(f"[fleet] {label}: {path} path, per tick {host_ms[path]:.4f} ms "
            f"(host; {dev_ms[path]:.4f} by CUDA events): densify "
            f"{step_ms[path]:.4f} ms (host), rowmin+fold {kernels_ms:.4f} "
            f"ms (card, CUDA graph), rest "
            f"{host_ms[path] - step_ms[path] - kernels_ms:.4f} ms; the "
            f"kernels' card time is {kernels_ms / host_ms[path]:.1%} of the "
            f"tick")
    if on_card:
        log(f"[fleet] {label}: the tick graph replayed back to back "
            f"{graph_card_ms:.4f} ms a tick (CUDA events; rowmin+fold alone "
            f"{kernels_ms:.4f}), one replay and its wait {replay_ms:.4f} ms "
            f"(host); graphs this phase: " + ", ".join(
                f"{k} {v - graphs0[k]}" for k, v in GRAPHS.items()))
        check(GRAPHS["replays"] > graphs0["replays"],
              f"{label}: no tick was served by a graph")
    return dict(host_ms=host_ms, dev_ms=dev_ms, step_ms=step_ms,
                kernels_ms=kernels_ms, graph_card_ms=graph_card_ms,
                replay_ms=replay_ms)


# --- phase 3b: the sharded fleet -----------------------------------------------

#: the state-level check's shard counts, every shard on the one card
SHARD_COUNTS = (1, 2, 4)
#: the kernels a sharded tick launches, once a shard
TICK_KERNELS = ("scatter", "rowmin", "fold")


def split_tick(torch, rd, t, D):
    """``t``'s tick split by columns into D blocks as the sharded fleet
    runs it: ``row_minima`` on each block, the elementwise min of the
    blocks' minima, ``fold_scores`` on each block against it.  Returns
    ``(scores, row minima, moved)``."""
    C = t["hours"].shape[1]
    width = -(-C // D)
    blocks = [slice(lo, min(lo + width, C)) for lo in range(0, C, width)]

    def part(name, b):
        return t[name][:, b].contiguous()

    partial = [rd.row_minima(part("hours", b), part("mask", b),
                             part("newp", b), t["rb"])[0] for b in blocks]
    rb = partial[0]
    for p in partial[1:]:
        rb = torch.minimum(rb, p)
    out = torch.cat([rd.fold_scores(
        part("hours", b), part("mask", b), part("oldp", b), part("newp", b),
        part("changed", b), t["rb"], rb, t["rm"], part("scores", b))
        for b in blocks], dim=1)
    return out, rb, int((rb != t["rb"]).sum())


def check_against_cold(np, fleet, key, cold, contract, label) -> None:
    """A member against ``rank_dense``'s float64 scores (``cold``, ``inf``
    where unprofiled), vectorized: every score within the contract, the
    winner the cold winner or tied with it, and the 10-head the
    (score, catalog position) order of the member's own scores, which is
    ``ranking()[:10]``."""
    got = np.where(fleet.counts(key) > 0, fleet.scores(key), np.inf)
    with np.errstate(invalid="ignore"):
        tol = contract.abs_tol + contract.rel_tol * np.maximum(
            np.abs(got), np.abs(cold))
        ok = (got == cold) | (np.abs(got - cold) <= tol)
    check(bool(ok.all()), f"{label}: member {key}: {int((~ok).sum())} "
          f"scores outside the contract of rank_dense")
    head = fleet.top_k(key, 10)
    order = np.lexsort((np.arange(got.size), got))[:10]
    check([r.config_id for r in head] == [fleet.config_ids[i]
                                          for i in order]
          and [r.score for r in head] == [float(got[i]) for i in order],
          f"{label}: member {key}: head is not ranking()[:10]")
    win = fleet._pos[head[0].config_id]
    check(contract.scores_match(cold[win], cold.min()),
          f"{label}: member {key}: winner {head[0]} is not the cold winner "
          f"or tied with it")


def same_heads(contract, got, want) -> bool:
    """Two lists of heads name the same configs in the same order, each
    score within the contract of the other's (a member's first
    accumulators, a matmul at the shard's width, may round apart)."""
    return all([r.config_id for r in a] == [r.config_id for r in b]
               and all(contract.scores_match(x.score, y.score)
                       for x, y in zip(a, b))
               for a, b in zip(got, want)) and len(got) == len(want)


def shard_scores(torch, fleet, device):
    """A sharded fleet's (S, C) member scores on ``device``, its shards'
    blocks side by side."""
    return torch.cat([sh.scores.to(device) for sh in fleet._shards], dim=1)


def shard_tick(torch, np, rng, fleet, shard=0):
    """A 1% tick on one shard's own tensors: what :func:`check_kernels`
    takes, at the shapes the sharded path gives the kernels."""
    sh = fleet._shards[shard]
    C = sh.width
    newp = fleet._host_prices[:, sh.lo:sh.hi].copy()
    cols = rng.choice(C, max(1, C // 100), replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.7, 1.3, cols.size)
                     ).astype(np.float32)
    changed = np.zeros_like(newp)
    changed[0, cols] = 1.0
    return dict(hours=sh.hours, mask=sh.mask, oldp=sh.prices,
                newp=torch.from_numpy(newp).to(sh.device),
                changed=torch.from_numpy(changed).to(sh.device),
                rb=sh.row_best, rm=sh.row_masks, scores=sh.scores,
                finite=sh.finite)


def sync_cards(torch) -> None:
    """Wait for every local card (a sharded tick reads back the moved count
    on its first shard's card alone)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_sharded(torch, np, rd, seed, card, J=64, C=100_000, S=16,
                  ticks=10, turn_ticks=20, device="cuda:0"):
    """The sharded fleet: the split tick bitwise against the whole one;
    ``TorchShardedRankState`` at 1, 2 and 4 shards on one card (and, where
    there are several cards, one shard a card) against the fused fleet and
    the float64 cold rank, tick by tick; the tick timed in turns with the
    fused fleet's, and the combine's share of it."""
    from repro_torch.selector import (TorchFusedRankState,
                                      TorchShardedRankState, score_contract)
    from repro_torch.selector.rank import _scores_numpy
    contract = score_contract("torch_sharded")
    dev = torch.device(device)
    # the split tick against the whole tick on the same inputs, bit for bit
    rng = np.random.default_rng(seed + 7)
    for width in (C, C + 3):
        t = make_universe(torch, np, rng, J, width, S, 0.01, dev=dev,
                          masked_rows=(5,))
        whole, rb, moved = rd.fused_reprice(
            t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
            t["rb"], t["rm"], t["scores"])
        for D in (2, 3, 4):
            out, rb_s, moved_s = split_tick(torch, rd, t, D)
            check(bitwise(torch, out, whole) and bitwise(torch, rb_s, rb)
                  and moved_s == int(moved), f"sharded: the tick split {D} "
                  f"ways at {J}x{width}x{S} differs from the whole tick")
        log(f"[sharded] the tick split 2, 3 and 4 ways by columns at "
            f"{J}x{width}x{S}: scores, row minima and moved ({int(moved)}) "
            f"bitwise the whole tick's")
        del t, whole
    # the state at 1, 2 and 4 shards on the card (one shard a card where
    # there are several) against the fused fleet, tick by tick
    layouts = {f"D={D}": [dev] * D for D in SHARD_COUNTS}
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_cards > 1:
        layouts[f"{n_cards} cards"] = [torch.device("cuda", i)
                                       for i in range(n_cards)]
    rng, hours, mask, prices, ids, members = fleet_universe(np, seed + 8, J,
                                                            C, S)
    fused = TorchFusedRankState(hours, mask, prices, ids, capacity=S,
                                device=dev)
    fleets = {name: TorchShardedRankState(hours, mask, prices, ids,
                                          capacity=S, devices=devices)
              for name, devices in layouts.items()}
    for fleet in (fused, *fleets.values()):
        for key, rows in members.items():
            fleet.add_state(key, rows=rows)
    keys = list(members)

    def not_bitwise(fleet):
        """Cells of the fleet's scores that are not the fused fleet's."""
        scores = shard_scores(torch, fleet, dev)
        return int((scores.view(torch.int32) !=
                    fused.d_scores.view(torch.int32)).sum())

    # a member's first accumulators are a matmul at the shard's width: the
    # cells where it rounds apart from the fused fleet's, before any tick
    seeded_cells = {name: not_bitwise(f) for name, f in fleets.items()}
    live = fused.prices.copy()
    n_chg = max(1, C // 100)

    def next_deltas():
        cols = rng.choice(C, n_chg, replace=False)
        new = (live[cols] * rng.uniform(0.7, 1.3, n_chg)).astype(np.float32)
        return {ids[c]: float(p) for c, p in zip(cols, new)}, cols, new

    for tick in range(1, ticks + 1):
        deltas, cols, new = next_deltas()
        want = fused.reprice(deltas)
        want_heads = fused.heads(keys, 10)
        for name, fleet in fleets.items():
            D = len(fleet._shards)
            rd.reset_launches()
            got = fleet.reprice(deltas)
            counts = dict(rd.LAUNCHES)
            check(got == want, f"sharded {name} tick {tick}: moved {got} != "
                  f"the fused fleet's {want}")
            check(counts == {n: D * (n in TICK_KERNELS) for n in counts},
                  f"sharded {name} tick {tick}: launches {counts}")
            check(within(torch, shard_scores(torch, fleet, dev),
                         fused.d_scores),
                  f"sharded {name} tick {tick}: scores outside the contract "
                  f"of the fused fleet's")
            rd.reset_launches()
            heads = fleet.heads(keys, 10)
            check(dict(rd.LAUNCHES) == {n: D * (n == "select")
                                        for n in rd.LAUNCHES},
                  f"sharded {name}: heads launched {dict(rd.LAUNCHES)}")
            check(same_heads(contract, heads, want_heads),
                  f"sharded {name} tick {tick}: heads differ from the fused "
                  f"fleet's")
        live[cols] = new
        if tick in (ticks // 2, ticks):       # the float64 cold rank
            for key, rows in members.items():
                cold, counts = _scores_numpy(hours[rows], mask[rows], live)
                cold = np.where(counts > 0, cold, np.inf)
                for name, fleet in fleets.items():
                    check_against_cold(np, fleet, key, cold, contract,
                                       f"sharded {name} tick {tick}")
            log(f"[sharded] tick {tick}: every member of every fleet within "
                f"the contract of rank_dense, heads = ranking()[:10]")
    for name, fleet in fleets.items():
        full = fleet.ranking("all")
        for k in (10, 1_000):
            head = fleet.top_k("all", k)
            check(head == full[:k] and same_heads(
                contract, [head], [fused.top_k("all", k)]),
                f"sharded {name}: the {k}-head is not ranking()[:{k}] or "
                f"the fused fleet's")
        check(fleet.dispatches == fleet.reprices == ticks,
              f"sharded {name}: {fleet.dispatches} dispatches")
    log(f"[sharded] {J}x{C}x{S} at {', '.join(layouts)}: {ticks} ticks of "
        f"{n_chg} prices, moved and 10-heads' configs equal to the fused "
        f"fleet's every tick, scores within the contract (of {S * C} "
        f"cells, not bitwise the fused fleet's after seeding / after the "
        f"last tick: " + ", ".join(
            f"{name} {seeded_cells[name]} / {not_bitwise(f)}"
            for name, f in fleets.items())
        + "), one scatter, rowmin and fold a shard a tick, one select a "
        "shard a heads call; the 1,000-head = ranking()[:1000] and the "
        "fused fleet's configs")
    # the tick in turns with the fused fleet's (host clock: the pairs'
    # validation, D scatters, rowmins and folds, the combine and the moved
    # count read back; every card waited for at the end of a turn)
    paths = {"fused": fused.reprice}
    paths.update({name: fleet.reprice for name, fleet in fleets.items()})
    order = list(paths) + list(paths)[::-1]
    batches = [next_deltas()[0] for _ in range(len(order) * turn_ticks)]
    for d in batches[:turn_ticks]:                   # warm-up
        for tick_fn in paths.values():
            tick_fn(d)
    tick_ms = dict.fromkeys(paths, 0.0)
    for turn, name in enumerate(order):
        part = batches[turn * turn_ticks:(turn + 1) * turn_ticks]
        sync_cards(torch)
        t0 = time.perf_counter()
        for d in part:
            paths[name](d)
        sync_cards(torch)
        tick_ms[name] += (time.perf_counter() - t0) * 1e3 / (2 * turn_ticks)
    # the combine alone on each fleet's own minima (host clock; the moved
    # count's readback belongs to every fleet's tick and is left out)
    combine_ms = {}
    for name, fleet in fleets.items():
        partial = [sh.row_best for sh in fleet._shards]
        base = fleet._shards[0].row_best
        sync_cards(torch)
        t0 = time.perf_counter()
        for _ in range(200):
            rb = fleet._combine(partial)
            (rb != base).sum()
            fleet._replicas(rb)
        sync_cards(torch)
        combine_ms[name] = (time.perf_counter() - t0) * 1e3 / 200
    log(f"[sharded] tick at {J}x{C}x{S}, 1% of prices, in turns (host "
        f"clock, ms): " + ", ".join(f"{n} {v:.4f}" for n, v in
                                    tick_ms.items())
        + "; the combine (min of the shards' minima, the moved count, the "
        "copies back): " + ", ".join(
            f"{name} {combine_ms[name]:.4f} ms = "
            f"{combine_ms[name] / tick_ms[name]:.1%}" for name in fleets)
        + f" of the tick; on {card}")
    return {"tick_ms": tick_ms, "combine_ms": combine_ms}


def phase_sharded_service(torch, np, rd, seed, errs, n_events=1_000,
                          device="cuda:0"):
    """The sharded main path: phase 4's service and daemon on
    ``torch_sharded`` at 2 shards on one card, read through the launch
    counters, then the kernels held against their plain versions at the
    shapes it gave them (a shard of its fleet, a 1% tick)."""
    dev = torch.device(device)
    rd.reset_launches()
    service, _, _ = phase_service(np, seed, n_events=n_events,
                                  device=[dev] * 2, backend="torch_sharded",
                                  label="sharded service")
    launches = dict(rd.LAUNCHES)
    ticks_run = service.reprice_dispatches
    check(all(launches[n] == 2 * ticks_run > 0 for n in TICK_KERNELS),
          f"sharded service: {launches} for {ticks_run} fleet ticks at 2 "
          f"shards")
    check(launches["select"] > 0 and launches["select"] % 2 == 0,
          f"sharded service: {launches['select']} select launches")
    for name in set(KERNELS) - set(PATH_KERNELS):
        check(launches[name] == 0, f"sharded service: {name} launched")
    log(f"[sharded service] launches: " + ", ".join(
        f"{n} {launches[n]}" for n in PATH_KERNELS)
        + f" for {ticks_run} fleet ticks at 2 shards")
    check_kernels(torch, shard_tick(torch, np, np.random.default_rng(
        seed + 9), service._batched), "sharded service shard 0 1%", 10, errs)
    return launches


# --- phase 4 --------------------------------------------------------------------

def phase_service(np, seed, n_jobs=64, n_cfgs=10_000, n_events=1_000,
                  device="cuda", backend="torch_fused", label="service"):
    from repro_torch.core.trace import JobClass
    from repro_torch.market import (JournalReplayer, SelectionDaemon,
                                    SimulatedSpotFeed, synthetic_stream)
    from repro_torch.selector import (IdentityCatalog, PriceTable,
                                      ProfilingStore, SelectionService)
    rng = np.random.default_rng(seed)
    ids = [f"cfg{i}" for i in range(n_cfgs)]
    store = ProfilingStore(config_ids=ids)
    hours = rng.uniform(0.1, 5.0, (n_jobs, n_cfgs))
    keep = rng.random((n_jobs, n_cfgs)) >= 0.2          # partial profiling
    for j in range(n_jobs):
        klass = JobClass.A if j % 2 else JobClass.B
        for c in np.flatnonzero(keep[j]):
            store.add(f"job{j}", ids[c], float(hours[j, c]),
                      job_class=klass, group=f"g{j % 6}")
    table = PriceTable({c: float(p) for c, p in
                        zip(ids, rng.uniform(1.0, 30.0, n_cfgs))})
    service = SelectionService(IdentityCatalog(ids), store, table,
                               backend=backend, device=device,
                               serve_top_k=10)
    feed = SimulatedSpotFeed(dict(table.items()), seed=seed,
                             change_fraction=0.01)
    daemon = SelectionDaemon(service, feed)
    t0 = time.perf_counter()
    stats = daemon.run(synthetic_stream(store.job_ids, n_events, seed=seed))
    secs = time.perf_counter() - t0
    fleet = service._batched
    check(fleet is not None and 0 < fleet.dispatches <= stats.epochs,
          f"{label}: fleet dispatches {getattr(fleet, 'dispatches', None)} "
          f"for {stats.epochs} price epochs")
    check(service.reprice_dispatches == fleet.dispatches,
          f"{label}: more than one dispatch per tick")
    t0 = time.perf_counter()
    audit = JournalReplayer(store, daemon.journal_dump()).audit()
    audit_secs = time.perf_counter() - t0
    check(audit.ok, f"{label}: journal audit failed: {audit.mismatches[:3]}")
    check(audit.decisions == stats.decisions > 0,
          f"{label}: audit saw no decisions")
    log(f"[{label}] {n_events} events in {secs:.3f} s "
        f"({n_events / secs:.1f} events/s): {stats.decisions} decisions, "
        f"{stats.ticks} ticks, {stats.epochs} epochs, {fleet.n_active} "
        f"members; audit ok in {audit_secs:.3f} s ({audit.decisions} "
        f"decisions, {len(audit.drift)} within-contract drift records)")
    # the service's own spans (host clock): where the daemon's time went
    spans = service.metrics.snapshot()["histograms"]
    log(f"[{label}] spans (count x mean ms): " + ", ".join(
        f"{name} {h['count']} x {h['sum'] * 1e3 / h['count']:.4f}"
        for name, h in spans.items() if h["count"]))
    return service, store, table


# --- phase 10 (first half): the profiled daemon; phase 4's kernels -----------

def phase_busy(torch, seed, service, store, table, n_events=1_000):
    """The card's busy share over a second daemon run on the warm
    service, traced by ``torch.profiler`` (CUDA activity only): the union
    of the kernel and copy intervals the trace holds, over the run's wall
    time.  Reported as not measured when the trace holds no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.market import (SelectionDaemon, SimulatedSpotFeed,
                                    synthetic_stream)
    feed = SimulatedSpotFeed(dict(table.items()), seed=seed + 1,
                             change_fraction=0.01)
    daemon = SelectionDaemon(service, feed)
    events = synthetic_stream(store.job_ids, n_events, seed=seed + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = daemon.run(events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    head = (f"[busy] {n_events} events ({stats.ticks} ticks, "
            f"{stats.decisions} decisions) in {wall:.3f} s under the "
            f"profiler")
    if not spans:
        log(f"{head}: busy share not measured (no device activity in the "
            f"trace)")
        return
    log(f"{head}: {len(spans)} device intervals, busy {busy_us / 1e3:.3f} "
        f"ms = {busy_us / 1e6 / wall:.3%} of the wall time")


def fleet_tick(torch, np, rng, fleet):
    """A tick of 1% of the prices (one at least) on a fleet's own tensors
    (S = its slot capacity): what :func:`check_kernels` takes."""
    C = len(fleet.config_ids)
    newp = fleet._host_prices.copy()
    cols = rng.choice(C, max(1, C // 100), replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.7, 1.3, cols.size)
                     ).astype(np.float32)
    changed = np.zeros_like(newp)
    changed[0, cols] = 1.0
    return dict(hours=fleet.d_hours, mask=fleet.d_mask, oldp=fleet.d_prices,
                newp=torch.from_numpy(newp).to(fleet.device),
                changed=torch.from_numpy(changed).to(fleet.device),
                rb=fleet.d_row_best, rm=fleet.d_row_masks,
                scores=fleet.d_scores, finite=fleet._d_finite)


def phase_main_path_kernels(torch, np, seed, fleet, errs, k=10):
    """The kernels at the shapes the main path gave them: the service
    fleet's own tensors with a 1% tick, and, for ``select``, one member's
    score row as the service's ``top_k`` serves it.  Held against the
    plain versions, then timed."""
    t = fleet_tick(torch, np, np.random.default_rng(seed + 2), fleet)
    check_kernels(torch, t, "main path 1%", k, errs)
    slot = min(fleet._slots.values())
    row = (fleet.d_scores[slot:slot + 1], fleet._d_finite[slot:slot + 1])
    check_select(torch, *row, k, "main path top_k row", errs)
    return time_kernels(torch, t, k, heads=row), row


def phase_guard(torch, rd, row, k=10, n=100_000):
    """What the kernels' device guard (``_build.launch_on``) costs the
    host: around a no-op (on this machine's card count), beside the two
    device exchanges it makes where there are several cards and
    ``torch.cuda.device``'s context manager (microseconds a call beyond
    the bare call, host clock), and on the service's one-row ``select``
    (CUDA events, back to back) in turns with the guard and with a bare
    call in its place."""
    from repro_torch.kernels import _build
    t = row[0]

    def noop(*args):
        return 0

    def bare():
        for _ in range(n):
            noop(1, 2, 3)

    def guard():
        for _ in range(n):
            _build.launch_on(t, noop, 1, 2, 3)

    def exchange():
        for _ in range(n):
            prev = torch.cuda._exchange_device(t.device.index)
            try:
                noop(1, 2, 3)
            finally:
                torch.cuda._maybe_exchange_device(prev)

    def context():
        for _ in range(n):
            with torch.cuda.device(t.device):
                noop(1, 2, 3)

    us = {}
    turns = (("bare", bare), ("guard", guard), ("exchange", exchange),
             ("context", context))
    for name, fn in turns + turns[::-1]:
        t0 = time.perf_counter()
        fn()
        us[name] = us.get(name, 0.0) + (time.perf_counter() - t0) * 1e6 / (
            2 * n)
    guarded = _build.launch_on

    def unguarded(t, entry, *args):
        return entry(*args)

    select_ms = {"guarded": [], "bare": []}
    for name in ("guarded", "bare", "bare", "guarded") * 2:
        _build.launch_on = guarded if name == "guarded" else unguarded
        try:
            select_ms[name].append(time_ms(
                torch, lambda: rd.select_heads(*row, k)))
        finally:
            _build.launch_on = guarded
    log(f"[guard] the device guard around a call, {torch.cuda.device_count()}"
        f" card(s): {us['guard'] - us['bare']:.3f} us (its two exchanges, "
        f"as with several cards: {us['exchange'] - us['bare']:.3f} us; "
        f"torch.cuda.device's context manager: "
        f"{us['context'] - us['bare']:.3f} us), host clock; select "
        f"on the service's member row ({row[0].shape[0]} x "
        f"{row[0].shape[1]}, k = {k}) back to back, 8 turns: " + "; ".join(
            f"{name} median {sorted(v)[len(v) // 2]:.4f} ms ("
            + ", ".join(f"{x:.4f}" for x in v) + ")"
            for name, v in select_ms.items()))


# --- phase 5: the serving front-end --------------------------------------------

#: the modelled client reply per served decision, as the reference's
#: serving benchmark models it (``benchmarks/serve_bench.py``)
REPLY_S = 0.001
#: the reference benchmark's own claims for 4 workers over the daemon
FRONTEND_CLAIMS = {"speedup": 3.0, "efficiency": 0.7}


def _frontend_leg(torch, rd, make_service, store, market, subs, warm,
                  workers, label):
    """One threaded front-end run over the recorded market: warm, then
    the launch counts set to 0, the submissions served, the counts read.
    Returns ``(submissions/s, service, front-end, counts)``."""
    from repro_torch.market import (JournalReplayer, RecordedPriceFeed,
                                    ServeFrontend)
    svc = make_service()
    fe = ServeFrontend(svc, RecordedPriceFeed.loads(market),
                       workers=workers, queue_capacity=len(subs) + 1,
                       on_decision=lambda d: time.sleep(REPLY_S))
    fe.warm(warm)
    warm_snaps = fe.stats().snapshots
    torch.cuda.synchronize()
    rd.reset_launches()
    with fe:                        # shutdown raises any thread's death
        t0 = time.perf_counter()
        for sub in subs:
            fe.submit(sub)
        fe.drain(timeout=120.0)
        secs = time.perf_counter() - t0
        fe.await_ticks(timeout=120.0)
    counts = dict(rd.LAUNCHES)
    stats = fe.stats()
    published = stats.snapshots - warm_snaps
    check(stats.shed == 0 and stats.accounted
          and stats.decisions == len(subs),
          f"{label}: {stats} for {len(subs)} submissions")
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    check(audit.ok, f"{label}: journal audit failed: "
          f"{audit.mismatches[:3]}")
    check(audit.decisions == stats.decisions, f"{label}: audit saw "
          f"{audit.decisions} of {stats.decisions} decisions")
    ticks = svc.reprice_dispatches
    check(counts["scatter"] == counts["rowmin"] == counts["fold"] == ticks
          > 0, f"{label}: {counts} for {ticks} fleet ticks")
    check(0 < counts["select"] <= published + stats.forwarded,
          f"{label}: {counts['select']} select launches for {published} "
          f"snapshots and {stats.forwarded} forwards")
    for name in ("rowmin_row", "fold_col", "select_rounds", "select_sort"):
        check(counts[name] == 0, f"{label}: {name} launched "
              f"{counts[name]} times")
    tput = len(subs) / secs
    log(f"[frontend] {label}: {len(subs)} submissions in {secs:.3f} s = "
        f"{tput:.1f} submissions/s; {stats.ticks} ticks, {ticks} fleet "
        f"ticks, {published} snapshots, {stats.forwarded} forwards; "
        f"launches scatter {counts['scatter']} rowmin {counts['rowmin']} "
        f"fold {counts['fold']} select {counts['select']} (routes "
        f"{len(fe.snapshot.entries)}); audit ok ({audit.decisions} "
        f"decisions, {len(audit.drift)} within-contract drift records)")
    return tput, svc, fe, counts


def snapshot_turns(svc, fe, turns=50):
    """The snapshot build's heads, two ways in turns on one fleet at one
    price epoch: every route through ``rank_heads`` (one ``select``
    launch) and route by route through ``rank_head`` (one launch each).
    The head cache is emptied before each build, so each one launches.
    Returns mean ms of each."""
    routes = list(fe.snapshot.entries)
    k = fe.top_k
    one = [[], []]
    for _ in range(turns):
        got = []
        for i, build in enumerate((
                lambda: svc.rank_heads(routes, k=k),
                lambda: [svc.rank_head(*r, k=k) for r in routes])):
            svc._head_cache.clear()
            t0 = time.perf_counter()
            got.append(build())
            one[i].append(time.perf_counter() - t0)
        check(got[0] == got[1],
              "snapshot turns: rank_heads differs from per-route rank_head")
    return tuple(sum(v) / len(v) * 1e3 for v in one), len(routes)


def phase_frontend(torch, np, seed, service, store, card, errs,
                   n_subs=1_000, n_ticks=100, device="cuda"):
    """Phase 4's store and catalog behind ``ServeFrontend`` at 1 and 4
    workers and behind the daemon, on one recorded market (100 ticks, 1%
    of prices a tick) and one list of submissions, each decision followed
    by a 1 ms modelled client reply.  Then ``select`` at the snapshot
    build's shape (the fleet's member rows), against its plain version
    and timed."""
    from repro_torch.kernels import rank_delta as rd
    from repro_torch.market import (JournalReplayer, RecordedPriceFeed,
                                    SelectionDaemon, SimulatedSpotFeed,
                                    Tick, record_feed, synthetic_stream)
    from repro_torch.selector import PriceTable, SelectionService
    base = dict(service.price_snapshot()[1])
    market = record_feed(SimulatedSpotFeed(base, seed=seed + 4,
                                           change_fraction=0.01), n_ticks)
    subs = list(synthetic_stream(store.job_ids, n_subs, seed=seed + 4,
                                 tick_fraction=0.0))
    warm = list(dict.fromkeys(subs))

    def make_service():
        return SelectionService(service.catalog, store, PriceTable(base),
                                backend="torch_fused", device=device,
                                serve_top_k=10)

    # what a modelled reply takes on this host
    naps = []
    for _ in range(200):
        t0 = time.perf_counter()
        time.sleep(REPLY_S)
        naps.append(time.perf_counter() - t0)
    reply_ms = sum(naps) / len(naps) * 1e3
    # the daemon: one thread ticks, serves and replies, a tick every
    # n_subs / n_ticks submissions
    svc = make_service()
    daemon = SelectionDaemon(svc, RecordedPriceFeed.loads(market))
    every = max(1, n_subs // n_ticks)
    ticked = 0
    t0 = time.perf_counter()
    for i, sub in enumerate(subs):
        if ticked < n_ticks and i % every == 0:
            daemon.handle(Tick())
            ticked += 1
        if daemon.handle(sub) is not None:
            time.sleep(REPLY_S)
    while ticked < n_ticks:
        daemon.handle(Tick())
        ticked += 1
    secs = time.perf_counter() - t0
    audit = JournalReplayer(store, daemon.journal_dump()).audit()
    check(audit.ok and audit.decisions == n_subs,
          f"frontend phase daemon: audit {audit.ok}, "
          f"{audit.decisions} decisions")
    daemon_tput = n_subs / secs
    h = svc.metrics.snapshot()["histograms"]
    log(f"[frontend] daemon: {n_subs} submissions in {secs:.3f} s = "
        f"{daemon_tput:.1f} submissions/s ({n_ticks} ticks, a "
        f"{REPLY_S * 1e3:g} ms reply sleeps {reply_ms:.4f} ms here); audit "
        f"ok; spans (count x mean ms): " + ", ".join(
            f"{name} {v['count']} x {v['sum'] * 1e3 / v['count']:.4f}"
            for name, v in h.items()
            if v["count"] and name in ("serve.submit", "tick.total",
                                       "rank.build")))
    tput1, _, _, _ = _frontend_leg(torch, rd, make_service, store, market,
                                   subs, warm, 1, "1 worker")
    tput4, svc4, fe4, counts = _frontend_leg(
        torch, rd, make_service, store, market, subs, warm, 4, "4 workers")
    speedup, eff = tput4 / daemon_tput, tput4 / (4 * tput1)
    log(f"[frontend] 4 workers: {speedup:.2f}x the daemon (the reference "
        f"benchmark claims >= {FRONTEND_CLAIMS['speedup']:g}x), scaling "
        f"efficiency 1 -> 4 workers {eff:.2f} (claims >= "
        f"{FRONTEND_CLAIMS['efficiency']:g}); recorded, not gated: both "
        f"are host-bound ({card})")
    h = svc4.metrics.snapshot()["histograms"]
    build = h["snapshot.build"]
    log(f"[frontend] 4 workers spans (count x mean ms): " + ", ".join(
        f"{name} {v['count']} x {v['sum'] * 1e3 / v['count']:.4f}"
        for name, v in h.items()
        if v["count"] and name in ("snapshot.build", "tick.total",
                                   "tick.poll", "tick.reprice",
                                   "reprice.dispatch", "serve.worker")))
    (batched_ms, per_route_ms), n_routes = snapshot_turns(svc4, fe4)
    log(f"[frontend] snapshot.build {build['count']} x "
        f"{build['sum'] * 1e3 / build['count']:.4f} ms in the run; heads "
        f"of {n_routes} routes in turns on one fleet: rank_heads (one "
        f"select) {batched_ms:.4f} ms, per-route rank_head ({n_routes} "
        f"selects) {per_route_ms:.4f} ms ({card})")
    # select at the snapshot build's shape: the member rows' span
    fleet = svc4._batched
    slots = sorted(fleet._slots.values())
    lo, hi = slots[0], slots[-1] + 1
    rows = (fleet.d_scores[lo:hi], fleet._d_finite[lo:hi])
    check_select(torch, *rows, fe4.top_k, "snapshot build rows", errs)
    head = time_head(torch, *rows, fe4.top_k)
    shape = f"{hi - lo} x {rows[0].shape[1]}, k={fe4.top_k}"
    log_time("select (snapshot build)", head, shape)
    return {"daemon": daemon_tput, "w1": tput1, "w4": tput4,
            "launches": counts, "head": head, "shape": (hi - lo,
                                                        rows[0].shape[1])}


# --- phase 6: Flora's core and the turbulence sweep ----------------------------

#: the reference turbulence benchmark's recorded calm-point figure
CALM_MAX_DEVIATION = 0.0645
FIXTURE = ROOT / "examples" / "data" / "gcp_spot_prices.csv"


#: how far a ``torch_fused`` or ``torch_sharded`` point's deviations may sit
#: from numpy's: the CPU tests' bound (``tests/test_torch_turbulence.py``)
SWEEP_REL, SWEEP_ABS = 1e-4, 1e-12
#: the sweep's backends, and the shards ``torch_sharded`` takes on the card
SWEEP_BACKENDS = ("numpy", "torch_fused", "torch_sharded")
SWEEP_SHARDS = 2


def phase_turbulence(torch, np, rd, seed, errs, device="cuda",
                     n_events=400, stream_seed=3, market_seed=11):
    """The turbulence benchmark's universe (the paper's trace at seed 0,
    18 jobs x 10 configs), every preset on numpy, on ``torch_fused`` and
    on ``torch_sharded`` at 2 shards on the card, the B1 kernels and
    ``select`` held against their plain versions on each ``torch_fused``
    fleet of the sweep, and the quickstart's outcome through the port's
    core."""
    from repro_torch.core import Flora, JobClass, costmodel, evaluate, \
        spark_sim
    from repro_torch.core.evaluate import turbulence_curves
    from repro_torch.market import (PollingPriceFeed, RecordedPriceFeed,
                                    make_market, record_feed, run_point,
                                    run_sweep, synthetic_stream)
    from repro_torch.selector import (GcpVmCatalog, PriceTable,
                                      ProfilingStore, SelectionService)
    trace = spark_sim.generate_trace(seed=0)
    price = costmodel.LinearPriceModel()
    store = ProfilingStore.from_trace(trace)
    catalog = GcpVmCatalog(trace.configs, price)
    base = dict(PriceTable.from_catalog(catalog).items())
    events = list(synthetic_stream([j.name for j in trace.jobs], n_events,
                                   seed=stream_seed, tick_fraction=0.15))
    services = []

    def factory(backend):
        on = [device] * SWEEP_SHARDS if backend == "torch_sharded" \
            else device
        svc = SelectionService(catalog, store,
                               PriceTable.from_catalog(catalog),
                               backend=backend, device=on)
        services.append(svc)
        return svc

    regen = record_feed(make_market("calm", base, seed=market_seed,
                                    ticks=40).raw, 40)
    check(regen == FIXTURE.read_text(),
          "calm preset does not regenerate gcp_spot_prices.csv")
    log(f"[turbulence] calm preset regenerates {FIXTURE.name} byte for "
        f"byte ({len(regen)} bytes)")
    calm = {}
    for backend in SWEEP_BACKENDS:
        point = run_point(factory(backend), RecordedPriceFeed.load(FIXTURE),
                          events, preset_name="calm",
                          truth=RecordedPriceFeed.load(FIXTURE))
        calm[backend] = point.mean_deviation
        check(point.audit_ok, f"calm fixture on {backend}: audit failed")
        check(point.mean_deviation <= CALM_MAX_DEVIATION,
              f"calm fixture on {backend}: mean deviation "
              f"{point.mean_deviation} > {CALM_MAX_DEVIATION}")
        check(backend != "torch_sharded" or calm[backend] == calm["numpy"],
              f"calm fixture on torch_sharded: mean deviation "
              f"{calm[backend]!r} != numpy's {calm['numpy']!r}")
        log(f"[turbulence] calm fixture on {backend}: mean deviation "
            f"{point.mean_deviation!r} (<= {CALM_MAX_DEVIATION}), "
            f"{point.decisions} decisions, {point.epochs} epochs, audit ok")
    del services[:]
    rd.reset_launches()
    t0 = time.perf_counter()
    points = run_sweep(factory, base, events, backends=SWEEP_BACKENDS,
                       seed=market_seed)
    secs = time.perf_counter() - t0
    counts = dict(rd.LAUNCHES)
    fused = [s for s in services if s.backend == "torch_fused"]
    sharded = [s for s in services if s.backend == "torch_sharded"]
    # one scatter, rowmin and fold a fleet tick, a shard on torch_sharded
    ticks = sum(s.reprice_dispatches for s in fused) + SWEEP_SHARDS * sum(
        s.reprice_dispatches for s in sharded)
    for p in points:
        check(p.audit_ok, f"turbulence {p.preset} on {p.backend}: audit "
              f"failed ({p.audit_mismatches} mismatches)")
    check(counts["scatter"] == counts["rowmin"] == counts["fold"] == ticks
          > 0, f"turbulence: {counts} for {ticks} fleet ticks")
    for name in ("rowmin_row", "fold_col", "select_rounds"):
        check(counts[name] == 0, f"turbulence: {name} launched")
    for backend, curve in turbulence_curves(points).items():
        log(f"[turbulence] curve {backend}: " + ", ".join(
            f"{p.preset} {p.mean_deviation!r} (truth "
            f"{p.truth_mean_deviation!r})" for p in curve))
    by = {(p.preset, p.backend): p for p in points}
    worst = 0.0
    for name, backend in {(n, b) for n, b in by if b != "numpy"}:
        for attr in ("mean_deviation", "truth_mean_deviation"):
            got = getattr(by[name, backend], attr)
            want = getattr(by[name, "numpy"], attr)
            check(abs(got - want) <= max(SWEEP_REL * abs(want), SWEEP_ABS),
                  f"turbulence {name}: {backend} {attr} {got!r} vs numpy "
                  f"{want!r} beyond rel {SWEEP_REL}")
            worst = max(worst, abs(got - want) / max(abs(want), 1e-300))
    # the kernels at the sweep's own shape, on each fleet it ticked
    rng = np.random.default_rng(seed + 6)
    fleets = [s._batched for s in fused if s._batched is not None]
    check(fleets, "turbulence: no torch_fused fleet was built")
    for i, fleet in enumerate(fleets):
        J, C = fleet.d_hours.shape
        check_kernels(torch, fleet_tick(torch, np, rng, fleet),
                      f"turbulence {J}x{C} fleet {i}", 10, errs)
    log(f"[turbulence] {len(points)} points in {secs:.3f} s, every audit "
        f"ok; torch_fused and torch_sharded vs numpy mean deviation: worst "
        f"relative difference {worst:.3g} (<= {SWEEP_REL}); {len(fleets)} "
        f"fleets' kernels against their plain versions ok; B1 on the card: "
        f"scatter {counts['scatter']}, rowmin {counts['rowmin']}, fold "
        f"{counts['fold']} launches for {ticks} fleet ticks and shard ticks "
        f"(1 each; torch_sharded {SWEEP_SHARDS} shards) over "
        f"{sum(s.price_epoch for s in fused + sharded)} price epochs; "
        f"select {counts['select']}")
    # one quote stream, two transports, on the card's backend
    market = make_market("eviction_storm", base, seed=market_seed,
                         ticks=sum(1 for e in events
                                   if type(e).__name__ == "Tick"))
    text = record_feed(market.raw, market.ticks)
    recorded = run_point(factory("torch_fused"),
                         RecordedPriceFeed.loads(text), events,
                         preset_name="eviction_storm",
                         truth=RecordedPriceFeed.loads(text))
    replay = RecordedPriceFeed.loads(text)
    polled = run_point(factory("torch_fused"), PollingPriceFeed(
        lambda t: {"quotes": [{"config_id": d.config_id, "price": d.price}
                              for d in replay.poll(t)]}), events,
        preset_name="eviction_storm", feed_kind="polled",
        truth=RecordedPriceFeed.loads(text))
    check(recorded.evaluation.summary() == polled.evaluation.summary()
          and recorded.decisions == polled.decisions
          and recorded.epochs == polled.epochs
          and recorded.audit_ok and polled.audit_ok,
          "torch_fused: the polled feed's evaluation differs from the "
          "recorded feed's")
    log(f"[turbulence] torch_fused polled == recorded: mean deviation "
        f"{polled.mean_deviation!r}, {polled.decisions} decisions")
    # the quickstart through the port's core
    flora = Flora(trace, price)
    picks = {k: flora.select(k).index for k in (JobClass.A, JobClass.B)}
    check(picks == {JobClass.A: 9, JobClass.B: 1},
          f"quickstart picks {picks}, expected A -> #9, B -> #1")
    rows = {r.name: r for r in evaluate.table4(trace, price)}
    check(all(rows["Flora"].mean_norm_cost < r.mean_norm_cost
              for n, r in rows.items() if n != "Flora"),
          "Table IV: Flora is not the best row")
    log(f"[core] quickstart through the port: class A -> #"
        f"{picks[JobClass.A]}, class B -> #{picks[JobClass.B]}; Table IV "
        f"Flora mean normalized cost {rows['Flora'].mean_norm_cost!r} "
        f"(best of {len(rows)} rows)")
    return counts


# --- phase 7: the LM kernels against their plain versions ---------------------

#: (B, Tq, Tk, H, G, D, causal, window): GQA, MQA, bidirectional,
#: windowed, ragged T (the engine's 12-token prompts, 100, 130), every head
#: size the kernel is built for, and bidirectional calls with Tq != Tk
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 64, 64, 8, 1, 32, True, None),
    (1, 96, 96, 2, 2, 16, False, None),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 12, 12, 16, 8, 128, True, None),
    (1, 100, 100, 4, 2, 80, True, 16),
    (1, 130, 130, 2, 1, 128, False, None),
    (1, 200, 200, 4, 4, 64, True, 48),
    (1, 100, 100, 4, 1, 64, True, None),
    (1, 1000, 1000, 4, 2, 128, True, 300),
    # D = 80: stablelm-3b's prefill (MHA), GQA, ragged T = 100, a window
    # over T = 1,000, T = 1 and T = 129 (one past a 128-row tile)
    (4, 1024, 1024, 32, 32, 80, True, None),
    (2, 256, 256, 8, 2, 80, True, None),
    (1, 100, 100, 4, 4, 80, True, None),
    (1, 1000, 1000, 4, 2, 80, True, 300),
    (2, 1, 1, 4, 4, 80, True, None),
    (1, 129, 129, 4, 2, 80, False, None),
    # D = 256 (its own block shape: 64-row tiles): recurrentgemma-9b's
    # prefill (MQA), its 4,096-token prompt past the 2,048 window, GQA,
    # T = 1, 100, 129 (bidirectional) and a window over T = 1,000
    (4, 1024, 1024, 16, 1, 256, True, None),
    (1, 4096, 4096, 16, 1, 256, True, 2048),
    (2, 256, 256, 8, 2, 256, True, None),
    (2, 1, 1, 4, 1, 256, True, None),
    (1, 100, 100, 4, 1, 256, True, None),
    (1, 129, 129, 4, 2, 256, False, None),
    (1, 1000, 1000, 4, 1, 256, True, 300),
    # bidirectional with Tq != Tk: seamless-m4t-large-v2's encoder over
    # 4,096 frames, its decoder's 1,024-token prompt over them (cross
    # prefill) and one decode token over them (cross decode); a ragged
    # source, Tk < Tq, one token at D = 256 and one past a tile at D = 80
    (4, 4096, 4096, 16, 16, 64, False, None),
    (4, 1024, 4096, 16, 16, 64, False, None),
    (4, 1, 4096, 16, 16, 64, False, None),
    (2, 7, 1000, 16, 16, 64, False, None),
    (1, 100, 37, 4, 2, 128, False, None),
    (2, 1, 130, 4, 1, 256, False, None),
    (1, 129, 300, 4, 4, 80, False, None),
    # D = 160 (the wide block's 64-row tiles; two 64-column blocks and a
    # 32-column tail): pixtral-12b's prefill (1,024 patches and 1,024
    # tokens, GQA 32 over 8), GQA at T = 256, ragged T = 100, a window
    # over T = 1,000, T = 1, T = 65 (one past a 64-row tile) and a
    # bidirectional call with Tq != Tk
    (4, 2048, 2048, 32, 8, 160, True, None),
    (2, 256, 256, 8, 2, 160, True, None),
    (1, 100, 100, 4, 4, 160, True, None),
    (1, 1000, 1000, 4, 2, 160, True, 300),
    (2, 1, 1, 4, 4, 160, True, None),
    (1, 65, 65, 4, 2, 160, True, None),
    (1, 129, 300, 4, 4, 160, False, None),
]
#: (B, T, H, N): a decode step, ragged T, both model head sizes, and one
#: step past the split kernel's 16-step chunk
WKV_CASES = [(2, 1, 3, 64), (4, 1, 40, 64), (1, 37, 2, 64), (2, 100, 2, 16),
             (1, 64, 4, 32), (2, 17, 3, 64)]
#: (B, T, H, N) with RWKV-6's own decay range, w = exp(-exp(x)) for x
#: uniform in [-8, 2] (w from about 6e-4 to just below 1)
WKV_STRONG_CASES = [(2, 17, 3, 64), (1, 1025, 2, 64), (2, 50, 2, 16)]
#: the end-to-end bound on kernel vs plain prefill logits in bf16 (relative
#: L2; the reason is at its check in ``phase_serve``)
REL_L2_TOL = 0.1
#: the reference kernel tests' tolerances
ATTN_TOL = {"float32": (2e-5, 1e-2), "bfloat16": (2e-2, 1e-2)}
#: a bidirectional case is also held to this relative L2 error over its
#: whole output.  With random q, k and v an output row averages about Tk
#: values of v, so |o| is about sqrt(e / Tk): at Tk = 4,096 near 0.026, on
#: the scale of ATTN_TOL's bf16 atol, which alone would pass a kernel that
#: skipped a key tile.  bf16 rounding of the output costs about 2^-9 of
#: it; a skipped tile of n keys about sqrt(n / Tk).  fp32 (the split
#: kernel): its P V sum, carried in the tensor cores' fp32 accumulator
#: (coarser than fp32 FMAs) across Tk / 32 key tiles, sat 2.7e-5 from
#: the plain version at Tk = 4,096 on an H100, the scalar kernel 1.2e-6
ATTN_REL_L2 = {"bfloat16": 1e-2, "float32": 1e-4}
#: the planted fault that shows ``ATTN_REL_L2`` has the power to fail a
#: kernel: the plain version with its last this many keys dropped (the
#: smallest key tile of any head size, D = 256's) must fail it
DROPPED_KEYS = 64
WKV_TOL = (1e-4, 1e-3)
#: the record's LM entries: ``flash_attention`` is the tensor-core kernel
#: at qwen3-1.7b's D = 128, ``flash_attention_d80`` the same kernel at
#: stablelm-3b's D = 80, ``flash_attention_mha128`` at deepseek-7b's (MHA,
#: D = 128), ``flash_attention_mqa`` at granite-20b's (48 query heads on
#: one KV head), ``flash_attention_d64`` at qwen3-moe-30b-a3b's (D = 64),
#: ``flash_attention_llama4`` at the llama4 check's (2 x 1,024, 40 heads
#: over 8), ``flash_attention_d256`` at recurrentgemma-9b's (D = 256, 16
#: query heads on one KV head), ``flash_attention_scalar`` the scalar
#: kernel (fp32) at qwen3-1.7b's shape and ``flash_attention_scalar_d256``
#: at recurrentgemma-9b's; ``flash_attention_enc``, ``_dec``, ``_cross``
#: and ``_xdec`` the tensor-core kernel at seamless-m4t-large-v2's four
#: shapes (``ENCDEC_MODES``); ``flash_attention_d160`` the tensor-core
#: kernel and ``flash_attention_scalar_d160`` the scalar one (fp32) at
#: pixtral-12b's (D = 160, 32 query heads on 8 KV heads, 1,024 patches
#: and 1,024 tokens a sequence)
_ATTN = dict(op="flash_attention",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:28")
LM_KERNELS = {
    "flash_attention": _ATTN,
    "flash_attention_d80": _ATTN,
    "flash_attention_mha128": _ATTN,
    "flash_attention_mqa": _ATTN,
    "flash_attention_d64": _ATTN,
    "flash_attention_llama4": _ATTN,
    "flash_attention_d256": _ATTN,
    "flash_attention_scalar": _ATTN,
    "flash_attention_scalar_d256": _ATTN,
    "flash_attention_enc": _ATTN,
    "flash_attention_dec": _ATTN,
    "flash_attention_cross": _ATTN,
    "flash_attention_xdec": _ATTN,
    "flash_attention_d160": _ATTN,
    "flash_attention_scalar_d160": _ATTN,
    "flash_attention_split": _ATTN,
    "flash_attention_split_d256": _ATTN,
    "flash_attention_split_d160": _ATTN,
    "wkv6": dict(op="wkv6", source="src/repro_torch/csrc/wkv6_scan.cu",
                 replaces="src/repro/kernels/rwkv6_scan.py:25"),
    # the backward of the training path (phase 9): XLA's autodiff of the
    # reference's chunked recurrence, no Pallas kernel
    "wkv6_bwd": dict(op="wkv6_bwd",
                     source="src/repro_torch/csrc/wkv6_scan.cu",
                     replaces="src/repro/models/recurrent.py:206"),
}
#: (model, record entry of the kernel its path runs), in serving order
SERVED = [("qwen3-1.7b", "flash_attention"),
          ("stablelm-3b", "flash_attention_d80"),
          ("rwkv6-3b", "wkv6"),
          ("deepseek-7b", "flash_attention_mha128"),
          ("granite-20b", "flash_attention_mqa"),
          ("qwen3-moe-30b-a3b", "flash_attention_d64"),
          ("recurrentgemma-9b", "flash_attention_d256"),
          ("seamless-m4t-large-v2", "flash_attention_enc"),
          ("pixtral-12b", "flash_attention_d160")]
#: the encoder-decoder's attention calls, one record entry each: (Tq, Tk,
#: causal) as functions of the prompt length T and the source length F,
#: and the calls a prefill ("prefill") or a decode step ("decode") makes
#: of each, one a layer of its stack
ENCDEC_MODES = {
    "flash_attention_enc": (lambda T, F: (F, F, False), "prefill"),
    "flash_attention_dec": (lambda T, F: (T, T, True), "prefill"),
    "flash_attention_cross": (lambda T, F: (T, F, False), "prefill"),
    "flash_attention_xdec": (lambda T, F: (1, F, False), "decode"),
}
#: the encoder-decoder's fp32 check: 2 encoder and 2 decoder layers at
#: full width, a source ragged against every tile, 6 prompt tokens and 8
#: decode steps
ENCDEC_PARITY_LAYERS, ENCDEC_PARITY_FRAMES = 2, 100
ENCDEC_PARITY_STEPS = 8
#: the backwards' counts, none of which a serving phase may move
NO_BWD = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
          "flash_attention_bwd_split": 0,
          "flash_attention_bwd_scalar": 0, "wkv6_bwd": 0,
          "wkv6_bwd_block": 0}
#: the record entries whose ``time_lm_kernel`` also times the split
#: kernel (what fp32 takes) and the scalar one (its yardstick, by name) in
#: fp32 at their path's shape (their entries' names)
FP32_ENTRIES = {
    "flash_attention": ("flash_attention_split", "flash_attention_scalar"),
    "flash_attention_d256": ("flash_attention_split_d256",
                             "flash_attention_scalar_d256"),
    "flash_attention_d160": ("flash_attention_split_d160",
                             "flash_attention_scalar_d160")}
#: the vision-language model's fp32 check: patches a sequence ahead of
#: its prompt, ragged against the 64-row tile
VLM_PARITY_PATCHES = 100
#: the windowed model's long-prompt check: a prompt past its window (the
#: ring write with T > S), then decode steps (the ring wraps); and the
#: fp32 4-layer check's prompt and steps there
WINDOW_PROMPT, WINDOW_STEPS = 4096, 8
WINDOW_PARITY_PROMPT, WINDOW_PARITY_STEPS = 2100, 8
#: the llama4 check: full width, this many layers (one dense, one MoE)
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2
#: the capacity factor of the 4-layer fp32 check on MoE models (the
#: reference's decode-parity test's; the reason is at the check)
MOE_PARITY_CAPACITY = 64.0
#: the depths of the MoE kernel-vs-plain account (``moe_account``), and
#: the depth held to ``REL_L2_TOL`` with the routes free (the reason is at
#: the check in ``phase_serve``)
MOE_DEPTHS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48)
MOE_CHECK_LAYERS = 1


def allclose(torch, a, b, atol, rtol) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def attn_inputs(torch, B, T, H, G, D, dtype, seed, dev="cuda", Tk=None):
    """q (B, T, H, D) and k, v (B, Tk, G, D), Tk = T unless given."""
    Tk = T if Tk is None else Tk
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, T, H, D), (B, Tk, G, D), (B, Tk, G, D)))


def wkv_inputs(torch, B, T, H, N, dtype, seed, random_state=True,
               dev="cuda", strong=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device=dev
                           ).to(dtype) for _ in range(3))
    if strong:      # RWKV-6's decay: w = exp(-exp(x)), x in [-8, 2]
        x = torch.rand((B, T, H, N), generator=gen, device=dev) * 10 - 8
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(torch.randn((B, T, H, N), generator=gen,
                                      device=dev)) * 0.5 + 0.45
    u = torch.randn((H, N), generator=gen, device=dev) * 0.5
    s0 = torch.randn((B, H, N, N), generator=gen, device=dev) \
        * float(random_state)
    return r, k, v, w, u, s0


def check_attention(torch, q, k, v, causal, window, label, errs=None,
                    name=None):
    """The kernel :func:`flash_attention.variant` names against the plain
    version; the error goes to ``errs`` under the record entry ``name``
    (default: the variant's entry at qwen3-1.7b's shape)."""
    from repro_torch.kernels import flash_attention as fa
    kind = fa.variant(q.dtype, q.shape[-1])
    before = fa.LAUNCHES[f"flash_attention_{kind}"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    check(fa.LAUNCHES[f"flash_attention_{kind}"] == before + 1,
          f"{label}: the {kind} kernel did not launch")
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    sync(torch, q.device)
    atol, rtol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    err = max_err(torch, got.float(), want.float())
    check(got.dtype == q.dtype and got.shape == want.shape,
          f"{label}: flash attention returned {got.dtype} {tuple(got.shape)}")
    check(allclose(torch, got, want, atol, rtol),
          f"{label}: flash attention outside atol {atol} rtol {rtol} "
          f"(max |err| {err:.3g})")
    limit = ATTN_REL_L2.get(str(q.dtype).split(".")[-1])
    if limit is not None and not causal:
        check_rel_l2(torch, q, k, v, got, want, limit, label)
    if errs is not None:
        name = name or {"tc": "flash_attention",
                        "split": "flash_attention_split"}.get(
                            kind, "flash_attention_scalar")
        errs[name] = max(errs[name], err)
    return err


def check_rel_l2(torch, q, k, v, got, want, limit, label) -> None:
    """A bidirectional call's output within ``limit`` relative L2 of the
    plain version's; where there are more than :data:`DROPPED_KEYS` keys,
    also the plain version with its last :data:`DROPPED_KEYS` keys dropped,
    which must fail the limit (and the log says whether it would pass
    ``ATTN_TOL`` alone)."""
    from repro_torch.kernels import flash_attention as fa
    rel = rel_l2(got, want)
    check(rel < limit, f"{label}: flash attention relative L2 {rel:.3g} "
          f">= {limit}")
    Tk = k.shape[1]
    if Tk <= DROPPED_KEYS:
        log(f"[lm-parity] {label}: relative L2 {rel:.3g} < {limit} ok")
        return
    cut = Tk - DROPPED_KEYS
    fault = fa.attention_ref(q, k[:, :cut], v[:, :cut], causal=False)
    rel_fault = rel_l2(fault, want)
    check(rel_fault >= limit, f"{label}: {DROPPED_KEYS} dropped keys move "
          f"the output by {rel_fault:.3g} relative L2, under {limit}")
    atol, rtol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    log(f"[lm-parity] {label}: relative L2 {rel:.3g} < {limit} ok; the last "
        f"{DROPPED_KEYS} of {Tk} keys dropped: {rel_fault:.3g} (fails it; "
        f"max |err| {max_err(torch, fault.float(), want.float()):.3g}, "
        f"within atol {atol} rtol {rtol}: "
        f"{allclose(torch, fault, want, atol, rtol)})")
    del fault


def check_wkv(torch, args, label, errs=None):
    """The split kernel (one launch) against the plain version; returns
    the larger max |err| of y and s_T."""
    from repro_torch.kernels import rwkv6_scan as wk
    before = dict(wk.LAUNCHES)
    y, sT = wk.wkv6(*args)
    check({n: wk.LAUNCHES[n] - before[n] for n in before}
          == {"wkv6": 1, "wkv6_seq": 0, "wkv6_bwd": 0, "wkv6_bwd_block": 0},
          f"{label}: wkv6 did not launch the split kernel once")
    y_p, s_p = wk.wkv6_scan_ref(*args)
    sync(torch, y.device)
    atol, rtol = WKV_TOL
    err = max(max_err(torch, y, y_p), max_err(torch, sT, s_p))
    check(allclose(torch, y, y_p, atol, rtol)
          and allclose(torch, sT, s_p, atol, rtol),
          f"{label}: wkv6 outside atol {atol} rtol {rtol} (max |err| "
          f"{err:.3g})")
    if errs is not None:
        errs["wkv6"] = max(errs["wkv6"], err)
    return err


def with_routes(torch, fn, replay=None):
    """``fn()`` with every MoE layer's router call recorded: returns (fn's
    result, [expert ids (B, T, K) of each MoE layer, in depth order]).
    With ``replay`` (such a list from another pass) each layer takes those
    experts in place of its own top K, at its own gates for them, so the
    pass differs from the one recorded in its continuous values alone."""
    from repro_torch.models import layers as L
    routes, route = [], L.moe_route

    def recording(p, cfg, x):
        logits, gates, idx = route(p, cfg, x)
        if replay is not None:
            idx = replay[len(routes)]
            K = cfg.experts_per_token
            probs = torch.sigmoid(logits) if K == 1 \
                else torch.softmax(logits, -1)
            gates = probs.gather(-1, idx)
            if K > 1:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        routes.append(idx)
        return logits, gates, idx
    L.moe_route = recording
    try:
        return fn(), routes
    finally:
        L.moe_route = route


@contextlib.contextmanager
def first_layers(model, n):
    """``model`` cut to its first ``n`` layers for the ``with`` block (the
    same weights; the state it makes has ``n`` layers too)."""
    plans, blocks = model.plans, model.blocks
    model.plans, model.blocks = plans[:n], blocks[:n]
    try:
        yield model
    finally:
        model.plans, model.blocks = plans, blocks


def phase_lm_parity(torch, dev="cuda"):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for case in ATTN_CASES:
            B, Tq, Tk, H, G, D, causal, window = case
            q, k, v = attn_inputs(torch, B, Tq, H, G, D, dtype,
                                  B + Tq + H + G + D, dev, Tk=Tk)
            err = check_attention(torch, q, k, v, causal, window,
                                  f"attn {case} {name}")
            log(f"[lm-parity] flash attention {name} "
                f"({fa.variant(dtype, D)}) B={B} Tq={Tq} Tk={Tk} H={H} G={G} "
                f"D={D} causal={causal} window={window}: max |err| "
                f"{err:.3g} ok")
            del q, k, v
        for case in WKV_CASES:
            args = wkv_inputs(torch, *case, dtype, sum(case), dev=dev)
            err = check_wkv(torch, args, f"wkv {case} {name}")
            log(f"[lm-parity] wkv6 {name} B,T,H,N={case}: max |err| "
                f"{err:.3g} ok")
        for case in WKV_STRONG_CASES:
            args = wkv_inputs(torch, *case, dtype, sum(case), dev=dev,
                              strong=True)
            err = check_wkv(torch, args, f"wkv strong decay {case} {name}")
            log(f"[lm-parity] wkv6 {name} strong decays (w from "
                f"{float(args[3].min()):.2g} to {float(args[3].max()):.6f}) "
                f"B,T,H,N={case}: max |err| {err:.3g} ok")
        # the two-call state carry
        r, k, v, w, u, s0 = wkv_inputs(torch, 1, 64, 2, 64, dtype, 11,
                                       dev=dev)
        y_full, s_full = wk.wkv6_scan_ref(r, k, v, w, u, s0)
        halves = [tuple(a[:, sl].contiguous() for a in (r, k, v, w))
                  for sl in (slice(0, 29), slice(29, 64))]
        y1, s_mid = wk.wkv6(*halves[0], u, s0)
        y2, s_T = wk.wkv6(*halves[1], u, s_mid)
        sync(torch, dev)
        check(allclose(torch, torch.cat([y1, y2], 1), y_full, *WKV_TOL)
              and allclose(torch, s_T, s_full, *WKV_TOL),
              f"wkv6 {name}: state carry across two calls differs")
        log(f"[lm-parity] wkv6 {name} state carry over 29 + 35 steps ok")


# --- phase 8: the dry run, and the decode fleet's placement from it ----------

#: the report's cells: the architectures and shapes the placement ranks
DRYRUN_ARCHS = ("qwen3-1.7b", "stablelm-3b", "rwkv6-3b")
DRYRUN_SHAPES = ("train_4k", "decode_32k")
#: the MoE cells of phase 8, beside the report (which they do not join):
#: expert parallelism traced on each split
DRYRUN_MOE_ARCH = "qwen3-moe-30b-a3b"


def dryrun_card_cell(path) -> None:
    """(a child process) The dry run's count of the card's training step:
    :data:`TRAIN_ARCH` at full width and depth, ``TRAIN_B`` x ``TRAIN_T``
    tokens, AdamW and remat as phase 9b trains it, the head over
    :data:`TRAIN_VOCAB_CHUNK` columns, on a (1, 1) mesh; the cell to
    ``path``."""
    from repro_torch.launch import dryrun
    from repro_torch.models.types import ShapeSpec
    cell = dryrun.lower_cell(
        TRAIN_ARCH, "chip", multi_pod=False, mesh_shape=(1, 1),
        shape=ShapeSpec("chip", TRAIN_T, TRAIN_B, "train"),
        settings_extra={"vocab_chunk": TRAIN_VOCAB_CHUNK}, quiet=True)
    Path(path).write_text(json.dumps(cell))


def phase_dryrun(out=None):
    """Phase 8's dry run (under ``out``, default ``build/dryrun``): the
    port's CLI writes one report a split of ``mesh_options(256)``
    (``--mesh dp{d}xtp{m}``) of :data:`DRYRUN_ARCHS` x
    :data:`DRYRUN_SHAPES`, each in its own process, all started together
    with the card hidden, :func:`dryrun_card_cell` runs in a fifth, and
    :data:`DRYRUN_MOE_ARCH`'s cells of the same shapes on each split in
    one process a split (``[dryrun] moe`` lines; not in the report the
    placement and the launcher rank); every cell must be ``ok``.
    Returns (the merged report's path, the report, the card cell)."""
    import os
    from repro_torch.launch.mesh import mesh_options
    out = Path(out or ROOT / "build" / "dryrun")
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cmds = {name: [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", ",".join(DRYRUN_ARCHS),
                   "--shape", ",".join(DRYRUN_SHAPES),
                   "--mesh", name, "--out", str(out / f"{name}.json")]
            for _, name in mesh_options(256)}
    for _, name in mesh_options(256):
        cmds[f"moe-{name}"] = [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            DRYRUN_MOE_ARCH, "--shape", ",".join(DRYRUN_SHAPES), "--mesh",
            name, "--out", str(out / f"moe-{name}.json")]
    card_path = str(out / "card.json")
    cmds["card"] = [sys.executable, "-c", f"import chip_smoke; "
                    f"chip_smoke.dryrun_card_cell({card_path!r})"]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=600)
        finally:
            p.kill()
        check(p.returncode == 0, f"dry run {name}: exit {p.returncode}: "
              f"{err[-2000:]}")
    wall = time.perf_counter() - t0
    cells = [c for _, name in mesh_options(256)
             for c in json.loads((out / f"{name}.json").read_text())["cells"]]
    report = {"cells": cells}
    path = out / "report.json"
    path.write_text(json.dumps(report, indent=1))
    moe = [c for _, name in mesh_options(256) for c in json.loads(
        (out / f"moe-{name}.json").read_text())["cells"]]
    failed = [(c["arch"], c["shape"], c["mesh"], c.get("error"))
              for c in cells + moe if not c["ok"]]
    check(len(cells) == 4 * len(DRYRUN_ARCHS) * len(DRYRUN_SHAPES)
          and len(moe) == 4 * len(DRYRUN_SHAPES) and not failed,
          f"the dry run's cells that failed: {failed}")
    for c in cells + moe:
        r = c["roofline"]
        log(f"[dryrun]{' moe' if c in moe else ''} {c['arch']} {c['shape']} "
            f"{c['mesh']}: step "
            f"{r['step_s']:.6g} s, {r['dominant']} (compute "
            f"{r['compute_s']:.6g}, memory {r['memory_s']:.6g}, collective "
            f"{r['collective_s']:.6g}); {r['flops_per_device']:.6g} FLOP, "
            f"{r['hbm_bytes_per_device']:.6g} HBM bytes, "
            f"{r['wire_bytes_per_device']:.6g} wire bytes a device; trace "
            f"{c['trace_s']} s")
    card = json.loads(Path(card_path).read_text())
    log(f"[dryrun] report: {len(cells)} cells, and {len(moe)} MoE cells "
        f"beside it, {len(procs)} processes in {wall:.1f} s (no card; "
        f"CPU), written to {path}")
    return path, report, card


def phase_placement(report, dev="cuda"):
    """The decode fleet's mesh from the dry run's report through the
    port's selection service on ``torch_fused`` (on ``dev``), which must
    decide as the ``numpy`` backend does on the same report."""
    from repro_torch.core.costmodel import TpuPriceModel
    from repro_torch.core.tpu_flora import service_from_dryrun_report
    from repro_torch.serve import plan_decode_placement
    decisions = {}
    for backend, device in (("torch_fused", dev), ("numpy", "cpu")):
        service = service_from_dryrun_report(report, TpuPriceModel("spot"),
                                             backend=backend, device=device)
        decisions[backend] = plan_decode_placement(
            service, exclude_archs=("qwen3-1.7b",))
    decision = decisions["torch_fused"]
    check(decision.config_id == decisions["numpy"].config_id,
          f"placement picked {decision.config_id} on torch_fused, "
          f"{decisions['numpy'].config_id} on numpy")
    log(f"[placement] decode fleet: mesh {decision.config_id} at "
        f"{decision.hourly_cost:.2f} $/h (class {decision.job_class.value}, "
        f"torch_fused on {dev}; numpy decides the same); ranking "
        f"{[r.config_id for r in decision.ranking]}")
    return decision


def phase_launcher(report_path, dev="cuda"):
    """The training launcher with ``--auto-mesh --report``: its
    ``[flora]`` line (the mesh the selection service ranks first for
    ``train_4k``), then 2 steps of the reduced model on ``dev``."""
    import io
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(["--arch", TRAIN_ARCH, "--reduced", "--steps", "2",
                           "--auto-mesh", "--report", str(report_path),
                           "--device", dev])
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[dryrun] launcher: {line}")
    check(sum(line.startswith("[flora]") for line in lines) == 1
          and any(line.startswith("[train] done") for line in lines),
          f"the launcher printed {lines}")


def check_card_cell(cell, train, card, cfg=None):
    """(a) The dry run's count of the card's step against ``phase_train``'s
    ``FlopCounterMode`` count of a real step (within 1%), at least
    :func:`train_flops` (remat's recompute comes on top), and the
    roofline step at most the measured median step."""
    from repro_torch import configs
    cfg = cfg or configs.get(TRAIN_ARCH)
    check(cell["ok"], f"the card cell: {cell}")
    roof = cell["roofline"]
    counted, real = roof["flops_per_device"], train["step_flops"]
    floor = train_flops(cfg, TRAIN_B, TRAIN_T)
    measured_s = train["step_ms"] / 1e3
    log(f"[dryrun] {cfg.name} {TRAIN_B} x {TRAIN_T} on (1, 1): the dry "
        f"run counts {counted:.6g} FLOP, FlopCounterMode around a real "
        f"step on {card} {real:.6g} (ratio {counted / real:.6f}); "
        f"train_flops {floor:.6g}; roofline: compute {roof['compute_s']:.6g} "
        f"s, memory {roof['memory_s']:.6g} s, collective "
        f"{roof['collective_s']:.6g} s, step {roof['step_s']:.6g} s "
        f"({roof['dominant']}); the measured step {measured_s:.6g} s is "
        f"{measured_s / roof['step_s']:.3f} x the roofline; trace "
        f"{cell['trace_s']} s")
    check(abs(counted / real - 1) <= 0.01, f"the dry run's count "
          f"{counted:.6g} is not within 1% of the step's {real:.6g}")
    check(counted >= floor, f"the count {counted:.6g} is below "
          f"train_flops {floor:.6g}")
    check(roof["step_s"] <= measured_s, f"the roofline step "
          f"{roof['step_s']:.6g} s is above the measured {measured_s:.6g} s")


# --- phase 9: LM serving at full width; phase 10's model profiles -------------

def profile_window(torch, fn, dev="cuda", kernels=None):
    """Device time by kernel name and the busy share over ``fn()``, from
    ``torch.profiler`` (CUDA activity; CPU activity on a CPU rehearsal).
    ``kernels``, a list, receives every device event's (start us,
    duration us, name) in start order."""
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(dev).type == "cuda"
    kind = torch.autograd.DeviceType.CUDA if on_card \
        else torch.autograd.DeviceType.CPU
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == kind)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_name = sorted(((getattr(e, "self_device_time_total", 0.0), e.key,
                       e.count) for e in prof.key_averages()),
                     reverse=True)
    if kernels is not None:
        kernels.extend(sorted(
            (e.time_range.start, e.time_range.end - e.time_range.start,
             e.name) for e in prof.events() if e.device_type == kind))
    return wall, busy_us, by_name


def collective_waits(durs):
    """This rank's collective kernels of a profiled step (durations in
    us, in launch order; every rank launches the same collectives in the
    same order) split into transfer and wait: a collective's kernel ends
    on every rank of its group at about one time, so the shortest of the
    ranks' i-th kernels is about its transfer (that rank arrived last)
    and the rest of this rank's i-th is its wait for the later ranks
    (over all ranks, so on a mesh of several groups the wait is an upper
    bound).  Returns (transfer us, wait us), or None where the ranks'
    counts of kernels differ."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, list(durs))
    if len({len(d) for d in every}) != 1:
        return None
    low = sum(min(d[i] for d in every) for i in range(len(durs)))
    return low, sum(durs) - low


def phase_parity_4_layers(torch, cfg, seed, dev="cuda", prompt=6, steps=6,
                          frames=0):
    """``cfg``'s width, 4 layers, fp32: a ``prompt``-token prefill and
    ``steps`` decode steps against ``forward`` over all ``prompt + steps``
    tokens, within the reference's decode-parity tolerance 2e-3; returns
    the check's split-kernel launches.  A
    windowed model takes a prompt past its window, so that the prefill
    writes its ring with T > S and decode wraps it.  An encoder-decoder
    model takes ``ENCDEC_PARITY_LAYERS`` encoder and decoder layers and a
    source of ``frames`` frames; a vision-language model ``frames``
    patches ahead of its prompt (decode at ``frames + t``).  Every
    attention kernel launch of the check is the split kernel (fp32 on the
    tensor cores), at least one where the cut model has attention."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    name = cfg.name
    vlm = cfg.frontend == "vision"
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, num_layers=ENCDEC_PARITY_LAYERS,
                                  encoder_layers=ENCDEC_PARITY_LAYERS,
                                  dtype="float32")
    else:
        cfg = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    if cfg.num_experts:
        # capacity is per call: the forward's 12 tokens get C = ceil(12 K /
        # E * 1.25) slots an expert, the prefill's 6 and each decode step's
        # 1 their own, so at 1.25 the forward drops tokens that prefill and
        # decode keep and the two differ by design; with capacity to spare
        # (the reference's decode-parity test) nothing is dropped
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_PARITY_CAPACITY)
        log(f"[serve] {name} 4 layers fp32: capacity factor "
            f"{MOE_PARITY_CAPACITY:g}, no drops (at 1.25 the forward's longer "
            f"call drops tokens that prefill and decode keep)")
    model = build_model(cfg, device=dev, seed=seed)
    plans = model.dec_plans if cfg.is_encdec else model.plans
    kinds = ", ".join(plan.kind for plan in plans)
    total = prompt + steps
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, total), generator=gen,
                           device=dev)
    extra = {}
    if cfg.is_encdec or vlm:
        extra["frontend_embeds"] = torch.randn(
            (2, frames, cfg.d_model), generator=gen, device=dev)
    if cfg.is_encdec:
        kinds = f"{cfg.encoder_layers} encoder + {kinds} with cross"
    F = frames if vlm else 0      # patches ahead of the prompt
    before = dict(fa.LAUNCHES)
    with torch.inference_mode():
        full = model({"tokens": tokens, **extra})
        state = new_state(model, 2, F + total, extra)
        slots = sorted({st["k"].shape[1] for st in state if "k" in st})
        logits, state = model.prefill({"tokens": tokens[:, :prompt],
                                       **extra}, state)
        errs = [float((logits - full[:, F + prompt - 1]).abs().max())]
        for t in range(prompt, total):
            logits, state = model.decode_step(tokens[:, t], F + t, state)
            errs.append(float((logits - full[:, F + t]).abs().max()))
    label = f"{cfg.num_layers} layers" if not cfg.is_encdec else \
        f"{cfg.encoder_layers} + {cfg.num_layers} layers"
    check(max(errs) < 2e-3, f"{name} {label} fp32: prefill/decode vs "
          f"forward max |err| {max(errs):.3g} >= 2e-3")
    n = {key: fa.LAUNCHES[key] - before[key] for key in before}
    has_attn = cfg.is_encdec or "attn" in kinds
    if torch.device(dev).type == "cuda":     # the CPU runs no kernel
        check(n["flash_attention_split"] == n["flash_attention"]
              and (n["flash_attention"] > 0) == has_attn,
              f"{name} {label} fp32: forward launches {n}, expected every "
              f"one the split kernel")
    log(f"[serve] {name} {label} fp32: {n['flash_attention_split']} "
        f"attention launches, all flash_attention_split" if has_attn else
        f"[serve] {name} {label} fp32: no attention layer, no attention "
        f"launch")
    source = f", {frames} source frames" if cfg.is_encdec else \
        f", {frames} patches ahead of the prompt" if vlm else ""
    log(f"[serve] {name} {label} fp32 at d_model {cfg.d_model} ({kinds}; "
        f"KV cache slots {slots}{source}): {prompt}-token prefill + {steps} "
        f"decode steps vs forward over {total} max |err| {max(errs):.3g} "
        f"(< 2e-3) ok")
    del model, full, state
    free_card(torch, dev)
    return n["flash_attention_split"]


def new_state(model, B, max_len, batch):
    """A zeroed decode state for ``batch``; an encoder-decoder model's also
    holds the cross caches of the batch's frames.  A vision-language
    model's patches take slots of the self caches: ``max_len`` counts
    them."""
    if model.cfg.is_encdec:
        return model.init_state(B, max_len,
                                batch["frontend_embeds"].shape[1])
    return model.init_state(B, max_len)


def free_card(torch, dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def card_gib(torch, dev, peak=False) -> float:
    if torch.device(dev).type != "cuda":
        return float("nan")
    f = torch.cuda.max_memory_allocated if peak \
        else torch.cuda.memory_allocated
    return f() / 2**30


def phase_serve(torch, np, cfg, seed, card, placement=None, n_requests=8,
                prompt_len=1024, slots=4, max_new=32, dev="cuda"):
    """Serve ``cfg`` (the published width on the card); returns what the
    kernel phase needs (the path's launches and shapes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, count_params
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import Engine, Request
    name = cfg.name
    kernel = "wkv6" if "rwkv" in cfg.block_pattern else "flash_attention"
    encdec = cfg.is_encdec
    vlm = cfg.frontend == "vision"
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    sync(torch, dev)
    n_params = count_params(model.param_specs())
    log(f"[serve] {name}: {n_params / 1e9:.3f} B params ({cfg.dtype}) "
        f"drawn on {dev} in {time.perf_counter() - t0:.2f} s, "
        f"{card_gib(torch, dev):.2f} GiB")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (n_requests, prompt_len))
    # an encoder-decoder model's requests carry their source, a
    # vision-language model's its image's patch embeddings: random, in
    # the compute dtype, the config's frontend_len each
    F = cfg.frontend_len if encdec or vlm else 0
    frames = [None] * n_requests
    if F:
        gen = torch.Generator(device=dev).manual_seed(seed)
        frames = torch.randn((n_requests, F, cfg.d_model), generator=gen,
                             device=dev).to(cfg.compute_dtype)
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=max_new,
                    frames=frames[i])
            for i in range(n_requests)]
    # the patches come first in the self caches; a source has its own
    P = F if vlm else 0
    max_len = P + prompt_len + max_new
    enc_len = F if encdec else 0
    # warm-up at the traffic's shapes (library loads, cuBLAS handles and
    # heuristics, the allocator's blocks), outside the counted run
    Engine(model, slots=slots, max_len=max_len, enc_len=enc_len,
           device=dev).generate_batch([dataclasses.replace(
               reqs[0], max_new_tokens=2)])
    metrics = MetricsRegistry()
    eng = Engine(model, slots=slots, max_len=max_len, enc_len=enc_len,
                 placement=placement, metrics=metrics, device=dev)
    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    comps = eng.serve(reqs)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    by_shape = dict(fa.SHAPE_LAUNCHES)
    check(sorted(c.uid for c in comps) == list(range(n_requests))
          and all(len(c.tokens) == max_new for c in comps),
          f"{name}: served {len(comps)} completions")
    waves = -(-n_requests // slots)
    check(eng.prefills == waves and eng.decode_steps == waves
          * (max_new - 1), f"{name}: {eng.prefills} prefills, "
          f"{eng.decode_steps} decode steps")
    L = cfg.num_layers
    modes = None
    if encdec:
        # a prefill: one launch an encoder layer (bidirectional over the
        # frames), and two a decoder layer (causal over the prompt, then
        # cross over the frames); a decode step: one a decoder layer
        # (cross decode); every one the tensor-core kernel
        L = cfg.encoder_layers + cfg.num_layers
        n_kernel = cfg.encoder_layers + 2 * cfg.num_layers
        n = n_kernel * eng.prefills + cfg.num_layers * eng.decode_steps
        expect = {"flash_attention": n, "flash_attention_tc": n,
                  "flash_attention_split": 0,
                  "flash_attention_scalar": 0, **NO_BWD,
                  "wkv6": 0, "wkv6_seq": 0}
        # each entry's launches are its shape's, as the wrapper counted
        # them where it launched
        modes, want_shapes = {}, {}
        for entry, (shape_of, per) in ENCDEC_MODES.items():
            Tq, Tk, causal = shape_of(prompt_len, F)
            layers = cfg.encoder_layers if entry == "flash_attention_enc" \
                else cfg.num_layers
            want_shapes[("tc", Tq, Tk, causal)] = layers * (
                eng.prefills if per == "prefill" else eng.decode_steps)
            modes[entry] = (dict(B=slots, T=Tq, Tk=Tk, causal=causal,
                                 d=cfg.d_model, H=cfg.num_heads,
                                 G=cfg.num_kv_heads, D=cfg.head_dim,
                                 N=cfg.rwkv_head_dim,
                                 dtype=cfg.compute_dtype),
                            by_shape.get(("tc", Tq, Tk, causal), 0))
        check(by_shape == want_shapes, f"{name}: launches by (variant, Tq, "
              f"Tk, causal) {by_shape}, expected {want_shapes}")
        log(f"[serve] {name}: launches by (variant, Tq, Tk, causal): "
            f"{by_shape}")
    else:
        # the layers that run the path's kernel: the attention layers (12
        # of recurrentgemma-9b's 38), or every RWKV-6 layer
        n_kernel = sum(plan.kind == ("attn" if kernel == "flash_attention"
                                     else "rwkv") for plan in model.plans)
        if kernel == "flash_attention":
            # every prefill launch the tensor-core kernel, one an
            # attention layer, causal over the patches and the prompt
            n = n_kernel * eng.prefills
            expect = {"flash_attention": n, "flash_attention_tc": n,
                      "flash_attention_split": 0,
                      "flash_attention_scalar": 0, **NO_BWD,
                      "wkv6": 0, "wkv6_seq": 0}
            T = P + prompt_len
            want_shapes = {("tc", T, T, True): n}
            check(by_shape == want_shapes, f"{name}: launches by (variant, "
                  f"Tq, Tk, causal) {by_shape}, expected {want_shapes}")
        else:
            # every model call launches the split kernel, never the
            # sequential one
            expect = {"flash_attention": 0, "flash_attention_tc": 0,
                      "flash_attention_split": 0,
                      "flash_attention_scalar": 0, **NO_BWD,
                      "wkv6": n_kernel * (eng.prefills + eng.decode_steps),
                      "wkv6_seq": 0}
    check(launches == expect, f"{name}: kernel launches {launches}, "
          f"expected {expect} for {n_kernel} of {L} layers")
    hist = metrics.snapshot()["histograms"]
    pre_s, dec_s = hist["serve.prefill"]["sum"], hist["serve.decode"]["sum"]
    pre_tok = n_requests * prompt_len
    dec_tok = eng.decode_steps * slots
    if encdec:
        per = (f"{cfg.encoder_layers} encoder + 2 x {cfg.num_layers} decoder "
               f"launches a prefill, {cfg.num_layers} a decode step")
        source = (f"; source {n_requests * F} frames in {pre_s:.4f} s = "
                  f"{n_requests * F / pre_s:.1f} frames/s")
    elif vlm:
        per = (f"{n_kernel} of {L} layers x prefills, each over {P} "
               f"patches and {prompt_len} tokens; by shape {by_shape}")
        source = (f"; patches {n_requests * P} in {pre_s:.4f} s = "
                  f"{n_requests * P / pre_s:.1f} patches/s")
    else:
        calls_of = "prefills" if kernel == "flash_attention" \
            else "model calls"
        per = f"{n_kernel} of {L} layers x {calls_of}"
        source = ""
    ahead = f" and {F}-frame sources" if encdec else \
        f" after {F} patches each" if vlm else ""
    log(f"[serve] {name}: {n_requests} requests x {prompt_len}-token "
        f"prompts{ahead} over {slots} "
        f"slots, {max_new} new tokens each, in {wall:.3f} s; launches "
        f"{launches} (= {per})")
    log(f"[serve] {name}: prefill {pre_tok} {'text ' if vlm else ''}"
        f"tokens in {pre_s:.4f} s = "
        f"{pre_tok / pre_s:.1f} tokens/s{source}; decode "
        f"{eng.decode_steps} steps x {slots} slots in {dec_s:.4f} s = "
        f"{dec_tok / dec_s:.1f} tokens/s ({dec_s / eng.decode_steps * 1e3:.3f}"
        f" ms a step); peak {card_gib(torch, dev, peak=True):.2f} GiB on "
        f"{card}")
    # the same traffic again on the warm engine: the spread within a call
    again = MetricsRegistry()
    Engine(model, slots=slots, max_len=max_len, enc_len=enc_len,
           metrics=again, device=dev).serve(reqs)
    sync(torch, dev)
    hist = again.snapshot()["histograms"]
    pre_2, dec_2 = hist["serve.prefill"]["sum"], hist["serve.decode"]["sum"]
    log(f"[serve] {name}: the same traffic again: prefill "
        f"{pre_tok / pre_2:.1f} tokens/s, decode {dec_tok / dec_2:.1f} "
        f"tokens/s ({dec_2 / eng.decode_steps * 1e3:.3f} ms a step)")
    if placement is not None:
        check(eng.placement is placement, "placement not attached")
        log(f"[serve] {name}: engine placement mesh "
            f"{eng.placement.config_id} at "
            f"{eng.placement.hourly_cost:.2f} $/h")

    # the first wave again: finite logits, and against the plain version
    first = {"tokens": torch.as_tensor(prompts[:slots], device=dev)}
    if F:
        first["frontend_embeds"] = frames[:slots]
    logits, logits_p, routes = kernel_vs_plain(
        torch, model, first, kernel, max_len)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{name}: non-finite prefill logits")
    a, b = logits.float(), logits_p.float()
    rel = rel_l2(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    if agree < 1:
        # where the passes pick different tokens: how close the plain
        # pass's top two logits lie, against the logits' max |err|
        flips = a.argmax(-1) != b.argmax(-1)
        top2 = b.topk(2, dim=-1).values[flips]
        log(f"[serve] {name}: argmax differs on {int(flips.sum())} of "
            f"{flips.numel()} rows, where the plain pass's top two logits "
            f"lie {[round(float(g), 4) for g in top2[:, 0] - top2[:, 1]]} "
            f"apart")
    # bf16 over the depth: the kernel and the plain version take their
    # fp32 sums in another order, so each layer's bf16 activations round
    # the other way wherever a sum sits near a rounding boundary (a step
    # of 2^-8), and the random-weight residual stream carries these on
    # through every later layer.  On an H100 that drift measured 0.02 of
    # the logits' norm over qwen3-1.7b's 28 layers and 0.05 over
    # rwkv6-3b's 32, so the bound is twice the larger.  The kernels
    # themselves are held to the reference tolerances in phase 7 and at
    # the path's shapes in ``time_lm_kernel``; this check covers the
    # path's own activations.
    if not routes:
        check(rel < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
              f"relative error {rel:.3g} >= {REL_L2_TOL}")
        log(f"[serve] {name}: first-wave prefill logits, kernel vs plain "
            f"{kernel}: relative L2 error {rel:.3g} (< {REL_L2_TOL}, bf16 "
            f"over {L} layers), max |err| {float((a - b).abs().max()):.3g} "
            f"of max |logit| {float(b.abs().max()):.3g}, argmax agreement "
            f"{agree:.0%}; all finite")
    else:
        # a MoE router's top K is a step function of its bf16 logits:
        # where a token's K-th and (K+1)-th logits lie within one bf16
        # step, the other pass's rounding picks the other expert, and the
        # token's output changes by one expert's contribution, not by a
        # rounding; every later layer's routes drift further apart.  On
        # an H100 qwen3-moe-30b-a3b's routes agreed on 98.7% of layer 0's
        # (token, k) slots and on 3.5% of layer 46's, and its logits with
        # the routes free stayed within the bound over its first layer
        # alone (0.0052; 0.115 over two).  So the bound holds that depth,
        # and the account shows the rest: with the plain pass on the
        # kernel pass's experts the gap is the bf16 drift alone.
        log_routes(name, routes)
        acct = moe_account(torch, model, first, kernel, max_len)
        log(f"[serve] {name}: kernel vs plain prefill logits over the first "
            f"n layers, relative L2 with the routes free / on the kernel "
            f"pass's experts: " + ", ".join(
                f"n = {n} {free:.3g} / {pinned:.3g}"
                for n, (free, pinned) in acct.items()))
        held = acct[MOE_CHECK_LAYERS][0]
        check(held < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
              f"over {MOE_CHECK_LAYERS} layer(s), routes free, relative "
              f"error {held:.3g} >= {REL_L2_TOL}")
        log(f"[serve] {name}: first-wave prefill logits, kernel vs plain "
            f"{kernel}: relative L2 error {held:.3g} over the first "
            f"{MOE_CHECK_LAYERS} layer(s) (< {REL_L2_TOL}, routes free); "
            f"over all {L}: {rel:.3g} with the routes free (argmax "
            f"agreement {agree:.0%}), {acct[L][1]:.3g} on the same "
            f"experts; all finite")

    waves = None
    if kernel == "flash_attention":
        waves = prefill_turns(torch, model, first, slots, max_len, dev)
        log(f"[serve] {name}: first-wave prefill ({slots} x {prompt_len} "
            f"tokens{f' after {P} patches' if P else ''}) in turns: "
            f"tensor-core kernel {waves['tc'] * 1e3:.3f} "
            f"ms = {slots * prompt_len / waves['tc']:.1f} tokens/s, scalar "
            f"kernel (the one it replaced) {waves['scalar'] * 1e3:.3f} ms = "
            f"{slots * prompt_len / waves['scalar']:.1f} tokens/s")
    if cfg.window:
        phase_window(torch, np, model, seed, card, dev=dev)
    shapes = dict(B=slots, T=P + prompt_len, d=cfg.d_model, H=cfg.num_heads,
                  G=cfg.num_kv_heads, D=cfg.head_dim,
                  N=cfg.rwkv_head_dim, dtype=cfg.compute_dtype)
    prefills = eng.prefills
    del model, eng, logits, logits_p, first, frames, reqs
    free_card(torch, dev)
    return dict(kernel=kernel, launches=launches, shapes=shapes,
                waves=waves, layers=n_kernel, modes=modes,
                prefills=prefills)


def phase_window(torch, np, model, seed, card, prompt_len=WINDOW_PROMPT,
                 steps=WINDOW_STEPS, dev="cuda"):
    """A windowed model past its window, at full width in bf16: one
    ``prompt_len``-token prefill (longer than the window: each attention
    layer's ring cache of ``window`` slots is written with T > S) and
    ``steps`` decode steps (the ring wraps), once through the kernel and
    once with the plain version; the prefill's and every step's logits
    finite and within ``REL_L2_TOL`` relative L2 of the plain pass's, and
    one tensor-core launch an attention layer in the kernel pass."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    cfg = model.cfg
    name = cfg.name
    rng = np.random.default_rng(seed + 1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, prompt_len + steps)),
                             device=dev)
    n_attn = sum(plan.kind == "attn" for plan in model.plans)

    def run():
        out = []
        with torch.inference_mode():
            state = model.init_state(1, prompt_len + steps)
            logits, state = model.prefill(
                {"tokens": tokens[:, :prompt_len]}, state)
            out.append(logits)
            for t in range(prompt_len, prompt_len + steps):
                logits, state = model.decode_step(tokens[:, t], t, state)
                out.append(logits)
        slots = sorted({st["k"].shape[1] for st in state if "k" in st})
        return out, slots

    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    got, slots = run()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    check(launches["flash_attention_tc"] == launches["flash_attention"]
          == n_attn, f"{name} long prompt: launches {launches}, expected "
          f"{n_attn} tensor-core launches (one prefill)")
    check(slots == [cfg.window] and prompt_len > cfg.window,
          f"{name} long prompt: KV cache slots {slots}, window {cfg.window}")
    original = ops.flash_attention
    ops.flash_attention = fa.attention_ref
    try:
        want, _ = run()
    finally:
        ops.flash_attention = original
    rels = [rel_l2(a, b) for a, b in zip(got, want)]
    check(all(bool(torch.isfinite(a.float()).all()) for a in got),
          f"{name} long prompt: non-finite logits")
    check(max(rels) < REL_L2_TOL, f"{name} long prompt: kernel vs plain "
          f"logits relative error {max(rels):.3g} >= {REL_L2_TOL}")
    log(f"[window] {name}: 1 x {prompt_len}-token prefill past the window "
        f"{cfg.window} (ring caches of {slots[0]} slots written with T > S) "
        f"+ {steps} decode steps (the ring wraps) in {wall:.3f} s, "
        f"launches {launches}; kernel vs plain attention logits relative "
        f"L2 prefill {rels[0]:.3g}, decode steps "
        f"{' '.join(f'{r:.3g}' for r in rels[1:])} (< {REL_L2_TOL}); all "
        f"finite; on {card}")
    del got, want, tokens
    free_card(torch, dev)


def phase_llama4(torch, np, seed, card, batch=2, prompt_len=1024, steps=4,
                 dev="cuda", cfg=None):
    """``llama4-maverick-400b-a17b`` at full width over ``LLAMA4_LAYERS``
    layers (one dense, one MoE with its 128 experts, top-1 sigmoid routing
    and the shared expert) in bf16: one prefill of ``batch`` x ``prompt_len``
    tokens through the kernel and one through the plain version (relative
    L2 of the logits < ``REL_L2_TOL``, all finite, the MoE routes' share
    that agree), one ``flash_attention_tc`` launch a layer, then ``steps``
    decode steps (C = 1), all finite.  No fp32 check at this width (one
    fp32 MoE layer's experts alone are 3 x 128 x 5120 x 8192 x 4 bytes);
    the CPU tests hold the architecture to the reference at reduced
    width.  ``cfg`` replaces the config (a reduced one for a CPU
    rehearsal).  Returns what ``time_lm_kernel`` needs."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, count_params
    cfg = cfg or dataclasses.replace(configs.get(LLAMA4),
                                     num_layers=LLAMA4_LAYERS)
    name = f"{cfg.name} ({cfg.num_layers} layers)"
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    sync(torch, dev)
    log(f"[llama4] {name}: {count_params(model.param_specs()) / 1e9:.3f} B "
        f"params ({cfg.dtype}) drawn on {dev} in "
        f"{time.perf_counter() - t0:.2f} s, {card_gib(torch, dev):.2f} GiB "
        f"(peak {card_gib(torch, dev, peak=True):.2f})")
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt_len)), device=dev)
    kernel_vs_plain(torch, model, {"tokens": tokens}, "flash_attention",
                    prompt_len + steps)                     # warm-up
    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, logits_p, routes = kernel_vs_plain(
        torch, model, {"tokens": tokens}, "flash_attention",
        prompt_len + steps)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    L = cfg.num_layers
    expect = {"flash_attention": L, "flash_attention_tc": L,
              "flash_attention_split": 0,
              "flash_attention_scalar": 0, **NO_BWD,
              "wkv6": 0, "wkv6_seq": 0}
    check(launches == expect, f"{name}: kernel launches {launches}, "
          f"expected {expect} (one prefill through the kernel)")
    check(len(routes) == sum(cfg.is_moe_layer(i) for i in range(L)) >= 1,
          f"{name}: {len(routes)} MoE layers ran")
    a, b = logits.float(), logits_p.float()
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          f"{name}: non-finite prefill logits")
    rel = rel_l2(a, b)
    log_routes(name, routes)
    check(rel < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
          f"relative error {rel:.3g} >= {REL_L2_TOL}")
    log(f"[llama4] {name}: prefill {batch} x {prompt_len} tokens, kernel "
        f"and plain passes in {wall:.3f} s; launches {launches} (= {L} "
        f"layers x 1 prefill); kernel vs plain logits relative L2 error "
        f"{rel:.3g} (< {REL_L2_TOL}), max |err| "
        f"{float((a - b).abs().max()):.3g} of max |logit| "
        f"{float(b.abs().max()):.3g}; all finite")
    with torch.inference_mode():
        state = model.init_state(batch, prompt_len + steps)
        logits, state = model.prefill({"tokens": tokens}, state)
        tok = logits.argmax(-1)
        sync(torch, dev)
        t0 = time.perf_counter()
        for step in range(steps):
            logits, state = model.decode_step(tok, prompt_len + step, state)
            check(bool(torch.isfinite(logits.float()).all()),
                  f"{name}: non-finite logits at decode step {step}")
            tok = logits.argmax(-1)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) / steps * 1e3
    log(f"[llama4] {name}: {steps} decode steps (C = 1: every expert's "
        f"weights read a step) finite, {step_ms:.3f} ms a step; peak "
        f"{card_gib(torch, dev, peak=True):.2f} GiB on {card}")
    shapes = dict(B=batch, T=prompt_len, d=cfg.d_model, H=cfg.num_heads,
                  G=cfg.num_kv_heads, D=cfg.head_dim, N=cfg.rwkv_head_dim,
                  dtype=cfg.compute_dtype)
    del model, state, logits, logits_p, tokens, routes
    free_card(torch, dev)
    return dict(kernel="flash_attention", launches=launches, shapes=shapes)


def kernel_vs_plain(torch, model, batch, kernel, max_len, pin=False):
    """One prefill of ``batch`` through the path's kernel and one with the
    model-side entry point swapped for the plain version (the package has
    no switch for it): (logits, plain logits, per-MoE-layer pairs of
    expert ids, empty for a dense model).  With ``pin`` the plain pass
    takes the kernel pass's experts (``with_routes``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as wk
    B = batch["tokens"].shape[0]
    plain = fa.attention_ref if kernel == "flash_attention" \
        else wk.wkv6_scan_ref
    with torch.inference_mode():
        (logits, _), ids = with_routes(torch, lambda: model.prefill(
            batch, new_state(model, B, max_len, batch)))
        original = getattr(ops, kernel)
        setattr(ops, kernel, plain)
        try:
            (logits_p, _), ids_p = with_routes(
                torch, lambda: model.prefill(
                    batch, new_state(model, B, max_len, batch)),
                replay=ids if pin else None)
        finally:
            setattr(ops, kernel, original)
    return logits, logits_p, list(zip(ids, ids_p))


def rel_l2(a, b) -> float:
    """Relative L2 error of ``a`` against ``b``, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def moe_account(torch, model, batch, kernel, max_len):
    """Kernel vs plain prefill logits of a MoE model over its first n
    layers (the same weights), for each n in ``MOE_DEPTHS`` it has and its
    full depth: {n: (relative L2 with the routes free, relative L2 with
    the plain pass on the kernel pass's experts)}."""
    out = {}
    L = len(model.plans)
    for n in sorted({n for n in MOE_DEPTHS if n < L} | {L}):
        with first_layers(model, n):
            out[n] = tuple(rel_l2(*kernel_vs_plain(
                torch, model, batch, kernel, max_len, pin=pin)[:2])
                for pin in (False, True))
    return out


def log_routes(name, routes):
    """Logs the share of (token, k) routes the kernel's pass and the plain
    pass agree on: the first MoE layer's, the least, and every layer's."""
    shares = [float((a == b).float().mean()) for a, b in routes]
    worst = min(range(len(shares)), key=shares.__getitem__)
    log(f"[serve] {name}: MoE routes, kernel vs plain pass: first MoE "
        f"layer {shares[0]:.4%} of {routes[0][0].numel()} (token, k) "
        f"routes agree; least {shares[worst]:.4%} at MoE layer {worst}; "
        f"all {len(shares)} layers "
        f"{' '.join(f'{x:.3f}' for x in shares)}")


def prefill_turns(torch, model, batch, slots, max_len, dev="cuda"):
    """Seconds of one prefill of ``batch`` with the path's attention
    kernel (``"tc"``) and with the scalar kernel on the same bf16 inputs
    (``"scalar"``), each the mean of two runs taken in turns (tc, scalar,
    scalar, tc) on the host clock around work that ends in a
    synchronize: what the tensor-core kernel changes end to end."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def scalar(q, k, v, *, causal=True, window=None):
        return fa._launch(q, k, v, causal, window, "scalar")
    path = ops.flash_attention
    secs = {"tc": [], "scalar": []}
    try:
        for which in ("tc", "scalar", "scalar", "tc"):
            ops.flash_attention = path if which == "tc" else scalar
            with torch.inference_mode():
                state = new_state(model, slots, max_len, batch)
                sync(torch, dev)
                t0 = time.perf_counter()
                model.prefill(batch, state)
                sync(torch, dev)
                secs[which].append(time.perf_counter() - t0)
            del state
    finally:
        ops.flash_attention = path
    return {w: sum(v) / len(v) for w, v in secs.items()}


def phase_lm_profile(torch, np, cfg, seed, prompt_len=1024, slots=4,
                     steps=8, dev="cuda"):
    """Where the time goes: the model rebuilt from the same seed runs the
    first wave's prefill and ``steps`` decode steps under
    ``torch.profiler`` (device time by kernel, busy share).  Before that,
    the same decode steps unprofiled, timed by the host clock: this phase
    runs after every other profiled phase, so that reading shows what the
    earlier profiler sessions left behind in the launch path."""
    from repro_torch.models import build_model
    model = build_model(cfg, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (slots, prompt_len))
    first = {"tokens": torch.as_tensor(prompts, device=dev)}
    if cfg.frontend:
        gen = torch.Generator(device=dev).manual_seed(seed)
        first["frontend_embeds"] = torch.randn(
            (slots, cfg.frontend_len, cfg.d_model), generator=gen,
            device=dev).to(cfg.compute_dtype)
    # a vision-language model's patches come first in the self caches
    start = prompt_len + (cfg.frontend_len if cfg.frontend == "vision"
                          else 0)

    def window():
        with torch.inference_mode():
            st = new_state(model, slots, start + steps, first)
            lg, st = model.prefill(first, st)
            tok = lg.argmax(-1)
            sync(torch, dev)
            t0 = time.perf_counter()
            for step in range(steps):
                lg, st = model.decode_step(tok, start + step, st)
                tok = lg.argmax(-1)
            sync(torch, dev)
            return time.perf_counter() - t0

    window()                                  # warm-up
    step_ms = window() / steps * 1e3
    wall, busy_us, by_name = profile_window(torch, window, dev)
    total = sum(t for t, _, _ in by_name) or 1.0
    log(f"[profile] {cfg.name}: decode step unprofiled, after the earlier "
        f"profiler sessions: {step_ms:.3f} ms")
    log(f"[profile] {cfg.name}: prefill + {steps} decode steps under the "
        f"profiler: {wall:.4f} s wall, card busy {busy_us / 1e3:.3f} ms = "
        f"{busy_us / 1e6 / wall:.1%}; top kernels by device time:")
    for t_us, key, count in by_name[:8]:
        log(f"[profile]   {t_us / 1e3:9.3f} ms {t_us / total:6.1%} "
            f"x{count} {key[:90]}")
    if "rec" in cfg.block_pattern:
        rec_shares(torch, model, first, dev)
    del model, first
    free_card(torch, dev)


def rec_shares(torch, model, batch, dev="cuda"):
    """The RG-LRU scan's and the float32 gate products' share of a prefill
    wave of ``batch``: each timed alone (CUDA events) at the wave's shapes
    on the first RG-LRU layer's weights, times the RG-LRU layers, over
    the wave's time (host clock around a synchronized prefill, the mean
    of three).  The scan's and the products' kernels are PyTorch's own
    (elementwise and fp32 GEMM), which the profile's names do not tell
    apart from the rest of the model's."""
    from repro_torch.models import recurrent as R
    cfg = model.cfg
    B, T = batch["tokens"].shape
    rec = [i for i, plan in enumerate(model.plans) if plan.kind == "rec"]
    p = model.blocks[rec[0]]["rec"]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, T, cfg.lru_width), generator=gen, device=dev)
    with torch.inference_mode():
        log_a, gated = R._rglru_gates(p, x)
        scan_ms = time_ms(torch, lambda: R.rglru_scan(log_a, gated, None),
                          iters=10, warmup=2)
        gate_ms = time_ms(torch, lambda: (x @ p["w_a"], x @ p["w_x"]),
                          iters=10, warmup=2)
        secs = []
        for _ in range(3):
            state = model.init_state(B, T)
            sync(torch, dev)
            t0 = time.perf_counter()
            model.prefill(batch, state)
            sync(torch, dev)
            secs.append(time.perf_counter() - t0)
            del state
    wave_ms = sum(secs) / len(secs) * 1e3
    # the scan as training runs it: inputs that want a gradient make its
    # rounds write new tensors (torch.cat) in place of in-place updates
    with torch.inference_mode(False), torch.enable_grad():
        with torch.no_grad():
            log_a_g, gated_g = (t.clone() for t in R._rglru_gates(p, x))
        log_a_g.requires_grad_()
        gated_g.requires_grad_()
        grad_scan_ms = time_ms(torch, lambda: R.rglru_scan(
            log_a_g, gated_g, None), iters=10, warmup=2)
    del log_a_g, gated_g
    flops = 2 * 2 * B * T * cfg.lru_width ** 2
    log(f"[profile] {cfg.name}: prefill wave {B} x {T} {wave_ms:.3f} ms; "
        f"RG-LRU scan {scan_ms:.4f} ms a layer x {len(rec)} layers = "
        f"{len(rec) * scan_ms / wave_ms:.1%} of it; fp32 gate products "
        f"(x @ w_a, x @ w_x; {flops:.3g} flops, "
        f"{flops / gate_ms / 1e9:.1f} TFLOP/s) {gate_ms:.4f} ms a layer x "
        f"{len(rec)} = {len(rec) * gate_ms / wave_ms:.1%} of it")
    log(f"[profile] {cfg.name}: the RG-LRU scan at the wave's shape, "
        f"in-place rounds (serving) {scan_ms:.4f} ms, new tensors a round "
        f"with autograd recording (training) {grad_scan_ms:.4f} ms: "
        f"{len(rec) * (grad_scan_ms - scan_ms) / wave_ms:+.1%} of the wave "
        f"if serving took the training rounds")
    del x, log_a, gated
    return dict(wave_ms=wave_ms, scan_ms=scan_ms, gate_ms=gate_ms,
                grad_scan_ms=grad_scan_ms, layers=len(rec))


def rel64(a, b) -> float:
    """Relative L2 distance of ``a`` from ``b``, in float64 (fine enough
    for fp32's own 1e-7)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def time_lm_kernel(torch, kernel, shapes, errs, seed, dev="cuda",
                   name=None, fp32_entries=None):
    """The kernel at the shapes its path gave it: held against its plain
    version, then timed beside the plain version, the library call (SDPA
    for attention, none for WKV6) and its bound; ``name`` is its record
    entry (default ``kernel``).  For attention, also the scalar kernel on
    the same bf16 inputs (the kernel this path ran before the tensor-core
    one: ``earlier_ms``) and, with ``fp32_entries`` (the names of two
    record entries), on fp32 inputs of the same shape: the split kernel
    (what fp32 takes) under ``"split"`` and the scalar kernel (by name,
    the yardstick: the split entry's ``earlier_ms``) under ``"scalar"``,
    both held against the plain version, their relative L2 distances from
    a float64 run logged side by side, each with the split bound (six
    bf16 products a product at the bf16 peak) and the scalar FFMA bound
    (``ffma_bound``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    name = name or kernel
    sh = shapes
    B, T, dt = sh["B"], sh["T"], sh["dtype"]
    if kernel == "flash_attention":
        # a causal call covers one sequence (Tk = T); a bidirectional one
        # may read another (the encoder-decoder's cross attention)
        H, G, D = sh["H"], sh["G"], sh["D"]
        Tk, causal = sh.get("Tk", T), sh.get("causal", True)
        shape = (B, T, Tk, H, G, D)
        q, k, v = attn_inputs(torch, B, T, H, G, D, dt, seed, dev, Tk=Tk)
        err = check_attention(torch, q, k, v, causal, None,
                              f"path shape {shape}", errs, name)
        log(f"[lm-parity] flash attention bfloat16 (tc) at the path shape "
            f"B={B} Tq={T} Tk={Tk} H={H} G={G} D={D} causal={causal}: "
            f"max |err| {err:.3g} ok")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the (query, key) pairs the mask lets through (the forward's
        # counting form counts 4 D a pair, as this bound)
        pairs = fa.attention_pairs(B, H, T, Tk, causal, None)
        n_elems = 2 * B * T * H * D + 2 * B * Tk * G * D

        def timed(q, k, v, kind, ops_per_s):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            out = dict(
                ms=time_ms(torch, lambda: fa._launch(q, k, v, causal, None,
                                                     kind),
                           iters=10 if kind == "scalar" else 50, warmup=3),
                plain_ms=time_ms(torch, lambda: fa.attention_ref(
                    q, k, v, causal=causal), iters=5, warmup=1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                    iters=50, warmup=3),
                bound=bound_ms(q.element_size() * n_elems, 4 * D * pairs,
                               ops_per_s))
            del qt, kt, vt
            return out

        r = timed(q, k, v, "tc", BF16_FLOPS_PER_S)
        r["earlier_ms"] = time_ms(torch, lambda: fa._launch(
            q, k, v, causal, None, "scalar"), iters=10, warmup=2)
        what = (f"B={B} Tq={T} Tk={Tk} H={H} G={G} D={D} "
                f"{'causal' if causal else 'bidirectional'} bf16")
    if kernel == "flash_attention" and fp32_entries:
        split_entry, scalar_entry = fp32_entries
        q32, k32, v32 = (x.float() for x in (q, k, v))
        label = f"path shape {shape} fp32"
        err = check_attention(torch, q32, k32, v32, causal, None, label,
                              errs, split_entry)
        check(fa.variant(torch.float32, D) == "split",
              f"{label}: fp32 routes to {fa.variant(torch.float32, D)}")
        # the scalar kernel by name on the same inputs, the same limits
        got = {"split": fa._launch(q32, k32, v32, causal, None),
               "scalar": fa._launch(q32, k32, v32, causal, None, "scalar")}
        want = fa.attention_ref(q32, k32, v32, causal=causal)
        atol, rtol = ATTN_TOL["float32"]
        s_err = max_err(torch, got["scalar"], want)
        check(allclose(torch, got["scalar"], want, atol, rtol),
              f"{label}: the scalar kernel outside atol {atol} rtol {rtol} "
              f"(max |err| {s_err:.3g})")
        errs[scalar_entry] = max(errs[scalar_entry], s_err)
        # both kernels and the plain version against a float64 run (the
        # plain version's casts to float32 taken for float64)
        with float64_math(torch, {}):
            want64 = fa.attention_ref(q32.double(), k32.double(),
                                      v32.double(), causal=causal)
        sync(torch, dev)
        dist = {kind: rel64(o, want64) for kind, o in got.items()}
        dist["plain"] = rel64(want, want64)
        del got, want, want64
        log(f"[lm-parity] flash attention float32 at the path shape: split "
            f"max |err| {err:.3g}, scalar {s_err:.3g} ok; relative L2 from "
            f"a float64 run: split {dist['split']:.3g}, scalar "
            f"{dist['scalar']:.3g}, plain {dist['plain']:.3g}")
        # the split kernel's work: six bf16 products a product at the bf16
        # peak; the scalar kernel's fp32 FFMAs at the fp32 peak off the
        # tensor cores (the same work: each entry carries both)
        r["split"] = timed(q32, k32, v32, "split", BF16_FLOPS_PER_S / 6)
        r["scalar"] = timed(q32, k32, v32, "scalar", BF16_FLOPS_PER_S / 6)
        ffma = bound_ms(q32.element_size() * n_elems, 4 * D * pairs,
                        FP32_FLOPS_PER_S)
        for kind in ("split", "scalar"):
            r[kind].update(ffma_bound=ffma, dist64=dist[kind],
                           plain_dist64=dist["plain"])
        r["split"]["earlier_ms"] = r["scalar"]["ms"]
        del q32, k32, v32
        sp, sc = r["split"], r["scalar"]
        log(f"[time] {split_entry}: kernel {sp['ms']:.4f} ms, scalar "
            f"{sc['ms']:.4f} ms ({sc['ms'] / sp['ms']:.2f} x the split), "
            f"plain {sp['plain_ms']:.4f} ms, SDPA fp32 "
            f"{sp['library_ms']:.4f} ms ({sp['library_ms'] / sp['ms']:.2f} x "
            f"the split; scalar's run {sc['library_ms']:.4f}), split bound "
            f"{sp['bound'][0]:.5f} ms ({sp['bound'][1]}), FFMA bound "
            f"{ffma[0]:.5f} ms; {sp['ms'] / sp['bound'][0]:.1f} x the split "
            f"bound, at {what.replace('bf16', 'fp32')}")
    if kernel == "wkv6":
        H, N = sh["d"] // sh["N"], sh["N"]
        args = wkv_inputs(torch, B, T, H, N, dt, seed, random_state=False,
                          dev=dev)
        check_wkv(torch, args, f"path shape {(B, T, H, N)}", errs)
        dec = wkv_inputs(torch, B, 1, H, N, dt, seed + 1, dev=dev)
        check_wkv(torch, dec, f"decode shape {(B, 1, H, N)}", errs)
        # the sequential kernel (the one this path ran before), held
        # against the plain version on the same inputs before it is timed
        for label, inputs in (("path", args), ("decode", dec)):
            got = wk._launch(*inputs, variant="seq")
            sync(torch, dev)
            check(all(allclose(torch, a, b, *WKV_TOL)
                      for a, b in zip(got, wk.wkv6_scan_ref(*inputs))),
                  f"wkv6: the sequential kernel at the {label} shape "
                  f"differs from the plain version")
        del got

        def split(inputs):
            return lambda: wk.wkv6(*inputs)

        def seq(inputs):
            return lambda: wk._launch(*inputs, variant="seq")
        r = dict(
            ms=time_ms(torch, split(args), iters=20, warmup=3),
            earlier_ms=time_ms(torch, seq(args), iters=10, warmup=2),
            plain_ms=time_ms(torch, lambda: wk.wkv6_scan_ref(*args),
                             iters=3, warmup=1),
            library_ms=None,
            decode_ms=time_ms(torch, split(dec), iters=200),
            decode_graph_ms=graph_ms(torch, split(dec)),
            decode_earlier_ms=time_ms(torch, seq(dec), iters=200),
            decode_earlier_graph_ms=graph_ms(torch, seq(dec)))

        def wkv_bound(steps):
            n_bytes = (3 * 2 + 4 + 4) * B * steps * H * N + 4 * H * N \
                + 2 * 4 * B * H * N * N
            return bound_ms(n_bytes, 5 * N * N * B * H * steps)
        r["bound"] = wkv_bound(T)
        r["decode_bound"] = wkv_bound(1)
        what = f"B={B} T={T} H={H} N={N} bf16 r/k/v"
        del args, dec
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    earlier = f", {'sequential' if kernel == 'wkv6' else 'scalar'} kernel " \
        f"{r['earlier_ms']:.4f} ms" if "earlier_ms" in r else ""
    log(f"[time] {name}: kernel {r['ms']:.4f} ms{earlier}, plain "
        f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
        f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) at {what}")
    if "decode_ms" in r:
        log(f"[time] {kernel}: decode step (T=1) kernel "
            f"{r['decode_ms']:.4f} ms back to back, "
            f"{r['decode_graph_ms']:.5f} ms from a CUDA graph; sequential "
            f"kernel {r['decode_earlier_ms']:.4f} ms back to back, "
            f"{r['decode_earlier_graph_ms']:.5f} ms from a CUDA graph; "
            f"bound {r['decode_bound'][0]:.6f} ms ({r['decode_bound'][1]})")
    return r


def time_encdec_kernels(torch, cfg, run, errs, seed, dev="cuda"):
    """The encoder-decoder's kernel at each of its four shapes
    (``ENCDEC_MODES``), timed by ``time_lm_kernel``; each entry keeps its
    shape's launches on the served path, the encoder's entry the first
    wave's prefill in turns, and the log the kernel's share of that wave.
    Returns {record entry: run}."""
    out = {}
    for entry, (shapes, n) in run["modes"].items():
        out[entry] = dict(run, entry_launches=n, times=time_lm_kernel(
            torch, run["kernel"], shapes, errs, seed, dev=dev, name=entry))
    w = run["waves"]
    out["flash_attention_enc"]["times"].update(
        wave_ms=w["tc"] * 1e3, wave_earlier_ms=w["scalar"] * 1e3)
    per_wave = {e: n // run["prefills"] for e, (_, n) in run["modes"].items()
                if ENCDEC_MODES[e][1] == "prefill"}
    ms = sum(k * out[e]["times"]["ms"] for e, k in per_wave.items())
    ms_earlier = sum(k * out[e]["times"]["earlier_ms"]
                     for e, k in per_wave.items())
    log(f"[serve] {cfg.name}: attention " + " + ".join(
        f"{k} x {out[e]['times']['ms']:.4f} ms ({e})"
        for e, k in per_wave.items())
        + f" = {ms / (w['tc'] * 1e3):.1%} of a {w['tc'] * 1e3:.3f} ms "
        f"prefill wave (scalar kernel: "
        f"{ms_earlier / (w['scalar'] * 1e3):.1%} of "
        f"{w['scalar'] * 1e3:.3f} ms)")
    return out


# --- phase 9: training --------------------------------------------------------

#: what the backward kernel replaces: XLA's autodiff of the reference's
#: chunked jnp attention in the train step (no Pallas kernel)
TRAIN_REPLACES = "src/repro/models/layers.py:132"
#: the training run: qwen3-1.7b at full width and depth, the serving cells'
#: batch of 4 x 1,024 tokens, the reference's TrainConfig defaults (AdamW,
#: remat), the head over vocabulary chunks of 16,384 (151,936 is no
#: multiple: the last chunk is padded), a checkpoint after step 5
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_STEPS = "qwen3-1.7b", 4, 1024, 10
TRAIN_VOCAB_CHUNK, TRAIN_CKPT_STEP, TRAIN_RESUMED = 16_384, 5, 2
#: the backward kernel's checks: (B, Tq, Tk, H, G, causal, window) at
#: every head size, both dtypes: causal, a window, bidirectional with
#: Tq != Tk (Tq > Tk with a window leaves rows fully masked), GQA R = 1,
#: 2, 4 and 48, ragged T, Tq = 1 and Tq = Tk = 1
BWD_CASES = [(2, 128, 128, 4, 4, True, None), (2, 130, 130, 4, 2, True, None),
             (1, 100, 100, 8, 2, True, 16), (2, 37, 53, 4, 4, False, None),
             (1, 100, 37, 4, 2, False, 8), (2, 1, 130, 4, 1, False, None),
             (1, 70, 70, 48, 1, True, None), (1, 1, 1, 4, 4, True, None)]
#: each of dq, dk and dv within this relative L2 of the plain version
BWD_LIMIT = {"float32": 1e-5, "bfloat16": 1e-2}
#: the planted fault: the plain version with the last key block's
#: contribution dropped (64 keys, the kernel's tile up to D = 160), which
#: the check above must refuse
BWD_FAULT_KEYS = 64
#: full-width kernel-vs-plain gradients over the whole gradient: bf16 over
#: every layer, fp32 over 4
TRAIN_GRAD_L2 = {"bfloat16": 0.1, "float32": 1e-3}
#: and each leaf's own relative L2 (a leaf whose plain gradient is zero
#: is held to zero).  The whole gradient cannot see a fault in one layer
#: of 28: with the last layer's last key tile dropped it moves by 0.0149
#: against 0.0089 of bf16 rounding, while that layer's worst leaf moves
#: by 0.11 against at most 0.023 (NVIDIA H100 80GB HBM3, 700 W)
TRAIN_LEAF_L2 = {"bfloat16": 0.05, "float32": 1e-4}
#: the backward's shapes on seamless-m4t-large-v2's training step (B, Tq,
#: Tk, H, G, D, causal): the encoder over the frames, the decoder's
#: self-attention, its cross-attention over the frames
ENCDEC_BWD_SHAPES = [(2, 4096, 4096, 16, 16, 64, False),
                     (2, 512, 512, 16, 16, 64, True),
                     (2, 512, 4096, 16, 16, 64, False)]
#: the encoder-decoder's one training step: 2 + 2 layers at full width,
#: 4,096 source frames, 512 target tokens a sequence
ENCDEC_TRAIN = dict(layers=2, B=2, T=512, frames=4096)


#: WKV6's backward (phase 9): what it replaces, XLA's autodiff of the
#: reference's chunk-rematerialised recurrence in the train step (no Pallas
#: kernel); rwkv6-3b's training run at full width and depth, the qwen3
#: run's batch, TrainConfig defaults and vocabulary chunks (65,536 is four
#: of them)
RWKV_ARCH, RWKV_STEPS = "rwkv6-3b", 8
#: the depth at which rwkv6-3b's gradients are held kernel against plain
#: (TRAIN_GRAD_L2, TRAIN_LEAF_L2), by dtype.  Deeper, the model's
#: gradients at random weights hang on the rounding of its arithmetic:
#: the kernel's and the plain version's are each as far from a float64
#: run on the same weights as the leaf limit or farther, the leaf u
#: first (:func:`rwkv_grad_witness`; on the CPU the reference's own
#: float32 gradient is as far, ``tests/test_torch_wkv6_bwd.py``).  No
#: kernel can be held to those limits there; the full depth is held layer
#: by layer instead (``wkv6_layers_vs_plain``)
RWKV_GRAD_LAYERS = {"bfloat16": 2, "float32": 1}
#: the backward kernel's checks (B, T, H, N), each with strong decays and a
#: nonzero s0 and dsT, in fp32 and bf16, beside rwkv6-3b's training shape:
#: a step alone (T = 1), ragged T, one past the 16-step chunk and past a
#: power of two, every head size
WKV_BWD_CASES = [(2, 1, 3, 64), (1, 37, 2, 64), (2, 100, 2, 16),
                 (1, 64, 4, 32), (2, 17, 3, 64), (1, 1025, 2, 64)]
WKV_BWD_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")

#: pixtral-12b's and recurrentgemma-9b's training at full width and cut
#: depth, by architecture: (layers, text tokens a sequence, patch
#: embeddings a sequence, the depth of the gradient check).  One 80 GB
#: card holds neither at full depth with AdamW (bf16 weights and
#: gradients, fp32 moments: 12 bytes a parameter, 105.0 GiB for
#: recurrentgemma-9b's 9.396 B and 142.7 GiB for pixtral-12b's 12.772 B);
#: at 9 layers (three cycles of rec, rec, attn) and 8 layers they are
#: 3.018 B and 3.628 B parameters, 33.7 and 40.5 GiB of state.  Their
#: gradient checks take a depth that holds an attention layer: one cycle,
#: and 2 layers
CUT_TRAIN = {"recurrentgemma-9b": (9, 1024, 0, 3),
             "pixtral-12b": (8, 1024, 1024, 2)}
CUT_STEPS = 6
#: the record entry of each cut model's backward shape, bf16 and fp32
CUT_ENTRY = {"recurrentgemma-9b": "flash_attention_bwd_d256",
             "pixtral-12b": "flash_attention_bwd_d160"}
CUT_ENTRY_FP32 = {"recurrentgemma-9b": "flash_attention_bwd_split_fp32_d256",
                  "pixtral-12b": "flash_attention_bwd_split_fp32_d160"}
#: qwen3-moe-30b-a3b's training on one card at full width: (layers of its
#: 48, steps, the depth of the gradient check).  One card holds the full
#: depth with no optimizer (30.5 B parameters, 61 GB of bf16 weights
#: alone); 8 layers are 5.53 B, 22.1 GB of bf16 weights and gradients,
#: Adafactor's factored state under 0.1 GB
MOE_ARCH, MOE_TRAIN = "qwen3-moe-30b-a3b", (8, 4, 2)
#: its optimizer, on one card and on four: Adafactor at the reference's
#: peak rate from the first step (the default 100-step warmup moves the
#: weights by less than the batches' spread of the loss in 4 steps)
MOE_TCFG = dict(optimizer="adafactor", warmup_steps=1)
#: the record entry of its backward's training shape
MOE_ENTRY = "flash_attention_bwd_d64"


def check_wkv6_bwd(torch, seed, train_shape, dev="cuda"):
    """The forward's checkpoints against ``wkv6_fwd_ref`` (``WKV_TOL``),
    and each backward kernel (``rwkv6_scan.BWD_VARIANTS``: the cluster
    kernel the train step runs, and the one-block-a-stream yardstick)
    against ``wkv6_bwd_ref``, each of its six gradients within
    :data:`BWD_LIMIT` relative L2, one launch a call (counted under its
    variant) and a second call bitwise, over :data:`WKV_BWD_CASES` and
    ``train_shape``; the cluster kernel also within :data:`BWD_LIMIT` of
    the yardstick.  The planted fault (dS not carried across the middle
    chunk boundary) must fail the cluster kernel's check at the shapes of
    more than 64 steps at N = 16 and at the training shape.  Returns the
    largest max |err| by variant."""
    from repro_torch.kernels import rwkv6_scan as wk
    worst_abs, n_caught = dict.fromkeys(wk.BWD_VARIANTS, 0.0), 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        limit, worst = BWD_LIMIT[name], dict.fromkeys(wk.BWD_VARIANTS, 0.0)
        worst_pair = 0.0
        for i, shape in enumerate(WKV_BWD_CASES + [tuple(train_shape)]):
            B, T, H, N = shape
            r, k, v, w, u, s0 = wkv_inputs(torch, *shape, dtype, seed + i,
                                           dev=dev, strong=True)
            gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
            dy = torch.randn((B, T, H, N), generator=gen, device=dev)
            dsT = torch.randn((B, H, N, N), generator=gen, device=dev)
            y, sT, ckpt = wk._launch(r, k, v, w, u, s0, ckpt=True)
            want_f = wk.wkv6_fwd_ref(r, k, v, w, u, s0)
            sync(torch, dev)
            check(all(allclose(torch, a, b, *WKV_TOL)
                      for a, b in zip((y, sT, ckpt), want_f)),
                  f"wkv6 {name} {shape}: the forward's y, s_T or "
                  f"checkpoints outside atol {WKV_TOL[0]} rtol {WKV_TOL[1]}")
            want = wk.wkv6_bwd_ref(r, k, v, w, u, s0, dy, dsT)
            got = {}
            for variant in wk.BWD_VARIANTS:
                before = dict(wk.LAUNCHES)
                got[variant] = wk._launch_bwd(r, k, v, w, u, ckpt, dy, dsT,
                                              True, variant=variant)
                check({n: wk.LAUNCHES[n] - before[n] for n in before}
                      == {"wkv6": 0, "wkv6_seq": 0, "wkv6_bwd": 1,
                          "wkv6_bwd_block": int(variant == "block")},
                      f"wkv6 backward {variant} {name} {shape}: not one "
                      f"launch")
                sync(torch, dev)
                for gname, g, wg in zip(WKV_BWD_GRADS, got[variant], want):
                    check(g.dtype == wg.dtype and g.shape == wg.shape,
                          f"wkv6 backward {variant} {name} {shape}: {gname} "
                          f"{g.dtype} {tuple(g.shape)}")
                    rel = bwd_rel(torch, g, wg, 1.0)
                    check(rel < limit, f"wkv6 backward {variant} {name} "
                          f"{shape}: {gname} relative L2 {rel:.3g} >= "
                          f"{limit}")
                    worst[variant] = max(worst[variant], rel)
                    worst_abs[variant] = max(worst_abs[variant], max_err(
                        torch, g.float(), wg.float()))
                again = wk._launch_bwd(r, k, v, w, u, ckpt, dy, dsT, True,
                                       variant=variant)
                sync(torch, dev)
                check(all(torch.equal(a, b)
                          for a, b in zip(got[variant], again)),
                      f"wkv6 backward {variant} {name} {shape}: two calls "
                      f"differ")
                del again
            for gname, g, wg in zip(WKV_BWD_GRADS, got["cluster"],
                                    got["block"]):
                rel = bwd_rel(torch, g, wg, 1.0)
                check(rel < limit, f"wkv6 backward {name} {shape}: {gname} "
                      f"of the cluster kernel {rel:.3g} from the "
                      f"yardstick's (limit {limit})")
                worst_pair = max(worst_pair, rel)
            if T > 64 and (N == 16 or shape == tuple(train_shape)):
                cut = wk.CKPT_STEPS * (-(-T // wk.CKPT_STEPS) // 2)
                f = wkv6_cut_bwd(torch, wk._launch_bwd, r, k, v, w, u, ckpt,
                                 dy, dsT, True, cuts=[cut])
                rels = [bwd_rel(torch, a, b, 1.0) for a, b in zip(f, want)]
                check(max(rels) >= limit, f"wkv6 backward {name} {shape}: "
                      f"the planted fault passes the check ({rels})")
                n_caught += 1
                log(f"[train] planted fault wkv6 {name} {shape}: dS not "
                    f"carried across step {cut} -> relative L2 "
                    + " ".join(f"{g} {x:.3g}"
                               for g, x in zip(WKV_BWD_GRADS, rels))
                    + f" (caught: >= {limit})")
            del r, k, v, w, u, s0, dy, dsT, y, sT, ckpt, want_f, got, want
        log(f"[train] wkv6 backward {name}: {len(WKV_BWD_CASES) + 1} shapes "
            f"(strong decays, nonzero s0 and dsT) within relative L2 {limit} "
            f"for each of {', '.join(WKV_BWD_GRADS)} (worst: cluster "
            f"{worst['cluster']:.3g}, yardstick {worst['block']:.3g}; "
            f"cluster against yardstick {worst_pair:.3g}); the forward's "
            f"checkpoints within atol {WKV_TOL[0]}; second calls bitwise")
    check(n_caught > 0, "no planted fault was checked")
    return worst_abs


def bwd_waves(torch, occ, streams) -> int:
    """Waves of a backward launch over ``streams`` (b, h) streams: the
    cluster kernel's clusters over those resident at once, the block
    kernel's blocks over blocks an SM times the card's SMs."""
    if occ["clusters"]:
        return -(-streams // occ["clusters"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-streams // (occ["blocks_per_sm"] * sms))


def time_wkv6_bwd(torch, seed, shape, dev="cuda"):
    """The WKV6 backward at rwkv6-3b's training ``shape`` as the train step
    launches it (bf16 r, k and v, no dsT, no ds0): the cluster kernel's
    time and the yardstick's (``variant="block"``) in turns, each with
    what the card gives it (blocks an SM, clusters resident, registers)
    and its waves; the forward's with and without its checkpoints, the
    plain version's and the bound.  The bound counts 14 N^2 flops a step
    and stream (the state recomputed from its checkpoint, 3; dr, dk, dv,
    dw, 2 each; dS, 3) and the bytes of r, k, v, w, u, dy and the
    checkpoints in, dr, dk, dv, dw and du out.  No single PyTorch call
    computes this function: ``library_ms`` is None."""
    from repro_torch.kernels import rwkv6_scan as wk
    B, T, H, N = shape
    r, k, v, w, u, s0 = wkv_inputs(torch, *shape, torch.bfloat16, seed,
                                   random_state=False, dev=dev, strong=True)
    dy = torch.randn((B, T, H, N), device=dev)
    _, _, ckpt = wk._launch(r, k, v, w, u, s0, ckpt=True)

    def run(variant):
        return lambda: wk._launch_bwd(r, k, v, w, u, ckpt, dy, None, False,
                                      variant=variant)
    turns = {"cluster": [], "block": []}
    for variant in ("cluster", "block", "block", "cluster"):
        turns[variant].append(time_ms(torch, run(variant), iters=50,
                                      warmup=5))
    ms, block_ms = (sum(turns[x]) / 2 for x in ("cluster", "block"))
    occ = {x: wk.bwd_occupancy(N, torch.bfloat16, x) for x in turns}
    waves = {x: bwd_waves(torch, occ[x], B * H) for x in turns}
    fwd_ckpt_ms = time_ms(torch, lambda: wk._launch(r, k, v, w, u, s0,
                                                    ckpt=True))
    fwd_ms = time_ms(torch, lambda: wk._launch(r, k, v, w, u, s0))
    plain_ms = time_ms(torch, lambda: wk.wkv6_bwd_ref(r, k, v, w, u, s0, dy),
                       iters=2, warmup=1)
    n, es = B * T * H * N, r.element_size()
    n_bytes = 6 * es * n + 3 * 4 * n + 4 * ckpt.numel() + 2 * 4 * H * N
    bound = bound_ms(n_bytes, 14 * N * N * B * H * T)
    for x, label in (("cluster", "wkv6_bwd_cluster"),
                     ("block", "wkv6_bwd_block (yardstick)")):
        o = occ[x]
        log(f"[time] {label} B,T,H,N={shape} bf16: "
            f"{' '.join(f'{t:.4f}' for t in turns[x])} ms in turns; "
            f"{o['threads']} threads, {o['registers']} registers, "
            f"{o['spill']} bytes of spills, {o['smem']} bytes of shared "
            f"memory a block; {o['blocks_per_sm']} blocks an SM, "
            f"{o['clusters'] or '-'} clusters resident, "
            f"{B * H * o['blocks_per_stream']} blocks in {waves[x]} "
            f"wave(s)")
    log(f"[time] wkv6_bwd B,T,H,N={shape} bf16: {ms:.4f} ms, "
        f"{ms / bound[0]:.1f} x the bound, {block_ms / ms:.2f} x faster "
        f"than the yardstick's {block_ms:.4f} (plain {plain_ms:.3f} ms); "
        f"bound {bound[0]:.5f} ms ({bound[1]}; {n_bytes / 1e6:.1f} MB, "
        f"{14 * N * N * B * H * T / 1e9:.3f} GFLOP); the forward with its "
        f"checkpoints {fwd_ckpt_ms:.4f} ms, without {fwd_ms:.4f} ms")
    common = {"plain_ms": plain_ms, "bound": bound, "library_ms": None}
    return {"ms": ms, "earlier_ms": block_ms, **common,
            "forward_ckpt_ms": fwd_ckpt_ms, "forward_ms": fwd_ms,
            "blocks_per_sm": occ["cluster"]["blocks_per_sm"],
            "clusters": occ["cluster"]["clusters"],
            "waves": waves["cluster"],
            "registers": occ["cluster"]["registers"],
            "block": {"ms": block_ms, **common,
                      "blocks_per_sm": occ["block"]["blocks_per_sm"],
                      "waves": waves["block"],
                      "registers": occ["block"]["registers"]}}


def bwd_rel(torch, got, want, floor):
    """Relative L2 of a gradient; where the true gradient vanishes (dq
    and dk at Tq = Tk = 1, where the softmax is constant) against
    ``floor``, dv's norm."""
    got, want = got.double(), want.double()
    denom = float(want.norm())
    if denom < 1e-6 * floor:
        denom = floor
    return float((got - want).norm()) / denom


def planted_fault(torch, bwd, q, k, v, o, do, causal, window):
    """``bwd`` (the plain version or the kernel's launch) with the last
    :data:`BWD_FAULT_KEYS` keys' contribution dropped: dk and dv of those
    keys left zero, and for a causal call the rows that see them too."""
    cut = k.shape[1] - BWD_FAULT_KEYS
    if causal:
        f = list(bwd(*(t[:, :cut].contiguous() for t in (q, k, v, o, do)),
                     causal, window))
        f[0] = torch.cat([f[0], torch.zeros_like(q[:, cut:])], 1)
    else:
        f = list(bwd(q, k[:, :cut].contiguous(), v[:, :cut].contiguous(),
                     o, do, causal, window))
    for j in (1, 2):
        f[j] = torch.cat([f[j], torch.zeros_like(k[:, cut:])], 1)
    return f


def plain_bwd(q, k, v, o, do, causal, window):
    from repro_torch.kernels import flash_attention as fa
    return fa.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)


def hold_bwd(torch, got, want, dtype, label):
    """(dq, dk, dv) against the plain version's, each within
    :data:`BWD_LIMIT`: returns the largest relative L2 and max |err|."""
    name = str(dtype).split(".")[-1]
    limit, floor = BWD_LIMIT[name], float(want[2].double().norm())
    worst = worst_abs = 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.dtype == dtype and g.shape == w.shape,
              f"backward {name} {label}: {gname} {g.dtype} "
              f"{tuple(g.shape)}")
        rel = bwd_rel(torch, g, w, floor)
        check(rel < limit, f"backward {name} {label}: {gname} relative L2 "
              f"{rel:.3g} >= {limit}")
        worst = max(worst, rel)
        worst_abs = max(worst_abs, max_err(torch, g.float(), w.float()))
    return worst, worst_abs


def check_attention_bwd(torch, seed, dev="cuda"):
    """The backward kernels against ``attention_bwd_ref`` at every head
    size and case of :data:`BWD_CASES`, in fp32 and bf16: the variant
    ``bwd_variant`` names (the tensor-core kernel in bf16, the split one
    in fp32, column pairs at D = 160 and 256), whose second call on the
    same inputs must give the same bits, and the scalar yardstick too;
    with a planted fault the check must catch (D = 64, 128, 160, 256).
    Returns the largest max |err| by variant."""
    from repro_torch.kernels import flash_attention as fa
    worst_abs, worst = {"tc": 0.0, "split": 0.0, "scalar": 0.0}, {}
    n_caught = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        limit = BWD_LIMIT[name]
        for D in fa.HEAD_DIMS:
            routed = fa.bwd_variant(dtype, D)
            kinds = [routed, "scalar"] if routed != "scalar" else ["scalar"]
            for i, (B, Tq, Tk, H, G, causal, window) in enumerate(BWD_CASES):
                gen = torch.Generator(device=dev).manual_seed(seed + D + i)
                q, do = (torch.randn((B, Tq, H, D), generator=gen,
                                     device=dev).to(dtype)
                         for _ in range(2))
                k, v = (torch.randn((B, Tk, G, D), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
                o = fa.attention_ref(q, k, v, causal=causal,
                                     window=window).contiguous()
                want = plain_bwd(q, k, v, o, do, causal, window)
                case = (B, Tq, Tk, H, G, D, causal, window)
                for kind in kinds:
                    before = dict(fa.LAUNCHES)
                    got = fa._launch_bwd(q, k, v, o, do, causal, window,
                                         kind=kind)
                    check(fa.LAUNCHES["flash_attention_bwd"]
                          == before["flash_attention_bwd"] + 1 and
                          fa.LAUNCHES[f"flash_attention_bwd_{kind}"]
                          == before[f"flash_attention_bwd_{kind}"] + 1,
                          f"the {kind} backward did not launch once")
                    sync(torch, dev)
                    rel, err = hold_bwd(torch, got, want, dtype,
                                        (kind,) + case)
                    worst[name, kind] = max(worst.get((name, kind), 0.0),
                                            rel)
                    worst_abs[kind] = max(worst_abs[kind], err)
                    if kind != "scalar":
                        again = fa._launch_bwd(q, k, v, o, do, causal,
                                               window)
                        sync(torch, dev)
                        check(all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
                              f"backward {name} {case}: two {kind} "
                              f"calls differ")
                if Tk > 2 * BWD_FAULT_KEYS and D in (64, 128, 160, 256):
                    floor = float(want[2].double().norm())
                    f = planted_fault(torch, plain_bwd, q, k, v, o, do,
                                      causal, window)
                    rels = [bwd_rel(torch, a, w, floor)
                            for a, w in zip(f, want)]
                    check(max(rels) >= limit, f"backward {name} {case}: "
                          f"the planted fault passes the check ({rels})")
                    n_caught += 1
                    log(f"[train] planted fault {name} {case}: the last "
                        f"{BWD_FAULT_KEYS} keys dropped -> relative L2 "
                        f"dq {rels[0]:.3g} dk {rels[1]:.3g} dv "
                        f"{rels[2]:.3g} (caught: >= {limit})")
        for kind in ("tc", "split", "scalar"):
            if (name, kind) in worst:
                log(f"[train] backward kernel {kind} {name}: "
                    f"{len(BWD_CASES)} cases x the head sizes it takes "
                    f"within relative L2 {limit} (worst "
                    f"{worst[name, kind]:.3g})"
                    + ("; second calls bitwise" if kind != "scalar"
                       else ""))
    check(n_caught > 0, "no planted fault was checked")
    return worst_abs


#: the backward's shapes on pixtral-12b's and recurrentgemma-9b's training
#: steps (B, Tq, Tk, H, G, D, causal, window): 1,024 patches and 1,024
#: text tokens a sequence; 1,024 tokens under the 2,048 window (which
#: reaches every earlier key: causal); and recurrentgemma-9b's 4,096
#: positions, where the window binds
CUT_BWD_SHAPES = [(4, 2048, 2048, 32, 8, 160, True, None),
                  (4, 1024, 1024, 16, 1, 256, True, 2048),
                  (1, 4096, 4096, 16, 1, 256, True, 2048)]


def check_attention_bwd_path_shapes(torch, seed, dev="cuda"):
    """The backward kernel against its plain version at the shapes the
    training paths give it beyond :func:`time_attention_bwd`'s:
    seamless-m4t-large-v2's three (:data:`ENCDEC_BWD_SHAPES`) in bf16 and
    fp32, qwen3-1.7b's in fp32, and :data:`CUT_BWD_SHAPES` in bf16 and
    fp32.  At every shape (the tensor-core kernel in bf16, the split one
    in fp32, column pairs at D = 160 and 256) a second call must give the
    same bits and the kernel with the planted fault (the last
    :data:`BWD_FAULT_KEYS` keys dropped) must fail the check.  Returns
    the largest max |err| by variant."""
    from repro_torch.kernels import flash_attention as fa
    shapes = [(dt, s + (None,)) for s in ENCDEC_BWD_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    shapes.append((torch.float32, (TRAIN_B, TRAIN_T, TRAIN_T, 16, 8, 128,
                                   True, None)))
    shapes += [(dt, s) for s in CUT_BWD_SHAPES
               for dt in (torch.bfloat16, torch.float32)]
    worst_abs = {"tc": 0.0, "split": 0.0}
    for dtype, (B, Tq, Tk, H, G, D, causal, window) in shapes:
        name = str(dtype).split('.')[-1]
        q, k, v = attn_inputs(torch, B, Tq, H, G, D, dtype, seed, dev, Tk=Tk)
        o = fa._launch(q, k, v, causal, window)
        do = torch.randn_like(q)
        got = fa._launch_bwd(q, k, v, o, do, causal, window)
        want = plain_bwd(q, k, v, o, do, causal, window)
        sync(torch, dev)
        label = (B, Tq, Tk, H, G, D, causal, window)
        kind = fa.bwd_variant(dtype, D)
        check(kind != "scalar", f"backward {name} {label}: the path's "
              f"shape takes the scalar kernel")
        rel, err = hold_bwd(torch, got, want, dtype, label)
        worst_abs[kind] = max(worst_abs[kind], err)
        # every path shape: a second call bitwise, and the fault caught
        again = fa._launch_bwd(q, k, v, o, do, causal, window)
        sync(torch, dev)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"backward {name} {label}: two calls differ")
        floor = float(want[2].double().norm())
        f = planted_fault(torch, fa._launch_bwd, q, k, v, o, do, causal,
                          window)
        rels = [bwd_rel(torch, a, w, floor) for a, w in zip(f, want)]
        check(max(rels) >= BWD_LIMIT[name], f"backward {name} {label}: "
              f"the kernel with the planted fault passes ({rels})")
        note = (f"; a second call bitwise; the planted fault dq "
                f"{rels[0]:.3g} dk {rels[1]:.3g} dv {rels[2]:.3g} "
                f"(caught)")
        del again, f
        log(f"[train] backward ({kind}) at the path's shape {label} {name}: "
            f"relative L2 {rel:.3g} (limit {BWD_LIMIT[name]}), max |err| "
            f"{err:.3g}{note}")
        del q, k, v, o, do, got, want
    return worst_abs


#: the backward's timed shapes (B, Tq, Tk, H, G, D, causal, window), by
#: record entry: qwen3-1.7b's training step, qwen3-moe-30b-a3b's,
#: seamless-m4t-large-v2's three, pixtral-12b's and recurrentgemma-9b's
BWD_TIMED = {"flash_attention_bwd": (TRAIN_B, TRAIN_T, TRAIN_T, 16, 8, 128,
                                     True, None),
             MOE_ENTRY: (TRAIN_B, TRAIN_T, TRAIN_T, 32, 4, 64, True, None),
             "flash_attention_bwd_enc": ENCDEC_BWD_SHAPES[0] + (None,),
             "flash_attention_bwd_dec": ENCDEC_BWD_SHAPES[1] + (None,),
             "flash_attention_bwd_cross": ENCDEC_BWD_SHAPES[2] + (None,),
             "flash_attention_bwd_d160": CUT_BWD_SHAPES[0],
             "flash_attention_bwd_d256": CUT_BWD_SHAPES[1]}


def sdpa_grads(torch, q, k, v, do, causal, window):
    """SDPA's backward alone on (q, k, v, dO) in the kernels' layout: a
    function that takes the gradients of one SDPA forward (``enable_gqa``;
    the window as a mask where it binds), which runs outside it.  The
    port never calls it: it is the timed yardstick."""
    from repro_torch.kernels import flash_attention as fa
    Tq, Tk = q.shape[1], k.shape[1]
    mask = None if window is None or window >= Tq else fa._mask(
        Tq, Tk, causal, window, q.device)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    y = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    dos = do.transpose(1, 2)
    return lambda: torch.autograd.grad(y, (qs, ks, vs), dos,
                                       retain_graph=True)


def time_attention_bwd(torch, seed, dev="cuda", entries=None):
    """The tensor-core backward at each shape of :data:`BWD_TIMED` (bf16;
    the ``entries`` of it where given), held against its plain version
    on the same inputs: its time, the scalar yardstick's (by name), the
    plain version's, SDPA's backward alone (:func:`sdpa_grads`) and the
    bound.  Returns {entry: numbers}; ``flash_attention_bwd_scalar`` is
    the yardstick at qwen3-1.7b's shape."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for entry in entries or BWD_TIMED:
        B, Tq, Tk, H, G, D, causal, window = BWD_TIMED[entry]
        q, k, v = attn_inputs(torch, B, Tq, H, G, D, torch.bfloat16, seed,
                              dev, Tk=Tk)
        o = fa._launch(q, k, v, causal, window)
        do = torch.randn_like(q)
        label = (B, Tq, Tk, H, G, D, causal, window)
        want = plain_bwd(q, k, v, o, do, causal, window)
        rel, err = hold_bwd(torch, fa._launch_bwd(q, k, v, o, do, causal,
                                                  window),
                            want, torch.bfloat16, label)
        s_rel, s_err = hold_bwd(torch, fa._launch_bwd(
            q, k, v, o, do, causal, window, kind="scalar"), want,
            torch.bfloat16, ("scalar",) + label)
        del want
        ms = time_ms(torch, lambda: fa._launch_bwd(q, k, v, o, do, causal,
                                                   window), iters=50,
                     warmup=3)
        scalar_ms = time_ms(torch, lambda: fa._launch_bwd(
            q, k, v, o, do, causal, window, kind="scalar"), iters=10,
            warmup=2)
        plain_ms = time_ms(torch, lambda: fa.attention_bwd_ref(
            q, k, v, o, do, causal=causal, window=window), iters=10,
            warmup=2)
        library_ms = time_ms(torch, sdpa_grads(torch, q, k, v, do, causal,
                                               window), iters=50, warmup=3)
        # five products of 2 D a (query, key) pair the mask lets through
        # (the backward's counting form); q, k, v, o and dO read once,
        # dq, dk, dv written once
        flops = fa.attention_flops(q.shape, k.shape, causal, window,
                                   backward=True)
        n_bytes = 2 * (4 * B * Tq * H * D + 4 * B * Tk * G * D)
        bound = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
        log(f"[time] {entry} (B={B} Tq={Tq} Tk={Tk} H={H} G={G} D={D} "
            f"{'causal' if causal else 'bidirectional'}"
            f"{f' window {window}' if window else ''}, bf16): tensor "
            f"cores {ms:.4f} ms, scalar {scalar_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
            f"{bound[0]:.5f} ms ({bound[1]}); {ms / bound[0]:.1f} x the "
            f"bound, {ms / library_ms:.2f} x SDPA; against the plain "
            f"version relative L2 {rel:.3g} (scalar {s_rel:.3g}), max "
            f"|err| {err:.3g} (scalar {s_err:.3g})")
        out[entry] = {"ms": ms, "earlier_ms": scalar_ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound": bound, "err": err, "shape": label}
        if entry == "flash_attention_bwd":
            out["flash_attention_bwd_scalar"] = {
                "ms": scalar_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound": bound, "err": s_err,
                "shape": label}
        del q, k, v, o, do
        free_card(torch, dev)
    return out


#: the fp32 backward's own use (B, T, H, G, D, window), causal, by record
#: entry of the split kernel: qwen3-1.7b's shape, the fp32 gradient
#: check's, and pixtral-12b's and recurrentgemma-9b's training shapes,
#: their cut models' fp32 gradient checks' (column pairs; the window
#: reaches every earlier key), where the split kernel is timed beside the
#: scalar one by name (the entry with ``_scalar_`` for ``_split_``, the
#: yardstick; in bf16 it is timed beside the tensor-core kernel,
#: :func:`time_attention_bwd`)
FP32_BWD_TIMED = {
    "flash_attention_bwd_split_fp32": (TRAIN_B, TRAIN_T, 16, 8, 128, None),
    "flash_attention_bwd_split_fp32_d160": (TRAIN_B, 2 * TRAIN_T, 32, 8,
                                            160, None),
    "flash_attention_bwd_split_fp32_d256": (TRAIN_B, TRAIN_T, 16, 1, 256,
                                            2048)}


def scalar_entry(entry: str) -> str:
    """The scalar yardstick's record entry beside a split one."""
    return entry.replace("_split_", "_scalar_")


def time_fp32_bwd(torch, seed, dev="cuda"):
    """The fp32 backward at each shape of :data:`FP32_BWD_TIMED`, causal:
    the split kernel (what fp32 takes) and the scalar one (by name), each
    held against the plain version on the same inputs (:data:`BWD_LIMIT`),
    their relative L2 distances from a float64 run of the plain version
    logged side by side (the split kernel may be no farther than the
    scalar one); their times, the plain version's, SDPA's fp32 backward
    alone (``enable_gqa``, the forward outside the timed region; the port
    never calls it) and the bounds: six bf16 products a product at the
    bf16 peak (``bound``) and the scalar FFMAs at the fp32 peak
    (``ffma_bound``), bytes of q, k, v, o, dO in and dq, dk, dv out.
    Returns {entry: numbers}."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for entry, (B, T, H, G, D, window) in FP32_BWD_TIMED.items():
        q, k, v = attn_inputs(torch, B, T, H, G, D, torch.float32, seed, dev)
        o = fa._launch(q, k, v, True, window)
        do = torch.randn_like(q)
        label = (B, T, T, H, G, D, True, window)
        check(fa.bwd_variant(torch.float32, D) == "split",
              f"fp32 {label} routes to {fa.bwd_variant(torch.float32, D)}")
        check(window is None or window >= T, f"{entry}: the bound counts "
              f"no window")
        kernels = {
            "split": lambda: fa._launch_bwd(q, k, v, o, do, True, window),
            "scalar": lambda: fa._launch_bwd(q, k, v, o, do, True, window,
                                             kind="scalar")}
        want = fa.attention_bwd_ref(q, k, v, o, do, causal=True,
                                    window=window)
        with float64_math(torch, {}):   # its float32 casts taken for float64
            want64 = fa.attention_bwd_ref(
                *(t.double() for t in (q, k, v, o, do)), causal=True,
                window=window)
        floor = float(want64[2].norm())
        held, dist = {}, {}
        for kind, fn in kernels.items():
            got = fn()
            held[kind] = hold_bwd(torch, got, want, torch.float32,
                                  (kind,) + label)
            dist[kind] = max(bwd_rel(torch, g, w, floor)
                             for g, w in zip(got, want64))
            del got
        dist["plain"] = max(bwd_rel(torch, g, w, floor)
                            for g, w in zip(want, want64))
        del want, want64
        free_card(torch, dev)
        check(dist["split"] <= dist["scalar"], f"{entry}: the split kernel "
              f"is farther from a float64 run ({dist['split']:.3g}) than the "
              f"scalar one ({dist['scalar']:.3g})")
        ms = {"split": time_ms(torch, kernels["split"], iters=20, warmup=3),
              "scalar": time_ms(torch, kernels["scalar"], iters=5, warmup=1)}
        plain_ms = time_ms(torch, lambda: fa.attention_bwd_ref(
            q, k, v, o, do, causal=True, window=window), iters=2, warmup=1)
        library_ms = time_ms(torch, sdpa_grads(torch, q, k, v, do, True,
                                               window), iters=20, warmup=3)
        flops = fa.attention_flops(q.shape, k.shape, True, window,
                                   backward=True)
        n_bytes = q.element_size() * (4 * B * T * H * D + 4 * B * T * G * D)
        bound = bound_ms(n_bytes, 6 * flops, BF16_FLOPS_PER_S)
        ffma = bound_ms(n_bytes, flops, FP32_FLOPS_PER_S)
        for kind, name in (("split", entry), ("scalar", scalar_entry(entry))):
            out[name] = {
                "ms": ms[kind], "plain_ms": plain_ms,
                "library_ms": library_ms, "bound": bound,
                "ffma_bound": ffma, "err": held[kind][1],
                "dist64": dist[kind], "plain_dist64": dist["plain"],
                "shape": label}
        out[entry]["earlier_ms"] = ms["scalar"]
        log(f"[time] {entry} (B={B} T={T} H={H} G={G} D={D} causal"
            f"{f' window {window}' if window else ''}, float32): split "
            f"{ms['split']:.4f} ms, scalar {ms['scalar']:.4f} ms "
            f"({ms['scalar'] / ms['split']:.2f} x the split), plain "
            f"{plain_ms:.4f} ms, SDPA fp32 backward {library_ms:.4f} ms "
            f"({ms['split'] / library_ms:.2f} x SDPA), split bound "
            f"{bound[0]:.5f} ms ({bound[1]}), FFMA bound {ffma[0]:.5f} ms; "
            f"{ms['split'] / bound[0]:.1f} x the split bound; against the "
            f"plain version relative L2 split {held['split'][0]:.3g}, scalar "
            f"{held['scalar'][0]:.3g}; from a float64 run split "
            f"{dist['split']:.3g}, scalar {dist['scalar']:.3g}, plain "
            f"{dist['plain']:.3g}")
        del q, k, v, o, do
        free_card(torch, dev)
    return out


def bwd_device_times(torch, seed, times, dev="cuda", calls=10):
    """Device time a call of the tensor-core backward and of SDPA's
    backward at each shape of :data:`BWD_TIMED`, from ``torch.profiler``
    over ``calls`` back-to-back calls: the device time of every kernel
    recorded, over the calls recorded (the count of the kernel with the
    most time, which runs once a call), which leaves out the
    host's work (Python, autograd, the tensor maps) that the CUDA-event
    times of :func:`time_attention_bwd` include wherever the host is
    slower than the card.  Logged beside the profile's busy span and, for
    the kernel, the time a call replayed from a CUDA graph; added to
    ``times``' entries as ``device_ms`` and ``library_device_ms``, and
    the kernel's by pass (its kernels: the statistics, dQ, dK/dV, each
    over its own count) as ``device_pass_ms``.  A profiled phase: it runs
    after the training phase's step times."""
    import re
    from repro_torch.kernels import flash_attention as fa
    for entry, (B, Tq, Tk, H, G, D, causal, window) in BWD_TIMED.items():
        q, k, v = attn_inputs(torch, B, Tq, H, G, D, torch.bfloat16, seed,
                              dev, Tk=Tk)
        o = fa._launch(q, k, v, causal, window)
        do = torch.randn_like(q)
        library = sdpa_grads(torch, q, k, v, do, causal, window)

        def kernel():
            fa._launch_bwd(q, k, v, o, do, causal, window)
        out, notes = {}, []
        for name, fn in (("device_ms", kernel), ("library_device_ms",
                                                 library)):
            fn()
            sync(torch, dev)
            _, busy_us, by_name = profile_window(
                torch, lambda: [fn() for _ in range(calls)], dev)
            seen = by_name[0][2]   # the main kernel's count
            out[name] = sum(t for t, _, _ in by_name) / seen / 1e3
            if torch.device(dev).type == "cuda":
                check(out[name] > 0, f"{entry}: the profiler saw no device "
                      f"time for {name}")
            notes.append(f"{seen} calls recorded, busy span "
                         f"{busy_us / calls / 1e3:.4f} ms a call")
            if name == "device_ms":
                passes = {}
                for t_us, key, count in by_name:
                    m = re.search(r"(bwd_\w+<\d+(?:, \d+)?>)", key)
                    if m and count:
                        passes[m.group(1)] = t_us / count / 1e3
                out["device_pass_ms"] = passes
        graph = graph_ms(torch, kernel, calls=calls, replays=5)
        times[entry].update(out)
        log(f"[time] {entry}: device time a call (profiler) tensor cores "
            f"{out['device_ms']:.4f} ms ({notes[0]}; from a CUDA graph "
            f"{graph:.4f} ms), SDPA backward "
            f"{out['library_device_ms']:.4f} ms ({notes[1]}): "
            f"{out['device_ms'] / max(out['library_device_ms'], 1e-12):.2f}"
            f" x; bound "
            f"{times[entry]['bound'][0]:.5f} ms; by pass "
            + ", ".join(f"{p} {t:.4f} ms"
                        for p, t in out["device_pass_ms"].items()))
        del q, k, v, o, do, library
        free_card(torch, dev)


def sdpa_backend(names) -> str:
    """SDPA's backend, from the names of the kernels one call ran."""
    low = " ".join(names).lower()
    for key, backend in (("cudnn", "cuDNN"), ("fmha", "memory-efficient"),
                         ("flash", "flash"), ("gemm", "math")):
        if key in low:
            return backend
    return "unknown"


def sdpa_fp32_backends(torch, seed, fwd_shapes, dev="cuda"):
    """The backend that serves SDPA's fp32 yardstick, from the names of the
    kernels ``torch.profiler`` records over one forward call at each
    record entry's path shape (``fwd_shapes``: {entry: the path's
    shapes}), and at each shape of :data:`FP32_BWD_TIMED` under its
    entry: SDPA picks its backend in the forward, and the timed backward
    (:func:`sdpa_grads`) is that backend's.  A profiled phase.  Returns
    {entry: backend}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def backend_of(entry, fn):
        fn()
        sync(torch, dev)
        _, _, by_name = profile_window(torch, fn, dev)
        names = [key for t, key, _ in by_name if t > 0]
        backend = sdpa_backend(names)
        log(f"[time] {entry}: SDPA's fp32 yardstick runs its {backend} "
            f"backend (kernels by device time: "
            f"{', '.join(n[:72] for n in names[:4])})")
        return backend
    shapes = dict(fwd_shapes)
    for entry, (B, T, H, G, D, window) in FP32_BWD_TIMED.items():
        check(window is None or window >= T, f"{entry}: the backward's "
              f"yardstick shape has a window that binds")
        shapes[entry] = dict(B=B, T=T, H=H, G=G, D=D, causal=True)
    out = {}
    for entry, sh in shapes.items():
        B, T, H, G, D = sh["B"], sh["T"], sh["H"], sh["G"], sh["D"]
        Tk, causal = sh.get("Tk", T), sh.get("causal", True)
        q, k, v = (x.transpose(1, 2).contiguous() for x in attn_inputs(
            torch, B, T, H, G, D, torch.float32, seed, dev, Tk=Tk))
        out[entry] = backend_of(entry, lambda: sdpa(
            q, k, v, is_causal=causal, enable_gqa=True))
        del q, k, v
    free_card(torch, dev)
    return out


def train_flops(cfg, B, T) -> float:
    """A training step's model FLOPs: 6 per weight of every matrix product
    a token passes (the layers' projections and the head) and three
    times the causal attention's forward products (remat's recompute not
    counted)."""
    d, H, G, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = d * (H + 2 * G) * D + H * D * d + 3 * d * cfg.d_ff
    n_mm = cfg.num_layers * per_layer + d * cfg.vocab_size
    attn = 3 * cfg.num_layers * 4 * B * H * T * T * D / 2
    return 6 * n_mm * B * T + attn


@contextlib.contextmanager
def plain_attention():
    """The model-side attention swapped for its plain version (the package
    has no switch for it): autograd then differentiates
    ``attention_ref``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    original = ops.flash_attention
    ops.flash_attention = fa.attention_ref
    try:
        yield
    finally:
        ops.flash_attention = original


@contextlib.contextmanager
def plain_wkv6():
    """The model-side WKV6 swapped for its plain version: autograd then
    differentiates ``wkv6_scan_ref``'s loop."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as wk
    original = ops.wkv6
    ops.wkv6 = wk.wkv6_scan_ref
    try:
        yield
    finally:
        ops.wkv6 = original


#: the planted fault of each backward kernel, as ``faulty_backward`` puts
#: it in one layer: the attention's last key tile dropped, or WKV6's dS
#: carried across no chunk boundary
FAULTS = {"attention": f"the last {BWD_FAULT_KEYS} keys dropped",
          "wkv6": "dS carried across no chunk boundary"}


@contextlib.contextmanager
def faulty_backward(torch, kind="attention", layer_call=0):
    """A backward kernel with its planted fault (:data:`FAULTS`) in one
    layer: the ``layer_call``-th launch of a backward pass (0: the last
    layer's)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    module = fa if kind == "attention" else wk
    original, calls = module._launch_bwd, [0]

    def launch(*args):
        calls[0] += 1
        if calls[0] - 1 != layer_call:
            return original(*args)
        if kind == "attention":
            return tuple(planted_fault(torch, original, *args))
        T = args[0].shape[1]
        return wkv6_cut_bwd(torch, original, *args,
                            cuts=range(wk.CKPT_STEPS, T, wk.CKPT_STEPS))
    module._launch_bwd = launch
    try:
        yield calls
    finally:
        module._launch_bwd = original


def wkv6_cut_bwd(torch, launch_bwd, r, k, v, w, u, ckpt, dy, dsT, want_ds0,
                 cuts):
    """WKV6's planted fault: ``launch_bwd`` (the kernel's launch) piece by
    piece between the chunk boundaries ``cuts`` (steps, multiples of
    ``CKPT_STEPS``), each piece walked back from a zero dS instead of the
    one the next piece hands on (the last from ``dsT``)."""
    from repro_torch.kernels import rwkv6_scan as wk
    T = r.shape[1]
    edges = [0, *cuts, T]
    pieces, carry = [], dsT
    for lo, hi in reversed(list(zip(edges[:-1], edges[1:]))):
        part = [t[:, lo:hi].contiguous() for t in (r, k, v, w)]
        cp = ckpt[:, :, lo // wk.CKPT_STEPS:-(-hi // wk.CKPT_STEPS)]
        pieces.insert(0, launch_bwd(*part, u, cp.contiguous(),
                                    dy[:, lo:hi].contiguous(), carry,
                                    want_ds0 and lo == 0))
        carry = None
    grads = [torch.cat([p[i] for p in pieces], 1) for i in range(4)]
    return (*grads, sum(p[4] for p in pieces), pieces[0][5])


def gradient_gaps(names, g_a, g_b):
    """Relative L2 of the gradient ``g_a`` against ``g_b`` over the whole
    gradient, and the worst leaf's as (relative L2, name); a leaf whose
    ``g_b`` is zero is held to zero."""
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(g_a, g_b))
    den = sum(float(b.float().square().sum()) for b in g_b)
    leaf = max(((rel_l2(a, b) if float(b.float().norm()) > 0 else
                 float(a.float().norm()), n)
                for n, a, b in zip(names, g_a, g_b)))
    return (num / den) ** 0.5, leaf


class _Stop(Exception):
    """Ends a backward pass once the planted fault's layer is checked."""


def wkv6_layers_vs_plain(torch, model, params, batch, label, fault=False):
    """One step's backward with each WKV6 backward launch held, on its own
    inputs, against ``wkv6_bwd_ref``: every layer's dr, dk, dv, dw and du
    within :data:`BWD_LIMIT` of its dtype.  The model's gradients
    themselves are no measure past a few layers (``RWKV_GRAD_LAYERS``);
    this holds the kernel at every layer of the full depth.  With
    ``fault`` the backward runs once more with the planted fault in its
    first launch (the last layer's: dS carried across no chunk boundary),
    which must fail that layer's check, and stops there.  Returns the
    worst relative L2 of each gradient over the layers."""
    from repro_torch.kernels import rwkv6_scan as wk
    original, rels, stopped = wk._launch_bwd, [], [False]

    def held(faulty):
        def launch(*args):
            r, k, v, w, u, ckpt, dy, dsT, _ = args
            if faulty:
                out = wkv6_cut_bwd(torch, original, *args, cuts=range(
                    wk.CKPT_STEPS, r.shape[1], wk.CKPT_STEPS))
            else:
                out = original(*args)
            want = wk.wkv6_bwd_ref(r, k, v, w, u, ckpt[:, :, 0], dy, dsT)
            rels.append([bwd_rel(torch, g, h, 1.0)
                         for g, h in zip(out[:5], want[:5])])
            if faulty:
                stopped[0] = True
                raise _Stop
            return out
        return launch

    def backward(faulty):
        wk._launch_bwd = held(faulty)
        try:
            loss, _ = model.loss(batch)
            torch.autograd.grad(loss, list(params.values()))
        except Exception:
            if not stopped[0]:
                raise
        finally:
            wk._launch_bwd = original
    dtype = next(p for n, p in params.items() if n.endswith("wr")).dtype
    limit = BWD_LIMIT[str(dtype).split(".")[-1]]
    backward(False)
    worst = [max(x[j] for x in rels) for j in range(5)]
    log(f"[train] {label}: each of its {len(rels)} WKV6 backward launches "
        f"against the plain version on the same inputs: worst relative L2 "
        + ", ".join(f"{g} {x:.3g}" for g, x in zip(WKV_BWD_GRADS, worst))
        + f" (limit {limit})")
    check(max(worst) < limit, f"{label}: a layer's WKV6 backward off its "
          f"plain version by {max(worst):.3g} >= {limit}")
    if fault:
        rels.clear()
        backward(True)
        check(stopped[0] and len(rels) == 1, f"{label}: the planted fault "
              f"did not run")
        log(f"[train] {label}, planted fault ({FAULTS['wkv6']}) in the last "
            f"layer's backward: relative L2 "
            + ", ".join(f"{g} {x:.3g}" for g, x in zip(WKV_BWD_GRADS,
                                                       rels[0]))
            + f" ({'caught' if max(rels[0]) >= limit else 'passes'} at "
            f"{limit})")
        check(max(rels[0]) >= limit, f"{label}: the planted fault passes "
              f"the layer check")
    return worst


def grads_kernel_vs_plain(torch, model, params, batch, label, limit,
                          leaf_limit, fault=None, fault_launches=0,
                          launches=None, pin_routes=False):
    """One step's gradients with the kernels and with plain attention and
    WKV6 on the same weights and batch: relative L2 over the whole
    gradient (checked against ``limit``) and each leaf's (against
    ``leaf_limit``).  With ``fault`` (a key of :data:`FAULTS`) the
    kernels' gradients are taken once more with :func:`faulty_backward`
    (which must launch the backward ``fault_launches`` times, once a
    layer that has the kernel), and the check must refuse them.  A
    ``launches`` dict gets the attention kernels' launches
    (``flash_attention.LAUNCHES``) of the kernels' own pass.  With
    ``pin_routes`` (an MoE model) the plain pass takes the kernels'
    pass's routes (:func:`with_routes`, the forward's and remat's
    recompute's), so the two differ in continuous values alone.
    Returns the whole gradient's relative L2."""
    from repro_torch.kernels import flash_attention as fa
    names = list(params)
    routes = None

    def grads():
        loss, _ = model.loss(batch)
        return torch.autograd.grad(loss, [params[n] for n in names])

    def pinned(fn):
        return with_routes(torch, fn, replay=routes)[0] if pin_routes \
            else fn()

    def plain():
        with plain_attention(), plain_wkv6():
            return grads()

    def gaps(g_a, g_b):
        return gradient_gaps(names, g_a, g_b)
    if not pin_routes:
        g_plain = plain()
    before = dict(fa.LAUNCHES)
    if pin_routes:
        g_kernel, routes = with_routes(torch, grads)
    else:
        g_kernel = grads()
    if launches is not None:
        launches.update({n: fa.LAUNCHES[n] - before[n] for n in before})
    if pin_routes:
        g_plain = pinned(plain)
    rel, leaf = gaps(g_kernel, g_plain)
    del g_kernel
    log(f"[train] {label}: kernel vs plain gradients relative L2 {rel:.4g} "
        f"over the whole gradient (limit {limit}); worst leaf {leaf[1]} "
        f"{leaf[0]:.4g} (limit {leaf_limit})")
    check(rel < limit, f"{label}: gradients relative L2 {rel:.4g} >= "
          f"{limit}")
    check(leaf[0] < leaf_limit, f"{label}: leaf {leaf[1]} relative L2 "
          f"{leaf[0]:.4g} >= {leaf_limit}")
    if fault:
        with faulty_backward(torch, fault) as calls:
            g_fault = pinned(grads)
        check(calls[0] == fault_launches, f"{label}: the backward launched "
              f"{calls[0]} times under the planted fault, expected "
              f"{fault_launches}")
        f_rel, f_leaf = gaps(g_fault, g_plain)
        del g_fault
        caught = f_rel >= limit or f_leaf[0] >= leaf_limit
        log(f"[train] {label}, planted fault (the last layer's backward, "
            f"{FAULTS[fault]}): relative L2 {f_rel:.4g} over "
            f"the whole gradient ({'caught' if f_rel >= limit else 'passes'}"
            f" at {limit}); worst leaf {f_leaf[1]} {f_leaf[0]:.4g} "
            f"({'caught' if f_leaf[0] >= leaf_limit else 'passes'} at "
            f"{leaf_limit})")
        check(caught, f"{label}: the planted fault passes the gradient "
              f"checks")
    del g_plain
    return rel


@contextlib.contextmanager
def float64_math(torch, params):
    """``params`` (a model's trainable parameters) in float64, and
    ``torch.Tensor.float`` taken for ``torch.Tensor.double``, so that a
    step through the port's model and ``wkv6_scan_ref`` (every cast to
    float32 there is ``.float()``; every other cast follows its input)
    computes in float64 end to end; the parameters are put back after."""
    saved = {n: p.data for n, p in params.items()}
    original = torch.Tensor.float
    for p in params.values():
        p.data = p.data.double()
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = original
        for n, p in params.items():
            p.data = saved[n]


#: :func:`rwkv_grad_witness`'s depths, and the unit roundoff of each
#: dtype: the relative size of the witness's perturbation of the weights
WITNESS_DEPTHS = (2, 4, 8)
ROUNDOFF = {"bfloat16": 2.0 ** -8, "float32": 2.0 ** -24}


def rwkv_grad_witness(torch, seed=0, depths=WITNESS_DEPTHS,
                      dtypes=("bfloat16", "float32"), B=TRAIN_B, T=TRAIN_T,
                      vocab_chunk=TRAIN_VOCAB_CHUNK, dev="cuda", cfg=None):
    """Where rwkv6-3b's gradient gaps at depth come from.  Not run by
    :func:`main`; on the card::

        python -c "import torch, chip_smoke as cs; cs.rwkv_grad_witness(torch)"

    At full width, for each dtype and depth, one step's gradients on the
    same random weights and batch (phase 9's): with the WKV6 kernels, with
    plain WKV6, and in float64 end to end (:func:`float64_math`, plain
    WKV6) on those weights as they are, and again with each weight scaled
    by 1 + e z (e the dtype's :data:`ROUNDOFF`, z standard normal).  Logs
    the relative L2 over the whole gradient and on the worst leaf of the
    kernel's, the plain version's and the perturbed float64 gradients
    against the float64 one, and of the kernel's against the plain
    version's.  The perturbed run moves the weights by a rounding and
    rounds nothing after: it is the model's own sensitivity to its
    weights.  Returns the rows."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.models.types import ShapeSpec
    from repro_torch.train.train_loop import to_device, trainable_params
    on_card = torch.device(dev).type == "cuda"
    log(f"[witness] {gpu_name_and_limit() if on_card else dev}")
    rows = []
    for dtype in dtypes:
        for depth in depths:
            t0 = time.perf_counter()
            cfg_n = dataclasses.replace(cfg or configs.get(RWKV_ARCH),
                                        num_layers=depth, dtype=dtype)
            model = build_model(cfg_n, device=dev, seed=seed)
            params = trainable_params(model)
            names = list(params)
            stream = pipeline.for_model(cfg_n, ShapeSpec("train", T, B,
                                                         "train"), seed=seed)
            batch = to_device(stream.batch_at(0), model.device)

            def grads():
                with msettings.use(vocab_chunk=vocab_chunk):
                    loss, _ = model.loss(batch)
                    return [g.double() for g in torch.autograd.grad(
                        loss, [params[n] for n in names])]
            kernel = grads()
            with plain_wkv6():
                plain = grads()
                with float64_math(torch, params):
                    exact = grads()
                    gen = torch.Generator(device=dev).manual_seed(seed + 1)
                    with torch.no_grad():
                        for p in params.values():
                            p.mul_(1 + ROUNDOFF[dtype] * torch.randn(
                                p.shape, generator=gen, device=dev,
                                dtype=p.dtype))
                    moved = grads()
            row = {"dtype": dtype, "depth": depth,
                   "kernel": gradient_gaps(names, kernel, exact),
                   "plain": gradient_gaps(names, plain, exact),
                   "moved": gradient_gaps(names, moved, exact),
                   "kernel_vs_plain": gradient_gaps(names, kernel, plain)}
            rows.append(row)
            log(f"[witness] {cfg_n.name} {dtype} {depth} layers, {B} x {T} "
                f"tokens, relative L2 whole, worst leaf: "
                + "; ".join(f"{what} {row[key][0]:.4g}, {row[key][1][1]} "
                            f"{row[key][1][0]:.4g}" for key, what in (
                                ("kernel", "kernel vs float64"),
                                ("plain", "plain vs float64"),
                                ("moved", f"float64 with weights moved "
                                          f"{ROUNDOFF[dtype]:.3g} vs "
                                          f"float64"),
                                ("kernel_vs_plain", "kernel vs plain")))
                + f" ({time.perf_counter() - t0:.1f} s)")
            del model, params, kernel, plain, exact, moved
            free_card(torch, dev)
    return rows


def train_steps(torch, seed=0, arch=TRAIN_ARCH, steps=TRAIN_STEPS,
                B=TRAIN_B, T=TRAIN_T, vocab_chunk=TRAIN_VOCAB_CHUNK,
                dev="cuda", cfg=None):
    """``arch``'s training steps alone, as phase 9 runs them (its batch,
    ``TrainConfig`` defaults, remat, vocabulary chunks), without its
    checkpoint and checks: logs the package it ran, the step ms and their
    median after the first, and returns that median.  Not run by
    :func:`main`: :func:`tree_turns` runs it on the port of two trees in
    turns, each turn a process (:func:`use_tree`)."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.models.types import ShapeSpec
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              train_loop, trainable_params)
    cfg = cfg or configs.get(arch)
    stream = pipeline.for_model(cfg, ShapeSpec("train", T, B, "train"),
                                seed=seed)
    model = build_model(cfg, device=dev, seed=seed)
    tcfg = TrainConfig()
    params = trainable_params(model)
    step_fn, opt = make_train_step(model, tcfg)
    batches = pipeline.PrefetchIterator(stream, start_step=0,
                                        device=model.device)
    try:
        with msettings.use(vocab_chunk=vocab_chunk):
            _, _, hist = train_loop(model, tcfg, params, opt.init(params),
                                    batches, steps=steps, log_every=0,
                                    train_step=step_fn)
    finally:
        batches.close()
    step_s = hist["step_time"]
    med_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    card = gpu_name_and_limit() if torch.device(dev).type == "cuda" else dev
    log(f"[steps] {arch} from {Path(repro_torch.__file__).parent} on "
        f"{card}: {steps} steps of {B} x {T} tokens, step "
        f"ms {[round(x * 1e3, 2) for x in step_s]}, median after the "
        f"first {med_s * 1e3:.3f} ms")
    return med_s * 1e3

def serve_steps(torch, seed=0, arch=TRAIN_ARCH, n_requests=8,
                prompt_len=1024, slots=4, max_new=32, dev="cuda", cfg=None):
    """``arch`` served as phase 9 serves it (the published width, the
    same requests, a warm-up engine first), without its checks: logs the
    package it ran and the decode ms a step of two runs on warm engines,
    and returns them.  Not run by :func:`main` (see :func:`tree_turns`)."""
    import numpy as np
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import Engine, Request
    cfg = cfg or configs.get(arch)
    model = build_model(cfg, device=dev, seed=seed)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n_requests, prompt_len))
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=max_new)
            for i in range(n_requests)]
    max_len = prompt_len + max_new
    Engine(model, slots=slots, max_len=max_len, device=dev).generate_batch(
        [dataclasses.replace(reqs[0], max_new_tokens=2)])
    step_ms = []
    for _ in range(2):
        metrics = MetricsRegistry()
        eng = Engine(model, slots=slots, max_len=max_len, metrics=metrics,
                     device=dev)
        eng.serve(reqs)
        sync(torch, dev)
        dec_s = metrics.snapshot()["histograms"]["serve.decode"]["sum"]
        step_ms.append(dec_s / eng.decode_steps * 1e3)
    log(f"[steps] {arch} served from {Path(repro_torch.__file__).parent}: "
        f"{n_requests} requests x {prompt_len}-token prompts over {slots} "
        f"slots, {max_new} new tokens each; decode ms a step "
        f"{[round(x, 3) for x in step_ms]}")
    return step_ms


def use_tree(src) -> None:
    """Make ``src`` (another tree's ``src`` directory) the port this
    process imports: the port's modules this script loaded are dropped
    and ``src`` put first on ``sys.path``."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(src))


#: the readings :func:`tree_turns` takes in each turn
TURN_READINGS = (("train", TRAIN_ARCH, TRAIN_STEPS),
                 ("train", RWKV_ARCH, RWKV_STEPS),
                 ("serve", TRAIN_ARCH, None), ("serve", RWKV_ARCH, None))


def tree_turns(other, order="OTTOOTTO", out=None) -> dict:
    """The port of this tree (T) and of ``other`` (O, another checkout's
    root) in turns on one card, ``order`` naming whose turn each is; each
    turn is a process of its own (:func:`use_tree`) taking
    :data:`TURN_READINGS`: the training step's median ms
    (:func:`train_steps`) and the decode ms a step (:func:`serve_steps`,
    each of its two runs a reading).  Logs every reading and each side's
    median, least and greatest, writes them to ``out`` as JSON, and
    returns them.  Not run by :func:`main`::

        python -c "import chip_smoke as cs; cs.tree_turns('PARENT_ROOT',
            out='turns.json')"
    """
    roots = {"T": ROOT, "O": Path(other).resolve()}
    readings = {side: {f"{kind} {arch}": [] for kind, arch, _ in
                       TURN_READINGS} for side in roots}
    for turn, side in enumerate(order):
        code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
                f"import chip_smoke as cs; "
                f"cs.use_tree({str(roots[side] / 'src')!r}); "
                f"import torch; print('TURN ' + json.dumps(cs.turn(torch)))")
        done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True)
        sys.stderr.write(done.stderr[-4000:])
        check(done.returncode == 0, f"turn {turn} ({side}) exited "
              f"{done.returncode}: {done.stderr[-2000:]}")
        for line in done.stdout.splitlines():
            if line.startswith("[steps]"):
                log(f"[turns] {turn} {side}: {line}")
            elif line.startswith("TURN "):
                for key, values in json.loads(line[5:]).items():
                    readings[side][key].extend(values)
    summary = {"card": gpu_name_and_limit(), "order": order,
               "roots": {k: str(v) for k, v in roots.items()},
               "readings": readings}
    for side, by_key in readings.items():
        for key, xs in by_key.items():
            med = sorted(xs)[len(xs) // 2]
            log(f"[turns] {side} {key}: median {med:.3f} ms, least "
                f"{min(xs):.3f}, greatest {max(xs):.3f} over {len(xs)} "
                f"readings {[round(x, 3) for x in xs]}")
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(summary, indent=1))
    return summary


def turn(torch) -> dict:
    """One turn of :func:`tree_turns`: :data:`TURN_READINGS` in this
    process's port."""
    got = {}
    for kind, arch, steps in TURN_READINGS:
        if kind == "train":
            got[f"train {arch}"] = [train_steps(torch, arch=arch,
                                                steps=steps)]
        else:
            got[f"serve {arch}"] = serve_steps(torch, arch=arch)
        gc.collect()
        torch.cuda.empty_cache()
    return got


def count_step_flops(torch, model, step_fn, params, state, batch,
                     vocab_chunk) -> float:
    """``FlopCounterMode``'s total over one training step (``step_fn`` on
    ``batch``, the head over ``vocab_chunk`` columns)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import settings as msettings
    from repro_torch.train.train_loop import to_device
    batch = to_device(batch, model.device)
    with msettings.use(vocab_chunk=vocab_chunk), \
            FlopCounterMode(display=False) as counter:
        step_fn(params, state, batch)
    return float(counter.get_total_flops())


def train_kit(tcfg, vocab_chunk, stream=None):
    """The training phases' ``trainer`` and ``loop``.  ``trainer(model,
    keys)`` gives the model's parameters, optimizer state (``tcfg``'s) and
    a train step that records each step's launches of ``keys``;
    ``loop(model, params, state, step_fn, start, stop, batches_of=None,
    **kw)`` runs ``train_loop`` from step ``start`` to ``stop`` over
    ``batches_of`` (default ``stream``), prefetched onto the model's
    device, with the head over vocabulary chunks of ``vocab_chunk``."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import settings as msettings
    from repro_torch.train.train_loop import (make_train_step, train_loop,
                                              trainable_params)

    def trainer(model, keys=("flash_attention", "flash_attention_bwd",
                             "flash_attention_bwd_tc")):
        params = trainable_params(model)
        step_fn, opt = make_train_step(model, tcfg)
        counted = []

        def counting_step(p, s, batch):
            ops.reset_launches()
            out = step_fn(p, s, batch)
            launches = ops.launches()
            counted.append(tuple(launches[key] for key in keys))
            return out
        return params, opt.init(params), counting_step, counted

    def loop(model, params, state, step_fn, start, stop, batches_of=None,
             **kw):
        batches = pipeline.PrefetchIterator(batches_of or stream,
                                            start_step=start,
                                            device=model.device)
        try:
            with msettings.use(vocab_chunk=vocab_chunk):
                return train_loop(model, tcfg, params, state, batches,
                                  steps=stop, log_every=0, start_step=start,
                                  train_step=step_fn, **kw)
        finally:
            batches.close()
    return trainer, loop


def phase_train(torch, np, seed, card, dev="cuda", cfg=None, B=TRAIN_B,
                T=TRAIN_T, steps=TRAIN_STEPS, ckpt_step=TRAIN_CKPT_STEP,
                vocab_chunk=TRAIN_VOCAB_CHUNK, encdec_cfg=None,
                encdec=ENCDEC_TRAIN, rwkv_cfg=None, rwkv_steps=RWKV_STEPS,
                cut=CUT_TRAIN, moe=True):
    """Training on the card: the backward kernel against its plain
    version; qwen3-1.7b for ``steps`` steps through ``make_train_step``
    and ``train_loop`` (falling loss, exact launch counts each step, step
    time, tokens/s, TFLOP/s, peak memory, the backward's share), with a
    checkpoint after ``ckpt_step`` that a new model and optimizer restore
    and continue from; full-width kernel-vs-plain gradients in bf16 and
    in fp32 over 4 layers; seamless-m4t-large-v2's step over its
    bidirectional and cross attention; rwkv6-3b's training
    (:func:`phase_train_rwkv`, under ``"wkv6"``); recurrentgemma-9b's and
    pixtral-12b's at cut depth (:func:`phase_train_cut` over ``cut``,
    under ``"cut"``; ``{}`` leaves them out, as a rehearsal on the CPU
    does, which drives :func:`phase_train_cut` on its own);
    qwen3-moe-30b-a3b's at cut depth with Adafactor
    (:func:`phase_train_moe`, under ``"moe"``; ``moe=False`` leaves it
    out).  Returns the record entries' numbers."""
    import shutil
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.models.types import ShapeSpec
    from repro_torch.obs import MetricsRegistry
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              to_device, trainable_params)
    on_card = torch.device(dev).type == "cuda"
    check(fa.LAUNCHES["flash_attention_bwd"] == 0,
          "the backward kernel launched before the training phase")
    errs = check_attention_bwd(torch, seed, dev)
    err, split_err, scalar_err = errs["tc"], errs["split"], errs["scalar"]
    times = fp32_times = None
    if on_card:
        path_errs = check_attention_bwd_path_shapes(torch, seed, dev)
        err = max(err, path_errs["tc"])
        split_err = max(split_err, path_errs["split"])
        times = time_attention_bwd(torch, seed, dev, [
            e for e in BWD_TIMED if e not in CUT_ENTRY.values()])
        scalar_err = max(scalar_err,
                         times["flash_attention_bwd_scalar"]["err"])
        err = max([err] + [r["err"] for name, r in times.items()
                           if name != "flash_attention_bwd_scalar"])
    cfg = cfg or configs.get(TRAIN_ARCH)
    L = cfg.num_layers
    stream = pipeline.for_model(cfg, ShapeSpec("train", T, B, "train"),
                                seed=seed)
    tcfg = TrainConfig()
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ck = Checkpointer(str(ckpt_dir), keep=1)

    trainer, loop = train_kit(tcfg, vocab_chunk, stream)
    # the uninterrupted run: a checkpoint after step ckpt_step
    free_card(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    sync(torch, dev)
    t_init = time.perf_counter() - t0
    params, state, step_fn, counted = trainer(model)
    reg = MetricsRegistry()
    # phase 9c's yardstick: the losses and weights after MESH_STEPS steps
    params, state, hist_0 = loop(model, params, state, step_fn, 0,
                                 MESH_STEPS, obs=reg)
    mesh_ref = {"losses": list(hist_0["loss"]),
                "params": {k: p.detach().to("cpu", copy=True)
                           for k, p in params.items()}}
    params, state, hist_a = loop(model, params, state, step_fn, MESH_STEPS,
                                 ckpt_step, checkpointer=ck,
                                 checkpoint_every=ckpt_step, obs=reg)
    hist_a = {k: hist_0[k] + v for k, v in hist_a.items()}
    t0 = time.perf_counter()
    ck.wait()
    t_save = time.perf_counter() - t0
    params, state, hist_b = loop(model, params, state, step_fn, ckpt_step,
                                 steps, obs=reg)
    losses = hist_a["loss"] + hist_b["loss"]
    step_s = hist_a["step_time"] + hist_b["step_time"]
    peak = card_gib(torch, dev, peak=True)
    check(len(losses) == steps and reg.histogram("train.step").count
          == steps, f"{len(losses)} steps recorded of {steps}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    if on_card:
        check(counted == [(2 * L, L, L)] * steps, f"launches (forward, "
              f"backward, tensor-core backward) a step {counted}, "
              f"expected {(2 * L, L, L)}: {L} layers and their recompute, "
              f"{L} backward, every one on the tensor cores")
    n_bwd = sum(c[1] for c in counted)
    med_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    flops = train_flops(cfg, B, T)
    log(f"[train] {cfg.name} ({L} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B params, "
        f"{cfg.dtype}) on {card}: {steps} steps of {B} x {T} tokens, "
        f"AdamW (TrainConfig defaults), remat, vocab_chunk {vocab_chunk}; "
        f"init {t_init:.2f} s")
    log(f"[train] loss by step {[round(x, 4) for x in losses]}")
    log(f"[train] step ms {[round(s * 1e3, 2) for s in step_s]} (the "
        f"first builds and warms up); median after the first "
        f"{med_s * 1e3:.3f} ms, {B * T / med_s:,.1f} tokens/s, "
        f"{flops / med_s / 1e12:.1f} TFLOP/s (6 N + attention: "
        f"{flops / 1e12:.2f} TFLOP a step), peak {peak:.2f} GiB; "
        f"launches a step: forward {counted[0][0]}, backward "
        f"{counted[0][1]} ({counted[0][2]} on the tensor cores); the "
        f"checkpoint's write waited {t_save:.2f} s")
    share = None
    if times is not None:
        bwd_ms = times["flash_attention_bwd"]["ms"]
        share = L * bwd_ms / (med_s * 1e3)
        log(f"[train] the backward kernel's share of a step: {L} x "
            f"{bwd_ms:.4f} ms = {share:.1%} of {med_s * 1e3:.3f} ms")
    # one more step under FlopCounterMode (the kernels through their
    # counting forms), which the dry run's card cell is held to
    step_flops = count_step_flops(torch, model, step_fn, params, state,
                                  stream.batch_at(steps), vocab_chunk)
    log(f"[train] FlopCounterMode around one more step: {step_flops:.6g} "
        f"FLOP")
    # full-width gradients, kernel against plain, on the trained weights
    batch = to_device(stream.batch_at(steps), model.device)
    with msettings.use(vocab_chunk=vocab_chunk):
        rel_bf16 = grads_kernel_vs_plain(
            torch, model, params, batch, f"{cfg.name} {cfg.dtype} {L} "
            f"layers", TRAIN_GRAD_L2[cfg.dtype], TRAIN_LEAF_L2[cfg.dtype],
            fault="attention" if on_card else None, fault_launches=L)
    del model, params, state, step_fn
    free_card(torch, dev)

    # a new model and optimizer from the checkpoint: the next steps
    model = build_model(cfg, device=dev, seed=seed + 1)
    params, state, step_fn, _ = trainer(model)
    check(ck.restore_into(params, state) == ckpt_step,
          "the checkpoint restored another step")
    n_more = min(TRAIN_RESUMED, steps - ckpt_step)
    _, _, hist_c = loop(model, params, state, step_fn, ckpt_step,
                        ckpt_step + n_more)
    resumed = hist_c["loss"]
    want = losses[ckpt_step:ckpt_step + n_more]
    rels = [abs(a - b) / abs(b) for a, b in zip(resumed, want)]
    check(max(rels) <= 1e-5, f"resumed losses {resumed} against {want}")
    log(f"[train] restored step {ckpt_step} into a new model and "
        f"optimizer: losses {resumed} against {want} (relative "
        f"{max(rels):.3g}; bitwise: {resumed == want})")
    del model, params, state, step_fn
    free_card(torch, dev)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # fp32 over 4 layers
    cfg4 = dataclasses.replace(cfg, num_layers=min(4, L), dtype="float32")
    model = build_model(cfg4, device=dev, seed=seed)
    params = trainable_params(model)
    batch = to_device(stream.batch_at(0), model.device)
    before = dict(fa.LAUNCHES)
    with msettings.use(vocab_chunk=vocab_chunk):
        rel_fp32 = grads_kernel_vs_plain(
            torch, model, params, batch, f"{cfg.name} float32 "
            f"{cfg4.num_layers} layers", TRAIN_GRAD_L2["float32"],
            TRAIN_LEAF_L2["float32"])
    # fp32 takes the split backward, one launch a layer, and never the
    # scalar one
    n_split = fa.LAUNCHES["flash_attention_bwd_split"] \
        - before["flash_attention_bwd_split"]
    n_scalar = fa.LAUNCHES["flash_attention_bwd_scalar"] \
        - before["flash_attention_bwd_scalar"]
    if on_card:
        check(n_split == cfg4.num_layers and n_scalar == 0,
              f"the fp32 gradients launched the split backward {n_split} "
              f"and the scalar one {n_scalar} times, expected "
              f"{cfg4.num_layers} and 0")
        log(f"[train] {cfg.name} float32 {cfg4.num_layers} layers: "
            f"{n_split} flash_attention_bwd_split launches, {n_scalar} "
            f"scalar")
    del model, params
    free_card(torch, dev)
    # the fp32 backward at its own use (split and scalar) and the
    # tensor-core backward at D = 160 and 256, after qwen3-1.7b's timed
    # steps, which measured slower after them (the plain references at D =
    # 160 and 256 take several GiB)
    if on_card:
        times.update(time_attention_bwd(torch, seed, dev, CUT_ENTRY.values()))
        err = max([err] + [times[e]["err"] for e in CUT_ENTRY.values()])
        fp32_times = time_fp32_bwd(torch, seed, dev)
        for entry in FP32_BWD_TIMED:
            split_err = max(split_err, fp32_times[entry]["err"])
            scalar_err = max(scalar_err,
                             fp32_times[scalar_entry(entry)]["err"])

    # the encoder-decoder: bidirectional and cross backward on its path
    ecfg = encdec_cfg or configs.get("seamless-m4t-large-v2")
    ecfg = dataclasses.replace(ecfg, num_layers=encdec["layers"],
                               encoder_layers=encdec["layers"])
    eB, eT, eF = encdec["B"], encdec["T"], encdec["frames"]
    rng = np.random.default_rng(seed + 9)
    ebatch = {"tokens": rng.integers(0, ecfg.vocab_size, (eB, eT)).astype(
                  np.int32),
              "labels": rng.integers(0, ecfg.vocab_size, (eB, eT)).astype(
                  np.int32),
              "frontend_embeds": rng.standard_normal(
                  (eB, eF, ecfg.d_model)).astype(np.float32)}
    model = build_model(ecfg, device=dev, seed=seed)
    params = trainable_params(model)
    step_fn, opt = make_train_step(model, tcfg)
    fa.reset_launches()
    _, _, m = step_fn(params, opt.init(params), ebatch)
    e_loss = float(m["loss"])
    shapes = {key: n for key, n in fa.SHAPE_LAUNCHES.items()
              if key[0].startswith("bwd")}
    check(math.isfinite(e_loss), f"{ecfg.name}: loss {e_loss}")
    if on_card:
        n = encdec["layers"]
        want_shapes = {("bwd_tc", eF, eF, False): n,
                       ("bwd_tc", eT, eT, True): n,
                       ("bwd_tc", eT, eF, False): n}
        check(shapes == want_shapes, f"{ecfg.name}: backward launches "
              f"{shapes}, expected {want_shapes}")
    log(f"[train] {ecfg.name} ({encdec['layers']} + {encdec['layers']} "
        f"layers, full width, {ecfg.dtype}): one step over {eB} x {eF} "
        f"frames and {eB} x {eT} tokens, loss {e_loss:.4f}; backward "
        f"launches by (variant, Tq, Tk, causal) {shapes}")
    ebatch = to_device(ebatch, model.device)
    rel_encdec = grads_kernel_vs_plain(
        torch, model, params, ebatch, f"{ecfg.name} {ecfg.dtype} "
        f"{encdec['layers']} + {encdec['layers']} layers",
        TRAIN_GRAD_L2[ecfg.dtype], TRAIN_LEAF_L2[ecfg.dtype])
    del model, params, step_fn, opt
    free_card(torch, dev)

    wkv = phase_train_rwkv(torch, seed, card, trainer, loop, dev, rwkv_cfg,
                           B, T, rwkv_steps, vocab_chunk)
    cut_runs = phase_train_cut(torch, seed, card, trainer, loop, dev, cut,
                               None, B, CUT_STEPS, vocab_chunk, times)
    moe_run = phase_train_moe(torch, seed, card, dev, times=times) if moe \
        else None
    return {"launches": n_bwd, "split_launches": n_split,
            "scalar_launches": n_scalar, "encdec_launches": shapes,
            "err": err, "split_err": split_err, "scalar_err": scalar_err,
            "losses": losses, "step_ms": med_s * 1e3, "share": share,
            "step_flops": step_flops,
            "rel": (rel_bf16, rel_fp32, rel_encdec), "times": times,
            "fp32_times": fp32_times, "wkv6": wkv, "cut": cut_runs,
            "moe": moe_run, "mesh_ref": mesh_ref}


def phase_train_rwkv(torch, seed, card, trainer, loop, dev="cuda", cfg=None,
                     B=TRAIN_B, T=TRAIN_T, steps=RWKV_STEPS,
                     vocab_chunk=TRAIN_VOCAB_CHUNK):
    """rwkv6-3b's training on the card, through ``phase_train``'s
    ``trainer`` and ``loop``: the WKV6 backward kernel against its plain
    version (:func:`check_wkv6_bwd`) and timed (:func:`time_wkv6_bwd`);
    ``steps`` steps at full width and depth (a finite loss that falls,
    the launches of every step exact: each layer's forward and its
    recompute, one backward a layer, no attention; step ms, tokens/s,
    peak memory, the backward's share of a step); every layer's backward
    on a full-depth bf16 step held against the plain version on its own
    inputs, with the planted fault in the last layer's; one step's
    gradients with the kernels against plain WKV6 at
    :data:`RWKV_GRAD_LAYERS`, bf16 with the planted fault and fp32.
    Returns the record entry's numbers."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import rwkv6_scan as wk
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.models.types import ShapeSpec
    from repro_torch.train.train_loop import to_device, trainable_params
    on_card = torch.device(dev).type == "cuda"
    cfg = cfg or configs.get(RWKV_ARCH)
    L, H = cfg.num_layers, cfg.d_model // cfg.rwkv_head_dim
    check(wk.LAUNCHES["wkv6_bwd"] == 0,
          "the WKV6 backward launched before its training phase")
    errs = check_wkv6_bwd(torch, seed, (B, T, H, cfg.rwkv_head_dim), dev)
    times = time_wkv6_bwd(torch, seed, (B, T, H, cfg.rwkv_head_dim), dev) \
        if on_card else None
    stream = pipeline.for_model(cfg, ShapeSpec("train", T, B, "train"),
                                seed=seed)
    free_card(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, seed=seed)
    params, state, step_fn, counted = trainer(
        model, ("wkv6", "wkv6_bwd", "flash_attention", "flash_attention_bwd",
                "wkv6_bwd_block"))
    params, state, hist = loop(model, params, state, step_fn, 0, steps,
                               batches_of=stream)
    losses, step_s = hist["loss"], hist["step_time"]
    peak = card_gib(torch, dev, peak=True)
    check(len(losses) == steps, f"{len(losses)} steps recorded of {steps}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    if on_card:
        check(counted == [(2 * L, L, 0, 0, 0)] * steps, f"launches (wkv6, "
              f"wkv6_bwd, attention forward and backward, the WKV6 "
              f"yardstick) a step {counted}, expected {(2 * L, L, 0, 0, 0)}"
              f": {L} layers and their recompute, {L} backward, every one "
              f"the cluster kernel")
    med_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    log(f"[train] {cfg.name} ({L} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B params, "
        f"{cfg.dtype}) on {card}: {steps} steps of {B} x {T} tokens, AdamW "
        f"(TrainConfig defaults), remat, vocab_chunk {vocab_chunk}")
    log(f"[train] {cfg.name} loss by step {[round(x, 4) for x in losses]}")
    log(f"[train] {cfg.name} step ms {[round(x * 1e3, 2) for x in step_s]} "
        f"(the first warms up); median after the first {med_s * 1e3:.3f} "
        f"ms, {B * T / med_s:,.1f} tokens/s, peak {peak:.2f} GiB; launches "
        f"a step: wkv6 {counted[0][0]}, wkv6_bwd {counted[0][1]}")
    share = None
    if times is not None:
        share = L * times["ms"] / (med_s * 1e3)
        log(f"[train] the WKV6 backward's share of a step: {L} x "
            f"{times['ms']:.4f} ms = {share:.1%} of {med_s * 1e3:.3f} ms")
    del state
    free_card(torch, dev)
    # every layer's backward on the trained weights, full depth, against
    # the plain version on its own inputs
    batch = to_device(stream.batch_at(steps), model.device)
    with msettings.use(vocab_chunk=vocab_chunk):
        layer_rel = wkv6_layers_vs_plain(
            torch, model, params, batch, f"{cfg.name} {cfg.dtype} {L} "
            f"layers", fault=on_card)
    del model, params, step_fn
    free_card(torch, dev)

    # the model's gradients, kernel against plain, at RWKV_GRAD_LAYERS:
    # bf16 with the planted fault, then fp32
    rels = []
    for dtype in (cfg.dtype, "float32"):
        n_layers = min(RWKV_GRAD_LAYERS[dtype], L)
        cfg_n = dataclasses.replace(cfg, num_layers=n_layers, dtype=dtype)
        model = build_model(cfg_n, device=dev, seed=seed)
        params = trainable_params(model)
        batch = to_device(stream.batch_at(0), model.device)
        fault = "wkv6" if on_card and dtype == cfg.dtype else None
        before = wk.LAUNCHES["wkv6_bwd"]
        with msettings.use(vocab_chunk=vocab_chunk):
            rels.append(grads_kernel_vs_plain(
                torch, model, params, batch, f"{cfg.name} {dtype} "
                f"{n_layers} layers", TRAIN_GRAD_L2[dtype],
                TRAIN_LEAF_L2[dtype], fault=fault, fault_launches=n_layers))
        n = wk.LAUNCHES["wkv6_bwd"] - before
        if on_card and not fault:
            check(n == n_layers, f"the {dtype} gradients launched the WKV6 "
                  f"backward {n} times, expected {n_layers}")
        del model, params
        free_card(torch, dev)
    return {"launches": sum(c[1] for c in counted), "err": errs["cluster"],
            "block_err": errs["block"], "losses": losses, "step_ms": med_s * 1e3, "share": share,
            "peak": peak, "rel": tuple(rels), "layer_rel": layer_rel,
            "times": times}


class PatchStream:
    """``stream``'s batches, each sequence after ``frames`` random patch
    embeddings (``frontend_embeds``, standard normal, float32, drawn from
    (seed, step)) whose labels are -1, as the vision-language model's
    training batches carry them; with ``masked=False`` the labels are the
    tokens' alone, as the encoder-decoder's source frames carry none."""

    def __init__(self, stream, frames, d_model, seed, masked=True):
        self.stream, self.cfg = stream, stream.cfg
        self.frames, self.d_model, self.seed = frames, d_model, seed
        self.masked = masked

    def batch_at(self, step):
        import numpy as np
        batch = dict(self.stream.batch_at(step))
        B = batch["tokens"].shape[0]
        rng = np.random.default_rng((self.seed, step))
        batch["frontend_embeds"] = rng.standard_normal(
            (B, self.frames, self.d_model), dtype=np.float32)
        if self.masked:
            batch["labels"] = np.concatenate(
                [np.full((B, self.frames), -1, np.int32), batch["labels"]],
                1)
        return batch


def train_stream(cfg, B, T, seed, frames=0):
    """The training batches of ``cfg``: ``B`` sequences of ``T`` tokens,
    after ``frames`` patch embeddings each where ``frames`` > 0 (an
    encoder-decoder's: its source frames)."""
    from repro_torch.data import pipeline
    from repro_torch.models.types import ShapeSpec
    stream = pipeline.for_model(cfg, ShapeSpec("train", T, B, "train"),
                                seed=seed)
    return PatchStream(stream, frames, cfg.d_model, seed,
                       masked=not cfg.is_encdec) if frames else stream


def attention_layers(cfg) -> int:
    return sum(cfg.block_kind(i) == "attn" for i in range(cfg.num_layers))


def attention_calls(cfg) -> int:
    """Attention calls a forward: an encoder-decoder's encoder layers and
    its decoder's self- and cross-attention, else the attention layers."""
    return cfg.encoder_layers + 2 * cfg.num_layers if cfg.is_encdec \
        else attention_layers(cfg)


def attention_layers_vs_plain(torch, model, params, batch, label, limit):
    """One step's backward with each attention backward launch held, on
    its own inputs, against ``attention_bwd_ref``: every layer's dq, dk
    and dv within ``limit`` relative L2.  Returns the worst
    relative L2 of each over the layers and the number of launches (0 on
    the CPU, where the backward is autograd of the plain version)."""
    from repro_torch.kernels import flash_attention as fa
    original, rels = fa._launch_bwd, []

    def launch(q, k, v, o, do, causal, window, kind=None):
        out = original(q, k, v, o, do, causal, window, kind=kind)
        want = fa.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                    window=window)
        floor = float(want[2].double().norm())
        rels.append([bwd_rel(torch, g, w, floor) for g, w in zip(out, want)])
        return out
    fa._launch_bwd = launch
    try:
        loss, _ = model.loss(batch)
        torch.autograd.grad(loss, list(params.values()))
    finally:
        fa._launch_bwd = original
    worst = [max((x[j] for x in rels), default=0.0) for j in range(3)]
    log(f"[train] {label}: each of its {len(rels)} attention backward "
        f"launches against the plain version on the same inputs: worst "
        f"relative L2 dq {worst[0]:.3g}, dk {worst[1]:.3g}, dv "
        f"{worst[2]:.3g} (limit {limit})")
    check(max(worst) < limit, f"{label}: a layer's attention backward off "
          f"its plain version by {max(worst):.3g} >= {limit}")
    return worst, len(rels)


def phase_train_cut(torch, seed, card, trainer, loop, dev="cuda",
                    models=CUT_TRAIN, cfgs=None, B=TRAIN_B, steps=CUT_STEPS,
                    vocab_chunk=TRAIN_VOCAB_CHUNK, times=None):
    """recurrentgemma-9b's and pixtral-12b's training on the card at full
    width and the depth :data:`CUT_TRAIN` cuts them to (``models``: arch
    -> (layers, T, patches, gradient depth); ``cfgs``: arch -> a config in
    place of the full one, e.g. a reduced one on the CPU), through
    ``phase_train``'s ``trainer`` and ``loop``: ``steps`` steps (a finite
    loss that falls; the launches of every step exact, each attention
    layer's forward and its recompute and one backward, every one
    ``flash_attention_bwd_tc``; step ms, positions/s, peak memory, the
    backward's share of a step from ``times``, time_attention_bwd's);
    every attention backward launch of a bf16 step on the trained weights
    held against the plain version on its own inputs; one step's
    gradients with the kernels against plain attention at the gradient
    depth, with the planted fault in the last attention layer's backward,
    in the model's dtype and in fp32 (:data:`TRAIN_GRAD_L2` and
    :data:`TRAIN_LEAF_L2`; in fp32 one ``flash_attention_bwd_split``
    launch an attention layer in the kernels' pass, no scalar one).
    Returns {arch: numbers}."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.train.train_loop import to_device, trainable_params
    on_card = torch.device(dev).type == "cuda"
    out = {}
    for arch, (layers, T, frames, grad_layers) in models.items():
        cfg = dataclasses.replace((cfgs or {}).get(arch) or configs.get(arch),
                                  num_layers=layers)
        A = attention_layers(cfg)
        stream = train_stream(cfg, B, T, seed, frames)
        free_card(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=dev, seed=seed)
        params, state, step_fn, counted = trainer(
            model, ("flash_attention", "flash_attention_bwd",
                    "flash_attention_bwd_tc", "flash_attention_bwd_scalar"))
        params, state, hist = loop(model, params, state, step_fn, 0, steps,
                                   batches_of=stream)
        losses, step_s = hist["loss"], hist["step_time"]
        peak = card_gib(torch, dev, peak=True)
        check(len(losses) == steps, f"{len(losses)} steps recorded of {steps}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        want = [(2 * A, A, A, 0) if on_card else (0, 0, 0, 0)] * steps
        check(counted == want, f"{arch}: launches (attention forward, "
              f"backward, tensor-core backward, scalar backward) a step "
              f"{counted}, expected {want[0]}: {A} attention layers and "
              f"their recompute, {A} backward, every one on the tensor "
              f"cores")
        med_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
        positions = B * (frames + T)
        log(f"[train] {cfg.name} ({layers} layers of "
            f"{configs.get(arch).num_layers}: {A} attention, d_model "
            f"{cfg.d_model}, {sum(p.numel() for p in params.values()) / 1e9:.3f}"
            f" B params, {cfg.dtype}) on {card}: {steps} steps of {B} x "
            f"({frames} patches + {T} tokens), AdamW (TrainConfig "
            f"defaults), remat, vocab_chunk {vocab_chunk}")
        log(f"[train] {cfg.name} loss by step {[round(x, 4) for x in losses]}")
        log(f"[train] {cfg.name} step ms {[round(x * 1e3, 2) for x in step_s]}"
            f" (the first warms up); median after the first "
            f"{med_s * 1e3:.3f} ms, {positions / med_s:,.1f} positions/s "
            f"({B * T / med_s:,.1f} text tokens/s), peak {peak:.2f} GiB; "
            f"launches a step: forward {counted[0][0]}, backward "
            f"{counted[0][1]} ({counted[0][2]} on the tensor cores)")
        share = None
        if times is not None:
            bwd_ms = times[CUT_ENTRY[arch]]["ms"]
            share = A * bwd_ms / (med_s * 1e3)
            log(f"[train] {cfg.name}: the backward kernel's share of a step: "
                f"{A} x {bwd_ms:.4f} ms = {share:.1%} of {med_s * 1e3:.3f} ms")
        del state, step_fn
        free_card(torch, dev)
        # every attention backward of a step on the trained weights
        batch = to_device(stream.batch_at(steps), model.device)
        with msettings.use(vocab_chunk=vocab_chunk):
            layer_rel, n_held = attention_layers_vs_plain(
                torch, model, params, batch, f"{cfg.name} {cfg.dtype} "
                f"{layers} layers", BWD_LIMIT[cfg.dtype])
        check(n_held == (A if on_card else 0), f"{arch}: {n_held} backward "
              f"launches held, expected {A}")
        del model, params
        free_card(torch, dev)
        # the gradients, kernel against plain, at the check's depth: in
        # the model's dtype, then in fp32 (the split backward, column
        # pairs at D = 160 and 256), each with the planted fault in the
        # last attention layer's backward
        rel = {}
        for dtype in dict.fromkeys((cfg.dtype, "float32")):
            cfg_n = dataclasses.replace(cfg, num_layers=grad_layers,
                                        dtype=dtype)
            A_n = attention_layers(cfg_n)
            model = build_model(cfg_n, device=dev, seed=seed)
            params = trainable_params(model)
            batch = to_device(stream.batch_at(0), model.device)
            n = {}
            with msettings.use(vocab_chunk=vocab_chunk):
                rel[dtype] = grads_kernel_vs_plain(
                    torch, model, params, batch, f"{cfg.name} {dtype} "
                    f"{grad_layers} layers", TRAIN_GRAD_L2[dtype],
                    TRAIN_LEAF_L2[dtype],
                    fault="attention" if on_card else None,
                    fault_launches=A_n, launches=n)
            if dtype == "float32":
                # one split launch an attention layer, never the scalar
                split_n = n["flash_attention_bwd_split"]
                want = A_n if on_card else 0
                check(split_n == want and n["flash_attention_bwd_scalar"]
                      == 0, f"{arch}: the fp32 gradients launched the split "
                      f"backward {split_n} and the scalar one "
                      f"{n['flash_attention_bwd_scalar']} times, expected "
                      f"{want} and 0")
                log(f"[train] {cfg.name} float32 {grad_layers} layers: "
                    f"{split_n} flash_attention_bwd_split launches, "
                    f"{n['flash_attention_bwd_scalar']} scalar")
            del model, params
            free_card(torch, dev)
        out[arch] = {"launches": sum(c[1] for c in counted),
                     "losses": losses, "step_ms": med_s * 1e3,
                     "positions_per_s": positions / med_s, "peak": peak,
                     "share": share, "layer_rel": layer_rel,
                     "rel": rel[cfg.dtype], "rel_fp32": rel["float32"],
                     "split_launches": split_n}
    return out


def phase_train_moe(torch, seed, card, dev="cuda", cfg=None,
                    shape=MOE_TRAIN, B=TRAIN_B, T=TRAIN_T,
                    vocab_chunk=TRAIN_VOCAB_CHUNK, times=None):
    """qwen3-moe-30b-a3b's training on one card at full width and the
    depth :data:`MOE_TRAIN` cuts it to (``shape``: layers, steps, the
    gradient check's depth; ``cfg`` a config in place of the full one,
    e.g. a reduced one on the CPU), with Adafactor (:data:`MOE_TCFG`): a
    finite loss that falls; the launches of every step exact, each
    attention layer's forward and its recompute on the tensor cores and
    one ``flash_attention_bwd_tc`` a layer, none scalar; every attention
    backward launch of a bf16 step on the trained weights within 1e-2 of
    the plain version on its own inputs; one step's gradients with the
    kernels against plain attention at the check's depth, in bf16 with
    the routes pinned to the kernels' pass's (a route is a step function
    of bf16 logits) and in fp32 with the routes free, within
    :data:`TRAIN_GRAD_L2` and :data:`TRAIN_LEAF_L2`.  Returns the
    numbers."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.train.train_loop import (TrainConfig, to_device,
                                              trainable_params)
    on_card = torch.device(dev).type == "cuda"
    layers, steps, grad_layers = shape
    cfg = dataclasses.replace(cfg or configs.get(MOE_ARCH),
                              num_layers=layers)
    A = attention_layers(cfg)
    stream = train_stream(cfg, B, T, seed)
    trainer, loop = train_kit(TrainConfig(**MOE_TCFG), vocab_chunk, stream)
    t0 = time.perf_counter()
    free_card(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, seed=seed)
    keys = ("flash_attention_tc", "flash_attention_bwd_tc",
            "flash_attention_scalar", "flash_attention_bwd_scalar")
    params, state, step_fn, counted = trainer(model, keys)
    n_params = sum(p.numel() for p in params.values())
    params, state, hist = loop(model, params, state, step_fn, 0, steps)
    losses, step_s = hist["loss"], hist["step_time"]
    peak = card_gib(torch, dev, peak=True)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{cfg.name}: losses {losses}")
    check(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall: "
          f"{losses}")
    want = [(2 * A, A, 0, 0) if on_card else (0, 0, 0, 0)] * steps
    check(counted == want, f"{cfg.name}: launches (tensor-core forward, "
          f"backward, scalar forward, backward) a step {counted}, expected "
          f"{want[0]}")
    med_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    log(f"[train] {cfg.name} ({layers} layers of "
        f"{configs.get(MOE_ARCH).num_layers}, d_model {cfg.d_model}, "
        f"{cfg.num_experts} experts, top {cfg.experts_per_token}, "
        f"{n_params / 1e9:.3f} B params, {cfg.dtype}) on {card}: {steps} "
        f"steps of {B} x {T} tokens, Adafactor ({MOE_TCFG}), remat, "
        f"vocab_chunk {vocab_chunk}: loss by step "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x * 1e3, 2) for x in step_s]} (the first warms up), "
        f"median after the first {med_s * 1e3:.3f} ms, "
        f"{B * T / med_s:,.1f} tokens/s; peak {peak:.2f} GiB; launches a "
        f"step (forward tc, backward tc, scalar forward, backward) "
        f"{counted[0]}")
    share = None
    if times is not None:
        bwd_ms = times[MOE_ENTRY]["ms"]
        share = A * bwd_ms / (med_s * 1e3)
        log(f"[train] {cfg.name}: the backward kernel's share of a step: "
            f"{A} x {bwd_ms:.4f} ms = {share:.1%} of {med_s * 1e3:.3f} ms")
    del state, step_fn
    free_card(torch, dev)
    batch = to_device(stream.batch_at(steps), model.device)
    with msettings.use(vocab_chunk=vocab_chunk):
        layer_rel, n_held = attention_layers_vs_plain(
            torch, model, params, batch, f"{cfg.name} {cfg.dtype} {layers} "
            f"layers", BWD_LIMIT[cfg.dtype])
    check(n_held == (A if on_card else 0), f"{cfg.name}: {n_held} backward "
          f"launches held, expected {A}")
    del model, params
    free_card(torch, dev)
    rel, split_n = {}, 0
    for dtype in dict.fromkeys((cfg.dtype, "float32")):
        cfg_n = dataclasses.replace(cfg, num_layers=grad_layers, dtype=dtype)
        model = build_model(cfg_n, device=dev, seed=seed)
        params = trainable_params(model)
        batch = to_device(stream.batch_at(0), model.device)
        n = {}
        with msettings.use(vocab_chunk=vocab_chunk):
            rel[dtype] = grads_kernel_vs_plain(
                torch, model, params, batch, f"{cfg.name} {dtype} "
                f"{grad_layers} layers, routes "
                f"{'free' if dtype == 'float32' else 'pinned'}",
                TRAIN_GRAD_L2[dtype], TRAIN_LEAF_L2[dtype], launches=n,
                pin_routes=dtype != "float32")
        if dtype == "float32":
            split_n = n["flash_attention_bwd_split"]
            A_n = attention_layers(cfg_n) if on_card else 0
            check(split_n == A_n and n["flash_attention_bwd_scalar"] == 0,
                  f"{cfg.name}: the fp32 gradients launched the split "
                  f"backward {split_n} and the scalar one "
                  f"{n['flash_attention_bwd_scalar']} times, expected {A_n} "
                  f"and 0")
        del model, params
        free_card(torch, dev)
    log(f"[train] {cfg.name} phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": sum(c[1] for c in counted),
            "fwd_launches": sum(c[0] for c in counted), "losses": losses,
            "step_ms": med_s * 1e3, "tokens_per_s": B * T / med_s,
            "peak": peak, "share": share, "layer_rel": layer_rel,
            "rel": rel[cfg.dtype], "rel_fp32": rel["float32"],
            "split_launches": split_n, "params": n_params}


def phase_train_profile(torch, np, seed, dev="cuda", cfg=None, B=TRAIN_B,
                        T=TRAIN_T, vocab_chunk=TRAIN_VOCAB_CHUNK, frames=0):
    """Where a training step's time goes: the model (qwen3-1.7b unless
    ``cfg`` names another; its sequences after ``frames`` patch
    embeddings where ``frames`` > 0) rebuilt from the seed takes two
    warm-up steps,
    then one step under ``torch.profiler`` (device time by kernel, grouped
    as the backward kernel, its forward kernel, matrix products and the
    rest, and the busy share);
    then the optimizer's update alone on the same parameters, by the
    host clock around a synchronised call.  Last of the profiled phases,
    as the training phase's step times are taken without a profiler.
    Returns the card's busy share of the step and each group's share of
    its device time."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              to_device, trainable_params)
    cfg = cfg or configs.get(TRAIN_ARCH)
    model = build_model(cfg, device=dev, seed=seed)
    params = trainable_params(model)
    step_fn, opt = make_train_step(model, TrainConfig())
    state = opt.init(params)
    stream = train_stream(cfg, B, T, seed, frames)
    batches = [to_device(stream.batch_at(i), model.device) for i in range(3)]

    def step(i):
        with msettings.use(vocab_chunk=vocab_chunk):
            step_fn(params, state, batches[i])
        sync(torch, dev)
    step(0)
    step(1)
    wall, busy_us, by_name = profile_window(torch, lambda: step(2), dev)
    total = sum(t for t, _, _ in by_name) or 1.0
    groups = {"backward kernel": 0.0, "forward kernel": 0.0,
              "matrix products": 0.0, "the rest": 0.0}
    for t_us, key, _ in by_name:
        k = key.lower()
        if "bwd_" in k or "wkv6_du_sum" in k:
            groups["backward kernel"] += t_us
        elif "flash_fwd" in k or "wkv6_split" in k:
            groups["forward kernel"] += t_us
        elif any(w in k for w in ("gemm", "xmma", "cutlass", "nvjet",
                                  "sm90_")):
            groups["matrix products"] += t_us
        else:
            groups["the rest"] += t_us
    log(f"[profile] {cfg.name} ({cfg.num_layers} layers) train step ({B} x "
        f"{f'({frames} patches + {T})' if frames else T} tokens) under the "
        f"profiler: {wall * 1e3:.3f} ms wall, card busy "
        f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.1%}; device time "
        + ", ".join(f"{name} {t / 1e3:.3f} ms ({t / total:.1%})"
                    for name, t in groups.items()))
    for t_us, key, count in by_name[:12]:
        log(f"[profile]   {t_us / 1e3:9.3f} ms {t_us / total:6.1%} "
            f"x{count} {key[:90]}")
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    sync(torch, dev)
    t0 = time.perf_counter()
    opt.update(grads, state, params)
    sync(torch, dev)
    opt_ms = (time.perf_counter() - t0) * 1e3
    log(f"[profile] {cfg.name}: the AdamW update alone (clip, moments, "
        f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B weights): "
        f"{opt_ms:.3f} ms (host clock, synchronised)")
    del model, params, state, step_fn, opt, grads, batches
    free_card(torch, dev)
    return {"busy": busy_us / 1e6 / wall,
            **{name: t / total for name, t in groups.items()}}


# --- phase 9c: sharded training ----------------------------------------------

#: the one-card mesh's steps, held against phase 9b's first steps (the same
#: seed, batches and vocabulary chunks)
MESH_STEPS = 3
#: the cards' leg: a model's first step on a mesh against the one-card
#: step, its loss within this relative distance and its gradients within
#: the limits (TRAIN_GRAD_L2, TRAIN_LEAF_L2), by dtype
MESH_LOSS_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
#: qwen3-moe-30b-a3b on four cards: at full depth on (2, cards / 2) and
#: (1, cards), Adafactor (MOE_TCFG), BIG_STEPS steps; at this many fp32
#: layers on the first against the one-card step (fp32 keeps the routes
#: where bf16's reordered partial sums flip some)
MOE_MESH_FP32_LAYERS = 2
#: seamless-m4t-large-v2 at full depth on (2, cards / 2) against the
#: one-card step: its source frames a sequence, and AdamW at its peak rate
#: from the first step (the first step's loss and gradients, which the
#: check compares, precede any update)
ENCDEC_MESH_FRAMES = 4096
ENCDEC_MESH_TCFG = dict(warmup_steps=1)
#: recurrentgemma-9b and pixtral-12b at full width and depth on the
#: (cards, 1) mesh: patch embeddings a sequence, the steps, every rank's
#: peak memory under this
BIG_TRAIN = {"recurrentgemma-9b": 0, "pixtral-12b": 1024}
BIG_STEPS = 4
MESH_PEAK_GIB = 75.0
#: the elastic restore: qwen3-1.7b at full width over this many layers in
#: float32 (bf16 rounding would hide a 1e-5 check), saved after step 2 on
#: the first mesh, steps 3 and 4 on the second against the first's own
ELASTIC_LAYERS, ELASTIC_RTOL = 2, 1e-5
#: the ranks' time limit (the whole leg, the kernels' build excluded)
MESH_TIMEOUT_S = 1800
#: the parts of the cards' leg, in order (``--mesh-parts`` takes some)
MESH_PARTS = ("qwen3", "compression", "elastic", "big", "moe", "moe_fp32",
              "encdec")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def open_group(torch, rank, world, port, dev) -> None:
    """This process as rank ``rank`` of ``world`` (NCCL on a card, gloo
    on the CPU), its store on ``localhost:port``."""
    import torch.distributed as dist
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    if on_card and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)


def mesh_shapes(world):
    """The cards' (data, model) meshes: 2 x (cards / 2) and (cards) x 1,
    or (cards) x 1 alone under four cards."""
    return [(2, world // 2), (world, 1)] if world >= 4 else [(world, 1)]


def moe_mesh_shapes(world):
    """The MoE model's meshes: 2 x (cards / 2) and 1 x (cards), the
    experts split over the model axis on both, or (cards) x 1 alone under
    four cards."""
    return [(2, world // 2), (1, world)] if world >= 4 else [(world, 1)]


def mesh_model(torch, cfg, dims, seed, dev):
    """``cfg``'s model (an LM, or an EncDec) on a (data, model) mesh of
    ``dims``: its weights drawn from ``seed`` one whole leaf at a time on
    ``dev`` and sliced (``place.init_placed``), equal leaf for leaf to the
    one-card model from ``seed``.  Returns (mesh, rules, model)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import encdec as encdec_lib
    from repro_torch.models import lm as lm_lib
    from repro_torch.sharding import place
    from repro_torch.sharding import rules as R
    mod, cls = (encdec_lib, encdec_lib.EncDec) if cfg.is_encdec \
        else (lm_lib, lm_lib.LM)
    dev = torch.device(dev)
    mesh = make_mesh(dims, ("data", "model"), device_type=dev.type)
    rules = R.production_rules().with_overrides(
        **R.arch_overrides(cfg, dims[1]))
    placed = place.init_placed(mod.param_specs(cfg), rules, mesh,
                               seed=seed, compute_dtype=cfg.compute_dtype,
                               device=dev)
    return mesh, rules, cls(cfg, device=dev, params=placed)


def mesh_batches(torch, stream, rules, mesh, start, dev):
    """``stream``'s batches from ``start``, placed by the rules'
    ``batch_shardings`` (each rank its rows) on ``dev``."""
    from repro_torch.data import pipeline
    from repro_torch.sharding import rules as R
    sh = R.batch_shardings({k: torch.from_numpy(v) for k, v in
                            stream.batch_at(start).items()}, rules, mesh)
    return pipeline.PrefetchIterator(stream, start_step=start, device=dev,
                                     shardings=sh)


def leaf_gap(a, b) -> float:
    """``rel_l2(a, b)``; ``a``'s norm where ``b`` is zero."""
    return rel_l2(a, b) if float(b.float().norm()) > 0 \
        else float(a.float().norm())


def whole(t):
    """A DTensor's whole value, a copy on the host (every rank gathers
    it)."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t
            ).detach().to("cpu", copy=True)


def counting_step(torch, step_fn, counted):
    """``step_fn`` recording each call's kernel launches in ``counted``."""
    from repro_torch.kernels import ops

    def step(p, s, b):
        ops.reset_launches()
        out = step_fn(p, s, b)
        counted.append(ops.launches())
        return out
    return step


def phase_train_mesh(torch, seed, card, ref, dev="cuda", cfg=None,
                     B=TRAIN_B, T=TRAIN_T, steps=MESH_STEPS,
                     vocab_chunk=TRAIN_VOCAB_CHUNK):
    """Phase 9c on one card: an NCCL group of one rank, a 1 x 1 mesh, and
    qwen3-1.7b (``cfg``) at full width and depth trained ``steps`` steps
    as DTensors through the sharded step (``train_loop`` over
    ``PrefetchIterator(shardings=)``), held against phase 9b's
    plain-tensor steps from the same seed (``ref``: their losses and the
    weights after them): each loss and each weight leaf within relative
    1e-5, bitwise recorded; 2 L tensor-core forward and L tensor-core
    backward attention launches a step, none scalar.  The group is
    destroyed before any later phase opens a fake world."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.models import settings as msettings
    from repro_torch.sharding import ctx
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              train_loop, trainable_params)
    cfg = cfg or configs.get(TRAIN_ARCH)
    L = cfg.num_layers
    on_card = torch.device(dev).type == "cuda"
    free_card(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    open_group(torch, 0, 1, free_port(), dev)
    try:
        mesh, rules, model = mesh_model(torch, cfg, (1, 1), seed, dev)
        params = trainable_params(model)
        step_fn, opt = make_train_step(model, TrainConfig())
        counted = []
        state = opt.init(params)
        batches = mesh_batches(torch, train_stream(cfg, B, T, seed), rules,
                               mesh, 0, dev)
        try:
            with ctx.use(rules, mesh), msettings.use(vocab_chunk=vocab_chunk):
                params, state, hist = train_loop(
                    model, TrainConfig(), params, state, batches,
                    steps=steps, log_every=0,
                    train_step=counting_step(torch, step_fn, counted))
        finally:
            batches.close()
        peak = card_gib(torch, dev, peak=True)
        losses = hist["loss"]
        rel_loss = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref["losses"]))
        bitwise = losses == ref["losses"]
        rel_w = 0.0
        for k, p in params.items():
            got, want = whole(p), ref["params"][k]
            bitwise &= torch.equal(got, want)
            rel_w = max(rel_w, leaf_gap(got, want))
        del model, params, state, step_fn, opt
    finally:
        dist.destroy_process_group()
    free_card(torch, dev)
    check(rel_loss <= 1e-5 and rel_w <= 1e-5,
          f"the 1 x 1 mesh's steps against phase 9b's: losses {losses} "
          f"against {ref['losses']} (relative {rel_loss:.3g}), weights "
          f"within relative L2 {rel_w:.3g}")
    per_step = [(c["flash_attention_tc"], c["flash_attention_bwd_tc"],
                 c["flash_attention_scalar"], c["flash_attention_bwd_scalar"])
                for c in counted]
    if on_card:
        check(per_step == [(2 * L, L, 0, 0)] * steps,
              f"the mesh step's launches (tensor-core forward, backward, "
              f"scalar forward, backward) {per_step}, expected "
              f"{(2 * L, L, 0, 0)} a step")
    med_s = sorted(hist["step_time"][1:])[len(hist["step_time"][1:]) // 2]
    log(f"[mesh] {cfg.name} on a 1 x 1 mesh ("
        f"{'NCCL' if on_card else 'gloo'}, one rank) on {card}: "
        f"{steps} steps of {B} x {T} tokens as DTensors: losses {losses} "
        f"against phase 9b's {ref['losses']} (relative {rel_loss:.3g}; "
        f"bitwise, losses and weights: {bitwise}); weights within "
        f"relative L2 {rel_w:.3g}; step ms "
        f"{[round(s * 1e3, 2) for s in hist['step_time']]}, median after "
        f"the first {med_s * 1e3:.3f}; peak {peak:.2f} GiB; launches a "
        f"step (forward tc, backward tc, scalar forward, backward) "
        f"{per_step[0]}; {time.perf_counter() - t0:.1f} s in all")
    return {"losses": losses, "bitwise": bitwise, "rel_loss": rel_loss,
            "rel_weights": rel_w, "step_ms": med_s * 1e3,
            "launches": sum(c[0] for c in per_step),
            "bwd_launches": sum(c[1] for c in per_step)}


# --- phase 9d: the head over a split vocabulary --------------------------------

#: the vocabulary cut as a model axis of 2 and of 4 ranks cuts it
HEAD_PARTS = (2, 4)
#: each cut head's (lse, ll, dx, dw) within this relative L2 of the
#: one-process chunked head's and the plain head's, by dtype
HEAD_LIMIT = {"float32": 1e-5, "bfloat16": 1e-2}


def head_labels(torch, gen, B, T, V, chunk, parts, dev):
    """Random labels in [0, V), the first row's first ones each slice's
    first and last id and the ids on its first chunk's edge."""
    labels = torch.randint(0, V, (B, T), generator=gen, device=dev)
    edges = sorted({e for m in parts for k in range(m)
                    for e in (k * V // m, k * V // m + chunk - 1,
                              k * V // m + chunk, (k + 1) * V // m - 1)
                    if e < (k + 1) * V // m})
    labels[0, :len(edges)] = torch.tensor(edges, device=dev)
    return labels


def phase_head(torch, seed, card, dev="cuda", cfg=None, B=TRAIN_B, T=TRAIN_T,
               chunk=TRAIN_VOCAB_CHUNK, parts=HEAD_PARTS):
    """Phase 9d: qwen3-1.7b's head (``cfg``) at full width, its table and
    hidden states random from ``seed``, in float32 and in bf16, through
    the plain head (``plain_xent``), the one-process chunked head
    (``fused_xent``) and the split vocabulary's local pass and combine
    (``sliced_xent``) over each of ``parts`` slices, as the ranks of a
    model axis run it: per-token (lse, ll) and the gradients of the
    hidden states and the table of the training loss over them, each cut
    head's within :data:`HEAD_LIMIT` of the other two; and each head's
    peak memory over its forward and backward, beyond its inputs
    (``[head]`` lines).  Returns {dtype: {head: peak GiB}}."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm as lm_lib
    cfg = cfg or configs.get(TRAIN_ARCH)
    V, d = cfg.vocab_size, cfg.d_model
    on_card = torch.device(dev).type == "cuda"
    peaks = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(B, T, d, generator=gen, device=dev).to(dt)
        embed = {"embedding": (torch.randn(V, d, generator=gen, device=dev)
                               * 0.02).to(dt)}
        if not cfg.tie_embeddings:
            embed["head"] = (torch.randn(d, V, generator=gen, device=dev)
                             * d ** -0.5).to(dt)
        w = embed["embedding" if cfg.tie_embeddings else "head"]
        labels = head_labels(torch, gen, B, T, V, chunk, parts, dev)
        x.requires_grad_(True)
        w.requires_grad_(True)
        heads = {"plain": lambda: lm_lib.plain_xent(
                     L.head_apply(embed, cfg, x), labels),
                 "fused": lambda: lm_lib.fused_xent(embed, cfg, x, labels,
                                                    chunk)}
        heads.update({f"split{m}": functools.partial(
            lm_lib.sliced_xent, embed, cfg, x, labels, chunk, m)
            for m in parts})
        got, peaks[dtype] = {}, {}
        for name, head in heads.items():
            free_card(torch, dev)
            base = card_gib(torch, dev)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            lse, ll = head()
            loss, _ = lm_lib.xent_loss(lse, ll, labels, 0.0, 0.0)
            gx, gw = torch.autograd.grad(loss, [x, w])
            sync(torch, dev)
            peaks[dtype][name] = card_gib(torch, dev, peak=True) - base
            got[name] = (lse.detach(), ll.detach(), gx, gw)
            del lse, ll, loss, gx, gw
        gaps = {}
        for m in parts:
            for ref in ("fused", "plain"):
                gaps[m, ref] = [rel_l2(a, b) for a, b in
                                zip(got[f"split{m}"], got[ref])]
                check(max(gaps[m, ref]) <= HEAD_LIMIT[dtype],
                      f"the head cut in {m} ({dtype}) against the {ref} "
                      f"head: (lse, ll, dx, dw) within relative L2 "
                      f"{gaps[m, ref]}")
        log(f"[head] {cfg.name}'s head in {dtype} on {card}: {B} x {T} "
            f"tokens, d {d}, V {V:,}, chunks of {chunk:,}; (lse, ll, dx, "
            f"dw) relative L2 " + "; ".join(
                f"cut in {m} against the {ref} head "
                + ", ".join(f"{g:.3g}" for g in gaps[m, ref])
                for m, ref in gaps))
        log(f"[head] {dtype} peak GiB over forward + backward beyond the "
            f"inputs: " + ", ".join(f"{name} {p:.3f}"
                                    for name, p in peaks[dtype].items()))
        del got, x, w, embed
        free_card(torch, dev)
    return peaks


def phase_train_cards(torch, seed, card, n=None, dev_type="cuda",
                      reduced=False, timeout=MESH_TIMEOUT_S,
                      parts=MESH_PARTS):
    """Phase 9c where the machine has 2 or more cards: one process a card
    (``python3 chip_smoke.py --mesh-rank R ...``, :func:`mesh_leg`), NCCL
    between them; the phase fails if any rank exits non-zero (the others
    are then stopped) or outlasts ``timeout``.  Rank 0's lines are
    printed; returns its record.  ``dev_type="cpu"`` rehearses it over
    gloo CPU ranks (``reduced``: the reduced configs); ``parts`` are
    :func:`mesh_leg`'s."""
    import shutil
    n = n or torch.cuda.device_count()
    out = ROOT / "build" / "mesh_ranks"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    free_card(torch, "cuda" if dev_type == "cuda" else "cpu")
    port = free_port()
    args = ["--mesh-world", str(n), "--mesh-port", str(port), "--mesh-out",
            str(out), "--seed", str(seed), "--mesh-parts", ",".join(parts)] + \
        (["--mesh-cpu"] if dev_type == "cpu" else []) + \
        (["--mesh-reduced"] if reduced else [])
    logs = [open(out / f"rank{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--mesh-rank", str(r)] + args,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(n)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.poll() is not None) \
                    or time.perf_counter() - t0 > timeout:
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for line in (out / "rank0.log").read_text().splitlines():
        if line.startswith("["):
            print(line, flush=True)
    failed = [r for r, p in enumerate(procs) if p.returncode]
    for r in failed:
        tail = (out / f"rank{r}.log").read_text()[-3000:]
        print(f"[mesh] rank {r} exited {procs[r].returncode}:\n{tail}",
              file=sys.stderr, flush=True)
    check(not failed, f"the sharded training ranks {failed} failed")
    with open(out / "rank0.json") as f:
        rec = json.load(f)
    log(f"[mesh] {n} ranks done in {time.perf_counter() - t0:.1f} s")
    return rec


def mesh_rank_main(args) -> int:
    """One rank of :func:`phase_train_cards`: :func:`mesh_leg`, its record
    written as ``rank<R>.json`` in ``--mesh-out``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world = args.mesh_rank, args.mesh_world
    dev = "cpu" if args.mesh_cpu else f"cuda:{rank}"
    open_group(torch, rank, world, args.mesh_port, dev)
    try:
        rec = mesh_leg(torch, np, args.seed, dev, world, args.mesh_reduced,
                       args.mesh_parts.split(","))
        with open(Path(args.mesh_out) / f"rank{rank}.json", "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_leg(torch, np, seed, dev, world, reduced=False, parts=MESH_PARTS):
    """A rank's part of the cards' leg (see :func:`phase_train_cards`), by
    ``parts``: qwen3-1.7b on each of :func:`mesh_shapes` against the
    one-card step (``"qwen3"``, :func:`mesh_against_one`); the int8
    compressed all-reduce on the card's collectives (:func:`mesh_compression`);
    the elastic restore (:func:`mesh_elastic`); recurrentgemma-9b and
    pixtral-12b at full depth (``"big"``, :func:`mesh_run`);
    qwen3-moe-30b-a3b at full depth with Adafactor on each of
    :func:`moe_mesh_shapes` (``"moe"``) and at
    :data:`MOE_MESH_FP32_LAYERS` fp32 layers on the first against the
    one-card step (``"moe_fp32"``);
    seamless-m4t-large-v2 at full depth on the first of
    :func:`mesh_shapes` against the one-card step (``"encdec"``).
    ``reduced``: the reduced configs and 32 tokens a sequence (a CPU
    rehearsal)."""
    from repro_torch import configs
    get = (lambda a: configs.reduced(configs.get(a))) if reduced \
        else configs.get
    T = 32 if reduced else TRAIN_T
    on_card = torch.device(dev).type == "cuda"
    rec = {"card": gpu_name_and_limit() if on_card else "cpu"}
    if "qwen3" in parts:
        rec["qwen3"] = mesh_against_one(
            torch, seed, dev, get(TRAIN_ARCH), TRAIN_B, T, mesh_shapes(world),
            chunked=[s for s in mesh_shapes(world)[:1] if s[1] > 1])
    if "compression" in parts:
        rec["compression"] = mesh_compression(torch, seed, dev, world,
                                              get(TRAIN_ARCH), TRAIN_B, T)
    if "elastic" in parts:
        rec["elastic"] = mesh_elastic(
            torch, seed, dev, world, dataclasses.replace(
                get(TRAIN_ARCH), num_layers=ELASTIC_LAYERS,
                dtype="float32"), TRAIN_B, T)
    for arch, frames in BIG_TRAIN.items() if "big" in parts else ():
        cfg = get(arch)
        frames = min(frames, cfg.frontend_len) if reduced else frames
        stream = train_stream(cfg, TRAIN_B, T, seed, frames)
        rec[arch] = mesh_run(torch, cfg, (world, 1), seed, dev, stream,
                             TRAIN_B, T + frames, BIG_STEPS, big=True)
    from repro_torch.train.train_loop import TrainConfig
    cfg, tcfg = get(MOE_ARCH), TrainConfig(**MOE_TCFG)
    if "moe" in parts:
        stream = train_stream(cfg, TRAIN_B, T, seed)
        # the last mesh again with the head over vocabulary chunks, held
        # to its plain-head run and to the one-card loss (the model's
        # weights fill a card; its gradients do not fit beside them)
        last = moe_mesh_shapes(world)[-1]
        split = last[1] > 1
        one = {"loss": one_card_loss(torch, seed, dev, cfg, stream)} \
            if split else None
        kept = {} if split else None
        rec["moe"] = {f"{d}x{m}": mesh_run(
            torch, cfg, (d, m), seed, dev, stream, TRAIN_B, T, BIG_STEPS,
            big=True, tcfg=tcfg, compare=(d, m) == last and split,
            keep=kept if (d, m) == last else None)
            for d, m in moe_mesh_shapes(world)}
        if split:
            plain = {"loss": rec["moe"][f"{last[0]}x{last[1]}"]["losses"][0],
                     "grads": kept}
            rec["moe"][f"{last[0]}x{last[1]} chunked"] = mesh_run(
                torch, cfg, last, seed, dev, stream, TRAIN_B, T, BIG_STEPS,
                big=True, tcfg=tcfg, compare=True,
                one=one, plain=plain,
                vocab_chunk=TRAIN_VOCAB_CHUNK)
            del plain, kept
    if "moe_fp32" in parts:
        rec["moe_fp32"] = mesh_against_one(
            torch, seed, dev, dataclasses.replace(
                cfg, num_layers=MOE_MESH_FP32_LAYERS, dtype="float32"),
            TRAIN_B, T, moe_mesh_shapes(world)[:1], tcfg=tcfg)
    if "encdec" in parts:
        cfg = get("seamless-m4t-large-v2")
        frames = cfg.frontend_len if reduced else ENCDEC_MESH_FRAMES
        rec["encdec"] = mesh_against_one(
            torch, seed, dev, cfg, TRAIN_B, T, mesh_shapes(world)[:1],
            frames=frames, steps=BIG_STEPS, big=True,
            tcfg=TrainConfig(**ENCDEC_MESH_TCFG))
    return rec


def mesh_run(torch, cfg, dims, seed, dev, stream, B, T, steps, one=None,
             compare=False, big=False, tcfg=None, vocab_chunk=0, plain=None,
             keep=None):
    """``cfg`` trained ``steps`` steps on the (data, model) mesh ``dims``
    through ``train_loop`` and the sharded prefetch, then one more step
    under the profiler, the head over vocabulary chunks of
    ``vocab_chunk`` ids (0: the plain head): each rank's parameter bytes
    equal to ``bytes_per_device``; finite losses (and, ``big``, the last
    below the first, every rank's peak under ``MESH_PEAK_GIB``); every
    attention backward launch on its dtype's kernel (the tensor cores in
    bf16, the split kernel in fp32).  With ``compare`` (on every rank)
    the first step's gradients are gathered whole leaf by leaf and, with
    its loss, held on rank 0 to ``one`` (rank 0's one-card first step:
    its loss, and its gradients where it has them) and to ``plain`` (the
    same mesh's plain-head run: its first loss and ``keep``) within the
    limits of ``cfg``'s dtype; ``keep``, a dict, takes rank 0's whole
    gradients.  ``tcfg``: the TrainConfig (default: the defaults,
    AdamW).  Returns the record: losses, step ms (median after the
    first), positions/s, peak GiB (this rank's, and every rank's), the
    collectives' share of the profiled step's device time, launches a
    step."""
    import torch.distributed as dist
    from repro_torch.models import settings as msettings
    from repro_torch.sharding import ctx
    from repro_torch.sharding import rules as R
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              train_loop, trainable_params)
    rank, on_card = dist.get_rank(), torch.device(dev).type == "cuda"
    name = f"{cfg.name} {dims[0]} x {dims[1]}"
    free_card(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh, rules, model = mesh_model(torch, cfg, dims, seed, dev)
    sync(torch, dev)
    t_init = time.perf_counter() - t0
    local = sum(p.to_local().numel() * p.to_local().element_size()
                for p in model.parameters())
    want = R.bytes_per_device(model.param_specs(), rules, mesh,
                              dtype=cfg.compute_dtype)
    check(local == want, f"{name}: rank {rank} holds {local} parameter "
          f"bytes, bytes_per_device says {want}")
    params = trainable_params(model)
    refs = {name: ref for name, ref in (("one", one), ("plain", plain))
            if rank == 0 and ref is not None}
    # each reference's gradient gap as it comes: sum of squared
    # differences, of squares, and the worst leaf's (gap, name)
    sums = {name: [0.0, 0.0, (0.0, "")] for name, ref in refs.items()
            if ref.get("grads") is not None}
    recorded = []

    def record(g):      # the first step's gradients, whole on rank 0
        if recorded:
            return g
        recorded.append(True)
        for k, v in g.items():
            w = v.full_tensor() if hasattr(v, "full_tensor") else v
            if rank:
                continue
            for name, acc in sums.items():
                a, b = w.float(), refs[name]["grads"][k].to(w.device).float()
                acc[0] += float((a - b).square().sum())
                acc[1] += float(b.square().sum())
                acc[2] = max(acc[2], (leaf_gap(a, b), k))
            if keep is not None:
                keep[k] = w.detach().to("cpu", copy=True)
        return g
    tcfg = tcfg or TrainConfig()
    step_fn, opt = make_train_step(model, tcfg,
                                   compress_fn=record if compare else None)
    counted = []
    state = opt.init(params)
    batches = mesh_batches(torch, stream, rules, mesh, 0, dev)
    try:
        with ctx.use(rules, mesh), msettings.use(vocab_chunk=vocab_chunk):
            params, state, hist = train_loop(
                model, tcfg, params, state, batches, steps=steps,
                log_every=0, train_step=counting_step(torch, step_fn,
                                                      counted))
            step = counting_step(torch, step_fn, counted)
            batch = next(batches)
            kernels = []
            wall, busy_us, by_name = profile_window(
                torch, lambda: step(params, state, batch), dev, kernels)
    finally:
        batches.close()
    split = collective_waits([d for _, d, k in kernels if "nccl" in
                              k.lower()])
    peak = card_gib(torch, dev, peak=True)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    losses = hist["loss"]
    total = sum(t for t, _, _ in by_name) or 1.0
    coll = sum(t for t, key, _ in by_name if "nccl" in key.lower())
    med_s = sorted(hist["step_time"][1:])[len(hist["step_time"][1:]) // 2]
    n_attn = attention_calls(cfg)
    # the dtype's backward: the tensor cores in bf16, the split kernel
    # (three bf16 pieces) in fp32
    variant = "tc" if cfg.dtype == "bfloat16" else "split"
    per_step = [(c["flash_attention_bwd"], c[f"flash_attention_bwd_{variant}"])
                for c in counted]
    check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    if on_card:
        check(per_step == [(n_attn, n_attn)] * (steps + 1),
              f"{name}: attention backward launches (all, {variant}) a "
              f"step {per_step}, expected {(n_attn, n_attn)}")
    if big:
        check(losses[-1] < losses[0], f"{name}: the loss did not fall: "
              f"{losses}")
        if on_card:
            check(peak < MESH_PEAK_GIB, f"{name}: rank {rank}'s peak "
                  f"{peak:.2f} GiB")
    gaps = {}
    whom = {"one": "the one-card step", "plain": "the plain head's run"}
    for ref_name, ref in refs.items() if compare else ():
        check(abs(losses[0] - ref["loss"]) <= MESH_LOSS_RTOL[cfg.dtype]
              * abs(ref["loss"]), f"{name}: first loss {losses[0]} "
              f"against {whom[ref_name]}'s {ref['loss']}")
        if ref_name in sums:
            num, den, (worst, leaf) = sums[ref_name]
            gaps[ref_name] = ((num / den) ** 0.5, worst, leaf)
            check(gaps[ref_name][0] < TRAIN_GRAD_L2[cfg.dtype]
                  and worst < TRAIN_LEAF_L2[cfg.dtype],
                  f"{name}: gradients against {whom[ref_name]}'s: whole "
                  f"{gaps[ref_name][0]:.4g}, worst leaf {worst:.4g} "
                  f"({leaf})")
    rel = gaps.get("one")
    r = {"losses": losses, "step_ms": med_s * 1e3, "vocab_chunk": vocab_chunk,
         "positions_per_s": B * T / med_s, "peak_gib": peak,
         "peaks_gib": peaks, "grad_rel_plain": gaps.get("plain"),
         "first_loss_plain": plain and plain["loss"],
         "collective_share": coll / total, "busy": busy_us / 1e6 / wall,
         "collective_ms": coll / 1e3, "collective_transfer_ms":
         split and split[0] / 1e3, "collective_wait_ms":
         split and split[1] / 1e3,
         "init_s": t_init, "launches": per_step[0], "grad_rel": rel,
         "param_bytes": local, "first_loss_one": one and one["loss"]}
    head = f"chunks of {vocab_chunk:,}" if vocab_chunk else "plain"
    log(f"[mesh] {name} ({head} head): {steps} steps of {B} x {T} "
        f"positions, losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(s * 1e3, 1) for s in hist['step_time']]}, median after "
        f"the first {med_s * 1e3:.1f} ({B * T / med_s:,.1f} positions/s); "
        f"peak GiB by rank {[round(p, 2) for p in peaks]}; "
        f"rank {rank}: peak {peak:.2f} GiB, {local / 2**30:.3f} GiB of "
        f"parameters (bytes_per_device), init {t_init:.1f} s; the profiled "
        f"step: collectives {coll / total:.1%} of device time ("
        + (f"{coll / 1e3:.3f} ms: transfer about {split[0] / 1e3:.3f}, "
           f"waiting for later ranks {split[1] / 1e3:.3f}" if split else
           f"{coll / 1e3:.3f} ms; ranks' kernel counts differ, not split")
        + f"), card busy "
        f"{busy_us / 1e6 / wall:.1%} of {wall * 1e3:.1f} ms; attention "
        f"backward launches a step (all, {variant}) {per_step[0]}"
        + "".join(
            f"; against {whom[n]}: first loss {ref['loss']:.8g} (relative "
            f"{abs(losses[0] - ref['loss']) / abs(ref['loss']):.3g})"
            + (f", gradients whole {gaps[n][0]:.4g}, worst leaf "
               f"{gaps[n][1]:.4g} ({gaps[n][2]})" if n in gaps else "")
            for n, ref in refs.items() if compare))
    del model, params, state, step_fn, opt
    free_card(torch, dev)
    return r


def mesh_against_one(torch, seed, dev, cfg, B, T, meshes, frames=0,
                     steps=MESH_STEPS, big=False, tcfg=None, chunked=()):
    """``cfg`` on each of ``meshes`` (:func:`mesh_run`, ``steps`` steps,
    ``frames`` a sequence), its first step held to the one-card step on
    rank 0's card (plain tensors, the same seed and batch); on each mesh
    of ``chunked`` again with the head over vocabulary chunks of
    ``TRAIN_VOCAB_CHUNK`` (``"<d>x<m> chunked"``), held to the one-card
    step and to the same mesh's plain-head run."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import to_device, trainable_params
    stream = train_stream(cfg, B, T, seed, frames)
    one = None
    if dist.get_rank() == 0:
        model = build_model(cfg, device=dev, seed=seed)
        params = trainable_params(model)
        loss, _ = model.loss(to_device(stream.batch_at(0), model.device))
        g = torch.autograd.grad(loss, list(params.values()))
        one = {"loss": float(loss),
               "grads": {k: v.cpu() for k, v in zip(params, g)}}
        del model, params, g, loss
        free_card(torch, dev)
    dist.barrier()
    out = {}
    for d, m in meshes:
        kept = {} if (d, m) in chunked else None
        out[f"{d}x{m}"] = mesh_run(torch, cfg, (d, m), seed, dev, stream, B,
                                   T + frames, steps, one=one, compare=True,
                                   big=big, tcfg=tcfg, keep=kept)
        if kept is not None:
            out[f"{d}x{m} chunked"] = mesh_run(
                torch, cfg, (d, m), seed, dev, stream, B, T + frames, steps,
                one=one, compare=True, big=big, tcfg=tcfg,
                vocab_chunk=TRAIN_VOCAB_CHUNK, plain={
                    "loss": out[f"{d}x{m}"]["losses"][0], "grads": kept})
    return out


def one_card_loss(torch, seed, dev, cfg, stream):
    """The first batch's loss of ``cfg``'s one-card model from ``seed``,
    no gradient, the head over vocabulary chunks (rank 0; None on the
    others, after a barrier): the
    reference a model whose gradients do not fit one card beside its
    weights is held to."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.train.train_loop import to_device
    loss = None
    if dist.get_rank() == 0:
        model = build_model(cfg, device=dev, seed=seed)
        with torch.no_grad(), \
                msettings.use(vocab_chunk=TRAIN_VOCAB_CHUNK):
            loss = float(model.loss(to_device(stream.batch_at(0),
                                              model.device))[0])
        del model
        free_card(torch, dev)
    dist.barrier()
    return loss


def mesh_compression(torch, seed, dev, world, cfg, B, T):
    """The int8 all-reduce (``compressed_psum``) over all ranks: ROADMAP
    §C entry 11's shards spread over the ranks and a random tensor, each
    element within ``n * scale / 2`` of the exact sum; then one
    qwen3-1.7b step on the (cards, 1) mesh with
    ``make_compressed_allreduce`` on the data axis, every gradient leaf
    within that bound, and the gradient dtype's rounding of the result,
    of its float32 sum, and a finite loss."""
    import torch.distributed as dist
    from repro_torch.sharding import ctx
    from repro_torch.train.compression import (compressed_psum,
                                               make_compressed_allreduce)
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              trainable_params)
    rank = dist.get_rank()
    shards = [[1.0, -0.5, 0.25, 0.1], [0.01, 0.02, -0.01, 0.005]]
    gen = torch.Generator(device=dev).manual_seed(seed + rank)
    worst = 0.0
    for x in (torch.tensor(shards[rank % 2], device=dev),
              torch.randn(4096, generator=gen, device=dev) * (rank + 1)):
        exact = x.clone()
        dist.all_reduce(exact)
        amax = x.abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
        err = float((compressed_psum(x) - exact).abs().max())
        bound = float(world * amax / 127 / 2)
        check(err <= bound * (1 + 1e-5), f"compressed_psum over {world} "
              f"ranks: {err} from the exact sum, bound {bound}")
        worst = max(worst, err / bound)
    mesh, rules, model = mesh_model(torch, cfg, (world, 1), seed, dev)
    reduce = make_compressed_allreduce(mesh)
    data = mesh.get_group("data")
    leaf_worst, n_leaves = [0.0], [0]

    def compress(grads):
        # each leaf against its float32 sum over the data axis: within
        # n scale / 2 (the int8 sum) and the result's rounding to the
        # gradient's dtype (bf16: half a unit in the 8th bit)
        got = reduce(grads)
        for k, g in grads.items():
            if not g.placements[0].is_partial():
                continue
            local = g.to_local().float()
            exact = local.clone()
            dist.all_reduce(exact, group=data)
            amax = local.abs().max()
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=data)
            c = got[k].to_local().float()
            ulp = 2.0 ** -8 if g.dtype == torch.bfloat16 else 2.0 ** -24
            bound = world * amax / 127 / 2 + c.abs() * ulp
            ratio = float(((c - exact).abs() / bound).max())
            check(ratio <= 1 + 1e-5, f"compressed step: {k} {ratio:.6f} of "
                  f"its bound from the float32 sum")
            leaf_worst[0] = max(leaf_worst[0], ratio)
            n_leaves[0] += 1
        return got
    params = trainable_params(model)
    step_fn, opt = make_train_step(model, TrainConfig(), compress_fn=compress)
    batch = train_stream(cfg, B, T, seed).batch_at(0)
    with ctx.use(rules, mesh):
        _, _, m = step_fn(params, opt.init(params), batch)
    loss = float(m["loss"])
    check(math.isfinite(loss) and n_leaves[0] > 0, f"compressed step: loss "
          f"{loss}, {n_leaves[0]} leaves compressed")
    log(f"[mesh] compressed_psum over {world} ranks: worst error "
        f"{worst:.3f} of n scale / 2; a {cfg.name} step on {world} x 1 "
        f"with the int8 all-reduce: loss {loss:.6f}, {n_leaves[0]} "
        f"gradient leaves each within {leaf_worst[0]:.3f} of its bound")
    del model, params, step_fn, opt
    free_card(torch, dev)
    return {"psum_worst": worst, "step_worst": leaf_worst[0], "loss": loss}


def mesh_elastic(torch, seed, dev, world, cfg, B, T):
    """Saved on the first of :func:`mesh_shapes` after step 2 (every rank
    gathers, rank 0 writes), steps 3 and 4 there (the uninterrupted run)
    and, restored (``Checkpointer.restore_into``) into a model drawn from
    another seed, on the last mesh: each loss and weight leaf within
    ``ELASTIC_RTOL``."""
    import shutil
    import torch.distributed as dist
    from repro_torch.sharding import ctx
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              train_loop, trainable_params)
    rank = dist.get_rank()
    stream = train_stream(cfg, B, T, seed)
    ckdir = ROOT / "build" / "mesh_ckpt"
    if rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
    dist.barrier()
    ck = Checkpointer(str(ckdir), keep=1)
    first, last = mesh_shapes(world)[0], mesh_shapes(world)[-1]
    runs = {}
    for dims, start, s in ((first, 0, seed), (last, 2, seed + 1)):
        mesh, rules, model = mesh_model(torch, cfg, dims, s, dev)
        params = trainable_params(model)
        step_fn, opt = make_train_step(model, TrainConfig())
        state = opt.init(params)
        if start:
            check(ck.restore_into(params, state) == start,
                  "the mesh checkpoint restored another step")
        losses = []
        # the first mesh saves after step 2 and goes on; the last resumes
        legs = ((0, 2, ck), (2, 4, None)) if not start else ((2, 4, None),)
        with ctx.use(rules, mesh):
            for lo, hi, saver in legs:
                batches = mesh_batches(torch, stream, rules, mesh, lo, dev)
                try:
                    params, state, hist = train_loop(
                        model, TrainConfig(), params, state, batches,
                        steps=hi, start_step=lo, log_every=0,
                        train_step=step_fn, checkpointer=saver,
                        checkpoint_every=hi)
                finally:
                    batches.close()
                losses += hist["loss"]
        ck.wait()
        runs[dims] = (losses[-2:], {k: whole(p) for k, p in params.items()})
        del model, params, state, step_fn, opt
        free_card(torch, dev)
    (want, w_want), (got, w_got) = runs[first], runs[last]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    rel_w = max(leaf_gap(w_got[k], w_want[k]) for k in w_want)
    check(rel_loss <= ELASTIC_RTOL and rel_w <= ELASTIC_RTOL,
          f"restored on {last} after a save on {first}: losses {got} "
          f"against {want} (relative {rel_loss:.3g}), weights within "
          f"{rel_w:.3g}")
    log(f"[mesh] elastic restore ({cfg.name}, {cfg.num_layers} layers, "
        f"float32): saved on {first[0]} x {first[1]} after step 2, steps 3 "
        f"and 4 restored on {last[0]} x {last[1]}: losses {got} against "
        f"{want} (relative {rel_loss:.3g}, bitwise {got == want}); weights "
        f"within relative L2 {rel_w:.3g}")
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"losses": got, "want": want, "rel_loss": rel_loss,
            "rel_weights": rel_w}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 9c's cards' leg (phase_train_cards starts them)
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-cpu", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-reduced", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-parts", default=",".join(MESH_PARTS),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_rank_main(args)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import rank_delta as rd
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = gpu_name_and_limit()
    log(f"[env] {card}")
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        log(f"[{phase}] done at {time.perf_counter() - t_start:.1f} s")

    phase_build(torch)
    done("build")
    errs, main_shape, big_shape = phase_parity(torch, np, args.seed)
    # the fleet heads tick's k-head: every member row of 64 x 100k x 16;
    # the fold at 16 members on both fleet shapes
    heads_times = time_kernels(torch, big_shape)
    fleet_times = time_kernels(torch, main_shape)
    scatter_rng = np.random.default_rng(args.seed + 3)
    scatter_times, pageable_times = {}, {}
    for C in (10_000, 100_000):
        scatter_times[C], pageable_times[C] = time_scatter(torch, np,
                                                           scatter_rng, C)
    done("parity")
    phase_fleet(torch, np, args.seed, 64, 10_000, 16, 100, 10,
                "64x10000x16", card)
    rd.reset_launches()
    phase_fleet(torch, np, args.seed + 1, 64, 100_000, 16, 10, 10,
                "64x100000x16", card)
    fleet_heads_launches = rd.LAUNCHES["select"]
    done("fleet")
    phase_sharded(torch, np, rd, args.seed, card)
    sharded_launches = phase_sharded_service(torch, np, rd, args.seed, errs)
    done("sharded")
    from repro_torch.selector import fused_rank
    rd.reset_launches()
    fused_rank.reset_graphs()
    service, store, table = phase_service(np, args.seed)
    launches = dict(rd.LAUNCHES)
    graphs = dict(fused_rank.GRAPHS)
    done("service")
    # the daemon's ticks replay the fleet's tick graph (its first runs
    # eagerly, and each capture serves every tick in its direction after)
    log(f"[service] tick graphs: {graphs} for "
        f"{service.reprice_dispatches} fleet ticks")
    check(graphs["replays"] > 0 and graphs["captures"] > 0,
          f"main path: no tick was served by a graph ({graphs})")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on "
              f"the main path")
    for name in set(KERNELS) - set(PATH_KERNELS):
        check(launches[name] == 0, f"kernel {name} was launched "
              f"{launches[name]} times on the main path")
    check(launches["scatter"] == launches["rowmin"] == launches["fold"]
          == service.reprice_dispatches, f"main path: {launches} for "
          f"{service.reprice_dispatches} fleet ticks")
    times, row = phase_main_path_kernels(torch, np, args.seed,
                                         service._batched, errs)
    head_times = time_heads(torch, row, (big_shape["scores"],
                                         big_shape["finite"]))
    # select_sort's record: its first k, on the service's member row;
    # scatter's: the service's C and a 1% tick
    times["select_sort"] = head_times[(1, 10_000, rd.SELECT_CAP + 1)]
    times["scatter"] = scatter_times[10_000]
    times["scatter_pageable"] = pageable_times[10_000]
    phase_guard(torch, rd, row)
    done("main-path kernels")
    frontend = phase_frontend(torch, np, args.seed, service, store, card,
                              errs)
    done("frontend")
    turbulence = phase_turbulence(torch, np, rd, args.seed, errs)
    done("turbulence")
    phase_lm_parity(torch)
    done("lm-parity")
    report_path, report, card_cell = phase_dryrun()
    done("dryrun")
    placement = phase_placement(report)
    phase_launcher(report_path)
    done("placement")
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    lm_errs = {name: 0.0 for name in LM_KERNELS}
    lm_runs = {}
    for arch, name in SERVED:
        cfg = configs.get(arch)
        op = LM_KERNELS[name]["op"]
        run = phase_serve(torch, np, cfg, args.seed, card, placement)
        check(run["kernel"] == op, f"{cfg.name} ran {run['kernel']}")
        check(fa.LAUNCHES["flash_attention_bwd"] == 0,
              f"serving {cfg.name} launched the backward kernel")
        # the fp32 check's split launches: the split entries' launches
        if cfg.window:
            n_split = phase_parity_4_layers(torch, cfg, args.seed,
                                            prompt=WINDOW_PARITY_PROMPT,
                                            steps=WINDOW_PARITY_STEPS)
        elif cfg.is_encdec:
            n_split = phase_parity_4_layers(torch, cfg, args.seed,
                                            steps=ENCDEC_PARITY_STEPS,
                                            frames=ENCDEC_PARITY_FRAMES)
        elif cfg.frontend == "vision":
            n_split = phase_parity_4_layers(torch, cfg, args.seed,
                                            frames=VLM_PARITY_PATCHES)
        else:
            n_split = phase_parity_4_layers(torch, cfg, args.seed)
        run["fp32_launches"] = n_split
        if run["modes"] is not None:
            lm_runs.update(time_encdec_kernels(torch, cfg, run, lm_errs,
                                               args.seed))
            done(f"serve {cfg.name}")
            continue
        r = time_lm_kernel(torch, op, run["shapes"], lm_errs, args.seed,
                           name=name, fp32_entries=FP32_ENTRIES.get(name))
        run["times"] = r
        if run["waves"] is not None:
            # the kernel's share of a prefill wave, with each kernel
            w = run["waves"]
            r.update(wave_ms=w["tc"] * 1e3, wave_earlier_ms=w["scalar"] * 1e3)
            log(f"[serve] {cfg.name}: attention {run['layers']} x "
                f"{r['ms']:.4f} ms = {run['layers'] * r['ms'] / r['wave_ms']:.1%} "
                f"of a {r['wave_ms']:.3f} ms prefill wave (scalar kernel: "
                f"{run['layers']} x {r['earlier_ms']:.4f} ms = "
                f"{run['layers'] * r['earlier_ms'] / r['wave_earlier_ms']:.1%}"
                f" of {r['wave_earlier_ms']:.3f} ms)")
        lm_runs[name] = run
        done(f"serve {cfg.name}")
    run = phase_llama4(torch, np, args.seed, card)
    run["times"] = time_lm_kernel(torch, "flash_attention", run["shapes"],
                                  lm_errs, args.seed,
                                  name="flash_attention_llama4")
    lm_runs["flash_attention_llama4"] = run
    done("llama4")
    # serving runs under inference_mode: no backward launch anywhere yet
    from repro_torch.kernels import ops
    check(all(ops.launches()[name] == 0 for name in NO_BWD),
          "the serving phases launched a backward kernel")
    train = phase_train(torch, np, args.seed, card)
    done("train")
    mesh = phase_train_mesh(torch, args.seed, card, train.pop("mesh_ref"))
    done("mesh")
    if torch.cuda.device_count() >= 2:
        phase_train_cards(torch, args.seed, card)
        done("mesh cards")
    phase_head(torch, args.seed, card)
    done("head")
    check_card_cell(card_cell, train, card)
    # the profiled phases come last: a profiler session may slow the
    # host's launches for the rest of the process (phase_lm_profile reads
    # whether it did), and the serving phases time those launches
    phase_busy(torch, args.seed, service, store, table)
    done("busy")
    del service, store, table
    for arch, _ in SERVED:
        phase_lm_profile(torch, np, configs.get(arch), args.seed)
    phase_train_profile(torch, np, args.seed)
    phase_train_profile(torch, np, args.seed, cfg=configs.get(RWKV_ARCH))
    for arch, (layers, T, frames, _) in CUT_TRAIN.items():
        train["cut"][arch]["profile"] = phase_train_profile(
            torch, np, args.seed, cfg=dataclasses.replace(
                configs.get(arch), num_layers=layers), T=T, frames=frames)
    bwd_device_times(torch, args.seed, train["times"])
    backends = sdpa_fp32_backends(torch, args.seed, {
        split: lm_runs[name]["shapes"]
        for name, (split, _) in FP32_ENTRIES.items()})
    for name, (split, _) in FP32_ENTRIES.items():
        for kind in ("split", "scalar"):
            lm_runs[name]["times"][kind]["library_backend"] = backends[split]
    for entry in FP32_BWD_TIMED:
        for name in (entry, scalar_entry(entry)):
            train["fp32_times"][name]["library_backend"] = backends[entry]
    done("profile")

    def entry(name, source, replaces, n_launches, err, r):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n_launches,
             "max_abs_err": err, "ms": r["ms"],
             "earlier_ms": r.get("earlier_ms"), "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
             "library_ms": r["library_ms"]}
        for key in ("device_ms", "earlier_device_ms", "library_device_ms",
                    "device_pass_ms", "kernel", "library_backend"):
            if key in r:
                e[key] = r[key]
        if "ffma_bound" in r:
            # fp32: the bound is six bf16 products a product; the scalar
            # FFMAs' beside it, and the distance from a float64 run
            e.update(ffma_bound_ms=r["ffma_bound"][0],
                     rel_l2_float64=r["dist64"],
                     plain_rel_l2_float64=r["plain_dist64"])
        if "wave_ms" in r:
            e.update(wave_ms=r["wave_ms"], wave_earlier_ms=r["wave_earlier_ms"])
        return e

    kernels = []
    for name in KERNELS:
        kernels.append(entry(f"rank_delta_{name}", SOURCE, REPLACES[name],
                             launches[name], errs[name], times[name]))
        if name in ALSO_REPLACES:
            kernels[-1]["also_replaces"] = ALSO_REPLACES[name]
        # the 4-worker front-end's run, the turbulence sweep's and the
        # sharded service's (2 shards)
        if name in ("scatter", "rowmin", "fold", "select"):
            kernels[-1]["frontend_launches"] = \
                frontend["launches"][name]
            kernels[-1]["turbulence_launches"] = turbulence[name]
            kernels[-1]["sharded_launches"] = sharded_launches[name]
    # the same select kernel at the fleet heads tick's shape (B2)
    kernels.append(entry("rank_delta_select_heads_64x100000x16", SOURCE,
                         ALSO_REPLACES["select"], launches["select"],
                         errs["select"], heads_times["select"]))
    kernels[-1]["fleet_launches"] = fleet_heads_launches
    # the same select at the front-end snapshot build's member rows (B2's
    # serving path): one launch a published snapshot
    R, C = frontend["shape"]
    kernels.append(entry(f"rank_delta_select_snapshot_{R}x{C}", SOURCE,
                         ALSO_REPLACES["select"],
                         frontend["launches"]["select"], errs["select"],
                         frontend["head"]))
    kernels[-1]["frontend_launches"] = frontend["launches"]["select"]
    kernels.append(entry("rank_delta_scatter_100000", SOURCE,
                         REPLACES["scatter"], launches["scatter"],
                         errs["scatter"], scatter_times[100_000]))
    # rowmin and the fold at 16 members on the two fleet shapes
    # (rowmin_row and fold_col: earlier_ms)
    for shape, r in (("64x10000", fleet_times["rowmin"]),
                     ("64x100000", heads_times["rowmin"])):
        kernels.append(entry(f"rank_delta_rowmin_{shape}", SOURCE,
                             REPLACES["rowmin"], launches["rowmin"],
                             errs["rowmin"], r))
    for shape, r in (("64x10000x16", fleet_times["fold"]),
                     ("64x100000x16", heads_times["fold"])):
        kernels.append(entry(f"rank_delta_fold_{shape}", SOURCE,
                             REPLACES["fold"], launches["fold"],
                             errs["fold"], r))
    # the k-head at each timed (rows, columns, k), by the kernel k takes
    for (R, C, k), r in head_times.items():
        kernels.append(entry(f"rank_delta_khead_{R}x{C}_k{k}", SOURCE,
                             REPLACES[r["kernel"]], launches[r["kernel"]],
                             errs[r["kernel"]], r))
    # each entry's launches: its own path's (the llama4 check's one
    # prefill for its entry); the scalar kernel's on the path of the
    # entry it was timed beside
    runs = {name: (run["entry_launches"] if "entry_launches" in run
                   else run["launches"]["flash_attention_tc" if
                                        run["kernel"] == "flash_attention"
                                        else "wkv6"], run["times"])
            for name, run in lm_runs.items()}
    # the split kernel's: its model's fp32 4-layer check's; the scalar
    # one's (the yardstick) the serving path's, none
    for name, (split_name, scalar_name) in FP32_ENTRIES.items():
        run = lm_runs[name]
        runs[split_name] = (run["fp32_launches"], run["times"]["split"])
        runs[scalar_name] = (run["launches"]["flash_attention_scalar"],
                             run["times"]["scalar"])
    # WKV6's backward: its launches rwkv6-3b's training steps'
    wkv = train["wkv6"]
    runs["wkv6_bwd"] = (wkv["launches"], wkv["times"])
    lm_errs["wkv6_bwd"] = wkv["err"]
    for name, spec in LM_KERNELS.items():
        n_launches, r = runs[name]
        kernels.append(entry(name, spec["source"], spec["replaces"],
                             n_launches, lm_errs[name], r))
        if name == "flash_attention_llama4":
            # the backward: the tensor-core kernel at each timed shape,
            # its launches that shape's on the training path (seamless's
            # one step: a call a layer; the cut models' steps); the scalar
            # yardstick's the fp32 gradient check's
            cut_of = {e: arch for arch, e in CUT_ENTRY.items()}
            for bwd_name, r in train["times"].items():
                if bwd_name == "flash_attention_bwd_scalar":
                    n_launches, err = train["scalar_launches"], \
                        train["scalar_err"]
                elif bwd_name == "flash_attention_bwd":
                    n_launches, err = train["launches"], train["err"]
                elif bwd_name in cut_of:
                    n_launches = train["cut"][cut_of[bwd_name]]["launches"]
                    err = train["err"]
                elif bwd_name == MOE_ENTRY:
                    n_launches, err = train["moe"]["launches"], train["err"]
                else:
                    _, Tq, Tk, _, _, _, causal, _ = r["shape"]
                    n_launches = train["encdec_launches"].get(
                        ("bwd_tc", Tq, Tk, causal), 0)
                    err = train["err"]
                kernels.append(entry(
                    bwd_name, "src/repro_torch/csrc/flash_attention_bwd.cu",
                    TRAIN_REPLACES, n_launches, err, r))
                if bwd_name == "flash_attention_bwd":
                    kernels[-1].update(step_ms=train["step_ms"],
                                       step_share=train["share"])
                if bwd_name == MOE_ENTRY:
                    kernels[-1].update(step_ms=train["moe"]["step_ms"],
                                       step_share=train["moe"]["share"])
                if bwd_name in cut_of:
                    cut_run = train["cut"][cut_of[bwd_name]]
                    kernels[-1].update(
                        step_ms=cut_run["step_ms"],
                        step_share=cut_run["share"],
                        step_busy=cut_run["profile"]["busy"],
                        step_backward_share=cut_run["profile"][
                            "backward kernel"])
            # the fp32 backward at its own use, qwen3-1.7b's,
            # pixtral-12b's and recurrentgemma-9b's shapes: the split
            # kernel's launches the fp32 gradient checks' (qwen3-1.7b's,
            # the cut models'), the scalar one's (by name, the yardstick)
            # none on the path
            fp32_cut_of = {e: arch for arch, e in CUT_ENTRY_FP32.items()}
            for bwd_name, r in train["fp32_times"].items():
                kind = "split" if "_split_" in bwd_name else "scalar"
                n_launches = train[f"{kind}_launches"]
                if bwd_name in fp32_cut_of:
                    n_launches = train["cut"][fp32_cut_of[bwd_name]][
                        "split_launches"]
                kernels.append(entry(
                    bwd_name, "src/repro_torch/csrc/flash_attention_bwd.cu",
                    TRAIN_REPLACES, n_launches, train[f"{kind}_err"], r))
        if name == "wkv6_bwd":
            kernels[-1].update(
                kernel="wkv6_bwd_cluster", forward_ckpt_ms=r["forward_ckpt_ms"],
                forward_ms=r["forward_ms"], step_ms=wkv["step_ms"],
                step_share=wkv["share"], blocks_per_sm=r["blocks_per_sm"],
                clusters=r["clusters"], waves=r["waves"],
                registers=r["registers"])
            # the yardstick, timed beside it: no launch on the path
            y = r["block"]
            kernels.append(entry("wkv6_bwd_block", spec["source"],
                                 spec["replaces"], 0, wkv["block_err"], y))
            kernels[-1].update(blocks_per_sm=y["blocks_per_sm"],
                               waves=y["waves"], registers=y["registers"])
        if "decode_ms" in r:
            kernels[-1].update(
                decode_ms=r["decode_ms"],
                decode_graph_ms=r["decode_graph_ms"],
                decode_earlier_ms=r["decode_earlier_ms"],
                decode_earlier_graph_ms=r["decode_earlier_graph_ms"],
                decode_bound_ms=r["decode_bound"][0])
    # qwen3-moe-30b-a3b's training forward: the same kernel and shape as
    # its serving entry's, launched by phase 9b's MoE steps
    for e in kernels:
        if e["name"] == "flash_attention_d64":
            e["train_launches"] = train["moe"]["fwd_launches"]
    # phase 9c's launches: the 1 x 1 mesh's steps
    for e in kernels:
        if e["name"] == "flash_attention":
            e["mesh_launches"] = mesh["launches"]
        elif e["name"] == "flash_attention_bwd":
            e["mesh_launches"] = mesh["bwd_launches"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
