#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: a CUDA card must be present; prints its name and power limit;
1b. `[lint]` the port's cascade-lint (`python -m repro_torch.analysis`,
   stdlib `ast` only, CL001-CL011) over src/repro_torch, the port's tests
   and this script, in-process: files scanned, findings and ms; any
   finding fails the run;
1c. `[costs]` the dry-run cost report (`repro_torch.launch.dryrun`) on
   the host: every (arch x shape) step of `configs/shapes.py` at
   `--variant auto` traced on `meta` tensors (no allocation) but the
   recurrent archs' chunked train and prefill (minutes of host time;
   `python -m repro_torch.launch.dryrun --all` has them): one line per
   combo with its FLOPs, bytes accessed, bound at one H100's peaks (989
   TFLOP/s bf16, 3.35 TB/s) and what bounds it, argument and peak temp
   GB, whether it fits one card; any failed combo fails the run. The LM
   phases below take their decode steps' bounds from the same report;
2. build: compiles the CUDA kernels from `src/repro_torch/csrc` (nvcc,
   sm_90a, one process per source) and loads them;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card. K1/K2 at every shape the serving session warms and at edge shapes
   (ties, fully masked groups, m_q > G, d in {5, 13, 27, 50} — d % 4 != 0,
   the kernels' scalar layouts, and at d = 50 K2's column chunks — and x
   contiguous at a 4-byte storage offset); continuous outputs at rtol/atol
   1e-5, discrete outputs exactly, after checking that the inputs leave
   every discrete decision a margin (kernels/cascade_filter/ref.py); K1
   alone also at 4096 x 256, on one group of 1,048,576 items and at odd G
   (its blocks walk many tiles, its tiles span many groups), and K1 at
   T = 3, K3 and K4 at T = 3 and 8, and K5 at T = 8 at the widest d their
   previous designs took and at their own widest d (all three at d = 384,
   T = 8 too), each wrapper refusing one d past its widest. K3/K4/K5
   over G in {1, 7, 130}, d in {8, 24, 5, 13, 27}, T in {1, 3, 8} with a
   fully masked group, at the training shape (64 groups of 64, d=24, T=3),
   on it with xc, K3's x and its cotangent g at a 4-byte storage offset,
   at 5000 groups of 7 (the blocks walk several groups; K3's g chunks
   mostly not 16-byte aligned), at 2000 groups of 7 with offset inputs,
   and at an exact tie of lp_T with the NLL clamp; forward values at
   rtol 2e-5 / atol 1e-5 (K4's plain NLL is taken in probability space,
   the kernel's in log space), backward outputs at rtol 1e-4 / atol 5e-5
   (sums over up to 130 items in another order). K6 (the single-group
   scorer, forward and backward) and K7 (the feature-major scorer) over
   N in {1, 7, 128, 129, 512, 1000, 2048, 262144} x (d, T) in {(24, 3),
   (8, 1), (128, 8), (40, 5)}, float32 and bfloat16 inputs, each with its
   last N // 4 rows zero (held to cumsum log sigmoid(zq)): forward at
   rtol/atol 1e-5 (bfloat16 too: kernel and plain version up-cast the same
   values), K6's backward at rtol 1e-4 / atol 5e-5 (dw and dzq, sums over
   all N items, with 2^-24 sum_i |term_i| more), K7 against K6. K6 and
   its backward on B groups in one launch (the launch a vmapped call
   makes) at the same bars, float32 and bfloat16, over (B, N) in {(64,
   64), (5000, 7), (3, 262144), (1, 1048576)} and (2, 100) at d = 400,
   with zq per group and shared, d in {5, 13, 27} and x at a 4-byte
   storage offset, each launched twice for the same bits. Every kernel
   launched twice on the same inputs gives the same bits (K6 and K7 on the
   timing shape's 1,048,576 items as one group);
3b. query_bias (the serving cascade's zq = q @ w_q.T + b, each row summed
   in a fixed order; a port-only kernel) against its plain version at 1-32
   and 4096 rows: bit for bit on the card, and against the plain version on
   the CPU bit for bit or else within 1e-6 (printed which); the rows of one
   launch equal the same rows launched in slices of every warmed b; timed
   at 32 and 4096 rows beside its plain version, its bound and the
   library's addmm;
4. timing: each kernel and its plain version at B=4096 groups of G=256
   items (d=24, T=3) and at the training shape: the median over 25 runs
   of 20 calls back to back between CUDA events (device time per call),
   beside a lone call's time (wrapper and launch included) and the least
   time the card could take (bytes at 3.35 TB/s, operations at 67 TFLOP/s
   f32); K1 and K2 also at the serving session's largest bucket batch (32
   groups of 256); K1, K3, K4 and K5 beside their previous design's times
   and their target shares of the bound (60%, 50%, 50%, 40%); each K2 time
   beside the (item, surviving item) pairs its data has per stage (the
   first design's rank compares). K6 and its backward on the B groups of
   both shapes in one launch, beside K1 and K3 there (within 1.25x of
   them). K6, K6's backward and K7 so at N = 64 (the vmap fit's group,
   inputs warm in the L2), 4096, 65536, 262144 and 1,048,576 items (d=24,
   T=3; the reference kernel bench's N and K1's item count), inputs
   rotated through copies past the L2, beside K1 at B=1 on the same items,
   and K6 and its backward at 1,048,576 beside their previous design's
   times and target shares (60%, 50%); and the vmapped op as a caller runs
   it at the training shape, forward and forward + backward;
5. training: `fit_cloes` (L3) and `fit_soft_cascade` (L1) at the serve
   launcher's settings (640 groups of 64, 4 epochs of 10 steps, lr 0.01,
   beta 5) on the card, each path with the launch counts set to 0 before
   and read after: K4 and K5 launched once per L3 step, K1 and K3 once
   per L1 step; two fits on the card byte-equal; the loss trajectory,
   params and `evaluate` metrics against the same fit on the CPU at
   rtol 1e-4 / atol 1e-4; steps/s and epoch time printed, and one more
   L3 fit under torch.profiler (device busy time, launches per step).
   Then L3 fitted through the losses' score_fn seam with torch.func.vmap
   of the single-group op (the reference's `jax.vmap` path): K6 forward
   and backward once per step for lp and once for the penalty variant
   (one launch each for the minibatch's 64 groups), 2 each per step,
   nothing else launched; two card fits byte-equal, and within 1e-4 of
   the same fit on the CPU and of the default K4 + K5 fit on the card;
   steps/s, and profiled as the first (launches per step, device busy);
5b. durable training state and the other training paths, each with the
   launch counts set to 0 before it and read after it: `[train restart]`
   the L3 fit checkpointed for 2 of its 4 epochs, then resumed: params
   and the resumed losses byte-equal to the uninterrupted card fit, K4 =
   K5 = the steps run after the restore; CheckpointStore save and load
   times; the launcher in subprocesses on the card (--crash-after-epoch 2
   exits 9, --resume prints the uninterrupted run's params sha256).
   `[train dp]` the same fit through fit(mesh=) on a one-rank NCCL group,
   byte-equal to the fit without a mesh;
6. serving: the launcher's open-loop DES (`launch.serve`) on the card
   with the cascade trained in phase 5, once per plan ("filter", then
   "score"): 500 requests of 8-63 items at 400 QPS with a 130 ms
   deadline, checked for resolved futures, closed accounting, no faults
   or errors, no shape first seen after warmup, the plan's kernel
   launched once per served chunk, and responses that agree with the
   plain pipeline on the CPU. Then the reference's vmap pipeline built from
   the port's pieces (vmapped single-group op, keep counts, stage chain,
   latency) on a batch of every warm bucket shape against plan "score"
   (K1): one K6 launch per batch, lp within 1e-5 and bit-equal to K1's in
   every batch, survivors exact where the decisions have margin;
   and every query group of the test split scored feature-major (K7)
   against K6;
6b. serving on the wall clock and across replicas, each path with the
   launch counts set to 0 before it and read after it:
   `[pump filter]` the launcher's --pump (a SessionPump over the session,
   500 requests at 400 QPS from 4 submitter threads, 130 ms deadline):
   every future resolved, the accounting identity, no shape after warmup,
   no cycle error or restart, K2 once per pipeline run and at least once
   per executed chunk, the page-locked transfer pool reusing its buffers,
   every served response against the plain pipeline; wall-clock p50 /
   p95 / p99, achieved QPS, cycles, slot joins, host ms per chunk.
   `[router]` --replicas 2 (both on the card, each on its own stream,
   distinct and not the default), on the DES and with one pump per
   replica, each plain and with replica 0 forced dead: every future
   resolved, the fleet identity, drained = adopted, failovers in the kill
   runs, K2 once per pipeline run, responses against the plain pipeline.
   `[router adopt]` a backlog queued on the dead replica, drained by the
   router's tick and served by the survivor: at least one adopted, each
   adopted response bit-equal to the plain DES run's.
   `[replica streams]` at every warmed (b, g) two page-locked batches on
   the two replicas' streams behind one busy-wait (both enqueued before
   it ends), each output equal to its one-stream bits. `[pump faults]`
   --pump --faults 0.2: every future resolved, the identity, every error
   an injected fault and every poisoned request an error. `[shim]`
   CascadeServer on "filter" (K2) and "score" (K1): responses in submit
   order, each equal bit for bit to the session's results on
   RequestBatcher.drain's batch (pageable copies; the shim's own are
   page-locked). `[warm restart]` the launcher with --serve-dir (500
   requests at 400 QPS; drained, persisted), then with --warm-restart:
   the restored params equal, no shape first seen after warmup, every
   future resolved, the identity closed, K2 = chunks executed + the
   manifest's replayed shapes (and query_bias as often), responses
   bit-equal to the first server's wherever both served a request in a
   chunk of the same g, at any b (within 1e-5 across g); zq by query_bias
   and K2's outputs bit-equal for the same rows in chunks of every warmed
   b (`row_bits_by_b`, 0 rows differing, asserted); both warmup times and
   the warm server's latency. Every pipeline run launches query_bias once
   beside the plan's kernel, and each router kill run's responses equal
   the run without the kill bit for bit;
6c. `[witness]` the port's runtime lock-order witness
   (`repro_torch.analysis.witness`) installed around a wall-clock pump
   with --faults 0.2 (200 requests, 4 submitter threads), the router's
   pump-mode kill run at 200 requests (held bit for bit to the
   unwitnessed run) and an adopted backlog of 24, each with its
   unwitnessed phase's checks: the locks wrapped (session, pool, router,
   injector, `_build`'s build and launch), their acquisitions, the
   distinct edges by node name, K2 and query_bias launches under the
   witness (nonzero), and no inversion, unresolved future or open
   identity. The timed 6b phases run unwitnessed;
6d. `[paper]` the paper's evaluation (`repro_torch.paper`): at the
   reference's benchmark scale (1,200 queries x 64 items, seed 42) Table
   3, Table 4 and Figs 3-5 on the card, each suite with the launch counts
   set to 0 before it and read after it (Table 3: K1 = K3 = 4 x the fit's
   steps (+ 10 K1 for `evaluate`), K4 = K5 = 2 x; Table 4 and Fig 4 the
   fits' K4 / K5, K1 and QB; Fig 3 K1; Fig 5 K4 / K5, K2 and QB in its
   sessions), every claim of the reference's asserts held; Table 3 again
   on the CPU, the card's AUC within 1e-4 and cost ratio within 1e-4
   relative of it (the paper's scale, 61,500 x 64 = 1,998,780 instances,
   runs on its own: `python -m repro_torch.paper.table3_offline --scale
   paper`);
7. K8 (`swa_decode`, the LLM engine's one-token decode attention) against
   its plain version on the card: float32 and bfloat16, hd 64 and 128, rep
   1, 2, 4, 7, 12, windows NO_WINDOW / 1024 / 100 and cache_len at 0, at
   block edges and at S - 1 of an S = 1037 cache (float32 at 2e-5;
   bfloat16 elementwise within one unit of the output, 2^-7 |want| +
   1e-5), the ring-buffer mapping against the reference's masked formula
   over ring_slot_positions, float32 at 2e-5 at gemma3-27b's decode shapes
   (global layer B=4, S=4096; local ring S=W=1024, wrapped and not; B=1 at
   128k), at zamba2-1.2b's (B=4, 32 heads of 64, S=547) and at
   seamless-m4t-large-v2's cross attention (B=4, 16 heads of 64, S=4096),
   and two launches giving the same bits; then K8 timed as the
   other kernels at those shapes in bfloat16 (held to the same bar),
   beside its plain version, its bound (in-window K+V bytes at 3.35 TB/s)
   and one PyTorch call computing the same function
   (scaled_dot_product_attention with the window's mask and GQA), with
   its launch plan (splits, blocks, blocks per SM) and the kernel
   launches per call (torch.profiler's count of the runtime's launch
   calls, one; the device's kernels listed beside it); and pairs of K8 calls
   launched back to back on two side streams with no sync between them
   (at 128k with the same and with different inputs, at the ring shape
   and at a shape whose two grids fit on the card together) equal to the
   one-stream results bit for bit. `[k8 partial]` K8's partials mode (the
   softmax state (m, l, acc) of one rank's block of a sequence-cut cache)
   at the global / ring / 128k shapes in float32 and bfloat16, each cache
   cut into 4 blocks one of which holds no valid slot (it launches
   nothing): each block against its plain version, the four combined
   against K8's normalising call at K8's bar; one 32k quarter of the 128k
   shape timed beside its plain version, its bound and whole K8, with one
   CUDA launch per call;
8. the LLM engine: gemma3-27b at full width and depth in bfloat16
   (random weights made on the card), prefill of 4 prompts of 2048
   synthetic tokens (every local ring wraps), 32 greedy decode steps with
   K8 launched once per layer per step, finite logits; prefill time, ms
   per step, tokens/s and peak memory, and a few more steps under
   torch.profiler. Here and in 8b-8d the median step is asserted no faster
   than the cost report's bound for the step (its FLOPs at the bf16 peak,
   its bytes at 3.35 TB/s, at the last step's cache_len), printed with
   the share of the median it is: a faster step means the count is
   wrong. Then, at full width and 6 layers (one local:global period) in
   float32, prefill of 1100 tokens plus one decode step held
   to the model's own forward over the extended sequence (2e-3, the
   reference's bar), a forward that never runs K8;
9. serving with the neural final stage (`launch.serve --neural
   gemma3-27b`: the smoke variant in float32, plan "filter", 500
   requests at 400 QPS): every request served, none shed, no errors, the
   responses against the plain pipeline plus the same scorer on the CPU;
8b. `[moe lm]` dbrx-132b (2 layers, 15.5 GB) and arctic-480b (1 layer,
   28.1 GB) at their published widths in bfloat16, the weights drawn leaf
   by leaf on the card: prefill of 4 prompts of 512 tokens, 32 greedy
   decode steps, K8 launched once per layer per step and nothing else;
   ms per step beside the report's bound and the reference formula's
   floor (which charges only the experts a batch's top-k choices can
   hit; the capacity dispatch reads all of them), CUDA kernel launches
   per step and peak memory beside the card's name and power limit;
8e. `[tp parity]` model parallelism (`models/parallel.py`, the "tp"
   layout: heads, ffn, vocabulary and experts over the ranks) on
   gemma3-smoke and dbrx-smoke in float32 over 2 ranks
   (`launch.mesh.spawn_ranks`; one card: gloo, the ranks sharing it; a
   card a rank: NCCL) against the card's unsharded run of the same
   params: prefill and 8 decode steps fed the unsharded run's greedy
   tokens, logits rtol 1e-5 / atol 2e-4, greedy tokens exact where the
   margin exceeds 4e-4, expert choices exact where the router leaves a
   margin, the ranks' logits bit-equal, K8 = layers x steps on each rank
   (its counts set to 0 in the rank before its run, read after);
   `[tp lm]` gemma3-27b at full width cut to 12 layers in bfloat16 over 4
   ranks (8 q / 4 kv heads, a quarter of d_ff and 65,536 of the
   vocabulary a rank; each rank draws the unsharded run's weights from
   the same seed, keeping only its blocks): prefill of 4 x 2048 tokens
   and 8 decode steps fed the unsharded run's greedy tokens, logits within
   TP_BF16_STD_TOL of the step's logit std of that run's, greedy tokens
   equal where its top-2 margin exceeds that; per rank K8 = 12 x 8, peak
   memory,
   prefill s, median ms a step and the collectives a step; `[tp moe]`
   the same for dbrx-132b at [moe lm]'s 2 layers (4 of 16 experts a
   rank), every layer routed to the unsharded run's experts and the
   ranks' own routing held to it. The transport and the card count are
   printed; on one card the times are four processes sharing it over
   gloo, not a sharded deployment's. The sequence-sharded variants
   (attn_shard "seqkv" / "shmap", the "seq" cache: the KV sequence over
   the ranks, decode through K8's partials mode combined across them):
   `[seq parity]` inside [tp parity]'s spawn, both smoke configs under
   both variants against the card's unsharded run (see SEQ_BF16_UNIT),
   K8 partials = layers x steps a rank and K8 0; `[seq lm]` inside [tp
   lm]'s spawn, on its shards, gemma3-27b under "seqkv" held to [tp lm]'s
   unsharded run at [tp lm]'s bar, per rank the cache's bytes, prefill s,
   median ms a step, the collectives a step by kind and K8 partials =
   12 x 8; `[seq families parity]` inside [tp families parity]'s spawn
   and `[seq families lm]` inside [tp families lm]'s (8g below). Where
   the ranks do not divide the kv heads (each rank holding whole the kv
   heads its query heads read,
   `parallel.kv_heads`), inside [tp lm]'s spawn of 4 ranks: `[tp kvrep
   parity]` starcoder2-smoke and dbrx-smoke (4 query / 2 kv heads: one kv
   head a rank) in float32 against the card's unsharded run at [tp
   parity]'s bars, K8 = layers x steps a rank; `[tp kvrep lm]`
   starcoder2-3b at full width cut to 10 layers in bfloat16 (24 query / 2
   kv heads: 6 / 1 a rank, ranks 0-1 holding kv head 0 and ranks 2-3 kv
   head 1), a prefill of 4 x 2048 tokens and 8 decode steps fed the
   unsharded run's greedy tokens, held to that run at [tp lm]'s bar; per
   rank K8 = 10 x 8, peak memory, the cache's bytes, prefill s, median ms
   a step and the collectives a step by kind;
8f. training over a ("data", "model") mesh (`zoo.train_step` with a
   `parallel.TrainLayout`), one spawn of 2 x 2 ranks after [tp lm]'s:
   `[fsdp parity]` yi-smoke, gemma3-smoke and dbrx-smoke (capacity 1.0:
   drops) in float32 under "fsdp" and "zero3", 3 Adam steps against the
   card's unsharded `train_step` at the CPU tests' bars (losses 1e-5,
   step 1's gathered m 1e-5 of each leaf's largest, the kept choices
   exact where the router leaves a margin, each rank's state bytes its
   layout's); `[fsdp lm]` yi-34b at its published widths cut to 1 layer,
   float32 weights from seed 0, 3 Adam steps (lr 1e-3) of the launcher's
   4 x 64 batch under both layouts (`launch.train.train_lm_rank`), the losses
   within 1e-4 of the launcher's unsharded run on the card (run before
   the spawn), each rank's params + m + v its layout's bytes and its peak
   below half of the unsharded run's; per rank and layout the transport,
   card count, state and peak bytes, seconds a step and the collectives
   a step by kind with their bytes. No kernel of the table is on this
   path: each rank's launch counts over its run are held to 0;
8c. `[ssm lm]` rwkv6-1.6b (24 layers) and zamba2-1.2b (38 layers, 6
   shared-block applications) at their published widths and full depth in
   bfloat16, the weights drawn on the card: prefill of 4 prompts of 512
   tokens through the chunked form and through the scan (seconds each, the
   largest gap between their last logits), 32 greedy decode steps from the
   scan's cache, K8 = 6 x 32 for zamba2 and no kernel at all for rwkv6;
   ms per step beside the report's bound, CUDA kernel launches per step,
   the device's idle share (a profile of 3 more steps) and peak memory,
   beside the card's name and power limit;
8d. `[encdec lm]` seamless-m4t-large-v2 at its published widths and full
   depth (24 encoder + 24 decoder layers) in bfloat16, the weights drawn on
   the card: prefill of 4 prompts of 512 tokens over 4096 frontend frames
   (configs/shapes.py's decode context), 32 greedy decode steps with K8
   launched twice per decoder layer per step (self attention, and cross
   attention over the cached encoder K/V) and nothing else, the logits
   against the model's forward over the same tokens; prefill s, median and
   p90 ms per step beside the report's bound, CUDA kernel launches per
   step, the device's idle share, tokens/s and peak memory;
8g. the ssm, hybrid and encdec families over ranks: `[tp families
   parity]` (after [tp parity]) their smoke configs in float32, perturbed,
   over 2 ranks under "tp" against the card's unsharded run, and in the
   same spawn `[seq families parity]` zamba2-smoke and seamless-smoke
   under "seqkv" and "shmap" with every K/V leaf cut over its slots, at
   [seq parity]'s bars, K8 partials = attention layers x steps a rank and
   K8 0; `[tp families lm]` (after [encdec lm]) rwkv6-1.6b, zamba2-1.2b and
   seamless at full width and depth in bfloat16 over 4 ranks against [ssm
   lm]'s / [encdec lm]'s teacher-fed reruns, and on the same shards
   `[seq families lm]` zamba2-1.2b and seamless under "seqkv" (their K/V
   over 520 positions and 4096 frames cut over the ranks, K8 partials 6 x
   8 and 48 x 8 a rank, K8 0); `[tp families train]` rwkv6-1.6b (2
   layers), zamba2-1.2b (7) and seamless (2 + 2) at full width in float32
   under "tp" over 2 x 2 ranks, 3 Adam steps at lr 1e-3 (the recurrent
   ones in the chunked form), the losses within 1e-4 of the unsharded run
   on the card, equal bits wherever ranks share a leaf's pieces, each
   rank's state its pieces' bytes, the collectives of every step the
   formula's;
8h. `[pod costs]` (after [tp families lm]) the pod dry run
   (`launch/dryrun.py` `rank_class_records`, the counting transport) held
   on the host to the spawns above, in [costs]'s pool: for every rank row
   ([tp lm], [seq lm], [tp moe], [tp kvrep lm], [tp qsplit lm] under "tp"
   and "seqkv", [tp / seq families lm]) each decode step (and the prefill,
   but the recurrent families' scan-form ones) traced on `meta` for
   every class of ranks, and for [shmap train lm] and [fsdp lm] an Adam
   step: every rank's collectives (calls and bytes by kind) and K8
   launches equal its own counts pass by pass, its shard / cache / params
   + m + v bytes equal its own; each row's bound on the shared card (the
   ranks' FLOPs and bytes summed) printed beside its medians, none faster
   than it;
10. `[train lm]` --target lm at starcoder2-3b's published widths cut to
   2 layers (float32 weights, as the launcher draws them), 3 Adam steps on
   the card: finite losses within 1e-4 of the same steps on the CPU, and
   the same steps with the weights in bfloat16 more than 1e-4 from them;
   the card's peak memory beside the report's argument + temp bytes.
   It and the phases after it run last: their CPU work stays out of every
   phase timed on the host's clock;
11. `[moe parity]` dbrx-smoke and arctic-smoke in float32 on the card
   against the CPU: forward logits (2e-4) and aux loss (1e-6), prefill and
   16 greedy decode steps (2e-4), greedy tokens and every layer's expert
   choices exactly wherever the margin allows, K8 = layers x steps;
12. `[moe lm check]` dbrx-132b at full width, 1 layer in float32 (18.0 GB):
   prefill of 4 x 512 tokens ([moe lm]'s capacity) and 8 greedy decode
   steps on the card against the CPU, logits
   within 2e-4, greedy tokens and expert choices exact where the margin
   allows;
13. `[ssm parity]` rwkv6-smoke, zamba2-smoke and zamba2-smoke at 3 layers
   (a tail layer after the last shared block) in float32, every leaf the
   templates initialise to zeros or ones perturbed, on the card against
   the CPU: forward logits in both ssm_impl forms, prefill and 16 greedy
   decode steps fed the CPU's tokens (2e-4), greedy tokens exact wherever
   the margin allows, K8 = shared-block applications x steps (none for
   rwkv6) and no other kernel;
14. `[ssm lm check]` both configs at full width, rwkv6 cut to 2 layers and
   zamba2 to 7 (one group of 6 and a tail layer), in float32, perturbed:
   prefill of 2 x 128 tokens and 8 greedy decode steps, and the chunked
   form's prefill, on the card against the CPU within 2e-4;
15. `[ssm train]` --target lm at those cuts, 3 Adam steps on 2 x 32
   tokens at lr 1e-4, the card's losses within 1e-4 of the CPU's;
16. `[encdec parity]` seamless-smoke in float32, its norms perturbed, on
   the card against the CPU: forward, prefill of 2 x 24 tokens over 16
   frames and 16 greedy decode steps fed the CPU's tokens, and
   `build_neural`'s scorer on 37 items, all within 1e-5, greedy tokens
   exact where the margin allows; K8 = 2 x layers x steps and no other
   kernel, none for the scorer;
17. `[encdec lm check]` seamless at full width cut to 2 + 2 layers in
   float32, perturbed: prefill of 2 x 128 tokens over 256 frames and 8
   greedy decode steps, held to the model's own forward on the card
   (2e-3) and to the CPU (2e-4);
18. `[encdec train]` --target lm on seamless-smoke, 3 Adam steps at lr
   1e-4 within 1e-4 of the CPU; then at full depth on the card alone (3
   steps of 2 x 64 tokens + 16 frames, float32 weights): finite losses, s
   per step, peak memory beside the report's argument + temp bytes;
19. one JSON line with each kernel's launches on its path (K2, K4 and
   K5 also on the restart, data-parallel and warm-restart paths; K1-K5
   and QB also on `[paper]`'s suites; K8 also on the moe, ssm, encdec
   and model-parallel paths, per rank; query_bias on the serving main path
   and the others; K2 and query_bias also under the witness), error and
   times; the last line is {"ok": true,
   "device": {...}}.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# The port's source tree: this checkout's `src`, or CHIP_SMOKE_SRC (kernel_ab.py
# points it at another tree to run these checks and timings on that tree).
sys.path.insert(0, os.environ.get("CHIP_SMOKE_SRC") or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

from repro_torch import configs as CFG  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import cloes  # noqa: E402
from repro_torch.configs.shapes import DECODE_ENC_LEN, SHAPES  # noqa: E402
from repro_torch.core import baselines as B  # noqa: E402
from repro_torch.core import cascade as C  # noqa: E402
from repro_torch.core import losses as L  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.core import trainer as T  # noqa: E402
from repro_torch.data import LogConfig, generate_log  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.cascade_filter.ref import (  # noqa: E402
    assert_decision_margin)
from repro_torch.kernels.cascade_loss import kernel as loss_kernel  # noqa: E402
from repro_torch.kernels.cascade_score import kernel as score_kernel  # noqa: E402
from repro_torch.kernels.swa_decode import kernel as swa_kernel  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.launch import sharding as SHD  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    data_parallel_mesh, replica_devices, spawn_ranks, train_mesh, transport)
from repro_torch.models import base as MB  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import zoo as Z  # noqa: E402
from repro_torch.models.parallel import (  # noqa: E402
    SEQ_VARIANTS, TrainLayout, combine_partials, kv_heads, q_heads,
    rank_pieces)
from repro_torch.optim import adam  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving.batching import (  # noqa: E402
    PinnedBatch, RequestBatcher, alloc_batch, bucket_of, pack_into)
from repro_torch.serving.cascade_server import (  # noqa: E402
    CascadeServer, NeuralScorer)
from repro_torch.serving.loadgen import (  # noqa: E402
    run_open_loop, run_open_loop_router)
from repro_torch.serving.pump import SessionPump, run_wall_clock  # noqa: E402
from repro_torch.serving.router import make_replicas  # noqa: E402
from repro_torch.serving.session import CascadeSession  # noqa: E402

RTOL = ATOL = 1e-5          # float32 sums taken in another order
FWD_RTOL = 2e-5             # K4's NLL: probability vs log space
BWD_RTOL, BWD_ATOL = 1e-4, 5e-5       # backward sums in another order
# K6's backward sums dw and dzq over all N items of a group (up to 262,144
# here): two float32 sums of the same terms in other orders differ by a
# few roundings of the terms' magnitude, not of the result (which may
# cancel to ~0), so those outputs also get U32 * sum_i |term_i| of slack.
U32 = 2.0 ** -24            # float32 unit roundoff
FIT_RTOL = FIT_ATOL = 1e-4  # the card's fit against the CPU's
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bfloat16 tensor cores, dense
K8_F32_TOL = 2e-5           # the reference's bar (test_kernels)
# bfloat16: the kernel and its plain version both compute in float32 and
# round the output once, so they differ by at most one bfloat16 unit of
# the value (<= 2^-7 |want|) plus float32 noise. Held elementwise, the
# bar scales with the output (~0.005 at 128k) rather than exceeding it.
K8_BF16_RTOL, K8_BF16_ATOL = 2.0 ** -7, 1e-5
# K8 timing shapes (B, H, Hkv, hd, S): gemma3-27b's decode attention at
# the LM phase's batch: a global layer's cache, a local layer's full ring,
# and one sequence at 128k context; and zamba2-1.2b's shared block in
# [ssm lm] (32 heads of 64, no GQA) over its cache of 512 + 32 + 3; and
# seamless-m4t-large-v2's cross attention in [encdec lm] (16 heads of 64,
# no GQA) over its 4096 cached encoder frames; and those two at one of 4
# ranks' heads ([tp families lm]: 8 and 4 heads); and starcoder2-3b's
# decode attention in [tp kvrep lm] over its cache of 2048 + 8 (24 query /
# 2 kv heads of 128: rep 12, two blocks of the group-8 instance) and at one
# of 4 ranks' heads (6 query heads and the one kv head they read: rep 6,
# one block with 2 heads masked).
K8_SHAPES = {"global": (4, 32, 16, 128, 4096), "ring": (4, 32, 16, 128, 1024),
             "long": (1, 32, 16, 128, 131072), "zamba2": (4, 32, 32, 64, 547),
             "encdec_cross": (4, 16, 16, 64, DECODE_ENC_LEN),
             "zamba2_tp4": (4, 8, 8, 64, 547),
             "encdec_cross_tp4": (4, 4, 4, 64, DECODE_ENC_LEN),
             "starcoder2": (4, 24, 2, 128, 2056),
             "starcoder2_tp4": (4, 6, 1, 128, 2056)}
# ... and one whose grid (B=1, 2 kv heads, 32 splits: 64 blocks) leaves room
# for a second call's on the card, for the two-stream check.
K8_PAIR_SHAPE = (1, 4, 2, 128, 2048)
L2_BYTES = 50 * 2**20       # rotate K8's inputs past the L2 between calls
# The LM phase: gemma3-27b at full width and depth in bfloat16.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS, LM_PROFILE_STEPS = (
    "gemma3-27b", 4, 2048, 32, 3)
# ... and at full width, 6 layers in float32, held to its own forward.
LM_CHECK_LAYERS, LM_CHECK_BATCH, LM_CHECK_PROMPT = 6, 2, 1100
LM_PREFILL_TOL, LM_DECODE_TOL = 2e-4, 2e-3   # the reference's bars
NEURAL_ARCH = "gemma3-27b"
# The launcher's --target lm on the card: Adam steps (its default lr 0.01)
# of LM_TRAIN_ARCH at its published widths, cut to LM_TRAIN_LAYERS layers
# so the same steps on the CPU stay affordable, held to them. The launcher
# draws the weights in float32 whatever the config's dtype, as the
# reference's does, so the bar is float32's: Adam carries the gradients'
# float32 differences forward, most once lr 0.01 has doubled the loss by
# the third step. The same steps with the weights in bfloat16 must miss
# the bar, so it is one that bf16 rounding fails. 1 layer (2 until the
# "zero3" phases joined the script, cut for its time limit: the CPU's
# steps took 32 s at 2).
LM_TRAIN_ARCH, LM_TRAIN_LAYERS, LM_TRAIN_STEPS = "starcoder2-3b", 1, 3
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 64      # the launcher's defaults
LM_TRAIN_RTOL = 1e-4
# The moe family. [moe parity]: each smoke config in float32 on the card
# against the CPU (forward, prefill, MOE_PARITY_STEPS greedy decode
# steps). [moe lm]: each config at its published widths cut to
# MOE_LM_LAYERS layers in bfloat16 (dbrx 2: 15.5 GB; arctic 1: 28.1 GB of
# weights), a prompt's prefill then MOE_LM_STEPS greedy decode steps at
# B = 4. [moe lm check]: dbrx at full width, 1 layer in float32 (18.0 GB),
# prefill and decode on the card against the CPU.
MOE_ARCHS = ("dbrx-132b", "arctic-480b")
MOE_PARITY_BATCH, MOE_PARITY_PROMPT, MOE_PARITY_STEPS = 2, 24, 16
MOE_LM_LAYERS = {"dbrx-132b": 2, "arctic-480b": 1}
MOE_LM_BATCH, MOE_LM_PROMPT, MOE_LM_STEPS = 4, 512, 32
MOE_CHECK_ARCH, MOE_CHECK_LAYERS = "dbrx-132b", 1
# [moe lm]'s prefill (4 x 512 tokens, 640 capacity slots per expert) and a
# longer decode, so the large-capacity dispatch is held to the CPU too
MOE_CHECK_BATCH, MOE_CHECK_PROMPT, MOE_CHECK_STEPS = (
    MOE_LM_BATCH, MOE_LM_PROMPT, 8)
MOE_LOGIT_TOL = 2e-4        # the dense LM phases' bar
MOE_AUX_TOL = 1e-6          # a mean of E products of probabilities
# Expert choices are compared exactly where the k-th and (k+1)-th router
# probabilities differ by more than this in log space.
ROUTE_LOG_MARGIN = 1e-3
# Model parallelism ("tp": models/parallel.py). [tp parity]: the smoke
# configs in float32 over TP_PARITY_WORLD ranks against the card's
# unsharded run, at the CPU tests' bars (tests/test_torch_tp.py). [tp lm]
# / [tp moe]: [lm]'s gemma3-27b and [moe lm]'s dbrx-132b over TP_WORLD
# ranks in bfloat16, TP_STEPS decode steps fed [lm]'s / [moe lm]'s greedy
# tokens, held to a teacher-fed rerun of the unsharded run. bfloat16 bar:
# a rank sums bfloat16 partial products where the unsharded matmul rounds
# once, so the runs part by a few bfloat16 units a layer; on the CPU
# (gloo, 4 ranks, a dense config of d_model 1024 and 4-36 layers, and a
# moe one of 2 layers) the largest logit difference was 0.05-0.11 of the
# logits' standard deviation, so the bar is TP_BF16_STD_TOL of it, and
# greedy tokens are compared where the unsharded top-2 margin exceeds it
# (on the H100 the largest difference was 0.117 of the std, 0.47 of the
# bar, for gemma3-27b: a token cannot flip past a margin of 0.94 of the
# bar). [tp moe]'s ranks route every moe layer's tokens to the unsharded
# run's experts, so no token's path parts from the reference's and every
# row is held; their own routing is held to the reference's beside it
# (`check_rank_routes`).
TP_PARITY_ARCHS = ("gemma3-27b", "dbrx-132b")
TP_PARITY_WORLD, TP_PARITY_BATCH, TP_PARITY_PROMPT = 2, 2, 40
TP_PARITY_STEPS = 8
TP_RTOL, TP_ATOL, TP_TOKEN_MARGIN = 1e-5, 2e-4, 4e-4
TP_WORLD, TP_STEPS = 4, 8
TP_MOE_ARCH = "dbrx-132b"
# [tp lm] / [seq lm] run gemma3-27b at its published widths cut to
# TP_LM_LAYERS layers (one group of 5 local and 1 global layer), against
# an unsharded run of the same cut on one card (`tp_lm_reference`): four
# ranks sharing one card pay ~1.3 s (heads) / ~2.7 s ("seq") a step and
# ~30 s a prefill over gloo at full depth (PR 32 F0), which chip_smoke.py's
# time limit no longer holds beside the later phases (one group of 6
# layers leaves room for [tp qsplit lm]'s spawn).
TP_LM_LAYERS = 6
TP_BF16_STD_TOL = 0.25
# Sequence-sharded serving (cfg.attn_shard "seqkv" / "shmap": the "tp"
# parameter layout, the KV sequence over the ranks; decode through K8's
# partials mode, combined across the ranks). [k8 partial]: the partials
# mode at K8_PARTIAL_SHAPES of K8_SHAPES, each cache cut into
# K8_PARTIAL_BLOCKS blocks, one of which holds no valid slot, in float32
# and bfloat16: each block against its plain version (m within 1e-5 (1 +
# |m|), l rescaled to the plain m within K8_F32_TOL relative, acc / l
# within K8_F32_TOL: both compute in float32), the blocks combined against
# K8's normalising call at its bar; one 32k quarter of the 128k shape
# timed against its bound and whole K8. [seq parity]: inside [tp
# parity]'s spawn, the smoke configs in float32 under both variants
# against the card's unsharded run: "seqkv" at TP_RTOL / TP_ATOL; "shmap"
# crosses bfloat16 wires (its attention combine over fresh keys and its
# experts' sum, as the reference's), which move the smoke logits by ~3e-3
# on the CPU (tests/test_torch_seq.py), so it is held to one bfloat16 unit
# of the step's largest logit (SEQ_BF16_UNIT x max |logit|). [seq lm]:
# inside [tp lm]'s spawn, on its shards, gemma3-27b under SEQ_LM_VARIANT
# with the "seq" cache, held to [tp lm]'s unsharded run as [tp lm] is.
SEQ_BF16_UNIT = 2.0 ** -7
SEQ_LM_VARIANT = "seqkv"
K8_PARTIAL_SHAPES = ("global", "ring", "long")
K8_PARTIAL_BLOCKS = 4
# the library yardstick of the partials mode (aten's flash attention with
# its logsumexp) is first held to the kernel: its bfloat16 output within
# K8_LIB_TOL of the largest |acc / l| (it rounds P to bfloat16 before P.V,
# so it sits a unit or two from K8), its logsumexp to m + log l within
# K8_F32_TOL
K8_LIB_TOL = 2.0 ** -5
# The ssm (rwkv6) and hybrid (zamba2) families. [ssm parity]: each smoke
# config (and zamba2-smoke at 3 layers: a tail layer after its last shared
# block) in float32 on the card against the CPU, every leaf the templates
# initialise to zeros or ones perturbed by SSM_NOISE * N(0, 1) (else the
# LoRA paths, the bonus term and the data-dependent shift are zero):
# forward in both ssm_impl forms, then prefill and SSM_PARITY_STEPS greedy
# decode steps. [ssm lm]: both configs at published widths and full depth
# in bfloat16, a prompt's prefill through the scan and the chunked form,
# then SSM_LM_STEPS greedy decode steps. [ssm lm check] / [ssm train]: full
# width at SSM_CHECK_LAYERS (rwkv6 1, 2 until the "zero3" phases joined
# the script, cut for its time limit; zamba2 7: one group of 6 and a tail
# layer; ~1.5 GB in float32) on the card against the CPU.
SSM_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
SSM_PARITY_CASES = (("rwkv6-1.6b", 0), ("zamba2-1.2b", 0), ("zamba2-1.2b", 3))
SSM_PARITY_BATCH, SSM_PARITY_PROMPT, SSM_PARITY_STEPS = 2, 40, 16
SSM_NOISE = 0.1
SSM_LM_BATCH, SSM_LM_PROMPT, SSM_LM_STEPS = 4, 512, 32
SSM_CHECK_LAYERS = {"rwkv6-1.6b": 1, "zamba2-1.2b": 7}
SSM_CHECK_BATCH, SSM_CHECK_PROMPT, SSM_CHECK_STEPS = 2, 128, 8
# [ssm train] runs the launcher at lr 1e-4, not its default 0.01. Adam
# moves a weight by about lr whatever its gradient's size, so where a
# gradient is near zero float32 rounding picks the step's sign, and the
# card's and the CPU's runs part by about lr times the loss's sensitivity
# to such weights. On the H100, rwkv6's third loss differed from the
# CPU's by 1.35e-3 at lr 0.01 (its loss went 11.42 -> 18.16 in three
# steps) and by 8.27e-5 at lr 1e-3, against the bar of 1e-4; the first
# loss agreed to every printed digit at both rates.
SSM_TRAIN_STEPS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_LR = 3, 2, 32, 1e-4
# The encdec family (seamless-m4t-large-v2). [encdec parity]: the smoke
# config in float32, its zero-initialised leaves (the norms) perturbed as
# [ssm parity]'s, on the card against the CPU: forward, prefill of
# ENCDEC_PARITY_BATCH x ENCDEC_PARITY_PROMPT tokens over
# ENCDEC_PARITY_FRAMES frontend frames, ENCDEC_PARITY_STEPS greedy decode
# steps and the neural scorer, all within ENCDEC_PARITY_TOL. [encdec lm]:
# the config at published widths and full depth (24 + 24 layers) in
# bfloat16, B = 4 over DECODE_ENC_LEN frames (configs/shapes.py's decode
# context), a prompt's prefill and ENCDEC_LM_STEPS greedy decode steps.
# [encdec lm check]: full width cut to ENCDEC_CHECK_LAYERS encoder and
# decoder layers in float32 (perturbed) on the card against the CPU.
# [encdec train]: --target lm on the smoke config, card against CPU at
# [ssm train]'s lr and bar, then at full depth on the card alone.
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_PARITY_BATCH, ENCDEC_PARITY_PROMPT = 2, 24
ENCDEC_PARITY_FRAMES, ENCDEC_PARITY_STEPS = 16, 16
ENCDEC_PARITY_TOL = 1e-5
ENCDEC_NEURAL_ITEMS = 37
ENCDEC_LM_BATCH, ENCDEC_LM_PROMPT, ENCDEC_LM_STEPS = 4, 512, 32
# [encdec lm]'s decode against its own forward in bfloat16: the gap as a
# share of the logits' scale. The reference's 2e-3 is below one bfloat16
# unit of logits that reach ~3; [encdec lm check] holds decode to the
# forward at 2e-3 in float32.
ENCDEC_BF16_GAP = 0.1
ENCDEC_CHECK_LAYERS, ENCDEC_CHECK_BATCH, ENCDEC_CHECK_PROMPT = 2, 2, 128
ENCDEC_CHECK_FRAMES, ENCDEC_CHECK_STEPS = 256, 8
ENCDEC_TRAIN_STEPS = 3
ENCDEC_FULL_TRAIN_BATCH, ENCDEC_FULL_TRAIN_SEQ = 2, 64
# The ssm, hybrid and encdec families under "tp" (RWKV-6's and Mamba2's
# heads, zamba2's shared block, seamless's encoder and decoder, the cross
# K/V by head over the ranks). [tp families parity]: the smoke configs in
# float32, perturbed as [ssm parity]'s, over TP_PARITY_WORLD ranks against
# the card's unsharded run of the same params at [tp parity]'s bars:
# TP_FAMILY_CASES, rwkv6 and zamba2 in both ssm_impl forms, seamless at its
# smoke vocabulary and at TP_ODD_VOCAB, which the ranks do not divide (the
# embedding and the head stay whole on every rank). [tp families lm]:
# rwkv6-1.6b, zamba2-1.2b and seamless-m4t-large-v2 at published widths,
# cut to TP_FAMILY_LAYERS (for the time limit, beside [tp qsplit lm]'s
# spawn: zamba2's 13 keep two shared-block applications and a tail
# layer), in bfloat16 over TP_WORLD ranks, [ssm lm]'s / [encdec lm]'s
# batch and prompt (and frames), TP_STEPS decode steps fed the unsharded
# run's greedy tokens, held to the one-card run of the same cut
# (`family_reference`) at [tp lm]'s bar (`check_tp_logits`).
# bfloat16 bar of [tp families lm]: rwkv6-1.6b at random init is
# sensitive enough that two one-card runs of the same function part by
# more than check_tp_logits's bar at full depth ([ssm lm]'s scan and
# chunked prefill by 0.398 with logits up to 4.75, ~1.75 of it, on the
# H100; on the CPU at its full width and 8 / 12 layers 0.50 / 0.65 of it,
# the same model with float32 weights 1.58 / 1.66). So each step's bar is
# also TP_SPREAD_FACTOR x the step's `one_card_spread`, the distance of
# one card's bfloat16 run from the same run in float32: a rank run that
# is as close to the float32 function as one card's is within twice that
# of it (the triangle inequality); check_tp_logits takes the larger bar.
TP_SPREAD_FACTOR = 2.0
TP_ODD_VOCAB = 511
TP_FAMILY_CASES = (("rwkv6-1.6b", "scan", 0), ("rwkv6-1.6b", "chunked", 0),
                   ("zamba2-1.2b", "scan", 0), ("zamba2-1.2b", "chunked", 0),
                   (ENCDEC_ARCH, "scan", 0), (ENCDEC_ARCH, "scan", TP_ODD_VOCAB))
TP_FAMILY_ARCHS = (*SSM_ARCHS, ENCDEC_ARCH)
# rwkv6 and seamless 3 (6 until the "zero3" phases joined the script, cut
# for its time limit); zamba2 13, two applications of its shared block
TP_FAMILY_LAYERS = {"rwkv6-1.6b": 3, "zamba2-1.2b": 13, ENCDEC_ARCH: 3}
# "tp" where the ranks do not divide the kv heads: each rank holds whole
# the kv heads its query heads read (`parallel.kv_heads`), so a kv head
# sits on several ranks. Both phases run inside [tp lm]'s spawn of
# TP_WORLD ranks. [tp kvrep parity]: KVREP_PARITY_ARCHS' smoke configs (4
# query / 2 kv heads: one kv head a rank, ranks 0-1 holding kv head 0 and
# ranks 2-3 kv head 1; dbrx-smoke 1 expert a rank) in float32 against the
# card's unsharded run of the same params at [tp parity]'s bars, K8 =
# layers x steps a rank. [tp kvrep lm]: KVREP_LM_ARCH (24 query / 2 kv
# heads: 6 / 1 a rank) at its published widths and full depth in
# bfloat16, drawn on the card from seed 0 (each rank keeping its pieces),
# a prefill of KVREP_LM_BATCH x KVREP_LM_PROMPT tokens and TP_STEPS decode
# steps fed the unsharded run's greedy tokens, held to that run at [tp
# lm]'s bar (`check_tp_logits`); cut to KVREP_LM_LAYERS of its 30 layers
# for [tp lm]'s reason (3; 5 until the "zero3" phases joined the script).
KVREP_PARITY_ARCHS = ("starcoder2-3b", "dbrx-132b")
KVREP_LM_ARCH, KVREP_LM_BATCH, KVREP_LM_PROMPT = "starcoder2-3b", 4, 2048
KVREP_LM_LAYERS = 3
# Training over a ("data", "model") mesh (`zoo.train_step` with a
# `parallel.TrainLayout`), one spawn of FSDP_MESH's ranks after [tp lm]'s.
# [fsdp parity]: the CPU tests' smoke cases (tests/test_torch_fsdp.py; a
# capacity factor where the experts drop choices) in float32 under each
# of FSDP_MODES against the card's unsharded `train_step` of the same
# params (seed 3) and batches, at the CPU tests' bars: losses
# FSDP_LOSS_TOL every step, step 1's gathered Adam m within FSDP_M_TOL of
# each leaf's largest, the kept choices exact where the router leaves
# every token ROUTE_LOG_MARGIN. [fsdp lm]: FSDP_LM_ARCH at its published
# widths cut to FSDP_LM_LAYERS layers, float32 weights from seed 0,
# LM_TRAIN_STEPS Adam steps of the launcher's batch (`launch.train
# .train_lm_rank`) under each mode, held to the launcher's unsharded run
# on the card at LM_TRAIN_RTOL; each rank's params + m + v its layout's
# bytes, its peak below FSDP_PEAK_SHARE of the unsharded run's; the ranks
# that hold the same pieces of a leaf hold equal bits of it. At lr
# FSDP_LM_LR, not the launcher's 0.01: there the loss nearly doubles by
# the third step, and the rounding of the data split or of the model
# split alone moves it by about the bar (fsdp_controls.py, which also
# plants faults at FSDP_LM_LR to show what these checks catch).
FSDP_MESH = (2, 2)
FSDP_MODES = ("fsdp", "zero3")
FSDP_PARITY_ARCHS = {"yi-34b": None, "gemma3-27b": None, "dbrx-132b": 1.0}
FSDP_PARITY_BATCH, FSDP_PARITY_SEQ, FSDP_PARITY_LR = 4, 16, 1e-3
FSDP_LOSS_TOL, FSDP_M_TOL = 1e-5, 1e-5
# [fsdp lm] keeps 1 of yi-34b's 60 layers (2 until PR 31; cut for [tp
# lm]'s reason: its steps move ~3.6 GB a rank per layer and embedding
# through the host).
FSDP_LM_ARCH, FSDP_LM_LAYERS, FSDP_LM_LR = "yi-34b", 1, 1e-3
FSDP_PEAK_SHARE = 0.5
# The ssm, hybrid and encdec families over ranks, as the reference's pod
# dry run lowers them. [seq families parity]: inside [tp families
# parity]'s spawn, SEQ_FAMILY_ARCHS' smoke configs (scan form, smoke
# vocabulary) under both sequence-sharded variants with the "seq" cache
# (zamba2's attn_k / attn_v, seamless's self and cross K/V cut over their
# slots: M = 48 and 16 frames over 2 ranks) against the card's unsharded
# run, at [seq parity]'s bars. [seq families lm]: inside [tp families
# lm]'s spawn, on its shards, zamba2-1.2b and seamless-m4t-large-v2 under
# SEQ_LM_VARIANT with the "seq" cache (M = 512 + TP_STEPS and 4096 frames,
# both divided by TP_WORLD), held to the same teacher-fed reruns at the
# same bar as [tp families lm]. [tp families train]: one spawn of
# FAMILY_TRAIN_MESH's ranks sharing the card, FAMILY_TRAIN_ARCHS at their
# published widths cut to the layers given (zamba2 7, [ssm lm check]'s:
# its shared block on the path and a state carried over layers; rwkv6 1
# and seamless 1 + 1, for the time limit: with 2 and 2 + 2, as [ssm lm
# check] / [encdec lm check] keep them, all of this script took 1148.9
# s of its 1200 on an H100 host whose CPU ran the unchanged phases 1.6x
# slower than another's), float32 weights from
# seed 0, LM_TRAIN_STEPS Adam steps of the launcher's batch at
# FAMILY_TRAIN_LR under "tp" (rwkv6 and zamba2 in the chunked form, the
# dry run's choice for training; `launch.train.train_lm_rank`), held to
# the unsharded run of the same steps on the card at LM_TRAIN_RTOL, the
# ranks sharing a leaf's pieces holding equal bits of it.
SEQ_FAMILY_ARCHS = ("zamba2-1.2b", ENCDEC_ARCH)
FAMILY_TRAIN_MESH = (2, 2)
FAMILY_TRAIN_ARCHS = {
    "rwkv6-1.6b": ("chunked", 1),
    "zamba2-1.2b": ("chunked", SSM_CHECK_LAYERS["zamba2-1.2b"]),
    ENCDEC_ARCH: (None, 1)}
FAMILY_TRAIN_LR = FSDP_LM_LR
# Query heads the ranks do not divide (`parallel.q_heads`): a rank holds
# its block of wq's H·hd columns (the reference's cut), gathers q whole,
# attends the heads its columns touch and keeps its own columns. [tp
# qsplit parity], inside [tp lm]'s spawn of TP_WORLD ranks:
# QSPLIT_PARITY's smoke configs (yi-smoke with 6 query / 2 kv heads: 1.5
# heads a rank; dbrx-smoke with 14 / 2: 3.5) and, inside [tp parity]'s
# spawn of TP_PARITY_WORLD ranks, QSPLIT_MQA (one kv head, held by every
# rank: the count check_tp refused before the cache's layout was a tag),
# each under "auto", "seqkv" and "shmap" in float32 against the card's
# unsharded run at [tp parity]'s / [seq parity]'s bars, K8 (or its
# partials) = layers x steps a rank. [tp qsplit lm]: one spawn of
# QSPLIT_WORLD ranks sharing the card (gloo), QSPLIT_LM_ARCHS at their
# published widths cut to the layers given, bfloat16, drawn on the card
# from seed 0: a prefill of QSPLIT_LM_BATCH x QSPLIT_LM_PROMPT tokens
# under "shmap" (the pod dry run's prefill variant for them) then TP_STEPS
# decode steps fed the unsharded run's greedy tokens, once into the
# "heads" cache decoding under "auto" (K8 on the touched heads) and once
# into the "seq" cache decoding under "seqkv" (K8's partials), each held
# to the unsharded run at [tp lm]'s bar (`check_tp_logits`).
QSPLIT_PARITY = {"yi6": ("yi-34b", {"n_heads": 6, "head_dim": 64}),
                 "dbrx14": ("dbrx-132b", {"n_heads": 14, "head_dim": 64})}
QSPLIT_MQA = {"yi-mqa": ("yi-34b", {"n_kv_heads": 1})}
QSPLIT_WORLD = 16
# starcoder2-3b kept 4 layers until its "zero3" run joined the spawn,
# whose ranks gather every layer's leaves at every pass through gloo on
# the shared host (3.2 s a decode step at 2 layers on an H100 host); cut
# to 1 for the script's time limit
QSPLIT_LM_ARCHS = {"starcoder2-3b": 1, "yi-34b": 1}
QSPLIT_LM_BATCH, QSPLIT_LM_PROMPT = 4, 512
QSPLIT_PREFILL, QSPLIT_SEQ = "shmap", "seqkv"
# "shmap" training (the reference's shard_map attention and MoE: the max
# carries no gradient, acc crosses in bfloat16 both ways, the experts'
# capacity and aux are each data shard's). [shmap train parity], inside
# [fsdp parity]'s spawn: SHMAP_TRAIN_PARITY's smoke cases under
# SHMAP_TRAIN_MODES (yi3: 1.5 heads a model rank, its one kv head on
# both, the layout the pod dry run gives yi-34b), LM_TRAIN_STEPS Adam
# steps, against the card's one-process run of the same semantics
# (`layers.one_process_mesh(*FSDP_MESH)`: the keys in two blocks, the
# experts over two data shards, each with its capacity and aux), the
# ranks routed to its experts, at bars derived from the bfloat16 wire:
# step 1's loss FSDP_LOSS_TOL (its forward's roundings agree),
# every loss SHMAP_LOSS_BAR and step 1's m SHMAP_M_BAR (one bfloat16
# rounding step) of each leaf's largest; where a rounding to bfloat16
# flips, an element moves by up to 2^-8 of itself, and the reference's
# own step moves past fsdp's 1e-5 when its params move by one ulp
# (tests/test_torch_shmap_train.py holds that spread below these bars).
# [shmap train lm], inside [tp qsplit lm]'s spawn on its 1 x QSPLIT_WORLD
# mesh: SHMAP_LM_ARCH at its published widths cut to SHMAP_LM_LAYERS
# layers, float32, LM_TRAIN_STEPS Adam steps of the launcher's batch at
# FSDP_LM_LR under "tp" + "shmap" (3.5 heads a rank; each kv head on two
# ranks, its gradient summed over them), held to the same steps in one
# process on the card with the same semantics (`layers.one_process_mesh(1,
# QSPLIT_WORLD)`: the keys in QSPLIT_WORLD blocks, their softmax states
# combined as the ranks', the max carrying no gradient, acc in bfloat16;
# the plain step is not that step, since its gradient depends on how the
# keys are cut): step 1's loss at FSDP_LOSS_TOL, every loss within
# SHMAP_LM_BAR; the ranks' shared leaves bit-equal, each rank's params +
# m + v its pieces' bytes. SHMAP_LM_BAR lies between what a sound run and
# a planted fault read (fsdp_controls.py's "shmap" group, on an H100
# 80GB HBM3 at 700 W): the sound run 1.81e-5 off at step 1 and 2.82e-3
# at step 2 (the 16 ranks sum acc in bfloat16 in another order than the
# one process, and Adam's first step takes the sign of the gradients
# such rounding moves), "max carries gradient" 1.24e-2 and "no gather
# sum" 4.09e-2 at step 2; "no kv sum" reads the sound losses and is
# caught by the unequal bits of the kv heads' two holders.
SHMAP_TRAIN_PARITY = {"yi6": ("yi-34b", {"n_heads": 6, "head_dim": 64}),
                      "yi3": ("yi-34b", {"n_heads": 3, "n_kv_heads": 1,
                                         "head_dim": 64}),
                      "dbrx": ("dbrx-132b", {"capacity_factor": 1.0})}
SHMAP_TRAIN_MODES = ("tp", "fsdp")
SHMAP_LOSS_BAR, SHMAP_M_BAR = 1e-3, 2.0 ** -8
SHMAP_LM_ARCH, SHMAP_LM_LAYERS = "yi-34b", 1
SHMAP_LM_BAR = 6e-3
# "zero3" wherever the reference's dry run reaches it: every family's
# serving (`engine.serve_weights`: a rank holds its zero3 shard, gathers a
# sublayer's weights whole where it runs them, narrows them to its "tp"
# pieces and runs the "tp" code into the "tp" cache) and the ssm, hybrid
# and encdec families' training (computed whole on every rank). Inside
# [fsdp lm]'s spawn of FSDP_MESH's ranks: [zero3 families parity]:
# ZERO3_FAMILY_PARITY's smoke configs in float32 (seed 3), LM_TRAIN_STEPS
# Adam steps of FSDP_PARITY_BATCH x FSDP_PARITY_SEQ tokens under "zero3"
# against the card's unsharded train_step at [fsdp parity]'s bars, the
# ranks holding the same pieces of a leaf holding equal bits of it; [zero3
# serve parity]: ZERO3_SERVE_ARCHS' smoke configs in float32 (seed 3),
# each row of data ranks serving its row of the batch, a prefill of
# TP_PARITY_BATCH x TP_PARITY_PROMPT tokens and TP_PARITY_STEPS decode
# steps fed the card's unsharded run's greedy tokens, at [tp parity]'s
# bars, K8 a rank "tp"'s (`k8_decode_calls` a step); [zero3 lm]:
# ZERO3_LM_ARCHS at their published widths cut to the layers given
# (zamba2: its attn_every, the fewest at which its shared block runs),
# float32 weights from seed 0, LM_TRAIN_STEPS Adam steps of the
# launcher's batch at FSDP_LM_LR under "zero3" in the chunked form (the
# dry run's choice for training), held to the unsharded run of the same
# steps on the card at LM_TRAIN_RTOL. Inside [tp qsplit lm]'s spawn of
# QSPLIT_WORLD ranks: ZERO3_QSPLIT_ARCH at its [tp qsplit lm] depth in
# bfloat16 served under "zero3" (its 2 kv heads over 16 ranks: the case
# the repair of `parallel.rank_pieces` fixed), the prefill and TP_STEPS
# decode steps held to the same unsharded run at [tp lm]'s bar.
ZERO3_FAMILY_PARITY = {"rwkv6-scan": ("rwkv6-1.6b", "scan"),
                       "rwkv6-chunked": ("rwkv6-1.6b", "chunked"),
                       "zamba2": ("zamba2-1.2b", "scan"),
                       "seamless": (ENCDEC_ARCH, "scan")}
ZERO3_SERVE_ARCHS = ("yi-34b", "gemma3-27b", "dbrx-132b", "rwkv6-1.6b",
                     "zamba2-1.2b", ENCDEC_ARCH)
ZERO3_LM_ARCHS = {"rwkv6-1.6b": 2, "zamba2-1.2b": 6}
ZERO3_QSPLIT_ARCH = "starcoder2-3b"
# [zero3 families parity]'s bar on step 1's m where float32's own spread
# is wider than FSDP_M_TOL (`data_split_spread`), as [tp families lm]'s
# TP_SPREAD_FACTOR
ZERO3_SPREAD_FACTOR = 2.0
# query_bias: the serving buckets' batch sizes and a large batch; timed at
# the largest bucket and at 4096 rows.
QB_ROWS = (1, 2, 3, 4, 8, 16, 32, 4096)
QB_TIMING_ROWS = (32, 4096)
WARM_B = (1, 2, 4, 8, 16, 32)
WARM_G = (16, 64, 256)
TIMING_SHAPE = (4096, 256, 24, 3)     # B, G, d, T: ~100 MB of x
TRAIN_SHAPE = (64, 64, 24, 3)         # one minibatch of the serve fit
SERVE_SHAPE = (WARM_B[-1], WARM_G[-1], 24, 3)   # the largest bucket batch
# K6 / K7: the parity grid (one group of N items), and the timing sizes at
# d=24, T=3: the group size of the vmap fit (64; its inputs are timed warm
# in the L2, as the fit reads them), the reference kernel bench's N and
# TIMING_SHAPE's item count.
SINGLE_N = (1, 7, 128, 129, 512, 1000, 2048, 262144)
SINGLE_DT = ((24, 3), (8, 1), (128, 8), (40, 5))
VMAP_GROUP_N = 64
SINGLE_TIMING_N = (VMAP_GROUP_N, 4096, 65536, 262144, 1048576)
# K6 on B groups at once, the launch a vmapped call makes: (B, N, d, T, zq
# shared by the groups, x at a 4-byte storage offset), each in float32 and
# bfloat16. The vmap fit's minibatch; 5000 groups of 7 (whole-group pieces,
# many per block); 3 and 1 large groups (128-row pieces, dzq added over a
# group's pieces); d % 4 != 0 (the scalar paths); a d too wide for four
# warps' rings in the backward (one warp a block) and for two of the
# forward's tiles (a one-tile ring).
VMAP_CASES = ((64, 64, 24, 3, False, False), (64, 64, 24, 3, True, False),
              (64, 64, 13, 3, False, True), (5000, 7, 24, 3, False, False),
              (5000, 7, 5, 8, True, False), (5000, 7, 27, 3, False, True),
              (3, 262144, 24, 3, False, False),
              (3, 262144, 27, 5, True, True),
              (1, 1048576, 24, 3, False, False),
              (1, 1048576, 13, 3, False, True),
              (2, 100, 400, 8, False, False))
# The serve launcher's fit (launch/serve.py).
FIT_QUERIES, FIT_EPOCHS, FIT_LR, FIT_BETA = 800, 4, 0.01, 5.0
DES_REQUESTS, DES_QPS, DES_DEADLINE_MS = 500, 400.0, 130.0
# The wall-clock pump and the router: the launcher's --pump / --replicas
# defaults (4 submitter threads, 2 replicas), --faults 0.2 for the chaos
# run; every wait on a future is bounded by RESULT_TIMEOUT_S.
PUMP_THREADS, N_REPLICAS, CHAOS_RATE, RESULT_TIMEOUT_S = 4, 2, 0.2, 60.0
ADOPT_BACKLOG = 48
# [paper]: the paper's suites (repro_torch.paper). Table 3 on the card is
# held to the same suite on the CPU: AUC within PAPER_AUC_TOL, the cost
# ratio within PAPER_COST_RTOL relative. Each suite must launch the
# kernels listed (the fits: K1 + K3 per L1 step, K4 + K5 per L3 step;
# evaluate's and the Eq-16 latency's forward: K1; run_cascade's zq: QB;
# Fig 5's sessions: K2); fig3 reuses table4's beta=5 fit.
PAPER_AUC_TOL, PAPER_COST_RTOL = 1e-4, 1e-4
PAPER_SUITE_KERNELS = {
    "table3": ("cascade_score_batched", "cascade_score_batched_bwd",
               "cascade_loss", "cascade_loss_bwd"),
    "table4": ("cascade_loss", "cascade_loss_bwd", "cascade_score_batched",
               "query_bias"),
    "fig3": ("cascade_score_batched",),
    "fig4": ("cascade_loss", "cascade_loss_bwd", "cascade_score_batched",
             "query_bias"),
    "fig5": ("cascade_loss", "cascade_loss_bwd", "cascade_filter",
             "query_bias")}
# [witness]: the pump with --faults and the router's kill run at this many
# requests, and the adopted backlog, under the lock-order witness.
WITNESS_REQUESTS, WITNESS_ADOPT_BACKLOG = 200, 24
SHIM_REQUESTS = 200
# The injector's own exceptions (and the session's guard against the
# corrupt scores it plants): the only errors a chaos run may end in.
INJECTED_ERRORS = ("TransientFault", "PoisonFault", "CorruptOutput")
BUSY_CYCLES = 50_000_000    # ~25 ms at 1.98 GHz: covers queueing the calls
# Zero features make the logits these biases exactly; on the CPU lp_T is
# then float32(-1e-7), the NLL clamp, exactly (tests/test_torch_losses.py);
# phase 3 searches around them for a pair that ties on the card.
TIE_ZQ = (16.118097, 29.3795)
# The times (ms, H100 80GB HBM3, 700 W) of the designs the current K1, K3,
# K4, K5, K6 and K6's backward replace, printed beside the new ones ("b1":
# one group of 1,048,576 items). K6's at the training shape are its
# previous design's per-group launches under vmap: 64 at N = 64, 0.0061
# and 0.0128 ms each.
WAS_MS = {"cascade_score_batched": {TIMING_SHAPE: 0.0945, TRAIN_SHAPE: 0.0083,
                                    "b1": 0.0944},
          "cascade_score_batched_bwd": {TIMING_SHAPE: 0.2387,
                                        TRAIN_SHAPE: 0.0135},
          "cascade_loss": {TIMING_SHAPE: 0.1310, TRAIN_SHAPE: 0.0096},
          "cascade_loss_bwd": {TIMING_SHAPE: 0.4143, TRAIN_SHAPE: 0.0157},
          "cascade_score": {"b1": 0.0919, TRAIN_SHAPE: 64 * 0.0061},
          "cascade_score_bwd": {"b1": 0.2280, TRAIN_SHAPE: 64 * 0.0128}}
# The share of its bound each redesigned kernel aims at, at the timing shape
# (K6 and its backward: on one group of 1,048,576 items).
TARGET_SHARE = {"cascade_score_batched": 0.60,
                "cascade_score_batched_bwd": 0.50, "cascade_loss": 0.50,
                "cascade_loss_bwd": 0.40, "cascade_score": 0.60,
                "cascade_score_bwd": 0.50}
# The vmapped K6 call against K1 and K6's backward against K3 on the same
# (B, G) shape: the most time it may take as a multiple of theirs.
VMAP_RATIO_BAR = 1.25
# The widest d the previous designs took at these T (one block per tile or
# group, in floats of shared memory: K1 t d + 128 (d + 1) + 128 t; K3
# t d + 128 (d + 1) + 128 t + t (d + 1); K4 t d + 128 (d + 5) + 128 (1 + 2t)
# + 1 + 2t; K5 t d + 128 (d + 5) + 256 t + t (d + 2)): the new ones must
# take them too.
PREV_WIDEST_D = {("cascade_score_batched", 3): 439,
                 ("cascade_score_batched_bwd", 3): 429,
                 ("cascade_score_batched_bwd", 8): 395,
                 ("cascade_loss", 3): 431, ("cascade_loss", 8): 406,
                 ("cascade_loss_bwd", 8): 384}
# A wrapper's shared-memory entry point, where it is not `<wrapper>_smem`.
SMEM_ENTRY = {"cascade_score_batched_bwd": "cascade_score_bwd_smem"}

KERNEL_INFO = {
    "cascade_score_batched": {
        "id": "K1", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_score.cu",
        "replaces": "src/repro/kernels/cascade_score/kernel.py:238"},
    "cascade_filter": {
        "id": "K2", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_filter.cu",
        "replaces": "src/repro/kernels/cascade_filter/kernel.py:111"},
    "cascade_score_batched_bwd": {
        "id": "K3", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_score_bwd.cu",
        "replaces": "src/repro/kernels/cascade_score/kernel.py:305"},
    "cascade_loss": {
        "id": "K4", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_loss.cu",
        "replaces": "src/repro/kernels/cascade_loss/kernel.py:175"},
    "cascade_loss_bwd": {
        "id": "K5", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_loss.cu",
        "replaces": "src/repro/kernels/cascade_loss/kernel.py:271"},
    "swa_decode": {
        "id": "K8", "route": "cuda",
        "source": "src/repro_torch/csrc/swa_decode.cu",
        "replaces": "src/repro/kernels/swa_decode/kernel.py:75"},
    # K8's partials mode: the same kernel, writing the softmax state of a
    # rank's block of a sequence-cut cache
    "swa_decode_partial": {
        "id": "K8 partial", "route": "cuda",
        "source": "src/repro_torch/csrc/swa_decode.cu",
        "replaces": "src/repro/kernels/swa_decode/kernel.py:75"},
    "cascade_score": {
        "id": "K6", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_score.cu",
        "replaces": "src/repro/kernels/cascade_score/kernel.py:73"},
    "cascade_score_bwd": {
        "id": "K6 bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_score_single.cu",
        "replaces": "src/repro/kernels/cascade_score/kernel.py:154"},
    "cascade_score_fm": {
        "id": "K7", "route": "cuda",
        "source": "src/repro_torch/csrc/cascade_score_single.cu",
        "replaces": "src/repro/kernels/cascade_score/kernel.py:365"},
    # port-only: the reference computes zq in XLA, no Pallas kernel
    "query_bias": {
        "id": "QB", "route": "cuda",
        "source": "src/repro_torch/csrc/query_bias.cu",
        "replaces": "src/repro/core/pipeline.py:140"},
}


def sync():
    torch.cuda.synchronize()


# -- 1. device ----------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# -- 1b. lint ------------------------------------------------------------------

def phase_lint() -> dict:
    """The port's cascade-lint (`repro_torch.analysis`, stdlib `ast`
    only) over this checkout, in-process: src/repro_torch, the port's
    tests and this script. Any finding fails the run. Imported here, not
    at the top: kernel_ab.py runs this script's code on trees that
    predate the package."""
    from repro_torch.analysis import core as lint
    t0 = time.perf_counter()
    files = lint.collect_files(lint.default_targets())
    findings = lint.run(files)
    ms = 1e3 * (time.perf_counter() - t0)
    for f in findings:
        print(f"[lint] {f}")
    print(f"[lint] {len(files)} files scanned, {len(lint.all_rules())} "
          f"rules, {len(findings)} findings in {ms:.1f} ms")
    assert not findings, f"[lint] {len(findings)} findings"
    return dict(files=len(files), findings=len(findings), ms=ms)


# -- 1c. the cost report --------------------------------------------------------

def cost_report():
    """The cost report's modules (`launch/dryrun.py`, `launch/roofline.py`),
    imported here, not at the top: kernel_ab.py runs this script's code on
    trees that predate them."""
    from repro_torch.launch import dryrun, roofline
    return dryrun, roofline


def costs_combos() -> list[tuple[str, str]]:
    """`configs/shapes.py`'s (arch, shape) combos that `[costs]` traces:
    all but the recurrent archs' train and prefill, whose chunked forms'
    Python loops over chunks take minutes of host time to trace (the CLI's
    --all runs them)."""
    out = []
    for arch in CFG.all_archs():
        recurrent = CFG.get(arch).arch_type in ("ssm", "hybrid")
        for shape, sh in SHAPES.items():
            if not (recurrent and sh.step != "decode"):
                out.append((arch, shape))
    return out


HOST_WORKERS = min(8, os.cpu_count() or 1)


@functools.lru_cache(maxsize=1)
def host_pool() -> concurrent.futures.ProcessPoolExecutor:
    """The pool of HOST_WORKERS spawned processes that traces on the
    host's CPU: `[costs]` starts it, `[pod costs]` reuses it (its workers
    wait idle in between, so the second phase pays no start-up), and main
    shuts it down after that (or the interpreter's exit, after a failed
    phase)."""
    pool = concurrent.futures.ProcessPoolExecutor(
        HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    atexit.register(pool.shutdown)
    return pool


def phase_costs(tmp: str) -> dict:
    """The dry-run cost report on the host at --variant auto over
    `costs_combos()`, written under tmp: one line per combo (skipped ones
    with the reason) and the phase's wall time. The combos are traced in
    `host_pool()`, the longest (the 32k-token prefills' KV-chunk loops)
    first. A combo that fails to trace fails the run."""
    DR, RL = cost_report()
    t0 = time.perf_counter()
    combos = sorted(costs_combos(),
                    key=lambda c: ("prefill", "train", "decode").index(
                        SHAPES[c[1]].step))
    pool = host_pool()
    futures = {(arch, shape): pool.submit(
        DR.run_one, arch, shape, out_dir=Path(tmp),
        variant=DR.recommended_variant(CFG.get(arch), shape))
        for arch, shape in combos}
    done = {c: f.result() for c, f in futures.items()}
    recs = {}
    for arch, shape in costs_combos():
        rec = done[(arch, shape)]
        if rec["status"] == "skipped":
            print(f"[costs] {arch} x {shape}: skipped ({rec['skipped']})")
            continue
        recs[(arch, shape)] = rec
        print(f"[costs] {arch} x {shape} ({rec['variant']}): "
              f"{DR.summary(rec)}")
    seconds = time.perf_counter() - t0
    print(f"[costs] {len(recs)} combos traced on meta tensors in "
          f"{seconds:.1f} s on the host ({HOST_WORKERS} processes; one H100's "
          f"peaks: {RL.PEAK_FLOPS:.3g} FLOP/s bf16, {RL.HBM_BW:.3g} B/s)")
    return dict(records=recs, seconds=seconds)


def decode_bound(cfg, b: int, max_len: int, pos: int, enc_len: int = 0
                 ) -> dict:
    """The cost report's record of one decode step of cfg (its layers as
    cut) at batch b against a cache of max_len positions at cache_len pos,
    with its bound (ms) and what bounds it."""
    DR, RL = cost_report()
    rec = DR.step_record(cfg, "decode", batch=b, seq_len=max_len,
                         cache_len=pos, enc_len=enc_len)
    seconds, by = RL.bound(rec)
    return dict(rec=rec, bound_ms=seconds * 1e3, by=by)


def bound_note(tag: str, med: float, bnd: dict) -> str:
    """Assert the median step no faster than the report's bound (else the
    count is wrong) and say how far it is."""
    if med < bnd["bound_ms"]:
        raise AssertionError(
            f"[{tag}] median step {med:.4f} ms is faster than the cost "
            f"report's bound {bnd['bound_ms']:.4f} ms: the count is wrong")
    cost = bnd["rec"]["cost"]
    return (f"report bound {bnd['bound_ms']:.3f} ms by {bnd['by']} "
            f"({cost['bytes accessed']:.0f} bytes, {cost['flops']:.4g} FLOPs "
            f"at cache_len {bnd['rec']['cache_len']}; "
            f"{bnd['bound_ms'] / med:.1%} of the median)")


# -- 2. build -----------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    ops.load_library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f}s -> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build]   {line.strip()}")


# -- 3. kernels vs plain --------------------------------------------------------

def make_case(b, g, d, t, seed, *, twins=False, masked_group=None,
              mq_big=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, g, d))
    if twins:                       # every item has an identical twin
        x[:, 1::2] = x[:, ::2][:, :g // 2]
    w = 0.3 * rng.normal(size=(t, d))
    zq = np.full((b, t), 8.0) if mq_big else rng.normal(size=(b, t))
    mask = (rng.random((b, g)) < 0.85).astype(np.float32)
    if twins or mq_big:
        mask[:] = 1.0
    if masked_group is not None:
        mask[masked_group] = 0.0
    m_q = np.full(b, 1e6) if mq_big else rng.integers(1, 4 * g + 2, b)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    return dev(x), dev(w), dev(zq), dev(mask), dev(m_q)


def case_with_margin(b, g, d, t, seed, **kw):
    """The first seed from `seed` on whose inputs every discrete decision
    of the plain filter has margin."""
    last = None
    for s in range(seed, seed + 50):
        case = make_case(b, g, d, t, s, **kw)
        lp = ops.cascade_score_batched_ref(*case[:3])
        try:
            assert_decision_margin(lp, case[3], case[4])
            return case
        except AssertionError as e:
            last = e
    raise AssertionError(f"no seed with decision margin for {(b, g, d, t)}: "
                         f"{last}")


def at_offset(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `a` whose storage starts 4 bytes past a 16-byte
    boundary (the kernels' scalar paths take such an input)."""
    k = 4 // a.element_size()          # elements in 4 bytes
    buf = torch.empty(a.numel() + k, dtype=a.dtype, device=a.device)
    out = buf[k:].view(a.shape)
    out.copy_(a)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


def check_case(case, errs, label):
    x, w, zq, mask, m_q = case
    got = ops.cascade_score_batched(x, w, zq)
    sync()
    want = ops.cascade_score_batched_ref(x, w, zq)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                               msg=lambda m: f"K1 {label}: {m}")
    errs["cascade_score_batched"] = max(
        errs["cascade_score_batched"], float((got - want).abs().max()))
    got = ops.cascade_filter(x, w, zq, mask, m_q)
    sync()
    want = ops.cascade_filter_ref(x, w, zq, mask, m_q)
    for k in ("lp", "expected_counts"):
        torch.testing.assert_close(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"K2 {label} {k}: {m}")
        errs["cascade_filter"] = max(errs["cascade_filter"],
                                     float((got[k] - want[k]).abs().max()))
    for k in ("n_keep", "survivors"):
        if not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5].tolist()
            raise AssertionError(f"K2 {label}: {k} differs from the plain "
                                 f"version at {bad}")
    return got


def phase_parity() -> dict[str, float]:
    errs = {"cascade_score_batched": 0.0, "cascade_filter": 0.0}
    n = 0
    for g in WARM_G:
        for b in WARM_B:
            check_case(case_with_margin(b, g, 24, 3, seed=1000 * g + b),
                       errs, f"warm shape b={b} g={g}")
            n += 1
    # the last five: d % 4 != 0 (K1's and K2's scalar layouts; (4, 512, 50,
    # 8) also cuts K2's x tile into column chunks)
    for b, g, d, t in [(4, 1, 24, 3), (4, 7, 24, 3), (4, 130, 24, 3),
                       (4, 512, 24, 3), (8, 64, 8, 1), (8, 64, 40, 5),
                       (8, 64, 24, 8), (4, 512, 40, 8), (3, 33, 8, 5),
                       (4, 64, 5, 3), (4, 130, 13, 8), (8, 256, 27, 3),
                       (3, 7, 27, 1), (4, 512, 50, 8)]:
        check_case(case_with_margin(b, g, d, t, seed=g * 37 + d + t),
                   errs, f"b={b} g={g} d={d} t={t}")
        n += 1
    # x contiguous at a 4-byte storage offset (not 16-byte aligned)
    for b, g, d, t in [(4, 256, 24, 3), (3, 130, 13, 5)]:
        x, w, zq, mask, m_q = case_with_margin(b, g, d, t, seed=g + d)
        check_case((at_offset(x), w, zq, mask, m_q), errs,
                   f"offset x b={b} g={g} d={d} t={t}")
        n += 1
    got = check_case(case_with_margin(3, 64, 24, 3, seed=0, twins=True),
                     errs, "ties")
    kept = got["survivors"][..., -1].sum().item()
    assert 0 < kept < 3 * 64, f"tie case kept {kept} of 192"
    got = check_case(case_with_margin(3, 32, 24, 3, seed=1, masked_group=1),
                     errs, "fully masked group")
    assert got["survivors"][1].sum().item() == 0
    assert (got["n_keep"][1] == 1).all()
    got = check_case(case_with_margin(2, 16, 24, 2, seed=2, mq_big=True),
                     errs, "m_q > G")
    assert (got["n_keep"] == 16).all()
    assert (got["survivors"][..., -1] == 1).all()
    n += 3
    # K1 alone where its blocks walk many tiles and a tile spans many
    # groups: the timing shape, one group of 1,048,576 items, and odd G
    # (scalar path, unaligned x)
    for b, g, d, t, offset in [(*TIMING_SHAPE, False), (1, 1 << 20, 24, 3, False),
                               (3001, 77, 13, 5, False),
                               (2000, 33, 24, 3, True)]:
        check_alone("cascade_score_batched", (b, g, d, t), b + g, errs,
                    offset=offset)
        n += 1
    # the widest d (a one-tile ring), checked, and one past it refused
    widest, n_wide = check_widest("cascade_score_batched", 3, errs)
    n += n_wide
    print(f"[parity] {n} cases: kernels agree with their plain versions "
          f"(max |err| K1 {errs['cascade_score_batched']:.3g}, "
          f"K2 {errs['cascade_filter']:.3g}; discrete outputs exact); K1 "
          f"takes d <= {widest} at T=3 (its previous design "
          f"{PREV_WIDEST_D[('cascade_score_batched', 3)]}) and refuses "
          f"{widest + 1}")
    return errs


def check_alone(name, shape, seed, errs, offset=False) -> None:
    """K1, K3, K4 or K5 (`name`) alone against its plain version on a case
    at (B, G, d, T), its x or xc (and K3's cotangent) at a 4-byte storage
    offset if `offset`."""
    b, g, d, t = shape
    place = at_offset if offset else (lambda a: a)
    if name == "cascade_score_batched":
        x, w, zq, _, _ = make_case(b, g, d, t, seed=seed)
        args = (place(x), w, zq)
        got = (ops.cascade_score_batched(*args),)
        sync()
        want = (ops.cascade_score_batched_ref(*args),)
        rtol, atol = RTOL, ATOL
    elif name == "cascade_score_batched_bwd":
        xc, w, zq, gct, *_ = train_case(b, g, d, t, seed=seed)
        args = (place(xc[..., :d].contiguous()), w, zq, place(gct))
        got = score_kernel.cascade_score_batched_bwd(*args)
        sync()
        want = ops.cascade_score_batched_bwd_ref(*args)
        rtol, atol = BWD_RTOL, BWD_ATOL
    elif name == "cascade_loss":
        xc, w, zq, *_ = train_case(b, g, d, t, seed=seed)
        args = (place(xc), w, zq)
        got = loss_kernel.cascade_loss(*args)
        sync()
        want = ops.cascade_loss_ref(*args)
        rtol, atol = FWD_RTOL, ATOL
    else:
        xc, w, zq, _, g_ll, g_cost, g_cnt = train_case(b, g, d, t, seed=seed)
        args = (place(xc), w, zq, g_ll, g_cost, g_cnt)
        got = loss_kernel.cascade_loss_bwd(*args)
        sync()
        want = ops.cascade_loss_bwd_ref(*args)
        rtol, atol = BWD_RTOL, BWD_ATOL
        assert got[0][..., d:].abs().max().item() == 0.0, (
            f"K5 {shape}: dxc data lanes")
    _check(name, got, want, rtol, atol, f"{shape} offset={offset}", errs)


def widest_d(name, t) -> int:
    """The widest d whose launch of K1, K3, K4 or K5 (`name`) at T = t fits
    in a block's shared memory: the wrapper refuses wider."""
    smem = getattr(_build.load_library(),
                   SMEM_ENTRY.get(name, f"{name}_smem"))
    d = 1
    while smem(d + 1, t) <= _build.MAX_SMEM_BYTES:
        d += 1
    return d


def check_widest(name, t, errs) -> tuple[int, int]:
    """K1, K3, K4 or K5 at T = t: at its previous design's widest d (and
    one more: the other of the vector and scalar paths) and at its own
    widest d against its plain version, and its wrapper refusing one past
    that.
    Returns (the widest d, cases checked)."""
    d = widest_d(name, t)
    prev = PREV_WIDEST_D[(name, t)]
    assert d >= prev, (f"{name} takes d <= {d} at T={t}; its previous "
                       f"design took {prev}")
    ds = sorted({prev, prev + 1, d})
    for dd in ds:
        check_alone(name, (2, 40, dd, t), dd, errs)
    try:
        check_alone(name, (1, 4, d + 1, t), 0, errs)
    except ValueError as e:
        assert "shared memory" in str(e), e
    else:
        raise AssertionError(f"{name} took d={d + 1} at T={t}, past its "
                             "shared memory")
    return d, len(ds)


def train_case(b, g, d, t, seed, *, dead_group=True):
    """K3/K4/K5 inputs on the card: packed items xc (B, G, d+4) with
    group 0 fully masked when dead_group, w (T, d), zq (B, T), and the
    cotangents g (B, G, T), g_ll (B,), g_cost (T,), g_cnt (B, T)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, g, d))
    y = rng.integers(0, 2, (b, g)).astype(np.float64)
    mask = (rng.random((b, g)) < 0.85).astype(np.float64)
    if dead_group:
        mask[0] = 0.0
    wgt = rng.uniform(0.5, 3.0, (b, g)) * mask
    cost_w = rng.uniform(0.0, 50.0, (b, g)) * mask
    xc = np.concatenate([x, y[..., None], mask[..., None], wgt[..., None],
                         cost_w[..., None]], axis=-1)
    arrays = (xc, 0.3 * rng.normal(size=(t, d)), rng.normal(size=(b, t)),
              rng.normal(size=(b, g, t)) * mask[..., None],
              rng.normal(size=b), rng.normal(size=t), rng.normal(size=(b, t)))
    return tuple(torch.tensor(a, dtype=torch.float32, device="cuda")
                 for a in arrays)


def find_tie_zq() -> tuple[float, float]:
    """Biases (z1, z2) for which lp_T = log s(z1) + log s(z2) is
    float32(-1e-7) exactly both in the plain version on the card and in K1,
    whose log-sigmoid and stage sum K4 and K5 share: a search around the
    pair that ties on the CPU, z1 by float32 steps, z2 by 0.01."""
    target = np.float32(-1e-7)
    base = np.array([TIE_ZQ[0]], np.float32).view(np.int32)[0]
    z1 = (base + np.arange(-128, 128)).astype(np.int32).view(np.float32)
    z2 = np.concatenate([[TIE_ZQ[1]], np.linspace(18.0, 40.0, 2201)])
    grid = np.stack(np.meshgrid(z1, z2.astype(np.float32), indexing="ij"),
                    axis=-1).reshape(-1, 2)
    first = np.nonzero((grid == np.array(TIE_ZQ, np.float32)).all(-1))[0]
    grid = np.concatenate([grid[first], grid])       # the CPU's pair first
    zq = torch.tensor(grid, device="cuda")
    x = torch.zeros((len(grid), 1, 4), device="cuda")
    w = torch.zeros((2, 4), device="cuda")
    lp_k = score_kernel.cascade_score_batched(x, w, zq)[:, 0, -1]
    lp_p = ops.cascade_score_batched_ref(x, w, zq)[:, 0, -1]
    hit = torch.nonzero((lp_k == float(target)) & (lp_p == float(target)))
    assert len(hit), "no float32 tie with the NLL clamp found"
    z = grid[int(hit[0, 0])]
    return float(z[0]), float(z[1])


def tie_case():
    """lp_T exactly at the NLL clamp for both items; NLL cotangent only."""
    d = 4
    xc = torch.zeros((1, 2, d + 4), device="cuda")
    xc[0, 1, d] = 1.0                       # y: one negative, one positive
    xc[0, :, d + 1:] = 1.0                  # mask, wgt, cost_w
    zq = torch.tensor([find_tie_zq()], device="cuda")
    w = torch.zeros((2, d), device="cuda")
    return (xc, w, zq, torch.zeros((1, 2, 2), device="cuda"),
            torch.ones(1, device="cuda"), torch.zeros(2, device="cuda"),
            torch.zeros((1, 2), device="cuda"))


def _check(name, got, want, rtol, atol, label, errs):
    for i, (a, r) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, r, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name} {label} out {i}: {m}")
        errs[name] = max(errs[name], float((a - r).abs().max()))


def check_train_case(case, errs, label, offset=False):
    """K3, K4 and K5 on one case against their plain versions; with
    `offset`, xc, K3's x and its cotangent g at a 4-byte storage offset."""
    xc, w, zq, g, g_ll, g_cost, g_cnt = case
    d = w.shape[1]
    x = xc[..., :d].contiguous()
    if offset:
        xc, x, g = at_offset(xc), at_offset(x), at_offset(g)
    got = score_kernel.cascade_score_batched_bwd(x, w, zq, g)
    sync()
    _check("cascade_score_batched_bwd", got,
           ops.cascade_score_batched_bwd_ref(x, w, zq, g),
           BWD_RTOL, BWD_ATOL, label, errs)
    got = loss_kernel.cascade_loss(xc, w, zq)
    sync()
    want = ops.cascade_loss_ref(xc, w, zq)
    _check("cascade_loss", got, want, FWD_RTOL, ATOL, label, errs)
    got = loss_kernel.cascade_loss_bwd(xc, w, zq, g_ll, g_cost, g_cnt)
    sync()
    _check("cascade_loss_bwd", got,
           ops.cascade_loss_bwd_ref(xc, w, zq, g_ll, g_cost, g_cnt),
           BWD_RTOL, BWD_ATOL, label, errs)
    assert got[0][..., d:].abs().max().item() == 0.0, "dxc data lanes"
    return got


def phase_train_parity(errs) -> None:
    n = 0
    # d + 4 a multiple of 4 (8, 24) and not (5, 13, 27: K5's scalar path)
    for g in (1, 7, 130):
        for d in (8, 24, 5, 13, 27):
            for t in (1, 3, 8):
                check_train_case(train_case(3, g, d, t, seed=g * 11 + d + t),
                                 errs, f"g={g} d={d} t={t}")
                n += 1
    b, g, d, t = TRAIN_SHAPE
    check_train_case(train_case(b, g, d, t, seed=5), errs, "training shape")
    # xc, and K3's x and g, at a 4-byte storage offset (the scalar paths);
    # more groups than the kernels have blocks on the card, so their blocks
    # walk several groups each, and groups of 7: at T = 3 the chunks of K3's
    # g start at float 21 b, 16-byte aligned only where b % 4 == 0
    check_train_case(train_case(b, g, d, t, seed=6), errs, "offset inputs",
                     offset=True)
    check_train_case(train_case(5000, 7, 24, 3, seed=7), errs,
                     "5000 groups of 7")
    check_train_case(train_case(2000, 7, 24, 3, seed=10), errs,
                     "offset inputs, 2000 groups of 7", offset=True)
    # K3, K4 and K5 at the widest d K5's previous design took (with one
    # warp a block here), then each alone at the widest d of its previous
    # design and its own
    check_train_case(train_case(2, 40, 384, 8, seed=8), errs, "d=384 t=8")
    n += 5
    widest = {}
    for name, tt in (("cascade_score_batched_bwd", 3),
                     ("cascade_score_batched_bwd", 8), ("cascade_loss", 3),
                     ("cascade_loss", 8), ("cascade_loss_bwd", 8)):
        widest[(name, tt)], n_wide = check_widest(name, tt, errs)
        n += n_wide
    case = tie_case()
    got = check_train_case(case, errs, "clamp tie")
    assert got[2].abs().max().item() > 0, "the tie must pass the tangent"
    print(f"[parity] clamp tie at zq = {case[2].tolist()}")
    n += 1
    print(f"[parity] {n} training cases: K3 max |err| "
          f"{errs['cascade_score_batched_bwd']:.3g}, K4 "
          f"{errs['cascade_loss']:.3g}, K5 {errs['cascade_loss_bwd']:.3g}")
    for (name, tt), d_max in widest.items():
        print(f"[parity] {KERNEL_INFO[name]['id']} takes d <= {d_max} at "
              f"T={tt} (its previous design {PREV_WIDEST_D[(name, tt)]}) "
              f"and refuses {d_max + 1}")


def single_case(n, d, t, seed, dtype=torch.float32, zero_tail=True):
    """K6/K7 inputs on the card: x (N, d) in `dtype` with its last N // 4
    rows zero when zero_tail, w (T, d) at 0.3 scale and zq (T,) in `dtype`,
    and a float32 cotangent g (N, T)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device="cuda")
    if zero_tail:
        x[n - n // 4:] = 0.0
    w = 0.3 * torch.randn((t, d), generator=gen, device="cuda")
    zq = torch.randn(t, generator=gen, device="cuda")
    g = torch.randn((n, t), generator=gen, device="cuda")
    return x.to(dtype), w.to(dtype), zq.to(dtype), g


def sum_scales(x, w, zq, g) -> tuple[torch.Tensor, torch.Tensor]:
    """sum_i |term_i| of each of K6's backward sums, in float64: dw (T, d)
    and dzq shaped as zq from |g_logit| (the closed form of
    `cascade_score_bwd_ref`) and |x|."""
    xd, gd = x.double(), g.double()
    t, d = w.shape
    logits = xd @ w.double().T + zq.double()[..., None, :]
    gc = gd.sum(-1, keepdim=True) - gd.cumsum(-1) + gd
    g_logit = (gc * torch.sigmoid(-logits)).abs()
    dzq = g_logit.sum(-2)
    return (g_logit.reshape(-1, t).T @ xd.abs().reshape(-1, d),
            dzq if dzq.ndim == zq.ndim else dzq.reshape(-1, t).sum(0))


def check_bwd_single(got, x, w, zq, g, label, errs) -> float:
    """K6's backward against its plain version: dx at BWD_RTOL/BWD_ATOL,
    dw and dzq with the sums' slack too. Returns the largest share of its
    bar that an element of dw or dzq used."""
    want = ops.cascade_score_bwd_ref(x, w, zq, g)
    _check("cascade_score_bwd", got[:1], want[:1], BWD_RTOL, BWD_ATOL, label,
           errs)
    use = 0.0
    for name, a, r, scale in zip(("dw", "dzq"), got[1:], want[1:],
                                 sum_scales(x, w, zq, g)):
        err = (a - r).abs()
        bar = BWD_ATOL + BWD_RTOL * r.abs() + U32 * scale.float()
        assert (err <= bar).all(), (
            f"K6 bwd {label} {name}: |err| up to {float(err.max()):.3g}, "
            f"{int((err > bar).sum())} elements over the bar")
        errs["cascade_score_bwd"] = max(errs["cascade_score_bwd"],
                                        float(err.max()))
        use = max(use, float((err / bar).max()))
    return use


def phase_single_parity(errs) -> None:
    """K6 forward and backward and K7 against their plain versions on the
    card; the zero rows inert; K7 against K6 on the same items."""
    cases, fm_same_bits, bar_use = 0, 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n in SINGLE_N:
            for d, t in SINGLE_DT:
                x, w, zq, g = single_case(n, d, t, seed=cases, dtype=dtype)
                label = f"{dtype} n={n} d={d} t={t}"
                got = score_kernel.cascade_score(x, w, zq)
                fm = score_kernel.cascade_score_fm(x.T.contiguous(), w, zq)
                grads = score_kernel.cascade_score_bwd(x, w, zq, g)
                sync()
                want = ops.cascade_score_ref(x, w, zq)
                _check("cascade_score", [got], [want], RTOL, ATOL, label, errs)
                _check("cascade_score_fm", [fm], [want], RTOL, ATOL, label,
                       errs)
                torch.testing.assert_close(
                    fm, got, rtol=RTOL, atol=ATOL,
                    msg=lambda m: f"K7 against K6 {label}: {m}")
                bar_use = max(bar_use, check_bwd_single(grads, x, w, zq, g,
                                                        label, errs))
                inert = torch.cumsum(torch.nn.functional.logsigmoid(
                    zq.float()), 0)
                torch.testing.assert_close(
                    got[n - n // 4:], inert.expand(n // 4, t), rtol=RTOL,
                    atol=ATOL, msg=lambda m: f"K6 {label} zero rows: {m}")
                fm_same_bits += torch.equal(fm, got)
                cases += 1
    print(f"[parity] {cases} K6/K7 cases (n up to {max(SINGLE_N)}, f32 and "
          f"bf16 inputs): max |err| K6 {errs['cascade_score']:.3g}, K6 bwd "
          f"{errs['cascade_score_bwd']:.3g} (dw, dzq at most {bar_use:.3f} "
          f"of their bar), K7 {errs['cascade_score_fm']:.3g}"
          f"; K7 bit-equal to K6 in {fm_same_bits} of {cases}; zero rows "
          "score cumsum log sigmoid(zq)")


def groups_case(b, n, d, t, seed, dtype, shared, offset):
    """K6 inputs for B groups (the launch a vmapped call makes): x (B, N, d),
    zq (B, T) or one shared row (T,), cotangent g (B, N, T), all in
    `dtype`, x at a 4-byte storage offset when `offset`; B = 1 without a
    shared row is one group, x (N, d) and zq (T,)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, d), generator=gen, device="cuda")
    w = 0.3 * torch.randn((t, d), generator=gen, device="cuda")
    zq = torch.randn((t,) if shared else (b, t), generator=gen, device="cuda")
    g = torch.randn((b, n, t), generator=gen, device="cuda")
    if b == 1 and not shared:
        x, zq, g = x[0], zq[0], g[0]
    x, w, zq, g = (a.to(dtype).contiguous() for a in (x, w, zq, g))
    return at_offset(x) if offset else x, w, zq, g


def check_groups(b, n, d, t, seed, dtype, shared, offset, errs) -> float:
    """K6 forward and backward on one `groups_case` against their plain
    versions, and launched twice: the same bits. Returns the largest share
    of its bar an element of dw or dzq used."""
    x, w, zq, g = groups_case(b, n, d, t, seed, dtype, shared, offset)
    label = (f"{dtype} B={b} N={n} d={d} t={t} zq "
             f"{'shared' if shared else 'per group'}"
             f"{' x at offset' if offset else ''}")
    runs = [(score_kernel.cascade_score(x, w, zq),
             *score_kernel.cascade_score_bwd(x, w, zq, g)) for _ in range(2)]
    sync()
    for u, v in zip(*runs):
        assert torch.equal(u, v), f"K6 {label}: two launches differ"
    _check("cascade_score", runs[0][:1], [ops.cascade_score_ref(x, w, zq)],
           RTOL, ATOL, label, errs)
    return check_bwd_single(runs[0][1:], x, w, zq, g, label, errs)


def phase_vmap_parity(errs) -> None:
    """K6 forward and backward on B groups at once (VMAP_CASES, float32 and
    bfloat16) against their plain versions, each launched twice."""
    cases, bar_use = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d, t, shared, offset in VMAP_CASES:
            bar_use = max(bar_use, check_groups(b, n, d, t, cases, dtype,
                                                shared, offset, errs))
            cases += 1
    print(f"[parity] {cases} vmapped K6 cases (B groups in one launch, up to "
          f"B x N = {max(b * n for b, n, *_ in VMAP_CASES)}, f32 and bf16): "
          f"max |err| K6 {errs['cascade_score']:.3g}, K6 bwd "
          f"{errs['cascade_score_bwd']:.3g} (dw, dzq at most {bar_use:.3f} of "
          "their bar); two launches give the same bits")


def phase_determinism() -> None:
    """Each kernel twice on the same inputs: the same bits."""
    b, g, d, t = TIMING_SHAPE
    xc, w, zq, gct, g_ll, g_cost, g_cnt = train_case(b, g, d, t, seed=9)
    x = xc[..., :d].contiguous()
    mask, m_q = xc[..., d + 1].contiguous(), torch.full((b,), 5000.0,
                                                        device="cuda")
    # K6 and K7: the same items as one group of B * G
    x1, g1, zq1 = x.view(b * g, d), gct.view(b * g, t), zq[0]
    xt1 = x1.T.contiguous()
    runs = {
        "cascade_score_batched": lambda: [ops.cascade_score_batched(x, w, zq)],
        "cascade_filter": lambda: list(
            ops.cascade_filter(x, w, zq, mask, m_q).values()),
        "cascade_score_batched_bwd": lambda: list(
            score_kernel.cascade_score_batched_bwd(x, w, zq, gct)),
        "cascade_loss": lambda: list(loss_kernel.cascade_loss(xc, w, zq)),
        "cascade_loss_bwd": lambda: list(loss_kernel.cascade_loss_bwd(
            xc, w, zq, g_ll, g_cost, g_cnt)),
        "cascade_score": lambda: [score_kernel.cascade_score(x1, w, zq1)],
        "cascade_score_bwd": lambda: list(score_kernel.cascade_score_bwd(
            x1, w, zq1, g1)),
        "cascade_score_fm": lambda: [score_kernel.cascade_score_fm(
            xt1, w, zq1)],
    }
    for name, run in runs.items():
        a, z = run(), run()
        sync()
        for u, v in zip(a, z):
            assert torch.equal(u, v), f"{name}: two launches differ"
    print(f"[determinism] {len(runs)} kernels at B={b} G={g}: two launches "
          "on the same inputs give the same bits")


# -- 3b. query_bias: zq per row, in a fixed order -------------------------------

def qb_case(rows, seed):
    """query_bias's inputs at `rows` rows: q half one-hot query buckets (as
    the log draws them) and half normal draws, w_q and b of the CLOES
    cascade's shapes."""
    cfg = cloes.CASCADE
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(rows, cfg.d_q)).astype(np.float32)
    hot = rng.integers(0, cfg.d_q, (rows + 1) // 2)
    q[::2] = np.eye(cfg.d_q, dtype=np.float32)[hot]
    w = (0.3 * rng.normal(size=(cfg.n_stages, cfg.d_q))).astype(np.float32)
    b = rng.normal(size=(cfg.n_stages,)).astype(np.float32)
    return tuple(torch.tensor(a, device="cuda") for a in (q, w, b))


def phase_query_bias(errs) -> dict[int, dict]:
    """query_bias against its plain version at every row count in QB_ROWS:
    bit for bit on the card (asserted), and against the plain version on
    the CPU bit for bit, or else within 1e-6 (which of the two held is
    printed); the rows of one launch over all of them equal, bit for bit,
    the same rows launched in slices of every warmed b; two launches give
    the same bits. Then its time at QB_TIMING_ROWS beside its plain
    version, its bound and the library's q @ w_q.T + b (`torch.addmm`)."""
    held = "bit for bit"
    for rows in QB_ROWS:
        q, w, b = qb_case(rows, seed=rows)
        got = ops.query_bias(q, w, b)
        want = ops.query_bias_ref(q, w, b)
        assert torch.equal(got, want), f"query_bias at {rows} rows"
        assert torch.equal(got, ops.query_bias(q, w, b)), "two launches"
        cpu = ops.query_bias_ref(q.cpu(), w.cpu(), b.cpu())
        if not torch.equal(got.cpu(), cpu):
            torch.testing.assert_close(got.cpu(), cpu, rtol=1e-6, atol=1e-6)
            held = "within 1e-6"
        errs["query_bias"] = max(errs["query_bias"],
                                 float((got - want).abs().max()))
        for bb in WARM_B:
            if bb < rows:
                parts = torch.cat([ops.query_bias(q[s:s + bb], w, b)
                                   for s in range(0, rows, bb)])
                assert torch.equal(parts, got), (rows, bb)
    print(f"[parity] query_bias at rows {QB_ROWS}: bit-equal to its plain "
          f"version on the card; against the plain version on the CPU "
          f"{held}; every row's bits the same in slices of each b in "
          f"{WARM_B}")
    out = {}
    for rows in QB_TIMING_ROWS:
        q, w, b = qb_case(rows, seed=rows + 1)
        t_, d_q = w.shape
        kern, lone = time_ms(lambda: ops.query_bias(q, w, b))
        plain, _ = time_ms(lambda: ops.query_bias_ref(q, w, b))
        lib, _ = time_ms(lambda: torch.addmm(b, q, w.T))
        nbytes = 4 * (rows * d_q + t_ * d_q + t_ + rows * t_)
        nops = 2 * rows * t_ * d_q
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / F32_OPS_PER_S * 1e3
        out[rows] = r = dict(
            ms=kern, lone_ms=lone, plain_ms=plain, library_ms=lib,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations")
        print(f"[timing] QB query_bias at {rows} rows, d_q={d_q} T={t_}: "
              f"kernel {kern:.4f} ms (lone call {lone:.4f} ms), plain "
              f"{plain:.4f} ms, library addmm {lib:.4f} ms, bound "
              f"{r['bound_ms']:.3g} ms by {r['bound_by']} ({nbytes} bytes, "
              f"{nops} ops), {r['bound_ms'] / kern:.2%} of bound")
    return out


# -- 4. timing ------------------------------------------------------------------

def time_ms(fn, reps=25, calls=20) -> tuple[float, float]:
    """(device ms per call, ms per lone call), medians over `reps`.

    Device time: `calls` calls back to back between one pair of CUDA
    events, queued behind a busy-wait on the stream, so the host's
    wrapper work overlaps device work and the events see only the
    device's time. A lone call is one call from an idle stream between
    two events: the wrapper's host time up to the launch is inside it."""
    for _ in range(3):
        fn()
    sync()
    device, lone = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        z.record()
        z.synchronize()
        device.append(a.elapsed_time(z) / calls)
        a.record()
        fn()
        z.record()
        z.synchronize()
        lone.append(a.elapsed_time(z))
    return statistics.median(device), statistics.median(lone)


def shape_costs(b, g, d, t, pairs) -> dict[str, tuple[int, int]]:
    """(bytes, operations) each kernel must move and do at (B, G, d, T):
    every input read once, every output written once (float32).
    Operations: 2*B*G*T*d for the logits; K2 adds one compare and one add
    per (item, surviving item) pair per stage (`pairs`, counted on the
    run's data); K3 and K5 add the dx and dw products (~6*B*G*T*d in all,
    as the reference's backward does two more matmuls). K6 and its
    backward on B groups at once move what K1 and K3 do."""
    f = 4
    bgt, tdp = b * g * t, t * d
    k1 = (f * (b * g * d + tdp + b * t + bgt), 2 * bgt * d)
    k3 = (f * (2 * b * g * d + bgt + 2 * tdp + 2 * b * t), 6 * bgt * d)
    return {
        "cascade_score": k1, "cascade_score_bwd": k3,
        "cascade_score_batched": k1,
        "cascade_filter": (f * (b * g * d + tdp + b * t + b * g + b
                                + 2 * bgt + 2 * b * t),
                           2 * bgt * d + 2 * pairs),
        "cascade_score_batched_bwd": k3,
        "cascade_loss": (f * (b * g * (d + 4) + tdp + b * t + b + t + b * t),
                         2 * bgt * d),
        "cascade_loss_bwd": (f * (2 * b * g * (d + 4) + 2 * tdp + b * t + b
                                  + t + b * t + 2 * b * t), 6 * bgt * d),
    }


def was_note(name, key, r) -> str:
    """The previous design's time of a redesigned kernel at this shape,
    and at the timing shapes whether it reaches its target share of the
    bound."""
    was = WAS_MS.get(name, {}).get(key)
    if was is None:
        return ""
    note = (f"; was {was:.4f} ms (the previous design), now "
            f"{was / r['ms']:.2f}x as fast")
    if key in (TIMING_SHAPE, "b1"):
        share, target = r["bound_ms"] / r["ms"], TARGET_SHARE[name]
        note += (f"; target >= {target:.0%} of bound "
                 f"{'met' if share >= target else 'MISSED'}")
    return note


def time_shape(shape, seed, names=None) -> dict[str, dict]:
    """Each kernel of `names` (by default the five batched ones, and K6 and
    its backward on the B groups at once, as a vmapped call launches them)
    and its plain version at (B, G, d, T), beside its bound."""
    b, g, d, t = shape
    xc, w, zq, gct, g_ll, g_cost, g_cnt = train_case(b, g, d, t, seed=seed,
                                                     dead_group=False)
    x = xc[..., :d].contiguous()
    x1, w1, zq1, mask, m_q = make_case(b, g, d, t, seed=seed)
    calls = {
        "cascade_score_batched": (
            lambda: ops.cascade_score_batched(x1, w1, zq1),
            lambda: ops.cascade_score_batched_ref(x1, w1, zq1)),
        "cascade_filter": (
            lambda: ops.cascade_filter(x1, w1, zq1, mask, m_q),
            lambda: ops.cascade_filter_ref(x1, w1, zq1, mask, m_q)),
        "cascade_score_batched_bwd": (
            lambda: score_kernel.cascade_score_batched_bwd(x, w, zq, gct),
            lambda: ops.cascade_score_batched_bwd_ref(x, w, zq, gct)),
        "cascade_loss": (
            lambda: loss_kernel.cascade_loss(xc, w, zq),
            lambda: ops.cascade_loss_ref(xc, w, zq)),
        "cascade_loss_bwd": (
            lambda: loss_kernel.cascade_loss_bwd(xc, w, zq, g_ll, g_cost,
                                                 g_cnt),
            lambda: ops.cascade_loss_bwd_ref(xc, w, zq, g_ll, g_cost, g_cnt)),
        "cascade_score": (
            lambda: score_kernel.cascade_score(x1, w1, zq1),
            lambda: ops.cascade_score_ref(x1, w1, zq1)),
        "cascade_score_bwd": (
            lambda: score_kernel.cascade_score_bwd(x, w, zq, gct),
            lambda: ops.cascade_score_bwd_ref(x, w, zq, gct)),
    }
    calls = {k: v for k, v in calls.items() if names is None or k in names}
    pairs = 0
    if "cascade_filter" in calls:
        res = ops.cascade_filter(x1, w1, zq1, mask, m_q)
        entering = torch.cat([mask[..., None], res["survivors"][..., :-1]],
                             -1)
        pairs = int(entering.sum().item()) * g
    costs = shape_costs(b, g, d, t, pairs)
    out = {}
    for name, (kern_fn, plain_fn) in calls.items():
        kern, lone = time_ms(kern_fn)
        # the plain versions (up to ~20 ms a call) over fewer calls, as in
        # time_single
        plain, _ = time_ms(plain_fn, reps=5, calls=5)
        nbytes, nops = costs[name]
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / F32_OPS_PER_S * 1e3
        out[name] = dict(ms=kern, lone_ms=lone, plain_ms=plain, bytes=nbytes,
                         ops=nops, bound_ms=max(by_bytes, by_ops),
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations")
        r = out[name]
        print(f"[timing] {KERNEL_INFO[name]['id']} {name} at B={b} G={g} "
              f"d={d} T={t}: kernel {r['ms']:.4f} ms (lone call "
              f"{r['lone_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes} bytes -> "
              f"{by_bytes:.4f} ms; {nops} ops -> {by_ops:.4f} ms), "
              f"{r['bound_ms'] / r['ms']:.1%} of bound"
              + (f"; rank pairs on this data {pairs}"
                 if name == "cascade_filter" else "")
              + was_note(name, tuple(shape), r))
    if "cascade_filter" in out:
        out["cascade_filter"]["pairs"] = pairs
    for k6, other in (("cascade_score", "cascade_score_batched"),
                      ("cascade_score_bwd", "cascade_score_batched_bwd")):
        if k6 in out and other in out:
            ratio = out[k6]["ms"] / out[other]["ms"]
            print(f"[timing] vmapped {KERNEL_INFO[k6]['id']} / "
                  f"{KERNEL_INFO[other]['id']} at B={b} G={g}: {ratio:.3f} "
                  f"(bar {VMAP_RATIO_BAR}: "
                  f"{'met' if ratio <= VMAP_RATIO_BAR else 'MISSED'})")
    return out


def phase_timing() -> tuple[dict[str, dict], dict[str, dict], dict]:
    """The five batched kernels at the timing and training shapes, and K1
    and K2 also at the serving session's largest bucket batch."""
    big = time_shape(TIMING_SHAPE, seed=7)
    b, g, _, t = TIMING_SHAPE
    all_pairs = b * g * g * t
    print(f"[timing] cascade_filter rank compares: {big['cascade_filter']['pairs']}"
          f" on this data, {all_pairs} for all G^2*T pairs "
          f"({all_pairs / F32_OPS_PER_S * 1e3:.4f} ms at one op each)")
    train = time_shape(TRAIN_SHAPE, seed=8)
    serve = time_shape(SERVE_SHAPE, seed=9,
                       names=("cascade_score_batched", "cascade_filter"))
    return big, train, serve


def single_costs(n, d, t) -> dict[str, tuple[int, int]]:
    """(bytes, operations) of K6, its backward, K7 and K1 at B=1 on one
    group of N items (float32; inputs read once, outputs written once)."""
    f = 4
    fwd = (f * (n * d + t * d + t + n * t), 2 * n * t * d)
    return {"cascade_score": fwd, "cascade_score_fm": fwd,
            "cascade_score_batched": fwd,
            "cascade_score_bwd": (f * (2 * n * d + n * t + 2 * (t * d + t)),
                                  6 * n * t * d)}


def time_single(n, d=24, t=3) -> dict[str, dict]:
    """K6, K6's backward and K7 beside their plain versions and K1 at B=1 on
    the same items, on one group of n items. Past N = 64 the inputs rotate
    through enough copies that back-to-back calls read them from device
    memory, not from the L2."""
    copies = (1 if n == VMAP_GROUP_N
              else max(1, -(-3 * L2_BYTES // (n * d * 4))))
    cases = []
    for i in range(copies):
        x, w, zq, g = single_case(n, d, t, seed=100 + i, zero_tail=False)
        cases.append((x, x.T.contiguous(), g))
    calls = {
        "cascade_score": (
            lambda x, xt, g: score_kernel.cascade_score(x, w, zq),
            lambda x, xt, g: ops.cascade_score_ref(x, w, zq)),
        "cascade_score_bwd": (
            lambda x, xt, g: score_kernel.cascade_score_bwd(x, w, zq, g),
            lambda x, xt, g: ops.cascade_score_bwd_ref(x, w, zq, g)),
        "cascade_score_fm": (
            lambda x, xt, g: score_kernel.cascade_score_fm(xt, w, zq),
            lambda x, xt, g: ops.cascade_score_ref(xt.T, w, zq)),
        "cascade_score_batched": (
            lambda x, xt, g: score_kernel.cascade_score_batched(
                x[None], w, zq[None]),
            lambda x, xt, g: ops.cascade_score_batched_ref(
                x[None], w, zq[None])),
    }
    costs = single_costs(n, d, t)
    out = {}
    for name, (kern_fn, plain_fn) in calls.items():
        kern, lone = time_ms(rotate(kern_fn, cases))
        plain, _ = time_ms(rotate(plain_fn, cases), reps=5, calls=5)
        nbytes, nops = costs[name]
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / F32_OPS_PER_S * 1e3
        out[name] = r = dict(
            ms=kern, lone_ms=lone, plain_ms=plain, bytes=nbytes, ops=nops,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations")
        label = ("K1 cascade_score_batched at B=1" if
                 name == "cascade_score_batched" else
                 f"{KERNEL_INFO[name]['id']} {name}")
        print(f"[timing] {label} at N={n} d={d} T={t} ({copies} input "
              f"copies): kernel {r['ms']:.4f} ms (lone call "
              f"{r['lone_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes} "
              f"bytes -> {by_bytes:.4f} ms; {nops} ops -> {by_ops:.4f} "
              f"ms), {r['bound_ms'] / r['ms']:.1%} of bound"
              + (was_note(name, "b1", r) if n == max(SINGLE_TIMING_N)
                 else ""))
    print(f"[timing] N={n}: K7 / K6 device time "
          f"{out['cascade_score_fm']['ms'] / out['cascade_score']['ms']:.3f}, "
          f"K6 / K1 at B=1 "
          f"{out['cascade_score']['ms'] / out['cascade_score_batched']['ms']:.3f}")
    return out


def phase_single_timing() -> dict[int, dict[str, dict]]:
    """`time_single` at each N of SINGLE_TIMING_N (d=24, T=3)."""
    return {n: time_single(n) for n in SINGLE_TIMING_N}


def time_vmap_call(shape, seed) -> dict[str, float]:
    """The vmapped single-group op as a caller runs it, at (B, G, d, T):
    `vmap_score` forward, and forward plus backward (torch.autograd.grad in
    w_eff and zq). Device ms per call (with the host's gaps where the host
    is slower than the card) and a lone call's ms."""
    b, g, d, t = shape
    x, w, zq, _, _ = make_case(b, g, d, t, seed=seed)
    w.requires_grad_(True)
    zq.requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return vmap_score(x, w, zq)

    def fwd_bwd():
        return torch.autograd.grad(vmap_score(x, w, zq).sum(), (w, zq))
    out = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        out[f"{name}_ms"], out[f"{name}_lone_ms"] = time_ms(fn, reps=10)
    print(f"[timing] vmap of the single-group op at B={b} G={g} d={d} T={t}: "
          f"forward {out['fwd_ms']:.4f} ms (lone call "
          f"{out['fwd_lone_ms']:.4f} ms), forward + backward "
          f"{out['fwd_bwd_ms']:.4f} ms (lone call {out['fwd_bwd_lone_ms']:.4f}"
          " ms)")
    return out


# -- 5. training ------------------------------------------------------------------

def fit_once(fit_fn, device, **kw) -> tuple[dict, list, float, dict]:
    """One fit on `device` with its launch counts taken from 0:
    (params, losses, seconds, launches)."""
    losses = []
    ops.reset_launch_counts()        # this training path starts here
    t0 = time.perf_counter()
    params, cfg = fit_fn(callback=lambda s, v: losses.append(v),
                         device=device, **kw)
    if device == "cuda":
        sync()
    seconds = time.perf_counter() - t0
    return params, losses, seconds, ops.launch_counts()   # ... ends here


def phase_train(tr, te) -> tuple[dict, dict[str, int], list]:
    """Both training paths on the card, held to their launch counts, to
    themselves (byte-equal) and to the same fit on the CPU. Returns the
    L3 params, each kernel's launches on its path and the L3 fit's loss
    trajectory."""
    steps_per_epoch, _ = T.epoch_steps(tr.x.shape[0], 64)
    steps = FIT_EPOCHS * steps_per_epoch
    lcfg = L.LossConfig(beta=FIT_BETA)
    paths = {
        "l3": (lambda **kw: B.fit_cloes(
            tr, lcfg=lcfg, tcfg=T.TrainConfig(
                loss="l3", epochs=FIT_EPOCHS, lr=FIT_LR, log_every=1), **kw),
            ("cascade_loss", "cascade_loss_bwd")),
        "l1": (lambda **kw: B.fit_soft_cascade(
            tr, tcfg=T.TrainConfig(loss="l1", epochs=FIT_EPOCHS, lr=FIT_LR,
                                   log_every=1), **kw),
            ("cascade_score_batched", "cascade_score_batched_bwd")),
    }
    launches, trained = {}, None
    for name, (fit_fn, kernels) in paths.items():
        p1, losses1, s1, counts = fit_once(fit_fn, "cuda")
        p2, losses2, s2, _ = fit_once(fit_fn, "cuda")
        pc, losses_c, sc, _ = fit_once(fit_fn, "cpu")
        assert len(losses1) == steps, (len(losses1), steps)
        for k in kernels:
            assert counts[k] == steps, (name, counts)
            launches[k] = counts[k]
        assert sum(v for k, v in counts.items() if k not in kernels) == 0, \
            (name, counts)
        assert losses1 == losses2, f"{name}: two fits' losses differ"
        for k in p1:
            assert torch.equal(p1[k], p2[k]), f"{name}: two fits differ in {k}"
        np.testing.assert_allclose(losses1, losses_c, rtol=FIT_RTOL,
                                   atol=FIT_ATOL)
        dev = {k: float((p1[k].cpu() - pc[k]).abs().max()) for k in p1}
        for k in p1:
            np.testing.assert_allclose(p1[k].cpu().numpy(), pc[k].numpy(),
                                       rtol=FIT_RTOL, atol=FIT_ATOL)
        cfg = cloes.CASCADE
        m_card = T.evaluate(p1, cfg, te, lcfg)
        m_cpu = T.evaluate(pc, cfg, te, lcfg)
        for k in m_cpu:
            np.testing.assert_allclose(m_card[k], m_cpu[k], rtol=FIT_RTOL,
                                       atol=FIT_ATOL, err_msg=k)
        loss_err = max(abs(a - c) for a, c in zip(losses1, losses_c))
        metric_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                         for k in m_cpu)
        print(f"[train {name}] {steps} steps ({FIT_EPOCHS} epochs x "
              f"{steps_per_epoch}) on the card: first fit {s1:.3f} s, second "
              f"{s2:.3f} s ({steps / s2:.1f} steps/s, {s2 / FIT_EPOCHS:.4f} "
              f"s/epoch); CPU {sc:.3f} s; launches {counts}")
        print(f"[train {name}] two card fits byte-equal; against the CPU fit: "
              f"max |loss err| {loss_err:.3g}, max |param err| {dev}, max "
              f"relative metric err {metric_err:.3g}; loss "
              f"{losses1[0]:.4f} -> {losses1[-1]:.4f}; test metrics on the "
              f"card {json.dumps(m_card)}")
        if name == "l3":
            trained, trained_losses = p1, losses1
            profile_fit(fit_fn, steps)
    return trained, launches, trained_losses


def profile_fit(fit_fn, steps, label="l3") -> None:
    """One more L3 fit under torch.profiler: where a training step's time
    goes (the profiler's overhead inflates the fit's wall time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, seconds, _ = fit_once(fit_fn, "cuda")
    summary = S.profile_summary(prof, seconds, top=10)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    print(f"[train {label}] profiled fit: {seconds:.4f} s, device busy "
          f"{summary['device_busy_ms']:.3f} ms (idle share "
          f"{summary['device_idle_share']:.4f}), {launches} cudaLaunchKernel "
          f"({launches / steps:.1f} per step)")
    for op in summary["device_ops"]:
        print(f"[train {label}]   device {op['self_device_ms']:8.3f} ms "
              f"x{op['count']:<6d} {op['name']}")
    for op in summary["top_host_ops"]:
        print(f"[train {label}]   host {op['self_cpu_ms']:8.3f} ms "
              f"x{op['count']:<6d} {op['name']}")


def vmap_score(x, w_eff, zq):
    """The reference's `jax.vmap` of its single-group op over query groups
    (its losses' and benches' vmap path): one K6 launch for the batch."""
    return torch.func.vmap(
        lambda xb, zb: ops.cascade_score(xb, w_eff, zb))(x, zq)


def phase_train_k6(tr, default_params, default_losses) -> dict[str, int]:
    """L3 through the losses' score_fn seam with the vmapped single-group
    op: K6 forward and backward once per step for lp and once for the
    penalty variant lp_pen (one launch each for the minibatch's 64 groups),
    nothing else launched; two card fits byte-equal; the same fit on the
    CPU and the card's default K4 + K5 fit (the same objective) within
    1e-4. Returns the launches of the first card fit."""
    steps_per_epoch, _ = T.epoch_steps(tr.x.shape[0], 64)
    steps = FIT_EPOCHS * steps_per_epoch
    kernels = ("cascade_score", "cascade_score_bwd")

    def fit_fn(**kw):
        return B.fit_cloes(
            tr, lcfg=L.LossConfig(beta=FIT_BETA),
            tcfg=T.TrainConfig(loss="l3", epochs=FIT_EPOCHS, lr=FIT_LR,
                               log_every=1),
            loss_fn=functools.partial(L.loss_l3, score_fn=vmap_score), **kw)

    p1, losses1, s1, counts = fit_once(fit_fn, "cuda")
    p2, losses2, s2, _ = fit_once(fit_fn, "cuda")
    pc, losses_c, sc, _ = fit_once(fit_fn, "cpu")
    assert len(losses1) == steps, (len(losses1), steps)
    for k in kernels:              # lp and lp_pen: one call per step each
        assert counts[k] == 2 * steps, counts
    assert sum(v for k, v in counts.items() if k not in kernels) == 0, counts
    assert losses1 == losses2, "K6 fit: two fits' losses differ"
    for k in p1:
        assert torch.equal(p1[k], p2[k]), f"K6 fit: two fits differ in {k}"
    errs = {}
    for other, (params, losses) in {
            "the CPU fit": (pc, losses_c),
            "the default K4 + K5 fit": (default_params, default_losses)
    }.items():
        np.testing.assert_allclose(losses1, losses, rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=other)
        for k in p1:
            np.testing.assert_allclose(
                p1[k].cpu().numpy(), params[k].cpu().numpy(), rtol=FIT_RTOL,
                atol=FIT_ATOL, err_msg=f"{other}: {k}")
        errs[other] = (max(abs(a - c) for a, c in zip(losses1, losses)),
                       max(float((p1[k].cpu() - params[k].cpu()).abs().max())
                           for k in p1))
    print(f"[train l3 via K6] {steps} steps through vmap of the single-group "
          f"op on the card: first fit {s1:.3f} s, second {s2:.3f} s "
          f"({steps / s2:.1f} steps/s); CPU {sc:.3f} s; launches {counts} "
          f"({counts['cascade_score'] / steps:.0f} K6 + "
          f"{counts['cascade_score_bwd'] / steps:.0f} K6 bwd per step; "
          f"{counts['cascade_score']} + {counts['cascade_score_bwd']} per "
          "fit)")
    print(f"[train l3 via K6] two card fits byte-equal; max |loss err|, max "
          f"|param err| against " + "; ".join(
              f"{k} {a:.3g}, {b:.3g}" for k, (a, b) in errs.items()))
    profile_fit(fit_fn, steps, label="l3 via K6")
    return counts


def l3_fit_fn(tr, epochs=FIT_EPOCHS):
    """phase_train's L3 fit (the serve launcher's settings), `epochs`
    long; a checkpoint every epoch when given a directory."""
    return lambda **kw: B.fit_cloes(
        tr, lcfg=L.LossConfig(beta=FIT_BETA),
        tcfg=T.TrainConfig(loss="l3", epochs=epochs, lr=FIT_LR, log_every=1,
                           checkpoint_every=1), **kw)


def run_launcher(module, args, timeout) -> subprocess.CompletedProcess:
    """`python -m module args` from this checkout, with a time limit."""
    src = os.environ.get("CHIP_SMOKE_SRC") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src")
    return subprocess.run([sys.executable, "-m", module, *args],
                          env=dict(os.environ, PYTHONPATH=src),
                          capture_output=True, text=True, timeout=timeout)


def phase_train_restart(tr, params, losses, tmp) -> dict:
    """Crash-safe training on the card: phase_train's L3 fit checkpointed
    for 2 of FIT_EPOCHS epochs, then resumed to FIT_EPOCHS — params and
    the resumed epochs' losses byte-equal to phase_train's uninterrupted
    card fit, K4 = K5 = the steps run after the restore (counts set to 0
    before the resumed fit, read after it); the CheckpointStore's save and
    load (to the card) times for the CLOES state. Then the launcher in
    subprocesses on the card: --crash-after-epoch 2 returns 9, --resume
    prints the digest of the same run made here without a crash."""
    steps_per_epoch, _ = T.epoch_steps(tr.x.shape[0], 64)
    ckpt = os.path.join(tmp, "fit")
    l3_fit_fn(tr, epochs=2)(checkpoint_dir=ckpt, device="cuda")
    info: dict = {}
    resumed = []
    ops.reset_launch_counts()        # the resumed path starts here
    t0 = time.perf_counter()
    p, _ = l3_fit_fn(tr)(checkpoint_dir=ckpt, resume=True, train_info=info,
                         callback=lambda s, v: resumed.append(v),
                         device="cuda")
    sync()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()     # ... and ends here
    steps = (FIT_EPOCHS - 2) * steps_per_epoch
    assert info == {"restored_epoch": 2, "epochs_run": FIT_EPOCHS - 2}, info
    assert counts["cascade_loss"] == counts["cascade_loss_bwd"] == steps, \
        counts
    assert sum(counts.values()) == 2 * steps, counts
    assert resumed == losses[2 * steps_per_epoch:], \
        "resumed losses differ from the uninterrupted fit's"
    for k in params:
        assert torch.equal(p[k], params[k]), f"resumed fit differs in {k}"

    store = CheckpointStore(os.path.join(tmp, "timing"), keep=1)
    _, state, meta = CheckpointStore(ckpt).load_latest()
    state["theta"] = torch.tensor(state["theta"], device="cuda")
    state["opt_state"]["mu"] = torch.tensor(state["opt_state"]["mu"],
                                            device="cuda")
    nbytes = state["theta"].numel() * 4
    save_ms = host_ms(lambda: store.save(1, state, meta=meta), calls=20)

    def load_to_card():
        _, st, _ = store.load_latest()
        torch.tensor(st["theta"], device="cuda")
        torch.tensor(st["opt_state"]["mu"], device="cuda")
    load_ms = host_ms(load_to_card, calls=20)
    print(f"[train restart] fit checkpointed at epoch 2, resumed to "
          f"{FIT_EPOCHS} on the card: {steps} steps in {seconds:.4f} s "
          f"({steps / seconds:.1f} steps/s); K4 x "
          f"{counts['cascade_loss']}, K5 x {counts['cascade_loss_bwd']}; "
          "params and losses byte-equal to the uninterrupted card fit")
    print(f"[train restart] CheckpointStore for the CLOES state ({nbytes} "
          f"bytes of theta, as many of momentum): save from the card "
          f"{save_ms:.3f} ms, load to the card {load_ms:.3f} ms (20 back to "
          "back, host clock, fsync included)")

    args = ["--device", "cuda", "--queries", "300", "--epochs", "4",
            "--batch-groups", "16"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        TLT.main(args)
    want = re.search(r"sha256=[0-9a-f]{64}", out.getvalue()).group(0)
    launcher_ckpt = ["--checkpoint-dir", os.path.join(tmp, "launcher")]
    crash = run_launcher("repro_torch.launch.train",
                         args + launcher_ckpt + ["--crash-after-epoch", "2"],
                         timeout=180)
    assert crash.returncode == T.CRASH_EXIT_CODE == 9, \
        (crash.returncode, crash.stderr[-2000:])
    res = run_launcher("repro_torch.launch.train",
                       args + launcher_ckpt + ["--resume"], timeout=180)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "(restored_epoch=2 epochs_run=2)" in res.stdout, res.stdout
    got = re.search(r"sha256=[0-9a-f]{64}", res.stdout).group(0)
    assert got == want, (got, want)
    print(f"[train restart] launcher on the card: --crash-after-epoch 2 "
          f"exited {crash.returncode}; --resume restored epoch 2 and printed "
          f"{got}, the uninterrupted run's")
    return dict(launches=counts, steps_per_s=steps / seconds,
                save_ms=save_ms, load_ms=load_ms)


def phase_train_dp(tr, params, losses, tmp) -> dict[str, int]:
    """The data-parallel fit on a one-rank NCCL group: phase_train's L3
    fit through fit(mesh=) byte-equal to the fit without a mesh, K4 = K5
    = its steps. data_parallel_mesh is None at a world of one, as the
    launcher's one-process fallback needs."""
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                            world_size=1)
    try:
        assert data_parallel_mesh(64, "cuda") is None
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
        p, got, seconds, counts = fit_once(l3_fit_fn(tr), "cuda", mesh=mesh)
    finally:
        dist.destroy_process_group()
    steps = len(losses)
    assert counts["cascade_loss"] == counts["cascade_loss_bwd"] == steps, \
        counts
    assert got == losses, "the one-rank mesh's losses differ"
    for k in params:
        assert torch.equal(p[k], params[k]), f"the one-rank mesh differs in {k}"
    print(f"[train dp] fit(mesh=) on a one-rank NCCL group: {steps} steps in "
          f"{seconds:.4f} s, K4 x {counts['cascade_loss']}, K5 x "
          f"{counts['cascade_loss_bwd']}, byte-equal to the fit without a "
          "mesh")
    return counts


def phase_train_lm() -> dict:
    """The launcher's --target lm on the card: LM_TRAIN_STEPS Adam steps of
    LM_TRAIN_ARCH at its published widths and LM_TRAIN_LAYERS layers (the
    weights drawn on the CPU from the seed, so both devices start alike),
    finite losses within LM_TRAIN_RTOL of the same steps on the CPU. The
    same steps with the weights rounded to bfloat16 (on the card, the
    launcher's batches) must differ from the card's by more than the bar."""
    args = ["--target", "lm", "--arch", LM_TRAIN_ARCH, "--layers",
            str(LM_TRAIN_LAYERS), "--steps", str(LM_TRAIN_STEPS), "--batch",
            str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ)]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        card = TLT.main(args + ["--device", "cuda"])
        sync()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        cpu = TLT.main(args + ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
    head = out.getvalue().splitlines()[0]
    assert f"{LM_TRAIN_LAYERS} layers" in head, head
    assert len(card) == LM_TRAIN_STEPS and np.isfinite(card).all(), card
    np.testing.assert_allclose(card, cpu, rtol=LM_TRAIN_RTOL)
    err = max(abs(a - c) / abs(c) for a, c in zip(card, cpu))

    cfg = dataclasses.replace(CFG.get(LM_TRAIN_ARCH),
                              n_layers=LM_TRAIN_LAYERS)
    need = train_need(dataclasses.replace(cfg, dtype=torch.float32),
                      LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    params = MB.tree_map(
        lambda p: p.to("cuda", torch.bfloat16),
        MB.materialize(Z.templates(cfg), torch.Generator().manual_seed(0)))
    opt = adam(0.01)                       # the launcher's defaults
    opt_state, rng, bf16 = opt.init(params), np.random.default_rng(0), []
    for _ in range(LM_TRAIN_STEPS):
        batch = TLT.lm_batch(cfg, rng, LM_TRAIN_BATCH, LM_TRAIN_SEQ, "cuda")
        params, opt_state, loss = Z.train_step(params, opt_state, batch, cfg,
                                               opt.update)
        bf16.append(float(loss))
    del params, opt_state
    free_cuda()
    bf16_err = max(abs(a - c) / abs(c) for a, c in zip(bf16, card))
    assert bf16_err > LM_TRAIN_RTOL, (bf16, card)
    print(f"[train lm] {head.removeprefix('[train] ')}: "
          f"{seconds:.2f} s on the card (first-call work included), "
          f"{cpu_s:.2f} s on the CPU; losses {[round(v, 4) for v in card]}, "
          f"max relative err against the CPU {err:.3g} (bar {LM_TRAIN_RTOL});"
          f" the same steps in bfloat16 {bf16_err:.3g} from the card's")
    print(f"[train lm] peak memory on the card {peak} bytes; the cost "
          f"report's argument + temp for one step {need} bytes "
          f"({peak / need:.3f} of it)")
    return dict(losses=card, max_rel_err=err, bf16_err=bf16_err,
                peak_bytes=peak, report_bytes=need)


def train_need(cfg, b: int, s: int, enc_len: int = 0) -> int:
    """The cost report's argument + peak temp bytes of one train step
    (`zoo.train_step` with Adam) of cfg at b x s: what the card must hold
    for it."""
    DR, _ = cost_report()
    mem = DR.step_record(cfg, "train", batch=b, seq_len=s,
                         enc_len=enc_len)["memory"]
    return mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


class Tally:
    """Counts and times calls of a session's seams (rank_batch,
    execute_chunk) from any thread: the pump thread, router probes made in
    submitter threads and the DES all call them. `longest` keeps each
    seam's slowest call, so a latency tail can be told apart from a slow
    execute."""

    def __init__(self):
        self.lock = threading.Lock()
        self.calls = collections.Counter()
        self.seconds = collections.Counter()
        self.longest = collections.Counter()

    def wrap(self, ses, name: str) -> None:
        fn = getattr(ses, name)

        def counted(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    self.calls[name] += 1
                    self.seconds[name] += dt
                    self.longest[name] = max(self.longest[name], dt)
        setattr(ses, name, counted)


# -- 6. serving -------------------------------------------------------------------
def check_responses(reqs, futures, params, cfg, ses, neural=None) -> int:
    """Every served, undegraded response against the plain pipeline on the
    CPU for that request alone (plus the same neural scorer on the CPU,
    when the session has one): scores to tolerance, survivors exactly
    where the request's decisions have margin, order a stable descending
    sort of the scores. Returns how many were checked."""
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu_neural = None if neural is None else dataclasses.replace(
        neural, params=MB.tree_map(lambda a: a.cpu(), neural.params),
        head=neural.head.cpu())
    checked = 0
    for req, fut in zip(reqs, futures):
        r = fut.result()
        if r.status != "ok" or r.degraded:
            continue
        g = bucket_of(len(req.item_feats), ses.buckets)
        batch = alloc_batch(1, g, cfg.d_x, cfg.d_q)
        pack_into(batch, [req], g)
        t = {k: torch.tensor(v) for k, v in batch.items()}
        out = P.run_cascade(cpu_params, cfg, t["x"], t["q"], t["mask"],
                            t["m_q"], fused="none")
        n = len(r.scores)
        surv = out["survivors"][0, :n, -1] > 0
        scores = out["scores"][0, :n]
        if cpu_neural is not None:
            scores = scores + cpu_neural.score(t["x"][0, :n])
        want = torch.where(surv, scores, -torch.inf).numpy()
        np.testing.assert_allclose(r.scores, want, rtol=RTOL, atol=ATOL)
        try:
            assert_decision_margin(out["lp"], t["mask"], t["m_q"])
        except AssertionError:
            continue
        np.testing.assert_array_equal(r.survivors, surv.numpy())
        ranked = r.scores[r.order]
        kept = np.isfinite(ranked)
        assert kept[:kept.sum()].all() and (np.diff(ranked[kept]) <= 0).all()
        checked += 1
    return checked


def phase_slice(plan: str, params, te, neural=None) -> tuple[dict, dict]:
    cfg = cloes.CASCADE
    ses = S.build_session(params, cfg, neural=neural, plan=plan,
                          device="cuda")
    label = plan if neural is None else f"{plan} + neural {neural.cfg.name}"
    tally = Tally()
    tally.wrap(ses, "execute_chunk")
    reqs = S.make_requests(te, DES_REQUESTS, seed=0)

    ops.reset_launch_counts()        # the main path starts here
    t0 = time.perf_counter()
    shapes = ses.warmup()
    warmup_s = time.perf_counter() - t0
    warm_launches = ops.launch_counts()
    shapes_after_warmup = S.compiled_count([ses])
    res = run_open_loop(ses, reqs, DES_QPS, deadline_ms=DES_DEADLINE_MS,
                        seed=0)
    sync()
    launches = ops.launch_counts()   # ... and ends here
    st = ses.stats_export()
    new_shapes = S.compiled_count([ses]) - shapes_after_warmup

    kernel = "cascade_filter" if plan == "filter" else "cascade_score_batched"
    serve_launches = launches[kernel] - warm_launches[kernel]
    chunks = tally.calls["execute_chunk"]
    assert res.unresolved == 0, f"{res.unresolved} futures unresolved"
    assert all(f.done() for f in res.futures)
    assert st["submitted"] == st["completed"] + st["shed"] + st["errors"], st
    assert st["faults"] == 0 and st["errors"] == 0, \
        f"plan {plan}: faults {st['faults']} errors {st['errors']}"
    assert new_shapes == 0, f"{new_shapes} shapes first seen after warmup"
    assert warm_launches[kernel] >= len(shapes), warm_launches
    assert serve_launches >= chunks > 0, (serve_launches, chunks)
    # zq: one query_bias launch per pipeline run, beside the plan's kernel
    assert launches["query_bias"] == launches[kernel], launches
    if neural is not None:
        assert res.completed == res.n_requests and res.shed == 0, \
            f"{label}: served {res.completed}, shed {res.shed}"
        assert ses.warmup_manifest()["degraded_pipeline"]
    checked = check_responses(reqs, res.futures, params, cfg, ses, neural)
    assert checked > 0
    print(f"[slice {label}] warmed {len(shapes)} shapes in {warmup_s:.2f}s; "
          f"served {res.completed}/{res.n_requests} (shed {res.shed}, "
          f"errors {res.errors}, degraded {res.degraded}, deadline-missed "
          f"{res.deadline_missed}) in {chunks} chunks; "
          f"{res.achieved_qps:.1f} QPS achieved over {res.sim_s:.3f}s "
          f"simulated, {res.serve_s:.4f}s compute "
          f"({1e3 * res.serve_s / max(chunks, 1):.4f} ms/chunk)")
    print(f"[slice {label}] latency p50 {res.pct(50):.3f} ms, p95 "
          f"{res.pct(95):.3f} ms, p99 {res.pct(99):.3f} ms; "
          f"recompiles after warmup: {new_shapes}; launches {launches} "
          f"(warmup {warm_launches}); {checked} responses match the plain "
          f"pipeline{'' if neural is None else ' and scorer'} on the CPU")
    return launches, res.summary()


def phase_serve_k6(params, te) -> dict[str, int]:
    """The reference's vmap serving pipeline (`_vmap_score_pipeline` of its
    serving bench), built from the port's pieces, on one batch of each warm
    bucket shape of test-split requests, against plan "score" (K1): lp
    within 1e-5, survivors exactly where the decisions have margin, the
    latency estimate within 1e-5. Returns the launches."""
    cfg, lcfg = cloes.CASCADE, L.LossConfig()
    w_eff = (params["w_x"] * C.masks_tensor(cfg, "cuda")).contiguous()
    reqs = iter(S.make_requests(te, len(WARM_G) * sum(WARM_B), seed=1))
    worst, bit_equal, with_margin, batches = 0.0, 0, 0, 0
    ops.reset_launch_counts()              # this path starts here
    for g in WARM_G:
        for b in WARM_B:
            batch = alloc_batch(b, g, cfg.d_x, cfg.d_q)
            pack_into(batch, [next(reqs) for _ in range(b)], g)
            x, q, mask, m_q = (torch.tensor(batch[k], device="cuda")
                               for k in ("x", "q", "mask", "m_q"))
            zq = (q @ params["w_q"].T + params["b"]).contiguous()
            lp = vmap_score(x, w_eff, zq)
            counts, n_keep = P.keep_counts_from_lp(lp, mask, m_q)
            surv = P.filter_chain(lp, mask, n_keep)
            lat = P.latency_from_counts(counts, m_q, cfg, lcfg.latency_scale,
                                        lcfg.latency_convention)
            want = P.run_cascade(params, cfg, x, q, mask, m_q, fused="score")
            lat_want = P.latency_from_counts(
                want["expected_counts"], m_q, cfg, lcfg.latency_scale,
                lcfg.latency_convention)
            sync()
            label = f"vmap pipeline b={b} g={g}"
            torch.testing.assert_close(lp, want["lp"], rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{label} lp: {m}")
            torch.testing.assert_close(lat, lat_want, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{label} latency: {m}")
            worst = max(worst, float((lp - want["lp"]).abs().max()))
            bit_equal += torch.equal(lp, want["lp"])
            batches += 1
            try:
                assert_decision_margin(want["lp"], mask, m_q)
            except AssertionError:
                continue
            assert torch.equal(surv, want["survivors"]), label
            assert torch.equal(n_keep, want["n_keep"]), label
            with_margin += 1
    sync()
    launches = ops.launch_counts()         # ... and ends here
    assert launches["cascade_score"] == batches, launches   # one per batch
    assert launches["cascade_score_batched"] == batches, launches
    assert with_margin > 0
    assert bit_equal == batches, (
        f"K1 bit-equal to vmap of K6 in {bit_equal} of {batches} batches")
    print(f"[slice vmap K6] {batches} batches (B in {WARM_B}, G in {WARM_G}):"
          f" lp against plan \"score\" max |err| {worst:.3g}, bit-equal in "
          f"{bit_equal} of {batches}; survivors and n_keep exact in the "
          f"{with_margin} batches with decision margin; launches {launches}")
    return launches


def phase_fm_scoring(params, te) -> dict[str, int]:
    """Every query group of the test split scored with the trained cascade
    feature-major (K7, the layout the reference's serving store keeps) and
    item-major (K6): the same values. Returns K7's launches."""
    cfg = cloes.CASCADE
    w_eff = (params["w_x"] * C.masks_tensor(cfg, "cuda")).contiguous()
    x = torch.tensor(te.x, dtype=torch.float32, device="cuda")
    q = torch.tensor(te.q, dtype=torch.float32, device="cuda")
    zq = (q @ params["w_q"].T + params["b"]).contiguous()
    xt = x.transpose(1, 2).contiguous()          # (queries, d, G)
    ops.reset_launch_counts()              # this path starts here
    fm = torch.stack([ops.cascade_score_fm(xt[i], w_eff, zq[i])
                      for i in range(len(x))])
    sync()
    launches = ops.launch_counts()         # ... and ends here
    im = torch.stack([ops.cascade_score(x[i], w_eff, zq[i])
                      for i in range(len(x))])
    sync()
    torch.testing.assert_close(fm, im, rtol=RTOL, atol=ATOL,
                               msg=lambda m: f"K7 scoring vs K6: {m}")
    assert launches["cascade_score_fm"] == len(x), launches
    print(f"[score fm] {len(x)} test-split groups of {x.shape[1]} items "
          f"scored feature-major (K7 x {launches['cascade_score_fm']}) and "
          f"item-major (K6): max |err| {float((fm - im).abs().max()):.3g}, "
          f"bit-equal {torch.equal(fm, im)}")
    return launches


# -- 6b. wall-clock pump, replica router, replica streams, shim ------------------

def in_request_order(reqs, futures) -> list:
    """The futures of a wall-clock run (grouped by submitter thread) in
    the order of `reqs`, as check_responses takes them."""
    by_id = {f.request_id: f for f in futures}
    return [by_id[r.request_id] for r in reqs]


def wall_summary(res) -> str:
    return (f"p50 {res.pct(50):.3f} ms, p95 {res.pct(95):.3f} ms, p99 "
            f"{res.pct(99):.3f} ms; {res.achieved_qps:.1f} QPS achieved of "
            f"{res.offered_qps:.0f} offered in {res.wall_s:.3f}s wall; "
            f"served {res.completed}/{res.n_requests}, shed {res.shed}, "
            f"errors {res.errors}, degraded {res.degraded}, deadline-missed "
            f"{res.deadline_missed}")


def check_injected_errors(futures, injectors) -> tuple[int, int]:
    """Every error response ends in one of the injector's own faults, and
    every poisoned request that was not shed is an error. Returns (errors,
    poisoned)."""
    errors = poisoned = 0
    for f in futures:
        r = f.result()
        if r.status == "error":
            errors += 1
            assert r.error.split(":")[0] in INJECTED_ERRORS, r.error
        if (r.status != "shed"
                and any(i.is_poisoned(r.request_id) for i in injectors)):
            poisoned += 1
            assert r.status == "error", (r.request_id, r.status)
    return errors, poisoned


def phase_pump(params, te, *, fault_rate=0.0, n_requests=DES_REQUESTS,
               label=None) -> dict:
    """The launcher's --pump path on the card: a SessionPump over the
    launcher's session (plan "filter", K2), 500 requests (`n_requests`) at
    400 QPS offered from 4 submitter threads, deadline 130 ms, with the
    launch counts set to 0 before warmup and read after the pump has
    closed. Without faults: no errors, cycle errors or restarts, K2
    launched once per pipeline run and at least once per executed chunk,
    the page-locked pool reusing its buffers, every served response
    against the plain pipeline on the CPU. With --faults: errors only from
    the injector."""
    cfg = cloes.CASCADE
    injector = S.build_injector(fault_rate, seed=0)
    ses = S.build_session(params, cfg, plan="filter", faults=injector,
                          device="cuda")
    label = label or ("pump filter" if injector is None else "pump faults")
    reqs = S.make_requests(te, n_requests, seed=0)
    ops.reset_launch_counts()        # the path starts here
    shapes = ses.warmup()
    warm = ops.launch_counts()
    shapes_after_warmup = S.compiled_count([ses])
    tally = Tally()
    tally.wrap(ses, "rank_batch")
    tally.wrap(ses, "execute_chunk")
    pump = SessionPump(ses).start()
    res = run_wall_clock(pump, reqs, DES_QPS, deadline_ms=DES_DEADLINE_MS,
                         n_threads=PUMP_THREADS, seed=0,
                         result_timeout_s=RESULT_TIMEOUT_S)
    pump.close(timeout=RESULT_TIMEOUT_S)
    sync()
    counts = ops.launch_counts()     # ... and ends here
    launches = counts["cascade_filter"] - warm["cascade_filter"]
    qb_launches = counts["query_bias"] - warm["query_bias"]
    assert not pump.running, f"{label}: the pump thread did not stop"
    pst = pump.stats_export()
    st = pst["session"]
    futures = in_request_order(reqs, res.futures)
    assert res.unresolved == 0 and all(f.done() for f in futures), \
        f"{label}: {res.unresolved} futures unresolved"
    assert st["submitted"] == st["completed"] + st["shed"] + st["errors"], st
    assert pst["cycle_errors"] == 0 and pst["restarts"] == 0, pst
    new_shapes = S.compiled_count([ses]) - shapes_after_warmup
    assert new_shapes == 0, f"{label}: {new_shapes} shapes after warmup"
    chunks, runs = tally.calls["execute_chunk"], tally.calls["rank_batch"]
    assert launches == qb_launches == runs, (launches, qb_launches, runs)
    pool = ses.pool.snapshot()
    assert ses.pool.pin, f"{label}: the session's pool is not page-locked"
    assert pool["reused"] > 0 and pool["allocated"] <= 4 * len(shapes), pool
    checked = check_responses(reqs, futures, params, cfg, ses)
    assert checked > 0
    if injector is None:
        assert st["faults"] == 0 and st["errors"] == 0, st
        assert launches >= chunks > 0, (launches, chunks)
        chaos = ""
    else:
        errors, poisoned = check_injected_errors(futures, [injector])
        inj = injector.snapshot()
        assert sum(inj.values()) > 0 and st["faults"] > 0, inj
        chaos = (f"; injected {inj}, {st['retries']} retries, {errors} "
                 f"errors (every one an injected fault), {poisoned} "
                 "poisoned requests all errors")
    per_cycle = 1e3 * tally.seconds["execute_chunk"] / max(chunks, 1)
    print(f"[{label}] {wall_summary(res)}; {pst['cycles']} cycles, "
          f"{pst['slot_joins']} slot joins, {chunks} chunks executed "
          f"({per_cycle:.4f} ms host each, pack to fetch; longest "
          f"{1e3 * tally.longest['execute_chunk']:.3f} ms), K2 x {launches} "
          f"(warmup {warm['cascade_filter']}), query_bias x {qb_launches}; "
          f"pool allocated {pool['allocated']} / reused "
          f"{pool['reused']} (page-locked); {checked} responses match the "
          f"plain pipeline on the CPU{chaos}")
    return dict(launches=launches, qb_launches=qb_launches,
                summary=res.summary(), cycles=pst["cycles"],
                slot_joins=pst["slot_joins"], chunks=chunks,
                ms_per_chunk=per_cycle, pool=pool)


def phase_router(params, te) -> dict:
    """--replicas 2 on the card: both replicas on the one card
    (`replica_devices`), each on its own stream (distinct, neither the
    default). The DES (`run_open_loop_router`) and the wall-clock run (one
    pump per replica, 4 submitter threads), each once plain and once with
    replica 0's executor forced dead (--kill-replica), each run as
    `router_run` checks it; each kill run's responses (adopted ones
    included) bit-equal to the same mode's run without the kill wherever
    both served the request whole. Then `[router adopt]`. Returns the K2
    launches and, under "plain", each mode's plain responses by request
    id."""
    reqs = S.make_requests(te, DES_REQUESTS, seed=0)
    out = {"launches": 0, "plain": {}}
    for mode in ("des", "pump"):
        plain_run = out["plain"][mode] = {}
        for kill in (False, True):
            run = router_run(params, reqs, mode, kill, plain_run)
            out["launches"] += run["launches"]
            out[run["label"]] = run["res"].summary()
    out["launches"] += phase_router_adopt(params, reqs, out["plain"]["des"])
    return out


def router_run(params, reqs, mode, kill, plain_run, label=None) -> dict:
    """One run of `phase_router`: every future resolved, the fleet
    identity, Σ adopted = Σ drained, failovers in a kill run, K2 and
    query_bias once per pipeline run on either replica (counts set to 0
    before the run's warmup and read after it), every served response
    against the plain pipeline on the CPU. A run without the kill records
    its whole, undegraded responses in `plain_run` (request id ->
    response); a kill run's are held to them bit for bit."""
    cfg = cloes.CASCADE
    label = label or f"router {mode}" + (" kill-replica" if kill else "")
    router = S.build_router(params, cfg, n=N_REPLICAS,
                            kill_replica=kill, device="cuda")
    reps = router.replicas
    streams = [r.stream for r in reps]
    default = torch.cuda.default_stream(reps[0].device)
    handles = {s.cuda_stream for s in streams if s is not None}
    assert len(handles) == N_REPLICAS and \
        default.cuda_stream not in handles, (streams, default)
    ops.reset_launch_counts()        # this run starts here
    shapes = router.warmup()
    warm_counts = ops.launch_counts()
    warm = warm_counts["cascade_filter"]
    tally = Tally()
    for r in reps:
        tally.wrap(r, "rank_batch")
        tally.wrap(r, "execute_chunk")
    if mode == "des":
        res = run_open_loop_router(router, reqs, DES_QPS,
                                   deadline_ms=DES_DEADLINE_MS, seed=0)
        router.close()
    else:
        router.attach_pumps([
            SessionPump(r, name=f"pump-{r.name}").start() for r in reps])
        res = run_wall_clock(router, reqs, DES_QPS,
                             deadline_ms=DES_DEADLINE_MS,
                             n_threads=PUMP_THREADS, seed=0,
                             result_timeout_s=RESULT_TIMEOUT_S)
        router.close(timeout=RESULT_TIMEOUT_S)
        assert not any(p.running for p in router.pumps), label
    sync()
    counts = ops.launch_counts()
    launches = counts["cascade_filter"] - warm
    qb_launches = counts["query_bias"] - warm_counts["query_bias"]
    st = router.stats_export()
    per = [p.get("session", p) for p in st["replicas"]]
    g = st["global"]
    futures = in_request_order(reqs, res.futures)
    assert res.unresolved == 0 and all(f.done() for f in futures), \
        f"{label}: unresolved futures"
    assert g["submitted"] == g["completed"] + g["shed"] \
        + g["errors"], g
    assert g["pending"] == 0 and g["inflight"] == 0, g
    assert g["adopted"] == g["drained"], g
    assert launches == qb_launches == tally.calls["rank_batch"] > 0, \
        (launches, qb_launches, tally.calls)
    if mode == "pump":
        for p in st["replicas"]:
            assert p["cycle_errors"] == 0 and p["restarts"] == 0, p
    if kill:
        assert st["failovers"] >= 1 and st["failed"] == [0], st
    else:
        assert st["failovers"] == 0 and g["errors"] == 0 \
            and g["faults"] == 0, st
        assert all(p["submitted"] > 0 for p in per), per
    checked = check_responses(reqs, futures, params, cfg, reps[0])
    assert checked > 0
    # failover changes placement and chunking, never a request's
    # bits: each response served whole in both runs equals the
    # plain run's bit for bit, adopted ones included
    equal = 0
    for f in futures:
        r = f.result()
        if r.status != "ok" or r.degraded:
            continue
        if not kill:
            plain_run[r.request_id] = r
        elif r.request_id in plain_run:
            p0 = plain_run[r.request_id]
            assert np.array_equal(r.scores, p0.scores), \
                (label, r.request_id)
            assert np.array_equal(r.order, p0.order), r.request_id
            equal += 1
    assert equal > 0 or not kill, label
    detail = wall_summary(res) if mode == "pump" else (
        f"p50 {res.pct(50):.3f} ms, p95 {res.pct(95):.3f} ms, p99 "
        f"{res.pct(99):.3f} ms; {res.achieved_qps:.1f} QPS over "
        f"{res.sim_s:.3f}s simulated, {res.serve_s:.4f}s compute; "
        f"served {res.completed}/{res.n_requests}, errors "
        f"{res.errors}")
    print(f"[{label}] {len(shapes)} shapes warmed per replica; "
          f"{detail}; failovers {st['failovers']}, drained "
          f"{[p['drained'] for p in per]} adopted "
          f"{[p['adopted'] for p in per]}, probes {st['probes']}, "
          f"submitted {[p['submitted'] for p in per]}; "
          f"{tally.calls['execute_chunk']} chunks executed, longest "
          f"{1e3 * tally.longest['execute_chunk']:.3f} ms; K2 x "
          f"{launches} (warmup {warm}), query_bias x {qb_launches}; "
          f"streams {[hex(s.cuda_stream) for s in streams]}; {checked} "
          "responses match the plain pipeline on the CPU"
          + (f"; {equal} bit-equal to the run without the kill"
             if kill else ""))
    return dict(label=label, res=res, launches=launches,
                qb_launches=qb_launches, equal=equal)


def phase_router_adopt(params, reqs, plain_run, *, backlog_n=ADOPT_BACKLOG,
                       label="router adopt") -> int:
    """Failover with a backlog on the card. In the kill runs above replica
    0 holds nothing queued when its breaker opens (it quarantines each
    chunk as it comes), so nothing is adopted. Here ADOPT_BACKLOG requests
    that the plain DES run served whole are queued on replica 0 (forced
    dead), chunks of its smallest bucket are executed until its breaker
    opens, and the router's tick drains the rest to replica 1, which
    serves them on the card. At least one request must be adopted, Σ
    adopted = Σ drained, and every adopted response must equal the plain
    DES run's response to the same request bit for bit, though it was
    served in another chunk of another size; every future resolved and
    the fleet identity closed. Returns K2's launches, asserted = the
    adopting replica's pipeline runs (`backlog_n` requests queued)."""
    router = S.build_router(params, cloes.CASCADE, n=N_REPLICAS,
                            kill_replica=True, device="cuda")
    dead, live = router.replicas
    dead._sleep = lambda s: None        # no backoff between its attempts
    router.warmup()
    backlog = [r for r in reqs if r.request_id in plain_run][:backlog_n]
    futs = [dead.submit(r, now_ms=0.0) for r in backlog]
    quarantined = 0
    while not dead._breaker_open():
        g = min((g for g in dead.buckets if dead._pending[g]),
                key=lambda g: len(dead._pending[g]))
        chunk = dead.claim_bucket(g)
        quarantined += len(dead.resolve_chunk(
            chunk, dead.execute_chunk(chunk), 0.0))
    router.tick(0.0)
    tally = Tally()
    tally.wrap(live, "rank_batch")
    adopted = live.stats["adopted"]
    assert dead.pending == 0 and adopted >= 1 \
        and adopted == dead.stats["drained"] == router.stats["drained"], \
        router.stats_export()
    ops.reset_launch_counts()            # the survivor's run starts here
    live.flush(0.0)
    sync()
    launches = ops.launch_counts()["cascade_filter"]
    assert launches == tally.calls["rank_batch"] > 0, \
        (launches, tally.calls)
    router.close()
    g = router.stats_export()["global"]
    assert all(f.done() for f in futs), f"{label}: unresolved futures"
    assert g["submitted"] == g["completed"] + g["shed"] + g["errors"], g
    equal = 0
    for f in futs:
        r = f.result()
        if r.status != "ok":
            continue
        assert not r.degraded, r.request_id
        p0 = plain_run[r.request_id]
        assert np.array_equal(r.scores, p0.scores), r.request_id
        assert np.array_equal(r.order, p0.order), r.request_id
        equal += 1
    assert equal == adopted, (equal, adopted)
    print(f"[{label}] {len(backlog)} queued on the dead replica, "
          f"{quarantined} quarantined before its breaker opened, {adopted} "
          f"adopted and served by the survivor in {tally.calls['rank_batch']} "
          f"pipeline runs (K2 x {launches}); {equal} bit-equal to the plain "
          "DES run")
    return launches


def phase_witness(params, te, plain) -> dict:
    """The serving paths under the port's runtime lock-order witness
    (`repro_torch.analysis.witness`), where the real interleavings exist:
    the session, pool, router and injector locks and `_build`'s build and
    launch locks wrapped while installed, every K2 and query_bias launch
    counting under the wrapped launch lock while pump, submitter, router
    control and probe threads take the others. A wall-clock pump with
    --faults 0.2 (WITNESS_REQUESTS requests from 4 threads), the
    two-replica router's pump-mode kill run (its whole responses held bit
    for bit to `plain["pump"]`, the unwitnessed run's) and an adopted
    backlog of WITNESS_ADOPT_BACKLOG (held to `plain["des"]`), each with
    the checks of its unwitnessed phase (every future resolved, the
    identity). Fails on any inversion, or when no K2 or query_bias launch
    ran under the witness. A phase of its own: the timed pump and router
    phases above run unwitnessed."""
    from repro_torch.analysis import witness as lock_witness
    t0 = time.perf_counter()
    witness, uninstall = lock_witness.install_witness()
    try:
        pump = phase_pump(params, te, fault_rate=CHAOS_RATE,
                          n_requests=WITNESS_REQUESTS,
                          label="witness pump faults")
        reqs = S.make_requests(te, WITNESS_REQUESTS, seed=0)
        router = router_run(params, reqs, "pump", True, plain["pump"],
                            label="witness router pump kill-replica")
        adopt_k2 = phase_router_adopt(
            params, S.make_requests(te, DES_REQUESTS, seed=0), plain["des"],
            backlog_n=WITNESS_ADOPT_BACKLOG, label="witness router adopt")
        adopt_qb = ops.launch_counts()["query_bias"]
    finally:
        uninstall()
    assert adopt_qb == adopt_k2, (adopt_qb, adopt_k2)
    k2 = pump["launches"] + router["launches"] + adopt_k2
    qb = pump["qb_launches"] + router["qb_launches"] + adopt_qb
    wrapped = collections.Counter(
        lock_witness.kind(w._name) for w in witness.locks)
    acquired = witness.acquisitions()
    edges = ["->".join(e) for e in sorted(witness.edge_kinds())]
    seconds = time.perf_counter() - t0
    print(f"[witness] locks wrapped {dict(sorted(wrapped.items()))}; "
          f"acquisitions {dict(sorted(acquired.items()))}; distinct edges "
          f"{edges or 'none'}; K2 x {k2}, query_bias x {qb} under the "
          f"witness (pump {pump['launches']}, router "
          f"{router['launches']}, adopt {adopt_k2}; warmups not counted); "
          f"inversions {len(witness.inversions)}; {seconds:.1f} s")
    witness.assert_clean()
    assert k2 > 0 and qb > 0, (k2, qb)
    assert acquired["launch"] > 0 and acquired["session"] > 0, acquired
    assert {"session", "pool", "router", "injector", "build",
            "launch"} <= set(wrapped), wrapped
    return dict(k2=k2, qb=qb, edges=edges, wrapped=dict(wrapped),
                acquisitions=acquired, seconds=seconds)


def phase_replica_streams(params, te) -> int:
    """The two replicas' streams at once: at every warmed (b, g), two
    packed page-locked batches, each run first alone on the current stream
    (a bare session: the one-stream bits), then on replica 0's and replica
    1's streams back to back, both held behind one busy-wait so that they
    run together; each output must equal its one-stream bits exactly, and
    the host must have enqueued both before the busy-wait ends (no host
    sync inside rank_batch). Returns K2's launches (counts set to 0 after
    the warmups, read at the end)."""
    cfg = cloes.CASCADE
    reps = make_replicas(params, cfg, n=N_REPLICAS,
                         scfg=S.build_serving_config(),
                         devices=replica_devices(N_REPLICAS))
    bare = S.build_session(params, cfg, device="cuda")
    for r in reps + [bare]:
        r.warmup()
    reqs = iter(S.make_requests(te, N_REPLICAS * len(WARM_G) * sum(WARM_B),
                                seed=2))
    main = torch.cuda.current_stream()
    ops.reset_launch_counts()        # this path starts here
    shapes = overlapped = 0
    for g in WARM_G:
        for b in WARM_B:
            batches = []
            for r in reps:
                batch = r.pool.acquire(b, g)
                assert isinstance(batch, PinnedBatch)
                pack_into(batch, [next(reqs) for _ in range(b)], g)
                batches.append(batch)
            want = [bare.fetch(bare.rank_batch(batch)) for batch in batches]
            torch.cuda._sleep(BUSY_CYCLES)
            for r in reps:
                r.stream.wait_stream(main)
            res = [r.rank_batch(batch) for r, batch in zip(reps, batches)]
            overlapped += not main.query()
            got = [r.fetch(x) for r, x in zip(reps, res)]
            for k in range(N_REPLICAS):
                for key in want[k]:
                    assert np.array_equal(got[k][key], want[k][key]), (
                        f"replica {k} stream, b={b} g={g} {key}: differs "
                        "from the one-stream result")
            for r, batch in zip(reps, batches):
                r.pool.release(batch)
            shapes += 1
    sync()
    launches = ops.launch_counts()["cascade_filter"]   # ... and ends here
    assert launches == 2 * N_REPLICAS * shapes, launches
    assert overlapped == shapes, (
        f"{shapes - overlapped} of {shapes} shapes: the host waited for "
        "the device before both replicas were enqueued")
    print(f"[replica streams] {shapes} shapes (B in {WARM_B}, G in "
          f"{WARM_G}): replicas 0 and 1 on streams "
          f"{[hex(r.stream.cuda_stream) for r in reps]} behind one "
          f"busy-wait, both enqueued while it ran in {overlapped} of "
          f"{shapes}; every output equals its one-stream bits; K2 x "
          f"{launches}")
    return launches


def phase_shim(params, te) -> dict[str, int]:
    """The CascadeServer shim on the card, plans "filter" (K2) and "score"
    (K1): 200 requests submitted, served in submit order; each response's
    scores, survivors, stage counts and latency equal, bit for bit, the
    session's results on the same batch packed by RequestBatcher.drain
    (pageable numpy; the shim's flush stages them page-locked). The plan's
    launches counted from 0 before serve() and read after it."""
    cfg = cloes.CASCADE
    reqs = S.make_requests(te, SHIM_REQUESTS, seed=3)
    out = {}
    for plan, kernel in (("filter", "cascade_filter"),
                         ("score", "cascade_score_batched")):
        srv = CascadeServer(params, cfg, fused=plan, device="cuda")
        shapes = srv.warmup()
        for r in reqs:
            srv.submit(r)
        ops.reset_launch_counts()    # this path starts here
        resps = srv.serve()
        sync()
        launches = ops.launch_counts()[kernel]   # ... and ends here
        assert [r.request_id for r in resps] == [r.request_id for r in reqs]
        assert all(r.status == "ok" for r in resps)
        batcher = RequestBatcher()
        for r in reqs:
            batcher.submit(r)
        batches = 0
        for seqs, chunk, batch in batcher.drain():
            want = srv.session.fetch(srv.rank_batch(batch))
            batches += 1
            for i, (seq, req) in enumerate(zip(seqs, chunk)):
                r = resps[seq]
                n = len(r.scores)
                assert np.array_equal(r.scores, want["scores"][i][:n]), seq
                assert np.array_equal(r.survivors,
                                      want["survivors"][i][:n] > 0), seq
                assert r.stage_counts == [int(c) for c in
                                          want["stage_counts"][i]], seq
                assert r.est_latency_ms == float(want["lat"][i]), seq
        assert launches == batches, (launches, batches)
        out[kernel] = launches
        print(f"[shim {plan}] {len(shapes)} shapes warmed; {len(resps)} "
              f"requests served in submit order in {batches} batches "
              f"({kernel} x {launches}); every response equals the "
              "session's bits on RequestBatcher.drain's batch")
    return out


def phase_warm_restart(tmp) -> dict:
    """`launch.serve` on the card with --serve-dir (the cascade trained,
    500 requests at 400 QPS, drained and persisted), then again with
    --warm-restart: restored params equal to the first server's, 0 shapes
    first seen after warmup, every future resolved, the identity closed,
    K2 = query_bias = chunks executed + the manifest's replayed shapes
    (counts set to 0 before the warm-restarted run, read after it), and
    each response equal bit for bit to the first server's wherever both
    served the request in a chunk of the same g, whatever the chunks' b
    (within 1e-5 across g): `row_bits_by_b` shows why (query_bias's zq and
    K2's outputs are bit-equal at every b; asserted). Warmup seconds of
    both, the warm server's p99."""
    serve_dir = os.path.join(tmp, "serve")
    args = ["--device", "cuda", "--requests", str(DES_REQUESTS), "--qps",
            str(DES_QPS), "--serve-dir", serve_dir]
    orig = CascadeSession.execute_chunk
    runs, reports, chunk_of, executed = [], [], [], []

    def recorded(self, chunk):
        executed[-1] += 1
        for e in chunk.entries:
            chunk_of[-1][e.req.request_id] = (chunk.capacity, chunk.g)
        return orig(self, chunk)
    other_b = 0
    CascadeSession.execute_chunk = recorded
    try:
        for extra in ([], ["--warm-restart"]):
            chunk_of.append({})
            executed.append(0)
            report = os.path.join(tmp, f"serve{len(runs)}.json")
            if extra:
                cold_params = S.load_serving_state(serve_dir,
                                                   device="cuda")[0]
                ops.reset_launch_counts()    # the warm path starts here
            with contextlib.redirect_stdout(io.StringIO()):
                runs.append(S.main(args + extra + ["--report", report]))
            sync()
            with open(report) as f:
                reports.append(json.load(f))
        launches = ops.launch_counts()       # ... and ends here
    finally:
        CascadeSession.execute_chunk = orig
    cold, warm = reports
    warm_params = S.load_serving_state(serve_dir, device="cuda")[0]
    for k in cold_params:
        assert torch.equal(warm_params[k], cold_params[k]), k
    with open(os.path.join(serve_dir, "warmup_manifest.json")) as f:
        shapes = len(json.load(f)["shapes"])
    assert warm["recompiles_after_warmup"] == 0, warm
    for res, rep in zip(runs, reports):
        st = rep["session_stats"]
        assert res.unresolved == 0 and all(f.done() for f in res.futures)
        assert st["submitted"] == st["completed"] + st["shed"] + st["errors"]
        assert st["errors"] == 0 and st["faults"] == 0, st
    same = other = 0
    for f1, f2 in zip(runs[0].futures, runs[1].futures):
        a, b = f1.result(), f2.result()
        assert a.request_id == b.request_id
        if a.status != "ok" or b.status != "ok" or a.degraded or b.degraded:
            continue
        (cap0, g0), (cap1, g1) = (chunk_of[0][a.request_id],
                                  chunk_of[1][b.request_id])
        if g0 == g1:
            assert np.array_equal(a.scores, b.scores), (a.request_id,
                                                        cap0, cap1)
            assert np.array_equal(a.survivors, b.survivors), a.request_id
            assert np.array_equal(a.order, b.order), a.request_id
            same += 1
            other_b += cap0 != cap1
        else:
            np.testing.assert_allclose(b.scores, a.scores, rtol=RTOL,
                                       atol=ATOL)
            other += 1
    assert same > 0
    assert launches["cascade_filter"] == launches["query_bias"] \
        == executed[1] + shapes, (launches, executed, shapes)
    print(f"[warm restart] cold start: trained, warmed {shapes} shapes in "
          f"{cold['phases_s']['warmup']:.4f} s, served, drained, persisted; "
          f"warm restart: restored in {warm['phases_s']['train']:.4f} s, "
          f"replayed the manifest in {warm['phases_s']['warmup']:.4f} s, "
          f"0 shapes first seen after warmup")
    lat = {k: r["open_loop"]["latency_ms"] for k, r in
           (("cold", cold), ("warm", warm))}
    print(f"[warm restart] {DES_REQUESTS} requests at {DES_QPS:.0f} QPS: "
          f"p50 / p95 / p99 {lat['warm']['p50']:.3f} / "
          f"{lat['warm']['p95']:.3f} / {lat['warm']['p99']:.3f} ms (cold "
          f"start {lat['cold']['p99']:.3f}); K2 x "
          f"{launches['cascade_filter']} = {executed[1]} chunks + {shapes} "
          f"replayed shapes; {same} responses bit-equal to the first "
          f"server's in a chunk of the same g ({other_b} of them at another"
          f" b), {other} within 1e-5 at another g")
    zq_rows, rows = row_bits_by_b(warm_params)
    assert zq_rows == 0, f"{zq_rows} of {rows} rows' zq differ with b"
    print(f"[warm restart] a row's bits by its chunk's b ({WARM_B[-1]} rows"
          f" in chunks of each b in {WARM_B}, g in {WARM_G}: {rows} in all): "
          f"K2's outputs bit-equal given the same zq; query_bias's zq in "
          f"other bits than one chunk of all {WARM_B[-1]} for {zq_rows}")
    return dict(launches=launches["cascade_filter"],
                qb_launches=launches["query_bias"], cold=cold, warm=warm)


def row_bits_by_b(params) -> tuple[int, int]:
    """The same WARM_B[-1] rows of random requests through the `filter`
    pipeline's two steps (`query_bias`, then K2, as run_cascade calls
    them) in chunks of each warmed b, against one chunk of all of them:
    K2's outputs must be bit-equal for the same zq rows (each group is
    scored and filtered on its own). Returns (rows x (b, g) whose zq
    differs in any bit, rows x (b, g) compared)."""
    cfg = cloes.CASCADE
    gen = torch.Generator(device="cuda").manual_seed(11)
    w_eff = (params["w_x"] * C.masks_tensor(cfg, "cuda")).contiguous()
    n_rows, zq_diff, compared = WARM_B[-1], 0, 0
    for g in WARM_G:
        x = torch.randn(n_rows, g, cfg.d_x, generator=gen, device="cuda")
        q = torch.randn(n_rows, cfg.d_q, generator=gen, device="cuda")
        n = torch.randint(1, g + 1, (n_rows,), generator=gen, device="cuda")
        mask = (torch.arange(g, device="cuda")[None] < n[:, None]).float()
        m_q = 3.0 * n.float()
        zq_all = ops.query_bias(q, params["w_q"], params["b"])
        want = ops.cascade_filter(x, w_eff, zq_all, mask, m_q)
        for b in WARM_B:
            for s in range(0, n_rows, b):
                sl = slice(s, s + b)
                zq = ops.query_bias(q[sl], params["w_q"], params["b"])
                zq_diff += int((zq != zq_all[sl]).any(-1).sum())
                got = ops.cascade_filter(x[sl], w_eff,
                                         zq_all[sl].contiguous(), mask[sl],
                                         m_q[sl])
                for k in ("lp", "survivors", "expected_counts", "n_keep"):
                    assert torch.equal(got[k], want[k][sl]), (k, b, g)
            compared += n_rows
    return zq_diff, compared


# -- 7. K8: the LLM engine's decode attention ------------------------------------

def k8_inputs(b, h, hkv, hd, s, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


def ring_plain(q, k, v, cache_len):
    """The reference's ring decode, independent of K8's mapping: softmax
    over the ring slots that hold a position (ring_slot_positions >= 0)
    within the window W = ring size, grouped-head einsums in float32."""
    b, h, hd = q.shape
    w, hkv = k.shape[1], k.shape[2]
    kpos = Lyr.ring_slot_positions(cache_len + 1, w, device=q.device)
    valid = (kpos >= 0) & (kpos <= cache_len) & (cache_len - kpos < w)
    qg = q.reshape(b, hkv, h // hkv, hd).float()
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k.float()) / math.sqrt(hd)
    p = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return out.reshape(b, h, hd).to(q.dtype)


def k8_check(got, want, label) -> tuple[float, float, float]:
    """Hold K8's output to its plain version's elementwise: float32 within
    K8_F32_TOL, bfloat16 within one unit of the output. Returns (max |err|,
    max |want|, the largest share of its bar that an element used)."""
    g, w = got.float(), want.float()
    if want.dtype == torch.bfloat16:
        rtol, atol = K8_BF16_RTOL, K8_BF16_ATOL
    else:
        rtol = atol = K8_F32_TOL
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                               msg=lambda m: f"{label}: {m}")
    err = (g - w).abs()
    return (float(err.max()), float(w.abs().max()),
            float((err / (atol + rtol * w.abs())).max()))


def phase_k8_parity(errs) -> None:
    """K8 against its plain version on the card over the dtype x hd x rep
    x window x cache_len grid, the ring mapping of the engine's local
    layers against the reference's masked formula, and float32 at the
    timing shapes."""
    n = 0
    s = 1037                          # a multiple of no block or split
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}

    def check(got, want, label):
        err, _, use = k8_check(got, want, label)
        w = worst[want.dtype]
        w[0], w[1] = max(w[0], err), max(w[1], use)
        errs["swa_decode"] = max(errs["swa_decode"], err)

    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for h, hkv in ((4, 4), (8, 4), (16, 4), (14, 2), (24, 2),
                           (6, 1)):
                q, k, v = k8_inputs(2, h, hkv, hd, s, dtype, seed=n)
                for window in (ops.NO_WINDOW, 1024, 100):
                    for cache_len in (0, 255, 256, s - 1):
                        got = ops.swa_decode(q, k, v, cache_len,
                                             window=window)
                        sync()
                        want = ops.swa_decode_ref(q, k, v, cache_len, window)
                        check(got, want, f"K8 {dtype} hd={hd} h={h} "
                              f"hkv={hkv} window={window} len={cache_len}")
                        n += 1
                ring_k = k[:, :1024].contiguous()
                ring_v = v[:, :1024].contiguous()
                for cache_len in (5, 1023, 1024, 5000):
                    got = Lyr.decode_attention(
                        q[:, None], ring_k, ring_v, q_offset=cache_len,
                        window=1024, ring=True)[:, 0]
                    sync()
                    want = ring_plain(q, ring_k, ring_v, cache_len)
                    check(got, want, f"K8 ring {dtype} hd={hd} h={h} "
                          f"len={cache_len}")
                    n += 1
    print(f"[parity] {n} K8 cases at S={s} (ring mapping included): f32 max "
          f"|err| {worst[torch.float32][0]:.3g} (bar {K8_F32_TOL}); bf16 max "
          f"|err| {worst[torch.bfloat16][0]:.3g}, at most "
          f"{worst[torch.bfloat16][1]:.3f} of its bar (|err| <= 2^-7 |want| "
          f"+ {K8_BF16_ATOL})")
    # float32 at the timing shapes: the main path's sizes, held to 2e-5
    readings = []
    for name, shape in K8_SHAPES.items():
        b, h, hkv, hd, s = shape
        q, k, v = k8_inputs(b, h, hkv, hd, s, torch.float32, seed=n)
        # the ring: wrapped (as in the LM phase) and half full
        for cache_len in (LM_PROMPT + 31, s // 2) if name == "ring" else (
                s - 1,):
            if name == "ring":
                got = Lyr.decode_attention(q[:, None], k, v,
                                           q_offset=cache_len, window=s,
                                           ring=True)[:, 0]
                want = ring_plain(q, k, v, cache_len)
            else:
                got = ops.swa_decode(q, k, v, cache_len)
                want = ops.swa_decode_ref(q, k, v, cache_len)
            sync()
            err, mag, _ = k8_check(got, want, f"K8 f32 {name} len={cache_len}")
            errs["swa_decode"] = max(errs["swa_decode"], err)
            readings.append(f"{name} len={cache_len} {err:.3g} (|want| up to "
                            f"{mag:.3g})")
            n += 1
        del q, k, v
    print(f"[parity] K8 f32 at the timing shapes (bar {K8_F32_TOL}): max "
          f"|err| " + "; ".join(readings))


def host_ms(fn, calls=200) -> float:
    """Wall-clock ms per call of `calls` calls back to back, synchronised
    at the end: the host's cost per call wherever it exceeds the device's."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / calls


def k8_timing_case(shape, seed):
    """K8's inputs at a timing shape in bfloat16, with enough copies that
    back-to-back calls read K/V from device memory, not from the L2."""
    b, h, hkv, hd, s = shape
    kv_bytes = 2 * b * s * hkv * hd * 2
    copies = max(1, -(-3 * L2_BYTES // kv_bytes))
    q, _, _ = k8_inputs(b, h, hkv, hd, 1, torch.bfloat16, seed)
    kvs = [k8_inputs(b, h, hkv, hd, s, torch.bfloat16, seed + 1 + i)[1:]
           for i in range(copies)]
    return q, kvs


def rotate(fn, copies):
    """fn(*args) over the copies of the arguments in turn, one copy per
    call."""
    it = [0]

    def call():
        args = copies[it[0] % len(copies)]
        it[0] += 1
        return fn(*args)
    return call


def sdpa_call(q, cache_len, window):
    """One PyTorch call computing K8's function: scaled_dot_product_attention
    with the window's boolean mask and GQA (timed as a yardstick; the port
    never calls it)."""
    import torch.nn.functional as F

    def call(k, v):
        s = k.shape[1]
        pos = torch.arange(s, device=k.device)
        mask = (pos <= cache_len) & (pos > cache_len - window)
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[None, None, None], enable_gqa=True)[:, :, 0]
    return call


def sdpa_lse_call(q, hkv):
    """One PyTorch call computing K8's partials mode over a whole block:
    aten's flash attention, which returns the output and its logsumexp
    (the state (m, l, acc) as out = acc / l, lse = m + log l; what
    PyTorch's context-parallel attention combines across ranks), each kv
    head's GQA group of q as its query rows, K / V as views (timed as a
    yardstick; the port never calls it). Returns (out (B, H, hd), lse (B,
    H))."""
    b, h, hd = q.shape
    qg = q.reshape(b, hkv, h // hkv, hd)

    def call(k, v):
        r = torch.ops.aten._scaled_dot_product_flash_attention(
            qg, k.transpose(1, 2), v.transpose(1, 2))
        return r[0].reshape(b, h, hd), r[1].reshape(b, h)
    return call


# the CUDA runtime and driver calls that launch one kernel each
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
# idle host time on each side of the counted calls inside the traced step
TRACE_MARGIN_S = 0.02


def cuda_launches_per_call(fn, calls=5) -> tuple[float, int, list[str]]:
    """Kernel launches per call of fn, the kernels the device ran over
    those calls, and their names, from torch.profiler over `calls` calls
    in a step that follows a waiting and a warm-up step (so the tracer is
    running). Launches are the runtime's launch calls, stamped by the host
    clock; a device event is stamped by the card's clock, converted, and
    the tracer drops one that lands outside the step's window, so the
    counted calls sit between idle margins and the device count is a
    second reading, at most the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            time.sleep(TRACE_MARGIN_S)
            for _ in range(calls):
                fn()
            sync()
            time.sleep(TRACE_MARGIN_S)
            prof.step()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    kernels = [e for e in events
               if e.device_type != DeviceType.CPU
               and not e.key.startswith(("Memcpy", "Memset",
                                         "ProfilerStep"))]
    return (launches / calls, sum(e.count for e in kernels),
            sorted({e.key.split("<")[0].split("(")[-1].split("::")[-1]
                    for e in kernels}))


def phase_k8_timing() -> dict[str, dict]:
    """K8 at the LM phase's shapes, beside its plain version, its bound and
    the library call; two launches give the same bits at each shape."""
    out = {}
    for name, shape in K8_SHAPES.items():
        b, h, hkv, hd, s = shape
        # global: the last slot of a full cache; ring: the mapping's
        # cache_len for a wrapped ring (every slot valid, no window)
        cache_len, window = s - 1, ops.NO_WINDOW
        q, kvs = k8_timing_case(shape, seed=11)
        a = ops.swa_decode(q, *kvs[0], cache_len, window=window)
        z = ops.swa_decode(q, *kvs[0], cache_len, window=window)
        want = ops.swa_decode_ref(q, *kvs[0], cache_len, window)
        sync()
        assert torch.equal(a, z), f"K8 {name}: two launches differ"
        err, mag, use = k8_check(a, want, f"K8 bf16 {name}")
        lib = sdpa_call(q, cache_len, window)
        lib_err = float((lib(*kvs[0]).float() - want.float()).abs().max())
        kern, lone = time_ms(rotate(lambda k, v: ops.swa_decode(
            q, k, v, cache_len, window=window), kvs))
        host = host_ms(rotate(lambda k, v: ops.swa_decode(
            q, k, v, cache_len, window=window), kvs))
        plain, _ = time_ms(rotate(lambda k, v: ops.swa_decode_ref(
            q, k, v, cache_len, window), kvs), reps=5, calls=5)
        library, _ = time_ms(rotate(lib, kvs), reps=5, calls=5)
        n_valid = min(cache_len + 1, window)
        nops, kv_bytes, q_bytes = ops.swa_decode_work(b, h, hkv, hd, 2,
                                                      cache_len, window)
        nbytes = kv_bytes + 2 * q_bytes
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / BF16_OPS_PER_S * 1e3
        per_sm, tile = swa_kernel._instance(
            0, hd, swa_kernel.head_group(h // hkv), True)
        p = swa_kernel.plan(b, s, h, hkv, cache_len, window,
                            swa_kernel._sm_count(0), per_sm, tile)
        out[name] = dict(
            ms=kern, lone_ms=lone, host_ms=host, plain_ms=plain,
            library_ms=library,
            bytes=nbytes, ops=nops, bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            max_abs_err=err, max_abs_want=mag, bar_use=use,
            library_err=lib_err, plan=p, inputs=(q, kvs[0], cache_len,
                                                 window))
        r = out[name]
        print(f"[timing] K8 swa_decode {name} (B={b} H={h} Hkv={hkv} hd={hd} "
              f"S={s} bf16, {n_valid} positions, {p['n_split']} splits x "
              f"{p['split_len']} = {p['blocks']} blocks at "
              f"{p['blocks_per_sm']} per SM ({p['waves']} wave(s)), "
              f"{len(kvs)} K/V copies): kernel "
              f"{r['ms']:.4f} ms (lone call {r['lone_ms']:.4f} ms; "
              f"{r['host_ms']:.4f} ms per call of 200 back to back, wall "
              f"clock), plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms "
              f"(|err| {lib_err:.3g}), bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({nbytes} bytes -> {by_bytes:.4f} ms; "
              f"{nops} ops -> {by_ops:.5f} ms), "
              f"{r['bound_ms'] / r['ms']:.1%} of bound; two launches "
              f"bit-equal; against plain max |err| {err:.3g}, |want| up to "
              f"{mag:.3g}, at most {use:.3f} of the bf16 bar")
    # CUDA launches per call, over all the shapes in one profiled session
    calls = [out[name].pop("inputs") for name in K8_SHAPES]
    n_cuda, n_device, names = cuda_launches_per_call(
        lambda: [ops.swa_decode(q, k, v, c, window=w)
                 for q, (k, v), c, w in calls], calls=5)
    n_cuda /= len(calls)
    n_calls = 5 * len(calls)
    print(f"[timing] K8: {n_cuda:g} CUDA launch(es) per call, the device "
          f"ran {n_device} kernel(s) {names} (torch.profiler, {n_calls} "
          f"calls over the {len(calls)} shapes)")
    if n_cuda != 1:
        raise AssertionError(f"K8: {n_cuda} CUDA launches per call, not 1")
    if n_device > n_calls or names != ["swa_decode_kernel"]:
        raise AssertionError(f"K8: the device ran {n_device} kernels "
                             f"{names} for {n_calls} calls")
    for name in K8_SHAPES:
        out[name]["cuda_launches_per_call"] = n_cuda
    return out


def phase_k8_streams() -> None:
    """K8 calls in flight on two streams at once give the one-stream bits:
    the split combine's tickets are per (device, stream). Pairs of calls
    at the 128k shape (the same inputs on both streams, then different
    ones), at the ring shape and at a shape whose two grids fit on the card
    together, each pair launched back to back on two side streams with no
    sync between them, both held behind one busy-wait so that they start
    together; three rounds each, on new inputs every round (so a combine
    that read another call's slot would meet partials that differ)."""
    main = torch.cuda.current_stream()
    side = (torch.cuda.Stream(), torch.cuda.Stream())
    cases = [("long", K8_SHAPES["long"], True),
             ("long", K8_SHAPES["long"], False),
             ("ring", K8_SHAPES["ring"], False),
             ("two grids at once", K8_PAIR_SHAPE, False)]
    done = []
    for name, shape, same in cases:
        b, h, hkv, hd, s = shape
        for rnd in range(3):
            first = k8_inputs(b, h, hkv, hd, s, torch.bfloat16, seed=20 + rnd)
            args = [(*first, s - 1), (*(first if same else k8_inputs(
                b, h, hkv, hd, s, torch.bfloat16, seed=30 + rnd)), s - 1)]
            want = [ops.swa_decode(*a) for a in args]       # one stream
            torch.cuda._sleep(BUSY_CYCLES)
            got = [None, None]
            for st in side:
                st.wait_stream(main)
            for i, st in enumerate(side):
                with torch.cuda.stream(st):
                    got[i] = ops.swa_decode(*args[i])
            for st in side:
                main.wait_stream(st)
            sync()
            for i in range(2):
                assert torch.equal(got[i], want[i]), (
                    f"K8 {name} on two streams (round {rnd}, stream {i}): "
                    "differs from the one-stream result")
            del first, args
        p = swa_kernel.plan(b, s, h, hkv, s - 1, ops.NO_WINDOW,
                            swa_kernel._sm_count(0),
                            *swa_kernel._instance(
                                0, hd, swa_kernel.head_group(h // hkv), True))
        done.append(f"{name} {shape} ({'same' if same else 'different'} "
                    f"inputs; {p['blocks']} blocks a call, {p['n_split']} "
                    f"splits x {p['units']} tickets)")
    print(f"[k8 streams] two calls in flight on two side streams equal the "
          f"one-stream bits, 3 rounds each: " + "; ".join(done))



def k8_partial_cut(name: str, s: int) -> tuple[int, int, bool]:
    """[k8 partial]'s query at a K8_SHAPES cache of s slots: (cache_len,
    window, ring) that leave one of K8_PARTIAL_BLOCKS blocks without a
    valid slot. A cache of positions: the last slot, window 3s/4 (block 0
    lies wholly before the window); the ring: its first 3/4 of slots
    written (cache_len 3s/4 - 1: the last block is empty; the ring's
    mapping onto K8, `layers.decode_attention`, has no window)."""
    if name == "ring":
        return 3 * s // 4 - 1, ops.NO_WINDOW, True
    return s - 1, 3 * s // 4, False


def k8_partial_check(got, want, label) -> float:
    """K8's partials (m, l, acc) against the plain version's: both -inf /
    0 / 0 where the block has no slot; else m within 1e-5 (1 + |m|), l
    rescaled to the plain m within K8_F32_TOL relative, and the block's
    normalised output acc / l within K8_F32_TOL (both compute in float32
    from the same inputs). Returns the largest |acc / l| error."""
    (m, l, acc), (wm, wl, wacc) = got, want
    if not torch.isfinite(wm).any():
        assert not torch.isfinite(m).any() and not l.any() and not acc.any(), (
            f"{label}: an empty block's partials are not -inf / 0 / 0")
        return 0.0
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5,
                               msg=lambda x: f"{label} m: {x}")
    torch.testing.assert_close(l * torch.exp(m - wm), wl, rtol=K8_F32_TOL,
                               atol=0.0, msg=lambda x: f"{label} l: {x}")
    out, want_out = acc / l[..., None], wacc / wl[..., None]
    torch.testing.assert_close(out, want_out, rtol=K8_F32_TOL,
                               atol=K8_F32_TOL,
                               msg=lambda x: f"{label} acc / l: {x}")
    return float((out - want_out).abs().max())


def phase_k8_partial(errs, k8: dict) -> dict:
    """[k8 partial] K8's partials mode against its plain version at the
    K8_PARTIAL_SHAPES of K8_SHAPES in float32 and bfloat16, each cache cut
    into K8_PARTIAL_BLOCKS blocks (each its own tensor, as a rank holds
    it) one of which has no valid slot (`k8_partial_cut`): every block's
    partials held to the plain version's, the empty one launching
    nothing; the blocks' partials combined (`combine_partials`, no mp)
    against K8's normalising call on the whole cache at K8's bar. Then one
    32k quarter of the 128k shape in bfloat16 timed (device time, inputs
    past the L2) beside its plain version, its bound, the library call
    that returns the same state (`sdpa_lse_call`, held to the kernel
    first) and whole K8 at 128k (`k8`, phase_k8_timing's), with its launch
    plan and the CUDA launches per call (one)."""
    readings = []
    for name in K8_PARTIAL_SHAPES:
        b, h, hkv, hd, s = K8_SHAPES[name]
        cache_len, window, ring = k8_partial_cut(name, s)
        n = s // K8_PARTIAL_BLOCKS
        if ring:
            lo_g, hi_g = 0, min(cache_len, s - 1) + 1
        else:
            lo_g, hi_g = max(0, cache_len - window + 1), cache_len + 1
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = k8_inputs(b, h, hkv, hd, s, dtype, seed=40)
            if ring:
                whole = Lyr.decode_attention(q[:, None], k, v,
                                             q_offset=cache_len, window=s,
                                             ring=True)[:, 0]
            else:
                whole = ops.swa_decode(q, k, v, cache_len, window=window)
            parts, launched, err, empty = [], 0, 0.0, 0
            for r in range(K8_PARTIAL_BLOCKS):
                kb = k[:, r * n:(r + 1) * n].contiguous()
                vb = v[:, r * n:(r + 1) * n].contiguous()
                lo = min(max(lo_g - r * n, 0), n)
                hi = min(max(hi_g - r * n, 0), n)
                empty += lo >= hi
                before = ops.launch_counts()["swa_decode_partial"]
                got = ops.swa_decode_partial(q, kb, vb, lo, hi)
                sync()
                launched += ops.launch_counts()["swa_decode_partial"] - before
                want = ops.swa_decode_partial_ref(q, kb, vb, lo, hi)
                err = max(err, k8_partial_check(
                    got, want, f"[k8 partial] {name} {dtype} block {r}"))
                parts.append(got)
                del kb, vb
            assert empty == 1 and launched == K8_PARTIAL_BLOCKS - 1, (
                name, dtype, empty, launched)
            combined = combine_partials(
                None, *map(torch.stack, zip(*parts)), torch.float32).to(dtype)
            c_err, mag, use = k8_check(combined, whole,
                                       f"[k8 partial] {name} {dtype} "
                                       "combined vs K8")
            errs["swa_decode_partial"] = max(errs["swa_decode_partial"],
                                             err)
            readings.append(f"{name} {str(dtype)[6:]}: blocks |acc/l err| "
                            f"{err:.3g}, combined vs K8 {c_err:.3g} "
                            f"({use:.3f} of its bar)")
            del q, k, v, whole, parts
    print(f"[k8 partial] partials mode vs its plain version on "
          f"{K8_PARTIAL_BLOCKS} blocks a cache (one empty: no launch), "
          f"combined vs K8's normalising call at K8's bar: "
          + "; ".join(readings))
    # one 32k quarter of the 128k shape, as a rank of 4 holds it
    b, h, hkv, hd, s = K8_SHAPES["long"]
    n = s // K8_PARTIAL_BLOCKS
    q, kvs = k8_timing_case((b, h, hkv, hd, n), seed=41)
    kern, lone = time_ms(rotate(lambda k, v: ops.swa_decode_partial(
        q, k, v, 0, n), kvs))
    plain, _ = time_ms(rotate(lambda k, v: ops.swa_decode_partial_ref(
        q, k, v, 0, n), kvs), reps=5, calls=5)
    lib_fn = sdpa_lse_call(q, hkv)
    m, l, acc = ops.swa_decode_partial(q, *kvs[0], 0, n)
    lib_out, lib_lse = lib_fn(*kvs[0])
    want_out = acc / l[..., None]
    lib_err = float((lib_out.float() - want_out).abs().max())
    assert lib_err <= K8_LIB_TOL * float(want_out.abs().max()), (
        "[k8 partial] flash attention's output vs the partials' acc / l",
        lib_err, float(want_out.abs().max()))
    torch.testing.assert_close(lib_lse, m + torch.log(l), rtol=K8_F32_TOL,
                               atol=K8_F32_TOL,
                               msg=lambda x: f"[k8 partial] lse vs m + log l: "
                               f"{x}")
    library, _ = time_ms(rotate(lib_fn, kvs))
    del m, l, acc, lib_out, lib_lse, want_out
    nops, kv_bytes, q_bytes = ops.swa_decode_range_work(b, h, hkv, hd, 2, n)
    nbytes = kv_bytes + q_bytes + b * h * (hd + 2) * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / BF16_OPS_PER_S * 1e3
    per_sm, tile = swa_kernel._instance(
        0, hd, swa_kernel.head_group(h // hkv), True)
    plan = swa_kernel.plan_range(b, h, hkv, 0, n, swa_kernel._sm_count(0),
                                 per_sm, tile)
    n_cuda, n_device, names = cuda_launches_per_call(
        lambda: ops.swa_decode_partial(q, *kvs[0], 0, n))
    assert n_cuda == 1 and names == ["swa_decode_kernel"], (n_cuda, names)
    out = dict(ms=kern, lone_ms=lone, plain_ms=plain,
               bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations",
               library_ms=library, bytes=nbytes, ops=nops, plan=plan,
               whole_k8_ms=k8["long"]["ms"], cuda_launches_per_call=n_cuda)
    print(f"[k8 partial] one quarter of the 128k shape (B={b} H={h} "
          f"Hkv={hkv} hd={hd}, {n} slots, bf16; {plan['n_split']} splits x "
          f"{plan['split_len']} = {plan['blocks']} blocks at "
          f"{plan['blocks_per_sm']} per SM, {plan['waves']} wave(s)): "
          f"kernel {kern:.4f} ms (lone call {lone:.4f} ms), plain "
          f"{plain:.4f} ms, aten flash attention with its logsumexp "
          f"{library:.4f} ms (|out err| {lib_err:.3g}), bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']} ({nbytes} bytes -> {by_bytes:.4f} ms; {nops} "
          f"ops -> {by_ops:.5f} ms), {out['bound_ms'] / kern:.1%} of bound; "
          f"whole K8 at 128k {k8['long']['ms']:.4f} ms ({kern / k8['long']['ms']:.3f}"
          f" of it); {n_cuda:g} CUDA launch per call, the device ran "
          f"{n_device} kernel(s) {names}")
    return out


# -- 6d. the paper's evaluation ---------------------------------------------------

def check_table3_launches(counts: dict[str, int], steps: int, tag: str):
    """Table 3 launches exactly this for fits of `steps` steps: four L1
    fits (K1 + K3 a step), two L3 fits (K4 + K5 a step) and ten
    `evaluate` forwards (K1; the 2-stage evaluation scores in plain
    torch)."""
    want = {"cascade_score_batched": 4 * steps + 10,
            "cascade_score_batched_bwd": 4 * steps,
            "cascade_loss": 2 * steps, "cascade_loss_bwd": 2 * steps}
    got = {k: v for k, v in counts.items() if v}
    assert got == want, f"[{tag}] Table 3 launches {got} != {want}"


def phase_paper(card: str) -> dict:
    """[paper] the paper's evaluation (`repro_torch.paper`) on the card.

    At the reference's benchmark scale (1,200 x 64, seed 42): all five
    suites, each with the launch counts set to 0 before it and read after
    it, every claim asserted; Table 3 again on the CPU, the card's rows
    within PAPER_AUC_TOL / PAPER_COST_RTOL of it. (The paper's scale,
    61,500 x 64 = 1,998,780 instances, is `python -m
    repro_torch.paper.table3_offline --scale paper`, run on its own.)
    Imported here, not at the top: kernel_ab.py runs this script's code on
    trees that predate the package."""
    import importlib
    from repro_torch.paper import MODULES, common
    from repro_torch.paper import table3_offline as T3
    t0 = time.perf_counter()
    split = common.bench_split("ci")
    steps = 6 * T.epoch_steps(split[0].x.shape[0], 64)[0]
    common.clear_fits()
    results, launches = {}, collections.Counter()
    for name, module in MODULES.items():
        run = importlib.import_module(f"repro_torch.paper.{module}").run
        ops.reset_launch_counts()          # this suite's path starts here
        res = common.run_suite(name, run, split, "cuda")
        sync()
        counts = ops.launch_counts()       # ... and ends here
        common.emit_claims(res)
        missing = [k for k in PAPER_SUITE_KERNELS[name] if not counts[k]]
        assert not missing, f"[paper] {name} launched no {missing}: {counts}"
        if name == "table3":
            check_table3_launches(counts, steps, "paper ci")
        assert not res.failed, f"[paper] {name} claims failed: {res.claims}"
        launches.update(counts)
        results[name] = res
        print(f"[paper] {name} at ci scale on the card: {len(res.claims)} "
              f"claims held in {res.seconds:.2f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    ci_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    cpu_rows = T3.rows(split, "cpu")
    cpu_s = time.perf_counter() - t1
    worst = {"auc": 0.0, "cost": 0.0}
    for got, want in zip(results["table3"].rows, cpu_rows):
        for k in ("train_auc", "test_auc"):
            err = abs(got[k] - want[k])
            worst["auc"] = max(worst["auc"], err)
            assert err <= PAPER_AUC_TOL, (got["algo"], k, got[k], want[k])
        err = abs(got["cost"] - want["cost"]) / abs(want["cost"])
        worst["cost"] = max(worst["cost"], err)
        assert err <= PAPER_COST_RTOL, (got["algo"], got["cost"], want["cost"])
    print(f"[paper] Table 3 at ci scale on the CPU in {cpu_s:.2f} s: the "
          f"card's rows within {worst['auc']:.3g} AUC and "
          f"{worst['cost']:.3g} relative cost of it; the five suites took "
          f"{ci_s:.1f} s on the card")
    paper_s = time.perf_counter() - t0
    print(f"[paper] done in {paper_s:.1f} s ({card})")
    common.clear_fits()
    common.bench_split.cache_clear()
    common.bench_log.cache_clear()
    return {"launches": dict(launches), "seconds": paper_s}


# -- 8. the LLM engine: gemma3-27b prefill + greedy decode -------------------

def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm() -> dict:
    """gemma3-27b at full width and depth in bf16 through the engine's
    prefill and 32 greedy decode steps. K8's launches are counted from 0
    just before the prefill and read just after the last step."""
    cfg = CFG.get(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
    sync()
    make_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size()
                 for t in MB.tree_leaves(params))
    print(f"[lm] {cfg.name}: {cfg.param_count()} parameters, {nbytes} bytes "
          f"in {cfg.dtype} made on the card in {make_s:.1f} s; "
          f"{cfg.n_layers} layers, window {cfg.sliding_window}, global "
          f"every {cfg.global_every}")
    max_len = LM_PROMPT + LM_STEPS + 2 * LM_PROFILE_STEPS
    cache = E.init_cache(cfg, LM_BATCH, max_len, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda")
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()          # the LM path starts here
    t0 = time.perf_counter()
    logits, cache = E.prefill(params, cfg, {"tokens": tokens}, cache)
    sync()
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(LM_STEPS + 1)]
    generated = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(LM_STEPS):
        logits, cache = E.decode_step(params, cfg, tok, cache, LM_PROMPT + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        finite &= torch.isfinite(logits).all()
        generated.append(tok)
        events[i + 1].record()
    sync()
    decode_s = time.perf_counter() - t0
    launches = ops.launch_counts()     # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    assert bool(finite), "non-finite logits in the LM phase"
    want = {k: 0 for k in launches}
    want["swa_decode"] = cfg.n_layers * LM_STEPS
    assert launches == want, (launches, want)
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(LM_STEPS)]
    med = statistics.median(step_ms)
    bnd = decode_bound(cfg, LM_BATCH, max_len, LM_PROMPT + LM_STEPS - 1)
    print(f"[lm] prefill B={LM_BATCH} x {LM_PROMPT} tokens: {prefill_s:.3f} s "
          f"({LM_BATCH * LM_PROMPT / prefill_s:.0f} tokens/s); {LM_STEPS} "
          f"greedy decode steps in {decode_s:.3f} s: median {med:.3f} ms "
          f"per step (first {step_ms[0]:.3f}, min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}), {LM_BATCH / med * 1e3:.1f} tokens/s at the "
          f"median, {LM_BATCH * LM_STEPS / decode_s:.1f} tokens/s overall; "
          f"peak memory {peak} bytes; K8 launches {launches['swa_decode']} "
          f"= {cfg.n_layers} x {LM_STEPS}; logits finite")
    print(f"[lm] decode step: {bound_note('lm', med, bnd)}")
    print(f"[lm] greedy tokens of sequence 0: "
          f"{torch.cat(generated, 1)[0].tolist()}")
    profile = profile_decode(params, cfg, cache, tok, LM_PROMPT + LM_STEPS)
    cprofile_decode(params, cfg, cache, tok)
    del cache, logits
    del params
    free_cuda()
    return dict(params=cfg.param_count(), param_bytes=nbytes,
                prefill_s=prefill_s, step_ms=step_ms, step_ms_median=med,
                floor_ms=bnd["bound_ms"],
                tokens_per_s=LM_BATCH / med * 1e3, peak_bytes=peak,
                k8_launches=launches["swa_decode"], profile=profile)


def tp_reference(params, cfg, tokens, generated, frontend=None) -> dict:
    """What [tp lm] / [tp moe] / [tp families lm] hold their ranks to: the
    unsharded model's prefill of `tokens` (over an encdec model's
    `frontend`) and TP_STEPS decode steps fed the timed run's first greedy
    tokens, rerun untimed (lm_serve: logits and routes on the CPU), with
    the prompt and the tokens fed."""
    feed = [g.cpu() for g in generated[:TP_STEPS]]
    ref = lm_serve(params, cfg, tokens.cpu(), TP_STEPS, "cuda", feed=feed,
                   frontend=frontend)
    return dict(tokens=tokens.cpu(), **ref)


def profile_decode(params, cfg, cache, tok, pos, tag="lm") -> dict:
    """LM_PROFILE_STEPS more decode steps from position `pos` under
    torch.profiler: where a step's time goes (the profiler's overhead
    inflates the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_PROFILE_STEPS):
            logits, cache = E.decode_step(params, cfg, tok, cache, pos + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        sync()
        seconds = time.perf_counter() - t0
    summary = S.profile_summary(prof, seconds, top=12)
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    print(f"[{tag}] profiled {LM_PROFILE_STEPS} decode steps of {cfg.name}: "
          f"{seconds:.4f} s, device busy {summary['device_busy_ms']:.3f} ms "
          f"(idle share {summary['device_idle_share']:.4f}), {n_launch} "
          f"cudaLaunchKernel ({n_launch / LM_PROFILE_STEPS:.0f} per step)")
    for op in summary["device_ops"]:
        print(f"[{tag}]   device {op['self_device_ms']:9.3f} ms "
              f"x{op['count']:<6d} {op['name'][:90]}")
    for op in summary["top_host_ops"]:
        print(f"[{tag}]   host {op['self_cpu_ms']:9.3f} ms "
              f"x{op['count']:<6d} {op['name'][:90]}")
    return dict(seconds=seconds, launches_per_step=n_launch / LM_PROFILE_STEPS,
                device_busy_ms=summary["device_busy_ms"],
                device_idle_share=summary["device_idle_share"])


def cprofile_decode(params, cfg, cache, tok) -> None:
    """A few more decode steps under cProfile: which Python functions take
    the host's time (cProfile's own overhead inflates it)."""
    import cProfile
    import pstats
    pos = LM_PROMPT + LM_STEPS + LM_PROFILE_STEPS
    prof = cProfile.Profile()
    prof.enable()
    for i in range(LM_PROFILE_STEPS):
        logits, cache = E.decode_step(params, cfg, tok, cache, pos + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    sync()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)
    total = sum(v[2] for v in stats.stats.values())
    print(f"[lm] cProfile of {LM_PROFILE_STEPS} decode steps: "
          f"{total * 1e3 / LM_PROFILE_STEPS:.1f} ms of host time per step; "
          "top functions by own time (ms per step, calls per step):")
    for (path, line, fn), (_, ncalls, tottime, _, _) in rows[:14]:
        print(f"[lm]   {tottime * 1e3 / LM_PROFILE_STEPS:8.2f} ms "
              f"x{ncalls // LM_PROFILE_STEPS:<6d} "
              f"{os.path.basename(path)}:{line} {fn}")


def phase_lm_check() -> dict:
    """Full width, one local:global period (6 layers) in float32: prefill
    and one decode step against the model's own forward over the extended
    sequence, which runs no K8."""
    cfg = dataclasses.replace(CFG.get(LM_ARCH), n_layers=LM_CHECK_LAYERS,
                              dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
    b, s = LM_CHECK_BATCH, LM_CHECK_PROMPT
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda")
    cache = E.init_cache(cfg, b, s + 1, device="cuda")
    ops.reset_launch_counts()
    lg, cache = E.prefill(params, cfg, {"tokens": tokens}, cache)
    tok = lg[:, -1].argmax(-1, keepdim=True)
    lg2, cache = E.decode_step(params, cfg, tok, cache, s)
    sync()
    launches = ops.launch_counts()["swa_decode"]
    assert launches == cfg.n_layers, launches
    del cache
    full, _ = Z.forward(params, cfg, {"tokens": torch.cat([tokens, tok], 1)})
    err_prefill = float((lg[:, 0] - full[:, -2]).abs().max())
    err_decode = float((lg2[:, 0] - full[:, -1]).abs().max())
    scale = float(full[:, -1].abs().max())
    torch.testing.assert_close(lg[:, 0], full[:, -2], rtol=LM_PREFILL_TOL,
                               atol=LM_PREFILL_TOL)
    torch.testing.assert_close(lg2[:, 0], full[:, -1], rtol=LM_DECODE_TOL,
                               atol=LM_DECODE_TOL)
    print(f"[lm check] {cfg.name} at full width, {cfg.n_layers} layers, "
          f"float32: prefill of {s} tokens (window {cfg.sliding_window}: "
          f"the rings wrap) + 1 decode step (K8 x {launches}) against the "
          f"forward over {s + 1} tokens: max |err| prefill {err_prefill:.3g}"
          f" (bar {LM_PREFILL_TOL}), decode {err_decode:.3g} (bar "
          f"{LM_DECODE_TOL}); logits up to {scale:.3g}")
    del params, full, lg, lg2
    free_cuda()
    return dict(err_prefill=err_prefill, err_decode=err_decode)


# -- 8b. the moe family: dbrx and arctic ----------------------------------------

def routed(fn, *args, host=True, feed=None):
    """fn(*args) with every moe layer's routing recorded: (fn's result,
    [(probs (T, E), gate_i (T, k)), ...] in call order), on the CPU, or
    with host=False left on the device (no copy waits for the card). The
    zoo reaches `layers.moe_route` through the module. feed: an iterator
    of gate_i (T, k) on the device, one a call: each call then routes its
    tokens to feed's experts, their gates this run's own probabilities of
    them renormalised as moe_route renormalises its top k, and records its
    own choices."""
    routes = []
    orig = Lyr.moe_route

    def rec(p, cfg, xt):
        out = orig(p, cfg, xt)
        r = (out[0].detach(), out[2])
        routes.append(tuple(a.cpu() for a in r) if host else r)
        if feed is None:
            return out
        gate_i = next(feed)
        gate_v = out[0].gather(1, gate_i)
        gate_v = gate_v / torch.clamp_min(gate_v.sum(-1, keepdim=True), 1e-9)
        return out[0], gate_v, gate_i
    Lyr.moe_route = rec
    try:
        return fn(*args), routes
    finally:
        Lyr.moe_route = orig


def check_routes(got, want, k, label) -> tuple[int, int]:
    """Expert choices equal wherever the router leaves a margin: the
    k-th and (k+1)-th of `want`'s probabilities more than ROUTE_LOG_MARGIN
    apart in log space. Returns (tokens compared, tokens without margin)."""
    assert len(got) == len(want), (label, len(got), len(want))
    compared = skipped = 0
    for (_, g_i), (w_p, w_i) in zip(got, want):
        top = torch.sort(w_p, dim=-1, descending=True).values.log()
        sure = (top[:, k - 1] - top[:, k]) > ROUTE_LOG_MARGIN
        assert torch.equal(g_i[sure], w_i[sure]), label
        compared += int(sure.sum())
        skipped += int((~sure).sum())
    assert compared > 0, label
    return compared, skipped


def check_greedy(got, want, label, tol=MOE_LOGIT_TOL) -> int:
    """Logits (B, V) within tol; the greedy token equal wherever want's
    top-2 margin exceeds twice the bar. Returns tokens compared."""
    torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                               msg=lambda m: f"{label}: {m}")
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]), label
    return int(sure.sum())


def lm_serve(params, cfg, tokens, steps, device, feed=None,
             frontend=None, mp=None) -> dict:
    """Prefill `tokens` (B, S) (over an encdec model's `frontend` frames
    (B, S_enc, d)), then `steps` greedy decode steps on `device`, each fed
    feed[i] (B, 1) if given, else this run's own greedy token: every
    step's last-position logits (on the CPU), the tokens fed and the
    routing of every moe layer's call (none in other families). mp: a
    rank of a model-parallel run, params its shard (prefill_calls: its
    collectives up to the end of the prefill)."""
    b, s = tokens.shape
    batch, enc_len = {"tokens": tokens.to(device)}, 0
    if frontend is not None:
        batch["frontend"], enc_len = frontend.to(device), frontend.shape[1]
    cache = E.init_cache(cfg, b, s + steps, enc_len, device=device, mp=mp)
    (lg, cache), routes = routed(E.prefill, params, cfg, batch, cache, mp)
    prefill_calls = {} if mp is None else dict(mp.calls)
    logits, fed = [lg[:, -1].cpu()], []
    for i in range(steps):
        tok = (logits[-1].argmax(-1, keepdim=True) if feed is None
               else feed[i])
        fed.append(tok)
        (lg, cache), r = routed(E.decode_step, params, cfg, tok.to(device),
                                cache, s + i, mp)
        logits.append(lg[:, -1].cpu())
        routes += r
    return dict(logits=logits, fed=fed, routes=routes,
                prefill_calls=prefill_calls)


def phase_moe_parity() -> dict:
    """dbrx-smoke and arctic-smoke in float32 on the card against the same
    weights on the CPU: the forward's logits (MOE_LOGIT_TOL) and aux loss
    (MOE_AUX_TOL), then a prompt's prefill and MOE_PARITY_STEPS greedy
    decode steps, both fed the CPU's greedy tokens: logits within the bar
    at every step, the greedy token and every layer's expert choices
    exactly wherever the margin allows; K8 launched once per layer per
    decode step (counts set to 0 before the card's prefill, read after its
    last step)."""
    out = {}
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32)
        cpu_params = MB.materialize(Z.templates(cfg),
                                    torch.Generator().manual_seed(3))
        params = MB.tree_map(lambda a: a.to("cuda"), cpu_params)
        rng = np.random.default_rng(3)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (MOE_PARITY_BATCH, MOE_PARITY_PROMPT)))
        (lg, aux), r_card = routed(Z.forward, params, cfg,
                                   {"tokens": tokens.to("cuda")})
        (lg_c, aux_c), r_cpu = routed(Z.forward, cpu_params, cfg,
                                      {"tokens": tokens})
        torch.testing.assert_close(lg.cpu(), lg_c, rtol=MOE_LOGIT_TOL,
                                   atol=MOE_LOGIT_TOL)
        torch.testing.assert_close(aux.cpu(), aux_c, rtol=MOE_AUX_TOL,
                                   atol=MOE_AUX_TOL)
        fwd_err = float((lg.cpu() - lg_c).abs().max())
        routes, no_margin = check_routes(r_card, r_cpu, cfg.top_k,
                                         f"{arch} forward")
        cpu = lm_serve(cpu_params, cfg, tokens, MOE_PARITY_STEPS, "cpu")
        ops.reset_launch_counts()        # the card's engine path starts here
        card = lm_serve(params, cfg, tokens, MOE_PARITY_STEPS, "cuda",
                         feed=cpu["fed"])
        sync()
        k8 = ops.launch_counts()["swa_decode"]      # ... and ends here
        assert k8 == cfg.n_layers * MOE_PARITY_STEPS, k8
        greedy = sum(check_greedy(g, w, f"{arch} step {i}") for i, (g, w)
                     in enumerate(zip(card["logits"], cpu["logits"])))
        assert greedy > 0, arch
        r, nm = check_routes(card["routes"], cpu["routes"], cfg.top_k,
                             f"{arch} engine")
        routes, no_margin = routes + r, no_margin + nm
        err = max(float((g - w).abs().max())
                  for g, w in zip(card["logits"], cpu["logits"]))
        print(f"[moe parity] {cfg.name} (float32, {cfg.n_experts} experts "
              f"top-{cfg.top_k}, capacity factor {cfg.capacity_factor}) on "
              f"the card against the CPU: forward of {MOE_PARITY_BATCH} x "
              f"{MOE_PARITY_PROMPT} tokens max |err| {fwd_err:.3g}, aux "
              f"{float(aux):.6f} vs {float(aux_c):.6f}; prefill + "
              f"{MOE_PARITY_STEPS} greedy decode steps max |err| {err:.3g} "
              f"(bar {MOE_LOGIT_TOL}), {greedy} greedy tokens equal; expert "
              f"choices equal for {routes} token-layers ({no_margin} "
              f"without margin); K8 x {k8} = {cfg.n_layers} x "
              f"{MOE_PARITY_STEPS}")
        out[arch] = dict(fwd_err=fwd_err, decode_err=err, k8_launches=k8)
        del params
    free_cuda()
    return out


def phase_moe_lm(card: str) -> dict:
    """Each moe config at its published widths cut to MOE_LM_LAYERS layers
    in bfloat16 (the weights drawn leaf by leaf on the card, each cast to
    bfloat16 as it is drawn): prefill of MOE_LM_BATCH prompts of
    MOE_LM_PROMPT tokens, then MOE_LM_STEPS greedy decode steps, finite
    logits; K8 launched once per layer per step and nothing else counted
    (counts set to 0 before the prefill, read after the last step); ms per
    step (CUDA events, median), asserted no faster than the cost report's
    bound for the step and printed beside it and the reference formula's
    floor, the CUDA kernel launches of one more step and a profile of
    LM_PROFILE_STEPS more (torch.profiler: device busy and idle share),
    peak memory; each beside the card's name and power limit."""
    out = {}
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(CFG.get(arch),
                                  n_layers=MOE_LM_LAYERS[arch])
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
        sync()
        make_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size()
                     for t in MB.tree_leaves(params))
        b, s, steps = MOE_LM_BATCH, MOE_LM_PROMPT, MOE_LM_STEPS
        cache = E.init_cache(cfg, b, s + steps + LM_PROFILE_STEPS,
                             device="cuda")
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               device="cuda")
        sync()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()        # the path starts here
        t0 = time.perf_counter()
        logits, cache = E.prefill(params, cfg, {"tokens": tokens}, cache)
        sync()
        prefill_s = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        generated = []
        events[0].record()
        for i in range(steps):
            logits, cache = E.decode_step(params, cfg, tok, cache, s + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            finite &= torch.isfinite(logits).all()
            generated.append(tok)
            events[i + 1].record()
        sync()
        launches = ops.launch_counts()   # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        assert bool(finite), f"{arch}: non-finite logits"
        want = {k: 0 for k in launches}
        want["swa_decode"] = cfg.n_layers * steps
        assert launches == want, (launches, want)
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(steps)]
        med = statistics.median(step_ms)
        per_step, kernels, _ = cuda_launches_per_call(
            lambda: E.decode_step(params, cfg, tok, cache, s + steps),
            calls=2)
        bnd = decode_bound(cfg, b, s + steps + LM_PROFILE_STEPS,
                           s + steps - 1)
        floor_ms = bnd["bound_ms"]
        # the reference's formula charges only the experts the batch's
        # top-k choices can hit; the capacity dispatch reads all E
        RL = cost_report()[1]
        ref_ms = RL.streaming_floor_bytes(bnd["rec"], 1) / RL.HBM_BW * 1e3
        hit = min(1.0, b * cfg.top_k / cfg.n_experts)
        print(f"[moe lm] {cfg.name}: {cfg.n_layers} of "
              f"{CFG.get(arch).n_layers} layers at the published widths, {cfg.param_count()} parameters, {nbytes} "
              f"bytes in {cfg.dtype} made on the card in {make_s:.1f} s; "
              f"{cfg.n_experts} experts top-{cfg.top_k}"
              + (", dense residual" if cfg.dense_residual else ""))
        print(f"[moe lm] {cfg.name} on {card}: prefill B={b} x {s} tokens "
              f"{prefill_s:.3f} s; {steps} greedy decode steps at B={b}: "
              f"median {med:.3f} ms per step (first {step_ms[0]:.3f}, min "
              f"{min(step_ms):.3f}, max {max(step_ms):.3f}), "
              f"{b / med * 1e3:.1f} tokens/s; {per_step:.0f} CUDA kernel "
              f"launches per step ({kernels / 2:.0f} kernels on the device); "
              f"peak memory {peak} bytes; K8 launches "
              f"{launches['swa_decode']} = {cfg.n_layers} x {steps}")
        print(f"[moe lm] {cfg.name} decode step: "
              f"{bound_note('moe lm', med, bnd)}; the reference formula's "
              f"floor {ref_ms:.3f} ms (it charges {hit:.2%} of the experts "
              f"at B={b}, top-{cfg.top_k} of {cfg.n_experts})")
        print(f"[moe lm] {cfg.name} greedy tokens of sequence 0: "
              f"{torch.cat(generated, 1)[0].tolist()}")
        profile = profile_decode(params, cfg, cache, tok, s + steps,
                                 tag="moe lm")
        tp_ref = (tp_reference(params, cfg, tokens, generated)
                  if arch == TP_MOE_ARCH else None)
        out[arch] = dict(layers=cfg.n_layers, params=cfg.param_count(),
                         param_bytes=nbytes, prefill_s=prefill_s,
                         step_ms_median=med, floor_ms=floor_ms,
                         ref_floor_ms=ref_ms, launches_per_step=per_step,
                         device_idle_share=profile["device_idle_share"],
                         peak_bytes=peak, k8_launches=launches["swa_decode"],
                         tp_ref=tp_ref)
        del params, cache, logits
        free_cuda()
    return out


def phase_moe_lm_check() -> dict:
    """dbrx at full width cut to MOE_CHECK_LAYERS layer in float32 (the
    weights drawn on the card, then copied to the CPU): a prompt's prefill
    and MOE_CHECK_STEPS greedy decode steps on the card (K8 once per layer
    per step), then the same on the CPU fed the card's tokens: logits
    within MOE_LOGIT_TOL at every step, greedy tokens and every layer's
    expert choices exactly wherever the margin allows. The CPU part runs
    last of all phases: no phase timed on the host's clock follows it."""
    cfg = dataclasses.replace(CFG.get(MOE_CHECK_ARCH),
                              n_layers=MOE_CHECK_LAYERS, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
    tokens = torch.randint(0, cfg.vocab, (MOE_CHECK_BATCH, MOE_CHECK_PROMPT),
                           generator=gen, device="cuda").cpu()
    ops.reset_launch_counts()        # the card's path starts here
    card = lm_serve(params, cfg, tokens, MOE_CHECK_STEPS, "cuda")
    sync()
    k8 = ops.launch_counts()["swa_decode"]      # ... and ends here
    assert k8 == cfg.n_layers * MOE_CHECK_STEPS, k8
    params = MB.tree_map(lambda a: a.cpu(), params)
    free_cuda()
    t0 = time.perf_counter()
    cpu = lm_serve(params, cfg, tokens, MOE_CHECK_STEPS, "cpu",
                    feed=card["fed"])
    cpu_s = time.perf_counter() - t0
    greedy = sum(check_greedy(g, w, f"{cfg.name} step {i}") for i, (g, w)
                 in enumerate(zip(card["logits"], cpu["logits"])))
    routes, no_margin = check_routes(card["routes"], cpu["routes"],
                                     cfg.top_k, cfg.name)
    err = max(float((g - w).abs().max())
              for g, w in zip(card["logits"], cpu["logits"]))
    scale = max(float(w.abs().max()) for w in cpu["logits"])
    print(f"[moe lm check] {cfg.name} at full width, {cfg.n_layers} layer, "
          f"float32 ({cfg.param_count()} parameters): prefill of "
          f"{MOE_CHECK_BATCH} x {MOE_CHECK_PROMPT} tokens + {MOE_CHECK_STEPS}"
          f" greedy decode steps (K8 x {k8}) on the card against the CPU "
          f"({cpu_s:.1f} s): max |err| {err:.3g} (bar {MOE_LOGIT_TOL}; "
          f"logits up to {scale:.3g}), {greedy} greedy tokens equal, expert "
          f"choices equal for {routes} token-layers ({no_margin} without "
          "margin)")
    del params
    return dict(err=err, k8_launches=k8)


# -- 8e. model parallelism: the "tp" layout over ranks ------------------------

def tp_shard(mp, cfg, seed: int) -> dict:
    """Rank mp's shard of the params `MB.materialize` draws on the CPU
    from `seed`, on the rank's card."""
    tmpl = Z.templates(cfg)
    full = MB.materialize(tmpl, torch.Generator().manual_seed(seed))
    shard = MB.shard_params(full, tmpl, SHD.param_layouts(tmpl, mp.mesh),
                            mp)
    return MB.tree_map(lambda a: a.to(mp.device), shard)


def parity_cfg(key: str):
    """The float32 smoke config of a parity case: `key` an arch, or a name
    of QSPLIT_PARITY / QSPLIT_MQA (an arch with its head counts
    replaced)."""
    arch, over = {**QSPLIT_PARITY, **QSPLIT_MQA}.get(key, (key, {}))
    return dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32,
                               **over)


def tp_parity_rank(mp, cases, variants=("auto", *SEQ_VARIANTS)) -> dict:
    """[tp parity] and [seq parity] (or [tp kvrep parity], "auto" alone;
    [tp qsplit parity]), one rank: for each (key, tokens, feed) its shard
    of `parity_cfg(key)` (seed 3), prefill and decode fed `feed` through
    lm_serve
    under each of `variants` ("auto": the "tp" layout; a sequence-sharded
    one: the "seq" cache); the launch counts set to 0 before each run and
    read after. Keys "arch/variant"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, tokens, feed in cases:
        cfg = parity_cfg(arch)
        params = tp_shard(mp, cfg, 3)
        for variant in variants:
            vcfg = dataclasses.replace(cfg, attn_shard=variant)
            ops.reset_launch_counts()        # this rank's path starts here
            mp.reset_counts()
            run = lm_serve(params, vcfg, torch.as_tensor(tokens),
                           len(feed), mp.device, feed=[torch.as_tensor(f)
                                                       for f in feed], mp=mp)
            sync()
            counts = ops.launch_counts()     # ... and ends here
            out[f"{arch}/{variant}"] = dict(
                logits=run["logits"], routes=run["routes"],
                k8=counts["swa_decode"],
                k8_partial=counts["swa_decode_partial"],
                calls=dict(mp.calls))
    return out


def tp_parity_refs(archs) -> tuple[dict, list]:
    """The card's unsharded runs that [tp parity] and [tp kvrep parity]
    hold their ranks to, per arch: its smoke config in float32 drawn on
    the CPU from seed 3, a prefill of TP_PARITY_BATCH x TP_PARITY_PROMPT
    tokens (past gemma3-smoke's window: its rings wrap) and
    TP_PARITY_STEPS greedy decode steps (lm_serve); and the ranks' cases
    (arch, tokens, the tokens fed)."""
    refs, cases = {}, []
    for arch in archs:
        cfg = parity_cfg(arch)
        params = MB.tree_map(lambda a: a.to("cuda"), MB.materialize(
            Z.templates(cfg), torch.Generator().manual_seed(3)))
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (TP_PARITY_BATCH, TP_PARITY_PROMPT)))
        refs[arch] = lm_serve(params, cfg, tokens, TP_PARITY_STEPS, "cuda")
        cases.append((arch, tokens.numpy(),
                      [f.numpy() for f in refs[arch]["fed"]]))
        del params
    free_cuda()
    return refs, cases


def check_tp_parity(arch, got, want, tag, backend, n_cards, card) -> dict:
    """One smoke config's "tp" run on every rank (`got`, per rank, from
    tp_parity_rank) against the card's unsharded run `want`: logits within
    TP_RTOL / TP_ATOL, greedy tokens exact where the margin exceeds
    TP_TOKEN_MARGIN, expert choices exact where the router leaves
    ROUTE_LOG_MARGIN, the ranks' logits bit-equal, K8 = layers x steps on
    every rank."""
    cfg = parity_cfg(arch)
    err, greedy, routes = 0.0, 0, 0
    for r, rank in enumerate(got):
        assert rank["k8"] == cfg.n_layers * TP_PARITY_STEPS, (tag, arch, r,
                                                              rank["k8"])
        for i, (g, w) in enumerate(zip(rank["logits"], want["logits"])):
            g = torch.from_numpy(g)
            torch.testing.assert_close(
                g, w, rtol=TP_RTOL, atol=TP_ATOL,
                msg=lambda m: f"[{tag}] {arch} rank {r} step {i}: {m}")
            err = max(err, float((g - w).abs().max()))
            top2 = torch.topk(w, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > TP_TOKEN_MARGIN
            assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure])
            greedy += int(sure.sum())
            np.testing.assert_array_equal(got[0]["logits"][i],
                                          rank["logits"][i])
        if cfg.arch_type == "moe":
            routes += check_routes(
                [(torch.from_numpy(p), torch.from_numpy(i))
                 for p, i in rank["routes"]], want["routes"], cfg.top_k,
                f"[{tag}] {arch} rank {r}")[0]
    assert greedy > 0, (tag, arch)
    print(f"[{tag}] {cfg.name} (float32; {cfg.n_heads} query / "
          f"{cfg.n_kv_heads} kv heads) over {len(got)} ranks ({backend}, "
          f"{n_cards} card(s), {card}) against the card's unsharded run: "
          f"prefill of {TP_PARITY_BATCH} x {TP_PARITY_PROMPT} tokens + "
          f"{TP_PARITY_STEPS} decode steps fed its greedy tokens, max |err| "
          f"{err:.3g} (bars rtol {TP_RTOL}, atol {TP_ATOL}), {greedy} greedy "
          f"tokens equal"
          + (f", expert choices equal for {routes} token-layers"
             if routes else "")
          + f"; the ranks' logits bit-equal; K8 per rank "
          f"{[rank['k8'] for rank in got]} = {cfg.n_layers} x "
          f"{TP_PARITY_STEPS}; collectives per rank {got[0]['calls']}")
    return dict(err=err, k8_per_rank=[rank["k8"] for rank in got])


def phase_tp_parity(card: str) -> dict:
    """[tp parity] gemma3-smoke and dbrx-smoke in float32 over
    TP_PARITY_WORLD ranks against the card's unsharded run of the same
    params (`tp_parity_refs`), the ranks fed the unsharded run's greedy
    tokens (`check_tp_parity`); then [seq parity] (`seq_parity_check`)."""
    t0 = time.perf_counter()
    backend, devices = transport(TP_PARITY_WORLD, "cuda")
    refs, cases = tp_parity_refs((*TP_PARITY_ARCHS, *QSPLIT_MQA))
    ranks = spawn_ranks(TP_PARITY_WORLD, tp_parity_rank, (cases,),
                        device="cuda", timeout_s=600)
    n_cards = len(set(map(str, devices)))
    out = {}
    for arch in (*TP_PARITY_ARCHS, *QSPLIT_MQA):
        tag = "tp qsplit parity" if arch in QSPLIT_MQA else "tp parity"
        out[arch] = check_tp_parity(
            arch, [rank[f"{arch}/auto"] for rank in ranks], refs[arch],
            tag, backend, n_cards, card)
        for variant in SEQ_VARIANTS:
            out[f"{arch}/{variant}"] = seq_parity_check(
                parity_cfg(arch), variant,
                [rank[f"{arch}/{variant}"] for rank in ranks], refs[arch],
                backend, card,
                tag="tp qsplit parity" if arch in QSPLIT_MQA
                else "seq parity")
    print(f"[tp parity] done in {time.perf_counter() - t0:.1f} s (with "
          f"[seq parity] and [tp qsplit parity]'s {list(QSPLIT_MQA)} over "
          f"{TP_PARITY_WORLD} ranks)")
    return out


def seq_parity_check(cfg, variant, got, want, backend, card,
                     tag="seq parity", wire_routes=False) -> dict:
    """[seq parity] (or [seq families parity], `tag`) one smoke config
    under one sequence-sharded variant
    (`got` per rank, from tp_parity_rank) against the card's unsharded run
    `want`: "seqkv" at TP_RTOL / TP_ATOL, greedy tokens exact where the
    margin exceeds TP_TOKEN_MARGIN; "shmap" (bfloat16 wires) within one
    bfloat16 unit of the step's largest logit, greedy tokens exact where
    the margin exceeds twice that; expert choices exact where the router
    leaves ROUTE_LOG_MARGIN (with wire_routes, under "shmap": at the
    margin its bfloat16 wires leave, `check_rank_routes`: every router
    log-probability within TP_BF16_STD_TOL of the call's std, the
    choices equal where the k-th and (k+1)-th are twice the largest
    difference apart); the ranks' logits bit-equal; K8's partials
    mode launched once per attention layer a step on every rank
    (`k8_decode_calls`: no block of these caches is empty, the prompt
    fills every rank's block) and K8 itself never."""
    tag = f"[{tag}] {cfg.name} {variant}"
    per_step = k8_decode_calls(cfg)
    err, share, greedy, routes = 0.0, 0.0, 0, 0
    for r, rank in enumerate(got):
        assert rank["k8_partial"] == per_step * TP_PARITY_STEPS \
            and rank["k8"] == 0, (tag, r, rank["k8_partial"], rank["k8"])
        for i, (g, w) in enumerate(zip(rank["logits"], want["logits"])):
            g = torch.from_numpy(g)
            np.testing.assert_array_equal(got[0]["logits"][i],
                                          rank["logits"][i])
            if variant == "shmap":
                rtol, atol = 0.0, SEQ_BF16_UNIT * float(w.abs().max())
                margin = 2 * atol
            else:
                rtol, atol, margin = TP_RTOL, TP_ATOL, TP_TOKEN_MARGIN
            torch.testing.assert_close(
                g, w, rtol=rtol, atol=atol,
                msg=lambda m: f"{tag} rank {r} step {i}: {m}")
            e = float((g - w).abs().max())
            err, share = max(err, e), max(share, e / atol)
            top2 = torch.topk(w, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > margin
            assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure]), tag
            greedy += int(sure.sum())
        if cfg.arch_type == "moe" and not (wire_routes
                                           and variant == "shmap"):
            routes += check_routes(
                [(torch.from_numpy(p), torch.from_numpy(i))
                 for p, i in rank["routes"]], want["routes"], cfg.top_k,
                f"{tag} rank {r}")[0]
    if cfg.arch_type == "moe" and wire_routes and variant == "shmap":
        routes = check_rank_routes([rank["routes"] for rank in got],
                                   want["routes"], cfg.top_k, tag)[2]
    assert greedy > 0, tag
    print(f"{tag} (float32, the \"seq\" cache) over {len(got)} ranks "
          f"({backend}, {card}) against the card's unsharded run: max |err| "
          f"{err:.3g}, {share:.3f} of the largest atol "
          + ("(one bfloat16 unit of the step's largest logit)"
             if variant == "shmap" else f"(rtol {TP_RTOL}, atol {TP_ATOL})")
          + f", {greedy} greedy tokens equal"
          + (f", expert choices equal for {routes} token-layers"
             if routes else "")
          + f"; the ranks' logits bit-equal; K8 partials per rank "
          f"{[rank['k8_partial'] for rank in got]} = {per_step} x "
          f"{TP_PARITY_STEPS}, K8 0; collectives per rank {got[0]['calls']}")
    return dict(err=err, share=share,
                k8_partial_per_rank=[rank["k8_partial"] for rank in got])


def tp_lm_rank(mp, jobs, parity=(), qsplit=(), train=None) -> dict:
    """[tp lm] / [tp moe] / [tp kvrep lm] and [seq lm] (or [tp qsplit
    lm]), one rank: for each job its shard of the config at full width
    (cut to job["layers"] where given) in bfloat16, drawn as the unsharded
    phase drew it (seed 0 on the card) keeping only this rank's pieces,
    served by `tp_lm_serve` (key: job["key"], default the arch; its
    prefill under job["prefill"] where given; its layout job["mode"],
    default "tp"); where job["seq"] names a
    sequence-sharded variant, the same shard served again under it with
    the "seq" cache (key: "arch/seq"). First [tp kvrep parity]:
    `tp_parity_rank` of the `parity` cases under "auto" (key: "kvrep
    parity"), and [tp qsplit parity]: of the `qsplit` cases under every
    variant (key: "qsplit parity"). Last, where `train` (arch, layers, lr)
    is given, [shmap train lm]: `launch.train.train_lm_rank` of it under
    "tp" + "shmap" (key: "train"; its launch counts 0 before, read
    after)."""
    dev = mp.device
    out = {"kvrep parity": tp_parity_rank(mp, parity, ("auto",)),
           "qsplit parity": tp_parity_rank(mp, qsplit)}
    for job in jobs:
        cfg = CFG.get(job["arch"])
        if job["layers"]:
            cfg = dataclasses.replace(cfg, n_layers=job["layers"])
        tmpl = Z.templates(cfg)
        t0 = time.perf_counter()
        mode = job.get("mode", "tp")
        layout = TrainLayout(mode, SHD.param_layouts(tmpl, mp.mesh, mode))
        params = MB.materialize_shard(
            tmpl, torch.Generator(device=dev).manual_seed(0), cfg.dtype,
            layout.specs, mp)
        sync()
        make_s = time.perf_counter() - t0
        shard_bytes = sum(a.numel() * a.element_size()
                          for a in MB.tree_leaves(params))
        pre = (dataclasses.replace(cfg, attn_shard=job["prefill"])
               if job.get("prefill") else None)
        t0 = time.perf_counter()
        out[job.get("key", job["arch"])] = dict(
            make_s=make_s, shard_bytes=shard_bytes,
            **tp_lm_serve(mp, params, cfg, job, prefill_cfg=pre,
                          layout=None if mode == "tp" else layout),
            s=time.perf_counter() - t0)
        if job["seq"]:
            out[f"{job['arch']}/seq"] = tp_lm_serve(
                mp, params, dataclasses.replace(cfg, attn_shard=job["seq"]),
                job, prefill_cfg=pre)
        del params
        free_cuda()
    if train is not None:
        arch, layers, lr = train
        ops.reset_launch_counts()            # this rank's path starts here
        run = TLT.train_lm_rank(mp, arch, layers, "tp", LM_TRAIN_STEPS,
                                LM_TRAIN_BATCH, LM_TRAIN_SEQ, 0, False, lr,
                                attn_shard="shmap")
        sync()
        run["launches"] = ops.launch_counts()    # ... and ends here
        out["train"] = run
        free_cuda()
    return out


def tp_lm_serve(mp, params, cfg, job, frontend=None,
                prefill_cfg=None, layout=None) -> dict:
    """One rank's prefill of job["tokens"] (over an encdec model's
    `frontend` frames; under `prefill_cfg`'s attn_shard where given) and
    decode steps fed job["feed"], every moe layer's
    call routed to job["gates"]'s experts (`routed(feed=)`) where given,
    into a cache of the layout cfg's attn_shard gives
    (`engine.cache_policy`): logits and the rank's own routes (kept on the
    card until the last step), the launch counts (0 before the prefill,
    read after the last step), the cache's bytes, peak memory, prefill s,
    ms per step (CUDA events), the collectives of the decode steps, and
    `passes`: what [pod costs] traces again on `meta` (`pass_counts` of
    the prefill and of each decode step, the run's sizes and config).
    layout: the params' (`engine.serve_weights`; None: "tp")."""
    dev = mp.device
    tokens = torch.as_tensor(job["tokens"]).to(dev)
    feed = [torch.as_tensor(f).to(dev) for f in job["feed"]]
    gates = (iter([torch.as_tensor(g).to(dev) for g in job["gates"]])
             if job["gates"] is not None else None)
    b, s = tokens.shape
    batch, enc_len = {"tokens": tokens}, 0
    if frontend is not None:
        batch["frontend"], enc_len = frontend, frontend.shape[1]
    max_len = job.get("max_len") or s + len(feed)
    cache = E.init_cache(cfg, b, max_len, enc_len, device=dev, mp=mp)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    passes = dict(arch=job["arch"], n_layers=cfg.n_layers,
                  n_enc_layers=cfg.n_enc_layers, attn_shard=cfg.attn_shard,
                  prefill_shard=(prefill_cfg or cfg).attn_shard,
                  mode="tp" if layout is None else layout.mode,
                  smoke=cfg.name == CFG.get_smoke(job["arch"]).name,
                  dtype=cfg.dtype, ssm_impl=cfg.ssm_impl, mesh=mp.mesh.sizes,
                  batch=b * mp.data_world, prompt=s, max_len=max_len,
                  enc_len=enc_len, decode=[])
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                # this rank's path starts here
    mp.reset_counts()
    t0 = time.perf_counter()
    (lg, cache), routes = routed(E.prefill, params, prefill_cfg or cfg,
                                 batch, cache, mp, layout, host=False,
                                 feed=gates)
    sync()
    prefill_s = time.perf_counter() - t0
    passes["prefill"] = pass_counts(mp, {})
    logits = [lg[:, -1]]
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(feed) + 1)]
    calls, nbytes = collections.Counter(), collections.Counter()
    events[0].record()
    for i, tok in enumerate(feed):
        before = ops.launch_counts()
        mp.reset_counts()
        (lg, cache), r = routed(E.decode_step, params, cfg, tok, cache,
                                s + i, mp, layout, host=False, feed=gates)
        logits.append(lg[:, -1])
        routes += r
        events[i + 1].record()
        passes["decode"].append(pass_counts(mp, before))
        calls.update(mp.calls)
        nbytes.update(mp.bytes)
    sync()
    counts = ops.launch_counts()             # ... and ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(len(feed))]
    out = dict(
        logits=[a.cpu() for a in logits],
        routes=[(p.cpu(), i.cpu()) for p, i in routes],
        k8=counts["swa_decode"], k8_partial=counts["swa_decode_partial"],
        cache_bytes=cache_bytes, prefill_s=prefill_s, step_ms=step_ms,
        peak=torch.cuda.max_memory_allocated(), calls=dict(calls),
        bytes=dict(nbytes), passes=passes)
    del cache, lg
    free_cuda()
    return out


def pass_counts(mp, before: dict) -> dict:
    """A pass's counts on this rank: its collectives (calls and bytes put
    in, by kind, `mp`'s since its last reset) and K8's launches, whole and
    partials, since the launch counts `before` (its counters since their
    reset where empty)."""
    now = ops.launch_counts()
    return dict(calls=dict(mp.calls), bytes=dict(mp.bytes), **{
        key: now[name] - before.get(name, 0) for key, name in (
            ("k8", "swa_decode"), ("k8_partial", "swa_decode_partial"))})


def check_rank_routes(rank_routes, want, k: int, tag: str
                      ) -> tuple[float, float, int, int]:
    """Each rank's own routing (`routes` of `routed`, as numpy) against
    the unsharded run's `want`, layer call by layer call. Every router
    log-probability within TP_BF16_STD_TOL of the standard deviation of
    the call's unsharded ones (the router's logits round to bfloat16, at
    their own magnitude, on inputs that already differ by a few bfloat16
    units: the output logits' bar, at the router). Then, with d the
    call's largest difference on any rank, the set of each token's k
    experts equal wherever the unsharded k-th and (k+1)-th
    log-probabilities are more than 2d apart, where no difference within
    d can swap them (the order within the k follows near-equal
    probabilities and moves no token in a buffer). Returns (the largest
    d, its largest share of its bar, rank-token-layers compared, not
    compared)."""
    for r, got in enumerate(rank_routes):
        assert len(got) == len(want), (tag, r, len(got), len(want))
    worst_d = worst_share = 0.0
    compared = skipped = 0
    for j, (w_p, w_i) in enumerate(want):
        w_log = w_p.clamp_min(1e-30).log()
        g_logs = [torch.from_numpy(got[j][0]).clamp_min(1e-30).log()
                  for got in rank_routes]
        d = max(float((g - w_log).abs().max()) for g in g_logs)
        bar = TP_BF16_STD_TOL * float(w_log.std())
        assert d <= bar, (f"[{tag}] call {j}: a router log-probability "
                          f"{d:.4g} from the unsharded run's, over {bar:.4g}")
        worst_d, worst_share = max(worst_d, d), max(worst_share, d / bar)
        top = w_log.sort(-1, descending=True).values
        sure = (top[:, k - 1] - top[:, k]) > 2 * d
        for r, got in enumerate(rank_routes):
            assert torch.equal(
                torch.from_numpy(got[j][1])[sure].sort(-1).values,
                w_i[sure].sort(-1).values), (tag, r, j)
            compared += int(sure.sum())
            skipped += int((~sure).sum())
    return worst_d, worst_share, compared, skipped


def check_tp_logits(got, ref, tag, spread=None) -> tuple[float, int]:
    """Each rank's logits (`got`: per rank, the prefill's and each decode
    step's) against the unsharded teacher-fed rerun `ref`: every row
    within TP_BF16_STD_TOL of the step's logit standard deviation, greedy
    tokens equal where the unsharded top-2 margin exceeds the bar, the
    ranks' logits bit-equal. spread (per step, `one_card_spread`): where
    given, a step's bar is the larger of that and TP_SPREAD_FACTOR x the
    step's spread between two one-card runs of the same function. Returns
    (the largest share of the bar, greedy tokens compared)."""
    worst, greedy = 0.0, 0
    for r, rank in enumerate(got):
        for i, (g, w) in enumerate(zip(rank, ref["logits"])):
            np.testing.assert_array_equal(got[0][i], g)
            g, w = torch.from_numpy(g), w.float()
            tol = TP_BF16_STD_TOL * float(w.std())
            if spread is not None:
                tol = max(tol, TP_SPREAD_FACTOR * spread[i])
            err = (g - w).abs().amax(-1)
            assert bool((err <= tol).all()), (
                f"[{tag}] rank {r} step {i}: max |err| {err.tolist()} over "
                f"{tol:.4g}")
            worst = max(worst, float(err.max()) / tol)
            top2 = torch.topk(w, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > tol
            assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure]), (
                f"[{tag}] rank {r} step {i}: greedy tokens")
            greedy += int(sure.sum())
    return worst, greedy


def tp_lm_reference(arch: str, layers: int, batch: int, prompt: int,
                    tag: str, card: str) -> dict:
    """What [tp lm] / [tp kvrep lm] hold their ranks to: the arch at full
    width cut to `layers` layers in bfloat16 on one card, drawn from seed
    0 on the card (the tokens the generator's next draw), a prefill of
    batch x prompt tokens and TP_STEPS greedy decode steps (lm_serve:
    logits on the CPU, the tokens fed)."""
    cfg = dataclasses.replace(CFG.get(arch), n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device="cuda")
    nbytes = sum(a.numel() * a.element_size()
                 for a in MB.tree_leaves(params))
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = lm_serve(params, cfg, tokens, TP_STEPS, "cuda")
    sync()
    run_s = time.perf_counter() - t0
    assert all(bool(torch.isfinite(a).all()) for a in ref["logits"])
    print(f"[{tag}] {cfg.name} unsharded on one card ({card}): "
          f"{cfg.param_count()} parameters, {nbytes} bytes in {cfg.dtype}, "
          f"{cfg.n_layers} layers, {cfg.n_heads} query / {cfg.n_kv_heads} kv "
          f"heads of {cfg.hd}; prefill {batch} x {prompt} tokens + "
          f"{TP_STEPS} greedy decode steps in {run_s:.3f} s (logits copied "
          f"to the host each step); peak memory "
          f"{torch.cuda.max_memory_allocated()} bytes; logits finite")
    del params
    free_cuda()
    return dict(tokens=tokens.cpu(), **ref)


def phase_tp_lm(card: str, moe_ref: dict) -> dict:
    """[tp lm] gemma3-27b at full width and TP_LM_LAYERS layers, [tp moe]
    dbrx-132b at [moe lm]'s depth and [tp kvrep lm] starcoder2-3b at
    KVREP_LM_LAYERS layers (its 2 kv heads undivided by the ranks), in
    bfloat16 over TP_WORLD ranks (one spawn for all, [tp kvrep parity] in
    it too), against `tp_lm_reference`'s unsharded runs and [moe lm]'s
    teacher-fed rerun: the logits of
    the prefill and of each of TP_STEPS decode steps within
    TP_BF16_STD_TOL of the step's logit standard deviation on every row,
    greedy tokens equal where the unsharded top-2 margin exceeds the bar
    (`check_tp_logits`); dbrx's ranks routed to the unsharded run's
    experts in every layer (`routed(feed=)`, so no token's path parts from
    the reference's), and their own routing held to it
    (`check_rank_routes`); the ranks' logits bit-equal, K8 = layers x
    steps on every rank; per rank the shard's bytes, the peak memory,
    prefill s, median ms a step and the collectives a step. Then [seq lm]:
    gemma3-27b on the same shards under SEQ_LM_VARIANT with the "seq"
    cache (`seq_lm_report`). [tp kvrep parity]: KVREP_PARITY_ARCHS' smoke
    configs against `tp_parity_refs` (`check_tp_parity`)."""
    t0 = time.perf_counter()
    backend, devices = transport(TP_WORLD, "cuda")
    n_cards = len(set(map(str, devices)))
    parity_refs, parity_cases = tp_parity_refs(KVREP_PARITY_ARCHS)
    qsplit_refs, qsplit_cases = tp_parity_refs(tuple(QSPLIT_PARITY))
    jobs = [dict(arch=LM_ARCH, layers=TP_LM_LAYERS, seq=SEQ_LM_VARIANT,
                 ref=tp_lm_reference(LM_ARCH, TP_LM_LAYERS, LM_BATCH,
                                     LM_PROMPT, "tp lm", card)),
            dict(arch=TP_MOE_ARCH, layers=MOE_LM_LAYERS[TP_MOE_ARCH],
                 ref=moe_ref, seq=None),
            dict(arch=KVREP_LM_ARCH, layers=KVREP_LM_LAYERS, seq=None,
                 ref=tp_lm_reference(KVREP_LM_ARCH, KVREP_LM_LAYERS,
                                     KVREP_LM_BATCH, KVREP_LM_PROMPT,
                                     "tp kvrep lm", card))]
    ref_s = time.perf_counter() - t0
    ranks = spawn_ranks(
        TP_WORLD, tp_lm_rank,
        ([dict(arch=j["arch"], layers=j["layers"], seq=j["seq"],
               tokens=j["ref"]["tokens"].numpy(),
               feed=[f.numpy() for f in j["ref"]["fed"]],
               gates=([i.numpy() for _, i in j["ref"]["routes"]]
                      if j["arch"] == TP_MOE_ARCH else None))
          for j in jobs], parity_cases, qsplit_cases),
        device="cuda", timeout_s=900)
    spawn_s = time.perf_counter() - t0 - ref_s
    out = {"kvrep parity": {
        arch: check_tp_parity(
            arch, [rank["kvrep parity"][f"{arch}/auto"] for rank in ranks],
            parity_refs[arch], "tp kvrep parity", backend, n_cards, card)
        for arch in KVREP_PARITY_ARCHS}}
    out["qsplit parity"] = {}
    for key in QSPLIT_PARITY:
        got = {v: [rank["qsplit parity"][f"{key}/{v}"] for rank in ranks]
               for v in ("auto", *SEQ_VARIANTS)}
        out["qsplit parity"][key] = check_tp_parity(
            key, got["auto"], qsplit_refs[key], "tp qsplit parity", backend,
            n_cards, card)
        for variant in SEQ_VARIANTS:
            out["qsplit parity"][f"{key}/{variant}"] = seq_parity_check(
                parity_cfg(key), variant, got[variant], qsplit_refs[key],
                backend, card, tag="tp qsplit parity", wire_routes=True)
    tags = {LM_ARCH: "tp lm", TP_MOE_ARCH: "tp moe",
            KVREP_LM_ARCH: "tp kvrep lm"}
    for job in jobs:
        arch, ref, layers = job["arch"], job["ref"], job["layers"]
        tag = tags[arch]
        cfg = CFG.get(arch)
        b, s = ref["tokens"].shape
        for r, rank in enumerate(ranks):
            assert rank[arch]["k8"] == layers * TP_STEPS, (tag, r,
                                                          rank[arch]["k8"])
        worst, greedy = check_tp_logits(
            [rank[arch]["logits"] for rank in ranks], ref, tag)
        if cfg.arch_type == "moe":
            dlog, dshare, compared, skipped = check_rank_routes(
                [rank[arch]["routes"] for rank in ranks], ref["routes"],
                cfg.top_k, tag)
        held = kv_heads(cfg.n_heads, cfg.n_kv_heads, TP_WORLD, 0)
        print(f"[{tag}] {cfg.name}, {layers} of {cfg.n_layers} layers in "
              f"bfloat16 ({cfg.n_heads} query / {cfg.n_kv_heads} kv heads, "
              f"{cfg.n_heads // TP_WORLD} / {len(held)} a rank), over "
              f"{TP_WORLD} ranks ({backend}; {n_cards} "
              f"card(s): {card}): prefill {b} x {s} tokens + {TP_STEPS} "
              f"decode steps fed the unsharded run's greedy tokens; logits "
              f"within {worst:.3f} of the bar ({TP_BF16_STD_TOL} x the "
              f"step's logit std) on all {len(ranks) * (TP_STEPS + 1) * b} "
              f"rank-rows, "
              f"{greedy} greedy tokens equal (where the top-2 margin "
              f"exceeds the bar); the ranks' logits bit-equal"
              + (f"; every layer routed to the unsharded run's experts, "
                 f"the ranks' own router log-probabilities within "
                 f"{dlog:.4g} of it ({dshare:.3f} of the bar, "
                 f"{TP_BF16_STD_TOL} x the call's std) and their expert "
                 f"choices equal for {compared} rank-token-layers, all "
                 f"those whose k-th and (k+1)-th are more than twice the "
                 f"call's largest difference apart ({skipped} are not)"
                 if cfg.arch_type == "moe" else ""))
        for r, rank in enumerate(ranks):
            got = rank[arch]
            med = statistics.median(got["step_ms"])
            print(f"[{tag}]   rank {r}: shard {got['shard_bytes']} bytes "
                  f"drawn in {got['make_s']:.2f} s; cache "
                  f"{got['cache_bytes']} bytes; prefill "
                  f"{got['prefill_s']:.3f} s; median {med:.3f} ms a decode "
                  f"step (min {min(got['step_ms']):.3f}, max "
                  f"{max(got['step_ms']):.3f}); peak memory {got['peak']} "
                  f"bytes; K8 launches {got['k8']} = {layers} x {TP_STEPS}; "
                  f"collectives a step "
                  f"{ {k: v / TP_STEPS for k, v in got['calls'].items()} }, "
                  f"bytes a step {sum(got['bytes'].values()) / TP_STEPS:.0f}")
        out[arch] = dict(
            k8_per_rank=[rank[arch]["k8"] for rank in ranks],
            step_ms_median=[statistics.median(rank[arch]["step_ms"])
                            for rank in ranks],
            prefill_s=[rank[arch]["prefill_s"] for rank in ranks],
            peak_bytes=[rank[arch]["peak"] for rank in ranks],
            cache_bytes=[rank[arch]["cache_bytes"] for rank in ranks],
            calls_per_step=[{k: v / TP_STEPS
                             for k, v in rank[arch]["calls"].items()}
                            for rank in ranks],
            shard_bytes=[rank[arch]["shard_bytes"] for rank in ranks],
            passes=[rank[arch]["passes"] for rank in ranks],
            worst_share_of_bar=worst, backend=backend, cards=n_cards,
            **({"route_log_err": dlog, "route_share_of_bar": dshare}
               if cfg.arch_type == "moe" else {}))
        if job["seq"]:
            out[f"{arch}/seq"] = dict(seq_lm_report(
                [rank[f"{arch}/seq"] for rank in ranks], ref,
                dataclasses.replace(cfg, n_layers=layers), job["seq"],
                backend, n_cards, card), shard_bytes=out[arch]["shard_bytes"])
    print(f"[tp lm] done in {time.perf_counter() - t0:.1f} s (the "
          f"unsharded reference runs {ref_s:.1f} s, the ranks {spawn_s:.1f} "
          f"s of it, [seq lm], [tp kvrep parity], [tp kvrep lm] and [tp "
          f"qsplit parity] included); the times are "
          f"{TP_WORLD} processes "
          + ("sharing one card over gloo, not a sharded deployment's"
             if n_cards < TP_WORLD else f"on {n_cards} cards over {backend}"))
    return out


def zero3_qsplit_check(job, got, backend, n_cards, card) -> dict:
    """[tp qsplit lm]'s "zero3" run of ZERO3_QSPLIT_ARCH (every rank's,
    `got`) against the unsharded run of the same cut at [tp lm]'s bar
    (`check_tp_logits`: the ranks' logits bit-equal too), K8 =
    k8_decode_calls x TP_STEPS a rank ("tp"'s) and no partials; prints per
    rank the K8 launches, the shard's and the cache's bytes, peak memory,
    prefill s, the median ms a step, the collectives a step by kind with
    their bytes, and the run's seconds."""
    arch, layers, ref = job["arch"], job["layers"], job["ref"]
    cfg = dataclasses.replace(CFG.get(arch), n_layers=layers)
    b, s = ref["tokens"].shape
    want_k8 = k8_decode_calls(cfg) * TP_STEPS
    for r, run in enumerate(got):
        assert run["k8"] == want_k8 and run["k8_partial"] == 0, (
            r, run["k8"], run["k8_partial"])
    worst, greedy = check_tp_logits([run["logits"] for run in got], ref,
                                    "tp qsplit lm zero3")
    print(f"[tp qsplit lm] {cfg.name}, {layers} of "
          f"{CFG.get(arch).n_layers} layers in bfloat16 ({cfg.n_heads} "
          f"query / {cfg.n_kv_heads} kv heads) under \"zero3\" over 1 x "
          f"{QSPLIT_WORLD} ranks ({backend}; {n_cards} card(s): {card}): "
          f"each rank's zero3 shard ({got[0]['shard_bytes']} bytes; the "
          f"weights cut on embed over all {QSPLIT_WORLD} ranks) gathered a "
          f"sublayer at a time and narrowed to its \"tp\" pieces; prefill "
          f"{b} x {s} tokens, {TP_STEPS} decode steps fed the unsharded "
          f"run's greedy tokens into the \"tp\" cache; logits within "
          f"{worst:.3f} of the bar ({TP_BF16_STD_TOL} x the step's logit "
          f"std) on all {len(got) * (TP_STEPS + 1) * b} rank-rows, {greedy} "
          f"greedy tokens equal; the ranks' logits bit-equal; "
          f"{got[0]['s']:.1f} s")
    for r, run in enumerate(got):
        calls = {k: (v / TP_STEPS, run["bytes"][k] / TP_STEPS)
                 for k, v in run["calls"].items()}
        print(f"[tp qsplit lm]   zero3 rank {r}: K8 {run['k8']} = "
              f"{k8_decode_calls(cfg)} x {TP_STEPS}; cache "
              f"{run['cache_bytes']} bytes; peak memory {run['peak']} bytes; "
              f"prefill {run['prefill_s']:.3f} s; median "
              f"{statistics.median(run['step_ms']):.3f} ms a decode step; "
              f"collectives a step (calls, bytes) {calls}")
    return dict(launches_per_rank=[run["k8"] for run in got],
                step_ms_median=[statistics.median(run["step_ms"])
                                for run in got],
                prefill_s=[run["prefill_s"] for run in got],
                peak_bytes=[run["peak"] for run in got],
                cache_bytes=[run["cache_bytes"] for run in got],
                shard_bytes=[run["shard_bytes"] for run in got],
                passes=[run["passes"] for run in got],
                worst_share_of_bar=worst, seconds=got[0]["s"])


def phase_tp_qsplit_lm(card: str) -> dict:
    """[tp qsplit lm] and [shmap train lm] in one spawn of QSPLIT_WORLD
    ranks sharing the card (gloo) on a 1 x QSPLIT_WORLD mesh, the
    unsharded runs first (never beside the spawn). [tp qsplit lm]: each
    of QSPLIT_LM_ARCHS (their query heads split: 1.5 and 3.5 a rank) at
    full width cut to its layers, bfloat16, against `tp_lm_reference`'s
    unsharded run of the same cut: the prefill under QSPLIT_PREFILL, then
    decode into the "heads" cache under "auto" (whole K8 on the heads a
    rank's columns touch) and into the "seq" cache under QSPLIT_SEQ (K8's
    partials), each at [tp lm]'s bar (`check_tp_logits`), the ranks'
    logits bit-equal, K8 (or its partials) = layers x steps a rank; per
    rank the K8 launches, the cache's bytes, peak memory, prefill s, the
    median ms a step and the collectives a step by kind. [shmap train
    lm]: SHMAP_LM_ARCH's losses against `shmap_lm_reference`'s
    one-process run of the same semantics on the card, step 1's at
    FSDP_LOSS_TOL and every step's within SHMAP_LM_BAR, each rank's
    params + m + v its pieces' bytes, the ranks holding the same pieces of
    a leaf holding equal bits of it (`shared_bits`), no kernel
    launched."""
    t0 = time.perf_counter()
    backend, devices = transport(QSPLIT_WORLD, "cuda")
    n_cards = len(set(map(str, devices)))
    jobs = [dict(arch=arch, layers=layers, seq=QSPLIT_SEQ,
                 prefill=QSPLIT_PREFILL,
                 ref=tp_lm_reference(arch, layers, QSPLIT_LM_BATCH,
                                     QSPLIT_LM_PROMPT, "tp qsplit lm", card))
            for arch, layers in QSPLIT_LM_ARCHS.items()]
    tcfg = TLT.lm_config(SHMAP_LM_ARCH, False, SHMAP_LM_LAYERS,
                         attn_shard="shmap")
    want, want_s, want_peak = shmap_lm_reference(tcfg)
    ref_s = time.perf_counter() - t0
    mesh = train_mesh(1, QSPLIT_WORLD)
    t1 = time.perf_counter()
    # the cache's slots rounded up to a multiple of the ranks: the "seq"
    # layout cuts each leaf into blocks, every block holding a prompt
    # position, so every rank launches K8's partials at every step
    max_len = -(-(QSPLIT_LM_PROMPT + TP_STEPS) // QSPLIT_WORLD) * QSPLIT_WORLD
    z3 = next(j for j in jobs if j["arch"] == ZERO3_QSPLIT_ARCH)
    z3 = dict(z3, seq=None, prefill=None, mode="zero3",
              key=f"{ZERO3_QSPLIT_ARCH}/zero3")
    ranks = spawn_ranks(
        QSPLIT_WORLD, tp_lm_rank,
        ([dict(arch=j["arch"], layers=j["layers"], seq=j["seq"],
               prefill=j["prefill"], max_len=max_len,
               mode=j.get("mode", "tp"), key=j.get("key", j["arch"]),
               tokens=j["ref"]["tokens"].numpy(),
               feed=[f.numpy() for f in j["ref"]["fed"]], gates=None)
          for j in (*jobs, z3)], (), (),
         (SHMAP_LM_ARCH, SHMAP_LM_LAYERS, FSDP_LM_LR)),
        device="cuda", timeout_s=900, mesh=mesh)
    spawn_s = time.perf_counter() - t1
    out = {}
    for job in jobs:
        arch, ref, layers = job["arch"], job["ref"], job["layers"]
        cfg = dataclasses.replace(CFG.get(arch), n_layers=layers)
        b, s = ref["tokens"].shape
        touched = [len(q_heads(cfg.n_heads, QSPLIT_WORLD, r))
                   for r in range(QSPLIT_WORLD)]
        held = [len(kv_heads(cfg.n_heads, cfg.n_kv_heads, QSPLIT_WORLD, r))
                for r in range(QSPLIT_WORLD)]
        for key, variant in ((arch, "auto"), (f"{arch}/seq", QSPLIT_SEQ)):
            got = [rank[key] for rank in ranks]
            kind = "k8" if variant == "auto" else "k8_partial"
            for r, run in enumerate(got):
                assert run[kind] == layers * TP_STEPS, (key, r, run[kind])
                assert run["k8" if kind == "k8_partial" else
                           "k8_partial"] == 0, (key, r)
            worst, greedy = check_tp_logits([run["logits"] for run in got],
                                            ref, "tp qsplit lm")
            print(f"[tp qsplit lm] {cfg.name}, {layers} of "
                  f"{CFG.get(arch).n_layers} layers in bfloat16 "
                  f"({cfg.n_heads} query / {cfg.n_kv_heads} kv heads of "
                  f"{cfg.hd}: {cfg.n_heads / QSPLIT_WORLD} a rank, touching "
                  f"{sorted(set(touched))}, holding {sorted(set(held))} kv "
                  f"head(s)), over {QSPLIT_WORLD} ranks ({backend}; "
                  f"{n_cards} card(s): {card}): prefill {b} x {s} tokens "
                  f"under {QSPLIT_PREFILL!r}, {TP_STEPS} decode steps under "
                  f"{variant!r} ({'the heads' if variant == 'auto' else 'the seq'}"
                  f" cache) fed the unsharded run's greedy tokens; logits "
                  f"within {worst:.3f} of the bar ({TP_BF16_STD_TOL} x the "
                  f"step's logit std) on all {len(got) * (TP_STEPS + 1) * b} "
                  f"rank-rows, {greedy} greedy tokens equal; the ranks' "
                  f"logits bit-equal")
            for r, run in enumerate(got):
                print(f"[tp qsplit lm]   {variant} rank {r}: "
                      f"{'K8' if variant == 'auto' else 'K8 partials'} "
                      f"{run[kind]} = {layers} x {TP_STEPS}; cache "
                      f"{run['cache_bytes']} bytes; peak memory "
                      f"{run['peak']} bytes; prefill {run['prefill_s']:.3f} "
                      f"s; median "
                      f"{statistics.median(run['step_ms']):.3f} ms a decode "
                      f"step; collectives a step "
                      f"{ {k: v / TP_STEPS for k, v in run['calls'].items()} }")
            out[key] = dict(
                launches_per_rank=[run[kind] for run in got],
                step_ms_median=[statistics.median(run["step_ms"])
                                for run in got],
                prefill_s=[run["prefill_s"] for run in got],
                peak_bytes=[run["peak"] for run in got],
                cache_bytes=[run["cache_bytes"] for run in got],
                shard_bytes=[rank[arch]["shard_bytes"] for rank in ranks],
                passes=[run["passes"] for run in got],
                worst_share_of_bar=worst)
    out[z3["key"]] = zero3_qsplit_check(z3, [rank[z3["key"]]
                                             for rank in ranks],
                                        backend, n_cards, card)
    got = [rank["train"] for rank in ranks]
    err = max(abs(a - c) for run in got
              for a, c in zip(run["losses"], want))
    for r, run in enumerate(got):
        assert np.isfinite(run["losses"]).all(), run["losses"]
        assert run["losses"] == got[0]["losses"], (r, run["losses"])
        np.testing.assert_allclose(run["losses"][0], want[0],
                                   rtol=FSDP_LOSS_TOL, atol=FSDP_LOSS_TOL)
        np.testing.assert_allclose(run["losses"], want, rtol=0,
                                   atol=SHMAP_LM_BAR)
        assert run["state_bytes"] == layout_bytes(tcfg, mesh, "tp", r), (
            r, run["state_bytes"])
        assert not any(run["launches"].values()), run["launches"]
    shared, differ = shared_bits(tcfg, mesh, "tp", got)
    assert shared and not differ, (shared, differ)
    print(f"[shmap train lm] {tcfg.name}, {tcfg.n_layers} layer(s) at the "
          f"published widths, float32, {LM_TRAIN_STEPS} Adam steps of "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens at lr {FSDP_LM_LR} "
          f"under \"tp\" + \"shmap\" over 1 x {QSPLIT_WORLD} ranks "
          f"({backend}; {n_cards} card(s): {card}): losses "
          f"{got[0]['losses']}, the one-process run's of the same "
          f"semantics on the card {want} ({want_s:.2f} s, peak {want_peak} "
          f"bytes); step 1 {abs(got[0]['losses'][0] - want[0]):.3g} off "
          f"(bar {FSDP_LOSS_TOL} + {FSDP_LOSS_TOL} of the loss), max "
          f"absolute err {err:.3g} ({err / SHMAP_LM_BAR:.3f} of the bar "
          f"{SHMAP_LM_BAR}); every two ranks holding the same pieces "
          f"of a leaf hold equal bits of it in params, m and v ({shared} "
          f"such leaves); state {got[0]['state_bytes']} bytes a rank (its "
          f"pieces'); kernel launches 0")
    for r, run in enumerate(got):
        calls = {k: (v, run["bytes"][-1][k])
                 for k, v in run["calls"][-1].items()}
        print(f"[shmap train lm]   rank {r}: peak {run['peak_bytes']} bytes; "
              f"seconds a step {[round(v, 3) for v in run['seconds']]}; "
              f"collectives a step (calls, bytes) {calls}")
    out["train"] = dict(losses=got[0]["losses"], one_process=want, err=err,
                        shared_leaves=shared,
                        peak_bytes=[run["peak_bytes"] for run in got],
                        runs=[train_counts(run) for run in got])
    print(f"[tp qsplit lm] done in {time.perf_counter() - t0:.1f} s (the "
          f"unsharded runs {ref_s:.1f} s; the spawn of {QSPLIT_WORLD} ranks "
          f"{spawn_s:.1f} s, [shmap train lm] included); the times are "
          f"{QSPLIT_WORLD} processes "
          + ("sharing one card over gloo, not a sharded deployment's"
             if n_cards < QSPLIT_WORLD
             else f"on {n_cards} cards over {backend}"))
    return dict(out, spawn_s=spawn_s)


def shmap_lm_reference(cfg) -> tuple[list[float], float, int]:
    """[shmap train lm]'s reference: `launch.train.lm_train_steps` of cfg
    ("shmap") on the card inside `layers.one_process_mesh(1,
    QSPLIT_WORLD)`, the 16 ranks' semantics in one process: (losses,
    seconds, peak bytes)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            Lyr.one_process_mesh(1, QSPLIT_WORLD):
        want = TLT.lm_train_steps(cfg, LM_TRAIN_STEPS, LM_TRAIN_BATCH,
                                  LM_TRAIN_SEQ, 0, FSDP_LM_LR, "cuda")
    sync()
    out = want, time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    free_cuda()
    return out


def layout_bytes(cfg, mesh, mode: str, rank: int) -> int:
    """params + Adam's m and v in float32 of the pieces `rank` holds under
    `mode` on `mesh` (`parallel.rank_pieces`: a leaf's block, or Mamba2's
    head-aligned pieces with B / C whole on every rank)."""
    tmpl = Z.templates(cfg)
    held = MB.tree_leaves(rank_pieces(tmpl, SHD.param_layouts(tmpl, mesh,
                                                              mode),
                                      mesh, rank))
    return 3 * 4 * sum(math.prod(sum(m for _, m in dim) for dim in leaf)
                       for leaf in held)


def shared_bits(cfg, mesh, mode: str, got: list) -> tuple[int, list]:
    """Whether every two ranks of `got` (`train_lm_rank`'s runs on `mesh`
    under `mode`) that hold the same pieces of a leaf hold the same bits of
    it in params, m and v after the last step (their digests): the leaves
    compared, and the (kind, leaf, rank, rank) where they differ."""
    tmpl = Z.templates(cfg)
    specs = SHD.param_layouts(tmpl, mesh, mode)
    held = [list(MB.tree_leaves(rank_pieces(tmpl, specs, mesh, r)))
            for r in range(mesh.size)]
    leaves, differ = set(), []
    for r, run in enumerate(got):
        for kind, digests in run["digests"].items():
            for i, digest in digests.items():
                differ += [(kind, i, r, q) for q, other in enumerate(got)
                           if held[q][i] == held[r][i]
                           and other["digests"][kind][i] != digest]
                leaves.add(i)
    return len(leaves), differ


def fsdp_parity_cfg(arch: str):
    cfg = dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32)
    cf = FSDP_PARITY_ARCHS[arch]
    return dataclasses.replace(cfg, capacity_factor=cf) if cf else cfg


def fsdp_batches(cfg) -> list[dict]:
    rng = np.random.default_rng(3)
    return [TLT.lm_batch(cfg, rng, FSDP_PARITY_BATCH, FSDP_PARITY_SEQ, "cpu")
            for _ in range(LM_TRAIN_STEPS)]


def recorded_dispatch(keeps: list):
    """Wrap `layers.moe_dispatch` to record each call's router
    probabilities and kept choices (slot < cap) on the host; returns the
    undo."""
    orig = Lyr.moe_dispatch

    def recorded(cfg, probs, gate_i, mp=None):
        out = orig(cfg, probs, gate_i, mp)
        keeps.append((probs.detach().cpu(), (out[2] < out[3]).cpu()))
        return out

    Lyr.moe_dispatch = recorded
    return lambda: setattr(Lyr, "moe_dispatch", orig)


def fsdp_parity_run(params, cfg, device, mp=None, layout=None,
                    feed=None, states=None) -> dict:
    """LM_TRAIN_STEPS Adam steps of `zoo.train_step` (with mp and layout:
    a rank's shard and rows of `fsdp_batches`): the losses, step 1's m
    (gathered under a layout), each step's kept choices, routes (`routed`:
    each moe layer's probabilities and its own choices), collectives
    (calls and bytes put in) and seconds (the loss read back included).
    feed: per step, the gate_i (T, k) of each moe layer's call, which the
    step routes its tokens to (`routed(feed=)`). Under a layout, after the
    last step, a sha256 of each leaf of params, m and v that another rank
    holds the same pieces of (`launch.train.shared_leaves`; leaf index ->
    digest). states: "record" keeps, as `states`, the whole params and
    Adam state (on the CPU) each step after the first starts from; a path
    to a file of such a list (`torch.save`) makes each step after the
    first start from its entry instead of this run's own (a rank's shard
    of it under a layout)."""
    opt = adam(FSDP_PARITY_LR)
    state = opt.init(params)
    out = dict(losses=[], keeps=[], calls=[], bytes=[], routes=[],
               seconds=[])
    given = None if states in (None, "record") else torch.load(states)
    for i, batch in enumerate(fsdp_batches(cfg)):
        if i and states == "record":
            out.setdefault("states", []).append(MB.tree_map(
                lambda a: a.detach().cpu().clone(),
                {"params": params, **state}))
        if i and given is not None:
            params, state = state_at(given[i - 1], cfg, layout, mp, device)
        if mp is not None:
            batch = TLT.batch_rows(batch, mp.mesh, mp.global_rank)
            mp.reset_counts()
        batch = {k: v.to(device) for k, v in batch.items()}
        keeps = []
        undo = recorded_dispatch(keeps)
        gates = (None if feed is None else
                 iter([torch.as_tensor(g).to(device) for g in feed[i]]))
        t0 = time.perf_counter()
        try:
            (params, state, loss), routes = routed(
                Z.train_step, params, state, batch, cfg, opt.update, mp,
                layout, feed=gates)
        finally:
            undo()
        out["losses"].append(float(loss))
        out["seconds"].append(time.perf_counter() - t0)
        out["keeps"].append(keeps)
        out["routes"].append(routes)
        out["calls"].append(dict(mp.calls) if mp is not None else {})
        out["bytes"].append(dict(mp.bytes) if mp is not None else {})
        if i == 0:
            m = state["m"] if mp is None else MB.gather_params(
                state["m"], Z.templates(cfg), layout.specs, mp)
            out["m1"] = [a.detach().cpu() for a in MB.tree_leaves(m)]
    out["state_bytes"] = sum(a.numel() * a.element_size() for t in (
        params, state["m"], state["v"]) for a in MB.tree_leaves(t))
    if layout is not None:
        shared = TLT.shared_leaves(Z.templates(cfg), layout.specs, mp.mesh,
                                   mp.global_rank)
        out["digests"] = {kind: {i: TLT._digest(a) for i, a in enumerate(
            MB.tree_leaves(tree)) if i in shared} for kind, tree in (
                ("params", params), ("m", state["m"]), ("v", state["v"]))}
    return out


def state_at(whole: dict, cfg, layout, mp, device) -> tuple[dict, dict]:
    """(params, Adam state) on `device` from a whole one (`fsdp_parity_run`
    's recorded `states`): under a layout, mp's shards of it."""
    tmpl = Z.templates(cfg)
    out = {k: v if k == "step" else MB.tree_map(
        lambda a: a.to(device), v if layout is None else MB.shard_params(
            v, tmpl, layout.specs, mp)) for k, v in whole.items()}
    params = out.pop("params")
    return params, out


def shmap_parity_cfg(key: str):
    arch, over = SHMAP_TRAIN_PARITY[key]
    return dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32,
                               attn_shard="shmap", **over)


def shmap_parity_rank(mp, feeds=None) -> dict:
    """[shmap train parity], one rank of FSDP_MESH: each
    SHMAP_TRAIN_PARITY case's shard of its smoke params (seed 3) under
    each of SHMAP_TRAIN_MODES, trained by `fsdp_parity_run` (step 1's m
    returned by rank 0 only), routed to feeds[name]'s experts where given
    (this rank's, per step: `shmap_parity_feeds`); the launch counts set
    to 0 before and read after. Keys "shmap/key/mode"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key in SHMAP_TRAIN_PARITY:
        cfg = shmap_parity_cfg(key)
        tmpl = Z.templates(cfg)
        full = MB.materialize(tmpl, torch.Generator().manual_seed(3))
        for mode in SHMAP_TRAIN_MODES:
            layout = TrainLayout(mode, SHD.param_layouts(tmpl, mp.mesh,
                                                         mode))
            shard = MB.tree_map(lambda a: a.to(mp.device), MB.shard_params(
                full, tmpl, layout.specs, mp))
            name = f"shmap/{key}/{mode}"
            ops.reset_launch_counts()        # this rank's path starts here
            run = fsdp_parity_run(shard, cfg, mp.device, mp, layout,
                                  feed=(feeds or {}).get(name))
            if mp.device.type == "cuda":
                sync()
            run["launches"] = ops.launch_counts()    # ... and ends here
            if mp.global_rank:
                del run["m1"]
            out[name] = run
    return out


def shmap_parity_refs(device="cuda") -> dict:
    """The runs [shmap train parity] holds its ranks to: each
    SHMAP_TRAIN_PARITY case's smoke params (seed 3) trained by
    `fsdp_parity_run` in one process on `device` with the ranks'
    semantics (`layers.one_process_mesh(*FSDP_MESH)`: the keys in
    FSDP_MESH[1] blocks, the experts over FSDP_MESH[0] data shards, whose
    routes and kept choices it records per (layer, data shard) in call
    order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = {}
    for key in SHMAP_TRAIN_PARITY:
        cfg = shmap_parity_cfg(key)
        params = MB.tree_map(lambda a: a.to(device), MB.materialize(
            Z.templates(cfg), torch.Generator().manual_seed(3)))
        with Lyr.one_process_mesh(*FSDP_MESH):
            refs[key] = fsdp_parity_run(params, cfg, device)
        del params
    if torch.device(device).type == "cuda":
        free_cuda()
    return refs


def shmap_parity_feeds(refs: dict) -> list[dict]:
    """Per rank of FSDP_MESH, each "shmap/key/mode" case's feed: per step,
    the one-process run's expert choices (gate_i) of the rank's data shard
    at each moe layer, which the rank routes its tokens to."""
    n_data, n_model = FSDP_MESH
    return [{f"shmap/{key}/{mode}": [
        [i for j, (_, i) in enumerate(step) if j % n_data == r // n_model]
        for step in ref["routes"]]
        for key, ref in refs.items() for mode in SHMAP_TRAIN_MODES}
        for r in range(n_data * n_model)]


def check_shmap_parity(key, mode, got, want, backend, n_cards, card
                       ) -> dict:
    """One [shmap train parity] case on every rank of the card's run
    (`got`) against the one-process run of the same semantics on the card
    (`want`, `shmap_parity_refs`), the ranks' moe layers routed to its
    experts (a choice that float rounding flips at the capacity's edge
    parts two runs' drops by a token's whole output): the losses (equal
    on every rank) within FSDP_LOSS_TOL at step 1 and SHMAP_LOSS_BAR at
    every step, step 1's gathered m within SHMAP_M_BAR of each leaf's
    largest, each rank's own expert choices equal to the one-process
    run's for its data shard where its router leaves ROUTE_LOG_MARGIN
    (`check_routes`), its kept choices (its data shard's own dispatch of
    those experts) equal to that shard's, some dropped, each rank's state
    bytes its pieces', no kernel launched."""
    cfg = shmap_parity_cfg(key)
    mesh = train_mesh(*FSDP_MESH)
    n_data, n_model = FSDP_MESH
    for r, rank in enumerate(got):
        assert rank["losses"] == got[0]["losses"], (key, mode, r)
        np.testing.assert_allclose(rank["losses"][0], want["losses"][0],
                                   rtol=FSDP_LOSS_TOL, atol=FSDP_LOSS_TOL)
        np.testing.assert_allclose(rank["losses"], want["losses"], rtol=0,
                                   atol=SHMAP_LOSS_BAR)
        assert rank["state_bytes"] == layout_bytes(cfg, mesh, mode, r), (
            key, mode, r, rank["state_bytes"])
        assert not any(rank["launches"].values()), rank["launches"]
    m_err = 0.0
    for g, w in zip(got[0]["m1"], want["m1"]):
        scale = float(w.abs().max())
        err = float((torch.from_numpy(g) - w).abs().max())
        assert err <= SHMAP_M_BAR * scale, (key, mode, err, scale)
        m_err = max(m_err, err / max(scale, 1e-30))
    compared = dropped = routes = 0
    for r, rank in enumerate(got):
        d = r // n_model
        for step, calls in enumerate(want["keeps"]):
            shard = calls[d::n_data]
            assert len(rank["keeps"][step]) == len(shard), (key, mode, r)
            for (_, mine), (_, keep) in zip(rank["keeps"][step], shard):
                np.testing.assert_array_equal(mine, keep.numpy())
                compared += 1
                dropped += int((~keep).sum())
            if cfg.arch_type == "moe":
                routes += check_routes(
                    [tuple(map(torch.from_numpy, x))
                     for x in rank["routes"][step]],
                    want["routes"][step][d::n_data], cfg.top_k,
                    f"[shmap train parity] {key} {mode} rank {r} step "
                    f"{step}")[0]
    if cfg.arch_type == "moe":
        assert compared > 0 and dropped > 0, (key, mode, compared, dropped)
    print(f"[shmap train parity] {cfg.name} (float32; {cfg.n_heads} query / "
          f"{cfg.n_kv_heads} kv heads) under {mode!r} + \"shmap\" over "
          f"{n_data} x {n_model} ranks ({backend}, {n_cards} card(s), "
          f"{card}) against the one-process run of the same semantics on "
          f"the card: {LM_TRAIN_STEPS} Adam steps of {FSDP_PARITY_BATCH} x "
          f"{FSDP_PARITY_SEQ} tokens, losses {got[0]['losses']} (the one "
          f"process's {want['losses']}; bars {FSDP_LOSS_TOL} at step 1, "
          f"{SHMAP_LOSS_BAR} every step), step 1's m within {m_err:.3g} of "
          f"each leaf's largest (bar {SHMAP_M_BAR}: one bfloat16 rounding "
          f"step)"
          + (f", routed to its experts: each rank's own choices equal for "
             f"{routes} token-layers (where the router leaves "
             f"{ROUTE_LOG_MARGIN}), the kept choices (each data shard's "
             f"capacity) equal in {compared} rank-(step, layer)s with "
             f"{dropped} dropped" if cfg.arch_type == "moe" else "")
          + f"; state {got[0]['state_bytes']} bytes a rank; collectives a "
          f"step {got[0]['calls'][0]}; kernel launches 0")
    return dict(m_err=m_err, losses=got[0]["losses"])


def zero3_family_cfg(key: str):
    """A [zero3 families parity] case's smoke config in float32."""
    arch, impl = ZERO3_FAMILY_PARITY[key]
    return dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32,
                               ssm_impl=impl)


def zero3_shard(mp, cfg, seed: int):
    """(rank mp's zero3 shard of the params `MB.materialize` draws on the
    CPU from `seed`, on the rank's card; the layout)."""
    tmpl = Z.templates(cfg)
    layout = TrainLayout("zero3", SHD.param_layouts(tmpl, mp.mesh, "zero3"))
    full = MB.materialize(tmpl, torch.Generator().manual_seed(seed))
    return MB.tree_map(lambda a: a.to(mp.device), MB.shard_params(
        full, tmpl, layout.specs, mp)), layout


def zero3_rank(mp, serve_cases, lm_lr: float, family_states: dict) -> dict:
    """[zero3 families parity], [zero3 serve parity] and [zero3 lm], one
    rank of FSDP_MESH, each case's launch counts set to 0 before it and
    read after, its seconds timed: each ZERO3_FAMILY_PARITY case's zero3
    shard of its smoke params (seed 3) trained by `fsdp_parity_run`, each
    step after the first from the unsharded run's state of that step
    (family_states[key], a file) (step 1's m returned by rank 0 only);
    each serve case (arch, tokens, feed,
    frontend) of ZERO3_SERVE_ARCHS served from its zero3 shard (seed 3)
    by `tp_lm_serve` on the rank's rows; `train_lm_rank` of each of
    ZERO3_LM_ARCHS under "zero3" in the chunked form."""
    out = {}
    for key in ZERO3_FAMILY_PARITY:
        t0 = time.perf_counter()
        cfg = zero3_family_cfg(key)
        shard, layout = zero3_shard(mp, cfg, 3)
        ops.reset_launch_counts()            # this rank's path starts here
        run = fsdp_parity_run(shard, cfg, mp.device, mp, layout,
                              states=family_states[key])
        sync()
        run["launches"] = ops.launch_counts()    # ... and ends here
        if mp.global_rank:
            del run["m1"]
        out[f"zero3 family/{key}"] = dict(run, s=time.perf_counter() - t0)
    for arch, tokens, feed, frontend in serve_cases:
        t0 = time.perf_counter()
        cfg = parity_cfg(arch)
        shard, layout = zero3_shard(mp, cfg, 3)
        rows = TLT.batch_rows({"tokens": torch.as_tensor(tokens)}, mp.mesh,
                              mp.global_rank)["tokens"]
        job = dict(arch=arch, tokens=rows.numpy(), gates=None, feed=[
            TLT.batch_rows({"tokens": torch.as_tensor(f)}, mp.mesh,
                           mp.global_rank)["tokens"].numpy() for f in feed])
        if frontend is not None:
            frontend = TLT.batch_rows({"f": torch.as_tensor(frontend)},
                                      mp.mesh, mp.global_rank)["f"]
            frontend = frontend.to(mp.device)
        run = tp_lm_serve(mp, shard, cfg, job, frontend, layout=layout)
        run["shard_bytes"] = sum(a.numel() * a.element_size()
                                 for a in MB.tree_leaves(shard))
        out[f"zero3 serve/{arch}"] = dict(run, s=time.perf_counter() - t0)
        del shard
    for arch, layers in ZERO3_LM_ARCHS.items():
        free_cuda()
        t0 = time.perf_counter()
        ops.reset_launch_counts()            # this rank's path starts here
        run = TLT.train_lm_rank(mp, arch, layers, "zero3", LM_TRAIN_STEPS,
                                LM_TRAIN_BATCH, LM_TRAIN_SEQ, 0, False,
                                lm_lr, ssm_impl="chunked")
        sync()
        run["launches"] = ops.launch_counts()    # ... and ends here
        out[f"zero3 lm/{arch}"] = dict(run, s=time.perf_counter() - t0)
    free_cuda()
    return out


def fsdp_rank(mp, lm_layers: int, lm_lr: float, shmap_feeds,
              zero3_serve_cases, zero3_states) -> dict:
    """[shmap train parity], [fsdp parity] and [fsdp lm], one rank of
    FSDP_MESH: `shmap_parity_rank` routed to shmap_feeds[its rank]; each
    parity case's shard of its smoke params (seed 3) under each mode,
    trained as the unsharded run (`fsdp_parity_run`; step 1's m returned
    by rank 0 only); then `train_lm_rank` of FSDP_LM_ARCH at lm_layers
    layers under each mode, the launch counts set to 0 before it and read
    after; then the "zero3" cases (`zero3_rank`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = shmap_parity_rank(mp, shmap_feeds[mp.global_rank])
    for arch in FSDP_PARITY_ARCHS:
        cfg = fsdp_parity_cfg(arch)
        tmpl = Z.templates(cfg)
        full = MB.materialize(tmpl, torch.Generator().manual_seed(3))
        for mode in FSDP_MODES:
            layout = TrainLayout(mode, SHD.param_layouts(tmpl, mp.mesh,
                                                         mode))
            shard = MB.tree_map(lambda a: a.to(mp.device), MB.shard_params(
                full, tmpl, layout.specs, mp))
            run = fsdp_parity_run(shard, cfg, mp.device, mp, layout)
            if mp.global_rank:
                del run["m1"]
            out[f"{arch}/{mode}"] = run
    for mode in FSDP_MODES:
        free_cuda()
        ops.reset_launch_counts()            # this rank's path starts here
        run = TLT.train_lm_rank(mp, FSDP_LM_ARCH, lm_layers, mode,
                                LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                0, False, lm_lr)
        sync()
        run["launches"] = ops.launch_counts()    # ... and ends here
        out[f"lm/{mode}"] = run
    out.update(zero3_rank(mp, zero3_serve_cases, lm_lr, zero3_states))
    return out


def fsdp_parity_refs() -> dict:
    """The card's unsharded runs [fsdp parity] holds its ranks to: each
    case's smoke params drawn on the CPU from seed 3, `fsdp_parity_run`
    on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = {}
    for arch in FSDP_PARITY_ARCHS:
        cfg = fsdp_parity_cfg(arch)
        params = MB.tree_map(lambda a: a.to("cuda"), MB.materialize(
            Z.templates(cfg), torch.Generator().manual_seed(3)))
        refs[arch] = fsdp_parity_run(params, cfg, "cuda")
        del params
    free_cuda()
    return refs


def check_fsdp_parity(arch, mode, got, want, backend, n_cards, card) -> dict:
    """One [fsdp parity] case on every rank (`got`) against the card's
    unsharded run `want`: the losses (equal on every rank) within
    FSDP_LOSS_TOL each step, step 1's gathered m within FSDP_M_TOL of each
    leaf's largest, the kept choices of every moe layer over the whole
    batch (the data ranks' in order) equal where the router leaves every
    token ROUTE_LOG_MARGIN, each rank's state bytes its layout's, the same
    collectives every step."""
    cfg = fsdp_parity_cfg(arch)
    mesh = train_mesh(*FSDP_MESH)
    n_model = FSDP_MESH[1]
    for r, rank in enumerate(got):
        assert rank["losses"] == got[0]["losses"], (arch, mode, r)
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=FSDP_LOSS_TOL, atol=FSDP_LOSS_TOL)
        assert rank["state_bytes"] == layout_bytes(cfg, mesh, mode, r), (
            arch, mode, r, rank["state_bytes"])
        assert all(c == rank["calls"][0] for c in rank["calls"]), rank["calls"]
    m_err = 0.0
    for g, w in zip(got[0]["m1"], want["m1"]):
        scale = float(w.abs().max())
        err = float((torch.from_numpy(g) - w).abs().max())
        assert err <= FSDP_M_TOL * scale, (arch, mode, err, scale)
        m_err = max(m_err, err / max(scale, 1e-30))
    compared = dropped = 0
    for step, layers in enumerate(want["keeps"]):
        for layer, (probs, keep) in enumerate(layers):
            top = torch.topk(probs.log(), cfg.top_k + 1, dim=-1).values
            if bool((top[:, -2] - top[:, -1] <= ROUTE_LOG_MARGIN).any()):
                continue
            for col in range(n_model):
                mine = np.concatenate(
                    [got[d * n_model + col]["keeps"][step][layer][1]
                     for d in range(FSDP_MESH[0])])
                np.testing.assert_array_equal(mine, keep.numpy())
            compared += 1
            dropped += int((~keep).sum())
    if cfg.arch_type == "moe":
        assert compared > 0 and dropped > 0, (arch, mode, compared, dropped)
    print(f"[fsdp parity] {cfg.name} (float32) under {mode!r} over "
          f"{FSDP_MESH[0]} x {FSDP_MESH[1]} ranks ({backend}, {n_cards} "
          f"card(s), {card}) against the card's unsharded train_step: "
          f"{LM_TRAIN_STEPS} Adam steps of {FSDP_PARITY_BATCH} x "
          f"{FSDP_PARITY_SEQ} tokens, losses {got[0]['losses']} (the "
          f"unsharded {want['losses']}; bar {FSDP_LOSS_TOL}), step 1's m "
          f"within {m_err:.3g} of each leaf's largest (bar {FSDP_M_TOL})"
          + (f", the kept choices equal in {compared} (step, layer)s with "
             f"{dropped} dropped" if cfg.arch_type == "moe" else "")
          + f"; state {got[0]['state_bytes']} bytes a rank; collectives a "
          f"step {got[0]['calls'][0]}")
    return dict(m_err=m_err, losses=got[0]["losses"])


def zero3_refs(tmp: str) -> dict:
    """The card's unsharded runs the "zero3" cases are held to: each
    ZERO3_FAMILY_PARITY case's `fsdp_parity_run` (smoke params, seed 3),
    the state each step after the first starts from saved under `tmp`
    (the ranks start each such step from it: Adam moves a weight whose
    gradient rounding leaves near 0 by +-lr on a sign the rounding
    decides, so two runs' later losses part by more than [fsdp parity]'s
    bar, rwkv6-smoke's by 2.3e-5 at step 2 on the card);
    each of ZERO3_SERVE_ARCHS' prefill of TP_PARITY_BATCH x
    TP_PARITY_PROMPT tokens (numpy seed 3; an encdec model's
    ENCDEC_PARITY_FRAMES frames too) and TP_PARITY_STEPS greedy decode
    steps (`lm_serve`), with the ranks' cases (arch, tokens, the tokens
    fed, frames); each of ZERO3_LM_ARCHS' `launch.train.lm_train_steps`
    at its cut in the chunked form (losses, seconds, peak bytes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"family": {}, "states": {}, "serve": {}, "cases": [], "lm": {}}
    for key in ZERO3_FAMILY_PARITY:
        cfg = zero3_family_cfg(key)
        params = MB.tree_map(lambda a: a.to("cuda"), MB.materialize(
            Z.templates(cfg), torch.Generator().manual_seed(3)))
        run = fsdp_parity_run(params, cfg, "cuda", states="record")
        run["spread"] = data_split_spread(params, cfg, {
            k: v.to("cuda") for k, v in fsdp_batches(cfg)[0].items()})
        out["states"][key] = os.path.join(tmp, f"{key}.pt")
        torch.save(run.pop("states"), out["states"][key])
        out["family"][key] = run
        del params
    for arch in ZERO3_SERVE_ARCHS:
        cfg = parity_cfg(arch)
        params = MB.tree_map(lambda a: a.to("cuda"), MB.materialize(
            Z.templates(cfg), torch.Generator().manual_seed(3)))
        tokens, frontend = tp_family_inputs(cfg)
        ref = lm_serve(params, cfg, tokens, TP_PARITY_STEPS, "cuda",
                       frontend=frontend)
        out["serve"][arch] = ref
        out["cases"].append((arch, tokens.numpy(),
                             [f.numpy() for f in ref["fed"]],
                             None if frontend is None else frontend.numpy()))
        del params
    free_cuda()
    for arch, layers in ZERO3_LM_ARCHS.items():
        cfg = TLT.lm_config(arch, False, layers, "chunked")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            losses = TLT.lm_train_steps(cfg, LM_TRAIN_STEPS, LM_TRAIN_BATCH,
                                        LM_TRAIN_SEQ, 0, FSDP_LM_LR, "cuda")
        sync()
        out["lm"][arch] = dict(losses=losses, s=time.perf_counter() - t0,
                               peak=torch.cuda.max_memory_allocated())
        free_cuda()
    return out


def data_split_spread(params, cfg, batch) -> list[float]:
    """Per leaf (tree order), how far the gradient of the loss on `batch`
    moves when the batch is cut into FSDP_MESH[0] blocks of rows, each
    block's gradient taken apart and averaged (the order a data split
    sums in), from the whole batch's, as a share of the leaf's largest:
    float32's own spread for this step on one card."""
    def grads(rows):
        leaves = MB.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
        flat = list(MB.tree_leaves(leaves))
        got = torch.autograd.grad(Z.lm_loss(leaves, cfg, rows), flat,
                                  allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(got, flat)]

    n = FSDP_MESH[0]
    b = batch["tokens"].shape[0] // n
    whole = grads(batch)
    parts = [grads({k: v[i * b:(i + 1) * b] for k, v in batch.items()})
             for i in range(n)]
    return [float((sum(ps) / n - w).abs().max())
            / max(float(w.abs().max()), 1e-30)
            for w, *ps in zip(whole, *parts)]


def check_zero3_family(key, got, want, backend, n_cards, card) -> dict:
    """One [zero3 families parity] case on every rank (`got`, each step
    after the first from `want`'s state) against the card's unsharded run
    `want`, at [fsdp parity]'s bars: the losses (equal on every rank)
    within FSDP_LOSS_TOL each step, step 1's gathered m within FSDP_M_TOL
    of each leaf's largest or, where float32's own spread for the step
    is wider (`data_split_spread`: rwkv6-smoke's, up to 8.1e-5 on an
    H100), ZERO3_SPREAD_FACTOR x that leaf's spread, each rank's state
    bytes its layout's, every two ranks holding the same pieces of a leaf
    holding equal bits of it (`shared_bits`), no kernel launched."""
    cfg = zero3_family_cfg(key)
    mesh = train_mesh(*FSDP_MESH)
    for r, rank in enumerate(got):
        assert rank["losses"] == got[0]["losses"], (key, r)
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=FSDP_LOSS_TOL, atol=FSDP_LOSS_TOL)
        assert rank["state_bytes"] == layout_bytes(cfg, mesh, "zero3", r), (
            key, r, rank["state_bytes"])
        assert not any(rank["launches"].values()), rank["launches"]
    m_err = share = 0.0
    for g, w, spread in zip(got[0]["m1"], want["m1"], want["spread"]):
        scale = float(w.abs().max())
        err = float((torch.from_numpy(g) - w).abs().max())
        bar = max(FSDP_M_TOL, ZERO3_SPREAD_FACTOR * spread)
        assert err <= bar * scale, (key, err, scale, spread)
        m_err = max(m_err, err / max(scale, 1e-30))
        share = max(share, err / max(bar * scale, 1e-30))
    shared, differ = shared_bits(cfg, mesh, "zero3", got)
    assert shared and not differ, (key, shared, differ)
    print(f"[zero3 families parity] {cfg.name} (float32, {cfg.ssm_impl}) "
          f"under \"zero3\" over {FSDP_MESH[0]} x {FSDP_MESH[1]} ranks "
          f"({backend}, {n_cards} card(s), {card}) against the card's "
          f"unsharded train_step: {LM_TRAIN_STEPS} Adam steps of "
          f"{FSDP_PARITY_BATCH} x {FSDP_PARITY_SEQ} tokens, each after the "
          f"first from the unsharded run's state, losses "
          f"{got[0]['losses']} (the unsharded {want['losses']}; bar "
          f"{FSDP_LOSS_TOL}), step 1's m within {m_err:.3g} of each leaf's "
          f"largest, {share:.3f} of its bar (the larger of {FSDP_M_TOL} and "
          f"{ZERO3_SPREAD_FACTOR} x the leaf's data-split spread, at most "
          f"{max(want['spread']):.3g}); equal bits of the {shared} leaves "
          f"ranks share; state {got[0]['state_bytes']} bytes a rank; "
          f"collectives a step {got[0]['calls'][0]}; kernel launches 0; "
          f"{got[0]['s']:.1f} s")
    return dict(m_err=m_err, losses=got[0]["losses"],
                runs=[train_counts(run) for run in got])


def check_zero3_serve(arch, got, want, backend, n_cards, card) -> dict:
    """One [zero3 serve parity] case on every rank (`got`, each its row of
    the batch) against the card's unsharded run `want` at [tp parity]'s
    bars: logits within TP_RTOL / TP_ATOL, greedy tokens exact where the
    margin exceeds TP_TOKEN_MARGIN, the ranks of a data row bit-equal, K8
    = k8_decode_calls x TP_PARITY_STEPS a rank ("tp"'s)."""
    cfg = parity_cfg(arch)
    n_data, n_model = FSDP_MESH
    rows = TP_PARITY_BATCH // n_data
    want_k8 = k8_decode_calls(cfg) * TP_PARITY_STEPS
    err, greedy = 0.0, 0
    for r, rank in enumerate(got):
        assert rank["k8"] == want_k8 and rank["k8_partial"] == 0, (
            arch, r, rank["k8"])
        mine = slice(r // n_model * rows, (r // n_model + 1) * rows)
        for i, (g, w) in enumerate(zip(rank["logits"], want["logits"])):
            np.testing.assert_array_equal(
                got[r - r % n_model]["logits"][i], g)
            g, w = torch.from_numpy(g), w[mine]
            torch.testing.assert_close(
                g, w, rtol=TP_RTOL, atol=TP_ATOL,
                msg=lambda m: f"[zero3 serve parity] {arch} rank {r} step "
                              f"{i}: {m}")
            err = max(err, float((g - w).abs().max()))
            top2 = torch.topk(w, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > TP_TOKEN_MARGIN
            assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure])
            greedy += int(sure.sum())
    assert greedy > 0, arch
    calls = {k: (v / TP_PARITY_STEPS, got[0]["bytes"][k] / TP_PARITY_STEPS)
             for k, v in got[0]["calls"].items()}
    print(f"[zero3 serve parity] {cfg.name} (float32) under \"zero3\" over "
          f"{n_data} x {n_model} ranks ({backend}, {n_cards} card(s), "
          f"{card}), each data row of ranks its {rows} row(s), against the "
          f"card's unsharded run: prefill of {TP_PARITY_BATCH} x "
          f"{TP_PARITY_PROMPT} tokens + {TP_PARITY_STEPS} decode steps fed "
          f"its greedy tokens, max |err| {err:.3g} (bars rtol {TP_RTOL}, "
          f"atol {TP_ATOL}), {greedy} greedy tokens equal; K8 per rank "
          f"{[rank['k8'] for rank in got]} = {k8_decode_calls(cfg)} x "
          f"{TP_PARITY_STEPS} (\"tp\"'s); collectives a decode step "
          f"(calls, bytes) {calls}; {got[0]['s']:.1f} s")
    return dict(err=err, k8_per_rank=[rank["k8"] for rank in got],
                passes=[rank["passes"] for rank in got],
                step_ms_median=[statistics.median(rank["step_ms"])
                                for rank in got],
                shard_bytes=[rank["shard_bytes"] for rank in got],
                cache_bytes=[rank["cache_bytes"] for rank in got])


def check_zero3_lm(arch, got, want, backend, n_cards, card) -> dict:
    """One [zero3 lm] run on every rank (`got`, `train_lm_rank`'s) against
    the unsharded run of the same steps on the card (`want`) at
    LM_TRAIN_RTOL, each rank's params + m + v its layout's bytes, the
    ranks sharing a leaf's pieces holding equal bits of it, no kernel
    launched; prints the state and peak a rank."""
    cfg = TLT.lm_config(arch, False, ZERO3_LM_ARCHS[arch], "chunked")
    mesh = train_mesh(*FSDP_MESH)
    err = max(abs(a - c) / abs(c) for run in got
              for a, c in zip(run["losses"], want["losses"]))
    for r, run in enumerate(got):
        assert np.isfinite(run["losses"]).all(), run["losses"]
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   rtol=LM_TRAIN_RTOL)
        assert run["state_bytes"] == layout_bytes(cfg, mesh, "zero3", r), (
            arch, r, run["state_bytes"])
        assert not any(run["launches"].values()), run["launches"]
    shared, differ = shared_bits(cfg, mesh, "zero3", got)
    assert shared and not differ, (arch, shared, differ)
    print(f"[zero3 lm] {cfg.name}, {cfg.n_layers} layers at the published "
          f"widths ({cfg.ssm_impl}), float32, {LM_TRAIN_STEPS} Adam steps of "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens at lr {FSDP_LM_LR} under "
          f"\"zero3\" over {FSDP_MESH[0]} x {FSDP_MESH[1]} ranks "
          f"({backend}; {n_cards} card(s): {card}): losses "
          f"{got[0]['losses']}, the unsharded run's on the card "
          f"{want['losses']} ({want['s']:.2f} s, peak {want['peak']} bytes),"
          f" max relative err {err:.3g} (bar {LM_TRAIN_RTOL}); equal bits "
          f"of the {shared} leaves ranks share; state "
          f"{got[0]['state_bytes']} bytes a rank (the unsharded "
          f"{layout_bytes(cfg, train_mesh(1, 1), 'zero3', 0)}); kernel "
          f"launches 0; {got[0]['s']:.1f} s")
    for r, run in enumerate(got):
        calls = {k: (v, run["bytes"][-1][k])
                 for k, v in run["calls"][-1].items()}
        print(f"[zero3 lm]   {arch} rank {r}: state {run['state_bytes']} "
              f"bytes; peak {run['peak_bytes']} bytes "
              f"({run['peak_bytes'] / want['peak']:.3f} of the unsharded "
              f"run's); seconds a step "
              f"{[round(v, 3) for v in run['seconds']]}; collectives a step "
              f"(calls, bytes) {calls}")
    return dict(losses=got[0]["losses"], max_rel_err=err,
                peak_bytes=[run["peak_bytes"] for run in got],
                runs=[train_counts(run) for run in got])


def phase_fsdp(card: str) -> dict:
    """[fsdp parity] and [fsdp lm] in one spawn of FSDP_MESH's ranks
    sharing the card: the card's unsharded references first (the parity
    cases; `launch.train`'s --target lm of FSDP_LM_ARCH at FSDP_LM_LAYERS
    layers with its peak memory), then the ranks (`fsdp_rank`). [fsdp lm]
    holds each mode's losses to the unsharded run's at LM_TRAIN_RTOL, each
    rank's state bytes to its layout's and its peak below FSDP_PEAK_SHARE
    of the unsharded run's, and the bits of each leaf piece two ranks hold
    equal on both (`shared_bits`); it prints per rank and mode the transport and
    card count, the state and peak bytes, seconds a step and the
    collectives a step by kind with their bytes. The training step
    launches no kernel of the table (the reference's reaches no Pallas
    kernel either): each rank's counts over its run are held to 0."""
    t0 = time.perf_counter()
    world = FSDP_MESH[0] * FSDP_MESH[1]
    backend, devices = transport(world, "cuda")
    n_cards = len(set(map(str, devices)))
    refs = fsdp_parity_refs()
    shmap_refs = shmap_parity_refs()
    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    z3 = zero3_refs(tmp)
    args = ["--target", "lm", "--arch", FSDP_LM_ARCH, "--layers",
            str(FSDP_LM_LAYERS), "--steps", str(LM_TRAIN_STEPS), "--batch",
            str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ), "--lr",
            str(FSDP_LM_LR), "--device", "cuda"]
    out_text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(out_text):
        t1 = time.perf_counter()
        want = TLT.main(args)
        sync()
        want_s = time.perf_counter() - t1
    want_peak = torch.cuda.max_memory_allocated()
    head = out_text.getvalue().splitlines()[0]
    free_cuda()
    ref_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ranks = spawn_ranks(world, fsdp_rank,
                        (FSDP_LM_LAYERS, FSDP_LM_LR,
                         shmap_parity_feeds(shmap_refs), z3["cases"],
                         z3["states"]),
                        device="cuda", timeout_s=900,
                        mesh=train_mesh(*FSDP_MESH))
    spawn_s = time.perf_counter() - t1
    out = {}
    for key in SHMAP_TRAIN_PARITY:
        for mode in SHMAP_TRAIN_MODES:
            name = f"shmap/{key}/{mode}"
            out[name] = check_shmap_parity(
                key, mode, [rank[name] for rank in ranks], shmap_refs[key],
                backend, n_cards, card)
    for arch in FSDP_PARITY_ARCHS:
        for mode in FSDP_MODES:
            out[f"parity/{arch}/{mode}"] = check_fsdp_parity(
                arch, mode, [rank[f"{arch}/{mode}"] for rank in ranks],
                refs[arch], backend, n_cards, card)
    cfg = TLT.lm_config(FSDP_LM_ARCH, False, FSDP_LM_LAYERS)
    mesh = train_mesh(*FSDP_MESH)
    print(f"[fsdp lm] {head.removeprefix('[train] ')}, lr {FSDP_LM_LR}: "
          f"the unsharded run on the card {want_s:.2f} s (first-call work "
          f"included), losses {want}, peak memory {want_peak} bytes")
    for mode in FSDP_MODES:
        want_bytes = layout_bytes(cfg, mesh, mode, 0)
        got = [rank[f"lm/{mode}"] for rank in ranks]
        err = max(abs(a - c) / abs(c) for run in got
                  for a, c in zip(run["losses"], want))
        print(f"[fsdp lm] {cfg.name}, {cfg.n_layers} layers at the published "
              f"widths, float32, under {mode!r} over {FSDP_MESH[0]} x "
              f"{FSDP_MESH[1]} ranks ({backend}; {n_cards} card(s): {card}):"
              f" losses {got[0]['losses']}, max relative err against the "
              f"unsharded run {err:.3g} (bar {LM_TRAIN_RTOL}); state "
              f"{want_bytes} bytes a rank (the unsharded "
              f"{layout_bytes(cfg, train_mesh(1, 1), mode, 0)})")
        for r, run in enumerate(got):
            calls = {k: (v, run["bytes"][-1][k])
                     for k, v in run["calls"][-1].items()}
            print(f"[fsdp lm]   {mode} rank {r}: {run['backend']}, "
                  f"{run['cards']} card(s); state {run['state_bytes']} bytes;"
                  f" peak {run['peak_bytes']} bytes "
                  f"({run['peak_bytes'] / want_peak:.3f} of the unsharded "
                  f"run's); seconds a step "
                  f"{[round(v, 3) for v in run['seconds']]}; collectives a "
                  f"step (calls, bytes) {calls}; kernel launches "
                  f"{sum(run['launches'].values())}")
        for r, run in enumerate(got):
            assert np.isfinite(run["losses"]).all(), run["losses"]
            np.testing.assert_allclose(run["losses"], want,
                                       rtol=LM_TRAIN_RTOL)
            assert run["state_bytes"] == layout_bytes(cfg, mesh, mode, r), (
                mode, r, run["state_bytes"])
            assert run["peak_bytes"] < FSDP_PEAK_SHARE * want_peak, (
                mode, r, run["peak_bytes"], want_peak)
            assert not any(run["launches"].values()), run["launches"]
        shared, differ = shared_bits(cfg, mesh, mode, got)
        assert shared and not differ, (mode, shared, differ)
        print(f"[fsdp lm]   {mode}: every two ranks holding the same pieces "
              f"of a leaf hold equal bits of it in params, m and v "
              f"({shared} such leaves)")
        out[f"lm/{mode}"] = dict(
            losses=got[0]["losses"], max_rel_err=err, state_bytes=want_bytes,
            shared_leaves=shared,
            peak_bytes=[run["peak_bytes"] for run in got],
            step_s=[run["seconds"] for run in got],
            calls=got[0]["calls"][-1],
            runs=[train_counts(run) for run in got])
    for key in ZERO3_FAMILY_PARITY:
        out[f"zero3 family/{key}"] = check_zero3_family(
            key, [rank[f"zero3 family/{key}"] for rank in ranks],
            z3["family"][key], backend, n_cards, card)
    for arch in ZERO3_SERVE_ARCHS:
        out[f"zero3 serve/{arch}"] = check_zero3_serve(
            arch, [rank[f"zero3 serve/{arch}"] for rank in ranks],
            z3["serve"][arch], backend, n_cards, card)
    for arch in ZERO3_LM_ARCHS:
        out[f"zero3 lm/{arch}"] = check_zero3_lm(
            arch, [rank[f"zero3 lm/{arch}"] for rank in ranks],
            z3["lm"][arch], backend, n_cards, card)
    print(f"[fsdp lm] done in {time.perf_counter() - t0:.1f} s (the "
          f"unsharded references {ref_s:.1f} s, the ranks {spawn_s:.1f} s, "
          f"[fsdp parity], [shmap train parity] and the zero3 cases "
          f"included); the times are "
          f"{world} processes "
          + ("sharing one card over gloo, not a sharded deployment's"
             if n_cards < world else f"on {n_cards} cards over {backend}"))
    return dict(out, unsharded_losses=want, unsharded_peak=want_peak)


def seq_lm_report(got, ref, cfg, variant, backend, n_cards, card) -> dict:
    """[seq lm]: each rank's run of gemma3-27b under `variant` with the
    "seq" cache (`got`, per rank) held to [tp lm]'s unsharded run as [tp
    lm] is (`check_tp_logits`); K8's partials mode launched once per
    layer a step on every rank (no rank's block of any leaf is empty: the
    prompt fills them) and K8 itself never; per rank the cache's bytes,
    prefill s, median ms a step, the collectives a step by kind."""
    tag = "seq lm"
    b, s = ref["tokens"].shape
    for r, rank in enumerate(got):
        assert rank["k8_partial"] == cfg.n_layers * TP_STEPS \
            and rank["k8"] == 0, (tag, r, rank["k8_partial"], rank["k8"])
    worst, greedy = check_tp_logits([rank["logits"] for rank in got], ref,
                                    tag)
    print(f"[{tag}] {cfg.name} in bfloat16 under attn_shard={variant!r} "
          f"(the \"seq\" cache: {s + TP_STEPS} positions, "
          f"{(s + TP_STEPS) // TP_WORLD} a rank; rings of "
          f"{min(cfg.sliding_window, s + TP_STEPS)}, "
          f"{min(cfg.sliding_window, s + TP_STEPS) // TP_WORLD} a rank) over "
          f"{TP_WORLD} ranks ({backend}; {n_cards} card(s): {card}) on [tp "
          f"lm]'s shards: prefill {b} x {s} tokens + {TP_STEPS} decode steps "
          f"fed the unsharded run's greedy tokens; logits within "
          f"{worst:.3f} of the bar ({TP_BF16_STD_TOL} x the step's logit "
          f"std) on all {len(got) * (TP_STEPS + 1) * b} rank-rows, {greedy} "
          f"greedy tokens equal; the ranks' logits bit-equal")
    for r, rank in enumerate(got):
        med = statistics.median(rank["step_ms"])
        print(f"[{tag}]   rank {r}: cache {rank['cache_bytes']} bytes; "
              f"prefill {rank['prefill_s']:.3f} s; median {med:.3f} ms a "
              f"decode step (min {min(rank['step_ms']):.3f}, max "
              f"{max(rank['step_ms']):.3f}); peak memory {rank['peak']} "
              f"bytes; K8 partial launches {rank['k8_partial']} = "
              f"{cfg.n_layers} x {TP_STEPS}, K8 {rank['k8']}; collectives a "
              f"step {({k: v / TP_STEPS for k, v in rank['calls'].items()})}"
              f", bytes a step "
              f"{sum(rank['bytes'].values()) / TP_STEPS:.0f}")
    return dict(k8_partial_per_rank=[rank["k8_partial"] for rank in got],
                step_ms_median=[statistics.median(rank["step_ms"])
                                for rank in got],
                prefill_s=[rank["prefill_s"] for rank in got],
                cache_bytes=[rank["cache_bytes"] for rank in got],
                peak_bytes=[rank["peak"] for rank in got],
                calls_per_step=[{k: v / TP_STEPS
                                 for k, v in rank["calls"].items()}
                                for rank in got],
                passes=[rank["passes"] for rank in got],
                worst_share_of_bar=worst, variant=variant)


# -- 8f. "tp" for the ssm, hybrid and encdec families -------------------------

def tp_calls_per_step(cfg, world: int) -> dict[str, int]:
    """The collectives of one decode step on each rank of cfg (rwkv6,
    zamba2 or seamless) under "tp" over `world` ranks: an all-reduce per
    row-parallel output projection (RWKV-6's time-mix wo and channel-mix
    wv; Mamba2's out_proj; the shared block's and seamless's attention wo,
    cross-attention wo and MLP wo) and per Mamba2 out_norm (its sum of
    squares over d_inner), an all-gather per RWKV-6 channel mix (the gated
    channels); with a vocabulary the ranks divide, one all-reduce for the
    embedding and one all-gather of the logits."""
    n = cfg.n_layers
    if cfg.arch_type == "ssm":
        sums, gathers = 2 * n, n
    elif cfg.arch_type == "hybrid":
        sums, gathers = 2 * n + 2 * Z.shared_applications(cfg), 0
    else:
        sums, gathers = 3 * n, 0
    cut = int(cfg.vocab % world == 0)
    want = {"all_reduce_sum": sums + cut, "all_gather": gathers + cut}
    return {k: v for k, v in want.items() if v}


def k8_decode_calls(cfg) -> int:
    """K8 launches of one decode step (or, under a sequence-sharded
    variant with every K/V leaf cut over its slots, launches of its
    partials mode): one a layer of a dense or moe model, k8_per_step's for
    the ssm and hybrid families, seamless's two a decoder layer (self and
    cross attention)."""
    if cfg.arch_type == "encdec":
        return 2 * cfg.n_layers
    if cfg.arch_type in ("ssm", "hybrid"):
        return k8_per_step(cfg)
    return cfg.n_layers


def seq_calls_per_step(cfg, world: int) -> dict[str, int]:
    """The collectives of one decode step of zamba2 or seamless under a
    sequence-sharded variant with every K/V leaf cut over its slots:
    `tp_calls_per_step`'s, and for each attention over such a leaf
    (k8_decode_calls of them) the all-gather of the token's heads, the
    all-reduce max and the one float32 sum of the partials' combine."""
    want = dict(tp_calls_per_step(cfg, world))
    for kind in ("all_gather", "all_reduce_max", "all_reduce_sum"):
        want[kind] = want.get(kind, 0) + k8_decode_calls(cfg)
    return want


def one_card_spread(params, cfg, ref, frontend=None) -> list[float]:
    """Per step of the teacher-fed rerun `ref` (tp_reference's, on the
    card), the largest |difference| between its logits and those of the
    same run with every weight upcast to float32 (exactly) and cfg.dtype
    float32: how far one card's bfloat16 run is from the function it
    computes. A rank run of that function in bfloat16, with other
    roundings, as far from it is within twice this of one card's
    (TP_SPREAD_FACTOR)."""
    exact = lm_serve(MB.tree_map(lambda a: a.float(), params),
                     dataclasses.replace(cfg, dtype=torch.float32),
                     ref["tokens"], TP_STEPS, "cuda", feed=ref["fed"],
                     frontend=frontend)
    free_cuda()
    return [float((a.float() - b.float()).abs().max())
            for a, b in zip(exact["logits"], ref["logits"])]


def std_share(got, ref) -> float:
    """The ranks' largest |logit difference| from `ref` as a share of
    check_tp_logits's own bar (TP_BF16_STD_TOL x the step's std)."""
    return max(float((torch.from_numpy(g) - w.float()).abs().max())
               / (TP_BF16_STD_TOL * float(w.float().std()))
               for rank in got for g, w in zip(rank, ref["logits"]))


def tp_family_cfg(arch: str, impl: str, vocab: int):
    """A [tp families parity] case's smoke config in float32."""
    cfg = dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32,
                              ssm_impl=impl)
    return dataclasses.replace(cfg, vocab=vocab) if vocab else cfg


def tp_family_inputs(cfg):
    """(tokens, frontend or None) of a [tp families parity] case, from
    numpy seed 3."""
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (TP_PARITY_BATCH, TP_PARITY_PROMPT)))
    if cfg.arch_type != "encdec":
        return tokens, None
    return tokens, torch.from_numpy((0.1 * rng.normal(size=(
        TP_PARITY_BATCH, ENCDEC_PARITY_FRAMES, cfg.d_model))).astype(
            np.float32))


def seq_family_case(arch: str, impl: str, vocab: int) -> bool:
    """Whether a [tp families parity] case is run again under the
    sequence-sharded variants ([seq families parity])."""
    return arch in SEQ_FAMILY_ARCHS and impl == "scan" and not vocab


def tp_families_parity_rank(mp, cases) -> dict:
    """[tp families parity] and [seq families parity], one rank: for each
    (key, arch, impl, vocab, feed) its shard of the perturbed float32
    smoke config (`perturbed`, seed 3 on the CPU), prefill and decode fed
    `feed` through lm_serve, under "auto" and, for a `seq_family_case`,
    under each sequence-sharded variant with the "seq" cache (key
    "key/variant"); the launch counts set to 0 before each run and read
    after it, the collectives of the prefill and of the decode steps, the
    run's seconds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, arch, impl, vocab, feed in cases:
        cfg = tp_family_cfg(arch, impl, vocab)
        tmpl = Z.templates(cfg)
        params = MB.shard_params(
            perturbed(cfg, torch.Generator().manual_seed(3)), tmpl,
            SHD.param_layouts(tmpl, mp.mesh), mp)
        params = MB.tree_map(lambda a: a.to(mp.device), params)
        tokens, frontend = tp_family_inputs(cfg)
        variants = (("auto", *SEQ_VARIANTS)
                    if seq_family_case(arch, impl, vocab) else ("auto",))
        for variant in variants:
            vcfg = dataclasses.replace(cfg, attn_shard=variant)
            t0 = time.perf_counter()
            ops.reset_launch_counts()        # this rank's path starts here
            mp.reset_counts()
            run = lm_serve(params, vcfg, tokens, len(feed), mp.device,
                           feed=[torch.as_tensor(f) for f in feed],
                           frontend=frontend, mp=mp)
            sync()
            counts = ops.launch_counts()     # ... and ends here
            decode = {k: v - run["prefill_calls"].get(k, 0)
                      for k, v in mp.calls.items()}
            out[key if variant == "auto" else f"{key}/{variant}"] = dict(
                logits=run["logits"], launches=counts,
                k8=counts["swa_decode"],
                k8_partial=counts["swa_decode_partial"],
                prefill_calls=run["prefill_calls"],
                decode_calls={k: v for k, v in decode.items() if v},
                calls=dict(mp.calls), seconds=time.perf_counter() - t0)
        del params
    return out


def phase_tp_families_parity(card: str) -> dict:
    """[tp families parity] TP_FAMILY_CASES (smoke configs, float32,
    perturbed) over TP_PARITY_WORLD ranks against the card's unsharded run
    of the same params: prefill of TP_PARITY_BATCH x TP_PARITY_PROMPT
    tokens (seamless over ENCDEC_PARITY_FRAMES frames) and TP_PARITY_STEPS
    decode steps, the ranks fed the unsharded run's greedy tokens: logits
    within TP_RTOL / TP_ATOL, greedy tokens exact where the margin exceeds
    TP_TOKEN_MARGIN, the ranks' logits bit-equal, on every rank K8 =
    k8_decode_calls x steps and no other kernel, and the collectives of
    each decode step `tp_calls_per_step`'s."""
    t0 = time.perf_counter()
    backend, devices = transport(TP_PARITY_WORLD, "cuda")
    refs, cases = {}, []
    for arch, impl, vocab in TP_FAMILY_CASES:
        cfg = tp_family_cfg(arch, impl, vocab)
        key = f"{cfg.name}/{impl}" + (f"/vocab{vocab}" if vocab else "")
        params = MB.tree_map(lambda a: a.to("cuda"), perturbed(
            cfg, torch.Generator().manual_seed(3)))
        tokens, frontend = tp_family_inputs(cfg)
        refs[key] = lm_serve(params, cfg, tokens, TP_PARITY_STEPS, "cuda",
                             frontend=frontend)
        cases.append((key, arch, impl, vocab,
                      [f.numpy() for f in refs[key]["fed"]]))
        del params
    free_cuda()
    ranks = spawn_ranks(TP_PARITY_WORLD, tp_families_parity_rank, (cases,),
                        device="cuda", timeout_s=600)
    out = {}
    for key, arch, impl, vocab, _ in cases:
        cfg = tp_family_cfg(arch, impl, vocab)
        want = refs[key]
        per_step = tp_calls_per_step(cfg, TP_PARITY_WORLD)
        err, greedy = 0.0, 0
        for r, rank in enumerate(ranks):
            got = rank[key]
            launches = {k: 0 for k in got["launches"]}
            launches["swa_decode"] = k8_decode_calls(cfg) * TP_PARITY_STEPS
            assert got["launches"] == launches, (key, r, got["launches"])
            assert got["decode_calls"] == {
                k: v * TP_PARITY_STEPS for k, v in per_step.items()}, (
                key, r, got["decode_calls"], per_step)
            for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
                g = torch.from_numpy(g)
                torch.testing.assert_close(
                    g, w, rtol=TP_RTOL, atol=TP_ATOL,
                    msg=lambda m: f"[tp families parity] {key} rank {r} "
                    f"step {i}: {m}")
                err = max(err, float((g - w).abs().max()))
                top2 = torch.topk(w, 2, dim=-1).values
                sure = (top2[:, 0] - top2[:, 1]) > TP_TOKEN_MARGIN
                assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure])
                greedy += int(sure.sum())
                np.testing.assert_array_equal(ranks[0][key]["logits"][i],
                                              got["logits"][i])
        assert greedy > 0, key
        k8 = [rank[key]["launches"]["swa_decode"] for rank in ranks]
        print(f"[tp families parity] {key} (float32, perturbed, vocab "
              f"{cfg.vocab}{' whole' if cfg.vocab % TP_PARITY_WORLD else ''})"
              f" over {TP_PARITY_WORLD} ranks ({backend}, "
              f"{len(set(map(str, devices)))} card(s), {card}) against the "
              f"card's unsharded run: prefill of {TP_PARITY_BATCH} x "
              f"{TP_PARITY_PROMPT} tokens + {TP_PARITY_STEPS} decode steps "
              f"fed its greedy tokens, max |err| {err:.3g} (bars rtol "
              f"{TP_RTOL}, atol {TP_ATOL}), {greedy} greedy tokens equal; the "
              f"ranks' logits bit-equal; K8 per rank {k8} = "
              f"{k8_decode_calls(cfg)} x {TP_PARITY_STEPS}, no other kernel; "
              f"collectives per rank: prefill {ranks[0][key]['prefill_calls']}"
              f", a decode step {per_step}")
        out[key] = dict(err=err, k8_per_rank=k8, calls_per_step=per_step)
    seq_s = 0.0
    for key, arch, impl, vocab, _ in cases:
        if not seq_family_case(arch, impl, vocab):
            continue
        cfg = tp_family_cfg(arch, impl, vocab)
        per_step = seq_calls_per_step(cfg, TP_PARITY_WORLD)
        for variant in SEQ_VARIANTS:
            got = [rank[f"{key}/{variant}"] for rank in ranks]
            for r, rank in enumerate(got):
                launches = {k: 0 for k in rank["launches"]}
                launches["swa_decode_partial"] = (k8_decode_calls(cfg)
                                                  * TP_PARITY_STEPS)
                assert rank["launches"] == launches, (key, variant, r,
                                                      rank["launches"])
                assert rank["decode_calls"] == {
                    k: v * TP_PARITY_STEPS for k, v in per_step.items()}, (
                    key, variant, r, rank["decode_calls"], per_step)
            out[f"{key}/{variant}"] = seq_parity_check(
                dataclasses.replace(cfg, attn_shard=variant), variant, got,
                refs[key], backend, card, tag="seq families parity")
            seq_s += got[0]["seconds"]
    print(f"[seq families parity] done: rank 0's runs {seq_s:.1f} s of "
          f"[tp families parity]'s spawn; a decode step's collectives per "
          f"rank as `seq_calls_per_step`")
    print(f"[tp families parity] done in {time.perf_counter() - t0:.1f} s "
          f"(with [seq families parity])")
    return out


def tp_families_lm_rank(mp, jobs) -> dict:
    """[tp families lm] and [seq families lm], one rank: for each job its
    shard of `family_lm_cfg` in bfloat16, drawn as `family_reference`
    drew it (seed 0 on the card) keeping only this rank's pieces, then the
    prompt (and an encdec model's frames) drawn on from the same generator
    as there (checked equal to the job's tokens),
    served by `tp_lm_serve` (key: the arch); where job["seq"] names a
    sequence-sharded variant, the same shard served again under it with
    the "seq" cache (key: "arch/seq", with its seconds)."""
    dev = mp.device
    out = {}
    for job in jobs:
        cfg = family_lm_cfg(job["arch"])
        tmpl = Z.templates(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = MB.materialize_shard(tmpl, gen, cfg.dtype,
                                      SHD.param_layouts(tmpl, mp.mesh), mp)
        sync()
        make_s = time.perf_counter() - t0
        b, s = job["tokens"].shape
        if cfg.arch_type == "encdec":
            tokens, frontend = encdec_batch(cfg, b, s, DECODE_ENC_LEN, gen)
        else:
            tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                   device=dev)
            frontend = None
        assert torch.equal(tokens.cpu(), torch.as_tensor(job["tokens"])), (
            job["arch"], "the prompt differs from the unsharded run's")
        shard_bytes = sum(a.numel() * a.element_size()
                          for a in MB.tree_leaves(params))
        out[job["arch"]] = dict(make_s=make_s, shard_bytes=shard_bytes,
                                **tp_lm_serve(mp, params, cfg, job, frontend))
        if job["seq"]:
            t0 = time.perf_counter()
            out[f"{job['arch']}/seq"] = dict(tp_lm_serve(
                mp, params, dataclasses.replace(cfg, attn_shard=job["seq"]),
                job, frontend), seconds=time.perf_counter() - t0)
        del params, frontend
        free_cuda()
    return out


def family_lm_cfg(arch: str):
    """[tp families lm]'s config of `arch`: its published widths cut to
    TP_FAMILY_LAYERS[arch] layers (an encdec model's encoder and decoder
    each)."""
    cfg, n = CFG.get(arch), TP_FAMILY_LAYERS[arch]
    return dataclasses.replace(
        cfg, n_layers=n, n_enc_layers=n if cfg.n_enc_layers else 0)


def family_reference(arch: str, card: str) -> dict:
    """What [tp families lm] holds its ranks to: `family_lm_cfg(arch)` in
    bfloat16 on one card, drawn from seed 0 on the card, the prompt of
    [ssm lm]'s / [encdec lm]'s batch (and DECODE_ENC_LEN frames) drawn on
    from the same generator, a prefill and TP_STEPS greedy decode steps
    (lm_serve: logits on the CPU, the tokens fed), and each step's
    `one_card_spread`."""
    cfg = family_lm_cfg(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
    if cfg.arch_type == "encdec":
        tokens, frontend = encdec_batch(cfg, ENCDEC_LM_BATCH,
                                        ENCDEC_LM_PROMPT, DECODE_ENC_LEN, gen)
    else:
        tokens = torch.randint(0, cfg.vocab, (SSM_LM_BATCH, SSM_LM_PROMPT),
                               generator=gen, device="cuda")
        frontend = None
    t0 = time.perf_counter()
    ref = dict(tokens=tokens.cpu(), **lm_serve(params, cfg, tokens, TP_STEPS,
                                               "cuda", frontend=frontend))
    ref["spread"] = one_card_spread(params, cfg, ref, frontend)
    assert all(bool(torch.isfinite(a).all()) for a in ref["logits"])
    print(f"[tp families lm] {cfg.name} unsharded on one card ({card}): "
          f"{cfg.param_count()} parameters in {cfg.dtype}, {cfg.n_layers} "
          f"layers"
          + (f" + {cfg.n_enc_layers} encoder layers"
             if cfg.arch_type == "encdec" else "")
          + f"; prefill {tuple(tokens.shape)} tokens + {TP_STEPS} greedy "
          f"decode steps and their float32 rerun in "
          f"{time.perf_counter() - t0:.3f} s; logits finite")
    del params, frontend
    free_cuda()
    return ref


def phase_tp_families_lm(card: str) -> dict:
    """[tp families lm] rwkv6-1.6b, zamba2-1.2b and seamless-m4t-large-v2
    at published widths cut to TP_FAMILY_LAYERS in bfloat16 over TP_WORLD
    ranks (one spawn), against the one-card runs of the same cuts
    (`family_reference`): the logits of the prefill and of each of TP_STEPS
    decode steps within the larger of TP_BF16_STD_TOL of the step's logit
    standard deviation and TP_SPREAD_FACTOR x one card's own bfloat16
    spread (`one_card_spread`) on every row, greedy tokens equal where the
    unsharded top-2 margin exceeds the bar (`check_tp_logits`), the
    ranks' logits bit-equal; on every rank K8 = k8_decode_calls x steps (its partials
    mode never) and the collectives of a decode step `tp_calls_per_step`'s;
    per rank the shard's and the cache's bytes, the peak memory, prefill
    s, median ms a step."""
    t0 = time.perf_counter()
    backend, devices = transport(TP_WORLD, "cuda")
    n_cards = len(set(map(str, devices)))
    refs = {arch: family_reference(arch, card) for arch in TP_FAMILY_ARCHS}
    ref_s = time.perf_counter() - t0
    jobs = [dict(arch=arch, tokens=refs[arch]["tokens"].numpy(),
                 feed=[f.numpy() for f in refs[arch]["fed"]], gates=None,
                 seq=SEQ_LM_VARIANT if arch in SEQ_FAMILY_ARCHS else None)
            for arch in TP_FAMILY_ARCHS]
    ranks = spawn_ranks(TP_WORLD, tp_families_lm_rank, (jobs,),
                        device="cuda", timeout_s=900)
    spawn_s = time.perf_counter() - t0 - ref_s
    out = {}
    where = ("sharing one card over gloo, not a sharded deployment's"
             if n_cards < TP_WORLD else f"on {n_cards} cards over {backend}")
    for arch in TP_FAMILY_ARCHS:
        cfg, ref = family_lm_cfg(arch), refs[arch]
        b, s = ref["tokens"].shape
        per_step = tp_calls_per_step(cfg, TP_WORLD)
        k8_want = k8_decode_calls(cfg) * TP_STEPS
        for r, rank in enumerate(ranks):
            got = rank[arch]
            assert got["k8"] == k8_want and got["k8_partial"] == 0, (
                arch, r, got["k8"], got["k8_partial"])
            assert got["calls"] == {k: v * TP_STEPS
                                    for k, v in per_step.items()}, (
                arch, r, got["calls"], per_step)
        got = [rank[arch]["logits"] for rank in ranks]
        worst, greedy = check_tp_logits(got, ref, "tp families lm",
                                        spread=ref["spread"])
        spread = max(sp / (TP_BF16_STD_TOL * float(w.float().std()))
                     for sp, w in zip(ref["spread"], ref["logits"]))
        alone = std_share(got, ref)
        frames = (f" over {DECODE_ENC_LEN} frames"
                  if cfg.arch_type == "encdec" else "")
        print(f"[tp families lm] {cfg.name}, {cfg.n_layers} layers"
              + (f" + {cfg.n_enc_layers} encoder layers"
                 if cfg.arch_type == "encdec" else "")
              + f" in bfloat16 (vocab {cfg.vocab}, "
              f"{'cut' if cfg.vocab % TP_WORLD == 0 else 'whole'} on each "
              f"rank), over {TP_WORLD} ranks ({backend}; {n_cards} card(s): "
              f"{card}): prefill {b} x {s} tokens{frames} + {TP_STEPS} decode "
              f"steps fed the unsharded run's greedy tokens; logits within "
              f"{worst:.3f} of the bar (the larger of {TP_BF16_STD_TOL} x the "
              f"step's logit std and {TP_SPREAD_FACTOR} x one card's own "
              f"bfloat16 spread) on all {len(ranks) * (TP_STEPS + 1) * b} "
              f"rank-rows: {alone:.3f} of the std bar alone, "
              f"where one card's bfloat16 run lies {spread:.3f} of it from "
              f"the same run in float32; {greedy} greedy tokens equal "
              f"(where the top-2 margin exceeds the bar); the ranks' logits "
              f"bit-equal; the times are {TP_WORLD} processes {where}")
        for r, rank in enumerate(ranks):
            got = rank[arch]
            med = statistics.median(got["step_ms"])
            print(f"[tp families lm]   {cfg.name} rank {r}: shard "
                  f"{got['shard_bytes']} bytes drawn in {got['make_s']:.2f} s;"
                  f" cache {got['cache_bytes']} bytes; prefill "
                  f"{got['prefill_s']:.3f} s; median {med:.3f} ms a decode "
                  f"step (min {min(got['step_ms']):.3f}, max "
                  f"{max(got['step_ms']):.3f}); peak memory {got['peak']} "
                  f"bytes; K8 launches {got['k8']} = {k8_decode_calls(cfg)} x "
                  f"{TP_STEPS}; collectives a step "
                  f"{ {k: v / TP_STEPS for k, v in got['calls'].items()} }, "
                  f"bytes a step {sum(got['bytes'].values()) / TP_STEPS:.0f}")
        out[arch] = dict(
            k8_per_rank=[rank[arch]["k8"] for rank in ranks],
            step_ms_median=[statistics.median(rank[arch]["step_ms"])
                            for rank in ranks],
            prefill_s=[rank[arch]["prefill_s"] for rank in ranks],
            shard_bytes=[rank[arch]["shard_bytes"] for rank in ranks],
            cache_bytes=[rank[arch]["cache_bytes"] for rank in ranks],
            peak_bytes=[rank[arch]["peak"] for rank in ranks],
            calls_per_step=per_step, worst_share_of_bar=worst,
            std_bar_share=alone, one_card_spread_share=spread,
            passes=[rank[arch]["passes"] for rank in ranks],
            backend=backend, cards=n_cards)
    for arch in SEQ_FAMILY_ARCHS:
        out[f"{arch}/seq"] = dict(seq_families_lm_report(
            [rank[f"{arch}/seq"] for rank in ranks], refs[arch],
            family_lm_cfg(arch), backend, n_cards, card),
            shard_bytes=out[arch]["shard_bytes"])
    print(f"[tp families lm] done in {time.perf_counter() - t0:.1f} s (the "
          f"ranks {spawn_s:.1f} s of it, [seq families lm] included); the "
          f"times are {TP_WORLD} processes " + where)
    return out


def seq_families_lm_report(got, ref, cfg, backend, n_cards, card) -> dict:
    """[seq families lm]: each rank's run of zamba2-1.2b or
    seamless-m4t-large-v2 under SEQ_LM_VARIANT with the "seq" cache
    (`got`, per rank) held to the teacher-fed rerun `ref` as [tp families
    lm] is (`check_tp_logits` with the one-card spread); on every rank
    K8's partials mode launched k8_decode_calls x TP_STEPS times, K8
    itself never, the collectives of a decode step `seq_calls_per_step`'s;
    per rank the cache's bytes, prefill s, median ms a step."""
    tag = "seq families lm"
    b, s = ref["tokens"].shape
    per_step = seq_calls_per_step(cfg, TP_WORLD)
    for r, rank in enumerate(got):
        assert rank["k8_partial"] == k8_decode_calls(cfg) * TP_STEPS \
            and rank["k8"] == 0, (tag, cfg.name, r, rank["k8_partial"],
                                  rank["k8"])
        assert rank["calls"] == {k: v * TP_STEPS
                                 for k, v in per_step.items()}, (
            tag, cfg.name, r, rank["calls"], per_step)
    logits = [rank["logits"] for rank in got]
    worst, greedy = check_tp_logits(logits, ref, tag, spread=ref["spread"])
    frames = (f", cross K/V {DECODE_ENC_LEN} frames, "
              f"{DECODE_ENC_LEN // TP_WORLD} a rank"
              if cfg.arch_type == "encdec" else "")
    print(f"[{tag}] {cfg.name} in bfloat16 under attn_shard="
          f"{SEQ_LM_VARIANT!r} (the \"seq\" cache: {s + TP_STEPS} positions,"
          f" {(s + TP_STEPS) // TP_WORLD} a rank{frames}) over {TP_WORLD} "
          f"ranks ({backend}; {n_cards} card(s): {card}) on [tp families "
          f"lm]'s shards: prefill {b} x {s} tokens + {TP_STEPS} decode steps "
          f"fed the unsharded run's greedy tokens; logits within "
          f"{worst:.3f} of [tp families lm]'s bar on all "
          f"{len(got) * (TP_STEPS + 1) * b} rank-rows "
          f"({std_share(logits, ref):.3f} of the std bar alone), {greedy} "
          f"greedy tokens equal; the ranks' logits bit-equal; "
          f"{got[0]['seconds']:.1f} s a rank")
    for r, rank in enumerate(got):
        med = statistics.median(rank["step_ms"])
        print(f"[{tag}]   {cfg.name} rank {r}: cache {rank['cache_bytes']} "
              f"bytes; prefill {rank['prefill_s']:.3f} s; median {med:.3f} "
              f"ms a decode step (min {min(rank['step_ms']):.3f}, max "
              f"{max(rank['step_ms']):.3f}); peak memory {rank['peak']} "
              f"bytes; K8 partial launches {rank['k8_partial']} = "
              f"{k8_decode_calls(cfg)} x {TP_STEPS}, K8 {rank['k8']}; "
              f"collectives a step "
              f"{ {k: v / TP_STEPS for k, v in rank['calls'].items()} }, "
              f"bytes a step {sum(rank['bytes'].values()) / TP_STEPS:.0f}")
    return dict(k8_partial_per_rank=[rank["k8_partial"] for rank in got],
                step_ms_median=[statistics.median(rank["step_ms"])
                                for rank in got],
                prefill_s=[rank["prefill_s"] for rank in got],
                cache_bytes=[rank["cache_bytes"] for rank in got],
                peak_bytes=[rank["peak"] for rank in got],
                seconds=[rank["seconds"] for rank in got],
                passes=[rank["passes"] for rank in got],
                calls_per_step=per_step, worst_share_of_bar=worst)


# -- 8h. [pod costs]: the pod dry run held to the ranks' own counts -----------

def train_counts(run) -> dict:
    """What [pod costs] reads of a `train_lm_rank` run: each step's
    collectives (calls and bytes put in), the bytes of params + m + v, the
    seconds of each step."""
    return {k: run[k] for k in ("calls", "bytes", "state_bytes", "seconds")}


def _by_rank(classes) -> dict[int, dict]:
    return {r: c for c in classes for r in c["ranks"]}


def _check_pass(tag, label, recs, got) -> None:
    """A pass's meta records (by rank) against each rank's own counts:
    collective calls and bytes by kind, K8's launches whole and
    partials, all equal."""
    for r, run in enumerate(got):
        rec = recs[r]
        k8 = rec["kernel_calls"]
        want = dict(calls=rec["calls"], bytes=rec["bytes"],
                    k8=k8.get("swa_decode", 0),
                    k8_partial=k8.get("swa_decode_partial", 0))
        assert want == run, (tag, label, r, want, run)


def shared_card_bound(recs: dict) -> tuple[float, str, float]:
    """(bound ms, by, collective ms) of one step of every rank in `recs`
    on ONE card: max(the ranks' FLOPs / the peak of the dtype their
    matmuls run in (the records' `dtype`), their bytes / HBM bandwidth);
    the collective term (at an H100 machine's links, the largest rank's)
    printed beside it, not priced: gloo moves it through the host."""
    _, RL = cost_report()
    (dtype,) = {rec["dtype"] for rec in recs.values()}
    flops = sum(rec["cost"]["flops"] for rec in recs.values())
    nbytes = sum(rec["cost"]["bytes accessed"] for rec in recs.values())
    t = {"compute": flops / RL.peak_flops(dtype), "memory": nbytes / RL.HBM_BW}
    by = max(t, key=t.get)
    coll = max(RL.collective_s(rec["collectives"]) for rec in recs.values())
    return 1e3 * t[by], by, 1e3 * coll


def pod_serve_row(tag: str, row: dict, card: str) -> dict:
    """One serving rank row (`tp_lm_serve`'s runs, per rank): its config,
    mesh and sizes as the ranks ran them (`passes`), each decode step and,
    but for the recurrent families' scan-form prefills (a trace steps
    through every prompt token: 9-14 s of host each, beside no check
    [pod costs] owes), the prefill traced on `meta` for every class of
    ranks (`dryrun.rank_class_records`), every rank's collectives and K8
    launches equal to its own counts pass by pass, its parameter and cache
    bytes equal to its shard's and cache's; the bound of the last step on
    the shared card (`shared_card_bound`) no slower than any rank's
    median step."""
    DR, _ = cost_report()
    t0 = time.perf_counter()
    passes = row["passes"]
    p0 = passes[0]
    base = CFG.get_smoke(p0["arch"]) if p0["smoke"] else CFG.get(p0["arch"])
    cfg = dataclasses.replace(base, n_layers=p0["n_layers"],
                              n_enc_layers=p0["n_enc_layers"],
                              attn_shard=p0["attn_shard"],
                              ssm_impl=p0["ssm_impl"], dtype=p0["dtype"])
    mesh = train_mesh(*p0["mesh"])
    kw = dict(batch=p0["batch"], max_len=p0["max_len"],
              enc_len=p0["enc_len"], mode=p0["mode"])
    classes, traced = [], []
    if cfg.arch_type not in ("ssm", "hybrid"):
        recs = _by_rank(DR.rank_class_records(
            dataclasses.replace(cfg, attn_shard=p0["prefill_shard"]),
            "prefill", mesh, seq_len=p0["prompt"], cache_cfg=cfg, **kw))
        _check_pass(tag, "prefill", recs, [p["prefill"] for p in passes])
        classes.append(len({id(rec) for rec in recs.values()}))
        traced.append(f"the {p0['prefill_shard']} prefill")
    for i in range(len(p0["decode"])):
        recs = _by_rank(DR.rank_class_records(
            cfg, "decode", mesh, seq_len=p0["max_len"],
            cache_len=p0["prompt"] + i, **kw))
        _check_pass(tag, f"decode {i}", recs, [p["decode"][i] for p in passes])
    classes.append(len({id(rec) for rec in recs.values()}))
    traced.append(f"{len(p0['decode'])} {cfg.attn_shard} decode steps")
    for r in recs:
        assert recs[r]["argument_bytes"]["params"] == row["shard_bytes"][r] \
            and recs[r]["argument_bytes"]["cache"] == \
            row["cache_bytes"][r], (tag, r, recs[r]["argument_bytes"])
    bound, by, coll = shared_card_bound(recs)
    med = row["step_ms_median"]
    assert min(med) >= bound, (tag, med, bound)
    line = (f"[pod costs] {tag}: {cfg.name}, {cfg.n_layers} layers, "
            f"{p0['mode']!r}, {len(passes)} ranks "
            f"({' / '.join(map(str, classes))} "
            f"class(es)): {' and '.join(traced)} traced on meta, every "
            f"rank's collectives (calls and bytes by kind) and K8 launches "
            f"equal its own, its shard and cache bytes too; one step of all "
            f"ranks on one card ({card}) bound {bound:.4f} ms by {by} "
            f"(collective term {coll:.4f} ms a rank at H100 links, not "
            f"priced for gloo); medians {min(med):.3f}-{max(med):.3f} ms a "
            f"step, the bound {bound / min(med):.2%} of the fastest")
    return dict(bound_ms=bound, bound_by=by, collective_ms=coll,
                median_ms=med, classes=classes, line=line,
                seconds=time.perf_counter() - t0)


def pod_train_row(tag: str, runs: list, cfg, mesh, mode: str,
                  card: str, batch: int = LM_TRAIN_BATCH,
                  seq: int = LM_TRAIN_SEQ) -> dict:
    """One training rank row (`train_counts` per rank of
    `train_lm_rank`'s run of cfg on `mesh` under `mode`): an Adam step
    traced on `meta` for every class of ranks, every step's collectives of
    every rank equal to the trace's, no kernel, params + m + v equal to
    the rank's state bytes; the bound of a step of all ranks on the shared
    card no slower than any rank's median step."""
    DR, _ = cost_report()
    t0 = time.perf_counter()
    recs = _by_rank(DR.rank_class_records(
        cfg, "train", mesh, batch=batch, seq_len=seq, mode=mode,
        param_dtype=torch.float32))
    for r, run in enumerate(runs):
        rec = recs[r]
        for i, (calls, nbytes) in enumerate(zip(run["calls"], run["bytes"])):
            assert (rec["calls"], rec["bytes"]) == (calls, nbytes), (
                tag, r, i, rec["calls"], calls, rec["bytes"], nbytes)
        assert not rec["kernel_calls"], (tag, rec["kernel_calls"])
        held = rec["argument_bytes"]
        assert held["params"] + held["opt_state"] - 4 == run["state_bytes"], (
            tag, r, held, run["state_bytes"])
    bound, by, coll = shared_card_bound(recs)
    med = [1e3 * statistics.median(run["seconds"]) for run in runs]
    assert min(med) >= bound, (tag, med, bound)
    line = (f"[pod costs] {tag}: {cfg.name}, {cfg.n_layers} layer(s), "
          f"float32 weights, {mode!r} + {cfg.attn_shard!r} over "
          f"{mesh.sizes[0]} x {mesh.sizes[1]} ranks "
          f"({len({id(rec) for rec in recs.values()})} classes): an Adam "
          f"step traced on meta, every step's collectives of every rank "
          f"equal its own, params + m + v its state bytes, no kernel; one "
          f"step of all ranks on one card ({card}) bound {bound:.3f} ms by "
          f"{by} at the float32 peak (collective term {coll:.3f} ms a rank "
          f"at H100 links, not priced for gloo); medians {min(med):.1f}-"
          f"{max(med):.1f} ms a step, the bound {bound / min(med):.2%} of "
          f"the fastest")
    return dict(bound_ms=bound, bound_by=by, collective_ms=coll,
                median_ms=med, line=line, seconds=time.perf_counter() - t0)


def phase_pod_costs(card: str, tp_lm: dict, tp_qsplit: dict, fsdp: dict,
                    tp_families_lm: dict) -> dict:
    """[pod costs]: the pod dry run (`launch/dryrun.py` `rank_record`, the
    counting transport) held on the host to the spawns that ran on the
    card, no new spawn: every rank row (`pod_serve_row`: [tp lm], [seq
    lm], [tp moe], [tp kvrep lm], [tp qsplit lm] under "tp", "seqkv" and
    "zero3", [tp families lm], [seq families lm], [zero3 serve parity])
    and the training rows (`pod_train_row`: [shmap train lm], [fsdp lm]
    under each of FSDP_MODES, [zero3 lm], [zero3 families parity]), each
    rank's counts equal to the trace's, each row's
    bound printed beside its medians. The rows are traced in [costs]'s
    pool (`host_pool`), the longest first."""
    t0 = time.perf_counter()
    rows = {"tp lm": tp_lm[LM_ARCH], "seq lm": tp_lm[f"{LM_ARCH}/seq"],
            "tp moe": tp_lm[TP_MOE_ARCH],
            "tp kvrep lm": tp_lm[KVREP_LM_ARCH],
            **{f"tp qsplit lm {arch}{'' if key == arch else ' seqkv'}":
               tp_qsplit[key] for arch in QSPLIT_LM_ARCHS
               for key in (arch, f"{arch}/seq")},
            **{f"tp families lm {arch}": tp_families_lm[arch]
               for arch in TP_FAMILY_ARCHS},
            **{f"seq families lm {arch}": tp_families_lm[f"{arch}/seq"]
               for arch in SEQ_FAMILY_ARCHS},
            f"tp qsplit lm {ZERO3_QSPLIT_ARCH} zero3":
                tp_qsplit[f"{ZERO3_QSPLIT_ARCH}/zero3"],
            **{f"zero3 serve parity {arch}": fsdp[f"zero3 serve/{arch}"]
               for arch in ZERO3_SERVE_ARCHS}}
    lm = (LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    train = {"shmap train lm": (
        tp_qsplit["train"]["runs"],
        TLT.lm_config(SHMAP_LM_ARCH, False, SHMAP_LM_LAYERS,
                      attn_shard="shmap"), train_mesh(1, QSPLIT_WORLD), "tp",
        *lm),
        **{f"fsdp lm {mode}": (
            fsdp[f"lm/{mode}"]["runs"],
            TLT.lm_config(FSDP_LM_ARCH, False, FSDP_LM_LAYERS),
            train_mesh(*FSDP_MESH), mode, *lm) for mode in FSDP_MODES},
        **{f"zero3 lm {arch}": (
            fsdp[f"zero3 lm/{arch}"]["runs"],
            TLT.lm_config(arch, False, layers, "chunked"),
            train_mesh(*FSDP_MESH), "zero3", *lm)
           for arch, layers in ZERO3_LM_ARCHS.items()},
        **{f"zero3 families parity {key}": (
            fsdp[f"zero3 family/{key}"]["runs"], zero3_family_cfg(key),
            train_mesh(*FSDP_MESH), "zero3", FSDP_PARITY_BATCH,
            FSDP_PARITY_SEQ) for key in ZERO3_FAMILY_PARITY}}
    pool = host_pool()
    # the longest first: gemma3's prefills of 4 x 2048 tokens, then the
    # 16 ranks' rows
    order = sorted(rows, key=lambda tag: (tag not in ("tp lm", "seq lm"),
                                          "qsplit" not in tag))
    futures = {tag: pool.submit(pod_serve_row, tag, rows[tag], card)
               for tag in order}
    futures.update({tag: pool.submit(pod_train_row, tag, *args[:4], card,
                                     *args[4:])
                     for tag, args in train.items()})
    out = {tag: futures[tag].result() for tag in (*rows, *train)}
    for r in out.values():
        print(r["line"])
    seconds = time.perf_counter() - t0
    print(f"[pod costs] {len(out)} rank rows traced on meta tensors and "
          f"held to the ranks' counts in {seconds:.1f} s on the host "
          f"({HOST_WORKERS} processes; each row's own seconds "
          f"{ {tag: round(r['seconds'], 1) for tag, r in out.items()} })")
    return dict(rows=out, seconds=seconds)


# -- 8g. "tp" training of the ssm, hybrid and encdec families -----------------

def family_train_cfg(arch: str):
    """A [tp families train] config (`train_lm_rank`'s): published widths,
    FAMILY_TRAIN_ARCHS' depth and ssm_impl; the weights are drawn in
    float32."""
    impl, layers = FAMILY_TRAIN_ARCHS[arch]
    return TLT.lm_config(arch, False, layers, impl)


def family_train_calls(cfg, mesh) -> dict[str, int]:
    """The collectives of one "tp" training step on each rank of a (D, M)
    mesh, M > 1 (tests/test_torch_train_families.py's formula): with the
    vocabulary cut (V = 1) the embedding's sum and the logits' gather; the
    head input's backward sum; per layer rwkv6 14 sums and 1 gather (its
    channel mix), zamba2 10 sums and 4 per shared-block application,
    seamless 7 sums and 4 per encoder layer; where D > 1 the loss's and
    the gradients' sums over "data"."""
    d, m = mesh
    vocab = int(cfg.vocab % m == 0)
    sums, gathers = vocab + 1, vocab
    if cfg.arch_type == "ssm":
        sums, gathers = sums + 14 * cfg.n_layers, gathers + cfg.n_layers
    elif cfg.arch_type == "hybrid":
        sums += 10 * cfg.n_layers + 4 * Z.shared_applications(cfg)
    else:
        sums += 7 * cfg.n_layers + 4 * cfg.n_enc_layers
    return {"all_reduce_sum": sums + (2 if d > 1 else 0),
            "all_gather": gathers}


def family_train_rank(mp) -> dict:
    """[tp families train], one rank of FAMILY_TRAIN_MESH: `train_lm_rank`
    of each FAMILY_TRAIN_ARCHS config under "tp", the launch counts set to
    0 before it and read after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, (impl, layers) in FAMILY_TRAIN_ARCHS.items():
        free_cuda()
        ops.reset_launch_counts()            # this rank's path starts here
        run = TLT.train_lm_rank(mp, arch, layers, "tp", LM_TRAIN_STEPS,
                                LM_TRAIN_BATCH, LM_TRAIN_SEQ, 0, False,
                                FAMILY_TRAIN_LR, impl)
        sync()
        run["launches"] = ops.launch_counts()    # ... and ends here
        out[arch] = run
    return out


def phase_tp_families_train(card: str) -> dict:
    """[tp families train] FAMILY_TRAIN_ARCHS under "tp" over
    FAMILY_TRAIN_MESH's ranks sharing the card (one spawn), after the
    card's unsharded runs of the same steps (`launch.train
    .lm_train_steps`, the launcher's draw and batches): every rank's
    losses within LM_TRAIN_RTOL of the unsharded run's, its params + m + v
    the bytes of its pieces (`layout_bytes`), the collectives of every step
    `family_train_calls`', no kernel of the table launched (the train
    step reaches none, in the reference either), and every two ranks
    holding the same pieces of a leaf holding equal bits of it in params,
    m and v (`shared_bits`). Prints per rank the state and peak bytes,
    seconds a step and the collectives a step with their bytes."""
    t0 = time.perf_counter()
    world = FAMILY_TRAIN_MESH[0] * FAMILY_TRAIN_MESH[1]
    backend, devices = transport(world, "cuda")
    n_cards = len(set(map(str, devices)))
    mesh = train_mesh(*FAMILY_TRAIN_MESH)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = {}
    for arch in FAMILY_TRAIN_ARCHS:
        cfg = family_train_cfg(arch)
        torch.cuda.reset_peak_memory_stats()
        out_text = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out_text):
            losses = TLT.lm_train_steps(cfg, LM_TRAIN_STEPS, LM_TRAIN_BATCH,
                                        LM_TRAIN_SEQ, 0, FAMILY_TRAIN_LR,
                                        "cuda")
        sync()
        want[arch] = dict(losses=losses, s=time.perf_counter() - t1,
                          peak=torch.cuda.max_memory_allocated(),
                          head=out_text.getvalue().splitlines()[0]
                          .removeprefix("[train] "))
        free_cuda()
    ref_s = time.perf_counter() - t0
    ranks = spawn_ranks(world, family_train_rank, (), device="cuda",
                        timeout_s=900, mesh=mesh)
    spawn_s = time.perf_counter() - t0 - ref_s
    out = {}
    for arch in FAMILY_TRAIN_ARCHS:
        cfg, ref = family_train_cfg(arch), want[arch]
        got = [rank[arch] for rank in ranks]
        calls = family_train_calls(cfg, FAMILY_TRAIN_MESH)
        err = max(abs(a - c) / abs(c) for run in got
                  for a, c in zip(run["losses"], ref["losses"]))
        for r, run in enumerate(got):
            assert np.isfinite(run["losses"]).all(), run["losses"]
            np.testing.assert_allclose(run["losses"], ref["losses"],
                                       rtol=LM_TRAIN_RTOL)
            assert run["state_bytes"] == layout_bytes(cfg, mesh, "tp", r), (
                arch, r, run["state_bytes"])
            assert all(c == calls for c in run["calls"]), (arch, r,
                                                           run["calls"])
            assert not any(run["launches"].values()), run["launches"]
        shared, differ = shared_bits(cfg, mesh, "tp", got)
        assert shared and not differ, (arch, shared, differ)
        print(f"[tp families train] {ref['head']}, {cfg.ssm_impl} form, lr "
              f"{FAMILY_TRAIN_LR}: the unsharded run on the card "
              f"{ref['s']:.2f} s (first-call work included), losses "
              f"{ref['losses']}, peak memory {ref['peak']} bytes")
        print(f"[tp families train] {cfg.name} under 'tp' over "
              f"{FAMILY_TRAIN_MESH[0]} x {FAMILY_TRAIN_MESH[1]} ranks "
              f"({backend}; {n_cards} card(s): {card}): losses "
              f"{got[0]['losses']}, max relative err against the unsharded "
              f"run {err:.3g} (bar {LM_TRAIN_RTOL}); every two ranks holding "
              f"the same pieces of a leaf hold equal bits of it in params, m "
              f"and v ({shared} such leaves); collectives a step {calls}")
        for r, run in enumerate(got):
            step = {k: (v, run["bytes"][-1][k])
                    for k, v in run["calls"][-1].items()}
            print(f"[tp families train]   {cfg.name} rank {r}: "
                  f"{run['backend']}, {run['cards']} card(s); state "
                  f"{run['state_bytes']} bytes (the unsharded "
                  f"{layout_bytes(cfg, train_mesh(1, 1), 'tp', 0)}); peak "
                  f"{run['peak_bytes']} bytes "
                  f"({run['peak_bytes'] / ref['peak']:.3f} of the unsharded "
                  f"run's); seconds a step "
                  f"{[round(v, 3) for v in run['seconds']]}; collectives a "
                  f"step (calls, bytes) {step}; kernel launches "
                  f"{sum(run['launches'].values())}")
        out[arch] = dict(losses=got[0]["losses"], unsharded=ref["losses"],
                         max_rel_err=err, shared_leaves=shared,
                         state_bytes=[run["state_bytes"] for run in got],
                         peak_bytes=[run["peak_bytes"] for run in got],
                         step_s=[run["seconds"] for run in got],
                         calls=calls)
    print(f"[tp families train] done in {time.perf_counter() - t0:.1f} s "
          f"(the unsharded runs {ref_s:.1f} s, the ranks {spawn_s:.1f} s); "
          f"the times are {world} processes "
          + ("sharing one card over gloo, not a sharded deployment's"
             if n_cards < world else f"on {n_cards} cards over {backend}"))
    return out


# -- 8c. the ssm and hybrid families: rwkv6 and zamba2 -------------------------

def perturbed(cfg, gen: torch.Generator) -> dict:
    """cfg's weights drawn on the generator's device in cfg.dtype, every
    leaf the templates initialise to zeros or ones plus SSM_NOISE * N(0,
    1)."""
    tmpl = Z.templates(cfg)
    params = MB.materialize(tmpl, gen, dtype=cfg.dtype)

    def bump(t, p):
        if t.init not in ("zeros", "ones"):
            return p
        noise = torch.randn(p.shape, generator=gen, device=p.device)
        return p + (SSM_NOISE * noise).to(p.dtype)
    return MB.tree_map(bump, tmpl, params)


def k8_per_step(cfg) -> int:
    """K8 launches of one decode step: one per shared-block application of
    a hybrid, none for the ssm family."""
    return Z.shared_applications(cfg) if cfg.arch_type == "hybrid" else 0


def phase_ssm_parity() -> dict:
    """Each SSM_PARITY_CASES config in float32 (perturbed weights) on the
    card against the same weights on the CPU: the forward's logits in both
    ssm_impl forms, then a prompt's prefill and SSM_PARITY_STEPS greedy
    decode steps fed the CPU's tokens: logits within MOE_LOGIT_TOL (the
    same 2e-4) at every step, the greedy token exactly where the margin
    allows; K8 once per shared-block application per decode step for
    zamba2, no kernel at all for rwkv6 (counts set to 0 before the card's
    prefill, read after its last step)."""
    out = {}
    for arch, layers in SSM_PARITY_CASES:
        cfg = dataclasses.replace(CFG.get_smoke(arch), dtype=torch.float32)
        cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
        cpu_params = perturbed(cfg, torch.Generator().manual_seed(3))
        params = MB.tree_map(lambda a: a.to("cuda"), cpu_params)
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (SSM_PARITY_BATCH, SSM_PARITY_PROMPT)))
        fwd_err = {}
        for impl in ("scan", "chunked"):
            c = dataclasses.replace(cfg, ssm_impl=impl)
            lg, aux = Z.forward(params, c, {"tokens": tokens.to("cuda")})
            lg_c, _ = Z.forward(cpu_params, c, {"tokens": tokens})
            torch.testing.assert_close(lg.cpu(), lg_c, rtol=MOE_LOGIT_TOL,
                                       atol=MOE_LOGIT_TOL)
            assert float(aux) == 0.0, aux
            fwd_err[impl] = float((lg.cpu() - lg_c).abs().max())
        cpu = lm_serve(cpu_params, cfg, tokens, SSM_PARITY_STEPS, "cpu")
        ops.reset_launch_counts()        # the card's engine path starts here
        card = lm_serve(params, cfg, tokens, SSM_PARITY_STEPS, "cuda",
                        feed=cpu["fed"])
        sync()
        launches = ops.launch_counts()   # ... and ends here
        want = {k: 0 for k in launches}
        want["swa_decode"] = k8_per_step(cfg) * SSM_PARITY_STEPS
        assert launches == want, (arch, launches, want)
        greedy = sum(check_greedy(g, w, f"{cfg.name} step {i}") for i, (g, w)
                     in enumerate(zip(card["logits"], cpu["logits"])))
        assert greedy > 0, arch
        err = max(float((g - w).abs().max())
                  for g, w in zip(card["logits"], cpu["logits"]))
        tag = f"{cfg.name}-L{cfg.n_layers}"
        print(f"[ssm parity] {cfg.name} at {cfg.n_layers} layers (float32, "
              "perturbed) on the card against "
              f"the CPU: forward of {SSM_PARITY_BATCH} x {SSM_PARITY_PROMPT} "
              f"tokens max |err| scan {fwd_err['scan']:.3g}, chunked "
              f"{fwd_err['chunked']:.3g}; prefill + {SSM_PARITY_STEPS} greedy "
              f"decode steps max |err| {err:.3g} (bar {MOE_LOGIT_TOL}), "
              f"{greedy} greedy tokens equal; K8 x {launches['swa_decode']}"
              f" = {k8_per_step(cfg)} x {SSM_PARITY_STEPS}, no other kernel")
        out[tag] = dict(fwd_err=fwd_err, decode_err=err,
                        k8_launches=launches["swa_decode"])
        del params
    free_cuda()
    return out


def phase_ssm_lm(card: str) -> dict:
    """Each ssm / hybrid config at its published widths and full depth in
    bfloat16 (the weights drawn on the card): prefill of SSM_LM_BATCH
    prompts of SSM_LM_PROMPT tokens through the chunked form and through
    the scan (each timed on the host clock around a sync; the largest gap
    between their last logits printed), then SSM_LM_STEPS greedy decode
    steps from the scan's cache, finite logits; K8 once per shared-block
    application per step and nothing else counted (counts set to 0 before
    the first prefill, read after the last step); ms per step (CUDA events,
    median), asserted no faster than the cost report's bound for the step
    and printed beside it, the CUDA kernel launches of one more step, a
    profile of LM_PROFILE_STEPS more (device idle share) and peak memory;
    each beside the card's name and power limit."""
    out = {}
    for arch in SSM_ARCHS:
        cfg = CFG.get(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
        sync()
        make_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size()
                     for t in MB.tree_leaves(params))
        b, s, steps = SSM_LM_BATCH, SSM_LM_PROMPT, SSM_LM_STEPS
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               device="cuda")
        sync()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()        # the path starts here
        prefill_s, last = {}, {}
        for impl in ("chunked", "scan"):
            c = dataclasses.replace(cfg, ssm_impl=impl)
            cache = E.init_cache(c, b, s + steps + LM_PROFILE_STEPS,
                                 device="cuda")
            sync()
            t0 = time.perf_counter()
            logits, cache = E.prefill(params, c, {"tokens": tokens}, cache)
            sync()
            prefill_s[impl] = time.perf_counter() - t0
            last[impl] = logits[:, -1].float()
        gap = float((last["scan"] - last["chunked"]).abs().max())
        scale = float(last["scan"].abs().max())
        finite = torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        generated = []
        events[0].record()
        for i in range(steps):
            logits, cache = E.decode_step(params, cfg, tok, cache, s + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            finite &= torch.isfinite(logits).all()
            generated.append(tok)
            events[i + 1].record()
        sync()
        launches = ops.launch_counts()   # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        assert bool(finite), f"{arch}: non-finite logits"
        want = {k: 0 for k in launches}
        want["swa_decode"] = k8_per_step(cfg) * steps
        assert launches == want, (launches, want)
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(steps)]
        med = statistics.median(step_ms)
        per_step, kernels, _ = cuda_launches_per_call(
            lambda: E.decode_step(params, cfg, tok, cache, s + steps),
            calls=2)
        bnd = decode_bound(cfg, b, s + steps + LM_PROFILE_STEPS,
                           s + steps - 1)
        floor_ms = bnd["bound_ms"]
        extra = (f", {Z.shared_applications(cfg)} shared-block applications"
                 if cfg.arch_type == "hybrid" else "")
        print(f"[ssm lm] {cfg.name}: {cfg.n_layers} layers{extra} at the "
              f"published widths, {cfg.param_count()} parameters, {nbytes} "
              f"bytes in {cfg.dtype} made on the card in {make_s:.1f} s")
        print(f"[ssm lm] {cfg.name} on {card}: prefill B={b} x {s} tokens "
              f"chunked {prefill_s['chunked']:.3f} s, scan "
              f"{prefill_s['scan']:.3f} s, last logits max |scan - chunked| "
              f"{gap:.3g} (logits up to {scale:.3g}); {steps} greedy decode "
              f"steps at B={b}: median {med:.3f} ms per step (first "
              f"{step_ms[0]:.3f}, min {min(step_ms):.3f}, max "
              f"{max(step_ms):.3f}), {b / med * 1e3:.1f} tokens/s; "
              f"{per_step:.0f} CUDA kernel launches per step "
              f"({kernels / 2:.0f} kernels on the device); peak memory "
              f"{peak} bytes; K8 launches {launches['swa_decode']} = "
              f"{k8_per_step(cfg)} x {steps}")
        print(f"[ssm lm] {cfg.name} decode step: "
              f"{bound_note('ssm lm', med, bnd)}")
        print(f"[ssm lm] {cfg.name} greedy tokens of sequence 0: "
              f"{torch.cat(generated, 1)[0].tolist()}")
        profile = profile_decode(params, cfg, cache, tok, s + steps,
                                 tag="ssm lm")
        del cache
        out[arch] = dict(params=cfg.param_count(), param_bytes=nbytes,
                         prefill_s=prefill_s, scan_chunked_gap=gap,
                         step_ms_median=med, floor_ms=floor_ms,
                         launches_per_step=per_step,
                         device_idle_share=profile["device_idle_share"],
                         peak_bytes=peak, k8_launches=launches["swa_decode"])
        del params, logits, last
        free_cuda()
    return out


def phase_ssm_lm_check() -> dict:
    """Each ssm / hybrid config at full width cut to SSM_CHECK_LAYERS in
    float32 (perturbed weights drawn on the card, then copied to the CPU):
    a prompt's prefill and SSM_CHECK_STEPS greedy decode steps on the card
    (K8 once per shared-block application per step), and the chunked
    form's prefill, then the same on the CPU fed the card's tokens: logits
    within MOE_LOGIT_TOL (the same 2e-4) at every step, greedy tokens
    exact where the margin allows. Runs after every phase timed on the
    host's clock."""
    out = {}
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(CFG.get(arch),
                                  n_layers=SSM_CHECK_LAYERS[arch],
                                  dtype=torch.float32)
        chunked = dataclasses.replace(cfg, ssm_impl="chunked")
        gen = torch.Generator(device="cuda").manual_seed(2)
        params = perturbed(cfg, gen)
        b, s = SSM_CHECK_BATCH, SSM_CHECK_PROMPT
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               device="cuda").cpu()
        ops.reset_launch_counts()        # the card's path starts here
        card = lm_serve(params, cfg, tokens, SSM_CHECK_STEPS, "cuda")
        sync()
        k8 = ops.launch_counts()["swa_decode"]      # ... and ends here
        assert k8 == k8_per_step(cfg) * SSM_CHECK_STEPS, (arch, k8)
        card_chunked = E.prefill(params, chunked, {"tokens": tokens.to("cuda")},
                                 E.init_cache(chunked, b, s,
                                              device="cuda"))[0].cpu()
        params = MB.tree_map(lambda a: a.cpu(), params)
        free_cuda()
        t0 = time.perf_counter()
        cpu = lm_serve(params, cfg, tokens, SSM_CHECK_STEPS, "cpu",
                       feed=card["fed"])
        cpu_chunked = E.prefill(params, chunked, {"tokens": tokens},
                                E.init_cache(chunked, b, s, device="cpu"))[0]
        cpu_s = time.perf_counter() - t0
        greedy = sum(check_greedy(g, w, f"{cfg.name} step {i}") for i, (g, w)
                     in enumerate(zip(card["logits"], cpu["logits"])))
        greedy += check_greedy(card_chunked[:, -1], cpu_chunked[:, -1],
                               f"{cfg.name} chunked prefill")
        err = max(float((g - w).abs().max())
                  for g, w in zip(card["logits"], cpu["logits"]))
        err_chunked = float((card_chunked - cpu_chunked).abs().max())
        scale = max(float(w.abs().max()) for w in cpu["logits"])
        print(f"[ssm lm check] {cfg.name} at full width, {cfg.n_layers} "
              f"layers, float32, perturbed ({cfg.param_count()} parameters): "
              f"prefill of {b} x {s} tokens + {SSM_CHECK_STEPS} greedy decode "
              f"steps (K8 x {k8}) on the card against the CPU ({cpu_s:.1f} "
              f"s): max |err| {err:.3g}, chunked prefill {err_chunked:.3g} "
              f"(bar {MOE_LOGIT_TOL}; logits up to {scale:.3g}), {greedy} "
              "greedy tokens equal")
        out[arch] = dict(err=err, err_chunked=err_chunked, k8_launches=k8)
        del params
    return out


def phase_ssm_train() -> dict:
    """The launcher's --target lm on the card for each ssm / hybrid config
    at full width cut to SSM_CHECK_LAYERS: SSM_TRAIN_STEPS Adam steps at
    SSM_TRAIN_LR (the weights drawn on the CPU from the seed, so both
    devices start alike), finite losses within LM_TRAIN_RTOL of the same
    steps on the CPU (checked once both configs have run)."""
    out = {}
    for arch in SSM_ARCHS:
        layers = SSM_CHECK_LAYERS[arch]
        args = ["--target", "lm", "--arch", arch, "--layers", str(layers),
                "--steps", str(SSM_TRAIN_STEPS), "--batch",
                str(SSM_TRAIN_BATCH), "--seq", str(SSM_TRAIN_SEQ), "--lr",
                str(SSM_TRAIN_LR)]
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            card = TLT.main(args + ["--device", "cuda"])
            sync()
            seconds = time.perf_counter() - t0
            free_cuda()
            t0 = time.perf_counter()
            cpu = TLT.main(args + ["--device", "cpu"])
            cpu_s = time.perf_counter() - t0
        head = log.getvalue().splitlines()[0]
        assert f"{layers} layers" in head, head
        assert len(card) == SSM_TRAIN_STEPS and np.isfinite(card).all(), card
        errs = [abs(a - c) / abs(c) for a, c in zip(card, cpu)]
        err = max(errs)
        print(f"[ssm train] {head.removeprefix('[train] ')}: B="
              f"{SSM_TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens, lr "
              f"{SSM_TRAIN_LR}, {seconds:.2f} s on the card (first-call work "
              f"included), {cpu_s:.2f} s on the CPU; losses "
              f"{[round(v, 4) for v in card]}, relative err against the CPU "
              f"per step {[float(f'{e:.3g}') for e in errs]} (bar "
              f"{LM_TRAIN_RTOL})")
        out[arch] = dict(losses=card, cpu_losses=cpu, max_rel_err=err)
    for arch, r in out.items():
        np.testing.assert_allclose(r["losses"], r["cpu_losses"],
                                   rtol=LM_TRAIN_RTOL, err_msg=arch)
    return out


# -- 8d. the encdec family: seamless-m4t-large-v2 -------------------------------

def encdec_batch(cfg, b, s, frames, gen) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens (b, s), frontend (b, frames, d) float32 0.1 N(0, 1)) drawn
    with `gen` on its device."""
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=gen.device)
    frontend = 0.1 * torch.randn((b, frames, cfg.d_model), generator=gen,
                                 device=gen.device)
    return tokens, frontend


def decode_gap(params, cfg, tokens, frontend, run) -> tuple[float, float]:
    """The largest gap between an lm_serve run's logits (its prefill's
    and each decode step's) and the model's forward over the prompt and
    the tokens fed, and the forward's largest logit there."""
    s = tokens.shape[1]
    seq = torch.cat([tokens.to(frontend.device)]
                    + [t.to(frontend.device) for t in run["fed"]], 1)
    full, _ = Z.forward(params, cfg, {"tokens": seq, "frontend": frontend})
    want = full[:, s - 1:].float().cpu()
    got = torch.stack([lg.float() for lg in run["logits"]], 1)
    return (float((got - want).abs().max()), float(want.abs().max()))


def phase_encdec_parity() -> dict:
    """seamless-smoke in float32, perturbed, on the card against the same
    weights on the CPU: the forward's logits, then a prompt's prefill over
    ENCDEC_PARITY_FRAMES frames and ENCDEC_PARITY_STEPS greedy decode steps
    fed the CPU's tokens, and the neural scorer (`build_neural`'s) on the
    same items, all within ENCDEC_PARITY_TOL; the greedy token exactly
    where the margin allows; K8 twice per decoder layer per step (self and
    cross attention) and no other kernel (counts set to 0 before the
    card's prefill, read after its last step); the scorer launches no
    kernel."""
    cfg = dataclasses.replace(CFG.get_smoke(ENCDEC_ARCH), dtype=torch.float32)
    cpu_params = perturbed(cfg, torch.Generator().manual_seed(3))
    params = MB.tree_map(lambda a: a.to("cuda"), cpu_params)
    b, s, steps = ENCDEC_PARITY_BATCH, ENCDEC_PARITY_PROMPT, ENCDEC_PARITY_STEPS
    tokens, frontend = encdec_batch(cfg, b, s, ENCDEC_PARITY_FRAMES,
                                    torch.Generator().manual_seed(3))
    tol = ENCDEC_PARITY_TOL
    lg, aux = Z.forward(params, cfg, {"tokens": tokens.to("cuda"),
                                      "frontend": frontend.to("cuda")})
    lg_c, _ = Z.forward(cpu_params, cfg, {"tokens": tokens,
                                          "frontend": frontend})
    torch.testing.assert_close(lg.cpu(), lg_c, rtol=tol, atol=tol)
    assert float(aux) == 0.0, aux
    fwd_err = float((lg.cpu() - lg_c).abs().max())
    cpu = lm_serve(cpu_params, cfg, tokens, steps, "cpu", frontend=frontend)
    ops.reset_launch_counts()        # the card's engine path starts here
    card = lm_serve(params, cfg, tokens, steps, "cuda", feed=cpu["fed"],
                    frontend=frontend)
    sync()
    launches = ops.launch_counts()   # ... and ends here
    want = {k: 0 for k in launches}
    want["swa_decode"] = 2 * cfg.n_layers * steps
    assert launches == want, (launches, want)
    greedy = sum(check_greedy(g, w, f"{cfg.name} step {i}", tol) for i, (g, w)
                 in enumerate(zip(card["logits"], cpu["logits"])))
    assert greedy > 0
    err = max(float((g - w).abs().max())
              for g, w in zip(card["logits"], cpu["logits"]))
    scorer = S.build_neural(ENCDEC_ARCH, device="cuda")
    cpu_scorer = NeuralScorer(
        cfg=scorer.cfg, params=MB.tree_map(lambda a: a.cpu(), scorer.params),
        head=scorer.head.cpu())
    feats = torch.from_numpy(np.random.default_rng(4).normal(
        size=(ENCDEC_NEURAL_ITEMS, cloes.CASCADE.d_x)).astype(np.float32))
    ops.reset_launch_counts()
    scores = scorer.score(feats.to("cuda")).cpu()
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    want_scores = cpu_scorer.score(feats)
    scale = float(want_scores.abs().max())
    torch.testing.assert_close(scores, want_scores, rtol=tol,
                               atol=tol * scale)
    score_err = float((scores - want_scores).abs().max())
    print(f"[encdec parity] {cfg.name} ({cfg.n_enc_layers} + {cfg.n_layers} "
          f"layers, float32, perturbed) on the card against the CPU: forward "
          f"of {b} x {s} tokens over {ENCDEC_PARITY_FRAMES} frames max |err| "
          f"{fwd_err:.3g}; prefill + {steps} greedy decode steps max |err| "
          f"{err:.3g} (bar {tol}), {greedy} greedy tokens equal; K8 x "
          f"{launches['swa_decode']} = 2 x {cfg.n_layers} x {steps}, no other "
          f"kernel; neural scorer ({scorer.cfg.name}) on "
          f"{ENCDEC_NEURAL_ITEMS} items max |err| {score_err:.3g} (scores up "
          f"to {scale:.3g}), no kernel")
    del params
    free_cuda()
    return dict(fwd_err=fwd_err, decode_err=err, score_err=score_err,
                k8_launches=launches["swa_decode"])


def phase_encdec_lm(card: str) -> dict:
    """seamless-m4t-large-v2 at its published widths and full depth in
    bfloat16 (the weights drawn on the card): prefill of ENCDEC_LM_BATCH
    prompts of ENCDEC_LM_PROMPT tokens over DECODE_ENC_LEN frontend frames
    (timed on the host clock around a sync), then ENCDEC_LM_STEPS greedy
    decode steps, finite logits; K8 twice per decoder layer per step (self
    and cross attention) and nothing else counted (counts set to 0 before
    the prefill, read after the last step); the prefill's and every step's
    logits against the model's forward over the same tokens (within
    ENCDEC_BF16_GAP of the logits' scale); ms per step (CUDA events: median
    and p90), the median asserted no faster than the cost report's bound
    for the step and printed beside it, the CUDA kernel
    launches of one more step, a profile of LM_PROFILE_STEPS more (device
    idle share) and peak memory; each beside the card's name and power
    limit."""
    cfg = CFG.get(ENCDEC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = MB.materialize(Z.templates(cfg), gen, dtype=cfg.dtype)
    sync()
    make_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size()
                 for t in MB.tree_leaves(params))
    b, s, steps = ENCDEC_LM_BATCH, ENCDEC_LM_PROMPT, ENCDEC_LM_STEPS
    tokens, frontend = encdec_batch(cfg, b, s, DECODE_ENC_LEN, gen)
    cache = E.init_cache(cfg, b, s + steps + LM_PROFILE_STEPS, DECODE_ENC_LEN,
                         device="cuda")
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()        # the path starts here
    t0 = time.perf_counter()
    logits, cache = E.prefill(params, cfg, {"tokens": tokens,
                                            "frontend": frontend}, cache)
    sync()
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    run = {"logits": [logits[:, -1]], "fed": []}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    events[0].record()
    for i in range(steps):
        run["fed"].append(tok)
        logits, cache = E.decode_step(params, cfg, tok, cache, s + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        finite &= torch.isfinite(logits).all()
        run["logits"].append(logits[:, -1])
        events[i + 1].record()
    sync()
    launches = ops.launch_counts()   # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    assert bool(finite), f"{cfg.name}: non-finite logits"
    want = {k: 0 for k in launches}
    want["swa_decode"] = 2 * cfg.n_layers * steps
    assert launches == want, (launches, want)
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    med = statistics.median(step_ms)
    p90 = statistics.quantiles(step_ms, n=10)[-1]
    run["logits"] = [lg.cpu() for lg in run["logits"]]
    gap, scale = decode_gap(params, cfg, tokens, frontend, run)
    assert gap <= ENCDEC_BF16_GAP * scale, (gap, scale)
    per_step, kernels, _ = cuda_launches_per_call(
        lambda: E.decode_step(params, cfg, tok, cache, s + steps), calls=2)
    bnd = decode_bound(cfg, b, s + steps + LM_PROFILE_STEPS, s + steps - 1,
                       DECODE_ENC_LEN)
    floor_ms = bnd["bound_ms"]
    print(f"[encdec lm] {cfg.name}: {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers at the published widths, "
          f"{cfg.param_count()} parameters, {nbytes} bytes in {cfg.dtype} "
          f"made on the card in {make_s:.1f} s")
    print(f"[encdec lm] {cfg.name} on {card}: prefill B={b} x {s} tokens over "
          f"{DECODE_ENC_LEN} frames {prefill_s:.3f} s; {steps} greedy decode "
          f"steps at B={b}: median {med:.3f} ms per step, p90 {p90:.3f} "
          f"(first {step_ms[0]:.3f}, min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}), {b / med * 1e3:.1f} tokens/s; "
          f"{per_step:.0f} CUDA kernel "
          f"launches per step ({kernels / 2:.0f} kernels on the device); "
          f"peak memory {peak} bytes; K8 launches {launches['swa_decode']} = "
          f"2 x {cfg.n_layers} x {steps}; decode against the forward max "
          f"|gap| {gap:.3g} (logits up to {scale:.3g}, bar "
          f"{ENCDEC_BF16_GAP} of it)")
    print(f"[encdec lm] {cfg.name} decode step: "
          f"{bound_note('encdec lm', med, bnd)}")
    print(f"[encdec lm] {cfg.name} greedy tokens of sequence 0: "
          f"{torch.cat(run['fed'][1:] + [tok], 1)[0].tolist()}")
    profile = profile_decode(params, cfg, cache, tok, s + steps,
                             tag="encdec lm")
    del cache
    out = dict(params=cfg.param_count(), param_bytes=nbytes,
               prefill_s=prefill_s, step_ms_median=med, step_ms_p90=p90,
               floor_ms=floor_ms, tokens_per_s=b / med * 1e3,
               launches_per_step=per_step,
               device_idle_share=profile["device_idle_share"],
               peak_bytes=peak, k8_launches=launches["swa_decode"],
               decode_gap=gap)
    del params, logits, run
    free_cuda()
    return out


def phase_encdec_lm_check() -> dict:
    """seamless-m4t-large-v2 at full width cut to ENCDEC_CHECK_LAYERS
    encoder and decoder layers in float32 (perturbed weights drawn on the
    card): a prompt's prefill over ENCDEC_CHECK_FRAMES frames and
    ENCDEC_CHECK_STEPS greedy decode steps on the card (K8 twice per layer
    per step), held to the model's own forward on the card (LM_DECODE_TOL,
    the reference's bar), then the same on the CPU fed the card's tokens:
    logits within MOE_LOGIT_TOL (2e-4) at every step, greedy tokens exact
    where the margin allows. Runs after every phase timed on the host's
    clock."""
    cfg = dataclasses.replace(CFG.get(ENCDEC_ARCH),
                              n_layers=ENCDEC_CHECK_LAYERS,
                              n_enc_layers=ENCDEC_CHECK_LAYERS,
                              dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = perturbed(cfg, gen)
    b, s, steps = ENCDEC_CHECK_BATCH, ENCDEC_CHECK_PROMPT, ENCDEC_CHECK_STEPS
    tokens, frontend = encdec_batch(cfg, b, s, ENCDEC_CHECK_FRAMES, gen)
    tokens = tokens.cpu()
    ops.reset_launch_counts()        # the card's path starts here
    card = lm_serve(params, cfg, tokens, steps, "cuda", frontend=frontend)
    sync()
    k8 = ops.launch_counts()["swa_decode"]      # ... and ends here
    assert k8 == 2 * cfg.n_layers * steps, k8
    fwd_gap, _ = decode_gap(params, cfg, tokens, frontend, card)
    assert fwd_gap <= LM_DECODE_TOL, fwd_gap
    params = MB.tree_map(lambda a: a.cpu(), params)
    frontend = frontend.cpu()
    free_cuda()
    t0 = time.perf_counter()
    cpu = lm_serve(params, cfg, tokens, steps, "cpu", feed=card["fed"],
                   frontend=frontend)
    cpu_s = time.perf_counter() - t0
    greedy = sum(check_greedy(g, w, f"{cfg.name} step {i}") for i, (g, w)
                 in enumerate(zip(card["logits"], cpu["logits"])))
    err = max(float((g - w).abs().max())
              for g, w in zip(card["logits"], cpu["logits"]))
    scale = max(float(w.abs().max()) for w in cpu["logits"])
    print(f"[encdec lm check] {cfg.name} at full width, {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, float32, perturbed ({cfg.param_count()} "
          f"parameters): prefill of {b} x {s} tokens over "
          f"{ENCDEC_CHECK_FRAMES} frames + {steps} greedy decode steps (K8 x "
          f"{k8}): against the card's forward max |gap| {fwd_gap:.3g} (bar "
          f"{LM_DECODE_TOL}); against the CPU ({cpu_s:.1f} s) max |err| "
          f"{err:.3g} (bar {MOE_LOGIT_TOL}; logits up to {scale:.3g}), "
          f"{greedy} greedy tokens equal")
    del params
    return dict(err=err, fwd_gap=fwd_gap, k8_launches=k8)


def phase_encdec_train() -> dict:
    """The launcher's --target lm for seamless: ENCDEC_TRAIN_STEPS Adam
    steps of the smoke config at SSM_TRAIN_LR on the card and on the CPU
    (the weights drawn on the CPU from the seed), finite losses within
    LM_TRAIN_RTOL; then the config at its published widths and full depth
    (24 + 24 layers, float32 as the launcher draws them) on the card
    alone, at the launcher's lr: finite losses, s per step and peak
    memory."""
    args = ["--target", "lm", "--arch", ENCDEC_ARCH, "--smoke", "--steps",
            str(ENCDEC_TRAIN_STEPS), "--lr", str(SSM_TRAIN_LR)]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        card = TLT.main(args + ["--device", "cuda"])
        cpu = TLT.main(args + ["--device", "cpu"])
    head = log.getvalue().splitlines()[0]
    assert len(card) == ENCDEC_TRAIN_STEPS and np.isfinite(card).all(), card
    np.testing.assert_allclose(card, cpu, rtol=LM_TRAIN_RTOL)
    err = max(abs(a - c) / abs(c) for a, c in zip(card, cpu))
    print(f"[encdec train] {head.removeprefix('[train] ')}: lr "
          f"{SSM_TRAIN_LR}, losses {[round(v, 4) for v in card]}, max "
          f"relative err against the CPU {err:.3g} (bar {LM_TRAIN_RTOL})")
    free_cuda()
    full = ["--target", "lm", "--arch", ENCDEC_ARCH, "--steps",
            str(ENCDEC_TRAIN_STEPS), "--batch", str(ENCDEC_FULL_TRAIN_BATCH),
            "--seq", str(ENCDEC_FULL_TRAIN_SEQ), "--device", "cuda"]
    log = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        losses = TLT.main(full)
        sync()
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lines = log.getvalue().splitlines()
    per_step = float(re.findall(r"\(([0-9.]+)s/step\)", lines[-2])[0])
    depth = CFG.get(ENCDEC_ARCH)
    need = train_need(dataclasses.replace(depth, dtype=torch.float32),
                      ENCDEC_FULL_TRAIN_BATCH, ENCDEC_FULL_TRAIN_SEQ,
                      TLT.ENC_FRAMES)
    assert (f"{depth.n_layers} layers + {depth.n_enc_layers} encoder layers"
            in lines[0]), lines[0]
    assert len(losses) == ENCDEC_TRAIN_STEPS and np.isfinite(losses).all(), \
        losses
    print(f"[encdec train] {lines[0].removeprefix('[train] ')} at full depth: "
          f"B={ENCDEC_FULL_TRAIN_BATCH} x {ENCDEC_FULL_TRAIN_SEQ} tokens + "
          f"{TLT.ENC_FRAMES} frames, losses {[round(v, 4) for v in losses]}, "
          f"{per_step:.3f} s per step (the launcher's mean over "
          f"{ENCDEC_TRAIN_STEPS} steps, first-call work included), "
          f"{seconds:.1f} s in all (weights drawn on the CPU), peak memory "
          f"{peak} bytes; the cost report's argument + temp for one step "
          f"{need} bytes ({peak / need:.3f} of it)")
    free_cuda()
    return dict(losses=card, cpu_losses=cpu, max_rel_err=err,
                full_losses=losses, full_s_per_step=per_step,
                full_peak_bytes=peak, full_report_bytes=need)


class Laps:
    """The seconds of each group of phases: `lap(name)` prints and keeps
    the time since the previous lap (or the start)."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
        print(f"[time] {name}: {self.seconds[name]:.1f} s")


def main() -> None:
    t0 = time.perf_counter()
    lap = Laps()
    card = phase_device()
    phase_lint()
    with tempfile.TemporaryDirectory() as tmp:
        phase_costs(tmp)
    lap("device, lint, costs")
    phase_build()
    lap("build")
    errs = phase_parity()
    errs.update(cascade_score_batched_bwd=0.0, cascade_loss=0.0,
                cascade_loss_bwd=0.0, cascade_score=0.0,
                cascade_score_bwd=0.0, cascade_score_fm=0.0)
    phase_train_parity(errs)
    phase_single_parity(errs)
    phase_vmap_parity(errs)
    phase_determinism()
    lap("kernel parity")
    errs["query_bias"] = 0.0
    timing_qb = phase_query_bias(errs)
    timing, timing_train, timing_serve = phase_timing()
    timing_single = phase_single_timing()
    timing_vmap = time_vmap_call(TRAIN_SHAPE, seed=8)
    free_cuda()
    lap("kernel timing")
    log = generate_log(LogConfig(n_queries=FIT_QUERIES, seed=0))
    tr, te = log.split(0.8)
    params, launches, l3_losses = phase_train(tr, te)
    counts = phase_train_k6(tr, params, l3_losses)
    launches.update(cascade_score=counts["cascade_score"],
                    cascade_score_bwd=counts["cascade_score_bwd"])
    with tempfile.TemporaryDirectory() as tmp:
        restart = phase_train_restart(tr, params, l3_losses, tmp)
        dp = phase_train_dp(tr, params, l3_losses, tmp)
    lap("cascade training")
    for plan in ("filter", "score"):
        counts, _ = phase_slice(plan, params, te)
        kernel = ("cascade_filter" if plan == "filter"
                  else "cascade_score_batched")
        launches[kernel] = counts[kernel]
        if plan == "filter":             # the serving main path's zq
            launches["query_bias"] = counts["query_bias"]
        else:
            qb_score_launches = counts["query_bias"]
    pump = phase_pump(params, te)
    router = phase_router(params, te)
    streams_launches = phase_replica_streams(params, te)
    chaos = phase_pump(params, te, fault_rate=CHAOS_RATE)
    shim = phase_shim(params, te)
    with tempfile.TemporaryDirectory() as tmp:
        warm = phase_warm_restart(tmp)
    witnessed = phase_witness(params, te, router["plain"])
    lap("cascade serving")
    extra = {"cascade_filter": dict(
                 pump_launches=pump["launches"],
                 pump_faults_launches=chaos["launches"],
                 router_launches=router["launches"],
                 replica_streams_launches=streams_launches,
                 shim_launches=shim["cascade_filter"],
                 warm_restart_launches=warm["launches"],
                 witness_launches=witnessed["k2"]),
             "cascade_score_batched": dict(
                 shim_launches=shim["cascade_score_batched"])}
    for name in ("cascade_loss", "cascade_loss_bwd"):
        extra[name] = dict(restart_launches=restart["launches"][name],
                           dp_launches=dp[name])
    phase_serve_k6(params, te)
    launches["cascade_score_fm"] = phase_fm_scoring(
        params, te)["cascade_score_fm"]
    free_cuda()
    paper = phase_paper(card)
    free_cuda()
    lap("fm scoring, paper")
    errs["swa_decode"] = errs["swa_decode_partial"] = 0.0
    phase_k8_parity(errs)
    k8 = phase_k8_timing()
    k8_partial = phase_k8_partial(errs, k8)
    phase_k8_streams()
    free_cuda()
    lap("k8")
    lm = phase_lm()
    launches["swa_decode"] = lm["k8_launches"]
    phase_lm_check()
    moe_lm = phase_moe_lm(card)
    lap("lm, moe lm")
    tp_parity = phase_tp_parity(card)
    tp_families_parity = phase_tp_families_parity(card)
    lap("tp parity, tp families parity")
    tp_lm = phase_tp_lm(card, moe_lm[TP_MOE_ARCH]["tp_ref"])
    lap("tp lm")
    free_cuda()
    tp_qsplit = phase_tp_qsplit_lm(card)
    lap(f"tp qsplit lm (its spawn of {QSPLIT_WORLD} ranks "
        f"{tp_qsplit['spawn_s']:.1f} s)")
    for r in moe_lm.values():
        del r["tp_ref"]
    free_cuda()
    fsdp = phase_fsdp(card)
    lap("fsdp")
    ssm_lm = phase_ssm_lm(card)
    encdec_lm = phase_encdec_lm(card)
    lap("ssm lm, encdec lm")
    tp_families_lm = phase_tp_families_lm(card)
    lap("tp families lm")
    phase_pod_costs(card, tp_lm, tp_qsplit, fsdp, tp_families_lm)
    host_pool().shutdown()
    lap("pod costs")
    free_cuda()
    phase_tp_families_train(card)
    lap("tp families train")
    phase_slice("filter", params, te,
                neural=S.build_neural(NEURAL_ARCH, device="cuda"))
    free_cuda()
    phase_train_lm()
    lap("neural slice, train lm")
    moe_parity = phase_moe_parity()
    moe_check = phase_moe_lm_check()     # its CPU part is the largest
    lap("moe parity, moe lm check")
    ssm_parity = phase_ssm_parity()
    ssm_check = phase_ssm_lm_check()
    phase_ssm_train()
    lap("ssm parity, ssm lm check, ssm train")
    encdec_parity = phase_encdec_parity()
    encdec_check = phase_encdec_lm_check()
    phase_encdec_train()
    lap("encdec parity, encdec lm check, encdec train")
    extra["swa_decode"] = {
        **{f"moe_lm_{a}_launches": r["k8_launches"]
           for a, r in moe_lm.items()},
        **{f"moe_parity_{a}_launches": r["k8_launches"]
           for a, r in moe_parity.items()},
        "moe_lm_check_launches": moe_check["k8_launches"],
        **{f"ssm_lm_{a}_launches": r["k8_launches"]
           for a, r in ssm_lm.items()},
        **{f"ssm_parity_{a}_launches": r["k8_launches"]
           for a, r in ssm_parity.items()},
        **{f"ssm_lm_check_{a}_launches": r["k8_launches"]
           for a, r in ssm_check.items()},
        "encdec_lm_launches": encdec_lm["k8_launches"],
        "encdec_parity_launches": encdec_parity["k8_launches"],
        "encdec_lm_check_launches": encdec_check["k8_launches"],
        **{f"tp_parity_{a}_launches_per_rank": r["k8_per_rank"]
           for a, r in tp_parity.items() if "/" not in a},
        "tp_lm_launches_per_rank": tp_lm[LM_ARCH]["k8_per_rank"],
        "tp_moe_launches_per_rank": tp_lm[TP_MOE_ARCH]["k8_per_rank"],
        "tp_kvrep_lm_launches_per_rank": tp_lm[KVREP_LM_ARCH]["k8_per_rank"],
        **{f"tp_kvrep_parity_{a.split('-')[0]}_launches_per_rank":
           r["k8_per_rank"] for a, r in tp_lm["kvrep parity"].items()},
        **{f"tp_qsplit_parity_{a.replace('-', '_')}_launches_per_rank":
           r["k8_per_rank"] for a, r in {**tp_lm["qsplit parity"],
                                         **tp_parity}.items()
           if "/" not in a and (a in QSPLIT_PARITY or a in QSPLIT_MQA)},
        **{f"tp_qsplit_lm_{a.split('-')[0]}_launches_per_rank":
           r["launches_per_rank"] for a, r in tp_qsplit.items()
           if a in QSPLIT_LM_ARCHS},
        **{f"tp_families_parity_{re.sub(r'[^0-9a-z]+', '_', a)}"
           f"_launches_per_rank": r["k8_per_rank"]
           for a, r in tp_families_parity.items() if "k8_per_rank" in r},
        **{f"tp_families_lm_{a}_launches_per_rank": r["k8_per_rank"]
           for a, r in tp_families_lm.items() if "k8_per_rank" in r},
        **{f"zero3_serve_parity_{a.split('-')[0]}_launches_per_rank":
           fsdp[f"zero3 serve/{a}"]["k8_per_rank"]
           for a in ZERO3_SERVE_ARCHS},
        f"zero3_qsplit_lm_{ZERO3_QSPLIT_ARCH.split('-')[0]}"
        f"_launches_per_rank":
            tp_qsplit[f"{ZERO3_QSPLIT_ARCH}/zero3"]["launches_per_rank"]}
    seq_lm = tp_lm[f"{LM_ARCH}/seq"]
    launches["swa_decode_partial"] = seq_lm["k8_partial_per_rank"][0]
    extra["swa_decode_partial"] = {
        "seq_lm_launches_per_rank": seq_lm["k8_partial_per_rank"],
        **{f"seq_parity_{a.replace('/', '_')}_launches_per_rank":
           r["k8_partial_per_rank"]
           for a, r in {**tp_parity, **tp_lm["qsplit parity"]}.items()
           if "/" in a},
        **{f"seq_qsplit_lm_{a.split('-')[0]}_launches_per_rank":
           r["launches_per_rank"] for a, r in tp_qsplit.items()
           if a.endswith("/seq")},
        **{f"seq_families_parity_{re.sub(r'[^0-9a-z]+', '_', a)}"
           f"_launches_per_rank": r["k8_partial_per_rank"]
           for a, r in tp_families_parity.items()
           if "k8_partial_per_rank" in r},
        **{f"seq_families_lm_{a.split('/')[0]}_launches_per_rank":
           r["k8_partial_per_rank"]
           for a, r in tp_families_lm.items() if a.endswith("/seq")}}
    extra["query_bias"] = dict(
        score_launches=qb_score_launches,
        pump_launches=pump["qb_launches"],
        warm_restart_launches=warm["qb_launches"],
        witness_launches=witnessed["qb"])
    for name, n in paper["launches"].items():
        extra.setdefault(name, {})["paper_launches"] = n
    rows = []
    for name, info in KERNEL_INFO.items():
        row = {"name": name, **info, "launches": launches[name],
               "max_abs_err": errs[name], **extra.get(name, {})}
        if name == "swa_decode":
            tm = k8["global"]
            row.update(ms=tm["ms"], plain_ms=tm["plain_ms"],
                       bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
                       library_ms=tm["library_ms"], lone_ms=tm["lone_ms"],
                       launches_per_decode_step=CFG.get(LM_ARCH).n_layers,
                       cuda_launches_per_call=tm["cuda_launches_per_call"],
                       n_split=tm["plan"]["n_split"],
                       blocks=tm["plan"]["blocks"],
                       blocks_per_sm=tm["plan"]["blocks_per_sm"])
            for shape in ("ring", "long", "zamba2", "encdec_cross",
                          "zamba2_tp4", "encdec_cross_tp4", "starcoder2",
                          "starcoder2_tp4"):
                for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                            "cuda_launches_per_call"):
                    row[f"{shape}_{key}"] = k8[shape][key]
                row[f"{shape}_n_split"] = k8[shape]["plan"]["n_split"]
        elif name == "swa_decode_partial":
            tm = k8_partial
            row.update(ms=tm["ms"], plain_ms=tm["plain_ms"],
                       bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
                       library_ms=tm["library_ms"], lone_ms=tm["lone_ms"],
                       whole_k8_long_ms=tm["whole_k8_ms"],
                       cuda_launches_per_call=tm["cuda_launches_per_call"],
                       n_split=tm["plan"]["n_split"],
                       blocks=tm["plan"]["blocks"],
                       launches_per_decode_step=TP_LM_LAYERS,
                       timed_shape="one 32k quarter of the 128k shape")
        elif name == "query_bias":
            tm = timing_qb[QB_TIMING_ROWS[0]]
            row.update(ms=tm["ms"], plain_ms=tm["plain_ms"],
                       bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
                       library_ms=tm["library_ms"], lone_ms=tm["lone_ms"],
                       port_only=True)
            for rows_, tm in timing_qb.items():
                for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    row[f"rows{rows_}_{key}"] = tm[key]
        elif name in ("cascade_score", "cascade_score_bwd",
                      "cascade_score_fm"):
            tm = timing_single[max(SINGLE_TIMING_N)][name]
            row.update(ms=tm["ms"], plain_ms=tm["plain_ms"],
                       bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
                       library_ms=None, lone_ms=tm["lone_ms"])
            for n, by_name in timing_single.items():
                for key in ("ms", "plain_ms", "bound_ms"):
                    row[f"n{n}_{key}"] = by_name[name][key]
                row[f"n{n}_k1_b1_ms"] = by_name["cascade_score_batched"]["ms"]
            if name != "cascade_score_fm":     # B groups in one launch
                for shape, tms in (("timing_shape", timing),
                                   ("train_shape", timing_train)):
                    for key in ("ms", "plain_ms", "bound_ms"):
                        row[f"vmap_{shape}_{key}"] = tms[name][key]
                row["vmap_train_shape_call_ms"] = timing_vmap[
                    "fwd_ms" if name == "cascade_score" else "fwd_bwd_ms"]
        else:
            tm = timing[name]
            row.update(ms=tm["ms"], plain_ms=tm["plain_ms"],
                       bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
                       library_ms=None, lone_ms=tm["lone_ms"],
                       train_shape_ms=timing_train[name]["ms"],
                       train_shape_plain_ms=timing_train[name]["plain_ms"],
                       train_shape_bound_ms=timing_train[name]["bound_ms"])
            if name in timing_serve:
                row.update(serve_shape_ms=timing_serve[name]["ms"],
                           serve_shape_bound_ms=timing_serve[name]["bound_ms"])
            if name == "cascade_filter":
                row.update(pairs=tm["pairs"],
                           serve_shape_pairs=timing_serve[name]["pairs"])
            if name == "cascade_score_batched":
                row["b1_ms"] = timing_single[max(SINGLE_TIMING_N)][name]["ms"]
        rows.append(row)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
