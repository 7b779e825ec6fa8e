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
   relative of it. Then Table 3 at the paper's scale (61,500 x 64:
   1,998,780 instances) on the card: data generation s, each row beside
   the paper's numbers, each fit's steps/s, the launches per fit (held to
   the same counts), the claims printed held or not (findings, not
   failures); finite values and the launch counts asserted;
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
   one-stream results bit for bit;
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
   and QB also on `[paper]`'s suites and its paper-scale Table 3; K8 also
   on the moe, ssm and encdec paths; query_bias on the serving main path
   and the others; K2 and query_bias also under the witness), error and
   times; the last line is {"ok": true,
   "device": {...}}.
"""

from __future__ import annotations

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
from repro_torch.launch.mesh import (  # noqa: E402
    data_parallel_mesh, replica_devices)
from repro_torch.models import base as MB  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import zoo as Z  # noqa: E402
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
# no GQA) over its 4096 cached encoder frames.
K8_SHAPES = {"global": (4, 32, 16, 128, 4096), "ring": (4, 32, 16, 128, 1024),
             "long": (1, 32, 16, 128, 131072), "zamba2": (4, 32, 32, 64, 547),
             "encdec_cross": (4, 16, 16, 64, DECODE_ENC_LEN)}
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
# the bar, so it is one that bf16 rounding fails.
LM_TRAIN_ARCH, LM_TRAIN_LAYERS, LM_TRAIN_STEPS = "starcoder2-3b", 2, 3
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
# The ssm (rwkv6) and hybrid (zamba2) families. [ssm parity]: each smoke
# config (and zamba2-smoke at 3 layers: a tail layer after its last shared
# block) in float32 on the card against the CPU, every leaf the templates
# initialise to zeros or ones perturbed by SSM_NOISE * N(0, 1) (else the
# LoRA paths, the bonus term and the data-dependent shift are zero):
# forward in both ssm_impl forms, then prefill and SSM_PARITY_STEPS greedy
# decode steps. [ssm lm]: both configs at published widths and full depth
# in bfloat16, a prompt's prefill through the scan and the chunked form,
# then SSM_LM_STEPS greedy decode steps. [ssm lm check] / [ssm train]: full
# width at SSM_CHECK_LAYERS (rwkv6 2, zamba2 7: one group of 6 and a tail
# layer; ~1.5 GB each in float32) on the card against the CPU.
SSM_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
SSM_PARITY_CASES = (("rwkv6-1.6b", 0), ("zamba2-1.2b", 0), ("zamba2-1.2b", 3))
SSM_PARITY_BATCH, SSM_PARITY_PROMPT, SSM_PARITY_STEPS = 2, 40, 16
SSM_NOISE = 0.1
SSM_LM_BATCH, SSM_LM_PROMPT, SSM_LM_STEPS = 4, 512, 32
SSM_CHECK_LAYERS = {"rwkv6-1.6b": 2, "zamba2-1.2b": 7}
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


def phase_costs(tmp: str) -> dict:
    """The dry-run cost report on the host at --variant auto over
    `costs_combos()`, written under tmp: one line per combo (skipped ones
    with the reason) and the phase's wall time. The combos are traced in
    a pool of spawned processes, one per core up to 8, the longest (the
    32k-token prefills' KV-chunk loops) first. A combo that fails to trace
    fails the run."""
    DR, RL = cost_report()
    t0 = time.perf_counter()
    combos = sorted(costs_combos(),
                    key=lambda c: ("prefill", "train", "decode").index(
                        SHAPES[c[1]].step))
    ctx = multiprocessing.get_context("spawn")
    workers = min(8, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
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
          f"{seconds:.1f} s on the host ({workers} processes; one H100's "
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
        plain, _ = time_ms(plain_fn)
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
            for h, hkv in ((4, 4), (8, 4), (16, 4), (14, 2), (24, 2)):
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
    within PAPER_AUC_TOL / PAPER_COST_RTOL of it. At the paper's scale
    (61,500 x 64: 1,998,780 instances): Table 3 on the card, each row
    beside the paper's numbers, its claims printed as held or not (a
    finding there: the reference never checked them at that size), the
    data generation time, each fit's steps/s and the launches per fit.
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
    common.clear_fits()
    common.bench_split.cache_clear()

    t1 = time.perf_counter()
    psplit = common.bench_split("paper")
    gen_s = time.perf_counter() - t1
    n_inst = psplit[0].n_instances + psplit[1].n_instances
    psteps = 6 * T.epoch_steps(psplit[0].x.shape[0], 64)[0]
    print(f"[paper 2M] {n_inst} instances ({psplit[0].x.shape[0]} train + "
          f"{psplit[1].x.shape[0]} test groups of {psplit[0].x.shape[1]}) "
          f"generated and split in {gen_s:.1f} s on the host; {psteps} "
          f"steps a fit")
    ops.reset_launch_counts()              # the paper-scale path starts here
    rows = T3.rows(psplit, "cuda")
    sync()
    counts = ops.launch_counts()           # ... and ends here
    check_table3_launches(counts, psteps, "paper 2M")
    for r in rows:
        vals = (r["train_auc"], r["test_auc"], r["cost"])
        assert all(math.isfinite(v) for v in vals), r
        assert 0.0 < r["test_auc"] <= 1.0 and r["cost"] > 0.0, r
        paper = r["paper"]
        ptxt = (f"paper {paper[0]} / {paper[1]} / {paper[2]}" if paper
                else "paper: not in the table")
        print(f"[paper 2M] {r['algo']}: train AUC {r['train_auc']:.4f}, test "
              f"AUC {r['test_auc']:.4f}, cost ratio {r['cost']:.4f} ({ptxt}); "
              f"fit {r['fit_s']:.2f} s = {psteps / r['fit_s']:.1f} steps/s, "
              f"evaluation {r['eval_s']:.2f} s")
    print(f"[paper 2M] launches per L1 fit: K1 = K3 = {psteps}; per L3 fit: "
          f"K4 = K5 = {psteps}; evaluate: K1 x 10; in all {dict(counts)}")
    for name, held, detail in T3.claims(rows):
        print(f"[paper 2M] claim {name}: {'held' if held else 'NOT held'} "
              f"({detail})")
    paper_s = time.perf_counter() - t0
    print(f"[paper] done in {paper_s:.1f} s ({card})")
    common.clear_fits()
    common.bench_split.cache_clear()
    common.bench_log.cache_clear()
    return {"launches": dict(launches), "paper_scale_launches": counts,
            "seconds": paper_s}


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
    del params, cache, logits
    free_cuda()
    return dict(params=cfg.param_count(), param_bytes=nbytes,
                prefill_s=prefill_s, step_ms=step_ms, step_ms_median=med,
                floor_ms=bnd["bound_ms"],
                tokens_per_s=LM_BATCH / med * 1e3, peak_bytes=peak,
                k8_launches=launches["swa_decode"], profile=profile)


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

def routed(fn, *args):
    """fn(*args) with every moe layer's routing recorded: (fn's result,
    [(probs (T, E) on the CPU, gate_i (T, k) on the CPU), ...] in call
    order). The zoo reaches `layers.moe_route` through the module."""
    routes = []
    orig = Lyr.moe_route

    def rec(p, cfg, xt):
        out = orig(p, cfg, xt)
        routes.append((out[0].detach().cpu(), out[2].cpu()))
        return out
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
             frontend=None) -> dict:
    """Prefill `tokens` (B, S) (over an encdec model's `frontend` frames
    (B, S_enc, d)), then `steps` greedy decode steps on `device`, each fed
    feed[i] (B, 1) if given, else this run's own greedy token: every
    step's last-position logits (on the CPU), the tokens fed and the
    routing of every moe layer's call (none in other families)."""
    b, s = tokens.shape
    batch, enc_len = {"tokens": tokens.to(device)}, 0
    if frontend is not None:
        batch["frontend"], enc_len = frontend.to(device), frontend.shape[1]
    cache = E.init_cache(cfg, b, s + steps, enc_len, device=device)
    (lg, cache), routes = routed(E.prefill, params, cfg, batch, cache)
    logits, fed = [lg[:, -1].cpu()], []
    for i in range(steps):
        tok = (logits[-1].argmax(-1, keepdim=True) if feed is None
               else feed[i])
        fed.append(tok)
        (lg, cache), r = routed(E.decode_step, params, cfg, tok.to(device),
                                cache, s + i)
        logits.append(lg[:, -1].cpu())
        routes += r
    return dict(logits=logits, fed=fed, routes=routes)


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
        out[arch] = dict(layers=cfg.n_layers, params=cfg.param_count(),
                         param_bytes=nbytes, prefill_s=prefill_s,
                         step_ms_median=med, floor_ms=floor_ms,
                         ref_floor_ms=ref_ms, launches_per_step=per_step,
                         device_idle_share=profile["device_idle_share"],
                         peak_bytes=peak, k8_launches=launches["swa_decode"])
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
        out[arch] = dict(params=cfg.param_count(), param_bytes=nbytes,
                         prefill_s=prefill_s, scan_chunked_gap=gap,
                         step_ms_median=med, floor_ms=floor_ms,
                         launches_per_step=per_step,
                         device_idle_share=profile["device_idle_share"],
                         peak_bytes=peak, k8_launches=launches["swa_decode"])
        del params, cache, logits, last
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
    out = dict(params=cfg.param_count(), param_bytes=nbytes,
               prefill_s=prefill_s, step_ms_median=med, step_ms_p90=p90,
               floor_ms=floor_ms, tokens_per_s=b / med * 1e3,
               launches_per_step=per_step,
               device_idle_share=profile["device_idle_share"],
               peak_bytes=peak, k8_launches=launches["swa_decode"],
               decode_gap=gap)
    del params, cache, logits, run
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


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
    phase_lint()
    with tempfile.TemporaryDirectory() as tmp:
        phase_costs(tmp)
    phase_build()
    errs = phase_parity()
    errs.update(cascade_score_batched_bwd=0.0, cascade_loss=0.0,
                cascade_loss_bwd=0.0, cascade_score=0.0,
                cascade_score_bwd=0.0, cascade_score_fm=0.0)
    phase_train_parity(errs)
    phase_single_parity(errs)
    phase_vmap_parity(errs)
    phase_determinism()
    errs["query_bias"] = 0.0
    timing_qb = phase_query_bias(errs)
    timing, timing_train, timing_serve = phase_timing()
    timing_single = phase_single_timing()
    timing_vmap = time_vmap_call(TRAIN_SHAPE, seed=8)
    free_cuda()
    log = generate_log(LogConfig(n_queries=FIT_QUERIES, seed=0))
    tr, te = log.split(0.8)
    params, launches, l3_losses = phase_train(tr, te)
    counts = phase_train_k6(tr, params, l3_losses)
    launches.update(cascade_score=counts["cascade_score"],
                    cascade_score_bwd=counts["cascade_score_bwd"])
    with tempfile.TemporaryDirectory() as tmp:
        restart = phase_train_restart(tr, params, l3_losses, tmp)
        dp = phase_train_dp(tr, params, l3_losses, tmp)
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
    errs["swa_decode"] = 0.0
    phase_k8_parity(errs)
    k8 = phase_k8_timing()
    phase_k8_streams()
    free_cuda()
    lm = phase_lm()
    launches["swa_decode"] = lm["k8_launches"]
    phase_lm_check()
    moe_lm = phase_moe_lm(card)
    ssm_lm = phase_ssm_lm(card)
    encdec_lm = phase_encdec_lm(card)
    phase_slice("filter", params, te,
                neural=S.build_neural(NEURAL_ARCH, device="cuda"))
    free_cuda()
    phase_train_lm()
    moe_parity = phase_moe_parity()
    moe_check = phase_moe_lm_check()     # its CPU part is the largest
    ssm_parity = phase_ssm_parity()
    ssm_check = phase_ssm_lm_check()
    phase_ssm_train()
    encdec_parity = phase_encdec_parity()
    encdec_check = phase_encdec_lm_check()
    phase_encdec_train()
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
        "encdec_lm_check_launches": encdec_check["k8_launches"]}
    extra["query_bias"] = dict(
        score_launches=qb_score_launches,
        pump_launches=pump["qb_launches"],
        warm_restart_launches=warm["qb_launches"],
        witness_launches=witnessed["qb"])
    for name, n in paper["launches"].items():
        extra.setdefault(name, {})["paper_launches"] = n
    for name, n in paper["paper_scale_launches"].items():
        extra.setdefault(name, {})["paper_scale_table3_launches"] = n
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
            for shape in ("ring", "long", "zamba2", "encdec_cross"):
                for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                            "cuda_launches_per_call"):
                    row[f"{shape}_{key}"] = k8[shape][key]
                row[f"{shape}_n_split"] = k8[shape]["plan"]["n_split"]
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
