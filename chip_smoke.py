#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  — nvcc builds the six CUDA kernels from
     horovod_tpu_torch/csrc/, one process per source, in parallel; what
     ptxas says of registers and spills, and the HGMMA (wgmma) and
     UTMALDG (TMA) instructions in each library's SASS, which all six
     must have (each has a Hopper instance); the same per kernel for the
     18 kernels of the f32 (tf32) instance of kernels 2 and 3, which must
     spill nothing and hold both, and the clusters of its dW blocks the
     card holds at once, which every ResNet-50 site's plan must fit in
     one wave;
  2. conv kernel checks — kernels 1–3 against their plain PyTorch
     versions on the card, in bf16 and in f32, at ResNet-50 site shapes
     (batch 32) plus ragged M (on the Hopper instances, and on the
     simple ones) and a C that is no multiple of 16, each line naming
     the instance that ran (`hopper`, `hopper_tf32` or `simple`);
     kernel 2's ReLU mask
     against the forward's z > 0 on an input built to sit on the
     boundary, with bf16 and with f32 y; two launches of each Hopper
     instance of kernels 1–3 at (6272, 1024, 512) giving bitwise-equal
     y, Σy, Σy², dx and dW (kernels 2 and 3 in f32 too), and two of
     kernel 6's at the LM's shape giving the same dq; then each kernel,
     its plain version and a PyTorch yardstick timed at every fused site
     shape of a ResNet-50 step, in both types (in f32 the yardstick both
     in full f32 and as tf32 cuBLAS), beside the card's bound (device
     time from the profiler's trace, `device_ms`; the wall time of
     back-to-back calls beside it);
  3. flash kernel checks — kernels 4–6 against their plain versions at
     the LM's shape (B·H 192, S 1024, dh 128, causal, bf16), non-causal,
     a ragged S, dh 64, a non-causal chunk (Sq 512, Sk 1024) with an lse
     cotangent, f32, dh 32 with a ragged S, dh 80 (zero-padded to the
     128 instance), dh 200 (the 256 instance) in bf16 and f32, and dh
     320 and 512 (the wide path, padded to 512) in bf16 and f32, each
     line naming the instance that ran; then each timed (device time)
     at the LM's shape beside its bound, its plain version and
     scaled_dot_product_attention (kernel 6 has no PyTorch call of its
     own: kernels 5 + 6 are timed as a pair against SDPA's backward),
     and at the shapes that still run the simple code (FLASH_SIMPLE:
     f32 at the ring's chunk and at the LM's S, bf16 at dh 256 and at
     dh 512, the wide path), each with the backend SDPA picked;
  4. ResNet main path — hvd.init(), ResNet-50 at full width (224², bf16,
     batch 32) with HOROVOD_CONV_BLOCK=1 (every site on the Hopper
     instances of kernels 1 and 2), broadcast_parameters,
     DistributedOptimizer(SGD momentum 0.9) with the bucketed NCCL
     all-reduce: 2 warm-up and 5 timed steps, the launch counters read
     around them; then one step from the same weights on the unfused
     route, whose loss must match; kernel 3 on its path, 7 steps with
     HOROVOD_FUSE_CONV_BN=1; f32 steps from the same weights on the
     block route (28 + 28 launches of kernels 1 and 2), the fuse_bn route
     (28 of kernel 3 alone) and the unfused route, whose first losses and
     losses after one step must agree, and each route's ms/step;
  5. LM main path — the transformer LM at the bench's flagship width
     (L12 D2048 F8192 H16 S1024 B12 V32768, bf16, Adam) through
     horovod_tpu_torch.transformer_lm with attn="flash": 2 warm-up and
     5 timed steps, 12 launches of each flash kernel per step, all on
     the Hopper instances (bf16, dh 128); then one
     step from the same weights with attn="local", whose loss must match;
     then fault C13's check: 5 backward passes of the LM step from one
     state (every other token from 64 ids) and of the tied LM's
     global_loss, whose embedding gradients must be bit-identical;
  6. the launcher — `python -m horovod_tpu_torch.runner.launch
     --check-build` names the card and the six kernels built by phase 1;
     the launcher starts the synthetic benchmark (ResNet-50, 224², bf16,
     batch 32, HOROVOD_CONV_BLOCK=1) on one rank, which joins its NCCL
     world through the launcher's `tcp://` coordinator and prints its
     img/s; `runner.run` runs one step of the same model in a worker,
     whose loss must equal phase 4's first block-route loss (same seed-0
     weights, same batch) and whose kernels 1 and 2 launch 28 times
     each; `--scaling-report 1` starts both of its worlds through
     `runner.run` and prints the JSON line, and `--scaling-report 2` is
     refused on one card;
  7. collectives — hvd.init() on NCCL with process sets and
     hierarchical mode on: every op of ops/collectives.py (Min, Max,
     Product and Adasum through allreduce and grouped_allreduce,
     allgather, reducescatter, alltoall with splits, broadcast, a set
     [0] added and removed, the hierarchical allreduce and allgather,
     DuplicateNameError on a reused async name) on CUDA tensors in bf16,
     f32 and int32, bit for bit against k = 1's result, then
     `collective_bench.check` against numpy, and the flat allreduce of
     ResNet-50's 25,557,032 bf16 gradient values timed. With two or more
     cards, a world of min(4, count) through `runner.run` holds every op
     against numpy (sets {0, 2} and {0, 1, 2}, uneven allgather,
     reducescatter and alltoall, hierarchical against flat under
     HOROVOD_TPU_MESH_SHAPE=2x2 at 4) and prints the bus GB/s of the flat
     and hierarchical allreduce, allgather and alltoall; with one card it
     says so and checks nothing more.
  8. the training API — hvd.init() on NCCL, ResNet-50 at full width
     (224², bf16, batch 32, HOROVOD_CONV_BLOCK=1, cuDNN deterministic)
     from the seed-0 weights on one fixed batch, 3 steps of
     DistributedOptimizer(SGD momentum 0.9) for each of op= Average
     (twice), Sum, Adasum (per tensor, one collective per parameter),
     Min, Max and Product, and groups=4 (the step-time path): at k = 1
     each reduce is the identity, so each loss sequence equals
     Average's bit for bit; gradient_predivide_factor 4 within
     TOL_PREDIVIDE; kernels 1 and 2 launch 28 times a step on each;
     backward_passes_per_step 2 (SGD lr 0.1): the first step() returns
     None and moves nothing, the second moves each parameter by
     -lr·(g1 + g2) of two gradients taken with no optimizer, within one
     bf16 step (2^-7) of |w - lr·(g1 + g2)| and of |lr·(g1 + g2)|; fault C5 on the card
     (broadcast_optimizer_state keeps the momentum buffers, a fresh
     optimizer loaded from broadcast_object's copy holds them on the
     card) and broadcast_object/allgather_object of a dict with a CUDA
     tensor; EmbeddingBag(10000, 64, sparse=True) with a Linear head, 3
     steps against sparse_as_dense within TOL_SPARSE; img/s of the
     Average hook path, the grouped path, Adasum and bpps 2; then the
     launcher with --autotune (warm-up 1, 2 steps a sample, 3 samples)
     and with HOROVOD_BUCKET_AUTOTUNE=1 (interval 2) runs the synthetic
     benchmark until each tuner freezes, printing its samples or
     decisions, every loss finite. With two or more cards a world of
     min(4, count) through `runner.run` holds every op against numpy,
     join over uneven loops and one tuner decision on every rank
     (horovod_tpu_torch/optim/world_check.py); with one card it says so.
  9. the input pipeline and the profilers — hvd.init() on NCCL,
     ResNet-50 at full width (224², bf16, batch 32, HOROVOD_CONV_BLOCK=1):
     DeviceFeed stages phase 4's batch and three more bit for bit, and 3
     steps fed by it give the losses of 3 steps fed by `.to(device)`, bit
     for bit under cuDNN deterministic; perfscope over 10 implicit steps
     of the hook path (kernels 1 and 2 launched 28 times a step) with a
     prefetched feed and with a synchronous one whose source sleeps 50
     ms a batch: coverage, comms and optimizer, input_wait under
     MAX_INPUT_WAIT_FED of the fed step and, in the mean starved step,
     at least that sleep; mfu, the gradient hooks off the training
     thread; hvd.start_timeline around 3
     steps holds one span per bucket (18) a step, with NVTX ranges, and a
     copy cut mid-event recovers; device_profile.profile_step's "hvd
     kernel" category within TOL_KERNEL_CATEGORY of phase 2's kernel 1 +
     2 times; img/s with HOROVOD_PERFSCOPE=0 against the default, in
     turns (recorded, not gated); then `runner.launch -np 1
     --timeline-filename` of the synthetic benchmark leaves a trace with
     the bucket spans and rank 0's perfscope summary, which the launcher
     persisted into HOROVOD_FLIGHT_DIR.
 10. elastic training and checkpointing — ResNet-50 at full width (224²,
     bf16, batch 32, block route, seed-0 weights, cuDNN deterministic)
     with DistributedOptimizer(SGD momentum 0.9) in a TrainLoopState:
     (a) a commit after step 2, two more steps, restore(): parameters,
     BN stats and momentum equal the commit bit for bit; (b) under
     @hvd.elastic.run with HOROVOD_ELASTIC=1, a HorovodInternalError
     injected once after step 3's backward: the state restores, the
     NCCL world is aborted and made again in the process, the same
     optimizer carries on, the 5 losses equal an uninterrupted run's bit
     for bit, kernels 1 and 2 launch 28 times every step on both sides,
     and no kernel is built or loaded again; (c) 5 steps saving every
     step through the AsyncCheckpointer under perfscope: each save's
     bytes, snapshot ms against the step's, the background persist's
     seconds, the `checkpoint` phase's share, the snapshot's two ways
     (pinned side stream, synchronous .cpu()) in turns, then a blocking
     save restored into a fresh model whose logits on phase 4's batch
     equal the saved model's bit for bit; (d) `runner.launch` in
     elastic mode over horovod_tpu_torch/elastic/resnet_check.py, the
     worker SIGKILLed after step 3's commit and round 2's fresh worker
     resuming from the checkpoint at step 3, its losses (28 + 28
     launches a step) and final parameter digest equal an uninterrupted
     twin's, with the time to recover from the kill to round 2's first
     step; (e) with two or more cards, a world of 2 whose rank 1 exits
     at step 5: the survivor's collective raises HorovodInternalError
     within HOROVOD_STALL_SHUTDOWN_TIME_SECONDS (30 s), it restores,
     re-joins round 2 at size 1, grows back to 2 with a joiner synced
     from rank 0, and both end on the twin's parameters; with one card
     it says so.
 11. sequence parallelism — (a) the ring's hops on one card: the LM's
     attention (B 12, H 16, S 1024, dh 128, causal, bf16 upcast to f32)
     in 4 sequence blocks, each ring rank's 4 hops through
     ring_attention.ring_hop (the skipped, causal and full cases), the
     outputs and the q, k, v gradients against flash_attention at full
     S in f32 and the plain f32 attention (TOL_RING, tile by tile), 10
     launches each of kernels 4–6 (causal rank r runs r + 1 chunks, all
     on the f32 simple instances) with an lse cotangent on every
     kernel-5 call, the ring's chunk shapes against the plain versions,
     and the hop loop timed beside one flash_attention at full S; (b)
     the flagship LM through transformer_lm.run with attn="ulysses" and
     "ring" under HOROVOD_MESH="sp=1", 1 warm-up and 3 timed steps from
     the seed-0 weights and phase 5's batch: losses within TOL_SP_LOSS
     of phase 5's flash ones, 12 launches of kernels 4–6 a step,
     tokens/s and ms/step; (c) with two or more cards, the same LM in a
     world of min(4, count) under HOROVOD_MESH="sp=N" through
     `runner.run`, ring and Ulysses: rank 0's world loss against phase
     5's, kernels 4–6 12·(r + 1) (ring) or 12 (Ulysses) times a step on
     rank r, tokens/s over the global batch and each rank's peak
     memory; with one card it says so.
 12. the benchmark's other models and the API surface — hvd.init() on
     NCCL: (a) VGG-16 (224²) and Inception V3 (299²), bf16, batch 32,
     1000 classes, through synthetic_benchmark.build/train_step and the
     bucketed DistributedOptimizer (SGD momentum 0.9; VGG-16 at lr
     VGG_LR, since the benchmark's 0.01 diverges on it, as on the JAX
     model) from the seed-0 weights, 2 warm-up and 5 timed steps:
     every loss finite, every Inception BN stat
     moved, none of kernels 1–6 launched (no TPU kernel lies on these
     models' path); img/s, ms/step, buckets a step, peak memory,
     perfscope's dispatch share and, by profile_step.profile_route over
     device_profile's kernel events, the device busy share, kernels a
     step and ms by family; one VGG-19 step, its loss finite; (b) one
     f32 forward and backward at batch 2 of the same weights on the
     same batch on the card and on the host, tf32 off: VGG-16 at 64²,
     Inception V3 at 75² in eval mode, and Inception's train-mode loss
     at 299², the loss and the largest |gradient| within TOL_HOST; (c)
     ops/pooling.max_pool's forward and gradient on the card equal the
     host's bit for bit on all-zero and post-ReLU inputs, 3x3/2 and
     2x2/2, f32 and bf16; (d) every in-place and grouped async form of
     ops/collectives.py on CUDA tensors in bf16 and f32 writes into the
     caller's tensor exactly what the out-of-place form returns, and
     nccl_built() and cuda_built() are True; (e) SyncBatchNorm in a
     world of 1 against the JAX-formula BN, and with two or more cards a
     world of 2 (batches 3 and 5) through `runner.run` against one
     SyncBatchNorm over the 8 on one card (TOL_SBN, TOL_SBN_STATS); (f)
     `runner.launch -np 1` of the synthetic benchmark with --model
     inception3 prints its img/s, and with two or more cards
     `--scaling-report min(4, count) --model vgg16` its JSON line
     (recorded); with one card it says so.
 13. observability and the control plane — (a) the phase-4 ResNet-50
     step (2 warm-up and 5 timed steps) with metrics, flight and tracing
     at their defaults (on), and from the same weights and batch with
     HOROVOD_METRICS=0 HOROVOD_FLIGHT=0 HOROVOD_TRACE=0, four runs each
     in ABBA order: equal losses
     (cudnn.deterministic), 28 launches each of kernels 1 and 2 a step,
     `hvd.metrics()` counting the calls and bytes the bucket plan
     implies; ms/step on and off and the ratio of their medians,
     and the stall watchdog's host µs a bucket; (b) `runner.launch -np
     1` of the synthetic benchmark with --stall-check,
     HOROVOD_CHECK_COLLECTIVES=1, the native KV server and
     HOROVOD_FLIGHT_DIR: `GET /metrics` scraped while it runs holds rank
     0's collective counters, and the flight tail, the trace spans and
     the exit dump are in the directory at its end; with two or more
     cards a world of min(4, count) with the consistency check, then one
     in which rank 1 sleeps past the shutdown window as it launches its
     first gradient bucket (a `collective.dispatch` latency fault): every
     other rank raises HorovodInternalError naming the collective it
     waits on (the backward's sync-BN all-reduce) within
     STALL_WINDOW_S + STALL_MARGIN_S of the step's dispatch, and each
     rank's flight records name the bucketed all-reduce; with one card
     it says so.
 14. serving, the record readers and the data service — (a) the
     flagship LM (seed-0 weights, bf16, attn="flash") in
     serve/engine.py's InferenceEngine: one CUDA graph per bucket (1, 2,
     4, 8), the capture seconds of each; per bucket the device ms of a
     replay against the eager forward of the same padded batch, kernel
     4's launches in a replay from the profiler's trace (12, all on the
     Hopper instance; the wrapper's count does not see replays), the
     replayed logits against the eager forward and a request's logits
     beside 7 padding rows against it alone (TOL_BF16), no capture
     after warm-up; (b) `python -m horovod_tpu_torch.serve` with one
     replica per card (at most 2) restored params-only from (a)'s
     checkpoint root, 64 requests of 1024 tokens from 4 client threads,
     each response against (a)'s engine (TOL_BF16), p50, p99 and
     requests/s, then the doctor's [serve] section and joined request
     traces; with two or more cards one replica is SIGKILLed under load
     and the doctor names it, with one card it says so; (c) the phase-4
     ResNet-50 step under hvdwatch, clean (zero anomalies) and with a
     WATCH_FAULT_MS latency fault on 3 steps (the step-time detector
     fires, the flight recorder holds the anomaly, the on-demand
     capture holds kernels 1 and 2), and hvdtop's snapshot of a
     `runner.launch -np 1` benchmark showing rank 0's step time; (d) the
     phase-4 batch and three more through two DataWorkers,
     DataServiceClient and DeviceFeed into the same step: the losses
     equal the same batches fed in process bit for bit, and the
     input_wait share.
 15. tensor, pipeline and expert parallelism — the flagship LM (bf16,
     Adam, attn="flash", seed-0 weights, phase 5's batch) on one card:
     (a) remat "dots" and "full", 3 steps each, losses against phase
     5's (TOL_REMAT, and whether bit for bit), peak memory against phase
     5's, 24 launches of kernel 4 a step (the recompute) and 12 of
     kernels 5 and 6; (b) 8 experts at ep = 1 (capacity 2.0) with remat
     "dots": the first loss with attn="flash" against attn="local" on
     the same weights (TOL_MOE_LOSS), the tokens routed differently and
     dropped, 3 training steps, their peak memory and launches; (c) two
     microbatches at pp = 1 against phase 5's losses (TOL_MICRO); then,
     with two or more cards, through runner.run under HOROVOD_MESH, the
     LM at tp = N, at pp = N with N microbatches, at ep = N with 8
     experts, and at dp = 2 x tp = 2 (N = 4 with four cards, else 2):
     rank 0's world losses (tp's and pp's, whose model and batch are
     the one card's, against its losses to TOL_SP_LOSS), tokens/s,
     ms/step, each rank's peak memory and launches of kernels 4–6 a
     step ((L/pp)·(M + pp − 1) per stage under pp); with four cards the
     tied LM at bench.py's gspmd_hybrid shapes (canonical config, B 64,
     S 64; SGD at TIED_LR) at dp = 2 x tp = 2 against dp = 4: the first
     losses (TOL_TIED_LOSS), and each step's move of the loss against
     the whole move (TOL_TIED), which must reach TIED_MIN_MOVE; with
     one card it says so.
 16. the layout pass, its tuner, hvdrace and hvdlint — ResNet-50 at full
     width (224², bf16, batch 32, phase 4's seed-0 weights and batch):
     (a) the plan at the port's lane (64) is as_declared; (b) at lane
     128 the JAX package's edges pad (the stem and the stage-0 blocks'
     inner widths, 64→128), every 1x1 site of the padded model takes
     the Hopper instances, kernels 1–3 at each padded site shape
     against their plain versions with every padded lane exactly 0,
     LAYOUT_STEPS SGD-momentum steps through DistributedOptimizer on
     HOROVOD_CONV_BLOCK=1 against as many as-declared steps from the
     same weights (losses within TOL_LOSS, 28 launches of kernels 1 and
     2 a step, every padded lane of the weights, BN parameters, running
     stats and momentum exactly 0, the stripped weights within
     TOL_PADDED_STATE, the unfused route's distances printed beside),
     FUSE_BN_STEPS padded steps on kernel 3's route, and kernels 1 and 2 timed alone at the padded stage-0
     sites beside their as-declared sites; (c) OnlineLayoutTuner
     (HOROVOD_LAYOUT_AUTOTUNE=1, interval TUNER_INTERVAL) over both
     arms, swapping through resnet.relayout: each arm's mean ms a step
     and the winner (any winner passes), memory within MEM_SWAP_GROWTH
     across each swap; (d) in a bounded process under HOROVOD_RACE_CHECK=1
     and HOROVOD_RACE_CHECK_FAIL=1, phase 14's serving engine under
     requests from RACE_CLIENTS threads and an async checkpoint beside a
     ResNet-50 step, with no race report and no stale annotation; then
     `python -m horovod_tpu_torch.analysis horovod_tpu_torch` with the
     empty baseline exits 0;
 17. frontends and orchestration — (a) which of tensorflow, keras,
     pandas, pyarrow, fsspec, cloudpickle, pyspark, ray and mxnet this
     machine has (the only condition a later part tests); (b)
     spark.elastic.run_elastic with its agents in threads
     (thread_agent_runner) and one worker, given no CPU request, that
     trains ResNet-50 at full width (224², bf16, batch 32,
     HOROVOD_CONV_BLOCK=1) from phase 4's seed-0 weights on phase 4's
     batch for ORCH_STEPS steps: elastic NCCL on the card (cuda:0, local
     rank 0), its first loss
     within TOL_LAUNCHED_LOSS of phase 4's first block-route loss, 28
     launches of kernels 1 and 2 a step from the worker's counters, its
     ms a step; (c) where pandas and pyarrow are present, TorchEstimator
     on the same model, route and seed-0 weights through LocalBackend(1)
     (no CPU request) on a frame of phase 4's batch (float32 images, int64
     labels), batch 32, ESTIMATOR_EPOCHS epochs of one step, no shuffle:
     epoch 1's loss within TOL_LAUNCHED_LOSS of the same loss, 28 + 28
     launches in the worker's first step (its rank-0 callback), and
     `transform` of TRANSFORM_ROWS rows on the card (TorchModel's own
     copy of the module; the stored one stays on the host) within
     TOL_TRANSFORM of the trained module's eval forward; (d) where
     tensorflow is
     present, allreduce of a TF tensor through the port with Sum and
     Average, eagerly and in a tf.function, bit for bit against numpy.
     A part whose package is absent prints `not run: <package> absent
     on this machine`. `spark_elastic_cards()`, outside this run,
     repeats (b) with ELASTIC_CARDS workers, one card each.
 18. the analyzers of recorded step programs — (a) phase 4's ResNet-50
     block-route step (224², bf16, batch 32, seed-0 weights and batch,
     its first step) recorded by horovod_tpu_torch/analysis/graph.py:
     exactly 28 + 28 kernel ops (conv1x1_fwd_fused,
     conv1x1_bn_act_bwd_fused) and 28 + 28 launches, one all-reduce per
     bucket of the plan whose payloads sum to the gradients' bytes, and
     a loss equal to phase 4's first bit for bit; (b) phase 5's flagship
     LM step (Adam, after one step that makes its state): 12 + 12 + 12
     kernel ops and launches of kernels 4-6; neither with an HVD504
     finding (phase 5's C13 check); for each, every family's
     findings by rule (hvdhlo, hvdshard, hvdsched, hvdnum), the HVD303
     peak-memory estimate beside torch.cuda.max_memory_allocated of the
     same step and their ratio, and the seconds; (c) phase 14's serving
     engine's hvdhlo stamp over buckets 1, 2, 4, 8 (each bucket's
     warm-up recorded): no error, 12 kernel-4 ops in each program.
Then the `kernels` JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Exits non-zero without a CUDA device, and wherever a check fails.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12    # dense bf16 tensor cores, same source
TF32_FLOPS_PER_S = 495e12    # dense tf32 tensor cores, same source

CHECK_SHAPES = [(100352, 64, 256), (25088, 512, 128), (6272, 1024, 256),
                (6272, 1024, 512), (6271, 256, 1024), (6271, 64, 200),
                (1001, 24, 50)]
REPEAT_SHAPE = (6272, 1024, 512)  # the Hopper instances' determinism check
# Tolerances, each relative to the reference's scale (bf16 keeps 8
# significant bits; both sides accumulate in f32 in different orders, so
# a rounded output may differ by one bf16 step, 2^-7 of the largest
# value; f32 outputs only by accumulation order):
TOL_BF16 = 2.0 ** -7        # y, dx: max|Δ| / max|ref|
TOL_SUMS = 1e-3             # Σy: max|Δ| / Σ|y| per channel; Σy²: relative
TOL_DW = 1e-3               # dW (f32): max|Δ| / max|ref|
TOL_LOSS = 2e-2             # fused vs unfused step loss, relative (bf16
                            # activations through 50 layers)
# f32 runs the conv kernels on tf32 (operands rounded to 11 significant
# bits, products summed in f32), the plain versions in full f32: the
# error of a K-term sum stays near 2^-11 of its typical term, well inside
# 2^-9 of the largest output. The f32 ResNet step carries that rounding
# through 50 layers of random weights.
TOL_TF32 = 2.0 ** -9        # f32 y, dx, dW: max|Δ| / max|ref|
TOL_LOSS_F32 = 1e-2         # f32 block vs unfused step loss, relative
TOL_PREDIVIDE = 2.0 ** -8   # phase 8: each loss with predivide 4 vs
                            # Average, relative (one bf16 step; /4 and
                            # x4 are exact in bf16 but for underflow)
TOL_SPARSE = 1e-6           # phase 8: sparse vs sparse_as_dense f32
                            # weights after 3 steps, of the largest
# Flash kernels against their plain versions (full f32 scores), o, dk,
# dv and dq each held tile by tile: every 64-row tile (what one kernel
# block writes) must satisfy ‖Δ_tile‖ ≤ tol·‖ref_tile‖, so an error in
# any tile shows whatever the other tiles hold. In bf16 the kernels
# round p and ds to bf16 (8 significant bits, rms error ~2^-9.3 of a
# value) before the second product and the output to bf16 (the same
# again): ~2^-8.6 of a tile's norm, under 2^-7. In f32 every operand is
# rounded to tf32 (11 bits, rms ~2^-12.3), in the scores, p, dp and ds
# in turn: ~2^-11 of a tile's norm, under 2^-9.
TOL_FLASH = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -9}  # ‖Δ‖/‖ref‖ a tile
TILE = 64
TOL_LSE = 2e-3              # lse, absolute
TOL_DELTA = 2e-5            # delta = rowsum(do·o) − dlse, each row against
                            # Σ|do·o| + |dlse|: two f32 sums of ≤ 128 terms
                            # in different orders differ by at most
                            # 2·127·2^-24 ≈ 1.5e-5 of that
TOL_LM_LOSS = 1e-4          # flash vs local attention LM step loss,
                            # relative: ~9x the 1.1e-5 measured on an
                            # H100 (bf16 softmax in "local")
TOL_LAUNCHED_LOSS = 1e-3    # the launched worker's first ResNet loss vs
                            # phase 4's, relative: the same weights, batch
                            # and route, and kernels 1 and 2 repeat bit for
                            # bit, so only library choices that differ
                            # between two processes could move it; 1e-3 is
                            # a quarter of the fused vs unfused gap (4e-3)
SCALING_KEYS = ["model", "per_rank_batch", "ips_1chip", "ips_per_chip_at_n",
                "n", "scaling_efficiency"]  # examples/synthetic_benchmark.py


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time of one fn() call: every kernel (and copy) that `iters`
    back-to-back calls run, summed from torch.profiler's trace of the
    card, over iters; the larger of two such windows, since a trace can
    come back with records missing (seen once in f32 on an H100). Unlike
    time_ms it leaves out the host's time between launches: a conv
    wrapper spends ~0.1 ms of Python and launches a call, longer than
    its kernels. Falls back to time_ms when the trace holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best_us = 0.0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        best_us = max(best_us, sum(getattr(e, "device_time_total", 0.0)
                                   for e in prof.key_averages()))
    if best_us <= 0:
        return time_ms(fn, iters, warmup)
    return best_us / 1e3 / iters


def bound(kind: str, m: int, cin: int, c: int, e: int = 2):
    """(bound ms, bytes ms, flops ms) for elements of e bytes (2: bf16,
    4: f32 on tf32): each input read once, each output written once, over
    HBM; the products' flops over the type's tensor-core peak."""
    if kind == "fwd":
        nbytes = e * m * cin + e * cin * c + e * m * c + 2 * 4 * c
        flops = 2 * m * cin * c
    else:
        rows = 7 if kind == "act_bwd" else 5
        nbytes = (e * 2 * m * c + e * m * cin + e * cin * c + 4 * rows * c
                  + e * m * cin + 4 * cin * c)
        flops = 4 * m * cin * c
    peak = BF16_FLOPS_PER_S if e == 2 else TF32_FLOPS_PER_S
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(tb, tf), tb, tf


class Failed(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# ---------------------------------------------------------------- inputs

def site_inputs(m, cin, c, dev, seed, dtype=None):
    """Site inputs in `dtype` (default bf16) and the f32 rows both
    backward kernels take."""
    import torch
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dtype or torch.bfloat16
    x = torch.randn((m, cin), generator=g, device=dev).to(bf)
    w = (torch.randn((cin, c), generator=g, device=dev)
         * cin ** -0.5).to(bf)
    scale = (1 + 0.5 * torch.randn((c,), generator=g, device=dev)).to(bf)
    bias = (0.1 * torch.randn((c,), generator=g, device=dev)).to(bf)
    dz = torch.randn((m, c), generator=g, device=dev).to(bf)
    y, ssum, ssq = cb._fwd_plain(x, w)
    mean = ssum / m
    inv = torch.rsqrt(ssq / m - mean.square() + 1e-5)
    db_m, dg_m = cb._bn_act_sums(dz, y, mean, inv, scale, bias, True)
    g2, a2, b2 = cbb.fold_rows(scale.float(), inv, db_m, dg_m, None, None, m)
    db, dg = cbb._bn_sums(dz, y, mean, inv)
    g3, a3, b3 = cbb.fold_rows(scale.float(), inv, db, dg, None, None, m)
    return dict(x=x, w=w, scale=scale, bias=bias, dz=dz, y=y, mean=mean,
                inv=inv, db_m=db_m, dg_m=dg_m, db=db, dg=dg,
                rows2=(g2, mean, inv, a2, b2, scale.float(), bias.float()),
                rows3=(g3, mean, inv, a3, b3))


def run_k1(s):
    from horovod_tpu_torch.ops import conv_block as cb
    return cb.conv1x1_fwd_fused(s["x"], s["w"])


def plain_k1(s):
    from horovod_tpu_torch.ops import conv_block as cb
    return cb._fwd_plain(s["x"], s["w"])


def run_k2(s):
    from horovod_tpu_torch.ops import conv_block as cb
    return cb.conv1x1_bn_act_bwd_fused(
        s["dz"], s["y"], s["x"], s["w"], s["scale"], s["bias"], s["mean"],
        s["inv"], s["db_m"], s["dg_m"])


def plain_k2(s):
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    return cbb._bwd_plain(s["dz"], s["y"], s["x"], s["w"], *s["rows2"])


def run_k3(s):
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    return cbb.conv1x1_bn_bwd_fused(
        s["dz"], s["y"], s["x"], s["w"], s["scale"], s["mean"], s["inv"],
        s["db"], s["dg"])


def plain_k3(s):
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    return cbb._bwd_plain(s["dz"], s["y"], s["x"], s["w"], *s["rows3"])


def library_fwd(s):
    import torch
    y = torch.matmul(s["x"], s["w"])
    yf = y.float()
    return y, yf.sum(0), yf.square().sum(0)


def library_bwd(s, dy):
    import torch
    return torch.matmul(dy, s["w"].t()), torch.matmul(s["x"].t(), dy)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_outputs(name, got, ref):
    """Hold one kernel's outputs against the plain version's; returns
    the max abs error over its outputs."""
    import torch
    f32 = ref[0].dtype == torch.float32
    tol_out = TOL_TF32 if f32 else TOL_BF16
    if name == "fwd":
        (y, s1, s2), (yr, s1r, s2r) = got, ref
        e = _err(y, yr)
        need(e <= tol_out * float(yr.float().abs().max()),
             f"kernel 1 y: max|Δ| {e}")
        scale = yr.float().abs().sum(0) + 1e-30
        rel = float(((s1 - s1r).abs() / scale).max())
        need(rel <= TOL_SUMS, f"kernel 1 sum: {rel} of Σ|y|")
        rel2 = float(((s2 - s2r).abs() / (s2r.abs() + 1e-30)).max())
        need(rel2 <= TOL_SUMS, f"kernel 1 sumsq: relative {rel2}")
        return max(e, _err(s1, s1r), _err(s2, s2r)), f"y {e:.3g}, Σy rel {rel:.3g}, Σy² rel {rel2:.3g}"
    (dx, dw), (dxr, dwr) = got, ref
    e1, e2 = _err(dx, dxr), _err(dw, dwr)
    need(e1 <= tol_out * float(dxr.float().abs().max()),
         f"{name} dx: max|Δ| {e1}")
    need(e2 <= (TOL_TF32 if f32 else TOL_DW) * float(dwr.abs().max()),
         f"{name} dW: max|Δ| {e2}")
    return max(e1, e2), (f"dx {e1:.3g} (max {float(dxr.float().abs().max()):.3g}),"
                         f" dW {e2:.3g} (max {float(dwr.abs().max()):.3g})")


def instance(m, cin, c, dtype, kernel="act_bwd") -> str:
    """The instance of kernel 1 ("fwd") or kernels 2 and 3 that runs this
    shape."""
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    pick = cb.fwd_instance if kernel == "fwd" else cbb.bwd_instance
    return pick(m, cin, c, dtype)


def check_kernels(dev, dtype):
    """Kernels 1–3 against their plain versions at CHECK_SHAPES in
    `dtype`, then the mask check; returns each kernel's largest max abs
    error."""
    import torch
    worst = {"fwd": 0.0, "act_bwd": 0.0, "bn_bwd": 0.0}
    tag = str(dtype).replace("torch.", "")
    for i, (m, cin, c) in enumerate(CHECK_SHAPES):
        s = site_inputs(m, cin, c, dev, seed=i, dtype=dtype)
        for name, run, plain in (("fwd", run_k1, plain_k1),
                                 ("act_bwd", run_k2, plain_k2),
                                 ("bn_bwd", run_k3, plain_k3)):
            got = run(s)
            torch.cuda.synchronize()
            ref = plain(s)
            for t in got:
                need(bool(torch.isfinite(t.float()).all()),
                     f"{name} at {(m, cin, c)}: non-finite output")
            err, msg = check_outputs(name, got, ref)
            worst[name] = max(worst[name], err)
            print(f"check {name:8s} {tag} M={m:6d} Cin={cin:4d} C={c:4d}"
                  f" [{instance(m, cin, c, dtype, name)}]: {msg}")
        del s
    mask_check(dev, dtype)
    return worst


def mask_check(dev, dtype, m=25088, c=256):
    """Kernel 2's ReLU mask equals the forward's z > 0, read out through
    the kernel itself: with w = I, dz = 1, g = 1 and a = b = 0 the
    kernel's dy is its mask and dx = dy @ wᵀ returns it. y takes few
    distinct values and each channel's bias cancels one of them exactly,
    so many pre-activations are exactly 0 (the mask must say 0 there)."""
    import torch
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    g = torch.Generator(device=dev).manual_seed(99)
    y = (torch.round(torch.randn((m, c), generator=g, device=dev) * 4) / 4
         ).to(dtype)
    yf = y.float()
    mean = yf.mean(0)
    inv = torch.rsqrt(yf.square().mean(0) - mean.square() + 1e-5)
    scale = (1 + 0.3 * torch.randn((c,), generator=g, device=dev)).to(
        torch.bfloat16).float()
    bias = -(((yf[0] - mean) * inv) * scale)   # row 0's value sits at 0
    zf = ((yf - mean) * inv) * scale + bias     # the forward's f32 chain
    fwd_mask = zf > 0
    on_boundary = int((zf == 0).sum())
    eye = torch.eye(c, device=dev, dtype=dtype)
    ones = torch.ones((m, c), device=dev, dtype=dtype)
    one, zero = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    dx, _ = cbb.launch_bwd("conv1x1_bn_act_bwd", "hvd_conv1x1_bn_act_bwd",
                           ones, y, ones, eye,
                           [t.contiguous() for t in
                            (one, mean, inv, zero, zero, scale, bias)])
    torch.cuda.synchronize()
    kmask = dx != 0
    equal = int((kmask == fwd_mask).sum())
    print(f"check mask ({dtype}) [{instance(m, c, c, dtype)}]: "
          f"{equal}/{m * c} equal to the forward's z > 0; "
          f"{on_boundary} pre-activations exactly on the boundary")
    need(on_boundary >= m, "mask check: too few boundary values")
    need(equal == m * c, f"kernel 2 mask differs at {m * c - equal} places")
    return equal, m * c, on_boundary


def repeat_check(dev, shape=REPEAT_SHAPE, flash_shape=(192, 1024, 128)):
    """Two launches of each Hopper instance (kernels 1, 2 and 3 at
    `shape` in bf16, kernels 2 and 3 in f32 too, kernel 6 at the LM's
    per-layer shape in bf16) on the same inputs give bitwise-equal
    outputs: every sum runs in a fixed order."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    m, cin, c = shape
    s = site_inputs(m, cin, c, dev, seed=7)
    out = {}
    for name, run in (("fwd", run_k1), ("act_bwd", run_k2),
                      ("bn_bwd", run_k3)):
        need(instance(m, cin, c, torch.bfloat16, name) == "hopper",
             f"{shape} does not take kernel {name}'s Hopper instance")
        a, b = run(s), run(s)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
        out[name] = same
        print(f"check repeat {name} bf16 M={m} Cin={cin} C={c} [hopper]: "
              f"two launches bitwise equal: {same}")
        need(same, f"{name}: two launches of the Hopper instance differ")
    del s
    s = site_inputs(m, cin, c, dev, seed=7, dtype=torch.float32)
    for name, run in (("act_bwd", run_k2), ("bn_bwd", run_k3)):
        inst = instance(m, cin, c, torch.float32, name)
        need(inst == "hopper_tf32",
             f"{shape} does not take kernel {name}'s f32 Hopper instance")
        a, b = run(s), run(s)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
        out[name + "_f32"] = same
        print(f"check repeat {name} f32 M={m} Cin={cin} C={c} [{inst}]: "
              f"two launches bitwise equal: {same}")
        need(same, f"{name}: two launches of the f32 Hopper instance "
             f"differ")
    del s
    bh, sq, dh = flash_shape
    need(fa.flash_instance(torch.bfloat16, dh) == "hopper",
         "the LM's head dim does not take kernel 6's Hopper instance")
    x = flash_inputs(bh, sq, sq, dh, True, "bfloat16", False, dev, 9)
    q, k, v, do, sc = x["q"], x["k"], x["v"], x["do"], x["scale"]
    o, lse = fa.flash_fwd(q, k, v, True, sc)
    _, _, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, None, True, sc)
    a = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, sc)
    b = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, sc)
    torch.cuda.synchronize()
    out["attn_dq"] = bool(torch.equal(a, b))
    print(f"check repeat attn_dq bf16 BH={bh} S={sq} dh={dh} causal "
          f"[hopper]: two launches bitwise equal: {out['attn_dq']}")
    need(out["attn_dq"], "attn_dq: two launches of the Hopper instance "
         "differ")
    return out


def library_tf32_ms(fn) -> float:
    """device_ms of fn() with cuBLAS allowed tf32 (the conv kernels' f32
    precision), the script's full-f32 setting restored afterwards."""
    import torch
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return device_ms(fn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def time_kernels(dev, dtype):
    """Per-step times over the 28 fused sites of a ResNet-50 step at batch
    32 in `dtype`: kernel, plain version, PyTorch yardstick (device time,
    device_ms; in f32 both full-f32 SGEMM and, as library_tf32_ms, cuBLAS
    at the kernels' tf32 precision) and bound, each summed over the sites
    (site shape × its count); and the wall time of back-to-back wrapper
    calls (time_ms), which the host's time a call sets once the kernels
    are faster."""
    import torch
    from horovod_tpu_torch.models import resnet
    sites = resnet.fused_sites(50, 32, 224)
    shapes = {}
    for _, _, m, cin, c in sites:
        shapes[(m, cin, c)] = shapes.get((m, cin, c), 0) + 1
    agg = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, flops_ms=0.0, wall_ms=0.0)
           for k in ("fwd", "act_bwd", "bn_bwd")}
    if dtype == torch.float32:
        for a in agg.values():
            a["library_tf32_ms"] = 0.0
    detail = []
    for i, ((m, cin, c), count) in enumerate(sorted(shapes.items())):
        s = site_inputs(m, cin, c, dev, seed=100 + i, dtype=dtype)
        dy2 = (s["rows2"][0] * s["dz"].float() - s["rows2"][3]
               - s["rows2"][4] * (s["y"].float() - s["mean"]) * s["inv"]
               ).to(dtype)
        for name, run, plain, lib in (
                ("fwd", run_k1, plain_k1, library_fwd),
                ("act_bwd", run_k2, plain_k2, lambda s: library_bwd(s, dy2)),
                ("bn_bwd", run_k3, plain_k3,
                 lambda s: library_bwd(s, dy2))):
            t = {"ms": device_ms(lambda: run(s)),
                 "plain_ms": device_ms(lambda: plain(s), iters=5),
                 "library_ms": device_ms(lambda: lib(s)),
                 "wall_ms": time_ms(lambda: run(s))}
            if dtype == torch.float32:  # cuBLAS at the kernels' precision
                t["library_tf32_ms"] = library_tf32_ms(lambda: lib(s))
            b, tb, tf = bound(name, m, cin, c, dtype.itemsize)
            t.update(bound_ms=b, bytes_ms=tb, flops_ms=tf)
            for key, v in t.items():
                agg[name][key] += v * count
            detail.append(dict(kernel=name, dtype=str(dtype), M=m, Cin=cin,
                               C=c, count=count,
                               instance=instance(m, cin, c, dtype, name),
                               **t))
            print(f"time {name:8s} {dtype.itemsize * 8}b M={m:6d} "
                  f"Cin={cin:4d} C={c:4d} x{count} "
                  f"[{instance(m, cin, c, dtype, name)}]: "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
                  f"library {t['library_ms']:.4f}"
                  + (f" (tf32 {t['library_tf32_ms']:.4f})"
                     if "library_tf32_ms" in t else "")
                  + f", bound {b:.4f} "
                  f"({'bytes' if tb >= tf else 'operations'}); "
                  f"wall of back-to-back calls {t['wall_ms']:.4f}")
        del s, dy2
    return agg, detail


# ---------------------------------------------------------------- flash

# (label, B·H, Sq, Sk, dh, causal, dtype, with an lse cotangent)
FLASH_CHECKS = [
    ("LM shape", 192, 1024, 1024, 128, True, "bfloat16", False),
    ("non-causal", 48, 1024, 1024, 128, False, "bfloat16", False),
    ("ragged S", 48, 1000, 1000, 128, True, "bfloat16", False),
    ("dh 64", 48, 1024, 1024, 64, True, "bfloat16", False),
    ("chunk + dlse", 48, 512, 1024, 128, False, "bfloat16", True),
    ("f32", 48, 1024, 1024, 128, True, "float32", False),
    ("f32 chunk dh 32 + dlse", 48, 500, 1000, 32, False, "float32", True),
    ("bf16 dh 32 ragged", 48, 1000, 1000, 32, True, "bfloat16", False),
    ("dh 80 padded", 48, 1024, 1024, 80, True, "bfloat16", False),
    ("dh 200 (256 instance)", 48, 1024, 1024, 200, True, "bfloat16", False),
    ("f32 dh 200 + dlse", 8, 512, 512, 200, True, "float32", True),
    ("dh 320 (wide, 512)", 16, 1024, 1024, 320, True, "bfloat16", False),
    ("dh 512 (wide)", 16, 1024, 1024, 512, False, "bfloat16", False),
    ("f32 dh 320 + dlse", 8, 512, 512, 320, True, "float32", True),
]


def flash_inputs(bh, sq, sk, dh, causal, dtype, with_dlse, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(n):
        return torch.randn((bh, n, dh), generator=g, device=dev).to(dt)

    dlse = (0.1 * torch.randn((bh, sq), generator=g, device=dev)
            if with_dlse else None)
    return dict(q=rnd(sq), k=rnd(sk), v=rnd(sk), do=rnd(sq), dlse=dlse,
                causal=causal, scale=dh ** -0.5)


def run_flash(x):
    """Kernels 4, 5, 6 in turn; returns (o, lse, dk, dv, delta, dq)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    c, sc = x["causal"], x["scale"]
    o, lse = fa.flash_fwd(x["q"], x["k"], x["v"], c, sc)
    dk, dv, delta = fa.flash_bwd_dkdv(x["q"], x["k"], x["v"], o, x["do"],
                                      lse, x["dlse"], c, sc)
    dq = fa.flash_bwd_dq(x["q"], x["k"], x["v"], x["do"], lse, delta, c, sc)
    return o, lse, dk, dv, delta, dq


def tile_ratio(a, r, tile=TILE) -> float:
    """max over 64-row tiles (along dim 1 of (BH, S, dh)) of
    ‖a − r‖ / ‖r‖ in the tile."""
    import torch.nn.functional as F
    d2 = (a.float() - r.float()).square().sum(-1)
    r2 = r.float().square().sum(-1)
    pad = -d2.shape[1] % tile
    d2, r2 = (F.pad(t, (0, pad)).reshape(t.shape[0], -1, tile).sum(-1)
              for t in (d2, r2))
    return float((d2 / r2.clamp_min(1e-30)).sqrt().max())


def delta_ratio(delta, delta_r, o, do, dlse) -> float:
    """max over rows of |Δdelta| / (Σ|do·o| + |dlse|)."""
    size = (do.float() * o.float()).abs().sum(-1)
    if dlse is not None:
        size = size + dlse.abs()
    return float(((delta - delta_r).abs() / size.clamp_min(1e-30)).max())


def flash_case(dev, label, bh, sq, sk, dh, causal, dtype, wd, seed):
    """Kernels 4–6 once at one shape against their plain versions, each
    plain version fed what its kernel was fed (the backward ones the
    kernels' o, lse and delta); fails past the tolerances. Returns the
    record: max abs error and worst tile ratio of each output."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    x = flash_inputs(bh, sq, sk, dh, causal, dtype, wd, dev, seed)
    got = run_flash(x)
    torch.cuda.synchronize()
    for t in got:
        need(bool(torch.isfinite(t.float()).all()),
             f"flash {label}: non-finite output")
    o, lse, dk, dv, delta, dq = got
    q, k, v, do, c, sc = (x[n] for n in ("q", "k", "v", "do", "causal",
                                         "scale"))
    o_r, lse_r = fa._fwd_plain(q, k, v, c, sc)
    dk_r, dv_r, delta_r = fa._bwd_dkdv_plain(q, k, v, o, do, lse,
                                             x["dlse"], c, sc)
    dq_r = fa._bwd_dq_plain(q, k, v, do, lse, delta, c, sc)
    tol = TOL_FLASH[dtype]
    rec = {"check": label, "BH": bh, "Sq": sq, "Sk": sk, "dh": dh,
           "causal": causal, "dtype": dtype, "dlse": wd}
    for name, a, r in (("o", o, o_r), ("dk", dk, dk_r), ("dv", dv, dv_r),
                       ("dq", dq, dq_r)):
        rec[name] = _err(a, r)
        rec[name + "_tile"] = tile_ratio(a, r)
        need(rec[name + "_tile"] <= tol,
             f"flash {label} {name}: a tile's ‖Δ‖/‖ref‖ is "
             f"{rec[name + '_tile']} (tolerance {tol})")
    rec["delta"] = _err(delta, delta_r)
    rec["delta_tile"] = delta_ratio(delta, delta_r, o, do, x["dlse"])
    need(rec["delta_tile"] <= TOL_DELTA,
         f"flash {label} delta: {rec['delta_tile']} of Σ|do·o| + |dlse|")
    rec["lse"] = _err(lse, lse_r)
    need(rec["lse"] <= TOL_LSE, f"flash {label} lse: {rec['lse']}")
    rec["instance"] = fa.flash_instance(getattr(torch, dtype), dh)
    print(f"check flash {label:22s} {dtype} BH={bh} Sq={sq} Sk={sk} "
          f"dh={dh} [{rec['instance']}]: max|Δ| (worst tile ratio) "
          + ", ".join(
              f"{n} {rec[n]:.3g}" + (f" ({rec[n + '_tile']:.3g})"
                                     if n != "lse" else "")
              for n in ("o", "lse", "dk", "dv", "dq", "delta")))
    return rec


def check_flash(dev):
    """Kernels 4–6 against their plain versions at FLASH_CHECKS
    (flash_case). Returns each kernel's largest max abs error and the
    per-check records."""
    worst = {"attn_fwd": 0.0, "attn_dkdv": 0.0, "attn_dq": 0.0}
    records = []
    for i, case in enumerate(FLASH_CHECKS):
        rec = flash_case(dev, *case, seed=200 + i)
        worst["attn_fwd"] = max(worst["attn_fwd"], rec["o"], rec["lse"])
        worst["attn_dkdv"] = max(worst["attn_dkdv"], rec["dk"], rec["dv"],
                                 rec["delta"])
        worst["attn_dq"] = max(worst["attn_dq"], rec["dq"])
        records.append(rec)
    return worst, records


def flash_bound(kind, bh, sq, sk, dh, causal, e):
    """(bound ms, bytes ms, flops ms) of one flash kernel launch: each
    input read once and each output written once over HBM; the products
    over the unmasked (query, key) pairs this causal flag leaves, over the
    type's tensor-core peak (e bytes an element)."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    qs, ks, rows = bh * sq * dh, bh * sk * dh, bh * sq
    if kind == "attn_fwd":      # q, k, v -> o, lse
        nbytes, flops = e * (2 * qs + 2 * ks) + 4 * rows, 4 * pairs * dh
    elif kind == "attn_dkdv":   # q, k, v, o, do, lse -> dk, dv, delta
        nbytes = e * (3 * qs + 4 * ks) + 4 * 2 * rows
        flops = 8 * pairs * dh + 2 * sq * dh
    else:                       # q, k, v, do, lse, delta -> dq
        nbytes, flops = e * (3 * qs + 2 * ks) + 4 * 2 * rows, 6 * pairs * dh
    peak = BF16_FLOPS_PER_S if e == 2 else TF32_FLOPS_PER_S
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops * bh / peak * 1e3
    return max(tb, tf), tb, tf


def sdpa_backend(fn) -> str:
    """The backend scaled_dot_product_attention picked for fn(), read
    from the names of the kernels one call runs on the card: "flash",
    "efficient" (memory-efficient, CUTLASS), "cudnn" or "math" (no fused
    attention kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages()).lower()
    for key, label in (("cudnn", "cudnn"), ("flash", "flash"),
                       ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return label
    return "math"


def time_flash(dev, bh=192, s=1024, dh=128, heads=16, sq=None, causal=True,
               dtype="bfloat16"):
    """Kernels 4–6, their plain versions and
    torch.nn.functional.scaled_dot_product_attention (forward for kernel
    4; its autograd backward, which makes dq, dk and dv in one call, on
    kernel 5's line; each with the backend it picked) at B·H `bh`, `sq`
    queries (default `s`) against `s` keys, head dim `dh`, by default the
    LM's per-layer shape, causal, bf16. No PyTorch call computes dq
    alone, so kernels 5 + 6 are also timed as the pair ("attn_bwd") that
    SDPA's backward computes. In f32 SDPA runs as the script sets
    matmuls (full f32) and once more with tf32 allowed
    ("library_tf32_ms")."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa
    sq = sq or s
    dt = getattr(torch, dtype)
    x = flash_inputs(bh, sq, s, dh, causal, dtype, False, dev, 300)
    q, k, v, do, sc = x["q"], x["k"], x["v"], x["do"], x["scale"]
    o, lse = fa.flash_fwd(q, k, v, causal, sc)
    _, _, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, None, causal, sc)
    four = [t.reshape(bh // heads, heads, t.shape[1], dh)
            for t in (q, k, v, do)]
    leaves = [t.detach().requires_grad_(True) for t in four[:3]]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib_fwd = (lambda: F.scaled_dot_product_attention(*four[:3],
                                                      is_causal=causal))
    lib_bwd = (lambda: torch.autograd.grad(o_lib, leaves, four[3],
                                           retain_graph=True))
    runs = {
        "attn_fwd": (lambda: fa.flash_fwd(q, k, v, causal, sc),
                     lambda: fa._fwd_plain(q, k, v, causal, sc), lib_fwd),
        "attn_dkdv": (lambda: fa.flash_bwd_dkdv(q, k, v, o, do, lse, None,
                                                causal, sc),
                      lambda: fa._bwd_dkdv_plain(q, k, v, o, do, lse, None,
                                                 causal, sc), lib_bwd),
        "attn_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                            sc),
                    lambda: fa._bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                             sc),
                    None)}
    tag = (f"BH={bh} Sq={sq} Sk={s} dh={dh} "
           f"{'causal' if causal else 'non-causal'} {dtype}")
    inst = fa.flash_instance(dt, dh)
    out = {}
    for name, (run, plain, lib) in runs.items():
        b, tb, tf = flash_bound(name, bh, sq, s, dh, causal, dt.itemsize)
        t = {"ms": device_ms(run), "plain_ms": device_ms(plain, iters=3),
             "library_ms": device_ms(lib) if lib else None,
             "bound_ms": b, "bytes_ms": tb, "flops_ms": tf,
             "instance": inst}
        if lib is not None:
            t["library_backend"] = sdpa_backend(lib)
            if dt == torch.float32:
                t["library_tf32_ms"] = library_tf32_ms(lib)
        out[name] = t
        lib_s = ("n/a (in kernel 5's line)" if lib is None
                 else f"{t['library_ms']:.4f} ({t['library_backend']}"
                 + (f"; tf32 {t['library_tf32_ms']:.4f}"
                    if "library_tf32_ms" in t else "") + ")")
        print(f"time {name:9s} {tag} [{inst}]: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, library "
              f"{lib_s}, bound {b:.4f} "
              f"({'bytes' if tb >= tf else 'operations'})")
    pair = {"ms": device_ms(lambda: (runs["attn_dkdv"][0](),
                                     runs["attn_dq"][0]())),
            "library_ms": out["attn_dkdv"]["library_ms"],
            "bound_ms": sum(flash_bound(k, bh, sq, s, dh, causal,
                                        dt.itemsize)[0]
                            for k in ("attn_dkdv", "attn_dq"))}
    print(f"time attn_bwd  {tag}: kernels 5 + 6 "
          f"{pair['ms']:.4f} ms, SDPA backward {pair['library_ms']:.4f} "
          f"({pair['ms'] / pair['library_ms']:.2f}x), bound "
          f"{pair['bound_ms']:.4f}")
    out["attn_bwd_pair"] = pair
    return out


# The flash instances still on the simple code (PERF.md §6 rows 4–6):
# f32 at the ring's chunk (S/4 queries against S keys) and at the LM's
# full S, bf16 at dh 256 (the D 256 instance) and dh 512 (the wide path).
FLASH_SIMPLE = {
    "f32_ring_chunk": dict(bh=192, s=1024, sq=256, dh=128, causal=False,
                           dtype="float32"),
    "f32_lm": dict(bh=192, s=1024, dh=128, dtype="float32"),
    "bf16_dh256": dict(bh=48, s=1024, dh=256),
    "bf16_dh512": dict(bh=16, s=1024, dh=512),
}


def time_flash_simple(dev) -> dict:
    """time_flash at each FLASH_SIMPLE shape."""
    import torch
    out = {}
    for label, kw in FLASH_SIMPLE.items():
        out[label] = time_flash(dev, **kw)
        torch.cuda.empty_cache()
    return out


def sass_counts():
    """Per library, the HGMMA (wgmma) and UTMALDG (TMA load) instructions
    in its SASS, read with the toolkit's cuobjdump: all six kernels must
    have both. None where the toolkit has no cuobjdump."""
    from horovod_tpu_torch import kernels
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("sass: the toolkit has no cuobjdump; HGMMA/UTMALDG not counted")
        return None
    out = {}
    for name in kernels.SOURCES:
        sass = subprocess.run([tool, "-sass", kernels._target(name)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        out[name] = {op: sum(f" {op}." in line or f" {op} " in line
                             for line in sass.splitlines())
                     for op in ("HGMMA", "UTMALDG")}
        print(f"sass {name}: {out[name]['HGMMA']} HGMMA, "
              f"{out[name]['UTMALDG']} UTMALDG")
    for name in kernels.SOURCES:
        need(out[name]["HGMMA"] > 0 and out[name]["UTMALDG"] > 0,
             f"{name}: no wgmma or TMA load in its SASS")
    return out


TF32_KERNEL = re.compile(r"(dx_tf32|dw_tf32)ILb([01])E((?:Li\d+E)+)")


def _tf32_label(mangled: str):
    """"dx_tf32<MASK 1, 256>" for a mangled f32 Hopper kernel, else None."""
    m = TF32_KERNEL.search(mangled)
    if not m:
        return None
    ints = ", ".join(re.findall(r"Li(\d+)E", m.group(3)))
    return f"{m.group(1)}<MASK {m.group(2)}, {ints}>"


def tf32_instance_report() -> dict:
    """ptxas's registers and spills, and the HGMMA (wgmma) and UTMALDG
    (TMA load) instructions in the SASS, of each kernel of the f32 Hopper
    instance of kernels 2 and 3 (dx_tf32, dw_tf32 at each tile width),
    from this process's build: each must spill nothing and hold wgmma."""
    from horovod_tpu_torch import kernels
    out = {}
    for lib in ("conv1x1_bn_act_bwd", "conv1x1_bn_bwd"):
        fn = None
        for line in kernels.ptxas_log.get(lib, "").splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                fn = _tf32_label(m.group(1))
                continue
            if fn is None:
                continue
            rec = out.setdefault(f"{lib}:{fn}", {})
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rec["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                rec["spill_stores"] = int(m.group(1))
                rec["spill_loads"] = int(m.group(2))
        tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "cuobjdump")
        if os.path.exists(tool):
            sass = subprocess.run([tool, "-sass", kernels._target(lib)],
                                  capture_output=True, text=True,
                                  timeout=120).stdout
            fn = None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    fn = _tf32_label(m.group(1))
                    continue
                if fn is None:
                    continue
                rec = out.setdefault(f"{lib}:{fn}", {})
                for op in ("HGMMA", "UTMALDG"):
                    if f" {op}." in line or f" {op} " in line:
                        rec[op] = rec.get(op, 0) + 1
    out["max_clusters"] = tf32_dw_waves()
    for name, rec in sorted(out.items()):
        if name == "max_clusters":
            continue
        print(f"tf32 instance {name}: {rec.get('registers')} registers, "
              f"spill stores {rec.get('spill_stores')}, loads "
              f"{rec.get('spill_loads')}; {rec.get('HGMMA', 0)} HGMMA, "
              f"{rec.get('UTMALDG', 0)} UTMALDG")
    kern = {k: v for k, v in out.items() if k != "max_clusters"}
    need(len(kern) == 18, f"not the 18 kernels of the f32 Hopper instance "
         f"(dx at 3 widths, dW at 6 tiles, with and without the mask) in "
         f"the build's ptxas log and SASS: {sorted(kern)}")
    for name, rec in kern.items():
        need(rec.get("spill_stores", 1) == 0 and rec.get("spill_loads", 1)
             == 0, f"{name}: spills ({rec})")
        need(rec.get("HGMMA", 0) > 0 and rec.get("UTMALDG", 0) > 0,
             f"{name}: no wgmma or TMA load in its SASS ({rec})")
    return out


def tf32_dw_waves() -> dict:
    """The clusters of f32 dW blocks the card holds at once
    (cudaOccupancyMaxActiveClusters) by tile and cluster size, and a
    check that at every ResNet-50 site (batch 32) the wrapper's plan
    (`hopper_tf32_dw_plan`) fits in one wave."""
    import ctypes
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    fn = kernels.lib("conv1x1_bn_act_bwd"
                     ).hvd_conv1x1_bn_act_bwd_tf32_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    occ = {(ct, nt, cl): fn(ct, nt, cl) for ct in (64, 128, 256)
           for nt in (64, 128) for cl in (2, 4, 6, 8)}
    print("tf32 dW clusters held at once (tile Cin x C, cluster size): "
          + ", ".join(f"{ct}x{nt}/{cl}: {n}"
                      for (ct, nt, cl), n in occ.items()))
    for m, cin, c in sorted({(m, cin, c) for _, _, m, cin, c in
                             resnet.fused_sites(50, 32, 224)}):
        _, ct, nt = cbb.hopper_tf32_tiles(m, cin, c)
        clusters, _ = cbb.hopper_tf32_dw_plan(m, cin, c)
        cl = cbb.TF32_CLUSTER
        tiles = math.ceil(cin / ct) * math.ceil(c / nt)
        need(tiles * clusters <= occ[(ct, nt, cl)],
             f"f32 dW at {(m, cin, c)}: {tiles * clusters} clusters of {cl}, "
             f"more than the {occ[(ct, nt, cl)]} the card holds at once")
    return {f"{ct}x{nt}/{cl}": n for (ct, nt, cl), n in occ.items()}


# ---------------------------------------------------------------- main path

def _wrappers():
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    from horovod_tpu_torch.ops import flash_attention as fa
    return {"fwd": cb.conv1x1_fwd_fused,
            "act_bwd": cb.conv1x1_bn_act_bwd_fused,
            "bn_bwd": cbb.conv1x1_bn_bwd_fused,
            "attn_fwd": fa.flash_fwd, "attn_dkdv": fa.flash_bwd_dkdv,
            "attn_dq": fa.flash_bwd_dq}


def reset_counters():
    for f in _wrappers().values():
        f.launches = 0


def read_counters():
    return {k: f.launches for k, f in _wrappers().items()}


def drive(sb, model, opt, data, group, warmup, timed):
    """`warmup` + `timed` training steps with the launch counters set to
    0 just before and read just after. Returns (losses, img/s of the
    timed steps, ms/step, counts)."""
    import torch
    reset_counters()
    losses = [sb.train_step(model, opt, data, group) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [sb.train_step(model, opt, data, group) for _ in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counters()
    losses = [float(v) for v in losses]
    need(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    n = data[0].shape[0]
    return losses, n * timed / dt, dt / timed * 1e3, counts


def main_path(batch=32, image=224, depth=50, warmup=2, timed=5):
    """The port's ResNet training path at full width; each route driven
    with the counters read around it."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb

    from horovod_tpu_torch.models import resnet
    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    sites = resnet.fused_sites(depth, batch, image)
    for kernel in ("fwd", "act_bwd"):
        insts = {instance(m, cin, c, torch.bfloat16, kernel)
                 for _, _, m, cin, c in sites}
        need(insts == {"hopper"}, f"kernel {kernel}: the ResNet-{depth} "
             f"sites take {insts}, not only the Hopper instance")
    dev = hvd.device()
    model = sb.build(f"resnet{depth}", torch.bfloat16, dev)
    opt = sb.make_optimizer(model)
    data = sb.make_batch(batch, image, torch.bfloat16, dev, seed=hvd.rank())
    group = dist.group.WORLD
    steps = warmup + timed
    out = {"buckets": len(opt.plan), "world": hvd.size(), "batch": batch}

    losses, ips, ms, counts = drive(sb, model, opt, data, group, warmup,
                                    timed)
    out["block"] = dict(losses=losses, img_per_s=ips, step_ms=ms,
                        launches=counts,
                        per_step={k: v / steps for k, v in counts.items()})
    print(f"main path: ResNet-{depth} {image}² bf16 batch {batch}, "
          f"{hvd.size()} rank(s), {out['buckets']} buckets; losses "
          f"{[round(v, 5) for v in losses]}")
    print(f"main path: {ips:.1f} img/s, {ms:.2f} ms/step; launches per "
          f"step {out['block']['per_step']}")
    need(counts["fwd"] == 28 * steps and counts["act_bwd"] == 28 * steps,
         f"expected 28 + 28 launches per step, got {counts}")
    need(counts["bn_bwd"] == 0 and counts["attn_fwd"] == 0,
         "kernel 3 or a flash kernel ran on the block route")

    # Same weights, fused and unfused route: the step losses must match.
    snap_m = copy.deepcopy(model.state_dict())
    snap_o = copy.deepcopy(opt.state_dict())
    loss_f = sb.train_step(model, opt, data, group).item()
    model.load_state_dict(snap_m)
    opt.load_state_dict(snap_o)
    os.environ["HOROVOD_CONV_BLOCK"] = "0"
    losses, ips, ms, counts = drive(sb, model, opt, data, group, 1, timed)
    loss_u = losses[0]
    rel = abs(loss_f - loss_u) / max(abs(loss_u), 1e-6)
    out["unfused"] = dict(losses=losses, img_per_s=ips, step_ms=ms,
                          launches=counts, loss_fused=loss_f,
                          loss_rel=rel)
    print(f"route check: fused loss {loss_f:.6f}, unfused {loss_u:.6f}, "
          f"relative difference {rel:.3g} (tolerance {TOL_LOSS}); "
          f"unfused route {ips:.1f} img/s, {ms:.2f} ms/step")
    need(sum(counts.values()) == 0, "the unfused route ran a kernel")
    need(rel <= TOL_LOSS, "fused and unfused losses disagree")

    # Kernel 3 on its own path.
    os.environ["HOROVOD_FUSE_CONV_BN"] = "1"
    losses, ips, ms, counts = drive(sb, model, opt, data, group, warmup,
                                    timed)
    out["fuse_bn"] = dict(losses=losses, img_per_s=ips, step_ms=ms,
                          launches=counts)
    print(f"fuse-bn path: {ips:.1f} img/s, {ms:.2f} ms/step; launches "
          f"{counts}")
    need(counts["bn_bwd"] == 28 * steps and counts["fwd"] == 0
         and counts["act_bwd"] == 0,
         f"expected 28 launches of kernel 3 per step, got {counts}")
    return out


def resnet_f32_check(batch=32, image=224, depth=50, timed=3):
    """The f32 ResNet step from the same weights on three routes: the
    block route (kernels 1 and 2 on tf32, every site on kernel 2's f32
    Hopper instance), the fuse_bn route (kernel 3 alone) and the unfused
    route; each route's first loss and launches, then `timed` more steps
    for its ms/step, the first of which gives the loss after one step of
    the route's backward; both losses within TOL_LOSS_F32 of the unfused
    route's."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.models import resnet

    sites = resnet.fused_sites(depth, batch, image)
    for kernel in ("act_bwd", "bn_bwd"):
        insts = {instance(m, cin, c, torch.float32, kernel)
                 for _, _, m, cin, c in sites}
        need(insts == {"hopper_tf32"}, f"kernel {kernel}: the f32 "
             f"ResNet-{depth} sites take {insts}, not only the f32 Hopper "
             f"instance")
    dev, group = hvd.device(), dist.group.WORLD
    model = sb.build(f"resnet{depth}", torch.float32, dev)
    opt = sb.make_optimizer(model)
    data = sb.make_batch(batch, image, torch.float32, dev, seed=hvd.rank())
    snap_m = copy.deepcopy(model.state_dict())
    snap_o = copy.deepcopy(opt.state_dict())
    out = {}
    for route, block, fuse in (("block", "1", "0"), ("fuse_bn", "0", "1"),
                               ("unfused", "0", "0")):
        os.environ["HOROVOD_CONV_BLOCK"] = block
        os.environ["HOROVOD_FUSE_CONV_BN"] = fuse
        model.load_state_dict(snap_m)
        opt.load_state_dict(snap_o)
        reset_counters()
        out[route] = sb.train_step(model, opt, data, group).item()
        out[route + "_launches"] = read_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [sb.train_step(model, opt, data, group)
                  for _ in range(timed)]
        torch.cuda.synchronize()
        out[route + "_step_ms"] = (time.perf_counter() - t0) / timed * 1e3
        # the loss after one step: it has run the route's backward
        out[route + "_second"] = float(losses[0])
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    for route in ("block", "fuse_bn"):
        rel, rel2 = (abs(out[route + k] - out["unfused" + k])
                     / max(abs(out["unfused" + k]), 1e-6)
                     for k in ("", "_second"))
        out[route + "_loss_rel"], out[route + "_second_rel"] = rel, rel2
        print(f"f32 route check: {route} losses {out[route]:.6f}, "
              f"{out[route + '_second']:.6f} (launches "
              f"{out[route + '_launches']}), unfused {out['unfused']:.6f}, "
              f"{out['unfused_second']:.6f}, relative differences {rel:.3g}, "
              f"{rel2:.3g} (tolerance {TOL_LOSS_F32}); "
              f"{out[route + '_step_ms']:.2f} ms/step against unfused "
              f"{out['unfused_step_ms']:.2f}")
        need(math.isfinite(out[route]) and math.isfinite(
            out[route + "_second"]), f"non-finite f32 {route} loss")
        need(rel <= TOL_LOSS_F32 and rel2 <= TOL_LOSS_F32,
             f"f32 {route} and unfused losses disagree")
    out["loss_rel"] = out["block_loss_rel"]
    bl, fl = out["block_launches"], out["fuse_bn_launches"]
    need(bl["fwd"] == 28 and bl["act_bwd"] == 28 and bl["bn_bwd"] == 0,
         f"f32 block route: expected 28 + 28 launches, got {bl}")
    need(fl["bn_bwd"] == 28 and fl["fwd"] == 0 and fl["act_bwd"] == 0,
         f"f32 fuse_bn route: expected 28 launches of kernel 3, got {fl}")
    need(sum(out["unfused_launches"].values()) == 0,
         "the unfused route ran a kernel")
    return out


C13_RUNS = 5                # backward passes from one state
TIED_SHAPES = {"tests": (dict(vocab=256, d_model=32, d_ff=64, n_layers=2),
                         8, 16),
               "canonical": (dict(vocab=8192, d_model=512, d_ff=2048,
                                  n_layers=2), 64, 64)}


def lm_determinism_check(runs=C13_RUNS) -> dict:
    """Fault C13 on the card: do the LMs' embedding and loss backward
    passes sum in a run-to-run order? Phase 5's flagship LM (seed-0
    weights, its batch with every other token drawn from 64 ids, so each
    of those embedding rows is looked up ~96 times) runs `runs` backward
    passes of transformer.loss_fn from the same parameters, no optimizer
    step; the embed and unembed gradients must be bit-identical. The
    same for the tied LM's global_loss at the shapes its tests use and
    at the canonical shapes (emb's gradient: the lookup and the tied
    unembedding). Bit-identical gradients mean CUDA's index_put_ with
    accumulate (sorted) and the target gather's scatter_add_ (one index a
    row) are no HVD504 hazard (analysis/graph.py ATOMIC_OPS)."""
    import torch
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import tied_lm
    from horovod_tpu_torch.models import transformer as tfm
    dev = torch.device("cuda", 0)
    out = {}
    cfg = tfm.TransformerConfig(**lm.FLAGSHIP, attn="flash",
                                dtype=torch.bfloat16)
    model = tfm.TransformerLM(cfg, seed=0, device=dev)
    tokens, _ = lm.make_batch(lm.FLAGSHIP_BATCH, cfg.max_seq, cfg.vocab, dev,
                              seed=0)
    tokens[:, ::2] %= 64
    targets = torch.roll(tokens, -1, dims=1)
    grads = []
    for _ in range(runs):
        model.zero_grad(set_to_none=True)
        tfm.loss_fn(model, tokens, targets).backward()
        grads.append((model.embed.grad.clone(), model.unembed.grad.clone()))
    torch.cuda.synchronize()
    same = [all(bool(torch.equal(a, b)) for a, b in zip(grads[0], g))
            for g in grads[1:]]
    out["flagship"] = dict(runs=runs, distinct_tokens=int(
        tokens.unique().numel()), tokens=tokens.numel(),
        bit_identical=all(same))
    print(f"C13 flagship LM (L{cfg.n_layers} D{cfg.d_model} V{cfg.vocab} "
          f"B{tokens.shape[0]} S{tokens.shape[1]} bf16): {runs} backward "
          f"passes from one state, {out['flagship']['distinct_tokens']} "
          f"distinct of {tokens.numel()} tokens; embed and unembed "
          f"gradients bit-identical to the first: {same}")
    del model, grads
    torch.cuda.empty_cache()
    for label, (kw, batch, seq) in TIED_SHAPES.items():
        tcfg = tied_lm.TiedLMConfig(**kw)
        params = tied_lm.init(0, tcfg, device=dev)
        emb = params["emb"].requires_grad_(True)
        tok, tgt = tied_lm.sample_batch(1, tcfg, batch=batch, seq=seq,
                                        device=dev)
        gs = [torch.autograd.grad(
            tied_lm.global_loss(params, tok, tgt, tcfg), emb)[0]
            for _ in range(runs)]
        torch.cuda.synchronize()
        tsame = [bool(torch.equal(gs[0], g)) for g in gs[1:]]
        out["tied_" + label] = dict(runs=runs, bit_identical=all(tsame),
                                    distinct_tokens=int(tok.unique().numel()),
                                    tokens=tok.numel())
        print(f"C13 tied LM global_loss ({label}: V{tcfg.vocab} "
              f"D{tcfg.d_model} B{batch} S{seq} f32): {runs} backward passes, "
              f"{int(tok.unique().numel())} distinct of {tok.numel()} tokens; "
              f"emb gradients bit-identical to the first: {tsame}")
    need(all(v["bit_identical"] for v in out.values()),
         "C13: an LM's embedding or loss gradient differs between backward "
         "passes from one state (graph.py ATOMIC_OPS says it cannot)")
    return out


def lm_path(warmup=2, timed=5):
    """The transformer LM at the bench's flagship width and batch
    (transformer_lm.FLAGSHIP) through transformer_lm.build and its step,
    attn="flash", the counters read around 2 warm-up + 5 timed steps;
    then one step from the same weights with attn="local"."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm

    from horovod_tpu_torch.ops import flash_attention as fa
    cfg = tfm.TransformerConfig(**lm.FLAGSHIP, attn="flash",
                                dtype=torch.bfloat16)
    batch, seq = lm.FLAGSHIP_BATCH, cfg.max_seq
    dh = cfg.d_model // cfg.n_heads
    need(fa.flash_instance(torch.bfloat16, dh) == "hopper",
         f"the LM's head dim {dh} does not take the flash kernels' Hopper "
         f"instances")
    dev = hvd.device()
    model, opt, step = lm.build(cfg, dev)
    data = lm.make_batch(batch, seq, cfg.vocab, dev, seed=hvd.rank())
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    losses = [step(data) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(data) for _ in range(timed)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    counts = read_counters()
    losses = [float(v) for v in losses]
    steps = warmup + timed
    r = lm.report(cfg, batch, seq, dt, torch.cuda.get_device_name(dev))
    out = dict(losses=losses, launches=counts, buckets=len(opt.plan),
               per_step={k: v / steps for k, v in counts.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, **r)
    print(f"LM path: L{cfg.n_layers} D{cfg.d_model} F{cfg.d_ff} "
          f"H{cfg.n_heads} S{seq} B{batch} V{cfg.vocab} bf16, "
          f"{hvd.size()} rank(s), {out['buckets']} buckets; losses "
          f"{[round(v, 5) for v in losses]}")
    print(f"LM path: {r['tokens_per_s']:.1f} tokens/s, {r['step_ms']:.2f} "
          f"ms/step, model-FLOPs share of peak {r['mfu']:.4f}, peak memory "
          f"{out['peak_mem_gb']:.1f} GB; launches per step "
          f"{out['per_step']}")
    need(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    n = cfg.n_layers * steps
    need(counts["attn_fwd"] == n and counts["attn_dkdv"] == n
         and counts["attn_dq"] == n,
         f"expected {cfg.n_layers} launches of kernels 4, 5, 6 per step, "
         f"got {counts}")

    snap_m = copy.deepcopy(model.state_dict())
    snap_o = copy.deepcopy(opt.state_dict())
    loss_f = step(data).item()
    model.load_state_dict(snap_m)
    opt.load_state_dict(snap_o)
    del snap_m, snap_o
    model.cfg = dataclasses.replace(cfg, attn="local")
    reset_counters()
    loss_l = step(data).item()
    counts_l = read_counters()
    rel = abs(loss_f - loss_l) / max(abs(loss_l), 1e-6)
    out.update(loss_flash=loss_f, loss_local=loss_l, loss_rel=rel,
               launches_local=counts_l)
    print(f"LM attention check: flash loss {loss_f:.6f}, local "
          f"{loss_l:.6f}, relative difference {rel:.3g} (tolerance "
          f"{TOL_LM_LOSS})")
    need(sum(counts_l.values()) == 0, "the local-attention step ran a kernel")
    need(rel <= TOL_LM_LOSS, "flash and local LM losses disagree")
    return out


def run_bounded(cmd, timeout, env=None):
    """Run `cmd` from the repo root in its own session; returns (exit
    code, stdout + stderr). Past `timeout` it gets SIGTERM (the launcher
    and the scaling report then terminate their workers' process
    groups), then its group SIGKILL, and the phase fails."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
        raise Failed(f"{' '.join(cmd)}: still running after {timeout} s; "
                     f"its output's end:\n{(out or '')[-4000:]}")
    return proc.returncode, out


def launched_path(block_loss: float, phase4_ms: float):
    """Phase 6: the launcher, `runner.run` and the scaling report drive
    the ResNet-50 main path on the card in worker processes."""
    import torch
    from horovod_tpu_torch import kernels, runner
    from horovod_tpu_torch import synthetic_benchmark as sb
    py = sys.executable
    card = torch.cuda.get_device_name(0)
    block_env = {"HOROVOD_CONV_BLOCK": "1", "HOROVOD_FUSE_CONV_BN": "0"}
    out = {"seconds": {}}
    t_last = [time.perf_counter()]

    def took(step):
        """Wall seconds since the last step of this phase ended."""
        now = time.perf_counter()
        out["seconds"][step] = now - t_last[0]
        t_last[0] = now
        return out["seconds"][step]

    rc, text = run_bounded([py, "-m", "horovod_tpu_torch.runner.launch",
                            "--check-build"], 120)
    print("\n".join("check-build: " + ln for ln in text.splitlines()
                    if ln.strip()))
    need(rc == 0, f"--check-build exited {rc}")
    need(card in text, "--check-build does not name the card")
    for name in kernels.SOURCES:
        need(f"[X] {name} built" in text,
             f"--check-build does not show kernel {name} built")
    print(f"check-build: {took('check_build'):.1f} s")

    log_dir = os.path.join("chiprun_out", "launch")
    rc, text = run_bounded(
        [py, "-m", "horovod_tpu_torch.runner.launch", "-np", "1",
         "--output-filename", log_dir, py, "-m",
         "horovod_tpu_torch.synthetic_benchmark", "--batch-size", "32",
         "--num-iters", "2"], 600, env=dict(os.environ, **block_env))
    print("\n".join("launch: " + ln for ln in text.splitlines()
                    if "<stdout>:" in ln or "horovodrun" in ln))
    need(rc == 0, f"the launched benchmark exited {rc}")
    lines = [ln for ln in text.splitlines() if ln.startswith("[0]<stdout>: ")]
    need(any("Model: resnet50" in ln and card in ln for ln in lines),
         "the launched worker does not name the card")
    world = [ln for ln in lines if "World: 1 rank(s) joined over tcp://"
             in ln and "(nccl)" in ln]
    need(bool(world), "the launched worker did not join NCCL over the "
         "launcher's tcp:// coordinator")
    rate = [float(ln.rsplit(":", 1)[1]) for ln in lines
            if "Img/sec per rank:" in ln]
    need(len(rate) == 1 and rate[0] > 0, "no Img/sec per rank figure")
    out["launched"] = dict(img_per_s=rate[0], step_ms=32e3 / rate[0],
                           world=world[0], log_dir=log_dir)
    print(f"launched path: {rate[0]:.1f} img/s per rank, "
          f"{32e3 / rate[0]:.2f} ms/step (phase 4 in-process: "
          f"{phase4_ms:.2f} ms/step); {took('launch'):.1f} s")

    res = runner.run(sb.first_step, np=1, extra_env=block_env,
                     timeout=600)[0]
    rel = abs(res["loss"] - block_loss) / max(abs(block_loss), 1e-6)
    out["run"] = dict(res, loss_phase4=block_loss, loss_rel=rel)
    print(f"runner.run: first loss {res['loss']:.6f} on {res['device']} "
          f"over {res['rendezvous']}, phase 4's {block_loss:.6f}, relative "
          f"difference {rel:.3g} (tolerance {TOL_LAUNCHED_LOSS}); launches "
          f"{res['launches']}; {took('run'):.1f} s")
    need(res["device"] == card, "runner.run's worker ran elsewhere")
    need(res["launches"] == {"fwd": 28, "act_bwd": 28},
         f"runner.run's step: expected 28 + 28 launches, got "
         f"{res['launches']}")
    need(rel <= TOL_LAUNCHED_LOSS, "the launched and in-process losses "
         "disagree")

    report_cmd = [py, "-m", "horovod_tpu_torch.synthetic_benchmark",
                  "--batch-size", "32", "--num-warmup-batches", "2",
                  "--num-iters", "2", "--scaling-report"]
    rc, text = run_bounded(report_cmd + ["1"], 600,
                           env=dict(os.environ, **block_env))
    print("\n".join("scaling: " + ln for ln in text.splitlines()
                    if "<stdout>:" in ln or ln.startswith("{")))
    need(rc == 0, f"--scaling-report 1 exited {rc}")
    worlds = [ln for ln in text.splitlines() if "<stdout>: Model:" in ln]
    need(len(worlds) == 2 and all(card in ln for ln in worlds),
         "--scaling-report 1: both worlds must run on the card")
    report = json.loads(text.strip().splitlines()[-1])
    need(list(report) == SCALING_KEYS and report["n"] == 1
         and report["ips_1chip"] > 0, f"--scaling-report 1: {report}")
    out["scaling_report_1"] = report
    print(f"scaling: --scaling-report 1 {took('scaling_report_1'):.1f} s")
    rc, text = run_bounded(report_cmd + ["2"], 120)
    refusal = "--scaling-report 2 needs 2 GPUs, have 1 visible"
    print(f"scaling: --scaling-report 2 exited {rc}: {text.strip()} "
          f"({took('scaling_report_2'):.1f} s)")
    need(rc != 0 and refusal in text, "--scaling-report 2 was not refused "
         "on one card")
    out["scaling_report_2"] = dict(rc=rc, message=text.strip())
    return out


PHASE7_ENV = {"HOROVOD_DYNAMIC_PROCESS_SETS": "1",
              "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
              "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}


def one_card_ops(dev):
    """Every collective of ops/collectives.py on CUDA tensors in bf16, f32
    and int32 in a world of 1, each against what the JAX package's
    semantics give at k = 1 (bit for bit): Min, Max, Product and Adasum are x itself
    through allreduce and grouped_allreduce; allgather, reducescatter
    (Sum; Average divides by 1, an int32 tensor coming back float32, as
    `/` gives in the JAX package), alltoall with splits [n], broadcast
    and the hierarchical allreduce and allgather (groups of one rank)
    give x back; a set [0] added and removed; DuplicateNameError on a
    reused async name."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology
    g = torch.Generator(device=dev).manual_seed(7)
    cases = 0

    def same(what, got, want):
        nonlocal cases
        need(got.is_cuda, f"{what}: result left the card")
        need(got.dtype == want.dtype and torch.equal(got, want),
             f"{what}: {got.dtype} result differs from k = 1's "
             f"{want.dtype} one")
        cases += 1

    cfg = topology.config()
    for dt in (torch.bfloat16, torch.float32, torch.int32):
        if dt == torch.int32:
            x = torch.randint(-9, 10, (4099, 3), generator=g, device=dev,
                              dtype=dt)
        else:
            x = torch.randn(4099, 3, generator=g, device=dev).to(dt)
        x2 = x[:7, 0].clone()
        for op in (hvd.Min, hvd.Max, hvd.Product, hvd.Adasum):
            same(f"allreduce {op.name} {dt}", hvd.allreduce(x, op=op), x)
            a, b = hvd.grouped_allreduce([x, x2], op=op)
            same(f"grouped_allreduce {op.name} {dt}", a, x)
            same(f"grouped_allreduce {op.name} {dt}", b, x2)
        same(f"allgather {dt}", hvd.allgather(x), x)
        same(f"reducescatter Sum {dt}", hvd.reducescatter(x, op=hvd.Sum), x)
        avg = x.float() if dt == torch.int32 else x
        same(f"reducescatter Average {dt}", hvd.reducescatter(x), avg)
        y, recv = hvd.alltoall(x, splits=[x.shape[0]])
        same(f"alltoall {dt}", y, x)
        need(recv.tolist() == [x.shape[0]], "alltoall received splits")
        same(f"broadcast {dt}", hvd.broadcast(x, 0), x)
        need(cfg.hierarchical_allreduce and topology.hier() is not None,
             "hierarchical mode's groups were not built")
        same(f"hierarchical allreduce {dt}", hvd.allreduce(x, op=hvd.Sum), x)
        same(f"hierarchical allgather {dt}", hvd.allgather(x), x)
        ps = hvd.add_process_set([0])
        same(f"allreduce over set [0] {dt}",
             hvd.allreduce(x, op=hvd.Sum, process_set=ps), x)
        hvd.remove_process_set(ps)
        h = hvd.allreduce_async(x, name="phase7")
        try:
            hvd.allreduce_async(x, name="phase7")
            raise Failed("a reused async name was not refused")
        except hvd.DuplicateNameError:
            pass
        same(f"named async allreduce {dt}", hvd.synchronize(h), x)
    return cases


def collectives_path():
    """Phase 7: the eager collectives on NCCL. One card: every op
    in a world of 1 (one_card_ops, then collective_bench.check against
    numpy), and the flat allreduce of ResNet-50's gradient values in bf16
    timed (device ms from the profiler, host ms of call plus synchronize).
    Two or more cards: a world of min(4, count) through runner.run, every
    op against numpy (sets {0, 2} and {0, 1, 2}, uneven allgather,
    reducescatter and alltoall, hierarchical against flat under
    HOROVOD_TPU_MESH_SHAPE=2x2 at 4), then the bus GB/s of the flat and
    hierarchical allreduce, allgather and alltoall on the same values."""
    import functools
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective_bench as cb, runner
    out = {}
    saved = {k: os.environ.get(k) for k in PHASE7_ENV}
    os.environ.update(PHASE7_ENV)
    hvd.init()
    try:
        dev = hvd.device()
        need(dev.type == "cuda", "phase 7 is not on the card")
        out["one_card_cases"] = one_card_ops(dev)
        out["check_k1"] = cb.check(dev)
        from horovod_tpu_torch.core import topology
        topology.config().hierarchical_allreduce = False
        x = torch.randn(cb.RESNET50_GRAD_VALUES, device=dev).to(
            torch.bfloat16)

        def call():
            return hvd.allreduce(x, op=hvd.Sum)

        dev_ms = device_ms(call)
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        need(torch.equal(call(), x), "the flat allreduce at k = 1 changed x")
        out["allreduce_flat_k1"] = dict(values=cb.RESNET50_GRAD_VALUES,
                                        device_ms=dev_ms, host_ms=host_ms)
    finally:
        hvd.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"collectives: {out['one_card_cases']} one-card cases and "
          f"{len(out['check_k1'])} numpy checks equal on "
          f"{torch.cuda.get_device_name(0)}; flat allreduce of "
          f"{cb.RESNET50_GRAD_VALUES} bf16 values at k = 1: device "
          f"{dev_ms:.4f} ms, host {host_ms:.4f} ms")
    n = min(4, torch.cuda.device_count())
    if n < 2:
        print("collectives: the multi-rank checks and bus GB/s need at "
              "least two cards; 1 is present")
        return out
    env = dict(PHASE7_ENV)
    if n == 4:
        env["HOROVOD_TPU_MESH_SHAPE"] = "2x2"
    res = cb.summarize(runner.run(functools.partial(cb.worker, None),
                                  np=n, extra_env=env, timeout=600))
    need(res["size"] == n and res["device"] == torch.cuda.get_device_name(0),
         f"the {n}-rank world ran elsewhere: {res['device']}")
    need(n != 4 or res["hier"] == [2, 2], f"split {res['hier']}, not 2x2")
    out[f"world_{n}"] = res
    print(f"collectives: {n} ranks, split {res['hier']}, "
          f"{len(res['check_max_err'])} numpy checks passed")
    for name, b in res["bench"].items():
        if isinstance(b, dict):
            lib = "none" if b["library_ms"] is None \
                else f"{b['library_ms']:.4f} ms"
            print(f"collectives: {name} of {res['bench']['values']} bf16 "
                  f"values over {n} cards: {b['ms']:.4f} ms, bus "
                  f"{b['bus_gb_s']:.2f} GB/s; one library call {lib}")
    print(f"collectives: allgather's size exchange "
          f"{res['bench']['size_exchange_ms']:.4f} ms")
    return out


def _launched(cmd, env, timeout=600):
    """Run a launcher command; its rank 0's stdout lines."""
    rc, text = run_bounded(cmd, timeout, env=dict(os.environ, **env))
    lines = [ln[len("[0]<stdout>: "):] for ln in text.splitlines()
             if ln.startswith("[0]<stdout>: ")]
    need(rc == 0, f"{' '.join(cmd[:6])}... exited {rc}:\n{text[-3000:]}")
    need("All losses finite: True" in lines,
         "a launched step's loss was not finite")
    return lines


def autotune_runs():
    """The synthetic benchmark through the launcher under each tuner."""
    py = sys.executable
    bench = ["--", py, "-m", "horovod_tpu_torch.synthetic_benchmark",
             "--batch-size", "32", "--num-warmup-batches", "2",
             "--num-batches-per-iter", "5", "--num-iters", "6"]
    block_env = {"HOROVOD_CONV_BLOCK": "1", "HOROVOD_FUSE_CONV_BN": "0"}
    out = {}
    t0 = time.perf_counter()
    lines = _launched([py, "-m", "horovod_tpu_torch.runner.launch", "-np",
                       "1", "--autotune", "--autotune-warmup-samples", "1",
                       "--autotune-steps-per-sample", "2",
                       "--autotune-bayes-opt-max-samples", "3"] + bench,
                      block_env)
    samples = [ln for ln in lines if ln.startswith("Autotune sample:")]
    frozen = [ln for ln in lines if ln.startswith("Autotune frozen:")]
    for ln in samples + frozen:
        print(f"autotune: {ln}")
    need(len(samples) == 5, f"{len(samples)} scored samples, not 3 + the "
         f"two playoff windows")
    need(len(frozen) == 1, "the ParameterManager did not freeze")
    out["autotune"] = dict(samples=samples, frozen=frozen[0],
                           seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    lines = _launched([py, "-m", "horovod_tpu_torch.runner.launch", "-np",
                       "1"] + bench, dict(block_env,
                                          HOROVOD_BUCKET_AUTOTUNE="1",
                                          HOROVOD_BUCKET_AUTOTUNE_INTERVAL="2"))
    decisions = [ln for ln in lines if ln.startswith(
        "Bucket autotune decision")]
    frozen = [ln for ln in lines if ln.startswith("Bucket autotune frozen:")]
    for ln in decisions + frozen:
        print(f"bucket autotune: {ln}")
    need(len(frozen) == 1, "the OnlineBucketTuner did not freeze")
    out["bucket_autotune"] = dict(decisions=decisions, frozen=frozen[0],
                                  seconds=time.perf_counter() - t0)
    return out


def training_api_path(steps=3, timed=10):
    """Phase 8: the rest of DistributedOptimizer, the object helpers and
    the tuners on the ResNet-50 main path (one card); with two or more,
    the numpy checks of a world of min(4, count)."""
    import functools
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import runner
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.optim import world_check

    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi, "routes": {}}
    hvd.init()
    try:
        dev, group = hvd.device(), dist.group.WORLD
        need(dev.type == "cuda", "phase 8 is not on the card")
        model = sb.build("resnet50", torch.bfloat16, dev)
        data = sb.make_batch(32, 224, torch.bfloat16, dev, seed=0)
        snap = copy.deepcopy(model.state_dict())
        n_params = len(list(model.parameters()))

        def route(name, n_timed=0, **kw):
            model.load_state_dict(snap)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
                named_parameters=model.named_parameters(), **kw)
            reset_counters()
            losses = [sb.train_step(model, opt, data, group)
                      for _ in range(steps)]
            torch.cuda.synchronize()
            counts = read_counters()
            losses = [float(v) for v in losses]
            r = dict(losses=losses, hooked=opt.hooked, buckets=len(opt.plan),
                     collectives_per_step=opt.collectives_per_step,
                     launches={k: counts[k] for k in ("fwd", "act_bwd")})
            need(all(math.isfinite(v) for v in losses),
                 f"{name}: non-finite loss {losses}")
            need(counts["fwd"] == 28 * steps and
                 counts["act_bwd"] == 28 * steps,
                 f"{name}: expected 28 + 28 launches a step, got {counts}")
            if n_timed:
                t0 = time.perf_counter()
                for _ in range(n_timed):
                    sb.train_step(model, opt, data, group)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                r.update(img_per_s=32 * n_timed / dt,
                         step_ms=dt / n_timed * 1e3)
            out["routes"][name] = r
            # the next route's optimizer wraps the same parameters
            for h in getattr(opt, "_hooks", ()):
                h.remove()
            rate = f", {r['img_per_s']:.1f} img/s" if n_timed else ""
            print(f"training API: {name}: losses {losses}, "
                  f"{'hook' if opt.hooked else 'step-time'} path, "
                  f"{r['collectives_per_step']} collective call(s) a step"
                  f"{rate}")
            return opt

        opt_avg = route("Average", timed)
        need(out["routes"]["Average"]["buckets"] == 18,
             "the Average hook path does not plan ResNet-50's 18 buckets")
        route("Average again")
        for op in ("Sum", "Adasum", "Min", "Max", "Product"):
            route(op, timed if op == "Adasum" else 0, op=op)
        route("groups=4", timed, groups=4)
        route("predivide 4", gradient_predivide_factor=4.0)
        avg = out["routes"]["Average"]["losses"]
        for name in ("Average again", "Sum", "Adasum", "Min", "Max",
                     "Product", "groups=4"):
            got = out["routes"][name]["losses"]
            need(got == avg, f"{name}: losses {got} differ from Average's "
                 f"{avg} at k = 1")
        ada = out["routes"]["Adasum"]
        need(not ada["hooked"] and ada["collectives_per_step"] == n_params,
             f"Adasum: {ada['collectives_per_step']} calls a step, not one "
             f"per parameter ({n_params})")
        need(not out["routes"]["groups=4"]["hooked"],
             "groups=4 rode the hook path")
        pre = out["routes"]["predivide 4"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(pre, avg))
        out["predivide_rel"] = rel
        print(f"training API: predivide 4 against Average: largest "
              f"relative loss difference {rel:.3g} (tolerance "
              f"{TOL_PREDIVIDE})")
        need(rel <= TOL_PREDIVIDE, "predivide 4 disagrees with Average")

        # backward_passes_per_step 2 against two gradients taken with no
        # optimizer, from the same weights.
        model.load_state_dict(snap)
        params = list(model.parameters())
        w0 = [p.detach().clone() for p in params]
        batches = [data, sb.make_batch(32, 224, torch.bfloat16, dev,
                                       seed=1)]
        grads = []
        for b in batches:
            model.zero_grad(set_to_none=True)
            resnet.loss_fn(model, b, train=True, group=group)[0].backward()
            grads.append([p.grad.detach().float() for p in params])
        model.zero_grad(set_to_none=True)
        lr = 0.1
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=lr),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=2)
        rets = []
        for b in batches:
            loss = resnet.loss_fn(model, b, train=True, group=group)[0]
            loss.backward()
            rets.append(opt.step(lambda: loss))
            if len(rets) == 1:
                need(rets[0] is None, "bpps 2: the first step() returned "
                     "a value")
                need(all(torch.equal(p, w) for p, w in zip(params, w0)),
                     "bpps 2: the first step() moved a parameter")
        need(rets[1] is not None, "bpps 2: the second step() applied "
             "nothing")
        # bf16 rounds g1 + g2 as it accumulates, then lr times it, then
        # the update, each by at most 2^-8 of its magnitude: the
        # tolerance is one bf16 step (2^-7) of |update| and of |w|.
        worst = 0.0
        for p, w, g1, g2 in zip(params, w0, *grads):
            g = g1 + g2
            want = w.float() - lr * g
            tol = 2.0 ** -7 * (want.abs() + lr * g.abs()) + 1e-30
            worst = max(worst, float(
                ((p.detach().float() - want).abs() / tol).max()))
        out["bpps_worst_over_tol"] = worst
        print(f"training API: bpps 2: first step() None, no parameter "
              f"moved; after the second, |Δ| ≤ {worst:.3f} of the "
              f"tolerance (one bf16 step of each term)")
        need(worst <= 1.0, "bpps 2: the update is not -lr·(g1 + g2)")
        n_timed = 2 * timed
        t0 = time.perf_counter()
        for i in range(n_timed):
            if i % 2 == 0:
                opt.zero_grad()
            loss, stats = resnet.loss_fn(model, data, train=True,
                                         group=group)
            loss.backward()
            opt.step()
            model.set_stats(stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["routes"]["bpps 2"] = dict(img_per_s=32 * n_timed / dt,
                                       pass_ms=dt / n_timed * 1e3)
        print(f"training API: bpps 2: {32 * n_timed / dt:.1f} img/s")

        # Fault C5 on the card, and the object helpers.
        state = {id(p): s["momentum_buffer"].clone()
                 for p, s in opt_avg.state.items()}
        need(len(state) == n_params, "the Average route holds no momentum")
        hvd.broadcast_optimizer_state(opt_avg)
        fresh = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        fresh.load_state_dict(hvd.broadcast_object(opt_avg.state_dict()))
        for o in (opt_avg, fresh):
            need(len(o.state) == n_params, "C5: state entries lost")
            for p, s in o.state.items():
                buf = s["momentum_buffer"]
                need(buf.device == p.device and
                     torch.equal(buf, state[id(p)]),
                     "C5: a momentum buffer differs or left the card")
        obj = {"t": torch.arange(7, device=dev), "tag": "phase 8"}
        got = hvd.broadcast_object(obj)
        gathered = hvd.allgather_object(obj)
        need(got["t"].is_cuda and torch.equal(got["t"], obj["t"])
             and len(gathered) == 1 and torch.equal(gathered[0]["t"],
                                                    obj["t"]),
             "broadcast_object/allgather_object did not round-trip")
        print(f"training API: C5: {n_params} momentum buffers equal on the "
              f"card after broadcast_optimizer_state and in a fresh "
              f"optimizer; object round trips with a CUDA tensor equal")

        # A sparse gradient against sparse_as_dense.
        g = torch.Generator(device=dev).manual_seed(0)
        idx = torch.randint(0, 10000, (32 * 20,), generator=g, device=dev)
        offsets = torch.arange(0, 32 * 20, 20, device=dev)
        labels = torch.randint(0, 10, (32,), generator=g, device=dev)
        w_emb = torch.randn(10000, 64, generator=g, device=dev) * 0.1
        w_head = torch.randn(10, 64, generator=g, device=dev) * 0.1
        final = {}
        for dense in (False, True):
            emb = torch.nn.EmbeddingBag(10000, 64, sparse=True, device=dev)
            head = torch.nn.Linear(64, 10, device=dev)
            with torch.no_grad():
                emb.weight.copy_(w_emb)
                head.weight.copy_(w_head)
                head.bias.zero_()
            sopt = hvd.DistributedOptimizer(
                torch.optim.SGD([emb.weight, head.weight, head.bias],
                                lr=0.1), sparse_as_dense=dense)
            for _ in range(3):
                sopt.zero_grad()
                torch.nn.functional.cross_entropy(
                    head(emb(idx, offsets)), labels).backward()
                need(dense or emb.weight.grad.is_sparse,
                     "the embedding's gradient is not sparse")
                sopt.step()
            final[dense] = [emb.weight.detach(), head.weight.detach()]
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(final[False], final[True]))
        out["sparse_rel"] = err
        print(f"training API: EmbeddingBag(10000, 64, sparse=True), 3 "
              f"steps: sparse against sparse_as_dense {err:.3g} of the "
              f"largest weight (tolerance {TOL_SPARSE})")
        need(err <= TOL_SPARSE, "sparse and sparse_as_dense disagree")
    finally:
        hvd.shutdown()
        cudnn.deterministic, cudnn.benchmark = saved
    rates = {k: round(r["img_per_s"], 1) for k, r in out["routes"].items()
             if "img_per_s" in r}
    print(f"training API: img/s {rates} on {smi}")

    out.update(autotune_runs())
    n = min(4, torch.cuda.device_count())
    if n < 2:
        print("training API: the multi-rank checks need at least two "
              "cards; 1 is present")
        return out
    res = runner.run(functools.partial(world_check.worker, None), np=n,
                     timeout=600)
    need(all(r["size"] == n for r in res) and
         all(r["tuner"] == res[0]["tuner"] for r in res),
         f"the {n}-rank world disagrees: {res}")
    out[f"world_{n}"] = res[0]
    print(f"training API: {n} ranks: every op against numpy "
          f"{ {k: v['max_abs_err'] for k, v in res[0]['ops'].items()} }, "
          f"join {res[0]['join']}, tuner {res[0]['tuner']}")
    return out


# Phase 9's bars. The always-on scope's phases sum to the step's wall by
# construction; 0.99 leaves room for float sums over ten steps and
# nothing else. A prefetched feed's get returns a staged batch (its
# copy ran on the side stream during the step before), so under 5% of
# the step waits; the synchronous feed of a source that sleeps
# SOURCE_SLEEP_S a batch parks all of that sleep, and its copy, in
# input_wait, so a starved step's input_wait is at least the sleep. The
# bar is in seconds, not a share of the step: the step's host dispatch
# (0.09-0.22 s on H100 hosts) sets the share, not the attribution.
MIN_COVERAGE = 0.99
MAX_INPUT_WAIT_FED = 0.05
SOURCE_SLEEP_S = 0.05
# device_profile's "hvd kernel" category against phase 2's kernel 1 + 2
# times per step: inside a step the kernels run between other kernels on
# a cold L2, where phase 2 runs them back to back; PRs 4, 5 and 8 read
# kernel 2 between 2.749 and 2.986 ms a step in separate calls.
TOL_KERNEL_CATEGORY = 0.30


def observed_path(k12_ms: float, steps: int = 10):
    """Phase 9: the input pipeline and the profilers on the ResNet-50
    main path (224², bf16, batch 32, block route): DeviceFeed against
    direct copies; perfscope over `steps` steps of the hook path, fed
    and starved; the timeline and NVTX around 3 steps; device_profile's
    categories against kernels 1 + 2 (`k12_ms`, phase 2); the host cost
    of the always-on scope; then the launcher with --timeline-filename
    and HOROVOD_FLIGHT_DIR."""
    import itertools
    import threading
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.data import DeviceFeed
    from horovod_tpu_torch.profiler import device_profile, perfscope
    from horovod_tpu_torch.profiler import flops as F
    from horovod_tpu_torch.profiler.timeline import recover_trace

    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    out_dir = os.path.abspath(os.path.join("chiprun_out", "observe"))
    os.makedirs(out_dir, exist_ok=True)
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    out = {}
    hvd.init()
    try:
        dev, group = hvd.device(), dist.group.WORLD
        need(dev.type == "cuda", "phase 9 is not on the card")
        model = sb.build("resnet50", torch.bfloat16, dev)
        snap = copy.deepcopy(model.state_dict())
        # Host batches: phase 4's batch (seed 0) and three more.
        host = [tuple(t.cpu() for t in sb.make_batch(32, 224, torch.bfloat16,
                                                     dev, seed=s))
                for s in range(4)]
        opts = []

        def fresh_opt():
            """The hook path from the seed-0 weights; the last
            optimizer's hooks removed (they stack on the parameters)."""
            for o in opts:
                for h in o._hooks:
                    h.remove()
            model.load_state_dict(snap)
            opts.append(sb.make_optimizer(model))
            return opts[-1]

        # 1. DeviceFeed against direct copies.
        feed = DeviceFeed(iter(host))
        staged = list(feed)
        need(feed.close(), "the feed's producer did not exit")
        need(len(staged) == len(host) and all(
            b[0].device == dev and torch.equal(b[0].cpu(), h[0])
            and torch.equal(b[1].cpu(), h[1])
            for b, h in zip(staged, host)),
            "a DeviceFeed batch differs from its host copy")
        cudnn.deterministic, cudnn.benchmark = True, False
        losses = {}
        for how in ("direct", "feed"):
            opt = fresh_opt()
            batches = (DeviceFeed(iter(host[:3])) if how == "feed" else
                       (tuple(t.to(dev) for t in h) for h in host[:3]))
            losses[how] = [float(sb.train_step(model, opt, b, group))
                           for b in batches]
        cudnn.deterministic, cudnn.benchmark = saved
        out["feed_losses"] = losses
        print(f"observe: DeviceFeed: {len(host)} batches equal to their "
              f"host copies on {dev}; 3 steps fed {losses['feed']}, by "
              f".to(device) {losses['direct']}")
        need(losses["feed"] == losses["direct"],
             "DeviceFeed's losses differ from direct copies'")

        # 2. perfscope over `steps` implicit steps of the hook path.
        ps = hvd.perfscope()
        need(isinstance(ps, perfscope.PerfScope), "perfscope is off")
        opt = fresh_opt()
        main = threading.get_ident()
        hook_threads = set()
        probe = next(model.parameters()).register_post_accumulate_grad_hook(
            lambda p: hook_threads.add(threading.get_ident()))

        def window(feed_depth, source):
            feed = DeviceFeed(source, depth=feed_depth)
            for _ in range(2):  # warm-up, outside the window
                sb.train_step(model, opt, next(feed), group)
            torch.cuda.synchronize()
            ps.reset()
            ps.set_model_flops(
                32 * F.resnet_train_flops_per_image(50, "flops"),
                "fallback")
            reset_counters()
            t0 = time.perf_counter()
            ps.step_entry()  # step 1 starts here, not at its step()
            for _ in range(steps):
                sb.train_step(model, opt, next(feed), group)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counters()
            feed.close()
            s = ps.summary()
            need(counts["fwd"] == 28 * steps
                 and counts["act_bwd"] == 28 * steps,
                 f"expected 28 + 28 launches a step, got {counts}")
            need(s["steps"] == steps, f"{s['steps']} steps recorded, not "
                 f"{steps}")
            return s, counts, 32 * steps / dt

        def sleepy():
            for h in itertools.cycle(host):
                time.sleep(SOURCE_SLEEP_S)
                yield h

        fed, counts, ips_fed = window(2, itertools.cycle(host))
        starved, _, ips_starved = window(0, sleepy())
        probe.remove()
        for tag, s, ips in (("prefetched", fed, ips_fed),
                            ("starved", starved, ips_starved)):
            print(f"observe: perfscope, {tag} feed, {ips:.1f} img/s: "
                  + json.dumps({k: s[k] for k in (
                      "steps", "wall", "phases_s", "phase_fractions",
                      "coverage", "dominant_phase", "mfu", "mfu_source",
                      "comms_axes") if k in s}))
        autograd_thread = bool(hook_threads) and main not in hook_threads
        out.update(perfscope_fed=fed, perfscope_starved=starved,
                   img_per_s_fed=ips_fed, img_per_s_starved=ips_starved,
                   launches=counts, hooks_off_main_thread=autograd_thread)
        print(f"observe: the gradient hooks ran on {len(hook_threads)} "
              f"thread(s), not the training thread: {autograd_thread}")
        need(autograd_thread, "the gradient hooks ran on the training "
             "thread")
        for tag, s in (("prefetched", fed), ("starved", starved)):
            need(s["coverage"] >= MIN_COVERAGE,
                 f"{tag}: coverage {s['coverage']}")
            need(s["phases_s"].get("comms", 0) > 0
                 and s["phases_s"].get("optimizer", 0) > 0,
                 f"{tag}: no comms or optimizer time")
            need("mfu" in s and s["mfu"] > 0, f"{tag}: no mfu")
        need(fed["phase_fractions"].get("input_wait", 0.0)
             < MAX_INPUT_WAIT_FED, "a prefetched feed waited")
        need(starved["phases_s"].get("input_wait", 0.0)
             >= SOURCE_SLEEP_S, "the starved feed's wait is not "
             "in input_wait")

        # 3. The timeline (and NVTX) around 3 steps.
        trace = os.path.join(out_dir, "trace.json")
        hvd.start_timeline(trace)
        from horovod_tpu_torch.core import topology
        nvtx = topology.timeline()._nvtx
        batch = tuple(t.to(dev) for t in host[0])
        for _ in range(3):
            sb.train_step(model, opt, batch, group)
        torch.cuda.synchronize()
        hvd.stop_timeline()
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        want = sorted([f"bucketed_allreduce/b{i}"
                       for i in range(len(opt.plan))] * 3)
        got = sorted(e["args"]["tensor"] for e in events
                     if e["ph"] == "X" and e["name"] == "ALLREDUCE"
                     and e["args"]["tensor"].startswith(
                         "bucketed_allreduce/b"))
        text = open(trace).read()
        cut = os.path.join(out_dir, "trace_cut.json")
        with open(cut, "w") as f:
            f.write(text[:text.rindex('{"ph"') + 20])
        recovered = recover_trace(cut)
        out["timeline"] = dict(events=len(events), buckets=len(opt.plan),
                               nvtx=nvtx, recovered=len(recovered))
        print(f"observe: timeline: {len(events)} events, "
              f"{len(got)} ALLREDUCE spans over 3 steps of "
              f"{len(opt.plan)} buckets, NVTX ranges {nvtx}; a copy cut "
              f"mid-event recovers {len(recovered)} events")
        need(len(opt.plan) == 18 and want == got,
             "the timeline does not hold one span per bucket a step")
        need(nvtx, "the timeline opened no NVTX ranges on the card")
        need(len(recovered) == len(events) - 1,
             "recover_trace lost events of the cut copy")

        # 6. The host cost of the always-on scope, in turns, ahead of the
        # device trace of 5.
        rates = {"default": [], "off": []}
        for tag in ("default", "off", "off", "default"):
            if tag == "off":
                os.environ["HOROVOD_PERFSCOPE"] = "0"
            else:
                os.environ.pop("HOROVOD_PERFSCOPE", None)
            perfscope.reset_for_tests()
            sb.train_step(model, opt, batch, group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                sb.train_step(model, opt, batch, group)
            torch.cuda.synchronize()
            rates[tag].append(32 * steps / (time.perf_counter() - t0))
        os.environ.pop("HOROVOD_PERFSCOPE", None)
        perfscope.reset_for_tests()
        out["scope_cost_img_per_s"] = rates
        print(f"observe: hook path img/s with the scope on (default) "
              f"{[round(r, 1) for r in rates['default']]}, with "
              f"HOROVOD_PERFSCOPE=0 {[round(r, 1) for r in rates['off']]}")

        # 5. device_profile on the block-route step.
        prof = device_profile.profile_step(
            lambda: sb.train_step(model, opt, batch, group), reps=3)
        hvd_ms = prof.per_category.get("hvd kernel", 0.0)
        rel = abs(hvd_ms - k12_ms) / k12_ms
        out["device_profile"] = dict(per_category=prof.per_category,
                                     total_ms=prof.total_ms,
                                     top=prof.top_ops(10), hvd_ms=hvd_ms,
                                     k12_ms=k12_ms, rel=rel)
        print("\n".join("observe: " + ln
                        for ln in prof.as_markdown(top=10).splitlines()))
        print(f"observe: hvd kernel category {hvd_ms:.4f} ms a step, "
              f"kernels 1 + 2 in phase 2 {k12_ms:.4f}: relative "
              f"difference {rel:.3f} (tolerance {TOL_KERNEL_CATEGORY})")
        need(rel <= TOL_KERNEL_CATEGORY, "the hvd kernel category is not "
             "kernels 1 + 2")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        hvd.shutdown()
    torch.cuda.empty_cache()

    # 4. The launched run, after this process left its world.
    flight = os.path.join(out_dir, "flight")
    launched_trace = os.path.join(out_dir, "launched_trace.json")
    py = sys.executable
    rc, text = run_bounded(
        [py, "-m", "horovod_tpu_torch.runner.launch", "-np", "1",
         "--timeline-filename", launched_trace, py, "-m",
         "horovod_tpu_torch.synthetic_benchmark", "--batch-size", "32",
         "--num-warmup-batches", "1", "--num-batches-per-iter", "3",
         "--num-iters", "1"], 600,
        env=dict(os.environ, HOROVOD_FLIGHT_DIR=flight,
                 HOROVOD_CONV_BLOCK="1", HOROVOD_FUSE_CONV_BN="0"))
    need(rc == 0, f"the launched benchmark exited {rc}:\n{text[-3000:]}")
    with open(launched_trace) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    summary_path = os.path.join(flight, "perf-rank-0.r0.json")
    need(os.path.exists(summary_path), "the launcher persisted no "
         "perfscope summary into HOROVOD_FLIGHT_DIR")
    with open(summary_path) as f:
        body = json.load(f)
    buckets = {e["args"]["tensor"] for e in spans
               if e["args"]["tensor"].startswith("bucketed_allreduce/b")}
    out["launched"] = dict(spans=len(spans), buckets=len(buckets),
                           summary=body["summary"])
    print(f"observe: launched run: trace with {len(spans)} spans "
          f"({len(buckets)} bucket names), rank 0's summary in "
          f"{summary_path}: {body['summary']['steps']} steps, coverage "
          f"{body['summary']['coverage']:.4f}, dominant phase "
          f"{body['summary']['dominant_phase']}")
    need(len(buckets) == 18, "the launched trace lacks the bucket spans")
    need(body["rank"] == 0 and body["summary"]["steps"] >= 4,
         "the persisted summary does not cover the launched steps")
    return out


# ------------------------------------------------------ phase 10: elastic

PHASE10_STEPS = 5           # (b), (c): steps of each in-process run
PHASE10_TWIN_STEPS = 8      # the launched uninterrupted twin (d, e)
PHASE10_STALL_S = 30        # (e): HOROVOD_STALL_SHUTDOWN_TIME_SECONDS


def _resnet_check_job(tmp, hosts, flags, extra_env=None, timeout=240):
    """`runner.launch` in elastic mode over elastic/resnet_check.py with a
    discovery script that reads `hosts` from a file the workers may
    rewrite. Returns ({step: [loss repr, ...]}, parsed lines by kind,
    the raw output)."""
    py = sys.executable
    os.makedirs(tmp, exist_ok=True)
    hosts_file = os.path.join(tmp, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.write(hosts + "\n")
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts_file}\n")
    os.chmod(script, 0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_ELASTIC", "HOROVOD_RANK", "HOROVOD_SIZE")}
    env.update({"HOROVOD_CONV_BLOCK": "1", "HOROVOD_FUSE_CONV_BN": "0",
                "HOROVOD_CKPT_DIR": os.path.join(tmp, "ckpts"),
                "HOROVOD_CKPT_EVERY": "1"}, **(extra_env or {}))
    cmd = [py, "-m", "horovod_tpu_torch.runner.launch",
           "--host-discovery-script", script, "--slots-per-host", "1",
           "--min-np", "1", "--elastic-timeout", "120",
           "--blacklist-cooldown-range", "1", "1",
           py, "-m", "horovod_tpu_torch.elastic.resnet_check",
           "--hosts-file", hosts_file, *flags]
    rc, text = run_bounded(cmd, timeout, env=env)
    need(rc == 0, f"{' '.join(flags)}: the elastic job exited {rc}:\n"
         f"{text[-4000:]}")
    lines = {}
    for ln in text.splitlines():
        body = ln.split(">: ", 1)[-1]
        kind = body.split(" ", 1)[0]
        if kind in ("RESUME", "STEP", "RAISED", "DIGEST", "KILL", "EXIT",
                    "DONE"):
            lines.setdefault(kind, []).append(
                dict(kv.split("=", 1) for kv in body.split()[1:]))
    losses = {}
    for f in lines.get("STEP", []):
        losses.setdefault(int(f["step"]), []).append(f["loss"])
        need(f["launches"] == "28,28", f"a launched step ran kernels 1 "
             f"and 2 {f['launches']} times, not 28,28: {f}")
    need(all(math.isfinite(float(v)) for vs in losses.values() for v in vs),
         f"non-finite launched losses {losses}")
    return losses, lines, text


def elastic_path():
    """Phase 10: elastic training and checkpointing on the ResNet-50 main
    path (224², bf16, batch 32, block route, seed-0 weights, cuDNN
    deterministic): (a) TrainLoopState's commit and restore, (b) the
    in-process retry through a reset of the NCCL world, (c) the async
    checkpointer under perfscope, (d) a preempted launched job resuming
    from its checkpoint, (e) with two or more cards, a peer's death, a
    shrink and a grow through the elastic launcher. (d) and (e) alone:
    `elastic_launched()`."""
    out = elastic_in_process()
    launched = elastic_launched()
    out["seconds"].update(launched.pop("seconds"))
    out.update(launched)
    return out


def _phase10_env():
    """Phase 10's knobs and cuDNN's deterministic mode; returns what to
    put back."""
    import torch
    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    return saved


def elastic_in_process():
    """Phase 10 (a), (b), (c), in this process on one card."""
    import tempfile
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import ckpt, elastic, kernels
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.ckpt import sharded
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.profiler import perfscope

    saved = _phase10_env()
    os.environ["HOROVOD_ELASTIC"] = "1"  # the elastic NCCL settings
    tmp = tempfile.TemporaryDirectory(prefix="hvd_phase10_")
    out = {}
    took = _lap(out)
    hvd.init()
    try:
        dev = hvd.device()
        need(dev.type == "cuda", "phase 10 is not on the card")
        data = sb.make_batch(32, 224, torch.bfloat16, dev, seed=0)

        def build():
            model = sb.build("resnet50", torch.bfloat16, dev)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
                named_parameters=model.named_parameters())
            return model, opt

        def step(model, opt):
            opt.zero_grad()
            loss, stats = resnet.loss_fn(model, data, train=True,
                                         group=dist.group.WORLD)
            loss.backward()
            opt.step()
            model.set_stats(stats)
            return loss.item()

        def drop(opt):
            for h in opt._hooks:
                h.remove()

        # (a) commit after step 2, 2 more steps, restore
        model, opt = build()
        st = elastic.TrainLoopState(model=model, optimizer=opt)
        for s in (1, 2):
            step(model, opt)
            st.step = s
        t0 = time.perf_counter()
        st.commit()
        torch.cuda.synchronize()
        commit_ms = (time.perf_counter() - t0) * 1e3
        want = {k: v.clone() for k, v in model.state_dict().items()}
        want_mom = [opt.state[p]["momentum_buffer"].clone()
                    for p in model.parameters()]
        for s in (3, 4):
            step(model, opt)
            st.step = s
        moved = not torch.equal(model.stem.conv, want["stem.conv"])
        st.restore()
        same = all(torch.equal(model.state_dict()[k], v)
                   for k, v in want.items())
        same_mom = all(torch.equal(opt.state[p]["momentum_buffer"], m)
                       for p, m in zip(model.parameters(), want_mom))
        out["a"] = dict(commit_ms=commit_ms, moved=moved, params=same,
                        momentum=same_mom, step=st.step)
        print(f"elastic (a): commit of {len(want)} state tensors and "
              f"{len(want_mom)} momentum buffers {commit_ms:.2f} ms; after "
              f"2 more steps restore() gives the committed parameters and "
              f"BN stats {same}, momentum {same_mom} (step {st.step}); "
              f"{took('a'):.1f} s")
        need(moved and same and same_mom and st.step == 2,
             "phase 10 (a): restore() did not give the commit back")
        drop(opt)
        del model, opt, st

        # (b) HorovodInternalError at step 3 through @hvd.elastic.run
        def run_b(inject):
            model, opt = build()
            state = elastic.TrainLoopState(model=model, optimizer=opt)
            rec = {"losses": [], "launches": [], "worlds": []}

            @elastic.run
            def train(st):
                rec["worlds"].append(topology.rendezvous())
                while st.step < PHASE10_STEPS:
                    c0 = read_counters()
                    opt.zero_grad()
                    loss, stats = resnet.loss_fn(model, data, train=True,
                                                 group=dist.group.WORLD)
                    loss.backward()
                    if inject and st.step == 2 and len(rec["worlds"]) == 1:
                        raise hvd.HorovodInternalError("injected at step 3")
                    opt.step()
                    model.set_stats(stats)
                    rec["losses"].append(loss.item())
                    c1 = read_counters()
                    rec["launches"].append((c1["fwd"] - c0["fwd"],
                                            c1["act_bwd"] - c0["act_bwd"]))
                    st.step += 1
                    st.commit()
                return st.step

            builds, libs = kernels.build_count, dict(kernels._libs)
            t0 = time.perf_counter()
            train(state)
            rec["seconds"] = time.perf_counter() - t0
            rec["builds"] = kernels.build_count - builds
            rec["libs_kept"] = libs == kernels._libs
            rec["backend"] = dist.get_backend()
            drop(opt)
            return rec

        ref = run_b(False)
        got = run_b(True)
        out["b"] = dict(uninterrupted=ref, injected=got)
        print(f"elastic (b): losses {got['losses']} with the reset at step "
              f"3, uninterrupted {ref['losses']}; kernel 1, 2 launches a "
              f"step {got['launches']}; worlds {got['worlds']}; kernel "
              f"builds during the run {got['builds']}, libraries kept "
              f"{got['libs_kept']}; {got['seconds']:.1f} s against "
              f"{ref['seconds']:.1f} s; {took('b'):.1f} s")
        need(got["losses"] == ref["losses"],
             "phase 10 (b): the losses through the reset differ from the "
             "uninterrupted run's")
        need(len(got["worlds"]) == 2 and got["worlds"][0] != got["worlds"][1]
             and got["backend"] == "nccl",
             "phase 10 (b): the NCCL world was not re-made in the process")
        need(all(x == (28, 28) for x in got["launches"] + ref["launches"])
             and len(got["launches"]) == PHASE10_STEPS,
             "phase 10 (b): kernels 1 and 2 did not run 28 times a step")
        need(got["builds"] == 0 and got["libs_kept"],
             "phase 10 (b): the reset built or loaded a kernel again")

        # (c) async checkpointing, saving every step, under perfscope
        model, opt = build()
        saver = ckpt.AsyncCheckpointer(os.path.join(tmp.name, "c"))
        st = elastic.TrainLoopState(model=model, optimizer=opt,
                                    checkpointer=saver)
        scope = perfscope.get()
        scope.reset()
        saves = []
        for s in range(1, PHASE10_STEPS + 1):
            t0 = time.perf_counter()
            step(model, opt)
            t1 = time.perf_counter()
            st.step = s
            st.commit()
            t2 = time.perf_counter()
            accepted = st.checkpoint()
            t3 = time.perf_counter()
            saves.append(dict(step=s, accepted=accepted,
                              step_ms=(t1 - t0) * 1e3,
                              commit_ms=(t2 - t1) * 1e3,
                              save_call_ms=(t3 - t2) * 1e3))
        need(saver.wait(120), "phase 10 (c): the writer did not finish")
        summ = scope.summary()
        hist = {h["step"]: h for h in saver.history}
        for rec in saves:
            h = hist.get(rec["step"]) if rec["accepted"] else None
            if h is not None:
                rec.update(bytes=h["bytes"], snapshot_ms=h["snapshot_s"] * 1e3,
                           persist_s=h.get("persist_s"),
                           commit_s=h.get("commit_s"))
                print(f"elastic (c): step {rec['step']} save: "
                      f"{h['bytes']} bytes, snapshot "
                      f"{rec['snapshot_ms']:.2f} ms against the step's "
                      f"{rec['step_ms']:.2f} ms (commit "
                      f"{rec['commit_ms']:.2f} ms), persist "
                      f"{rec['persist_s']:.3f} s in the background")
            else:
                print(f"elastic (c): step {rec['step']} save skipped "
                      f"(writer busy), step {rec['step_ms']:.2f} ms")
        share = summ["phase_fractions"].get("checkpoint", 0.0)
        out["c"] = dict(saves=saves, skipped=saver.skipped,
                        checkpoint_share=share,
                        checkpoint_s=summ["phases_s"].get("checkpoint", 0.0),
                        step_mean_s=summ["wall"]["mean_s"],
                        perfscope=summ)
        print(f"elastic (c): perfscope over {summ['steps']} steps: "
              f"checkpoint {share:.4f} of the step "
              f"({summ['phases_s'].get('checkpoint', 0.0) * 1e3:.2f} ms a "
              f"step), {saver.skipped} save(s) skipped by back-pressure")
        need(saves[0]["accepted"] and "checkpoint" in summ["phases_s"],
             "phase 10 (c): the first save was not taken or not attributed")
        # the snapshot's two ways on the committed payload, in turns
        tree, _ = st._ckpt_payload()
        tensors = [t for _, t in sharded.flatten(tree)]
        ways = {"pinned side stream": lambda: sharded._host_copies(tensors),
                "synchronous .cpu()": lambda: [t.cpu() for t in tensors]}
        times = {k: [] for k in ways}
        for k in list(ways) + list(reversed(list(ways))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ways[k]()
            times[k].append((time.perf_counter() - t0) * 1e3)
        out["c"]["snapshot_ways_ms"] = times
        print(f"elastic (c): snapshot of {len(tensors)} tensors, in turns: "
              + "; ".join(f"{k} {', '.join(f'{v:.2f}' for v in vs)} ms"
                          for k, vs in times.items()))
        # the final blocking save, restored into a fresh model
        need(st.checkpoint(block=True), "phase 10 (c): the final blocking "
             "save did not commit")
        fresh, fopt = build()
        fst = elastic.TrainLoopState(model=fresh, optimizer=fopt,
                                     checkpointer=ckpt.AsyncCheckpointer(
                                         saver.root))
        need(fst.maybe_resume() and fst.step == PHASE10_STEPS,
             "phase 10 (c): the fresh model did not resume from disk")
        with torch.no_grad():
            la, _ = resnet.apply(model, data[0], train=False)
            lb, _ = resnet.apply(fresh, data[0], train=False)
        equal = torch.equal(la, lb)
        out["c"]["logits_equal"] = equal
        print(f"elastic (c): logits of the restored model on phase 4's "
              f"batch equal the saved model's bit for bit: {equal}; "
              f"{took('c'):.1f} s")
        need(equal, "phase 10 (c): restored logits differ")
        saver.close()
        drop(opt)
        drop(fopt)
        del model, opt, fresh, fopt, st, fst
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
        tmp.cleanup()
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
        os.environ.pop("HOROVOD_ELASTIC", None)
    return out


def _lap(out):
    """took(part): wall seconds since the last part ended, into
    out["seconds"]."""
    t_last = [time.perf_counter()]

    def took(part):
        now = time.perf_counter()
        out.setdefault("seconds", {})[part] = now - t_last[0]
        t_last[0] = now
        return out["seconds"][part]
    return took


def _preempted(tmp, twin, twin_d, out, took):
    """Phase 10 (d): the launched job SIGKILLed after step 3's commit
    resumes from its checkpoint in round 2."""
    got, gl, text = _resnet_check_job(
        os.path.join(tmp, "d"), "localhost:1",
        ["--steps", "6", "--kill-step", "3", "--digest-steps", "6"])
    kill_t = float(gl["KILL"][0]["t"])
    round2 = [f for f in gl["STEP"] if f["round"] != "1"]
    resumed = [f for f in gl["RESUME"] if f["round"] != "1"]
    recover_s = float(round2[0]["t"]) - kill_t
    out["d"] = dict(losses=got, twin=twin, resume=resumed,
                    recover_s=recover_s, digest=gl["DIGEST"],
                    twin_digest=twin_d)
    print(f"elastic (d): killed after step {gl['KILL'][0]['step']}'s "
          f"commit; round 2 {resumed[0]}; losses "
          f"{ {k: v[0] for k, v in sorted(got.items())} }; twin "
          f"{ {k: v[0] for k, v in sorted(twin.items()) if k <= 6} }; "
          f"digest at 6 {gl['DIGEST'][0]['digest'][:16]}, twin's "
          f"{twin_d['6'][:16]}; time to recover {recover_s:.2f} s "
          f"(kill to round 2's first step); {took('d'):.1f} s")
    need(len(gl["KILL"]) == 1 and resumed
         and resumed[0]["step"] == "3"
         and resumed[0]["source"] == "checkpoint",
         "phase 10 (d): round 2 did not resume from step 3's checkpoint")
    need(sorted(got) == list(range(1, 7))
         and all(got[k] == twin[k] for k in got),
         "phase 10 (d): the losses differ from the uninterrupted twin's")
    need(gl["DIGEST"][0]["digest"] == twin_d["6"],
         "phase 10 (d): the parameters differ from the twin's")


def elastic_launched(preempt: bool = True):
    """Phase 10 (d) and (e): `runner.launch` in elastic mode over
    elastic/resnet_check.py, against an uninterrupted twin; without
    `preempt`, the twin and (e) alone (the four-card call)."""
    import tempfile
    import torch
    saved = _phase10_env()
    tmp = tempfile.TemporaryDirectory(prefix="hvd_phase10_")
    out = {}
    took = _lap(out)
    try:
        twin, tl, _ = _resnet_check_job(
            os.path.join(tmp.name, "twin"), "localhost:1",
            ["--steps", str(PHASE10_TWIN_STEPS), "--digest-steps", "6,8"])
        twin_d = {f["step"]: f["digest"] for f in tl["DIGEST"]}
        out["twin"] = dict(losses=twin, digest=twin_d)
        print(f"elastic: uninterrupted twin, losses "
              f"{ {k: v[0] for k, v in sorted(twin.items())} }; "
              f"{took('twin'):.1f} s")
        if preempt:
            _preempted(tmp.name, twin, twin_d, out, took)

        # (e) two or more cards: a peer dies, the survivor shrinks, grows
        n = torch.cuda.device_count()
        if n < 2:
            out["e"] = dict(skipped=f"{n} card visible")
            print(f"elastic (e): needs two or more cards, {n} visible: "
                  f"not run")
        else:
            got, gl, text = _resnet_check_job(
                os.path.join(tmp.name, "e"), "localhost:2",
                ["--steps", str(PHASE10_TWIN_STEPS), "--exit-step", "5",
                 "--exit-rank", "1", "--grow-step", "6"],
                extra_env={"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS":
                           str(PHASE10_STALL_S)})
            raised = gl.get("RAISED", [])
            sizes = [(f["round"], f["size"], f["rank"], f["source"])
                     for f in gl["RESUME"]]
            done = [f["digest"] for f in gl["DONE"]]
            out["e"] = dict(cards=n, raised=raised, resumes=sizes,
                            losses=got, done=done, twin=twin,
                            exit=gl.get("EXIT"))
            print(f"elastic (e): {n} cards; rank 1 exited at step "
                  f"{gl['EXIT'][0]['step']}; the survivor raised "
                  f"HorovodInternalError after {raised[0]['after'] if raised else '-'} s "
                  f"(bound {PHASE10_STALL_S} s); rounds (round, size, rank, "
                  f"source) {sizes}; losses "
                  f"{ {k: v for k, v in sorted(got.items())} }; final "
                  f"digests {[d[:16] for d in done]}, twin's "
                  f"{twin_d['8'][:16]}; {took('e'):.1f} s")
            need(len(raised) == 1 and raised[0]["step"] == "5"
                 and float(raised[0]["after"]) <= PHASE10_STALL_S + 15,
                 "phase 10 (e): the survivor did not raise within the "
                 "bound")
            need({s for _, s, _, _ in sizes} == {"1", "2"},
                 "phase 10 (e): the job did not shrink to 1 and grow to 2")
            need(all(got[k] == [twin[k][0]] * len(got[k]) for k in got)
                 and sorted(got) == list(range(1, PHASE10_TWIN_STEPS + 1)),
                 "phase 10 (e): the losses differ from the twin's")
            need(len(done) == 2 and set(done) == {twin_d["8"]},
                 "phase 10 (e): the final parameters differ from the "
                 "twin's")
    finally:
        tmp.cleanup()
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    return out


# ------------------------------------------- phase 11: sequence parallelism

RING_SHAPE = (12, 16, 1024, 128)  # the LM's (B, H, S, dh) at the flagship
RING_P = 4                        # sequence blocks of phase 11 (a)
# The ring's hops in f32 (tf32 products, simple instances) against
# flash_attention at full S in f32 (the same kernels, one chunk) and
# against the plain f32 attention: each output and gradient tile by tile,
# ‖Δ_tile‖ ≤ tol·‖ref_tile‖, at the f32 flash tolerance of phase 3
# (tf32 rounding, ~2^-11 of a tile's norm; the merge adds f32 rounding).
TOL_RING = 2.0 ** -9
# Losses of 4 Adam steps (flagship LM, bf16) through ring or Ulysses
# against phase 5's attn="flash" losses from the same weights and batch,
# relative. Ulysses at sp = 1 runs phase 5's kernels (bf16 Hopper) on the
# same inputs; the ring runs its chunks in f32 and casts the output to
# bf16 once, so its attention differs from flash's by bf16 rounding
# (2^-8 of a value), which Adam carries into the later steps' weights;
# at sp = N the world's loss is also a mean of N partial means.
TOL_SP_LOSS = 2e-3


def ring_hops_check(dev, P=RING_P):
    """Phase 11 (a): the ring's hops on one card. The LM's attention
    (RING_SHAPE, causal, bf16 input upcast to f32 as
    ring_flash_attention does) cut into P sequence blocks; for each ring
    rank r the hop helper (ring_attention.ring_hop) over its P hops,
    fed the block that rank would hold after t hops, (r − t) % P; the
    outputs concatenated, and one backward of Σ o·do through every hop.
    Held against flash_attention at full S (f32) and the plain f32
    attention, o and the q, k, v gradients; kernels 4–6 counted (causal
    rank r runs r + 1 chunks: 10 of each at P = 4), every kernel-5 call
    checked to carry an lse cotangent, and the ring's chunk shapes
    checked against the plain versions (flash_case). Times the hop loop
    (forward, and forward + backward; device time) beside one
    flash_attention at full S, f32 and bf16."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.ring_attention import (
        blockwise_attention_reference, hop_case, ring_hop)
    B, H, S, dh = RING_SHAPE
    n, sc = S // P, dh ** -0.5
    g = torch.Generator(device=dev).manual_seed(1100)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=g, device=dev)
                   .to(torch.bfloat16).float() for _ in range(4))
    out = {"shape": dict(B=B, H=H, S=S, dh=dh, P=P),
           "instance": fa.flash_instance(torch.float32, dh)}
    for i, case in enumerate((
            ("ring causal chunk + dlse", B * H, n, n, dh, True, "float32",
             True),
            ("ring full chunk + dlse", B * H, n, n, dh, False, "float32",
             True))):
        out[case[0]] = flash_case(dev, *case, seed=1110 + i)

    def blk(t, j):
        return t[:, :, j * n:(j + 1) * n]

    def ring(q, k, v):
        outs = []
        for r in range(P):
            o = torch.zeros((B, H, n, dh), device=dev)
            L = torch.full((B, H, n), -1e30, device=dev)
            for t in range(P):
                src = (r - t) % P
                kv = torch.stack([blk(k, src), blk(v, src)])
                o, L = ring_hop(blk(q, r), kv, o, L, hop_case(src, r, True),
                                sc)
            outs.append(o)
        return torch.cat(outs, dim=2)

    def grads(fn, *ins):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        o = fn(*leaves)
        o.backward(do)
        return [o.detach()] + [t.grad for t in leaves]

    dlse_seen = []
    bwd = fa._bwd  # what _FlashChunk.backward calls: kernels 5, then 6

    def spy(q_, k_, v_, o_, lse, do_, dlse, causal, scale):
        dlse_seen.append(dlse is not None)
        return bwd(q_, k_, v_, o_, lse, do_, dlse, causal, scale)

    reset_counters()
    fa._bwd = spy
    try:
        got = grads(ring, q, k, v)
    finally:
        fa._bwd = bwd
    torch.cuda.synchronize()
    counts = read_counters()
    want = P * (P + 1) // 2
    out["launches"] = counts
    print(f"ring hops: B={B} H={H} S={S} dh={dh} in {P} blocks of {n}, "
          f"f32 [{out['instance']}]; launches {counts} (expected {want} "
          f"of kernels 4, 5, 6)")
    need(counts["attn_fwd"] == want and counts["attn_dkdv"] == want
         and counts["attn_dq"] == want,
         f"phase 11 (a): expected {want} launches of kernels 4-6, got "
         f"{counts}")
    need(len(dlse_seen) == want and all(dlse_seen),
         f"phase 11 (a): kernel 5 ran without an lse cotangent "
         f"({dlse_seen})")
    flash = grads(lambda a, b, c: fa.flash_attention(a, b, c, causal=True),
                  q, k, v)
    plain = grads(lambda a, b, c: blockwise_attention_reference(
        a, b, c, causal=True), q, k, v)
    for ref_name, ref in (("flash_full_s", flash), ("plain", plain)):
        rec = {}
        for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
            flat = (lambda t: t.reshape(B * H, S, dh))
            rec[name] = _err(a, r)
            rec[name + "_tile"] = tile_ratio(flat(a), flat(r))
            need(bool(torch.isfinite(a).all())
                 and rec[name + "_tile"] <= TOL_RING,
                 f"phase 11 (a): the ring's {name} against {ref_name}: "
                 f"worst tile ratio {rec[name + '_tile']} (tolerance "
                 f"{TOL_RING})")
        out["vs_" + ref_name] = rec
        print(f"ring hops vs {ref_name}: max|Δ| (worst tile ratio) "
              + ", ".join(f"{k_} {rec[k_]:.3g} ({rec[k_ + '_tile']:.3g})"
                          for k_ in ("o", "dq", "dk", "dv"))
              + f" (tolerance {TOL_RING})")
    del got, flash, plain

    def fwd_bwd(fn, *ins):
        leaves = [t.detach().requires_grad_(True) for t in ins]
        fn(*leaves).backward(do)

    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    full = lambda a, b, c: fa.flash_attention(a, b, c, causal=True)  # noqa
    t = {"ring_fwd_ms": device_ms(lambda: ring(q, k, v), iters=5),
         "ring_fwd_bwd_ms": device_ms(lambda: fwd_bwd(ring, q, k, v),
                                      iters=5),
         "flash_f32_fwd_ms": device_ms(lambda: full(q, k, v), iters=5),
         "flash_f32_fwd_bwd_ms": device_ms(lambda: fwd_bwd(full, q, k, v),
                                           iters=5),
         "flash_bf16_fwd_ms": device_ms(lambda: full(qb, kb, vb), iters=5),
         "flash_bf16_fwd_bwd_ms": device_ms(
             lambda: fwd_bwd(full, qb, kb, vb), iters=5)}
    out["times"] = t
    print(f"time ring hops (all {P} ranks' {want} chunks and merges, one "
          f"card): forward {t['ring_fwd_ms']:.4f} ms, forward + backward "
          f"{t['ring_fwd_bwd_ms']:.4f}; flash_attention at full S f32 "
          f"{t['flash_f32_fwd_ms']:.4f} / {t['flash_f32_fwd_bwd_ms']:.4f}, "
          f"bf16 {t['flash_bf16_fwd_ms']:.4f} / "
          f"{t['flash_bf16_fwd_bwd_ms']:.4f}")
    return out


def _sp_losses(name, res, flash_losses):
    """The largest relative difference of `res`'s losses from phase 5's
    first ones; fails past TOL_SP_LOSS."""
    losses = res["losses"]
    need(all(math.isfinite(v) for v in losses),
         f"phase 11 {name}: non-finite loss {losses}")
    rel = max(abs(a - b) / max(abs(b), 1e-6)
              for a, b in zip(losses, flash_losses))
    print(f"{name}: losses {[round(v, 6) for v in losses]}, phase 5's "
          f"flash {[round(v, 6) for v in flash_losses[:len(losses)]]}, "
          f"largest relative difference {rel:.3g} (tolerance "
          f"{TOL_SP_LOSS})")
    need(rel <= TOL_SP_LOSS, f"phase 11 {name}: losses disagree with "
         f"attn='flash'")
    return rel


def sequence_parallel_path(lm_out: dict):
    """Phase 11: sequence parallelism. (a) the ring's hops on one card
    (ring_hops_check); (b) the flagship LM through transformer_lm.run
    with attn="ulysses" and "ring" under HOROVOD_MESH="sp=1", 1 warm-up
    and 3 timed steps each from the seed-0 weights and phase 5's batch,
    its losses against phase 5's flash ones; (c) with two or more cards,
    the same LM in a world of min(4, count) under HOROVOD_MESH="sp=N"
    through runner.run, ring and Ulysses, rank 0's losses against phase
    5's, the launches of kernels 4–6 per step on every rank; with one
    card it says so."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm
    dev = torch.device("cuda", 0)
    out = {"a": ring_hops_check(dev)}
    torch.cuda.empty_cache()
    flash = lm_out["losses"]
    steps, L = 4, lm.FLAGSHIP["n_layers"]
    print(f"phase 5 (attn=flash): {lm_out['tokens_per_s']:.1f} tokens/s, "
          f"{lm_out['step_ms']:.2f} ms/step")

    saved = os.environ.get("HOROVOD_MESH")
    os.environ["HOROVOD_MESH"] = "sp=1"
    hvd.init()
    try:
        for attn in ("ulysses", "ring"):
            cfg = tfm.TransformerConfig(**lm.FLAGSHIP, attn=attn,
                                        dtype=torch.bfloat16)
            res = lm.run(cfg, lm.FLAGSHIP_BATCH, 1, 3)
            res["loss_rel"] = _sp_losses(f"(b) {attn} sp=1", res, flash)
            print(f"(b) {attn} sp=1: {res['tokens_per_s']:.1f} tokens/s, "
                  f"{res['step_ms']:.2f} ms/step (phase 5 flash "
                  f"{lm_out['step_ms']:.2f}), peak memory "
                  f"{res['peak_mem_gb']:.1f} GB; launches {res['launches']}")
            need(all(c == L * steps for c in res["launches"].values()),
                 f"phase 11 (b) {attn}: expected {L} launches of kernels "
                 f"4-6 per step, got {res['launches']}")
            out[f"b_{attn}"] = res
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
        if saved is None:
            os.environ.pop("HOROVOD_MESH")
        else:
            os.environ["HOROVOD_MESH"] = saved

    out.update(sp_world(lm_out))
    return out


def _sp_steps(attn: str) -> dict:
    """One rank of phase 11 (c): transformer_lm.flagship_steps, with every
    thread's stack printed should the launcher's SIGTERM end it (a
    world that hangs past its bound)."""
    import faulthandler
    import signal
    from horovod_tpu_torch import transformer_lm as lm
    faulthandler.register(signal.SIGTERM, chain=True)
    return lm.flagship_steps(attn)


def sp_world(lm_out: dict) -> dict:
    """Phase 11 (c) alone (see sequence_parallel_path)."""
    import functools
    import torch
    from horovod_tpu_torch import runner
    from horovod_tpu_torch import transformer_lm as lm
    flash = lm_out["losses"]
    steps, L = 4, lm.FLAGSHIP["n_layers"]
    out = {}
    cards = torch.cuda.device_count()
    if cards < 2:
        print("phase 11 (c): one card; the sp = N world needs two or more")
        out["c"] = None
        return out
    N = min(4, cards)
    for attn in ("ring", "ulysses"):
        res = runner.run(functools.partial(_sp_steps, attn), np=N,
                         extra_env={"HOROVOD_MESH": f"sp={N}"}, timeout=300)
        res[0]["loss_rel"] = _sp_losses(f"(c) {attn} sp={N}", res[0], flash)
        per_step = [{k: c / steps for k, c in r["launches"].items()}
                    for r in res]
        for r, counts in enumerate(per_step):
            chunks = (r + 1) if attn == "ring" else 1
            need(all(c == L * chunks for c in counts.values()),
                 f"phase 11 (c) {attn}: rank {r} launched {counts} a step, "
                 f"expected {L * chunks} of each")
        print(f"(c) {attn} sp={N}: {res[0]['tokens_per_s']:.1f} tokens/s "
              f"over the global batch, {res[0]['step_ms']:.2f} ms/step; "
              f"launches of kernels 4-6 a step by rank "
              f"{[c['attn_fwd'] for c in per_step]}; peak memory by rank "
              f"{[round(r['peak_mem_gb'], 2) for r in res]} GB")
        out[f"c_{attn}"] = dict(ranks=res, launches_per_step=per_step)
    return out


# ------------------------- phase 12: the other models and the API surface

# Phase 12's bars. (b) The same f32 model on the card and on the host:
# cuDNN's and oneDNN's convolutions and the two GEMM libraries sum in
# different orders (tf32 is off, so every product is f32), ~1e-6 of a
# value per layer through 16 (VGG) or ~95 (Inception) layers; 1e-3 of
# the loss and of the largest gradient leaves room for that and catches
# any wrong layer, whose error is of the order of the value.
TOL_HOST = 1e-3
# (e) Count-weighted BN on the card against the JAX formula or one BN
# over the whole batch: f32 sums of 2·8·8 to 8·8·8 values a channel in
# other orders (and the all-reduce's) differ by ~1e-7; the outputs and
# gradients pass through rsqrt(var + eps), a few ulp.
TOL_SBN = 1e-5              # outputs and gradients, of the largest
TOL_SBN_STATS = 1e-6        # running mean and var, of the largest
SBN_C = 64
SBN_BATCHES = (3, 5)        # per-rank images in (e)'s world of 2
# (a) VGG-16 under the benchmark's SGD (lr 0.01, momentum 0.9) on one
# repeated batch diverges within a few steps, as the JAX model does
# (tests/test_torch_models.py::test_vgg16_sgd_steps_track_jax_and_
# diverge_alike): the finite-loss bar trains it at this lr (momentum
# 0.9); the step's kernels and their times do not depend on the lr.
VGG_LR = 1e-4


def _bn_buffers(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()}


def other_model_run(name, image, batch=32, warmup=2, timed=5, lr=None):
    """Phase 12 (a) for one model: `warmup` + `timed` steps of
    synthetic_benchmark.train_step (bf16, 1000 classes, the bucketed
    hook path) from the seed-0 weights, perfscope over the timed steps,
    then profile_step.profile_route's device busy share over 3 traced
    steps. The optimizer is the benchmark's, or SGD at `lr` (momentum
    0.9). No kernel of ours lies on this path: the counters must stay
    at 0."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import profile_step
    from horovod_tpu_torch import synthetic_benchmark as sb
    dev, group = hvd.device(), dist.group.WORLD
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = sb.build(name, torch.bfloat16, dev, image_size=image)
    opt = sb.make_optimizer(model) if lr is None else \
        hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
            named_parameters=model.named_parameters())
    data = sb.make_batch(batch, image, torch.bfloat16, dev, seed=hvd.rank())
    before = _bn_buffers(model)
    reset_counters()
    losses = [sb.train_step(model, opt, data, group) for _ in range(warmup)]
    ps = hvd.perfscope()
    torch.cuda.synchronize()
    ps.reset()
    ps.step_entry()
    t0 = time.perf_counter()
    losses += [sb.train_step(model, opt, data, group) for _ in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summ = ps.summary()
    counts = read_counters()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [float(v) for v in losses]
    prof = profile_step.profile_route(
        lambda: sb.train_step(model, opt, data, group), 3)
    after = _bn_buffers(model)
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    out = dict(model=name, image=image, batch=batch, lr=lr, losses=losses,
               img_per_s=batch * timed / dt, step_ms=dt / timed * 1e3,
               buckets=len(opt.plan), peak_mem_gb=peak_gb,
               launches=counts, bn_buffers=len(before),
               bn_buffers_moved=len(moved),
               dispatch_share=summ.get("phase_fractions", {}).get(
                   "dispatch"),
               phase_fractions=summ.get("phase_fractions"),
               busy_share=prof["busy_share"],
               device_busy_ms=prof["device_busy_ms_per_step"],
               kernels_per_step=prof["kernels_per_step"],
               family_ms=prof["family_ms_per_step"],
               profiled_wall_ms=prof["wall_ms_per_step"])
    for h in opt._hooks:  # they stack on the parameters of a next run
        h.remove()
    print(f"(a) {name} {image}² bf16 batch {batch}: {out['img_per_s']:.1f} "
          f"img/s, {out['step_ms']:.2f} ms/step, {out['buckets']} buckets "
          f"a step, peak memory {peak_gb:.2f} GB, losses "
          f"{[round(v, 5) for v in losses]}")
    print(f"(a) {name}: device busy {prof['device_busy_ms_per_step']:.2f} "
          f"ms a step ({prof['busy_share']:.3f} of "
          f"{prof['wall_ms_per_step']:.2f} ms traced), "
          f"{prof['kernels_per_step']:.0f} kernels a step, perfscope "
          f"dispatch share {out['dispatch_share']}; ms a step by family "
          + ", ".join(f"{k} {v:.2f}"
                      for k, v in prof["family_ms_per_step"].items()))
    need(all(math.isfinite(v) for v in losses),
         f"phase 12 (a) {name}: non-finite loss {losses}")
    need(sum(counts.values()) == 0,
         f"phase 12 (a) {name}: a kernel of ours ran: {counts}")
    if name == "inception3":
        need(len(moved) == len(before) == 188,
             f"phase 12 (a): {len(moved)} of {len(before)} BN stats moved")
    else:
        need(not before, f"phase 12 (a) {name} holds buffers")
    return out


def _seeded_bn_stats(model, seed):
    """Running stats from a seed (means N(0, 0.1²), vars U(0.5, 1.5)),
    so eval mode normalises with values unlike the init's."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith(".mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            else:
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)


def host_check(dev):
    """Phase 12 (b): one f32 forward and backward at batch 2 of the same
    model, from the same weights on the same batch, on the card and on
    the host (which tests/test_torch_models.py holds against the JAX
    models), tf32 off: VGG-16 at 64², 10 classes; Inception V3 at 75²,
    10 classes, in eval mode with seeded running stats (in train mode at
    75² a batch of 2 leaves count-2 BNs, where even the JAX model's two
    lowerings differ by 27%); and Inception's train-mode loss at 299²
    (the forward, well conditioned there). The loss and the largest
    |gradient| within TOL_HOST, relative."""
    import torch
    from horovod_tpu_torch.models import inception, vgg
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        cases = [("vgg16", 64, True), ("inception3", 75, False),
                 ("inception3", 299, True)]
        for name, image, train in cases:
            if name == "vgg16":
                host = vgg.VGG(16, num_classes=10, image_size=image)
            else:
                host = inception.InceptionV3(num_classes=10)
                if not train:
                    _seeded_bn_stats(host, 3)
            card = copy.deepcopy(host).to(dev)
            g = torch.Generator().manual_seed(11)
            x = torch.randn(2, image, image, 3, generator=g)
            y = torch.randint(0, 10, (2,), generator=g)
            res = {}
            grads = image != 299
            for where, m in (("host", host), ("card", card)):
                batch = (x.to(next(m.parameters()).device),
                         y.to(next(m.parameters()).device))
                with torch.set_grad_enabled(grads):
                    loss = vgg.loss_fn(m, batch) if name == "vgg16" else \
                        inception.loss_fn(m, batch, train=train)[0]
                res[where] = {"loss": float(loss.detach())}
                if grads:
                    loss.backward()
                    res[where]["max_grad"] = max(
                        float(p.grad.abs().max()) for p in m.parameters())
            tag = f"{name} {image}² {'train' if train else 'eval'}"
            rel = {k: abs(res["card"][k] - res["host"][k]) /
                   abs(res["host"][k]) for k in res["host"]}
            out[tag] = dict(res, rel=rel)
            print(f"(b) {tag}: card {res['card']}, host {res['host']}, "
                  f"relative differences {rel} (tolerance {TOL_HOST})")
            need(all(math.isfinite(v) for r in res.values()
                     for v in r.values()), f"phase 12 (b) {tag}: "
                 "non-finite value")
            need(all(v <= TOL_HOST for v in rel.values()),
                 f"phase 12 (b) {tag}: the card and the host disagree")
            del card
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    torch.cuda.empty_cache()
    return out


def pool_check(dev):
    """Phase 12 (c): ops/pooling.max_pool's forward and backward on the
    card equal the host's bit for bit, in f32 and bf16, on Inception's
    stem pool (3x3/2 VALID, 2 x 147 x 147 x 64: overlapping windows)
    and VGG's (2x2/2 VALID, 2 x 224 x 224 x 64), for an all-zero input
    (every window a tie) and post-ReLU data (about half zeros). The
    cotangents are small integers, whose sums are exact in either
    order, so every bit of the gradient is where the first-max rule put
    it."""
    import torch
    from horovod_tpu_torch.ops.pooling import max_pool
    g = torch.Generator().manual_seed(5)
    cases = 0
    for shape, win in (((2, 147, 147, 64), 3), ((2, 224, 224, 64), 2)):
        for kind in ("zeros", "relu"):
            base = torch.zeros(shape) if kind == "zeros" else \
                torch.relu(torch.round(torch.randn(shape, generator=g) * 2)
                           / 2)
            for dt in (torch.float32, torch.bfloat16):
                res = []
                for d in ("cpu", dev):
                    x = base.to(d, dt).clone().requires_grad_()
                    yv = max_pool(x, (win, win), (2, 2), "VALID")
                    ct = torch.randint(
                        1, 8, yv.shape,
                        generator=torch.Generator().manual_seed(6)).to(dt)
                    (yv * ct.to(d)).sum().backward()
                    res.append((yv.detach().cpu(), x.grad.cpu()))
                what = f"{win}x{win}/2 {tuple(shape)} {kind} {dt}"
                need(torch.equal(res[0][0], res[1][0]),
                     f"phase 12 (c) {what}: forward differs")
                need(torch.equal(res[0][1], res[1][1]),
                     f"phase 12 (c) {what}: gradient differs")
                cases += 1
    print(f"(c) max_pool: {cases} cases (3x3/2 and 2x2/2, all-zero and "
          f"post-ReLU, f32 and bf16), forward and gradient on the card "
          f"equal to the host's bit for bit")
    return cases


def inplace_check(dev):
    """Phase 12 (d): every in-place form on CUDA tensors over NCCL in a
    world of 1, bf16 and f32, leaves the same tensor (data_ptr
    unchanged) holding exactly what the out-of-place form returns;
    grouped_allgather_async and grouped_reducescatter_async equal their
    synchronous forms; the build queries of the card's build."""
    import torch
    import horovod_tpu_torch as hvd
    g = torch.Generator(device=dev).manual_seed(9)
    cases = 0

    def same(what, r, t, ptr, want):
        nonlocal cases
        need(r is t and t.data_ptr() == ptr and t.is_cuda,
             f"phase 12 (d) {what}: not written into the caller's tensor")
        need(torch.equal(t, want), f"phase 12 (d) {what}: differs from "
             "the out-of-place form")
        cases += 1

    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(4099, 3, generator=g, device=dev).to(dt)
        x2 = torch.randn(7, 5, generator=g, device=dev).to(dt)
        for op in (hvd.Average, hvd.Sum, hvd.Max, hvd.Product, hvd.Adasum):
            t = x.clone()
            ptr = t.data_ptr()
            same(f"allreduce_ {op.name} {dt}", hvd.allreduce_(t, op=op), t,
                 ptr, hvd.allreduce(x, op=op))
            t = x.clone()
            ptr = t.data_ptr()
            h = hvd.allreduce_async_(t, op=op, name=f"p12.{op.name}")
            same(f"allreduce_async_ {op.name} {dt}", hvd.synchronize(h), t,
                 ptr, hvd.allreduce(x, op=op))
        group = [x.clone(), x2.clone()]
        ptrs = [t.data_ptr() for t in group]
        got = hvd.grouped_allreduce_(group, op=hvd.Sum)
        for r, t, p, w in zip(got, group, ptrs,
                              hvd.grouped_allreduce([x, x2], op=hvd.Sum)):
            same(f"grouped_allreduce_ {dt}", r, t, p, w)
        group = [x.clone(), x2.clone()]
        ptrs = [t.data_ptr() for t in group]
        got = hvd.synchronize(hvd.grouped_allreduce_async_(group))
        for r, t, p, w in zip(got, group, ptrs,
                              hvd.grouped_allreduce([x, x2])):
            same(f"grouped_allreduce_async_ {dt}", r, t, p, w)
        t = x.clone()
        ptr = t.data_ptr()
        same(f"broadcast_ {dt}", hvd.broadcast_(t, 0), t, ptr,
             hvd.broadcast(x, 0))
        t = x.clone()
        ptr = t.data_ptr()
        same(f"broadcast_async_ {dt}",
             hvd.synchronize(hvd.broadcast_async_(t, 0)), t, ptr,
             hvd.broadcast(x, 0))
        for what, a, b in (
                ("grouped_allgather_async",
                 hvd.synchronize(hvd.grouped_allgather_async([x, x2])),
                 hvd.grouped_allgather([x, x2])),
                ("grouped_reducescatter_async",
                 hvd.synchronize(hvd.grouped_reducescatter_async([x, x2])),
                 hvd.grouped_reducescatter([x, x2]))):
            need(all(u.is_cuda and torch.equal(u, v) for u, v in zip(a, b)),
                 f"phase 12 (d) {what} {dt}: differs from the synchronous "
                 "form")
            cases += 1
    queries = {q: getattr(hvd, q)() for q in (
        "nccl_built", "cuda_built", "gloo_built", "mpi_built", "rocm_built",
        "tpu_built", "gloo_enabled", "mpi_enabled")}
    queries["local_slot_ranks"] = hvd.local_slot_ranks()
    print(f"(d) {cases} in-place and grouped async cases on the card equal "
          f"their out-of-place forms; queries {queries}")
    need(queries["nccl_built"] and queries["cuda_built"],
         "phase 12 (d): nccl_built() or cuda_built() is False on the card")
    need(not queries["gloo_enabled"] and queries["local_slot_ranks"] == [0],
         f"phase 12 (d): queries {queries}")
    return dict(cases=cases, queries=queries)


def _sbn_close(what, got, want, tol):
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    need(err <= tol * scale, f"phase 12 (e) {what}: {err:.3g} against "
         f"{tol} of {scale:.3g}")
    return err / scale


def _sbn_inputs(dev):
    """The batch of 8 images (8 x 8 x 64, channels with offsets so that
    E[x]² is not small against var), its cotangent, scale and bias."""
    import torch
    g = torch.Generator().manual_seed(13)
    x = torch.randn(sum(SBN_BATCHES), 8, 8, SBN_C, generator=g) * 2 + \
        torch.arange(SBN_C) / 8
    ct = torch.randn(x.shape, generator=g)
    scale = torch.rand(SBN_C, generator=g) + 0.5
    bias = torch.randn(SBN_C, generator=g) * 0.5
    return [t.to(dev) for t in (x, ct, scale, bias)]


def _sbn_forward(x, ct, scale, bias):
    """One SyncBatchNorm over its process set, train mode: (out, dx,
    running mean, running var)."""
    import torch
    import horovod_tpu_torch as hvd
    layer = hvd.SyncBatchNorm(SBN_C, device=x.device)
    with torch.no_grad():
        layer.scale.copy_(scale)
        layer.bias.copy_(bias)
    x = x.detach().clone().requires_grad_()
    y = layer(x)
    (y * ct).sum().backward()
    return y.detach(), x.grad, layer.running_mean, layer.running_var


def sbn_rank() -> dict:
    """One rank of phase 12 (e)'s world of 2 (under runner.run): its
    slice (3 or 5 images) of the batch through SyncBatchNorm."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        r, dev = hvd.rank(), hvd.device()
        x, ct, scale, bias = _sbn_inputs(dev)
        lo = sum(SBN_BATCHES[:r])
        sl = slice(lo, lo + SBN_BATCHES[r])
        y, dx, m, v = _sbn_forward(x[sl], ct[sl], scale, bias)
        return {"y": y.cpu(), "dx": dx.cpu(), "mean": m.cpu(),
                "var": v.cpu(), "device": torch.cuda.get_device_name(dev)}
    finally:
        hvd.shutdown()


def sbn_check(dev):
    """Phase 12 (e): SyncBatchNorm on the card. In this world of 1 it
    equals the JAX-formula BN (ops/sync_batch_norm.batch_norm, no group)
    of the same batch: output, input gradient and running stats. With
    two or more cards, a world of 2 through runner.run with per-rank
    batches of 3 and 5 gives each rank's slice of the output and input
    gradient, and the running stats, of one SyncBatchNorm over the
    concatenated 8 on one card."""
    import torch
    from horovod_tpu_torch.ops import sync_batch_norm as sbn
    x, ct, scale, bias = _sbn_inputs(dev)
    y, dx, m, v = _sbn_forward(x, ct, scale, bias)
    x2 = x.clone().requires_grad_()
    want, (wm, wv) = sbn.batch_norm(x2, scale, bias,
                                    torch.zeros(SBN_C, device=dev),
                                    torch.ones(SBN_C, device=dev), True)
    (want * ct).sum().backward()
    out = {"world1": {
        "out": _sbn_close("world of 1: output", y, want.detach(), TOL_SBN),
        "dx": _sbn_close("world of 1: dx", dx, x2.grad, TOL_SBN),
        "mean": _sbn_close("world of 1: mean", m, wm, TOL_SBN_STATS),
        "var": _sbn_close("world of 1: var", v, wv, TOL_SBN_STATS)}}
    print(f"(e) SyncBatchNorm, world of 1, against the JAX-formula BN: "
          f"relative errors {out['world1']}")
    cards = torch.cuda.device_count()
    if cards < 2:
        print("phase 12 (e): one card; the world of 2 (batches 3 and 5) "
              "needs two or more")
        out["world2"] = None
        return out
    from horovod_tpu_torch import runner
    # By its module's name, so that the workers can import it when this
    # file runs as __main__ (pickle refers to a function by its module).
    from chip_smoke import sbn_rank as rank_fn
    res = runner.run(rank_fn, np=2, timeout=180)
    errs = {}
    for r, rr in enumerate(res):
        lo = sum(SBN_BATCHES[:r])
        sl = slice(lo, lo + SBN_BATCHES[r])
        errs[r] = {
            "out": _sbn_close(f"rank {r} output", rr["y"], y[sl].cpu(),
                              TOL_SBN),
            "dx": _sbn_close(f"rank {r} dx", rr["dx"], dx[sl].cpu(),
                             TOL_SBN),
            "mean": _sbn_close(f"rank {r} mean", rr["mean"], m.cpu(),
                               TOL_SBN_STATS),
            "var": _sbn_close(f"rank {r} var", rr["var"], v.cpu(),
                              TOL_SBN_STATS)}
    out["world2"] = errs
    print(f"(e) SyncBatchNorm, world of 2 (batches {SBN_BATCHES}) on "
          f"{res[0]['device']}, against one over all 8: relative errors "
          f"{errs}")
    return out


def launched_models():
    """Phase 12 (f): the launcher starts the synthetic benchmark with
    --model inception3 on one rank, which prints its img/s; with two or
    more cards `--scaling-report min(4, count) --model vgg16` prints its
    JSON line (recorded, not gated)."""
    import torch
    py = sys.executable
    out = {}
    rc, text = run_bounded(
        [py, "-m", "horovod_tpu_torch.runner.launch", "-np", "1", py, "-m",
         "horovod_tpu_torch.synthetic_benchmark", "--model", "inception3",
         "--num-iters", "2"], 600)
    print("\n".join("(f) launch: " + ln for ln in text.splitlines()
                    if "<stdout>:" in ln))
    need(rc == 0, f"phase 12 (f): the launched benchmark exited {rc}")
    rate = [float(ln.rsplit(":", 1)[1]) for ln in text.splitlines()
            if "Img/sec per rank:" in ln]
    need(len(rate) == 1 and rate[0] > 0 and
         any("Model: inception3" in ln and "299²" in ln
             for ln in text.splitlines()),
         "phase 12 (f): no Img/sec per rank figure for inception3 at 299²")
    out["inception3_img_per_s"] = rate[0]
    cards = torch.cuda.device_count()
    if cards < 2:
        print("phase 12 (f): one card; the vgg16 scaling report needs two "
              "or more")
        out["scaling_report"] = None
        return out
    n = min(4, cards)
    rc, text = run_bounded(
        [py, "-m", "horovod_tpu_torch.synthetic_benchmark", "--model",
         "vgg16", "--num-iters", "2", "--scaling-report", str(n)], 600)
    last = text.strip().splitlines()[-1] if text.strip() else ""
    print(f"(f) --scaling-report {n} --model vgg16 exited {rc}: {last}")
    out["scaling_report"] = dict(rc=rc, line=last)
    return out


def other_models_path():
    """Phase 12: the benchmark's other models and the API surface, (a)
    to (f) above, in a world of 1 on NCCL."""
    import torch
    import horovod_tpu_torch as hvd
    t0 = time.perf_counter()
    hvd.init()
    try:
        dev = hvd.device()
        need(dev.type == "cuda", "phase 12 is not on the card")
        out = {"a": {"vgg16": other_model_run("vgg16", 224, lr=VGG_LR),
                     "inception3": other_model_run("inception3", 299)}}
        torch.cuda.empty_cache()
        out["vgg19_loss"] = vgg19_step()
        out["b"] = host_check(dev)
        out["c"] = pool_check(dev)
        out["d"] = inplace_check(dev)
        out["e"] = sbn_check(dev)
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    out["f"] = launched_models()
    out["seconds"] = time.perf_counter() - t0
    return out


def vgg19_step():
    """Phase 12 (a): one VGG-19 step (224², bf16, batch 32); its loss
    finite."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    dev = hvd.device()
    model = sb.build("vgg19", torch.bfloat16, dev)
    opt = sb.make_optimizer(model)
    data = sb.make_batch(32, 224, torch.bfloat16, dev, seed=hvd.rank())
    loss = float(sb.train_step(model, opt, data, dist.group.WORLD))
    for h in opt._hooks:
        h.remove()
    del model, opt
    torch.cuda.empty_cache()
    print(f"(a) vgg19 224² bf16 batch 32: one step, loss {loss:.5f}")
    need(math.isfinite(loss), f"phase 12 (a) vgg19: loss {loss}")
    return loss


# ------------------------------------- phase 13: observability, control

OBS_OFF = {"HOROVOD_METRICS": "0", "HOROVOD_FLIGHT": "0",
           "HOROVOD_TRACE": "0"}
STALL_WINDOW_S = 10     # phase 13 (b), two or more cards: the shutdown
STALL_MARGIN_S = 5.0    # window, and what the raise may lag it by (the
                        # backward pass before the wait, the poll, the
                        # NCCL abort, the flight dump)


def _observability_anew(env: dict) -> None:
    """Set or clear the observability gates and drop the process's
    registry, recorder and tracer, so the next use reads them anew."""
    from horovod_tpu_torch.observability import flight, metrics, tracing
    for k in OBS_OFF:
        if k in env:
            os.environ[k] = env[k]
        else:
            os.environ.pop(k, None)
    metrics.reset_for_tests()
    flight.reset_for_tests()
    tracing.reset_for_tests()


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def _allreduce_counts(snap: dict) -> tuple:
    """(calls, bytes) of op allreduce in a metrics snapshot, all dtypes."""
    fams = snap.get("families", {})

    def total(name):
        return sum(s["value"] for s in fams.get(name, {}).get("series", [])
                   if s["labels"][0] == "allreduce")

    return (total("horovod_collective_calls_total"),
            total("horovod_collective_bytes_total"))


def watchdog_us(dev, n: int = 3000) -> dict:
    """Host µs of one wait on a finished bucket's Work: the bare
    `Work.wait()`, `guarded_wait` with the defaults (the stall
    inspector's bookkeeping) and with a shutdown window (the polling
    watchdog)."""
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.ops import collectives
    x = torch.ones(1024, device=dev)
    work = dist.all_reduce(x, async_op=True)
    work.wait()
    torch.cuda.synchronize()
    cfg = topology.config()

    def per_call(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    out = {"bare_us": per_call(work.wait), "default_us": per_call(
        lambda: collectives.guarded_wait(work, "bucketed_allreduce/b0"))}
    saved = cfg.stall_shutdown_seconds
    cfg.stall_shutdown_seconds = 120.0
    try:
        out["window_us"] = per_call(
            lambda: collectives.guarded_wait(work, "bucketed_allreduce/b0"))
    finally:
        cfg.stall_shutdown_seconds = saved
    out["default_extra_us"] = out["default_us"] - out["bare_us"]
    out["window_extra_us"] = out["window_us"] - out["bare_us"]
    return out


def observability_in_process(warmup: int = 2, timed: int = 5) -> dict:
    """Phase 13 (a): the phase-4 ResNet-50 step (224², bf16, batch 32,
    HOROVOD_CONV_BLOCK=1) with metrics, flight and tracing at their
    defaults (on), then from the same weights and batch with all three
    off, four times each in ABBA order (the host-bound step moves
    between runs by more than the cost sought): equal losses, 28
    launches each of kernels 1 and 2 a step, the metrics' calls and
    bytes those of the bucket plan; ms/step on and off, the ratio of
    their medians; the watchdog's host µs a bucket."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    saved = {k: os.environ.get(k) for k in
             ("HOROVOD_CONV_BLOCK", "HOROVOD_FUSE_CONV_BN", *OBS_OFF)}
    det = torch.backends.cudnn.deterministic
    os.environ.update(HOROVOD_CONV_BLOCK="1", HOROVOD_FUSE_CONV_BN="0")
    torch.backends.cudnn.deterministic = True
    _observability_anew({})
    hvd.init()
    try:
        dev = hvd.device()
        need(dev.type == "cuda", "phase 13 is not on the card")
        model = sb.build("resnet50", torch.bfloat16, dev)
        opt = sb.make_optimizer(model)
        data = sb.make_batch(32, 224, torch.bfloat16, dev, seed=hvd.rank())
        group = dist.group.WORLD
        snap_m = copy.deepcopy(model.state_dict())
        snap_o = copy.deepcopy(opt.state_dict())
        steps = warmup + timed
        runs = []
        for mode in ("on", "off", "off", "on") * 2:
            _observability_anew(OBS_OFF if mode == "off" else {})
            model.load_state_dict(snap_m)
            opt.load_state_dict(snap_o)
            losses, ips, ms, counts = drive(sb, model, opt, data, group,
                                            warmup, timed)
            calls, nbytes = _allreduce_counts(hvd.metrics())
            runs.append(dict(mode=mode, losses=losses, img_per_s=ips,
                             step_ms=ms, launches=counts, calls=calls,
                             bytes=nbytes))
            print(f"(a) observability {mode}: {ms:.2f} ms/step, {ips:.1f} "
                  f"img/s; losses {[round(v, 6) for v in losses]}; "
                  f"launches {counts}; allreduce calls {calls:.0f}, bytes "
                  f"{nbytes:.0f}")
            need(counts["fwd"] == 28 * steps
                 and counts["act_bwd"] == 28 * steps,
                 f"phase 13 (a) {mode}: expected 28 + 28 launches a step, "
                 f"got {counts}")
        want_calls = steps * len(opt.plan)
        want_bytes = steps * opt.plan_bytes * hvd.size()
        for r in runs:
            need(r["losses"] == runs[0]["losses"],
                 f"phase 13 (a): the losses with observability {r['mode']} "
                 f"differ: {r['losses']} against {runs[0]['losses']}")
            if r["mode"] == "on":
                need(r["calls"] == want_calls and r["bytes"] == want_bytes,
                     f"phase 13 (a): metrics count {r['calls']} calls, "
                     f"{r['bytes']} bytes; the bucket plan implies "
                     f"{want_calls}, {want_bytes}")
            else:
                need(r["calls"] == 0, "phase 13 (a): HOROVOD_METRICS=0 "
                     "still counted")
        on = [r["step_ms"] for r in runs if r["mode"] == "on"]
        off = [r["step_ms"] for r in runs if r["mode"] == "off"]
        ratio = _median(on) / _median(off)
        wd = watchdog_us(dev)
        out = dict(runs=runs, buckets=len(opt.plan),
                   plan_bytes=opt.plan_bytes, want_calls=want_calls,
                   want_bytes=want_bytes, on_ms=on, off_ms=off,
                   ratio=ratio, watchdog=wd,
                   per_step_watchdog_us=wd["default_extra_us"]
                   * len(opt.plan))
        print(f"(a) ms/step with observability on {on}, off {off}: ratio "
              f"of the medians {ratio:.4f}; {len(opt.plan)} buckets a step, "
              f"metrics "
              f"{want_calls} calls and {want_bytes} bytes over {steps} "
              f"steps as the plan implies")
        print(f"(a) watchdog host µs a bucket: bare Work.wait "
              f"{wd['bare_us']:.2f}, guarded {wd['default_us']:.2f} "
              f"(+{wd['default_extra_us']:.2f}), with a shutdown window "
              f"{wd['window_us']:.2f} (+{wd['window_extra_us']:.2f})")
        for h in opt._hooks:
            h.remove()
        del model, opt
    finally:
        hvd.shutdown()
        torch.backends.cudnn.deterministic = det
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _observability_anew({k: v for k, v in saved.items()
                             if k in OBS_OFF and v is not None})
        torch.cuda.empty_cache()
    return out


def _scrape_while_running(cmd, env, port_file, dtype="bfloat16",
                          timeout=600):
    """Run `cmd` in its own session; while it runs, scrape `GET /metrics`
    from the rendezvous endpoint it announces until rank 0's collective
    counters show. Returns (exit code, output, scrape text, scrape ms)."""
    import signal
    import urllib.request
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    chunks = []
    reader = __import__("threading").Thread(
        target=lambda: chunks.append(proc.stdout.read()), daemon=True)
    reader.start()
    end = time.monotonic() + timeout
    text, scrape_ms = "", []
    want = ('horovod_collective_calls_total{op="allreduce",'
            f'dtype="{dtype}",rank="0"}}')
    while proc.poll() is None and time.monotonic() < end:
        try:
            ep = open(port_file).read().split(",")[0]
            t0 = time.perf_counter()
            text = urllib.request.urlopen(f"http://{ep}/metrics",
                                          timeout=5).read().decode()
            scrape_ms.append((time.perf_counter() - t0) * 1e3)
            if want in text:
                break
        except (OSError, ValueError):
            pass
        time.sleep(0.5)
    try:
        proc.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        raise Failed(f"{' '.join(cmd)}: still running after {timeout} s")
    reader.join(30)
    return proc.returncode, "".join(chunks), text, scrape_ms


def observability_launched(bench_extra=(), dtype="bfloat16",
                           multi: bool = True) -> dict:
    """Phase 13 (b): `runner.launch -np 1` of the synthetic benchmark
    with --stall-check, HOROVOD_CHECK_COLLECTIVES=1, the native KV server
    and HOROVOD_FLIGHT_DIR; `GET /metrics` scraped while it runs must
    hold rank 0's collective counters, and at exit the flight tail, the
    trace spans and the exit dump must be in the directory. With two or
    more cards, a world of min(4, count) with the consistency check, and
    one in which rank 1 sleeps past the shutdown window as it launches
    its first gradient bucket: every other rank raises
    HorovodInternalError naming the collective it waits on within the
    window plus STALL_MARGIN_S, and each rank's flight records name the
    bucketed all-reduce. `bench_extra` (the benchmark's flags) and
    `dtype` let the same checks run on the host (--device cpu)."""
    import shutil
    import torch
    py = sys.executable
    base = os.path.join("chiprun_out", "observe13")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    flight = os.path.join(base, "flight")
    port_file = os.path.join(base, "rdv.port")
    env = dict(os.environ, HOROVOD_CONV_BLOCK="1", HOROVOD_FUSE_CONV_BN="0",
               HOROVOD_CHECK_COLLECTIVES="1", HOROVOD_FLIGHT_DIR=flight,
               HOROVOD_RENDEZVOUS_PORT_FILE=port_file,
               HOROVOD_METRICS_PUSH_INTERVAL="0.5")
    cmd = [py, "-m", "horovod_tpu_torch.runner.launch", "-np", "1",
           "--stall-check", "--stall-check-warning-time-seconds", "60",
           "--stall-check-shutdown-time-seconds", "120", py, "-m",
           "horovod_tpu_torch.synthetic_benchmark", "--batch-size", "32",
           "--num-iters", "6", *bench_extra]
    t0 = time.perf_counter()
    rc, text, scrape, scrape_ms = _scrape_while_running(cmd, env, port_file,
                                                        dtype)
    print("\n".join("(b) launch: " + ln for ln in text.splitlines()
                    if "<stdout>:" in ln))
    need(rc == 0, f"phase 13 (b): the launched benchmark exited {rc}: "
         f"{text[-3000:]}")
    plane = [json.loads(ln.split("Control plane: ", 1)[1])
             for ln in text.splitlines() if "Control plane: " in ln]
    need(len(plane) == 1 and plane[0]["native"] == "native"
         and plane[0]["native_kv"] and plane[0]["stall_check"]
         and plane[0]["stall_check"]["shutdown_s"] == 120
         and plane[0]["metrics"] and plane[0]["flight"]
         and plane[0]["trace"],
         f"phase 13 (b): the control plane is not all on: {plane}")
    want = ('horovod_collective_calls_total{op="allreduce",'
            f'dtype="{dtype}",rank="0"}}')
    got = [ln for ln in scrape.splitlines() if ln.startswith(want)]
    need(bool(got), "phase 13 (b): the /metrics scrape does not hold rank "
         "0's collective counters")
    files = sorted(os.listdir(flight))
    need({"kv-tail-rank-0.r0.json", "trace-kv-rank-0.r0.json", "0.json",
          "perf-rank-0.r0.json"} <= set(files),
         f"phase 13 (b): the flight directory holds {files}")
    tail = json.load(open(os.path.join(flight, "kv-tail-rank-0.r0.json")))
    spans = json.load(open(os.path.join(flight, "trace-kv-rank-0.r0.json")))
    coll = [e for e in tail["events"] if e[2] == "collective"]
    steps = [t for t in spans.get("traces", [])
             if any(s["name"] == "train.step" for s in t["spans"])]
    need(bool(coll) and bool(steps), "phase 13 (b): no collective record "
         "in the flight tail or no train.step span in the trace")
    out = dict(control_plane=plane[0], scrape_line=got[0],
               scrape_ms=scrape_ms, flight_files=files,
               tail_collectives=len(coll), trace_steps=len(steps),
               seconds=time.perf_counter() - t0)
    print(f"(b) control plane {plane[0]}; scrape {got[0]} "
          f"({len(scrape_ms)} scrapes, last {scrape_ms[-1]:.2f} ms); "
          f"flight directory {files}; {len(coll)} collective records in "
          f"the tail, {len(steps)} train.step traces; "
          f"{out['seconds']:.1f} s")
    cards = torch.cuda.device_count()
    if not multi:
        return out
    if cards < 2:
        print("phase 13 (b): one card; the world of min(4, count) and the "
              "stalled rank need two or more")
        out["world"] = None
        return out
    out["world"] = observability_world(min(4, cards), base)
    return out


def observability_world(n: int, base: str, bench_extra=()) -> dict:
    """Phase 13 (b) with n cards: a run with the consistency check, then
    the stalled rank (see observability_launched)."""
    py = sys.executable
    out = {}
    bench = [py, "-m", "horovod_tpu_torch.synthetic_benchmark",
             "--batch-size", "32", "--num-iters", "2", *bench_extra]
    env = dict(os.environ, HOROVOD_CONV_BLOCK="1", HOROVOD_FUSE_CONV_BN="0",
               HOROVOD_CONSISTENCY_CHECK="1")
    rc, text = run_bounded([py, "-m", "horovod_tpu_torch.runner.launch",
                            "-np", str(n), *bench], 600, env=env)
    plane = [json.loads(ln.split("Control plane: ", 1)[1])
             for ln in text.splitlines() if "Control plane: " in ln]
    need(rc == 0 and plane and plane[0]["consistency_check"],
         f"phase 13 (b): the world of {n} with the consistency check: rc "
         f"{rc}, {plane}: {text[-3000:]}")
    rate = [float(ln.rsplit(":", 1)[1]) for ln in text.splitlines()
            if "Img/sec per rank:" in ln]
    out["checked"] = dict(img_per_s_per_rank=rate[0] if rate else None,
                          control_plane=plane[0])
    print(f"(b) world of {n} with the consistency check: {rate} img/s per "
          f"rank; {plane[0]}")
    flight = os.path.join(base, f"flight{n}")
    env.update(HOROVOD_FLIGHT_DIR=flight, HOROVOD_FAULT_SPEC=(
        "site=collective.dispatch,kind=latency,"
        f"ms={int(STALL_WINDOW_S * 2500)},"
        "match=rank1:bucketed_allreduce,count=1"))
    t0 = time.perf_counter()
    rc, text = run_bounded(
        [py, "-m", "horovod_tpu_torch.runner.launch", "-np", str(n),
         "--stall-check-warning-time-seconds", str(STALL_WINDOW_S // 2),
         "--stall-check-shutdown-time-seconds", str(STALL_WINDOW_S),
         *bench], 600, env=env)
    need(rc != 0, "phase 13 (b): the stalled world exited 0")
    raised = {}
    for r in range(n):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(f"[{r}]") and "HorovodInternalError" in ln
                 and "stalled past HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="
                 f"{STALL_WINDOW_S}s" in ln]
        if lines:
            raised[r] = lines[0].split("HorovodInternalError: ", 1)[-1]
    others = [r for r in range(n) if r != 1]
    need(set(others) <= set(raised),
         f"phase 13 (b): ranks {sorted(set(others) - set(raised))} did not "
         f"raise HorovodInternalError: {text[-4000:]}")
    lags, named = {}, {}
    for r in range(n):
        body = None
        for name in (f"{r}.json", f"kv-tail-rank-{r}.r0.json"):
            path = os.path.join(flight, name)
            if os.path.exists(path):
                body = json.load(open(path))
                break
        need(body is not None, f"phase 13 (b): no flight record of rank {r}")
        evs = body["events"]
        named[r] = any("bucketed_allreduce" in str(e[3]) for e in evs)
        stall = [e for e in evs if e[2] == "stall" and "past" in e[3]]
        disp = [e for e in evs if e[2] == "collective"
                and e[4] == "bucketed_allreduce"]
        if r != 1:
            need(bool(stall) and bool(disp), f"phase 13 (b): rank {r}'s "
                 f"flight dump has no stall or no dispatch record")
            lags[r] = stall[-1][1] - disp[-1][1]
            need(STALL_WINDOW_S <= lags[r] <= STALL_WINDOW_S
                 + STALL_MARGIN_S, f"phase 13 (b): rank {r} raised "
                 f"{lags[r]:.2f} s after the step's dispatch")
    need(all(named.values()), f"phase 13 (b): flight records naming the "
         f"all-reduce: {named}")
    out["stalled"] = dict(raised=raised, lag_s=lags, named=named,
                          seconds=time.perf_counter() - t0)
    print(f"(b) stalled rank 1 in a world of {n}: ranks {sorted(raised)} "
          f"raised {set(raised.values())}; dispatch to raise "
          f"{ {r: round(v, 3) for r, v in lags.items()} } s (window "
          f"{STALL_WINDOW_S} s, margin {STALL_MARGIN_S} s); flight records "
          f"name it {named}")
    return out


def observability_path() -> dict:
    """Phase 13: (a) then (b)."""
    t0 = time.perf_counter()
    out = {"a": observability_in_process(), "b": observability_launched()}
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------- phase 14: serving

SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_REQUESTS = 64
SERVE_CLIENTS = 4
SERVE_KILL_AFTER = 16       # (b), two or more cards: responses before
                            # the SIGKILL
WATCH_FAULT_MS = 1500       # (c): the latency injected into 3 steps, many
                            # times the ResNet step's 1.2-2.8x spread
WATCH_STEPS = 24            # (c): steps of each run; the fault hits
WATCH_FAULT_AFTER = 12      # steps 13-15


def serve_infer(model, tokens):
    """The served function: the last position's logits in f32 (a
    response is V·4 bytes, not S·V·2)."""
    return model(tokens.long())[:, -1, :].float()


def _serve_cfg(over=None):
    """The served model: the flagship LM, bf16, attn="flash". `over`
    (TransformerConfig fields, dtype by name) shrinks it for a rehearsal
    on the host; main() passes none."""
    import torch
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm
    kw = dict(lm.FLAGSHIP, attn="flash", dtype=torch.bfloat16)
    kw.update(over or {})
    if isinstance(kw["dtype"], str):
        kw["dtype"] = getattr(torch, kw["dtype"])
    return tfm.TransformerConfig(**kw)


def _rel(got, ref) -> float:
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _flash_fwd_names(names):
    """(Hopper, simple) instance launches of kernel 4 among kernel names."""
    hop = sum("flash::fwd_hopper" in n for n in names)
    simple = sum("flash::fwd_kernel" in n for n in names)
    return hop, simple


def _replays(events, gap_us: float = 5000.0):
    """Kernel names of a trace of replays made apart in time, one list
    a replay (split where the card idled for `gap_us`)."""
    out, last = [], None
    for name, start, end in sorted(events, key=lambda e: e[1]):
        if last is None or start - last > gap_us:
            out.append([])
        out[-1].append(name)
        last = end if last is None else max(last, end)
    return out


def serving_in_process(tmp: str) -> dict:
    """Phase 14 (a): the flagship LM (seed-0 weights, bf16, attn="flash")
    in an InferenceEngine on the card, one CUDA graph per bucket. Writes
    a params-only checkpoint root of the weights, the 64 requests' tokens
    and their logits from this engine into `tmp` for (b)."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from horovod_tpu_torch import ckpt
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.profiler import device_profile
    from horovod_tpu_torch.serve.engine import InferenceEngine

    dev = torch.device("cuda", 0)
    cfg = _serve_cfg()
    S, V = cfg.max_seq, cfg.vocab
    model = tfm.TransformerLM(cfg, seed=0, device=dev)
    eng = InferenceEngine(serve_infer, model, name="flagship", device=dev)
    reset_counters()
    t0 = time.perf_counter()
    eng.warmup((S,), np.int32, SERVE_BUCKETS)
    warm_s = time.perf_counter() - t0
    capture_calls = read_counters()["attn_fwd"]
    cap_s = eng.capture_seconds()
    need(eng.compiles == len(SERVE_BUCKETS)
         and sorted(cap_s) == list(SERVE_BUCKETS),
         f"(a): {eng.compiles} graphs for buckets {sorted(cap_s)}")
    print(f"(a) engine: L{cfg.n_layers} D{cfg.d_model} F{cfg.d_ff} "
          f"H{cfg.n_heads} S{S} V{V} bf16 attn=flash; {eng.compiles} "
          f"graphs in {warm_s:.1f} s, capture s per bucket "
          + json.dumps({b: round(s, 3) for b, s in sorted(cap_s.items())})
          + f"; kernel 4's wrapper called {capture_calls} times "
          f"(warm-up and capture, {cfg.n_layers} a forward)")
    tokens = np.random.default_rng(0).integers(
        0, V, (SERVE_REQUESTS, S)).astype(np.int32)
    buckets = {}
    for b in SERVE_BUCKETS:
        g = eng.compile_for((b, S), np.int32)
        x = tokens[:b]
        reset_counters()
        got = eng.infer(x)
        replay_calls = read_counters()["attn_fwd"]
        with torch.inference_mode():
            ref = serve_infer(model, torch.as_tensor(x, device=dev)) \
                .cpu().numpy()
        err = _rel(got, ref)

        def eager():
            with torch.inference_mode():
                serve_infer(model, g.static_in)

        replay_ms = device_ms(g.graph.replay, iters=5)
        eager_ms = device_ms(eager, iters=5)
        replay_wall = time_ms(g.graph.replay, iters=5)
        eager_wall = time_ms(eager, iters=5)
        # A trace of the whole script's process can come back with one
        # layer's records missing (seen on an H100; as in device_ms): four
        # replays 20 ms apart in one trace, split at the gaps, and the
        # fullest replay counts.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda.synchronize()
                time.sleep(0.02)
                g.graph.replay()
            torch.cuda.synchronize()
        traces = _replays(device_profile.kernel_events(prof))
        names = max(traces, key=len)
        hop, simple = _flash_fwd_names(names)
        buckets[b] = dict(max_rel_err=err, replay_ms=replay_ms,
                          eager_ms=eager_ms, replay_wall_ms=replay_wall,
                          eager_wall_ms=eager_wall, kernels=len(names),
                          kernels_per_replay=[len(t) for t in traces],
                          k4_hopper=hop, k4_simple=simple,
                          capture_s=cap_s[b], wrapper_calls=replay_calls)
        print(f"(a) bucket {b}: replay {replay_ms:.3f} ms device "
              f"({replay_wall:.3f} ms on the stream), eager "
              f"{eager_ms:.3f} ms device ({eager_wall:.3f} ms on the "
              f"stream); kernels in 4 traced replays "
              f"{[len(t) for t in traces]}, in the fullest kernel 4 "
              f"{hop} on the Hopper instance, {simple} on the simple one; "
              f"logits against the eager forward {err:.3g} (tolerance "
              f"{TOL_BF16})")
        need(err <= TOL_BF16, f"(a): bucket {b}'s replay disagrees with "
             f"the eager forward")
        need(hop == cfg.n_layers and simple == 0,
             f"(a): bucket {b}'s replay ran kernel 4 {hop} times on the "
             f"Hopper instance and {simple} on the simple one, not "
             f"{cfg.n_layers} and 0")
        need(replay_calls == 0, "(a): a replay went through kernel 4's "
             "wrapper (it should replay the captured launch)")
    # Padding never changes a real row.
    alone = eng.infer(tokens[:1])[0]
    padded = np.concatenate([tokens[:1], np.zeros((7, S), np.int32)])
    pad_err = _rel(eng.infer(padded)[0], alone)
    full = eng.infer(tokens[:8])
    row_err = max(_rel(full[i], eng.infer(tokens[i:i + 1])[0])
                  for i in range(8))
    print(f"(a) padding: a request at bucket 8 beside 7 zero rows against "
          f"it alone at bucket 1 {pad_err:.3g}; 8 requests at bucket 8 "
          f"against each alone, largest {row_err:.3g} (tolerance "
          f"{TOL_BF16})")
    need(pad_err <= TOL_BF16 and row_err <= TOL_BF16,
         "(a): a padded row changed a real row's logits")
    ref = np.concatenate([eng.infer(tokens[i:i + 8])
                          for i in range(0, SERVE_REQUESTS, 8)])
    need(eng.compiles == len(SERVE_BUCKETS), f"(a): {eng.compiles} "
         f"captures after warm-up, not {len(SERVE_BUCKETS)}")
    need(bool(np.isfinite(ref).all()) and ref.shape == (SERVE_REQUESTS, V),
         "(a): non-finite or misshapen logits")
    np.save(os.path.join(tmp, "tokens.npy"), tokens)
    np.save(os.path.join(tmp, "ref.npy"), ref)
    t0 = time.perf_counter()
    saver = ckpt.AsyncCheckpointer(os.path.join(tmp, "ckpt"))
    need(saver.save(0, {"params": model.state_dict()}, block=True),
         "(a): the checkpoint save was refused")
    saver.close()
    ckpt_s = time.perf_counter() - t0
    print(f"(a) params-only checkpoint root of the weights in "
          f"{ckpt_s:.1f} s")
    out = dict(capture_s=cap_s, warmup_s=warm_s, buckets=buckets,
               pad_err=pad_err, row_err=row_err, compiles=eng.compiles,
               capture_wrapper_calls=capture_calls, ckpt_s=ckpt_s,
               hlo_lint=eng.hlo_lint(),
               kernel_ops={b: _kernel_ops(p)
                           for b, p in eng.lint_programs().items()})
    del eng, model, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serving_replica(d: str, over=None, device=None) -> int:
    """Phase 14 (b)'s replica command (run by `python -m
    horovod_tpu_torch.serve`): the flagship LM restored params-only from
    (a)'s checkpoint root in `d` into a model of other weights, every
    bucket captured, served until the launcher drains it. `device` None
    is the engine's default, the card of this replica's local rank;
    "by-rank" is the card of its global rank; "cpu" the host (with `over`
    shrinking the model, a rehearsal off the card)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serve.engine import InferenceEngine, serve_device
    from horovod_tpu_torch.serve.replica import serve_replica

    host = os.environ.get("HOROVOD_HOSTNAME", "localhost")
    os.makedirs(os.path.join(d, "pids"), exist_ok=True)
    with open(os.path.join(d, "pids", host), "w") as f:
        f.write(str(os.getpid()))
    if device == "by-rank":
        device = torch.device("cuda", int(os.environ["HOROVOD_RANK"])
                              % torch.cuda.device_count())
    cfg = _serve_cfg(over)
    t0 = time.perf_counter()
    model = tfm.TransformerLM(cfg, seed=1, device=serve_device(device))
    eng = InferenceEngine.from_checkpoint(os.path.join(d, "ckpt"),
                                          serve_infer, model,
                                          name="flagship", device=device)
    dev = eng.device
    eng.warmup((cfg.max_seq,), np.int32, SERVE_BUCKETS)
    print(f"SERVE14_READY host={host} device={dev} graphs={eng.compiles} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    return serve_replica(eng)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def serving_launched(tmp: str, over=None, cpu: bool = False) -> int:
    """Phase 14 (b), run by `run_bounded` in a process of its own: `python
    -m horovod_tpu_torch.serve` with one replica per card (at most 2)
    over (a)'s checkpoint, 64 requests of S tokens from 4 client threads
    held against (a)'s logits, then the doctor over the flight
    directory. With two or more replicas one is SIGKILLed under load.
    Writes `tmp`/launched.json. `over` and `cpu` (two replicas on the
    host) are for a rehearsal off the card; main() passes neither."""
    import shutil
    import signal
    import threading
    import numpy as np
    import torch
    from horovod_tpu_torch.serve.frontend import (ServeClient,
                                                  wait_for_port_file)

    py = sys.executable
    slots = 2 if cpu else min(torch.cuda.device_count(), 2)
    # Each replica stands as a host of one slot (so the elastic driver
    # blacklists only a killed one), so each is local rank 0: with one
    # card the engine's default (cuda:<local rank>) places it; with two,
    # each takes the card of its global rank.
    device = "cpu" if cpu else "by-rank" if slots >= 2 else None
    tokens = np.load(os.path.join(tmp, "tokens.npy"))
    ref = np.load(os.path.join(tmp, "ref.npy"))
    hosts = os.path.join(tmp, "hosts.txt")
    with open(hosts, "w") as f:
        f.write("\n".join(["localhost:1", "127.0.0.1:1"][:slots]) + "\n")
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts}\n")
    os.chmod(script, 0o755)
    flight = os.path.abspath(os.path.join("chiprun_out", "serve14",
                                          "flight"))
    shutil.rmtree(flight, ignore_errors=True)  # this run's records only
    os.makedirs(flight)
    port_file = os.path.join(tmp, "serve.port")
    secret = "5e" * 32
    env = dict(os.environ, HOROVOD_SECRET_KEY=secret,
               HOROVOD_SERVE_PORT_FILE=port_file,
               HOROVOD_FLIGHT_DIR=flight, HOROVOD_TRACE_SAMPLE="1",
               HOROVOD_SERVE_MAX_BATCH=str(SERVE_BUCKETS[-1]),
               HOROVOD_SERVE_BUCKETS=",".join(map(str, SERVE_BUCKETS)),
               HOROVOD_SERVE_MAX_WAIT_MS="5",
               HOROVOD_SERVE_REPLICA_TIMEOUT="60",
               HOROVOD_METRICS_PUSH_INTERVAL="0.5")
    cmd = [py, "-m", "horovod_tpu_torch.serve", "--host-discovery-script",
           script, "--slots-per-host", "1", "--min-np", "1",
           "--elastic-timeout", "120", "--blacklist-cooldown-range", "300",
           "600", "--", py, "-c",
           "import sys, chip_smoke; sys.exit(chip_smoke.serving_replica("
           f"{tmp!r}, {over!r}, {device!r}))"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    out = {"replicas": slots, "victim": None}
    lock = threading.Lock()
    lat, errs, fails, done = {}, {}, [], [0]
    t_up = time.perf_counter()
    try:
        port = wait_for_port_file(port_file, timeout=120)
        addr = ("127.0.0.1", port)
        deadline = time.monotonic() + 240
        while sum("SERVE14_READY" in ln for ln in lines) < slots:
            need(proc.poll() is None and time.monotonic() < deadline,
                 "(b): the replicas did not come up:\n"
                 + "".join(lines)[-3000:])
            time.sleep(0.2)
        out["startup_s"] = time.perf_counter() - t_up
        out["devices"] = sorted(
            ln.split("SERVE14_READY")[1].split(" device=")[1].split()[0]
            for ln in lines if "SERVE14_READY" in ln)
        kill_at = SERVE_KILL_AFTER if slots >= 2 else None

        def client(tid):
            c = ServeClient(addr, secret=secret.encode())
            try:
                for i in range(tid, SERVE_REQUESTS, SERVE_CLIENTS):
                    t0 = time.perf_counter()
                    try:
                        got = c.infer(tokens[i])
                    except Exception as e:  # recorded, failed below
                        with lock:
                            fails.append((i, repr(e)))
                        continue
                    dt = time.perf_counter() - t0
                    with lock:
                        lat[i] = dt
                        errs[i] = _rel(got, ref[i])
                        done[0] += 1
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        if kill_at is not None:
            while done[0] < kill_at and any(t.is_alive() for t in threads):
                time.sleep(0.01)
            with open(os.path.join(tmp, "pids", "127.0.0.1")) as f:
                out["victim"] = int(f.read().strip())
            os.kill(out["victim"], signal.SIGKILL)
            with open(hosts, "w") as f:
                f.write("localhost:1\n")
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        need(not any(t.is_alive() for t in threads),
             "(b): a client thread hung")
        if out["victim"] is not None:
            # The pool finds a dead replica at its next submit or when
            # its heartbeat goes stale (pool.STALE_HEARTBEAT_S): wait
            # for that before the drain.
            dead = f"pid={out['victim']}"
            end = time.monotonic() + 60
            while not any("died" in ln and dead in ln for ln in lines):
                need(time.monotonic() < end, "(b): the pool never marked "
                     "the killed replica dead")
                time.sleep(0.2)
        probe = ServeClient(addr, secret=secret.encode())
        out["frontend_stats"] = probe.stats()
        probe.shutdown()
        probe.close()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            # SIGTERM first: the launcher then ends its replicas, which
            # run in sessions of their own.
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(30)
        reader.join(30)
    text = "".join(lines)
    with open(os.path.join("chiprun_out", "serve14", "launcher.log"),
              "w") as f:
        f.write(text)
    need(rc == 0, f"(b): the serving launcher exited {rc}:\n{text[-3000:]}")
    need(not fails and len(lat) == SERVE_REQUESTS,
         f"(b): {len(lat)} of {SERVE_REQUESTS} requests answered; "
         f"failures {fails[:4]}")
    ms = [v * 1e3 for v in lat.values()]
    out.update(p50_ms=_pct(ms, 0.5), p99_ms=_pct(ms, 0.99),
               requests_per_s=SERVE_REQUESTS / wall,
               max_rel_err=max(errs.values()), wall_s=wall)
    print(f"(b) launched serving: {slots} replica(s) on "
          f"{', '.join(out['devices'])}, up in "
          f"{out['startup_s']:.1f} s; {SERVE_REQUESTS} requests of "
          f"{tokens.shape[1]} tokens from {SERVE_CLIENTS} clients: p50 "
          f"{out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms, "
          f"{out['requests_per_s']:.2f} requests/s; largest error "
          f"against (a)'s engine {out['max_rel_err']:.3g} (tolerance "
          f"{TOL_BF16}); frontend {out['frontend_stats']}")
    need(out["max_rel_err"] <= TOL_BF16,
         "(b): a response disagrees with (a)'s engine")
    rc, doc = run_bounded([py, "-m", "horovod_tpu_torch.observability.doctor",
                           "--dir", flight], 120)
    with open(os.path.join("chiprun_out", "serve14", "doctor.txt"),
              "w") as f:
        f.write(doc)
    section = []
    for ln in doc.splitlines():
        if ln.startswith("[serve]") or (section and ln.strip()
                                         and not ln.startswith("[")):
            section.append(ln)
        elif section:
            break
    print("\n".join("(b) doctor: " + ln for ln in section))
    traces = [ln for ln in doc.splitlines()
              if "SLOWEST request" in ln or ln.startswith("[traces]")]
    print("\n".join("(b) doctor: " + ln for ln in traces[:3]))
    need(rc == 0 and bool(section) and bool(traces),
         f"(b): the doctor's report lacks [serve] or [traces]:\n"
         f"{doc[-3000:]}")
    if out["victim"] is not None:
        need("SERVE REPLICA DEATH" in doc and str(out["victim"]) in doc,
             f"(b): the doctor does not name the killed replica "
             f"{out['victim']}")
        print(f"(b) replica {out['victim']} SIGKILLed after "
              f"{SERVE_KILL_AFTER} responses: every request answered, "
              f"the doctor names it")
    else:
        print("(b) one card: the SIGKILL of one replica under load needs "
              "two or more")
    out["doctor_serve"] = section
    with open(os.path.join(tmp, "launched.json"), "w") as f:
        json.dump(out, f)
    return 0


def _service_shard(batches, shard, num_shards):
    """(d)'s dataset: batch i of `batches` (bf16 images as int16, int64
    labels) goes to shard i mod num_shards."""
    for i in range(shard, len(batches), num_shards):
        x, y = batches[i]
        yield {"i": i, "x": x, "y": y}


def _kernel_names(trace_dir: str) -> list:
    names = []
    for root, _, files in os.walk(trace_dir):
        for fn in files:
            if fn.endswith(".json"):
                with open(os.path.join(root, fn)) as f:
                    names += [e.get("name", "") for e in
                              json.load(f).get("traceEvents", [])
                              if e.get("cat") == "kernel"]
    return names


def watch_and_data(batch=32, image=224, dtype="bfloat16",
                   device=None) -> dict:
    """Phase 14 (c) in process and (d): the phase-4 ResNet-50 step under
    hvdwatch, with and without a latency fault; then four batches
    through two DataWorkers, DataServiceClient and DeviceFeed into the
    same step, against the same batches fed in process. `device`
    "cpu" (with a small batch and image, f32) rehearses it on the
    host."""
    import functools
    import itertools
    import shutil
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.data import service as ds
    from horovod_tpu_torch.data import DeviceFeed
    from horovod_tpu_torch.observability import flight, watch
    from horovod_tpu_torch.profiler import device_profile, perfscope
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.testing import faults

    dt = getattr(torch, dtype)
    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    wdir = os.path.abspath(os.path.join("chiprun_out", "watch14"))
    shutil.rmtree(wdir, ignore_errors=True)
    os.makedirs(wdir)
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    out = {}
    hvd.init(device=device)
    try:
        dev, group = hvd.device(), dist.group.WORLD
        model = sb.build("resnet50", dt, dev)
        snap = copy.deepcopy(model.state_dict())
        host = [tuple(t.cpu() for t in sb.make_batch(batch, image, dt, dev,
                                                     seed=s))
                for s in range(4)]
        opts = []

        def fresh_opt():
            for o in opts:
                for h in o._hooks:
                    h.remove()
            model.load_state_dict(snap)
            opts.append(sb.make_optimizer(model))
            return opts[-1]

        # (c) hvdwatch: the same steps clean and with a latency fault.
        env = {"HOROVOD_WATCH": "1", "HOROVOD_WATCH_DIR": wdir,
               "HOROVOD_FLIGHT_DIR": wdir, "HOROVOD_WATCH_WARMUP": "8",
               "HOROVOD_WATCH_CAPTURE_STEPS": "3",
               "HOROVOD_WATCH_CAPTURE_SECONDS": "60"}
        prev = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        runs = {}
        try:
            for tag in ("clean", "fault"):
                for mod in (watch, flight, perfscope):
                    mod.reset_for_tests()
                w = watch.get()
                need(isinstance(w, watch.Watcher), "(c): hvdwatch is off")
                opt = fresh_opt()
                spec = (f"site=data.feed.produce,kind=latency,"
                        f"ms={WATCH_FAULT_MS},after={WATCH_FAULT_AFTER},"
                        f"count=3")
                faults.install(faults.FaultInjector(faults.parse_spec(spec))
                               if tag == "fault" else None)
                feed = DeviceFeed(itertools.cycle(host), device=dev, depth=0)
                walls = []
                try:
                    for _ in range(WATCH_STEPS):
                        t0 = time.perf_counter()
                        sb.train_step(model, opt, next(feed), group)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t0)
                        w.tick()
                    # Let a triggered capture see its steps, then stop.
                    end = time.monotonic() + 60
                    while device_profile.capture_active() \
                            and time.monotonic() < end:
                        sb.train_step(model, opt, next(feed), group)
                        w.tick()
                finally:
                    feed.close()
                    faults.uninstall()
                events = flight.get().payload("phase14")["events"]
                anomalies = [e for e in events if e[2] == "anomaly"]
                runs[tag] = dict(counts=w.counts(), records=w.records(),
                                 flight_anomalies=[e[3] for e in anomalies],
                                 step_ms=[v * 1e3 for v in walls])
                print(f"(c) hvdwatch, {tag} run of {WATCH_STEPS} steps: "
                      f"anomalies {w.counts()}; step ms median "
                      f"{_median(runs[tag]['step_ms']):.1f}, largest "
                      f"{max(runs[tag]['step_ms']):.1f}; flight "
                      f"{[e[3] for e in anomalies]}")
        finally:
            for k, v in prev.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            for mod in (watch, flight, perfscope):
                mod.reset_for_tests()
        need(runs["clean"]["counts"] == {},
             f"(c): the clean run reported {runs['clean']['counts']}")
        need(runs["fault"]["counts"].get("step_time") == 1,
             f"(c): the step-time detector did not fire once: "
             f"{runs['fault']['counts']}")
        need(any("detector=step_time" in d
                 for d in runs["fault"]["flight_anomalies"]),
             "(c): the flight recorder holds no step_time anomaly event")
        cap = [os.path.join(wdir, d) for d in os.listdir(wdir)
               if d.startswith("devtrace-")]
        names = [n for d in cap for n in _kernel_names(d)]
        k1 = sum("cfh::fwd_hopper" in n for n in names)
        k2 = sum("cbh::dx_hopper" in n or "cbh::dw_hopper" in n
                 for n in names)
        out["watch"] = dict(runs=runs, captures=[os.path.basename(d)
                                                 for d in cap],
                            capture_kernels=len(names), k1=k1, k2=k2)
        print(f"(c) on-demand capture {[os.path.basename(d) for d in cap]}:"
              f" {len(names)} kernels, kernel 1 {k1} times, kernel 2 "
              f"{k2}")
        if dev.type == "cuda":
            need(len(cap) == 1 and k1 > 0 and k2 > 0,
                 "(c): the capture does not hold kernels 1 and 2")

        # (d) the data service into the same step.
        secret = bytes.fromhex(secret_mod.make_secret_key())
        disp = ds.DataDispatcher(expected_workers=2, secret=secret)
        addr = ("127.0.0.1", disp.start())
        workers = [ds.DataWorker(addr, secret=secret, poll_interval=0.02)
                   for _ in range(2)]
        for wk in workers:
            wk.start()
        try:
            client = ds.DataServiceClient(addr, secret=secret)
            # numpy has no bf16: the images travel as integers of
            # their width and are viewed back on the card.
            as_int = {2: torch.int16, 4: torch.int32}[host[0][0]
                                                     .element_size()]
            wire = [(x.view(as_int).numpy(), y.numpy()) for x, y in host]
            client.register_dataset(
                "phase14", functools.partial(_service_shard, wire))
            cudnn.deterministic, cudnn.benchmark = True, False
            opt = fresh_opt()
            ps = perfscope.get()
            ps.reset()
            order, served = [], []
            feed = client.device_stream("phase14", device=dev)
            try:
                for b in feed:
                    order.append(b["i"])
                    x = b["x"].view(dt)
                    served.append(float(sb.train_step(
                        model, opt, (x, b["y"]), group)))
            finally:
                feed.close()
            summ = ps.summary()
            opt = fresh_opt()
            direct = [float(sb.train_step(
                model, opt, tuple(t.to(dev) for t in host[i]), group))
                for i in order]
            cudnn.deterministic, cudnn.benchmark = saved
        finally:
            for wk in workers:
                wk.stop()
            disp.stop()
        share = (summ.get("phase_fractions") or {}).get("input_wait", 0.0)
        out["data_service"] = dict(order=order, served=served,
                                   direct=direct, input_wait_share=share,
                                   steps=summ.get("steps"))
        print(f"(d) data service: 2 workers, batches {order} through "
              f"DeviceFeed: losses {served}; fed in process {direct}; "
              f"input_wait share {share:.4f} over {summ.get('steps')} "
              f"recorded steps")
        need(sorted(order) == [0, 1, 2, 3], f"(d): batches {order}")
        need(served == direct, "(d): the service-fed losses differ from "
             "the in-process ones")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        hvd.shutdown()
    return out


def top_launched(bench_extra=()) -> dict:
    """Phase 14 (c), launched: `runner.launch -np 1` of the synthetic
    benchmark; while it runs, hvdtop's snapshot over the launcher's `GET
    /metrics` and KV scopes must show rank 0's step time."""
    import signal
    import threading
    from horovod_tpu_torch.observability import top
    from horovod_tpu_torch.runner import secret as secret_mod

    py = sys.executable
    base = os.path.join("chiprun_out", "top14")
    os.makedirs(base, exist_ok=True)
    port_file = os.path.join(base, "rdv.port")
    if os.path.exists(port_file):
        os.remove(port_file)
    # The job's key, set before it starts, signs hvdtop's KV reads.
    secret = secret_mod.make_secret_key()
    env = dict(os.environ, HOROVOD_CONV_BLOCK="1", HOROVOD_FUSE_CONV_BN="0",
               HOROVOD_RENDEZVOUS_PORT_FILE=port_file,
               HOROVOD_METRICS_PUSH_INTERVAL="0.5",
               HOROVOD_SECRET_KEY=secret)
    cmd = [py, "-m", "horovod_tpu_torch.runner.launch", "-np", "1", py,
           "-m", "horovod_tpu_torch.synthetic_benchmark", "--batch-size",
           "32", "--num-iters", "4", *bench_extra]
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    chunks = []
    reader = threading.Thread(target=lambda: chunks.append(proc.stdout.read()),
                              daemon=True)
    reader.start()
    snap = {}
    end = time.monotonic() + 300
    saved = os.environ.get(secret_mod.SECRET_ENV)
    os.environ[secret_mod.SECRET_ENV] = secret
    try:
        while proc.poll() is None and time.monotonic() < end:
            try:
                h, p = open(port_file).read().split(",")[0].rsplit(":", 1)
                s = top.snapshot(h, int(p), max_ranks=2)
                if (s.get("ranks", {}).get("0", {}).get("step_ms") or
                        {}).get("mean", 0) > 0 and not s["errors"]:
                    snap = s
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.5)
        rc = proc.wait(timeout=max(1.0, end - time.monotonic()))
    finally:
        if saved is None:
            os.environ.pop(secret_mod.SECRET_ENV, None)
        else:
            os.environ[secret_mod.SECRET_ENV] = saved
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
        reader.join(30)
    need(rc == 0, f"(c): the launched benchmark exited {rc}: "
         f"{''.join(chunks)[-3000:]}")
    need(bool(snap), "(c): hvdtop never saw rank 0's step time")
    text = top.render(snap)
    print("\n".join("(c) hvdtop: " + ln[:160] for ln in text.splitlines()))
    row = snap["ranks"]["0"]
    return dict(step_ms=row["step_ms"], steps=row.get("steps"),
                mfu=row.get("mfu"), render=text)


def serving_path() -> dict:
    """Phase 14: serving, the record readers and the data service."""
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="serve14-")
    os.makedirs(os.path.join("chiprun_out", "serve14"), exist_ok=True)
    out = {"in_process": serving_in_process(tmp)}
    out["in_process_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    rc, text = run_bounded(
        [sys.executable, "-c", "import sys, chip_smoke; "
         f"sys.exit(chip_smoke.serving_launched({tmp!r}))"], 600)
    print("\n".join(ln for ln in text.splitlines() if ln.startswith("(b)")))
    need(rc == 0, f"phase 14 (b) failed ({rc}):\n{text[-4000:]}")
    with open(os.path.join(tmp, "launched.json")) as f:
        out["launched"] = json.load(f)
    out["launched_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out.update(watch_and_data())
    out["top"] = top_launched()
    out["watch_data_top_s"] = time.perf_counter() - t1
    return out

# --------------------- phase 15: tensor, pipeline and expert parallelism

# (a) Remat recomputes each layer from the same inputs with the same
# kernels, so its losses repeat phase 5's bit for bit where every kernel
# of the step is deterministic; the bar is phase 11's (2e-3 relative,
# 4 Adam steps in bf16) in case an atomics-based backward sums in
# another order. (b) The MoE LM with attn="flash" against attn="local"
# on the same weights: the attention outputs differ by a bf16 step, so
# a token whose top-1/top-2 router margin is below that routes to
# another expert; TOL_MOE_LOSS leaves room for a few such tokens out of
# 12288 per layer (each moves the loss by ~1/12288 of a token's NLL
# difference). (c) Two microbatches at pp = 1 run every GEMM at half
# the rows: bf16 outputs of other shapes, so the same 2e-3 as (a). The
# worlds: tp and pp sum over tp in another order than one card and ep
# and dp train other batches, so their losses are printed beside the
# one card's, and tp's and pp's held to TOL_SP_LOSS.
TOL_REMAT = 2e-3
TOL_MOE_LOSS = 2e-3
TOL_MICRO = 2e-3


def _lm_steps(cfg, steps, seed=0):
    """`steps` Adam steps of the one-card LM at `cfg` through
    transformer_lm.build and its step from the seed-0 weights on phase 5's
    batch, the launch counters set to 0 just before and read just after.
    Returns (losses, launches per step, peak GB, ms/step of the steps
    after the first)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_lm as lm
    dev = hvd.device()
    model, opt, step = lm.build(cfg, dev, seed)
    data = lm.make_batch(lm.FLAGSHIP_BATCH, cfg.max_seq, cfg.vocab, dev,
                         seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    losses = [step(data)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the first step warms the allocator
    losses += [step(data) for _ in range(steps - 1)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    counts = read_counters()
    del model, opt, step
    torch.cuda.empty_cache()
    return ([float(v) for v in losses],
            {k: counts[k] / steps for k in ("attn_fwd", "attn_dkdv",
                                            "attn_dq")},
            torch.cuda.max_memory_allocated(dev) / 1e9, ms)


def _rel_diff(a, b):
    """|a − b| / |b| of two losses."""
    return abs(a - b) / max(abs(b), 1e-6)


def parallel_one_card(lm_out: dict) -> dict:
    """Phase 15 on one card: (a) remat "dots" and "full", (b) the MoE LM
    (8 experts, ep = 1, capacity 2.0, remat "dots") against
    attn="local", then 3 training steps, (c) two microbatches at pp = 1;
    the flagship width, bf16, Adam, from the seed-0 weights on phase 5's
    batch. ms/step counts the steps after the first."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import moe
    L = lm.FLAGSHIP["n_layers"]
    need(fa.flash_instance(torch.bfloat16, 128) == "hopper",
         "the LM's bf16 dh-128 attention is not on the Hopper instances")
    base = tfm.TransformerConfig(**lm.FLAGSHIP, attn="flash",
                                 dtype=torch.bfloat16)
    ref, out = lm_out["losses"], {}
    print(f"phase 5 (no remat): losses {[round(v, 6) for v in ref[:3]]}, "
          f"peak memory {lm_out['peak_mem_gb']:.1f} GB, "
          f"{lm_out['step_ms']:.2f} ms/step")
    hvd.init()
    try:
        for policy in ("dots", "full"):
            cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
            losses, per, peak, ms = _lm_steps(cfg, 3)
            rel = max(_rel_diff(a, b) for a, b in zip(losses, ref))
            print(f"(a) remat {policy}: losses {[round(v, 6) for v in losses]}"
                  f", bit for bit {losses == ref[:3]}, largest relative "
                  f"difference {rel:.3g} (tolerance {TOL_REMAT}); peak "
                  f"memory {peak:.1f} GB against phase 5's "
                  f"{lm_out['peak_mem_gb']:.1f}; {ms:.2f} ms/step; "
                  f"launches a step {per}")
            need(rel <= TOL_REMAT, f"remat {policy} losses disagree with "
                 f"phase 5's")
            need(per == {"attn_fwd": 2 * L, "attn_dkdv": L, "attn_dq": L},
                 f"remat {policy}: expected {2 * L} launches of kernel 4 "
                 f"and {L} of kernels 5 and 6 a step, got {per}")
            out[f"a_{policy}"] = dict(losses=losses, launches=per,
                                      peak_mem_gb=peak, step_ms=ms,
                                      bit_equal=losses == ref[:3], rel=rel)

        # (b) MoE: the loss on the seed-0 weights with both attentions
        # (routing recorded), then 2 training steps with flash.
        cfg = dataclasses.replace(base, num_experts=8, remat=True)
        dev = hvd.device()
        model, opt, step = lm.build(cfg, dev)
        data = lm.make_batch(lm.FLAGSHIP_BATCH, cfg.max_seq, cfg.vocab, dev,
                             seed=0)
        routes, orig = [], moe.route
        moe.route = lambda *a: routes.append(orig(*a)) or routes[-1]
        try:
            firsts = {}
            for attn in ("local", "flash"):
                model.cfg = dataclasses.replace(cfg, attn=attn)
                with torch.no_grad():
                    firsts[attn] = float(tfm.loss_fn(model, *data))
        finally:
            moe.route = orig
        n, tokens = len(routes) // 2, routes[0][1].numel()
        moved = sum(int((a[1] != b[1]).sum()) for a, b in
                    zip(routes[:n], routes[n:]))
        dropped = [int((~r[3]).sum()) for r in routes[n:]]
        del routes
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        losses = [float(step(data))]
        t0 = time.perf_counter()  # after the first step's allocations
        losses += [float(step(data)) for _ in range(2)]
        ms = (time.perf_counter() - t0) / 2 * 1e3
        per = {k: v / 3 for k, v in read_counters().items()
               if k.startswith("attn")}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        rel = _rel_diff(firsts["flash"], firsts["local"])
        print(f"(b) MoE E=8 ep=1 capacity 2.0 remat dots: flash loss "
              f"{firsts['flash']:.6f}, local {firsts['local']:.6f}, relative "
              f"difference {rel:.3g} (tolerance {TOL_MOE_LOSS}); tokens "
              f"routed differently {moved} of {n * tokens}; tokens dropped "
              f"by layer (flash) {dropped}; training losses "
              f"{[round(v, 6) for v in losses]}; {ms:.2f} ms/step; peak "
              f"memory {peak:.1f} GB; launches a step {per}")
        need(all(math.isfinite(v) for v in losses), "MoE loss not finite")
        need(rel <= TOL_MOE_LOSS, "MoE flash and local losses disagree")
        need(abs(losses[0] - firsts["flash"]) <= TOL_REMAT *
             abs(firsts["flash"]), "the MoE step's loss is not its forward's")
        need(per == {"attn_fwd": 2 * L, "attn_dkdv": L, "attn_dq": L},
             f"MoE: expected {2 * L} launches of kernel 4 and {L} of "
             f"kernels 5 and 6 a step, got {per}")
        out["b"] = dict(loss_flash=firsts["flash"], loss_local=firsts["local"],
                        rel=rel, routed_differently=moved, dropped=dropped,
                        losses=losses, step_ms=ms, peak_mem_gb=peak,
                        launches=per)
        del model, opt, step
        torch.cuda.empty_cache()

        # (c) two microbatches at pp = 1
        losses, per, peak, ms = _lm_steps(
            dataclasses.replace(base, microbatches=2), 2)
        rel = max(_rel_diff(a, b) for a, b in zip(losses, ref))
        print(f"(c) microbatches 2 at pp=1: losses "
              f"{[round(v, 6) for v in losses]} against phase 5's "
              f"{[round(v, 6) for v in ref[:2]]}, largest relative "
              f"difference {rel:.3g} (tolerance {TOL_MICRO}); {ms:.2f} "
              f"ms/step; peak memory {peak:.1f} GB; launches a step {per}")
        need(rel <= TOL_MICRO, "the pipelined step's losses disagree")
        need(all(v == 2 * L for v in per.values()),
             f"microbatches 2: expected {2 * L} launches of kernels 4-6 a "
             f"step, got {per}")
        out["c"] = dict(losses=losses, rel=rel, launches=per,
                        peak_mem_gb=peak, step_ms=ms)
    finally:
        hvd.shutdown()
    return out


def _mesh_steps(attn, cfg_kw):
    """One rank of a phase 15 world: transformer_lm.flagship_steps, with
    every thread's stack printed should the launcher's SIGTERM end it."""
    import faulthandler
    import signal
    from horovod_tpu_torch import transformer_lm as lm
    faulthandler.register(signal.SIGTERM, chain=True)
    return lm.flagship_steps(attn, **cfg_kw)


def _tied_rank(batch=64, seq=64, warmup=2, steps=9):
    """One rank of phase 15's tied-LM worlds: hybrid_lm.train at
    bench.py's gspmd_hybrid shapes (canonical config, B 64, S 64) with
    SGD at TIED_LR on the HOROVOD_MESH mesh; losses, ms/step and peak
    GB."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import hybrid_lm
    from horovod_tpu_torch.models import tied_lm
    hvd.init()
    try:
        dev = hvd.device()
        cfg = tied_lm.canonical_config()
        params = tied_lm.init(0, cfg, dev)
        data = tied_lm.sample_batch(1, cfg, batch=batch, seq=seq, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_s = hybrid_lm.train(cfg, hvd.hybrid_mesh(), params,
                                         data, warmup + steps, TIED_LR,
                                         optimizer="sgd", warmup=warmup)
        return dict(losses=losses, step_s=step_s,
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    finally:
        hvd.shutdown()


def parallel_worlds(lm_out: dict) -> dict:
    """Phase 15 with two or more cards, through runner.run under
    HOROVOD_MESH: the flagship LM at tp = N, at pp = N with N
    microbatches, at ep = N with 8 experts, at dp = 2 x tp = 2 (four
    cards), and the tied LM at dp = 2 x tp = 2 against dp = 4 (four
    cards); with one card it says so."""
    import functools
    import torch
    from horovod_tpu_torch import runner
    from horovod_tpu_torch import transformer_lm as lm
    cards = torch.cuda.device_count()
    if cards < 2:
        print("phase 15 worlds: one card; the tp, pp, ep and dp x tp "
              "worlds need two or more")
        return {}
    N = 4 if cards >= 4 else 2
    L, steps = lm.FLAGSHIP["n_layers"], 4
    ref, out = lm_out["losses"], {}
    worlds = [("tp", f"tp={N}", {}), ("pp", f"pp={N}", dict(microbatches=N)),
              ("ep", f"ep={N}", dict(num_experts=8, remat=True))]
    if cards >= 4:
        worlds.append(("dp_tp", "dp=2,tp=2", {}))
    for name, mesh, kw in worlds:
        res = runner.run(functools.partial(_mesh_steps, "flash", kw), np=N,
                         extra_env={"HOROVOD_MESH": mesh}, timeout=600)
        losses = res[0]["losses"]
        need(all(math.isfinite(v) for v in losses),
             f"phase 15 {name}: non-finite loss {losses}")
        per = [{k: c / steps for k, c in r["launches"].items()}
               for r in res]
        if name in ("tp", "pp"):  # the one card's model and batch
            rel = max(_rel_diff(a, b) for a, b in zip(losses, ref))
            held = (f"one card's {[round(v, 6) for v in ref[:steps]]}, "
                    f"largest relative difference {rel:.3g} (tolerance "
                    f"{TOL_SP_LOSS})")
        else:  # ep: the MoE LM; dp x tp: two data blocks
            rel, held = None, (
                f"not held to the one card's: {N} data blocks of the MoE LM"
                if name == "ep" else "not held to the one card's: 2 data "
                "blocks")
        print(f"(15 {name}) mesh {mesh}: losses "
              f"{[round(v, 6) for v in losses]}, {held}; "
              f"{res[0]['tokens_per_s']:.1f} tokens/s "
              f"over the global batch, {res[0]['step_ms']:.2f} ms/step; peak "
              f"memory by rank {[round(r['peak_mem_gb'], 2) for r in res]} "
              f"GB; launches of kernels 4/5/6 a step by rank "
              f"{[(c['attn_fwd'], c['attn_dkdv'], c['attn_dq']) for c in per]}")
        if rel is not None:
            need(rel <= TOL_SP_LOSS, f"phase 15 {name}: losses disagree "
                 f"with the one card's")
        if name == "pp":
            want = L // N * (N + N - 1)  # (L/pp)·(M + pp − 1), M = N
            need(all(c["attn_fwd"] == want for c in per),
                 f"phase 15 pp: expected {want} launches of kernel 4 a "
                 f"step per stage, got {per}")
        else:
            fwd = 2 * L if kw.get("remat") else L
            need(all(c["attn_fwd"] == fwd and c["attn_dq"] == L
                     for c in per),
                 f"phase 15 {name}: expected {fwd} launches of kernel 4 "
                 f"and {L} of kernel 6 a step, got {per}")
        out[name] = dict(mesh=mesh, ranks=res, launches_per_step=per,
                         rel=rel)
    if cards >= 4:
        tied = {}
        for mesh in ("dp=2,tp=2", "dp=4"):
            res = runner.run(_tied_rank, np=4,
                             extra_env={"HOROVOD_MESH": mesh}, timeout=600)
            r0 = res[0]
            tied[mesh] = res
            print(f"(15 tied LM) mesh {mesh}: losses "
                  f"{[round(v, 6) for v in r0['losses']]}, "
                  f"{64 * 64 / r0['step_s']:.0f} tokens/s, "
                  f"{r0['step_s'] * 1e3:.3f} ms/step (after 2 warm-up "
                  f"steps); peak memory by rank "
                  f"{[round(r['peak_mem_gb'], 3) for r in res]} GB")
            need(all(math.isfinite(v) for v in r0["losses"]),
                 f"tied LM at {mesh}: non-finite loss")
        a, b = (tied[m][0]["losses"] for m in ("dp=2,tp=2", "dp=4"))
        first = _rel_diff(a[0], b[0])
        da, db = ([v - x[0] for v in x] for x in (a, b))
        move = max(abs(v) for v in db)
        rel = max(abs(x - y) for x, y in zip(da, db)) / max(move, 1e-30)
        print(f"(15 tied LM) dp=2,tp=2 against dp=4: first loss relative "
              f"difference {first:.3g} (tolerance {TOL_TIED_LOSS}); the "
              f"loss moves {move:.6f} over the steps (at least "
              f"{TIED_MIN_MOVE}); the largest difference of the two "
              f"meshes' moves {rel:.3g} of it (tolerance {TOL_TIED})")
        need(first <= TOL_TIED_LOSS, "the tied LM's hybrid and "
             "data-parallel first losses disagree")
        need(move >= TIED_MIN_MOVE, "the tied LM's data-parallel "
             "trajectory does not move")
        need(rel <= TOL_TIED, "the tied LM's hybrid and data-parallel "
             "trajectories disagree")
        out["tied"] = dict(runs=tied, first_rel=first, move=move, rel=rel)
    return out


# The tied LM in f32 (tf32 off) at dp=2 x tp=2 against dp=4: the same
# math in other reduction orders. The first losses (the forward) agree
# to f32 rounding (~1e-7 relative). At bench.py's SGD 0.01 the 11 steps
# move the loss by ~2e-5, a few f32 ulps of 9.01, where no check can
# see the step; at TIED_LR 10 the near-linear start moves it by ~1.8e-2,
# ~1e4 times the meshes' ~1e-6 of rounding, so each step's move
# (loss[i] − loss[0]) is held to TOL_TIED of the whole move. A step that
# drops the /tp doubles the hybrid mesh's move (reads ~1), one that
# skips the gradient reduction leaves each dp half on its own batch,
# and one that leaves the weights alone does not move.
TIED_LR = 10.0
TIED_MIN_MOVE = 5e-3
TOL_TIED_LOSS = 1e-5
TOL_TIED = 1e-2


def parallel_path(lm_out: dict) -> dict:
    """Phase 15 (see the module docstring)."""
    out = {"one_card": parallel_one_card(lm_out)}
    out["worlds"] = parallel_worlds(lm_out)
    return out



# ------------------------------- phase 16: the layout pass, its tuner,
#                                  hvdrace and hvdlint

# The JAX package's padded edges of ResNet-50 at its lane, 128
# (horovod_tpu/ops/layout.py over horovod_tpu/models/resnet.py
# conv_stack): the stem and the stage-0 blocks' inner widths.
JAX_PADDED_EDGES = {e: (64, 128) for e in (
    "stem", "s0b0.c1", "s0b0.c2", "s0b1.c1", "s0b1.c2", "s0b2.c1",
    "s0b2.c2")}
LAYOUT_STEPS = 3            # (b): padded and as-declared SGD steps
FUSE_BN_STEPS = 2           # (b): padded steps on kernel 3's route
# (b): the stripped padded state after LAYOUT_STEPS steps against the
# as-declared state: for each weight tensor (conv and FC, dim >= 2) max|Δ|
# over its largest |value|, whose median over the tensors must stay
# within TOL_PADDED_STATE. The padded model runs the same math in other
# summation orders (kernels 1-3 at other tile plans, cuDNN's convs and
# the BN reductions at 128 channels), like the unfused route of the same
# model (phase 4), and bf16 weights step by bf16-rounded updates: two
# such runs differ in most tensors by one or two bf16 steps (2^-8 to 2^-7
# of the largest value) after 3 steps, in a few by more. The BN vectors
# (zero-initialised biases), running stats and momentum are printed with
# the unfused route's distances beside them: their gradients at random
# weights decorrelate between summation orders within 3 steps.
TOL_PADDED_STATE = 2.0 ** -6
TUNER_INTERVAL = 5          # (c): steps per arm (2 more are discarded)
MEM_SWAP_GROWTH = 1.10      # (c): allocated after a swap over before it
RACE_CLIENTS = 4            # (d): request threads on the engine
RACE_REQUESTS = 12          # (d): requests per thread


def _state_distance(got, got_mom, want, want_mom):
    """{category: (max, median)} over tensors of max|Δ| / max|want|:
    weights (dim >= 2), BN vectors, running stats, momentum."""
    by = {}

    def add(cat, a, b):
        d = float((a.float() - b.float()).abs().max())
        by.setdefault(cat, []).append(d / max(float(b.float().abs().max()),
                                              1e-30))
    for k, b in want.items():
        if b.is_floating_point():
            add("weights" if b.dim() >= 2 else "stats"
                if k.endswith((".mean", ".var")) else "vectors", got[k], b)
    for k, b in want_mom.items():
        add("momentum", got_mom[k], b)
    return {c: (max(v), sorted(v)[len(v) // 2]) for c, v in by.items()}


def _momentum(model, opt):
    return {n: opt.state[p]["momentum_buffer"]
            for n, p in model.named_parameters() if p in opt.state}


def _padded_inputs(s, cin_p, c_p):
    """site_inputs `s` zero-padded as the layout pass pads a site to
    (Cin cin_p, C c_p): x's and w's new channels 0, the BN vectors' 0,
    a zero channel's stats (mean 0, var 0: inv = rsqrt(eps)), and the
    BN-backward sums of the padded tensors."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    cin, c = s["w"].shape
    dc, di = c_p - c, cin_p - cin
    p = dict(x=F.pad(s["x"], (0, di)), w=F.pad(s["w"], (0, dc, 0, di)),
             scale=F.pad(s["scale"], (0, dc)), bias=F.pad(s["bias"], (0, dc)),
             dz=F.pad(s["dz"], (0, dc)), y=F.pad(s["y"], (0, dc)),
             mean=F.pad(s["mean"], (0, dc)),
             inv=torch.cat([s["inv"], torch.full((dc,), 1e-5).rsqrt().to(
                 s["inv"])]))
    p["db_m"], p["dg_m"] = cb._bn_act_sums(p["dz"], p["y"], p["mean"],
                                           p["inv"], p["scale"], p["bias"],
                                           True)
    p["db"], p["dg"] = cbb._bn_sums(p["dz"], p["y"], p["mean"], p["inv"])
    m, sc = p["x"].shape[0], p["scale"].float()
    g2, a2, b2 = cbb.fold_rows(sc, p["inv"], p["db_m"], p["dg_m"], None,
                               None, m)
    g3, a3, b3 = cbb.fold_rows(sc, p["inv"], p["db"], p["dg"], None, None, m)
    p["rows2"] = (g2, p["mean"], p["inv"], a2, b2, sc, p["bias"].float())
    p["rows3"] = (g3, p["mean"], p["inv"], a3, b3)
    return p


def padded_kernel_check(dev, pairs):
    """Kernels 1–3 at each padded site shape on the zero-padded inputs of
    its as-declared site (bf16, the Hopper instances): against their
    plain versions at the phase-2 tolerances, and the padded lanes of y,
    Σy, Σy², dx and dW (and of the BN-backward sums dscale, dbias)
    exactly 0. Whether the real part repeats the declared site's outputs
    bit for bit is printed: the tile plans and column-sum splits depend
    on Cin and C, so sums may run in another order. Returns a row per
    shape pair."""
    import torch
    rows = []
    for i, (decl, padded) in enumerate(pairs):
        m, cin, c = decl
        _, cin_p, c_p = padded
        s = site_inputs(m, cin, c, dev, seed=300 + i)
        p = _padded_inputs(s, cin_p, c_p)
        outs, errs = {}, {}
        for name, run, plain in (("fwd", run_k1, plain_k1),
                                 ("act_bwd", run_k2, plain_k2),
                                 ("bn_bwd", run_k3, plain_k3)):
            outs[name] = (run(s), run(p))
            torch.cuda.synchronize()
            errs[name] = check_outputs(name, outs[name][1], plain(p))[1]
        (y, s1, s2), (yp, s1p, s2p) = outs["fwd"]
        lanes = [yp[:, c:], s1p[c:], s2p[c:], p["db_m"][c:], p["dg_m"][c:],
                 p["db"][c:], p["dg"][c:]]
        same = [torch.equal(yp[:, :c], y), torch.equal(s1p[:c], s1),
                torch.equal(s2p[:c], s2)]
        for name in ("act_bwd", "bn_bwd"):
            (dx, dw), (dxp, dwp) = outs[name]
            lanes += [dxp[:, cin:], dwp[cin:], dwp[:, c:]]
            same += [torch.equal(dxp[:, :cin], dx),
                     torch.equal(dwp[:cin, :c], dw)]
        zero = max(float(t.float().abs().max()) if t.numel() else 0.0
                   for t in lanes)
        row = dict(declared=list(decl), padded=list(padded),
                   padded_lanes_max=zero, bit_equal=all(same),
                   equal_parts=[bool(v) for v in same], against_plain=errs)
        rows.append(row)
        print(f"(b) kernels 1-3 [hopper] at {padded} on the zero-padded "
              f"inputs of {decl}: against their plain versions "
              f"{json.dumps(errs)}; largest |value| in the padded lanes of "
              f"y, Σy, Σy², dx, dW, dscale, dbias {zero}; real part bit "
              f"for bit the declared site's (y, Σy, Σy², kernel 2 dx, dW, "
              f"kernel 3 dx, dW): {row['equal_parts']}")
        need(zero == 0.0, f"(b): a padded lane of kernels 1-3 at {padded} "
             f"is not exactly 0")
        del s, p, outs
    return rows


def layout_plans(batch=32, image=224, depth=50):
    """Phase 16 (a) and (b): ResNet-50 at full width (224², bf16, batch
    32, the seed-0 weights and batch of phase 4). (a) the plan at the
    port's lane (64) is as_declared; (b) at lane 128 the JAX package's
    edges pad; every 1x1 site on the Hopper instances; kernels 1–3 at
    the padded site shapes (padded_kernel_check); LAYOUT_STEPS
    SGD-momentum steps of the padded model through DistributedOptimizer
    on HOROVOD_CONV_BLOCK=1 against as many as-declared steps (and
    unfused ones) from the same weights: the losses within TOL_LOSS,
    every padded lane of the weights, BN parameters, running stats and
    momentum exactly 0, the stripped weights within TOL_PADDED_STATE,
    the launches of kernels 1 and 2 a step; then
    FUSE_BN_STEPS padded steps on HOROVOD_FUSE_CONV_BN=1 (kernel 3); and
    kernels 1 and 2 timed alone at the padded stage-0 sites beside their
    as-declared sites (device time)."""
    import gc
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import layout

    dev = hvd.device()
    group = dist.group.WORLD
    model = sb.build(f"resnet{depth}", torch.bfloat16, dev)
    declared = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    stack = resnet.conv_stack(depth)
    out = {}

    # (a) the port's lane
    p64 = layout.plan(declared, stack)
    print(f"(a) plan at the port's lane: {json.dumps(p64.summary())}")
    need(p64.mode == layout.AS_DECLARED and not p64.padded_edges(),
         "(a): the plan at lane 64 pads an edge of ResNet-50")
    out["a"] = p64.summary()

    # (b) the JAX package's lane
    plan = layout.plan(declared, stack, lane=layout.TPU_LANE)
    print(f"(b) plan at lane 128: {json.dumps(plan.summary())}")
    need(plan.padded_edges() == JAX_PADDED_EDGES,
         f"(b): padded edges {plan.padded_edges()}, not the JAX "
         f"package's {JAX_PADDED_EDGES}")
    widths = resnet.widths_of(plan.pad(declared), depth)
    sites = resnet.fused_sites(depth, batch, image, widths)
    insts = {}
    for blk, site, m, cin, c in sites:
        insts[f"{blk}.{site}"] = [instance(m, cin, c, torch.bfloat16, k)
                                  for k in ("fwd", "act_bwd", "bn_bwd")]
    print(f"(b) padded 1x1 sites [kernels 1, 2, 3 instance]: "
          + json.dumps({k: v for k, v in insts.items()
                        if k.startswith("s0")}) + f"; the other "
          f"{len(insts) - sum(k.startswith('s0') for k in insts)} sites as "
          f"declared")
    need(len(sites) == 28 and all(v == ["hopper"] * 3
                                  for v in insts.values()),
         f"(b): the padded sites do not all take the Hopper instances: "
         f"{insts}")
    decl_sites = {(b, k): (m, cin, c) for b, k, m, cin, c in
                  resnet.fused_sites(depth, batch, image)}
    pairs = sorted({(decl_sites[(b, k)], (m, cin, c))
                    for b, k, m, cin, c in sites
                    if decl_sites[(b, k)] != (m, cin, c)})
    out["b_kernels"] = padded_kernel_check(dev, pairs)
    data = sb.make_batch(batch, image, torch.bfloat16, dev, seed=0)
    runs = {}
    for run, state, block in (("declared", declared, "1"),
                              ("padded", plan.pad(declared), "1"),
                              ("unfused", declared, "0")):
        os.environ["HOROVOD_CONV_BLOCK"] = block
        os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
        m_ = resnet.ResNet.from_state(state)
        opt = sb.make_optimizer(m_)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(sb.train_step(m_, opt, data, group))
                  for _ in range(LAYOUT_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / LAYOUT_STEPS * 1e3
        runs[run] = dict(model=m_, opt=opt, losses=losses, ms=ms,
                         launches=read_counters())
    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    dm, pm, um = runs["declared"], runs["padded"], runs["unfused"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(pm["losses"],
                                                  dm["losses"]))
    pstate = pm["model"].state_dict()
    pmom = _momentum(pm["model"], pm["opt"])
    lanes = max(plan.padding_max(pstate), plan.padding_max(pmom))
    dstate, dmom = dm["model"].state_dict(), _momentum(dm["model"],
                                                       dm["opt"])
    dist_p = _state_distance(plan.strip(pstate), plan.strip(pmom), dstate,
                             dmom)
    dist_u = _state_distance(um["model"].state_dict(),
                             _momentum(um["model"], um["opt"]), dstate, dmom)
    per = {k: v / LAYOUT_STEPS for k, v in pm["launches"].items()
           if k in ("fwd", "act_bwd", "bn_bwd")}
    print(f"(b) {LAYOUT_STEPS} SGD-momentum steps on HOROVOD_CONV_BLOCK=1: "
          f"padded losses {[round(v, 6) for v in pm['losses']]}, as "
          f"declared {[round(v, 6) for v in dm['losses']]} (the unfused "
          f"route {[round(v, 6) for v in um['losses']]}); largest relative "
          f"difference {rel:.3g} (tolerance {TOL_LOSS}); {pm['ms']:.2f} "
          f"against {dm['ms']:.2f} ms/step (the first step included); "
          f"launches a step of kernels 1, 2, 3: padded {per}")
    print(f"(b) after {LAYOUT_STEPS} steps: largest |value| in the padded "
          f"lanes of weights, BN parameters, running stats and momentum "
          f"{lanes}; stripped padded state against as declared, (largest, "
          f"median) over tensors of max|Δ|/max|ref|: "
          + json.dumps({k: [round(a, 4), round(b, 4)]
                        for k, (a, b) in dist_p.items()})
          + "; the unfused route against as declared: "
          + json.dumps({k: [round(a, 4), round(b, 4)]
                        for k, (a, b) in dist_u.items()})
          + f" (weights' median tolerance {TOL_PADDED_STATE:.4g})")
    need(all(math.isfinite(v) for v in pm["losses"]),
         "(b): non-finite padded loss")
    need(rel <= TOL_LOSS, "(b): the padded and as-declared losses disagree")
    need(per == {"fwd": 28, "act_bwd": 28, "bn_bwd": 0},
         f"(b): expected 28 launches of kernels 1 and 2 a step, got {per}")
    need(lanes == 0.0, "(b): a padded lane is not exactly 0")
    need(dist_p["weights"][1] <= TOL_PADDED_STATE,
         "(b): the stripped padded weights differ from the as-declared")
    out["b"] = dict(plan=plan.summary(), instances=insts,
                    losses_padded=pm["losses"], losses_declared=dm["losses"],
                    losses_unfused=um["losses"], loss_rel=rel,
                    ms_padded=pm["ms"], ms_declared=dm["ms"],
                    launches_per_step=per, padded_lanes_max=lanes,
                    distance_padded=dist_p, distance_unfused=dist_u)

    # kernel 3's route, padded
    os.environ["HOROVOD_CONV_BLOCK"] = "0"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "1"
    reset_counters()
    losses = [float(sb.train_step(pm["model"], pm["opt"], data, group))
              for _ in range(FUSE_BN_STEPS)]
    counts = read_counters()
    lanes3 = max(plan.padding_max(pm["model"].state_dict()),
                 plan.padding_max(_momentum(pm["model"], pm["opt"])))
    per3 = {k: counts[k] / FUSE_BN_STEPS for k in ("fwd", "act_bwd",
                                                   "bn_bwd")}
    print(f"(b) {FUSE_BN_STEPS} padded steps on HOROVOD_FUSE_CONV_BN=1: "
          f"losses {[round(v, 6) for v in losses]}; launches a step {per3}; "
          f"largest |value| in the padded lanes {lanes3}")
    need(all(math.isfinite(v) for v in losses), "(b): kernel 3's route "
         "gave a non-finite loss")
    need(per3 == {"fwd": 0, "act_bwd": 0, "bn_bwd": 28},
         f"(b): expected 28 launches of kernel 3 a step, got {per3}")
    need(lanes3 == 0.0, "(b): kernel 3's route moved a padded lane")
    out["b"].update(fuse_bn_losses=losses, fuse_bn_launches_per_step=per3)
    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    del runs, dm, pm, um, pstate, pmom, dstate, dmom
    gc.collect()
    torch.cuda.empty_cache()

    # kernels 1 and 2 alone at the sites the padding changes
    times, cache = [], {}
    for blk, site, m, cin, c in sites:
        before = decl_sites[(blk, site)]
        if before == (m, cin, c):
            continue
        row = {"site": f"{blk}.{site}"}
        for tag, shape in (("declared", before), ("padded", (m, cin, c))):
            if shape not in cache:
                sin = site_inputs(*shape, dev, seed=200 + len(cache))
                cache[shape] = {k: device_ms(lambda: run(sin))
                                for k, run in (("fwd", run_k1),
                                               ("act_bwd", run_k2))}
                for k in ("fwd", "act_bwd"):
                    cache[shape][k + "_bound"] = bound(k, *shape)[0]
                del sin
            row[tag] = dict(shape=list(shape), **cache[shape])
        times.append(row)
        print(f"(b) time {row['site']}: declared {before} kernel 1 "
              f"{row['declared']['fwd']:.4f} ms (bound "
              f"{row['declared']['fwd_bound']:.4f}), kernel 2 "
              f"{row['declared']['act_bwd']:.4f} ({row['declared']['act_bwd_bound']:.4f}); "
              f"padded {(m, cin, c)} kernel 1 {row['padded']['fwd']:.4f} "
              f"({row['padded']['fwd_bound']:.4f}), kernel 2 "
              f"{row['padded']['act_bwd']:.4f} ({row['padded']['act_bwd_bound']:.4f})")
    tot = {tag: {k: sum(r[tag][k] for r in times)
                 for k in ("fwd", "act_bwd", "fwd_bound", "act_bwd_bound")}
           for tag in ("declared", "padded")}
    print(f"(b) the {len(times)} changed stage-0 sites a step: kernel 1 "
          f"{tot['declared']['fwd']:.4f} ms declared against "
          f"{tot['padded']['fwd']:.4f} padded (bounds "
          f"{tot['declared']['fwd_bound']:.4f}, "
          f"{tot['padded']['fwd_bound']:.4f}); kernel 2 "
          f"{tot['declared']['act_bwd']:.4f} against "
          f"{tot['padded']['act_bwd']:.4f} (bounds "
          f"{tot['declared']['act_bwd_bound']:.4f}, "
          f"{tot['padded']['act_bwd_bound']:.4f})")
    out["b"].update(site_times=times, site_totals=tot)
    return out, declared, plan, data


def layout_tuner(declared, plan, data):
    """Phase 16 (c): OnlineLayoutTuner (HOROVOD_LAYOUT_AUTOTUNE=1,
    interval TUNER_INTERVAL) over as_declared and padded at lane 128 on
    the block route, from phase 16's weights and batch, each swap through
    resnet.relayout (a new model and DistributedOptimizer, the momentum
    padded or stripped): each arm's mean ms a step and the winner. After
    each swap the allocated memory stays within MEM_SWAP_GROWTH of
    before it, so the dropped model and optimizer were freed."""
    import gc
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.core import autotune
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import layout

    os.environ["HOROVOD_LAYOUT_AUTOTUNE"] = "1"
    os.environ["HOROVOD_LAYOUT_AUTOTUNE_INTERVAL"] = str(TUNER_INTERVAL)
    try:
        tuner = autotune.OnlineLayoutTuner(Config.from_env())
    finally:
        del os.environ["HOROVOD_LAYOUT_AUTOTUNE"]
        del os.environ["HOROVOD_LAYOUT_AUTOTUNE_INTERVAL"]
    group = dist.group.WORLD
    model = resnet.ResNet.from_state(declared)
    opt = sb.make_optimizer(model)
    dev = next(model.parameters()).device
    torch.cuda.reset_peak_memory_stats(dev)
    walls, swaps, steps = {a: [] for a in tuner.arms}, [], 0
    while not tuner.frozen and steps < 4 * (TUNER_INTERVAL + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(sb.train_step(model, opt, data, group))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        need(math.isfinite(loss), f"(c): non-finite loss at step {steps}")
        walls[tuner.choice].append(dt * 1e3)
        tuner.record_step(dt)
        steps += 1
        if tuner.update():
            gc.collect()
            before = torch.cuda.memory_allocated(dev)
            model, opt = resnet.relayout(model, opt, plan, tuner.choice,
                                         sb.make_optimizer)
            gc.collect()
            after = torch.cuda.memory_allocated(dev)
            swaps.append(dict(step=steps, to=tuner.choice,
                              before_gb=before / 1e9, after_gb=after / 1e9))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    lanes = plan.padding_max(model.state_dict()) \
        if tuner.choice == layout.NHWC_PADDED else 0.0
    res = tuner.result or {}
    print(f"(c) layout tuner, interval {TUNER_INTERVAL}: froze after "
          f"{steps} steps on {tuner.choice!r}; mean ms a step by arm (the "
          f"tuner's, 2 discarded a window) "
          + json.dumps({a: round(v * 1e3, 3) for a, v in
                        res.get("mean_step_s", {}).items()})
          + f"; every step's ms by arm "
          + json.dumps({a: [round(v, 2) for v in w]
                        for a, w in walls.items()})
          + f"; swaps {json.dumps(swaps)}; peak memory {peak:.2f} GB")
    need(tuner.frozen and res.get("winner") == tuner.choice,
         f"(c): the tuner did not freeze on a winner ({res})")
    need(all(len(walls[a]) >= TUNER_INTERVAL + 2 for a in tuner.arms),
         f"(c): an arm ran fewer than {TUNER_INTERVAL + 2} steps")
    need(all(sw["after_gb"] <= MEM_SWAP_GROWTH * sw["before_gb"]
             for sw in swaps), "(c): memory grew across a swap: the "
         "dropped model or optimizer was kept")
    need(lanes == 0.0, "(c): a padded lane is not exactly 0")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(choice=tuner.choice, result=res, steps=steps,
                ms_by_arm=walls, swaps=swaps, peak_mem_gb=peak)


def race_child() -> int:
    """Phase 16 (d)'s bounded child, under HOROVOD_RACE_CHECK=1 and
    HOROVOD_RACE_CHECK_FAIL=1: phase 14's serving engine (the flagship
    LM, one CUDA graph per bucket) under requests from RACE_CLIENTS
    threads, then one AsyncCheckpointer save persisting beside a
    ResNet-50 training step. Prints one JSON line (reports, stale
    annotations, the instrumented classes); exit 0 only with neither."""
    import tempfile
    import threading
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import ckpt
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.analysis import race
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serve.engine import InferenceEngine

    need(race.active(), "HOROVOD_RACE_CHECK did not enable hvdrace at "
         "import")
    dev = torch.device("cuda", 0)
    cfg = _serve_cfg()
    model = tfm.TransformerLM(cfg, seed=0, device=dev)
    eng = InferenceEngine(serve_infer, model, name="flagship", device=dev)
    eng.warmup((cfg.max_seq,), np.int32, SERVE_BUCKETS)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (8, cfg.max_seq)).astype(np.int32)
    served, errors = [], []

    def client(i):
        rng = np.random.default_rng(i)
        try:
            for _ in range(RACE_REQUESTS):
                n = int(rng.choice(SERVE_BUCKETS))  # a padded batch
                served.append(eng.infer(tokens[:n]).shape)
        except Exception as e:  # noqa: BLE001 - reported by the parent
            errors.append(f"client {i}: {type(e).__name__}: {e}")
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(RACE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    serve_s = time.perf_counter() - t0
    need(not any(t.is_alive() for t in threads), "(d): a client hung")
    need(not errors, f"(d): {errors}")
    need(eng.compiles == len(SERVE_BUCKETS), f"(d): {eng.compiles} "
         f"captures, not {len(SERVE_BUCKETS)}")
    del eng, model
    torch.cuda.empty_cache()

    hvd.init()
    try:
        rnet = sb.build("resnet50", torch.bfloat16, hvd.device())
        opt = sb.make_optimizer(rnet)
        data = sb.make_batch(32, 224, torch.bfloat16, hvd.device(), seed=0)
        sb.train_step(rnet, opt, data, dist.group.WORLD)
        with tempfile.TemporaryDirectory() as tmp:
            saver = ckpt.AsyncCheckpointer(tmp)
            need(saver.save(1, {"params": rnet.state_dict()}),
                 "(d): the checkpoint save was refused")
            loss = float(sb.train_step(rnet, opt, data, dist.group.WORLD))
            need(saver.wait(120), "(d): the writer did not finish")
            saver.close()
    finally:
        hvd.shutdown()
    reports = race.drain()
    stale = race.stale_annotations()
    for r in reports[:5]:
        print(r.render())
    print(json.dumps({
        "race_reports": len(reports), "stale": stale,
        "requests": len(served), "serve_s": serve_s, "loss": loss,
        "instrumented": sorted(c.__name__
                               for c in race._detector._instrumented)}))
    return 0 if not reports and not stale else 1


def race_and_lint() -> dict:
    """Phase 16 (d): race_child in a bounded process, then hvdlint over
    the port with the checked-in (empty) baseline."""
    env = dict(os.environ, HOROVOD_RACE_CHECK="1",
               HOROVOD_RACE_CHECK_FAIL="1", HOROVOD_CONV_BLOCK="1",
               HOROVOD_FUSE_CONV_BN="0")
    t0 = time.perf_counter()
    rc, text = run_bounded([sys.executable, "-c", "import sys, chip_smoke "
                            "as cs; sys.exit(cs.race_child())"], 600, env)
    race_s = time.perf_counter() - t0
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    res = json.loads(lines[-1]) if lines else {}
    print(f"(d) hvdrace over serving ({RACE_CLIENTS} threads x "
          f"{RACE_REQUESTS} requests on the flagship LM's engine, "
          f"{res.get('requests')} served in {res.get('serve_s', 0):.1f} s) "
          f"and an async checkpoint beside a ResNet-50 step: exit code "
          f"{rc}, {res.get('race_reports')} reports, stale annotations "
          f"{res.get('stale')}, {len(res.get('instrumented', []))} classes "
          f"instrumented, {race_s:.1f} s")
    need(rc == 0 and res.get("race_reports") == 0 and res.get("stale") == []
         and res.get("requests") == RACE_CLIENTS * RACE_REQUESTS,
         f"(d): hvdrace failed ({rc}):\n{text[-4000:]}")
    base = "horovod_tpu_torch/analysis/hvdlint_baseline.json"
    t0 = time.perf_counter()
    rc, lint = run_bounded([sys.executable, "-m",
                            "horovod_tpu_torch.analysis",
                            "horovod_tpu_torch", "--baseline", base], 600)
    lint_s = time.perf_counter() - t0
    print(f"(d) python -m horovod_tpu_torch.analysis horovod_tpu_torch "
          f"--baseline {base}: exit code {rc}, "
          f"{lint.strip().splitlines()[-1] if lint.strip() else ''!r}, "
          f"{lint_s:.1f} s")
    need(rc == 0, f"(d): hvdlint over the port failed:\n{lint[-4000:]}")
    return dict(race=res, race_s=race_s, lint_rc=rc, lint_s=lint_s)


def layout_path() -> dict:
    """Phase 16 (see the module docstring)."""
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        out, declared, plan, data = layout_plans()
        out["c"] = layout_tuner(declared, plan, data)
    finally:
        hvd.shutdown()
    del declared, data
    import torch
    torch.cuda.empty_cache()
    out["d"] = race_and_lint()
    return out


# ------------------------------ phase 17: frontends and orchestration

FRAMEWORKS = ("tensorflow", "keras", "pandas", "pyarrow", "fsspec",
              "cloudpickle", "pyspark", "ray", "mxnet")
ORCH_STEPS = 3             # phase 17 (b): the Spark-elastic worker's steps
ORCH_TIMEOUT_S = 400       # phase 17 (b), (c): one job's bound
ESTIMATOR_EPOCHS = 2       # phase 17 (c): one step an epoch (32 rows)
TRANSFORM_ROWS = 8
ELASTIC_CARDS = 2          # spark_elastic_cards: workers, one card each
# phase 17 (c): TorchModel.transform against the trained module's own
# eval-mode forward on the same 8 rows, max|Δ| / max|ref|: the same
# module, input and card, so only a library choice of another call
# could move it; one bf16 step of the logits' scale.
TOL_TRANSFORM = 2.0 ** -7
BLOCK_ENV = {"HOROVOD_CONV_BLOCK": "1", "HOROVOD_FUSE_CONV_BN": "0"}


def frameworks() -> dict:
    """Phase 17 (a): which of FRAMEWORKS this machine has."""
    import importlib.util
    return {m: importlib.util.find_spec(m) is not None for m in FRAMEWORKS}


def spark_elastic_worker(steps: int = ORCH_STEPS) -> dict:
    """One rank of phase 17 (b), run by a Spark-elastic agent's worker:
    `hvd.init()` as the estimator's trainers call it (the card, since
    no CPU request is passed), ResNet-50 at full width from phase 4's
    seed-0 weights on phase 4's batch, `steps` steps with the launch
    counters set to 0 just before and read just after."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.spark.backend import worker_device

    hvd.init(device=worker_device())
    try:
        dev = hvd.device()
        model = sb.build("resnet50", torch.bfloat16, dev)
        opt = sb.make_optimizer(model)
        batch = sb.make_batch(32, 224, torch.bfloat16, dev, seed=hvd.rank())
        reset_counters()
        losses, ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(sb.train_step(model, opt, batch,
                                        dist.group.WORLD).item())
            ms.append((time.perf_counter() - t0) * 1e3)
        return {"losses": losses, "step_ms": ms, "launches": read_counters(),
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else str(dev)),
                "card": dev.index, "local_rank": hvd.local_rank(),
                "backend": dist.get_backend(), "world": hvd.size(),
                "elastic": topology.config().elastic}
    finally:
        hvd.shutdown()


def _bounded(fn, what: str, timeout: float = ORCH_TIMEOUT_S):
    """fn() in a daemon thread, its result or its exception; Failed past
    `timeout` seconds."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    need(not t.is_alive(), f"{what}: still running after {timeout} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def spark_elastic_part(block_loss: float) -> dict:
    """Phase 17 (b): spark.elastic.run_elastic with its agents in threads
    (thread_agent_runner) and one worker on the card."""
    import torch
    from horovod_tpu_torch.spark import elastic as spe
    # By its module's name (pickle refers to a function by its module).
    from chip_smoke import spark_elastic_worker as worker
    t0 = time.perf_counter()
    res = _bounded(lambda: spe.run_elastic(
        worker, num_proc=1, start_timeout=120, elastic_timeout=300,
        extra_env=dict(BLOCK_ENV),
        _agent_runner=spe.thread_agent_runner()), "phase 17 (b)")
    wall = time.perf_counter() - t0
    need(len(res) == 1 and res[0] is not None,
         f"phase 17 (b): results {res}")
    r = res[0]
    losses = r["losses"]
    rel = abs(losses[0] - block_loss) / max(abs(block_loss), 1e-6)
    per_step = {k: v / ORCH_STEPS for k, v in r["launches"].items()}
    step_ms = sum(r["step_ms"][1:]) / (ORCH_STEPS - 1)
    print(f"(b) spark elastic: worker on {r['device']} ({r['backend']}, "
          f"elastic {r['elastic']}, world {r['world']}); losses "
          f"{[round(v, 6) for v in losses]}, phase 4's first "
          f"{block_loss:.6f}, relative difference {rel:.3g} (tolerance "
          f"{TOL_LAUNCHED_LOSS}); {step_ms:.2f} ms a step after the "
          f"first ({r['step_ms'][0]:.1f} ms); launches a step {per_step}; "
          f"{wall:.1f} s")
    need(r["device"] == torch.cuda.get_device_name(0) and r["card"] == 0
         and r["local_rank"] == 0 and r["backend"] == "nccl"
         and r["elastic"],
         "phase 17 (b): the worker did not run elastic NCCL on the card")
    need(all(math.isfinite(v) for v in losses),
         f"phase 17 (b): non-finite loss {losses}")
    need(per_step["fwd"] == 28 and per_step["act_bwd"] == 28
         and per_step["bn_bwd"] == 0,
         f"phase 17 (b): expected 28 + 28 launches a step, got "
         f"{r['launches']}")
    need(rel <= TOL_LAUNCHED_LOSS, "phase 17 (b): the first loss disagrees "
         "with phase 4's")
    return dict(r, loss_phase4=block_loss, loss_rel=rel,
                step_ms_after_first=step_ms, seconds=wall)


def spark_elastic_cards() -> list:
    """Spark elastic on one machine of ELASTIC_CARDS or more cards (not
    part of the one-card run; .claude/skills/verify/SKILL.md gives the
    command): ELASTIC_CARDS threaded agents, each worker training
    ResNet-50 as in phase 17 (b), must form one NCCL world whose local
    ranks 0, 1, ... hold cards cuda:0, cuda:1, ..., 28 + 28 launches a
    step each."""
    import torch
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.spark import elastic as spe
    from chip_smoke import spark_elastic_worker as worker
    num_proc = ELASTIC_CARDS
    need(torch.cuda.device_count() >= num_proc,
         f"spark elastic on cards: {torch.cuda.device_count()} card(s), "
         f"{num_proc} asked for")
    kernels.build_all(kernels.CONV_SOURCES)  # once, before the workers
    t0 = time.perf_counter()
    res = _bounded(lambda: spe.run_elastic(
        worker, num_proc=num_proc, min_num_proc=num_proc,
        start_timeout=120, elastic_timeout=300, extra_env=dict(BLOCK_ENV),
        _agent_runner=spe.thread_agent_runner()), "spark elastic on cards")
    wall = time.perf_counter() - t0
    need(len(res) == num_proc and all(r is not None for r in res),
         f"spark elastic on cards: results {res}")
    for rank, r in enumerate(res):
        print(f"spark elastic on cards: rank {rank} local rank "
              f"{r['local_rank']} on cuda:{r['card']} ({r['device']}, "
              f"{r['backend']}, world {r['world']}); losses "
              f"{[round(v, 6) for v in r['losses']]}; "
              f"{sum(r['step_ms'][1:]) / (ORCH_STEPS - 1):.2f} ms a step "
              f"after the first; launches {r['launches']}")
    print(f"spark elastic on cards: {wall:.1f} s")
    need(sorted(r["card"] for r in res) == list(range(num_proc))
         and all(r["card"] == r["local_rank"] for r in res),
         "spark elastic on cards: the workers did not take one card each")
    need(all(r["backend"] == "nccl" and r["world"] == num_proc
             and r["elastic"] for r in res),
         "spark elastic on cards: not one elastic NCCL world")
    need(all(math.isfinite(v) for r in res for v in r["losses"]),
         "spark elastic on cards: non-finite loss")
    need(all(r["launches"]["fwd"] == 28 * ORCH_STEPS
             and r["launches"]["act_bwd"] == 28 * ORCH_STEPS for r in res),
         "spark elastic on cards: expected 28 + 28 launches a step")
    return res


def _estimator_resnet():
    """(module, loss) for phase 17 (c): ResNet-50 from the seed-0 weights
    (built on the host, as the estimator ships it) taking float32 NHWC
    images, cast to the model's bf16, and giving f32 logits; in training
    it installs each step's batch stats, as synthetic_benchmark.
    train_step does; the loss is resnet.loss_fn's cross-entropy. Both
    travel to the worker by value (cloudpickle)."""
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch.models import resnet

    class EstimatorResNet(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            group = dist.group.WORLD if self.training \
                and dist.is_initialized() else None
            logits, stats = self.net(x.to(torch.bfloat16),
                                     train=self.training, group=group)
            if self.training:
                self.net.set_stats(stats)
            return logits.float()

    def xent(preds, y):
        return -torch.log_softmax(preds, dim=-1).gather(1, y[:, None]).mean()

    net = resnet.ResNet(depth=50, dtype=torch.bfloat16, device="cpu", seed=0)
    return EstimatorResNet(net), xent


def estimator_part(block_loss: float) -> dict:
    """Phase 17 (c): TorchEstimator on ResNet-50 through LocalBackend(1)
    (no CPU request), then TorchModel.transform on the card."""
    import shutil
    import tempfile

    import numpy as np
    import pandas as pd
    import torch
    from horovod_tpu_torch import spark as hs
    from horovod_tpu_torch import synthetic_benchmark as sb

    dev = torch.device("cuda", 0)
    x, y = sb.make_batch(32, 224, torch.bfloat16, dev, seed=0)  # phase 4's
    imgs = x.float().cpu().numpy()  # exact: every bf16 is an f32
    df = pd.DataFrame({"img": list(imgs),
                       "label": y.cpu().numpy().astype(np.int64)})
    tmp = tempfile.mkdtemp(prefix="hvd_estimator_")
    counts_path = os.path.join(tmp, "launches.jsonl")

    def on_epoch(epoch, logs, _path=counts_path):
        # Rank 0's callback, in the worker after each epoch: the
        # worker's cumulative launches (0 at its start).
        import json as _json

        from horovod_tpu_torch.core import topology as _top
        from horovod_tpu_torch.ops import conv_block as _cb
        from horovod_tpu_torch.ops import conv_bn_backward as _cbb
        with open(_path, "a") as f:
            f.write(_json.dumps({
                "epoch": epoch, "device": str(_top.device()),
                "fwd": _cb.conv1x1_fwd_fused.launches,
                "act_bwd": _cb.conv1x1_bn_act_bwd_fused.launches,
                "bn_bwd": _cbb.conv1x1_bn_bwd_fused.launches}) + "\n")

    model, loss = _estimator_resnet()
    try:
        t0 = time.perf_counter()
        est = hs.TorchEstimator(
            model=model, loss=loss,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            featureCols=["img"], labelCols=["label"],
            store=hs.LocalStore(os.path.join(tmp, "store")), batchSize=32,
            epochs=ESTIMATOR_EPOCHS, shuffle=False, callbacks=[on_epoch],
            backend=hs.LocalBackend(1, extra_env=dict(BLOCK_ENV)),
            verbose=0)
        fitted = _bounded(lambda: est.fit(df), "phase 17 (c) fit")
        fit_s = time.perf_counter() - t0
        with open(counts_path) as f:
            counts = [json.loads(line) for line in f]
        t0 = time.perf_counter()
        out = fitted.transform(df.head(TRANSFORM_ROWS))
        transform_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    preds = np.stack(out["label__output"].to_list())
    # transform ran on the device of TorchModel's copy; the stored module
    # stays on the host
    on = fitted._built[0]
    stored_on = next(fitted.getModel().parameters()).device
    trained = copy.deepcopy(fitted.getModel()).to(on)
    with torch.no_grad():
        trained.eval()
        ref = trained(torch.from_numpy(imgs[:TRANSFORM_ROWS]).to(on)).cpu()
    err = float(np.max(np.abs(preds - ref.numpy()))) / max(
        float(ref.abs().max()), 1e-6)
    losses = [h["loss"] for h in fitted.history]
    rel = abs(losses[0] - block_loss) / max(abs(block_loss), 1e-6)
    print(f"(c) torch estimator: fit {fit_s:.1f} s, worker on "
          f"{counts[0]['device']}; epoch losses "
          f"{[round(v, 6) for v in losses]}, phase 4's first "
          f"{block_loss:.6f}, relative difference {rel:.3g} (tolerance "
          f"{TOL_LAUNCHED_LOSS}); launches after step 1 {counts[0]}; "
          f"transform of {TRANSFORM_ROWS} rows on {on} (the stored "
          f"module on {stored_on}) in "
          f"{transform_s:.2f} s, against the module's eval forward "
          f"{err:.3g} (tolerance {TOL_TRANSFORM})")
    need(counts[0]["device"].startswith("cuda"),
         "phase 17 (c): the estimator's worker did not take the card")
    need(counts[0]["fwd"] == 28 and counts[0]["act_bwd"] == 28
         and counts[0]["bn_bwd"] == 0,
         f"phase 17 (c): expected 28 + 28 launches in the first step, got "
         f"{counts[0]}")
    need(len(losses) == ESTIMATOR_EPOCHS
         and all(math.isfinite(v) for v in losses),
         f"phase 17 (c): losses {losses}")
    need(rel <= TOL_LAUNCHED_LOSS, "phase 17 (c): epoch 1's loss disagrees "
         "with phase 4's first")
    need(on.type == "cuda", "phase 17 (c): transform did not run on the "
         "card")
    need(stored_on.type == "cpu", "phase 17 (c): transform moved the "
         "stored module off the host")
    need(preds.shape == (TRANSFORM_ROWS, 1000) and np.isfinite(preds).all(),
         f"phase 17 (c): transform gave {preds.shape}")
    need(err <= TOL_TRANSFORM, "phase 17 (c): transform disagrees with the "
         "module's eval forward")
    return {"losses": losses, "loss_phase4": block_loss, "loss_rel": rel,
            "launches_step1": counts[0], "fit_s": fit_s,
            "transform_s": transform_s, "transform_err": err}


def tf_part() -> dict:
    """Phase 17 (d): allreduce of a TF tensor through the port, Sum and
    Average, eagerly and in a tf.function, bit for bit against numpy in
    a world of one."""
    import numpy as np
    import tensorflow as tf
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.frontends.tensorflow as tfvd

    tfvd.init()
    try:
        dev = hvd.device()
        x = np.random.default_rng(0).standard_normal((1024, 256)).astype(
            np.float32)
        t = tf.constant(x)
        graph = tf.function(lambda a, op: tfvd.allreduce(a, op=op))
        out = {}
        for name in ("Sum", "Average"):
            op = getattr(tfvd, name)
            out[f"{name}_eager"] = bool(np.array_equal(
                tfvd.allreduce(t, op=op).numpy(), x))
            out[f"{name}_graph"] = bool(np.array_equal(
                graph(t, op).numpy(), x))
        print(f"(d) TF frontend: allreduce on {dev} "
              f"({torch.cuda.get_device_name(dev)}), bit for bit against "
              f"numpy: {out}")
        need(dev.type == "cuda" and all(out.values()),
             f"phase 17 (d): {out} on {dev}")
        return {"device": str(dev), "bitwise": out}
    finally:
        tfvd.shutdown()


def frontends_path(block_loss: float) -> dict:
    """Phase 17 (see the module docstring)."""
    have = frameworks()
    print("(a) frameworks on this machine: " + ", ".join(
        f"{m} {'present' if ok else 'absent'}" for m, ok in have.items()))
    out = {"frameworks": have, "b": spark_elastic_part(block_loss)}
    missing = [m for m in ("pandas", "pyarrow") if not have[m]]
    if missing:
        print(f"(c) torch estimator: not run: {missing[0]} absent on this "
              f"machine")
        out["c"] = None
    else:
        out["c"] = estimator_part(block_loss)
    if have["tensorflow"]:
        out["d"] = tf_part()
    else:
        print("(d) TF frontend: not run: tensorflow absent on this machine")
        out["d"] = None
    return out


# -------------------- phase 18: the analyzers of recorded step programs

ANALYZER_FAMILIES = ("hlo", "shard", "sched", "num")


def _kernel_ops(prog) -> dict:
    """custom_call ops of a recorded program by kernel name."""
    out = {}
    for op in prog.ops:
        if op.opcode == "custom_call":
            name = op.attrs.split('custom_call_target="')[1].split('"')[0]
            out[name] = out.get(name, 0) + 1
    return out


def _findings_by_rule(prog) -> dict:
    """Every family's findings on one recorded program, by rule."""
    from horovod_tpu_torch.analysis import hlo, numerics, schedule, shard
    fs = (hlo.lint_program(prog) + shard.lint_program(prog)
          + schedule.lint_programs([prog]) + numerics.lint_programs([prog]))
    out = {}
    for f in fs:
        out[f.rule_id] = out.get(f.rule_id, 0) + 1
    return out


def _recorded_step(name, run, dev):
    """Run `run()` (one training step) under the recorder, the launch
    counters set to 0 just before and read just after and the peak memory
    reset; returns (step output, program, launches, summary)."""
    import torch
    from horovod_tpu_torch.analysis import graph, shard
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    t0 = time.perf_counter()
    out, prog = graph.record(run, path=f"<phase18:{name}>")
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    launches = read_counters()
    t1 = time.perf_counter()
    rules = _findings_by_rule(prog)
    est = shard.peak_memory(prog)
    lint_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev)
    summary = dict(ops=len(prog.ops), params=len(prog.params),
                   kernel_ops=_kernel_ops(prog), launches=launches,
                   findings=rules, estimate_bytes=est.peak_bytes,
                   max_memory_allocated=peak,
                   ratio=est.peak_bytes / peak, record_s=step_s,
                   lint_s=lint_s, device_memory=prog.device_memory)
    print(f"({name}) recorded {len(prog.ops)} ops, {len(prog.params)} entry "
          f"parameters in {step_s:.2f} s, linted in {lint_s:.2f} s; kernel "
          f"ops {summary['kernel_ops']}; launches {launches}; findings by "
          f"rule {json.dumps(rules, sort_keys=True)}")
    print(f"({name}) HVD303 peak-memory estimate {est.peak_bytes / 1e9:.3f} "
          f"GB, max_memory_allocated {peak / 1e9:.3f} GB, ratio "
          f"{summary['ratio']:.4f} (HVD303's budget, the recording card's "
          f"memory: {(prog.device_memory or 0) / 1e9:.1f} GB)")
    return out, prog, launches, summary


def analyzers_path(block_loss: float, serving: dict) -> dict:
    """Phase 18 (see the module docstring)."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm

    out = {}
    t0 = time.perf_counter()
    hvd.init()
    try:
        dev = hvd.device()
        # (a) phase 4's block-route step, its first, from the same weights
        os.environ["HOROVOD_CONV_BLOCK"] = "1"
        os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
        model = sb.build("resnet50", torch.bfloat16, dev)
        opt = sb.make_optimizer(model)
        data = sb.make_batch(32, 224, torch.bfloat16, dev, seed=hvd.rank())
        loss, prog, launches, a = _recorded_step(
            "a", lambda: sb.train_step(model, opt, data, dist.group.WORLD),
            dev)
        a["loss"] = float(loss)
        # the gradient buckets' all-reduces (the sync-BN ones of the
        # block route come from ops/sync_batch_norm.py)
        payloads = [int(op.attrs.split("payload_bytes=")[1].split(",")[0])
                    for op in prog.ops if op.opcode == "all_reduce"
                    and "DistributedOptimizer._hook" in op.attrs]
        grad_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters() if p.requires_grad)
        a.update(buckets=len(opt.plan), all_reduces=len(payloads),
                 payloads=payloads, grad_bytes=grad_bytes)
        print(f"(a) ResNet-50 224² bf16 batch 32: loss {a['loss']!r}, phase "
              f"4's first {block_loss!r}; {len(payloads)} gradient "
              f"all-reduces for the {len(opt.plan)}-bucket plan, payload "
              f"MiB {[round(b / 2 ** 20, 2) for b in payloads]} (sum "
              f"{sum(payloads)}, gradients {grad_bytes} bytes)")
        need(a["kernel_ops"] == {"conv1x1_fwd_fused": 28,
                                 "conv1x1_bn_act_bwd_fused": 28},
             f"(a): kernel ops {a['kernel_ops']}, not 28 + 28")
        need(launches["fwd"] == 28 and launches["act_bwd"] == 28
             and sum(launches.values()) == 56,
             f"(a): launches {launches}, not 28 + 28")
        need(a["loss"] == block_loss, "(a): the recorded step's loss is not "
             "phase 4's bit for bit")
        need("HVD504" not in a["findings"], "(a): HVD504 on the ResNet "
             "step: its loss gather's backward writes each address once")
        need(prog.device_memory == torch.cuda.get_device_properties(
            dev).total_memory, "(a): the program's budget is not the card's "
             "memory")
        need(len(payloads) == len(opt.plan) and sum(payloads) == grad_bytes,
             "(a): the all-reduces are not the bucket plan's")
        out["a"] = a
        del model, opt, data, prog
        torch.cuda.empty_cache()

        # (b) phase 5's flagship LM step (Adam: one step first makes its
        # state, which the recorded step then reads as entry tensors)
        cfg = tfm.TransformerConfig(**lm.FLAGSHIP, attn="flash",
                                    dtype=torch.bfloat16)
        model, opt, step = lm.build(cfg, dev)
        data = lm.make_batch(lm.FLAGSHIP_BATCH, cfg.max_seq, cfg.vocab, dev,
                             seed=hvd.rank())
        step(data)
        loss, prog, launches, b = _recorded_step("b", lambda: step(data),
                                                 dev)
        b["loss"] = float(loss)
        n = cfg.n_layers
        need(b["kernel_ops"] == {"flash_fwd": n, "flash_bwd_dkdv": n,
                                 "flash_bwd_dq": n},
             f"(b): kernel ops {b['kernel_ops']}, not {n} + {n} + {n}")
        need(launches["attn_fwd"] == n and launches["attn_dkdv"] == n
             and launches["attn_dq"] == n,
             f"(b): launches {launches}, not {n} + {n} + {n}")
        need(math.isfinite(b["loss"]), "(b): non-finite loss")
        need("HVD504" not in b["findings"], "(b): HVD504 on the LM step, "
             "which phase 5's C13 check found deterministic")
        out["b"] = b
        del model, opt, step, data, prog
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()

    # (c) phase 14's engine: each bucket's warm-up recorded and linted
    c = serving["in_process"]["hlo_lint"]
    per = serving["in_process"]["kernel_ops"]
    print(f"(c) serving stamp over buckets {sorted(per)}: "
          f"{json.dumps(c, sort_keys=True)}; kernel ops per bucket "
          f"{json.dumps(per, sort_keys=True)}")
    need("error" not in c, f"(c): the stamp holds an error: "
         f"{c.get('error')}")
    need(c["programs"] == len(SERVE_BUCKETS)
         and sorted(per) == list(SERVE_BUCKETS)
         and all(k == {"flash_fwd": 12} for k in per.values()),
         "(c): not 12 kernel-4 ops in each bucket's program")
    out["c"] = dict(stamp=c, kernel_ops=per)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 18 wall: {out['wall_s']:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_s = {}

    def lap(name):
        """Wall seconds of the phase that just ended."""
        phase_s[name] = time.perf_counter() - t0 - sum(phase_s.values())
        print(f"phase {name}: {phase_s[name]:.1f} s")

    kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(kernels.SOURCES)} kernels in {build_s:.1f} s")
    for name, log in kernels.ptxas_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "setmaxnreg", "Performance",
                                       "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}")
    sass = sass_counts()
    tf32 = tf32_instance_report()
    lap("1 build")

    errs = check_kernels(dev, torch.bfloat16)  # the main path's type
    errs32 = check_kernels(dev, torch.float32)
    repeat = repeat_check(dev)
    ferrs, flash_checks = check_flash(dev)
    errs.update(ferrs)
    agg, detail = time_kernels(dev, torch.bfloat16)
    agg32, detail32 = time_kernels(dev, torch.float32)
    for tag, a in (("bf16", agg), ("f32", agg32)):
        for k, t in a.items():
            print(f"time {k} {tag} per ResNet-50 step: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, library "
                  f"{t['library_ms']:.4f}"
                  + (f" (tf32 {t['library_tf32_ms']:.4f})"
                     if "library_tf32_ms" in t else "")
                  + f", bound {t['bound_ms']:.4f}")
    agg.update(time_flash(dev))
    flash_simple = time_flash_simple(dev)
    wide = flash_simple["bf16_dh512"]  # the wide path
    torch.cuda.empty_cache()
    lap("2-3 kernel checks and times")

    hvd.init()
    path = main_path()
    torch.cuda.empty_cache()
    path["f32"] = resnet_f32_check()
    torch.cuda.empty_cache()
    lap("4 ResNet main path")
    lm = lm_path()
    torch.cuda.empty_cache()
    lm["c13"] = lm_determinism_check()
    hvd.shutdown()
    torch.cuda.empty_cache()
    lap("5 LM main path")
    launched = launched_path(path["block"]["losses"][0],
                             path["block"]["step_ms"])
    lap("6 launcher")
    collectives = collectives_path()
    lap("7 collectives")
    training = training_api_path()
    lap("8 training API")
    observed = observed_path(agg["fwd"]["ms"] + agg["act_bwd"]["ms"])
    lap("9 observed path")
    elastic_run = elastic_path()
    lap("10 elastic and checkpointing")
    sp_run = sequence_parallel_path(lm)
    lap("11 sequence parallelism")
    others = other_models_path()
    lap("12 other models and the API surface")
    observability = observability_path()
    lap("13 observability and the control plane")
    serving = serving_path()
    lap("14 serving, the record readers and the data service")
    parallel = parallel_path(lm)
    lap("15 tensor, pipeline and expert parallelism")
    layout_run = layout_path()
    lap("16 the layout pass, its tuner, hvdrace and hvdlint")
    frontends = frontends_path(path["block"]["losses"][0])
    lap("17 frontends and orchestration")
    analyzers = analyzers_path(path["block"]["losses"][0], serving)
    lap("18 the analyzers of recorded step programs")
    print(f"total: {time.perf_counter() - t0:.1f} s")

    src = "horovod_tpu_torch/csrc/"
    fa = "horovod_tpu/ops/flash_attention.py"
    meta = {"fwd": ("conv1x1_fwd_fused", src + "conv1x1_fwd.cu",
                    "horovod_tpu/ops/conv_block.py:192"),
            "act_bwd": ("conv1x1_bn_act_bwd_fused",
                        src + "conv1x1_bn_act_bwd.cu",
                        "horovod_tpu/ops/conv_block.py:323"),
            "bn_bwd": ("conv1x1_bn_bwd_fused", src + "conv1x1_bn_bwd.cu",
                       "horovod_tpu/ops/conv_bn_backward.py:186"),
            "attn_fwd": ("flash_fwd", src + "flash_fwd.cu", fa + ":105"),
            "attn_dkdv": ("flash_bwd_dkdv", src + "flash_bwd_dkdv.cu",
                          fa + ":274"),
            "attn_dq": ("flash_bwd_dq", src + "flash_bwd_dq.cu",
                        fa + ":303")}
    launches = dict(path["block"]["launches"])
    launches["bn_bwd"] = path["fuse_bn"]["launches"]["bn_bwd"]
    for k in ("attn_fwd", "attn_dkdv", "attn_dq"):
        launches[k] = lm["launches"][k]
    line = {"kernels": [
        {"name": meta[k][0], "route": "cuda", "source": meta[k][1],
         "replaces": meta[k][2], "launches": launches[k],
         "max_abs_err": errs[k], "ms": agg[k]["ms"],
         "plain_ms": agg[k]["plain_ms"], "bound_ms": agg[k]["bound_ms"],
         "bound_by": ("bytes" if agg[k]["bytes_ms"] >= agg[k]["flops_ms"]
                      else "operations"),
         "library_ms": agg[k]["library_ms"]} for k in meta]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke.json", "w") as f:
        json.dump({"build_s": build_s, "sass": sass, "repeat": repeat,
                   "tf32_instance": tf32, "flash_simple": flash_simple,
                   "flash_wide_dh512": wide,
                   "attn_bwd_pair": agg["attn_bwd_pair"],
                   "kernels": line["kernels"],
                   "sites": detail + detail32, "conv_f32": agg32,
                   "conv_f32_max_abs_err": errs32,
                   "flash_checks": flash_checks, "main_path": path,
                   "lm_path": lm, "launched_path": launched,
                   "collectives_path": collectives,
                   "training_api_path": training,
                   "observed_path": observed,
                   "elastic_path": elastic_run,
                   "sequence_parallel_path": sp_run,
                   "other_models_path": others,
                   "observability_path": observability,
                   "serving_path": serving,
                   "parallel_path": parallel,
                   "layout_path": layout_run,
                   "frontends_path": frontends,
                   "analyzers_path": analyzers,
                   "phase_s": phase_s,
                   "nvidia_smi": smi}, f, indent=1)
    print(json.dumps(line))
    need(bool(smi), "nvidia-smi gave no card name and power limit")
    print(smi[0])  # as nvidia-smi gives them: "<name>, <power.limit>"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
