#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's two kernel paths through the entry points a user calls,
at full width, and holds every kernel against its plain PyTorch version:

* chess_hvp, the main path: ``engine.plan(f, 64, m=524288, csize="auto")``
  then ``plan.batched_hvp(A, V)`` for the paper's three test functions on
  both schedules, at the paper's scale (0.5M instances, n=64); then the
  same path with bfloat16 A and V, and with chunks wider than 64 lanes
  (csize 128 and 96, m = 65,536), both resolved to the kernel by
  ``backend="auto"``.
* hdual_linear, through ``kernels.ops.hdual_linear_apply``: hDuals of
  T = 524,288 points at n = 64 (c = 4 and 8) and a 2560-wide layer
  (T = 4,096, c = 4), float32 and bfloat16, every one on the kernel's
  tensor-core (wgmma) variant; and a sin network with two
  hdual_linear_apply maps whose Hessian chunk is checked in float64.
* the tuner: ``engine.plan(f, 64, m=524288, csize="autotune")`` for the
  three functions on both schedules -- the joint csize x backend x blk_m
  sweep on the card, where ``blk_m`` is chess_hvp's instances per CTA --
  then each tuned plan's ``batched_hvp`` at full width; a second process on
  the same store; every instance block against the kernel's own pick; and
  the service's default online re-tune (``autotune_buckets``).
* the served path: ``CurvatureService`` + ``CurvatureFrontend`` built as
  ``repro_torch.launch.serve`` builds them, on the card, 8 TCP clients:
  2,048 HVPs of each test function at n = 64, 1,024 Rosenbrock HVPs at
  n in {48, 56, 64} and 8 Hessians at n = 16; every dense HVP bucket runs
  chess_hvp, mixed-n buckets the ragged torch.func path.
* pytree curvature: ``engine.plan(tgt.loss, None, device="cuda", ...)`` on
  the full-width h2o-danube-1.8b loss (1.83B float32 params, bfloat16
  compute, 2 x 512 tokens): hvp, quadform, ggn, fisher and diag, and diag
  through a service; no kernel lies on this path (torch.func).
* optim and training: ``make_train_step`` with AdamW, then SophiaH, on
  the same full-width loss (B = 2 x S = 512); the loop, the entry point
  ``python -m repro_torch.launch.train`` and its resume; Newton-CG on the
  three test functions at n = 64.  Every train-mode forward under a
  gradient recomputes its layers in the backward (``cfg.remat``).  No kernel lies on this path either:
  Newton-CG's single-point ``hvp`` resolves to ``vmap_l2``.
* CHESSFAD across devices: ``engine.plan(f, n, mesh=mesh)`` on an NCCL
  ``DeviceMesh`` of the one card (``launch.mesh.make_test_mesh``):
  ``sharded`` batched HVPs at m = 2,048, n = 64 and ``sharded_rows`` HVPs
  and Hessians at n = 512, both layouts, against the mesh-less plans and a
  float64 oracle; the collectives of ``repro_torch.parallel``.  No kernel
  lies on this path, as in the reference (the ``cuda`` backend vetoes mesh
  plans).
* the trainer across devices: ``make_train_step(cfg, mesh, adamw)`` with
  the state as DTensors, ``make_shard_map_train_step`` with each
  compression, ``training.pipeline.pipeline_forward`` and ``python -m
  repro_torch.launch.train --data-mesh 1`` with its resume, in an NCCL
  world of one at the same full width.  No kernel lies on this path.
* LM decode: ``prefill`` / ``decode_step`` against KV caches (bfloat16 and
  int8) and ``models.decode_engine.ServingEngine`` (continuous batching,
  8 slots) on the same full-width model; the KV cache policy from the
  curvature phase's diag spectrum.  No kernel lies on this path either:
  the reference's decode is plain XLA einsums.
* the MoE, SSM and hybrid families: curvature, training, decode, int8
  caches and the engine on the full-width granite-moe-1b-a400m,
  zamba2-1.2b and mamba2-2.7b; the expert-parallel MoE in an NCCL world
  of one.  No kernel lies on this path: the reference's MoE dispatch and
  SSD scan are plain XLA.
* the enc-dec and VLM families: curvature, training and decode on the
  full-width whisper-base (its 1,500 audio frames) and internvl2-1b (its
  256 patches), internvl2's engine text-only; remat on and off on the
  dense curvature loss.  No kernel lies on this path either.

Phases, each fatal on failure:

  1. toolchain: the card's name and power limit, torch/CUDA, nvcc versions,
     TF32 off (the plain versions' matrix products are IEEE float32)
  2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
     process per source (seconds, registers and spills); cuobjdump -sass
     shows HGMMA (wgmma) in every tensor-core instantiation of hdual_linear
  3. each kernel against its plain version on the card at the CPU tests'
     shapes: chess_hvp in float32, bfloat16, float16, csize 65-128 and n on
     both sides of Fletcher-Powell's staging size
     (rtol 5e-3, atol 5e-3 * (1 + max|want|), the reference's kernel
     tolerance); hdual_linear at the reference's sweep shapes and tiles
     (float32 rtol 1e-5, atol 1e-5 * din; bfloat16 1e-1, 1e-1 * din)
  4. chess_hvp's main path at full width (launch counts zeroed before it and
     read after): backend ``cuda``, one launch per call, finite output whose
     first, middle and last 256 rows equal the plain version's; a float64
     torch.func HVP on a few instances; CUDA-event timing against the bound
     of the work the active coordinates need (``needed_work``), with the
     first kernel's dense bound (``work``) beside it; then the bfloat16 and
     wide-chunk cases; a time that beats its needed bound fails
  5. hdual_linear's path at full width (counts zeroed before it and read
     after): one launch per hdual_linear_apply, of the wgmma variant, every
     element of the output against the plain version at the output's own
     scale (float32 rtol 1e-5, bfloat16 rtol 1e-2, both atol
     1e-5 * (1 + max|want|)), a bound shown to reject an all-zero output
     and, in float32, a TF32-rounded product of the same inputs; CUDA-event
     timing of the call, the kernel on the stacked components, its simt
     variant (the FFMA kernel) on the same data, the plain version and
     torch.matmul (the yardstick), against the least time of the card's
     routes for the same work (float32: bytes, or the faster of FFMA and
     three TF32 products), with the card's clocks, power and temperature
     read before and after
  6. the network check: sin(x W1) . W2 through two hdual_linear_apply maps,
     one Hessian chunk against float64 torch.func.hessian
  7. the tuner on the card (store: a fresh ``chiprun_out/autotune_store.json``
     named by ``REPRO_TORCH_AUTOTUNE_CACHE``): (a) the six
     ``plan(..., csize="autotune")`` sweeps, each winner on ``cuda`` with no
     ``cuda`` candidate raising, printed with its candidate count, sweep
     time and probes; (b) the six tuned plans' ``batched_hvp`` at m =
     524,288 (counts zeroed before, read after): one launch a call, the
     first, middle and last 256 rows against the plain version at phase 4's
     tolerance, CUDA-event times beside the ``csize="auto"`` plan's in
     turns, against the needed bound; (c) a second process (``repro_torch``
     only) on the same store plans the same six with zero probes, to the
     same winners; (d) every ``instance_blocks`` entry of each function at
     n = 64, both schedules, and ``ipb=None``, against the plain version at
     the kernel tolerance, timed on 64- and 256-row buckets; (e) the server
     built as phase 8 builds it with no ``tuner=``: one dense round,
     ``svc.retune()`` (hot swaps > 0, no errors, every swapped bucket on
     ``cuda``), the round again with every row checked, every batched_hvp
     bucket on ``cuda`` and chess_hvp's launches equal to the ``cuda``
     batches; us per point by queue and bucket before and after
  8. the served path (counts and telemetry zeroed before its traffic and
     read after): the server on 127.0.0.1, ``max_batch`` 256,
     ``max_wait_us`` 500, cross-n on, ``symmetric=False``; 8 clients, each
     on its own thread with 32 requests in flight, priorities mixed as in
     the server's selftest.  Every dense HVP row against chess_hvp's plain
     version (rtol 5e-3, atol 5e-3 * (1 + max|want|)); every mixed-n row
     and Hessian against float64 torch.func (relative 1e-3, the selftest's
     bound); chess_hvp's launches equal to the batched_hvp batches the
     telemetry records, every one of them on backend ``cuda``; ragged
     batches > 0; one dense bucket under ``obs.profile_session``, whose
     trace must name the kernel and its ``repro:batched_hvp:cuda:b<k>``
     range.  Prints requests per second, p50/p99 round trip, batches and
     rows by bucket, each queue's us per point, and the same points
     through one ``plan.batched_hvp`` call (CUDA events)
  9. pytree curvature (kernel launch counts read before and after: the
     phase launches neither kernel).  (a) The full-width h2o-danube-1.8b
     loss, params and tokens (B = 2, S = 512) from a seeded generator on
     the card, ``lm_curvature_targets``, one plan (``n_probes`` 4, csize
     1) whose hvp/diag/ggn/fisher resolve to ``pytree_fwdrev`` and
     quadform to ``pytree_fwd``: each workload's CUDA-event ms (median of
     3 after a warm-up) and peak memory, against the least time for its
     matmul passes (bfloat16 rate; float32 score products at the FFMA
     rate).  Fatal: every output finite; v.Hv from hvp against
     quadform(v, v), and w.Hv against v.Hw, within 1e-3 of ||v|| ||Hv||
     (the bfloat16 bound of the CPU test of the same pair); v.Gv and v.Fv
     >= 0; the diag submitted through a service with budget 4 bitwise
     ``plan.diag`` for the same seed (budget 2 beside it).  (b) The
     reduced config at float32 compute: the same params, v, w and probes
     through the five workloads and block_hessian on the CPU and on the
     card (normalized error 1e-4); then 16 HVP and 8 budgeted diag submits
     from 4 threads to a service on the card, fewer batches than
     requests, every row bitwise the direct call
 10. optim and training (kernel launch counts read before and after: the
     phase launches neither kernel).  (a) The full-width h2o-danube-1.8b
     from seeded params on the card, ``SyntheticTokens`` at B = 2 x S =
     512: 3 steps of ``make_train_step`` with ``adamw(warmup_cosine(3e-4,
     1, 4))``, then 3 with ``sophia_h`` (``hess_every`` 2, 4 probes at
     csize 1, ``hess_batch_frac`` 0.5: steps 0 and 2 estimate); per step
     CUDA-event ms, peak GB (reset before each optimizer), loss, grad norm
     and lr.  Fatal: a non-finite loss, grad norm or state leaf; SophiaH's
     h below 0; params unchanged by a step whose lr is nonzero.  (b) The
     reduced config at float32 compute: 2 AdamW steps from the same
     CPU-made params on the CPU and on the card (losses and params within
     1e-5, normalized).  (c) ``python -m repro_torch.launch.train
     --reduced --steps 6 --ckpt-every 2 --optimizer sophia_h --device
     cuda`` in a process; a ``TrainLoop`` on the card whose step raises
     once at step 3 against an uninterrupted one (final params within
     1e-5, normalized); a second process resuming the first's directory
     to step 8.  (d) Newton-CG at n = 64, ``engine="chessfad"`` (csize 4)
     and ``"fwdrev"``, on Rosenbrock (f < 1e-6, |x - 1| < 1e-3), Ackley
     (monotone) and Fletcher-Powell (gnorm below 1e-4 of its start), the
     two engines' final f within 1e-2; prints the backend ``auto``
     resolved to, outer iterations, HVP calls and ms
 11. CHESSFAD across devices (kernel launch counts read after (a) and at
     the end: the phase launches neither kernel).  (a) While another thread
     holds ``core.funclock.FUNC_LOCK``, a ``cuda`` plan's batched_hvp (m =
     2,048) runs to its end (the lock serializes torch.func transforms, not
     kernel buckets); then an NCCL world of one on ``cuda:0`` and
     ``make_test_mesh((1, 1), ("data", "model"))``.  (b) ``plan(f, 64,
     m=2048, csize="auto", mesh=mesh)`` for the three functions on both
     schedules: batched_hvp on ``sharded``, against the mesh-less plan
     pinned to ``vmap_l2`` and, on 64 instances, float64 torch.func
     (normalized error 1e-5: max|got - want| / (1 + max|want|)).  (c)
     ``plan(f, 512, csize=8, mesh=mesh, row_layout=L)``, both layouts and
     schedules: hvp and hessian on ``sharded_rows``, against the mesh-less
     ``vmap_l2`` plan and float64 torch.func (1e-5).  CUDA-event ms of every
     sharded call beside its mesh-less counterpart, peak GB.  (d)
     ``compressed_psum`` with each method and ``hierarchical_grad_sync`` on
     4M float32, within each method's own rounding.  The process group is
     destroyed at the end of the phase
 12. the trainer across devices, in an NCCL world of one on ``cuda:0``
     (kernel launch counts read before and after: the phase launches
     neither kernel), phase 10's full-width h2o-danube-1.8b, seeded params
     and B = 2 x S = 512 tokens.  (a) 3 steps of ``make_train_step(cfg,
     mesh, adamw)`` on ``make_test_mesh((1, 1), ("data", "model"))``, the
     state held as DTensors placed by ``state_shardings``, against 3
     mesh-less steps from the same state: losses, and the params after
     step 1 (normalized, leaf by leaf), within 1e-5; CUDA-event ms per step
     and peak GB of both.  (b) ``make_shard_map_train_step`` on a (1, 1, 1) ("pod",
     "data", "model") mesh with compress "none", "bf16" and "int8", 2 steps
     each: finite losses; "none" within 1e-6 of (a) (losses and params
     after step 1).  (c) ``pipeline_forward`` over the stacked dense layers
     on a ("pipe",) mesh of one with 2 microbatches against
     ``transformer.dense_stack`` on the same embedded tokens: the reduced
     config at float32 compute within 1e-5, the full width in bfloat16
     within 5e-2 (normalized); ms of both.  (d) ``python -m
     repro_torch.launch.train --reduced --data-mesh 1`` in a process: 4
     steps, a checkpoint every 2; LATEST rewound to step 2 and a second
     process resumes there; its step-4 checkpoint within 1e-5 (normalized)
     of the first's.  The process group is destroyed after (c)
 13. LM decode (kernel launch counts read before and after: the phase
     launches neither kernel), the full-width h2o-danube-1.8b from seeded
     params, bfloat16 compute and cache.  (a) B = 2 prompts of 4,160 tokens
     (past the 4,096 window: the ring wraps), ``prefill`` then 16
     ``decode_step``s: the prefill's last logits and each step's against
     ``forward(mode="train")`` of the 4,176-token sequence, normalized
     1e-2, or twice the forward's own bfloat16 noise (the prompt's forward
     against the whole sequence's at the prompt's last position) where that
     is larger; the prefill against the prompt's forward (1e-3 of that
     floor); ``pos`` exactly the last 4,096 positions after the prefill
     and after the steps; the same at float32 compute and caches (TF32
     off), at 1e-5 or twice the float32 forward's own noise.  (b) ``kv_cache_dtype="int8"`` on the same tokens: each step
     within 1e-1 normalized of (a)'s bfloat16-cache logits (ten times
     tests/test_torch_kv_quant.py's bound), the prefill's equal; cache
     bytes equal to the formula (2·L·KV·hd·2 and 2·L·KV·(hd + 4) bytes a
     token a sequence, pos's 4·L beside).  (c) ``ServingEngine(params,
     cfg, max_batch=8, max_seq=4352)``: 32 greedy requests, 28 prompts of
     16-1,024 tokens (seeded numpy) and 4 of 4,160, 32 new tokens each;
     every request finishes with 32 tokens; for 4 requests (2 long) each
     emitted token's logits against a batch-1 ``prefill`` +
     ``decode_step`` run fed the engine's tokens (teacher forcing), at
     (a)'s bound.  Prints tokens/s, the median CUDA-event ms of a decode
     step of 8 full slots beside the bound of its bytes (bfloat16 params
     and the cache read at 3.35 TB/s) and its idle share under
     ``torch.profiler``, ``cast_to_compute`` alone, prefill ms at 256,
     1,024 and 4,160 tokens, cache and peak GB.  (d) The reduced config at
     float32 compute and caches: the same CPU-made params, 6 prompts
     through a 2-slot engine on the CPU and on the card, tokens equal and
     every emitted token's logits within 1e-5 normalized.  (e)
     ``kv_sensitivity`` of phase 9's full-width diag spectrum (its wk / wv
     rows) and ``choose_kv_cache_dtype(int8_budget_frac=0.5)``: 12 int8
     layers of 24
 14. the MoE, SSM and hybrid families (kernel launch counts read before
     and after: the phase launches neither kernel), from seeded params,
     float32 params and bfloat16 compute, at full width:
     granite-moe-1b-a400m (1,384,963,072 params), zamba2-1.2b
     (1,170,313,344) and mamba2-2.7b (2,830,951,936, 64 layers).  (a)
     granite and (b) zamba2: the loss of B = 2 x S = 512 tokens (finite;
     granite's share of (token, expert) assignments dropped at capacity
     factor 1.25; zamba2's HVP fits at 2 x 512 with remat), hvp
     (median of 3), ggn and diag (4 probes, one call each) through
     ``engine.plan(tgt.loss, None, backend="pytree_fwdrev")`` with phase
     9's two AD routes within 1e-3, CUDA-event ms, peak GB, the hvp's idle
     share under ``torch.profiler``; 3 AdamW steps (phase 10's
     ``full_width_steps``); ``prefill`` of 2 prompts (granite 4,160
     tokens, zamba2 4,224 = 33 x 128: past the 4,096 window, and a
     multiple of the SSD chunk) then 16 ``decode_step``s against
     ``forward`` (zamba2's run to the next multiple of 128, read at the
     decoded positions), granite at capacity factor E / k (nothing drops),
     at phase 13's max(1e-2, twice the forward's own bf16 noise), then at
     float32 compute and state within max(1e-5, twice the float32
     forward's own noise), every family; the same with int8 KV caches at
     1e-1 of the bf16 caches' logits;
     ``ServingEngine`` with 8 slots: 16 greedy requests of 32 tokens (12
     prompts of 16-128 tokens, 4 of the long prompt), every request
     finishing, one long request teacher-forced through batch-1 decode at
     the (a) bound; tokens/s, the ms of an 8-slot decode step beside its
     byte bound (bf16 params read and the decode state at 3.35 TB/s) and
     its idle share, cache and peak GB.  (c) mamba2: no curvature or
     training; the decode check on 4,224-token prompts and the engine.
     (d) The reduced configs at float32 compute and state: CPU-made
     params, a 2-slot engine on the CPU and on the card, tokens equal,
     logits within 1e-5.  (e) In an NCCL world of one on a (1, 1) ("data",
     "model") mesh: ``moe_block_sharded`` against ``moe_block`` at a
     full-width granite layer (T = 1,024, float32, TF32 off), outputs and
     gradients within 1e-6; ``repro_torch.launch.train``'s ``main`` with
     ``--arch granite-moe-1b-a400m --reduced --data-mesh 1 --moe-impl
     shard_map_local --device cuda``, 4 finite steps
 15. the enc-dec and VLM families and remat (kernel launch counts read
     before and after: the phase launches neither kernel), from seeded
     params, float32 params and bfloat16 compute, at full width and depth:
     whisper-base (97,503,232 params; B = 2, its 1,500 frames and 448
     decoder tokens) and internvl2-1b (630,439,040; B = 2 x (256 patches
     + 256 tokens)): the loss, hvp (median of 3), ggn and diag (4 probes)
     through ``pytree_fwdrev`` with phase 9's two AD routes within 1e-3,
     ms, peak GB and the hvp's idle share; 3 AdamW steps on
     ``data.global_batch_at``'s batches; ``prefill`` of the frames /
     patches and a prompt (224 / 1,024 tokens) then 16 ``decode_step``s
     against ``forward`` at bf16 (max(1e-2, twice the noise)) and at
     float32 compute and state (max(1e-5, twice the noise)), prefill ms,
     peak and ``cross_kv`` GB; internvl2's 8-slot engine on 16 text-only
     requests as phase 14's.  Then phase 9's dense loss and HVP (B = 2 x
     512) with ``cfg.remat`` off and on: the loss bitwise equal, the HVP
     within 1e-4 (normalized), each HVP's peak GB
 16. the dry run (kernel launch counts read before and after: the phase
     launches neither kernel).  (a) ``python -m repro_torch.launch.dryrun
     --arch A,... --shape S,... --jobs 8`` with no card visible: one arch
     of each family (h2o-danube-1.8b, granite-moe-1b-a400m, mamba2-2.7b,
     zamba2-1.2b, whisper-base, internvl2-1b) over the four shapes on the
     fake 16x16 world, at full width and depth, records under
     ``chiprun_out/dryrun_torch/``; every cell ok (the full-attention
     long_500k cells skipped) with its probes' cross-check agreeing; then
     ``python -m repro_torch.launch.roofline --dir`` on them.  (b) The dry
     run's counting function, mesh-less, on phase 10's AdamW step and
     phase 13's bfloat16 prefill of 2 x 4,160 tokens: the predicted peak
     within 15% of the ``torch.cuda.max_memory_allocated`` those phases
     measured in this run, the roofline bound at most the measured ms
 17. a ``dryrun`` JSON line with phase 16's numbers, a ``zoo`` JSON line
     with phase 14's and (under ``encdec_vlm``) phase
     15's numbers, a ``curvature`` line
     with phase 9's, a ``training`` line with phase 10's, a
     ``distributed`` line with phase 11's, a ``mesh_training`` line with
     phase 12's and a ``decode`` line with phase 13's; one JSON
     line with both kernels' numbers (the tuner's under chess_hvp's
     ``tuning``, the served path's under ``serving``), the card's name and
     power limit, and a last line ``{"ok": true, "device": {...}}``

Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.  Imports nothing of JAX or of the ``repro`` package.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
M, N = 524288, 64                    # the paper's scale: 0.5M instances, n=64
SAMPLE = 256                         # rows checked against the plain version
FUNCTIONS = ("rosenbrock", "ackley", "fletcher_powell")
SCHEDULES = (True, False)            # symmetric (Alg. 8), full (Alg. 7)
CPU_SWEEP = [(16, 8, 2), (8, 16, 4), (8, 8, 8), (24, 12, 3), (8, 10, 4),
             (8, 9, 2), (5, 8, 2), (13, 7, 3), (4, 6, 16)]
WIDE_SWEEP = [(37, 100, 65), (37, 100, 96), (37, 100, 128), (9, 128, 128)]
# n on both sides of the largest n whose A^T and B^T Fletcher-Powell stages
# in shared memory: 168 at 4 lanes, 159 at 8, 55 at 64 (csize 40)
STAGING_SWEEP = [(3, 168, 4), (3, 169, 4), (3, 159, 8), (3, 160, 8),
                 (5, 55, 40), (5, 56, 40)]
RTOL = 5e-3                          # atol = RTOL * (1 + max|want|)
# chess_hvp's repairs at width: bfloat16 at the main path's scale, and
# chunks wider than 64 lanes (function, n, csize, symmetric) at M_WIDE
BF16_CASES = (("rosenbrock", True), ("fletcher_powell", True))
M_WIDE = 65536
WIDE_CASES = (("rosenbrock", 128, 128, False),
              ("fletcher_powell", 100, 96, True))
# hdual_linear's reference sweep (tests/test_kernels.py) and full-width
# cases (name, c, T, din, dout, dtype name)
LINEAR_SWEEP = [(6, 32, 16, 24, 32, 8, 16), (10, 128, 128, 128, 64, 128, 32),
                (4, 64, 32, 128, 16, 64, 32), (18, 8, 8, 8, 8, 8, 8)]
LINEAR_CASES = (("paper_c4", 4, M, N, N, "float32"),
                ("paper_c4", 4, M, N, N, "bfloat16"),
                ("paper_c8", 8, M, N, N, "float32"),
                ("wide_layer", 4, 4096, 2560, 2560, "float32"),
                ("wide_layer", 4, 4096, 2560, 2560, "bfloat16"))
LINEAR_TOL = {"float32": 1e-5, "bfloat16": 1e-1}   # atol = tol * din
# The full-width cases scale w by 1/sqrt(din), so their outputs are about
# N(0, 1) and the reference's din-scaled atol (set for |y| ~ sqrt(din)) would
# pass an all-zero output.  They are held at the output's own scale instead:
# kernel and plain version both sum exact-enough float32 products, in other
# orders (atol), and round the sum once to x.dtype (rtol: one bfloat16 ulp is
# at most 2**-7 of the value).
FULL_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
FULL_ATOL = 1e-5                     # atol = FULL_ATOL * (1 + max|want|)
PEAK_FP32 = 67e12                    # H100 SXM fp32 (non-tensor) FLOP/s
PEAK_TF32 = 495e12                   # H100 SXM tf32 dense tensor FLOP/s
PEAK_BYTES = 3.35e12                 # H100 SXM HBM3 bytes/s
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
# the served path (phase 8): requests per test function at N, Rosenbrock
# requests at mixed n, Hessians at SERVE_HESSIAN_N, client threads, requests
# each client keeps in flight, and the server's knobs
SERVE_DENSE = 2048
SERVE_MIXED = 1024
SERVE_MIXED_NS = (48, 56, 64)
SERVE_HESSIANS = 8
SERVE_HESSIAN_N = 16
SERVE_CLIENTS = 8
SERVE_WINDOW = 32
SERVE_MAX_BATCH = 256
SERVE_MAX_WAIT_US = 500.0
SERVE_REL64 = 1e-3                   # max|got - want| / max|want|, float64
SERVE_PROFILE_ROWS = 64
# the tuner's phase: bucket sizes each instance block is timed at
SWEEP_ROWS = (64, 256)


def smi_query(fields):
    """nvidia-smi's reading of the given fields for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def check_close(got, want, what):
    """Max abs error of got vs want; fails past the kernel tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not (err <= RTOL * (1.0 + scale)):
        fail(f"{what}: max abs err {err:.3e} > {RTOL} * (1 + {scale:.3e})")
    return err


def within(got, want, rtol, atol):
    """(every element within atol + rtol * |want|, max abs err)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return bool((diff <= atol + rtol * want.abs()).all()), diff.max().item()


def check_elementwise(got, want, rtol, atol, what):
    """Every element within atol + rtol * |want|; returns the max abs err.
    Works in slices of the leading axis to bound the temporaries."""
    err = 0.0
    for k in range(got.shape[0]):
        ok, diff = within(got[k], want[k], rtol, atol)
        if not ok:
            fail(f"{what}: component {k} off by up to {diff:.3e} "
                 f"(rtol {rtol}, atol {atol})")
        err = max(err, diff)
    return err


def tf32(t):
    """float32 t rounded to TF32's 10 mantissa bits, as a TF32 tensor-core
    product reads its inputs."""
    import torch
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def cuda_ms(fn, reps):
    """Mean CUDA-event time of reps calls, after one untimed call (the first
    call of a library kernel includes loading its module)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16",
         "6__half": "float16"}


def host_ms(fn, reps):
    """Mean host time of reps calls with no synchronize between them: the
    rate at which the host enqueues the work.  Where it nears cuda_ms's
    time of the same calls, the host, not the card, sets that time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def kernel_name(entry):
    """A readable name for a mangled kernel entry of csrc/*.cu."""
    c = re.search(r"INS_\d+([A-Za-z]+)ELi(\d+)ELb([01])E", entry)
    if c:
        staged = ", staged" if c.group(3) == "1" else ""
        return f"chess_hvp<{c.group(1)}, C={c.group(2)}{staged}>"
    h = re.search(r"hdual_linear\d+(simt|tc)\d+(kernel|prep_w_kernel)I"
                  r"(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?E", entry)
    if h:
        variant = {"simt": "simt", "tc": "wgmma"}[h.group(1)]
        what = "prep_w" if h.group(2) == "prep_w_kernel" else variant
        bn = f", BN={h.group(4)}" if h.group(4) else ""
        return f"hdual_linear {what}<{TYPES[h.group(3)]}{bn}>"
    return entry


def ptxas_lines(log):
    """'<kernel>: R registers, S/L bytes spill stores/loads' per
    instantiation, from nvcc -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(.*?)'", line)
        if m:
            name = kernel_name(m.group(1))
            spill = ("?", "?")
        elif name and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill[0]} B spill stores,"
                       f" {spill[1]} B spill loads")
            name = None
    return out


def hgmma_counts(lib):
    """{kernel name: HGMMA instructions in its SASS} for every kernel of a
    built library, from cuobjdump -sass."""
    sass = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def linear_bound(ops, nbytes, dtype_name):
    """(bound ms, what bounds it, FFMA bound ms): the least time of the
    card's routes to the same result.  bfloat16: bytes or tensor-core
    operations.  float32: bytes, or operations by the faster float32-exact
    route, FFMA at 67 TFLOP/s or three TF32 products at 495 TFLOP/s; the
    FFMA-only bound is returned beside it, for comparison with earlier
    runs."""
    from repro_torch.launch.hlo_analysis import PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES
    ffma = max(ops / PEAK_FP32, t_bytes) * 1e3
    if dtype_name == "float32":
        t_ops = min(ops / PEAK_FP32, 3 * ops / PEAK_TF32)
    else:
        t_ops = ops / PEAK_BF16
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_ops, t_bytes) * 1e3, by, ffma


def row_slices(m):
    """First, middle and last SAMPLE rows of an m-row batch."""
    return (0, m // 2 - SAMPLE // 2, m - SAMPLE)


def drive_clients(connect, address, jobs):
    """Run ``jobs`` -- (method, plan name, a, v or None) -- through
    SERVE_CLIENTS connections, one thread each, job i on client
    i % SERVE_CLIENTS with at most SERVE_WINDOW of its requests in flight,
    priority interactive for every third job (as the server's selftest
    mixes them).  Returns (results, round-trip seconds, wall seconds); a
    request the server failed fails the phase."""
    results, latency, errors = [None] * len(jobs), [None] * len(jobs), []

    def client(c):
        window = threading.Semaphore(SERVE_WINDOW)
        futs = []
        try:
            with connect(*address, client=f"smoke-{c}") as cli:
                for i in range(c, len(jobs), SERVE_CLIENTS):
                    method, name, a, v = jobs[i]
                    pr = "interactive" if i % 3 == 0 else "batch"
                    if not window.acquire(timeout=120):
                        raise TimeoutError("no response in 120 s")
                    t0 = time.perf_counter()
                    if method == "hvp":
                        fut = cli.submit_hvp(name, a, v, priority=pr)
                    else:
                        fut = cli.submit_hessian(name, a, priority=pr)

                    def done(f, i=i, t0=t0):
                        latency[i] = time.perf_counter() - t0
                        window.release()
                    fut.add_done_callback(done)
                    futs.append((i, fut))
                for i, fut in futs:
                    results[i] = fut.result(timeout=300)
        except Exception as e:          # reported by the main thread
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail("served requests failed: " + "; ".join(errors[:4]))
    return results, latency, wall


def dense_rounds(rng):
    """The dense round of phases 7 and 8: SERVE_DENSE HVPs of each
    function at N, the functions interleaved; returns (data by function,
    jobs)."""
    dense = {}
    for fname in FUNCTIONS:
        dense[fname] = (rng.uniform(-2, 2, (SERVE_DENSE, N)).astype("f4"),
                        rng.randn(SERVE_DENSE, N).astype("f4"))
    jobs = [("hvp", fname, dense[fname][0][i], dense[fname][1][i])
            for i in range(SERVE_DENSE) for fname in FUNCTIONS]
    return dense, jobs


def check_dense(results, dense, dev, what):
    """Every served dense row against chess_hvp's plain version at the
    kernel tolerance; returns the max abs error."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.core import testfns
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels.ops import kernel_form

    csize = engine.model_csize(N, False)
    err = 0.0
    for k, fname in enumerate(FUNCTIONS):
        got = torch.as_tensor(np.asarray(results[k::len(FUNCTIONS)], "f4"),
                              device=dev)
        A, V = (torch.as_tensor(x, device=dev) for x in dense[fname])
        kf, consts, _ = kernel_form(testfns.FUNCTIONS[fname](N))
        consts = tuple(c.to(dev) for c in consts)
        for r0 in range(0, SERVE_DENSE, SAMPLE):
            sl = slice(r0, r0 + SAMPLE)
            err = max(err, check_close(
                got[sl], ck.chess_hvp_plain(kf, A[sl], V[sl], csize, consts,
                                            False),
                f"{what} {fname} rows {r0}:{r0 + SAMPLE} vs plain"))
    return err


def queue_report(records, tag):
    """Batches, rows and us per point by queue and bucket, from
    ``engine.execution_stats()`` records; printed and returned."""
    queues = []
    for r in records:
        sig = r["signature"]
        fname = getattr(sig[0], "__name__", repr(sig[0]))
        for b, info in r["by_bucket"].items():
            queues.append({"f": fname, "n": sig[1], "workload": r["workload"],
                           "backend": r["backend"], "bucket": b,
                           "csize": sig[2], "blk_m": dict(sig[8]).get("blk_m"),
                           "batches": info["executions"],
                           "rows": info["points"],
                           "us_per_point": info["us_per_point_mean"]})
    queues.sort(key=lambda q: (q["workload"], q["f"], q["n"], q["bucket"],
                               q["backend"]))
    for q in queues:
        print(f"{tag}   {q['workload']} {q['f']} n={q['n']} {q['backend']} "
              f"csize {q['csize']} blk_m {q['blk_m']} "
              f"bucket {q['bucket']}: {q['batches']} batches, "
              f"{q['rows'] / q['batches']:.1f} rows per batch, "
              f"{q['us_per_point']:.3f} us per point (kernel + readback)",
              flush=True)
    return queues


def serve_phase(smi, dev, zero_counts):
    """Phase 8: the served path on the card, with the server built as
    ``repro_torch.launch.serve`` builds it.  Returns its numbers."""
    from repro_torch import engine
    from repro_torch.launch.serve import build_plans
    from repro_torch.serving.frontend import CurvatureFrontend

    plans = build_plans(FUNCTIONS, symmetric=False, device=dev)
    svc = engine.CurvatureService(max_batch=SERVE_MAX_BATCH,
                                  max_wait_us=SERVE_MAX_WAIT_US,
                                  coalesce_across_n=True)
    fe = CurvatureFrontend(plans, service=svc, host="127.0.0.1", port=0)
    fe.start()
    try:
        return _serve_phase(smi, dev, zero_counts, fe, svc, plans)
    finally:
        fe.stop()
        svc.shutdown(wait=True)


def _serve_phase(smi, dev, zero_counts, fe, svc, plans):
    import numpy as np
    import torch
    from repro_torch import engine, obs
    from repro_torch.core import ref, testfns
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.serving.frontend import connect

    tag = f"[{smi}]"
    rng = np.random.RandomState(5000)
    dense, dense_jobs = dense_rounds(rng)
    mixed_n = rng.choice(SERVE_MIXED_NS, SERVE_MIXED)
    mixed = [(rng.uniform(-2, 2, n).astype("f4"), rng.randn(n).astype("f4"))
             for n in mixed_n]
    hess = [(FUNCTIONS[i % len(FUNCTIONS)],
             rng.uniform(-2, 2, SERVE_HESSIAN_N).astype("f4"))
            for i in range(SERVE_HESSIANS)]
    rounds = {
        "dense": dense_jobs,
        "mixed_n": [("hvp", "rosenbrock", a, v) for a, v in mixed],
        "hessian": [("hessian", fname, a, None) for fname, a in hess]}

    # the phase's counts start here: launches, telemetry, metrics
    zero_counts()
    engine.clear_telemetry()
    obs.reset()
    served, report = {}, {}
    for name, jobs in rounds.items():
        results, latency, wall = drive_clients(connect, fe.address, jobs)
        served[name] = results
        lat_ms = np.asarray(latency) * 1e3
        report[name] = {"requests": len(jobs), "wall_s": wall,
                        "requests_per_s": len(jobs) / wall,
                        "p50_ms": float(np.percentile(lat_ms, 50)),
                        "p99_ms": float(np.percentile(lat_ms, 99))}
        print(f"{tag} served {name}: {len(jobs)} requests in {wall:.3f} s, "
              f"{len(jobs) / wall:.1f} requests/s, round trip p50 "
              f"{report[name]['p50_ms']:.3f} ms, p99 "
              f"{report[name]['p99_ms']:.3f} ms", flush=True)
    torch.cuda.synchronize()
    launches = ck.chess_hvp_cuda.launches
    stats = svc.stats()
    records = engine.execution_stats()
    executions = obs.metrics_registry().value(
        "repro_executions_total", backend="cuda", workload="batched_hvp")
    hvp_recs = [r for r in records if r["workload"] == "batched_hvp"]
    not_cuda = sorted({r["backend"] for r in hvp_recs} - {"cuda"})
    batches = sum(b["executions"] for r in hvp_recs
                  for b in r["by_bucket"].values())
    rows = sum(b["points"] for r in hvp_recs
               for b in r["by_bucket"].values())
    if not_cuda:
        fail(f"served batched_hvp buckets ran on {not_cuda}, not cuda")
    if not (launches == batches == executions and launches > 0):
        fail(f"served path: chess_hvp launched {launches} times, the "
             f"telemetry records {batches} batched_hvp batches and the "
             f"metrics {executions}")
    if hl.hdual_linear_cuda.launches:
        fail("served path launched hdual_linear")
    if stats["ragged_batches"] <= 0:
        fail(f"served path formed no ragged batch ({stats})")
    print(f"{tag} served path: {launches} chess_hvp launches = {batches} "
          f"batched_hvp batches in the telemetry (all backend cuda), "
          f"{rows / batches:.1f} rows per launch; {stats['batches']} "
          f"batches in all, {stats['ragged_batches']} ragged "
          f"({stats['ragged_points']} rows), {stats.get('cross_n_fills', 0)}"
          f" cross-n fills, {stats['padded_rows']} padded rows", flush=True)

    # every served result against its reference
    dense_err = check_dense(served["dense"], dense, dev, "served")
    rel64 = 0.0
    for n in SERVE_MIXED_NS:
        idx = [i for i, m in enumerate(mixed_n) if m == n]
        A64 = torch.as_tensor(np.stack([mixed[i][0] for i in idx]),
                              device=dev).double()
        V64 = torch.as_tensor(np.stack([mixed[i][1] for i in idx]),
                              device=dev).double()
        want = torch.func.vmap(lambda a, v: ref.hvp_fwdrev(
            testfns.rosenbrock, a, v))(A64, V64)
        got = torch.as_tensor(np.asarray([served["mixed_n"][i]
                                          for i in idx]), device=dev)
        rel = ((got.double() - want).abs().amax(1)
               / want.abs().amax(1)).max().item()
        if not rel <= SERVE_REL64:
            fail(f"served mixed-n rows at n={n}: relative error {rel:.3e}")
        rel64 = max(rel64, rel)
    for (fname, a), got in zip(hess, served["hessian"]):
        f = testfns.FUNCTIONS[fname](SERVE_HESSIAN_N)
        want = ref.hessian_fwdrev(f, torch.as_tensor(a, device=dev).double())
        got = torch.as_tensor(np.asarray(got), device=dev).double()
        if got.shape != want.shape:
            fail(f"served {fname} Hessian of shape {tuple(got.shape)}")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not rel <= SERVE_REL64:
            fail(f"served {fname} Hessian: relative error {rel:.3e}")
        rel64 = max(rel64, rel)
    print(f"{tag} served results: dense rows vs plain max abs err "
          f"{dense_err:.3e}; mixed-n rows and Hessians vs float64 max rel "
          f"err {rel64:.3e}", flush=True)

    # batches, rows and us per point by queue and bucket
    queues = queue_report(records, tag)

    # one dense bucket under the profiler: the trace names the kernel and
    # the dispatcher's range
    prof_dir = ROOT / "chiprun_out" / "serving_profile"
    plan = plans["rosenbrock"](N)
    A, V = dense["rosenbrock"]
    with obs.profile_session(str(prof_dir)) as where:
        if where is None:
            fail("the profiler did not start")
        futs = [svc.submit(plan, A[i], V[i])
                for i in range(SERVE_PROFILE_ROWS)]
        for f in futs:
            f.result(timeout=120)
        torch.cuda.synchronize()
    trace = max(prof_dir.glob("repro_torch_trace_*.json"),
                key=lambda p: p.stat().st_mtime)
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if "chess_hvp_kernel" in str(e.get("name"))
               and e.get("cat") == "kernel"]
    ranges = [e for e in events
              if str(e.get("name")).startswith("repro:batched_hvp:cuda:b")]
    if not kernels or not ranges:
        fail(f"the profiler trace {trace} names the kernel {len(kernels)} "
             f"times and the range {len(ranges)} times")
    profile = {"trace": str(trace.relative_to(ROOT)),
               "kernel_us": [e.get("dur") for e in kernels],
               "ranges": [(e["name"], e.get("cat"), e.get("dur"))
                          for e in ranges]}
    print(f"{tag} profiler trace {profile['trace']}: chess_hvp_kernel "
          f"{profile['kernel_us']} us inside ranges {profile['ranges']} us",
          flush=True)

    # the same points through one batched_hvp call per function
    direct = {}
    for fname in FUNCTIONS:
        p = plans[fname](N)
        A, V = (torch.as_tensor(x, device=dev) for x in dense[fname])
        ms = cuda_ms(lambda: p.batched_hvp(A, V), 3)
        ops, nbytes = ck.needed_work(fname, SERVE_DENSE, N, p.csize, False)
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        served_us = sum(q["us_per_point"] * q["rows"] for q in queues
                        if q["f"] == getattr(p.f, "__name__", "")
                        and q["n"] == N and q["workload"] == "batched_hvp")
        served_rows = sum(q["rows"] for q in queues
                          if q["f"] == getattr(p.f, "__name__", "")
                          and q["n"] == N
                          and q["workload"] == "batched_hvp")
        direct[fname] = {"batched_hvp_ms": ms,
                         "us_per_point": ms * 1e3 / SERVE_DENSE,
                         "served_us_per_point": served_us / served_rows,
                         "bound_ms": bound}
        print(f"{tag} {fname} n={N}: one batched_hvp of {SERVE_DENSE} points"
              f" {ms:.3f} ms ({ms * 1e3 / SERVE_DENSE:.4f} us per point, "
              f"needed bound {bound:.3f} ms); served "
              f"{served_us / served_rows:.4f} us per point", flush=True)
    return {"launches": launches, "batches": stats["batches"],
            "batched_hvp_batches": batches, "rows_per_launch": rows / batches,
            "ragged_batches": stats["ragged_batches"],
            "ragged_rows": stats["ragged_points"],
            "cross_n_fills": stats.get("cross_n_fills", 0),
            "padded_rows": stats["padded_rows"],
            "buckets": {str(b): c for b, c in stats["buckets"].items()},
            "max_abs_err_dense": dense_err, "max_rel_err_float64": rel64,
            "rounds": report, "queues": queues, "direct": direct,
            "profile": profile,
            "config": {"max_batch": SERVE_MAX_BATCH,
                       "max_wait_us": SERVE_MAX_WAIT_US,
                       "clients": SERVE_CLIENTS, "window": SERVE_WINDOW}}


WARM_SCRIPT = """\
import json, sys
import torch
from repro_torch import engine
from repro_torch.core import testfns
dev = torch.device("cuda", 0)
winners = {{}}
for fname in {functions!r}:
    f = testfns.FUNCTIONS[fname]({n})
    for symmetric in {schedules!r}:
        p = engine.plan(f, {n}, m={m}, csize="autotune", symmetric=symmetric,
                        device=dev)
        cfg = engine.lookup_tuned(p, "batched_hvp")
        winners[f"{{fname}}/{{symmetric}}"] = [
            cfg.backend, cfg.csize, cfg.blk_m, cfg.source,
            p.backend_for("batched_hvp")]
foreign = sorted(k for k in sys.modules
                 if k == "repro" or k.startswith(("repro.", "jax")))
print(json.dumps({{"probes": engine.probe_count(), "winners": winners,
                  "foreign": foreign}}))
"""


def tune_phase(smi, dev, zero_counts, points):
    """Phase 7: the tuner on the card.  (a) ``plan(f, N, m=M,
    csize="autotune")`` for each function and schedule: a cuda winner, no
    cuda candidate raising; (b) the tuned plans' batched_hvp at full
    width (counts zeroed before, read after): one launch a call, sample
    rows against the plain version, CUDA-event times beside the
    ``csize="auto"`` plan's in turns (auto, tuned, tuned, auto) against the
    needed bound; (c) a second process on the same store plans the same
    plans with zero probes to the same winners; (d) every instance block of
    ``chess_hvp`` at n = N, and the kernel's own pick, against the plain
    version, and its time on SWEEP_ROWS-row buckets; (e) the service's default re-tune on phase 8's
    dense round.  Returns the numbers."""
    import torch
    from repro_torch import engine
    from repro_torch.core import testfns
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.kernels.ops import kernel_form

    tag = f"[{smi}]"
    sched = {True: "symmetric", False: "full"}
    report = {"store": os.environ["REPRO_TORCH_AUTOTUNE_CACHE"],
              "offline": {}, "full_width": {}, "instance_blocks": {}}

    @functools.lru_cache(maxsize=None)
    def form(fname, n):
        kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[fname](n))
        return kf, tuple(c.to(dev) for c in consts), device_fn

    # (a) the offline sweeps, through plan()
    tuned = {}
    for fname in FUNCTIONS:
        f = testfns.FUNCTIONS[fname](N)
        for symmetric in SCHEDULES:
            key = f"{fname}/{sched[symmetric]}"
            probes = engine.probe_count()
            t0 = time.perf_counter()
            p = engine.plan(f, N, m=M, csize="autotune", symmetric=symmetric,
                            device=dev)
            wall = time.perf_counter() - t0
            cfg = engine.lookup_tuned(p, "batched_hvp")
            if cfg is None or cfg.source != "sweep":
                fail(f"{key}: no fresh sweep behind the autotuned plan "
                     f"({cfg})")
            bad = [x for x in cfg.failures if x[0] == "cuda"]
            if bad:
                fail(f"{key}: cuda candidates raised in the sweep: {bad[:3]}")
            if cfg.backend != "cuda":
                fail(f"{key}: the sweep's winner is {cfg.backend}, not cuda")
            if (p.backend_for("batched_hvp") != cfg.backend
                    or p.opt("blk_m") != cfg.blk_m or p.csize != cfg.csize):
                fail(f"{p.describe()} does not carry its winner {cfg}")
            best = {}
            for bk, _c, _bm, t in cfg.trials:
                best[bk] = min(best.get(bk, t), t)
            at_csize = {str(bm): t * 1e3 for bk, c, bm, t in cfg.trials
                        if bk == "cuda" and c == cfg.csize}
            report["offline"][key] = {
                "backend": cfg.backend, "csize": cfg.csize,
                "blk_m": cfg.blk_m, "probe_ms": cfg.time_s * 1e3,
                "candidates": len(cfg.trials) + len(cfg.failures),
                "failures": [list(x) for x in cfg.failures],
                "sweep_s": cfg.sweep_s, "plan_s": wall,
                "probes": engine.probe_count() - probes,
                "best_probe_ms_by_backend": {k: v * 1e3
                                             for k, v in best.items()},
                "cuda_probe_ms_at_winning_csize": at_csize}
            tuned[(fname, symmetric)] = p
            print(f"{tag} autotune {key}: winner {cfg.backend} csize "
                  f"{cfg.csize} blk_m {cfg.blk_m} ({cfg.time_s * 1e3:.4f} ms "
                  f"on the probe batch); {len(cfg.trials)} candidates "
                  f"measured, {len(cfg.failures)} raised {cfg.failures}, "
                  f"sweep {cfg.sweep_s:.1f} s (plan {wall:.1f} s), "
                  f"{report['offline'][key]['probes']} probes; best probe "
                  f"ms by backend "
                  f"{ {k: round(v * 1e3, 4) for k, v in best.items()} }; "
                  f"cuda at csize {cfg.csize} by blk_m "
                  f"{ {k: round(v, 4) for k, v in at_csize.items()} }",
                  flush=True)

    # (b) the tuned plans at full width: the slice's path
    data = {fname: points(1000 + k, M, N) for k, fname in enumerate(FUNCTIONS)}
    zero_counts()
    err = 0.0
    for (fname, symmetric), p in tuned.items():
        A, V = data[fname]
        before = ck.chess_hvp_cuda.launches
        out = p.batched_hvp(A, V)
        torch.cuda.synchronize()
        if ck.chess_hvp_cuda.launches != before + 1:
            fail(f"{p.describe()}: batched_hvp did not launch the kernel once")
        if out.shape != (M, N) or not bool(torch.isfinite(out).all()):
            fail(f"{p.describe()}: output not finite or of shape {(M, N)}")
        kf, consts, _ = form(fname, N)
        for r0 in row_slices(M):
            sl = slice(r0, r0 + SAMPLE)
            err = max(err, check_close(
                out[sl], ck.chess_hvp_plain(kf, A[sl], V[sl], p.csize, consts,
                                            symmetric),
                f"autotuned {p.describe()} rows {r0}:{r0 + SAMPLE}"))
        del out
    launches = ck.chess_hvp_cuda.launches
    if launches != len(tuned) or hl.hdual_linear_cuda.launches:
        fail(f"autotuned path launched chess_hvp {launches} times (expected "
             f"{len(tuned)}) and hdual_linear "
             f"{hl.hdual_linear_cuda.launches} times")
    report.update(launches=launches, max_abs_err=err)
    print(f"{tag} autotuned path: {launches} launches of chess_hvp over "
          f"{len(tuned)} batched_hvp calls, rows {row_slices(M)} (+{SAMPLE} "
          f"each) vs plain max abs err {err:.3e}", flush=True)

    ms_total = auto_total = bound_total = 0.0
    for (fname, symmetric), p in tuned.items():
        A, V = data[fname]
        f = testfns.FUNCTIONS[fname](N)
        auto = engine.plan(f, N, m=M, csize="auto", symmetric=symmetric,
                           device=dev)
        if auto.backend_for("batched_hvp") != "cuda":
            fail(f"{auto.describe()} resolved to "
                 f"{auto.backend_for('batched_hvp')}")
        reps = 2 if fname == "fletcher_powell" else 5
        ta = [cuda_ms(lambda: auto.batched_hvp(A, V), reps)]
        tt = [cuda_ms(lambda: p.batched_hvp(A, V), reps) for _ in range(2)]
        ta.append(cuda_ms(lambda: auto.batched_hvp(A, V), reps))
        ms, ms_auto = sum(tt) / 2, sum(ta) / 2
        ops, nbytes = ck.needed_work(fname, M, N, p.csize, symmetric)
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        ops_a, nbytes_a = ck.needed_work(fname, M, N, auto.csize, symmetric)
        bound_auto = max(ops_a / PEAK_FP32, nbytes_a / PEAK_BYTES) * 1e3
        if bound > ms:
            fail(f"autotuned {fname}: {ms:.3f} ms beats the needed bound "
                 f"{bound:.3f} ms")
        key = f"{fname}/{sched[symmetric]}"
        report["full_width"][key] = {
            "csize": p.csize, "blk_m": p.opt("blk_m"), "ms": ms,
            "ms_turns": tt, "auto_csize": auto.csize, "auto_ms": ms_auto,
            "auto_ms_turns": ta, "bound_ms": bound,
            "auto_bound_ms": bound_auto, "tuned_over_auto": ms / ms_auto}
        ms_total += ms
        auto_total += ms_auto
        bound_total += bound
        print(f"{tag} {key} at m={M}: autotuned (csize {p.csize}, blk_m "
              f"{p.opt('blk_m')}) {ms:.3f} ms {tt}, auto (csize "
              f"{auto.csize}, the wrapper's pick) {ms_auto:.3f} ms {ta}; "
              f"tuned / auto {ms / ms_auto:.3f}; needed bound {bound:.3f} ms "
              f"(auto's {bound_auto:.3f} ms)", flush=True)
    report.update(ms=ms_total, auto_ms=auto_total, bound_ms=bound_total)
    del data
    torch.cuda.empty_cache()

    # (c) a warm store answers a second process with zero probes
    t0 = time.perf_counter()
    warm = subprocess.run(
        [sys.executable, "-c", WARM_SCRIPT.format(
            functions=FUNCTIONS, schedules=SCHEDULES, n=N, m=M)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    if warm.returncode != 0:
        fail(f"warm-store process failed: {warm.stderr[-2000:]}")
    got = json.loads(warm.stdout.strip().splitlines()[-1])
    want = {f"{fname}/{symmetric}": ["cuda", p.csize, p.opt("blk_m"), "disk",
                                     "cuda"]
            for (fname, symmetric), p in tuned.items()}
    if got["probes"] != 0 or got["foreign"] or got["winners"] != want:
        fail(f"warm-store process: {got} (expected zero probes, winners "
             f"{want})")
    report["warm_store"] = dict(got, wall_s=time.perf_counter() - t0)
    print(f"{tag} warm store, a second process: {got['probes']} probes, the "
          f"same {len(want)} winners ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # (d) every instance block against the kernel's own pick
    for fname in FUNCTIONS:
        kf, consts, device_fn = form(fname, N)
        for symmetric in SCHEDULES:
            csize = engine.model_csize(N, symmetric)
            blocks = ck.instance_blocks(fname, N, csize)
            P = len(ck.sub_cells(N, csize, symmetric)[0])
            pick = ck._instances_per_block(P, N, fname, ck.lanes_for(csize))
            for m in SWEEP_ROWS:
                A, V = points(6000 + m, m, N)

                def run(ipb):
                    return ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                                             device_fn=device_fn,
                                             symmetric=symmetric, ipb=ipb)
                want = ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)
                times, host = {}, {}
                for ipb in [None] + blocks:
                    check_close(run(ipb), want, f"{fname} "
                                f"{sched[symmetric]} m={m} ipb={ipb} (None: "
                                f"the kernel's pick, {pick}) vs plain")
                    times[str(ipb)] = cuda_ms(lambda: run(ipb), 20)
                    host[str(ipb)] = host_ms(lambda: run(ipb), 20)
                best = min(times, key=times.get)
                key = f"{fname}/{sched[symmetric]}/m={m}"
                report["instance_blocks"][key] = {
                    "csize": csize, "default_ipb": pick, "ms": times,
                    "host_ms": host, "best": best,
                    "default_over_best": times["None"] / times[best]}
                ms4 = {k: round(v, 4) for k, v in times.items()}
                host4 = {k: round(v, 4) for k, v in host.items()}
                print(f"{tag} {key} csize {csize}: ms a call by ipb {ms4}, "
                      f"host enqueue ms {host4} (None = the wrapper's "
                      f"{pick}); every ipb matches the plain version",
                      flush=True)

    # (e) the service's default re-tune
    report["retune"] = retune_phase(smi, dev, zero_counts)
    return report


def retune_phase(smi, dev, zero_counts):
    """The server as phase 8 builds it, with no tuner=: one dense round,
    ``svc.retune()`` (autotune_buckets on the card; every swapped bucket on
    cuda), the same round again with every row checked, every batched_hvp
    bucket on cuda and the launches equal to the cuda batches."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.launch.serve import build_plans
    from repro_torch.serving.frontend import CurvatureFrontend, connect

    tag = f"[{smi}]"
    plans = build_plans(FUNCTIONS, symmetric=False, device=dev)
    svc = engine.CurvatureService(max_batch=SERVE_MAX_BATCH,
                                  max_wait_us=SERVE_MAX_WAIT_US,
                                  coalesce_across_n=True)
    fe = CurvatureFrontend(plans, service=svc, host="127.0.0.1", port=0)
    fe.start()
    try:
        dense, jobs = dense_rounds(np.random.RandomState(5000))
        engine.clear_telemetry()
        rounds = {}
        for when in ("before", "after"):
            if when == "after":
                t0 = time.perf_counter()
                summary = svc.retune()
                retune_s = time.perf_counter() - t0
                if summary["errors"] or summary["hot_swaps"] <= 0:
                    fail(f"the default re-tune: {summary}")
                learned = svc.tuning_report()
                swapped = {f"{q['f']}/n={q['n']}": q["buckets"]
                           for q in learned if q["buckets"]}
                off_card = {(k, b): w["backend"]
                            for k, bk in swapped.items()
                            for b, w in bk.items() if w["backend"] != "cuda"}
                if off_card:
                    fail(f"the default re-tune swapped buckets off the "
                         f"kernel: {off_card}")
                # the same pass refits each tuned queue's dispatcher knobs
                knobs = {f"{q['f']}/n={q['n']}": [q["max_batch"],
                                                  q["max_wait_us"]]
                         for q in learned if q["buckets"]}
                print(f"{tag} default re-tune: {summary} in {retune_s:.2f} s;"
                      f" winners {swapped}; dispatcher knobs (max_batch, "
                      f"max_wait_us) {knobs}", flush=True)
                zero_counts()
                engine.clear_telemetry()
            results, latency, wall = drive_clients(connect, fe.address, jobs)
            torch.cuda.synchronize()
            launches = ck.chess_hvp_cuda.launches
            records = engine.execution_stats()
            err = check_dense(results, dense, dev, f"re-tune round {when}")
            print(f"{tag} dense round {when} the re-tune: {len(jobs)} "
                  f"requests in {wall:.3f} s, {len(jobs) / wall:.1f} "
                  f"requests/s; rows vs plain max abs err {err:.3e}; us per "
                  f"point by queue and bucket:", flush=True)
            rounds[when] = {"wall_s": wall, "requests_per_s": len(jobs) / wall,
                            "p50_ms": float(np.percentile(latency, 50)) * 1e3,
                            "max_abs_err": err,
                            "queues": queue_report(records, tag)}
        not_cuda = sorted({r["backend"] for r in records
                           if r["workload"] == "batched_hvp"} - {"cuda"})
        if not_cuda:
            fail(f"re-tuned round: batched_hvp buckets ran on {not_cuda}, "
                 f"not cuda")
        cuda_batches = sum(b["executions"] for r in records
                           if r["workload"] == "batched_hvp"
                           and r["backend"] == "cuda"
                           for b in r["by_bucket"].values())
        if not (launches == cuda_batches > 0) or hl.hdual_linear_cuda.launches:
            fail(f"re-tuned round: chess_hvp launched {launches} times, the "
                 f"telemetry records {cuda_batches} cuda batches; "
                 f"hdual_linear {hl.hdual_linear_cuda.launches} times")
        print(f"{tag} re-tuned round: {launches} chess_hvp launches = "
              f"{cuda_batches} cuda batches in the telemetry", flush=True)
        return {"summary": summary, "retune_s": retune_s, "knobs": knobs,
                "winners": {k: {str(b): v for b, v in bk.items()}
                            for k, bk in swapped.items()},
                "launches_after": launches,
                "cuda_batches_after": cuda_batches, "rounds": rounds}
    finally:
        fe.stop()
        svc.shutdown(wait=True)

# the pytree curvature phase (phase 9): the full-width h2o-danube-1.8b loss
# at B = 2 sequences of S = 512 tokens, float32 params and bfloat16
# compute (the config's own), then the reduced config at float32 compute
# on the card against the CPU
CURV_ARCH = "h2o-danube-1.8b"
CURV_B, CURV_S = 2, 512
CURV_PROBES = 4                      # the plan's n_probes; diag at csize 1
CURV_SEED = 0                        # params and tokens
CURV_DIAG_SEED = 3                   # the diag's probe seed
CURV_REPS = 3                        # timed calls after one warm-up
# two AD routes to one number in bfloat16, in units of ||v|| ||Hv||: the
# bound tests/test_torch_curvature_contracts.py holds the reduced configs to
BF16_ROUTES = 1e-3
# forward-equivalent matmul passes each workload needs: an HVP (jvp of
# grad) 3 forward + 6 backward, quadform (jvp of jvp) 1 + 2 + 2 + 3, the
# GGN and Fisher products a shared primal, one tangent (2) and one
# transpose (2); diag CURV_PROBES HVPs
CURV_PASSES = {"hvp": 9, "quadform": 8, "ggn": 5, "fisher": 5,
               "diag": 9 * CURV_PROBES}
CURV_RED_S = 48                      # the reduced config's window is 32
CURV_RED_CSIZE = 2
CURV_REL = 1e-4                      # card vs CPU, normalized error
CURV_BLOCK_CSIZE = 16                # block_hessian of final_norm (64 rows)
CURV_SERVE_THREADS = 4               # 4 HVP and 2 diag submits each


def median_cuda_ms(fn, digest, reps=CURV_REPS):
    """(median CUDA-event ms of reps calls after one warm-up, ``digest`` of
    the warm-up's result, peak bytes allocated during the warm-up).  The
    warm-up's result is digested (reduced to numbers, or moved to the
    host) and dropped before the timed calls, so no call runs beside
    another's output."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kept = digest(out)
    del out
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[reps // 2], kept, peak


def device_busy_ms(fn, top=6):
    """(wall ms of one call, ms the card spent in kernels during it, the
    ``top`` kernels by device time as (name, ms, launches)) under
    torch.profiler tracing the card only: the operator events' bookkeeping
    would take minutes on a call of ~100,000 operators (a full-width
    HVP)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0.0:
        fail("torch.profiler saw no kernel time on the card")
    events.sort(key=lambda e: -e.self_device_time_total)
    return wall, busy, [(e.key[:60], e.self_device_time_total / 1e3,
                         e.count) for e in events[:top]]


def tree_dot(a, b):
    """sum over leaves of a . b, each leaf summed in float64."""
    import torch
    from torch.utils import _pytree as pt
    return sum(float(torch.sum(x * y, dtype=torch.float64))
               for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)))


def tree_finite(tree, what):
    import torch
    from torch.utils import _pytree as pt
    for leaf in pt.tree_leaves(tree):
        if not bool(torch.isfinite(leaf).all()):
            fail(f"{what}: non-finite values")


def tree_nerr(got, want):
    """||got - want|| / ||want|| over all leaves, in float64 on the host."""
    import numpy as np
    from torch.utils import _pytree as pt
    g = np.concatenate([np.asarray(x.double().cpu()).ravel()
                        for x in pt.tree_leaves(got)])
    w = np.concatenate([np.asarray(x.double().cpu()).ravel()
                        for x in pt.tree_leaves(want)])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def trees_equal(got, want):
    """Bitwise equality of two trees (host numpy or tensors)."""
    import numpy as np
    from torch.utils import _pytree as pt
    return all(np.array_equal(np.asarray(g), np.asarray(w))
               for g, w in zip(pt.tree_leaves(got), pt.tree_leaves(want)))


def curvature_bound_ms(cfg, B, S, passes):
    """The least time for a workload of ``passes`` forward-equivalent
    passes: 2 x (matmul params) x tokens per pass and the bfloat16
    probabilities-times-values products at the card's bfloat16 dense rate,
    the float32 score products (TF32 off) at its FFMA rate."""
    from repro_torch.launch.hlo_analysis import PEAK_BF16
    T = B * S
    mm_params = cfg.num_params() - cfg.vocab_size * cfg.d_model  # no gather
    attn = 2 * B * cfg.num_heads * S * S * cfg.head_dim_ * cfg.num_layers
    bf16_flops = passes * (2 * mm_params * T + attn)
    fp32_flops = passes * attn
    return (bf16_flops / PEAK_BF16 + fp32_flops / PEAK_FP32) * 1e3


def curvature_phase(smi, dev, launch_counts):
    """Phase 9: pytree curvature on the full-width h2o-danube-1.8b loss,
    then the reduced config on the card against the CPU (see the module
    docstring)."""
    import torch
    from torch.utils import _pytree as pt

    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.core import curvature as tc
    from repro_torch.engine.service import CurvatureService
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.models.targets import diag_spectrum, lm_curvature_targets

    before = launch_counts()
    report = {"config": CURV_ARCH, "batch": CURV_B, "seq": CURV_S,
              "n_probes": CURV_PROBES, "diag_csize": 1,
              "bf16_routes_bound": BF16_ROUTES}

    # (a) full width ----------------------------------------------------
    cfg = get_config(CURV_ARCH)
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(CURV_SEED)
    params = init_params(cfg, gen, device=dev)
    batch = make_batch(cfg, CURV_B, CURV_S, gen, device=dev)
    tgt = lm_curvature_targets(cfg, batch)
    plan = engine.plan(tgt.loss, None, csize=1, device=dev,
                       options={"n_probes": CURV_PROBES,
                                **tgt.plan_options()})
    backends = {w: plan.backend_for(w) for w in CURV_PASSES}
    if backends != {"hvp": "pytree_fwdrev", "diag": "pytree_fwdrev",
                    "ggn": "pytree_fwdrev", "fisher": "pytree_fwdrev",
                    "quadform": "pytree_fwd"}:
        fail(f"curvature plan resolves to {backends}")
    report.update(params=cfg.num_params(), tokens=CURV_B * CURV_S,
                  setup_s=time.time() - t0, backends=backends)
    print(f"[{smi}] curvature: {CURV_ARCH} at full width, "
          f"{cfg.num_params():,} params (float32, compute "
          f"{cfg.compute_dtype}), B={CURV_B} x S={CURV_S} = "
          f"{CURV_B * CURV_S} tokens; one plan, backends {backends}",
          flush=True)

    v = tc.rademacher_like(1, params)
    work = {}

    def record(name, ms, peak):
        bound = curvature_bound_ms(cfg, CURV_B, CURV_S, CURV_PASSES[name])
        work[name] = {"ms": ms, "peak_gb": peak / 1e9, "bound_ms": bound,
                      "bound_share": bound / ms,
                      "passes": CURV_PASSES[name]}
        print(f"[{smi}] curvature {name}: {ms:.1f} ms (median of "
              f"{CURV_REPS} after a warm-up), peak {peak / 1e9:.2f} GB, "
              f"bound {bound:.2f} ms ({CURV_PASSES[name]} passes), "
              f"{bound / ms:.1%} of it", flush=True)

    def hvp_numbers(hv):
        # w is drawn here, after the warm-up's peak was read
        tree_finite(hv, "hvp")
        w = tc.rademacher_like(2, params)
        return tree_dot(v, hv), tree_dot(hv, hv) ** 0.5, tree_dot(w, hv)

    ms, (vhv, hv_norm, whv), peak = median_cuda_ms(
        lambda: plan.hvp(params, v), hvp_numbers)
    record("hvp", ms, peak)
    wall, busy, top = device_busy_ms(lambda: plan.hvp(params, v))
    # the idle share of the unprofiled call: kernel time over its median
    work["hvp"].update(profiled_wall_ms=wall, device_busy_ms=busy,
                       device_idle_share=max(0.0, 1.0 - busy / ms),
                       top_ops=top)
    print(f"[{smi}] curvature hvp under torch.profiler: {wall:.1f} ms wall "
          f"(profiled), the card in kernels {busy:.1f} ms, idle "
          f"{max(0.0, 1.0 - busy / ms):.1%} of the {ms:.1f} ms call; by "
          f"device time: "
          + "; ".join(f"{k} {t:.1f} ms x{c}" for k, t, c in top),
          flush=True)
    scale = tree_dot(v, v) ** 0.5 * hv_norm
    hw = plan.hvp(params, tc.rademacher_like(2, params))
    tree_finite(hw, "hvp (w)")
    vhw = tree_dot(v, hw)
    del hw

    ms, quad, peak = median_cuda_ms(lambda: plan.quadform(params, v, v),
                                    float)
    record("quadform", ms, peak)
    routes = abs(quad - vhv) / scale
    sym = abs(whv - vhw) / scale
    print(f"[{smi}] curvature: v.Hv {vhv:.6e} (hvp) vs {quad:.6e} "
          f"(quadform), |diff| / (||v|| ||Hv||) = {routes:.3e}; w.Hv "
          f"{whv:.6e} vs v.Hw {vhw:.6e}, {sym:.3e} (bound {BF16_ROUTES})",
          flush=True)
    if not (routes <= BF16_ROUTES and sym <= BF16_ROUTES):
        fail(f"curvature: AD routes disagree ({routes:.3e}, {sym:.3e} > "
             f"{BF16_ROUTES})")

    def v_dot(name):
        def digest(out):
            tree_finite(out, name)
            return tree_dot(v, out)
        return digest

    psd = {}
    for name, call in (("ggn", plan.ggn), ("fisher", plan.fisher)):
        ms, psd[name], peak = median_cuda_ms(lambda: call(params, v),
                                             v_dot(name))
        record(name, ms, peak)
        if not psd[name] >= 0.0:
            fail(f"curvature: v.{name}(v) = {psd[name]:.6e} < 0")
    print(f"[{smi}] curvature: v.Gv {psd['ggn']:.6e}, v.Fv "
          f"{psd['fisher']:.6e} (both >= 0)", flush=True)
    del v

    def to_host(diag):
        tree_finite(diag, "diag")
        return pt.tree_map(lambda t: t.cpu(), diag)

    ms, diag, peak = median_cuda_ms(
        lambda: plan.diag(params, CURV_DIAG_SEED), to_host)
    record("diag", ms, peak)
    # the KV projections' rows of the diag spectrum, for phase 13's cache
    # policy (the per-layer wk / wv entries diag_spectrum reports)
    report["kv_spectrum"] = diag_spectrum({"layers": {"attn": {
        k: diag["layers"]["attn"][k] for k in ("wk", "wv")}}})

    # the served diag: budgets 4 and 2 through a service, one row a bucket
    # (two rows of the full-width tree do not fit beside the model's work)
    host = pt.tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with CurvatureService(max_batch=1, max_wait_us=0.0) as svc:
        futs = {p: svc.submit(plan, host, CURV_DIAG_SEED, workload="diag",
                              n_probes=p) for p in (CURV_PROBES, 2)}
        served = {p: f.result(timeout=600) for p, f in futs.items()}
        stats = svc.stats()
    served_s = time.time() - t0
    if not trees_equal(served[CURV_PROBES], diag):
        fail("curvature: the served budget-4 diag is not bitwise plan.diag")
    for p, tree in served.items():
        tree_finite(pt.tree_map(torch.from_numpy, tree), f"served diag {p}")
    if trees_equal(served[2], diag):
        fail("curvature: the budget-2 diag equals the budget-4 one")
    report["served_diag"] = {
        "budgets": [CURV_PROBES, 2], "s": served_s,
        "batches": stats["batches"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "budget4_bitwise_plan_diag": True}
    print(f"[{smi}] curvature: served diag, budgets {CURV_PROBES} and 2, "
          f"{stats['batches']} buckets in {served_s:.1f} s (host marshalling "
          f"of two {cfg.num_params() * 4 / 1e9:.2f} GB rows included), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; budget "
          f"{CURV_PROBES} bitwise plan.diag", flush=True)
    report["workloads"] = work
    report["vHv"] = {"hvp": vhv, "quadform": quad, "routes_err": routes,
                     "wHv": whv, "vHw": vhw, "symmetry_err": sym}
    report["psd"] = psd
    del host, diag, served, plan, tgt, batch
    torch.cuda.empty_cache()

    # (b) the card against the CPU, reduced config, float32 compute ------
    report["reduced"] = reduced_curvature(smi, dev)
    after = launch_counts()
    if after != before:
        fail(f"curvature: kernel launches changed {before} -> {after}")
    return report


def reduced_curvature(smi, dev):
    """The reduced h2o-danube-1.8b at float32 compute: the same params, v,
    w and probes through the five workloads and block_hessian on the CPU
    and on the card; then the pytree service on the card."""
    import dataclasses
    import threading

    import torch
    from torch.utils import _pytree as pt

    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.core import curvature as tc
    from repro_torch.engine.service import CurvatureService
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.models.targets import lm_curvature_targets

    cfg = dataclasses.replace(get_config(CURV_ARCH, reduced=True),
                              compute_dtype="float32")
    cpu = torch.device("cpu")
    params = init_params(cfg, CURV_SEED, device=cpu)
    batch = make_batch(cfg, CURV_B, CURV_RED_S, CURV_SEED, device=cpu)
    v, w = tc.rademacher_like(1, params), tc.rademacher_like(2, params)
    gen = torch.Generator().manual_seed(CURV_DIAG_SEED)
    probes = tc._stack([tc.rademacher_like(gen, params)
                        for _ in range(CURV_PROBES)])

    def on(device, tree):
        return pt.tree_map(lambda t: t.to(device), tree)

    def run(device):
        p, vv, ww, pr = (on(device, t) for t in (params, v, w, probes))
        tgt = lm_curvature_targets(cfg, on(device, batch))
        plan = engine.plan(tgt.loss, None, csize=CURV_RED_CSIZE,
                           device=device,
                           options={"n_probes": CURV_PROBES,
                                    **tgt.plan_options()})
        out = {"hvp": plan.hvp(p, vv), "quadform": plan.quadform(p, vv, ww),
               "ggn": plan.ggn(p, vv), "fisher": plan.fisher(p, vv),
               "diag": tc._diag_from_probes(tc._hvp_map(tgt.loss, p), pr,
                                            CURV_RED_CSIZE),
               "block_hessian": tc.block_hessian(
                   tgt.loss, p, "final_norm", csize=CURV_BLOCK_CSIZE)}
        return {k: on(cpu, o) for k, o in out.items()}, plan, p

    want, _, _ = run(cpu)
    got, plan, dparams = run(dev)
    errs = {k: tree_nerr(got[k], want[k]) for k in want}
    print(f"[{smi}] curvature, reduced {CURV_ARCH} (float32 compute, TF32 "
          f"off), card vs CPU normalized error: "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (bound {CURV_REL})", flush=True)
    bad = {k: e for k, e in errs.items() if not e <= CURV_REL}
    if bad:
        fail(f"curvature: card vs CPU past {CURV_REL}: {bad}")

    # the pytree service on the card: HVP and budgeted diag submits from
    # CURV_SERVE_THREADS threads, every row the direct call's
    points = [pt.tree_map(lambda t: t.numpy(), init_params(cfg, s,
                                                           device=cpu))
              for s in range(CURV_SERVE_THREADS)]
    jobs, results = [], {}
    for c in range(CURV_SERVE_THREADS):
        for i in range(4):
            jobs.append((c, ("hvp", c, i)))
        for i in range(2):
            k = 2 * c + i
            jobs.append((c, ("diag", c, k)))

    def client(c, svc):
        for cc, job in jobs:
            if cc != c:
                continue
            kind, pc, i = job
            if kind == "hvp":
                results[job] = svc.submit(plan, points[pc], points[i])
            else:
                results[job] = svc.submit(
                    plan, points[pc], i, workload="diag",
                    n_probes=1 + i % CURV_PROBES)

    with CurvatureService(max_batch=8, max_wait_us=20000.0) as svc:
        threads = [threading.Thread(target=client, args=(c, svc))
                   for c in range(CURV_SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rows = {job: fut.result(timeout=120) for job, fut in results.items()}
        stats = svc.stats()
    if not stats["batches"] < len(rows):
        fail(f"curvature service: {stats['batches']} batches for "
             f"{len(rows)} requests")
    tgt = lm_curvature_targets(cfg, on(dev, batch))
    for (kind, pc, i), row in rows.items():
        point = on(dev, pt.tree_map(torch.from_numpy, points[pc]))
        if kind == "hvp":
            direct = plan.hvp(point, on(dev, pt.tree_map(torch.from_numpy,
                                                         points[i])))
        else:
            direct = tc.hutchinson_diag_budgeted(
                tgt.loss, point, i, 1 + i % CURV_PROBES,
                n_probes=CURV_PROBES, csize=CURV_RED_CSIZE)
        if not trees_equal(row, on(cpu, direct)):
            fail(f"curvature service: {kind} row {pc}/{i} is not the "
                 f"direct call")
    n_hvp = sum(1 for j in rows if j[0] == "hvp")
    print(f"[{smi}] curvature service (reduced, card): {n_hvp} HVP and "
          f"{len(rows) - n_hvp} diag submits (budgets 1-{CURV_PROBES}) from "
          f"{CURV_SERVE_THREADS} threads in {stats['batches']} batches, "
          f"every row bitwise the direct call", flush=True)
    return {"card_vs_cpu_nerr": errs, "bound": CURV_REL,
            "service": {"requests": len(rows), "batches": stats["batches"],
                        "hvp": n_hvp, "diag": len(rows) - n_hvp}}


# the optim and training phase (phase 10): the full-width h2o-danube-1.8b
# train step with AdamW, then SophiaH, at B = 2 x S = 512 (float32 params,
# bfloat16 compute); the reduced config on the card against the CPU; the
# loop and the entry point; Newton-CG at the paper's n = 64
TRAIN_ARCH = CURV_ARCH
TRAIN_B, TRAIN_S = 2, 512
TRAIN_SEED = 0
TRAIN_STEPS = 3
TRAIN_LR = (3e-4, 1, 4)              # warmup_cosine(base, warmup, total)
# the SophiaH settings that fit one 80 GB card at full width (PERF.md §5):
# its HVPs on half the batch, one probe at a time
SOPHIA = {"hess_every": 2, "n_probes": 4, "csize": 1,
          "hess_batch_frac": 0.5}
TRAIN_REL = 1e-5                     # card vs CPU; resumed vs uninterrupted
TRAIN_RED_S = 48
LOOP_STEPS, LOOP_EVERY, LOOP_FAIL_AT = 6, 2, 3
NCG_N, NCG_CSIZE = 64, 4


def param_sample(params):
    """A strided sample of every leaf (at most 4,096 elements each): what
    tells a changed parameter tree from an unchanged one without a copy of
    it."""
    from torch.utils import _pytree as pt
    return [l.reshape(-1)[::max(1, l.numel() // 4096)][:4096].clone()
            for l in pt.tree_leaves(params)]


def full_width_steps(smi, dev, cfg, opt, label, batch_at=None):
    """TRAIN_STEPS train steps of ``opt`` on the full-width config from
    seeded params; per step CUDA-event ms, the peak since the first step,
    loss, grad norm and lr.  ``batch_at(k)``: step k's batch (TRAIN_B x
    TRAIN_S synthetic tokens by default).  Fatal: a non-finite number or
    state leaf, and params unchanged by a step whose lr is nonzero."""
    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.models.params import init_params
    from repro_torch.training import TrainState, make_train_step

    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    params = init_params(cfg, gen, device=dev)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64, device=dev),
                       TRAIN_SEED)
    del params
    step_fn = make_train_step(cfg, None, opt)
    ds = SyntheticTokens(cfg.vocab_size, TRAIN_B, TRAIN_S, TRAIN_SEED,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for k in range(TRAIN_STEPS):
        batch = (batch_at(k) if batch_at is not None
                 else {"tokens": ds.batch_at(k)})
        before = param_sample(state.params)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step_fn(state, batch)
        stop.record()
        torch.cuda.synchronize()
        row = {"step": k, "ms": start.elapsed_time(stop),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
               "lr": m["lr"].item()}
        after = param_sample(state.params)
        row["params_changed"] = any(not torch.equal(a, b)
                                    for a, b in zip(before, after))
        del before, after, batch, m
        rows.append(row)
        print(f"[{smi}] training {label} step {k}: {row['ms']:.1f} ms, peak "
              f"{row['peak_gb']:.2f} GB, loss {row['loss']:.6f}, grad norm "
              f"{row['grad_norm']:.6f}, lr {row['lr']:.3e}, params "
              f"{'changed' if row['params_changed'] else 'unchanged'}",
              flush=True)
        if not all(map(math.isfinite, (row["loss"], row["grad_norm"]))):
            fail(f"training {label} step {k}: non-finite loss or grad norm")
        if row["lr"] > 0 and not row["params_changed"]:
            fail(f"training {label} step {k}: lr {row['lr']} but the "
                 f"params did not change")
    tree_finite(state.params, f"training {label} params")
    tree_finite(state.opt_state, f"training {label} optimizer state")
    return state, rows


def reduced_train_nerr(dev):
    """Two AdamW steps of the reduced config at float32 compute from the
    same CPU-made params and tokens, on the CPU and on the card: (loss
    relative errors, params' normalized error)."""
    import dataclasses

    import torch
    from torch.utils import _pytree as pt

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.training import TrainState, make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True),
                              compute_dtype="float32")
    cpu = torch.device("cpu")
    params = init_params(cfg, TRAIN_SEED, device=cpu)

    def run(device):
        p = pt.tree_map(lambda t: t.to(device, copy=True), params)
        opt = adamw(warmup_cosine(1e-2, 1, 4))
        state = TrainState(p, opt.init(p),
                           torch.zeros((), dtype=torch.int64, device=device),
                           TRAIN_SEED)
        step = make_train_step(cfg, None, opt)
        ds = SyntheticTokens(cfg.vocab_size, TRAIN_B, TRAIN_RED_S,
                             TRAIN_SEED, device="cpu")
        losses = []
        for k in range(2):
            state, m = step(state, {"tokens": ds.batch_at(k).to(device)})
            losses.append(m["loss"].item())
        return losses, pt.tree_map(lambda t: t.cpu(), state.params)

    want_l, want_p = run(cpu)
    got_l, got_p = run(dev)
    loss_err = [abs(g - w) / abs(w) for g, w in zip(got_l, want_l)]
    return loss_err, tree_nerr(got_p, want_p)


def train_cli(args, ckpt_dir):
    """``python -m repro_torch.launch.train`` in a process of its own on
    the card: (seconds, stdout)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--reduced", "--optimizer", "sophia_h", "--device",
           "cuda", "--ckpt-every", str(LOOP_EVERY), "--ckpt-dir",
           str(ckpt_dir)] + args
    t0 = time.time()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        fail(f"training: {' '.join(cmd[1:])} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    return time.time() - t0, out.stdout


def loop_phase(smi, dev):
    """(c): the entry point in a process, a TrainLoop whose step raises
    once against an uninterrupted one, and a second process resuming the
    first's directory."""
    import tempfile

    import torch

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.params import init_params
    from repro_torch.optim import sophia_h, warmup_cosine
    from repro_torch.training import (TrainLoop, TrainLoopConfig,
                                      TrainState, make_train_step)

    report = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        cli_dir = Path(tmp) / "cli"
        s1, out1 = train_cli(["--steps", str(LOOP_STEPS)], cli_dir)
        if (f"finished at step {LOOP_STEPS}" not in out1
                or latest_step(str(cli_dir)) != LOOP_STEPS):
            fail(f"training: the entry point did not reach step "
                 f"{LOOP_STEPS}: {out1!r}")
        print(f"[{smi}] training entry point: {LOOP_STEPS} sophia_h steps "
              f"of the reduced config on the card in {s1:.1f} s (process "
              f"included): {out1.strip()}", flush=True)

        cfg = get_config(TRAIN_ARCH, reduced=True)
        ds = SyntheticTokens(cfg.vocab_size, TRAIN_B, 32, TRAIN_SEED,
                             device=dev)

        def run_loop(name, fail_at):
            opt = sophia_h(warmup_cosine(1e-3, 1, LOOP_STEPS), hess_every=2,
                           n_probes=2, csize=1)
            params = init_params(cfg, TRAIN_SEED, device=dev)
            state = TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int64,
                                           device=dev), TRAIN_SEED)
            step = make_train_step(cfg, None, opt)
            armed = {"on": fail_at is not None}

            def step_fn(s, b):
                if armed["on"] and int(s.step) == fail_at:
                    armed["on"] = False
                    raise RuntimeError("injected failure")
                return step(s, b)

            loop = TrainLoop(TrainLoopConfig(
                total_steps=LOOP_STEPS, ckpt_dir=str(Path(tmp) / name),
                ckpt_every=LOOP_EVERY), step_fn,
                lambda k: {"tokens": ds.batch_at(k)}, state)
            res = loop.run()
            if res["final_step"] != LOOP_STEPS or armed["on"]:
                fail(f"training loop {name}: {res['final_step']}")
            return loop, [r["step"] for r in res["metrics"]]

        clean, clean_steps = run_loop("clean", None)
        flaky, flaky_steps = run_loop("flaky", LOOP_FAIL_AT)
        nerr = tree_nerr(flaky.state.params, clean.state.params)
        print(f"[{smi}] training loop on the card: a step raising at step "
              f"{LOOP_FAIL_AT} was retried from the step-{LOOP_FAIL_AT - 1}"
              f" checkpoint (steps run {flaky_steps}); final params vs an "
              f"uninterrupted run: normalized error {nerr:.2e} (bound "
              f"{TRAIN_REL})", flush=True)
        if not nerr <= TRAIN_REL:
            fail(f"training loop: resumed params off by {nerr:.2e}")

        s2, out2 = train_cli(["--steps", str(LOOP_STEPS + 2)], cli_dir)
        logged = [json.loads(line)["step"] for line in
                  (cli_dir / "metrics.jsonl").read_text().splitlines()]
        if (f"finished at step {LOOP_STEPS + 2}" not in out2
                or logged != list(range(LOOP_STEPS + 2))):
            fail(f"training: the second process did not resume at step "
                 f"{LOOP_STEPS}: {out2!r}, logged steps {logged}")
        print(f"[{smi}] training entry point, second process: resumed at "
              f"step {LOOP_STEPS} from LATEST, ran to {LOOP_STEPS + 2} in "
              f"{s2:.1f} s: {out2.strip()}", flush=True)
        report.update(cli_s=s1, resume_cli_s=s2, loop_nerr=nerr,
                      flaky_steps=flaky_steps, clean_steps=clean_steps,
                      bound=TRAIN_REL)
    return report


def newton_cg_phase(smi, dev):
    """(d): Newton-CG on the three test functions at n = 64 with both
    engines; the HVP calls are counted by wrapping the engines' maps."""
    import torch

    from repro_torch import engine
    from repro_torch.core import testfns
    from repro_torch.engine.plan import CurvaturePlan
    from repro_torch.optim import newton_cg as ncg

    n = NCG_N
    fp = testfns.make_fletcher_powell(n, device=dev)
    g0_fp = float(torch.linalg.norm(torch.func.grad(fp)(
        testfns.sample_point(n, seed=3, device=dev) * 0.1)))
    # x0 and the criteria of tests/test_newton_cg.py; Fletcher-Powell stops
    # at 1e-5 of its start gradient (its +-100 coefficients put that at
    # ~5e6), inside the test's 1e-4
    cases = {
        "rosenbrock": (testfns.rosenbrock,
                       torch.zeros(n, device=dev) - 0.5,
                       {"max_outer": 150, "cg_iters": 64}),
        "ackley": (testfns.ackley, testfns.sample_point(n, seed=1,
                                                        device=dev),
                   {"max_outer": 20}),
        "fletcher_powell": (fp, testfns.sample_point(n, seed=3,
                                                     device=dev) * 0.1,
                            {"max_outer": 100, "grad_tol": 1e-5 * g0_fp}),
    }
    calls = {"n": 0}
    plan_hvp, linear_map = CurvaturePlan.hvp, ncg._linear_map

    def counted_hvp(self, *a, **kw):
        calls["n"] += 1
        return plan_hvp(self, *a, **kw)

    def counted_map(f, x):
        hvp = linear_map(f, x)

        def call(v):
            calls["n"] += 1
            return hvp(v)
        return call

    CurvaturePlan.hvp, ncg._linear_map = counted_hvp, counted_map
    report = {}
    try:
        for name, (f, x0, kw) in cases.items():
            backend = engine.plan(f, n, csize=NCG_CSIZE, symmetric=True,
                                  device=dev).backend_for("hvp")
            runs = {}
            for eng in ("chessfad", "fwdrev"):
                calls["n"] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, info = ncg.newton_cg(f, x0, engine=eng, csize=NCG_CSIZE,
                                        device=dev, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                tr = info["trajectory"]
                runs[eng] = {
                    "ms": ms, "iterations": info["iterations"],
                    "hvp_calls": calls["n"],
                    "hvp_calls_upper_bound": info["hvp_calls_upper_bound"],
                    "f": tr[-1]["f"], "gnorm0": tr[0]["gnorm"],
                    "gnorm": tr[-1]["gnorm"],
                    "x_err": float((x - 1).abs().max()),
                    "monotone": all(b["f"] <= a["f"] + 1e-9
                                    for a, b in zip(tr, tr[1:]))}
                r = runs[eng]
                print(f"[{smi}] newton-cg {name} n={n} engine={eng} "
                      f"(auto -> {backend}): {r['iterations']} outer "
                      f"iterations, {r['hvp_calls']} HVP calls (upper bound "
                      f"{r['hvp_calls_upper_bound']}), {ms:.1f} ms, f "
                      f"{r['f']:.6e}, gnorm {r['gnorm0']:.3e} -> "
                      f"{r['gnorm']:.3e}", flush=True)
                if name == "rosenbrock" and not (r["f"] < 1e-6
                                                 and r["x_err"] < 1e-3):
                    fail(f"newton-cg {name} {eng}: f {r['f']}, "
                         f"max|x - 1| {r['x_err']}")
                if name == "ackley" and not r["monotone"]:
                    fail(f"newton-cg {name} {eng}: f rose")
                if name == "fletcher_powell" and not (
                        r["gnorm"] < 1e-4 * r["gnorm0"]):
                    fail(f"newton-cg {name} {eng}: gnorm {r['gnorm']} "
                         f"past 1e-4 of {r['gnorm0']}")
            fa, fb = runs["chessfad"]["f"], runs["fwdrev"]["f"]
            if not abs(fa - fb) <= 1e-3 + 1e-2 * abs(fb):
                fail(f"newton-cg {name}: engines end at f {fa} and {fb}")
            report[name] = {"backend": backend, **runs}
    finally:
        CurvaturePlan.hvp, ncg._linear_map = plan_hvp, linear_map
    return report


def training_phase(smi, dev, launch_counts):
    """Phase 10: optim and training (see the module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import adamw, sophia_h, warmup_cosine

    before = launch_counts()
    cfg = get_config(TRAIN_ARCH)
    report = {"config": TRAIN_ARCH, "params": cfg.num_params(),
              "batch": TRAIN_B, "seq": TRAIN_S, "lr": list(TRAIN_LR),
              "sophia_h": SOPHIA}
    print(f"[{smi}] training: {TRAIN_ARCH} at full width, "
          f"{cfg.num_params():,} float32 params (compute "
          f"{cfg.compute_dtype}), B={TRAIN_B} x S={TRAIN_S} synthetic "
          f"tokens, {TRAIN_STEPS} steps of adamw, then of sophia_h "
          f"{SOPHIA}", flush=True)

    # (a) full width ----------------------------------------------------
    torch.cuda.empty_cache()
    state, report["adamw"] = full_width_steps(
        smi, dev, cfg, adamw(warmup_cosine(*TRAIN_LR)), "adamw")
    del state
    torch.cuda.empty_cache()
    state, report["sophia_h"] = full_width_steps(
        smi, dev, cfg, sophia_h(warmup_cosine(*TRAIN_LR), **SOPHIA),
        "sophia_h")
    from torch.utils import _pytree as pt
    if not all(bool((h >= 0).all())
               for h in pt.tree_leaves(state.opt_state["h"])):
        fail("training sophia_h: a curvature estimate below 0")
    del state
    torch.cuda.empty_cache()

    # (b) the card against the CPU, reduced config, float32 compute ------
    loss_err, nerr = reduced_train_nerr(dev)
    print(f"[{smi}] training, reduced {TRAIN_ARCH} (float32 compute, TF32 "
          f"off), 2 adamw steps, card vs CPU: loss relative errors "
          + ", ".join(f"{e:.2e}" for e in loss_err)
          + f", params normalized error {nerr:.2e} (bound {TRAIN_REL})",
          flush=True)
    if not (max(loss_err) <= TRAIN_REL and nerr <= TRAIN_REL):
        fail(f"training: card vs CPU past {TRAIN_REL}: {loss_err}, {nerr}")
    report["reduced"] = {"loss_rel_err": loss_err, "params_nerr": nerr,
                         "bound": TRAIN_REL}

    # (c) the loop and the entry point ------------------------------------
    report["loop"] = loop_phase(smi, dev)

    # (d) Newton-CG at the paper's n --------------------------------------
    report["newton_cg"] = newton_cg_phase(smi, dev)
    after = launch_counts()
    if after != before:
        fail(f"training: kernel launches changed {before} -> {after}")
    report["kernel_launches_unchanged"] = True
    return report


# the distributed phase (phase 11): CHESSFAD's device-parallel schedules
# through plan(..., mesh=mesh) on an NCCL DeviceMesh of the one card (NCCL
# refuses two ranks on one GPU, so the card runs a world of one; the gloo
# CPU tests hold the cross-rank behaviour)
DIST_M = 2048        # the paper's 524,288 instances dealt over a 256-device
                     # pod: one device's share
ROWS_N, ROWS_CSIZE = 512, 8          # 5x the reference's largest bench n
DIST_REL = 1e-5                      # max|got - want| <= DIST_REL (1 + max|want|)
DIST_ORACLE = 64                     # instances held against float64
DIST_REPS = 3
LAYOUTS = ("cyclic", "block")
PSUM_NUMEL = 1 << 22                 # collectives: 4M float32 (16 MB)


def dist_check(got, want, what):
    """max|got - want| / (1 + max|want|), in float64; fails past
    DIST_REL."""
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item() / (1.0 + want.abs().max().item())
    if not err <= DIST_REL:
        fail(f"{what}: normalized error {err:.3e} > {DIST_REL}")
    return err


def lock_scope_check(smi, dev, points):
    """C.3's lock serializes torch.func transforms only: while another
    thread holds FUNC_LOCK, a cuda plan's batched_hvp (the service's kernel
    bucket path) runs to its end on the card."""
    import torch

    from repro_torch import engine
    from repro_torch.core import testfns
    from repro_torch.core.funclock import FUNC_LOCK

    p = engine.plan(testfns.rosenbrock, N, m=DIST_M, csize="auto")
    if p.backend_for("batched_hvp") != "cuda":
        fail(f"lock check: {p.describe()} is not on cuda")
    A, V = points(11, DIST_M, N)
    held, release = threading.Event(), threading.Event()
    out = {}

    def hold():
        with FUNC_LOCK:
            held.set()
            release.wait(300)

    def run():
        out["R"] = p.batched_hvp(A, V)
        torch.cuda.synchronize()

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    if not held.wait(60):
        fail("lock check: the holder never took FUNC_LOCK")
    runner = threading.Thread(target=run, daemon=True)
    runner.start()
    runner.join(120)
    waited = runner.is_alive()
    release.set()
    holder.join(60)
    runner.join(60)
    if waited or "R" not in out:
        fail("lock check: a cuda batched_hvp waited on FUNC_LOCK")
    print(f"[{smi}] distributed (a): a cuda batched_hvp (m={DIST_M}) ran to "
          f"its end while another thread held FUNC_LOCK", flush=True)


def distributed_phase(smi, dev, launch_counts):
    """Phase 11: the sharded and sharded_rows backends on an NCCL DeviceMesh
    (see the module docstring)."""
    import torch
    import torch.distributed as dist

    from repro_torch import engine
    from repro_torch.core import ref, testfns
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import compressed_psum, hierarchical_grad_sync

    gen = torch.Generator(device=dev)

    def points(seed, m, n):
        gen.manual_seed(seed)
        A = torch.rand(m, n, generator=gen, device=dev) * 4 - 2
        V = torch.randn(m, n, generator=gen, device=dev)
        return A, V

    # (a) set up -----------------------------------------------------------
    lock_scope_check(smi, dev, points)
    before = launch_counts()
    mesh = make_test_mesh((1, 1), ("data", "model"))
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        fail(f"distributed: a {dist.get_backend()} world on "
             f"{mesh.device_type}, not NCCL on the card")
    report = {"mesh": {"shape": list(mesh.shape),
                       "axes": list(mesh.mesh_dim_names),
                       "backend": dist.get_backend(),
                       "world": dist.get_world_size()},
              "bound": DIST_REL, "sharded": {}, "sharded_rows": {}}
    print(f"[{smi}] distributed: {report['mesh']}", flush=True)
    try:
        # (b) sharded: instances over the data axis ------------------------
        for k, fname in enumerate(FUNCTIONS):
            f = testfns.FUNCTIONS[fname](N)
            A, V = points(2000 + k, DIST_M, N)
            exact = torch.stack([ref.hvp_fwdrev(f, A[i].double(),
                                                V[i].double())
                                 for i in range(DIST_ORACLE)])
            for sym in SCHEDULES:
                p = engine.plan(f, N, m=DIST_M, csize="auto", mesh=mesh,
                                symmetric=sym)
                q = engine.plan(f, N, m=DIST_M, csize="auto", symmetric=sym,
                                backend="vmap_l2")
                if p.backend_for("batched_hvp") != "sharded":
                    fail(f"{p.describe()} resolved batched_hvp to "
                         f"{p.backend_for('batched_hvp')}")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                got = p.batched_hvp(A, V)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 1e9
                want = q.batched_hvp(A, V)
                what = f"sharded {fname} symmetric={sym}"
                case = {
                    "csize": p.csize, "m": DIST_M, "n": N,
                    "nerr_vs_meshless": dist_check(got, want, what),
                    "nerr_vs_float64": dist_check(
                        got[:DIST_ORACLE], exact, f"{what} vs float64"),
                    "ms": cuda_ms(lambda: p.batched_hvp(A, V), DIST_REPS),
                    "meshless_ms": cuda_ms(lambda: q.batched_hvp(A, V),
                                           DIST_REPS),
                    "peak_gb": peak}
                report["sharded"][f"{fname}_{'sym' if sym else 'full'}"] = \
                    case
                print(f"[{smi}] distributed (b) {what} csize={p.csize} "
                      f"m={DIST_M}: {case['ms']:.3f} ms (mesh-less vmap_l2 "
                      f"{case['meshless_ms']:.3f} ms), peak {peak:.2f} GB, "
                      f"normalized err vs mesh-less "
                      f"{case['nerr_vs_meshless']:.2e}, vs float64 "
                      f"{case['nerr_vs_float64']:.2e}", flush=True)
                del got, want
        # (c) sharded_rows: rows of one HVP / Hessian over the model axis --
        for k, fname in enumerate(FUNCTIONS):
            f = testfns.FUNCTIONS[fname](ROWS_N)
            a, v = (x[0] for x in points(3000 + k, 1, ROWS_N))
            exact_hvp = ref.hvp_fwdrev(f, a.double(), v.double())
            exact_hess = ref.hessian_fwdrev(f, a.double())
            for sym in SCHEDULES:
                q = engine.plan(f, ROWS_N, csize=ROWS_CSIZE, symmetric=sym,
                                backend="vmap_l2")
                flat_hvp, flat_hess = q.hvp(a, v), q.hessian(a)
                tag = f"{fname}_{'sym' if sym else 'full'}"
                meshless = {
                    "hvp_ms": cuda_ms(lambda: q.hvp(a, v), DIST_REPS),
                    "hessian_ms": cuda_ms(lambda: q.hessian(a), DIST_REPS)}
                for lay in LAYOUTS:
                    p = engine.plan(f, ROWS_N, csize=ROWS_CSIZE, mesh=mesh,
                                    symmetric=sym, row_layout=lay)
                    for wl in ("hvp", "hessian"):
                        if p.backend_for(wl) != "sharded_rows":
                            fail(f"{p.describe()} resolved {wl} to "
                                 f"{p.backend_for(wl)}")
                    what = f"sharded_rows {tag} {lay}"
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    got_hvp, got_hess = p.hvp(a, v), p.hessian(a)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() / 1e9
                    case = {
                        "csize": ROWS_CSIZE, "n": ROWS_N,
                        "hvp_nerr_vs_float64": dist_check(
                            got_hvp, exact_hvp, f"{what} hvp vs float64"),
                        "hvp_nerr_vs_meshless": dist_check(
                            got_hvp, flat_hvp, f"{what} hvp"),
                        "hessian_nerr_vs_float64": dist_check(
                            got_hess, exact_hess, f"{what} hessian vs "
                            "float64"),
                        "hessian_nerr_vs_meshless": dist_check(
                            got_hess, flat_hess, f"{what} hessian"),
                        "hvp_ms": cuda_ms(lambda: p.hvp(a, v), DIST_REPS),
                        "hessian_ms": cuda_ms(lambda: p.hessian(a),
                                              DIST_REPS),
                        "meshless_hvp_ms": meshless["hvp_ms"],
                        "meshless_hessian_ms": meshless["hessian_ms"],
                        "peak_gb": peak}
                    report["sharded_rows"][f"{tag}_{lay}"] = case
                    print(f"[{smi}] distributed (c) {what} n={ROWS_N}: hvp "
                          f"{case['hvp_ms']:.3f} ms (mesh-less "
                          f"{meshless['hvp_ms']:.3f}), hessian "
                          f"{case['hessian_ms']:.3f} ms (mesh-less "
                          f"{meshless['hessian_ms']:.3f}), peak {peak:.2f} "
                          f"GB, normalized err vs float64 "
                          f"{case['hvp_nerr_vs_float64']:.2e} / "
                          f"{case['hessian_nerr_vs_float64']:.2e}",
                          flush=True)
                    del got_hvp, got_hess
        # (d) the collectives on the card ----------------------------------
        gen.manual_seed(4000)
        x = torch.randn(PSUM_NUMEL, generator=gen, device=dev)
        mesh_pod = make_test_mesh((1, 1), ("pod", "data"))
        psum = {}
        for method in ("none", "bf16", "int8"):
            rounding = torch.Generator(device=dev).manual_seed(0)
            out = compressed_psum(x, mesh, "data", rounding, method)
            synced = hierarchical_grad_sync(
                {"g": x}, mesh_pod, data_axis="data", pod_axis="pod",
                generator=torch.Generator(device=dev).manual_seed(0),
                method=method)["g"]
            # a world of one sums one term: the method's own rounding only
            # (bf16: half an ulp of 2**-8; int8: one quantum of max|x|/127)
            tol = {"none": 0.0, "bf16": 2.0 ** -8 * x.abs().max().item(),
                   "int8": x.abs().max().item() / 127.0}[method]
            errs = [(y - x).abs().max().item() for y in (out, synced)]
            if not max(errs) <= tol:
                fail(f"compressed_psum {method}: off by {max(errs):.3e} "
                     f"(bound {tol:.3e})")
            psum[method] = {
                "max_abs_err": errs[0], "sync_max_abs_err": errs[1],
                "ms": cuda_ms(lambda: compressed_psum(
                    x, mesh, "data", rounding, method), DIST_REPS)}
        report["collectives"] = {"numel": PSUM_NUMEL, "methods": psum}
        print(f"[{smi}] distributed (d) compressed_psum and "
              f"hierarchical_grad_sync on {PSUM_NUMEL:,} float32: "
              + ", ".join(f"{k} {v['ms']:.3f} ms err {v['max_abs_err']:.2e}"
                          for k, v in psum.items()), flush=True)
    finally:
        dist.destroy_process_group()
    after = launch_counts()
    if after != before:
        fail(f"distributed: kernel launches changed {before} -> {after}")
    report["kernel_launches_unchanged"] = True
    return report


# the trainer across devices (phase 12): make_train_step on a mesh, the
# shard-map step and the GPipe pipeline in an NCCL world of one on the card
# (one H100 gives NCCL one rank), at phase 10's full width and batch
MESH_STEPS = 3
MESH_REL = 1e-5          # the mesh step vs phase 10's mesh-less step
SMAP_REL = 1e-6          # compress "none" vs the mesh step
PIPE_MICRO = 2
PIPE_FULL_REL = 5e-2     # bfloat16 compute over 24 layers, B=2 vs 2 x B=1
CLI_STEPS, CLI_EVERY, CLI_REWIND = 4, 2, 2


def host_copy(tree):
    """A host copy of a tree of (D)Tensors, leaf by leaf."""
    from torch.utils import _pytree as pt
    return [(x.full_tensor() if hasattr(x, "full_tensor") else x)
            .detach().to("cpu", copy=True) for x in pt.tree_leaves(tree)]


def leafwise_nerr(got, want_host):
    """||got - want|| / ||want|| over the leaves of a (D)Tensor tree on the
    card against a host copy, one leaf at a time in float64 on the card
    (a full-width tree does not fit the host twice in float64)."""
    import torch
    from torch.utils import _pytree as pt
    num = den = 0.0
    for g, w in zip(pt.tree_leaves(got), want_host):
        g = g.full_tensor() if hasattr(g, "full_tensor") else g
        g = g.to("cuda")
        w = w.to(g.device).double()
        num += float(torch.sum((g.double() - w) ** 2))
        den += float(torch.sum(w ** 2))
        del w
    return math.sqrt(num / den)


def mesh_step_run(smi, dev, cfg, mesh, make_step, steps, label,
                  sharded=True, keep_after=1):
    """``steps`` steps of ``make_step(opt)`` from phase 10's seeded params
    and tokens; per step CUDA-event ms, the peak since the first step and
    the loss; a host copy of the params after step ``keep_after``."""
    import torch
    from torch.utils import _pytree as pt

    from repro_torch.data import SyntheticTokens
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.training import TrainState, state_shardings

    opt = adamw(warmup_cosine(*TRAIN_LR))
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    params = init_params(cfg, gen, device=dev)
    if sharded:
        sh = state_shardings(cfg, mesh, opt, params)
        params = pt.tree_map(lambda s, p: s.shard(p), sh.params, params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64, device=dev),
                       TRAIN_SEED)
    del params
    step_fn = make_step(opt)
    ds = SyntheticTokens(cfg.vocab_size, TRAIN_B, TRAIN_S, TRAIN_SEED,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, kept = [], None
    for k in range(steps):
        batch = {"tokens": ds.batch_at(k)}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step_fn(state, batch)
        stop.record()
        torch.cuda.synchronize()
        rows.append({"step": k, "ms": start.elapsed_time(stop),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "loss": m["loss"].item()})
        print(f"[{smi}] mesh training {label} step {k}: "
              f"{rows[-1]['ms']:.1f} ms, peak {rows[-1]['peak_gb']:.2f} GB,"
              f" loss {rows[-1]['loss']:.6f}", flush=True)
        if not math.isfinite(rows[-1]["loss"]):
            fail(f"mesh training {label} step {k}: non-finite loss")
        if k == keep_after:
            kept = host_copy(state.params)
        del batch, m
    return state, rows, kept


def pipeline_check(smi, dev, cfg, mesh):
    """pipeline_forward over the stacked dense layers (pipe = 1, 2
    microbatches) against transformer.dense_stack on the same embedded
    tokens: (normalized error, pipeline ms, dense_stack ms)."""
    import torch
    from torch.utils import _pytree as pt

    from repro_torch.data import SyntheticTokens
    from repro_torch.models import transformer
    from repro_torch.models.common import cast_to_compute
    from repro_torch.models.params import init_params
    from repro_torch.training.pipeline import pipeline_forward, stack_stages

    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    params = cast_to_compute(init_params(cfg, gen, device=dev), cfg)
    S = TRAIN_S if cfg.d_model > 256 else TRAIN_RED_S
    tokens = SyntheticTokens(cfg.vocab_size, TRAIN_B, S, TRAIN_SEED,
                             device=dev).batch_at(0)
    x = torch.nn.functional.embedding(tokens, params["embed"])
    layers = params["layers"]
    del params
    positions = torch.arange(S, device=dev)[None]

    def body(lp, h):
        return transformer.dense_stack(
            h, pt.tree_map(lambda w: w[None], lp), cfg, None,
            positions.expand(h.shape[0], S))[0]

    with torch.no_grad():
        staged = stack_stages(layers, 1)
        want = transformer.dense_stack(x, layers, cfg, None,
                                       positions.expand(TRAIN_B, S))[0]
        got = pipeline_forward(body, staged, x, mesh,
                               n_microbatches=PIPE_MICRO, pipe_axis="pipe")
        nerr = float(torch.linalg.norm((got - want).double())
                     / torch.linalg.norm(want.double()))
        ms = cuda_ms(lambda: pipeline_forward(
            body, staged, x, mesh, n_microbatches=PIPE_MICRO,
            pipe_axis="pipe"), 3)
        plain_ms = cuda_ms(lambda: transformer.dense_stack(
            x, layers, cfg, None, positions.expand(TRAIN_B, S)), 3)
    if not bool(torch.isfinite(got).all()):
        fail(f"pipeline {cfg.name}: non-finite output")
    return nerr, ms, plain_ms


def train_cli_mesh(ckpt_dir):
    """``python -m repro_torch.launch.train --reduced --data-mesh 1`` on
    the card in a process of its own: (seconds, stdout)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--reduced", "--device", "cuda", "--data-mesh", "1",
           "--steps", str(CLI_STEPS), "--ckpt-every", str(CLI_EVERY),
           "--batch", str(TRAIN_B), "--seq", "64", "--ckpt-dir",
           str(ckpt_dir)]
    t0 = time.time()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        fail(f"mesh training: {' '.join(cmd[1:])} exited "
             f"{out.returncode}: {out.stderr[-2000:]}")
    return time.time() - t0, out.stdout


def mesh_cli_phase(smi):
    """(d): the entry point on a mesh of the card, 4 steps with a
    checkpoint every 2; LATEST rewound to step 2 (step 4's checkpoint kept
    aside) and a second process resumes there: its step-4 checkpoint
    against the first's."""
    import shutil
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        ckpt = Path(tmp) / "ckpt"
        s1, out1 = train_cli_mesh(ckpt)
        step4, aside = ckpt / f"step_{CLI_STEPS}", Path(tmp) / "aside"
        if f"finished at step {CLI_STEPS}" not in out1 or not step4.is_dir():
            fail(f"mesh training: the entry point did not reach step "
                 f"{CLI_STEPS}: {out1!r}")
        shutil.copytree(step4, aside)
        shutil.rmtree(step4)
        (ckpt / "LATEST").write_text(str(CLI_REWIND))
        s2, out2 = train_cli_mesh(ckpt)
        logged = [json.loads(line)["step"] for line in
                  (ckpt / "metrics.jsonl").read_text().splitlines()]
        want_log = list(range(CLI_STEPS)) + list(range(CLI_REWIND,
                                                       CLI_STEPS))
        if f"finished at step {CLI_STEPS}" not in out2 or logged != want_log:
            fail(f"mesh training: the second process did not resume at "
                 f"step {CLI_REWIND}: {out2!r}, logged steps {logged}")
        meta = json.loads((aside / "meta.json").read_text())["leaves"]
        num = den = 0.0
        bitwise = True
        for leaf in meta.values():
            w = np.load(aside / leaf["file"]).astype(np.float64)
            g = np.load(step4 / leaf["file"]).astype(np.float64)
            bitwise &= bool(np.array_equal(g, w))
            num += float(np.sum((g - w) ** 2))
            den += float(np.sum(w ** 2))
        nerr = math.sqrt(num / den)
    print(f"[{smi}] mesh training (d) python -m repro_torch.launch.train "
          f"--reduced --data-mesh 1: {CLI_STEPS} steps in {s1:.1f} s, then "
          f"resumed at step {CLI_REWIND} in a second process ({s2:.1f} s): "
          f"step-{CLI_STEPS} checkpoint ({len(meta)} leaves) "
          f"{'bitwise equal' if bitwise else f'normalized error {nerr:.2e}'}"
          f" to the uninterrupted run's (bound {TRAIN_REL})", flush=True)
    if not nerr <= TRAIN_REL:
        fail(f"mesh training: the resumed run is off by {nerr:.2e}")
    return {"cli_s": s1, "resume_cli_s": s2, "leaves": len(meta),
            "bitwise": bitwise, "nerr": nerr, "bound": TRAIN_REL,
            "logged_steps": logged}


def mesh_training_phase(smi, dev, launch_counts):
    """Phase 12: the trainer across devices (see the module docstring)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training import (make_shard_map_train_step,
                                      make_train_step)

    before = launch_counts()
    cfg = get_config(TRAIN_ARCH)
    report = {"config": TRAIN_ARCH, "params": cfg.num_params(),
              "batch": TRAIN_B, "seq": TRAIN_S, "lr": list(TRAIN_LR),
              "world": 1}
    print(f"[{smi}] mesh training: {TRAIN_ARCH} at full width, B={TRAIN_B}"
          f" x S={TRAIN_S}, an NCCL world of one", flush=True)
    mesh = make_test_mesh((1, 1), ("data", "model"))
    try:
        # (a) the mesh step against phase 10's mesh-less step -------------
        torch.cuda.empty_cache()
        state, plain_rows, want = mesh_step_run(
            smi, dev, cfg, None, lambda opt: make_train_step(cfg, None, opt),
            MESH_STEPS, "mesh-less", sharded=False)
        del state
        torch.cuda.empty_cache()
        state, rows, got = mesh_step_run(
            smi, dev, cfg, mesh, lambda opt: make_train_step(cfg, mesh, opt),
            MESH_STEPS, "mesh adamw")
        if not all(hasattr(x, "full_tensor") for x in
                   torch.utils._pytree.tree_leaves(state.params)):
            fail("mesh training: the mesh state is not held as DTensors")
        del state
        torch.cuda.empty_cache()
        nerr = leafwise_nerr(got, want)
        loss_err = [abs(r["loss"] - p["loss"]) / abs(p["loss"])
                    for r, p in zip(rows, plain_rows)]
        print(f"[{smi}] mesh training (a) make_train_step on the (1, 1) "
              f"mesh vs the mesh-less step: loss relative errors "
              + ", ".join(f"{e:.2e}" for e in loss_err)
              + f", params after step 1 normalized error {nerr:.2e} (bound"
              f" {MESH_REL})", flush=True)
        if not (max(loss_err) <= MESH_REL and nerr <= MESH_REL):
            fail(f"mesh training: mesh step off the mesh-less step: "
                 f"{loss_err}, {nerr}")
        report["mesh_adamw"] = {"steps": rows, "mesh_less": plain_rows,
                                "loss_rel_err": loss_err,
                                "params_nerr": nerr, "bound": MESH_REL}
        del want

        # (b) the shard-map step, three compressions ----------------------
        mesh3 = make_test_mesh((1, 1, 1), ("pod", "data", "model"))
        report["shard_map"] = {}
        for compress in ("none", "bf16", "int8"):
            torch.cuda.empty_cache()
            state, srows, kept = mesh_step_run(
                smi, dev, cfg, mesh3,
                lambda opt: make_shard_map_train_step(
                    cfg, mesh3, opt, compress=compress),
                2, f"shard-map {compress}", sharded=False,
                keep_after=1 if compress == "none" else None)
            del state
            torch.cuda.empty_cache()
            entry = {"steps": srows}
            if compress == "none":
                serr = leafwise_nerr(kept, got)
                lerr = [abs(r["loss"] - p["loss"]) / abs(p["loss"])
                        for r, p in zip(srows, rows)]
                print(f"[{smi}] mesh training (b) shard-map none vs (a): "
                      f"loss relative errors "
                      + ", ".join(f"{e:.2e}" for e in lerr)
                      + f", params after step 1 {serr:.2e} (bound "
                      f"{SMAP_REL})", flush=True)
                if not (max(lerr) <= SMAP_REL and serr <= SMAP_REL):
                    fail(f"mesh training: shard-map none off the mesh "
                         f"step: {lerr}, {serr}")
                entry.update(loss_rel_err=lerr, params_nerr=serr,
                             bound=SMAP_REL)
            report["shard_map"][compress] = entry
        del got

        # (c) the pipeline over the stacked dense layers ------------------
        torch.cuda.empty_cache()
        pipe = make_test_mesh((1,), ("pipe",))
        red = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True),
                                  compute_dtype="float32")
        pipes = {}
        for name, c, bound in ((f"{TRAIN_ARCH} reduced, float32", red,
                                TRAIN_REL),
                               (f"{TRAIN_ARCH} full width, bfloat16", cfg,
                                PIPE_FULL_REL)):
            nerr, ms, plain_ms = pipeline_check(smi, dev, c, pipe)
            print(f"[{smi}] mesh training (c) pipeline_forward (pipe 1, "
                  f"{PIPE_MICRO} microbatches) vs dense_stack, {name}: "
                  f"normalized error {nerr:.2e} (bound {bound}); "
                  f"{ms:.2f} ms vs {plain_ms:.2f} ms", flush=True)
            if not nerr <= bound:
                fail(f"mesh training: pipeline off dense_stack by {nerr}")
            pipes[name] = {"nerr": nerr, "bound": bound, "ms": ms,
                           "dense_stack_ms": plain_ms}
            torch.cuda.empty_cache()
        report["pipeline"] = pipes
    finally:
        dist.destroy_process_group()

    # (d) the entry point on a mesh, and its resume ------------------------
    report["cli"] = mesh_cli_phase(smi)
    after = launch_counts()
    if after != before:
        fail(f"mesh training: kernel launches changed {before} -> {after}")
    report["kernel_launches_unchanged"] = True
    return report


# ---------------------------------------------------------------------------
# the decode phase (phase 13): prefill / decode_step against the full
# forward, the int8 cache, the continuous-batching engine, the reduced
# config card vs CPU and the KV cache policy from phase 9's curvature, on
# the full-width h2o-danube-1.8b (float32 params, bfloat16 compute and cache)
DEC_ARCH = CURV_ARCH
DEC_SEED = 0
DEC_B, DEC_STEPS = 2, 16
# past the 4,096 window, so the ring wraps; 4,160 = 65 x 64 gives the tiled
# attention q tiles of 832 and kv tiles of 1,040 (a length with no divisor
# near the tile falls to 1-wide tiles: ROADMAP, "Left open")
DEC_PROMPT = 4160
# decode against the full forward, normalized: the bf16 forward's bound in
# tests/test_torch_models.py and the float32 one, or twice the forward's own
# noise where that is larger -- the prompt's forward against the whole
# sequence's at the prompt's last position, which differ in nothing but
# the sequence length (so in the kernels' shapes and the attention tiles)
DEC_BF16 = 1e-2
DEC_F32 = 1e-5           # float32 compute and caches, TF32 off
DEC_INT8 = 1e-1          # int8 against the bf16 cache, normalized: ten times
#   the bound of tests/test_torch_kv_quant.py (measured there 3.8e-3 to
#   7.2e-3 at the reduced configs), for a gap that grows with width/depth
ENG_SLOTS, ENG_MAX_SEQ, ENG_NEW = 8, 4352, 32
ENG_SHORT, ENG_SHORT_LEN = 28, (16, 1024)    # prompt lengths, seeded numpy
ENG_LONG = 4                                 # prompts of DEC_PROMPT tokens
ENG_PREFILL_LENS = (256, 1024, DEC_PROMPT)
ENG_REPS = 10                                # timed decode steps / casts
DEC_RED_PROMPTS, DEC_RED_SLOTS, DEC_RED_NEW = 6, 2, 8
DEC_RED_REL = 1e-5                           # card vs CPU, float32


def dec_nerr(got, want):
    """||got - want|| / ||want|| in float64 on the tensors' device."""
    import torch
    got, want = got.double(), want.to(got.device).double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def event_median_ms(fn, reps):
    """Median CUDA-event ms of reps calls after one warm-up (no reset of
    the peak-memory statistics)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[reps // 2]


def state_bytes(state):
    return sum(t.numel() * t.element_size()
               for t in state["layer_caches"].values())


def ring_positions_ok(state, last, C):
    """Every layer and row of the cache holds exactly positions
    last - C + 1 .. last."""
    import torch
    pos = state["layer_caches"]["pos"].long()
    want = torch.arange(last - C + 1, last + 1, device=pos.device)
    return bool((pos.sort(dim=-1).values == want).all())


def decode_full_width(smi, dev, cfg, params, report):
    """(a) prefill / decode_step against the full forward, in bfloat16 and
    in float32; (b) the int8 cache on the same tokens."""
    import dataclasses

    import torch

    from repro_torch.models.model import (decode_step, forward,
                                          init_decode_state, make_batch,
                                          prefill)

    P, T = DEC_PROMPT, DEC_PROMPT + DEC_STEPS
    C = min(T, cfg.sliding_window)
    gen = torch.Generator(device=dev).manual_seed(DEC_SEED + 1)
    tokens = make_batch(cfg, DEC_B, T, gen, device=dev)["tokens"]

    def run(c, dtype):
        """prefill + DEC_STEPS decode steps: logits (each (B, V)), the
        prefill's ms, the state's bytes, the ring check after prefill."""
        state = init_decode_state(c, DEC_B, T, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        # the prefill's own peak (phase 16 holds the dry run's count to
        # it); the phase's peak so far is kept for report["peak_gb"]
        report["_peak_seen"] = max(report.get("_peak_seen", 0),
                                   torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        lg, state = prefill(params, c, {"tokens": tokens[:, :P]}, state)
        stop.record()
        torch.cuda.synchronize()
        peaks.append({"base_gb": base / 1e9,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        ring_prefill = ring_positions_ok(state, P - 1, C)
        out = [lg]
        for i in range(DEC_STEPS):
            pos = torch.full((DEC_B,), P + i, dtype=torch.int32, device=dev)
            lg, state = decode_step(params, c, tokens[:, P + i:P + i + 1],
                                    pos, state)
            out.append(lg)
        if not (ring_prefill and ring_positions_ok(state, T - 1, C)):
            fail(f"decode {c.compute_dtype}/{c.kv_cache_dtype}: the ring "
                 f"does not hold exactly the last {C} positions")
        return out, start.elapsed_time(stop), state_bytes(state)

    peaks = []

    def against_forward(c, dtype, floor_bound):
        """(a) for one compute dtype: the decode run and its errors against
        the full forward, held to max(floor_bound, twice the forward's own
        noise)."""
        t0 = time.time()
        # clone: a slice would keep the whole (B, S, V) logits alive
        full = forward(params, c, {"tokens": tokens})[0][:, P - 1:].clone()
        prompt_fwd = forward(params, c,
                             {"tokens": tokens[:, :P]})[0][:, -1].clone()
        floor = dec_nerr(prompt_fwd, full[:, 0])
        bound = max(floor_bound, 2.0 * floor)
        logits, ms, nbytes = run(c, dtype)
        vs_prompt = dec_nerr(logits[0], prompt_fwd)
        errs = [dec_nerr(lg, full[:, i]) for i, lg in enumerate(logits)]
        print(f"[{smi}] decode (a) {c.compute_dtype}: B={DEC_B}, prompt {P} "
              f"tokens (ring of {C} wraps), {DEC_STEPS} decode steps; the "
              f"forward's own noise (prompt vs whole sequence at the "
              f"prompt's last position) {floor:.3e}, bound {bound:.3e}; "
              f"prefill vs the prompt's forward {vs_prompt:.3e}; vs the "
              f"full forward: prefill {errs[0]:.3e}, steps max "
              f"{max(errs[1:]):.3e} ({time.time() - t0:.1f} s)", flush=True)
        # the prefill is the prompt's forward plus the cache writes
        if vs_prompt > 1e-3 * floor_bound:
            fail(f"decode: {c.compute_dtype} prefill logits off the prompt's "
                 f"forward by {vs_prompt:.3e}")
        if max(errs) > bound:
            fail(f"decode: {c.compute_dtype} logits off the full forward by "
                 f"{max(errs)} > {bound}")
        return logits, ms, nbytes, {
            "noise_floor": floor, "bound": bound,
            "prefill_vs_prompt_forward": vs_prompt, "prefill_err": errs[0],
            "step_err_max": max(errs[1:]), "prefill_ms": ms,
            "prefill_base_gb": peaks[-1]["base_gb"],
            "prefill_peak_gb": peaks[-1]["peak_gb"]}

    with torch.inference_mode():
        # (a) bfloat16, the config's own; then float32 compute and caches
        bf16, _, bf16_bytes, rep_bf16 = against_forward(cfg, torch.bfloat16,
                                                        DEC_BF16)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        _, _, _, rep_f32 = against_forward(cfg32, torch.float32, DEC_F32)

        # (b) the int8 cache -------------------------------------------------
        cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        int8, prefill8_ms, int8_bytes = run(cfg8, torch.bfloat16)
        gaps = [dec_nerr(a, b) for a, b in zip(int8, bf16)]
        maxabs = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(int8, bf16))
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    per_tok = {"bfloat16": 2 * L * KV * hd * 2, "int8": 2 * L * KV * (hd + 4)}
    want = {k: DEC_B * C * (v + 4 * L) for k, v in per_tok.items()}
    print(f"[{smi}] decode (b) int8 cache: prefill logits equal the bf16 "
          f"cache's: {gaps[0] == 0.0}; steps vs the bf16 cache normalized max "
          f"{max(gaps[1:]):.3e} (bound {DEC_INT8}), max abs {maxabs:.3e}; "
          f"cache bytes bf16 {bf16_bytes:,} int8 {int8_bytes:,} (formula "
          f"{want['bfloat16']:,} / {want['int8']:,}: k/v {per_tok['bfloat16']:,}"
          f" / {per_tok['int8']:,} B a token a sequence, ratio "
          f"{per_tok['int8'] / per_tok['bfloat16']:.4f}; with pos "
          f"{int8_bytes / bf16_bytes:.4f})", flush=True)
    if max(gaps) > DEC_INT8:
        fail(f"decode: int8 logits off the bf16 cache's by {max(gaps)}")
    if (bf16_bytes, int8_bytes) != (want["bfloat16"], want["int8"]):
        fail(f"decode: cache bytes {bf16_bytes}, {int8_bytes} != {want}")
    report["full_width"] = {
        "prompt": P, "batch": DEC_B, "steps": DEC_STEPS, "cache_slots": C,
        "bf16": rep_bf16, "float32": rep_f32,
        "int8": {"step_nerr_max": max(gaps[1:]), "max_abs": maxabs,
                 "bound": DEC_INT8, "prefill_equal": gaps[0] == 0.0,
                 "prefill_ms": prefill8_ms},
        "cache_bytes": {"bfloat16": bf16_bytes, "int8": int8_bytes,
                        "per_token_kv": per_tok,
                        "ratio_kv": per_tok["int8"] / per_tok["bfloat16"],
                        "ratio_with_pos": int8_bytes / bf16_bytes}}
    return rep_bf16["bound"]


def decode_engine_phase(smi, dev, cfg, params, bound, report):
    """(c) the engine at full width: 32 greedy requests, timing, teacher
    forcing against naive batch-1 decode."""
    import numpy as np
    import torch

    from repro_torch.models.common import cast_to_compute
    from repro_torch.models.decode_engine import ServingEngine
    from repro_torch.models.model import (decode_step, init_decode_state,
                                          prefill)

    rng = np.random.RandomState(DEC_SEED)
    lengths = [int(n) for n in rng.randint(ENG_SHORT_LEN[0],
                                           ENG_SHORT_LEN[1] + 1, ENG_SHORT)]
    lengths += [DEC_PROMPT] * ENG_LONG
    order = rng.permutation(len(lengths))
    prompts = [rng.randint(0, cfg.vocab_size, lengths[i]).astype(np.int32)
               for i in order]
    longs = [i for i, p in enumerate(prompts) if len(p) == DEC_PROMPT]
    shorts = [i for i, p in enumerate(prompts) if len(p) != DEC_PROMPT]
    forced = longs[:2] + shorts[:2]

    eng = ServingEngine(params, cfg, max_batch=ENG_SLOTS, max_seq=ENG_MAX_SEQ)
    C = eng.state["layer_caches"]["k"].shape[2]
    reqs = [eng.submit(p, max_new_tokens=ENG_NEW, keep_logits=i in forced)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    if len(done) != len(reqs) or any(len(r.out_tokens) != ENG_NEW
                                     for r in reqs):
        fail("decode engine: a request did not finish with "
             f"{ENG_NEW} tokens")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"[{smi}] decode (c) engine: {len(reqs)} requests ({ENG_SHORT} "
          f"prompts of {min(lengths[:ENG_SHORT])}-{max(lengths[:ENG_SHORT])} "
          f"tokens, {ENG_LONG} of {DEC_PROMPT}), {ENG_SLOTS} slots of {C}, "
          f"{n_tok} tokens in {wall:.2f} s: {n_tok / wall:.1f} tokens/s "
          f"(prefills included)", flush=True)

    # teacher forcing: naive batch-1 prefill + decode fed the engine's tokens
    tf_err = 0.0
    with torch.inference_mode():
        for i in forced:
            req, prompt = reqs[i], prompts[i]
            state = init_decode_state(cfg, 1, ENG_MAX_SEQ, device=dev)
            toks = torch.as_tensor(prompt[None, :], device=dev)
            lg, state = prefill(params, cfg, {"tokens": toks}, state)
            errs = [dec_nerr(lg[0], req.out_logits[0])]
            for j in range(1, ENG_NEW):
                lg, state = decode_step(
                    params, cfg,
                    torch.tensor([[req.out_tokens[j - 1]]], device=dev),
                    torch.tensor([len(prompt) + j - 1], device=dev), state)
                errs.append(dec_nerr(lg[0], req.out_logits[j]))
            tf_err = max(tf_err, max(errs))
            del state
    print(f"[{smi}] decode (c) teacher forcing, {len(forced)} requests "
          f"(prompts {[len(prompts[i]) for i in forced]}): batch-1 naive "
          f"decode vs the engine's logits, max normalized {tf_err:.3e} "
          f"(bound {bound:.3e})", flush=True)
    if tf_err > bound:
        fail(f"decode engine: teacher-forced logits off by {tf_err}")

    # timing: a decode step of 8 full slots, the cast, prefills
    with torch.inference_mode():
        toks = torch.zeros((ENG_SLOTS, 1), dtype=torch.int64, device=dev)
        pos = torch.full((ENG_SLOTS,), ENG_MAX_SEQ - 1, dtype=torch.int32,
                         device=dev)
        step_ms = event_median_ms(
            lambda: decode_step(params, cfg, toks, pos, eng.state), ENG_REPS)
        wall_ms, busy_ms, top = device_busy_ms(
            lambda: decode_step(params, cfg, toks, pos, eng.state))
        cast_ms = event_median_ms(lambda: cast_to_compute(params, cfg),
                                  ENG_REPS)
        prefill_ms = {}
        for n in ENG_PREFILL_LENS:
            st = init_decode_state(cfg, 1, ENG_MAX_SEQ, device=dev)
            ptoks = torch.as_tensor(prompts[longs[0]][None, :n], device=dev)
            prefill_ms[n] = event_median_ms(
                lambda: prefill(params, cfg, {"tokens": ptoks}, st), 3)
            del st
    L, KV, hd, d = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_,
                    cfg.d_model)
    param_bytes = 2 * (cfg.num_params() - cfg.vocab_size * d
                       + ENG_SLOTS * d)
    cache_read = ENG_SLOTS * C * L * (2 * KV * hd * 2 + 4)
    step_bound = (param_bytes + cache_read) / PEAK_BYTES * 1e3
    cast_bound = cfg.num_params() * (4 + 2) / PEAK_BYTES * 1e3
    cache_gb = state_bytes(eng.state) / 1e9
    print(f"[{smi}] decode (c) step, {ENG_SLOTS} full slots: {step_ms:.3f} "
          f"ms median of {ENG_REPS} (bound {step_bound:.3f} ms: bf16 params "
          f"{param_bytes / 1e9:.2f} GB + cache read {cache_read / 1e9:.2f} "
          f"GB at 3.35 TB/s, {step_bound / step_ms:.1%} of it); under "
          f"torch.profiler {wall_ms:.1f} ms wall, the card in kernels "
          f"{busy_ms:.2f} ms, idle {max(0.0, 1 - busy_ms / step_ms):.1%} of "
          f"the step; by device time: "
          + "; ".join(f"{k} {t:.2f} ms x{c}" for k, t, c in top), flush=True)
    print(f"[{smi}] decode (c) cast_to_compute alone {cast_ms:.3f} ms (bound "
          f"{cast_bound:.3f} ms), {cast_ms / step_ms:.1%} of a step; prefill "
          f"ms at B=1: " + ", ".join(f"{n} tokens {t:.1f}" for n, t in
                                     prefill_ms.items())
          + f"; cache {cache_gb:.3f} GB, peak during the run "
          f"{peak_run / 1e9:.2f} GB", flush=True)
    report["engine"] = {
        "requests": len(reqs), "slots": ENG_SLOTS, "cache_slots": C,
        "max_new_tokens": ENG_NEW, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "teacher_forced": len(forced),
        "teacher_forcing_err_max": tf_err, "bound": bound,
        "step_ms": step_ms, "step_bound_ms": step_bound,
        "step_bound_share": step_bound / step_ms,
        "step_profiled_wall_ms": wall_ms, "step_device_busy_ms": busy_ms,
        "step_idle_share": max(0.0, 1 - busy_ms / step_ms),
        "step_top_ops": top, "cast_ms": cast_ms, "cast_bound_ms": cast_bound,
        "cast_share": cast_ms / step_ms,
        "prefill_ms": {str(n): t for n, t in prefill_ms.items()},
        "cache_gb": cache_gb, "peak_run_gb": peak_run / 1e9}
    del eng, reqs, done


def decode_reduced(smi, dev):
    """(d) the reduced config at float32 compute and cache: the same
    CPU-made params through a 2-slot engine on the CPU and on the card."""
    import dataclasses

    import numpy as np
    import torch
    from torch.utils import _pytree as pt

    from repro_torch.configs import get_config
    from repro_torch.models.decode_engine import ServingEngine
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config(DEC_ARCH, reduced=True),
                              compute_dtype="float32")
    host = init_params(cfg, DEC_SEED, device="cpu")
    rng = np.random.RandomState(DEC_SEED)
    # lengths past the reduced window of 32, so its ring wraps
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 20, 33, 40, 9)[:DEC_RED_PROMPTS]]

    def run(device, params):
        eng = ServingEngine(params, cfg, max_batch=DEC_RED_SLOTS, max_seq=64,
                            cache_dtype=torch.float32, device=device)
        reqs = [eng.submit(p, max_new_tokens=DEC_RED_NEW, keep_logits=True)
                for p in prompts]
        eng.run()
        return reqs

    cpu = run("cpu", host)
    card = run(dev, pt.tree_map(lambda t: t.to(dev), host))
    same = all(a.out_tokens == b.out_tokens for a, b in zip(cpu, card))
    err = max(dec_nerr(b, a) for x, y in zip(cpu, card)
              for a, b in zip(x.out_logits, y.out_logits))
    print(f"[{smi}] decode (d) reduced config, float32: {len(prompts)} "
          f"prompts through a {DEC_RED_SLOTS}-slot engine on the CPU and the "
          f"card: tokens equal {same}, logits max normalized {err:.3e} "
          f"(bound {DEC_RED_REL})", flush=True)
    if not same or err > DEC_RED_REL:
        fail(f"decode: reduced engine card vs CPU (tokens equal {same}, "
             f"err {err})")
    return {"prompts": len(prompts), "slots": DEC_RED_SLOTS,
            "tokens_equal": same, "logits_err_max": err,
            "bound": DEC_RED_REL}


def decode_phase(smi, dev, launch_counts, kv_spectrum):
    """Phase 13: LM decode on the full-width h2o-danube-1.8b (see the
    module docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.kv_quant import (choose_kv_cache_dtype,
                                             kv_sensitivity)
    from repro_torch.models.params import init_params

    before = launch_counts()
    cfg = get_config(DEC_ARCH)
    report = {"config": DEC_ARCH, "params": cfg.num_params(), "card": smi}
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(DEC_SEED)
    params = init_params(cfg, gen, device=dev)
    print(f"[{smi}] decode: {DEC_ARCH} at full width, {cfg.num_params():,} "
          f"params (float32, compute {cfg.compute_dtype}), window "
          f"{cfg.sliding_window}", flush=True)

    bound = decode_full_width(smi, dev, cfg, params, report)
    torch.cuda.empty_cache()
    decode_engine_phase(smi, dev, cfg, params, bound, report)
    report["peak_gb"] = max(report.pop("_peak_seen", 0),
                            torch.cuda.max_memory_allocated()) / 1e9
    del params
    torch.cuda.empty_cache()
    report["reduced"] = decode_reduced(smi, dev)

    # (e) the KV cache policy from phase 9's full-width curvature ---------
    sens = kv_sensitivity(kv_spectrum)
    policy = choose_kv_cache_dtype(sens, int8_budget_frac=0.5)
    n8 = sorted(l for l, d in policy.items() if d == "int8")
    print(f"[{smi}] decode (e) KV cache policy from phase 9's diag spectrum "
          f"(int8_budget_frac 0.5): int8 layers {n8}, bfloat16 the rest of "
          f"{len(policy)}", flush=True)
    if sorted(policy) != list(range(cfg.num_layers)) or \
            len(n8) != cfg.num_layers // 2:
        fail(f"decode: the KV policy {policy} does not cover "
             f"{cfg.num_layers} layers with {cfg.num_layers // 2} int8")
    report["kv_policy"] = {"int8_layers": n8, "sensitivity": sens}
    after = launch_counts()
    report["launches"] = {"before": list(before), "after": list(after)}
    if after != before:
        fail(f"decode: kernel launches changed {before} -> {after}")
    return report


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid families (phase 14): the full-width
# granite-moe-1b-a400m, zamba2-1.2b and mamba2-2.7b from seeded params
# (float32 params, bfloat16 compute): curvature, training, decode against
# the full forward, int8 caches and the engine; the reduced configs card vs
# CPU; the sharded MoE in an NCCL world of one
ZOO_ARCHS = ("granite-moe-1b-a400m", "zamba2-1.2b", "mamba2-2.7b")
ZOO_SEED = 0
ZOO_B, ZOO_S = 2, 512                # phase 9's curvature and train batch
ZOO_PROBES = 4
ZOO_REPS = 3                         # timed hvp calls after one warm-up
ZOO_DEC_STEPS = 16
# decode prompts: past zamba2's 4,096 window; an SSM refuses a length that
# is not a multiple of its 128-token chunk, so zamba2 and mamba2 prefill
# 4,224 = 33 x 128 tokens (attention tiles 704 x 1,408) and their full
# forward runs to the next multiple of 128, read at the decoded positions
ZOO_PROMPT = {"moe": 4160, "hybrid": 4224, "ssm": 4224}    # by family
ZOO_CHUNK = 128
# 16 requests, not 32: the depth cut that makes room for phase 16
ZOO_ENG_SLOTS, ZOO_ENG_REQS, ZOO_ENG_NEW = 8, 16, 32
ZOO_ENG_MAX_SEQ = 4352
ZOO_ENG_LONG = 4                     # prompts of ZOO_PROMPT; the rest short
ZOO_ENG_SHORT = (16, 128)            # prompt lengths, seeded numpy
ZOO_STEP_REPS = 10
ZOO_RED_PROMPTS = (5, 12, 20, 33, 40, 9)
ZOO_RED_REL = 1e-5                   # card vs CPU, float32
ZOO_SHARD_REL = 1e-6                 # moe_block_sharded vs moe_block
ZOO_SHARD_T = 1024                   # tokens of the sharded-block check


def zoo_state_bytes(state):
    from torch.utils import _pytree as pt
    return sum(t.numel() * t.element_size() for t in pt.tree_leaves(state))


def zoo_curvature(smi, dev, cfg, params, batch):
    """The loss, the drop share at the default capacity, hvp / diag / ggn
    on pytree_fwdrev with the two AD routes' agreement (phase 9's)."""
    import torch

    from repro_torch import engine
    from repro_torch.core import curvature as tc
    from repro_torch.models import moe
    from repro_torch.models.targets import lm_curvature_targets

    tgt = lm_curvature_targets(cfg, batch)
    out = {"batch": list(batch["tokens"].shape)}
    with torch.no_grad(), moe.record_drops() as drops:
        loss = tgt.loss(params).item()
    if not math.isfinite(loss):
        fail(f"zoo {cfg.name}: loss {loss}")
    out["loss"] = loss
    if cfg.family == "moe":
        per_layer = [int(d) / n for d, n in drops]
        dropped = sum(int(d) for d, _ in drops)
        assigned = sum(n for _, n in drops)
        out.update(drop_share=dropped / assigned, dropped=dropped,
                   assigned=assigned, drop_share_by_layer=per_layer)
        print(f"[{smi}] zoo {cfg.name}: loss {loss:.6f}; at capacity factor "
              f"{cfg.capacity_factor} the train batch drops {dropped:,} of "
              f"{assigned:,} (token, expert) assignments "
              f"({dropped / assigned:.2%}) over {len(drops)} layers; by "
              f"layer " + " ".join(f"{x:.1%}" for x in per_layer),
              flush=True)
    plan = engine.plan(tgt.loss, None, csize=1, device=dev,
                       backend="pytree_fwdrev",
                       options={"n_probes": ZOO_PROBES,
                                **tgt.plan_options()})
    v = tc.rademacher_like(1, params)

    def hvp_numbers(hv):
        tree_finite(hv, f"zoo {cfg.name} hvp")
        w = tc.rademacher_like(2, params)
        return tree_dot(v, hv), tree_dot(hv, hv) ** 0.5, tree_dot(w, hv)

    ms, (vhv, hv_norm, whv), peak = median_cuda_ms(
        lambda: plan.hvp(params, v), hvp_numbers, ZOO_REPS)
    t_prof = time.time()
    wall, busy, top = device_busy_ms(lambda: plan.hvp(params, v))
    t_prof = time.time() - t_prof
    out["hvp"] = {"ms": ms, "peak_gb": peak / 1e9, "profiled_wall_ms": wall,
                  "profiler_s": t_prof,
                  "device_busy_ms": busy,
                  "device_idle_share": max(0.0, 1.0 - busy / ms),
                  "top_ops": top}
    print(f"[{smi}] zoo {cfg.name} hvp: {ms:.1f} ms (median of {ZOO_REPS} "
          f"after a warm-up), peak {peak / 1e9:.2f} GB; under "
          f"torch.profiler ({t_prof:.1f} s) the card in kernels "
          f"{busy:.1f} ms, idle {max(0.0, 1.0 - busy / ms):.1%}; by "
          f"device time: "
          + "; ".join(f"{k} {t:.1f} ms x{c}" for k, t, c in top),
          flush=True)
    scale = tree_dot(v, v) ** 0.5 * hv_norm
    hw = plan.hvp(params, tc.rademacher_like(2, params))
    vhw = tree_dot(v, hw)
    del hw
    quad = float(tc.pytree_hvp_fwd(tgt.loss, params, v, v))
    routes, sym = abs(quad - vhv) / scale, abs(whv - vhw) / scale
    print(f"[{smi}] zoo {cfg.name}: v.Hv {vhv:.6e} (hvp) vs {quad:.6e} "
          f"(forward-over-forward), {routes:.3e}; w.Hv vs v.Hw {sym:.3e} "
          f"(bound {BF16_ROUTES})", flush=True)
    if not (routes <= BF16_ROUTES and sym <= BF16_ROUTES):
        fail(f"zoo {cfg.name}: AD routes disagree ({routes:.3e}, "
             f"{sym:.3e})")
    out["routes"] = {"vHv": vhv, "quadform": quad, "routes_err": routes,
                     "symmetry_err": sym}

    def v_dot(name):
        def digest(t):
            tree_finite(t, f"zoo {cfg.name} {name}")
            return tree_dot(v, t)
        return digest

    for name, call in (("ggn", lambda: plan.ggn(params, v)),
                       ("diag", lambda: plan.diag(params, 3))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = call()
        stop.record()
        torch.cuda.synchronize()
        ms, peak = start.elapsed_time(stop), torch.cuda.max_memory_allocated()
        out[name] = {"ms": ms, "peak_gb": peak / 1e9,
                     "v_dot": v_dot(name)(res)}
        del res
        print(f"[{smi}] zoo {cfg.name} {name}: {ms:.1f} ms (one call, after "
              f"the hvp's), peak {peak / 1e9:.2f} GB", flush=True)
    if not out["ggn"]["v_dot"] >= 0.0:
        fail(f"zoo {cfg.name}: v.Gv = {out['ggn']['v_dot']} < 0")
    return out


def zoo_decode(smi, dev, cfg, params, prompt=None, front=None,
               int8=True):
    """prefill + ZOO_DEC_STEPS decode steps against the full forward, in
    bfloat16, then at float32 compute and state, then (``int8``) with
    int8 KV caches.  ``prompt``: the prompt's tokens (ZOO_PROMPT by
    family); ``front``: the batch's frames / patches (B, F, d), prefilled
    with the prompt.  MoE at capacity factor E / k: capacity then covers
    every token, so decode and forward route alike.  The bfloat16 bound is
    max(1e-2, twice the forward's own noise), the noise the larger of the
    prompt's forward against the whole sequence's (phase 13's) and the
    bfloat16 forward against the float32 one at the decoded positions: an
    SSM's chunked forward gives the prompt's positions bitwise whatever
    the length, so only the second sees its rounding.  The float32 bound
    is max(1e-5, twice the float32 prompt-vs-whole noise)."""
    import dataclasses

    import torch

    from repro_torch.models.model import (decode_step, forward,
                                          frontend_offset, init_decode_state,
                                          make_batch, prefill)

    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    P = prompt or ZOO_PROMPT[cfg.family]
    T = P + ZOO_DEC_STEPS
    if cfg.family in ("ssm", "hybrid"):
        T = -(-T // ZOO_CHUNK) * ZOO_CHUNK
    off = frontend_offset(cfg)
    extra = front or {}
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED + 1)
    tokens = make_batch(dataclasses.replace(cfg, frontend=None), ZOO_B, T,
                        gen, device=dev)["tokens"]

    def run(c, dtype=torch.bfloat16):
        state = init_decode_state(c, ZOO_B, off + P + ZOO_DEC_STEPS,
                                  dtype=dtype, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        lg, state = prefill(params, c, {"tokens": tokens[:, :P], **extra},
                            state)
        stop.record()
        torch.cuda.synchronize()
        out = [lg]
        for i in range(ZOO_DEC_STEPS):
            pos = torch.full((ZOO_B,), off + P + i, dtype=torch.int32,
                             device=dev)
            lg, state = decode_step(params, c, tokens[:, P + i:P + i + 1],
                                    pos, state)
            out.append(lg)
        torch.cuda.synchronize()
        tree_finite(out, f"zoo {c.name} decode logits")
        cross = state.get("cross_kv")
        return out, start.elapsed_time(stop), {
            "state_bytes": zoo_state_bytes(state),
            "cross_kv_bytes": 0 if cross is None else zoo_state_bytes(cross),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    def forwards(c):
        """The full forward at the prompt's last and the decoded
        positions, the prompt's own forward at its last position."""
        full = forward(params, c, {"tokens": tokens, **extra})[0]
        full = full[:, off + P - 1:off + P + ZOO_DEC_STEPS].clone()
        return full, forward(params, c, {"tokens": tokens[:, :P],
                                         **extra})[0][:, -1].clone()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        t0 = time.time()
        full, prompt_lg = forwards(cfg)
        full32, prompt32 = forwards(cfg32)
        floor_len = dec_nerr(prompt_lg, full[:, 0])
        floor_f32 = dec_nerr(full, full32)
        floor = max(floor_len, floor_f32)
        bound = max(DEC_BF16, 2.0 * floor)
        logits, ms, sizes = run(cfg)
        vs_prompt = dec_nerr(logits[0], prompt_lg)
        errs = [dec_nerr(lg, full[:, i]) for i, lg in enumerate(logits)]
        out = {"prompt": P, "forward_len": T, "frontend_len": off,
               "noise_floor": floor, "noise_prompt_vs_full": floor_len,
               "noise_bf16_vs_f32": floor_f32,
               "bound": bound, "prefill_vs_prompt_forward": vs_prompt,
               "prefill_err": errs[0], "step_err_max": max(errs[1:]),
               "prefill_ms": ms, **sizes}
        print(f"[{smi}] zoo {cfg.name} decode: B={ZOO_B}, prompt {P}"
              + (f" after {off} patches" if off else "")
              + f", {ZOO_DEC_STEPS} steps vs the forward of {T} tokens; "
              f"noise: prompt vs whole {floor_len:.3e}, bf16 vs float32 "
              f"{floor_f32:.3e}; bound {bound:.3e}; prefill vs the "
              f"prompt's forward {vs_prompt:.3e}; vs the full forward: "
              f"prefill {errs[0]:.3e}, steps max {max(errs[1:]):.3e}; "
              f"prefill {ms:.1f} ms; state {sizes['state_bytes'] / 1e9:.3f} "
              f"GB (cross_kv {sizes['cross_kv_bytes'] / 1e9:.3f} GB), peak "
              f"{sizes['peak_gb']:.2f} GB ({time.time() - t0:.1f} s)",
              flush=True)
        if vs_prompt > 1e-3 * DEC_BF16:
            fail(f"zoo {cfg.name}: prefill off the prompt's forward by "
                 f"{vs_prompt:.3e}")
        if max(errs) > bound:
            fail(f"zoo {cfg.name}: decode off the full forward by "
                 f"{max(errs):.3e} > {bound:.3e}")
        # float32 compute and state, every family (the recurrence against
        # the chunks, the routing and the shared block unrounded)
        logits32, ms32, sizes32 = run(cfg32, torch.float32)
        floor32 = dec_nerr(prompt32, full32[:, 0])
        bound32 = max(DEC_F32, 2.0 * floor32)
        errs32 = [dec_nerr(lg, full32[:, i])
                  for i, lg in enumerate(logits32)]
        out["float32"] = {"noise_floor": floor32, "bound": bound32,
                          "err_max": max(errs32), "prefill_err": errs32[0],
                          "prefill_ms": ms32, **sizes32}
        print(f"[{smi}] zoo {cfg.name} decode at float32 compute and "
              f"state: vs the float32 forward max {max(errs32):.3e} "
              f"(bound {bound32:.3e}, noise {floor32:.3e}); prefill "
              f"{ms32:.1f} ms, peak {sizes32['peak_gb']:.2f} GB", flush=True)
        if max(errs32) > bound32:
            fail(f"zoo {cfg.name}: float32 decode off the forward by "
                 f"{max(errs32):.3e} > {bound32:.3e}")
        if int8 and cfg.family != "ssm":
            cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
            int8_lg, _, sizes8 = run(cfg8)
            gaps = [dec_nerr(a, b) for a, b in zip(int8_lg, logits)]
            out["int8"] = {"step_nerr_max": max(gaps[1:]),
                           "prefill_nerr": gaps[0], "bound": DEC_INT8,
                           "state_bytes": sizes8["state_bytes"]}
            print(f"[{smi}] zoo {cfg.name} int8 caches: vs the bf16 "
                  f"caches' logits, prefill {gaps[0]:.3e}, steps max "
                  f"{max(gaps[1:]):.3e} (bound {DEC_INT8}); state "
                  f"{sizes8['state_bytes'] / 1e9:.3f} GB", flush=True)
            if max(gaps) > DEC_INT8:
                fail(f"zoo {cfg.name}: int8 logits off by {max(gaps)}")
    return out


def zoo_engine(smi, dev, cfg, params, prompt=None):
    """ServingEngine with 8 slots, 16 greedy requests of 32 tokens (the
    long ones of ``prompt`` tokens, ZOO_PROMPT by family); one long
    request teacher-forced through batch-1 prefill + decode_step; the ms
    of an 8-slot decode step beside its byte bound."""
    import numpy as np
    import torch

    from repro_torch.models.decode_engine import ServingEngine
    from repro_torch.models.model import (decode_step, init_decode_state,
                                          prefill)

    P = prompt or ZOO_PROMPT[cfg.family]
    rng = np.random.RandomState(ZOO_SEED)
    n_short = ZOO_ENG_REQS - ZOO_ENG_LONG
    lengths = [int(n) for n in rng.randint(ZOO_ENG_SHORT[0],
                                           ZOO_ENG_SHORT[1] + 1, n_short)]
    lengths += [P] * ZOO_ENG_LONG
    prompts = [rng.randint(0, cfg.vocab_size, lengths[i]).astype(np.int32)
               for i in rng.permutation(len(lengths))]
    forced = next(i for i, p in enumerate(prompts) if len(p) == P)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(params, cfg, max_batch=ZOO_ENG_SLOTS,
                        max_seq=ZOO_ENG_MAX_SEQ)
    reqs = [eng.submit(p, max_new_tokens=ZOO_ENG_NEW,
                       keep_logits=i == forced)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != len(reqs) or any(len(r.out_tokens) != ZOO_ENG_NEW
                                     for r in reqs):
        fail(f"zoo {cfg.name} engine: a request did not finish")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    out = {"requests": len(reqs), "slots": ZOO_ENG_SLOTS, "tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "cache_gb": zoo_state_bytes(eng.state) / 1e9,
           "peak_run_gb": torch.cuda.max_memory_allocated() / 1e9}

    with torch.inference_mode():
        req = reqs[forced]
        state = init_decode_state(cfg, 1, ZOO_ENG_MAX_SEQ, device=dev)
        lg, state = prefill(params, cfg, {"tokens": torch.as_tensor(
            prompts[forced][None], device=dev)}, state)
        errs = [dec_nerr(lg[0], req.out_logits[0])]
        for j in range(1, ZOO_ENG_NEW):
            lg, state = decode_step(
                params, cfg, torch.tensor([[req.out_tokens[j - 1]]],
                                          device=dev),
                torch.tensor([P + j - 1], device=dev), state)
            errs.append(dec_nerr(lg[0], req.out_logits[j]))
        del state
        toks = torch.zeros((ZOO_ENG_SLOTS, 1), dtype=torch.int64,
                           device=dev)
        pos = torch.full((ZOO_ENG_SLOTS,), ZOO_ENG_MAX_SEQ - 1,
                         dtype=torch.int32, device=dev)
        # a step writes the engine's state in place (its requests are done)
        step_ms = event_median_ms(
            lambda: decode_step(params, cfg, toks, pos, eng.state),
            ZOO_STEP_REPS)
        pwall, busy, top = device_busy_ms(
            lambda: decode_step(params, cfg, toks, pos, eng.state))
    tf_err = max(errs)
    # the bf16 params, the embedding's 8 rows of it (granite's 8 tokens x
    # top-8 may reach all 32 experts), and the decode state, read once
    d = cfg.d_model
    param_bytes = 2 * (cfg.num_params() - cfg.vocab_size * d
                       + ZOO_ENG_SLOTS * d)
    step_bound = (param_bytes + zoo_state_bytes(eng.state)) / PEAK_BYTES * 1e3
    out.update(teacher_forcing_err=tf_err, step_ms=step_ms,
               step_bound_ms=step_bound, step_bound_share=step_bound / step_ms,
               step_device_busy_ms=busy,
               step_idle_share=max(0.0, 1.0 - busy / step_ms),
               step_top_ops=top)
    print(f"[{smi}] zoo {cfg.name} engine: {len(reqs)} requests ("
          f"{n_short} prompts of {ZOO_ENG_SHORT[0]}-{ZOO_ENG_SHORT[1]}, "
          f"{ZOO_ENG_LONG} of {P}), {ZOO_ENG_SLOTS} slots: {n_tok} tokens in "
          f"{wall:.2f} s, {n_tok / wall:.1f} tokens/s; teacher forcing "
          f"(prompt {P}) max {tf_err:.3e}; decode step of 8 full slots "
          f"{step_ms:.3f} ms (bound {step_bound:.3f} ms, "
          f"{step_bound / step_ms:.1%}), card idle "
          f"{max(0.0, 1.0 - busy / step_ms):.1%}; by device time: "
          + "; ".join(f"{k} {t:.2f} ms x{c}" for k, t, c in top)
          + f"; cache {out['cache_gb']:.3f} GB, peak "
          f"{out['peak_run_gb']:.2f} GB", flush=True)
    return out, tf_err


def zoo_full_width(smi, dev, name):
    """One family at full width: curvature and 3 AdamW steps (granite,
    zamba2), decode against the forward, int8 caches and the engine."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw, warmup_cosine

    t0 = time.time()
    cfg = get_config(name)
    rep = {"params": cfg.num_params(), "family": cfg.family,
           "layers": cfg.num_layers}
    print(f"[{smi}] zoo: {name} at full width, {cfg.num_params():,} params "
          f"(float32, compute {cfg.compute_dtype})", flush=True)
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED)
    params = init_params(cfg, gen, device=dev)
    parts = rep["part_s"] = {}
    if cfg.family != "ssm":
        t = time.time()
        batch = make_batch(cfg, ZOO_B, ZOO_S, gen, device=dev)
        rep["curvature"] = zoo_curvature(smi, dev, cfg, params, batch)
        del batch
        torch.cuda.empty_cache()
        parts["curvature"], t = time.time() - t, time.time()
        state, rows = full_width_steps(
            smi, dev, cfg, adamw(warmup_cosine(*TRAIN_LR)), name)
        del state
        rep["train"] = {"steps": rows,
                        "step_ms_median": sorted(r["ms"] for r in rows)[
                            len(rows) // 2]}
        torch.cuda.empty_cache()
        parts["train"] = time.time() - t
    t = time.time()
    rep["decode"] = zoo_decode(smi, dev, cfg, params)
    torch.cuda.empty_cache()
    parts["decode"], t = time.time() - t, time.time()
    bound = rep["decode"]["bound"]
    rep["engine"], tf_err = zoo_engine(smi, dev, cfg, params)
    if tf_err > bound:
        fail(f"zoo {name} engine: teacher-forced logits off by {tf_err}")
    parts["engine"] = time.time() - t
    rep["s"] = time.time() - t0
    del params
    torch.cuda.empty_cache()
    return rep


def zoo_reduced(smi, dev):
    """(d) each reduced config at float32 compute and state: CPU-made
    params through a 2-slot engine on the CPU and on the card."""
    import dataclasses

    import numpy as np
    import torch
    from torch.utils import _pytree as pt

    from repro_torch.configs import get_config
    from repro_torch.models.decode_engine import ServingEngine
    from repro_torch.models.params import init_params

    out = {}
    for name in ZOO_ARCHS:
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  compute_dtype="float32")
        host = init_params(cfg, ZOO_SEED, device="cpu")
        rng = np.random.RandomState(ZOO_SEED)
        prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                   for n in ZOO_RED_PROMPTS]

        def run(device, params):
            eng = ServingEngine(params, cfg, max_batch=2, max_seq=64,
                                cache_dtype=torch.float32, device=device)
            reqs = [eng.submit(p, max_new_tokens=8, keep_logits=True)
                    for p in prompts]
            eng.run()
            return reqs

        cpu = run("cpu", host)
        card = run(dev, pt.tree_map(lambda t: t.to(dev), host))
        same = all(a.out_tokens == b.out_tokens for a, b in zip(cpu, card))
        err = max(dec_nerr(b, a) for x, y in zip(cpu, card)
                  for a, b in zip(x.out_logits, y.out_logits))
        out[name] = {"tokens_equal": same, "logits_err_max": err}
        print(f"[{smi}] zoo (d) reduced {name}, float32: "
              f"{len(prompts)} prompts through a 2-slot engine on the CPU "
              f"and the card: tokens equal {same}, logits max normalized "
              f"{err:.3e} (bound {ZOO_RED_REL})", flush=True)
        if not same or err > ZOO_RED_REL:
            fail(f"zoo: reduced {name} card vs CPU (tokens equal {same}, "
                 f"err {err})")
    return out


def zoo_sharded(smi, dev):
    """(e) moe_block_sharded in an NCCL world of one against moe_block at
    a full-width granite layer; then the entry point's ``main`` with the
    sharded MoE on a (1, 1) mesh (it starts and ends a world of its
    own)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe import moe_block
    from repro_torch.models.moe_sharded import moe_block_sharded

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              compute_dtype="float32")
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    g = torch.Generator(device=dev).manual_seed(ZOO_SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale)

    p = {"router": randn(d, E, scale=d ** -0.5),
         "w_down": randn(E, ff, d, scale=ff ** -0.5),
         "w_gate": randn(E, d, ff, scale=d ** -0.5),
         "w_up": randn(E, d, ff, scale=d ** -0.5)}
    x = randn(ZOO_SHARD_T, d)
    r = randn(ZOO_SHARD_T, d)
    mesh = make_test_mesh((1, 1), ("data", "model"))
    try:
        res = {}
        for tag, fn in (("plain", lambda xx, pp: moe_block(xx, pp, cfg)),
                        ("sharded", lambda xx, pp: moe_block_sharded(
                            xx, pp, cfg, mesh))):
            xx = x.clone().requires_grad_()
            pp = {k: v.clone().requires_grad_() for k, v in p.items()}
            y, aux = fn(xx, pp)
            ((y * r).sum() + aux).backward()
            res[tag] = [y.detach(), aux.detach(), xx.grad] + \
                [pp[k].grad for k in sorted(pp)]
        errs = [dec_nerr(a, b) if b.dim() else
                abs(float(a) - float(b)) / abs(float(b))
                for a, b in zip(res["sharded"], res["plain"])]
    finally:
        dist.destroy_process_group()
    print(f"[{smi}] zoo (e) moe_block_sharded on a (1, 1) NCCL mesh vs "
          f"moe_block, T={ZOO_SHARD_T} at full width (float32, TF32 off): "
          f"y, aux, grads (x, router, w_down, w_gate, w_up) max normalized "
          f"{max(errs):.3e} (bound {ZOO_SHARD_REL})", flush=True)
    if max(errs) > ZOO_SHARD_REL:
        fail(f"zoo: moe_block_sharded off moe_block by {errs}")
    ckpt = ROOT / "build" / "zoo_train_ckpt"       # git-ignored
    shutil.rmtree(ckpt, ignore_errors=True)       # no resume from a last run
    t0 = time.time()
    args = ["--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "4",
            "--batch", "4", "--seq", "64", "--data-mesh", "1",
            "--moe-impl", "shard_map_local", "--device", "cuda",
            "--ckpt-dir", str(ckpt)]
    res = train_cli.main(args)
    losses = [m["loss"] for m in res["metrics"] if "loss" in m]
    print(f"[{smi}] zoo (e) repro_torch.launch.train " + " ".join(args[:-2])
          + f": final step {res['final_step']}, losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f" ({time.time() - t0:.1f} s)", flush=True)
    if res["final_step"] != 4 or len(losses) != 4 or \
            not all(map(math.isfinite, losses)):
        fail(f"zoo: the sharded-MoE entry point: {res['final_step']}, "
             f"{losses}")
    return {"errs": errs, "bound": ZOO_SHARD_REL,
            "cli_s": time.time() - t0, "cli_losses": losses}


def zoo_phase(smi, dev, launch_counts):
    """Phase 14: the MoE, SSM and hybrid families (see the module
    docstring)."""
    import torch

    before = launch_counts()
    report = {"card": smi}
    for name in ZOO_ARCHS:
        torch.cuda.empty_cache()
        report[name] = zoo_full_width(smi, dev, name)
        print(f"zoo {name}: {report[name]['s']:.1f} s ("
              + ", ".join(f"{k} {v:.1f}" for k, v in
                          report[name]["part_s"].items()) + ")", flush=True)
    t = time.time()
    report["reduced"] = zoo_reduced(smi, dev)
    report["reduced_s"], t = time.time() - t, time.time()
    report["sharded"] = zoo_sharded(smi, dev)
    report["sharded_s"] = time.time() - t
    print(f"zoo: reduced {report['reduced_s']:.1f} s, sharded "
          f"{report['sharded_s']:.1f} s", flush=True)
    after = launch_counts()
    report["launches"] = {"before": list(before), "after": list(after)}
    if after != before:
        fail(f"zoo: kernel launches changed {before} -> {after}")
    return report


# ---------------------------------------------------------------------------
# the enc-dec and VLM families and remat (phase 15): whisper-base and
# internvl2-1b at full width and depth from seeded params (float32 params,
# bfloat16 compute); the dense HVP's peak with remat on and off
EV_ARCHS = ("whisper-base", "internvl2-1b")
EV_SEED = 0
EV_B = 2
# make_batch's seq: whisper's 448 decoder tokens (Whisper's own text
# context) beside its 1,500 frames (the config's frontend_len); internvl2's
# 256 patches and 256 tokens
EV_SEQ = {"encdec": 448, "vlm": 512}
EV_PROMPT = {"encdec": 224, "vlm": 1024}      # the decode checks' prompts
REMAT_ARCH = CURV_ARCH                        # phase 9's loss, B and S
REMAT_REL = CURV_REL                          # remat on vs off, the HVP


def ev_full_width(smi, dev, name):
    """One family at full width: the loss, hvp / ggn / diag with the two
    AD routes (``zoo_curvature``), 3 AdamW steps on ``global_batch_at``'s
    batches, prefill of the frames / patches and a prompt then decode
    steps against the forward at bfloat16 and at float32 compute and
    state (``zoo_decode``); internvl2's text-only engine."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import global_batch_at
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw, warmup_cosine

    t0 = time.time()
    cfg = get_config(name)
    fam = cfg.family
    rep = {"params": cfg.num_params(), "family": fam,
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "frontend_len": cfg.frontend_len}
    print(f"[{smi}] enc-dec / VLM: {name} at full width, "
          f"{cfg.num_params():,} params (float32, compute "
          f"{cfg.compute_dtype}, remat {cfg.remat})", flush=True)
    gen = torch.Generator(device=dev).manual_seed(EV_SEED)
    params = init_params(cfg, gen, device=dev)
    key = "frames" if cfg.frontend == "audio" else "patches"
    batch = make_batch(cfg, EV_B, EV_SEQ[fam], gen, device=dev)
    parts = rep["part_s"] = {}
    t = time.time()
    rep["curvature"] = zoo_curvature(smi, dev, cfg, params, batch)
    rep["curvature"][key] = list(batch[key].shape)
    torch.cuda.empty_cache()
    parts["curvature"], t = time.time() - t, time.time()
    shape = InputShape("train", EV_SEQ[fam], EV_B, "train")
    state, rows = full_width_steps(
        smi, dev, cfg, adamw(warmup_cosine(*TRAIN_LR)), name,
        batch_at=lambda k: global_batch_at(cfg, shape, k, seed=EV_SEED,
                                           device=dev))
    del state
    rep["train"] = {"steps": rows, "step_ms_median": sorted(
        r["ms"] for r in rows)[len(rows) // 2]}
    torch.cuda.empty_cache()
    parts["train"], t = time.time() - t, time.time()
    rep["decode"] = zoo_decode(smi, dev, cfg, params,
                               prompt=EV_PROMPT[fam],
                               front={key: batch[key]}, int8=False)
    del batch
    torch.cuda.empty_cache()
    parts["decode"], t = time.time() - t, time.time()
    if fam == "vlm":                  # text-only, as the reference serves
        rep["engine"], tf_err = zoo_engine(smi, dev, cfg, params,
                                           prompt=EV_PROMPT[fam])
        if tf_err > rep["decode"]["bound"]:
            fail(f"{name} engine: teacher-forced logits off by {tf_err}")
        parts["engine"] = time.time() - t
    rep["s"] = time.time() - t0
    del params
    torch.cuda.empty_cache()
    return rep


def remat_check(smi, dev):
    """Phase 9's dense loss (B = 2 x 512) with cfg.remat off, then on: the
    loss bitwise equal, the pytree HVP within REMAT_REL (normalized), and
    each HVP's peak GB (phase 9 runs remat on, the configs' default)."""
    import dataclasses

    import torch

    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.core import curvature as tc
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.models.targets import lm_curvature_targets

    out = {"arch": REMAT_ARCH, "batch": [CURV_B, CURV_S]}
    base = get_config(REMAT_ARCH)
    gen = torch.Generator(device=dev).manual_seed(CURV_SEED)
    params = init_params(base, gen, device=dev)
    batch = make_batch(base, CURV_B, CURV_S, gen, device=dev)
    v = tc.rademacher_like(1, params)
    got = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        tgt = lm_curvature_targets(cfg, batch)
        plan = engine.plan(tgt.loss, None, csize=1, device=dev,
                           backend="pytree_fwdrev")
        loss = tgt.loss(params).detach()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        hv = plan.hvp(params, v)
        stop.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        tree_finite(hv, f"remat {remat} hvp")
        got[remat] = (loss, hv)
        out["on" if remat else "off"] = {
            "loss": loss.item(), "hvp_ms": start.elapsed_time(stop),
            "hvp_peak_gb": peak}
        print(f"[{smi}] remat {'on' if remat else 'off'}: {REMAT_ARCH} "
              f"B={CURV_B} x S={CURV_S} loss {loss.item():.6f}, hvp "
              f"{start.elapsed_time(stop):.1f} ms (one call), peak "
              f"{peak:.2f} GB", flush=True)
        del hv, plan, tgt
        torch.cuda.empty_cache()
    same = torch.equal(got[False][0], got[True][0])
    # on the card, leaf by leaf: two float64 host copies of 1.8 B-entry
    # trees (tree_nerr) would take ~60 GB of the host's memory
    from torch.utils import _pytree as pt
    num = den = 0.0
    for a, b in zip(pt.tree_leaves(got[True][1]),
                    pt.tree_leaves(got[False][1])):
        num += float(torch.sum((a.double() - b.double()) ** 2))
        den += float(torch.sum(b.double() ** 2))
    err = (num / den) ** 0.5
    out.update(loss_bitwise=same, hvp_nerr=err, bound=REMAT_REL)
    print(f"[{smi}] remat on vs off: loss bitwise equal {same}, hvp "
          f"normalized {err:.3e} (bound {REMAT_REL})", flush=True)
    if not same or err > REMAT_REL:
        fail(f"remat changed the loss ({same}) or the hvp ({err:.3e})")
    return out


def encdec_vlm_phase(smi, dev, launch_counts):
    """Phase 15: the enc-dec and VLM families at full width, and remat
    (see the module docstring)."""
    import torch

    before = launch_counts()
    report = {"card": smi}
    for name in EV_ARCHS:
        torch.cuda.empty_cache()
        report[name] = ev_full_width(smi, dev, name)
        print(f"enc-dec / VLM {name}: {report[name]['s']:.1f} s ("
              + ", ".join(f"{k} {v:.1f}" for k, v in
                          report[name]["part_s"].items()) + ")", flush=True)
    t = time.time()
    report["remat"] = remat_check(smi, dev)
    report["remat_s"] = time.time() - t
    after = launch_counts()
    report["launches"] = {"before": list(before), "after": list(after)}
    if after != before:
        fail(f"enc-dec / VLM: kernel launches changed {before} -> {after}")
    return report


# the dry run (phase 16): launch.dryrun's cells on the fake 16x16 world,
# one arch of each family over the four shapes, in a subprocess (no card),
# the --dir table of its records; then the dry run's counting function
# against this card: phase 10's AdamW step and phase 13's prefill
DRY_ARCHS = ("h2o-danube-1.8b", "granite-moe-1b-a400m", "mamba2-2.7b",
             "zamba2-1.2b", "whisper-base", "internvl2-1b")
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY_JOBS = 8                         # the card's machine has 8 cores
DRY_TIMEOUT = 600
DRY_PEAK_REL = 0.15                  # predicted peak vs the measured one


def dryrun_cells(smi):
    """(a): the cells through ``python -m repro_torch.launch.dryrun`` and
    the table through ``python -m repro_torch.launch.roofline --dir``;
    fatal: a failed process, an error record, a cross-check that does not
    agree, a cell missing."""
    from repro_torch.launch.dryrun import peak_bytes

    out = ROOT / "chiprun_out" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")      # the cells need no card
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", ",".join(DRY_ARCHS), "--shape", ",".join(DRY_SHAPES),
         "--force", "--jobs", str(DRY_JOBS), "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=DRY_TIMEOUT)
    cells_s = time.time() - t0
    (ROOT / "chiprun_out" / "dryrun_torch.log").write_text(
        run.stdout + run.stderr)
    if run.returncode != 0:
        fail(f"dryrun: the cells' process exited {run.returncode}: "
             f"{run.stderr[-2000:]}")
    table = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(out)], env=env, capture_output=True, text=True, timeout=120)
    if table.returncode != 0:
        fail(f"dryrun: the --dir table exited {table.returncode}: "
             f"{table.stderr[-2000:]}")
    print(table.stdout, flush=True)
    recs = {}
    for path in sorted(out.glob("*.json")):
        rec = json.loads(path.read_text())
        recs[rec["cell"]] = rec
    want = {f"{a}__{sh}__pod1" for a in DRY_ARCHS for sh in DRY_SHAPES}
    if set(recs) != want:
        fail(f"dryrun: records {sorted(recs)} != the cells {sorted(want)}")
    cells = {}
    for name, rec in recs.items():
        if rec["status"] == "error":
            fail(f"dryrun: {name}: {rec['error']}")
        if rec["status"] != "ok":
            cells[name] = {"status": rec["status"]}
            continue
        if not rec["probe_check"]["agrees"]:
            fail(f"dryrun: {name}: the probes' cross-check "
                 f"{rec['probe_check']}")
        cells[name] = {
            "status": "ok", "flops": rec["flops_per_device"],
            "bytes": rec["bytes_per_device"],
            "wire": rec["collective_wire_bytes_per_device"],
            "bound": rec["roofline"]["bound"],
            "bound_s": rec["roofline"]["step_time_lower_bound_s"],
            "hbm_gib": peak_bytes(rec["memory"]) / 2 ** 30,
            "useful_flop_ratio": rec["useful_flop_ratio"],
            "trace_s": rec["trace_s"]}
    print(f"[{smi}] dryrun (a): {len(recs)} cells on the fake 16x16 world "
          f"in {cells_s:.1f} s ({DRY_JOBS} processes): "
          f"{sum(c['status'] == 'ok' for c in cells.values())} ok, "
          f"{sum(c['status'] == 'skipped' for c in cells.values())} "
          f"skipped, every cross-check agreeing", flush=True)
    return {"cells": cells, "cells_s": cells_s}


def dryrun_against_card(smi, training, decode):
    """(b): the dry run's counting function (``launch.dryrun.count_cell``,
    mesh-less, meta stand-ins) on phase 10's AdamW step and phase 13's
    bfloat16 prefill, against what those phases measured in this run: the
    predicted peak (argument + temp + output - alias) within DRY_PEAK_REL
    of ``torch.cuda.max_memory_allocated``, the roofline bound at most the
    measured time."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import count_cell, peak_bytes
    from repro_torch.launch.hlo_analysis import PEAK_BF16, roofline_terms

    cfg = get_config(TRAIN_ARCH)
    adamw_rows = training["adamw"]
    bf16 = decode["full_width"]["bf16"]
    cases = {
        "train": (InputShape("card_train", TRAIN_S, TRAIN_B, "train"),
                  max(r["peak_gb"] for r in adamw_rows),
                  min(r["ms"] for r in adamw_rows)),
        "prefill": (InputShape("card_prefill", DEC_PROMPT, DEC_B,
                               "prefill"),
                    bf16["prefill_peak_gb"], bf16["prefill_ms"]),
    }
    report = {}
    for name, (shape, measured_gb, measured_ms) in cases.items():
        t0 = time.time()
        rec = count_cell(cfg, shape, None)
        mem = rec["memory"]
        predicted = peak_bytes(mem) / 1e9
        terms = roofline_terms(rec["flops"], rec["bytes"], rec["wire"],
                               peak_flops=PEAK_BF16)
        bound_ms = terms["step_time_lower_bound_s"] * 1e3
        rel = abs(predicted - measured_gb) / measured_gb
        report[name] = {
            "batch": shape.global_batch, "seq": shape.seq_len,
            "predicted_peak_gb": predicted, "measured_peak_gb": measured_gb,
            "peak_rel_err": rel, "argument_gb":
            mem["argument_size_in_bytes"] / 1e9,
            "temp_gb": mem["temp_size_in_bytes"] / 1e9,
            "flops": rec["flops"], "bytes": rec["bytes"],
            "bound": terms["bound"], "bound_ms": bound_ms,
            "measured_ms": measured_ms, "count_s": time.time() - t0}
        print(f"[{smi}] dryrun (b) {name} ({TRAIN_ARCH}, "
              f"B={shape.global_batch} x S={shape.seq_len}): predicted "
              f"peak {predicted:.2f} GB "
              f"(arguments {mem['argument_size_in_bytes'] / 1e9:.2f} + temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.2f}), measured "
              f"{measured_gb:.2f} GB (rel {rel:.3f}, bound {DRY_PEAK_REL}); "
              f"{rec['flops']:.3e} flops, {rec['bytes']:.3e} bytes, "
              f"bound {bound_ms:.2f} ms ({terms['bound']}) against "
              f"{measured_ms:.2f} ms measured; counted in "
              f"{report[name]['count_s']:.1f} s", flush=True)
        if rel > DRY_PEAK_REL:
            fail(f"dryrun: the {name} peak predicted {predicted:.2f} GB, "
                 f"measured {measured_gb:.2f} GB (rel {rel:.3f})")
        if bound_ms > measured_ms:
            fail(f"dryrun: the {name} bound {bound_ms:.2f} ms exceeds the "
                 f"measured {measured_ms:.2f} ms")
    return report


def dryrun_phase(smi, launch_counts, training, decode):
    """Phase 16: the dry run (see the module docstring)."""
    before = launch_counts()
    report = {"card": smi}
    report.update(dryrun_cells(smi))
    report["card_counts"] = dryrun_against_card(smi, training, decode)
    after = launch_counts()
    report["launches"] = {"before": list(before), "after": list(after)}
    if after != before:
        fail(f"dryrun: kernel launches changed {before} -> {after}")
    return report


def main():
    # phase 9 holds the full-width LM loss's HVP work (64 GB) beside two
    # parameter-sized accumulators on one card: expandable segments keep
    # the allocator's fragmentation from failing that allocation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import engine
    from repro_torch.core import hmath, ref, testfns
    from repro_torch.core.hdual import HDual, seed_point
    from repro_torch.kernels import build
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.kernels.ops import (hdual_linear, hdual_linear_apply,
                                         kernel_form)

    # the tuner's store: a fresh file in the git-ignored output directory
    store = ROOT / "chiprun_out" / "autotune_store.json"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(store)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False      # plain versions: IEEE
    torch.backends.cudnn.allow_tf32 = False
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # 1. toolchain --------------------------------------------------------
    smi = smi_query("name,power.limit")
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    nvcc = build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    print(" ".join(line for line in version.splitlines() if "release" in line))

    # 2. build ------------------------------------------------------------
    t0 = time.time()
    libs = build.build_all()
    print(f"build: {time.time() - t0:.1f} s for {sorted(libs)} ({nvcc} "
          f"-gencode arch=compute_90a,code=sm_90a)")
    for name in sorted(libs):
        for line in ptxas_lines(build.build_log(name)):
            print(f"  {line}")
    hgmma = hgmma_counts(libs["hdual_linear"])
    wgmma_kernels = sorted(k for k in hgmma if "hdual_linear wgmma<" in k)
    print(f"  HGMMA instructions in the SASS: "
          f"{ {k: hgmma[k] for k in wgmma_kernels} }")
    for dname in ("float32", "bfloat16", "float16"):
        inst = [k for k in wgmma_kernels if f"<{dname}," in k]
        if not inst or not all(hgmma[k] for k in inst):
            fail(f"hdual_linear's {dname} tensor-core instantiations "
                 f"{inst} hold no HGMMA instruction")
    sys.stdout.flush()

    max_err = 0.0
    gen = torch.Generator(device=dev)

    @functools.lru_cache(maxsize=None)
    def kernel_args(fname, n):
        kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[fname](n))
        return kf, tuple(c.to(dev) for c in consts), device_fn

    def run_kernel(fname, A, V, csize, symmetric):
        kf, consts, device_fn = kernel_args(fname, A.shape[1])
        return ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                                 device_fn=device_fn, symmetric=symmetric)

    def run_plain(fname, A, V, csize, symmetric):
        kf, consts, _ = kernel_args(fname, A.shape[1])
        return ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)

    def points(seed, m, n, dtype=torch.float32):
        gen.manual_seed(seed)
        A = torch.rand(m, n, generator=gen, device=dev) * 4 - 2
        V = torch.randn(m, n, generator=gen, device=dev)
        return A.to(dtype), V.to(dtype)

    # 3. each kernel against its plain version at the tests' shapes -------
    sweeps = ([(s, torch.float32) for s in CPU_SWEEP + WIDE_SWEEP
               + STAGING_SWEEP]
              + [(s, torch.bfloat16) for s in CPU_SWEEP]
              + [(s, torch.float16) for s in CPU_SWEEP])
    for fname in FUNCTIONS:
        for (m, n, csize), dtype in sweeps:
            if dtype == torch.float16 and fname == "fletcher_powell":
                continue           # its HVPs (~1e5-1e6) overflow float16
            A, V = points(m * 131 + n, m, n, dtype)
            for symmetric in SCHEDULES:
                got = run_kernel(fname, A, V, csize, symmetric)
                if got.dtype != dtype:
                    fail(f"chess_hvp returned {got.dtype} for {dtype}")
                want = run_plain(fname, A, V, csize, symmetric)
                max_err = max(max_err, check_close(
                    got, want, f"{fname} m={m} n={n} csize={csize} "
                    f"symmetric={symmetric} {dtype}"))
    print(f"chess_hvp vs plain, test shapes (float32, bfloat16, float16, "
          f"csize 65-128, around the staging size): ok, max abs err "
          f"{max_err:.3e}", flush=True)

    lin_err = 0.0
    for K2, T, din, dout, bt, bo, bk in LINEAR_SWEEP:
        for dname, dtype in dtypes.items():
            gen.manual_seed(K2)
            x = torch.randn(K2, T, din, generator=gen, device=dev).to(dtype)
            w = torch.randn(din, dout, generator=gen, device=dev).to(dtype)
            tol = LINEAR_TOL[dname]
            lin_err = max(lin_err, check_elementwise(
                hdual_linear(x, w, bt=bt, bo=bo, bk=bk),
                hl.hdual_linear_plain(x, w), tol, tol * din,
                f"hdual_linear {(K2, T, din, dout)} {dname}"))
    print(f"hdual_linear vs plain, reference sweep shapes and tiles: ok, "
          f"max abs err {lin_err:.3e}", flush=True)

    # full-width data, and the plain version on row slices of it (at full
    # width its intermediates, (n, cells, m, 2c+2) floats, would not fit)
    data, cases = {}, {}
    for k, fname in enumerate(FUNCTIONS):
        A, V = data[fname] = points(1000 + k, M, N)
        for symmetric in SCHEDULES:
            csize = engine.model_csize(N, symmetric)
            plain, err = [], 0.0
            for r0 in reversed(row_slices(M)):    # ends on the first slice
                As, Vs = A[r0:r0 + SAMPLE], V[r0:r0 + SAMPLE]
                got = run_kernel(fname, As, Vs, csize, symmetric)
                plain.insert(0, run_plain(fname, As, Vs, csize, symmetric))
                err = max(err, check_close(
                    got, plain[0], f"{fname} rows {r0}:{r0 + SAMPLE} "
                    f"symmetric={symmetric}"))
            max_err = max(max_err, err)
            # float64 oracle on a few instances of the first slice
            f = testfns.FUNCTIONS[fname](N)
            exact = torch.stack([ref.hvp_fwdrev(f, As[i].double(),
                                                Vs[i].double())
                                 for i in range(4)])
            check_close(got[:4].double(), exact, f"{fname} vs float64")
            rel64 = ((got[:4].double() - exact).abs().max()
                     / exact.abs().max()).item()
            cases[(fname, symmetric)] = {
                "csize": csize, "cells": ck.kernel_grid(M, N, csize,
                                                        symmetric, fname)[1],
                "plain_slices": plain, "max_abs_err_sample": err,
                "max_rel_err_float64": rel64,
                "sample_ms": cuda_ms(lambda: run_kernel(
                    fname, As, Vs, csize, symmetric), 3),
                "plain_sample_ms": cuda_ms(lambda: run_plain(
                    fname, As, Vs, csize, symmetric), 3)}
            print(f"{fname} symmetric={symmetric} csize={csize}: rows "
                  f"{row_slices(M)} (+{SAMPLE} each) vs plain max abs err "
                  f"{err:.3e}, vs float64 max rel err {rel64:.3e}",
                  flush=True)

    def zero_counts():
        ck.chess_hvp_cuda.launches = hl.hdual_linear_cuda.launches = 0
        hl.hdual_linear_cuda.launches_by_variant.update(
            dict.fromkeys(hl.VARIANTS, 0))

    # 4. chess_hvp's main path at full width ------------------------------
    zero_counts()
    for fname in FUNCTIONS:
        A, V = data[fname]
        f = testfns.FUNCTIONS[fname](N)
        for symmetric in SCHEDULES:
            p = engine.plan(f, N, m=M, csize="auto", symmetric=symmetric)
            if p.backend_for("batched_hvp") != "cuda":
                fail(f"{p.describe()} resolved batched_hvp to "
                     f"{p.backend_for('batched_hvp')}, not cuda")
            before = ck.chess_hvp_cuda.launches
            out = p.batched_hvp(A, V)
            torch.cuda.synchronize()
            if ck.chess_hvp_cuda.launches != before + 1:
                fail(f"{fname}: batched_hvp did not launch the kernel once")
            if out.shape != (M, N) or not bool(torch.isfinite(out).all()):
                fail(f"{fname}: output not finite or of shape {(M, N)}")
            case = cases[(fname, symmetric)]
            for r0, want in zip(row_slices(M), case.pop("plain_slices")):
                max_err = max(max_err, check_close(
                    out[r0:r0 + SAMPLE], want,
                    f"{fname} main path rows {r0}:{r0 + SAMPLE} vs plain"))
            case["plan"] = p
    launches = ck.chess_hvp_cuda.launches
    if launches != len(cases) or hl.hdual_linear_cuda.launches:
        fail(f"main path launched chess_hvp {launches} times (expected "
             f"{len(cases)}) and hdual_linear "
             f"{hl.hdual_linear_cuda.launches} times (expected 0)")
    print(f"main path: {launches} launches of chess_hvp over "
          f"{len(cases)} batched_hvp calls", flush=True)

    total_ms = total_bound = total_dense = total_plain = total_sample = 0.0
    report = {}
    for (fname, symmetric), case in cases.items():
        A, V = data[fname]
        p = case.pop("plan")
        reps = 2 if fname == "fletcher_powell" else 5
        ms = cuda_ms(lambda: p.batched_hvp(A, V), reps)
        ops, nbytes = ck.needed_work(fname, M, N, case["csize"], symmetric)
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        dense_ops = ck.work(fname, M, N, case["csize"], symmetric)[0]
        dense = max(dense_ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        if bound > ms:
            fail(f"{fname} symmetric={symmetric}: {ms:.3f} ms beats the "
                 f"needed bound {bound:.3f} ms")
        total_ms += ms
        total_bound += bound
        total_dense += dense
        total_plain += case["plain_sample_ms"]
        total_sample += case["sample_ms"]
        key = f"{fname}/{'symmetric' if symmetric else 'full'}"
        report[key] = dict(case, ms=ms, us_per_instance=ms * 1e3 / M,
                           bound_ms=bound, fp32_ops=ops, bytes=nbytes,
                           share=bound / ms, dense_bound_ms=dense,
                           dense_fp32_ops=dense_ops)
        print(f"{key}: {ms:.3f} ms per call, {ms * 1e3 / M:.5f} us per "
              f"instance, needed bound {bound:.3f} ms ({ops:.4e} fp32 ops, "
              f"{100 * bound / ms:.1f}%), dense bound {dense:.3f} ms, "
              f"{SAMPLE}-row sample: kernel {case['sample_ms']:.3f} ms, "
              f"plain {case['plain_sample_ms']:.3f} ms", flush=True)

    # the repairs through the same path: bfloat16 A and V, and chunks wider
    # than 64 lanes resolved by backend="auto"
    repairs = {}
    bf16_runs = [(fname, N, engine.model_csize(N, symmetric), symmetric, M,
                  torch.bfloat16) for fname, symmetric in BF16_CASES]
    wide_runs = [(fname, n, csize, symmetric, M_WIDE, torch.float32)
                 for fname, n, csize, symmetric in WIDE_CASES]
    for k, (fname, n, csize, symmetric, m, dtype) in enumerate(
            bf16_runs + wide_runs):
        A, V = points(2000 + k, m, n, dtype)
        f = testfns.FUNCTIONS[fname](n)
        p = engine.plan(f, n, m=m, csize=csize, symmetric=symmetric)
        if p.backend_for("batched_hvp") != "cuda":
            fail(f"{p.describe()} resolved to {p.backend_for('batched_hvp')}")
        before = ck.chess_hvp_cuda.launches
        out = p.batched_hvp(A, V)
        torch.cuda.synchronize()
        if ck.chess_hvp_cuda.launches != before + 1:
            fail(f"{p.describe()}: the kernel was not launched once")
        if out.dtype != dtype or not bool(torch.isfinite(out).all()):
            fail(f"{p.describe()}: output not finite or not {dtype}")
        err = 0.0
        for r0 in row_slices(m):
            As, Vs = A[r0:r0 + SAMPLE], V[r0:r0 + SAMPLE]
            err = max(err, check_close(
                out[r0:r0 + SAMPLE], run_plain(fname, As, Vs, csize,
                                               symmetric),
                f"{p.describe()} rows {r0}:{r0 + SAMPLE}"))
            torch.cuda.empty_cache()
        max_err = max(max_err, err)
        reps = 1 if fname == "fletcher_powell" else 3
        ms = cuda_ms(lambda: p.batched_hvp(A, V), reps)
        ops, nbytes = ck.needed_work(fname, m, n, csize, symmetric,
                                     itemsize=A.element_size())
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        dense = max(ck.work(fname, m, n, csize, symmetric)[0] / PEAK_FP32,
                    nbytes / PEAK_BYTES) * 1e3
        key = (f"{fname}/{'symmetric' if symmetric else 'full'}/n={n}/"
               f"csize={csize}/m={m}/{str(dtype).split('.')[-1]}")
        if bound > ms:
            fail(f"{key}: {ms:.3f} ms beats the needed bound {bound:.3f} ms")
        repairs[key] = {"ms": ms, "bound_ms": bound, "fp32_ops": ops,
                        "share": bound / ms, "dense_bound_ms": dense,
                        "bytes": nbytes, "max_abs_err_sample": err,
                        "sub_cells": len(ck.sub_cells(n, csize,
                                                      symmetric)[0])}
        print(f"{key}: backend cuda, {ms:.3f} ms per call, needed bound "
              f"{bound:.3f} ms ({100 * bound / ms:.1f}%), dense bound "
              f"{dense:.3f} ms, rows {row_slices(m)} vs plain max abs err "
              f"{err:.3e}", flush=True)

    # 5. hdual_linear's path at full width --------------------------------
    del data
    torch.cuda.empty_cache()

    def hdual_points(seed, c, T, din, dout, dtype):
        gen.manual_seed(seed)
        comps = [torch.randn(*shape, generator=gen, device=dev).to(dtype)
                 for shape in ((T, din), (T, din), (T, din, c), (T, din, c))]
        w = (torch.randn(din, dout, generator=gen, device=dev)
             / din ** 0.5).to(dtype)
        return HDual(*comps), w

    def stacked(hd):
        return torch.cat([hd.val[None], hd.di[None], hd.dj.movedim(-1, 0),
                          hd.dij.movedim(-1, 0)], dim=0)

    zero_counts()
    lin_cases = {}
    by_variant = hl.hdual_linear_cuda.launches_by_variant
    for k, (name, c, T, din, dout, dname) in enumerate(LINEAR_CASES):
        hd, w = hdual_points(3000 + k, c, T, din, dout, dtypes[dname])
        before = hl.hdual_linear_cuda.launches
        before_wgmma = by_variant["wgmma"]
        out = hdual_linear_apply(hd, w)
        torch.cuda.synchronize()
        if hl.hdual_linear_cuda.launches != before + 1:
            fail(f"hdual_linear_apply {name} did not launch the kernel once")
        if by_variant["wgmma"] != before_wgmma + 1:
            fail(f"hdual_linear_apply {name} {dname} did not run on the "
                 f"wgmma variant ({by_variant})")
        if not all(t.is_contiguous() for t in (out.val, out.di, out.dj,
                                                out.dij)):
            fail(f"hdual_linear_apply {name}: outputs not contiguous")
        if out.shape != (T, dout) or out.csize != c:
            fail(f"hdual_linear_apply {name}: value shape {out.shape}")
        x, y = stacked(hd), stacked(out)
        want = hl.hdual_linear_plain(x, w)
        rtol = FULL_RTOL[dname]
        atol = FULL_ATOL * (1.0 + want.abs().max().item())
        err = check_elementwise(y, want, rtol, atol,
                                f"hdual_linear {name} {dname}")
        # the bound has teeth: it rejects an all-zero output and, in
        # float32, the product a TF32 kernel would give on these inputs
        controls = {"zeros": torch.zeros_like(want[0])}
        if dname == "float32":
            controls["tf32"] = hl.hdual_linear_plain(tf32(x[:1]),
                                                     tf32(w))[0]
        for what, bad in controls.items():
            if within(bad, want[0], rtol, atol)[0]:
                fail(f"hdual_linear {name} {dname}: the check passes a "
                     f"{what} output (rtol {rtol}, atol {atol:.3e})")
        lin_cases[(name, dname)] = (hd, w, x, err, rtol, atol, list(controls))
        del want, controls
    lin_launches = hl.hdual_linear_cuda.launches
    if (lin_launches != len(LINEAR_CASES) or ck.chess_hvp_cuda.launches
            or by_variant != {"simt": 0, "wgmma": len(LINEAR_CASES)}):
        fail(f"hdual_linear path launched hdual_linear {lin_launches} times "
             f"({by_variant}; expected {len(LINEAR_CASES)}, all wgmma) and "
             f"chess_hvp {ck.chess_hvp_cuda.launches} times (expected 0)")
    print(f"hdual_linear path: {lin_launches} launches over "
          f"{len(LINEAR_CASES)} hdual_linear_apply calls, by variant "
          f"{by_variant}", flush=True)

    clocks = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    print(f"before the hdual_linear timings: {clocks} = {smi_query(clocks)}",
          flush=True)
    lin_report = {}
    lin_tot = dict.fromkeys(("ms", "apply_ms", "simt_ms", "plain_ms",
                             "bound_ms", "ffma_bound_ms", "library_ms"), 0.0)
    bound_by_ms = {"bytes": 0.0, "operations": 0.0}
    for (name, c, T, din, dout, dname) in LINEAR_CASES:
        hd, w, x, err, rtol, atol, rejected = lin_cases.pop((name, dname))
        K2 = 2 * c + 2
        before = dict(by_variant)
        apply_ms = cuda_ms(lambda: hdual_linear_apply(hd, w), 5)
        ms = cuda_ms(lambda: hdual_linear(x, w), 5)
        simt_ms = cuda_ms(lambda: hl.hdual_linear_cuda(x, w, variant="simt"),
                          3)
        if by_variant != {"simt": before["simt"] + 3 + 1,
                          "wgmma": before["wgmma"] + 2 * (5 + 1)}:
            fail(f"hdual_linear {name}: not one launch per call "
                 f"({before} -> {by_variant})")
        plain_ms = cuda_ms(lambda: hl.hdual_linear_plain(x, w), 3)
        x2 = x.reshape(K2 * T, din)
        library_ms = cuda_ms(lambda: torch.matmul(x2, w), 5)
        ops, nbytes = hl.work(K2, T, din, dout, x.element_size())
        bound, bound_by, ffma_bound = linear_bound(ops, nbytes, dname)
        key = f"{name}/{dname}"
        lin_report[key] = {
            "K2": K2, "T": T, "din": din, "dout": dout, "ms": ms,
            "apply_ms": apply_ms, "simt_ms": simt_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": bound_by, "ffma_bound_ms": ffma_bound, "ops": ops,
            "bytes": nbytes, "max_abs_err": err, "rtol": rtol, "atol": atol,
            "controls_rejected": rejected}
        for field in lin_tot:
            lin_tot[field] += lin_report[key][field]
        bound_by_ms[bound_by] += bound
        lin_err = max(lin_err, err)
        print(f"hdual_linear {key} (K2={K2}, T={T}, {din}x{dout}): kernel "
              f"(wgmma) {ms:.3f} ms, hdual_linear_apply {apply_ms:.3f} ms, "
              f"simt variant {simt_ms:.3f} ms, bound {bound:.3f} ms "
              f"({bound_by}; FFMA-only {ffma_bound:.3f} ms), plain "
              f"{plain_ms:.3f} ms, torch.matmul {library_ms:.3f} ms, max abs "
              f"err {err:.3e} (rtol {rtol}, atol {atol:.3e}; rejects "
              f"{' and '.join(rejected)})", flush=True)
        del hd, w, x, x2
        torch.cuda.empty_cache()

    print(f"after the hdual_linear timings: {clocks} = {smi_query(clocks)}",
          flush=True)

    # 6. the network check: the reference test's use of the entry point,
    # sin(x W1) then . W2, with one (row, chunk) cell seeded at T points
    n, hidden, T, c, row, cstart = N, 2560, 4096, 4, 5, 8
    gen.manual_seed(4000)
    W1 = torch.randn(n, hidden, generator=gen, device=dev) / n ** 0.5
    W2 = torch.randn(hidden, 1, generator=gen, device=dev) / hidden ** 0.5
    a = torch.randn(T, n, generator=gen, device=dev)
    y = seed_point(a.T, row, cstart, c)         # value shape (n, T)
    y = HDual(y.val.T, y.di.T, y.dj.movedim(0, 1), y.dij.movedim(0, 1))
    before = hl.hdual_linear_cuda.launches
    z = hmath.sin(hdual_linear_apply(y, W1))
    out = z.sum(-1) + hdual_linear_apply(z, W2)[:, 0]
    torch.cuda.synchronize()
    if hl.hdual_linear_cuda.launches != before + 2:
        fail("network: hdual_linear_apply did not launch twice")
    if out.dij.shape != (T, c) or not bool(torch.isfinite(out.dij).all()):
        fail("network: Hessian chunk not finite or of shape (T, c)")

    def net(p):
        h = torch.sin(p @ W1.double())
        return h.sum() + (h @ W2.double())[0]

    net_err = 0.0
    for t in (0, T // 2, T - 1):
        H = torch.func.hessian(net)(a[t].double())
        want = H[row, cstart:cstart + c]
        diff = (out.dij[t].double() - want).abs()
        if not bool((diff <= 1e-4 + 1e-3 * want.abs()).all()):
            fail(f"network: point {t} Hessian chunk off by "
                 f"{diff.max().item():.3e} (rtol 1e-3, atol 1e-4)")
        net_err = max(net_err, diff.max().item())
    print(f"network sin(x W1) . W2 (n={n}, hidden={hidden}, T={T}, c={c}): "
          f"H[{row}, {cstart}:{cstart + c}] vs float64 torch.func.hessian "
          f"max abs err {net_err:.3e}", flush=True)

    # 7. the tuner on the card -------------------------------------------
    del W1, W2, a, y, z, out
    torch.cuda.empty_cache()
    t_tune = time.time()
    tuning = tune_phase(smi, dev, zero_counts, points)
    print(f"tuning: {time.time() - t_tune:.1f} s", flush=True)
    # phase 8 is measured as PR 18 measured it: no tuned record or
    # telemetry of this phase answers its plans
    engine.clear_autotune_cache()
    engine.clear_telemetry()
    torch.cuda.empty_cache()

    # 8. the served path --------------------------------------------------
    t_serve = time.time()
    serving = serve_phase(smi, dev, zero_counts)
    print(f"served path: {time.time() - t_serve:.1f} s", flush=True)

    # 9. pytree curvature on the full-width LM loss -----------------------
    engine.clear_telemetry()
    torch.cuda.empty_cache()
    t_curv = time.time()
    curvature = curvature_phase(
        smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                           hl.hdual_linear_cuda.launches))
    kv_spectrum = curvature.pop("kv_spectrum")
    print(f"curvature: {time.time() - t_curv:.1f} s", flush=True)

    # 10. optim and training on the full-width LM -------------------------
    torch.cuda.empty_cache()
    t_train = time.time()
    training = training_phase(
        smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                           hl.hdual_linear_cuda.launches))
    print(f"training: {time.time() - t_train:.1f} s", flush=True)

    # 11. CHESSFAD across devices: an NCCL DeviceMesh of one card ---------
    torch.cuda.empty_cache()
    t_dist = time.time()
    distributed = distributed_phase(
        smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                           hl.hdual_linear_cuda.launches))
    print(f"distributed: {time.time() - t_dist:.1f} s", flush=True)

    # 12. the trainer across devices: an NCCL DeviceMesh of one card ------
    torch.cuda.empty_cache()
    t_mesh = time.time()
    mesh_training = mesh_training_phase(
        smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                           hl.hdual_linear_cuda.launches))
    print(f"mesh training: {time.time() - t_mesh:.1f} s", flush=True)

    # 13. LM decode on the full-width model -------------------------------
    torch.cuda.empty_cache()
    t_dec = time.time()
    decode = decode_phase(
        smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                           hl.hdual_linear_cuda.launches), kv_spectrum)
    decode["phase_s"] = time.time() - t_dec
    print(f"decode: {decode['phase_s']:.1f} s", flush=True)

    # 14. the MoE, SSM and hybrid families at full width ------------------
    torch.cuda.empty_cache()
    t_zoo = time.time()
    zoo = zoo_phase(smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                                       hl.hdual_linear_cuda.launches))
    zoo["phase_s"] = time.time() - t_zoo
    print(f"zoo: {zoo['phase_s']:.1f} s", flush=True)

    # 15. the enc-dec and VLM families at full width, and remat -----------
    torch.cuda.empty_cache()
    t_ev = time.time()
    zoo["encdec_vlm"] = encdec_vlm_phase(
        smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                           hl.hdual_linear_cuda.launches))
    zoo["encdec_vlm"]["phase_s"] = time.time() - t_ev
    print(f"enc-dec / VLM: {zoo['encdec_vlm']['phase_s']:.1f} s",
          flush=True)

    # 16. the dry run: the cells on fake tensors, and its counts here ----
    t_dry = time.time()
    dryrun = dryrun_phase(smi, lambda: (ck.chess_hvp_cuda.launches,
                                        hl.hdual_linear_cuda.launches),
                          training, decode)
    dryrun["phase_s"] = time.time() - t_dry
    print(f"dry run: {dryrun['phase_s']:.1f} s", flush=True)

    # 17. results ---------------------------------------------------------
    print(json.dumps({"dryrun": dryrun}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"curvature": curvature}))
    print(json.dumps({"training": training}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"mesh_training": mesh_training}))
    print(json.dumps({"decode": decode}))
    print(json.dumps({"kernels": [{
        "name": "chess_hvp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chess_hvp.cu",
        "replaces": "src/repro/kernels/chess_hvp.py:158",
        "launches": launches, "max_abs_err": max_err,
        "ms": total_ms, "plain_ms": total_plain, "bound_ms": total_bound,
        "bound_by": "operations", "library_ms": None,
        "dense_bound_ms": total_dense,
        "sample_rows": SAMPLE, "sample_ms": total_sample,
        "shape": {"m": M, "n": N}, "cases": report, "repairs": repairs,
        "tuning": tuning, "serving": serving}, {
        "name": "hdual_linear", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hdual_linear.cu",
        "replaces": "src/repro/kernels/hdual_linear.py:44",
        "launches": lin_launches, "max_abs_err": lin_err,
        "ms": lin_tot["ms"], "plain_ms": lin_tot["plain_ms"],
        "bound_ms": lin_tot["bound_ms"],
        "bound_by": max(bound_by_ms, key=bound_by_ms.get),
        "library_ms": lin_tot["library_ms"],
        "apply_ms": lin_tot["apply_ms"], "simt_ms": lin_tot["simt_ms"],
        "ffma_bound_ms": lin_tot["ffma_bound_ms"],
        "launches_by_variant": {"wgmma": lin_launches, "simt": 0},
        "hgmma_in_sass": {k: hgmma[k] for k in wgmma_kernels},
        "cases": lin_report, "network_max_abs_err": net_err}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
