#!/usr/bin/env python3
"""Drive the PyTorch port (ctr_recommendation_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line.

1. Print the card's name and power limit (nvidia-smi), build the five
   kernels from csrc/ with nvcc for sm_90a, one nvcc per source in parallel,
   and beside them the native submission writer (data/native/submission.cc,
   g++); fail if that writer does not build and load, so that the pipelines
   below write their CSV and zip natively.
2. With TF32 off, hold each kernel against its plain PyTorch version at full
   width: the interaction forward and the fused scoring kernel at the
   training batch 4096, the serving batch 8192 and each plus a ragged 37
   (F=6, E=128, tower 2688->512->256->1), the forward's repeat launch
   bit-identical and in bf16 also within FWD_NORM_TOL in norm, which a
   control taking V unrounded into the pair products must fail; the same
   at F=12, E=64 (B=4133, 8229); the interaction backward at
   B=4096 and 4096+37, with SENet biases on and off, its repeat launch
   bit-identical, and in bf16 the same bar rejecting a control taken at the
   forward's rounding points. "all" and "each", bf16 and fp32. The SASRec
   encoder forward at full width (E=128, H=2, S=20, L=1; B=4096, 8192,
   8192+37) and at E=64, H=4, L=2, B=4133, bf16 and fp32, histories of
   random pad lengths: within ENC_TOL (and ENC_NORM_TOL in bf16), the pad
   rows of fused_encode exactly 0, and in bf16 the jnp rounding points
   (attention.encode) rejected by the same norm bar. The same cases with
   dropout 0.1 under two seeds against encode_fwd_plain with the same
   seeds, rate 0 bit-identical to the eval launch, and the kernel's own
   mask read back equal to dropout_mask with its kept share within 6 sigma;
   the same mask read back at a data-parallel rank's token base (phase 6h
   (d): 2048 x 20, and across the 2^32 wrap) bit for bit dropout_mask's
   there, and the back half of a batch at its token base, forward and dx,
   bit for bit the whole batch's rows (the forward also within ENC_TOL of
   encode_fwd_plain at that base).
   The encoder backward at E=128, H=2, L=1 (B=4096, 4133) and E=64, H=4,
   L=2 (B=4133), rate 0 and 0.1, bf16 and fp32: within ENC_BWD_TOL and the
   norm bars, its repeat bit-identical, and in bf16 the fp32-operand
   control rejected. At the JAX recipe sweep's wider widths, with the same
   bars: the interaction forward and the scoring kernel at E=256 (B=4096,
   4133, 8192, 8229), the scoring kernel at the towers (1024, 512) and
   (768, 384) at E=128 and 256 (B=4133, 8192), the interaction backward at
   E=256 (B=4096, 4133, biases on and off, repeat bit-identical, the
   forward-rounding control rejected); "all" and "each", bf16 and fp32.
   Beside every scoring case, each block of the scoring call
   (ops/cuda/scoring.py) against its plain version on the plain version's
   inputs: the front's concat in cd (within TOL["interaction_fwd"], in bf16
   FWD_NORM_TOL, and bit for bit the interaction kernel's output in cd),
   both tower layers (the tile product with its ReLU epilogue, within
   ENC_TOL and the bf16 norm bar) and the head (within TOL["fused_score"]).
   The encoder at E=256 with the same bars and controls: the forward at
   H=2, L=1 (B=8192, 8229) and H=4, L=2 (B=4133), with and without
   dropout; the backward at H=2, L=1 (B=4096, 4133), rate 0 and 0.1. Then
   each building block of the encoder kernels (encoder_blocks: the tile
   product in its six uses, LayerNorm and its backward, attention and its
   backward, the column sums, the partial reduction) against its plain
   version at full width, E=128 and 256, bf16 and fp32. Then each building
   block of the interaction forward (the gate, V = cd(sc W), the pairs) at
   E=128 and 256 (F=6) and E=64 (F=12),
   "all" and "each", bf16 and fp32, B=8229: within TOL["interaction_fwd"]
   (and FWD_NORM_TOL in bf16), each block's repeat launch bit-identical;
   and each building block of the interaction backward (the gate, V = sc W,
   the pairs, the projection term dvc W^T, the gate backward and dx, dW_bi's
   split partials, the reduction) at the same widths, B=4133: within
   BWD_TOL (and BWD_NORM_TOL in bf16), each block's repeat launch
   bit-identical.
3. Time each kernel and its plain version with CUDA events (median of 30
   after warm-up) beside the bound the card sets for the same work; for the
   encoder also nn.TransformerEncoderLayer (the library yardstick, checked
   against the plain version in fp32 first): its forward, and for the
   backward its forward + backward minus its forward, at E=128 and E=256,
   and torch.profiler's split of one encoder call into its kernels. Also,
   in bf16, the interaction kernels at E=256 and the scoring kernel at
   E=256 with (512, 256) and (1024, 512) and at E=128 with (1024, 512).
   At each of those four widths one scoring call is split into its four
   blocks (CUDA events a block, torch.profiler over the call), with cuBLAS
   on layer 1's product alone (c @ W1, bf16) beside it as a yardstick. One
   interaction forward call ("all", B=8192) at E=128 and 256 split the same
   way into its three blocks, and one backward call ("all", B=4096) into its
   seven; the backward's plain time both as the blocks' plain versions
   composed (plain_ms) and as the single expression interaction_bwd_expr.
4. The serving main path at the full microlens_experiment() defaults
   (mm_fibinet, E=128, item vocab 91718, max_len 20, hidden (512, 256),
   bf16): seeded weights with perturbed BatchNorm stats, a seeded item
   store, 385,024 rows (47 x 8192) made with numpy; Predictor.score_table,
   then run_submission_pipeline from numpy chunks. Checks the CSV, the exact
   agreement of the two paths, the CSV's bytes against the Python writer's
   for score_table's probabilities (two writers, one expected byte string),
   the zip read back, the first 8192 rows against the same Predictor on the
   CPU, and the scoring call's launches on each path (score_launches() a
   batch). Times the host stages: wire pack, and the native CSV writer the
   pipeline uses with the Python writer beside it.
5. The unfused branch (fold_bn=False) for a few batches: the interaction
   forward runs (fwd_launches() a batch) and agrees with the fused branch. Then the sasrec_fibinet
   serving path at its full defaults (E=128, S=20, 2 heads, 1 layer, hidden
   (512, 256), bf16) on the same item store and rows: score_table and the
   pipeline with exactly fwd_launches(1) encoder and score_launches()
   scoring launches a batch, the CSV identical to score_table and its
   bytes the Python writer's, the encoder's share of one batch, the CPU
   Predictor on the first 8192 rows, and 4 unfused batches (encoder +
   interaction kernel) against the fused branch.
6. The training main path at the same full defaults (batch 4096, Adam + L2,
   OneCycle, clip 10, dropout 0.2, bf16 with fp32 master weights) on the
   port's high-signal synthetic data (91,717 items; 262,144 train and
   32,768 valid rows): one step's gradients through the kernels against the
   plain path in fp32, then Trainer.fit_on_device for 2 epochs (128 steps):
   loss finite and falling, best valid AUC > 0.6, exact launch counts of
   both interaction kernels (fwd_launches() and bwd_launches() a step), a
   resume point and the best export written;
   examples/s per epoch and one step split into forward+loss, backward and
   optimizer with CUDA events, then torch.profiler over three more steps
   (device-busy share, kernels a step, the largest device items).
6h. Data-parallel training (parallel/, the Trainer over a process group)
   at the same full defaults, two ranks sharing cuda:0 over gloo (NCCL
   refuses two ranks on one device), each a process started with
   --dp-rank and the launcher's environment, killed past DP_TIMEOUT_S; a
   rank that fails fails the phase. (a) One fp32 step (dropout 0.2 on),
   2 x 2048 rows against one process's step on the same 4096 rows and
   seeded weights, the one process's ReLU and dropout gates replayed on
   each rank's rows: the loss within 1e-5, every gradient within GRAD_TOL
   / GRAD_FLOOR (each flip within GATE_MARGIN), the BatchNorm running
   statistics within DP_STATE_TOL, the parameters after the update within
   DP_PARAM_TOL where the gradients fix Adam's step (2 lr elsewhere), the
   two replicas bit for bit equal, exactly fwd_launches() + bwd_launches()
   interaction launches a rank. (b) fit_on_device on two ranks over
   phase 6's splits, 2 epochs, the global batch 4096: exact launches a
   rank, both ranks' metrics equal, loss falling, best valid AUC within
   DP_AUC_TOL of phase 6's, rank 0's export and resume point; per rank
   examples/s, a step's wall, the gradient all-reduce's ms and bytes and
   the collectives a step (2 ranks sharing one card: not a scaling
   figure). (c) One rank on NCCL, world 1: the step of (a) within the same
   bars, its collectives run on the card. (d) is in phase 2.
6i. Row-sharded tables (parallel/embedding.py, model_parallel 2) at the
   same full defaults, the ranks sharing cuda:0 over gloo as in 6h (every
   exchange staged through host memory), spawned as in 6h. (a) One fp32
   step (dropout 0.2 on, grad_clip_norm MP_CLIP so that the clip scales
   every gradient) on the same 4096 rows and seeded weights as one
   process, at 1 x 2 (two ranks) and 2 x 2 (four): the tables' gradients,
   clipped gradients and updated parameters put together from the model
   ranks' shards, then held as in 6h (a) (loss within 1e-5, GRAD_TOL /
   GRAD_FLOOR with the 1-process gates replayed, DP_PARAM_TOL); the
   replicated leaves bit for bit equal on all ranks, each shard across its
   data group; fwd_launches() + bwd_launches() interaction launches a
   rank. At 1 x 2 also a lazy adam step (table_optimizer "adam") for each
   forced strategy against one process's: every row of the tables and of
   the moments one process left alone bit for bit, the others within 2 lr,
   the gradients within GRAD_TOL / GRAD_FLOOR.
   (b) fit_on_device at 1 x 2 on phase 6's splits, 2 epochs, the
   global batch 4096: exact launches a rank, both ranks' metrics equal,
   loss falling, best valid AUC within DP_AUC_TOL of phase 6's; world rank
   0 alone writes; its export holds whole tables and serves in this
   process through Predictor on the fused scoring kernel (within
   AUC_SERVE_TOL of the fit's best) and through a one-process Trainer's
   eval (within 1e-6); per rank examples/s, a step's wall, the exchange's
   collectives and bytes a step, and a step's lookups alone, each method,
   forward and backward ms and bytes (two ranks sharing one card: not a
   scaling figure). (c) The lookup alone at 1 x 2: the 91,776 x 128 fp32
   item table and a 4096-row batch's item_id and item_seq ids (86,016),
   each method bit for bit table[ids], then ids all in shard 0 at capacity
   factor MP_SKEW_CAPACITY through the fallback, bit for bit; each
   method's ms; exchange_stats of phase 6's first batch.
7. Serve the trained export through the evaluate CLI's function
   (cli/evaluate.py::evaluate: Predictor with the fused scoring kernel, then
   AUC, logloss and gAUC[user_id] on the card) on the valid split: its AUC
   equals the AUC of its probabilities on the CPU and the trainer's best
   within 2e-3, its logloss is finite, its gAUC within GAUC_TOL of
   group_auc on the CPU over the same probabilities; prints the [eval] line.
6b. Phases 6-7 for sasrec_fibinet (attn_dropout 0.1 as well): both
   encoder kernels in the gradient check (dropout on: the kernels and the
   plain path draw the same masks) and in the exact launch counts, its
   export served through the encoder and scoring kernels.
7b. Online serving over HTTP (serving/: RequestCollator, MicroBatcher,
   ScoringService, make_http_server) of phase 7's mm_fibinet export and
   phase 6b's sasrec_fibinet export, on the fused scoring kernel (and the
   encoder forward). mm_fibinet at DEFAULT_BUCKETS (16 to 8192 rows),
   max_wait_ms 2: warmup timed, exactly 6 buckets x 2 structures x
   score_launches() launches; the valid split as JSON rows without the
   dense column in requests of 8192, bit for bit score_table's, its AUC
   phase 7's; ragged requests of 1, 15, 17, 63, 255, 1023 and 4097 rows
   within TOL["fused_score"] of score_table, repeats bit-identical; the
   same rows with item_emb_d128 shipped by the client bit for bit the
   join's scores; an out-of-range item_id sent beside four well-formed
   requests gets 400, they 200. Latency a bucket (one client, sequential,
   30 full requests, 10 at 4096 and 8192): p50 and p99 end to end, the
   batcher's validate + collate and the JSON on the path (host clock), the
   predictor call's device ms (CUDA events). Load: 16 clients x 16
   requests of 1-64 seeded rows: requests/s, rows/s, p50, p99, requests a
   dispatch; some dispatch coalesced, launches exactly batches_dispatched x
   score_launches(), each response within the bar of score_table. For each
   bucket, rows scored alone against the same rows in a B=8192 batch:
   whether the trunk's output and the kernel's scores depend on B. Then
   sasrec_fibinet at buckets (16, 256, 8192): fwd_launches(1) encoder and
   score_launches() scoring launches a warmup call and a dispatch, whole
   buckets bit for bit score_table's with phase 6b's AUC, ragged requests
   within the bar.
7c. After phase 7, at the same full defaults: (a) Trainer.profile_epoch
   on phase 6's train split (64 steps an epoch, an untraced epoch then a
   traced one): exactly 2 x 64 x fwd_launches() interaction_fwd and
   2 x 64 x bwd_launches() interaction_bwd launches, state.step 128, no
   metrics.csv, one trace file (rank0.pt.trace.json) of valid JSON whose
   hand-written kernels (the ctr:: namespace) ran exactly one epoch's
   launches; the traced epoch's wall, device-busy share and ten longest
   device operations (profiled again, 3 tries, when a trace holds no
   device event). (b) A seeded reference-format MM_FiBiNET state_dict at
   full width (item_emb 91,718 x 128, cate_emb 11 x 128, user_emb 20,000 x
   128, mm_proj, senet.excitation, bilinear.W, mlp.{0,1,4,5,8} with
   running statistics), DataParallel-prefixed, through
   tools/torch_import.import_state_dict: every imported leaf its tensor,
   transposed where due; served through Predictor.score_table on phase 4's
   rows, score_launches() launches a batch, within TOL["fused_score"] of
   the scoring kernel's plain version on the same inputs. (c)
   HashTextEncoder over 91,718 seeded item texts on the host (timed),
   pca_project to 128 dims on the card within PCA_TOL of float64 numpy and
   of the port's CPU run (card ms beside numpy s); set_seed's generator on
   the card, and whether ScalarWriter is active on this machine.
6d. Phases 6-7 for sasrec_emb_256 (sasrec_fibinet with embedding_dim=256,
   its other defaults): both encoder kernels at E=256 in the gradient
   check and the exact launch counts, the export served through them.
6c. Phases 6-7 for emb_256_tower1024, the recipe sweep's widest mm_fibinet
   (E=256, tower (1024, 512)): the interaction kernels at E=256 in the
   gradient check and the exact launch counts, the export served through
   the scoring kernel at that tower.
6e. The sparse tables (training/sparse.py) at the full defaults on phase
   6's splits. One fp32 step (weight decay 0) for each table optimizer
   (adagrad on the dense adagrad chain at the shared lr, rowwise_adagrad,
   lazy adam) under each strategy, forced through
   sparse.GATHERED_MIN_VOCAB_RATIO: the loss, dense and row gradients
   through the kernels against the plain path; remap_batch and the update
   under torch.cuda.set_sync_debug_mode("error"); every untouched row of
   each table and of its state bit for bit unchanged; each table's update
   timed beside its byte floor (the touched rows' gradient, table and
   state rows read once, table and state rows written once, at 3.35 TB/s)
   and, gathered, remap_batch. Then gathered vs masked-dense, and sparse
   adagrad vs the dense adagrad chain on the tables, within SPARSE_TOL.
   Then phases 6-7 for mm_fibinet_rowwise_adagrad (the defaults with
   rowwise_adagrad: both tables masked-dense) and
   mm_fibinet_lazy_adam_b1024 (adam at batch 1024: the item table
   gathered), and each beside the dense mm_fibinet run: best valid AUC,
   examples/s, a step's wall and device-busy ms.
6f. Host-driven training (Trainer.fit) at the full defaults on phase 6's
   splits, fed numpy batches (the card's machine has no pyarrow): first the
   wire, each slice of the first widened chunk of 8 bit for bit put_batch
   of its numpy batch (split24 item ids, uint8 labels and categoricals);
   the feed at 8 giving every step of both epochs the feed at 1's batch,
   bit for bit (check_feeds); the shared likes_level table's merged
   embedding backward run 10 times on fixed inputs (is it reproducible?);
   then fit over iter_batches for 2 epochs at 1 batch an upload, again at
   1 (the repeat sets the bar: its own gap, at least FIT_METRIC_FLOOR, as
   the card's step is not bit-reproducible), and at 8: per-epoch train
   loss and valid AUC of 8 within that bar of 1, best valid AUC > 0.6 and
   within FIT_AUC_TOL of phase 6's, loss falling, exact launch counts, a
   resume point and the best export. The host item join (strict_items, no
   item store on the trainer): the first step's loss bit for bit the
   device join's, a fit of a few steps, an unknown item_id raising through
   fit. sasrec_fibinet through fit for 16 steps (the encoder kernels'
   exact launches). Labels turned soft halfway through an epoch: the run
   completes, logs "widening", takes every step. The stream window
   (data/streaming.window_batches) fed the train split cut into numpy row
   groups, host 0 of 2, shuffled: one epoch of fit, its batches covering
   the host's rows once. predict --stream's path: Predictor.predict_all
   over the unshuffled window of phase 4's rows in batches of 8192, equal
   to score_table's probabilities, its CSV's bytes the Python writer's,
   score_launches() a batch. Timing: examples/s a epoch of fit at 1 and 8
   beside fit_on_device's; the host's parts alone a batch (assembly,
   upload); a step's wall (host clock over 24 steps) and device-busy ms
   (torch.profiler over 24 more) fed uploads made beforehand, fed by fit's
   prefetch threads at 1 and 8 (with the time it waits for the feed), and
   of fit_on_device's loop; whether the side stream's host-to-device
   copies overlap the kernels in that trace.
6g. The model zoo (din, xdeepfm, finalmlp, dcnv2, deepfm, autoint,
   masknet, pnn, dlrm) at the full microlens_experiment() defaults (E=128,
   hidden (512, 256), CIN (64, 64), FinalMLP streams (512, 256) x 2 with 8
   heads, AutoInt 2 layers x 2 heads, MaskNet 4 blocks x 64, DIN (64, 32),
   bf16, batch 4096) on phase 6's splits, each through phases 6-7 with no
   kernel on its path: one fp32 step's loss (within 1e-5) and gradients
   (within GRAD_TOL / GRAD_FLOOR) on the card against the same step on the
   CPU (same seeded weights and batch, xdeepfm's zero CIN head set to
   seeded values, TF32 off, net_dropout 0; the CPU replays the card's
   ReLU and PReLU decisions, each one it would have taken otherwise lying
   within GATE_MARGIN of 0), then
   fit_on_device for 2 epochs (loss finite and falling, best valid AUC >
   0.6, a resume point and the best export, 0 launches of every counted
   kernel wrapper), the step split and profile, the export served through
   evaluate (Predictor on the model's eval forward: served AUC within
   AUC_SERVE_TOL of the trainer's, gAUC within GAUC_TOL of the CPU's, 0
   launches), and score_table over phase 4's 385,024 rows (rows/s,
   probabilities in [0, 1], 0 launches). A [zoo] summary line a model
   beside mm_fibinet's phase 6 run: examples/s, best AUC, a step's wall,
   device-busy ms and share, kernels a step, rows/s.
8. One JSON line describing the five kernels, then the result line.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

B_FULL = 8192
B_RAGGED = 8192 + 37
B_TRAIN = 4096
N_TRAIN, N_VALID = 64 * B_TRAIN, 32_768
TRAIN_EPOCHS = 2
F, E = 6, 128
HIDDEN = (512, 256)
N_ROWS = 47 * 8192  # the reference test split's size
CHUNK_ROWS = 65_536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 FMA
# kernel vs its plain version on the card: (atol, rtol). fp32 differs only by
# summation order; in bf16 a rounding point can land one ulp apart when the
# fp32 sums feeding it are taken in another order, and an interaction pair
# product carries two such roundings.
TOL = {
    ("interaction_fwd", "float32"): (1e-5, 1e-5),
    ("interaction_fwd", "bfloat16"): (1e-3, 2.0**-6),
    ("fused_score", "float32"): (2e-5, 0.0),
    ("fused_score", "bfloat16"): (5e-3, 0.0),
}
# interaction backward vs its plain version: (atol as a share of the
# output's largest magnitude, rtol), per output (dx and each weight
# gradient). fp32 differs by summation order (the weight gradients are sums
# over 4096 rows); in bf16, dv and dx are rounded after fp32 sums taken in
# another order, so a rounding can land one bf16 ulp (2^-8 relative) apart,
# and dW_bi sums 4096 products of such roundings.
# interaction_fwd and the scoring front's concat in bf16, also in norm:
# |kernel - plain| / |plain| <= FWD_NORM_TOL. V summed in fp64 (another
# summation order) reads under 3.0e-5 on the CPU; a forward that takes V
# unrounded into the pair products (fwd_project_plain(...,
# forward_rounding=False)) reads 1.4e-3 to 1.8e-3 there, yet puts no element
# outside the elementwise bar above. That control must fail this bar in
# every bf16 case.
FWD_NORM_TOL = 2.0**-12
BWD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0**-7, 2.0**-7)}
# bf16 also: |kernel - plain| / |plain| (norms) per output. Another
# summation order moves only the few roundings that land one ulp apart
# (under 3.1e-5 on an H100); s or v rounded where the forward rounds them
# moves every element, by 4e-3 to 9e-3 of the norm on the same card, yet
# stays inside the elementwise bar above. The forward-rounding control must
# fail this bar in every bf16 case.
BWD_NORM_TOL = 2.0**-12
# encoder kernel vs its plain version: |d| <= share * max|want| + rtol * |want|
# elementwise, and in bf16 also |d|/|want| <= ENC_NORM_TOL in norm. fp32
# differs by summation order only. In bf16 a rounding point (LN output, ao,
# f1, the output) can land one ulp apart after fp32 sums taken in another
# order, and such a flip in layer 1 moves what layer 2 computes from it; on
# the CPU an fp64-accumulated run of the plain version reads 8.9e-5 (E=128,
# L=1) and 2.5e-4 (E=64, L=2) in norm. The jnp rounding points (bf16 stream,
# LayerNorm and softmax: attention.encode) read 3.2e-3 and 4.2e-3 there, and
# must fail the norm bar in every bf16 case.
ENC_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0**-7, 2.0**-7)}
ENC_NORM_TOL = 2.0**-10
# encoder backward vs its plain version, per output (dx and each of the 12
# weight gradients): |d| <= share * max|want| + rtol * |want| elementwise and
# |d|/|want| <= ENC_BWD_NORM_TOL in norm; the outputs that no ReLU gate
# separates from g (the last layer's ffn2_w and ffn2_b) also within
# ENC_BWD_GATE_FREE_TOL in norm. The backward is discontinuous at the FFN's
# ReLU: where z1 lies within rounding of 0, the kernel's recomputed z1 and the
# plain version's can fall on two sides, and that gate flip moves one dz1
# element by |df1| and a column of dW1 by |hn2| |df1|, upstream of which every
# output moves too (on an H100: one flip in an fp32 case at B=4096, 2e-3 of
# the largest dW1 element and 1.7e-4 in norm; in bf16, where the operands'
# one-ulp rounding flips move z1 by far more, up to 1.1e-2 of the largest
# and 1.4e-3 in norm). Without a flip fp32 differs by summation order only
# (6e-7 in norm). The fp32 kernels and the plain version both accumulate
# their products in fp64 and round once: with fp32 sums on both sides a gate
# flipped in 4 of the 10 fp32 cases on an H100, 2 of them beyond this bar;
# with fp64 sums z1 still moves where an upstream fp32 value (a LayerNorm
# output) lies an ulp apart, and 2 of the 10 cases flip, within the bar. The
# gate-free outputs see no flip: there the kernel reads 4.8e-5 to 9.4e-5 in
# bf16, and the control that leaves every backward operand in fp32
# (encode_bwd_plain(..., fp32_operands=True)) 1.6e-3 to 2.4e-3 on ffn2_w:
# it must be rejected in every bf16 case.
ENC_BWD_TOL = {"float32": (2.0**-7, 1e-4), "bfloat16": (2.0**-5, 2.0**-7)}
ENC_BWD_NORM_TOL = {"float32": 2.0**-10, "bfloat16": 2.0**-8}
ENC_BWD_GATE_FREE_TOL = {"float32": 1e-5, "bfloat16": 2.0**-12}
ENC_BWD_OUTPUTS = ("dx", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_s", "ln1_b",
                   "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b", "ln2_s", "ln2_b")
CPU_TOL = 2e-2  # card vs CPU run of the same bf16 Predictor (probabilities)
# one train step's gradients, kernel path vs plain path, fp32 with TF32 off:
# |d| <= GRAD_TOL * the leaf's largest magnitude + GRAD_FLOOR * the largest
# magnitude of any gradient. Sums run in another order through a 4096-row
# BatchNorm and two dense layers; a missing term or a wrong rounding point
# moves a gradient by far more. The floor covers the Linear biases that feed
# a BatchNorm: their true gradient is 0 (the batch mean cancels them), so
# both paths report rounding noise there.
GRAD_TOL, GRAD_FLOOR = 1e-3, 1e-6
AUC_SERVE_TOL = 2e-3  # served export vs the trainer's eval, same rows
# group AUC of the same probabilities on the card vs on the CPU: both rank in
# float64, so only the order of the float64 sums differs
GAUC_TOL = 1e-6
# phase 6f: Trainer.fit, steps_per_dispatch 8 (the JAX default,
# config/schema.py) against 1; a fit's best valid AUC against phase 6's
# fit_on_device run, which shuffles with torch's randperm where fit's
# iter_batches shuffles with numpy's permutation
FIT_K = 8
FIT_AUC_TOL = 0.01
# fit at FIT_K against fit at 1, per-epoch train loss and valid AUC: within
# the larger of a repeat's gap (fit at 1 again) and FIT_METRIC_FLOOR. That
# the two feeds give every step the same batch is checked bit for bit on
# its own (check_feeds). The step itself is not bit-reproducible on the
# card: the shared likes_level table's merged embedding backward sums the
# same cotangents differently from call to call (the "[fit] one step's
# gradients" and "embedding_dense_backward" lines), the parameters drift,
# and now and then a drift crosses a bf16 rounding and the runs part: on an
# H100 a fit at 8 whose every step saw fit at 1's batch bit for bit ended
# its second epoch 1.9e-6 apart in loss and 2.4e-7 in AUC, while the
# repeat at 1 of the same call matched bit for bit. So the repeat's gap
# alone (0 then) cannot be the bar. The floor is 50x that parting; a step
# lost or a batch out of order moves the loss by more than 1e-3.
FIT_METRIC_FLOOR = 1e-4
WINDOW_GROUPS = 13  # numpy row groups cut from the train split, uneven sizes
FIT_STEPS_TIMED = 24  # steps timed (host clock) and then profiled, a run


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_inputs(torch, btype: str, dtype, b: int, seed: int, use_bias: bool = True,
                  e: int = E, hidden=HIDDEN, f: int = F):
    """Full-width operands for the kernels, drawn with the port's own
    initializers from a seeded generator (SENet with or without biases);
    x from numpy. E, the tower and F default to the model's (128, (512,
    256), 6)."""
    from ctr_recommendation_tpu_torch.ops import bilinear, mlp, senet
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import senet_weights

    gen = torch.Generator().manual_seed(seed)
    x = np.random.default_rng(seed).standard_normal((b, f, e)).astype(np.float32)
    sp = senet.init(gen, f, 2, use_bias=use_bias)
    bp = bilinear.init(gen, e, f, btype)
    cdim = (f + f * (f - 1) // 2) * e
    mp, _ = mlp.init(gen, cdim, hidden, batch_norm=False)
    dev = "cuda"
    sw = [t.to(dev) for t in senet_weights(sp, f)]
    w_bi = (bp["w"] if btype == "all" else bp["w_each"]).to(dev, dtype).contiguous()
    tower = []
    for lin in (mp["layers"][0]["linear"], mp["layers"][1]["linear"], mp["out"]):
        tower += [lin["w"].to(dev, dtype).contiguous(), lin["b"].to(dev)]
    xt = torch.from_numpy(x).to(dev, dtype)
    return xt, sw, w_bi, tower


def check_close(name, got, want, dtype_name):
    atol, rtol = TOL[(name, dtype_name)]
    err = (got.double() - want.double()).abs()
    bad = (err > atol + rtol * want.double().abs()).sum().item()
    return err.max().item(), bad, f"|d| <= {atol:g} + {rtol:g}*|want|"


def norm_gap(got, want) -> float:
    """|got - want| / |want| in norm, in fp64."""
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def time_ms(torch, fn, reps: int = 30) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times))


def kernel_split(torch, fn, label: str, card, reps: int = 5) -> None:
    """torch.profiler over ``reps`` calls of ``fn``: device ms a call of each
    kernel it launches, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / reps / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]
    log(f"[split] {label}: device busy {busy:.4f} ms a call on {card}; ms a call, launches: "
        + str([(e.key[:60], round(e.self_device_time_total / reps / 1e3, 4), e.count // reps)
               for e in top]))


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes at the HBM rate, operations
    at the bf16 tensor rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def make_rows(n: int, seed: int) -> dict[str, np.ndarray]:
    """MicroLens-shaped test rows: left-padded histories of 0..20 items."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 21, n)
    seq = rng.integers(1, 91718, (n, 20)).astype(np.int32)
    seq[np.arange(20)[None, :] < (20 - lens)[:, None]] = 0
    return {
        "user_id": rng.integers(0, 20000, n).astype(np.int32),
        "likes_level": rng.integers(0, 11, n).astype(np.int32),
        "views_level": rng.integers(0, 11, n).astype(np.int32),
        "item_id": rng.integers(1, 91718, n).astype(np.int32),
        "item_seq": seq,
    }


def check_submission(written, csv_path, zip_path, bulk, tag: str) -> None:
    """The pipeline's CSV + zip: N_ROWS rows, IDs in order, probabilities
    finite in (0, 1) and identical to ``bulk`` (score_table's); the CSV's
    bytes those the Python writer writes for ``bulk`` (the native writer
    wrote them), the zip holding those bytes."""
    import zipfile

    from ctr_recommendation_tpu_torch.inference.submission import HEADER, format_rows

    with open(csv_path, "rb") as f:
        raw = f.read()
    lines = raw.decode().splitlines()
    if lines[0] != "ID,Task2" or len(lines) != N_ROWS + 1 or written != N_ROWS:
        raise SystemExit(f"{tag}: CSV has {len(lines) - 1} rows, header {lines[0]!r}")
    ids, probs = zip(*(ln.split(",") for ln in lines[1:]))
    if not np.array_equal(np.asarray(ids, np.int64), np.arange(N_ROWS)):
        raise SystemExit(f"{tag}: CSV IDs are not 0..N-1 in order")
    csv_probs = np.asarray(probs, np.float64).astype(np.float32)
    if not np.isfinite(csv_probs).all() or not ((csv_probs > 0) & (csv_probs < 1)).all():
        raise SystemExit(f"{tag}: CSV probabilities not finite in (0, 1)")
    if not np.array_equal(csv_probs, bulk):
        n_diff = int((csv_probs != bulk).sum())
        raise SystemExit(f"{tag}: pipeline and score_table disagree on {n_diff} rows")
    want = (HEADER + format_rows(bulk)).encode()
    if raw != want:
        at = next((i for i, (a, b) in enumerate(zip(raw, want)) if a != b),
                  min(len(raw), len(want)))
        raise SystemExit(f"{tag}: CSV bytes differ from the Python writer's from byte {at}: "
                         f"{raw[at - 40 : at + 40]!r} vs {want[at - 40 : at + 40]!r}")
    with zipfile.ZipFile(zip_path) as z:
        if z.namelist() != [os.path.basename(csv_path)]:
            raise SystemExit(f"{tag}: zip holds {z.namelist()}")
        if z.read(z.namelist()[0]) != raw:
            raise SystemExit(f"{tag}: the zip does not hold the CSV's bytes")
    log(f"[{tag}] CSV {N_ROWS} rows, IDs in order, probabilities in (0, 1), "
        f"identical to score_table; {len(raw)} bytes, equal to the Python writer's; "
        f"zip ok ({os.path.getsize(zip_path)} bytes, holds the CSV's bytes)")


def where_the_time_goes(torch, pred, rows, bulk, card) -> None:
    """Per-batch device split of the fused scoring step (CUDA events) and
    the pipeline's host stages over the whole split (host clock)."""
    from ctr_recommendation_tpu_torch.data.device_store import device_join
    from ctr_recommendation_tpu_torch.data.wire import build_wire_plan, pack_columns
    from ctr_recommendation_tpu_torch.data import native
    from ctr_recommendation_tpu_torch.inference.submission import write_csv_python
    from ctr_recommendation_tpu_torch.models import trunk
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd

    plan = build_wire_plan(pred.fm)
    batch = {e.name: torch.as_tensor(rows[e.name][:B_FULL]).cuda() for e in plan.entries}

    def front():
        feats = device_join(dict(batch), pred._mm_tables, pred._join_plan)
        return trunk.apply(pred.params["trunk"], pred.fm, pred.exp.model, feats,
                           compute_dtype=pred.compute_dtype)

    x = front().to(pred.tower_dtype).contiguous()
    bt = pred.exp.model.bilinear_type
    with torch.inference_mode():
        dev = {
            "whole step": time_ms(torch, lambda: pred._score(batch)),
            "join + trunk": time_ms(torch, front),
            "fused_score kernel": time_ms(
                torch, lambda: score_fwd(x, *pred._score_weights, bilinear_type=bt)),
        }
    log(f"[breakdown] device ms per {B_FULL}-row batch: {dev} on {card}")
    t0 = time.perf_counter()
    for s in range(0, N_ROWS, CHUNK_ROWS):
        chunk = {k: v[s : s + CHUNK_ROWS] for k, v in rows.items()}
        pack_columns(chunk, plan, -(-len(chunk["item_id"]) // B_FULL) * B_FULL)
    t_pack = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if not native.write_csv(bulk, os.path.join(tmp, "native.csv")):
            raise SystemExit("the native CSV writer failed")
        t_fmt = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_csv_python(bulk, os.path.join(tmp, "python.csv"))
        t_py = time.perf_counter() - t0
    log(f"[breakdown] host s for {N_ROWS} rows: wire pack {t_pack:.4f}, "
        f"CSV format {t_fmt:.4f} (native write_csv, the pipeline's writer, into a file; "
        f"the Python writer {t_py:.4f})")


def encoder_case(torch, dtype, b: int, e: int, heads: int, layers: int, seed: int, s: int = 20):
    """The encoder's operands on the card: seeded params (the port's init),
    a numpy history of random pad lengths (row 0 all pad, row 1 none), and
    what fused_encode feeds the kernel. Returns (x, amask, pad, weights,
    params, seq_emb, ids)."""
    from ctr_recommendation_tpu_torch.ops import attention
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encoder_inputs, stack_weights
    from ctr_recommendation_tpu_torch.utils.tree import tree_map

    params = attention.init(torch.Generator().manual_seed(seed), e, s, num_heads=heads,
                            num_layers=layers)
    params = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, s + 1, b)
    lens[0], lens[1] = 0, s
    ids = rng.integers(1, 91718, (b, s))
    ids[np.arange(s)[None, :] < (s - lens)[:, None]] = 0
    ids = torch.from_numpy(ids).cuda()
    seq_emb = torch.from_numpy(rng.standard_normal((b, s, e)).astype(np.float32)).to("cuda", dtype)
    x, amask, pad = encoder_inputs(params, seq_emb, ids)
    return x, amask, pad, stack_weights(params, dtype), params, seq_emb, ids


def check_encoder(torch, got, want, dtype_name):
    """(max abs err, |d|/|want| in norm, within the bars) of the encoder
    kernel against a reference output."""
    atol_share, rtol = ENC_TOL[dtype_name]
    a, w = got.double(), want.double()
    err = (a - w).abs()
    rel_norm = (err.norm() / w.norm()).item()
    ok = (bool(torch.isfinite(a).all())
          and not bool((err > atol_share * w.abs().max() + rtol * w.abs()).any())
          and (dtype_name != "bfloat16" or rel_norm <= ENC_NORM_TOL))
    return err.max().item(), rel_norm, ok


def check_encoder_bwd(torch, got, want, dtype_name):
    """(max abs err, largest |d|/|want| in norm, the same over the gate-free
    outputs, names of the outputs out of their bars) over dx and the 12
    weight gradients."""
    share, rtol = ENC_BWD_TOL[dtype_name]
    worst, worst_norm, gate_free, bad = 0.0, 0.0, 0.0, []

    def rel(a, w):
        return ((a - w).norm() / w.norm().clamp(min=1e-30)).item()

    for name, a, w in zip(ENC_BWD_OUTPUTS, got, want):
        a, w = a.double(), w.double()
        err = (a - w).abs()
        rel_norm = rel(a, w)
        free = rel(a[-1], w[-1]) if name in ("ffn2_w", "ffn2_b") else 0.0
        if (not bool(torch.isfinite(a).all())
                or bool((err > share * w.abs().max() + rtol * w.abs()).any())
                or rel_norm > ENC_BWD_NORM_TOL[dtype_name]
                or free > ENC_BWD_GATE_FREE_TOL[dtype_name]):
            bad.append(name)
        worst = max(worst, err.max().item())
        worst_norm = max(worst_norm, rel_norm)
        gate_free = max(gate_free, free)
    return worst, worst_norm, gate_free, bad


def library_layer(torch, weights, num_heads: int, device="cuda"):
    """torch.nn.TransformerEncoderLayer computing one encoder layer of the
    stacked ``weights`` (L=1): the timing yardstick, never on the main path.
    Pre-LN (norm_first), ReLU FFN of 4E, eps 1e-6, no dropout, eval mode."""
    qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b = (
        t[0].float() for t in weights)
    e = qkv_w.shape[0]
    layer = torch.nn.TransformerEncoderLayer(
        d_model=e, nhead=num_heads, dim_feedforward=4 * e, dropout=0.0, activation="relu",
        layer_norm_eps=1e-6, batch_first=True, norm_first=True, device=device,
        dtype=weights[0].dtype,
    ).eval()
    with torch.no_grad():
        for param, value in (
            (layer.self_attn.in_proj_weight, qkv_w.T), (layer.self_attn.in_proj_bias, qkv_b),
            (layer.self_attn.out_proj.weight, proj_w.T), (layer.self_attn.out_proj.bias, proj_b),
            (layer.linear1.weight, w1.T), (layer.linear1.bias, b1),
            (layer.linear2.weight, w2.T), (layer.linear2.bias, b2),
            (layer.norm1.weight, ln1_s), (layer.norm1.bias, ln1_b),
            (layer.norm2.weight, ln2_s), (layer.norm2.bias, ln2_b),
        ):
            param.copy_(value)
    return layer


BWD_OUTPUTS = ("dx", "dW1", "db1", "dW2", "db2", "dW_bi")


def backward_inputs(torch, btype: str, dtype, b: int, seed: int, use_bias: bool, e: int = E,
                    f: int = F):
    """The interaction backward's operands: a seeded numpy cotangent g and
    the forward's (x, SENet weights, bilinear weight), F fields of width E."""
    x, sw, w_bi, _ = kernel_inputs(torch, btype, dtype, b, seed, use_bias, e=e, hidden=(8, 8),
                                   f=f)
    g = np.random.default_rng(seed + 1).standard_normal((b, (f + f * (f - 1) // 2) * e))
    return torch.from_numpy(g.astype(np.float32)).cuda(), x, sw, w_bi


def check_backward(torch, got, want, dtype_name):
    """(max abs err, largest |d|/|want| in norm, names of the outputs out of
    BWD_TOL, or in bf16 out of BWD_NORM_TOL) over dx and the five weight
    gradients."""
    share, rtol = BWD_TOL[dtype_name]
    worst, worst_norm, bad = 0.0, 0.0, []
    for name, a, w in zip(BWD_OUTPUTS, got, want):
        a, w = a.double(), w.double()
        err = (a - w).abs()
        limit = share * w.abs().max().item() + rtol * w.abs()
        rel_norm = (err.norm() / w.norm()).item()
        if (not bool(torch.isfinite(a).all()) or bool((err > limit).any())
                or (dtype_name == "bfloat16" and rel_norm > BWD_NORM_TOL)):
            bad.append(name)
        worst = max(worst, err.max().item())
        worst_norm = max(worst_norm, rel_norm)
    return worst, worst_norm, bad


# the zoo's card-vs-CPU step (phase 6g): the CPU replays the card's decision
# at every ReLU and PReLU gate. A pre-activation within rounding of 0 can
# fall on the two sides of a gate in the two runs, and the backward is
# discontinuous there: a single such gate of DIN's activation unit, whose
# weight gradients sum 81,920 rows, moves them past GRAD_TOL (the log's
# "without the replay" gap, which is not held). A gate may differ only
# where its input lies within GATE_MARGIN of 0, relative to the largest
# |input| of its tensor (~100 fp32 ulps of the tensor's scale); a wrong
# computation moves gates by far more.
GATE_MARGIN = 1e-5


def gate_replay(torch, gates=None, part=(0, 1)):
    """A torch function mode that records the decision of every ReLU
    (``torch.relu``) and every gate ``torch.where(cond, a, b)`` on floating
    ``a`` in one forward, in call order (``gates`` None), or replays such a
    record (``gates``) on another device: ``flips`` counts the decisions the
    replaying forward would have taken otherwise, ``margin`` is the largest
    |input| / max|input| of its tensor among them. ``part`` (rank, world):
    the replaying forward holds rank's share of the recorded batch, and
    takes that share of each recorded gate (along the dimension that is
    world times its own)."""
    from torch.overrides import TorchFunctionMode

    class GateReplay(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.replay = gates is not None
            self.gates = gates if gates is not None else []
            self.calls = self.flips = 0
            self.margin = 0.0

        def _decide(self, own, x):
            if not self.replay:
                self.gates.append(own)
                return own
            given = self.gates[self.calls].to(own.device)
            self.calls += 1
            rank, world = part
            for d, (n, m) in enumerate(zip(given.shape, own.shape)):
                if n == world * m != m:
                    given = given.narrow(d, rank * m, m)
                    break
            differ = given != own
            if bool(differ.any()):
                self.flips += int(differ.sum())
                mag = x.detach().abs()
                self.margin = max(self.margin, float(mag[differ].max() / mag.max()))
            return given

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.relu:
                x = args[0]
                return torch.where(self._decide(x > 0, x), x, 0.0)
            if (func is torch.where and len(args) == 3 and torch.is_tensor(args[1])
                    and args[1].is_floating_point()):
                return func(self._decide(args[0], args[1]), *args[1:], **kwargs)
            return func(*args, **kwargs)

    return GateReplay()


def gradient_check(torch, exp, train, store, root, kernels: dict, tag: str,
                   against_cpu: bool = False):
    """One step's gradients (fp32, TF32 off) through the kernels against the
    plain path: same seeded weights, batch and dropout seed (the encoder's
    masks too: the kernels and the plain path draw them alike). ``kernels``
    maps each wrapper the step must launch to its launches a step. With
    sparse tables the gradients are the dense leaves', the masked-dense
    tables' and the gathered tables' row buffers'. With ``against_cpu`` the
    card's step is held against the same step on the CPU instead (the zoo,
    whose path holds no kernel), with net_dropout 0, the CPU replaying the
    card's gate decisions (``gate_replay``, GATE_MARGIN). Returns the first
    path's (trainer, batch, aux, gradients), its step not yet applied,
    and the worst |d| / max|g| over the gradients above 1e-3 of the
    largest."""
    import dataclasses

    from ctr_recommendation_tpu_torch.training import Trainer

    bs = exp.train.batch_size
    host_batch = {k: torch.as_tensor(v[:bs]) for k, v in train.columns.items()}
    if against_cpu:
        exp = exp.replace(model=dataclasses.replace(exp.model, net_dropout=0.0))
        sides = (("card", "cuda", exp.model.use_pallas), ("CPU", "cpu", exp.model.use_pallas))
    else:
        sides = (("kernel", "cuda", True), ("plain", "cuda", False))
    out = []
    for i, (side, device, use_kernel) in enumerate(sides):
        e = exp.replace(
            model=dataclasses.replace(exp.model, use_pallas=use_kernel),
            train=dataclasses.replace(exp.train, compute_dtype="float32",
                                      checkpoint_dir=os.path.join(root, f"grad_{tag}_{side}")),
        )
        tr = Trainer(e, steps_per_epoch=N_TRAIN // bs, item_store=store, device=device,
                     log_fn=lambda s: None)
        if against_cpu and "cin" in tr.state.params:
            # xdeepfm's CIN head starts at 0, which makes every filter's
            # gradient 0 on both sides: seeded values, the same on both
            gen = torch.Generator().manual_seed(17)
            with torch.no_grad():
                for v in tr.state.params["cin"]["out"].values():
                    v.copy_(1e-3 * torch.randn(v.shape, generator=gen))
        batch = {k: v.to(device) for k, v in host_batch.items()}
        for fn in kernels:
            fn.launches = 0
        gates = (gate_replay(torch, None if i == 0 else gates.gates) if against_cpu
                 else contextlib.nullcontext())
        with torch.enable_grad():
            with gates:
                loss, aux = tr.forward_loss(batch)
            out.append((loss.item(), tr.gradients(loss, aux), list(aux.targets)))
        if i == 0:
            first = (tr, batch, aux, out[0][1])
        torch.cuda.synchronize()
        launched = tuple(fn.launches for fn in kernels)
        if launched != (tuple(kernels.values()) if i == 0 else (0,) * len(kernels)):
            raise SystemExit(f"{tag} gradient check, {side} (use_pallas={use_kernel}): launches "
                             f"{launched}")
    (l_k, g_k, names), (l_p, g_p, _) = out
    (s_k, dev_k, _), (s_p, _, _) = sides
    gate_note = ""
    if against_cpu:
        gate_note = (f"; the card's gates replayed on the CPU ({len(gates.gates)} tensors, "
                     f"{sum(g.numel() for g in gates.gates)} decisions): {gates.flips} the CPU "
                     f"would have taken otherwise, their inputs within {gates.margin:.2e} of 0 "
                     f"relative to their tensor's largest |input| (GATE_MARGIN {GATE_MARGIN:g})")
        if gates.calls != len(gates.gates) or gates.margin > GATE_MARGIN:
            raise SystemExit(f"{tag}: the CPU's forward met {gates.calls} gates for the "
                             f"card's {len(gates.gates)}, or a gate flipped beyond rounding "
                             f"({gates.margin:.2e} > {GATE_MARGIN:g})")
    g_p = [b.to(dev_k) for b in g_p]
    largest = max(b.abs().max().item() for b in g_p)
    floor = GRAD_FLOOR * largest
    if against_cpu:  # the CPU's step on its own gates too, for the log only
        with torch.enable_grad():
            loss, aux = tr.forward_loss(batch)
            free = [b.to(dev_k) for b in tr.gradients(loss, aux)]
        free_gap = max((a - b).abs().max().item() / b.abs().max().item()
                       for a, b in zip(g_k, free) if b.abs().max().item() > 1e-3 * largest)
        gate_note += f"; without the replay, worst |d|/max|g| {free_gap:.3e} (not held)"
    worst_rel, vanishing, no_floor, bad = 0.0, [], [], []
    for name, a, b in zip(names, g_k, g_p):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        if scale > 1e-3 * largest:
            worst_rel = max(worst_rel, err / scale)
        else:
            vanishing.append(f"{name}: max|d| {err:.3e}, max|g| {scale:.3e}")
        if err > GRAD_TOL * scale:
            no_floor.append(name)
        if not bool(torch.isfinite(a).all()) or err > GRAD_TOL * scale + floor:
            bad.append(f"{name}: max|d| {err:.2e}, max|g| {scale:.2e}")
    launched = ", ".join(f"{n} {fn.__name__}" for fn, n in kernels.items()) or "no kernel"
    log(f"[train {tag}] gradient check, fp32, "
        f"{'dropout off, card vs CPU' if against_cpu else 'dropout on'}: loss {s_k} {l_k:.7f} "
        f"vs {s_p} {l_p:.7f}; {len(names)} gradients through {launched} launches; worst "
        f"|d|/max|g| {worst_rel:.3e} over the gradients above 1e-3 of the largest "
        f"({largest:.3e}); tolerance {GRAD_TOL:g} of the leaf + {GRAD_FLOOR:g} of the largest "
        f"({floor:.3e}); below 1e-3 of the largest: {vanishing}; out of {GRAD_TOL:g} of the "
        f"leaf without the floor: {no_floor}{gate_note}")
    if bad or abs(l_k - l_p) > 1e-5:
        raise SystemExit(f"{tag}: {s_k} and {s_p} gradients disagree: {bad}, losses {l_k} and "
                         f"{l_p}")
    return (*first, worst_rel)


def step_split(torch, trainer, train, card, tag: str, reps: int = 10, profiled: int = 3) -> dict:
    """Median ms of one train step's forward+loss, backward and optimizer
    (CUDA events), after three warm-up steps; then ``torch.profiler`` over
    ``profiled`` more steps: device-busy ms and kernels a step, the busy
    share of the timed step, and the largest device items. Returns the
    timed step's ms, the device-busy ms and the kernels a step."""
    from torch.profiler import ProfilerActivity, profile

    bs = trainer.exp.train.batch_size
    batch = {k: torch.as_tensor(v[:bs]).cuda() for k, v in train.columns.items()}
    parts = {"forward+loss": [], "backward": [], "optimizer": []}
    for i in range(3 + reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.enable_grad():
            loss, aux = trainer.forward_loss(batch)
            ev[1].record()
            grads = trainer.gradients(loss, aux)
        ev[2].record()
        trainer.apply_gradients(grads, aux)
        ev[3].record()
        ev[3].synchronize()
        if i >= 3:
            for k, (a, z) in zip(parts, zip(ev[:-1], ev[1:])):
                parts[k].append(a.elapsed_time(z))
    split = {k: float(np.median(v)) for k, v in parts.items()}
    step_ms = sum(split.values())
    log(f"[train {tag}] one step at B={bs}, ms (median of {reps}): {split}, "
        f"sum {step_ms:.4f} on {card}")
    for attempt in range(3):  # a trace now and then holds no device event: profile again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                trainer.train_step(batch)
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if on_card:
            break
        log(f"[train {tag}] torch.profiler recorded no device event (try {attempt + 1} of 3)")
    else:
        raise SystemExit(f"{tag}: torch.profiler recorded no device event in 3 tries")
    busy = sum(e.self_device_time_total for e in on_card) / profiled / 1e3
    launched = sum(e.count for e in on_card) / profiled
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[train {tag}] torch.profiler over {profiled} steps: device busy {busy:.4f} ms a step "
        f"({busy / step_ms:.3f} of the {step_ms:.4f} ms timed step), {launched:.0f} kernels "
        f"a step on {card}; largest, ms a step: "
        + str([(e.key[:70], round(e.self_device_time_total / profiled / 1e3, 4)) for e in top]))
    return {"step_ms": step_ms, "busy_ms": busy, "kernels": launched}


ENC_CASES = ([(128, 2, 1, b) for b in (B_TRAIN, B_FULL, B_RAGGED)] + [(64, 4, 2, B_TRAIN + 37)]
             + [(256, 2, 1, b) for b in (B_FULL, B_RAGGED)] + [(256, 4, 2, B_TRAIN + 37)])
ENC_E, ENC_H, ENC_S = 128, 2, 20  # sasrec_fibinet's defaults: E, heads, max_len
LIB_TOL = 1e-4  # nn.TransformerEncoderLayer vs the plain version, fp32, TF32 off


def encoder_against_plain(torch) -> tuple[float, list]:
    """Phase 2 for the encoder: the kernel against its plain version at full
    width (E=128, H=2, L=1; B=4096, 8192, 8192+37) and a second shape (E=64,
    H=4, L=2, B=4133), bf16 and fp32; pad rows of fused_encode exactly 0; in
    bf16 the jnp rounding points (attention.encode) must fail the norm bar.
    Returns (worst max_abs_err, failures)."""
    from ctr_recommendation_tpu_torch.ops import attention
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        encode_fwd,
        encode_fwd_plain,
        fused_encode,
    )

    worst, failures = 0.0, []
    for e, heads, layers, b in ENC_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x, amask, pad, ws, params, seq_emb, ids = encoder_case(
                torch, dtype, b, e, heads, layers, seed=b + e)
            got = encode_fwd(x, amask, *ws, num_heads=heads)
            want = encode_fwd_plain(x, amask, *ws, num_heads=heads)
            fused = fused_encode(params, seq_emb, ids, num_heads=heads)
            torch.cuda.synchronize()
            err, rel_norm, ok = check_encoder(torch, got, want, dn)
            zeroed = torch.where(pad[..., None], torch.zeros((), dtype=dtype, device="cuda"), got)
            pads_zero = bool((fused[pad] == 0).all()) and bool((fused[0] == 0).all())
            ok = ok and pads_zero and torch.equal(fused, zeroed)
            worst = max(worst, err)
            control = ""
            if dtype == torch.bfloat16:
                ctl = attention.encode(params, seq_emb, ids, num_heads=heads)
                _, c_norm, _ = check_encoder(torch, zeroed, ctl, dn)
                ok = ok and c_norm > ENC_NORM_TOL
                control = (f"; jnp-rounding control |d|/|want| {c_norm:.3e} "
                           f"{'rejected' if c_norm > ENC_NORM_TOL else 'NOT REJECTED'}")
            atol_share, rtol = ENC_TOL[dn]
            log(f"[compare] sasrec_encoder_fwd E={e} H={heads} L={layers} {dn} B={b}: "
                f"max_abs_err={err:.3e} (|d| <= {atol_share:g}*max|want| + {rtol:g}*|want|), "
                f"|d|/|want| {rel_norm:.3e} (bf16 bar {ENC_NORM_TOL:.3e}), pad rows of "
                f"fused_encode exactly 0: {pads_zero}{control} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("sasrec_encoder_fwd", e, heads, layers, dn, b))
    return worst, failures


def encoder_timing(torch, card, e: int = ENC_E) -> dict:
    """Phase 3 for the encoder at B=8192, bf16, L=1: kernel, plain version and
    nn.TransformerEncoderLayer (checked first against the plain version in
    fp32 on every history with a real step), CUDA events, beside the bound."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encode_fwd, encode_fwd_plain

    x, amask, pad, ws, _, _, _ = encoder_case(torch, torch.float32, B_FULL, e, ENC_H, 1, 3)
    real = ~pad.all(-1)
    with torch.inference_mode():
        lib = library_layer(torch, ws, ENC_H)(x, src_key_padding_mask=pad)
    want = encode_fwd_plain(x, amask, *ws, num_heads=ENC_H)
    lib_err = (lib[real] - want[real]).abs().max().item()
    log(f"[compare] nn.TransformerEncoderLayer fp32 vs encode_fwd_plain on the "
        f"{int(real.sum())} histories with a real step: max_abs_err={lib_err:.3e} "
        f"(tolerance {LIB_TOL:g})")
    if not lib_err <= LIB_TOL:
        raise SystemExit("the library yardstick does not compute the encoder's function")

    x, amask, pad, ws, _, _, _ = encoder_case(torch, torch.bfloat16, B_FULL, e, ENC_H, 1, 4)
    layer = library_layer(torch, ws, ENC_H)
    tokens = B_FULL * ENC_S
    ops = 2 * tokens * (12 * e * e + 2 * ENC_S * e)
    nbytes = 2 * 2 * x.numel() + 4 * amask.numel() + sum(t.numel() * t.element_size() for t in ws)
    with torch.inference_mode():
        t = {
            "ms": time_ms(torch, lambda: encode_fwd(x, amask, *ws, num_heads=ENC_H)),
            "plain_ms": time_ms(torch, lambda: encode_fwd_plain(x, amask, *ws, num_heads=ENC_H)),
            **bound(nbytes, ops),
            "library_ms": time_ms(torch, lambda: layer(x, src_key_padding_mask=pad)),
        }
    log(f"[time] sasrec_encoder_fwd bf16 B={B_FULL} S={ENC_S} E={e} H={ENC_H} L=1: {t} "
        f"(bytes {nbytes}, ops {ops}; library: nn.TransformerEncoderLayer, bf16) on {card}")
    seed = torch.tensor([3], dtype=torch.int64, device="cuda")
    kw = dict(num_heads=ENC_H, seed=seed, rate=DROP_RATE)
    with torch.inference_mode():
        drop = {"ms": time_ms(torch, lambda: encode_fwd(x, amask, *ws, **kw)),
                "plain_ms": time_ms(torch, lambda: encode_fwd_plain(x, amask, *ws, **kw))}
    log(f"[time] sasrec_encoder_fwd with dropout {DROP_RATE} (train mode), same inputs: {drop} "
        f"on {card}")
    with torch.inference_mode():
        kernel_split(torch, lambda: encode_fwd(x, amask, *ws, **kw),
                     f"sasrec_encoder_fwd bf16 B={B_FULL} E={e} dropout {DROP_RATE}", card)
    return t


DROP_RATE = 0.1  # sasrec_fibinet's attn_dropout default
ENC_BWD_CASES = [(128, 2, 1, B_TRAIN), (128, 2, 1, B_TRAIN + 37), (64, 4, 2, B_TRAIN + 37),
                 (256, 2, 1, B_TRAIN), (256, 2, 1, B_TRAIN + 37)]


def encoder_cotangent(torch, pad, e: int, seed: int, dtype):
    """A seeded numpy cotangent of the encoder's output (B, S, e) on the
    card, zero at pad rows (fused_encode's re-zeroing gives that)."""
    b, s = pad.shape
    g = np.random.default_rng(seed).standard_normal((b, s, e)).astype(np.float32)
    g = torch.from_numpy(g).cuda() * ~pad[..., None]
    return g.to(dtype).contiguous()


def dropout_forward_against_plain(torch) -> tuple[float, list]:
    """Phase 2, the forward kernel with dropout: against encode_fwd_plain
    under the same seed (rate 0.1, two seeds, the encoder cases, bf16 and
    fp32); rate 0 bit-identical to the eval launch; and the kernel's own
    mask read back through weights that make each residual branch a
    constant 1 (f2 = ffn2_b = 1, the attention branch 0): it must equal
    dropout_mask, and its kept share lie within 6 sigma of 1 - rate."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        dropout_mask,
        encode_fwd,
        encode_fwd_plain,
    )

    worst, failures = 0.0, []
    for e, heads, layers, b in ENC_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x, amask, _, ws, _, _, _ = encoder_case(torch, dtype, b, e, heads, layers,
                                                    seed=b + e + 1)
            evaluated = encode_fwd(x, amask, *ws, num_heads=heads)
            zero_rate = encode_fwd(x, amask, *ws, num_heads=heads,
                                   seed=torch.tensor([5], dtype=torch.int64, device="cuda"),
                                   rate=0.0)
            same = torch.equal(evaluated, zero_rate)
            for s in (b, 2**40 + b):
                seed = torch.tensor([s], dtype=torch.int64, device="cuda")
                got = encode_fwd(x, amask, *ws, num_heads=heads, seed=seed, rate=DROP_RATE)
                want = encode_fwd_plain(x, amask, *ws, num_heads=heads, seed=seed,
                                        rate=DROP_RATE)
                torch.cuda.synchronize()
                err, rel_norm, ok = check_encoder(torch, got, want, dn)
                moved = (got.float() - evaluated.float()).abs().max().item()
                ok = ok and same and moved > 1e-2
                worst = max(worst, err)
                log(f"[compare] sasrec_encoder_fwd dropout {DROP_RATE} seed {s} E={e} H={heads} "
                    f"L={layers} {dn} B={b}: max_abs_err={err:.3e}, |d|/|want| {rel_norm:.3e}; "
                    f"rate 0 == eval launch: {same}; moved from eval by {moved:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(("sasrec_encoder_fwd dropout", e, heads, layers, dn, b, s))
    # the kernel's mask, read back: h_out = x + drop1(1) with a zero attention branch
    x, amask, _, ws, _, _, _ = encoder_case(torch, torch.float32, B_TRAIN, ENC_E, ENC_H, 1, 9)
    ws = [torch.zeros_like(t) if i in (0, 1, 2, 3, 6, 7, 8) else t for i, t in enumerate(ws)]
    ws[9] = torch.ones_like(ws[9])
    seed = torch.tensor([77], dtype=torch.int64, device="cuda")
    out = encode_fwd(x, amask, *ws, num_heads=ENC_H, seed=seed, rate=DROP_RATE)
    kept = ((out - x) > 0.5).reshape(-1, ENC_E)
    mask = dropout_mask(seed, kept.shape[0], ENC_E, 0, 1, DROP_RATE)
    n = kept.numel()
    share = kept.float().mean().item()
    sigma = (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5
    ok = torch.equal(kept, mask) and abs(share - (1 - DROP_RATE)) < 6 * sigma
    log(f"[compare] sasrec_encoder_fwd in-kernel mask over {n} elements: equals dropout_mask "
        f"{torch.equal(kept, mask)}, kept share {share:.6f} (1 - rate {1 - DROP_RATE:g}, 6 sigma "
        f"{6 * sigma:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(("sasrec_encoder_fwd mask",))
    return worst, failures + token_base_against_plain(torch, x, amask, ws, seed, mask)


def token_base_against_plain(torch, x, amask, ws, seed, mask) -> list:
    """Phase 6h (d): the encoder kernels at a data-parallel rank's token
    base. The in-kernel mask read back as above (``x``, ``ws``, ``mask``:
    that case's) at token0 = rank 1's first token in phase 6h (2048 x S)
    and across the 2^32 wrap: bit for bit dropout_mask at that token0, and
    not the token0 = 0 mask. Then the back half of a batch run at its token
    base: the forward's output and the backward's dx bit for bit the whole
    batch's back half (each token's result reads only its own sequence),
    the forward within ENC_TOL of encode_fwd_plain at that token0."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        dropout_mask,
        encode_bwd,
        encode_fwd,
        encode_fwd_plain,
    )

    failures = []
    for token0 in (B_TRAIN // 2 * ENC_S, (1 << 32) - 1000):
        out = encode_fwd(x, amask, *ws, num_heads=ENC_H, seed=seed, rate=DROP_RATE,
                         token0=token0)
        kept = ((out - x) > 0.5).reshape(-1, ENC_E)
        want = dropout_mask(seed, kept.shape[0], ENC_E, 0, 1, DROP_RATE, token0)
        ok = torch.equal(kept, want) and not torch.equal(kept, mask)
        log(f"[compare] sasrec_encoder_fwd in-kernel mask at token base {token0}: equals "
            f"dropout_mask there {torch.equal(kept, want)}, differs from token base 0's "
            f"{not torch.equal(kept, mask)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(("sasrec_encoder_fwd token base mask", token0))
    half = B_TRAIN // 2
    x, amask, pad, ws, _, _, _ = encoder_case(torch, torch.bfloat16, B_TRAIN, ENC_E, ENC_H, 1,
                                              seed=23)
    g = encoder_cotangent(torch, pad, ENC_E, 24, torch.bfloat16)
    kw = dict(num_heads=ENC_H, seed=seed, rate=DROP_RATE)
    back = dict(token0=half * ENC_S, **kw)
    full = encode_fwd(x, amask, *ws, **kw)
    got = encode_fwd(x[half:], amask[half:], *ws, **back)
    plain = encode_fwd_plain(x[half:], amask[half:], *ws, **back)
    dx_full = encode_bwd(g, x, amask, *ws, **kw)[0]
    dx = encode_bwd(g[half:], x[half:], amask[half:], *ws, **back)[0]
    torch.cuda.synchronize()
    err, rel_norm, ok_plain = check_encoder(torch, got, plain, "bfloat16")
    same_fwd, same_bwd = torch.equal(got, full[half:]), torch.equal(dx, dx_full[half:])
    ok = ok_plain and same_fwd and same_bwd
    log(f"[compare] sasrec_encoder token base {half * ENC_S} (rows {half}..{B_TRAIN - 1} of "
        f"{B_TRAIN}, bf16, dropout {DROP_RATE}): forward bit for bit the whole batch's rows "
        f"{same_fwd}, dx bit for bit {same_bwd}; forward vs encode_fwd_plain at that base "
        f"max_abs_err={err:.3e}, |d|/|want| {rel_norm:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(("sasrec_encoder token base", same_fwd, same_bwd, ok_plain))
    return failures


def encoder_bwd_against_plain(torch) -> tuple[float, list]:
    """Phase 2, the backward kernel against encode_bwd_plain at E=128, H=2,
    L=1 (B=4096, 4133) and E=64, H=4, L=2 (B=4133), rate 0 and 0.1, bf16 and
    fp32: ENC_BWD_TOL per output, the repeat launch bit-identical, and in
    bf16 the fp32-operand control rejected by the same bars."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encode_bwd, encode_bwd_plain

    worst, failures = 0.0, []
    for e, heads, layers, b in ENC_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x, amask, pad, ws, _, _, _ = encoder_case(torch, dtype, b, e, heads, layers,
                                                      seed=b + e + 2)
            g = encoder_cotangent(torch, pad, e, b + 3, dtype)
            for rate in (0.0, DROP_RATE):
                seed = torch.tensor([b * 7 + e], dtype=torch.int64, device="cuda")
                kw = dict(num_heads=heads, seed=seed, rate=rate)
                got = encode_bwd(g, x, amask, *ws, **kw)
                again = encode_bwd(g, x, amask, *ws, **kw)
                want = encode_bwd_plain(g, x, amask, *ws, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                err, rel_norm, free, bad = check_encoder_bwd(torch, got, want, dn)
                worst = max(worst, err)
                ok = same and not bad
                control = ""
                if dtype == torch.bfloat16:
                    wrong = encode_bwd_plain(g, x, amask, *ws, **kw, fp32_operands=True)
                    _, c_norm, c_free, c_bad = check_encoder_bwd(torch, got, wrong, dn)
                    ok = ok and bool(c_bad)
                    control = (f"; fp32-operand control |d|/|want| up to {c_norm:.3e}, gate-free "
                               f"{c_free:.3e}, {'rejected' if c_bad else 'NOT REJECTED'} on "
                               f"{c_bad}")
                share, rtol = ENC_BWD_TOL[dn]
                log(f"[compare] sasrec_encoder_bwd E={e} H={heads} L={layers} {dn} B={b} "
                    f"rate={rate}: max_abs_err={err:.3e} (|d| <= {share:g}*max|want| + "
                    f"{rtol:g}*|want|), |d|/|want| up to {rel_norm:.3e} (bar "
                    f"{ENC_BWD_NORM_TOL[dn]:.3e}), gate-free {free:.3e} (bar "
                    f"{ENC_BWD_GATE_FREE_TOL[dn]:.3e}), repeat bit-identical {same}{control} "
                    f"{'ok' if ok else f'FAIL {bad}'}")
                if not ok:
                    failures.append(("sasrec_encoder_bwd", e, heads, layers, dn, b, rate))
    return worst, failures


BLOCK_CASES = [(128, 2), (256, 2)]  # (E, H) of the building-block checks
BLOCK_CHUNK = 2048  # tokens a weight-gradient split sums (a multiple of 32)


def encoder_blocks_against_plain(torch, e: int, heads: int, dtype, seed: int = 0):
    """Phase 2: each building block of the encoder kernels (encoder_blocks)
    against its plain version on the same inputs, at full width: the
    forward's blocks over the serving batch 8192+37 (164,740 tokens), the
    backward's over 4133 histories, with dropout 0.1 where a block applies
    it; every output within ENC_TOL (and ENC_NORM_TOL in bf16). Each block
    takes the plain version's outputs of the block before it. Returns
    (worst max_abs_err, failures)."""
    from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb

    dn = str(dtype).split(".")[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    drop = dict(seed=torch.tensor([seed + 1], dtype=torch.int64, device="cuda"), rate=DROP_RATE)
    worst, failures = 0.0, []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def held(name, n, got, want):
        nonlocal worst
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for i, (a, w) in enumerate(pairs):
            err, rel_norm, ok = check_encoder(torch, a, w, dn)
            worst = max(worst, err)
            tag = name if len(pairs) == 1 else f"{name}[{i}]"
            log(f"[compare] encoder block {tag} E={e} H={heads} {dn} N={n}: max_abs_err={err:.3e}, "
                f"|d|/|want| {rel_norm:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("encoder block", tag, e, heads, dn))
        return want

    def block(name, n, fn, *args, **kw):
        """fn on CUDA tensors launches the kernel; fn's plain version (the
        same name with _plain) runs the same arguments."""
        plain = getattr(eb, fn.__name__ + "_plain")
        return held(name, n, fn(*args, **kw), plain(*args, **kw))

    # the forward's blocks
    x, amask, _, ws, _, _, _ = encoder_case(torch, dtype, B_RAGGED, e, heads, 1, seed=seed + e)
    (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
     ffn1_w, ffn1_b, ffn2_w, ffn2_b, _, _) = (t[0] for t in ws)
    n = x.shape[0] * x.shape[1]
    h = x.float().reshape(n, e) + randn(n, e)
    hn = block("layer_norm", n, eb.layer_norm, h, ln1_s, ln1_b, dtype, True)[0]
    qkv = block("product nn bias", n, eb.product, hn, qkv_w, "nn", "bias", bias=qkv_b)
    ao, _ = block("attention_fwd", n, eb.attention_fwd, qkv, amask, heads, dtype)
    h1 = block("product nn residual", n, eb.product, ao, proj_w, "nn", "residual", bias=proj_b,
               aux=h, layer=0, branch=0, **drop)
    f1 = block("product nn relu", n, eb.product, hn, ffn1_w, "nn", "relu", bias=ffn1_b,
               out_dtype=dtype)
    block("product nn residual to cd", n, eb.product, f1, ffn2_w, "nn", "residual", bias=ffn2_b,
          aux=h1, layer=0, branch=1, out_dtype=dtype, **drop)
    del x, h, hn, qkv, ao, h1, f1

    # the backward's blocks
    x, amask, _, ws, _, _, _ = encoder_case(torch, dtype, B_TRAIN + 37, e, heads, 1,
                                            seed=seed + e + 1)
    (_, _, proj_w, _, _, _, ffn1_w, _, ffn2_w, _, ln2_s, ln2_b) = (t[0] for t in ws)
    n = x.shape[0] * x.shape[1]
    dh = randn(n, e)
    f1 = torch.relu(randn(n, 4 * e)).to(dtype)
    ch = dict(chunk=BLOCK_CHUNK)
    db2, df2 = block("column_sums gate", n, eb.column_sums, dh, "gate", layer=0, branch=1,
                     cd=dtype, **ch, **drop)
    part = block("product tn partial", n, eb.product, f1, df2, "tn", "partial", **ch)
    block("reduce_partials", n, eb.reduce_partials, part.reshape(part.shape[0], -1))
    dz1, dz1_c = block("product nt gate", n, eb.product, df2, ffn2_w, "nt", "gate", aux=f1)
    block("column_sums sum", n, eb.column_sums, dz1, "sum", **ch)
    dn2 = block("product nt store", n, eb.product, dz1_c, ffn1_w, "nt")
    _, xhat, rstd = eb.layer_norm_plain(x.float().reshape(n, e), ln2_s, ln2_b, dtype, True)
    block("column_sums ln", n, eb.column_sums, dn2, "ln", x=xhat, **ch)
    block("layer_norm_bwd", n, eb.layer_norm_bwd, dn2, xhat, rstd, ln2_s, dh)
    qkv = randn(n, 3 * e)
    _, p = eb.attention_fwd_plain(qkv, amask, heads, dtype)
    block("attention_bwd", n, eb.attention_bwd, qkv, p, randn(n, e), dtype)
    return worst, failures


def library_grads(torch, layer, x, pad, g):
    """(dx, the 12 weight gradients in the stacked layout) of one
    nn.TransformerEncoderLayer forward + backward."""
    x = x.detach().requires_grad_()
    sa = layer.self_attn
    params = [sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight, sa.out_proj.bias,
              layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
              layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias]
    grads = torch.autograd.grad(layer(x, src_key_padding_mask=pad), [x, *params], g)
    return [grads[0]] + [t.T if t.dim() == 2 else t for t in grads[1:]]


def encoder_bwd_timing(torch, card, e: int = ENC_E) -> dict:
    """Phase 3 for the backward at B=4096, bf16, L=1, rate 0.1: kernel, plain
    version and nn.TransformerEncoderLayer forward + backward minus its
    forward (checked first against the plain version in fp32, every history
    with a real step), CUDA events, beside the bound."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encode_bwd, encode_bwd_plain

    def case(dtype, seed):
        x, amask, pad, ws, _, _, _ = encoder_case(torch, dtype, B_TRAIN, e, ENC_H, 1, seed)
        pad, amask = pad.clone(), amask.clone()
        pad[0], amask[0] = False, 0.0  # no all-pad history: the library's -inf gives NaN there
        return x, amask, pad, ws, encoder_cotangent(torch, pad, e, seed + 1, dtype)

    x, amask, pad, ws, g = case(torch.float32, 5)
    # fp32 accumulation, as cuBLAS sums for the library: a ReLU gate read
    # from a product then falls on the library's side
    want = encode_bwd_plain(g, x, amask, *ws, num_heads=ENC_H, acc=torch.float32)
    layer = library_layer(torch, ws, ENC_H).train()
    lib = library_grads(torch, layer, x, pad, g)
    lib_err = max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(lib, want))
    log(f"[compare] nn.TransformerEncoderLayer fp32 forward + backward vs encode_bwd_plain: "
        f"largest |d|/max|want| over dx and the 12 gradients {lib_err:.3e} (tolerance "
        f"{LIB_TOL:g})")
    if not lib_err <= LIB_TOL:
        raise SystemExit("the library yardstick does not compute the encoder backward's function")

    x, amask, pad, ws, g = case(torch.bfloat16, 6)
    seed = torch.tensor([11], dtype=torch.int64, device="cuda")
    layer = library_layer(torch, ws, ENC_H).train()
    tokens = B_TRAIN * ENC_S
    ops = 3 * 2 * tokens * (12 * e * e + 2 * ENC_S * e)
    nbytes = (3 * 2 * x.numel() + 4 * amask.numel()
              + sum(t.numel() * t.element_size() for t in ws) + 4 * sum(t.numel() for t in ws))
    lib_fwd = time_ms(torch, lambda: layer(x, src_key_padding_mask=pad))
    lib_both = time_ms(torch, lambda: library_grads(torch, layer, x, pad, g))
    kw = dict(num_heads=ENC_H, seed=seed, rate=DROP_RATE)
    t = {
        "ms": time_ms(torch, lambda: encode_bwd(g, x, amask, *ws, **kw)),
        "plain_ms": time_ms(torch, lambda: encode_bwd_plain(g, x, amask, *ws, **kw)),
        **bound(nbytes, ops),
        "library_ms": lib_both - lib_fwd,
    }
    log(f"[time] sasrec_encoder_bwd bf16 B={B_TRAIN} S={ENC_S} E={e} H={ENC_H} L=1 "
        f"rate={DROP_RATE}: {t} (bytes {nbytes}, ops {ops}; library: nn.TransformerEncoderLayer "
        f"bf16 forward + backward {lib_both:.4f} ms minus its forward {lib_fwd:.4f} ms) on {card}")
    kernel_split(torch, lambda: encode_bwd(g, x, amask, *ws, **kw),
                 f"sasrec_encoder_bwd bf16 B={B_TRAIN} E={e} dropout {DROP_RATE}", card)
    return t


WIDE_E = 256  # the recipe sweep's emb_256 and emb_256_tower1024
WIDE_TOWERS = ((1024, 512), (768, 384))  # its tower_1024 and tower_768_384
WIDE_HIDDEN = (1024, 512)  # emb_256_tower1024's tower
MANY_FIELDS, MANY_FIELDS_E = 12, 64  # a model with more fields than the backward keeps in registers


def width_tag(name: str, e: int, hidden) -> str:
    """' E=.. tower (..)' in a log line, empty at the model's own widths."""
    if (e, hidden) == (E, HIDDEN):
        return ""
    return f" E={e}" + (f" tower {hidden}" if name == "fused_score" else "")


def forward_against_plain(torch, worst: dict, e: int, hidden, batches, seed_offset: int = 0,
                          with_fwd: bool = True, f: int = F) -> list:
    """Phase 2 for the forwards at (e, hidden) and f fields: fused_score and
    (with_fwd) interaction_fwd against their plain versions at each batch,
    "all" and "each", bf16 and fp32, within TOL; interaction_fwd's repeat
    bit-identical and, in bf16, within FWD_NORM_TOL, where the same bar must
    reject the V-unrounded control. Updates ``worst``; returns the
    failures."""
    from ctr_recommendation_tpu_torch.ops.cuda import interaction as ki
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_fwd_plain

    failures = []
    fields = f" F={f}" if f != F else ""
    for btype in ("all", "each"):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            for b in batches:
                x, sw, w_bi, tower = kernel_inputs(torch, btype, dtype, b, seed=b + seed_offset,
                                                   e=e, hidden=hidden, f=f)
                kw = dict(bilinear_type=btype)
                cases = {}
                if with_fwd:
                    got, again = (ki.interaction_fwd(x, *sw, w_bi, **kw) for _ in range(2))
                    cases["interaction_fwd"] = (got, ki.interaction_fwd_plain(x, *sw, w_bi, **kw))
                cases["fused_score"] = (
                    score_fwd(x, *sw, w_bi, *tower, **kw),
                    score_fwd_plain(x, *sw, w_bi, *tower, **kw))
                torch.cuda.synchronize()
                for name, (got, want) in cases.items():
                    err, bad, tol = check_close(name, got, want, dn)
                    worst[name] = max(worst[name], err)
                    ok = bad == 0 and bool(torch.isfinite(got).all())
                    more = ""
                    if name == "interaction_fwd":
                        same = torch.equal(got, again)
                        ok = ok and same
                        more = f", repeat bit-identical {same}"
                        if dtype == torch.bfloat16:  # the norm bar, and the control it must reject
                            norm = norm_gap(got, want)
                            w, sc = ki.fwd_gate_plain(x, *sw, **kw)
                            wrong = ki.fwd_pairs_plain(x, w, ki.fwd_project_plain(
                                sc, w_bi, **kw, forward_rounding=False), **kw)
                            c_norm = norm_gap(got, wrong)
                            c_bad = check_close(name, got, wrong, dn)[1]
                            ok = ok and norm <= FWD_NORM_TOL < c_norm
                            verdict = "rejected" if c_norm > FWD_NORM_TOL else "NOT REJECTED"
                            more += (f", |d|/|want| {norm:.3e} (bar {FWD_NORM_TOL:.3e}); "
                                     f"V-unrounded control |d|/|want| {c_norm:.3e}, {c_bad} "
                                     f"elements outside TOL, {verdict}")
                    log(f"[compare] {name}{width_tag(name, e, hidden)}{fields} {btype} {dn} "
                        f"B={b}: max_abs_err={err:.3e} ({tol}){more} "
                        f"{'ok' if ok else f'FAIL ({bad} elements)'}")
                    if not ok:
                        failures.append((name, e, f, hidden, btype, dn, b))
                failures += score_blocks_against_plain(
                    torch, x, sw, w_bi, tower, btype,
                    f"E={e}{fields} tower {hidden} {btype} {dn} B={b}")
    return failures


def score_blocks_against_plain(torch, x, sw, w_bi, tower, btype: str, tag: str) -> list:
    """Phase 2: each building block of the scoring call (ops/cuda/scoring.py)
    against its plain version on the plain version's inputs: the front's
    concat in cd within TOL["interaction_fwd"] (and FWD_NORM_TOL in bf16)
    and bit for bit the interaction kernel's fp32 output rounded to cd (the
    same kernel blocks, the values already in cd); each tower layer within ENC_TOL (and
    ENC_NORM_TOL in bf16), the bars of the same tile product and epilogue in
    the encoder; the head's probabilities within TOL["fused_score"].
    Returns the failures."""
    from ctr_recommendation_tpu_torch.ops.cuda import scoring as ks
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_fwd

    dn = str(x.dtype).split(".")[1]
    c_plain = ks.score_front_plain(x, *sw, w_bi, bilinear_type=btype)
    h1_plain = ks.tower_layer_plain(c_plain, *tower[0:2])
    h2_plain = ks.tower_layer_plain(h1_plain, *tower[2:4])
    c = ks.score_front(x, *sw, w_bi, bilinear_type=btype)
    same = torch.equal(c, interaction_fwd(x, *sw, w_bi, bilinear_type=btype).to(x.dtype))
    got = {"layer 1": (ks.tower_layer(c_plain, *tower[0:2]), h1_plain),
           "layer 2": (ks.tower_layer(h1_plain, *tower[2:4]), h2_plain)}
    head = ks.score_head(h2_plain, *tower[4:6]), ks.score_head_plain(h2_plain, *tower[4:6])
    torch.cuda.synchronize()
    failures = []
    err, bad, tol = check_close("interaction_fwd", c.float(), c_plain.float(), dn)
    norm = norm_gap(c.float(), c_plain.float())
    ok = bad == 0 and same and (dn != "bfloat16" or norm <= FWD_NORM_TOL)
    log(f"[compare] fused_score block front {tag}: max_abs_err={err:.3e} ({tol}), |d|/|want| "
        f"{norm:.3e} (bf16 bar {FWD_NORM_TOL:.3e}), bit-identical to interaction_fwd in cd "
        f"{same} {'ok' if ok else f'FAIL ({bad})'}")
    failures += [] if ok else [("score front", tag)]
    for name, (a, w) in got.items():
        err, rel_norm, ok = check_encoder(torch, a, w, dn)
        log(f"[compare] fused_score block {name} {tag}: max_abs_err={err:.3e}, |d|/|want| "
            f"{rel_norm:.3e} (|d| <= {ENC_TOL[dn][0]:g}*max|want| + {ENC_TOL[dn][1]:g}*|want|"
            f"{f', norm {ENC_NORM_TOL:g}' if dn == 'bfloat16' else ''}) {'ok' if ok else 'FAIL'}")
        failures += [] if ok else [(f"score {name}", tag)]
    err, bad, tol = check_close("fused_score", *head, dn)
    ok = bad == 0 and bool(torch.isfinite(head[0]).all())
    log(f"[compare] fused_score block head {tag}: max_abs_err={err:.3e} ({tol}) "
        f"{'ok' if ok else f'FAIL ({bad})'}")
    return failures + ([] if ok else [("score head", tag)])


def backward_against_plain(torch, worst: dict, e: int, seed_offset: int = 0, f: int = F) -> list:
    """Phase 2 for interaction_bwd at width e (and f fields), B=4096 and
    4133, SENet biases on and off, "all" and "each", bf16 and fp32: within
    BWD_TOL (and the bf16 norm bar), the repeat launch bit-identical, and in
    bf16 the same bars rejecting a control taken at the forward's rounding
    points."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        interaction_bwd,
        interaction_bwd_plain,
    )

    failures = []
    for btype in ("all", "each"):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            for b in (B_TRAIN, B_TRAIN + 37):
                for use_bias in (True, False):
                    g, x, sw, w_bi = backward_inputs(torch, btype, dtype, b,
                                                     b + use_bias + seed_offset, use_bias, e=e,
                                                     f=f)
                    got = interaction_bwd(g, x, *sw, w_bi, bilinear_type=btype)
                    again = interaction_bwd(g, x, *sw, w_bi, bilinear_type=btype)
                    want = interaction_bwd_plain(g, x, *sw, w_bi, bilinear_type=btype)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, c) for a, c in zip(got, again))
                    err, rel_norm, bad = check_backward(torch, got, want, dn)
                    worst["interaction_bwd"] = max(worst["interaction_bwd"], err)
                    ok = same and not bad
                    control = ""
                    if dtype == torch.bfloat16:
                        # the same bar must reject the forward's rounding points
                        wrong = interaction_bwd_plain(g, x, *sw, w_bi, bilinear_type=btype,
                                                      forward_rounding=True)
                        _, c_norm, c_bad = check_backward(torch, got, wrong, dn)
                        ok = ok and bool(c_bad)
                        control = (f"; forward-rounding control |d|/|want| {c_norm:.3e}, "
                                   f"{'rejected' if c_bad else 'NOT REJECTED'} on {c_bad}")
                    log(f"[compare] interaction_bwd{width_tag('interaction_bwd', e, HIDDEN)}"
                        f"{f' F={f}' if f != F else ''} {btype} {dn} B={b} bias={use_bias}: "
                        f"max_abs_err={err:.3e} (|d| <= {BWD_TOL[dn][0]:g}*max|want| + "
                        f"{BWD_TOL[dn][1]:g}*|want|), |d|/|want| {rel_norm:.3e} (bf16 bar "
                        f"{BWD_NORM_TOL:.3e}), repeat bit-identical {same}{control} "
                        f"{'ok' if ok else f'FAIL {bad}'}")
                    if not ok:
                        failures.append(("interaction_bwd", e, f, btype, dn, b, use_bias))
    return failures


def fwd_blocks_against_plain(torch, e: int, btype: str, dtype, b: int = B_RAGGED,
                             f: int = F) -> list:
    """Phase 2: each building block of interaction_fwd (ops/cuda/interaction.py:
    the gate, V = cd(sc W), the pairs) against its plain version on the
    plain version's inputs, at width e (and f fields) on a ragged batch: every output within
    TOL["interaction_fwd"] (and FWD_NORM_TOL in bf16), the block's repeat
    launch bit-identical. Returns the failures."""
    from ctr_recommendation_tpu_torch.ops.cuda import interaction as ki

    dn = str(dtype).split(".")[1]
    x, sw, w_bi, _ = kernel_inputs(torch, btype, dtype, b, b + e + f + 9, e=e, hidden=(8, 8), f=f)
    kw = dict(bilinear_type=btype)
    w, sc = ki.fwd_gate_plain(x, *sw, **kw)
    v = ki.fwd_project_plain(sc, w_bi, **kw)
    cases = {
        "gate": (lambda: ki.fwd_gate(x, *sw, **kw), (w, sc)),
        "project": (lambda: ki.fwd_project(sc, w_bi, **kw), (v,)),
        "pairs": (lambda: ki.fwd_pairs(x, w, v, **kw), (ki.fwd_pairs_plain(x, w, v, **kw),)),
    }
    failures = []
    for name, (kernel, want) in cases.items():
        got, again = kernel(), kernel()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        worst, worst_norm, bad = 0.0, 0.0, []
        for i, (a, wt) in enumerate(zip(got, want)):
            err, n_bad, tol = check_close("interaction_fwd", a.float(), wt.float(), dn)
            norm = norm_gap(a, wt)
            if (a.shape != wt.shape or a.dtype != wt.dtype or not bool(torch.isfinite(a).all())
                    or n_bad or (dn == "bfloat16" and norm > FWD_NORM_TOL)):
                bad.append(i)
            worst, worst_norm = max(worst, err), max(worst_norm, norm)
        ok = same and not bad
        log(f"[compare] interaction_fwd block {name} E={e} F={f} {btype} {dn} B={b}: "
            f"max_abs_err={worst:.3e} ({tol}), |d|/|want| {worst_norm:.3e} (bf16 bar "
            f"{FWD_NORM_TOL:.3e}), repeat bit-identical {same} "
            f"{'ok' if ok else f'FAIL outputs {bad}'}")
        if not ok:
            failures.append(("interaction_fwd block", name, e, f, btype, dn))
    return failures


def bwd_blocks_against_plain(torch, e: int, btype: str, dtype, b: int = B_TRAIN + 37,
                             f: int = F) -> list:
    """Phase 2: each building block of interaction_bwd (ops/cuda/interaction.py:
    the gate, V, the pairs, the projection term dvc W^T, the gate backward
    and dx, dW_bi's partials, the reduction) against its plain version on the plain
    version's inputs, at width e (and f fields) on a ragged batch: every output within
    BWD_TOL (and BWD_NORM_TOL in bf16), the block's repeat launch
    bit-identical. Returns the failures."""
    from ctr_recommendation_tpu_torch.ops.cuda import interaction as ki

    dn = str(dtype).split(".")[1]
    g, x, sw, w_bi = backward_inputs(torch, btype, dtype, b, b + e + 5, True, e=e, f=f)
    w1, _, w2, _ = sw
    kw = dict(bilinear_type=btype)
    z, h1, w, sc = ki.bwd_gate_plain(x, *sw, **kw)
    v = ki.bwd_project_plain(sc, w_bi, **kw)
    ds, dvc = ki.bwd_pairs_plain(g, x, w, v, **kw)
    p = ki.bwd_project_t_plain(dvc, w_bi, **kw)
    dx, part_gate = ki.bwd_gate_dx_plain(ds, p, x, z, h1, w, w1, w2, **kw)
    part_bi = ki.bwd_weight_grad_plain(sc, dvc, **kw)
    cases = {
        "gate": (lambda: ki.bwd_gate(x, *sw, **kw), (z, h1, w, sc)),
        "project": (lambda: ki.bwd_project(sc, w_bi, **kw), v),
        "pairs": (lambda: ki.bwd_pairs(g, x, w, v, **kw), (ds, dvc)),
        "project_t": (lambda: ki.bwd_project_t(dvc, w_bi, **kw), p),
        "gate_dx": (lambda: ki.bwd_gate_dx(ds, p, x, z, h1, w, w1, w2, **kw), (dx, part_gate)),
        "weight_grad": (lambda: ki.bwd_weight_grad(sc, dvc, **kw), part_bi),
        "reduce": (lambda: ki.bwd_reduce(part_bi, part_gate),
                   ki.bwd_reduce_plain(part_bi, part_gate)),
    }
    share, rtol = BWD_TOL[dn]
    failures = []
    for name, (kernel, want) in cases.items():
        want = want if isinstance(want, tuple) else (want,)
        got, again = kernel(), kernel()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        worst, worst_norm, bad = 0.0, 0.0, []
        for i, (a, wt) in enumerate(zip(got, want)):
            a, wt = a.double(), wt.double()
            err = (a - wt).abs()
            rel_norm = (err.norm() / wt.norm().clamp(min=1e-30)).item()
            if (a.shape != wt.shape or not bool(torch.isfinite(a).all())
                    or bool((err > share * wt.abs().max() + rtol * wt.abs()).any())
                    or (dn == "bfloat16" and rel_norm > BWD_NORM_TOL)):
                bad.append(i)
            worst, worst_norm = max(worst, err.max().item()), max(worst_norm, rel_norm)
        ok = same and not bad
        log(f"[compare] interaction_bwd block {name} E={e} F={f} {btype} {dn} B={b}: "
            f"max_abs_err={worst:.3e} (|d| <= {share:g}*max|want| + {rtol:g}*|want|), "
            f"|d|/|want| {worst_norm:.3e} (bf16 bar {BWD_NORM_TOL:.3e}), repeat bit-identical "
            f"{same} {'ok' if ok else f'FAIL outputs {bad}'}")
        if not ok:
            failures.append(("interaction_bwd block", name, e, f, btype, dn))
    return failures


def fwd_split(torch, card, x, sw, w_bi, tag: str) -> None:
    """Phase 3: one bf16 interaction_fwd call ("all", B=8192) split into its
    three blocks, each timed alone with CUDA events (wrapper included), and
    torch.profiler's split of the whole call."""
    from ctr_recommendation_tpu_torch.ops.cuda import interaction as ki

    w, sc = ki.fwd_gate(x, *sw)
    v = ki.fwd_project(sc, w_bi)
    t = {"gate": time_ms(torch, lambda: ki.fwd_gate(x, *sw)),
         "project": time_ms(torch, lambda: ki.fwd_project(sc, w_bi)),
         "pairs": time_ms(torch, lambda: ki.fwd_pairs(x, w, v))}
    log(f"[split] interaction_fwd bf16 all{tag} B={B_FULL}: ms a block {t} on {card}")
    kernel_split(torch, lambda: ki.interaction_fwd(x, *sw, w_bi),
                 f"interaction_fwd bf16 all{tag} B={B_FULL}", card)


def bwd_split(torch, card, g, x, sw, w_bi, tag: str) -> None:
    """Phase 3: one bf16 interaction_bwd call ("all") split into its seven
    blocks, each timed alone with CUDA events (wrapper included), and
    torch.profiler's split of the whole call."""
    from ctr_recommendation_tpu_torch.ops.cuda import interaction as ki

    w1, _, w2, _ = sw
    z, h1, w, sc = ki.bwd_gate(x, *sw)
    v = ki.bwd_project(sc, w_bi)
    ds, dvc = ki.bwd_pairs(g, x, w, v)
    p = ki.bwd_project_t(dvc, w_bi)
    _, part_gate = ki.bwd_gate_dx(ds, p, x, z, h1, w, w1, w2)
    part_bi = ki.bwd_weight_grad(sc, dvc)
    t = {"gate": time_ms(torch, lambda: ki.bwd_gate(x, *sw)),
         "project": time_ms(torch, lambda: ki.bwd_project(sc, w_bi)),
         "pairs": time_ms(torch, lambda: ki.bwd_pairs(g, x, w, v)),
         "project_t": time_ms(torch, lambda: ki.bwd_project_t(dvc, w_bi)),
         "gate_dx": time_ms(torch, lambda: ki.bwd_gate_dx(ds, p, x, z, h1, w, w1, w2)),
         "weight_grad": time_ms(torch, lambda: ki.bwd_weight_grad(sc, dvc)),
         "reduce": time_ms(torch, lambda: ki.bwd_reduce(part_bi, part_gate))}
    log(f"[split] interaction_bwd bf16 all{tag} B={B_TRAIN}: ms a block {t} on {card}")
    kernel_split(torch, lambda: ki.interaction_bwd(g, x, *sw, w_bi),
                 f"interaction_bwd bf16 all{tag} B={B_TRAIN}", card)


def mm_timing(torch, card, e: int, hidden, with_interaction: bool = True) -> dict:
    """Phase 3 for the MM-FiBiNET kernels at (e, hidden), bf16: fused_score
    and (with_interaction) interaction_fwd at B=8192 and interaction_bwd at
    B=4096, kernel and plain version with CUDA events beside the bound from
    the run's shapes (each input read once, each output written once).
    Returns {(name, btype): times}."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        interaction_bwd,
        interaction_bwd_expr,
        interaction_bwd_plain,
        interaction_fwd,
        interaction_fwd_plain,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_fwd_plain

    cdim = (F + F * (F - 1) // 2) * e
    h1, h2 = hidden
    timing = {}
    for btype in ("all", "each"):
        x, sw, w_bi, tower = kernel_inputs(torch, btype, torch.bfloat16, B_FULL, seed=1,
                                           e=e, hidden=hidden)
        w_bytes = 4 * sum(t.numel() for t in sw) + 2 * w_bi.numel()
        inter_ops = 2 * B_FULL * (F - 1) * e * e  # the F-1 projections the pairs use
        runs = [("fused_score",
                 lambda: score_fwd(x, *sw, w_bi, *tower, bilinear_type=btype),
                 lambda: score_fwd_plain(x, *sw, w_bi, *tower, bilinear_type=btype),
                 2 * x.numel() + w_bytes + sum(t.numel() * t.element_size() for t in tower)
                 + 4 * B_FULL,
                 inter_ops + 2 * B_FULL * (cdim * h1 + h1 * h2 + h2))]
        if with_interaction:
            runs.insert(0, ("interaction_fwd",
                            lambda: interaction_fwd(x, *sw, w_bi, bilinear_type=btype),
                            lambda: interaction_fwd_plain(x, *sw, w_bi, bilinear_type=btype),
                            2 * x.numel() + w_bytes + 4 * B_FULL * cdim, inter_ops))
        for name, kern, plain, nbytes, ops in runs:
            timing[(name, btype)] = t = {"ms": time_ms(torch, kern),
                                         "plain_ms": time_ms(torch, plain), **bound(nbytes, ops)}
            log(f"[time] {name} bf16 {btype}{width_tag(name, e, hidden)} B={B_FULL}: {t} "
                f"(bytes {nbytes}, ops {ops}) on {card}")
        if btype == "all":
            score_split(torch, card, x, sw, w_bi, tower, width_tag("fused_score", e, hidden))
            if with_interaction:
                fwd_split(torch, card, x, sw, w_bi, width_tag("interaction_fwd", e, hidden))
        del x, sw, w_bi, tower
    if not with_interaction:
        return timing
    for btype in ("all", "each"):  # the backward at the training batch
        g, x, sw, w_bi = backward_inputs(torch, btype, torch.bfloat16, B_TRAIN, 2, True, e=e)
        nq = 1 if btype == "all" else F - 1
        # g read, x read, dx written, weights read and their gradients written
        nbytes = (4 * g.numel() + 2 * 2 * x.numel() + 4 * sum(t.numel() for t in sw)
                  + 2 * w_bi.numel() + 4 * (nq * e * e + sum(t.numel() for t in sw)))
        ops = 6 * B_TRAIN * (F - 1) * e * e  # v, dv W^T and s^T dv for F-1 fields
        timing[("interaction_bwd", btype)] = t = {
            "ms": time_ms(torch, lambda: interaction_bwd(g, x, *sw, w_bi, bilinear_type=btype)),
            "plain_ms": time_ms(
                torch, lambda: interaction_bwd_plain(g, x, *sw, w_bi, bilinear_type=btype)),
            **bound(nbytes, ops),
        }
        expr_ms = time_ms(
            torch, lambda: interaction_bwd_expr(g, x, *sw, w_bi, bilinear_type=btype))
        log(f"[time] interaction_bwd bf16 {btype}{width_tag('interaction_bwd', e, HIDDEN)} "
            f"B={B_TRAIN}: {t} (bytes {nbytes}, ops {ops}; plain_ms: the seven blocks' plain "
            f"versions composed; the single expression interaction_bwd_expr: {expr_ms:.4f} ms) "
            f"on {card}")
        if btype == "all":
            bwd_split(torch, card, g, x, sw, w_bi, width_tag("interaction_bwd", e, HIDDEN))
    return timing


def score_split(torch, card, x, sw, w_bi, tower, tag: str) -> None:
    """Phase 3: one bf16 scoring call at B=8192 split into its blocks, each
    timed alone with CUDA events (wrapper included), and torch.profiler's
    split of the whole call (both layers are one kernel there); beside layer
    1, cuBLAS on the same product, c @ W1 in bf16 without bias or ReLU: a
    yardstick of the product stage that the port never calls."""
    from ctr_recommendation_tpu_torch.ops.cuda import scoring as ks

    c = ks.score_front(x, *sw, w_bi)
    h1 = ks.tower_layer(c, *tower[0:2])
    h2 = ks.tower_layer(h1, *tower[2:4])
    t = {"front": time_ms(torch, lambda: ks.score_front(x, *sw, w_bi)),
         "layer 1": time_ms(torch, lambda: ks.tower_layer(c, *tower[0:2])),
         "layer 2": time_ms(torch, lambda: ks.tower_layer(h1, *tower[2:4])),
         "head": time_ms(torch, lambda: ks.score_head(h2, *tower[4:6])),
         "cuBLAS c @ W1": time_ms(torch, lambda: torch.matmul(c, tower[0]))}
    log(f"[split] fused_score bf16 all{tag} B={B_FULL}: ms a block {t} on {card}")
    kernel_split(torch, lambda: ks.score_fwd(x, *sw, w_bi, *tower),
                 f"fused_score bf16 all{tag} B={B_FULL}", card)


def train_and_serve(torch, exp, train, valid, store, root, card, counted, per_step: dict,
                    per_eval: dict, per_serve: dict, tag: str = "", fused: bool = True) -> dict:
    """Phases 6-7 (and 6b-6g) for one model at the full microlens_experiment()
    defaults on phase 6's splits: one step's fp32 gradients kernel vs plain
    with dropout on (``fused`` False, the zoo, whose path holds no kernel:
    the card's step vs the CPU's, dropout off), fit_on_device for 2 epochs
    (loss finite and falling, best valid AUC > 0.6, a resume point and the
    best export written), the step split and profile, then the best export
    served through Predictor at the trainer's AUC, on the fused scoring
    branch if ``fused``, else on the model's eval forward. ``counted`` are
    the wrappers whose launches are checked exactly; ``per_step``,
    ``per_eval`` and ``per_serve`` give each one's launches a train step, an
    eval batch and a serving batch (absent: 0). ``tag`` names the run in the
    log (default: the model's name). Returns the launches of each counted
    wrapper in the fit (``launches``), the fit's history (``hist``), its
    best valid AUC, the step split's numbers (``step``), the gradient
    check's worst gap (``grad_gap``), the serving Predictor (``server``)
    and the AUC evaluate gave its export (``served_auc``)."""
    from ctr_recommendation_tpu_torch.cli.evaluate import eval_line, evaluate
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        bwd_launches as inter_bwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        fwd_launches as inter_fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_launches
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.training import Trainer
    from ctr_recommendation_tpu_torch.training.metrics import auc, group_auc

    tag = tag or exp.model.model
    grad_gap = gradient_check(torch, exp, train, store, root, per_step, tag,
                              against_cpu=not fused)[-1]
    bs = exp.train.batch_size
    steps = TRAIN_EPOCHS * (N_TRAIN // bs)
    eval_batches = TRAIN_EPOCHS * -(-N_VALID // exp.train.eval_batch_size)
    trainer = Trainer(exp, steps_per_epoch=N_TRAIN // bs, item_store=store, log_fn=log)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    hist = trainer.fit_on_device(train, valid)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launched = {fn: fn.launches for fn in counted}
    expect = {fn: per_step.get(fn, 0) * steps + per_eval.get(fn, 0) * eval_batches
              for fn in counted}
    for h in hist:
        log(f"[train {tag}] epoch {int(h['epoch'])}: loss {h['train_loss']:.5f}, valid auc "
            f"{h['auc']:.5f}, {h['examples_per_sec']:.0f} examples/s ({h['seconds']:.3f} s "
            f"train, {h['eval_seconds']:.3f} s eval) on {card}")
    best_auc = max(h["auc"] for h in hist)
    names = lambda d: {fn.__name__: n for fn, n in d.items()}  # noqa: E731
    log(f"[train {tag}] fit_on_device: {steps} steps + {eval_batches} eval batches in "
        f"{t_fit:.3f} s; best valid auc {best_auc:.5f}; launches {names(launched)}, expected "
        f"{names(expect)} (launches a call: interaction_fwd {inter_fwd_launches()}, "
        f"interaction_bwd {inter_bwd_launches()}, fused_score {score_launches()}, "
        f"encode_fwd 1 + 7 L, encode_bwd 25 L + 1)")
    losses = [h["train_loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"{tag}: training loss not finite and falling: {losses}")
    if not best_auc > 0.6:
        raise SystemExit(f"{tag}: best valid AUC {best_auc} is not above 0.6")
    if launched != expect:
        raise SystemExit(f"{tag}: fit launches {names(launched)}, expected {names(expect)}")
    export = trainer.ckpt.best_export_path
    if trainer.ckpt.latest_step() != TRAIN_EPOCHS or not os.path.exists(export):
        raise SystemExit(f"{tag}: fit_on_device wrote no resume point or no best export")
    step = step_split(torch, trainer, train, card, tag)

    served_params, served_state = jax_bridge.params_from_jax(
        *jax_bridge.load(export), trainer.fm, exp.model)
    server = Predictor(exp, served_params, served_state, item_store=store)
    for fn in counted:
        fn.launches = 0
    res = evaluate(server, valid, batch_size=B_FULL, gauc_col="user_id")
    served = {fn: fn.launches for fn in counted}
    n_batches = -(-N_VALID // B_FULL)
    probs = res["probs"]
    served_auc = auc(torch.from_numpy(valid.columns["label"]), torch.from_numpy(probs)).item()
    cpu_gauc = group_auc(valid.columns["label"], probs, valid.columns["user_id"], device="cpu")
    log(f"[serve {tag}] {eval_line(res, 'user_id')} on {card}")
    log(f"[serve {tag}] best export through evaluate (Predictor): valid auc {res['auc']:.7f}, "
        f"over its probabilities on the CPU {served_auc:.7f}, the trainer's {best_auc:.5f} "
        f"(tolerance {AUC_SERVE_TOL}); gAUC[user_id] {res['gauc']:.7f}, on the CPU "
        f"{cpu_gauc:.7f}, |d| {abs(res['gauc'] - cpu_gauc):.1e} (tolerance {GAUC_TOL}); "
        f"launches {names(served)}")
    if server.use_fused != fused or served != {fn: per_serve.get(fn, 0) * n_batches
                                               for fn in counted}:
        raise SystemExit(f"{tag}: serving the export did not take the expected branch "
                         f"(fused {fused}) and launches")
    if res["rows"] != N_VALID or res["auc"] != served_auc:
        raise SystemExit(f"{tag}: evaluate's AUC is not the served probabilities' AUC")
    if abs(served_auc - best_auc) > AUC_SERVE_TOL:
        raise SystemExit(f"{tag}: the served export disagrees with the trainer's eval")
    if not np.isfinite(res["logloss"]) or abs(res["gauc"] - cpu_gauc) > GAUC_TOL:
        raise SystemExit(f"{tag}: evaluate's logloss is not finite or its gAUC is not the CPU's")
    return {"launches": launched, "hist": hist, "best_auc": best_auc, "step": step,
            "grad_gap": grad_gap, "server": server, "served_auc": res["auc"]}


def serve_sasrec(torch, store, rows, card) -> int:
    """The sasrec_fibinet serving path at the full microlens_experiment()
    defaults: score_table, the pipeline, the CPU Predictor and the unfused
    branch, with exact launch counts. Returns the pipeline's encoder launches."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import TableData
    from ctr_recommendation_tpu_torch.data.device_store import device_join
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor, run_submission_pipeline
    from ctr_recommendation_tpu_torch.models import build_model, trunk
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        fwd_launches as inter_fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        encode_fwd,
        encoder_inputs,
        fwd_launches,
        stack_weights,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches

    exp = microlens_experiment(data_root="", model="sasrec_fibinet")
    per = fwd_launches(exp.model.attn_num_layers)  # the encoder's launches a batch
    per_score = score_launches()  # the scoring call's
    fm = build_feature_map(exp.dataset)
    _, params, state = build_model(fm, exp.model, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(8)
    for st in state["mlp"]["layers"]:  # BatchNorm stats off init: the fold is real
        d = st["bn_mean"].shape[0]
        st["bn_mean"] = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32))
        st["bn_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    pred = Predictor(exp, params, state, item_store=store)
    if not pred.use_fused:
        raise SystemExit("sasrec_fibinet at its defaults must take the fused branch")
    n_batches = N_ROWS // B_FULL
    head = {k: v[:B_FULL] for k, v in rows.items()}

    def counts():
        return encode_fwd.launches, score_fwd.launches, interaction_fwd.launches

    pred.score_table(TableData(head, B_FULL), B_FULL)  # warm-up
    torch.cuda.synchronize()
    encode_fwd.launches = score_fwd.launches = interaction_fwd.launches = 0
    t0 = time.perf_counter()
    bulk = pred.score_table(TableData(rows, N_ROWS), B_FULL)
    t_bulk = time.perf_counter() - t0
    log(f"[sasrec] score_table: {N_ROWS} rows in {t_bulk:.4f} s = {N_ROWS / t_bulk:.0f} rows/s "
        f"on {card}; launches (encode_fwd, fused_score, interaction_fwd) {counts()}")
    if counts() != (n_batches * per, n_batches * per_score, 0):
        raise SystemExit(f"sasrec score_table launches {counts()}, expected "
                         f"({n_batches * per}, {n_batches * per_score}, 0)")
    if bulk.shape != (N_ROWS,) or not ((bulk > 0) & (bulk < 1)).all():
        raise SystemExit("sasrec score_table probabilities not in (0, 1) of shape (N,)")

    with tempfile.TemporaryDirectory() as out_dir:
        chunks = ({k: v[s : s + CHUNK_ROWS] for k, v in rows.items()}
                  for s in range(0, N_ROWS, CHUNK_ROWS))
        encode_fwd.launches = score_fwd.launches = interaction_fwd.launches = 0
        t0 = time.perf_counter()
        written, csv_path, zip_path = run_submission_pipeline(
            chunks, pred, out_dir, batch_size=B_FULL, chunk_rows=CHUNK_ROWS)
        t_pipe = time.perf_counter() - t0
        pipe_launches = counts()
        log(f"[sasrec] pipeline: {written} rows in {t_pipe:.4f} s = {written / t_pipe:.0f} "
            f"rows/s to CSV+zip on {card}; launches {pipe_launches}")
        if pipe_launches != (n_batches * per, n_batches * per_score, 0):
            raise SystemExit(f"sasrec pipeline launches {pipe_launches}")
        check_submission(written, csv_path, zip_path, bulk, "sasrec")

    # the encoder's share of one batch (CUDA events)
    batch = {k: torch.as_tensor(v).cuda() for k, v in head.items()}
    feats = device_join(dict(batch), pred._mm_tables, pred._join_plan)
    tables = pred.params["trunk"]["tables"]
    seq_emb = trunk.gather(tables[fm.table_of["item_seq"]], feats["item_seq"]).to(
        pred.compute_dtype)
    attn_params = pred.params["trunk"]["attn"]["item_seq"]
    x, amask, _ = encoder_inputs(attn_params, seq_emb, feats["item_seq"])
    ws = stack_weights(attn_params, x.dtype)
    with torch.inference_mode():
        split = {
            "whole step": time_ms(torch, lambda: pred._score(batch)),
            "join + trunk (encoder included)": time_ms(torch, lambda: trunk.apply(
                pred.params["trunk"], fm, exp.model, device_join(dict(batch), pred._mm_tables,
                                                                 pred._join_plan),
                seq_pooling="attention", compute_dtype=pred.compute_dtype)),
            "encoder kernel": time_ms(torch, lambda: encode_fwd(x, amask, *ws,
                                                                num_heads=ENC_H)),
        }
    log(f"[breakdown] sasrec_fibinet device ms per {B_FULL}-row batch: {split} on {card}")

    cpu_pred = Predictor(exp, params, state, item_store=store, device="cpu")
    cpu_probs = cpu_pred.score_table(TableData(head, B_FULL), B_FULL)
    cpu_err = float(np.abs(cpu_probs - bulk[:B_FULL]).max())
    log(f"[sasrec] first {B_FULL} rows vs the CPU Predictor: max_abs_err={cpu_err:.3e} "
        f"(tolerance {CPU_TOL})")
    if cpu_err > CPU_TOL:
        raise SystemExit("sasrec: card and CPU Predictor disagree")

    unfused = Predictor(exp, params, state, item_store=store, fold_bn=False)
    n_unfused = 4
    encode_fwd.launches = score_fwd.launches = interaction_fwd.launches = 0
    got = np.concatenate([
        unfused({k: v[i * B_FULL : (i + 1) * B_FULL] for k, v in rows.items()}).cpu().numpy()
        for i in range(n_unfused)
    ])
    unfused_err = float(np.abs(got - bulk[: n_unfused * B_FULL]).max())
    log(f"[sasrec unfused] {n_unfused} batches: launches (encode_fwd, fused_score, "
        f"interaction_fwd) {counts()}, max_abs_err vs fused {unfused_err:.3e} "
        f"(tolerance {CPU_TOL})")
    if counts() != (n_unfused * per, 0, n_unfused * inter_fwd_launches()):
        raise SystemExit("the sasrec unfused branch did not run encoder + interaction once a batch")
    if unfused_err > CPU_TOL:
        raise SystemExit("sasrec unfused and fused branches disagree")
    return pipe_launches[0]


SPARSE_KINDS = ("adagrad", "rowwise_adagrad", "adam")
# the vocab / ids ratio (training/sparse.py GATHERED_MIN_VOCAB_RATIO) that
# forces every table onto each strategy, as the JAX package's tests force it
FORCE_STRATEGY = {"gathered": 0.0, "masked_dense": 1e12}
# weight decay 0, fp32: gathered vs masked-dense after one step, and sparse
# adagrad vs the dense adagrad chain on the tables (the JAX package's bar,
# tests/test_sparse.py:390); the two differ in the order of the row sums
SPARSE_TOL = 2e-5


def table_floor_bytes(kind: str, rows: int, e: int) -> int:
    """Bytes a touched-rows update must move: per touched row the gradient
    read, each table and state row read once and written once."""
    floats = {"adagrad": 5 * e, "rowwise_adagrad": 3 * e + 2, "adam": 7 * e}[kind]
    return rows * floats * 4


def id_feats(tr, batch) -> dict:
    """The batch's features as the lookup reads them (joined, hashed)."""
    return tr._device_join({k: v for k, v in batch.items() if k != tr.fm.label})


def touched_rows(torch, tr, batch) -> dict:
    """table -> bool mask of the rows the batch reads (with the pad row 0,
    which the gathered strategy forces in)."""
    from ctr_recommendation_tpu_torch.config.schema import FeatureType
    from ctr_recommendation_tpu_torch.models.trunk import table_rows

    feats = id_feats(tr, batch)
    tables = tr.state.params["trunk"]["tables"]
    out = {}
    for f in tr.fm.features:
        if f.name in feats and f.type in (FeatureType.CATEGORICAL, FeatureType.SEQUENCE):
            t = tr.fm.table_of[f.name]
            n = tables[t].shape[0]
            m = out.setdefault(t, torch.zeros(n, dtype=torch.bool, device="cuda"))
            m[0] = True
            m[table_rows(feats[f.name], n).reshape(-1)] = True
            m[feats[f.name].to(torch.int64).clamp(0, n - 1).reshape(-1)] = True
    return out


def sparse_steps(torch, train, store, root, card, kernels: dict) -> None:
    """Phase 6e, one step per kind and forced strategy at the full defaults
    (fp32, TF32 off, weight decay 0, B=4096): kernel vs plain gradients,
    remap_batch and the update under set_sync_debug_mode("error"), untouched
    rows of every table and its state bit for bit unchanged, the table
    updates timed beside their byte floor; then gathered vs masked-dense, and
    sparse adagrad vs the dense adagrad chain, within SPARSE_TOL."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.training import Trainer, sparse

    after = {}  # (kind, strategy) -> {path: param after the step}
    default_ratio = sparse.GATHERED_MIN_VOCAB_RATIO
    try:
        for kind in SPARSE_KINDS:
            # adagrad on the dense adagrad chain at the shared lr: the dense-chain check
            extra = {"optimizer": "adagrad", "table_lr_scale": 1.0} if kind == "adagrad" else {}
            exp = microlens_experiment(data_root="", table_optimizer=kind, weight_decay=0.0,
                                       checkpoint_dir=os.path.join(root, f"sparse_{kind}"),
                                       **extra)
            for strategy, ratio in FORCE_STRATEGY.items():
                sparse.GATHERED_MIN_VOCAB_RATIO = ratio
                tag = f"sparse {kind} {strategy}"
                tr, batch, aux, grads, _ = gradient_check(torch, exp, train, store, root,
                                                          kernels, tag)
                tables, tstate = tr.state.params["trunk"]["tables"], tr.state.table_opt_state
                gathered = sorted(aux.uids)
                if gathered != (sorted(tables) if strategy == "gathered" else []):
                    raise SystemExit(f"{tag}: gathered tables {gathered}")
                before = {t: (v.detach().clone(), {k: x.clone() for k, x in tstate[t].items()})
                          for t, v in tables.items()}
                touched = touched_rows(torch, tr, batch)
                feats = id_feats(tr, batch)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:  # raises on any host sync
                    sparse.remap_batch(tr.fm, feats, tables, only=gathered)
                    tr.apply_gradients(grads, aux)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                for t, (tab0, st0) in before.items():
                    keep = ~touched[t]
                    pairs = [("table", tables[t].detach(), tab0)] + [
                        (k, tstate[t][k], st0[k]) for k in st0]
                    for name, new, old in pairs:
                        if not torch.equal(new[keep], old[keep]):
                            raise SystemExit(f"{tag}: untouched rows of {t}/{name} moved")
                    moved = int((tables[t].detach() != tab0).any(-1).sum())
                    log(f"[sparse] {tag}: table {t}: {int(touched[t].sum())} rows touched of "
                        f"{keep.numel()}, {moved} moved, {int(keep.sum())} untouched rows of the "
                        f"table and of {sorted(st0)} bit for bit unchanged; remap_batch and the "
                        f"update raised no host sync")
                after[(kind, strategy)] = {p: v.detach().clone() for p, v in tr.param_paths.items()}
                g = dict(zip(aux.targets, grads))
                for t in sorted(tables):
                    if t in aux.uids:
                        fn = lambda t=t: tr.table_opt.update(  # noqa: E731
                            {t: tables[t]}, tstate, aux.uids, {t: g["rows/" + t]}, tr.state.step)
                    else:
                        fn = lambda t=t: tr.table_opt.update_dense(  # noqa: E731
                            {t: tables[t]}, tstate, {t: g["trunk/tables/" + t]}, tr.state.step)
                    ms = time_ms(torch, fn, reps=20)
                    rows = int(touched[t].sum())
                    floor = table_floor_bytes(kind, rows, E) / HBM_BYTES_PER_S * 1e3
                    log(f"[sparse time] {kind} {strategy} table {t} ({tables[t].shape[0]} rows, "
                        f"{rows} touched): update {ms:.4f} ms, byte floor {floor:.4f} ms "
                        f"({table_floor_bytes(kind, rows, E)} bytes at 3.35 TB/s), "
                        f"{ms / floor:.1f}x on {card}")
                if gathered:
                    ms = time_ms(torch, lambda: sparse.remap_batch(tr.fm, feats, tables,
                                                                   only=gathered), reps=20)
                    n_ids = sum(feats[f].numel() for f in tr.fm.table_of if f in feats)
                    log(f"[sparse time] {kind} gathered: remap_batch (the dedup of {n_ids} ids "
                        f"into {gathered}) {ms:.4f} ms on {card}")
                del tr, aux, grads
    finally:
        sparse.GATHERED_MIN_VOCAB_RATIO = default_ratio

    def worst(a, b):
        return max((a[p] - b[p]).abs().max().item() for p in a)

    for kind in SPARSE_KINDS:
        d = worst(after[(kind, "gathered")], after[(kind, "masked_dense")])
        log(f"[sparse] {kind}: gathered vs masked_dense after one step, every parameter: "
            f"max|d| {d:.3e} (tolerance {SPARSE_TOL})")
        if d > SPARSE_TOL:
            raise SystemExit(f"sparse {kind}: the two strategies disagree")
    # the dense adagrad chain on every table, the same step
    exp = microlens_experiment(data_root="", optimizer="adagrad", weight_decay=0.0,
                               compute_dtype="float32",
                               checkpoint_dir=os.path.join(root, "sparse_dense_chain"))
    bs = exp.train.batch_size
    dense = Trainer(exp, steps_per_epoch=N_TRAIN // bs, item_store=store, log_fn=lambda s: None)
    dense.train_step({k: torch.as_tensor(v[:bs]).cuda() for k, v in train.columns.items()})
    want = {p: v.detach() for p, v in dense.param_paths.items() if p.startswith("trunk/tables/")}
    for strategy in FORCE_STRATEGY:
        d = worst(want, after[("adagrad", strategy)])
        log(f"[sparse] adagrad {strategy} vs the dense adagrad chain, the tables after one step: "
            f"max|d| {d:.3e} (tolerance {SPARSE_TOL})")
        if d > SPARSE_TOL:
            raise SystemExit(f"sparse adagrad {strategy} disagrees with the dense chain")


def sparse_fits(torch, train, valid, store, root, card, counted, per_step, per_eval, per_serve,
                dense: dict) -> None:
    """Phase 6e, the two fits through train_and_serve, then each beside the
    dense mm_fibinet run (``dense``) of this call."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.models.trunk import round_up_vocab
    from ctr_recommendation_tpu_torch.training import sparse

    runs = {"mm_fibinet": dense}
    for tag, kw, item_strategy in (
            ("mm_fibinet_rowwise_adagrad", {"table_optimizer": "rowwise_adagrad"}, "masked_dense"),
            ("mm_fibinet_lazy_adam_b1024", {"table_optimizer": "adam", "batch_size": 1024},
             "gathered")):
        exp = microlens_experiment(data_root="", epochs=TRAIN_EPOCHS,
                                   checkpoint_dir=os.path.join(root, f"ckpt_{tag}"), **kw)
        fm = build_feature_map(exp.dataset)
        bs = exp.train.batch_size
        ids = {}  # ids a step per table, the forced pad id included
        for f in fm.features:
            if f.name in fm.table_of:
                t = fm.table_of[f.name]
                ids[t] = ids.get(t, 1) + bs * (f.max_len or 1)
        vocab = {t.name: round_up_vocab(t.vocab_size) for t in fm.tables}
        plan = {t: sparse.choose_strategy(vocab[t], n) for t, n in ids.items()}
        log(f"[sparse] {tag}: batch {bs}, table rows {vocab}, ids a step {ids}: {plan}")
        if plan["item_id"] != item_strategy:
            raise SystemExit(f"{tag}: the item table takes {plan['item_id']}")
        runs[tag] = train_and_serve(torch, exp, train, valid, store, root, card, counted,
                                    per_step=per_step, per_eval=per_eval, per_serve=per_serve,
                                    tag=tag)
    for tag, r in runs.items():
        eps = [round(h["examples_per_sec"]) for h in r["hist"]]
        log(f"[sparse] {tag}: best valid auc {r['best_auc']:.5f}, examples/s per epoch {eps}, "
            f"one step {r['step']['step_ms']:.4f} ms wall, device busy "
            f"{r['step']['busy_ms']:.4f} ms a step, on {card}")


def device_intervals(prof) -> list[tuple]:
    """(category, stream, start µs, end µs) of each kernel, memcpy and memset
    on the card in a torch.profiler trace (its Chrome trace's events)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(e["cat"], e.get("args", {}).get("stream"), e["ts"], e["ts"] + e["dur"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def merged(spans) -> list[tuple]:
    """The union of (start, end) spans, as sorted disjoint spans."""
    out: list[list] = []
    for a, z in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return [tuple(x) for x in out]


def overlap(spans, union) -> float:
    """Total length of ``spans`` that lies inside the disjoint ``union``."""
    return sum(max(0.0, min(z, uz) - max(a, ua)) for a, z in spans for ua, uz in union)


def time_steps(torch, step, card, tag: str, warm: int) -> dict:
    """A train loop's steps: ``warm`` steps, then FIT_STEPS_TIMED on the host
    clock (ending in a synchronize), then FIT_STEPS_TIMED under
    torch.profiler: wall and device-busy ms a step (the union of the card's
    intervals), kernels a step, and the host-to-device copies: their stream
    beside the kernels', their ms a step and the share of it that overlaps a
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FIT_STEPS_TIMED):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / FIT_STEPS_TIMED * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(FIT_STEPS_TIMED):
            step()
        torch.cuda.synchronize()
    ev = device_intervals(prof)
    n = FIT_STEPS_TIMED
    kernels = [(st, a, z) for cat, st, a, z in ev if cat == "kernel"]
    copies = [(st, a, z) for cat, st, a, z in ev if cat == "gpu_memcpy"]
    busy = sum(z - a for a, z in merged([(a, z) for _, _, a, z in ev])) / n / 1e3
    kernel_streams = sorted({st for st, _, _ in kernels})
    copy_streams = sorted({st for st, _, _ in copies})
    copy_ms = sum(z - a for _, a, z in copies) / n / 1e3
    inside = overlap([(a, z) for _, a, z in copies], merged([(a, z) for _, a, z in kernels]))
    share = inside / max(sum(z - a for _, a, z in copies), 1e-9)
    log(f"[fit {tag}] a step: {wall:.4f} ms wall (host clock, {n} steps), device busy "
        f"{busy:.4f} ms ({busy / wall:.3f} of it; torch.profiler, {n} more steps), "
        f"{len(kernels) / n:.0f} kernels a step on streams {kernel_streams}; copies "
        f"{len(copies) / n:.1f} a step on streams {copy_streams}, {copy_ms:.4f} ms a step, "
        f"{share:.3f} of it overlapping a kernel, on {card}")
    return {"wall_ms": wall, "busy_ms": busy, "copy_streams": copy_streams,
            "kernel_streams": kernel_streams, "copy_overlap": share}


def check_wire(torch, tr, batches, card) -> None:
    """Each slice of the first chunk, uploaded at its wire dtypes and widened
    on the card, equals put_batch of its numpy batch bit for bit."""
    buf = [b for _, b in zip(range(FIT_K), batches)]
    up = tr._ready(tr.put_chunk(buf))
    wide = tr._widen(up)
    plan = {k: str(v) for k, v in tr._wire_plan.items()}
    want_plan = {"item_id": "split24", "item_seq": "split24", "label": "uint8",
                 "__weight__": "uint8", "likes_level": "uint8", "views_level": "uint8"}
    if plan != want_plan:
        raise SystemExit(f"wire plan {plan}, expected {want_plan}")
    rows = FIT_K * len(buf[0]["label"])
    wire = sum(t.element_size() * t.numel() for t in up.values()) / rows
    full = sum(v.nbytes for k, v in buf[0].items() if k in wide) / len(buf[0]["label"])
    for i, b in enumerate(buf):
        want = tr._ready(tr.put_batch(b))
        for k, v in wide.items():
            if v[i].dtype != want[k].dtype or not torch.equal(v[i], want[k]):
                raise SystemExit(f"wire: batch {i} column {k!r} widened on the card is not "
                                 "put_batch's")
    log(f"[wire] the first chunk's {len(buf)} batches widened on the card equal put_batch's "
        f"bit for bit, columns {sorted(wide)}; plan {plan}: {wire:.0f} B a row on the wire, "
        f"{full:.0f} B unnarrowed, on {card}")


def check_feeds(torch, tr, epoch_batches) -> None:
    """fit's feed at FIT_K batches an upload (put_chunk, widened, sliced)
    gives every step of both epochs the device batch that its feed at 1
    (put_batch) gives, bit for bit (the PLACEHOLDER column stays off the
    wire)."""
    import contextlib

    n = 0
    for epoch in range(TRAIN_EPOCHS):
        with contextlib.closing(tr._device_batches(epoch_batches(epoch), 1)) as one, \
                contextlib.closing(tr._device_batches(epoch_batches(epoch), FIT_K)) as eight:
            for a, b in zip(one, eight, strict=True):
                if any(not torch.equal(a[k], v) or a[k].dtype != v.dtype for k, v in b.items()):
                    raise SystemExit(f"fit's feed at {FIT_K} and at 1 part at step {n}")
                n += 1
    log(f"[fit] the feed at {FIT_K} batches an upload gives each of {n} steps the batch of the "
        "feed at 1, bit for bit")


def host_driven(torch, train, valid, store, root, card, dense: dict, serve: dict,
                counted, per_step: dict, per_eval: dict, sasrec_per_step: dict,
                sasrec_per_eval: dict) -> None:
    """Phase 6f (see the module docstring). ``dense`` is phase 6's mm_fibinet
    run; ``serve`` phase 4's Predictor, rows and score_table probabilities;
    ``counted``, ``per_step`` and ``per_eval`` as train_and_serve's, the
    ``sasrec_`` pair those of sasrec_fibinet."""
    import contextlib
    import itertools

    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import TableData, iter_batches
    from ctr_recommendation_tpu_torch.data.streaming import host_row_groups, window_batches
    from ctr_recommendation_tpu_torch.inference import write_submission
    from ctr_recommendation_tpu_torch.training import Trainer

    names = lambda d: {fn.__name__: n for fn, n in d.items()}  # noqa: E731

    def experiment(tag, k, **kw):
        return microlens_experiment(data_root="", epochs=kw.pop("epochs", TRAIN_EPOCHS),
                                    steps_per_dispatch=k,
                                    checkpoint_dir=os.path.join(root, f"ckpt_fit_{tag}"), **kw)

    exp = experiment("wire", FIT_K)
    bs, spe = exp.train.batch_size, N_TRAIN // exp.train.batch_size
    eval_bs = exp.train.eval_batch_size
    fm_trainer = Trainer(exp, steps_per_epoch=spe, item_store=store, log_fn=log)
    fm = fm_trainer.fm

    def epoch_batches(epoch, **kw):
        return iter_batches(train, fm, bs, shuffle=True, seed=exp.train.seed, epoch=epoch,
                            drop_last=True, **kw)

    def valid_batches():
        return iter_batches(valid, fm, eval_bs)

    check_wire(torch, fm_trainer, epoch_batches(0), card)
    # the card's step on identical inputs, twice: which gradients repeat bit for bit
    batch = fm_trainer._ready(fm_trainer.put_batch(next(epoch_batches(0))))
    grads = []
    for _ in range(2):
        with torch.enable_grad():
            loss, aux = fm_trainer.forward_loss(batch)
            grads.append(dict(zip(aux.targets, fm_trainer.gradients(loss, aux))))
    moved = {p: float((g - grads[1][p]).abs().max()) for p, g in grads[0].items()
             if not torch.equal(g, grads[1][p])}
    log(f"[fit] one step's gradients on the same batch twice: leaves that differ, max|d|: "
        f"{moved} on {card}")
    # the shared likes_level table's merged backward alone, on fixed inputs
    ids = torch.cat([batch["likes_level"], batch["views_level"]]).to(torch.int64)
    rows = fm_trainer.state.params["trunk"]["tables"]["likes_level"].shape[0] + 1
    cot = torch.randn(len(ids), exp.model.embedding_dim, device=ids.device,
                      generator=torch.Generator(device=ids.device).manual_seed(0))
    outs = [torch.ops.aten.embedding_dense_backward(cot, ids, rows, -1, False)
            for _ in range(10)]
    log(f"[fit] embedding_dense_backward of {len(ids)} ids into {rows} rows, the same inputs 10 "
        f"times: {sum(not torch.equal(o, outs[0]) for o in outs)} results differ from the "
        f"first, max|d| {max(float((o - outs[0]).abs().max()) for o in outs):.3e}")
    check_feeds(torch, fm_trainer, epoch_batches)

    def counted_fit(tr, train_batches, steps, eval_batches, tag, valid_fn=valid_batches,
                    launches=(per_step, per_eval)):
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        hist = tr.fit(train_batches, valid_fn)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        launched = {fn: fn.launches for fn in counted}
        expect = {fn: launches[0].get(fn, 0) * steps + launches[1].get(fn, 0) * eval_batches
                  for fn in counted}
        for h in hist:
            auc = f", valid auc {h['auc']:.5f}" if "auc" in h else ""
            log(f"[fit {tag}] epoch {int(h['epoch'])}: loss {h['train_loss']:.6f}{auc}, "
                f"{h['examples_per_sec']:.0f} examples/s ({h['seconds']:.3f} s train) on {card}")
        log(f"[fit {tag}] {steps} steps + {eval_batches} eval batches in {t:.3f} s; launches "
            f"{names(launched)}, expected {names(expect)}")
        if launched != expect or tr.state.step != steps:
            raise SystemExit(f"fit {tag}: {tr.state.step} steps, launches {names(launched)}; "
                             f"expected {steps} steps, {names(expect)}")
        return hist

    eval_batches = TRAIN_EPOCHS * -(-N_VALID // eval_bs)
    runs, trainers = {}, {}
    for tag, k in (("k1", 1), ("k1_repeat", 1), (f"k{FIT_K}", FIT_K)):
        tr = Trainer(experiment(tag, k), steps_per_epoch=spe, item_store=store, log_fn=log)
        runs[tag] = counted_fit(tr, epoch_batches, TRAIN_EPOCHS * spe, eval_batches, tag)
        trainers[tag] = tr

    def gap(a, b, key):
        return max(abs(x[key] - y[key]) for x, y in zip(runs[a], runs[b]))

    def param_gaps(a, b):
        return {p: float((x - y).abs().max()) for p, x, y in zip(
            trainers[a].param_paths, trainers[a].param_leaves, trainers[b].param_leaves)
            if not torch.equal(x, y)}

    repeat = {key: gap("k1", "k1_repeat", key) for key in ("train_loss", "auc")}
    bar = {key: max(v, FIT_METRIC_FLOOR) for key, v in repeat.items()}
    chunked = {key: gap("k1", f"k{FIT_K}", key) for key in ("train_loss", "auc")}
    log(f"[fit] per-epoch |d| of the repeat at 1 batch an upload {repeat}, at {FIT_K} against "
        f"1 {chunked} (bar {bar}); parameters that differ, max|d|: the repeat "
        f"{param_gaps('k1', 'k1_repeat')}, at {FIT_K} {param_gaps('k1', f'k{FIT_K}')}")
    if any(chunked[key] > bar[key] for key in bar):
        raise SystemExit(f"fit at {FIT_K} batches an upload differs from fit at 1 by {chunked}, "
                         f"beyond the bar {bar}")
    for tag in runs:
        losses = [h["train_loss"] for h in runs[tag]]
        best = max(h["auc"] for h in runs[tag])
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise SystemExit(f"fit {tag}: training loss not finite and falling: {losses}")
        if not best > 0.6 or abs(best - dense["best_auc"]) > FIT_AUC_TOL:
            raise SystemExit(f"fit {tag}: best valid AUC {best}, fit_on_device's "
                             f"{dense['best_auc']} (tolerance {FIT_AUC_TOL})")
        ck = trainers[tag].ckpt
        if ck.latest_step() != TRAIN_EPOCHS or not os.path.exists(ck.best_export_path):
            raise SystemExit(f"fit {tag}: no resume point or no best export")
    log(f"[fit] best valid auc at 1 {max(h['auc'] for h in runs['k1']):.5f}, at {FIT_K} "
        f"{max(h['auc'] for h in runs[f'k{FIT_K}']):.5f}, fit_on_device's "
        f"{dense['best_auc']:.5f} (tolerance {FIT_AUC_TOL})")

    # the host item join: the batches carry item_emb_d128, the trainer no store
    host_exp = experiment("host_join", FIT_K, epochs=1)
    first = next(epoch_batches(0, item_store=store, strict_items=True))
    losses = {}
    for tag, st, batch in (("device join", store, {k: v for k, v in first.items()
                                                   if k != "item_emb_d128"}),
                           ("host join", None, first)):
        tr = Trainer(host_exp, steps_per_epoch=spe, item_store=st, log_fn=log)
        up = tr.put_batch(batch)
        losses[tag] = tr.train_step(tr._ready(up))
    log(f"[fit host join] first step's loss: device join {losses['device join'].item():.9f}, "
        f"host join {losses['host join'].item():.9f}")
    if not torch.equal(losses["device join"], losses["host join"]):
        raise SystemExit("the host join's first loss is not the device join's")
    host_steps = 2 * FIT_K
    tr = Trainer(host_exp, steps_per_epoch=host_steps, item_store=None, log_fn=log)
    hist = counted_fit(tr, lambda epoch: itertools.islice(
        epoch_batches(epoch, item_store=store, strict_items=True), host_steps), host_steps,
        -(-N_VALID // eval_bs), "host join",
        valid_fn=lambda: iter_batches(valid, fm, eval_bs, item_store=store))
    bad = {k: v[:bs].copy() for k, v in train.columns.items()}
    bad["item_id"][17] = 91_718 + 5  # in the table's rows, not in item_info
    try:
        tr.fit(lambda epoch: iter_batches(TableData(bad, bs), fm, bs, item_store=store,
                                          strict_items=True))
        raise SystemExit("an unknown item_id did not raise through fit under strict_items")
    except KeyError as e:
        log(f"[fit host join] an unknown item_id raises through fit: KeyError {e}")

    # sasrec_fibinet through fit: the encoder kernels on the host-driven path
    tr = Trainer(experiment("sasrec", FIT_K, model="sasrec_fibinet", epochs=1),
                 steps_per_epoch=2 * FIT_K, item_store=store, log_fn=log)
    counted_fit(tr, lambda epoch: itertools.islice(epoch_batches(epoch), 2 * FIT_K), 2 * FIT_K,
                -(-N_VALID // eval_bs), "sasrec_fibinet",
                launches=(sasrec_per_step, sasrec_per_eval))

    # labels turn soft halfway through an epoch: the label column widens
    logs: list[str] = []
    tr = Trainer(experiment("soft", FIT_K, epochs=1), steps_per_epoch=spe, item_store=store,
                 log_fn=logs.append)

    def soft(epoch):
        rng = np.random.default_rng(5)
        for i, b in enumerate(epoch_batches(epoch)):
            if i >= spe // 2:
                b["label"] = rng.uniform(0.1, 0.9, size=bs).astype(np.float32)
            yield b

    hist = counted_fit(tr, soft, spe, 0, "soft labels", valid_fn=None)
    widening = [m for m in logs if "widening" in m]
    log(f"[fit soft labels] {widening}; loss {hist[0]['train_loss']:.6f}")
    if not widening or not np.isfinite(hist[0]["train_loss"]):
        raise SystemExit("soft labels mid-stream did not widen the label column or train")

    # the stream window on numpy row groups: host 0 of 2, shuffled
    rng = np.random.default_rng(3)
    cuts = np.sort(rng.choice(np.arange(1, N_TRAIN), WINDOW_GROUPS - 1, replace=False))
    bounds = list(zip([0, *cuts], [*cuts, N_TRAIN]))
    host_rows = np.concatenate([np.arange(a, z) for a, z in bounds[0::2]])
    steps = -(-len(host_rows) // bs)
    seen: list[np.ndarray] = []

    def window(epoch):
        groups, grng = host_row_groups(WINDOW_GROUPS, shuffle=True, seed=exp.train.seed,
                                       epoch=epoch, host_index=0, host_count=2)
        cols = dict(train.columns, __row__=np.arange(N_TRAIN))
        chunks = ({k: v[s : min(s + 4 * bs, bounds[g][1])] for k, v in cols.items()}
                  for g in groups for s in range(bounds[g][0], bounds[g][1], 4 * bs))
        for b in window_batches(chunks, fm, bs, rng=grng, shuffle=True):
            row = b.pop("__row__")
            seen.append(row[b["__weight__"] > 0])
            yield b

    tr = Trainer(experiment("window", FIT_K, epochs=1), steps_per_epoch=steps,
                 item_store=store, log_fn=log)
    counted_fit(tr, window, steps, 0, "stream window", valid_fn=None)
    rows_seen = np.sort(np.concatenate(seen))
    sizes = [int(z - a) for a, z in bounds]
    log(f"[fit stream window] {WINDOW_GROUPS} row groups of {sizes} rows; "
        f"host 0 of 2: {len(host_rows)} rows in {steps} batches, {len(rows_seen)} rows seen")
    if not np.array_equal(rows_seen, host_rows):
        raise SystemExit("the stream window's batches do not cover the host's rows once")

    # predict --stream's path: predict_all over the unshuffled window
    pred, rows, bulk = serve["pred"], serve["rows"], serve["bulk"]
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches

    chunks = ({k: v[s : s + 4 * B_FULL] for k, v in rows.items()}
              for s in range(0, N_ROWS, 4 * B_FULL))
    score_fwd.launches = 0
    t0 = time.perf_counter()
    probs = pred.predict_all(window_batches(chunks, fm, B_FULL,
                                            rng=np.random.default_rng(0)))
    t_pred = time.perf_counter() - t0
    n_launched = score_fwd.launches
    diff = (float(np.abs(probs.astype(np.float64) - bulk).max())
            if probs.shape == bulk.shape else float("inf"))
    log(f"[predict --stream] predict_all over the window: {len(probs)} rows in {t_pred:.4f} s "
        f"= {len(probs) / t_pred:.0f} rows/s on {card}; max|d| vs score_table {diff:.3e}; "
        f"fused_score launches {n_launched}")
    if n_launched != (N_ROWS // B_FULL) * score_launches():
        raise SystemExit(f"predict_all launched {n_launched} scoring kernels")
    if not np.array_equal(probs, bulk):
        raise SystemExit(f"predict --stream's probabilities are not score_table's: {diff}")
    with tempfile.TemporaryDirectory() as out_dir:
        csv_path, zip_path = write_submission(probs, out_dir)
        check_submission(len(probs), csv_path, zip_path, bulk, "predict --stream")

    timing = fit_timing(torch, train, card, experiment, epoch_batches, spe, store)
    eps = {tag: [round(h["examples_per_sec"]) for h in hist]
           for tag, hist in (("fit_on_device", dense["hist"]), ("fit k1", runs["k1"]),
                             (f"fit k{FIT_K}", runs[f"k{FIT_K}"]))}
    log(f"[fit] examples/s per epoch {eps}; a step, ms wall / device busy: "
        + ", ".join(f"{t} {v['wall_ms']:.4f} / {v['busy_ms']:.4f}" for t, v in timing.items())
        + "; copies on their own stream, overlapping kernels: "
        + ", ".join(f"{t} {v['copy_streams']} vs {v['kernel_streams']}, "
                    f"{v['copy_overlap']:.3f}" for t, v in timing.items() if t.startswith("k"))
        + f" on {card}")


def fit_timing(torch, train, card, experiment, epoch_batches, spe: int, store) -> dict:
    """Where a step of fit spends its time: the host's parts alone, a batch
    (iter_batches' assembly, put_batch, put_chunk of FIT_K), then a step
    (time_steps) fed uploads made beforehand, fed by fit's prefetch threads
    at 1 and FIT_K batches an upload (with the time the step waits for the
    feed), and of fit_on_device's loop on the resident split."""
    import contextlib
    import itertools

    from ctr_recommendation_tpu_torch.training import Trainer

    def trainer(tag, k):
        return Trainer(experiment(f"time_{tag}", k), steps_per_epoch=spe, item_store=store,
                       log_fn=log)

    tr = trainer("preloaded", 1)
    t0 = time.perf_counter()
    batches = list(epoch_batches(0))
    t_batch = (time.perf_counter() - t0) / spe * 1e3
    t0 = time.perf_counter()
    uploads = [tr.put_batch(b) for b in batches]
    torch.cuda.synchronize()
    t_put = (time.perf_counter() - t0) / spe * 1e3
    t0 = time.perf_counter()
    for i in range(0, spe, FIT_K):
        tr.put_chunk(batches[i : i + FIT_K])
    torch.cuda.synchronize()
    t_chunk = (time.perf_counter() - t0) / spe * 1e3
    log(f"[fit timing] the host alone, ms a batch: iter_batches {t_batch:.4f}, put_batch "
        f"{t_put:.4f}, put_chunk of {FIT_K} {t_chunk:.4f} (a batch's share), on {card}")
    timing = {}
    it = iter(uploads)
    timing["preloaded"] = time_steps(torch, lambda: tr.train_step(tr._ready(next(it))), card,
                                     "preloaded uploads timing", warm=2 * FIT_K)
    for tag, k in (("k1", 1), (f"k{FIT_K}", FIT_K)):
        tr = trainer(tag, k)
        # three epochs' batches: the prefetch threads stay busy through both windows
        batches = itertools.chain.from_iterable(epoch_batches(e) for e in range(3))
        waited = [0.0]
        with contextlib.closing(tr._device_batches(batches, k)) as feed:
            def step():
                t = time.perf_counter()
                batch = next(feed)
                waited[0] += time.perf_counter() - t
                tr.train_step(batch)

            timing[tag] = time_steps(torch, step, card, f"{tag} timing", warm=2 * FIT_K)
        wait = waited[0] / (2 * FIT_K + 2 * FIT_STEPS_TIMED) * 1e3
        log(f"[fit {tag} timing] of a step, {wait:.4f} ms waiting for the feed")
    tr = trainer("on_device", 1)
    data, perm = tr._upload(train), tr._permutation(0, N_TRAIN)
    at = itertools.count()
    bs = tr.exp.train.batch_size

    def resident_step():
        i = next(at)
        tr.train_step({k: v[perm[i * bs : (i + 1) * bs]] for k, v in data.items()})

    timing["fit_on_device"] = time_steps(torch, resident_step, card, "fit_on_device timing",
                                         warm=2 * FIT_K)
    return timing


ZOO = ("din", "xdeepfm", "finalmlp", "dcnv2", "deepfm", "autoint", "masknet", "pnn", "dlrm")


def zoo(torch, train, valid, store, root, card, counted, rows, dense: dict) -> None:
    """Phase 6g (see the module docstring). ``rows`` are phase 4's serving
    rows; ``dense`` is phase 6's mm_fibinet run."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import TableData

    runs = {}
    for name in ZOO:
        exp = microlens_experiment(data_root="", model=name, epochs=TRAIN_EPOCHS,
                                   checkpoint_dir=os.path.join(root, f"ckpt_{name}"))
        m = exp.model
        if (m.embedding_dim, m.hidden_units, m.cin_layer_units, m.finalmlp_stream1_units,
                m.finalmlp_stream2_units, m.finalmlp_num_heads, m.autoint_num_layers,
                m.autoint_num_heads, m.masknet_blocks, m.masknet_block_dim,
                m.din_att_hidden_units, exp.train.compute_dtype, exp.train.batch_size) != (
                E, HIDDEN, (64, 64), (512, 256), (512, 256), 8, 2, 2, 4, 64, (64, 32),
                "bfloat16", B_TRAIN):
            raise SystemExit(f"the zoo's defaults moved: {exp}")
        run = train_and_serve(torch, exp, train, valid, store, root, card, counted,
                              per_step={}, per_eval={}, per_serve={}, fused=False)
        server = run.pop("server")
        server.score_table(TableData({k: v[:B_FULL] for k, v in rows.items()}, B_FULL))
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        probs = server.score_table(TableData(rows, N_ROWS))
        t_score = time.perf_counter() - t0
        launched = {fn.__name__: fn.launches for fn in counted}
        log(f"[serve {name}] score_table: {N_ROWS} rows in {t_score:.4f} s = "
            f"{N_ROWS / t_score:.0f} rows/s on {card}; launches {launched}")
        # [0, 1]: a logit past ~17 (deepfm's raw FM term) rounds to 1 in fp32
        if probs.shape != (N_ROWS,) or not ((probs >= 0) & (probs <= 1)).all():
            raise SystemExit(f"{name}: score_table's probabilities are not in [0, 1], one a row")
        if any(launched.values()):
            raise SystemExit(f"{name}: the zoo's serving path launched a kernel: {launched}")
        runs[name] = dict(run, rows_per_s=N_ROWS / t_score)
    eps = lambda r: [round(h["examples_per_sec"]) for h in r["hist"]]  # noqa: E731
    log(f"[zoo] mm_fibinet (phase 6): examples/s per epoch {eps(dense)}, best valid auc "
        f"{dense['best_auc']:.5f}, a step {dense['step']['step_ms']:.4f} ms wall, "
        f"{dense['step']['busy_ms']:.4f} ms device busy, {dense['step']['kernels']:.0f} "
        f"kernels, on {card}")
    for name, r in runs.items():
        st = r["step"]
        log(f"[zoo] {name}: examples/s per epoch {eps(r)}, best valid auc "
            f"{r['best_auc']:.5f}; a step {st['step_ms']:.4f} ms wall, {st['busy_ms']:.4f} ms "
            f"device busy ({st['busy_ms'] / st['step_ms']:.3f}), {st['kernels']:.0f} kernels; "
            f"score_table {r['rows_per_s']:.0f} rows/s; card vs CPU gradients, worst "
            f"|d|/max|g| {r['grad_gap']:.3e}; kernel launches in the fit "
            f"{ {fn.__name__: n for fn, n in r['launches'].items()} } on {card}")


# ---- phase 6h: data-parallel training, two ranks sharing the card ----
# Two ranks on one card must use gloo (NCCL refuses two ranks on one
# device); (c) builds the NCCL path with one rank. A spawn of ranks is
# killed past DP_TIMEOUT_S, and any rank's failure fails the phase.
DP_WORLD = 2
DP_DEVICE = "cuda:0"  # every rank's, and the 1-process reference's
DP_TIMEOUT_S = 300
DP_AUC_TOL = 2e-3  # (b)'s best valid AUC against phase 6's single-process run
# (a) the BatchNorm running statistics, 2 ranks against 1 process: fp32
# sums of the same rows in another order
DP_STATE_TOL = 1e-5
# (a) the parameters after the update. Adam's first step moves an element by
# lr g' / (|g'| + eps), g' = g + weight_decay p: at most lr, and where the two
# gradients agree to 1e-3 of |g'| the two steps differ by at most lr 1e-3 / 4.
# There: |d| <= DP_PARAM_TOL (1 + |p|); elsewhere (the BatchNorm-fed biases,
# whose true gradient is 0 and whose computed one is rounding noise, among
# them): |d| <= 2 lr.
DP_PARAM_TOL = 1e-6


def dp_experiment(ckpt: str, fp32: bool):
    """The full microlens_experiment() defaults (dropout 0.2, use_pallas),
    in fp32 for the step checks."""
    import dataclasses

    from ctr_recommendation_tpu_torch.config import microlens_experiment

    exp = microlens_experiment(data_root="", epochs=TRAIN_EPOCHS, checkpoint_dir=ckpt,
                               batch_size=B_TRAIN)
    if fp32:
        exp = exp.replace(train=dataclasses.replace(exp.train, compute_dtype="float32"))
    return exp


def dp_step(torch, tr, batch: dict, gates, part) -> dict:
    """One train step of ``tr`` on ``batch`` (device columns), the forward
    recording its gates (``gates`` None) or replaying ``part`` of them;
    returns the global loss, the gradients by target, the interaction
    launches, the replay's counts, and after the update the gradients as the
    optimizer left them (``clipped``: clipped, plus the L2 term), the
    parameters and the model state (on the CPU)."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten

    interaction_fwd.launches = interaction_bwd.launches = 0
    replay = gate_replay(torch, gates, part)
    with torch.enable_grad():
        with replay:
            loss, aux = tr.forward_loss(batch)
        grads = tr.gradients(loss, aux)
    torch.cuda.synchronize()
    out = {"loss": aux.loss.item(), "grads": dict(zip(aux.targets, (g.detach().cpu().clone()
                                                                     for g in grads))),
           "launches": (interaction_fwd.launches, interaction_bwd.launches),
           "calls": replay.calls, "flips": replay.flips, "margin": replay.margin,
           "gates": [g.cpu() for g in replay.gates],
           "params0": {k: v.detach().cpu().clone() for k, v in tr.param_paths.items()}}
    tr.apply_gradients(grads, aux)
    out["clipped"] = {k: g.detach().cpu().clone() for k, g in zip(aux.targets, grads)}
    out["params"] = {k: v.detach().cpu().clone() for k, v in flatten(tr.state.params).items()}
    out["state"] = {k: v.cpu().clone() for k, v in flatten(tr.state.model_state).items()}
    out["lr0"], out["weight_decay"] = tr.schedule(0), tr.exp.train.weight_decay
    return out


def dp_load(path: str) -> dict:
    """The ranks' inputs, written once by the phase: the train and valid
    splits and the item store."""
    from ctr_recommendation_tpu_torch.data import ItemStore, TableData

    with np.load(path) as z:
        cols = {k: z[k] for k in z.files}
    split = {n: {k.split("/", 1)[1]: v for k, v in cols.items() if k.startswith(n + "/")}
             for n in ("train", "valid")}
    store = ItemStore.from_arrays(cols["item_ids"], cols["item_emb"])
    return {n: TableData(c, len(c["label"])) for n, c in split.items()} | {"store": store}


def dp_rank(spec_path: str) -> int:
    """One rank of phase 6h or 6i, started by ``spawn_ranks`` with the launcher's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): joins the
    group on cuda:0 with the spec's backend, runs its tasks and saves what
    they return for the phase to check."""
    import torch

    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.parallel import data_parallel, distributed
    from ctr_recommendation_tpu_torch.training import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(DP_DEVICE)
    if not distributed.initialize(backend=spec["backend"], timeout_s=DP_TIMEOUT_S):
        raise SystemExit("phase 6h rank: no launcher environment")
    rank, world = distributed.host_id(), distributed.host_count()
    data = dp_load(spec["inputs"])
    bs = B_TRAIN
    out = {"backend": torch.distributed.get_backend()}
    for task in spec["tasks"]:
        if task == "step":  # (a), (c): one step on this rank's rows of the 4096
            tr = Trainer(dp_experiment(spec["ckpt"] + f"_step{rank}", fp32=True),
                         steps_per_epoch=N_TRAIN // bs, item_store=data["store"],
                         device=DP_DEVICE, log_fn=lambda s: None)
            n = bs // world
            cols, row0 = distributed.host_local_to_global(
                {k: v[rank * n : (rank + 1) * n] for k, v in data["train"].columns.items()},
                tr.mesh)
            data_parallel.stats.update(calls=0, bytes=0)
            res = dp_step(torch, tr, cols, torch.load(spec["gates"]), (rank, world))
            res.update(row0=row0, stats=dict(data_parallel.stats))
            res.pop("gates")
            out["step"] = res
        elif task == "fit":  # (b): fit_on_device, the global batch 4096
            exp = dp_experiment(spec["ckpt"] + "_fit", fp32=False)
            tr = Trainer(exp, steps_per_epoch=N_TRAIN // bs, item_store=data["store"],
                         device=DP_DEVICE, log_fn=log if rank == 0 else (lambda s: None))
            torch.cuda.synchronize()
            interaction_fwd.launches = interaction_bwd.launches = 0
            data_parallel.stats.update(calls=0, bytes=0)
            t0 = time.perf_counter()
            hist = tr.fit_on_device(data["train"], data["valid"])
            torch.cuda.synchronize()
            res = {"hist": hist, "seconds": time.perf_counter() - t0,
                   "launches": (interaction_fwd.launches, interaction_bwd.launches),
                   "stats": dict(data_parallel.stats), "steps": tr.state.step}
            # the step's gradient all-reduce alone (every leaf and the loss,
            # bucketed), and one BatchNorm-sized all-reduce (512 floats)
            bufs = [torch.zeros_like(p) for p in tr.param_leaves]
            bufs.append(torch.zeros(1, device=DP_DEVICE))
            small = [torch.zeros(512, device=DP_DEVICE)]
            for key, tensors in (("allreduce_ms", bufs), ("small_allreduce_ms", small)):
                times = []
                for i in range(13):
                    torch.distributed.barrier()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    data_parallel.all_reduce_buckets_(tensors, tr.mesh.group("data"))
                    torch.cuda.synchronize()
                    if i >= 3:
                        times.append(1e3 * (time.perf_counter() - t))
                res[key] = sorted(times)
            res["allreduce_bytes"] = sum(b.numel() * b.element_size() for b in bufs)
            res["export"] = os.path.exists(tr.ckpt.best_export_path)
            res["resume_point"] = tr.ckpt.latest_step()
            out["fit"] = res
        elif task == "mp_step":  # 6i (a): one step on data rank d's rows, tables sharded
            out["mp_step"] = mp_step_task(torch, data, spec, rank)
        elif task == "mp_sparse":  # 6i (a), the sparse table optimizer
            out["mp_sparse"] = mp_sparse_task(torch, data, spec, rank)
        elif task == "mp_fit":  # 6i (b)
            out["mp_fit"] = mp_fit_task(torch, data, spec, rank)
        elif task == "mp_lookup":  # 6i (c)
            out["mp_lookup"] = mp_lookup_task(torch, data)
        else:
            raise SystemExit(f"phase 6h rank: unknown task {task!r}")
    torch.save(out, f"{spec['out']}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(torch, spec: dict, world: int, root: str) -> list[dict]:
    """Start ``world`` ranks of ``dp_rank`` on ``spec`` (this script with
    --dp-rank), wait for all, kill them all past DP_TIMEOUT_S; fail unless
    every rank exits 0. Returns each rank's saved results."""
    import socket

    path = os.path.join(root, f"dp_spec_{spec['name']}.json")
    spec = dict(spec, out=os.path.join(root, f"dp_out_{spec['name']}"))
    with open(path, "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, deadline = [], time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise SystemExit(f"phase 6h ({spec['name']}): the {world} ranks did not finish in "
                         f"{DP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"[dp {spec['name']} rank {rank}] {line}")
        if p.returncode != 0:
            raise SystemExit(f"phase 6h ({spec['name']}): rank {rank} exited {p.returncode}")
    return [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in range(world)]


def dp_check_step(torch, tag: str, got: dict, ref: dict, phase: str = "6h") -> float:
    """(a), (c): a rank's step against the 1-process step on the same 4096
    rows: the loss, every fp32 gradient (GRAD_TOL of the leaf + GRAD_FLOOR
    of the largest; the 1-process gates replayed, each flip within
    GATE_MARGIN), the BatchNorm running statistics (DP_STATE_TOL) and the
    parameters after the update (DP_PARAM_TOL, or 2 lr where the gradient
    is noise). Returns the worst |d| / max|g| over the gradients above 1e-3
    of the largest."""
    names = list(ref["grads"])
    if list(got["grads"]) != names:
        raise SystemExit(f"phase {phase} {tag}: gradient targets {list(got['grads'])} != {names}")
    worst, bad = 0.0, []
    for key in ("grads", "clipped"):  # before the update, and as the optimizer left them
        largest = max(g.abs().max().item() for g in ref[key].values())
        floor = GRAD_FLOOR * largest
        for name in names:
            a, b = got[key][name], ref[key][name]
            err, scale = (a - b).abs().max().item(), b.abs().max().item()
            if scale > 1e-3 * largest:
                worst = max(worst, err / scale)
            if not bool(torch.isfinite(a).all()) or err > GRAD_TOL * scale + floor:
                bad.append(f"{key} {name}: max|d| {err:.2e}, max|g| {scale:.2e}")
    state_err = max((got["state"][k] - v).abs().max().item() / max(1.0, v.abs().max().item())
                    for k, v in ref["state"].items())
    lr, wd = ref["lr0"], ref["weight_decay"]
    param_bad, param_err = [], 0.0
    for k, p in ref["params"].items():
        d = (got["params"][k] - p).abs()
        g = ref["grads"][k]
        fixed = (got["grads"][k] - g).abs() <= 1e-3 * (g + wd * ref["params0"][k]).abs()
        param_err = max(param_err, float(d[fixed].max()) if bool(fixed.any()) else 0.0)
        if (bool((d[fixed] > DP_PARAM_TOL * (1 + p.abs()[fixed])).any())
                or bool((d > 2 * lr).any())):
            param_bad.append(k)
    ok = (not bad and not param_bad and abs(got["loss"] - ref["loss"]) <= 1e-5
          and state_err <= DP_STATE_TOL and got["calls"] == len(ref["gates"])
          and got["margin"] <= GATE_MARGIN)
    log(f"[{'dp' if phase == '6h' else 'mp'} {tag}] loss {got['loss']:.7f} vs 1 process "
        f"{ref['loss']:.7f}; {len(names)} fp32 "
        f"gradients, before the update and clipped: worst |d|/max|g| {worst:.3e} (tolerance "
        f"{GRAD_TOL:g} of the leaf + "
        f"{GRAD_FLOOR:g} of the largest); the 1-process gates replayed: {got['calls']} of "
        f"{len(ref['gates'])} met, {got['flips']} flips, within {got['margin']:.2e} of 0 "
        f"(GATE_MARGIN {GATE_MARGIN:g}); BatchNorm running stats |d| {state_err:.2e} (tolerance "
        f"{DP_STATE_TOL:g}); parameters after the update |d| {param_err:.2e} where the gradient "
        f"fixes the step (tolerance {DP_PARAM_TOL:g} (1 + |p|); elsewhere 2 lr = {2 * lr:.2e}) "
        f"{'ok' if ok else f'FAIL {bad} {param_bad}'}")
    if not ok:
        raise SystemExit(f"phase {phase} {tag}: the ranks' step disagrees with one process's")
    return worst


def data_parallel_phase(torch, train, valid, store, root, card, dense: dict) -> dict:
    """Phase 6h (see the module docstring). ``dense`` is phase 6's
    mm_fibinet run."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        bwd_launches as inter_bwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        fwd_launches as inter_fwd_launches,
    )
    from ctr_recommendation_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    bs = B_TRAIN
    ids = np.flatnonzero(store.known_mask)
    inputs = os.path.join(root, "dp_inputs.npz")
    np.savez(inputs, item_ids=ids, item_emb=store.emb[ids],
             **{f"train/{k}": v for k, v in train.columns.items()},
             **{f"valid/{k}": v for k, v in valid.columns.items()})
    # the 1-process step on the first 4096 rows: the reference, its gates recorded
    tr = Trainer(dp_experiment(os.path.join(root, "dp_ref"), fp32=True),
                 steps_per_epoch=N_TRAIN // bs, item_store=store, device=DP_DEVICE,
                 log_fn=lambda s: None)
    ref = dp_step(torch, tr, {k: torch.as_tensor(v[:bs]).to(DP_DEVICE)
                              for k, v in train.columns.items()}, None, (0, 1))
    gates = os.path.join(root, "dp_gates.pt")
    torch.save(ref["gates"], gates)
    del tr
    torch.cuda.empty_cache()
    ifwd, ibwd = inter_fwd_launches(), inter_bwd_launches()
    spec = {"inputs": inputs, "gates": gates, "ckpt": os.path.join(root, "dp_ckpt")}
    # (a) and (b): two ranks on cuda:0 over gloo
    ranks = spawn_ranks(torch, dict(spec, name="gloo", backend="gloo", tasks=["step", "fit"]),
                        DP_WORLD, root)
    worst = 0.0
    for r, res in enumerate(ranks):
        step = res["step"]
        if res["backend"] != "gloo" or step["launches"] != (ifwd, ibwd):
            raise SystemExit(f"phase 6h (a) rank {r}: backend {res['backend']}, interaction "
                             f"launches {step['launches']}, expected ({ifwd}, {ibwd})")
        if step["row0"] != r * bs // DP_WORLD:
            raise SystemExit(f"phase 6h (a) rank {r}: first global row {step['row0']}")
        worst = max(worst, dp_check_step(
            torch, f"(a) rank {r} of {DP_WORLD}, {bs // DP_WORLD} rows, gloo", step, ref))
        log(f"[dp (a)] rank {r}: interaction launches {step['launches']} (fwd {ifwd} + bwd "
            f"{ibwd}); collectives in the step {step['stats']['calls']}, "
            f"{step['stats']['bytes']} bytes reduced")
    same = all(torch.equal(ranks[0]["step"][k][n], ranks[1]["step"][k][n])
               for k in ("params", "state") for n in ranks[0]["step"][k])
    log(f"[dp (a)] the two replicas after the step bit for bit equal: {same}")
    if not same or ranks[0]["step"]["loss"] != ranks[1]["step"]["loss"]:
        raise SystemExit("phase 6h (a): the ranks' replicas differ after the step")
    # (b): two epochs
    steps = TRAIN_EPOCHS * (N_TRAIN // bs)
    eval_bs = dp_experiment("", fp32=False).train.eval_batch_size
    eval_batches = TRAIN_EPOCHS * -(-N_VALID // eval_bs)
    hists = [res["fit"]["hist"] for res in ranks]
    metrics = ("epoch", "train_loss", "auc", "logloss")
    best = max(h["auc"] for h in hists[0])
    for r, res in enumerate(ranks):
        fit = res["fit"]
        eps = [h["examples_per_sec"] for h in fit["hist"]]
        wall = [1e3 * h["seconds"] / (N_TRAIN // bs) for h in fit["hist"]]
        ar, small = fit["allreduce_ms"], fit["small_allreduce_ms"]
        log(f"[dp (b)] rank {r} of {DP_WORLD} (2 ranks sharing one card, gloo; not a scaling "
            f"figure) on {card}: examples/s per epoch {[f'{v:.0f}' for v in eps]} (global "
            f"rows); a step's wall {[f'{v:.2f}' for v in wall]} ms; gradient all-reduce "
            f"{ar[len(ar) // 2]:.2f} ms a step (median of {len(ar)}, {ar[0]:.2f}-{ar[-1]:.2f}), "
            f"{fit['allreduce_bytes']} bytes ({fit['allreduce_bytes'] / 2**20:.1f} MiB); one "
            f"all-reduce of 512 floats (a BatchNorm statistic's) {small[len(small) // 2]:.3f} ms; "
            f"all collectives of the fit: {fit['stats']['calls'] / steps:.1f} calls and "
            f"{fit['stats']['bytes'] / steps:.0f} bytes a step; interaction launches "
            f"{fit['launches']}")
        for h in fit["hist"]:
            log(f"[dp (b)] rank {r} epoch {int(h['epoch'])}: loss {h['train_loss']:.5f}, valid "
                f"auc {h['auc']:.5f}, {h['seconds']:.3f} s train, {h['eval_seconds']:.3f} s eval")
        if fit["launches"] != (ifwd * (steps + eval_batches), ibwd * steps):
            raise SystemExit(f"phase 6h (b) rank {r}: interaction launches {fit['launches']}")
        if fit["steps"] != steps or [[h[k] for k in metrics] for h in fit["hist"]] != \
                [[h[k] for k in metrics] for h in hists[0]]:
            raise SystemExit(f"phase 6h (b) rank {r}: steps {fit['steps']} or metrics differ")
    losses = [h["train_loss"] for h in hists[0]]
    log(f"[dp (b)] best valid auc {best:.5f} vs phase 6's 1 process {dense['best_auc']:.5f} "
        f"(tolerance {DP_AUC_TOL}); export by rank 0 {ranks[0]['fit']['export']}, resume point "
        f"{ranks[0]['fit']['resume_point']}")
    if (abs(best - dense["best_auc"]) > DP_AUC_TOL or not all(np.isfinite(losses))
            or not losses[-1] < losses[0] or not ranks[0]["fit"]["export"]
            or ranks[0]["fit"]["resume_point"] != TRAIN_EPOCHS):
        raise SystemExit("phase 6h (b): the two-rank fit is off phase 6's or wrote no export")
    # (c): one rank on NCCL
    (nccl,) = spawn_ranks(torch, dict(spec, name="nccl", backend="nccl", tasks=["step"]), 1,
                          root)
    step = nccl["step"]
    if nccl["backend"] != "nccl" or step["launches"] != (ifwd, ibwd) or step["stats"]["calls"] < 1:
        raise SystemExit(f"phase 6h (c): backend {nccl['backend']}, launches {step['launches']}, "
                         f"collectives {step['stats']}")
    worst = max(worst, dp_check_step(torch, "(c) 1 rank, NCCL", step, ref))
    log(f"[dp (c)] NCCL, world 1: {step['stats']['calls']} collectives, {step['stats']['bytes']} "
        f"bytes reduced in the step")
    log(f"[dp] phase 6h in {time.perf_counter() - t_phase:.1f} s")
    return {"grad_gap": worst, "best_auc": best,
            "fit": [res["fit"] for res in ranks]}


# ---- phase 6i: row-sharded tables (model_parallel 2), ranks sharing the card ----
# The ranks share cuda:0 over gloo, as in 6h: every exchange goes through host
# memory (gloo runs all_to_all_single on CPU tensors only), so the times are
# those of a shared card, not a scaling figure.
MP = 2
MP_LAYOUTS = ((1, MP), (2, MP))  # (dp, mp): two ranks, then four
# (a)'s grad_clip_norm: below the step's global gradient norm, so that the
# clip scales every gradient and a norm summed wrongly over the shards shows
MP_CLIP = 1e-3
MP_SKEW_CAPACITY = 1.1  # (c): a batch in shard 0 overflows at this factor
MP_TABLE_SEED = 18


def mp_experiment(ckpt: str, fp32: bool, clip: float | None = None, mp: int = MP):
    """``dp_experiment`` on the (dp, ``mp``) mesh, with (a)'s clip."""
    import dataclasses

    from ctr_recommendation_tpu_torch.config.schema import MeshConfig

    exp = dp_experiment(ckpt, fp32).replace(mesh=MeshConfig(model_parallel=mp))
    if clip is not None:
        exp = exp.replace(train=dataclasses.replace(exp.train, grad_clip_norm=clip))
    return exp


def mp_step_task(torch, data: dict, spec: dict, rank: int) -> dict:
    """6i (a) on one rank: a Trainer on the (world / 2, 2) mesh, one fp32
    step on its data rank's rows of the 4096, the 1-process gates
    replayed; ``dp_step``'s results (the table leaves: this rank's shard)
    with the rank's coordinates and the step's collectives."""
    from ctr_recommendation_tpu_torch.parallel import data_parallel, distributed, embedding
    from ctr_recommendation_tpu_torch.training import Trainer

    bs = B_TRAIN
    tr = Trainer(mp_experiment(spec["ckpt"] + f"_mpstep{rank}", fp32=True, clip=MP_CLIP),
                 steps_per_epoch=N_TRAIN // bs, item_store=data["store"], device=DP_DEVICE,
                 log_fn=lambda s: None)
    d, dp = tr.mesh.data_rank, tr._world
    n = bs // dp
    cols, row0 = distributed.host_local_to_global(
        {k: v[d * n : (d + 1) * n] for k, v in data["train"].columns.items()}, tr.mesh)
    data_parallel.stats.update(calls=0, bytes=0)
    embedding.stats.update(dict.fromkeys(embedding.stats, 0))
    res = dp_step(torch, tr, cols, torch.load(spec["gates"]), (d, dp))
    res.pop("gates")
    res.update(row0=row0, coords=(d, tr.mesh.model_rank, dp, tr.mesh.shape["model"]),
               stats=dict(data_parallel.stats), exchange=dict(embedding.stats),
               sharded=sorted(tr._sharded))
    return res


def mp_sparse_experiment(ckpt: str, mp: int = MP):
    """(a)'s sparse step: lazy adam on the tables, weight decay 0, fp32."""
    import dataclasses

    exp = mp_experiment(ckpt, fp32=True, clip=MP_CLIP, mp=mp)
    return exp.replace(train=dataclasses.replace(exp.train, table_optimizer="adam",
                                                 weight_decay=0.0))


def mp_sparse_task(torch, data: dict, spec: dict, rank: int) -> dict:
    """6i (a) with the sparse table optimizer on one rank of the 1 x 2 mesh:
    one step of ``mp_sparse_experiment`` per forced strategy on the 4096
    rows, the 1-process gates replayed; ``dp_step``'s results and the
    table optimizer's state after the update (this rank's shards)."""
    from ctr_recommendation_tpu_torch.parallel import distributed
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
    from ctr_recommendation_tpu_torch.training import Trainer, sparse

    out = {}
    for strategy, ratio in FORCE_STRATEGY.items():
        sparse.GATHERED_MIN_VOCAB_RATIO = ratio
        tr = Trainer(mp_sparse_experiment(spec["ckpt"] + f"_mpsparse{rank}"),
                     steps_per_epoch=N_TRAIN // B_TRAIN, item_store=data["store"],
                     device=DP_DEVICE, log_fn=lambda s: None)
        cols, _ = distributed.host_local_to_global(
            {k: v[:B_TRAIN] for k, v in data["train"].columns.items()}, tr.mesh)
        res = dp_step(torch, tr, cols, torch.load(spec["sparse_gates"][strategy]), (0, 1))
        res.pop("gates")
        res["topt"] = {k: v.cpu().clone() for k, v in flatten(tr.state.table_opt_state).items()}
        res["sharded"] = sorted(tr._sharded)
        out[strategy] = res
    return out


def mp_check_sparse(torch, ranks: list[dict], refs: dict) -> None:
    """6i (a)'s sparse steps at 1 x 2 against one process's: the loss within
    1e-5, every gradient (the gathered rows' and the masked-dense shards')
    within GRAD_TOL / GRAD_FLOOR, every row of the tables and of lazy
    Adam's moments that the one-process step left alone bit for bit, the
    others within 2 lr (Adam's first step moves an element by at most lr);
    the replicated leaves bit for bit on both ranks."""
    for strategy, ref in refs.items():
        got = [res["mp_sparse"][strategy] for res in ranks]
        sharded = set(got[0]["sharded"])

        def whole(part, k):
            return torch.cat([g[part][k] for g in got]) if k in sharded else got[0][part][k]

        largest = max(g.abs().max().item() for g in ref["grads"].values())
        grad_err = 0.0
        for k, want in ref["grads"].items():
            err = (whole("grads", k) - want).abs().max().item()
            grad_err = max(grad_err, err / max(want.abs().max().item(), 1e-30))
            if err > GRAD_TOL * want.abs().max().item() + GRAD_FLOOR * largest:
                raise SystemExit(f"phase 6i (a) sparse {strategy}: gradient {k} off by {err:.2e}")
        lr = ref["lr0"]
        moved, kept, worst = 0, 0, 0.0
        # (rows one process left alone, its values, the ranks' values put together)
        pairs = [((ref["params"][k] == ref["params0"][k]).all(-1), ref["params"][k],
                  whole("params", k)) for k in sharded]
        # lazy Adam's moments start at 0 and stay there on untouched rows
        pairs += [((v == 0).all(-1), v, torch.cat([g["topt"][k] for g in got]))
                  for k, v in ref["topt"].items()]
        for same, want, have in pairs:
            if not torch.equal(have[same], want[same]):
                raise SystemExit(f"phase 6i (a) sparse {strategy}: rows one process left alone "
                                 "moved")
            kept += int(same.sum())
            moved += int((~same).sum())
        for k in sharded:
            worst = max(worst, (whole("params", k) - ref["params"][k]).abs().max().item())
        if worst > 2 * lr or abs(got[0]["loss"] - ref["loss"]) > 1e-5 or any(
                not torch.equal(g["params"][k], got[0]["params"][k])
                for g in got for k in got[0]["params"] if k not in sharded):
            raise SystemExit(f"phase 6i (a) sparse {strategy}: the 1x2 step is off one process's")
        log(f"[mp (a)] sparse (lazy adam), {strategy}, 1x{MP}: loss {got[0]['loss']:.7f} vs 1 "
            f"process {ref['loss']:.7f}; gradients worst |d|/max|g| {grad_err:.3e} (tolerance "
            f"{GRAD_TOL:g} + {GRAD_FLOOR:g} of the largest); {kept} rows of the tables and the "
            f"moments left alone by one process bit for bit, {moved} moved, the tables' worst "
            f"|d| {worst:.2e} (tolerance 2 lr = {2 * lr:.2e}); replicated leaves bit for bit")


def mp_exchange_times(torch, tr, cols: dict, reps: int = 10) -> dict:
    """A step's lookups alone, each method, on this rank's rows: every id
    feature through ``make_sharded_lookup`` as the trunk asks for it
    (item_seq transposed (S, B)), forward and backward (a cotangent of
    ones), median ms (host clock after a barrier, synchronized) and the
    bytes the exchange moved, from ``embedding.stats``."""
    import torch.distributed as dist

    from ctr_recommendation_tpu_torch.config.schema import FeatureType
    from ctr_recommendation_tpu_torch.parallel import embedding

    fm = tr.fm
    feats = [(f.name, cols[f.name].t() if f.type == FeatureType.SEQUENCE else cols[f.name])
             for f in fm.features
             if f.type in (FeatureType.CATEGORICAL, FeatureType.SEQUENCE) and f.name in cols]
    tables = {t: v.detach().requires_grad_() for t, v in tr.state.params["trunk"]["tables"].items()}
    out = {}
    for method in ("all_to_all", "psum"):
        fn = embedding.make_sharded_lookup(tr.mesh, method=method, feature_map=fm)
        fwd, bwd = [], []
        for i in range(reps + 2):
            dist.barrier()
            torch.cuda.synchronize()
            embedding.stats.update(dict.fromkeys(embedding.stats, 0))
            t0 = time.perf_counter()
            rows = [fn(tables, fm.table_of[name], ids, feature=name) for name, ids in feats]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            moved = dict(embedding.stats)
            torch.autograd.grad(sum(r.sum() for r in rows), list(tables.values()))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 2:
                fwd.append(1e3 * (t1 - t0))
                bwd.append(1e3 * (t2 - t1))
        backward_moved = embedding.stats["bytes"] - moved["bytes"]
        out[method] = {"fwd_ms": sorted(fwd), "bwd_ms": sorted(bwd), "bytes": moved["bytes"],
                       "row_bytes": moved["row_bytes"], "calls": moved["calls"],
                       "fallbacks": moved["fallbacks"], "bwd_bytes": backward_moved}
    return out


def mp_fit_task(torch, data: dict, spec: dict, rank: int) -> dict:
    """6i (b) on one rank: ``fit_on_device`` on the 1 x 2 mesh over phase
    6's splits (the global batch 4096), then the exchange of a step timed
    alone, each method."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.parallel import data_parallel, embedding
    from ctr_recommendation_tpu_torch.training import Trainer

    import dataclasses

    bs = B_TRAIN
    exp = mp_experiment(spec["ckpt"] + "_mpfit", fp32=False)
    exp = exp.replace(train=dataclasses.replace(exp.train, epochs=spec["mp_epochs"]))
    tr = Trainer(exp, steps_per_epoch=N_TRAIN // bs, item_store=data["store"],
                 device=DP_DEVICE, log_fn=log if rank == 0 else (lambda s: None))
    torch.cuda.synchronize()
    interaction_fwd.launches = interaction_bwd.launches = 0
    data_parallel.stats.update(calls=0, bytes=0)
    embedding.stats.update(dict.fromkeys(embedding.stats, 0))
    t0 = time.perf_counter()
    hist = tr.fit_on_device(data["train"], data["valid"])
    torch.cuda.synchronize()
    res = {"hist": hist, "seconds": time.perf_counter() - t0,
           "launches": (interaction_fwd.launches, interaction_bwd.launches),
           "stats": dict(data_parallel.stats), "exchange": dict(embedding.stats),
           "steps": tr.state.step, "export": os.path.exists(tr.ckpt.best_export_path),
           "resume_point": tr.ckpt.latest_step(), "writes": tr._writes,
           "export_path": tr.ckpt.best_export_path}
    cols = tr._device_join({k: torch.as_tensor(v[:bs]).to(DP_DEVICE)
                            for k, v in data["train"].columns.items() if k != "label"})
    res["exchange_times"] = mp_exchange_times(torch, tr, cols)
    return res


def mp_lookup_task(torch, data: dict) -> dict:
    """6i (c) on one rank of the 1 x 2 mesh: the 91,776 x 128 fp32 item
    table (seeded; the pad row 0 zero, as at init), this rank's shard, and
    the ids of a 4096-row batch of phase 6's train split, item_id and the
    20 item_seq ids (86,016 ids before pad exclusion): each method's rows
    against ``table[ids]`` bit for bit, then a batch of as many ids all in
    shard 0 at capacity factor MP_SKEW_CAPACITY (the fallback); each
    method's forward and backward ms; ``exchange_stats`` of phase 6's first
    batch (fit_on_device's first permuted 4096 rows), each feature as the
    trainer looks it up and the two together."""
    import torch.distributed as dist

    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.models.trunk import round_up_vocab
    from ctr_recommendation_tpu_torch.parallel import embedding, make_mesh, sharding
    from ctr_recommendation_tpu_torch.training.loop import _seed

    mesh = make_mesh(MeshConfig(model_parallel=MP), device=DP_DEVICE)
    cols = data["train"].columns
    exp = dp_experiment("", fp32=False)
    vocab = round_up_vocab(build_feature_map(exp.dataset).table("item_id").vocab_size)
    rng = np.random.default_rng(MP_TABLE_SEED)
    full = rng.standard_normal((vocab, E), dtype=np.float32)
    full[0] = 0.0
    full_t = torch.from_numpy(full).to(DP_DEVICE)
    shard = sharding.shard_rows(full_t, mesh).requires_grad_()
    ids = np.concatenate([cols["item_id"][:B_TRAIN, None], cols["item_seq"][:B_TRAIN]], axis=1)
    rows_per = vocab // MP
    skew = rng.integers(1, rows_per, ids.shape).astype(ids.dtype)
    out = {"vocab": vocab, "table_bytes": full.nbytes, "shard_bytes": full.nbytes // MP}
    for tag, batch, factor in (("batch", ids, embedding.DEFAULT_CAPACITY_FACTOR),
                               ("skew", skew, MP_SKEW_CAPACITY)):
        ids_t = torch.from_numpy(batch).to(DP_DEVICE)
        want = full_t[ids_t.long()]
        for method in ("all_to_all", "psum"):
            times_f, times_b = [], []
            for i in range(12):
                dist.barrier()
                torch.cuda.synchronize()
                embedding.stats.update(dict.fromkeys(embedding.stats, 0))
                t0 = time.perf_counter()
                rows = embedding.sharded_lookup(shard, ids_t, mesh, method=method,
                                                capacity_factor=factor, pad_id=0)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                stats = dict(embedding.stats)
                (g,) = torch.autograd.grad(rows.sum(), [shard])
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if i >= 2:
                    times_f.append(1e3 * (t1 - t0))
                    times_b.append(1e3 * (t2 - t1))
            out[f"{tag}/{method}"] = {
                "ids": int(batch.size), "pads": int((batch == 0).sum()),
                "equal": bool(torch.equal(rows, want)), "fwd_ms": sorted(times_f),
                "bwd_ms": sorted(times_b), "stats": stats,
                "grad_rows": int(g.any(dim=1).sum())}
    perm = torch.randperm(len(cols["label"]), generator=torch.Generator().manual_seed(
        _seed(exp.train.seed + 2, 0)))[:B_TRAIN].numpy()
    first = {"item_id": cols["item_id"][perm], "item_seq": cols["item_seq"][perm]}
    first["item_id+item_seq"] = np.concatenate([first["item_id"][:, None],
                                                first["item_seq"]], axis=1)
    out["exchange_stats"] = {
        k: {"pad excluded": embedding.exchange_stats(v, vocab_rows=vocab, dp=1, mp=MP, pad_id=0),
            "pad kept": embedding.exchange_stats(v, vocab_rows=vocab, dp=1, mp=MP)}
        for k, v in first.items()}
    return out


def mp_assemble(torch, ranks: list[dict], dp: int, mp: int) -> list[dict]:
    """Each data rank's (a) results with every row-sharded leaf put together
    from its model ranks' shards (gradients, clipped gradients, parameters
    before and after the update)."""
    out = []
    for d in range(dp):
        group = [ranks[d * mp + m]["mp_step"] for m in range(mp)]
        res = dict(group[0])
        for part in ("grads", "clipped", "params", "params0"):
            res[part] = {k: (torch.cat([g[part][k] for g in group]) if k in res["sharded"]
                             else v) for k, v in group[0][part].items()}
        out.append(res)
    return out


def model_parallel_phase(torch, train, valid, store, root, card, dense: dict) -> dict:
    """Phase 6i (see the module docstring). ``dense`` is phase 6's
    mm_fibinet run."""
    from ctr_recommendation_tpu_torch.cli.evaluate import eval_line, evaluate
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.models.trunk import round_up_vocab
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        bwd_launches as inter_bwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        fwd_launches as inter_fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    bs = B_TRAIN
    inputs = os.path.join(root, "dp_inputs.npz")  # written by phase 6h
    # the 1-process step on the first 4096 rows with (a)'s clip: the reference
    tr = Trainer(mp_experiment(os.path.join(root, "mp_ref"), fp32=True, clip=MP_CLIP, mp=1),
                 steps_per_epoch=N_TRAIN // bs, item_store=store, device=DP_DEVICE,
                 log_fn=lambda s: None)
    ref = dp_step(torch, tr, {k: torch.as_tensor(v[:bs]).to(DP_DEVICE)
                              for k, v in train.columns.items()}, None, (0, 1))
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.double().norm() for g in ref["grads"].values()])))
    log(f"[mp (a)] the 1-process step's global gradient norm {norm:.4e}, clipped to {MP_CLIP:g}")
    if not norm > MP_CLIP:
        raise SystemExit("phase 6i (a): the clip does not scale the step's gradients")
    gates = os.path.join(root, "mp_gates.pt")
    torch.save(ref["gates"], gates)
    del tr
    # the sparse steps' 1-process references, each strategy's gates recorded
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
    from ctr_recommendation_tpu_torch.training import sparse

    sparse_refs, sparse_gates = {}, {}
    default_ratio = sparse.GATHERED_MIN_VOCAB_RATIO
    try:
        for strategy, ratio in FORCE_STRATEGY.items():
            sparse.GATHERED_MIN_VOCAB_RATIO = ratio
            tr = Trainer(mp_sparse_experiment(os.path.join(root, f"mp_sparse_ref_{strategy}"),
                                              mp=1),
                         steps_per_epoch=N_TRAIN // bs, item_store=store, device=DP_DEVICE,
                         log_fn=lambda s: None)
            sref = dp_step(torch, tr, {k: torch.as_tensor(v[:bs]).to(DP_DEVICE)
                                       for k, v in train.columns.items()}, None, (0, 1))
            sref["topt"] = {k: v.cpu().clone()
                            for k, v in flatten(tr.state.table_opt_state).items()}
            sparse_gates[strategy] = os.path.join(root, f"mp_sparse_gates_{strategy}.pt")
            torch.save(sref.pop("gates"), sparse_gates[strategy])
            sparse_refs[strategy] = sref
            del tr
    finally:
        sparse.GATHERED_MIN_VOCAB_RATIO = default_ratio
    torch.cuda.empty_cache()
    ifwd, ibwd = inter_fwd_launches(), inter_bwd_launches()
    mp_epochs = TRAIN_EPOCHS
    spec = {"inputs": inputs, "gates": gates, "ckpt": os.path.join(root, "mp_ckpt"),
            "backend": "gloo", "mp_epochs": mp_epochs, "sparse_gates": sparse_gates}
    worst, results = 0.0, {}
    for dp, mp in MP_LAYOUTS:
        tasks = ["mp_step"] + (["mp_sparse", "mp_fit", "mp_lookup"] if dp == 1 else [])
        ranks = spawn_ranks(torch, dict(spec, name=f"mp{dp}x{mp}", tasks=tasks), dp * mp, root)
        results[(dp, mp)] = ranks
        for r, res in enumerate(ranks):
            step = res["mp_step"]
            if res["backend"] != "gloo" or step["launches"] != (ifwd, ibwd) or \
                    tuple(step["coords"]) != (r // mp, r % mp, dp, mp) or \
                    step["row0"] != (r // mp) * bs // dp:
                raise SystemExit(f"phase 6i (a) {dp}x{mp} rank {r}: backend {res['backend']}, "
                                 f"launches {step['launches']}, coords {step['coords']}, first "
                                 f"row {step['row0']}")
            ex = step["exchange"]
            log(f"[mp (a)] {dp}x{mp} rank {r} (data rank {r // mp}, model rank {r % mp}): "
                f"interaction launches {step['launches']} (fwd {ifwd} + bwd {ibwd}); the "
                f"exchange in the step: {ex['calls']} collectives, {ex['bytes']} bytes sent "
                f"({ex['row_bytes']} of rows), {ex['fallbacks']} fallbacks; other collectives "
                f"{step['stats']['calls']}, {step['stats']['bytes']} bytes; sharded "
                f"{step['sharded']}")
        for d, got in enumerate(mp_assemble(torch, ranks, dp, mp)):
            worst = max(worst, dp_check_step(
                torch, f"(a) {dp}x{mp} data rank {d}, {bs // dp} rows, tables in {mp} shards",
                got, ref, phase="6i"))
        same = all(torch.equal(res["mp_step"][k][n], ranks[0]["mp_step"][k][n])
                   for res in ranks for k in ("params", "state")
                   for n in res["mp_step"][k] if n not in res["mp_step"]["sharded"])
        same_shards = all(torch.equal(res["mp_step"]["params"][n],
                                      ranks[r % mp]["mp_step"]["params"][n])
                          for r, res in enumerate(ranks) for n in res["mp_step"]["sharded"])
        log(f"[mp (a)] {dp}x{mp}: the replicated leaves after the step bit for bit equal on "
            f"all {dp * mp} ranks: {same}; each shard across its data group: {same_shards}")
        if not (same and same_shards):
            raise SystemExit(f"phase 6i (a) {dp}x{mp}: the ranks' replicas or shards differ")
        if dp == 1:
            mp_check_sparse(torch, ranks, sparse_refs)
    # (b): fit_on_device at 1 x 2
    ranks = results[(1, MP)]
    steps = mp_epochs * (N_TRAIN // bs)
    eval_bs = dp_experiment("", fp32=False).train.eval_batch_size
    eval_batches = mp_epochs * -(-N_VALID // eval_bs)
    metrics = ("epoch", "train_loss", "auc", "logloss")
    hists = [res["mp_fit"]["hist"] for res in ranks]
    best = max(h["auc"] for h in hists[0])
    for r, res in enumerate(ranks):
        fit = res["mp_fit"]
        eps = [h["examples_per_sec"] for h in fit["hist"]]
        wall = [1e3 * h["seconds"] / (N_TRAIN // bs) for h in fit["hist"]]
        ex = fit["exchange"]
        log(f"[mp (b)] rank {r} of 1x{MP} (2 ranks sharing one card, gloo, the exchange "
            f"through host memory; not a scaling figure) on {card}: examples/s per epoch "
            f"{[f'{v:.0f}' for v in eps]}; a step's wall {[f'{v:.2f}' for v in wall]} ms; the "
            f"fit's exchange {ex['calls'] / steps:.1f} collectives and {ex['bytes'] / steps:.0f} "
            f"bytes a step ({ex['row_bytes'] / steps:.0f} of rows; eval batches included), "
            f"{ex['fallbacks']} fallbacks; interaction launches {fit['launches']}")
        for method, t in fit["exchange_times"].items():
            f_ms, b_ms = t["fwd_ms"], t["bwd_ms"]
            log(f"[mp (b)] rank {r} exchange alone, {method}: a step's lookups (item_id, "
                f"item_seq, likes_level, views_level) forward {f_ms[len(f_ms) // 2]:.2f} ms "
                f"(median of {len(f_ms)}, {f_ms[0]:.2f}-{f_ms[-1]:.2f}), {t['calls']} "
                f"collectives, {t['bytes']} bytes sent ({t['row_bytes']} of rows), "
                f"{t['fallbacks']} fallbacks; backward {b_ms[len(b_ms) // 2]:.2f} ms "
                f"({b_ms[0]:.2f}-{b_ms[-1]:.2f}), {t['bwd_bytes']} bytes (each owner "
                f"scatter-adds its own cotangents)")
        for h in fit["hist"]:
            log(f"[mp (b)] rank {r} epoch {int(h['epoch'])}: loss {h['train_loss']:.5f}, valid "
                f"auc {h['auc']:.5f}, {h['seconds']:.3f} s train, {h['eval_seconds']:.3f} s eval")
        if fit["launches"] != (ifwd * (steps + eval_batches), ibwd * steps):
            raise SystemExit(f"phase 6i (b) rank {r}: interaction launches {fit['launches']}")
        if fit["steps"] != steps or [[h[k] for k in metrics] for h in fit["hist"]] != \
                [[h[k] for k in metrics] for h in hists[0]] or fit["writes"] != (r == 0):
            raise SystemExit(f"phase 6i (b) rank {r}: steps {fit['steps']}, metrics or the "
                             "writing rank differ")
    losses = [h["train_loss"] for h in hists[0]]
    one = [h for h in dense["hist"] if int(h["epoch"]) <= mp_epochs]
    dense_best = max(h["auc"] for h in one)
    log(f"[mp (b)] best valid auc {best:.5f} vs phase 6's 1 process {dense_best:.5f} over "
        f"{mp_epochs} epochs (tolerance {DP_AUC_TOL}); export by world rank 0 "
        f"{ranks[0]['mp_fit']['export']}, resume point {ranks[0]['mp_fit']['resume_point']}")
    if (abs(best - dense_best) > DP_AUC_TOL or not all(np.isfinite(losses))
            or not losses[-1] < losses[0] or not ranks[0]["mp_fit"]["export"]
            or ranks[0]["mp_fit"]["resume_point"] != mp_epochs):
        raise SystemExit("phase 6i (b): the 1x2 fit is off phase 6's or wrote no export")
    # rank 0's export: whole tables, served in this process
    exp = mp_experiment(os.path.dirname(os.path.dirname(ranks[0]["mp_fit"]["export_path"])),
                        fp32=False, mp=1)
    params_np, state_np = jax_bridge.load(ranks[0]["mp_fit"]["export_path"])
    shapes = {k: v.shape for k, v in params_np["trunk"]["tables"].items()}
    fm = build_feature_map(exp.dataset)
    served_params, served_state = jax_bridge.params_from_jax(params_np, state_np, fm, exp.model)
    server = Predictor(exp, served_params, served_state, item_store=store, device=DP_DEVICE)
    score_fwd.launches = 0
    res = evaluate(server, valid, batch_size=B_FULL, gauc_col="user_id")
    n_batches = -(-N_VALID // B_FULL)
    one_tr = Trainer(exp, item_store=store, device=DP_DEVICE, log_fn=lambda s: None)
    one_tr.load_best()
    own = one_tr.evaluate_table(valid)["auc"]
    log(f"[mp (b)] world rank 0's export: tables {shapes} (whole); {eval_line(res, 'user_id')} "
        f"through Predictor on the fused scoring kernel ({score_fwd.launches} launches) on "
        f"{card}: |d| to the fit's best {abs(res['auc'] - best):.2e} (tolerance "
        f"{AUC_SERVE_TOL}); the trainer's eval forward in one process on the export "
        f"{own:.7f}, |d| {abs(own - best):.2e} (tolerance 1e-6)")
    want_rows = round_up_vocab(fm.table("item_id").vocab_size)
    if (not server.use_fused or score_fwd.launches != score_launches() * n_batches
            or abs(res["auc"] - best) > AUC_SERVE_TOL or abs(own - best) > 1e-6
            or shapes["item_id"][0] != want_rows):
        raise SystemExit("phase 6i (b): the export does not serve as the fit scored it")
    # (c): the lookup alone at 1 x 2
    for r, res_r in enumerate(ranks):
        lk = res_r["mp_lookup"]
        for key in ("batch/all_to_all", "batch/psum", "skew/all_to_all", "skew/psum"):
            v = lk[key]
            f_ms, b_ms = v["fwd_ms"], v["bwd_ms"]
            log(f"[mp (c)] rank {r} {key}: {v['ids']} ids ({v['pads']} pads) into the "
                f"{lk['vocab']} x {E} fp32 table ({lk['table_bytes'] / 1e6:.1f} MB, "
                f"{lk['shard_bytes'] / 1e6:.1f} MB a shard): bit for bit table[ids] "
                f"{v['equal']}; forward {f_ms[len(f_ms) // 2]:.2f} ms (median of {len(f_ms)}, "
                f"{f_ms[0]:.2f}-{f_ms[-1]:.2f}), backward {b_ms[len(b_ms) // 2]:.2f} ms; "
                f"{v['stats']['calls']} collectives, {v['stats']['bytes']} bytes sent "
                f"({v['stats']['row_bytes']} of rows), {v['stats']['fallbacks']} fallbacks; "
                f"{v['grad_rows']} shard rows with a gradient")
        if not all(lk[k]["equal"] for k in ("batch/all_to_all", "batch/psum", "skew/all_to_all",
                                              "skew/psum")) \
                or lk["skew/all_to_all"]["stats"]["fallbacks"] != 1 \
                or lk["batch/all_to_all"]["stats"]["fallbacks"] != 0:
            raise SystemExit(f"phase 6i (c) rank {r}: a lookup is not table[ids] or the "
                             "fallback was not taken as expected")
    for k, v in ranks[0]["mp_lookup"]["exchange_stats"].items():
        log(f"[mp (c)] exchange_stats of phase 6's first batch, {k}: {v}")
    log(f"[mp] phase 6i in {time.perf_counter() - t_phase:.1f} s")
    return {"grad_gap": worst, "best_auc": best, "fit": [res["mp_fit"] for res in ranks]}


# ---- phase 7c: profile_epoch, the reference state_dict import, item embeddings ----
PCA_TOL = 1e-5  # pca_project on the card vs float64 numpy (and the port's CPU run)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device events


def trace_summary(path: str, card: str, per_epoch: int) -> bool:
    """Read the profile_epoch trace at ``path``: one valid JSON file whose
    hand-written kernels (names in the ``ctr::`` namespace) ran exactly
    ``per_epoch`` times; prints the traced epoch's wall (the span of its
    events), the device-busy share (the union of the device events over
    that span) and the ten device operations of the longest total time.
    Returns False when the trace holds no device event."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        return False
    ours: dict[str, int] = {}
    for e in device:
        if e["cat"] == "kernel" and "ctr::" in e["name"]:
            name = e["name"].split("<")[0].split("(")[0].removeprefix("void ")
            ours[name] = ours.get(name, 0) + 1
    log(f"[profile] trace {os.path.basename(path)}: {os.path.getsize(path) / 2**20:.1f} MiB, "
        f"{len(events)} events, {len(device)} on the device; the hand-written kernels: {ours}")
    if sum(ours.values()) != per_epoch:
        raise SystemExit(f"profile_epoch: the trace holds {sum(ours.values())} launches of the "
                         f"hand-written kernels, expected {per_epoch} (one epoch)")
    t0 = min(e["ts"] for e in events)
    wall = max(e["ts"] + e["dur"] for e in events) - t0
    busy, end = 0.0, t0
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            end = hi
    totals: dict[str, list] = {}
    for e in device:
        t = totals.setdefault(e["name"], [0.0, 0])
        t[0] += e["dur"]
        t[1] += 1
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"[profile] traced epoch: wall {wall / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"= {busy / wall:.4f} of it, {len(device)} device operations, on {card}")
    for name, (dur, count) in top:
        log(f"[profile top] {dur / 1e3:.3f} ms total, {count} calls, "
            f"{dur / count:.2f} us each: {name[:110]}")
    return True


def profile_epoch_phase(torch, train, store, root, card) -> dict:
    """Phase 7c (a): Trainer.profile_epoch at the full defaults on phase 6's
    train split: exact interaction launches over both epochs, state.step 2
    epochs' steps, no metrics.csv, one trace whose hand-written kernels ran
    one epoch's launches. Profiles again (3 tries) when the trace holds no
    device event. Returns the launches of the run it keeps."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        bwd_launches,
        fwd_launches,
        interaction_bwd,
        interaction_fwd,
    )
    from ctr_recommendation_tpu_torch.training import Trainer

    ckpt = os.path.join(root, "ckpt_profile")
    exp = microlens_experiment(data_root="", checkpoint_dir=ckpt)
    steps = train.num_rows // exp.train.batch_size
    for attempt in range(3):
        log_dir = os.path.join(root, f"profile_{attempt}")
        tr = Trainer(exp, steps_per_epoch=steps, item_store=store, log_fn=log)
        interaction_fwd.launches = interaction_bwd.launches = 0
        t0 = time.perf_counter()
        tr.profile_epoch(train, log_dir)
        took = time.perf_counter() - t0
        launches = {interaction_fwd: interaction_fwd.launches,
                    interaction_bwd: interaction_bwd.launches}
        log(f"[profile] profile_epoch: {steps} steps x 2 epochs in {took:.2f} s (upload, the "
            f"untraced epoch, the traced one, the export); launches interaction_fwd "
            f"{launches[interaction_fwd]}, interaction_bwd {launches[interaction_bwd]}; "
            f"state.step {tr.state.step}")
        if (launches[interaction_fwd], launches[interaction_bwd]) != (
                2 * steps * fwd_launches(), 2 * steps * bwd_launches()):
            raise SystemExit("profile_epoch: the interaction kernels' launches are off")
        if tr.state.step != 2 * steps:
            raise SystemExit(f"profile_epoch: state.step {tr.state.step}, expected {2 * steps}")
        if os.path.exists(os.path.join(ckpt, "metrics.csv")) or tr.history:
            raise SystemExit("profile_epoch wrote metrics.csv or history")
        files = os.listdir(log_dir)
        if files != ["rank0.pt.trace.json"]:
            raise SystemExit(f"profile_epoch: expected one trace file, found {files}")
        if trace_summary(os.path.join(log_dir, files[0]), card,
                         steps * (fwd_launches() + bwd_launches())):
            return launches
        log(f"[profile] the trace holds no device event (try {attempt + 1} of 3)")
    raise SystemExit("profile_epoch: no trace held a device event in 3 tries")


def reference_state_dict(torch, exp, fm, seed: int) -> dict:
    """A reference-format MM_FiBiNET state_dict at ``exp``'s widths, seeded:
    the reference's names, torch's (out, in) Linear layout, BatchNorm
    running statistics and num_batches_tracked, the unused user table."""
    from ctr_recommendation_tpu_torch.models.registry import get_model

    rng = np.random.default_rng(seed)
    params, _ = get_model("mm_fibinet").init(torch.Generator().manual_seed(1), fm, exp.model)
    e = exp.model.embedding_dim

    def r(*shape, scale=0.05, loc=0.0):
        return torch.from_numpy((loc + scale * rng.standard_normal(shape)).astype(np.float32))

    mm_dim = params["trunk"]["dense"]["item_emb_d128"]["proj"]["w"].shape[0]
    f, red = params["senet"]["fc1"]["w"].shape
    sd = {
        "item_emb.weight": r(fm.table("item_id").vocab_size, e),
        "user_emb.weight": r(20000, e),
        "cate_emb.weight": r(fm.table("likes_level").vocab_size, e),
        "mm_proj.0.weight": r(e, mm_dim), "mm_proj.0.bias": r(e),
        "mm_proj.1.weight": r(e, loc=1.0), "mm_proj.1.bias": r(e),
        "senet.excitation.0.weight": r(red, f, scale=0.3), "senet.excitation.0.bias": r(red),
        "senet.excitation.2.weight": r(f, red, scale=0.3), "senet.excitation.2.bias": r(f),
    }
    if exp.model.bilinear_type == "all":
        sd["bilinear.W"] = r(e, e, scale=0.1)
    else:
        sd.update({f"bilinear.W_list.{i}": r(e, e, scale=0.1) for i in range(f - 1)})
    for k, (tl, tb) in enumerate(((0, 1), (4, 5))):
        d_in, d_out = params["mlp"]["layers"][k]["linear"]["w"].shape
        sd.update({
            f"mlp.{tl}.weight": r(d_out, d_in, scale=d_in ** -0.5), f"mlp.{tl}.bias": r(d_out),
            f"mlp.{tb}.weight": r(d_out, loc=1.0), f"mlp.{tb}.bias": r(d_out),
            f"mlp.{tb}.running_mean": r(d_out),
            f"mlp.{tb}.running_var": torch.from_numpy(
                rng.uniform(0.5, 1.5, d_out).astype(np.float32)),
            f"mlp.{tb}.num_batches_tracked": torch.tensor(1000),
        })
    h2 = params["mlp"]["out"]["w"].shape[0]
    sd["mlp.8.weight"] = r(1, h2, scale=1.0)  # logits of std ~0.5: probabilities spread
    sd["mlp.8.bias"] = r(1)
    return sd


# imported leaf -> (state_dict key, transposed); the tables hold the rows in their prefix
IMPORTED = {
    "params/trunk/tables/item_id": ("item_emb.weight", False),
    "params/trunk/tables/likes_level": ("cate_emb.weight", False),
    "params/trunk/dense/item_emb_d128/proj/w": ("mm_proj.0.weight", True),
    "params/trunk/dense/item_emb_d128/proj/b": ("mm_proj.0.bias", False),
    "params/trunk/dense/item_emb_d128/ln_scale": ("mm_proj.1.weight", False),
    "params/trunk/dense/item_emb_d128/ln_bias": ("mm_proj.1.bias", False),
    "params/senet/fc1/w": ("senet.excitation.0.weight", True),
    "params/senet/fc1/b": ("senet.excitation.0.bias", False),
    "params/senet/fc2/w": ("senet.excitation.2.weight", True),
    "params/senet/fc2/b": ("senet.excitation.2.bias", False),
    "params/bilinear/w": ("bilinear.W", False),
    **{f"params/mlp/layers/{k}/{leaf}": (f"mlp.{i}.{name}", leaf == "linear/w")
       for k, (tl, tb) in enumerate(((0, 1), (4, 5)))
       for leaf, i, name in (("linear/w", tl, "weight"), ("linear/b", tl, "bias"),
                             ("bn_scale", tb, "weight"), ("bn_bias", tb, "bias"))},
    **{f"model_state/mlp/layers/{k}/{leaf}": (f"mlp.{tb}.{name}", False)
       for k, tb in enumerate((1, 5))
       for leaf, name in (("bn_mean", "running_mean"), ("bn_var", "running_var"))},
    "params/mlp/out/w": ("mlp.8.weight", True),
    "params/mlp/out/b": ("mlp.8.bias", False),
}


@contextlib.contextmanager
def plain_scoring():
    """Predictor's fused branch on the scoring kernel's plain version: the
    same trunk output, the same prepared weights, no launch."""
    from ctr_recommendation_tpu_torch.inference import predictor
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd_plain

    kernel, predictor.score_fwd = predictor.score_fwd, score_fwd_plain
    try:
        yield
    finally:
        predictor.score_fwd = kernel


def import_phase(torch, store, rows, card) -> int:
    """Phase 7c (b): a seeded reference-format state_dict at full width
    through import_state_dict, every imported leaf its state_dict tensor
    (transposed where due), served through Predictor.score_table on phase
    4's rows: score_launches() launches a batch, within TOL["fused_score"]
    of the plain version on the same inputs. Returns the launches."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import TableData
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
    from ctr_recommendation_tpu_torch.tools.torch_import import import_state_dict

    exp = microlens_experiment(data_root="")
    fm = build_feature_map(exp.dataset)
    sd = reference_state_dict(torch, exp, fm, seed=17)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    log(f"[import] reference state_dict: {len(sd)} tensors, "
        f"{sum(v.numel() for v in sd.values())} values; " + ", ".join(
            f"{k} {shapes[k]}" for k in ("item_emb.weight", "cate_emb.weight", "user_emb.weight",
                                         "mm_proj.0.weight", "mlp.0.weight", "mlp.8.weight")))
    t0 = time.perf_counter()
    params, state = import_state_dict({f"module.{k}": v for k, v in sd.items()}, exp, fm)
    log(f"[import] import_state_dict in {time.perf_counter() - t0:.2f} s (DataParallel keys)")
    flat = {f"params/{k}": v for k, v in flatten(params).items()}
    flat.update({f"model_state/{k}": v for k, v in flatten(state).items()})
    for path, (key, transposed) in IMPORTED.items():
        want = sd[key].t() if transposed else sd[key]
        got = flat[path][: want.shape[0]]
        if got.dtype != torch.float32 or got.device.type != "cpu" or not torch.equal(got, want):
            raise SystemExit(f"import_state_dict: {path} is not {key}"
                             + (" transposed" if transposed else ""))
    log(f"[import] every one of the {len(IMPORTED)} imported leaves equals its state_dict "
        f"tensor (transposed where due); the tables in their first rows "
        f"({shapes['item_emb.weight'][0]} of {tuple(flat['params/trunk/tables/item_id'].shape)})")

    pred = Predictor(exp, params, state, item_store=store)
    if not pred.use_fused:
        raise SystemExit("the imported checkpoint must serve through the fused branch")
    table = TableData(rows, N_ROWS)
    pred.score_table(TableData({k: v[:B_FULL] for k, v in rows.items()}, B_FULL))  # warm-up
    torch.cuda.synchronize()
    score_fwd.launches = 0
    t0 = time.perf_counter()
    probs = pred.score_table(table)
    took = time.perf_counter() - t0
    launches = score_fwd.launches
    with plain_scoring():
        plain = pred.score_table(table)
    if score_fwd.launches != launches:
        raise SystemExit("the plain scoring version launched a kernel")
    tol = TOL[("fused_score", "bfloat16")][0]
    err = float(np.abs(probs - plain).max())
    n_batches = N_ROWS // B_FULL
    log(f"[import] served {N_ROWS} rows through Predictor.score_table in {took:.4f} s on {card}: "
        f"fused_score launches {launches} ({n_batches} batches x {score_launches()}), "
        f"probabilities {probs.min():.4f}..{probs.max():.4f} (std {probs.std():.4f}), "
        f"max_abs_err vs the plain version on the same inputs {err:.3e} (tolerance {tol})")
    if launches != n_batches * score_launches():
        raise SystemExit(f"score_table launched {launches} scoring kernels, expected "
                         f"{n_batches} x {score_launches()}")
    if probs.shape != (N_ROWS,) or not np.isfinite(probs).all() or err > tol:
        raise SystemExit("the imported checkpoint's scores are off")
    if probs.std() < 1e-3:
        raise SystemExit("the imported checkpoint scores every row alike")
    return launches


def item_texts(n: int, seed: int) -> list[str]:
    """``n`` seeded item texts in the Task-1 format: Zipf-distributed title
    words (2-12) and tags (0-4), random levels, 2% with no title and no
    tags."""
    from ctr_recommendation_tpu_torch.tools.item_embeddings import build_text

    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(20_000)])
    pw = 1.0 / np.arange(1, len(words) + 1)
    tags = np.array([f"tag{i}" for i in range(500)])
    pt = 1.0 / np.arange(1, len(tags) + 1) ** 0.8
    nw, ng = rng.integers(2, 13, n), rng.integers(0, 5, n)
    levels = rng.integers(0, 11, (n, 2))
    blank = rng.random(n) < 0.02
    tw = rng.choice(words, size=int(nw.sum()), p=pw / pw.sum())
    gw = rng.choice(tags, size=int(ng.sum()), p=pt / pt.sum())
    out, a, b = [], 0, 0
    for i in range(n):
        title, tg = " ".join(tw[a : a + nw[i]]), list(gw[b : b + ng[i]])
        a, b = a + nw[i], b + ng[i]
        if blank[i]:
            title, tg = "", []
        out.append(build_text(title, tg, int(levels[i, 0]), int(levels[i, 1])))
    return out


def pca_numpy(x: np.ndarray, k: int) -> np.ndarray:
    """pca_project's plain version: float64 numpy SVD, svd_flip on U,
    truncate, L2-renormalize; float32."""
    xc = x.astype(np.float64)
    xc -= xc.mean(axis=0, keepdims=True)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    u *= np.sign(u[np.argmax(np.abs(u), axis=0), np.arange(u.shape[1])])
    proj = u[:, :k] * s[:k]
    return (proj / np.maximum(np.linalg.norm(proj, axis=1, keepdims=True), 1e-8)).astype(
        np.float32)


def item_embeddings_phase(torch, root, card) -> None:
    """Phase 7c (c): HashTextEncoder over 91,718 seeded item texts on the
    host, pca_project on the card to 128 dims against float64 numpy and the
    port's CPU run (within PCA_TOL); set_seed's generator and whether the
    TensorBoard writer is active on this machine."""
    from ctr_recommendation_tpu_torch.tools.item_embeddings import HashTextEncoder, pca_project
    from ctr_recommendation_tpu_torch.utils import set_seed
    from ctr_recommendation_tpu_torch.utils.tb import ScalarWriter

    n, k = 91_718, 128
    t0 = time.perf_counter()
    texts = item_texts(n, seed=23)
    t_texts = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = HashTextEncoder().encode(texts)
    t_hash = time.perf_counter() - t0
    log(f"[item_emb] {n} texts made in {t_texts:.2f} s; HashTextEncoder on the host: "
        f"{raw.shape} {raw.dtype} in {t_hash:.2f} s = {n / t_hash:.0f} items/s")
    if not np.isfinite(raw).all():
        raise SystemExit("HashTextEncoder output is not finite")
    pca_project(raw[:4096], k)  # warm-up: the card's linear-algebra handles
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = pca_project(raw, k)  # returns numpy: the card's work is done
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    want = pca_numpy(raw, k)
    t_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = pca_project(raw, k, device="cpu")
    t_cpu = time.perf_counter() - t0
    err_np, err_cpu = float(np.abs(got - want).max()), float(np.abs(got - cpu).max())
    log(f"[item_emb] pca_project {raw.shape} -> {got.shape} on {card}: {min(times):.1f} ms "
        f"(best of 3, float64, host array in and out; runs {[round(t, 1) for t in times]}); "
        f"float64 numpy SVD on the host {t_np:.2f} s; the port on the CPU {t_cpu:.2f} s; "
        f"max_abs_err vs numpy {err_np:.3e}, vs the CPU run {err_cpu:.3e} (tolerance {PCA_TOL})")
    norms = np.linalg.norm(got, axis=1)
    if got.shape != (n, k) or got.dtype != np.float32 or not np.allclose(norms, 1.0, atol=1e-5):
        raise SystemExit("pca_project: not L2-normed float32 rows of the expected shape")
    if err_np > PCA_TOL or err_cpu > PCA_TOL:
        raise SystemExit("pca_project on the card disagrees")
    gen = set_seed(2025)
    with tempfile.TemporaryDirectory(dir=root) as tb:
        writer = ScalarWriter(tb)
        active = writer.active
        writer.close()
    have = {m: importlib.util.find_spec(m) is not None for m in ("pyarrow", "PIL", "tensorboard")}
    log(f"[item_emb] set_seed(2025) -> a torch.Generator on {gen.device} "
        f"(seed {gen.initial_seed()}); ScalarWriter(...).active {active}"
        + ("" if active else " (no tensorboard package on this machine: the writer is a "
           "no-op and metrics.csv stays the record)") + f"; packages here: {have}")
    if gen.device.type != "cuda":
        raise SystemExit("set_seed must return a generator on the card")


# ---- phase 7b: online serving over HTTP (serving/, the fused scoring kernel) ----
# ragged request sizes: every bucket of DEFAULT_BUCKETS and past its boundary
SERVE_RAGGED = (1, 15, 17, 63, 255, 1023, 4097)
SERVE_REPS = {4096: 10, 8192: 10}  # sequential requests a bucket in the latency run, else 30
SERVE_CLIENTS, SERVE_CLIENT_REQS, SERVE_CLIENT_ROWS = 16, 16, 64  # the load run: 1..64 rows
SASREC_SERVE_BUCKETS = (16, 256, 8192)
SASREC_SERVE_RAGGED = (1, 15, 17, 255, 257, 4097)
HTTP_TIMEOUT_S = 120


def request_rows(collator, cols: dict, idx, vectors=None) -> list[dict]:
    """Rows ``idx`` of a split's columns as JSON request rows: ids as ints,
    each history without its left padding (the collator pads it back);
    with ``vectors`` (the rows' item vectors) the client ships the dense
    column, else the server joins it."""
    from ctr_recommendation_tpu_torch.config.schema import FeatureType

    idx = np.asarray(idx)
    rows = [{} for _ in idx]
    for f in collator.features:
        if f.type == FeatureType.CATEGORICAL:
            for r, v in zip(rows, cols[f.name][idx].tolist()):
                r[f.name] = v
        elif f.type == FeatureType.SEQUENCE:
            seq = cols[f.name][idx]
            first = np.where((seq != f.pad_id).any(1), (seq != f.pad_id).argmax(1), seq.shape[1])
            for r, s, k in zip(rows, seq.tolist(), first.tolist()):
                r[f.name] = s[k:]
        elif vectors is not None:
            for r, v in zip(rows, vectors[idx].tolist()):
                r[f.name] = v
    return rows


def post(url: str, body: bytes) -> tuple[int, dict]:
    """POST ``body`` (JSON bytes) to ``url``: (status, the JSON answer)."""
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def http_service(service):
    """``service`` behind make_http_server on port 0, served from a thread;
    yields the score URL. Shuts the server down and closes the service (its
    batcher thread joined) on the way out."""
    from ctr_recommendation_tpu_torch.serving import make_http_server

    server = make_http_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/v1/score"
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=HTTP_TIMEOUT_S)
        if thread.is_alive() or service.batcher._thread.is_alive():
            raise SystemExit("the HTTP server or the batcher thread did not stop")


def score_requests(url, collator, cols, ref, sizes, start: int = 0, vectors=None) -> tuple:
    """POST consecutive rows of ``cols`` in requests of ``sizes``; each must
    answer 200. Returns the probabilities (fp32, in row order), and per
    request (rows, bucket, bit-equal to ``ref``'s rows, max |d| from them)."""
    out, per = [], []
    for n in sizes:
        idx = np.arange(start, start + n)
        code, body = post(url, json.dumps(
            {"rows": request_rows(collator, cols, idx, vectors)}).encode())
        if code != 200:
            raise SystemExit(f"serve: a request of {n} rows answered {code}: {body}")
        got = np.asarray(body["probs"], np.float32)
        per.append((n, collator.bucket_for(n), bool(np.array_equal(got, ref[idx])),
                    float(np.abs(got - ref[idx]).max())))
        out.append(got)
        start += n
    return np.concatenate(out), per


class TimedPredictor:
    """A Predictor with CUDA events and the host clock around each call:
    ``calls`` holds (events, host start, host ms) a call."""

    def __init__(self, torch, pred):
        self.torch, self.pred, self.calls = torch, pred, []

    def __call__(self, batch):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = self.pred(batch)
        ev[1].record()
        self.calls.append((ev, t0, (time.perf_counter() - t0) * 1e3))
        return out


def device_busy_ms(torch, pred, batch, reps: int = 5) -> float:
    """torch.profiler's device time a call of ``pred`` on ``batch`` (the
    kernels' and copies' self time summed), the call read back each time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        pred(batch).cpu()
    for _ in range(3):  # the card's trace now and then holds no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                pred(batch).cpu()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy:
            return busy / reps / 1e3
    raise SystemExit("torch.profiler saw no device time in three tries")


def bucket_dependence(torch, pred, cols, card) -> None:
    """The first 8192 rows in a random order, scored in batches of each
    bucket B (the rows of a coalesced dispatch sit elsewhere than in
    score_table's batch), against the same rows in score_table's B=8192
    batch: how many rows' trunk output x differs, field by field (the join,
    lookups and pooling of the trunk, the item projection, in PyTorch); how
    many rows' scores the kernel gives otherwise on the very same x rows;
    how many rows' scores differ, and by how much; for attention pooling,
    how many rows the encoder kernel encodes otherwise. Names the step whose
    result depends on B or on a row's place in the batch, if one does."""
    from ctr_recommendation_tpu_torch.config.schema import FeatureType
    from ctr_recommendation_tpu_torch.data.device_store import device_join
    from ctr_recommendation_tpu_torch.features.hashing import apply_hashing
    from ctr_recommendation_tpu_torch.models import trunk
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import fused_encode
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd
    from ctr_recommendation_tpu_torch.serving.collator import DEFAULT_BUCKETS

    cfg = pred.exp.model

    def x_of(idx):
        batch = pred._upload({k: v[idx] for k, v in cols.items()})
        feats = apply_hashing(device_join(batch, pred._mm_tables, pred._join_plan),
                              pred._hash_plan)
        return trunk.apply(pred.params["trunk"], pred.fm, cfg, feats,
                           seq_pooling=pred.module.SEQ_POOLING,
                           compute_dtype=pred.compute_dtype).to(pred.tower_dtype).contiguous()

    def score(x):
        return score_fwd(x, *pred._score_weights, bilinear_type=cfg.bilinear_type)

    seq = pred.fm.features_of_type(FeatureType.SEQUENCE)[0]

    def encoded_of(idx):  # the encoder kernel's output alone (attention pooling)
        ids = torch.as_tensor(cols[seq.name][idx]).to(pred.device)
        emb = trunk.gather(pred.params["trunk"]["tables"][pred.fm.table_of[seq.name]], ids)
        return fused_encode(pred.params["trunk"]["attn"][seq.name], emb.to(pred.compute_dtype),
                            ids, num_heads=cfg.attn_num_heads, pad_id=seq.pad_id)

    attention = pred.module.SEQ_POOLING == "attention"
    rng = np.random.default_rng(5)
    report = {}
    with torch.inference_mode():
        x_full = x_of(np.arange(B_FULL))
        p_full = score(x_full)
        enc_full = encoded_of(np.arange(B_FULL)) if attention else None
        for b in DEFAULT_BUCKETS:
            perm = rng.permutation(B_FULL)
            xs, ps, same_x, encs = [], [], [], []
            for i in range(0, B_FULL, b):
                xs.append(x_of(perm[i : i + b]))
                ps.append(score(xs[-1]))
                same_x.append(score(x_full[perm[i : i + b]].contiguous()))
                if attention:
                    encs.append(encoded_of(perm[i : i + b]))
            want_x, want_p = x_full[perm], p_full[perm]
            fields = (torch.cat(xs) != want_x).any(-1).sum(0).tolist()
            p = torch.cat(ps)
            report[b] = {
                "rows whose x differs, by field": {
                    name: n for name, n in zip(pred.fm.field_names, fields) if n},
                "rows the kernel scores otherwise on the same x": int(
                    (torch.cat(same_x) != want_p).sum()),
                "rows whose score differs": int((p != want_p).sum()),
                "max|d|": float((p - want_p).abs().max()),
            }
            if attention:
                report[b]["rows the encoder kernel encodes otherwise"] = int(
                    (torch.cat(encs) != enc_full[perm]).flatten(1).any(1).sum())
    log(f"[serve] {pred.exp.model.model}: the first {B_FULL} rows in random order in batches of "
        f"B against score_table's batch, on {card}: {report}")


def serve_http(torch, mm: dict, sasrec: dict, valid, store, card) -> None:
    """Phase 7b (see the module docstring): phase 7's exports served over
    HTTP through serving/ (RequestCollator, MicroBatcher, ScoringService,
    make_http_server) on the fused scoring kernel, and the encoder's
    forward for sasrec_fibinet."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encode_fwd, fwd_launches
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches
    from ctr_recommendation_tpu_torch.serving import ScoringService
    from ctr_recommendation_tpu_torch.serving.collator import DEFAULT_BUCKETS
    from ctr_recommendation_tpu_torch.training.metrics import auc

    t_phase = time.perf_counter()
    atol = TOL[("fused_score", "bfloat16")][0]  # the bar where a plan depends on B
    cols, n_valid = valid.columns, valid.num_rows
    pred = mm["server"]
    labels = torch.as_tensor(np.asarray(cols["label"], np.float32), device=pred.device)

    def served_auc(probs) -> float:  # as evaluate computes it, on the card
        return float(auc(labels, torch.as_tensor(probs, device=pred.device)))

    def counts():
        return encode_fwd.launches, score_fwd.launches, interaction_fwd.launches

    def reset():
        encode_fwd.launches = score_fwd.launches = interaction_fwd.launches = 0

    def within(per, tag):
        bad = [p for p in per if p[3] > atol]
        if bad:
            raise SystemExit(f"serve {tag}: requests (rows, bucket, bit-equal, max|d|) {bad} "
                             f"outside {atol} of score_table")

    # ---- mm_fibinet: warmup, correctness, latency a bucket, concurrent load ----
    ref = pred.score_table(valid, B_FULL)
    if served_auc(ref) != mm["served_auc"]:
        raise SystemExit("score_table's AUC on the valid split is not phase 7's")
    service = ScoringService(pred, pred.fm, model_name="mm_fibinet", max_wait_ms=2.0)
    collator = service.collator
    if collator.buckets != DEFAULT_BUCKETS:
        raise SystemExit(f"the service's buckets {collator.buckets} are not DEFAULT_BUCKETS")
    per_call = score_launches()
    with http_service(service) as url:
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        service.warmup()
        t_warm = time.perf_counter() - t0
        warm = counts()
        log(f"[serve warmup] {len(DEFAULT_BUCKETS)} buckets x 2 structures in {t_warm:.3f} s on "
            f"{card}; launches (encode_fwd, fused_score, interaction_fwd) {warm}")
        if warm != (0, len(DEFAULT_BUCKETS) * 2 * per_call, 0):
            raise SystemExit(f"warmup launched {warm}, expected "
                             f"(0, {len(DEFAULT_BUCKETS) * 2 * per_call}, 0)")

        # correctness: the split in whole buckets, then ragged requests
        reset()
        before = service.stats()
        full, per_full = score_requests(url, collator, cols, ref, [B_FULL] * (n_valid // B_FULL))
        auc_full = served_auc(full)
        log(f"[serve] valid split ({n_valid} rows, no dense column) in requests of {B_FULL}: "
            f"bit-equal to score_table {all(p[2] for p in per_full)}, max|d| "
            f"{max(p[3] for p in per_full):.3e}; served AUC {auc_full:.7f}, phase 7's "
            f"{mm['served_auc']:.7f} on {card}")
        if not all(p[2] for p in per_full) or auc_full != mm["served_auc"]:
            raise SystemExit("served scores at B=8192 are not score_table's, or the served AUC "
                             "is not phase 7's")
        ragged, per_ragged = score_requests(url, collator, cols, ref, SERVE_RAGGED)
        again, _ = score_requests(url, collator, cols, ref, SERVE_RAGGED)
        log(f"[serve] ragged requests (rows, bucket, bit-equal to score_table, max|d|): "
            f"{per_ragged}; repeats bit-identical {np.array_equal(ragged, again)} (bar {atol})")
        within(per_ragged, "ragged")
        if not np.array_equal(ragged, again):
            raise SystemExit("a repeated request did not get bit-identical scores")
        # the client ships the store's item vectors: the join's scores bit for bit
        vectors = store.emb
        ids = cols["item_id"]
        if ids.min() < 0 or ids.max() >= len(vectors):
            raise SystemExit("valid item ids outside the item store")
        dense_full, _ = score_requests(url, collator, cols, ref, [B_FULL], vectors=vectors[ids])
        dense_ragged, _ = score_requests(url, collator, cols, ref, SERVE_RAGGED,
                                         vectors=vectors[ids])
        dense_equal = (np.array_equal(dense_full, full[:B_FULL])
                       and np.array_equal(dense_ragged, ragged))
        log(f"[serve] the same rows with item_emb_d128 shipped by the client: bit-equal to the "
            f"join's scores {dense_equal}")
        if not dense_equal:
            raise SystemExit("client-shipped item vectors scored unlike the device join")
        # an out-of-range item_id beside well-formed requests: 400 alone
        vocab = pred.fm.table(pred.fm.table_of["item_id"]).vocab_size
        bad_rows = request_rows(collator, cols, np.arange(4))
        bad_rows[1]["item_id"] = vocab
        mixed = [("bad", bad_rows)] + [
            (f"good{i}", request_rows(collator, cols, np.arange(8 * i, 8 * i + 8)))
            for i in range(1, 5)]
        replies: dict = {}
        gate = threading.Barrier(len(mixed))

        def send(name, rows):
            gate.wait(timeout=HTTP_TIMEOUT_S)
            replies[name] = post(url, json.dumps({"rows": rows}).encode())

        coalesced0 = service.stats()["coalesced_batches"]
        threads = [threading.Thread(target=send, args=m) for m in mixed]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        codes = {k: v[0] for k, v in replies.items()}
        log(f"[serve] out-of-range item_id {vocab} sent beside 4 well-formed requests: "
            f"status {codes} ({replies.get('bad', (0, {}))[1].get('error', '')!r}); "
            f"coalesced dispatches {service.stats()['coalesced_batches'] - coalesced0}")
        if codes != {"bad": 400, **{f"good{i}": 200 for i in range(1, 5)}}:
            raise SystemExit(f"the malformed request's neighbours did not all get 200: {codes}")
        for i in range(1, 5):
            got = np.asarray(replies[f"good{i}"][1]["probs"], np.float32)
            if np.abs(got - ref[8 * i : 8 * i + 8]).max() > atol:
                raise SystemExit("a request coalesced beside a malformed one scored wrong")
        dispatched = service.stats()["batches_dispatched"] - before["batches_dispatched"]
        if counts() != (0, dispatched * per_call, 0):
            raise SystemExit(f"correctness requests launched {counts()} in {dispatched} "
                             f"dispatches, expected {dispatched * per_call} scoring launches")

        # latency a bucket: one client, sequential, full buckets
        timed = TimedPredictor(torch, pred)
        service.batcher.predictor = timed
        validate = collator.validate_chunk
        entered = {"t": None}  # the batcher's first validate call of a request

        def timed_validate(rows):
            if entered["t"] is None:
                entered["t"] = time.perf_counter()
            return validate(rows)

        collator.validate_chunk = timed_validate
        http_ms = []
        for _ in range(30):  # an HTTP round trip that scores nothing
            t0 = time.perf_counter()
            with urllib.request.urlopen(url.replace("/v1/score", "/healthz"),
                                        timeout=HTTP_TIMEOUT_S) as resp:
                resp.read()
            http_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"[serve latency] GET /healthz (no scoring): p50 {np.percentile(http_ms, 50):.3f} ms, "
            f"p99 {np.percentile(http_ms, 99):.3f} ms on {card}")
        rng = np.random.default_rng(21)
        for b in DEFAULT_BUCKETS:
            e2e, json_ms, host_ms = [], [], []
            timed.calls.clear()
            for _ in range(SERVE_REPS.get(b, 30)):
                idx = rng.integers(0, n_valid, b)
                rows = request_rows(collator, cols, idx)
                entered["t"] = None
                t0 = time.perf_counter()
                body = json.dumps({"rows": rows}).encode()
                t_encode = time.perf_counter() - t0
                code, reply = post(url, body)
                t1 = time.perf_counter()
                if code != 200 or len(reply["probs"]) != b:
                    raise SystemExit(f"latency run: a {b}-row request answered {code}")
                if np.abs(np.asarray(reply["probs"], np.float32) - ref[idx]).max() > atol:
                    raise SystemExit(f"latency run: a {b}-row request scored outside the bar")
                e2e.append((t1 - t0) * 1e3)
                # validate + collate: from the batcher's validate call to the predictor call
                host_ms.append((timed.calls[-1][1] - entered["t"]) * 1e3)
                # the rest of the JSON on the path, the same bytes timed here:
                # the handler's parse and answer, the client's read of it
                t2 = time.perf_counter()
                json.loads(body)
                json.loads(json.dumps(reply).encode())
                json_ms.append((t_encode + time.perf_counter() - t2) * 1e3)
            torch.cuda.synchronize()
            span = [ev[0].elapsed_time(ev[1]) for ev, _, _ in timed.calls]
            busy = device_busy_ms(torch, pred, collator.collate(
                request_rows(collator, cols, np.arange(b)))[0])
            p50 = float(np.percentile(e2e, 50))
            collate_ms, json_med = float(np.median(host_ms)), float(np.median(json_ms))
            log(f"[serve latency] bucket {b}: {len(e2e)} requests, p50 {p50:.3f} ms, p99 "
                f"{np.percentile(e2e, 99):.3f} ms end to end; validate + collate "
                f"{collate_ms:.3f} ms, JSON {json_med:.3f} ms (host share "
                f"{(collate_ms + json_med) / p50:.2f} of p50); the batcher lingers up to "
                f"{service.batcher.max_wait_s * 1e3:.1f} ms below a full {collator.max_batch}; "
                f"predictor call {np.median([c[2] for c in timed.calls]):.4f} ms host, "
                f"{np.median(span):.4f} ms between CUDA events around it, device busy "
                f"{busy:.4f} ms (torch.profiler; idle {1 - busy / p50:.3f} of p50) on {card}")
        collator.validate_chunk = validate
        service.batcher.predictor = pred

        # concurrent load: 16 clients x 16 requests of 1..64 rows
        rng = np.random.default_rng(16)
        plans = [[(int(rng.integers(0, n_valid - SERVE_CLIENT_ROWS)),
                   int(rng.integers(1, SERVE_CLIENT_ROWS + 1)))
                  for _ in range(SERVE_CLIENT_REQS)] for _ in range(SERVE_CLIENTS)]
        bodies = [[json.dumps({"rows": request_rows(collator, cols, np.arange(s, s + n))})
                   .encode() for s, n in plan] for plan in plans]
        results: list = [[] for _ in plans]
        gate = threading.Barrier(SERVE_CLIENTS + 1)

        def client(c):
            gate.wait(timeout=HTTP_TIMEOUT_S)
            for body in bodies[c]:
                t = time.perf_counter()
                code, reply = post(url, body)
                results[c].append((code, reply, (time.perf_counter() - t) * 1e3))

        reset()
        before = service.stats()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        gate.wait(timeout=HTTP_TIMEOUT_S)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        after = service.stats()
        load_counts = counts()
    # the batcher thread has stopped: its launch counts are final
    if counts() != load_counts:
        raise SystemExit("launches were counted after the load run's last response")
    delta = {k: after[k] - before[k] for k in after}
    n_req = SERVE_CLIENTS * SERVE_CLIENT_REQS
    lat, worst, equal = [], 0.0, 0
    for plan, res in zip(plans, results):
        if len(res) != len(plan):
            raise SystemExit("a load client did not finish")
        for (s, n), (code, reply, ms) in zip(plan, res):
            if code != 200:
                raise SystemExit(f"load run: a {n}-row request answered {code}: {reply}")
            got = np.asarray(reply["probs"], np.float32)
            worst = max(worst, float(np.abs(got - ref[s : s + n]).max()))
            equal += bool(np.array_equal(got, ref[s : s + n]))
            lat.append(ms)
    rows = sum(n for plan in plans for _, n in plan)
    log(f"[serve load] {SERVE_CLIENTS} clients x {SERVE_CLIENT_REQS} requests of 1-"
        f"{SERVE_CLIENT_ROWS} rows ({rows} rows) in {wall:.3f} s: {n_req / wall:.1f} requests/s, "
        f"{rows / wall:.0f} rows/s, p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms; stats {delta}, requests a dispatch "
        f"{delta['requests_served'] / max(delta['batches_dispatched'], 1):.2f}; launches "
        f"(encode_fwd, fused_score, interaction_fwd) {load_counts}; vs score_table: "
        f"{equal}/{n_req} bit-equal, max|d| {worst:.3e} (bar {atol}) on {card}")
    if delta["requests_served"] != n_req or delta["coalesced_batches"] < 1:
        raise SystemExit(f"the load run served {delta} (expected {n_req} requests, some "
                         "coalesced)")
    if load_counts != (0, delta["batches_dispatched"] * per_call, 0):
        raise SystemExit(f"the load run launched {load_counts}, expected "
                         f"{delta['batches_dispatched']} x {per_call} scoring launches")
    if worst > atol:
        raise SystemExit("a coalesced request's scores are not its own within the bar")
    bucket_dependence(torch, pred, {k: v for k, v in cols.items() if k != "label"}, card)

    # ---- sasrec_fibinet: the encoder forward + the scoring kernel a dispatch ----
    spred = sasrec["server"]
    sref = spred.score_table(valid, B_FULL)
    per_enc = fwd_launches(spred.exp.model.attn_num_layers)
    service = ScoringService(spred, spred.fm, model_name="sasrec_fibinet",
                             buckets=SASREC_SERVE_BUCKETS, max_wait_ms=2.0)
    with http_service(service) as url:
        torch.cuda.synchronize()
        reset()
        service.warmup()
        warm = counts()
        n_warm = len(SASREC_SERVE_BUCKETS) * 2
        if warm != (n_warm * per_enc, n_warm * per_call, 0):
            raise SystemExit(f"sasrec warmup launched {warm}, expected "
                             f"({n_warm * per_enc}, {n_warm * per_call}, 0)")
        reset()
        before = service.stats()
        full, per_full = score_requests(url, service.collator, cols, sref,
                                        [B_FULL] * (n_valid // B_FULL))
        ragged, per_ragged = score_requests(url, service.collator, cols, sref,
                                            SASREC_SERVE_RAGGED)
        dispatched = service.stats()["batches_dispatched"] - before["batches_dispatched"]
        served = counts()
    s_auc = served_auc(full)
    log(f"[serve sasrec_fibinet] buckets {SASREC_SERVE_BUCKETS}: warmup launches "
        f"(encode_fwd, fused_score, interaction_fwd) {warm}; {dispatched} dispatches launched "
        f"{served}; whole buckets bit-equal to score_table {all(p[2] for p in per_full)}; "
        f"ragged (rows, bucket, bit-equal, max|d|) {per_ragged}; served AUC {s_auc:.7f}, "
        f"phase 6b's {sasrec['served_auc']:.7f} on {card}")
    if served != (dispatched * per_enc, dispatched * per_call, 0):
        raise SystemExit(f"sasrec dispatches launched {served}, expected {dispatched} x "
                         f"({per_enc}, {per_call}, 0)")
    if not all(p[2] for p in per_full) or s_auc != sasrec["served_auc"]:
        raise SystemExit("sasrec: served scores at B=8192 are not score_table's")
    within(per_ragged, "sasrec ragged")
    bucket_dependence(torch, spred, {k: v for k, v in cols.items() if k != "label"}, card)
    log(f"[serve] phase 7b in {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if argv[:1] == ["--dp-rank"] and len(argv) == 2:  # a rank of phase 6h (spawn_ranks)
        return dp_rank(argv[1])
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    from ctr_recommendation_tpu_torch.ops.cuda import build
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        bwd_launches as inter_bwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        fwd_launches as inter_fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches

    # ---- phase 1: card, build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = smi.strip()
    from concurrent.futures import ThreadPoolExecutor

    from ctr_recommendation_tpu_torch.data import native

    def build_native():
        t = time.perf_counter()
        return native.build(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc builds
        native_build = pool.submit(build_native)
        per = build.build()
        native_lib, native_s = native_build.result()  # raises when g++ failed
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per source {per}")
    if not native.submission_available():
        raise SystemExit(f"the native submission writer {native_lib} built but did not load")
    log(f"[build] native submission writer {native_lib.name} in {native_s:.1f} s (g++): "
        f"submission_available() {native.submission_available()}; CSV native, zip native "
        f"(zlib), not zipfile")
    for name, text in build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # ---- phase 2: each kernel against its plain version ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {"interaction_fwd": 0.0, "fused_score": 0.0, "interaction_bwd": 0.0}
    batches = (B_TRAIN, B_TRAIN + 37, B_FULL, B_RAGGED)
    failures = forward_against_plain(torch, worst, E, HIDDEN, batches)
    failures += backward_against_plain(torch, worst, E)
    # the recipe sweep's wider widths, with the same bars
    failures += forward_against_plain(torch, worst, WIDE_E, HIDDEN, batches, seed_offset=WIDE_E)
    # past the 8 fields whose rows the pairs pass holds in registers
    failures += forward_against_plain(torch, worst, MANY_FIELDS_E, HIDDEN, (B_TRAIN + 37, B_RAGGED),
                                      seed_offset=13, f=MANY_FIELDS)
    for e in (E, WIDE_E):
        for hidden in WIDE_TOWERS:
            failures += forward_against_plain(torch, worst, e, hidden, (B_TRAIN + 37, B_FULL),
                                              seed_offset=e, with_fwd=False)
    failures += backward_against_plain(torch, worst, WIDE_E, seed_offset=7)
    # past the 8 fields whose rows the backward holds in registers
    failures += backward_against_plain(torch, worst, MANY_FIELDS_E, seed_offset=11, f=MANY_FIELDS)
    for e, f in ((E, F), (WIDE_E, F), (MANY_FIELDS_E, MANY_FIELDS)):  # both ways' blocks
        for btype in ("all", "each"):
            for dtype in (torch.bfloat16, torch.float32):
                failures += fwd_blocks_against_plain(torch, e, btype, dtype, f=f)
                failures += bwd_blocks_against_plain(torch, e, btype, dtype, f=f)
    worst["sasrec_encoder_fwd"], enc_failures = encoder_against_plain(torch)
    failures += enc_failures
    drop_worst, drop_failures = dropout_forward_against_plain(torch)
    worst["sasrec_encoder_fwd"] = max(worst["sasrec_encoder_fwd"], drop_worst)
    failures += drop_failures
    worst["sasrec_encoder_bwd"], bwd_failures = encoder_bwd_against_plain(torch)
    failures += bwd_failures
    for e, heads in BLOCK_CASES:  # the encoder kernels' building blocks, one by one
        for dtype in (torch.bfloat16, torch.float32):
            failures += encoder_blocks_against_plain(torch, e, heads, dtype, seed=e)[1]
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")

    # ---- phase 3: timing at the main path's shapes (bf16, B=8192) ----
    timing = mm_timing(torch, card, E, HIDDEN)
    mm_timing(torch, card, WIDE_E, HIDDEN)
    mm_timing(torch, card, WIDE_E, WIDE_HIDDEN, with_interaction=False)
    mm_timing(torch, card, E, WIDE_HIDDEN, with_interaction=False)
    timing[("sasrec_encoder_fwd", "all")] = encoder_timing(torch, card)
    timing[("sasrec_encoder_bwd", "all")] = encoder_bwd_timing(torch, card)
    encoder_timing(torch, card, WIDE_E)
    encoder_bwd_timing(torch, card, WIDE_E)

    # ---- phase 4: the serving main path ----
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import ItemStore, TableData
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor, run_submission_pipeline
    from ctr_recommendation_tpu_torch.models import build_model

    exp = microlens_experiment(data_root="")
    fm = build_feature_map(exp.dataset)
    _, params, state = build_model(fm, exp.model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    for st in state["mlp"]["layers"]:  # BatchNorm stats off init: the fold is real
        d = st["bn_mean"].shape[0]
        st["bn_mean"] = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32))
        st["bn_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    item_ids = np.arange(1, 91718)
    store = ItemStore.from_arrays(
        item_ids, rng.standard_normal((len(item_ids), 128)).astype(np.float32)
    )
    rows = make_rows(N_ROWS, seed=11)
    table = TableData(rows, N_ROWS)
    pred = Predictor(exp, params, state, item_store=store)
    if not pred.use_fused:
        raise SystemExit("the default configuration must take the fused branch")
    n_batches = N_ROWS // B_FULL

    pred.score_table(TableData({k: v[:B_FULL] for k, v in rows.items()}, B_FULL))  # warm-up
    torch.cuda.synchronize()
    score_fwd.launches = interaction_fwd.launches = 0
    t0 = time.perf_counter()
    bulk = pred.score_table(table)
    t_bulk = time.perf_counter() - t0
    bulk_launches = score_fwd.launches
    log(f"[main] score_table: {N_ROWS} rows in {t_bulk:.4f} s = {N_ROWS / t_bulk:.0f} rows/s "
        f"on {card}; fused_score launches {bulk_launches}")
    if bulk_launches != n_batches * score_launches() or interaction_fwd.launches != 0:
        raise SystemExit(f"score_table launched {bulk_launches} scoring kernels, "
                         f"expected {n_batches} x {score_launches()}")
    if bulk.shape != (N_ROWS,) or not np.isfinite(bulk).all():
        raise SystemExit("score_table output is not finite of shape (N,)")
    if not ((bulk > 0) & (bulk < 1)).all():
        raise SystemExit("score_table probabilities outside (0, 1)")

    with tempfile.TemporaryDirectory() as out_dir:
        chunks = (
            {k: v[s : s + CHUNK_ROWS] for k, v in rows.items()}
            for s in range(0, N_ROWS, CHUNK_ROWS)
        )
        score_fwd.launches = 0
        t0 = time.perf_counter()
        written, csv_path, zip_path = run_submission_pipeline(
            chunks, pred, out_dir, batch_size=B_FULL, chunk_rows=CHUNK_ROWS
        )
        t_pipe = time.perf_counter() - t0
        pipe_launches = score_fwd.launches
        log(f"[main] pipeline: {written} rows in {t_pipe:.4f} s = {written / t_pipe:.0f} rows/s "
            f"to CSV+zip on {card}; fused_score launches {pipe_launches}")
        if pipe_launches != n_batches * score_launches():
            raise SystemExit(f"pipeline launched {pipe_launches} scoring kernels, "
                             f"expected {n_batches} x {score_launches()}")
        check_submission(written, csv_path, zip_path, bulk, "main")

    where_the_time_goes(torch, pred, rows, bulk, card)

    cpu_pred = Predictor(exp, params, state, item_store=store, device="cpu")
    head = TableData({k: v[:B_FULL] for k, v in rows.items()}, B_FULL)
    cpu_probs = cpu_pred.score_table(head)
    cpu_err = float(np.abs(cpu_probs - bulk[:B_FULL]).max())
    log(f"[main] first {B_FULL} rows vs the CPU Predictor: max_abs_err={cpu_err:.3e} "
        f"(tolerance {CPU_TOL})")
    if cpu_err > CPU_TOL:
        raise SystemExit("card and CPU Predictor disagree")

    # ---- phase 5: the unfused branch (interaction kernel + tower in torch) ----
    unfused = Predictor(exp, params, state, item_store=store, fold_bn=False)
    n_unfused = 4
    interaction_fwd.launches = score_fwd.launches = 0
    got = np.concatenate([
        unfused({k: v[i * B_FULL : (i + 1) * B_FULL] for k, v in rows.items()}).cpu().numpy()
        for i in range(n_unfused)
    ])
    inter_launches = interaction_fwd.launches
    unfused_err = float(np.abs(got - bulk[: n_unfused * B_FULL]).max())
    log(f"[unfused] {n_unfused} batches: interaction_fwd launches {inter_launches}, "
        f"max_abs_err vs fused {unfused_err:.3e} (tolerance {CPU_TOL})")
    if inter_launches != n_unfused * inter_fwd_launches() or score_fwd.launches != 0:
        raise SystemExit("the unfused branch did not run the interaction kernel once a batch")
    if unfused_err > CPU_TOL:
        raise SystemExit("unfused and fused branches disagree")

    # ---- phase 5b: the sasrec_fibinet serving path (encoder kernel) ----
    enc_launches = serve_sasrec(torch, store, rows, card)

    # ---- phases 6-7: the training main path, then its export; 6b: sasrec ----
    from ctr_recommendation_tpu_torch.data import synthetic_splits
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        bwd_launches,
        encode_bwd,
        encode_fwd,
        fwd_launches,
    )

    t0 = time.perf_counter()
    train, valid, train_store = synthetic_splits(N_TRAIN, N_VALID, seed=0)
    log(f"[train] synthetic data: {N_TRAIN} train + {N_VALID} valid rows, 91,717 items, "
        f"made in {time.perf_counter() - t0:.1f} s")
    counted = (interaction_fwd, interaction_bwd, score_fwd, encode_fwd, encode_bwd)
    enc_fwd, enc_bwd = fwd_launches(1), bwd_launches(1)  # one layer's kernel launches a call
    ifwd, ibwd = inter_fwd_launches(), inter_bwd_launches()
    with tempfile.TemporaryDirectory() as root:
        mm = train_and_serve(
            torch, microlens_experiment(data_root="", epochs=TRAIN_EPOCHS,
                                        checkpoint_dir=os.path.join(root, "ckpt")),
            train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd},
            per_eval={interaction_fwd: ifwd}, per_serve={score_fwd: score_launches()})
        # ---- phase 7c: profile_epoch, the reference state_dict import, item embeddings ----
        profiled = profile_epoch_phase(torch, train, train_store, root, card)
        imported = import_phase(torch, store, rows, card)
        item_embeddings_phase(torch, root, card)
        # ---- phase 6h: data-parallel training, two ranks sharing the card ----
        data_parallel_phase(torch, train, valid, train_store, root, card, dense=mm)
        # ---- phase 6i: row-sharded tables, 1 x 2 and 2 x 2 ranks sharing the card ----
        model_parallel_phase(torch, train, valid, train_store, root, card, dense=mm)
        sasrec_exp = microlens_experiment(data_root="", model="sasrec_fibinet",
                                          epochs=TRAIN_EPOCHS,
                                          checkpoint_dir=os.path.join(root, "ckpt_sasrec"))
        m = sasrec_exp.model
        if (m.embedding_dim, m.attn_num_heads, m.attn_num_layers, m.attn_dropout,
                sasrec_exp.train.batch_size) != (ENC_E, ENC_H, 1, DROP_RATE, B_TRAIN):
            raise SystemExit(f"sasrec_fibinet defaults moved: {m}")
        sasrec = train_and_serve(
            torch, sasrec_exp, train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd, encode_fwd: enc_fwd,
                      encode_bwd: enc_bwd},
            per_eval={interaction_fwd: ifwd, encode_fwd: enc_fwd},
            per_serve={score_fwd: score_launches(), encode_fwd: enc_fwd})
        # ---- phase 7b: phase 7's exports served over HTTP (serving/) ----
        serve_http(torch, mm, sasrec, valid, train_store, card)
        # ---- phase 6d: sasrec_emb_256 (sasrec_fibinet at E=256) ----
        wide_sasrec = microlens_experiment(data_root="", model="sasrec_fibinet",
                                           epochs=TRAIN_EPOCHS, embedding_dim=WIDE_E,
                                           checkpoint_dir=os.path.join(root, "ckpt_sasrec_256"))
        train_and_serve(
            torch, wide_sasrec, train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd, encode_fwd: enc_fwd,
                      encode_bwd: enc_bwd},
            per_eval={interaction_fwd: ifwd, encode_fwd: enc_fwd},
            per_serve={score_fwd: score_launches(), encode_fwd: enc_fwd}, tag="sasrec_emb_256")
        # ---- phase 6c: emb_256_tower1024 (E=256, tower (1024, 512)) ----
        wide_exp = microlens_experiment(data_root="", epochs=TRAIN_EPOCHS,
                                        embedding_dim=WIDE_E, hidden_units=WIDE_HIDDEN,
                                        checkpoint_dir=os.path.join(root, "ckpt_wide"))
        train_and_serve(
            torch, wide_exp, train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd},
            per_eval={interaction_fwd: ifwd}, per_serve={score_fwd: score_launches()},
            tag="emb_256_tower1024")
        # ---- phase 6e: sparse tables (both strategies, every kind; two fits) ----
        sparse_steps(torch, train, train_store, root, card,
                     {interaction_fwd: ifwd, interaction_bwd: ibwd})
        sparse_fits(torch, train, valid, train_store, root, card, counted,
                    per_step={interaction_fwd: ifwd, interaction_bwd: ibwd},
                    per_eval={interaction_fwd: ifwd}, per_serve={score_fwd: score_launches()},
                    dense=mm)
        # ---- phase 6f: host-driven training (Trainer.fit), predict --stream's path ----
        host_driven(torch, train, valid, train_store, root, card, dense=mm,
                    serve={"pred": pred, "rows": rows, "bulk": bulk}, counted=counted,
                    per_step={interaction_fwd: ifwd, interaction_bwd: ibwd},
                    per_eval={interaction_fwd: ifwd},
                    sasrec_per_step={interaction_fwd: ifwd, interaction_bwd: ibwd,
                                     encode_fwd: enc_fwd, encode_bwd: enc_bwd},
                    sasrec_per_eval={interaction_fwd: ifwd, encode_fwd: enc_fwd})
        # ---- phase 6g: the model zoo, no kernel on its path ----
        zoo(torch, train, valid, train_store, root, card, counted, rows, dense=mm)
    # the training main path's launches: phase 6's fit and phase 7c's profiled epochs
    train_fwd = mm["launches"][interaction_fwd] + profiled[interaction_fwd]
    train_bwd = mm["launches"][interaction_bwd] + profiled[interaction_bwd]
    enc_bwd_launches = sasrec["launches"][encode_bwd]

    # ---- phase 8: result ----
    kernels = [
        {"name": "interaction_fwd", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/interaction.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/interaction.py:56",
         "launches": train_fwd, "max_abs_err": worst["interaction_fwd"],
         **timing[("interaction_fwd", "all")], "library_ms": None},
        {"name": "interaction_bwd", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/interaction_bwd.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/interaction.py:250",
         "launches": train_bwd, "max_abs_err": worst["interaction_bwd"],
         **timing[("interaction_bwd", "all")], "library_ms": None},
        {"name": "fused_score", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/scoring.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/scoring.py:36",
         "launches": pipe_launches + imported, "max_abs_err": worst["fused_score"],
         **timing[("fused_score", "all")], "library_ms": None},
        {"name": "sasrec_encoder_fwd", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/sasrec_encoder.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py:220",
         "launches": enc_launches, "max_abs_err": worst["sasrec_encoder_fwd"],
         **timing[("sasrec_encoder_fwd", "all")]},
        {"name": "sasrec_encoder_bwd", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/sasrec_encoder_bwd.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py:238",
         "launches": enc_bwd_launches, "max_abs_err": worst["sasrec_encoder_bwd"],
         **timing[("sasrec_encoder_bwd", "all")]},
    ]
    print(json.dumps({"kernels": kernels}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
