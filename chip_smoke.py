#!/usr/bin/env python3
"""Drive the PyTorch port (ctr_recommendation_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line. A
`[clock] phase X at T s` line marks where each starts.

1. Print the card's name and power limit (nvidia-smi), build the seven
   kernels (table_grad and tower among them) from csrc/ with nvcc for sm_90a, one nvcc per source in parallel,
   and beside them the native submission writer (data/native/submission.cc,
   g++); fail if that writer does not build and load, so that the pipelines
   below write their CSV and zip natively.
2. With TF32 off, hold each kernel against its plain PyTorch version at full
   width. First the encoder's workspace sizes as the chunk planner reads
   them in Python against the C workspace functions on a grid (`[ws
   grid]`); from here on every encoder call's chunk plan is recorded
   (spy_plans). Then table_grad (csrc/table_grad.cu, the table gradient of
   every gather) at table_grad_cases' shapes (the likes_level table's step,
   8192 ids into 129 rows: the shared path; the item table's, 86,016
   pad-heavy ids into 91,777: the sorted path; E = 10 on both and 256; ids
   in the cut-off row; each model rank's local shape of a row-sharded item
   table; the shared path's largest table and one row more; one row taking
   every id; no ids; ids out of range) against its plain version in fp64, within
   TG_NORM_TOL in norm, bit for bit table_grad_order (its order in fp32 on
   the CPU), launches(n, rows, E) launches a call, TG_REPEATS calls on the
   same inputs bit-identical; segmented calls as the call sites make them
   (two features; a transposed history cotangent; MAX_SEGMENTS segments)
   bit for bit the call on their concatenation; its C predicate against
   fits and its C plan against plan. Then the tower kernels (csrc/tower.cu:
   BatchNorm, ReLU and dropout after each tower GEMM, both ways): the card
   tests tests/test_torch_tower_kernels.py, run by pytest without the JAX
   conftest (each block against its plain version, the layer against the
   plain blocks and the library composition, 0 to 131,072 rows, widths 50
   to 512, repeats bit for bit, launch counts, a one-rank data-parallel
   group), all TOWER_CASES passing and none skipped, then the layer at the
   mm cell's shapes against the plain blocks (the kernels line's
   max_abs_err). Then the interaction forward and the fused scoring kernel at the
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
   after warm-up) beside the bound the card sets for the same work
   (table_grad at the item and likes_level tables' step shapes, the sort
   included, beside its plain version, fp32 index_add_ and
   embedding_dense_backward, the library call, with torch.profiler's split
   a launch; the tower kernels at the mm cell's layers, 131,072 x 512 and
   x 256 in bf16, forward and backward after the GEMM, beside their plain
   blocks, the library composition, the byte bound and torch.rand's draw,
   with the kernels a call launches on both paths); for the
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
   both interaction kernels (fwd_launches() and bwd_launches() a step) and
   of table_grad (tg_step_launches: launches(n, rows, E) summed over the
   step's table shapes, one call a table, in every training run below too;
   one a feature over row-sharded tables), a
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
   each rank's rows; the ranks' tower on its kernels (the sums all-reduced
   between the blocks, each block's launches exact) and the one process's
   on the composition, rerun taking the ranks' tower decisions
   (dp_reference; each flip within GATE_MARGIN): the loss within 1e-5, every gradient within GRAD_TOL
   / GRAD_FLOOR (each flip within GATE_MARGIN), the BatchNorm running
   statistics within DP_STATE_TOL, the parameters after the update within
   DP_PARAM_TOL where the gradients fix Adam's step (2 lr elsewhere), the
   two replicas bit for bit equal, exactly fwd_launches() + bwd_launches()
   interaction launches and a step's table_grad launches a rank. Task sasrec_step: the same step of
   sasrec_fibinet (net dropout 0.2, the encoder's 0.1) on the same rows and
   ranks, with the same bars and exactly fwd_launches(1) +
   bwd_launches(1) encoder launches a rank; the encoder kernels draw the
   global batch's masks (token0 = a rank's first global row x S), and
   their FFN ReLU decisions, which cannot be replayed inside a kernel, are
   recorded on both sides (encoder_gates) and held equal at every real
   token (any flip within GATE_MARGIN, |f1| against max |f1|), the FFN
   hidden f1 itself bit for bit there (the kernels are row-invariant,
   (d)). (b) fit_on_device on two ranks over
   phase 6's splits, 2 epochs, the global batch 4096: exact launches a
   rank, both ranks' metrics equal, loss falling, best valid AUC within
   DP_AUC_TOL of phase 6's, rank 0's export and resume point; per rank
   examples/s, a step's wall, the gradient all-reduce's ms and bytes and
   the collectives a step (2 ranks sharing one card: not a scaling
   figure). (c) One rank on NCCL, world 1: the step of (a) within the same
   bars, its collectives (the tower kernels' among them) run on the card.
   (d) is in phase 2.
6i. Row-sharded tables (parallel/embedding.py, model_parallel 2) at the
   same full defaults, the ranks sharing cuda:0 over gloo as in 6h (every
   exchange staged through host memory), spawned as in 6h. (a) One fp32
   step (dropout 0.2 on, grad_clip_norm MP_CLIP so that the clip scales
   every gradient) on the same 4096 rows and seeded weights as one
   process, at 1 x 2 (two ranks) and 2 x 2 (four): the tables' gradients,
   clipped gradients and updated parameters put together from the model
   ranks' shards, then held as in 6h (a) (loss within 1e-5, GRAD_TOL /
   GRAD_FLOOR with the 1-process gates replayed and its tower rerun on the
   ranks' tower decisions, DP_PARAM_TOL); the
   replicated leaves bit for bit equal on all ranks, each shard across its
   data group; fwd_launches() + bwd_launches() interaction launches and
   tg_step_launches table_grad launches a rank; at 1 x 2 and 2 x 2 the
   one-step probe (repeat_probe) on each rank first: no leaf apart. At 1 x 2 also a lazy adam step (table_optimizer "adam") for each
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
   export served through the encoder and scoring kernels; after the fit the
   one-step probe (repeat_probe), both dropouts on: no leaf apart.
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
   traced one): exactly 2 x 64 x fwd_launches() interaction_fwd,
   2 x 64 x bwd_launches() interaction_bwd and 2 x 64 x tg_step_launches
   table_grad launches, state.step 128, no
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
7d. The JAX repo's compile-check entry point (__graft_entry__.entry) on the port:
   microlens_experiment(use_pallas=True)'s MM-FiBiNET at full width (E=128,
   item table 91,776 x 128, max_len 20, hidden (512, 256), bf16) from a
   seeded generator, data/synthetic.fake_batch rows (256, as the entry
   draws them, and 8192) through the eval forward and the sigmoid: exactly
   fwd_launches() interaction_fwd launches a forward (counted in the
   kernels line) and no other counted kernel; the interaction block's
   output inside the forward within TOL["interaction_fwd"] and
   FWD_NORM_TOL of interaction_fwd_plain on the same x; the probabilities
   finite in (0, 1) and within CPU_TOL of the same forward on the CPU;
   the forward's ms on the kernel and the plain path (CUDA events, median
   of 30; [entry] lines) and the kernel path's device-busy ms and kernels
   ([split] lines).
7e. The shapes the JAX kernels run beyond the port's S <= 32 and E, H
   multiples of 8, after 7d. (a) The encoder kernels past 32 keys against
   their plain versions: first the attention blocks alone at each case's
   (S, E, H) and at ATTN_BLOCK_SHAPES (S=20; a head of 512): the
   streamed pair (tensor cores, 3xTF32: attention_fwd_streamed's ao, o and
   (m, l), then attention_bwd_streamed on the plain o and stats) at every
   shape, and the staged pair where the encoder takes it (attention_fwd's
   ao and P, then attention_bwd on the plain P), B=4133 (1061 past S=128),
   within ENC_TOL, repeats bit-identical; then the whole encoder: S=50 at
   E=128, H=2, L=1 (B=4096 and 4133), S=64 at E=256, H=2 (B=4133, staged),
   S=100 at E=64, H=2, L=2 (B=4133), S=200 at E=128, H=2, L=1, at E=50
   (SASRec's MovieLens-1M d, run zero-padded to 64) with H=1 and 2, L=2,
   S=512 at E=64, H=2 and S=50 with one head of 288 (B=1061, the head
   read from device memory); bf16 and fp32, histories of random
   pad lengths: the forward within ENC_TOL (ENC_NORM_TOL in bf16, the jnp
   rounding points rejected) of the plain version at the true widths,
   fused_encode's pad rows exactly 0, dropout 0.1 under two seeds; the
   backward within ENC_BWD_TOL and its norm bars at rate 0 and 0.1 (the
   fp32-operand control rejected in bf16); every repeat bit-identical and
   the launches exact. The C predicate (sasrec_encoder_fits) against the
   Python one on S 1..512 x FITS_E (E 1 to 1024, 10, 48 and 50 among
   them) x FITS_H x L 1, 2, with the C widths and attention route against
   padded_dims and attention_route. The attention blocks alone timed at
   ATTN_TIME_SHAPES beside two bounds, their plain versions and
   F.scaled_dot_product_attention (`[time] attention` lines); both encoder
   kernels timed at S=50 as phase 3 times them at S=20, and at S=200
   (E=128) and the ML-1M shape (E=50, H=1, L=2, S=200) beside their
   bounds (the attention's fp32 operations at the faster of the fp32 rate
   beside the products and 3xTF32 at the TF32 rate after them) and
   nn.TransformerEncoderLayer (`[time] ... S=50` / `S=200` lines). (b)
   sasrec_fibinet at max_len 50 (SASRec's n for its sparse datasets) and
   sasrec_fibinet_ml1m (max_len 200, E=50, one head, two blocks, dropout
   0.2: SASRec's MovieLens-1M setting) at full width on half of phase 6's
   train rows (LONG_TRAIN, 131,072) and its valid rows made at that
   max_len: phases 6-7's checks (gradients kernel vs plain, exact
   launches of the four training kernels, loss falling, AUC > 0.6, the
   export through evaluate); the export through Predictor.score_table on
   the fused scoring kernel, its AUC within AUC_SERVE_TOL of evaluate's,
   its first rows within CPU_TOL of the CPU Predictor's. (c) E=10 through
   the interaction entry point, which pads it to 16, against the plain
   version at E=10 (forward within TOL and FWD_NORM_TOL, gradients within
   BWD_TOL; `[padded compare]` lines); mm_fibinet at E=10, mm_fibinet with
   a (100, 50) tower (the scoring kernel at (104, 56)) and sasrec_fibinet
   with one head of E=512 at max_len 50 (the streamed attention, the head
   read from device memory), each 3 train steps, an eval forward and a serve
   of 16,384 rows on the kernels: exact launches, the served probabilities
   within CPU_TOL of the CPU Predictor's (`[padded ...]`, `[wide head
   ...]` lines). Then the encoder at batches cut into chunks of rows
   (sasrec_encoder.plan_chunks: each within MAX_TOKENS tokens and
   WORKSPACE_BUDGET bytes of workspace), bf16 (`[chunked ...]` lines):
   (a) encode_fwd on 45,000 x 200 tokens at E=128, H=2, rate 0.1 and 0,
   past MAX_TOKENS: the repeat bit-identical, whole calls of 4096 rows at
   their token bases (the first rows, across each chunk boundary, the
   last) bit for bit its rows, exact launches, the rise of
   max_memory_allocated within the output + WORKSPACE_BUDGET + 1 GiB, its
   tokens/s beside one chunk of 8192 rows; (b) encode_bwd on 24,576 x 200
   tokens at E=256, H=2, rate 0.1, whose whole-call workspace is more than
   the card holds: the repeat bit-identical, dx of such pieces bit for bit,
   dx and the 12 gradients within ENC_BWD_TOL and ENC_BWD_NORM_TOL of the
   fp64 sums of 6 whole calls of 4096 rows, exact launches, the memory
   bound; (c) 7e (b)'s sasrec_fibinet_ml1m export through
   Predictor.score_table at batch_size 65,536 over its 131,072 train rows
   (each encoder call 13.1M tokens, chunked): exact launches, within
   TOL["fused_score"] of the same table at batch 8192. The kernels line
   adds 7e's launches.
7f. The port's own entry points, each CLI's main() called in this process
   with no device flag (the card) at the full microlens_experiment()
   width, on a parquet root: the train CLI's --synthetic (327,680 rows,
   91,717 items, high signal: 245,760 train, 49,152 valid, 32,768 test
   rows through write_synthetic_dataset) and fit_on_device for 2 epochs;
   --resume --epochs 3 on its checkpoint directory (Trainer._restore
   observed: step, parameters, model state and Adam moments bit for bit
   the resume point's, on the card; only epoch 3 runs); --epochs 3
   straight on a fresh directory, then a copy of that directory as a stop
   after epoch 2 leaves it (ckpt_3.pt and epoch 3's metrics.csv row taken
   out) resumed with --resume --epochs 3: its ckpt_3.pt the straight run's
   in every tensor, epoch 3's metrics (all but the clock's) equal; --stream on a copy
   of the root whose train.parquet is rewritten in row groups of 16,384
   (stream_batches into Trainer.fit; best AUC within FIT_AUC_TOL of the
   in-memory run's); the predict CLI's pipeline from the parquet path and
   its --stream, both CSVs byte-identical and check_submission's against
   score_table over load_split(test.parquet) on the same export; evaluate
   --gauc-col user_id, its [eval] line and metrics evaluate()'s in this
   process, its AUC within AUC_SERVE_TOL of the export's in training;
   validate_dataset exiting 0; cli/serve.py's build_service on the
   checkpoint directory, warmed up, behind make_http_server on port 0, six
   requests of 1-64 test rows, then 256 sequential requests of 16 random
   ones (timed as 7b times its bucket 16: p50, p99), each within CPU_TOL
   of score_table; Task 1 -> Task
   2: a seeded item_feature.parquet of the 91,717 items through the item
   embeddings CLI (--encoder hash: the encoder on the host, pca_project on
   the card) into a second root's item_info.parquet (float32 rows of 128
   dims, L2-normed within 1e-5, the items in order), then the train CLI
   (sasrec_fibinet, 1 epoch) and the predict CLI on it, its CSV
   check_submission's against score_table on its export and that
   item_info. Each train run's
   loss finite and falling (a one-epoch run's below log 2) and best valid
   AUC above 0.6; every run's launches of the six counted wrappers exact
   (per step, eval batch, scoring batch, warmup bucket and dispatch); a
   `[cli ...]` line a stage with its seconds and rows/s or examples/s
   (predict's and evaluate's are main()'s wall over a small split, the
   set-up included: smoke figures, not the pipeline's rate).
   pyarrow is imported first: no stage is skipped without it. The kernels
   line adds 7f's launches and 6h sasrec_step's (both ranks).
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
   gathered), each with the one-step probe after its fit (no leaf apart),
   and each beside the dense mm_fibinet run: best valid AUC,
   examples/s, a step's wall and device-busy ms.
6f. Host-driven training (Trainer.fit) at the full defaults on phase 6's
   splits, fed numpy batches (phase 7f runs the parquet paths): first the
   wire, each slice of the first widened chunk of 8 bit for bit put_batch
   of its numpy batch (split24 item ids, uint8 labels and categoricals);
   the feed at 8 giving every step of both epochs the feed at 1's batch,
   bit for bit (check_feeds); the one-step probe (repeat_probe: one step's
   loss and gradients on the same batch twice, every leaf bit for bit);
   the shared likes_level table's merged table_grad run TG_REPEATS times
   on fixed inputs, every result bit for bit the first; then fit over
   iter_batches for 2 epochs at 1 batch an upload, again at 1, and at 8:
   every per-epoch train loss and valid AUC and every parameter of the
   repeat and of 8 bit for bit those of 1, best valid AUC > 0.6 and
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
   bf16, batch 4096) on the first half of phase 6's train rows (ZOO_TRAIN,
   131,072) and its valid rows, each through phases 6-7 with no
   kernel on its path: one fp32 step's loss (within 1e-5) and gradients
   (within GRAD_TOL / GRAD_FLOOR) on the card against the same step on the
   CPU (same seeded weights and batch, xdeepfm's zero CIN head set to
   seeded values, TF32 off, net_dropout 0; the CPU replays the card's
   ReLU and PReLU decisions, each one it would have taken otherwise lying
   within GATE_MARGIN of 0), then
   fit_on_device for 2 epochs (loss finite and falling, best valid AUC >
   0.6, a resume point and the best export, 0 launches of every counted
   kernel wrapper but table_grad's, the table gradient of every model), the
   one-step probe (leaves apart logged, a [zoo] line over the nine), the
   step split and profile, the export served through
   evaluate (Predictor on the model's eval forward: served AUC within
   AUC_SERVE_TOL of the trainer's, gAUC within GAUC_TOL of the CPU's, 0
   launches), and score_table over phase 4's 385,024 rows (rows/s,
   probabilities in [0, 1], 0 launches). A [zoo] summary line a model
   beside mm_fibinet's phase 6 run: examples/s, best AUC, a step's wall,
   device-busy ms and share, kernels a step, rows/s.
8. `[chunked budget]`: every encoder call of this process outside 7e (c)'s
   chunked cases was one chunk, and its largest workspace beside
   WORKSPACE_BUDGET. One JSON line describing the seven kernels (the
   tower's launches: phase 6's fit, exact, 7c's profiled epochs and 6h
   sasrec_step's on both ranks, each counted from 0), then the result
   line.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
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
# dense bf16 and TF32 tensor-core rates, fp32 FMA on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
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
# fit at FIT_K, fit at 1 and its repeat: every per-epoch train loss and valid
# AUC and every parameter bit for bit. The two feeds give every step the same
# batch (check_feeds), and the step is a function of its seed: the table
# gradient sums in a fixed order (csrc/table_grad.cu), and the one-step
# probes (repeat_probe) hold every other gradient to its repeat.
# table_grad (csrc/table_grad.cu) against its plain version in fp64:
# |d| / |want| in norm; fp32 sums of up to ~4e4 cotangents a row in another
# order (the pad id's) stay ~1e-7 apart, and a term lost or counted twice
# moves a row by the term itself
TG_NORM_TOL = 1e-6
TG_REPEATS = 10  # calls on the same inputs, bit-identical
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


def bound(nbytes: float, ops: float, fp32_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes at the HBM rate, or the
    operations, whichever is longer. ``ops`` run at the bf16 tensor rate;
    ``fp32_ops`` (work the precision contract keeps at fp32 accuracy: the
    encoder's attention) take the faster of two ways: on the CUDA cores at
    the fp32 rate, beside the tensor cores' work, or on the tensor cores
    as 3xTF32 (three TF32 operations an fp32 one) after it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(max(ops / PEAK_FLOPS["bfloat16"], fp32_ops / PEAK_FLOPS["float32"]),
                ops / PEAK_FLOPS["bfloat16"] + 3 * fp32_ops / PEAK_FLOPS["tf32"]) * 1e3
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


def check_submission(written, csv_path, zip_path, bulk, tag: str, n_rows: int = N_ROWS) -> None:
    """The pipeline's CSV + zip: ``n_rows`` rows, IDs in order, probabilities
    finite in (0, 1) and identical to ``bulk`` (score_table's); the CSV's
    bytes those the Python writer writes for ``bulk`` (the native writer
    wrote them), the zip holding those bytes."""
    import zipfile

    from ctr_recommendation_tpu_torch.inference.submission import HEADER, format_rows

    with open(csv_path, "rb") as f:
        raw = f.read()
    lines = raw.decode().splitlines()
    if lines[0] != "ID,Task2" or len(lines) != n_rows + 1 or written != n_rows:
        raise SystemExit(f"{tag}: CSV has {len(lines) - 1} rows, header {lines[0]!r}")
    ids, probs = zip(*(ln.split(",") for ln in lines[1:]))
    if not np.array_equal(np.asarray(ids, np.int64), np.arange(n_rows)):
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
    log(f"[{tag}] CSV {n_rows} rows, IDs in order, probabilities in (0, 1), "
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


def encoder_case(torch, dtype, b: int, e: int, heads: int, layers: int, seed: int, s: int = 20,
                 on_card: bool = False):
    """The encoder's operands on the card: seeded params (the port's init),
    a numpy history of random pad lengths (row 0 all pad, row 1 none), and
    what fused_encode feeds the kernel. The embeddings are drawn with numpy,
    or with ``on_card`` from a seeded generator on the card (phase 7e's
    larger cases: a host draw of 50M normals takes about a second). Returns
    (x, amask, pad, weights, params, seq_emb, ids)."""
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
    if on_card:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        seq_emb = torch.randn((b, s, e), generator=gen, device="cuda").to(dtype)
    else:
        seq_emb = torch.from_numpy(rng.standard_normal((b, s, e)).astype(np.float32)).to(
            "cuda", dtype)
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


def library_layer(torch, weights, num_heads: int, device="cuda", li: int = 0):
    """torch.nn.TransformerEncoderLayer computing layer ``li`` of the stacked
    ``weights``: the timing yardstick, never on the main path. Pre-LN
    (norm_first), ReLU FFN of 4E, eps 1e-6, no dropout, eval mode."""
    qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b = (
        t[li].float() for t in weights)
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


def tower_relu(torch, layer: dict, st: dict, x, weight):
    """The ReLU decisions (z > 0, before dropout) of one layer of the tower
    kernels on input x: the forward's blocks again on the same operands,
    whose sums repeat bit for bit, without the uniforms."""
    from ctr_recommendation_tpu_torch.ops.cuda import tower

    with torch.no_grad():
        lin = layer["linear"]
        y = x @ lin["w"].to(x.dtype)
        b, gamma, beta = lin.get("b"), layer.get("bn_scale"), layer.get("bn_bias")
        sums = devs = None
        if gamma is not None:
            sums = tower.fwd_sums(y, b, weight)
            devs = tower.fwd_devs(y, b, weight, sums)
        code = tower.fwd_apply(y, b, gamma, beta, sums, devs, None, 1.0, st.get("bn_mean"),
                               st.get("bn_var"))[1]
        return tower.unpack_code(code, y.shape[1])


def gate_replay(torch, gates=None, part=(0, 1), tower: bool = True):
    """A torch function mode that records the decision of every ReLU
    (``torch.relu``) and every gate ``torch.where(cond, a, b)`` on floating
    ``a`` in one forward, in call order (``gates`` None), or replays such a
    record (``gates``) on another device: ``flips`` counts the decisions the
    replaying forward would have taken otherwise, ``margin`` is the largest
    |input| / max|input| of its tensor among them. ``part`` (rank, world):
    the replaying forward holds rank's share of the recorded batch, and
    takes that share of each recorded gate (along the dimension that is
    world times its own). Recording with ``tower``, the tower kernels'
    layers (``mlp._kernel_layer``, dropout 0) append their ReLU decisions
    too (tower_relu), in call order, for a replaying forward on the
    composition. While ``paused`` is set the mode takes no decision."""
    from torch.overrides import TorchFunctionMode

    from ctr_recommendation_tpu_torch.ops import mlp

    class GateReplay(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.replay = gates is not None
            self.gates = gates if gates is not None else []
            self.calls = self.flips = 0
            self.margin = 0.0
            self.paused = False

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

        def __enter__(self):
            # recording on a card: the tower kernels' ReLU decisions
            # (tower_relu; the CPU replays no dropout select of theirs, so
            # dropout 0), in call order
            self.kernel_layer = mlp._kernel_layer
            if tower and not self.replay:
                def recorded(layer, st, x, rate, generator, weight):
                    if rate > 0.0:
                        raise SystemExit("gate_replay records the tower kernels' ReLU "
                                         "decisions at dropout 0 only")
                    self.gates.append(tower_relu(torch, layer, st, x, weight))
                    return self.kernel_layer(layer, st, x, rate, generator, weight)

                mlp._kernel_layer = recorded
            return super().__enter__()

        def __exit__(self, *exc):
            mlp._kernel_layer = self.kernel_layer
            return super().__exit__(*exc)

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if self.paused:
                return func(*args, **kwargs)
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
    largest. The plain path on the card launches table_grad as the kernel
    path does (it has no other table gradient); the CPU none."""
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
    enc_gates, enc_replay = [], {"calls": 0, "flips": 0, "margin": 0.0}
    mlp_gates, mlp_replay = [], {"calls": 0, "flips": 0, "margin": 0.0}
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
        if against_cpu:
            gates = gate_replay(torch, None if i == 0 else gates.gates)
            tower = contextlib.nullcontext()
        else:  # the encoder's and the tower's ReLUs: the kernel path's decisions, replayed
            gates = encoder_gates(torch, enc_gates, None if i == 0 else enc_replay)
            tower = tower_gates(torch, mlp_gates, None if i == 0 else mlp_replay)
        with torch.enable_grad():
            with gates, tower:
                loss, aux = tr.forward_loss(batch)
            out.append((loss.item(), tr.gradients(loss, aux), list(aux.targets)))
        if i == 0:
            first = (tr, batch, aux, out[0][1])
        torch.cuda.synchronize()
        launched = tuple(fn.launches for fn in kernels)
        want = tuple(n if i == 0 or (fn.__name__ == "table_grad" and device == "cuda") else 0
                     for fn, n in kernels.items())
        if launched != want:
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
    else:
        decisions = sum(int(r.sum()) * g.shape[1] for g, r in enc_gates)
        gate_note = (f"; the kernel path's ReLU decisions replayed on the plain path, the "
                     f"tower's ({len(mlp_gates)} layers, {sum(g.numel() for g in mlp_gates)} "
                     f"decisions): {mlp_replay['flips']} it would have taken otherwise, within "
                     f"{mlp_replay['margin']:.2e}; the encoder FFN's ({len(enc_gates)} layers, "
                     f"{decisions} decisions at real tokens): {enc_replay['flips']}, within "
                     f"{enc_replay['margin']:.2e} of 0 relative to their layer's largest "
                     f"|input| (GATE_MARGIN {GATE_MARGIN:g})")
        for what, got, rec in (("encoder FFN", enc_replay, enc_gates),
                               ("tower", mlp_replay, mlp_gates)):
            if got["calls"] != len(rec) or got["margin"] > GATE_MARGIN:
                raise SystemExit(f"{tag}: the plain path met {got['calls']} {what} gates for "
                                 f"the kernel path's {len(rec)}, or a gate flipped beyond "
                                 f"rounding ({got['margin']:.2e} > {GATE_MARGIN:g})")
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


@contextlib.contextmanager
def encoder_gates(torch, gates: list, stats: dict | None = None, values: list | None = None):
    """The encoder FFN's ReLU decisions, recorded on the kernel path
    (``stats`` None) or replayed on the plain path. Recording: each
    fused_encode call of the trunk first appends, per layer, the kernels'
    decisions f1 > 0 on its inputs, computed launch for launch by
    kernel_layers (the fused call's bits; the blocks' launches are not
    counted; at the kernels' padded widths where E is off their multiples,
    the FFN hidden's real columns kept), and the mask of real tokens.
    Replaying: each torch.relu on a
    3-d input of a recorded layer's size (attention.encode's FFN hidden (B,
    S, 4E), in layer order) takes the recorded decisions at the real tokens
    (attention.encode re-zeroes pad rows after each layer, the kernels do
    not: pad rows differ by design, and reach no output); ``stats`` counts
    the replayed layers
    (``calls``), the decisions taken otherwise (``flips``) and the largest
    |z1| / max|z1| among them (``margin``). A z1 within rounding of 0 falls
    on two sides in two computations, and the backward is discontinuous
    there: the more tokens, the likelier. Recording with ``values`` (a
    list) also appends each layer's f1 itself (fp32, (tokens, 4E)), for a
    comparison of two kernel paths' decisions (phase 6h's sasrec_step)."""
    from torch.overrides import TorchFunctionMode

    from ctr_recommendation_tpu_torch.models import trunk
    from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc

    if stats is None:
        fused = trunk.fused_encode
        layer_fwd = kernel_layers(torch)(None)

        def recording(params, seq_emb, seq_ids, *, num_heads, pad_id=0, train=False,
                      dropout_rate=0.0, seed=None, token0=0):
            drop_on = train and dropout_rate > 0.0 and seed is not None
            with torch.no_grad():
                x, amask, _ = enc.encoder_inputs(params, seq_emb, seq_ids, pad_id)
                e = x.shape[-1]
                ep = enc.padded_dims(e, num_heads)[0]
                w = enc.pad_weights(enc.stack_weights(params, x.dtype), e, num_heads)
                h = enc.pad_stream(x, ep).float().reshape(-1, ep)
                for li in range(len(params["blocks"])):
                    h, res = layer_fwd(h, amask, w, li, x.dtype, num_heads,
                                       seed if drop_on else None,
                                       float(dropout_rate) if drop_on else 0.0, token0=token0,
                                       e=e if ep != e else None)
                    gates.append((res["f1"][:, :4 * e] > 0, (seq_ids != pad_id).reshape(-1, 1)))
                    if values is not None:
                        values.append(res["f1"][:, :4 * e].cpu())
            return fused(params, seq_emb, seq_ids, num_heads=num_heads, pad_id=pad_id,
                         train=train, dropout_rate=dropout_rate, seed=seed, token0=token0)

        trunk.fused_encode = recording
        try:
            yield
        finally:
            trunk.fused_encode = fused
        return

    class Replay(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            k = stats["calls"]
            if (func is torch.relu and args[0].dim() == 3 and k < len(gates)
                    and args[0].numel() == gates[k][0].numel()):
                x = args[0]
                own = x > 0
                given = torch.where(gates[k][1], gates[k][0], own.reshape(gates[k][0].shape))
                given = given.reshape(x.shape)
                stats["calls"] += 1
                differ = given != own
                if bool(differ.any()):
                    stats["flips"] += int(differ.sum())
                    mag = x.detach().abs()
                    stats["margin"] = max(stats["margin"], float(mag[differ].max() / mag.max()))
                return torch.where(given, x, 0.0)
            return func(*args, **kwargs)

    with Replay():
        yield


@contextlib.contextmanager
def tower_gates(torch, gates: list, stats: dict | None = None):
    """The tower's ReLU decisions, recorded on the kernel path (``stats``
    None: each torch.relu inside ops/mlp.apply, and each layer of the tower
    kernels by tower_relu) or replayed in the same order on the plain path,
    whose tower runs the composition (``mlp.on_kernels`` off) fed the plain
    trunk's fields; ``stats`` as for encoder_gates."""
    from torch.overrides import TorchFunctionMode

    from ctr_recommendation_tpu_torch.ops import mlp

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is not torch.relu:
                return func(*args, **kwargs)
            x = args[0]
            own = x > 0
            if stats is None:
                gates.append(own)
                return torch.where(own, x, 0.0)
            given = gates[stats["calls"]]
            stats["calls"] += 1
            differ = given != own
            if bool(differ.any()):
                stats["flips"] += int(differ.sum())
                mag = x.detach().abs()
                stats["margin"] = max(stats["margin"], float(mag[differ].max() / mag.max()))
            return torch.where(given, x, 0.0)

    plain, kernel_layer, on_kernels = mlp.apply, mlp._kernel_layer, mlp.on_kernels

    def recorded(layer, st, x, rate, generator, weight):
        gates.append(tower_relu(torch, layer, st, x, weight))
        return kernel_layer(layer, st, x, rate, generator, weight)

    def apply(*args, **kw):
        with Mode():
            return plain(*args, **kw)

    mlp.apply = apply
    if stats is None:
        mlp._kernel_layer = recorded
    else:
        mlp.on_kernels = lambda x, train: False
    try:
        yield
    finally:
        mlp.apply, mlp._kernel_layer, mlp.on_kernels = plain, kernel_layer, on_kernels


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


PLAIN_REPS = 3  # runs timing phase 7e's fp64 plain encoders (phase 3's: 30)


def encoder_timing(torch, card, e: int = ENC_E, s: int = ENC_S, on_card: bool = False,
                   heads: int = ENC_H, layers: int = 1) -> dict:
    """Phase 3 for the encoder at B=8192, bf16, histories of S (phase 7e:
    50 and 200, and the ML-1M shape E=50, H=1, L=2): kernel, plain version
    and nn.TransformerEncoderLayer (L of them; checked first against the
    plain version in fp32 on every history with a real step), CUDA events,
    beside the bound (``bound``: the products' operations at the bf16
    rate, the attention's, fp32 accuracy by the precision contract, at the
    fp32 rate beside them or as 3xTF32 after them, whichever is faster).
    The plain version, fp64 and slow past S = 20, is timed over
    PLAIN_REPS runs in phase 7e (on_card)."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encode_fwd, encode_fwd_plain

    shape = f"S={s} E={e} H={heads} L={layers}"
    plain_reps = PLAIN_REPS if on_card else 30
    x, amask, pad, ws, _, _, _ = encoder_case(torch, torch.float32, B_FULL, e, heads, layers, 3,
                                              s=s, on_card=on_card)
    real = ~pad.all(-1)
    with torch.inference_mode():
        lib = library_stack(torch, ws, heads)[1](x, pad)
    want = encode_fwd_plain(x, amask, *ws, num_heads=heads)
    lib_err = (lib[real] - want[real]).abs().max().item()
    log(f"[compare] nn.TransformerEncoderLayer fp32 vs encode_fwd_plain at {shape} on the "
        f"{int(real.sum())} histories with a real step: max_abs_err={lib_err:.3e} "
        f"(tolerance {LIB_TOL:g})")
    if not lib_err <= LIB_TOL:
        raise SystemExit("the library yardstick does not compute the encoder's function")

    x, amask, pad, ws, _, _, _ = encoder_case(torch, torch.bfloat16, B_FULL, e, heads, layers, 4,
                                              s=s, on_card=on_card)
    library = library_stack(torch, ws, heads)[1]
    tokens = B_FULL * s
    # the attention: q k^T and p v, 4 S^2 D a head
    ops, fp32_ops = 2 * tokens * 12 * e * e * layers, 4 * tokens * s * e * layers
    nbytes = 2 * 2 * x.numel() + 4 * amask.numel() + sum(t.numel() * t.element_size() for t in ws)
    with torch.inference_mode():
        t = {
            "ms": time_ms(torch, lambda: encode_fwd(x, amask, *ws, num_heads=heads)),
            "plain_ms": time_ms(torch, lambda: encode_fwd_plain(x, amask, *ws, num_heads=heads),
                                plain_reps),
            **bound(nbytes, ops, fp32_ops),
            "library_ms": time_ms(torch, lambda: library(x, pad)),
        }
    log(f"[time] sasrec_encoder_fwd bf16 B={B_FULL} {shape}: {t} (bytes {nbytes}, ops {ops} "
        f"bf16 + {fp32_ops} fp32; library: nn.TransformerEncoderLayer, bf16) on {card}")
    seed = torch.tensor([3], dtype=torch.int64, device="cuda")
    kw = dict(num_heads=heads, seed=seed, rate=DROP_RATE)
    with torch.inference_mode():
        drop = {"ms": time_ms(torch, lambda: encode_fwd(x, amask, *ws, **kw)),
                "plain_ms": time_ms(torch, lambda: encode_fwd_plain(x, amask, *ws, **kw),
                                    plain_reps)}
    log(f"[time] sasrec_encoder_fwd with dropout {DROP_RATE} (train mode), same inputs: {drop} "
        f"on {card}")
    with torch.inference_mode():
        kernel_split(torch, lambda: encode_fwd(x, amask, *ws, **kw),
                     f"sasrec_encoder_fwd bf16 B={B_FULL} {shape} dropout {DROP_RATE}", card)
    return t


# (S, E, H) of the attention blocks' [time] lines: max_len 20, 50 and 200 at
# sasrec_fibinet's E = 128 with two heads, and SASRec's ML-1M shape
ATTN_TIME_SHAPES = [(20, 128, 2), (50, 128, 2), (200, 128, 2), (200, 50, 1)]


def attention_timing(torch, card, s: int, e: int, heads: int) -> dict:
    """Phase 7e: the attention blocks alone at the kernels' widths (E = 50
    runs at 64), bf16 output, the forward over B_FULL histories and the
    backward over B_TRAIN, of random pad lengths: the streamed pair (and
    the staged pair where the encoder takes it), CUDA events, beside the
    fp32-equivalent TFLOP/s (4 S^2 D a head forward, FlashAttention-2's 10
    S^2 D backward), two bounds (3xTF32 on the tensor cores at the TF32
    rate, and the same work in fp32 on the CUDA cores, each against the
    bytes: inputs read once, outputs written once), the plain versions and
    F.scaled_dot_product_attention on the same inputs in fp32 and bf16
    (the backward: autograd's backward of it alone), a yardstick the port
    never calls."""
    import torch.nn.functional as F

    from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import padded_dims

    ep, dp = padded_dims(e, heads)
    att = dict(scale=1.0 / (e // heads) ** 0.5)
    gen = torch.Generator(device="cuda").manual_seed(s * 7 + e)
    lens = torch.randint(1, s + 1, (B_FULL,), generator=gen, device="cuda")
    amask = torch.where(torch.arange(s, device="cuda")[None, :] < (s - lens)[:, None],
                        -1e9, 0.0).float()
    qkv = torch.randn((B_FULL * s, 3 * ep), generator=gen, device="cuda")
    nb = B_TRAIN * s
    qb, ab = qkv[:nb], amask[:B_TRAIN].contiguous()
    dao = torch.randn((nb, ep), generator=gen, device="cuda")
    bf16 = torch.bfloat16
    _, o, st = eb.attention_fwd_streamed(qb, ab, heads, bf16, **att)
    flops = {"fwd": 4 * B_FULL * s * s * ep, "bwd": 10 * B_TRAIN * s * s * ep}
    nbytes = {"fwd": 4 * qkv.numel() + 4 * amask.numel() + (2 + 4) * B_FULL * s * ep
              + 8 * B_FULL * heads * s,
              "bwd": 4 * qb.numel() + 4 * ab.numel() + 2 * 4 * nb * ep + 8 * B_TRAIN * heads * s
              + (4 + 2) * nb * 3 * ep}
    runs = {"fwd": lambda: eb.attention_fwd_streamed(qkv, amask, heads, bf16, **att),
            "bwd": lambda: eb.attention_bwd_streamed(qb, ab, o, st, dao, bf16, **att)}
    plain = {"fwd": lambda: eb.attention_fwd_streamed_plain(qkv, amask, heads, bf16, **att),
             "bwd": lambda: eb.attention_bwd_streamed_plain(qb, ab, o, st, dao, bf16, **att)}
    out = {}
    for way in ("fwd", "bwd"):
        ms = time_ms(torch, runs[way])
        t_bytes = nbytes[way] / HBM_BYTES_PER_S * 1e3
        out[way] = {
            "ms": ms, "tflops_fp32_equivalent": flops[way] / ms / 1e9,
            "bound_ms_3xtf32": max(t_bytes, 3 * flops[way] / PEAK_FLOPS["tf32"] * 1e3),
            "bound_ms_fp32": max(t_bytes, flops[way] / PEAK_FLOPS["float32"] * 1e3),
            "plain_ms": time_ms(torch, plain[way], reps=1)}
    if eb.attention_route(s, dp) == "staged":
        _, p = eb.attention_fwd(qb, ab, heads, bf16, **att)
        out["fwd"]["staged_ms"] = time_ms(
            torch, lambda: eb.attention_fwd(qkv, amask, heads, bf16, **att))
        out["bwd"]["staged_ms"] = time_ms(
            torch, lambda: eb.attention_bwd(qb, p, dao, bf16, **att))
        del p
    for dtype in (torch.float32, bf16):
        dn = str(dtype).split(".")[1]
        q, k, v = (eb.heads(t, B_FULL, s, heads).to(dtype).contiguous()
                   for t in qkv.split(ep, -1))
        mask = amask[:, None, None, :].to(dtype)
        out["fwd"][f"library_ms_{dn}"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, **att))
        leaves = [t[:B_TRAIN].detach().requires_grad_() for t in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, attn_mask=mask[:B_TRAIN], **att)
        gy = eb.heads(dao, B_TRAIN, s, heads).to(dtype).contiguous()
        out["bwd"][f"library_ms_{dn}"] = time_ms(
            torch, lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True))
        del q, k, v, leaves, y, gy
    log(f"[time] attention S={s} E={e} H={heads} (kernels at D={dp}), forward B={B_FULL}, "
        f"backward B={B_TRAIN}, bf16 out: {out} (fp32 operations {flops}, bytes {nbytes}; "
        f"bounds: 3xTF32 at {PEAK_FLOPS['tf32']:.3g}, fp32 at {PEAK_FLOPS['float32']:.3g} "
        f"FLOP/s; library: F.scaled_dot_product_attention, the staged pair where the encoder "
        f"takes it) on {card}")
    return out


DROP_RATE = 0.1  # sasrec_fibinet's attn_dropout default
ENC_BWD_CASES = [(128, 2, 1, B_TRAIN), (128, 2, 1, B_TRAIN + 37), (64, 4, 2, B_TRAIN + 37),
                 (256, 2, 1, B_TRAIN), (256, 2, 1, B_TRAIN + 37)]


def encoder_cotangent(torch, pad, e: int, seed: int, dtype, on_card: bool = False):
    """A seeded cotangent of the encoder's output (B, S, e) on the card,
    zero at pad rows (fused_encode's re-zeroing gives that): drawn with
    numpy, or with ``on_card`` from a seeded generator on the card."""
    b, s = pad.shape
    if on_card:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g = torch.randn((b, s, e), generator=gen, device="cuda")
    else:
        g = torch.from_numpy(
            np.random.default_rng(seed).standard_normal((b, s, e)).astype(np.float32)).cuda()
    g = g * ~pad[..., None]
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


def library_stack(torch, weights, num_heads: int):
    """The encoder's L layers as nn.TransformerEncoderLayers (library_layer),
    and their forward over (x, pad): the yardstick at any depth."""
    layers = [library_layer(torch, weights, num_heads, li=li) for li in range(weights[0].shape[0])]

    def forward(x, pad):
        for layer in layers:
            x = layer(x, src_key_padding_mask=pad)
        return x

    return layers, forward


def library_grads(torch, layers, x, pad, g):
    """(dx, the 12 weight gradients in the stacked layout) of one forward +
    backward of the nn.TransformerEncoderLayers ``layers`` in turn."""
    x = x.detach().requires_grad_()
    params = []
    for layer in layers:
        sa = layer.self_attn
        params += [sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight, sa.out_proj.bias,
                   layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
                   layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias]
    y = x
    for layer in layers:
        y = layer(y, src_key_padding_mask=pad)
    grads = torch.autograd.grad(y, [x, *params], g)
    per = [t.T if t.dim() == 2 else t for t in grads[1:]]
    return [grads[0]] + [torch.stack(per[k::12]) for k in range(12)]


@contextlib.contextmanager
def plain_layers(make):
    """While open, encode_bwd_plain's forward recompute runs each layer
    through ``make(the plain _layer_fwd)`` (same signature and residues)."""
    from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc

    plain = enc._layer_fwd
    enc._layer_fwd = make(plain)
    try:
        yield
    finally:
        enc._layer_fwd = plain


def replayed_gates(torch, z1s: list, stats: dict, held):
    """For plain_layers: the plain layer, then its FFN's ReLU gate given the
    decisions z1s[li] > 0 of another computation of layer li's
    pre-activation (fp32): f1 kept where both decide alike, 0 where only the
    plain one opens, fp32's least normal where only the other does (f1
    feeds the gate and, times df2, ffn2_w's gradient: that term moves by
    under 1e-37). ``stats`` counts the decisions taken otherwise on the
    tokens ``held`` (a (B*S,) mask: the histories with a real step, whose
    forward both compute alike; an all-pad history's softmax differs and
    its cotangent is 0) in ``flips``, and keeps the largest |z1| / max|z1|
    among them in ``margin``."""
    def make(plain):
        def layer_fwd(h, amask, w, li, cd, *args, **kw):
            h2, res = plain(h, amask, w, li, cd, *args, **kw)
            f1 = res["f1"]
            z = z1s[li].reshape(f1.shape).float()
            gate = z > 0
            flips = (gate != (f1 > 0)) & held[:, None]
            if bool(flips.any()):
                stats["flips"] += int(flips.sum())
                stats["margin"] = max(stats["margin"],
                                      float(z[flips].abs().max() / z.abs().max()))
            tiny = torch.full_like(f1, torch.finfo(torch.float32).tiny)
            res = dict(res, f1=torch.where(gate, torch.where(f1 > 0, f1, tiny), 0.0))
            return h2, res
        return layer_fwd
    return make


def kernel_layers(torch):
    """For plain_layers: each layer's forward and residues as the encoder
    kernels' backward recomputes them, launch for launch on the building
    blocks of encoder_blocks (the same kernels and launches as the fused
    call, so the same bits): LayerNorm and attention outputs in fp32 (their
    rounding to cd at use is the fused call's store), f1 in cd; the
    attention the staged or the streamed pair as the fused call takes it
    (attention_route), at the padded widths the fused call runs (``e`` the
    true width: encode_bwd_plain(..., padded=True)). The plain backward
    then runs on the kernels' own forward, with the kernels' ReLU decisions
    and rounding points: what differs from encode_bwd is the backward's
    arithmetic alone."""
    from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import padded_dims

    def make(plain):
        def layer_fwd(h, amask, w, li, cd, num_heads, seed, rate, acc=None, token0=0, e=None):
            (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
             ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b) = (t[li] for t in w)
            drop = dict(seed=seed, rate=rate, layer=li, token0=token0)
            f32 = torch.float32
            true_e = e or h.shape[1]
            att = dict(scale=1.0 / (true_e // num_heads) ** 0.5)
            hn1, xhat1, r1 = eb.layer_norm(h, ln1_s, ln1_b, f32, True, e=e)
            qkv = eb.product(hn1.to(cd), qkv_w.to(cd), "nn", "bias", bias=qkv_b)
            if eb.attention_route(amask.shape[1],
                                  padded_dims(true_e, num_heads)[1]) == "staged":
                ao, p = eb.attention_fwd(qkv, amask, num_heads, f32, **att)
                kept = dict(p=p)
            else:
                ao, _, stats = eb.attention_fwd_streamed(qkv, amask, num_heads, f32, **att)
                kept = dict(stats=stats)
            h1 = eb.product(ao.to(cd), proj_w.to(cd), "nn", "residual", bias=proj_b, aux=h,
                            branch=0, **drop)
            hn2, xhat2, r2 = eb.layer_norm(h1, ln2_s, ln2_b, f32, True, e=e)
            f1 = eb.product(hn2.to(cd), ffn1_w.to(cd), "nn", "relu", bias=ffn1_b, out_dtype=cd)
            h2 = eb.product(f1, ffn2_w.to(cd), "nn", "residual", bias=ffn2_b, aux=h1, branch=1,
                            **drop)
            return h2, dict(hn1=hn1, xhat1=xhat1, r1=r1, qkv=qkv, ao=ao, hn2=hn2, xhat2=xhat2,
                            r2=r2, f1=f1.float(), **kept)
        return layer_fwd
    return make


def encoder_bwd_timing(torch, card, e: int = ENC_E, s: int = ENC_S, on_card: bool = False,
                       heads: int = ENC_H, layers: int = 1) -> dict:
    """Phase 3 for the backward at B=4096, bf16, rate 0.1, histories of S
    (phase 7e: 50 and 200, and the ML-1M shape): kernel, plain version and
    nn.TransformerEncoderLayer (L of them) forward + backward minus its
    forward (checked first against the plain version in fp32, every history
    with a real step), CUDA events, beside the bound (as the forward's)."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encode_bwd, encode_bwd_plain

    shape = f"S={s} E={e} H={heads} L={layers}"
    plain_reps = PLAIN_REPS if on_card else 30  # as encoder_timing

    def case(dtype, seed):
        x, amask, pad, ws, _, _, _ = encoder_case(torch, dtype, B_TRAIN, e, heads, layers, seed,
                                                  s=s, on_card=on_card)
        pad, amask = pad.clone(), amask.clone()
        pad[0], amask[0] = False, 0.0  # no all-pad history: the library's -inf gives NaN there
        return x, amask, pad, ws, encoder_cotangent(torch, pad, e, seed + 1, dtype, on_card)

    x, amask, pad, ws, g = case(torch.float32, 5)
    lib_layers = library_stack(torch, ws, heads)[0]
    for layer in lib_layers:
        layer.train()
    z1 = []  # the library's FFN pre-activations, its ReLU gates' inputs, layer by layer
    hooks = [layer.linear1.register_forward_hook(lambda mod, inp, out: z1.append(out.detach()))
             for layer in lib_layers]
    lib = library_grads(torch, lib_layers, x, pad, g)
    for hook in hooks:
        hook.remove()
    # fp32 accumulation, as cuBLAS sums for the library: a ReLU gate read
    # from a product then falls on the library's side, but where z1 lies
    # within rounding of 0 (more often the more tokens): there the plain
    # version takes the library's decision (replayed_gates, GATE_MARGIN)
    direct = encode_bwd_plain(g, x, amask, *ws, num_heads=heads, acc=torch.float32)
    replay = {"flips": 0, "margin": 0.0}
    held = (~pad.all(-1))[:, None].expand(pad.shape).reshape(-1)
    with plain_layers(replayed_gates(torch, z1, replay, held)):
        want = encode_bwd_plain(g, x, amask, *ws, num_heads=heads, acc=torch.float32)

    def gap(ref):
        return max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(lib, ref))

    lib_err = gap(want)
    log(f"[compare] nn.TransformerEncoderLayer fp32 forward + backward vs encode_bwd_plain at "
        f"{shape}: largest |d|/max|want| over dx and the 12 gradients {lib_err:.3e} (tolerance "
        f"{LIB_TOL:g}) with the library's ReLU decisions replayed ({replay['flips']} of the "
        f"{int(held.sum()) * z1[0].shape[-1] * layers} in histories with a real step taken "
        f"otherwise, their inputs within {replay['margin']:.2e} of 0 "
        f"relative to the largest |z1|, GATE_MARGIN {GATE_MARGIN:g}); {gap(direct):.3e} "
        f"without the replay (not held)")
    if not lib_err <= LIB_TOL or replay["margin"] > GATE_MARGIN:
        raise SystemExit("the library yardstick does not compute the encoder backward's function")

    x, amask, pad, ws, g = case(torch.bfloat16, 6)
    seed = torch.tensor([11], dtype=torch.int64, device="cuda")
    lib_layers, library = library_stack(torch, ws, heads)
    for layer in lib_layers:
        layer.train()
    tokens = B_TRAIN * s
    # the attention: q k^T and p v of the recomputed forward, then dP, dV,
    # dQ and dK (q k^T counted once), 12 S^2 D a head
    ops, fp32_ops = 3 * 2 * tokens * 12 * e * e * layers, 12 * tokens * s * e * layers
    nbytes = (3 * 2 * x.numel() + 4 * amask.numel()
              + sum(t.numel() * t.element_size() for t in ws) + 4 * sum(t.numel() for t in ws))
    lib_fwd = time_ms(torch, lambda: library(x, pad))
    lib_both = time_ms(torch, lambda: library_grads(torch, lib_layers, x, pad, g))
    kw = dict(num_heads=heads, seed=seed, rate=DROP_RATE)
    t = {
        "ms": time_ms(torch, lambda: encode_bwd(g, x, amask, *ws, **kw)),
        "plain_ms": time_ms(torch, lambda: encode_bwd_plain(g, x, amask, *ws, **kw), plain_reps),
        **bound(nbytes, ops, fp32_ops),
        "library_ms": lib_both - lib_fwd,
    }
    log(f"[time] sasrec_encoder_bwd bf16 B={B_TRAIN} {shape} rate={DROP_RATE}: {t} (bytes "
        f"{nbytes}, ops {ops} bf16 + {fp32_ops} fp32; library: nn.TransformerEncoderLayer bf16 "
        f"forward + backward {lib_both:.4f} ms minus its forward {lib_fwd:.4f} ms) on {card}")
    kernel_split(torch, lambda: encode_bwd(g, x, amask, *ws, **kw),
                 f"sasrec_encoder_bwd bf16 B={B_TRAIN} {shape} dropout {DROP_RATE}", card)
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


def table_grad_cases(torch) -> list[tuple]:
    """Phase 2's table_grad shapes, (tag, ids on the card, rows, E), from
    phase 4's row generator at the training batch: the shared likes_level
    table's step (likes_level + views_level, 8192 ids into 128 + 1 rows,
    the one-step probe's shape: the shared path); the item table's
    (item_id + the 20-item history: 86,016 ids, pad-heavy, into 91,776 + 1
    rows: the sorted path); E = 10 on both paths and 256; ids in the cut-off
    row; the row-sharded local shape (each model rank of 2: rows_per + 1
    rows, the ids it does not own in the last); each path's edges: the
    largest table of the shared path (320 x 128 x 4 B = SHARED_BYTES) and
    one row more, one row taking all 86,016 ids (336 chunks), no ids; ids
    out of range (negative, rows, 2^32 + 5: past int32) on both paths."""
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import SHARED_BYTES

    r = make_rows(B_TRAIN, seed=23)
    likes = np.concatenate([r["likes_level"], r["views_level"]])
    item = np.concatenate([r["item_id"], r["item_seq"].reshape(-1)])
    cut = likes.copy()
    cut[::7] = 128
    rows_per = 91_776 // MP
    edge = SHARED_BYTES // (4 * E)
    cases = [("likes_level", likes, 129, E), ("item_id", item, 91_777, E),
             ("likes_level E=10", likes, 129, 10), ("item_id E=10", item, 91_777, 10),
             ("item_id E=256", item, 91_777, WIDE_E), ("cut-off row", cut, 129, E),
             ("shared edge", likes % edge, edge, E),
             ("shared edge + 1 row", likes % (edge + 1), edge + 1, E),
             ("one row takes every id", np.full_like(item, 5), 91_777, E),
             ("no ids, shared", item[:0], 129, E), ("no ids, sorted", item[:0], 91_777, E)]
    for tag, ids, rows in (("shared", likes, 129), ("sorted", item, 91_777)):
        out = ids.astype(np.int64)  # ids out of range add nothing: negative, rows, past int32
        out[::5], out[1::5], out[2::11] = -3, rows, 2**32 + 5
        cases.append((f"ids out of range, {tag}", out, rows, E))
    for m in range(MP):
        local = item - m * rows_per
        cases.append((f"row-sharded, model rank {m} of {MP}",
                      np.where((local >= 0) & (local < rows_per), local, rows_per),
                      rows_per + 1, E))
    return [(tag, torch.from_numpy(ids.astype(np.int64)).cuda(), rows, e)
            for tag, ids, rows, e in cases]


def tg_step_shapes(exp, rows: int, world: int = 1) -> list[tuple[int, int, int]]:
    """(ids, table rows, E) of each table_grad call in one train step of
    ``exp`` on ``rows`` rows a rank, ``world`` data ranks: one a table over
    its features' ids (a gathered table's into its row buffer: the step's
    unique ids with the forced pad id, at most the table's rows), or over
    row-sharded dense tables (model_parallel > 1) one a feature into its
    shard; each into one extra row, the cut-off row. The step's launches
    are ``tg_step_launches``."""
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.models.trunk import round_up_vocab
    from ctr_recommendation_tpu_torch.training import sparse

    fm = build_feature_map(exp.dataset)
    e, mp = exp.model.embedding_dim, exp.mesh.model_parallel
    sparse_tables = exp.train.table_optimizer != "dense"
    if mp > 1 and sparse_tables:
        raise ValueError("tg_step_shapes: row-sharded sparse tables are not counted")
    vocab = {t.name: round_up_vocab(t.vocab_size) for t in fm.tables}
    shapes, ids = [], {}
    for f in fm.features:
        if f.name in fm.table_of:
            t, n = fm.table_of[f.name], rows * (f.max_len or 1)
            if mp > 1:
                shapes.append((n, vocab[t] // mp + 1, e))
            else:
                ids[t] = ids.get(t, 0) + n
    for t, n in ids.items():
        count = 1 + n * world  # the step's ids over the ranks, the forced pad id included
        gathered = sparse_tables and sparse.choose_strategy(vocab[t], count) == "gathered"
        shapes.append((n, (min(count, vocab[t]) if gathered else vocab[t]) + 1, e))
    return shapes


def tower_step_launches(exp) -> int:
    """The tower blocks' launches in one train step on the card: each hidden
    layer's forward and backward (ops/cuda/tower.py)."""
    from ctr_recommendation_tpu_torch.ops.cuda import tower

    bn = exp.model.batch_norm
    return len(exp.model.hidden_units) * (tower.fwd_launches(bn) + tower.bwd_launches(bn))


def tg_step_launches(exp, rows: int | None = None, world: int = 1) -> int:
    """table_grad's launches in one train step of ``exp`` (``rows`` rows a
    rank, default the batch): launches(n, rows, E) summed over
    tg_step_shapes."""
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import launches

    rows = exp.train.batch_size if rows is None else rows
    return sum(launches(*s) for s in tg_step_shapes(exp, rows, world))


def table_grad_repeats(torch, segments, rows: int, first=None) -> tuple[int, float]:
    """TG_REPEATS calls of table_grad on the same (ids, cot) segments: how
    many results differ from the first (``first``, or the first call's), and
    by how much at most."""
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad

    outs = [table_grad(segments, rows) for _ in range(TG_REPEATS)]
    first = outs[0] if first is None else first
    return (sum(not torch.equal(o, first) for o in outs),
            max(float((o - first).abs().max()) for o in outs))


def table_grad_segment_cases(torch) -> list[tuple]:
    """(tag, segments, rows) of phase 2's segmented calls, as the call sites
    pass them: the likes_level table's two features; the item table's
    item_id and its history's ids (20, 4096) with the cotangent a transposed
    view of a (4096, 20, E) tensor, as the mean-pooled history's comes; the
    item ids cut into MAX_SEGMENTS uneven segments."""
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import MAX_SEGMENTS

    r = make_rows(B_TRAIN, seed=23)
    gen = torch.Generator(device="cuda").manual_seed(29)
    cuda = lambda a: torch.from_numpy(a.astype(np.int64)).cuda()  # noqa: E731
    cot = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    likes = [(cuda(r["likes_level"]), cot(B_TRAIN, E)), (cuda(r["views_level"]), cot(B_TRAIN, E))]
    seq = r["item_seq"]
    item = [(cuda(r["item_id"]), cot(B_TRAIN, E)),
            (cuda(seq.T.copy()), cot(B_TRAIN, seq.shape[1], E).transpose(0, 1))]
    flat = np.concatenate([r["item_id"], seq.reshape(-1)])
    cuts = np.sort(np.random.default_rng(31).choice(len(flat), MAX_SEGMENTS - 1, replace=False))
    pieces = np.split(flat, cuts)
    many = [(cuda(p), cot(len(p), E)) for p in pieces]
    return [("likes_level, 2 segments", likes, 129), ("item_id, 2 segments", item, 91_777),
            (f"item_id, {MAX_SEGMENTS} segments", many, 91_777)]


def table_grad_against_plain(torch) -> tuple[float, list]:
    """Phase 2: table_grad at each of table_grad_cases' shapes against its
    plain version in fp64, within TG_NORM_TOL in norm (the largest absolute
    gap logged), bit for bit table_grad_order (the kernel's order, in fp32
    on the CPU), launches(n, rows, E) launches a call, and TG_REPEATS calls
    bit-identical; table_grad_segment_cases' segmented calls bit for bit
    the call on their concatenation; then the C predicate against fits and
    the C plan against plan on the envelope's edges. Returns (the largest
    absolute gap, failures)."""
    from ctr_recommendation_tpu_torch.ops.cuda import table_grad as tg

    worst, failures = 0.0, []
    for i, (tag, ids, rows, e) in enumerate(table_grad_cases(torch)):
        cot = torch.randn(len(ids), e, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(i))
        tg.table_grad.launches = 0
        got = tg.table_grad([(ids, cot)], rows)
        launched = tg.table_grad.launches
        want = tg.table_grad_plain([(ids, cot.double())], rows)
        torch.cuda.synchronize()
        norm = float(want.norm())
        gap = norm_gap(got, want) if norm else float(got.abs().max())
        err = float((got.double() - want).abs().max())
        order = torch.equal(got.cpu(), tg.table_grad_order([(ids, cot)], rows))
        differ, moved = table_grad_repeats(torch, [(ids, cot)], rows, got)
        touched = int(torch.unique(ids).numel())
        p = tg.plan(len(ids), rows, e)
        ok = (gap <= TG_NORM_TOL and order and differ == 0 and launched == p.launches
              and got.shape == (rows, e) and got.dtype == torch.float32)
        worst = max(worst, err)
        log(f"[compare] table_grad {tag}: {len(ids)} ids ({touched} rows touched) into "
            f"({rows}, {e}), the {p.path} path: |d|/|want| {gap:.3e} against the fp64 plain "
            f"version (tolerance {TG_NORM_TOL:g}), max|d| {err:.3e}; bit for bit the order "
            f"mirror on the CPU: {order}; {TG_REPEATS} calls on the same inputs, {differ} differ "
            f"from the first (max|d| {moved:.1e}); {launched} launches (plan {p.launches}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"table_grad {tag}")
    for tag, segs, rows in table_grad_segment_cases(torch):
        n, e = sum(i.numel() for i, _ in segs), segs[0][1].shape[-1]
        tg.table_grad.launches = 0
        got = tg.table_grad(segs, rows)
        launched = tg.table_grad.launches
        flat = [(torch.cat([i.reshape(-1) for i, _ in segs]),
                 torch.cat([c.reshape(-1, e) for _, c in segs]))]
        same = torch.equal(got, tg.table_grad(flat, rows))
        differ, _ = table_grad_repeats(torch, segs, rows, got)
        ok = same and differ == 0 and launched == tg.launches(n, rows, e)
        log(f"[compare] table_grad {tag} ({[tuple(c.shape) for _, c in segs]}, contiguous "
            f"{[c.is_contiguous() for _, c in segs]}): bit for bit the call on their "
            f"concatenation: {same}; {TG_REPEATS} calls, {differ} differ; {launched} launches "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"table_grad {tag}")
    lib = tg._kernel_lib()
    edge = tg.SHARED_BYTES // 4
    edges = [(n, r, e, k) for n in (-1, 0, 1, tg.SLICE, tg.SLICE * tg.MAX_SLICES + 1, tg.MAX_IDS,
                                     tg.MAX_IDS + 1)
             for r in (0, 1, 320, 321, edge, edge + 1, tg.MAX_ROWS, tg.MAX_ROWS + 1)
             for e in (0, 1, 10, 128, 1 << 20) for k in (0, 1, tg.MAX_SEGMENTS,
                                                       tg.MAX_SEGMENTS + 1)]
    apart = [x for x in edges if bool(lib.table_grad_fits(*x)) != tg.fits(*x)]
    plans = {x[:3] for x in edges}
    plan_apart = [x for x in sorted(plans)
                  if tg.c_plan(*x) != (tg.plan(*x) if tg.fits(*x) else None)]
    log(f"[compare] table_grad fits and plan: the C predicate and the Python one on "
        f"{len(edges)} points of the envelope's edges, {len(apart)} apart {apart}; the C plan "
        f"and the Python one on {len(plans)} shapes, {len(plan_apart)} apart {plan_apart}")
    if apart or plan_apart:
        failures.append("table_grad fits / plan")
    return worst, failures


def table_grad_timing(torch, card) -> dict:
    """Phase 3: table_grad at the item table's (the sorted path: the key
    sort and both passes) and the likes_level table's step shapes
    (the shared path), each launch's device time (kernel_split), beside its
    plain version, fp32 index_add_ alone, the library call (aten's dense
    embedding backward, which the port never calls) and the byte bound (the
    ids read once, 8 B, the cotangents once, the gradient written once).
    Returns the item table's times (the kernels line's)."""
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import plan, table_grad, table_grad_plain

    out = {}
    for tag, ids, rows, e in table_grad_cases(torch)[:2]:  # likes_level, then item_id
        cot = torch.randn(len(ids), e, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
        nbytes = 8 * len(ids) + 4 * e * (len(ids) + rows)
        segs = [(ids, cot)]
        t = {"ms": time_ms(torch, lambda: table_grad(segs, rows)),
             "plain_ms": time_ms(torch, lambda: table_grad_plain(segs, rows)),
             "library_ms": time_ms(torch, lambda: torch.ops.aten.embedding_dense_backward(
                 cot, ids, rows, -1, False)),
             **bound(nbytes, 0)}
        index_add = time_ms(torch, lambda: torch.zeros(rows, e, device="cuda").index_add_(
            0, ids, cot))
        log(f"[time] table_grad {tag}: {len(ids)} ids into ({rows}, {e}), "
            f"{plan(len(ids), rows, e)}: {t} (bytes {nbytes}; library_ms: "
            f"embedding_dense_backward; fp32 index_add_ alone {index_add:.4f} ms) on {card}")
        kernel_split(torch, lambda: table_grad(segs, rows), f"table_grad {tag}", card)
        out = t
    return out


# the tower kernels (csrc/tower.cu) at the mm cell's layers: (rows, fan-in, width)
TOWER_SHAPES = ((131072, 2688, 512), (131072, 512, 256))
TOWER_RATE = 0.2  # mm_fibinet's net_dropout
TOWER_TESTS = "tests/test_torch_tower_kernels.py"
TOWER_CASES = 48  # its cases, every one of which has to pass on the card
# kernel against plain blocks at TOWER_SHAPES, as the card tests hold them:
# each element of out and dh within a bf16 ulp of |plain| plus TOWER_ABS of
# the tensor's largest |plain| (out where the two codes agree: a gate at z
# within rounding of 0 may differ; dh on the kernels' code)
TOWER_ABS = 1e-5


def tower_against_plain(torch) -> float:
    """Phase 2: the tower kernels' card tests (TOWER_TESTS: each block
    against its plain version, the layer against the plain blocks and the
    library composition, bf16 and fp32, BatchNorm on and off, rates 0 and
    0.2, weights, widths 50 to 512, 0 to 131,072 rows, repeats bit for bit,
    the launch counters, the C plan, a one-rank data-parallel group), run
    by pytest without the JAX conftest; the phase fails unless all
    TOWER_CASES pass, none skipped. Then the layer at the mm cell's shapes
    against the plain blocks (TOWER_ABS); returns the worst |d| of out and
    dh there."""
    from ctr_recommendation_tpu_torch.ops.cuda import tower

    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
           "--tb=short", TOWER_TESTS]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True)
    tail = res.stdout.strip().splitlines()[-1:] or [res.stderr.strip()[-400:]]
    log(f"[compare] tower: {TOWER_TESTS} rc {res.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: {tail[0]}")
    if res.returncode != 0 or not re.fullmatch(
            rf"{TOWER_CASES} passed(, \d+ warnings?)? in [^,]*", tail[0]):
        log(res.stdout[-20000:])
        raise SystemExit(f"the tower kernels' card tests: not all {TOWER_CASES} passed")
    keep, worst = 1.0 - TOWER_RATE, 0.0
    for rows, d_in, n in TOWER_SHAPES:
        t = tower_inputs(torch, rows, d_in, n, torch.bfloat16, seed=n + 1)
        y, b, gamma, beta, u, dout = (t[k] for k in ("y", "b", "gamma", "beta", "u", "dout"))
        sums = tower.fwd_sums(y, b, None)
        devs = tower.fwd_devs(y, b, None, sums)
        out, code, _ = tower.fwd_apply(y, b, gamma, beta, sums, devs, u, keep, t["rm"], t["rv"])
        sums_p = tower.fwd_sums_plain(y, b, None)
        devs_p = tower.fwd_devs_plain(y, b, None, sums_p)
        out_p, code_p, _ = tower.fwd_apply_plain(y, b, gamma, beta, sums_p, devs_p, u, keep,
                                                 t["rm"], t["rv"])
        same = tower.unpack_code(code, n) == tower.unpack_code(code_p, n)
        gsums = tower.bwd_sums(dout, y, code, b, gamma, beta, sums, devs, keep)
        dh = tower.bwd_dx(dout, y, code, b, gamma, beta, sums, devs, gsums, None, keep)[0]
        dh_p = tower.bwd_dx_plain(dout, y, code, b, gamma, beta, sums, devs, gsums, None, keep)[0]
        errs = []
        for name, a, w in (("out", out[same], out_p[same]), ("dh", dh, dh_p)):
            a, w = a.double(), w.double()
            d = (a - w).abs()
            errs.append(d.max().item())
            if bool((d > 2.0 ** -7 * w.abs() + TOWER_ABS * w.abs().max()).any()):
                raise SystemExit(f"tower ({rows}, {n}): {name} off its plain version, max|d| "
                                 f"{errs[-1]:.3e}")
        worst = max(worst, *errs)
        log(f"[compare] tower ({rows}, {n}) bf16, BatchNorm, dropout {TOWER_RATE}: max|d| out "
            f"{errs[0]:.3e} ({int((~same).sum())} gates apart, within rounding of 0), dh "
            f"{errs[1]:.3e} against the plain blocks (a bf16 ulp + {TOWER_ABS:g} of the "
            f"largest)")
        del t, out, out_p, dh, dh_p
    return worst


def tower_inputs(torch, rows: int, d_in: int, n: int, dtype, seed: int) -> dict:
    """A layer at (rows, d_in) -> n on the card: y = x W from cuBLAS, the
    fp32 bias, BatchNorm affine and running statistics, the uniforms and a
    cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    x = (rnd(rows, d_in) + 0.3).to(dtype)
    y = x @ (rnd(d_in, n) / d_in ** 0.5).to(dtype)
    return {"y": y, "b": 0.1 * rnd(n), "gamma": 1 + 0.2 * rnd(n), "beta": 0.2 * rnd(n),
            "rm": 0.1 * rnd(n), "rv": 0.5 + rnd(n).abs(),
            "u": torch.rand(rows, n, device="cuda", generator=gen), "dout": rnd(rows, n).to(dtype)}


def tower_fused(torch, t: dict, keep: float):
    """The layer's forward and backward on the kernels (TowerLayer)."""
    from ctr_recommendation_tpu_torch.ops.cuda import tower

    leaves = [t[k].detach().requires_grad_() for k in ("y", "b", "gamma", "beta")]
    out, _ = tower.TowerLayer.apply(*leaves, t["u"], None, t["rm"], t["rv"], keep, None)
    return torch.autograd.grad(out, leaves, t["dout"])


def tower_plain(torch, t: dict, keep: float):
    """The same on the plain blocks, on the card."""
    from ctr_recommendation_tpu_torch.ops.cuda import tower

    y, b, gamma, beta, u = (t[k] for k in ("y", "b", "gamma", "beta", "u"))
    sums = tower.fwd_sums_plain(y, b, None)
    devs = tower.fwd_devs_plain(y, b, None, sums)
    _, code, _ = tower.fwd_apply_plain(y, b, gamma, beta, sums, devs, u, keep, t["rm"], t["rv"])
    gsums = tower.bwd_sums_plain(t["dout"], y, code, b, gamma, beta, sums, devs, keep)
    return tower.bwd_dx_plain(t["dout"], y, code, b, gamma, beta, sums, devs, gsums, None, keep)


def tower_library(torch, t: dict, keep: float):
    """The library composition the kernels replace, as ops/mlp.py ran it on
    the card before them (a frozen copy, the yardstick): the bias add in cd,
    BatchNorm's plain branch (fp32 mean and var, the running statistics,
    the normalise-and-affine in cd), torch.relu, dropout's select; and
    autograd's backward of it."""
    leaves = [t[k].detach().requires_grad_() for k in ("y", "b", "gamma", "beta")]
    y, b, gamma, beta = leaves
    h = y + b.to(y.dtype)
    h32 = h.float()
    mean, var = h32.mean(0), h32.var(0, unbiased=False)
    n = h.shape[0]
    unbiased = var * (n / max(n - 1, 1))
    _ = (0.9 * t["rm"] + 0.1 * mean.detach(), 0.9 * t["rv"] + 0.1 * unbiased.detach())
    inv = torch.rsqrt(var.to(h.dtype) + 1e-5)
    h = (h - mean.to(h.dtype)) * inv
    h = h * gamma.to(h.dtype) + beta.to(h.dtype)
    h = torch.where(t["u"] < keep, torch.relu(h) / keep, 0.0)
    return torch.autograd.grad(h, leaves, t["dout"])


def device_kernels(torch, fn) -> int:
    """The kernels (not copies or sets) one call of ``fn`` launches on the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def tower_timing(torch, card) -> dict:
    """Phase 3: one tower layer after its GEMM, forward and backward, at the
    mm cell's two layers in bf16, BatchNorm and dropout on (the uniforms
    drawn beforehand; the draw timed alone): the kernels, the plain blocks on
    the card, the library composition they replace, and the byte bound (y,
    u, dout read once, out, the code and dh written once, y and the code
    read again by the backward); each launch's device time (kernel_split);
    the kernels a call launches on both paths. Returns the wider layer's
    times (the kernels line's)."""
    from ctr_recommendation_tpu_torch.ops.cuda import tower

    keep = 1.0 - TOWER_RATE
    out = {}
    for rows, d_in, n in TOWER_SHAPES:
        t = tower_inputs(torch, rows, d_in, n, torch.bfloat16, seed=n)
        nbytes = rows * n * (6 * 2 + 4 + 2 * 0.125)
        res = {"ms": time_ms(torch, lambda: tower_fused(torch, t, keep)),
               "plain_ms": time_ms(torch, lambda: tower_plain(torch, t, keep), reps=10),
               "library_ms": time_ms(torch, lambda: tower_library(torch, t, keep), reps=10),
               **bound(nbytes, 0)}
        draw = time_ms(torch, lambda: torch.rand(rows, n, device="cuda"))
        fused_k = device_kernels(torch, lambda: tower_fused(torch, t, keep))
        library_k = device_kernels(torch, lambda: tower_library(torch, t, keep))
        log(f"[time] tower ({rows}, {n}) bf16, from fan-in {d_in}, BatchNorm and dropout "
            f"{TOWER_RATE}, forward + backward after the GEMM: {res} (bytes {nbytes:.0f}); "
            f"kernels a call {fused_k} ({tower.fwd_launches(True) + tower.bwd_launches(True)} "
            f"counted), the library composition's {library_k}; torch.rand's draw "
            f"{draw:.4f} ms on {card}")
        kernel_split(torch, lambda: tower_fused(torch, t, keep), f"tower ({rows}, {n})", card)
        kernel_split(torch, lambda: tower_library(torch, t, keep),
                     f"tower library ({rows}, {n})", card)
        if not out:
            out = res
    return out


def repeat_probe(torch, tr, batch: dict, tag: str, card, hard: bool = True) -> dict:
    """One train step's loss and gradients on the same batch twice from the
    same state (the step's dropout masks are drawn from the step: the same
    both times). Logs the leaves that differ, with their max|d|; with
    ``hard`` any difference fails. Returns them."""
    runs = []
    for _ in range(2):
        with torch.enable_grad():
            loss, aux = tr.forward_loss(batch)
            grads = tr.gradients(loss, aux)
        runs.append((aux.loss.clone(), dict(zip(aux.targets, grads))))
    (l0, g0), (l1, g1) = runs
    moved = {p: float((g - g1[p]).abs().max()) for p, g in g0.items() if not torch.equal(g, g1[p])}
    if not torch.equal(l0, l1):
        moved["loss"] = float((l0 - l1).abs())
    log(f"[probe {tag}] one step's loss and {len(g0)} gradients on the same batch twice: "
        f"leaves that differ, max|d|: {moved} on {card}")
    if hard and moved:
        raise SystemExit(f"{tag}: one step on the same batch twice gave other bits: {moved}")
    return moved


def train_and_serve(torch, exp, train, valid, store, root, card, counted, per_step: dict,
                    per_eval: dict, per_serve: dict, tag: str = "", fused: bool = True,
                    probe: bool | None = None) -> dict:
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
    log (default: the model's name). ``probe``: after the fit, the trained
    step on its first batch twice (repeat_probe), any leaf apart failing
    (True) or logged (False). Returns the launches of each counted
    wrapper in the fit (``launches``) and the tower blocks' launches in it
    (``tower_launches``), the fit's history (``hist``), its
    best valid AUC, the step split's numbers (``step``), the gradient
    check's worst gap (``grad_gap``), the serving Predictor (``server``),
    the AUC evaluate gave its export (``served_auc``) and the probe's
    leaves apart (``probe``, None without one)."""
    from ctr_recommendation_tpu_torch.cli.evaluate import eval_line, evaluate
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.ops.cuda import tower
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
    bs, n_train, n_valid = exp.train.batch_size, train.num_rows, valid.num_rows
    steps = TRAIN_EPOCHS * (n_train // bs)
    eval_batches = TRAIN_EPOCHS * -(-n_valid // exp.train.eval_batch_size)
    trainer = Trainer(exp, steps_per_epoch=n_train // bs, item_store=store, log_fn=log)
    torch.cuda.synchronize()
    for fn in (*counted, *tower.BLOCKS):
        fn.launches = 0
    t0 = time.perf_counter()
    hist = trainer.fit_on_device(train, valid)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launched = {fn: fn.launches for fn in counted}
    tower_launches = tower.launches()
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
    moved = None if probe is None else repeat_probe(
        torch, trainer, {k: torch.as_tensor(v[:bs]).cuda() for k, v in train.columns.items()},
        tag, card, hard=probe)
    step = step_split(torch, trainer, train, card, tag)

    served_params, served_state = jax_bridge.params_from_jax(
        *jax_bridge.load(export), trainer.fm, exp.model)
    server = Predictor(exp, served_params, served_state, item_store=store)
    for fn in counted:
        fn.launches = 0
    res = evaluate(server, valid, batch_size=B_FULL, gauc_col="user_id")
    served = {fn: fn.launches for fn in counted}
    n_batches = -(-n_valid // B_FULL)
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
    if res["rows"] != n_valid or res["auc"] != served_auc:
        raise SystemExit(f"{tag}: evaluate's AUC is not the served probabilities' AUC")
    if abs(served_auc - best_auc) > AUC_SERVE_TOL:
        raise SystemExit(f"{tag}: the served export disagrees with the trainer's eval")
    if not np.isfinite(res["logloss"]) or abs(res["gauc"] - cpu_gauc) > GAUC_TOL:
        raise SystemExit(f"{tag}: evaluate's logloss is not finite or its gAUC is not the CPU's")
    return {"launches": launched, "tower_launches": tower_launches, "hist": hist,
            "best_auc": best_auc, "step": step,
            "grad_gap": grad_gap, "server": server, "served_auc": res["auc"], "probe": moved}


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
                # table_grad's launches over this strategy's table shapes
                step = {fn: tg_step_launches(exp) if fn.__name__ == "table_grad" else k
                        for fn, k in kernels.items()}
                tr, batch, aux, grads, _ = gradient_check(torch, exp, train, store, root,
                                                          step, tag)
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
        step = {fn: tg_step_launches(exp) if fn.__name__ == "table_grad" else k
                for fn, k in per_step.items()}
        runs[tag] = train_and_serve(torch, exp, train, valid, store, root, card, counted,
                                    per_step=step, per_eval=per_eval, per_serve=per_serve,
                                    tag=tag, probe=True)
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
    # the card's step on identical inputs, twice: every leaf bit for bit
    batch = fm_trainer._ready(fm_trainer.put_batch(next(epoch_batches(0))))
    repeat_probe(torch, fm_trainer, batch, "mm_fibinet", card)
    # the shared likes_level table's merged table gradient alone, on fixed inputs:
    # one segment a feature, as the step passes them
    rows = fm_trainer.state.params["trunk"]["tables"]["likes_level"].shape[0] + 1
    gen = torch.Generator(device=batch["likes_level"].device).manual_seed(0)
    segs = [(batch[f].to(torch.int64),
             torch.randn(len(batch[f]), exp.model.embedding_dim, device=batch[f].device,
                         generator=gen)) for f in ("likes_level", "views_level")]
    differ, moved = table_grad_repeats(torch, segs, rows)
    log(f"[fit] table_grad of {sum(len(i) for i, _ in segs)} ids in 2 segments into {rows} "
        f"rows, the same inputs {TG_REPEATS} times: {differ} results differ from the first, "
        f"max|d| {moved:.3e}")
    if differ:
        raise SystemExit("table_grad gave other bits on the same inputs")
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

    for other in ("k1_repeat", f"k{FIT_K}"):
        metrics = {key: gap("k1", other, key) for key in ("train_loss", "auc")}
        moved = param_gaps("k1", other)
        log(f"[fit] {other} against k1: per-epoch train loss and valid auc |d| {metrics}; "
            f"parameters that differ, max|d|: {moved} (bar: bit for bit)")
        if any(metrics.values()) or moved or len(runs[other]) != len(runs["k1"]):
            raise SystemExit(f"fit {other} is not fit k1 bit for bit: {metrics}, {moved}")
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
# the zoo's train rows: the first half of phase 6's (a depth cut made to pay for
# phase 7f: each fit half as long)
ZOO_TRAIN = N_TRAIN // 2


def zoo(torch, train, valid, store, root, card, counted, rows, dense: dict) -> None:
    """Phase 6g (see the module docstring). ``rows`` are phase 4's serving
    rows; ``dense`` is phase 6's mm_fibinet run; the models train on the
    first ZOO_TRAIN rows of ``train``."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import TableData
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad

    train = TableData({k: v[:ZOO_TRAIN] for k, v in train.columns.items()}, ZOO_TRAIN)
    runs, probes = {}, {}
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
                              per_step={table_grad: tg_step_launches(exp)}, per_eval={},
                              per_serve={}, fused=False, probe=False)
        probes[name] = run["probe"]
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
    log(f"[zoo] the one-step probe, leaves that differ between two steps on the same batch: "
        f"{ {n: sorted(m) for n, m in probes.items() if m} or 'none'} on {card}")
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


def dp_experiment(ckpt: str, fp32: bool, model: str = "mm_fibinet"):
    """The full microlens_experiment() defaults of ``model`` (dropout 0.2,
    sasrec_fibinet's attention dropout 0.1, use_pallas), in fp32 for the
    step checks."""
    import dataclasses

    from ctr_recommendation_tpu_torch.config import microlens_experiment

    exp = microlens_experiment(data_root="", epochs=TRAIN_EPOCHS, checkpoint_dir=ckpt,
                               batch_size=B_TRAIN, model=model)
    if fp32:
        exp = exp.replace(train=dataclasses.replace(exp.train, compute_dtype="float32"))
    return exp


@contextlib.contextmanager
def dp_tower(torch, replay, codes: list, given: list | None, stats: dict):
    """dp_step's tower. ``given`` None: on its kernels, each layer's
    decisions (ReLU on and the element kept: the code the kernels keep for
    the backward) appended to ``codes`` on the CPU. Else on the
    composition, each layer's ReLU taking ``given``'s next layer (this
    step's rows of it); ``stats`` counts the layers met (``calls``) and,
    where the layer's dropout keeps an element, the decisions its own ReLU
    would have taken otherwise (``flips``) with the largest |input| /
    max|input| among them (``margin``). ``replay``, the step's gate_replay,
    is paused inside the tower."""
    from torch.overrides import TorchFunctionMode

    from ctr_recommendation_tpu_torch.ops import mlp
    from ctr_recommendation_tpu_torch.ops.cuda import tower

    kernel_layer, plain, on_kernels = mlp._kernel_layer, mlp.apply, mlp.on_kernels
    if given is None:
        def recorded(layer, st, x, rate, generator, weight):
            replay.paused = True
            try:
                out, new_st = kernel_layer(layer, st, x, rate, generator, weight)
            finally:
                replay.paused = False
            code = out.grad_fn.saved_tensors[1]  # TowerLayer's, as its backward reads it
            codes.append(tower.unpack_code(code, out.shape[1]).cpu())
            return out, new_st

        mlp._kernel_layer = recorded
    else:
        pending = []

        def account(kept):
            x, own, want = pending.pop()
            differ = (own != want) & kept
            if bool(differ.any()):
                stats["flips"] += int(differ.sum())
                mag = x.detach().abs()
                stats["margin"] = max(stats["margin"], float(mag[differ].max() / mag.max()))

        class Mode(TorchFunctionMode):
            def __init__(self, rate: float):
                super().__init__()
                self.rate = rate

            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func is torch.relu:
                    x = args[0]
                    want = given[stats["calls"]].to(x.device)
                    stats["calls"] += 1
                    pending.append((x, x > 0, want))
                    if self.rate == 0.0:
                        account(torch.ones_like(want))
                    return torch.where(want, x, 0.0)
                if func is torch.where and pending and args[0].dtype == torch.bool:
                    account(args[0])  # the dropout's select: its kept elements
                return func(*args, **kwargs)

        def apply(*args, **kw):
            replay.paused = True
            try:
                with Mode(kw.get("dropout_rate", 0.0) if kw.get("train") else 0.0):
                    return plain(*args, **kw)
            finally:
                replay.paused = False

        mlp.apply = apply
        mlp.on_kernels = lambda x, train: False
    try:
        yield
    finally:
        mlp._kernel_layer, mlp.apply, mlp.on_kernels = kernel_layer, plain, on_kernels


def dp_step(torch, tr, batch: dict, gates, part, encoder: list | None = None,
            tower: list | None = None) -> dict:
    """One train step of ``tr`` on ``batch`` (device columns), the forward
    recording its gates (``gates`` None) or replaying ``part`` of them;
    returns the global loss, the gradients by target, the interaction (and
    table_grad), encoder and tower launches, the replay's counts, and after
    the update the gradients as the optimizer left them (``clipped``: clipped, plus the L2
    term), the parameters and the model state (on the CPU). With
    ``encoder`` (a list) the encoder kernels' FFN decisions are recorded
    into it (encoder_gates: each layer's f1 and its real tokens), as the
    kernels take them: they cannot be replayed inside a kernel. The tower
    (dp_tower) runs on its kernels, as training does, each layer's
    decisions recorded (``tower`` in the result, this step's rows); given
    ``tower`` (each layer's over the global batch, as the ranks' kernels
    took them), the reference runs it on the composition taking them
    (``tower_calls``, ``tower_flips``, ``tower_margin``)."""
    from ctr_recommendation_tpu_torch.ops.cuda import tower as tower_ops
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import encode_bwd, encode_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten

    interaction_fwd.launches = interaction_bwd.launches = table_grad.launches = 0
    encode_fwd.launches = encode_bwd.launches = 0
    for fn in tower_ops.BLOCKS:
        fn.launches = 0
    replay = gate_replay(torch, gates, part, tower=False)
    codes, tstats = [], {"calls": 0, "flips": 0, "margin": 0.0}
    enc_gates, f1 = [], []
    recorded = contextlib.nullcontext() if encoder is None else \
        encoder_gates(torch, enc_gates, None, values=f1)
    with torch.enable_grad():
        with replay, recorded, dp_tower(torch, replay, codes, tower, tstats):
            loss, aux = tr.forward_loss(batch)
        grads = tr.gradients(loss, aux)
    torch.cuda.synchronize()
    if encoder is not None:
        encoder.extend((v, real.cpu()) for v, (_, real) in zip(f1, enc_gates))
    out = {"loss": aux.loss.item(), "grads": dict(zip(aux.targets, (g.detach().cpu().clone()
                                                                     for g in grads))),
           "launches": (interaction_fwd.launches, interaction_bwd.launches,
                        table_grad.launches),
           "enc_launches": (encode_fwd.launches, encode_bwd.launches),
           "tower_launches": tower_ops.launches(),
           "tower_want": 0 if tower is not None else tower_step_launches(tr.exp),
           "calls": replay.calls, "flips": replay.flips, "margin": replay.margin,
           "gates": [g.cpu() for g in replay.gates], "tower": codes,
           "tower_calls": tstats["calls"], "tower_flips": tstats["flips"],
           "tower_margin": tstats["margin"],
           "params0": {k: v.detach().cpu().clone() for k, v in tr.param_paths.items()}}
    tr.apply_gradients(grads, aux)
    out["clipped"] = {k: g.detach().cpu().clone() for k, g in zip(aux.targets, grads)}
    out["params"] = {k: v.detach().cpu().clone() for k, v in flatten(tr.state.params).items()}
    out["state"] = {k: v.cpu().clone() for k, v in flatten(tr.state.model_state).items()}
    out["lr0"], out["weight_decay"] = tr.schedule(0), tr.exp.train.weight_decay
    return out


def dp_reference(torch, tr, batch: dict, ref: dict, codes: list,
                 encoder: list | None = None) -> dict:
    """The 1-process step again, on a fresh Trainer ``tr`` (the recorded
    step's seeded weights), its other gates replaying ``ref``'s (the
    recorded 1-process step) and its tower on the composition taking the
    ranks' decisions ``codes`` (each layer's over the global batch): the
    reference dp_check_step holds the ranks' kernel steps to. ``encoder``
    as the recorded step took it (its recording meets gates of its own).
    Fails unless every layer was met and any decision the composition
    would have taken otherwise lies within GATE_MARGIN of 0."""
    res = dp_step(torch, tr, batch, ref["gates"], (0, 1), encoder=encoder, tower=codes)
    if res["tower_calls"] != len(codes) or res["tower_margin"] > GATE_MARGIN:
        raise SystemExit(f"the 1-process reference met {res['tower_calls']} tower layers for "
                         f"the ranks' {len(codes)}, or a tower gate flipped beyond rounding "
                         f"({res['tower_margin']:.2e} > {GATE_MARGIN:g})")
    return res


def rank_codes(torch, steps: list) -> list:
    """Each tower layer's decisions over the global batch: the data ranks'
    ``tower`` (dp_step), in row order."""
    return [torch.cat(layer) for layer in zip(*(s["tower"] for s in steps))]


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
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
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
        elif task == "sasrec_step":  # (a) for sasrec_fibinet: its encoder masks counted
            tr = Trainer(dp_experiment(spec["ckpt"] + f"_sasrec{rank}", fp32=True,
                                       model="sasrec_fibinet"),
                         steps_per_epoch=N_TRAIN // bs, item_store=data["store"],
                         device=DP_DEVICE, log_fn=lambda s: None)
            n = bs // world
            cols, row0 = distributed.host_local_to_global(
                {k: v[rank * n : (rank + 1) * n] for k, v in data["train"].columns.items()},
                tr.mesh)
            encoder = []
            res = dp_step(torch, tr, cols, torch.load(spec["sasrec_gates"]), (rank, world),
                          encoder=encoder)
            res.update(row0=row0, encoder=encoder)
            res.pop("gates")
            out["sasrec_step"] = res
        elif task == "fit":  # (b): fit_on_device, the global batch 4096
            exp = dp_experiment(spec["ckpt"] + "_fit", fp32=False)
            tr = Trainer(exp, steps_per_epoch=N_TRAIN // bs, item_store=data["store"],
                         device=DP_DEVICE, log_fn=log if rank == 0 else (lambda s: None))
            torch.cuda.synchronize()
            interaction_fwd.launches = interaction_bwd.launches = table_grad.launches = 0
            data_parallel.stats.update(calls=0, bytes=0)
            t0 = time.perf_counter()
            hist = tr.fit_on_device(data["train"], data["valid"])
            torch.cuda.synchronize()
            res = {"hist": hist, "seconds": time.perf_counter() - t0,
                   "launches": (interaction_fwd.launches, interaction_bwd.launches,
                                table_grad.launches),
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
    rows (dp_reference): the loss, every fp32 gradient (GRAD_TOL of the leaf
    + GRAD_FLOOR of the largest; the 1-process gates replayed, each flip
    within GATE_MARGIN), the rank's tower on its kernels (its blocks'
    launches exact), the BatchNorm running statistics (DP_STATE_TOL) and the
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
          and got["margin"] <= GATE_MARGIN and got["tower_want"] > 0
          and got["tower_launches"] == got["tower_want"] and ref["tower_launches"] == 0)
    log(f"[{'dp' if phase == '6h' else 'mp'} {tag}] loss {got['loss']:.7f} vs 1 process "
        f"{ref['loss']:.7f}; {len(names)} fp32 "
        f"gradients, before the update and clipped: worst |d|/max|g| {worst:.3e} (tolerance "
        f"{GRAD_TOL:g} of the leaf + "
        f"{GRAD_FLOOR:g} of the largest); the 1-process gates replayed: {got['calls']} of "
        f"{len(ref['gates'])} met, {got['flips']} flips, within {got['margin']:.2e} of 0 "
        f"(GATE_MARGIN {GATE_MARGIN:g}); the tower on its kernels ({got['tower_launches']} "
        f"launches, {got['tower_want']} expected), the reference's composition taking their "
        f"decisions: {ref['tower_flips']} flips, within {ref['tower_margin']:.2e}; BatchNorm "
        f"running stats |d| {state_err:.2e} (tolerance "
        f"{DP_STATE_TOL:g}); parameters after the update |d| {param_err:.2e} where the gradient "
        f"fixes the step (tolerance {DP_PARAM_TOL:g} (1 + |p|); elsewhere 2 lr = {2 * lr:.2e}) "
        f"{'ok' if ok else f'FAIL {bad} {param_bad}'}")
    if not ok:
        raise SystemExit(f"phase {phase} {tag}: the ranks' step disagrees with one process's")
    return worst


def dp_encoder_decisions(torch, got: list, ref: list, rank: int) -> tuple:
    """A rank's encoder FFN decisions (dp_step's ``encoder``: each layer's
    f1 and real tokens) against the one process's at the same tokens (the
    rank's share of ``ref``): (layers, decisions at real tokens, flips,
    the largest |f1| of a flipped decision over its layer's largest |f1|,
    max |d| of f1 at real tokens)."""
    if len(got) != len(ref):
        raise SystemExit(f"phase 6h sasrec_step: {len(got)} encoder layers recorded, the one "
                         f"process {len(ref)}")
    decisions = flips = 0
    margin = gap = 0.0
    for (v, real), (w, _) in zip(got, ref):
        n = v.shape[0]
        real = real.reshape(-1)
        v, w = v[real], w[rank * n : (rank + 1) * n][real]
        differ = (v > 0) != (w > 0)
        decisions += v.numel()
        gap = max(gap, float((v - w).abs().max()))
        if bool(differ.any()):
            flips += int(differ.sum())
            mag = torch.maximum(v.abs(), w.abs())
            margin = max(margin, float(mag[differ].max() / w.abs().max()))
    return len(got), decisions, flips, margin, gap


def data_parallel_phase(torch, train, valid, store, root, card, dense: dict) -> dict:
    """Phase 6h (see the module docstring). ``dense`` is phase 6's
    mm_fibinet run. Returns (b)'s best AUC and fits, (a)'s worst gradient
    gap and the launches of the sasrec_fibinet step on both ranks."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        bwd_launches as inter_bwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        fwd_launches as inter_fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        bwd_launches,
        encode_bwd,
        encode_fwd,
        fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
    from ctr_recommendation_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    bs = B_TRAIN
    ids = np.flatnonzero(store.known_mask)
    inputs = os.path.join(root, "dp_inputs.npz")
    np.savez(inputs, item_ids=ids, item_emb=store.emb[ids],
             **{f"train/{k}": v for k, v in train.columns.items()},
             **{f"valid/{k}": v for k, v in valid.columns.items()})
    def fresh(tag: str, model: str = "mm_fibinet"):
        return Trainer(dp_experiment(os.path.join(root, f"dp_ref_{tag}"), fp32=True, model=model),
                       steps_per_epoch=N_TRAIN // bs, item_store=store, device=DP_DEVICE,
                       log_fn=lambda s: None)

    # the 1-process step on the first 4096 rows, its gates recorded; each check's
    # reference is this step again, taking the ranks' tower decisions (dp_reference)
    first = {k: torch.as_tensor(v[:bs]).to(DP_DEVICE) for k, v in train.columns.items()}
    rec = dp_step(torch, fresh("rec"), first, None, (0, 1))
    gates = os.path.join(root, "dp_gates.pt")
    torch.save(rec["gates"], gates)
    # sasrec_fibinet's 1-process step on the same rows, its encoder's decisions recorded
    tr = fresh("rec_sasrec", "sasrec_fibinet")
    m = tr.exp.model
    if (m.net_dropout, m.attn_dropout) != (0.2, DROP_RATE):
        raise SystemExit(f"phase 6h sasrec_step: dropout {m.net_dropout}, {m.attn_dropout}")
    sasrec_enc = []
    sasrec_rec = dp_step(torch, tr, first, None, (0, 1), encoder=sasrec_enc)
    sasrec_gates = os.path.join(root, "dp_gates_sasrec.pt")
    torch.save(sasrec_rec["gates"], sasrec_gates)
    del tr
    torch.cuda.empty_cache()
    ifwd, ibwd = inter_fwd_launches(), inter_bwd_launches()
    efwd, ebwd = fwd_launches(1), bwd_launches(1)
    # a step's table_grad launches: a rank's (its bs / DP_WORLD rows), one process's
    tgs = tg_step_launches(dp_experiment("", fp32=True), bs // DP_WORLD, world=DP_WORLD)
    tgs_one = tg_step_launches(dp_experiment("", fp32=True), bs)
    if sasrec_rec["enc_launches"] != (efwd, ebwd):
        raise SystemExit(f"phase 6h sasrec_step: the 1-process step launched the encoder "
                         f"{sasrec_rec['enc_launches']}, expected ({efwd}, {ebwd})")
    spec = {"inputs": inputs, "gates": gates, "sasrec_gates": sasrec_gates,
            "ckpt": os.path.join(root, "dp_ckpt")}
    # (a) and (b): two ranks on cuda:0 over gloo
    ranks = spawn_ranks(torch, dict(spec, name="gloo", backend="gloo",
                                    tasks=["step", "sasrec_step", "fit"]), DP_WORLD, root)
    ref = dp_reference(torch, fresh("gloo"), first, rec,
                       rank_codes(torch, [res["step"] for res in ranks]))
    worst = 0.0
    for r, res in enumerate(ranks):
        step = res["step"]
        if res["backend"] != "gloo" or step["launches"] != (ifwd, ibwd, tgs):
            raise SystemExit(f"phase 6h (a) rank {r}: backend {res['backend']}, interaction "
                             f"and table_grad launches {step['launches']}, expected ({ifwd}, "
                             f"{ibwd}, {tgs})")
        if step["row0"] != r * bs // DP_WORLD:
            raise SystemExit(f"phase 6h (a) rank {r}: first global row {step['row0']}")
        worst = max(worst, dp_check_step(
            torch, f"(a) rank {r} of {DP_WORLD}, {bs // DP_WORLD} rows, gloo", step, ref))
        log(f"[dp (a)] rank {r}: interaction and table_grad launches {step['launches']} (fwd "
            f"{ifwd} + bwd {ibwd}, table_grad {tgs}); collectives in the step "
            f"{step['stats']['calls']}, "
            f"{step['stats']['bytes']} bytes reduced")
    same = all(torch.equal(ranks[0]["step"][k][n], ranks[1]["step"][k][n])
               for k in ("params", "state") for n in ranks[0]["step"][k])
    log(f"[dp (a)] the two replicas after the step bit for bit equal: {same}")
    if not same or ranks[0]["step"]["loss"] != ranks[1]["step"]["loss"]:
        raise SystemExit("phase 6h (a): the ranks' replicas differ after the step")
    # (a) for sasrec_fibinet: net dropout 0.2, the encoder's 0.1, masks of the global batch
    sasrec_ref = dp_reference(torch, fresh("gloo_sasrec", "sasrec_fibinet"), first, sasrec_rec,
                              rank_codes(torch, [res["sasrec_step"] for res in ranks]),
                              encoder=[])
    for r, res in enumerate(ranks):
        step = res["sasrec_step"]
        if (step["launches"], step["enc_launches"]) != ((ifwd, ibwd, tgs), (efwd, ebwd)):
            raise SystemExit(f"phase 6h sasrec_step rank {r}: interaction and table_grad "
                             f"launches {step['launches']}, encoder {step['enc_launches']}, "
                             f"expected ({ifwd}, {ibwd}, {tgs}), ({efwd}, {ebwd})")
        if step["row0"] != r * bs // DP_WORLD:
            raise SystemExit(f"phase 6h sasrec_step rank {r}: first global row {step['row0']}")
        layers, decisions, flips, margin, gap = dp_encoder_decisions(
            torch, step["encoder"], sasrec_enc, r)
        log(f"[dp sasrec_step] rank {r}: the encoder kernels' FFN decisions ({layers} layer, "
            f"{decisions} at real tokens) against the 1 process's at the same tokens: {flips} "
            f"differ, within {margin:.2e} of 0 (GATE_MARGIN {GATE_MARGIN:g}); f1 max|d| "
            f"{gap:.2e}; launches interaction {step['launches']}, encoder "
            f"{step['enc_launches']} (fwd_launches(1) + bwd_launches(1))")
        if margin > GATE_MARGIN:
            raise SystemExit(f"phase 6h sasrec_step rank {r}: an encoder ReLU decision flipped "
                             f"beyond rounding")
        if gap != 0.0:  # the kernels are row-invariant (6h (d)): the same rows, the same f1
            raise SystemExit(f"phase 6h sasrec_step rank {r}: the encoder's f1 at real tokens "
                             f"differs from the 1 process's by {gap:.2e}")
        worst = max(worst, dp_check_step(
            torch, f"(a) sasrec_fibinet rank {r} of {DP_WORLD}, {bs // DP_WORLD} rows, gloo",
            step, sasrec_ref))
    same = all(torch.equal(ranks[0]["sasrec_step"][k][n], ranks[1]["sasrec_step"][k][n])
               for k in ("params", "state") for n in ranks[0]["sasrec_step"][k])
    log(f"[dp sasrec_step] the two replicas after the step bit for bit equal: {same}")
    if not same or ranks[0]["sasrec_step"]["loss"] != ranks[1]["sasrec_step"]["loss"]:
        raise SystemExit("phase 6h sasrec_step: the ranks' replicas differ after the step")
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
        if fit["launches"] != (ifwd * (steps + eval_batches), ibwd * steps, tgs * steps):
            raise SystemExit(f"phase 6h (b) rank {r}: interaction and table_grad launches "
                             f"{fit['launches']}")
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
    if nccl["backend"] != "nccl" or step["launches"] != (ifwd, ibwd, tgs_one) or \
            step["stats"]["calls"] < 1:
        raise SystemExit(f"phase 6h (c): backend {nccl['backend']}, launches {step['launches']}, "
                         f"collectives {step['stats']}")
    ref = dp_reference(torch, fresh("nccl"), first, rec, rank_codes(torch, [step]))
    worst = max(worst, dp_check_step(torch, "(c) 1 rank, NCCL", step, ref))
    log(f"[dp (c)] NCCL, world 1: {step['stats']['calls']} collectives, {step['stats']['bytes']} "
        f"bytes reduced in the step")
    log(f"[dp] phase 6h in {time.perf_counter() - t_phase:.1f} s")
    return {"grad_gap": worst, "best_auc": best,
            "fit": [res["fit"] for res in ranks],
            "tower_launches": sum(r["sasrec_step"]["tower_launches"] for r in ranks),
            "launches": {fn: sum(r["sasrec_step"][key][i] for r in ranks)
                         for fn, key, i in ((interaction_fwd, "launches", 0),
                                            (interaction_bwd, "launches", 1),
                                            (table_grad, "launches", 2),
                                            (encode_fwd, "enc_launches", 0),
                                            (encode_bwd, "enc_launches", 1))}}


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
    # the one-step probe on every rank, before the counted step: a leaf apart fails
    # at 1 x MP in the parent (a rank that raised would leave the others waiting in a
    # collective) and is logged at 2 x MP
    probe = repeat_probe(torch, tr, cols, f"6i {dp}x{tr.mesh.shape['model']} rank {rank}",
                         DP_DEVICE, hard=False)
    data_parallel.stats.update(calls=0, bytes=0)
    embedding.stats.update(dict.fromkeys(embedding.stats, 0))
    res = dp_step(torch, tr, cols, torch.load(spec["gates"]), (d, dp))
    res.pop("gates")
    res.update(row0=row0, coords=(d, tr.mesh.model_rank, dp, tr.mesh.shape["model"]),
               stats=dict(data_parallel.stats), exchange=dict(embedding.stats),
               sharded=sorted(tr._sharded), probe=probe)
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
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
    from ctr_recommendation_tpu_torch.parallel import data_parallel, embedding
    from ctr_recommendation_tpu_torch.training import Trainer

    import dataclasses

    bs = B_TRAIN
    exp = mp_experiment(spec["ckpt"] + "_mpfit", fp32=False)
    exp = exp.replace(train=dataclasses.replace(exp.train, epochs=spec["mp_epochs"]))
    tr = Trainer(exp, steps_per_epoch=N_TRAIN // bs, item_store=data["store"],
                 device=DP_DEVICE, log_fn=log if rank == 0 else (lambda s: None))
    torch.cuda.synchronize()
    interaction_fwd.launches = interaction_bwd.launches = table_grad.launches = 0
    data_parallel.stats.update(calls=0, bytes=0)
    embedding.stats.update(dict.fromkeys(embedding.stats, 0))
    t0 = time.perf_counter()
    hist = tr.fit_on_device(data["train"], data["valid"])
    torch.cuda.synchronize()
    res = {"hist": hist, "seconds": time.perf_counter() - t0,
           "launches": (interaction_fwd.launches, interaction_bwd.launches, table_grad.launches),
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
    def fresh(tag: str):
        return Trainer(mp_experiment(os.path.join(root, f"mp_ref_{tag}"), fp32=True,
                                     clip=MP_CLIP, mp=1),
                       steps_per_epoch=N_TRAIN // bs, item_store=store, device=DP_DEVICE,
                       log_fn=lambda s: None)

    def fresh_sparse(strategy: str, tag: str):
        return Trainer(mp_sparse_experiment(os.path.join(root, f"mp_sparse_{tag}_{strategy}"),
                                            mp=1),
                       steps_per_epoch=N_TRAIN // bs, item_store=store, device=DP_DEVICE,
                       log_fn=lambda s: None)

    # the 1-process step on the first 4096 rows with (a)'s clip, its gates
    # recorded; each layout's reference is this step again, taking the ranks'
    # tower decisions (dp_reference)
    first = {k: torch.as_tensor(v[:bs]).to(DP_DEVICE) for k, v in train.columns.items()}
    rec = dp_step(torch, fresh("rec"), first, None, (0, 1))
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.double().norm() for g in rec["grads"].values()])))
    log(f"[mp (a)] the 1-process step's global gradient norm {norm:.4e}, clipped to {MP_CLIP:g}")
    if not norm > MP_CLIP:
        raise SystemExit("phase 6i (a): the clip does not scale the step's gradients")
    gates = os.path.join(root, "mp_gates.pt")
    torch.save(rec["gates"], gates)
    # the sparse steps' 1-process steps, each strategy's gates recorded
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
    from ctr_recommendation_tpu_torch.training import sparse

    sparse_recs, sparse_gates = {}, {}
    default_ratio = sparse.GATHERED_MIN_VOCAB_RATIO
    try:
        for strategy, ratio in FORCE_STRATEGY.items():
            sparse.GATHERED_MIN_VOCAB_RATIO = ratio
            sparse_recs[strategy] = dp_step(torch, fresh_sparse(strategy, "rec"), first, None,
                                            (0, 1))
            sparse_gates[strategy] = os.path.join(root, f"mp_sparse_gates_{strategy}.pt")
            torch.save(sparse_recs[strategy]["gates"], sparse_gates[strategy])
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
        # a step's table_grad launches a rank: one call a feature on its data rank's rows
        tgs = tg_step_launches(mp_experiment("", fp32=True, mp=mp), bs // dp, world=dp)
        for r, res in enumerate(ranks):
            step = res["mp_step"]
            if res["backend"] != "gloo" or step["launches"] != (ifwd, ibwd, tgs) or \
                    tuple(step["coords"]) != (r // mp, r % mp, dp, mp) or \
                    step["row0"] != (r // mp) * bs // dp or (dp == 1 and step["probe"] != {}):
                raise SystemExit(f"phase 6i (a) {dp}x{mp} rank {r}: backend {res['backend']}, "
                                 f"launches {step['launches']}, coords {step['coords']}, first "
                                 f"row {step['row0']}, leaves apart in the probe "
                                 f"{step['probe']}")
            ex = step["exchange"]
            log(f"[mp (a)] {dp}x{mp} rank {r} (data rank {r // mp}, model rank {r % mp}): "
                f"interaction and table_grad launches {step['launches']} (fwd {ifwd} + bwd "
                f"{ibwd}, table_grad {tgs}); the one-step probe: leaves apart "
                f"{step['probe']}; the "
                f"exchange in the step: {ex['calls']} collectives, {ex['bytes']} bytes sent "
                f"({ex['row_bytes']} of rows), {ex['fallbacks']} fallbacks; other collectives "
                f"{step['stats']['calls']}, {step['stats']['bytes']} bytes; sharded "
                f"{step['sharded']}")
        apart = {r: res["mp_step"]["probe"] for r, res in enumerate(ranks)
                 if res["mp_step"]["probe"]}
        log(f"[mp (a)] {dp}x{mp}: the one-step probe on {dp * mp} ranks (the row-sharded "
            f"table_grad and the gloo all-reduce{'s' if dp > 1 else ''}), leaves apart "
            f"{apart or 'none'}{'' if dp == 1 else ' (logged)'}")
        assembled = mp_assemble(torch, ranks, dp, mp)
        agree = all(torch.equal(a, b) for r, res in enumerate(ranks)
                    for a, b in zip(res["mp_step"]["tower"], assembled[r // mp]["tower"]))
        log(f"[mp (a)] {dp}x{mp}: the tower kernels' decisions of each data group's model "
            f"ranks bit for bit equal: {agree}")
        ref = dp_reference(torch, fresh(f"{dp}x{mp}"), first, rec, rank_codes(torch, assembled))
        for d, got in enumerate(assembled):
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
            sparse_refs = {}
            try:
                for strategy, ratio in FORCE_STRATEGY.items():
                    sparse.GATHERED_MIN_VOCAB_RATIO = ratio
                    tr = fresh_sparse(strategy, "ref")
                    sref = dp_reference(torch, tr, first, sparse_recs[strategy],
                                        ranks[0]["mp_sparse"][strategy]["tower"])
                    sref["topt"] = {k: v.cpu().clone()
                                    for k, v in flatten(tr.state.table_opt_state).items()}
                    sparse_refs[strategy] = sref
                    del tr
            finally:
                sparse.GATHERED_MIN_VOCAB_RATIO = default_ratio
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
        tgs = tg_step_launches(mp_experiment("", fp32=False), bs)
        if fit["launches"] != (ifwd * (steps + eval_batches), ibwd * steps, tgs * steps):
            raise SystemExit(f"phase 6i (b) rank {r}: interaction and table_grad launches "
                             f"{fit['launches']}")
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
    train split: exact interaction, table_grad and tower launches over both
    epochs, state.step 2 epochs' steps, no metrics.csv, one trace whose hand-written kernels ran
    one epoch's launches. Profiles again (3 tries) when the trace holds no
    device event. Returns the launches of the run it keeps, and the tower
    blocks' in it."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        bwd_launches,
        fwd_launches,
        interaction_bwd,
        interaction_fwd,
    )
    from ctr_recommendation_tpu_torch.ops.cuda import tower
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
    from ctr_recommendation_tpu_torch.training import Trainer

    ckpt = os.path.join(root, "ckpt_profile")
    exp = microlens_experiment(data_root="", checkpoint_dir=ckpt)
    tgs, towers = tg_step_launches(exp), tower_step_launches(exp)
    steps = train.num_rows // exp.train.batch_size
    for attempt in range(3):
        log_dir = os.path.join(root, f"profile_{attempt}")
        tr = Trainer(exp, steps_per_epoch=steps, item_store=store, log_fn=log)
        for fn in (interaction_fwd, interaction_bwd, table_grad, *tower.BLOCKS):
            fn.launches = 0
        t0 = time.perf_counter()
        tr.profile_epoch(train, log_dir)
        took = time.perf_counter() - t0
        launches = {fn: fn.launches for fn in (interaction_fwd, interaction_bwd, table_grad)}
        tower_n = tower.launches()
        log(f"[profile] profile_epoch: {steps} steps x 2 epochs in {took:.2f} s (upload, the "
            f"untraced epoch, the traced one, the export); launches "
            f"{ {fn.__name__: n for fn, n in launches.items()} }, the tower blocks' {tower_n}; "
            f"state.step {tr.state.step}")
        if (tuple(launches.values()) != (2 * steps * fwd_launches(), 2 * steps * bwd_launches(),
                                         2 * steps * tgs) or tower_n != 2 * steps * towers):
            raise SystemExit("profile_epoch: the hand-written kernels' launches are off")
        if tr.state.step != 2 * steps:
            raise SystemExit(f"profile_epoch: state.step {tr.state.step}, expected {2 * steps}")
        if os.path.exists(os.path.join(ckpt, "metrics.csv")) or tr.history:
            raise SystemExit("profile_epoch wrote metrics.csv or history")
        files = os.listdir(log_dir)
        if files != ["rank0.pt.trace.json"]:
            raise SystemExit(f"profile_epoch: expected one trace file, found {files}")
        if trace_summary(os.path.join(log_dir, files[0]), card,
                         steps * (fwd_launches() + bwd_launches() + tgs + towers)):
            return launches, tower_n
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


def item_fields(n: int, seed: int) -> dict:
    """``n`` seeded items' Task-1 fields (item_feature.parquet's columns but
    the id): Zipf-distributed title words (2-12) and tags (0-4), random
    levels, 2% with no title and no tags (``blank``)."""
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
    titles, tag_lists, a, b = [], [], 0, 0
    for i in range(n):
        title, tg = " ".join(tw[a : a + nw[i]]), [str(t) for t in gw[b : b + ng[i]]]
        a, b = a + nw[i], b + ng[i]
        if blank[i]:
            title, tg = "", []
        titles.append(title)
        tag_lists.append(tg)
    return {"item_title": titles, "item_tags": tag_lists, "likes_level": levels[:, 0],
            "views_level": levels[:, 1], "blank": blank}


def item_texts(n: int, seed: int) -> list[str]:
    """``n`` seeded item texts in the Task-1 format, of item_fields' items."""
    from ctr_recommendation_tpu_torch.tools.item_embeddings import build_text

    f = item_fields(n, seed)
    return [build_text(t, g, int(lk), int(vw)) for t, g, lk, vw in
            zip(f["item_title"], f["item_tags"], f["likes_level"], f["views_level"])]


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


# ---- phase 7d: the entry point's forward (__graft_entry__.entry) on the port ----
ENTRY_ROWS = ((256, 0), (B_FULL, 1))  # (rows, fake_batch seed): the entry's batch, then 8192


@contextlib.contextmanager
def recorded_block(into: dict):
    """While open, record the interaction block's input x and output h as
    fibinet.apply computes them (the tower's input, as the forward uses it)."""
    from ctr_recommendation_tpu_torch.models import fibinet

    block = fibinet.senet_bilinear_concat

    def recording(senet_params, bilinear_params, x, **kw):
        into["x"] = x
        into["h"] = block(senet_params, bilinear_params, x, **kw)
        return into["h"]

    fibinet.senet_bilinear_concat = recording
    try:
        yield into
    finally:
        fibinet.senet_bilinear_concat = block


def entry_phase(torch, card, worst: dict, counted) -> int:
    """Phase 7d: the port's counterpart of the JAX repo's entry point
    (__graft_entry__.entry): microlens_experiment(use_pallas=True)'s
    MM-FiBiNET at full width from a seeded generator (seed 0), fake_batch
    rows (256 from seed 0, as the entry draws them, then 8192 from seed 1)
    through the bf16 eval forward and the sigmoid. Each forward: exactly
    fwd_launches() interaction_fwd launches and no other counted kernel; the
    block's output inside the forward against the kernel's plain version on
    the same x (TOL and FWD_NORM_TOL, as phase 2), the model's bf16
    reference block's gap beside it (reported: it rounds the gate and the
    output in bf16); the probabilities finite in (0, 1) and within CPU_TOL
    of the same forward on the CPU. Then both paths timed (CUDA events,
    median of 30) and the kernel path's device busy time split
    (torch.profiler). Returns the counted forwards' interaction_fwd launches."""
    import dataclasses

    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import fake_batch
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.models import build_model
    from ctr_recommendation_tpu_torch.ops.cuda import interaction as ki
    from ctr_recommendation_tpu_torch.ops.interaction import senet_bilinear_concat_reference
    from ctr_recommendation_tpu_torch.utils.tree import tree_map

    exp = microlens_experiment(data_root="", use_pallas=True)
    fm = build_feature_map(exp.dataset)
    cfg = exp.model
    module, params, state = build_model(fm, cfg, torch.Generator().manual_seed(0))
    seq_len = next(f.max_len for f in fm.features if f.name == "item_seq")
    widths = (cfg.model, cfg.embedding_dim, tuple(params["trunk"]["tables"]["item_id"].shape),
              seq_len, cfg.hidden_units, exp.train.compute_dtype)
    if widths != ("mm_fibinet", E, (91_776, E), 20, HIDDEN, "bfloat16"):
        raise SystemExit(f"the entry's configuration moved: {widths}")
    cd = getattr(torch, exp.train.compute_dtype)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    on_cpu = (params, state)
    on_card = (tree_map(lambda t: t.cuda(), params), tree_map(lambda t: t.cuda(), state))

    @torch.no_grad()
    def forward(weights, c, batch):
        logits, _ = module.apply(*weights, fm, c, batch, train=False, compute_dtype=cd)
        return torch.sigmoid(logits)

    launches, failures = 0, []
    for n, seed in ENTRY_ROWS:
        cols = fake_batch(np.random.default_rng(seed), n, 91718, 20, 128, with_label=False)
        batch = {k: torch.from_numpy(v).cuda() for k, v in cols.items()}
        torch.cuda.synchronize()
        for k in counted:
            k.launches = 0
        with recorded_block({}) as block:
            probs = forward(on_card, cfg, batch)
            torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in counted}
        want = {k.__name__: ki.fwd_launches() if k is ki.interaction_fwd else 0 for k in counted}
        launches += got["interaction_fwd"]
        x, h = block["x"], block["h"]
        w_bi = on_card[0]["bilinear"]["w"].to(x.dtype)
        sw = ki.senet_weights(on_card[0]["senet"], x.shape[1])
        plain = ki.interaction_fwd_plain(x, *sw, w_bi)
        err, bad, tol = check_close("interaction_fwd", h, plain, "bfloat16")
        norm = norm_gap(h, plain)
        worst["interaction_fwd"] = max(worst["interaction_fwd"], err)
        ref = senet_bilinear_concat_reference(on_card[0]["senet"], on_card[0]["bilinear"], x)
        ref_err, ref_norm = (h.double() - ref.double()).abs().max().item(), norm_gap(h, ref)
        cpu = forward(on_cpu, cfg, {k: torch.from_numpy(v) for k, v in cols.items()})
        probs = probs.cpu()
        cpu_err = (probs - cpu).abs().max().item()
        sane = (probs.shape == (n,) and bool(torch.isfinite(probs).all())
                and bool(((probs > 0) & (probs < 1)).all()))
        ok = (got == want and bad == 0 and norm <= FWD_NORM_TOL and cpu_err <= CPU_TOL
              and sane and tuple(h.shape) == (n, (F + F * (F - 1) // 2) * E))
        log(f"[entry] B={n}: launches {got} (expected {want}); the block's output in the "
            f"forward vs interaction_fwd_plain max_abs_err={err:.3e} ({tol}), |d|/|want| "
            f"{norm:.3e} (bar {FWD_NORM_TOL:.3e}); vs the bf16 reference block "
            f"max_abs_err={ref_err:.3e}, |d|/|want| {ref_norm:.3e} (reported); probabilities "
            f"{tuple(probs.shape)} in [{probs.min().item():.4f}, {probs.max().item():.4f}] vs "
            f"the CPU forward max_abs_err={cpu_err:.3e} (tolerance {CPU_TOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(n)
            continue
        kernel_ms = time_ms(torch, lambda: forward(on_card, cfg, batch))
        plain_ms = time_ms(torch, lambda: forward(on_card, plain_cfg, batch))
        gap = (forward(on_card, plain_cfg, batch).cpu() - probs).abs().max().item()
        log(f"[entry] B={n} on {card}: the bf16 eval forward + sigmoid {kernel_ms:.4f} ms on "
            f"the kernel path, {plain_ms:.4f} ms on the plain path (CUDA events around the "
            f"call, median of 30: the host's launches when the card waits on them, see the "
            f"[split] line's busy ms); the plain path's probabilities within {gap:.3e} of "
            f"the kernel's")
        kernel_split(torch, lambda: forward(on_card, cfg, batch), f"entry forward B={n}", card)
    if failures:
        raise SystemExit(f"the entry forward failed at B={failures}")
    return launches


# ---- phase 7e: the encoder at every S and E, E and towers off the kernels' multiples of 8 ----
LONG_S = 50  # SASRec's n for its sparse datasets (Kang & McAuley, ICDM 2018, section IV)
# 7e (b)'s train rows: half of phase 6's (a depth cut made to pay for phase 7f;
# at max_len 200 making phase 6's whole cut took 18 s of the host)
LONG_TRAIN = N_TRAIN // 2
# SASRec's MovieLens-1M setting (ibid., section IV-B): n = 200, d = 50, two
# self-attention blocks, one head, dropout 0.2
ML1M = dict(max_len=200, embedding_dim=50, attn_num_heads=1, attn_num_layers=2,
            attn_dropout=0.2)
OUTSIDE_E = 10  # an embedding width the interaction and scoring kernels take zero-padded
OUTSIDE_TOWER = (100, 50)  # a tower the scoring kernel takes zero-padded
WIDE_HEAD_E = 512  # with one head: a head width of 512, past what the CUDA-core attention took
# its history: the staged pair takes a head of 512 at S = 20, so LONG_S,
# where the shared memory of its backward cannot hold one and the streamed
# pair reads the head from device memory
WIDE_HEAD_LEN = LONG_S
B_LONG = 1024 + 37  # histories of phase 7e's cases past what shared memory holds
# (S, E, H, L, B) of the encoder checks past 32 keys: the streamed attention
# at S = 50, 100, 200 (SASRec's ML-1M shape at E = 50 padded to the
# kernels' widths) and 512, and at S = 50 with one head of 288 (read from
# device memory in chunks of 128 columns, the last one part full); the
# staged one at heads of 128 (S = 64)
LONG_CASES = [(LONG_S, 128, 2, 1, B_TRAIN), (LONG_S, 128, 2, 1, B_TRAIN + 37),
              (64, 256, 2, 1, B_TRAIN + 37), (100, 64, 2, 2, B_TRAIN + 37),
              (200, 128, 2, 1, B_LONG), (200, 50, 1, 2, B_LONG), (200, 50, 2, 2, B_LONG),
              (512, 64, 2, 1, B_LONG), (LONG_S, 288, 1, 1, B_LONG)]
# (S, E, H) of the attention blocks alone besides LONG_CASES': a history of
# one key tile (S = 20, the route's edge; both pairs) and a head of 512 in
# one key tile, which the streamed pair reads from device memory in chunks
ATTN_BLOCK_SHAPES = [(20, 128, 2), (20, 512, 1)]
FITS_S = range(1, 513)  # the grid the C and Python encoder predicates are held on
FITS_E = (1, 10, 16, 32, 48, 50, 64, 96, 100, 128, 160, 192, 256, 300, 384, 512, 1024)
FITS_H = (1, 2, 3, 4, 5, 8, 16, 32)
OUTSIDE_CPU_ROWS = 1024  # served rows held against the CPU Predictor in (b) and (c)
OUTSIDE_STEPS = 3  # train steps of each (c) case, on one batch
# 7e (c)'s chunked calls, (B, S, E, H, L), bf16: a forward of 9,000,000
# tokens, past MAX_TOKENS; a backward of 4,915,200 tokens at E = 256, whose
# whole-call workspace is more than the card holds
CHUNKED_FWD = (45_000, 200, 128, 2, 1)
CHUNKED_BWD = (24_576, 200, 256, 2, 1)
CHUNKED_PIECE = 4096  # rows of the whole calls the chunked ones are held against
CHUNKED_TOKEN0 = (1 << 32) - 4_000_000  # their token base: the Philox counter wraps mid-call
# (rows, batch_size) of sasrec_fibinet_ml1m's export through score_table:
# two batches of 65,536 x 200 = 13,107,200 tokens, each past MAX_TOKENS
CHUNKED_SERVE = (LONG_TRAIN, 65_536)
PEAK_SLACK = 1 << 30  # device memory a chunked call may take past its output and the budget


def long_attention_blocks(torch) -> tuple[float, list]:
    """Phase 7e (a): the attention blocks alone at each of LONG_CASES' (S,
    E, H) and ATTN_BLOCK_SHAPES, at the kernels' widths
    (padded_dims: E = 50 runs at 64) with the true D's scale, over B_TRAIN +
    37 histories (B_LONG past S = 128) of random pad lengths (row 0 all pad),
    bf16 and fp32: the streamed pair (tensor cores, 3xTF32) at every shape,
    and the staged pair too where the encoder takes it (attention_route).
    Staged: attention_fwd's ao and P against attention_fwd_plain's on the
    same qkv and mask, then attention_bwd on the plain version's P against
    attention_bwd_plain. Streamed: attention_fwd_streamed's ao, o and stats
    against attention_fwd_streamed_plain's, then attention_bwd_streamed on
    the plain version's o and stats against attention_bwd_streamed_plain.
    Every output within ENC_TOL (ENC_NORM_TOL in bf16; P, o, the stats and
    dqkv are fp32 and held at the fp32 bars; the running max m on the
    histories with a real key, as the -1e9 of an all-pad one would set the
    bar's scale); each launch's repeat bit-identical. The backward checks
    below take their forward residues from the kernels, so this holds those
    on their own. Returns (worst max_abs_err, failures)."""
    from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import padded_dims

    worst, failures = 0.0, []
    for s, e, heads in dict.fromkeys([c[:3] for c in LONG_CASES] + ATTN_BLOCK_SHAPES):
        b = B_TRAIN + 37 if s <= eb.MAX_S else B_LONG
        ep, dp = padded_dims(e, heads)
        routes = ("streamed", "staged") if eb.attention_route(s, dp) == "staged" else ("streamed",)
        att = dict(scale=1.0 / (e // heads) ** 0.5)
        gen = torch.Generator(device="cuda").manual_seed(s * 1000 + e)
        lens = torch.randint(0, s + 1, (b,), generator=gen, device="cuda")
        lens[0] = 0
        pad = torch.arange(s, device="cuda")[None, :] < (s - lens)[:, None]
        amask = torch.where(pad, -1e9, 0.0).float()
        real = ~pad.all(-1)
        qkv = torch.randn((b * s, 3 * ep), generator=gen, device="cuda")
        dao = torch.randn((b * s, ep), generator=gen, device="cuda")
        for route in routes:
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                if route == "staged":
                    fwd = lambda: eb.attention_fwd(qkv, amask, heads, dtype, **att)  # noqa: E731
                    want_f = eb.attention_fwd_plain(qkv, amask, heads, dtype, **att)
                    p_w = want_f[1]
                    bwd = lambda: eb.attention_bwd(qkv, p_w, dao, dtype, **att)  # noqa: E731
                    want_b = eb.attention_bwd_plain(qkv, p_w, dao, dtype, **att)
                    names = ("ao", "P")
                else:
                    fwd = lambda: eb.attention_fwd_streamed(qkv, amask, heads, dtype, **att)  # noqa
                    want_f = eb.attention_fwd_streamed_plain(qkv, amask, heads, dtype, **att)
                    _, o_w, st_w = want_f
                    bwd = lambda: eb.attention_bwd_streamed(  # noqa: E731
                        qkv, amask, o_w, st_w, dao, dtype, **att)
                    want_b = eb.attention_bwd_streamed_plain(qkv, amask, o_w, st_w, dao, dtype,
                                                             **att)
                got_f, got_b = fwd(), bwd()
                same = (all(torch.equal(a, c) for a, c in zip(got_f, fwd()))
                        and all(torch.equal(a, c) for a, c in zip(got_b, bwd())))
                torch.cuda.synchronize()
                if route == "streamed":  # the stats as m (real histories) and l
                    names = ("ao", "o", "m", "l")
                    got_f = (*got_f[:2], got_f[2][real][..., 0], got_f[2][..., 1])
                    want_f = (*want_f[:2], want_f[2][real][..., 0], want_f[2][..., 1])
                held = {name: (a, w, dn if name == "ao" else "float32")
                        for name, a, w in zip(names, got_f, want_f)}
                held.update({"dqkv": (got_b[0], want_b[0], "float32"),
                             "dqkv_c": (got_b[1], want_b[1], dn)})
                parts = []
                for name, (got, want, bar) in held.items():
                    err, rel_norm, ok = check_encoder(torch, got, want, bar)
                    worst = max(worst, err)
                    parts.append(f"{name} max_abs_err={err:.3e} |d|/|want| {rel_norm:.3e} "
                                 f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(("long attention block", route, name, s, e, heads, dn))
                if not same:
                    failures.append(("long attention block repeat", route, s, e, heads, dn))
                log(f"[long compare] attention blocks, {route}, S={s} E={e} H={heads} (kernels "
                    f"at E={ep}, D={dp}) {dn} B={b}: {'; '.join(parts)}; repeats bit-identical "
                    f"{same}")
                del got_f, got_b, want_f, want_b
    return worst, failures


def padded_interaction_against_plain(torch) -> tuple[float, float, list]:
    """Phase 7e (c): the interaction entry point at E = OUTSIDE_E, which
    the kernels take zero-padded to padded_width(E): fused_senet_bilinear_
    concat's output (B_RAGGED rows) against interaction_fwd_plain at the
    unpadded E within TOL["interaction_fwd"] (FWD_NORM_TOL in bf16), and
    its gradients through FusedInteraction (B_TRAIN + 37 rows) against
    interaction_bwd_plain at the unpadded E within BWD_TOL (BWD_NORM_TOL in
    bf16); "all" and "each", bf16 and fp32. Returns (worst forward
    max_abs_err, worst backward max_abs_err, failures)."""
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        fused_senet_bilinear_concat,
        interaction_bwd_plain,
        interaction_fwd_plain,
        padded_width,
    )

    worst_f, worst_b, failures = 0.0, 0.0, []
    for btype in ("all", "each"):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            tag = f"E={OUTSIDE_E} (kernels at {padded_width(OUTSIDE_E)}) {btype} {dn}"
            x, sw, w_bi, _ = kernel_inputs(torch, btype, dtype, B_RAGGED, OUTSIDE_E, e=OUTSIDE_E,
                                           hidden=(8, 8))
            sp = {"fc1": {"w": sw[0], "b": sw[1]}, "fc2": {"w": sw[2], "b": sw[3]}}
            bp = {"w" if btype == "all" else "w_each": w_bi.float()}
            got = fused_senet_bilinear_concat(sp, bp, x, bilinear_type=btype)
            want = interaction_fwd_plain(x, *sw, w_bi, bilinear_type=btype)
            torch.cuda.synchronize()
            err, bad, bar = check_close("interaction_fwd", got, want, dn)
            rel_norm = norm_gap(got, want)
            ok = bad == 0 and got.shape == want.shape and (
                dtype != torch.bfloat16 or rel_norm <= FWD_NORM_TOL)
            worst_f = max(worst_f, err)
            g, xb, swb, wb = backward_inputs(torch, btype, dtype, B_TRAIN + 37, OUTSIDE_E + 1,
                                             True, e=OUTSIDE_E)
            leaves = [xb.clone().requires_grad_()] + [t.clone().requires_grad_() for t in swb]
            w_master = wb.float().requires_grad_()
            out = fused_senet_bilinear_concat(
                {"fc1": {"w": leaves[1], "b": leaves[2]}, "fc2": {"w": leaves[3], "b": leaves[4]}},
                {"w" if btype == "all" else "w_each": w_master}, leaves[0], bilinear_type=btype)
            grads = torch.autograd.grad(out, leaves + [w_master], g)
            want_b = interaction_bwd_plain(g, xb, *swb, wb, bilinear_type=btype)
            torch.cuda.synchronize()
            b_err, b_norm, b_bad = check_backward(torch, grads, want_b, dn)
            worst_b = max(worst_b, b_err)
            log(f"[padded compare] interaction {tag}: forward B={B_RAGGED} max_abs_err={err:.3e} "
                f"({bar}, {bad} outside), |d|/|want| {rel_norm:.3e} (bf16 bar "
                f"{FWD_NORM_TOL:.3e}); backward B={B_TRAIN + 37} max_abs_err={b_err:.3e}, "
                f"|d|/|want| up to {b_norm:.3e}, outside BWD_TOL {b_bad} "
                f"{'ok' if ok and not b_bad else 'FAIL'}")
            if not ok or b_bad:
                failures.append(("padded interaction", btype, dn, bad, b_bad))
    return worst_f, worst_b, failures


def long_history_against_plain(torch) -> tuple[float, float, list]:
    """Phase 7e (a): the encoder kernels at LONG_CASES (S = 50, 64 and 100:
    two and four keys a lane, staged; S = 200 and 512 streamed, and E = 50
    with H = 1 and 2, which they run zero-padded to E = 64) against their
    plain versions at the true widths, bf16 and fp32: the forward
    within ENC_TOL (ENC_NORM_TOL in bf16, the jnp rounding points rejected),
    pad rows of fused_encode exactly 0, with dropout 0.1 under two seeds;
    the backward at rate 0 and 0.1 against encode_bwd_plain on the kernels'
    own forward residues (kernel_layers, at the kernels' widths and cut
    back: padded=True) within ENC_BWD_TOL, its norm and
    gate-free bars (the fp32-operand control, on the same residues,
    rejected in bf16 at rate 0.1, where dropout takes df2 off the bf16
    grid; at rate 0 g and f1 are in cd already and the gate-free output
    cannot tell), and against encode_bwd_plain's own recompute within
    the norm bar: with 2.5-5x phase 2's tokens a ReLU gate flips between
    two recomputes in most fp32 cases, and the bf16 rounding drift of two
    recomputes over two layers reaches the gate-free bar, neither the
    backward's doing; every repeat bit-identical and the launches exactly
    fwd_launches(L) and bwd_launches(L) a call. Returns (worst forward
    max_abs_err, worst backward max_abs_err, failures)."""
    from ctr_recommendation_tpu_torch.ops import attention
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        bwd_launches,
        encode_bwd,
        encode_bwd_plain,
        encode_fwd,
        encode_fwd_plain,
        fits,
        fused_encode,
        fwd_launches,
    )

    worst_f, worst_b, failures = 0.0, 0.0, []
    for s, e, heads, layers, b in LONG_CASES:
        if not fits(s, e, heads, layers):
            raise SystemExit(f"phase 7e's case S={s} E={e} H={heads} L={layers} is outside")
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            tag = f"S={s} E={e} H={heads} L={layers} {dn} B={b}"
            x, amask, pad, ws, params, seq_emb, ids = encoder_case(
                torch, dtype, b, e, heads, layers, seed=s + e + b, s=s, on_card=True)
            encode_fwd.launches = encode_bwd.launches = 0
            got = encode_fwd(x, amask, *ws, num_heads=heads)
            same = torch.equal(got, encode_fwd(x, amask, *ws, num_heads=heads))
            fused = fused_encode(params, seq_emb, ids, num_heads=heads)
            want = encode_fwd_plain(x, amask, *ws, num_heads=heads)
            torch.cuda.synchronize()
            err, rel_norm, ok = check_encoder(torch, got, want, dn)
            zeroed = torch.where(pad[..., None], torch.zeros((), dtype=dtype, device="cuda"), got)
            pads_zero = bool((fused[pad] == 0).all()) and torch.equal(fused, zeroed)
            ok = ok and same and pads_zero
            control = ""
            if dtype == torch.bfloat16:
                ctl = attention.encode(params, seq_emb, ids, num_heads=heads)
                _, c_norm, _ = check_encoder(torch, zeroed, ctl, dn)
                ok = ok and c_norm > ENC_NORM_TOL
                control = (f"; jnp-rounding control |d|/|want| {c_norm:.3e} "
                           f"{'rejected' if c_norm > ENC_NORM_TOL else 'NOT REJECTED'}")
            worst_f = max(worst_f, err)
            drops = []
            for seed_v in (b + s, 2**40 + b + s):
                seed = torch.tensor([seed_v], dtype=torch.int64, device="cuda")
                kw = dict(num_heads=heads, seed=seed, rate=DROP_RATE)
                got_d = encode_fwd(x, amask, *ws, **kw)
                same_d = torch.equal(got_d, encode_fwd(x, amask, *ws, **kw))
                d_err, d_norm, d_ok = check_encoder(torch, got_d, encode_fwd_plain(
                    x, amask, *ws, **kw), dn)
                moved = (got_d.float() - got.float()).abs().max().item()
                ok = ok and d_ok and same_d and moved > 1e-2
                worst_f = max(worst_f, d_err)
                drops.append(f"seed {seed_v}: max_abs_err={d_err:.3e}, |d|/|want| {d_norm:.3e}, "
                             f"repeat bit-identical {same_d}")
            log(f"[long compare] sasrec_encoder_fwd {tag}: max_abs_err={err:.3e}, |d|/|want| "
                f"{rel_norm:.3e} (bf16 bar {ENC_NORM_TOL:.3e}), repeat bit-identical {same}, pad "
                f"rows of fused_encode exactly 0: {pads_zero}{control}; dropout {DROP_RATE}: "
                f"{drops} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("long sasrec_encoder_fwd", s, e, heads, layers, dn, b))
            g = encoder_cotangent(torch, pad, e, s + b + 3, dtype, on_card=True)
            for rate in (0.0, DROP_RATE):
                seed = torch.tensor([b * 7 + s], dtype=torch.int64, device="cuda")
                kw = dict(num_heads=heads, seed=seed, rate=rate)
                got_b = encode_bwd(g, x, amask, *ws, **kw)
                same_b = all(torch.equal(a, c) for a, c in zip(
                    got_b, encode_bwd(g, x, amask, *ws, **kw)))
                with plain_layers(kernel_layers(torch)):  # at the kernels' widths
                    want_b = encode_bwd_plain(g, x, amask, *ws, **kw, padded=True)
                    wrong = (encode_bwd_plain(g, x, amask, *ws, **kw, fp32_operands=True,
                                              padded=True)
                             if dtype == torch.bfloat16 else None)
                whole = encode_bwd_plain(g, x, amask, *ws, **kw)
                torch.cuda.synchronize()
                b_err, b_norm, free, bad = check_encoder_bwd(torch, got_b, want_b, dn)
                w_err, w_norm, w_free, w_bad = check_encoder_bwd(torch, got_b, whole, dn)
                worst_b = max(worst_b, b_err)
                ok_b = same_b and not bad and w_norm <= ENC_BWD_NORM_TOL[dn]
                control = ""
                if wrong is not None:  # held at rate 0.1: at 0, g and f1 are already in cd
                    _, c_norm, c_free, c_bad = check_encoder_bwd(torch, got_b, wrong, dn)
                    ok_b = ok_b and (bool(c_bad) or rate == 0.0)
                    control = (f"; fp32-operand control on the same residues gate-free "
                               f"{c_free:.3e}, {'rejected' if c_bad else 'not rejected'} on "
                               f"{c_bad}{'' if rate else ' (held at rate 0.1 only)'}")
                log(f"[long compare] sasrec_encoder_bwd {tag} rate={rate}, on the kernels' "
                    f"forward residues: max_abs_err={b_err:.3e}, |d|/|want| up to {b_norm:.3e} "
                    f"(bar {ENC_BWD_NORM_TOL[dn]:.3e}), gate-free {free:.3e} (bar "
                    f"{ENC_BWD_GATE_FREE_TOL[dn]:.3e}), repeat bit-identical {same_b}{control}; "
                    f"against the plain version's own recompute |d|/|want| up to {w_norm:.3e} "
                    f"(held to the same norm bar), max_abs_err={w_err:.3e}, gate-free "
                    f"{w_free:.3e}, outside the elementwise and gate-free bars {w_bad} (ReLU "
                    f"gate flips and rounding drift of two recomputes: not held) "
                    f"{'ok' if ok_b else f'FAIL {bad}'}")
                if not ok_b:
                    failures.append(("long sasrec_encoder_bwd", s, e, heads, layers, dn, b, rate))
            counts = (encode_fwd.launches, encode_bwd.launches)
            want_counts = (7 * fwd_launches(layers), 4 * bwd_launches(layers))
            log(f"[long compare] {tag}: launches (encode_fwd, encode_bwd) {counts}, expected "
                f"{want_counts} (7 forward and 4 backward calls)")
            if counts != want_counts:
                failures.append(("long launches", s, e, dn, b, counts))
    return worst_f, worst_b, failures


def fits_grid(torch) -> None:
    """Phase 7e (a): the C predicate (sasrec_encoder_fits, the kernels'
    in_envelope) against the Python one (sasrec_encoder.fits) on every
    point of FITS_S x FITS_E x FITS_H x L in (1, 2); at every (S, E, H)
    inside, the C widths (sasrec_encoder_widths) against padded_dims and
    the C attention route (sasrec_attention_staged) against
    attention_route."""
    from ctr_recommendation_tpu_torch.ops.cuda.encoder_blocks import attention_route
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import fits, fwd_lib, padded_dims

    lib = fwd_lib()
    points, inside, apart = 0, 0, []
    for s in FITS_S:
        for e in FITS_E:
            for h in FITS_H:
                for layers in (1, 2):
                    c, py = bool(lib.sasrec_encoder_fits(s, e, h, layers)), fits(s, e, h, layers)
                    points += 1
                    inside += py
                    if c != py:
                        apart.append((s, e, h, layers, c, py))
                if not fits(s, e, h, 1):
                    continue
                ep, dp = padded_dims(e, h)
                c_staged = bool(lib.sasrec_attention_staged(s, e, h))
                if (lib.sasrec_encoder_widths(e, h) != ep * 1024 + dp
                        or c_staged != (attention_route(s, dp) == "staged")):
                    apart.append(("widths or route", s, e, h, lib.sasrec_encoder_widths(e, h),
                                  (ep, dp), c_staged))
    largest = {d: max((s for s in FITS_S if attention_route(s, d) == "staged"), default=0)
               for d in (32, 64, 128, 256)}
    refused = sorted({(e, h) for e in FITS_E for h in FITS_H if not fits(1, e, h, 1)})
    log(f"[long fits] sasrec_encoder_fits (C) vs sasrec_encoder.fits (Python) on {points} "
        f"points (S 1..{FITS_S[-1]} x E {FITS_E} x H {FITS_H} x L 1, 2), with the widths and "
        f"the attention's route where inside: {inside} inside, {len(apart)} apart "
        f"{apart[:5]}; (E, H) refused at every S: {refused} (E % H != 0); the "
        f"largest S the staged attention takes at each head width D (the streamed past it): "
        f"{largest}")
    if apart or not inside:
        raise SystemExit(f"the C and Python encoder predicates disagree: {apart[:10]}")


# the grid the C and Python workspace functions are held on (the chunk
# planner reads the Python ones), besides the (B, S, E, H, L) of phase 7e
# (c)'s chunked calls, their chunks and the whole calls of (b)
WS_B = (1, 3, 37, 1061, 4133)
WS_S = (1, 7, 19, 20, 21, 50, 64, 100, 200, 512)
WS_E = (10, 32, 50, 64, 128, 256, 288, 512)
WS_H = (1, 2, 4)


def workspace_grid(torch) -> None:
    """Phase 2: the encoder's workspace sizes as the chunk planner reads
    them in Python (sasrec_encoder.fwd_workspace, bwd_workspace) against the
    C sasrec_encode_fwd_workspace / sasrec_encode_bwd_workspace on every
    point of WS_B x WS_S x WS_E x WS_H (E % H == 0) x L 1..3 x bf16 and fp32,
    and at phase 7e (c)'s chunked shapes, whole and a chunk; every byte
    equal. Logs WORKSPACE_BUDGET beside the largest chunk of each."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        MAX_TOKENS,
        WORKSPACE_BUDGET,
        bwd_lib,
        bwd_workspace,
        fwd_lib,
        fwd_workspace,
        plan_chunks,
    )

    fl, bl = fwd_lib(), bwd_lib()
    shapes = [(b, s, e, h, layers) for b in WS_B for s in WS_S for e in WS_E for h in WS_H
              for layers in (1, 2, 3) if e % h == 0]
    plans = []
    for (b, s, e, h, layers), direction in ((CHUNKED_FWD, "fwd"), (CHUNKED_BWD, "bwd"),
                                            (chunked_serve_shape(), "fwd")):
        plan = plan_chunks(b, s, e, h, layers, torch.bfloat16, direction)
        rows = plan[0][1]
        size = (fwd_workspace(rows, s, e, h, True) if direction == "fwd"
                else bwd_workspace(rows, s, e, h, layers, True))
        plans.append(f"{direction} B={b} S={s} E={e} H={h} L={layers}: {len(plan)} chunks of "
                     f"{rows} rows, {size} bytes a chunk")
        shapes.append((rows, s, e, h, layers))
        if b * s <= MAX_TOKENS:  # the C backward's whole-call size, inside the grid rows
            shapes.append((b, s, e, h, layers))
    points, apart = 0, []
    for b, s, e, h, layers in shapes:
        for bf16 in (0, 1):
            want = (fl.sasrec_encode_fwd_workspace(b, s, e, h, bf16),
                    bl.sasrec_encode_bwd_workspace(b, s, e, h, layers, bf16))
            got = (fwd_workspace(b, s, e, h, bf16), bwd_workspace(b, s, e, h, layers, bf16))
            points += 1
            if got != want:
                apart.append(((b, s, e, h, layers, bf16), got, want))
    log(f"[ws grid] fwd_workspace / bwd_workspace (Python, the chunk planner's) vs the C "
        f"workspace functions on {points} points (B {WS_B} x S {WS_S} x E {WS_E} x H {WS_H} x "
        f"L 1..3 x bf16, fp32, and phase 7e (c)'s shapes): {len(apart)} apart {apart[:3]}; "
        f"WORKSPACE_BUDGET {WORKSPACE_BUDGET} bytes; 7e (c)'s plans, bf16: " + "; ".join(plans))
    if apart or not points:
        raise SystemExit(f"the C and Python encoder workspace functions disagree: {apart[:10]}")


def spy_plans(torch) -> dict:
    """Wrap sasrec_encoder.plan_chunks, which both encoder wrappers read at
    every call, with a recorder: while ``spied["on"]`` each plan's shape,
    its chunks and the whole call's workspace (the Python workspace
    functions, which phase 2 holds equal to the C ones) are kept, so that
    phase 8 shows every call outside 7e (c)'s chunked cases was one chunk,
    and its largest workspace beside WORKSPACE_BUDGET. Calls in the ranks of
    6h and 6i (processes of their own) are not seen."""
    from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc

    real = enc.plan_chunks
    spied = {"on": True, "calls": 0, "chunked": [], "largest": {}}

    def plan_chunks(b, s, e, num_heads, layers, dtype, direction):
        plan = real(b, s, e, num_heads, layers, dtype, direction)
        if spied["on"]:
            bf16 = dtype == torch.bfloat16
            size = (enc.fwd_workspace(b, s, e, num_heads, bf16) if direction == "fwd"
                    else enc.bwd_workspace(b, s, e, num_heads, layers, bf16))
            spied["calls"] += 1
            if len(plan) > 1:
                spied["chunked"].append((b, s, e, num_heads, layers, str(dtype), direction))
            if size > spied["largest"].get(direction, (0,))[0]:
                spied["largest"][direction] = (size, (b, s, e, num_heads, layers, str(dtype)))
        return plan

    enc.plan_chunks = plan_chunks
    return spied


def report_plans(spied: dict, card) -> None:
    """Phase 8: spy_plans' record. Fails if a call outside 7e (c)'s chunked
    cases planned more than one chunk."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import WORKSPACE_BUDGET

    ok = not spied["chunked"] and spied["calls"] > 0
    log(f"[chunked budget] {spied['calls']} encoder plans outside 7e (c)'s chunked cases (this "
        f"process's calls, CPU and card), {len(spied['chunked'])} of more than one chunk "
        f"{spied['chunked'][:5]}; the largest whole-call workspace: "
        + ", ".join(f"{d} {n} bytes at (B, S, E, H, L, dtype) {shape}"
                    for d, (n, shape) in sorted(spied["largest"].items()))
        + f"; WORKSPACE_BUDGET {WORKSPACE_BUDGET} bytes on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("an encoder call outside phase 7e (c)'s chunked cases was chunked")


def long_history_phase(torch, root, card, counted, tag: str, model_kw: dict,
                       layers: int = 1) -> dict:
    """Phase 7e (b): sasrec_fibinet with ``model_kw`` over its defaults
    (max_len 50; SASRec's ML-1M setting, ML1M), full width (tower (512,
    256), bf16) on LONG_TRAIN train rows and phase 6's valid rows made at
    that max_len, through the
    train-and-serve checks (gradients kernel vs plain, exact launches of the
    four training kernels, loss falling, best valid AUC > 0.6, the export
    through evaluate); then the export through Predictor.score_table on the
    fused scoring kernel: its AUC within AUC_SERVE_TOL of evaluate's and its
    first OUTSIDE_CPU_ROWS probabilities within CPU_TOL of the same
    Predictor on the CPU. Returns the launches of each counted wrapper in
    the fit and the serve, the serving Predictor and the train rows."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import TableData, synthetic_splits
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import bwd_launches as ibwd_n
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import fwd_launches as ifwd_n
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        bwd_launches,
        encode_bwd,
        encode_fwd,
        fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.training.checkpoint import CheckpointManager
    from ctr_recommendation_tpu_torch.training.metrics import auc

    max_len = model_kw["max_len"]
    t0 = time.perf_counter()
    train, valid, store = synthetic_splits(LONG_TRAIN, N_VALID, seed=0, max_len=max_len)
    log(f"[long] synthetic data at max_len {max_len}: {LONG_TRAIN} train + {N_VALID} valid rows "
        f"made in {time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(root, f"ckpt_{tag}")
    exp = microlens_experiment(data_root="", model="sasrec_fibinet", epochs=TRAIN_EPOCHS,
                               checkpoint_dir=ckpt, use_pallas=True, **model_kw)
    m = exp.model
    if (m.hidden_units, m.attn_num_layers, exp.train.compute_dtype, exp.train.batch_size) != (
            HIDDEN, layers, "bfloat16", B_TRAIN):
        raise SystemExit(f"sasrec_fibinet's defaults moved: {m}")
    ef, eb, fi, bi = fwd_launches(layers), bwd_launches(layers), ifwd_n(), ibwd_n()
    res = train_and_serve(
        torch, exp, train, valid, store, root, card, counted,
        per_step={interaction_fwd: fi, interaction_bwd: bi, encode_fwd: ef, encode_bwd: eb,
                  table_grad: tg_step_launches(exp)},
        per_eval={interaction_fwd: fi, encode_fwd: ef},
        per_serve={score_fwd: score_launches(), encode_fwd: ef}, tag=tag)
    server = res["server"]
    for fn in counted:
        fn.launches = 0
    probs = server.score_table(valid, B_FULL)
    torch.cuda.synchronize()
    n_batches = -(-N_VALID // B_FULL)
    served = {fn: fn.launches for fn in counted}
    want = {fn: 0 for fn in counted}
    want.update({score_fwd: n_batches * score_launches(), encode_fwd: n_batches * ef})
    table_auc = auc(torch.from_numpy(valid.columns["label"]), torch.from_numpy(probs)).item()
    params, state = jax_bridge.params_from_jax(
        *jax_bridge.load(CheckpointManager(ckpt).best_export_path), server.fm, exp.model)
    head = TableData({k: v[:OUTSIDE_CPU_ROWS] for k, v in valid.columns.items()},
                     OUTSIDE_CPU_ROWS)
    cpu = Predictor(exp, params, state, item_store=store, device="cpu").score_table(
        head, OUTSIDE_CPU_ROWS)
    cpu_err = float(np.abs(cpu - probs[:OUTSIDE_CPU_ROWS]).max())
    names = lambda d: {fn.__name__: n for fn, n in d.items()}  # noqa: E731
    ok = (served == want and abs(table_auc - res["served_auc"]) <= AUC_SERVE_TOL
          and cpu_err <= CPU_TOL and server.use_fused and probs.shape == (N_VALID,))
    log(f"[long serve] {tag} (max_len {max_len}, E={m.embedding_dim}, H={m.attn_num_heads}, "
        f"L={layers}): score_table on the valid split's {N_VALID} rows, AUC {table_auc:.7f} vs "
        f"evaluate's {res['served_auc']:.7f} (tolerance {AUC_SERVE_TOL}); launches "
        f"{names(served)} (expected {names(want)}); the first {OUTSIDE_CPU_ROWS} rows vs the CPU "
        f"Predictor max_abs_err={cpu_err:.3e} (tolerance {CPU_TOL}) on {card} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{tag}: the served export failed")
    return {fn: res["launches"][fn] + served[fn] for fn in counted}, server, train


def outside_case(torch, tag: str, exp, train, valid, store, card, counted,
                 launches: dict, kind: str = "padded") -> None:
    """Phase 7e (c), one model at a shape its kernels take zero-padded (or,
    ``kind``, past what their first designs took): OUTSIDE_STEPS train
    steps on one batch (loss finite), one eval forward
    (Trainer.predict) of B_FULL rows, and a serve of 2 x B_FULL rows
    (Predictor.score_table) of the trained weights. ``launches`` maps
    "step", "eval" and "serve" to each counted wrapper's launches a step,
    an eval forward and a serving batch; the run must show exactly those.
    The served probabilities' first OUTSIDE_CPU_ROWS within CPU_TOL of the
    same Predictor on the CPU."""
    from ctr_recommendation_tpu_torch.data import TableData
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.training import Trainer
    from ctr_recommendation_tpu_torch.utils.tree import tree_map

    tr = Trainer(exp, steps_per_epoch=OUTSIDE_STEPS, item_store=store, log_fn=lambda s: None)
    bs = exp.train.batch_size
    batch = {k: torch.as_tensor(v[:bs]).cuda() for k, v in train.columns.items()}
    rows = {k: v[:2 * B_FULL] for k, v in valid.columns.items()}
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    losses = [tr.train_step(batch).item() for _ in range(OUTSIDE_STEPS)]
    evaluated = tr.predict([{k: v[:B_FULL] for k, v in rows.items()}])
    params = tree_map(lambda t: t.detach().cpu(), tr.state.params)
    state = tree_map(lambda t: t.detach().cpu(), tr.state.model_state)
    pred = Predictor(exp, params, state, item_store=store)
    served = pred.score_table(TableData(rows, 2 * B_FULL), B_FULL)
    torch.cuda.synchronize()
    calls = {"step": OUTSIDE_STEPS, "eval": 1, "serve": 2}
    got_l = {fn.__name__: fn.launches for fn in counted}
    want_l = {fn.__name__: sum(calls[k] * launches[k].get(fn, 0) for k in calls)
              for fn in counted}
    head = TableData({k: v[:OUTSIDE_CPU_ROWS] for k, v in rows.items()}, OUTSIDE_CPU_ROWS)
    cpu = Predictor(exp, params, state, item_store=store, device="cpu").score_table(
        head, OUTSIDE_CPU_ROWS)
    cpu_err = float(np.abs(cpu - served[:OUTSIDE_CPU_ROWS]).max())
    sane = (np.isfinite(losses).all() and evaluated.shape == (B_FULL,)
            and np.isfinite(evaluated).all() and served.shape == (2 * B_FULL,)
            and bool(((served > 0) & (served < 1)).all()))
    ok = got_l == want_l and cpu_err <= CPU_TOL and sane and pred.use_fused
    log(f"[{kind} {tag}] {OUTSIDE_STEPS} steps (losses {[round(v, 5) for v in losses]}), an "
        f"eval forward of {B_FULL} rows, {2 * B_FULL} rows served (fused scoring "
        f"{pred.use_fused}): launches {got_l} (expected {want_l}); the first "
        f"{OUTSIDE_CPU_ROWS} served rows vs the CPU Predictor max_abs_err={cpu_err:.3e} "
        f"(tolerance {CPU_TOL}) on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 7e (c) {tag} failed")


def chunked_serve_shape() -> tuple:
    """(B, S, E, H, L) of the encoder call a batch of CHUNKED_SERVE makes."""
    return (CHUNKED_SERVE[1], ML1M["max_len"], ML1M["embedding_dim"], ML1M["attn_num_heads"],
            ML1M["attn_num_layers"])


def chunk_pieces(plan, b: int) -> list[tuple]:
    """Row ranges of CHUNKED_PIECE rows a chunked call is held against:
    the first rows, one straddling each chunk boundary, the last rows."""
    half = CHUNKED_PIECE // 2
    return ([(0, CHUNKED_PIECE)] + [(r1 - half, r1 + half) for _, r1 in plan[:-1]]
            + [(b - CHUNKED_PIECE, b)])


def timed(torch, fn):
    """(fn's result, its ms by CUDA events), one run."""
    a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    z.record()
    z.synchronize()
    return out, a.elapsed_time(z)


def chunked_forward(torch, card, counted) -> dict:
    """Phase 7e (c) (a): encode_fwd on CHUNKED_FWD, 9,000,000 tokens past
    MAX_TOKENS, bf16, rate 0.1 and 0, at CHUNKED_TOKEN0, in the chunks of
    plan_chunks: the repeat bit-identical, exactly call_launches' launches
    a call, finite, the rise of max_memory_allocated over the first call
    within the output + WORKSPACE_BUDGET + PEAK_SLACK, and the rows of each
    chunk_pieces range bit for bit a whole call of those rows at its own
    token base. Logs the call's ms and tokens/s beside a one-chunk call of
    B_FULL rows at the same S. Returns the counted launches of the chunked
    calls."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        WORKSPACE_BUDGET,
        call_launches,
        encode_fwd,
        plan_chunks,
    )

    b, s, e, heads, layers = CHUNKED_FWD
    dt = torch.bfloat16
    x, amask, _, ws, _, _, _ = encoder_case(torch, dt, b, e, heads, layers, 41, s=s, on_card=True)
    plan = plan_chunks(b, s, e, heads, layers, dt, "fwd")
    per_call = call_launches(b, s, e, heads, layers, dt, "fwd")
    seed = torch.tensor([43], dtype=torch.int64, device="cuda")
    launched = {fn: 0 for fn in counted}
    failed = []
    for rate in (DROP_RATE, 0.0):
        kw = dict(num_heads=heads, seed=seed, rate=rate)
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = encode_fwd(x, amask, *ws, **kw, token0=CHUNKED_TOKEN0)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - before
        again, ms = timed(torch, lambda: encode_fwd(x, amask, *ws, **kw, token0=CHUNKED_TOKEN0))
        got_l = {fn.__name__: fn.launches for fn in counted}
        for fn in counted:
            launched[fn] += fn.launches
        want_l = {fn.__name__: 2 * per_call * (fn is encode_fwd) for fn in counted}
        same = torch.equal(out, again)
        del again
        pieces = [torch.equal(encode_fwd(x[r0:r1], amask[r0:r1], *ws, **kw,
                                         token0=CHUNKED_TOKEN0 + r0 * s), out[r0:r1])
                  for r0, r1 in chunk_pieces(plan, b)]
        limit = out.numel() * out.element_size() + WORKSPACE_BUDGET + PEAK_SLACK
        finite = bool(torch.isfinite(out).all())
        ok = (same and all(pieces) and got_l == want_l and rise <= limit and finite
              and len(plan) >= 2)
        del out
        one_ms = time_ms(torch, lambda: encode_fwd(x[:B_FULL], amask[:B_FULL], *ws, **kw), reps=5)
        log(f"[chunked forward] B={b} S={s} E={e} H={heads} L={layers} bf16 rate {rate}: "
            f"{b * s} tokens in {len(plan)} chunks {plan}, token base {CHUNKED_TOKEN0}; "
            f"{ms:.3f} ms = {b * s / ms * 1e3:.0f} tokens/s (one chunk of B={B_FULL} at this S, "
            f"median of 5: "
            f"{one_ms:.3f} ms = {B_FULL * s / one_ms * 1e3:.0f} tokens/s); repeat bit-identical "
            f"{same}; {len(pieces)} whole calls of {CHUNKED_PIECE} rows (first, across each "
            f"boundary, last) bit for bit {pieces}; finite {finite}; launches {got_l} (expected "
            f"{want_l}); max_memory_allocated rose {rise} bytes (bound {limit}: the output, "
            f"WORKSPACE_BUDGET and {PEAK_SLACK}) on {card} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(rate)
    if failed:
        raise SystemExit(f"phase 7e (c) (a): the chunked forward failed at rates {failed}")
    return launched


def chunked_backward(torch, card, counted) -> dict:
    """Phase 7e (c) (b): encode_bwd on CHUNKED_BWD, 4,915,200 tokens at E =
    256, bf16, rate 0.1, at CHUNKED_TOKEN0, whose whole-call workspace
    (sasrec_encode_bwd_workspace) is more than the card's memory: in the
    chunks of plan_chunks, the repeat bit-identical in all 13 outputs,
    exactly call_launches' launches a call, the memory rise bounded as in
    (a), dx of each chunk_pieces range bit for bit a whole call's, and dx
    and the 12 weight gradients within ENC_BWD_TOL and ENC_BWD_NORM_TOL
    (check_encoder_bwd) of the fp64 sums over another partition, whole
    calls of CHUNKED_PIECE rows at their token bases. Returns the counted
    launches of the chunked calls."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        WORKSPACE_BUDGET,
        bwd_lib,
        call_launches,
        encode_bwd,
        plan_chunks,
    )

    b, s, e, heads, layers = CHUNKED_BWD
    dt = torch.bfloat16
    x, amask, pad, ws, _, _, _ = encoder_case(torch, dt, b, e, heads, layers, 47, s=s,
                                              on_card=True)
    g = encoder_cotangent(torch, pad, e, 48, dt, on_card=True)
    whole = bwd_lib().sasrec_encode_bwd_workspace(b, s, e, heads, layers, 1)
    card_bytes = torch.cuda.mem_get_info()[1]
    plan = plan_chunks(b, s, e, heads, layers, dt, "bwd")
    kw = dict(num_heads=heads, seed=torch.tensor([49], dtype=torch.int64, device="cuda"),
              rate=DROP_RATE)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = encode_bwd(g, x, amask, *ws, **kw, token0=CHUNKED_TOKEN0)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    again, ms = timed(torch, lambda: encode_bwd(g, x, amask, *ws, **kw, token0=CHUNKED_TOKEN0))
    got_l = {fn.__name__: fn.launches for fn in counted}
    launched = {fn: fn.launches for fn in counted}
    want_l = {fn.__name__: 2 * call_launches(b, s, e, heads, layers, dt, "bwd")
              * (fn is encode_bwd) for fn in counted}
    same = all(torch.equal(p, q) for p, q in zip(got, again))
    del again
    pieces = [torch.equal(encode_bwd(g[r0:r1], x[r0:r1], amask[r0:r1], *ws, **kw,
                                     token0=CHUNKED_TOKEN0 + r0 * s)[0], got[0][r0:r1])
              for r0, r1 in chunk_pieces(plan, b)]
    dxs, sums = [], None
    for r0 in range(0, b, CHUNKED_PIECE):
        r1 = min(r0 + CHUNKED_PIECE, b)
        dx, *grads = encode_bwd(g[r0:r1], x[r0:r1], amask[r0:r1], *ws, **kw,
                                token0=CHUNKED_TOKEN0 + r0 * s)
        dxs.append(dx)
        grads = [t.double() for t in grads]
        sums = grads if sums is None else [p + q for p, q in zip(sums, grads)]
    want = (torch.cat(dxs), *sums)
    torch.cuda.synchronize()
    worst, worst_norm, gate_free, bad = check_encoder_bwd(torch, got, want, "bfloat16")
    limit = sum(t.numel() * t.element_size() for t in got) + WORKSPACE_BUDGET + PEAK_SLACK
    ok = (whole > card_bytes and len(plan) >= 2 and same and all(pieces) and not bad
          and got_l == want_l and rise <= limit)
    log(f"[chunked backward] B={b} S={s} E={e} H={heads} L={layers} bf16 rate {DROP_RATE}: "
        f"{b * s} tokens, whole-call workspace {whole} bytes (the card holds {card_bytes}), in "
        f"{len(plan)} chunks of {plan[0][1]} rows, token base {CHUNKED_TOKEN0}; {ms:.3f} ms = "
        f"{b * s / ms * 1e3:.0f} tokens/s; repeat bit-identical {same}; dx of {len(pieces)} "
        f"whole calls of {CHUNKED_PIECE} rows (first, across each boundary, last) bit for bit "
        f"{pieces}; against the fp64 sum of {len(dxs)} whole calls of {CHUNKED_PIECE} rows: "
        f"max_abs_err={worst:.3e}, largest |d|/|want| {worst_norm:.3e} (bars ENC_BWD_TOL, "
        f"ENC_BWD_NORM_TOL {ENC_BWD_NORM_TOL['bfloat16']:.3e}), gate-free {gate_free:.3e}, out "
        f"of the bars {bad}; launches {got_l} (expected {want_l}); max_memory_allocated rose "
        f"{rise} bytes (bound {limit}) on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 7e (c) (b): the chunked backward failed")
    return launched


def chunked_serve(torch, server, rows, card, counted) -> dict:
    """Phase 7e (c) (c): sasrec_fibinet_ml1m's export (7e (b)) through
    Predictor.score_table at batch_size CHUNKED_SERVE[1] over the
    CHUNKED_SERVE[0] rows it trained on (max_len 200): two batches whose
    encoder calls are each past MAX_TOKENS, so chunked. Exactly
    call_launches' encoder launches and score_launches a batch; the
    probabilities finite in (0, 1) and within TOL["fused_score"] of the
    same table scored at B_FULL a batch (one chunk a call). Returns the
    counted launches of the batch-65,536 run."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        call_launches,
        encode_fwd,
        plan_chunks,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches

    n, batch = CHUNKED_SERVE
    shape = chunked_serve_shape()
    plan = plan_chunks(*shape, torch.bfloat16, "fwd")
    if rows.num_rows != n or server.compute_dtype != torch.bfloat16:
        raise SystemExit(f"phase 7e (c) (c): {rows.num_rows} rows in {server.compute_dtype}")
    n_batches = -(-n // batch)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    probs = server.score_table(rows, batch)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    launched = {fn: fn.launches for fn in counted}
    got_l = {fn.__name__: fn.launches for fn in counted}
    per = {encode_fwd: call_launches(*shape, torch.bfloat16, "fwd"), score_fwd: score_launches()}
    want_l = {fn.__name__: n_batches * per.get(fn, 0) for fn in counted}
    t0 = time.perf_counter()
    ref = server.score_table(rows, B_FULL)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    err, bad, bar = check_close("fused_score", torch.from_numpy(probs), torch.from_numpy(ref),
                                "bfloat16")
    sane = probs.shape == (n,) and bool(((probs > 0) & (probs < 1)).all())
    ok = got_l == want_l and not bad and sane and server.use_fused and len(plan) >= 2
    log(f"[chunked serve] sasrec_fibinet_ml1m score_table over {n} rows at batch_size {batch} "
        f"(max_len {shape[1]}: {batch * shape[1]} tokens an encoder call, "
        f"{len(plan)} chunks of {plan[0][1]} rows): {t_big:.3f} s = {n / t_big:.0f} rows/s (batch "
        f"{B_FULL}: {t_ref:.3f} s = {n / t_ref:.0f} rows/s); against batch {B_FULL} "
        f"max_abs_err={err:.3e}, {bad} outside {bar}; launches {got_l} (expected {want_l}) on "
        f"{card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 7e (c) (c): score_table past MAX_TOKENS failed")
    return launched


def outside_phase(torch, train, valid, store, root, card, counted, ml1m, spied) -> dict:
    """Phase 7e (c): the shapes the JAX kernels run that lie outside the
    port's kernels' own multiples or past what their first designs took,
    each model otherwise at the full defaults: mm_fibinet at E = OUTSIDE_E
    (the interaction and scoring kernels at padded_width(E)), mm_fibinet
    with an OUTSIDE_TOWER tower (the scoring kernel at each width padded to
    a multiple of 8) and sasrec_fibinet with one head of WIDE_HEAD_E at
    max_len WIDE_HEAD_LEN (the streamed attention reading its heads from
    device memory in chunks; on a cut of phase 6's data made at that
    max_len), trained, evaluated and served on the kernels; then the
    encoder at batches cut into chunks: (a) chunked_forward, (b)
    chunked_backward and (c) chunked_serve of ``ml1m`` (7e (b)'s
    sasrec_fibinet_ml1m Predictor and train rows), with ``spied``
    (spy_plans) off over them. Returns each counted wrapper's launches
    over the cases."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import synthetic_splits
    from ctr_recommendation_tpu_torch.ops.cuda.encoder_blocks import attention_route, attn_depth
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import bwd_launches as ibwd_n
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import fwd_launches as ifwd_n
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        bwd_launches,
        encode_bwd,
        encode_fwd,
        fwd_launches,
        padded_dims,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad

    def experiment(tag, **kw):
        return microlens_experiment(data_root="", checkpoint_dir=os.path.join(root, tag),
                                    use_pallas=True, **kw)

    dp = padded_dims(WIDE_HEAD_E, 1)[1]
    if attention_route(WIDE_HEAD_LEN, dp) != "streamed" or attn_depth(dp) != 0:
        raise SystemExit(f"phase 7e (c): a head of {dp} at S={WIDE_HEAD_LEN} does not take the "
                         f"streamed attention from device memory")
    wide = synthetic_splits(B_TRAIN, 2 * B_FULL, seed=0, max_len=WIDE_HEAD_LEN)

    fi, bi, ef, eb = ifwd_n(), ibwd_n(), fwd_launches(1), bwd_launches(1)
    total = {fn: 0 for fn in counted}
    per = {"step": {interaction_fwd: fi, interaction_bwd: bi},
           "eval": {interaction_fwd: fi}, "serve": {score_fwd: score_launches()}}
    per_sasrec = {"step": {interaction_fwd: fi, interaction_bwd: bi, encode_fwd: ef,
                           encode_bwd: eb},
                  "eval": {interaction_fwd: fi, encode_fwd: ef},
                  "serve": {score_fwd: score_launches(), encode_fwd: ef}}
    calls = {"step": OUTSIDE_STEPS, "eval": 1, "serve": 2}
    for tag, exp, launches, kind, data in (
            (f"mm_fibinet E={OUTSIDE_E}", experiment("e10", embedding_dim=OUTSIDE_E), per,
             "padded", (train, valid, store)),
            (f"mm_fibinet tower {OUTSIDE_TOWER}", experiment("t100", hidden_units=OUTSIDE_TOWER),
             per, "padded", (train, valid, store)),
            (f"sasrec_fibinet E={WIDE_HEAD_E} H=1 max_len {WIDE_HEAD_LEN}",
             experiment("e512", model="sasrec_fibinet", embedding_dim=WIDE_HEAD_E,
                        attn_num_heads=1, max_len=WIDE_HEAD_LEN), per_sasrec, "wide head", wide)):
        # a step's table_grad launches: the sum over this configuration's table shapes
        launches = dict(launches, step={**launches["step"], table_grad: tg_step_launches(exp)})
        outside_case(torch, tag, exp, *data, card, counted, launches, kind)
        for fn in counted:
            total[fn] += sum(calls[k] * launches[k].get(fn, 0) for k in calls)
    spied["on"] = False  # the chunked cases: plans of more than one chunk
    clock("7e (c) chunked")
    for launched in (chunked_forward(torch, card, counted), chunked_backward(torch, card, counted),
                     chunked_serve(torch, *ml1m, card, counted)):
        for fn in counted:
            total[fn] += launched[fn]
    spied["on"] = True
    return total


# ---- phase 7f: the port's own entry points (the CLIs' main) on a parquet root ----
# write_synthetic_dataset's cut of CLI_ROWS: 245,760 train, 49,152 valid, 32,768 test rows
CLI_ROWS, CLI_ITEMS = 327_680, 91_717
CLI_SPLITS = {"train": 245_760, "valid": 49_152, "test": 32_768}
CLI_ROW_GROUP = 16_384  # --stream's train.parquet, rewritten in row groups of this many rows
CLI_SERVE_SIZES = (1, 9, 16, 17, 40, 64)  # requests of consecutive test rows to the service
# the service's latency run: sequential requests of random test rows, 7b's smallest bucket
CLI_SERVE_REPS, CLI_SERVE_ROWS, CLI_SERVE_SEED = 256, 16, 31
CLI_ITEM_SEED = 29  # item_feature.parquet's generator (Task 1)


class CliOutput:
    """A CLI's standard output, line by line: each line logged as ``[cli
    <stage>] | <line>`` on the script's own output and kept with the host
    clock's time (``lines``: (perf_counter, line))."""

    def __init__(self, stage: str, out):
        self.stage, self.out, self.lines, self._part = stage, out, [], ""
        self._lock = threading.Lock()

    def write(self, s: str) -> int:
        with self._lock:
            *done, self._part = (self._part + s).split("\n")
            for line in done:
                self.lines.append((time.perf_counter(), line))
                self.out.write(f"[cli {self.stage}] | {line}\n")
        return len(s)

    def flush(self) -> None:
        self.out.flush()


def run_cli(torch, stage: str, main, argv: list[str], counted) -> dict:
    """``main(argv)`` of one of the port's CLIs in this process, its standard
    output kept (CliOutput); fails unless it returns 0. Returns its lines
    (seconds from the call's start, line), its wall seconds and each
    counted wrapper's launches in the call."""
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    out = CliOutput(stage, sys.stdout)
    log(f"[cli {stage}] main({' '.join(argv)})")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if out._part:
        out.write("\n")
    if rc != 0:
        raise SystemExit(f"phase 7f {stage}: the CLI returned {rc}")
    log(f"[cli {stage}] returned 0 in {seconds:.3f} s")
    return {"lines": [(t - t0, ln) for t, ln in out.lines], "seconds": seconds,
            "launches": {fn: fn.launches for fn in counted}}


def cli_line_at(run: dict, prefix: str) -> float:
    """The seconds into ``run`` at which its first line starting with
    ``prefix`` was printed."""
    at = next((t for t, ln in run["lines"] if ln.startswith(prefix)), None)
    if at is None:
        raise SystemExit(f"phase 7f: no {prefix!r} line in {[ln for _, ln in run['lines']]}")
    return at


def cli_launches(stage: str, run: dict, want: dict) -> None:
    """``run``'s launches exactly ``want``'s (a wrapper absent: 0)."""
    got = run["launches"]
    want = {fn: want.get(fn, 0) for fn in got}
    names = lambda d: {fn.__name__: n for fn, n in d.items()}  # noqa: E731
    log(f"[cli {stage}] launches {names(got)}, expected {names(want)}")
    if got != want:
        raise SystemExit(f"phase 7f {stage}: launches {names(got)}, expected {names(want)}")


def cli_history(stage: str, ckpt: str, epochs: int, ran: int, card: str) -> list[dict]:
    """A train run's ``metrics.csv``: rows of epochs 1..``epochs``, the train
    loss finite and falling (from the first epoch to the last; a one-epoch
    run's below log 2, a constant predictor's at the labels' even odds),
    the best valid AUC above 0.6. Logs the last ``ran`` epochs' examples/s
    and AUC."""
    import csv

    with open(os.path.join(ckpt, "metrics.csv"), newline="") as f:
        hist = [{k: float(v) for k, v in r.items() if v not in (None, "")}
                for r in csv.DictReader(f)]
    for h in hist[-ran:]:
        log(f"[cli {stage}] epoch {int(h['epoch'])}: {h['examples_per_sec']:.0f} examples/s "
            f"({h['seconds']:.3f} s train, {h['eval_seconds']:.3f} s eval), loss "
            f"{h['train_loss']:.5f}, valid auc {h['auc']:.5f} on {card}")
    losses = [h["train_loss"] for h in hist]
    falling = losses[-1] < losses[0] if len(losses) > 1 else losses[0] < np.log(2.0)
    best = max(h["auc"] for h in hist)
    if [int(h["epoch"]) for h in hist] != list(range(1, epochs + 1)):
        raise SystemExit(f"phase 7f {stage}: metrics.csv holds epochs "
                         f"{[h['epoch'] for h in hist]}, expected 1..{epochs}")
    if not all(np.isfinite(losses)) or not falling or not best > 0.6:
        raise SystemExit(f"phase 7f {stage}: losses {losses} not finite and falling, or best "
                         f"valid AUC {best} not above 0.6")
    return hist


@contextlib.contextmanager
def restored_state(into: dict):
    """Trainer._restore observed: right after it returns, ``into`` holds
    the trainer's step, parameters, model state and optimizer states as
    the trainer holds them (clones of its tensors, where they lie)."""
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
    from ctr_recommendation_tpu_torch.training import Trainer

    restore = Trainer._restore

    def observed(self, payload):
        restore(self, payload)
        st = self.state
        into.update({k: {p: t.detach().clone() if hasattr(t, "detach") else t
                         for p, t in flatten(getattr(st, k)).items()}
                     for k in ("params", "model_state", "opt_state", "table_opt_state")},
                    step=st.step)

    Trainer._restore = observed
    try:
        yield
    finally:
        Trainer._restore = restore


def check_restored(torch, got: dict, path: str) -> int:
    """The state Trainer._restore left (restored_state) against the resume
    point at ``path``: the step, every parameter, model state and optimizer
    leaf bit for bit, each tensor on the card. Returns the tensors held."""
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten

    want = torch.load(path, map_location="cpu", weights_only=True)
    if not got or got["step"] != want["step"]:
        raise SystemExit(f"phase 7f resume: _restore did not run or left step "
                         f"{got.get('step')}, the resume point holds {want['step']}")
    n, bad = 0, []
    for key in ("params", "model_state", "opt_state", "table_opt_state"):
        ref = flatten(want[key])
        if sorted(got[key]) != sorted(ref):
            raise SystemExit(f"phase 7f resume: {key}'s leaves differ from the resume point's")
        for p, b in ref.items():
            a = got[key][p]
            if torch.is_tensor(b):
                n += 1
                if (not torch.is_tensor(a) or a.device.type != "cuda" or a.dtype != b.dtype
                        or not torch.equal(a.cpu(), b)):
                    bad.append(f"{key}/{p}")
            elif a != b:
                bad.append(f"{key}/{p}")
    if bad:
        raise SystemExit(f"phase 7f resume: restored leaves not the resume point's bit for bit "
                         f"on the card: {bad[:8]} ({len(bad)})")
    return n


def write_item_feature(path: str, n: int, seed: int) -> np.ndarray:
    """item_feature.parquet of items 1..n (item_fields' seeded titles, tags
    and levels); returns the mask of the items with no title and no tags."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    f = item_fields(n, seed)
    pq.write_table(pa.table({
        "item_id": pa.array(np.arange(1, n + 1, dtype=np.int64)),
        "item_title": pa.array(f["item_title"], pa.string()),
        "item_tags": pa.array(f["item_tags"], pa.list_(pa.string())),
        "likes_level": pa.array(f["likes_level"].astype(np.int64)),
        "views_level": pa.array(f["views_level"].astype(np.int64)),
    }), path)
    return f["blank"]


def ckpt_tensors(torch, path: str) -> dict:
    """Every tensor of the resume point at ``path`` by its path in the
    payload, and its step."""
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten

    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = {"step": payload["step"]}
    for key in ("params", "model_state", "opt_state", "table_opt_state"):
        out.update({f"{key}/{p}": t for p, t in flatten(payload[key]).items()
                    if torch.is_tensor(t)})
    return out


def resume_against_straight(torch, synth: list, base: str, card, counted, add,
                            mm_epochs) -> None:
    """Phase 7f 3b: the train CLI for 3 epochs straight on a fresh
    checkpoint directory; that directory as a stop after epoch 2 leaves it
    (its ckpt_3.pt and epoch 3's metrics.csv row taken out) resumed with
    --resume --epochs 3: its ckpt_3.pt equal to the straight run's in every
    tensor, and its epoch-3 row's metrics (all but the clock's) equal."""
    import csv
    import shutil

    from ctr_recommendation_tpu_torch.cli import train as cli_train

    epochs = TRAIN_EPOCHS + 1
    straight, cut = os.path.join(base, "ckpt_straight"), os.path.join(base, "ckpt_cut")
    argv = [*synth[:-1], straight, "--epochs", str(epochs)]  # synth ends in its ckpt dir
    run = add(run_cli(torch, "train straight", cli_train.main, argv, counted))
    cli_launches("train straight", run, mm_epochs(epochs))
    cli_history("train straight", straight, epochs, epochs, card)
    shutil.copytree(straight, cut)
    os.remove(os.path.join(cut, f"ckpt_{epochs}.pt"))
    with open(os.path.join(cut, "metrics.csv"), newline="") as f:
        rows = list(csv.reader(f))
    with open(os.path.join(cut, "metrics.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows[:epochs])  # the header and epochs 1..2
    argv = [*synth[:-1], cut, "--epochs", str(epochs), "--resume"]
    run = add(run_cli(torch, "resume straight", cli_train.main, argv, counted))
    cli_launches("resume straight", run, mm_epochs(1))
    hists = [cli_history(tag, d, epochs, 1, card)
             for tag, d in (("train straight", straight), ("resume straight", cut))]
    clocked = ("seconds", "examples_per_sec", "eval_seconds", "checkpoint_seconds")
    rows3 = [{k: v for k, v in h[-1].items() if k not in clocked} for h in hists]
    want, got = (ckpt_tensors(torch, os.path.join(d, f"ckpt_{epochs}.pt"))
                 for d in (straight, cut))
    apart = [k for k in want if k != "step" and not (k in got and torch.equal(want[k], got[k]))]
    log(f"[cli resume straight] ckpt_{epochs}.pt of the run stopped after epoch {TRAIN_EPOCHS} "
        f"and resumed against the straight {epochs}-epoch run's: step {got['step']} / "
        f"{want['step']}, {len(want) - 1} tensors, {len(apart)} apart {apart[:8]}; epoch "
        f"{epochs}'s metrics {rows3[1]} / {rows3[0]} on {card}")
    if apart or sorted(got) != sorted(want) or got["step"] != want["step"] or \
            rows3[0] != rows3[1]:
        raise SystemExit("phase 7f: the resumed run is not the straight run bit for bit")


def cli_phase(torch, root: str, card: str, counted) -> dict:
    """Phase 7f (see the module docstring): the CLIs' main() on a parquet
    root at the full microlens_experiment() width. Returns each counted
    wrapper's launches over the phase's CLI runs."""
    import dataclasses

    import pyarrow  # noqa: F401  the parquet paths need it: no skip without it
    import pyarrow.parquet as pq

    from ctr_recommendation_tpu_torch.cli import evaluate as cli_evaluate
    from ctr_recommendation_tpu_torch.cli import item_embeddings as cli_items
    from ctr_recommendation_tpu_torch.cli import predict as cli_predict
    from ctr_recommendation_tpu_torch.cli import serve as cli_serve
    from ctr_recommendation_tpu_torch.cli import train as cli_train
    from ctr_recommendation_tpu_torch.cli import validate_dataset as cli_validate
    from ctr_recommendation_tpu_torch.config import microlens_experiment, serialize
    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.data import ItemStore, load_split
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import bwd_launches as ibwd_n
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import fwd_launches as ifwd_n
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_bwd, interaction_fwd
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import (
        bwd_launches,
        encode_bwd,
        encode_fwd,
        fwd_launches,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_launches
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
    from ctr_recommendation_tpu_torch.tools import jax_bridge

    t_phase = time.perf_counter()
    total = {fn: 0 for fn in counted}

    def add(run):
        for fn, n in run["launches"].items():
            total[fn] += n
        return run

    base = os.path.join(root, "cli")
    data, ckpt = os.path.join(base, "data"), os.path.join(base, "ckpt")
    fi, bi, sl = ifwd_n(), ibwd_n(), score_launches()
    ef, eb = fwd_launches(1), bwd_launches(1)
    # ---- 1-2: --synthetic writes the root, then fit_on_device on it ----
    synth = ["--synthetic", data, "--synthetic-rows", str(CLI_ROWS), "--synthetic-items",
             str(CLI_ITEMS), "--synthetic-signal", "high", "--checkpoint-dir", ckpt]
    run = add(run_cli(torch, "train", cli_train.main, [*synth, "--epochs", str(TRAIN_EPOCHS)],
                      counted))
    t_load = cli_line_at(run, "[data] loading")
    t_train = cli_line_at(run, "[data] train ")
    sizes = {n: pq.ParquetFile(os.path.join(data, f"{n}.parquet")).metadata for n in CLI_SPLITS}
    got_rows = {n: md.num_rows for n, md in sizes.items()}
    if got_rows != CLI_SPLITS:
        raise SystemExit(f"phase 7f: the synthetic root's splits hold {got_rows}, expected "
                         f"{CLI_SPLITS}")
    log(f"[cli write] --synthetic: {CLI_ROWS} rows ({got_rows}, row groups "
        f"{ {n: md.num_row_groups for n, md in sizes.items()} }) and item_info of {CLI_ITEMS} "
        f"items written in {t_load:.3f} s = {CLI_ROWS / t_load:.0f} rows/s on {card}'s host")
    log(f"[cli load] load_split (valid, train) and ItemStore.from_parquet: "
        f"{CLI_SPLITS['train'] + CLI_SPLITS['valid']} rows in {t_train - t_load:.3f} s = "
        f"{(CLI_SPLITS['train'] + CLI_SPLITS['valid']) / (t_train - t_load):.0f} rows/s on "
        f"{card}'s host")
    bs = B_TRAIN
    spe = CLI_SPLITS["train"] // bs
    evals = -(-CLI_SPLITS["valid"] // B_FULL)  # eval_batch_size 8192
    # a step's table_grad launches at the CLIs' defaults (any item table past
    # the shared path's edge takes the same launches)
    mm_step = {interaction_fwd: fi, interaction_bwd: bi,
               table_grad: tg_step_launches(microlens_experiment(data_root=""))}

    def mm_epochs(n):
        return {fn: k * n * spe + (fi if fn is interaction_fwd else 0) * n * evals
                for fn, k in mm_step.items()}

    cli_launches("train", run, mm_epochs(TRAIN_EPOCHS))
    hist = cli_history("train", ckpt, TRAIN_EPOCHS, TRAIN_EPOCHS, card)
    in_memory_auc = max(h["auc"] for h in hist)
    for name in ("experiment.json", f"ckpt_{TRAIN_EPOCHS}.pt", os.path.join("best", "export.npz")):
        if not os.path.exists(os.path.join(ckpt, name)):
            raise SystemExit(f"phase 7f train: no {name} in the checkpoint directory")
    log(f"[cli train] fit_on_device from main(): {TRAIN_EPOCHS} epochs of {spe} steps in "
        f"{run['seconds']:.3f} s of the CLI (the write and the load included), best valid auc "
        f"{in_memory_auc:.5f} on {card}")
    # ---- 3: --resume --epochs 3 on the same checkpoint directory ----
    resume_point = os.path.join(ckpt, f"ckpt_{TRAIN_EPOCHS}.pt")
    restored: dict = {}
    with restored_state(restored):
        run = add(run_cli(torch, "resume", cli_train.main,
                          [*synth, "--epochs", str(TRAIN_EPOCHS + 1), "--resume"], counted))
    held = check_restored(torch, restored, resume_point)
    resumed = [ln for _, ln in run["lines"] if ln.startswith("[resume]")]
    log(f"[cli resume] {resumed}; the state _restore left: step {restored['step']}, {held} "
        f"tensors (parameters, model state, Adam moments) bit for bit {resume_point}'s, on "
        f"the card")
    if not any(ln.startswith(f"[resume] epoch {TRAIN_EPOCHS} ") for ln in resumed):
        raise SystemExit(f"phase 7f resume: no '[resume] epoch {TRAIN_EPOCHS}' line")
    cli_launches("resume", run, mm_epochs(1))
    hist = cli_history("resume", ckpt, TRAIN_EPOCHS + 1, 1, card)
    if not os.path.exists(os.path.join(ckpt, f"ckpt_{TRAIN_EPOCHS + 1}.pt")):
        raise SystemExit("phase 7f resume: no resume point of the third epoch")
    # ---- 3b: --resume against a straight run of the same 3-epoch schedule ----
    resume_against_straight(torch, synth, base, card, counted, add, mm_epochs)
    # ---- 4: --stream over row groups of CLI_ROW_GROUP rows ----
    streamed = os.path.join(base, "data_row_groups")
    os.makedirs(streamed)
    for name in ("valid", "test", "item_info"):
        os.symlink(os.path.join(data, f"{name}.parquet"),
                   os.path.join(streamed, f"{name}.parquet"))
    pq.write_table(pq.read_table(os.path.join(data, "train.parquet")),
                   os.path.join(streamed, "train.parquet"), row_group_size=CLI_ROW_GROUP)
    groups = pq.ParquetFile(os.path.join(streamed, "train.parquet")).metadata.num_row_groups
    ckpt_stream = os.path.join(base, "ckpt_stream")
    run = add(run_cli(torch, "train --stream", cli_train.main,
                      ["--data-root", streamed, "--stream", "--epochs", str(TRAIN_EPOCHS),
                       "--checkpoint-dir", ckpt_stream], counted))
    cli_launches("train --stream", run, mm_epochs(TRAIN_EPOCHS))
    hist = cli_history("train --stream", ckpt_stream, TRAIN_EPOCHS, TRAIN_EPOCHS, card)
    stream_auc = max(h["auc"] for h in hist)
    log(f"[cli train --stream] Trainer.fit over stream_batches: {groups} row groups of "
        f"{CLI_ROW_GROUP} rows, {TRAIN_EPOCHS} epochs in {run['seconds']:.3f} s of the CLI; "
        f"best valid auc {stream_auc:.5f}, the in-memory run's {in_memory_auc:.5f} (tolerance "
        f"{FIT_AUC_TOL}) on {card}")
    if groups != CLI_SPLITS["train"] // CLI_ROW_GROUP or \
            abs(stream_auc - in_memory_auc) > FIT_AUC_TOL:
        raise SystemExit(f"phase 7f train --stream: {groups} row groups, or its AUC is off the "
                         f"in-memory run's")
    # ---- 5: predict, the pipeline (default) and --stream, against score_table ----
    def export_predictor(ckpt_dir: str, data_root: str):
        """A Predictor on ``ckpt_dir``'s best/export.npz over ``data_root``'s
        item_info, as the predict CLI assembles it; and its feature map."""
        exp = serialize.load(os.path.join(ckpt_dir, "experiment.json"))
        exp = exp.replace(dataset=dataclasses.replace(
            exp.dataset, data_root=data_root,
            item_info=os.path.join(data_root, "item_info.parquet")), mesh=MeshConfig())
        fm = build_feature_map(exp.dataset)
        return Predictor(exp, *jax_bridge.params_from_jax(
            *jax_bridge.load(os.path.join(ckpt_dir, "best", "export.npz")), fm, exp.model),
            item_store=ItemStore.from_parquet(exp.dataset.item_info)), fm

    pred, fm = export_predictor(ckpt, data)
    test = load_split(os.path.join(data, "test.parquet"), fm)
    ref = pred.score_table(test, B_FULL)
    n_test = CLI_SPLITS["test"]
    csvs = {}
    for flags in ([], ["--stream"]):
        stage = " ".join(["predict", *flags])
        out_dir = os.path.join(base, "out" + "_".join(flags).replace("--", "_"))
        run = add(run_cli(torch, stage, cli_predict.main,
                          ["--data-root", data, "--checkpoint-dir", ckpt, "--out-dir", out_dir,
                           *flags], counted))
        cli_launches(stage, run, {score_fwd: sl * -(-n_test // B_FULL)})
        csv_path = os.path.join(out_dir, "prediction_fibinet.csv")
        check_submission(n_test, csv_path, os.path.join(out_dir, "submission_fibinet.zip"), ref,
                         f"cli {stage}", n_rows=n_test)
        with open(csv_path, "rb") as f:
            csvs[stage] = f.read()
        log(f"[cli {stage}] {n_test} rows from parquet to CSV + zip in {run['seconds']:.3f} s "
            f"of the CLI = {n_test / run['seconds']:.0f} rows/s on {card}")
    if csvs["predict"] != csvs["predict --stream"]:
        raise SystemExit("phase 7f predict: the two paths' CSVs differ")
    log(f"[cli predict] the pipeline's and --stream's CSVs byte-identical "
        f"({len(csvs['predict'])} bytes), and score_table's over load_split(test.parquet)")
    # ---- 6: evaluate --gauc-col user_id on the valid split ----
    seen = {}
    evaluate = cli_evaluate.evaluate

    def observed(*a, **kw):
        res = evaluate(*a, **kw)
        seen.update(res)
        return res

    cli_evaluate.evaluate = observed
    try:
        run = add(run_cli(torch, "evaluate", cli_evaluate.main,
                          ["--data-root", data, "--checkpoint-dir", ckpt, "--gauc-col",
                           "user_id"], counted))
    finally:
        cli_evaluate.evaluate = evaluate
    cli_launches("evaluate", run, {score_fwd: sl * evals})
    valid = load_split(os.path.join(data, "valid.parquet"), fm)
    want = evaluate(pred, valid, batch_size=B_FULL, gauc_col="user_id")
    line = next((ln for _, ln in run["lines"] if ln.startswith("[eval]")), None)
    with open(os.path.join(ckpt, "best", "metric.json")) as f:
        best_export = json.load(f)["metric"]  # the export's valid AUC in training
    log(f"[cli evaluate] {line} in {run['seconds']:.3f} s = "
        f"{CLI_SPLITS['valid'] / run['seconds']:.0f} rows/s on {card}; in this process "
        f"{cli_evaluate.eval_line(want, 'user_id')}; the export's valid auc in training "
        f"{best_export:.5f} (tolerance {AUC_SERVE_TOL})")
    if line != cli_evaluate.eval_line(want, "user_id") or any(
            seen.get(k) != want[k] for k in ("rows", "auc", "logloss", "gauc")):
        raise SystemExit("phase 7f evaluate: the CLI's metrics are not evaluate()'s")
    if abs(want["auc"] - best_export) > AUC_SERVE_TOL:
        raise SystemExit("phase 7f evaluate: the CLI's AUC is off the export's in training")
    # ---- 7: validate_dataset ----
    run = run_cli(torch, "validate", cli_validate.main, ["--data-root", data], counted)
    cli_launches("validate", run, {})
    log(f"[cli validate] exit 0 in {run['seconds']:.3f} s ({CLI_ROWS} rows) on {card}'s host")
    # ---- 8: serve: build_service, warmup, make_http_server on port 0 ----
    args = cli_serve.build_argparser().parse_args(
        ["--data-root", data, "--checkpoint-dir", ckpt, "--port", "0"])
    service = cli_serve.build_service(args)
    collator = service.collator
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    service.warmup()
    t_warm = time.perf_counter() - t0
    warm = add({"launches": {fn: fn.launches for fn in counted}})
    cli_launches("serve warmup", warm, {score_fwd: len(collator.buckets) * 2 * sl})
    for fn in counted:
        fn.launches = 0
    start, e2e, worst = 0, [], 0.0
    rng = np.random.default_rng(CLI_SERVE_SEED)
    with http_service(service) as url:
        for n in CLI_SERVE_SIZES:
            _, per = score_requests(url, collator, test.columns, ref, [n], start=start)
            worst, start = max(worst, per[0][3]), start + n
        for _ in range(CLI_SERVE_REPS):  # timed as 7b times a bucket: JSON encode to reply
            idx = rng.integers(0, n_test, CLI_SERVE_ROWS)
            rows = request_rows(collator, test.columns, idx)
            t0 = time.perf_counter()
            code, reply = post(url, json.dumps({"rows": rows}).encode())
            e2e.append(1e3 * (time.perf_counter() - t0))
            if code != 200 or len(reply["probs"]) != CLI_SERVE_ROWS:
                raise SystemExit(f"phase 7f serve: a {CLI_SERVE_ROWS}-row request answered {code}")
            worst = max(worst, float(np.abs(np.asarray(reply["probs"], np.float32)
                                            - ref[idx]).max()))
        dispatched = service.stats()["batches_dispatched"]
    served = add({"launches": {fn: fn.launches for fn in counted}})
    log(f"[cli serve] build_service on the train CLI's checkpoint directory, warmup of "
        f"{len(collator.buckets)} buckets in {t_warm:.3f} s; {len(CLI_SERVE_SIZES)} requests of "
        f"{list(CLI_SERVE_SIZES)} consecutive test rows, then {CLI_SERVE_REPS} sequential "
        f"requests of {CLI_SERVE_ROWS} random ones: p50 {np.percentile(e2e, 50):.3f} ms, p99 "
        f"{np.percentile(e2e, 99):.3f} ms end to end; max|d| from score_table {worst:.3e} "
        f"(tolerance {CPU_TOL}); {dispatched} dispatches on {card}")
    cli_launches("serve", served, {score_fwd: dispatched * sl})
    if worst > CPU_TOL:
        raise SystemExit("phase 7f serve: responses off score_table's")
    # ---- 9: Task 1 -> Task 2: item embeddings, then sasrec_fibinet trained and predicted ----
    task2 = os.path.join(base, "data_task2")
    os.makedirs(task2)
    for name in ("train", "valid", "test"):
        os.symlink(os.path.join(data, f"{name}.parquet"), os.path.join(task2, f"{name}.parquet"))
    features = os.path.join(base, "item_feature.parquet")
    blank = write_item_feature(features, CLI_ITEMS, CLI_ITEM_SEED)
    info = os.path.join(task2, "item_info.parquet")
    run = add(run_cli(torch, "item_embeddings", cli_items.main,
                      ["--item-feature", features, "--output", info, "--encoder", "hash"],
                      counted))
    cli_launches("item_embeddings", run, {})
    table = pq.read_table(info)
    ids = table.column("item_id").to_numpy()
    col = table.column("item_emb_d128").combine_chunks()
    if not (col.value_lengths().to_numpy() == 128).all():
        raise SystemExit("phase 7f item_embeddings: a row of item_emb_d128 is not 128 long")
    emb = col.flatten().to_numpy().astype(np.float64).reshape(-1, 128)
    norms = np.linalg.norm(emb, axis=1)
    log(f"[cli item_embeddings] {CLI_ITEMS} items in {run['seconds']:.3f} s = "
        f"{CLI_ITEMS / run['seconds']:.0f} items/s (the hash encoder on the host, pca_project on "
        f"the card) on {card}; {emb.shape} {table.schema.field('item_emb_d128').type}, L2 norms "
        f"|1 - n| max {np.abs(norms[~blank] - 1).max():.2e} (tolerance 1e-5), {int(blank.sum())} "
        f"items with no title and no tags at 0")
    if (not np.array_equal(ids, np.arange(1, CLI_ITEMS + 1)) or emb.shape != (CLI_ITEMS, 128)
            or not np.array_equal(emb.astype(np.float32).astype(np.float64), emb)
            or np.abs(norms[~blank] - 1).max() > 1e-5 or np.any(emb[blank] != 0)):
        raise SystemExit("phase 7f item_embeddings: not float32 rows of 128 dims, L2-normed, "
                         "of the input's items in order")
    ckpt_sasrec = os.path.join(base, "ckpt_sasrec")
    run = add(run_cli(torch, "train sasrec_fibinet", cli_train.main,
                      ["--data-root", task2, "--model", "sasrec_fibinet", "--epochs", "1",
                       "--checkpoint-dir", ckpt_sasrec], counted))
    cli_launches("train sasrec_fibinet", run, {
        interaction_fwd: fi * (spe + evals), interaction_bwd: bi * spe,
        encode_fwd: ef * (spe + evals), encode_bwd: eb * spe,
        table_grad: spe * tg_step_launches(microlens_experiment(data_root="",
                                                                model="sasrec_fibinet"))})
    cli_history("train sasrec_fibinet", ckpt_sasrec, 1, 1, card)
    out_dir = os.path.join(base, "out_sasrec")
    run = add(run_cli(torch, "predict sasrec_fibinet", cli_predict.main,
                      ["--data-root", task2, "--checkpoint-dir", ckpt_sasrec, "--out-dir",
                       out_dir], counted))
    n_batches = -(-n_test // B_FULL)
    cli_launches("predict sasrec_fibinet", run, {score_fwd: sl * n_batches,
                                                  encode_fwd: ef * n_batches})
    log(f"[cli predict sasrec_fibinet] {n_test} rows to CSV + zip in {run['seconds']:.3f} s "
        f"of the CLI = {n_test / run['seconds']:.0f} rows/s on {card}")
    pred, fm = export_predictor(ckpt_sasrec, task2)
    check_submission(n_test, os.path.join(out_dir, "prediction_fibinet.csv"),
                     os.path.join(out_dir, "submission_fibinet.zip"),
                     pred.score_table(load_split(os.path.join(task2, "test.parquet"), fm), B_FULL),
                     "cli predict sasrec_fibinet", n_rows=n_test)
    log(f"[cli] phase 7f in {time.perf_counter() - t_phase:.1f} s")
    return total


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


_START = time.perf_counter()


def clock(phase: str) -> None:
    """A ``[clock]`` line: the seconds since the script started, at the start
    of ``phase``."""
    log(f"[clock] phase {phase} at {time.perf_counter() - _START:.1f} s")


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
    from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad

    # ---- phase 1: card, build ----
    clock("1")
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
        fn = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.rsplit(" ", 1)[-1]
            elif "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {fn} {line.strip()}")

    # ---- phase 2: each kernel against its plain version ----
    clock("2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {"interaction_fwd": 0.0, "fused_score": 0.0, "interaction_bwd": 0.0}
    workspace_grid(torch)
    spied = spy_plans(torch)  # every encoder call's plan from here on
    worst["table_grad"], failures = table_grad_against_plain(torch)
    worst["tower"] = tower_against_plain(torch)
    batches = (B_TRAIN, B_TRAIN + 37, B_FULL, B_RAGGED)
    failures += forward_against_plain(torch, worst, E, HIDDEN, batches)
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
    clock("3")
    timing = mm_timing(torch, card, E, HIDDEN)
    mm_timing(torch, card, WIDE_E, HIDDEN)
    mm_timing(torch, card, WIDE_E, WIDE_HIDDEN, with_interaction=False)
    mm_timing(torch, card, E, WIDE_HIDDEN, with_interaction=False)
    timing[("sasrec_encoder_fwd", "all")] = encoder_timing(torch, card)
    timing[("sasrec_encoder_bwd", "all")] = encoder_bwd_timing(torch, card)
    encoder_timing(torch, card, WIDE_E)
    encoder_bwd_timing(torch, card, WIDE_E)
    timing[("table_grad", "all")] = table_grad_timing(torch, card)
    timing[("tower", "all")] = tower_timing(torch, card)

    # ---- phase 4: the serving main path ----
    clock("4")
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
    clock("5")
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
    clock("5b")
    enc_launches = serve_sasrec(torch, store, rows, card)

    # ---- phases 6-7: the training main path, then its export; 6b: sasrec ----
    clock("6-7")
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
    counted = (interaction_fwd, interaction_bwd, score_fwd, encode_fwd, encode_bwd, table_grad)
    # table_grad's launches a train step at the MicroLens defaults, both models
    # (the other configurations' are summed over their own table shapes)
    tgs = tg_step_launches(microlens_experiment(data_root=""))
    enc_fwd, enc_bwd = fwd_launches(1), bwd_launches(1)  # one layer's kernel launches a call
    ifwd, ibwd = inter_fwd_launches(), inter_bwd_launches()
    with tempfile.TemporaryDirectory() as root:
        mm_exp = microlens_experiment(data_root="", epochs=TRAIN_EPOCHS,
                                      checkpoint_dir=os.path.join(root, "ckpt"))
        mm = train_and_serve(
            torch, mm_exp, train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd, table_grad: tgs},
            per_eval={interaction_fwd: ifwd}, per_serve={score_fwd: score_launches()})
        mm_towers = (TRAIN_EPOCHS * (train.num_rows // mm_exp.train.batch_size)
                     * tower_step_launches(mm_exp))
        log(f"[train mm_fibinet] the tower blocks' launches in the fit {mm['tower_launches']}, "
            f"expected {mm_towers} (steps x layers x (fwd_launches + bwd_launches))")
        if mm["tower_launches"] != mm_towers:
            raise SystemExit("mm_fibinet: the tower blocks' launches in the fit are off")
        # ---- phase 7c: profile_epoch, the reference state_dict import, item embeddings ----
        clock("7c")
        profiled, profiled_tower = profile_epoch_phase(torch, train, train_store, root, card)
        imported = import_phase(torch, store, rows, card)
        item_embeddings_phase(torch, root, card)
        # ---- phase 7d: the entry point's forward, 256 and 8192 rows ----
        clock("7d")
        entry = entry_phase(torch, card, worst, counted)
        # ---- phase 7e: the encoder at every S and E, widths off the kernels' multiples ----
        clock("7e")
        block_err, long_failures = long_attention_blocks(torch)
        clock("7e (a) whole encoder")
        long_fwd, long_bwd, failures = long_history_against_plain(torch)
        pad_fwd, pad_bwd, pad_failures = padded_interaction_against_plain(torch)
        if long_failures or failures or pad_failures:
            raise SystemExit(f"phase 7e's kernels disagree with their plain versions: "
                             f"{long_failures + failures + pad_failures}")
        worst["sasrec_encoder_fwd"] = max(worst["sasrec_encoder_fwd"], long_fwd, block_err)
        worst["sasrec_encoder_bwd"] = max(worst["sasrec_encoder_bwd"], long_bwd)
        worst["interaction_fwd"] = max(worst["interaction_fwd"], pad_fwd)
        worst["interaction_bwd"] = max(worst["interaction_bwd"], pad_bwd)
        fits_grid(torch)
        clock("7e (a) timing")
        for shape in ATTN_TIME_SHAPES:
            attention_timing(torch, card, *shape)
        encoder_timing(torch, card, s=LONG_S, on_card=True)
        encoder_bwd_timing(torch, card, s=LONG_S, on_card=True)
        ml1m_shape = dict(e=ML1M["embedding_dim"], s=ML1M["max_len"],
                          heads=ML1M["attn_num_heads"], layers=ML1M["attn_num_layers"])
        for shape in (dict(s=ML1M["max_len"]), ml1m_shape):  # past shared memory: streamed
            encoder_timing(torch, card, on_card=True, **shape)
            encoder_bwd_timing(torch, card, on_card=True, **shape)
        clock("7e (b)")
        long, _, _ = long_history_phase(torch, root, card, counted,
                                        f"sasrec_fibinet_len{LONG_S}", dict(max_len=LONG_S))
        ml1m, *ml1m_serve = long_history_phase(torch, root, card, counted, "sasrec_fibinet_ml1m",
                                               ML1M, layers=ML1M["attn_num_layers"])
        clock("7e (c)")
        outside = outside_phase(torch, train, valid, train_store, root, card, counted, ml1m_serve,
                                spied)
        del ml1m_serve
        long = {fn: long[fn] + ml1m[fn] + outside[fn] for fn in counted}  # 7e's launches
        # ---- phase 7f: the CLIs' main() on a parquet root ----
        clock("7f")
        cli = cli_phase(torch, root, card, counted)
        # ---- phase 6h: data-parallel training, two ranks sharing the card ----
        clock("6h")
        dp = data_parallel_phase(torch, train, valid, train_store, root, card, dense=mm)
        # ---- phase 6i: row-sharded tables, 1 x 2 and 2 x 2 ranks sharing the card ----
        clock("6i")
        model_parallel_phase(torch, train, valid, train_store, root, card, dense=mm)
        sasrec_exp = microlens_experiment(data_root="", model="sasrec_fibinet",
                                          epochs=TRAIN_EPOCHS,
                                          checkpoint_dir=os.path.join(root, "ckpt_sasrec"))
        m = sasrec_exp.model
        if (m.embedding_dim, m.attn_num_heads, m.attn_num_layers, m.attn_dropout,
                sasrec_exp.train.batch_size) != (ENC_E, ENC_H, 1, DROP_RATE, B_TRAIN):
            raise SystemExit(f"sasrec_fibinet defaults moved: {m}")
        sasrec_tgs = tg_step_launches(sasrec_exp)
        sasrec = train_and_serve(
            torch, sasrec_exp, train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd, encode_fwd: enc_fwd,
                      encode_bwd: enc_bwd, table_grad: sasrec_tgs},
            per_eval={interaction_fwd: ifwd, encode_fwd: enc_fwd},
            per_serve={score_fwd: score_launches(), encode_fwd: enc_fwd}, probe=True)
        # ---- phase 7b: phase 7's exports served over HTTP (serving/) ----
        clock("7b")
        serve_http(torch, mm, sasrec, valid, train_store, card)
        # ---- phase 6d: sasrec_emb_256 (sasrec_fibinet at E=256) ----
        clock("6d")
        wide_sasrec = microlens_experiment(data_root="", model="sasrec_fibinet",
                                           epochs=TRAIN_EPOCHS, embedding_dim=WIDE_E,
                                           checkpoint_dir=os.path.join(root, "ckpt_sasrec_256"))
        train_and_serve(
            torch, wide_sasrec, train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd, encode_fwd: enc_fwd,
                      encode_bwd: enc_bwd, table_grad: tg_step_launches(wide_sasrec)},
            per_eval={interaction_fwd: ifwd, encode_fwd: enc_fwd},
            per_serve={score_fwd: score_launches(), encode_fwd: enc_fwd}, tag="sasrec_emb_256")
        # ---- phase 6c: emb_256_tower1024 (E=256, tower (1024, 512)) ----
        clock("6c")
        wide_exp = microlens_experiment(data_root="", epochs=TRAIN_EPOCHS,
                                        embedding_dim=WIDE_E, hidden_units=WIDE_HIDDEN,
                                        checkpoint_dir=os.path.join(root, "ckpt_wide"))
        train_and_serve(
            torch, wide_exp, train, valid, train_store, root, card, counted,
            per_step={interaction_fwd: ifwd, interaction_bwd: ibwd,
                      table_grad: tg_step_launches(wide_exp)},
            per_eval={interaction_fwd: ifwd}, per_serve={score_fwd: score_launches()},
            tag="emb_256_tower1024")
        # ---- phase 6e: sparse tables (both strategies, every kind; two fits) ----
        clock("6e")
        sparse_steps(torch, train, train_store, root, card,
                     {interaction_fwd: ifwd, interaction_bwd: ibwd, table_grad: tgs})
        sparse_fits(torch, train, valid, train_store, root, card, counted,
                    per_step={interaction_fwd: ifwd, interaction_bwd: ibwd, table_grad: tgs},
                    per_eval={interaction_fwd: ifwd}, per_serve={score_fwd: score_launches()},
                    dense=mm)
        # ---- phase 6f: host-driven training (Trainer.fit), predict --stream's path ----
        clock("6f")
        host_driven(torch, train, valid, train_store, root, card, dense=mm,
                    serve={"pred": pred, "rows": rows, "bulk": bulk}, counted=counted,
                    per_step={interaction_fwd: ifwd, interaction_bwd: ibwd, table_grad: tgs},
                    per_eval={interaction_fwd: ifwd},
                    sasrec_per_step={interaction_fwd: ifwd, interaction_bwd: ibwd,
                                     encode_fwd: enc_fwd, encode_bwd: enc_bwd,
                                     table_grad: sasrec_tgs},
                    sasrec_per_eval={interaction_fwd: ifwd, encode_fwd: enc_fwd})
        # ---- phase 6g: the model zoo, no kernel on its path ----
        clock("6g")
        zoo(torch, train, valid, train_store, root, card, counted, rows, dense=mm)
    # the training main path's launches: phase 6's fit and phase 7c's profiled
    # epochs; phase 7d's entry forwards; phase 7e's fit, serve and cases; and
    # phase 7f's CLI runs and phase 6h's sasrec_fibinet step on both ranks
    extra = {fn: long[fn] + cli[fn] + dp["launches"].get(fn, 0) for fn in counted}
    train_fwd = mm["launches"][interaction_fwd] + profiled[interaction_fwd] + entry \
        + extra[interaction_fwd]
    train_bwd = mm["launches"][interaction_bwd] + profiled[interaction_bwd] \
        + extra[interaction_bwd]
    enc_fwd_launches = enc_launches + extra[encode_fwd]
    enc_bwd_launches = sasrec["launches"][encode_bwd] + extra[encode_bwd]
    tg_total = mm["launches"][table_grad] + profiled[table_grad] + extra[table_grad]
    # the tower blocks': phase 6's fit, phase 7c's profiled epochs, phase 6h's
    # sasrec_fibinet step on both ranks, each counted from 0
    tower_total = mm["tower_launches"] + profiled_tower + dp["tower_launches"]

    # ---- phase 8: result ----
    clock("8")
    report_plans(spied, card)
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
         "launches": pipe_launches + imported + extra[score_fwd],
         "max_abs_err": worst["fused_score"],
         **timing[("fused_score", "all")], "library_ms": None},
        {"name": "sasrec_encoder_fwd", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/sasrec_encoder.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py:220",
         "launches": enc_fwd_launches, "max_abs_err": worst["sasrec_encoder_fwd"],
         **timing[("sasrec_encoder_fwd", "all")]},
        {"name": "sasrec_encoder_bwd", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/sasrec_encoder_bwd.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py:238",
         "launches": enc_bwd_launches, "max_abs_err": worst["sasrec_encoder_bwd"],
         **timing[("sasrec_encoder_bwd", "all")]},
        {"name": "table_grad", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/table_grad.cu",
         "replaces": "no TPU kernel: the library's embedding_dense_backward on the training "
                     "path (the JAX package's table gradient: "
                     "ctr_recommendation_tpu/training/sparse.py:280, a scatter-add)",
         "launches": tg_total, "max_abs_err": worst["table_grad"],
         **timing[("table_grad", "all")]},
        {"name": "tower", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/tower.cu",
         "replaces": "no TPU kernel: the library's BatchNorm, ReLU and dropout kernels after "
                     "each tower GEMM on the training path (the JAX package leaves the tower "
                     "to XLA: ctr_recommendation_tpu/ops/mlp.py)",
         "launches": tower_total, "max_abs_err": worst["tower"],
         **timing[("tower", "all")]},
    ]
    print(json.dumps({"kernels": kernels}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
