#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DBCSR on one GPU and check it.

    python3 chip_smoke.py

Phase 0  prints the card (nvidia-smi name and power limit) and builds
         the four CUDA kernels from src/repro_torch/csrc, one nvcc each,
         all started together, timing the build; decode_attention's
         (the longest) finishes in a thread beside phases 1-3, and its
         phase-1 checks run at the end of phase 3, once it is in.
Phase 1  holds each kernel against its plain PyTorch version on the card:
         smm at blocks 4, 22 and 64 (f32 and bf16), with a ragged final
         stack, valid == 0 rows and a masked plan of several size bins;
         then at the kernel's edges: blocks 4, 22, 23, 32, 33 (its two
         regimes meet at 32), 64, 100 and 22x64x16, f32 and bf16, over
         runs of 1 to 70 rows with valid == 0 rows at a run's start, end
         and over a whole 32-row triple window, and a padding run, with
         4 and with 3 triple columns (``edge_stack``);
         tiled_matmul and grouped_gemm, f32 and bf16, at ragged shapes
         and E = 1, and at the GEMM body's edges: K below one 32-deep
         slice and no multiple of it, K or N % 4 != 0, M or N of 1,
         operands at storage offset 1 (not 16-byte aligned: one-element
         copies); grouped_gemm(t, w)[e] bitwise tiled_matmul(t[e], w[e]);
         decode_attention at the four cases of the JAX package's kernel
         test, a bf16 cache, and cur_len 0, 1, 513 and S at the serve
         heads with an S that is no multiple of the kernel's 16-row tile
         (513: beside a boundary of the CTAs' row ranges), at Jamba's
         heads (32/8, Dh 128) at phase 10 (z)'s B and S, and at head
         sizes 33 and 65 (rows copied 4 bytes at a time, or by plain
         loads in bf16), f32 and bf16.
Phase 2  runs the main path, dbcsr.create -> dbcsr.multiply with
         algorithm="cannon" on a 1x1 mesh, at the size of one rank of
         the paper's 63,360^2 matrices on a 16x16 grid:
           (a) 3,960^2, block 22, blocked, dense
           (b) 4,096^2, block 64, blocked, dense
           (c) 3,960^2, block 22, blocked, A at ~20% block fill, at the
               default stack size and at stacks <= 64 (several size
               bins), plus filter_eps=0 (bitwise equal to no filter)
               and eps > 0
           (d) 3,960^2, densified, local_kernel="pallas" (tiled_matmul)
           (e) 3,960^2, densified, torch.matmul
         Each result is held against torch.matmul of the mask-applied
         dense operands (f32, TF32 off); each case's launch counters are
         zeroed just before the multiply and read just after.  Then
         (e)'s operands through distributed_matmul at every precision=
         (None, "highest", "high" = TF32, "default" = one bf16 pass):
         each product's distance from IEEE torch.matmul and its
         CUDA-event ms beside the same GEMM outside the multiply (None
         and "highest" bitwise the product without precision; "high"
         and "default" within PREC_SAME_TOL of the GEMM outside under
         the same mode, and farther from IEEE); the script's float32
         matmul settings unchanged after every call; local_kernel=
         "pallas" at "high" launches tiled_matmul, bitwise its IEEE
         product (precision_check).
Phase 3  times each kernel at the shapes of (a), (b), (c) (both stack
         sizes) and (d) (and tiled_matmul at phase 1's ragged 1,000 x 777
         x 1,030), the fused smm launch at (f) and grouped_gemm at
         (h): median of CUDA-event timings after a warm-up, beside its
         bound (the larger of flop / f32 non-tensor peak and bytes / HBM
         rate), the plain version (smm: stack by stack) and torch.matmul
         (torch.bmm for a batch) of the operands, which computes the same
         function for every timed plan (absent blocks are stored as
         zeros).  decode_attention at four shapes, bf16 caches, 8 KV
         heads of 6 query heads each (of 4 at (z)), Dh 128:
           (l) B=8, S=4,096, cur_len = S: the serve case's cache when full
           (m) B=16, S=32,768, cur_len = S: decode_32k's context
           (n) B=8, S=4,096, cur_len = 2,064: (k)'s cache half way
           (z) (n) at Jamba's 32/8 heads: phase 10 (z)'s decode
         beside its bound (q, the output and the K and V rows below
         cur_len read once), its plain version and torch's
         scaled_dot_product_attention (enable_gqa, a cur_len mask; it
         reads all S rows), a yardstick that the port never calls.
Phase 4  runs the serving path, MultiplyService(fused=True,
         algorithm="cannon") -> dbcsr.multiply_batched on a 1x1 mesh, at
         one rank of the paper's 63,360^2 matrices on a 32x32 grid
         (1,980^2 = 90^2 blocks of 22), as a k-point-style batch of 16
         requests:
           (f) 16 dense requests, blocked: one bucket, ONE smm launch
           (g) 8 dense + 8 with A at ~20% block fill, blocked: two
               buckets, two smm launches; with filter_eps None, 0 and
               in a gap of the norm products
           (h) 16 dense requests, densified, local_kernel="pallas": ONE
               grouped_gemm launch, no tiled_matmul
           (i) 16 dense requests, densified, torch.bmm
         Each case submits, flushes and collects with the launch counters
         zeroed just before and read just after; each product is held
         against torch.matmul (or, under eps > 0, against the
         per-request multiply and its mask), blocked fused results with
         eps in {None, 0} and (h)'s densified ones (one grouped_gemm
         launch against one tiled_matmul launch a request) against
         dbcsr.multiply_batched(fused=False) bitwise, and stats() must
         show every request fused with no retry, degradation or error
         ticket.  It prints the host time of the first and the repeat
         flush against the looped dispatch.  Then (h)'s 16 products
         through distributed_matmul_batched at every precision=, held
         as at (e) (torch.bmm; grouped_gemm at "high" under "pallas").
Phase 5  serves Qwen2-1.5B at full width (28 layers, d_model 1,536, 48
         query and 8 KV heads after the config's head_pad_factor 4,
         vocabulary 151,936) from seeded random weights through
         prefill_step and decode_step:
           (j) f32 (8.0 GB of weights), B=2: forward over 256 tokens
               against prefill_step over 255 plus one decode step (last
               position's logits), then 8 greedy decode steps with the
               kernel against the same 8 with decode_attention's plain
               version swapped in on the card: argmax and tokens equal,
               logits within J_TOL of max|logits|.
           (k) bf16, the config's dtype (4.0 GB of weights): 8 requests
               of 2,048-token prompts (the blockwise prefill path), the
               prefill caches padded into a max_len 4,096 cache, 32
               greedy decode steps with the launch counters zeroed just
               before and read just after (decode_attention exactly 28 per
               step, nothing else); prefill ms, decode ms/token (median
               of steps 2-32), tokens/s beside the per-step bounds of the
               weight and KV bytes; finite logits, and the first step's
               logits within K_TOL of the plain-version path, argmax
               equal.  In that first step every layer's kernel output is
               also held against the plain version on the same inputs.
               Two controls bracket K_TOL: the plain path with layer 0's
               attention output moved one bf16 step (the noise of a right
               kernel) and with the cache's first 64-row chunk skipped in
               every layer (a planted fault), which must exceed K_TOL.  A
               profiler window of 4 more steps counts the kernels a step
               launches, the device's busy share, its time a step and
               decode_attention's share of that time.
Phase 6  runs the distributed schedules through dbcsr.multiply on meshes
         whose ranks are simulated on the card (launch/mesh.py), at the
         paper's per-rank size (3,960^2: one rank of 63,360^2 on 16x16):
           (o) Cannon 4x4 (16 ranks), 15,840^2 f32, densified, with
               torch.matmul and with local_kernel="pallas" (one
               grouped_gemm launch a step over the 16 ranks)
           (p) Cannon 4x4, blocked, block 22: dense, and A at ~20 %
               block fill with filter_eps None and 0, each on the union
               plan (rank_exact=False) and rank-exact (the default: each
               rank's own plan, one smm launch a step over the 16 ranks'
               concatenated triples; bitwise the union), with per-rank
               triples and imbalance; eps > 0 rank-exact, its retained
               triples counted against the exact filter and its error
               held to the dropped-norm bound (both on the card); and
               SUMMA 4x4 on a hot-corner mask with rebalance=False and
               True (bitwise equal; the imbalance before and after)
           (q) SUMMA 4x4 at (o)'s size, bcast "psum" and "gather",
               densified pallas
           (r) 2.5D Cannon on 2x4x4 (stack 2, 32 ranks) at (o)'s size,
               reduce "all_reduce" and "reduce_scatter", densified pallas
           (s) ts_k over 16 ranks at the paper's tall-skinny shape, 1,408
               x 1,982,464 x 1,408 f32 (benchmarks/bench_vs_pgemm.py:60),
               both reduces, densified pallas; held against torch.matmul
               and an f64 product within TS_TOL
         Each case: the error against torch.matmul of the global product,
         the launch counters zeroed just before its first multiply and
         read just after, the repeat multiply's time (host clock,
         synchronized; bitwise the first), one local kernel launch's time
         (CUDA events) times its launches, torch.matmul of the global
         product (the one-card yardstick), and the bytes the schedule
         moves between ranks (Mesh.traffic); one {"phase6": [...]} line.
         Then 4 requests of 880^2 on 2x2 through multiply_batched and
         MultiplyService with algorithm="summa", blocked and densified
         pallas: fused == looped == served, bit for bit.

Phase 7  the multiply planner (repro_torch.planner): micro_calibrate on
         the card (the communication constants on a 4x4 mesh of
         simulated ranks), saved to the calibration file for this
         phase (the file is left afterwards as phase 7 found it), every
         constant printed beside DEFAULT_HARDWARE; then dbcsr.multiply(a, b,
         mesh=mesh) with no algorithm= or densify= at (a) (= (d)/(e)'s
         operands), (b), (c) mask only and at eps 0, and a tall-skinny
         1,408 x 123,904 x 1,408 on 1x1: bitwise its plan's pinned
         (algorithm, densify), within REL_TOL of torch.matmul, last_plan
         the returned plan, and host times of auto and every feasible
         pinned configuration (median of interleaved rounds) with the
         regret t_auto / t_best - 1 and predicted_s; (a) and (b) held to
         the JAX package's gate, regret <= 10 % + 1 ms.  A batch of 16 x
         1,980^2 (dense; dense with local_kernel="pallas"; 8 dense + 8 at
         20 % fill) through MultiplyService() and multiply_batched with
         no fused= or algorithm=, beside the pinned fused / looped x
         blocked / densified dispatches and, with one bucket, the
         service pinned to the plan's dispatch (fused blocked == looped
         bitwise; the dense batch held to the gate twice: auto against
         the best pinned dispatch, and MultiplyService() against the
         pinned service).  Auto on a 4x4 mesh
         of simulated ranks at (o)'s size, dense, A at 20 % fill and a
         hot corner: bitwise its pinned plan, rank imbalance and the
         rebalance decision, predicted against measured (not gated: the
         ranks share the card).  On 1x1 ``predicted_s`` charges no
         communication (one rank).  One {"phase7": ...} line.
Phase 8  purification and self-verifying multiplies:
           (u) McWeeny purification (sparsity.workloads.mcweeny_purify)
               of banded_hamiltonian(15,840, 22) on a 4x4 mesh of
               simulated ranks (3,960^2 a rank, (p)'s share), filter_eps
               1e-6, blocked smm, 6 iterations with the union plans and
               8 rank-exact; one line an iteration (occupancy, blocks,
               retained / filtered / busiest-rank triples, ||P^2 - P||,
               tr(P), smm launches and their CUDA-event time, wall, host
               = wall - smm, and the host time of the planning functions,
               exclusive, by name); the example's three properties and
               P within PUR_TOL of the exact density (the diagonal parity
               projector) for both runs; PUR_VERIFY iterations with
               verify="checksum": no detection, bitwise the unverified
               iterates, overhead against the unverified iterations run
               before and after; smm at the largest rank-exact launch of
               the peak iterate against its plain version and torch.bmm.
           (v) verify="checksum" against verify=None at (a) blocked depth
               1, (a) densified pallas, (c) at eps near the median and the
               1st percentile of the norm products, (o) densified pallas
               on 4x4 and (p) rank-exact at the median eps on 4x4, Cannon
               pinned: no detection and bitwise the unverified product;
               one-shot bitflip / nan / scale into the max-norm block:
               detected, localized exactly, repaired and bitwise clean
               wherever the change exceeds the tolerances (checked), and
               any detection repaired bitwise; a fault in every dispatch
               raises CorruptionDetectedError; the overhead (median of
               interleaved rounds) beside decide_verify's and verify=
               "auto"'s decision, against the JAX package's 25 % gate
               (printed, not fatal).  (f)'s batch of 16 under
               multiply_batched(verify=) runs looped, bitwise; fused=True
               with verify= raises.  run_injection_matrix on 1x1 and 2x2
               with the smm kernel: all green.  (v) runs in a process of
               its own (abft_process) beside (u), whose trajectories are
               host-bound planning that leaves the card idle; its lines
               are printed after (u)'s.  One {"phase8": ...} line.
Phase 9  telemetry and tensor contractions:
           (w) obs.enable() around (a) blocked on 1x1, a verify=
               "checksum" multiply at (a) with a NaN injected (multiply
               -> verify -> repair -> second dispatch, repaired bitwise,
               the abft counters), (f)'s 16 x 1,980^2 through
               MultiplyService() and through the service pinned to its
               plan (each flush split into the roots' plan and dispatch
               spans and the time outside them; the untraced gap, median
               of interleaved rounds) and (p) Cannon 4x4 rank-exact at
               20 %: per call render_breakdown, every dispatch's host
               interval beside its CUDA-event device_s, a valid Chrome
               trace, step spans summing to their dispatch within
               STEP_SUM_TOL, check_drift over the outcome rows; telemetry
               off is bitwise the traced result and adds no registry
               entry; traced against untraced at (a) and (p), median of
               interleaved rounds, beside the JAX package's 5 % gate
               (printed, not fatal).
           (x) the tensor example's integral tensor B[i,a,P] made on the
               card from a seed (its decay formula, rate 30; blocks (8,
               16, 16)) at N_I 128, N_A 1,024, N_P = N_Q 2,048 (1.07 GB
               f32), eps 1e-8: iaP,PQ->iaQ and RPA's iaP,iaQ->PQ
               (contracted 131,072 deep) on 1x1 and on a simulated 2x2:
               auto's layout, path and predicted_s, every pinned layout
               timed (median of interleaved rounds), the regret, launches,
               one traced auto call (its breakdown, the dispatch's host
               time beside device_s, a valid trace, check_drift),
               the error against torch.einsum of the unfiltered tensors
               (in f64) within REL_TOL of max|C| plus the dropped-norm
               bound (Tolerances, below), and
               at auto's layout (blocked on 1x1, densified on 2x2)
               contract bitwise the hand-matricized dbcsr.multiply.  One
               {"phase9": ...} line.
Phase 10 the MLA, MoE, Mamba and RWKV-6 layer kinds at their published
         widths in bf16, random weights from SEED, one model at a time,
         each built, served and freed before the next; only depth is cut
         (one whole period of the layer pattern, printed):
           (y) DeepSeek-V3 671B, 61 -> 4 layers (the 3 dense ones and
               one MoE layer; MLA, 256 experts top-8 with a sigmoid
               router and a shared expert, the MTP parameters): 4 prompts
               of 1,024 tokens, max_len 2,048, 16 greedy tokens
           (z) Jamba-v0.1 52B, 32 -> 8 layers (Mamba, GQA 32/8 at layer
               4, softmax MoE 16 experts top-2 at 1, 3, 5, 7): 8 prompts
               of 2,048 tokens, max_len 4,096, 16 greedy tokens
           (aa) RWKV-6 1.6B, whole: 8 prompts of 1,024, 32 greedy tokens
         Each: weights by the JAX package's init rule first, for the
         record: a forward of 1 x 64 tokens with max|x| printed after
         every layer, by kind, and whether a norm's f32 mean square
         overflows (Jamba's does: max|x| 1.2e20).  Then phase 10's
         weights, by that rule on each layer's own shape
         (``init_per_layer``; a departure, printed: the JAX rule draws a
         stack of one layer at std 1).  In f32 at full width: prefill of
         2 x 255 tokens then decode of token 256 against forward's last
         logits (drop-free capacity): argmax equal, error within
         KIND_TOL, beside the controls that bracket it.  In bf16 (the
         served dtype, the same seed): the probe again, then serving at
         the published capacity: weights and cache bytes, prefill ms and
         prompt tokens/s, decode ms a token and tokens/s with the launch
         counters zeroed before and read after (decode_attention once a
         step per attention layer, nothing else), finite logits; (z)'s
         kernel against the plain decode_attention over 8 greedy steps
         (tokens equal, 8 launches); a profiler window of 4 steps
         (launches and device time a step).  One {"phase10": ...} line.
Phase 11 trains (ROADMAP A11), printing nvidia-smi's name and power
         limit beside its numbers:
           (ab) Qwen2-1.5B whole at its published widths in bf16,
                remat "full", AdamW: 4 steps of make_train_step through
                run_loop on one batch of 4 x 2,048 tokens (data.make_batch);
                the loss must descend and every loss and grad norm be
                finite; step ms (median of steps 2-4), tokens/s, peak
                max_memory_allocated, the bound (GEMM flops at the bf16
                peak, the attention's products at the TF32 rate of its
                forward and the f32 rate of its backward), the four
                kernels' launches a step (0: printed, not gated), 2 steps
                with TF32 allowed in the backward, and a profiler window of
                one step
           (ac) 2 layers in f32, B=1, S=512: loss and every gradient leaf
                against float64 autograd of the same function on the card
                (F64_TOL); remat full and dots bitwise none; two
                microbatches against one (B=2)
           (ad) 4 layers in bf16: run_loop of 6 steps, a checkpoint every 2,
                a failure injected at step 3; final params and optimizer
                state bitwise the uninterrupted run's (under deterministic
                algorithms if not as run, naming the leaves that needed
                it); the last checkpoint restores bitwise; its bytes and
                save and restore seconds, in a temporary directory
           (ae) all ten architectures at reduced_config in f32 and bf16:
                3 AdamW steps on one batch descend and stay finite (MoE
                aux and MTP losses printed).  One {"phase11": ...} line.
         (ab)'s bound is launch.roofline's over the cost counter's meta
         count of the step (launch.cost_counter) on the card's HW; phases
         5 and 10 take their weights bound from launch.roofline too.
Phase 12 the launch tools (ROADMAP A12), on the meta device: nothing
         allocated or launched by the counts:
           (af) the dry-run grid, python -m repro_torch.launch.dryrun in
                the background on the host's CPU from the end of phase 0
                (niced, CUDA hidden): every architecture's decode_32k
                and long_500k on 1x1 and on the production mesh 32 x 8
                (rank 0's step on a meta rank mesh, its collectives
                counted), Qwen2-1.5B's, DeepSeek-V3's and Jamba's
                train_4k on 1x1 (one model of each layer kind:
                DRYRUN_GRID) and Qwen2-1.5B's and DeepSeek-V3's
                (Adafactor on cut leaves) on the production mesh, and
                prefill_32k of Qwen2-1.5B and DeepSeek-V3 on 1x1; every
                cell ok or skipped by cell_is_supported, within
                DRYRUN_BUDGET_S of its start; the table and each cell's
                seconds; beside it the CLI's A/B flags on one cell
                (DRYRUN_AB: Qwen2-1.5B's train_4k on 1x1 with --override
                head_pad_factor=1 --micro 2 --tag _ab), its record held
                to 2 microbatches, its file name to the tag and its
                argument bytes below the padded model's
           (ag) predictions held against the card: (ab)'s step counted on
                meta, its FLOPs equal to FlopCounterMode over the step on
                the card and its peak live bytes within PEAK_TOL of
                max_memory_allocated (the step alone); (k)'s decode step
                (B=8, max_len 4,096, cur_len 2,064): counted bytes at
                least the weights read plus the K and V rows below
                cur_len, its peak within PEAK_TOL; both at
                head_pad_factor 4 (the config's) and 1, in counts.
         One {"phase12": ...} line.
Phase 13 the process mesh (launch.mesh.make_process_mesh): one rank a
         process, started by launch.processes.run_ranks (spawn), meeting
         at a FileStore in a temporary directory; the kernels come from
         phase 0's build.  One card: 4 processes (2x2) and 8 (2x2x2)
         share it over gloo, every collective staged through pinned host
         memory (no NVLink number); NCCL, one card a rank, runs the same
         cases where the host has a card for every rank.  The 2x2 cases
         run in phases 14-15's 4 processes, before their LM cells (one
         spawn fewer), and are checked after that spawn.
           (ah) Cannon 2x2 at 7,920^2 (3,960^2 a rank, block 22): blocked
                dense; A at 20 % fill on the union plan, rank-exact
                (bitwise the union), rank-exact at eps 0 (bitwise the
                union) and at eps PM_EPS; densified pallas (tiled_matmul
                on a process's one rank); verify="checksum" with one
                injected fault (repaired bitwise the dense blocked C);
                SUMMA 2x2 psum and gather, densified pallas; 2.5D
                Cannon 2x2x2 at 7,920^2, both reduces, blocked
           (ai) ts_k on 4 ranks at 1,408 x 495,616 x 1,408 (123,904 deep
                a rank, as (s)), both reduces, densified pallas
           (aj) batched SUMMA 2x2, 4 x 880^2 at block 22, fused and
                looped (bitwise each other)
         Each process makes a warm-up call, then one timed call with its
         launch counters zeroed before it and read after it (smm for the
         blocked cases, tiled_matmul for the densified: > 0 on every
         process) and smm's CUDA-event time; every process's C is the
         same bit for bit; mesh rank 0 runs the case on an in-process
         mesh on its card and holds the two bitwise where the collectives
         only move data, within REL_TOL of max|C| where they add (2.5D,
         ts_k), and holds C against torch.matmul of the global operands
         (TS_TOL for ts_k; not at eps > 0); the traffic summed over the
         processes equals the in-process mesh's count.  One
         {"phase13": ...} line.
Phases 14-15 the LM on a process mesh (repro_torch.models on
         make_process_mesh: tensor-, data- and expert-parallel): one
         spawn of 4 processes on the card over host-staged gloo (one
         card holds no two NCCL ranks), a 2x2 and a 1x4 mesh over the
         same processes (LM_CELLS), each process holding its shards of
         the weights, the optimizer state, the batch and the caches;
         weights by init_per_layer's rule from SEED, the same draws on
         one rank in this process (drawn one process at a time:
         init_params on a shared card).  Phase 14:
           (ak) Qwen2-1.5B in bf16 at its published widths, 8 of its 28
                layers: AdamW with ZeRO, 2 steps of 4 x 2,048 tokens,
                the step-2 checkpoint (each leaf gathered, one writer),
                prefill of 2 x 256 and 8 greedy tokens (decode_attention
                on every process's own KV heads), then step 3; on one
                rank the same 3 steps from the same weights, and from
                the checkpoint the same prefill and tokens
                (teacher-forced on the mesh's) and step 3
           (al) DeepSeek-V3 in bf16 at its published widths, 4 of 61
                layers (3 dense, one MoE, as (y)): prefill of 4 x 1,024
                and 16 greedy tokens, the MoE on its partial path (the
                step's tokens gathered, the experts left cut over data);
                the same on one rank, teacher-forced
         Phase 15, Mamba and RWKV-6 cut over model, Adafactor on a cut
         and the dry-run's count of one rank:
           (am) Jamba-v0.1 in bf16 at its published widths, one whole
                period (32 -> 8 layers) on 1x4: prefill of 4 x 1,024 and
                16 greedy tokens, Mamba cut on its inner width, the MoE
                expert-parallel, decode_attention on each process's two
                KV heads; its median row error against one rank held to
                one rank's own bf16 distance from f32 at the same
                prompts and tokens; in f32 prefill of 2 x 256 and 4
                tokens held at F32_ROW_TOL
           (an) RWKV-6 in bf16 at its published widths, 24 -> 6 layers,
                on 2x2 (time mix cut by heads, channel mix on d_ff):
                prefill of 4 x 512 and 16 greedy tokens, held as (am);
                in f32 the same prompts and tokens at F32_ROW_TOL, then
                one ZeRO AdamW step of 4 x 512 and the loss after it at
                F32_* (rank 0 under FlopCounterMode)
           (ao) Qwen2-1.5B in bf16, 8 of 28 layers, on 2x2: one
                Adafactor step of 4 x 1,024 (its factored means and
                update clipping over leaves cut by model) and the loss
                after it against one rank's
           (ap) rank 0 of (an)'s f32 step counted on a meta rank mesh
                (launch.mesh.make_meta_rank_mesh, as the dry-run counts
                a production cell), in a thread during the spawn: its
                FLOPs equal to FlopCounterMode over rank 0's step on the
                card and its collective bytes by kind equal to rank 0's
                traffic; its roofline terms beside the step's time.
         Then, in the same spawn, (ak)'s model on 2x2 with the sequence-
         parallel residual (cfg.sequence_parallel: each rank keeps its
         half of the sequence's rows between layers) against without:
         one ZeRO AdamW step of 4 x 2,048 each from the same weights and
         batch, the loss and gradient norm held at SP_LOSS_TOL /
         SP_GNORM_TOL, the step ms, each process's peak
         max_memory_allocated and the bytes a rank received.
         Step ms and tokens/s, prefill ms, decode ms a token, bytes a
         rank received, decode_attention launches a process, and each
         comparison's error against one rank, held to the tolerances
         at LM_* and F32_* below.  One {"phase14": ...} line.
Phase 16 the smm sweep and the H100 winners table on the main path (the
         table, artifacts/smm_autotune_h100.json, is the repository's
         whatever the working directory: use_repo_table):
           the sweep, autotune.tune_block at block 22 on 180^2 blocks
           (3,960^2, the main path's grid) at fills 1.0 and 0.2 on the
           card: each tile's time and rate, each row's stacks and
           triples held to its plan's;
           (a), (b) and (c) (A at ~20 % block fill) through
           dbcsr.multiply with no stack size: the tile and source the
           table gives (winners[...]), the multiply's plan ran them, its
           product bitwise the same product at stack_size=30000 (a stack
           never splits a C block's run, so the kernel adds in the same
           order; where it is not, the first differing block is printed
           and the product held to REL_TOL of max|C|), and the smm
           kernel's CUDA-event ms at both tiles in turns beside PERF.md
           section 6's.  One {"phase16": ...} line.
         Phases 2, 3 and 6 build the plans they hold launches and times
         to at the tile the table gives (table_tile).
``--phase 9`` (or 10, 11, 12, 13, 14, 16) builds the kernels and runs
that phase alone (development: no kernels line and no ok line); 15 runs
14.

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits nonzero before that line.  Without CUDA it exits 1 at once.

Tolerances.  Kernel vs plain and port vs torch.matmul are both f32 sums
of the same products in different orders; errors are held to 1e-5 of
max|C| (bf16 inputs are exact in f32, so the same bound holds).
decode_attention: 2e-4 (rtol and atol, the JAX package's kernel test) in
f32; with bf16 q and caches its bf16 output may lie one bf16 step from
the plain version's f32 output rounded to bf16, which ``bf16_worst``
allows and no more.  Phase 5: J_TOL and K_TOL below, each stated beside the value
observed.  Phase 9 (x): against torch.einsum in f64 of the unfiltered
tensors, REL_TOL of max|C| plus the dropped-norm bound (the largest sum
of norm products eps drops from one C block).  A densified product is
torch.matmul's f32 sum, which at RPA's 131,072-deep contraction misses
REL_TOL itself (the f32 torch.einsum: 6.3e-5 of max|C| on an H100, the
smm path 1.7e-6): such a product is held to twice the f32 einsum's
error, measured in the same run, where that exceeds REL_TOL.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-5
SEED = 0
DA_TOL = 2e-4        # decode_attention vs plain, f32 (rtol and atol)
# phase 5: max |logits - reference| / max |reference|.  f32 (j): the same
# model computed along two paths (full causal attention vs the cache and
# the decode kernel; kernel vs plain decode), observed 4.0e-5 and 6.9e-5
# on an H100: f32 rounding, amplified by the JAX package's init rule
# (std 1/sqrt(layers) on every stacked weight), which gives attention
# scores of size ~50.  bf16 (k): both paths keep the softmax weights in
# f32 and differ only in summation order, but an output that rounds to
# the neighbouring bf16 value in one layer moves the next layers' scores,
# and 28 layers carry it to the logits: observed 5.0e-2 (argmax equal).
# Its controls on an H100: the plain path with layer 0's output one bf16
# step up, 7.9e-2 (one argmax moved); with the first 64-row chunk skipped
# in every layer, 1.05.  K_TOL lies between them; the tight check of the
# kernel on (k)'s inputs is the per-layer one (one bf16 step).
J_TOL = 3e-4
K_TOL = 1e-1
# phase 6 (s): each rank sums 123,904 products in f32 in one sequence (the
# GEMM body's K loop), then the 16 partials are added.  Such a sum's
# rounding error has a standard deviation of about u*K_r/sqrt(6)*sqrt(16)
# = 0.012 (u = 2**-24), against max|C| = 5.1*sqrt(K) = 7,200: 1.7e-6 of
# max|C| typically and ~9e-6 at the worst of 2 M outputs, while
# torch.matmul has its own error of the same kind.  1e-5 (REL_TOL, set for
# k ~ 4,000) does not hold at K = 1,982,464; TS_TOL is 4x the estimate, and
# the script also prints both sides against an f64 product.
TS_TOL = 4e-5


def edge_stack(rng, na, nb, nc):
    """(S, 4) int32 triples whose runs cover the smm kernel's edges: runs
    of 1 to 70 rows (longer than its 3-stage ring and its 32-row triple
    window), valid == 0 rows at a run's start, at its end, every third
    row and over a whole window, and a padding run on the scratch block
    ``nc``, which ``stack_run_starts`` leaves out.  A and B indices are
    random, so odd (for bf16: not 16-byte aligned) blocks occur."""
    import numpy as np

    lens = [1, 2, 3, 4, 5, 33, 70, 32, 31]
    cs = rng.permutation(nc)[:len(lens)]
    rows = []
    for r, (n, c) in enumerate(zip(lens, cs)):
        valid = np.ones(n, dtype=int)
        if r == 2:
            valid[0] = 0
        if r == 3:
            valid[-1] = 0
        if r == 5:
            valid[1::3] = 0
        if r == 6:
            valid[:36] = valid[-1] = 0
        rows.append(np.stack([rng.randint(0, na, n), rng.randint(0, nb, n),
                              np.full(n, c), valid], axis=1))
        if r == 4:
            rows.append(np.tile([0, 0, nc, 0], (3, 1)))
    return np.concatenate(rows).astype(np.int32)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def use_repo_table():
    """Point the smm winners-table lookup at the repository's
    ``artifacts/smm_autotune_h100.json`` whatever the working directory
    (the executor and the planner read it when no stack size is pinned)."""
    from repro_torch.kernels.smm import autotune

    autotune.DEFAULT_CACHE = os.path.join(REPO, "artifacts",
                                          "smm_autotune_h100.json")


def table_tile(block: int, nb: int, pair_mask=None, rank_masks=None) -> int:
    """The stack tile the executor resolves, without a pinned stack size,
    for an (nb x nb x nb)-block product at ``block`` with these masks:
    the winners table's entry for its occupancy bin (a rank-exact step's
    busiest rank's), or the heuristic."""
    from repro_torch.core.engine import _mask_fill
    from repro_torch.kernels.smm.autotune import best_params_for

    fills = [_mask_fill(nb, nb, nb, rm.get("a_mask"), rm.get("b_mask"),
                        rm.get("pair_mask"))
             for rm in (rank_masks or [{"pair_mask": pair_mask}])]
    return best_params_for(block, block, block, fill=max(fills))[1]


def rel_err(x, ref) -> float:
    """max |x - ref| / max |ref|, in float32."""
    x, ref = x.float(), ref.float()
    scale = float(ref.abs().max())
    return float((x - ref).abs().max()) / (scale if scale else 1.0)


def check_close(what: str, x, ref, tol: float = REL_TOL) -> float:
    err = rel_err(x, ref)
    print(f"  {what}: max err / max|C| = {err:.3e}")
    if not err <= tol:
        raise AssertionError(f"{what}: relative error {err:.3e} > {tol:g}")
    return float((x - ref).abs().max())


def bf16_worst(out, ref) -> float:
    """How far a bf16 output lies from the plain version's f32 one, rounded
    to bf16, in units of the slack a right kernel needs: one bf16 step at
    the element (f32 values that differ only by summation order round to
    the same or to neighbouring bf16 values) plus 2**-16 max|ref| for that
    f32 difference itself, which matters only where an output cancels to
    near zero.  A right kernel stays at or below 1."""
    import torch

    out, ref = out.float(), ref.float()
    rounded = ref.to(torch.bfloat16).float()
    big = torch.maximum(out.abs(), rounded.abs())
    # bf16 values in [2**(e-1), 2**e) are 2**(e-8) apart
    step = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    tol = step + 2.0 ** -16 * float(ref.abs().max())
    return float(((out - rounded).abs() / tol).max())


def time_ms(fn, reps: int, setup=None, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call.  With inner > 1 the host's work for one call overlaps
    the card's work for the one before."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def attention_swaps(decode_attention, decode_attention_ref):
    """(model_decode, plain_f32, plain_decode, swapped): the model's decode
    attention (the kernel's caller), its plain version in f32 and in the
    query's dtype, and ``swapped(fn, *args, attn=..., launches=...)``,
    which runs fn(*args) with the model's decode attention replaced by
    ``attn`` (default: the plain version) and checks that it launched the
    kernel ``launches`` times."""
    from repro_torch.models import attention as attention_mod

    model_decode = attention_mod.decode_attention   # the kernel's caller

    def plain_f32(q, k_cache, v_cache, cur_len, scale):
        b, _, h, dh = q.shape
        qg = q.reshape(b, k_cache.shape[2], -1, dh)
        out = decode_attention_ref(qg, k_cache, v_cache, cur_len, scale)
        return out.reshape(b, 1, h, dh)

    def plain_decode(q, k_cache, v_cache, cur_len, *, scale):
        return plain_f32(q, k_cache, v_cache, cur_len, scale).to(q.dtype)

    def swapped(fn, *args, attn=plain_decode, launches=0):
        before = decode_attention.launches
        attention_mod.decode_attention = attn
        try:
            return fn(*args)
        finally:
            attention_mod.decode_attention = model_decode
            if decode_attention.launches - before != launches:
                raise AssertionError(
                    f"{attn.__name__} launched the kernel "
                    f"{decode_attention.launches - before} times")

    return model_decode, plain_f32, plain_decode, swapped


def step_logits(params, cfg, tok, cache, cur):
    """decode_step's forward: (B, V) logits of one step; the cache is
    written in place."""
    from repro_torch.models import transformer as T

    return T.forward(params, tok, cfg, cache=cache, cur_len=cur)[0][:, -1]


PREC_NAMES = (None, "highest", "high", "default")
PREC_REPS = 10
PREC_SAME_TOL = 1e-6   # "high" / "default" against the same mode taken
                       # outside the multiply (one cuBLAS call each way)


def precision_check(label, a, b, mesh, zero_counters, read_counters,
                    card) -> list:
    """``precision=`` on the densified path at ``label``'s operands (one
    product (M, K) @ (K, N) through distributed_matmul, or a batch
    (G, M, K) @ (G, K, N) through distributed_matmul_batched), Cannon on
    ``mesh``: each name's product, its max |C - IEEE| / max |IEEE|
    against torch.matmul / torch.bmm in IEEE f32 of the same operands
    and its CUDA-event ms, beside the same GEMM taken outside the
    multiply under the same mode.  None and "highest" are bitwise the
    multiply's product without precision; "high" (TF32) and "default"
    (one bf16 pass, f32 accumulation) lie within PREC_SAME_TOL of the
    GEMM outside and farther than 10x that distance from IEEE, so the
    mode is applied; the script's float32 matmul settings are unchanged
    after every call.  local_kernel="pallas" at "high" launches its
    kernel (the counters zeroed before, read after) and is bitwise its
    IEEE product.  Returns one row a name."""
    import torch

    from repro_torch.core.multiply import distributed_matmul
    from repro_torch.core.multiply_batched import distributed_matmul_batched

    batched = a.ndim == 3
    fn = distributed_matmul_batched if batched else distributed_matmul
    op = torch.bmm if batched else torch.matmul
    kernel = "grouped_gemm" if batched else "tiled_matmul"
    flags = torch.backends.cuda.matmul

    def settings():
        return (torch.get_float32_matmul_precision(), flags.allow_tf32,
                flags.allow_bf16_reduced_precision_reduction)

    def call(prec, **kw):
        return fn(a, b, mesh=mesh, algorithm="cannon", densify=True,
                  precision=prec, **kw)

    def outside(prec):
        """The GEMM of the operands under ``prec``'s mode, set here."""
        if prec == "default":
            caller = flags.allow_bf16_reduced_precision_reduction
            flags.allow_bf16_reduced_precision_reduction = False
            try:
                return (torch.bmm if batched else torch.mm)(
                    a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
            finally:
                flags.allow_bf16_reduced_precision_reduction = caller
        caller = flags.allow_tf32
        flags.allow_tf32 = prec == "high"
        try:
            return op(a, b)
        finally:
            flags.allow_tf32 = caller

    before = settings()
    ieee = outside(None)
    today = call(None)
    rows = []
    for prec in PREC_NAMES:
        c = call(prec)
        torch.cuda.synchronize()
        if settings() != before:
            raise AssertionError(f"{label} precision={prec!r}: the script's "
                                 f"settings {before} became {settings()}")
        row = {"case": label, "precision": prec, "err_vs_ieee":
               rel_err(c, ieee),
               "ms": time_ms(lambda: call(prec), PREC_REPS),
               "gemm_ms": time_ms(lambda: outside(prec), PREC_REPS),
               "card": card}
        if prec in (None, "highest"):
            row["bitwise_none"] = torch.equal(c, today)
            if not row["bitwise_none"]:
                raise AssertionError(f"{label} precision={prec!r}: not "
                                     "bitwise the product without precision")
        else:
            row["err_vs_outside"] = rel_err(c, outside(prec))
            if not (row["err_vs_outside"] <= PREC_SAME_TOL
                    and row["err_vs_ieee"] > 10 * max(row["err_vs_outside"],
                                                      1e-7)):
                raise AssertionError(
                    f"{label} precision={prec!r}: {row['err_vs_outside']:.3e}"
                    f" from the same mode outside the multiply, "
                    f"{row['err_vs_ieee']:.3e} from IEEE")
        print(f"  {label} precision={prec!r}: max|C - IEEE| / max|IEEE| "
              f"{row['err_vs_ieee']:.3e}"
              + (f", {row['err_vs_outside']:.3e} from the same GEMM outside"
                 if "err_vs_outside" in row else
                 f", bitwise no precision: {row['bitwise_none']}")
              + f"; {row['ms']:.3f} ms through the multiply, the GEMM alone "
              f"{row['gemm_ms']:.3f} ms ({card})")
        rows.append(row)
        del c
    zero_counters()
    c = call("high", local_kernel="pallas")
    torch.cuda.synchronize()
    got = read_counters()
    same = torch.equal(c, call(None, local_kernel="pallas"))
    print(f"  {label} local_kernel='pallas', precision='high': {kernel} "
          f"launches {got[kernel]}, bitwise its IEEE product: {same}")
    if got[kernel] < 1 or not same:
        raise AssertionError(f"{label} pallas at 'high': launches {got}, "
                             f"bitwise {same}")
    print(json.dumps({"precision": rows}))
    return rows


def sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def serve_lm(dev, zero_counters, read_counters, decode_attention,
             decode_attention_ref, hw) -> dict:
    """Phase 5: serve Qwen2-1.5B at full width; returns the decode
    kernel's main-path numbers for the kernels line."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.roofline import memory_bound_s
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serve import engine
    from repro_torch.serve.prefill import prefill_step

    model_decode, plain_f32, plain_decode, swapped = attention_swaps(
        decode_attention, decode_attention_ref)

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    base = get_config("qwen2_1_5b")
    gen = torch.Generator(device=dev)

    # ------------------------------------------------------------ (j)
    cfg = dataclasses.replace(base, dtype="float32")
    print(f"phase 5 (j): {cfg.name} full width in f32, B=2")
    params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"  weights {n_bytes / 1e9:.2f} GB, {cfg.num_layers} layers")
    seq = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                        dtype=torch.int32, device=dev)
    full = T.forward(params, seq, cfg)[0]
    want_next, want_last = full[:, 254].argmax(-1), full[:, -1].clone()
    del full
    tok, pcache, cur = prefill_step(params, seq[:, :255], cfg)
    if not torch.equal(tok[:, 0], want_next.int()):
        raise AssertionError("(j) prefill's next token != forward's argmax")
    cache = engine.pad_cache(pcache, cfg, 2, 272)
    del pcache
    last = step_logits(params, cfg, seq[:, 255:], cache, cur)
    err = rel_err(last, want_last)
    same = torch.equal(last.argmax(-1), want_last.argmax(-1))
    print(f"  forward(256) vs prefill(255) + decode: max err / max|logits| "
          f"{err:.3e} (tolerance {J_TOL:g}), argmax equal {same}")
    if not (err <= J_TOL and same):
        raise AssertionError("(j) prefill + decode != forward")
    tok0, cur = last.argmax(-1, keepdim=True).int(), cur + 1

    def greedy(cache, steps=8):
        tok, c, toks, logits = tok0, cur, [], []
        for _ in range(steps):
            lg = step_logits(params, cfg, tok, cache, c)
            tok, c = lg.argmax(-1, keepdim=True).int(), c + 1
            toks.append(tok)
            logits.append(lg)
        return torch.cat(toks, 1), logits

    cache_plain = clone(cache)
    toks_k, logits_k = greedy(cache)
    toks_p, logits_p = swapped(greedy, cache_plain)
    errs = [rel_err(a, b) for a, b in zip(logits_k, logits_p)]
    print(f"  8 decode steps, kernel vs plain decode_attention: tokens equal "
          f"{torch.equal(toks_k, toks_p)}, max err / max|logits| "
          f"{max(errs):.3e} (tolerance {J_TOL:g})")
    if not (torch.equal(toks_k, toks_p) and max(errs) <= J_TOL):
        raise AssertionError("(j) kernel decode != plain decode")
    del params, cache, cache_plain, logits_k, logits_p
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (k)
    cfg = base
    B, S, MAX_LEN, STEPS = 8, 2048, 4096, 32
    print(f"phase 5 (k): {cfg.name} full width in {cfg.dtype}, {B} requests "
          f"of {S} tokens, max_len {MAX_LEN}, {STEPS} greedy tokens")
    params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32, device=dev)
    prefill_step(params, prompts[:1, :64], cfg)          # warm-up
    (tok, pcache, cur), prefill_s = sync_time(
        lambda: prefill_step(params, prompts, cfg))
    cache = engine.pad_cache(pcache, cfg, B, MAX_LEN)
    del pcache
    kv_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    print(f"  weights {w_bytes / 1e9:.2f} GB, KV cache {kv_bytes / 1e9:.2f} GB; "
          f"prefill {1e3 * prefill_s:.1f} ms "
          f"({B * S / prefill_s:.0f} prompt tokens/s)")

    # first step along several paths; each writes its own K and V at
    # cur_len before reading the cache, so every path is self-consistent
    def faulty(q, k_cache, v_cache, cur_len, *, scale):
        """the plain version, blind to the cache's first 64-row chunk"""
        return plain_decode(q, k_cache[:, 64:], v_cache[:, 64:],
                            cur_len - 64, scale=scale)

    layer_worst, layer_fault = [], []

    def checked(q, k_cache, v_cache, cur_len, *, scale):
        """the kernel, held against the plain version on the same inputs,
        beside the planted fault on them"""
        out = model_decode(q, k_cache, v_cache, cur_len, scale=scale)
        ref = plain_f32(q, k_cache, v_cache, cur_len, scale)
        layer_worst.append(bf16_worst(out, ref))
        layer_fault.append(bf16_worst(
            faulty(q, k_cache, v_cache, cur_len, scale=scale), ref))
        return out

    calls = [0]

    def nudged(q, k_cache, v_cache, cur_len, *, scale):
        """the plain version, layer 0's output one bf16 step up"""
        out = plain_decode(q, k_cache, v_cache, cur_len, scale=scale)
        calls[0] += 1
        if calls[0] == 1 and out.dtype == torch.bfloat16:
            out = (out.view(torch.int16) + 1).view(torch.bfloat16)
        return out

    first_p = swapped(step_logits, params, cfg, tok, cache, cur)
    first_k = swapped(step_logits, params, cfg, tok, cache, cur, attn=checked,
                      launches=cfg.num_layers)
    first_n = swapped(step_logits, params, cfg, tok, cache, cur, attn=nudged)
    first_f = swapped(step_logits, params, cfg, tok, cache, cur, attn=faulty)
    err_k, err_n, err_f = (rel_err(x, first_p)
                           for x in (first_k, first_n, first_f))
    same = torch.equal(first_k.argmax(-1), first_p.argmax(-1))
    print(f"  first decode step, each layer's kernel output vs plain on the "
          f"same inputs: worst / one bf16 step {max(layer_worst):.3f} "
          f"over {len(layer_worst)} layers; first chunk skipped "
          f"{min(layer_fault):.3g} to {max(layer_fault):.3g}")
    print(f"  first decode step vs the plain path, max err / max|logits|: "
          f"kernel {err_k:.3e} (tolerance {K_TOL:g}), argmax equal {same}; "
          f"controls: layer 0 one bf16 step up {err_n:.3e} (argmax equal "
          f"{torch.equal(first_n.argmax(-1), first_p.argmax(-1))}), first "
          f"chunk skipped {err_f:.3e}")
    if not (len(layer_worst) == cfg.num_layers and max(layer_worst) <= 1.0):
        raise AssertionError("(k) a layer's kernel output is off its plain "
                             "version")
    if not max(layer_fault) > 1.0:
        raise AssertionError("(k) the per-layer check cannot see a skipped "
                             "chunk")
    if not (bool(torch.isfinite(first_k).all()) and err_k <= K_TOL and same):
        raise AssertionError("(k) first-step logits off the plain path")
    if not err_f > K_TOL:
        raise AssertionError("(k) K_TOL cannot tell a skipped chunk from "
                             "the plain path")
    del first_p, first_k, first_n, first_f

    state = {"cache": cache, "cur_len": cur}
    zero_counters()
    step_s, toks = [], [tok]
    for _ in range(STEPS):
        (tok, state), dt = sync_time(
            lambda: engine.decode_step(params, state, tok, cfg))
        step_s.append(dt)
        toks.append(tok)
    got = read_counters()
    want = {key: 0 for key in got}
    want["decode_attention"] = cfg.num_layers * STEPS
    print(f"  launches over {STEPS} decode steps: {got}")
    if got != want:
        raise AssertionError(f"(k) launches {got}, expected {want}")
    toks = torch.cat(toks, 1)
    if toks.shape != (B, STEPS + 1) or int(state["cur_len"][0]) != S + STEPS:
        raise AssertionError("(k) wrong token or cache length")
    final = step_logits(params, cfg, tok, state["cache"], state["cur_len"])
    if not bool(torch.isfinite(final).all()):
        raise AssertionError("(k) non-finite logits")
    step = statistics.median(step_s[1:])
    cur_mid = S + STEPS // 2
    kv_valid = kv_bytes * cur_mid / MAX_LEN
    w_ms, kv_ms, kv_all_ms = (1e3 * memory_bound_s(x, hw)
                              for x in (w_bytes, kv_valid, kv_bytes))
    print(f"  decode: {1e3 * step:.3f} ms/token (median of steps 2-{STEPS}; "
          f"first {1e3 * step_s[0]:.3f} ms), {B / step:.1f} tokens/s; "
          f"bounds per step: weights {w_ms:.3f} ms, KV rows < cur_len "
          f"{kv_ms:.3f} ms (the kernel reads only those; all {MAX_LEN} "
          f"rows: {kv_all_ms:.3f} ms)")

    busy = profile_steps(params, cfg, engine, state, tok)
    return {"serve": {
        "prefill_ms": 1e3 * prefill_s, "decode_ms_per_token": 1e3 * step,
        "tokens_per_s": B / step, "weight_bound_ms": w_ms,
        "kv_bound_ms": kv_ms, "profile": busy}}


def profile_steps(params, cfg, engine, state, tok, steps=4) -> dict:
    """Kernels per decode step, the device's busy share and busy time a
    step, and decode_attention's kernel time a step and share of the busy
    time, over a window of ``steps`` steps, from torch.profiler; {} if the
    profiler records no device activity here."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            tok, state = engine.decode_step(params, state, tok, cfg)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    attn_us = sum(e.time_range.end - e.time_range.start for e in kernels
                  if "decode_attention" in e.name)
    if not spans:
        print("  profiler: no device activity recorded (busy share not "
              "measured)")
        return {}
    busy, end = 0.0, float("-inf")
    for a, b in spans:          # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    out = {"kernels_per_step": len(spans) / steps,
           "busy_share": busy / wall_us,
           "wall_ms_per_step": wall_us / steps / 1e3,
           "device_ms_per_step": busy / steps / 1e3,
           "decode_attention_ms_per_step": attn_us / steps / 1e3,
           "decode_attention_share": attn_us / busy}
    print(f"  profiler, {steps} steps: {out['kernels_per_step']:.0f} kernels "
          f"per step, device busy {100 * out['busy_share']:.1f} % of "
          f"{out['wall_ms_per_step']:.3f} ms per step: "
          f"{out['device_ms_per_step']:.3f} ms of device time a step, of "
          f"which decode_attention {out['decode_attention_ms_per_step']:.3f} "
          f"ms ({100 * out['decode_attention_share']:.1f} %)")
    return out


# ---------------------------------------------------------------------------
# phase 10: the MLA, MoE, Mamba and RWKV-6 layer kinds at full width
# ---------------------------------------------------------------------------

# (cell, arch, depth cut, B, prompt tokens, max_len, greedy tokens).  The
# published widths stay; only depth is cut, keeping one whole period of
# the layer pattern (the leading dense layers count once).
KIND_CELLS = (
    ("(y)", "deepseek_v3_671b", {"num_layers": 4}, 4, 1024, 2048, 16),
    ("(z)", "jamba_v0_1_52b", {"num_layers": 8}, 8, 2048, 4096, 16),
    ("(aa)", "rwkv6_1_6b", {}, 8, 1024, 2048, 32),
)
KIND_CHECK = (2, 256)   # prefill + decode against forward: B, S
# max |logits - forward's| / max |forward's| of one f32 decode step
# against the teacher-forced f32 forward at full width (J_TOL's
# derivation): the two paths differ in summation order and, for MLA, in
# the contraction order (the absorbed decode contracts wk_b into the
# query, the expanded prefill into the keys).  f32, not the served bf16:
# bf16 rounding differs between the paths by ~4e-3, enough to swap a
# token's k-th expert where two router scores lie that close, and one
# swapped expert moves the logits by ~1 (a bf16 version of this check
# moved Jamba's argmax on an H100).  Bracketed in every run by two
# controls: the decode step with layer 0's output one ulp up (the noise
# of a right path), printed, and with every cache zeroed (a planted
# fault: the prompt's state lost), which must exceed it.  Observed on an
# H100: (y) 4.9e-6, (z) 1.4e-5, (aa) 4.7e-5 (one ulp in layer 0: 4.4e-6,
# 1.4e-5, 5.5e-5; every cache zeroed: 1.32, 1.40, 1.47).
KIND_TOL = 3e-4


def init_per_layer(cfg, generator, device, **mesh_kw):
    """Random parameters by the JAX package's rule applied to each
    layer's own shape: std scale / sqrt(n), n the first dim of the leaf
    without its layer axis (the JAX rule reads the layer count there: std
    1 for a stack of one layer).  ``mesh_kw`` (mesh, specs) draws a
    process's shards of the same tensors (``init_params``)."""
    import dataclasses
    import math

    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.common import ParamDef, init_params, tree_map

    def per_layer(d):
        if d.init in ("zeros", "ones"):
            return d
        layer = d.shape[1:]
        n = layer[0] if len(layer) > 1 else max(layer[-1], 1)
        # init_params divides by sqrt(shape[0]), the layer count
        return dataclasses.replace(d, scale=d.scale * math.sqrt(d.shape[0] / n))

    defs = T.model_defs(cfg)
    defs["segments"] = tree_map(per_layer, defs["segments"],
                                is_leaf=lambda x: isinstance(x, ParamDef))
    return init_params(defs, generator, dtype_override=getattr(torch, cfg.dtype),
                       device=device, **mesh_kw)


def layer_trace(fn):
    """fn() with every layer's output recorded: [(kind, max|x|, whether
    the next norm's f32 mean square is finite)]."""
    import torch

    from repro_torch.models import transformer as T

    rows, inner = [], T._apply_layer

    def traced(kind, *args, **kw):
        x, aux, nc = inner(kind, *args, **kw)
        xf = x.float()
        rows.append((kind, float(xf.abs().max()),
                     bool(torch.isfinite(xf.square().mean(-1)).all())))
        return x, aux, nc

    T._apply_layer = traced
    try:
        return fn(), rows
    finally:
        T._apply_layer = inner


def healthy(rows, logits) -> bool:
    """Every layer's output finite and inside the norm's f32 range, and
    the logits finite and not all equal (a norm that overflows to inf
    outputs zeros, and the logits of a zero hidden state are constant)."""
    import torch

    return (all(ok and x < float("inf") for _, x, ok in rows)
            and bool(torch.isfinite(logits).all())
            and float(logits.float().std()) > 0)


def print_layers(rows):
    by_kind = {}
    for kind, x, ok in rows:
        by_kind.setdefault(kind, []).append((x, ok))
    for kind, xs in by_kind.items():
        print(f"    {kind[0]}/{kind[1]} ({len(xs)} layers): max|x| "
              + ", ".join(f"{x:.3g}" for x, _ in xs)
              + ("" if all(ok for _, ok in xs)
                 else "  (the next norm's f32 mean square overflows)"))


def layer_kinds(dev, card, zero_counters, read_counters, decode_attention,
                decode_attention_ref, hw) -> list:
    """Phase 10: DeepSeek-V3 (MLA, sigmoid MoE, MTP), Jamba (Mamba, GQA,
    softmax MoE) and RWKV-6 at their published widths in bf16, served
    through prefill_step / decode_step; returns one summary per model."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.roofline import memory_bound_s
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serve import engine
    from repro_torch.serve.prefill import prefill_step

    model_decode, _, _, swapped = attention_swaps(decode_attention,
                                                  decode_attention_ref)
    gen = torch.Generator(device=dev)
    out, failed = [], []

    def check(ok: bool, what: str):
        """a failed check is printed and raised after the last model, so
        that one run shows every model's numbers"""
        if not ok:
            print(f"  FAILED: {what}")
            failed.append(what)

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    def probe_layers(params, cfg) -> bool:
        probe = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                              dtype=torch.int32, device=dev)
        logits, rows = layer_trace(lambda: T.forward(params, probe, cfg)[0])
        print_layers(rows)
        return healthy(rows, logits)

    def decode_check(params, cfg):
        """prefill S-1 tokens, decode token S; max err / max|logits|
        against forward's last logits, argmax equal, and the two
        controls: layer 0's output one ulp up in the decode step, and
        every cache zeroed before it"""
        cb, cs = KIND_CHECK
        seq = torch.randint(0, cfg.vocab_size, (cb, cs), generator=gen,
                            dtype=torch.int32, device=dev)
        want = T.forward(params, seq, cfg)[0][:, -1].float()
        _, pcache, cur = prefill_step(params, seq[:, :-1], cfg)
        cache = engine.pad_cache(pcache, cfg, cb, cs + 16)
        del pcache

        def first_step(nudge=False, zero=False):
            c = clone(cache)
            if zero:
                tree_map(lambda t: t.zero_(), c)
            inner, calls = T._apply_layer, [0]

            def nudged(*args, **kw):
                x, aux, nc = inner(*args, **kw)
                calls[0] += 1
                if calls[0] == 1:       # one ulp up, in x's own dtype
                    bits = torch.int16 if x.element_size() == 2 else torch.int32
                    x = (x.view(bits) + 1).view(x.dtype)
                return x, aux, nc

            T._apply_layer = nudged if nudge else inner
            try:
                return step_logits(params, cfg, seq[:, -1:], c, cur).float()
            finally:
                T._apply_layer = inner

        got = first_step()
        ok = bool(torch.isfinite(got).all())
        same = torch.equal(got.argmax(-1), want.argmax(-1))
        err, err_n, err_f = (rel_err(x, want) for x in (
            got, first_step(nudge=True), first_step(zero=True)))
        print(f"  {cfg.dtype}: forward({cb} x {cs}) vs prefill({cs - 1}) + "
              f"decode: max err / max|logits| {err:.3e} (tolerance "
              f"{KIND_TOL:g}), argmax equal {same}; controls: layer 0's "
              f"output one ulp up {err_n:.3e}, every cache zeroed "
              f"{err_f:.3e}")
        return ok and same and err <= KIND_TOL, err, err_n, err_f

    for cell, arch, cut, B, S, MAX_LEN, STEPS in KIND_CELLS:
        base = get_config(arch)
        cfg = dataclasses.replace(base, **cut)
        kinds = [cfg.layer_kind(l) for l in range(cfg.num_layers)]
        n_attn = sum(mix == "attention" for mix, _ in kinds)
        print(f"phase 10 {cell}: {cfg.name} at its published widths in "
              f"{cfg.dtype}"
              + (f", num_layers {base.num_layers} -> {cfg.num_layers} (depth "
                 "cut: one whole period, leading dense layers once)"
                 if cut else ", whole")
              + f"; {B} prompts of {S} tokens, max_len {MAX_LEN}, {STEPS} "
              f"greedy tokens ({card})")
        print(f"  layers: {kinds}")
        # the check runs drop-free: which tokens a full expert drops
        # depends on their order, which prefill and decode do not share
        ccfg = cfg
        if cfg.moe:
            ccfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            print(f"  DEPARTURE (check only): capacity_factor "
                  f"{ccfg.capacity_factor:g}, drop-free; served at "
                  f"{cfg.capacity_factor:g}")

        # ---- the JAX package's init rule, for the record
        print("  the JAX package's init rule (std 1/sqrt(shape[0]); 1 for "
              "a stack of one layer), forward of 1 x 64 tokens:")
        params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
        jax_rule_ok = probe_layers(params, cfg)
        if not jax_rule_ok:
            print("  the JAX package's rule overflows: a norm's f32 mean "
                  "square is infinite or the logits are constant")
        del params
        torch.cuda.empty_cache()

        # ---- phase 10's weights: that rule on each layer's own shape;
        # the check in f32 (bf16 rounding moves MoE routing between the
        # two paths: an expert swapped for one token moves its logits by
        # ~1), serving in bf16
        print("  DEPARTURE: weights drawn by the JAX package's rule on each "
              "layer's own shape (init_per_layer)")
        fcfg = dataclasses.replace(ccfg, dtype="float32")
        params = init_per_layer(fcfg, gen.manual_seed(SEED), dev)
        ok, err, err_n, err_f = decode_check(params, fcfg)
        check(ok, f"{cell} prefill + decode == forward")
        check(err_f > KIND_TOL, f"{cell} KIND_TOL tells a lost state from "
              "the forward")
        del params
        torch.cuda.empty_cache()
        params = init_per_layer(cfg, gen.manual_seed(SEED), dev)
        print(f"  {cfg.dtype}, forward of 1 x 64 tokens:")
        check(probe_layers(params, cfg), f"{cell} finite at the per-layer "
              "init rule")
        w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        print(f"  weights {w_bytes / 1e9:.2f} GB "
              f"({sum(t.numel() for t in tree_leaves(params)) / 1e9:.2f} B "
              f"parameters) from seed {SEED}")

        # ---- serving at the published capacity
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                dtype=torch.int32, device=dev)
        prefill_step(params, prompts[:1, :64], cfg)          # warm-up
        (tok, pcache, cur), prefill_s = sync_time(
            lambda: prefill_step(params, prompts, cfg))
        cache = engine.pad_cache(pcache, cfg, B, MAX_LEN)
        del pcache
        c_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        print(f"  cache {c_bytes / 1e9:.3f} GB; prefill {1e3 * prefill_s:.1f} "
              f"ms ({B * S / prefill_s:.0f} prompt tokens/s)")
        state = {"cache": cache, "cur_len": cur}
        zero_counters()
        step_s, toks = [], [tok]
        for _ in range(STEPS):
            (tok, state), dt = sync_time(
                lambda: engine.decode_step(params, state, tok, cfg))
            step_s.append(dt)
            toks.append(tok)
        got = read_counters()
        want = {key: 0 for key in got}
        want["decode_attention"] = n_attn * STEPS
        print(f"  launches over {STEPS} decode steps: {got}")
        check(got == want, f"{cell} launches {got} == {want}")
        toks = torch.cat(toks, 1)
        check(toks.shape == (B, STEPS + 1)
              and int(state["cur_len"][0]) == S + STEPS,
              f"{cell} tokens and cache length")
        final = step_logits(params, cfg, tok, clone(state["cache"]),
                            state["cur_len"])
        check(bool(torch.isfinite(final).all()), f"{cell} finite logits")
        step = statistics.median(step_s[1:])
        print(f"  decode: {1e3 * step:.3f} ms/token (median of steps "
              f"2-{STEPS}; first {1e3 * step_s[0]:.3f} ms), "
              f"{B / step:.1f} tokens/s; weights' bound a step "
              f"{1e3 * memory_bound_s(w_bytes, hw):.3f} ms")

        if n_attn:
            # the decode kernel against its plain version, token for token
            def greedy(cache, cur, tok, steps=8):
                toks = []
                for _ in range(steps):
                    tok = step_logits(params, cfg, tok, cache,
                                      cur).argmax(-1, keepdim=True).int()
                    cur = cur + 1
                    toks.append(tok)
                return torch.cat(toks, 1)

            start = (state["cur_len"], tok)
            toks_k = swapped(greedy, clone(state["cache"]), *start,
                             attn=model_decode, launches=8 * n_attn)
            toks_p = swapped(greedy, clone(state["cache"]), *start)
            print(f"  8 greedy steps, kernel ({8 * n_attn} launches) vs plain "
                  f"decode_attention: tokens equal "
                  f"{torch.equal(toks_k, toks_p)}")
            check(torch.equal(toks_k, toks_p),
                  f"{cell} kernel decode == plain decode")
        busy = profile_steps(params, cfg, engine, state, tok)
        out.append({
            "cell": cell, "model": cfg.name, "layers": cfg.num_layers,
            "weights_gb": w_bytes / 1e9, "cache_gb": c_bytes / 1e9,
            "prefill_ms": 1e3 * prefill_s,
            "prompt_tokens_per_s": B * S / prefill_s,
            "decode_ms_per_token": 1e3 * step, "tokens_per_s": B / step,
            "weight_bound_ms": 1e3 * memory_bound_s(w_bytes, hw),
            "check_err": err, "check_noise": err_n, "check_state_lost": err_f,
            "jax_rule_finite": jax_rule_ok,
            "profile": busy})
        del params, state, cache, final, prompts
        torch.cuda.empty_cache()
    print(json.dumps({"phase10": {"card": card, "cells": out}}))
    if failed:
        raise AssertionError("phase 10: " + "; ".join(failed))
    return out

# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

TRAIN_AB = (4, 2048, 4)        # (ab): B, S, steps; Qwen2-1.5B whole
TRAIN_AB_TF32 = 2              # (ab): steps more with TF32 in the backward
TRAIN_AC = (2, 1, 512)         # (ac): layers, B, S (f32 against f64)
TRAIN_AD = (4, 2, 512, 6, 2, 3)  # (ad): layers, B, S, steps, ckpt_every, fail
TRAIN_AE = (2, 16, 3)          # (ae): B, S, steps at reduced_config
# PR 24's bound of (ab) a step, from a hand formula (GEMMs at the bf16
# peak, the attention's causal triangle at TF32 forward and f32 backward),
# printed once beside the bound the counter gives (launch.roofline)
AB_BOUND_PR24_MS = 324.8
# (ac): the port's f32 loss and gradients against float64 autograd of the
# same function on the card, max |g32 - g64| / max |g64| for each leaf,
# with weights by the JAX package's rule on each layer's own shape
# (init_per_layer).  The JAX rule itself (std 1/sqrt(2) on every stacked
# weight at 2 layers) makes the attention's softmax so sharp that f32
# rounding moves the gradients by ~2e-2 of a leaf's largest magnitude
# (CPU, full width, 2 layers, S = 128); with per-layer weights f32
# rounding is 3.0e-6 there.  F64_TOL allows 30 times that.
F64_TOL = 1e-4
F64_LOSS_TOL = 1e-5


def f64_reference():
    """A context in which the functions that upcast to f32 (norms, RoPE,
    the attention products, the loss) compute in the input's own dtype
    instead: the same function in f32 (where the upcast does nothing)
    and, for an f64 model, the whole of it in f64."""
    import contextlib

    import torch

    from repro_torch.models import attention, common, transformer

    def rms_norm(x, weight, eps=1e-6):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight

    def apply_rope(x, positions, theta=10000.0):
        dh = x.shape[-1]
        freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=x.dtype,
                                             device=x.device) / dh)
        angles = positions[..., None].to(x.dtype) * freqs
        cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def cross_entropy(logits, labels, *, valid_mask=None):
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels.long()[..., None])[..., 0]
        if valid_mask is None:
            return nll.mean()
        valid = valid_mask.to(nll.dtype)
        return (nll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)

    patches = ((common, "rms_norm", rms_norm),
               (attention, "rms_norm", rms_norm),
               (attention, "apply_rope", apply_rope),
               (attention, "_einsum_f32", torch.einsum),
               (transformer, "cross_entropy_logits_sharded", cross_entropy))

    @contextlib.contextmanager
    def ctx():
        saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
        for m, n, f in patches:
            setattr(m, n, f)
        try:
            yield
        finally:
            for m, n, f in saved:
                setattr(m, n, f)

    return ctx()


def count_train_step(cfg, b, s):
    """The cost counter's sums (launch.cost_counter, on the meta device:
    nothing allocated or launched) for one AdamW step of ``cfg`` on a
    b x s token batch, one microbatch, as (ab) runs it."""
    import torch

    from repro_torch.launch.cost_counter import count_costs
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step

    params = T.model_param_shapes(cfg)
    opt = make_optimizer(OptConfig())
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("inputs", "labels")}
    return count_costs(make_train_step(cfg, opt), params, opt.init(params),
                       batch)[1]


def count_decode_step(cfg, b, max_len):
    """The counter's sums for one decode step of ``cfg`` with a b x
    max_len cache, on the meta device (decode_attention charged by
    formula over every cache row: cur_len is unknown there)."""
    from repro_torch.launch.cost_counter import count_costs
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine

    state, tok = engine.serve_input_specs(cfg, batch=b, kv_len=max_len)
    return count_costs(engine.decode_step, T.model_param_shapes(cfg), state,
                       tok, cfg)[1]


def print_bound(label, costs, hw) -> dict:
    """The roofline terms of ``costs`` on ``hw`` (launch.roofline), printed
    by dtype; returns them with the bound in ms."""
    from repro_torch.launch.roofline import roofline_terms, step_bound_s

    t = roofline_terms(costs, hw)
    by = ", ".join(f"{k} {costs.flops_by_dtype[k] / 1e12:.2f} TFLOP "
                   f"({1e3 * v:.1f} ms)"
                   for k, v in sorted(t["compute_s_by_dtype"].items()))
    bound = 1e3 * step_bound_s(costs, hw)
    print(f"  {label}: bound {bound:.1f} ms ({t['dominant']}) on "
          f"{hw['name']}'s data-sheet peaks: compute "
          f"{1e3 * t['compute_s']:.1f} ms ({by}), memory "
          f"{1e3 * t['memory_s']:.1f} ms "
          f"({costs.hbm_bytes / 1e12:.3f} TB of eager traffic, "
          f"{costs.n_ops} aten ops); peak live "
          f"{costs.peak_live_bytes / 1e9:.3f} GB")
    return {"bound_ms": bound, "compute_ms": 1e3 * t["compute_s"],
            "memory_ms": 1e3 * t["memory_s"], "dominant": t["dominant"],
            "flops_by_dtype": dict(costs.flops_by_dtype),
            "hbm_bytes": costs.hbm_bytes, "peak_live_bytes":
            costs.peak_live_bytes, "n_ops": costs.n_ops}


def profile_train_step(step) -> dict:
    """One training step in a torch.profiler window: wall and device busy
    time, kernels, and the kernels that took the most device time; {} if
    the profiler records no device activity here."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("  profiler: no device activity recorded (not measured)")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:          # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  profiler, one step: {len(kernels)} kernels, device busy "
          f"{busy / 1e3:.1f} ms of {wall_ms:.1f} ms ({100 * busy / 1e3 / wall_ms:.1f} %); "
          f"the most device time:")
    for name, us in top:
        print(f"    {us / 1e3:9.1f} ms  {name[:110]}")
    return {"kernels": len(kernels), "wall_ms": wall_ms,
            "device_busy_ms": busy / 1e3,
            "top": [[name[:110], us / 1e3] for name, us in top]}


def training(dev, card, zero_counters, read_counters, hw) -> dict:
    """Phase 11: the train step, the loop, checkpoints and recovery on the
    card; returns the phase's summary (with (ab)'s count under
    ``ab_costs``, which phase 12 reuses)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.base import ARCHS, get_config, reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import make_batch
    from repro_torch.train.elastic import FailureInjector, run_loop
    from repro_torch.train.optimizer import OptConfig, make_optimizer
    from repro_torch.train.train_step import _grads_of, make_train_step

    gen = torch.Generator(device=dev)
    out = {"card": card}

    def batch_of(cfg, b, s, step=0):
        return {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            step, global_batch=b, seq_len=s, vocab=cfg.vocab_size,
            input_mode=cfg.input_mode, d_model=cfg.d_model).items()}

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    def recorded(step_fn, seen):
        def step(p, o, b):
            zero_counters()
            p, o, m = step_fn(p, o, b)
            row = {k: float(v) for k, v in m.items()}
            row["launches"] = read_counters()
            seen.append(row)
            return p, o, m
        return step

    # ---- (ab) Qwen2-1.5B at full width, bf16, remat "full", AdamW
    B, S, STEPS = TRAIN_AB
    cfg = get_config("qwen2_1_5b")
    print(f"phase 11 (ab): {cfg.name} at full width ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}), {cfg.dtype}, remat "
          f"{cfg.remat!r}, AdamW; {STEPS} steps of make_train_step through "
          f"run_loop on one batch of {B} x {S} ({card})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
    opt = make_optimizer(OptConfig())
    opt_state = opt.init(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = batch_of(cfg, B, S)
    seen = []
    with tempfile.TemporaryDirectory() as tmp:
        res = run_loop(train_step=recorded(make_train_step(cfg, opt), seen),
                       make_batch=lambda step: batch, params=params,
                       opt_state=opt_state, n_steps=STEPS, ckpt_dir=tmp,
                       ckpt_every=STEPS + 1)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in res["history"]]
    norms = [r["grad_norm"] for r in seen]
    step_s = statistics.median(h["dt"] for h in res["history"][1:])
    t0 = time.perf_counter()
    ab_costs = count_train_step(cfg, B, S)
    count_s = time.perf_counter() - t0
    print(f"  {n_params / 1e9:.3f} B parameters; losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
          + ", ".join(f"{x:.3g}" for x in norms))
    print(f"  step {1e3 * step_s:.1f} ms (median of steps 2-{STEPS}; first "
          f"{1e3 * res['history'][0]['dt']:.1f} ms), {B * S / step_s:.0f} "
          f"tokens/s, peak memory {peak / 1e9:.2f} GB "
          f"(max_memory_allocated)")
    ab_bound = print_bound(f"the step counted on meta in {count_s:.1f} s",
                           ab_costs, hw)
    print(f"  the step at {100 * ab_bound['bound_ms'] / (1e3 * step_s):.1f} "
          f"% of that bound; the compute term "
          f"{ab_bound['compute_ms']:.1f} ms beside PR 24's hand formula "
          f"(compute only) {AB_BOUND_PR24_MS} ms")
    print(f"  hand-written kernels launched a step: "
          f"{[r['launches'] for r in seen[-1:]]} (expected 0: the training "
          f"path reaches none of them)")
    ok = all(map(math.isfinite, losses + norms)) and losses[-1] < losses[0]
    # what IEEE f32 in the attention's backward costs: the same steps with
    # TF32 allowed there (the forward already multiplies the bf16
    # operands in TF32; bf16 GEMMs do not read the flag)
    flags = torch.backends.cuda.matmul
    flags.allow_tf32 = True
    try:
        tf32 = []
        step = make_train_step(cfg, opt)
        for _ in range(TRAIN_AB_TF32):
            _, dt = sync_time(lambda: step(params, opt_state, batch))
            tf32.append(dt)
    finally:
        flags.allow_tf32 = False
    tf32_s = statistics.median(tf32)
    print(f"  with TF32 in the attention's backward: step {1e3 * tf32_s:.1f} "
          f"ms (median of {TRAIN_AB_TF32}); IEEE f32 there costs "
          f"{1e3 * (step_s - tf32_s):.1f} ms a step")
    busy = profile_train_step(lambda: step(params, opt_state, batch))
    out["ab"] = {"params_b": n_params / 1e9, "losses": losses,
                 "grad_norms": norms, "step_ms": 1e3 * step_s,
                 "tokens_per_s": B * S / step_s, "peak_gb": peak / 1e9,
                 "bound_ms": ab_bound["bound_ms"], "bound": ab_bound,
                 "bound_pr24_ms": AB_BOUND_PR24_MS,
                 "step_ms_tf32_backward": 1e3 * tf32_s, "profile": busy,
                 "launches_a_step": seen[-1]["launches"]}
    if not ok:
        raise AssertionError(f"(ab): losses {losses}, grad norms {norms}: "
                             "not finite or not descending")
    del params, opt_state, batch, res
    torch.cuda.empty_cache()

    # ---- (ac) gradients on the card against f64
    layers, B, S = TRAIN_AC
    cfg = dataclasses.replace(get_config("qwen2_1_5b"), num_layers=layers,
                              dtype="float32")
    print(f"phase 11 (ac): {cfg.name} at full width, {layers} layers, f32, "
          f"B={B}, S={S}: loss and gradients against float64 autograd of the "
          f"same function on the card; DEPARTURE: weights by the JAX "
          f"package's rule on each layer's own shape (init_per_layer) "
          f"({card})")
    params = init_per_layer(cfg, gen.manual_seed(SEED), dev)
    batch = batch_of(cfg, B, S)
    loss, _, grads = _grads_of(params, batch, cfg)
    with f64_reference():
        loss64, _, grads64 = _grads_of(
            tree_map(lambda t: t.double(), params), batch,
            dataclasses.replace(cfg, dtype="float64"))
    loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    errs = [rel_err(g, g64) for g, g64 in zip(tree_leaves(grads),
                                              tree_leaves(grads64))]
    worst = max(errs)
    print(f"  loss {float(loss):.6f} vs f64 {float(loss64):.6f} (rel "
          f"{loss_err:.2e}, tolerance {F64_LOSS_TOL:g}); gradients: worst "
          f"leaf {worst:.3e} of its max|g| (tolerance {F64_TOL:g}), median "
          f"{statistics.median(errs):.3e}")
    del grads64
    if not (loss_err <= F64_LOSS_TOL and worst <= F64_TOL):
        raise AssertionError(f"(ac): loss {loss_err:.3e}, gradients "
                             f"{worst:.3e} against f64")
    same = {}
    for remat in ("full", "dots"):
        l2, _, g2 = _grads_of(params, batch, dataclasses.replace(
            cfg, remat=remat))
        same[remat] = bool(torch.equal(l2, loss)) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g2),
                                              tree_leaves(grads)))
    print(f"  remat full / dots bitwise none's loss and gradients: {same}")
    if cfg.remat != "none" and not all(same.values()):
        raise AssertionError(f"(ac) remat not bitwise: {same}")
    mb = batch_of(cfg, 2, S)
    micro = {}
    for n in (1, 2):
        mopt = make_optimizer(OptConfig(eps=1.0))
        p = clone(params)
        _, st, m = make_train_step(cfg, mopt, n_microbatches=n)(
            p, mopt.init(p), mb)
        micro[n] = (float(m["loss"]), float(m["grad_norm"]), st["m"])
    m_err = max(rel_err(a, b) for a, b in zip(tree_leaves(micro[2][2]),
                                             tree_leaves(micro[1][2])))
    print(f"  n_microbatches 2 vs 1 at B=2: loss {micro[2][0]:.6f} / "
          f"{micro[1][0]:.6f}, grad norm {micro[2][1]:.6f} / "
          f"{micro[1][1]:.6f}, first moments {m_err:.2e} of max")
    if not (abs(micro[2][0] - micro[1][0]) <= 1e-5 * abs(micro[1][0])
            and abs(micro[2][1] - micro[1][1]) <= 1e-5 * micro[1][1]
            and m_err <= 1e-4):
        raise AssertionError("(ac): two microbatches differ from one")
    out["ac"] = {"loss_rel_err": loss_err, "grad_worst": worst,
                 "grad_median": statistics.median(errs),
                 "remat_bitwise": same, "micro_moment_err": m_err}
    del params, grads, micro
    torch.cuda.empty_cache()

    # ---- (ad) recovery: bitwise against the uninterrupted run
    layers, B, S, STEPS, EVERY, FAIL = TRAIN_AD
    cfg = dataclasses.replace(get_config("qwen2_1_5b"), num_layers=layers)
    print(f"phase 11 (ad): {cfg.name} at full width, {layers} layers, "
          f"{cfg.dtype}: run_loop of {STEPS} steps (B={B}, S={S}, a new "
          f"batch a step), checkpoints every {EVERY}, a failure injected at "
          f"step {FAIL}, against the uninterrupted run ({card})")
    params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
    opt = make_optimizer(OptConfig())
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)

    def run(d, fail):
        # the uninterrupted run writes no checkpoint
        return run_loop(
            train_step=step, make_batch=lambda i: batch_of(cfg, B, S, i),
            params=clone(params), opt_state=clone(opt_state), n_steps=STEPS,
            ckpt_dir=d, ckpt_every=EVERY if fail else STEPS + 1,
            failure_injector=FailureInjector([FAIL] if fail else []))

    def keys_of(tree):
        return [ckpt._leaf_key(p) for p, _ in ckpt._flatten_with_path(tree)]

    def recover(tmp):
        plain = run(os.path.join(tmp, "plain"), False)["final_state"]
        res = run(os.path.join(tmp, "fail"), True)
        differ = [k for k, a, b in zip(keys_of(plain),
                                       tree_leaves(plain),
                                       tree_leaves(res["final_state"]))
                  if not torch.equal(a, b)]
        return plain, res, differ

    with tempfile.TemporaryDirectory() as tmp:
        plain, res, differ = recover(tmp)
        print(f"  restarts {res['restarts']}, steps run "
              f"{[h['step'] for h in res['history']]}; leaves that differ "
              f"from the uninterrupted run: {differ or 'none'}")
        deterministic = bool(differ)
        if differ:
            # index_select's backward (the embedding gradient) adds with
            # atomics on CUDA; deterministic mode sorts instead
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                shutil.rmtree(os.path.join(tmp, "fail"))
                plain, res, differ = recover(tmp)
            finally:
                torch.use_deterministic_algorithms(False)
            print(f"  under torch.use_deterministic_algorithms: leaves that "
                  f"differ {differ or 'none'}")
        if differ or res["restarts"] != 1:
            raise AssertionError(f"(ad): recovery not bitwise: {differ}")
        final = res["final_state"]
        last = ckpt.latest_step(os.path.join(tmp, "fail"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ckpt.restore_checkpoint(os.path.join(tmp, "fail"), last,
                                           final)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                   zip(tree_leaves(restored), tree_leaves(final))):
            raise AssertionError("(ad): the last checkpoint does not restore "
                                 "the final state")
        del restored
        t0 = time.perf_counter()
        ckpt.save_checkpoint(os.path.join(tmp, "timed"), last, final)
        save_s = time.perf_counter() - t0
        files = os.path.join(tmp, "timed", f"step_{last}")
        n_bytes = sum(os.path.getsize(os.path.join(files, f))
                      for f in os.listdir(files))
    dtypes = sorted({str(t.dtype)[6:] for t in tree_leaves(final)})
    print(f"  bitwise: final params and optimizer state "
          f"({'under deterministic algorithms' if deterministic else 'as run'}"
          f"); checkpoint of step {last}: {n_bytes / 1e9:.3f} GB ({dtypes}), "
          f"save {save_s:.2f} s ({n_bytes / save_s / 1e9:.2f} GB/s), restore "
          f"{restore_s:.2f} s onto the card, bitwise")
    out["ad"] = {"bitwise": True, "needed_deterministic": deterministic,
                 "ckpt_gb": n_bytes / 1e9, "save_s": save_s,
                 "restore_s": restore_s,
                 "losses": [h["loss"] for h in res["history"]]}
    del params, opt_state, plain, res, final
    torch.cuda.empty_cache()

    # ---- (ae) every architecture at reduced_config, f32 and bf16
    B, S, STEPS = TRAIN_AE
    print(f"phase 11 (ae): all {len(ARCHS)} architectures at reduced_config, "
          f"{STEPS} AdamW steps (lr 5e-3) on one batch of {B} x {S}, f32 and "
          f"bf16 ({card})")
    rows, failed = [], []
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = reduced_config(get_config(arch), dtype=dtype)
            params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
            opt = make_optimizer(OptConfig(lr=5e-3))
            state = opt.init(params)
            step = make_train_step(cfg, opt)
            batch = batch_of(cfg, B, S)
            ms = []
            for _ in range(STEPS):
                params, state, m = step(params, state, batch)
                ms.append({k: float(v) for k, v in m.items()})
            losses = [m["loss"] for m in ms]
            good = (all(math.isfinite(v) for m in ms for v in m.values())
                    and losses[-1] < losses[0])
            extra = "".join(f", {k} {ms[-1][k]:.4f}" for k in ("aux", "mtp")
                            if k in ms[-1] and (k == "mtp" or cfg.moe))
            print(f"  {arch} {dtype}: losses "
                  + ", ".join(f"{x:.4f}" for x in losses) + extra
                  + ("" if good else "  FAILED"))
            rows.append({"arch": arch, "dtype": dtype, "losses": losses,
                         **{k: ms[-1][k] for k in ("aux", "mtp")
                            if k in ms[-1]}})
            if not good:
                failed.append(f"{arch} {dtype}")
    out["ae"] = rows
    print(json.dumps({"phase11": out}))
    if failed:
        raise AssertionError("phase 11 (ae): " + "; ".join(failed))
    out["ab_costs"] = ab_costs
    return out


# ---------------------------------------------------------------------------
# phase 12: the launch tools
# ---------------------------------------------------------------------------

# (af): the dry-run grid, calls of the CLI (python -m
# repro_torch.launch.dryrun --arch A --shape S --mesh M), run at once with
# DRYRUN_JOBS processes each.  Every architecture's decode_32k and
# long_500k on 1x1 and on the production mesh (rank 0 of 32 x 8, counted
# on a meta rank mesh: ~1 s a decode cell), and two prefill_32k cells;
# train_4k (20-90 s of host time a cell) on 1x1 for one model of each
# layer kind: Qwen2 (GQA attention, dense FFN), DeepSeek-V3 (MLA, MoE,
# MTP) and Jamba (Mamba), and on the production mesh for Qwen2 and for
# DeepSeek-V3, whose Adafactor runs on leaves cut over model and data.
# RWKV-6's train_4k and prefill_32k loop over the sequence in Python,
# ~10.6 M aten ops on meta under autograd (~20 min of host time a cell).
# The CLI run of the whole grid counts every cell.
_ALL_BUT_RWKV = ",".join(a for a in (
    "deepseek_v3_671b", "qwen3_moe_30b_a3b", "starcoder2_3b", "qwen2_1_5b",
    "granite_20b", "granite_34b", "musicgen_medium", "jamba_v0_1_52b",
    "llava_next_mistral_7b"))
DRYRUN_GRID = (
    (_ALL_BUT_RWKV, "decode_32k,long_500k", "1x1,production"),
    ("qwen2_1_5b,deepseek_v3_671b", "train_4k", "production"),
    ("qwen2_1_5b,deepseek_v3_671b,jamba_v0_1_52b", "train_4k", "1x1"),
    ("rwkv6_1_6b", "decode_32k,long_500k", "1x1,production"),
    ("qwen2_1_5b,deepseek_v3_671b", "prefill_32k", "1x1"))
DRYRUN_JOBS = (1, 2, 2, 1, 1)
# (af) the CLI's A/B flags on one cell: Qwen2-1.5B's train_4k on 1x1 with
# head_pad_factor 1 (the config's is 4) and 2 microbatches, its record
# written under the tag beside the grid's own cell
DRYRUN_AB = (("qwen2_1_5b", "train_4k", "1x1"),
             ("--override", "head_pad_factor=1", "--micro", "2",
              "--tag", "_ab"))
DRYRUN_BUDGET_S = 600   # the grid's wall from its start; the full run
                        # hides it behind phases 1-11 (~850 s)
PEAK_TOL = 0.10         # (ag): counted peak against max_memory_allocated
AG_DECODE = (8, 4096, 2064)   # (ag): (k)'s B, max_len and a cur_len


def start_dryrun(out_dir) -> list:
    """(af): start the grid in the background on the host's CPU, niced, with
    CUDA hidden (the dry-run runs on the meta device and launches
    nothing); returns [(process, log file, start time)]."""
    import atexit
    import signal

    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(REPO, "src"))
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    procs = []
    runs = [(cell, ("--jobs", str(jobs)))
            for cell, jobs in zip(DRYRUN_GRID, DRYRUN_JOBS)] + [DRYRUN_AB]
    for i, ((arch, shape, mesh), extra) in enumerate(runs):
        log = open(os.path.join(out_dir, f"grid{i}.log"), "w")
        cmd = nice + [sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", arch, "--shape", shape, "--mesh", mesh,
                      "--out", out_dir, *extra]
        procs.append((subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                       stderr=subprocess.STDOUT,
                                       start_new_session=True),
                      log, time.time()))

    def stop():
        for p, log, _ in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)   # the CLI and its workers
                p.wait()
            log.close()

    atexit.register(stop)
    return procs


def collect_dryrun(procs, out_dir) -> dict:
    """(af): wait for the grid within its budget and check every cell: ok,
    or skipped with cell_is_supported's reason."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import cell_is_supported

    waited = []
    for p, log, t0 in procs:
        left = DRYRUN_BUDGET_S - (time.time() - t0)
        try:
            rc = p.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"(af) the dry-run grid exceeded its "
                                 f"{DRYRUN_BUDGET_S} s budget: {p.args}")
        log.flush()
        # the wall to the CLI's last line (its summary), not to this wait
        wall = os.path.getmtime(log.name) - t0
        if wall > DRYRUN_BUDGET_S:
            raise AssertionError(f"(af) {p.args} took {wall:.1f} s, over "
                                 f"its {DRYRUN_BUDGET_S} s budget")
        waited.append((rc, wall))
    for i, (rc, wall) in enumerate(waited):
        with open(os.path.join(out_dir, f"grid{i}.log")) as f:
            tail = f.read().splitlines()[-1:]
        args = procs[i][0].args
        flags = args[args.index("repro_torch.launch.dryrun") + 1:]
        print(f"  (af) dryrun {' '.join(flags)}: exit {rc}, "
              f"{wall:.1f} s from its start; {tail[0] if tail else ''}")
    want = [cell for grid in DRYRUN_GRID for cell in dryrun.cells(*grid)]
    recs, bad = [], []
    for arch, shape, mesh in want:
        path = os.path.join(out_dir, f"{arch}__{shape}__"
                                     f"{dryrun.MESHES[mesh]}.json")
        rec = json.load(open(path)) if os.path.exists(path) else {
            "arch": arch, "shape": shape, "mesh": dryrun.MESHES[mesh],
            "status": "FAILED"}
        recs.append(rec)
        ok, why = cell_is_supported(get_config(arch), SHAPES[shape])
        if not (rec["status"] == "ok" and ok or rec["status"] == "skipped"
                and not ok and rec["why"] == why):
            bad.append(f"{arch} x {shape} x {mesh}: {rec['status']}")
    print(dryrun.summary(recs))
    one = [r for r in recs if r["mesh"] == "1x1" and r["status"] == "ok"]
    n_ok = sum(r["status"] == "ok" for r in recs)
    print(f"  (af) {n_ok} ok, {len(recs) - n_ok - len(bad)} skipped, "
          f"{len(bad)} failed; the 1x1 cells' counts took "
          f"{sum(r['count_s'] for r in one):.1f} s of host time (slowest "
          f"{max(one, key=lambda r: r['count_s'])['arch']} "
          f"{max(r['count_s'] for r in one):.1f} s)")
    if any(rc != 0 for rc, _ in waited) or bad:
        raise AssertionError(f"(af) dry-run cells failed: {bad}")
    (arch, shape, mesh), _ = DRYRUN_AB
    base = f"{arch}__{shape}__{dryrun.MESHES[mesh]}"
    with open(os.path.join(out_dir, base + ".json")) as f:
        plain = json.load(f)
    with open(os.path.join(out_dir, base + "_ab.json")) as f:
        ab = json.load(f)
    print(f"  (af) A/B {base}_ab.json (--override head_pad_factor=1 --micro "
          f"2 --tag _ab) against {base}.json (head_pad_factor 4, "
          f"{plain['n_microbatches']} microbatch(es)): n_microbatches "
          f"{ab['n_microbatches']}; argument bytes {ab['memory']['argument_bytes']:,} "
          f"against {plain['memory']['argument_bytes']:,}; FLOPs "
          f"{ab['hlo_costs']['flops']:.4e} against "
          f"{plain['hlo_costs']['flops']:.4e}; HBM bytes "
          f"{ab['hlo_costs']['hbm_bytes']:.4e} against "
          f"{plain['hlo_costs']['hbm_bytes']:.4e}; peak "
          f"{ab['memory']['peak_per_device_bytes'] / 2**30:.2f} against "
          f"{plain['memory']['peak_per_device_bytes'] / 2**30:.2f} GiB")
    if not (ab["status"] == "ok" and ab["n_microbatches"] == 2
            and ab["memory"]["argument_bytes"]
            < plain["memory"]["argument_bytes"]):
        raise AssertionError(f"(af) the A/B cell: status {ab['status']}, "
                             f"n_microbatches {ab['n_microbatches']}, "
                             "argument bytes not below the padded model's")
    return {"cells": [{k: r.get(k) for k in (
        "arch", "shape", "mesh", "status", "cell_s", "n_microbatches",
        "useful_flop_ratio", "fits_hbm")} | {
        "peak_bytes": (r.get("memory") or {}).get("peak_per_device_bytes"),
        "args_bytes": (r.get("memory") or {}).get("argument_bytes"),
        "terms_ms": {k: 1e3 * v for k, v in (r.get("roofline") or {}).items()
                     if k in ("compute_s", "memory_s", "collective_s")},
        "dominant": (r.get("roofline") or {}).get("dominant")}
        for r in recs], "grid_wall_s": [w for _, w in waited]}


def launch_tools(dev, card, hw, procs, out_dir, ab_costs=None) -> dict:
    """Phase 12: the dry-run's predictions held against the card ((ag)),
    head_pad_factor 4 against 1 in counts, and the grid ((af))."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import get_config
    from repro_torch.launch.cost_counter import count_costs
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve import engine
    from repro_torch.train.data import make_batch
    from repro_torch.train.optimizer import OptConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step

    gen = torch.Generator(device=dev)
    out = {"card": card, "hw": hw["name"]}
    failed = []

    def peak_check(label, counted, measured):
        rel = (counted - measured) / measured
        print(f"  {label}: peak counted on meta {counted / 1e9:.3f} GB, "
              f"max_memory_allocated {measured / 1e9:.3f} GB (the step alone: "
              f"above what was allocated before its arguments), "
              f"{100 * rel:+.2f} % (tolerance {100 * PEAK_TOL:.0f} %)")
        if abs(rel) > PEAK_TOL:
            failed.append(f"{label} peak {100 * rel:+.2f} %")
        return rel

    # ---- (ag) (ab)'s step: FLOPs exact, peak within PEAK_TOL
    B, S, _ = TRAIN_AB
    cfg = get_config("qwen2_1_5b")
    print(f"phase 12 (ag): (ab)'s step, {cfg.name} bf16, {B} x {S}, remat "
          f"{cfg.remat!r}, AdamW: the meta count against the card ({card})")
    if ab_costs is None:
        ab_costs = count_train_step(cfg, B, S)
    train = print_bound("counted on meta", ab_costs, hw)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
    opt = make_optimizer(OptConfig())
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        0, global_batch=B, seq_len=S, vocab=cfg.vocab_size).items()}
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    card_flops = fc.get_total_flops()
    print(f"  FLOPs: counted on meta {ab_costs.flops:.6e}, FlopCounterMode "
          f"over the step on the card {card_flops:.6e}: equal "
          f"{ab_costs.flops == card_flops}")
    if ab_costs.flops != card_flops:
        failed.append("(ab) FLOPs differ")
    train["peak_rel"] = peak_check("(ab)", ab_costs.peak_live_bytes, peak)
    train["card_peak_gb"] = peak / 1e9
    del params, state, batch, step
    torch.cuda.empty_cache()

    # ---- (ag) (k)'s decode step: bytes >= weights + rows read, peak
    B, L, CUR = AG_DECODE
    print(f"phase 12 (ag): (k)'s decode step, {cfg.name} bf16, B={B}, "
          f"max_len {L}, cur_len {CUR} ({card})")
    dcosts = count_decode_step(cfg, B, L)
    decode = print_bound("counted on meta", dcosts, hw)
    base = torch.cuda.memory_allocated(dev)
    params = T.model_init(cfg, gen.manual_seed(SEED), device=dev)
    st = engine.init_serve_state(cfg, B, L, device=dev)
    st["cur_len"].fill_(CUR)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    engine.decode_step(params, st, tok, cfg)       # plans and handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _, card_costs = count_costs(engine.decode_step, params, st, tok, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    embed = params["embed"]
    w_read = w_bytes - (embed.numel() - B * embed.shape[1]) \
        * embed.element_size()
    kv = st["cache"][0][0][0]                      # (layers, B, L, Hkv, Dh)
    rows = 2 * kv.shape[0] * B * (CUR + 1) * kv[0, 0, 0].numel() \
        * kv.element_size()
    print(f"  bytes: counted {dcosts.hbm_bytes / 1e9:.3f} GB >= weights read "
          f"{w_read / 1e9:.3f} GB (the embedding table but {B} rows) + K and "
          f"V rows < cur_len + 1 {rows / 1e9:.3f} GB: "
          f"{dcosts.hbm_bytes >= w_read + rows}; the counter on the card "
          f"(decode_attention charged at its {CUR + 1} rows, "
          f"{dict(card_costs.charged)}): {card_costs.hbm_bytes / 1e9:.3f} GB, "
          f"{card_costs.flops / 1e9:.3f} GFLOP against "
          f"{dcosts.flops / 1e9:.3f} on meta")
    if not dcosts.hbm_bytes >= w_read + rows:
        failed.append("(k) counted bytes below weights + rows")
    decode.update({"peak_rel": peak_check("(k)", dcosts.peak_live_bytes, peak),
                   "card_peak_gb": peak / 1e9, "weights_read_gb": w_read / 1e9,
                   "kv_rows_gb": rows / 1e9,
                   "card_count_gb": card_costs.hbm_bytes / 1e9})
    del params, st, tok
    torch.cuda.empty_cache()
    out["ag"] = {"train": train, "decode": decode}

    # ---- head_pad_factor 4 (the config's) against 1, in counts
    pads = {}
    for pad in (4, 1):
        c = dataclasses.replace(cfg, head_pad_factor=pad)
        tc = ab_costs if pad == 4 else count_train_step(c, *TRAIN_AB[:2])
        dc = dcosts if pad == 4 else count_decode_step(c, B, L)
        pads[pad] = {k: {"tflop": x.flops / 1e12, "gb": x.hbm_bytes / 1e9,
                         "peak_gb": x.peak_live_bytes / 1e9}
                     for k, x in (("train", tc), ("decode", dc))}
        print(f"  head_pad_factor {pad}: (ab) step {pads[pad]['train']}; (k) "
              f"decode step {pads[pad]['decode']}")
    out["head_pad"] = pads

    # ---- (af) the grid
    print(f"phase 12 (af): the dry-run grid on the meta device ({card}; host "
          f"times, the CLI niced beside the card's phases)")
    out["af"] = collect_dryrun(procs, out_dir)
    print(json.dumps({"phase12": out}, default=str))
    if failed:
        raise AssertionError("phase 12: " + "; ".join(failed))
    return out


def distributed(dev, counters, zero_counters, read_counters, report) -> dict:
    """Phase 6: the distributed schedules on meshes whose ranks are
    simulated on the card, at the paper's per-rank size; returns rows for
    the kernels line (grouped_gemm and smm at the new call sites)."""
    import numpy as np
    import torch

    from repro_torch.core import dbcsr
    from repro_torch.core.blocking import GridSpec
    from repro_torch.core.cannon import cannon_rank_steps, cannon_step_masks
    from repro_torch.core.densify import to_blocks_batched
    from repro_torch.core.engine import (build_executor_plan,
                                         build_rank_executor_plan,
                                         execute_rank_plan)
    from repro_torch.core.multiply import _distributed_matmul
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref
    from repro_torch.kernels.smm.ops import smm_process_stack
    from repro_torch.kernels.smm.ref import smm_process_stack_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import MultiplyService

    P, NL, BS = 4, 3960, 22           # a 4x4 grid of the paper's rank
    N = P * NL                        # 15,840
    reps = 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    grid2 = GridSpec("data", "model")
    grid3 = GridSpec("data", "model", "pod")
    mesh44 = make_mesh((P, P), ("data", "model"))
    mesh244 = make_mesh((2, P, P), ("pod", "data", "model"))
    rows = {"grouped_gemm": [], "smm": []}
    summary = []

    def sync_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def run(label, mesh, a, b, exact, want, local_ms, yard_ms,
            tol=REL_TOL, calls=None, **kw):
        """One case through dbcsr.multiply: counters and traffic from the
        first call, the time of the repeat calls (bitwise the first).
        ``local_ms`` is one local multiply's time, ``calls`` the local
        multiplies a multiply makes (default: the counted launches)."""
        zero_counters()
        mesh.reset_traffic()
        c, first = sync_ms(lambda: dbcsr.multiply(a, b, mesh=mesh, **kw))
        got = read_counters()
        moved = sum(mesh.traffic.values())
        for key in counters:
            if got[key] != want.get(key, 0):
                raise AssertionError(f"{label}: launches {got}, expected "
                                     f"{want}")
        err = None
        if exact is not None:   # None: the caller checks (eps > 0)
            err = rel_err(c.data, exact)
            if not err <= tol:
                raise AssertionError(f"{label}: relative error {err:.3e} > "
                                     f"{tol:g}")
        times = []
        for _ in range(reps):
            again, ms = sync_ms(lambda: dbcsr.multiply(a, b, mesh=mesh, **kw))
            times.append(ms)
            if not torch.equal(again.data, c.data):
                raise AssertionError(f"{label}: a repeated multiply differs")
            del again
        n_launch = sum(got.values()) if calls is None else calls
        line = {"case": label, "rel_err": err, "tol": tol,
                "first_ms": first, "repeat_ms": statistics.median(times),
                "launches": {k: v for k, v in got.items() if v},
                "local_ms_per_launch": local_ms,
                "local_ms": None if local_ms is None else local_ms * n_launch,
                "matmul_ms": yard_ms, "moved_bytes": moved}
        summary.append(line)
        print(f"  {label}: err/max|C| "
              + ("checked below" if err is None else f"{err:.3e}")
              + f" (tol {tol:g}); first "
              f"{first:.1f} ms, repeat {line['repeat_ms']:.1f} ms; launches "
              f"{line['launches']}; local kernel "
              + ("timed below" if local_ms is None else
                 f"{local_ms:.3f} ms x {n_launch} = {line['local_ms']:.1f} ms")
              + f"; torch.matmul {yard_ms:.1f} ms; moved between ranks "
              f"{moved / 1e9:.3f} GB")
        return c

    def gg_row(label, a, b, launches, tol=REL_TOL):
        """grouped_gemm on the stacked per-rank operands a step gives it:
        kernel, plain and library (both torch.bmm) times."""
        e, m, k = a.shape
        n = b.shape[2]
        ms = time_ms(lambda: grouped_gemm(a, b), 3)
        plain_ms = time_ms(lambda: grouped_gemm_ref(a, b), 3)
        out = grouped_gemm(a, b)
        err = check_close(f"grouped_gemm {label} kernel vs plain", out,
                          grouped_gemm_ref(a, b), tol)
        del out
        row = report("grouped_gemm", label, ms, plain_ms, plain_ms,
                     2.0 * e * m * k * n, 4 * e * (m * k + k * n + m * n),
                     launches)
        row["max_abs_err"] = err
        rows["grouped_gemm"].append(row)
        return ms

    def rank_row(rp, a, b, launches):
        """smm at one rank-exact step: the 16 ranks' own triples
        concatenated, ONE launch on the rank-stacked blocks of ``a`` and
        ``b`` (global), against its plain version on the same triples
        (30,000 rows at a time) and torch.bmm of the ranks' operands."""
        a_r, b_r = mesh44.shard(a, spec), mesh44.shard(b, spec)
        a_blk = to_blocks_batched(a_r, BS, BS)
        b_blk = to_blocks_batched(b_r, BS, BS)
        c = torch.zeros((P * P, rp.n_c_blocks, BS, BS), device=dev)
        ms = time_ms(lambda: execute_rank_plan(rp, a_blk, b_blk, c), 3,
                     setup=c.zero_)
        out_k = c.clone()
        t, r = rp.device_triples(dev)
        flat = (a_blk.view(-1, BS, BS), b_blk.view(-1, BS, BS),
                c.view(-1, BS, BS))

        def plain():
            for s0 in range(0, t.shape[0], 30000):
                smm_process_stack_ref(*flat, t[s0:s0 + 30000])

        plain_ms = time_ms(plain, 1, setup=c.zero_)
        err = check_close("smm (p) rank-exact step, 16 ranks, kernel vs "
                          "plain", out_k, c)
        lib_ms = time_ms(lambda: torch.bmm(a_r, b_r), 3)
        tri = rp.triples
        used_a = np.zeros(P * P * rp.nbr * rp.nbk, dtype=bool)
        used_b = np.zeros(P * P * rp.nbk * rp.nbc, dtype=bool)
        used_a[tri[:, 0]] = True
        used_b[tri[:, 1]] = True
        row = report(
            "smm", f"one rank-exact step of (p), 16 ranks concatenated "
            f"({NL}^2 a rank, block {BS}, A 20 % fill)", ms, plain_ms,
            lib_ms, 2.0 * tri.shape[0] * BS ** 3,
            4 * BS * BS * (int(used_a.sum()) + int(used_b.sum())
                           + 2 * int(r.shape[0]))
            + 16 * tri.shape[0] + 4 * int(r.shape[0]), launches)
        row["max_abs_err"] = err
        row["rows"] = int(tri.shape[0])
        del a_r, b_r, a_blk, b_blk, c, out_k, flat
        return row, ms

    def rank_stats(label, a, b, **kw):
        """The executed plan's per-rank statistics for the multiply
        dbcsr.multiply(a, b) makes (one more multiply, through the layer
        below it, which returns them)."""
        eps = kw.get("filter_eps")
        norms = ({} if eps is None
                 else dict(a_norms=a.norms(), b_norms=b.norms()))
        _, st = _distributed_matmul(
            a.data, b.data, mesh=mesh44, grid=grid2, algorithm="cannon",
            densify=False, block_m=BS, block_k=BS, block_n=BS,
            a_mask=a.block_mask, b_mask=b.block_mask, **norms, **kw)
        print(f"    {label}: per-rank triples over the multiply "
              f"{st['rank_entries']}; busiest {st['max_rank_entries']}, mean "
              f"{st['mean_rank_entries']:.0f}, imbalance "
              f"{st['rank_imbalance']:.4f}; smm launches {st['n_launches']}")
        summary[-1].update(rank_entries=st["rank_entries"],
                           max_rank_entries=st["max_rank_entries"],
                           rank_imbalance=st["rank_imbalance"])
        return st

    # ---------------------------------------------------------- (o)-(r)
    A = torch.randn(N, N, generator=gen, device=dev)
    B = torch.randn(N, N, generator=gen, device=dev)
    yard = time_ms(lambda: torch.matmul(A, B), 3)
    exact = torch.matmul(A, B)
    print(f"  operands {N}^2 f32; torch.matmul of the global product "
          f"{yard:.1f} ms (one card's yardstick)")
    dA = dbcsr.create(A, mesh=mesh44, grid=grid2, block_size=BS)
    dB = dbcsr.create(B, mesh=mesh44, grid=grid2, block_size=BS)
    spec = ("data", "model")
    a16, b16 = mesh44.shard(A, spec), mesh44.shard(B, spec)
    t_bmm = time_ms(lambda: torch.matmul(a16, b16), 3)
    t_gg = gg_row(f"16 x {NL}^3 (6 (o)/(q): a 4x4 step)", a16, b16, P)
    run("(o) cannon 4x4 densified torch.matmul", mesh44, dA, dB, exact, {},
        t_bmm, yard, calls=P, algorithm="cannon", densify=True)
    run("(o) cannon 4x4 densified pallas", mesh44, dA, dB, exact,
        {"grouped_gemm": P}, t_gg, yard, algorithm="cannon", densify=True,
        local_kernel="pallas")
    run("(q) summa 4x4 psum densified pallas", mesh44, dA, dB, exact,
        {"grouped_gemm": P}, t_gg, yard, algorithm="summa", bcast="psum",
        densify=True, local_kernel="pallas")
    # PUMMA: one step on the gathered full-K row of A and column of B
    a_row = mesh44.all_gather(a16, "model", axis=1)
    b_col = mesh44.all_gather(b16, "data", axis=0)
    t_ggw = gg_row(f"16 x {NL}x{N}x{NL} (6 (q) gather)", a_row, b_col, 1)
    del a_row, b_col
    run("(q) summa 4x4 gather densified pallas", mesh44, dA, dB, exact,
        {"grouped_gemm": 1}, t_ggw, yard, algorithm="summa", bcast="gather",
        densify=True, local_kernel="pallas")

    # (p) blocked, block 22: the per-rank plan is phase 2's (a)
    plan = build_executor_plan(NL, NL, NL, BS, BS, BS,
                               table_tile(BS, NL // BS))
    a_blk = to_blocks_batched(a16[:1], BS, BS)[0]
    b_blk = to_blocks_batched(b16[:1], BS, BS)[0]
    cbuf = torch.zeros((plan.n_c_blocks + 1, BS, BS), device=dev)

    def smm_one_rank(p):
        def go():
            for t, r in p.device_bins(dev):
                smm_process_stack(a_blk, b_blk, cbuf, t, r)
        return time_ms(go, 3, setup=cbuf.zero_)

    t_smm = smm_one_rank(plan)
    del a16, b16
    run("(p) cannon 4x4 blocked dense", mesh44, dA, dB, exact,
        {"smm": P * P * P * plan.n_launches}, t_smm, yard,
        algorithm="cannon", densify=False)
    nb = N // BS
    rng = np.random.RandomState(SEED + 6)
    am = rng.rand(nb, nb) < 0.2
    dAm = dbcsr.create(A, mesh=mesh44, grid=grid2, block_size=BS,
                       block_mask=am)
    exact_m = torch.matmul(dAm.data, B)
    steps = cannon_step_masks(am, np.ones((nb, nb), bool), P)
    plans = [build_executor_plan(NL, NL, NL, BS, BS, BS,
                                 table_tile(BS, NL // BS, pair_mask=pm),
                                 pair_mask=pm)
             for pm in steps]
    fill = [p.n_entries / p.n_dense_triples for p in plans]
    print(f"  (p) A at 20 % block fill: union plans over 16 ranks hold "
          f"{', '.join(f'{100 * f:.1f}' for f in fill)} % of the dense "
          f"triples a step")
    t_masked = sum(smm_one_rank(p) for p in plans) / len(plans)
    n_masked = P * P * sum(p.n_launches for p in plans)
    # step 0's plan on rank 0's blocks: kernel against its plain version
    # (stack by stack) and one torch.matmul of the rank's operands
    p0 = plans[0]
    cbuf.zero_()
    for t, r in p0.device_bins(dev):
        smm_process_stack(a_blk, b_blk, cbuf, t, r)
    out_k = cbuf[:-1].clone()

    def plain():
        for (t, _), tri in zip(p0.device_bins(dev), p0.bin_triples):
            for s0 in range(0, t.shape[0], tri.shape[1]):
                smm_process_stack_ref(a_blk, b_blk, cbuf, t[s0:s0 + tri.shape[1]])

    plain_ms = time_ms(plain, 1, setup=cbuf.zero_)
    err = check_close("smm (p) union plan kernel vs plain", out_k, cbuf[:-1])
    a0, b0 = dA.data[:NL, :NL], dB.data[:NL, :NL]
    lib_ms = time_ms(lambda: torch.matmul(a0, b0), 3)
    rows_used = sum(int(t.shape[0]) for t, _ in p0.device_bins(dev))
    runs = sum(int(r.shape[0]) for _, r in p0.device_bins(dev))
    row = report(
        "smm", f"one rank's step 0, {NL}^2 block {BS}, A 20 % fill over 16 "
        "ranks (6 (p), union plan)", smm_one_rank(p0), plain_ms, lib_ms,
        2.0 * p0.n_entries * BS ** 3,
        4 * BS * BS * (2 * nb // P * nb // P + 2 * p0.n_c_blocks)
        + 16 * rows_used + 4 * runs, n_masked)
    row["max_abs_err"] = err
    rows["smm"].append(row)
    del out_k
    c_none = run("(p) cannon 4x4 blocked, A 20 % fill, eps None, union",
                 mesh44, dAm, dB, exact_m, {"smm": n_masked}, t_masked, yard,
                 algorithm="cannon", densify=False, rank_exact=False)
    c_zero = run("(p) cannon 4x4 blocked, A 20 % fill, eps 0, union", mesh44,
                 dAm, dB, exact_m, {"smm": n_masked}, t_masked, yard,
                 algorithm="cannon", densify=False, filter_eps=0.0,
                 rank_exact=False)
    if not torch.equal(c_none.data, c_zero.data):
        raise AssertionError("(p) eps 0 is not bitwise equal to eps None")
    del cbuf, a_blk, b_blk

    # (p) rank-exact (the default): each rank runs its own plan, and a
    # step is ONE smm launch over the 16 ranks' concatenated triples.
    # The multiplies run first, so their first calls build the plans.
    t_rank = None
    for eps, union in ((None, c_none), (0.0, c_zero)):
        c = run(f"(p) cannon 4x4 blocked, A 20 % fill, eps {eps}, "
                "rank-exact", mesh44, dAm, dB, exact_m, {"smm": P}, t_rank,
                yard, algorithm="cannon", densify=False, filter_eps=eps)
        if not torch.equal(c.data, union.data):
            raise AssertionError(f"(p) eps {eps}: rank-exact is not bitwise "
                                 "the union plan")
        rank_stats(f"(p) eps {eps} rank-exact", dAm, dB, filter_eps=eps)
        del c
        if t_rank is None:
            # the plans the multiply built (memoized), one a step
            rplans = [build_rank_executor_plan(
                NL, NL, NL, block_m=BS, block_k=BS, block_n=BS,
                rank_masks=rm, stack_size=table_tile(BS, NL // BS,
                                                     rank_masks=rm),
                rank_order=mesh44.flat_index(("data", "model")))
                for rm in cannon_rank_steps(am, np.ones((nb, nb), bool), P)]
            print("  (p) rank-exact plans: the busiest rank holds "
                  + ", ".join(f"{100 * p.occupancy:.1f}" for p in rplans)
                  + " % of its dense triples a step (rank imbalance "
                  + ", ".join(f"{p.rank_imbalance:.3f}" for p in rplans)
                  + ")")
            row, t_rank = rank_row(rplans[0], dAm.data, B,
                                   sum(p.n_launches for p in rplans))
            rows["smm"].append(row)
            line = next(x for x in summary if x["case"].endswith(
                "eps None, rank-exact"))
            line.update(local_ms_per_launch=t_rank, local_ms=t_rank * P)
            print(f"    eps None rank-exact: local kernel {t_rank:.3f} ms x "
                  f"{P} = {t_rank * P:.1f} ms")
    del c_none, c_zero

    # (p) eps > 0, rank-exact: each rank filters by its own norms, which
    # is the exact per-triple filter (norm products of f32 norms formed
    # in f64 are exact, so there is no rounding at eps)
    an, bn = dAm.norms(), dB.norms()
    ii, kk = np.nonzero(am)
    pick = rng.randint(0, ii.size, 1 << 20)
    eps = float(np.median(an[ii[pick], kk[pick]].astype(np.float64)
                          * bn[kk[pick], rng.randint(0, nb, 1 << 20)]))
    c_eps = run(f"(p) cannon 4x4 blocked, A 20 % fill, eps {eps:.4g}, "
                "rank-exact", mesh44, dAm, dB, None, {"smm": P}, t_rank,
                yard, algorithm="cannon", densify=False, filter_eps=eps)
    st = rank_stats(f"(p) eps {eps:.4g} rank-exact", dAm, dB,
                    filter_eps=eps)
    an_d = torch.tensor(np.where(am, an, 0), dtype=torch.float64, device=dev)
    bn_d = torch.tensor(bn, dtype=torch.float64, device=dev)
    am_d = torch.tensor(am, device=dev)
    kept, dropped = 0, torch.zeros((nb, nb), dtype=torch.float64, device=dev)
    retained = torch.zeros((nb, nb), dtype=torch.bool, device=dev)
    for i0 in range(0, nb, 45):
        prod = an_d[i0:i0 + 45, :, None] * bn_d[None]
        present = am_d[i0:i0 + 45, :, None].expand_as(prod)
        keep = present & (prod >= eps)
        kept += int(keep.sum())
        dropped[i0:i0 + 45] = torch.where(present & ~keep, prod, 0.0).sum(1)
        retained[i0:i0 + 45] = keep.any(dim=1)
        del prod, present, keep
    if sum(st["rank_entries"]) != kept:
        raise AssertionError(f"(p) eps: the ranks ran {sum(st['rank_entries'])}"
                             f" triples, the exact filter keeps {kept}")
    if not np.array_equal(c_eps.block_mask, retained.cpu().numpy()):
        raise AssertionError("(p) eps result mask != retained product mask")
    bound = dropped + REL_TOL * float(exact_m.abs().max()) * BS
    diff = (c_eps.data - exact_m).reshape(nb, BS, nb, BS)
    blk_err = torch.sqrt((diff.double() ** 2).sum(dim=(1, 3)))
    worst = float((blk_err / bound).max())
    present_all = int(am.sum()) * nb
    print(f"  (p) eps: {present_all - kept} of {present_all} triples dropped "
          f"(the ranks ran exactly the {kept} the exact filter keeps); worst "
          f"block error / dropped bound = {worst:.3f}")
    if not worst <= 1.0:
        raise AssertionError("(p) eps error exceeds the dropped-norm bound")
    del c_eps, diff, blk_err, an_d, bn_d, am_d, dropped, retained, bound
    del dAm, exact_m

    # SUMMA 4x4 on a hot-corner mask (the first tenth of the block rows
    # and columns full, 5 % elsewhere): the costed rebalance permutes
    # block rows of A and columns of B; SUMMA's panel order does not
    # depend on the rank, so the product is bitwise the unpermuted one
    hot = rng.rand(nb, nb) < 0.05
    hot[:nb // 10] = True
    hot[:, :nb // 10] = True
    dAh = dbcsr.create(A, mesh=mesh44, grid=grid2, block_size=BS,
                       block_mask=hot)
    dBh = dbcsr.create(B, mesh=mesh44, grid=grid2, block_size=BS,
                       block_mask=hot)
    exact_h = torch.matmul(dAh.data, dBh.data)
    hot_out = {}
    for rebalance in (False, True):
        kw = dict(mesh=mesh44, grid=grid2, algorithm="summa",
                  densify=False, block_m=BS, block_k=BS, block_n=BS,
                  a_mask=hot, b_mask=hot, rebalance=rebalance)
        zero_counters()
        (c, st), first = sync_ms(
            lambda: _distributed_matmul(dAh.data, dBh.data, **kw))
        got = read_counters()
        if got["smm"] != st["n_launches"] or sum(got.values()) != got["smm"]:
            raise AssertionError(f"hot summa: launches {got}, plan "
                                 f"{st['n_launches']}")
        err = check_close(f"hot summa 4x4 rebalance={rebalance}", c,
                          exact_h) / float(exact_h.abs().max())
        times = [sync_ms(lambda: _distributed_matmul(
            dAh.data, dBh.data, **kw))[1] for _ in range(reps)]
        line = {"case": f"hot-corner summa 4x4 blocked, rebalance="
                        f"{rebalance}", "rel_err": err, "tol": REL_TOL,
                "first_ms": first, "repeat_ms": statistics.median(times),
                "launches": {"smm": got["smm"]},
                "rank_imbalance": st["rank_imbalance"],
                "max_rank_entries": st["max_rank_entries"],
                "mean_rank_entries": st["mean_rank_entries"]}
        for key in ("rebalance_method", "rebalance_imbalance_before",
                    "rebalance_imbalance_after"):
            if key in st:
                line[key] = st[key]
        summary.append(line)
        print(f"    first {first:.1f} ms, repeat {line['repeat_ms']:.1f} ms; "
              f"smm launches {got['smm']}; busiest rank "
              f"{st['max_rank_entries']} triples, mean "
              f"{st['mean_rank_entries']:.0f}, imbalance "
              f"{st['rank_imbalance']:.3f}"
              + (f"; planned imbalance {st['rebalance_imbalance_before']:.3f}"
                 f" -> {st['rebalance_imbalance_after']:.3f} "
                 f"({st['rebalance_method']})" if rebalance else ""))
        if rebalance and not st["rebalance_applied"]:
            raise AssertionError("hot summa: rebalance=True permuted nothing")
        hot_out[rebalance] = c
    if not torch.equal(hot_out[False], hot_out[True]):
        raise AssertionError("hot summa: the rebalanced product is not "
                             "bitwise the unpermuted one")
    del hot_out, c, dAh, dBh, exact_h

    # (r) 2.5D on 2x4x4: stack 2, R = 32, each replica half the shifts
    dA3 = dbcsr.create(A, mesh=mesh244, grid=grid3, block_size=BS)
    dB3 = dbcsr.create(B, mesh=mesh244, grid=grid3, block_size=BS)
    a32, b32 = mesh244.shard(A, spec), mesh244.shard(B, spec)
    t_gg32 = gg_row(f"32 x {NL}^3 (6 (r): a 2x4x4 step)", a32, b32, 2)
    del a32, b32
    for red in ("all_reduce", "reduce_scatter"):
        run(f"(r) cannon25d 2x4x4 {red} densified pallas", mesh244, dA3,
            dB3, exact, {"grouped_gemm": P // 2}, t_gg32, yard,
            algorithm="cannon25d", reduce=red, densify=True,
            local_kernel="pallas")
    del dA, dB, dA3, dB3, A, B, exact
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- (s)
    M, K = 1408, 1982464              # benchmarks/bench_vs_pgemm.py:60
    torch.cuda.reset_peak_memory_stats(dev)
    As = torch.randn(M, K, generator=gen, device=dev)
    Bs = torch.randn(K, M, generator=gen, device=dev)
    yard_s = time_ms(lambda: torch.matmul(As, Bs), 3)
    exact_s = torch.matmul(As, Bs)
    # the f64 product, in K chunks, to see both f32 sums' errors
    exact64 = torch.zeros((M, M), dtype=torch.float64, device=dev)
    for k0 in range(0, K, K // 16):
        exact64 += As[:, k0:k0 + K // 16].double() @ Bs[k0:k0 + K // 16].double()
    scale = float(exact64.abs().max())
    err_lib = float((exact_s.double() - exact64).abs().max()) / scale
    print(f"  (s) {M} x {K:,} x {M} f32 ({2 * M * K * 4 / 1e9:.1f} GB of "
          f"operands); torch.matmul {yard_s:.1f} ms, its error against the "
          f"f64 product {err_lib:.3e} of max|C|")
    a_s = mesh44.shard(As, (None, spec))
    b_s = mesh44.shard(Bs, (spec, None))
    t_ggs = gg_row(f"16 x {M}x{K // 16}x{M} (6 (s): ts_k)", a_s, b_s, 1,
                   tol=TS_TOL)
    del a_s, b_s
    torch.cuda.empty_cache()
    dAs = dbcsr.create(As, mesh=mesh44, grid=grid2, block_size=BS)
    dBs = dbcsr.create(Bs, mesh=mesh44, grid=grid2, block_size=BS)
    for red in ("all_reduce", "reduce_scatter"):
        c = run(f"(s) ts_k 16 ranks {red} densified pallas", mesh44, dAs,
                dBs, exact_s, {"grouped_gemm": 1}, t_ggs, yard_s, tol=TS_TOL,
                algorithm="ts_k", reduce=red, densify=True,
                local_kernel="pallas")
        err64 = float((c.data.double() - exact64).abs().max()) / scale
        summary[-1]["rel_err_f64"] = err64
        print(f"    against the f64 product: {err64:.3e} of max|C|")
        if not err64 <= TS_TOL:
            raise AssertionError(f"(s) {red}: error {err64:.3e} against f64")
        del c
    print(f"  (s) peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.1f}"
          " GB (operands, their rank-stacked copies, C)")
    del As, Bs, dAs, dBs, exact_s, exact64
    torch.cuda.empty_cache()

    # ------------------------------------------- batched SUMMA on 2x2
    mesh22 = make_mesh((2, 2), ("data", "model"))
    G, NS = 4, 880
    reqs = [(dbcsr.create(torch.randn(NS, NS, generator=gen, device=dev),
                          mesh=mesh22, block_size=BS),
             dbcsr.create(torch.randn(NS, NS, generator=gen, device=dev),
                          mesh=mesh22, block_size=BS)) for _ in range(G)]
    for densify, key, per_panel in ((False, "smm", 4), (True, "grouped_gemm",
                                                        1)):
        kw = dict(algorithm="summa", densify=densify, pipeline_depth=1,
                  local_kernel="pallas" if densify else None)
        zero_counters()
        fused = dbcsr.multiply_batched(reqs, mesh=mesh22, fused=True, **kw)
        got = read_counters()
        if got[key] != 2 * per_panel or sum(got.values()) != got[key]:
            raise AssertionError(f"batched summa: launches {got}")
        looped = dbcsr.multiply_batched(reqs, mesh=mesh22, fused=False, **kw)
        svc = MultiplyService(mesh22, fused=True, max_batch=G, slo_s=60.0,
                              **kw)
        tickets = [svc.submit(a, b) for a, b in reqs]
        svc.flush()
        served = [svc.result(t) for t in tickets]
        st = svc.stats()
        if st["n_fused_requests"] != G or st["n_error_tickets"]:
            raise AssertionError(f"summa service stats {st}")
        for i, (x, y, z, (a, b)) in enumerate(zip(fused, looped, served,
                                                  reqs)):
            if not (torch.equal(x.data, y.data)
                    and torch.equal(x.data, z.data)):
                raise AssertionError(f"batched summa request {i}: fused "
                                     "!= looped")
            check_close(f"batched summa {'densified' if densify else 'blocked'}"
                        f" request {i}", x.data, torch.matmul(a.data, b.data))
        print(f"  batched summa 2x2, {G} x {NS}^2, "
              f"{'densified pallas' if densify else 'blocked'}: launches "
              f"{ {k: v for k, v in got.items() if v} }, fused == looped == "
              "MultiplyService bitwise")
    print(json.dumps({"phase6": summary}))
    return rows


def sync_s(fn):
    """(fn(), seconds) on the host clock, synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


PLAN_ROUNDS = 3   # phase 7: interleaved rounds a timing (2 more on a retry)


def time_interleaved(fns, reps: int) -> list:
    """Median of ``reps`` synchronized host-clock timings per callable,
    the callables taken round-robin so drift of the host hits each alike
    (the JAX package's benchmarks/bench_planner.py:58-70), after one
    warm-up call each."""
    for fn in fns:
        sync_s(fn)
    samples = [[] for _ in fns]
    for _ in range(reps):
        for i, fn in enumerate(fns):
            samples[i].append(sync_s(fn)[1])
    return [statistics.median(x) for x in samples]


def regret_gate(t_auto: float, t_best: float) -> bool:
    """The JAX package's planner gate (scripts/ci.sh: bench_planner
    --check): auto within 10 % of the best pinned time plus 1 ms."""
    return t_auto <= 1.10 * t_best + 1e-3


def planner(dev, card, zero_counters, read_counters) -> dict:
    """Phase 7: the multiply planner on the card; returns its summary.
    It plans with the constants it measures, saved where the default
    entry points read them, and then leaves the working directory's
    calibration file as it found it (absent, or the one it held), so
    that a later run or test plans as if phase 7 had not run."""
    from repro_torch.planner import calibrate
    from repro_torch.planner.plan import plan_cache_clear

    path = calibrate.DEFAULT_CALIBRATION
    before = None
    if os.path.exists(path):
        with open(path) as f:
            before = f.read()
    try:
        return planner_cases(dev, card, zero_counters, read_counters)
    finally:
        if before is None:
            if os.path.exists(path):
                os.remove(path)
        else:
            with open(path, "w") as f:
                f.write(before)
        calibrate.invalidate_cache()
        plan_cache_clear()


def planner_cases(dev, card, zero_counters, read_counters) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import dbcsr
    from repro_torch.core.blocking import GridSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.planner import calibrate
    from repro_torch.planner.plan import plan_cache_clear
    from repro_torch.serve import MultiplyService

    grid = GridSpec("data", "model")
    mesh44 = make_mesh((4, 4), ("data", "model"))
    mesh = make_mesh((1, 1), ("data", "model"))
    summary = {"card": card, "cases": []}

    # ------------------------------------------------- (1) calibration
    print(f"phase 7 (1): micro_calibrate on the card ({card}); bytes_per_s, "
          "latency_s and overlap_* on a 4x4 mesh of simulated ranks")
    consts = calibrate.micro_calibrate(mesh44, grid, log=print)
    path = calibrate.save_calibration(consts)
    calibrate.invalidate_cache()
    plan_cache_clear()
    print(f"  saved -> {path}; constants beside DEFAULT_HARDWARE:")
    print(calibrate.describe(consts, mesh44))
    summary["calibration"] = consts

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rng = np.random.RandomState(SEED + 7)

    def dense(r, c):
        return torch.randn((r, c), generator=gen, device=dev)

    def winner(plan) -> str:
        lines = plan.explain().splitlines()
        star = [ln for ln in lines if ln.startswith("*")]
        return lines[0] + ("\n    " + star[0].strip() if star else "")

    def expect_kernel(label, plan, got, local_kernel=None):
        """The path went through the kernels of its plan."""
        if plan.trivial:
            return
        if not plan.densify and got["smm"] < 1:
            raise AssertionError(f"{label}: blocked plan, no smm launch")
        if plan.densify and local_kernel == "pallas" and \
                got["grouped_gemm"] + got["tiled_matmul"] < 1:
            raise AssertionError(f"{label}: densified pallas plan, no GEMM "
                                 "kernel launch")

    def record(label, plan, t_auto, t_best, best, rows, gate, first_s):
        regret = t_auto / t_best - 1.0
        line = {"case": label, "auto": f"{plan.algorithm}+"
                + ("densified" if plan.densify else "blocked"),
                "predicted_ms": 1e3 * plan.predicted_s,
                "auto_ms": 1e3 * t_auto, "best_ms": 1e3 * t_best,
                "best": best, "regret": regret, "gated": gate,
                "first_s": first_s, "pinned": rows,
                "occupancy": plan.occupancy}
        summary["cases"].append(line)
        print(f"  {label}: auto {line['auto']} {1e3 * t_auto:.3f} ms "
              f"(predicted {1e3 * plan.predicted_s:.3f} ms); best pinned "
              f"{best} {1e3 * t_best:.3f} ms; regret {100 * regret:.1f} %"
              + (" (gate: 10 % + 1 ms)" if gate else " (not gated)"))
        return line

    # ------------------------------------------- (2) 1x1 multiplies
    print("phase 7 (2): dbcsr.multiply(a, b, mesh=mesh) with no algorithm= "
          "or densify=, 1x1 mesh; every feasible pinned (algorithm, "
          f"densify) timed beside it (median of {PLAN_ROUNDS} interleaved "
          "rounds)")

    def auto_case(label, a, b, exact, gate, **kw):
        zero_counters()
        (c, plan), first = sync_s(lambda: dbcsr.multiply(
            a, b, mesh=mesh, return_plan=True, **kw))
        got = read_counters()
        if c.last_plan is not plan:
            raise AssertionError(f"{label}: last_plan is not the plan")
        expect_kernel(label, plan, got)
        check_close(f"{label} auto vs torch.matmul", c.data, exact)
        pinned = dbcsr.multiply(a, b, mesh=mesh, algorithm=plan.algorithm,
                                densify=plan.densify, **kw)
        if not torch.equal(pinned.data, c.data):
            raise AssertionError(f"{label}: auto != its pinned plan")
        del pinned
        print(f"  {label}: first call {first:.3f} s, launches "
              f"{ {k: v for k, v in got.items() if v} }; {winner(plan)}")
        cands = [x for x in plan.candidates if x.feasible]
        fns = [lambda x=x: dbcsr.multiply(a, b, mesh=mesh,
                                          algorithm=x.algorithm,
                                          densify=x.densify, **kw)
               for x in cands]
        fns.append(lambda: dbcsr.multiply(a, b, mesh=mesh, **kw))
        for attempt in range(2):
            times = time_interleaved(fns, PLAN_ROUNDS + 2 * attempt)
            rows = [{"config": x.label, "predicted_ms": 1e3 * x.total_s,
                     "ms": 1e3 * t} for x, t in zip(cands, times)]
            chosen = [t for x, t in zip(cands, times)
                      if (x.algorithm, x.densify) == (plan.algorithm,
                                                      plan.densify)]
            t_auto = min([times[-1]] + chosen)
            i_best = int(np.argmin(times[:-1]))
            if not gate or regret_gate(t_auto, times[i_best]) or attempt:
                break
            print(f"  {label}: regret gate failed once, measuring again")
        line = record(label, plan, t_auto, times[i_best],
                      cands[i_best].label, rows, gate, first)
        if gate and not regret_gate(t_auto, times[i_best]):
            raise AssertionError(f"{label}: regret {line['regret']:.3f} "
                                 "over the gate")
        return plan

    A = dbcsr.create(dense(3960, 3960), mesh=mesh, block_size=22)
    B = dbcsr.create(dense(3960, 3960), mesh=mesh, block_size=22)
    exact = torch.matmul(A.data, B.data)
    auto_case("(a) 3960^2 block 22 dense (= (d)/(e)'s operands)", A, B, exact,
              True)
    nb = 180
    am = rng.rand(nb, nb) < 0.2
    Am = dbcsr.create(dense(3960, 3960), mesh=mesh, block_size=22,
                      block_mask=am)
    exact = torch.matmul(Am.data, B.data)
    auto_case("(c) 3960^2 block 22, A at 20 % fill, mask only", Am, B,
              exact, False)
    auto_case("(c) the same, filter_eps=0", Am, B, exact, False,
              filter_eps=0.0)
    del A, B, Am, exact
    A = dbcsr.create(dense(4096, 4096), mesh=mesh, block_size=64)
    B = dbcsr.create(dense(4096, 4096), mesh=mesh, block_size=64)
    auto_case("(b) 4096^2 block 64 dense", A, B,
              torch.matmul(A.data, B.data), True)
    del A, B
    # tall-skinny: one rank's share of (s), 1,408 x 123,904 x 1,408
    A = dbcsr.create(dense(1408, 123904), mesh=mesh, block_size=22)
    B = dbcsr.create(dense(123904, 1408), mesh=mesh, block_size=22)
    auto_case("(t) 1408 x 123904 x 1408 block 22 dense", A, B,
              torch.matmul(A.data, B.data), False)
    del A, B
    torch.cuda.empty_cache()

    # ------------------------------------------- (3) batch of 16
    G, NB, BS = 16, 1980, 22
    print(f"phase 7 (3): {G} requests of {NB}^2 block {BS}, 1x1 mesh, "
          "MultiplyService() and multiply_batched with no fused= and no "
          "algorithm=, beside the pinned fused / looped x blocked / "
          f"densified dispatches (median of {PLAN_ROUNDS} interleaved "
          "rounds)")
    nbb = NB // BS
    dense_reqs = [(dbcsr.create(dense(NB, NB), mesh=mesh, block_size=BS),
                   dbcsr.create(dense(NB, NB), mesh=mesh, block_size=BS))
                  for _ in range(G)]
    sparse_reqs = [(dbcsr.create(dense(NB, NB), mesh=mesh, block_size=BS,
                                 block_mask=rng.rand(nbb, nbb) < 0.2),
                    dbcsr.create(dense(NB, NB), mesh=mesh, block_size=BS))
                   for _ in range(G // 2)]

    def serve(reqs, **kw):
        svc = MultiplyService(mesh, max_batch=G, slo_s=60.0, **kw)
        tickets = [svc.submit(a, b) for a, b in reqs]
        svc.flush()
        return [svc.result(t) for t in tickets], svc.stats()

    def batch_case(label, reqs, gate, **kw):
        zero_counters()
        (served, st), first = sync_s(lambda: serve(reqs, **kw))
        got = read_counters()
        if st["n_error_tickets"] or st["n_degradations"]:
            raise AssertionError(f"{label}: service stats {st}")
        out, report = dbcsr.multiply_batched(reqs, mesh=mesh,
                                             return_plan=True, **kw)
        for x, y in zip(served, out):
            if not torch.equal(x.data, y.data):
                raise AssertionError(f"{label}: service != multiply_batched")
        for x, (a, b) in zip(out, reqs):
            if not rel_err(x.data, torch.matmul(a.data, b.data)) <= REL_TOL:
                raise AssertionError(f"{label}: a product is off")
        for r in report["buckets"]:
            if r["plan"] is None:   # a bucket of one request goes looped
                print(f"  {label}: bucket of {r['n_requests']}: looped, "
                      "not priced")
        plans = [r["plan"] for r in report["buckets"] if r["plan"]]
        for r, plan in zip([r for r in report["buckets"] if r["plan"]],
                           plans):
            if plan.fuse != r["fused"]:
                raise AssertionError(f"{label}: fuse decision not followed")
            expect_kernel(label, plan.per_request, got,
                          kw.get("local_kernel"))
            print(f"  {label}: bucket of {r['n_requests']}: "
                  f"{plan.explain().splitlines()[0]}\n    "
                  + winner(plan.per_request).replace("\n", "\n    "))
        print(f"    first flush {first:.3f} s, launches "
              f"{ {k: v for k, v in got.items() if v} }")
        algo = plans[0].algorithm
        configs = [(f, d) for f in (True, False) for d in (True, False)]
        fns = [lambda f=f, d=d: dbcsr.multiply_batched(
            reqs, mesh=mesh, fused=f, algorithm=algo, densify=d, **kw)
            for f, d in configs]
        # with one bucket, the service pinned to the plan's own dispatch:
        # the default service's extra time over it is the planning's
        svc_pin = (dict(fused=plans[0].fuse, algorithm=algo,
                        densify=plans[0].densify) if len(plans) == 1
                   else None)
        if svc_pin:
            fns.append(lambda: serve(reqs, **svc_pin, **kw))
        fns.append(lambda: serve(reqs, **kw))
        fns.append(lambda: dbcsr.multiply_batched(reqs, mesh=mesh, **kw))
        pinned_f = dbcsr.multiply_batched(reqs, mesh=mesh, fused=True,
                                          algorithm=algo, densify=False,
                                          pipeline_depth=1, **kw)
        pinned_l = dbcsr.multiply_batched(reqs, mesh=mesh, fused=False,
                                          algorithm=algo, densify=False,
                                          pipeline_depth=1, **kw)
        if not all(torch.equal(x.data, y.data)
                   for x, y in zip(pinned_f, pinned_l)):
            raise AssertionError(f"{label}: fused blocked != looped")
        del pinned_f, pinned_l
        if len(plans) == 1:
            own = dbcsr.multiply_batched(reqs, mesh=mesh, fused=plans[0].fuse,
                                         algorithm=algo,
                                         densify=plans[0].densify, **kw)
            if not all(torch.equal(x.data, y.data)
                       for x, y in zip(own, out)):
                raise AssertionError(f"{label}: auto != its pinned plan")
            del own
        # the auto dispatch's time: its own call or, with one bucket, the
        # pinned run of the same configuration (bench_planner's rule)
        own = ([configs.index((plans[0].fuse, plans[0].densify))]
               if len(plans) == 1 else [])
        def passes(times, t_auto, i_best):
            """Both gates: multiply_batched's auto against the best
            pinned dispatch, the default service against the pinned."""
            return (regret_gate(t_auto, times[i_best])
                    and (not svc_pin or regret_gate(times[-2], times[-3])))

        for attempt in range(2):
            times = time_interleaved(fns, PLAN_ROUNDS + 2 * attempt)
            t_auto = min([times[-1]] + [times[i] for i in own])
            i_best = int(np.argmin(times[:len(configs)]))
            if not gate or passes(times, t_auto, i_best) or attempt:
                break
            print(f"  {label}: regret gate failed once, measuring again")
        names = [f"{algo} {'fused' if f else 'looped'} "
                 f"{'densified' if d else 'blocked'}" for f, d in configs]
        rows = [{"config": n, "ms": 1e3 * t} for n, t in zip(names, times)]
        rows.append({"config": "MultiplyService() flush", "ms":
                     1e3 * times[-2]})
        svc_regret = None
        if svc_pin:
            svc_regret = times[-2] / times[-3] - 1.0
            rows.append({"config": "MultiplyService(fused="
                         f"{svc_pin['fused']}, algorithm={algo!r}, densify="
                         f"{svc_pin['densify']}) flush", "ms":
                         1e3 * times[-3]})
        print(f"    MultiplyService() submit + flush + result: "
              f"{1e3 * times[-2]:.3f} ms"
              + (f" against {1e3 * times[-3]:.3f} ms pinned to the plan's "
                 f"dispatch (regret {100 * svc_regret:.1f} %)"
                 if svc_pin else "")
              + f"; multiply_batched auto {1e3 * times[-1]:.3f} ms")
        pred = sum(p.predicted_fused_s if p.fuse else p.predicted_looped_s
                   for p in plans)
        line = record(label, plans[0].per_request, t_auto, times[i_best],
                      names[i_best], rows, gate, first)
        line.update(predicted_ms=1e3 * pred,
                    fuse=[p.fuse for p in plans],
                    auto=[p.algorithm + ("+densified" if p.densify
                                         else "+blocked") for p in plans])
        line["service_regret"] = svc_regret
        print(f"    predicted (the buckets' chosen dispatch) "
              f"{1e3 * pred:.3f} ms; fuse {line['fuse']}")
        if gate and not passes(times, t_auto, i_best):
            raise AssertionError(
                f"{label}: regret {line['regret']:.3f}, service regret "
                f"{svc_regret} over the gate")

    batch_case(f"(f) {G} dense", dense_reqs, True)
    batch_case(f"(h) {G} dense, local_kernel='pallas'", dense_reqs, False,
               local_kernel="pallas")
    batch_case(f"(g) {G // 2} dense + {G // 2} at 20 % fill",
               dense_reqs[:G // 2] + sparse_reqs, False)
    del dense_reqs, sparse_reqs
    torch.cuda.empty_cache()

    # ------------------------------------------- (4) simulated 4x4
    P, NL, BS = 4, 3960, 22
    N = P * NL
    nb = N // BS
    print(f"phase 7 (4): auto on a 4x4 mesh of simulated ranks at (o)'s and "
          f"(p)'s sizes ({N}^2, block {BS}), local_kernel='pallas'; the "
          "ranks share one card, so predicted and measured are printed and "
          "nothing is gated")
    A = dense(N, N)
    B = dense(N, N)
    dB = dbcsr.create(B, mesh=mesh44, grid=grid, block_size=BS)
    hot = rng.rand(nb, nb) < 0.05
    hot[:nb // 10] = True
    hot[:, :nb // 10] = True
    cases = [("(o) dense", None, None),
             ("(p) A at 20 % fill", rng.rand(nb, nb) < 0.2, None),
             ("(p') hot corner A and B", hot, hot)]
    for label, a_mask, b_mask in cases:
        dA = dbcsr.create(A, mesh=mesh44, grid=grid, block_size=BS,
                          block_mask=a_mask)
        dBm = dB if b_mask is None else dbcsr.create(
            B, mesh=mesh44, grid=grid, block_size=BS, block_mask=b_mask)
        exact = torch.matmul(dA.data, dBm.data)
        kw = dict(mesh=mesh44, local_kernel="pallas")
        zero_counters()
        (c, plan), first = sync_s(lambda: dbcsr.multiply(
            dA, dBm, return_plan=True, **kw))
        got = read_counters()
        if c.last_plan is not plan:
            raise AssertionError(f"{label}: last_plan is not the plan")
        expect_kernel(label, plan, got, "pallas")
        check_close(f"{label} auto vs torch.matmul", c.data, exact)
        del exact
        pin = dict(algorithm=plan.algorithm, densify=plan.densify,
                   rebalance=plan.rebalance, **kw)
        pinned, _ = sync_s(lambda: dbcsr.multiply(dA, dBm, **pin))
        if not torch.equal(pinned.data, c.data):
            raise AssertionError(f"{label}: auto != its pinned plan")
        del pinned
        t_auto = statistics.median(
            sync_s(lambda: dbcsr.multiply(dA, dBm, **kw))[1]
            for _ in range(2))
        es = plan.executor_stats or {}
        line = {"case": label, "mesh": "4x4 simulated",
                "auto": f"{plan.algorithm}+"
                + ("densified" if plan.densify else "blocked"),
                "predicted_ms": 1e3 * plan.predicted_s,
                "auto_ms": 1e3 * t_auto, "first_s": first,
                "rank_imbalance": plan.rank_imbalance,
                "rebalance_armed": plan.rebalance,
                "rebalance_applied": es.get("rebalance_applied", False),
                "launches": {k: v for k, v in got.items() if v},
                "infeasible": [x.label + ": " + x.reason
                               for x in plan.candidates
                               if not x.feasible and "GB" in x.reason]}
        if b_mask is not None:
            # the pass's price: the same plan with the pass toggled (one
            # warm-up call builds the other distribution's rank plans)
            other = dict(pin, rebalance=not plan.rebalance)
            sync_s(lambda: dbcsr.multiply(dA, dBm, **other))
            line["toggled_rebalance_ms"] = 1e3 * statistics.median(
                sync_s(lambda: dbcsr.multiply(dA, dBm, **other))[1]
                for _ in range(2))
        summary["cases"].append(line)
        print(f"  {label}: {winner(plan)}\n    first {first:.3f} s, repeat "
              f"{1e3 * t_auto:.1f} ms against predicted "
              f"{1e3 * plan.predicted_s:.3f} ms (one rank's time; 16 share "
              f"the card); rank imbalance {plan.rank_imbalance:.4f}, "
              f"rebalance {'armed' if plan.rebalance else 'declined'} "
              f"(saves {1e3 * plan.rebalance_saved_s:.3f} ms vs "
              f"{1e3 * plan.rebalance_cost_s:.3f} ms permute cost)"
              + (f"; with rebalance={not plan.rebalance} "
                 f"{line['toggled_rebalance_ms']:.1f} ms"
                 if "toggled_rebalance_ms" in line else "")
              + f"; launches {line['launches']}; memory-gated candidates "
              f"{line['infeasible'] or 'none'}")
        del c, dA, dBm
    del A, B, dB
    torch.cuda.empty_cache()
    print(json.dumps({"phase7": summary}))
    return summary


# ---------------------------------------------------------------------------
# phase 8: purification (u) and self-verifying multiplies (v)
# ---------------------------------------------------------------------------

PUR_N = 15840        # (u): (p)'s matrix, 720^2 blocks of 22 on 4x4
PUR_ITERS = 6         # ||P^2 - P|| is 1.8e-10 after the 6th, 2.6e-22
                      # after the 8th
# (u): max |P - exact density| after PUR_ITERS iterations.  The exact
# density of banded_hamiltonian is the diagonal parity projector; the
# iteration converges to it quadratically and filter(1e-6) drops any
# block below 1e-6, so what is left is f32 rounding of entries 0 and 1
# (observed 0.0 at n 1,760 on the CPU).
PUR_TOL = 1e-6
PUR_VERIFY = 1       # (u): iterations with verify="checksum", and the same
                     # unverified before and after them
ABFT_GATE = 0.25     # the JAX package's gate on the measured overhead
ABFT_NL, ABFT_P = 3960, 4        # (v): one rank's side; the 4x4 grid
ABFT_BATCH = (16, 1980)          # (v): (f)'s batch


class HostSplit:
    """Exclusive host time of named functions of the port: each module
    attribute the port looks up at call time is wrapped while the split
    is open; a function's time excludes the wrapped functions it calls."""

    def __init__(self, targets):
        self.totals = {label: 0.0 for label, _, _ in targets}
        self._stack = []
        self._undo = []
        for label, mod, attr in targets:
            fn = getattr(mod, attr)
            setattr(mod, attr, self._wrap(label, fn))
            self._undo.append((mod, attr, fn))

    def _wrap(self, label, fn):
        def timed(*args, **kw):
            self._stack.append(0.0)
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t
                inner = self._stack.pop()
                self.totals[label] += dt - inner
                if self._stack:
                    self._stack[-1] += dt
        return timed

    def take(self) -> dict:
        out = dict(self.totals)
        for label in self.totals:
            self.totals[label] = 0.0
        return out

    def close(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)


class KernelClock:
    """CUDA events around every stack-kernel launch: the engine resolves
    its stack processor (``engine._resolve_process``) at each execution,
    and the clock wraps what it returns while open; ``take()`` syncs and
    returns the seconds since the last take."""

    def __init__(self):
        import torch

        from repro_torch.core import engine

        self._engine, self._resolve = engine, engine._resolve_process
        self._events = []

        def resolve(kernel):
            fn = self._resolve(kernel)

            def timed(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                stop.record()
                self._events.append((start, stop))
                return out

            return timed

        engine._resolve_process = resolve

    def take(self) -> float:
        import torch

        torch.cuda.synchronize()
        s = sum(a.elapsed_time(b) for a, b in self._events) / 1e3
        self._events = []
        return s

    def close(self):
        self._engine._resolve_process = self._resolve


def host_targets():
    """The host planning functions the (u) split times, by label."""
    from repro_torch.core import dbcsr as dbcsr_mod
    from repro_torch.core import engine
    from repro_torch.core import multiply as mult
    from repro_torch.planner import plan as pplan
    from repro_torch.robustness import abft
    from repro_torch.sparsity import balance, norms
    from repro_torch.sparsity import filter as sfilter

    steps = [("step masks and norms", mult, name) for name in (
        "cannon_rank_steps", "cannon_step_masks", "cannon_step_norms",
        "summa_rank_steps", "summa_step_masks", "summa_step_norms",
        "summa_gather_rank_steps", "summa_gather_masks",
        "summa_gather_norms", "ts_rank_steps", "ts_step_masks",
        "ts_step_norms", "_masks_empty")]
    return steps + [
        ("product_mask", sfilter, "product_mask"),
        ("fingerprints", engine, "_array_fingerprint"),
        ("retained_block_weights", balance, "retained_block_weights"),
        ("mask expansion", dbcsr_mod, "_expand_mask"),
        ("block norms", norms, "block_norms_of"),
        ("occupancy", engine, "_mask_fill"),
        ("stack plans", engine, "_build_executor_plan_cached"),
        ("rank plan concat", engine, "_concat_rank_plans"),
        ("planner", pplan, "plan_multiply"),
        ("abft", abft, "verify_and_repair"),
    ]


def pur_setup(dev):
    """(u)'s operands: P0 of banded_hamiltonian(PUR_N, 22) on a simulated
    4x4 mesh, and the exact density's diagonal; (P0, mesh, exact, set-up
    seconds)."""
    import numpy as np
    import torch

    from repro_torch.core import dbcsr
    from repro_torch.core.blocking import GridSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sparsity.workloads import (banded_hamiltonian,
                                                initial_density)

    t = time.perf_counter()
    H, mask = banded_hamiltonian(PUR_N, 22)
    P0h = initial_density(H)
    del H
    mesh = make_mesh((4, 4), ("data", "model"), device=dev)
    P0 = dbcsr.create(P0h.astype(np.float32), mesh=mesh,
                      grid=GridSpec("data", "model"), block_size=22,
                      block_mask=mask)
    exact = torch.zeros(PUR_N, device=dev)
    exact[0::2] = 1.0
    return P0, mesh, exact, time.perf_counter() - t


def pur_trajectory(P0, mesh, exact, name, iters, split, clock,
                   zero_counters, read_counters, keep=(), converged=True,
                   **extra):
    """(u): ``iters`` McWeeny iterations from P0, each timed (wall, smm by
    CUDA events, the host split); with ``converged``, P held within
    PUR_TOL of the exact density.  Returns (P, trace, the iterates of
    ``keep``, the error or None, the lines to print)."""
    import torch

    from repro_torch.examples.purification import FILTER_EPS
    from repro_torch.sparsity.workloads import mcweeny_purify

    P, trace, kept = P0, [], {}
    lines = [f"  (u) {name}: iter occupancy blocks retained filtered "
             f"busiest idempotency tr(P) smm_launches smm_ms wall_ms "
             f"host_ms | host split ms"]
    for it in range(iters):
        split.take()
        clock.take()
        zero_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        P, (e,) = mcweeny_purify(
            P, mesh=mesh, n_iter=1, filter_eps=FILTER_EPS,
            multiply_kw=dict(densify=False, local_kernel="smm", **extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        kernel = clock.take()
        got = read_counters()
        host = split.take()
        e.update(iteration=it, smm_launches=got["smm"],
                 smm_ms=1e3 * kernel, wall_ms=1e3 * wall,
                 host_ms=1e3 * (wall - kernel),
                 host_split_ms={k: 1e3 * v for k, v in host.items()
                                if v > 0})
        trace.append(e)
        if it in keep:
            kept[it] = P
        top = sorted(e["host_split_ms"].items(), key=lambda kv: -kv[1])
        lines.append(
            f"    {it:2d} {e['occupancy']:.5f} {e['n_blocks']:6d} "
            f"{e.get('n_retained_triples', 0):9d} "
            f"{e.get('n_norm_filtered_triples', 0):9d} "
            f"{e.get('max_rank_entries', 0):9d} "
            f"{e['idempotency']:.3e} {e['trace_P']:.2f} "
            f"{got['smm']:3d} {1e3 * kernel:8.2f} "
            f"{1e3 * wall:9.1f} {1e3 * (wall - kernel):9.1f} | "
            + ", ".join(f"{k} {v:.1f}" for k, v in top))
    err = None
    if converged:
        err = float((P.data - torch.diag(exact)).abs().max())
        lines.append(f"  (u) {name}: max |P - exact density| {err:.3e} "
                     f"(tolerance {PUR_TOL:g})")
        if not err <= PUR_TOL:
            raise AssertionError("\n".join(lines) + f"\n(u) {name}: P is "
                                 f"{err:.3e} from the exact density")
    return P, trace, kept, err, lines


def pur_union() -> dict:
    """(u)'s union trajectory (``rank_exact=False``), in a process of its
    own beside the rank-exact one: both are host-bound planning on a core
    each.  Returns its trace, error, lines and set-up seconds."""
    import torch

    from repro_torch.kernels.smm.ops import smm_process_stack

    use_repo_table()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def zero():
        smm_process_stack.launches = 0

    def read():
        return {"smm": smm_process_stack.launches}

    P0, mesh, exact, setup_s = pur_setup(dev)
    split = HostSplit(host_targets())
    clock = KernelClock()
    try:
        _, trace, _, err, lines = pur_trajectory(
            P0, mesh, exact, "union", PUR_ITERS, split, clock, zero, read,
            rank_exact=False)
    finally:
        split.close()
        clock.close()
    return {"trace": trace, "err": err, "lines": lines, "setup_s": setup_s}


def purification(dev, card, zero_counters, read_counters, report) -> dict:
    """(u): McWeeny purification at (p)'s size on a simulated 4x4 mesh,
    blocked with the smm kernel, union (in a second process, beside) and
    rank-exact, then PUR_VERIFY verified iterations; one smm row at a
    rank-exact step of its peak iterate.  Returns (its record, the smm
    row, the union process's smm launches)."""
    import numpy as np
    import torch

    from repro_torch.core import dbcsr, engine
    from repro_torch.examples.purification import (FILTER_EPS,
                                                   purification_checks)
    from repro_torch.kernels.smm.ref import smm_process_stack_ref

    N, BS = PUR_N, 22
    pool, union_run = spawn_beside(pur_union)
    P0, mesh, exact, setup_s = pur_setup(dev)
    nb = N // BS
    print(f"phase 8 (u): McWeeny purification, {N}^2 in {nb}^2 blocks of "
          f"{BS} on a 4x4 mesh of simulated ranks ({N // 4}^2 a rank), "
          f"filter_eps {FILTER_EPS:g}, blocked smm, {PUR_ITERS} iterations; "
          f"set-up {setup_s:.1f} s (host numpy H and P0, float64); P0 "
          f"occupancy {P0.occupancy:.4f}, tr(P0) {float(P0.trace()):.2f}, "
          f"electrons {N // 2}; the union trajectory in a second process "
          f"beside the rank-exact one")
    base_kw = dict(densify=False, local_kernel="smm")
    split = HostSplit(host_targets())
    clock = KernelClock()
    out = {"n": N, "block": BS, "eps": FILTER_EPS, "runs": {}}
    try:
        def trajectory(name, iters, **kw):
            P, trace, kept, err, lines = pur_trajectory(
                P0, mesh, exact, name, iters, split, clock, zero_counters,
                read_counters, **kw)
            print("\n".join(lines))
            out["runs"][name] = {"trace": trace}
            if err is not None:
                out["runs"][name]["max_err_exact"] = err
            return P, trace, kept

        # every iterate kept: the union's peak is known once it returns
        P_r, exact_tr, kept = trajectory("rank-exact", PUR_ITERS,
                                         keep=range(PUR_ITERS))
        with pool:
            got = union_run.result()
        print("\n".join(got["lines"]))
        union = got["trace"]
        out["runs"]["union"] = {"trace": union, "max_err_exact": got["err"]}
        union_launches = sum(e["smm_launches"] for e in union)
        occs = [e["occupancy"] for e in union]
        peak = occs.index(max(occs))
        kept = {k: kept[k] for k in (PUR_VERIFY - 1, peak)}
        for name, tr in (("union", union), ("rank-exact", exact_tr)):
            ok = purification_checks(tr, union if name == "rank-exact"
                                     else tr, N)
            print(f"  (u) {name}: {ok}")
            if not (ok["monotone"] and ok["decayed"] and ok["electrons"]):
                raise AssertionError(f"(u) {name}: purification properties "
                                     f"{ok}")
            if name == "rank-exact" and not ok["shrunk"]:
                raise AssertionError("(u) rank-exact did not shrink the "
                                     "busiest rank's load on every iteration")
            out["runs"][name]["checks"] = ok
        if sum(e["smm_launches"] for e in exact_tr) < 1:
            raise AssertionError("(u) no smm launch")
        for name in ("union", "rank-exact"):
            tr = out["runs"][name]["trace"]
            wall = sum(e["wall_ms"] for e in tr)
            kern = sum(e["smm_ms"] for e in tr)
            split_tot = {}
            for e in tr:
                for k, v in e["host_split_ms"].items():
                    split_tot[k] = split_tot.get(k, 0.0) + v
            split_tot["other host (wall - smm - the above)"] = (
                wall - kern - sum(split_tot.values()))
            out["runs"][name]["totals_ms"] = {"wall": wall, "smm": kern,
                                             **split_tot}
            print(f"  (u) {name} over {PUR_ITERS} iterations: wall "
                  f"{wall:.1f} ms, smm {kern:.1f} ms; host split ms: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                      split_tot.items(), key=lambda kv: -kv[1])))

        # PUR_VERIFY iterations with verify="checksum": no detection, bitwise the
        # unverified rank-exact iterates
        real = dbcsr.multiply
        reports = []

        def spy(*args, **kw):
            res = real(*args, **kw)
            c = res[0] if isinstance(res, tuple) else res
            reports.append(c.verification)
            return res

        # the same iterations unverified before and after, their plans
        # memoized as the verified run's are
        _, warm0, _ = trajectory("rank-exact again", PUR_VERIFY,
                                 converged=False)
        dbcsr.multiply = spy
        try:
            P_v, ver_tr, _ = trajectory("rank-exact verify=checksum",
                                        PUR_VERIFY,
                                        converged=False, verify="checksum")
        finally:
            dbcsr.multiply = real
        _, warm1, _ = trajectory("rank-exact again", PUR_VERIFY,
                                 converged=False)
        bad = [r for r in reports
               if not r["enabled"] or r["report"].detected]
        if bad or len(reports) != 2 * PUR_VERIFY:
            raise AssertionError(f"(u) verified iterations: {len(reports)} "
                                 f"multiplies, {len(bad)} not clean")
        if not torch.equal(P_v.data, kept[PUR_VERIFY - 1].data):
            raise AssertionError("(u) verified iterates differ from the "
                                 "unverified ones")
        over = [2.0 * v["wall_ms"] / (u0["wall_ms"] + u1["wall_ms"]) - 1.0
                for v, u0, u1 in zip(ver_tr, warm0, warm1)]
        fracs = [r["overhead_frac"] for r in reports]
        print(f"  (u) verify=checksum: {2 * PUR_VERIFY} multiplies, no "
              f"detection, bitwise "
              f"the unverified iterates; iteration wall overhead against "
              f"the mean of the unverified runs before and after "
              + ", ".join(f"{100 * x:.1f} %" for x in over)
              + "; decide_verify overhead_frac "
              + ", ".join(f"{100 * x:.1f} %" for x in fracs))
        out["verify"] = {"wall_overhead": over, "overhead_frac": fracs}
        del P_v, P_r

        # smm at the shape (u) gives it: the largest rank-exact launch of
        # P_peak @ P_peak, replayed against its plain version
        P_pk = kept[peak]
        seen = {}
        real_exec = engine.execute_rank_plan

        def capture(plan, a_blocks, b_blocks, c_blocks, **kw):
            rows_ = int(plan.triples.shape[0])
            if rows_ > seen.get("rows", -1):
                seen.update(rows=rows_, plan=plan, a=a_blocks, b=b_blocks,
                            c=c_blocks.clone())
            return real_exec(plan, a_blocks, b_blocks, c_blocks, **kw)

        engine.execute_rank_plan = capture
        try:
            dbcsr.multiply(P_pk, P_pk, mesh=mesh, filter_eps=FILTER_EPS,
                           **base_kw)
        finally:
            engine.execute_rank_plan = real_exec
    finally:
        split.close()
        clock.close()
    rp, a_blk, b_blk, c0 = (seen["plan"], seen["a"], seen["b"], seen["c"])
    c = c0.clone()
    ms = time_ms(lambda: real_exec(rp, a_blk, b_blk, c), 3,
                 setup=lambda: c.copy_(c0))
    c.copy_(c0)
    real_exec(rp, a_blk, b_blk, c)
    out_k = c.clone()
    trip, runs = rp.device_triples(dev)
    R = a_blk.shape[0]
    flat = (a_blk.reshape((-1, BS, BS)), b_blk.reshape((-1, BS, BS)),
            c.view(-1, BS, BS))

    def plain():
        for s0 in range(0, trip.shape[0], 30000):
            smm_process_stack_ref(*flat, trip[s0:s0 + 30000])

    plain_ms = time_ms(plain, 1, setup=lambda: c.copy_(c0))
    c.copy_(c0)
    plain()
    err = check_close(f"smm (u) rank-exact launch of iterate {peak}, kernel "
                      "vs plain", out_k, c)
    a_r = (a_blk.reshape(R, rp.nbr, rp.nbk, BS, BS).permute(0, 1, 3, 2, 4)
           .reshape(R, rp.nbr * BS, rp.nbk * BS))
    b_r = (b_blk.reshape(R, rp.nbk, rp.nbc, BS, BS).permute(0, 1, 3, 2, 4)
           .reshape(R, rp.nbk * BS, rp.nbc * BS))
    lib_ms = time_ms(lambda: torch.bmm(a_r, b_r), 3)
    tri = rp.triples
    valid = tri[:, 3] != 0 if tri.shape[1] > 3 else np.ones(len(tri), bool)
    used = [np.unique(tri[valid, i]).size for i in range(3)]
    row = report(
        "smm", f"(u) one rank-exact launch of P @ P at iterate {peak} "
        f"({R} ranks, {rp.nbr * BS}^2 a rank, block {BS})", ms, plain_ms,
        lib_ms, 2.0 * int(valid.sum()) * BS ** 3,
        4 * BS * BS * (used[0] + used[1] + 2 * used[2])
        + 16 * tri.shape[0] + 4 * int(runs.shape[0]), 1)
    row["max_abs_err"] = err
    row["rows"] = int(tri.shape[0])
    out["smm_row"] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms")}
    del a_r, b_r, flat, c, c0, out_k, seen, kept, P_pk, P0
    torch.cuda.empty_cache()
    return out, row, union_launches


def abft(dev, card, zero_counters, read_counters) -> dict:
    """(v): verify="checksum" against verify=None at five points, the
    batch of 16 under multiply_batched, and the injection matrices."""
    import numpy as np
    import torch

    from repro_torch.core import dbcsr
    from repro_torch.core import multiply as mult
    from repro_torch.core.blocking import GridSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.robustness import chaos, guards
    from repro_torch.sparsity.norms import compute_block_norms

    NL, BS, P = ABFT_NL, 22, ABFT_P
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rng = np.random.RandomState(SEED + 8)
    grid = GridSpec("data", "model")
    mesh11 = make_mesh((1, 1), ("data", "model"))
    mesh44 = make_mesh((P, P), ("data", "model"))
    rows = []

    def dense(n):
        return torch.randn((n, n), generator=gen, device=dev)

    def gap_eps(a, am, b, q=50.0):
        """An eps near the q-th percentile of the present triples' norm
        products, in the widest gap among the 2,000 products around it
        (all products, sorted on the card).  Cannon's step plans compare
        f32 products with eps while the tolerance's dropped mass forms
        them in f64, so a product within f32 rounding of eps could be
        dropped by one and kept by the other (as phase 2 does for (c))."""
        an = torch.tensor(np.where(am, a.norms(), 0), dtype=torch.float64,
                          device=dev)
        bn = torch.tensor(b.norms(), dtype=torch.float64, device=dev)
        ii, kk = np.nonzero(am)
        ii, kk = torch.from_numpy(ii).to(dev), torch.from_numpy(kk).to(dev)
        prod = (an[ii, kk][:, None] * bn[kk]).flatten().sort().values
        mid = int(prod.numel() * q / 100.0)
        half = max(min(1000, prod.numel() // 400), 1)
        win = prod[max(mid - half, 0):mid + half + 1]
        i = int(torch.argmax(win[1:] / win[:-1]))
        eps = float(torch.sqrt(win[i] * win[i + 1]))
        del an, bn, prod, win
        return eps

    def margin(res, tol):
        """The largest residual / tolerance where the tolerance is not 0
        (a block row of zeros has both 0)."""
        ok = tol > 0
        return float(np.max(res[ok] / tol[ok])) if ok.any() else 0.0

    def point(label, mesh, a, b, reps, **kw):
        kw = dict(mesh=mesh, algorithm="cannon", **kw)
        zero_counters()
        clean = dbcsr.multiply(a, b, **kw)
        got = read_counters()
        cv, plan = dbcsr.multiply(a, b, verify="checksum", return_plan=True,
                                  **kw)
        info = plan.verification
        rep = info["report"]
        if not info["enabled"] or rep.detected:
            raise AssertionError(f"(v) {label}: clean run {info}")
        if not torch.equal(cv.data, clean.data):
            raise AssertionError(f"(v) {label}: verified != unverified")
        del cv
        norms = compute_block_norms(clean.data, BS, BS)
        i0, j0 = (int(x) for x in np.unravel_index(int(np.argmax(norms)),
                                                     norms.shape))
        line = {"case": label, "launches": {k: v for k, v in got.items()
                                            if v},
                "clean_margin": max(margin(rep.row_residual, rep.row_tol),
                                    margin(rep.col_residual, rep.col_tol)),
                "block": [i0, j0], "modes": {}}
        for mode in ("bitflip", "nan", "scale"):
            # the corruption's own checksum signature: one block moves
            # each checksum element of its block row and column by the
            # element it changes, so detection (and exact localization)
            # is guaranteed when the largest change exceeds both
            # tolerances plus the clean residuals
            delta = (chaos.FaultInjector(seed=SEED).corrupt_block(
                clean.data, i0, j0, block_m=BS, block_n=BS, mode=mode)
                - clean.data)[i0 * BS:(i0 + 1) * BS, j0 * BS:(j0 + 1) * BS]
            sig = float(delta.double().abs().max())
            need_r = rep.row_tol[i0] + rep.row_residual[i0]
            need_c = rep.col_tol[j0] + rep.col_residual[j0]
            guaranteed = not (sig <= max(need_r, need_c))
            hook = chaos.FaultInjector(seed=SEED).one_shot_result_hook(
                i0, j0, block_m=BS, block_n=BS, mode=mode)
            with chaos.result_corruption(hook):
                cr, pl = dbcsr.multiply(a, b, verify="checksum",
                                        return_plan=True, **kw)
            r = pl.verification["report"]
            res = {"signature_over_tol": sig / max(need_r, need_c),
                   "guaranteed": guaranteed, "detected": r.detected,
                   "localized_exact": r.flagged_blocks == ((i0, j0),),
                   "flagged_rows": list(r.flagged_rows[:8]),
                   "flagged_cols": list(r.flagged_cols[:8]),
                   "repaired": r.repaired,
                   "bitwise_clean": bool(torch.equal(cr.data, clean.data))}
            line["modes"][mode] = res
            del cr
            ok = (res["detected"] and res["localized_exact"]
                  and res["repaired"] and res["bitwise_clean"])
            if guaranteed and not ok:
                raise AssertionError(f"(v) {label} {mode}: {res}")
            if r.detected and not (r.repaired and res["bitwise_clean"]):
                raise AssertionError(f"(v) {label} {mode}: detected but not "
                                     f"repaired bitwise: {res}")
        # a persistent fault (every dispatch corrupted, the repair too)
        real = mult.cannon_matmul

        def corrupted(*args, **kwargs):
            return chaos.corrupt_block(real(*args, **kwargs), i0, j0,
                                       block_m=BS, block_n=BS, mode="nan")

        mult.cannon_matmul = corrupted
        try:
            dbcsr.multiply(a, b, verify="checksum", **kw)
            raise AssertionError(f"(v) {label}: a persistent fault passed")
        except guards.CorruptionDetectedError:
            line["persistent_raises"] = True
        finally:
            mult.cannon_matmul = real
        auto = dbcsr.multiply(a, b, verify="auto", **kw).verification
        t_none, t_ver = time_interleaved(
            [lambda: dbcsr.multiply(a, b, **kw),
             lambda: dbcsr.multiply(a, b, verify="checksum", **kw)], reps)
        over = t_ver / t_none - 1.0
        line.update(none_ms=1e3 * t_none, checksum_ms=1e3 * t_ver,
                    overhead=over, predicted_ms=1e3 * plan.predicted_s,
                    overhead_frac=info["overhead_frac"],
                    predicted_overhead_ms=1e3 * info["predicted_overhead_s"],
                    auto_enabled=auto["enabled"])
        rows.append(line)
        def outcome(x):
            if not x["detected"]:
                return "MISSED"
            where = ("exact" if x["localized_exact"] else
                     f"rows {x['flagged_rows']} x cols {x['flagged_cols']}")
            return (f"detected, {where}, repaired"
                    + (" bitwise" if x["bitwise_clean"] else " NOT bitwise"))

        modes = "; ".join(
            f"{m} {outcome(x)} (largest change / tolerance "
            f"{x['signature_over_tol']:.3g}"
            + (")" if x["guaranteed"] else ": not guaranteed)")
            for m, x in line["modes"].items())
        print(f"  (v) {label}: launches {line['launches']}; clean: no "
              f"detection (max residual / tolerance "
              f"{line['clean_margin']:.3g}); block ({i0}, {j0}): {modes}; "
              f"persistent NaN raises CorruptionDetectedError\n"
              f"      verify=None {1e3 * t_none:.3f} ms, checksum "
              f"{1e3 * t_ver:.3f} ms: overhead {100 * over:.1f} % (gate "
              f"{100 * ABFT_GATE:.0f} %: "
              f"{'within' if over <= ABFT_GATE else 'MISSED, not fatal'}); "
              f"decide_verify predicts "
              f"{1e3 * info['predicted_overhead_s']:.3f} ms = "
              f"{100 * info['overhead_frac']:.1f} % of predicted "
              f"{1e3 * plan.predicted_s:.3f} ms; verify=\"auto\" "
              f"{'enables' if auto['enabled'] else 'declines'}")
        return line

    print(f"phase 8 (v): verify=\"checksum\" against verify=None, algorithm="
          f"\"cannon\" pinned ({card})")
    A = dbcsr.create(dense(NL), mesh=mesh11, block_size=BS)
    B = dbcsr.create(dense(NL), mesh=mesh11, block_size=BS)
    point(f"(a) {NL}^2 block 22 blocked, depth 1", mesh11, A, B, 5,
          densify=False, pipeline_depth=1)
    point(f"(a) {NL}^2 densified pallas (tiled_matmul)", mesh11, A, B, 5,
          densify=True, local_kernel="pallas")
    nb = NL // BS
    am = rng.rand(nb, nb) < 0.2
    Am = dbcsr.create(dense(NL), mesh=mesh11, block_size=BS, block_mask=am)
    for q in (50.0, 1.0):
        eps = gap_eps(Am, am, B, q)
        point(f"(c) A 20 % fill, blocked, eps {eps:.4g} (percentile {q:g} "
              "of the norm products)", mesh11, Am, B, 5, densify=False,
              filter_eps=eps)
    del A, B, Am
    N = P * NL
    A = dbcsr.create(dense(N), mesh=mesh44, grid=grid, block_size=BS)
    B = dbcsr.create(dense(N), mesh=mesh44, grid=grid, block_size=BS)
    point(f"(o) {N}^2 4x4 densified pallas (grouped_gemm)", mesh44, A, B, 2,
          densify=True, local_kernel="pallas")
    am = rng.rand(N // BS, N // BS) < 0.2
    Am = dbcsr.create(A.data, mesh=mesh44, grid=grid, block_size=BS,
                      block_mask=am)
    del A
    eps = gap_eps(Am, am, B)
    point(f"(p) {N}^2 4x4 blocked rank-exact, A 20 % fill, eps {eps:.4g}",
          mesh44, Am, B, 1, densify=False, filter_eps=eps)
    del Am, B
    torch.cuda.empty_cache()

    # (f)'s batch of 16 under verify: looped, bitwise the unverified loop
    G, NB = ABFT_BATCH
    reqs = [(dbcsr.create(dense(NB), mesh=mesh11, block_size=BS),
             dbcsr.create(dense(NB), mesh=mesh11, block_size=BS))
            for _ in range(G)]
    bkw = dict(mesh=mesh11, algorithm="cannon", densify=False)
    out, rep = dbcsr.multiply_batched(reqs, verify="checksum",
                                      return_plan=True, **bkw)
    looped = dbcsr.multiply_batched(reqs, fused=False, **bkw)
    if any(b["fused"] for b in rep["buckets"]):
        raise AssertionError("(v) (f) under verify= ran fused")
    for x, y in zip(out, looped):
        if not torch.equal(x.data, y.data) or \
                x.verification["report"].detected:
            raise AssertionError("(v) (f) verified batch differs or detects")
    try:
        dbcsr.multiply_batched(reqs, verify="checksum", fused=True, **bkw)
        raise AssertionError("(v) fused=True with verify= did not raise")
    except ValueError:
        pass
    print(f"  (v) (f) {G} x {NB}^2 multiply_batched(verify=\"checksum\"): "
          "looped, no detection, bitwise the unverified loop; fused=True "
          "with verify= raises ValueError")
    del reqs, out, looped

    matrix = {}
    for name, shape in (("1x1", (1, 1)), ("2x2", (2, 2))):
        mrows = chaos.run_injection_matrix(
            make_mesh(shape, ("data", "model")), name, local_kernel="smm")
        bad = [r for r in mrows if not r["ok"]]
        inj = [r for r in mrows if r["injected_block"] is not None]
        fp = sum(r["detected"] for r in mrows if r["injected_block"] is None)
        print(f"  (v) run_injection_matrix {name}, smm: {len(inj)} "
              f"injections, {sum(r['ok'] for r in inj)} detected, exact, "
              f"repaired, bitwise; {len(mrows) - len(inj)} clean runs, "
              f"{fp} false positives")
        if bad:
            raise AssertionError(f"(v) injection matrix {name}: {bad}")
        matrix[name] = len(mrows)
    return {"points": rows, "matrix_rows": matrix}


def abft_process() -> dict:
    """(v) in a process of its own, beside (u)'s two trajectories: they
    are host-bound planning that leaves the card idle, (v) mostly card
    work.  Returns (v)'s record, the lines it printed and the kernels it
    launched."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
    from repro_torch.kernels.smm.ops import smm_process_stack
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul

    use_repo_table()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counters = {"smm": smm_process_stack, "tiled_matmul": tiled_matmul,
                "grouped_gemm": grouped_gemm}
    total = dict.fromkeys(counters, 0)

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        got = {key: fn.launches for key, fn in counters.items()}
        for key in total:
            total[key] += got[key]
        return got

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ver = abft(dev, card_line(), zero, read)
    return {"abft": ver, "lines": out.getvalue(), "launches": total}


def spawn_beside(fn):
    """``fn`` (a module-level function of this script) in a spawned
    process started now, with 2 host threads (its work is serial numpy
    and launches: the host's cores stay this process's); returns
    (pool, future)."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    threads = {k: os.environ.get(k) for k in (
        "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
    os.environ.update(dict.fromkeys(threads, "2"))
    try:
        return pool, pool.submit(fn)    # starts the process
    finally:
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def robustness(dev, card, zero_counters, read_counters, report):
    """Phase 8: (u) here and (v) in a process beside it (abft_process);
    returns the smm row of (u) for the kernels line and the launches of
    the phase's other processes ((u)'s union trajectory's, (v)'s)."""
    pool, ver_run = spawn_beside(abft_process)
    pur, row, union_launches = purification(dev, card, zero_counters,
                                            read_counters, report)
    with pool:
        got = ver_run.result()
    print(got["lines"], end="")
    launches = dict(got["launches"])
    launches["smm"] += union_launches
    print(json.dumps({"phase8": {"card": card, "purification": pur,
                                 "abft": got["abft"]}}))
    return [row], launches


# ---------------------------------------------------------------------------
# phase 9: telemetry on the card (w) and tensor contractions (x)
# ---------------------------------------------------------------------------
STEP_SUM_TOL = 0.05   # step spans against their dispatch: the JAX
#                       package's STEP_SUM_TOL (benchmarks/bench_obs.py:48)
OBS_GATE = 0.05       # its traced-over-untraced overhead gate (printed)
OBS_ROUNDS = 3
P_ROUNDS = 2          # (p): ~0.7 s a call
OBS_A = (3960, 22)                # (a): side, block
OBS_F = (16, 1980)                # (f): requests, side
OBS_P = (4, 3960)                 # (p): grid side, side a rank
TEN_DIMS = (128, 1024, 2048)      # N_I, N_A, N_P = N_Q (x)
TEN_BLOCKS = (8, 16, 16)          # the tensor example's blocks
TEN_EPS = 1e-8                    # the tensor example's filter_eps
TEN_ROUNDS = 2


def traced(fn):
    """``fn()`` with telemetry on (a fresh tracer and outcome log):
    ``(out, spans, outcomes, host_s)``, the host time synchronized."""
    from repro_torch import obs

    obs.clear_plan_outcomes()
    tracer = obs.enable()
    try:
        out, host_s = sync_s(fn)
    finally:
        obs.disable()
    return out, list(tracer.spans), obs.plan_outcomes(), host_s


def check_trace(label, spans, outcomes) -> dict:
    """The telemetry contract on one traced call: the breakdown, every
    dispatch's host interval beside its CUDA-event time, a valid Chrome
    trace, step spans summing to their dispatch within STEP_SUM_TOL, and
    the scoreboard / drift check over the call's outcome rows."""
    from repro_torch import obs

    print(f"  {label}: " + obs.render_breakdown(spans).replace(
        "\n", "\n    "))
    disps = [s for s in spans if s.name == "dispatch"]
    if not disps:
        raise AssertionError(f"{label}: no dispatch span")
    rows = []
    for d in disps:
        kids = [s for s in spans if s.parent_id == d.span_id]
        step_sum = sum(s.dur for s in kids)
        rel = abs(step_sum - d.dur) / d.dur
        dev_s = d.attrs.get("device_s")
        if dev_s is None or not 0.0 < dev_s <= d.dur:
            raise AssertionError(f"{label}: dispatch device_s {dev_s} "
                                 f"against host {d.dur}")
        if not kids or rel > STEP_SUM_TOL:
            raise AssertionError(f"{label}: step spans sum {step_sum} "
                                 f"against dispatch {d.dur}")
        rows.append({"host_ms": 1e3 * d.dur, "device_ms": 1e3 * dev_s,
                     "host_minus_device_ms": 1e3 * (d.dur - dev_s),
                     "steps": len(kids), "step_sum_rel": rel})
        print(f"    dispatch: host {1e3 * d.dur:.3f} ms, device_s "
              f"{1e3 * dev_s:.3f} ms (host - device "
              f"{1e3 * (d.dur - dev_s):.3f} ms); {len(kids)} step spans "
              f"sum to the dispatch within {100 * rel:.4f} % "
              f"(tol {100 * STEP_SUM_TOL:.0f} %)")
    errs = obs.validate_chrome_trace(obs.to_chrome_trace(spans))
    if errs:
        raise AssertionError(f"{label}: Chrome trace invalid: {errs[:3]}")
    drift = obs.check_drift(outcomes)
    print(f"    Chrome trace valid ({len(spans)} spans); scoreboard:\n      "
          + obs.render_scoreboard(drift["scoreboard"]).replace(
              "\n", "\n      ")
          + f"\n    check_drift: ok={drift['ok']} flagged "
          f"{ {k: round(v, 3) for k, v in drift['flagged'].items()} }")
    return {"case": label,
            "breakdown_ms": {k: 1e3 * v for k, v in
                             obs.category_breakdown(spans).items()},
            "dispatches": rows, "drift_ok": drift["ok"],
            "drift_flagged": drift["flagged"],
            "scoreboard": drift["scoreboard"]}


def telemetry(dev, card, zero_counters, read_counters) -> dict:
    """Phase 9 (w): traced multiplies on the card."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import dbcsr
    from repro_torch.core.blocking import GridSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.robustness import chaos
    from repro_torch.serve import MultiplyService

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rng = np.random.RandomState(SEED + 9)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {"traces": [], "overhead": []}

    def dense(r, c):
        return torch.randn((r, c), generator=gen, device=dev)

    def overhead(label, fn, rounds):
        """Untraced against traced, median of interleaved rounds."""
        def on():
            obs.enable()
            try:
                return fn()
            finally:
                obs.disable()
        t_off, t_on = time_interleaved([fn, on], rounds)
        ratio = t_on / t_off - 1.0
        print(f"  {label} overhead: traced {1e3 * t_on:.3f} ms against "
              f"untraced {1e3 * t_off:.3f} ms: {100 * ratio:+.2f} % (median "
              f"of {rounds} interleaved rounds; the JAX package's gate "
              f"{100 * OBS_GATE:.0f} %, printed, not enforced)")
        out["overhead"].append({"case": label, "untraced_ms": 1e3 * t_off,
                                "traced_ms": 1e3 * t_on, "overhead": ratio,
                                "rounds": rounds})

    def off_path(label, fn, ref):
        """Telemetry off: bitwise the traced result, no registry entry."""
        n0 = len(obs.registry())
        c = fn()
        torch.cuda.synchronize()
        if len(obs.registry()) != n0:
            raise AssertionError(f"{label}: an untraced call added "
                                 "registry entries")
        if not torch.equal(c.data, ref.data):
            raise AssertionError(f"{label}: untraced != traced")
        print(f"  {label}: telemetry off: bitwise the traced result, "
              f"registry unchanged ({n0} entries)")

    # ---- (a) 3,960^2 block 22 blocked, 1x1
    NB, BS = OBS_A
    A = dbcsr.create(dense(NB, NB), mesh=mesh, block_size=BS)
    B = dbcsr.create(dense(NB, NB), mesh=mesh, block_size=BS)
    kw_a = dict(mesh=mesh, algorithm="cannon", densify=False)
    dbcsr.multiply(A, B, **kw_a)  # the plan's first call, untraced
    zero_counters()
    c_a, spans, outc, host_s = traced(lambda: dbcsr.multiply(A, B, **kw_a))
    got = read_counters()
    if got["smm"] < 1:
        raise AssertionError("(a) traced: no smm launch")
    check_close("(a) traced vs torch.matmul", c_a.data,
                torch.matmul(A.data, B.data))
    out["traces"].append(check_trace(
        f"(a) {NB}^2 block {BS} blocked 1x1, traced", spans, outc))
    off_path("(a)", lambda: dbcsr.multiply(A, B, **kw_a), c_a)
    overhead("(a)", lambda: dbcsr.multiply(A, B, **kw_a), OBS_ROUNDS)

    # ---- verify="checksum" at (a), a NaN injected into the product
    nb = NB // BS
    i0, j0 = int(rng.randint(nb)), int(rng.randint(nb))
    before = {k: obs.counter(f"abft.{k}").value
              for k in ("detections", "repairs")}
    hook = chaos.FaultInjector(seed=SEED).one_shot_result_hook(
        i0, j0, block_m=BS, block_n=BS, mode="nan")

    def verified():
        with chaos.result_corruption(hook):
            return dbcsr.multiply(A, B, verify="checksum", **kw_a)
    c_v, spans, outc, _ = traced(verified)
    if not torch.equal(c_v.data, c_a.data):
        raise AssertionError("(a) verified: repair is not bitwise clean")
    rep = c_v.verification["report"]
    root = [s for s in spans if s.parent_id is None]
    ver = [s for s in spans if s.name == "verify"]
    repair = [s for s in spans if s.name == "repair"]
    disps = [s for s in spans if s.name == "dispatch"]
    if not (len(root) == 1 and len(ver) == 1 and len(repair) == 1
            and ver[0].parent_id == root[0].span_id
            and repair[0].parent_id == ver[0].span_id and len(disps) == 2
            and sorted(d.parent_id for d in disps)
            == sorted([root[0].span_id, repair[0].span_id])
            and rep.flagged_blocks == ((i0, j0),) and rep.repaired):
        raise AssertionError(f"(a) verified: span nesting or report wrong "
                             f"({[(s.name, s.parent_id) for s in spans][:8]},"
                             f" {rep.flagged_blocks})")
    deltas = {k: obs.counter(f"abft.{k}").value - v
              for k, v in before.items()}
    if deltas != {"detections": 1, "repairs": 1}:
        raise AssertionError(f"(a) verified: abft counters {deltas}")
    print(f"  (a) verify='checksum', NaN at block ({i0}, {j0}): multiply -> "
          f"verify -> repair -> dispatch nests as the reference's; "
          f"repaired bitwise; abft counters {deltas}")
    out["traces"].append(check_trace("(a) verified, NaN injected", spans,
                                     outc))
    first_disp = min(disps, key=lambda s: s.t0)
    (row,) = [r for r in outc if r.get("kind") == "multiply"]
    if not abs(row["measured_s"] - first_disp.dur) <= 0.05 * first_disp.dur:
        raise AssertionError("(a) verified: the outcome row is not the "
                             "first dispatch's time")
    del c_v

    # ---- (f) 16 x 1,980^2: MultiplyService() against its pinned service
    G, NF = OBS_F
    reqs = [(dbcsr.create(dense(NF, NF), mesh=mesh, block_size=BS),
             dbcsr.create(dense(NF, NF), mesh=mesh, block_size=BS))
            for _ in range(G)]
    _, report = dbcsr.multiply_batched(reqs, mesh=mesh, return_plan=True)
    (bucket,) = report["buckets"]
    plan = bucket["plan"]
    pin = dict(fused=plan.fuse, algorithm=plan.algorithm,
               densify=plan.densify)

    def serve(**kw):
        svc = MultiplyService(mesh, max_batch=G, slo_s=60.0, **kw)
        tickets = [svc.submit(a, b) for a, b in reqs]
        svc.flush()
        return [svc.result(t) for t in tickets]

    svc_rows = {}
    for name, kw in (("MultiplyService()", {}),
                     (f"MultiplyService({pin})", pin)):
        serve(**kw)   # warm: plans and executors built
        res, spans, outc, host_s = traced(lambda: serve(**kw))
        roots = [s for s in spans if s.parent_id is None]
        plan_s = sum(s.dur for s in spans if s.name == "plan")
        disp = [s for s in spans if s.name == "dispatch"]
        row = check_trace(f"(f) {name}, one flush", spans, outc)
        row.update(flush_ms=1e3 * host_s,
                   roots_ms=1e3 * sum(s.dur for s in roots),
                   plan_ms=1e3 * plan_s,
                   dispatch_host_ms=1e3 * sum(d.dur for d in disp),
                   dispatch_device_ms=1e3 * sum(d.attrs["device_s"]
                                                for d in disp),
                   outside_roots_ms=1e3 * (host_s - sum(s.dur
                                                        for s in roots)),
                   roots=[s.name for s in roots])
        svc_rows[name] = row
        out["traces"].append(row)
        print(f"    flush {row['flush_ms']:.3f} ms = roots "
              f"{row['roots_ms']:.3f} ({row['roots']}: plan "
              f"{row['plan_ms']:.3f}, dispatch host "
              f"{row['dispatch_host_ms']:.3f} / device "
              f"{row['dispatch_device_ms']:.3f}) + outside the roots "
              f"{row['outside_roots_ms']:.3f} ms")
        for x, (a, b) in zip(res, reqs[:2]):
            check_close(f"(f) {name} product", x.data,
                        torch.matmul(a.data, b.data))
        del res
    t_def, t_pin = time_interleaved([lambda: serve(),
                                     lambda: serve(**pin)], OBS_ROUNDS)
    (d_row, p_row) = svc_rows.values()
    gap = {"untraced_default_ms": 1e3 * t_def,
           "untraced_pinned_ms": 1e3 * t_pin,
           "gap_ms": 1e3 * (t_def - t_pin),
           "gap_outside_roots_ms": d_row["outside_roots_ms"]
           - p_row["outside_roots_ms"],
           "gap_plan_ms": d_row["plan_ms"] - p_row["plan_ms"],
           "gap_dispatch_host_ms": d_row["dispatch_host_ms"]
           - p_row["dispatch_host_ms"]}
    out["service_gap"] = gap
    print(f"  (f) untraced flush: MultiplyService() {1e3 * t_def:.3f} ms, "
          f"pinned {1e3 * t_pin:.3f} ms (median of {OBS_ROUNDS} interleaved "
          f"rounds): gap {gap['gap_ms']:.3f} ms.  The spans place the "
          f"traced gap: outside the multiply_batched roots "
          f"{gap['gap_outside_roots_ms']:+.3f} ms (the bucket's fuse "
          f"decision, dbcsr._execute_bucket), plan span "
          f"{gap['gap_plan_ms']:+.3f} ms, dispatch "
          f"{gap['gap_dispatch_host_ms']:+.3f} ms")
    del reqs, A, B, c_a
    torch.cuda.empty_cache()

    # ---- (p) Cannon 4x4 rank-exact, 15,840^2, A at 20 %
    P, NL = OBS_P
    N = P * NL
    nbp = N // BS
    mesh44 = make_mesh((P, P), ("data", "model"))
    grid = GridSpec("data", "model")
    am = rng.rand(nbp, nbp) < 0.2
    Ap = dbcsr.create(dense(N, N), mesh=mesh44, grid=grid, block_size=BS,
                      block_mask=am)
    Bp = dbcsr.create(dense(N, N), mesh=mesh44, grid=grid, block_size=BS)
    kw_p = dict(mesh=mesh44, algorithm="cannon", densify=False)
    _, first = sync_s(lambda: dbcsr.multiply(Ap, Bp, **kw_p))
    print(f"  (p) first call (rank-exact plans built) {first:.2f} s")
    zero_counters()
    c_p, spans, outc, host_s = traced(lambda: dbcsr.multiply(Ap, Bp, **kw_p))
    got = read_counters()
    if got["smm"] < 1:
        raise AssertionError("(p) traced: no smm launch")
    check_close("(p) traced vs torch.matmul", c_p.data,
                torch.matmul(Ap.data, Bp.data))
    steps = [s for s in spans if s.cat == "schedule-step"]
    imbs = [s.attrs.get("rank_imbalance") for s in steps]
    print(f"  (p) smm launches {got['smm']}; step spans' rank_imbalance "
          f"{[None if x is None else round(x, 3) for x in imbs]}")
    out["traces"].append(check_trace(
        f"(p) cannon {P}x{P} rank-exact {N}^2, A 20 %, traced", spans, outc))
    off_path("(p)", lambda: dbcsr.multiply(Ap, Bp, **kw_p), c_p)
    overhead("(p)", lambda: dbcsr.multiply(Ap, Bp, **kw_p), P_ROUNDS)
    del Ap, Bp, c_p
    torch.cuda.empty_cache()
    return out


def dropped_norm_bound(con, a, b, eps) -> float:
    """max over C blocks of the sum of the norm products ``||A_blk|| *
    ||B_blk||`` the filter drops (present blocks, product below eps): a
    bound on any element's change from eps filtering.  Computed on the
    spec-order layout's matricized norm grids, in float64."""
    import numpy as np

    from repro_torch.tensor import enumerate_layouts
    from repro_torch.tensor.matricize import layout_operands, unfold_grid

    _, lrows, lcols, _, rrows, rcols, _, _ = layout_operands(
        con, enumerate_layouts(con)[0])
    an = unfold_grid(a.norms(), con.a_indices, lrows, lcols).astype(
        np.float64)
    bn = unfold_grid(b.norms(), con.b_indices, rrows, rcols).astype(
        np.float64)
    worst = 0.0
    for i0 in range(0, an.shape[0], 64):
        prod = an[i0:i0 + 64, :, None] * bn[None]
        prod = np.where(prod < eps, prod, 0.0)
        worst = max(worst, float(prod.sum(axis=1).max()))
    return worst


def tensors(dev, card, zero_counters, read_counters) -> list:
    """Phase 9 (x): the tensor example's integral tensor at the size of
    a CP2K RPA run, both contractions on 1x1 and on a simulated 2x2."""
    import numpy as np
    import torch

    from repro_torch.core import dbcsr
    from repro_torch.examples.tensor_contraction import (DECAY, block_decay,
                                                         integral_mask)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tensor import enumerate_layouts, parse_contraction
    from repro_torch.tensor.matricize import (fold_to_tensor,
                                              layout_operands, unfold_tensor)

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    ni, na, np_ = TEN_DIMS
    bi, ba, bp = TEN_BLOCKS
    scale = block_decay(ni // bi, np_ // bp)
    mask = integral_mask(scale, na // ba)
    mesh11 = make_mesh((1, 1), ("data", "model"))
    mesh22 = make_mesh((2, 2), ("data", "model"))
    # B[i,a,P] made on the card from a seed: normal entries times the
    # example's block decay (rate DECAY), blocks below 1e-6 masked out
    data = torch.randn(TEN_DIMS, generator=gen, device=dev)
    full = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    data *= full.repeat_interleave(bi, 0).repeat_interleave(bp, 1)[:, None]
    Bt = dbcsr.create_tensor(data, mesh=mesh11, block_sizes=TEN_BLOCKS,
                             block_mask=mask, compute_norms=True)
    del data, full
    Mt = dbcsr.create_tensor(torch.randn((np_, np_), generator=gen,
                                         device=dev), mesh=mesh11,
                             block_sizes=(bp, bp), compute_norms=True)
    print(f"  B[i,a,P] {TEN_DIMS} in blocks {TEN_BLOCKS} (decay rate "
          f"{DECAY:g}), occupancy {Bt.occupancy:.4f}, "
          f"{Bt.data.numel() * 4 / 1e9:.2f} GB f32; eps {TEN_EPS:g}")
    rows = []
    for spec in ("iaP,PQ->iaQ", "iaP,iaQ->PQ"):
        other = Mt if spec == "iaP,PQ->iaQ" else Bt
        con = parse_contraction(spec)
        layouts = enumerate_layouts(con)
        # torch.einsum of the unfiltered tensors in f64 is the reference;
        # the f32 einsum's own error beside it (a 131,072-deep f32 sum)
        exact = torch.einsum(spec, Bt.data.double(), other.data.double())
        scale_c = float(exact.abs().max())
        lib_err = float((torch.einsum(spec, Bt.data, other.data).double()
                         - exact).abs().max())
        bound = dropped_norm_bound(con, Bt, other, TEN_EPS)
        tol = REL_TOL * scale_c + bound
        # a densified product is torch.matmul's f32 sum: held to twice
        # the f32 einsum's error where that exceeds REL_TOL
        tol_dense = max(tol, 2.0 * lib_err + bound)
        print(f"  {spec}: max|C| {scale_c:.4e}; the f32 torch.einsum is "
              f"{lib_err / scale_c:.3e} of it off the f64 one; dropped-norm "
              f"bound at eps {TEN_EPS:g}: {bound:.3e}")
        for mname, mesh in (("1x1", mesh11), ("2x2", mesh22)):
            label = f"(x) {spec} on {mname}"

            def run(**kw):
                return dbcsr.contract(spec, Bt, other, mesh=mesh,
                                      filter_eps=TEN_EPS, **kw)
            zero_counters()
            (C, plan), first = sync_s(lambda: run(return_plan=True))
            got = read_counters()
            err = float((C.data.double() - exact).abs().max())
            if not err <= (tol_dense if plan.densify else tol):
                raise AssertionError(
                    f"{label}: max err {err:.3e} > {REL_TOL:g} x "
                    f"{scale_c:.3e} + dropped-norm bound {bound:.3e}"
                    + (f" (or 2 x the f32 einsum's {lib_err:.3e})"
                       if plan.densify else ""))
            if tuple(C.shape) != tuple(exact.shape) or not bool(
                    torch.isfinite(C.data).all()):
                raise AssertionError(f"{label}: result shape or values")
            del C
            fns = [lambda L=L: run(layout=L.label) for L in layouts]
            fns.append(lambda: run())
            times = time_interleaved(fns, TEN_ROUNDS)
            t_auto, pinned = times[-1], times[:-1]
            i_best = int(np.argmin(pinned))
            regret = t_auto / pinned[i_best] - 1.0
            table = {L.label: 1e3 * t for L, t in zip(layouts, pinned)}
            print(f"  {label}: auto {plan.layout} {plan.algorithm}+"
                  f"{'densified' if plan.densify else 'blocked'}, "
                  f"predicted {1e3 * plan.predicted_s:.3f} ms (copy "
                  f"{1e3 * plan.copy_s:.3f}); first call {first:.3f} s, "
                  f"launches { {k: v for k, v in got.items() if v} }")
            print(f"    pinned layouts (median of {TEN_ROUNDS} interleaved "
                  f"rounds): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in table.items())
                  + f"; auto {1e3 * t_auto:.3f} ms; regret "
                  f"{100 * regret:.1f} % against {layouts[i_best].label}")
            # one traced call: where the host time of a contraction goes
            _, spans, outc, host_s = traced(lambda: run())
            tr = check_trace(f"{label}, auto, traced", spans, outc)
            disp = [x for x in spans if x.name == "dispatch"]
            tr.update(call_ms=1e3 * host_s,
                      device_ms=1e3 * sum(d.attrs["device_s"] for d in disp))
            print(f"    traced call {tr['call_ms']:.3f} ms, of which the "
                  f"dispatch's device_s {tr['device_ms']:.3f} ms "
                  f"({100 * tr['device_ms'] / tr['call_ms']:.1f} %)")
            print(f"    max |C - f64 einsum| {err:.3e} = {err / scale_c:.3e} "
                  f"of max|C| (tol {REL_TOL:g} + the dropped-norm bound"
                  + (f", or 2 x the f32 einsum's {lib_err / scale_c:.3e}"
                     " for a densified product" if plan.densify else "")
                  + ")")
            # at one pinned layout, contract is bitwise the
            # hand-matricized dbcsr.multiply: blocked (smm) on 1x1,
            # densified on 2x2
            L = next(x for x in layouts if x.label == plan.layout)
            dens = mname != "1x1"
            zero_counters()
            Cb, pb = run(layout=L.label, densify=dens, return_plan=True)
            got_b = read_counters()
            if not dens and got_b["smm"] < 1:
                raise AssertionError(f"{label}: blocked, no smm launch")
            lsrc, lrows, lcols, rsrc, rrows, rcols, crows, ccols = \
                layout_operands(con, L)
            left, lidx = ((Bt, con.a_indices) if lsrc == "a"
                          else (other, con.b_indices))
            right, ridx = ((other, con.b_indices) if rsrc == "b"
                           else (Bt, con.a_indices))
            dims = {**dict(zip(con.a_indices, Bt.shape)),
                    **dict(zip(con.b_indices, other.shape))}
            bsz = {**dict(zip(con.a_indices, Bt.block_sizes)),
                   **dict(zip(con.b_indices, other.block_sizes))}
            ma = unfold_tensor(left, lidx, lrows, lcols, mesh=mesh)
            mb = unfold_tensor(right, ridx, rrows, rcols, mesh=mesh)
            c2d = dbcsr.multiply(ma, mb, mesh=mesh,
                                 algorithm=pb.plan.algorithm, densify=dens,
                                 filter_eps=TEN_EPS)
            hand = fold_to_tensor(c2d, con.out_indices, crows, ccols, dims,
                                  bsz, Bt.grid, mesh=mesh)
            del ma, mb, c2d
            if not torch.equal(Cb.data, hand.data):
                raise AssertionError(f"{label}: contract at {L.label} != "
                                     "the hand-matricized multiply")
            err_b = float((Cb.data.double() - exact).abs().max())
            print(f"    at {L.label} {'densified' if dens else 'blocked'} "
                  f"({pb.algorithm}; launches "
                  f"{ {k: v for k, v in got_b.items() if v} }): bitwise the "
                  f"hand-matricized dbcsr.multiply; max err "
                  f"{err_b / scale_c:.3e} of max|C|")
            if not err_b <= (tol_dense if dens else tol):
                raise AssertionError(f"{label}: bitwise case err {err_b}")
            del Cb, hand
            rows.append({"case": label, "auto": plan.layout,
                         "algorithm": plan.algorithm,
                         "densify": plan.densify,
                         "predicted_ms": 1e3 * plan.predicted_s,
                         "auto_ms": 1e3 * t_auto, "pinned_ms": table,
                         "regret": regret, "first_s": first,
                         "launches": got, "bitwise_layout": L.label,
                         "bitwise_launches": got_b, "max_abs_err": err,
                         "rel_err": err / scale_c,
                         "bitwise_rel_err": err_b / scale_c,
                         "einsum_f32_rel_err": lib_err / scale_c,
                         "dropped_norm_bound": bound, "trace": tr})
        del exact
        torch.cuda.empty_cache()
    return rows


def obs_and_tensors(dev, card, zero_counters, read_counters) -> dict:
    """Phase 9; prints one {"phase9": ...} line."""
    from repro_torch import obs

    try:
        tel = telemetry(dev, card, zero_counters, read_counters)
        print(f"phase 9 (x): tensor contractions at a CP2K RPA size "
              f"({card})")
        ten = tensors(dev, card, zero_counters, read_counters)
    finally:
        obs.disable()
    summary = {"card": card, "telemetry": tel, "tensor": ten}
    print(json.dumps({"phase9": summary}, default=str))
    return summary


# ---------------------------------------------------------------------------
# phase 13: the process mesh
# ---------------------------------------------------------------------------

PM_NL, PM_BS = 3960, 22            # a rank of (a): Cannon, SUMMA, 2.5D
PM_TS = (1408, 123904, 1408)       # a rank of (s): ts_k over 4 ranks
PM_BATCH = (4, 880)                # batched SUMMA 2x2: G products of N^2
PM_FILL = 0.2                      # A's block fill in the masked cases
PM_EPS = 484.0                     # ~ the median norm product at block 22
PM_TIMEOUT_S = 300                 # the group's timeout, a collective
PM_JOIN_S = 420                    # a spawn's whole run


def pm_cases(world: int) -> list:
    """Phase 13's cases for a process mesh of ``world`` ranks: (label,
    algorithm / path keywords, what the result is held to)."""
    if world == 8:
        return [dict(label=f"(ah) cannon25d 2x2x2 {red} blocked",
                     op="multiply", kw=dict(algorithm="cannon25d", reduce=red,
                                            densify=False), adds=True)
                for red in ("all_reduce", "reduce_scatter")]
    dense = dict(algorithm="cannon", densify=False)
    masked = dict(op="multiply", masked=True)
    return [
        dict(label="(ah) cannon 2x2 blocked dense", op="multiply", kw=dense),
        dict(label="(ah) cannon 2x2 blocked 20 % union", kw=dict(
            dense, rank_exact=False), **masked),
        dict(label="(ah) cannon 2x2 blocked 20 % rank-exact", kw=dense,
             same_as="(ah) cannon 2x2 blocked 20 % union", **masked),
        dict(label="(ah) cannon 2x2 blocked 20 % rank-exact eps 0",
             kw=dict(dense, filter_eps=0.0),
             same_as="(ah) cannon 2x2 blocked 20 % union", **masked),
        dict(label=f"(ah) cannon 2x2 blocked 20 % rank-exact eps {PM_EPS:g}",
             kw=dict(dense, filter_eps=PM_EPS), filtered=True, **masked),
        dict(label="(ah) cannon 2x2 densified pallas", op="multiply",
             kw=dict(algorithm="cannon", densify=True,
                     local_kernel="pallas")),
        dict(label="(ah) summa 2x2 psum densified pallas", op="multiply",
             kw=dict(algorithm="summa", bcast="psum", densify=True,
                     local_kernel="pallas")),
        dict(label="(ah) summa 2x2 gather densified pallas", op="multiply",
             kw=dict(algorithm="summa", bcast="gather", densify=True,
                     local_kernel="pallas")),
        dict(label="(ah) cannon 2x2 blocked dense, verify=checksum, one "
                   "fault", op="multiply", kw=dict(dense, verify="checksum"),
             fault=True, same_as="(ah) cannon 2x2 blocked dense"),
        dict(label="(ai) ts_k 4 ranks all_reduce densified pallas", op="ts",
             kw=dict(algorithm="ts_k", reduce="all_reduce", densify=True,
                     local_kernel="pallas"), adds=True),
        dict(label="(ai) ts_k 4 ranks reduce_scatter densified pallas",
             op="ts", kw=dict(algorithm="ts_k", reduce="reduce_scatter",
                              densify=True, local_kernel="pallas"),
             adds=True),
        dict(label="(aj) batched summa 2x2 fused blocked", op="batched",
             kw=dict(algorithm="summa", densify=False, fused=True,
                     pipeline_depth=1)),
        dict(label="(aj) batched summa 2x2 looped blocked", op="batched",
             kw=dict(algorithm="summa", densify=False, fused=False,
                     pipeline_depth=1),
             same_as="(aj) batched summa 2x2 fused blocked"),
    ]


def pm_rank(rank: int, shape, axes, cases) -> dict:
    """One process of phase 13's process mesh: every case on the mesh
    (a warm-up call, then one timed call with the launch counters zeroed
    before it and read after it, and the smm kernel's CUDA-event time);
    mesh rank 0 then runs the same case on an in-process mesh of the
    same shape on its card and holds the two results against each other
    and against torch.matmul of the global operands.  Returns the
    process's numbers (no tensors)."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import dbcsr
    from repro_torch.core.blocking import GridSpec
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
    from repro_torch.kernels.smm.ops import smm_process_stack
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    from repro_torch.launch.mesh import make_mesh, make_process_mesh
    from repro_torch.robustness import chaos

    use_repo_table()
    mesh = make_process_mesh(
        shape, axes, timeout=datetime.timedelta(seconds=PM_TIMEOUT_S))
    dev = mesh.device
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    lead = rank == 0
    ref_mesh = make_mesh(shape, axes, device=dev) if lead else None
    grid = (GridSpec("data", "model", "pod") if len(shape) == 3
            else GridSpec("data", "model"))
    counters = {"smm": smm_process_stack, "tiled_matmul": tiled_matmul,
                "grouped_gemm": grouped_gemm}
    clock = KernelClock()
    side = shape[-1] * PM_NL

    def operands(case):
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        if case["op"] == "ts":
            m, k, n = PM_TS[0], PM_TS[1] * mesh.n_ranks, PM_TS[2]
            return (torch.randn(m, k, generator=gen, device=dev),
                    torch.randn(k, n, generator=gen, device=dev))
        if case["op"] == "batched":
            g, n = PM_BATCH
            return [(torch.randn(n, n, generator=gen, device=dev),
                     torch.randn(n, n, generator=gen, device=dev))
                    for _ in range(g)]
        a = torch.randn(side, side, generator=gen, device=dev)
        b = torch.randn(side, side, generator=gen, device=dev)
        mask = None
        if case.get("masked"):
            nb = side // PM_BS
            mask = np.random.RandomState(SEED + 13).rand(nb, nb) < PM_FILL
        return a, b, mask

    def runner(case, ops, on):
        """``(call, pairs)``: the case's call on mesh ``on`` (a list of
        result tensors) and its global operand pairs (masked blocks
        zeroed), the yardstick's."""
        kw = case["kw"]
        if case["op"] == "batched":
            reqs = [(dbcsr.create(a, mesh=on, grid=grid, block_size=PM_BS),
                     dbcsr.create(b, mesh=on, grid=grid, block_size=PM_BS))
                    for a, b in ops]
            return (lambda: [c.data for c in dbcsr.multiply_batched(
                reqs, mesh=on, **kw)]), [(x.data, y.data) for x, y in reqs]
        mask = None if case["op"] == "ts" else ops[2]
        da = dbcsr.create(ops[0], mesh=on, grid=grid, block_size=PM_BS,
                          block_mask=mask)
        db = dbcsr.create(ops[1], mesh=on, grid=grid, block_size=PM_BS)

        def call():
            if not case.get("fault"):
                return [dbcsr.multiply(da, db, mesh=on, **kw).data]
            hook = chaos.FaultInjector(seed=13).one_shot_result_hook(
                1, 2, block_m=PM_BS, block_n=PM_BS, mode="scale")
            with chaos.result_corruption(hook):
                c = dbcsr.multiply(da, db, mesh=on, **kw)
            rep = c.verification["report"]
            if not (rep.detected and rep.repaired):
                raise AssertionError(
                    f"{case['label']}: the fault was not detected and "
                    f"repaired (detected {rep.detected}, repaired "
                    f"{rep.repaired}, flagged {rep.flagged_blocks})")
            return [c.data]
        return call, [(da.data, db.data)]

    def timed(call, on):
        """(result, ms, launches, smm ms, traffic) of one call after a
        warm-up call."""
        call()
        torch.cuda.synchronize(dev)
        on.reset_traffic()
        for fn in counters.values():
            fn.launches = 0
        clock.take()
        if on is mesh:
            dist.barrier()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in counters.items()}
        return out, ms, launches, 1e3 * clock.take(), on.traffic_total()

    results, kept = [], {}
    for case in cases:
        ops = operands(case)
        call, pairs = runner(case, ops, mesh)
        out, ms, launches, smm_ms, traffic = timed(call, mesh)
        digest = hashlib.sha1()
        for c in out:
            digest.update(c.cpu().numpy().tobytes())
        row = {"case": case["label"], "ms": ms, "launches": launches,
               "smm_ms": smm_ms, "traffic": traffic,
               "digest": digest.hexdigest()}
        if lead:
            ref, ref_ms, ref_launches, ref_smm, ref_traffic = timed(
                runner(case, ops, ref_mesh)[0], ref_mesh)
            bitwise = all(torch.equal(x, y) for x, y in zip(out, ref))
            err = max(rel_err(x, y) for x, y in zip(out, ref))
            vs_matmul = max(rel_err(x, torch.matmul(a, b))
                            for x, (a, b) in zip(out, pairs))
            same = case.get("same_as")
            row.update(inproc_ms=ref_ms, inproc_launches=ref_launches,
                       inproc_smm_ms=ref_smm, inproc_traffic=ref_traffic,
                       bitwise_inproc=bitwise, err_inproc=err,
                       err_matmul=vs_matmul,
                       bitwise_same_as=(None if same is None else all(
                           torch.equal(x, y)
                           for x, y in zip(out, kept[same]))))
            kept[case["label"]] = out
            del ref
            print(f"    rank 0: {case['label']}: {ms:.1f} ms, in process "
                  f"{ref_ms:.1f} ms, bitwise {bitwise}", flush=True)
        dist.barrier()
        results.append(row)
        del ops, out, call, pairs
    clock.close()
    return {"rank": rank, "device": str(dev), "transport": mesh.transport,
            "repr": repr(mesh), "rows": results}


PM_MESHES = (((2, 2), ("data", "model")),
             ((2, 2, 2), ("pod", "data", "model")))


def process_mesh(card: str, meshes=PM_MESHES, ran=None) -> dict:
    """Phase 13: the process mesh (launch.mesh.make_process_mesh), one rank
    a process: 4 processes (2x2) and 8 (2x2x2) spawned on the card
    (launch.processes.run_ranks), a gloo group over a FileStore, the
    collectives host-staged; NCCL with one card a rank where the host
    has a card for every rank.  Each case is held bitwise against the
    in-process mesh where its collectives only move data, else within
    REL_TOL of max|C|, and against torch.matmul; every process holds the
    same C and launches the case's kernel; the summed traffic is the
    in-process count.  ``ran`` maps a mesh shape to ``(ranks, wall)``
    of its gloo run made in another spawn (the full run's 2x2 cases run
    in phases 14-15's 4 processes, before the LM cells: one spawn fewer);
    only the remaining runs are spawned here."""
    import tempfile

    import torch

    from repro_torch.launch.processes import run_ranks

    out = {"card": card, "runs": []}
    failed = []
    cards = torch.cuda.device_count()
    ran = ran or {}
    for shape, axes in meshes:
        world = math.prod(shape)
        cases = pm_cases(world)
        backends = ["gloo"] + (["nccl"] if cards >= world else [])
        if cards < world:
            print(f"  {world} ranks on {cards} card(s): gloo, host-staged "
                  "(NCCL takes one card a rank; not run)")
        for backend in backends:
            if backend == "gloo" and shape in ran:
                ranks, wall = ran[shape]
                print(f"  {ranks[0]['repr']}: {world} processes, "
                      f"{ranks[0]['transport']}, run in phases 14-15's "
                      f"spawn before its LM cells ({card})")
            else:
                t0 = time.perf_counter()
                with tempfile.TemporaryDirectory() as store:
                    ranks = run_ranks(pm_rank, world, store_dir=store,
                                      args=(shape, axes, cases),
                                      backend=backend,
                                      timeout_s=PM_TIMEOUT_S,
                                      join_timeout_s=PM_JOIN_S)
                wall = time.perf_counter() - t0
                print(f"  {ranks[0]['repr']}: {world} processes, "
                      f"{ranks[0]['transport']}, {wall:.1f} s with the "
                      f"spawn ({card})")
            for i, case in enumerate(cases):
                rows = [r["rows"][i] for r in ranks]
                lead = rows[0]
                label = lead["case"]
                want = ("tiled_matmul" if case["kw"].get("densify")
                        else "smm")
                problems = []
                if len({r["digest"] for r in rows}) != 1:
                    problems.append("the processes' results differ")
                if not all(r["launches"][want] > 0 for r in rows):
                    problems.append(f"a process launched no {want}: "
                                    f"{[r['launches'] for r in rows]}")
                if lead["traffic"] != lead["inproc_traffic"]:
                    problems.append(f"traffic {lead['traffic']} != in "
                                    f"process {lead['inproc_traffic']}")
                if case.get("adds"):
                    if not lead["err_inproc"] <= REL_TOL:
                        problems.append(f"err vs in process "
                                        f"{lead['err_inproc']:.3e}")
                elif not lead["bitwise_inproc"]:
                    problems.append("not bitwise the in-process mesh "
                                    f"(err {lead['err_inproc']:.3e})")
                if lead["bitwise_same_as"] is False:
                    problems.append(f"not bitwise {case['same_as']}")
                tol = TS_TOL if case["op"] == "ts" else REL_TOL
                if not case.get("filtered") and not lead["err_matmul"] <= tol:
                    problems.append(f"err vs torch.matmul "
                                    f"{lead['err_matmul']:.3e} > {tol:g}")
                smm = [round(r["smm_ms"], 3) for r in rows]
                print(f"  {label} [{backend}]: process mesh "
                      f"{lead['ms']:.1f} ms (ranks "
                      f"{[round(r['ms'], 1) for r in rows]}), in process "
                      f"{lead['inproc_ms']:.1f} ms; bitwise in-process "
                      f"{lead['bitwise_inproc']} (err "
                      f"{lead['err_inproc']:.2e}), vs torch.matmul "
                      f"{lead['err_matmul']:.2e}; smm ms a process {smm}; "
                      f"{want} launches a process "
                      f"{[r['launches'][want] for r in rows]}; received "
                      f"{sum(lead['traffic'].values()) / 1e9:.4f} GB over "
                      f"the ranks: "
                      + ("OK" if not problems else "; ".join(problems)))
                if problems:
                    failed.append(f"{label} [{backend}]: "
                                  + "; ".join(problems))
                out["runs"].append({
                    "case": label, "backend": backend,
                    "transport": ranks[0]["transport"], "world": world,
                    "ms": [r["ms"] for r in rows],
                    "inproc_ms": lead["inproc_ms"],
                    "smm_ms": [r["smm_ms"] for r in rows],
                    "inproc_smm_ms": lead["inproc_smm_ms"],
                    "launches": [r["launches"] for r in rows],
                    "inproc_launches": lead["inproc_launches"],
                    "bitwise_inproc": lead["bitwise_inproc"],
                    "err_inproc": lead["err_inproc"],
                    "err_matmul": lead["err_matmul"],
                    "traffic": lead["traffic"], "wall_s": wall})
    print(json.dumps({"phase13": out}))
    if failed:
        raise AssertionError("phase 13: " + "; ".join(failed))
    return out

# ---------------------------------------------------------------------------
# phases 14-15: the LM on a process mesh (one spawn of 4 processes)
# ---------------------------------------------------------------------------


def lm_cell(label, phase, arch, layers, mesh=(2, 2), dtype=None, opt=None,
            train=None, serve=None, step=None, count=False, twin=None):
    """A cell of phases 14-15: ``arch`` cut to ``layers`` on a process mesh
    of ``mesh`` (data, model), in ``dtype`` (None: the config's), with
    ``opt`` ("adafactor", or None: ``launch.specs.opt_for``'s choice);
    ``train`` (batch, seq, steps): that many steps, the last one's
    checkpoint, then one more step after serving; ``serve`` ((B, S),
    greedy tokens): prefill and greedy decode; ``step`` (batch, seq): one
    step and the loss after it (with ``count``, rank 0's under
    FlopCounterMode: (ap)); ``twin``: the bf16 cell whose serving this
    f32 cell's one-rank weights measure bf16's own distance for."""
    return {"cell": label, "phase": phase, "arch": arch, "layers": layers,
            "mesh": mesh, "dtype": dtype, "opt": opt, "train": train,
            "serve": serve, "step": step, "count": count, "twin": twin}


LM_CELLS = (
    lm_cell("(ak)", 14, "qwen2_1_5b", 8, train=(4, 2048, 2),
            serve=((2, 256), 8)),
    lm_cell("(al)", 14, "deepseek_v3_671b", 4, serve=((4, 1024), 16)),
    # one whole period of Jamba (32 -> 8 layers) is ~27 GB in bf16, most of
    # it the 4 MoE layers' 16 experts: 1x4 puts ~7 GB on each of the 4
    # processes of the one card (2x2 would put ~13.5)
    lm_cell("(am)", 15, "jamba_v0_1_52b", 8, mesh=(1, 4),
            serve=((4, 1024), 16)),
    lm_cell("(am) f32", 15, "jamba_v0_1_52b", 8, mesh=(1, 4),
            dtype="float32", serve=((2, 256), 4), twin="(am)"),
    lm_cell("(an)", 15, "rwkv6_1_6b", 6, serve=((4, 512), 16)),
    lm_cell("(an) f32", 15, "rwkv6_1_6b", 6, dtype="float32",
            serve=((4, 512), 16), step=(4, 512), count=True, twin="(an)"),
    lm_cell("(ao)", 15, "qwen2_1_5b", 8, opt="adafactor", step=(4, 1024)),
)
LM_MESHES = ((2, 2), (1, 4))
# Tolerances against one rank, bf16 (one bf16 step is 2^-8 = 3.9e-3 of a
# value; the mesh sums its partial products in bf16 through gloo where
# one rank sums inside one GEMM):
#   LM_LOSS_TOL: a step's loss, and the loss after a single step,
#     relative (steps 1-2 from the same weights drift apart by a rounding
#     a step; the last from the same checkpoint);
#   LM_GNORM_TOL: the gradient norm, relative;
#   LM_LOGIT_TOL: a (prompt, step) row of logits, max |mesh - one rank|
#     over max |one rank's|, teacher-forced on the mesh's tokens; a
#     greedy token of the mesh must be within it of the row's largest;
#   LM_ROW_SHARE: DeepSeek's MoE routes a token to the top 8 of 256
#     sigmoid scores, whose gaps are ~0.05 in router-logit units, and a
#     bf16 difference in the MoE's input moves a router logit by ~4e-3:
#     a row where one expert swapped misses LM_LOGIT_TOL; at least this
#     share of (al)'s rows must not, and every row of (ak) (no MoE).
# (am) and (an) at full width: bf16 rounding alone puts one rank's own
# logits further from its f32 logits than LM_LOGIT_TOL (a median 6.2e-2
# for Jamba and 1.5e-1 for RWKV-6 at their cells' prompts on an H100),
# so their bf16 serving is held to that distance, measured in the same
# run at the same prompts and teacher tokens: the median row error of
# the mesh against one rank must not exceed the median row error of one
# rank's bf16 against its f32.  The sharding is held in f32, where the
# mesh and one rank differ only in the order of f32 sums:
#   F32_ROW_TOL: a logit row, max |mesh - one rank| / max |one rank|;
#   F32_LOSS_TOL: the loss, relative;
#   F32_GNORM_TOL: each parameter's gradient norm (read from AdamW's
#     second moment), relative, plus twice one rank's own distance from
#     the same step in f64 for that parameter.  RWKV-6's gradient at
#     these weights is ill-conditioned (its norm, nearly all the WKV
#     bonus u's, moves by per cent between f32 and f64 on one rank), and
#     its bf16 norm no more stable (17,820 on one rank on an H100, its
#     f32 norm 87,435, the same batch), so the step runs in f32 and is
#     held leaf by leaf: a wrong gradient of any other leaf, which the
#     global norm cannot see, fails;
#   F32_AFTER_TOL: the loss after the step, relative.  AdamW's first
#     update is lr * sign(g) wherever |g| >> eps, so elements whose
#     gradient is f32 rounding move opposite ways on the mesh and on one
#     rank (observed 1.4e-5 at 4 x 512 and 2.0e-4 at 2 x 128 on an
#     H100, where the step moves the loss by 1.6-2.7 %).
LM_LOSS_TOL = 1e-2
LM_GNORM_TOL = 5e-2
LM_LOGIT_TOL = 3e-2
LM_ROW_SHARE = 0.75
F32_ROW_TOL = 1e-3
F32_LOSS_TOL = 1e-4
F32_GNORM_TOL = 4e-3
F32_AFTER_TOL = 1e-3
# (ak) with the sequence-parallel residual against without, one step each
# from the same weights and batch in bf16: the two run the same products on
# the same rows (every block gathers the whole sequence first); they differ
# in the order of the sums that give the norms' and biases' gradients (a
# rank's half of the rows, then the psum) and in a reduce-scatter where an
# all-reduce was.  The CPU test holds every gradient in f32 within 1e-4.
SP_CELL = "(ak)"
SP_KEY = "(ak) sequence_parallel"      # its record in a process's results
SP_LOSS_TOL = 1e-3
SP_GNORM_TOL = 1e-2
LM_TIMEOUT_S = 600
LM_JOIN_S = 900
LM_PROMPT_SEED, LM_STEP_SEED = 50, 62


def lm_config(cell):
    import dataclasses

    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(cell["arch"]),
                              num_layers=cell["layers"])
    return dataclasses.replace(cfg, dtype=cell["dtype"]) if cell["dtype"] \
        else cfg


def lm_opt(cfg, cell):
    from repro_torch.launch.specs import opt_for
    from repro_torch.train.optimizer import OptConfig, make_optimizer

    return make_optimizer(OptConfig(name="adafactor") if cell["opt"]
                          == "adafactor" else opt_for(cfg))


def lm_batch(cfg, b, s, i, dev):
    """A global batch of random tokens from SEED + i (inputs and labels)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 100 + i)
    tok = rng.randint(0, cfg.vocab_size, (2, b, s)).astype(np.int32)
    return {"inputs": torch.from_numpy(tok[0]).to(dev),
            "labels": torch.from_numpy(tok[1]).to(dev)}


def lm_serve(params, cfg, mesh, prompts, n, teacher=None):
    """Prefill, then n greedy tokens (or, with ``teacher``, the teacher's
    tokens fed): (tokens (B, n+1), per-row logits [(B, V) of each step],
    prefill s, decode s a token).  On a mesh the tokens and logits stay
    this process's shards."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import pad_cache
    from repro_torch.serve.prefill import greedy

    b, s = prompts.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, _, cache = T.backbone(params, prompts, cfg, collect_cache=True,
                                      mesh=mesh)
        logits = [T.lm_head(params, hidden[:, -1:], cfg, mesh)[:, -1]]
        tok = greedy(logits[-1][:, None], cfg, mesh)
        del hidden
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = pad_cache(cache, cfg, b, s + n)
        cur = torch.full((1,), s, dtype=torch.int32, device=prompts.device)
        toks = [tok]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(n):
            feed = toks[-1] if teacher is None else teacher[:, i:i + 1]
            lg = T.forward(params, feed, cfg, cache=cache, cur_len=cur,
                           mesh=mesh)[0][:, -1]
            logits.append(lg)
            toks.append(greedy(lg[:, None], cfg, mesh))
            cur = cur + 1
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    return torch.cat(toks, dim=1), logits, t1 - t0, (t3 - t2) / n


def lm_step(cfg, opt, mesh, params, st, batch, count=False):
    """One train step on ``mesh`` (None: one rank), timed; with ``count``,
    under FlopCounterMode.  Returns (params, state, its record)."""
    import contextlib

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train.train_step import make_train_step

    fn = make_train_step(cfg, opt, mesh=mesh)
    fc = FlopCounterMode(display=False) if count else contextlib.nullcontext()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with fc:
        params, st, met = fn(params, st, batch)
    rec = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
    torch.cuda.synchronize()
    rec["ms"] = (time.perf_counter() - t) * 1e3
    if count:
        rec["flops"] = fc.get_total_flops()
    return params, st, rec


def post_loss(params, batch, cfg, mesh):
    """The loss on ``batch`` after a step (the update's effect)."""
    import torch

    from repro_torch.models import transformer as T

    with torch.no_grad():
        return float(T.lm_loss(params, batch, cfg, mesh)[0])


def leaf_norms(st, opt, cfg, mesh, gnorm) -> list:
    """Each parameter's gradient norm at a first AdamW step, read from the
    second moment the step left, v = (1 - b2) (scale g)^2 (scale: the
    global clip of a gradient of norm ``gnorm``); on a ``mesh`` each
    leaf's sum over its state's chunks, psummed over the axes they are
    cut on (mesh None: one rank)."""
    import torch

    from repro_torch.models.common import tree_leaves
    from repro_torch.train.train_step import train_layout

    sums = [v.double().sum() for v in tree_leaves(st["v"])]
    if mesh is not None:
        axes = [lay.grad_axes
                for lay in tree_leaves(train_layout(cfg, opt, mesh))]
        for ax in sorted(set(a for a in axes if a)):
            idx = [i for i, a in enumerate(axes) if a == ax]
            got = mesh.psum(torch.stack([sums[i] for i in idx])[None], ax)[0]
            for j, i in enumerate(idx):
                sums[i] = got[j]
    scale = min(1.0, opt.cfg.grad_clip / max(gnorm, 1e-9))
    return [math.sqrt(float(x) / (1 - opt.cfg.b2)) / scale for x in sums]


def leaf_names(tree, prefix="") -> list:
    """The paths of ``tree``'s leaves in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                             f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


def lm_rank(rank: int, store: str, pm=None) -> dict:
    """One process of phases 14-15: a 2x2 and a 1x4 mesh over the same 4
    processes, every cell in turn; returns {cell: its numbers and, on
    mesh rank 0, the gathered tokens and logits}.  With ``pm`` (phase
    13's 2x2 cases) the process first runs those (``pm_rank``), under
    the key "phase13"."""
    import torch

    from repro_torch.launch.mesh import make_process_mesh

    out = {}
    if pm:
        out["phase13"] = pm_rank(rank, *PM_MESHES[0], pm)
        torch.cuda.empty_cache()
    meshes = {shape: make_process_mesh(
        shape, ("data", "model"),
        timeout=datetime.timedelta(seconds=LM_TIMEOUT_S))
        for shape in LM_MESHES}
    torch.cuda.set_device(meshes[LM_MESHES[0]].device)
    for cell in LM_CELLS:
        out[cell["cell"]] = lm_cell_on_mesh(meshes[cell["mesh"]], cell, store)
        torch.cuda.empty_cache()
    out[SP_KEY] = lm_sp_steps(meshes[(2, 2)])
    return out


def lm_sp_steps(mesh) -> dict:
    """(ak)'s model on 2x2: one ZeRO AdamW step of (ak)'s batch shape
    without and with ``sequence_parallel``, each from the same weights and
    batch, the peak memory reset before each; returns {flag: its step}."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import init_opt_state, shard_batch

    (cell,) = [c for c in LM_CELLS if c["cell"] == SP_CELL]
    dev = mesh.device
    cfg = lm_config(cell)
    opt = lm_opt(cfg, cell)
    b, s, _ = cell["train"]
    batch = shard_batch(lm_batch(cfg, b, s, LM_STEP_SEED, dev), mesh)
    out = {}
    for sp in (False, True):
        c = dataclasses.replace(cfg, sequence_parallel=sp)
        params = init_per_layer(c, torch.Generator(dev).manual_seed(SEED),
                                dev, mesh=mesh,
                                specs=T.model_param_specs(c, mesh))
        st = init_opt_state(opt, params, c, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh.reset_traffic()
        params, st, rec = lm_step(c, opt, mesh, params, st, batch)
        rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["received"] = sum(mesh.traffic.values())
        out[sp] = rec
        del params, st
        torch.cuda.empty_cache()
    return out


def lm_cell_on_mesh(mesh, cell, store) -> dict:
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.launch.mesh import P
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import (init_opt_state, shard_batch,
                                              state_specs)

    dev = mesh.device
    cfg = lm_config(cell)
    opt = lm_opt(cfg, cell)
    dp = T.dp_axes(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_per_layer(cfg, torch.Generator(dev).manual_seed(SEED), dev,
                            mesh=mesh, specs=T.model_param_specs(cfg, mesh))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "steps": [],
           "transport": mesh.transport, "repr": repr(mesh)}
    torch.cuda.reset_peak_memory_stats(dev)

    def one_step(b, s, seed, count=False):
        nonlocal params, st
        batch = shard_batch(lm_batch(cfg, b, s, seed, dev), mesh)
        mesh.reset_traffic()
        params, st, rec = lm_step(cfg, opt, mesh, params, st, batch, count)
        rec["received"] = sum(mesh.traffic.values())
        rec["traffic"] = {k: v for k, v in mesh.traffic.items() if v}
        out["steps"].append(rec)
        return batch

    if cell["train"] is not None:
        b, s, n_steps = cell["train"]
        st = init_opt_state(opt, params, cfg, mesh)
        for i in range(n_steps):
            one_step(b, s, i)
        t = time.perf_counter()
        ckpt.save_checkpoint(os.path.join(store, "ckpt"), n_steps,
                             {"params": params, "opt": st}, mesh=mesh,
                             specs=state_specs(cfg, opt, mesh))
        out["save_s"] = time.perf_counter() - t
    if cell["serve"] is not None:
        (pb, ps), n_new = cell["serve"]
        prompts = lm_batch(cfg, pb, ps, LM_PROMPT_SEED, dev)["inputs"]
        local = shard_batch({"x": prompts}, mesh)["x"]
        mesh.reset_traffic()
        decode_attention.launches = 0
        toks, logits, pre_s, dec_s = lm_serve(params, cfg, mesh, local, n_new)
        out["decode_attention_launches"] = decode_attention.launches
        out["serve_received"] = sum(mesh.traffic.values())
        out["prefill_ms"], out["decode_ms"] = pre_s * 1e3, dec_s * 1e3
        toks = mesh.unshard(toks.unsqueeze(0), P(dp, None))
        rows = [mesh.unshard(lg.unsqueeze(0), P(dp, "model")).float().cpu()
                for lg in logits]
        if mesh.rank == 0:
            out["tokens"] = toks.cpu()
            out["logits"] = torch.stack(rows)
    if cell["train"] is not None:
        one_step(b, s, n_steps)
    if cell["step"] is not None:
        b, s = cell["step"]
        st = init_opt_state(opt, params, cfg, mesh)
        batch = one_step(b, s, LM_STEP_SEED,
                         count=cell["count"] and mesh.rank == 0)
        if opt.cfg.name == "adamw":
            out["steps"][-1]["leaf_norms"] = leaf_norms(
                st, opt, cfg, mesh, out["steps"][-1]["grad_norm"])
        out["post_loss"] = post_loss(params, batch, cfg, mesh)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def lm_compare(label, mesh_logits, want_logits, toks, share,
               tol=LM_LOGIT_TOL, gate=True, what="against one rank") -> dict:
    """Row errors of the mesh's logits against one rank's (teacher-forced
    on the mesh's tokens) and its greedy tokens' standing there; ``ok``
    where a ``share`` of rows and of tokens lie within ``tol`` (printed
    as a statistic, without OK / FAILED, where not ``gate``)."""
    import torch

    rows, tok_ok = [], 0
    for i in range(mesh_logits.shape[0]):
        want = want_logits[i]
        err = ((mesh_logits[i] - want).abs().amax(-1)
               / want.abs().amax(-1))
        rows += err.tolist()
        # the mesh's choice is within the tolerance of the row's largest
        chosen = want.gather(-1, toks[:, i:i + 1].long())[:, 0]
        tok_ok += int((want.amax(-1) - chosen
                       <= tol * want.abs().amax(-1)).sum())
    rows = torch.tensor(rows)
    within = float((rows <= tol).float().mean())
    n = rows.numel()
    ok = within >= share and tok_ok >= share * n
    print(f"  {label} {what}: logit rows within {tol:g} "
          f"{within:.3f} of {n}" + (f" (needed {share:g})" if gate else "")
          + f", worst {float(rows.max()):.3e}, median "
          f"{float(rows.median()):.3e}; greedy tokens within the tolerance "
          f"{tok_ok} of {n}"
          + (f" (needed {math.ceil(share * n)}): "
             + ("OK" if ok else "FAILED") if gate else ""))
    return {"ok": ok, "rows_within": within, "worst": float(rows.max()),
            "median": float(rows.median()), "tokens_ok": tok_ok, "rows": n}


def lm_count(cell):
    """(ap): rank 0 of ``cell``'s 2x2 train step counted on a meta rank
    mesh, as the dry-run counts a production cell; returns (costs,
    seconds)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cost_counter import count_costs
    from repro_torch.launch.mesh import make_meta_rank_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.train import train_step as TS

    t = time.perf_counter()
    mesh = make_meta_rank_mesh(cell["mesh"], ("data", "model"))
    b, s = cell["step"]
    step, args, _, _, _ = build_cell(cell["arch"],
                                     ShapeConfig("ap", s, b, "train"), mesh,
                                     cfg=lm_config(cell))
    _, costs = count_costs(step, *args, mesh=mesh,
                           replay=((TS, "_grads_of"),))
    return costs, time.perf_counter() - t


def lm_on_mesh(dev, card: str, hw, mark=None, pm=None) -> dict:
    """Phases 14-15: LM_CELLS on process meshes of 4 processes on the card
    (host-staged gloo; one spawn runs them all), each against one rank in
    this process from the same weights: (ak)'s steps before the spawn,
    the rest after it; (ap), the meta count of (an)'s f32 step, runs in a
    thread of this process during the spawn.  ``mark(15)`` is called
    before the first phase-15 cell's comparisons.  With ``pm`` (phase
    13's 2x2 cases) the spawn runs those first; their ranks' rows come
    back as ``out["pm_ranks"]``, for ``process_mesh``'s checks."""
    import dataclasses
    import tempfile
    import threading

    import torch

    from repro_torch.launch.processes import run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    from repro_torch.train import checkpoint as ckpt

    out, failed = {"card": card, "cells": []}, []

    def one_rank(cfg):
        return init_per_layer(cfg, torch.Generator(dev).manual_seed(SEED), dev)

    def one_rank_step(cfg, opt, params, st, b, s, i):
        return lm_step(cfg, opt, None, params, st, lm_batch(cfg, b, s, i,
                                                            dev))

    # ---- one rank: the training cells' steps from the same weights
    mine = {}
    for cell in LM_CELLS:
        if cell["train"] is None:
            continue
        cfg = lm_config(cell)
        opt = lm_opt(cfg, cell)
        b, s, n_steps = cell["train"]
        params = one_rank(cfg)
        st = opt.init(params)
        mine[cell["cell"]] = []
        for i in range(n_steps):
            params, st, rec = one_rank_step(cfg, opt, params, st, b, s, i)
            mine[cell["cell"]].append(rec)
        del params, st
        torch.cuda.empty_cache()

    counted = {}
    (counted_cell,) = [c for c in LM_CELLS if c["count"]]
    counter = threading.Thread(target=lambda: counted.update(
        zip(("costs", "s"), lm_count(counted_cell))), daemon=True)
    counter.start()
    with tempfile.TemporaryDirectory() as store:
        t0 = time.perf_counter()
        ranks = run_ranks(lm_rank, 4, store_dir=store, args=(store, pm),
                          timeout_s=LM_TIMEOUT_S, join_timeout_s=LM_JOIN_S)
        wall = time.perf_counter() - t0
        out["wall_s"] = wall
        if pm:
            out["pm_ranks"] = [r.pop("phase13") for r in ranks]
        print(f"  4 processes, one spawn for {[c['cell'] for c in LM_CELLS]}"
              f": {wall:.1f} s ({card})")
        twins = {}
        for cell in LM_CELLS:
            label, arch = cell["cell"], cell["arch"]
            if cell["phase"] == 15 and mark is not None:
                mark(15)
                mark = None
            cfg = lm_config(cell)
            opt = lm_opt(cfg, cell)
            got = [r[label] for r in ranks]
            lead = got[0]
            f32 = cfg.dtype == "float32"
            mesh_name = f"{cell['mesh'][0]}x{cell['mesh'][1]}"
            print(f"phase {cell['phase']} {label}: {cfg.name} in {cfg.dtype}"
                  f" at its published widths, num_layers "
                  f"{get_layers(arch)} -> {cfg.num_layers}, on a "
                  f"{mesh_name} process mesh ({lead['repr']}); "
                  + (f"{opt.cfg.name}" + (" with ZeRO" if opt.cfg.zero
                                          else "") + "; "
                     if cell["train"] or cell["step"] else "") + "init "
                  f"{[round(r['init_s'], 1) for r in got]} s, peak "
                  f"{[round(r['peak_gb'], 2) for r in got]} GB a process "
                  f"({card})")
            rec = {"cell": label, "arch": arch, "layers": cell["layers"],
                   "mesh": cell["mesh"], "dtype": cfg.dtype, "wall_s": wall,
                   "init_s": [r["init_s"] for r in got],
                   "peak_gb": [r["peak_gb"] for r in got],
                   "transport": lead["transport"],
                   "decode_attention_launches": [0] * 4}
            torch.cuda.empty_cache()
            if cell["train"] is not None:
                # the mesh's checkpoint on one rank: serving, then a step
                b, s, n_steps = cell["train"]
                shapes = T.model_param_shapes(cfg)
                t = time.perf_counter()
                state = ckpt.restore_checkpoint(
                    os.path.join(store, "ckpt"), n_steps,
                    {"params": shapes, "opt": opt.init(shapes)}, device=dev)
                rec["restore_s"] = time.perf_counter() - t
                params, st = state["params"], state["opt"]
                del state
            else:
                params, st = one_rank(cfg), None

            if cell["serve"] is not None:
                (pb, ps), n_new = cell["serve"]
                prompts = lm_batch(cfg, pb, ps, LM_PROMPT_SEED, dev)["inputs"]
                _, want, pre1, dec1 = lm_serve(params, cfg, None, prompts,
                                               n_new,
                                               teacher=lead["tokens"].to(dev))
                want = torch.stack([w.float().cpu() for w in want])
                if f32:
                    cmp = lm_compare(label, lead["logits"], want,
                                     lead["tokens"], 1.0, tol=F32_ROW_TOL)
                elif label in ("(am)", "(an)"):
                    # gated below, against bf16's own distance from f32
                    cmp = lm_compare(label, lead["logits"], want,
                                     lead["tokens"], 1.0, gate=False)
                    twins[label] = {"want": want, "tokens": lead["tokens"],
                                    "prompts": prompts, "n_new": n_new,
                                    "cmp": cmp}
                else:
                    cmp = lm_compare(label, lead["logits"], want,
                                     lead["tokens"], 1.0 if cell["train"]
                                     else LM_ROW_SHARE)
                if not cmp["ok"] and label not in twins:
                    failed.append(f"{label} serving")
                same = float((want.argmax(-1).T == lead["tokens"].long())
                             .float().mean())
                launches = [r["decode_attention_launches"] for r in got]
                n_att = sum(cfg.layer_kind(i)[0] == "attention"
                            for i in range(cfg.num_layers))
                if launches != [n_new * n_att] * 4:
                    failed.append(f"{label} decode_attention launches "
                                  f"{launches}")
                print(f"  {label} serving {pb} x {ps} + {n_new}: prefill "
                      f"{lead['prefill_ms']:.1f} ms on the mesh "
                      f"({pre1 * 1e3:.1f} on one rank), decode "
                      f"{lead['decode_ms']:.2f} ms a token "
                      f"({dec1 * 1e3:.2f}); greedy tokens equal to one "
                      f"rank's argmax (teacher-forced on the mesh's) "
                      f"{same:.3f}; a rank received "
                      f"{[r['serve_received'] / 1e9 for r in got]} GB; "
                      f"decode_attention launches a process {launches} "
                      f"(want {n_new * n_att})")
                rec.update(compare=cmp, tokens_equal=same,
                           prefill_ms=lead["prefill_ms"],
                           decode_ms=lead["decode_ms"],
                           one_rank_prefill_ms=pre1 * 1e3,
                           one_rank_decode_ms=dec1 * 1e3,
                           serve_received=[r["serve_received"] for r in got],
                           decode_attention_launches=launches)

            if cell["twin"] is not None:
                # bf16's own distance: one rank's bf16 logits of the twin
                # against this f32 cell's weights, teacher-forced alike
                tw = twins.pop(cell["twin"])
                _, want32, _, _ = lm_serve(params, cfg, None, tw["prompts"],
                                           tw["n_new"],
                                           teacher=tw["tokens"].to(dev))
                want32 = torch.stack([w.float().cpu() for w in want32])
                noise = lm_compare(f"{cell['twin']} bf16 on one rank",
                                   tw["want"], want32, tw["tokens"], 1.0,
                                   gate=False, what="against its f32")
                good = tw["cmp"]["median"] <= noise["median"]
                print(f"  {cell['twin']} bf16 serving: the mesh's median row "
                      f"error against one rank {tw['cmp']['median']:.3e}, "
                      f"bf16's own on one rank {noise['median']:.3e}: "
                      + ("OK" if good else "FAILED"))
                if not good:
                    failed.append(f"{cell['twin']} bf16 serving")
                rec["bf16_vs_f32_one_rank"] = noise
                rec["bf16_mesh_compare"] = tw["cmp"]

            steps = []
            if cell["train"] is not None:
                params, st, r1 = one_rank_step(cfg, opt, params, st, b, s,
                                               n_steps)
                mine[label].append(r1)
                steps = list(enumerate(zip(lead["steps"], mine[label])))
                rec.update(save_s=lead["save_s"], one_rank=mine[label])
            if cell["step"] is not None:
                b, s = cell["step"]
                batch = lm_batch(cfg, b, s, LM_STEP_SEED, dev)
                if f32:    # the same weights in f64: f32's own distance
                    cfg64 = dataclasses.replace(cfg, dtype="float64")
                    p64 = tree_map(lambda p: p.double(), params)
                params, st, r1 = lm_step(cfg, opt, None, params,
                                         opt.init(params), batch)
                r1["post_loss"] = post_loss(params, batch, cfg, None)
                if "leaf_norms" in lead["steps"][0]:
                    r1["leaf_norms"] = leaf_norms(st, opt, cfg, None,
                                                  r1["grad_norm"])
                if f32:
                    del params, st
                    params, st, r64 = lm_step(cfg64, opt, None, p64,
                                              opt.init(p64), batch)
                    del p64
                    r64["leaf_norms"] = leaf_norms(st, opt, cfg64, None,
                                                   r64["grad_norm"])
                    r1["f64"] = r64
                steps = [(0, (dict(lead["steps"][0],
                                   post_loss=lead["post_loss"]), r1))]
                rec["one_rank"] = [r1]
            del params, st
            torch.cuda.empty_cache()
            tol_l, tol_g, tol_a = ((F32_LOSS_TOL, F32_GNORM_TOL,
                                    F32_AFTER_TOL) if f32 else
                                   (LM_LOSS_TOL, LM_GNORM_TOL, LM_LOSS_TOL))
            for i, (mesh_r, ref) in steps:
                b, s = (cell["train"] or cell["step"])[:2]
                dl = abs(mesh_r["loss"] - ref["loss"]) / abs(ref["loss"])
                dg = (abs(mesh_r["grad_norm"] - ref["grad_norm"])
                      / ref["grad_norm"])
                da = (abs(mesh_r["post_loss"] - ref["post_loss"])
                      / abs(ref["post_loss"]) if "post_loss" in ref else 0.0)
                good = dl <= tol_l and da <= tol_a
                if "f64" in ref:
                    # each leaf's gradient norm within tol_g of one rank's
                    # plus twice one rank's own f32 distance from f64
                    worst = max(zip(mesh_r["leaf_norms"], ref["leaf_norms"],
                                    ref["f64"]["leaf_norms"]),
                                key=lambda t: abs(t[0] - t[1]) / (
                                    tol_g * t[1] + 2 * abs(t[1] - t[2])
                                    + 1e-30))
                    ratio = abs(worst[0] - worst[1]) / (
                        tol_g * worst[1] + 2 * abs(worst[1] - worst[2])
                        + 1e-30)
                    good = good and ratio <= 1.0
                    g64 = ref["f64"]["grad_norm"]
                    n64 = ref["f64"]["leaf_norms"]
                    top = max(range(len(n64)), key=n64.__getitem__)
                    top_name = leaf_names(T.model_param_shapes(cfg))[top]
                    print(f"  {label} gradient norms, leaf by leaf (from "
                          f"AdamW's second moment): the mesh against one "
                          f"rank within {tol_g:g} plus twice one rank's f32 "
                          f"distance from f64; worst leaf at {ratio:.3f} of "
                          f"its allowance (mesh {worst[0]:.6g}, one rank "
                          f"{worst[1]:.6g}, f64 {worst[2]:.6g}); the global "
                          f"norm in f64 {g64:.6g} ({ref['f64']['ms']:.1f} "
                          f"ms), one rank's f32 "
                          f"{abs(ref['grad_norm'] - g64) / g64:.2e} from it;"
                          f" its largest leaf {top_name} holds "
                          f"{n64[top] ** 2 / sum(x * x for x in n64):.6f} of "
                          f"its square")
                    rec["leaf_ratio"] = ratio
                else:
                    good = good and dg <= tol_g
                print(f"  {label} step {i + 1} of {b} x {s}"
                      + (" (from the checkpoint)" if cell["train"]
                         and i == cell["train"][2] else "")
                      + f": mesh {mesh_r['ms']:.1f} ms "
                      f"({b * s / mesh_r['ms'] * 1e3:.1f} tokens/s), loss "
                      f"{mesh_r['loss']:.5f}, grad norm "
                      f"{mesh_r['grad_norm']:.4f}"
                      + (f", loss after {mesh_r['post_loss']:.5f}"
                         if "post_loss" in ref else "")
                      + f", a rank received "
                      f"{[r['steps'][i]['received'] / 1e9 for r in got]} GB;"
                      f" one rank {ref['ms']:.1f} ms, loss {ref['loss']:.5f},"
                      f" grad norm {ref['grad_norm']:.4f}"
                      + (f", loss after {ref['post_loss']:.5f}"
                         if "post_loss" in ref else "")
                      + f"; rel err {dl:.2e} / {dg:.2e}"
                      + (f" / {da:.2e}" if "post_loss" in ref else "")
                      + f" (tolerances {tol_l:g} / {tol_g:g}"
                      + (f" / {tol_a:g}" if "post_loss" in ref else "")
                      + "): " + ("OK" if good else "FAILED"))
                if not good:
                    failed.append(f"{label} step {i + 1}")
            if steps:
                rec["steps"] = [r["steps"] for r in got]
            if cell["train"] is not None:
                print(f"  {label} checkpoint: save {lead['save_s']:.1f} s on "
                      f"the mesh, restore {rec['restore_s']:.1f} s on one "
                      "rank")

            if cell["count"]:
                counter.join()
                rec["count"] = lm_count_check(cell, counted, lead, hw, card,
                                              failed)
            out["cells"].append(rec)
        out["sp"] = lm_sp_check([r[SP_KEY] for r in ranks], card, failed)
    print(json.dumps({"phase14": out}, default=str))
    if failed:
        raise AssertionError("phases 14-15: " + "; ".join(failed))
    return out


def lm_sp_check(got, card, failed) -> dict:
    """(ak)'s step with ``sequence_parallel`` against without on 2x2 (every
    process's record of ``lm_sp_steps``)."""
    off, on = got[0][False], got[0][True]
    dl = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    dg = abs(on["grad_norm"] - off["grad_norm"]) / off["grad_norm"]
    good = dl <= SP_LOSS_TOL and dg <= SP_GNORM_TOL
    (cell,) = [c for c in LM_CELLS if c["cell"] == SP_CELL]
    b, s, _ = cell["train"]
    print(f"phase 14 {SP_CELL} sequence_parallel: one ZeRO AdamW step of "
          f"{b} x {s} on 2x2 from the same weights, with the residual cut "
          f"over model between layers against without: loss "
          f"{on['loss']:.6f} / {off['loss']:.6f}, grad norm "
          f"{on['grad_norm']:.5f} / {off['grad_norm']:.5f} (rel err "
          f"{dl:.2e} / {dg:.2e}; tolerances {SP_LOSS_TOL:g} / "
          f"{SP_GNORM_TOL:g}): " + ("OK" if good else "FAILED"))
    print(f"  step {on['ms']:.1f} / {off['ms']:.1f} ms; peak "
          f"max_memory_allocated a process "
          f"{[round(r[True]['peak_gb'], 3) for r in got]} / "
          f"{[round(r[False]['peak_gb'], 3) for r in got]} GB; a rank "
          f"received {[r[True]['received'] / 1e9 for r in got]} / "
          f"{[r[False]['received'] / 1e9 for r in got]} GB ({card})")
    if not good:
        failed.append(f"{SP_CELL} sequence_parallel step")
    return {"on": [r[True] for r in got], "off": [r[False] for r in got],
            "loss_rel_err": dl, "grad_norm_rel_err": dg, "ok": good}


def lm_count_check(cell, counted, lead, hw, card, failed) -> dict:
    """(ap): the meta count of rank 0 of ``cell``'s step against rank 0 of
    the step on the card (FlopCounterMode and its traffic)."""
    costs, step = counted["costs"], lead["steps"][0]
    b, s = cell["step"]
    print(f"phase 15 (ap): rank 0 of {cell['cell']}'s 2x2 step ({b} x {s}) "
          f"counted on a meta rank mesh (launch.mesh.make_meta_rank_mesh, "
          f"{counted['s']:.1f} s of host time, in a thread during the spawn) "
          f"against rank 0 of the step on the card ({card})")
    bound = print_bound("counted on meta", costs, hw)
    coll_ms = 1e3 * costs.total_collective_bytes / hw["nvlink_bw"]
    bound["collective_ms"] = coll_ms
    print(f"  collective term {coll_ms:.2f} ms "
          f"({costs.total_collective_bytes / 1e9:.3f} GB received by rank 0 "
          f"over {hw['name']}'s NVLink rate; this run's transport is "
          "host-staged gloo)")
    got_bytes = {k: float(v) for k, v in costs.collective_bytes.items()}
    want_bytes = {k: float(v) for k, v in step["traffic"].items()}
    f_ok = costs.flops == step["flops"]
    b_ok = got_bytes == want_bytes
    print(f"  FLOPs: counted {costs.flops:.6e}, FlopCounterMode over rank 0's "
          f"step on the card {step['flops']:.6e}: equal {f_ok}; collective "
          f"bytes by kind: counted {got_bytes} ({dict(costs.collective_count)}"
          f" calls), rank 0's traffic {want_bytes}: equal {b_ok}; the step "
          f"took {step['ms']:.1f} ms on the mesh (under FlopCounterMode, "
          f"host-staged gloo) against a bound of {bound['bound_ms']:.1f} ms: "
          + ("OK" if f_ok and b_ok else "FAILED"))
    if not (f_ok and b_ok):
        failed.append("(ap) the count differs from the card")
    return {"flops": costs.flops, "card_flops": step["flops"],
            "collective_bytes": got_bytes, "traffic": want_bytes,
            "collective_count": dict(costs.collective_count),
            "count_s": counted["s"], "bound": bound,
            "peak_counted_gb": costs.peak_live_bytes / 1e9}


# ---------------------------------------------------------------------------
# phase 16: the smm sweep and the H100 winners table on the main path
# ---------------------------------------------------------------------------

SWEEP_NB = 180            # blocks a side of the sweep at block 22 (3,960^2)
SWEEP_FILLS = (1.0, 0.2)
SWEEP_SIZES = {"(a)": (3960, 22), "(b)": (4096, 64)}   # (n, block)
# PERF.md section 6's smm CUDA-event ms of (a), (b) and (c) at default
# stacks before the table (stack tile 30,000; this script's phase 3 on an
# H100 80GB HBM3 at 700 W)
SMM_MS_BEFORE = {"(a)": 5.263, "(b)": 4.819, "(c)": 1.171}


def sweep_phase(dev, card, zero_counters, read_counters) -> dict:
    """Phase 16: ``autotune.tune_block`` at block 22 on the main path's
    grid on the card, each row's stacks and triples held to the plan's;
    then (a), (b) and (c) through ``dbcsr.multiply`` with the stack tile
    the committed table gives them, bitwise the same product at
    ``stack_size=30000`` (stacks never split a C block's run, so the
    kernel's order of sums is the same), and the smm kernel's CUDA-event
    ms at both tiles in turns (30,000, table, table, 30,000)."""
    import numpy as np
    import torch

    from repro_torch.core import dbcsr, engine
    from repro_torch.core.cannon import cannon_step_masks
    from repro_torch.core.densify import to_blocks
    from repro_torch.kernels.smm import autotune
    from repro_torch.kernels.smm.ops import smm_process_stack
    from repro_torch.launch.mesh import make_mesh

    out = {"card": card, "table": os.path.relpath(autotune.DEFAULT_CACHE,
                                                  REPO),
           "sweep": [], "cases": []}
    n = 22 * SWEEP_NB
    for fill in SWEEP_FILLS:
        t = time.perf_counter()
        res = autotune.tune_block(22, n_blocks=SWEEP_NB, fill=fill)
        mask = autotune.sweep_mask(SWEEP_NB, fill)
        for row in res["rows"]:
            plan = engine.build_executor_plan(n, n, n, 22, 22, 22,
                                              row["stack_tile"], a_mask=mask)
            if (row["n_stacks"], row["n_entries"]) != (plan.n_stacks,
                                                       plan.n_entries):
                raise AssertionError(f"sweep fill {fill:g} tile "
                                     f"{row['stack_tile']}: row {row} "
                                     f"against the plan's {plan.n_stacks} "
                                     f"stacks, {plan.n_entries} triples")
        print(f"  sweep, block 22, {SWEEP_NB}^2 blocks, fill {fill:g} "
              f"({time.perf_counter() - t:.1f} s, {res['device']}): "
              + "; ".join(f"tile {r['stack_tile']} {1e3 * r['time_s']:.4f} "
                          f"ms {r['gflops']:.0f} GF/s, {r['n_stacks']} "
                          f"stacks" for r in res["rows"])
              + f"; best {res['best']['stack_tile']}; each row's stacks "
              "and triples equal its plan's")
        out["sweep"].append(res)

    mesh = make_mesh((1, 1), ("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    rng = np.random.RandomState(SEED + 16)

    def dense(m):
        return torch.randn((m, m), generator=gen, device=dev)

    (na, ba), (nb64, bb) = SWEEP_SIZES["(a)"], SWEEP_SIZES["(b)"]
    a22, b22 = dense(na), dense(na)
    cases = (("(a)", ba, a22, b22, None),
             ("(b)", bb, dense(nb64), dense(nb64), None),
             ("(c)", ba, a22, b22, rng.rand(na // ba, na // ba) < 0.2))
    for label, bs, a, b, am in cases:
        nb = a.shape[0] // bs
        x = dbcsr.create(a, mesh=mesh, block_size=bs, block_mask=am)
        y = dbcsr.create(b, mesh=mesh, block_size=bs)
        pm = (None if am is None else
              cannon_step_masks(am, np.ones((nb, nb), bool), 1)[0])
        fill = engine._mask_fill(nb, nb, nb, None, None, pm)
        meta = autotune.best_params_meta(bs, bs, bs, fill=fill)
        if not meta["source"].startswith("winners["):
            raise AssertionError(f"{label}: no winners entry ({meta})")
        zero_counters()
        c_tab = dbcsr.multiply(x, y, mesh=mesh, algorithm="cannon",
                               densify=False)
        torch.cuda.synchronize()
        got = read_counters()
        ran = c_tab.last_plan
        if (ran.stack_tile, ran.params_source) != (meta["stack_tile"],
                                                   meta["source"]):
            raise AssertionError(f"{label}: the multiply ran tile "
                                 f"{ran.stack_tile} from {ran.params_source}"
                                 f", the table gives {meta}")
        c_30 = dbcsr.multiply(x, y, mesh=mesh, algorithm="cannon",
                              densify=False, stack_size=30000)
        torch.cuda.synchronize()
        if c_30.last_plan.stack_tile != 30000:
            raise AssertionError(f"{label}: stack_size=30000 ran tile "
                                 f"{c_30.last_plan.stack_tile}")
        check_close(f"{label} table tile vs torch.matmul", c_tab.data,
                    torch.matmul(x.data, y.data))
        same = torch.equal(c_tab.data, c_30.data)
        where = None
        if not same:
            # report the first differing C block, and hold the product to
            # REL_TOL of max|C| instead
            diff = (c_tab.data != c_30.data).nonzero()[0].tolist()
            where = [diff[0] // bs, diff[1] // bs]
            check_close(f"{label} table tile vs tile 30000", c_tab.data,
                        c_30.data)
        # the kernel alone at both tiles, in turns
        a_blk, b_blk = to_blocks(x.data, bs, bs), to_blocks(y.data, bs, bs)
        cbuf = torch.zeros((nb * nb + 1, bs, bs), device=dev)
        plans = {tile: engine.build_executor_plan(
            a.shape[0], a.shape[0], a.shape[0], bs, bs, bs, tile,
            pair_mask=pm) for tile in (30000, meta["stack_tile"])}

        def kernel(plan):
            def go():
                for t, r in plan.device_bins(dev):
                    smm_process_stack(a_blk, b_blk, cbuf, t, r)
            return go

        times = {tile: [] for tile in plans}
        for tile in (30000, meta["stack_tile"], meta["stack_tile"], 30000):
            times[tile].append(time_ms(kernel(plans[tile]), 5,
                                       setup=cbuf.zero_))
        ms = {tile: statistics.median(v) for tile, v in times.items()}
        rec = {"case": label, "block": bs, "fill": fill,
               "source": meta["source"], "tile": meta["stack_tile"],
               "gflops_table": meta["gflops"], "launches": got,
               "bitwise_30000": same, "first_diff_block": where,
               "smm_ms": ms[meta["stack_tile"]], "smm_ms_30000": ms[30000],
               "smm_ms_before": SMM_MS_BEFORE[label],
               "n_stacks": plans[meta["stack_tile"]].n_stacks,
               "n_stacks_30000": plans[30000].n_stacks}
        print(f"  {label} {a.shape[0]}^2 block {bs}, fill {fill:.3f}: "
              f"{meta['source']} gives tile {meta['stack_tile']} "
              f"({meta['gflops']:.0f} GF/s swept); the multiply ran it "
              f"(launches {got}); its product "
              + ("bitwise" if same else f"NOT bitwise (first at C block "
                 f"{where}; within {REL_TOL:g} of max|C|)")
              + f" the product at stack_size=30000; smm "
              f"{rec['smm_ms']:.3f} ms at tile {meta['stack_tile']} "
              f"({rec['n_stacks']} stacks), {rec['smm_ms_30000']:.3f} at "
              f"30000 ({rec['n_stacks_30000']} stacks; PERF.md section 6: "
              f"{SMM_MS_BEFORE[label]})")
        out["cases"].append(rec)
        del c_tab, c_30, cbuf, plans
    print(json.dumps({"phase16": out}, default=str))
    return out


# ---------------------------------------------------------------------------
# phase 17: the planner's bench-fed calibration, fed from this run
# ---------------------------------------------------------------------------

FIT_CASES = (("(a)", "(a) 3960^2 block 22 dense", 3960, 22),
             ("(b)", "(b) 4096^2 block 64 dense", 4096, 64),
             ("(c)", "(c) 3960^2 block 22, A at 20 % fill, mask only", 3960,
              22))


def fit_phase(dev, card, zero_counters, read_counters, fed) -> dict:
    """Phase 17: ``planner.calibrate.fit_from_artifacts`` fed on the card.

    Writes ``kernels.json``, ``densify.json`` and ``sparse.json`` in the
    JAX benches' schemas (benchmarks/bench_kernels.py, bench_densify.py,
    bench_sparse.py; the columns this run has) into a temporary
    directory, from timings this run took: phase 3's ``torch.matmul`` at
    3,960^2 (``dense_dot``) and the fused smm launches of (a) and (b)
    (``smm_dispatch``), phase 16's sweep rows at block 22 on 180^2 blocks,
    fills 1.0 and 0.2 (its best tile each; ``sparse``), all CUDA events;
    and one taken here: the densified local multiply at (e)'s size with
    its block-layout copies (blocks -> dense A and B, ``torch.matmul``,
    dense C -> blocks), which is what bench_densify.py's
    ``t_densified_s`` prices.  Then fits the directory and resolves
    ``get_hardware_model(bench_dir=...)``.

    Gates: the fitted keys are exactly ``flops_per_s``,
    ``smm_flops_per_s`` and ``stack_entry_s``; the first two equal the
    JAX package's formula recomputed here from the same numbers, the
    third to 1e-12 relative (the fit's slope is ``np.polyfit``'s, this
    one a difference quotient of the two rows); each is finite and
    positive; the resolved model is the defaults with the fit over them
    where the working directory holds no calibration file.  Prints each
    constant beside ``DEFAULT_HARDWARE``'s and phase 7's measured one, and
    the planner's choice at (a), (b), (c) under the fitted model beside
    phase 7's (not gated).  Leaves no directory behind."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.densify import (densified_local_matmul, densify,
                                          from_blocks, to_blocks, undensify)
    from repro_torch.planner import calibrate
    from repro_torch.planner.cost_model import DEFAULT_HARDWARE
    from repro_torch.planner.plan import plan_multiply

    out = {"card": card}
    # the densified local multiply at (e)'s size, its layout copies in
    n, bs = 3960, 22
    nb = n // bs
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    a_blk = to_blocks(torch.randn((n, n), generator=gen, device=dev), bs, bs)
    b_blk = to_blocks(torch.randn((n, n), generator=gen, device=dev), bs, bs)
    lm = densified_local_matmul()

    def densified():
        c = lm(densify(a_blk, nb, nb)[None], densify(b_blk, nb, nb)[None])
        return undensify(c[0], bs, bs)

    zero_counters()
    t_dens = time_ms(densified, 10) / 1e3
    torch.cuda.synchronize()
    got = read_counters()
    check_close("(e)'s densified local multiply with its layout copies vs "
                "torch.matmul", from_blocks(densified(), nb, nb),
                torch.matmul(densify(a_blk, nb, nb), densify(b_blk, nb, nb)))
    print(f"  densified local multiply {n}^2 at block {bs}, blocks -> dense "
          f"-> torch.matmul -> blocks: {1e3 * t_dens:.4f} ms (CUDA events, "
          f"median of 10); launches {got}")
    del a_blk, b_blk

    t_dot = fed["dense_dot_ms"] / 1e3
    kernels = [{"kernel": "smm_dispatch", "block": r["block"],
                "n_stacks": r["n_stacks"], "stack_tile": r["stack_tile"],
                "t_fused_s": r["ms"] / 1e3,
                "fused_gflops": 2.0 * r["n_entries"] * r["block"] ** 3
                / (r["ms"] / 1e3) / 1e9} for r in fed["smm"]]
    kernels.append({"kernel": "dense_dot", "time_s": t_dot,
                    "gflops": 2 * n * n * n / t_dot / 1e9})
    densify_rows = [{"case": "square", "m": n, "k": n, "n": n, "block": bs,
                     "t_densified_s": t_dens}]
    sweep = {res["fill"]: res["best"] for res in fed["sweep"]
             if res["block"] == 22 and res["fill"] in (1.0, 0.2)}
    dense_triples = SWEEP_NB ** 3
    sparse = {"block": 22, "n_blocks": SWEEP_NB, "rows": [
        {"fill": fill, "n_dense_triples": dense_triples,
         "n_triples": row["n_entries"],
         "occupancy": row["n_entries"] / dense_triples,
         "n_stacks": row["n_stacks"], "stack_tile": row["stack_tile"],
         "t_sparse_s": row["time_s"], "t_dense_s": sweep[1.0]["time_s"],
         "dense_over_sparse": sweep[1.0]["time_s"] / row["time_s"]}
        for fill, row in sorted(sweep.items(), reverse=True)]}
    if len(sparse["rows"]) != 2:
        raise AssertionError(f"phase 16 gave sweep rows at {sorted(sweep)}")

    with tempfile.TemporaryDirectory(prefix="bench_h100_") as bench:
        for name, obj in (("kernels.json", kernels),
                          ("densify.json", densify_rows),
                          ("sparse.json", sparse)):
            with open(os.path.join(bench, name), "w") as f:
                json.dump(obj, f, indent=1)
        fit = calibrate.fit_from_artifacts(bench)
        hw = calibrate.get_hardware_model(bench_dir=bench)
    if os.path.exists(bench):
        raise AssertionError(f"{bench} was left behind")

    # the JAX package's formula on the same numbers
    eff = 2.0 * n * n * n / t_dens
    want = {"flops_per_s": min(kernels[-1]["gflops"] * 1e9, eff),
            "smm_flops_per_s": max(r["fused_gflops"]
                                   for r in kernels[:-1]) * 1e9}
    (r1, r2) = sparse["rows"]
    slope = (r1["t_sparse_s"] - r2["t_sparse_s"]) / (r1["n_triples"]
                                                     - r2["n_triples"])
    net = slope - 2.0 * 22 ** 3 / want["smm_flops_per_s"]
    want["stack_entry_s"] = max(net, 1e-8)
    if set(fit) != set(want):
        raise AssertionError(f"fitted keys {sorted(fit)}")
    for key, value in fit.items():
        same = (math.isclose(value, want[key], rel_tol=1e-12)
                if key == "stack_entry_s" else value == want[key])
        if not (same and math.isfinite(value) and value > 0):
            raise AssertionError(f"{key}: fitted {value!r}, the formula "
                                 f"gives {want[key]!r}")
    on_file = os.path.exists(calibrate.DEFAULT_CALIBRATION)
    if not on_file and hw != DEFAULT_HARDWARE.replace(**fit):
        raise AssertionError(f"get_hardware_model(bench_dir=...) gave {hw}")

    measured = fed["phase7"].get("calibration", {})
    print(f"  fitted ({card}; the slope {slope:.6g} s a triple over "
          f"{r2['n_triples']:,}-{r1['n_triples']:,} triples, minus "
          f"2*22^3 / smm rate = {net:.6g} s"
          + (", under the 1e-8 floor" if net < 1e-8 else "") + "):")
    for key in sorted(fit):
        got_m = measured.get(key)
        print(f"  {key:16s} fitted {fit[key]:.6g}, DEFAULT_HARDWARE "
              f"{getattr(DEFAULT_HARDWARE, key):.6g}, phase 7 measured "
              + ("-" if got_m is None else f"{got_m:.6g}"))
    print("  get_hardware_model(bench_dir=...): defaults <- fit"
          + (f" <- {calibrate.DEFAULT_CALIBRATION} (the working directory's)"
             if on_file else " (no calibration file)"))

    hw7 = DEFAULT_HARDWARE.replace(**{k: v for k, v in measured.items()
                                      if k in DEFAULT_HARDWARE.to_dict()})
    cases7 = {c["case"].split(" (=")[0]: c for c in fed["phase7"]["cases"]}
    out.update(fit=fit, formula=want, t_densified_s=t_dens,
               t_dense_dot_s=t_dot, kernels=kernels, sparse=sparse,
               choices=[])
    for label, key, size, block in FIT_CASES:
        c7 = cases7[key]
        kw = dict(blocks=(block,) * 3, occupancy=c7["occupancy"])
        p_fit = plan_multiply(size, size, size, hw=hw, **kw)
        p_7 = plan_multiply(size, size, size, hw=hw7, **kw)
        p_def = plan_multiply(size, size, size, hw=DEFAULT_HARDWARE, **kw)

        def name(p):
            return (f"{p.algorithm}+{'densified' if p.densify else 'blocked'}"
                    f" {1e3 * p.predicted_s:.3f} ms")

        row = {"case": label, "occupancy": c7["occupancy"],
               "phase7_auto": c7["auto"], "phase7_ms": c7["auto_ms"],
               "fitted": name(p_fit), "phase7_model": name(p_7),
               "default": name(p_def)}
        out["choices"].append(row)
        print(f"  {label} occupancy {c7['occupancy']:.4f}: fitted model -> "
              f"{row['fitted']}; phase 7's model -> {row['phase7_model']} "
              f"(phase 7 ran {c7['auto']}, {c7['auto_ms']:.3f} ms); "
              f"DEFAULT_HARDWARE -> {row['default']}")
    print(json.dumps({"phase17": out}, default=str))
    return out


def get_layers(arch):
    from repro_torch.configs.base import get_config

    return get_config(arch).num_layers


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", type=int,
                    choices=[9, 10, 11, 12, 13, 14, 15, 16],
                    default=None,
                    help="development: build the kernels and run this "
                         "phase alone (prints no kernels and no ok line)")
    only = ap.parse_args(argv).phase

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    use_repo_table()
    import numpy as np

    from repro_torch.core import dbcsr
    from repro_torch.core.cannon import cannon_step_masks, cannon_step_norms
    from repro_torch.core.densify import to_blocks, to_blocks_batched
    from repro_torch.core.engine import (build_batched_executor_plan,
                                         build_executor_plan)
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.grouped_gemm.ops import (grouped_gemm,
                                                      grouped_process_stack)
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref
    from repro_torch.kernels.smm.ops import smm_process_stack, stack_run_starts
    from repro_torch.kernels.smm.ref import smm_process_stack_ref
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref
    from repro_torch.launch.mesh import hw_for, make_mesh
    from repro_torch.serve import MultiplyService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    hw = hw_for(name)
    flops_peak, hbm_rate = hw["peak_flops"]["float32"], hw["hbm_bw"]
    card = card_line()
    rng = np.random.RandomState(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err_abs = {"smm": 0.0, "tiled_matmul": 0.0, "grouped_gemm": 0.0,
               "decode_attention": 0.0}
    err_bf16_out = 0.0   # decode_attention's bf16 outputs (rounded)

    # ---------------------------------------------------------- phase 0
    t_script = time.perf_counter()

    def mark(n):   # each phase's start, for the wall's breakdown
        print(f"  [phase {n} starts {time.perf_counter() - t_script:.1f} s "
              "into the script]")

    print("phase 0: card and build")
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    t0 = time.perf_counter()
    # decode_attention's build (30 template instantiations, the longest)
    # runs on in a thread while phases 1-3 check and time the other three
    # kernels; its checks wait for it at the end of phase 3
    late = {}

    def build_late():
        try:
            late.update(_build.build(["decode_attention"]))
        except BaseException as e:     # re-raised by wait_late_build
            late["error"] = e

    late_build = threading.Thread(target=build_late, daemon=True)
    late_build.start()
    built = _build.build([k for k in _build.SOURCES
                          if k != "decode_attention"])
    per_source = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items())
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, in parallel: {per_source}); "
          "decode_attention building beside phases 1-3")

    def wait_late_build():
        t_wait = time.perf_counter()
        late_build.join()
        if "error" in late:
            raise late["error"]
        print(f"  built decode_attention in "
              f"{late['decode_attention']['seconds']:.2f} s (nvcc started "
              f"with the others; waited {time.perf_counter() - t_wait:.2f} "
              "s for it here)")
    # phase 12 (af): the dry-run grid runs on the host's CPU meanwhile
    grid_dir = os.path.join(REPO, "artifacts", "dryrun_torch")
    shutil.rmtree(grid_dir, ignore_errors=True)
    grid = start_dryrun(grid_dir) if only in (None, 12) else []
    counters = {"smm": smm_process_stack, "tiled_matmul": tiled_matmul,
                "grouped_gemm": grouped_gemm,
                "decode_attention": decode_attention}
    launches = {key: 0 for key in counters}

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0

    def read_counters():
        got = {key: fn.launches for key, fn in counters.items()}
        for key in launches:
            launches[key] += got[key]
        return got

    if only is not None:
        # a development run of one phase: no kernels line, no ok line
        wait_late_build()
        print(f"phase {only} ({card})")
        if only == 9:
            obs_and_tensors(dev, card, zero_counters, read_counters)
        elif only == 10:
            layer_kinds(dev, card, zero_counters, read_counters,
                        decode_attention, decode_attention_ref, hw)
        elif only == 11:
            training(dev, card, zero_counters, read_counters, hw)
        elif only == 13:
            process_mesh(card)
        elif only in (14, 15):
            lm_on_mesh(dev, card, hw)
        elif only == 16:
            sweep_phase(dev, card, zero_counters, read_counters)
        else:
            launch_tools(dev, card, hw, grid, grid_dir)
        print(f"phase {only} alone: done; launches {launches}")
        return 0

    # ---------------------------------------------------------- phase 1
    mark(1)
    print("phase 1: kernels against their plain versions")

    def smm_case(label, plan, dtype, invalidate=0.0):
        nblk_a = plan.nbr * plan.nbk
        nblk_b = plan.nbk * plan.nbc
        a = torch.randn((nblk_a, plan.block_m, plan.block_k), generator=gen,
                        device=dev).to(dtype)
        b = torch.randn((nblk_b, plan.block_k, plan.block_n), generator=gen,
                        device=dev).to(dtype)
        c0 = torch.randn((plan.n_c_blocks + 1, plan.block_m, plan.block_n),
                         generator=gen, device=dev)
        ck, cp = c0.clone(), c0.clone()
        for tri in plan.bin_triples:
            t = np.array(tri.reshape(-1, 4))
            if invalidate:
                # mark some real rows invalid: the kernel must skip them
                real = np.flatnonzero(t[:, 3] != 0)
                t[rng.choice(real, int(invalidate * real.size),
                             replace=False), 3] = 0
            r = torch.tensor(stack_run_starts(t), device=dev)
            t = torch.tensor(t, device=dev)
            smm_process_stack(a, b, ck, t, r)
            smm_process_stack_ref(a, b, cp, t)
        torch.cuda.synchronize()
        err_abs["smm"] = max(err_abs["smm"], check_close(
            f"smm {label} {str(dtype)[6:]} ({plan.n_bins} bins, "
            f"{plan.n_entries} triples)", ck[:-1], cp[:-1]))

    for blk, nb, stack in ((4, 40, 990), (22, 30, 990), (64, 12, 990)):
        plan = build_executor_plan(blk * nb, blk * nb, blk * nb, blk, blk,
                                   blk, stack)
        if plan.plans[-1].size == plan.plans[0].size:
            raise AssertionError(f"block {blk}: no ragged final stack")
        for dtype in (torch.float32, torch.bfloat16):
            smm_case(f"block {blk}, ragged tail", plan, dtype)
        smm_case(f"block {blk}, 10% valid=0 rows", plan, torch.float32,
                 invalidate=0.1)
    # ragged runs of ~8 triples packed into stacks of at most 8: stack
    # lengths differ enough for the executor to size-bin them
    nb = 40
    a_mask = rng.rand(nb, nb) < 0.2
    plan = build_executor_plan(22 * nb, 22 * nb, 22 * nb, 22, 22, 22, 8,
                               a_mask=a_mask)
    if plan.n_bins < 2:
        raise AssertionError(f"masked plan has {plan.n_bins} bin(s)")
    for dtype in (torch.float32, torch.bfloat16):
        smm_case("block 22, 20% A mask", plan, dtype)

    def smm_edges(bm, bk, bn, dtype, three_cols):
        n = 25
        t = edge_stack(rng, n, n, n)
        if three_cols:
            t = np.ascontiguousarray(t[t[:, 3] != 0, :3])
        a = torch.randn((n, bm, bk), generator=gen, device=dev).to(dtype)
        b = torch.randn((n, bk, bn), generator=gen, device=dev).to(dtype)
        ck = torch.randn((n + 1, bm, bn), generator=gen, device=dev)
        cp = ck.clone()
        r = torch.tensor(stack_run_starts(t), device=dev)
        t = torch.tensor(t, device=dev)
        smm_process_stack(a, b, ck, t, r)
        smm_process_stack_ref(a, b, cp, t)
        torch.cuda.synchronize()
        err_abs["smm"] = max(err_abs["smm"], check_close(
            f"smm edges {bm}x{bk}x{bn} {str(dtype)[6:]}, {t.shape[1]} "
            f"columns, {int(r.shape[0])} runs", ck[:-1], cp[:-1]))

    for shape in ((4, 4, 4), (22, 22, 22), (23, 23, 23), (32, 32, 32),
                  (33, 33, 33), (64, 64, 64), (100, 100, 100), (22, 64, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            for three_cols in (False, True):
                smm_edges(*shape, dtype, three_cols)

    def operand(shape, dtype, offset=0):
        """Random and contiguous; at ``offset`` > 0 a view that starts that
        many elements into its storage (data_ptr() not 16-byte aligned)."""
        n = int(np.prod(shape))
        flat = torch.randn(n + offset, generator=gen, device=dev).to(dtype)
        return flat[offset:].view(shape)

    # the GEMM body's edges (32-deep K slices; B by 16-byte copies where N
    # and the pointers allow, else one element a copy): K no multiple of
    # 32 and below one slice, K or N % 4 != 0, M or N of 1, and operands
    # at storage offset 1 (last field)
    for m, k, n, off in ((1000, 777, 1030, 0), (129, 3960, 257, 0),
                         (70, 7, 90, 0), (130, 12, 136, 0), (129, 40, 260, 0),
                         (64, 64, 130, 0), (1, 300, 256, 0), (257, 48, 1, 0),
                         (300, 200, 256, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            a, b = operand((m, k), dtype, off), operand((k, n), dtype, off)
            out, ref = tiled_matmul(a, b), tiled_matmul_ref(a, b)
            torch.cuda.synchronize()
            err_abs["tiled_matmul"] = max(err_abs["tiled_matmul"], check_close(
                f"tiled_matmul {m}x{k}x{n} {str(dtype)[6:]}"
                + (f" at offset {off}" if off else ""), out, ref))

    for e, m, k, n, off in ((3, 200, 333, 130, 0), (1, 1000, 777, 1030, 0),
                            (3, 70, 7, 90, 0), (2, 130, 40, 136, 0),
                            (2, 64, 64, 130, 0), (2, 1, 300, 256, 0),
                            (2, 200, 256, 128, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            t, w = operand((e, m, k), dtype, off), operand((e, k, n), dtype, off)
            out, ref = grouped_gemm(t, w), grouped_gemm_ref(t, w)
            torch.cuda.synchronize()
            err_abs["grouped_gemm"] = max(err_abs["grouped_gemm"], check_close(
                f"grouped_gemm {e}x{m}x{k}x{n} {str(dtype)[6:]}"
                + (f" at offset {off}" if off else ""), out, ref))

    # one summation order: product e of a batch is bitwise the product alone
    for dtype in (torch.float32, torch.bfloat16):
        t, w = operand((3, 200, 333), dtype), operand((3, 333, 130), dtype)
        out = grouped_gemm(t, w)
        if not all(torch.equal(out[i], tiled_matmul(t[i], w[i]))
                   for i in range(3)):
            raise AssertionError(f"grouped_gemm(t, w)[e] != tiled_matmul(t[e], "
                                 f"w[e]) ({str(dtype)[6:]})")
        print(f"  grouped_gemm(t, w)[e] == tiled_matmul(t[e], w[e]) bitwise, "
              f"E=3, 200x333x130 {str(dtype)[6:]}")

    def decode_inputs(b, hkv, r, dh, s, dtype):
        q = torch.randn((b, 1, hkv * r, dh), generator=gen, device=dev)
        k = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
        v = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def decode_case(b, hkv, r, dh, s, cur, dtype):
        nonlocal err_bf16_out
        q, k, v = decode_inputs(b, hkv, r, dh, s, dtype)
        cur_len = torch.tensor([cur], dtype=torch.int32, device=dev)
        out = decode_attention(q, k, v, cur_len).float().reshape(b, hkv, r, dh)
        ref = decode_attention_ref(q.reshape(b, hkv, r, dh), k, v, cur_len)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if dtype == torch.float32:
            worst = float(((out - ref).abs() / (DA_TOL + DA_TOL * ref.abs()))
                          .max())
        else:
            worst = bf16_worst(out, ref)
        print(f"  decode_attention B={b} Hkv={hkv} R={r} Dh={dh} S={s} "
              f"cur_len={cur} {str(dtype)[6:]}: max abs err {err:.3e} "
              f"(worst / tolerance {worst:.3f})")
        if not worst <= 1.0:
            raise AssertionError("decode_attention disagrees with its plain "
                                 "version")
        if dtype == torch.float32:
            err_abs["decode_attention"] = max(err_abs["decode_attention"], err)
        else:
            err_bf16_out = max(err_bf16_out, err)

    def decode_checks():
        """Phase 1's decode_attention checks, run once its build is in."""
        # the JAX package's kernel test cases (B, Hkv, R, Dh, S, cur_len)
        for case in ((2, 2, 4, 64, 256, 200), (1, 1, 8, 128, 512, 512),
                     (2, 4, 1, 64, 128, 7), (1, 2, 6, 32, 384, 100)):
            decode_case(*case, torch.float32)
        decode_case(1, 2, 4, 64, 256, 250, torch.bfloat16)
        for cur in (0, 1, 513, 1000):   # serve heads, S = 1,000 = 62 tiles + 8
            for dtype in (torch.float32, torch.bfloat16):
                decode_case(2, 8, 6, 128, 1000, cur, dtype)
        # Jamba's attention layer in phase 10 (z): 32/8 heads (R 4), Dh 128
        for dtype in (torch.float32, torch.bfloat16):
            decode_case(8, 8, 4, 128, 4096, 2064, dtype)
        # Dh % 4 != 0: 4-byte copies in f32, plain loads in bf16; ragged S
        for case in ((1, 2, 3, 33, 130, 70), (2, 2, 6, 65, 200, 200),
                     (1, 1, 4, 33, 70, 0)):
            for dtype in (torch.float32, torch.bfloat16):
                decode_case(*case, dtype)

    # ---------------------------------------------------------- phase 2
    mark(2)
    print("phase 2: dbcsr.create -> dbcsr.multiply on a 1x1 mesh")
    mesh = make_mesh((1, 1), ("data", "model"))

    def run(label, a, b, **kw):
        zero_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        c = dbcsr.multiply(a, b, mesh=mesh, algorithm="cannon", **kw)
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        got = read_counters()
        repeats = []
        for _ in range(3):
            t = time.perf_counter()
            again = dbcsr.multiply(a, b, mesh=mesh, algorithm="cannon", **kw)
            torch.cuda.synchronize()
            repeats.append(time.perf_counter() - t)
            if not torch.equal(again.data, c.data):
                raise AssertionError(f"{label}: a repeated multiply differs")
        print(f"  {label}: first call {first:.3f} s (plan build included), "
              f"repeat median of 3 {1e3 * statistics.median(repeats):.2f} ms "
              f"(min {1e3 * min(repeats):.2f}); launches {got}")
        return c, got

    def dense(n):
        return torch.randn((n, n), generator=gen, device=dev)

    def expect_launches(got, key, want):
        if got[key] != want:
            raise AssertionError(f"{key} launched {got[key]} times, expected {want}")

    # (a) 3,960^2 at block 22, dense
    A = dbcsr.create(dense(3960), mesh=mesh, block_size=22)
    B = dbcsr.create(dense(3960), mesh=mesh, block_size=22)
    exact = torch.matmul(A.data, B.data)
    c, got = run("(a) 3960^2 block 22 blocked", A, B, densify=False)
    check_close("(a) vs torch.matmul", c.data, exact)
    plan_a = build_executor_plan(3960, 3960, 3960, 22, 22, 22,
                                 table_tile(22, 180))
    expect_launches(got, "smm", plan_a.n_bins)
    if c.block_mask is not None:
        raise AssertionError("(a) dense product carries a mask")

    # (d) and (e): the densified path on the same operands
    c, got = run("(d) 3960^2 densified pallas", A, B, densify=True,
                 local_kernel="pallas")
    check_close("(d) vs torch.matmul", c.data, exact)
    if got["tiled_matmul"] < 1:
        raise AssertionError("(d) never launched tiled_matmul")
    c, got = run("(e) 3960^2 densified torch.matmul", A, B, densify=True)
    check_close("(e) vs torch.matmul", c.data, exact)
    del c
    precision_check("(e) 3960^2", A.data, B.data, mesh, zero_counters,
                    read_counters, card)

    # (c) A at ~20% block fill, first at the default stack size, then at
    # stack_size 64, which makes the ragged runs (~36 triples each) pack
    # into stacks of very different lengths, so the plan has several
    # size bins
    nb = 180
    am = rng.rand(nb, nb) < 0.2
    # block scales over two decades give the norm filter work to do
    scale = np.repeat(np.repeat(10.0 ** (-2 * rng.rand(nb, nb)), 22, 0), 22, 1)
    Am = dbcsr.create(dense(3960) * torch.tensor(scale, dtype=torch.float32,
                                                 device=dev),
                      mesh=mesh, block_size=22, block_mask=am)
    exact = torch.matmul(Am.data, B.data)
    bm = np.ones((nb, nb), dtype=bool)
    c_def, got = run("(c) 3960^2 block 22 blocked, 20% A mask, default "
                     "stacks", Am, B, densify=False)
    check_close("(c) default stacks vs torch.matmul", c_def.data, exact)
    pm_c = cannon_step_masks(am, bm, 1)[0]
    plan_c_def = build_executor_plan(3960, 3960, 3960, 22, 22, 22,
                                     table_tile(22, nb, pair_mask=pm_c),
                                     pair_mask=pm_c)
    expect_launches(got, "smm", plan_c_def.n_bins)
    del c_def
    c_none, got = run("(c) 3960^2 block 22 blocked, 20% A mask, stacks "
                      "<= 64", Am, B, densify=False, stack_size=64)
    check_close("(c) vs torch.matmul", c_none.data, exact)
    plan_c = build_executor_plan(
        3960, 3960, 3960, 22, 22, 22, 64,
        pair_mask=cannon_step_masks(am, bm, 1)[0])
    if plan_c.n_bins < 2:
        raise AssertionError(f"(c) plan has {plan_c.n_bins} bin(s)")
    expect_launches(got, "smm", plan_c.n_bins)
    sym = (am.astype(np.int64) @ bm.astype(np.int64)) > 0
    if not np.array_equal(c_none.block_mask, sym):
        raise AssertionError("(c) result mask != symbolic product mask")

    c0, got = run("(c) filter_eps=0", Am, B, densify=False, stack_size=64,
                  filter_eps=0.0)
    if not torch.equal(c0.data, c_none.data):
        raise AssertionError("(c) filter_eps=0 is not bitwise equal to None")
    if not np.array_equal(c0.block_mask, sym):
        raise AssertionError("(c) eps=0 mask != symbolic product mask")

    an, bn = Am.norms(), B.norms()
    # norm products as the step plan forms them (float32, compared in
    # float64); eps sits in a wide gap between two of them near the
    # median, so no product is within rounding of the threshold
    prod = (an[:, :, None] * bn[None]).astype(np.float64)
    present = am[:, :, None] & bm[None]
    srt = np.sort(prod[present])
    mid = srt.size // 2
    gaps = srt[mid - 1000:mid + 1000] / srt[mid - 1001:mid + 999]
    i = mid - 1001 + int(np.argmax(gaps))
    eps = float(np.sqrt(srt[i] * srt[i + 1]))
    c_eps, got = run(f"(c) filter_eps={eps:.4g}", Am, B, densify=False,
                     stack_size=64, filter_eps=eps)
    dropped = present & (prod < eps)
    retained = (present & (prod >= eps)).any(axis=1)
    if not np.array_equal(c_eps.block_mask, retained):
        raise AssertionError("(c) eps result mask != retained product mask")
    plan_eps = build_executor_plan(
        3960, 3960, 3960, 22, 22, 22, 64,
        pair_mask=cannon_step_masks(am, bm, 1)[0],
        pair_norms=cannon_step_norms(np.where(am, an, np.float32(0)), bn, 1)[0],
        filter_eps=eps)
    expect_launches(got, "smm", plan_eps.n_bins)
    # each block may miss at most its dropped contributions
    bound = (np.where(dropped, prod, 0.0).sum(axis=1)
             + REL_TOL * float(exact.abs().max()) * 22)
    diff = (c_eps.data - exact).reshape(nb, 22, nb, 22)
    blk_err = torch.sqrt((diff.double() ** 2).sum(dim=(1, 3))).cpu().numpy()
    worst = float((blk_err / bound).max())
    print(f"  (c) eps: {int(dropped.sum())} of {int(present.sum())} triples "
          f"dropped; worst block error / dropped bound = {worst:.3f}")
    if not worst <= 1.0:
        raise AssertionError("(c) eps error exceeds the dropped-norm bound")
    del c_none, c0, c_eps

    # (b) 4,096^2 at block 64, dense
    A64 = dbcsr.create(dense(4096), mesh=mesh, block_size=64)
    B64 = dbcsr.create(dense(4096), mesh=mesh, block_size=64)
    c, got = run("(b) 4096^2 block 64 blocked", A64, B64, densify=False)
    check_close("(b) vs torch.matmul", c.data, torch.matmul(A64.data, B64.data))
    plan_b = build_executor_plan(4096, 4096, 4096, 64, 64, 64,
                                 table_tile(64, 64))
    expect_launches(got, "smm", plan_b.n_bins)
    del c

    # the batched path's operands: 16 requests at one rank of 63,360^2 on
    # a 32x32 grid (1,980^2, 90^2 blocks of 22)
    G, NB, BS = 16, 1980, 22
    nbb = NB // BS
    dense_reqs = [(dbcsr.create(dense(NB), mesh=mesh, block_size=BS),
                   dbcsr.create(dense(NB), mesh=mesh, block_size=BS))
                  for _ in range(G)]
    a_stack = torch.stack([a.data for a, _ in dense_reqs])
    b_stack = torch.stack([b.data for _, b in dense_reqs])
    t = time.perf_counter()
    plan_f = build_batched_executor_plan(NB, NB, NB, BS, BS, BS, [{}] * G,
                                         stack_size=table_tile(BS, nbb))
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    plan_f.device_triples(dev)
    torch.cuda.synchronize()
    print(f"  (f)'s fused plan: host build {build_s:.3f} s, upload "
          f"{time.perf_counter() - t:.3f} s (memoized: phase 4 reuses both)")
    if plan_f.n_launches != 1:
        raise AssertionError(f"(f) plan launches {plan_f.n_launches}")

    # ---------------------------------------------------------- phase 3
    mark(3)
    print(f"phase 3: times (median of CUDA events; {card})")

    def smm_times(label, plan, a, b):
        a_blocks = to_blocks(a, plan.block_m, plan.block_k)
        b_blocks = to_blocks(b, plan.block_k, plan.block_n)
        c = torch.zeros((plan.n_c_blocks + 1, plan.block_m, plan.block_n),
                        device=dev)
        bins = plan.device_bins(dev)

        def kernel():
            for t, r in bins:
                smm_process_stack(a_blocks, b_blocks, c, t, r)

        def plain():
            for (t, _), tri in zip(bins, plan.bin_triples):
                tile = tri.shape[1]
                for s in range(0, t.shape[0], tile):
                    smm_process_stack_ref(a_blocks, b_blocks, c, t[s:s + tile])

        ms = time_ms(kernel, 5, setup=c.zero_)
        out_k = c[:-1].clone()
        plain_ms = time_ms(plain, 3, setup=c.zero_)
        err_abs["smm"] = max(err_abs["smm"], check_close(
            f"smm {label} kernel vs plain", out_k, c[:-1]))
        # absent blocks are stored as zeros, so one dense torch.matmul
        # computes the same function for dense and mask-only plans (an
        # eps plan, which drops present products, is never timed here)
        library_ms = time_ms(lambda: torch.matmul(a, b), 10)
        flops = 2.0 * plan.n_entries * plan.block_m * plan.block_k * plan.block_n
        # bytes this plan needs: the A and B blocks its triples name, C
        # read and written once, the triples and run starts
        rows = sum(int(t.shape[0]) for t, _ in bins)
        runs = sum(int(r.shape[0]) for _, r in bins)
        used = np.concatenate([p.triples for p in plan.plans])
        nbytes = (np.unique(used[:, 0]).size * plan.block_m * plan.block_k
                  * a_blocks.element_size()
                  + np.unique(used[:, 1]).size * plan.block_k * plan.block_n
                  * b_blocks.element_size()
                  + 2 * plan.n_c_blocks * plan.block_m * plan.block_n * 4
                  + rows * 16 + runs * 4)
        return report("smm", label, ms, plain_ms, library_ms, flops, nbytes,
                      plan.n_launches)

    def report(kernel, label, ms, plain_ms, library_ms, flops, nbytes,
               per_call):
        t_flop = 1e3 * flops / flops_peak
        t_byte = 1e3 * nbytes / hbm_rate
        row = {"shape": label, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_flop, t_byte),
               "bound_by": "operations" if t_flop >= t_byte else "bytes",
               "library_ms": library_ms, "launches_per_multiply": per_call,
               "flop": flops, "bytes": nbytes}
        print(f"  {kernel} {label}: kernel {ms:.3f} ms, launches/multiply "
              f"{per_call}, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
              f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms")
        return row

    smm_rows = [smm_times("3960^2 block 22 dense", plan_a, A.data, B.data),
                smm_times("4096^2 block 64 dense", plan_b, A64.data, B64.data),
                smm_times("3960^2 block 22 A 20% fill, default stacks",
                          plan_c_def, Am.data, B.data),
                smm_times("3960^2 block 22 A 20% fill, stacks <= 64", plan_c,
                          Am.data, B.data)]
    a, b = A.data, B.data
    ms = time_ms(lambda: tiled_matmul(a, b), 10)
    plain_ms = time_ms(lambda: tiled_matmul_ref(a, b), 10)
    library_ms = time_ms(lambda: torch.matmul(a, b), 10)
    out = tiled_matmul(a, b)
    err_abs["tiled_matmul"] = max(err_abs["tiled_matmul"], check_close(
        "tiled_matmul 3960^3 kernel vs plain", out, tiled_matmul_ref(a, b)))
    print(f"  tiled_matmul 3960^3 bitwise torch.matmul (an observation of "
          f"cuBLAS, not a check): {torch.equal(out, torch.matmul(a, b))}")
    del out
    tiled_rows = [report("tiled_matmul", "3960^3 f32", ms, plain_ms,
                         library_ms, 2.0 * 3960 ** 3, 4 * 3 * 3960 ** 2, 1)]
    # the ragged shape of phase 1: N % 4 != 0, one element a copy
    m, k, n = 1000, 777, 1030
    a, b = operand((m, k), torch.float32), operand((k, n), torch.float32)
    ms = time_ms(lambda: tiled_matmul(a, b), 10)
    plain_ms = time_ms(lambda: tiled_matmul_ref(a, b), 10)
    library_ms = time_ms(lambda: torch.matmul(a, b), 10)
    err_abs["tiled_matmul"] = max(err_abs["tiled_matmul"], check_close(
        f"tiled_matmul {m}x{k}x{n} kernel vs plain", tiled_matmul(a, b),
        tiled_matmul_ref(a, b)))
    tiled_rows.append(report("tiled_matmul", f"{m}x{k}x{n} f32", ms, plain_ms,
                             library_ms, 2.0 * m * k * n,
                             4 * (m * k + k * n + m * n), 1))

    # (f)'s fused launch: all 16 products' stacks in one smm launch
    a_blocks = to_blocks_batched(a_stack, BS, BS).reshape(-1, BS, BS)
    b_blocks = to_blocks_batched(b_stack, BS, BS).reshape(-1, BS, BS)
    c = torch.zeros((G * nbb * nbb + 1, BS, BS), device=dev)
    t_f, r_f = plan_f.device_triples(dev)
    ms = time_ms(lambda: grouped_process_stack(a_blocks, b_blocks, c, t_f,
                                               r_f), 5, setup=c.zero_)
    out_k = c[:-1].clone()
    tile = plan_f.stack_tile

    def fused_plain():
        for s in range(0, t_f.shape[0], tile):
            smm_process_stack_ref(a_blocks, b_blocks, c, t_f[s:s + tile])

    plain_ms = time_ms(fused_plain, 3, setup=c.zero_)
    err_abs["smm"] = max(err_abs["smm"], check_close(
        f"smm fused {G} x {NB}^2 block {BS} kernel vs plain", out_k, c[:-1]))
    del out_k, c
    library_ms = time_ms(lambda: torch.bmm(a_stack, b_stack), 10)
    nbytes = (2 * G * nbb * nbb * BS * BS * 4            # A and B blocks
              + 2 * G * nbb * nbb * BS * BS * 4          # C read and written
              + int(t_f.shape[0]) * 16 + int(r_f.shape[0]) * 4)
    smm_rows.append(report(
        "smm", f"fused batch {G} x {NB}^2 block {BS} dense (one launch)", ms,
        plain_ms, library_ms, 2.0 * plan_f.n_entries * BS ** 3, nbytes, 1))
    print(f"  fused triples: {plan_f.n_stacks} x {plan_f.stack_tile} rows "
          f"({plan_f.n_stacks * plan_f.stack_tile * 16 / 1e6:.0f} MB), "
          f"padding {100 * plan_f.padding_frac:.1f} %, "
          f"{int(r_f.shape[0])} runs")

    ms = time_ms(lambda: grouped_gemm(a_stack, b_stack), 10)
    plain_ms = time_ms(lambda: grouped_gemm_ref(a_stack, b_stack), 10)
    err_abs["grouped_gemm"] = max(err_abs["grouped_gemm"], check_close(
        f"grouped_gemm {G} x {NB}^3 kernel vs plain",
        grouped_gemm(a_stack, b_stack),
        grouped_gemm_ref(a_stack, b_stack)))
    grouped_rows = [report("grouped_gemm", f"{G} x {NB}^3 f32", ms, plain_ms,
                           library_ms, 2.0 * G * NB ** 3,
                           4 * 3 * G * NB ** 2, 1)]
    del a_stack, b_stack

    def decode_times(label, b, s, cur, hkv=8, r=6, dh=128):
        nonlocal err_bf16_out
        q, k, v = decode_inputs(b, hkv, r, dh, s, torch.bfloat16)
        cur_len = torch.tensor([cur], dtype=torch.int32, device=dev)
        qg = q.reshape(b, hkv, r, dh)
        ms = time_ms(lambda: decode_attention(q, k, v, cur_len), 20, inner=10)
        plain_ms = time_ms(lambda: decode_attention_ref(qg, k, v, cur_len), 5)
        out = decode_attention(q, k, v, cur_len).float().reshape(qg.shape)
        ref = decode_attention_ref(qg, k, v, cur_len)
        err = float((out - ref).abs().max())
        worst = bf16_worst(out, ref)
        if not worst <= 1.0:
            raise AssertionError(f"decode_attention {label} disagrees with "
                                 f"its plain version ({err:.3e}, worst / one "
                                 f"bf16 step {worst:.3f})")
        err_bf16_out = max(err_bf16_out, err)
        del out, ref
        # the yardstick: one PyTorch call of the same function
        mask = (torch.arange(s, device=dev) < cur_len).reshape(1, 1, 1, s)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 5, inner=10)
        h = hkv * r
        # each input read once (q, cur_len, the K and V rows below
        # cur_len: the rest weigh exactly 0), the bf16 output written
        # once; QK^T and PV: 2 flop per multiply-add
        n = min(cur, s) if cur >= 1 else s
        nbytes = 2 * (b * h * dh + 2 * b * n * hkv * dh + b * h * dh) + 4
        flops = 4.0 * b * h * n * dh
        print(f"  decode_attention {label}: B={b}, S={s}, Hkv={hkv}, R={r}, "
              f"Dh={dh}, bf16, cur_len={cur}; max abs err vs plain "
              f"{err:.3e} (worst / one bf16 step {worst:.3f}); SDPA reads "
              f"all {s} rows")
        return report("decode_attention", label, ms, plain_ms, library_ms,
                      flops, nbytes, 1)

    wait_late_build()
    print("phase 1, decode_attention against its plain version (after its "
          "build)")
    decode_checks()
    decode_rows = [decode_times("(l) B=8 S=4096", 8, 4096, 4096),
                   decode_times("(m) B=16 S=32768", 16, 32768, 32768),
                   decode_times("(n) B=8 S=4096 cur_len=2064", 8, 4096, 2064),
                   decode_times("(z) Jamba heads 32/8, B=8 S=4096 "
                                "cur_len=2064", 8, 4096, 2064, r=4)]

    # ---------------------------------------------------------- phase 4
    mark(4)
    print("phase 4: MultiplyService -> dbcsr.multiply_batched, "
          f"{G} requests of {NB}^2, block {BS}, 1x1 mesh")
    exec_kw = dict(algorithm="cannon", pipeline_depth=1)

    def serve(label, reqs, want, n_buckets, filter_eps=None, **kw):
        """Submit, flush and collect ``reqs`` through a fused service;
        returns (first results, looped results)."""
        svc = MultiplyService(mesh, fused=True, max_batch=G, slo_s=60.0,
                              filter_eps=filter_eps, **exec_kw, **kw)

        def flush_all():
            torch.cuda.synchronize()
            t = time.perf_counter()
            tickets = [svc.submit(a, b) for a, b in reqs]
            svc.flush()
            out = [svc.result(tk) for tk in tickets]
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        zero_counters()
        out, first = flush_all()
        got = read_counters()
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        if svc.stats()["n_dispatches"] != n_buckets:
            raise AssertionError(f"{label}: {svc.stats()['n_dispatches']} "
                                 f"dispatches, expected {n_buckets}")
        again, repeat = flush_all()
        for x, y in zip(out, again):
            if not torch.equal(x.data, y.data):
                raise AssertionError(f"{label}: a repeated flush differs")
        st = svc.stats()
        if (st["n_fused_requests"] != st["n_requests"]
                or st["n_retries"] or st["n_degradations"]
                or st["n_error_tickets"]):
            raise AssertionError(f"{label}: service stats {st}")
        looped_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            looped = dbcsr.multiply_batched(
                reqs, mesh=mesh, fused=False, filter_eps=filter_eps,
                **exec_kw, **kw)
            torch.cuda.synchronize()
            looped_s.append(time.perf_counter() - t)
        print(f"  {label}: fused flush first {first:.3f} s (plans built), "
              f"repeat {1e3 * repeat:.2f} ms; looped first "
              f"{looped_s[0]:.3f} s, repeat {1e3 * looped_s[1]:.2f} ms; "
              f"launches {got}")
        return out, looped

    def against_matmul(label, out, reqs):
        for i, (c, (a, b)) in enumerate(zip(out, reqs)):
            rel = rel_err(c.data, torch.matmul(a.data, b.data))
            if not rel <= REL_TOL:
                raise AssertionError(f"{label} request {i}: error {rel:.3e}")
        print(f"  {label}: {len(out)} products within {REL_TOL:g} of "
              "max|C| of torch.matmul")

    def bitwise(label, out, looped):
        for i, (x, y) in enumerate(zip(out, looped)):
            if not torch.equal(x.data, y.data):
                raise AssertionError(f"{label} request {i}: fused != looped")
            if (x.block_mask is None) != (y.block_mask is None) or (
                    x.block_mask is not None
                    and not np.array_equal(x.block_mask, y.block_mask)):
                raise AssertionError(f"{label} request {i}: masks differ")
        print(f"  {label}: fused == looped bitwise, masks equal")

    none = {"smm": 0, "tiled_matmul": 0, "grouped_gemm": 0,
            "decode_attention": 0}
    out, looped = serve("(f) 16 dense, blocked", dense_reqs,
                        dict(none, smm=1), 1, densify=False)
    against_matmul("(f)", out, dense_reqs)
    bitwise("(f)", out, looped)
    del out, looped

    # (g): 8 dense and 8 with A at ~20 % block fill, block scales over two
    # decades so the norm filter has work to do
    sparse_reqs = []
    for _ in range(G // 2):
        am = rng.rand(nbb, nbb) < 0.2
        scale = np.repeat(np.repeat(10.0 ** (-2 * rng.rand(nbb, nbb)), BS, 0),
                          BS, 1)
        a = dense(NB) * torch.tensor(scale, dtype=torch.float32, device=dev)
        sparse_reqs.append((dbcsr.create(a, mesh=mesh, block_size=BS,
                                         block_mask=am),
                            dbcsr.create(dense(NB), mesh=mesh, block_size=BS)))
    mixed = dense_reqs[:G // 2] + sparse_reqs
    for eps in (None, 0.0):
        out, looped = serve(f"(g) 8 dense + 8 at 20 % fill, eps {eps}", mixed,
                            dict(none, smm=2), 2, filter_eps=eps,
                            densify=False)
        against_matmul(f"(g) eps {eps}", out, mixed)
        bitwise(f"(g) eps {eps}", out, looped)
        del out, looped
    # eps in a wide gap between two norm products near the median of the
    # sparse requests' present triples (as phase 2 places it)
    prods = []
    for a, b in sparse_reqs:
        p = (a.norms()[:, :, None] * b.norms()[None]).astype(np.float64)
        prods.append(p[np.broadcast_to(a.block_mask[:, :, None], p.shape)])
    srt = np.sort(np.concatenate(prods))
    mid = srt.size // 2
    gaps = srt[mid - 1000:mid + 1000] / srt[mid - 1001:mid + 999]
    i = mid - 1001 + int(np.argmax(gaps))
    eps = float(np.sqrt(srt[i] * srt[i + 1]))
    out, looped = serve(f"(g) eps {eps:.4g}", mixed, dict(none, smm=2), 2,
                        filter_eps=eps, densify=False)
    for j, (x, y) in enumerate(zip(out, looped)):
        if not np.array_equal(x.block_mask, y.block_mask):
            raise AssertionError(f"(g) eps request {j}: mask != per-request")
        rel = rel_err(x.data, y.data)
        if not rel <= REL_TOL:
            raise AssertionError(f"(g) eps request {j}: error {rel:.3e}")
    # the filter must have dropped products: the sparse requests then
    # differ from the unfiltered product by far more than rounding
    moved = min(rel_err(x.data, torch.matmul(a.data, b.data))
                for x, (a, b) in zip(out[G // 2:], sparse_reqs))
    if not moved > 100 * REL_TOL:
        raise AssertionError(f"(g) eps dropped nothing (error {moved:.3e})")
    print(f"  (g) eps: masks equal the per-request multiply's, data within "
          f"{REL_TOL:g} of it (bitwise: "
          f"{all(torch.equal(x.data, y.data) for x, y in zip(out, looped))}); "
          f"{int((srt < eps).sum())} of {srt.size} sparse triples below eps, "
          f"sparse products moved by >= {moved:.3e} of max|C|")
    del out, looped

    out, looped = serve("(h) 16 dense, densified, grouped_gemm", dense_reqs,
                        dict(none, grouped_gemm=1), 1, densify=True,
                        local_kernel="pallas")
    against_matmul("(h)", out, dense_reqs)
    bitwise("(h) grouped_gemm vs looped tiled_matmul", out, looped)
    del looped
    out, _ = serve("(i) 16 dense, densified, torch.bmm", dense_reqs, none, 1,
                   densify=True)
    against_matmul("(i)", out, dense_reqs)
    del out
    precision_check(f"(h) {G} x {NB}^2",
                    torch.stack([a.data for a, _ in dense_reqs]),
                    torch.stack([b.data for _, b in dense_reqs]), mesh,
                    zero_counters, read_counters, card)

    del dense_reqs, sparse_reqs, mixed, A, B, Am, A64, B64, exact
    torch.cuda.empty_cache()
    decode_rows[0].update(serve_lm(dev, zero_counters, read_counters,
                                   decode_attention, decode_attention_ref,
                                   hw))

    # ---------------------------------------------------------- phase 6
    mark(6)
    print("phase 6: the distributed schedules on simulated ranks "
          f"(dbcsr.multiply; {card})")
    torch.cuda.empty_cache()
    rows6 = distributed(dev, counters, zero_counters, read_counters, report)
    smm_rows += rows6["smm"]
    grouped_rows += rows6["grouped_gemm"]
    for key in ("smm", "grouped_gemm"):
        for row in rows6[key]:
            err_abs[key] = max(err_abs[key], row.pop("max_abs_err"))

    # ---------------------------------------------------------- phase 7
    mark(7)
    print(f"phase 7: the multiply planner ({card})")
    phase7 = planner(dev, card, zero_counters, read_counters)

    # ---------------------------------------------------------- phase 8
    mark(8)
    print(f"phase 8: purification and self-verifying multiplies ({card})")
    torch.cuda.empty_cache()
    rows, beside = robustness(dev, card, zero_counters, read_counters,
                              report)
    for key, n in beside.items():    # the phase's other processes' own
        launches[key] += n
    for row in rows:
        err_abs["smm"] = max(err_abs["smm"], row.pop("max_abs_err"))
        smm_rows.append(row)

    # ---------------------------------------------------------- phase 9
    mark(9)
    print(f"phase 9 (w): telemetry on the card ({card})")
    torch.cuda.empty_cache()
    obs_and_tensors(dev, card, zero_counters, read_counters)

    # ---------------------------------------------------------- phase 10
    mark(10)
    print(f"phase 10: the MLA, MoE, Mamba and RWKV-6 layer kinds at full "
          f"width ({card})")
    torch.cuda.empty_cache()
    layer_kinds(dev, card, zero_counters, read_counters, decode_attention,
                decode_attention_ref, hw)

    # ---------------------------------------------------------- phase 11
    mark(11)
    print(f"phase 11: training ({card})")
    torch.cuda.empty_cache()
    ab_costs = training(dev, card, zero_counters, read_counters,
                        hw)["ab_costs"]

    # ---------------------------------------------------------- phase 12
    mark(12)
    print(f"phase 12: the launch tools ({card})")
    torch.cuda.empty_cache()
    launch_tools(dev, card, hw, grid, grid_dir, ab_costs)

    # ---------------------------------------------------------- phase 13
    mark(13)
    print(f"phase 13: the process mesh, one rank a process; its 2x2 cases "
          f"run in phases 14-15's spawn ({card})")
    torch.cuda.empty_cache()
    process_mesh(card, PM_MESHES[1:])

    # ------------------------------------------------------ phases 14-15
    mark(14)
    print(f"phases 14-15: the LM on a process mesh; Mamba and RWKV-6 cut "
          f"over model, Adafactor on a cut, the count of one rank; first, "
          f"in the same 4 processes, phase 13's 2x2 cases ({card})")
    torch.cuda.empty_cache()
    lm = lm_on_mesh(dev, card, hw, mark, pm=pm_cases(4))
    for cell in lm["cells"]:
        # every process's own launches of the sharded decode
        launches["decode_attention"] += sum(cell["decode_attention_launches"])
    print(f"phase 13, 2x2 (run in phases 14-15's spawn; {card})")
    process_mesh(card, PM_MESHES[:1],
                 ran={PM_MESHES[0][0]: (lm["pm_ranks"], lm["wall_s"])})

    # ---------------------------------------------------------- phase 16
    mark(16)
    print(f"phase 16: the smm sweep and the H100 winners table on the main "
          f"path ({card})")
    torch.cuda.empty_cache()
    swept = sweep_phase(dev, card, zero_counters, read_counters)

    # ---------------------------------------------------------- phase 17
    mark(17)
    print(f"phase 17: the planner's constants fitted from this run's "
          f"timings ({card})")
    torch.cuda.empty_cache()
    fit_phase(dev, card, zero_counters, read_counters, {
        "dense_dot_ms": tiled_rows[0]["library_ms"],
        "smm": [{"block": p.block_m, "n_stacks": p.n_stacks,
                 "stack_tile": p.stack_tile, "n_entries": p.n_entries,
                 "ms": row["ms"]}
                for p, row in ((plan_a, smm_rows[0]), (plan_b, smm_rows[1]))],
        "sweep": swept["sweep"], "phase7": phase7})

    mark("end")
    for key, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {key}")
    kernels = []
    for kname, src, replaces, rows in (
            ("smm", "src/repro_torch/csrc/smm.cu",
             "src/repro/kernels/smm/smm.py:42", smm_rows),
            ("tiled_matmul", "src/repro_torch/csrc/tiled_matmul.cu",
             "src/repro/kernels/tiled_matmul/tiled_matmul.py:26", tiled_rows),
            ("grouped_gemm", "src/repro_torch/csrc/grouped_gemm.cu",
             "src/repro/kernels/grouped_gemm/grouped_gemm.py:27",
             grouped_rows),
            ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/decode_attention.py:30",
             decode_rows)):
        main = rows[0]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": err_abs[kname], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "by_shape": rows})
    kernels[-1]["max_abs_err_bf16_out"] = err_bf16_out
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
