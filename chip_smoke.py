#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
scipy; imports nothing of JAX or of the JAX package.  Phases:

1. print the card's name and power limit; build the four kernel sources from
   ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a, all in parallel);
2. hold each kernel against its plain torch version on the card, at the
   paper's Table 1 sizes (``cant``, ``ldoor`` at scale 1.0), with x from
   ``default_rng(0)``: SELL (slot-major, each chunk read to its width
   ``chunk_w``), the column-slab kernel (2 slabs), BCSR at
   all three block shapes and k in {1, 4, 16, 64}, at k in {3, 17, 100}
   on 8x8 blocks (N tiles masked past k), on (12, 8) and (8, 32) blocks
   at k = 3 and 64 (the generic path, for shapes the specialised paths do
   not take), and at k = 64 on (128, 128) blocks of a seeded random
   4096 x 4096 block matrix.  Tolerance per row
   i: |kernel - plain| <= 1e-5 * (|A| |x|)_i, because only the summation
   order differs.  The SELL, column-slab and BCSR kernels must also give
   the same bits on a second launch, and the csr/vector tier is checked
   bitwise repeatable on the card; (2b) ``op.aot()`` (a CUDA graph) of
   pinned ``sell/cuda``, ``sell_blocked/cuda`` and ``bcsr/cuda`` (k = 64) on
   cant equals ``op @ x`` bit for bit on two calls and leaves the first
   result alone, with the wall time per call of both;
3. the tuned main path: ``SparseOperator.build`` on cant for SpMV and k=16
   (fresh plan cache), an ldoor SpMV search over a cut candidate list, and
   pinned column-slab operators on cant and ldoor; every result against a
   scipy float64 oracle;
4. serving on cant: a tuned ``SparseEngine`` answers 64 requests (the
   search behind each of its buckets is printed); an engine pinned to
   sell/cuda (k=1) and bcsr/cuda (k>1) answers 64 more, async equal to
   ``async_depth=0`` bit for bit; ``repro_torch.launch.serve --sparse cant
   --scale 1.0`` serves 64 more from the plan cache; every kernel's launch
   count over phases 3-4 must be > 0.  The engines' dense buckets run as
   CUDA graphs: an engine with ``captured=False`` on the pinned plans must
   serve the same bits, each bucket's graph must equal its eager closure,
   the buckets' graphs must share the engine's pool, whose allocator bytes
   are printed per engine, and the host time of one dispatch per bucket,
   graphed and eager; then the wide bucket (k = 64) of cant (bcsr/cuda)
   and ldoor (csr/vector), graphed against ``captured=False`` in turns:
   req/s through the serve CLI's loop (``serve.offer``) and the device ms
   of one batch, the results bit for bit equal;
5. times per kernel (CUDA events, median of 25 single launches, L2
   flushed before each): kernel, plain version, one cuSPARSE call through
   ``torch.sparse_csr_tensor`` (``library_ms``), and the bound of the
   function itself (see ``bound``).
   BCSR rows (three block shapes x k in {1, 4, 16, 64}, and (128, 128) at
   k = 64) add ``format_floor_ms``, the least time for the work the format
   stores: the larger of its bytes over 3.35 TB/s and its flops over 67
   TFLOP/s.  SELL and column-slab rows add ``read_bytes``, the bytes left
   to read once each chunk stops at its width ``chunk_w``;
6. sparse right-hand sides (SpMSpV) on the power-law graphs webbase-1M and
   torso1 at scale 1.0, x sorted unique indices from ``default_rng``:
   the SpMSpV kernel (its passes ``SCATTER_PASSES``: offsets, count, scan,
   place, sum) against its plain version (expansion + ``index_add_``,
   stream-ordered) on a CPU copy of the same operands and against its
   plain version on the card (a sort by row, one ``index_add_`` a rank),
   bit for bit and the same bits on a second launch, and against float64
   at 1e-5 (|A| |x|)_i, at all four engine buckets on webbase-1M, at
   nnz(x) = n/256 and n/4 on torso1 and on a constructed operand whose 16
   hub rows share one row tile (its kernel ms recorded); then, with the launch counts
   set to 0, ``SparseOperator.build(webbase, x_nnz=B)`` at the four
   default buckets, a pinned ``spmspv/cuda`` operator, a tuned
   ``SparseEngine`` answering 65 ``submit_sparse`` requests (one thicker
   than n/4, which goes to the dense k=1 lane), engines on the tuned
   plans and engines whose sparse lane is pinned to ``spmspv/cuda``, each
   at ``async_depth`` 2 and 0, all against a scipy float64 oracle; the
   pinned lane must run no eager expansion (counted), each lane at
   ``async_depth`` 2 must give the bits it gives at 0 on all 65 requests,
   and ``torch.profiler`` lists the device work of one pinned request: the
   kernel's passes once each and one host-to-device copy; last the
   kernel's times at every checked bucket beside its plain version,
   ``index_add_`` on the
   pre-expanded stream (the library call), one cuSPARSE ``torch.mv`` on the
   densified x, a whole ``apply_sparse`` (on the host clock, and split into
   validate + pad, the copy, launch + run) and the bound 8*T + 16*B + 4*m
   bytes, and at nnz(x) = n/4 on each graph the device time of each pass
   (``torch.profiler``).  The engines'
   answers against float64: a row that breaks 1e-5 * (|A| |x|)_i is
   printed with its term count k_i and held to k_i * 2**-24 * (|A| |x|)_i
   instead;
7. the remaining serving tiers, reordering, supervision and overload:
   (a) ``merge/scan[chunk=2048|16384]`` at k = 1 on cant, ldoor and
   webbase-1M and at k = 4 on cant, and ``csr/scalar`` on cant, pinned,
   against the float64 oracle (scalar at 1e-5; merge at 1e-5 (|A| |x|)_i
   + 8 * 2**-24 * max|P|, a row being a difference of global prefix sums),
   each timed; (b) cant scrambled by ``random_order(seed=0)``: pinned
   ``sell/cuda`` with and without ``reorder=rcm`` at 1e-5, bandwidth and
   UCLD before and after RCM, their times and the SELL kernel's alone, and
   ``build(include_reorder=True)``; (c) the tuned engine of phase 4 under
   ``nan_guard`` and a fault plan (dispatch faults exhaust bucket 1's
   retries, NaN poisons bucket 64): 256 requests at 1e-5, the events run
   batch_failed -> demote -> promote per faulted bucket, the tuned plans
   and kernels serve again after promotion, and a real refused launch
   (BCSR blocks off their 16-byte boundary) fails its batch's futures with
   no retry and no demotion, and a faulted sparse bucket on webbase-1M
   (pinned ``spmspv/cuda``) whose repair probe must run the SpMSpV
   kernel's passes once each before its promotion; (d) ``max_queue`` under each
   policy with ``shed_after_s``, a ``BrownoutController`` and an
   ``engine.overload`` delay: every future resolves (served at 1e-5, or a
   typed ``OverloadError``), the widest bucket serves through
   ``bcsr/cuda``; (e) the serve CLI with ``--max-queue 64
   --overload-policy shed-oldest --brownout``.  The engines of phases 4,
   6b and 7d, into which no failure is injected, must record no failed
   batch and no demotion;
8. the iterative solvers (``runtime.solver``) on ``spd_shift(cant)`` and
   ``spd_shift(ldoor)`` at scale 1.0: a tuned ``SparseSolver`` on cant
   runs CG (tol 1e-5), Lanczos (64 steps) and block power (k = 8, tol
   1e-4, 100 iterations), a second one pinned to ``bcsr/cuda`` runs block
   power again, and one pinned to ``sell/cuda`` runs CG on ldoor.  Their
   plans are built first, and each kernel they run is held against its
   plain version on the solver's own prepared operand at its width
   (phase 2's row tolerance); then the launch counts are set to 0 and the
   solves run.  CG's float64 relative residual (scipy, on the host) must
   be <= 1e-4; the largest Ritz value must lie within 1e-3 (relative) of
   ``eigsh(which="LA")``; every block-power theta, index by index, within
   1e-4 of lambda_1 of the same iteration run in float64 from the same
   start, theta_1 within 1e-3 of eigsh's lambda_1, and the thetas under
   the Ky Fan bound of eigsh's top 8; the
   blocks run as CUDA graphs and each solve equals the same solve with
   eager blocks (``captured=False``: count, flag and reads, x or V bit for
   bit); the device-decided loop and the host loop (``cg_host_loop``,
   ``block_power_host_loop``) on the same plan must give the same count and
   flag, x within 1e-6 and theta within 1e-5, also for a CG whose tol is
   met inside a block (iteration 5 of the block 4-7); SELL and BCSR must
   both launch; the unfaulted solvers record no event.  Then ms per iteration
   at a fixed budget (tol < 0, 128 iterations; best of 5, fused and host
   loop in turns, now graphed blocks, eager blocks and the host loop) with
   the synchronising calls torch counts, each CG's wall time to tol 1e-5
   against the eager blocks' and the host loop's, an injected ``solver.dispatch`` fault (retry ->
   demote) and a plan that really refuses its launch (``cg()`` raises,
   no retry).  Each kernel row gains ``solver_launches``;
9. the fleet (``runtime.fleet.SparseFleet``) at scale 1.0 over cant, hood,
   pwtk (banded FEM), scircuit and webbase-1M (power-law), on a copy of
   phase 4's plan cache, launches counted from 9a to 9f: (a) admission
   on predicted plans under a
   900 MiB budget that evicts: per tenant and bucket where the plan came
   from, the prediction's distance, the plan, the accuracy check's time
   and the candidates passed over; no predicted plan was measured, none
   on webbase-1M is merge; (b) 64 requests to each tenant but scircuit (1 alone, 63
   interleaved), max_wait 1 ms, each within 1e-5 of scipy float64,
   ``sell_spmv`` and ``bcsr_spmm`` both launched, zero supervisor events,
   and each tenant's first-request latency (its k = 1 capture included);
   (c) webbase-1M retuned on the worker's own stream while 4 requests of
   it a round are served: latency p50/p99 during and after,
   ``swaps_applied >= 1``, every retuned closure a CUDA graph captured by
   the worker, every batch dispatched before the swap (through the old
   table's graphs) equal bit for bit to the old plans' eager closures on
   the same operands, the
   retuned plans and medians; (d) with the budget
   full, the zero-traffic scircuit is evicted first and the allocator
   frees >= 90 % of its prepared bytes (slab and graph-pool bytes the
   budget does not count printed per tenant); webbase-1M, evicted, reactivates from the
   cache in every bucket with no search; (e) a second fleet: an injected
   ``engine.dispatch`` storm on cant opens its breaker after 3 batches
   (``CircuitOpenError`` after), webbase-1M beside it resolves within 1e-5 with
   no event, scircuit at rate 5/s burst 2 is refused typed and counted;
   (f) ``serve --fleet cant,webbase-1M --scale 1.0 --requests 64`` serves
   all 128.  Each kernel row gains ``fleet_launches``;
10. row-partitioned and mesh serving (``core.distributed``) on cant at scale
   1.0 with P = 4 shards (``make_spmm_mesh(4)``: on one card all four share
   it): (a) both schedules' operands (host partition time, stored entries,
   bytes on the card), a product of each schedule and of ``stacked_spmm``
   at k in {1, 4, 16, 64} against scipy float64 at 1e-5 and bit for bit on
   a second run, the psum dot against float64; (b) launches counted from
   here to (e): a mesh ``SparseEngine`` on a fresh plan cache (both
   schedules timed per bucket) answers 64 requests, async equal to
   ``async_depth=0`` bit for bit on a second engine that is a full cache
   hit; a single-device engine on that cache does not see the mesh plans;
   an ``n_shards=4`` engine answers 64 more; no supervisor event; (c) an
   injected dispatch fault demotes bucket 16 to ``csr/vector`` on the
   first device, results hold 1e-5, the repair re-promotes the schedule,
   ``submit_sparse`` raises; (d) CG over the mesh on spd_shift(cant) to
   tol 1e-5: float64 residual <= 1e-4 and the single-device solve's
   iteration count; (e) ``serve --mesh-shards 4`` and ``--shards 4``, 64
   requests each; (f) times (median of 25, L2 flushed) per product of
   allgather, ring and stacked at k = 1 and 64 beside the tuned
   single-device plan and ``csr/vector``, and the ring with every cell's
   padding gathered and multiplied (as the JAX package's ``local_spmm``
   streams it), with the device operations per product that
   ``torch.profiler`` lists in a fresh process (``--mesh-device-ops``);
   then, while the phase is under 45 s, one ldoor
   product per schedule.  Each kernel row gains ``mesh_launches`` (no
   kernel is on this path: the shards run the plain row sum);
11. LM serving (``models.lm``, ``runtime.server``) of qwen1.5-4b at full
   width and depth (40 layers) in bf16, weights from seed 0 on the card:
   (a) ``serve --arch qwen1.5-4b --requests 8 --slots 4 --prompt-len 32
   --max-new 16 --max-seq 128`` serves 8/8 with no BCSR launch (dense
   FFN), and so does ``--arch h2o-danube-3-4b`` (24 layers, GQA); (b) the
   bcsr-FFN variant (``SparseFFNConfig(kind="bcsr")``: (128, 128) blocks,
   density 0.25, impl ``cuda``): layer 0's W1 and W2 through
   ``bcsr_spmm_bf16`` (its tensor-core kernel) against the plain version
   at k in {1, 3, 4, 17, 32, 100, 128, 512}, at 1e-5 (|A| |x|)_i (a row
   that breaks it is printed with its term count k_i) and the same bits on
   a second launch; (c) with the launch counts set to 0, a 4-slot
   ``BatchedServer`` serves 8 requests (prompt 32, max_new 16) through its
   CUDA graphs (decode, and prefill at 32 tokens): ``bcsr_spmm_bf16`` and
   ``bcsr_spmm_bf16_mma`` must each launch 2 x 40 x (prefills + decode
   steps + warm-ups) times (each replay counts its captured launches, each
   of the two warm-up passes before a capture its own; every launch on the
   tensor cores) and nothing else; (g) prefill ms (32 tokens) and decode
   step ms (4 slots) of the dense and the bcsr model, each through a
   server's own path (a ``captured=False`` server's eager passes, a
   default server's graphs after their pinned copies), beside the decode
   step's bound (weight bytes over 3.35 TB/s), ``torch.profiler``'s device
   busy time, idle share and kernel count of one eager and one graphed
   bcsr decode step of those servers (in a fresh process,
   ``--lm-profile``), and the kernel per weight at k = 4, 32, 128 and
   512 (L2 flushed) beside its plain version, a dense bf16 matmul of the
   densified weight (``library_ms``) and its bound (bf16 blocks and X
   read, float32 Y written, over 3.35 TB/s, against 2 nnz k over 989
   TFLOP/s) and the same launch on an empty matrix of the same shapes
   (``empty_ms``: the launch and a zero Y, the floor of this timing);
   then W1 cut into (128, 8) blocks, which take the CUDA-core
   kernel, checked the same way and timed at k = 4 and 32 (not on the
   main path, so not in the kernel table); (f) ``impl="auto"``: the two
   searches at k = 4 on a scratch plan cache, each weight's plan and impl,
   the 8 requests again; (d) a float32 copy of the bcsr model (TF32 off):
   prefill + 15 decode steps equal ``forward`` at every position within
   1e-3 max|logits|, and so do a 1-slot server's 16 graphed decode steps;
   its 4-slot server gives each request the tokens of a 1-slot server; (e) the bf16 first-token logits of the 8 prompts
   against the float32 copy's (largest deviation within ``LM_BF16_LIMIT``
   x max|logits|; the share of equal first tokens).  Each kernel row gains
   ``lm_launches``; the ``bcsr_spmm_bf16`` rows carry (b)'s error and (g)'s
   times.

12. MoE and RWKV-6 serving (``models.moe``, ``models.rwkv6``; plain torch on
   the serving path, as the JAX package writes them in ``jnp``), weights
   from seed 0 on the card, each model freed before the next, each
   sub-phase's wall time and allocator peak printed: (a) granite-moe-1b-a400m
   in bf16 at full width and depth (24 layers, 32 experts top-8): ``serve
   --arch`` and a 4-slot ``BatchedServer`` serve 8/8 (prompt 32, max_new
   16) through the decode graph and one prefill graph with no kernel
   launched, every token below ``vocab``; prefill and decode step ms,
   eager and graphed, against the step's bytes bound (every weight a step
   reads: at one token a row every expert runs), tok/s; (c) the combine
   through kernel 4: layer 0's experts in float32, x of 4 rows x 32 tokens,
   ``moe_apply_spmspv(impl="cuda")`` at capacity_factor E / top_k (nothing
   drops) against ``moe_apply_dense_ref`` and at 1.25 against
   ``moe_apply``, each output within 1e-5 (|A| |x|)_i of the products
   behind it (``moe._combine_scale``: A the experts' wo, x the gate-weighted
   h and, to first order, what the gate and up products' reordering can
   move it by), and bit for bit equal to the same combine
   (``moe_combine_spmspv``) of the same operands through the plain version
   on the CPU, with exactly ``SCATTER_LAUNCHES`` (5) ``spmspv_scatter``
   launches per token that keeps a slot (one ``apply_sparse`` call each
   where nothing drops); (b) a float32 copy (TF32
   off) at capacity_factor E / top_k: prefill + 15 decode steps equal
   ``forward`` within 1e-3 max|logits|, one replay of a 4-slot server's
   decode graph equals eager ``decode_step`` bit for bit (logits and
   state), 4-slot tokens equal 1-slot tokens; (f) bf16 first-token logits
   against the float32 copy's, at full depth (reported) and over the first
   ``BF16_CHECK_LAYERS`` layers (held): each prompt's deviation (held to
   ``LM_BF16_LIMIT`` where its routing agrees, reported where it does
   not), the share of (token, layer) routing decisions that pick the same
   experts, and the float32 copy on the bf16 model's routing (held on
   every prompt; these random inits amplify bf16 rounding with depth, in
   the JAX package too, so full depth is reported only);
   (d) llama4-scout-17b-a16e at full width, cut to ``SCOUT_LAYERS`` of 48
   layers in this script (reckoned before it is built): the server and
   the times as in (a); (e) rwkv6-7b in bf16 at full width
   and depth (32 layers): as (a), then its float32 copy at full depth as in
   (b) (decode against forward, graph against eager) and (f); last, one
   eager and one graphed decode step of granite and rwkv6 under
   ``torch.profiler`` in a fresh process (device busy time, idle share,
   kernel count).  Each kernel row gains ``moe_launches`` (c's counts).

13. Hybrid serving (``models.mamba2`` and the hybrid branch of ``models.lm``;
   plain torch but for the shared FFN's kernel), zamba2-2.7b in bf16 at full
   width and depth (54 Mamba-2 layers in 9 super-blocks, each one
   application of the shared attention block with its LoRA), weights from
   seed 0 made live by ``perturb_hybrid`` (at init the Mamba-2 layers are
   the identity and the LoRA zero, in the JAX package too: ROADMAP C.23):
   (a) ``serve --arch zamba2-2.7b`` serves 8/8 through 2 graphs with no
   kernel launched; (b) a 4-slot ``BatchedServer``, dense shared FFN, as
   phase 12a, with the step's bound two ways (``hybrid_bounds``: the shared
   block charged once or at each application, the float32 Mamba-2 state
   read and written); (e) bf16 first-token logits against the float32 copy
   over the first super-block (held to ``LM_BF16_LIMIT``) and at full
   depth (reported); (d) the float32 copy, TF32 off: decode against
   ``forward`` within 1e-3 max|logits| and one graphed step against its
   eager twin bit for bit; (c) the bcsr shared FFN ((128, 128) blocks):
   W1 and W2 through ``bcsr_spmm_bf16`` at k = 4 and 32 against the plain
   version (1e-5 (|A| |x|)_i, the same bits on a second launch), the
   4-slot server with both counters held to 2 x 9 x (prefills + steps +
   warm-ups), the kernel timed at both widths as phase 11g times it, and
   (d) on its float32 copy; last, one eager and one graphed decode step of
   each variant under ``torch.profiler`` in a fresh process; (f) the
   phase's wall time.  Each kernel row gains ``hybrid_launches`` (c's
   counts), and the table gains the kernel's rows at the shared FFN's
   shapes.

14. Audio and VLM serving (the audio and vlm branches of ``models.lm``;
   plain torch but for the bcsr FFN's kernel), in bf16, weights from seed
   0, every request carrying its own seeded modality inputs
   (``repro_torch.data.modality``, drawn as ``serve --arch`` draws them),
   each sub-phase's wall time and allocator peak printed: (a) whisper-tiny
   at full width and depth (4 encoder + 4 decoder layers, d 384, 1500
   frames): ``serve --arch whisper-tiny`` and a 4-slot ``BatchedServer``
   serve 8/8 (a 4-token prompt and 1500 frames each, 32 new tokens)
   through the decode graph and one prefill graph with no kernel launched;
   prefill and decode step ms, eager and graphed, beside the bytes bound
   (``av_bounds``: the decode step reads the decoder's weights and the
   cross keys and values, not the encoder), tok/s; (b) qwen2-vl-72b at full
   width, cut to ``vl_layers`` of its 80 layers (the depth whose bf16
   weights fit ``VL_WEIGHT_BUDGET``, reckoned before it is built): the
   same with prompts of 256 vision slots + 32 text tokens at
   Qwen2-VL-layout M-RoPE positions, 16 new tokens, max_seq 320, and the
   CLI on the reduced config; (c) a float32 copy (TF32 off; qwen2-vl's at
   ``BF16_CHECK_LAYERS``): prefill + the new tokens' decode steps equal
   ``forward`` within 1e-3 max|logits| (a VLM's forward at the positions
   decode gives them), one decode-graph replay equals eager
   ``decode_step`` and the prefill graph's replay of the fourth request
   equals eager ``prefill`` on it, bit for bit; (d) bf16 first-token logits
   against the float32 copy within ``LM_BF16_LIMIT`` (whisper at full
   depth, qwen2-vl at ``BF16_CHECK_LAYERS``); (e) the bcsr variants
   ((128, 128) blocks): kernel 3 on W1 and W2 at k = 4 and 1500 (whisper's
   decode and encoder) and k = 4 and 288 (qwen2-vl's decode and prefill)
   against its plain version (1e-5 (|A| |x|)_i, the same bits on a second
   launch), the 4-slot servers with both counters held to 2 x (4 + 4) a
   whisper prefill and 2 x 4 a decode step, 2 x ``vl_layers`` a qwen2-vl
   pass (each warm-up as its pass), the kernel timed as phase 11g times it,
   and whisper's bcsr float32 copy as in (c); last, one eager and one
   graphed decode step of each model under ``torch.profiler`` in a fresh
   process; (f) the phase's wall time.  Each kernel row gains
   ``av_launches`` ((e)'s counts), and the table gains the kernel's rows
   at these shapes.

15. Training (``runtime.trainer``, ``optim``, ``checkpoint``,
   ``launch.train``; plain torch: the path launches no kernel), in a fresh
   process after this one frees its cached blocks, TF32 off: (a)
   qwen1.5-4b in bf16 at full width and depth, 6 ``make_train_step`` steps
   of 8 x 128 ``MarkovTokens`` with AdamW as the train CLI builds it (lr
   3e-4, float32 moments): the bytes reckoned before the run (bf16
   parameters and gradients, float32 m and v, each float32 copy of the
   logits) beside the allocator's peak, step 0's ce within 1.5 of
   log(vocab), every metric finite, grad_norm > 0, every parameter's shape
   and dtype kept, the embedding's step-0 rows and every projection
   changed (norm gains counted, not held), the step ms (median of steps
   2-6, the host read of the metrics included), tokens/s, MFU (6 N T over
   989 TFLOP/s) and, under ``torch.profiler``, one more step's forward and
   backward and its AdamW update (busy time, idle share, kernels); (b) at
   2 layers, full width: float32 loss within 1e-5 relative of a float64
   copy's (the same weights) and each gradient leaf within 1e-4 max|g64|,
   bf16 reported; (c) float32, 2 layers, lr 1e-3: n_micro = 2 against 1,
   loss within 1e-4, parameters within 2e-5; (d) one step of every
   ARCH_ID's reduced config (the hybrid perturbed): finite, grad_norm > 0,
   shapes and dtypes kept; (e) ``train_loop`` on a 2-layer d 64 model:
   a fault at step 15 of 30 (checkpoints every 10) gives the reference's
   step list and each step's loss within 1e-5 relative of an uninterrupted
   run's, learning on the Markov chain (the loss falls by 1.0 and below
   log 64 - 1 in 50 steps) and with the structured sparse FFN (by 0.8 in
   40), ``python -m repro_torch.launch.train --reduced --steps 20`` in a
   fresh process, a bf16 checkpoint restored bit for bit; (f) a 2-layer
   qwen1.5-4b-shaped bcsr model: at ``impl="cuda"`` its backward raises
   ``NotImplementedError``, at ``"ref"`` it trains (every FFN block's
   gradient nonzero), each of the four kernel wrappers refuses an operand
   that requires grad; no kernel launched in the whole phase.  Each kernel
   row gains ``train_launches`` (0).  Rehearse on the CPU with
   ``train_phase(torch.device("cpu"), {}, reduced=True)``.

16. The sharded train step on an LM mesh, in a fresh process (its own
   docstring, ``mesh_train_phase``).

17. The dry-run tools (``launch.op_analysis``, ``launch.dryrun``,
   ``launch.roofline``, ``core.traffic``; plain torch, no kernel) against
   the card, in a fresh process: (a) qwen1.5-4b's train step at full width
   and ``DRY_TRAIN_LAYERS`` (20) of its 40 layers (15a's cell cut in depth
   for the script's time limit: 8 x 128, AdamW with float32 moments, one
   device)
   analysed on meta and run on the card under ``torch.profiler``
   (``with_flops``): the analyzer's matmul FLOPs within 0.1 % of the
   profiler's FLOPs of the ``aten::mm``, ``addmm``, ``bmm`` and ``baddbmm``
   calls that launched a kernel (``matmul_flops_of``); its
   FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s each at most the
   step's device-busy time; ``argument_size`` within 1 % of the allocator's
   bytes once the state is built, ``temp_size`` within 15 % of the step's
   allocator peak less them; the op count beside the profiler's kernels,
   the update's bytes beside the ≈ 630 GB 15a's kernels moved, the three
   roofline terms beside the measured step; (b) its dense bf16 decode step
   at ``LM_SLOTS`` slots: the FLOPs held against an eager step's profile,
   the bounds against the graphed step's busy time, the bytes at least the
   weights a step reads (all but the embedding table: 7.124 GB); (c) the
   production cells qwen1.5-4b train_4k and llama3-405b decode_32k on
   ``make_production_mesh()`` (meta), their records and seconds; (d) the
   paper's Fig 6 figures for cant at scale 1.0.  Each
   kernel row gains ``dryrun_launches`` (0).  Rehearse on the CPU with
   ``dryrun_phase(torch.device("cpu"), {}, reduced=True)``.

18. The public surface and the examples' twins (``examples/*_torch.py``),
   in a fresh process that runs right after phase 16's, while the parent
   holds no tensor (llama3-405b's check peaks near 61 GB), each twin's ``main`` on the card, launches counted
   over the twins' runs and (f)'s serving runs: (a) quickstart: kernels 1
   and 3 launched, the SELL product and the float32 BCSR product ((8, 16)
   blocks, k = 16) within 1e-5 (|A| |x|)_i of their plain versions and of
   a float64 oracle, so are the plain tier's, the tuned operator's (a
   plan-cache hit) and the engine's 9 futures (no supervisor event);
   (b) serve_decode: the 1-slot
   tokens equal the 4- and 8-slot tokens, tok/s, the engine's 32 futures
   at 1e-5; (c) sparse_eigensolver at full size: its own 5 % assertion,
   then block power run on to 500 iterations, the largest Ritz value
   within 1e-3 of ``eigsh(which="LA")``; (d) ``train_lm --big --steps
   300`` with its depth cut to 2 layers, then whole (88 M parameters):
   every loss finite, the last 20 losses' mean below log(vocab), not below
   the chain's entropy floor less 0.05, and below the first 5's by 1 nat
   (the cut) or ``EX_LEARN_NATS`` (12 layers; the JAX package's drops at
   both depths, ``tests/witness_train_lm.py``), step ms, tokens/s and the
   allocator peak; the cut run resumed from its step-250 checkpoint, whose
   losses equal its first run's within 1e-5; (e) ``train_lm --sparse --steps
   20``: finite and falling; (f) deepseek-67b and llama3-405b at full
   width and the depth ``vl_layers`` reckons (32 of 95 and 6 of 126), each
   freed before the next: ``serve --arch --reduced``, a 4-slot server of
   the dense model (8/8 through its graphs, no launch) with its step
   times beside the bound (``av_bounds``), bf16 first-token logits against
   float32 blocks streamed one at a time at the served depth (reported),
   then, at ``BF16_CHECK_LAYERS`` (the first layers built afresh from seed
   0), bf16 against a float32 copy (held to ``LM_BF16_LIMIT``), decode
   against ``forward`` at 1e-3 and a graphed step against eager bit for
   bit; the bcsr variant ((128, 128) blocks, density 0.25): kernel 3 in
   bf16 on W1 and W2 at k = 4 and 32 against its plain version, a 4-slot
   server with both counters at 2 x layers a pass, the kernel timed beside
   a dense matmul and its bound; after each model is freed the allocator
   must be back within 1 % of its bytes before it was built (ROADMAP
   C.31; the largest live blocks printed with their stacks where not:
   allocation stacks are recorded over 18f except while it times).
   Each kernel row gains ``examples_launches``, and the table gains
   kernel 3's rows at the two models' FFN shapes.
   Rehearse on the CPU with ``examples_phase(torch.device("cpu"), {},
   reduced=True)``; alone: ``python3 chip_smoke.py --examples-phase
   OUT.json``.

Any failed check exits non-zero.  The last lines are the card's name and
power limit, one JSON object with the kernel table, and the JSON status
line.  The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-5  # relative to (|A| |x|)_i: only the summation order differs
REPS = 25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
K_BUCKETS = (1, 4, 16, 64)
WIDE_REQUESTS = {"cant": 2048, "ldoor": 512}  # phase 4's wide-bucket turns
WIDE_TURNS = 3  # graphed and eager turns each, alternating
MERGE_ULPS = 8  # the merge tier's limit: 1e-5 (|A| |x|)_i + 8 * 2**-24 * max|P|


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def hub_tile_operand():
    """Phase 6a's constructed operand whose hub rows share one row tile more
    than torso1's do: 16 consecutive rows each hold a product in 20 000 of
    the touched columns (torso1's hub row at n/4 holds 4 162), so the
    tile's bucket (320 000+) sorts in global scratch and 16 threads each
    add one hub row.  Returns the CSR matrix, its scipy copy, the sparse x
    (idx, val) and the hub rows; the same from seed 61 every run."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.formats import CSRMatrix

    rng = np.random.default_rng(61)
    m, n, hub_cols = 400_000, 200_000, 20_000
    cols = rng.choice(n, size=hub_cols, replace=False)
    hub_rows = 200_000 + np.arange(16)
    r = np.concatenate([rng.integers(0, m, 800_000), np.repeat(hub_rows, hub_cols)])
    c = np.concatenate([rng.integers(0, n, 800_000), np.tile(cols, hub_rows.size)])
    H = sp.csr_matrix((rng.standard_normal(r.size).astype(np.float32), (r, c)),
                      shape=(m, n))
    H.sum_duplicates()
    H.sort_indices()
    g = CSRMatrix((m, n), H.indptr.astype(np.int32), H.indices.astype(np.int32),
                  H.data.astype(np.float32))
    idx = np.union1d(cols, rng.choice(n, size=30_000, replace=False)).astype(np.int64)
    val = rng.standard_normal(idx.size).astype(np.float32)
    return g, H, idx, val, hub_rows


def spmspv_pass_ms(fn, flush, reps: int = REPS) -> dict:
    """Kernel 4's median device ms by pass over ``reps`` calls of fn(), the
    L2 flushed before each, from the profiler's kernel records (every
    kernel named ``spmspv_scatter_<pass>``, so any version of the kernel),
    plus their sum as ``"total"``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # a measurement, not the path: record it
        return {"profiler failed": repr(e)}
    by_pass: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spmspv_scatter_" in e.name:
            key = e.name.split("spmspv_scatter_")[1].split("<")[0].split("(")[0]
            by_pass.setdefault(key, []).append(e.device_time / 1e3)
    out = {k: float(np.median(v)) for k, v in by_pass.items()}
    if out:
        out["total"] = float(sum(out.values()))
    for _ in range(2000):  # bring the clocks back up after the profiler's pause
        flush.zero_()
    torch.cuda.synchronize()
    return out


FLEET_TENANTS = ("cant", "hood", "pwtk", "scircuit", "webbase-1M")
# Retuned in 9c: the power-law tenant.  A banded one (hood) beside it
# roughly doubles phase 9's time on the card (PERF.md §4), so it is left out.
FLEET_RETUNED = ("webbase-1M",)
FLEET_ZERO_TRAFFIC = "scircuit"  # admitted, never served until 9e: 9d's victim
FLEET_ADMIT_BUDGET = 900 * 2**20  # about three of the five tenants' prepared bytes
FLEET_SERVE_BUDGET = 4 * 2**30  # 9b-9d: every tenant resident at once


def fleet_phase(dev, scale: float, plans_text: str, record: dict,
                admit_budget: int = FLEET_ADMIT_BUDGET) -> dict:
    """Phase 9: ``SparseFleet`` over five suite matrices at ``scale``.

    Returns the kernel launches of the fleet's path.  Runs on the CPU too (``dev`` cpu, small ``scale``
    and ``admit_budget``), where the launch and allocator checks are
    skipped: that is its rehearsal."""
    import gc

    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.data.suite import generate
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime.engine import CAPTURE_MAX_OUTPUT_BYTES, SparseEngine
    from repro_torch.runtime.executable import pool_bytes
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.fleet import CircuitOpenError, SparseFleet
    from repro_torch.runtime.overload import OverloadError
    from repro_torch.tune import PlanCache, SparseOperator
    from repro_torch.tune import plan as tplan

    on_card = dev.type == "cuda"
    rec = record["fleet"] = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    cache_path = Path(tmp.name) / "plans.json"
    cache_path.write_text(plans_text)  # phase 4's plan cache: cant is an exact hit
    cache = PlanCache(cache_path)
    t_gen = time.perf_counter()
    mats = {n: generate(n, scale=scale) for n in FLEET_TENANTS}
    A64 = {n: sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                            shape=a.shape) for n, a in mats.items()}
    absA = {n: abs(A) for n, A in A64.items()}
    print(f"  generated {', '.join(f'{n} {a.shape[0]}x{a.shape[1]} nnz={a.nnz}' for n, a in mats.items())} "
          f"in {time.perf_counter() - t_gen:.1f}s", flush=True)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def check_cols(label: str, name: str, ys, xs_host) -> float:
        """Every column within 1e-5 (|A| |x|)_i of scipy float64."""
        X = np.stack(xs_host, axis=1).astype(np.float64)
        Y = np.stack([y.cpu().numpy() for y in ys], axis=1).astype(np.float64)
        ref, lim = A64[name] @ X, TOL * (absA[name] @ np.abs(X))
        err = np.abs(Y - ref)
        bad = ~(err <= lim)
        if Y.shape != ref.shape or bad.any():
            fail(f"{label}: {int(bad.sum())} entries off 1e-5 (|A||x|)_i, worst "
                 f"{float(np.max(err - lim)):.3e} over the limit")
        m = float(err.max())
        print(f"  ok {label}: {len(ys)} results, max_abs_err {m:.3e}")
        return m

    def unfaulted(label: str, eng) -> None:
        ev = [(e.kind, e.info) for e in eng.supervisor.events]
        if ev or eng.stats.demotions or eng.stats.failed_requests:
            fail(f"{label}: supervisor events {ev}, demotions {eng.stats.demotions}, "
                 f"failed {eng.stats.failed_requests}")

    def serve(fl, reqs) -> None:
        while not all(r.done for r in reqs):
            if fl.step() == 0:
                fl.flush()

    # -- 9a: admission on predicted plans --------------------------------
    t0 = time.perf_counter()
    print("phase 9a: fleet admission (plan cache, transfer, byte model), "
          f"budget {admit_budget / 2**20:.1f} MiB", flush=True)
    _build.reset_launches()
    fleet = SparseFleet(cache=cache, budget_bytes=admit_budget, max_wait_s=1e-3,
                        retune=False, device=dev)
    adm = rec["admission"] = {}
    for name in FLEET_TENANTS:
        t1 = time.perf_counter()
        t = fleet.add_tenant(name, mats[name], retune=False)
        sync()
        row = adm[name] = {"admit_s": time.perf_counter() - t1, "nbytes": t.nbytes,
                           "buckets": {}}
        for k, op in t.engine.ops.items():
            pred = op.predicted
            b = row["buckets"][k] = {
                "from": t.admitted_from[k], "plan": op.plan.candidate.key(),
                "distance": None if pred is None else pred.distance,
                "check_ms": op.check_s * 1e3,
                "passed_over": {c: repr(e) for c, e in op.search_failures.items()},
            }
            if not op.from_cache and op.plan.n_measured != 0:
                fail(f"{name} k={k}: a predicted plan was measured ({op.plan})")
            if name == "webbase-1M" and op.plan.fmt == "merge":
                fail(f"webbase-1M k={k} serves merge: {op.plan.candidate.key()}")
            dist = "-" if b["distance"] is None else f"{b['distance']:.3f}"
            print(f"  {name} k={k}: from {b['from']} (distance {dist}) plan {b['plan']}, "
                  f"accuracy check {b['check_ms']:.1f} ms")
            for c, e in op.search_failures.items():
                print(f"    passed over {c}: {e!r}"[:300])
        print(f"  {name}: admitted in {row['admit_s']:.2f}s, {t.nbytes / 1e6:.1f} MB "
              f"prepared; resident {[n for n, t_ in fleet.tenants.items() if t_.resident]}",
              flush=True)
    s_ = fleet.stats().summary()
    rec["admission_stats"] = {k: s_[k] for k in (
        "admissions", "cache_admissions", "predicted_admissions", "transferred_buckets",
        "byte_model_buckets", "evictions", "bytes_evicted")}
    print(f"  admission: {rec['admission_stats']}")
    if s_["evictions"] < 1:
        fail("admission under the budget evicted nothing")
    record["phases_s"]["fleet_admission"] = round(time.perf_counter() - t0, 3)

    # -- 9b: serving ------------------------------------------------------
    t0 = time.perf_counter()
    fleet.budget_bytes = FLEET_SERVE_BUDGET
    served_names = [n for n in FLEET_TENANTS if n != FLEET_ZERO_TRAFFIC]
    print(f"phase 9b: 64 requests to each of {served_names} (1 alone, then 63 "
          f"interleaved), max_wait 1 ms; budget {FLEET_SERVE_BUDGET / 2**30:.0f} GiB",
          flush=True)
    rng = np.random.default_rng(9)
    xs_host = {n: [rng.standard_normal(mats[n].shape[1]).astype(np.float32)
                   for _ in range(64)] for n in served_names}
    xs_dev = {n: [torch.as_tensor(x, device=dev) for x in v] for n, v in xs_host.items()}
    before = dict(_build.LAUNCHES)
    # each tenant's first request alone (its k = 1 graph is captured at
    # its dispatch), then the same x again (the graph replayed)
    reqs, first_ms = {}, {}
    for n in served_names:
        reqs[n] = [fleet.submit(n, xs_dev[n][0])]
        serve(fleet, reqs[n])
        again = fleet.submit(n, xs_dev[n][0])
        serve(fleet, [again])
        if not torch.equal(again.result(), reqs[n][0].result()):
            fail(f"9b {n}: the first request's replay differs from its capture run")
        first_ms[n] = {"first": reqs[n][0].latency_s * 1e3, "again": again.latency_s * 1e3}
    for i in range(1, 64):
        for n in served_names:
            reqs[n].append(fleet.submit(n, xs_dev[n][i]))
    serve(fleet, [r for v in reqs.values() for r in v])
    fleet.flush()
    sync()
    l9b = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
    for n in served_names:
        check_cols(f"9b {n}", n, [r.result() for r in reqs[n]], xs_host[n])
        unfaulted(f"9b {n}", fleet.tenants[n].engine)
        print(f"  {n}: plans { {k: op.plan.candidate.key() for k, op in fleet.tenants[n].engine.ops.items()} } "
              f"by_bucket {fleet.tenants[n].engine.stats.summary()['by_bucket']}")
    print(f"  launches over 9b: {l9b}; reactivations {fleet.stats_fleet.reactivations}")
    if on_card and (l9b.get("sell_spmv", 0) <= 0 or l9b.get("bcsr_spmm", 0) <= 0):
        fail(f"9b: sell_spmv and bcsr_spmm must both launch: {l9b}")
    print("  first-request latency (submit to result; the first includes its bucket's "
          "capture), ms: " + ", ".join(f"{n} {v['first']:.3f} then {v['again']:.3f}"
                                        for n, v in first_ms.items()))
    rec["serving"] = {"launches": l9b, "reactivations": fleet.stats_fleet.reactivations,
                      "first_request_ms": first_ms}
    del reqs
    record["phases_s"]["fleet_serving"] = round(time.perf_counter() - t0, 3)

    # -- 9c: background retune under load --------------------------------
    t0 = time.perf_counter()
    print(f"phase 9c: retune {list(FLEET_RETUNED)} on the worker's stream while "
          "serving 4 requests a tenant a round", flush=True)
    engs = {n: fleet.tenants[n].engine for n in FLEET_RETUNED}
    old = {n: dict(e.ops) for n, e in engs.items()}
    for n in FLEET_RETUNED:
        fleet.retune(n)
    lat = {"during": [], "after": []}
    pre = {n: [] for n in FLEET_RETUNED}  # dispatched before the swap, kept
    last = {}
    rounds = {"during": 0, "after": 0}

    def serve_round(i: int, phase: str) -> None:
        live = []
        for n in FLEET_RETUNED:
            for j in range(4):
                idx = (4 * i + j) % 64
                live.append((n, idx, fleet.submit(n, xs_dev[n][idx]), [None]))
        while not all(r.done for _, _, r, _ in live):
            if fleet.step() == 0:
                fleet.flush()
            for n, _, r, tag in live:  # the table a request was dispatched on
                if tag[0] is None and not any(q is r for q in engs[n]._queue):
                    tag[0] = engs[n].swaps_applied
        for n, idx, r, tag in live:
            lat[phase].append(r.latency_s)
            if tag[0] == 0 and len(pre[n]) < 64:
                pre[n].append(r)
            last[n] = [(idx, r) for n_, idx, r, _ in live if n_ == n]
        rounds[phase] += 1

    t_rt = time.perf_counter()
    i = 0
    while fleet._retune_q.unfinished_tasks:
        serve_round(i, "during")
        i += 1
        time.sleep(0.002)
    retune_wall = time.perf_counter() - t_rt
    for _ in range(32):
        serve_round(i, "after")
        i += 1
    sync()
    st = fleet.stats_fleet
    if st.retunes_done != len(FLEET_RETUNED) or st.retunes_failed:
        fail(f"9c: retunes done {st.retunes_done}, failed {st.retunes_failed}: "
             f"{st.last_retune_error}")
    for n, e in engs.items():
        if e.swaps_applied < 1 or fleet.tenants[n].engine is not e:
            fail(f"9c {n}: swaps_applied {e.swaps_applied}")
        # every retuned closure whose output fits CAPTURE_MAX_OUTPUT_BYTES is
        # a graph, and the others are eager
        for k, fn in e._execs.items():
            small = mats[n].shape[0] * k * 4 <= CAPTURE_MAX_OUTPUT_BYTES
            if on_card and hasattr(fn, "executable") != small:
                fail(f"9c {n}: the retuned k={k} closure is "
                     f"{'not ' if small else ''}a CUDA graph")
        # the batches dispatched before the swap (through the old table's
        # graphs), replayed through the old plans' eager closures with the
        # same operands: bit for bit
        pinned = SparseEngine(mats[n], ks=K_BUCKETS, ops=old[n], device=dev,
                              captured=False)
        batches: dict = {}
        for r in pre[n]:
            batches.setdefault(id(r._ys), []).append(r)
        if not batches:
            fail(f"9c {n}: no batch was dispatched before the swap")
        zero = torch.zeros(mats[n].shape[1], dtype=torch.float32, device=dev)
        for group in batches.values():
            group.sort(key=lambda r: r._col)
            bucket = group[0].bucket
            xs_ = [r.x for r in group] + [zero] * (bucket - len(group))
            ys = pinned._make_exec(bucket, old[n][bucket])(*xs_)
            if not torch.equal(ys, group[0]._ys):
                fail(f"9c {n}: a batch dispatched before the swap differs from the "
                     f"pinned old plan (bucket {bucket})")
        print(f"  ok {n}: {len(pre[n])} requests in {len(batches)} batches dispatched "
              "before the swap equal the pinned old plan bit for bit")
        check_cols(f"9c {n} after the swap", n, [r.result() for _, r in last[n]],
                   [xs_host[n][idx] for idx, _ in last[n]])
        unfaulted(f"9c {n}", e)
    q = {ph: (float(np.percentile(v, 50)) * 1e3, float(np.percentile(v, 99)) * 1e3)
         for ph, v in lat.items()}
    print(f"  retune wall {retune_wall:.2f}s over {rounds['during']} serving rounds; "
          f"latency p50/p99 during {q['during'][0]:.3f}/{q['during'][1]:.3f} ms, after "
          f"{q['after'][0]:.3f}/{q['after'][1]:.3f} ms ({rounds['after']} rounds)", flush=True)
    retune_rows = {}
    for n in FLEET_RETUNED:
        for k, op in engs[n].ops.items():
            retune_rows[f"{n} k={k}"] = {
                "retuned": op.plan.candidate.key(), "retuned_ms": op.plan.measured_s * 1e3}
            r_ = retune_rows[f"{n} k={k}"]
            print(f"  {n} k={k}: retuned {r_['retuned']} {r_['retuned_ms']:.4f} ms")
    rec["retune"] = {"wall_s": retune_wall, "rounds": rounds,
                     "latency_ms_p50_p99": q, "buckets": retune_rows}
    del pre, last, old, pinned, batches, group, ys, xs_
    record["phases_s"]["fleet_retune"] = round(time.perf_counter() - t0, 3)

    # -- 9d: residency ----------------------------------------------------
    t0 = time.perf_counter()
    print("phase 9d: residency (budget full: the zero-traffic tenant goes first)",
          flush=True)
    fleet.budget_bytes = fleet.resident_bytes
    slabs = {n: sum(fn.slab.nbytes for fn in t.engine._execs.values()
                    if hasattr(fn, "slab"))
             for n, t in fleet.tenants.items() if t.resident}
    # the engine's own pool and the pools of its retuned closures, once a
    # pool no graph holds has gone back to the card
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    pools = {n: pool_bytes({fn.executable.pool for fn in t.engine._execs.values()
                            if hasattr(fn, "executable")}
                           | ({t.engine.graph_pool} - {None})) if on_card else 0
             for n, t in fleet.tenants.items() if t.resident}
    gc.collect()
    sync()
    mem0 = torch.cuda.memory_allocated(dev) if on_card else 0
    res0 = fleet.resident_bytes
    victim = fleet.tenants[FLEET_ZERO_TRAFFIC]
    nb = victim.nbytes
    resident_before = [n for n, t in fleet.tenants.items() if t.resident]
    fleet._make_room(1)
    gc.collect()
    sync()
    mem1 = torch.cuda.memory_allocated(dev) if on_card else 0
    evicted = [n for n in resident_before if not fleet.tenants[n].resident]
    if evicted != [FLEET_ZERO_TRAFFIC]:
        fail(f"9d: evicted {evicted}, expected only {FLEET_ZERO_TRAFFIC}")
    print(f"  evicted {evicted} ({nb / 1e6:.1f} MB prepared); allocator "
          f"{mem0 / 1e6:.1f} -> {mem1 / 1e6:.1f} MB (freed {(mem0 - mem1) / 1e6:.1f}); "
          f"resident_bytes {res0 / 1e6:.1f} -> {fleet.resident_bytes / 1e6:.1f} MB")
    print(f"  slab bytes the budget does not count: "
          f"{ {n: round(v / 1e6, 1) for n, v in slabs.items()} } MB; graph pools "
          f"(allocator bytes, not counted either): "
          f"{ {n: round(v / 1e6, 1) for n, v in pools.items()} } MB")
    if on_card and mem0 - mem1 < 0.9 * nb:
        fail(f"9d: the allocator freed {mem0 - mem1} B of {nb} B prepared")
    again = FLEET_RETUNED[0]  # evicted and reactivated: the retune's plans
    t_h = fleet.tenants[again]
    fleet._evict(t_h)
    n_plans = len(cache)
    t1 = time.perf_counter()
    r_h = fleet.submit(again, xs_dev[again][0])
    react_s = time.perf_counter() - t1
    serve(fleet, [r_h])
    if set(t_h.admitted_from.values()) != {"cache"} or len(cache) != n_plans or \
            not all(op.from_cache for op in t_h.engine.ops.values()):
        fail(f"9d: reactivating {again} was not an exact cache hit: {t_h.admitted_from}")
    check_cols(f"9d {again} reactivated", again, [r_h.result()], [xs_host[again][0]])
    print(f"  {again} reactivated in {react_s:.2f}s: every bucket an exact cache hit, "
          f"no search")
    rec["residency"] = {"evicted": evicted, "victim_nbytes": nb,
                        "allocated_before": mem0, "allocated_after": mem1,
                        "resident_bytes_before": res0,
                        "resident_bytes_after": fleet.resident_bytes,
                        "slab_bytes": slabs, "graph_pool_bytes": pools,
                        "reactivate_s": react_s}
    rec["summary"] = fleet.stats().summary()
    fleet.close()
    del fleet, engs, r_h, t_h, victim, xs_dev
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    record["phases_s"]["fleet_residency"] = round(time.perf_counter() - t0, 3)

    # -- 9e: breaker and fair share ----------------------------------------
    t0 = time.perf_counter()
    print("phase 9e: an engine.dispatch storm on cant (every batch), webbase-1M "
          "healthy, scircuit rate-limited (5/s, burst 2)", flush=True)
    storm = FaultPlan({"engine.dispatch": {"engine": "cant"}})
    healthy = "webbase-1M"
    fe = SparseFleet(cache=cache, retune=False, device=dev, faults=storm,
                     budget_bytes=FLEET_SERVE_BUDGET,
                     breaker_threshold=3, breaker_reset_s=600.0,
                     supervisor_kwargs=dict(max_retries=0, backoff_base_s=0.0,
                                            backoff_cap_s=0.0, repair_interval_s=0.05))
    for n in ("cant", healthy):
        fe.add_tenant(n, mats[n])
    fe.add_tenant("scircuit", mats["scircuit"], rate=5.0, burst=2.0)
    rng = np.random.default_rng(10)
    xe = {n: [rng.standard_normal(mats[n].shape[1]).astype(np.float32)
              for _ in range(12)] for n in ("cant", healthy, "scircuit")}
    bad, good = [], []
    for b in range(fe.breaker_threshold):
        bad += [fe.submit("cant", torch.as_tensor(x, device=dev)) for x in xe["cant"][4 * b:4 * b + 4]]
        good += [fe.submit(healthy, torch.as_tensor(x, device=dev))
                 for x in xe[healthy][4 * b:4 * b + 4]]
        serve(fe, bad + good)
    cant_t = fe.tenants["cant"]
    if not cant_t.quarantined or fe.stats_fleet.quarantines != 1:
        fail(f"9e: the breaker did not open after {fe.breaker_threshold} failed batches")
    if not all(r.failed for r in bad):
        fail("9e: a request of the faulted tenant was served")
    try:
        fe.submit("cant", torch.as_tensor(xe["cant"][0], device=dev))
        fail("9e: a quarantined tenant accepted a request")
    except CircuitOpenError as e:
        print(f"  ok cant quarantined after {fe.breaker_threshold} batches: {e}"[:200])
    kinds = [e.kind for e in cant_t.engine.supervisor.events]
    check_cols(f"9e {healthy} beside the storm", healthy, [r.result() for r in good],
               xe[healthy])
    refused, admitted = 0, []
    for x in xe["scircuit"][:10]:
        try:
            admitted.append((x, fe.submit("scircuit", torch.as_tensor(x, device=dev))))
        except OverloadError:
            refused += 1
    serve(fe, [r for _, r in admitted])
    if refused <= 0 or fe.stats_fleet.rate_limited != refused:
        fail(f"9e: rate_limited {fe.stats_fleet.rate_limited} != refusals {refused}")
    check_cols("9e scircuit (rate-limited, admitted ones)", "scircuit",
               [r.result() for _, r in admitted], [x for x, _ in admitted])
    for n in (healthy, "scircuit"):
        unfaulted(f"9e {n}", fe.tenants[n].engine)
    print(f"  cant events {sorted(set(kinds))}; rate-limited {refused} of 10 scircuit "
          f"requests; {healthy} and scircuit: zero events")
    rec["breaker"] = {"cant_events": kinds, "rate_limited": refused,
                      "quarantines": fe.stats_fleet.quarantines}
    fe.close()
    del fe, bad, good, admitted
    record["phases_s"]["fleet_breaker"] = round(time.perf_counter() - t0, 3)

    # -- 9f: the CLI -------------------------------------------------------
    t0 = time.perf_counter()
    print("phase 9f: serve --fleet cant,webbase-1M on the phase 9 plan cache", flush=True)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(cache_path)
    os.environ["REPRO_TORCH_FLEET_BUDGET_BYTES"] = str(FLEET_SERVE_BUDGET)
    tplan._default = None  # re-read $REPRO_TORCH_TUNE_CACHE
    stats_path = Path(tmp.name) / "fleet_cli.json"
    serve_cli.main(["--fleet", "cant,webbase-1M", "--scale", repr(scale), "--requests",
                    "64", "--max-wait-ms", "1", "--retune-wait-s", "30",
                    "--device", dev.type, "--stats-json", str(stats_path)])
    cli = rec["cli"] = json.loads(stats_path.read_text())
    if cli["served"] != 128 or cli["refused"] or cli["requests"] != 128:
        fail(f"9f: the fleet CLI served {cli['served']}/128 ({cli['refused']} refused)")
    record["phases_s"]["fleet_cli"] = round(time.perf_counter() - t0, 3)
    tmp.cleanup()
    sync()
    return dict(_build.LAUNCHES)


MESH_SHARDS = 4  # P of phase 10: on one card every shard shares it
MESH_KS = (1, 4, 16, 64)
MESH_LDOOR_IF_UNDER_S = 45.0  # the optional ldoor products run only below this


def mesh_runs(a, mesh) -> tuple[dict, dict]:
    """The products of phase 10 over ``mesh``: {name: fn(x)} for both
    schedules and ``stacked_spmm``, and per schedule (operand, placed
    operand, host partition seconds, placement seconds)."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.core.partition import rows_balanced, stack_csr_shards

    P = mesh.shape[mesh.axis_names[0]]
    first = mesh.devices[0]
    runs, built = {}, {}
    for schedule in dist.SCHEDULES:
        t1 = time.perf_counter()
        op = dist.build_mesh_operand(a, P, schedule)
        host_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        placed = dist.place_mesh_operand(op, mesh, mesh.axis_names[0])
        if first.type == "cuda":
            torch.cuda.synchronize()
        built[schedule] = (op, placed, host_s, time.perf_counter() - t1)
        runs[schedule] = dist.mesh_spmm_runner(mesh, mesh.axis_names[0], placed)
    part = rows_balanced(a, P)
    stacked = dist.place_stacked(stack_csr_shards(part.shards), first)
    shard_rows = np.diff(part.bounds)

    def stacked_run(x):
        x2 = x[:, None] if x.dim() == 1 else x
        y = dist.assemble_rows(dist.stacked_spmm(stacked, x2), shard_rows)
        return y[:, 0] if x.dim() == 1 else y

    runs["stacked"] = stacked_run
    return runs, built


def mesh_cases(a, runs: dict, tuned: dict, X) -> list:
    """10f's products, (k, name, fn()) at k = 1 and 64 on the columns of
    X (n, 64): the mesh ``runs``, the ring with every cell's padding
    gathered and multiplied as the JAX package's ``local_spmm`` streams it
    (ROADMAP C.16; the row sum over the stored entries), the ``tuned``
    single-device plans {k: SparseOperator} and ``csr/vector``."""
    from unittest import mock

    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.core.spmv import csr_prepare, spmm_csr, spmv_csr

    m = a.shape[0]
    csr = csr_prepare(a, X.device)

    def padded_local(cell, x):
        prod = cell["data"][:, None] * x[cell["indices"], :]
        return torch.segment_reduce(prod[:cell["nnz"]], "sum",
                                    offsets=cell["offsets"], axis=0, unsafe=True)

    def padded_stream(x):
        with mock.patch.object(dist, "local_spmm", padded_local):
            return runs["ring"](x)

    cases = []
    for k in (1, 64):
        x = X[:, 0].contiguous() if k == 1 else X[:, :k].contiguous()
        cases += [(k, name, (lambda fn=fn, x=x: fn(x))) for name, fn in runs.items()]
        cases.append((k, "ring, padded stream", (lambda x=x: padded_stream(x))))
        cases.append((k, f"tuned single-device ({tuned[k].plan.candidate.key()})",
                      (lambda op=tuned[k], x=x: op @ x)))
        cases.append((k, "csr/vector", (lambda x=x: spmv_csr(csr, x, n_rows=m)) if k == 1
                      else (lambda x=x: spmm_csr(csr, x, n_rows=m))))
    return cases


def mesh_device_ops(plans_json: str) -> None:
    """``python3 chip_smoke.py --mesh-device-ops PLANS``: the device
    operations of each of 10f's products by ``torch.profiler``, in a fresh
    process (sessions opened after phase 6's in one process lost device
    events on the card), for the tuned plans PLANS ({k: [fmt, impl,
    params]}); prints one JSON object {"k<k>/<name>": {"device_ops",
    "kernels"}}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.suite import generate
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.tune import SparseOperator, make

    cant = generate("cant", scale=1.0)
    mesh = make_spmm_mesh(MESH_SHARDS)
    first = mesh.devices[0]
    runs, _ = mesh_runs(cant, mesh)
    tuned = {int(k): SparseOperator.from_candidate(
                 cant, make(fmt, impl, **params), k=None if int(k) == 1 else int(k),
                 device=first)
             for k, (fmt, impl, params) in json.loads(plans_json).items()}
    X = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (cant.shape[1], 64)).astype(np.float32), device=first)
    out = {}
    for k, name, fn in mesh_cases(cant, runs, tuned, X):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        work = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [w for w in work if "memcpy" not in w.lower() and "memset" not in w.lower()]
        out[f"k{k}/{name}"] = {"device_ops": len(work), "kernels": len(kern)}
    print(json.dumps(out))


def mesh_phase(dev, scale: float, record: dict, *, tuned: dict | None = None,
               spd=None, ldoor=None) -> dict:
    """Phase 10: row-partitioned and mesh serving on cant at ``scale``, with
    P = 4 shards (on one card all four share it).

    ``tuned`` is a single-device plan table {k: SparseOperator} of the same
    matrix (10f times it beside the schedules), ``spd`` spd_shift(cant)
    (10d), ``ldoor`` the optional extra matrix.  Returns the kernel
    launches of 10b-10e (the mesh path runs the plain ``csr/vector`` row
    sum on every shard, so they are expected to be 0).  Runs on the CPU too
    (small ``scale``), without 10f's times: that is its rehearsal."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.core.device import backend_name
    from repro_torch.core.spmv import spd_shift
    from repro_torch.data.suite import generate
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.solver import SparseSolver
    from repro_torch.runtime.supervisor import Supervisor
    from repro_torch.tune import PlanCache, SparseOperator, fingerprint, make
    from repro_torch.tune import plan as tplan

    on_card = dev.type == "cuda"
    P = MESH_SHARDS
    rec = record["mesh"] = {}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    cant = generate("cant", scale=scale)
    m, n = cant.shape
    A64 = sp.csr_matrix((cant.data.astype(np.float64), cant.indices, cant.indptr),
                        shape=cant.shape)
    absA = abs(A64)
    mesh = make_spmm_mesh(P, device=dev.type)
    first = mesh.devices[0]
    print(f"phase 10: cant {m}x{n} nnz={cant.nnz}, P = {P} shards on "
          f"{mesh.n_devices} distinct device(s): {[str(d) for d in mesh.devices]}",
          flush=True)
    rec["mesh"] = {"shards": P, "n_devices": mesh.n_devices,
                   "devices": [str(d) for d in mesh.devices]}

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def check(label: str, Y, X) -> float:
        """Every entry within 1e-5 (|A| |x|)_i of scipy float64."""
        X = np.asarray(X, np.float64).reshape(n, -1)
        Y = Y.detach().cpu().numpy().astype(np.float64).reshape(m, -1)
        ref, lim = A64 @ X, TOL * (absA @ np.abs(X))
        err = np.abs(Y - ref)
        bad = ~(err <= lim)
        if Y.shape != ref.shape or bad.any():
            fail(f"{label}: {int(bad.sum())} entries off 1e-5 (|A||x|)_i, worst "
                 f"{float(np.max(err - lim)):.3e} over the limit")
        e = float(err.max())
        print(f"  ok {label}: max_abs_err {e:.3e}")
        return e

    def unfaulted(label: str, eng) -> None:
        ev = [(e.kind, e.info) for e in eng.supervisor.events]
        st = eng.stats
        if ev or st.demotions or st.failed_requests or st.retries:
            fail(f"{label}: supervisor events {ev}, demotions {st.demotions}, "
                 f"failed {st.failed_requests}, retries {st.retries}")

    rng = np.random.default_rng(0)
    X64h = rng.standard_normal((n, max(MESH_KS))).astype(np.float32)
    Xd = torch.as_tensor(X64h, device=first)

    def xk(k: int) -> torch.Tensor:
        return Xd[:, 0].contiguous() if k == 1 else Xd[:, :k].contiguous()

    # -- 10a: the operands, both schedules, stacked, psum ----------------
    t0 = time.perf_counter()
    ops_rec = rec["operands"] = {}
    runs, built = mesh_runs(cant, mesh)
    for schedule, (op, placed, host_s, place_s) in built.items():
        stored = int(op["arrays"]["indices"].size)
        cells = op["arrays"]["indptr"][..., -1]
        ops_rec[schedule] = {
            "host_partition_s": host_s, "place_s": place_s, "stored_entries": stored,
            "stored_over_nnz": stored / cant.nnz,
            "bytes_on_card": dist.mesh_operand_nbytes(placed),
            "entries_per_shard_or_cell": np.asarray(cells).tolist(),
        }
        print(f"  10a {schedule}: host partition {host_s:.3f}s, placement "
              f"{place_s:.3f}s, {stored} stored entries ({stored / cant.nnz:.2f}x nnz), "
              f"{ops_rec[schedule]['bytes_on_card'] / 1e6:.1f} MB on the device(s); "
              f"entries per {'cell' if schedule == 'ring' else 'shard'} "
              f"{np.asarray(cells).tolist()}", flush=True)
    ratio = ops_rec["ring"]["stored_entries"] / ops_rec["allgather"]["stored_entries"]
    rec["ring_over_allgather_entries"] = ratio
    print(f"  ring stores {ratio:.2f}x the allgather operand's entries "
          "(every cell padded to the largest)")
    del built
    errs = rec["max_abs_err"] = {}
    for k in MESH_KS:
        x = xk(k)
        for name, fn in runs.items():
            y = fn(x)
            errs[f"{name}/k{k}"] = check(f"10a {name} k={k} vs float64", y, X64h[:, :k])
            if not torch.equal(y, fn(x)):
                fail(f"10a {name} k={k}: two runs differ")
    print("  ok 10a: two runs of each schedule and of stacked_spmm agree bit for bit")
    dot = dist.psum_dot_runner(mesh, "shard", n)
    for k in (1, 8):
        u, v = xk(k), Xd[:, 8:8 + k].contiguous()
        if k == 1:
            v = v[:, 0].contiguous()
        got = dot(u, v).detach().cpu().numpy().astype(np.float64)
        u64 = u.cpu().numpy().astype(np.float64).reshape(n, -1)
        v64 = v.cpu().numpy().astype(np.float64).reshape(n, -1)
        want = (u64 * v64).sum(0)
        lim = TOL * (np.abs(u64) * np.abs(v64)).sum(0)
        if not np.all(np.abs(got.reshape(-1) - want) <= lim):
            fail(f"10a psum dot k={k}: {got} vs float64 {want}")
        print(f"  ok 10a psum dot k={k}: max_abs_err {float(np.abs(got.reshape(-1) - want).max()):.3e}")
    sync()
    record["phases_s"]["mesh_operands"] = round(time.perf_counter() - t0, 3)

    # -- 10b: the mesh engine and the shard engine, launches counted ------
    t0 = time.perf_counter()
    _build.reset_launches()
    cache_path = Path(tmp.name) / "plans.json"
    req_host = [X64h[:, j].copy() for j in range(64)]
    req_dev = [torch.as_tensor(v, device=first) for v in req_host]
    groups = (1, 3, 4, 12, 44)  # -> buckets 1, 4, 4, 16, 64

    def serve(eng, xs_):
        reqs, i = [], 0
        for g in groups:
            reqs += [eng.submit(x) for x in xs_[i:i + g]]
            i += g
            eng.step()
        eng.drain()
        return torch.stack([r.result() for r in reqs], dim=1)

    t1 = time.perf_counter()
    eng = SparseEngine(cant, ks=MESH_KS, mesh=mesh, cache=PlanCache(cache_path),
                       race=False)
    sync()
    rec["engine_build_s"] = time.perf_counter() - t1
    searches = rec["searches"] = {}
    for k, op in eng.ops.items():
        if op.plan.fmt != "dist" or op.plan.mesh_shape != [P]:
            fail(f"10b mesh engine k={k}: plan {op.plan}")
        timed = {c: v * 1e3 for c, v in op.measurements.items()}
        searches[k] = {"plan": op.plan.candidate.key(), "measured_ms": timed,
                       "backend": op.plan.backend}
        print(f"  10b bucket {k}: {op.plan.impl} won ({op.plan.measured_s * 1e3:.4f} ms); "
              + ", ".join(f"{c} {v:.4f} ms" for c, v in sorted(timed.items())))
        if len(timed) != len(dist.SCHEDULES) or not all(np.isfinite(list(timed.values()))):
            fail(f"10b bucket {k}: both schedules must be timed, got {timed}")
    print(f"  mesh engine: {eng!r}; built (searched) in {rec['engine_build_s']:.2f}s")
    Y_async = serve(eng, req_dev)
    errs["engine"] = check("10b mesh engine, 64 requests vs float64", Y_async,
                           np.stack(req_host, axis=1))
    eng_sync = SparseEngine(cant, ks=MESH_KS, mesh=mesh, cache=PlanCache(cache_path),
                            async_depth=0)
    if not eng_sync.from_cache:
        fail("10b: a second mesh engine on the same cache searched again")
    Y_sync = serve(eng_sync, req_dev)
    if not torch.equal(Y_async, Y_sync):
        fail("10b mesh engine: async results differ from async_depth=0 results")
    print("  ok 10b: a second engine on the cache is a full hit; async == "
          "async_depth=0 bit for bit")
    single = SparseEngine(cant, ks=(1, 64), cache=PlanCache(cache_path), device=first,
                          candidates=[make("csr", "vector")])
    if single.from_cache or any(op.plan.fmt == "dist" for op in single.ops.values()):
        fail("10b: a single-device engine on the mesh engine's cache saw its plans")
    fp, scale_ = fingerprint(cant), [m, n, cant.nnz]
    hit = PlanCache(cache_path).get(fp, "spmv", 1, backend=backend_name(first),
                                    scale=scale_)
    if hit is not None and hit.fmt == "dist":
        fail("10b: a single-device lookup returned a mesh plan")
    print("  ok 10b: a single-device engine on that cache does not see the mesh plans")
    single.close()
    eng_sh = SparseEngine(cant, ks=MESH_KS, n_shards=P, device=first)
    Y_sh = serve(eng_sh, req_dev)
    errs["shard_engine"] = check(f"10b n_shards={P} engine, 64 requests vs float64",
                                 Y_sh, np.stack(req_host, axis=1))
    for label, e in (("mesh engine", eng), ("mesh engine sync", eng_sync),
                     ("shard engine", eng_sh)):
        e.close()
        unfaulted(label, e)
    print("  ok 10b engines: zero supervisor events")
    record["phases_s"]["mesh_engines"] = round(time.perf_counter() - t0, 3)

    # -- 10c: a fault in one mesh bucket ---------------------------------
    t0 = time.perf_counter()
    fault = FaultPlan({"engine.dispatch": {"n": 2, "bucket": 16}})
    eng_f = SparseEngine(cant, ks=MESH_KS, mesh=mesh, cache=PlanCache(cache_path),
                         faults=fault,
                         supervisor=Supervisor(max_retries=1, backoff_base_s=0.0,
                                               backoff_cap_s=0.0, repair_interval_s=0.01))
    Y_f = serve(eng_f, req_dev)
    errs["demoted"] = check("10c faulted mesh engine (bucket 16 demoted) vs float64",
                            Y_f, np.stack(req_host, axis=1))
    dem = eng_f.supervisor.events_of("demote")
    if [e.info["bucket"] for e in dem] != [16] or eng_f.ops[16].mesh is not None:
        fail(f"10c: demotions {[(e.info) for e in dem]}, bucket 16 on "
             f"{eng_f.ops[16]!r}")
    print(f"  ok 10c: bucket 16 demoted to {dem[0].info['tier']} on {first}")
    deadline = time.perf_counter() + 30.0
    while eng_f.supervisor.promotions < 1:
        if time.perf_counter() > deadline:
            fail("10c: the repair never re-promoted bucket 16")
        time.sleep(0.01)
    Y_f2 = serve(eng_f, req_dev)
    check("10c after the repair vs float64", Y_f2, np.stack(req_host, axis=1))
    if eng_f.ops[16].plan.fmt != "dist" or eng_f._demoted:
        fail(f"10c: bucket 16 serves {eng_f.ops[16].plan.candidate.key()} after repair")
    kinds = [e.kind for e in eng_f.supervisor.events]
    if not kinds.index("batch_failed") < kinds.index("demote") < kinds.index("promote"):
        fail(f"10c: events out of order {kinds}")
    print(f"  ok 10c: re-promoted to {eng_f.ops[16].plan.candidate.key()}; events {kinds}")
    try:
        eng_f.submit_sparse(np.array([0], np.int64), np.ones(1, np.float32))
    except NotImplementedError:
        print("  ok 10c: submit_sparse on a mesh engine raises NotImplementedError")
    else:
        fail("10c: submit_sparse on a mesh engine did not raise")
    eng_f.close()
    record["phases_s"]["mesh_faults"] = round(time.perf_counter() - t0, 3)

    # -- 10d: CG over the mesh -------------------------------------------
    t0 = time.perf_counter()
    spd = spd_shift(cant) if spd is None else spd
    S64 = sp.csr_matrix((spd.data.astype(np.float64), spd.indices, spd.indptr),
                        shape=spd.shape)
    b = np.random.default_rng(0).standard_normal(m).astype(np.float32)
    ms = SparseSolver(spd, mesh=mesh, cache=PlanCache(cache_path))
    res = ms.cg(b, tol=1e-5)
    one = SparseSolver(spd, cache=PlanCache(), device=first,
                       candidates=[make("csr", "vector")])
    res1 = one.cg(b, tol=1e-5)
    x64 = res.x.cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(S64 @ x64 - b) / np.linalg.norm(b))
    rec["cg"] = {"plan": res.plan, "iterations": res.iterations,
                 "single_device_iterations": res1.iterations,
                 "float64_rel_residual": rel, "syncs": res.syncs}
    print(f"  10d mesh CG ({res.plan}): {res.iterations} iterations, float64 residual "
          f"{rel:.3e}; single-device CG {res1.iterations} iterations")
    if not res.converged or rel > 1e-4:
        fail(f"10d mesh CG: converged={res.converged}, residual {rel:.3e} > 1e-4")
    if res.iterations != res1.iterations:
        fail(f"10d mesh CG took {res.iterations} iterations, the single-device "
             f"solve {res1.iterations}")
    if ms.supervisor.events:
        fail(f"10d mesh solver events {ms.supervisor.events}")
    record["phases_s"]["mesh_cg"] = round(time.perf_counter() - t0, 3)

    # -- 10e: the CLI ------------------------------------------------------
    t0 = time.perf_counter()
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(cache_path)
    tplan._default = None  # re-read $REPRO_TORCH_TUNE_CACHE
    cli = rec["cli"] = {}
    for flag in ("--mesh-shards", "--shards"):
        out = Path(tmp.name) / f"cli{flag}.json"
        print(f"phase 10e: serve --sparse cant {flag} {P}", flush=True)
        serve_cli.main(["--sparse", "cant", "--scale", repr(scale), "--requests", "64",
                        flag, str(P), "--device", dev.type, "--stats-json", str(out)])
        st = cli[flag] = json.loads(out.read_text())
        if st["served"] != 64 or st["shards"] != P or st["supervisor"]["demotions"]:
            fail(f"10e {flag}: {st}")
    sync()
    launches = dict(_build.LAUNCHES)
    print(f"  launches over 10b-10e: {launches}")
    record["phases_s"]["mesh_cli"] = round(time.perf_counter() - t0, 3)

    # -- 10f: times --------------------------------------------------------
    t0 = time.perf_counter()
    if not on_card:
        print("  10f skipped: times are taken on the card only")
    else:
        smi = smi_line()
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=first)

        def time_ms(fn) -> float:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(REPS):
                flush.zero_()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                e.synchronize()
                ts.append(s.elapsed_time(e))
            return float(np.median(ts))

        tuned = tuned if tuned is not None else SparseOperator.build_multi(
            cant, ks=(1, 64), cache=PlanCache(), device=first)
        plans = {k: [tuned[k].plan.fmt, tuned[k].plan.impl, tuned[k].plan.params]
                 for k in (1, 64)}
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--mesh-device-ops", json.dumps(plans)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"10f: counting device operations failed: {proc.stderr[-2000:]}")
        ops = json.loads(proc.stdout.strip().splitlines()[-1])
        times = rec["times"] = {"card": smi}
        for k, name, fn in mesh_cases(cant, runs, tuned, Xd):
            row = times.setdefault(f"k{k}", {})[name] = {"ms": time_ms(fn),
                                                         **ops[f"k{k}/{name}"]}
            print(f"  10f k={k} {name}: {row['ms']:.4f} ms, {row['kernels']} kernels "
                  f"+ {row['device_ops'] - row['kernels']} copies/fills per product "
                  f"[{smi}]", flush=True)
        del flush
        torch.cuda.empty_cache()
    record["phases_s"]["mesh_times"] = round(time.perf_counter() - t0, 3)

    # -- the optional ldoor products --------------------------------------
    elapsed = time.perf_counter() - t_phase
    if ldoor is not None and elapsed < MESH_LDOOR_IF_UNDER_S:
        L64 = sp.csr_matrix((ldoor.data.astype(np.float64), ldoor.indices, ldoor.indptr),
                            shape=ldoor.shape)
        xl = np.random.default_rng(0).standard_normal(ldoor.shape[1]).astype(np.float32)
        ref, lim = L64 @ xl.astype(np.float64), TOL * (abs(L64) @ np.abs(xl.astype(np.float64)))
        lrec = rec["ldoor"] = {}
        for schedule in dist.SCHEDULES:
            t1 = time.perf_counter()
            op = dist.build_mesh_operand(ldoor, P, schedule)
            host_s = time.perf_counter() - t1
            placed = dist.place_mesh_operand(op, mesh, "shard")
            y = dist.mesh_spmm_runner(mesh, "shard", placed)(torch.as_tensor(xl, device=first))
            err = np.abs(y.cpu().numpy().astype(np.float64) - ref)
            if not np.all(err <= lim):
                fail(f"ldoor {schedule}: {int((err > lim).sum())} rows off 1e-5")
            lrec[schedule] = {"host_partition_s": host_s,
                              "stored_entries": int(op["arrays"]["indices"].size),
                              "bytes_on_card": dist.mesh_operand_nbytes(placed),
                              "max_abs_err": float(err.max())}
            print(f"  ldoor {schedule}: host partition {host_s:.3f}s, "
                  f"{lrec[schedule]['stored_entries']} stored entries "
                  f"({lrec[schedule]['stored_entries'] / ldoor.nnz:.2f}x nnz), "
                  f"{lrec[schedule]['bytes_on_card'] / 1e6:.1f} MB, max_abs_err "
                  f"{lrec[schedule]['max_abs_err']:.3e}", flush=True)
            del placed, op
        if on_card:
            torch.cuda.empty_cache()
    else:
        print(f"  ldoor products skipped ({'no matrix' if ldoor is None else f'{elapsed:.1f}s elapsed'})")
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 10 wall time {rec['wall_s']:.1f}s", flush=True)
    tmp.cleanup()
    return launches


# -- phase 11: LM serving ---------------------------------------------------
LM_ARCHES = ("qwen1.5-4b", "h2o-danube-3-4b")  # (a): both dense, at full width
LM_REQUESTS, LM_SLOTS, LM_PROMPT, LM_NEW, LM_MAX_SEQ = 8, 4, 32, 16, 128
# (b): decode at 1 and 4 slots, the 32-token prefill, a 4-slot x 128-token
# prefill (512), and ragged widths for the N tiles' masks
LM_CHECK_KS = (1, 3, 4, 17, 32, 100, 128, 512)
LM_TIMED_KS = (4, 32, 128, 512)  # (g)
LM_CORE_KS = (4, 32)  # (g): the CUDA-core path on the same weight, re-blocked
LM_CONSISTENCY = 1e-3  # (d): float32 decode against forward, x max|logits|
# (e): served bf16 first-token logits against the float32 copy's, as a share
# of max|logits| (PERF.md §2 gives the limit's reason)
LM_BF16_LIMIT = 0.05
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense


class LMBench:
    """The LM phases' tools on one device, over the prompts they serve
    (with each prompt's modality inputs ``extras``, ``new`` tokens each, at
    ``max_seq``): ``sync``, ``free``, ``median_ms`` (CUDA events; the host
    clock on the CPU, for a rehearsal only), ``serve`` and ``step_times``."""

    def __init__(self, dev, prompts, extras=None, new: int = LM_NEW,
                 max_seq: int = LM_MAX_SEQ):
        import torch

        self.dev, self.prompts = dev, prompts
        self.extras = extras or [{} for _ in prompts]
        self.new, self.max_seq = new, max_seq
        self.cuda = dev.type == "cuda"
        self.flush = torch.empty(64 * 2**20 if self.cuda else 1, dtype=torch.int32,
                                 device=dev)

    def sync(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def median_ms(self, fn, l2_flush: bool = False) -> float:
        """CUDA events around each of REPS runs (host clock on the CPU,
        for the rehearsal only)."""
        import numpy as np
        import torch

        for _ in range(2):
            fn()
        self.sync()
        ts = []
        for _ in range(REPS):
            if l2_flush:
                self.flush.zero_()
            if self.cuda:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                e.synchronize()
                ts.append(s.elapsed_time(e))
            else:
                t = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts))

    def serve(self, cfg_, model, slots, ps=None):
        """A ``BatchedServer`` with ``slots`` slots serves ``ps`` (the
        prompts, or (prompt, extras) pairs), ``new`` tokens each; fails
        unless every request is served with tokens below ``vocab``."""
        from repro_torch.runtime.server import BatchedServer, Request

        ps = list(zip(self.prompts, self.extras)) if ps is None else [
            p if isinstance(p, tuple) else (p, {}) for p in ps]
        srv = BatchedServer(cfg_, model, batch_slots=slots, max_seq=self.max_seq)
        reqs = [Request(rid=i, prompt=p, max_new=self.new, **x)
                for i, (p, x) in enumerate(ps)]
        t0 = time.perf_counter()
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        self.sync()
        dt = time.perf_counter() - t0
        if not all(r.done and len(r.out) == self.new for r in reqs):
            fail(f"{cfg_.arch_id}: served {sum(r.done for r in reqs)}/{len(reqs)}")
        if any(t >= cfg_.vocab for r in reqs for t in [r._first, *r.out]):
            fail(f"{cfg_.arch_id}: a served token is a pad id (>= {cfg_.vocab})")
        lats = sorted(r.latency_s for r in reqs)
        return srv, reqs, {
            "served": len(reqs), "seconds": dt, "tok_per_s": self.new * len(reqs) / dt,
            "latency_p50_s": lats[len(lats) // 2],
            "latency_p99_s": lats[int(len(lats) * 0.99)],
            "decode_steps": srv.steps, "prefills": srv.prefills,
            "graphs": srv.graphs, "warmups": srv.warmups, "capture_s": srv.capture_s}

    def step_times(self, cfg_, model) -> dict:
        """Prefill ms of the first prompt (batch 1) and decode step ms at
        LM_SLOTS slots, each through a server's own path: a
        ``captured=False`` server's eager passes and (on a card) a default
        server's graphs (``_prefill_one``: the pinned copy and the prompt
        length's replay; ``_decode_once``: the pinned token copy and the
        decode graph's replay); and the decode step's bound: the weight
        bytes a step reads (every weight but the embedding table, of which
        it reads LM_SLOTS rows, plus the kernel's block indices) over
        3.35 TB/s.  A MoE decode step reads every expert: at one token a
        row, each expert's capacity is one slot, and the batched expert
        products run over all of them."""
        import numpy as np

        from repro_torch.runtime.server import BatchedServer, _merge_slot

        prompts, extras, median_ms = self.prompts, self.extras, self.median_ms
        toks = np.zeros((LM_SLOTS, 1), np.int64)
        times = {"prefill_graph_ms": None, "decode_step_graph_ms": None}
        for captured in (False, True) if self.cuda else (False,):
            srv = BatchedServer(cfg_, model, batch_slots=LM_SLOTS, max_seq=self.max_seq,
                                captured=captured)
            for i in range(LM_SLOTS):  # fill the slots as the server does
                one, _ = srv._prefill_one(prompts[i], **extras[i])
                _merge_slot(srv.state, one, i)
                self.sync()
            tag = "_graph" if captured else ""
            times[f"prefill{tag}_ms"] = median_ms(
                lambda: srv._prefill_one(prompts[0], **extras[0]))
            times[f"decode_step{tag}_ms"] = median_ms(lambda: srv._decode_once(toks))
            if captured:  # the replay alone, without the pinned token copy
                times["decode_replay_ms"] = median_ms(srv._decode[0].replay)
            state_bytes = sum(t.numel() * t.element_size()
                              for leaves in srv.state.values() for t in leaves.values())
            del srv
            self.free()
        graphed = {k: times.get(k) for k in ("prefill_graph_ms", "decode_step_graph_ms",
                                             "decode_replay_ms")}
        prefill_ms, decode_ms = times["prefill_ms"], times["decode_step_ms"]
        weights = sum(t.numel() * t.element_size() for name, t in model.named_parameters()
                      if name != "embed")
        weights += sum(t.numel() * t.element_size() for name, t in model.named_buffers()
                       if name.endswith(("_cols", "_indptr")))
        weights += LM_SLOTS * cfg_.d_model * model.embed.element_size()
        out = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms, **graphed,
               "decode_weight_bytes": weights, "state_bytes": state_bytes,
               "decode_bound_ms": weights / HBM_BYTES_PER_S * 1e3}
        g_txt = ("" if not self.cuda else
                 f"; as CUDA graphs: prefill {graphed['prefill_graph_ms']:.3f} ms, "
                 f"decode step {graphed['decode_step_graph_ms']:.3f} ms (the replay "
                 f"alone {graphed['decode_replay_ms']:.3f})")
        kind = ("bcsr" if cfg_.sparse_ffn else "moe" if cfg_.moe else
                cfg_.ssm_kind or "dense")
        print(f"  {cfg_.arch_id} {str(cfg_.dtype)[6:]} {kind}: eager prefill "
              f"{prefill_ms:.3f} ms ({len(prompts[0])} tokens), decode step {decode_ms:.3f} ms "
              f"({LM_SLOTS} slots){g_txt}; the step's bound {out['decode_bound_ms']:.3f} "
              f"ms ({weights / 1e9:.3f} GB of weights; decode state "
              f"{state_bytes / 1e6:.1f} MB)", flush=True)
        return out


def lm_profile(labels: list[str]) -> None:
    """``python3 chip_smoke.py --lm-profile LABEL ...``: one eager and one
    graphed decode step of each model under ``torch.profiler``, in a fresh
    process (see ``mesh_device_ops``).  A label is an architecture id at
    its full configuration in bf16, or ``<arch>/bcsr`` for its bcsr-FFN
    variant ((128, 128) blocks, phase 11g's); weights from seed 0, LM_SLOTS
    slots after LM_PROMPT-token prefills (whisper-tiny and qwen2-vl-72b:
    phase 14's requests, qwen2-vl at ``vl_layers``).  Each step is a server's own:
    ``_decode_once`` of a ``captured=False`` server (eager) and of a
    default server (the pinned token copy and its decode graph's replay).
    Each runs inside a ``record_function`` range that ends after a
    synchronise; all of them under one profiler.  Prints one JSON
    object {label: {"eager"|"graph": {"wall_ms", "busy_ms", "idle_share",
    "kernels", "device_ops"}}}: the range's wall time, the union of the
    device operations inside it, the share of the range the device was
    idle, and the kernels and all device operations (copies and fills too)
    counted."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.runtime.server import BatchedServer, _merge_slot

    dev = torch.device("cuda")
    steps = {}
    for label in labels:
        arch, _, variant = label.partition("/")
        cfg = get_config(arch)
        if variant == "bcsr":
            cfg = dataclasses.replace(cfg, sparse_ffn=SparseFFNConfig(
                kind="bcsr", block=(128, 128)))
        max_seq = LM_MAX_SEQ
        if cfg.family in ("audio", "vlm"):  # phase 14's traffic and depth
            cfg = dataclasses.replace(cfg, n_layers=vl_layers(cfg)[0])
            prompts, extras = av_traffic(cfg, LM_SLOTS)
            max_seq = VL_MAX_SEQ if cfg.family == "vlm" else LM_MAX_SEQ
        else:
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
                       for _ in range(LM_SLOTS)]
            extras = [{} for _ in prompts]
        model = lm.init_model(cfg, 0, device=dev)
        if cfg.family == "hybrid":
            perturb_hybrid(model, 0)
        toks = np.zeros((LM_SLOTS, 1), np.int64)
        for name, captured in (("eager", False), ("graph", True)):
            srv = BatchedServer(cfg, model, batch_slots=LM_SLOTS, max_seq=max_seq,
                                captured=captured)
            for i, p in enumerate(prompts):  # fill the slots as the server does
                one, _ = srv._prefill_one(p, **extras[i])
                _merge_slot(srv.state, one, i)
                torch.cuda.synchronize()
            steps[f"{label}:{name}"] = functools.partial(srv._decode_once, toks)
    for _ in range(3):
        for fn in steps.values():
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for key, fn in steps.items():
            with record_function(f"decode_step/{key}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    out: dict = {}
    for key in steps:
        label, name = key.rsplit(":", 1)
        out.setdefault(label, {})[name] = profile_window(events, f"decode_step/{key}")
    print(json.dumps(out))


def run_lm_profile(labels: list[str]) -> dict:
    """``lm_profile`` in a fresh process; its JSON, or a failed run."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--lm-profile", *labels], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        fail(f"profiling decode steps of {labels} failed: {proc.stderr[-2000:]}")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    for label, by_name in prof.items():
        for name, p_ in by_name.items():
            print(f"  one {label} decode step, {name}, by torch.profiler: wall "
                  f"{p_['wall_ms']:.3f} ms, device busy {p_['busy_ms']:.3f} ms, idle "
                  f"share {p_['idle_share']:.4f}, {p_['kernels']} kernels, "
                  f"{p_['device_ops']} device operations", flush=True)
    return prof


def ffn_weights(ffn, cfg) -> dict:
    """{"w1"|"w2": ((blocks, cols, indptr), n_cb)} of a bcsr FFN: the
    kernel's operands per weight and X's column-block count."""
    bm, bk = cfg.sparse_ffn.block
    return {which: ((ffn[f"{which}_blocks"], ffn[f"{which}_cols"],
                     ffn[f"{which}_indptr"]), n_cb)
            for which, n_cb in (("w1", cfg.d_model // bk), ("w2", cfg.d_ff // bm))}


def check_bf16_products(label: str, args, n_cb: int, ks, rng, dev, path: str,
                        key: str) -> dict:
    """``bcsr_spmm`` on one bf16 weight at each width in ``ks`` against its
    plain version, every output within TOL (|A| |x|)_i, and a second launch
    bit for bit; fails otherwise.  Returns {f"{key}/k{k}": max_abs_err}."""
    import numpy as np
    import torch

    from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain

    errs = {}
    # k_i, the terms of each output row: its block row's stored blocks x bk
    terms = (args[2][1:] - args[2][:-1]).long() * args[0].shape[2]
    for k in ks:
        xb = torch.as_tensor(rng.standard_normal((n_cb, args[0].shape[2], k))
                             .astype(np.float32), device=dev).to(torch.bfloat16)
        y = bcsr_spmm(*args, xb)
        if not torch.equal(y, bcsr_spmm(*args, xb)):
            fail(f"bcsr_spmm_bf16 {label} k={k}: two launches differ")
        yp = bcsr_spmm_plain(*args, xb)
        scale = bcsr_spmm_plain(args[0].abs(), *args[1:], xb.abs()).double()
        err = (y.double() - yp.double()).abs()
        bad = err > TOL * scale
        if y.dtype != torch.float32 or bool(bad.any()):
            for r, i in bad.any(-1).nonzero()[:8].tolist():
                j = int((err[r, i] / scale[r, i]).argmax())
                print(f"  row {r * args[0].shape[1] + i}: k_i {int(terms[r])}, "
                      f"|err| {float(err[r, i, j]):.3e} = "
                      f"{float(err[r, i, j] / scale[r, i, j]):.3e} (|A| |x|)_i")
            fail(f"bcsr_spmm_bf16 {label} k={k}: {int(bad.sum())} entries over "
                 f"{TOL:g} (|A| |x|)_i, max_abs_err {float(err.max()):.3e}")
        errs[f"{key}/k{k}"] = float(err.max())
        print(f"  ok bcsr_spmm_bf16 ({path}) {label} k={k}: max_abs_err "
              f"{errs[f'{key}/k{k}']:.3e}, the same bits on a second launch")
    return errs


def densify(args, n_cb: int):
    """The dense bf16 matrix of a bcsr weight (the library call's operand)."""
    import torch

    blocks, cols, indptr = args
    gm = indptr.shape[0] - 1
    brows = torch.repeat_interleave(
        torch.arange(gm, device=blocks.device), (indptr[1:] - indptr[:-1]).long())
    r, c = blocks.shape[1:]
    dense = torch.zeros((gm, n_cb, r, c), dtype=torch.bfloat16, device=blocks.device)
    dense[brows, cols.long()] = blocks
    return dense.permute(0, 2, 1, 3).reshape(gm * r, n_cb * c)


def bf16_time_rows(label: str, args, n_cb: int, dense, ks, rng, median_ms, path: str,
                   *, launches: int, max_abs_err: float) -> list:
    """Kernel table rows of ``bcsr_spmm`` on one bf16 weight at each width
    in ``ks`` (medians of REPS, L2 flushed): the kernel, its plain version,
    a dense bf16 matmul of ``dense`` (``library_ms``), the bound (bf16
    blocks and X read, float32 Y written, over 3.35 TB/s, against 2 nnz k
    over 989 TFLOP/s) and the same launch on an empty matrix of the same
    shapes (``empty_ms``: the launch and a zero Y, the floor of this
    timing)."""
    import numpy as np
    import torch

    from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain

    blocks, cols, indptr = args
    gm = indptr.shape[0] - 1
    r, c = blocks.shape[1:]
    empty = torch.zeros_like(indptr)  # the same shapes, no stored block
    rows = []
    for k in ks:
        xb = torch.as_tensor(rng.standard_normal((n_cb, c, k)).astype(np.float32),
                             device=blocks.device).to(torch.bfloat16)
        x2 = xb.view(-1, k)
        fn_bytes = blocks.numel() * 2 + xb.numel() * 2 + gm * r * k * 4
        flops = 2 * blocks.numel() * k
        b_s, f_s = fn_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        row = {
            "name": "bcsr_spmm_bf16",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
            "replaces": "src/repro/kernels/bcsr_spmm.py:56",
            "shape": f"{label} {tuple(dense.shape)} {blocks.shape[0]} blocks "
                     f"{(r, c)} bf16 k={k}",
            "path": path,
            "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": median_ms(lambda: bcsr_spmm(*args, xb), True),
            "plain_ms": median_ms(lambda: bcsr_spmm_plain(*args, xb), True),
            "bound_ms": max(b_s, f_s) * 1e3,
            "bound_by": "bytes" if b_s >= f_s else "operations",
            "bytes": int(fn_bytes),
            "flops": int(flops),
            "library_ms": median_ms(lambda: dense @ x2, True),
            "empty_ms": median_ms(lambda: bcsr_spmm(blocks, cols, empty, xb), True),
        }
        rows.append(row)
        print(f"  bcsr_spmm_bf16 [{row['shape']}]: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, dense bf16 matmul {row['library_ms']:.4f}, "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']}, "
              f"{fn_bytes / 1e6:.2f} MB), share "
              f"{row['bound_ms'] / row['ms'] * 100:.1f} %; on an empty matrix "
              f"{row['empty_ms']:.4f}", flush=True)
    return rows


def lm_phase(dev, record: dict, *, reduced: bool = False) -> tuple[dict, list]:
    """Phase 11: LM serving of qwen1.5-4b at full width and depth in bf16
    (``reduced``: the reduced configs, a CPU rehearsal with no times).
    Returns the launch counts of (c) and the ``bcsr_spmm_bf16`` rows."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels.bcsr_spmm import (
        bcsr_spmm,
        bcsr_spmm_plain,
        bf16_tensor_core_path,
    )
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.runtime.server import BatchedServer, Request
    from repro_torch.tune import PlanCache

    rec = record.setdefault("lm", {})
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    get = get_reduced if reduced else get_config
    cfg = get(LM_ARCHES[0])
    block = (32, 32) if reduced else (128, 128)
    rng = np.random.default_rng(0)  # the CLI's prompts, drawn the same way
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    bench = LMBench(dev, prompts)
    sync, free, median_ms = bench.sync, bench.free, bench.median_ms
    serve, step_times = bench.serve, bench.step_times

    # (a) the CLI, dense FFN: qwen1.5-4b, then h2o-danube-3-4b
    for arch in LM_ARCHES:
        t0 = time.perf_counter()
        print(f"phase 11a: serve --arch {arch}" + (" --reduced" if reduced else ""),
              flush=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as td:
            stats = Path(td) / "lm.json"
            _build.reset_launches()
            serve_cli.main(["--arch", arch, "--requests", str(LM_REQUESTS),
                            "--slots", str(LM_SLOTS), "--prompt-len", str(LM_PROMPT),
                            "--max-new", str(LM_NEW), "--max-seq", str(LM_MAX_SEQ),
                            "--device", dev.type, "--stats-json", str(stats)]
                           + (["--reduced"] if reduced else []))
            summary = json.loads(stats.read_text())
        dense_launches = dict(_build.LAUNCHES)
        if summary["served"] != LM_REQUESTS:
            fail(f"serve --arch {arch} served {summary['served']}/{LM_REQUESTS}")
        if cuda and dense_launches:
            fail(f"serve --arch {arch} (dense FFN) launched {dense_launches}")
        summary["wall_s"] = time.perf_counter() - t0
        rec[f"cli/{arch}"] = summary
        free()

    # the dense model's step times (g)
    model = lm.init_model(cfg, 0, device=dev)
    rec["dense_params"] = lm.param_count(model)
    rec["times/dense"] = step_times(cfg, model)
    del model
    free()

    # (b) the bcsr-FFN variant: layer 0's weights through the bf16 kernel
    sff = SparseFFNConfig(kind="bcsr", block=block)
    cfg_b = dataclasses.replace(cfg, sparse_ffn=sff)
    t0 = time.perf_counter()
    model_b = lm.init_model(cfg_b, 0, device=dev)
    sync()
    rec["bcsr_params"] = lm.param_count(model_b)
    rec["bcsr_init_s"] = time.perf_counter() - t0
    ffn0 = model_b.blocks[0].ffn
    bm, bk = block
    print(f"phase 11b: {cfg_b.arch_id} bcsr FFN {block}, density {sff.density}: "
          f"W1 {ffn0.w1_blocks.shape[0]} blocks, W2 {ffn0.w2_blocks.shape[0]} blocks; "
          f"{rec['bcsr_params'] / 1e9:.3f} G parameters (dense "
          f"{rec['dense_params'] / 1e9:.3f} G)", flush=True)
    weights = ffn_weights(ffn0, cfg_b)
    errs = {}
    path = "tensor cores" if bf16_tensor_core_path(bm, bk) else "CUDA cores"
    for which, (args, n_cb) in weights.items():
        errs.update(check_bf16_products(f"layer-0 {which}", args, n_cb, LM_CHECK_KS,
                                        rng, dev, path, key=which))
    rec["kernel_checks"] = errs

    # (c) serving the variant: the main path, launches counted
    print(f"phase 11c: BatchedServer({LM_SLOTS} slots), {LM_REQUESTS} requests, "
          f"prompt {LM_PROMPT}, max_new {LM_NEW}", flush=True)
    _build.reset_launches()
    srv, reqs_b, served_b = serve(cfg_b, model_b, LM_SLOTS)
    launches = dict(_build.LAUNCHES)
    # every replay counts its captured launches and every warm-up pass (one
    # eager pass before each capture: decode, and each prompt length) its own
    passes = srv.prefills + srv.steps + srv.warmups
    expect = 2 * cfg.n_layers * passes
    print(f"  served {LM_REQUESTS}/{LM_REQUESTS} in {served_b['seconds']:.2f}s "
          f"({served_b['tok_per_s']:.1f} tok/s, latency p50 "
          f"{served_b['latency_p50_s']:.2f}s p99 {served_b['latency_p99_s']:.2f}s): "
          f"{srv.prefills} prefills, {srv.steps} decode steps, {srv.graphs} CUDA graphs "
          f"captured in {srv.capture_s:.2f}s after {srv.warmups} warm-up passes, "
          f"launches {launches} (2 x {cfg.n_layers} x ({srv.prefills} + {srv.steps} + "
          f"{srv.warmups}) = {expect} expected)", flush=True)
    if cuda and (srv.graphs != 2 or srv.warmups != 2):
        fail(f"phase 11c: {srv.graphs} graphs and {srv.warmups} warm-ups, expected the "
             "decode graph and one prefill graph (one prompt length)")
    # every launch on the tensor cores: both counters equal, nothing else
    if cuda and (launches.get("bcsr_spmm_bf16", 0) != expect
                 or launches.get("bcsr_spmm_bf16_mma", 0) != expect
                 or set(launches) != {"bcsr_spmm_bf16", "bcsr_spmm_bf16_mma"}):
        fail(f"phase 11c launches {launches}, expected bcsr_spmm_bf16 = "
             f"bcsr_spmm_bf16_mma = {expect} and nothing else")
    rec["serve/bcsr"] = served_b
    rec["launches"] = launches
    del srv

    def core_rows(args, n_cb, dense) -> list:
        """The CUDA-core path on the same function: W1's (bm, bk) blocks cut
        into (bm, 8) ones (bk = 8 takes bcsr_bf16), X viewed to match;
        checked against the plain version (1e-5 (|A| |x|)_i, the same bits on
        a second launch) and timed as the rows above.  Not on the main path."""
        blocks, cols, indptr = args
        nb, r, c = blocks.shape
        cut = c // 8
        b8 = blocks.view(nb, r, cut, 8).permute(0, 2, 1, 3).contiguous().view(nb * cut, r, 8)
        c8 = (cols.long()[:, None] * cut + torch.arange(cut, device=dev)).reshape(-1).int()
        ip8 = (indptr * cut).int()
        if bf16_tensor_core_path(r, 8):
            fail(f"({r}, 8) blocks would take the tensor cores")
        out = []
        for k in LM_CORE_KS:
            xb = torch.as_tensor(rng.standard_normal((n_cb, c, k)).astype(np.float32),
                                 device=dev).to(torch.bfloat16)
            x8 = xb.view(n_cb * cut, 8, k)
            before = dict(_build.LAUNCHES)
            y = bcsr_spmm(b8, c8, ip8, x8)
            if cuda and (_build.LAUNCHES["bcsr_spmm_bf16"]
                         != before.get("bcsr_spmm_bf16", 0) + 1
                         or _build.LAUNCHES["bcsr_spmm_bf16_mma"]
                         != before.get("bcsr_spmm_bf16_mma", 0)):
                fail("the (bm, 8) launch was not counted as a CUDA-core launch")
            if not torch.equal(y, bcsr_spmm(b8, c8, ip8, x8)):
                fail(f"bcsr_spmm_bf16 CUDA cores k={k}: two launches differ")
            yp = bcsr_spmm_plain(*args, xb)
            scale = bcsr_spmm_plain(blocks.abs(), cols, indptr, xb.abs()).double()
            err = (y.double() - yp.double()).abs()
            if not bool((err <= TOL * scale).all()):
                fail(f"bcsr_spmm_bf16 CUDA cores k={k}: {int((err > TOL * scale).sum())} "
                     f"entries over {TOL:g} (|A| |x|)_i")
            fn_bytes = blocks.numel() * 2 + xb.numel() * 2 + y.numel() * 4
            b_s, f_s = fn_bytes / HBM_BYTES_PER_S, 2 * blocks.numel() * k / BF16_FLOPS
            row = {"name": "bcsr_spmm_bf16", "path": "CUDA cores",
                   "shape": f"{cfg.arch_id} FFN w1 as {nb * cut} blocks ({r}, 8) bf16 k={k}",
                   "max_abs_err": float(err.max()),
                   "ms": median_ms(lambda: bcsr_spmm(b8, c8, ip8, x8), True),
                   "plain_ms": median_ms(lambda: bcsr_spmm_plain(*args, xb), True),
                   "library_ms": median_ms(lambda: dense @ xb.view(-1, k), True),
                   "bound_ms": max(b_s, f_s) * 1e3,
                   "bound_by": "bytes" if b_s >= f_s else "operations"}
            out.append(row)
            print(f"  bcsr_spmm_bf16 [{row['shape']}] (CUDA cores, not on the main path): "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, dense bf16 matmul "
                  f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f}, max_abs_err "
                  f"{row['max_abs_err']:.3e}, the same bits on a second launch", flush=True)
        return out

    # (g) times of the variant and of its kernel at the FFN's shapes
    rec["times/bcsr"] = step_times(cfg_b, model_b)
    if cuda and not reduced:  # the device's idle share in one decode step
        rec["decode_profile"] = run_lm_profile([f"{LM_ARCHES[0]}/bcsr"])[
            f"{LM_ARCHES[0]}/bcsr"]
    rows = []
    for which, (args, n_cb) in weights.items():
        dense = densify(args, n_cb)
        rows += bf16_time_rows(f"{cfg.arch_id} FFN {which}", args, n_cb, dense,
                               LM_TIMED_KS, rng, median_ms, path,
                               launches=int(launches.get("bcsr_spmm_bf16_mma", 0)),
                               max_abs_err=max(errs.values()))
        if which == "w1":
            rec["cuda_core_rows"] = core_rows(args, n_cb, dense)
        del dense

    # (f) the tuned variant: impl="auto" searches W1 and W2 at k = slots
    print(f"phase 11f: impl='auto' (two searches at k = {LM_SLOTS}, scratch plan "
          "cache)", flush=True)
    cfg_auto = dataclasses.replace(cfg_b, sparse_ffn=dataclasses.replace(sff, impl="auto"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_plans_") as td:
        cache = PlanCache(Path(td) / "plans.json")
        t0 = time.perf_counter()
        srv = BatchedServer(cfg_auto, model_b, batch_slots=LM_SLOTS,
                            max_seq=LM_MAX_SEQ, plan_cache=cache)
        search_s = time.perf_counter() - t0
        plans = [{"shape": p.scale[:2], "fmt": p.fmt, "impl": p.impl,
                  "params": p.params, "measured_ms": p.measured_s * 1e3,
                  "n_measured": p.n_measured} for p in cache.plans()]
    tuned = srv.cfg.sparse_ffn
    for p in plans:
        which = "W1" if p["shape"] == [cfg.d_ff, cfg.d_model] else "W2"
        print(f"  {which} {p['shape']}: plan {p['fmt']}/{p['impl']} {p['params']} "
              f"{p['measured_ms']:.4f} ms ({p['n_measured']} measured)")
    print(f"  searched in {search_s:.1f}s: W1 -> impl {tuned.impl_for('w1')!r}, "
          f"W2 -> impl {tuned.impl_for('w2')!r}", flush=True)
    reqs = [Request(rid=i, prompt=p, max_new=LM_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    if not all(r.done for r in reqs):
        fail("phase 11f: the tuned server left requests unserved")
    rec["tuned"] = {"plans": plans, "search_s": search_s, "impl_w1": tuned.impl_for("w1"),
                    "impl_w2": tuned.impl_for("w2"), "served": len(reqs)}
    print(f"  served {len(reqs)}/{LM_REQUESTS} with the tuned routing")
    del srv

    # (e) first-token logits of the served bf16 model, kept for the float32 copy
    bf_first = torch.stack([lm.prefill(cfg_b, model_b, {"tokens": p[None]},
                                       LM_MAX_SEQ)[1][0].float() for p in prompts])
    cfg_f = dataclasses.replace(cfg_b, dtype=torch.float32)
    model_f = lm.LM(cfg_f, dev)
    model_f.load_state_dict(model_b.state_dict())
    del model_b, ffn0, weights
    free()

    # (d) consistency of the float32 copy, TF32 off
    print(f"phase 11d: float32 copy ({lm.param_count(model_f) * 4 / 1e9:.2f} GB): "
          f"prefill + {LM_NEW - 1} decode steps against forward", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    state, lg = lm.prefill(cfg_f, model_f, {"tokens": prompts[0][None]}, LM_MAX_SEQ)
    logits, toks = [lg[0]], [int(torch.argmax(lg[0]))]
    for _ in range(LM_NEW - 1):
        state, lg = lm.decode_step(cfg_f, model_f, state, [[toks[-1]]])
        logits.append(lg[0, 0])
        toks.append(int(torch.argmax(lg[0, 0])))
    seq = np.concatenate([prompts[0], np.asarray(toks[:-1], np.int32)])
    full, _ = lm.forward(cfg_f, model_f, {"tokens": seq[None]})
    worst = 0.0
    for j, got in enumerate(logits):
        ref = full[0, LM_PROMPT - 1 + j]
        rel = float((got - ref).abs().max() / ref.abs().max())
        worst = max(worst, rel)
        if not rel <= LM_CONSISTENCY:
            fail(f"phase 11d: position {LM_PROMPT - 1 + j}: decode differs from "
                 f"forward by {rel:.3e} x max|logits| (limit {LM_CONSISTENCY:g})")
    print(f"  ok decode == forward at {len(logits)} positions: worst {worst:.3e} x "
          f"max|logits| (limit {LM_CONSISTENCY:g})")
    # the same through a 1-slot server: its prefill and decode graphs on a card
    srv1 = BatchedServer(cfg_f, model_f, batch_slots=1, max_seq=LM_MAX_SEQ)
    req1 = Request(rid=0, prompt=prompts[0], max_new=LM_NEW)
    srv1.submit(req1)
    g_logits = []
    while srv1.step():
        g_logits.append(srv1.last_logits[0, 0].clone())
    seq1 = np.concatenate([prompts[0], np.asarray([req1._first] + req1.out[:-1],
                                                   np.int32)])
    full1, _ = lm.forward(cfg_f, model_f, {"tokens": seq1[None]})
    worst_g = 0.0
    for j, got in enumerate(g_logits):
        ref = full1[0, LM_PROMPT + j]
        rel = float((got - ref).abs().max() / ref.abs().max())
        worst_g = max(worst_g, rel)
        if not rel <= LM_CONSISTENCY:
            fail(f"phase 11d: server step {j}: decode differs from forward by "
                 f"{rel:.3e} x max|logits| (limit {LM_CONSISTENCY:g})")
    if cuda and srv1.graphs != 2:
        fail(f"phase 11d: the 1-slot server captured {srv1.graphs} graphs, not 2")
    print(f"  ok the 1-slot server's decode steps (graphs: {srv1.graphs}) == forward at "
          f"{len(g_logits)} positions: worst {worst_g:.3e} x max|logits|")
    del state, full, full1, srv1
    _, reqs4, served_f = serve(cfg_f, model_f, LM_SLOTS)
    for p, r in zip(prompts, reqs4):
        _, (alone,), _ = serve(cfg_f, model_f, 1, [p])
        if alone.out != r.out:
            fail(f"phase 11d: request {r.rid}: {LM_SLOTS} slots gave {r.out}, one "
                 f"slot {alone.out}")
    print(f"  ok float32 {LM_SLOTS}-slot server: every request's tokens equal a "
          "1-slot server's")
    rec["consistency"] = {"worst": worst, "worst_server_graphs": worst_g,
                          "limit": LM_CONSISTENCY, "serve_float32": served_f}

    # (e) bf16 against float32
    f_first = torch.stack([lm.prefill(cfg_f, model_f, {"tokens": p[None]},
                                      LM_MAX_SEQ)[1][0] for p in prompts])
    dev_rel = float((bf_first - f_first).abs().max() / f_first.abs().max())
    same = float((bf_first.argmax(-1) == f_first.argmax(-1)).float().mean())
    print(f"phase 11e: bf16 first-token logits against the float32 copy: largest "
          f"deviation {dev_rel:.4e} x max|logits| (limit {LM_BF16_LIMIT:g}), equal "
          f"first tokens {same * 100:.1f} %", flush=True)
    if not dev_rel <= LM_BF16_LIMIT:
        fail(f"phase 11e: bf16 deviates {dev_rel:.3e} x max|logits| from float32")
    rec["bf16_vs_f32"] = {"max_dev_rel": dev_rel, "equal_first_tokens": same,
                          "limit": LM_BF16_LIMIT}
    del model_f, bf_first, f_first
    free()
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 11 wall time {rec['wall_s']:.1f}s", flush=True)
    return launches, rows


# -- phase 12: MoE and RWKV-6 serving ---------------------------------------
MOE_ARCH, SCOUT_ARCH, RWKV_ARCH = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                                   "rwkv6-7b")
# 12d: llama4-scout's depth on one card.  A layer holds 16 experts x 3 x
# 5120 x 8192 bf16 weights (4.03 GB) and its attention (0.13 GB); embed and
# unembed 202240 x 5120 x 2 x 2 B (4.14 GB): 12 of the 48 layers take
# ~54 GB of the 80, which leaves room for the KV cache and the graphs.
SCOUT_LAYERS = 12
# 12f: the depth at which bf16 is held to its float32 copy.  These random
# inits amplify bf16 rounding with depth, in the JAX package as in the port:
# at the reduced width bf16 deviates 0.007-0.03 x max|logits| from float32
# at 2 layers and 0.45-1.3 at the full configs' 24 and 32, in both packages
# (tests/test_torch_models.py::
# test_bf16_deviation_from_float32_grows_with_depth_in_both_packages), so
# 5e-2 can tell a wrong path from rounding only at a few layers (PERF.md §2)
BF16_CHECK_LAYERS = 2
COMBINE_ROWS = 4  # 12c: x of 4 rows x LM_PROMPT tokens through one granite layer


@contextlib.contextmanager
def forcing_routes(ids_seq):
    """Every MoE layer call routes to the next ids of ``ids_seq`` (in call
    order), its gate weights the softmax of its own router logits there:
    a float32 copy run on the routing a bf16 model chose.  Fails unless
    exactly ``len(ids_seq)`` calls went through ``moe._route``."""
    import torch

    from repro_torch.models import moe as moe_mod

    it, orig, used = iter(ids_seq), moe_mod._route, [0]

    def forced(p, x, cfg, aux=True):
        ids = next(it, None)
        if ids is None:
            fail(f"forcing_routes: more MoE layer calls than the {len(ids_seq)} recorded")
        used[0] += 1
        logits = x.float() @ p.router.float()
        return torch.softmax(logits.gather(-1, ids), dim=-1), ids, 0.0, 0.0

    moe_mod._route = forced
    try:
        yield
    finally:
        moe_mod._route = orig
    if used[0] != len(ids_seq):
        fail(f"forcing_routes: {used[0]} MoE layer calls routed, expected {len(ids_seq)}")


@contextlib.contextmanager
def recording_routes(calls: int):
    """Every MoE layer call's routing ids (b, s, k), in call order.  Fails
    unless exactly ``calls`` calls went through ``moe._route``."""
    from repro_torch.models import moe as moe_mod

    seen, orig = [], moe_mod._route

    def rec(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[1].clone())
        return out

    moe_mod._route = rec
    try:
        yield seen
    finally:
        moe_mod._route = orig
    if len(seen) != calls:
        fail(f"recording_routes: {len(seen)} MoE layer calls recorded, expected {calls}")


def rel_dev(a, b) -> list:
    """Each row's largest |a - b| as a share of its largest |b|."""
    return ((a - b).abs().amax(-1) / b.abs().amax(-1)).tolist()


class ServingChecks:
    """The checks phases 12 and 13 share, on one device, into one record
    ``rec``: each sub-phase's wall time and allocator peak (``begin``,
    ``end``), ``serve --arch`` (``cli``), a 4-slot server and its step
    times (``served``), float32 decode against ``forward`` and graph
    against eager (``consistency``), bf16 against its float32 copy
    (``bf16_vs_f32``; a broken limit goes to ``failures``, which the phase
    fails on at its end).  ``reduced``: a CPU rehearsal."""

    def __init__(self, dev, rec: dict, reduced: bool = False):
        self.dev, self.rec, self.reduced = dev, rec, reduced
        self.cuda = dev.type == "cuda"
        self.failures: list[str] = []


    def begin(self, name: str, text: str) -> float:
        import torch

        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        print(f"phase {name}: {text}", flush=True)
        return time.perf_counter()

    def end(self, name: str, t0: float) -> None:
        import torch

        peak = torch.cuda.max_memory_allocated() / 1e9 if self.cuda else float("nan")
        self.rec.setdefault("wall_s", {})[name] = time.perf_counter() - t0
        self.rec.setdefault("peak_gb", {})[name] = peak
        print(f"  [{name}: {time.perf_counter() - t0:.1f}s, allocator peak "
              f"{peak:.2f} GB]", flush=True)

    def cli(self, cfg_, prompt_len: int = LM_PROMPT, new: int = LM_NEW,
            max_seq: int = LM_MAX_SEQ, reduced: bool | None = None) -> dict:
        """``serve --arch``: 8/8 served, decode and prefill graphed on a
        card, no kernel launched (the path is plain torch).  ``reduced``:
        the reduced config (default: a rehearsal's)."""
        from repro_torch.kernels import _build
        from repro_torch.launch import serve as serve_cli

        reduced = self.reduced if reduced is None else reduced
        args = ["--arch", cfg_.arch_id.split("/")[0], "--requests", str(LM_REQUESTS),
                "--slots", str(LM_SLOTS), "--prompt-len", str(prompt_len),
                "--max-new", str(new), "--max-seq", str(max_seq),
                "--device", self.dev.type] + (["--reduced"] if reduced else [])
        print(f"  serve {' '.join(args)}", flush=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as td:
            stats = Path(td) / "lm.json"
            _build.reset_launches()
            serve_cli.main(args + ["--stats-json", str(stats)])
            summary = json.loads(stats.read_text())
        if summary["served"] != LM_REQUESTS:
            fail(f"serve --arch {cfg_.arch_id} served {summary['served']}/{LM_REQUESTS}")
        if self.cuda and (dict(_build.LAUNCHES) or summary["graphs"] != 2):
            fail(f"serve --arch {cfg_.arch_id}: launches {dict(_build.LAUNCHES)}, "
                 f"{summary['graphs']} graphs (expected none, and 2)")
        return summary

    def served(self, cfg_, model, bench, per_pass: dict | None = None,
               per_prefill: dict | None = None) -> dict:
        """A 4-slot server over the 8 prompts (graphed on a card), then the
        step times and the bound.  ``per_pass``: the launches each prefill,
        decode step and warm-up pass must make, counted over the serving
        run alone (none when None); ``per_prefill``: a prefill's and its
        warm-up's where they differ from a decode step's."""
        from repro_torch.kernels import _build

        _build.reset_launches()
        srv, _, stats = bench.serve(cfg_, model, LM_SLOTS)
        launches = dict(_build.LAUNCHES)
        passes = srv.prefills + srv.steps + srv.warmups
        decode_warmups = int(srv._decode is not None)
        steps = srv.steps + decode_warmups
        prefills = srv.prefills + srv.warmups - decode_warmups
        per_prefill = per_pass if per_prefill is None else per_prefill
        expect = {k: v * steps + (per_prefill or {}).get(k, 0) * prefills
                  for k, v in (per_pass or {}).items()}
        if self.cuda and (srv.graphs != 2 or srv.warmups != 2 or launches != expect):
            fail(f"{cfg_.arch_id}: {srv.graphs} graphs, {srv.warmups} warm-ups, launches "
                 f"{launches} (expected the decode graph and one prefill graph, and "
                 f"launches {expect or 'none'})")
        print(f"  {cfg_.arch_id}: served {LM_REQUESTS}/{LM_REQUESTS} in "
              f"{stats['seconds']:.2f}s ({stats['tok_per_s']:.1f} tok/s, latency p50 "
              f"{stats['latency_p50_s']:.2f}s p99 {stats['latency_p99_s']:.2f}s), "
              f"every token < vocab {cfg_.vocab}; {srv.graphs} CUDA graphs captured in "
              f"{srv.capture_s:.2f}s; launches {launches} over {srv.prefills} prefills, "
              f"{srv.steps} decode steps and {srv.warmups} warm-ups", flush=True)
        stats.update(launches=launches, passes=passes)
        del srv
        bench.free()
        return {"serve": stats, "times": bench.step_times(cfg_, model)}

    def first_logits(self, cfg_, model, prompts, extras=None):
        import torch

        from repro_torch.models import lm

        extras = extras or [{} for _ in prompts]
        return torch.stack([lm.prefill(cfg_, model, self.batch(p, x), LM_MAX_SEQ)[1][0]
                            .float() for p, x in zip(prompts, extras)])

    def batch(self, prompt, extras) -> dict:
        """The batch-1 model inputs of a prompt and its modality inputs, on
        the device."""
        import torch

        from repro_torch.runtime.server import prompt_batch

        return {k: torch.as_tensor(v, device=self.dev)
                for k, v in prompt_batch(prompt, **extras).items()}

    def copy_as(self, model, cfg_to):
        """``model``'s weights in ``cfg_to``'s dtype, at its first n_layers
        (a hybrid: its first n_layers // hybrid_period super-blocks and
        their LoRA)."""
        from repro_torch.models import lm

        hybrid = cfg_to.family == "hybrid"
        n = cfg_to.n_layers // cfg_to.hybrid_period if hybrid else cfg_to.n_layers
        copy = lm.LM(cfg_to, self.dev)
        copy.load_state_dict({k: v[:n] if k in ("lora_a", "lora_b") else v
                              for k, v in model.state_dict().items()
                              if not k.startswith("blocks.") or int(k.split(".")[1]) < n})
        return copy

    def consistency(self, cfg_f, model_f, prompts, name: str, extras=None,
                    new: int = LM_NEW, max_seq: int = LM_MAX_SEQ) -> dict:
        """float32, TF32 off: prefill + ``new`` - 1 greedy decode steps
        against ``forward`` at every position (LM_CONSISTENCY; a VLM's
        forward at the positions decode gives the new tokens: s, s + 1, ...
        on all three streams), and one replay of a 4-slot server's decode
        graph against eager ``decode_step`` on a copy of its state, bit for
        bit; with modality inputs (``extras``) also the prefill graph's
        last replay against eager ``prefill`` on the same request."""
        import numpy as np
        import torch

        from repro_torch.models import lm
        from repro_torch.runtime.server import BatchedServer, _merge_slot

        torch.backends.cuda.matmul.allow_tf32 = False
        extras = extras or [{} for _ in prompts]
        state, lg = lm.prefill(cfg_f, model_f, self.batch(prompts[0], extras[0]), max_seq)
        logits, toks = [lg[0]], [int(torch.argmax(lg[0, :cfg_f.vocab]))]
        for _ in range(new - 1):
            state, lg = lm.decode_step(cfg_f, model_f, state, [[toks[-1]]])
            logits.append(lg[0, 0])
            toks.append(int(torch.argmax(lg[0, 0, :cfg_f.vocab])))
        s0 = len(prompts[0])
        seq = np.concatenate([prompts[0], np.asarray(toks[:-1], np.int32)])
        x0 = dict(extras[0])
        if "positions" in x0:
            x0["positions"] = np.concatenate([x0["positions"], np.broadcast_to(
                np.arange(s0, len(seq), dtype=np.int32), (3, len(seq) - s0))], axis=1)
        full, _ = lm.forward(cfg_f, model_f, self.batch(seq, x0))
        worst = 0.0
        for j, got in enumerate(logits):
            ref = full[0, s0 - 1 + j]
            rel = float((got - ref).abs().max() / ref.abs().max())
            worst = max(worst, rel)
            if not rel <= LM_CONSISTENCY:
                fail(f"phase {name}: position {s0 - 1 + j}: decode differs from "
                     f"forward by {rel:.3e} x max|logits| (limit {LM_CONSISTENCY:g})")
        print(f"  ok {cfg_f.arch_id} float32 decode == forward at {len(logits)} "
              f"positions: worst {worst:.3e} x max|logits| (limit {LM_CONSISTENCY:g})",
              flush=True)
        del state, full
        srv = BatchedServer(cfg_f, model_f, batch_slots=LM_SLOTS, max_seq=max_seq)
        for i in range(LM_SLOTS):
            one, lg1 = srv._prefill_one(prompts[i], **extras[i])
            _merge_slot(srv.state, one, i)
        prefill_bitwise = None
        if srv._prefill and any(extras):  # the last replay's state and logits
            st_e, lg_e = lm.prefill(cfg_f, model_f, self.batch(prompts[LM_SLOTS - 1],
                                                               extras[LM_SLOTS - 1]), max_seq)
            prefill_bitwise = bool(torch.equal(lg1, lg_e)) and all(
                torch.equal(one[g][k], t) for g, leaves in st_e.items()
                for k, t in leaves.items())
            if not prefill_bitwise:
                fail(f"phase {name}: the prefill graph's replay differs from eager prefill "
                     "on the same request (logits or state)")
            print(f"  ok the prefill graph's replay of request {LM_SLOTS - 1} (its own "
                  "inputs copied in) == eager prefill bit for bit (logits and every "
                  "state leaf)", flush=True)
            del st_e, lg_e
        twin = {g: {k: t.clone() for k, t in leaves.items()}
                for g, leaves in srv.state.items()}
        toks = torch.as_tensor([[int(p[-1])] for p in prompts[:LM_SLOTS]], device=self.dev)
        _, eager = lm.decode_step(cfg_f, model_f, twin, toks)
        bitwise = None
        if srv._decode is not None:
            graph, tokens, _, logits_g = srv._decode
            tokens.copy_(toks)
            graph.replay()
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(logits_g, eager)) and all(
                torch.equal(srv.state[g][k], t)
                for g, leaves in twin.items() for k, t in leaves.items())
            if not bitwise:
                fail(f"phase {name}: the decode graph's step differs from eager "
                     "decode_step (logits or state)")
            print("  ok one graphed decode step == its eager twin bit for bit "
                  "(logits and every state leaf)", flush=True)
        del srv, twin
        return {"worst": worst, "limit": LM_CONSISTENCY, "graph_bitwise": bitwise,
                "prefill_graph_bitwise": prefill_bitwise}

    def bf16_vs_f32(self, cfg_b, model_b, model_f, prompts, layers: int, held: bool,
                    label: str = "12f", extras=None) -> dict:
        """Phase ``label`` over the first ``layers`` layers of the served bf16 model and
        its float32 copy ``model_f`` (cut copies of both below full
        depth): first-token logits as a share of max|logits| per prompt;
        for a MoE, the share of (token, layer) routing decisions that pick
        the same experts and the float32 copy on the bf16 model's routing.
        ``held``: LM_BF16_LIMIT holds on every prompt whose routing agrees
        and, on the bf16 routing, on every prompt; a broken limit is
        recorded in ``self.failures``, which fail the phase at its end."""
        import torch

        name = f"{cfg_b.arch_id}, {layers} of {cfg_b.n_layers} layers"
        cut = dataclasses.replace(cfg_b, n_layers=layers)
        cut_f = dataclasses.replace(cut, dtype=torch.float32)
        if layers != cfg_b.n_layers:
            model_b, model_f = self.copy_as(model_b, cut), self.copy_as(model_b, cut_f)
        moe = cut.moe is not None
        calls = layers * len(prompts)  # one prefill a prompt, one route a layer
        with recording_routes(calls) if moe else contextlib.nullcontext() as rb:
            bf = self.first_logits(cut, model_b, prompts, extras)
        with recording_routes(calls) if moe else contextlib.nullcontext() as rf:
            f32 = self.first_logits(cut_f, model_f, prompts, extras)
        dv = rel_dev(bf, f32)
        out = {"layers": layers, "dev_rel": dv, "limit": LM_BF16_LIMIT, "held": held,
               "equal_first_tokens": float((bf.argmax(-1) == f32.argmax(-1)).float().mean())}
        flips = [0] * len(prompts)
        if moe:
            for i, (a_, b_) in enumerate(zip(rb, rf)):  # prompt i // layers
                flips[i // layers] += int((a_.sort(-1).values != b_.sort(-1).values)
                                          .any(-1).sum())
            total = sum(a_.shape[0] * a_.shape[1] for a_ in rb)
            out["routing_agree_share"] = 1 - sum(flips) / total
            out["flipped_decisions_per_prompt"] = flips
            with forcing_routes(rb):
                on = rel_dev(bf, self.first_logits(cut_f, model_f, prompts))
            out["dev_rel_on_bf16_routing"] = on
            print(f"  {name}: bf16 and float32 pick the same experts at "
                  f"{out['routing_agree_share'] * 100:.2f} % of (token, layer) decisions "
                  f"({sum(f > 0 for f in flips)}/{len(flips)} prompts with a flip); on the "
                  f"bf16 model's routing the float32 copy deviates {min(on):.4e}-"
                  f"{max(on):.4e} x max|logits|", flush=True)
        for i, (d_, f_) in enumerate(zip(dv, flips)):
            print(f"    prompt {i}: bf16 deviates {d_:.4e} x max|logits|"
                  + (f" (its routing differs at {f_} decisions: reported, not held)"
                     if f_ else ""))
        agreeing = [d_ for d_, f_ in zip(dv, flips) if not f_]
        print(f"  {name}: largest deviation {max(dv):.4e} x max|logits|, equal first "
              f"tokens {out['equal_first_tokens'] * 100:.1f} %; "
              + ("reported, not held" if not held
                 else f"held to {LM_BF16_LIMIT:g} on every prompt" if not moe
                 else f"held to {LM_BF16_LIMIT:g} on the {len(agreeing)}/{len(dv)} prompts "
                 "whose routing agrees and on the bf16 routing"), flush=True)
        if held:
            if agreeing and not max(agreeing) <= LM_BF16_LIMIT:
                self.failures.append(f"{label} {name}: bf16 deviates {max(agreeing):.3e} x "
                                "max|logits| from float32 on a prompt whose routing agrees")
            if moe and not max(out["dev_rel_on_bf16_routing"]) <= LM_BF16_LIMIT:
                self.failures.append(f"{label} {name}: on the bf16 routing, bf16 deviates "
                                f"{max(out['dev_rel_on_bf16_routing']):.3e} x max|logits|")
        return out

def moe_ssm_phase(dev, record: dict, *, reduced: bool = False) -> dict:
    """Phase 12: MoE and RWKV-6 serving (``reduced``: the reduced configs,
    a CPU rehearsal with no times or launch checks).  Returns 12c's launch
    counts, the kernel rows' ``moe_launches``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmspv import SCATTER_LAUNCHES
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod

    rec = record.setdefault("moe_ssm", {})
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    get = get_reduced if reduced else get_config
    moe_launches: collections.Counter = collections.Counter()
    chk = ServingChecks(dev, rec, reduced)

    # -- granite-moe-1b-a400m ------------------------------------------------
    cfg = get(MOE_ARCH)
    rng = np.random.default_rng(0)  # the CLI's prompts, drawn the same way
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    bench = LMBench(dev, prompts)
    t0 = chk.begin("12a", f"{cfg.arch_id} bf16, {cfg.n_layers} layers, d {cfg.d_model}, "
                      f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
                      f"{cfg.moe.d_ff}")
    rec["cli/" + MOE_ARCH] = chk.cli(cfg)
    bench.free()
    model = lm.init_model(cfg, 0, device=dev)
    rec["granite_params"] = lm.param_count(model)
    print(f"  {rec['granite_params'] / 1e9:.3f} G parameters "
          f"({sum(t.numel() * t.element_size() for t in model.parameters()) / 1e9:.2f} GB)")
    rec["granite"] = chk.served(cfg, model, bench)
    chk.end("12a", t0)

    # 12c: the MoE combine through kernel 4, one layer at full width, float32
    t0 = chk.begin("12c", f"moe_apply_spmspv(impl='cuda') on layer 0's experts (float32 copy), "
                      f"x {COMBINE_ROWS} rows x {LM_PROMPT} tokens")
    src = model.blocks[0].ffn
    p32 = moe_mod.MoE(cfg.d_model, cfg.moe, torch.float32, dev)
    for key in ("router", "wi_gate", "wi_up", "wo"):
        getattr(p32, key).copy_(getattr(src, key))
    x = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (COMBINE_ROWS, LM_PROMPT, cfg.d_model)).astype(np.float32), device=dev)
    b, s_, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    rec["combine"] = {}
    for cf in (E / k, cfg.moe.capacity_factor):
        mcfg = dataclasses.replace(cfg.moe, capacity_factor=cf)
        out_flat, dest, weights, _, _, C = moe_mod._dispatch_expert_outputs(
            p32, x, mcfg, aux=False)
        # (|A| |x|)_i of the products behind each output: the experts' wo
        # against the gate-weighted h (and what reordering the gate and up
        # products' sums can move h by)
        scale = moe_mod._combine_scale(p32, x, mcfg)
        nonempty = int((dest.reshape(b, s_, k) < E * C).any(-1).sum())
        dropped = int((dest == E * C).sum())
        bench.sync()
        _build.reset_launches()
        t1 = time.perf_counter()
        y = moe_mod.moe_apply_spmspv(p32, x, mcfg, impl="cuda")
        bench.sync()
        wall = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
        moe_launches.update(launches)
        # the same combine of the dispatch's operands through the plain
        # version on the CPU, whose index_add_ sums in stream order
        t1 = time.perf_counter()
        y_plain = moe_mod.moe_combine_spmspv(out_flat.cpu(), dest.cpu(), weights.cpu(),
                                             impl="cuda")
        wall_plain = time.perf_counter() - t1
        n_diff = int((y.cpu().view(torch.int32) != y_plain.view(torch.int32)).sum())
        del out_flat, weights
        no_drop = cf >= E / k
        ref = (moe_mod.moe_apply_dense_ref(p32, x, mcfg) if no_drop
               else moe_mod.moe_apply(p32, x, mcfg, aux=False)[0])
        t1 = time.perf_counter()
        moe_mod.moe_apply(p32, x, mcfg, aux=False)
        bench.sync()
        wall_apply = time.perf_counter() - t1
        err = (y.double() - ref.double()).abs()
        ratio = float((err / scale.clamp_min(1e-300)).max())
        what = ("moe_apply_dense_ref" if no_drop else "moe_apply")
        if cuda and (launches.get("spmspv_scatter", 0) != nonempty * SCATTER_LAUNCHES
                     or set(launches) != {"spmspv_scatter"}):
            fail(f"12c cf={cf}: launches {launches}, expected spmspv_scatter = "
                 f"{nonempty * SCATTER_LAUNCHES} ({SCATTER_LAUNCHES} per token with a "
                 f"kept slot) and nothing else")
        if n_diff:
            fail(f"12c cf={cf}: the combine through the kernel differs in {n_diff} "
                 "entries' bits from the same combine through the plain version on "
                 "the CPU")
        if no_drop and (dropped or nonempty != b * s_):
            fail(f"12c cf={cf}: {dropped} slots dropped where none may")
        if not bool((err <= TOL * scale).all()):
            fail(f"12c cf={cf}: the combine through the kernel differs from {what} by "
                 f"{ratio:.3e} (|A| |x|)_i at worst (limit {TOL:g})")
        rec["combine"][f"cf{cf:g}"] = {
            "C": C, "dropped_slots": dropped, "tokens": b * s_, "launches": launches,
            "bits_differing_from_cpu_plain": n_diff,
            "apply_sparse_calls": b * s_, "nonempty_tokens": nonempty,
            "max_abs_err": float(err.max()), "worst_ratio": ratio,
            "spmspv_wall_s": wall, "cpu_plain_combine_wall_s": wall_plain,
            "moe_apply_wall_s": wall_apply, "oracle": what}
        print(f"  ok capacity_factor {cf:g} (C = {C}, {dropped} slots dropped): the "
              f"combine through the kernel == the plain combine on the CPU bit for bit, "
              f"and == {what} within {TOL:g} (|A| |x|)_i (worst "
              f"{ratio:.3e}, max_abs_err {float(err.max()):.3e}); launches {launches} "
              f"for {b * s_} apply_sparse calls ({nonempty} with a kept slot); host-side "
              f"{wall:.2f}s against moe_apply's {wall_apply * 1e3:.2f} ms", flush=True)
        del y, y_plain, ref, err, scale
    del p32, x, src
    chk.end("12c", t0)

    # 12f: bf16 against its float32 copy, at full depth and at BF16_CHECK_LAYERS
    cfg_f = dataclasses.replace(cfg, dtype=torch.float32)
    model_f = chk.copy_as(model, cfg_f)
    t0 = chk.begin("12f", f"{cfg.arch_id}: bf16 first-token logits against the float32 copy "
                      f"(capacity_factor {cfg.moe.capacity_factor:g})")
    rec["bf16_vs_f32/granite"] = chk.bf16_vs_f32(cfg, model, model_f, prompts,
                                             cfg.n_layers, held=False)
    rec["bf16_vs_f32/granite/cut"] = chk.bf16_vs_f32(cfg, model, model_f, prompts,
                                                 min(BF16_CHECK_LAYERS, cfg.n_layers),
                                                 held=True)
    del model
    bench.free()
    chk.end("12f", t0)

    # 12b: the float32 copy's consistency
    nodrop = dataclasses.replace(cfg_f, moe=dataclasses.replace(
        cfg.moe, capacity_factor=E / k))
    t0 = chk.begin("12b", f"float32 copy ({lm.param_count(model_f) * 4 / 1e9:.2f} GB, all "
                      f"{cfg_f.n_layers} layers) at capacity_factor E / top_k = "
                      f"{E / k:g}, where nothing drops (at {cfg.moe.capacity_factor:g} "
                      "forward's capacity grows with the sequence, a decode step's is "
                      "one slot)")
    rec["consistency/granite"] = chk.consistency(nodrop, model_f, prompts, "12b")
    _, reqs4, _ = bench.serve(nodrop, model_f, LM_SLOTS)
    for p_, r in zip(prompts, reqs4):
        _, (alone,), _ = bench.serve(nodrop, model_f, 1, [p_])
        if alone.out != r.out:
            fail(f"12b: request {r.rid}: {LM_SLOTS} slots gave {r.out}, one slot "
                 f"{alone.out}")
    print(f"  ok float32 {LM_SLOTS}-slot server: every request's tokens equal a 1-slot "
          "server's", flush=True)
    del model_f
    bench.free()
    chk.end("12b", t0)

    # -- llama4-scout-17b-a16e, cut in depth ------------------------------
    full = get(SCOUT_ARCH)
    layers = min(SCOUT_LAYERS, full.n_layers)
    cfg_s = dataclasses.replace(full, n_layers=layers)
    (qd, kvd), ms = cfg_s.qkv_dims, cfg_s.moe
    layer_bytes = 2 * (3 * ms.n_experts * cfg_s.d_model * ms.d_ff
                       + 2 * cfg_s.d_model * (qd + kvd) + 2 * cfg_s.d_model) \
        + 4 * cfg_s.d_model * ms.n_experts
    table_bytes = 2 * 2 * cfg_s.vocab_padded * cfg_s.d_model
    t0 = chk.begin("12d", f"{SCOUT_ARCH} at full width (d {cfg_s.d_model}, {ms.n_experts} "
                      f"experts top-{ms.top_k} of d_ff {ms.d_ff}), cut to {layers} of "
                      f"{full.n_layers} layers: reckoned {layer_bytes / 1e9:.2f} GB a "
                      f"layer + {table_bytes / 1e9:.2f} GB embed/unembed = "
                      f"{(layers * layer_bytes + table_bytes) / 1e9:.1f} GB in bf16")
    rng = np.random.default_rng(0)
    prompts_s = [rng.integers(0, cfg_s.vocab, LM_PROMPT).astype(np.int32)
                 for _ in range(LM_REQUESTS)]
    bench_s = LMBench(dev, prompts_s)
    model = lm.init_model(cfg_s, 0, device=dev)
    rec["scout"] = {"layers": layers, "of": full.n_layers,
                    "reckoned_gb": (layers * layer_bytes + table_bytes) / 1e9,
                    **chk.served(cfg_s, model, bench_s)}
    del model
    bench_s.free()
    chk.end("12d", t0)

    # -- rwkv6-7b ------------------------------------------------------------
    cfg_r = get(RWKV_ARCH)
    rng = np.random.default_rng(0)
    prompts_r = [rng.integers(0, cfg_r.vocab, LM_PROMPT).astype(np.int32)
                 for _ in range(LM_REQUESTS)]
    bench_r = LMBench(dev, prompts_r)
    t0 = chk.begin("12e", f"{cfg_r.arch_id} bf16, {cfg_r.n_layers} layers, d {cfg_r.d_model}, "
                      f"d_ff {cfg_r.d_ff}, vocab {cfg_r.vocab}")
    rec["cli/" + RWKV_ARCH] = chk.cli(cfg_r)
    bench_r.free()
    model = lm.init_model(cfg_r, 0, device=dev)
    rec["rwkv_params"] = lm.param_count(model)
    print(f"  {rec['rwkv_params'] / 1e9:.3f} G parameters "
          f"({sum(t.numel() * t.element_size() for t in model.parameters()) / 1e9:.2f} GB)")
    rec["rwkv"] = chk.served(cfg_r, model, bench_r)
    cfg_rf = dataclasses.replace(cfg_r, dtype=torch.float32)
    model_f = chk.copy_as(model, cfg_rf)
    print(f"  float32 copy ({lm.param_count(model_f) * 4 / 1e9:.2f} GB, all "
          f"{cfg_rf.n_layers} layers)", flush=True)
    chk.end("12e", t0)
    t0 = chk.begin("12f", f"{cfg_r.arch_id}: bf16 first-token logits against the float32 copy")
    rec["bf16_vs_f32/rwkv"] = chk.bf16_vs_f32(cfg_r, model, model_f, prompts_r,
                                          cfg_r.n_layers, held=False)
    rec["bf16_vs_f32/rwkv/cut"] = chk.bf16_vs_f32(cfg_r, model, model_f, prompts_r,
                                              min(BF16_CHECK_LAYERS, cfg_r.n_layers),
                                              held=True)
    del model
    bench_r.free()
    chk.end("12f/rwkv", t0)
    t0 = chk.begin("12e", f"{cfg_r.arch_id} float32 copy: decode against forward, graph "
                      "against eager")
    rec["consistency/rwkv"] = chk.consistency(cfg_rf, model_f, prompts_r, "12e")
    del model_f
    bench_r.free()
    chk.end("12e/float32", t0)

    if cuda and not reduced:  # the device's idle share in one decode step
        rec["decode_profile"] = run_lm_profile([MOE_ARCH, RWKV_ARCH])
    rec["moe_launches"] = dict(moe_launches)
    rec["total_s"] = time.perf_counter() - t_phase
    print(f"  phase 12 wall time {rec['total_s']:.1f}s", flush=True)
    if chk.failures:
        fail("phase " + "; ".join(chk.failures))
    return dict(moe_launches)


# -- phase 13: hybrid serving (zamba2) ---------------------------------------
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_KS = (4, 32)  # 13c: the shared FFN's widths, decode at 4 slots and the prefill


def perturb_hybrid(model, seed: int = 0) -> None:
    """A hybrid's Mamba-2 layers and LoRA made live in place, drawn from
    ``torch.Generator(model.device).manual_seed(seed)``: ``conv_w``
    0.2·N(0, 1), ``conv_b`` 0.1·N(0, 1), ``A_log`` log U(1, 16), ``dt_bias``
    softplus⁻¹(U(0.001, 0.1)) (Mamba-2's published ranges), ``lora_b``
    0.02·N(0, 1).  At init the Mamba-2 layers are the identity and the
    LoRA zero, as in the JAX package (ROADMAP C.23), so a check on those
    weights would pass with a wrong SSD."""
    import torch

    gen = torch.Generator(device=model.device).manual_seed(seed)

    def draw(t, fn):
        t.copy_(fn(torch.empty(t.shape, dtype=torch.float32, device=t.device)))

    for group in model.blocks:
        for layer in group:
            m = layer.mamba
            draw(m.conv_w, lambda e: e.normal_(generator=gen).mul_(0.2))
            draw(m.conv_b, lambda e: e.normal_(generator=gen).mul_(0.1))
            draw(m.A_log, lambda e: e.uniform_(1.0, 16.0, generator=gen).log_())
            draw(m.dt_bias, lambda e: e.uniform_(0.001, 0.1, generator=gen).expm1_().log_())
    draw(model.lora_b, lambda e: e.normal_(generator=gen).mul_(0.02))


def hybrid_bounds(cfg, model, times: dict) -> dict:
    """The decode step's bytes bound (4 slots) two ways, and the prefill's.
    ``bound_ms`` charges every weight once (the shared block's ~210 MB
    read once a step, as if the 50 MB L2 kept it across its n_super
    applications), the decode state read once and its Mamba-2 part
    (conv and SSD, float32) written once; ``bound_per_application_ms``
    charges the shared block at each application.  The prefill (32
    tokens, one slot) reads every weight once and writes a one-slot
    state."""
    from repro_torch.models.mamba2 import CONV_K

    n_super, period = cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period
    d_inner = 2 * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    ch = d_inner + 2 * cfg.ssm_state
    mamba = n_super * period * LM_SLOTS * 4 * (
        (CONV_K - 1) * ch + H * cfg.ssm_head_dim * cfg.ssm_state)
    shared = sum(t.numel() * t.element_size() for t in model.shared.parameters())
    shared += sum(t.numel() * t.element_size() for name, t in model.shared.named_buffers()
                  if name.endswith(("_cols", "_indptr")))
    once = times["decode_weight_bytes"] + times["state_bytes"] + mamba
    per_app = once + (n_super - 1) * shared
    prefill = times["decode_weight_bytes"] + times["state_bytes"] / LM_SLOTS
    out = {"bytes": once, "bound_ms": once / HBM_BYTES_PER_S * 1e3,
           "bytes_per_application": per_app,
           "bound_per_application_ms": per_app / HBM_BYTES_PER_S * 1e3,
           "shared_block_bytes": shared, "mamba_state_bytes": mamba,
           "prefill_bytes": prefill, "prefill_bound_ms": prefill / HBM_BYTES_PER_S * 1e3}
    print(f"  the step's bound {out['bound_ms']:.3f} ms ({once / 1e9:.3f} GB: weights "
          f"once, the state read and its float32 Mamba-2 part ({mamba / 1e6:.1f} MB) "
          f"written); the shared block ({shared / 1e6:.1f} MB) charged at each of its "
          f"{n_super} applications {out['bound_per_application_ms']:.3f} ms "
          f"({per_app / 1e9:.3f} GB); the prefill's {out['prefill_bound_ms']:.3f} ms",
          flush=True)
    return out


def hybrid_phase(dev, record: dict, *, reduced: bool = False) -> tuple[dict, list]:
    """Phase 13: zamba2-2.7b serving at full width and depth in bf16, its
    weights from seed 0 perturbed (``perturb_hybrid``); ``reduced``: the
    reduced config, a CPU rehearsal with no times or launch checks.
    Returns 13c's launch counts (the kernel rows' ``hybrid_launches``) and
    the ``bcsr_spmm_bf16`` rows at the shared FFN's shapes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels.bcsr_spmm import bf16_tensor_core_path
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig

    rec = record.setdefault("hybrid", {})
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    chk = ServingChecks(dev, rec, reduced)
    cfg = (get_reduced if reduced else get_config)(HYBRID_ARCH)
    n_super = cfg.n_layers // cfg.hybrid_period
    block = (32, 32) if reduced else (128, 128)
    rng = np.random.default_rng(0)  # the CLI's prompts, drawn the same way
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    bench = LMBench(dev, prompts)

    def build(cfg_):
        model = lm.init_model(cfg_, 0, device=dev)
        perturb_hybrid(model, 0)
        return model

    # 13a: the CLI (its own weights, from seed 0 unperturbed: it serves)
    t0 = chk.begin("13a", f"{cfg.arch_id} bf16, {cfg.n_layers} Mamba-2 layers in {n_super} "
                          f"super-blocks of {cfg.hybrid_period}, d {cfg.d_model}, "
                          f"{cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, ssm_state "
                          f"{cfg.ssm_state}, ssm_head_dim {cfg.ssm_head_dim}, LoRA rank "
                          f"{cfg.lora_rank}")
    rec["cli"] = chk.cli(cfg)
    bench.free()
    chk.end("13a", t0)

    # 13b: dense shared FFN
    t0 = chk.begin("13b", f"{LM_SLOTS}-slot BatchedServer, dense shared FFN, perturbed "
                          "weights")
    model = build(cfg)
    rec["params"] = lm.param_count(model)
    print(f"  {rec['params'] / 1e9:.3f} G parameters "
          f"({sum(t.numel() * t.element_size() for t in model.parameters()) / 1e9:.2f} GB)")
    rec["dense"] = chk.served(cfg, model, bench)
    rec["dense"]["bounds"] = hybrid_bounds(cfg, model, rec["dense"]["times"])
    chk.end("13b", t0)

    # 13e: bf16 against its float32 copy, over the first super-block (held)
    # and at full depth (reported)
    cfg_f = dataclasses.replace(cfg, dtype=torch.float32)
    model_f = chk.copy_as(model, cfg_f)
    t0 = chk.begin("13e", f"{cfg.arch_id}: bf16 first-token logits against the float32 "
                          "copy")
    rec["bf16_vs_f32"] = chk.bf16_vs_f32(cfg, model, model_f, prompts, cfg.n_layers,
                                         held=False, label="13e")
    rec["bf16_vs_f32/cut"] = chk.bf16_vs_f32(cfg, model, model_f, prompts,
                                             cfg.hybrid_period, held=True, label="13e")
    del model
    bench.free()
    chk.end("13e", t0)

    # 13d: the float32 copy, TF32 off: decode against forward, graph against eager
    t0 = chk.begin("13d", f"float32 copy ({lm.param_count(model_f) * 4 / 1e9:.2f} GB, all "
                          f"{cfg.n_layers} layers), dense shared FFN")
    rec["consistency/dense"] = chk.consistency(cfg_f, model_f, prompts, "13d")
    del model_f
    bench.free()
    chk.end("13d", t0)

    # 13c: the bcsr shared FFN on the bf16 kernel
    sff = SparseFFNConfig(kind="bcsr", block=block)
    cfg_b = dataclasses.replace(cfg, sparse_ffn=sff)
    model_b = build(cfg_b)
    ffn = model_b.shared.ffn
    t0 = chk.begin("13c", f"bcsr shared FFN {block}, density {sff.density}: W1 "
                          f"{ffn.w1_blocks.shape[0]} blocks, W2 {ffn.w2_blocks.shape[0]} "
                          f"blocks; {lm.param_count(model_b) / 1e9:.3f} G parameters")
    bm, bk = block
    path = "tensor cores" if bf16_tensor_core_path(bm, bk) else "CUDA cores"
    weights = ffn_weights(ffn, cfg_b)
    errs = {}
    for which, (args, n_cb) in weights.items():
        errs.update(check_bf16_products(f"shared {which}", args, n_cb, HYBRID_KS, rng,
                                        dev, path, key=which))
    rec["kernel_checks"] = errs
    per_pass = 2 * n_super  # W1 and W2 at each application of the shared block
    served_b = chk.served(cfg_b, model_b, bench, per_pass={
        "bcsr_spmm_bf16": per_pass, "bcsr_spmm_bf16_mma": per_pass} if cuda else None)
    served_b["bounds"] = hybrid_bounds(cfg_b, model_b, served_b["times"])
    launches = served_b["serve"]["launches"]
    rec["bcsr"] = served_b
    rows = []
    for which, (args, n_cb) in weights.items():
        dense = densify(args, n_cb)
        rows += bf16_time_rows(f"{cfg.arch_id} shared FFN {which}", args, n_cb, dense,
                               HYBRID_KS, rng, bench.median_ms, path,
                               launches=int(launches.get("bcsr_spmm_bf16_mma", 0)),
                               max_abs_err=max(errs.values()))
        del dense
    cfg_bf = dataclasses.replace(cfg_b, dtype=torch.float32)
    model_bf = chk.copy_as(model_b, cfg_bf)
    del model_b, ffn, weights
    bench.free()
    chk.end("13c", t0)
    t0 = chk.begin("13d", f"float32 copy of the bcsr variant ({lm.param_count(model_bf) * 4 / 1e9:.2f} "
                          "GB; float32 kernel)")
    rec["consistency/bcsr"] = chk.consistency(cfg_bf, model_bf, prompts, "13d")
    del model_bf
    bench.free()
    chk.end("13d/bcsr", t0)

    if cuda and not reduced:  # the device's idle share in one decode step
        rec["decode_profile"] = run_lm_profile([HYBRID_ARCH, f"{HYBRID_ARCH}/bcsr"])
    rec["launches"] = launches
    rec["total_s"] = time.perf_counter() - t_phase
    print(f"phase 13f: phase 13 wall time {rec['total_s']:.1f}s", flush=True)
    if chk.failures:
        fail("phase " + "; ".join(chk.failures))
    return launches, rows


# -- phase 14: audio and VLM serving (whisper-tiny, qwen2-vl-72b) ------------
AV_ARCH, VL_ARCH = "whisper-tiny", "qwen2-vl-72b"
AV_PROMPT, AV_NEW = 4, 32  # (a): 1500 frames and a 4-token prompt, 32 new tokens
VL_TEXT, VL_NEW, VL_MAX_SEQ = 32, 16, 320  # (b): 256 vision slots + 32 text tokens
# (b), 18f: qwen2-vl-72b's 80 layers (145 GB in bf16), deepseek-67b's 95 and
# llama3-405b's 126 do not fit one card: the depth whose bf16 weights fit this
# budget, which leaves room for the caches, the graphs and the check copies
VL_WEIGHT_BUDGET = 48e9


def vl_layers(cfg) -> tuple[int, float]:
    """(the depth phases 14 and 18 serve ``cfg`` at, its bf16 weight
    bytes): the deepest cut whose weights fit VL_WEIGHT_BUDGET, full depth
    where they fit.  A layer is reckoned as a decoder layer of the dense
    and VLM families (q, k, v, o, SwiGLU and two norms; embed and unembed
    beside); phase 12 cuts the MoE llama4-scout itself (SCOUT_LAYERS)."""
    d, f, (qd, kvd) = cfg.d_model, cfg.d_ff, cfg.qkv_dims
    layer = 2 * (2 * d * qd + 2 * d * kvd + 3 * d * f + 2 * d)
    table = 2 * 2 * cfg.vocab_padded * d
    layers = max(1, min(cfg.n_layers, int((VL_WEIGHT_BUDGET - table) // layer)))
    return layers, layers * layer + table


def av_traffic(cfg, n: int) -> tuple[list, list]:
    """Phase 14's n requests to ``cfg`` (prompts, modality inputs), drawn
    as ``serve --arch`` draws them from ``default_rng(0)``: whisper a
    AV_PROMPT-token prompt and its frames; a VLM n_vision_tokens vision
    slots + VL_TEXT text tokens, the vision embeddings and Qwen2-VL-layout
    positions."""
    import numpy as np

    from repro_torch.data.modality import request_inputs

    rng = np.random.default_rng(0)
    length = (cfg.n_vision_tokens + VL_TEXT if cfg.family == "vlm" else AV_PROMPT)
    prompts, extras = [], []
    for _ in range(n):
        prompts.append(rng.integers(0, cfg.vocab, length).astype(np.int32))
        extras.append(request_inputs(cfg, length, rng))
    return prompts, extras


def av_bounds(cfg, model, times: dict, extras: dict) -> dict:
    """The decode step's bytes bound (LM_SLOTS slots): the weights a step
    reads (every parameter but the embedding table, of which it reads
    LM_SLOTS rows, and an audio model's encoder, which only prefill runs)
    and the decode state read (the self-attention caches and whisper's
    cross keys and values); and the prefill's (one request): every weight
    once, its modality inputs read and one slot's state written."""
    enc = sum(t.numel() * t.element_size() for name, t in model.named_parameters()
              if name.startswith(("enc_blocks.", "ln_enc.")))
    enc += sum(t.numel() * t.element_size() for name, t in model.named_buffers()
               if name.startswith("enc_blocks.") and name.endswith(("_cols", "_indptr")))
    step = times["decode_weight_bytes"] - enc + times["state_bytes"]
    inputs = sum(v.nbytes for v in extras.values())
    prefill = times["decode_weight_bytes"] + inputs + times["state_bytes"] / LM_SLOTS
    out = {"bytes": step, "bound_ms": step / HBM_BYTES_PER_S * 1e3,
           "encoder_bytes": enc, "state_bytes": times["state_bytes"],
           "prefill_bytes": prefill, "prefill_bound_ms": prefill / HBM_BYTES_PER_S * 1e3}
    print(f"  the step's bound {out['bound_ms']:.4f} ms ({step / 1e9:.4f} GB: weights "
          f"but the encoder's ({enc / 1e6:.1f} MB) and the table, the decode state "
          f"({times['state_bytes'] / 1e6:.1f} MB) read); the prefill's "
          f"{out['prefill_bound_ms']:.4f} ms", flush=True)
    return out


def av_phase(dev, record: dict, *, reduced: bool = False) -> tuple[dict, list]:
    """Phase 14: whisper-tiny at full width and depth and qwen2-vl-72b at
    full width and ``vl_layers`` depth, in bf16, weights from seed 0, each
    request with its seeded frames or vision embeddings and M-RoPE
    positions (``reduced``: the reduced configs, a CPU rehearsal with no
    times or launch checks).  Returns (e)'s launch counts (the kernel rows'
    ``av_launches``) and the ``bcsr_spmm_bf16`` rows at the new shapes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels.bcsr_spmm import bf16_tensor_core_path
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig

    rec = record.setdefault("av", {})
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    chk = ServingChecks(dev, rec, reduced)
    get = get_reduced if reduced else get_config
    block = (32, 32) if reduced else (128, 128)
    bm, bk = block
    path = "tensor cores" if bf16_tensor_core_path(bm, bk) else "CUDA cores"
    sff = SparseFFNConfig(kind="bcsr", block=block)
    rng = np.random.default_rng(14)
    launches: collections.Counter = collections.Counter()
    rows: list = []

    def bcsr_variant(cfg_, model_, bench_, ffn, ks, label, per_step, per_prefill):
        """(e): the bcsr variant's W1 and W2 (``ffn``) through kernel 3 at
        ``ks`` against the plain version; the 4-slot server with both
        counters held to ``per_step`` a decode step and ``per_prefill`` a
        prefill (each warm-up as its pass); the kernel's time rows."""
        weights = ffn_weights(ffn, cfg_)
        errs = {}
        for which, (args, n_cb) in weights.items():
            errs.update(check_bf16_products(f"{label} {which}", args, n_cb, ks, rng, dev,
                                            path, key=f"{label}/{which}"))
        counters = ("bcsr_spmm_bf16", "bcsr_spmm_bf16_mma")
        served = chk.served(cfg_, model_, bench_,
                            per_pass={c: per_step for c in counters} if cuda else None,
                            per_prefill={c: per_prefill for c in counters} if cuda else None)
        got = served["serve"]["launches"]
        launches.update(got)
        for which, (args, n_cb) in weights.items():
            dense = densify(args, n_cb)
            rows.extend(bf16_time_rows(f"{label} FFN {which}", args, n_cb, dense, ks, rng,
                                       bench_.median_ms, path,
                                       launches=int(got.get("bcsr_spmm_bf16_mma", 0)),
                                       max_abs_err=max(errs.values())))
            del dense
        served["kernel_checks"] = errs
        return served

    # -- (a) whisper-tiny ---------------------------------------------------
    cfg = get(AV_ARCH)
    prompts, extras = av_traffic(cfg, LM_REQUESTS)
    bench = LMBench(dev, prompts, extras, new=AV_NEW)
    t0 = chk.begin("14a", f"{cfg.arch_id} bf16, {cfg.enc_layers} encoder + {cfg.n_layers} "
                          f"decoder layers, d {cfg.d_model}, {cfg.n_heads} heads, d_ff "
                          f"{cfg.d_ff}, {cfg.enc_frames} frames, vocab {cfg.vocab}; "
                          f"prompts of {AV_PROMPT} tokens, {AV_NEW} new")
    rec["cli/" + AV_ARCH] = chk.cli(cfg, prompt_len=AV_PROMPT, new=AV_NEW)
    bench.free()
    model = lm.init_model(cfg, 0, device=dev)
    rec["whisper_params"] = lm.param_count(model)
    print(f"  {rec['whisper_params'] / 1e6:.2f} M parameters; cross keys and values "
          f"{2 * cfg.n_layers * cfg.enc_frames * cfg.n_kv_heads * cfg.hd * 2 / 1e6:.2f} "
          "MB a slot", flush=True)
    rec["whisper"] = chk.served(cfg, model, bench)
    rec["whisper"]["bounds"] = av_bounds(cfg, model, rec["whisper"]["times"], extras[0])
    chk.end("14a", t0)
    cfg_f = dataclasses.replace(cfg, dtype=torch.float32)
    model_f = chk.copy_as(model, cfg_f)
    t0 = chk.begin("14d", f"{cfg.arch_id}: bf16 first-token logits against the float32 "
                          "copy at full depth")
    rec["bf16_vs_f32/whisper"] = chk.bf16_vs_f32(cfg, model, model_f, prompts, cfg.n_layers,
                                                 held=True, label="14d", extras=extras)
    del model
    bench.free()
    chk.end("14d", t0)
    t0 = chk.begin("14c", f"{cfg.arch_id} float32 copy, TF32 off: decode against forward, "
                          "graphs against eager")
    rec["consistency/whisper"] = chk.consistency(cfg_f, model_f, prompts, "14c", extras,
                                                 new=AV_NEW)
    del model_f
    bench.free()
    chk.end("14c", t0)
    t0 = chk.begin("14e", f"{cfg.arch_id} with the bcsr FFN {block}, density {sff.density}")
    cfg_b = dataclasses.replace(cfg, sparse_ffn=sff)
    model_b = lm.init_model(cfg_b, 0, device=dev)
    # kernel 3's widths: a 4-slot decode step and a 4-token decoder prefill
    # (k = 4), the encoder's frames (k = enc_frames)
    rec["whisper_bcsr"] = bcsr_variant(
        cfg_b, model_b, bench, model_b.dec_blocks[0].ffn, (LM_SLOTS, cfg.enc_frames),
        AV_ARCH, 2 * cfg.n_layers, 2 * (cfg.enc_layers + cfg.n_layers))
    cfg_bf = dataclasses.replace(cfg_b, dtype=torch.float32)
    model_bf = chk.copy_as(model_b, cfg_bf)
    del model_b
    rec["consistency/whisper_bcsr"] = chk.consistency(cfg_bf, model_bf, prompts, "14e",
                                                      extras, new=AV_NEW)
    del model_bf
    bench.free()
    chk.end("14e", t0)

    # -- (b) qwen2-vl-72b at the depth one card holds ----------------------
    full = get(VL_ARCH)
    layers, reckoned = vl_layers(full)
    cfg_v = dataclasses.replace(full, n_layers=layers)
    prompts_v, extras_v = av_traffic(cfg_v, LM_REQUESTS)
    bench_v = LMBench(dev, prompts_v, extras_v, new=VL_NEW, max_seq=VL_MAX_SEQ)
    t0 = chk.begin("14b", f"{VL_ARCH} bf16 at full width (d {cfg_v.d_model}, {cfg_v.n_heads} "
                          f"heads over {cfg_v.n_kv_heads} kv heads, d_ff {cfg_v.d_ff}, "
                          f"M-RoPE {cfg_v.mrope_sections}, {cfg_v.n_vision_tokens} vision "
                          f"slots), cut to {layers} of {full.n_layers} layers: reckoned "
                          f"{reckoned / 1e9:.2f} GB of weights; prompts of "
                          f"{len(prompts_v[0])} tokens, {VL_NEW} new, max_seq {VL_MAX_SEQ}")
    rec["cli/" + VL_ARCH] = chk.cli(full, prompt_len=VL_TEXT, new=VL_NEW,
                                    max_seq=VL_MAX_SEQ, reduced=True)
    bench_v.free()
    model = lm.init_model(cfg_v, 0, device=dev)
    rec["qwen2_vl"] = {"layers": layers, "of": full.n_layers, "reckoned_gb": reckoned / 1e9,
                       "params": lm.param_count(model),
                       **chk.served(cfg_v, model, bench_v)}
    rec["qwen2_vl"]["bounds"] = av_bounds(cfg_v, model, rec["qwen2_vl"]["times"],
                                          extras_v[0])
    chk.end("14b", t0)
    # (c), (d) at BF16_CHECK_LAYERS: a float32 copy of the full depth would
    # not fit beside it
    t0 = chk.begin("14d", f"{VL_ARCH}: bf16 first-token logits against the float32 copy "
                          f"over the first {min(BF16_CHECK_LAYERS, layers)} layers")
    cut = dataclasses.replace(cfg_v, n_layers=min(BF16_CHECK_LAYERS, layers))
    model_cut = chk.copy_as(model, cut)
    del model
    bench_v.free()
    cut_f = dataclasses.replace(cut, dtype=torch.float32)
    model_cut_f = chk.copy_as(model_cut, cut_f)
    rec["bf16_vs_f32/qwen2_vl"] = chk.bf16_vs_f32(cut, model_cut, model_cut_f, prompts_v,
                                                  cut.n_layers, held=True, label="14d",
                                                  extras=extras_v)
    del model_cut
    bench_v.free()
    chk.end("14d/qwen2_vl", t0)
    t0 = chk.begin("14c", f"{VL_ARCH} float32 copy at {cut.n_layers} layers, TF32 off")
    rec["consistency/qwen2_vl"] = chk.consistency(cut_f, model_cut_f, prompts_v, "14c",
                                                  extras_v, new=VL_NEW, max_seq=VL_MAX_SEQ)
    del model_cut_f
    bench_v.free()
    chk.end("14c/qwen2_vl", t0)
    t0 = chk.begin("14e", f"{VL_ARCH} at {layers} layers with the bcsr FFN {block}, "
                          f"density {sff.density}")
    cfg_vb = dataclasses.replace(cfg_v, sparse_ffn=sff)
    model_vb = lm.init_model(cfg_vb, 0, device=dev)
    # kernel 3's widths: a 4-slot decode step, a prompt's prefill
    rec["qwen2_vl_bcsr"] = bcsr_variant(
        cfg_vb, model_vb, bench_v, model_vb.blocks[0].ffn, (LM_SLOTS, len(prompts_v[0])),
        VL_ARCH, 2 * layers, 2 * layers)
    del model_vb
    bench_v.free()
    chk.end("14e/qwen2_vl", t0)

    if cuda and not reduced:  # the device's idle share in one decode step
        rec["decode_profile"] = run_lm_profile([AV_ARCH, VL_ARCH])
    rec["launches"] = dict(launches)
    rec["total_s"] = time.perf_counter() - t_phase
    print(f"phase 14f: phase 14 wall time {rec['total_s']:.1f}s", flush=True)
    if chk.failures:
        fail("phase " + "; ".join(chk.failures))
    return dict(launches), rows


TRAIN_ARCH = "qwen1.5-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 6  # 15a: the train CLI's defaults
TRAIN_CHECK_LAYERS = 2  # 15b, 15c, 15f: full width, 2 layers
BF16_PEAK_FLOPS = 989e12  # H100 SXM data sheet, dense bf16
F64_LOSS_REL, F64_GRAD_REL = 1e-5, 1e-4  # 15b: float32 against float64
MICRO_LOSS_ABS, MICRO_PARAM_ABS = 1e-4, 2e-5  # 15c: the reference's own limits


def profile_window(events, name: str, index: int = 0) -> dict:
    """The device's work inside the host range ``name`` ("<family>/<label>",
    a ``record_function`` range; its ``index``-th) of a profiler's events:
    the range's wall time, the union of its device operations' intervals
    (busy), the idle share, and its kernels (copies and fills left out) and
    device operations counted.  The device-side marks of the family's
    ranges are not operations."""
    import torch

    family = name.split("/", 1)[0] + "/"
    rng_ = [e for e in events if e.name == name
            and e.device_type == torch.autograd.DeviceType.CPU][index].time_range
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and rng_.start <= e.time_range.start <= rng_.end
                 and not e.name.startswith(family))
    busy, end = 0.0, float("-inf")
    for a_, b_, _ in ops:
        if b_ > end:
            busy += b_ - max(a_, end)
            end = b_
    wall = rng_.end - rng_.start
    kernels = [o for o in ops if "memcpy" not in o[2].lower()
               and "memset" not in o[2].lower()]
    return {"wall_ms": wall / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall if wall > 0 else None,
            "kernels": len(kernels), "device_ops": len(ops)}


def gb(n: float) -> str:
    return f"{n / 1e9:.2f} GB"


def floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


class PhaseLog:
    """What phases 15 and 16 share: the card's line, failed checks (the
    phase fails at its end with all of them), synchronisation, freeing the
    allocator's cache, and each sub-phase's seconds and allocator peak
    under ``rec``."""

    def __init__(self, dev, rec: dict):
        self.dev, self.rec = dev, rec
        self.cuda = dev.type == "cuda"
        self.smi = smi_line() if self.cuda else "cpu rehearsal"
        self.failures: list[str] = []

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"  FAILED: {what}", flush=True)

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()

    def begin(self, label: str, what: str) -> float:
        print(f"phase {label}: {what} [{self.smi}]", flush=True)
        if self.cuda:
            import torch

            torch.cuda.reset_peak_memory_stats(self.dev)
        return time.perf_counter()

    def end(self, label: str, t0: float) -> None:
        import torch

        peak = torch.cuda.max_memory_allocated(self.dev) if self.cuda else None
        self.rec.setdefault("seconds", {})[label] = time.perf_counter() - t0
        self.rec.setdefault("peak_bytes", {})[label] = peak
        print(f"  [{label}: {time.perf_counter() - t0:.1f}s"
              + (f", allocator peak {gb(peak)}" if self.cuda else "") + "]", flush=True)


def train_phase(dev, record: dict, *, reduced: bool = False) -> dict:
    """Phase 15: training on the card (``runtime.trainer``, ``optim``,
    ``checkpoint``, ``launch.train``; plain torch, no kernel on the path).
    ``reduced``: the reduced qwen1.5-4b in 15a-15c and 15f, a CPU rehearsal
    with no times, profile or allocator figures.  Returns the launch counts
    over the whole phase, which must all be 0."""
    import math
    import tempfile as tmp_mod

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    from repro_torch.core.formats import bcsr_from_csr, csr_from_dense, sell_from_csr
    from repro_torch.data.pipeline import MarkovTokens, SyntheticTokens, make_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.spmspv import spmspv_prepare, spmspv_scatter, stage_sparse
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.optim.adamw import (
        OptimConfig,
        adamw_init,
        adamw_update,
        global_norm,
        lr_schedule,
    )
    from repro_torch.runtime import trainer

    rec = record.setdefault("train", {})
    log = PhaseLog(dev, rec)
    cuda, smi, failures = log.cuda, log.smi, log.failures
    check, sync, free, begin, end = log.check, log.sync, log.free, log.begin, log.end
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # every float32 check
    torch.backends.cudnn.allow_tf32 = False
    _build.reset_launches()

    full = get_reduced(TRAIN_ARCH) if reduced else get_config(TRAIN_ARCH)
    cli_opt = OptimConfig(lr_peak=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 1),
                          total_steps=TRAIN_STEPS)  # as launch.train builds it
    data = MarkovTokens(full.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # -- 15a: the full model, six steps -------------------------------------
    free()
    t0 = begin("15a", f"{TRAIN_ARCH} bf16 at full width and depth ({full.n_layers} layers, "
                      f"d {full.d_model}, d_ff {full.d_ff}, vocab {full.vocab} padded to "
                      f"{full.vocab_padded}), {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
                      f"{TRAIN_SEQ} Markov tokens, AdamW lr 3e-4, float32 moments")
    model = lm.init_model(full, 0, device=dev)
    params = lm.trainable(model)
    n_params = sum(p.numel() for p in params.values())
    p_bytes = sum(p.numel() * p.element_size() for p in params.values())
    moments = 2 * n_params * 4
    logits_copy = tokens * full.vocab_padded * 4
    reckoned = 2 * p_bytes + moments
    flops = 6 * n_params * tokens
    # the optimizer's bytes: parameters and moments read and written,
    # gradients written and read once each
    step_bytes = 2 * p_bytes + 2 * p_bytes + 2 * moments
    bound_ms = max(flops / BF16_PEAK_FLOPS, step_bytes / HBM_BYTES_PER_S) * 1e3
    rec["a"] = a = {
        "params": n_params, "param_bytes": p_bytes, "grad_bytes": p_bytes,
        "moment_bytes": moments, "logits_float32_bytes": logits_copy,
        "reckoned_bytes": reckoned, "flops": flops,
        "flops_ms": flops / BF16_PEAK_FLOPS * 1e3,
        "bytes_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "card": smi}
    print(f"  reckoned: {n_params / 1e9:.3f} G parameters; bf16 parameters "
          f"{gb(p_bytes)}, bf16 gradients {gb(p_bytes)}, float32 m and v {gb(moments)}: "
          f"{gb(reckoned)} before activations, plus {gb(logits_copy)} for each live "
          f"float32 copy of the logits; 6 N T = {flops / 1e12:.1f} TFLOP "
          f"({a['flops_ms']:.1f} ms at 989 TFLOP/s), the update's "
          f"{step_bytes / 1e9:.1f} GB ({a['bytes_ms']:.1f} ms at 3.35 TB/s) [{smi}]",
          flush=True)
    opt = adamw_init(params, cli_opt)
    step_fn = trainer.make_train_step(full, cli_opt)
    layout = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    first = data.batch_at(0)
    used_rows = torch.as_tensor(np.unique(first["tokens"]), device=dev)

    def probe(name, p):  # a sample of each leaf (the embedding: rows step 0 reads)
        if name == "embed":
            return p.detach()[used_rows].clone()
        flat = p.detach().reshape(-1)
        return flat[:: max(1, flat.numel() // 4096)][:4096].clone()

    before = {n: probe(n, p) for n, p in params.items()}
    steps = []
    for i in range(TRAIN_STEPS):
        batch = data.batch_at(i)
        sync()
        t_ = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, batch)
        metrics = floats(metrics)  # the host read of the metrics, inside the time
        steps.append({"step": i, "ms": (time.perf_counter() - t_) * 1e3, **metrics})
        print(f"  step {i}: loss {metrics['loss']:.4f} ce {metrics['ce']:.4f} gnorm "
              f"{metrics['grad_norm']:.4f} lr {metrics['lr']:.3e} "
              f"{steps[-1]['ms']:.1f} ms [{smi}]", flush=True)
        if i == 0:
            changed = {n: int((probe(n, p) != before[n]).sum()) for n, p in params.items()}
    a["steps"] = steps
    check(abs(steps[0]["ce"] - math.log(full.vocab)) <= 1.5,
          f"15a step 0 ce {steps[0]['ce']:.4f} not within 1.5 of log(vocab) "
          f"{math.log(full.vocab):.4f}")
    check(all(np.isfinite(v) for s in steps for v in s.values()), "15a: a metric is not finite")
    check(all(s["grad_norm"] > 0 for s in steps), "15a: a zero gradient norm")
    check({n: (tuple(p.shape), p.dtype) for n, p in params.items()} == layout,
          "15a: a parameter changed its shape or dtype")
    held = [n for n in params if n == "embed" or n == "unembed"
            or n.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo", "wi_gate", "wi_up",
                                         "bq", "bk", "bv")]
    unchanged = [n for n in held if changed[n] == 0]
    check(not unchanged, f"15a: step 0 left {unchanged[:4]} unchanged")
    gains = {n: (changed[n], before[n].numel()) for n in params if n not in held}
    a["changed_sampled"] = changed
    print(f"  step 0 changed the embedding's sampled rows and every sampled one of the "
          f"{len(held) - 1} other projection leaves (weights, biases, the unembedding): "
          f"{not unchanged}; norm gains (not held), elements changed of "
          f"those sampled: {sum(c for c, _ in gains.values())} of "
          f"{sum(t for _, t in gains.values())}", flush=True)
    if cuda:
        times = [s["ms"] for s in steps[1:]]
        step_ms = float(np.median(times))
        peak = torch.cuda.max_memory_allocated(dev)
        a.update(step_ms=step_ms, step_ms_range=[min(times), max(times)],
                 tokens_per_s=tokens / (step_ms / 1e3),
                 mfu=flops / (step_ms / 1e3) / BF16_PEAK_FLOPS,
                 bound_ms=bound_ms, peak_allocated_bytes=peak)
        print(f"  step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}; "
              f"{min(times):.1f}-{max(times):.1f}), {a['tokens_per_s']:.0f} tokens/s, MFU "
              f"{a['mfu']:.4f} (6 N T over 989 TFLOP/s); bound {bound_ms:.1f} ms; "
              f"allocator peak {gb(peak)} against {gb(reckoned)} reckoned before "
              f"activations [{smi}]", flush=True)
        # one more step under the profiler, its two halves in their own ranges
        batch = trainer._on(data.batch_at(TRAIN_STEPS), dev)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("train/step"):
                with record_function("train/forward_backward"):
                    loss, _ = lm.loss_fn(full, model, batch)
                    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
                    sync()
                with record_function("train/adamw"):
                    adamw_update(grads, opt, params, cli_opt)
                    sync()
        del grads, loss
        events = prof.events()
        a["profile"] = {name: profile_window(events, f"train/{name}")
                        for name in ("step", "forward_backward", "adamw")}
        for name, p_ in a["profile"].items():
            print(f"  one step's {name} by torch.profiler: wall {p_['wall_ms']:.1f} ms, "
                  f"device busy {p_['busy_ms']:.1f} ms, idle share {p_['idle_share']:.4f}, "
                  f"{p_['kernels']} kernels [{smi}]", flush=True)
    del model, opt, params, step_fn, before
    end("15a", t0)

    # -- 15b: autograd against float64 --------------------------------------
    free()
    cut = dataclasses.replace(full, n_layers=min(TRAIN_CHECK_LAYERS, full.n_layers))
    t0 = begin("15b", f"{TRAIN_ARCH} at full width, {cut.n_layers} layers: float32 loss and "
                      "gradients against a float64 copy (the same weights), bf16 reported")
    batch = data.batch_at(0)
    runs = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        c = dataclasses.replace(cut, dtype=dtype)
        m_ = lm.init_model(c, 0, device=dev)  # float32 draws: equal in float64
        ps = lm.trainable(m_)
        loss, _ = lm.loss_fn(c, m_, batch)
        gs = torch.autograd.grad(loss, list(ps.values()))
        runs[dtype] = (float(loss.detach()), {n: g.detach().double() for n, g in zip(ps, gs)})
        del m_, ps, gs, loss
        free()
    (l64, g64), (l32, g32), (l16, g16) = (runs[d] for d in (torch.float64, torch.float32,
                                                           torch.bfloat16))
    ratios = {n: float((g32[n] - g).abs().max() / (F64_GRAD_REL * g.abs().max()))
              for n, g in g64.items()}
    bf16_dev = {n: float((g16[n] - g32[n]).abs().max() / g32[n].abs().max())
                for n in g32}
    rec["b"] = {"loss64": l64, "loss32": l32, "loss_bf16": l16,
                "loss_rel": abs(l32 - l64) / abs(l64), "grad_ratio_to_limit": ratios,
                "bf16_loss_rel": abs(l16 - l32) / abs(l32), "bf16_grad_rel": bf16_dev,
                "card": smi}
    print(f"  loss float64 {l64:.10f}, float32 {l32:.10f} (relative "
          f"{rec['b']['loss_rel']:.3e}, limit {F64_LOSS_REL}); gradient leaves' largest "
          f"deviation over 1e-4 max|g64|: " + ", ".join(
              f"{n} {r:.3f}" for n, r in sorted(ratios.items(), key=lambda t: -t[1])[:6])
          + f" ... (largest of {len(ratios)}) [{smi}]", flush=True)
    print(f"  bf16 against float32 (reported): loss relative {rec['b']['bf16_loss_rel']:.3e}, "
          f"gradients max|d| / max|g32| {min(bf16_dev.values()):.3e}-"
          f"{max(bf16_dev.values()):.3e}", flush=True)
    check(rec["b"]["loss_rel"] <= F64_LOSS_REL, f"15b: float32 loss {rec['b']['loss_rel']:.3e} "
                                               f"from float64")
    check(max(ratios.values()) <= 1.0, f"15b: a float32 gradient leaf past 1e-4 max|g64|: "
                                       f"{max(ratios, key=ratios.get)}")
    del runs, g64, g32, g16
    end("15b", t0)

    # -- 15c: gradient accumulation -----------------------------------------
    free()
    cut32 = dataclasses.replace(cut, dtype=torch.float32)
    t0 = begin("15c", f"{TRAIN_ARCH} float32 at full width, {cut.n_layers} layers, lr 1e-3: "
                      "n_micro = 2 against n_micro = 1")
    acc_opt = OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    lr1 = float(lr_schedule(acc_opt, 1))
    out = {}
    for n_micro in (1, 2):
        m_ = lm.init_model(cut32, 0, device=dev)
        ps = lm.trainable(m_)
        # the step's gradient as make_train_step forms it, clipped as AdamW
        # clips it, and the first step's direction g / (|g| + eps) from it
        micro = trainer._split_micro(trainer._on(batch, dev), n_micro)
        g_ = {n: torch.zeros_like(p) for n, p in ps.items()}
        for i in range(n_micro):
            l_, _ = lm.loss_fn(cut32, m_, {k: v[i] for k, v in micro.items()})
            for n, g in zip(ps, torch.autograd.grad(l_, list(ps.values()))):
                g_[n].add_(g)
        for g in g_.values():
            g.div_(n_micro)
        scale = min(1.0, acc_opt.clip_norm / max(float(global_norm(g_)), 1e-9))
        o_ = adamw_init(ps, acc_opt)
        m_, o_, met = trainer.make_train_step(cut32, acc_opt, n_micro)(m_, o_, batch)
        out[n_micro] = (floats(met), m_, g_, scale)
        del o_, ps, micro
    (met1, m1, g1, s1), (met2, m2, g2, s2) = out[1], out[2]
    leaves = {}
    for (name, a_), b_ in zip(m1.state_dict().items(), m2.state_dict().values()):
        d_ = (a_ - b_).abs().double()
        h1, h2 = g1[name].double() * s1, g2[name].double() * s2
        # what the first AdamW step makes of the two gradients' rounding
        amp = lr1 * (h2 / (h2.abs() + acc_opt.eps) - h1 / (h1.abs() + acc_opt.eps)).abs()
        past = d_ > MICRO_PARAM_ABS
        leaves[name] = {
            "param_abs": float(d_.max()), "past_limit": int(past.sum()),
            "over_bound": float((d_ - MICRO_PARAM_ABS - amp).max()),
            "grad_rel": float((g1[name] - g2[name]).abs().max()
                              / g1[name].abs().max().clamp(min=1e-30)),
            "max_g_past": float(h1.abs()[past].max()) if past.any() else None}
        del d_, h1, h2, amp, past
    p_err = max(v["param_abs"] for v in leaves.values())
    n_past = sum(v["past_limit"] for v in leaves.values())
    g_past = [v["max_g_past"] for v in leaves.values() if v["max_g_past"] is not None]
    rec["c"] = {"loss_1": met1["loss"], "loss_2": met2["loss"],
                "loss_abs": abs(met1["loss"] - met2["loss"]), "param_abs": p_err,
                "past_limit": n_past, "leaves": leaves, "card": smi}
    print(f"  loss n_micro 1 {met1['loss']:.8f}, 2 {met2['loss']:.8f} (|d| "
          f"{rec['c']['loss_abs']:.3e}, limit {MICRO_LOSS_ABS}); gradients max|d| / "
          f"max|g| per leaf {max(v['grad_rel'] for v in leaves.values()):.3e} (limit "
          f"{F64_GRAD_REL}); parameters max|d| {p_err:.3e}, {n_past} elements past "
          f"{MICRO_PARAM_ABS}" + (f" (their clipped |g| at most {max(g_past):.3e}, eps "
                                  f"{acc_opt.eps})" if g_past else "")
          + f"; past 2e-5 + the first step's |d(g / (|g| + eps))| x lr: "
          f"{max(v['over_bound'] for v in leaves.values()):.3e} (must be <= 0) [{smi}]",
          flush=True)
    check(rec["c"]["loss_abs"] <= MICRO_LOSS_ABS, "15c: the microbatched loss moved")
    check(all(v["grad_rel"] <= F64_GRAD_REL for v in leaves.values()),
          "15c: the accumulated gradient moved")
    check(all(v["over_bound"] <= 0 for v in leaves.values()),
          "15c: the microbatched update moved the parameters past 2e-5 beyond what AdamW's "
          "first step makes of the gradients' rounding")
    del out, m1, m2, g1, g2
    end("15c", t0)

    # -- 15d: every architecture's reduced config ---------------------------
    free()
    t0 = begin("15d", "one train step of every ARCH_ID's reduced config (the hybrid "
                      "perturbed, C.23)")
    rec["d"] = {}
    for arch in ARCH_IDS:
        c = get_reduced(arch)
        m_ = lm.init_model(c, 0, device=dev)
        if c.family == "hybrid":
            perturb_hybrid(m_, 0)
        layout_ = {n: (tuple(t.shape), t.dtype) for n, t in m_.state_dict().items()}
        o_cfg = OptimConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
        o_ = adamw_init(lm.trainable(m_), o_cfg)
        m_, o_, met = trainer.make_train_step(c, o_cfg)(m_, o_, make_batch(c, 2, 32, step=0))
        met = floats(met)
        rec["d"][arch] = met
        kept = {n: (tuple(t.shape), t.dtype) for n, t in m_.state_dict().items()} == layout_
        print(f"  {arch}: loss {met['loss']:.4f} gnorm {met['grad_norm']:.4f} aux "
              f"{met['aux']:.4f}, shapes and dtypes kept: {kept}", flush=True)
        check(np.isfinite(met["loss"]) and np.isfinite(met["grad_norm"])
              and met["grad_norm"] > 0 and kept, f"15d {arch}: {met}, kept {kept}")
        del m_, o_
    end("15d", t0)

    # -- 15e: the driver, the CLI and checkpoints ---------------------------
    free()
    t0 = begin("15e", "train_loop: a fault at step 15 of 30 (ckpt_every 10), learning, "
                      "the CLI in a fresh process, a bf16 checkpoint")
    tiny = lm.ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                          dtype=torch.float32, remat="none", attn_chunk=16)
    e = rec["e"] = {}
    with tmp_mod.TemporaryDirectory() as d:
        hist = {}
        for name in ("uninterrupted", "faulted"):
            crashed = []

            def fault(step, crashed=crashed, on=name == "faulted"):
                if on and step == 15 and not crashed:
                    crashed.append(step)
                    raise RuntimeError("injected")

            _, _, hist[name] = trainer.train_loop(
                tiny, OptimConfig(lr_peak=1e-3, warmup_steps=2, total_steps=30),
                trainer.TrainConfig(steps=30, ckpt_every=10, ckpt_dir=f"{d}/{name}",
                                    log_every=1000),
                SyntheticTokens(vocab=64, batch=4, seq=16, seed=2), fault_hook=fault,
                log=lambda s: None, device=dev)
        run = [h["step"] for h in hist["faulted"]]
        ref = {h["step"]: h["loss"] for h in hist["uninterrupted"]}
        worst = max(abs(h["loss"] - ref[h["step"]]) / abs(ref[h["step"]])
                    for h in hist["faulted"])
        bitwise = all(h["loss"] == ref[h["step"]] for h in hist["faulted"])
        e["fault"] = {"steps": run, "worst_rel": worst, "bit_for_bit": bitwise}
        print(f"  faulted run: {len(run)} steps, last {run[-1]}, step 15 x{run.count(15)}, "
              f"step 11 x{run.count(11)}; worst loss deviation from the uninterrupted run "
              f"{worst:.3e} (limit 1e-5), bit for bit: {bitwise}", flush=True)
        check(run[-1] == 29 and run.count(15) == 1 and run.count(11) == 2,
              f"15e: the faulted run's steps {run}")
        check(worst <= 1e-5, f"15e: a replayed loss moved {worst:.3e}")
        _, _, h = trainer.train_loop(
            tiny, OptimConfig(lr_peak=3e-3, warmup_steps=10, total_steps=50),
            trainer.TrainConfig(steps=50, ckpt_every=0, ckpt_dir=f"{d}/markov", log_every=1000),
            MarkovTokens(vocab=64, batch=8, seq=32, branch=4, seed=0), log=lambda s: None,
            device=dev)
        e["markov"] = [h[0]["loss"], h[-1]["loss"]]
        sparse = dataclasses.replace(tiny, arch_id="sparse-lm", sparse_ffn=SparseFFNConfig(
            kind="structured", n_groups=4, band=1))
        _, _, h2 = trainer.train_loop(
            sparse, OptimConfig(lr_peak=3e-3, warmup_steps=5, total_steps=40),
            trainer.TrainConfig(steps=40, ckpt_every=0, ckpt_dir=f"{d}/sparse", log_every=1000),
            MarkovTokens(vocab=64, batch=8, seq=32, branch=4, seed=0), log=lambda s: None,
            device=dev)
        e["sparse_lm"] = [h2[0]["loss"], h2[-1]["loss"]]
        print(f"  Markov chain: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} in 50 steps "
              f"(log 64 - 1 = {math.log(64) - 1:.4f}); structured sparse FFN "
              f"{h2[0]['loss']:.4f} -> {h2[-1]['loss']:.4f} in 40", flush=True)
        check(h[-1]["loss"] < h[0]["loss"] - 1.0 and h[-1]["loss"] < math.log(64) - 1.0,
              "15e: TINY did not learn the Markov chain")
        check(h2[-1]["loss"] < h2[0]["loss"] - 0.8, "15e: the sparse-FFN LM did not learn")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
               "--reduced", "--steps", "20", "--markov", "--ckpt-dir", f"{d}/cli",
               "--device", "cuda" if cuda else "cpu"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
        check(proc.returncode == 0, f"15e: the train CLI failed: {proc.stderr[-1500:]}")
        if proc.returncode == 0:
            summary = json.loads(proc.stdout.strip().splitlines()[-1])
            e["cli"] = summary
            print(f"  {' '.join(cmd[1:])}: {json.dumps(summary)} [{smi}]", flush=True)
            check(summary["steps"] == 20 and np.isfinite(summary["last_loss"]),
                  f"15e: the CLI's summary {summary}")
        # a bf16 checkpoint, bf16 moments, restored bit for bit
        c = get_reduced(TRAIN_ARCH)
        m_ = lm.init_model(c, 0, device=dev)
        o_cfg = OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10,
                            moment_dtype=torch.bfloat16)
        o_ = adamw_init(lm.trainable(m_), o_cfg)
        m_, o_, _ = trainer.make_train_step(c, o_cfg)(m_, o_, make_batch(c, 2, 32, step=0))
        mgr = CheckpointManager(f"{d}/bf16", keep=1)
        mgr.save(1, trainer._state_tree(c, m_, o_), blocking=True)
        m2_ = lm.init_model(c, 1, device=dev)
        o2_ = adamw_init(lm.trainable(m2_), o_cfg)
        trainer._load_state(c, m2_, o2_, mgr.restore(1, trainer._state_tree(c, m2_, o2_)))
        same = all(torch.equal(a_.view(torch.int16) if a_.dtype == torch.bfloat16 else a_,
                               b_.view(torch.int16) if b_.dtype == torch.bfloat16 else b_)
                   for a_, b_ in zip(m_.state_dict().values(), m2_.state_dict().values()))
        same &= all(torch.equal(o_[k][n].view(torch.int16), o2_[k][n].view(torch.int16))
                    for k in ("m", "v") for n in o_[k])
        e["bf16_checkpoint_bitwise"] = same
        print(f"  a bf16 checkpoint (bf16 moments) restored bit for bit: {same}", flush=True)
        check(same, "15e: the bf16 checkpoint did not restore bit for bit")
        del m_, o_, m2_, o2_
    end("15e", t0)

    # -- 15f: no silent detach ----------------------------------------------
    free()
    cfg_b = dataclasses.replace(cut, sparse_ffn=SparseFFNConfig(
        kind="bcsr", block=(32, 32) if reduced else (128, 128)))
    t0 = begin("15f", f"{TRAIN_ARCH}-shaped {cut.n_layers}-layer bcsr model: the kernel tier "
                      "refuses autograd, the plain tier trains; every wrapper refuses")
    f = rec["f"] = {}
    m_ = lm.init_model(cfg_b, 0, device=dev)
    ps = lm.trainable(m_)
    try:
        lm.loss_fn(cfg_b, m_, batch)[0].backward()
        f["cuda_tier"] = "trained"
    except NotImplementedError as err:
        f["cuda_tier"] = f"NotImplementedError: {err}"
    print(f"  impl='cuda' backward: {f['cuda_tier'][:120]}", flush=True)
    check(f["cuda_tier"].startswith("NotImplementedError"),
          "15f: the kernel tier's backward did not raise")
    cfg_r = dataclasses.replace(cfg_b, sparse_ffn=dataclasses.replace(cfg_b.sparse_ffn,
                                                                      impl="ref"))
    ffn_names = [n for n in ps if "_blocks" in n]
    loss, _ = lm.loss_fn(cfg_r, m_, batch)
    gs = torch.autograd.grad(loss, [ps[n] for n in ffn_names])
    f["ffn_grad_norms"] = {n: float(g.float().norm()) for n, g in zip(ffn_names, gs)}
    del loss, gs
    o_ = adamw_init(ps, acc_opt)
    m_, o_, met = trainer.make_train_step(cfg_r, acc_opt)(m_, o_, batch)
    f["ref_tier"] = floats(met)
    print(f"  impl='ref': loss {f['ref_tier']['loss']:.4f} gnorm "
          f"{f['ref_tier']['grad_norm']:.4f}; FFN block gradient norms "
          f"{min(f['ffn_grad_norms'].values()):.3e}-{max(f['ffn_grad_norms'].values()):.3e}",
          flush=True)
    check(f["ref_tier"]["grad_norm"] > 0 and min(f["ffn_grad_norms"].values()) > 0,
          "15f: the plain tier did not train its FFN blocks")
    del m_, o_, ps
    rng = np.random.default_rng(0)
    dense = ((rng.random((64, 64)) < 0.1) * rng.standard_normal((64, 64))).astype(np.float32)
    a_ = csr_from_dense(dense)
    sell = kops.sell_prepare(sell_from_csr(a_, C=8, sigma=16), device=dev)
    slabs = kops.sell_prepare_blocked_stacked(a_, 2, device=dev)
    bcsr = kops.bcsr_prepare(bcsr_from_csr(a_, (8, 8)), device=dev)
    spv = spmspv_prepare(a_, device=dev)
    st = stage_sparse(spv, np.array([1, 5, 9], np.int32), np.array([1.0, -2.0, 0.5],
                                                                   np.float32))
    wrappers = (
        ("sell_spmv", torch.ones(64, device=dev), lambda x: kops.sell_spmv(sell, x)),
        ("sell_spmv_blocked", torch.ones(64, device=dev),
         lambda x: kops.sell_spmv_blocked_stacked(slabs, x)),
        ("bcsr_spmm", torch.ones(64, 3, device=dev), lambda x: kops.bcsr_spmm(bcsr, x)),
        ("spmspv_scatter", st["xv"].clone(),
         lambda x: spmspv_scatter(spv, st["xi"], x, st["flags"], st["plan"])),
    )
    f["wrappers"] = {}
    for name, x, call in wrappers:
        x.requires_grad_(True)
        try:
            call(x)
            f["wrappers"][name] = "ran"
        except NotImplementedError:
            f["wrappers"][name] = "refused"
    print(f"  each wrapper on an operand that requires grad: {f['wrappers']}", flush=True)
    check(all(v == "refused" for v in f["wrappers"].values()),
          f"15f: a wrapper took an operand that requires grad: {f['wrappers']}")
    end("15f", t0)

    launches = dict(_build.LAUNCHES)
    rec["launches"] = launches
    rec["total_s"] = time.perf_counter() - t_phase
    print(f"phase 15: kernel launches over the phase {launches or '{}'} (must be none); "
          f"wall time {rec['total_s']:.1f}s [{smi}]", flush=True)
    check(not any(launches.values()), f"15: kernels launched on the training path: {launches}")
    if failures:
        fail("phase 15: " + "; ".join(failures))
    return launches


def train_main(out_path: str) -> None:
    """``python3 chip_smoke.py --train-phase OUT``: phase 15 in a fresh
    process (a clean allocator for the full model), its record to OUT."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: phase 15 needs a card")
    record: dict = {}
    launches = train_phase(torch.device("cuda"), record)
    Path(out_path).write_text(json.dumps({"train": record["train"], "launches": launches}))


MESH_TRAIN_SHAPE = (1, 2, 4)  # 16a-16e: make_mesh(1, 2, 4), data 2 x model 4 on the card
MESH_RESTORE_SHAPE = (1, 4, 2)  # 16d: the factorization a checkpoint is restored onto
MESH_KEEP = 16  # 16a: labels kept in each row of the first data half (all in the second)
EF_LEAVES = ("blocks.0.attn.wq", "blocks.1.ffn.wo", "ln_f.g")  # 16e's gradients
MESH_FIT = 0.92  # 16c: the share of the card's free bytes the reckoned peak may take
MESH_TIMED_LAYERS = 20  # 16c: qwen1.5-4b's depth cut to half, for the script's time limit


def profile_spans(events, name: str) -> dict:
    """:func:`profile_window` summed over every range called ``name`` (a
    span that runs once per batch replica)."""
    import torch

    n = sum(1 for e in events if e.name == name
            and e.device_type == torch.autograd.DeviceType.CPU)
    wins = [profile_window(events, name, i) for i in range(n)]
    out = {k: sum(w[k] for w in wins) for k in ("wall_ms", "busy_ms", "kernels", "device_ops")}
    out["idle_share"] = 1.0 - out["busy_ms"] / out["wall_ms"] if out["wall_ms"] > 0 else None
    out["ranges"] = n
    return out


def mesh_train_phase(dev, record: dict, *, reduced: bool = False) -> dict:
    """Phase 16: the sharded train step on an LM mesh (``launch.mesh.
    make_mesh``, ``runtime.sharded``, ``runtime.trainer``'s mesh path,
    ``optim.compress``; plain torch, no kernel on the path).  ``reduced``:
    the reduced qwen1.5-4b throughout, a CPU rehearsal with no times,
    profile or allocator figures.  Returns the launch counts over the
    phase, which must all be 0."""
    import math
    import tempfile as tmp_mod

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.checkpoint import CheckpointManager, tree_paths
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import MarkovTokens, SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import default_rules
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import OptimConfig, adamw_init, global_norm, lr_schedule
    from repro_torch.runtime import trainer

    rec = record.setdefault("mesh_train", {})
    log = PhaseLog(dev, rec)
    cuda, smi, check = log.cuda, log.smi, log.check
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # every float32 check
    torch.backends.cudnn.allow_tf32 = False
    _build.reset_launches()

    full = get_reduced(TRAIN_ARCH) if reduced else get_config(TRAIN_ARCH)
    cut = dataclasses.replace(full, n_layers=min(TRAIN_CHECK_LAYERS, full.n_layers))
    cut32 = dataclasses.replace(cut, dtype=torch.float32)
    mesh = make_mesh(*MESH_TRAIN_SHAPE, device=dev)
    rules = default_rules(False)
    n_data = mesh.shape["data"]
    cli_opt = OptimConfig(lr_peak=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 1),
                          total_steps=TRAIN_STEPS)  # as launch.train builds it
    acc_opt = OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    lr1 = float(lr_schedule(acc_opt, 1))
    data = MarkovTokens(full.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    batch0 = data.batch_at(0)
    uneven = dict(batch0, labels=batch0["labels"].copy())
    uneven["labels"][: TRAIN_BATCH // n_data, MESH_KEEP:] = -1
    print(f"phase 16: {mesh} ({MESH_TRAIN_SHAPE}); {TRAIN_ARCH} [{smi}]", flush=True)

    def sharded(cfg, seed=0):
        sm = trainer.shard_model(cfg, lm.init_model(cfg, seed, device=dev), mesh, rules)
        return sm

    def step_gradient(cfg, model, batch, n_micro):
        """The single-device step's gradient as make_train_step forms it."""
        params = lm.trainable(model)
        micro = trainer._split_micro(trainer._on(batch, dev), n_micro)
        g_ = {n: torch.zeros_like(p) for n, p in params.items()}
        for i in range(n_micro):
            l_, _ = lm.loss_fn(cfg, model, {k: v[i] for k, v in micro.items()})
            for n, g in zip(params, torch.autograd.grad(l_, list(params.values()))):
                g_[n].add_(g)
        return {n: g.div_(n_micro) for n, g in g_.items()}

    def clip_scale(g_: dict) -> float:
        return min(1.0, acc_opt.clip_norm / max(float(global_norm(g_)), 1e-9))

    # -- 16a: parity with the single-device step -----------------------------
    log.free()
    t0 = log.begin("16a", f"{TRAIN_ARCH} float32 at full width, {cut.n_layers} layers, on "
                          f"make_mesh{MESH_TRAIN_SHAPE} (8 cells on {mesh.n_devices} "
                          f"device(s)), lr 1e-3, the first data half's rows keeping "
                          f"{MESH_KEEP} labels: the sharded step at n_micro 1 and 2 against "
                          "the single-device step from the same weights")
    a = rec["a"] = {"card": smi}
    for n_micro in (1, 2):
        m1 = lm.init_model(cut32, 0, device=dev)
        g1 = step_gradient(cut32, m1, uneven, n_micro)
        o1 = adamw_init(lm.trainable(m1), acc_opt)
        m1, o1, met1 = trainer.make_train_step(cut32, acc_opt, n_micro)(m1, o1, uneven)
        del o1
        sm = sharded(cut32)
        acc, _, _ = trainer.sharded_grads(cut32, sm, uneven, n_micro)
        g2 = {n: sm.full(n, acc, device=dev) for n in acc}
        del acc
        o2 = trainer.sharded_adamw_init(sm, acc_opt, rules)
        sm, o2, met2 = trainer.make_sharded_train_step(cut32, acc_opt, n_micro)(sm, o2, uneven)
        met1, met2 = floats(met1), floats(met2)
        s1, s2 = clip_scale(g1), clip_scale(g2)
        on_card = all(t.device.type == dev.type for tree in (sm.blocks, o2["m"], o2["v"])
                      for stacks in tree.values() for t in stacks.values())
        leaves = {}
        for name, p1 in m1.state_dict().items():
            d_ = (sm.full(name, device=dev) - p1).abs().double()
            h1, h2 = g1[name].double() * s1, g2[name].double() * s2
            amp = lr1 * (h2 / (h2.abs() + acc_opt.eps) - h1 / (h1.abs() + acc_opt.eps)).abs()
            leaves[name] = {
                "param_abs": float(d_.max()),
                "over_bound": float((d_ - MICRO_PARAM_ABS - amp).max()),
                "grad_rel": float((g1[name] - g2[name]).abs().max()
                                  / g1[name].abs().max().clamp(min=1e-30))}
            del d_, h1, h2, amp
        a[n_micro] = {"single": met1, "mesh": met2, "loss_abs": abs(met1["loss"] - met2["loss"]),
                      "leaves": leaves, "blocks_on_card": on_card,
                      "grids": {n: list(lay.grid) for n, lay in sm.layouts.items()
                                if n.startswith("blocks.0.") or "." not in n}}
        print(f"  n_micro {n_micro}: loss single {met1['loss']:.8f} mesh {met2['loss']:.8f} "
              f"(|d| {a[n_micro]['loss_abs']:.3e}, limit {MICRO_LOSS_ABS}); grad_norm "
              f"{met1['grad_norm']:.6f} / {met2['grad_norm']:.6f}; gradients max|d| / max|g| "
              f"per leaf {max(v['grad_rel'] for v in leaves.values()):.3e} (limit "
              f"{F64_GRAD_REL}); parameters max|d| "
              f"{max(v['param_abs'] for v in leaves.values()):.3e}, past 2e-5 + C.30's term "
              f"{max(v['over_bound'] for v in leaves.values()):.3e} (must be <= 0); every "
              f"block on the card: {on_card} [{smi}]", flush=True)
        check(a[n_micro]["loss_abs"] <= MICRO_LOSS_ABS, f"16a n_micro {n_micro}: the loss moved")
        check(all(v["grad_rel"] <= F64_GRAD_REL for v in leaves.values()),
              f"16a n_micro {n_micro}: the sharded gradient moved")
        check(all(v["over_bound"] <= 0 for v in leaves.values()),
              f"16a n_micro {n_micro}: the sharded update moved the parameters")
        check(on_card, "16a: a block left the card")
        del m1, g1, sm, g2, o2
        log.free()
    print(f"  layouts (blocks per dimension): {a[1]['grids']}", flush=True)
    log.end("16a", t0)

    # -- 16b and 16e: float64, and the int8 reduce of the replicas' gradients
    t0 = log.begin("16b", f"{TRAIN_ARCH} at full width, {cut.n_layers} layers: the sharded "
                          "float32 loss and gradient against a float64 copy (phase 15b's), "
                          "with each replica's gradients kept for 16e")
    c64 = dataclasses.replace(cut, dtype=torch.float64)
    m64 = lm.init_model(c64, 0, device=dev)  # float32 draws: equal in float64
    p64 = lm.trainable(m64)
    loss64, _ = lm.loss_fn(c64, m64, batch0)
    g64 = {n: g.detach() for n, g in zip(p64, torch.autograd.grad(loss64, list(p64.values())))}
    l64 = float(loss64.detach())
    del m64, p64, loss64
    kept: dict = {}

    def keep(i, r, device, grads):
        kept[r] = {n: grads[n].detach().clone() for n in EF_LEAVES}

    sm = sharded(cut32)
    acc, loss32, _ = trainer.sharded_grads(cut32, sm, batch0, 1, on_replica=keep)
    l32 = float(loss32)
    ratios = {n: float((sm.full(n, acc, device=dev).double() - g).abs().max()
                       / (F64_GRAD_REL * g.abs().max())) for n, g in g64.items()}
    del acc, sm, g64
    rec["b"] = {"loss64": l64, "loss32_mesh": l32, "loss_rel": abs(l32 - l64) / abs(l64),
                "grad_ratio_to_limit": ratios, "card": smi}
    print(f"  loss float64 {l64:.10f}, sharded float32 {l32:.10f} (relative "
          f"{rec['b']['loss_rel']:.3e}, limit {F64_LOSS_REL}); gradient leaves' largest "
          f"deviation over 1e-4 max|g64|: {max(ratios.values()):.3f} ({max(ratios, key=ratios.get)}"
          f", largest of {len(ratios)}) [{smi}]", flush=True)
    check(rec["b"]["loss_rel"] <= F64_LOSS_REL, "16b: the sharded loss strayed from float64")
    check(max(ratios.values()) <= 1.0, "16b: a sharded gradient leaf past 1e-4 max|g64|")
    log.end("16b", t0)

    t0 = log.begin("16e", f"ef_compressed_psum over the data axis ({n_data} shards) of the "
                          f"replicas' gradients of {list(EF_LEAVES)}, two error-feedback "
                          "steps: the card against the CPU run bit for bit, the identity, "
                          "the distance from the exact sum")
    cpu_mesh = make_mesh(*MESH_TRAIN_SHAPE, device="cpu")

    def ef_check(grads: list) -> dict:
        """Two error-feedback steps over the data axis, each against the
        same function's CPU run; the identity and the bound."""
        errs = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]
        errs_c = [x.cpu() for x in errs]
        row = {"bitwise": True, "identity": True, "worst_over_bound": -math.inf}
        for _ in range(2):
            gs = [g.float() + x for g, x in zip(grads, errs)]
            out, errs_new = compress.ef_compressed_psum(grads, errs, mesh, "data")
            out_c, errs_c = compress.ef_compressed_psum([g.cpu() for g in grads], errs_c,
                                                        cpu_mesh, "data")
            row["bitwise"] &= all(torch.equal(x.cpu(), y) for x, y in zip(out + errs_new,
                                                                            out_c + errs_c))
            s_max = max(float(compress.quantize_int8(x)[1]) for x in gs)
            s = torch.tensor(s_max, dtype=torch.float32, device=grads[0].device)
            for x, en in zip(gs, errs_new):  # g = q scale_max + e_new, exactly
                q = torch.clamp(torch.round(x / s), -127, 127)
                row["identity"] &= bool(torch.equal(q.double() * s.double() + en.double(),
                                                    x.double()))
            exact = sum(x.double() for x in gs)
            row["worst_over_bound"] = max(row["worst_over_bound"], float(
                ((out[0].double() - exact).abs().max() - n_data * s_max / 2)))
            row["scale_max"] = s_max
            errs = errs_new
        return row

    e = rec["e"] = {}
    for name in EF_LEAVES:
        row = e[name] = ef_check([kept[r].pop(name) for r in range(n_data)])
        print(f"  {name}: card == CPU bit for bit {row['bitwise']}; g + e_old == q "
              f"scale_max + e_new exactly {row['identity']}; |reduced - exact| - D scale_max "
              f"/ 2 at most {row['worst_over_bound']:.3e} (must be <= 0; scale_max "
              f"{row['scale_max']:.3e}) [{smi}]", flush=True)
        check(row["bitwise"] and row["identity"] and row["worst_over_bound"] <= 0,
              f"16e {name}: {row}")
    del kept
    log.end("16e", t0)

    # -- 16c: timing at full width -------------------------------------------
    log.free()
    meta = lm.init_model(full, 0, device="meta")
    n_params = sum(p.numel() for p in lm.trainable(meta).values())
    per_layer = sum(p.numel() for n, p in lm.trainable(meta).items()
                    if n.startswith("blocks.0."))
    del meta
    el = torch.tensor([], dtype=full.dtype).element_size()
    rows = TRAIN_BATCH // n_data
    acts = 4 * rows * TRAIN_SEQ * full.vocab_padded * 4  # float32 logit-sized copies

    def reckon(n_layers: int) -> int:
        """Blocks, the compute model's weights, one replica's gradients and
        the accumulators (each in the parameters' dtype), two float32
        moments, and a replica's logits."""
        n = n_params - (full.n_layers - n_layers) * per_layer
        return n * (4 * el + 8) + acts

    free_b = torch.cuda.mem_get_info(dev)[0] if cuda else None
    depth = min(full.n_layers, MESH_TIMED_LAYERS)
    while cuda and depth > 1 and reckon(depth) > MESH_FIT * free_b:
        depth -= 1
    cfg_c = full if depth == full.n_layers else dataclasses.replace(full, n_layers=depth)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    c = rec["c"] = {"layers": depth, "full_layers": full.n_layers, "reckoned_bytes": reckon(depth),
                    "free_bytes": free_b, "card": smi}
    fit = f"{gb(reckon(depth))} against {gb(free_b)} free" if cuda else "no fit on the CPU"
    t0 = log.begin("16c", f"{TRAIN_ARCH} bf16 at full width, {depth} of {full.n_layers} layers "
                          f"(reckoned {fit}), "
                          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} Markov tokens, "
                          "the CLI's AdamW: the single-device step, then the sharded step on "
                          f"make_mesh{MESH_TRAIN_SHAPE}")

    def timed(step_fn, state, opt_state, label):
        steps = []
        for i in range(TRAIN_STEPS):
            log.sync()
            t_ = time.perf_counter()
            state, opt_state, metrics = step_fn(state, opt_state, data.batch_at(i))
            metrics = floats(metrics)  # the host read of the metrics, inside the time
            steps.append({"step": i, "ms": (time.perf_counter() - t_) * 1e3, **metrics})
            print(f"  {label} step {i}: loss {metrics['loss']:.4f} gnorm "
                  f"{metrics['grad_norm']:.4f} {steps[-1]['ms']:.1f} ms [{smi}]", flush=True)
        return state, opt_state, steps

    def summary(steps, peak):
        times = [s["ms"] for s in steps[1:]]
        step_ms = float(np.median(times)) if cuda else None
        return {"steps": steps, "step_ms": step_ms,
                "step_ms_range": [min(times), max(times)] if cuda else None,
                "tokens_per_s": tokens / (step_ms / 1e3) if cuda else None,
                "peak_allocated_bytes": peak}

    model = lm.init_model(cfg_c, 0, device=dev)
    opt = adamw_init(lm.trainable(model), cli_opt)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    model, opt, steps1 = timed(trainer.make_train_step(cfg_c, cli_opt), model, opt, "single")
    c["single"] = summary(steps1, torch.cuda.max_memory_allocated(dev) if cuda else None)
    del model, opt
    log.free()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sm = sharded(cfg_c)
    opt = trainer.sharded_adamw_init(sm, cli_opt, rules)
    state_bytes = sm.nbytes() + sum(s.numel() * s.element_size() for k in ("m", "v")
                                    for b in opt[k].values() for s in b.values())
    step_fn = trainer.make_sharded_train_step(cfg_c, cli_opt)
    sm, opt, steps2 = timed(step_fn, sm, opt, "mesh")
    c["mesh"] = summary(steps2, torch.cuda.max_memory_allocated(dev) if cuda else None)
    c["mesh"]["state_bytes"] = state_bytes
    check(all(np.isfinite(v) for s in steps1 + steps2 for v in s.values()),
          "16c: a metric is not finite")
    check(abs(steps2[0]["loss"] - steps1[0]["loss"]) <= 1e-2 * abs(steps1[0]["loss"]),
          "16c: the sharded step's first bf16 loss is not the single-device one's")
    # the collectives' bytes: each leaf gathered once per compute card, each
    # replica's gradient added once onto its owners (every element read once
    # and written once)
    p_bytes = sum(lay.n_blocks * math.prod(lay.block) for lay in sm.layouts.values()) * el
    c["gather_bytes"] = 2 * p_bytes * len({trainer.replica_device(mesh, r)
                                           for r in range(n_data)})
    c["reduce_bytes"] = 3 * p_bytes * n_data - p_bytes  # the first replica only writes
    if cuda:
        @contextlib.contextmanager
        def synced(name):
            """The step's own ranges, each ended by a synchronise, so that
            every device operation falls inside the range that launched it
            (the profiled step only; the timed steps run as they are)."""
            with record_function(name):
                yield
                torch.cuda.synchronize()

        log.sync()
        trainer.record_function = synced
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("mesh/step"):
                    step_fn(sm, opt, data.batch_at(TRAIN_STEPS))
                    log.sync()
        finally:
            trainer.record_function = record_function
        events = prof.events()
        c["profile"] = {"step": profile_window(events, "mesh/step")} | {
            name: profile_spans(events, f"sharded/{name}")
            for name in ("gather", "forward_backward", "reduce", "adamw")}
        s1, s2 = c["single"], c["mesh"]
        print(f"  single device: {s1['step_ms']:.1f} ms (median of steps 2-{TRAIN_STEPS}; "
              f"{s1['step_ms_range'][0]:.1f}-{s1['step_ms_range'][1]:.1f}), "
              f"{s1['tokens_per_s']:.0f} tokens/s, peak {gb(s1['peak_allocated_bytes'])}; "
              f"mesh: {s2['step_ms']:.1f} ms ({s2['step_ms_range'][0]:.1f}-"
              f"{s2['step_ms_range'][1]:.1f}), {s2['tokens_per_s']:.0f} tokens/s, peak "
              f"{gb(s2['peak_allocated_bytes'])} against {gb(reckon(depth))} reckoned "
              f"(state {gb(state_bytes)}) [{smi}]", flush=True)
        print(f"  copies a step: gathers {gb(c['gather_bytes'])}, reductions "
              f"{gb(c['reduce_bytes'])} [{smi}]", flush=True)
        for name, p_ in c["profile"].items():
            print(f"  one mesh step's {name} by torch.profiler: wall {p_['wall_ms']:.1f} ms, "
                  f"device busy {p_['busy_ms']:.1f} ms, idle share {p_['idle_share']:.4f}, "
                  f"{p_['kernels']} kernels, {p_['device_ops']} device ops [{smi}]",
                  flush=True)
    del sm, opt, step_fn
    log.end("16c", t0)

    # -- 16d: train_loop, checkpoints across meshes, the CLI -----------------
    log.free()
    t0 = log.begin("16d", "a mesh run's checkpoint restored onto one device and onto "
                          f"make_mesh{MESH_RESTORE_SHAPE}, a fault in a mesh run, the CLI "
                          "with --data 2 --model 4")
    red = get_reduced(TRAIN_ARCH)
    tiny = lm.ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                          dtype=torch.float32, remat="none", attn_chunk=16)
    d_ = rec["d"] = {}
    quiet = lambda s: None  # noqa: E731
    with tmp_mod.TemporaryDirectory() as d:
        sm, opt, _ = trainer.train_loop(
            red, acc_opt, trainer.TrainConfig(steps=3, ckpt_every=2, ckpt_dir=f"{d}/mesh"),
            SyntheticTokens(red.vocab, 4, 32, seed=2), mesh=mesh, rules=rules, log=quiet,
            device=dev)
        saved = tree_paths(trainer._state_tree(red, sm, opt))
        mgr = CheckpointManager(f"{d}/mesh")

        def same(model, opt_state) -> bool:
            got = tree_paths(trainer._state_tree(red, model, opt_state))
            return sorted(got) == sorted(saved) and all(torch.equal(got[k], saved[k])
                                                        for k in saved)

        m1 = lm.init_model(red, 1, device=dev)
        o1 = adamw_init(lm.trainable(m1), acc_opt)
        trainer._load_state(red, m1, o1, mgr.restore(2, trainer._state_like(red, m1, o1)))
        other = make_mesh(*MESH_RESTORE_SHAPE, device=dev)
        sm2 = trainer.shard_model(red, lm.init_model(red, 1, device=dev), other, rules)
        o2 = trainer.sharded_adamw_init(sm2, acc_opt, rules)
        trainer._load_state(red, sm2, o2, mgr.restore(2, trainer._state_like(red, sm2, o2)))
        d_["one_device_bitwise"], d_["other_mesh_bitwise"] = same(m1, o1), same(sm2, o2)
        print(f"  step 2's checkpoint ({len(saved)} arrays, bf16 parameters, float32 "
              f"moments) restored bit for bit onto one device: {d_['one_device_bitwise']}, "
              f"onto {other}: {d_['other_mesh_bitwise']}", flush=True)
        check(d_["one_device_bitwise"] and d_["other_mesh_bitwise"],
              "16d: a mesh checkpoint did not restore bit for bit")
        del sm, opt, m1, o1, sm2, o2
        hist = {}
        for name in ("uninterrupted", "faulted"):
            crashed = []

            def fault(step, crashed=crashed, on=name == "faulted"):
                if on and step == 15 and not crashed:
                    crashed.append(step)
                    raise RuntimeError("injected")

            _, _, hist[name] = trainer.train_loop(
                tiny, OptimConfig(lr_peak=1e-3, warmup_steps=2, total_steps=30),
                trainer.TrainConfig(steps=30, ckpt_every=10, ckpt_dir=f"{d}/{name}",
                                    log_every=1000),
                SyntheticTokens(vocab=64, batch=4, seq=16, seed=2), mesh=mesh, rules=rules,
                fault_hook=fault, log=quiet, device=dev)
        run = [h["step"] for h in hist["faulted"]]
        ref = {h["step"]: h["loss"] for h in hist["uninterrupted"]}
        worst = max(abs(h["loss"] - ref[h["step"]]) / abs(ref[h["step"]])
                    for h in hist["faulted"])
        d_["fault"] = {"steps": run, "worst_rel": worst}
        print(f"  faulted mesh run: {len(run)} steps, last {run[-1]}, step 15 "
              f"x{run.count(15)}, step 11 x{run.count(11)}; worst loss deviation from the "
              f"uninterrupted mesh run {worst:.3e} (limit 1e-5)", flush=True)
        check(run[-1] == 29 and run.count(15) == 1 and run.count(11) == 2,
              f"16d: the faulted mesh run's steps {run}")
        check(worst <= 1e-5, f"16d: a replayed loss moved {worst:.3e}")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
               "--reduced", "--steps", "20", "--markov", "--ckpt-dir", f"{d}/cli",
               "--data", str(MESH_TRAIN_SHAPE[1]), "--model", str(MESH_TRAIN_SHAPE[2]),
               "--device", "cuda" if cuda else "cpu"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
        check(proc.returncode == 0, f"16d: the train CLI failed: {proc.stderr[-1500:]}")
        if proc.returncode == 0:
            summary_ = json.loads(proc.stdout.strip().splitlines()[-1])
            d_["cli"] = summary_
            print(f"  {' '.join(cmd[1:])}: {json.dumps(summary_)} [{smi}]", flush=True)
            check(summary_["steps"] == 20 and np.isfinite(summary_["last_loss"])
                  and summary_["mesh"] == {"data": MESH_TRAIN_SHAPE[1],
                                           "model": MESH_TRAIN_SHAPE[2]}
                  and summary_["n_devices"] == mesh.n_devices,
                  f"16d: the CLI's summary {summary_}")
    log.end("16d", t0)

    # -- 16f: no kernel -------------------------------------------------------
    launches = dict(_build.LAUNCHES)
    rec["launches"] = launches
    rec["total_s"] = time.perf_counter() - t_phase
    print(f"phase 16: kernel launches over the phase {launches or '{}'} (must be none); "
          f"wall time {rec['total_s']:.1f}s [{smi}]", flush=True)
    check(not any(launches.values()), f"16f: kernels launched on the mesh path: {launches}")
    if log.failures:
        fail("phase 16: " + "; ".join(log.failures))
    return launches


def mesh_train_main(out_path: str) -> None:
    """``python3 chip_smoke.py --mesh-train-phase OUT``: phase 16 in a
    fresh process, its record to OUT."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: phase 16 needs a card")
    record: dict = {}
    launches = mesh_train_phase(torch.device("cuda"), record)
    Path(out_path).write_text(json.dumps({"mesh_train": record["mesh_train"],
                                          "launches": launches}, default=str))


DRY_ARCH = "qwen1.5-4b"  # 17a, 17b: 15a's train cell and 11g's dense decode cell
DRY_TRAIN_LAYERS = 20  # 17a: the train step at half of qwen1.5-4b's 40 layers (C.37)
MATMUL_EVENTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
DRY_FLOPS_REL = 1e-3  # 17a, 17b: analyzer matmul FLOPs against the profiler's
DRY_ARG_REL, DRY_TEMP_REL = 0.01, 0.15  # 17a: the state and the step's temporaries
DRY_CELLS = (("qwen1.5-4b", "train_4k"), ("llama3-405b", "decode_32k"))  # 17c, on 16x16
UPDATE_BYTES_15A = 630e9  # PERF.md §5: what 15a's AdamW update moves, by its kernels


def matmul_flops_of(events, ran: bool) -> tuple[float, int]:
    """The profiler's FLOPs (``with_flops``) of the matmul ops and the count
    of matmul events left out.  ``ran``: only the events that launched a
    kernel on the card.  The profiler records an op, and its FLOPs, when
    it is called, and ``torch.utils.checkpoint``'s early stop raises inside
    the recomputed block's last matmul before it runs (``remat="full"``:
    one such call a block), so a call that launched nothing did no work."""
    mm = [e for e in events if e.name in MATMUL_EVENTS]
    kept = [e for e in mm if e.kernels] if ran else mm
    return float(sum(e.flops or 0 for e in kept)), len(mm) - len(kept)


def dryrun_phase(dev, record: dict, *, reduced: bool = False) -> dict:
    """Phase 17: the dry-run tools (``launch.op_analysis``, ``launch.dryrun``,
    ``launch.roofline``, ``core.traffic``; plain torch, no kernel) held
    against the card on cells that fit it.  ``reduced``: the reduced
    qwen1.5-4b in 17a and 17b and a CPU rehearsal: the profiler's CPU
    FLOPs are held, no time, bound or allocator figure.  Returns the
    launch counts over the phase, which must all be 0."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core import traffic
    from repro_torch.core.metrics import spmv_app_bytes
    from repro_torch.data.pipeline import MarkovTokens
    from repro_torch.data.suite import generate
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import OpAnalyzer
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptimConfig, adamw_init, adamw_update
    from repro_torch.runtime import trainer
    from repro_torch.runtime.server import BatchedServer, _merge_slot

    rec = record.setdefault("dryrun", {})
    log = PhaseLog(dev, rec)
    cuda, smi, check, sync, free, begin, end = (log.cuda, log.smi, log.check, log.sync,
                                                log.free, log.begin, log.end)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_launches()
    cfg = get_reduced(DRY_ARCH) if reduced else get_config(DRY_ARCH)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def held(label: str, an: dict, prof_flops: float, busy_ms: float | None) -> dict:
        """The FLOPs and bound checks of one analysed step against its
        profile; the figures, printed and returned."""
        cost = an["cost"]
        rel = abs(cost.matmul_flops - prof_flops) / max(prof_flops, 1.0)
        out = {"matmul_flops": cost.matmul_flops, "profiler_matmul_flops": prof_flops,
               "matmul_rel": rel, "flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
               "n_ops": an["n_ops"], "n_compute_ops": an["n_compute_ops"],
               "t_compute_ms": cost.flops / roofline.PEAK_FLOPS * 1e3,
               "t_memory_ms": cost.hbm_bytes / roofline.HBM_BW * 1e3, "t_collective_ms": 0.0,
               "busy_ms": busy_ms}
        print(f"  {label}: analyzer matmul {cost.matmul_flops:.6e} FLOPs, profiler "
              f"{prof_flops:.6e} (rel {rel:.2e}); all FLOPs {cost.flops:.6e}, HBM bytes "
              f"{cost.hbm_bytes:.6e}; {an['n_ops']} aten ops ({an['n_compute_ops']} not "
              f"views); terms compute {out['t_compute_ms']:.3f} ms, memory "
              f"{out['t_memory_ms']:.3f} ms, collective 0 ms"
              + (f"; device busy {busy_ms:.3f} ms" if busy_ms is not None else ""), flush=True)
        check(rel <= DRY_FLOPS_REL, f"{label}: analyzer matmul FLOPs {cost.matmul_flops:.6e} "
                                    f"against the profiler's {prof_flops:.6e} (rel {rel:.2e})")
        if busy_ms is not None:
            check(out["t_compute_ms"] <= busy_ms, f"{label}: FLOPs bound {out['t_compute_ms']:.3f} "
                                                  f"ms above the busy {busy_ms:.3f} ms")
            check(out["t_memory_ms"] <= busy_ms, f"{label}: bytes bound {out['t_memory_ms']:.3f} "
                                                 f"ms above the busy {busy_ms:.3f} ms")
        return out

    # -- 17a: 15a's train step, analysed on meta and profiled on the card --
    # (at DRY_TRAIN_LAYERS of its 40 layers on the card, C.37)
    cfg_a = cfg if reduced else dataclasses.replace(cfg, n_layers=DRY_TRAIN_LAYERS)
    free()
    t0 = begin("17a", f"{DRY_ARCH} train step ({cfg_a.n_layers} layers, {TRAIN_BATCH} x "
                      f"{TRAIN_SEQ}, AdamW float32 moments, one device): op_analysis on "
                      f"meta against the card")
    opt_cfg = OptimConfig(lr_peak=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    meta_batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32, device="meta")
                  for k in ("tokens", "labels")}
    t_an = time.perf_counter()
    an = dryrun.analyze_train_step(cfg_a, meta_batch, opt_cfg)
    an_s = time.perf_counter() - t_an
    meta_model = lm.init_model(cfg_a, device="meta")
    meta_params = lm.trainable(meta_model)
    meta_grads = {n: torch.empty_like(p) for n, p in meta_params.items()}
    meta_opt = adamw_init(meta_params, opt_cfg)
    with OpAnalyzer() as an_upd:
        adamw_update(meta_grads, meta_opt, meta_params, opt_cfg)
    upd = an_upd.cost()
    mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
    model = lm.init_model(cfg_a, 0, device=dev)
    opt_state = adamw_init(lm.trainable(model), opt_cfg)
    sync()
    state_bytes = (torch.cuda.memory_allocated(dev) - mem0) if cuda else None
    data = MarkovTokens(cfg_a.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch_at(0).items()}
    step = trainer.make_train_step(cfg_a, opt_cfg)
    model, opt_state, _ = step(model, opt_state, batch)  # warm-up
    sync()
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=acts, with_flops=True) as prof:
        with record_function("dryrun/train_step"):
            model, opt_state, _ = step(model, opt_state, batch)
            sync()
    temp_meas = (torch.cuda.max_memory_allocated(dev) - base) if cuda else None
    step_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        model, opt_state, m = step(model, opt_state, batch)
        float(m["loss"])
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    # where the temporaries peak (reported): the forward and backward, then
    # the update, each on the card and traced on meta
    with OpAnalyzer() as an_fb:
        trainer._grads_of(cfg_a, meta_model, meta_params, meta_batch)
    pieces = {"fb_traced": an_fb.peak_bytes, "update_traced": an_upd.peak_bytes}
    if cuda:
        params = lm.trainable(model)
        sync()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _, _, grads = trainer._grads_of(cfg_a, model, params, batch)
        sync()
        pieces["fb_card"] = torch.cuda.max_memory_allocated(dev) - base
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        adamw_update(grads, opt_state, params, opt_cfg)
        sync()
        pieces["update_card"] = torch.cuda.max_memory_allocated(dev) - base
        del grads, params
    print("  17a: temporaries' peak by part: " + ", ".join(
        f"{k} {gb(v)}" for k, v in pieces.items()), flush=True)
    events = prof.events()
    win = profile_window(events, "dryrun/train_step") if cuda else None
    mm_flops, mm_idle = matmul_flops_of(events, ran=cuda)
    a = held("17a", an, mm_flops, win["busy_ms"] if win else None)
    a.update(temp_by_part=pieces, matmul_calls_without_kernel=mm_idle,
             profiler_matmul_flops_all_calls=matmul_flops_of(events, ran=False)[0])
    print(f"  17a: {mm_idle} matmul calls launched no kernel (left out); the profiler's "
          f"matmul FLOPs over every call {a['profiler_matmul_flops_all_calls']:.6e}",
          flush=True)
    a.update(trace_s=an_s, argument_bytes=an["argument_bytes"], temp_bytes=an["temp_bytes"],
             state_bytes=state_bytes, temp_measured=temp_meas,
             step_ms=sorted(step_ms)[1], update_bytes=upd.hbm_bytes,
             update_flops=upd.flops, profile=win)
    print(f"  17a: traced on meta in {an_s:.1f}s; the update alone (adamw_update traced) "
          f"{gb(upd.hbm_bytes)} against the ≈ {gb(UPDATE_BYTES_15A)} its kernels moved in "
          f"15a; step {a['step_ms']:.1f} ms (median of 3)"
          + (f", kernels {win['kernels']}, idle share {win['idle_share']:.3f}" if win else ""),
          flush=True)
    if cuda:
        arg_rel = abs(an["argument_bytes"] - state_bytes) / state_bytes
        temp_rel = abs(an["temp_bytes"] - temp_meas) / temp_meas
        a.update(argument_rel=arg_rel, temp_rel=temp_rel)
        print(f"  17a: argument_size {gb(an['argument_bytes'])} against allocated "
              f"{gb(state_bytes)} (rel {arg_rel:.4f}); temp_size {gb(an['temp_bytes'])} "
              f"against the step's peak less the state {gb(temp_meas)} (rel {temp_rel:.4f})",
              flush=True)
        check(arg_rel <= DRY_ARG_REL, f"17a: argument_size off by {arg_rel:.4f}")
        check(temp_rel <= DRY_TEMP_REL, f"17a: temp_size off by {temp_rel:.4f}")
    rec["17a"] = a
    del model, opt_state, batch, prof, events
    end("17a", t0)

    # -- 17b: the dense bf16 decode step at LM_SLOTS slots --------------------
    free()
    t0 = begin("17b", f"{DRY_ARCH} dense bf16 decode step at {LM_SLOTS} slots "
                      f"(max_seq {LM_MAX_SEQ}): op_analysis on meta against the card")
    an = dryrun.analyze_decode_step(cfg, LM_SLOTS, LM_MAX_SEQ)
    model = lm.init_model(cfg, 0, device=dev)
    state = lm.init_decode_state(cfg, LM_SLOTS, LM_MAX_SEQ, device=dev)
    toks = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=dev)
    steps = {"eager": lambda: lm.decode_step(cfg, model, state, toks)}
    if cuda:
        rng = np.random.default_rng(0)
        srv = BatchedServer(cfg, model, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
        for i in range(LM_SLOTS):
            one, _ = srv._prefill_one(rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32))
            _merge_slot(srv.state, one, i)
        host_toks = np.zeros((LM_SLOTS, 1), np.int64)
        steps["graph"] = lambda: srv._decode_once(host_toks)
    for _ in range(3):
        for fn in steps.values():
            fn()
    sync()
    with profile(activities=acts, with_flops=True) as prof:
        for name, fn in steps.items():
            with record_function(f"dryrun/decode_{name}"):
                fn()
                sync()
    events = prof.events()
    flops_eager, _ = matmul_flops_of(events, ran=cuda)
    wins = ({name: profile_window(events, f"dryrun/decode_{name}") for name in steps}
            if cuda else {})
    b = held("17b", an, flops_eager, wins["graph"]["busy_ms"] if cuda else None)
    b.update(argument_bytes=an["argument_bytes"], profile=wins)
    # what a step must read: every weight but the embedding table, whose
    # rows alone are read (7.124 GB at full size, PERF.md §4)
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    must_read = weights - model.embed.numel() * model.embed.element_size()
    b.update(weight_bytes=weights, must_read_bytes=must_read)
    print(f"  17b: HBM bytes {gb(an['cost'].hbm_bytes)} against the {gb(must_read)} of "
          f"weights a step reads ({gb(weights)} with the embedding table)"
          + "".join(f"; {n}: busy {w['busy_ms']:.3f} ms, {w['kernels']} kernels"
                    for n, w in wins.items()), flush=True)
    check(an["cost"].hbm_bytes >= must_read, f"17b: HBM bytes {an['cost'].hbm_bytes:.4e} "
                                             f"under the weights' {must_read:.4e}")
    rec["17b"] = b
    del model, state, steps, prof
    if cuda:
        del srv
    end("17b", t0)

    # -- 17c: production cells on 16x16 logical cards, no card -------------
    t0 = begin("17c", "dry-run cells on make_production_mesh() (256 logical cards, meta)")
    rec["17c"] = {}
    for arch, shape in DRY_CELLS:
        t1 = time.perf_counter()
        cell = dryrun.reckon_cell(get_config(arch), shape, make_production_mesh(),
                                  dict(dryrun.TRAIN_KNOBS.get(arch, {})))
        secs = time.perf_counter() - t1
        out = {k: cell[k] for k in ("per_device", "memory", "mesh_totals", "depth",
                                    "compute_cards", "n_micro", "placement")}
        out["seconds"] = secs
        t = roofline.terms({"arch": arch, "shape": shape, "mesh": "16x16", **out})
        out["terms"] = t
        rec["17c"][f"{arch}/{shape}"] = out
        print(f"  17c {arch} {shape} 16x16 in {secs:.1f}s: {json.dumps(out, default=str)}",
              flush=True)
        check(all(math.isfinite(v) and v > 0 for v in (
            out["per_device"]["flops"], out["per_device"]["hbm_bytes"])),
              f"17c: {arch} {shape} figures not finite and positive")
    end("17c", t0)

    # -- 17d: the paper's Fig 6 figures for cant through core.traffic ------
    t0 = begin("17d", "Fig 6 on cant at scale 1.0 (61 cores, 64-row chunks, 8192-line LRU)")
    a_cant = generate("cant", scale=1.0)
    m, n = a_cant.shape
    app = spmv_app_bytes(m, n, a_cant.nnz)
    inf = traffic.actual_spmv_bytes(a_cant)
    lru = traffic.actual_spmv_bytes(a_cant, cache_lines=8192)
    va = traffic.vector_access_multiplier(a_cant)
    shards = traffic.shard_vector_access(a_cant, 4)
    rec["17d"] = {"app_bytes": app, "actual_infinite": inf, "actual_lru": lru,
                  "vector_access": va, "shards4": shards}
    print(f"  17d: cant application bytes {app}, actual (infinite cache) {inf} "
          f"({inf / app:.4f}x), actual (LRU 8192 lines) {lru} ({lru / app:.4f}x), vector "
          f"access {va:.4f}x; over 4 row shards allgather {shards['allgather_bytes']:.0f} B "
          f"against on-demand {shards['ondemand_bytes']:.0f} B", flush=True)
    check(lru >= inf >= app - 2 * n * 4, "17d: the traffic counts out of order")
    end("17d", t0)

    launches = dict(_build.LAUNCHES)
    rec["launches"] = launches
    rec["total_s"] = time.perf_counter() - t_phase
    print(f"phase 17: kernel launches over the phase {launches or '{}'} (must be none); "
          f"wall time {rec['total_s']:.1f}s [{smi}]", flush=True)
    check(not any(launches.values()), f"17: kernels launched by the dry-run phase: {launches}")
    if log.failures:
        fail("phase 17: " + "; ".join(log.failures))
    return launches


def dryrun_main(out_path: str) -> None:
    """``python3 chip_smoke.py --dryrun-phase OUT``: phase 17 in a fresh
    process, its record to OUT."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: phase 17 needs a card")
    record: dict = {}
    launches = dryrun_phase(torch.device("cuda"), record)
    Path(out_path).write_text(json.dumps({"dryrun": record["dryrun"],
                                          "launches": launches}, default=str))


# -- phase 18: the public surface and the examples' twins --------------------
EXAMPLES = ROOT / "examples"
SERVE_ARCHES = ("deepseek-67b", "llama3-405b")  # 18f: at the depth vl_layers reckons
SERVE_KS = (LM_SLOTS, LM_PROMPT)  # 18f: kernel 3's widths, a decode step and a prefill
EX_TRAIN_STEPS, EX_RESUME_AT = 300, 250  # 18d: train_lm --big, resumed from a checkpoint
EX_SPARSE_STEPS = 20  # 18e: train_lm --sparse
# 18d: the learning check.  The example's schedule (lr 6e-4, 20 warmup
# steps, cosine to 0 over 300) takes --big's width cut to EX_CUT_LAYERS
# layers 2.76 nat down: its loss sits near the chain's stationary entropy
# until step ~120, then learns the transitions.  At 12 layers (d 384) it
# learns the stationary distribution and stalls there to step 300, 0.50 nat
# down.  The JAX package and the port agree on both, within 6.1e-6 and
# 2.8e-6 relative at every step on the same weights and data
# (tests/witness_train_lm.py on the CPU; PERF.md §6).  So the cut is held
# to the 1-nat drop on the card, and --big to EX_LEARN_NATS: the JAX
# package's 12-layer drop less 0.1 nat for the width and the initial
# weights.  Both last-20 means stay below log(vocab), the uniform
# predictor's loss, and not below the chain's entropy floor less
# EX_FLOOR_SLACK (a loss under the floor would mean the labels leak).
EX_CUT_LAYERS, EX_CUT_LEARN_NATS = 2, 1.0
EX_LEARN_NATS = 0.4
EX_FLOOR_SLACK = 0.05
EX_RESUME_REL = 1e-5  # 18d: a resumed run's losses against the first run's
EX_RITZ_ITERS, EX_RITZ_REL = 500, 1e-3  # 18c: block power run on, held to eigsh's
EX_MEMORY_SHARE = 0.01  # 18f: allocated bytes back within this share once a model is freed


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module, to call its ``main``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}_torch",
                                                  EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def row_held(log, what: str, got, ref, scale, quiet: bool = False) -> float:
    """Every entry of ``got`` within TOL (|A| |x|)_i (``scale``) of ``ref``,
    finite and of its shape; a miss goes to ``log``'s failures, or ends the
    run where ``log`` is None.  Returns the largest |got - ref|."""
    import numpy as np
    import torch

    def host(t):
        return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                          np.float64)

    got, ref, scale = host(got), host(ref), host(scale)
    ok = got.shape == ref.shape and bool(np.isfinite(got).all())
    try:
        scale = np.broadcast_to(scale, got.shape)
    except ValueError:
        ok = False
    err = np.abs(got - ref) if ok else np.full(1, np.inf)
    bad = int((err > TOL * scale).sum()) if ok else -1
    msg = f"{what}: shape {got.shape} against {ref.shape}, {bad} entries over {TOL:g} (|A| |x|)_i"
    if log is not None:
        log.check(ok and bad == 0, msg)
    elif not (ok and bad == 0):
        fail(msg)
    m = float(err.max()) if err.size else 0.0
    if ok and not bad and not quiet:
        print(f"  ok {what}: max_abs_err {m:.3e}", flush=True)
    return m


def streamed_first_logits(cfg, model, prompts):
    """The first-token logits of the dense transformer ``model`` (its own
    dtype) computed in float32 at its full depth, one block widened at a
    time, since a float32 copy of the whole depth would not fit beside it:
    each block runs as ``lm.forward`` runs it (``lm._attn_seq``,
    ``lm._ffn``); the embedding rows and the unembedding (in column chunks)
    are widened as they are read.  Prompts of one length."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    dev = model.device
    cfg_f = dataclasses.replace(cfg, dtype=torch.float32, n_layers=1)
    blk, norm = lm.Block(cfg_f, dev), lm.Norm(cfg_f, cfg.d_model, dev)
    norm.load_state_dict(model.ln_f.state_dict())
    toks = torch.as_tensor(np.stack(prompts), device=dev).long()
    with torch.no_grad():
        h = model.embed[toks].float()
        angles = lm._rotary(cfg_f, lm._positions({}, *toks.shape, dev))
        for src in model.blocks:
            blk.load_state_dict(src.state_dict())
            h = h + lm._attn_seq(cfg_f, blk.attn, blk.ln1(h), angles)[0]
            h = h + lm._ffn(cfg_f, blk.ffn, blk.ln2(h))[0]
        last = norm(h[:, -1])
        step = 16384
        return torch.cat([last @ model.unembed[:, c:c + step].float()
                          for c in range(0, model.unembed.shape[1], step)], dim=1)


def memory_note(label: str, base: int, log) -> dict:
    """ROADMAP C.31 on this path: with every server and model of ``label``
    freed, the allocator's bytes must come back within EX_MEMORY_SHARE of
    ``base`` (what it held before the model was built).  Where they do not,
    the largest live blocks are printed with the Python stacks that
    allocated them (recorded over 18f outside its timings)."""
    import torch

    log.free()
    now = torch.cuda.memory_allocated()
    ok = abs(now - base) <= EX_MEMORY_SHARE * base
    print(f"  {label} freed: {now / 1e9:.4f} GB allocated against {base / 1e9:.4f} GB "
          f"before it was built ({'back' if ok else 'NOT back'} within "
          f"{EX_MEMORY_SHARE:.0%})", flush=True)
    if not ok:
        blocks = [b for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
                  if b["state"] == "active_allocated"]
        for b in sorted(blocks, key=lambda b: -b["size"])[:8]:
            frames = [f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']} {f['name']}"
                      for f in b.get("frames", []) if f["filename"].endswith(".py")][:6]
            print(f"    live block {b['size'] / 1e6:.1f} MB: " + " <- ".join(frames))
    log.check(ok, f"{label}: {now / 1e9:.4f} GB stay allocated after it was freed "
                  f"(before: {base / 1e9:.4f} GB)")
    return {"before_bytes": base, "after_bytes": now, "back": ok}


def examples_phase(dev, record: dict, *, reduced: bool = False) -> dict:
    """Phase 18: each example twin's ``main`` on the card, then deepseek-67b
    and llama3-405b served at the depth ``vl_layers`` reckons (``reduced``:
    a CPU rehearsal on the reduced configs, the eigensolver's ``--smoke``
    and a tiny training config; no time, launch or memory check).  Returns
    the launch counts of the twins' runs and the servers' serving runs."""
    import shutil

    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.linalg import eigsh

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain, bf16_tensor_core_path
    from repro_torch.kernels.sell_spmv import sell_spmv_plain
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig

    rec = record.setdefault("examples", {})
    log = PhaseLog(dev, rec)
    cuda, smi, check, free, begin, end = (log.cuda, log.smi, log.check, log.free,
                                          log.begin, log.end)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = ["--device", dev.type]
    launches: collections.Counter = collections.Counter()
    rows: list = []
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_examples_")
    # the eigensolver builds on the default plan cache: keep it in this run
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tmp.name) / "plans.json")

    def counted(fn):
        _build.reset_launches()
        out = fn()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        launches.update(got)
        return out, got

    def csr64(a):
        return sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                             shape=a.shape)

    def engine_held(label, A, xs, ys, events, summary):
        worst = 0.0
        for xi, yi in zip(xs, ys):
            xi = np.asarray(xi.cpu() if torch.is_tensor(xi) else xi, np.float64)
            worst = max(worst, row_held(log, f"{label} request", yi, A @ xi, abs(A) @ abs(xi),
                                        quiet=True))
        bad = [e for e in events if e in ("batch_failed", "demote", "batch_abandoned")]
        check(not bad and not summary["demotions"] and not summary["failed_batches"],
              f"{label}: supervisor events {bad}, demotions {summary['demotions']}")
        print(f"  ok {label}: {len(xs)} futures within {TOL:g} (|A| |x|)_i of float64 "
              f"(max_abs_err {worst:.3e}), no demotion, no failed batch", flush=True)

    # -- 18a: quickstart ----------------------------------------------------
    t0 = begin("18a", "examples/quickstart_torch.py (cant at 1/64)")
    q, got = counted(lambda: load_example("quickstart").main(device))
    print(f"  launches {got}", flush=True)
    if cuda:
        check(got.get("sell_spmv", 0) > 0 and got.get("bcsr_spmm", 0) > 0,
              f"18a: kernels 1 and 3 not both launched: {got}")
    a, x, X, sell, p = q["a"], q["x"], q["X"], q["sell"], q["bcsr"]
    m, n = a.shape
    A = csr64(a)
    x64, X64 = x.cpu().numpy().astype(np.float64), X.cpu().numpy().astype(np.float64)
    s1, s16 = abs(A) @ abs(x64), abs(A) @ abs(X64)
    errs = {"sell": row_held(log, "18a SELL kernel against its plain version", q["y_k"],
                             sell_spmv_plain(sell["cols"], sell["vals"], x,
                                             sell["row_perm"], m), s1)}
    row_held(log, "18a SELL kernel against float64", q["y_k"], A @ x64, s1)
    (gm, gn), (bm, bk) = p["grid_shape"], p["block_shape"]
    xb = torch.zeros((gn * bk, X.shape[1]), device=x.device)
    xb[:n] = X
    Yp = bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"],
                         xb.view(gn, bk, -1)).reshape(gm * bm, -1)[:m]
    errs["bcsr"] = row_held(log, "18a BCSR kernel (8, 16), k = 16 against its plain "
                                 "version", q["Y_k"], Yp, s16)
    row_held(log, "18a BCSR kernel against float64", q["Y_k"], A @ X64, s16)
    for key, want, scale in (("y", A @ x64, s1), ("Y", A @ X64, s16), ("y_t", A @ x64, s1)):
        row_held(log, f"18a {key} against float64", q[key], want, scale)
    check(q["from_cache"], "18a: the rebuild was not a plan-cache hit")
    engine_held("18a engine", A, q["engine_xs"], q["engine_ys"], q["engine_events"],
                q["engine"])
    rec["18a"] = {"launches": got, "plan": q["plan"], "engine_plans": q["engine_plans"],
                  "engine": q["engine"], "max_abs_err": errs}
    del q, sell, p, xb, Yp
    free()
    end("18a", t0)

    # -- 18b: serve_decode --------------------------------------------------
    t0 = begin("18b", "examples/serve_decode_torch.py (cant at 1/128; a 4-layer d 256 "
                      "float32 LM at 1, 4 and 8 slots)")
    sd, got = counted(lambda: load_example("serve_decode").main(device))
    toks = {s: v["tokens"] for s, v in sd["lm"].items()}
    check(toks[4] == toks[1] and toks[8] == toks[1],
          "18b: the 4- and 8-slot servers' tokens differ from the 1-slot server's")
    print(f"  ok 18b: the 4- and 8-slot tokens equal the 1-slot tokens; tok/s "
          + ", ".join(f"{s} slots {v['tok_per_s']:.1f}" for s, v in sd["lm"].items())
          + f" [{smi}]", flush=True)
    eng = sd["engine"]
    engine_held("18b engine", csr64(eng["a"]), eng["xs"], eng["ys"], eng["events"],
                eng["summary"])
    rec["18b"] = {"launches": got, "tok_per_s": {s: v["tok_per_s"] for s, v in sd["lm"].items()},
                  "graphs": {s: v["graphs"] for s, v in sd["lm"].items()},
                  "engine_req_per_s": eng["engine_req_per_s"],
                  "seq_req_per_s": eng["seq_req_per_s"]}
    del sd, eng
    free()
    end("18b", t0)

    # -- 18c: sparse_eigensolver --------------------------------------------
    t0 = begin("18c", "examples/sparse_eigensolver_torch.py"
                      + (" --smoke" if reduced else " (full size)"))
    es, got = counted(lambda: load_example("sparse_eigensolver").main(
        device + (["--smoke"] if reduced else [])))  # asserts its 5 % itself
    A = csr64(es["a"])
    la = float(eigsh(A, k=1, which="LA")[0][0])
    res = es["solver"].block_power(8, tol=-1.0, maxiter=EX_RITZ_ITERS, seed=0)
    rel = abs(float(res.eigenvalues.max()) - la) / abs(la)
    print(f"  18c: the example's 60 iterations: dominant |eig| rel-err {es['rel_err']:.4%} "
          f"(limit 5 %); run on to {res.iterations} iterations: largest Ritz value "
          f"{float(res.eigenvalues.max()):.8f} against eigsh LA {la:.8f}, rel {rel:.3e} "
          f"(limit {EX_RITZ_REL:g})", flush=True)
    check(rel <= EX_RITZ_REL, f"18c: largest Ritz value {rel:.3e} from eigsh's")
    rec["18c"] = {"launches": got, "plan": es["plan"], "rel_err_60": es["rel_err"],
                  "ritz_rel_to_eigsh": rel, "iterations": res.iterations}
    del es, res
    free()
    end("18c", t0)

    # -- 18d, 18e: train_lm ---------------------------------------------------
    mod = load_example("train_lm")
    steps, resume_at = EX_TRAIN_STEPS, EX_RESUME_AT
    if reduced:  # a tiny model for the rehearsal
        mod.BIG_DIMS = mod.SMALL_DIMS = dict(n_layers=2, d_model=64, n_heads=4,
                                             n_kv_heads=2, d_ff=128, vocab=64)
        mod.SEQ, steps, resume_at = 32, 60, 50
    t0 = begin("18d", f"examples/train_lm_torch.py --big --steps {steps}, its depth cut to "
                      f"{EX_CUT_LAYERS} layers and resumed from its step-{resume_at} "
                      "checkpoint, then whole")

    def train(argv, ckpt):
        return mod.main(argv + ["--ckpt-dir", str(ckpt)] + device)

    def learning(label, losses, floor, log_v, nats):
        """The first 5 and last 20 losses' means, printed with the curve,
        and whether the last 20 sit below log V, ``nats`` below the first
        5 and not under the floor less EX_FLOOR_SLACK (held on a card)."""
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-20:]))
        ok = (all(np.isfinite(losses)) and last < log_v and last <= first - nats
              and last >= floor - EX_FLOOR_SLACK)
        print(f"  18d {label}: losses " + " ".join(f"{i}:{losses[i]:.4f}" for i in
                                                  range(0, len(losses), 30))
              + f"; the last 20 losses' mean {last:.4f} against log(vocab) {log_v:.4f}, "
              f"the first 5's mean less {nats} ({first - nats:.4f}) and the floor less "
              f"{EX_FLOOR_SLACK} ({floor - EX_FLOOR_SLACK:.4f}): "
              + ("learned" if ok else "NOT learned"), flush=True)
        if not reduced:
            check(ok, f"18d {label}: the last 20 losses' mean {last:.4f} is not below "
                      f"log(vocab) {log_v:.4f} and {nats} nat below the first 5's "
                      f"{first:.4f}, or is under the floor {floor:.4f} - {EX_FLOOR_SLACK}")
        return first, last, ok

    ck = Path(tmp.name)
    big = mod.BIG_DIMS
    mod.BIG_DIMS = dict(big, n_layers=EX_CUT_LAYERS)
    cut, _ = counted(lambda: train(["--big", "--steps", str(steps)], ck / "cut"))
    cut_losses = [h["loss"] for h in cut["history"]]
    log_v = float(np.log(cut["cfg"].vocab))
    cut_first, cut_last, cut_ok = learning(f"--big cut to {EX_CUT_LAYERS} layers", cut_losses,
                                           cut["entropy_floor"], log_v, EX_CUT_LEARN_NATS)
    rec["18d_cut"] = {"layers": EX_CUT_LAYERS, "losses": cut_losses, "first5": cut_first,
                      "last20": cut_last, "learned": cut_ok}
    # the cut run resumed from its step-resume_at checkpoint (a cut step
    # takes a fraction of a whole one's time)
    (ck / "resume").mkdir()
    shutil.copytree(ck / "cut" / f"step_{resume_at:08d}",
                    ck / "resume" / f"step_{resume_at:08d}")
    tr2, _ = counted(lambda: train(["--big", "--steps", str(steps)], ck / "resume"))
    mod.BIG_DIMS = big
    by_step = {h["step"]: h["loss"] for h in cut["history"]}
    resumed = [(h["step"], h["loss"], by_step[h["step"]]) for h in tr2["history"]]
    worst = max(abs(l2 - l1) / abs(l1) for _, l2, l1 in resumed)
    check([s for s, _, _ in resumed] == list(range(resume_at + 1, steps)),
          f"18d: the resumed run ran steps {[s for s, _, _ in resumed][:3]}...")
    check(worst <= EX_RESUME_REL, f"18d: resumed losses {worst:.3e} from the first run's")
    print(f"  ok 18d: the {EX_CUT_LAYERS}-layer cut resumed from step {resume_at}, steps "
          f"{resume_at + 1}-{steps - 1}'s losses within {worst:.3e} relative of its first "
          f"run's (limit {EX_RESUME_REL:g})", flush=True)
    del cut, tr2
    t_run = time.perf_counter()
    tr, got = counted(lambda: train(["--big", "--steps", str(steps)], ck / "run"))
    wall = time.perf_counter() - t_run
    hist = tr["history"]
    losses = [h["loss"] for h in hist]
    floor = tr["entropy_floor"]
    step_ms = float(np.median([h["time_s"] for h in hist[1:]])) * 1e3
    tokens = mod.BATCH * mod.SEQ
    params = sum(t.numel() for t in tr["model"].parameters())
    peak = torch.cuda.max_memory_allocated() if cuda else None
    print(f"  18d: {params / 1e6:.1f} M parameters, {len(hist)} steps in {wall:.1f}s: step "
          f"{step_ms:.2f} ms (median), {tokens / step_ms * 1e3:.0f} tokens/s, allocator "
          f"peak {gb(peak) if peak else 'n/a'} [{smi}]; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, entropy floor {floor:.4f}", flush=True)
    check(all(np.isfinite(losses)) and len(hist) == steps, "18d: a loss is not finite")
    first, last, learned = learning("--big", losses, floor, log_v, EX_LEARN_NATS)
    rec["18d"] = {"launches": got, "params": params, "losses": losses, "step_ms": step_ms,
                  "tokens_per_s": tokens / step_ms * 1e3, "peak_bytes": peak, "wall_s": wall,
                  "first5": first, "last20": last, "entropy_floor": floor, "log_vocab": log_v,
                  "learned": learned, "resume_worst_rel": worst}
    del tr
    free()
    end("18d", t0)
    t0 = begin("18e", f"examples/train_lm_torch.py --sparse --steps {EX_SPARSE_STEPS}")
    ts, got = counted(lambda: train(["--sparse", "--steps", str(EX_SPARSE_STEPS)],
                                    ck / "sparse"))
    ls = [h["loss"] for h in ts["history"]]
    print(f"  18e: the structured sparse FFN's losses {ls[0]:.4f} -> {ls[-1]:.4f} (mean of "
          f"the first 5 {np.mean(ls[:5]):.4f}, of the last 5 {np.mean(ls[-5:]):.4f}); "
          f"launches {got or '{}'}", flush=True)
    check(all(np.isfinite(ls)) and ls[-1] < ls[0] and np.mean(ls[-5:]) < np.mean(ls[:5]),
          "18e: the sparse FFN's losses are not finite and falling")
    rec["18e"] = {"launches": got, "losses": ls}
    del ts
    free()
    end("18e", t0)

    # -- 18f: deepseek-67b and llama3-405b at the depth one card holds ------
    chk = ServingChecks(dev, rec, reduced)
    block = (32, 32) if reduced else (128, 128)
    path = "tensor cores" if bf16_tensor_core_path(*block) else "CUDA cores"
    sff = SparseFFNConfig(kind="bcsr", block=block)
    rng = np.random.default_rng(18)

    @contextlib.contextmanager
    def timing():
        """Allocation stacks off while 18f times: recording one costs host
        time inside the CUDA-event timings.  Blocks allocated here print no
        stack in ``memory_note``."""
        if cuda:
            torch.cuda.memory._record_memory_history(enabled=None)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.memory._record_memory_history(max_entries=100_000)

    if cuda:
        torch.cuda.memory._record_memory_history(max_entries=100_000)
    for arch in SERVE_ARCHES:
        full = (get_reduced if reduced else get_config)(arch)
        layers, reckoned = vl_layers(full)
        cfg = dataclasses.replace(full, n_layers=layers)
        r = rec.setdefault(arch, {"layers": layers, "of": full.n_layers,
                                  "reckoned_gb": reckoned / 1e9})
        prng = np.random.default_rng(0)
        prompts = [prng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
                   for _ in range(LM_REQUESTS)]
        lmb = LMBench(dev, prompts)
        label = f"18f {arch}"
        base = torch.cuda.memory_allocated() if cuda else 0
        t0 = chk.begin(label, f"{arch} bf16 at full width (d {cfg.d_model}, {cfg.n_heads} "
                              f"heads over {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
                              f"{cfg.vocab}), cut to {layers} of {full.n_layers} layers: "
                              f"reckoned {reckoned / 1e9:.2f} GB of weights [{smi}]")
        r["cli"] = chk.cli(full, reduced=True)
        model = lm.init_model(cfg, 0, device=dev)
        r["params"] = lm.param_count(model)
        with timing():
            r["dense"] = chk.served(cfg, model, lmb)
            r["dense"]["bounds"] = av_bounds(cfg, model, r["dense"]["times"], {})
        # bf16 against float32 at the served depth: reported, not held (C.22)
        full_dev = rel_dev(chk.first_logits(cfg, model, prompts),
                           streamed_first_logits(cfg, model, prompts))
        r["bf16_vs_f32_served_depth"] = full_dev
        print(f"  {arch}, {layers} layers (the served depth): bf16 first-token logits "
              f"deviate {min(full_dev):.4e}-{max(full_dev):.4e} x max|logits| from float32 "
              "blocks streamed one at a time (reported, not held)", flush=True)
        del model
        lmb.free()
        # the first BF16_CHECK_LAYERS layers, built afresh from seed 0 (the
        # served model's own: the layers are drawn in order), since a copy
        # beside the served model would not fit
        cut = dataclasses.replace(cfg, n_layers=min(BF16_CHECK_LAYERS, layers))
        model_cut = lm.init_model(cut, 0, device=dev)
        cut_f = dataclasses.replace(cut, dtype=torch.float32)
        # bf16 against its float32 copy, the copy made from the host after
        # the bf16 model is freed (llama3-405b's two together take 63.6 GB)
        bf = chk.first_logits(cut, model_cut, prompts)
        host = {k: v.cpu() for k, v in model_cut.state_dict().items()}
        del model_cut
        lmb.free()
        model_cut_f = lm.LM(cut_f, dev)
        model_cut_f.load_state_dict(host)
        del host
        f32 = chk.first_logits(cut_f, model_cut_f, prompts)
        dv = rel_dev(bf, f32)
        eq = float((bf.argmax(-1) == f32.argmax(-1)).float().mean())
        r["bf16_vs_f32"] = {"layers": cut.n_layers, "dev_rel": dv, "limit": LM_BF16_LIMIT,
                            "held": True, "equal_first_tokens": eq}
        print(f"  {arch}, {cut.n_layers} of {layers} layers: bf16 first-token logits "
              f"deviate {min(dv):.4e}-{max(dv):.4e} x max|logits| from the float32 copy, "
              f"equal first tokens {eq * 100:.1f} %; held to {LM_BF16_LIMIT:g}", flush=True)
        check(max(dv) <= LM_BF16_LIMIT, f"18f {arch}: bf16 deviates {max(dv):.3e} x "
                                        "max|logits| from float32")
        del bf, f32
        # the streamed float32 forward is the model's own on the float32 copy:
        # only the summation order differs (8 prompts at once against one)
        stream_dev = max(rel_dev(streamed_first_logits(cut_f, model_cut_f, prompts),
                                 chk.first_logits(cut_f, model_cut_f, prompts)))
        check(stream_dev <= LM_CONSISTENCY, f"18f {arch}: the streamed float32 logits "
                                            f"are {stream_dev:.3e} from prefill's on the "
                                            "float32 copy")
        print(f"  ok the streamed float32 forward on the {cut.n_layers}-layer float32 copy: "
              f"{stream_dev:.3e} x max|logits| from its prefill", flush=True)
        r["consistency"] = chk.consistency(cut_f, model_cut_f, prompts, "18f")
        del model_cut_f
        if cuda:
            r["memory/dense"] = memory_note(f"{label} dense", base, log)
        cfg_b = dataclasses.replace(cfg, sparse_ffn=sff)
        model_b = lm.init_model(cfg_b, 0, device=dev)
        weights = ffn_weights(model_b.blocks[0].ffn, cfg_b)
        kerrs = {}
        for which, (args, n_cb) in weights.items():
            kerrs.update(check_bf16_products(f"{arch} {which}", args, n_cb, SERVE_KS, rng,
                                             dev, path, key=f"{arch}/{which}"))
        counters = ("bcsr_spmm_bf16", "bcsr_spmm_bf16_mma")
        with timing():
            r["bcsr"] = chk.served(cfg_b, model_b, lmb, per_pass={c: 2 * layers for c in
                                                                   counters} if cuda else None)
            r["bcsr"]["bounds"] = av_bounds(cfg_b, model_b, r["bcsr"]["times"], {})
        r["bcsr"]["kernel_checks"] = kerrs
        served = r["bcsr"]["serve"]["launches"]
        launches.update(served)
        if cuda and not reduced:
            for which, (args, n_cb) in weights.items():
                dense = densify(args, n_cb)
                with timing():
                    rows.extend(bf16_time_rows(
                        f"{arch} FFN {which}", args, n_cb, dense, SERVE_KS, rng,
                        lmb.median_ms, path, max_abs_err=max(kerrs.values()),
                        launches=int(served.get("bcsr_spmm_bf16_mma", 0))))
                del dense
        del model_b, weights, args  # the loop's last operands too
        lmb.free()
        if cuda:
            r["memory/bcsr"] = memory_note(f"{label} bcsr", base, log)
        chk.end(label, t0)
    if cuda:
        torch.cuda.memory._record_memory_history(enabled=None)
    log.failures += chk.failures

    tmp.cleanup()
    rec["rows"] = rows
    rec["launches"] = dict(launches)
    rec["total_s"] = time.perf_counter() - t_phase
    print(f"phase 18: launches {dict(launches)}; wall time {rec['total_s']:.1f}s [{smi}]",
          flush=True)
    if log.failures:
        fail("phase 18: " + "; ".join(log.failures))
    return dict(launches)


def examples_main(out_path: str) -> None:
    """``python3 chip_smoke.py --examples-phase OUT``: phase 18 in a fresh
    process, its record to OUT."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: phase 18 needs a card")
    record: dict = {}
    launches = examples_phase(torch.device("cuda"), record)
    Path(out_path).write_text(json.dumps({"examples": record["examples"],
                                          "launches": launches}, default=str))


def run_subphase(flag: str, key: str, label: str, record: dict) -> dict:
    """Phase ``label`` in a fresh process (``chip_smoke.py FLAG OUT``)
    after this one's cached blocks are freed; its launches (all 0), with
    its record under ``record[key]``."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free_b, total_b = torch.cuda.mem_get_info()
    print(f"phase {label}: this process still holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; {free_b / 1e9:.2f} of "
          f"{total_b / 1e9:.2f} GB free for phase {label}'s process", flush=True)
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "phase.json"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag,
                               str(out)], timeout=900)
        if proc.returncode != 0:
            fail(f"phase {label}'s process exited with {proc.returncode}")
        got = json.loads(out.read_text())
    record[key] = got[key]
    return got["launches"]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")

    import numpy as np
    import scipy.sparse as sp

    from scipy.sparse.linalg import eigsh

    from repro_torch.core.formats import CSRMatrix, bcsr_from_csr, sell_from_csr
    from repro_torch.core.spmv import csr_prepare, spd_shift, spmm_csr, spmv_csr
    from repro_torch.data.suite import generate
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain
    from repro_torch.kernels.sell_spmv import (
        sell_spmv,
        sell_spmv_blocked,
        sell_spmv_blocked_plain,
        sell_spmv_plain,
    )
    from repro_torch.kernels import spmspv as kspmspv
    from repro_torch.kernels.spmspv import (
        SCATTER_LAUNCHES,
        SCATTER_PASSES,
        expand_products,
        pad_sparse_rhs,
        spmspv_prepare,
        spmspv_scatter,
        spmspv_scatter_plain,
        stage_sparse,
        validate_sparse_rhs,
        work_bucket,
    )
    from repro_torch.core.metrics import matrix_bandwidth, ucld
    from repro_torch.core.reorder import random_order
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime.engine import CAPTURE_MAX_OUTPUT_BYTES, SparseEngine
    from repro_torch.runtime.executable import fused_batch_executable, pool_bytes
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.overload import (
        BROWNOUT,
        SHED,
        BrownoutController,
        OverloadError,
    )
    from repro_torch.runtime.solver import (
        SparseSolver,
        block_power_host_loop,
        cg_host_loop,
    )
    from repro_torch.runtime.supervisor import Supervisor
    from repro_torch.tune import (
        BCSR_BLOCKS,
        InaccurateTier,
        NoSpMMTier,
        PlanCache,
        SparseOperator,
        make,
    )
    from repro_torch.tune.operator import runner

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions stay float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record: dict = {"phases_s": {}}
    t_start = time.perf_counter()

    def phase_done(name: str, t0: float) -> None:
        record["phases_s"][name] = round(time.perf_counter() - t0, 3)
        print(f"[{name}] done in {record['phases_s'][name]:.1f}s", flush=True)

    lap_t = [time.perf_counter()]

    def lap(name: str) -> None:
        """Seconds since the previous lap, printed and kept in the record."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        record.setdefault("laps_s", {})[name] = round(now - lap_t[0], 3)
        print(f"  [{name}: {now - lap_t[0]:.2f}s]", flush=True)
        lap_t[0] = now

    # -- phase 1: card and build ------------------------------------------
    t0 = time.perf_counter()
    smi = smi_line()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda} "
          f"numpy {np.__version__}", flush=True)
    targets = _build.ensure_built()
    for name, path in targets.items():
        ptxas = [ln for ln in _build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {path.name}: " + ("; ".join(ptxas) or "(cached)"))
    record["build"] = {n: _build.BUILD_LOG.get(n, "") for n in targets}
    phase_done("build", t0)

    # -- phase 16: the sharded train step, in a fresh process; no kernel on
    # its path.  It runs first, while this process holds no tensor: its
    # full-depth step needs ≈ 65 GB, which the ≈ 14 GB that phases 1-14
    # leave allocated (ROADMAP C.31) would not leave free.
    t0 = time.perf_counter()
    launches16 = run_subphase("--mesh-train-phase", "mesh_train", "16", record)
    record["mesh_train_launches"] = launches16
    phase_done("mesh_train", t0)

    # -- phase 18: the public surface and the examples' twins, in a fresh
    # process; launches counted over the twins' runs and 18f's serving runs.
    # It runs second, while this process still holds no tensor: llama3-405b
    # at its served depth with one float32 block streamed beside it peaks
    # near 61 GB, which phases 1-14's ≈ 14 GB and their graph pools would
    # not leave free.  Its rows join the table at the end.
    t0 = time.perf_counter()
    launches18 = run_subphase("--examples-phase", "examples", "18", record)
    rows18 = record["examples"].pop("rows")
    phase_done("examples", t0)

    # -- shared inputs ----------------------------------------------------
    t0 = time.perf_counter()
    mats = {name: generate(name, scale=1.0) for name in ("cant", "ldoor")}
    A64 = {
        name: sp.csr_matrix(
            (a.data.astype(np.float64), a.indices, a.indptr), shape=a.shape
        )
        for name, a in mats.items()
    }
    xs_host = {
        name: np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
        for name, a in mats.items()
    }
    xs = {name: torch.as_tensor(v, device=dev) for name, v in xs_host.items()}
    abs_csr = {}
    for name, a in mats.items():
        d = csr_prepare(a, dev)
        d["data"] = d["data"].abs()
        abs_csr[name] = d
    for name, a in mats.items():
        print(f"{name}: {a.shape[0]}x{a.shape[1]} nnz={a.nnz}")
    phase_done("inputs", t0)

    def row_scale(name: str, x: torch.Tensor) -> torch.Tensor:
        """(|A| |x|) in float32 on the card."""
        fn = spmv_csr if x.dim() == 1 else spmm_csr
        return fn(abs_csr[name], x.abs(), n_rows=mats[name].shape[0])

    def check(what: str, got, ref, scale) -> float:
        return row_held(None, what, got, ref, scale)

    def oracle(name: str, x_host: np.ndarray):
        A = A64[name]
        x64 = x_host.astype(np.float64)
        return A @ x64, abs(A) @ np.abs(x64)

    def assert_unfaulted(label: str, eng_) -> None:
        """An engine no fault was injected into: no batch failed, nothing
        demoted.  A kernel that fails on the card must fail the run, not
        hide behind the supervisor's fallback."""
        bad = [(e.kind, e.info) for e in eng_.supervisor.events
               if e.kind in ("batch_failed", "demote", "batch_abandoned")]
        st = eng_.stats
        if bad or st.demotions or st.failed_requests or st.retries:
            fail(f"{label}: supervisor events {bad}, demotions {st.demotions}, "
                 f"failed requests {st.failed_requests}, retries {st.retries}")

    # -- phase 2: each kernel against its plain version -------------------
    t0 = time.perf_counter()
    errs: dict[str, float] = {}
    preps: dict[str, dict] = {}
    print("phase 2: kernels against their plain versions", flush=True)

    def repeatable(what: str, fn) -> None:
        """Two launches on the same operands agree bit for bit."""
        if not torch.equal(fn(), fn()):
            fail(f"{what}: two launches differ")

    for name in ("ldoor", "cant"):
        a, x = mats[name], xs[name]
        sell = sell_from_csr(a, C=8, sigma=64, width_align=8)
        for ct in (8, 16):
            p = kops.sell_prepare(sell, ct, device=dev)

            def run_sell(p=p, x=x, a=a, ct=ct):
                return sell_spmv(p["cols"], p["vals"], x, p["row_perm"],
                                 n_rows=a.shape[0], chunk_w=p["chunk_w"],
                                 chunk_tile=ct)

            y = run_sell()
            yp = sell_spmv_plain(p["cols"], p["vals"], x, p["row_perm"], a.shape[0])
            torch.cuda.synchronize()
            errs[f"sell_spmv/{name}/ct{ct}"] = check(
                f"sell_spmv {name} chunk_tile={ct} (W={p['cols'].shape[2]}, "
                f"mean chunk_w {float(p['chunk_w'].float().mean()):.2f})",
                y, yp, row_scale(name, x))
            repeatable(f"sell_spmv {name} chunk_tile={ct}", run_sell)
            if ct == 8:
                preps[f"sell/{name}"] = p
            del p, y, yp
        del sell
        torch.cuda.empty_cache()

    for name in ("cant", "ldoor"):
        a, x = mats[name], xs[name]
        p = kops.sell_prepare_blocked_stacked(a, 2, device=dev)
        x_pad = torch.zeros(2 * p["slab_n"], device=dev)
        x_pad[: a.shape[1]] = x

        def run_blocked(p=p, x_pad=x_pad, a=a):
            return sell_spmv_blocked(p["cols"], p["vals"], x_pad, p["row_perm"],
                                     n_rows=a.shape[0], slab_n=p["slab_n"],
                                     chunk_w=p["chunk_w"])

        y = run_blocked()
        yp = sell_spmv_blocked_plain(p["cols"], p["vals"], x_pad, p["row_perm"],
                                     a.shape[0], p["slab_n"], p["chunk_w"])
        torch.cuda.synchronize()
        errs[f"sell_spmv_blocked/{name}"] = check(
            f"sell_spmv_blocked {name} n_slabs=2", y, yp, row_scale(name, x))
        repeatable(f"sell_spmv_blocked {name}", run_blocked)
        preps[f"blocked/{name}"] = dict(p, x_pad=x_pad)
        del y, yp
    cant = mats["cant"]
    m, n = cant.shape

    def bcsr_case(label: str, p: dict, X, scale) -> dict:
        """The kernel against its plain version (and against itself) on X;
        returns the prepared dict with the blocked X beside it."""
        gm, gn = p["grid_shape"]
        bm, bk = p["block_shape"]
        rows, k = X.shape
        xb = torch.zeros((gn * bk, k), device=dev)
        xb[:rows] = X
        xb = xb.view(gn, bk, k)

        def run():
            return bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"], xb)

        y = run()
        yp = bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"], xb)
        torch.cuda.synchronize()
        m_ = scale.shape[0]
        errs[f"bcsr_spmm/{label}"] = check(
            f"bcsr_spmm {label}", y.reshape(gm * bm, k)[:m_],
            yp.reshape(gm * bm, k)[:m_], scale)
        repeatable(f"bcsr_spmm {label}", run)
        return dict(p, xb=xb)

    def rand_x(rows: int, k: int):
        return torch.as_tensor(
            np.random.default_rng(0).standard_normal((rows, k)).astype(np.float32),
            device=dev)

    for block in BCSR_BLOCKS:
        p = kops.bcsr_prepare(bcsr_from_csr(cant, block), dev)
        # the bucket widths, then widths whose last N tile is masked
        for k in K_BUCKETS + ((3, 17, 100) if block == (8, 8) else ()):
            X = rand_x(n, k)
            label = f"{block[0]}x{block[1]}/k{k}"
            q = bcsr_case(label, p, X, row_scale("cant", X))
            if k in K_BUCKETS:
                preps[f"bcsr/{label}"] = q
            del q
    for block, k in (((12, 8), 3), ((8, 32), 64)):  # the generic path
        X = rand_x(n, k)
        bcsr_case(f"{block[0]}x{block[1]}/k{k}",
                  kops.bcsr_prepare(bcsr_from_csr(cant, block), dev), X,
                  row_scale("cant", X))
    # (128, 128) blocks, as the sparse FFN stores them: a seeded random
    # block matrix of 32 x 32 block positions, a quarter of them stored.
    rng_b = np.random.default_rng(0)
    present = rng_b.random((32, 32)) < 0.25
    dense = np.zeros((4096, 4096), np.float32)
    for bi, bj in zip(*np.nonzero(present)):
        dense[bi * 128:(bi + 1) * 128, bj * 128:(bj + 1) * 128] = (
            rng_b.standard_normal((128, 128)))
    ffn = sp.csr_matrix(dense)
    ffn_csr = CSRMatrix(ffn.shape, ffn.indptr.astype(np.int32),
                        ffn.indices.astype(np.int32), ffn.data)
    mats["ffn128"] = ffn_csr
    A64["ffn128"] = ffn.astype(np.float64)
    d = csr_prepare(ffn_csr, dev)
    d["data"] = d["data"].abs()
    abs_csr["ffn128"] = d
    del dense, ffn
    X = rand_x(4096, 64)
    preps["bcsr/128x128/k64"] = bcsr_case(
        "128x128/k64", kops.bcsr_prepare(bcsr_from_csr(ffn_csr, (128, 128)), dev),
        X, row_scale("ffn128", X))
    csr = csr_prepare(cant, dev)
    X16 = torch.as_tensor(
        np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32),
        device=dev)
    for what, fn, arg in (("spmv", spmv_csr, xs["cant"]), ("spmm k=16", spmm_csr, X16)):
        if not torch.equal(fn(csr, arg, n_rows=m), fn(csr, arg, n_rows=m)):
            fail(f"csr/vector {what} is not bitwise repeatable on the card")
        print(f"  ok csr/vector {what}: bitwise repeatable")
    torch.cuda.empty_cache()
    phase_done("kernels_vs_plain", t0)

    # -- phase 2b: op.aot(), a CUDA graph, against op @ x -----------------
    t0 = time.perf_counter()
    print("phase 2b: op.aot() (a CUDA graph) against op @ x on cant, bit for bit",
          flush=True)
    aot_rec = record["aot"] = {}
    rng_a = np.random.default_rng(2)

    def host_us(fn, x, reps: int = 200) -> float:
        """Host microseconds per call, the device waited for at the end."""
        fn(x)
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        for _ in range(reps):
            fn(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t_) / reps * 1e6

    for label, cand, k in (
            ("sell/cuda k=1", make("sell", "cuda", C=8, sigma=64, chunk_tile=8), None),
            ("sell_blocked/cuda k=1", make("sell_blocked", "cuda", C=8, sigma=64,
                                           n_slabs=2, chunk_tile=8), None),
            ("bcsr/cuda k=64", make("bcsr", "cuda", block=(8, 8)), 64)):
        op = SparseOperator.from_candidate(cant, cand, k=k, device=dev)
        exe = op.aot()
        shape = (n,) if k is None else (n, k)
        x1, x2 = (torch.as_tensor(rng_a.standard_normal(shape).astype(np.float32),
                                  device=dev) for _ in range(2))
        y1 = exe(x1)
        kept = y1.clone()
        y2 = exe(x2)
        torch.cuda.synchronize()
        if exe is op._run or not hasattr(exe, "graph"):
            fail(f"op.aot() of {label} is not a captured executable")
        if not (torch.equal(y1, op @ x1) and torch.equal(y2, op @ x2)):
            fail(f"op.aot() of {label} differs from op @ x")
        if not torch.equal(y1, kept):
            fail(f"op.aot() of {label}: the second call changed the first result")
        us_graph, us_eager = host_us(exe, x1), host_us(op.__matmul__, x1)
        aot_rec[label] = {"host_us_per_call_graph": us_graph,
                          "host_us_per_call_eager": us_eager,
                          "tally": dict(exe.graph.tally)}
        print(f"  ok {label}: op.aot() == op @ x bit for bit on two calls, the first "
              f"result kept; captured launches {dict(exe.graph.tally)}; wall per call "
              f"{us_graph:.1f} us graph (copy in, replay, copy out), {us_eager:.1f} us "
              f"eager [{smi}]")
        del op, exe
    torch.cuda.empty_cache()
    phase_done("aot", t0)

    # -- phase 3 + 4: the main path, launches counted ---------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    print("phase 3: tuned main path", flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    cache = PlanCache(Path(tmp.name) / "plans.json")
    record["searches"] = {}

    def report_search(label: str, op) -> None:
        failures = {key: repr(e) for key, e in op.search_failures.items()}
        record["searches"][label] = {
            "plan": op.plan.candidate.key(),
            "measured_ms": {key: round(v * 1e3, 6) for key, v in op.measurements.items()},
            "search_failures": failures,
        }
        print(f"  {label}: plan {op.plan.candidate.key()} "
              f"({op.plan.measured_s * 1e3:.4f} ms), {len(op.measurements)} timed")
        for key, v in sorted(op.measurements.items(), key=lambda kv: kv[1]):
            print(f"    {key}: {v * 1e3:.4f} ms")
        for key, e in op.search_failures.items():
            print(f"    FAILED {key}: {e!r}")
            # the two failures a search on the card passes over: a k = 1
            # tier asked for k > 1, and a plain tier that failed the
            # accuracy check (a kernel that fails it raises in build)
            if not isinstance(e, (NoSpMMTier, InaccurateTier)):
                fail(f"{label}: candidate {key} failed in the search: {e!r}")

    op1 = SparseOperator.build(cant, cache=cache, device=dev)
    report_search("cant spmv", op1)
    y64, sc = oracle("cant", xs_host["cant"])
    check("tuned cant spmv vs float64 oracle", op1 @ xs["cant"], y64, sc)
    op16 = SparseOperator.build(cant, k=16, cache=cache, device=dev)
    report_search("cant spmm k=16", op16)
    X16h = X16.cpu().numpy()
    check("tuned cant spmm k=16 vs float64 oracle", op16 @ X16,
          A64["cant"] @ X16h.astype(np.float64),
          abs(A64["cant"]) @ np.abs(X16h.astype(np.float64)))
    ldoor = mats["ldoor"]
    opL = SparseOperator.build(
        ldoor, cache=cache, device=dev,
        candidates=[
            make("csr", "vector"),
            make("sell", "cuda", C=8, sigma=64, chunk_tile=8),
            make("sell_blocked", "cuda", C=8, sigma=64, n_slabs=2, chunk_tile=8),
        ],
    )
    report_search("ldoor spmv (cut candidate list)", opL)
    y64, sc = oracle("ldoor", xs_host["ldoor"])
    check("tuned ldoor spmv vs float64 oracle", opL @ xs["ldoor"], y64, sc)
    del opL
    slab_cand = make("sell_blocked", "cuda", C=8, sigma=64, n_slabs=2, chunk_tile=8)
    for name in ("cant", "ldoor"):
        op = SparseOperator.from_candidate(mats[name], slab_cand, device=dev)
        y64, sc = oracle(name, xs_host[name])
        check(f"pinned {slab_cand.key()} on {name} vs float64 oracle",
              op @ xs[name], y64, sc)
        del op
    torch.cuda.empty_cache()
    phase_done("tuned_main_path", t0)

    t0 = time.perf_counter()
    print("phase 4: serving on cant", flush=True)
    rng = np.random.default_rng(0)
    req_host = [rng.standard_normal(n).astype(np.float32) for _ in range(128)]
    req_dev = [torch.as_tensor(v, device=dev) for v in req_host]
    groups = (1, 3, 4, 12, 44)  # -> buckets 1, 4, 4, 16, 64

    def serve(eng, xs_):
        reqs, i = [], 0
        for g in groups:
            reqs += [eng.submit(x) for x in xs_[i : i + g]]
            i += g
            eng.step()
        eng.drain()
        return [r.result() for r in reqs]

    def check_served(label, ys, hosts):
        X = np.stack(hosts, axis=1).astype(np.float64)
        Y = torch.stack(list(ys), dim=1)
        return check(label, Y, A64["cant"] @ X, abs(A64["cant"]) @ np.abs(X))

    eng = SparseEngine(cant, ks=K_BUCKETS, cache=cache, device=dev)
    plans = {k: op.plan.candidate.key() for k, op in eng.ops.items()}
    print(f"  tuned engine plans: {plans}")
    record["engine_plans"] = plans
    for k, op in eng.ops.items():
        report_search(f"tuned engine k={k}", op)
    check_served("tuned engine, 64 requests vs float64 oracle",
                 serve(eng, req_dev[:64]), req_host[:64])
    print(f"  tuned engine stats: {eng.stats.summary()}")
    pinned = {
        k: SparseOperator.from_candidate(
            cant,
            make("sell", "cuda", C=8, sigma=64, chunk_tile=8) if k == 1
            else make("bcsr", "cuda", block=(8, 8)),
            k=None if k == 1 else k, device=dev,
        )
        for k in K_BUCKETS
    }
    eng_async = SparseEngine(cant, ks=K_BUCKETS, ops=pinned, device=dev,
                             async_depth=2)
    ys_async = serve(eng_async, req_dev[64:])
    eng_sync = SparseEngine(cant, ks=K_BUCKETS, ops=pinned, device=dev,
                            async_depth=0)
    ys_sync = serve(eng_sync, req_dev[64:])
    if not all(torch.equal(a_, b_) for a_, b_ in zip(ys_async, ys_sync)):
        fail("pinned engine: async results differ from async_depth=0 results")
    print("  ok pinned engine: async == sync bit for bit (both through CUDA graphs)")
    eng_eager = SparseEngine(cant, ks=K_BUCKETS, ops=pinned, device=dev,
                             captured=False)
    ys_eager = serve(eng_eager, req_dev[64:])
    if not all(torch.equal(a_, b_) for a_, b_ in zip(ys_async, ys_eager)):
        fail("pinned engine: the graphs' results differ from the eager closures'")
    for k in K_BUCKETS:  # each bucket's graph against its eager closure
        g_fn, e_fn = eng_async._execs[k], eng_eager._execs[k]
        if not hasattr(g_fn, "executable") or hasattr(e_fn, "executable"):
            fail(f"bucket {k}: the default engine's closure is not a graph, or the "
                 "captured=False one is")
        if not torch.equal(g_fn(*req_dev[:k]), e_fn(*req_dev[:k])):
            fail(f"bucket {k}: its graph differs from its eager closure")
    print("  ok pinned engine: every bucket's graph equals its eager closure bit for "
          "bit, and the served results equal an eager engine's")
    pools = {}
    for label, eng_ in (("tuned", eng), ("pinned async", eng_async),
                        ("pinned sync", eng_sync)):
        graphs_ = [fn.executable for fn in eng_._execs.values()
                   if hasattr(fn, "executable")]
        if {g.pool for g in graphs_} != {eng_.graph_pool}:
            fail(f"{label} engine: its buckets' graphs do not share the engine's pool")
        pools[label] = {"graphs": len(graphs_), "pool_bytes": pool_bytes([eng_.graph_pool])}
    print(f"  graph pools per engine (allocator bytes): {pools}")
    record["engine_graph_pools"] = pools

    def dispatch_us(captured: bool) -> dict:
        """Median host microseconds of one step() per bucket (a dispatch; the
        batch it retires has finished), the capturing first one left out."""
        e_ = SparseEngine(cant, ks=K_BUCKETS, ops=pinned, device=dev,
                          captured=captured)
        out = {}
        for k in K_BUCKETS:
            ts = []
            for _ in range(33):
                for x in req_dev[:k]:
                    e_.submit(x)
                torch.cuda.synchronize()
                t_ = time.perf_counter()
                e_.step()
                ts.append(time.perf_counter() - t_)
            e_.drain()
            out[k] = float(np.median(ts[1:])) * 1e6
        e_.close()
        assert_unfaulted(f"dispatch timing engine (captured={captured})", e_)
        return out

    turns = [dispatch_us(c) for c in (True, False, True, False)]
    disp = record["dispatch_host_us"] = {
        "graph": {k: min(turns[0][k], turns[2][k]) for k in K_BUCKETS},
        "eager": {k: min(turns[1][k], turns[3][k]) for k in K_BUCKETS},
        "card": smi}
    for k in K_BUCKETS:
        print(f"  host time per dispatch, bucket {k}: graph {disp['graph'][k]:.1f} us, "
              f"eager {disp['eager'][k]:.1f} us (median of 32, best of 2 in turns) "
              f"[{smi}]")
    # The wide bucket, graphed against eager: each result is a copy of the
    # graph's static output, one more write and read of Y per batch.
    print("phase 4 (wide): serve --sparse's loop at k = 64, graphed against "
          "captured=False, in turns", flush=True)
    wide = record["wide_bucket"] = {"card": smi}
    for name, cand in (("cant", make("bcsr", "cuda", block=(8, 8))),
                       ("ldoor", make("csr", "vector"))):
        a_ = mats[name]
        op_ = SparseOperator.from_candidate(a_, cand, k=64, device=dev)
        gen = torch.Generator(device=dev).manual_seed(4)
        xs_ = [torch.randn(a_.shape[1], generator=gen, device=dev)
               for _ in range(WIDE_REQUESTS[name])]
        turns_ = {True: [], False: []}
        outs = {}
        # the engine's own choice: a graph up to CAPTURE_MAX_OUTPUT_BYTES
        engine_graphs = a_.shape[0] * 64 * 4 <= CAPTURE_MAX_OUTPUT_BYTES
        for captured in (True, False) * WIDE_TURNS:
            e_ = SparseEngine(a_, ks=(64,), ops={64: op_}, device=dev)
            if hasattr(e_._exec(64), "executable") != engine_graphs:
                fail(f"wide bucket on {name}: the engine's capture choice is not "
                     f"the output-size rule's ({engine_graphs})")
            if captured != engine_graphs:  # the other side, bound by hand
                e_.hot_swap({64: op_}, execs={64: fused_batch_executable(
                    op_._run, bucket=64, n=a_.shape[1], device=dev,
                    captured=captured)})
            e_.run(xs_[:64])  # the first dispatch (the graph's capture)
            fn = e_._exec(64)
            if hasattr(fn, "executable") != captured:
                fail(f"wide bucket on {name}: captured={captured} closure mismatch")
            # device ms of one batch (stack, run, and the graph's copy out):
            # 20 batches enqueued back to back between two events
            fn(*xs_[:64])
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            for _ in range(20):
                fn(*xs_[:64])
            ev1.record()
            ev1.synchronize()
            reqs_, _, dt_ = serve_cli.offer(e_, xs_)
            outs[captured] = [r.result() for r in reqs_]
            e_.close()
            assert_unfaulted(f"wide bucket engine on {name} (captured={captured})", e_)
            turns_[captured].append({"req_per_s": len(reqs_) / dt_,
                                     "batch_device_ms": ev0.elapsed_time(ev1) / 20})
        if not all(torch.equal(gy, ey) for gy, ey in zip(outs[True], outs[False])):
            fail(f"wide bucket on {name}: graphed results differ from eager ones")
        del outs, xs_, op_
        torch.cuda.empty_cache()
        w = wide[name] = {"plan": cand.key(), "requests": WIDE_REQUESTS[name],
                          "output_bytes": a_.shape[0] * 64 * 4,
                          "engine_captures": engine_graphs,
                          "graph": turns_[True], "eager": turns_[False]}
        print(f"  {name} k=64 {cand.key()} (Y {w['output_bytes'] / 1e6:.1f} MB; the "
              f"engine {'captures' if engine_graphs else 'keeps eager'}): "
              f"req/s graph {[round(t['req_per_s'], 1) for t in w['graph']]}, eager "
              f"{[round(t['req_per_s'], 1) for t in w['eager']]}; device ms per batch "
              f"graph {[round(t['batch_device_ms'], 4) for t in w['graph']]}, eager "
              f"{[round(t['batch_device_ms'], 4) for t in w['eager']]}; results bit for "
              f"bit equal [{smi}]", flush=True)
    check_served("pinned engine, 64 requests vs float64 oracle", ys_async,
                 req_host[64:])
    by_bucket = eng_async.stats.summary()["by_bucket"]
    if sorted(by_bucket) != list(K_BUCKETS):
        fail(f"pinned engine did not serve every bucket: {by_bucket}")
    for label, eng_ in (("tuned engine", eng), ("pinned engine async", eng_async),
                        ("pinned engine sync", eng_sync),
                        ("pinned engine eager", eng_eager)):
        eng_.close()
        assert_unfaulted(label, eng_)
    print("  ok phase 4 engines: zero supervisor events, zero demotions")
    tuned_ops = eng.ops  # phase 7c serves this table again
    # The serve CLI, on the plan table the tuned engine left in the cache.
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tmp.name) / "plans.json")
    serve_stats = Path(tmp.name) / "serve.json"
    serve_cli.main(["--sparse", "cant", "--scale", "1.0", "--requests", "64",
                "--stats-json", str(serve_stats)])
    record["serve_cli"] = json.loads(serve_stats.read_text())
    if record["serve_cli"]["served"] != 64:
        fail(f"serve CLI served {record['serve_cli']['served']}/64 requests")
    plans4 = (Path(tmp.name) / "plans.json").read_text()  # phase 9's plan cache
    cli_sup = record["serve_cli"]["supervisor"]
    if cli_sup["demotions"] or set(cli_sup["events"]) & {"batch_failed", "demote"}:
        fail(f"serve CLI: supervisor {cli_sup}")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches over phases 3-4: {launches}")
    for key in ("sell_spmv", "sell_spmv_blocked", "bcsr_spmm"):
        if launches.get(key, 0) <= 0:
            fail(f"kernel {key} was never launched on the main path")
    record["launches"] = launches
    phase_done("serving", t0)

    # -- phase 5: times ----------------------------------------------------
    t0 = time.perf_counter()
    print("phase 5: times (median of 25, L2 flushed before each)", flush=True)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return float(np.median(ts))

    def csr_lib(name: str):
        a = mats[name]
        return torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr, device=dev),
            torch.as_tensor(a.indices, device=dev),
            torch.as_tensor(a.data, device=dev), size=a.shape,
            check_invariants=False)

    def nbytes(*ts) -> int:
        return int(sum(t.numel() * t.element_size() for t in ts))

    def bound(a, k: int, a_bytes: int) -> tuple[int, int]:
        """Bytes and flops that Y = A X needs: A read once, as CSR (a value
        and a column index per nonzero, m + 1 row pointers) or as the
        kernel's format reads it (``a_bytes``), whichever is smaller; X
        read once, Y written once; 2 flops per nonzero and column of X."""
        m_, n_ = a.shape
        a_min = min(8 * a.nnz + 4 * (m_ + 1), a_bytes)
        return a_min + 4 * (n_ + m_) * k, 2 * a.nnz * k

    kernels = []

    def entry(name, source, replaces, launch_key, err_key, shape, kernel, plain,
              library, a, k, a_bytes, stored_bytes, **extra):
        fn_bytes, flops = bound(a, k, a_bytes)
        bytes_s = fn_bytes / HBM_BYTES_PER_S
        flops_s = flops / FP32_FLOPS
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "shape": shape,
            "launches": int(launches.get(launch_key, 0)),
            "max_abs_err": errs[err_key],
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain),
            "bound_ms": max(bytes_s, flops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= flops_s else "operations",
            "bytes": int(fn_bytes),
            "flops": int(flops),
            "stored_bytes": int(stored_bytes),
            "library_ms": time_ms(library),
            **extra,
        }
        kernels.append(row)
        more = "".join(f", {key} {v:.4f}" if isinstance(v, float) else
                       f", {key} {v}" for key, v in extra.items())
        print(f"  {name} [{shape}]: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
              f"cuSPARSE {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}, {row['bytes'] / 1e6:.1f} MB needed, "
              f"{row['stored_bytes'] / 1e6:.1f} MB stored){more}, "
              f"launches {row['launches']}", flush=True)

    for name in ("cant", "ldoor"):
        p, x, a = preps[f"sell/{name}"], xs[name], mats[name]
        A = csr_lib(name)
        # slot-major, one slot of a chunk is one 32-byte sector of cols and
        # one of vals: 64 bytes per slot below each chunk's width
        read_a = 64 * int(p["chunk_w"].sum()) + nbytes(p["chunk_w"], p["row_perm"])
        entry("sell_spmv", "src/repro_torch/kernels/csrc/sell_spmv.cu",
              "src/repro/kernels/sell_spmv.py:53", "sell_spmv",
              f"sell_spmv/{name}/ct8",
              f"{name} SELL-8-64 W={p['cols'].shape[2]} chunk_tile=8",
              lambda: sell_spmv(p["cols"], p["vals"], x, p["row_perm"],
                                n_rows=a.shape[0], chunk_w=p["chunk_w"],
                                chunk_tile=8),
              lambda: sell_spmv_plain(p["cols"], p["vals"], x, p["row_perm"],
                                      a.shape[0]),
              lambda: torch.mv(A, x), a, 1, read_a,
              nbytes(p["cols"], p["vals"], p["chunk_w"], p["row_perm"], x)
              + 4 * a.shape[0],
              read_bytes=int(read_a + nbytes(x) + 4 * a.shape[0]))
        del A
    for name in ("cant", "ldoor"):
        p, a = preps[f"blocked/{name}"], mats[name]
        A = csr_lib(name)
        x = xs[name]
        # what chunk_w leaves to read of A: 8 rows x (4-byte column + 4-byte
        # value) per slot, chunk_w and row_perm; then x once, y once
        read_a = 64 * int(p["chunk_w"].sum()) + nbytes(p["chunk_w"], p["row_perm"])
        read_bytes = read_a + nbytes(p["x_pad"]) + 4 * a.shape[0]
        entry("sell_spmv_blocked", "src/repro_torch/kernels/csrc/sell_spmv_blocked.cu",
              "src/repro/kernels/sell_spmv.py:98", "sell_spmv_blocked",
              f"sell_spmv_blocked/{name}",
              f"{name} 2 slabs W={p['cols'].shape[3]}",
              lambda: sell_spmv_blocked(p["cols"], p["vals"], p["x_pad"],
                                        p["row_perm"], n_rows=a.shape[0],
                                        slab_n=p["slab_n"], chunk_w=p["chunk_w"]),
              lambda: sell_spmv_blocked_plain(p["cols"], p["vals"], p["x_pad"],
                                              p["row_perm"], a.shape[0],
                                              p["slab_n"], p["chunk_w"]),
              lambda: torch.mv(A, x), a, 1, read_a,
              nbytes(p["cols"], p["vals"], p["chunk_w"], p["row_perm"], p["x_pad"])
              + 4 * a.shape[0],
              read_bytes=int(read_bytes))
        del A
    for name, block, ks in [("cant", b, K_BUCKETS) for b in BCSR_BLOCKS] + [
            ("ffn128", (128, 128), (64,))]:
        A = csr_lib(name)
        a = mats[name]
        for k in ks:
            label = f"{block[0]}x{block[1]}/k{k}"
            p = preps[f"bcsr/{label}"]
            Xk = p["xb"].reshape(-1, k)[: a.shape[1]].contiguous()
            stored = (nbytes(p["blocks"], p["block_cols"], p["indptr"], p["xb"])
                      + 4 * p["grid_shape"][0] * p["block_shape"][0] * k)
            stored_flops = 2 * p["blocks"].numel() * k
            floor = max(stored / HBM_BYTES_PER_S, stored_flops / FP32_FLOPS) * 1e3
            entry("bcsr_spmm", "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
                  "src/repro/kernels/bcsr_spmm.py:56", "bcsr_spmm",
                  f"bcsr_spmm/{label}", f"{name} {block[0]}x{block[1]} blocks k={k}",
                  lambda: bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"],
                                    p["xb"]),
                  lambda: bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"],
                                          p["xb"]),
                  (lambda: torch.mv(A, Xk[:, 0])) if k == 1 else (lambda: A @ Xk),
                  a, k, nbytes(p["blocks"], p["block_cols"], p["indptr"]), stored,
                  stored_flops=int(stored_flops),
                  format_floor_ms=floor)
        del A
    del preps
    torch.cuda.empty_cache()
    phase_done("times", t0)

    # -- phase 6: sparse right-hand sides (SpMSpV) --------------------------
    t0 = time.perf_counter()
    print("phase 6: sparse right-hand sides on webbase-1M and torso1", flush=True)
    graphs = {name: generate(name, scale=1.0) for name in ("webbase-1M", "torso1")}
    G64, G_abs, G_pat = {}, {}, {}
    for name, g in graphs.items():
        G64[name] = sp.csr_matrix((g.data.astype(np.float64), g.indices, g.indptr),
                                  shape=g.shape)
        G_abs[name] = abs(G64[name])
        G_pat[name] = sp.csr_matrix((np.ones(g.nnz), g.indices, g.indptr),
                                    shape=g.shape)
        print(f"{name}: {g.shape[0]}x{g.shape[1]} nnz={g.nnz}, longest row "
              f"{int(np.diff(g.indptr).max())}, longest column "
              f"{int(np.bincount(g.indices).max())}")
    web = graphs["webbase-1M"]
    m_w, n_w = web.shape
    buckets = (n_w // 256, n_w // 64, n_w // 16, n_w // 4)  # the engine's
    sp_limits = record["spmspv_limits"] = {}

    def sparse_x(n_: int, nx: int, seed: int = 0):
        rng_ = np.random.default_rng(seed)
        idx = np.sort(rng_.choice(n_, size=nx, replace=False)).astype(np.int64)
        return idx, rng_.standard_normal(nx).astype(np.float32)

    def sparse_oracle(name: str, idx, val):
        """(y64, (|A| |x|), k_i = the touched terms of each row)."""
        x64 = np.zeros(graphs[name].shape[1])
        x64[idx] = val
        mask = np.zeros_like(x64)
        mask[idx] = 1.0
        return G64[name] @ x64, G_abs[name] @ np.abs(x64), G_pat[name] @ mask

    def check_sparse(what: str, got, ref, scale, terms, quiet=False,
                     fallback=True) -> float:
        """Per row |got - ref| <= 1e-5 * scale_i; a row that breaks it is
        printed with its term count k_i and, with ``fallback``, held to
        k_i * 2**-24 * scale_i (else it fails)."""
        got = torch.as_tensor(got, device=dev).double()
        ref = torch.as_tensor(ref, device=dev).double()
        scale = torch.as_tensor(scale, device=dev).double()
        terms = torch.as_tensor(terms, device=dev).double()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or "
                 "non-finite output")
        err = (got - ref).abs()
        lim = TOL * scale
        used = "1e-5"
        if bool((err > lim).any()):
            i = int(torch.argmax(err - lim))
            print(f"  {what}: {int((err > lim).sum())} rows break 1e-5, worst row "
                  f"{i}: err {float(err[i]):.3e}, (|A||x|)_i {float(scale[i]):.3e}, "
                  f"k_i = {int(terms[i])} terms; limit becomes k_i * 2^-24")
            if not fallback:
                fail(f"{what}: row {i} breaks 1e-5 (|A| |x|)_i")
            lim = torch.clamp(terms * 2.0**-24, min=TOL) * scale
            used = "k_i*2^-24"
            if bool((err > lim).any()):
                j = int(torch.argmax(err - lim))
                fail(f"{what}: row {j} err {float(err[j]):.3e} > k_i * 2^-24 * "
                     f"{float(scale[j]):.3e} with k_i = {int(terms[j])}")
        sp_limits[what] = used
        worst = float(err.max()) if err.numel() else 0.0
        if not quiet:
            print(f"  ok {what}: max_abs_err {worst:.3e} (limit {used})")
        return worst

    # 6a: the kernel against its plain version on a CPU copy, bit for bit
    def differing_bits(got, want) -> int:
        return int((got.cpu().view(torch.int32) != want.cpu().view(torch.int32)).sum())

    def check_kernel(what: str, prep, prep_cpu, xi, xv, y64, scale, m_: int):
        """The kernel on staged operands, twice, against the plain version on
        a CPU copy and the plain version on the card (the deterministic
        ``spmspv/ref``), bit for bit, and float64 at 1e-5 with no fallback.
        Returns (staged op, y, max |y - plain|, k_i)."""
        op = stage_sparse(prep, xi, xv)
        y = spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], op["plan"])
        y2 = spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], op["plan"])
        y_ref = spmspv_scatter_plain(prep, op["xi"], op["xv"])
        torch.cuda.synchronize()
        yp = spmspv_scatter_plain(prep_cpu, op["xi"].cpu(), op["xv"].cpu())
        T = int(prep_cpu["col_len"][op["xi"].cpu().long()].sum())
        rows, _ = expand_products(prep_cpu, op["xi"].cpu(), op["xv"].cpu(),
                                  work_bucket(T, prep_cpu["nnz"]))
        terms = torch.bincount(rows[:T].long(), minlength=m_)
        plan = op["plan"]
        cs = kspmspv.chunk_shift(T, plan.chunk_shift)
        what = (f"{what} (T={T} of t_max {plan.t_max}, {-(-T >> cs)} chunks of {1 << cs}, "
                f"{plan.n_tiles} row tiles of {1 << plan.shift}, max k_i {int(terms.max())})")
        if tuple(y.shape) != (m_,) or not bool(torch.isfinite(y).all()):
            fail(f"{what}: shape {tuple(y.shape)} or non-finite output")
        n_diff, n_rerun, n_ref = (differing_bits(y, yp), differing_bits(y2, y),
                                  differing_bits(y_ref, yp))
        if n_diff or n_rerun or n_ref:
            fail(f"{what}: {n_diff} rows differ in their bits from the plain version on "
                 f"the CPU, {n_rerun} from the first launch, and the plain version on "
                 f"the card in {n_ref}")
        f64 = check_sparse(f"{what} vs float64", y, y64, scale, terms, quiet=True,
                           fallback=False)
        print(f"  ok {what}: bit for bit with the plain version on the CPU, on a second "
              f"launch and with the plain version on the card; vs float64 max_abs_err "
              f"{f64:.3e}, every row within 1e-5 (|A| |x|)_i")
        return op, y, float((y.cpu() - yp).abs().max()), terms

    sp_preps, sp_cases = {}, []
    for name, g in graphs.items():
        m_, n_ = g.shape
        prep = spmspv_prepare(g, device=dev)
        prep_cpu = spmspv_prepare(g, device="cpu")
        for B in buckets if name == "webbase-1M" else (n_ // 256, n_ // 4):
            idx, val = sparse_x(n_, B)
            xi, xv = pad_sparse_rhs(idx, val, B, n_)
            y64, scale, _ = sparse_oracle(name, idx, val)
            op, y, err, _ = check_kernel(f"spmspv_scatter {name} x_nnz={B}", prep, prep_cpu,
                                         xi, xv, y64, scale, m_)
            errs[f"spmspv_scatter/{name}/B{B}"] = err
            sp_cases.append((name, B, idx, val))
            del op, y
        sp_preps[name] = prep
        del prep, prep_cpu
    # the constructed tile of hub rows (hub_tile_operand)
    hub_g, H, idx_h, val_h, hub_rows = hub_tile_operand()
    m_h, n_h = hub_g.shape
    x_h = np.zeros(n_h)
    x_h[idx_h] = val_h
    H64 = H.astype(np.float64)
    prep_h = spmspv_prepare(hub_g, device=dev)
    op_h, y_h, _, terms_h = check_kernel(
        f"spmspv_scatter hub tile x_nnz={idx_h.size}", prep_h,
        spmspv_prepare(hub_g, device="cpu"), *pad_sparse_rhs(idx_h, val_h, idx_h.size, n_h),
        H64 @ x_h, abs(H64) @ np.abs(x_h), m_h)
    if len({int(r) >> op_h["plan"].shift for r in hub_rows}) != 1:
        fail("the hub tile's 16 hub rows do not share one row tile")
    record["spmspv_hub_tile"] = {
        "shape": f"{m_h}x{n_h}, 16 hub rows of 20000 products in one tile of "
                 f"{1 << op_h['plan'].shift} rows, x_nnz={idx_h.size}",
        "max_k_i": int(terms_h.max()),
        "ms": time_ms(lambda: spmspv_scatter(prep_h, op_h["xi"], op_h["xv"], op_h["flags"],
                                             op_h["plan"]))}
    print(f"  spmspv_scatter hub tile: {record['spmspv_hub_tile']}", flush=True)
    del H, H64, hub_g, prep_h, op_h, y_h, terms_h
    torch.cuda.empty_cache()
    phase_done("spmspv_kernel_vs_plain", t0)

    # 6b: the sparse-RHS main path on webbase-1M, launches counted
    _build.reset_launches()
    t0 = time.perf_counter()
    print("phase 6b: sparse-RHS main path on webbase-1M", flush=True)
    sp_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sp_")
    sp_cache = PlanCache(Path(sp_tmp.name) / "plans.json")
    pinned_sp = make("spmspv", "cuda", slab=4096)
    lap_t[0] = time.perf_counter()
    for B in buckets:
        op = SparseOperator.build(web, x_nnz=B, cache=sp_cache, device=dev)
        lap(f"build x_nnz={B}")
        report_search(f"webbase-1M spmspv x_nnz={B}", op)
        idx, val = sparse_x(n_w, B, seed=1)
        y64, scale, terms = sparse_oracle("webbase-1M", idx, val)
        y = op.apply_sparse(idx, val)
        check_sparse(f"tuned x_nnz={B} apply_sparse vs float64 oracle", y, y64,
                     scale, terms)
        check_sparse(f"tuned x_nnz={B} op @ (idx, val) vs apply_sparse",
                     op @ (idx, val), y, scale, terms)
        pin = SparseOperator.from_candidate(web, pinned_sp, x_nnz=B, device=dev)
        check_sparse(f"pinned {pinned_sp.key()} x_nnz={B} vs float64 oracle",
                     pin.apply_sparse(idx, val), y64, scale, terms)
        del op, pin
        lap(f"checks x_nnz={B}")
    # 64 requests spread over the four buckets, then one thicker than n/4
    rng = np.random.default_rng(2)
    lows = (0,) + buckets[:-1]
    sizes = [int(rng.integers(lo + 1, hi + 1)) for lo, hi in zip(lows, buckets)
             for _ in range(16)]
    rng.shuffle(sizes)
    sizes.append(buckets[-1] + 1000)
    sp_reqs = [sparse_x(n_w, s_, seed=100 + j) for j, s_ in enumerate(sizes)]
    sp_oracles = [sparse_oracle("webbase-1M", i_, v_) for i_, v_ in sp_reqs]
    lap("65 requests and their oracles")

    def check_answers(label: str, ys) -> float:
        worst = max(check_sparse(f"{label} request {j}", y_, o[0], o[1], o[2],
                                 quiet=True)
                    for j, (y_, o) in enumerate(zip(ys, sp_oracles)))
        print(f"  ok {label}: {len(ys)} answers vs float64 oracle, max_abs_err "
              f"{worst:.3e}")
        return worst

    eng_sp = SparseEngine(web, ks=(1,), cache=sp_cache, device=dev)
    lap("tuned engine built")
    futs = []
    for i_, v_ in sp_reqs:  # one at a time: each latency is one request's
        futs.append(eng_sp.submit_sparse(i_, v_))
        futs[-1].result()
    lap("tuned engine served")
    check_answers("tuned engine", [f.result() for f in futs])
    lap("tuned engine checked")
    summary = eng_sp.stats.summary()
    lat_by_bucket = {}
    for f in futs:
        key = f"spmspv{f.bucket[1]}" if isinstance(f.bucket, tuple) else f"dense k={f.bucket}"
        lat_by_bucket.setdefault(key, []).append(f.latency_s * 1e3)
    lat_by_bucket = {key: round(float(np.median(v)), 4)
                     for key, v in lat_by_bucket.items()}
    sparse_plans = {B: op.plan.candidate.key() for B, op in eng_sp._sparse_ops.items()}
    print(f"  tuned engine sparse plans: {sparse_plans}")
    print(f"  tuned engine stats: {summary}")
    print(f"  tuned engine median latency by lane (ms): {lat_by_bucket}")
    record["spmspv_engine"] = {"plans": sparse_plans, "stats": summary,
                               "median_latency_ms": lat_by_bucket}
    if sorted(summary["sparse_by_bucket"]) != sorted(f"spmspv{B}" for B in buckets):
        fail(f"tuned engine did not serve every x-nnz bucket: "
             f"{summary['sparse_by_bucket']}")
    if summary["by_bucket"] != {1: 1}:
        fail(f"the oversize request did not take the dense k=1 lane: "
             f"{summary['by_bucket']}")
    # The tuned lane async == sync: engines on the tuned plans (from the
    # cache, no search) take all 65 requests at once at async_depth 2, then
    # one at a time at 0; both give the same bits.
    tuned_by_depth = {}
    for depth in (2, 0):
        eng_ = SparseEngine(web, ks=(1,), ops={1: eng_sp.ops[1]}, cache=sp_cache,
                            device=dev, async_depth=depth)
        futs_ = [eng_.submit_sparse(i_, v_) for i_, v_ in sp_reqs]
        eng_.drain()
        tuned_by_depth[depth] = [f.result() for f in futs_]
        eng_.close()
        assert_unfaulted(f"tuned sparse engine async_depth={depth}", eng_)
    for j, (ya, ys_) in enumerate(zip(*tuned_by_depth.values())):
        if differing_bits(ya, ys_):
            fail(f"tuned engine request {j}: async_depth=2 differs from async_depth=0 "
                 f"in {differing_bits(ya, ys_)} rows' bits")
    print(f"  ok tuned engine: async_depth=2 equals async_depth=0 bit for bit on all "
          f"{len(sp_reqs)} requests (plans {sparse_plans})")
    record["spmspv_tuned_async_equals_sync_bits"] = True
    del tuned_by_depth
    lap("tuned engines async and sync checked")
    ys_by_depth = {}
    pin_cache = PlanCache()  # the second engine loads the first one's plans
    # The pinned lane runs the kernel alone: count every eager
    # expansion made while its engines serve (the plain version's).
    expansions = [0]
    expand_eager = kspmspv.expand_products

    def expand_counted(*args, **kwargs):
        expansions[0] += 1
        return expand_eager(*args, **kwargs)

    kspmspv.expand_products = expand_counted
    for depth in (2, 0):
        eng_ = SparseEngine(web, ks=(1,), ops={1: eng_sp.ops[1]}, cache=pin_cache,
                            device=dev, async_depth=depth, candidates=[pinned_sp])
        lap(f"pinned engine async_depth={depth} built")
        futs_ = [eng_.submit_sparse(i_, v_) for i_, v_ in sp_reqs]
        eng_.drain()
        ys_by_depth[depth] = [f.result() for f in futs_]
        lap(f"pinned engine async_depth={depth} served")
        lanes = {op.plan.candidate for op in eng_._sparse_ops.values()}
        if lanes != {pinned_sp}:
            fail(f"pinned engine's sparse lane ran {lanes}")
        check_answers(f"pinned engine async_depth={depth}", ys_by_depth[depth])
        eng_.close()
        assert_unfaulted(f"pinned sparse engine async_depth={depth}", eng_)
    kspmspv.expand_products = expand_eager
    print(f"  pinned engines: {expansions[0]} eager expansions over "
          f"{2 * len(sp_reqs)} requests")
    if expansions[0]:
        fail(f"the pinned spmspv/cuda lane ran {expansions[0]} eager expansions")
    record["spmspv_pinned_eager_expansions"] = expansions[0]
    # every request, the oversize one on the dense k=1 lane included
    for j, (ya, ys_) in enumerate(zip(ys_by_depth[2], ys_by_depth[0])):
        if differing_bits(ya, ys_):
            fail(f"pinned engine request {j}: async_depth=2 differs from "
                 f"async_depth=0 in {differing_bits(ya, ys_)} rows' bits")
    print(f"  ok pinned engine: async_depth=2 equals async_depth=0 bit for bit on "
          f"all {len(sp_reqs)} requests ({len(sp_reqs) - 1} sparse, 1 on the dense "
          f"k=1 lane)")
    record["spmspv_pinned_async_equals_sync_bits"] = True
    lap("pinned engines checked")
    # The device work of one pinned request, as the profiler lists it.
    pin = SparseOperator.from_candidate(web, pinned_sp, x_nnz=buckets[0], device=dev)
    idx, val = sparse_x(n_w, buckets[0], seed=1)
    pin.apply_sparse(idx, val)
    torch.cuda.synchronize()
    before = _build.LAUNCHES["spmspv_scatter"]
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pin.apply_sparse(idx, val)
            torch.cuda.synchronize()
        device_work = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
    except RuntimeError as e:  # a measurement, not the path: record it
        device_work = [f"profiler failed: {e!r}"]
    print(f"  one pinned request, device work by the profiler: {device_work}")
    record["spmspv_one_request_device_work"] = device_work
    if _build.LAUNCHES["spmspv_scatter"] != before + SCATTER_LAUNCHES:
        fail(f"one pinned sparse request did not launch the kernel's "
             f"{SCATTER_LAUNCHES} passes once each")
    kernels_seen = [w for w in device_work if "memcpy" not in w.lower()
                    and "memset" not in w.lower()]
    copies = [w for w in device_work if "memcpy" in w.lower() or "memset" in w.lower()]
    if device_work and not device_work[0].startswith("profiler failed") and (
            len(kernels_seen) != SCATTER_LAUNCHES
            or any(sum(f"spmspv_scatter_{p_}" in w for w in kernels_seen) != 1
                   for p_ in SCATTER_PASSES)
            or len(copies) != 1 or "htod" not in copies[0].lower()):
        fail(f"one pinned sparse request ran other device work than the "
             f"{SCATTER_PASSES} passes once each and one host-to-device copy: "
             f"{device_work}")
    del pin
    lap("one pinned request profiled")
    eng_sp.close()
    assert_unfaulted("tuned sparse engine", eng_sp)
    print("  ok phase 6b engines: zero supervisor events, zero demotions")
    torch.cuda.synchronize()
    sp_launches = dict(_build.LAUNCHES)
    print(f"  launches over phase 6b: {sp_launches}")
    if sp_launches.get("spmspv_scatter", 0) <= 0:
        fail("the kernel spmspv_scatter was never launched on the sparse-RHS "
             "main path")
    record["spmspv_launches"] = sp_launches
    sp_tmp.cleanup()
    torch.cuda.empty_cache()
    phase_done("spmspv_main_path", t0)

    # 6c: times at every bucket checked in 6a
    t0 = time.perf_counter()
    print("phase 6c: spmspv times on webbase-1M and torso1 (median of 25, L2 "
          "flushed)", flush=True)

    def wall_ms(fn) -> float:
        """Host clock around fn() and a synchronise: a whole request."""
        for _ in range(3):
            fn()
        ts = []
        for _ in range(REPS):
            flush.zero_()
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t_) * 1e3)
        return float(np.median(ts))

    for _ in range(2000):  # bring the clocks back up after the profiler's pause
        flush.zero_()
    torch.cuda.synchronize()
    pass_jobs = []  # profiled after every timing, so none follows a pause
    for name in graphs:
        g, prep = graphs[name], sp_preps[name]
        m_, n_ = g.shape
        A_lib = torch.sparse_csr_tensor(
            torch.as_tensor(g.indptr, device=dev), torch.as_tensor(g.indices, device=dev),
            torch.as_tensor(g.data, device=dev), size=g.shape, check_invariants=False)
        for gname, B, idx, val in sp_cases:
            if gname != name:
                continue
            xi, xv = pad_sparse_rhs(idx, val, B, n_)
            op = stage_sparse(prep, xi, xv)
            plan = op["plan"]
            T = int(prep["col_len_np"][xi].sum())
            cs = kspmspv.chunk_shift(T, plan.chunk_shift)
            G = work_bucket(T, g.nnz)
            rows, prods = expand_products(prep, op["xi"], op["xv"], G)
            x_dense = torch.zeros(n_, device=dev)
            x_dense[torch.as_tensor(idx, device=dev)] = torch.as_tensor(val, device=dev)
            pin = SparseOperator.from_candidate(g, pinned_sp, x_nnz=B, device=dev)
            stager = kspmspv.SparseStager(prep, plan)
            fn_bytes, ops_ = 8 * T + 16 * B + 4 * m_, 2 * T
            bytes_s, ops_s = fn_bytes / HBM_BYTES_PER_S, ops_ / FP32_FLOPS

            def run(prep=prep, op=op):
                return spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], op["plan"])

            row = {
                "name": "spmspv_scatter",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/spmspv_scatter.cu",
                "replaces": "src/repro/kernels/spmspv.py:212",
                "shape": f"{name} x_nnz={B} T={T} t_max={plan.t_max} chunks="
                         f"{-(-T >> cs)}x{1 << cs} row_tiles={plan.n_tiles}x"
                         f"{1 << plan.shift}",
                "launches": int(sp_launches.get("spmspv_scatter", 0)),
                "launches_per_request": SCATTER_LAUNCHES,
                "scratch_bytes": 4 * plan.scratch_words,
                "max_abs_err": errs[f"spmspv_scatter/{name}/B{B}"],
                "ms": time_ms(run),
                # the deterministic plain tier: sort by row, one add a rank
                "plain_ms": time_ms(lambda: spmspv_scatter_plain(prep, op["xi"], op["xv"])),
                "bound_ms": max(bytes_s, ops_s) * 1e3,
                "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                "bytes": int(fn_bytes),
                "flops": int(ops_),
                "library_ms": time_ms(lambda: torch.zeros(m_, device=dev).index_add_(
                    0, rows[:T], prods[:T])),
                "x_nnz": B,
                "T": T,
                "G": G,
                "expand_ms": time_ms(lambda: expand_products(prep, op["xi"], op["xv"],
                                                             G)),
                "apply_sparse_ms": wall_ms(lambda: pin.apply_sparse(idx, val)),
                # the whole request's host steps, each on the host clock
                "host_validate_pad_ms": wall_ms(lambda: pad_sparse_rhs(
                    *validate_sparse_rhs(idx, val, n_), B, n_)),
                "host_copy_ms": wall_ms(lambda: stager(xi, xv)),
                "launch_and_run_ms": wall_ms(run),
                "cusparse_dense_mv_ms": time_ms(lambda: torch.mv(A_lib, x_dense)),
            }
            if B == n_ // 4:  # the largest bucket of each matrix, by pass
                pass_jobs.append((row, run))
            kernels.append(row)
            print(f"  spmspv_scatter [{row['shape']}]: {row['ms']:.4f} ms "
                  f"({SCATTER_LAUNCHES} launches {'+'.join(SCATTER_PASSES)}, no zero "
                  f"fill), plain (sort by row, an index_add_ a rank) "
                  f"{row['plain_ms']:.4f}, expand alone "
                  f"{row['expand_ms']:.4f}, index_add_ on the expanded stream "
                  f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                  f"({row['bound_by']}); whole apply_sparse "
                  f"{row['apply_sparse_ms']:.4f} ms (host clock: validate + pad "
                  f"{row['host_validate_pad_ms']:.4f}, copy "
                  f"{row['host_copy_ms']:.4f}, launch + run "
                  f"{row['launch_and_run_ms']:.4f}) vs cuSPARSE mv on the densified "
                  f"x {row['cusparse_dense_mv_ms']:.4f} ms; launches "
                  f"{row['launches']}", flush=True)
            del rows, prods, pin, op, stager
        del A_lib
    del sp_preps
    for row, fn in pass_jobs:
        row["pass_device_ms"] = spmspv_pass_ms(fn, flush)
        print(f"  spmspv_scatter [{row['shape']}]: device ms by pass "
              f"{row['pass_device_ms']}", flush=True)
    del pass_jobs
    phase_done("spmspv_times", t0)

    # -- phase 7: the remaining tiers, reordering, supervision, overload ---
    # 7a: the plain merge and csr/scalar tiers at full size
    t0 = time.perf_counter()
    print("phase 7a: merge and csr/scalar tiers against the float64 oracle", flush=True)
    graphs.clear()
    G_pat.clear()
    G_abs.clear()
    A64["webbase-1M"] = G64.pop("webbase-1M")
    mats["webbase-1M"] = web
    tier_rows = record["tiers"] = []

    def prefix_max(name: str, X64: torch.Tensor) -> torch.Tensor:
        """max |P| per column: the float64 prefix sums of A.data * x[cols]
        in CSR order, as the merge tier accumulates them."""
        a_ = mats[name]
        data = torch.as_tensor(a_.data, device=dev).double()
        cols = torch.as_tensor(a_.indices, device=dev).long()
        out = torch.empty(X64.shape[1], dtype=torch.float64, device=dev)
        for j in range(X64.shape[1]):
            out[j] = (data * X64[cols, j]).cumsum(0).abs().max()
        return out

    def check_tier(what: str, name: str, y, x_host, merge: bool) -> dict:
        """1e-5 (|A| |x|)_i, plus 8 * 2**-24 * max|P| for the merge tier."""
        x64 = x_host.astype(np.float64)
        y64 = torch.as_tensor(A64[name] @ x64, device=dev)
        sc = torch.as_tensor(abs(A64[name]) @ np.abs(x64), device=dev)
        err = (y.double() - y64).abs()
        if not bool(torch.isfinite(y).all()) or err.shape != y64.shape:
            fail(f"{what}: shape {tuple(y.shape)} or non-finite output")
        base = TOL * sc
        over = int((err > base).sum())
        info = {"max_abs_err": float(err.max()), "rows_over_1e-5": over,
                "rows": int(err.shape[0])}
        lim = base
        if merge:
            X64 = torch.as_tensor(x64.reshape(x64.shape[0], -1), device=dev)
            pmax = prefix_max(name, X64).reshape(y64.shape[1:])
            lim = base + MERGE_ULPS * 2.0**-24 * pmax
            info["max_P"] = float(pmax.max())
            info["worst_ulps_of_max_P"] = float((err / (2.0**-24 * pmax)).max())
        if bool((err > lim).any()):
            i = int(torch.argmax((err - lim).flatten()))
            fail(f"{what}: {int((err > lim).sum())} entries over the limit, worst "
                 f"err {float(err.flatten()[i]):.3e} > {float(lim.flatten()[i]):.3e}")
        print(f"  ok {what}: " + ", ".join(
            f"{k_} {v_:.3e}" if isinstance(v_, float) else f"{k_} {v_}"
            for k_, v_ in info.items()))
        return info

    xs_host["webbase-1M"] = np.random.default_rng(0).standard_normal(
        web.shape[1]).astype(np.float32)
    X4 = np.random.default_rng(0).standard_normal((cant.shape[1], 4)).astype(np.float32)
    tier_cases = [(make("merge", "scan", chunk=c), name, 1)
                  for c in (2048, 16384) for name in ("cant", "ldoor", "webbase-1M")]
    tier_cases += [(make("merge", "scan", chunk=c), "cant", 4) for c in (2048, 16384)]
    tier_cases.append((make("csr", "scalar"), "cant", 1))
    for cand, name, k in tier_cases:
        x_host = xs_host[name] if k == 1 else X4
        xt = torch.as_tensor(x_host, device=dev)
        op = SparseOperator.from_candidate(mats[name], cand, k=None if k == 1 else k,
                                           device=dev)
        info = check_tier(f"{cand.key()} {name} k={k}", name, op @ xt, x_host,
                          cand.fmt == "merge")
        row = {"tier": cand.key(), "matrix": name, "k": k,
               "ms": time_ms(lambda: op @ xt), **info}
        tier_rows.append(row)
        del op
    torch.cuda.empty_cache()
    phase_done("tiers", t0)

    # 7b: RCM reordering (the paper's §4.4) on a scrambled cant
    t0 = time.perf_counter()
    print("phase 7b: RCM on a scrambled cant", flush=True)
    scr = cant.permuted(random_order(cant, seed=0))
    A64["cant-scrambled"] = sp.csr_matrix(
        (scr.data.astype(np.float64), scr.indices, scr.indptr), shape=scr.shape)
    mats["cant-scrambled"] = scr
    x_c, xt_c = xs_host["cant"], xs["cant"]
    sell_c = make("sell", "cuda", C=8, sigma=64, chunk_tile=8)
    rcm_c = make("sell", "cuda", C=8, sigma=64, chunk_tile=8, reorder="rcm")
    t_ = time.perf_counter()
    op_rcm = SparseOperator.from_candidate(scr, rcm_c, device=dev)
    t_rcm_s = time.perf_counter() - t_
    op_plain = SparseOperator.from_candidate(scr, sell_c, device=dev)
    reordered = op_rcm._prep["matrix"]
    x_perm = xt_c[op_rcm._prep["perm"]]
    inner = op_rcm._prep["inner"]
    reorder_rec = record["reorder"] = {"host_rcm_and_prepare_s": round(t_rcm_s, 3)}
    for label, a_ in (("cant", cant), ("scrambled", scr), ("scrambled + RCM", reordered)):
        reorder_rec[label] = {"bandwidth": matrix_bandwidth(a_), "ucld": ucld(a_)}
        print(f"  {label}: bandwidth {reorder_rec[label]['bandwidth']}, "
              f"UCLD {reorder_rec[label]['ucld']:.4f}")
    for label, op_ in (("sell/cuda", op_plain), ("sell/cuda + rcm", op_rcm)):
        info = check_tier(f"{label} on scrambled cant", "cant-scrambled", op_ @ xt_c,
                          x_c, False)
        tier_rows.append({"tier": op_.plan.candidate.key(), "matrix": "cant-scrambled",
                          "k": 1, "ms": time_ms(lambda: op_ @ xt_c), **info})
    reorder_rec["sell_kernel_ms"] = {
        "scrambled": time_ms(lambda: kops.sell_spmv(op_plain._prep, xt_c)),
        "scrambled + RCM": time_ms(lambda: kops.sell_spmv(inner, x_perm)),
    }
    print(f"  host RCM + prepare {t_rcm_s:.2f}s; SELL kernel alone "
          f"{reorder_rec['sell_kernel_ms']}")
    t_ = time.perf_counter()
    op_b = SparseOperator.build(scr, include_reorder=True, cache=PlanCache(), device=dev)
    reorder_rec["build_s"] = round(time.perf_counter() - t_, 3)
    report_search("scrambled cant spmv, include_reorder=True", op_b)
    reorder_rec["build_plan"] = op_b.plan.candidate.key()
    check("tuned (include_reorder) scrambled cant spmv vs float64 oracle",
          op_b @ xt_c, *oracle("cant-scrambled", x_c))
    del op_rcm, op_plain, op_b, inner, x_perm
    torch.cuda.empty_cache()
    print("  tiers (median of 25, L2 flushed; a plain tier is not a kernel row):")
    for r_ in tier_rows:
        print(f"    {r_['tier']:<48} {r_['matrix']:<15} k={r_['k']:<2} "
              f"{r_['ms']:.4f} ms  rows over 1e-5: {r_['rows_over_1e-5']}"
              + (f", worst {r_['worst_ulps_of_max_P']:.2f} x 2^-24 max|P|"
                 if "max_P" in r_ else ""))
    phase_done("reorder", t0)

    # 7c: supervised serving on cant: injected faults, demote, repair, promote
    t0 = time.perf_counter()
    print("phase 7c: supervised serving on cant", flush=True)
    faults7 = FaultPlan({"engine.dispatch": {"n": 3, "bucket": "1"},
                         "engine.nan": {"n": 3, "bucket": "64"}})
    sup7 = Supervisor(max_retries=2, repair_interval_s=0.02)
    eng7 = SparseEngine(cant, ks=K_BUCKETS, ops=tuned_ops, device=dev, name="cant-7c",
                        nan_guard=True, faults=faults7, supervisor=sup7)
    kernel_of = {"sell": "sell_spmv", "sell_blocked": "sell_spmv_blocked",
                 "bcsr": "bcsr_spmm"}
    faulted = (1, 64)
    ys7, hosts7 = list(serve(eng7, req_dev[:64])), req_host[:64]
    deadline = time.perf_counter() + 10.0
    while sup7.promotions < len(faulted) and time.perf_counter() < deadline:
        time.sleep(0.01)
    _build.reset_launches()
    for r_ in range(3):  # 192 more after the repair
        ys7 += serve(eng7, req_dev[64 * (r_ % 2):64 * (r_ % 2) + 64])
        hosts7 += req_host[64 * (r_ % 2):64 * (r_ % 2) + 64]
    torch.cuda.synchronize()
    launches7 = dict(_build.LAUNCHES)
    eng7.close()
    check_served(f"supervised engine, {len(ys7)} requests vs float64 oracle", ys7, hosts7)
    events7 = [(e.kind, e.info.get("bucket"), e.info.get("tier")) for e in sup7.events]
    print(f"  events: {events7}")
    print(f"  stats: {eng7.stats.summary()}; fault log: "
          f"{[(e.site, e.ctx.get('bucket'), e.ctx.get('probe', False))
              for e in faults7.log]}")
    print(f"  launches after promotion: {launches7}")
    record["supervised"] = {"events": [list(map(str, e)) for e in events7],
                            "stats": eng7.stats.summary(), "launches": launches7}
    for b in faulted:
        kinds = [k_ for k_, bb, _ in events7 if bb == b]
        first = [kinds.index(k_) if k_ in kinds else -1
                 for k_ in ("batch_failed", "demote", "promote")]
        if -1 in first or first != sorted(first):
            fail(f"bucket {b}: events {kinds} do not run batch_failed -> demote -> promote")
        kernel = kernel_of.get(tuned_ops[b].plan.fmt)
        if tuned_ops[b].plan.impl == "cuda" and launches7.get(kernel, 0) <= 0:
            fail(f"bucket {b}: {kernel} did not launch after promotion")
    if {b for _, b, _ in events7} != set(faulted):
        fail(f"unfaulted buckets recorded events: {events7}")
    now_plans = {k: op.plan.candidate.key() for k, op in eng7.ops.items()}
    if now_plans != plans:
        fail(f"after promotion the plans are {now_plans}, tuned {plans}")
    for key in ("sell_spmv", "bcsr_spmm"):
        if launches7.get(key, 0) <= 0:
            fail(f"{key} did not launch again after promotion")
    st7 = eng7.stats
    if st7.failed_requests or st7.demotions != 2 or st7.promotions != 2:
        fail(f"supervised engine stats {eng7.stats.summary()}")
    # A real failure is never demoted: bucket 64's BCSR blocks start off
    # their 16-byte boundary, so the wrapper refuses the launch; its batch
    # must fail (no retry, no demotion) while bucket 1 keeps serving.
    good = pinned[64]
    prep_bad = dict(good._prep)
    shifted = torch.empty(prep_bad["blocks"].numel() + 1, device=dev)[1:]
    prep_bad["blocks"] = shifted.view(good._prep["blocks"].shape)
    prep_bad["blocks"].copy_(good._prep["blocks"])
    bad = SparseOperator.from_candidate(cant, good.plan.candidate, k=64, device=dev)
    bad._run = runner(cant, good.plan.candidate, prep_bad, k=64)
    sup_r = Supervisor(max_retries=2, repair_interval_s=0.02)
    eng_r = SparseEngine(cant, ks=(1, 64), ops={1: pinned[1], 64: bad}, device=dev,
                         name="cant-refused", supervisor=sup_r)
    reqs_r = [eng_r.submit(x) for x in req_dev[:64]]
    eng_r.drain()
    y_r = eng_r.submit(req_dev[0]).result(timeout=10)
    eng_r.close()
    kinds_r = [e.kind for e in sup_r.events]
    errs_r = {type(r_._exc).__name__ for r_ in reqs_r}
    print(f"  real refused launch on bucket 64: events {kinds_r}, futures failed "
          f"{sum(r_.failed for r_ in reqs_r)}/64 with {errs_r}")
    record["supervised"]["real_failure"] = {"events": kinds_r,
                                            "stats": eng_r.stats.summary()}
    if (kinds_r != ["batch_failed", "batch_abandoned"] or errs_r != {"ValueError"}
            or sup_r.retries or eng_r.stats.demotions or eng_r.ops[64] is not bad):
        fail(f"a real refused launch was retried or demoted: {kinds_r}, "
             f"{eng_r.stats.summary()}")
    check_served("bucket 1 beside the refused bucket vs float64 oracle", [y_r],
                 [req_host[0]])
    # A faulted sparse bucket on webbase-1M, pinned to spmspv/cuda: it
    # demotes to the densified csr/vector fallback, and the repair probe
    # that promotes it back runs a product, so the kernel's passes launch
    # exactly once each between the demotion and the next request.
    B7 = buckets[0]
    cache7 = PlanCache()  # the pinned plan, searched here so the engine loads it
    SparseOperator.build(web, x_nnz=B7, cache=cache7, candidates=[pinned_sp],
                         device=dev)
    sup_s = Supervisor(max_retries=0, repair_interval_s=0.02)
    eng_s7 = SparseEngine(
        web, ks=(1,), device=dev, name="web-7c", x_nnz_buckets=(B7,),
        ops={1: SparseOperator.from_candidate(web, make("csr", "vector"), device=dev)},
        cache=cache7, candidates=[pinned_sp], supervisor=sup_s,
        faults=FaultPlan({"engine.dispatch": {"n": 1, "bucket": f"('spmspv', {B7})"}}))
    idx7, val7 = sparse_x(n_w, B7, seed=7)
    W64 = A64["webbase-1M"]
    x7, mask7 = np.zeros(n_w), np.zeros(n_w)
    x7[idx7], mask7[idx7] = val7, 1.0
    W_pat = W64.copy()
    W_pat.data[:] = 1.0
    o7 = (W64 @ x7, abs(W64) @ np.abs(x7), W_pat @ mask7)
    del W_pat
    _build.reset_launches()
    y7 = eng_s7.submit_sparse(idx7, val7).result(timeout=10)
    deadline = time.perf_counter() + 10.0
    while sup_s.promotions < 1 and time.perf_counter() < deadline:
        time.sleep(0.01)
    torch.cuda.synchronize()
    probe_launches = _build.LAUNCHES["spmspv_scatter"]
    y7b = eng_s7.submit_sparse(idx7, val7).result(timeout=10)
    torch.cuda.synchronize()
    after_launches = _build.LAUNCHES["spmspv_scatter"]
    eng_s7.close()
    kinds_s = [e.kind for e in sup_s.events]
    print(f"  sparse bucket {B7}: events {kinds_s}; spmspv_scatter launches by the "
          f"repair probe {probe_launches}, after the next request {after_launches}")
    record["supervised"]["sparse_probe"] = {"events": kinds_s,
                                            "probe_launches": probe_launches,
                                            "after_next_request": after_launches}
    if kinds_s != ["batch_failed", "demote", "promote"] \
            or probe_launches != SCATTER_LAUNCHES \
            or after_launches != 2 * SCATTER_LAUNCHES:
        fail(f"the sparse bucket's repair probe ran no product: events {kinds_s}, "
             f"launches {probe_launches} then {after_launches}")
    for label, y_ in (("on the fallback", y7), ("after promotion", y7b)):
        check_sparse(f"sparse bucket {B7} {label} vs float64 oracle", y_, *o7)
    phase_done("supervised", t0)

    # 7d: overload on cant: each policy under a slowed dispatch
    t0 = time.perf_counter()
    print("phase 7d: overload on cant (each dispatch slowed by 2 ms; 40 requests "
          "offered per dispatch to a queue of 32, every fourth dispatch after a "
          "6 ms stall)", flush=True)
    _build.reset_launches()
    record["overload"] = {}
    for policy in ("reject", "shed-oldest", "block"):
        ctrl = BrownoutController(min_dwell_s=0.01)
        eng_o = SparseEngine(cant, ks=K_BUCKETS, ops=pinned, device=dev,
                             name=f"cant-{policy}", max_queue=32,
                             overload_policy=policy, block_timeout_s=1.0,
                             shed_after_s=0.004, brownout=ctrl,
                             faults=FaultPlan({"engine.overload": {"delay_s": 0.002}}))
        futs, refused = [], 0
        for i in range(320):
            try:
                futs.append((i, eng_o.submit(req_dev[i % 128])))
            except OverloadError:
                refused += 1
            if i % 40 == 39:
                if (i // 40) % 4 == 3:
                    time.sleep(0.006)  # a stall: the queued requests lapse
                eng_o.step()
        eng_o.drain()
        eng_o.close()
        served, typed = [], {"OverloadError": 0, "DeadlineExceededError": 0}
        for i, f in futs:
            if not f.done:
                fail(f"{policy}: request {i} never resolved")
            if f.failed:
                if not isinstance(f._exc, OverloadError):
                    fail(f"{policy}: request {i} failed with {f._exc!r}")
                typed[type(f._exc).__name__] += 1
            else:
                served.append((i, f))
        if served:
            check_served(f"{policy}: {len(served)} served requests vs float64 oracle",
                         [f.result() for _, f in served],
                         [req_host[i % 128] for i, _ in served])
        assert_unfaulted(f"overload engine {policy}", eng_o)
        s_ = eng_o.stats.summary()
        rec = {"submitted": 320, "admitted": len(futs), "refused_at_submit": refused,
               "served": len(served), "failed_typed": typed, "stats": s_,
               "brownout": ctrl.summary()}
        record["overload"][policy] = rec
        print(f"  {policy}: admitted {len(futs)}, refused {refused}, served "
              f"{len(served)}, failed {typed}; rejected {s_['rejected']} shed_oldest "
              f"{s_['shed_oldest']} shed_deadline {s_['shed_deadline']} by_bucket "
              f"{s_['by_bucket']}; brownout {ctrl.summary()}")
        if ctrl.entries(BROWNOUT) + ctrl.entries(SHED) == 0:
            fail(f"{policy}: the brownout controller never left HEALTHY")
        if s_["by_bucket"].get(K_BUCKETS[-1], 0) <= 0:
            fail(f"{policy}: the widest bucket never served under brownout")
    widest = pinned[K_BUCKETS[-1]].plan.candidate.key()
    launches_o = dict(_build.LAUNCHES)
    print(f"  widest bucket plan {widest}; launches over 7d: {launches_o}")
    if not widest.startswith("bcsr/cuda") or launches_o.get("bcsr_spmm", 0) <= 0:
        fail(f"the widest bucket did not serve through bcsr/cuda: {widest}, {launches_o}")
    phase_done("overload", t0)

    # 7e: the serve CLI with the overload flags, on the phase 4 plan cache
    t0 = time.perf_counter()
    print("phase 7e: serve CLI with --max-queue 64 --overload-policy shed-oldest "
          "--brownout", flush=True)
    serve_stats = Path(tmp.name) / "serve_overload.json"
    serve_cli.main(["--sparse", "cant", "--scale", "1.0", "--requests", "256",
                    "--max-queue", "64", "--overload-policy", "shed-oldest",
                    "--brownout", "--stats-json", str(serve_stats)])
    cli = record["serve_cli_overload"] = json.loads(serve_stats.read_text())
    eng_s = cli["engine"]
    print(f"  counters: {{'served': {cli['served']}, 'refused': {cli['refused']}, "
          f"'shed_oldest': {eng_s['shed_oldest']}, 'shed_deadline': "
          f"{eng_s['shed_deadline']}, 'rejected': {eng_s['rejected']}, 'demotions': "
          f"{eng_s['demotions']}}}; supervisor {cli['supervisor']}; brownout "
          f"{cli['brownout']}")
    if (cli["served"] + cli["refused"] + eng_s["shed_oldest"]
            + eng_s["shed_deadline"]) != 256:
        fail(f"serve CLI: requests unaccounted for: {cli}")
    if cli["served"] <= 0 or eng_s["demotions"] or eng_s["failed_requests"]:
        fail(f"serve CLI: {eng_s}")
    tmp.cleanup()
    phase_done("serve_cli_overload", t0)

    # -- phase 8: the iterative solvers, launches counted -----------------
    t0 = time.perf_counter()
    print("phase 8: CG, Lanczos and block power on spd_shift(cant) and "
          "spd_shift(ldoor)", flush=True)
    spd = {name: spd_shift(mats[name]) for name in ("cant", "ldoor")}
    S64 = {name: sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                               shape=a.shape) for name, a in spd.items()}
    for name, a in spd.items():
        print(f"  spd_shift({name}): {a.shape[0]} rows, {a.nnz} nonzeros")
        mats[f"spd_{name}"] = a  # row_scale() of the kernel checks below
        d = csr_prepare(a, dev)
        d["data"] = d["data"].abs()
        abs_csr[f"spd_{name}"] = d
    lam8 = np.sort(eigsh(S64["cant"], k=8, which="LA", tol=1e-8,
                         return_eigenvectors=False))[::-1]
    lam_max = float(lam8[0])
    b_host = {name: np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32) for name, a in spd.items()}
    sol_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_solver_")
    sol_cache = PlanCache(Path(sol_tmp.name) / "plans.json")
    bcsr88 = make("bcsr", "cuda", block=(8, 8))
    lap_t[0] = time.perf_counter()
    solvers = {
        "cant tuned": SparseSolver(spd["cant"], cache=sol_cache, device=dev),
        "cant bcsr/cuda": SparseSolver(spd["cant"], cache=PlanCache(), device=dev,
                                       candidates=[bcsr88]),
        "ldoor sell/cuda": SparseSolver(
            spd["ldoor"], cache=PlanCache(), device=dev,
            candidates=[make("sell", "cuda", C=8, sigma=64, chunk_tile=8)]),
    }
    sc, sb, sl = solvers.values()
    # the same plans with their blocks enqueued eagerly (captured=False): the
    # graphs' baseline
    eager_solvers = {}
    for label, s_ in solvers.items():
        e_ = eager_solvers[label] = SparseSolver(s_.a, device=dev, captured=False)
        e_._ops = s_._ops  # shared: every width is built below, once
    sc_e, sb_e, sl_e = eager_solvers.values()
    # every plan the solves below run, searched (or pinned) and prepared
    step_ops = {"spd_cant k=1, tuned": (sc.op(1), 1),
                "spd_cant k=8, tuned": (sc.op(8), 8),
                "spd_cant k=8, bcsr/cuda": (sb.op(8), 8),
                "spd_ldoor k=1, sell/cuda": (sl.op(1), 1)}
    lap("solver plans: searches and preparation")
    report_search("spd_cant solver_step k=1", sc.op(1))
    report_search("spd_cant solver_step k=8", sc.op(8))
    for label, want in (("spd_cant k=8, bcsr/cuda", "bcsr/cuda"),
                        ("spd_ldoor k=1, sell/cuda", "sell/cuda")):
        if not step_ops[label][0].plan.candidate.key().startswith(want):
            fail(f"{label}: the pinned plan is {step_ops[label][0].plan.candidate.key()}")
    sol = record["solvers"] = {}

    # Each kernel the solvers run, on the solvers' own prepared operands and
    # at their widths, against its plain version (phase 2's row tolerance);
    # these launches are not counted.
    for label, (op, k) in step_ops.items():
        name = label.split()[0]
        cand, p = op.plan.candidate, op._prep
        X = rand_x(op.shape[1], k)
        if (cand.fmt, cand.impl) == ("bcsr", "cuda"):
            bm, bk = p["block_shape"]
            bcsr_case(f"{label} ({bm}x{bk})", p, X, row_scale(name, X))
        elif (cand.fmt, cand.impl) == ("sell", "cuda"):
            x = X[:, 0]
            y = kops.sell_spmv(p, x)
            yp = sell_spmv_plain(p["cols"], p["vals"], x, p["row_perm"], op.shape[0])
            torch.cuda.synchronize()
            errs[f"sell_spmv/{label}"] = check(f"sell_spmv {label}", y, yp,
                                              row_scale(name, x))
            repeatable(f"sell_spmv {label}", lambda: kops.sell_spmv(p, x))
        else:
            print(f"  {label}: plan {cand.key()} runs no kernel of the port")
    lap("solver kernels against their plain versions")

    def cg_check(label: str, name: str, res) -> None:
        """The float64 relative residual of the returned x, by scipy."""
        x64 = res.x.double().cpu().numpy()
        b64 = b_host[name].astype(np.float64)
        true = float(np.linalg.norm(b64 - S64[name] @ x64) / np.linalg.norm(b64))
        rec = float(res.residual / np.linalg.norm(b64))
        sol[label] = {"plan": res.plan, "iterations": res.iterations,
                      "converged": res.converged, "syncs": res.syncs,
                      "true_rel_residual": true, "recursive_rel_residual": rec}
        print(f"  {label}: plan {res.plan}, {res.iterations} iterations, converged "
              f"{res.converged}, float64 relative residual {true:.3e} (float32 "
              f"recursive {rec:.3e}), {res.syncs} host reads")
        if not res.converged or not true <= 1e-4:
            fail(f"{label}: converged {res.converged}, relative residual {true:.3e}")

    def same_run(label: str, fused, host, atol: float) -> None:
        """Fused and host loop on one plan: one count, one flag, one answer."""
        got = fused.x if fused.x is not None else torch.as_tensor(fused.eigenvalues)
        want = host.x if host.x is not None else torch.as_tensor(host.eigenvalues)
        gap = float((got.cpu() - want.cpu()).abs().max())
        print(f"  {label}: fused {fused.iterations} iterations ({fused.syncs} host "
              f"reads), host loop {host.iterations} ({host.syncs}), flags "
              f"{fused.converged}/{host.converged}, max gap {gap:.3e}")
        sol[f"{label} vs host loop"] = {"iterations": [fused.iterations,
                                                       host.iterations],
                                        "syncs": [fused.syncs, host.syncs],
                                        "max_gap": gap}
        if (fused.iterations, fused.converged) != (host.iterations, host.converged) \
                or not gap <= atol:
            fail(f"{label}: fused and host loop differ")

    def same_as_eager(label: str, graphed, eager) -> None:
        """Graphed and eager blocks on one plan: the same count, flag and
        reads, and the same bits (within 1e-6 if a library reduction
        differs under capture, which is then printed)."""
        pair = ((graphed.x, eager.x) if graphed.x is not None
                else (graphed.eigenvectors, eager.eigenvectors))
        bitwise = torch.equal(*pair) and (
            graphed.x is not None
            or np.array_equal(graphed.eigenvalues, eager.eigenvalues))
        gap = float((pair[0] - pair[1]).abs().max())
        sol[f"{label}, graphed vs eager blocks"] = {
            "iterations": [graphed.iterations, eager.iterations],
            "syncs": [graphed.syncs, eager.syncs], "bitwise": bitwise, "max_gap": gap}
        print(f"  {label}: graphed blocks {graphed.iterations} iterations "
              f"({graphed.syncs} host reads), eager blocks {eager.iterations} "
              f"({eager.syncs}), flags {graphed.converged}/{eager.converged}, "
              + ("bit for bit" if bitwise else f"NOT bit for bit: max gap {gap:.3e}"))
        if ((graphed.iterations, graphed.converged, graphed.syncs)
                != (eager.iterations, eager.converged, eager.syncs)
                or not (bitwise or gap <= 1e-6)):
            fail(f"{label}: graphed and eager blocks differ")

    def block_power64(name: str, v0, iters: int) -> np.ndarray:
        """The same block power iteration in float64 on the card (a library
        product, no plan, no kernel of the port, so no launch counted): the
        Rayleigh quotients after ``iters`` steps from the same start."""
        a = S64[name]
        A = torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr.astype(np.int64)),
            torch.as_tensor(a.indices.astype(np.int64)),
            torch.as_tensor(a.data), size=a.shape, device=dev)
        V = torch.linalg.qr(v0.double()).Q
        theta = torch.zeros(v0.shape[1], dtype=torch.float64, device=dev)
        for _ in range(iters):
            W = A @ V
            theta = (V * W).sum(0)
            V = torch.linalg.qr(W).Q
        return theta.cpu().numpy()

    # the solves, launches counted from here
    torch.cuda.synchronize()
    _build.reset_launches()
    b_c = torch.as_tensor(b_host["cant"], device=dev)
    r_cg = sc.cg(b_c, tol=1e-5, maxiter=500)
    cg_check("cant CG, tuned", "cant", r_cg)
    same_as_eager("cant CG", r_cg, sc_e.cg(b_c, tol=1e-5, maxiter=500))
    same_run("cant CG", r_cg, cg_host_loop(sc.op(1)._run, b_c, tol=1e-5, maxiter=500,
                                           device=dev), 1e-6)
    # A tol the host loop first meets at iteration 5, inside the block of
    # iterations 4-7: the fused loop masks iterations 6 and 7 on the card.
    res45 = [cg_host_loop(sc.op(1)._run, b_c, tol=-1.0, maxiter=i,
                          device=dev).residual for i in (4, 5)]
    tol_mid = float(np.sqrt(res45[0] * res45[1]) / np.linalg.norm(b_host["cant"]))
    r_mid = sc.cg(b_c, tol=tol_mid, maxiter=500)
    same_run(f"cant CG to tol {tol_mid:.3e}, converged inside a block", r_mid,
             cg_host_loop(sc.op(1)._run, b_c, tol=tol_mid, maxiter=500, device=dev),
             1e-6)
    same_as_eager(f"cant CG to tol {tol_mid:.3e}", r_mid,
                  sc_e.cg(b_c, tol=tol_mid, maxiter=500))
    if (r_mid.iterations, r_mid.converged, r_mid.syncs) != (5, True, 3 + 1):
        fail(f"CG to tol {tol_mid:.3e}: {r_mid.iterations} iterations, converged "
             f"{r_mid.converged}, {r_mid.syncs} host reads; want 5, True, 4")
    lap("cant: CG")
    r_lz = sc.lanczos(num_steps=64)
    ritz = float(r_lz.eigenvalues[-1])
    sol["cant Lanczos"] = {"ritz_max": ritz, "eigsh_max": lam_max,
                           "rel_gap": abs(ritz - lam_max) / abs(lam_max),
                           "syncs": r_lz.syncs}
    print(f"  cant Lanczos, 64 steps: largest Ritz value {ritz:.6f}, eigsh {lam_max:.6f}"
          f" (relative gap {sol['cant Lanczos']['rel_gap']:.2e}), {r_lz.syncs} host read")
    if not abs(ritz - lam_max) <= 1e-3 * abs(lam_max):
        fail(f"Lanczos: largest Ritz value {ritz} against eigsh {lam_max}")
    v0 = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (spd["cant"].shape[0], 8)).astype(np.float32), device=dev)
    bp_runs = {}
    for label, s_, e_ in (("cant block power k=8, tuned", sc, sc_e),
                          ("cant block power k=8, bcsr/cuda", sb, sb_e)):
        r_bp = bp_runs[label] = s_.block_power(8, tol=1e-4, maxiter=100, v0=v0)
        same_run(label, r_bp, block_power_host_loop(
            s_.op(8)._run, v0, tol=1e-4, maxiter=100, device=dev), 1e-5)
        same_as_eager(label, r_bp, e_.block_power(8, tol=1e-4, maxiter=100, v0=v0))
    lap("cant: Lanczos and block power")
    for label, r_bp in bp_runs.items():
        # Every theta, index by index, against the float64 run of the same
        # iteration from the same start (within 1e-4 of lambda_1): a wrong
        # column of the product shows here.  Against eigsh's top 8: theta_1
        # within 1e-3, and the Ky Fan bound every orthonormal V obeys (the
        # j largest thetas sum to at most lambda_1 + ... + lambda_j).  The
        # trailing columns need not have converged, so they are printed
        # against eigsh, not held to it.
        theta = np.asarray(r_bp.eigenvalues, np.float64)
        srt = np.sort(theta)[::-1]
        gap_eigsh = np.abs(srt - lam8) / abs(lam_max)
        gap_64 = np.abs(theta - block_power64("cant", v0, r_bp.iterations)) / abs(lam_max)
        ky_fan = np.cumsum(srt) - np.cumsum(lam8) - 1e-5 * abs(lam_max) * np.arange(1, 9)
        sol[label] = {"plan": r_bp.plan, "iterations": r_bp.iterations,
                      "converged": r_bp.converged, "theta": theta.tolist(),
                      "eigsh_top8": lam8.tolist(),
                      "rel_gap_eigsh": gap_eigsh.tolist(),
                      "rel_gap_float64_run": gap_64.tolist(), "syncs": r_bp.syncs}
        print(f"  {label}: plan {r_bp.plan}, {r_bp.iterations} iterations, converged "
              f"{r_bp.converged}, {r_bp.syncs} host reads; theta (sorted) "
              f"{np.round(srt, 4).tolist()}, eigsh top 8 {np.round(lam8, 4).tolist()}; "
              f"gaps to eigsh {np.array2string(gap_eigsh, precision=2)}, largest gap "
              f"to the float64 run {gap_64.max():.2e} (relative to lambda_1)")
        if not (gap_eigsh[0] <= 1e-3 and gap_64.max() <= 1e-4 and (ky_fan <= 0).all()):
            fail(f"{label}: theta {theta.tolist()} against eigsh {lam8.tolist()} "
                 f"(gaps {gap_eigsh.tolist()}) or the float64 run (gaps "
                 f"{gap_64.tolist()})")
    lap("cant: block power against eigsh and the float64 run")
    b_l = torch.as_tensor(b_host["ldoor"], device=dev)
    r_l = sl.cg(b_l, tol=1e-5, maxiter=500)
    lap("ldoor: CG on sell/cuda")
    cg_check("ldoor CG, sell/cuda", "ldoor", r_l)
    same_run("ldoor CG", r_l, cg_host_loop(sl.op(1)._run, b_l, tol=1e-5, maxiter=500,
                                           device=dev), 1e-6)
    same_as_eager("ldoor CG", r_l, sl_e.cg(b_l, tol=1e-5, maxiter=500))
    torch.cuda.synchronize()
    launches8 = dict(_build.LAUNCHES)
    print(f"  launches over the phase 8 solves: {launches8}")
    record["solver_launches"] = launches8
    for key in ("sell_spmv", "bcsr_spmm"):
        if launches8.get(key, 0) <= 0:
            fail(f"kernel {key} was never launched by the solvers")
    for label, s_ in solvers.items():
        ev = [(e.kind, e.info) for e in s_.supervisor.events]
        if ev or s_.supervisor.demotions:
            fail(f"unfaulted solver {label}: supervisor events {ev}")
    print("  ok phase 8 solvers: zero supervisor events, zero demotions")

    graphs8 = {label: s_.n_graphs for label, s_ in solvers.items()}
    print(f"  CUDA graphs captured per solver (one per block size, kind and width): "
          f"{graphs8}")
    sol["graphs"] = graphs8

    # Rate: ms per iteration at a fixed budget (tol < 0, 128 iterations),
    # graphed blocks, eager blocks and the host loop on one plan, best of 5
    # taken in turns; host reads counted by torch's sync debug mode.
    def per_iter_ms(fn) -> float:
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t_) * 1e3 / 128

    def sync_count(fn) -> int:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    rates = record["solver_rates"] = {}
    cases = (
        ("cant CG", lambda: sc.cg(b_c, tol=-1.0, maxiter=128),
         lambda: sc_e.cg(b_c, tol=-1.0, maxiter=128),
         lambda: cg_host_loop(sc.op(1)._run, b_c, tol=-1.0, maxiter=128, device=dev)),
        ("ldoor CG", lambda: sl.cg(b_l, tol=-1.0, maxiter=128),
         lambda: sl_e.cg(b_l, tol=-1.0, maxiter=128),
         lambda: cg_host_loop(sl.op(1)._run, b_l, tol=-1.0, maxiter=128, device=dev)),
        ("cant block power k=8, bcsr/cuda",
         lambda: sb.block_power(8, tol=-1.0, maxiter=128, v0=v0),
         lambda: sb_e.block_power(8, tol=-1.0, maxiter=128, v0=v0),
         lambda: block_power_host_loop(sb.op(8)._run, v0, tol=-1.0, maxiter=128,
                                       device=dev)),
    )
    for label, graph_fn, eager_fn, host_fn in cases:
        graph_fn(), eager_fn(), host_fn()  # warm (the graphs are captured here)
        g_ms, e_ms, h_ms = [], [], []
        for _ in range(5):
            g_ms.append(per_iter_ms(graph_fn))
            e_ms.append(per_iter_ms(eager_fn))
            h_ms.append(per_iter_ms(host_fn))
        rates[label] = {"graph_ms_per_iter": min(g_ms),
                        "eager_blocks_ms_per_iter": min(e_ms),
                        "host_ms_per_iter": min(h_ms),
                        "graph_syncs_counted": sync_count(graph_fn),
                        "eager_blocks_syncs_counted": sync_count(eager_fn),
                        "host_syncs_counted": sync_count(host_fn), "card": smi}
        print(f"  {label}, 128 iterations at tol < 0: graphed blocks {min(g_ms):.4f} "
              f"ms per iteration, eager blocks {min(e_ms):.4f}, host loop "
              f"{min(h_ms):.4f} (best of 5 in turns); synchronising calls counted "
              f"{rates[label]['graph_syncs_counted']} / "
              f"{rates[label]['eager_blocks_syncs_counted']} / "
              f"{rates[label]['host_syncs_counted']} [{smi}]", flush=True)
    def wall(fn) -> float:
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t_) * 1e3

    for label, s_, e_, b_ in (("cant CG", sc, sc_e, b_c), ("ldoor CG", sl, sl_e, b_l)):
        walls = {"graph": [], "eager": [], "host": []}
        for _ in range(5):  # in turns, plans already built
            walls["graph"].append(wall(lambda: s_.cg(b_, tol=1e-5, maxiter=500)))
            walls["eager"].append(wall(lambda: e_.cg(b_, tol=1e-5, maxiter=500)))
            walls["host"].append(wall(lambda: cg_host_loop(
                s_.op(1)._run, b_, tol=1e-5, maxiter=500, device=dev)))
        res_ = s_.cg(b_, tol=1e-5, maxiter=500)
        rates[label].update(solve_wall_ms=min(walls["graph"]),
                            eager_blocks_solve_wall_ms=min(walls["eager"]),
                            host_solve_wall_ms=min(walls["host"]),
                            solve_iterations=res_.iterations, solve_syncs=res_.syncs)
        print(f"  {label} to tol 1e-5 ({res_.iterations} iterations, {res_.syncs} host "
              f"reads): graphed blocks {min(walls['graph']):.3f} ms wall, eager blocks "
              f"{min(walls['eager']):.3f}, host loop {min(walls['host']):.3f} (best of 5 "
              f"in turns)")
    lap("rates")

    # Supervision: an injected solver.dispatch fault retries, then demotes;
    # a plan that fails for real raises from cg() with no retry.
    sup8 = Supervisor(max_retries=2)
    s_f = SparseSolver(spd["cant"], cache=sol_cache, device=dev, name="cant-8",
                       faults=FaultPlan("solver.dispatch:n=3"), supervisor=sup8)
    r_f = s_f.cg(b_c, tol=1e-5, maxiter=500)
    kinds8 = [e.kind for e in sup8.events]
    print(f"  injected solver.dispatch x3: events {kinds8}, plan {r_f.plan}")
    if kinds8 != ["solver_attempt_failed"] * 3 + ["demote", "solver_recovered"] \
            or r_f.plan != "csr/vector":
        fail(f"the faulted solver did not retry then demote: {kinds8}, {r_f.plan}")
    cg_check("cant CG after demotion", "cant", r_f)
    good = SparseOperator.from_candidate(spd["cant"], bcsr88, device=dev)
    prep_bad = dict(good._prep)
    shifted = torch.empty(prep_bad["blocks"].numel() + 1, device=dev)[1:]
    prep_bad["blocks"] = shifted.view(good._prep["blocks"].shape)
    prep_bad["blocks"].copy_(good._prep["blocks"])
    good._run = runner(spd["cant"], bcsr88, prep_bad, k=1)
    sup_bad = Supervisor(max_retries=2)
    s_bad = SparseSolver(spd["cant"], device=dev, supervisor=sup_bad)
    s_bad._ops[1] = good
    try:
        s_bad.cg(b_c, tol=1e-5, maxiter=500)
        fail("a CG whose plan refuses its launch returned")
    except ValueError as e:
        print(f"  a plan that fails for real: cg() raised {type(e).__name__}; events "
              f"{[ev.kind for ev in sup_bad.events]}")
    if [e.kind for e in sup_bad.events] != ["solver_attempt_failed", "solver_failed"] \
            or sup_bad.retries or sup_bad.demotions:
        fail(f"a real failure was retried or demoted: {sup_bad.summary()}")
    sol["supervision"] = {"injected": kinds8,
                          "real": [e.kind for e in sup_bad.events]}
    sol_tmp.cleanup()
    del solvers, step_ops, bp_runs, sc, sb, sl, s_f, s_bad, good, prep_bad, shifted
    del eager_solvers, sc_e, sb_e, sl_e, e_
    torch.cuda.empty_cache()
    phase_done("solvers", t0)
    for row in kernels:
        row["solver_launches"] = int(launches8.get(row["name"], 0))

    # -- phase 9: the fleet, launches counted -----------------------------
    t0 = time.perf_counter()
    launches9 = fleet_phase(dev, 1.0, plans4, record)
    print(f"  launches over phase 9: {launches9}")
    record["fleet_launches"] = launches9
    for key in ("sell_spmv", "bcsr_spmm"):
        if launches9.get(key, 0) <= 0:
            fail(f"kernel {key} was never launched by the fleet")
    for row in kernels:
        row["fleet_launches"] = int(launches9.get(row["name"], 0))
    phase_done("fleet", t0)

    # -- phase 10: row-partitioned and mesh serving, launches counted -----
    t0 = time.perf_counter()
    launches10 = mesh_phase(dev, 1.0, record, tuned=tuned_ops, spd=spd["cant"],
                            ldoor=mats["ldoor"])
    record["mesh_launches"] = launches10
    for row in kernels:  # the shards run plain torch: no kernel is on the path
        row["mesh_launches"] = int(launches10.get(row["name"], 0))
    phase_done("mesh", t0)

    # -- phase 11: LM serving, launches counted over (c) -------------------
    t0 = time.perf_counter()
    launches11, lm_rows = lm_phase(dev, record)
    record["lm_launches"] = launches11
    for row in lm_rows:  # the bf16 path did not exist before this phase
        for key in ("solver_launches", "fleet_launches", "mesh_launches"):
            row[key] = int(record[key].get(row["name"], 0))
    kernels.extend(lm_rows)
    for row in kernels:
        row["lm_launches"] = int(launches11.get(row["name"], 0))
    phase_done("lm", t0)

    # -- phase 12: MoE and RWKV-6 serving, 12c's launches counted ----------
    t0 = time.perf_counter()
    launches12 = moe_ssm_phase(dev, record)
    record["moe_launches"] = launches12
    if launches12.get("spmspv_scatter", 0) <= 0:
        fail("kernel spmspv_scatter was never launched by the MoE combine")
    for row in kernels:
        row["moe_launches"] = int(launches12.get(row["name"], 0))
    phase_done("moe_ssm", t0)

    # -- phase 13: hybrid serving, 13c's launches counted ------------------
    t0 = time.perf_counter()
    launches13, hybrid_rows = hybrid_phase(dev, record)
    record["hybrid_launches"] = launches13
    if launches13.get("bcsr_spmm_bf16_mma", 0) <= 0:
        fail("kernel bcsr_spmm_bf16 was never launched by the hybrid's shared FFN")
    for row in hybrid_rows:  # rows at the shared FFN's shapes, new in this phase
        for key in ("solver_launches", "fleet_launches", "mesh_launches", "lm_launches",
                    "moe_launches"):
            row[key] = int(record[key].get(row["name"], 0))
    kernels.extend(hybrid_rows)
    for row in kernels:
        row["hybrid_launches"] = int(launches13.get(row["name"], 0))
    phase_done("hybrid", t0)

    # -- phase 14: audio and VLM serving, 14e's launches counted -----------
    t0 = time.perf_counter()
    launches14, av_rows = av_phase(dev, record)
    record["av_launches"] = launches14
    if launches14.get("bcsr_spmm_bf16_mma", 0) <= 0:
        fail("kernel bcsr_spmm_bf16 was never launched by the audio and VLM FFNs")
    for row in av_rows:  # rows at whisper's and qwen2-vl's FFN shapes, new here
        for key in ("solver_launches", "fleet_launches", "mesh_launches", "lm_launches",
                    "moe_launches", "hybrid_launches"):
            row[key] = int(record[key].get(row["name"], 0))
    kernels.extend(av_rows)
    for row in kernels:
        row["av_launches"] = int(launches14.get(row["name"], 0))
    phase_done("av", t0)

    # -- phase 15: training, in a fresh process; no kernel on its path -----
    t0 = time.perf_counter()
    launches15 = run_subphase("--train-phase", "train", "15", record)
    record["train_launches"] = launches15
    for row in kernels:
        row["train_launches"] = int(launches15.get(row["name"], 0))
        row["mesh_train_launches"] = int(launches16.get(row["name"], 0))
    phase_done("train", t0)

    # -- phase 17: the dry-run tools against the card, in a fresh process; no
    # kernel on their path
    t0 = time.perf_counter()
    launches17 = run_subphase("--dryrun-phase", "dryrun", "17", record)
    record["dryrun_launches"] = launches17
    for row in kernels:
        row["dryrun_launches"] = int(launches17.get(row["name"], 0))
    phase_done("dryrun", t0)

    # -- phase 18's rows and launches, merged now that every phase has counted
    record["examples_launches"] = launches18
    for row in rows18:  # the twins' shapes and the two models' FFN shapes
        for key in ("solver_launches", "fleet_launches", "mesh_launches", "lm_launches",
                    "moe_launches", "hybrid_launches", "av_launches", "train_launches",
                    "mesh_train_launches", "dryrun_launches"):
            row[key] = int(record.get(key, {}).get(row["name"], 0))
    kernels.extend(rows18)
    for row in kernels:
        row["examples_launches"] = int(launches18.get(row["name"], 0))

    record["kernels"] = kernels
    record["card"] = smi
    record["total_s"] = round(time.perf_counter() - t_start, 3)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1) + "\n")
    print(f"total {record['total_s']:.1f}s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


def spmspv_times_main(out_path: str, src: str) -> None:
    """Kernel 4 alone, in a fresh process, for a tree's ``src`` given on the
    command line: this checkout's, or an unpacked earlier commit's, so two
    versions are timed in turns in one call on one card.  It goes through
    the bound request (``spmspv_bind(prep, B, impl="cuda")``), which every
    version has, at phase 6a's six shapes and its hub tile: per shape the
    device ms by pass and their sum (:func:`spmspv_pass_ms`) and the
    request on the host clock; then the
    measured search of ``SparseOperator.build(x_nnz=n/4)`` on webbase-1M and
    torso1 (its wall seconds and what it measured).  To ``out_path``."""
    sys.path.insert(0, str(Path(src).resolve()))
    import numpy as np
    import torch

    from repro_torch.data.suite import generate
    from repro_torch.kernels import spmspv as ksp
    from repro_torch.tune import PlanCache, SparseOperator

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this timing needs a card")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    out = {"src": str(Path(ksp.__file__).resolve()), "card": smi_line(), "rows": [],
           "searches": {}}

    def one(label, g, idx, val, B):
        m_, n_ = g.shape
        prep = ksp.spmspv_prepare(g, device=dev)
        xi, xv = ksp.pad_sparse_rhs(idx, val, B, n_)
        request = ksp.spmspv_bind(prep, B, impl="cuda")
        for _ in range(3):
            request((xi, xv))
        torch.cuda.synchronize()
        wall = []
        for _ in range(REPS):
            flush.zero_()
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            request((xi, xv))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t_) * 1e3)
        by_pass = spmspv_pass_ms(lambda: request((xi, xv)), flush)
        row = {"shape": label, "device_ms": by_pass.get("total"),
               "request_ms": float(np.median(wall)), "pass_device_ms": by_pass}
        out["rows"].append(row)
        print(f"  {row}", flush=True)

    graphs = {name: generate(name, scale=1.0) for name in ("webbase-1M", "torso1")}
    for name, g in graphs.items():
        n_ = g.shape[1]
        for B in ((n_ // 256, n_ // 64, n_ // 16, n_ // 4) if name == "webbase-1M"
                  else (n_ // 256, n_ // 4)):
            rng = np.random.default_rng(0)  # 6a's x
            idx = np.sort(rng.choice(n_, size=B, replace=False)).astype(np.int64)
            one(f"{name} x_nnz={B}", g, idx, rng.standard_normal(B).astype(np.float32), B)
    hub_g, _, idx_h, val_h, _ = hub_tile_operand()
    one(f"hub tile x_nnz={idx_h.size}", hub_g, idx_h, val_h, idx_h.size)
    for name, g in graphs.items():
        with tempfile.TemporaryDirectory(prefix="spmspv_times_") as tmp:
            t_ = time.perf_counter()
            op = SparseOperator.build(g, x_nnz=g.shape[1] // 4,
                                      cache=PlanCache(Path(tmp) / "plans.json"), device=dev)
            out["searches"][f"{name} x_nnz={g.shape[1] // 4}"] = {
                "build_s": time.perf_counter() - t_, "plan": op.plan.candidate.key(),
                "measured_ms": {k: v * 1e3 for k, v in op.measurements.items()}}
            print(f"  search {name}: {out['searches'][f'{name} x_nnz={g.shape[1] // 4}']}",
                  flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-device-ops"]:
        mesh_device_ops(sys.argv[2])
    elif sys.argv[1:2] == ["--lm-profile"]:
        lm_profile(sys.argv[2:])
    elif sys.argv[1:2] == ["--train-phase"]:
        train_main(sys.argv[2])
    elif sys.argv[1:2] == ["--mesh-train-phase"]:
        mesh_train_main(sys.argv[2])
    elif sys.argv[1:2] == ["--dryrun-phase"]:
        dryrun_main(sys.argv[2])
    elif sys.argv[1:2] == ["--examples-phase"]:
        examples_main(sys.argv[2])
    elif sys.argv[1:2] == ["--spmspv-times"]:
        spmspv_times_main(sys.argv[2], sys.argv[3])
    else:
        main()
