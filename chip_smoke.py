#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports the port only (never JAX nor the reference package) and fails,
printing no result, when CUDA is missing. Phases, each fatal on failure:

1. build:    compile every CUDA source of the port with nvcc (sm_90a), one
             nvcc per source, all started together.
2. kernels:  GQMM at b in {1, 4, 16, 64, 256} and GQMV at b=1, for int8,
             int4, int3 and fp8 weights, at every TinyLlama projection shape,
             against their plain PyTorch versions on the card (int8, int4,
             int3: rtol 1e-5, atol 1e-5 * max|plain|, since the int32 group
             sums are exact and only the f32 order of <= 22 group terms
             differs; fp8: rtol 5e-4, atol 1e-4, the reference's tolerance
             for its fp8 kernel, since the group dots are f32 sums), timed
             with CUDA events over weight copies that exceed the L2, behind
             a GPU spin that keeps the host's launch cost out; beside the int8
             GQMM at b=256, torch._int_mm on the same int8 operands (the
             tensor-core product without group scales, a yardstick the port
             never calls; int_mm_us); beside the int8 GQMV, the first GQMV
             design on the same inputs (the library's streamed width set to 0
             for the call: first_us, the time before the streamed design).
             Then GQMM of every format at b = 8 and 16 with each of its two
             designs (the times that set the cut-over); the int4 and fp8 GQMM
             designs at every projection, every group size 16-256 and b in
             {4, 8, 16, 256}, checked only; the streamed GQMV of every format
             (each GQMV row records its design; all must run the streamed
             one) at every projection and every group size, checked only;
             and each kernel at every group size 16-256 on a small shape at
             b up to 40, the int3 and int4 kernels on a stacked leaf's layer
             slices (rows 2- and 8-byte aligned), and the first GQMV design
             of every format at n 1056 and, for int3 and int4, on storage off
             a 16-byte boundary, checked only.
             Then paged decode attention (bf16, f32, int8 and fp8 pools;
             b in {1, 8, 32}, BS in {8, 16}, MB*BS in {256, 2048}, KV 4, G 8,
             hd 64, softcap None or 50; random non-identity block tables with
             sink entries past each row's position; the split plan of each
             shape shown) against its plain version: within 1e-5 * max|plain|
             at f32 inputs (another f32 summation order); at bf16 inputs
             within 1e-2 * max|plain| of the plain arithmetic run in f32 on
             the same values (the kernel rounds once, to bf16, at the end).
             Timed the same way, over pools larger than the L2, with each
             time's share of its bound; then gemma2's paged shape, G 2 at
             hd 256 over bf16, f32, int8 and fp8 pools, checked and timed the
             same way.
             Then flash attention (B4): causal GQA 32/4 heads, hd 64, at
             4 x 64 and 1 x 2048 tokens, gemma2's 8/4 heads at hd 256 and
             zamba2's 32/32 at hd 112 over 1 x 2048 (timed, beside
             scaled_dot_product_attention on the same inputs, the library
             call for the same function, which the port never calls), window
             + soft cap 50 (at hd 64, 256 and 112), non-causal, hd 32 and
             128, and 4 x 200 tokens;
             bf16 runs the tensor-core kernel, f32 the CUDA-core one, with
             the paged kernel's tolerance rule. Then the fused RMSNorm +
             quantize (B2) at (4, 2048), (256, 2048) and (256, 5632), GS 256
             (timed, beside an empty kernel launched the same way, the
             card's floor for a launch, and beside the first design on the
             same rows one element off 16 bytes, checked too), and at every
             GS 16-256 on (13, 1024), bf16 and f32 input, zero groups
             included: scales within rtol 1e-5, int8 values equal except by
             1 where the plain x/S lies within max(1e-5, 1e-6 * |x/S|) of a
             .5 boundary (RMSQ_TIE).
3. serve:    full-width TinyLlama-1.1B (22 layers, d 2048, bf16, weights
             from the port's own init_lm) through InferenceEngine.generate:
             batch 4, prompt 64, 32 greedy tokens, once with int8 weights and
             once each with int4, int3, fp8, mixed and mixed3. generate
             replays its captured programs (serving/graphs.py: the prefill
             once, the decode step 32 times); its tokens must equal an eager
             prefill + decode_step loop's exactly, and one replayed decode
             step must count one pass's launches. Eager and replayed wall
             times, the replayed programs' device times (CUDA events), the
             captures (count, seconds, graph-pool bytes) and the decode
             step graph's nodes and programmatic edges are printed. The GQMM
             launch count must be 89 per forward pass (4 per layer x 22 +
             classifier): all of the weight format's kernel, or for the
             presets 88 of the packed format's and 1 of int8's (the
             classifier). The same run on the plain versions must give
             first-step logits within 5e-2 * max|logit| (bf16 rounds every
             projection output to 2^-8 and 22 layers compound the kernel's
             other f32 summation order); the greedy-token agreement is shown.
             The 89 projections are timed as one pass at b = 4 and at the
             prefill's b = 256, and at b = 1 (GQMV; with int8 weights also on
             the first GQMV design). Then the matvec path:
             ops.quantized_matmul on 1-D activations (the GQMV kernels) over
             the same 89 projections.
4. golden:   TinyLlama at full width (depth cut to the golden file's), f32,
             weights drawn by bridge.init_params_numpy: the greedy tokens
             must equal the reference package's (written by
             tests/make_torch_golden.py) exactly, for InferenceEngine.generate
             with int8 weights and for serve_ragged(mode="paged") on a float
             KV pool. With int4, int3, fp8, mixed and mixed3 weights the
             free-running agreement is shown beside the CPU's (one int8
             activation rounded across a .5 tie changes a trajectory), and
             the reference's tokens replayed step by step must each be the
             card's greedy choice or within 3e-2 of max|logit| of it. The
             quantized pools' agreement is shown. Then the deep golden: the
             same prompt at TinyLlama's full 22 layers, one weight draw
             shared by an f32 and an int8 engine; f32 tokens must be exact,
             int8 tokens exact or, replayed, lost only at steps traced to a
             .5 activation tie (the CPU's, in the golden file, and the
             card's, DEEP_CARD_TIES), each within 3e-2 of max|logit|.
5. ragged:   the serve CLI's --ragged path at full width: the phase-3 model
             through serve_ragged with 16 requests (prompts 16-192 tokens,
             budgets 8-64, seed 0), 8 slots, chunk 4, block size 8, in paged
             mode with float, int8 and fp8 KV pools, in continuous mode and
             in bucketed mode: each once cold (capturing its programs), then
             replayed (timed), then eagerly (serving/graphs.eager), whose
             tokens and launch counts must equal the replayed pass's.
             Each paged pass must launch the paged-attention op exactly
             22 x its decode steps. A paged pass on the plain versions gives
             the token agreement, one paged decode step of 8 rows the logits
             (within 5e-2 * max|logit|) and its paged-attention kernels (split
             passes and combines) and time, and a pass with half the default
             pool the backpressure path. Last, one paged pass with mixed3
             weights (int3 attention/FFN, int8 classifier), which must launch
             the int3 GQMM and the paged-attention kernel.
6. flags:    the reference's perf-variant flags (core/flags.py) on the
             phase-3 int8 model: (a) generate (batch 4, prompt 64, 32
             tokens) under blockwise_attention, deferred_decode_cache and
             kvt_cache_layout: 22 flash launches per prefill, first-step
             logits within 5e-2 * max|logit| of the plain versions, tokens
             beside phase 3's and equal to an eager decode_step loop's,
             decode timing (replayed and eager) and a profiled step; (b) one
             1 x 2048 prefill under blockwise_attention with prefill_dequant
             around it: 22 flash launches, no GQMM, its device time split
             into flash attention, float products and elementwise work;
             (c) Model.forward on (2, 512) tokens under
             blockwise_attention: 22 flash launches, logits within 5e-2 *
             max|logit| of the plain versions; (d) the standalone
             ops.rmsnorm_quant at the model's 45 norm sites.
             The bf16 model runs the tensor-core flash kernel (counted as
             flash_attn). The golden phase (run last) adds int8 generate
             under the three serving flags on the f32 model (the CUDA-core
             kernel, flash_attn_f32): exact tokens if the port's CPU run was
             exact, else the replay rule above (the CPU run is not exact: the
             flash kernel's f32 order moves one int8 activation of layer 0's
             wo input across a .5 tie, as ROADMAP Queue C records).
7. spec:     speculative decoding (serving/spec.py, k = 4) on the phase-3 int8
             model, run after phase 6. A verify row sums as its decode step
             does (the projections over the chunk's b*k rows, the norms per
             chunk column, each column attending through the decode step's
             own attention), so greedy spec tokens are held to vanilla
             decode's exactly. (a) generate (batch 4, prompt 64, 32 tokens)
             on phase 3's engine (which keeps k slots of cache slack) with
             the n-gram drafter and an oracle drafter that replays the
             vanilla continuation, contiguous and paged: a cold run, a
             replayed run (counts zeroed just before, read just after) and
             an eager run (graphs.eager), whose tokens, spec_stats and
             launches must equal the replayed run's; tokens equal phase 3's
             (contiguous) or a paged vanilla generate's (paged); the oracle
             takes ceil(31/4) = 8 verify steps, every draft accepted; a
             verify step launches 89 GQMMs, all at b*k = 16 rows (rows
             counted on the eager run), and, paged, the paged-attention
             kernel 22 x 4 times. Printed: ms a verify step (wall and CUDA
             events), busy share, tokens a step, ms a generated token beside
             phase 3's vanilla ms/step. (b) serve_ragged on phase 5's trace
             and engine (8 slots), paged and continuous, k 4, n-gram
             drafter: replayed and eager passes equal in tokens and
             launches, tokens equal to phase 5's vanilla pass's, 89 GQMMs
             at 32 rows (the large design) a verify round, one 32-row
             verify step's logits equal to a decode step's bit for bit;
             last_spec_stats, tok/s and ms a round beside phase 5's. The
             golden phase adds (c) top-p generate (p 0.9, seed 0) on the
             2-layer int8 f32 model, on the kernels and on the plain versions
             with the same noise: equal, or each row's first difference a
             near tie of the kernels' perturbed scores; and (d) greedy spec
             generate with the n-gram and the oracle drafter, int8 at 2
             layers and f32 at 22: the golden tokens, the oracle accepted
             throughout in ceil(15/4) = 4 steps (16 golden tokens); spec
             top-p at p = 1e-6 equal to greedy spec.

8. families: the families beside TinyLlama at full width, bf16 and int8
             weights from the port's init_lm (FAMILIES: internlm2-1.8b at 12
             of 24 and gemma2-2b at 13 of 26 (the script's time, once phase
             12 was added), pixtral-12b at 10 of 40, deepseek-coder-33b at 4
             of 62 and dbrx-132b at 2 of 40 (the bf16 draw and its int8 copy
             must fit the card; 2, not 4, for time), deepseek-v2-lite-16b at
             2 of 27 and minicpm3-4b at 8 of 62 (time); each cut printed
             with its reason). First their kernels at each family's shapes: the int8
             GQMM at b in {1, 4, 16, 256} and the int8 GQMV at every
             projection (the MoE experts' and shared expert's, MLA's wq /
             wdq / wuq / wdkv / wukv, each at its own GS: deepseek-v2-lite's
             128), timed, each beside its bound from kernels/bounds.py and
             its plain version's time; at the MoE and MLA families'
             projections (m 288, 1 to 42 groups, odd counts) int4, int3 and
             fp8 too, checked; every format's GQMM (both designs at b 8-17)
             and streamed GQMV at rows of 9 and 75 groups (gemma2's d 2304,
             deepseek's d_ff 19200), checked; flash attention (bf16) at each
             GQA family's heads over 1 x 2048 tokens (dbrx's G 6 included),
             gemma2's over 1 x 4608 with its 4096-token window and cap 50;
             paged attention at each GQA family's (KV, G, hd), bf16 and int8
             pools, gemma2's over 4608-token tables with the window and cap,
             positions past the window; phase 2's tolerances. Then each
             family: generate (batch 4, prompt 64, 32 tokens) replayed
             (counts zeroed just before, read just after) against an eager
             prefill + decode_step loop (tokens and launches equal; the GQMM
             count from the config: a MoE layer 2 per expert and 2 for the
             shared one, an MLA layer 3 or 4 in decode, wukv dequantized, and
             one more in prefill), its decode step wall and on the card,
             kernels a step, the decode graph's nodes, captures (seconds,
             pool bytes), projection bytes a step against the HBM bound,
             first-step logits against the plain versions within 5e-2 *
             max|logit|, or for a MoE family whose router choices flipped
             between the two runs, the flips printed with their margins and
             hold_per_kernel's rule (every kernel held to its plain version
             on the same input, the plain run with the kernels launched
             beside it bit-equal; the one-ulp change printed);
             for internlm2, gemma2 and dbrx the ragged paged serve over the
             first 8 requests of phase 5's trace (replayed == eager, the
             paged kernel once a layer a decode step), dbrx's also in
             continuous (replayed == eager) and bucketed mode and on int8
             and fp8 pools, and speculative generate (k 4, oracle drafter,
             contiguous and paged: vanilla decode's tokens, every draft
             accepted); the MLA families the continuous (replayed == eager)
             and bucketed serve and the reference's refusals (paged
             generate, spec_k, kv_quant, the paged mode and pool);
             gemma2's 1 x 4608 prompt and 16 decode steps (contiguous and
             paged) and the prefill under blockwise_attention, each step's
             logits against the plain versions'; pixtral's prefill of a
             320-token prompt whose first 256 positions are patch
             embeddings, against the plain versions by hold_per_kernel's
             rule, its logits within ULP_FACTOR x the one-ulp change. Last,
             the internlm2, gemma2, minicpm3 and deepseek-v2-lite goldens
             (golden_<arch>.json: 2 layers, f32, f32 and int8 weights), held
             to TinyLlama's 2-layer rule.

9. recurrent: rwkv6-7b and zamba2-7b (Mamba2 SSD + a shared attention
             block) at full width, rwkv6 at every layer and zamba2 at 27 of
             81 (RECURRENT_LAYERS; the cut printed with its reason), bf16,
             int8 weights from the port's init. (a) the int8 GQMM at b in
             {1, 4, 256} and the streamed int8 GQMV at every projection
             shape of both (zamba2's win 14576 x 3584, wout, the shared
             block's wqkv / wo / w13 / w2, the classifiers; rwkv6's six
             4096 x 4096 mixing matrices, wff1, wff2), timed beside their
             bounds and plain versions; int4, int3 and fp8 GQMM at b 4 and
             256, checked; B4 bf16 at the shape zamba2's blockwise prefill
             gives it (4 x 64, 32/32 heads, hd 112), SDPA beside it. (b)
             generate as phase 8's (b 4, prompt 64, 32 tokens; replayed ==
             eager in tokens and launches; 257 and 71 GQMMs a decode step;
             the bytes bound with the recurrent state read and written; the
             first-step logits kernel vs plain within LOGIT_TOL, or, as at
             full depth these random models carry one f32 ulp at layer 0 to
             ~1e-1 of max|logit| and more, hold_per_kernel: every kernel of
             the prefill held to its plain version on the same input, the
             plain prefill with every kernel launched beside it bit-equal,
             and the logits within ULP_FACTOR x the one-ulp change of the
             all-plain prefill). (c) serve_ragged of 8 requests (prompts of
             16, 24 or 32 tokens, budgets 8-32, 4 slots, chunk 4) in
             continuous mode (the RecurrentAdapter) and bucketed mode,
             replayed == eager. (d) zamba2: a prefill under
             blockwise_attention runs the flash kernel 4 times (once per
             shared-block application), logits against plain by (b)'s rule
             (its checked run holds the 4 flash calls too); generate under
             deferred decode, the kvt layout and int8_kv_cache replayed ==
             eager, the shared cache kvt and float. (e) zamba2's 1 x 512
             tokens with the chunked SSD (chunk 128) against the sequential
             scan: layer 0's output and state within RECURRENT_CHUNKED's
             tolerances, the whole prefill's logits printed. (f) the
             reference's refusals (paged, spec_k, kv_quant, lengths=). (g)
             the rwkv6 (2 layers) and zamba2 (7 layers) goldens, held to the
             families' rule, and each int8 golden model's first-step logits
             kernel vs plain within LOGIT_TOL. Budget 150 s; its time is
             printed.

10. encdec:  seamless-m4t-large-v2 (24 encoder + 24 decoder layers, d 1024,
             16/16 heads of 64, vocab 256,206 in 256,224 classifier rows) at
             full width and every layer, bf16, int8 weights from the port's
             init. (a) the int8 GQMM at b 4 and 2048 and the int8 GQMV at
             every projection shape (wqkv, wo / cross wq / cross wo, cross
             wkv, w13, w2, the classifier), timed beside their bounds and
             plain versions; int4, int3 and fp8 GQMM at b 4 and 256,
             checked; B4 bf16 at the encoder's shape (4 x 512, non-causal)
             and the decoder prompt's (4 x 64, causal), SDPA beside it. (b)
             generate: frames (4, 512, 1024) from a seeded torch.Generator,
             a decoder prompt of 4 x 64, 32 greedy tokens, cache_len 96;
             replayed == eager (tokens and launches); 145 GQMMs a decode
             step and 265 a prefill; the static cross cache of 512 rows;
             decode ms wall and on the card, kernels a step, the bytes bound
             (decoder and classifier weights, cross K/V); the prefill's ms;
             first-step logits kernel vs plain within LOGIT_TOL, else
             hold_per_kernel (phase 9's rule). (c) blockwise_attention: 48
             B4 calls a prefill (24 non-causal, 24 causal), each held within
             FLASH_TOL on a checked prefill with its error printed; the
             logits by (b)'s rule; generate replayed == eager. (d) the
             refusals (serve_ragged, paged, spec_k, lengths=, kv_quant, the
             kvt and int8 KV flags). (e) the golden (2 + 2 layers, f32,
             frames N(0, 1) of the prompt's length), held to the families'
             rule, and the int8 golden model's first-step logits kernel vs
             plain within LOGIT_TOL. Budget 120 s; its time is printed.

11. train:   training (train/loop.py, optim/adamw.py, checkpoint/ckpt.py)
             on TinyLlama-1.1B at full width, bf16 params and compute. (a)
             the flash backward (flash_attn_bwd, B4's gradient: bf16 on
             the tensor cores, f32 register-tiled; D, dK/dV, dQ and for GQA
             the group sum, four launches counted as one call; the layout
             of its two products kernels against the Python mirror) against
             its plain version at TinyLlama's 4 x
             128 and 1 x 2048 (32/4 heads of 64), gemma2's hd 256 over 1 x
             4608 with its 4096-token window and cap 50, zamba2's hd 112 and
             seamless's non-causal 4 x 512 (16/16), f32 and bf16: dQ, dK, dV
             within 1e-4 (f32) / 2e-2 (bf16) of max|plain| (the plain
             backward in f32 on the same values), the forward's log-sum-exp
             within 1e-5 / 1e-3 of the plain version's, the forward's output
             with the lse pointer bit-equal to it without, a second call
             bit-equal (no atomics); timed beside the bound (five products
             of 2 hd operations a visible pair, or the bytes), the plain
             version, SDPA's backward and the first design's time ("was",
             a constant). (b) run_loop with the train CLI's defaults
             (SyntheticLM seed 0, batch 8, seq 128, lr 3e-4), 8
             steps at 22 layers: losses finite and falling, ms a step,
             tok/s, peak memory, grad norms. (c) one step at 1 x 2048 under
             blockwise_attention: 44 B4 forwards (remat recomputes each
             layer) and 22 backwards, counted from 0 around it, the
             backward's card time split into its kernels; every
             gradient leaf against the plain path's (impl "plain") within
             5e-2 of its max|plain|, every B4 call held to its plain version
             on the same inputs. (d) at 2 layers of full width (11 GB a
             checkpoint at 22): 8 steps with checkpoints at 4 and 8, the
             latter removed, a resume from 4: the restored params and AdamW
             state bit-equal to those after step 4, the resumed losses equal
             to the straight run's. (e) rwkv6-7b and (f) zamba2-7b at full
             width, bf16, depth cut to what the card holds (10 of 32 and 19
             of 81 layers: 3 groups of 6 and a tail of 1; the cut and the
             memory reckoning printed): 3 steps of run_loop with (b)'s
             settings, checkpoints not written (tens of GB; (d) holds
             them), every loss finite and the first batch's falling, ms a
             step (host clock and CUDA events), tok/s, peak memory, grad
             norms, the bound; (e) also one f32 step at 2 layers, 1 x 16,
             on the card against the CPU (every leaf within 1e-3 of
             max|cpu|); (f) also (c)'s step under blockwise_attention and
             chunked_ssd at 1 x 2048: one B4 forward and backward an
             application of the shared block (3), each held, every leaf
             within 5e-2 of the plain path's. Its time is printed.

12. sanitize: repro-san (analysis/sanitizer.py), run after phase 7 on
             phase 5's int8 engine (bf16 pool) and trace. (a) The trace in
             paged and continuous mode on an engine with sanitize=True (a
             cold pass that captures, then SANITIZE_PAIRS replayed passes
             in turns with the unsanitized engine's): tokens bit-identical
             (and equal to phase 5's), launches equal, B8 once a layer a decode
             step, every round checked, blocks poisoned, poison reach 0,
             finalize clean; median tok/s on and off. (b) B8 at the serve's decode
             shape over a bf16 pool whose rows from each row's position on
             (masked columns, the stale slot at pos) and whose dead blocks
             hold POISON: bit-equal to the same pool with zeros there, within
             PAGED_TOL of the plain arithmetic. (c) Planted faults through
             the captured programs: a use-after-free (block and
             generation), a leak at finish (request and blocks), NaN in the
             pool (leaf and layer), and a corrupt weight at a sanitized
             engine's init (QuantNumericsError with param and layer class).
             (d) kv_quant int8 and fp8 pools refused under sanitize. (e)
             rwkv6-7b at full width and SANITIZE_RWKV_LAYERS layers through
             the RecurrentAdapter: tokens equal on and off, audit clean.
             Its time is printed.
13. mesh:    the platform layers (dist/sharding.py, ft/elastic.py, the
             placed train step, launch/dryrun.py) on a one-rank NCCL group
             over a HashStore: (a) elastic_mesh() is 1 x 1 (this machine has
             one card) and every placement of TinyLlama's tree degrades to
             replicated. (b) 2 steps at phase 11 (b)'s 8 x 128, placed
             (make_train_step with the mesh: DTensor params and moments,
             gathered a step) against unplaced from the same weights:
             losses, grad norms and every leaf of params, m and v bit-equal;
             ms a step both ways (host clock and CUDA events). (c) (b)'s
             comparison for one step at 1 x 2048 under blockwise_attention,
             the placed step's B4 and B4' launches counted from 0 around it.
             (d) compressed_all_reduce over the group on (b)'s gradients,
             bit-equal to compress_leaf + decompress_leaf. (e) the dry-run's
             host cell: train_4k's and prefill_32k's arguments allocated and
             placed, memory_allocated's growth within 1 % of the dry-run's
             bytes a device; decode_32k (a 94.5 GB cache) marked as not
             fitting and not allocated. The group is destroyed; the time is
             printed.
14. contracts: the compiled-program contracts' card halves
             (analysis/xray.card_audit, analysis/launch_contract.
             card_contract). TinyLlama generate at batch 1, cache 64, full
             width and depth, with each of the six weight presets phase 3
             quantized (its weights kept on the host since) and with int8
             weights over an int8 and an fp8 KV cache: each captured decode
             program's kernel nodes (cuGraphKernelNodeGetParams, their
             argument values mapped to weights, cache and graph pool) read
             every quantized weight slice exactly once, in a GQMV/GQMM node;
             the weight bytes they read within 15 % of the registry nbytes
             model (printed beside bounds.decode_step's); 4 L + 1 = 89
             projection nodes; no NCCL node; the cache in place across a
             replay and the graph pool below one cache leaf; no pool block
             of a dequantized weight's size. Then every kernel node of every
             captured program still alive (those, a paged int8 and int8-KV
             decode, a blockwise prefill, two fused RMSNorm + quantize
             programs): block <= 1024, grid y/z <= 65535, dynamic shared
             memory <= the opt-in and, for a hand-written kernel, equal to
             its kernels/ mirror. Launch counts are restored after; the
             time is printed beside CONTRACTS["budget_s"].

A [graphs] line sums up eager against replayed: int8 decode ms/step wall
and on the card with the busy share, the 4 x 64 prefill, the ragged tok/s,
the captures and the graph pools. Every time is printed beside the card's
name and power limit from nvidia-smi. The lines before the last are a JSON object of the kernels (14
entries: B4 has a tensor-core and an f32 entry and its backward one; the paged entries carry the
b = 32, MB*BS 2048 row beside the serve's shape), then the card's name and
power limit; the last line is
``{"ok": true, "device": {...}}``. Phase 8's launches join each kernel's
count (``launches_by_run``) and its shapes each kernel's ``family_shapes``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import itertools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.analysis.program import kernel_signature  # noqa: E402
from repro_torch.analysis.shadow import POISON, SanitizerError  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.policy import resolve_format_map  # noqa: E402
from repro_torch.core.quant import (  # noqa: E402
    FP8_MAX,
    QuantizedTensor,
    QuantNumericsError,
    get_format,
    numerics_checks_enabled,
    quantize,
    quantize_activation,
    set_numerics_checks,
)
from repro_torch.core import flags  # noqa: E402
from repro_torch.core.qlinear import embedding_lookup  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core.tree import (  # noqa: E402
    tensor_map_with_path,
    tree_index,
    tree_items,
    tree_map,
    tree_to,
)
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.ft.elastic import elastic_mesh  # noqa: E402
from repro_torch.kernels import bounds, cuda_build, ops  # noqa: E402
from repro_torch.kernels import flash_attn as fkern  # noqa: E402
from repro_torch.kernels import gqmv as kern  # noqa: E402
from repro_torch.kernels import paged_attn as pkern  # noqa: E402
from repro_torch.kernels import rmsnorm_quant as rkern  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    flash_attention_bwd_ref,
    flash_attention_ref,
    paged_attention_ref,
    rmsnorm_quant_ref,
)
from repro_torch.models import mlp as mlpmod  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.common import NEG_INF, decode_mask, rmsnorm  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.models.transformer import _layer_windows, contiguous_to_paged  # noqa: E402
from repro_torch.models.transformer import lm_init_paged_cache as init_paged_cache  # noqa: E402
from repro_torch.serving.batching import (  # noqa: E402
    Request,
    bucket_length,
    pad_bucket,
    serve_ragged,
    slot_scheduler,
    valid_modes,
)
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.core import SchedulerCore  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.paged import PagedAdapter, paged_scheduler  # noqa: E402
from repro_torch.serving.sampling import fill_gumbel, nucleus_mask  # noqa: E402
from repro_torch.serving.spec import NgramDrafter  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compress import (  # noqa: E402
    compress_leaf,
    compressed_all_reduce,
    decompress_leaf,
)
from repro_torch.train.loop import (  # noqa: E402
    LoopConfig,
    batch_to,
    make_loss_fn,
    make_train_step,
    run_loop,
    value_and_grad,
)

# H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 tensor operations/s,
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

ARCH = "tinyllama-1.1b"
# (name, m, n): every quantized projection TinyLlama runs, per layer and once
PROJECTIONS = (("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w13", 11264, 2048),
               ("w2", 2048, 5632), ("classifier", 32000, 2048))
KERNEL_BATCHES = (1, 4, 16, 64, 256)
# GQMM of every format: both designs timed at these b, the cut-over's
# neighbourhood (kern.SMALL_MAX_B), on every projection
CUTOVER_BATCHES = (8, 16)
# the int4 and fp8 GQMM designs (small at b <= kern.SMALL_MAX_B, large
# above), checked against their plain versions at every projection, every
# group size and these b
TC_SWEEP = {"formats": ("int4", "fp8"), "batches": (4, 8, 16, 256),
            "group_sizes": (16, 32, 64, 128, 256)}
# torch._int_mm (int8 tensor-core product, no group scales; the port never
# calls it) timed at this b on the int8 operands, as a yardstick
INT_MM_B = 256
RTOL = 1e-5
# weight formats of phase 2, the fp8 tolerance (rtol, absolute atol), and
# the card's peak rate for the products (fp8 x int8 runs at f16's and
# bf16's rate: both hold e4m3 and int8 values exactly, and the fp8 GQMM
# runs the f16 tensor cores)
WEIGHT_FORMATS = ("int8", "int4", "int3", "fp8")
FP8_TOL = (5e-4, 1e-4)
OPS_PER_S = {"int8": INT8_OPS_PER_S, "int4": INT8_OPS_PER_S, "int3": INT8_OPS_PER_S,
             "fp8": BF16_OPS_PER_S}
GS_SWEEP = {"m": 200, "n": 1024, "batches": (1, 4, 13, 40),
            "group_sizes": (16, 32, 64, 128, 256)}
# the GQMV formats that run the streamed design, checked against their plain
# versions at every projection and every group size
GQMV_SWEEP = {"formats": ("int4", "int3", "fp8", "int8"), "group_sizes": (16, 32, 64, 128, 256)}
# how far off a 16-byte boundary the first GQMV design still takes a format's
# storage (fp8's first design needs 16 bytes itself): phase 2 checks the
# first design there, at n 1056 (GS 32) and on a stacked leaf's layer slices
FIRST_DESIGN_SHIFT = {"int3": 2, "int4": 8}
# phase 3's weight settings after int8, and the one phase 5 serves paged
FORMAT_SETTINGS = ("int4", "int3", "fp8", "mixed", "mixed3")
RAGGED_FORMAT = "mixed3"
# phase 2, flash attention (B4): TinyLlama's causal GQA 32/4 heads at hd 64,
# timed beside scaled_dot_product_attention (the library call for the same
# function, a yardstick the port never calls) at the serve's prefill
# (4 x 64) and at one 2048-token prompt, then gemma2-2b's heads (8/4 at hd
# 256) and zamba2-7b's shared attention's (32/32 at hd 112) over one
# 2048-token prompt; then checked-only cases: window + soft cap (also at hd
# 256 and 112, gemma2's soft cap 50), non-causal, hd 32 and 128, a length
# that is no power of two.
# (name, b, heads, kv_heads, s, t, hd, causal, window, softcap)
FLASH_TIMED = (("4x64", 4, 32, 4, 64, 64, 64, True, None, None),
               ("1x2048", 1, 32, 4, 2048, 2048, 64, True, None, None),
               ("gemma2_1x2048", 1, 8, 4, 2048, 2048, 256, True, None, None),
               ("zamba2_1x2048", 1, 32, 32, 2048, 2048, 112, True, None, None))
FLASH_CHECKED = (("window32_cap50", 2, 8, 2, 256, 256, 64, True, 32, 50.0),
                 ("non_causal", 2, 8, 2, 64, 96, 64, False, None, None),
                 ("hd32", 2, 8, 2, 128, 128, 32, True, None, None),
                 ("hd128", 2, 8, 2, 128, 128, 128, True, None, None),
                 ("4x200", 4, 32, 4, 200, 200, 64, True, None, None),
                 ("hd256_window48_cap50", 2, 8, 4, 256, 256, 256, True, 48, 50.0),
                 ("hd112_window48_cap50", 2, 8, 8, 200, 200, 112, True, 48, 50.0))
FLASH_DTYPES = (torch.bfloat16, torch.float32)
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLASH_MAIN = "4x64"          # the kernels line reports the serve's prefill shape
# phase 2, fused RMSNorm + quantize (B2): TinyLlama's rows at GS 256, then
# every group size on a small shape; checked at bf16 and f32 input
RMSQ_TIMED = ((4, 2048), (256, 2048), (256, 5632))
RMSQ_SWEEP = {"m": 13, "n": 1024, "group_sizes": (16, 32, 64, 128, 256)}
RMSQ_DTYPES = (torch.bfloat16, torch.float32)
RMSQ_MAIN = (256, 2048)
# phase 6: the perf-variant flags on the phase-3 model and int8 weights
SERVE_FLAGS = {"blockwise_attention": True, "deferred_decode_cache": True,
               "kvt_cache_layout": True}
LONG_PREFILL = {"b": 1, "s": 2048}
FORWARD = {"b": 2, "s": 512}
SERVE = {"batch": 4, "prompt_len": 64, "max_new_tokens": 32, "seed": 0}
LOGIT_TOL = 5e-2
# a replayed golden token may lose the card's greedy choice only to a near
# tie: one int8 activation rounded to the other side of a .5 boundary moves
# the golden config's logits by up to 1.3e-2 of max|logit|
# (tests/trace_torch_golden.py on the CPU; the CPU's own replay of uniform
# int3 loses three steps, by margins up to 1.32e-2), so a lost step's margin
# stays below twice that
TIE_MARGIN = 3e-2
GOLDEN_FILE = ROOT / "src" / "repro_torch" / "golden_tinyllama.json"
GOLDEN = {"arch": ARCH, "num_layers": 2, "dtype": "float32", "quantize": "int8",
          "seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 16,
          "max_new_tokens": 16, "weight_formats": list(FORMAT_SETTINGS),
          "flags": SERVE_FLAGS}
# the deep golden: the same prompt and weights drawn the same way, at
# TinyLlama's full depth; f32 weights (token-exact) and int8 weights (exact,
# or the reference's token replayed, lost only at steps traced to a .5
# activation tie, each within TIE_MARGIN). The CPU's tie step is in the
# golden file (tests/test_torch_deep_tie.py traces it); the card's f32
# order rounds that tie as the reference does but another one, layer 2's w2
# input at row 0, position 2, column 1490 (x/S 24.500008 on the card,
# 24.499998 in the reference; the float inputs 2.9e-6 apart at max|x| 8.9),
# not, which loses row 0's token at decode step 11 (`python
# tests/trace_torch_card.py int8 --layers 22 --against NPZ`, the NPZ from
# `tests/trace_torch_golden.py int8 --layers 22 --steps 16 --dump NPZ`)
GOLDEN_DEEP = {"num_layers": 22, "settings": ["float32", "int8"]}
# the families' goldens (golden_<arch>.json, tests/make_torch_golden.py
# --arch): full width, 2 layers, f32 compute, weights from
# init_params_numpy; the reference's greedy tokens with f32 and int8 weights
FAMILY_GOLDEN = {"archs": ["internlm2-1.8b", "gemma2-2b", "minicpm3-4b", "deepseek-v2-lite-16b",
                           "rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2"],
                 "num_layers": 2, "dtype": "float32",
                 "settings": ["float32", "int8"], "seed": 0, "prompt_seed": 1, "batch": 2,
                 "prompt_len": 16, "max_new_tokens": 16}
# zamba2's golden depth: at 2 layers it has no shared block; 7 is one group
# of 6 Mamba2 layers, one shared-block application and a tail layer. The
# encoder-decoder's golden has as many encoder layers as decoder layers (2
# + 2) and frames (batch, prompt_len, d_model), N(0, 1) from a numpy
# RandomState seeded with frames_seed
FAMILY_GOLDEN_LAYERS = {"zamba2-7b": 7}
FAMILY_GOLDEN_FRAMES_SEED = 2
DEEP_CARD_TIES = {"int8": [(11, 0)]}      # (decode step, batch row)
# the golden ragged trace, served by serve_ragged(mode="paged") on the
# golden model with a float, int8 and fp8 KV pool
GOLDEN_RAGGED = {"prompt_seed": 2, "prompt_lens": [5, 16, 9, 12, 3],
                 "budgets": [8, 4, 12, 6, 10], "max_new_tokens": 12, "slots": 3,
                 "chunk": 4, "block_size": 8, "cache_len": 32,
                 "kv": ["float", "int8", "fp8"]}
# phase 2, paged attention: TinyLlama's KV heads, query heads per KV head
# and head dim; every pool type, batch, block size and table width below
PAGED = {"kv": 4, "g": 8, "hd": 64, "batches": (1, 8, 32), "block_sizes": (8, 16),
         "widths": (256, 2048), "pools": ("float", "int8", "fp8"),
         "qdtypes": (torch.bfloat16, torch.float32), "softcaps": (None, 50.0)}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# gemma2's paged shape (G 2 at hd 256; an f32 pool runs 32-column tiles):
# every pool type, one split (256 columns at b = 3 is 4 tiles) and many
PAGED_HD256 = {"kv": 4, "g": 2, "hd": 256, "b": 3, "bs": 8, "widths": (256, 2048),
               "cases": (("float", torch.bfloat16), ("float", torch.float32),
                         ("int8", torch.bfloat16), ("fp8", torch.bfloat16),
                         ("int8", torch.float32))}
# the shape of the ragged serve's decode (phase 5): 8 slots, blocks of 8,
# 256-token tables, bf16 queries; the kernels line reports this call, and
# beside it a long-cache batch (32 rows of 2048-token tables)
PAGED_MAIN = {"b": 8, "bs": 8, "T": 256, "qdtype": "bfloat16", "softcap": None}
PAGED_LARGE = {"b": 32, "bs": 8, "T": 2048, "qdtype": "bfloat16", "softcap": None}
# phase 7: speculative decoding (k-token chunks, n-gram and oracle drafters)
# and top-p (nucleus mass, and the tiny mass that collapses it to the argmax)
SPEC = {"k": 4, "top_p": 0.9, "tiny_p": 1e-6, "seed": 0}
# phase 5: the ragged trace at full width
# the ragged passes run cold (capturing), replayed and eager: (name, KV pool, mode)
RAGGED_REPLAYED = (("paged_float", None, "paged"), ("paged_int8", "int8", "paged"),
                   ("paged_fp8", "fp8", "paged"), ("continuous", None, "continuous"),
                   ("bucketed", None, "bucketed"))
RAGGED = {"requests": 16, "prompt_lens": (16, 192), "budgets": (8, 64), "seed": 0,
          "slots": 8, "chunk": 4, "block_size": 8}
# phase 8: the families beside TinyLlama at full width, bf16 and int8
# weights from the port's init_lm; the depth each runs (None: every layer).
# pixtral-12b (~273 M parameters a layer, 1.34 G of embedding and
# classifier) and deepseek-coder-33b (~530 M a layer: 62 layers of bf16
# draw and int8 copy would not fit in 80 GB) are cut, and dbrx-132b (~3.3 G
# a layer: 6.5 GB of bf16 draw and 3.3 GB of int8 copy); the others, and
# dbrx further, for time (FAMILY_CUT_REASONS)
FAMILIES = {"internlm2-1.8b": 12, "gemma2-2b": 13, "pixtral-12b": 10,
            "deepseek-coder-33b": 4, "minicpm3-4b": 8, "deepseek-v2-lite-16b": 2,
            "dbrx-132b": 2}
# phase 12 (sanitize) added ~17 s and the script read 802.1 and 858.5 s on
# two runs of one tree (phase 8 took 272.0 and 285.6 of them; NVIDIA H100
# 80GB HBM3, 700 W): halving these depths took ~60 s off phase 8
_PHASE12 = "; halved when phase 12 was added, for the script's time"
FAMILY_CUT_REASONS = {
    "pixtral-12b": "memory", "deepseek-coder-33b": "memory",
    "dbrx-132b": "memory: 4 layers fit" + _PHASE12,
    "internlm2-1.8b": "the script's time: 14.0 s at every layer" + _PHASE12,
    "gemma2-2b": "the script's time: 27.8 s at every layer (13 keeps local and global "
                 "layers alike)" + _PHASE12,
    "minicpm3-4b": "the script's time: phase 11 (training) adds ~60 s, and at 62 layers "
                   "this family took 61.5 s of phase 8, the most of any; 16 layers "
                   "17.3 s" + _PHASE12,
    "deepseek-v2-lite-16b": "phase 8's 300 s budget: every one of a layer's 64 experts "
                            "runs each step, two GQMMs and their glue, and the eager "
                            "comparison runs launch each of those kernels from the host; "
                            "4 layers 30.1 s" + _PHASE12}
# + the ragged serve and speculative generate on both caches; the MLA
# families (no paged pool, no verify) run the continuous and bucketed serve
# and their refusals instead
FAMILY_FULL = ("internlm2-1.8b", "gemma2-2b", "dbrx-132b", "minicpm3-4b",
               "deepseek-v2-lite-16b")
# the MoE and MLA families' projections: phase 2's check in every format;
# their int8 GQMM timed at decode's and prefill's b only (checked at all)
FAMILY_ALL_FORMATS = ("minicpm3-4b", "deepseek-v2-lite-16b", "dbrx-132b")
FAMILY_TIMED_BATCHES = {arch: (4, 256) for arch in FAMILY_ALL_FORMATS}
FAMILY_RAGGED = 8               # the first requests of phase 5's trace
# the serve_ragged modes a family runs (the family's every mode where not
# named), those held to an eager pass (bucketed mode replays generate
# programs, held to eager by family_generate), and the quantized KV pools
# of its paged mode
FAMILY_RAGGED_MODES = {"internlm2-1.8b": ("paged",), "gemma2-2b": ("paged",)}
FAMILY_EAGER_MODES = ("paged", "continuous")
FAMILY_KV_POOLS = {"dbrx-132b": ("int8", "fp8")}
# gemma2's long prompt: past its 4096-token window, so the local layers
# mask keys, then decode steps on the contiguous and the paged cache
FAMILY_LONG = {"arch": "gemma2-2b", "prompt_len": 4608, "steps": 16}
FAMILY_PATCH_PROMPT = 320       # pixtral: the first 256 positions are patch embeddings
# phase 2 at the families' shapes: the int8 GQMM at these b and the int8
# GQMV at every projection of each config; every format and design at rows
# with an odd number of groups (gemma2's d 2304 is 9 groups of 256,
# deepseek's d_ff 19200 is 75), checked only; flash attention (bf16) and
# paged attention (bf16 and int8 pools) at each config's attention shape
FAMILY_KERNEL_BATCHES = (1, 4, 16, 256)
ODD_GROUPS = {"m": 512, "widths": (2304, 19200), "batches": (1, 4, 8, 9, 16, 17, 256)}
FAMILY_FLASH = (("internlm2 1x2048", 1, 16, 8, 2048, 128, None, None),
                ("deepseek 1x2048", 1, 56, 8, 2048, 128, None, None),
                ("pixtral 1x2048", 1, 32, 8, 2048, 128, None, None),
                ("gemma2 1x4608 w4096 cap50", 1, 8, 4, 4608, 256, 4096, 50.0),
                ("dbrx 1x2048", 1, 48, 8, 2048, 128, None, None))
FAMILY_PAGED = (("internlm2", 8, 2, 128, 2048, None, None),
                ("deepseek", 8, 7, 128, 2048, None, None),
                ("pixtral", 8, 4, 128, 2048, None, None),
                ("gemma2 w4096 cap50", 4, 2, 256, 4608, 4096, 50.0),
                ("dbrx", 8, 6, 128, 2048, None, None))
FAMILY_PAGED_B = 8
# phase 9: the recurrent families at full width, bf16 and
# int8 weights from the port's init
RECURRENT_ARCHS = ("rwkv6-7b", "zamba2-7b")
# the depth each runs (None: every layer), cut for the script's time:
# phase 11 (e) and (f) (training of the recurrent families) add ~57 s, and
# at every layer zamba2-7b took ~84 s of phase 9 on an H100 80GB HBM3 at 700 W
RECURRENT_LAYERS = {"rwkv6-7b": None, "zamba2-7b": 27}
RECURRENT_CUT_REASON = ("the script's time: phase 11 (e) and (f) add ~57 s; 27 layers keep the "
                        "full config's tail of 3 and apply the shared block 4 times")
RECURRENT_BUDGET_S = 150
RECURRENT_MODEL_TYPES = ("rwkv6", "zamba2")
# the deep families whose kernel logits past LOGIT_TOL are held per kernel
# (``_check_family_logits``): the recurrent ones and the encoder-decoder
HELD_MODEL_TYPES = RECURRENT_MODEL_TYPES + ("encdec",)
# a family whose kernel logits leave the plain ones by more than LOGIT_TOL
# is held per kernel, and (but for a MoE, whose router flips jump) its
# logits to ULP_FACTOR x the change one f32 ulp at layer 0 makes in the
# plain run (hold_per_kernel)
ULP_FACTOR = 2.0
# (a) the int8 GQMM at these b and the int8 GQMV, timed, at every projection
# shape of both configs; int4, int3 and fp8 GQMM at RECURRENT_CHECKED_B,
# checked; B4 bf16 at the shape zamba2's blockwise prefill gives it (the
# serve's 4 x 64 prompt, 32/32 heads, hd 112; phase 2's zamba2_1x2048 row
# holds one 2048-token prompt)
RECURRENT_KERNEL_BATCHES = (1, 4, 256)
RECURRENT_CHECKED_B = (4, 256)
RECURRENT_FLASH = ("zamba2 4x64", 4, 32, 32, 64, 112, None, None)
# (c) serve_ragged: prompts of exact lengths from a few values, so the
# exact-length prefill programs (a per-position scan each) stay few
RECURRENT_RAGGED = {"requests": 8, "prompt_lens": (16, 24, 32), "budgets": (8, 32), "seed": 0,
                    "slots": 4, "chunk": 4}
# phase 12 (e): rwkv6-7b's depth under the sanitizer (full width), for the
# script's time; phase 9 serves it at every layer
SANITIZE_RWKV_LAYERS = 4
# phase 12 (a): replayed passes a mode with the sanitizer off and on, in
# turns (off, on, on, off, ...): one pass reads +-15 % on the host clock
SANITIZE_PAIRS = 3
# (d) zamba2's shared cache under the KV-layout flags (kvt, floats)
RECURRENT_FLAGS = {"deferred_decode_cache": True, "kvt_cache_layout": True,
                   "int8_kv_cache": True}
# (e) the chunked SSD against the sequential scan, zamba2's first Mamba2
# layer over 1 x 512 tokens. Tolerance: the CPU test
# (tests/test_torch_recurrent.py) holds the two forms within 1e-4 of each
# other at f32 (|y| ~ 1), f32 reordering; here each form's f32 y is rounded
# to bf16 (2^-8 relative) before the gate norm and wout, so the outputs may
# sit a couple of bf16 steps apart: 1e-2 of max|y|; the f32 state h keeps
# the f32 rule, 1e-4 of max|h|. The whole prefill's logits are printed
# beside the model's one-ulp sensitivity (phase 9 (b)): at full depth the
# random model carries one f32 ulp to ~1e-1 of max|logit|
RECURRENT_CHUNKED = {"b": 1, "s": 512, "chunk": 128, "y_tol": 1e-2, "h_tol": 1e-4}
# phase 10: seamless-m4t-large-v2, the encoder-decoder, at full width and
# every layer (24 + 24), bf16, int8 weights from the port's init
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_BUDGET_S = 120
# generate as phase 8's (SERVE: b 4, a decoder prompt of 64 tokens, 32
# greedy tokens) with frames (b, s_enc, d_model) f32 from a torch.Generator
# on the card seeded with "seed"; the self cache of cache_len rows (the
# cross K/V of s_enc rows)
ENCDEC = {"s_enc": 512, "cache_len": 96, "seed": 0}
# GQMM launches: a decode step runs each decoder layer's wqkv, wo, cross wq,
# cross wo, w13, w2 and the classifier (24 x 6 + 1); a prefill the encoder's
# four a layer, the decoder's seven (the cross wkv too) and the classifier
# (24 x 4 + 24 x 7 + 1)
ENCDEC_GQMM = {"decode": 24 * 6 + 1, "prefill": 24 * 4 + 24 * 7 + 1}
# (a) the int8 GQMM timed at decode's rows and the encoder's (4 x 512), and
# the int8 GQMV, at every projection shape; int4, int3 and fp8 GQMM at
# ENCDEC_CHECKED_B, checked; B4 bf16 at the encoder's shape (non-causal,
# 4 x 512, 16/16 heads, hd 64) and the decoder prompt's (causal, 4 x 64)
ENCDEC_KERNEL_BATCHES = (4, 2048)
ENCDEC_CHECKED_B = (4, 256)
ENCDEC_FLASH = ((("seamless encoder 4x512", 4, 16, 16, 512, 64, None, None), False),
                (("seamless decoder 4x64", 4, 16, 16, 64, 64, None, None), True))
# phase 11: training, TinyLlama-1.1B at full width (bf16 params and
# compute). (a) the flash backward (flash_attn_bwd) against its plain
# version at (name, b, H, KV, s, hd, causal, window, soft cap), f32 and
# bf16, within TRAIN_GRAD_TOL of max|plain| for each of dQ, dK and dV (the
# plain arithmetic in f32 on the same values); the forward's log-sum-exp
# within TRAIN_LSE_TOL (absolute) of the plain version's
TRAIN_FLASH = (("tinyllama 4x128", 4, 32, 4, 128, 64, True, None, None),
               ("tinyllama 1x2048", 1, 32, 4, 2048, 64, True, None, None),
               ("gemma2 1x4608 window cap", 1, 8, 4, 4608, 256, True, 4096, 50.0),
               ("zamba2 1x2048", 1, 32, 32, 2048, 112, True, None, None),
               ("seamless encoder 4x512", 4, 16, 16, 512, 64, False, None, None))
TRAIN_FLASH_MAIN = "tinyllama 1x2048"   # the kernels line: (c)'s shape
# each case's backward on the first design (f32 on the CUDA cores for every
# dtype), measured by this script on an NVIDIA H100 80GB HBM3 at 700.00 W,
# us by (case, dtype): printed beside this run's as "was"
TRAIN_FLASH_WAS_US = {
    ("tinyllama 4x128", "bfloat16"): 249.6, ("tinyllama 4x128", "float32"): 247.6,
    ("tinyllama 1x2048", "bfloat16"): 5563.0, ("tinyllama 1x2048", "float32"): 5561.0,
    ("gemma2 1x4608 window cap", "bfloat16"): 26991.0,
    ("gemma2 1x4608 window cap", "float32"): 27419.0,
    ("zamba2 1x2048", "bfloat16"): 7398.0, ("zamba2 1x2048", "float32"): 7578.0,
    ("seamless encoder 4x512", "bfloat16"): 971.7, ("seamless encoder 4x512", "float32"): 985.3}
TRAIN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# (b) the train CLI's defaults (SyntheticLM seed 0, batch 8, seq 128, lr
# 3e-4) for 8 steps through run_loop; (d) at resume_layers layers (full
# width): 8 steps with a checkpoint every resume_at, then a resume from
# step resume_at to step 8
TRAIN = {"batch": 8, "seq": 128, "lr": 3e-4, "steps": 8, "seed": 0, "resume_at": 4,
         "resume_layers": 2}
TRAIN_RESUME_CUT = ("checkpoint I/O: a 22-layer checkpoint is 11 GB (bf16 params, f32 m "
                    "and v), ~15 s a save or restore, and (d) writes three and reads one")
# (c) one step under blockwise_attention at 1 x 2048: every gradient leaf
# of the kernel path against the plain path's within TRAIN_LEAF_TOL of the
# leaf's max|plain|, and every B4 call of the step held to its plain version
# on the same inputs (FLASH_TOL / TRAIN_GRAD_TOL)
TRAIN_BLOCKWISE = {"b": 1, "s": 2048}
TRAIN_LEAF_TOL = 5e-2
# (e), (f): the recurrent families trained at full width through run_loop
# with (b)'s settings, bf16, the depth cut to what the card holds (printed
# with the reckoning of train_memory); (e) also one f32 step of rwkv6 at
# TRAIN_RECURRENT_CPU's depth and tokens on the card against the same step
# on the CPU (allow_tf32 off), every leaf within its tol of max|cpu|; (f)
# also zamba2's blockwise step (train_blockwise) under chunked_ssd, every
# leaf within TRAIN_LEAF_TOL; the two within TRAIN_RECURRENT_BUDGET_S
TRAIN_RECURRENT = {"rwkv6-7b": 10, "zamba2-7b": 19}
TRAIN_RECURRENT_STEPS = 3
TRAIN_RECURRENT_CPU = {"arch": "rwkv6-7b", "layers": 2, "b": 1, "s": 16, "tol": 1e-3}
TRAIN_RECURRENT_BUDGET_S = 90
# phase 13 (mesh): the platform layers on a one-rank NCCL group. This
# machine has one card, so elastic_mesh() is 1 x 1 and every placement
# replicates. (b)'s 8 x 128 steps, placed against unplaced; (c)'s 1 x 2048
# step under blockwise_attention; compressed_all_reduce; and the dry-run's
# host cell: the cells' arguments placed on the card, the allocator's
# growth within MESH_BYTES_RTOL of the dry-run's bytes (it rounds each
# block up to 512 bytes); the cell not allocated (its cache outgrows the
# card) must be marked as not fitting
MESH = {"steps": 2, "cells": ("train_4k", "prefill_32k"), "unallocated": "decode_32k",
        "budget_s": 45}
MESH_BYTES_RTOL = 1e-2
# phase 14 (contracts): the card halves of the xray audits
# (analysis/xray.card_audit) on full-depth TinyLlama generate decode programs
# at batch 1, cache 64, one a weight preset of phase 3 (its weights kept on
# the host since) and int8 weights over an int8 and an fp8 KV cache; then the
# launch contract's card half (analysis/launch_contract.card_contract) over
# every captured program still alive, with a paged decode, a blockwise
# prefill and a fused RMSNorm + quantize program beside them
CONTRACTS = {"batch": 1, "cache_len": 64, "prompt_len": 8, "new_tokens": 4,
             "blockwise_prompt": 48, "rmsq_rows": (1, 4), "budget_s": 45}
SOURCES = {**{f"{k}_{f}": "src/repro_torch/csrc/gqmm.cu" for f in WEIGHT_FORMATS
              for k in ("gqmv", "gqmm")},
           "paged_attn": "src/repro_torch/csrc/paged_attn.cu",
           "paged_attn_quant": "src/repro_torch/csrc/paged_attn.cu",
           "flash_attn": "src/repro_torch/csrc/flash_attn.cu",
           "flash_attn_f32": "src/repro_torch/csrc/flash_attn.cu",
           "flash_attn_bwd": "src/repro_torch/csrc/flash_attn.cu",
           "rmsnorm_quant": "src/repro_torch/csrc/rmsnorm_quant.cu"}
REPLACES = {"gqmv_int8": "src/repro/kernels/gqmv.py:166",     # gqmv_pallas
            "gqmm_int8": "src/repro/kernels/gqmv.py:312",     # gqmm_pallas
            "gqmv_int4": "src/repro/kernels/gqmv.py:182",     # gqmv_int4_pallas
            "gqmm_int4": "src/repro/kernels/gqmv.py:329",     # gqmm_int4_pallas
            "gqmv_int3": "src/repro/kernels/gqmv.py:198",     # gqmv_int3_pallas
            "gqmm_int3": "src/repro/kernels/gqmv.py:346",     # gqmm_int3_pallas
            "gqmv_fp8": "src/repro/kernels/gqmv.py:214",      # gqmv_fp8_pallas
            "gqmm_fp8": "src/repro/kernels/gqmv.py:363",      # gqmm_fp8_pallas
            # paged_attention_pallas: _paged_kernel / _paged_quant_kernel
            "paged_attn": "src/repro/kernels/paged_attn.py:116",
            "paged_attn_quant": "src/repro/kernels/paged_attn.py:116",
            "flash_attn": "src/repro/kernels/flash_attn.py:82",       # flash_attention_pallas
            "flash_attn_f32": "src/repro/kernels/flash_attn.py:82",
            # the gradient of flash_attention_pallas's function (the
            # reference differentiates its XLA twin _mha_blockwise)
            "flash_attn_bwd": "src/repro/kernels/flash_attn.py:82",
            "rmsnorm_quant": "src/repro/kernels/rmsnorm_quant.py:36"}  # rmsnorm_quant_pallas


def golden_config(num_layers: int | None = None):
    cfg = load_config(GOLDEN["arch"])
    return dataclasses.replace(cfg, num_layers=num_layers or GOLDEN["num_layers"],
                               param_dtype=GOLDEN["dtype"], compute_dtype=GOLDEN["dtype"])


def family_golden_file(arch: str) -> Path:
    return ROOT / "src" / "repro_torch" / f"golden_{arch.replace('-', '_').replace('.', '_')}.json"


def family_golden_settings(arch: str) -> dict:
    """What golden_<arch>.json was made with: FAMILY_GOLDEN but its arch
    list, at the arch's golden depth (the encoder-decoder's: as many
    encoder layers, and its frames' seed)."""
    out = {k: v for k, v in FAMILY_GOLDEN.items() if k != "archs"}
    out["num_layers"] = FAMILY_GOLDEN_LAYERS.get(arch, FAMILY_GOLDEN["num_layers"])
    if load_config(arch).model_type == "encdec":
        out.update(encoder_layers=out["num_layers"], frames_seed=FAMILY_GOLDEN_FRAMES_SEED)
    return out


def family_golden_config(arch: str):
    st = family_golden_settings(arch)
    cfg = load_config(arch)
    return dataclasses.replace(cfg, num_layers=st["num_layers"],
                               encoder_layers=st.get("encoder_layers", cfg.encoder_layers),
                               param_dtype=FAMILY_GOLDEN["dtype"],
                               compute_dtype=FAMILY_GOLDEN["dtype"])


def family_golden_extra(cfg) -> dict:
    """The golden prompt's other inputs: the encoder-decoder's frames
    (batch, prompt_len, d_model), else none."""
    if cfg.model_type != "encdec":
        return {}
    rng = np.random.RandomState(FAMILY_GOLDEN_FRAMES_SEED)
    return {"frames": rng.standard_normal((FAMILY_GOLDEN["batch"], FAMILY_GOLDEN["prompt_len"],
                                           cfg.d_model)).astype(np.float32)}


def family_golden_prompt(vocab_size: int) -> np.ndarray:
    rng = np.random.RandomState(FAMILY_GOLDEN["prompt_seed"])
    return rng.randint(0, vocab_size, size=(FAMILY_GOLDEN["batch"],
                                            FAMILY_GOLDEN["prompt_len"]))


def golden_prompt(vocab_size: int) -> np.ndarray:
    rng = np.random.RandomState(GOLDEN["prompt_seed"])
    return rng.randint(0, vocab_size, size=(GOLDEN["batch"], GOLDEN["prompt_len"]))


def golden_ragged_prompts(vocab_size: int) -> list[list[int]]:
    rng = np.random.RandomState(GOLDEN_RAGGED["prompt_seed"])
    return [rng.randint(0, vocab_size, size=n).tolist() for n in GOLDEN_RAGGED["prompt_lens"]]


def weights_checksum(tree) -> str:
    """sha256 over every leaf's bytes, in sorted key order."""
    h = hashlib.sha256()

    def feed(node):
        if isinstance(node, dict):
            for k in sorted(node):
                feed(node[k])
        else:
            h.update(np.ascontiguousarray(node).tobytes())

    feed(tree)
    return h.hexdigest()


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


CARD = {"smi": "not read"}      # set by main() before any phase; printed beside the times


def bound_s(nbytes: int, ops: int, ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (tb, "bytes") if tb >= to else (to, "operations")


def call_bytes(wq, ws, xq, xs, out_numel: int) -> int:
    """Each input read once, the f32 output written once."""
    return (wq.numel() + 4 * ws.numel() + xq.numel() + 4 * xs.numel() + 4 * out_numel)


SPIN_CYCLES_PER_MS = 2.0e6   # >= the H100's top SM clock: a spin of x ms lasts >= x ms


class HostBound(RuntimeError):
    """The host's enqueue outlasted every GPU spin (``device_time_ms``)."""


def device_time_ms(fn, iters: int, host_ms_guess: float = 0.1) -> tuple[float, float]:
    """(mean device ms, mean host enqueue ms) of fn(0), ..., fn(iters-1) run
    back to back. A GPU spin queued first keeps the card busy while the host
    enqueues the calls, so the host's per-call cost (Python checks, ctypes,
    PyTorch dispatch) stays out of the CUDA-event reading; the spin grows
    until it outlasts the enqueue."""
    fn(0)
    torch.cuda.synchronize()
    spin_ms = max(1.0, 2.0 * host_ms_guess * iters)
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * spin_ms:
            return start.elapsed_time(end) / iters, host_ms / iters
        spin_ms = 2.0 * host_ms
    raise HostBound("the host's enqueue outlasted every GPU spin; no device time read")


def profile_device(fn, reps: int) -> dict:
    """Device time per call of fn() by kernel name, from torch.profiler's
    CUDA activity (CUPTI also sees the kernels launched through ctypes).
    A profile that now and then comes back without CUDA activity is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        counts: dict[str, int] = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", 0) or 0
            if us > 0:
                by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3 / reps
                counts[evt.key] = counts.get(evt.key, 0) + evt.count
        count = sum(counts.values())
        total = sum(by_name.values())
        if total > 0:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time in three profiles")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    def ms(pred):
        return sum(v for k, v in by_name.items() if pred(k))

    # the port's kernels by name (the paged op's split pass and combine, both
    # flash kernels, the flash backward's launches); float products: cuBLAS /
    # CUTLASS GEMMs
    products = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "s16816")
    bwd_split: dict[str, float] = {}
    for k, v in by_name.items():
        if "flash_bwd" in k:
            part = ("D" if "delta" in k else "group sum" if "group_sum" in k
                    else "dQ" if "true>" in k else "dK/dV")
            bwd_split[part] = bwd_split.get(part, 0.0) + v
    return {"device_ms": total, "kernels": count // reps,
            "gqmm_ms": ms(lambda k: "gqmm_" in k),
            "paged_ms": ms(lambda k: "paged_attn" in k),
            "paged_kernels": sum(c for k, c in counts.items() if "paged_attn" in k) // reps,
            "flash_ms": ms(lambda k: "flash_attn" in k and "flash_bwd" not in k),
            "flash_bwd_ms": ms(lambda k: "flash_bwd" in k), "flash_bwd_split": bwd_split,
            "products_ms": ms(lambda k: any(w in k.lower() for w in products)),
            "top": top}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand_q(gen, shape, gs, dev):
    q = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((*shape[:-1], shape[-1] // gs), generator=gen, device=dev) * 1e-2 + 1e-4
    return q, s


def _rand_weights(gen, fmt: str, m: int, n: int, gs: int, dev):
    """(storage, scales) of an (m, n) weight: random int8 values and scales
    for int8, random normal weights quantized by the port for the others."""
    if fmt == "int8":
        return _rand_q(gen, (m, n), gs, dev)
    w = quantize(torch.randn((m, n), generator=gen, device=dev), gs, fmt)
    return w.qvalues, w.scales


def check_close(name, got, want, fmt: str = "int8"):
    err = (got - want).abs()
    if fmt == "fp8":
        tol = FP8_TOL[0] * want.abs() + FP8_TOL[1]
    else:
        tol = RTOL * want.abs() + RTOL * want.abs().max()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max |err| {err.max().item():.3e}, tol {tol.max().item():.3e})")
    return err.max().item()


def _kernel_fns(kind: str, fmt: str):
    """(CUDA wrapper, plain version) of GQMV or GQMM for one weight format."""
    hook = ops.KERNEL_HOOKS[get_format(fmt).kernel]
    return getattr(hook, f"{kind}_cuda"), getattr(hook, f"{kind}_plain")


def phase_kernels(dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    gs = load_config(ARCH).group_size
    rows = []
    for fmt, (name, m, n) in itertools.product(WEIGHT_FORMATS, PROJECTIONS):
        wq, ws = _rand_weights(gen, fmt, m, n, gs, dev)
        wbytes = wq.numel() + 4 * ws.numel()
        copies = max(1, math.ceil(160e6 / wbytes))          # cycle through > 3x the L2
        pool = [(wq, ws)] + [(wq.clone(), ws.clone()) for _ in range(copies - 1)]
        for kind, b in [("gqmm", bb) for bb in KERNEL_BATCHES] + [("gqmv", 1)]:
            kname = f"{kind}_{fmt}"
            xq, xs = _rand_q(gen, (b, n) if kind == "gqmm" else (n,), gs, dev)
            kfn, pfn = _kernel_fns(kind, fmt)
            got = kfn(wq, ws, xq, xs, group_size=gs)
            want = pfn(wq, ws, xq, xs, group_size=gs)
            torch.cuda.synchronize()
            err = check_close(f"{kname} {name} b={b}", got, want, fmt)
            k_ms, k_host = device_time_ms(
                lambda i: kfn(*pool[i % copies], xq, xs, group_size=gs), max(50, 2 * copies))
            p_ms, _ = device_time_ms(
                lambda i: pfn(*pool[i % copies], xq, xs, group_size=gs), 5, host_ms_guess=1.0)
            bnd, by = bound_s(call_bytes(wq, ws, xq, xs, got.numel()), 2 * b * m * n,
                              OPS_PER_S[fmt])
            row = {"kernel": kname, "fmt": fmt, "shape": name, "m": m, "n": n, "b": b,
                   "max_abs_err": err, "us": 1e3 * k_ms, "host_us": 1e3 * k_host,
                   "plain_us": 1e3 * p_ms, "bound_us": 1e6 * bnd, "bound_by": by}
            if kind == "gqmm" and fmt in kern.TC_FORMATS:
                row["design"] = "%s/%d" % kern.gqmm_design(b, m, n, gs, fmt)
            elif kind == "gqmv":
                row["design"] = kern.gqmv_design(n, fmt, wq.data_ptr() % 16 == 0)
                if fmt in kern.STREAM_CHUNK_BYTES and row["design"] != "stream":
                    raise AssertionError(f"{kname} {name}: expected the streamed design")
                if fmt == "int8":
                    with first_gqmv_design():
                        row["first_us"] = 1e3 * device_time_ms(
                            lambda i: kfn(*pool[i % copies], xq, xs, group_size=gs),
                            max(50, 2 * copies))[0]
            if (kname, b) == ("gqmm_int8", INT_MM_B):
                row["int_mm_us"] = 1e3 * device_time_ms(
                    lambda i: torch._int_mm(xq, pool[i % copies][0].t()), max(50, 2 * copies))[0]
            rows.append(row)
            log(f"[kernels] {kname:9s} {name:10s} m={m:5d} n={n:4d} b={b:3d}  "
                f"max|err| {err:.2e}  {1e3 * k_ms:8.1f} us (host {1e3 * k_host:5.1f})  "
                f"plain {1e3 * p_ms:8.1f} us  bound {1e6 * bnd:6.1f} us ({by})"
                + (f"  design {row['design']}" if "design" in row else "")
                + (f"  first design {row['first_us']:.1f} us" if "first_us" in row else "")
                + (f"  int_mm {row['int_mm_us']:.1f} us" if "int_mm_us" in row else "")
                + f"  [{CARD['smi']}]")
        del pool
    return rows


@contextlib.contextmanager
def first_gqmv_design():
    """Every GQMV row on the first design inside the block (the library's
    streamed width set to 0): the design before the streamed one, timed."""
    prev = kern.set_stream_max_n(0)
    try:
        yield
    finally:
        kern.set_stream_max_n(prev)


def phase_cutover(dev) -> list[dict]:
    """GQMM of every format at the b of CUTOVER_BATCHES with each design
    (the library's cut-over moved by kern.set_small_max_b), on every
    projection: the times that set kern.SMALL_MAX_B. Both designs are
    checked against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(9)
    gs = load_config(ARCH).group_size
    rows = []
    for fmt, (name, m, n) in itertools.product(kern.TC_FORMATS, PROJECTIONS):
        wq, ws = _rand_weights(gen, fmt, m, n, gs, dev)
        copies = max(1, math.ceil(160e6 / (wq.numel() + 4 * ws.numel())))
        pool = [(wq, ws)] + [(wq.clone(), ws.clone()) for _ in range(copies - 1)]
        kfn, pfn = _kernel_fns("gqmm", fmt)
        for b in CUTOVER_BATCHES:
            xq, xs = _rand_q(gen, (b, n), gs, dev)
            want = pfn(wq, ws, xq, xs, group_size=gs)
            row = {"kernel": f"gqmm_{fmt}", "shape": name, "m": m, "n": n, "b": b}
            for design, cut in (("small", 10 ** 6), ("large", 0)):
                prev = kern.set_small_max_b(cut)
                try:
                    check_close(f"gqmm_{fmt} {name} b={b} {design}",
                                kfn(wq, ws, xq, xs, group_size=gs), want, fmt)
                    row[f"{design}_us"] = 1e3 * device_time_ms(
                        lambda i: kfn(*pool[i % copies], xq, xs, group_size=gs),
                        max(50, 2 * copies))[0]
                finally:
                    kern.set_small_max_b(prev)
            row["runs"] = kern.gqmm_design(b, m, n, gs, fmt)[0]
            rows.append(row)
            log(f"[cut-over] gqmm_{fmt} {name:10s} b={b:2d}  small {row['small_us']:7.1f} us  "
                f"large {row['large_us']:7.1f} us  (runs {row['runs']}; cut-over "
                f"{kern.SMALL_MAX_B}) [{CARD['smi']}]")
        del pool
    return rows


def phase_tc_sweep(dev) -> list[dict]:
    """The int4 and fp8 GQMM designs against their plain versions at every
    TinyLlama projection, every group size and each b of TC_SWEEP (the
    small design at b <= kern.SMALL_MAX_B, the large one at 256), with the
    design each shape runs. Checked only."""
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for fmt, (name, m, n), gs in itertools.product(TC_SWEEP["formats"], PROJECTIONS,
                                                   TC_SWEEP["group_sizes"]):
        wq, ws = _rand_weights(gen, fmt, m, n, gs, dev)
        kfn, pfn = _kernel_fns("gqmm", fmt)
        for b in TC_SWEEP["batches"]:
            xq, xs = _rand_q(gen, (b, n), gs, dev)
            design = "%s/%d" % kern.gqmm_design(b, m, n, gs, fmt)
            err = check_close(f"gqmm_{fmt} {name} GS {gs} b={b} ({design})",
                              kfn(wq, ws, xq, xs, group_size=gs),
                              pfn(wq, ws, xq, xs, group_size=gs), fmt)
            rows.append({"kernel": f"gqmm_{fmt}", "shape": name, "m": m, "n": n, "gs": gs,
                         "b": b, "design": design, "max_abs_err": err})
        del wq, ws
    torch.cuda.synchronize()
    for fmt in TC_SWEEP["formats"]:
        mine = [r for r in rows if r["kernel"] == f"gqmm_{fmt}"]
        designs = sorted({(r["b"], r["design"].split("/")[0]) for r in mine})
        log(f"[kernels] gqmm_{fmt}: {len(mine)} cases pass (every projection, GS "
            f"{TC_SWEEP['group_sizes']}, b in {TC_SWEEP['batches']}; designs by b "
            f"{designs}), max|err| {max(r['max_abs_err'] for r in mine):.2e}")
    return rows


def phase_gqmv_sweep(dev) -> list[dict]:
    """The streamed GQMV of every format of GQMV_SWEEP against its plain
    version at every TinyLlama projection and every group size (gqmv_design
    must name the streamed design at every one of them; each row logs it).
    Checked only."""
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for fmt, (name, m, n), gs in itertools.product(GQMV_SWEEP["formats"], PROJECTIONS,
                                                   GQMV_SWEEP["group_sizes"]):
        wq, ws = _rand_weights(gen, fmt, m, n, gs, dev)
        xq, xs = _rand_q(gen, (n,), gs, dev)
        design = kern.gqmv_design(n, fmt, wq.data_ptr() % 16 == 0)
        if design != "stream":
            raise AssertionError(f"gqmv_{fmt} {name} GS {gs}: expected the streamed design")
        kfn, pfn = _kernel_fns("gqmv", fmt)
        err = check_close(f"gqmv_{fmt} {name} GS {gs} ({design})",
                          kfn(wq, ws, xq, xs, group_size=gs), pfn(wq, ws, xq, xs, group_size=gs),
                          fmt)
        rows.append({"kernel": f"gqmv_{fmt}", "shape": name, "m": m, "n": n, "gs": gs, "b": 1,
                     "design": design, "max_abs_err": err})
        del wq, ws
    torch.cuda.synchronize()
    for fmt in GQMV_SWEEP["formats"]:
        mine = [r for r in rows if r["kernel"] == f"gqmv_{fmt}"]
        designs = sorted({(r["shape"], r["design"]) for r in mine})
        log(f"[kernels] gqmv_{fmt}: {len(mine)} cases pass (every projection, GS "
            f"{GQMV_SWEEP['group_sizes']}; designs {designs}), max|err| "
            f"{max(r['max_abs_err'] for r in mine):.2e}")
    return rows


def phase_group_sizes(dev) -> list[dict]:
    """Every kernel at every group size on a small shape; the int3 and int4
    kernels on a stacked leaf's layer slices (n = 48 at GS 16: int3's
    18-byte rows and lanes are only 2-byte aligned, int4's 24-byte rows 8-byte
    aligned); and the GQMV of each streamed format on rows the streamed
    design cannot take (n 1056, storage off a 16-byte boundary by
    FIRST_DESIGN_SHIFT), which run the first design. Checked only."""
    gen = torch.Generator(device=dev).manual_seed(5)
    m, n = GS_SWEEP["m"], GS_SWEEP["n"]
    rows = []
    cases = [(fmt, gs, kind, b) for fmt in WEIGHT_FORMATS for gs in GS_SWEEP["group_sizes"]
             for kind, b in [("gqmm", bb) for bb in GS_SWEEP["batches"]] + [("gqmv", 1)]]
    for fmt, gs, kind, b in cases:
        wq, ws = _rand_weights(gen, fmt, m, n, gs, dev)
        xq, xs = _rand_q(gen, (b, n) if kind == "gqmm" else (n,), gs, dev)
        kfn, pfn = _kernel_fns(kind, fmt)
        err = check_close(f"{kind}_{fmt} GS {gs} b={b}", kfn(wq, ws, xq, xs, group_size=gs),
                          pfn(wq, ws, xq, xs, group_size=gs), fmt)
        rows.append({"kernel": f"{kind}_{fmt}", "gs": gs, "m": m, "n": n, "b": b,
                     "max_abs_err": err})
    for fmt in FIRST_DESIGN_SHIFT:
        stacked = quantize(torch.randn((3, 9, 48), generator=gen, device=dev), 16, fmt)
        for kind, b in (("gqmm", 2), ("gqmv", 1)):
            xq, xs = _rand_q(gen, (b, 48) if kind == "gqmm" else (48,), 16, dev)
            kfn, pfn = _kernel_fns(kind, fmt)
            for i in range(3):
                w = stacked[i]
                err = check_close(f"{kind}_{fmt} stacked leaf, layer {i}",
                                  kfn(w.qvalues, w.scales, xq, xs, group_size=16),
                                  pfn(w.qvalues, w.scales, xq, xs, group_size=16), fmt)
                rows.append({"kernel": f"{kind}_{fmt}", "gs": 16, "m": 9, "n": 48, "b": b,
                             "max_abs_err": err, "layer_slice": i})
    # GQMV rows the streamed design cannot take: n 1056 at GS 32 (no multiple
    # of 128) and storage off a 16-byte boundary
    for fmt in GQMV_SWEEP["formats"]:
        shapes = [(1056, 32, 0)] + ([(2048, 64, FIRST_DESIGN_SHIFT[fmt])]
                                    if fmt in FIRST_DESIGN_SHIFT else [])
        for width, gs, shift in shapes:
            wq, ws = _rand_weights(gen, fmt, 60, width, gs, dev)
            if shift:
                moved = torch.empty(wq.numel() + shift, dtype=wq.dtype, device=dev)[shift:]
                wq = moved.view(wq.shape).copy_(wq)
            xq, xs = _rand_q(gen, (width,), gs, dev)
            design = kern.gqmv_design(width, fmt, wq.data_ptr() % 16 == 0)
            if design != "first":
                raise AssertionError(f"gqmv_{fmt} n={width} shift {shift}: expected the first "
                                     "design")
            kfn, pfn = _kernel_fns("gqmv", fmt)
            err = check_close(f"gqmv_{fmt} n={width} GS {gs} shift {shift} ({design})",
                              kfn(wq, ws, xq, xs, group_size=gs),
                              pfn(wq, ws, xq, xs, group_size=gs), fmt)
            rows.append({"kernel": f"gqmv_{fmt}", "gs": gs, "m": 60, "n": width, "b": 1,
                         "max_abs_err": err, "design": design, "shift": shift})
    torch.cuda.synchronize()
    log(f"[kernels] {len(rows)} group-size cases pass (GS {GS_SWEEP['group_sizes']}, "
        f"{m} x {n}, b in {GS_SWEEP['batches']} and GQMV; int3 and int4 on a stacked leaf's "
        "slices; the first GQMV design of int4, int3, fp8 and int8 at n 1056 and, for int3 "
        "and int4, on storage off 16 bytes)")
    return rows


def flash_bytes_ops(q, k, causal: bool) -> tuple[int, int]:
    """The bytes flash attention must move (q, k, v read once, out written
    once) and its operations (q . k and p . v, 2 per multiply-add, over the
    visible pairs: the causal half with the diagonal, or every pair)."""
    bh, s, hd = q.shape
    t = k.shape[1]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    pairs = bh * (s * (s + 1) // 2 if causal and s == t else s * t)
    return nbytes, 4 * hd * pairs


def _sdpa_ms(q4, k4, v4, causal: bool = True) -> tuple[float, float]:
    """(device ms, max |err| against the f32 arithmetic) of
    scaled_dot_product_attention, GQA, causal or not, on (b, H, s, hd)
    tensors."""
    F = torch.nn.functional
    h, kv = q4.shape[1], k4.shape[1]
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, enable_gqa=True)
    ref_out = F.scaled_dot_product_attention(
        q4.float(), k4.float().repeat_interleave(h // kv, 1),
        v4.float().repeat_interleave(h // kv, 1), is_causal=causal)
    err = (out.float() - ref_out).abs().max().item()
    if not err <= 2e-2 * ref_out.abs().max().item():
        raise AssertionError(f"scaled_dot_product_attention disagrees with f32: {err:.3e}")
    ms, _ = device_time_ms(lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, enable_gqa=True), 50)
    return ms, err


def phase_flash_kernels(dev) -> tuple[list[dict], dict]:
    """The flash-attention kernels (B4) against their plain version at every
    case of FLASH_TIMED and FLASH_CHECKED: f32 inputs run the CUDA-core
    kernel, within 1e-5 * max|plain| (another f32 summation order); bf16
    inputs the tensor-core kernel, within 1e-2 * max|plain| of the plain
    arithmetic run in f32 on the same values (it rounds P to bf16 before
    P V, up to 2^-9 relative per weight, and the output once). The timed
    cases are timed beside their plain version and
    scaled_dot_product_attention on the same inputs (the library's causal
    GQA path), with the bound and the kernel's share of it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    rows, sdpa = [], {}
    for hd in fkern.HEAD_DIMS:
        smem, ctas = fkern.f32_layout(hd, dev.index)
        log(f"[flash] flash_attn_f32 hd {hd:3d}: {smem} bytes of shared memory, {ctas} CTAs "
            f"of {fkern.F32_THREADS} threads an SM (K/V tiles of {fkern.f32_keys(hd)} keys, "
            f"{fkern.f32_splits(hd)} d-split(s))")
    for case, dt in itertools.product(FLASH_TIMED + FLASH_CHECKED, FLASH_DTYPES):
        name, b, h, kv, s, t, hd, causal, window, cap = case
        q = torch.randn((b * h, s, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b * kv, t, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b * kv, t, hd), generator=gen, device=dev).to(dt)
        kw = dict(group=h // kv, scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
        got = fkern.flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = FLASH_TOL[dt] * want.abs().max().item()
        row = {"kernel": fkern.kernel_name(dt), "case": name, "dtype": str(dt).split(".")[-1],
               "b": b,
               "heads": h, "kv_heads": kv, "s": s, "t": t, "hd": hd, "causal": causal,
               "window": window, "softcap": cap, "max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"flash_attn: kernel disagrees with its plain version: {row}")
        if case in FLASH_TIMED:
            k_ms, k_host = device_time_ms(lambda i: fkern.flash_attention_cuda(q, k, v, **kw), 20)
            p_ms = profile_device(lambda: flash_attention_ref(q, k, v, **kw), 3)["device_ms"]
            nbytes, nops = flash_bytes_ops(q, k, causal)
            bnd, by = bound_s(nbytes, nops, BF16_OPS_PER_S if dt == torch.bfloat16
                              else F32_OPS_PER_S)
            row.update({"us": 1e3 * k_ms, "host_us": 1e3 * k_host, "plain_us": 1e3 * p_ms,
                        "bound_us": 1e6 * bnd, "bound_by": by, "bound_share": 1e3 * bnd / k_ms})
            q4 = q.reshape(b, h, s, hd)
            sd_ms, sd_err = _sdpa_ms(q4, k.reshape(b, kv, t, hd), v.reshape(b, kv, t, hd))
            row["library_us"] = 1e3 * sd_ms
            sdpa[f"{name} {row['dtype']}"] = {"ms": sd_ms, "max_abs_err_vs_f32": sd_err, "b": b,
                                              "s": s, "heads": h, "kv_heads": kv, "hd": hd}
        rows.append(row)
        log(f"[flash] {row['kernel']:14s} {row['dtype']:8s} {name:14s} b*H={b * h:3d} s={s:4d} "
            f"t={t:4d} hd={hd:3d} causal={causal} window={window} cap={cap}  max|err| "
            f"{err:.2e} (tol {tol:.1e})"
            + (f"  {row['us']:9.2f} us  plain {row['plain_us']:9.1f} us  bound "
               f"{row['bound_us']:7.2f} us ({row['bound_by']}, {100 * row['bound_share']:.1f} % "
               f"of it)  sdpa {row['library_us']:7.2f} us ({row['us'] / row['library_us']:.2f}x)"
               f" [{CARD['smi']}]" if "us" in row else ""))
        del q, k, v, got, want
    return rows, sdpa


# A fused RMSNorm + quantize value may round to the other side of a .5 tie
# from the plain version's: the kernel sums the squares in another order, so
# inv differs, and although inv cancels from x / S, the roundings of
# x * inv * w, of the group's absmax * inv * w * 2/255 and of the quotient do
# not (about a dozen f32 roundings, 2^-24 each, relative to |x / S|). A flip
# is allowed where the plain x / S lies within RMSQ_TIE of a .5 boundary:
# 1e-5, or 1e-6 * |x / S| where that is larger.
RMSQ_TIE = (1e-5, 1e-6)


def rmsq_ties(x, w, gs, q, qp, sp) -> tuple[int, bool, float]:
    """(values that differ, whether every one is a tie flip, the largest
    distance of a flipped plain x / S from its .5 boundary)."""
    diff = q.to(torch.int32) - qp.to(torch.int32)
    flips = int((diff != 0).sum())
    if not flips:
        return 0, True, 0.0
    normed = rmsnorm(x.float(), w)
    ratio = (normed.reshape(*sp.shape, gs) / torch.where(sp > 0, sp, 1.0)[..., None])
    ratio = ratio.reshape(q.shape)
    dist = (ratio - ratio.floor() - 0.5).abs()
    near = dist <= torch.clamp(RMSQ_TIE[1] * ratio.abs(), min=RMSQ_TIE[0])
    ok = diff.abs().max().item() <= 1 and bool(near[diff != 0].all())
    return flips, ok, dist[diff != 0].max().item()


def _rmsq_check(name, x, w, gs, got) -> dict:
    """The fused kernel's (int8, scales) against the plain version: scales
    within rtol 1e-5; int8 values equal except by 1 at a .5 tie (RMSQ_TIE)."""
    qp, sp = rmsnorm_quant_ref(x, w, group_size=gs)
    q, sc = got
    if not bool(torch.allclose(sc, sp, rtol=1e-5, atol=0)):
        raise AssertionError(f"rmsnorm_quant {name}: scales differ by "
                             f"{(sc - sp).abs().max().item():.3e}")
    flips, ok, far = rmsq_ties(x, w, gs, q, qp, sp)
    if not ok:
        raise AssertionError(f"rmsnorm_quant {name}: {flips} int8 values differ, not all at "
                             f"a .5 tie (farthest {far:.3e} from one)")
    return {"max_scale_rel_err": ((sc - sp).abs() / sp.clamp(min=1e-30)).max().item(),
            "max_scale_abs_err": (sc - sp).abs().max().item(),
            "tie_flips": flips, "farthest_tie": far, "elements": q.numel()}


def _off16(t: torch.Tensor) -> torch.Tensor:
    """A copy of t whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def phase_rmsnorm_kernels(dev) -> list[dict]:
    """The fused RMSNorm + quantize kernel (B2) against its plain version at
    TinyLlama's rows (GS 256; timed) and at every group size on a small
    shape, bf16 and f32 input, each with a row holding a group of zeros, on
    the design rkern.design names (the row design). The timed rows also run
    the first design, on x one element off 16 bytes (checked and timed: the
    time before the row design), and an empty kernel launched with the row
    design's grid (the card's floor for such a launch)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    gs0 = load_config(ARCH).group_size
    cases = ([(m, n, gs0, True) for m, n in RMSQ_TIMED]
             + [(RMSQ_SWEEP["m"], RMSQ_SWEEP["n"], g, False) for g in RMSQ_SWEEP["group_sizes"]])
    rows = []
    for (m, n, gs, timed), dt in itertools.product(cases, RMSQ_DTYPES):
        x = (torch.randn((m, n), generator=gen, device=dev) * 3).to(dt)
        x[0, :gs] = 0
        w = (1 + 0.1 * torch.randn((n,), generator=gen, device=dev)).to(dt)
        got = rkern.rmsnorm_quant_cuda(x, w, group_size=gs)
        torch.cuda.synchronize()
        if got[0][0, :gs].any() or got[1][0, 0] != 0:
            raise AssertionError("rmsnorm_quant: a group of zeros did not stay zero")
        row = {"kernel": "rmsnorm_quant", "m": m, "n": n, "gs": gs,
               "dtype": str(dt).split(".")[-1], "design": rkern.design(n, gs),
               **_rmsq_check(f"({m}, {n}) GS {gs} {dt}", x, w, gs, got)}
        if timed:
            k_ms, k_host = device_time_ms(lambda i: rkern.rmsnorm_quant_cuda(x, w, group_size=gs),
                                          100)
            p_ms = profile_device(lambda: rmsnorm_quant_ref(x, w, group_size=gs), 3)["device_ms"]
            nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() + m * n + \
                4 * m * n // gs
            bnd, by = bound_s(nbytes, 8 * m * n, F32_OPS_PER_S)
            ctas = rkern.plan(m, n)[2]
            e_ms, _ = device_time_ms(lambda i: rkern.empty_cuda(ctas, dev), 100)
            xo = _off16(x)
            if rkern.design(n, gs, xo.data_ptr() % 16 == 0) != "first":
                raise AssertionError("rmsnorm_quant: rows off 16 bytes must run the first design")
            first = _rmsq_check(f"({m}, {n}) GS {gs} {dt} first design", x, w, gs,
                                rkern.rmsnorm_quant_cuda(xo, w, group_size=gs))
            f_ms, _ = device_time_ms(lambda i: rkern.rmsnorm_quant_cuda(xo, w, group_size=gs),
                                     100)
            row.update({"us": 1e3 * k_ms, "host_us": 1e3 * k_host, "plain_us": 1e3 * p_ms,
                        "bound_us": 1e6 * bnd, "bound_by": by, "empty_us": 1e3 * e_ms,
                        "empty_ctas": ctas, "first_us": 1e3 * f_ms,
                        "first_tie_flips": first["tie_flips"]})
            log(f"[rmsnorm_quant] {row['dtype']:8s} ({m:3d}, {n:4d}) GS {gs}  scales rel err "
                f"{row['max_scale_rel_err']:.1e}, {row['tie_flips']} tie flips of {m * n} "
                f"(farthest {row['farthest_tie']:.1e})  "
                f"{row['us']:7.2f} us (host {row['host_us']:5.1f})  plain {row['plain_us']:7.1f} "
                f"us  bound {row['bound_us']:5.3f} us ({by})  empty kernel ({ctas} CTAs) "
                f"{row['empty_us']:5.2f} us  first design {row['first_us']:6.2f} us "
                f"({row['first_tie_flips']} tie flips) [{CARD['smi']}]")
        rows.append(row)
    log(f"[rmsnorm_quant] {len(rows)} cases pass (GS {RMSQ_SWEEP['group_sizes']} at "
        f"({RMSQ_SWEEP['m']}, {RMSQ_SWEEP['n']}); bf16 and f32 input; zero groups; designs "
        f"{sorted({r['design'] for r in rows})})")
    return rows


def _paged_pools(gen, dev, pool: str, qdt, nb: int, bs: int, kv: int = PAGED["kv"],
                 hd: int = PAGED["hd"]):
    """Random K and V pools (NB, BS, KV, hd) of one pool type, finite
    everywhere (fp8 values stay inside e4m3's range), and the f32 row
    scales (NB, BS, KV) of a quantized pool."""
    shape = (nb, bs, kv, hd)
    if pool == "float":
        return (torch.randn(shape, generator=gen, device=dev).to(qdt),
                torch.randn(shape, generator=gen, device=dev).to(qdt), None, None)
    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=gen, device=dev)
        if pool == "int8":
            out.append((x * 40).round().clamp(-127, 127).to(torch.int8))
        else:
            out.append((x * 100).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn))
    scales = [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 1e-3 for _ in range(2)]
    return out[0], out[1], scales[0], scales[1]


def paged_call_bytes_ops(q, k_pages, pos, mask, table, quant: bool) -> tuple[int, int]:
    """The bytes a paged decode-attention call must move and the operations
    it must do, for these inputs: the committed rows t < pos[i] of each row
    (the current token comes from k_new / v_new), K and V and their scales,
    plus q, k_new, v_new, mask, table and pos read once and ctx written once;
    q . k and p . v at 2 operations per multiply-add."""
    b, kv, g, hd = q.shape
    rows = int(pos.sum())
    nbytes = rows * kv * hd * k_pages.element_size() * 2 + (rows * kv * 4 * 2 if quant else 0)
    nbytes += 2 * q.numel() * q.element_size() + 2 * b * kv * hd * q.element_size()
    nbytes += 4 * (mask.numel() + table.numel() + pos.numel())
    return nbytes, 4 * g * hd * kv * (rows + b)


def _paged_variants(b: int, T: int, kv: int, hd: int, elt: int) -> int:
    """Tables over distinct blocks that a timed paged run cycles through:
    enough that the run reads more than the 50 MB L2 holds."""
    return max(1, min(1000, math.ceil(160e6 / (b * (T // 2) * kv * hd * elt * 2))))


def _time_paged(row, q, kp, vp, tables, pos, kn, vn, mask, kw, quant: bool) -> None:
    """Adds to ``row`` the kernel's device time over ``tables`` (variants,
    b, MB), its plain version's, the bound and the kernel's share of it."""
    variants = tables.shape[0]
    pos32 = pos.to(torch.int32)
    # a call launches up to two kernels (the split pass and the combine)
    # and the launch queue holds about a thousand, so at most 400 calls wait
    # behind the GPU spin
    k_ms, k_host = device_time_ms(
        lambda i: pkern.paged_attention_cuda(q, kp, vp, tables[i % variants], pos32, kn, vn,
                                             mask, **kw),
        min(400, max(50, variants)))
    # the plain version's enqueue outlasts every GPU spin (some step of it
    # waits for the card): its device time comes from the profiler instead
    turn = itertools.count()
    p_ms = profile_device(lambda: paged_attention_ref(
        q, kp, vp, tables[next(turn) % variants], pos, kn, vn, mask, **kw), 3)["device_ms"]
    nbytes, nops = paged_call_bytes_ops(q, kp, pos, mask, tables[0], quant)
    bnd, by = bound_s(nbytes, nops, F32_OPS_PER_S)
    row.update({"us": 1e3 * k_ms, "host_us": 1e3 * k_host, "plain_us": 1e3 * p_ms,
                "bound_us": 1e6 * bnd, "bound_by": by, "bytes": nbytes,
                "variants": variants, "bound_share": 1e3 * bnd / k_ms})


def phase_paged_kernels(dev) -> list[dict]:
    """The paged decode-attention kernel against its plain version at every
    pool type and shape of ``PAGED`` (the split plan S of each shape shown);
    timed where softcap is None, with the bound and the kernel's share of
    it."""
    gen = torch.Generator(device=dev).manual_seed(3)
    kv, g, hd = PAGED["kv"], PAGED["g"], PAGED["hd"]
    rows = []
    for qdt, pool, b, bs, T in itertools.product(
            PAGED["qdtypes"], PAGED["pools"], PAGED["batches"], PAGED["block_sizes"],
            PAGED["widths"]):
        quant = pool != "float"
        kname = "paged_attn_quant" if quant else "paged_attn"
        mb = T // bs
        variants = _paged_variants(b, T, kv, hd, qdt.itemsize if pool == "float" else 1)
        nb = variants * b * mb + 1                                  # block 0: the sink
        kp, vp, ks, vs = _paged_pools(gen, dev, pool, qdt, nb, bs)
        pos = torch.randint(0, T, (b,), generator=gen, device=dev)
        tables = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).reshape(variants, b, mb)
        # entries past each row's position point at the sink
        past = torch.arange(mb, device=dev)[None, :] > (pos // bs)[:, None]
        tables = torch.where(past[None], 0, tables).to(torch.int32)
        pos32 = pos.to(torch.int32)
        q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(qdt)
        kn = torch.randn((b, kv, hd), generator=gen, device=dev).to(qdt)
        vn = torch.randn((b, kv, hd), generator=gen, device=dev).to(qdt)
        mask = decode_mask(T, pos)
        # the plain arithmetic in f32 on the same values
        q32, kn32, vn32 = q.float(), kn.float(), vn.float()
        kp32, vp32 = (kp.float(), vp.float()) if pool == "float" else (kp, vp)
        for softcap in PAGED["softcaps"]:
            kw = dict(scale=hd ** -0.5, softcap=softcap, k_scales=ks, v_scales=vs)
            got = pkern.paged_attention_cuda(q, kp, vp, tables[0], pos32, kn, vn, mask, **kw)
            want = paged_attention_ref(q32, kp32, vp32, tables[0], pos, kn32, vn32, mask, **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(want).all()):
                raise AssertionError("the paged plain version is not finite")
            err = (got.float() - want).abs().max().item()
            tol = PAGED_TOL[qdt] * want.abs().max().item()
            row = {"kernel": kname, "qdtype": str(qdt).split(".")[-1], "pool": pool, "b": b,
                   "bs": bs, "T": T, "softcap": softcap, "max_abs_err": err, "tol": tol,
                   "splits": pkern.split_plan(b, kv, mb, bs)[0]}
            if qdt == torch.bfloat16:
                same = paged_attention_ref(q, kp, vp, tables[0], pos, kn, vn, mask, **kw)
                row["err_vs_plain_bf16"] = (got.float() - same.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{kname}: kernel disagrees with its plain version: {row}")
            if softcap is None:
                _time_paged(row, q, kp, vp, tables, pos, kn, vn, mask, kw, quant)
            rows.append(row)
            log(f"[paged] {row['qdtype']:8s} {pool:5s} b={b:2d} BS={bs:2d} T={T:4d} "
                f"S={row['splits']:2d} cap={softcap}  max|err| {err:.2e} (tol {tol:.1e})"
                + (f"  {row['us']:7.2f} us  plain {row['plain_us']:8.1f} us  bound "
                   f"{row['bound_us']:5.2f} us ({row['bound_by']}, "
                   f"{100 * row['bound_share']:.1f} % of it) [{CARD['smi']}]" if "us" in row
                   else ""))
        del kp, vp, ks, vs, tables, kp32, vp32
    return rows


def phase_paged_hd256(dev) -> list[dict]:
    """The paged kernel at hd 256 (PAGED_HD256), every pool type, against
    its plain version with the tolerance of phase 2's other paged cases;
    timed as phase 2's other paged cases are (tables over distinct blocks
    that together exceed the L2), with the bound and its share."""
    gen = torch.Generator(device=dev).manual_seed(4)
    c = PAGED_HD256
    kv, g, hd, b, bs = c["kv"], c["g"], c["hd"], c["b"], c["bs"]
    rows = []
    for (pool, qdt), T in itertools.product(c["cases"], c["widths"]):
        mb = T // bs
        variants = _paged_variants(b, T, kv, hd, qdt.itemsize if pool == "float" else 1)
        nb = variants * b * mb + 1                                  # block 0: the sink
        kp, vp, ks, vs = _paged_pools(gen, dev, pool, qdt, nb, bs, kv, hd)
        pos = torch.randint(0, T, (b,), generator=gen, device=dev)
        tables = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).reshape(variants, b, mb)
        past = torch.arange(mb, device=dev)[None] > (pos // bs)[:, None]
        tables = torch.where(past[None], 0, tables).to(torch.int32)
        table = tables[0]
        q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(qdt)
        kn, vn = (torch.randn((b, kv, hd), generator=gen, device=dev).to(qdt) for _ in range(2))
        mask = decode_mask(T, pos)
        kw = dict(scale=hd ** -0.5, k_scales=ks, v_scales=vs)
        got = pkern.paged_attention_cuda(q, kp, vp, table, pos, kn, vn, mask, **kw)
        up = [t.float() if pool == "float" or t.dtype == torch.bfloat16 else t
              for t in (q, kp, vp)]
        want = paged_attention_ref(up[0], up[1], up[2], table, pos, kn.float(), vn.float(),
                                   mask, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = PAGED_TOL[qdt] * want.abs().max().item()
        cols = pkern.tile_cols(hd, kp.element_size())
        kname = "paged_attn_quant" if ks is not None else "paged_attn"
        row = {"kernel": kname, "pool": pool,
               "qdtype": str(qdt).split(".")[-1], "b": b, "g": g, "hd": hd, "bs": bs, "T": T,
               "tile_cols": cols, "splits": pkern.split_plan(b, kv, mb, bs, cols)[0],
               "max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"paged attention at hd 256 disagrees with its plain version: "
                                 f"{row}")
        _time_paged(row, q, kp, vp, tables, pos, kn, vn, mask, kw, ks is not None)
        rows.append(row)
        log(f"[paged] hd 256 G 2 {row['qdtype']:8s} {pool:5s} b={b} BS={bs} T={T:4d} "
            f"tile {cols} S={row['splits']:2d}  max|err| {err:.2e} (tol {tol:.1e})  "
            f"{row['us']:7.2f} us  plain {row['plain_us']:8.1f} us  bound {row['bound_us']:5.2f} "
            f"us ({row['bound_by']}, {100 * row['bound_share']:.1f} % of it) [{CARD['smi']}]")
        del kp, vp, ks, vs, tables
    return rows


# ---------------------------------------------------------------------------
# phase 2 at the families' shapes
# ---------------------------------------------------------------------------

def family_projections() -> list[tuple[str, int, int, int]]:
    """(name, m, n, GS) of every quantized weight matrix of each family
    config (``bounds.layer_projections``: GQA's or MLA's attention, the
    dense FFN or one expert's and the shared expert's), at the weight
    policy's group size for its n, the classifier (vocab_padded rows;
    gemma2's is its tied embedding) included."""
    out = []
    for arch in FAMILIES:
        cfg = load_config(arch)
        for name, m, n, _ in bounds.layer_projections(cfg):
            out.append((f"{arch} {name}", m, n, bounds.group_size(cfg, n)))
        out.append((f"{arch} classifier", cfg.vocab_padded, cfg.d_model,
                    bounds.group_size(cfg, cfg.d_model)))
    return out


def _format_rows(gen, dev, name: str, m: int, n: int, pgs: int, formats, batches,
                 gqmv: bool) -> list[dict]:
    """GQMM of each of ``formats`` at each b of ``batches`` (and, with
    ``gqmv``, GQMV) on random (m, n) weights at GS ``pgs``, each against its
    plain version with phase 2's tolerance; checked, not timed."""
    rows = []
    for fmt in formats:
        wq, ws = _rand_weights(gen, fmt, m, n, pgs, dev)
        for kind, b in [("gqmm", bb) for bb in batches] + [("gqmv", 1)] * gqmv:
            kfn, pfn = _kernel_fns(kind, fmt)
            xq, xs = _rand_q(gen, (b, n) if kind == "gqmm" else (n,), pgs, dev)
            err = check_close(f"{kind}_{fmt} {name} b={b}",
                              kfn(wq, ws, xq, xs, group_size=pgs),
                              pfn(wq, ws, xq, xs, group_size=pgs), fmt)
            rows.append({"kernel": f"{kind}_{fmt}", "shape": name, "m": m, "n": n,
                         "b": b, "gs": pgs, "groups": n // pgs, "max_abs_err": err,
                         "design": ("%s/%d" % kern.gqmm_design(b, m, n, pgs, fmt)
                                    if kind == "gqmm" else
                                    kern.gqmv_design(n, fmt, wq.data_ptr() % 16 == 0))})
        del wq, ws
    return rows


def _int8_rows(gen, dev, name: str, m: int, n: int, pgs: int, batches, timed,
               tag: str) -> list[dict]:
    """The int8 GQMM at each b of ``batches`` and the int8 GQMV on random
    (m, n) weights at GS ``pgs``, against their plain versions; the GQMV and
    the GQMM at the b in ``timed`` timed as phase 2's rows are (weight
    copies past the L2, behind a GPU spin), each beside its bound from
    kernels/bounds.py and its plain version's time."""
    rows = []
    wq, ws = _rand_weights(gen, "int8", m, n, pgs, dev)
    copies = max(1, math.ceil(160e6 / (wq.numel() + 4 * ws.numel())))
    pool = [(wq, ws)] + [(wq.clone(), ws.clone()) for _ in range(copies - 1)]
    for kind, b in [("gqmm", bb) for bb in batches] + [("gqmv", 1)]:
        kfn, pfn = _kernel_fns(kind, "int8")
        xq, xs = _rand_q(gen, (b, n) if kind == "gqmm" else (n,), pgs, dev)
        got = kfn(wq, ws, xq, xs, group_size=pgs)
        err = check_close(f"{kind}_int8 {name} b={b}", got,
                          pfn(wq, ws, xq, xs, group_size=pgs))
        if kind == "gqmm" and b not in timed:
            rows.append({"kernel": "gqmm_int8", "shape": name, "m": m, "n": n, "b": b,
                         "gs": pgs, "groups": n // pgs, "max_abs_err": err,
                         "design": "%s/%d" % kern.gqmm_design(b, m, n, pgs)})
            continue
        k_ms, _ = device_time_ms(lambda i: kfn(*pool[i % copies], xq, xs, group_size=pgs),
                                 max(50, 2 * copies))
        p_ms, _ = device_time_ms(lambda i: pfn(*pool[i % copies], xq, xs, group_size=pgs), 3,
                                 host_ms_guess=2.0)
        bnd = bounds.projection("int8", m, n, b, pgs)
        row = {"kernel": f"{kind}_int8", "shape": name, "m": m, "n": n, "b": b, "gs": pgs,
               "groups": n // pgs, "max_abs_err": err, "us": 1e3 * k_ms,
               "plain_us": 1e3 * p_ms, "bound_us": 1e6 * bnd.seconds,
               "bound_by": bnd.bound_by,
               "design": ("%s/%d" % kern.gqmm_design(b, m, n, pgs) if kind == "gqmm"
                          else kern.gqmv_design(n, "int8", True))}
        rows.append(row)
        log(f"[{tag}] {kind}_int8 {name:30s} m={m:6d} n={n:5d} b={b:3d} "
            f"({n // pgs} groups of {pgs})  max|err| {err:.2e}  {row['us']:9.1f} us  plain "
            f"{row['plain_us']:9.1f} us  bound {row['bound_us']:7.1f} us ({bnd.bound_by}, "
            f"{100 * row['bound_us'] / row['us']:.1f} % of it)  design {row['design']} "
            f"[{CARD['smi']}]")
    del pool
    return rows


def phase_family_kernels(dev) -> list[dict]:
    """The int8 GQMM (b in FAMILY_KERNEL_BATCHES) and the int8 GQMV at every
    projection of the families, against their plain versions, timed as
    phase 2's TinyLlama rows are, each beside its bound from
    kernels/bounds.py; the MoE and MLA families' projections (m 288, 1 to
    42 groups, GS 128) in int4, int3 and fp8 too, checked only; then every
    format's GQMM (both designs at b 8-17) and streamed GQMV at rows of 9
    and 75 groups, checked only."""
    gen = torch.Generator(device=dev).manual_seed(12)
    gs = 256
    rows = []
    checked = 0
    for name, m, n, pgs in family_projections():
        if name.split()[0] in FAMILY_ALL_FORMATS:
            fr = _format_rows(gen, dev, name, m, n, pgs, WEIGHT_FORMATS[1:],
                              FAMILY_KERNEL_BATCHES, gqmv=True)
            rows += fr
            checked += len(fr)
        rows += _int8_rows(gen, dev, name, m, n, pgs, FAMILY_KERNEL_BATCHES,
                           FAMILY_TIMED_BATCHES.get(name.split()[0], FAMILY_KERNEL_BATCHES),
                           "families kernels")
    log(f"[families kernels] int4, int3 and fp8 at the projections of {FAMILY_ALL_FORMATS}: "
        f"{checked} cases (GQMM at b {FAMILY_KERNEL_BATCHES}, GQMV) within phase 2's tolerances")
    # odd group counts: every format, both GQMM designs where b allows, and
    # the streamed GQMV
    checked = 0
    for fmt, n in itertools.product(WEIGHT_FORMATS, ODD_GROUPS["widths"]):
        m = ODD_GROUPS["m"]
        wq, ws = _rand_weights(gen, fmt, m, n, gs, dev)
        kfn, pfn = _kernel_fns("gqmm", fmt)
        for b in ODD_GROUPS["batches"]:
            xq, xs = _rand_q(gen, (b, n), gs, dev)
            want = pfn(wq, ws, xq, xs, group_size=gs)
            designs = (("small", 10 ** 6), ("large", 0)) if 8 <= b <= 17 else (("auto", None),)
            for design, cut in designs:
                prev = kern.set_small_max_b(cut) if cut is not None else None
                try:
                    err = check_close(f"gqmm_{fmt} m={m} n={n} b={b} {design}",
                                      kfn(wq, ws, xq, xs, group_size=gs), want, fmt)
                finally:
                    if cut is not None:
                        kern.set_small_max_b(prev)
                rows.append({"kernel": f"gqmm_{fmt}", "shape": f"odd groups n={n}", "m": m,
                             "n": n, "b": b, "groups": n // gs, "max_abs_err": err,
                             "design": design if cut is not None
                             else "%s/%d" % kern.gqmm_design(b, m, n, gs, fmt)})
                checked += 1
        vfn, vpfn = _kernel_fns("gqmv", fmt)
        xq, xs = _rand_q(gen, (n,), gs, dev)
        err = check_close(f"gqmv_{fmt} m={m} n={n}", vfn(wq, ws, xq, xs, group_size=gs),
                          vpfn(wq, ws, xq, xs, group_size=gs), fmt)
        design = kern.gqmv_design(n, fmt, wq.data_ptr() % 16 == 0)
        if fmt in kern.STREAM_CHUNK_BYTES and design != "stream":
            raise AssertionError(f"gqmv_{fmt} n={n}: expected the streamed design, got {design}")
        rows.append({"kernel": f"gqmv_{fmt}", "shape": f"odd groups n={n}", "m": m, "n": n,
                     "b": 1, "groups": n // gs, "max_abs_err": err, "design": design})
        checked += 1
    log(f"[families kernels] {checked} odd-group cases pass (formats {WEIGHT_FORMATS}, "
        f"n {ODD_GROUPS['widths']} = {[n // gs for n in ODD_GROUPS['widths']]} groups, b "
        f"{ODD_GROUPS['batches']}, both GQMM designs at b 8-17, the streamed GQMV); the small "
        f"design at n 19200 takes b <= {max(b for b in range(1, 17) if kern.gqmm_design(b, 4096, 19200, gs)[0] == 'small')}")
    return rows


def _visible_pairs(s: int, window: int | None) -> int:
    """Causal (query, key) pairs of an s-token prompt, inside ``window``."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _flash_row(gen, dev, case: tuple, tag: str, causal: bool = True) -> dict:
    """Flash attention (bf16, the tensor-core kernel) of one (name, b, H,
    KV, s, hd, window, cap) case, causal or not, against its plain version
    with phase 2's tolerance, timed, with the bound from the work this data
    needs (the window's pairs only; every pair when not causal) and,
    without a window or cap, scaled_dot_product_attention on the same
    inputs."""
    name, b, h, kv, s, hd, window, cap = case
    dt = torch.bfloat16
    q = torch.randn((b * h, s, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b * kv, s, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b * kv, s, hd), generator=gen, device=dev).to(dt)
    kw = dict(group=h // kv, scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
    err, tol = check_flash(f"flash_attn {name}", fkern.flash_attention_cuda(q, k, v, **kw),
                           q, k, v, **kw)
    k_ms, _ = device_time_ms(lambda i: fkern.flash_attention_cuda(q, k, v, **kw), 20)
    p_ms = profile_device(lambda: flash_attention_ref(q, k, v, **kw), 2)["device_ms"]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    pairs = _visible_pairs(s, window) if causal else s * s
    bnd, by = bound_s(nbytes, 4 * hd * b * h * pairs, BF16_OPS_PER_S)
    row = {"kernel": "flash_attn", "case": name, "dtype": "bfloat16", "b": b, "heads": h,
           "kv_heads": kv, "s": s, "hd": hd, "window": window, "softcap": cap, "causal": causal,
           "max_abs_err": err, "tol": tol, "us": 1e3 * k_ms, "plain_us": 1e3 * p_ms,
           "bound_us": 1e6 * bnd, "bound_by": by, "library_us": None}
    if window is None and cap is None:
        row["library_us"] = 1e3 * _sdpa_ms(q.reshape(b, h, s, hd), k.reshape(b, kv, s, hd),
                                           v.reshape(b, kv, s, hd), causal)[0]
    log(f"[{tag}] {name:26s} H {h}/{kv} hd {hd} max|err| {err:.2e} (tol "
        f"{tol:.1e})  {row['us']:9.2f} us  plain {row['plain_us']:9.1f} us  bound "
        f"{row['bound_us']:7.2f} us ({by}, {100 * row['bound_us'] / row['us']:.1f} % of it)"
        + (f"  sdpa {row['library_us']:7.2f} us" if row["library_us"] else
           "  (no library call takes the window and cap)") + f" [{CARD['smi']}]")
    return row


def phase_family_attention(dev) -> tuple[list[dict], list[dict]]:
    """Flash attention (bf16, the tensor-core kernel) and paged attention
    (bf16 and int8 pools) at each family's attention shape, gemma2's with
    its 4096-token window and soft cap 50 over a 4608-token prompt (the
    window masks keys): against the plain versions with phase 2's
    tolerances, timed, with the bound from the work this data needs (the
    window's pairs and rows only) and, for flash without a window or cap,
    scaled_dot_product_attention on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(13)
    frows, prows = [], []
    dt = torch.bfloat16
    for case in FAMILY_FLASH:
        frows.append(_flash_row(gen, dev, case, "families flash"))
    bs, b = 8, FAMILY_PAGED_B
    for (name, kv, g, hd, T, window, cap), pool in itertools.product(FAMILY_PAGED,
                                                                     ("float", "int8")):
        mb = T // bs
        variants = _paged_variants(b, T, kv, hd, 2 if pool == "float" else 1)
        nb = variants * b * mb + 1
        kp, vp, ks, vs = _paged_pools(gen, dev, pool, dt, nb, bs, kv, hd)
        lo = 0 if window is None else window
        pos = torch.randint(lo, T, (b,), generator=gen, device=dev)
        tables = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).reshape(variants, b, mb)
        past = torch.arange(mb, device=dev)[None] > (pos // bs)[:, None]
        tables = torch.where(past[None], 0, tables).to(torch.int32)
        q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(dt)
        kn, vn = (torch.randn((b, kv, hd), generator=gen, device=dev).to(dt) for _ in range(2))
        mask = decode_mask(T, pos, window)
        kw = dict(scale=hd ** -0.5, softcap=cap, k_scales=ks, v_scales=vs)
        got = pkern.paged_attention_cuda(q, kp, vp, tables[0], pos.to(torch.int32), kn, vn,
                                         mask, **kw)
        up = [t.float() if t.dtype == torch.bfloat16 else t for t in (q, kp, vp)]
        want = paged_attention_ref(up[0], up[1], up[2], tables[0], pos, kn.float(), vn.float(),
                                   mask, **kw)
        err = (got.float() - want).abs().max().item()
        tol = PAGED_TOL[dt] * want.abs().max().item()
        quant = pool != "float"
        kname = "paged_attn_quant" if quant else "paged_attn"
        row = {"kernel": kname, "case": name, "pool": pool, "qdtype": "bfloat16", "b": b,
               "kv": kv, "g": g, "hd": hd, "bs": bs, "T": T, "window": window, "softcap": cap,
               "splits": pkern.split_plan(b, kv, mb, bs, pkern.tile_cols(hd, kp.element_size()))[0],
               "max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"{kname} {name}: kernel disagrees with its plain version: {row}")
        _time_paged(row, q, kp, vp, tables, pos, kn, vn, mask, kw, quant)
        if window is not None:
            # the work this data needs: the rows inside the window only
            visible = int(((mask > NEG_INF / 2) & (torch.arange(T, device=dev)[None]
                                                   < pos[:, None])).sum())
            nbytes = row["bytes"] - (int(pos.sum()) - visible) * kv * hd * kp.element_size() * 2
            bnd, by = bound_s(nbytes, 4 * g * hd * kv * (visible + b), F32_OPS_PER_S)
            row.update({"bound_us": 1e6 * bnd, "bound_by": by, "bytes": nbytes,
                        "bound_share": 1e6 * bnd / row["us"],
                        "visible_rows": visible})
        prows.append(row)
        log(f"[families paged] {name:20s} {pool:5s} b={b} KV {kv} G {g} hd {hd} T={T} "
            f"S={row['splits']}  max|err| {err:.2e} (tol {tol:.1e})  {row['us']:7.2f} us  plain "
            f"{row['plain_us']:8.1f} us  bound {row['bound_us']:5.2f} us ({row['bound_by']}) "
            f"[{CARD['smi']}]")
        del kp, vp, ks, vs, tables
    return frows, prows


# ---------------------------------------------------------------------------
# phase 3: full-width serving, kernels against plain, and the matvec path
# ---------------------------------------------------------------------------

def model_projections(params) -> list[QuantizedTensor]:
    """The 89 quantized projections of one forward pass, in call order."""
    lay = params["layers"]
    out = []
    for i in range(lay["attn"]["wqkv"].qvalues.shape[0]):
        out += [lay["attn"]["wqkv"][i], lay["attn"]["wo"][i],
                lay["mlp"]["w13"][i], lay["mlp"]["w2"][i]]
    return out + [params["classifier"]]


def step_timing(projs, b: int, dev, rows) -> dict:
    """One forward pass's 89 projections back to back at batch b (b=1 as
    1-D GQMV) on the model's own weights, each through its format's kernel:
    the kernels' device time, and the pass's bound (all bytes over the
    memory rate against every call's operations over its peak rate). The
    plain versions' time is the sum of their per-shape device times from
    phase 2 (a back-to-back pass of them queues more launches than the
    GPU-spin timing can hold)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    kind = "gqmm" if b > 1 else "gqmv"
    acts, nbytes, op_s = [], 0, 0.0
    for w in projs:
        m, n = w.shape
        x = torch.randn((b, n) if b > 1 else (n,), generator=gen, device=dev)
        xq = quantize_activation(x, w.group_size)
        acts.append((w, xq, _kernel_fns(kind, w.fmt)[0]))
        nbytes += call_bytes(w.qvalues, w.scales, xq.qvalues, xq.scales, b * m)
        op_s += 2 * b * m * n / OPS_PER_S[w.fmt]

    def step(_):
        for w, xq, kfn in acts:
            kfn(w.qvalues, w.scales, xq.qvalues, xq.scales, group_size=w.group_size)

    k_ms, k_host = device_time_ms(step, 4, host_ms_guess=4.0)
    plain_us = {(r["fmt"], r["m"], r["n"]): r["plain_us"] for r in rows
                if r["kernel"].startswith(kind) and r["b"] == b}
    p_ms = sum(plain_us[(w.fmt, *w.shape)] for w in projs) / 1e3
    tb = nbytes / HBM_BYTES_PER_S
    bnd, by = (tb, "bytes") if tb >= op_s else (op_s, "operations")
    return {"ms": k_ms, "host_ms": k_host, "plain_ms": p_ms, "bound_ms": 1e3 * bnd,
            "bound_by": by}


def launches_per_pass(cfg, quantize, path: str = "decode") -> dict[str, int]:
    """GQMM launches of one forward pass by kernel, from the weight policy:
    the attention projections take the attn class's format, the FFN's the
    ffn class's, the classifier its own (every GS here packs every format).
    A layer's attention runs wqkv and wo, or MLA's query projection(s),
    wdkv and wo, and in a prefill (``path``) also wukv, which decode
    dequantizes instead; its FFN w13 and w2, or with a MoE both for every
    expert and the shared expert."""
    fmap = resolve_format_map(cfg.quant_format if quantize is True else quantize)
    attn, ffn = 2, 2
    if cfg.mla:
        attn = (4 if cfg.mla.q_lora_rank else 3) + (path == "prefill")
    if cfg.moe:
        ffn = 2 * cfg.moe.num_experts + 2 * bool(cfg.moe.num_shared)
    attn_n, ffn_n = attn * cfg.num_layers, ffn * cfg.num_layers
    if cfg.model_type == "rwkv6":
        # time mix wr, wk, wv, wg, wout (attn class); channel mix wffr,
        # wff1, wff2 (ffn); the decay LoRA stays float
        attn_n, ffn_n = 5 * cfg.num_layers, 3 * cfg.num_layers
    elif cfg.model_type == "zamba2":
        # each Mamba2 layer's win and wout (attn class), and the shared
        # block's wqkv, wo and w13, w2 at each of its applications
        groups = cfg.num_layers // cfg.shared_attn_every
        attn_n, ffn_n = 2 * cfg.num_layers + 2 * groups, 2 * groups
    elif cfg.model_type == "encdec":
        # a decode step: each decoder layer's wqkv, wo and the cross
        # attention's wq, wo (attn class), w13, w2; a prefill adds the cross
        # wkv and the encoder's layers (wqkv, wo, w13, w2)
        attn_n, ffn_n = 4 * cfg.num_layers, 2 * cfg.num_layers
        if path == "prefill":
            attn_n += cfg.num_layers + 2 * cfg.encoder_layers
            ffn_n += 2 * cfg.encoder_layers
    out: dict[str, int] = {}
    for cls, count in (("attn", attn_n), ("ffn", ffn_n), ("classifier", 1)):
        k = f"gqmm_{fmap[cls]}"
        out[k] = out.get(k, 0) + count
    return out


def step_loop(engine, batch, n: int) -> tuple[torch.Tensor, float, float]:
    """Greedy tokens (b, n) of an eager ``prefill`` + ``decode_step`` loop
    with a host-side position counter, n decode steps as generate runs
    (the last one's token dropped); the prefill's and the steps' wall
    seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = engine.prefill(batch)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    p = batch["tokens"].shape[1]
    for i in range(n):
        logits, cache = engine.decode_step(tok, cache, p + i)
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return torch.stack(out[:n], 1).cpu(), t1 - t0, t2 - t1


def phase_serve(dev, rows, model, params, quantize) -> tuple[dict, InferenceEngine]:
    """Full-width generate with one weight setting: launches per pass,
    timing, logits against the plain versions, the profiler's view of a
    decode step, the 89-projection pass on the kernels, and the matvec path."""
    cfg = model.cfg
    tag = "int8" if quantize is True else quantize
    t0 = time.perf_counter()
    # SPEC["k"] slots of slack: phase 7's verify chunks run on this engine
    # and are held to this phase's tokens
    engine = InferenceEngine(model, params, quantize=quantize, device=dev,
                             cache_len=SERVE["prompt_len"] + SERVE["max_new_tokens"] + SPEC["k"])
    torch.cuda.synchronize()
    log(f"[serve {tag}] {cfg.arch_id}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.param_dtype}, quantized fraction {engine.quantized_fraction:.3f}, quantize "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SERVE["seed"])
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(SERVE["batch"], SERVE["prompt_len"])))}
    engine.generate(batch, 2)                               # warm-up
    torch.cuda.synchronize()

    kern.reset_launches()
    t0 = time.perf_counter()
    logits_k, _ = engine.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = {k: v for k, v in kern.LAUNCHES.items() if v}

    # the main path: counts zeroed just before, read just after
    kern.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate(batch, SERVE["max_new_tokens"])
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)

    per_pass = launches_per_pass(cfg, quantize)
    passes = 1 + SERVE["max_new_tokens"]
    if prefill_launches != per_pass:
        raise AssertionError(f"{tag}: prefill launched {prefill_launches}, expected {per_pass}")
    want = {k: per_pass.get(k, 0) * passes for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: generate launched {launches}, expected {want} "
                             f"({per_pass} x {passes} passes)")
    toks = res.tokens
    if toks.shape != (SERVE["batch"], SERVE["max_new_tokens"]) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_padded)).all()):
        raise AssertionError(f"bad tokens: shape {tuple(toks.shape)}")
    if not bool(torch.isfinite(res.logits_last).all()):
        raise AssertionError("non-finite logits")

    # the captured programs against eager execution on the card: the replayed
    # tokens must equal an eager decode_step loop's (the same kernels in the
    # same order), and one replayed decode step counts one pass's launches
    pre_prog, dec_prog = engine.graphs.last["generate.prefill"], engine.graphs.last[
        "generate.decode"]
    replayed_gqmm = {k: n for _, k, n in dec_prog.launches if k.startswith("gqm")}
    if replayed_gqmm != per_pass:
        raise AssertionError(f"{tag}: a replayed decode step launches {replayed_gqmm}, "
                             f"expected {per_pass}")
    eager_toks, t_eager_prefill, t_eager_decode = step_loop(engine, batch,
                                                            SERVE["max_new_tokens"])
    if not torch.equal(eager_toks, toks):
        raise AssertionError(f"{tag}: replayed tokens differ from the eager decode_step "
                             f"loop's:\n replayed {toks.tolist()}\n eager {eager_toks.tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_prog.replay()
    torch.cuda.synchronize()
    t_prefill_replay = time.perf_counter() - t0
    p0 = SERVE["prompt_len"]
    dec_dev, dec_host = device_time_ms(lambda i: (dec_prog.load(pos=p0) if i == 0 else None,
                                                  dec_prog.replay()), 8, host_ms_guess=0.2)
    pre_dev, _ = device_time_ms(lambda i: pre_prog.replay(), 2, host_ms_guess=0.2)
    census = graphs.census(dec_prog)
    # the replayed step's kernels by the profiler (each run resets the
    # position first: one fill kernel more than the step)
    rprof = profile_device(lambda: (dec_prog.load(pos=p0), dec_prog.replay()), 3)

    with ops.impl_scope("plain"):
        logits_p, _ = engine.prefill(batch)
        res_p = engine.generate(batch, SERVE["max_new_tokens"])
    lk, lp = logits_k.float(), logits_p.float()
    logit_err = (lk - lp).abs().max().item() / lp.abs().max().item()
    agree = (toks == res_p.tokens).float().mean().item()
    first_agree = (toks[:, 0] == res_p.tokens[:, 0]).float().mean().item()
    log(f"[serve {tag}] first-step logits kernel vs plain: max|diff|/max|logit| "
        f"{logit_err:.3e} (tol {LOGIT_TOL}); greedy-token agreement {agree:.4f} "
        f"(first token {first_agree:.2f})")
    if not logit_err <= LOGIT_TOL:
        raise AssertionError(f"{tag}: kernel logits differ from plain by {logit_err:.3e}")

    b, p, new = SERVE["batch"], SERVE["prompt_len"], SERVE["max_new_tokens"]
    # replayed: generate's wall time less one replay of its prefill program;
    # eager: the decode_step loop's 32 steps, its prefill apart
    t_decode = t_gen - t_prefill_replay
    programs = engine.graphs.stats()
    out = {"quantize": tag, "prefill_s": t_prefill_replay, "generate_s": t_gen,
           "decode_s": t_decode, "prefill_tok_s": b * p / t_prefill_replay,
           "decode_tok_s": b * new / t_decode, "decode_ms_per_step": 1e3 * t_decode / new,
           "decode_device_ms": dec_dev, "decode_replay_host_ms": dec_host,
           "prefill_device_ms": pre_dev,
           "replayed_decode_profile": {k: v for k, v in rprof.items() if k != "top"},
           "eager": {"prefill_s": t_prefill, "prefill_loop_s": t_eager_prefill,
                     "decode_s": t_eager_decode,
                     "decode_ms_per_step": 1e3 * t_eager_decode / new,
                     "decode_tok_s": b * new / t_eager_decode},
           "programs": programs, "decode_graph": census, "replayed_step_launches": replayed_gqmm,
           "launches": launches, "prefill_launches": prefill_launches, "per_pass": per_pass,
           "logit_rel_err": logit_err, "token_agreement": agree,
           "quantized_fraction": engine.quantized_fraction, "tokens": toks.tolist()}
    log(f"[serve {tag}] replayed: prefill {b}x{p} {t_prefill_replay * 1e3:.2f} ms wall, "
        f"{pre_dev:.3f} ms on the card; decode {new} steps {t_decode * 1e3:.1f} ms "
        f"({out['decode_tok_s']:.1f} tok/s, {out['decode_ms_per_step']:.3f} ms/step wall, "
        f"{dec_dev:.3f} ms/step on the card, {100 * dec_dev / out['decode_ms_per_step']:.1f} % "
        f"busy; the profiler: {rprof['device_ms']:.3f} ms in {rprof['kernels']} kernels; "
        f"the host enqueues a replay in {dec_host:.3f} ms); "
        f"GQMM launches { {k: v for k, v in launches.items() if v} } = {per_pass} x {passes} "
        f"[{CARD['smi']}]")
    log(f"[serve {tag}] eager (decode_step loop, tokens equal the replay's): prefill "
        f"{t_prefill * 1e3:.1f} ms wall; decode {out['eager']['decode_ms_per_step']:.2f} ms/step "
        f"wall ({out['eager']['decode_tok_s']:.1f} tok/s)")
    log(f"[serve {tag}] programs: " + "; ".join(
        f"{name} {st['captured']} captured, capture {st['capture_s']:.3f} s (warm-up "
        f"{st['warmup_s']:.3f} s), graph pool {st['pool_bytes'] / 2**20:.0f} MiB"
        for name, st in sorted(programs.items()))
        + f"; the decode step's graph: {census['kernel_nodes']} kernel nodes of "
        f"{census['nodes']}, {census['edges']} edges, {census['programmatic_edges']} "
        "programmatic")

    # where the card's time goes: kernel time by name from the profiler
    logits0, cache = engine.prefill(batch)
    tok0 = logits0.argmax(-1)
    steps = iter(range(p, p + 8))
    dec = profile_device(lambda: engine.decode_step(tok0, cache, next(steps)), 3)
    eager_ms = out["eager"]["decode_ms_per_step"]
    out.update({"decode_profile": dec,
                "decode_device_busy_share": dec_dev / out["decode_ms_per_step"]})
    out["eager"]["decode_device_busy_share"] = dec["device_ms"] / eager_ms
    msg = (f"[serve {tag}] profiler: eager decode step {dec['device_ms']:.3f} ms of device "
           f"time ({100 * out['eager']['decode_device_busy_share']:.1f} % of the "
           f"{eager_ms:.2f} ms eager step), GQMM {dec['gqmm_ms']:.3f} ms, {dec['kernels']} kernels")
    if quantize is True:
        pre = profile_device(lambda: engine.prefill(batch), 1)
        out.update({"prefill_profile": pre,
                    "prefill_device_busy_share": pre_dev / (1e3 * t_prefill_replay)})
        out["eager"]["prefill_device_busy_share"] = pre["device_ms"] / (1e3 * t_prefill)
        msg += (f"; eager prefill {pre['device_ms']:.3f} ms "
                f"({100 * out['eager']['prefill_device_busy_share']:.1f} % busy), GQMM "
                f"{pre['gqmm_ms']:.3f} ms")
    log(msg)
    for name, ms in dec["top"]:
        log(f"[serve {tag}]   decode {ms:8.4f} ms/step  {name[:90]}")

    projs = model_projections(engine.params)
    out["step_gqmm"] = step_timing(projs, SERVE["batch"], dev, rows)
    out["step_gqmm_prefill"] = step_timing(projs, b * p, dev, rows)
    out["step_gqmv"] = step_timing(projs, 1, dev, rows)
    if tag == "int8":      # the int8 GQMV pass on its first design, the time before
        with first_gqmv_design():
            out["step_gqmv_first"] = step_timing(projs, 1, dev, rows)
    sm, sp, sv = out["step_gqmm"], out["step_gqmm_prefill"], out["step_gqmv"]
    log(f"[serve {tag}] one pass of 89 projections: GQMM b={b} {sm['ms']:.3f} ms (plain "
        f"{sm['plain_ms']:.2f} ms, bound {sm['bound_ms']:.3f} ms); GQMM b={b * p} "
        f"{sp['ms']:.3f} ms (plain {sp['plain_ms']:.2f} ms, bound {sp['bound_ms']:.3f} ms); "
        f"GQMV {sv['ms']:.3f} ms (plain {sv['plain_ms']:.2f} ms, bound {sv['bound_ms']:.3f} ms)"
        + (f"; GQMV on the first design {out['step_gqmv_first']['ms']:.3f} ms"
           if "step_gqmv_first" in out else "")
        + f" [{CARD['smi']}]")

    # the matvec path: 1-D activations reach GQMV through quantized_matmul
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = [torch.randn((w.shape[1],), generator=gen, device=dev, dtype=torch.bfloat16)
          for w in projs]
    kern.reset_launches()
    ys = [ops.quantized_matmul(x, w) for x, w in zip(xs, projs)]
    torch.cuda.synchronize()
    out["matvec_launches"] = {k: v for k, v in kern.LAUNCHES.items() if v}
    want_mv = {k.replace("gqmm", "gqmv"): v for k, v in per_pass.items()}
    if out["matvec_launches"] != want_mv:
        raise AssertionError(f"{tag}: matvec path launched {out['matvec_launches']}, "
                             f"expected {want_mv}")
    err = 0.0
    for x, w, y in zip(xs, projs, ys):
        err = max(err, check_close("quantized_matmul 1-D", y,
                                   ops.quantized_matmul(x, w, impl="plain"), w.fmt))
    out["matvec_max_abs_err"] = err
    log(f"[serve {tag}] matvec path: GQMV launches {out['matvec_launches']} through "
        f"quantized_matmul, max|err| vs plain {err:.2e}")
    return out, engine


# ---------------------------------------------------------------------------
# phase 5: the ragged path (serve_ragged) at full width
# ---------------------------------------------------------------------------

def ragged_trace(vocab_size: int) -> list[Request]:
    rng = np.random.default_rng(RAGGED["seed"])
    n = RAGGED["requests"]
    lens = rng.integers(RAGGED["prompt_lens"][0], RAGGED["prompt_lens"][1] + 1, size=n)
    budgets = rng.integers(RAGGED["budgets"][0], RAGGED["budgets"][1] + 1, size=n)
    return [Request(i, rng.integers(0, vocab_size, size=int(m)).tolist(), max_new=int(k))
            for i, (m, k) in enumerate(zip(lens, budgets))]


def _served(reqs, out, vocab_padded: int) -> int:
    """Checks the responses of one pass; returns the tokens generated."""
    for r, resp in zip(reqs, out):
        t = np.asarray(resp.tokens)
        if resp.id != r.id or t.shape != (r.max_new,) or resp.length != r.max_new or not (
                (t >= 0) & (t < vocab_padded)).all():
            raise AssertionError(f"bad response for request {r.id}: {resp}")
    return sum(resp.length for resp in out)


def _ragged_pass(engine, reqs, mode: str, *, slots: int = RAGGED["slots"],
                 chunk: int = RAGGED["chunk"], **kw) -> tuple[list, dict]:
    """One serve_ragged pass, every launch count set to 0 just before it and
    read just after; host clock around it, ended by a synchronise."""
    sk = dict(slots=slots, chunk=chunk)
    if mode == "paged":
        sk.update(block_size=RAGGED["block_size"], **kw)
    kern.reset_launches()
    pkern.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve_ragged(engine, reqs, RAGGED["budgets"][1], mode=mode,
                       **(sk if mode != "bucketed" else {}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**kern.LAUNCHES, **pkern.LAUNCHES}
    toks = _served(reqs, out, engine.cfg.vocab_padded)
    info = {"mode": mode, "kv": engine.cfg.kv_quant or "float", "wall_s": wall, "tokens": toks,
            "tok_s": toks / wall, "launches": launches}
    if mode == "bucketed":                  # one generate per bucket: no rounds
        return out, info
    sched = paged_scheduler(engine, **sk) if mode == "paged" else slot_scheduler(engine, **sk)
    info.update({"rounds": sched.last_rounds, "decode_steps": sched.last_decode_steps,
                 "ms_per_round": 1e3 * wall / sched.last_rounds,
                 "ms_per_decode_step": 1e3 * wall / sched.last_decode_steps})
    if mode == "paged":
        info.update(peak_blocks=sched.last_peak_blocks, pool_blocks=sched.num_blocks - 1,
                    footprint_blocks=slots * sched.blocks_per_req)
    return out, info


def _agreement(a, b) -> float:
    same = sum(int((np.asarray(x.tokens) == np.asarray(y.tokens)).sum()) for x, y in zip(a, b))
    return same / sum(len(x.tokens) for x in a)


def _first_step_logits(engine, reqs, dev) -> dict:
    """One paged decode step of the trace's first ``slots`` requests after
    their prefill, over a pool whose blocks are permuted (a non-identity
    table), on the kernels and on the plain versions."""
    group = reqs[:RAGGED["slots"]]
    length = bucket_length(max(len(r.tokens) for r in group))
    toks, lens = pad_bucket(group, length)
    model, params = engine.model, engine.params
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).to(dev),
                                               "lengths": torch.from_numpy(lens).to(dev)}, length)
        pool, table = contiguous_to_paged(cache, RAGGED["block_size"])
        nb = next(iter(pool.values())).shape[1]
        perm = torch.randperm(nb, generator=torch.Generator().manual_seed(4)).to(dev)
        moved = {}
        for name, leaf in pool.items():
            moved[name] = torch.empty_like(leaf)
            moved[name][:, perm] = leaf
        table = perm[table.long()].to(torch.int32)
        tok, pos = logits.argmax(-1), torch.from_numpy(lens).to(dev)
        got, _ = model.decode_paged(params, tok, {k: v.clone() for k, v in moved.items()},
                                    table, pos)
        with ops.impl_scope("plain"):
            want, _ = model.decode_paged(params, tok, {k: v.clone() for k, v in moved.items()},
                                         table, pos)
        err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        prof = profile_device(lambda: model.decode_paged(params, tok, moved, table, pos), 3)
    if not err <= LOGIT_TOL:
        raise AssertionError(f"paged decode logits differ from plain by {err:.3e}")
    return {"logit_rel_err": err, "profile": prof, "b": len(group),
            "positions": lens.tolist()}


def phase_ragged(dev, engine0, engine_fmt) -> tuple[dict, InferenceEngine, dict]:
    """The ragged trace through serve_ragged. Returns the results, the
    bf16-pool engine and the passes' responses (phase 7 serves the trace
    speculatively on that engine, held to those responses)."""
    cfg = engine0.cfg
    reqs = ragged_trace(cfg.vocab_size)
    # SPEC["k"] slots of slack for phase 7's verify chunks
    cache_len = max(max(bucket_length(len(r.tokens)), len(r.tokens) + r.max_new)
                    for r in reqs) + SPEC["k"]
    engines = {kvq: InferenceEngine(engine0.model, engine0.params, cache_len=cache_len,
                                    kv_quant=kvq, device=dev) for kvq in (None, "int8", "fp8")}
    warm = [Request(r.id, r.tokens, max_new=3) for r in reqs[:2]]
    log(f"[ragged] {len(reqs)} requests, prompt lengths {sorted(len(r.tokens) for r in reqs)}, "
        f"budgets {sorted(r.max_new for r in reqs)}; cache_len {cache_len}, slots "
        f"{RAGGED['slots']}, chunk {RAGGED['chunk']}, block size {RAGGED['block_size']}")
    # cold passes: the whole trace once per engine and mode, capturing every
    # program it needs (a decode step, a prefill per group size and bucket
    # length; generate's two programs per bucket)
    cold = {}
    for name, kvq, mode in RAGGED_REPLAYED:
        _, cold[name] = _ragged_pass(engines[kvq], reqs, mode)
    programs = {kvq or "float": engines[kvq].graphs.stats() for kvq in engines}
    for k, stats in programs.items():
        log(f"[ragged] programs of the {k}-pool engine: " + "; ".join(
            f"{name} {st['captured']} captured in {st['capture_s']:.2f} s (warm-ups "
            f"{st['warmup_s']:.2f} s), graph pool {st['pool_bytes'] / 2**20:.0f} MiB"
            for name, st in sorted(stats.items())))
    census = graphs.census(engines[None].graphs.last["paged.decode"])
    log(f"[ragged] the paged decode step's graph: {census['kernel_nodes']} kernel nodes of "
        f"{census['nodes']}, {census['edges']} edges, {census['programmatic_edges']} "
        "programmatic (the paged kernel's dependent launches)")

    passes, outs = {}, {}

    def show(name, info, extra=""):
        rounds = ("" if "rounds" not in info else
                  f"; {info['rounds']} rounds ({info['ms_per_round']:.1f} ms each), "
                  f"{info['decode_steps']} decode steps")
        log(f"[ragged] {name:13s} {info['tokens']} tokens in {info['wall_s']:.2f} s "
            f"({info['tok_s']:.1f} tok/s, prefill included){rounds}; "
            f"GQMM { {k: v for k, v in info['launches'].items() if v and 'gqm' in k} }, paged_attn "
            f"{info['launches']['paged_attn']}, paged_attn_quant "
            f"{info['launches']['paged_attn_quant']}"
            + (f"; peak {info['peak_blocks']} of {info['pool_blocks']} pool blocks "
               f"(contiguous footprint {info['footprint_blocks']})" if "peak_blocks" in info
               else "") + extra)

    def check_launches(name, info, kname):
        want = cfg.num_layers * info["decode_steps"]
        other = "paged_attn" if kname == "paged_attn_quant" else "paged_attn_quant"
        if info["launches"][kname] != want or want == 0 or info["launches"][other]:
            raise AssertionError(f"{name}: {kname} launched {info['launches'][kname]} times "
                                 f"({other} {info['launches'][other]}), expected "
                                 f"{cfg.num_layers} x {info['decode_steps']}")

    for kvq in (None, "int8", "fp8"):
        name = f"paged_{kvq or 'float'}"
        outs[name], passes[name] = _ragged_pass(engines[kvq], reqs, "paged")
        check_launches(name, passes[name], "paged_attn" if kvq is None else "paged_attn_quant")
        show(name, passes[name], f" (cold, with captures: {cold[name]['tok_s']:.1f} tok/s)")
    outs["continuous"], passes["continuous"] = _ragged_pass(engines[None], reqs, "continuous")
    if passes["continuous"]["launches"]["paged_attn"]:
        raise AssertionError("the continuous pass launched the paged-attention kernel")
    agree = {k: _agreement(outs[k], outs["continuous"]) for k in outs if k != "continuous"}
    show("continuous", passes["continuous"],
         "; token agreement with paged float/int8/fp8 "
         + "/".join(f"{agree[f'paged_{k}']:.4f}" for k in ("float", "int8", "fp8")))
    outs["bucketed"], passes["bucketed"] = _ragged_pass(engines[None], reqs, "bucketed")
    agree["bucketed"] = _agreement(outs["bucketed"], outs["continuous"])
    show("bucketed", passes["bucketed"],
         f"; token agreement with continuous {agree['bucketed']:.4f}")

    # the same passes run eagerly on the card: tokens equal the replayed
    # passes' exactly (the same kernels in the same order), and so do the
    # launch counts
    eager = {}
    with graphs.eager():
        for name, kvq, mode in RAGGED_REPLAYED:
            out_e, eager[name] = _ragged_pass(engines[kvq], reqs, mode)
            same = all(np.array_equal(a.tokens, b.tokens) and a.length == b.length
                       for a, b in zip(out_e, outs[name]))
            if not same or eager[name]["launches"] != passes[name]["launches"]:
                raise AssertionError(f"{name}: the eager pass differs from the replayed one "
                                     f"(tokens equal: {same}; launches "
                                     f"{eager[name]['launches']} vs "
                                     f"{passes[name]['launches']})")
            log(f"[ragged] {name:13s} eager {eager[name]['tok_s']:.1f} tok/s, replayed "
                f"{passes[name]['tok_s']:.1f} tok/s: tokens and launches equal "
                f"[{CARD['smi']}]")

    with ops.impl_scope("plain"):
        outs["paged_plain"], passes["paged_plain"] = _ragged_pass(engines[None], reqs, "paged")
    if any(passes["paged_plain"]["launches"].values()):
        raise AssertionError("the plain pass launched a kernel")
    agree["plain"] = _agreement(outs["paged_float"], outs["paged_plain"])
    show("paged_plain", passes["paged_plain"],
         f"; token agreement with the kernels' pass {agree['plain']:.4f}")

    # backpressure: a pool of half the default (contiguous-footprint) size
    half = passes["paged_float"]["footprint_blocks"] // 2 + 1
    outs["paged_half"], passes["paged_half"] = _ragged_pass(engines[None], reqs, "paged",
                                                            num_blocks=half)
    check_launches("paged_half", passes["paged_half"], "paged_attn")
    if passes["paged_half"]["peak_blocks"] > half - 1:
        raise AssertionError("the half pool's peak exceeds the pool")
    agree["half"] = _agreement(outs["paged_float"], outs["paged_half"])
    show("paged_half", passes["paged_half"],
         f"; token agreement with the default pool {agree['half']:.4f}")

    # the packed-weight preset (int3 attention/FFN, int8 classifier), float pool
    eng3 = InferenceEngine(engine_fmt.model, engine_fmt.params, cache_len=cache_len, device=dev)
    serve_ragged(eng3, warm, 3, mode="paged", slots=RAGGED["slots"], chunk=RAGGED["chunk"],
                 block_size=RAGGED["block_size"])
    name = f"paged_{RAGGED_FORMAT}"
    outs[name], passes[name] = _ragged_pass(eng3, reqs, "paged")
    check_launches(name, passes[name], "paged_attn")
    per_pass = launches_per_pass(cfg, RAGGED_FORMAT)
    got = {k: v for k, v in passes[name]["launches"].items() if v and k.startswith("gqm")}
    forwards = got.get("gqmm_int8", 0) // per_pass["gqmm_int8"]
    if forwards < 1 or got != {k: v * forwards for k, v in per_pass.items()}:
        raise AssertionError(f"{name}: GQMM launches {got}, expected {per_pass} per forward")
    agree[RAGGED_FORMAT] = _agreement(outs["paged_float"], outs[name])
    show(name, passes[name], f" ({forwards} forward passes); token agreement with int8 "
         f"weights {agree[RAGGED_FORMAT]:.4f}")
    del eng3

    logits = {kvq or "float": _first_step_logits(engines[kvq], reqs, dev)
              for kvq in (None, "int8")}
    for k, v in logits.items():
        p = v["profile"]
        log(f"[ragged] one paged decode step, {k} pool, b={v['b']}: logits kernel vs plain "
            f"max|diff|/max|logit| {v['logit_rel_err']:.3e} (tol {LOGIT_TOL}); device "
            f"{p['device_ms']:.3f} ms, paged attention {p['paged_ms']:.4f} ms in "
            f"{p['paged_kernels']} kernels (split passes and combines), GQMM "
            f"{p['gqmm_ms']:.3f} ms, {p['kernels']} kernels [{CARD['smi']}]")
    return {"cache_len": cache_len, "passes": passes, "agreement": agree,
            "cold": cold, "eager": eager, "programs": programs, "paged_graph": census,
            "first_step": logits,
            "trace": [{"len": len(r.tokens), "max_new": r.max_new} for r in reqs]}, \
        engines[None], outs


# ---------------------------------------------------------------------------
# phase 6: the perf-variant flags at full width
# ---------------------------------------------------------------------------

def _flash_launches(fn):
    """Runs fn() with the flash and GQMM launch counts set to 0 just before;
    returns (fn's result, flash launches by kernel, GQMM launches by kernel)."""
    fkern.reset_launches()
    kern.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: v for k, v in fkern.LAUNCHES.items() if v},
            {k: v for k, v in kern.LAUNCHES.items() if v})


def phase_flags(dev, engine, serve3) -> dict:
    """The phase-3 int8 model under the reference's perf-variant flags.

    (a) generate, batch 4, prompt 64, 32 tokens, under blockwise_attention,
        deferred_decode_cache and kvt_cache_layout: the flash kernel runs
        once per layer in the prefill (22), decode commits each step's rows
        after the last layer into the (L, b, KV, T, hd) cache; first-step
        logits against the same run on the plain versions; greedy tokens
        beside phase 3's default-flag run; timing and a profiled decode step.
    (b) one prefill of 1 x 2048 tokens under blockwise_attention with
        prefill_dequant set around it only: 22 flash launches, no GQMM; the
        flash kernel's device time per layer from the profiler.
    (c) Model.forward on (2, 512) tokens under blockwise_attention: 22 flash
        launches, logits against the plain versions.
    (d) the standalone fused RMSNorm + quantize through ops.rmsnorm_quant at
        the model's 45 norm sites (22 attention norms, 22 FFN norms, the
        final norm) on bf16 rows of b*s = 256, against its plain version and
        beside the model's unfused path (rmsnorm rounded to bf16, then
        quantize_activation), which it differs from by design.
    """
    cfg, model, params = engine.cfg, engine.model, engine.params
    L = cfg.num_layers
    # the model is bf16: every layer's flash attention is the tensor-core kernel
    per_prefill = {"flash_attn": L}
    rng = np.random.default_rng(SERVE["seed"])
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(SERVE["batch"], SERVE["prompt_len"])))}
    out: dict = {}

    # (a) serving under the three flags
    with flags.overrides(**SERVE_FLAGS):
        engine.generate(batch, 2)                                     # warm-up
        torch.cuda.synchronize()
        (logits_k, cache), pre_flash, pre_gqmm = _flash_launches(lambda: engine.prefill(batch))
        if pre_flash != per_prefill:
            raise AssertionError(f"flags prefill launched {pre_flash}, expected {per_prefill}")
        kv_shape = tuple(cache["k"].shape)
        want_shape = (L, SERVE["batch"], cfg.num_kv_heads, engine.cache_len,
                      cfg.resolved_head_dim)
        if kv_shape != want_shape:
            raise AssertionError(f"kvt cache {kv_shape}, expected {want_shape}")
        t0 = time.perf_counter()
        (logits0, _), _, _ = _flash_launches(lambda: engine.prefill(batch))
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        res, gen_flash, gen_gqmm = _flash_launches(
            lambda: engine.generate(batch, SERVE["max_new_tokens"]))
        t_gen = time.perf_counter() - t0
        passes = 1 + SERVE["max_new_tokens"]
        per_pass = launches_per_pass(cfg, True)
        if gen_flash != per_prefill or gen_gqmm != {k: v * passes for k, v in per_pass.items()}:
            raise AssertionError(f"flags generate launched {gen_flash} (expected "
                                 f"{per_prefill}), GQMM {gen_gqmm} (expected {per_pass} x "
                                 f"{passes})")
        toks = res.tokens
        if toks.shape != (SERVE["batch"], SERVE["max_new_tokens"]) or not bool(
                torch.isfinite(res.logits_last).all()):
            raise AssertionError(f"flags generate: bad output {tuple(toks.shape)}")
        pre_prog = engine.graphs.last["generate.prefill"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre_prog.replay()
        torch.cuda.synchronize()
        t_prefill_replay = time.perf_counter() - t0
        eager_toks, _, t_eager_decode = step_loop(engine, batch, SERVE["max_new_tokens"])
        if not torch.equal(eager_toks, toks):
            raise AssertionError("flags generate: replayed tokens differ from the eager "
                                 "decode_step loop's")
        with ops.impl_scope("plain"):
            (logits_p, _), plain_flash, _ = _flash_launches(lambda: engine.prefill(batch))
            res_p = engine.generate(batch, SERVE["max_new_tokens"])
        if plain_flash:
            raise AssertionError("the plain prefill launched the flash kernel")
        lk, lp = logits_k.float(), logits_p.float()
        logit_err = (lk - lp).abs().max().item() / lp.abs().max().item()
        if not logit_err <= LOGIT_TOL:
            raise AssertionError(f"flags: kernel logits differ from plain by {logit_err:.3e}")
        steps = itertools.count(SERVE["prompt_len"])       # <= 13 calls, inside cache_len
        tok0 = logits0.argmax(-1)
        _, cache = engine.prefill(batch)
        dec = profile_device(lambda: engine.decode_step(tok0, cache, next(steps)), 3)
    t_decode = t_gen - t_prefill_replay
    ms_step = 1e3 * t_decode / SERVE["max_new_tokens"]
    eager_ms = 1e3 * t_eager_decode / SERVE["max_new_tokens"]
    base = torch.as_tensor(serve3["tokens"])
    out["generate"] = {
        "flash_launches_prefill": pre_flash, "flash_launches_generate": gen_flash,
        "gqmm_launches_generate": gen_gqmm, "cache_shape": list(kv_shape),
        "logit_rel_err": logit_err,
        "token_agreement_plain": (toks == res_p.tokens).float().mean().item(),
        "token_agreement_phase3": (toks == base).float().mean().item(),
        "prefill_s": t_prefill, "prefill_replay_s": t_prefill_replay, "generate_s": t_gen,
        "decode_ms_per_step": ms_step, "eager_decode_ms_per_step": eager_ms,
        "decode_profile": dec, "decode_device_busy_share": dec["device_ms"] / ms_step,
        "phase3_decode_ms_per_step": serve3["decode_ms_per_step"]}
    g = out["generate"]
    log(f"[flags] generate {SERVE['batch']}x{SERVE['prompt_len']}, {SERVE['max_new_tokens']} "
        f"tokens under {sorted(SERVE_FLAGS)}: {pre_flash} per prefill, cache "
        f"{kv_shape}; first-step logits kernel vs plain {logit_err:.3e} (tol {LOGIT_TOL}); "
        f"greedy agreement with plain {g['token_agreement_plain']:.4f}, with phase 3's "
        f"default-flag run {g['token_agreement_phase3']:.4f}")
    log(f"[flags] prefill {1e3 * t_prefill:.1f} ms eager, {1e3 * t_prefill_replay:.2f} ms "
        f"replayed; decode {ms_step:.3f} ms/step replayed, {eager_ms:.2f} eager (tokens equal; "
        f"phase 3 replayed: {serve3['decode_ms_per_step']:.3f}); profiler: eager decode step "
        f"{dec['device_ms']:.3f} ms of device time ({100 * g['decode_device_busy_share']:.1f} % "
        f"of the replayed step), GQMM {dec['gqmm_ms']:.3f} ms, {dec['kernels']} kernels")

    # (b) one long prompt: blockwise attention, prefill_dequant around the prefill only
    gen = torch.Generator(device=dev).manual_seed(8)
    long = {"tokens": torch.randint(0, cfg.vocab_size, (LONG_PREFILL["b"], LONG_PREFILL["s"]),
                                    generator=gen, device=dev)}
    with flags.overrides(blockwise_attention=True), torch.inference_mode():
        with flags.overrides(prefill_dequant=True):
            model.prefill(params, long, LONG_PREFILL["s"])            # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (lg, _), long_flash, long_gqmm = _flash_launches(
                lambda: model.prefill(params, long, LONG_PREFILL["s"]))
            t_long = time.perf_counter() - t0
            prof = profile_device(lambda: model.prefill(params, long, LONG_PREFILL["s"]), 1)
        if long_flash != per_prefill or long_gqmm:
            raise AssertionError(f"long prefill launched {long_flash} (expected {per_prefill}) "
                                 f"and GQMM {long_gqmm} (expected none)")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("long prefill: non-finite logits")
    other_ms = prof["device_ms"] - prof["flash_ms"] - prof["products_ms"] - prof["gqmm_ms"]
    out["long_prefill"] = {"tokens": LONG_PREFILL["s"], "flash_launches": long_flash,
                           "gqmm_launches": long_gqmm, "wall_s": t_long, "profile": prof,
                           "flash_ms_per_layer": prof["flash_ms"] / L,
                           "elementwise_ms": other_ms}
    log(f"[flags] prefill 1x{LONG_PREFILL['s']} (blockwise, prefill_dequant): {long_flash} "
        f"launches, GQMM {long_gqmm or 0}; {1e3 * t_long:.1f} ms wall, {prof['device_ms']:.2f} "
        f"ms on the card: flash attention {prof['flash_ms']:.2f} ms "
        f"({prof['flash_ms'] / L:.3f} ms per layer), float products {prof['products_ms']:.2f} "
        f"ms, elementwise passes and copies {other_ms:.2f} ms [{CARD['smi']}]")
    for name, ms in prof["top"]:
        log(f"[flags]   long prefill {ms:8.3f} ms  {name[:90]}")

    # (c) the scoring forward
    fwd = {"tokens": torch.randint(0, cfg.vocab_size, (FORWARD["b"], FORWARD["s"]),
                                   generator=gen, device=dev)}
    with flags.overrides(blockwise_attention=True), torch.inference_mode():
        model.forward(params, fwd)                                    # warm-up
        got, fwd_flash, fwd_gqmm = _flash_launches(lambda: model.forward(params, fwd))
        with ops.impl_scope("plain"):
            want = model.forward(params, fwd)
    if fwd_flash != per_prefill or tuple(got.shape) != (FORWARD["b"], FORWARD["s"],
                                                         cfg.vocab_padded):
        raise AssertionError(f"Model.forward launched {fwd_flash} (expected {per_prefill}), "
                             f"logits {tuple(got.shape)}")
    fwd_err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    if not fwd_err <= LOGIT_TOL:
        raise AssertionError(f"Model.forward: kernel logits differ from plain by {fwd_err:.3e}")
    out["forward"] = {"flash_launches": fwd_flash, "gqmm_launches": fwd_gqmm,
                      "logit_rel_err": fwd_err,
                      "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean()
                      .item()}
    log(f"[flags] Model.forward {FORWARD['b']}x{FORWARD['s']} (blockwise): {fwd_flash} "
        f"launches, GQMM {fwd_gqmm}; logits kernel vs plain {fwd_err:.3e} (tol "
        f"{LOGIT_TOL}), argmax agreement {out['forward']['argmax_agreement']:.4f}")
    del got, want

    # (d) the standalone fused RMSNorm + quantize at the model's norm sites
    lay = params["layers"]
    weights = [lay["att_norm"][i] for i in range(L)] + [lay["ffn_norm"][i] for i in range(L)]
    weights.append(params["final_norm"])
    xs = [torch.randn((SERVE["batch"] * SERVE["prompt_len"], cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16) for _ in weights]
    rkern.reset_launches()
    fused = [ops.rmsnorm_quant(x, w, group_size=cfg.group_size) for x, w in zip(xs, weights)]
    torch.cuda.synchronize()
    launches = rkern.LAUNCHES["rmsnorm_quant"]
    if launches != len(weights):
        raise AssertionError(f"rmsnorm_quant launched {launches} times, expected {len(weights)}")
    flips = unfused_diff = 0
    far = 0.0
    for x, w, got in zip(xs, weights, fused):
        chk = _rmsq_check("model site", x, w, cfg.group_size, got)
        flips, far = flips + chk["tie_flips"], max(far, chk["farthest_tie"])
        unf = quantize_activation(rmsnorm(x, w), cfg.group_size).qvalues
        unfused_diff += int((unf != got[0]).sum())
    total = sum(x.numel() for x in xs)
    out["rmsnorm_quant"] = {"launches": launches, "tie_flips": flips, "farthest_tie": far,
                            "differ_from_unfused": unfused_diff, "elements": total}
    log(f"[flags] ops.rmsnorm_quant at the model's {len(weights)} norm sites, bf16 rows "
        f"{tuple(xs[0].shape)}: {launches} launches, {flips} tie flips against the plain "
        f"version (farthest {far:.2e} from .5); {unfused_diff} of {total} int8 values differ "
        "from the model's unfused path (rmsnorm rounded to bf16, then quantize_activation)")
    return out


# ---------------------------------------------------------------------------
# phase 7: speculative decoding and top-p at full width
# ---------------------------------------------------------------------------

class OracleDrafter:
    """Drafts each row's vanilla greedy continuation (the reference's
    ``SelfDrafter``), found by the row's prompt: every draft is the target's
    own choice, so a verify step accepts all of them where verify's greedy
    choice equals vanilla decode's."""

    name = "oracle"

    def __init__(self, prompts: np.ndarray, tokens: np.ndarray):
        self.plen = prompts.shape[1]
        self.rows = {tuple(int(t) for t in p): [int(t) for t in row]
                     for p, row in zip(prompts, tokens)}

    def draft(self, context, k: int) -> list[int]:
        row = self.rows[tuple(int(t) for t in context[:self.plen])]
        g = len(context) - self.plen          # tokens generated, the current one included
        out = row[g:g + k]
        return out + [0] * (k - len(out))


@contextlib.contextmanager
def gqmm_rows(cls, method: str):
    """Counts the GQMM launches made inside ``cls.method`` by their
    activation rows (b), while active: the format hooks' CUDA GQMM wrapped in
    a recorder and the method in a flag, both restored on exit."""
    rows: collections.Counter = collections.Counter()
    inside = [False]
    saved, orig = dict(ops.KERNEL_HOOKS), getattr(cls, method)
    for name, hook in saved.items():
        def rec(wq, ws, xq, xs, *, group_size, _fn=hook.gqmm_cuda):
            if inside[0]:
                rows[xq.shape[0]] += 1
            return _fn(wq, ws, xq, xs, group_size=group_size)
        ops.KERNEL_HOOKS[name] = dataclasses.replace(hook, gqmm_cuda=rec)

    def flagged(*args, **kw):
        inside[0] = True
        try:
            return orig(*args, **kw)
        finally:
            inside[0] = False

    setattr(cls, method, flagged)
    try:
        yield rows
    finally:
        ops.KERNEL_HOOKS.update(saved)
        setattr(cls, method, orig)


def _launches() -> dict[str, int]:
    return {k: v for k, v in {**kern.LAUNCHES, **pkern.LAUNCHES}.items() if v}


def _reset_launches() -> None:
    kern.reset_launches()
    pkern.reset_launches()


def step_logits(engine, batch, tokens: torch.Tensor) -> list[torch.Tensor]:
    """f32 logits (b, V) that chose tokens[:, s], for every s: eager prefill,
    then decode_step fed the given tokens (vanilla decode's arithmetic)."""
    out = []
    p = batch["tokens"].shape[1]
    with torch.inference_mode():
        logits, cache = engine.prefill(batch)
        for s in range(tokens.shape[1]):
            out.append(logits.float())
            if s + 1 < tokens.shape[1]:
                logits, cache = engine.decode_step(tokens[:, s].to(logits.device), cache, p + s)
    return out


def first_differences(want: np.ndarray, got: np.ndarray, scores) -> list[dict]:
    """Per row, the first step where ``got`` leaves ``want``, and the gap
    between the two tokens in ``scores[step]`` (the step's logits, or
    perturbed scores for top-p) as a fraction of max|logit|: a traced near
    tie when <= TIE_MARGIN."""
    out = []
    for row in range(want.shape[0]):
        diff = np.flatnonzero(want[row] != got[row])
        if diff.size:
            s = int(diff[0])
            sc, scale = scores(s, row)
            a, c = int(want[row, s]), int(got[row, s])
            out.append({"row": row, "step": s, "want": a, "got": c,
                        "margin": abs(sc[a] - sc[c]).item() / scale})
    return out


def _check_ties(name: str, diffs: list[dict]) -> None:
    if any(d["margin"] > TIE_MARGIN for d in diffs):
        raise AssertionError(f"{name}: tokens leave the reference run at a step that is not a "
                             f"near tie (margin > {TIE_MARGIN}): {diffs}")


def _spec_generate(engine, batch, n: int, **kw) -> tuple:
    """One replayed speculative generate (after a cold one that captured its
    programs), counts zeroed just before and read just after, then the same
    run eagerly (graphs.eager) with GQMM launches counted by rows; its tokens
    and launches must equal the replayed run's. Returns the replayed run's
    result, wall seconds, launches, its verify and prefill programs (the
    captured ones), and the eager verify steps' GQMM launches by rows."""
    engine.generate(batch, n, **kw)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(batch, n, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    ver, pre = engine.graphs.last["generate.verify"], engine.graphs.last["generate.prefill"]
    with graphs.eager(), gqmm_rows(InferenceEngine, "_generate_spec") as rows:
        _reset_launches()
        res_e = engine.generate(batch, n, **kw)
        launches_e = _launches()
    if not torch.equal(res.tokens, res_e.tokens) or launches != launches_e \
            or res.spec_stats != res_e.spec_stats:
        raise AssertionError(f"spec generate {kw}: the eager run differs from the replayed one "
                             f"(launches {launches_e} vs {launches})")
    return res, wall, launches, ver, pre, dict(rows)


def _first_mismatch(want: np.ndarray, got: np.ndarray) -> list[dict]:
    """Each row's first step where ``got`` leaves ``want``."""
    out = []
    for row in range(want.shape[0]):
        d = np.flatnonzero(want[row] != got[row])
        if d.size:
            out.append({"row": row, "step": int(d[0]), "want": int(want[row, d[0]]),
                        "got": int(got[row, d[0]])})
    return out


def phase_spec(dev, engine3, serve3, ragged3, reng, rvanilla) -> dict:
    """Phase 7: speculative decoding on the phase-3 int8 model (its engine
    and vanilla tokens) and on phase 5's engine and vanilla passes."""
    cfg, k, n = engine3.cfg, SPEC["k"], SERVE["max_new_tokens"]
    b, p = SERVE["batch"], SERVE["prompt_len"]
    rng = np.random.default_rng(SERVE["seed"])
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, p)))}
    vanilla = {False: np.asarray(serve3["tokens"])}
    # paged decode (the paged-attention kernel) sums in other orders than
    # contiguous decode: paged spec is held to paged vanilla
    vanilla[True] = engine3.generate(batch, n, paged=True).tokens.numpy()
    per_pass = launches_per_pass(cfg, True)
    out = {"paged_vanilla_equal_contiguous": int((vanilla[True] == vanilla[False]).sum()),
           "tokens_total": b * n, "runs": {}}
    steps_oracle = math.ceil((n - 1) / k)
    for paged in (False, True):
        vtoks = vanilla[paged]
        oracle = OracleDrafter(batch["tokens"].numpy(), vtoks)
        for dname, drafter in (("ngram", NgramDrafter()), ("oracle", oracle)):
            name = f"{'paged' if paged else 'contiguous'}_{dname}"
            res, wall, launches, ver, pre, rows = _spec_generate(
                engine3, batch, n, spec_k=k, drafter=drafter, paged=paged)
            st, toks = res.spec_stats, res.tokens.numpy()
            # the run's own captured prefill, replayed once more: its time
            # comes off the run's wall time
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre.replay()
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            step_launches = {kn: c for _, kn, c in ver.launches}
            want_step = {**per_pass, **({"paged_attn": cfg.num_layers * k} if paged else {})}
            if step_launches != want_step:
                raise AssertionError(f"{name}: a verify step launches {step_launches}, "
                                     f"expected {want_step}")
            if rows != {b * k: per_pass["gqmm_int8"] * st["verify_steps"]}:
                raise AssertionError(f"{name}: GQMM launches of the verify steps by rows {rows}, "
                                     f"expected {per_pass['gqmm_int8']} x {st['verify_steps']} "
                                     f"at {b * k}")
            want_all = {kn: c * st["verify_steps"] for kn, c in want_step.items()}
            want_all["gqmm_int8"] += per_pass["gqmm_int8"]                  # the prefill
            if launches != want_all:
                raise AssertionError(f"{name}: launched {launches}, expected {want_all}")
            diffs = _first_mismatch(vtoks, toks)
            if diffs:
                raise AssertionError(f"{name}: spec tokens leave vanilla decode's at {diffs}")
            if dname == "oracle" and (st["verify_steps"] != steps_oracle
                                      or st["accepted"] != st["drafted"]):
                raise AssertionError(f"{name}: the oracle drafter took {st}; expected "
                                     f"acceptance 1 in {steps_oracle} steps")
            chunk = torch.as_tensor(vtoks[:, :k])
            dev_ms, host_ms = device_time_ms(lambda i: (ver.load(
                pos=p, chunk=chunk, live=np.ones(b, bool), remaining=np.full(b, n))
                if i == 0 else None, ver.replay()), 6, host_ms_guess=0.3)
            wall_step = 1e3 * (wall - t_prefill) / st["verify_steps"]
            r = {"tokens_equal_vanilla": int((toks == vtoks).sum()), "spec_stats": st,
                 "wall_s": wall, "verify_ms_wall": wall_step, "verify_ms_device": dev_ms,
                 "replay_host_ms": host_ms, "busy_share": dev_ms / wall_step,
                 "tokens_per_step": (st["generated"] - b) / (st["verify_steps"] * b),
                 "ms_per_token": 1e3 * (wall - t_prefill) / (n - 1),
                 "launches": launches, "step_launches": step_launches, "gqmm_rows": rows}
            out["runs"][name] = r
            log(f"[spec] generate {name}, k {k}: {r['tokens_equal_vanilla']}/{b * n} tokens equal "
                f"{'paged' if paged else 'contiguous'} vanilla decode's; {st['verify_steps']} "
                f"verify steps, {st['accepted']}/{st['drafted']} drafts accepted, "
                f"{r['tokens_per_step']:.2f} tokens a step a row; verify step "
                f"{wall_step:.3f} ms wall, {dev_ms:.3f} ms on the card "
                f"({100 * r['busy_share']:.1f} % busy; the host enqueues a replay in "
                f"{host_ms:.3f} ms); {r['ms_per_token']:.3f} ms a generated token beside "
                f"vanilla's {serve3['decode_ms_per_step']:.3f} ms/step (phase 3); a step "
                f"launches {step_launches}, GQMM at {b * k} rows "
                f"({kern.gqmm_design(b * k, 2048, 2048, 256)[0]} design) [{CARD['smi']}]")
    log(f"[spec] paged vanilla decode: {out['paged_vanilla_equal_contiguous']}/{b * n} tokens "
        "equal contiguous vanilla decode's (phase 3)")

    # (b) the ragged trace, paged and continuous, n-gram drafter, on phase
    # 5's engine beside its vanilla passes
    reqs = ragged_trace(cfg.vocab_size)
    sk = dict(slots=RAGGED["slots"], chunk=RAGGED["chunk"])
    out["ragged"] = {}
    for mode, vname in (("paged", "paged_float"), ("continuous", "continuous")):
        kw = dict(sk, **({"block_size": RAGGED["block_size"]} if mode == "paged" else {}))
        serve_ragged(reng, reqs, RAGGED["budgets"][1], mode=mode, spec_k=k, **kw)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp = serve_ragged(reng, reqs, RAGGED["budgets"][1], mode=mode, spec_k=k, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        sched = (paged_scheduler(reng, spec_k=k, **kw) if mode == "paged"
                 else slot_scheduler(reng, spec_k=k, **kw))
        st = dict(sched.last_spec_stats)
        adapter = type(sched._core.adapter)
        with graphs.eager(), gqmm_rows(adapter, "verify_round") as rows:
            _reset_launches()
            sp_e = serve_ragged(reng, reqs, RAGGED["budgets"][1], mode=mode, spec_k=k, **kw)
            launches_e = _launches()
        same = all(np.array_equal(x.tokens, y.tokens) and x.length == y.length
                   for x, y in zip(sp, sp_e))
        if not same or launches != launches_e:
            raise AssertionError(f"ragged spec {mode}: the eager pass differs from the replayed "
                                 f"one (tokens equal: {same}; launches {launches_e} vs "
                                 f"{launches})")
        toks = _served(reqs, sp, cfg.vocab_padded)
        large = {r: c for r, c in rows.items()
                 if kern.gqmm_design(r, 2048, 2048, 256)[0] == "large"}
        if dict(rows) != {RAGGED["slots"] * k: per_pass["gqmm_int8"] * st["verify_steps"]}:
            raise AssertionError(f"ragged spec {mode}: GQMM launches of the verify rounds by "
                                 f"rows {dict(rows)}, expected {per_pass['gqmm_int8']} x "
                                 f"{st['verify_steps']} at {RAGGED['slots'] * k}")
        diffs = [{"request": i, "step": int(np.flatnonzero(
                      np.asarray(x.tokens) != np.asarray(y.tokens))[0])}
                 for i, (x, y) in enumerate(zip(rvanilla[vname], sp))
                 if not np.array_equal(x.tokens, y.tokens)]
        if diffs:
            raise AssertionError(f"ragged spec {mode}: tokens leave phase 5's vanilla pass's at "
                                 f"{diffs}")
        if not verify_step_equals_decode(reng, reqs, mode == "paged"):
            raise AssertionError(f"ragged spec {mode}: a {RAGGED['slots'] * k}-row verify "
                                 "step's logits differ from a decode step's")
        van = ragged3["passes"][vname]
        r = {"tokens": toks, "wall_s": wall, "tok_s": toks / wall, "vanilla_tok_s": van["tok_s"],
             "spec_stats": st, "ms_per_verify_step": 1e3 * wall / st["verify_steps"],
             "vanilla_ms_per_round": van["ms_per_round"], "vanilla_rounds": van["rounds"],
             "vanilla_decode_steps": van["decode_steps"], "launches": launches,
             "gqmm_rows": dict(rows), "large_design_launches": sum(large.values())}
        out["ragged"][mode] = r
        log(f"[spec] serve_ragged {mode}, {len(reqs)} requests, k {k}: {toks} tokens in {wall:.2f} s "
            f"({r['tok_s']:.1f} tok/s; vanilla {van['tok_s']:.1f}, phase 5), every token "
            f"equal to the vanilla pass's; last_spec_stats {st}; a verify round "
            f"{r['ms_per_verify_step']:.1f} ms wall with prefills (vanilla: "
            f"{van['ms_per_round']:.1f} ms a round of up to {RAGGED['chunk']} decode steps, "
            f"{van['decode_steps']} steps in {van['rounds']} rounds); one "
            f"{RAGGED['slots'] * k}-row verify step's logits equal a decode step's bit for bit; "
            f"verify rounds' GQMM by rows {dict(rows)}, {r['large_design_launches']} on the "
            f"large design; launches {launches} [{CARD['smi']}]")
    return out


def verify_step_equals_decode(engine, reqs, paged: bool) -> bool:
    """The trace's first ``slots`` requests prefilled together, then one
    verify step of chunk [token, token, ...] (slots * k rows: the large
    GQMM design) and one decode step of the same tokens, over the
    contiguous cache or its identity-mapped pool: verify row 0's logits
    equal the decode step's bit for bit."""
    group = reqs[:RAGGED["slots"]]
    length = bucket_length(max(len(r.tokens) for r in group))
    toks, lens = pad_bucket(group, length)
    model, params, dev, bs = engine.model, engine.params, engine.device, RAGGED["block_size"]
    with torch.inference_mode():
        cache_len = -(-engine.cache_len // bs) * bs
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).to(dev),
                                               "lengths": torch.from_numpy(lens).to(dev)},
                                      cache_len)
        tok, pos = logits.argmax(-1), torch.from_numpy(lens).to(dev)
        chunk = tok[:, None].expand(-1, SPEC["k"]).contiguous()
        if paged:
            pool, table = contiguous_to_paged(cache, bs)
            want, _ = model.decode_paged(params, tok, {k: v.clone() for k, v in pool.items()},
                                         table, pos)
            got, _ = model.verify_paged(params, chunk, pool, table, pos)
        else:
            want, _ = model.decode(params, tok, {k: v.clone() for k, v in cache.items()}, pos)
            got, _ = model.verify(params, chunk, cache, pos)
    return torch.equal(got[:, 0], want)


# ---------------------------------------------------------------------------
# phase 4: golden tokens from the reference package
# ---------------------------------------------------------------------------

def replay_choices(engine, prompt, tokens, extra: dict | None = None) -> list[dict]:
    """Prefill (``extra`` joining the prompt's batch: the encoder-decoder's
    frames), then decode the reference's tokens (b, T) step by step; at
    each step where the card's greedy token is not the reference's, the gap
    between the card's top logit and the reference token's logit, as a
    fraction of max|logit|."""
    off = []
    with torch.inference_mode():
        logits, cache = engine.prefill({"tokens": torch.as_tensor(prompt), **(extra or {})})
        for step in range(tokens.shape[1]):
            want = torch.as_tensor(tokens[:, step], device=logits.device)
            lg = logits.float()
            gap = (lg.max(-1).values - lg.gather(1, want[:, None])[:, 0]) / lg.abs().max()
            for row in torch.nonzero(lg.argmax(-1) != want).flatten().tolist():
                off.append({"step": step, "row": row, "margin": gap[row].item()})
            if step + 1 < tokens.shape[1]:
                logits, cache = engine.decode_step(want, cache, prompt.shape[1] + step)
    return off


def phase_golden(dev) -> dict:
    golden = json.loads(GOLDEN_FILE.read_text())
    for k, v in GOLDEN.items():
        if golden[k] != v:
            raise AssertionError(f"{GOLDEN_FILE.name}: {k}={golden[k]!r}, this script uses {v!r}")
    cfg = golden_config()
    t0 = time.perf_counter()
    tree = init_params_numpy(cfg, GOLDEN["seed"])
    checksum = weights_checksum(tree)
    if checksum != golden["weights_checksum"]:
        raise AssertionError(f"numpy drew other weights than the golden run "
                             f"({checksum!r} vs {golden['weights_checksum']!r})")
    prompt = golden_prompt(cfg.vocab_size)
    if prompt.tolist() != golden["prompt"]:
        raise AssertionError("golden prompt differs")
    params = params_from_numpy(tree, dev)
    del tree
    engine = InferenceEngine(build(cfg), params, device=dev, quantize=True,
                             cache_len=GOLDEN["prompt_len"] + GOLDEN["max_new_tokens"])
    kern.reset_launches()
    res = engine.generate({"tokens": torch.as_tensor(prompt)}, GOLDEN["max_new_tokens"])
    launches = dict(kern.LAUNCHES)
    got = res.tokens.tolist()
    same = sum(a == b for ra, rb in zip(got, golden["tokens"]) for a, b in zip(ra, rb))
    total = GOLDEN["batch"] * GOLDEN["max_new_tokens"]
    log(f"[golden] {cfg.arch_id} d {cfg.d_model} x {cfg.num_layers} layers f32 int8: "
        f"{same}/{total} tokens equal the reference's ({time.perf_counter() - t0:.1f} s, "
        f"GQMM launches {launches['gqmm_int8']})")
    if got != golden["tokens"]:
        raise AssertionError(f"golden tokens differ:\n port {got}\n  ref {golden['tokens']}")
    spec = golden_spec(dev, engine, prompt, golden["tokens"], "int8, 2 layers")
    spec["top_p"] = golden_top_p(dev, engine, prompt)

    # the ragged trace through serve_ragged(mode="paged"), one KV pool type each
    gr, ref = GOLDEN_RAGGED, golden["ragged"]
    for k, v in gr.items():
        if ref[k] != v:
            raise AssertionError(f"{GOLDEN_FILE.name}: ragged {k}={ref[k]!r}, this script "
                                 f"uses {v!r}")
    prompts = golden_ragged_prompts(cfg.vocab_size)
    if prompts != ref["prompts"]:
        raise AssertionError("golden ragged prompts differ")
    reqs = [Request(i, p, max_new=n) for i, (p, n) in enumerate(zip(prompts, gr["budgets"]))]
    ragged = {}
    for kv in gr["kv"]:
        # the int8 weights of the engine above
        eng = InferenceEngine(engine.model, engine.params, device=dev, cache_len=gr["cache_len"],
                              kv_quant=None if kv == "float" else kv)
        kern.reset_launches()
        pkern.reset_launches()
        out = serve_ragged(eng, reqs, gr["max_new_tokens"], mode="paged", slots=gr["slots"],
                           chunk=gr["chunk"], block_size=gr["block_size"])
        toks = [np.asarray(r.tokens).tolist() for r in out]
        lengths = [r.length for r in out]
        peak = paged_scheduler(eng, slots=gr["slots"], chunk=gr["chunk"],
                               block_size=gr["block_size"]).last_peak_blocks
        same_r = sum(a == b for ra, rb in zip(toks, ref["tokens"][kv]) for a, b in zip(ra, rb))
        total_r = sum(gr["budgets"])
        ragged[kv] = {"tokens_equal": same_r, "tokens_total": total_r, "peak_blocks": peak,
                      "launches": {k: v for k, v in {**kern.LAUNCHES, **pkern.LAUNCHES}.items()
                                   if v}}
        log(f"[golden] serve_ragged paged, {kv} KV pool: {same_r}/{total_r} tokens equal the "
            f"reference's; lengths {'equal' if lengths == ref['lengths'][kv] else 'differ'}, "
            f"peak blocks {peak} (reference {ref['peak_blocks'][kv]}); launches "
            f"{ragged[kv]['launches']}")
        if kv == "float" and (toks != ref["tokens"][kv] or lengths != ref["lengths"][kv]
                              or peak != ref["peak_blocks"][kv]):
            raise AssertionError(f"golden ragged tokens differ (float pool):\n port {toks}\n"
                                 f"  ref {ref['tokens'][kv]}")

    # generate with the other weight settings. Free-running tokens are shown:
    # one int8 activation that f32 order rounds to the other side of a .5
    # tie changes a trajectory (ROADMAP Queue C). Required: replayed on the
    # reference's tokens, every one of them is the card's greedy choice or
    # within TIE_MARGIN of its top logit.
    formats = {}
    cpu_equal = golden["port_cpu_equal"]["generate"]
    for fmt in GOLDEN["weight_formats"]:
        eng = InferenceEngine(engine.model, params, device=dev, quantize=fmt,
                              cache_len=GOLDEN["prompt_len"] + GOLDEN["max_new_tokens"])
        kern.reset_launches()
        got_f = eng.generate({"tokens": torch.as_tensor(prompt)},
                             GOLDEN["max_new_tokens"]).tokens.tolist()
        launches_f = {k: v for k, v in kern.LAUNCHES.items() if v}
        want_f = golden["formats"][fmt]
        same_f = sum(a == b for ra, rb in zip(got_f, want_f) for a, b in zip(ra, rb))
        off = replay_choices(eng, prompt, np.asarray(want_f))
        formats[fmt] = {"tokens_equal": same_f, "tokens_total": total,
                        "cpu_tokens_equal": cpu_equal[fmt], "launches": launches_f,
                        "replay_differs": off}
        log(f"[golden] generate, {fmt} weights: {same_f}/{total} tokens equal the reference's "
            f"(the port's plain path on the CPU: {cpu_equal[fmt]}/{total}); replayed on the "
            f"reference's tokens, the card's choice differs at {len(off)} of {total} steps"
            + "".join(f"; step {o['step']} row {o['row']}: margin {o['margin']:.2e}" for o in off)
            + f" (margins as a fraction of max|logit|, tol {TIE_MARGIN}); launches {launches_f}")
        if any(o["margin"] > TIE_MARGIN for o in off):
            raise AssertionError(f"golden replay ({fmt} weights): the reference's token is "
                                 f"not a near-tie of the card's choice: {off}")
        del eng
    # int8 generate under the perf-variant flags (blockwise prefill through
    # the flash kernel, deferred decode into the kvt cache): exact tokens
    # where the port's CPU run was exact, else the replay rule above
    with flags.overrides(**GOLDEN["flags"]):
        eng = InferenceEngine(engine.model, engine.params, device=dev,
                              cache_len=GOLDEN["prompt_len"] + GOLDEN["max_new_tokens"])
        fkern.reset_launches()
        kern.reset_launches()
        got_fl = eng.generate({"tokens": torch.as_tensor(prompt)},
                              GOLDEN["max_new_tokens"]).tokens.tolist()
        launches_fl = {k: v for k, v in {**kern.LAUNCHES, **fkern.LAUNCHES}.items() if v}
        want_fl = golden["flags_tokens"]
        same_fl = sum(a == b for ra, rb in zip(got_fl, want_fl) for a, b in zip(ra, rb))
        off_fl = replay_choices(eng, prompt, np.asarray(want_fl))
    cpu_fl = golden["port_cpu_equal"]["generate_flags"]
    flagged = {"tokens_equal": same_fl, "tokens_total": total, "cpu_tokens_equal": cpu_fl,
               "launches": launches_fl, "replay_differs": off_fl}
    log(f"[golden] generate, int8 weights under {sorted(GOLDEN['flags'])}: {same_fl}/{total} "
        f"tokens equal the reference's (the port's plain path on the CPU: {cpu_fl}/{total}); "
        f"replayed, the card's choice differs at {len(off_fl)} steps"
        + "".join(f"; step {o['step']} row {o['row']}: margin {o['margin']:.2e}" for o in off_fl)
        + f"; launches {launches_fl}")
    # the golden model is f32: the CUDA-core flash kernel, once per layer
    if launches_fl.get("flash_attn_f32") != GOLDEN["num_layers"] or launches_fl.get(
            "flash_attn"):
        raise AssertionError(f"golden flags run launched {launches_fl}, expected "
                             f"{GOLDEN['num_layers']} flash_attn_f32")
    if cpu_fl == total and got_fl != want_fl:
        raise AssertionError(f"golden tokens under the flags differ:\n port {got_fl}\n"
                             f"  ref {want_fl}")
    if any(o["margin"] > TIE_MARGIN for o in off_fl):
        raise AssertionError(f"golden replay under the flags: the reference's token is not a "
                             f"near-tie of the card's choice: {off_fl}")
    return {"tokens_equal": same, "tokens_total": total, "launches": launches,
            "ragged": ragged, "formats": formats, "flags": flagged, "spec": spec}


def golden_spec(dev, engine, prompt, want, tag: str) -> dict:
    """Phase 7 (d): greedy speculative generate (k = SPEC["k"]) on a golden
    engine's weights must give the golden tokens: greedy spec tokens are
    the vanilla tokens, each verify row summed as its decode step. With the
    n-gram drafter, and with the oracle drafter (the golden continuation):
    every draft accepted, in ceil((n-1)/k) verify steps. Spec top-p at p ->
    0 collapses the nucleus to the argmax: the greedy spec tokens (f32
    logits: no exact tie at the top)."""
    k, n = SPEC["k"], GOLDEN["max_new_tokens"]
    seng = InferenceEngine(engine.model, engine.params, device=dev,
                           cache_len=GOLDEN["prompt_len"] + n + k)
    batch = {"tokens": torch.as_tensor(prompt)}
    _reset_launches()
    res = seng.generate(batch, n, spec_k=k)
    launches = _launches()
    got = res.tokens.tolist()
    same = sum(a == b for ra, rb in zip(got, want) for a, b in zip(ra, rb))
    orc = seng.generate(batch, n, spec_k=k, drafter=OracleDrafter(prompt, np.asarray(want)))
    steps = math.ceil((n - 1) / k)
    tiny = seng.generate(batch, n, spec_k=k, sampler="top_p", sampler_kw={"p": SPEC["tiny_p"]})
    log(f"[golden] spec generate ({tag}), k {k}: {same}/{GOLDEN['batch'] * n} tokens equal the "
        f"reference's; {res.spec_stats}; launches {launches}; with the oracle drafter "
        f"{orc.spec_stats}; top-p at p={SPEC['tiny_p']} equal to greedy spec: "
        f"{torch.equal(tiny.tokens, res.tokens)}")
    if got != want:
        raise AssertionError(f"golden spec tokens ({tag}) differ:\n port {got}\n  ref {want}")
    if orc.tokens.tolist() != want or orc.spec_stats["verify_steps"] != steps \
            or orc.spec_stats["accepted"] != orc.spec_stats["drafted"]:
        raise AssertionError(f"golden spec ({tag}): the oracle drafter took {orc.spec_stats}, "
                             f"expected the golden tokens with acceptance 1 in {steps} steps")
    if not torch.equal(tiny.tokens, res.tokens):
        raise AssertionError(f"golden spec ({tag}): top-p at p={SPEC['tiny_p']} differs from "
                             "greedy spec")
    return {"tokens_equal": same, "spec_stats": res.spec_stats, "launches": launches,
            "oracle": orc.spec_stats, "tiny_p_equals_greedy": True}


def golden_top_p(dev, engine, prompt) -> dict:
    """Phase 7 (c): top-p generate (p SPEC["top_p"], seed SPEC["seed"]) on the
    kernels and on the plain versions, the same noise drawn for both: tokens
    equal, or each row's first differing step a near tie of the kernels'
    perturbed scores (filtered logits + the step's Gumbel draw) along the
    common prefix, within TIE_MARGIN of max|logit|."""
    n, p = GOLDEN["max_new_tokens"], SPEC["top_p"]
    batch = {"tokens": torch.as_tensor(prompt)}
    kw = dict(sampler="top_p", sampler_kw={"p": p}, seed=SPEC["seed"])
    _reset_launches()
    got = engine.generate(batch, n, **kw).tokens.numpy()
    launches = _launches()
    with ops.impl_scope("plain"):
        want = engine.generate(batch, n, **kw).tokens.numpy()
    gen = torch.Generator(device=dev).manual_seed(SPEC["seed"])
    noise = [fill_gumbel(torch.empty((prompt.shape[0], engine.cfg.vocab_padded), device=dev), gen)
             for _ in range(n)]
    klog = step_logits(engine, batch, torch.as_tensor(want))

    def perturbed(s, row):
        lg = klog[s][row]
        return (torch.where(nucleus_mask(lg, p), lg, NEG_INF) + noise[s][row],
                lg.abs().max().item())

    diffs = first_differences(want, got, perturbed)
    log(f"[golden] top-p (p {p}, seed {SPEC['seed']}) kernels vs plain: "
        f"{int((got == want).sum())}/{got.size} tokens equal; first differences {diffs} "
        f"(tol {TIE_MARGIN}); launches {launches}")
    _check_ties("top-p kernels vs plain", diffs)
    return {"tokens_equal": int((got == want).sum()), "first_differences": diffs,
            "launches": launches}


def phase_golden_deep(dev) -> dict:
    """The golden prompt at TinyLlama's full depth (GOLDEN_DEEP): one draw
    of the 22-layer f32 weights, shared by an f32 and an int8 engine. f32
    tokens must equal the reference's. int8 tokens must too, unless the
    reference's tokens, replayed step by step, lose the card's greedy choice
    only at steps traced to a .5 activation tie (the port's CPU run's, which
    tests/test_torch_deep_tie.py traces, and the card's, DEEP_CARD_TIES),
    each within TIE_MARGIN."""
    golden = json.loads(GOLDEN_FILE.read_text())["deep"]
    for k, v in GOLDEN_DEEP.items():
        if golden[k] != v:
            raise AssertionError(f"{GOLDEN_FILE.name}: deep {k}={golden[k]!r}, this script "
                                 f"uses {v!r}")
    cfg = golden_config(GOLDEN_DEEP["num_layers"])
    t0 = time.perf_counter()
    tree = init_params_numpy(cfg, GOLDEN["seed"])
    if weights_checksum(tree) != golden["weights_checksum"]:
        raise AssertionError("numpy drew other 22-layer weights than the golden run")
    params = params_from_numpy(tree, dev)
    del tree
    t_weights = time.perf_counter() - t0
    prompt = golden_prompt(cfg.vocab_size)
    model = build(cfg)
    total = GOLDEN["batch"] * GOLDEN["max_new_tokens"]
    out = {"weights_s": t_weights}
    for setting in GOLDEN_DEEP["settings"]:
        t1 = time.perf_counter()
        quantize = GOLDEN["quantize"] if setting == "int8" else False
        eng = InferenceEngine(model, params, device=dev, quantize=quantize,
                              cache_len=GOLDEN["prompt_len"] + GOLDEN["max_new_tokens"])
        kern.reset_launches()
        got = eng.generate({"tokens": torch.as_tensor(prompt)},
                           GOLDEN["max_new_tokens"]).tokens.tolist()
        launches = {k: v for k, v in kern.LAUNCHES.items() if v}
        want = golden["tokens"][setting]
        same = sum(a == b for ra, rb in zip(got, want) for a, b in zip(ra, rb))
        off = replay_choices(eng, prompt, np.asarray(want))
        ties = {(o["step"], o["row"]) for o in golden["port_cpu_replay_differs"][setting]}
        ties |= set(DEEP_CARD_TIES.get(setting, []))
        out[setting] = {"tokens_equal": same, "tokens_total": total,
                        "cpu_tokens_equal": golden["port_cpu_equal"][setting],
                        "replay_differs": off, "cpu_ties": sorted(ties), "launches": launches,
                        "seconds": time.perf_counter() - t1}
        log(f"[golden] {cfg.num_layers} layers, {setting} weights: {same}/{total} tokens equal "
            f"the reference's (the port's plain path on the CPU: "
            f"{golden['port_cpu_equal'][setting]}/{total}); replayed, the card's choice differs "
            f"at {len(off)} steps" + "".join(f"; step {o['step']} row {o['row']}: margin "
                                             f"{o['margin']:.2e}" for o in off)
            + f" (traced ties, CPU's and card's: {sorted(ties)}); launches {launches}; "
            f"{out[setting]['seconds']:.1f} s")
        if setting == "float32" and got != want:
            raise AssertionError(f"deep golden f32 tokens differ:\n port {got}\n  ref {want}")
        if setting == "float32":
            out["spec"] = golden_spec(dev, eng, prompt, want, f"f32, {cfg.num_layers} layers")
        if got != want and not off:
            raise AssertionError("deep golden int8 tokens differ with no replayed tie")
        for o in off:
            if (o["step"], o["row"]) not in ties or o["margin"] > TIE_MARGIN:
                raise AssertionError(f"deep golden {setting}: the reference's token at step "
                                     f"{o['step']} row {o['row']} is not a traced tie of the "
                                     f"card's choice: {o}")
        del eng
    del params
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 8: the dense GQA families at full width
# ---------------------------------------------------------------------------

def family_config(arch: str):
    cfg = load_config(arch)
    layers = FAMILIES[arch]
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


def _check_logits(tag: str, got, want) -> float:
    err = _rel_err(got, want)
    if not (err <= LOGIT_TOL and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{tag}: kernel logits differ from plain by {err:.3e} "
                             f"(tol {LOGIT_TOL})")
    return err


def family_generate(dev, engine, tag: str, prefix: str = "families",
                    batch: dict | None = None) -> dict:
    """Phase 3's generate at b 4, prompt 64, 32 greedy tokens on one family
    (or on ``batch``, the encoder-decoder's with its frames): replayed
    (counts zeroed just before, read just after) against an eager prefill +
    decode_step loop, whose tokens and launches must equal the replay's;
    the decode step's time wall and on the card, its kernels, and the
    first-step logits against the plain versions."""
    cfg = engine.cfg
    new = SERVE["max_new_tokens"]
    if batch is None:
        rng = np.random.default_rng(SERVE["seed"])
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, size=(SERVE["batch"], SERVE["prompt_len"])))}
    b, p = batch["tokens"].shape
    s_enc = batch["frames"].shape[1] if "frames" in batch else 0
    engine.generate(batch, 2)                               # captures
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(batch, new)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = _launches()
    per_pass = launches_per_pass(cfg, True)
    pre_pass = launches_per_pass(cfg, True, "prefill")
    want = {k: pre_pass[k] + v * new for k, v in per_pass.items()}
    if launches != want:
        raise AssertionError(f"{tag}: generate launched {launches}, expected {want}")
    toks = res.tokens
    if toks.shape != (b, new) or not bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()) \
            or not bool(torch.isfinite(res.logits_last).all()):
        raise AssertionError(f"{tag}: bad generate output")
    _reset_launches()
    eager_toks, _, t_eager = step_loop(engine, batch, new)
    eager_launches = _launches()
    if not torch.equal(eager_toks, toks) or eager_launches != launches:
        raise AssertionError(f"{tag}: replayed tokens/launches differ from the eager loop's "
                             f"({eager_launches} vs {launches}):\n replayed {toks.tolist()}\n"
                             f" eager {eager_toks.tolist()}")
    pre_prog, dec_prog = (engine.graphs.last["generate.prefill"],
                          engine.graphs.last["generate.decode"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_prog.replay()
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    try:
        dec_dev, _ = device_time_ms(lambda i: (dec_prog.load(pos=p) if i == 0 else None,
                                               dec_prog.replay()), 8, host_ms_guess=0.2)
        timing = "spin"
    except HostBound:
        # a graph of tens of thousands of kernels fills the launch queue
        # behind the spin; its own launch is short beside its run, so
        # back-to-back replays keep the card busy between the events
        dec_dev, timing = replay_events_ms(dec_prog, lambda: dec_prog.load(pos=p), 8), "events"
    prof = profile_device(lambda: (dec_prog.load(pos=p), dec_prog.replay()), 3)
    wall_ms = 1e3 * (t_gen - t_pre) / new
    with torch.inference_mode():
        logits_k, _ = engine.prefill(batch)
        with ops.impl_scope("plain"):
            logits_p, _ = engine.prefill(batch)
    err, rule = _check_family_logits(tag, engine, batch, logits_k, logits_p)
    # the projections' bytes, a recurrent family's state read and written,
    # the encoder-decoder's cross K/V read
    wbound = bounds.decode_step(cfg, "int8", b, s_enc)
    census = graphs.census(dec_prog)
    gstats = engine.graphs.stats()
    out = {"tokens": toks.tolist(), "launches": launches, "per_pass": per_pass,
           "prefill_pass": pre_pass, "logit_rule": rule, "decode_graph": census,
           "captures": {k: {f: v[f] for f in ("captured", "capture_s", "pool_bytes")}
                        for k, v in gstats.items()},
           "decode_ms_wall": wall_ms, "decode_ms_device": dec_dev, "device_timing": timing,
           "busy_share": dec_dev / wall_ms, "eager_decode_ms": 1e3 * t_eager / new,
           "kernels_per_step": prof["kernels"], "gqmm_ms_per_step": prof["gqmm_ms"],
           "weight_bytes_per_step": wbound.nbytes,
           "state_bytes_per_step": bounds.recurrent_state_bytes(cfg, b),
           "cross_kv_bytes_per_step": bounds.cross_kv_bytes(cfg, b, s_enc),
           "bytes_bound_ms": 1e3 * wbound.nbytes / HBM_BYTES_PER_S,
           "logit_rel_err": err, "first_token_agreement": (
               logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()}
    log(f"[{prefix} {tag}] generate b={b}, prompt {p}, {new} tokens: replayed == eager "
        f"(tokens and launches {launches}); decode {wall_ms:.3f} ms/step wall, {dec_dev:.3f} on "
        f"the card ({timing}; {100 * out['busy_share']:.1f} % busy; eager "
        f"{out['eager_decode_ms']:.2f} "
        f"ms/step), {prof['kernels']} kernels a step, GQMM {prof['gqmm_ms']:.3f} ms; "
        f"bytes a step (projections, recurrent state, cross K/V) {wbound.nbytes / 1e9:.3f} GB "
        f"-> HBM bound "
        f"{out['bytes_bound_ms']:.3f} ms; first-step logits kernel vs plain {err:.3e} "
        f"(tol {LOGIT_TOL}); decode graph {census['nodes']} nodes ({census['kernel_nodes']} "
        f"kernels); captures " + ", ".join(
            f"{k} {v['capture_s']:.2f} s, {v['pool_bytes'] / 2**20:.0f} MiB pool"
            for k, v in sorted(out["captures"].items())) + f" [{CARD['smi']}]")
    out["batch"] = batch
    return out


def replay_events_ms(prog, reset, reps: int) -> float:
    """Device ms a replay of ``prog``, from CUDA events around ``reps``
    back-to-back replays (``reset()`` first: the step advances its own
    position), after one replay to warm."""
    reset()
    prog.replay()
    torch.cuda.synchronize()
    reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        prog.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def router_flips(engine, batch) -> list[dict]:
    """The MoE router choices that differ between the kernels' prefill and
    the plain versions' (every layer, row and position whose top-k expert
    set differs), each with the plain run's gap between its k-th and
    (k+1)-th probability relative to the k-th, in layer order."""
    k = engine.cfg.moe.top_k
    runs = []
    orig = mlpmod.moe_forward

    def rec(p, x, cfg, **kw):
        runs[-1].append(torch.softmax(mlpmod._router_logits(x, p["router_w"]), -1).float())
        return orig(p, x, cfg, **kw)

    mlpmod.moe_forward = rec
    try:
        with torch.inference_mode():
            for impl in ("auto", "plain"):
                runs.append([])
                with ops.impl_scope(impl):
                    engine.prefill(batch)
    finally:
        mlpmod.moe_forward = orig
    out = []
    for layer, (pk, pp) in enumerate(zip(*runs)):
        ik = torch.topk(pk, k, dim=-1).indices.sort(-1).values
        ip = torch.topk(pp, k, dim=-1).indices.sort(-1).values
        top = torch.topk(pp, k + 1, dim=-1).values
        for row, pos in torch.nonzero((ik != ip).any(-1)).tolist():
            gap = (top[row, pos, k - 1] - top[row, pos, k]) / top[row, pos, k - 1]
            out.append({"layer": layer, "row": row, "pos": pos, "margin": gap.item()})
    return out


def hold_per_kernel(tag: str, engine, batch, want, err: float, ulp_bound: bool = True) -> dict:
    """The rule for a prefill whose kernel logits leave the plain versions'
    (``want``) by ``err`` > LOGIT_TOL, every other op plain in each run
    (``prefill_logits``): every kernel of the prefill held to its plain
    version on the same input ("checked", raises); the plain prefill with
    every kernel launched beside it must give ``want`` bit for bit (no
    kernel acts outside its output, "shadow"); the plain prefill with one
    f32 ulp moved at layer 0 ("ulp") says how far the model carries a
    rounding-sized change, and with ``ulp_bound`` ``err`` must stay within
    ULP_FACTOR x that."""
    calls: dict[str, int] = {}
    flash: list = []
    prefill_logits(engine, batch, "checked", calls, flash)
    if not torch.equal(prefill_logits(engine, batch, "shadow"), want.float()):
        raise AssertionError(f"{tag}: launching the kernels beside the plain versions changed "
                             "the plain logits")
    ulp = _rel_err(prefill_logits(engine, batch, "ulp"), want)
    if ulp_bound and err > ULP_FACTOR * ulp:
        raise AssertionError(f"{tag}: kernel logits differ from plain by {err:.3e}, more than "
                             f"{ULP_FACTOR} x the {ulp:.3e} that one f32 ulp at layer 0 makes")
    log(f"[logit rule {tag}] logits kernel vs plain {err:.3e} (LOGIT_TOL {LOGIT_TOL}): every "
        f"kernel of the prefill within its tolerance of its plain version on the same input ("
        + ", ".join(f"{n} {k}" for k, n in sorted(calls.items()))
        + "), kernels beside the plain run change nothing; one f32 ulp at layer 0's first "
        f"projection moves the plain logits {ulp:.3e}"
        + (f" (the kernels' within {ULP_FACTOR} x that)" if ulp_bound else ""))
    if flash:
        log_flash_errors(tag, flash)
    return {"checked_calls": calls, "ulp_rel_err": ulp, "ulp_bound": ulp_bound,
            "flash_errors": flash}


def log_flash_errors(tag: str, flash: list) -> None:
    """Print each held flash call's max |err| against its plain version, in
    call order, as a fraction of its FLASH_TOL bound (the error over the
    tolerance, which is FLASH_TOL x max|ref| of that call)."""
    log(f"[logit rule {tag}] {len(flash)} flash calls held, max|err| each (causal C, "
        f"non-causal N; share of its tolerance): " + ", ".join(
            f"{i}{'C' if c else 'N'} {e:.2e} ({e / t:.2f})" for i, (e, t, c) in enumerate(flash)))


def _check_family_logits(tag: str, engine, batch, got, want) -> tuple[float, dict]:
    """First-step logits, kernels against plain, within LOGIT_TOL; past it,
    ``hold_per_kernel``'s rule (its record returned): for a recurrent
    family and the encoder-decoder, whose full depth may carry one f32 ulp
    at layer 0 to ~1e-1 of max|logit|; for a MoE family only where a router choice flipped between
    the two runs (a flip moves a token's FFN output by a whole expert, so
    the logits are not bounded by the one-ulp change there), the flips
    traced and printed with their margins."""
    err = _rel_err(got, want)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag} first step: non-finite kernel logits")
    if err <= LOGIT_TOL:
        return err, {}
    if engine.cfg.model_type in HELD_MODEL_TYPES:
        return err, hold_per_kernel(tag, engine, batch, want, err)
    flips = router_flips(engine, batch) if engine.cfg.moe else []
    if not flips:
        raise AssertionError(f"{tag} first step: kernel logits differ from plain by {err:.3e} "
                             f"(tol {LOGIT_TOL}) and no router choice flipped")
    log(f"[families {tag}] first-step logits kernel vs plain {err:.3e} > {LOGIT_TOL}: "
        f"{len(flips)} router choices flipped between the two runs (first: layer "
        f"{flips[0]['layer']} row {flips[0]['row']} position {flips[0]['pos']}, margin "
        f"{flips[0]['margin']:.2e}; smallest margin {min(f['margin'] for f in flips):.2e}, "
        f"largest {max(f['margin'] for f in flips):.2e})")
    return err, {"router_flips": flips,
                 **hold_per_kernel(tag, engine, batch, want, err, ulp_bound=False)}


def family_ragged_and_spec(dev, engine, gen_out: dict, tag: str) -> dict:
    """The first FAMILY_RAGGED requests of phase 5's trace through
    serve_ragged in each of the family's FAMILY_RAGGED_MODES (the paged one
    on a float pool), replayed, and in FAMILY_EAGER_MODES against eager
    (tokens and launches equal; the paged kernel once a layer a decode
    step), and for dbrx its
    int8 and fp8 KV pools too (the quantized paged kernel once a layer a
    decode step); then speculative generate (k 4, the oracle drafter),
    contiguous and paged, replayed and eager, whose greedy tokens must equal
    vanilla decode's. An MLA family has no paged pool and no verify: the
    reference's refusals are checked to raise instead."""
    cfg = engine.cfg
    reqs = ragged_trace(cfg.vocab_size)[:FAMILY_RAGGED]
    cache_len = max(max(bucket_length(len(r.tokens)), len(r.tokens) + r.max_new)
                    for r in reqs) + SPEC["k"]
    reng = InferenceEngine(engine.model, engine.params, cache_len=cache_len, device=dev)
    ragged = {}
    for mode in FAMILY_RAGGED_MODES.get(tag, valid_modes(engine.model)):
        _ragged_pass(reng, reqs, mode)                     # captures
        out_r, info = _ragged_pass(reng, reqs, mode)
        if mode not in FAMILY_EAGER_MODES:
            ragged[mode] = {"replayed": info}
            log(f"[families {tag}] ragged {mode} serve, {len(reqs)} requests: {info['tokens']} "
                f"tokens, {info['tok_s']:.1f} tok/s replayed, launches "
                f"{ {k: v for k, v in info['launches'].items() if v} } [{CARD['smi']}]")
            continue
        with graphs.eager():
            out_e, info_e = _ragged_pass(reng, reqs, mode)
        same = all(np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
                   for a, b in zip(out_r, out_e))
        la = {k: v for k, v in info["launches"].items() if v}
        le = {k: v for k, v in info_e["launches"].items() if v}
        if not same or la != le:
            raise AssertionError(f"{tag} ragged {mode}: the eager pass differs from the replayed "
                                 f"one ({le} vs {la})")
        if mode == "paged" and la.get("paged_attn") != cfg.num_layers * info["decode_steps"]:
            raise AssertionError(f"{tag} ragged: paged_attn launched {la.get('paged_attn')}, "
                                 f"expected {cfg.num_layers} x {info['decode_steps']}")
        ragged[mode] = {"replayed": info, "eager": info_e}
        log(f"[families {tag}] ragged {mode} serve, {len(reqs)} requests: {info['tokens']} "
            f"tokens, {info['tok_s']:.1f} tok/s replayed ({info_e['tok_s']:.1f} eager), replayed "
            f"== eager (tokens and launches {la}) [{CARD['smi']}]")
    if tag in FAMILY_KV_POOLS:
        for kvq in FAMILY_KV_POOLS[tag]:
            qeng = InferenceEngine(engine.model, engine.params, cache_len=cache_len, device=dev,
                                   kv_quant=kvq)
            _ragged_pass(qeng, reqs, "paged")              # captures
            _, info = _ragged_pass(qeng, reqs, "paged")
            got = info["launches"].get("paged_attn_quant")
            if got != cfg.num_layers * info["decode_steps"] or info["launches"].get("paged_attn"):
                raise AssertionError(f"{tag} ragged paged {kvq} pool: paged_attn_quant launched "
                                     f"{got}, expected {cfg.num_layers} x "
                                     f"{info['decode_steps']}")
            ragged[f"paged_{kvq}"] = {"replayed": info}
            log(f"[families {tag}] ragged paged serve, {kvq} KV pool: {info['tokens']} tokens, "
                f"{info['tok_s']:.1f} tok/s replayed, launches "
                f"{ {k: v for k, v in info['launches'].items() if v} } [{CARD['smi']}]")
            del qeng
    if not engine.model.supports_spec:
        return {"ragged": ragged, "refusals": family_refusals(dev, engine, gen_out["batch"])}
    batch, b, new, k = gen_out["batch"], SERVE["batch"], SERVE["max_new_tokens"], SPEC["k"]
    prompts = batch["tokens"].numpy()
    spec = {}
    for paged in (False, True):
        van = (torch.as_tensor(gen_out["tokens"]) if not paged
               else engine.generate(batch, new, paged=True).tokens)
        oracle = OracleDrafter(prompts, van.numpy())
        res, wall, launches, ver, _, _ = _spec_generate(engine, batch, new, spec_k=k,
                                                        drafter=oracle, paged=paged)
        st = res.spec_stats
        if not torch.equal(res.tokens, van) or st["accepted"] != st["drafted"] \
                or st["verify_steps"] != math.ceil((new - 1) / k):
            raise AssertionError(f"{tag} spec ({'paged' if paged else 'contiguous'}): greedy "
                                 f"spec tokens differ from vanilla decode's, or the oracle did "
                                 f"not take every draft in ceil({new - 1}/{k}) steps ({st}):\n "
                                 f"spec {res.tokens.tolist()}\n vanilla {van.tolist()}")
        spec["paged" if paged else "contiguous"] = {"launches": launches, "spec_stats": st,
                                                    "wall_s": wall}
        log(f"[families {tag}] speculative generate k {k}, oracle drafter, "
            f"{'paged' if paged else 'contiguous'}: tokens == vanilla decode's, "
            f"{st['verify_steps']} verify steps, replayed == eager; launches {launches}")
    return {"ragged": ragged, "spec": spec}


def family_refusals(dev, engine, batch) -> list[str]:
    """An MLA family refuses what the reference refuses, with its errors:
    generate(paged=True), spec_k, kv_quant, serve_ragged(mode="paged") and
    a paged cache; the model declares no paged or verify hooks."""
    model, out = engine.model, []
    calls = {"generate(paged=True)": lambda: engine.generate(batch, 2, paged=True),
             "generate(spec_k=4)": lambda: engine.generate(batch, 2, spec_k=SPEC["k"]),
             "InferenceEngine(kv_quant='int8')": lambda: InferenceEngine(
                 model, engine.params, cache_len=8, device=dev, kv_quant="int8"),
             "serve_ragged(mode='paged')": lambda: serve_ragged(
                 engine, ragged_trace(engine.cfg.vocab_size)[:1], 2, mode="paged"),
             "lm_init_paged_cache": lambda: init_paged_cache(engine.cfg, 4, 8, torch.bfloat16,
                                                              dev)}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            out.append(f"{name}: {e}")
            continue
        raise AssertionError(f"{engine.cfg.arch_id}: {name} did not raise")
    if model.supports_paged or model.supports_spec or any(getattr(model, h) is not None for h in (
            "init_paged_cache", "decode_paged", "verify", "commit_verify", "verify_paged",
            "commit_verify_paged")):
        raise AssertionError(f"{engine.cfg.arch_id}: an MLA model declares a paged or verify hook")
    log(f"[families {engine.cfg.arch_id}] refusals as in the reference: " + "; ".join(out))
    return out


def family_long(dev, engine) -> dict:
    """gemma2's 1 x FAMILY_LONG prompt, past its 4096-token window, then
    FAMILY_LONG["steps"] decode steps fed the kernels' greedy tokens on the
    contiguous cache and on the paged pool, each step's logits against the
    plain versions'; and the prefill under blockwise_attention (the flash
    kernel with the window and the cap, once a layer) against its plain
    version."""
    cfg, model, params = engine.cfg, engine.model, engine.params
    n, steps = FAMILY_LONG["prompt_len"], FAMILY_LONG["steps"]
    cache_len = -(-(n + steps) // 8) * 8           # whole blocks of 8 for the pool
    rng = np.random.default_rng(SERVE["seed"] + 1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, n)),
                                       device=dev)}
    errs = {"prefill": [], "contiguous": [], "paged": [], "blockwise": []}
    launches = {}
    with torch.inference_mode():
        _reset_launches()
        lk, ck = model.prefill(params, batch, cache_len)
        launches["prefill"] = _launches()
        with ops.impl_scope("plain"):
            lp, cp = model.prefill(params, batch, cache_len)
        errs["prefill"].append(_check_logits("gemma2 long prefill", lk, lp))
        pk, table = contiguous_to_paged({k: v.clone() for k, v in ck.items()}, 8)
        pp, _ = contiguous_to_paged({k: v.clone() for k, v in cp.items()}, 8)
        tok = lk.argmax(-1)
        toks = []
        _reset_launches()
        for i in range(steps):
            pos = n + i
            gk, ck = model.decode(params, tok, ck, pos)
            with ops.impl_scope("plain"):
                gp, cp = model.decode(params, tok, cp, pos)
            errs["contiguous"].append(_check_logits(f"gemma2 long decode step {i}", gk, gp))
            tok = gk.argmax(-1)
            toks.append(int(tok[0]))
        launches["decode"] = _launches()
        tok = lk.argmax(-1)
        posv = torch.full((1,), n, device=dev, dtype=torch.long)
        _reset_launches()
        for i in range(steps):
            gk, pk = model.decode_paged(params, tok, pk, table, posv + i)
            with ops.impl_scope("plain"):
                gp, pp = model.decode_paged(params, tok, pp, table, posv + i)
            errs["paged"].append(_check_logits(f"gemma2 long paged step {i}", gk, gp))
            tok = gk.argmax(-1)
        launches["decode_paged"] = _launches()
        if launches["decode_paged"].get("paged_attn") != cfg.num_layers * steps:
            raise AssertionError(f"gemma2 long paged decode launched {launches['decode_paged']}")
        with flags.overrides(blockwise_attention=True):
            fkern.reset_launches()
            _reset_launches()
            lf, _ = model.prefill(params, batch, cache_len)
            launches["blockwise_prefill"] = {**_launches(), "flash_attn":
                                             fkern.LAUNCHES["flash_attn"]}
            with ops.impl_scope("plain"):
                lfp, _ = model.prefill(params, batch, cache_len)
        errs["blockwise"].append(_check_logits("gemma2 long blockwise prefill", lf, lfp))
        if fkern.LAUNCHES["flash_attn"] != cfg.num_layers:
            raise AssertionError(f"gemma2 long blockwise prefill: {fkern.LAUNCHES}")
    local = sum(_layer_windows(cfg))
    out = {"prompt_len": n, "steps": steps, "max_rel_err": {k: max(v) for k, v in errs.items()},
           "launches": launches, "tokens": toks, "local_layers": local,
           "keys_masked_last_step": n + steps - 1 - (cfg.sliding_window - 1)}
    log(f"[families gemma2-2b] 1 x {n} prompt, {steps} decode steps: kernel vs plain logits "
        + ", ".join(f"{k} {v:.3e}" for k, v in out["max_rel_err"].items())
        + f" (tol {LOGIT_TOL}); its {local} local layers mask the "
        f"{out['keys_masked_last_step']} oldest keys at the last step; launches {launches} "
        f"[{CARD['smi']}]")
    return out


def patch_batch(cfg, seed: int = 0) -> dict:
    """One FAMILY_PATCH_PROMPT-token prompt whose first num_frontend_tokens
    positions are patch embeddings, N(0, 1) as the reference's
    ``smoke_batch`` draws them, from ``SERVE["seed"] + 2 + seed``."""
    rng = np.random.default_rng(SERVE["seed"] + 2 + seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(1, FAMILY_PATCH_PROMPT)),
            "patch_embeds": rng.normal(size=(1, cfg.num_frontend_tokens, cfg.d_model)
                                       ).astype(np.float32)}


@contextlib.contextmanager
def projections_as(fn, attention=None):
    """Every quantized projection inside the block runs ``fn(qmm, x, w)``,
    ``qmm`` being ops.quantized_matmul itself, and with ``attention`` every
    flash attention call ``attention(fa, q, k, v, **kw)``, ``fa`` being
    ops.flash_attention (both restored on exit)."""
    qmm, fa = ops.quantized_matmul, ops.flash_attention
    ops.quantized_matmul = lambda x, w, *, impl=None, xq=None: fn(qmm, x, w)
    if attention is not None:
        ops.flash_attention = lambda q, k, v, *, impl=None, **kw: attention(fa, q, k, v, **kw)
    try:
        yield
    finally:
        ops.quantized_matmul, ops.flash_attention = qmm, fa


def check_flash(name, got, q, k, v, **kw) -> tuple[float, float]:
    """Flash attention's output against flash_attention_ref on the f32 of
    the same inputs, within phase 2's FLASH_TOL of max|ref| (raises):
    (max |err|, tol)."""
    want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    err = (got.float() - want).abs().max().item()
    tol = FLASH_TOL[q.dtype] * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({err:.3e} > {tol:.3e})")
    return err, tol


def prefill_logits(engine, batch, mode: str = "kernel", counts: dict | None = None,
                   flash_errs: list | None = None) -> torch.Tensor:
    """A prefill's logits, its kernels run as ``mode`` says: "kernel";
    "plain"; "checked" (each projection's and flash attention call's kernel,
    its output held to the plain version on the same input by
    ``check_close`` / ``check_flash``); "shadow" (the plain versions'
    outputs, each kernel launched beside on the same input and dropped: any
    effect a kernel has outside its output shows); "ulp" (the plain
    versions', layer 0's first projection output moved one f32 ulp up: how
    far the model carries a rounding-sized change). The last three run
    every other op plain. ``counts`` gets the calls by kind, and
    ``flash_errs`` each checked flash call's (max |err|, tol, causal)."""
    calls = collections.Counter()

    def run(qmm, x, w):
        i = calls["projections"]
        calls["projections"] += 1
        if mode == "checked":
            y = qmm(x, w, impl="cuda")
            check_close(f"projection call {i} x {tuple(x.shape)} w {tuple(w.shape)}", y,
                        qmm(x, w, impl="plain"), w.fmt)
            return y
        want = qmm(x, w, impl="plain")
        if mode == "shadow":
            qmm(x, w, impl="cuda")
        elif mode == "ulp" and i == 0:
            want = torch.nextafter(want, torch.full_like(want, float("inf")))
        return want

    def attend(fa, q, k, v, **kw):
        i = calls["flash_attention"]
        calls["flash_attention"] += 1
        if mode == "checked":
            y = fa(q, k, v, impl="cuda", **kw)
            err, tol = check_flash(f"flash attention call {i} q {tuple(q.shape)} k "
                                   f"{tuple(k.shape)}", y, q, k, v, **kw)
            if flash_errs is not None:
                flash_errs.append((err, tol, kw.get("causal", True)))
            return y
        if mode == "shadow":
            fa(q, k, v, impl="cuda", **kw)
        return fa(q, k, v, impl="plain", **kw)

    with torch.inference_mode():
        if mode == "kernel":
            return engine.prefill(batch)[0].float()
        with ops.impl_scope("plain"):
            if mode == "plain":
                return engine.prefill(batch)[0].float()
            with projections_as(run, attend):
                out = engine.prefill(batch)[0].float()
    if counts is not None:
        counts.update(calls)
    return out


def family_patches(dev, engine) -> dict:
    """pixtral's prefill of a patch-embedding prompt (``patch_batch``),
    kernels against the plain versions. The end-to-end logits are not held
    to LOGIT_TOL here: on this prompt the model carries a one-ulp change of
    layer 0's first projection to ~5e-2 of max|logit| (``tests/
    trace_torch_families.py``; ROADMAP Queue C), the tolerance itself. So
    ``hold_per_kernel``'s rule holds it, and the patch embeddings must
    reach the logits."""
    cfg = engine.cfg
    batch = patch_batch(cfg)
    _reset_launches()
    lk = prefill_logits(engine, batch)
    launches = _launches()
    lp = prefill_logits(engine, batch, "plain")
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("pixtral patch prefill: non-finite logits")
    err = _rel_err(lk, lp)
    held = hold_per_kernel("pixtral-12b patch prefill", engine, batch, lp, err)
    with torch.inference_mode():
        text_only, _ = engine.prefill({"tokens": batch["tokens"]})
    moved = _rel_err(text_only, lk)
    if not moved > 0:
        raise AssertionError("pixtral: the patch embeddings did not reach the logits")
    log(f"[families pixtral-12b] prefill 1 x {FAMILY_PATCH_PROMPT}, the first "
        f"{cfg.num_frontend_tokens} positions patch embeddings: logits kernel vs plain "
        f"{err:.3e}, plain vs plain with one ulp moved {held['ulp_rel_err']:.3e} (of "
        f"max|logit|); the text-only prompt's logits differ by {moved:.3e}; launches {launches}")
    return {"logit_rel_err": err, "ulp_rel_err": held["ulp_rel_err"],
            "text_only_rel_diff": moved, "launches": launches}


def phase_families(dev) -> dict:
    """Phase 8 (module docstring): each family at its FAMILIES depth."""
    out = {}
    for arch in FAMILIES:
        t0 = time.perf_counter()
        cfg = family_config(arch)
        model = build(cfg)
        params = model.init(seed=SERVE["seed"], device=dev)
        engine = InferenceEngine(model, params, quantize=True, device=dev,
                                 cache_len=SERVE["prompt_len"] + SERVE["max_new_tokens"]
                                 + SPEC["k"])
        del params
        torch.cuda.synchronize()
        cut = ("" if FAMILIES[arch] is None else
               f"depth cut to {cfg.num_layers} of {load_config(arch).num_layers} layers "
               f"({FAMILY_CUT_REASONS[arch]}), ")
        log(f"[families {arch}] full width d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
            f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
            f"{cut}{cfg.num_layers} layers, {cfg.param_dtype}, int8 weights")
        res = family_generate(dev, engine, arch)
        if arch in FAMILY_FULL:
            res.update(family_ragged_and_spec(dev, engine, res, arch))
        if arch == FAMILY_LONG["arch"]:
            res["long"] = family_long(dev, engine)
        if cfg.frontend == "patch_embed":
            res["patches"] = family_patches(dev, engine)
        res.pop("batch")
        res.update({"layers": cfg.num_layers, "full_layers": load_config(arch).num_layers,
                    "seconds": time.perf_counter() - t0})
        out[arch] = res
        del engine, model
        torch.cuda.empty_cache()
        log(f"[families {arch}] {res['seconds']:.1f} s")
    out["goldens"] = family_goldens(dev, [a for a in FAMILY_GOLDEN["archs"]
                                          if a not in (*RECURRENT_ARCHS, ENCDEC_ARCH)])
    return out


def golden_tree(arch: str) -> tuple[dict, str]:
    """The golden's numpy weights (init_params_numpy) and their checksum."""
    tree = init_params_numpy(family_golden_config(arch), FAMILY_GOLDEN["seed"])
    return tree, weights_checksum(tree)


def family_goldens(dev, archs, drawn=None, hold_logits: bool = False) -> dict:
    """The goldens of ``archs`` (golden_<arch>.json): full width, 2 layers
    (zamba2 7), f32, weights by init_params_numpy (``drawn``: futures of
    ``golden_tree`` by arch, drawn beside earlier work); greedy tokens with
    f32 and int8 weights must equal the reference's (the rule of
    TinyLlama's 2-layer golden); where the port's own CPU run was not
    exact, the reference's tokens replayed must each be the card's choice
    or within TIE_MARGIN. With ``hold_logits``, the quantized model's
    first-step logits, kernels against plain, within LOGIT_TOL too (at this
    depth a rounding-sized change stays small: the end-to-end check that
    full depth cannot give)."""
    out = {}
    fg = FAMILY_GOLDEN
    for arch in archs:
        path = family_golden_file(arch)
        golden = json.loads(path.read_text())
        for k, v in family_golden_settings(arch).items():
            if golden[k] != v:
                raise AssertionError(f"{path.name}: {k}={golden[k]!r}, this script uses {v!r}")
        cfg = family_golden_config(arch)
        tree, checksum = drawn.pop(arch).result() if drawn else golden_tree(arch)
        if checksum != golden["weights_checksum"]:
            raise AssertionError(f"{arch}: numpy drew other weights than the golden run")
        prompt = family_golden_prompt(cfg.vocab_size)
        if prompt.tolist() != golden["prompt"]:
            raise AssertionError(f"{arch}: golden prompt differs")
        extra = {k: torch.as_tensor(v) for k, v in family_golden_extra(cfg).items()}
        params = params_from_numpy(tree, dev)
        del tree
        total = fg["batch"] * fg["max_new_tokens"]
        res = {}
        for setting in fg["settings"]:
            eng = InferenceEngine(build(cfg), params, device=dev,
                                  quantize=False if setting == "float32" else setting,
                                  cache_len=fg["prompt_len"] + fg["max_new_tokens"])
            got = eng.generate({"tokens": torch.as_tensor(prompt), **extra},
                               fg["max_new_tokens"]).tokens.tolist()
            want = golden["tokens"][setting]
            same = sum(a == b for ra, rb in zip(got, want) for a, b in zip(ra, rb))
            off = [] if got == want else replay_choices(eng, prompt, np.asarray(want), extra)
            cpu = golden["port_cpu_equal"][setting]
            res[setting] = {"tokens_equal": same, "tokens_total": total, "cpu_tokens_equal": cpu,
                            "replay_differs": off}
            held = ""
            if hold_logits and setting != "float32":
                batch = {"tokens": torch.as_tensor(prompt), **extra}
                err = _rel_err(prefill_logits(eng, batch), prefill_logits(eng, batch, "plain"))
                if not err <= LOGIT_TOL:
                    raise AssertionError(f"{arch} golden model ({setting}): first-step logits "
                                         f"kernel vs plain {err:.3e} (tol {LOGIT_TOL})")
                res[setting]["logit_rel_err"] = err
                held = f"; first-step logits kernel vs plain {err:.3e} (tol {LOGIT_TOL})"
            log(f"[families golden] {arch} d {cfg.d_model} x {cfg.num_layers} layers f32, "
                f"{setting} weights: {same}/{total} tokens equal the reference's (the port's "
                f"CPU run: {cpu}/{total})"
                + "".join(f"; step {o['step']} row {o['row']}: margin {o['margin']:.2e}"
                          for o in off) + held)
            if got != want and (cpu == total or any(o["margin"] > TIE_MARGIN for o in off)):
                raise AssertionError(f"{arch} golden ({setting}) tokens differ:\n port {got}\n"
                                     f"  ref {want}\n replayed {off}")
            del eng
        out[arch] = res
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the recurrent families at full width
# ---------------------------------------------------------------------------

def recurrent_projections() -> list[tuple[str, int, int, int]]:
    """(name, m, n, GS) of each distinct quantized weight shape of the two
    recurrent configs (``bounds.layer_projections``; rwkv6's six d x d
    matrices are one shape), the classifier (vocab_padded rows) included."""
    out = []
    for arch in RECURRENT_ARCHS:
        cfg = load_config(arch)
        shapes: dict[tuple[int, int], list[str]] = {}
        for name, m, n, _ in bounds.layer_projections(cfg):
            shapes.setdefault((m, n), []).append(name.replace("shared ", "shared-"))
        shapes.setdefault((cfg.vocab_padded, cfg.d_model), []).append("classifier")
        out += [(f"{arch} {'/'.join(names)}", m, n, bounds.group_size(cfg, n))
                for (m, n), names in shapes.items()]
    return out


def phase_recurrent_kernels(dev) -> tuple[list[dict], list[dict]]:
    """(a) The int8 GQMM at RECURRENT_KERNEL_BATCHES and the int8 GQMV at
    every projection shape of rwkv6 and zamba2, timed beside their bounds
    and plain versions; int4, int3 and fp8 GQMM at RECURRENT_CHECKED_B,
    checked; B4 bf16 at RECURRENT_FLASH, the shape zamba2's blockwise
    prefill gives it, SDPA beside it. Phase 2's tolerances."""
    gen = torch.Generator(device=dev).manual_seed(14)
    rows, checked = [], 0
    for name, m, n, pgs in recurrent_projections():
        fr = _format_rows(gen, dev, name, m, n, pgs, WEIGHT_FORMATS[1:], RECURRENT_CHECKED_B,
                          gqmv=False)
        rows += fr
        checked += len(fr)
        rows += _int8_rows(gen, dev, name, m, n, pgs, RECURRENT_KERNEL_BATCHES,
                           RECURRENT_KERNEL_BATCHES, "recurrent kernels")
    log(f"[recurrent kernels] int4, int3 and fp8 GQMM at b {RECURRENT_CHECKED_B}: {checked} "
        f"cases within phase 2's tolerances")
    return rows, [_flash_row(gen, dev, RECURRENT_FLASH, "recurrent flash")]


def recurrent_trace(vocab_size: int) -> list[Request]:
    rr = RECURRENT_RAGGED
    rng = np.random.default_rng(rr["seed"])
    lens = rng.choice(rr["prompt_lens"], size=rr["requests"])
    budgets = rng.integers(rr["budgets"][0], rr["budgets"][1] + 1, size=rr["requests"])
    return [Request(i, rng.integers(0, vocab_size, size=int(n)).tolist(), max_new=int(k))
            for i, (n, k) in enumerate(zip(lens, budgets))]


def recurrent_ragged(dev, engine, tag: str) -> dict:
    """(c) RECURRENT_RAGGED's requests through serve_ragged in continuous
    mode (the RecurrentAdapter: exact-length admission groups, a prefill
    program per group size and length) and in bucketed mode (generate per
    exact length): a cold pass that captures, then a replayed and an eager
    pass, equal in tokens and launches."""
    rr = RECURRENT_RAGGED
    reqs = recurrent_trace(engine.cfg.vocab_size)
    cache_len = max(len(r.tokens) + r.max_new for r in reqs)
    reng = InferenceEngine(engine.model, engine.params, cache_len=cache_len, device=dev)
    sk = dict(slots=rr["slots"], chunk=rr["chunk"])
    out = {}
    for mode in ("continuous", "bucketed"):
        t0 = time.perf_counter()
        _ragged_pass(reng, reqs, mode, **sk)                   # captures
        cold = time.perf_counter() - t0
        out_r, info = _ragged_pass(reng, reqs, mode, **sk)
        with graphs.eager():
            out_e, info_e = _ragged_pass(reng, reqs, mode, **sk)
        same = all(np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
                   for a, b in zip(out_r, out_e))
        la = {k: v for k, v in info["launches"].items() if v}
        le = {k: v for k, v in info_e["launches"].items() if v}
        if not same or la != le:
            raise AssertionError(f"{tag} ragged {mode}: the eager pass differs from the replayed "
                                 f"one ({le} vs {la})")
        out[mode] = {"replayed": info, "eager": info_e, "cold_s": cold}
        log(f"[recurrent {tag}] ragged {mode} serve, {len(reqs)} requests (prompts "
            f"{sorted({len(r.tokens) for r in reqs})}): {info['tokens']} tokens, "
            f"{info['tok_s']:.1f} tok/s replayed ({info_e['tok_s']:.1f} eager; cold pass "
            f"{cold:.1f} s with its captures), replayed == eager (tokens and launches {la}) "
            f"[{CARD['smi']}]")
    out["captures"] = {k: {f: v[f] for f in ("builds", "captured", "capture_s", "pool_bytes")}
                       for k, v in reng.graphs.stats().items()}
    log(f"[recurrent {tag}] ragged captures: " + ", ".join(
        f"{k} {v['captured']} ({v['capture_s']:.2f} s, {v['pool_bytes'] / 2**20:.0f} MiB)"
        for k, v in sorted(out["captures"].items())))
    return out


def recurrent_refusals(dev, engine, batch) -> list[str]:
    """(f) A recurrent family refuses what the reference refuses, with its
    errors: a paged cache, spec_k (generate and serve), kv_quant, ragged
    lengths=; the model declares no paged or verify hook."""
    model, out = engine.model, []
    lens = torch.full((batch["tokens"].shape[0],), batch["tokens"].shape[1])
    reqs = recurrent_trace(engine.cfg.vocab_size)[:1]
    calls = {"generate(paged=True)": lambda: engine.generate(batch, 2, paged=True),
             "generate(spec_k=4)": lambda: engine.generate(batch, 2, spec_k=SPEC["k"]),
             "generate(lengths=)": lambda: engine.generate(batch, 2, lengths=lens),
             "InferenceEngine(kv_quant='int8')": lambda: InferenceEngine(
                 model, engine.params, cache_len=8, device=dev, kv_quant="int8"),
             "serve_ragged(mode='paged')": lambda: serve_ragged(engine, reqs, 2, mode="paged"),
             "serve_ragged(spec_k=4)": lambda: serve_ragged(engine, reqs, 2, spec_k=SPEC["k"])}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            out.append(f"{name}: {e}")
            continue
        raise AssertionError(f"{engine.cfg.arch_id}: {name} did not raise")
    if model.supports_paged or model.supports_spec or model.supports_lengths or any(
            getattr(model, h) is not None for h in ("init_paged_cache", "decode_paged", "verify",
                                                    "commit_verify", "verify_paged",
                                                    "commit_verify_paged")):
        raise AssertionError(f"{engine.cfg.arch_id}: a recurrent model declares a ragged, "
                             "paged or verify capability")
    log(f"[recurrent {engine.cfg.arch_id}] refusals as in the reference: " + "; ".join(out))
    return out


def recurrent_flags(dev, engine, batch) -> dict:
    """(d) zamba2 under the flags: a prefill under blockwise_attention runs
    the flash kernel once per shared-block application (4 at 27 layers, hd 112), its
    logits against the plain versions' (phase 9's rule: LOGIT_TOL, else
    ``hold_per_kernel``, which holds the flash calls too);
    generate under deferred decode, the kvt layout and int8_kv_cache
    replayed == an eager loop (tokens and launches), the shared cache kvt
    and float."""
    cfg = engine.cfg
    groups = cfg.num_layers // cfg.shared_attn_every
    new = SERVE["max_new_tokens"]
    fname = fkern.kernel_name(cfg.cdtype())             # the tensor-core kernel at bf16
    with flags.overrides(blockwise_attention=True):
        with torch.inference_mode():
            (logits_k, _), fl, gq = _flash_launches(lambda: engine.prefill(batch))
        if fl != {fname: groups}:
            raise AssertionError(f"zamba2 blockwise prefill: flash launches {fl}, expected "
                                 f"{groups} of {fname}")
        err, rule = _check_family_logits("zamba2-7b blockwise prefill", engine, batch,
                                         logits_k.float(), prefill_logits(engine, batch, "plain"))
    with flags.overrides(**RECURRENT_FLAGS):
        engine.generate(batch, 2)                               # captures
        _reset_launches()
        res = engine.generate(batch, new)
        launches = _launches()
        _reset_launches()
        eager, _, _ = step_loop(engine, batch, new)
        le = _launches()
        cache = engine.graphs.last["generate.decode"].inputs["cache"]
    if not torch.equal(eager, res.tokens) or le != launches:
        raise AssertionError(f"zamba2 under {RECURRENT_FLAGS}: replayed tokens/launches differ "
                             f"from the eager loop's ({le} vs {launches})")
    sk = cache["shared_k"]
    if sk.dtype != cfg.cdtype() or tuple(sk.shape[2:4]) != (cfg.num_kv_heads,
                                                             engine.cache_len):
        raise AssertionError(f"zamba2 shared cache under the flags: {sk.dtype} {tuple(sk.shape)}, "
                             "expected the kvt layout in floats")
    log(f"[recurrent zamba2-7b] blockwise prefill: {fname} x {fl[fname]} (hd "
        f"{cfg.resolved_head_dim}), logits vs plain {err:.3e}; generate under "
        f"{sorted(RECURRENT_FLAGS)}: replayed == eager (tokens and launches {launches}), shared "
        f"cache {str(sk.dtype).removeprefix('torch.')} {tuple(sk.shape)} [{CARD['smi']}]")
    return {"blockwise_launches": {**fl, **gq}, "blockwise_logit_rel_err": err,
            "blockwise_logit_rule": rule, "launches": launches,
            "shared_cache": [str(sk.dtype), list(sk.shape)]}


def recurrent_chunked(dev, engine, ulp: float | None) -> dict:
    """(e) zamba2's first Mamba2 layer over 1 x 512 tokens with the chunked
    SSD (chunk 128) against the sequential scan, on the card: y and the
    final state h within RECURRENT_CHUNKED's tolerances (its comment says
    why); then the whole 1 x 512 prefill in both forms, finite, its logits
    printed beside the model's one-ulp sensitivity ``ulp``, both prefills
    timed on the host clock."""
    rc = RECURRENT_CHUNKED
    cfg = engine.cfg
    ceng = InferenceEngine(engine.model, engine.params, cache_len=rc["s"], device=dev)
    rng = np.random.default_rng(SERVE["seed"] + 5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(rc["b"], rc["s"])),
                             device=dev)
    lp = tree_index(tree_index(ceng.params["mamba_layers"], 0), 0)
    chunked = {"chunked_ssd": True, "ssd_chunk": rc["chunk"]}
    layer, times, logits = {}, {}, {}
    for form, kw in (("sequential", {}), ("chunked", chunked)):
        with flags.overrides(**kw), torch.inference_mode():
            x = embedding_lookup(ceng.params["embed"], tokens, cfg.cdtype())
            layer[form] = ssm.mamba2_forward(lp["mamba"], rmsnorm(x, lp["norm"], cfg.norm_eps),
                                             cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[form], _ = ceng.prefill({"tokens": tokens})
            torch.cuda.synchronize()
            times[form] = time.perf_counter() - t0
    y_err = _rel_err(layer["chunked"][0], layer["sequential"][0])
    h_err = _rel_err(layer["chunked"][1][1], layer["sequential"][1][1])
    err = _rel_err(logits["chunked"], logits["sequential"])
    if not (y_err <= rc["y_tol"] and h_err <= rc["h_tol"]
            and bool(torch.isfinite(logits["chunked"]).all())):
        raise AssertionError(f"zamba2 chunked SSD: layer 0's y {y_err:.3e} (tol {rc['y_tol']}), "
                             f"h {h_err:.3e} (tol {rc['h_tol']}) from the sequential scan's, or "
                             "non-finite logits")
    log(f"[recurrent zamba2-7b] {rc['b']} x {rc['s']}, chunked SSD (chunk {rc['chunk']}) vs the "
        f"sequential scan: layer 0 y {y_err:.3e} (tol {rc['y_tol']}), h {h_err:.3e} (tol "
        f"{rc['h_tol']}) of max; the whole prefill's logits {err:.3e} of max|logit| (one f32 "
        f"ulp moves the model's logits {ulp if ulp is not None else float('nan'):.3e}); "
        f"eager wall {times['chunked']:.2f} s chunked, {times['sequential']:.2f} s sequential "
        f"[{CARD['smi']}]")
    return {"layer0_y_rel_err": y_err, "layer0_h_rel_err": h_err, "logit_rel_err": err,
            "seconds": times}


def recurrent_config(arch: str):
    cfg, layers = load_config(arch), RECURRENT_LAYERS[arch]
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def recurrent_gqmm_per_step(cfg) -> int:
    """GQMM launches a decode step: rwkv6 8 a layer + the classifier (257 at
    32 layers); zamba2 2 a Mamba2 layer, 4 a shared-block application + the
    classifier (215 at 81 layers, 13 applications)."""
    if cfg.model_type == "rwkv6":
        return 8 * cfg.num_layers + 1
    return 2 * cfg.num_layers + 4 * (cfg.num_layers // cfg.shared_attn_every) + 1


def phase_recurrent(dev) -> tuple[dict, list[dict], list[dict]]:
    """Phase 9 (module docstring): (a) the kernels at the new shapes, then
    each recurrent family at RECURRENT_LAYERS: (b) generate, (c) the
    ragged serve, (f) the refusals, zamba2's (d) flags and (e) chunked SSD;
    (g) the goldens."""
    t_start = time.perf_counter()
    golden_archs = [a for a in FAMILY_GOLDEN["archs"] if a in RECURRENT_ARCHS]
    # (g)'s numpy draws and hashes (~1 G values each) run on host threads
    # beside (a)-(f)'s work on the card; numpy and hashlib release the GIL
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(golden_archs))
    drawn = {a: pool.submit(golden_tree, a) for a in golden_archs}
    pool.shutdown(wait=False)
    krows, frows = phase_recurrent_kernels(dev)
    out = {"kernels_s": time.perf_counter() - t_start}
    for arch in RECURRENT_ARCHS:
        t0 = time.perf_counter()
        cfg, full = recurrent_config(arch), load_config(arch)
        model = build(cfg)
        params = model.init(seed=SERVE["seed"], device=dev)
        engine = InferenceEngine(model, params, quantize=True, device=dev,
                                 cache_len=SERVE["prompt_len"] + SERVE["max_new_tokens"]
                                 + SPEC["k"])
        del params
        torch.cuda.synchronize()
        log(f"[recurrent {arch}] full width d {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, {cfg.num_layers} of {full.num_layers} layers"
            + (f" (depth cut: {RECURRENT_CUT_REASON})" if cfg.num_layers < full.num_layers
               else "") + f", {cfg.param_dtype}, int8 weights, "
            f"state {bounds.recurrent_state_bytes(cfg, SERVE['batch']) / 2 / 1e6:.1f} MB at b "
            f"{SERVE['batch']}")
        res = family_generate(dev, engine, arch, prefix="recurrent")
        got, want = res["per_pass"].get("gqmm_int8"), recurrent_gqmm_per_step(cfg)
        if got != want:
            raise AssertionError(f"{arch}: {got} GQMMs a decode step, expected {want}")
        res["ragged"] = recurrent_ragged(dev, engine, arch)
        res["refusals"] = recurrent_refusals(dev, engine, res["batch"])
        if arch == "zamba2-7b":
            res["flags"] = recurrent_flags(dev, engine, res["batch"])
            ulp = res["logit_rule"].get("ulp_rel_err")
            res["chunked"] = recurrent_chunked(dev, engine, ulp)
        res.pop("batch")
        res.update({"layers": cfg.num_layers, "seconds": time.perf_counter() - t0})
        out[arch] = res
        del engine, model
        torch.cuda.empty_cache()
        log(f"[recurrent {arch}] {res['seconds']:.1f} s")
    t0 = time.perf_counter()
    out["goldens"] = family_goldens(dev, golden_archs, drawn, hold_logits=True)
    out["goldens_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_start
    log(f"[recurrent] phase 9 took {out['seconds']:.1f} s (budget {RECURRENT_BUDGET_S} s; "
        f"kernels {out['kernels_s']:.1f}, goldens {out['goldens_s']:.1f})")
    return out, krows, frows


def recurrent_runs(rec: dict) -> dict[str, dict[str, int]]:
    """Phase 9's launch counts by run (each counted from 0 just before it)."""
    runs = {}
    for arch in RECURRENT_ARCHS:
        r = rec[arch]
        runs[f"phase 9 {arch} generate"] = r["launches"]
        for mode in ("continuous", "bucketed"):
            runs[f"phase 9 {arch} ragged {mode}"] = r["ragged"][mode]["replayed"]["launches"]
        if "flags" in r:
            runs[f"phase 9 {arch} blockwise prefill"] = r["flags"]["blockwise_launches"]
            runs[f"phase 9 {arch} generate under the KV flags"] = r["flags"]["launches"]
    return runs


def recurrent_summary(rec: dict, smi: str) -> None:
    for arch in RECURRENT_ARCHS:
        r = rec[arch]
        rg = r["ragged"]
        log(f"[recurrent] {arch}: {r['layers']} layers; decode b="
            f"{SERVE['batch']} {r['decode_ms_wall']:.3f} ms/step wall, {r['decode_ms_device']:.3f} "
            f"on the card ({100 * r['busy_share']:.1f} % busy), {r['kernels_per_step']} kernels "
            f"a step, GQMM {r['gqmm_ms_per_step']:.3f} ms; bytes a step "
            f"{r['weight_bytes_per_step'] / 1e9:.3f} GB (state "
            f"{r['state_bytes_per_step'] / 1e9:.3f}), HBM bound {r['bytes_bound_ms']:.3f} ms; "
            f"ragged continuous {rg['continuous']['replayed']['tok_s']:.1f} tok/s, bucketed "
            f"{rg['bucketed']['replayed']['tok_s']:.1f}; {r['seconds']:.1f} s [{smi}]")


# ---------------------------------------------------------------------------
# phase 10: the encoder-decoder at full width
# ---------------------------------------------------------------------------

def encdec_projections() -> list[tuple[str, int, int, int]]:
    """(name, m, n, GS) of each distinct quantized weight shape of the
    encoder-decoder (``bounds.layer_projections``: wqkv 3072 x 1024; wo and
    the cross wq / wo 1024 x 1024; cross wkv 2048 x 1024; w13; w2), the
    classifier (vocab_padded rows) included."""
    cfg = load_config(ENCDEC_ARCH)
    shapes: dict[tuple[int, int], list[str]] = {}
    for name, m, n, _ in bounds.layer_projections(cfg):
        names = shapes.setdefault((m, n), [])
        short = name.split(" ", 1)[1].replace("cross ", "cross-")
        if short not in names:
            names.append(short)
    shapes.setdefault((cfg.vocab_padded, cfg.d_model), []).append("classifier")
    return [(f"seamless {'/'.join(names)}", m, n, bounds.group_size(cfg, n))
            for (m, n), names in shapes.items()]


def phase_encdec_kernels(dev) -> tuple[list[dict], list[dict]]:
    """(a) The int8 GQMM at ENCDEC_KERNEL_BATCHES and the int8 GQMV at every
    projection shape, timed beside their bounds and plain versions; int4,
    int3 and fp8 GQMM at ENCDEC_CHECKED_B, checked; B4 bf16 at the
    encoder's non-causal and the decoder prompt's causal shape, SDPA beside
    it. Phase 2's tolerances."""
    gen = torch.Generator(device=dev).manual_seed(15)
    rows, checked = [], 0
    for name, m, n, pgs in encdec_projections():
        fr = _format_rows(gen, dev, name, m, n, pgs, WEIGHT_FORMATS[1:], ENCDEC_CHECKED_B,
                          gqmv=False)
        rows += fr
        checked += len(fr)
        rows += _int8_rows(gen, dev, name, m, n, pgs, ENCDEC_KERNEL_BATCHES,
                           ENCDEC_KERNEL_BATCHES, "encdec kernels")
    log(f"[encdec kernels] int4, int3 and fp8 GQMM at b {ENCDEC_CHECKED_B}: {checked} cases "
        f"within phase 2's tolerances")
    return rows, [_flash_row(gen, dev, case, "encdec flash", causal=causal)
                  for case, causal in ENCDEC_FLASH]


def encdec_batch(cfg, dev) -> dict:
    """SERVE's decoder prompt (numpy, seeded) and ENCDEC's frames (a
    torch.Generator on the card, seeded), N(0, 1) f32."""
    b = SERVE["batch"]
    rng = np.random.default_rng(ENCDEC["seed"])
    gen = torch.Generator(device=dev).manual_seed(ENCDEC["seed"])
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   size=(b, SERVE["prompt_len"]))),
            "frames": torch.randn((b, ENCDEC["s_enc"], cfg.d_model), generator=gen,
                                  device=dev)}


def encdec_blockwise(dev, engine, batch) -> dict:
    """Under blockwise_attention: the prefill runs B4 once an encoder layer
    (non-causal) and once a decoder layer (the prompt, causal), 48 in all;
    every flash call (and projection) of a checked prefill held to its
    plain version on the same input, each call's error printed; the
    logits kernel vs plain by the families' rule; generate replayed ==
    eager (tokens and launches)."""
    cfg = engine.cfg
    new = SERVE["max_new_tokens"]
    fname = fkern.kernel_name(cfg.cdtype())
    want_fl = cfg.encoder_layers + cfg.num_layers
    with flags.overrides(blockwise_attention=True):
        with torch.inference_mode():
            (logits_k, _), fl, gq = _flash_launches(lambda: engine.prefill(batch))
        if fl != {fname: want_fl}:
            raise AssertionError(f"seamless blockwise prefill: flash launches {fl}, expected "
                                 f"{want_fl} of {fname}")
        flash: list = []
        prefill_logits(engine, batch, "checked", flash_errs=flash)
        causal = [c for _, _, c in flash]
        if causal != [False] * cfg.encoder_layers + [True] * cfg.num_layers:
            raise AssertionError(f"seamless blockwise prefill: checked flash calls {causal}")
        log_flash_errors("seamless blockwise prefill", flash)
        err, rule = _check_family_logits("seamless blockwise prefill", engine, batch,
                                         logits_k.float(), prefill_logits(engine, batch, "plain"))
        engine.generate(batch, 2)                               # captures
        _reset_launches()
        fkern.reset_launches()
        res = engine.generate(batch, new)
        launches = {**_launches(), **{k: v for k, v in fkern.LAUNCHES.items() if v}}
        _reset_launches()
        fkern.reset_launches()
        eager, _, _ = step_loop(engine, batch, new)
        le = {**_launches(), **{k: v for k, v in fkern.LAUNCHES.items() if v}}
    if not torch.equal(eager, res.tokens) or le != launches:
        raise AssertionError(f"seamless under blockwise_attention: replayed tokens/launches "
                             f"differ from the eager loop's ({le} vs {launches})")
    if launches.get(fname) != want_fl:
        raise AssertionError(f"seamless generate under blockwise_attention: {launches}")
    log(f"[encdec] blockwise prefill: {fname} x {fl[fname]} ({cfg.encoder_layers} non-causal, "
        f"{cfg.num_layers} causal; hd {cfg.resolved_head_dim}), each held within FLASH_TOL "
        f"(largest share of its tolerance {max(e / t for e, t, _ in flash):.2f}), logits vs "
        f"plain {err:.3e}; generate under it replayed == eager (tokens and launches {launches}) "
        f"[{CARD['smi']}]")
    return {"blockwise_launches": {**fl, **gq}, "flash_errors": flash,
            "blockwise_logit_rel_err": err, "blockwise_logit_rule": rule, "launches": launches,
            "tokens": res.tokens.tolist()}


def encdec_refusals(dev, engine, batch) -> list[str]:
    """The encoder-decoder refuses what the reference refuses or fails on:
    serve_ragged (bucketed: a request carries no frames), a paged cache,
    spec_k, ragged lengths=, kv_quant (ValueError), and the kvt and int8
    KV-cache flags (NotImplementedError); the model declares no ragged,
    paged, verify or slot capability."""
    model, out = engine.model, []
    lens = torch.full((batch["tokens"].shape[0],), batch["tokens"].shape[1])
    reqs = [Request(0, batch["tokens"][0, :8].tolist())]
    calls = {"serve_ragged": (ValueError, lambda: serve_ragged(engine, reqs, 2)),
             "generate(paged=True)": (ValueError, lambda: engine.generate(batch, 2, paged=True)),
             "generate(spec_k=4)": (ValueError, lambda: engine.generate(batch, 2, spec_k=4)),
             "generate(lengths=)": (ValueError, lambda: engine.generate(batch, 2, lengths=lens)),
             "InferenceEngine(kv_quant='int8')": (ValueError, lambda: InferenceEngine(
                 model, engine.params, cache_len=8, device=dev, kv_quant="int8"))}
    for flag in ("kvt_cache_layout", "int8_kv_cache"):
        def under(flag=flag):
            with flags.overrides(**{flag: True}):
                engine.generate(batch, 2)
        calls[f"generate under {flag}"] = (NotImplementedError, under)
    for name, (exc, call) in calls.items():
        try:
            call()
        except exc as e:
            out.append(f"{name}: {type(e).__name__}: {e}")
            continue
        raise AssertionError(f"seamless: {name} did not raise {exc.__name__}")
    if model.supports_paged or model.supports_spec or model.supports_lengths or \
            model.cache_kind != "none" or any(getattr(model, h) is not None for h in (
                "init_paged_cache", "decode_paged", "verify", "commit_verify", "verify_paged",
                "commit_verify_paged", "insert_slots", "gather_slots")):
        raise AssertionError("seamless: the model declares a ragged, paged, verify or slot "
                             "capability")
    log("[encdec] refusals as in the reference: " + "; ".join(out))
    return out


def phase_encdec(dev) -> tuple[dict, list[dict], list[dict]]:
    """Phase 10 (module docstring): (a) the kernels at the encoder-decoder's
    shapes; (b) generate at full width and every layer; (c) the prefill and
    generate under blockwise_attention; (d) the refusals; (e) the golden."""
    t_start = time.perf_counter()
    # (e)'s numpy draw and hash (~0.65 G values) run on a host thread
    # beside (a)-(d)'s work on the card
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    drawn = {ENCDEC_ARCH: pool.submit(golden_tree, ENCDEC_ARCH)}
    pool.shutdown(wait=False)
    krows, frows = phase_encdec_kernels(dev)
    out = {"kernels_s": time.perf_counter() - t_start}
    cfg = load_config(ENCDEC_ARCH)
    model = build(cfg)
    params = model.init(seed=ENCDEC["seed"], device=dev)
    engine = InferenceEngine(model, params, quantize=True, device=dev,
                             cache_len=ENCDEC["cache_len"])
    del params
    torch.cuda.synchronize()
    log(f"[encdec] {ENCDEC_ARCH} full width d {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} ({cfg.vocab_padded} rows), {cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, {cfg.param_dtype}, int8 weights; frames "
        f"{SERVE['batch']} x {ENCDEC['s_enc']}, decoder prompt {SERVE['batch']} x "
        f"{SERVE['prompt_len']}")
    batch = encdec_batch(cfg, dev)
    res = family_generate(dev, engine, ENCDEC_ARCH, prefix="encdec", batch=batch)
    for path, key in (("decode", "per_pass"), ("prefill", "prefill_pass")):
        if res[key] != {"gqmm_int8": ENCDEC_GQMM[path]}:
            raise AssertionError(f"seamless: GQMM launches a {path} {res[key]}, expected "
                                 f"{ENCDEC_GQMM[path]}")
    cache = engine.graphs.last["generate.prefill"].inputs["cache"]
    if cache["cross_k"].shape[2] != ENCDEC["s_enc"]:
        raise AssertionError(f"seamless: the static cross cache holds "
                             f"{cache['cross_k'].shape[2]} rows, not the frames' "
                             f"{ENCDEC['s_enc']}")
    res["prefill_ms"] = encdec_prefill_time(engine)
    res.pop("batch")
    res["blockwise"] = encdec_blockwise(dev, engine, batch)
    res["refusals"] = encdec_refusals(dev, engine, batch)
    out.update(res, layers=(cfg.encoder_layers, cfg.num_layers))
    del engine, model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["goldens"] = family_goldens(dev, [ENCDEC_ARCH], drawn, hold_logits=True)
    out["goldens_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_start
    log(f"[encdec] phase 10 took {out['seconds']:.1f} s (budget {ENCDEC_BUDGET_S} s; kernels "
        f"{out['kernels_s']:.1f}, golden {out['goldens_s']:.1f})")
    return out, krows, frows


def encdec_prefill_time(engine) -> dict:
    """The captured prefill (encoder 4 x 512, decoder prompt 4 x 64): wall
    ms of one replay (host clock, synchronised) and device ms (CUDA events
    around back-to-back replays)."""
    prog = engine.graphs.last["generate.prefill"]
    prog.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog.replay()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    dev_ms = replay_events_ms(prog, lambda: None, 4)
    log(f"[encdec] prefill (encoder {SERVE['batch']} x {ENCDEC['s_enc']}, decoder "
        f"{SERVE['batch']} x {SERVE['prompt_len']}) replayed {wall:.3f} ms wall, {dev_ms:.3f} "
        f"on the card [{CARD['smi']}]")
    return {"wall": wall, "device": dev_ms}


def encdec_runs(enc: dict) -> dict[str, dict[str, int]]:
    """Phase 10's launch counts by run (each counted from 0 just before it)."""
    return {"phase 10 generate": enc["launches"],
            "phase 10 blockwise prefill": enc["blockwise"]["blockwise_launches"],
            "phase 10 generate under blockwise_attention": enc["blockwise"]["launches"]}


def encdec_summary(enc: dict, smi: str) -> None:
    log(f"[encdec] {ENCDEC_ARCH}: {enc['layers'][0]} + {enc['layers'][1]} layers; decode "
        f"b={SERVE['batch']} "
        f"{enc['decode_ms_wall']:.3f} ms/step wall, {enc['decode_ms_device']:.3f} on the card "
        f"({100 * enc['busy_share']:.1f} % busy), {enc['kernels_per_step']} kernels a step, "
        f"GQMM {enc['gqmm_ms_per_step']:.3f} ms ({ENCDEC_GQMM['decode']} launches); bytes a "
        f"step {enc['weight_bytes_per_step'] / 1e9:.3f} GB (cross K/V "
        f"{enc['cross_kv_bytes_per_step'] / 1e9:.3f}), HBM bound {enc['bytes_bound_ms']:.3f} "
        f"ms; prefill {enc['prefill_ms']['wall']:.3f} ms wall, {enc['prefill_ms']['device']:.3f} "
        f"on the card ({ENCDEC_GQMM['prefill']} GQMMs); {enc['seconds']:.1f} s [{smi}]")


# ---------------------------------------------------------------------------
# phase 11: training at full width
# ---------------------------------------------------------------------------

def _sdpa_bwd_ms(q, k, v, do, b: int, h: int, kv: int, causal: bool, iters: int) -> float:
    """Device ms of scaled_dot_product_attention's backward (GQA) on the
    same (b, heads, s, hd) inputs: the library call for dQ, dK, dV."""
    F = torch.nn.functional
    s, hd = q.shape[1], q.shape[2]
    q4, k4, v4 = (x.reshape(b, n, s, hd).detach().requires_grad_(True)
                  for x, n in ((q, h), (k, kv), (v, kv)))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, enable_gqa=True)
    do4 = do.reshape(b, h, s, hd)
    ms, _ = device_time_ms(lambda i: torch.autograd.grad(out, (q4, k4, v4), do4,
                                                         retain_graph=True), iters)
    return ms


def train_flash_rows(dev) -> list[dict]:
    """Phase 11 (a): the flash backward against its plain version at every
    TRAIN_FLASH case, f32 and bf16: the forward with the log-sum-exp
    pointer bit-equal to the forward without it, its lse within
    TRAIN_LSE_TOL of the plain version's, dQ, dK, dV within TRAIN_GRAD_TOL
    of max|plain| (the plain backward in f32 on the same values), the same
    bits from a second call (no atomics); timed (CUDA events behind a GPU
    spin) beside its bound from this data's visible pairs, the plain
    version and, without a window or cap, SDPA's backward."""
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for case, dt in itertools.product(TRAIN_FLASH, FLASH_DTYPES):
        name, b, h, kv, s, hd, causal, window, cap = case
        q, do = (torch.randn((b * h, s, hd), generator=gen, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((b * kv, s, hd), generator=gen, device=dev).to(dt) for _ in range(2))
        kw = dict(group=h // kv, scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
        plain_out = fkern.flash_attention_cuda(q, k, v, **kw)
        out, lse = fkern.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        f32 = [x.float() for x in (q, k, v, do)]
        rout, rlse = flash_attention_ref(*f32[:3], return_lse=True, **kw)
        got = fkern.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        again = fkern.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        want = flash_attention_bwd_ref(*f32[:3], rout, rlse, f32[3], **kw)
        rel = {n: ((g.float() - w).abs().max() / w.abs().max()).item()
               for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        row = {"kernel": "flash_attn_bwd", "case": name, "dtype": str(dt).split(".")[-1],
               "b": b, "heads": h, "kv_heads": kv, "s": s, "hd": hd, "causal": causal,
               "window": window, "softcap": cap, "rel_err": rel,
               "max_abs_err": max((g.float() - w).abs().max().item() for g, w in zip(got, want)),
               "tol": TRAIN_GRAD_TOL[dt], "lse_err": (lse - rlse).abs().max().item(),
               "lse_tol": TRAIN_LSE_TOL[dt], "out_equal": torch.equal(out, plain_out),
               "deterministic": all(torch.equal(x, y) for x, y in zip(got, again))}
        if not (row["out_equal"] and row["deterministic"] and row["lse_err"] <= row["lse_tol"]
                and max(rel.values()) <= row["tol"]):
            raise AssertionError(f"flash_attn_bwd: kernel disagrees with its plain version: {row}")
        iters = 10 if s * s * h * b <= 2 ** 26 else 3
        k_ms, _ = device_time_ms(lambda i: fkern.flash_attention_bwd_cuda(
            q, k, v, out, lse, do, **kw), iters, host_ms_guess=0.3)
        # the plain version by CUDA events too: torch.profiler has read it
        # well below the events here (missed kernels)
        p_ms, _ = device_time_ms(lambda i: flash_attention_bwd_ref(q, k, v, out, lse, do, **kw),
                                 1, host_ms_guess=3.0)
        pairs = b * h * (_visible_pairs(s, window) if causal else s * s)
        bnd = bounds.flash_backward_bound(b * h, b * kv, s, s, hd, pairs,
                                          "bf16" if dt == torch.bfloat16 else "f32")
        row.update({"us": 1e3 * k_ms, "plain_us": 1e3 * p_ms, "bound_us": 1e6 * bnd.seconds,
                    "bound_by": bnd.bound_by, "bound_share": 1e3 * bnd.seconds / k_ms,
                    "pairs": pairs})
        if window is None and cap is None:
            row["library_us"] = 1e3 * _sdpa_bwd_ms(q, k, v, do, b, h, kv, causal, iters)
        rows.append(row)
        log(f"[train (a)] flash_attn_bwd {row['dtype']:8s} {name:25s} b*H={b * h:3d} s={s:4d} "
            f"hd={hd:3d} causal={causal} window={window} cap={cap}  dq/dk/dv "
            + "/".join(f"{e:.2e}" for e in rel.values()) + f" of max|plain| (tol "
            f"{row['tol']:.0e}); lse {row['lse_err']:.2e} (tol {row['lse_tol']:.0e}); out with "
            f"lse bit-equal; deterministic  {row['us']:10.2f} us  plain {row['plain_us']:10.1f} us"
            f"  bound {row['bound_us']:8.2f} us ({row['bound_by']}, "
            f"{100 * row['bound_share']:.2f} % of it)"
            + (f"  sdpa bwd {row['library_us']:8.2f} us" if "library_us" in row else "")
            + f"  was {TRAIN_FLASH_WAS_US[(name, row['dtype'])]:.1f} us (the first design, "
            f"not timed in this run) [{CARD['smi']}]")
        del q, k, v, do, out, lse, got, again, want, rout, rlse
    torch.cuda.empty_cache()
    return rows


def _clone_tree(tree):
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(_clone_tree(x) for x in tree))
    return tree_map(lambda t: t.clone(), tree) if isinstance(tree, dict) else tree.clone()


def _trees_equal(a, b) -> list[str]:
    """The paths whose leaves differ in a bit (dtype, shape or value)."""
    fa = dict(tree_items({"params": a[0], "opt": {"step": a[1].step, "m": a[1].m, "v": a[1].v}}))
    fb = dict(tree_items({"params": b[0], "opt": {"step": b[1].step, "m": b[1].m, "v": b[1].v}}))
    return [k for k in fa if fa[k].dtype != fb[k].dtype or not torch.equal(fa[k], fb[k])]


def train_setup(dev, seq: int, batch: int, layers: int | None = None, arch: str = ARCH,
                steps: int = TRAIN["steps"]):
    cfg = load_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                  seed=TRAIN["seed"]))
    opt_cfg = adamw.AdamWConfig(lr=TRAIN["lr"], total_steps=steps,
                                warmup_steps=max(1, steps // 20))
    return cfg, model, data, opt_cfg


def train_steps(dev) -> dict:
    """Phase 11 (b): TinyLlama-1.1B (22 layers, bf16) through run_loop with
    the train CLI's defaults for TRAIN["steps"] steps (run_loop's own
    checkpoint at the end); every loss finite and the last below the first;
    ms a step (host clock after the loss reaches the host, steps 2 on),
    tok/s, peak memory, the grad norms."""
    cfg, model, data, opt_cfg = train_setup(dev, TRAIN["seq"], TRAIN["batch"])
    ckdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    loop_cfg = LoopConfig(total_steps=TRAIN["steps"], ckpt_every=TRAIN["steps"],
                          ckpt_dir=str(ckdir), log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(seed=TRAIN["seed"], device=dev)
    params, opt_state, hist = run_loop(model, params, data, opt_cfg, loop_cfg, resume=False,
                                       log=lambda m: log(f"[train (b)] {m}"))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(ckdir, ignore_errors=True)
    step_fn = make_train_step(model, opt_cfg)
    batch = batch_to(data.batch_at(0), dev)
    prof = profile_device(lambda: step_fn(params, opt_state, batch), 1)
    del params, opt_state
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train (b): losses not finite or not falling: {losses}")
    ms = 1e3 * sum(h["sec"] for h in hist[1:]) / (len(hist) - 1)
    tok = TRAIN["batch"] * TRAIN["seq"]
    res = {"layers": cfg.num_layers, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [1e3 * h["sec"] for h in hist],
           "ms_per_step": ms, "tok_s": tok / (ms / 1e3), "peak_bytes": peak, "run_s": run_s,
           "profile": prof}
    bnd = bounds.train_step(cfg, TRAIN["batch"], TRAIN["seq"])
    res.update({"bound_ms": 1e3 * bnd.seconds, "bound_by": bnd.bound_by})
    log(f"[train (b)] {ARCH} {cfg.num_layers} layers d {cfg.d_model} bf16, batch "
        f"{TRAIN['batch']} x seq {TRAIN['seq']}, lr {TRAIN['lr']}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{h['grad_norm']:.3f}" for h in hist)
        + f"; {ms:.2f} ms a step (host clock, steps 2-{len(hist)}; bound {res['bound_ms']:.2f} "
        f"ms, {res['bound_by']}), {res['tok_s']:.0f} tok/s; "
        f"peak memory {peak / 2**30:.2f} GiB; run_loop with its final checkpoint {run_s:.1f} s; "
        f"profiler, one step: {prof['device_ms']:.2f} ms on the card, {prof['kernels']} kernels, "
        f"products {prof['products_ms']:.2f} ms; top " + ", ".join(
            f"{k[:40]} {v:.2f}" for k, v in prof["top"][:5]) + f" [{CARD['smi']}]")
    return res


def train_resume(dev) -> dict:
    """Phase 11 (d), at TRAIN["resume_layers"] layers of full width (the
    depth cut and its reason printed): a straight run_loop of TRAIN["steps"]
    steps with a checkpoint every TRAIN["resume_at"] (the state after that
    step kept on the card), the newest checkpoint removed, then a resume
    from step resume_at to the end: the restored params and AdamW state
    bit-equal to the kept ones, the resumed losses equal to the straight
    run's."""
    cfg, model, data, opt_cfg = train_setup(dev, TRAIN["seq"], TRAIN["batch"],
                                            TRAIN["resume_layers"])
    log(f"[train (d)] depth cut to {cfg.num_layers} of {load_config(ARCH).num_layers} layers "
        f"({TRAIN_RESUME_CUT}); full width d {cfg.d_model}, vocab {cfg.vocab_size}, bf16")
    ckdir = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(ckdir, ignore_errors=True)
    loop_cfg = LoopConfig(total_steps=TRAIN["steps"], ckpt_every=TRAIN["resume_at"],
                          ckpt_dir=str(ckdir), log_every=TRAIN["steps"])
    step_fn = make_train_step(model, opt_cfg)
    kept, checked = {}, {}

    def keep(params, opt_state, batch):
        params, opt_state, m = step_fn(params, opt_state, batch)
        if int(opt_state.step) == TRAIN["resume_at"]:
            kept["state"] = (_clone_tree(params), _clone_tree(opt_state))
        return params, opt_state, m

    def check_first(params, opt_state, batch):
        if not checked:
            checked["differ"] = _trees_equal((params, opt_state), kept["state"])
        return step_fn(params, opt_state, batch)

    t0 = time.perf_counter()
    _, _, hist = run_loop(model, model.init(seed=TRAIN["seed"], device=dev), data, opt_cfg,
                          loop_cfg, train_step=keep, resume=False,
                          log=lambda m: log(f"[train (d)] {m}"))
    shutil.rmtree(ckdir / f"step_{TRAIN['steps']:08d}")
    like = model.init(seed=TRAIN["seed"] + 1, device=dev)
    _, _, rhist = run_loop(model, like, data, opt_cfg, loop_cfg, train_step=check_first,
                           resume=True, log=lambda m: log(f"[train (d)] {m}"))
    shutil.rmtree(ckdir, ignore_errors=True)
    resumed = [h["loss"] for h in rhist]
    straight = [h["loss"] for h in hist][TRAIN["resume_at"]:]
    res = {"layers": cfg.num_layers, "restored_differ": checked["differ"], "losses": resumed,
           "straight_losses": straight, "equal": resumed == straight,
           "leaves": 3 * len(tree_items(like)) + 1, "seconds": time.perf_counter() - t0}
    log(f"[train (d)] resumed at step {TRAIN['resume_at']}: restored params and AdamW state "
        f"({res['leaves']} leaves, bf16 params) "
        + ("bit-equal to the state kept after the step" if not checked["differ"] else
           f"DIFFER at {checked['differ'][:5]}")
        + "; losses " + ", ".join(f"{x:.6f}" for x in resumed) + " against the straight run's "
        + ", ".join(f"{x:.6f}" for x in straight) + (" (equal)" if res["equal"] else
                                                      " (NOT equal)")
        + f"; {res['seconds']:.1f} s with 3 checkpoints and a restore")
    if checked["differ"] or not res["equal"]:
        raise AssertionError(f"train (d): resume is not the straight run: {res}")
    return res


@contextlib.contextmanager
def held_flash(calls: list):
    """Every flash call (forward with lse, backward) inside held to its plain
    version on the same inputs: the forward within FLASH_TOL of max|plain|
    and its lse within TRAIN_LSE_TOL, each gradient within TRAIN_GRAD_TOL
    (raises); the errors appended to ``calls``."""
    fwd, bwd = fkern.flash_attention_cuda, fkern.flash_attention_bwd_cuda

    def f(q, k, v, **kw):
        res = fwd(q, k, v, **kw)
        out, lse = res if kw.get("return_lse") else (res, None)
        want = flash_attention_ref(q.float(), k.float(), v.float(), **{
            **kw, "return_lse": lse is not None})
        wout, wlse = want if lse is not None else (want, None)
        err = ((out.float() - wout).abs().max() / wout.abs().max()).item()
        lerr = (lse - wlse).abs().max().item() if lse is not None else 0.0
        calls.append({"call": "forward", "rel_err": err, "lse_err": lerr})
        if not (err <= FLASH_TOL[q.dtype] and lerr <= TRAIN_LSE_TOL[q.dtype]):
            raise AssertionError(f"held flash forward: {calls[-1]}")
        return res

    def g(q, k, v, out, lse, dout, **kw):
        got = bwd(q, k, v, out, lse, dout, **kw)
        want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), **kw)
        rel = [((a.float() - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want)]
        calls.append({"call": "backward", "rel_err": rel})
        if not max(rel) <= TRAIN_GRAD_TOL[q.dtype]:
            raise AssertionError(f"held flash backward: {calls[-1]}")
        return got

    fkern.flash_attention_cuda, fkern.flash_attention_bwd_cuda = f, g
    try:
        yield calls
    finally:
        fkern.flash_attention_cuda, fkern.flash_attention_bwd_cuda = fwd, bwd


def _reset_all_launches() -> None:
    for mod in (kern, pkern, fkern, rkern):
        mod.reset_launches()


def _all_launches() -> dict[str, int]:
    return {k: v for mod in (kern, pkern, fkern, rkern) for k, v in mod.LAUNCHES.items() if v}


def _restore_launches(saved: dict[str, int]) -> None:
    """Every kernel's launch count back to ``saved`` (``_all_launches``)."""
    for mod in (kern, pkern, fkern, rkern):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = saved.get(k, 0)


def train_flash_launches(cfg) -> dict[str, int]:
    """B4's launches in one train step under blockwise_attention: a
    decoder layer's forward twice (remat recomputes it) and its backward
    once; zamba2's shared block, which remat leaves out (as the reference's
    jax.checkpoint does), forward and backward once an application."""
    if cfg.model_type == "zamba2":
        apps = cfg.num_layers // cfg.shared_attn_every
        return {"flash_attn": apps, "flash_attn_bwd": apps}
    return {"flash_attn": 2 * cfg.num_layers, "flash_attn_bwd": cfg.num_layers}


def train_blockwise(dev, arch: str = ARCH, layers: int | None = None, tag: str = "(c)",
                    profile: bool = True, **flag_kw) -> dict:
    """Phase 11 (c), and (f) for zamba2: one full-width step (bf16) under
    blockwise_attention (and ``flag_kw``) at TRAIN_BLOCKWISE's 1 x 2048:
    launches counted from 0 around the second step (train_flash_launches:
    TinyLlama's 2 x 22 B4 forwards and 22 backwards), its ms (host clock,
    synchronised); then the gradients of the kernel path, every B4 call
    held to its plain version (held_flash), against the plain path's (impl
    "plain" end to end) on the same params and batch, leaf by leaf against
    TRAIN_LEAF_TOL of the leaf's max|plain|."""
    bw = TRAIN_BLOCKWISE
    cfg, model, data, opt_cfg = train_setup(dev, bw["s"], bw["b"], layers, arch)
    params = model.init(seed=TRAIN["seed"], device=dev)
    batch = batch_to(data.batch_at(0), dev)
    step_fn = make_train_step(model, opt_cfg)
    opt_state = adamw.init(params)
    loss_fn = make_loss_fn(model)
    with flags.overrides(blockwise_attention=True, **flag_kw):
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        _reset_all_launches()
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])
        ms = 1e3 * (time.perf_counter() - t0)
        launches = _all_launches()
        want = train_flash_launches(cfg)
        if launches != want:
            raise AssertionError(f"train {tag}: launches {launches}, expected {want}")
        prof = profile_device(lambda: step_fn(params, opt_state, batch), 1) if profile else None
        calls: list = []
        with held_flash(calls):
            (kloss, _), kgrads = value_and_grad(loss_fn, params, batch)
        with ops.impl_scope("plain"):
            (ploss, _), pgrads = value_and_grad(loss_fn, params, batch)
    pflat = dict(tree_items(pgrads))
    leaf_err = {path: ((g.float() - pflat[path].float()).abs().max()
                       / pflat[path].float().abs().max()).item()
                for path, g in tree_items(kgrads)}
    worst = max(leaf_err, key=leaf_err.get)
    fwd_err = max(c["rel_err"] for c in calls if c["call"] == "forward")
    bwd_err = max(max(c["rel_err"]) for c in calls if c["call"] == "backward")
    bnd = bounds.train_step(cfg, bw["b"], bw["s"])
    res = {"launches": launches, "ms_per_step": ms, "profile": prof, "bound_ms": 1e3 * bnd.seconds,
           "bound_by": bnd.bound_by, "loss": loss, "kernel_loss": kloss.item(),
           "plain_loss": ploss.item(), "leaf_rel_err": leaf_err,
           "leaves_within_tol": leaf_err[worst] <= TRAIN_LEAF_TOL,
           "held_calls": {"forward": sum(c["call"] == "forward" for c in calls),
                          "backward": sum(c["call"] == "backward" for c in calls),
                          "forward_max_rel_err": fwd_err, "backward_max_rel_err": bwd_err}}
    log(f"[train {tag}] {arch} {cfg.num_layers} layers, blockwise"
        + "".join(f" + {k}" for k in flag_kw) + f" 1x{bw['s']} step: {ms:.1f} ms (host clock, "
        f"synchronised; bound {res['bound_ms']:.2f} ms, {res['bound_by']}"
        + (f"; profiler: {prof['device_ms']:.1f} ms on the card, B4 forward "
           f"{prof['flash_ms']:.1f}, backward {prof['flash_bwd_ms']:.1f} ("
           + ", ".join(f"{k} {v:.1f}" for k, v in sorted(prof["flash_bwd_split"].items()))
           + f"), products {prof['products_ms']:.1f}" if prof else "") + "), "
        f"launches {launches}; loss kernel {kloss.item():.6f} plain {ploss.item():.6f}; "
        f"gradient leaves kernel vs plain: worst {worst} {leaf_err[worst]:.3e} of max|plain| "
        f"(tol {TRAIN_LEAF_TOL}), " + ", ".join(f"{k.split('/')[-1]} {v:.2e}"
                                                for k, v in sorted(leaf_err.items()))
        + f"; every B4 call held to its plain version on the same inputs: "
        f"{res['held_calls']['forward']} forwards (max {fwd_err:.2e}, tol "
        f"{FLASH_TOL[torch.bfloat16]}), {res['held_calls']['backward']} backwards (max "
        f"{bwd_err:.2e}, tol {TRAIN_GRAD_TOL[torch.bfloat16]}) [{CARD['smi']}]")
    if not res["leaves_within_tol"]:
        log(f"[train {tag}] the leaves of a {cfg.num_layers}-layer random bf16 model leave the "
            f"plain path's by more than {TRAIN_LEAF_TOL}: held per B4 call above")
    return res


@contextlib.contextmanager
def no_checkpoints(saved: list):
    """run_loop with its checkpoints not written, each step it would save
    appended to ``saved``: a full-width 7B state is tens of GB a checkpoint
    (bf16 params, f32 m and v), and (d) holds checkpoints and resume."""
    save, retain = ckpt.save, ckpt.retain
    ckpt.save = lambda ckpt_dir, step, state, **kw: saved.append(step)
    ckpt.retain = lambda ckpt_dir, keep: None
    try:
        yield saved
    finally:
        ckpt.save, ckpt.retain = save, retain


def train_memory(cfg) -> dict:
    """The card's reckoning for a train step of ``cfg``: 12 bytes a parameter
    of state (bf16 param and gradient, f32 m and v) and 24 at the update
    (AdamW is functional: the old and the new params, m and v live together
    with the gradients and their clipped copy), against the card's memory."""
    n = bounds.train_params(cfg)
    return {"params": n, "state_bytes": 12 * n, "update_bytes": 24 * n,
            "card_bytes": torch.cuda.get_device_properties(0).total_memory}


def train_recurrent_run(dev, arch: str) -> dict:
    """Phase 11 (e) / (f): ``arch`` at full width and TRAIN_RECURRENT's
    depth (the cut printed with train_memory's reckoning at full and cut
    depth) through run_loop with the train CLI's defaults (SyntheticLM seed
    0, batch 8 x seq 128, lr 3e-4) for TRAIN_RECURRENT_STEPS steps, its
    checkpoints not written (no_checkpoints): every loss finite and the
    first batch's loss after the run below its first (a step's loss on its
    new batch barely moves in so few steps); ms a step on the host clock (the loss on the
    host) and on the card (CUDA events around each step), steps 2 on;
    tok/s, peak memory, the grad norms and bounds.train_step."""
    full = load_config(arch)
    steps = TRAIN_RECURRENT_STEPS
    cfg, model, data, opt_cfg = train_setup(dev, TRAIN["seq"], TRAIN["batch"],
                                            TRAIN_RECURRENT[arch], arch, steps)
    fm, cm = train_memory(full), train_memory(cfg)
    tag = "(e)" if arch == "rwkv6-7b" else "(f)"
    log(f"[train {tag}] {arch}: depth cut to {cfg.num_layers} of {full.num_layers} layers "
        f"(memory: {full.num_layers} layers are {fm['params'] / 1e9:.3f} B parameters, "
        f"{fm['state_bytes'] / 1e9:.1f} GB of state at 12 bytes a parameter and "
        f"{fm['update_bytes'] / 1e9:.1f} GB at the update's 24, more than the card's "
        f"{fm['card_bytes'] / 1e9:.1f} GB; {cfg.num_layers} layers are "
        f"{cm['params'] / 1e9:.3f} B, {cm['state_bytes'] / 1e9:.1f} / "
        f"{cm['update_bytes'] / 1e9:.1f} GB, with room for a layer's recomputed scan "
        f"states; and time: (e) and (f) within {TRAIN_RECURRENT_BUDGET_S} s); full width d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, bf16")
    loop_cfg = LoopConfig(total_steps=steps, ckpt_every=steps,
                          ckpt_dir=str(ROOT / "build" / "chip_smoke_recurrent"), log_every=1)
    step_fn, events, saved = make_train_step(model, opt_cfg), [], []

    def timed(params, opt_state, batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step_fn(params, opt_state, batch)
        ev[1].record()
        events.append(ev)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with no_checkpoints(saved):
        params, opt_state, hist = run_loop(
            model, model.init(seed=TRAIN["seed"], device=dev), data, opt_cfg, loop_cfg,
            train_step=timed, resume=False, log=lambda m: log(f"[train {tag}] {m}"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del opt_state
    with torch.no_grad():
        first_after = make_loss_fn(model)(params, batch_to(data.batch_at(0), dev))[0].item()
    del params
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses + [first_after]) or not first_after < losses[0]:
        raise AssertionError(f"train {tag}: losses not finite or the first batch's not falling: "
                             f"{losses}, after the run {first_after}")
    card_ms = [a.elapsed_time(b) for a, b in events]
    ms = 1e3 * sum(h["sec"] for h in hist[1:]) / (len(hist) - 1)
    dms = sum(card_ms[1:]) / (len(card_ms) - 1)
    bnd = bounds.train_step(cfg, TRAIN["batch"], TRAIN["seq"])
    res = {"arch": arch, "layers": cfg.num_layers, "full_layers": full.num_layers,
           "memory": cm, "full_memory": fm, "losses": losses, "first_batch_after": first_after,
           "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [1e3 * h["sec"] for h in hist],
           "step_card_ms": card_ms, "ms_per_step": ms, "card_ms_per_step": dms,
           "tok_s": TRAIN["batch"] * TRAIN["seq"] / (ms / 1e3), "peak_bytes": peak,
           "run_s": run_s, "checkpoints_not_written": saved, "bound_ms": 1e3 * bnd.seconds,
           "bound_by": bnd.bound_by}
    log(f"[train {tag}] {arch} {cfg.num_layers} layers bf16, batch {TRAIN['batch']} x seq "
        f"{TRAIN['seq']}, lr {TRAIN['lr']}: losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f" (each step's new batch; the first batch's {losses[0]:.4f} -> {first_after:.4f} "
        "after the run); grad norms " + ", ".join(f"{x:.3f}" for x in res["grad_norms"])
        + f"; {ms:.1f} ms a step on the host clock, {dms:.1f} on the card (CUDA events; steps "
        f"2-{len(hist)}; bound {res['bound_ms']:.2f} ms, {res['bound_by']}), "
        f"{res['tok_s']:.0f} tok/s; peak memory {peak / 1e9:.1f} GB; run_loop {run_s:.1f} s "
        f"(checkpoints at steps {saved} not written) [{CARD['smi']}]")
    return res


def train_recurrent_cpu(dev) -> dict:
    """Phase 11 (e): one f32 train step of TRAIN_RECURRENT_CPU's config
    (full width, its depth cut) on the card against the same step on the
    CPU, the same params (copied from the card) and batch: the loss and
    every gradient leaf within ``tol`` of the CPU leaf's max|g|."""
    c = TRAIN_RECURRENT_CPU
    cfg, model, data, _ = train_setup(dev, c["s"], c["b"], c["layers"], c["arch"])
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=TRAIN["seed"], device=dev)
    raw = data.batch_at(0)
    loss_fn = make_loss_fn(model)
    (kloss, _), kgrads = value_and_grad(loss_fn, params, batch_to(raw, dev))
    host = tree_map(lambda t: t.cpu(), params)
    del params
    (closs, _), cgrads = value_and_grad(loss_fn, host, batch_to(raw, torch.device("cpu")))
    cflat = dict(tree_items(cgrads))
    errs = {path: ((g.cpu() - cflat[path]).abs().max() / cflat[path].abs().max()).item()
            for path, g in tree_items(kgrads)}
    worst = max(errs, key=errs.get)
    res = {"arch": c["arch"], "layers": cfg.num_layers, "tokens": [c["b"], c["s"]],
           "loss_card": kloss.item(), "loss_cpu": closs.item(),
           "loss_rel_err": abs(kloss.item() - closs.item()) / abs(closs.item()),
           "leaf_rel_err": errs, "worst": worst, "tol": c["tol"],
           "seconds": time.perf_counter() - t0}
    log(f"[train (e)] {c['arch']} {cfg.num_layers} layers f32 (full width), {c['b']} x {c['s']} "
        f"tokens, allow_tf32 off: the card's step against the CPU's: loss {res['loss_card']:.7f} "
        f"/ {res['loss_cpu']:.7f} ({res['loss_rel_err']:.1e}); gradient leaves: worst {worst} "
        f"{errs[worst]:.3e} of max|cpu| (tol {c['tol']}), " + ", ".join(
            f"{k} {v:.1e}" for k, v in sorted(errs.items())) + f"; {res['seconds']:.1f} s")
    del kgrads, cgrads, host
    torch.cuda.empty_cache()
    if errs[worst] > c["tol"] or res["loss_rel_err"] > c["tol"]:
        raise AssertionError(f"train (e): the card's f32 gradient leaves the CPU's: {worst} "
                             f"{errs[worst]}")
    return res


def phase_train_recurrent(dev) -> dict:
    """Phase 11 (e) rwkv6-7b and (f) zamba2-7b (train_recurrent_run), with
    (e)'s step against the CPU and (f)'s blockwise + chunked_ssd step at
    zamba2's cut depth (4 B4 forwards and 4 backwards: the shared block's
    applications; every leaf within TRAIN_LEAF_TOL)."""
    t0 = time.perf_counter()
    out = {"rwkv6-7b": train_recurrent_run(dev, "rwkv6-7b"), "cpu": train_recurrent_cpu(dev),
           "zamba2-7b": train_recurrent_run(dev, "zamba2-7b")}
    out["blockwise"] = bw = train_blockwise(dev, "zamba2-7b", TRAIN_RECURRENT["zamba2-7b"], "(f)",
                                            profile=False, chunked_ssd=True)
    if not bw["leaves_within_tol"]:
        raise AssertionError(f"train (f): gradient leaves leave the plain path's: "
                             f"{max(bw['leaf_rel_err'].values())}")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] (e) and (f) took {out['seconds']:.1f} s (budget {TRAIN_RECURRENT_BUDGET_S} s)")
    return out


def phase_train(dev) -> tuple[dict, list[dict]]:
    t0 = time.perf_counter()
    rows = train_flash_rows(dev)
    out = {"layout": train_layout(), "steps": train_steps(dev)}
    torch.cuda.empty_cache()
    out["resume"] = train_resume(dev)
    torch.cuda.empty_cache()
    out["blockwise"] = train_blockwise(dev)
    torch.cuda.empty_cache()
    out["recurrent"] = phase_train_recurrent(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 11 {out['seconds']:.1f} s")
    return out, rows


def train_layout() -> dict:
    """Shared memory and CTAs an SM of both backward products kernels
    (dK/dV, dQ) at every head dim and dtype of phase 11 (a), from the card
    (flash_attn_bwd_layout); raises where the shared memory is not the
    Python mirror's (flash_attn.bwd_smem_bytes)."""
    out = {}
    for (_, _, _, _, _, hd, *_), dt in itertools.product(TRAIN_FLASH, FLASH_DTYPES):
        for dq in (False, True):
            smem, ctas = fkern.bwd_layout(hd, dt, dq)
            want = fkern.bwd_smem_bytes(hd, dq, dt)
            if smem != want or ctas < 1:
                raise AssertionError(f"flash_attn_bwd layout hd {hd} {dt} dq {dq}: {smem} bytes "
                                     f"(mirror {want}), {ctas} CTAs an SM")
            out[f"{str(dt).split('.')[-1]} hd {hd} {'dq' if dq else 'dkdv'}"] = {
                "smem_bytes": smem, "ctas_per_sm": ctas}
    log("[train (a)] flash_attn_bwd layout (shared memory = the mirror's; CTAs an SM): "
        + ", ".join(f"{k} {v['smem_bytes']} B {v['ctas_per_sm']}" for k, v in out.items()))
    return out


def train_entry(rows: list[dict], train: dict) -> dict:
    """The kernels line's flash_attn_bwd entry: times at (c)'s shape (bf16),
    launches added from phase 11 (c)'s run by add_runs, and the kernels' layout."""
    main = next(r for r in rows if r["case"] == TRAIN_FLASH_MAIN and r["dtype"] == "bfloat16")
    return {
        "name": "flash_attn_bwd", "route": "cuda", "source": SOURCES["flash_attn_bwd"],
        "replaces": REPLACES["flash_attn_bwd"],
        "replaces_note": "the gradient of flash_attention_pallas's function: the reference "
                         "differentiates _mha_blockwise with XLA "
                         "(src/repro/models/attention.py:194)",
        "launches": 0, "max_abs_err": max(r["max_abs_err"] for r in rows), **_timing(main),
        "library_ms": main["library_us"] / 1e3,
        "layout": train["layout"],
        "per": f"one call (four launches: D, dK/dV, dQ, the group sum), causal GQA 32/4, hd 64, "
               f"bfloat16, {TRAIN_FLASH_MAIN} tokens (one layer of phase 11 (c)'s step); library: "
               "scaled_dot_product_attention's backward on the same inputs; max_abs_err over "
               "every phase-11 (a) case",
        "path": "phase 11 (c): a full-width TinyLlama train step under blockwise_attention",
        "shapes": [{k: r.get(k) for k in ("case", "dtype", "s", "us", "plain_us", "bound_us",
                                          "bound_by", "library_us", "rel_err",
                                          "max_abs_err")} for r in rows],
    }


def train_summary(train: dict, smi: str) -> None:
    st, bw, rec = train["steps"], train["blockwise"], train["recurrent"]
    log(f"[train] {ARCH} bf16 {st['layers']} layers, batch {TRAIN['batch']} x seq "
        f"{TRAIN['seq']}: {st['ms_per_step']:.2f} ms a step, {st['tok_s']:.0f} tok/s, peak "
        f"{st['peak_bytes'] / 2**30:.2f} GiB, loss {st['losses'][0]:.4f} -> "
        f"{st['losses'][-1]:.4f}; resume ({train['resume']['layers']} layers) bit-equal; "
        f"blockwise 1x{TRAIN_BLOCKWISE['s']} step "
        f"{bw['ms_per_step']:.1f} ms ({bw['launches']}); " + "; ".join(
            f"{r['arch']} ({r['layers']} of {r['full_layers']} layers) {r['ms_per_step']:.1f} ms "
            f"a step ({r['card_ms_per_step']:.1f} on the card), {r['tok_s']:.0f} tok/s, peak "
            f"{r['peak_bytes'] / 1e9:.1f} GB, loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}"
            for r in (rec["rwkv6-7b"], rec["zamba2-7b"]))
        + f"; zamba2 blockwise + chunked_ssd 1x{TRAIN_BLOCKWISE['s']} step "
        f"{rec['blockwise']['ms_per_step']:.1f} ms ({rec['blockwise']['launches']}); rwkv6 f32 "
        f"card vs CPU worst leaf {rec['cpu']['leaf_rel_err'][rec['cpu']['worst']]:.2e}; phase "
        f"{train['seconds']:.1f} s [{smi}]")


def _phase_gqmm_launches(kname, kind, serves, ragged, flagres, spec) -> dict[str, int]:
    """Launches of one GQMV/GQMM kernel on the main paths, by run: phase 3's
    generate per weight setting (its matvec path for GQMV), phase 5's ragged
    passes, phase 6's generate and Model.forward (the 1 x 2048 prefill runs
    prefill_dequant: no GQMM), phase 7's replayed speculative generates and
    serves."""
    key = "launches" if kind == "gqmm" else "matvec_launches"
    runs = {f"phase 3 {tag}": sv[key].get(kname, 0) for tag, sv in serves.items()}
    runs.update({f"phase 5 {name}": ps["launches"].get(kname, 0)
                 for name, ps in ragged["passes"].items()})
    runs["phase 6 generate"] = flagres["generate"]["gqmm_launches_generate"].get(kname, 0)
    runs["phase 6 forward"] = flagres["forward"]["gqmm_launches"].get(kname, 0)
    if kind == "gqmm":
        runs.update({f"phase 7 generate {name}": r["launches"].get(kname, 0)
                     for name, r in spec["runs"].items()})
        runs.update({f"phase 7 ragged {mode}": r["launches"].get(kname, 0)
                     for mode, r in spec["ragged"].items()})
    return {k: v for k, v in runs.items() if v}


def _timing(row) -> dict:
    """The kernels line's time fields from one timed phase-2 row."""
    return {"ms": row["us"] / 1e3, "plain_ms": row["plain_us"] / 1e3,
            "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
            "bound_share": row["bound_us"] / row["us"]}


def kernel_entries(rows, gsrows, serves, prows, ragged, frows, rqrows, flagres,
                   golden, spec) -> list[dict]:
    """The kernels line. A GQMV/GQMM kernel's times are one forward pass of
    its format's uniform setting; its launches add up every run of phases 3,
    5 and 6 that launched it (the presets launch int4/int3 and the int8
    classifier). The paged kernel's launches are phase 5's passes (and, for
    the float pool, phase 7's paged verify runs); the
    tensor-core flash kernel's phase 6's three runs (bf16), the CUDA-core
    flash kernel's the golden phase's run under the flags (f32); the fused
    RMSNorm + quantize's its standalone run."""
    entries = []
    for fmt, kind in itertools.product(WEIGHT_FORMATS, ("gqmm", "gqmv")):
        kname = f"{kind}_{fmt}"
        runs = _phase_gqmm_launches(kname, kind, serves, ragged, flagres, spec)
        mine = [r for r in rows if r["kernel"] == kname]
        step = serves[fmt]["step_gqmm" if kind == "gqmm" else "step_gqmv"]
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": sum(runs.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine + gsrows if r["kernel"] == kname),
            "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
            "bound_by": step["bound_by"], "bound_share": step["bound_ms"] / step["ms"],
            "library_ms": None,
            "per": f"one forward pass of the 89 TinyLlama projections with {fmt} weights at b="
                   + str(SERVE["batch"] if kind == "gqmm" else 1),
            "path": ("InferenceEngine.generate (batch {b}, prompt {p}, {n} tokens), serve_ragged, "
                     "the flags' generate and Model.forward, speculative generate and "
                     "serve_ragged (verify at b*k rows)".format(
                         b=SERVE["batch"], p=SERVE["prompt_len"], n=SERVE["max_new_tokens"])
                     if kind == "gqmm" else
                     "ops.quantized_matmul on 1-D activations over the 89 projections")
            + "; launches by run " + ", ".join(f"{t} {c}" for t, c in runs.items()),
            "launches_by_run": runs,
            **({f"b{SERVE['batch'] * SERVE['prompt_len']}_pass": {
                k: serves[fmt]["step_gqmm_prefill"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")}} if kind == "gqmm" else {}),
            "shapes": [{k: r[k] for k in ("shape", "m", "n", "b", "us", "plain_us", "bound_us",
                                          "max_abs_err", "design", "int_mm_us", "first_us")
                        if k in r}
                       for r in mine],
        })
        if kname == "gqmv_int8":
            entries[-1]["was_ms"] = serves[fmt]["step_gqmv_first"]["ms"]
            entries[-1]["was_note"] = (
                "was_ms: the same pass on the first GQMV design, timed in this run (the "
                "design before the streamed one); first_us per shape likewise")
        if kname == "gqmm_int8":
            entries[-1]["int_mm_us"] = {r["shape"]: r["int_mm_us"] for r in mine
                                        if "int_mm_us" in r}
            entries[-1]["library_note"] = (
                f"library_ms is null: no PyTorch call applies per-group scales; int_mm_us is "
                f"torch._int_mm on the same int8 operands at b={INT_MM_B} (the int8 "
                f"tensor-core product without the scales), a yardstick the port never calls")
    passes = ragged["passes"]
    for kname, pool, names in (("paged_attn", "float", ("paged_float", "paged_half",
                                                        f"paged_{RAGGED_FORMAT}")),
                               ("paged_attn_quant", "int8", ("paged_int8", "paged_fp8"))):
        mine = [r for r in prows if r["kernel"] == kname]

        def timed(shape, pool=pool, mine=mine):
            return next(r for r in mine if r["pool"] == pool and "us" in r and all(
                r[k] == v for k, v in shape.items()))

        main, large = timed(PAGED_MAIN), timed(PAGED_LARGE)
        # phase 7's paged verify runs the float-pool kernel once a chunk
        # column a layer
        spec_runs = {} if kname != "paged_attn" else {
            **{f"phase 7 generate {name}": r["launches"].get(kname, 0)
               for name, r in spec["runs"].items() if name.startswith("paged")},
            "phase 7 ragged paged": spec["ragged"]["paged"]["launches"].get(kname, 0)}
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": sum(passes[n]["launches"][kname] for n in names)
            + sum(spec_runs.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine), **_timing(main),
            "library_ms": None,
            "per": f"one call at b={PAGED_MAIN['b']}, BS {PAGED_MAIN['bs']}, MB*BS "
                   f"{PAGED_MAIN['T']}, KV 4, G 8, hd 64, bf16 q, {pool} pool (the ragged "
                   f"serve's decode shape; {main['splits']} splits); max_abs_err over every "
                   "phase-2 case",
            f"b{PAGED_LARGE['b']}_T{PAGED_LARGE['T']}": {
                **_timing(large), "splits": large["splits"],
                "per": f"one call at b={PAGED_LARGE['b']}, BS {PAGED_LARGE['bs']}, MB*BS "
                       f"{PAGED_LARGE['T']}, bf16 q, {pool} pool, random positions"},
            "path": "serve_ragged(mode='paged'), " + " and ".join(
                f"{n} ({passes[n]['kv']} KV, {passes[n]['launches'][kname]} launches = "
                f"{passes[n]['launches'][kname] // passes[n]['decode_steps']} layers x "
                f"{passes[n]['decode_steps']} decode steps)" for n in names)
            + "".join(f"; {t} {c}" for t, c in spec_runs.items()),
            "shapes": [{k: r[k] for k in ("qdtype", "pool", "b", "bs", "T", "splits", "us",
                                          "plain_us", "bound_us", "max_abs_err", "tol")}
                       for r in mine if "us" in r],
        })
    fl = {"generate": flagres["generate"]["flash_launches_generate"],
          f"1x{LONG_PREFILL['s']} prefill": flagres["long_prefill"]["flash_launches"],
          f"Model.forward {FORWARD['b']}x{FORWARD['s']}": flagres["forward"]["flash_launches"]}
    gfl = golden["flags"]["launches"]
    for kname, dtype, runs, path in (
            ("flash_attn", "bfloat16", fl, "phase 6 under blockwise_attention (bf16 model): "),
            ("flash_attn_f32", "float32", {"golden generate under the flags": gfl},
             "the golden phase's int8 generate under the serving flags (f32 model): ")):
        mine = [r for r in frows if r["kernel"] == kname]
        main = next(r for r in mine if r["case"] == FLASH_MAIN and "us" in r)
        counts = {k: v.get(kname, 0) for k, v in runs.items()}
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": sum(counts.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine), **_timing(main),
            "library_ms": main["library_us"] / 1e3,
            "per": f"one call, causal GQA 32/4, hd 64, {dtype}, {FLASH_MAIN} tokens (one layer "
                   "of the serve's prefill); library: scaled_dot_product_attention on the same "
                   "inputs; max_abs_err over every phase-2 case of this kernel",
            "path": path + ", ".join(f"{k} ({v})" for k, v in counts.items()),
            "shapes": [{k: r.get(k) for k in ("case", "dtype", "s", "us", "plain_us", "bound_us",
                                              "bound_by", "library_us", "max_abs_err")}
                       for r in mine if "us" in r],
        })
    main = next(r for r in rqrows if (r["m"], r["n"]) == RMSQ_MAIN and "us" in r
                and r["dtype"] == "bfloat16")
    entries.append({
        "name": "rmsnorm_quant", "route": "cuda", "source": SOURCES["rmsnorm_quant"],
        "replaces": REPLACES["rmsnorm_quant"],
        "launches": flagres["rmsnorm_quant"]["launches"],
        "max_abs_err": max(r["max_scale_abs_err"] for r in rqrows), **_timing(main),
        "library_ms": None, "was_ms": main["first_us"] / 1e3, "empty_ms": main["empty_us"] / 1e3,
        "was_note": "was_ms: the first design (the design before the row design) on the same "
                    "rows one element off 16 bytes, timed in this run; empty_ms: an empty "
                    "kernel launched with the row design's grid, the card's floor for the launch",
        "per": f"one call on bf16 rows {RMSQ_MAIN}, GS 256; max_abs_err is the largest "
               "scale error over every phase-2 case (the int8 values are equal but for .5 "
               "ties, counted as tie_flips); no single PyTorch call does RMSNorm and group "
               "quantization",
        "path": "standalone op (no model path calls it, in the reference or the port): "
                "ops.rmsnorm_quant at the model's 45 norm sites, phase 6 (d)",
        "shapes": [{k: r.get(k) for k in ("m", "n", "dtype", "us", "plain_us", "bound_us",
                                          "empty_us", "first_us", "tie_flips")}
                   for r in rqrows if "us" in r],
    })
    return entries


def family_runs(fam: dict) -> dict[str, dict[str, int]]:
    """Phase 8's launch counts by run (each counted from 0 just before it)."""
    runs = {}
    for arch, r in fam.items():
        if arch == "goldens":
            continue
        runs[f"phase 8 {arch} generate"] = r["launches"]
        for mode, rr in r.get("ragged", {}).items():
            runs[f"phase 8 {arch} ragged {mode}"] = rr["replayed"]["launches"]
        for mode, sp in r.get("spec", {}).items():
            runs[f"phase 8 {arch} spec generate {mode}"] = sp["launches"]
        for name, counts in r.get("long", {}).get("launches", {}).items():
            runs[f"phase 8 {arch} 1x{FAMILY_LONG['prompt_len']} {name}"] = counts
        if "patches" in r:
            runs[f"phase 8 {arch} patch prefill"] = r["patches"]["launches"]
    return runs


# ---------------------------------------------------------------------------
# phase 12: repro-san (analysis/sanitizer.py) at full width
# ---------------------------------------------------------------------------

class _UafAdapter(PagedAdapter):
    """Frees a live slot's first block but leaves the table mapping it."""

    tripped = False

    def before_round(self, pos, live):
        super().before_round(pos, live)
        if not self.tripped:
            s = int(np.flatnonzero(live)[0])
            self.pool.free([self._slot_blocks[s][0]])      # pre_round poisons it
            self.tripped = True


class _LeakOnFinishAdapter(PagedAdapter):
    """Drops the bookkeeping at finish but never returns the blocks."""

    def on_finish(self, s):
        self._slot_blocks[s], self._slot_need[s] = [], 0
        self.table[s, :] = 0
        self._slot_live[s] = False


class _NanCacheAdapter(PagedAdapter):
    """Writes NaN into the pool (layer 0, block 2) after a decode round."""

    tripped = False

    def decode_round(self, params, tok, pos, live, steps):
        out = super().decode_round(params, tok, pos, live, steps)
        if not self.tripped:
            self.cache()["k_pages"][0, 2] = float("nan")
            self.tripped = True
        return out


def _sanitize_pass(engine, reqs, mode: str) -> tuple[list, dict]:
    """One phase-5 ragged pass; with a sanitized engine it adds the
    sanitizer's stats of the serve."""
    out, info = _ragged_pass(engine, reqs, mode)
    if engine.sanitize:
        sk = dict(slots=RAGGED["slots"], chunk=RAGGED["chunk"])
        sched = (paged_scheduler(engine, block_size=RAGGED["block_size"], **sk) if mode == "paged"
                 else slot_scheduler(engine, **sk))
        info["sanitizer"] = dict(sched._core.sanitizer.stats)
    return out, info


def _sanitized_b8(dev) -> dict:
    """(b) B8 at the serve's decode shape (PAGED_MAIN) over a bf16 pool
    whose columns from each row's position on (the masked ones and the
    stale slot at pos, which k_new replaces) and whose dead blocks hold
    POISON: the output equals, bit for bit, the kernel's on the same pool
    with zeros there, and lies within PAGED_TOL of the plain arithmetic in
    f32 on the poisoned values."""
    gen = torch.Generator(device=dev).manual_seed(12)
    b, bs, T = PAGED_MAIN["b"], PAGED_MAIN["bs"], PAGED_MAIN["T"]
    kv, g, hd, mb = PAGED["kv"], PAGED["g"], PAGED["hd"], T // bs
    nb = b * mb + 1                                          # block 0: the sink
    kp, vp, _, _ = _paged_pools(gen, dev, "float", torch.bfloat16, nb, bs)
    pos = torch.randint(1, T, (b,), generator=gen, device=dev)
    table = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).reshape(b, mb)
    table = table.to(torch.int32)
    # every (physical block, in-block row) at or past its row's position
    t = torch.arange(T, device=dev)
    stale = (t[None, :] >= pos[:, None]).reshape(b, mb, bs)
    phys = table.long()[:, :, None].expand(b, mb, bs)
    rows = torch.arange(bs, device=dev)[None, None, :].expand(b, mb, bs)
    dead_blocks = int((stale.all(-1)).sum())
    poisoned, zeroed = (kp.clone(), vp.clone()), (kp.clone(), vp.clone())
    for pages in poisoned:
        pages[phys[stale], rows[stale]] = POISON
    for pages in zeroed:
        pages[phys[stale], rows[stale]] = 0
    q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    mask = decode_mask(T, pos)
    pos32 = pos.to(torch.int32)
    kw = dict(scale=hd ** -0.5, softcap=None, k_scales=None, v_scales=None)
    got = pkern.paged_attention_cuda(q, *poisoned, table, pos32, kn, vn, mask, **kw)
    clean = pkern.paged_attention_cuda(q, *zeroed, table, pos32, kn, vn, mask, **kw)
    want = paged_attention_ref(q.float(), poisoned[0].float(), poisoned[1].float(), table, pos,
                               kn.float(), vn.float(), mask, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(want).all()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError("paged attention over the poisoned pool is not finite")
    err = (got.float() - want).abs().max().item()
    tol = PAGED_TOL[torch.bfloat16] * want.abs().max().item()
    same = torch.equal(got, clean)
    row = {"kernel": "paged_attn", "case": "poisoned pool", "b": b, "bs": bs, "T": T,
           "poisoned_rows": int(stale.sum()), "dead_blocks": dead_blocks,
           "bit_equal_to_zeroed": same, "max_abs_err": err, "tol": tol}
    if not same or not err <= tol:
        raise AssertionError(f"paged_attn under poison: {row}")
    log(f"[sanitize] (b) B8 over a bf16 pool with {row['poisoned_rows']} poisoned rows "
        f"({dead_blocks} dead blocks): output bit-equal to the zeroed pool's; max|err| vs "
        f"plain {err:.2e} (tol {tol:.1e})")
    return row


def _caught(part: str, what: str, fn, err_type, needles) -> str:
    """Runs a planted fault; it must raise ``err_type`` naming every needle."""
    try:
        fn()
    except err_type as e:
        msg = str(e)
        if not all(n in msg for n in needles):
            raise AssertionError(f"{what}: caught without its attribution {needles}: {msg}")
        log(f"[sanitize] ({part}) {what} caught: {msg}")
        return msg
    raise AssertionError(f"{what}: the planted fault was not caught")


def phase_sanitize(dev, reng, rvanilla) -> dict:
    """Phase 12: repro-san at full width on phase 5's int8 engine and trace
    (bf16 pool); see the module docstring. ``reng`` is phase 5's bf16-pool
    engine and ``rvanilla`` its replayed passes' responses."""
    t_start = time.perf_counter()
    prev_checks = numerics_checks_enabled()
    reqs = ragged_trace(reng.cfg.vocab_size)
    san = InferenceEngine(reng.model, reng.params, cache_len=reng.cache_len, sanitize=True,
                          device=dev)
    res = {"passes": {}}
    # (a) parity: the unsanitized engine's programs are phase 5's (replayed);
    # the sanitized engine's are captured by a cold pass, then replayed
    for mode in ("paged", "continuous"):
        name = "paged_float" if mode == "paged" else "continuous"
        _, cold = _sanitize_pass(san, reqs, mode)
        runs = {"off": [], "on": []}
        for i in range(2 * SANITIZE_PAIRS):
            side = ("off", "on")[(i + i // 2) % 2]          # off, on, on, off, off, on
            out, info = _sanitize_pass(san if side == "on" else reng, reqs, mode)
            same = all(np.array_equal(a.tokens, b.tokens) and a.length == b.length
                       for a, b in zip(out, rvanilla[name]))
            if not same:
                raise AssertionError(f"{mode} serve with the sanitizer {side}: tokens differ "
                                     "from phase 5's replayed pass")
            runs[side].append(info)
        off, on = runs["off"][-1], runs["on"][-1]
        st = on["sanitizer"]
        if any(r["launches"] != off["launches"] for r in runs["on"] + runs["off"]):
            raise AssertionError(f"sanitized {mode} serve: launches differ from the "
                                 f"unsanitized serve's ({on['launches']} vs {off['launches']})")
        if st["poison_reach"] or st["rounds_checked"] != on["rounds"] or (
                mode == "paged" and not st["blocks_poisoned"]):
            raise AssertionError(f"sanitized {mode} serve: bad sanitizer stats {st}")
        if mode == "paged" and on["launches"]["paged_attn"] != \
                reng.cfg.num_layers * on["decode_steps"]:
            raise AssertionError("the sanitized paged serve did not run B8 once a layer a step")
        tok_s = {k: float(np.median([r["tok_s"] for r in v])) for k, v in runs.items()}
        round_ms = {k: float(np.median([1e3 * r["wall_s"] / r["rounds"] for r in v]))
                    for k, v in runs.items()}
        res["passes"][mode] = {"off": off, "on": on, "cold_on": cold, "runs": runs,
                               "median_tok_s": tok_s, "median_ms_per_round": round_ms}
        log(f"[sanitize] (a) {mode:10s} tokens bit-identical on/off (and equal to phase 5's); "
            f"finalize clean; {st['blocks_poisoned']} blocks poisoned, {st['rounds_checked']} "
            f"rounds checked, poison reach {st['poison_reach']}; median tok/s of "
            f"{SANITIZE_PAIRS} passes in turns: off {tok_s['off']:.1f} (" + ", ".join(
                f"{r['tok_s']:.1f}" for r in runs["off"]) + f"), on {tok_s['on']:.1f} ("
            + ", ".join(f"{r['tok_s']:.1f}" for r in runs["on"])
            + f"): {tok_s['on'] / tok_s['off']:.3f}x; ms a round off {round_ms['off']:.3f}, "
            f"on {round_ms['on']:.3f} ({on['rounds']} rounds), of which the round check "
            f"{1e3 * st['check_s'] / st['rounds_checked']:.3f} (host clock to its device read) "
            f"[{CARD['smi']}]")

    res["b8"] = _sanitized_b8(dev)

    # (c) planted faults on the sanitized engine, the trace's slots and block
    # size (the programs of (a) replay), one request each
    sk = dict(slots=RAGGED["slots"], chunk=RAGGED["chunk"])
    one = [Request(0, reqs[0].tokens, max_new=12)]

    def serve_with(cls):
        core = SchedulerCore(san, cls(san, block_size=RAGGED["block_size"]), **sk)
        return core.serve(one, 12)

    res["faults"] = {
        "use_after_free": _caught("c", "use-after-free", lambda: serve_with(_UafAdapter),
                                  SanitizerError, ("use-after-free", "freed physical block",
                                                   "generation")),
        "leak": _caught("c", "leak at finish", lambda: serve_with(_LeakOnFinishAdapter),
                        SanitizerError, ("leak — request 0", "still owns block(s)")),
        "nan_cache": _caught("c", "NaN in the pool", lambda: serve_with(_NanCacheAdapter),
                             SanitizerError, ("cache leaf ['k_pages']", "(layer) indices [0]")),
    }
    model1 = build(dataclasses.replace(load_config(ARCH), num_layers=1))
    bad = model1.init(seed=SERVE["seed"], device=dev)
    bad["layers"]["attn"]["wqkv"][0, 5, 7] = float("nan")
    res["faults"]["corrupt_weight"] = _caught(
        "c", "corrupt weight at a sanitized engine's init",
        lambda: InferenceEngine(model1, bad, cache_len=64, quantize=True, sanitize=True,
                                device=dev),
        QuantNumericsError, ("quantize[int8].input", "param 'layers/attn/wqkv'",
                             "layer-class attn"))
    del bad, model1

    # (d) the quantized pools are refused under sanitize
    res["refusals"] = {}
    for kvq in ("int8", "fp8"):
        qeng = InferenceEngine(reng.model, reng.params, cache_len=reng.cache_len, kv_quant=kvq,
                               sanitize=True, device=dev)
        res["refusals"][kvq] = _caught(
            "d", f"kv_quant {kvq} pool refused",
            lambda: serve_ragged(qeng, reqs[:2], 4, mode="paged", block_size=RAGGED["block_size"],
                                 **sk),
            NotImplementedError, ("poison", "OverflowError for int8", "NaN for float8_e4m3fn"))
        del qeng

    # (e) rwkv6-7b at full width, SANITIZE_RWKV_LAYERS layers, continuous
    cfg = dataclasses.replace(load_config("rwkv6-7b"), num_layers=SANITIZE_RWKV_LAYERS)
    model = build(cfg)
    rreqs = recurrent_trace(cfg.vocab_size)
    cache_len = max(len(r.tokens) + r.max_new for r in rreqs)
    off_eng = InferenceEngine(model, model.init(seed=SERVE["seed"], device=dev),
                              cache_len=cache_len, quantize=True, device=dev)
    on_eng = InferenceEngine(model, off_eng.params, cache_len=cache_len, sanitize=True,
                             device=dev)
    rk = dict(slots=RECURRENT_RAGGED["slots"], chunk=RECURRENT_RAGGED["chunk"])
    want = serve_ragged(off_eng, rreqs, RECURRENT_RAGGED["budgets"][1], mode="continuous", **rk)
    got = serve_ragged(on_eng, rreqs, RECURRENT_RAGGED["budgets"][1], mode="continuous", **rk)
    st = dict(slot_scheduler(on_eng, **rk)._core.sanitizer.stats)
    if not all(np.array_equal(a.tokens, b.tokens) for a, b in zip(got, want)):
        raise AssertionError("rwkv6: sanitized tokens differ from unsanitized ones")
    _served(rreqs, got, cfg.vocab_padded)
    res["rwkv6"] = {"layers": SANITIZE_RWKV_LAYERS, "requests": len(rreqs), "sanitizer": st}
    log(f"[sanitize] (e) rwkv6-7b at {SANITIZE_RWKV_LAYERS} of 32 layers, full width: "
        f"{len(rreqs)} requests continuous, tokens equal on/off, audit clean, "
        f"{st['rounds_checked']} rounds checked")
    del off_eng, on_eng, model, san
    set_numerics_checks(prev_checks)
    res["seconds"] = time.perf_counter() - t_start
    log(f"[sanitize] phase 12 took {res['seconds']:.1f} s [{CARD['smi']}]")
    return res


# ---------------------------------------------------------------------------
# phase 13: the platform layers (placement, the placed step, the dry-run)
# ---------------------------------------------------------------------------

def _timed_step(step_fn, params, opt_state, batch):
    """One train step: (params, opt_state, metrics, host ms to the loss on
    the host, the card's span by CUDA events)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    params, opt_state, m = step_fn(params, opt_state, batch)
    ev[1].record()
    float(m["loss"])
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return params, opt_state, m, host_ms, ev[0].elapsed_time(ev[1])


def _state(params, opt_state) -> dict[str, torch.Tensor]:
    """Every leaf of a (placed or plain) train state, gathered."""
    full = sharding.gather({"params": params, "m": opt_state.m, "v": opt_state.v})
    return {**dict(tree_items(full)), "step": opt_state.step}


def _differ(a: dict, b: dict) -> list[str]:
    return [k for k in b if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]


def mesh_replicated(mesh, params) -> int:
    """Every placement of ``params`` on the 1 x 1 mesh degrades to
    replicated (raises otherwise); returns the leaves checked."""
    from torch.distributed.tensor import Replicate

    specs = sharding.param_specs(params, mesh, "train")
    bad = [k for k, s in specs.items() if any(s) or not all(
        isinstance(p, Replicate) for p in sharding.placements(s, mesh))]
    if bad:
        raise AssertionError(f"mesh (a): placements on 1 x 1 not replicated: {bad[:5]}")
    return len(specs)


def mesh_steps(dev, mesh) -> dict:
    """(b): MESH["steps"] steps of TinyLlama at the train CLI's 8 x 128,
    through the unplaced step and the placed one (make_train_step with
    the mesh) from the same weights: losses, grad norms and every leaf of
    params, m and v bit-equal; ms a step both ways (host clock to the loss
    on the host, and CUDA events), the last step's."""
    cfg, model, data, opt_cfg = train_setup(dev, TRAIN["seq"], TRAIN["batch"],
                                            steps=MESH["steps"])
    init = model.init(seed=TRAIN["seed"], device=dev)
    leaves = mesh_replicated(mesh, init)
    runs = {}
    for name in ("unplaced", "placed"):
        placed = name == "placed"
        step_fn = make_train_step(model, opt_cfg, mesh=mesh if placed else None)
        params = sharding.distribute(init, sharding.param_specs(init, mesh, "train"), mesh) \
            if placed else init
        opt_state, hist = adamw.init(params), []
        for i in range(MESH["steps"]):
            params, opt_state, m, host_ms, card_ms = _timed_step(
                step_fn, params, opt_state, batch_to(data.batch_at(i), dev))
            hist.append({"loss": m["loss"], "grad_norm": m["grad_norm"], "host_ms": host_ms,
                         "card_ms": card_ms})
        runs[name] = {"hist": hist, "state": _state(params, opt_state)}
        del params, opt_state
    u, p = runs["unplaced"], runs["placed"]
    metrics = [k for i in range(MESH["steps"]) for k in ("loss", "grad_norm")
               if not torch.equal(u["hist"][i][k], p["hist"][i][k])]
    differ = _differ(p["state"], u["state"])
    res = {"leaves": leaves, "state_leaves": len(u["state"]), "metrics_differ": metrics,
           "state_differ": differ,
           "losses": [float(h["loss"]) for h in u["hist"]],
           "grad_norms": [float(h["grad_norm"]) for h in u["hist"]],
           **{f"{n}_{k}": r["hist"][-1][k] for n, r in runs.items()
              for k in ("host_ms", "card_ms")}}
    log(f"[mesh (b)] {ARCH} {cfg.num_layers} layers bf16, {TRAIN['batch']} x {TRAIN['seq']}, "
        f"{MESH['steps']} steps on the 1 x 1 mesh ({leaves} leaves, every placement "
        f"replicated): losses " + ", ".join(f"{x:.6f}" for x in res["losses"]) + ", grad norms "
        + ", ".join(f"{x:.4f}" for x in res["grad_norms"]) + "; placed against unplaced: "
        + ("losses, grad norms and every leaf of params, m, v bit-equal"
           if not metrics and not differ else f"DIFFER {metrics} {differ[:5]}")
        + f"; last step unplaced {res['unplaced_host_ms']:.2f} ms (host clock; "
        f"{res['unplaced_card_ms']:.2f} by CUDA events), placed {res['placed_host_ms']:.2f} "
        f"ms ({res['placed_card_ms']:.2f}) [{CARD['smi']}]")
    if metrics or differ:
        raise AssertionError(f"mesh (b): the placed step is not the unplaced one: {metrics} "
                             f"{differ[:10]}")
    grads = value_and_grad(make_loss_fn(model), init, batch_to(data.batch_at(0), dev))[1]
    res["compress"] = mesh_compress(grads)
    return res


def mesh_compress(grads) -> dict:
    """(d): compressed_all_reduce over the one-rank NCCL group on the full
    gradient tree, twice (the second call timed apart from the first's
    communicator set-up), bit-equal to compress_leaf and decompress_leaf on
    the same gradients (a sum over one rank, divided by 1); the leaves that
    do not divide into groups averaged uncompressed with zero residual."""
    ms = []
    for _ in range(2):      # the first call also sets up NCCL's communicator
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        mean = resid = None
        torch.cuda.synchronize()
        ev[0].record()
        mean, resid = compressed_all_reduce(grads, None)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    fm, fr = dict(tree_items(mean)), dict(tree_items(resid))
    differ, grouped = [], 0
    for path, g in tree_items(grads):
        g32 = g.to(torch.float32)
        if g.shape[-1] % 256 == 0:
            local = decompress_leaf(*compress_leaf(g32, 256), 256)
            want, wres = local, g32 - local
            grouped += 1
        else:
            want, wres = g32, torch.zeros_like(g32)
        if not (torch.equal(fm[path], want) and torch.equal(fr[path], wres)):
            differ.append(path)
    res = {"leaves": len(fm), "grouped": grouped, "differ": differ,
           "first_ms": ms[0], "ms": ms[1],
           "bytes": sum(4 * g.numel() for _, g in tree_items(grads))}
    log(f"[mesh (d)] compressed_all_reduce over NCCL world 1, {res['leaves']} gradient leaves "
        f"({grouped} in int8 groups of 256, {res['bytes'] / 1e9:.2f} GB of f32): "
        + ("bit-equal to compress_leaf + decompress_leaf" if not differ else f"DIFFER {differ}")
        + f"; {res['ms']:.2f} ms by CUDA events ({res['first_ms']:.2f} the first call, which "
        f"also sets up NCCL's communicator) [{CARD['smi']}]")
    if differ:
        raise AssertionError(f"mesh (d): compressed_all_reduce differs at {differ}")
    return res


def mesh_blockwise(dev, mesh) -> dict:
    """(c): one step at TRAIN_BLOCKWISE's 1 x 2048 under blockwise_attention
    (B4 forward, B4' backward), unplaced then placed from the same weights:
    loss, grad norm and every leaf bit-equal; the placed step's launches
    counted from 0 around it (train_flash_launches)."""
    bw = TRAIN_BLOCKWISE
    cfg, model, data, opt_cfg = train_setup(dev, bw["s"], bw["b"])
    init = model.init(seed=TRAIN["seed"], device=dev)
    batch = batch_to(data.batch_at(0), dev)
    out = {}
    with flags.overrides(blockwise_attention=True):
        for name in ("unplaced", "placed"):
            placed = name == "placed"
            params = sharding.distribute(init, sharding.param_specs(init, mesh, "train"), mesh) \
                if placed else init
            step_fn = make_train_step(model, opt_cfg, mesh=mesh if placed else None)
            if placed:
                _reset_all_launches()
            params, opt_state, m, host_ms, card_ms = _timed_step(
                step_fn, params, adamw.init(params), batch)
            out[name] = {"m": m, "state": _state(params, opt_state), "host_ms": host_ms,
                         "card_ms": card_ms, "launches": _all_launches() if placed else None}
            del params, opt_state
    u, p = out["unplaced"], out["placed"]
    differ = [k for k in ("loss", "grad_norm") if not torch.equal(u["m"][k], p["m"][k])]
    differ += _differ(p["state"], u["state"])
    want = train_flash_launches(cfg)
    res = {"launches": p["launches"], "differ": differ, "loss": float(u["m"]["loss"]),
           **{f"{n}_{k}": out[n][k] for n in out for k in ("host_ms", "card_ms")}}
    log(f"[mesh (c)] {ARCH} {cfg.num_layers} layers, blockwise 1x{bw['s']} step on the 1 x 1 "
        f"mesh: placed against unplaced "
        + ("bit-equal (loss, grad norm, every leaf)" if not differ else f"DIFFER {differ[:5]}")
        + f"; launches of the placed step {p['launches']} (want {want}); unplaced "
        f"{res['unplaced_host_ms']:.1f} ms ({res['unplaced_card_ms']:.1f} by CUDA events), "
        f"placed {res['placed_host_ms']:.1f} ms ({res['placed_card_ms']:.1f}) [{CARD['smi']}]")
    if differ or p["launches"] != want:
        raise AssertionError(f"mesh (c): {differ[:10]}, launches {p['launches']} vs {want}")
    return res


def mesh_cells(dev, mesh) -> dict:
    """(e): the dry-run's host cell (make_host_mesh: this process's 1 x 1)
    against the card: each of MESH["cells"]'s arguments (train_4k: bf16
    params, f32 m and v, AdamW's step, the batch; prefill_32k: int8 params
    and the batch) allocated empty and placed on the mesh, the allocator's
    growth (memory_allocated) within MESH_BYTES_RTOL of the dry-run's bytes
    a device; MESH["unallocated"] must be marked as not fitting."""
    cfg = load_config(ARCH)
    out = {}
    for name in MESH["cells"]:
        rec = dryrun.run_cell(ARCH, name, mesh, "host")
        args, _ = dryrun.cell_arguments(cfg, SHAPES[name], mesh)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        placed = {k: sharding.distribute(tensor_map_with_path(
            lambda _, t: torch.empty(t.shape, dtype=t.dtype, device=dev), tree), specs, mesh)
            for k, (tree, specs) in args.items()}
        grown = torch.cuda.memory_allocated(dev) - before
        del placed
        want = rec["memory"]["argument_bytes"]
        out[name] = {"dryrun_bytes": want, "allocated_bytes": grown,
                     "rel_err": abs(grown - want) / want, "memory": rec["memory"],
                     "fits": rec["fits"], "least": rec["least"]}
    dec = dryrun.run_cell(ARCH, MESH["unallocated"], mesh, "host")
    total = torch.cuda.get_device_properties(0).total_memory
    out[MESH["unallocated"]] = {"dryrun_bytes": dec["memory"]["argument_bytes"],
                                "memory": dec["memory"], "fits": dec["fits"],
                                "card_bytes": total, "least": dec["least"]}
    torch.cuda.empty_cache()
    log("[mesh (e)] dry-run host cell (1 x 1) against the card's allocator: " + "; ".join(
        f"{k} {v['dryrun_bytes'] / 1e9:.4f} GB by shapes ("
        + ", ".join(f"{n.split('_')[0]} {b / 1e9:.4f}" for n, b in v["memory"].items()
                    if n != "argument_bytes" and b)
        + f"), allocated {v['allocated_bytes'] / 1e9:.4f} GB ({100 * v['rel_err']:.4f} %)"
        for k, v in out.items() if "allocated_bytes" in v)
        + f"; {MESH['unallocated']} {out[MESH['unallocated']]['dryrun_bytes'] / 1e9:.2f} GB "
        f"(cache {dec['memory']['cache_bytes'] / 1e9:.2f} GB) against the card's "
        f"{total / 1e9:.2f} GB: " + ("fits" if dec["fits"] else "does not fit, not allocated")
        + f" [{CARD['smi']}]")
    bad = [k for k, v in out.items() if v.get("rel_err", 0) > MESH_BYTES_RTOL]
    if bad or dec["fits"]:
        raise AssertionError(f"mesh (e): allocated bytes off the dry-run's in {bad}, or "
                             f"{MESH['unallocated']} marked as fitting: {out}")
    return out


def phase_mesh(dev) -> dict:
    """Phase 13: a one-rank NCCL group on a HashStore and elastic_mesh() over
    it (1 x 1), then (b)-(e); the group destroyed at the end."""
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = elastic_mesh(dev)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        if shape != {"data": 1, "model": 1}:
            raise AssertionError(f"mesh (a): elastic_mesh() on one rank gave {shape}")
        log(f"[mesh (a)] NCCL world 1, elastic_mesh() {shape}")
        out = {"mesh": shape, "steps": mesh_steps(dev, mesh)}
        torch.cuda.empty_cache()
        out["blockwise"] = mesh_blockwise(dev, mesh)
        torch.cuda.empty_cache()
        out["cells"] = mesh_cells(dev, mesh)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"[mesh] phase 13 {out['seconds']:.1f} s (budget {MESH['budget_s']} s) [{CARD['smi']}]")
    return out



def preset_bound_bytes(cfg, preset: str) -> int:
    """``bounds.decode_step``'s bytes at batch 1 with each projection at its
    layer class's format under ``preset`` (the classifier's too)."""
    fmap = resolve_format_map(preset)
    total = 0
    for name, m, n, c in bounds.pass_projections(cfg):
        fmt = fmap["ffn" if name in ("w13", "w2") else "attn"]
        total += c * bounds.projection(fmt, m, n, 1, bounds.group_size(cfg, n)).nbytes
    return total + bounds.projection(fmap["classifier"], cfg.vocab_size, cfg.d_model, 1,
                                     bounds.group_size(cfg, cfg.d_model)).nbytes


def phase_contracts(dev, held: dict) -> dict:
    """Phase 14: the four xray audits' card halves on the captured decode
    program of each weight preset of phase 3 (``held``: its quantized
    weights, on the host since phase 3) and of int8 weights over an int8
    and an fp8 KV cache, full width and depth, batch 1, cache 64; then the
    launch contract over every captured program still alive. A failed
    audit fails the run. The kernels' launch counts are restored after."""
    from repro_torch.analysis import launch_contract, xray

    t0 = time.perf_counter()
    saved = _all_launches()
    c = CONTRACTS
    model = build(load_config(ARCH))
    cfg = model.cfg
    prompt = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(c["batch"], c["prompt_len"])))}
    engines, rows, bad = {}, {}, []
    runs = [(fmt, fmt, None) for fmt in xray.BYTES_PRESETS] + \
        [(f"int8+kv_{kvq}", "int8", kvq) for kvq in xray.KV_QUANT_PRESETS]
    for tag, preset, kvq in runs:
        params = tree_to(held[preset], dev) if kvq is None else engines["int8"].params
        eng = InferenceEngine(model, params, cache_len=c["cache_len"], quantize=False,
                              kv_quant=kvq, device=dev)
        eng.generate(prompt, c["new_tokens"])
        fails, stats = xray.card_audit(eng.graphs.last["generate.decode"], eng, name=tag)
        stats["bound_bytes"] = preset_bound_bytes(cfg, preset)
        bad += fails
        rows[tag] = stats
        engines[tag] = eng
        log(f"[contracts] {tag}: weights read by kernel nodes "
            f"{stats['weight_bytes_read'] / 1e6:.3f} MB, registry model "
            f"{stats['registry_weight_bytes'] / 1e6:.3f} MB "
            f"({stats['weight_bytes_read'] / stats['registry_weight_bytes']:.6f}x), "
            f"bounds.decode_step {stats['bound_bytes'] / 1e6:.3f} MB "
            f"({stats['weight_bytes_read'] / stats['bound_bytes']:.4f}x); "
            f"{stats['kernel_nodes']} kernel nodes, {stats['projection_nodes']} GQMV/GQMM "
            f"(expected {stats['expected_projections']}); graph pool {stats['pool_bytes']} "
            f"bytes (a cache leaf {stats['cache_leaf_min_bytes']})"
            + (f"; FAILED: {fails}" if fails else ""))
    # more kernels for the launch contract: B8 and B9 (paged decode), B4
    # (blockwise prefill), B2 (a program of the fused RMSNorm + quantize)
    eng8 = engines["int8"]
    eng8.generate(prompt, c["new_tokens"], paged=True)
    engines["int8+kv_int8"].generate(prompt, c["new_tokens"], paged=True)
    with flags.overrides(blockwise_attention=True):
        eng8.generate({"tokens": prompt["tokens"].repeat(1, c["blockwise_prompt"]
                                                         // c["prompt_len"])}, 2)
    norm_w = eng8.params["final_norm"]
    rmsq = [eng8.graphs.program(
        "contracts.rmsnorm_quant", (m,),
        lambda x, w: ops.rmsnorm_quant(x, w, group_size=cfg.group_size),
        lambda m=m: {"x": torch.randn((m, cfg.d_model), device=dev, dtype=norm_w.dtype),
                     "w": norm_w}) for m in c["rmsq_rows"]]
    checked = mirrored = 0
    names = collections.Counter()
    progs = graphs.captured()
    n_progs = len(progs)
    for prog in progs:
        nodes = graphs.kernel_nodes(prog)
        fails, n_mirrored = launch_contract.card_contract(nodes, prog.name)
        bad += fails
        checked += len(nodes)
        mirrored += n_mirrored
        names.update(kernel_signature(n.name)[0] for n in nodes
                     if launch_contract.card_mirror(n.name, n.values()) is not None)
    del rmsq, engines, eng8, progs
    torch.cuda.empty_cache()
    _restore_launches(saved)
    out = {"rows": rows, "programs_checked": n_progs, "kernel_nodes_checked": checked,
           "hand_written_nodes": mirrored, "hand_written_kernels": dict(names),
           "seconds": time.perf_counter() - t0}
    log(f"[contracts] launch contract: {checked} kernel nodes of the {n_progs} captured "
        f"programs alive checked, {mirrored} hand-written nodes held to their shared-memory "
        f"mirrors ("
        + ", ".join(f"{k} {v}" for k, v in sorted(names.items())) + ")")
    log(f"[contracts] phase 14 {out['seconds']:.1f} s (budget {c['budget_s']} s) "
        f"[{CARD['smi']}]")
    if bad:
        raise AssertionError("phase 14 (contracts) failed:\n" + "\n".join(bad))
    return out


def add_runs(entries: list[dict], runs: dict, rows: list[dict], key: str) -> None:
    """A phase's launches by run and its kernel rows (under ``key``) into the
    kernels line's entries."""
    for e in entries:
        by_run = e.setdefault("launches_by_run", {})
        for run, counts in runs.items():
            if counts.get(e["name"]):
                by_run[run] = counts[e["name"]]
                e["launches"] += counts[e["name"]]
        mine = [r for r in rows if r["kernel"] == e["name"]]
        if mine:
            e[key] = mine
            e["max_abs_err"] = max([e["max_abs_err"]] + [r["max_abs_err"] for r in mine])


def add_families(entries: list[dict], fam: dict, rows: list[dict]) -> None:
    """Phase 8's launches and the families' phase-2 rows into the kernels
    line's entries."""
    add_runs(entries, family_runs(fam), rows, "family_shapes")


def family_summary(fam: dict, smi: str) -> None:
    for arch, r in fam.items():
        if arch == "goldens":
            continue
        log(f"[families] {arch}: {r['layers']} of {r['full_layers']} layers; decode b="
            f"{SERVE['batch']} {r['decode_ms_wall']:.3f} ms/step wall, {r['decode_ms_device']:.3f} "
            f"on the card ({100 * r['busy_share']:.1f} % busy), {r['kernels_per_step']} kernels "
            f"a step; projection bytes {r['weight_bytes_per_step'] / 1e9:.3f} GB a step, HBM "
            f"bound {r['bytes_bound_ms']:.3f} ms; first-step logits vs plain "
            f"{r['logit_rel_err']:.3e}; {r['seconds']:.1f} s [{smi}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None, help="also write the full results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    # float32 matmuls in full precision: the plain versions and the f32 golden run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    CARD["smi"] = card()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {CARD['smi']}")

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    log(f"[build] {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{b.name} ({'cached' if b.cached else f'{b.seconds:.1f} s'})"
                    for b in built.values()))
    for b in built.values():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {b.name}: {line.strip()}")

    rows = phase_kernels(dev)
    corows = phase_cutover(dev)
    tcrows = phase_tc_sweep(dev)
    mvrows = phase_gqmv_sweep(dev)
    gsrows = phase_group_sizes(dev)
    frows, sdpa = phase_flash_kernels(dev)
    rqrows = phase_rmsnorm_kernels(dev)
    prows = phase_paged_kernels(dev)
    p256rows = phase_paged_hd256(dev)
    model = build(load_config(ARCH))
    params = model.init(seed=SERVE["seed"], device=dev)
    serves, engines, held = {}, {}, {}
    for quantize in (True, *FORMAT_SETTINGS):
        tag = "int8" if quantize is True else quantize
        serves[tag], eng = phase_serve(dev, rows, model, params, quantize)
        held[tag] = tree_to(eng.params, "cpu")      # phase 14's weights
        if tag in ("int8", RAGGED_FORMAT):
            engines[tag] = eng
        del eng
    del params
    ragged, ragged_engine, ragged_outs = phase_ragged(dev, engines["int8"],
                                                      engines[RAGGED_FORMAT])
    flagres = phase_flags(dev, engines["int8"], serves["int8"])
    t_spec = time.perf_counter()
    spec = phase_spec(dev, engines["int8"], serves["int8"], ragged, ragged_engine, ragged_outs)
    spec["seconds"] = time.perf_counter() - t_spec
    log(f"[spec] phase 7 (a) and (b) took {spec['seconds']:.1f} s")
    sanitize = phase_sanitize(dev, ragged_engine, ragged_outs)
    del engines, ragged_engine, ragged_outs
    golden = phase_golden(dev)
    golden["deep"] = phase_golden_deep(dev)
    t_fam = time.perf_counter()
    famrows = phase_family_kernels(dev)
    ffrows, fprows = phase_family_attention(dev)
    fam = phase_families(dev)
    fam_s = time.perf_counter() - t_fam
    log(f"[families] phase 8 with its phase-2 shapes took {fam_s:.1f} s")
    rec, rkrows, rfrows = phase_recurrent(dev)
    enc, ekrows, efrows = phase_encdec(dev)
    train, trows = phase_train(dev)
    mesh = phase_mesh(dev)
    contracts = phase_contracts(dev, held)
    del held

    s8, pf = serves["int8"], ragged["passes"]["paged_float"]
    log(f"[graphs] int8, batch {SERVE['batch']}: decode eager {s8['eager']['decode_ms_per_step']:.2f} "
        f"ms/step wall ({s8['decode_profile']['device_ms']:.3f} on the card, "
        f"{100 * s8['eager']['decode_device_busy_share']:.1f} % busy), replayed "
        f"{s8['decode_ms_per_step']:.3f} ms/step wall ({s8['decode_device_ms']:.3f} on the card, "
        f"{100 * s8['decode_device_busy_share']:.1f} % busy); prefill {SERVE['batch']}x"
        f"{SERVE['prompt_len']} eager {1e3 * s8['eager']['prefill_s']:.1f} ms wall "
        f"({s8['prefill_profile']['device_ms']:.3f} on the card), replayed "
        f"{1e3 * s8['prefill_s']:.2f} ms wall ({s8['prefill_device_ms']:.3f} on the card); "
        f"ragged paged bf16 pool eager {ragged['eager']['paged_float']['tok_s']:.1f} tok/s, "
        f"replayed {pf['tok_s']:.1f} tok/s; captures: generate "
        + ", ".join(f"{k} {v['captured']} ({v['capture_s']:.3f} s)"
                    for k, v in sorted(s8["programs"].items()))
        + ", ragged bf16-pool engine " + ", ".join(
            f"{k} {v['captured']} ({v['capture_s']:.2f} s)"
            for k, v in sorted(ragged["programs"]["float"].items()))
        + f"; graph pools {sum(v['pool_bytes'] for v in s8['programs'].values()) / 2**20:.0f} "
        f"MiB (int8 generate), "
        f"{sum(v['pool_bytes'] for v in ragged['programs']['float'].values()) / 2**20:.0f} MiB "
        f"(ragged bf16-pool engine) [{CARD['smi']}]")

    sc = spec["runs"]["contiguous_ngram"]
    log(f"[spec] int8, batch {SERVE['batch']}, k {SPEC['k']}: verify step "
        + ", ".join(f"{name} {r['verify_ms_wall']:.3f} ms wall ({r['verify_ms_device']:.3f} on "
                    f"the card), {r['tokens_per_step']:.2f} tokens a row, {r['ms_per_token']:.3f} "
                    f"ms a token" for name, r in spec["runs"].items())
        + f"; vanilla {s8['decode_ms_per_step']:.3f} ms/step; ragged tok/s "
        + ", ".join(f"{m} {r['tok_s']:.1f} (vanilla {r['vanilla_tok_s']:.1f})"
                    for m, r in spec["ragged"].items())
        + f"; n-gram acceptance {sc['spec_stats']['accepted']}/{sc['spec_stats']['drafted']} "
        f"[{CARD['smi']}]")

    smi = card()
    entries = kernel_entries(rows, gsrows + tcrows + mvrows, serves, prows, ragged, frows,
                             rqrows, flagres, golden, spec)
    add_families(entries, fam, famrows + ffrows + fprows)
    add_runs(entries, recurrent_runs(rec), rkrows + rfrows, "recurrent_shapes")
    add_runs(entries, encdec_runs(enc), ekrows + efrows, "encdec_shapes")
    entries.append(train_entry(trows, train))
    add_runs(entries, {"phase 11 blockwise train step": train["blockwise"]["launches"],
                       "phase 11 (f) zamba2 blockwise train step":
                       train["recurrent"]["blockwise"]["launches"]}, [], "train_shapes")
    add_runs(entries, {"phase 13 placed blockwise train step": mesh["blockwise"]["launches"]},
             [], "mesh_shapes")
    add_runs(entries, {f"phase 12 sanitized {m} serve": p["on"]["launches"]
                       for m, p in sanitize["passes"].items()}, [sanitize["b8"]],
             "sanitize_shapes")
    family_summary(fam, smi)
    recurrent_summary(rec, smi)
    encdec_summary(enc, smi)
    train_summary(train, smi)
    for e in entries:
        log(f"[kernels] {e['name']:16s} {e['launches']:6d} launches  {1e3 * e['ms']:10.3f} us  "
            f"bound {1e3 * e['bound_ms']:9.3f} us ({e['bound_by']}, {100 * e['bound_share']:.1f} "
            f"% of it)  plain {1e3 * e['plain_ms']:10.1f} us"
            + (f"  library {1e3 * e['library_ms']:8.2f} us" if e["library_ms"] else "")
            + (f"  was {1e3 * e['was_ms']:10.3f} us" if "was_ms" in e else "")
            + f"  [{smi}]")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"card": smi, "kernel_rows": rows, "cutover_rows": corows,
             "tc_sweep_rows": tcrows, "gqmv_sweep_rows": mvrows, "group_size_rows": gsrows,
             "sdpa": sdpa,
             "flash_rows": frows, "rmsnorm_quant_rows": rqrows, "paged_rows": prows,
             "paged_hd256_rows": p256rows,
             "serve": serves, "ragged": ragged, "flags": flagres, "golden": golden,
             "spec": spec,
             "family_kernel_rows": famrows, "family_flash_rows": ffrows,
             "family_paged_rows": fprows, "families": fam, "families_seconds": fam_s,
             "recurrent_kernel_rows": rkrows, "recurrent_flash_rows": rfrows,
             "recurrent": rec,
             "encdec_kernel_rows": ekrows, "encdec_flash_rows": efrows, "encdec": enc,
             "train_flash_rows": trows, "train": train, "sanitize": sanitize, "mesh": mesh,
             "contracts": contracts,
             "kernels": entries,
             "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
