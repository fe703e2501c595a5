#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ditl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

``python3 chip_smoke.py --path20`` runs paths 1, 2 and 20 alone,
``--path21`` paths 1, 2 and 21, ``--path22`` paths 1, 2 and 22,
``--path23`` paths 1, 2 and 23, and ``--path24`` paths 1, 2 and 24 (no
kernels line). ``python3 chip_smoke.py
--paged-rows [--sweep] [TREE]`` and ``--f32-mm [--sweep] [TREE]`` time one
kernel family on TREE's ``ditl_tpu_torch``
(default: this checkout's; ``tree_main``), so that a parent commit unpacked
beside the checkout and the checkout can be timed in turns in one run.

Every phase is fatal: a failure raises, the script exits non-zero and prints
no result line. It imports nothing of JAX or of the JAX package.

1. Card: CUDA must be present; prints ``nvidia-smi`` name and power limit.
2. Build: every ``ditl_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, one nvcc
   per source, all started together; prints ptxas' register/spill lines.
3. Kernels against their plain PyTorch versions on the card: K1 (flash
   forward) at the serving prefill shapes, the training batch, ragged
   lengths (S = 129, 300, 2064), every head dim with and without causal
   masking, non-monotone ids and a boundary one row past a tile edge, K2a/K2b (flash
   backward) on the same kinds of cases, the training shape (B=4, S=2048,
   32/8 heads, D=128, the pipeline's packed rows) first, where two calls
   must give the same bits, K3 (paged decode with the
   tail) and K4 (without) at the decode tick's shape, ragged ones and the
   edges of their key splits, each also against the plain twin of the split
   rule and called twice, which must give the same bits (tolerances at ``O_TOL``/``LSE_TOL``/``BWD_TOL``). K4 has no serving
   path: its launches are this phase's direct calls. K3 over int8 pools
   (``ditl_paged_tail_i8``) against the plain version's int8 branch and
   the split twin at the decode tick, the split edges, a dead slot,
   starts == lengths and a tail-only slot, head_dim 64 and 128, called
   twice. K3's multi-query verify (``ditl_paged_verify_bf16``/``_i8``) over
   float and int8 pools against the plain version's 4-D branch and the split
   twin (``_verify_cases``: the spec tick's shape, head_dim 64, a dead slot,
   a tail longer than 128 columns whose split is live for some queries and
   dead for others, a tail-only slot, G = 8 at 72 query rows, Q = 2), called
   twice, and a 4-D q with Q = 1 against the 3-D call's bits; K3, K3-int8 and
   K4 in their single-query form on fixed integer-made inputs against the
   digests of the build before the verify joined their template
   (``K3_DIGESTS``). ``[f32-kernels]``: the f32 kernels (``csrc/flash_f32.cu``,
   ``csrc/paged_attention_f32.cu``) against their plain versions in f32:
   K1-f32, K2a-f32 and K2b-f32 at D = 64 and 128, causal and not, packed and
   right-padded ids, G = 4 and 7 (path 9's batch among them; ``F32_O_TOL``,
   ``F32_BWD_TOL``), K3-f32, K4-f32 and K3-f32-verify at the decode tick,
   the spec tick and the verify's other cases against the plain version
   and the split twin (``F32_PAGED_TOL``); every kernel called twice gives
   the same bits. ``[f32-mm-kernels]`` (after the bf16 K5/K6 checks of
   phase 9): K5a-f32, K5b-f32 and K6-f32 (``csrc/gemm_f32.cu``) against
   their plain versions in f32 (``F32_MM_TOL`` of each output's largest
   magnitude) at path 10's shapes (N = 8192, D = 896, F = 4864; K6 at
   wq/wo and wk/wv), at ragged ones (N = 2064 and 16, D = F = 384; N =
   2000 with F = 640 and 600, no multiple of the tiles) and with a strided
   gradient; each called twice gives the same bits; the bf16 K5a
   and K5b still give ``K5_DIGESTS``. ``[f16-kernels]`` and
   ``[f32-int8-kernels]`` (``phase_f16_int8_kernels``): K1-f16 against the
   plain forward in float16 at the serving prefill, the training batch's
   packed rows and head_dim 64 and 32 (``O_TOL``/``LSE_TOL``), the bf16 K1
   against ``K1_DIGESTS`` (its build before the element type became a
   template parameter); the paged
   entry points of ``NEW_PAGED`` (K3-f16, K4-f16, K3-f16-verify,
   K3-int8-f16 and its verify at ``O_TOL``; K3-int8-f32 and its verify
   within ``F32_PAGED_TOL`` of the largest magnitude) against the plain
   version and the split twin at the decode tick, a ragged head_dim 64 case
   (a dead slot, a tail-only slot, an empty tail) and the split edges, the
   verify forms at ``_verify_cases`` and 80 query rows; every kernel called
   twice gives the same bits. ``[f16-bwd-kernels]``
   (``phase_f16_bwd_kernels``): K2a-f16 and K2b-f16 against the plain
   backward in float16 (``BWD_TOL`` of each gradient's largest magnitude)
   at the llama3-8b training shape on packed rows and on one document a
   row, path 13's heads (14/2, D = 64), D = 32, ragged S = 129 and 300 and
   ids that go up and down; K5a-f16 and K5b-f16 at N = 8192 with llama3-8b's
   and path 13's widths and a ragged N = 2064, K6-f16 at llama3-8b's and
   qwen2-0.5b's wq/wo and wk/wv (``MM_TOL``); every kernel twice the same
   bits; then the bf16 K1, K2a/K2b, K3 and K5a/K5b against ``K1_DIGESTS``,
   ``K2_DIGESTS`` (recorded on the build before K2's element type became a
   template parameter), ``K3_DIGESTS`` and ``K5_DIGESTS``, and the f32 paged kernels
   and K5a-f32, K5b-f32 and K6-f32 against ``F32_DIGESTS``.
   ``[hd-kernels]`` (``phase_head_dim_kernels``): every paged entry point
   (``HD_PAGED``: K3, K4, K3-verify and their int8 forms in bf16, float16
   and f32) at head_dim 32 and 256 against the plain version and the split
   twin (``HD_PAGED_CASES``, ``HD_VERIFY_CASES``: the decode and spec ticks
   of paths 14 and 15, G = 1 and 8, 80 query rows, split and tile edges, dead
   and tail-only slots), and K1, K2a and K2b at head_dim 256 in bf16 and
   float16 (``HD_FLASH_CASES``: path 15's prefill and training rows, ids up
   and down, a boundary past a tile edge, Sq != Skv); every kernel called
   twice gives the same bits. ``[shape-kernels]``
   (``phase_shape_kernels``): every paged entry point at the group counts,
   verify rows and head dims of paths 16 and 17 (``SHAPE_PAGED_CASES``,
   ``SHAPE_VERIFY_CASES``: G = 16 single-query, a 144-row verify in two row
   groups, D = 96 on the 128 instance, G = 12 at D = 80 with split edges and
   108 rows, D = 16 at G = 16 with dead and tail-only slots and a long
   tail) the same way.
4. Timings: each kernel, its plain version, one PyTorch library call that
   computes the same function (a yardstick the port never calls), and the
   card's bound for the same work from this run's inputs; K1, K2a and K2b
   also at the training shape, on one document per row (SDPA and its
   backward on the same inputs) and on the pipeline's packed rows (SDPA and
   its backward given the same packed causal mask), with the tiles each
   visits, and the whole backward wrapper (delta, K2a, K2b) against SDPA's
   backward on both inputs; K3 and K4 also at splits of 128, 256 and 512
   keys. K3 over int8 pools at the decode tick beside the float K3 on the
   same keys, with SDPA over the keys dequantized to bf16 beforehand as its
   yardstick and the dequantization's own time, and its bound from the
   int8 bytes plus scales. K3-verify (float and int8) at the spec tick
   (``SPEC_MAIN``) beside the single-query K3 on the same keys, with SDPA over
   the gathered keys and the same per-query mask as its yardstick (the
   gather timed apart). ``[f32-timing]``: each f32 kernel, its plain
   version and the library call on the same f32 inputs (SDPA, its backend
   named), with the bound at 4 B an element and 165 TFLOP/s (3xTF32; the
   67 TFLOP/s FFMA figure beside): K1-f32, K2a-f32 and K2b-f32 at path 9's
   batch (K1-f32 also at the serving prefill), K3-f32 and K4-f32 at the
   decode tick, K3-f32-verify at the spec tick. ``[f32-mm-timing]``:
   K5a-f32, K5b-f32 and K6-f32 (wq/wo, wk/wv) at path 10's shapes, with
   their plain versions, cuBLAS's SGEMM (TF32 off) on each kernel's own two
   products, ``autograd.grad`` of the plain MLP forward or of ``x @ w``, the
   bound and the rate. ``[f16-timing]`` and ``[f32-int8-timing]``: K1-f16 at
   the serving prefill and on packed rows against SDPA in float16, the new
   paged kernels at the decode tick or the spec tick against SDPA over keys
   gathered (and dequantized to q's dtype) beforehand, the gather timed
   apart. ``[f16-bwd-timing]``: K2a-f16, K2b-f16, K5a-f16, K5b-f16 and
   K6-f16 at llama3-8b's shapes (their bf16 twins' rows) and path 13's,
   beside the bf16 twin on the same values, the plain version, SDPA's
   backward in float16 with the same mask (K2) or cuBLAS float16 on the
   kernel's own two products and ``autograd.grad`` of the plain forward
   (K5/K6), and the bound (989 TFLOP/s dense float16). ``[hd-timing]``:
   every paged entry point at head_dim 32 and 256 at the decode tick of
   paths 14 and 15 (the verify forms at their spec tick), K1 at head_dim 256
   at path 15's prefill and on one packed training row, K2a and K2b on that
   row, each beside its plain version, SDPA (or SDPA's backward) and its
   bound, and for f32 K2a-f32 + K2b-f32 against SDPA's whole backward with
   K2b-f32's grid (its runs, ``f32_dkv_splits``; path 9's batch the same
   in ``[f32-timing]``); the kernels line carries them under
   ``at_head_dims``. ``[shape-timing]``: every paged entry point at path
   16's decode tick (G = 16) and spec tick (144 rows) and path 17's (D =
   96), the verify forms also at 80 rows of path 16's widths (Q = 5: one row
   group), the same way; K1, K1-f16 and K1-f32 at path 16's prefill widths
   (128 heads on 8, D = 128) on the serving prefill's batch against SDPA;
   the kernels line carries them under ``at_shapes``.
5. Main path 1: the lock-step OpenAI server, ``llama3-8b`` at full width and
   depth (32 layers), ``attention_impl=flash``, seed-initialised weights,
   run in-process on a thread so the kernels' launch counters can be read.
6. Main path 2: the continuous engine over the paged KV cache behind the
   same server code, over the same weights object (8 slots, page 256,
   context 2048, decode_chunk 16), answering 12 concurrent requests; K3 on
   every decode step, K1 on every cold prefill.
6a. Main path 7, speculative continuous serving: the continuous engine as
   ``infer/server.py --speculative on`` builds it (every tick speculates),
   over path 1's weights object, path 2's 12 requests plus four prompts that
   repeat a span: K3-verify 32 x verify rounds, the single-query K3 never;
   tokens per verify forward per row, ms per round beside path 2's ms per
   step, tokens/s; greedy tokens equal path 2's (the span prompts the plain
   engine's) up to each request's first divergence, where the two candidate
   tokens' logits in one plain forward over the common prefix must differ
   by less than ``SPEC_TIE_TOL``; then ``--speculative auto`` over the same
   weights (probing every 2 ticks): a measured threshold and both kinds of
   tick in ``/v1/stats``. Lock-step speculation: five greedy requests
   through ``--engine lockstep --speculative on`` (K1 on each prefill), held
   to path 1's Generator by the same rule, with their acceptance.
6a.1. Main path 18, draft-model speculation: the continuous engine as
   ``infer/server.py --speculative on --draft-preset`` builds it, over path
   1's weights object, drafting with the reference bench's drafter shape
   over the target's config (``DRAFT_WIDTHS``: hidden 512, 6 layers, 8 heads
   on 4; seed-initialised), path 2's 12 requests over HTTP: K3-verify 32 x
   verify rounds, the single-query K3 never, K1 on every cold prefill and
   draft prefill that tiles, (k + 1) draft steps a round, ``drafter:
   model`` in ``/v1/stats``; greedy tokens against path 2's by the
   divergence rule; tokens per verify forward per row, ms per round beside
   path 7's, tokens/s. Then the target at depth 2 (views of path 1's first
   two layers) as its own drafter: every live round accepts all k drafts
   but where the verify's logits are near a tie (``SPEC_TIE_TOL``).
6a.2. Main path 19, chunked prefill under a token budget: path 2's engine with
   ``prefill_chunk=512, token_budget=640`` (``CHUNK_PREFILL``,
   ``CHUNK_BUDGET``) on path 2's 12 requests over HTTP: K1 on every first
   chunk and cold prefill, K3 on every decode step, the 1501-, 1201- and
   1001-token prompts in 3, 3 and 2 chunks, a slot prefilling while others
   decode, every tick's prefill within max(512, 640 - decode_ready x 16),
   greedy tokens against path 2's by the divergence rule, the sampled
   requests again with the same tokens; then four decoding requests while
   three long prompts arrive, their time per output token and worst tick
   and the long prompts' TTFT, beside the same trace on path 2's engine
   (``_tick_recorder``, ``_interference_trace``).
6a.3. Main path 20, streaming, embeddings and API eval (``phase_serve_stream``)
   over path 1's weights with an lm head that writes printable ASCII
   (``ASCII_HEAD_SCALE``, so that streamed text is not empty): path 2's 12
   requests (the odd ones as chat, two sampled with pinned seeds) plus
   one of ``STOP_PROBES`` with a stop sequence across a chunk boundary,
   without a stream on a fresh path-2 engine, then streamed concurrently
   over SSE on another (both pre-warmed with the shared prefix's pages):
   texts, finish reasons and token ids equal, the role chunk, ``[DONE]``,
   ``Connection: close``, K3 on every decode step and K1 on every cold
   prefill; time to the first content chunk against path 2's TTFT; a client
   gone after two chunks frees its slot within four ticks and K3 stops;
   ``/v1/embeddings`` on four inputs padded to 1024 (K1 once a layer, unit
   norms, cosine with the plain forward ``EMBED_COS_MIN``, ``client.embed``
   the same vectors); ``train()`` on qwen2-0.5b (``EVAL_TRAIN_ARGS``) with
   the API eval every 2 steps against that server: 16 client requests, no
   retries, 16 served, K1 2 x 24 and K2a, K2b 24 a step beside the server's
   K1 and K3. Then the streaming check at depth 2 through path 7's
   prompt-lookup engine and path 18's drafter at depth 2 (``DEPTH2_DRAFT``;
   K3-verify on every round),
   and path 1's lock-step server (one content chunk, the same text).
6a.4. Main path 21, optimistic admission with preemption and exact resume,
   logprobs, deadlines and n/best_of (``phase_serve_preempt``), over path
   1's weights: eight 230-token requests with 96-token budgets (six
   greedy, then a greedy ``logprobs: 5`` one and a seeded sampled one) over
   HTTP to path 2's engine with ``logprobs_k=5`` on path 2's pool, then on 8
   usable pages under reserve and optimistic admission, each held until
   all have arrived: reserve decodes at most 4 slots together, optimistic
   more, with at least 4 preemptions, each resumed (its re-prefill and
   restore timed); K3 on every decode step and K1 on every cold prefill,
   resumes' included; greedy tokens the uncontended run's or diverging
   first at a near-tie (``RESUME_TIE_TOL``), the logprob request's logprobs
   its within ``LP_BF16_TOL``, the sampled request its tokens up to its
   preemption; peaks, preemptions, re-prefilled tokens, tokens/s and wall
   of both. A decode step with ``logprobs_k=5`` against 0 (the same
   tokens). At depth 2: speculative ticks over prompt lookup and over path
   18's drafter at depth 2, lookup over int8 pools and plain ticks over int8 pools,
   each preempting and resuming (K3-verify, K3-int8-verify or K3-int8 on
   every round or step; greedy tokens by the same rule). Over HTTP with
   path 20's ASCII head, ``--admission optimistic --logprobs-k 5``: top-1
   ids are the greedy tokens, chosen logprobs the lock-step Generator's
   within ``LP_BF16_TOL``, streamed ones the unstreamed ones; ``deadline_s:
   0`` 504 before any work, a queued request past a short deadline 504 with
   the free pages back; ``n: 2, best_of: 3`` ranked by mean logprob, copy 0
   the ``n: 1`` completion with the same seed.
6a.5. Main path 22, grammar-constrained decoding (``phase_serve_guided``),
   over path 1's weights and path 2's engine shape with a table of
   ``GUIDED_CAPACITY`` rows: the native token-table builder must build and
   give the numpy walk's table for the JSON grammar (byte DFA, native
   table, numpy walk, registration and upload timed, the table's MB);
   ``GUIDED_MIXED`` (four unconstrained requests, one sampled, beside four
   greedy guided ones over JSON, a regex, an order-free schema and an enum,
   and a sampled guided one) on the armed engine and a guided-off one: the
   unconstrained tokens identical, every guided completion on its
   grammar's byte DFA (a full match when it ended at EOS), each greedy
   guided request the tokens of a recompute oracle (``_guided_oracle``:
   plain prefill forward, mask, argmax) or diverging first at a near-tie
   (``RESUME_TIE_TOL``); K1 on every cold prefill, K3 on every decode step;
   a decode step with eight guided rows against none (armed and guided-off)
   and ``_fsm_mask`` alone at (8, 128256). At depth 2: prompt-lookup and
   path 18's drafter's ticks (at depth 2) give the plain guided ticks' tokens by the
   same rule (K3-verify on every round), and guided requests preempted and
   resumed under optimistic admission their uncontended tokens over float
   and int8 pools (K3, K3-int8). Over HTTP: ``guided_regex``,
   ``guided_json``, ``response_format`` ``json_object`` and ``json_schema``
   answer 200 with conforming text, a guided stream concatenates to the
   unstreamed text, two specs 400, ``/v1/stats`` the guided block, and a
   64-row server 503 for a JSON grammar (streamed too) with no rows taken.
6a.6. Main path 23, the contiguous KV cache (``phase_serve_contiguous``),
   over path 1's weights at full width and depth, 8 slots, context 2048:
   path 2's 12 requests over HTTP to the engine as ``--engine continuous``
   builds it with no ``--cache-mode``: greedy tokens against path 2's by the
   ``RESUME_TIE_TOL`` rule, sampled ones repeated per seed, K1 on every
   cold prefill whose bucket tiles, no paged kernel, no page field on
   ``/health`` or ``/v1/stats``, the cache's 2 GiB beside its reckoning;
   ``register_prefix`` of the 601-token shared prefix (four hits, no K1, the
   cold tokens by the rule, the stored logits' token for a prompt equal to
   the prefix, ``clear_prefixes`` freeing the row); the paged warm on path
   2's engine shape (K1 on the warm, 512 hit tokens for each shared request
   at admission, ``prefill_tok_per_s``; a no-op on a one-page pool); ms per
   decode step contiguous against paged, ``register_prefix`` ms on both
   modes and a prefix hit's TTFT against a cold prompt's. At depth 2:
   chunked prefill (384-token chunks under a 640-token budget, no K1),
   lookup speculation, a guided JSON request and logprobs give the plain
   contiguous ticks' tokens by the rule; int8 KV the paged int8 engine's.
6a.7. Main path 24, serving telemetry (``phase_serve_telemetry``), over path
   1's weights at full width and depth, 8 slots, context 2048, path 2's 12
   requests: over HTTP to the engine as ``--engine continuous --trace-dir
   DIR`` builds it (contiguous), half with a client ``traceparent`` and
   every third with an ``X-Request-Id``: greedy tokens against path 23's by
   the ``RESUME_TIE_TOL`` rule, ids echoed or generated, ``/metrics`` in
   the Prometheus text contract counting 12 requests, admissions,
   completions and TTFT/queue-wait/end-to-end observations and the
   responses' tokens, ``/slo`` grading its three objectives, the journal's
   span tree a request (``server.request`` > ``engine.request`` >
   queue/prefill/decode, token sums equal to the usage's, the client's
   trace id) and a tick instant a tick, the flight ring's rows; K1 on the
   cold prefills. Then path 2's paged engine by ``step()``, unarmed and
   armed: the same tokens, the same synchronising-op warnings a tick under
   ``set_sync_debug_mode("warn")``, K1 and K3 in both; ms per decode step
   armed against unarmed, the latency quantiles and span medians.
6b. Main path 6, int8 serving: the bf16 serving state is freed, then
   ``infer/server.py --quantize int8 --kv-quant int8 --engine continuous
   --cache-mode paged`` is built in process (``llama3-8b``, full width and
   depth): int8 weights resident beside their reckoning from the config,
   int8 pools plus scales against the bf16 pools at the same page count;
   path 2's 12 requests over HTTP (K3 over int8 pools on every decode step,
   the float K3 never, K1 on every cold prefill, the shared prefix hit),
   ms per step and tokens/s beside path 2's; five logprob requests through
   the lock-step ``Generator`` over an int8 cache (a repeated one gives the
   same tokens and logprobs); the same greedy request twice on the engine,
   identical; one decode step's logits through K3-int8 against the plain
   version. Then int8 with speculation: ``--kv-quant int8 --speculative on``
   at full width and depth 2, the continuous traffic's greedy requests plus
   the span prompts: K3-int8-verify on every round, greedy tokens against
   the same configuration's plain ticks by the divergence rule.
6c. Main path 8, f32 serving (after the int8 state is freed): paths 1 and
   2 again with ``--override dtype=float32`` (f32 weights, seed-initialised,
   f32 pools): K1-f32 on every prefill, K3-f32 on every decode step
   (counts against prefills and steps), prefill and decode-step logits
   against the plain versions (``F32_LOGITS_REL_TOL``), decode ms a step,
   time to first token, tokens/s against the f32 weight-read bound, pool
   bytes, peak memory; greedy tokens of both engines against the same
   requests through the plain versions (identical, or a near-tie by
   ``_tie_check``). Then ``--override dtype=float32 --speculative on`` at
   depth 2 (K3-f32-verify on every round, no other paged kernel).
   Main path 11, f32 serving over int8 pools (after path 8's state is
   freed): the same with ``--override dtype=float32 --kv-quant int8``:
   K1-f32 on every prefill (the lock-step int8 cache decodes outside any
   kernel, as in the reference), K3-int8-f32 on every decode step, pool
   bytes against path 8's; then its speculation at depth 2
   (K3-int8-f32-verify on every round; the same requests on a plain engine,
   K3-int8-f32 on every step). Main path 12, float16 serving
   (``--override dtype=float16``, 16.0 GiB of weights): K1-f16 on every
   prefill, K3-f16 on every decode step, finite logits and their largest
   magnitude; then float16 speculation at depth 2 (K3-f16-verify) and
   ``--kv-quant int8`` under float16 at depth 2 (K3-int8-f16 on the plain
   engine's steps, K3-int8-f16-verify on the speculative engine's rounds).
6d. Main path 9, f32 training: ``train()`` with ``F32_TRAIN_ARGS``
   (qwen2-0.5b at its published size, f32 masters and compute, flash, full
   remat, adafactor, the fused loss, the MLP and projection backward at the
   "xla" defaults), B=4, S=2048, ``F32_TRAIN_STEPS`` steps: falling finite
   losses, K1-f32 2 x 24 a step, K2a-f32 and K2b-f32 24 a step, step p50,
   tokens/s, MFU over the 495 TFLOP/s TF32 peak, peak memory; then one step
   at full depth through the f32 kernels against the plain versions (loss
   within ``F32_STEP_LOSS_TOL``, grad norm within ``F32_STEP_GNORM_TOL``).
6e. Main path 10, f32 training under the reference's kernel flags:
   ``train()`` with ``F32_KERNEL_ARGS`` (path 9 plus ``KERNEL_FLAGS``,
   ``mlp_bwd_block_f=256`` and ``proj_bwd_block_d=128``, which admit
   qwen2-0.5b's widths), ``F32_TRAIN_STEPS`` steps: falling finite losses,
   per step K5a-f32 and K5b-f32 24, K6-f32 96, K1-f32 48, K2a-f32 and
   K2b-f32 24, every bf16 kernel 0; step p50, tokens/s, MFU, peak memory;
   then one step's forward and backward at full depth, B=4, through the
   f32 K5/K6 against their plain versions (loss ``F32_STEP_LOSS_TOL``,
   grad norm ``F32_STEP_GNORM_TOL``, every leaf ``F32_STEP2_LEAF_TOL``).
6f. Main path 13, float16 training under the reference's kernel flags:
   ``train()`` with ``F16_KERNEL_ARGS`` (path 10 with ``model.dtype=float16``
   over the reference's default f32 masters; no loss scale, as in the
   reference), ``F32_TRAIN_STEPS`` steps: falling finite losses, per step
   K1-f16 48, K2a-f16, K2b-f16, K5a-f16 and K5b-f16 24, K6-f16 96, every
   other dtype's kernel 0; step p50, tokens/s, MFU over 989 TFLOP/s, peak
   memory. ``[f16-train-parity]``: one step's forward and backward at full
   depth, B=4, with K2a/K2b, K5a/K5b and K6 against their plain versions
   (bf16's ``STEP2_LOSS_TOL``/``STEP_GNORM_TOL``/``STEP2_LEAF_TOL``), the
   share of zero gradient entries logged; then the same on
   ``F16_8B_ARGS`` (llama3-8b's width in float16 over f32 masters, depth 2,
   B=1: K2 at D = 128, K5/K6 at the 8B widths). ``[f1]``: ``tiny-llama``
   (D = 32) in f32 with ``attention_impl=flash``, where the reference takes
   plain attention: one train step and one served prefill, finite, no flash
   launch of any dtype.
6g. Main path 14, the README's quick start: ``infer/server.py --preset
   tiny-llama --engine continuous --cache-mode paged`` (D = 32, 8/4 heads,
   hidden 256, vocab 32000, 4 layers) built by ``create_server``, path 2's
   12 requests over HTTP, then the same with ``--speculative on`` (its
   greedy requests and the span prompts), in bf16, over int8 pools, in
   float16 and in f32, each with and without int8 pools (``HD_SERVE_RUNS``):
   the single-query K3 of those pools and that dtype on every decode step,
   the verify on every round, no other paged kernel; one decode step's
   logits against the plain paged version; greedy tokens against the same
   requests through the plain versions (speculative: against the plain
   run), identical or a near-tie. Main path 15, head_dim 256
   (``GEMMA_SERVE``: google/gemma-2b's attention and MLP widths as the
   repo's Llama architecture, 8 heads on 1 KV head, vocab 256000, tied
   embeddings, ``attention_impl=flash``): the same runs, bf16 at full depth
   (18 layers: K1 at D = 256 on every cold prefill, K3 on every decode step)
   and every run at depth 2; then its training (``GEMMA_TRAIN_ARGS``, depth
   4, B=1, S=2048, 3 steps: K1, K2a, K2b at D = 256), one step at depth 4
   through the kernels against the plain versions, and one float16 and one
   f32 step at depth 2 the same way.
6h. Main path 16, Llama-3.1-405B's widths (``LLAMA405_SERVE``: the
   ``llama31-70b`` preset with hidden 16384, MLP 53248, 128 heads on 8 KV
   heads: G = 16), the runs of paths 14 and 15: bf16 at depth 4 of 126,
   plain and speculative (the decode tick's K3 at 16 query rows a KV head,
   the verify at 144 rows a KV head, K1 at G = 16 on every cold
   prefill), every other run at depth 2. Main path 17, Phi-3-mini-4k's
   widths (``PHI3_SERVE``: hidden 3072, MLP 8192, 32 layers, 32 heads
   without GQA, D = 96, vocab 32064): bf16 at full depth, every run at
   depth 2; prefill in plain attention (the reference's ``supports`` takes
   no D = 96); every request's prompt plus new tokens under the published
   2047-token sliding window, so it never binds. Both: the repeated greedy
   request gives identical tokens.
7. Main path 3: training. The serving weights and pools are freed first;
   then ``train()`` runs in-process with the launcher's arguments
   (``TRAIN_ARGS``: ``llama3-8b`` at full width and depth, bf16 masters,
   adafactor, flash attention, fused loss, full remat, B=4, S=2048, 6
   steps). Every loss must be finite and the last below the first; K2a and
   K2b launch once per layer per step, K1 twice (the forward and its remat
   recompute in the backward).
8. Training parity: one train step at full width, depth 2, B=1, through
   the kernels and again with ``flash_attention`` rebound to the plain
   versions, from the same parameters and batch: loss and grad_norm within
   ``STEP_LOSS_TOL``/``STEP_GNORM_TOL``.
9. The MLP and projection backward kernels against their plain versions
   (the K5 kernels' GEMM core alone in its four operand layouts; K5a/K5b
   at the training shape N=8192, D=4096, F=14336, where a second call must
   give the same bits, and at ragged ones: N = 2064 and 16, D and F = 384;
   K6 at the wq/wo, wk/wv and a ragged, strided shape, where both tile
   orders must give the same bits; ``MM_TOL``), K5a and K5b on fixed
   integer-made inputs against the digests of the build before K5b moved
   onto the kernel it shares with K6 (``K5_DIGESTS``), and their timings:
   kernel, plain, a library yardstick (autograd of the plain MLP forward for
   K5a + K5b together, of ``x @ w`` for K6), the bound from this run's
   shapes and the rate in TFLOP/s; K6 in both tile orders; cuBLAS on each K5
   kernel's own two products, and the K5 GEMM core alone on each of the
   four products beside cuBLAS on it.
10. Main path 4: ``train()`` with ``TRAIN_ARGS`` plus ``KERNEL_FLAGS``
   (``fused_gate_up``, ``mlp_bwd_impl=pallas``, ``proj_bwd_impl=pallas``),
   full width and depth, ``TRAIN4_STEPS`` steps: falling finite losses, K5a
   and K5b once per layer per step, K6 four times (wq, wk, wv, wo), K1, K2a
   and K2b as on path 3.
11. Training parity 2: the forward and backward of one train step at full
   width, depth 2, B=1, with ``KERNEL_FLAGS``, through the kernels and again
   with ``fused_mlp_bwd`` and ``projection_bwd`` rebound to their plain
   versions: loss, grad norm and every leaf's gradient
   (``STEP2_LOSS_TOL``/``STEP_GNORM_TOL``/``STEP2_LEAF_TOL``).
12. Main path 5, the JAX package's one-chip recipe: ``train()`` with
   ``TRAIN_ARGS`` + ``KERNEL_FLAGS`` + ``remat=dots_inputs`` at full width
   and depth, then ``remat=dots`` and ``remat=attn`` on the same
   configuration (``RECIPE_RUNS``), each from the same seed: falling finite
   losses; per policy step p50, tokens/s, MFU, peak device memory beside
   its reckoning from the kept outputs' shapes, and launches per step (K1
   64: the forward and its recompute, which no policy can skip, since a
   ctypes launch is not a dispatcher op; K2a, K2b, K5a, K5b 32; K6 128);
   peaks must order full (path 4) <= attn < dots < dots_inputs.
13. Remat parity: one train step at full width, depth 2, B=1 through the
   recipe's kernels under every policy and under ``remat=none``, from the
   same masters and batch: loss, grad norm and every updated master the
   same bits.
14. Checkpoint, resume and serve: the recipe at full width, depth 2,
   ``train()`` for 4 steps saving at 2 and 4 and validating on a held-out
   fifth of the corpus, then a run resumed from that step-2 checkpoint
   alone: losses, ``val_loss``, masters and optimizer state the same bits;
   save and restore seconds and a step's bytes. Then the continuous
   paged server with ``--checkpoint-dir`` (K1 on prefill, K3 on decode):
   greedy tokens equal the lock-step ``Generator``'s over the trained tree
   and differ from the run's starting weights'. The checkpoints live in the
   git-ignored ``_ckpt_smoke/`` of the checkout and are removed.
15. The kernels line, then the result line, last.

Each main path's launch counts are zeroed just before it runs and read just
after (path 5: before and after each policy's run). The paths run at full
depth (the speculative checks over other pools and dtypes, and path 15's
runs but its first, at depth 2): the whole script takes about seven minutes
on an H100, the build included.

f32 matrix products run in full f32 here (TF32 off, set below): the port's
lm head takes f32 products of bf16 values, as the JAX package's logits do,
and the f32 paths' plain versions and SDPA yardsticks multiply in f32.
"""

from __future__ import annotations

import functools
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

# bf16 outputs: the kernel rounds p to bf16 against its running row max, the
# plain version against the final max, and both round o to bf16, so they
# differ by a few bf16 ulps of values of magnitude <= ~4.
O_TOL = 2e-2
# f32 log-sum-exp: the kernel scales the q.k sums after the product, the
# plain version scales q first, and the sums run in another order.
LSE_TOL = 1e-3
# Logits of the flash prefill against the plain-attention prefill through 32
# bf16 layers: both round every activation to bf16, at different places in
# the attention, and the residual stream is bf16; relative L2 of the logits.
LOGITS_REL_TOL = 5e-2
# dq/dk/dv of K2a/K2b against the plain backward, relative to each
# gradient's largest magnitude: the kernels round p and ds to bf16 for the
# three second products (p.do, ds.k, ds.q) that the plain version computes
# in f32 (2^-9 relative per term, averaging out over the sums), and round
# the outputs to bf16.
BWD_TOL = 2e-2
# One 2-layer train step through K1/K2a/K2b against the same step through
# the plain versions: relative difference of the loss and of the gradient's
# global norm. Every activation is bf16 on both sides; K1 rounds p to bf16
# against its running max, and K2a/K2b round p and ds to bf16 for their
# second products, which moves each attention gradient by up to BWD_TOL of
# its scale, a small share of the whole model's gradient.
STEP_LOSS_TOL = 1e-3
STEP_GNORM_TOL = 1e-2
# K5a/K5b/K6 against their plain versions, relative to each output's largest
# magnitude: the same bf16 operands with f32 sums in another order, dgate,
# dup and inner rounded to bf16 at the same places (a rounding can land one
# bf16 ulp, 2^-8, apart), and SwiGLU's exponent from the fast intrinsic.
MM_TOL = 1e-2
# Training parity 2 swaps only backward kernels: the forward is the same
# code, so the loss agrees to f32 round-off; each leaf's gradient within
# STEP2_LEAF_TOL of its largest magnitude (bf16 gradients, the kernels'
# sums in another order, a few ulps through two layers' backward).
STEP2_LOSS_TOL = 1e-6
STEP2_LEAF_TOL = 2e-2
# Speculative against plain greedy tokens (bf16): the verify attends through
# K3-verify over a (k+1)-token chunk, the plain tick through K3 one token at a
# time, so their logits differ by bf16 rounding (the decode-step logits
# against the plain attention's: max abs ~0.07 at |logits| <= ~4.5, PERF.md),
# and a greedy token may flip where two candidates are that close (the JAX
# package's own note, ditl_tpu/infer/speculative.py). At a request's first
# divergence one plain forward over the common prefix scores both
# candidates; their logits must differ by less than this: a near-tie.
SPEC_TIE_TOL = 0.25
# The f32 kernels (K1-f32, K2a-f32, K2b-f32, K3-f32 and its verify, K4-f32)
# against their plain versions in f32, TF32 off: the same f32 operands with
# f32 sums in other orders (FFMA chains or 3xTF32 products against
# cuBLAS's f32 GEMMs) and the same exponent, so f32 round-off: o and lse
# within F32_O_TOL, each gradient within F32_BWD_TOL of its own largest
# magnitude, paged attention within F32_PAGED_TOL (the reference's own f32
# tolerance, tests/test_torch_paged.py).
F32_O_TOL = 1e-4
F32_BWD_TOL = 1e-4
F32_PAGED_TOL = 2e-5
# Path 8's logits through 32 f32 layers, kernels against plain attention:
# relative L2. Only the attention's sum order differs (f32 round-off, about
# 1e-7 relative a layer); 1e-4 leaves room for its growth through the
# residual stream of a seed-initialised model.
F32_LOGITS_REL_TOL = 1e-4
# Path 9's one step through the f32 kernels against the plain versions: f32's
# counterparts of STEP_LOSS_TOL / STEP_GNORM_TOL.
F32_STEP_LOSS_TOL = 1e-4
F32_STEP_GNORM_TOL = 1e-3
F32_TRAIN_STEPS = 3
# Path 9: qwen2-0.5b at its published size in f32 masters and compute,
# flash attention, full remat, adafactor, the fused loss; the MLP and
# projection backward at the reference's "xla" defaults.
F32_TRAIN_ARGS = [
    "--preset", "qwen2-0.5b", "model.dtype=float32", "model.param_dtype=float32",
    "model.attention_impl=flash", "model.loss_impl=fused", "model.loss_block_tokens=4096",
    "model.remat=full", "train.optimizer=adafactor", "train.warmup_steps=1",
    f"train.total_steps={F32_TRAIN_STEPS}", "train.log_every=1", "data.synthetic=true",
    "data.batch_size=4", "data.seq_len=2048",
]
TRAIN_STEPS = 6
TRAIN4_STEPS = 4
# Path 5, the JAX package's one-chip recipe (bench.py: remat="dots_inputs",
# fused_gate_up), then the other selective policies on the same config:
# (policy, steps).
RECIPE_RUNS = [("dots_inputs", 4), ("dots", 3), ("attn", 3)]
KERNEL_FLAGS = ["model.fused_gate_up=true", "model.mlp_bwd_impl=pallas",
                "model.proj_bwd_impl=pallas"]
# Path 10: path 9 under the reference's kernel flags. qwen2-0.5b's widths (D
# = 896, F = 4864) take K5/K6 only with these two of the reference's block
# fields (ops/mlp_bwd.py::supports, ops/projection.py::supports); without
# them both packages take the einsum backward.
F32_KERNEL_ARGS = F32_TRAIN_ARGS + KERNEL_FLAGS + ["model.mlp_bwd_block_f=256",
                                                   "model.proj_bwd_block_d=128"]
# K5a-f32, K5b-f32 and K6-f32 against their plain versions, TF32 off: 3xTF32
# products (each good to about 2^-21) with f32 sums in another order than
# the plain versions' SGEMMs, so each output within F32_MM_TOL of its own
# largest magnitude (measured: at most 1.5e-6, at contractions up to 9728).
F32_MM_TOL = 2e-5
# Path 10's full-depth step through them against the plain versions: every
# leaf's gradient within F32_STEP2_LEAF_TOL of its largest magnitude, f32's
# counterpart of STEP2_LEAF_TOL (which is a few bf16 ulps): the same
# products to about 2^-21 each, through 24 layers of the backward (measured:
# 2.5e-6).
F32_STEP2_LEAF_TOL = 1e-4
# Path 13's full-depth parity (float16 at 24 layers, B=4): without a loss
# scale, as in the reference, a float16 step's activation gradients lie
# among float16's subnormals, where one rounding flip moves a value by
# percents, and the flip grows through 24 layers: the same plain step with
# one product summed in another order lies several times STEP2_LEAF_TOL
# away in the q/k biases (whose gradient is rounding noise: softmax ignores
# a shift shared by a row's scores) and in wq, far more than bf16 at the
# same depth (chip_smoke logs this noise floor). So there each leaf of the
# kernels' step may lie within F16_NOISE_FACTOR times the measured floor
# where that exceeds STEP2_LEAF_TOL (three: the kernels sum in another order
# in three places, K2, K5 and K6, the noise leg in two); loss and grad norm
# keep their tolerances, and the depth-2 legs keep STEP2_LEAF_TOL.
F16_NOISE_FACTOR = 3.0
TRAIN_ARGS = [
    "--preset", "llama3-8b", "model.param_dtype=bfloat16", "model.attention_impl=flash",
    "model.loss_impl=fused", "model.loss_block_tokens=4096", "model.remat=full",
    "train.optimizer=adafactor", "train.warmup_steps=1", f"train.total_steps={TRAIN_STEPS}",
    "train.log_every=1", "data.synthetic=true", "data.batch_size=4", "data.seq_len=2048",
]
# Path 13: path 10 in float16 compute over the reference's default f32
# masters (ModelConfig.param_dtype): K1-f16, K2a-f16, K2b-f16, K5a-f16,
# K5b-f16 and K6-f16. No loss scale, as in the reference.
F16_KERNEL_ARGS = [a.replace("model.dtype=float32", "model.dtype=float16")
                   for a in F32_KERNEL_ARGS]
# The 8B leg of path 13's parity: path 4's configuration in float16 over f32
# masters (at depth 2, B=1: K2 at D = 128, K5/K6 at llama3-8b's widths).
F16_8B_ARGS = [a.replace("model.param_dtype=bfloat16", "model.param_dtype=float32")
               for a in TRAIN_ARGS] + KERNEL_FLAGS + ["model.dtype=float16"]

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32, SXM data sheet (path 9's MFU)
# The fastest f32-accurate product on the card: 3xTF32 (three TF32 passes,
# hi.hi + hi.lo + lo.hi) on the tensor cores; FFMA on the CUDA cores beside.
H100_F32_FLOPS = H100_TF32_FLOPS / 3
H100_FFMA_FLOPS = 67e12

# Each entry's "head_dims": the head dims its kernel was held against its
# plain version at in this run (None: the MLP and projection kernels have
# none); the paged kernels take every multiple of 16 up to 256, and any
# group count and verify-row count (paths 16 and 17).
KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:127",
        "path": "both serving paths' cold prefills (and the served checkpoint's), path "
                "18's draft prefills, path 19's first chunks; "
                "training forward and remat recompute, paths 3-5; path 15 (D = 256)",
        "head_dims": [32, 64, 128, 256],
    },
    "flash_dq": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:300",
        "path": "training backward, every layer, paths 3-5 and 15 (D = 256)",
        "head_dims": [32, 64, 128, 256],
    },
    "flash_dkv": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:362",
        "path": "training backward, every layer, paths 3-5 and 15 (D = 256)",
        "head_dims": [32, 64, 128, 256],
    },
    "paged_tail": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235",
        "path": "continuous paged decode ticks (and the served checkpoint's, path 19's "
                "beside chunked prefills); paths 14 "
                "(D = 32) and 15 (D = 256)",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:191",
        "path": "direct call",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_tail_int8": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (quantized=True)",
        "path": "int8 serving (path 6): continuous paged decode ticks over int8 pools",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_verify": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (q_groups, :248)",
        "path": "speculative continuous serving (paths 7 and 18, drafts by lookup or by "
                "a draft model): every verify round of every layer",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_verify_int8": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (q_groups, quantized=True)",
        "path": "speculative continuous serving over int8 pools: every verify round",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "flash_fwd_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_f32.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:127 (float32 operands)",
        "path": "f32 serving (path 8): cold prefills of both engines; f32 training "
                "(paths 9, 10): forward and remat recompute",
        "head_dims": [64, 128, 256],
    },
    "flash_dq_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_f32.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:300 (float32 operands)",
        "path": "f32 training backward (paths 9, 10), every layer",
        "head_dims": [64, 128, 256],
    },
    "flash_dkv_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_f32.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:362 (float32 operands)",
        "path": "f32 training backward (paths 9, 10), every layer",
        "head_dims": [64, 128, 256],
    },
    "paged_tail_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention_f32.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (float32 operands)",
        "path": "f32 serving (path 8): continuous paged decode ticks",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_verify_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention_f32.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (q_groups, float32 operands)",
        "path": "f32 speculative continuous serving: every verify round",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention_f32.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:191 (float32 operands)",
        "path": "direct call",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "mlp_dgu_dwdown": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/mlp_bwd.cu",
        "replaces": "ditl_tpu/ops/mlp_bwd.py:102",
        "path": "training backward with mlp_bwd_impl=pallas, every layer, paths 4-5",
        "head_dims": None,
    },
    "mlp_dh_dwgu": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/mlp_bwd.cu",
        "replaces": "ditl_tpu/ops/mlp_bwd.py:153",
        "path": "training backward with mlp_bwd_impl=pallas, every layer, paths 4-5",
        "head_dims": None,
    },
    "proj_bwd": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/projection_bwd.cu",
        "replaces": "ditl_tpu/ops/projection.py:79",
        "path": "training backward with proj_bwd_impl=pallas: wq, wk, wv, wo of every "
                "layer, paths 4-5",
        "head_dims": None,
    },
    "mlp_dgu_dwdown_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/gemm_f32.cu",
        "replaces": "ditl_tpu/ops/mlp_bwd.py:102 (float32 operands)",
        "path": "f32 training under the kernel flags (path 10), every layer",
        "head_dims": None,
    },
    "mlp_dh_dwgu_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/gemm_f32.cu",
        "replaces": "ditl_tpu/ops/mlp_bwd.py:153 (float32 operands)",
        "path": "f32 training under the kernel flags (path 10), every layer",
        "head_dims": None,
    },
    "proj_bwd_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/gemm_f32.cu",
        "replaces": "ditl_tpu/ops/projection.py:79 (float32 operands)",
        "path": "f32 training under the kernel flags (path 10): wq, wk, wv, wo of every "
                "layer",
        "head_dims": None,
    },
    "flash_fwd_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:127 (float16 operands)",
        "path": "float16 serving (path 12): every prefill of the lock-step engine, every "
                "cold prefill of the continuous one",
        "head_dims": [32, 64, 128, 256],
    },
    "paged_tail_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (float16 operands)",
        "path": "float16 serving (path 12): continuous paged decode ticks",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_verify_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (q_groups, float16 operands)",
        "path": "float16 speculative continuous serving: every verify round",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:191 (float16 operands)",
        "path": "direct call",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_tail_int8_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (quantized=True, float16 q)",
        "path": "float16 serving over int8 pools (--kv-quant int8): continuous decode ticks",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_verify_int8_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (q_groups, quantized=True, "
                    "float16 q)",
        "path": "float16 speculative serving over int8 pools: every verify round",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_tail_int8_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention_f32.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (quantized=True, float32 q)",
        "path": "f32 serving over int8 pools (path 11): continuous paged decode ticks",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "paged_verify_int8_f32": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/paged_attention_f32.cu",
        "replaces": "ditl_tpu/ops/paged_attention.py:235 (q_groups, quantized=True, "
                    "float32 q)",
        "path": "f32 speculative serving over int8 pools: every verify round",
        "head_dims": [16, 32, 64, 80, 96, 128, 256],
    },
    "flash_dq_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:300 (float16 operands)",
        "path": "float16 training (path 13): backward, every layer",
        "head_dims": [32, 64, 128, 256],
    },
    "flash_dkv_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:362 (float16 operands)",
        "path": "float16 training (path 13): backward, every layer",
        "head_dims": [32, 64, 128, 256],
    },
    "mlp_dgu_dwdown_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/mlp_bwd.cu",
        "replaces": "ditl_tpu/ops/mlp_bwd.py:102 (float16 operands)",
        "path": "float16 training under the kernel flags (path 13), every layer",
        "head_dims": None,
    },
    "mlp_dh_dwgu_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/mlp_bwd.cu",
        "replaces": "ditl_tpu/ops/mlp_bwd.py:153 (float16 operands)",
        "path": "float16 training under the kernel flags (path 13), every layer",
        "head_dims": None,
    },
    "proj_bwd_f16": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/projection_bwd.cu",
        "replaces": "ditl_tpu/ops/projection.py:79 (float16 operands)",
        "path": "float16 training under the kernel flags (path 13): wq, wk, wv, wo of "
                "every layer",
        "head_dims": None,
    },
}
# The decode tick's paged-attention shape on the main path: 8 slots, 32
# query / 8 KV heads, head_dim 128, page 256, a 16-column tail.
PAGED_MAIN = dict(b=8, h=32, kv=8, d=128, ps=256, tail_len=16)
# K3/K4 timings rotate through this many copies of their inputs: on the
# serving path each layer reads other pools, so no call may find its keys in
# the 50 MB L2 (6 x 17.8 MB of live K/V between two uses of one copy).
PAGED_COPIES = 6
SMI = ""  # nvidia-smi's name and power limit, set by phase_card

WORDS = ("tensor card kernel shard token layer cache batch prompt decode "
         "prefill attention memory stream warp block tile scale norm head "
         "route server request weight query key value logit sample").split()


def require(ok, what="") -> None:
    """A check that holds under ``python -O`` too (``assert`` is dropped)."""
    if not ok:
        raise AssertionError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def _text(seed: int, n_chars: int) -> str:
    rng = random.Random(seed)
    words: list[str] = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(rng.choice(WORDS))
    return " ".join(words)[:n_chars]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call over back-to-back eager calls, host issue included
    (CUDA events). L2 is not flushed: K1's callers pass one input, as a
    prefill's q/k/v were just written by its projections; K3/K4's rotate
    input copies through ``_cycle``."""
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


def _cycle(fns):
    """One callable that calls ``fns`` in turn, one per call."""
    state = {"i": 0}

    def call():
        fns[state["i"] % len(fns)]()
        state["i"] += 1

    return call


def _graph_ms(fns, rounds: int = 4, replays: int = 3) -> float:
    """Device time per call without host issue: ``rounds`` passes over
    ``fns`` captured in one CUDA graph, timed with CUDA events over
    ``replays`` replays."""
    import torch

    for fn in fns:  # first calls: lazy set-up and allocations
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * rounds * len(fns))
    del graph
    return ms


def _attn_inputs(b, s_q, s_kv, h, kv, d, *, seed, lengths=None, packed=False, dtype=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype or torch.bfloat16)

    q, k, v = rnd(b, s_q, h, d), rnd(b, s_kv, kv, d), rnd(b, s_kv, kv, d)
    seg = None
    if lengths is not None:  # the engine's prefill: real 1, right pads 0
        pos = torch.arange(s_q, device="cuda")
        seg = (pos[None, :] < torch.tensor(lengths, device="cuda")[:, None]).to(torch.int32)
        if packed:  # the first third is another packed document
            seg[:, : s_q // 3] *= 2
        seg = seg.contiguous()
    return q, k, v, seg


def _attended_pairs(b, s_q, s_kv, causal, seg) -> int:
    """(query, key) pairs the mask admits, summed over the batch: the work
    these inputs need, per head."""
    import torch

    mask = torch.ones(b, s_q, s_kv, dtype=torch.bool, device="cuda")
    if causal:
        mask &= torch.ones(s_q, s_kv, dtype=torch.bool, device="cuda").tril()[None]
    if seg is not None:
        mask &= seg[:, :, None] == seg[:, None, :]
    return int(mask.sum())


def _peak_flops(dtype) -> float:
    """The card's peak rate for products of ``dtype`` operands: bf16 on the
    tensor cores, or f32-accurate products (3xTF32) for float32."""
    import torch

    return H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS


def _bound(nbytes: float, flops: float, dtype):
    """max(bytes over HBM bandwidth, flops over the dtype's peak) in ms, and
    which of the two binds."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / _peak_flops(dtype)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _flash_bound(q, k, seg, causal):
    """Least time on an H100 SXM for the forward: bytes (q, k, v read once,
    o and lse written once, segment ids read once) over HBM bandwidth,
    against the attended pairs' 4*D flops each over the peak of q's dtype."""
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    es = q.element_size()
    nbytes = es * (2 * b * s_q * h * d + 2 * b * s_kv * kv * d) + 4 * b * h * s_q
    if seg is not None:
        nbytes += 4 * seg.numel()
    flops = 4 * d * h * _attended_pairs(b, s_q, s_kv, causal, seg)
    return _bound(nbytes, flops, q.dtype)


def phase_card() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    global SMI
    SMI = smi[0]
    log(smi[0])  # the card's name and power limit, as nvidia-smi gives them
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})")


def _kernel_name(line: str) -> str:
    """The kernel and its template arguments from ptxas' mangled entry name:
    a length-prefixed name that ends in ``_kernel``, then ``I...E``."""
    for m in re.finditer(r"\d+(?=[a-z])", line):
        start = m.end()
        names = [line[start:start + int(m.group()[i:])] for i in range(len(m.group()))]
        name = next((x for x in names if x.endswith("_kernel")), None)
        if name:
            args = re.match(r"I((?:L[ib]\d+E)+)E", line[start + len(name):])
            if args:
                return f"{name}<{', '.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
            return name
    return "?"


def _log_ptxas(name: str, path, tag: str = "build") -> None:
    """ptxas' register and spill lines of the build of ``name`` at ``path``,
    each named by its kernel."""
    ptxas = path.with_suffix(".log")
    kernel = ""
    for line in (ptxas.read_text().splitlines() if ptxas.is_file() else []):
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        elif "registers" in line or "spill" in line:
            log(f"[{tag}] {name} {kernel}: {line.strip()}")


def phase_build() -> None:
    from ditl_tpu_torch.ops.cuda_build import build_libraries

    t0 = time.perf_counter()
    built = build_libraries()
    log(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f}s")
    for name, path in built.items():
        _log_ptxas(name, path)


def _segment_ids(kind, b, s, train_seg):
    """(B, S) int32 ids for a K1 case: ``"train"`` the training pipeline's
    first batch, ``"nonmono"`` runs of random length (seeded) with ids that
    go up and down, ``"edge1"`` a boundary one row past a tile edge (ids 1
    up to position 129, then 2)."""
    import torch

    if kind == "train":
        return train_seg
    if kind == "edge1":
        ids = torch.ones(b, s, dtype=torch.int32)
        ids[:, 129:] = 2
    else:
        rng = random.Random(s)
        rows = []
        for _ in range(b):
            row: list[int] = []
            while len(row) < s:
                row += [rng.randrange(4)] * rng.randrange(1, 97)
            rows.append(row[:s])
        ids = torch.tensor(rows, dtype=torch.int32)
    return ids.cuda().contiguous()


def phase_kernels(flash, train_seg) -> dict:
    """Each kernel against its plain version; returns the max abs error."""
    import torch

    cases = [  # (b, s_q, s_kv, h, kv, d, causal, lengths or segment kind, packed)
        (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97], False),  # batched prefill
        (1, 512, 512, 32, 8, 128, True, [401], False),  # one request, 512 bucket
        (1, 256, 256, 32, 8, 128, True, [227], False),  # one request, 256 bucket
        (1, 128, 128, 32, 8, 128, True, [101], False),  # one request, 128 bucket
        (2, 200, 333, 16, 4, 128, False, None, False),  # ragged, non-causal
        (2, 300, 300, 8, 2, 64, True, [300, 170], True),  # head_dim 64, packed
        (1, 130, 130, 4, 4, 32, True, None, False),  # head_dim 32, MHA
        (4, 2048, 2048, 32, 8, 128, True, "train", False),  # the training batch
        (2, 300, 300, 8, 2, 128, True, "nonmono", False),  # ids up and down
        (1, 257, 257, 4, 2, 128, True, "edge1", False),  # boundary past a tile edge
        (1, 129, 129, 4, 1, 128, True, None, False),
        (1, 2064, 2064, 8, 2, 128, True, "nonmono", False),
        (2, 300, 300, 4, 2, 32, True, "nonmono", False),  # every head dim, both masks
        (2, 300, 300, 4, 2, 32, False, "nonmono", False),
        (2, 300, 300, 4, 2, 64, True, "nonmono", False),
        (2, 300, 300, 4, 2, 64, False, "edge1", False),
        (2, 300, 300, 4, 2, 128, False, "nonmono", False),
        (2, 300, 300, 4, 2, 128, False, None, False),
    ]
    worst = 0.0
    for i, (b, sq, skv, h, kv, d, causal, lengths, packed) in enumerate(cases):
        kind = lengths if isinstance(lengths, str) else None
        q, k, v, seg = _attn_inputs(b, sq, skv, h, kv, d, seed=i,
                                    lengths=None if kind else lengths, packed=packed)
        if kind:
            seg = _segment_ids(kind, b, sq, train_seg)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
        o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal=causal,
                                                     segment_ids=seg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
                f"flash_fwd case {i}: non-finite output")
        err = float((o.float() - o_ref.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=LSE_TOL)
        worst = max(worst, err)
        log(f"[kernels] flash_fwd B={b} Sq={sq} Skv={skv} H={h} K={kv} D={d} "
            f"causal={causal} seg={kind or ('yes' if seg is not None else 'no')}: "
            f"max|o-plain|={err:.3e} max|lse-plain|={lse_err:.3e} ok")
        del q, k, v, o, lse, o_ref, lse_ref
    return {"flash_fwd": worst}


def phase_timings(flash) -> dict:
    import torch
    import torch.nn.functional as F

    out = {}
    shapes = [  # (label, b, s, lengths): the first goes into the kernels line
        ("B=4 S=512", 4, 512, [512, 401, 230, 97]),
        ("B=1 S=512", 1, 512, [401]),
        # the continuous engine's cold prefills: one request, 128 to 2048
        # positions (at S=128, K1 launches 32 blocks for the 132 SMs)
        ("B=1 S=128", 1, 128, [101]),
        ("B=1 S=2048", 1, 2048, [1501]),
    ]
    for label, b, s, lengths in shapes:
        q, k, v, seg = _attn_inputs(b, s, s, 32, 8, 128, seed=100, lengths=lengths)
        groups = q.shape[2] // k.shape[2]
        # The library call: SDPA over the same function, with the causal and
        # segment mask as one boolean mask and the KV heads expanded (both
        # made outside the timed call).
        mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()[None]
        mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(groups, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(groups, dim=2).transpose(1, 2)
        ms = _time_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True,
                                                        segment_ids=seg))
        plain_ms = _time_ms(lambda: flash.flash_attention_plain(
            q, k, v, causal=True, segment_ids=seg), iters=5)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                 attn_mask=mask))
        ms2 = _time_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True,
                                                         segment_ids=seg))
        bound_ms, bound_by = _flash_bound(q, k, seg, True)
        log(f"[timing] flash_fwd {label} H=32 K=8 D=128 causal+seg: kernel "
            f"{ms:.4f}/{ms2:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / min(ms, ms2):.1%} of bound")
        out.setdefault("flash_fwd", {
            "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
        })
    return out


def _train_segments(b: int = 4, s: int = 2048):
    """The training main path's first batch's packed-document segment ids
    (the pipeline's own rows: several documents per row)."""
    import torch

    from ditl_tpu_torch.config import DataConfig
    from ditl_tpu_torch.data.dataset import synthetic_dataset
    from ditl_tpu_torch.data.loader import DataPipeline
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer

    cfg = DataConfig(batch_size=b, seq_len=s, synthetic=True)
    pipe = DataPipeline(synthetic_dataset(cfg.synthetic_examples, cfg.seed),
                        ByteTokenizer(), cfg, "cuda")
    batch = next(pipe._host_batches(0))
    return torch.from_numpy(batch["segment_ids"]).cuda().contiguous()


def _bwd_inputs(b, s_q, s_kv, h, kv, d, causal, seg, *, seed, flash, dtype=None,
                do_scale: float = 1.0):
    """q, k, v, the forward's o and lse through K1 (K1-f32 for float32), and
    an upstream gradient (normal values times ``do_scale``)."""
    import torch

    q, k, v, _ = _attn_inputs(b, s_q, s_kv, h, kv, d, seed=seed, dtype=dtype)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = (torch.randn(o.shape, generator=g, device="cuda") * do_scale).to(q.dtype)
    return q, k, v, o, lse, do


def _bwd_bound(q, k, seg, causal, kernel: str):
    """Least time on an H100 SXM for K2a (``dq``), K2b (``dkv``) or the whole
    backward (``all``: dq, dk, dv from q, k, v, o, lse and do): q, k, v, do
    read once (bf16), lse and delta once (f32; ``all`` reads o instead of
    delta), segment ids once, the outputs written once, over HBM bandwidth;
    against 2*D flops per attended (query, key) pair and head for each
    product (three for dq: q.k, do.v, ds.k; four for dkv: q.k, do.v, p.do,
    ds.q; five for all three gradients) at the peak of q's dtype."""
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    q_bytes, kv_bytes = q.element_size() * b * s_q * h * d, q.element_size() * b * s_kv * kv * d
    nbytes = 2 * q_bytes + 2 * kv_bytes + 4 * b * h * s_q
    nbytes += {"dq": q_bytes + 4 * b * h * s_q, "dkv": 2 * kv_bytes + 4 * b * h * s_q,
               "all": 2 * q_bytes + 2 * kv_bytes}[kernel]
    if seg is not None:
        nbytes += 4 * seg.numel()
    products = {"dq": 3, "dkv": 4, "all": 5}[kernel]
    flops = products * 2 * d * h * _attended_pairs(b, s_q, s_kv, causal, seg)
    return _bound(nbytes, flops, q.dtype)


def _bwd_segment_ids(spec, b, s, train_seg):
    """A backward case's ids: None, right-padded real ``lengths`` (a list),
    ``"packed"`` three documents a row, or a kind of ``_segment_ids``."""
    import torch

    if spec is None:
        return None
    if isinstance(spec, list):
        pos = torch.arange(s, device="cuda")
        lengths = torch.tensor(spec, device="cuda")
        return (pos[None, :] < lengths[:, None]).to(torch.int32).contiguous()
    if spec == "packed":
        seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
        seg[:, s // 3:] += 1
        seg[:, 2 * s // 3 + 5:] += 1
        return seg.contiguous()
    return _segment_ids(spec, b, s, train_seg)


def phase_bwd_kernels(flash, train_seg) -> dict:
    """K2a and K2b against the plain backward, on K1's cases (every head
    dim causal and not, the training batch, ids that go up and down, a
    boundary one row past a tile edge, right padding, ragged lengths, Sq !=
    Skv both ways), and two calls on the training batch bitwise equal (no
    atomics); returns the max abs errors."""
    import torch

    cases = [  # (b, s_q, s_kv, h, kv, d, causal, ids)
        (4, 2048, 2048, 32, 8, 128, True, "train"),  # the training shape
        (2, 333, 333, 8, 2, 64, True, "packed"),  # S % 64 != 0, head_dim 64
        (2, 200, 333, 8, 8, 128, False, None),  # MHA, non-causal, Sq != Skv
        (1, 130, 130, 4, 4, 32, True, None),  # head_dim 32
        (2, 300, 300, 8, 2, 128, True, "nonmono"),  # ids up and down
        (1, 257, 257, 4, 2, 128, True, "edge1"),  # boundary past a tile edge
        (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97]),  # right padding
        (1, 2064, 2064, 8, 2, 128, True, "nonmono"),
        (2, 300, 300, 4, 2, 32, True, "nonmono"),  # every head dim, both masks
        (2, 300, 300, 4, 2, 32, False, "nonmono"),
        (2, 300, 300, 4, 2, 64, True, "nonmono"),
        (2, 300, 300, 4, 2, 64, False, "edge1"),
        (2, 300, 300, 4, 2, 128, False, "nonmono"),
        (1, 129, 129, 4, 1, 128, True, None),
        (2, 200, 333, 8, 2, 64, True, None),  # causal, Sq < Skv
        (2, 333, 200, 8, 2, 128, True, None),  # causal, Sq > Skv
    ]
    worst = {"flash_dq": 0.0, "flash_dkv": 0.0}
    for i, (b, sq, skv, h, kv, d, causal, spec) in enumerate(cases):
        seg = _bwd_segment_ids(spec, b, sq, train_seg)
        q, k, v, o, lse, do = _bwd_inputs(b, sq, skv, h, kv, d, causal, seg,
                                          seed=400 + i, flash=flash)
        got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                        segment_ids=seg)
        want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                               segment_ids=seg)
        torch.cuda.synchronize()
        errs = []
        for name, x, ref in zip(("dq", "dk", "dv"), got, want):
            require(bool(torch.isfinite(x.float()).all()), f"{name} case {i}: non-finite")
            scale = float(ref.float().abs().max())
            err = float((x.float() - ref.float()).abs().max())
            torch.testing.assert_close(x.float(), ref.float(), rtol=0,
                                       atol=BWD_TOL * scale, msg=f"{name} case {i}")
            errs.append((name, err, scale))
        worst["flash_dq"] = max(worst["flash_dq"], errs[0][1])
        worst["flash_dkv"] = max(worst["flash_dkv"], errs[1][1], errs[2][1])
        kind = spec if isinstance(spec, str) else ("padded" if spec else "no")
        log(f"[kernels] flash_bwd B={b} Sq={sq} Skv={skv} H={h} K={kv} D={d} "
            f"causal={causal} seg={kind}: "
            + ", ".join(f"max|{n}-plain|={e:.3e} (max|{n}| {sc:.3e})" for n, e, sc in errs)
            + " ok")
        if i == 0:  # K2a owns query rows, K2b keys: no atomics, one order of sums
            again = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                              segment_ids=seg)
            torch.cuda.synchronize()
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    "flash_bwd: two calls differ")
            log("[kernels] flash_bwd training batch: two calls bitwise equal (dq, dk, dv) ok")
            del again
        del q, k, v, o, lse, do, got, want
    return worst


def _bwd_launchers(flash, q, k, v, o, lse, do, seg, causal):
    """K2a and K2b (or their f32 forms, by ``kernel_route``) as bare
    launches on preallocated outputs (the wrapper's arguments; delta
    computed once; K2b-f32 over its split workspace where the wrapper
    splits it, the runs and their sum timed together), for timing each
    kernel alone."""
    import torch

    b, s_q, h, d = q.shape
    dq_fn = flash._kernel(flash.kernel_route(q.dtype, d, "dq"), "dq")
    dkv_entry = flash.kernel_route(q.dtype, d, "dkv")
    s_kv, kv = k.shape[1], k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), None if seg is None else seg.data_ptr())

    def sizes():
        return (b, s_q, s_kv, h, kv, d, int(causal), d**-0.5,
                torch.cuda.current_stream().cuda_stream)

    def run_dq():
        require(dq_fn(*common, dq.data_ptr(), *sizes()) == 0, "K2a launch")

    def run_dkv():
        require(flash._run_dkv(dkv_entry, common, dk.data_ptr(), dv.data_ptr(), sizes(),
                               q.device) == 0, "K2b launch")

    return run_dq, run_dkv, (delta, dq, dk, dv)


def _tiles(flash, name, seg, causal, s) -> str:
    """A flash kernel's visited tiles at the training tiling
    (``tile_schedule``, per row and head): the tiles its blocks load and
    those its warpgroups compute, against the causal tiles of one document
    per row. K1 and K2a walk key tiles for blocks of query rows, K2b query
    tiles for blocks of keys."""
    b = 4 if seg is None else seg.shape[0]
    tilings = {  # (block tiling, warpgroup tiling) as (block_q, block_kv)
        "flash_fwd": ((flash.FWD_BLOCK_Q, flash.fwd_block_kv(128)),
                      (flash.FWD_WARPGROUP_ROWS, flash.fwd_block_kv(128))),
        "flash_dq": ((flash.BWD_DQ_BLOCK_Q, flash.fwd_block_kv(128)),
                     (flash.FWD_WARPGROUP_ROWS, flash.fwd_block_kv(128))),
        "flash_dkv": ((flash.BWD_DKV_BLOCK_Q, flash.bwd_dkv_block_kv(128)),
                      (flash.BWD_DKV_BLOCK_Q, flash.BWD_DKV_WARPGROUP_KEYS)),
    }[name]
    counts = []
    for block_q, block_kv in tilings:
        visit = int(flash.tile_schedule(seg, causal, s, s, block_q, block_kv).sum())
        every = int(flash.tile_schedule(None, causal, s, s, block_q, block_kv).sum())
        counts.append(f"{visit * (b if seg is None else 1)}/{every * b}")
    label = {"flash_fwd": "K1", "flash_dq": "K2a", "flash_dkv": "K2b"}[name]
    return (f"{label} tiles visited: {counts[0]} block tiles loaded, {counts[1]} "
            f"warpgroup tiles computed, of the causal tiles")


def phase_train_timings(flash, train_seg) -> dict:
    """K1, K2a and K2b at the training shape (B=4, S=2048, 32/8 heads,
    D=128, causal) on two inputs, each against one PyTorch call computing
    the same function on the same inputs: one document per row, where the
    yardsticks are one scaled_dot_product_attention call (causal,
    enable_gqa) and ``autograd.grad`` of its output (graph kept); and the
    pipeline's packed rows, where they are SDPA given the same packed causal
    mask as a boolean ``attn_mask`` and the grad of that call (KV heads
    expanded outside the timed calls). Each kernel alone (CUDA events over
    back-to-back calls, the better of two runs), then the whole backward
    wrapper (delta, K2a, K2b and the output allocations) against the SDPA
    backward; the plain versions; the bounds from these inputs; the tiles
    each kernel visits. Returns the one-document figures of K2a and K2b."""
    import torch
    import torch.nn.functional as F

    causal, s = True, 2048
    out: dict = {}
    for rows, seg in (("one document per row", None), ("packed rows", train_seg)):
        q, k, v, o, lse, do = _bwd_inputs(4, s, s, 32, 8, 128, causal, seg,
                                          seed=500, flash=flash)
        run_dq, run_dkv, keep = _bwd_launchers(flash, q, k, v, o, lse, do, seg, causal)
        do_t = do.transpose(1, 2)
        if seg is None:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            sdpa_kw = {"is_causal": True, "enable_gqa": True}
        else:
            groups = q.shape[2] // k.shape[2]
            mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()[None]
            mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
            qt = q.transpose(1, 2).detach().requires_grad_()
            kt, vt = (x.repeat_interleave(groups, dim=2).transpose(1, 2).detach()
                      .requires_grad_() for x in (k, v))
            sdpa_kw = {"attn_mask": mask}
        out_t = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

        def sdpa_bwd():
            torch.autograd.grad(out_t, (qt, kt, vt), grad_outputs=do_t, retain_graph=True)

        def fwd():
            flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)

        def bwd():
            flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)

        def plain_fwd():
            flash.flash_attention_plain(q, k, v, causal=causal, segment_ids=seg)

        def plain_bwd():
            flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                            segment_ids=seg)

        plain_bwd_ms = _time_ms(plain_bwd, iters=3, warmup=1)
        lib_bwd_ms = min(_time_ms(sdpa_bwd, iters=10), _time_ms(sdpa_bwd, iters=10))
        fwd_lib = ("sdpa (causal, enable_gqa)" if seg is None else
                   "sdpa (the same packed causal mask as attn_mask)")
        bwd_lib = ("sdpa backward" if seg is None else
                   "sdpa backward (the same packed causal mask as attn_mask)")
        segs = "" if seg is None else f" ({int(seg.max())} segments max)"
        for name, run, plain_ms, lib, bound in (
                ("flash_fwd", fwd, _time_ms(plain_fwd, iters=3, warmup=1),
                 _time_ms(sdpa_fwd), _flash_bound(q, k, seg, causal)),
                ("flash_dq", run_dq, plain_bwd_ms, lib_bwd_ms,
                 _bwd_bound(q, k, seg, causal, "dq")),
                ("flash_dkv", run_dkv, plain_bwd_ms, lib_bwd_ms,
                 _bwd_bound(q, k, seg, causal, "dkv")),
                ("flash_bwd", bwd, plain_bwd_ms, lib_bwd_ms,
                 _bwd_bound(q, k, seg, causal, "all"))):
            ms = min(_time_ms(run, iters=10), _time_ms(run, iters=10))
            bound_ms, bound_by = bound
            is_fwd = name == "flash_fwd"
            what = {"flash_fwd": "kernel", "flash_dq": "kernel", "flash_dkv": "kernel",
                    "flash_bwd": "wrapper (delta + K2a + K2b)"}[name]
            tiles = "" if name == "flash_bwd" else ", " + _tiles(flash, name, seg, causal, s)
            log(f"[timing] {name} training shape B=4 S={s} H=32 K=8 D=128 causal, "
                f"{rows}{segs}: {what} {ms:.4f} ms, plain {plain_ms:.4f} ms"
                f"{'' if is_fwd else ' (dq, dk, dv together)'}, "
                f"{fwd_lib if is_fwd else bwd_lib} {lib:.4f} ms "
                f"({ms / lib:.2f}x), bound {bound_ms:.4f} ms ({bound_by}), "
                f"{bound_ms / ms:.1%} of bound{tiles} ({SMI})")
            if seg is None and name in ("flash_dq", "flash_dkv"):
                out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib}
        del keep, q, k, v, o, lse, do, do_t, qt, kt, vt, out_t
        if seg is not None:
            del mask
    return out


def _model_flops_per_token(cfg, seq: int) -> float:
    """Matmul FLOPs per token of one forward (``bench.py``'s count: the
    projections, causal attention at average context (S+1)/2, the MLP and
    the lm head; 2 FLOPs per multiply-add)."""
    d, hd = cfg.hidden_size, cfg.head_dim
    nh, nkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    qkvo = 2 * d * (nh * hd) * 2 + 2 * d * (nkv * hd) * 2
    attn = 4 * ((seq + 1) / 2) * (nh * hd)
    mlp = 3 * 2 * d * f
    return cfg.num_layers * (qkvo + attn + mlp) + 2 * d * cfg.vocab_size


def phase_train(flash) -> dict:
    """Main path 3: ``train()`` over the launcher's arguments; returns the
    path's launch counts."""
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.train.trainer import train

    config, device = build_config(TRAIN_ARGS)
    cfg = config.model
    require((cfg.name, cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.param_dtype,
             cfg.attention_impl, cfg.loss_impl, cfg.remat, config.train.optimizer,
             device) == ("llama3-8b", 32, 4096, 128256, "bfloat16", "flash", "fused",
                         "full", "adafactor", "cuda"), config)
    flash.reset_launches()  # this path's counts start here
    summary = train(config, device=device)
    launches = {"flash_fwd": flash.launches, "flash_dq": flash.launches_dq,
                "flash_dkv": flash.launches_dkv}  # read right after the run
    losses = summary["losses"]
    require(summary["steps"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS, summary)
    require(all(x == x and abs(x) != float("inf") for x in losses), losses)
    require(losses[-1] < losses[0], losses)
    layers = cfg.num_layers
    require(launches["flash_dq"] == launches["flash_dkv"] == layers * TRAIN_STEPS,
            launches)
    # K1 runs in each layer's forward and again in its remat recompute.
    require(launches["flash_fwd"] == 2 * layers * TRAIN_STEPS, launches)
    step_s = summary["step_time_p50_s"]
    tps = summary["tokens_per_sec_per_chip_p50"]
    mfu = _model_flops_per_token(cfg, config.data.seq_len) * 3 * tps / H100_BF16_FLOPS
    log(f"[train] llama3-8b ({summary['params_m'] / 1e3:.3f}B parameters, bf16 masters, "
        f"adafactor, flash, fused loss, full remat) B=4 S=2048, {TRAIN_STEPS} steps: "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"[train] step time p50 {step_s:.3f} s, {tps:.1f} tokens/s, MFU {mfu:.1%} "
        f"(bench.py's flops per token x 3 over 989 TFLOP/s, remat not counted), "
        f"peak device memory {summary['peak_device_memory_gib']:.1f} GiB, wall "
        f"{summary['wall_s']:.1f} s ({SMI})")
    log(f"[train] launches: K1 {launches['flash_fwd']} = 2 x {layers} layers x "
        f"{TRAIN_STEPS} steps (forward + remat recompute), K2a {launches['flash_dq']} "
        f"and K2b {launches['flash_dkv']} = {layers} x {TRAIN_STEPS}")
    return launches


def phase_train_parity(flash, args=TRAIN_ARGS, num_layers: int = 2, batch_size: int = 1,
                       tols=(STEP_LOSS_TOL, STEP_GNORM_TOL), tag: str = "train") -> dict:
    """One train step of ``args``' configuration at full width, depth
    ``num_layers``, B=``batch_size`` through K1/K2a/K2b (their f32 forms
    for float32) and again with ``flash_attention`` rebound to the plain
    versions, from the same parameters and batch (float16: K1-f16, K2a-f16,
    K2b-f16). Returns the kernels step's launch counts."""
    import dataclasses

    from ditl_tpu_torch.config import DataConfig, TrainConfig
    from ditl_tpu_torch.data.dataset import synthetic_dataset
    from ditl_tpu_torch.data.loader import DataPipeline
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.train.state import TrainState, make_optimizer
    from ditl_tpu_torch.train.step import train_step

    config, _ = build_config(args)
    cfg = dataclasses.replace(config.model, num_layers=num_layers)
    sfx = DTYPE_SFX[cfg.dtype][0]
    tcfg = TrainConfig(optimizer="adafactor", warmup_steps=1, total_steps=6)
    dcfg = DataConfig(batch_size=batch_size, seq_len=2048, synthetic=True)
    batch = next(iter(DataPipeline(synthetic_dataset(256, 0), ByteTokenizer(), dcfg,
                                   "cuda").epoch(0)))
    base = llama.init_train_params(cfg, seed=1, device="cuda")

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        return tree.clone()

    results = []
    fwd, bwd = flash.flash_attention_fwd, flash.flash_attention_bwd
    for plain in (False, True):
        params = clone(base)
        opt = make_optimizer(tcfg, params)
        state = TrainState.create(params, opt)
        if plain:  # looked up at call time: swapped for this step only
            flash.flash_attention_fwd = flash.flash_attention_plain
            flash.flash_attention_bwd = flash.flash_attention_bwd_plain
        try:
            flash.reset_launches()
            m = train_step(state, batch, cfg, opt)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            counts = tuple(getattr(flash, n + sfx)
                           for n in ("launches", "launches_dq", "launches_dkv"))
        finally:
            flash.flash_attention_fwd, flash.flash_attention_bwd = fwd, bwd
        layers = cfg.num_layers  # K1 in the forward and the remat recompute
        require(counts == ((0, 0, 0) if plain else (2 * layers, layers, layers)), counts)
        if not plain:
            launched = {k + sfx: n for k, n in zip(("flash_fwd", "flash_dq", "flash_dkv"), counts)}
        results.append((loss, gnorm))
        del params, opt, state, m
    (lk, gk), (lp, gp) = results
    rel_l, rel_g = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    log(f"[{tag}] parity, one step of {cfg.name} ({cfg.dtype}) at full width, "
        f"{cfg.num_layers} layers, B={batch_size}, S=2048: kernels loss {lk:.6f} grad_norm "
        f"{gk:.6f}; plain loss {lp:.6f} grad_norm {gp:.6f}; relative differences "
        f"{rel_l:.3e}, {rel_g:.3e} (tolerances {tols[0]}, {tols[1]})")
    require(rel_l <= tols[0] and rel_g <= tols[1], (rel_l, rel_g))
    return launched


# ---------------------------------------------------------------------------
# K5a/K5b (MLP backward), K6 (projection backward), main path 4
# ---------------------------------------------------------------------------

# (label, N, D, F) of the llama3-8b training step (N = B*S = 4 x 2048) and
# ragged ones: N = 16 x 129, D and F odd multiples of 128 (256-wide tiles
# overhang them), the least N.
MLP_CASES = [("training shape", 8192, 4096, 14336), ("ragged", 2064, 256, 384),
             ("ragged, D = F = 384", 2064, 384, 384), ("N = 16", 16, 384, 384)]
# (M, N, K) of the GEMM core's own check: M and N overhang its 128 x 256
# tiles, K = 16 x 129 its 64-deep k-tiles.
CORE_CASE = (320, 384, 2064)
# (label, N, D, F, row stride of g or 0, the reference's blocks that admit N)
PROJ_CASES = [("wq/wo", 8192, 4096, 4096, 0, None), ("wk/wv", 8192, 4096, 1024, 0, None),
              ("ragged, strided g", 2064, 256, 384, 512, (16, 128))]


def _mm_bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _mlp_bounds(n: int, d: int, f: int, es: int = 2) -> dict:
    """Least time on an H100 SXM for K5a and K5b (``es``-byte elements in
    and out: 2, bf16 at the bf16 peak; 4, f32 at 3xTF32's): each input read
    once and each output written once over HBM bandwidth (K5a: g, w_down,
    gate|up in, dgu and d_w_down out; K5b: h, dgu, w_gu in, dh and d_w_gu
    out), against the kernel's two products (K5a: dinner and d_w_down,
    2*N*D*F flops each; K5b: dh and d_w_gu, 2*N*D*2F)."""
    k5a_bytes = es * (n * d + f * d + 2 * n * f) + es * (2 * n * f + f * d)
    k5b_bytes = es * (n * d + 2 * n * f + 2 * d * f) + es * (n * d + 2 * d * f)
    peak, sfx = (H100_F32_FLOPS, "_f32") if es == 4 else (H100_BF16_FLOPS, "")
    return {"mlp_dgu_dwdown" + sfx: _mm_bound(4.0 * n * d * f, k5a_bytes, peak),
            "mlp_dh_dwgu" + sfx: _mm_bound(8.0 * n * d * f, k5b_bytes, peak)}


def _proj_bound(n: int, d: int, f: int, es: int = 2):
    """K6: x, w, g read once and dx, dw written once (``es``-byte elements,
    as in ``_mlp_bounds``), against dx = g.w^T and dw = x^T.g, 2*N*D*F
    flops each."""
    return _mm_bound(4.0 * n * d * f, es * (2 * n * d + 2 * d * f + n * f),
                     H100_F32_FLOPS if es == 4 else H100_BF16_FLOPS)


def _randn(shape, seed: int, scale: float = 1.0, dtype=None):
    """Normal values times ``scale`` from a seeded card generator, in
    ``dtype`` (default bf16)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype or torch.bfloat16)


def _mlp_case(n: int, d: int, f: int, seed: int, dtype=None):
    """h, w_gu, w_down, the forward's gu (gate | up) and an upstream g at the
    scales of a layer's inputs (unit activations, fan-in weights), in
    ``dtype`` (default bf16)."""
    h = _randn((n, d), seed, dtype=dtype)
    w_gu = _randn((d, 2 * f), seed + 1, d**-0.5, dtype)
    w_down = _randn((f, d), seed + 2, f**-0.5, dtype)
    return h, w_gu, w_down, h @ w_gu, _randn((n, d), seed + 3, 0.1, dtype)


def _proj_case(n: int, d: int, f: int, ld: int, seed: int, dtype=None):
    """x (1, N, D), w (D, F) and g (1, N, F) in ``dtype`` (default bf16);
    with ``ld``, g is the first F columns of an (N, ld) gradient (a fused
    projection's split)."""
    x = _randn((1, n, d), seed, dtype=dtype)
    w = _randn((d, f), seed + 1, d**-0.5, dtype)
    g = _randn((1, n, ld or f), seed + 2, 0.1, dtype)[..., :f]
    return x, w, g


def _check_scaled(label: str, named, tol: float = MM_TOL, tag: str = "kernels",
                  quantum: float = 0.0) -> float:
    """``named``: (name, kernel output, plain output); each within ``tol`` of
    the plain output's largest magnitude, plus ``quantum`` (the outputs'
    own spacing where they are subnormal). Returns the largest error."""
    import torch

    worst, parts = 0.0, []
    for name, x, r in named:
        require(x.shape == r.shape and x.dtype == r.dtype, (label, name, x.shape, r.shape))
        require(bool(torch.isfinite(x.float()).all()), f"{label} {name}: non-finite")
        scale = float(r.float().abs().max())
        err = float((x.float() - r.float()).abs().max())
        torch.testing.assert_close(x.float(), r.float(), rtol=0, atol=tol * scale + quantum,
                                   msg=f"{label} {name}")
        worst = max(worst, err)
        parts.append(f"max|{name}-plain|={err:.3e} (max|{name}| {scale:.3e}, "
                     f"{err / max(scale, 1e-30):.2e} of it)")
    log(f"[{tag}] {label}: " + ", ".join(parts) + f" ok (tolerance {tol} of it)")
    return worst


# SHA-256 (first 16 hex digits) of the K5 kernels' outputs on the inputs of
# ``_k5_digests``, as the kernels built from commit 7db4668 (K5b a kernel of
# its own, before it and K6 shared the core's projection backward) gave them
# on an H100: K5a and K5b must keep these bits.
K5_DIGESTS = {
    "N=8192 D=4096 F=14336 dgu": "141a6da8c68aebce",
    "N=8192 D=4096 F=14336 d_w_down": "84ef8e9296991907",
    "N=8192 D=4096 F=14336 dh": "9ae98d5b6fc85a12",
    "N=8192 D=4096 F=14336 d_w_gu": "5da4fb3c9f38d9c3",
    "N=2064 D=384 F=384 dgu": "5ef53d8a3f547fb0",
    "N=2064 D=384 F=384 d_w_down": "6034a93c33c5a33f",
    "N=2064 D=384 F=384 dh": "2e65493b65f108e7",
    "N=2064 D=384 F=384 d_w_gu": "4a0382e58d9dd71c",
}


def _det_bf16(shape, salt: int, shift: int):
    """bf16 values made on the card by integer arithmetic alone (integers in
    [-1000, 1000] times 2**-shift, hashed from the position and ``salt``):
    the same bits whatever card, CUDA version or torch makes them."""
    import torch

    n = 1
    for x in shape:
        n *= x
    i = torch.arange(n, device="cuda", dtype=torch.int64)
    h = (i * 2654435761 + salt * 40503) % 4294967296
    h = (h ^ (h >> 15)) * 1274126177 % 4294967296
    return ((h % 2001 - 1000).float() * 2.0**-shift).reshape(shape).to(torch.bfloat16)


# ``_k1_digests``, as K1 built from commit a31cf38 (before its element type
# became a template parameter) gave them on an H100: the bf16 K1 must keep
# these bits.
K1_DIGESTS = {
    "serving prefill o": "f02dece29e8b24c6",
    "serving prefill lse": "d77d7591f3f90744",
    "packed D=64 o": "11e4064bbab891dc",
    "packed D=64 lse": "12d148447c1460bd",
    "D=32 no mask o": "c44b61ee7f702a88",
    "D=32 no mask lse": "92b62254061d03dd",
}


def _k1_digests(flash) -> dict:
    """K1 (bf16) on fixed integer-made inputs: the serving prefill (B=4,
    S=512, 32/8 heads, D=128, right-padded ids), packed rows at D=64 (G=4,
    S=300, ids in runs) and D=32 without a mask (Sq=200, Skv=333); SHA-256
    digests of o's and lse's bytes. Uses only the wrapper's forward
    signature, so it runs against an older tree's module too."""
    import hashlib

    import torch

    pos = torch.arange(512, device="cuda")
    padded = (pos[None] < torch.tensor([512, 401, 230, 97], device="cuda")[:, None])
    packed = torch.stack([torch.arange(300, device="cuda") // 70,
                          torch.arange(300, device="cuda") // 111]) + 1
    cases = [("serving prefill", 4, 512, 512, 32, 8, 128, True, padded.to(torch.int32)),
             ("packed D=64", 2, 300, 300, 8, 2, 64, True, packed.to(torch.int32)),
             ("D=32 no mask", 2, 200, 333, 8, 4, 32, False, None)]
    out = {}
    for i, (label, b, sq, skv, h, kv, d, causal, seg) in enumerate(cases):
        q = _det_bf16((b, sq, h, d), 800 + 10 * i, 9)
        k = _det_bf16((b, skv, kv, d), 801 + 10 * i, 9)
        v = _det_bf16((b, skv, kv, d), 802 + 10 * i, 9)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal,
                                           segment_ids=None if seg is None
                                           else seg.contiguous())
        torch.cuda.synchronize()
        for name, t in (("o", o.view(torch.int16)), ("lse", lse.view(torch.int32))):
            raw = t.contiguous().cpu().numpy().tobytes()
            out[f"{label} {name}"] = hashlib.sha256(raw).hexdigest()[:16]
    return out


def _k5_digests(mlp_bwd) -> dict:
    """K5a's (dgu, d_w_down) and K5b's (dh, d_w_gu) at the training shape and
    a ragged one, each kernel on fixed integer-made inputs (K5b's dgu one of
    them, not K5a's output), as SHA-256 digests of their bytes."""
    import hashlib

    import torch

    out = {}
    for n, d, f in ((8192, 4096, 14336), (2064, 384, 384)):
        g, w_down = _det_bf16((n, d), 1, 12), _det_bf16((f, d), 2, 16)
        gate, up = _det_bf16((n, 2 * f), 3, 9).chunk(2, dim=-1)
        h, dgu_in = _det_bf16((n, d), 4, 10), _det_bf16((n, 2 * f), 5, 12)
        w_gu = _det_bf16((d, 2 * f), 6, 16)
        outs = (*mlp_bwd.dgu_dwdown(g, w_down, gate, up), *mlp_bwd.dh_dwgu(h, dgu_in, w_gu))
        torch.cuda.synchronize()
        for name, t in zip(("dgu", "d_w_down", "dh", "d_w_gu"), outs):
            raw = t.contiguous().view(torch.int16).cpu().numpy().tobytes()
            out[f"N={n} D={d} F={f} {name}"] = hashlib.sha256(raw).hexdigest()[:16]
        del g, w_down, gate, up, h, dgu_in, w_gu, outs
    return out


# ``_k2_digests``, as K2a and K2b built from commit bf9ae81 (before their
# element type became a template parameter) gave them on an H100: the bf16
# K2a and K2b must keep these bits.
K2_DIGESTS = {
    "packed D=128 dq": "a3851892a3a340d9",
    "packed D=128 dk": "de4d5f70e3ed4c0d",
    "packed D=128 dv": "2a3fcb272095d6f9",
    "packed D=64 G=7 dq": "f5ae1e482e4ef37c",
    "packed D=64 G=7 dk": "fefbecb5521b0884",
    "packed D=64 G=7 dv": "b0f7a6c2d7a76fbf",
    "D=32 no mask dq": "83fcc1f25733cb14",
    "D=32 no mask dk": "b344fb8c29b523b0",
    "D=32 no mask dv": "ba80698925508695",
}


def _k2_digests(flash) -> dict:
    """K2a and K2b (bf16) on fixed integer-made inputs, through the
    backward wrapper, with o and lse from the bf16 K1 (held by
    ``K1_DIGESTS``): packed rows at D=128 (B=2, S=512, 32/8 heads), packed
    rows at D=64 and G=7 (S=300) and D=32 without a mask (Sq=200, Skv=333);
    SHA-256 digests of dq's, dk's and dv's bytes. Uses only the wrappers'
    signatures, so it runs against an older tree's module too."""
    import hashlib

    import torch

    packed = torch.stack([torch.arange(512, device="cuda") // 150,
                          torch.arange(512, device="cuda") // 97]) + 1
    runs = torch.stack([torch.arange(300, device="cuda") // 70,
                        torch.arange(300, device="cuda") // 111]) + 1
    cases = [("packed D=128", 2, 512, 512, 32, 8, 128, True, packed.to(torch.int32)),
             ("packed D=64 G=7", 2, 300, 300, 14, 2, 64, True, runs.to(torch.int32)),
             ("D=32 no mask", 2, 200, 333, 8, 4, 32, False, None)]
    out = {}
    for i, (label, b, sq, skv, h, kv, d, causal, seg) in enumerate(cases):
        q = _det_bf16((b, sq, h, d), 900 + 10 * i, 9)
        k = _det_bf16((b, skv, kv, d), 901 + 10 * i, 9)
        v = _det_bf16((b, skv, kv, d), 902 + 10 * i, 9)
        do = _det_bf16((b, sq, h, d), 903 + 10 * i, 9)
        seg = None if seg is None else seg.contiguous()
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
        grads = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
        torch.cuda.synchronize()
        for name, t in zip(("dq", "dk", "dv"), grads):
            raw = t.contiguous().view(torch.int16).cpu().numpy().tobytes()
            out[f"{label} {name}"] = hashlib.sha256(raw).hexdigest()[:16]
    return out


def phase_mm_kernels(mlp_bwd, proj) -> dict:
    """The K5 kernels' GEMM core alone in its four operand layouts; K5a and
    K5b (K5b fed the kernel's own dgu, and its plain version the same
    buffer), at the training shape also called twice, which must give the
    same bits; and K6, in both tile orders, against their plain versions.
    Then K5a and K5b on integer-made inputs against ``K5_DIGESTS``. Returns
    the largest absolute errors."""
    import torch

    worst = {"mlp_dgu_dwdown": 0.0, "mlp_dh_dwgu": 0.0, "proj_bwd": 0.0}
    m, n, k = CORE_CASE
    for a_mn in (False, True):
        for b_mn in (False, True):
            a = _randn((k, m) if a_mn else (m, k), 580)
            b = _randn((k, n) if b_mn else (n, k), 581)
            _check_scaled(f"gemm core M={m} N={n} K={k}, A {'MN' if a_mn else 'K'}-major, "
                          f"B {'MN' if b_mn else 'K'}-major",
                          [("c", mlp_bwd.gemm_core(a, b, a_mn, b_mn),
                            mlp_bwd.gemm_core_plain(a, b, a_mn, b_mn))])
    for i, (label, n, d, f) in enumerate(MLP_CASES):
        h, w_gu, w_down, gu, g = _mlp_case(n, d, f, seed=600 + 10 * i)
        gate, up = gu.chunk(2, dim=-1)  # views of gu, as the op saves them
        dgu, d_w_down = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
        dgu_ref, d_w_down_ref = mlp_bwd.dgu_dwdown_plain(g, w_down, gate, up)
        dh, d_w_gu = mlp_bwd.dh_dwgu(h, dgu, w_gu)
        dh_ref, d_w_gu_ref = mlp_bwd.dh_dwgu_plain(h, dgu, w_gu)
        torch.cuda.synchronize()
        shape = f"N={n} D={d} F={f} ({label})"
        worst["mlp_dgu_dwdown"] = max(worst["mlp_dgu_dwdown"], _check_scaled(
            f"mlp_dgu_dwdown {shape}", [("dgu", dgu, dgu_ref),
                                        ("d_w_down", d_w_down, d_w_down_ref)]))
        worst["mlp_dh_dwgu"] = max(worst["mlp_dh_dwgu"], _check_scaled(
            f"mlp_dh_dwgu {shape}", [("dh", dh, dh_ref), ("d_w_gu", d_w_gu, d_w_gu_ref)]))
        if i == 0:  # a second call: the same bits (no atomics in the sums; inner
            # read back only once it is complete)
            dgu2, d_w_down2 = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
            dh2, d_w_gu2 = mlp_bwd.dh_dwgu(h, dgu2, w_gu)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in ((dgu, dgu2), (d_w_down, d_w_down2),
                                                   (dh, dh2), (d_w_gu, d_w_gu2))]
            require(all(same), f"K5 {shape}: a second call gave other bits {same}")
            log(f"[kernels] mlp_dgu_dwdown, mlp_dh_dwgu {shape}: a second call gives the "
                f"same bits (dgu, d_w_down, dh, d_w_gu)")
            del dgu2, d_w_down2, dh2, d_w_gu2
        del h, w_gu, w_down, gu, g, gate, up, dgu, dgu_ref, dh, dh_ref
    for i, (label, n, d, f, ld, blocks) in enumerate(PROJ_CASES):
        x, w, g = _proj_case(n, d, f, ld, seed=700 + 10 * i)
        dx, dw = proj.projection_bwd(x, w, g, blocks=blocks)
        dx_ref, dw_ref = proj.projection_bwd_plain(x, w, g)
        # both tile orders, one of them the default: the same bits
        again = [proj.projection_bwd(x, w, g, blocks=blocks, dx_first=o) for o in (True, False)]
        torch.cuda.synchronize()
        worst["proj_bwd"] = max(worst["proj_bwd"], _check_scaled(
            f"proj_bwd N={n} D={d} F={f} ({label})", [("dx", dx, dx_ref), ("dw", dw, dw_ref)]))
        require(all(torch.equal(dx, a) and torch.equal(dw, b) for a, b in again),
                f"proj_bwd {label}: another call or tile order gave other bits")
        log(f"[kernels] proj_bwd N={n} D={d} F={f} ({label}): dx tiles first, dw tiles "
            f"first and the default order give the same bits")
        del x, w, g, dx, dw, dx_ref, dw_ref, again
    # K5a and K5b keep their bits: the moved K5b against the digests of the
    # kernels built before the move, on the same integer-made inputs.
    digests = _k5_digests(mlp_bwd)
    for key, value in digests.items():
        log(f"[kernels] K5 digest {key}: {value} (expected {K5_DIGESTS.get(key)})")
    require(digests == K5_DIGESTS, "K5a/K5b outputs differ from the earlier build's bits")
    log("[kernels] K5a and K5b: the same bits as the build before K5b moved onto the "
        "shared projection-backward kernel (training shape and N=2064 D=F=384)")
    return worst


def phase_mm_timings(mlp_bwd, proj) -> dict:
    """K5a, K5b and K6 at the training step's shapes: CUDA events over 10
    back-to-back calls, the better of two runs; the plain versions; one
    library yardstick each (the port never calls it): ``torch.autograd.grad``
    of the plain MLP forward with respect to (h, w_gu, w_down) for K5a and
    K5b together, and of ``x @ w`` with respect to (x, w) for K6; the
    bounds from these shapes."""
    import torch
    import torch.nn.functional as F

    out = {}
    _, n, d, f = MLP_CASES[0]
    h, w_gu, w_down, gu, g = _mlp_case(n, d, f, seed=800)
    gate, up = gu.chunk(2, dim=-1)
    dgu, _ = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
    leaves = [t.detach().clone().requires_grad_() for t in (h, w_gu, w_down)]
    gate_l, up_l = (leaves[0] @ leaves[1]).chunk(2, dim=-1)
    mlp_out = (F.silu(gate_l) * up_l) @ leaves[2]

    def library():
        torch.autograd.grad(mlp_out, leaves, grad_outputs=g, retain_graph=True)

    lib_ms = min(_time_ms(library, iters=10), _time_ms(library, iters=10))
    bounds = _mlp_bounds(n, d, f)
    flops = {"mlp_dgu_dwdown": 4.0 * n * d * f, "mlp_dh_dwgu": 8.0 * n * d * f}
    gf = gate.float()
    inner = (gf * torch.sigmoid(gf) * up.float()).to(torch.bfloat16)
    del gf
    # cuBLAS on each kernel's own two products (a yardstick of the GEMM core
    # alone, without K5a's SwiGLU epilogue; the port never calls it).
    cublas = {"mlp_dgu_dwdown": lambda: (g @ w_down.T, inner.T @ g),
              "mlp_dh_dwgu": lambda: (dgu @ w_gu.T, h.T @ dgu)}
    for name, run, plain in (
            ("mlp_dgu_dwdown", lambda: mlp_bwd.dgu_dwdown(g, w_down, gate, up),
             lambda: mlp_bwd.dgu_dwdown_plain(g, w_down, gate, up)),
            ("mlp_dh_dwgu", lambda: mlp_bwd.dh_dwgu(h, dgu, w_gu),
             lambda: mlp_bwd.dh_dwgu_plain(h, dgu, w_gu))):
        ms = min(_time_ms(run, iters=10), _time_ms(run, iters=10))
        plain_ms = _time_ms(plain, iters=3, warmup=1)
        cublas_ms = min(_time_ms(cublas[name], iters=10), _time_ms(cublas[name], iters=10))
        bound_ms, bound_by = bounds[name]
        log(f"[timing] {name} N={n} D={d} F={f}: kernel {ms:.4f} ms "
            f"({flops[name] / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library "
            f"(autograd of the plain MLP forward, dh, d_w_gu and d_w_down together) "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound ({SMI})")
        log(f"[timing] {name}: cuBLAS on the kernel's own two products "
            f"({'g @ w_down.T, inner.T @ g' if name == 'mlp_dgu_dwdown' else 'dgu @ w_gu.T, h.T @ dgu'}"
            f") {cublas_ms:.4f} ms ({flops[name] / cublas_ms / 1e9:.1f} TFLOP/s), a "
            f"yardstick the port never calls ({SMI})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    log(f"[timing] K5a + K5b {out['mlp_dgu_dwdown']['ms'] + out['mlp_dh_dwgu']['ms']:.4f} ms "
        f"against the library call's {lib_ms:.4f} ms ({SMI})")
    # The GEMM core alone on each of the four products, operands in the
    # layouts the kernels read them, beside cuBLAS on the same product: what
    # K5a's SwiGLU epilogue and each role's schedule add.
    for name, a, b, a_mn, b_mn in (("dinner", g, w_down, False, False),
                                   ("d_w_down", inner, g, True, True),
                                   ("dh", dgu, w_gu, False, False),
                                   ("d_w_gu", h, dgu, True, True)):
        fl = (2.0 if name in ("dinner", "d_w_down") else 4.0) * n * d * f
        ms = min(_time_ms(lambda: mlp_bwd.gemm_core(a, b, a_mn, b_mn), iters=10)
                 for _ in range(2))
        cms = min(_time_ms(lambda: (a.T if a_mn else a) @ (b if b_mn else b.T), iters=10)
                  for _ in range(2))
        log(f"[timing] GEMM core alone, {name} (A {'MN' if a_mn else 'K'}-major, B "
            f"{'MN' if b_mn else 'K'}-major): {ms:.4f} ms ({fl / ms / 1e9:.1f} TFLOP/s); "
            f"cuBLAS on the same product {cms:.4f} ms ({fl / cms / 1e9:.1f} TFLOP/s) ({SMI})")
    del h, w_gu, w_down, gu, g, gate, up, dgu, leaves, gate_l, up_l, mlp_out, inner
    for label, n, d, f, ld, blocks in PROJ_CASES[:2]:
        x, w, g = _proj_case(n, d, f, ld, seed=900)
        xl, wl = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
        y = xl @ wl
        ms = min(_time_ms(lambda: proj.projection_bwd(x, w, g), iters=10),
                 _time_ms(lambda: proj.projection_bwd(x, w, g), iters=10))
        plain_ms = _time_ms(lambda: proj.projection_bwd_plain(x, w, g), iters=3, warmup=1)
        lib_ms = min(_time_ms(lambda: torch.autograd.grad(y, (xl, wl), grad_outputs=g,
                                                          retain_graph=True), iters=10)
                     for _ in range(2))
        # Both tile orders, in turns (dx first, dw first, dw first, dx first).
        order_ms = {True: [], False: []}
        for order in (True, False, False, True):
            order_ms[order].append(_time_ms(
                lambda: proj.projection_bwd(x, w, g, dx_first=order), iters=10))
        bound_ms, bound_by = _proj_bound(n, d, f)
        flops = 4.0 * n * d * f
        log(f"[timing] proj_bwd {label} N={n} D={d} F={f}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library "
            f"(autograd.grad of x @ w) {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
            f"kernel / library {ms / lib_ms:.2f}x, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound ({SMI})")
        log(f"[timing] proj_bwd {label}: dx tiles first "
            f"{'/'.join(f'{t:.4f}' for t in order_ms[True])} ms, dw tiles first "
            f"{'/'.join(f'{t:.4f}' for t in order_ms[False])} ms (default: "
            f"{'dx' if proj.k6_dx_first(n, f) else 'dw'} first) ({SMI})")
        # The kernels line carries the wq/wo shape; wk/wv is logged beside it.
        out.setdefault("proj_bwd", {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                    "bound_by": bound_by, "library_ms": lib_ms})
    return out


def phase_train_kernels(flash, mlp_bwd, proj) -> dict:
    """Main path 4: ``train()`` with ``TRAIN_ARGS`` + ``KERNEL_FLAGS``;
    returns the path's launch counts."""
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.train.trainer import train

    config, device = build_config(TRAIN_ARGS + KERNEL_FLAGS
                                  + [f"train.total_steps={TRAIN4_STEPS}"])
    cfg = config.model
    require((cfg.name, cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
             cfg.fused_gate_up, cfg.mlp_bwd_impl, cfg.proj_bwd_impl, cfg.attention_impl,
             cfg.remat, config.train.total_steps, device)
            == ("llama3-8b", 32, 4096, 14336, True, "pallas", "pallas", "flash", "full",
                TRAIN4_STEPS, "cuda"), config)
    flash.reset_launches()  # this path's counts start here
    mlp_bwd.reset_launches()
    proj.reset_launches()
    summary = train(config, device=device)
    launches = {"flash_fwd": flash.launches, "flash_dq": flash.launches_dq,
                "flash_dkv": flash.launches_dkv, "mlp_dgu_dwdown": mlp_bwd.launches_dgu,
                "mlp_dh_dwgu": mlp_bwd.launches_dh,
                "proj_bwd": proj.launches}  # read right after the run
    losses = summary["losses"]
    require(summary["steps"] == TRAIN4_STEPS and len(losses) == TRAIN4_STEPS, summary)
    require(all(x == x and abs(x) != float("inf") for x in losses), losses)
    require(losses[-1] < losses[0], losses)
    layers, steps = cfg.num_layers, TRAIN4_STEPS
    require(launches["mlp_dgu_dwdown"] == launches["mlp_dh_dwgu"] == layers * steps,
            launches)
    require(launches["proj_bwd"] == 4 * layers * steps, launches)  # wq, wk, wv, wo
    require(launches["flash_dq"] == launches["flash_dkv"] == layers * steps, launches)
    require(launches["flash_fwd"] == 2 * layers * steps, launches)
    step_s = summary["step_time_p50_s"]
    tps = summary["tokens_per_sec_per_chip_p50"]
    mfu = _model_flops_per_token(cfg, config.data.seq_len) * 3 * tps / H100_BF16_FLOPS
    log(f"[train4] llama3-8b, path 3's recipe + fused_gate_up, mlp_bwd_impl=pallas, "
        f"proj_bwd_impl=pallas, B=4 S=2048, {steps} steps: losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[train4] step time p50 {step_s:.3f} s, {tps:.1f} tokens/s, MFU {mfu:.1%} "
        f"(bench.py's flops per token x 3 over 989 TFLOP/s, remat not counted), "
        f"peak device memory {summary['peak_device_memory_gib']:.1f} GiB, wall "
        f"{summary['wall_s']:.1f} s ({SMI})")
    log(f"[train4] launches: K5a {launches['mlp_dgu_dwdown']} and K5b "
        f"{launches['mlp_dh_dwgu']} = {layers} layers x {steps} steps, K6 "
        f"{launches['proj_bwd']} = 4 x {layers} x {steps}; K1 {launches['flash_fwd']}, "
        f"K2a {launches['flash_dq']}, K2b {launches['flash_dkv']}")
    return launches, summary


def phase_train_parity2(mlp_bwd, proj, args=TRAIN_ARGS + KERNEL_FLAGS, num_layers: int = 2,
                        batch_size: int = 1,
                        tols=(STEP2_LOSS_TOL, STEP_GNORM_TOL, STEP2_LEAF_TOL),
                        tag: str = "train4", flash=None, noise_leg: bool = False) -> dict:
    """Training parity 2: the forward and backward of one train step of
    ``args``' configuration (with ``KERNEL_FLAGS``) at full width, depth
    ``num_layers``, B=``batch_size``, S=2048, through K5a/K5b/K6 (their
    forms of the compute dtype) and again with their wrappers rebound to the
    plain versions, from the same parameters and batch: loss, grad norm and
    every leaf's gradient within ``tols``. With ``flash``, the flash
    backward wrapper (K2a, K2b) is rebound to its plain version too; the
    forward (K1) runs the kernel on both sides. With ``noise_leg``, a third
    step runs the plain versions with the input gradients of K6 (dx) and of
    K5b (dh) summed in another order (over each half of the contraction,
    then the two halves), where the kernels' own sums run in another order
    than the plain versions': its distance from the plain step is
    the step's own rounding noise, and each leaf of the kernels' step may
    lie within ``F16_NOISE_FACTOR`` times the largest such distance where
    that exceeds ``tols[2]`` (float16 at full depth: its gradients lie among
    float16's subnormals, where a one-ulp flip anywhere grows through the
    layers; ``F16_NOISE_FACTOR``'s note). Returns the share of exactly zero
    entries in the kernels' gradients, overall and of the embedding, and the
    noise floor."""
    import dataclasses

    import torch

    from ditl_tpu_torch.config import DataConfig
    from ditl_tpu_torch.data.dataset import synthetic_dataset
    from ditl_tpu_torch.data.loader import DataPipeline
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.train.state import TrainState, global_norm, make_leaves
    from ditl_tpu_torch.train.step import cast_for_compute, loss_fn

    config, _ = build_config(args)
    cfg = dataclasses.replace(config.model, num_layers=num_layers)
    require((cfg.fused_gate_up, cfg.mlp_bwd_impl, cfg.proj_bwd_impl)
            == (True, "pallas", "pallas"), cfg)
    sfx = DTYPE_SFX[cfg.dtype][0]
    counters = [(mlp_bwd, "launches_dgu"), (mlp_bwd, "launches_dh"), (proj, "launches")]
    if flash is not None:
        counters += [(flash, "launches_dq"), (flash, "launches_dkv")]
    names = [(m, c + sfx) for m, c in counters]
    others = [(m, c + o) for m, c in counters for o in ("", "_f16", "_f32") if o != sfx]
    dcfg = DataConfig(batch_size=batch_size, seq_len=2048, synthetic=True)
    batch = next(iter(DataPipeline(synthetic_dataset(256, 0), ByteTokenizer(), dcfg,
                                   "cuda").epoch(0)))
    base = llama.init_train_params(cfg, seed=2, device="cuda")

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        return tree.clone()

    def counts(which):
        return tuple(getattr(m, c) for m, c in which)

    def reordered(x, w, g, blocks=None):  # the noise leg's K6: dx over two halves of F
        _, dw = proj.projection_bwd_plain(x, w, g)
        f, h = w.shape[1], w.shape[1] // 2
        g2, wf = g.reshape(-1, f).float(), w.float()
        dx = g2[:, :h] @ wf[:, :h].T + g2[:, h:] @ wf[:, h:].T
        return dx.to(x.dtype).reshape(x.shape), dw

    def reordered_mlp(h, w_gu, w_down, gate, up, g, blocks=None):  # dh over gate, then up
        _, d_w_gu, d_w_down = mlp_bwd.fused_mlp_bwd_plain(h, w_gu, w_down, gate, up, g)
        b, s, d = h.shape
        f = w_down.shape[0]
        dgu, _ = mlp_bwd.dgu_dwdown_plain(g.reshape(-1, d), w_down, gate.reshape(-1, f),
                                          up.reshape(-1, f))
        dgu, wf = dgu.float(), w_gu.float()
        dh = dgu[:, :f] @ wf[:, :f].T + dgu[:, f:] @ wf[:, f:].T
        return dh.to(h.dtype).reshape(b, s, d), d_w_gu, d_w_down

    results = []
    fused, proj_bwd = mlp_bwd.fused_mlp_bwd, proj.projection_bwd
    flash_bwd = None if flash is None else flash.flash_attention_bwd
    layers_n = cfg.num_layers
    for plain in (False, True, "noise") if noise_leg else (False, True):
        params = clone(base)
        state = TrainState(params, make_leaves(params))
        if plain:  # looked up at call time: swapped for this step only
            mlp_bwd.fused_mlp_bwd = (reordered_mlp if plain == "noise" else
                                     lambda *a, blocks=None: mlp_bwd.fused_mlp_bwd_plain(*a))
            proj.projection_bwd = (reordered if plain == "noise" else
                                   lambda x, w, g, blocks=None: proj.projection_bwd_plain(
                                       x, w, g))
            if flash is not None:
                flash.flash_attention_bwd = flash.flash_attention_bwd_plain
        try:
            for m in {m for m, _ in counters}:
                m.reset_launches()
            layers, top = state.model_views(cast_for_compute(cfg))
            loss, _ = loss_fn(layers, top, batch, cfg)
            loss.backward()
            gnorm = float(global_norm(state.leaves))
            got, other = counts(names), counts(others)
        finally:
            mlp_bwd.fused_mlp_bwd, proj.projection_bwd = fused, proj_bwd
            if flash is not None:
                flash.flash_attention_bwd = flash_bwd
        want = (layers_n, layers_n, 4 * layers_n, layers_n, layers_n)[:len(names)]
        require(got == ((0,) * len(names) if plain else want) and set(other) <= {0},
                (got, other))
        grads = {"/".join(leaf.path): [p.grad for p in leaf.parts] for leaf in state.leaves}
        results.append((float(loss.detach()), gnorm, grads))
        del params, state, layers, top, loss
    (lk, gk, grads_k), (lp, gp, grads_p) = results[:2]
    rel_l, rel_g = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)

    def leaf_errors(grads):
        """(largest error relative to the plain leaf's largest magnitude, its
        leaf) over every leaf, and the errors by leaf."""
        errs = {}
        for path, parts in grads_p.items():
            for i, (x, r) in enumerate(zip(grads[path], parts)):
                require(bool(torch.isfinite(x).all()), (path, i, "non-finite gradient"))
                scale = float(r.float().abs().max())
                errs[f"{path}[{i}]"] = float((x.float() - r.float()).abs().max()) / max(
                    scale, 1e-30)
        leaf = max(errs, key=errs.get)
        return errs[leaf], leaf, errs

    worst, worst_leaf, errs = leaf_errors(grads_k)
    noise, noise_leaf, leaf_tol = 0.0, "", tols[2]
    if noise_leg:
        noise, noise_leaf, _ = leaf_errors(results[2][2])
        leaf_tol = max(tols[2], F16_NOISE_FACTOR * noise)
        log(f"[{tag}] noise floor: the plain step with K6's and K5b's input gradients "
            f"summed in another order (two halves of the contraction) lies {noise:.3e} of "
            f"its largest magnitude from the plain step "
            f"(leaf {noise_leaf}); the kernels' step may lie within max({tols[2]}, "
            f"{F16_NOISE_FACTOR} x {noise:.3e}) = {leaf_tol:.3e}")
    bad = {k: v for k, v in errs.items() if v > leaf_tol}
    require(not bad, (bad, leaf_tol))
    zeros = sum(int((p == 0).sum()) for parts in grads_k.values() for p in parts)
    total = sum(p.numel() for parts in grads_k.values() for p in parts)
    embed = grads_k["embed/embedding"][0]
    shares = {"zero_share": zeros / total, "embed_zero_share": float((embed == 0).float().mean()),
              "worst_leaf": worst, "noise_floor": noise}
    which = "K5a, K5b, K6" + (", K2a, K2b" if flash is not None else "")
    log(f"[{tag}] parity, one step's forward and backward of {cfg.name} ({cfg.dtype} compute, "
        f"{cfg.param_dtype} masters) at full width, {layers_n} layers, B={batch_size}, "
        f"S=2048, kernel flags: kernels loss {lk:.6f} grad_norm {gk:.6f}; plain loss "
        f"{lp:.6f} grad_norm {gp:.6f}; relative differences {rel_l:.3e}, {rel_g:.3e} "
        f"(tolerances {tols[0]}, {tols[1]}); worst leaf {worst_leaf} at {worst:.3e} of its "
        f"largest magnitude (tolerance {leaf_tol:.3e}); launches ({which}){sfx.replace('_', '-')} "
        f"{want} through the kernels, all 0 plain; exactly zero gradient entries "
        f"{shares['zero_share']:.4%} of all, {shares['embed_zero_share']:.4%} of the "
        f"embedding's")
    require(rel_l <= tols[0] and rel_g <= tols[1], (rel_l, rel_g))
    return shares


# ---------------------------------------------------------------------------
# Path 5 (the recipe and the selective remat policies), remat parity,
# checkpoint, resume and serve
# ---------------------------------------------------------------------------


def _kept_gib_per_layer(cfg, tokens: int) -> dict:
    """GiB a layer keeps for its backward under each selective policy, from
    the shapes: the weight products' outputs (q, k, v, o, gate|up, down),
    the tagged attn_in and mlp_in, or attn_out alone; bf16."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    products = (q + 2 * kv + d + 2 * f + d) * tokens * 2
    return {"dots": products / 2**30, "dots_inputs": (products + 2 * d * tokens * 2) / 2**30,
            "attn": q * tokens * 2 / 2**30}


def phase_recipe(flash, mlp_bwd, proj, full_peak_gib: float) -> dict:
    """Main path 5: ``train()`` with the JAX package's one-chip recipe
    (``TRAIN_ARGS`` + ``KERNEL_FLAGS`` + ``remat=dots_inputs``) at full width
    and depth, then ``dots`` and ``attn`` on the same configuration
    (``RECIPE_RUNS``), each from the same seed. Each run's counts start at 0
    just before it and are read just after; returns their sums."""
    import gc

    import torch

    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.train.trainer import train

    names = ("flash_fwd", "flash_dq", "flash_dkv", "mlp_dgu_dwdown", "mlp_dh_dwgu",
             "proj_bwd")
    total = dict.fromkeys(names, 0)
    peaks = {"full": full_peak_gib}
    for remat, steps in RECIPE_RUNS:
        config, device = build_config(TRAIN_ARGS + KERNEL_FLAGS + [
            f"model.remat={remat}", f"train.total_steps={steps}"])
        cfg = config.model
        require((cfg.name, cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                 cfg.vocab_size, cfg.param_dtype, cfg.remat, cfg.fused_gate_up,
                 cfg.mlp_bwd_impl, cfg.proj_bwd_impl, cfg.attention_impl, cfg.loss_impl,
                 config.train.optimizer, config.data.batch_size, config.data.seq_len,
                 device)
                == ("llama3-8b", 32, 4096, 14336, 128256, "bfloat16", remat, True,
                    "pallas", "pallas", "flash", "fused", "adafactor", 4, 2048, "cuda"),
                config)
        flash.reset_launches()  # this run's counts start here
        mlp_bwd.reset_launches()
        proj.reset_launches()
        summary = train(config, device=device)
        launches = dict(zip(names, (flash.launches, flash.launches_dq, flash.launches_dkv,
                                    mlp_bwd.launches_dgu, mlp_bwd.launches_dh,
                                    proj.launches)))  # read right after the run
        losses = summary["losses"]
        require(summary["steps"] == steps and len(losses) == steps, summary)
        require(all(x == x and abs(x) != float("inf") for x in losses), losses)
        require(losses[-1] < losses[0], losses)
        layers = cfg.num_layers
        # Per step: K1 in each layer's forward and again in its recompute
        # (a ctypes launch, which no policy can keep), the backward kernels
        # once per layer, K6 for wq, wk, wv and wo.
        per_step = {"flash_fwd": 2 * layers, "flash_dq": layers, "flash_dkv": layers,
                    "mlp_dgu_dwdown": layers, "mlp_dh_dwgu": layers, "proj_bwd": 4 * layers}
        require(launches == {k: v * steps for k, v in per_step.items()},
                (remat, launches, per_step))
        for k in names:
            total[k] += launches[k]
        step_s = summary["step_time_p50_s"]
        tps = summary["tokens_per_sec_per_chip_p50"]
        mfu = _model_flops_per_token(cfg, config.data.seq_len) * 3 * tps / H100_BF16_FLOPS
        peaks[remat] = summary["peak_device_memory_gib"]
        kept = _kept_gib_per_layer(cfg, config.data.batch_size * config.data.seq_len)
        reckoned = full_peak_gib + layers * kept[remat]
        log(f"[recipe] remat={remat}: llama3-8b, bf16 masters, adafactor, flash, fused "
            f"loss, fused_gate_up, mlp_bwd_impl=pallas, proj_bwd_impl=pallas, B=4 S=2048, "
            f"{steps} steps: losses {[round(x, 4) for x in losses]}")
        log(f"[recipe] remat={remat}: step time p50 {step_s:.3f} s, {tps:.1f} tokens/s, "
            f"MFU {mfu:.1%} (as path 3), peak device memory {peaks[remat]:.1f} GiB "
            f"(reckoned {reckoned:.1f} = path 4's {full_peak_gib:.1f} + {layers} x "
            f"{kept[remat]:.3f} kept a layer), wall {summary['wall_s']:.1f} s ({SMI})")
        log(f"[recipe] remat={remat}: launches per step: K1 "
            f"{launches['flash_fwd'] // steps}, K2a {launches['flash_dq'] // steps}, "
            f"K2b {launches['flash_dkv'] // steps}, K5a {launches['mlp_dgu_dwdown'] // steps}"
            f", K5b {launches['mlp_dh_dwgu'] // steps}, K6 {launches['proj_bwd'] // steps}")
        del summary
        gc.collect()
        torch.cuda.empty_cache()
    # full is the floor: under full and attn the peak can sit at the end of
    # the backward (every gradient live, no kept output left).
    require(peaks["full"] <= peaks["attn"] < peaks["dots"] < peaks["dots_inputs"], peaks)
    log(f"[recipe] peak device memory by policy: "
        f"{ {k: round(v, 2) for k, v in peaks.items()} } GiB ({SMI})")
    return total


def phase_remat_parity(flash, mlp_bwd, proj) -> None:
    """One train step at full width, depth 2, B=1, S=2048 through the
    recipe's kernels under each remat policy and under ``remat=none``, from
    the same masters and batch: loss, grad norm and every updated master
    must be the same bits (a policy moves no arithmetic, and the kernels are
    bitwise repeatable)."""
    import dataclasses

    import torch

    from ditl_tpu_torch.config import DataConfig, TrainConfig
    from ditl_tpu_torch.data.dataset import synthetic_dataset
    from ditl_tpu_torch.data.loader import DataPipeline
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.train.state import TrainState, make_optimizer, tree_to
    from ditl_tpu_torch.train.step import train_step

    config, _ = build_config(TRAIN_ARGS + KERNEL_FLAGS)
    tcfg = TrainConfig(optimizer="adafactor", warmup_steps=1, total_steps=6)
    dcfg = DataConfig(batch_size=1, seq_len=2048, synthetic=True)
    batch = next(iter(DataPipeline(synthetic_dataset(256, 0), ByteTokenizer(), dcfg,
                                   "cuda").epoch(0)))
    base_cfg = dataclasses.replace(config.model, num_layers=2)
    base = llama.init_train_params(base_cfg, seed=3, device="cuda")
    ref = None
    for remat in ("none", "full", "dots", "dots_inputs", "attn"):
        cfg = dataclasses.replace(base_cfg, remat=remat)
        params = tree_to(base, "cuda")
        opt = make_optimizer(tcfg, params)
        state = TrainState.create(params, opt)
        flash.reset_launches()
        mlp_bwd.reset_launches()
        proj.reset_launches()
        m = train_step(state, batch, cfg, opt)
        counts = (flash.launches, flash.launches_dq, flash.launches_dkv,
                  mlp_bwd.launches_dgu, mlp_bwd.launches_dh, proj.launches)
        require(counts == ((2 if remat == "none" else 4), 2, 2, 2, 2, 8), (remat, counts))
        out = (m["loss"].cpu(), m["grad_norm"].cpu(),
               [leaf.master for leaf in state.leaves])
        if ref is None:
            ref = out
            log(f"[remat] parity, one step at full width, 2 layers, B=1, S=2048, the "
                f"recipe's kernels: remat=none loss {float(out[0]):.6f} grad_norm "
                f"{float(out[1]):.6f}; launches (K1, K2a, K2b, K5a, K5b, K6) {counts}")
            continue
        same = (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
                and all(torch.equal(a, b) for a, b in zip(out[2], ref[2])))
        log(f"[remat] remat={remat}: loss {float(out[0]):.6f} grad_norm "
            f"{float(out[1]):.6f}, loss, grad norm and all {len(out[2])} updated masters "
            f"bitwise equal to remat=none: {same}; launches {counts}")
        require(same, remat)
        del state, opt, params, out
    del ref, base


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, n)) for r, _, names in os.walk(path)
               for n in names)


def phase_checkpoint_serve(flash, paged) -> dict:
    """The recipe at full width, depth 2, B=4, S=2048 through ``train()``:
    4 steps straight, saving at 2 and 4 and validating at both; then step 2
    moved into a directory of its own, and a run resumed there for the last
    2 steps. Losses, ``val_loss``, masters and optimizer state must be the
    same bits. Then
    the continuous paged server with ``--checkpoint-dir`` serves the trained
    weights: its greedy completions equal the lock-step ``Generator``'s over
    the trained tree and differ from those of the run's starting weights.
    Returns the serving launches."""
    import dataclasses
    import os
    import shutil

    import torch

    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.engine import GenerateConfig, Generator
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.train.checkpoint import CheckpointManager
    from ditl_tpu_torch.train.state import TrainState, make_optimizer
    from ditl_tpu_torch.train.trainer import train

    # In the checkout (git-ignored), removed at the end: three 2.9 GB steps
    # at most at once.
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    straight_dir, resumed_dir = os.path.join(root, "straight"), os.path.join(root, "resumed")
    overrides = ["model.num_layers=2", "model.remat=dots_inputs", "train.total_steps=4",
                 "train.checkpoint_every=2", "data.eval_fraction=0.2", "train.val_every=2",
                 "train.val_batches=2"]
    try:
        config, device = build_config(TRAIN_ARGS + KERNEL_FLAGS + overrides
                                      + [f"train.checkpoint_dir={straight_dir}"])
        cfg = config.model
        straight = train(config, device=device)
        require(sorted(os.listdir(straight_dir)) == ["2", "4"], os.listdir(straight_dir))
        os.makedirs(resumed_dir)  # the run that stopped at step 2
        os.rename(os.path.join(straight_dir, "2"), os.path.join(resumed_dir, "2"))
        rconfig = dataclasses.replace(config, train=dataclasses.replace(
            config.train, checkpoint_dir=resumed_dir, keep_checkpoints=1))
        resumed = train(rconfig, device=device)
        require(resumed["resumed_from"] == 2 and resumed["steps"] == 4, resumed)
        require(resumed["losses"] == straight["losses"][2:],
                (straight["losses"], resumed["losses"]))
        val = straight["val_loss"]
        require(val == val and abs(val) != float("inf") and resumed["val_loss"] == val,
                (val, resumed["val_loss"]))
        states = []
        for d in (straight_dir, resumed_dir):
            params = llama.init_train_params(cfg, seed=5, device="cuda")
            st = TrainState.create(params, make_optimizer(config.train, params))
            t0 = time.perf_counter()
            _, pos = CheckpointManager(d).restore_latest(st)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            require((st.step, pos.global_step) == (4, 4), (st.step, pos))
            states.append((st, pos))
        (a, pos_a), (b, pos_b) = states
        require(pos_a == pos_b, (pos_a, pos_b))
        sa, sb = a.state_dict(), b.state_dict()
        leaves = [(la.master, lb.master) for la, lb in zip(a.leaves, b.leaves)]
        opt_a, opt_b = _tensors(sa["opt_state"]), _tensors(sb["opt_state"])
        same = (all(torch.equal(x, y) for x, y in leaves) and len(opt_a) == len(opt_b)
                and all(torch.equal(x, y) for x, y in zip(opt_a, opt_b))
                and sa["opt_state"]["count"] == sb["opt_state"]["count"])
        log(f"[checkpoint] the recipe at full width, 2 layers, B=4 S=2048: 4 steps "
            f"straight, losses {[round(x, 4) for x in straight['losses']]}; resumed at "
            f"step 2 from the straight run's step-2 checkpoint, losses "
            f"{[round(x, 4) for x in resumed['losses']]}; val_loss at step 4 (20% of "
            f"the corpus held out) {val:.6f} in both; masters ({len(leaves)} leaves) and "
            f"optimizer state ({len(opt_a)} tensors) bitwise equal: {same}; data position "
            f"{pos_a}")
        require(same, "resumed state differs from the straight run's")
        # The save and the restore alone, on the trained state.
        mgr = CheckpointManager(os.path.join(root, "timed"))
        t0 = time.perf_counter()
        mgr.save(4, a, pos_a)
        copy_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        step_bytes = _dir_bytes(os.path.join(root, "timed", "4"))
        log(f"[checkpoint] save {save_s:.3f} s (of which the copy to the host, before "
            f"the next step may start, {copy_s:.3f} s), restore into a fresh state "
            f"{restore_s:.3f} s, {step_bytes / 2**30:.3f} GiB a step ({step_bytes} bytes; "
            f"params.pt {os.path.getsize(os.path.join(root, 'timed', '4', 'params.pt'))})")
        shutil.rmtree(os.path.join(root, "timed"))
        del states, a, b, sa, sb, leaves, opt_a, opt_b
        trained = llama.serving_params(
            torch.load(os.path.join(straight_dir, "4", "params.pt"), weights_only=True),
            cfg, "cuda")
        start = llama.init_params(cfg, seed=config.train.seed, device="cuda")

        # The server over the straight run's checkpoint.
        server = server_mod.create_server([
            "--preset", "llama3-8b", "--override", "num_layers=2",
            "--override", "attention_impl=flash", "--override", "fused_gate_up=true",
            "--checkpoint-dir", straight_dir, "--engine", "continuous",
            "--cache-mode", "paged", "--max-cache-len", "2048", "--device", "cuda",
            "--host", "127.0.0.1", "--port", "0"])
        gen = server.RequestHandlerClass.generator
        require(all(torch.equal(x, y) for x, y in zip(_tensors(gen.params),
                                                      _tensors(trained))),
                "the server does not hold the checkpoint's weights")
        threaded = server.RequestHandlerClass.threaded_engine
        outputs: dict = {}
        generate_one = threaded.generate_one

        def recording(prompt_tokens, **kw):
            out = generate_one(prompt_tokens, **kw)
            outputs[tuple(prompt_tokens)] = list(out)
            return out

        threaded.generate_one = recording
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        prompts = [_text(60, 300), _text(61, 700)]
        try:
            flash.reset_launches()  # this path's counts start here
            paged.reset_launches()
            bodies = []
            for p in prompts:
                status, body = _http("POST", url + "/v1/completions",
                                     {"prompt": p, "max_tokens": 8})
                require(status == 200, (status, body))
                bodies.append(body)
            launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail}
        finally:
            server.close(drain=True)
            thread.join(timeout=30)
        require(not thread.is_alive(), "server thread did not stop")
        tok = gen.tokenizer
        greedy = GenerateConfig(max_new_tokens=8)
        lockstep = Generator(trained, cfg, tok, device="cuda")
        seeded = Generator(start, cfg, tok, device="cuda")
        n_differ = 0
        for p, body in zip(prompts, bodies):
            ids = [tok.bos_id] + tok.encode(p)
            served = outputs[tuple(ids)]
            want = lockstep.generate_tokens([ids], greedy)[0]
            before = seeded.generate_tokens([ids], greedy)[0]
            log(f"[checkpoint] served {served} (text {body['choices'][0]['text']!r}); "
                f"lock-step Generator over the trained tree {want}; the run's starting "
                f"weights {before}")
            require(served == want, (served, want))
            n_differ += served != before
        require(n_differ == len(prompts), "training did not move a greedy completion")
        require(launches["flash_fwd"] >= cfg.num_layers and launches["paged_tail"] >= 1,
                launches)
        log(f"[checkpoint] served the trained checkpoint: K1 {launches['flash_fwd']}, K3 "
            f"{launches['paged_tail']} launches ({SMI})")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _tensors(tree):
    """Every tensor of a nested dict/list, in order."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []



def _paged_inputs(b, h, kv, d, ps, tail_len, lengths, starts, *, seed, n_pool=65,
                  share=True, nq=None, maxp=None, dtype=None):
    """q, pools, tails and a table giving each slot its own pages for
    ceil(max(starts, lengths) / ps) blocks, in a table of ``maxp`` columns
    (default: the most any slot needs); with ``share``, rows 1 and 2 share
    their first physical page. ``nq``: a verify's (B, Q, H, D) q; ``dtype``
    (default bf16) of q, pools and tails."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype or torch.bfloat16)

    q = rnd(b, h, d) if nq is None else rnd(b, nq, h, d)
    kp, vp = rnd(n_pool, kv, ps, d), rnd(n_pool, kv, ps, d)
    tk, tv = rnd(b, kv, tail_len, d), rnd(b, kv, tail_len, d)
    maxp = maxp or max(1, max(-(-max(x, y) // ps) for x, y in zip(lengths, starts)))
    table = torch.zeros((b, maxp), dtype=torch.int32)
    pid = 1
    for row in range(b):
        for i in range(min(maxp, -(-max(lengths[row], starts[row]) // ps))):
            table[row, i] = pid
            pid += 1
    require(pid <= n_pool, (pid, n_pool))
    if share:
        table[2, 0] = table[1, 0]

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    return q, kp, vp, table.cuda(), ints(lengths), ints(starts), tk, tv


def _paged_main_case():
    """The main path's decode-tick shape with the ragged state of a busy
    tick: each slot's tokens [0, starts) in pages, [starts, lengths) in the
    tail; a dead slot, a partial page, an exact page boundary (512), a
    shared page, and starts == lengths (no live tail)."""
    starts = [0, 700, 512, 1490, 9, 256, 1030, 300]
    lengths = [0, 710, 512, 1500, 10, 256, 1046, 309]
    return starts, lengths


def _paged_bound(q, kp, table, lengths, starts, tail: bool):
    """Least time on an H100 SXM for one call: the live keys' K and V (read
    once per slot that reads them), q and o, the table and the lengths over
    HBM bandwidth, against 4*D flops per (query head, live key) at the
    peak of q's dtype. Live keys: positions [0, min(starts, lengths)) from
    pages plus [starts, lengths) from the tail, or [0, lengths) from pages
    for K4."""
    b, h, d = q.shape
    kv = kp.shape[1]
    es = q.element_size()
    lengths = [int(x) for x in lengths.tolist()]
    starts = [int(x) for x in starts.tolist()]
    live = sum(lengths) if not tail else sum(
        min(s, n) + max(0, n - s) for s, n in zip(starts, lengths))
    nbytes = 2 * live * kv * d * es + 2 * (es * b * h * d) + 4 * (table.numel() + 2 * b)
    flops = 4 * d * h * live
    return _bound(nbytes, flops, q.dtype)


def phase_paged_kernels(paged) -> dict:
    """K3 and K4 against the plain version; returns the max abs errors and
    K4's direct-call launches."""
    import torch

    main = PAGED_MAIN
    starts, lengths = _paged_main_case()
    cases = [  # (b, h, kv, d, ps, tail_len, lengths, starts)
        (main["b"], main["h"], main["kv"], main["d"], main["ps"], main["tail_len"],
         lengths, starts),
        (4, 8, 4, 64, 16, 8, [0, 5, 38, 50], [0, 0, 32, 45]),  # head_dim 64, page 16
        (3, 8, 8, 128, 16, 16, [17, 40, 33], [16, 33, 33]),  # MHA, page 16
        # split edges (splits of SPLIT_KEYS): keys one past a split, ending on
        # a split boundary, a tile across the last page and the tail
        (4, 32, 8, 128, 16, 16, [257, 256, 513, 140], [257, 250, 500, 128]),
        (3, 16, 2, 64, 48, 8, [300, 1, 40], [297, 0, 33]),
    ]
    worst = {"paged_tail": 0.0, "paged": 0.0}
    paged.reset_launches()
    for i, (b, h, kv, d, ps, tl, lens, sts) in enumerate(cases):
        q, kp, vp, table, ln, st, tk, tv = _paged_inputs(b, h, kv, d, ps, tl, lens, sts,
                                                         seed=200 + i, n_pool=128)
        o3 = paged.paged_attention(q, kp, vp, table, ln, tail_k=tk, tail_v=tv, starts=st)
        r3 = paged.paged_attention_plain(q, kp, vp, table, ln, tk, tv, st)
        s3 = paged.paged_attention_split_plain(q, kp, vp, table, ln, tk, tv, st)
        o4 = paged.paged_attention(q, kp, vp, table, ln)
        r4 = paged.paged_attention_plain(q, kp, vp, table, ln)
        s4 = paged.paged_attention_split_plain(q, kp, vp, table, ln)
        # a second call: the same bits
        again = (paged.paged_attention(q, kp, vp, table, ln, tail_k=tk, tail_v=tv, starts=st),
                 paged.paged_attention(q, kp, vp, table, ln))
        torch.cuda.synchronize()
        for name, o, r, sp, o2 in (("paged_tail", o3, r3, s3, again[0]),
                                   ("paged", o4, r4, s4, again[1])):
            require(bool(torch.isfinite(o.float()).all()), f"{name} case {i}: non-finite")
            torch.testing.assert_close(o.float(), r.float(), atol=O_TOL, rtol=O_TOL)
            torch.testing.assert_close(o.float(), sp.float(), atol=O_TOL, rtol=O_TOL)
            require(torch.equal(o, o2), f"{name} case {i}: a second call gave other bits")
            err = float((o.float() - r.float()).abs().max())
            err_split = float((o.float() - sp.float()).abs().max())
            worst[name] = max(worst[name], err)
            dead = [j for j, n in enumerate(lens) if n == 0]
            require(all(bool((o[j] == 0).all()) for j in dead), f"{name}: dead slot")
            log(f"[kernels] {name} B={b} H={h} K={kv} D={d} ps={ps} T={tl} "
                f"lengths={lens} starts={sts if name == 'paged_tail' else '-'}: "
                f"max|o-plain|={err:.3e}, max|o-split plain|={err_split:.3e}, a second call "
                f"the same bits ok")
    direct = paged.launches
    require((direct, paged.launches_tail) == (2 * len(cases), 2 * len(cases)),
            (direct, paged.launches_tail))
    return {**worst, "paged_direct_launches": direct}


def _device_us_by_kernel(fn, calls: int) -> dict:
    """Device time per call of each kernel ``fn`` launches: torch.profiler's
    CUDA activity over ``calls`` calls after one warm-up, by kernel name
    (template arguments kept, namespaces and parameters dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        m = re.search(r"\w+_kernel(?:<[^()]*>)?", evt.key)
        name = m.group(0) if m else evt.key[:40]
        out[name] = out.get(name, 0.0) + evt.self_device_time_total / calls
    return out


def phase_paged_timings(paged) -> dict:
    """K3 and K4 at the main path's decode-tick shape: kernel, plain, SDPA
    over the same slots' keys gathered beforehand (with the length mask),
    and the bound. Every call reads one of ``PAGED_COPIES`` input copies in
    turn, so none finds its keys in L2. The kernels line takes device times
    from CUDA-graph replays (host issue taken out); the eager times, issue
    included, are logged beside them."""
    import torch
    import torch.nn.functional as F

    m = PAGED_MAIN
    starts, lengths = _paged_main_case()
    copies = [_paged_inputs(m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"],
                            lengths, starts, seed=300 + c, share=False)
              for c in range(PAGED_COPIES)]
    q, kp, _, table, ln, st, _, _ = copies[0]  # table, lengths, starts: shared
    b, h, d = q.shape
    kv, ps = kp.shape[1], kp.shape[2]
    maxp = table.shape[1]
    cols = torch.arange(maxp * ps, device="cuda")
    tail_cols = torch.arange(m["tail_len"], device="cuda")
    out = {}
    for name, tail in (("paged_tail", True), ("paged", False)):
        kernel, plain, library = [], [], []
        for q, kp, vp, table, ln, st, tk, tv in copies:
            # Library yardstick inputs, built outside the timed call: every
            # slot's page keys, then its tail, at the KV heads' count (SDPA
            # groups the query heads), and a boolean validity mask.
            k_all = kp[table.long()].transpose(2, 3).reshape(b, maxp * ps, kv, d)
            v_all = vp[table.long()].transpose(2, 3).reshape(b, maxp * ps, kv, d)
            if tail:
                k_all = torch.cat([k_all, tk.transpose(1, 2)], dim=1)
                v_all = torch.cat([v_all, tv.transpose(1, 2)], dim=1)
                valid = torch.cat([cols[None] < torch.minimum(st, ln)[:, None],
                                   st[:, None] + tail_cols[None] < ln[:, None]], dim=1)
                kw = dict(tail_k=tk, tail_v=tv, starts=st)
            else:
                valid = cols[None] < ln[:, None]
                kw = {}
            qt = q[:, :, None]  # (B, H, 1, D)
            kt = k_all.transpose(1, 2).contiguous()  # (B, K, S, D)
            vt = v_all.transpose(1, 2).contiguous()
            mask = valid[:, None, None, :]
            kernel.append(functools.partial(paged.paged_attention, q, kp, vp, table,
                                            ln, **kw))
            plain.append(functools.partial(paged.paged_attention_plain, q, kp, vp,
                                           table, ln, *kw.values()))
            library.append(functools.partial(F.scaled_dot_product_attention, qt, kt,
                                             vt, attn_mask=mask, enable_gqa=True))
        ms = _graph_ms(kernel)
        plain_ms = _graph_ms(plain, rounds=1)
        lib_ms = _graph_ms(library)
        ms2 = _graph_ms(kernel)
        # The split length, each timed in the same way (the kernels line keeps
        # the default).
        default, variants = paged.SPLIT_KEYS, []
        try:
            for split in (128, 256, 512):
                paged.SPLIT_KEYS = split
                variants.append(f"split {split} {_graph_ms(kernel):.4f}")
        finally:
            paged.SPLIT_KEYS = default
        log(f"[timing] {name} split lengths, device (CUDA graph) ms: {', '.join(variants)} "
            f"(default {default}) ({SMI})")
        eager_ms = _time_ms(_cycle(kernel), iters=4 * PAGED_COPIES)
        eager_lib_ms = _time_ms(_cycle(library), iters=4 * PAGED_COPIES)
        # Where a call's device time goes: the split kernel, then the merge.
        by_kernel = _device_us_by_kernel(_cycle(kernel), 4 * PAGED_COPIES)
        log(f"[timing] {name} device time per call by kernel (torch.profiler, eager calls): "
            + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(by_kernel.items()))
            + f" ({SMI})")
        bound_ms, bound_by = _paged_bound(q, kp, table, ln, st, tail)
        sdpa_mb = 2 * kt.numel() * 2 / 1e6
        log(f"[timing] {name} B={b} H={h} K={kv} D={d} ps={ps} T={m['tail_len']} "
            f"lengths={lengths} starts={starts if tail else '-'}, {PAGED_COPIES} input "
            f"copies in turn: device (CUDA graph) kernel {ms:.4f}/{ms2:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (enable_gqa, reads {sdpa_mb:.1f} MB "
            f"of padded K/V), kernel / sdpa {min(ms, ms2) / lib_ms:.2f}x; eager, host "
            f"launches included: kernel {eager_ms:.4f} ms, "
            f"sdpa {eager_lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / min(ms, ms2):.1%} of bound ({SMI})")
        out[name] = {"ms": min(ms, ms2), "eager_ms": eager_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    return out


def _http(method: str, url: str, payload: dict | None = None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _prefill_logits(gen, cfg, ids: list[int]):
    """The engine's first prefill for one prompt (bucketed, right-padded,
    causal with pad segments, into an empty cache): last-position f32
    logits."""
    import torch

    from ditl_tpu_torch.infer.cache import init_cache
    from ditl_tpu_torch.infer.engine import _next_pow2
    from ditl_tpu_torch.models import llama

    bucket = _next_pow2(len(ids))
    x = torch.full((1, bucket), gen.tokenizer.pad_id, dtype=torch.long, device="cuda")
    x[0, : len(ids)] = torch.tensor(ids, device="cuda")
    pos = torch.arange(bucket, device="cuda")
    seg = (pos < len(ids)).to(torch.int32)[None].contiguous()
    cache = init_cache(cfg, 1, bucket, "cuda")
    hidden = llama.forward(gen.params, x, cfg, positions=pos[None], segment_ids=seg,
                           cache=cache, cache_index=0, prefill_causal=True,
                           return_hidden=True)
    return llama.logits_from_hidden(gen.params, hidden[:, len(ids) - 1])[0]


# Serving compute dtype -> (kernel and counter suffix, log tag prefix).
DTYPE_SFX = {"bfloat16": ("", ""), "float16": ("_f16", "f16-"), "float32": ("_f32", "f32-")}


def phase_serve(flash, paged, dtype: str = "bfloat16", kv_int8: bool = False):
    """Main path 1, the lock-step server; with ``dtype`` the lock-step half
    of path 8 (``--override dtype=float32``, K1-f32), path 11 (the same plus
    ``--kv-quant int8``: a contiguous int8 cache, whose decode runs outside
    any kernel, as in the reference) or path 12 (``dtype=float16``,
    K1-f16). Returns its Generator (whose weights the continuous half
    reuses) and the path's launch counts."""
    import dataclasses

    import torch

    from ditl_tpu_torch.infer import server as server_mod

    sfx, prefix = DTYPE_SFX[dtype]
    tag = prefix + ("int8-serve" if kv_int8 else "serve")
    t0 = time.perf_counter()
    server = server_mod.create_server([
        "--preset", "llama3-8b", "--override", "attention_impl=flash",
        "--override", f"dtype={dtype}", *(["--kv-quant", "int8"] if kv_int8 else []),
        "--device", "cuda", "--host", "127.0.0.1", "--port", "0", "--seed", "0",
    ])
    gen = server.RequestHandlerClass.generator
    cfg = gen.cfg
    require((cfg.name, cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
             cfg.vocab_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.attention_impl, cfg.dtype)
            == ("llama3-8b", 32, 4096, 14336, 128256, 32, 8, 128, "flash", dtype)
            and (cfg.kv_cache_dtype == "int8") == kv_int8, cfg)

    def total(tree, fn):
        if isinstance(tree, torch.Tensor):
            return fn(tree)
        return sum(total(sub, fn) for sub in tree.values())

    n_params = total(gen.params, torch.Tensor.numel)
    # A decode step reads every weight once, except the embedding table
    # (one row per token).
    step_bytes = total({k: v for k, v in gen.params.items() if k != "embed"},
                       lambda t: t.numel() * t.element_size())
    torch.cuda.synchronize()
    log(f"[{tag}] llama3-8b ({dtype}) built in {time.perf_counter() - t0:.1f}s: "
        f"{n_params / 1e9:.3f}B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card; a decode "
        f"step reads {step_bytes / 1e9:.2f} GB of weights: "
        f"{step_bytes / H100_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    tok = gen.tokenizer
    chat_msgs = [{"role": "system", "content": _text(1, 60)},
                 {"role": "user", "content": _text(2, 140)}]
    long_prompt = _text(3, 400)
    requests = [  # (route, payload, prompt text as the server builds it)
        ("/v1/completions", {"prompt": _text(0, 100), "max_tokens": 16}, _text(0, 100)),
        ("/v1/chat/completions", {"messages": chat_msgs, "max_tokens": 16},
         server_mod._chat_prompt(chat_msgs)),
        ("/v1/completions", {"prompt": long_prompt, "max_tokens": 24, "logprobs": 1},
         long_prompt),
        ("/v1/completions", {"prompt": long_prompt, "max_tokens": 24, "logprobs": 1},
         long_prompt),
        ("/v1/completions", {"prompt": _text(4, 300), "max_tokens": 16,
                             "temperature": 0.8, "top_p": 0.9, "seed": 7}, _text(4, 300)),
    ]
    from ditl_tpu_torch.infer.engine import _next_pow2

    buckets = [_next_pow2(1 + len(tok.encode(p))) for _, _, p in requests]
    require(min(buckets) >= 128 and 512 in buckets, buckets)

    try:
        flash.reset_launches()  # the main path's counts start here
        paged.reset_launches()
        status, health = _http("GET", url + "/health")
        require(status == 200 and health["status"] == "ok", health)
        bodies, walls = [], []
        for (route, payload, _), bucket in zip(requests, buckets):
            t = time.perf_counter()
            status, body = _http("POST", url + route, payload)
            wall = time.perf_counter() - t
            walls.append(wall)
            require(status == 200, (route, status, body))
            usage = body["usage"]
            log(f"[{tag}] {route} bucket {bucket}: {usage['prompt_tokens']} prompt + "
                f"{usage['completion_tokens']} completion tokens in {wall:.3f}s "
                f"(finish {body['choices'][0]['finish_reason']})")
            bodies.append(body)
        launches = {"flash_fwd" + sfx: getattr(flash, "launches" + sfx),  # right after
                    "paged": sum(getattr(paged, n) for n in paged._COUNTERS.values())}
        status, stats = _http("GET", url + "/v1/stats")
        require(status == 200 and stats["requests"] == len(requests), stats)
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")

    # Non-empty completions. The byte tokenizer decodes only ids 3..258 of
    # the 128256-way head to text, so with seed-initialised weights the
    # text is mostly empty: non-empty is the token count, and greedy
    # requests ran to their budget (no EOS is likely among 128256 ids).
    for (_, payload, _), body in zip(requests, bodies):
        n = body["usage"]["completion_tokens"]
        require(n >= 1, body)
        if not payload.get("temperature"):
            require(n == payload["max_tokens"], body)
    want = cfg.num_layers * len(requests)  # one prefill per request
    require(launches["flash_fwd" + sfx] == want, (launches, want))
    log(f"[{tag}] flash_fwd{sfx} launches on the main path: {launches['flash_fwd' + sfx]} "
        f"= {cfg.num_layers} layers x {len(requests)} prefills")

    # One greedy request repeated gives identical tokens (their logprobs and
    # text agree exactly).
    a, b = (body["choices"][0] for body in bodies[2:4])
    require(a["text"] == b["text"], (a["text"], b["text"]))
    require(a["logprobs"]["token_logprobs"] == b["logprobs"]["token_logprobs"])
    require(a["logprobs"]["tokens"] == b["logprobs"]["tokens"])
    log(f"[{tag}] repeated greedy request: identical tokens")

    # The prefill's last-position logits with the flash kernel against the
    # same forward with plain attention, on the card.
    logits_tol = F32_LOGITS_REL_TOL if dtype == "float32" else LOGITS_REL_TOL
    for i in (0, 2):
        ids = [tok.bos_id] + tok.encode(requests[i][2])
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            lf = _prefill_logits(gen, cfg, ids)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            lx = _prefill_logits(gen, dataclasses.replace(cfg, attention_impl="xla"), ids)
        log(f"[{tag}] bucket {buckets[i]}: prefill {prefill_s * 1e3:.1f} ms "
            "(host clock, synchronised)")
        if i == 2:  # its repeat (request 3) ran warm
            steps = requests[3][1]["max_tokens"] - 1  # decode forwards after the prefill
            log(f"[{tag}] bucket 512, warm request: wall minus prefill over its {steps} "
                f"decode steps {(walls[3] - prefill_s) / steps * 1e3:.1f} ms/step ({SMI})")
        require(lf.shape == (cfg.vocab_size,) and bool(torch.isfinite(lf).all()))
        rel = float((lf - lx).norm() / lx.norm())
        max_err = float((lf - lx).abs().max())
        same_top = int(lf.argmax()) == int(lx.argmax())
        log(f"[{tag}] prefill logits flash vs xla (bucket {buckets[i]}): rel L2 "
            f"{rel:.3e}, max abs {max_err:.3e} (|logits| max {float(lx.abs().max()):.3f}), "
            f"same argmax {same_top} (tolerance {logits_tol})")
        require(rel <= logits_tol, rel)
        # The greedy first token the server sampled is this argmax: its
        # logprob is the flash logits' log-softmax maximum.
        if i == 2:
            first_lp = a["logprobs"]["token_logprobs"][0]
            want_lp = float(torch.log_softmax(lf, -1).max())
            require(abs(first_lp - want_lp) < 1e-4, (first_lp, want_lp))
    require(launches["paged"] == 0, launches)  # no paged kernel of any kind
    log(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return gen, {k: v for k, v in launches.items() if k.startswith("flash")}


def _decode_step_logits(engine, slot: int):
    """One paged decode step's f32 logits for ``slot`` from the engine's
    current pools, table and slot state, with a fresh tail (column 0)."""
    import torch

    from ditl_tpu_torch.models import llama

    c = engine.cfg
    shape = (c.num_layers, engine.n_slots, c.num_kv_heads, engine.decode_chunk,
             c.head_dim)
    alive = torch.zeros(engine.n_slots, dtype=torch.bool, device="cuda")
    alive[slot] = True
    dtype = llama.torch_dtype(c.dtype)  # the tails stay in the compute dtype
    cache = {**engine.cache,
             "tk": torch.zeros(shape, dtype=dtype, device="cuda"),
             "tv": torch.zeros(shape, dtype=dtype, device="cuda")}
    paged = {"table": engine._table_device(), "starts": engine.pos, "t": 0,
             "lengths": torch.where(alive, engine.pos + 1, 0).to(torch.int32)}
    return llama.forward(engine.params, engine.cur[:, None], c,
                         positions=engine.pos[:, None], cache=cache, paged=paged)[slot, 0]


def _recording_engine(engine):
    """``engine`` behind a ``ThreadedEngine`` that keeps the token ids each
    completion returned, by (prompt ids, max_new_tokens): the byte tokenizer
    decodes only ids 3..258 of the 128256-way head to text."""
    from ditl_tpu_torch.infer.continuous import ThreadedEngine

    class RecordingEngine(ThreadedEngine):
        def __init__(self, engine):
            super().__init__(engine)
            self.outputs: dict[tuple, list] = {}
            self._lock = threading.Lock()

        def generate_one(self, prompt_tokens, **kw):
            out = super().generate_one(prompt_tokens, **kw)
            with self._lock:
                self.outputs.setdefault((tuple(prompt_tokens), kw["max_new_tokens"]),
                                        []).append(list(out))
            return out

    return RecordingEngine(engine)


def _continuous_requests():
    """The continuous paths' traffic: 12 requests, the first four sharing a
    600-character prefix (two full 256-token pages with BOS, and 89 more),
    two of the others sampled and two the same greedy request. Returns the
    payloads and the repeated prompt."""
    prefix = _text(30, 600)
    shared = [{"prompt": prefix + " " + _text(31 + i, n), "max_tokens": m}
              for i, (n, m) in enumerate([(100, 32), (180, 48), (250, 16), (140, 64)])]
    repeated = _text(40, 150)
    others = [
        {"prompt": _text(41, 1500), "max_tokens": 32},
        {"prompt": _text(42, 1200), "max_tokens": 48},
        {"prompt": _text(43, 1000), "max_tokens": 32, "temperature": 0.8,
         "top_p": 0.9, "seed": 7},
        {"prompt": _text(44, 450), "max_tokens": 40, "temperature": 1.0, "seed": 11},
        {"prompt": repeated, "max_tokens": 24},
        {"prompt": repeated, "max_tokens": 24},
        {"prompt": _text(45, 100), "max_tokens": 16},
        {"prompt": _text(46, 300), "max_tokens": 20},
    ]
    return shared + others, repeated


def _send_continuous(url: str, requests: list, engine):
    """POST ``requests`` to /v1/completions, each from its own thread: the
    four shared-prefix requests first, queued or admitted before the others
    arrive, so pool pressure cannot evict their pages first. Returns
    {index: (status, body, seconds)} and the wall seconds."""
    results: dict[int, tuple] = {}

    def one(i):
        t = time.perf_counter()
        status, body = _http("POST", url + "/v1/completions", requests[i])
        results[i] = (status, body, time.perf_counter() - t)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
    t_start = time.perf_counter()
    for th in threads[:4]:
        th.start()
    for _ in range(600):
        st = engine.stats()
        if st["slots_busy"] + st["queue_depth"] + len(results) >= 4:
            break
        time.sleep(0.01)
    for th in threads[4:]:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return results, time.perf_counter() - t_start


def phase_serve_continuous(gen, flash, paged) -> tuple[dict, dict]:
    """Main path 2: the continuous engine over the paged KV cache, over
    ``gen``'s weights (no second 8B copy), serving 12 concurrent requests
    through the HTTP server. Returns the path's launch counts and a summary
    (ms per decode step, tokens/s, pool bytes and pages, prefix-hit
    tokens) that path 6 is set beside."""
    import torch

    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.continuous import ContinuousEngine

    cfg = gen.cfg
    tok = gen.tokenizer
    # paths 8, 11 and 12's continuous halves: K1-f32 or K1-f16, and K3 over
    # pools of the compute dtype or int8
    sfx, prefix = DTYPE_SFX[cfg.dtype]
    int8 = "_int8" if cfg.kv_cache_dtype == "int8" else ""
    tag = prefix + ("int8-continuous" if int8 else "continuous")
    t0 = time.perf_counter()
    engine = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                              max_cache_len=2048, cache_mode="paged", page_size=256,
                              device="cuda")
    rec = _tick_recorder(engine)  # for path 19's comparison
    threaded = _recording_engine(engine)
    server = server_mod.make_server(gen, threaded_engine=threaded, host="127.0.0.1",
                                    port=0, model_name=cfg.name)
    pool_gib = 2 * engine.cache["kp"].numel() * engine.cache["kp"].element_size() / 2**30
    log(f"[{tag}] engine built in {time.perf_counter() - t0:.1f}s: "
        f"{engine.n_pages} pages of {engine.page_size} tokens, {pool_gib:.2f} GiB "
        f"of pools, 8 slots, decode_chunk 16, context 2048")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    requests, repeated = _continuous_requests()
    try:
        flash.reset_launches()  # this path's counts start here
        paged.reset_launches()
        results, wall = _send_continuous(url, requests, engine)
        k3 = "paged_tail" + int8 + sfx
        launches = {"flash_fwd" + sfx: getattr(flash, "launches" + sfx),
                    k3: getattr(paged, "launches_tail" + int8 + sfx),
                    # every other paged kernel (K4, the verify, the other dtypes')
                    "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                    - getattr(paged, "launches_tail" + int8 + sfx)}  # read right after
        st = engine.stats()
        status, http_stats = _http("GET", url + "/v1/stats")
        require(status == 200 and http_stats["engine"] == "continuous", http_stats)
        # Time to first token of one cold request on the idle engine: a fresh
        # 1000-character prompt, one token, over HTTP.
        t = time.perf_counter()
        status, body = _http("POST", url + "/v1/completions",
                             {"prompt": _text(47, 1000), "max_tokens": 1})
        ttft_s = time.perf_counter() - t
        require(status == 200 and body["usage"]["completion_tokens"] == 1, body)
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    require(not threaded._thread.is_alive(), "engine driver thread did not stop")

    n_tokens = 0
    for i, payload in enumerate(requests):
        require(i in results, f"request {i} did not answer")
        status, body, w = results[i]
        require(status == 200, (i, status, body))
        n = body["usage"]["completion_tokens"]
        n_tokens += n
        require(n >= 1, body)
        if not payload.get("temperature"):
            require(n == payload["max_tokens"], (i, body))  # greedy: to budget
        log(f"[{tag}] request {i}: {body['usage']['prompt_tokens']} prompt + {n} "
            f"completion tokens in {w:.3f}s wall "
            f"({'sampled' if payload.get('temperature') else 'greedy'})")
    rep = threaded.outputs[(tuple([tok.bos_id] + tok.encode(repeated)), 24)]
    require(len(rep) == 2 and rep[0] == rep[1], rep)
    log(f"[{tag}] repeated greedy request: identical tokens")
    hit = st["prefix_cache"]["hit_tokens"]
    require(hit >= 512 * 3, st["prefix_cache"])
    require(st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"], st)
    require(st["slots_busy"] == 0 and st["queue_depth"] == 0, st)
    want_k3 = cfg.num_layers * st["decode_steps"]
    want_k1 = cfg.num_layers * st["prefills_cold"]
    require(launches[k3] == want_k3, (launches, st["decode_steps"]))
    require(launches["flash_fwd" + sfx] == want_k1, (launches, st["prefills_cold"]))
    require(launches.pop("other") == 0, launches)
    log(f"[{tag}] {k3} launches {launches[k3]} = {cfg.num_layers} layers "
        f"x {st['decode_steps']} decode steps ({st['decode_ticks']} ticks); K1{sfx} launches "
        f"{launches['flash_fwd' + sfx]} = {cfg.num_layers} x {st['prefills_cold']} cold "
        f"prefills ({st['prefills_prefix_hit']} prefix-hit prefills, masked plain "
        f"path); prefix cache {st['prefix_cache']}; pages total {st['pages_total']}, "
        f"free {st['pages_free']}, cached {st['pages_cached_evictable']}")
    tick_ms = st["decode_seconds"] / st["decode_ticks"] * 1e3
    pool_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    log(f"[{tag}] {len(requests)} concurrent requests in {wall:.3f}s wall: "
        f"{n_tokens} generated tokens, {n_tokens / wall:.1f} tokens/s aggregate; "
        f"decode {tick_ms:.1f} ms per tick, {tick_ms / engine.decode_chunk:.2f} ms "
        f"per step (host clock, each tick ends in a device-to-host copy); time to first "
        f"token of a cold 1001-token request on the idle engine {ttft_s * 1e3:.1f} ms "
        f"(HTTP included); pools {pool_bytes / 1e9:.3f} GB ({SMI})")

    _check_decode_step(engine, paged, tag, k3)
    interference = None
    if tag == "continuous":  # path 2 itself: path 19's yardstick
        interference = _interference_trace(engine, rec)
        log(f"[{tag}] four requests decoding while three long prompts arrive: "
            f"{_interference_line(interference)} (host clock; {SMI})")
    log(f"[{tag}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, {"ms_step": tick_ms / engine.decode_chunk,
                      "tokens_s": n_tokens / wall, "pool_bytes": pool_bytes,
                      "n_pages": engine.n_pages, "hit_tokens": hit, "ttft_s": ttft_s,
                      "outputs": threaded.outputs, "interference": interference}


def _check_decode_step(engine, paged, tag: str, kernel: str) -> None:
    """One paged decode step through the kernel against the same step
    through the plain version, from a fresh cold prefill of a 701-token
    prompt (the server has stopped, so this thread owns the engine)."""
    import torch

    tok, cfg = engine.tokenizer, engine.cfg
    prompt = [tok.bos_id] + tok.encode(_text(50, 700))
    rid = engine.submit(prompt, max_new_tokens=4)
    engine._admit()
    slot = next(i for i, r in enumerate(engine._slots) if r is not None and r.req_id == rid)
    wrapper = paged.paged_attention
    with torch.no_grad():
        lk = _decode_step_logits(engine, slot)
        # The forward looks the wrapper up at call time: rebinding it to the
        # plain version swaps it for this one forward only.
        paged.paged_attention = paged.paged_attention_plain
        try:
            lx = _decode_step_logits(engine, slot)
        finally:
            paged.paged_attention = wrapper
    engine.cancel(rid)
    require(lk.shape == (cfg.vocab_size,) and bool(torch.isfinite(lk).all()))
    rel = float((lk - lx).norm() / lx.norm())
    same_top = int(lk.argmax()) == int(lx.argmax())
    tol = F32_LOGITS_REL_TOL if cfg.dtype == "float32" else LOGITS_REL_TOL
    log(f"[{tag}] decode-step logits {kernel} vs plain paged attention (701-token "
        f"context): rel L2 {rel:.3e}, max abs {float((lk - lx).abs().max()):.3e}, "
        f"same argmax {same_top} (tolerance {tol})")
    require(rel <= tol and same_top, (rel, same_top))


def _span_requests():
    """Four prompts that repeat a span (what prompt lookup is for), greedy."""
    return [{"prompt": " ".join([_text(70 + i, n)] * reps), "max_tokens": m}
            for i, (n, reps, m) in enumerate([(120, 4, 48), (60, 8, 40), (200, 3, 64),
                                              (90, 5, 32)])]


def _tie_check(gen, cfg, prompt_ids: list[int], spec: list[int], plain: list[int]):
    """The speculative tokens against the plain ones up to their first
    divergence: None when identical, else the gap between the two candidate
    tokens' logits in one plain forward over the common prefix (a causal
    prefill of prompt + the shared tokens), which must be under
    ``SPEC_TIE_TOL``."""
    n = min(len(spec), len(plain))
    i = next((j for j in range(n) if spec[j] != plain[j]), None)
    if i is None and len(spec) == len(plain):
        return None
    i = n if i is None else i
    eos = gen.tokenizer.eos_id
    a = plain[i] if i < len(plain) else eos
    b = spec[i] if i < len(spec) else eos
    import torch

    with torch.no_grad():
        logits = _prefill_logits(gen, cfg, prompt_ids + plain[:i])
    gap = abs(float(logits[a] - logits[b]))
    require(gap < SPEC_TIE_TOL, (i, a, b, gap))
    return gap


def _check_against(gen, cfg, pairs, tag: str) -> None:
    """``pairs``: (prompt ids, speculative tokens, plain tokens) of greedy
    requests; each identical, or diverging at a near-tie."""
    same, gaps = 0, []
    for prompt_ids, spec, plain in pairs:
        gap = _tie_check(gen, cfg, prompt_ids, spec, plain)
        if gap is None:
            same += 1
        else:
            gaps.append(gap)
    log(f"[{tag}] greedy tokens against the plain path: {same} of {len(pairs)} requests "
        f"identical; {len(gaps)} diverge at a near-tie, logit gaps "
        f"{[round(g, 4) for g in gaps]} (SPEC_TIE_TOL {SPEC_TIE_TOL})")


def phase_serve_spec(gen, flash, paged, bf16: dict) -> tuple[dict, dict]:
    """Main path 7, speculative continuous serving: the continuous engine
    as ``infer/server.py --engine continuous --cache-mode paged
    --speculative on`` builds it (``speculative=True``, threshold 0: every
    tick speculates), over path 1's weights object, serving path 2's 12
    requests plus four prompts that repeat a span over HTTP. K3-verify on
    every round of every layer, never the single-query K3; greedy tokens
    against path 2's (the span prompts against the plain engine's) by the
    divergence rule; then ``--speculative auto`` over the same weights.
    Returns the path's launch counts and its ms per verify round and
    tokens/s."""
    import torch

    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.continuous import ContinuousEngine

    cfg, tok = gen.cfg, gen.tokenizer
    engine = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                              max_cache_len=2048, cache_mode="paged", page_size=256,
                              speculative=True, spec_threshold=0.0, device="cuda")
    threaded = _recording_engine(engine)
    server = server_mod.make_server(gen, threaded_engine=threaded, host="127.0.0.1",
                                    port=0, model_name=cfg.name)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    requests = _continuous_requests()[0] + _span_requests()
    try:
        flash.reset_launches()  # this path's counts start here
        paged.reset_launches()
        results, wall = _send_continuous(url, requests, engine)
        launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                    "paged_verify": paged.launches_verify,
                    "paged": paged.launches}  # read right after the run
        status, http_stats = _http("GET", url + "/v1/stats")
        require(status == 200, http_stats)
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    st = http_stats["speculative"]
    n_tokens = 0
    for i, payload in enumerate(requests):
        require(i in results, f"request {i} did not answer")
        status, body, w = results[i]
        require(status == 200, (i, status, body))
        n_tokens += body["usage"]["completion_tokens"]
        if not payload.get("temperature"):
            require(body["usage"]["completion_tokens"] == payload["max_tokens"], (i, body))
    require(st["spec_ticks"] == st["ticks"] == http_stats["decode_ticks"] > 0, st)
    require(launches["paged_verify"] == cfg.num_layers * st["verify_rounds"], (launches, st))
    require(launches["paged_tail"] == 0 and launches["paged"] == 0, launches)
    require(launches["flash_fwd"] == cfg.num_layers * http_stats["prefills_cold"],
            (launches, http_stats["prefills_cold"]))
    ms_round = st["spec_seconds"] / st["verify_rounds"] * 1e3
    log(f"[spec] continuous --speculative on: K3-verify launches {launches['paged_verify']} "
        f"= {cfg.num_layers} layers x {st['verify_rounds']} verify rounds ({st['spec_ticks']} "
        f"ticks of {st['rounds_per_tick']} rounds, k = {st['k']}), single-query K3 launches "
        f"{launches['paged_tail']}; K1 launches {launches['flash_fwd']} = {cfg.num_layers} x "
        f"{http_stats['prefills_cold']} cold prefills")
    log(f"[spec] {len(requests)} concurrent requests in {wall:.3f}s wall: {n_tokens} "
        f"generated tokens, {n_tokens / wall:.1f} tokens/s aggregate (path 2: "
        f"{bf16['tokens_s']:.1f}); {st['tokens_per_row_forward']:.3f} tokens per verify "
        f"forward per row (acceptance EMA {st['acceptance_ema']:.3f}); {ms_round:.2f} ms "
        f"per verify round against path 2's {bf16['ms_step']:.2f} ms per step, "
        f"{ms_round / bf16['ms_step']:.2f}x (host clock, each tick ends in a device-to-host "
        f"copy; {SMI})")

    # Greedy tokens against the plain path: path 2's for its requests, the
    # plain engine's for the span prompts (run here over the same weights).
    plain_engine = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                                    max_cache_len=2048, cache_mode="paged", page_size=256,
                                    device="cuda")
    span_ids = {}
    for payload in _span_requests():
        ids = [tok.bos_id] + tok.encode(payload["prompt"])
        span_ids[plain_engine.submit(ids, max_new_tokens=payload["max_tokens"])] = (
            ids, payload["max_tokens"])
    plain_out = plain_engine.run()
    want = {key: outs[0] for key, outs in bf16["outputs"].items()}
    want.update({(tuple(ids), m): plain_out[rid] for rid, (ids, m) in span_ids.items()})
    del plain_engine
    keys = {(tuple([tok.bos_id] + tok.encode(p["prompt"])), p["max_tokens"])
            for p in requests if not p.get("temperature")}
    pairs = [(list(key[0]), spec_out, want[key]) for key in sorted(keys)
             for spec_out in threaded.outputs[key]]  # one pair a greedy request
    _check_against(gen, cfg, pairs, "spec")

    # --speculative auto over the same weights: the measured threshold and
    # both kinds of tick (probing every 2 ticks, so the smoke's traffic times
    # both kinds twice; the server's default is every 32).
    auto = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                            max_cache_len=2048, cache_mode="paged", page_size=256,
                            speculative=True, spec_threshold=None, spec_probe_every=2,
                            device="cuda")
    server = server_mod.make_server(gen, threaded_engine=_recording_engine(auto),
                                    host="127.0.0.1", port=0, model_name=cfg.name)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    greedy = [p for p in requests if not p.get("temperature")]
    try:
        for _ in range(3):
            results, _ = _send_continuous(url, greedy, auto)
            require(all(results[i][0] == 200 for i in range(len(greedy))), results)
            status, auto_stats = _http("GET", url + "/v1/stats")
            if auto_stats["speculative"]["threshold_source"] == "measured":
                break
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    ast = auto_stats["speculative"]
    require(ast["threshold_source"] == "measured"
            and abs(ast["threshold"] - ast["spec_round_ms"] / ast["plain_step_ms"]) < 1e-9
            and 0 < ast["spec_ticks"] < ast["ticks"], ast)
    log(f"[spec] --speculative auto: threshold {ast['threshold']:.3f} (measured: "
        f"{ast['spec_round_ms']:.2f} ms per verify round / {ast['plain_step_ms']:.2f} ms per "
        f"plain step), {ast['spec_ticks']} speculative of {ast['ticks']} ticks, acceptance "
        f"EMA {ast['acceptance_ema']:.3f} ({SMI})")
    log(f"[spec] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, {"ms_round": ms_round, "tokens_s": n_tokens / wall}


# Path 18's drafter: the reference bench's draft model over the target's
# config (``bench.py``'s ``--spec-draft``: hidden 512, 6 layers, 8 heads on 4,
# the target's vocab and head_dim), seed-initialised.
DRAFT_WIDTHS = dict(name="bench-draft", hidden_size=512, intermediate_size=1408,
                    num_layers=6, num_heads=8, num_kv_heads=4)
# The drafter of the depth-2 legs of paths 20-22: path 18's widths at depth
# 2, a depth cut that keeps the whole script within its time limit (each
# drafted round runs k + 1 host-bound drafter forwards).
DEPTH2_DRAFT = dict(DRAFT_WIDTHS, num_layers=2)
# Path 19: path 2's engine with chunks of 512 and a budget of one decode tick
# (8 slots x 16 steps) plus one chunk.
CHUNK_PREFILL, CHUNK_BUDGET = 512, 8 * 16 + 512


def _tick_recorder(engine):
    """Wrap ``engine``'s ``submit``, ``step`` and ``_paged_prefill_chunk`` on
    the instance (the server's engine thread calls them) to record, host
    clock: each request's submit, first-token and finish times and token
    count, and for each tick the requests decode-ready at its start, its
    prefill tokens, the largest chunk, its slots still prefilling after it
    its spend against the budget and its wall time. Returns the record."""
    rec = {"submit": {}, "first": {}, "done": {}, "n": {}, "ticks": [], "chunks": []}
    submit, step, chunk = engine.submit, engine.step, engine._paged_prefill_chunk
    tick = {}

    def rec_submit(prompt, **kw):
        rid = submit(prompt, **kw)
        rec["submit"][rid] = time.perf_counter()
        return rid

    def rec_chunk(req, slot, d, s, generator, **kw):
        tick["prefill"] = tick.get("prefill", 0) + s
        tick["largest"] = max(tick.get("largest", 0), s)
        rec["chunks"].append((req.req_id, d, s))
        return chunk(req, slot, d, s, generator, **kw)

    def rec_step():
        seen = {id(r): r for r in list(engine._queue) + engine._slots if r is not None}
        ready = [r.req_id for r in engine._slots if r is not None and not r.prefilling]
        tick.clear()
        t0 = time.perf_counter()
        step()
        now = time.perf_counter()
        seen.update((id(r), r) for r in engine._slots if r is not None)
        for r in seen.values():
            if r.tokens and r.req_id not in rec["first"]:
                rec["first"][r.req_id] = now
            if r.finished and r.req_id not in rec["done"]:
                rec["done"][r.req_id], rec["n"][r.req_id] = now, len(r.tokens)
        rec["ticks"].append({"ready": ready, "ms": (now - t0) * 1e3,
                             "prefill": tick.get("prefill", 0),
                             "largest": tick.get("largest", 0),
                             "spent": engine._tick_prefill_spent,
                             "prefilling": engine.stats()["slots_prefilling"]})

    engine.submit, engine.step, engine._paged_prefill_chunk = rec_submit, rec_step, rec_chunk
    return rec


def _interference_trace(engine, rec) -> dict:
    """Four greedy requests of 201 tokens decode, then three long prompts
    (1501, 1201 and 1001 tokens, texts no earlier request used) arrive: the
    four's time per output token and their worst tick while a long prompt
    prefilled (host clock, harvest to harvest), and the long prompts' time
    to first token, in ms. ``rec`` is ``engine``'s ``_tick_recorder``."""
    tok = engine.tokenizer
    n0 = len(rec["ticks"])
    shorts = [engine.submit([tok.bos_id] + tok.encode(_text(80 + i, 200)), max_new_tokens=64,
                            temperature=0.0) for i in range(4)]
    engine.step()
    engine.step()
    longs = [engine.submit([tok.bos_id] + tok.encode(_text(90 + i, n)), max_new_tokens=8,
                           temperature=0.0) for i, n in enumerate((1500, 1200, 1000))]
    engine.run()
    stalls = [t["ms"] for t in rec["ticks"][n0:] if t["prefill"] and set(t["ready"]) & set(shorts)]
    tpot = [(rec["done"][r] - rec["first"][r]) * 1e3 / (rec["n"][r] - 1) for r in shorts]
    ttft = [(rec["first"][r] - rec["submit"][r]) * 1e3 for r in longs]
    return {"tpot_ms": sum(tpot) / len(tpot), "stall_ticks": len(stalls),
            "worst_tick_ms": max(stalls, default=0.0), "ttft_ms": sum(ttft) / len(ttft)}


def _interference_line(lat: dict) -> str:
    return (f"time per output token {lat['tpot_ms']:.2f} ms, worst tick beside a prefill "
            f"{lat['worst_tick_ms']:.1f} ms over {lat['stall_ticks']} such ticks; the long "
            f"prompts' TTFT {lat['ttft_ms']:.1f} ms")


def _serve_engine(gen, engine, requests):
    """Serve ``requests`` through the HTTP server over ``engine`` (path 2's
    traffic pattern, ``_send_continuous``); returns the results, the wall
    seconds, /v1/stats and the recording engine's outputs."""
    from ditl_tpu_torch.infer import server as server_mod

    threaded = _recording_engine(engine)
    server = server_mod.make_server(gen, threaded_engine=threaded, host="127.0.0.1", port=0,
                                    model_name=gen.cfg.name)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        results, wall = _send_continuous(url, requests, engine)
        status, stats = _http("GET", url + "/v1/stats")
        require(status == 200, stats)
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive() and not threaded._thread.is_alive(), "server did not stop")
    n_tokens = 0
    for i, payload in enumerate(requests):
        require(i in results, f"request {i} did not answer")
        status, body, _ = results[i]
        require(status == 200, (i, status, body))
        n_tokens += body["usage"]["completion_tokens"]
        if not payload.get("temperature"):
            require(body["usage"]["completion_tokens"] == payload["max_tokens"], (i, body))
    return n_tokens, wall, stats, threaded.outputs


def _greedy_pairs(tok, requests, outputs, want: dict):
    """(prompt ids, tokens, path 2's tokens) of each greedy request."""
    keys = {(tuple([tok.bos_id] + tok.encode(p["prompt"])), p["max_tokens"])
            for p in requests if not p.get("temperature")}
    return [(list(key[0]), out, want[key][0]) for key in sorted(keys) for out in outputs[key]]


def phase_serve_draft(gen, flash, paged, bf16: dict, spec: dict) -> dict:
    """Main path 18, draft-model speculation: the continuous engine as
    ``infer/server.py --engine continuous --cache-mode paged --speculative
    on --draft-preset`` builds it, over path 1's weights object, drafting
    with ``DRAFT_WIDTHS`` over the target's config (seed 11), serving path
    2's 12 requests over HTTP. K3-verify on every round of every layer, the
    single-query K3 never, K1 on every cold prefill and on each draft
    prefill that tiles; the drafter's k + 1 steps a round; greedy tokens
    against path 2's by the divergence rule. Then the target at depth 2 as
    its own drafter (views of path 1's first two layers): every live row
    of every round accepts all k drafts but at a near-tie of the verify's
    logits. Returns the path's launch counts."""
    import dataclasses

    import torch

    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.models import llama

    cfg, tok = gen.cfg, gen.tokenizer
    dcfg = dataclasses.replace(cfg, **DRAFT_WIDTHS)
    dparams = llama.init_params(dcfg, seed=11, device="cuda")
    engine = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                              max_cache_len=2048, cache_mode="paged", page_size=256,
                              speculative=True, spec_threshold=0.0, draft_params=dparams,
                              draft_cfg=dcfg, device="cuda")
    requests = _continuous_requests()[0]
    flash.reset_launches()  # this path's counts start here
    paged.reset_launches()
    n_tokens, wall, stats, outputs = _serve_engine(gen, engine, requests)
    launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                "paged_verify": paged.launches_verify,
                "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                - paged.launches_tail - paged.launches_verify}  # read right after
    st = stats["speculative"]
    prompts = [[tok.bos_id] + tok.encode(p["prompt"]) for p in requests]
    buckets = [min(1 << (len(p) - 1).bit_length(), engine.smax) for p in prompts]
    draft_k1 = dcfg.num_layers * sum(flash.supports(b, b, dcfg.head_dim) for b in buckets)
    require(st["drafter"] == "model" and st["spec_ticks"] == st["ticks"]
            == stats["decode_ticks"] > 0, st)
    require(launches["paged_verify"] == cfg.num_layers * st["verify_rounds"], (launches, st))
    require(launches["paged_tail"] == 0 and launches.pop("other") == 0, launches)
    require(st["draft_steps"] == (st["k"] + 1) * st["verify_rounds"], st)
    require(launches["flash_fwd"] == cfg.num_layers * stats["prefills_cold"] + draft_k1,
            (launches, stats["prefills_cold"], draft_k1))
    ms_round = st["spec_seconds"] / st["verify_rounds"] * 1e3
    log(f"[draft] --draft-preset ({dcfg.num_layers} layers, hidden {dcfg.hidden_size}, "
        f"{dcfg.num_heads} heads on {dcfg.num_kv_heads}, head_dim {dcfg.head_dim}): "
        f"K3-verify launches {launches['paged_verify']} = {cfg.num_layers} layers x "
        f"{st['verify_rounds']} verify rounds ({st['spec_ticks']} ticks of "
        f"{st['rounds_per_tick']} rounds, k = {st['k']}), single-query K3 launches "
        f"{launches['paged_tail']}; draft steps {st['draft_steps']} = (k + 1) x rounds; K1 "
        f"launches {launches['flash_fwd']} = {cfg.num_layers} x {stats['prefills_cold']} "
        f"cold prefills + {draft_k1} in the drafter's prefills")
    log(f"[draft] {len(requests)} concurrent requests in {wall:.3f}s wall: {n_tokens} "
        f"generated tokens, {n_tokens / wall:.1f} tokens/s aggregate (path 2: "
        f"{bf16['tokens_s']:.1f}, path 7: {spec['tokens_s']:.1f}); "
        f"{st['tokens_per_row_forward']:.3f} tokens per verify forward per row "
        f"(acceptance EMA {st['acceptance_ema']:.3f}); {ms_round:.2f} ms per verify round "
        f"with its {st['k'] + 1} draft steps against path 7's {spec['ms_round']:.2f} ms "
        f"(host clock, each tick ends in a device-to-host copy; {SMI})")
    _check_against(gen, cfg, _greedy_pairs(tok, requests, outputs, bf16["outputs"]), "draft")
    del engine, dparams

    # The target at depth 2 as its own drafter: views of path 1's weights.
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = {**gen.params, "layers": {g: {k: w[:2] for k, w in grp.items()}
                                        for g, grp in gen.params["layers"].items()}}
    perfect = ContinuousEngine(params2, cfg2, tok, n_slots=8, decode_chunk=16,
                               max_cache_len=2048, cache_mode="paged", page_size=256,
                               speculative=True, spec_threshold=0.0, draft_params=params2,
                               draft_cfg=cfg2, device="cuda")
    k = perfect.spec_k
    accept, scan = perfect._spec_accept, perfect._draft_scan
    rounds = {"live": 0, "full": 0, "gaps": []}
    live_rows = []

    def scan_live(cur, pos):
        # a round's live rows: a pending token and budget left
        live_rows[:] = torch.nonzero((cur != tok.pad_id) & (pos < perfect.limits)
                                     ).flatten().tolist()
        return scan(cur, pos)

    def record(logits, tokens_in, gens, sampled):
        n_acc, nxt = accept(logits, tokens_in, gens, sampled)
        for b in live_rows:
            rounds["live"] += 1
            j = int(n_acc[b])
            if j == k:
                rounds["full"] += 1
            else:  # the verify's argmax against the draft at the first miss
                row = logits[b, j]
                rounds["gaps"].append(float(row.max() - row[tokens_in[b, j + 1]]))
        return n_acc, nxt

    perfect._draft_scan = scan_live
    perfect._spec_accept = record
    greedy = [p for p in requests if not p.get("temperature")][:6]
    rids = [perfect.submit([tok.bos_id] + tok.encode(p["prompt"]),
                           max_new_tokens=p["max_tokens"], temperature=0.0) for p in greedy]
    out = perfect.run()
    pst = perfect.stats()["speculative"]
    require(all(len(out[r]) == p["max_tokens"] for r, p in zip(rids, greedy)), out)
    require(rounds["live"] > 0 and all(g < SPEC_TIE_TOL for g in rounds["gaps"]), rounds)
    log(f"[draft] the target at depth 2 as its own drafter: {rounds['full']} of "
        f"{rounds['live']} live rounds accept all k = {k} drafts; the rest miss at a "
        f"near-tie of the verify's logits, gaps {[round(g, 4) for g in rounds['gaps']]} "
        f"(SPEC_TIE_TOL {SPEC_TIE_TOL}); {pst['tokens_per_row_forward']:.3f} tokens per "
        f"verify forward per row over {len(greedy)} greedy requests")
    del perfect, params2
    log(f"[draft] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def phase_serve_chunked(gen, flash, paged, bf16: dict) -> dict:
    """Main path 19, chunked prefill under a token budget: path 2's engine
    with ``prefill_chunk=CHUNK_PREFILL`` and ``token_budget=CHUNK_BUDGET``
    over path 1's weights object, path 2's 12 requests over HTTP. K1 on
    every first chunk and cold prefill, K3 on every decode step; the long
    prompts' chunk counts; a slot seen prefilling while others decode; each
    tick's prefill within max(one chunk, budget - decode_ready x 16); greedy
    tokens against path 2's by the divergence rule; the sampled requests
    again on the engine, the same tokens. Prints the time per output token
    of requests that decode while long prompts prefill, and those prompts'
    TTFT, beside path 2's (``_interference_trace``). Returns the path's launch
    counts."""
    import torch

    from ditl_tpu_torch.infer.continuous import ContinuousEngine

    cfg, tok = gen.cfg, gen.tokenizer
    engine = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                              max_cache_len=2048, cache_mode="paged", page_size=256,
                              prefill_chunk=CHUNK_PREFILL, token_budget=CHUNK_BUDGET,
                              device="cuda")
    rec = _tick_recorder(engine)
    requests = _continuous_requests()[0]
    flash.reset_launches()  # this path's counts start here
    paged.reset_launches()
    n_tokens, wall, stats, outputs = _serve_engine(gen, engine, requests)
    launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                - paged.launches_tail}  # read right after the run
    require(launches["paged_tail"] == cfg.num_layers * stats["decode_steps"] > 0,
            (launches, stats["decode_steps"]))
    require(launches["flash_fwd"] == cfg.num_layers * stats["prefills_cold"] > 0,
            (launches, stats["prefills_cold"]))
    require(launches.pop("other") == 0, launches)
    by_req: dict[int, list] = {}
    for rid, d, s in rec["chunks"]:
        by_req.setdefault(rid, []).append((d, s))
    # the three long prompts (1500, 1200, 1000 characters and BOS; no shared
    # prefix) by their prompt length: the offset of their first chunk plus
    # the tokens prefilled
    want_chunks = {1501: 3, 1201: 3, 1001: 2}
    got_chunks = {}
    for parts in by_req.values():
        require(all(d % engine.page_size == 0 and s <= CHUNK_PREFILL for d, s in parts), parts)
        total = parts[0][0] + sum(s for _, s in parts)
        if total in want_chunks:
            got_chunks[total] = len(parts)
    require(got_chunks == want_chunks, (got_chunks, by_req))
    both = [t for t in rec["ticks"] if t["prefilling"] > 0 and t["ready"]]
    require(both, "no tick had a slot prefilling beside decoding ones")
    for t in rec["ticks"]:
        cap = max(CHUNK_PREFILL, CHUNK_BUDGET - len(t["ready"]) * engine.decode_chunk)
        require(t["spent"] == t["prefill"] <= cap, (t, cap))
    require(stats["max_tick_prefill_tokens"] == max(t["spent"] for t in rec["ticks"]), stats)
    log(f"[chunked] prefill_chunk {CHUNK_PREFILL}, token_budget {CHUNK_BUDGET}: K1 launches "
        f"{launches['flash_fwd']} = {cfg.num_layers} x {stats['prefills_cold']} first chunks "
        f"and cold prefills ({stats['prefills_prefix_hit']} later chunks and prefix-hit "
        f"prefills on the masked plain path); K3 launches {launches['paged_tail']} = "
        f"{cfg.num_layers} x {stats['decode_steps']} decode steps; chunks by prompt length "
        f"{got_chunks}; {len(both)} ticks decoded beside a prefilling slot; "
        f"max_tick_prefill_tokens {stats['max_tick_prefill_tokens']}; prefix cache "
        f"{stats['prefix_cache']}")
    _check_against(gen, cfg, _greedy_pairs(tok, requests, outputs, bf16["outputs"]), "chunked")
    # The sampled requests again, straight to the engine: the same tokens.
    sampled = [p for p in requests if p.get("temperature")]
    again = {}
    for p in sampled:
        ids = [tok.bos_id] + tok.encode(p["prompt"])
        rid = engine.submit(ids, max_new_tokens=p["max_tokens"], temperature=p["temperature"],
                            top_p=p.get("top_p", 1.0), seed=p["seed"])
        again[rid] = (tuple(ids), p["max_tokens"])
    rerun = engine.run()
    for rid, key in again.items():
        require(outputs[key] == [rerun[rid]], (key[1], outputs[key], rerun[rid]))
    log(f"[chunked] {len(sampled)} sampled requests served again: the same tokens")
    log(f"[chunked] {len(requests)} concurrent requests in {wall:.3f}s wall: {n_tokens} "
        f"generated tokens, {n_tokens / wall:.1f} tokens/s aggregate (path 2: "
        f"{bf16['tokens_s']:.1f}; {SMI})")
    lat = _interference_trace(engine, rec)
    log(f"[chunked] four requests decoding while three long prompts arrive: "
        f"{_interference_line(lat)}; path 2: {_interference_line(bf16['interference'])} "
        f"(host clock; {SMI})")
    log(f"[chunked] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def phase_lockstep_spec(gen, flash, paged) -> dict:
    """Lock-step speculation: ``infer/server.py --engine lockstep
    --speculative on`` over path 1's Generator and weights, five greedy
    requests (K1 on each prefill; the verify reads the contiguous cache
    with the reference's mask, no kernel); tokens against path 1's
    Generator by the divergence rule; the acceptance."""
    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.engine import GenerateConfig
    from ditl_tpu_torch.infer.speculative import SpeculativeGenerator

    class RecordingSpec(SpeculativeGenerator):
        def generate_tokens(self, token_lists, max_new_tokens=64):
            out = super().generate_tokens(token_lists, max_new_tokens)
            self.record.append((token_lists[0], out[0], self.last_acceptance))
            return out

    cfg, tok = gen.cfg, gen.tokenizer
    spec = RecordingSpec(gen.params, cfg, tok, device="cuda")
    spec.record = []
    server = server_mod.make_server(gen, spec_generator=spec, host="127.0.0.1", port=0,
                                    model_name=cfg.name)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    requests = [{"prompt": _text(0, 100), "max_tokens": 16},
                {"prompt": _text(3, 400), "max_tokens": 24},
                {"prompt": _text(4, 300), "max_tokens": 16}] + _span_requests()[:2]
    try:
        flash.reset_launches()
        paged.reset_launches()
        t0 = time.perf_counter()
        for payload in requests:
            status, body = _http("POST", url + "/v1/completions", payload)
            require(status == 200 and body["usage"]["completion_tokens"]
                    == payload["max_tokens"], (status, body))
        wall = time.perf_counter() - t0
        k1 = flash.launches
        status, stats = _http("GET", url + "/v1/stats")
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(len(spec.record) == len(requests) and k1 == cfg.num_layers * len(requests),
            (len(spec.record), k1))
    require(paged.launches_verify == paged.launches_tail == 0)
    accs = [a for _, _, a in spec.record]
    log(f"[lockstep-spec] {len(requests)} greedy requests through SpeculativeGenerator "
        f"(k = {spec.k}) in {wall:.3f}s: K1 launches {k1} = {cfg.num_layers} x "
        f"{len(requests)} prefills; tokens per verify forward per row {accs}; /stats "
        f"speculative_acceptance {stats.get('speculative_acceptance')} ({SMI})")
    pairs = [(ids, out, gen.generate_tokens([ids], GenerateConfig(
        max_new_tokens=payload["max_tokens"]))[0])
        for (ids, out, _), payload in zip(spec.record, requests)]
    _check_against(gen, cfg, pairs, "lockstep-spec")
    return {"flash_fwd": k1}


# Path 20: streaming, embeddings and API eval over path 1's weights. The
# byte tokenizer decodes only ids 3..258 of the 128256-way head, so the
# seed-initialised head generates ids that decode to nothing and a stream's
# text would be empty. Path 20's head keeps the columns of the printable
# ASCII bytes (0x20-0x7e), scaled by ASCII_HEAD_SCALE so that they also win
# under sampling, and zeroes every other column: each generated token is one
# character, and a text is its token ids.
ASCII_HEAD_SCALE = 8.0
# Candidates for the request sent with a stop sequence across a chunk
# boundary (a plain tick's 16 tokens): sampled at temperature 1.5, where the
# ASCII columns still win most draws but the text varies (greedy text of a
# seed-initialised model repeats one character, where no stop can first
# occur across a boundary). The first candidate whose 48 tokens are all
# printable or past the byte table (which decode to nothing) and whose text
# holds such a stop is the probe.
STOP_PROBES = [{"prompt": _text(48 + i, 120), "max_tokens": 48, "temperature": 1.5,
                "seed": 5 + i} for i in range(6)]
# Path 20's API eval: train() on qwen2-0.5b at its published size in bf16
# (f32 masters), flash attention, full remat, adafactor, the fused loss, B=4,
# S=2048, EVAL_STEPS steps, the API eval every 2 steps over 8 examples,
# against the path's continuous llama3-8b server (api.api_base is added).
EVAL_STEPS = 4
EVAL_TRAIN_ARGS = [
    "--preset", "qwen2-0.5b", "model.dtype=bfloat16", "model.param_dtype=float32",
    "model.attention_impl=flash", "model.loss_impl=fused", "model.loss_block_tokens=4096",
    "model.remat=full", "train.optimizer=adafactor", "train.warmup_steps=1",
    f"train.total_steps={EVAL_STEPS}", "train.log_every=1", "data.synthetic=true",
    "data.batch_size=4", "data.seq_len=2048", "train.eval_every=2", "train.eval_samples=8",
    "api.timeout_s=300", "api.total_timeout_s=600",
]
# /v1/embeddings: four inputs of about 300-900 tokens, so the padded length
# is 1024 (K1's prefill path: one launch a layer for the batch).
EMBED_INPUTS = [_text(60 + i, n) for i, n in enumerate((300, 520, 710, 900))]
# The cosine of each embedding against the same forward with flash rebound
# to its plain version (bf16 attention outputs a few ulps apart, pooled over
# up to 901 positions and 32 layers).
EMBED_COS_MIN = 0.999


def _ascii_params(gen) -> dict:
    """Path 1's weights with the lm head described at ``ASCII_HEAD_SCALE``
    (a new head tensor; the other weights are shared)."""
    import torch

    head = gen.params["lm_head"]["kernel"]
    off = gen.tokenizer.byte_offset
    keep = torch.zeros(head.shape[1], dtype=torch.bool, device=head.device)
    keep[off + 0x20: off + 0x7f] = True
    ascii_head = torch.where(keep, head * ASCII_HEAD_SCALE, torch.zeros_like(head[:1, :1]))
    return {**gen.params, "lm_head": {"kernel": ascii_head}}


def _req_key(prompt_tokens, kw) -> tuple:
    """A request's identity across legs: prompt, budget and, when sampled,
    temperature and seed (a greedy request's seed is the server's draw)."""
    temp = kw.get("temperature") or 0.0
    return (tuple(prompt_tokens), kw.get("max_new_tokens"), temp,
            kw.get("seed") if temp > 0 else None)


def _stream_recorder(engine):
    """``engine`` behind a ``ThreadedEngine`` that keeps, by ``_req_key``,
    the token ids each completion returned and each stream's token chunks."""
    from ditl_tpu_torch.infer.continuous import ThreadedEngine, TokenStream

    class StreamRecorder(ThreadedEngine):
        def __init__(self, engine):
            super().__init__(engine)
            self.outputs: dict[tuple, list] = {}
            self.streams: dict[tuple, list] = {}
            self._lock = threading.Lock()

        def generate_one(self, prompt_tokens, **kw):
            out = super().generate_one(prompt_tokens, **kw)
            with self._lock:
                self.outputs.setdefault(_req_key(prompt_tokens, kw), []).append(list(out))
            return out

        def stream_one(self, prompt_tokens, **kw):
            inner = super().stream_one(prompt_tokens, **kw)
            chunks: list = []
            with self._lock:
                self.streams.setdefault(_req_key(prompt_tokens, kw), []).append(chunks)

            def recorded():
                for chunk in inner:
                    chunks.append(list(chunk))
                    yield chunk

            return TokenStream(recorded(), inner.close)

    return StreamRecorder(engine)


def _paged_engine(params, cfg, tok, **kw):
    """Path 2's engine configuration (8 slots, page 256, context 2048)."""
    from ditl_tpu_torch.infer.continuous import ContinuousEngine

    return ContinuousEngine(params, cfg, tok, n_slots=8, decode_chunk=16, max_cache_len=2048,
                            cache_mode="paged", page_size=256, device="cuda", **kw)


class _Served:
    """An HTTP server over ``gen`` (and ``engine`` behind a stream recorder,
    when given) on its own thread; ``close()`` drains and stops it."""

    def __init__(self, gen, engine=None):
        from ditl_tpu_torch.infer import server as server_mod

        self.rec = None if engine is None else _stream_recorder(engine)
        self.engine = engine
        self.server = server_mod.make_server(gen, threaded_engine=self.rec, host="127.0.0.1",
                                             port=0, model_name=gen.cfg.name)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stats(self) -> dict:
        status, stats = _http("GET", self.url + "/v1/stats")
        require(status == 200, stats)
        return stats

    def close(self) -> None:
        self.server.close(drain=True)
        self.thread.join(timeout=30)
        require(not self.thread.is_alive() and (
            self.rec is None or not self.rec._thread.is_alive()), "server did not stop")


def _sse(url: str, route: str, payload: dict):
    """POST ``payload`` with ``"stream": true``: (status, headers, events,
    seconds from the send to each event), the events being the ``data:``
    payloads, JSON-decoded but the final ``[DONE]`` (a non-200 answer's
    events are its JSON body)."""
    import http.client

    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", route, json.dumps({**payload, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        headers = {k.lower(): v for k, v in resp.getheaders()}
        if resp.status != 200:
            return resp.status, headers, json.loads(resp.read() or b"{}"), []
        events, times = [], []
        while True:
            line = resp.fp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                times.append(time.perf_counter() - t0)
                data = line[len(b"data: "):].strip().decode()
                events.append(data if data == "[DONE]" else json.loads(data))
        return 200, headers, events, times
    finally:
        conn.close()


def _sse_text(events, chat: bool):
    """(the content events' indices, their texts, the concatenated text, the
    finish reason) of an SSE body, whose framing is checked: a chat stream
    opens with the role chunk, every chunk but the finish chunk has no
    finish reason, the finish chunk carries no text, ``[DONE]`` is last."""
    require(events and events[-1] == "[DONE]", events[-3:])
    first = 0
    if chat:
        require(events[0]["choices"][0]["delta"] == {"role": "assistant", "content": ""},
                events[0])
        first = 1
    body = events[first:-1]
    texts = [e["choices"][0]["delta"].get("content", "") if chat else e["choices"][0]["text"]
             for e in body]
    finish = body[-1]["choices"][0]["finish_reason"]
    require(all(e["choices"][0]["finish_reason"] is None for e in body[:-1])
            and texts[-1] == "" and finish in ("stop", "length"), body[-1])
    content = [i + first for i, t in enumerate(texts[:-1]) if t]
    return content, texts[:-1], "".join(texts), finish


def _as_routes(requests: list) -> list:
    """(route, payload, chat) of each request: the odd ones through
    /v1/chat/completions, their prompt as the user message."""
    out = []
    for i, p in enumerate(requests):
        if i % 2:
            payload = {k: v for k, v in p.items() if k != "prompt"}
            payload["messages"] = [{"role": "user", "content": p["prompt"]}]
            out.append(("/v1/chat/completions", payload, True))
        else:
            out.append(("/v1/completions", dict(p), False))
    return out


def _prewarm(url: str) -> None:
    """Publish the shared 600-character prefix's two full pages on both
    routes, so that each leg's four shared-prefix requests hit the same
    pages whatever order they arrive in (a cold and a prefix-hit prefill
    differ by bf16 rounding)."""
    prefix = _continuous_requests()[0][0]["prompt"][:600]
    for route, payload, _ in _as_routes([{"prompt": prefix + " warm", "max_tokens": 1}] * 2):
        status, body = _http("POST", url + route, payload)
        require(status == 200, body)


def _send_all(url: str, routed: list, stream: bool) -> dict:
    """Send every (route, payload, chat) from its own thread, all at once;
    returns {index: (text, finish, usage or None, events, times)}."""
    results: dict[int, tuple] = {}

    def one(i):
        route, payload, chat = routed[i]
        if stream:
            status, headers, events, times = _sse(url, route, payload)
            require(status == 200 and headers.get("content-type") == "text/event-stream"
                    and headers.get("connection") == "close", (i, status, headers, events))
            content, _, text, finish = _sse_text(events, chat)
            results[i] = (text, finish, None, [events[j] for j in content],
                          [times[j] for j in content] + [times[-1]])
        else:
            status, body = _http("POST", url + route, payload)
            require(status == 200, (i, status, body))
            choice = body["choices"][0]
            text = choice["message"]["content"] if chat else choice["text"]
            results[i] = (text, choice["finish_reason"], body["usage"], None, None)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(routed))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    require(len(results) == len(routed), sorted(results))
    return results


def _stop_at_boundary(tok, ids: list[int]) -> tuple[str, int] | None:
    """The shortest stop sequence across the text offset of token 16 or 32
    of ``ids`` that first occurs there, with that token offset; None when
    there is none, or when an id is neither a printable byte nor past the
    byte table (a text offset is then not a token offset's)."""
    off = tok.byte_offset
    if not all(off + 0x20 <= t < off + 0x7f or t >= off + 256 for t in ids):
        return None
    text = tok.decode(ids)
    for k in (16, 32):
        j = len(tok.decode(ids[:k]))
        for a, b in ((1, 1), (1, 2), (2, 1), (2, 2), (3, 3), (4, 4), (6, 6), (8, 8)):
            s = text[j - a: j + b]
            if j >= a and len(s) == a + b and text.find(s) == j - a:
                return s, k
    return None


def _stream_legs(gen_s, params, cfg, tok, flash, paged, requests, tag: str, **engine_kw):
    """``requests`` (routed by ``_as_routes``) through a fresh engine, pre-warmed,
    without a stream, then through another, pre-warmed, streamed; every
    streamed text and finish equals the unstreamed one, and so do the token
    ids (each stream's chunks against the same request's tokens). Returns
    the two legs' results, the streamed leg's launch counts (reset after its
    pre-warm, read once the engine has settled), its stats before and after
    and its server."""
    import gc

    from ditl_tpu_torch.infer.server import _chat_prompt

    routed = _as_routes(requests)
    plain = _Served(gen_s, _paged_engine(params, cfg, tok, **engine_kw))
    try:
        _prewarm(plain.url)
        want = _send_all(plain.url, routed, stream=False)
        want_tokens = dict(plain.rec.outputs)
    finally:
        plain.close()
    del plain
    gc.collect()
    streamed = _Served(gen_s, _paged_engine(params, cfg, tok, **engine_kw))
    try:
        _prewarm(streamed.url)
        st0 = streamed.stats()
        flash.reset_launches()  # this leg's counts start here
        paged.reset_launches()
        t0 = time.perf_counter()
        got = _send_all(streamed.url, routed, stream=True)
        wall = time.perf_counter() - t0
        engine = streamed.engine  # a stop's cancel lands between ticks: wait it out
        while engine.stats()["slots_busy"] or engine.pending:
            require(time.perf_counter() - t0 < 600, "the engine did not settle")
            time.sleep(0.01)
        launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                    "paged_verify": paged.launches_verify,
                    "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                    - paged.launches_tail - paged.launches_verify}  # read right after
        st1 = streamed.stats()
    except BaseException:
        streamed.close()
        raise
    for i, (route, payload, chat) in enumerate(routed):
        require(got[i][:2] == want[i][:2], (tag, i, got[i][:2], want[i][:2]))
        ids = [tok.bos_id] + tok.encode(payload["prompt"] if not chat else
                                        _chat_prompt(payload["messages"]))
        key = _req_key(ids, {"max_new_tokens": payload["max_tokens"],
                             "temperature": payload.get("temperature"),
                             "seed": payload.get("seed")})
        chunks, full = streamed.rec.streams[key], want_tokens[key][0]
        toks = sum(chunks[0], [])
        # a stop sequence cancels the stream; unstreamed, the text is cut
        require(len(chunks) == 1 and len(full) == want[i][2]["completion_tokens"]
                and (toks == full if not payload.get("stop") else toks == full[:len(toks)]),
                (tag, i, chunks, full))
    n_chunks = [len(r[3]) for r in got.values()]
    require(max(n_chunks) >= 2, n_chunks)
    log(f"[{tag}] {len(routed)} requests ({sum(c for _, _, c in routed)} chat), "
        f"{sum(1 for r in requests if r.get('temperature'))} sampled with pinned seeds, "
        f"streamed concurrently in {wall:.3f}s: every text, finish reason and token list "
        f"equals the same request's without a stream; content chunks a stream "
        f"{sorted(n_chunks)}")
    return want, got, launches, (st0, st1), streamed


def phase_serve_stream(gen, flash, paged, bf16: dict) -> dict:
    """Main path 20, streaming, embeddings and API eval over path 1's
    weights (the lm head of ``ASCII_HEAD_SCALE``): (1) path 2's 12 requests,
    the odd ones as chat, greedy and sampled with pinned seeds, without a
    stream on a fresh path-2 engine, then streamed concurrently on another
    (both pre-warmed, ``_prewarm``), plus one of ``STOP_PROBES`` with a stop
    sequence across a chunk boundary: texts, finish reasons and
    token ids equal, SSE framing, at least one stream of two or more content
    chunks; time to the first content chunk and per output token, and one
    streamed cold request on the idle engine against path 2's TTFT. (2) A
    client that reads two chunks of a 1500-token stream and goes away: its
    slot frees within a few ticks and K3 stops. (3) The same streaming
    check through path 7's prompt-lookup engine and ``DEPTH2_DRAFT``'s
    drafter at depth 2: K3-verify on every round. (4) Path 1's lock-step server: one
    content chunk, the same text. (5) /v1/embeddings on four inputs padded
    to 1024: K1 once a layer, unit norms, each vector's cosine with the
    plain forward at least ``EMBED_COS_MIN``; ``client.embed`` once. (6)
    ``train()`` on qwen2-0.5b (``EVAL_TRAIN_ARGS``) with the API eval
    against the path's server: finite falling losses, 16 client requests,
    no retries exhausted, 16 served requests, K1/K2a/K2b per layer per step
    beside the server's K1 and K3. Returns the path's launch counts."""
    import dataclasses
    import gc
    import socket

    import torch

    from ditl_tpu_torch.client import llm as client_llm
    from ditl_tpu_torch.config import APIConfig
    from ditl_tpu_torch.infer.engine import Generator
    from ditl_tpu_torch.models import llama

    cfg, tok = gen.cfg, gen.tokenizer
    params = _ascii_params(gen)
    gen_s = Generator(params, cfg, tok, device="cuda")
    total = {k: 0 for k in ("flash_fwd", "flash_dq", "flash_dkv", "paged_tail",
                            "paged_verify")}

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)

    # (1) streaming on path 2's engine, the stop probe beside path 2's 12
    requests = _continuous_requests()[0]
    probe = _Served(gen_s, _paged_engine(params, cfg, tok))
    try:
        texts = _send_all(probe.url, [("/v1/completions", p, False) for p in STOP_PROBES],
                          stream=False)
        found = None
        for i, p in enumerate(STOP_PROBES):
            ids = probe.rec.outputs[_req_key([tok.bos_id] + tok.encode(p["prompt"]), {
                "max_new_tokens": p["max_tokens"], "temperature": p["temperature"],
                "seed": p["seed"]})][0]
            at = _stop_at_boundary(tok, ids)
            if at is not None:
                found = (p, texts[i][0], *at)
                break
        require(found is not None, [t[0] for t in texts.values()])
        p_stop, probe_text, stop, k_stop = found
        with_stop = dict(p_stop, stop=[stop])
        status, body = _http("POST", probe.url + "/v1/completions", with_stop)
        cut = probe_text[: probe_text.find(stop)]
        require(status == 200 and (body["choices"][0]["text"],
                                   body["choices"][0]["finish_reason"]) == (cut, "stop"), body)
    finally:
        probe.close()
    del probe
    want, got, launches, (st0, st1), served = _stream_legs(
        gen_s, params, cfg, tok, flash, paged, requests + [with_stop], "stream")
    try:
        steps = st1["decode_steps"] - st0["decode_steps"]
        cold = st1["prefills_cold"] - st0["prefills_cold"]
        require(launches["paged_tail"] == cfg.num_layers * steps
                and launches["flash_fwd"] == cfg.num_layers * cold
                and launches["paged_verify"] == launches.pop("other") == 0,
                (launches, steps, cold))
        log(f"[stream] K3 launches {launches['paged_tail']} = {cfg.num_layers} layers x "
            f"{steps} decode steps; K1 launches {launches['flash_fwd']} = {cfg.num_layers} x "
            f"{cold} cold prefills ({st1['prefills_prefix_hit'] - st0['prefills_prefix_hit']} "
            f"prefix hits on the pre-warmed pages)")
        add(launches)
        ids = [tok.bos_id] + tok.encode(p_stop["prompt"])
        probe_chunks = served.rec.streams[_req_key(ids, {
            "max_new_tokens": p_stop["max_tokens"], "temperature": p_stop["temperature"],
            "seed": p_stop["seed"]})][0]
        p = len(requests)
        lens = [len(c) for c in probe_chunks]
        require(got[p][:2] == (cut, "stop") and len(lens) == k_stop // 16 + 1
                and lens[:-1] == [16] * (k_stop // 16), (got[p][:2], lens))
        log(f"[stream] stop sequence {stop!r} across the boundary of the probe's chunks "
            f"{lens} at token {k_stop} (probe {STOP_PROBES.index(p_stop)}): streamed "
            f"{got[p][0]!r}, finish 'stop', as without a stream")
        ttfc = sorted(r[4][0] for r in got.values())
        tpot = sorted((got[i][4][-1] - got[i][4][0])
                      / max(1, want[i][2]["completion_tokens"] - 1)
                      for i in range(len(requests)))
        # one cold streamed request on the idle engine, path 2's TTFT request
        status, _, events, times = _sse(served.url, "/v1/completions",
                                        {"prompt": _text(47, 1000), "max_tokens": 16})
        content, _, text, _ = _sse_text(events, False)
        require(status == 200 and content and len(text) == 16, (status, text))
        idle_ttfc = times[content[0]]
        log(f"[stream] time to the first content chunk over the 13 concurrent streams: "
            f"median {ttfc[len(ttfc) // 2] * 1e3:.1f} ms, max {ttfc[-1] * 1e3:.1f} ms; "
            f"time per output token after it: median {tpot[len(tpot) // 2] * 1e3:.1f} ms, "
            f"max {tpot[-1] * 1e3:.1f} ms; one cold streamed 1001-token request on the idle "
            f"engine: first content chunk after {idle_ttfc * 1e3:.1f} ms, its whole 16 tokens "
            f"after {times[-1] * 1e3:.1f} ms, against path 2's time to first token "
            f"{bf16['ttft_s'] * 1e3:.1f} ms (HTTP included; a stream's first chunk is a "
            f"tick's 16 tokens; host clock; {SMI})")

        # (2) a client that goes away after two chunks
        engine = served.engine
        body = json.dumps({"prompt": _text(49, 100), "max_tokens": 1500, "stream": True})
        sock = socket.create_connection(("127.0.0.1", int(served.url.rsplit(":", 1)[1])),
                                        timeout=600)
        sock.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                      f"application/json\r\nContent-Length: {len(body)}\r\n\r\n{body}").encode())
        seen = b""
        while seen.count(b"data: ") < 2:
            data = sock.recv(65536)
            require(data, "stream closed early")
            seen += data
        ticks0 = engine.decode_ticks
        sock.shutdown(socket.SHUT_RDWR)
        sock.close()
        t0 = time.perf_counter()
        while engine.stats()["slots_busy"] or engine.pending:
            require(time.perf_counter() - t0 < 60, "the abandoned stream kept its slot")
            time.sleep(0.01)
        ticks = engine.decode_ticks - ticks0
        k3 = paged.launches_tail
        time.sleep(1.0)
        st = served.stats()
        require(ticks <= 4 and paged.launches_tail == k3 and st["slots_busy"] == 0
                and st["queue_depth"] == 0, (ticks, k3, paged.launches_tail, st))
        log(f"[stream] a client gone after two chunks of a 1500-token stream: its slot "
            f"free {ticks} ticks later ({(time.perf_counter() - t0 - 1.0) * 1e3:.0f} ms), "
            f"K3's count unmoved over the next second, /v1/stats slots_busy 0")

        # (5) /v1/embeddings: K1 once a layer, against the plain forward
        n_tok = [1 + len(tok.encode(t)) for t in EMBED_INPUTS]
        require(512 < max(n_tok) <= 1024, n_tok)  # padded to 1024
        flash.reset_launches()
        paged.reset_launches()
        t0 = time.perf_counter()
        status, body = _http("POST", served.url + "/v1/embeddings",
                             {"input": EMBED_INPUTS, "model": "m"})
        embed_s = time.perf_counter() - t0
        k1 = flash.launches
        require(status == 200 and k1 == cfg.num_layers and body["usage"]["prompt_tokens"]
                == sum(n_tok), (status, k1, body.get("usage")))
        add({"flash_fwd": k1})
        vecs = torch.tensor([d["embedding"] for d in body["data"]], dtype=torch.float32)
        norms = vecs.norm(dim=-1)
        require(vecs.shape == (4, cfg.hidden_size)
                and bool(((norms - 1).abs() < 1e-4).all()), norms)
        fwd = flash.flash_attention_fwd
        flash.flash_attention_fwd = flash.flash_attention_plain
        try:
            with torch.no_grad():
                ids = torch.full((4, 1024), tok.pad_id, dtype=torch.long, device="cuda")
                for i, t in enumerate(EMBED_INPUTS):
                    ids[i, : n_tok[i]] = torch.tensor([tok.bos_id] + tok.encode(t))
                pos = torch.arange(1024, device="cuda")
                seg = (pos[None] < torch.tensor(n_tok, device="cuda")[:, None]).to(torch.int32)
                hidden = llama.forward(gen.params, ids, cfg, positions=pos.expand(4, 1024),
                                       segment_ids=seg, return_hidden=True)
                mask = seg.float()[..., None]
                plain = ((hidden.float() * mask).sum(1) / mask.sum(1)).cpu()
        finally:
            flash.flash_attention_fwd = fwd
        require(flash.launches == k1, "the plain forward launched K1")
        cos = torch.nn.functional.cosine_similarity(vecs, plain, dim=-1)
        require(bool((cos >= EMBED_COS_MIN).all()), cos)
        client = client_llm.LLMClient(APIConfig(api_base=served.url + "/v1", timeout_s=300))
        again = client.embed(EMBED_INPUTS)
        require(again is not None and float((torch.tensor(again, dtype=torch.float32)
                                             - vecs).abs().max()) <= 1e-6,
                "client.embed differs")
        add({"flash_fwd": flash.launches - k1})
        log(f"[embed] /v1/embeddings, 4 inputs of {n_tok} tokens padded to 4 x 1024: "
            f"{embed_s * 1e3:.1f} ms over HTTP, K1 launches {k1} = {cfg.num_layers} layers "
            f"x 1 forward; norms {[round(float(n), 6) for n in norms]}; cosine with the "
            f"plain forward {[round(float(c), 6) for c in cos]} (at least {EMBED_COS_MIN}); "
            f"client.embed the same vectors ({SMI})")

        # (6) API eval during training against this server
        from ditl_tpu_torch.launch import build_config
        from ditl_tpu_torch.train import trainer as trainer_mod

        config, device = build_config(EVAL_TRAIN_ARGS + [f"api.api_base={served.url}/v1"])
        mcfg = config.model
        require((mcfg.name, mcfg.num_layers, mcfg.hidden_size, mcfg.dtype,
                 mcfg.attention_impl, config.train.eval_every, config.train.eval_samples,
                 device) == ("qwen2-0.5b", 24, 896, "bfloat16", "flash", 2, 8, "cuda"), config)
        m = client_llm.client_metrics
        before = {k: getattr(m, k).value for k in ("requests", "retries", "retry_exhausted",
                                                   "deadline_exhausted")}
        st0 = served.stats()
        evals = []
        real = trainer_mod.run_api_eval

        def timed_eval(*args, **kw):
            t = time.perf_counter()
            out = real(*args, **kw)
            evals.append((time.perf_counter() - t, out))
            return out

        trainer_mod.run_api_eval = timed_eval
        flash.reset_launches()  # this leg's counts start here
        paged.reset_launches()
        try:
            summary = trainer_mod.train(config, device=device)
        finally:
            trainer_mod.run_api_eval = real
        counts = {"flash_fwd": flash.launches, "flash_dq": flash.launches_dq,
                  "flash_dkv": flash.launches_dkv, "paged_tail": paged.launches_tail,
                  "paged_other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                  - paged.launches_tail}  # read right after
        st1 = served.stats()
        after = {k: getattr(m, k).value - before[k] for k in before}
        losses = summary["losses"]
        served_k1 = cfg.num_layers * (st1["prefills_cold"] - st0["prefills_cold"])
        train_k1 = 2 * mcfg.num_layers * EVAL_STEPS
        require(summary["steps"] == EVAL_STEPS and all(x == x and abs(x) != float("inf")
                                                       for x in losses)
                and losses[-1] < losses[0], losses)
        require(len(evals) == 2 and all(out["n"] == 8 and out["n_errors"] == 0
                                        for _, out in evals), evals)
        require(after == {"requests": 16, "retries": 0, "retry_exhausted": 0,
                          "deadline_exhausted": 0}, after)
        require(st1["requests"] - st0["requests"] == 16, (st0["requests"], st1["requests"]))
        require(counts["flash_dq"] == counts["flash_dkv"] == mcfg.num_layers * EVAL_STEPS
                and counts["flash_fwd"] == train_k1 + served_k1
                and counts["paged_tail"] == cfg.num_layers * (st1["decode_steps"]
                                                              - st0["decode_steps"]) > 0
                and counts.pop("paged_other") == 0, (counts, served_k1, st0, st1))
        add(counts)
        log(f"[api-eval] train() on qwen2-0.5b (bf16, f32 masters, flash, full remat) B=4 "
            f"S=2048, {EVAL_STEPS} steps, API eval every 2 steps against the path's "
            f"llama3-8b server: losses {[round(x, 4) for x in losses]}; step time p50 "
            f"{summary['step_time_p50_s']:.3f} s; eval wall {[round(s, 3) for s, _ in evals]} "
            f"s for 8 chat requests of up to 64 tokens each; results "
            f"{[out for _, out in evals]}; client requests +{after['requests']}, retries "
            f"+{after['retries']}, exhausted +{after['retry_exhausted']} / "
            f"+{after['deadline_exhausted']}; served requests +16; trainer K1 {train_k1} = "
            f"2 x {mcfg.num_layers} layers x {EVAL_STEPS} steps, K2a {counts['flash_dq']} "
            f"and K2b {counts['flash_dkv']} = {mcfg.num_layers} x {EVAL_STEPS}; server K1 "
            f"{served_k1} = {cfg.num_layers} x {st1['prefills_cold'] - st0['prefills_cold']} "
            f"cold prefills, K3 {counts['paged_tail']} = {cfg.num_layers} x "
            f"{st1['decode_steps'] - st0['decode_steps']} decode steps; peak device memory "
            f"{summary['peak_device_memory_gib']:.1f} GiB ({SMI})")
    finally:
        served.close()
    del served, config
    gc.collect()
    torch.cuda.empty_cache()

    # (3) speculative streaming at depth 2: prompt lookup, then the drafter
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = {**params, "layers": {g: {k: w[:2] for k, w in grp.items()}
                                    for g, grp in params["layers"].items()}}
    gen2 = Generator(params2, cfg2, tok, device="cuda")
    dcfg = dataclasses.replace(cfg, **DEPTH2_DRAFT)
    dparams = llama.init_params(dcfg, seed=11, device="cuda")
    for tag, kw in (("stream-spec", {}),
                    ("stream-draft", {"draft_params": dparams, "draft_cfg": dcfg})):
        _, _, launches, (st0, st1), served = _stream_legs(
            gen2, params2, cfg2, tok, flash, paged, requests, tag, speculative=True,
            spec_threshold=0.0, **kw)
        served.close()
        sp = st1["speculative"]
        rounds = sp["verify_rounds"] - st0["speculative"]["verify_rounds"]
        require(launches["paged_verify"] == cfg2.num_layers * rounds > 0
                and launches["paged_tail"] == launches.pop("other") == 0
                and sp["spec_ticks"] == sp["ticks"] > 0, (launches, rounds, sp))
        add(launches)
        log(f"[{tag}] depth 2: K3-verify launches {launches['paged_verify']} = "
            f"{cfg2.num_layers} layers x {rounds} verify rounds, single-query K3 0; "
            f"{sp['tokens_per_row_forward']:.3f} tokens per verify forward per row")
        del served
    del dparams, gen2, params2
    gc.collect()
    torch.cuda.empty_cache()

    # (4) the lock-step server: one content chunk, the same text
    lock = _Served(gen_s)
    try:
        chat_msgs = [{"role": "user", "content": _text(2, 140)}]
        cases = [("/v1/completions", {"prompt": _text(0, 100), "max_tokens": 16}, False),
                 ("/v1/chat/completions", {"messages": chat_msgs, "max_tokens": 16}, True),
                 ("/v1/completions", {"prompt": _text(4, 300), "max_tokens": 16,
                                      "temperature": 0.8, "seed": 7}, False)]
        flash.reset_launches()
        paged.reset_launches()
        for route, payload, chat in cases:
            status, _, events, _ = _sse(lock.url, route, payload)
            content, _, text, finish = _sse_text(events, chat)
            status2, body = _http("POST", lock.url + route, payload)
            choice = body["choices"][0]
            want_text = choice["message"]["content"] if chat else choice["text"]
            require(status == status2 == 200 and len(content) == 1 and text == want_text
                    and len(text) == 16 and finish == choice["finish_reason"],
                    (route, text, want_text, content))
        k1 = flash.launches
        require(k1 == cfg.num_layers * 2 * len(cases)
                and sum(getattr(paged, n) for n in paged._COUNTERS.values()) == 0, k1)
        add({"flash_fwd": k1})
        log(f"[stream-lockstep] lock-step server: {len(cases)} streams of one content "
            f"chunk each, the text of the same request without a stream; K1 launches {k1} "
            f"= {cfg.num_layers} x {2 * len(cases)} prefills")
    finally:
        lock.close()
    del lock, gen_s, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[stream] path 20 launches {total}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return total


# Path 21: optimistic admission with preemption and exact resume, logprobs,
# deadlines and n/best_of. Pool pressure at full width: eight prompts of
# PREEMPT_CHARS + 1 tokens with PREEMPT_MAX_NEW-token budgets, 2 pages of 256
# at worst, 1 with a tick of headroom; PREEMPT_PAGES usable pages hold four
# requests under reserve admission and all eight optimistically, until each
# needs its second page after the first tick and the four youngest (the last
# a sampled request, the one before it a logprob request) are preempted.
PREEMPT_CHARS = 229
PREEMPT_MAX_NEW = 96
PREEMPT_PAGES = 8  # usable pages (page 0 is the sentinel)
# Re-prefilled K/V against the K/V the decode steps first wrote: a batched
# bf16 prefill rounds apart from one token a step, so a greedy token after a
# resume may flip where two candidates are that close. As SPEC_TIE_TOL: at a
# request's first divergence the two candidates' logits in one plain forward
# over the common prefix must differ by less than this.
RESUME_TIE_TOL = 0.25
# The engine's chosen-token logprobs (K3 over pages and tail) against the
# lock-step Generator's (plain masked attention over a contiguous cache) for
# the same bf16 request: their logits differ by up to ~0.07 (SPEC_TIE_TOL's
# note), and a logprob moves with its logit.
LP_BF16_TOL = 0.15
# Depth-2 legs (views of path 1's first two layers): four prompts of
# DEPTH2_CHARS + 1 tokens with 96-token budgets, 2 pages each with a
# speculative tick's headroom (63 positions) or a plain tick's, 3 at worst;
# DEPTH2_PAGES usable pages preempt two when their third pages come due.
DEPTH2_CHARS = 439
DEPTH2_PAGES = 8


def _preempt_recorder(engine):
    """``engine`` behind a ``ThreadedEngine`` that keeps, by ``_req_key``,
    what each completion returned: ``generate_one``'s tokens,
    ``generate_one_with_logprobs``' (tokens, stats), ``generate_many``'s
    finished requests (key prefixed ``"many"``) and the (tokens, stats)
    chunks of ``stream_one_with_logprobs`` (prefixed ``"stream"``)."""
    from ditl_tpu_torch.infer.continuous import ThreadedEngine, TokenStream

    class Recorder(ThreadedEngine):
        def __init__(self, engine):
            super().__init__(engine)
            self.outputs: dict[tuple, list] = {}
            self._lock = threading.Lock()

        def _keep(self, key, value):
            with self._lock:
                self.outputs.setdefault(key, []).append(value)

        def generate_one(self, prompt_tokens, **kw):
            out = super().generate_one(prompt_tokens, **kw)
            self._keep(_req_key(prompt_tokens, kw), list(out))
            return out

        def generate_one_with_logprobs(self, prompt_tokens, n_top, **kw):
            out, lp = super().generate_one_with_logprobs(prompt_tokens, n_top, **kw)
            self._keep(_req_key(prompt_tokens, kw), (list(out), lp))
            return out, lp

        def generate_many(self, prompt_tokens, n, **kw):
            reqs = super().generate_many(prompt_tokens, n, **kw)
            self._keep(("many",) + _req_key(prompt_tokens, kw), reqs)
            return reqs

        def stream_one_with_logprobs(self, prompt_tokens, n_top, **kw):
            inner = super().stream_one_with_logprobs(prompt_tokens, n_top, **kw)
            chunks: list = []
            self._keep(("stream",) + _req_key(prompt_tokens, kw), chunks)

            def recorded():
                for item in inner:
                    chunks.append(item)
                    yield item

            return TokenStream(recorded(), inner.close)

    return Recorder(engine)


def _preempt_requests(tok):
    """Path 21's eight payloads, in arrival order: six greedy, then a
    greedy logprob request (``logprobs: 5``) and a seeded sampled one, the
    two youngest. Returns them and each one's ``_req_key``."""
    payloads = [{"prompt": _text(80 + i, PREEMPT_CHARS), "max_tokens": PREEMPT_MAX_NEW}
                for i in range(8)]
    payloads[6]["logprobs"] = 5
    payloads[7].update(temperature=0.8, top_p=0.95, seed=21)
    keys = [_req_key([tok.bos_id] + tok.encode(p["prompt"]),
                     {"max_new_tokens": p["max_tokens"], "temperature": p.get("temperature"),
                      "seed": p.get("seed")}) for p in payloads]
    return payloads, keys


def _preempt_leg(gen, flash, paged, payloads, tag: str, **engine_kw) -> dict:
    """``payloads`` over HTTP to a fresh path-2 engine (``logprobs_k=5``,
    ``engine_kw``) whose driver is held until all have arrived, in order,
    then released at once: the recorder's outputs, the most slots one tick
    decoded, the engine's stats, the wall seconds from the release, the
    launches (read right after; K3 on every decode step and K1 on every
    cold prefill, resumes' re-prefills included, required), each resume's
    milliseconds (synchronised on both sides) with its re-prefilled tokens,
    and the tokens each preempted request (by id: its arrival index) held at
    its first preemption."""
    import torch

    from ditl_tpu_torch.infer import server as server_mod

    cfg = gen.cfg
    engine = _paged_engine(gen.params, cfg, gen.tokenizer, logprobs_k=5, **engine_kw)
    gate = threading.Event()
    step, tick = engine.step, engine._decode_tick
    resume, preempt = engine._resume_paged_slot, engine._preempt_slot
    peak, resumes, preempted = [0], [], {}

    def held_step():
        gate.wait(timeout=600)
        step()

    def counted_tick(occupied):
        peak[0] = max(peak[0], sum(occupied))
        return tick(occupied)

    def timed_resume(slot, req):
        n0 = engine.resume_prefill_tokens
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok = resume(slot, req)
        torch.cuda.synchronize()
        if ok:
            resumes.append(((time.perf_counter() - t) * 1e3, engine.resume_prefill_tokens - n0))
        return ok

    def noted_preempt(slot):
        req = engine._slots[slot]
        preempted.setdefault(req.req_id, len(req.tokens))  # tokens at its first
        preempt(slot)

    engine.step, engine._decode_tick = held_step, counted_tick
    engine._resume_paged_slot, engine._preempt_slot = timed_resume, noted_preempt
    rec = _preempt_recorder(engine)
    server = server_mod.make_server(gen, threaded_engine=rec, host="127.0.0.1", port=0,
                                    model_name=cfg.name)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results: dict[int, tuple] = {}
    try:
        flash.reset_launches()  # this leg's counts start here
        paged.reset_launches()

        def one(i):
            results[i] = _http("POST", url + "/v1/completions", payloads[i])

        threads = []
        for i in range(len(payloads)):
            threads.append(threading.Thread(target=one, args=(i,)))
            threads[-1].start()
            t = time.perf_counter()
            while engine._next_id < i + 1:  # arrival order is id order
                require(time.perf_counter() - t < 60, f"request {i} did not arrive")
                time.sleep(0.002)
        t0 = time.perf_counter()
        gate.set()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                    "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                    - paged.launches_tail}  # read right after
        st = engine.stats()
    finally:
        gate.set()
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive() and not rec._thread.is_alive(), "server did not stop")
    require(all(results[i][0] == 200 for i in range(len(payloads))), results)
    require(launches["paged_tail"] == cfg.num_layers * st["decode_steps"]
            and launches["flash_fwd"] == cfg.num_layers * st["prefills_cold"]
            and launches.pop("other") == 0, (tag, launches, st["decode_steps"]))
    require(st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
            and st["slots_busy"] == st["queue_depth"] == 0, st)
    n_tokens = sum(results[i][1]["usage"]["completion_tokens"] for i in range(len(payloads)))
    log(f"[{tag}] {len(payloads)} requests, {st['pages_total']} usable pages: peak "
        f"{peak[0]} slots decoding together, {st['preemptions']} preemptions, "
        f"{len(resumes)} resumes, {st.get('resume_prefill_tokens', 0)} re-prefilled tokens; "
        f"{n_tokens} tokens in {wall:.3f}s, {n_tokens / wall:.1f} tokens/s; "
        f"{st['decode_ticks']} ticks, {st['decode_seconds'] / st['decode_steps'] * 1e3:.2f} ms "
        f"a decode step; K3 {launches['paged_tail']} = {cfg.num_layers} x "
        f"{st['decode_steps']} steps, K1 {launches['flash_fwd']} = {cfg.num_layers} x "
        f"{st['prefills_cold']} cold prefills (host clock; {SMI})")
    return {"outputs": rec.outputs, "peak": peak[0], "stats": st, "wall": wall,
            "tokens_s": n_tokens / wall, "launches": launches, "resumes": resumes,
            "preempted": preempted}


def _resume_tie_check(gen, cfg, prompt_ids, got, ref, tag: str, what: str,
                      labels: tuple = ("uncontended", "resumed")):
    """``got`` (a resumed request's tokens) against ``ref`` (the same
    request uncontended; ``labels`` name the two in the log as (ref, got)):
    None when identical, else the first diverging step, the two candidates'
    logit gap and the top-2 gap of one plain forward over the common
    prefix, logged; the candidates' gap must be under ``RESUME_TIE_TOL``."""
    n = min(len(got), len(ref))
    i = next((j for j in range(n) if got[j] != ref[j]), None)
    if i is None and len(got) == len(ref):
        return None
    i = n if i is None else i
    eos = gen.tokenizer.eos_id
    a = ref[i] if i < len(ref) else eos
    b = got[i] if i < len(got) else eos
    import torch

    with torch.no_grad():
        logits = _prefill_logits(gen, cfg, prompt_ids + ref[:i]).float()
    gap = abs(float(logits[a] - logits[b]))
    top2 = torch.topk(logits, 2).values
    log(f"[{tag}] {what}: first divergence at step {i} ({a} {labels[0]}, {b} {labels[1]}), "
        f"candidates' logit gap {gap:.4f}, top-2 gap {float(top2[0] - top2[1]):.4f} "
        f"(RESUME_TIE_TOL {RESUME_TIE_TOL})")
    require(gap < RESUME_TIE_TOL, (tag, what, i, a, b, gap))
    return i


def _depth2_model(gen, kv_int8: bool = False):
    """(config, weights) of the target at depth 2: views of path 1's first
    two layers, int8 pools with ``kv_int8``."""
    import dataclasses

    cfg2 = dataclasses.replace(gen.cfg, num_layers=2,
                               kv_cache_dtype="int8" if kv_int8 else gen.cfg.kv_cache_dtype)
    params2 = {**gen.params, "layers": {g: {k: w[:2] for k, w in grp.items()}
                                        for g, grp in gen.params["layers"].items()}}
    return cfg2, params2


def _depth2_preempt(gen, flash, paged, tag: str, counter: str, kv_int8: bool = False,
                    grammar=None, **engine_kw) -> dict:
    """The target at depth 2 (``_depth2_model``), four greedy requests
    (constrained by ``grammar`` when given), uncontended and then with
    ``admission="optimistic"`` over ``DEPTH2_PAGES`` usable pages: at least
    one preemption, each resumed; greedy tokens identical or diverging at a
    near-tie (``_resume_tie_check``); the contended run's ``counter`` (the
    verify or the single-query kernel of those pools) 2 x its rounds or
    steps, no other paged kernel, K1 on every cold prefill. Returns the
    contended run's launches."""
    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.infer.engine import Generator

    cfg2, params2 = _depth2_model(gen, kv_int8)
    tok = gen.tokenizer
    prompts = [[tok.bos_id] + tok.encode(_text(90 + i, DEPTH2_CHARS)) for i in range(4)]

    def run(**kw):
        eng = ContinuousEngine(params2, cfg2, tok, n_slots=8, decode_chunk=16,
                               max_cache_len=2048, cache_mode="paged", page_size=256,
                               device="cuda", **engine_kw, **kw)
        flash.reset_launches()
        paged.reset_launches()
        rids = [eng.submit(p, max_new_tokens=96, temperature=0.0, grammar=grammar)
                for p in prompts]
        out = eng.run()
        launches = {"flash_fwd": flash.launches, counter: getattr(paged, _counter(counter)),
                    "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                    - getattr(paged, _counter(counter))}  # read right after
        return eng, [out[r] for r in rids], launches

    _, ref, _ = run()
    eng, got, launches = run(admission="optimistic", n_pages=DEPTH2_PAGES + 1)
    st = eng.stats()
    spec = st.get("speculative")
    units = spec["verify_rounds"] if spec else st["decode_steps"]
    require(eng.preemptions >= 1 and st["resume_prefill_tokens"] > 0, (tag, st))
    require(launches[counter] == cfg2.num_layers * units > 0 and launches.pop("other") == 0
            and launches["flash_fwd"] >= cfg2.num_layers * st["prefills_cold"],
            (tag, launches, units, st["prefills_cold"]))
    gen2 = Generator(params2, cfg2, tok, device="cuda")
    diverged = [_resume_tie_check(gen2, cfg2, p, g, r, tag, f"request {i}")
                for i, (p, g, r) in enumerate(zip(prompts, got, ref))]
    log(f"[{tag}] depth 2: {eng.preemptions} preemptions, {st['resume_prefill_tokens']} "
        f"re-prefilled tokens; {counter} launches {launches[counter]} = {cfg2.num_layers} x "
        f"{units} {'verify rounds' if spec else 'decode steps'}, K1 {launches['flash_fwd']}; "
        f"greedy tokens against the uncontended run: "
        f"{sum(d is None for d in diverged)} of 4 identical")
    return launches


def phase_serve_preempt(gen, flash, paged, bf16: dict) -> dict:
    """Main path 21, optimistic admission with preemption and exact resume,
    logprobs, deadlines and n/best_of, over path 1's weights. (1) Pool
    pressure at full width: ``_preempt_requests`` over HTTP to path 2's
    engine with ``logprobs_k=5`` three times: on path 2's pool (the
    uncontended yardstick), then on ``PREEMPT_PAGES`` usable pages under
    ``admission="reserve"`` and ``"optimistic"`` (``_preempt_leg``): reserve
    decodes at most half the slots at once, optimistic more, with at least 4
    preemptions, each resumed; every greedy request (the logprob one too)
    gives the uncontended tokens or diverges first at a near-tie
    (``_resume_tie_check``), the logprob request's chosen logprobs the
    uncontended ones within ``LP_BF16_TOL`` up to there, and the sampled
    request, preempted and resumed, its tokens before the preemption. (2)
    The ms of a decode step with ``logprobs_k=5`` against 0 on the same
    eight requests (the same tokens), and of ``_lp_stats`` alone. (3) At
    depth 2 (``_depth2_preempt``): speculative ticks over prompt lookup and
    over ``DEPTH2_DRAFT``'s drafter, lookup over int8 pools, and plain ticks over
    int8 pools, each preempting and resuming. (4) Over HTTP, path 20's
    ASCII head, ``--admission optimistic --logprobs-k 5``: a logprob
    request's top-1 ids are its greedy tokens and its chosen logprobs the
    lock-step Generator's within ``LP_BF16_TOL``; streamed, its logprobs
    concatenate to the unstreamed ones; ``deadline_s: 0`` answers 504 before
    any work, a queued request past a short deadline 504 with the free pages
    back at their idle count; ``n: 2, best_of: 3`` two choices ranked by
    mean logprob, copy 0 the ``n: 1`` completion with the same seed.
    Returns the path's launch counts."""
    import dataclasses
    import gc

    import torch

    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.continuous import _lp_stats
    from ditl_tpu_torch.infer.engine import GenerateConfig, Generator
    from ditl_tpu_torch.models import llama

    cfg, tok = gen.cfg, gen.tokenizer
    total = {k: 0 for k in ("flash_fwd", "paged_tail", "paged_tail_int8", "paged_verify",
                            "paged_verify_int8")}

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)

    # (1) pool pressure at full width
    payloads, keys = _preempt_requests(tok)
    ref = _preempt_leg(gen, flash, paged, payloads, "preempt-uncontended")
    reserve = _preempt_leg(gen, flash, paged, payloads, "preempt-reserve",
                           n_pages=PREEMPT_PAGES + 1)
    opt = _preempt_leg(gen, flash, paged, payloads, "preempt-optimistic",
                       admission="optimistic", n_pages=PREEMPT_PAGES + 1)
    for leg in (ref, reserve, opt):
        add(leg["launches"])
    ost = opt["stats"]
    require(ref["stats"]["preemptions"] == reserve["stats"]["preemptions"] == 0, ref["stats"])
    require(reserve["peak"] <= 4 < opt["peak"], (reserve["peak"], opt["peak"]))
    require(ost["preemptions"] >= 4 and len(opt["resumes"]) == ost["preemptions"]
            and ost["resume_prefill_tokens"] == sum(n for _, n in opt["resumes"]), ost)
    require({6, 7} <= set(opt["preempted"]), opt["preempted"])  # the logprob and sampled ones
    same = 0
    for i, (payload, key) in enumerate(zip(payloads, keys)):
        want, got = ref["outputs"][key][0], opt["outputs"][key][0]
        if payload.get("logprobs"):
            (want, want_lp), (got, got_lp) = want, got
        prompt_ids = list(key[0])
        if payload.get("temperature"):
            # its own generator resumes where it stopped; what it draws from
            # then on depends on logits the bf16 re-prefill rounds apart
            cut = opt["preempted"][i]
            require(cut > 0 and got[:cut] == want[:cut], (i, cut, got[:cut], want[:cut]))
            k = next((j for j in range(min(len(got), len(want))) if got[j] != want[j]), None)
            log(f"[preempt-optimistic] the sampled request (seed {payload['seed']}), preempted "
                f"at token {cut}: " + ("the uncontended tokens" if k is None and got == want
                                       else f"first differs at token {k} of {len(got)}"))
            continue
        at = _resume_tie_check(gen, cfg, prompt_ids, got, want, "preempt-optimistic",
                               f"request {i}")
        same += at is None
        if payload.get("logprobs"):
            n = len(got) if at is None else at
            err = max(abs(a - b) for a, b in zip(got_lp["token_logprobs"][:n],
                                                 want_lp["token_logprobs"][:n]))
            require(err < LP_BF16_TOL and got_lp["top_ids"][:n] == want_lp["top_ids"][:n]
                    and [ids[0] for ids in got_lp["top_ids"]] == got, (err, n))
            log(f"[preempt-optimistic] the logprob request: top-1 ids are its tokens; chosen "
                f"logprobs {err:.5f} from the uncontended run's over {n} tokens")
    ms = sorted(m for m, _ in opt["resumes"])
    log(f"[preempt] greedy tokens against the uncontended run: {same} of 7 identical; peak "
        f"decoding slots reserve {reserve['peak']} / optimistic {opt['peak']}; preemptions "
        f"{reserve['stats']['preemptions']} / {ost['preemptions']}; re-prefilled tokens 0 / "
        f"{ost['resume_prefill_tokens']}; tokens/s {reserve['tokens_s']:.1f} / "
        f"{opt['tokens_s']:.1f} (uncontended {ref['tokens_s']:.1f}, path 2 "
        f"{bf16['tokens_s']:.1f}); wall {reserve['wall']:.3f} / {opt['wall']:.3f}s; a resume "
        f"(re-prefill and restore, synchronised) {ms[len(ms) // 2]:.2f} ms median of "
        f"{len(ms)}, {min(ms):.2f}-{max(ms):.2f} ms, "
        f"{[n for _, n in opt['resumes']]} tokens each ({SMI})")
    del ref, reserve, opt
    gc.collect()

    # (2) a decode step's cost with logprobs armed
    prompts = [[tok.bos_id] + tok.encode(p["prompt"]) for p in payloads]
    step_ms, outs = {}, {}
    for k in (0, 5):
        eng = _paged_engine(gen.params, cfg, tok, logprobs_k=k)
        lp = {"logprobs": 5} if k else {}
        rids = [eng.submit(p, max_new_tokens=48, temperature=0.0, **lp) for p in prompts]
        res = eng.run()
        outs[k] = [res[r] for r in rids]
        st = eng.stats()
        step_ms[k] = st["decode_seconds"] / st["decode_steps"] * 1e3
        del eng
    require(outs[0] == outs[5], "logprobs changed a token")
    logits = torch.randn((8, cfg.vocab_size), device="cuda")
    cur = torch.argmax(logits, dim=-1)
    lp_ms = _time_ms(lambda: _lp_stats(logits, cur, 5))
    log(f"[lp-timing] a decode step of 8 slots at full width: {step_ms[0]:.2f} ms with "
        f"logprobs_k=0, {step_ms[5]:.2f} ms with 5 (host clock over 3 ticks, the same "
        f"tokens); _lp_stats on (8, {cfg.vocab_size}) f32 logits {lp_ms:.4f} ms (CUDA "
        f"events; {SMI})")
    gc.collect()
    torch.cuda.empty_cache()

    # (3) depth 2: speculative and int8 resumes
    dcfg = dataclasses.replace(cfg, **DEPTH2_DRAFT)
    dparams = llama.init_params(dcfg, seed=11, device="cuda")
    spec = dict(speculative=True, spec_threshold=0.0)
    add(_depth2_preempt(gen, flash, paged, "preempt-spec", "paged_verify", **spec))
    add(_depth2_preempt(gen, flash, paged, "preempt-draft", "paged_verify",
                        draft_params=dparams, draft_cfg=dcfg, **spec))
    del dparams
    add(_depth2_preempt(gen, flash, paged, "preempt-spec-int8", "paged_verify_int8",
                        kv_int8=True, **spec))
    add(_depth2_preempt(gen, flash, paged, "preempt-int8", "paged_tail_int8", kv_int8=True))
    gc.collect()
    torch.cuda.empty_cache()

    # (4) over HTTP: logprobs, deadlines, n/best_of
    params = _ascii_params(gen)
    gen_s = Generator(params, cfg, tok, device="cuda")
    engine = _paged_engine(params, cfg, tok, logprobs_k=5, admission="optimistic")
    rec = _preempt_recorder(engine)
    server = server_mod.make_server(gen_s, threaded_engine=rec, host="127.0.0.1", port=0,
                                    model_name=cfg.name)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        flash.reset_launches()  # this leg's counts start here
        paged.reset_launches()
        prompt = _text(95, 300)
        ids = [tok.bos_id] + tok.encode(prompt)
        key = _req_key(ids, {"max_new_tokens": 40, "temperature": None, "seed": None})
        payload = {"prompt": prompt, "max_tokens": 40, "logprobs": 5}
        status, _ = _http("POST", url + "/v1/completions", {"prompt": prompt, "max_tokens": 1})
        require(status == 200, status)  # its full page published: both legs hit it
        status, body = _http("POST", url + "/v1/completions", payload)
        require(status == 200, body)
        toks, lp = rec.outputs[key][0]
        require([row[0] for row in lp["top_ids"]] == toks
                and body["choices"][0]["logprobs"]["token_logprobs"] == lp["token_logprobs"],
                (toks, lp["top_ids"]))
        status, _, events, _ = _sse(url, "/v1/completions", payload)
        require(status == 200, events)
        streamed = [v for e in events[:-1] if e["choices"][0].get("logprobs")
                    for v in e["choices"][0]["logprobs"]["token_logprobs"]]
        chunks = rec.outputs[("stream",) + key][0]
        require(streamed == lp["token_logprobs"]
                and sum((c[0] for c in chunks), []) == toks, (streamed, lp["token_logprobs"]))
        lock_k1 = flash.launches  # the lock-step yardstick's K1 is not the path's
        ref_out, ref_lp = gen_s.generate_tokens_with_logprobs(
            [ids], GenerateConfig(max_new_tokens=40, logprobs=5))
        lock_k1 = flash.launches - lock_k1
        n = next((j for j, (a, b) in enumerate(zip(toks, ref_out[0])) if a != b), len(toks))
        err = max(abs(a - b) for a, b in zip(lp["token_logprobs"][:n],
                                              ref_lp[0]["token_logprobs"][:n]))
        require(n > 0 and err < LP_BF16_TOL, (n, err))
        log(f"[preempt-http] --logprobs-k 5: a logprob request's top-1 ids are its {len(toks)} "
            f"greedy tokens; its chosen logprobs within {err:.5f} of the lock-step "
            f"Generator's over {n} tokens (LP_BF16_TOL {LP_BF16_TOL}); streamed in "
            f"{len(chunks)} chunks, the same logprobs")
        # deadlines: expired on arrival, and queued past a short one
        ticks0 = engine.stats()["decode_ticks"]
        status, body = _http("POST", url + "/v1/completions",
                             {"prompt": prompt, "max_tokens": 8, "deadline_s": 0})
        require(status == 504 and body["error"]["message"]
                == "deadline expired before any work began"
                and engine.stats()["decode_ticks"] == ticks0, body)
        idle = engine.stats()["pages_free"]
        gate = threading.Event()
        step = engine.step

        def held_step():
            gate.wait(timeout=600)
            step()

        engine.step = held_step
        answer = {}
        th = threading.Thread(target=lambda: answer.update(r=_http(
            "POST", url + "/v1/completions",
            {"prompt": _text(96, 200), "max_tokens": 8, "deadline_s": 0.5})))
        th.start()
        time.sleep(1.0)
        gate.set()
        th.join(timeout=60)
        engine.step = step
        st = engine.stats()
        status, body = answer["r"]
        # the metrics' counter: the arrival's 504 and this eviction
        expired = int(engine.metrics.deadline_expired.value)
        require(status == 504 and body["error"]["type"] == "timeout_error"
                and expired == 2 and st["pages_free"] == idle, (body, st, expired))
        log(f"[preempt-http] deadline_s 0: 504 before any work; a queued request past its "
            f"0.5 s deadline: 504 ({body['error']['message']!r}), free pages back at "
            f"{idle}")
        # n/best_of
        nb = {"prompt": _text(97, 150), "max_tokens": 16, "temperature": 1.5, "seed": 5}
        status, body = _http("POST", url + "/v1/completions", {**nb, "n": 2, "best_of": 3})
        require(status == 200 and len(body["choices"]) == 2, body)
        nb_ids = [tok.bos_id] + tok.encode(nb["prompt"])
        cands = rec.outputs[("many",) + _req_key(nb_ids, {
            "max_new_tokens": 16, "temperature": 1.5, "seed": 5})][0]
        mean = [sum(r.lp_token) / max(1, len(r.tokens)) for r in cands]
        order = sorted(range(3), key=lambda j: mean[j], reverse=True)
        require([c["text"] for c in body["choices"]]
                == [tok.decode(cands[j].tokens) for j in order[:2]]
                and body["usage"]["completion_tokens"] == sum(len(r.tokens) for r in cands),
                (body, mean))
        status, one = _http("POST", url + "/v1/completions", nb)
        single = rec.outputs[_req_key(nb_ids, {"max_new_tokens": 16, "temperature": 1.5,
                                               "seed": 5})][0]
        require(status == 200 and single == cands[0].tokens, (single, cands[0].tokens))
        log(f"[preempt-http] n 2, best_of 3: choices {order[:2]} of the copies by mean "
            f"logprob {[round(m, 4) for m in mean]}; copy 0 is the n 1 completion with seed 5; "
            f"usage {body['usage']['completion_tokens']} tokens")
        st = engine.stats()
        launches = {"flash_fwd": flash.launches - lock_k1, "paged_tail": paged.launches_tail,
                    "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                    - paged.launches_tail}  # read right after
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(launches["flash_fwd"] == cfg.num_layers * st["prefills_cold"] > 0
            and launches["paged_tail"] == cfg.num_layers * st["decode_steps"] > 0
            and launches.pop("other") == 0, (launches, st["prefills_cold"], st["decode_steps"]))
    add(launches)
    del server, rec, engine, gen_s, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[preempt] path 21 launches {total}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return total


# Path 22: grammar-constrained decoding. GUIDED_CAPACITY table rows hold the
# FREE and DEAD rows and every grammar of GUIDED_SPECS (1505 states, the JSON
# grammar's 1108 at depth 5 among them); at llama3-8b's 128256 columns the
# device table is 788 MB.
GUIDED_CAPACITY = 1536
GUIDED_MAX_NEW = 48
GUIDED_SPECS = {
    "phone": ("regex", r"[0-9]{3}-[0-9]{4}"),
    "words": ("regex", r"[a-z ]{10,40}"),
    "long": ("regex", r"[a-z ]{100,300}"),  # never done within a 96-token budget
    "color": ("schema", {"enum": ["red", "green", "blue"]}),
    "record": ("schema", {"type": "object", "properties": {
        "n": {"type": "integer", "minimum": 0, "maximum": 99},
        "u": {"anyOf": [{"const": "a"}, {"const": "b"}]}},
        "required": ["n", "u"], "additionalProperties": False}),
    "json": ("json", 5),
}
# The mixed batch: (prompt seed, grammar or None, submit kwargs); eight
# requests in eight slots, four unconstrained (one sampled), four guided
# greedy and one guided sampled beside them.
GUIDED_MIXED = [
    (110, None, {}), (111, "json", {}), (112, None, {"temperature": 0.8, "seed": 22}),
    (113, "phone", {}), (114, None, {}), (115, "record", {}),
    (116, "words", {"temperature": 0.9, "seed": 23}), (117, "color", {}),
]


def _guided_grammars(tok) -> dict:
    """``GUIDED_SPECS`` compiled for ``tok`` (``infer/grammar.py``)."""
    from ditl_tpu_torch.infer import grammar as G

    out = {}
    for name, (kind, spec) in GUIDED_SPECS.items():
        out[name] = (G.compile_regex(spec, tok) if kind == "regex"
                     else G.compile_json(tok, max_depth=spec) if kind == "json"
                     else G.compile_json_schema(spec, tok))
    return out


def _walk_ok(g, text: str, at_eos: bool) -> bool:
    """Every byte of ``text`` is a live edge of ``g``'s byte DFA, and a
    completion that ended at EOS fullmatches."""
    s = 0
    for b in text.encode():
        s = int(g.byte_next[s, b])
        if s < 0:
            return False
    return bool(g.accept[s]) or not at_eos


def _guided_oracle(gen, cfg, prompt_ids: list[int], g, max_new: int) -> list[int]:
    """Greedy guided tokens by full recompute: each step one plain prefill
    forward over the prompt and the tokens so far (``_prefill_logits``), its
    logits masked by the grammar's row at the current state (every column
    past the grammar's vocabulary masked), then the first maximum; EOS
    ends."""
    import torch

    eos = gen.tokenizer.eos_id
    table = torch.as_tensor(g.token_next, device="cuda")
    toks, state = [], 0
    with torch.no_grad():
        for _ in range(max_new):
            logits = _prefill_logits(gen, cfg, prompt_ids + toks).float()
            row = table[state]
            masked = torch.full_like(logits, float("-inf"))
            masked[: row.shape[0]] = torch.where(row >= 0, logits[: row.shape[0]],
                                                 float("-inf"))
            t = int(masked.argmax())
            if t == eos:
                break
            toks.append(t)
            state = int(g.token_next[state, t])
    return toks


def _run_counted(engine, flash, paged, requests):
    """Submit ``requests`` ((prompt ids, submit kwargs)) at once and run the
    engine to its end: the finished requests in order and the launches of
    K1, of every paged kernel by counter, read right after."""
    flash.reset_launches()
    paged.reset_launches()
    rids = [engine.submit(p, **kw) for p, kw in requests]
    done, steps = {}, 0
    while engine.pending:
        engine.step()
        steps += 1
        require(steps < 10000, "engine did not finish")
        done.update({r.req_id: r for r in engine.take_finished()})
    launches = {"flash_fwd": flash.launches,
                **{c: getattr(paged, c) for c in paged._COUNTERS.values()}}
    return [done[r] for r in rids], launches


def _guided_http(gen, flash, paged, grammars: dict) -> dict:
    """Over HTTP, a path-2 engine armed with ``GUIDED_CAPACITY`` rows and
    ``logprobs_k=2``: ``guided_regex``, ``guided_json``, chat
    ``response_format`` ``json_object`` and ``json_schema`` answer 200 with
    conforming text, a guided stream concatenates to the unstreamed text,
    two specs at once answer 400 and ``/v1/stats`` carries the guided block;
    then a 64-row server answers a JSON grammar 503, with the restart hint
    unstreamed and without it streamed. Returns the armed leg's launches (K1
    on every cold prefill, K3 on every decode step, required)."""
    import torch

    import gc

    cfg, tok = gen.cfg, gen.tokenizer
    served = _Served(gen, _paged_engine(gen.params, cfg, tok, fsm_capacity=GUIDED_CAPACITY,
                                        logprobs_k=2))
    try:
        flash.reset_launches()
        paged.reset_launches()
        phone = {"prompt": "call " + _text(130, 120), "guided_regex": GUIDED_SPECS["phone"][1],
                 "max_tokens": 16}
        forms = [
            ("/v1/completions", phone, "phone"),
            ("/v1/completions", {"prompt": "record " + _text(131, 120), "max_tokens": 40,
                                 "guided_json": GUIDED_SPECS["record"][1]}, "record"),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": _text(132, 90)}],
                                      "response_format": {"type": "json_object"},
                                      "max_tokens": 32}, "json"),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": _text(133, 90)}],
                                      "response_format": {"type": "json_schema", "json_schema": {
                                          "name": "color", "schema": GUIDED_SPECS["color"][1]}},
                                      "max_tokens": 16}, "color"),
        ]
        texts = []
        for route, payload, name in forms:
            status, body = _http("POST", served.url + route, payload)
            require(status == 200, (route, body))
            c = body["choices"][0]
            text = c["message"]["content"] if "chat" in route else c["text"]
            ended = c["finish_reason"] == "stop"
            require(_walk_ok(grammars[name], text, ended), (name, text))
            if ended and name in ("record", "color", "json"):
                json.loads(text)
            texts.append((name, text, c["finish_reason"]))
        status, _, events, _ = _sse(served.url, "/v1/completions", phone)
        require(status == 200, events)
        _, _, streamed, _ = _sse_text(events, chat=False)
        require(streamed == texts[0][1], (streamed, texts[0][1]))
        status, body = _http("POST", served.url + "/v1/completions",
                             {**phone, "response_format": {"type": "json_object"}})
        require(status == 400 and body["error"]["message"].startswith("at most one of"), body)
        st = served.engine.stats()
        launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                    "other": sum(getattr(paged, n) for n in paged._COUNTERS.values())
                    - paged.launches_tail}  # read right after
        http_stats = served.stats()
        require(http_stats["guided"] == st["guided"] and st["guided"]["grammars_registered"] == 4,
                (http_stats.get("guided"), st["guided"]))
    finally:
        served.close()
    require(launches["flash_fwd"] == cfg.num_layers * st["prefills_cold"] > 0
            and launches["paged_tail"] == cfg.num_layers * st["decode_steps"] > 0
            and launches.pop("other") == 0, (launches, st["prefills_cold"], st["decode_steps"]))
    log(f"[guided-http] guided_regex, guided_json, response_format json_object and "
        f"json_schema: 200, {[(n, t[:40], f) for n, t, f in texts]}; the guided stream "
        f"concatenates to the unstreamed text; two specs 400; /v1/stats guided "
        f"{st['guided']}; K1 {launches['flash_fwd']}, K3 {launches['paged_tail']}")
    del served
    gc.collect()
    torch.cuda.empty_cache()
    small = _Served(gen, _paged_engine(gen.params, cfg, tok, fsm_capacity=64))
    try:
        payload = {"prompt": "json " + _text(134, 60), "max_tokens": 8,
                   "response_format": {"type": "json_object"}}
        status, body = _http("POST", small.url + "/v1/completions", payload)
        msg = body["error"]["message"]
        require(status == 503 and msg.startswith("fsm_capacity exhausted: 2 rows used + 1108 "
                                                 "needed > 64") and "restart" in msg, body)
        status, _, body, _ = _sse(small.url, "/v1/completions", payload)
        require(status == 503 and body["error"]["message"]
                == "fsm_capacity exhausted: 2 rows used + 1108 needed > 64", body)
        require(small.stats()["guided"]["fsm_rows_used"] == 2, "a refused grammar took rows")
    finally:
        small.close()
    log(f"[guided-http] a 64-row server: a JSON grammar 503 ({msg!r}), streamed 503 "
        f"without the hint; no rows taken")
    del small
    torch.cuda.synchronize()
    return launches


def phase_serve_guided(gen, flash, paged) -> dict:
    """Main path 22, grammar-constrained decoding, over path 1's weights
    and path 2's engine shape, at full width. (1) ``GUIDED_MIXED`` on an
    engine armed with ``GUIDED_CAPACITY`` rows and on a guided-off engine,
    both driven directly: the unconstrained requests' tokens are identical;
    every guided completion walks its grammar's byte DFA, fullmatching when
    it ended at EOS; each greedy guided request gives the tokens of
    ``_guided_oracle`` (full recompute, mask, argmax) or diverges first at
    a near-tie (``_resume_tie_check``); K1 on every cold prefill, K3 on
    every decode step. Registration of the JSON grammar timed by stage:
    the byte DFA, the native token table (and the numpy walk beside it,
    which must give the same table), the upload. (2) The ms of a decode
    step with eight guided rows against the same eight prompts
    unconstrained on the armed engine and on the guided-off one;
    ``_fsm_mask`` alone at (8, vocab). (3) At depth 2: speculative ticks
    over prompt lookup and over ``DEPTH2_DRAFT``'s drafter give the plain guided
    ticks' tokens (or diverge at a near-tie; K3-verify on every round),
    and guided requests preempted and resumed under optimistic admission
    give their uncontended tokens (``_depth2_preempt``), over float and int8
    pools. (4) Over HTTP (``_guided_http``). Returns the path's launch
    counts."""
    import dataclasses
    import gc

    import torch

    from ditl_tpu_torch.infer import grammar as G
    from ditl_tpu_torch.infer.continuous import ContinuousEngine, _fsm_mask
    from ditl_tpu_torch.infer.engine import Generator
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.native import fsm as native_fsm

    cfg, tok = gen.cfg, gen.tokenizer
    total = {k: 0 for k in ("flash_fwd", "paged_tail", "paged_tail_int8", "paged_verify")}

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)

    # JSON grammar registration by stage, on the armed engine
    require(native_fsm.available(), "the native token-table builder did not build")
    grammars = _guided_grammars(tok)
    t = time.perf_counter()
    byte_next, accept = G._json_dfa(5, "object")
    dfa_ms = (time.perf_counter() - t) * 1e3
    toks = G.token_strings(tok)
    t = time.perf_counter()
    native = native_fsm.token_table_native(byte_next, toks)
    native_ms = (time.perf_counter() - t) * 1e3
    native_off = native_fsm.token_table_native
    native_fsm.token_table_native = lambda byte_next, toks: None
    try:
        t = time.perf_counter()
        walked = G._token_table(byte_next, accept, toks, eos_id=tok.eos_id, source="numpy")
        numpy_ms = (time.perf_counter() - t) * 1e3
    finally:
        native_fsm.token_table_native = native_off
    via_native = G._token_table(byte_next, accept, toks, eos_id=tok.eos_id, source="native")
    require(native is not None and (via_native.token_next == walked.token_next).all()
            and (via_native.token_next == grammars["json"].token_next).all(),
            "the native table differs from the numpy walk")
    armed = _paged_engine(gen.params, cfg, tok, fsm_capacity=GUIDED_CAPACITY)
    t = time.perf_counter()
    base = armed.register_grammar(grammars["json"])
    reg_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    armed._fsm_device()
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t) * 1e3
    table_mb = armed._fsm_dev.numel() * armed._fsm_dev.element_size() / 1e6
    n_json = grammars["json"].n_states
    log(f"[guided] JSON grammar (depth 5, {n_json} states, {len(toks)} token columns of "
        f"{cfg.vocab_size}): byte DFA {dfa_ms:.1f} ms, native token table {native_ms:.2f} ms "
        f"(numpy walk {numpy_ms:.1f} ms, the same table), registration at rows [{base}, "
        f"{base + n_json}) {reg_ms:.1f} ms, upload of its {n_json} rows "
        f"{upload_ms:.1f} ms (host clock, synchronised); device table {GUIDED_CAPACITY} x "
        f"{cfg.vocab_size} int32 = {table_mb:.1f} MB ({SMI})")

    # (1) the mixed batch, armed and guided off
    requests = []
    for seed, name, kw in GUIDED_MIXED:
        prompt = [tok.bos_id] + tok.encode(_text(seed, 160))
        requests.append((prompt, {"max_new_tokens": GUIDED_MAX_NEW, "temperature": 0.0,
                                  **kw, "grammar": grammars.get(name)}))
    got, launches = _run_counted(armed, flash, paged, requests)
    st = armed.stats()
    other = sum(v for k, v in launches.items() if k not in ("flash_fwd", "launches_tail"))
    require(launches["flash_fwd"] == cfg.num_layers * st["prefills_cold"]
            and launches["launches_tail"] == cfg.num_layers * st["decode_steps"] and other == 0,
            (launches, st))
    add({"flash_fwd": launches["flash_fwd"], "paged_tail": launches["launches_tail"]})
    off = _paged_engine(gen.params, cfg, tok)
    free, _ = _run_counted(off, flash, paged,
                           [(p, {k: v for k, v in kw.items() if k != "grammar"})
                            for p, kw in requests])
    same_free = [i for i, (_, name, _) in enumerate(GUIDED_MIXED)
                 if name is None and got[i].tokens == free[i].tokens]
    require(len(same_free) == sum(name is None for _, name, _ in GUIDED_MIXED),
            ("unconstrained rows differ from the guided-off engine", same_free))
    greedy_same, gaps = 0, []
    for i, (seed, name, kw) in enumerate(GUIDED_MIXED):
        if name is None:
            continue
        g, req = grammars[name], got[i]
        text = tok.decode(req.tokens)
        at_eos = len(req.tokens) < GUIDED_MAX_NEW
        require(_walk_ok(g, text, at_eos), (name, text))
        if at_eos and name in ("json", "record", "color"):
            json.loads(text)
        if kw.get("temperature"):
            log(f"[guided] sampled {name} request: {text!r} ({len(req.tokens)} tokens)")
            continue
        want = _guided_oracle(gen, cfg, requests[i][0], g, GUIDED_MAX_NEW)
        at = _resume_tie_check(gen, cfg, requests[i][0], req.tokens, want, "guided",
                               f"{name} request against the recompute oracle")
        greedy_same += at is None
        log(f"[guided] {name}: {text[:60]!r} ({len(req.tokens)} tokens, "
            f"{'EOS' if at_eos else 'budget'}); the oracle's tokens "
            + ("exactly" if at is None else f"up to step {at}"))
    log(f"[guided] mixed batch of 8 in 8 slots: the 4 unconstrained rows' tokens are the "
        f"guided-off engine's; {greedy_same} of 4 greedy guided requests equal the oracle; "
        f"K1 {launches['flash_fwd']} = {cfg.num_layers} x {st['prefills_cold']} cold "
        f"prefills, K3 {launches['launches_tail']} = {cfg.num_layers} x "
        f"{st['decode_steps']} steps; stats {st['guided']}")

    # (2) what the mask costs a decode step: the legs in turns, there and back
    prompts = [[tok.bos_id] + tok.encode(_text(140 + i, 200)) for i in range(8)]
    legs = [("guided-off engine", off, None), ("armed, none", armed, None),
            ("armed, 8 guided", armed, grammars["long"])]
    step_ms = {label: [] for label, _, _ in legs}
    for label, eng, grammar in legs + legs[::-1]:
        s0, n0 = eng.decode_seconds, eng.decode_steps
        _run_counted(eng, flash, paged, [(p, {"max_new_tokens": GUIDED_MAX_NEW,
                                              "temperature": 0.0, "grammar": grammar})
                                         for p in prompts])
        step_ms[label].append((eng.decode_seconds - s0) / (eng.decode_steps - n0) * 1e3)
    ftab = armed._fsm_device()
    fst = torch.tensor([0, 1] + [base + 3 * i for i in range(6)], dtype=torch.int32,
                       device="cuda")
    logits = torch.randn((8, cfg.vocab_size), device="cuda")
    mask_ms = _time_ms(lambda: _fsm_mask(ftab, fst, logits))
    log(f"[guided-timing] a decode step of 8 slots at full width: "
        + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} ms" for k, v in step_ms.items())
        + f" (host clock, {GUIDED_MAX_NEW} tokens each, the legs in turns, there and "
        f"back); _fsm_mask alone on (8, "
        f"{cfg.vocab_size}) f32 logits {mask_ms:.4f} ms (CUDA events; {SMI})")
    del armed, off, ftab
    gc.collect()
    torch.cuda.empty_cache()

    # (3) depth 2: speculative guided ticks, and preempted guided requests
    cfg2, params2 = _depth2_model(gen)
    gen2 = Generator(params2, cfg2, tok, device="cuda")
    span = [[tok.bos_id] + tok.encode(r["prompt"]) for r in _span_requests()]
    names = ["words", "json", "long", "record"]
    d2 = [(p, {"max_new_tokens": 64, "temperature": 0.0, "grammar": grammars[n]})
          for p, n in zip(span, names)]

    def engine2(**kw):
        return ContinuousEngine(params2, cfg2, tok, n_slots=8, decode_chunk=16,
                                max_cache_len=2048, cache_mode="paged", page_size=256,
                                device="cuda", fsm_capacity=GUIDED_CAPACITY, **kw)

    plain, lp = _run_counted(engine2(), flash, paged, d2)
    add({"flash_fwd": lp["flash_fwd"], "paged_tail": lp["launches_tail"]})
    dcfg = dataclasses.replace(cfg, **DEPTH2_DRAFT)
    dparams = llama.init_params(dcfg, seed=11, device="cuda")
    spec = dict(speculative=True, spec_threshold=0.0)
    for tag, kw in (("lookup", spec), ("draft", {**spec, "draft_params": dparams,
                                                 "draft_cfg": dcfg})):
        eng = engine2(**kw)
        reqs, ls = _run_counted(eng, flash, paged, d2)
        rounds = eng.stats()["speculative"]["verify_rounds"]
        other = sum(v for k, v in ls.items() if k not in ("flash_fwd", "launches_verify"))
        require(ls["launches_verify"] == cfg2.num_layers * rounds > 0 and other == 0,
                (tag, ls, rounds))
        add({"flash_fwd": ls["flash_fwd"], "paged_verify": ls["launches_verify"]})
        same = 0
        for (p, kw2), name, r, ref in zip(d2, names, reqs, plain):
            require(_walk_ok(grammars[name], tok.decode(r.tokens),
                             len(r.tokens) < 64), (tag, name))
            same += _resume_tie_check(gen2, cfg2, p, r.tokens, ref.tokens, f"guided-{tag}",
                                      f"{name} against plain guided ticks") is None
        log(f"[guided-{tag}] depth 2: {same} of 4 guided requests give the plain guided "
            f"ticks' tokens; K3-verify {ls['launches_verify']} = {cfg2.num_layers} x {rounds} "
            f"rounds; tokens per row forward "
            f"{eng.stats()['speculative']['tokens_per_row_forward']:.3f}")
        del eng
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    long_g = grammars["long"]
    add(_depth2_preempt(gen, flash, paged, "guided-preempt", "paged_tail", grammar=long_g,
                        fsm_capacity=GUIDED_CAPACITY))
    add(_depth2_preempt(gen, flash, paged, "guided-preempt-int8", "paged_tail_int8",
                        kv_int8=True, grammar=long_g, fsm_capacity=GUIDED_CAPACITY))
    del gen2
    gc.collect()
    torch.cuda.empty_cache()

    # (4) over HTTP
    add(_guided_http(gen, flash, paged, grammars))
    log(f"[guided] path 22 launches {total}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return total


def _paged_silent(paged, launches: dict) -> bool:
    """No paged kernel launched: every paged counter of ``launches`` (a
    ``_run_counted`` result) is zero."""
    return all(launches[c] == 0 for c in paged._COUNTERS.values())


def phase_serve_contiguous(gen, flash, paged, bf16: dict) -> dict:
    """Main path 23, the continuous engine over the contiguous KV cache
    (the reference's default), over path 1's weights at full width and
    depth, 8 slots, context 2048. (1) Path 2's 12 requests over HTTP to the
    engine as ``infer/server.py --engine continuous`` builds it with no
    ``--cache-mode`` flag: greedy tokens against path 2's paged engine by
    the divergence rule (``_resume_tie_check``), the sampled requests
    repeated per seed, K1 ``num_layers`` times on every cold prefill whose
    bucket tiles, no paged kernel; ``/health`` and ``/v1/stats`` without
    page fields; the cache's bytes beside their reckoning. (2)
    ``register_prefix`` of the 600-character shared prefix (BOS and its
    600 tokens): the four shared-prefix requests hit, give the cold run's
    tokens by the rule and launch no K1; a prompt equal to the prefix takes
    the stored logits' token; ``clear_prefixes`` returns the row's bytes;
    TTFT of a prefix hit against a cold prompt of the same length. (3)
    ``register_prefix`` on path 2's engine shape warms two full pages (K1
    on the warm), after which the four requests hit 512 tokens each at
    their first admission and ``prefill_tok_per_s`` appears; a warm on a
    one-page pool is a logged no-op. (4) ms per decode step, contiguous
    against paged, on the same eight requests in turns. (5) At depth 2
    (views of path 1's first two layers) the contiguous plain ticks'
    greedy tokens, by the rule, from chunked prefill (384-token chunks, no
    page multiple, under a 640-token budget; no K1), prompt-lookup
    speculative ticks, a guided JSON request beside unconstrained ones and
    logprobs (within ``LP_BF16_TOL`` of the lock-step Generator's); int8 KV
    on the contiguous cache against the paged int8 engine's tokens. No
    contiguous leg launches a paged kernel. Returns the path's launch
    counts."""
    import gc

    import torch

    from ditl_tpu_torch.infer import grammar as G
    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.infer.engine import GenerateConfig, Generator, _next_pow2

    t_path = time.perf_counter()
    cfg, tok = gen.cfg, gen.tokenizer
    n_l = cfg.num_layers
    total = {"flash_fwd": 0, "paged_tail": 0, "paged_tail_int8": 0}

    def add(launches):
        total["flash_fwd"] += launches["flash_fwd"]
        total["paged_tail"] += launches["launches_tail"]
        total["paged_tail_int8"] += launches["launches_tail_int8"]

    # (1) the default server configuration, over HTTP
    args = server_mod._parser().parse_args(["--engine", "continuous", "--max-cache-len", "2048"])
    require(args.cache_mode == "contiguous", args)
    engine = ContinuousEngine(gen.params, cfg, tok, n_slots=args.slots,
                              max_cache_len=args.max_cache_len, cache_mode=args.cache_mode,
                              prefill_chunk=args.prefill_chunk, device="cuda")
    cache_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    es = engine.cache["k"].element_size()
    per_token = 2 * n_l * cfg.num_kv_heads * cfg.head_dim * es  # K and V
    require(cache_bytes == per_token * 8 * 2048, (cache_bytes, per_token))
    log(f"[contiguous] engine built as --engine continuous with no --cache-mode: cache "
        f"{cache_bytes / 2**30:.3f} GiB = 2 x {n_l} layers x {cfg.num_kv_heads} KV heads x "
        f"{cfg.head_dim} x {es} B = {per_token / 1024:g} KiB a token x 8 slots x 2048 tokens "
        f"(path 2's pools {bf16['pool_bytes'] / 2**30:.3f} GiB, the sentinel page included)")
    buckets = []
    cold_prefill = engine._cold_prefill

    def rec_cold(prompt, slot):
        buckets.append(min(_next_pow2(len(prompt), floor=16), engine.smax))
        return cold_prefill(prompt, slot)

    engine._cold_prefill = rec_cold
    threaded = _recording_engine(engine)
    server = server_mod.make_server(gen, threaded_engine=threaded, host="127.0.0.1",
                                    port=0, model_name=cfg.name)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    requests, _ = _continuous_requests()
    try:
        flash.reset_launches()
        paged.reset_launches()
        results, wall = _send_continuous(url, requests, engine)
        sampled = [p for p in requests if p.get("temperature")]
        for payload in sampled:  # each again: the same tokens per seed
            status, body = _http("POST", url + "/v1/completions", payload)
            require(status == 200, body)
        k1 = flash.launches
        others = sum(getattr(paged, c) for c in paged._COUNTERS.values())  # read right after
        st = engine.stats()
        health = _http("GET", url + "/health")
        stats = _http("GET", url + "/v1/stats")
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive() and not threaded._thread.is_alive(), "server did not stop")
    engine._cold_prefill = cold_prefill
    bf16["contiguous_outputs"] = threaded.outputs  # path 24's yardstick
    require(health[0] == stats[0] == 200 and stats[1]["cache_mode"] == "contiguous"
            and not any(k.startswith("page") for k in list(health[1]) + list(stats[1])),
            (health, stats))
    tiling = sum(flash.supports(b, b, cfg.head_dim) for b in buckets)
    require(others == 0 and k1 == n_l * tiling == n_l * st["prefills_cold"] > 0,
            (k1, others, buckets, st["prefills_cold"]))
    total["flash_fwd"] += k1
    same, n_tokens = 0, 0
    for i, payload in enumerate(requests):
        status, body, _ = results[i]
        require(status == 200, (i, status, body))
        n_tokens += body["usage"]["completion_tokens"]
        ids = [tok.bos_id] + tok.encode(payload["prompt"])
        key = (tuple(ids), payload["max_tokens"])
        got = threaded.outputs[key]
        if payload.get("temperature"):
            require(len(got) == 2 and got[0] == got[1], (i, got))
            continue
        same += _resume_tie_check(gen, cfg, ids, got[0], bf16["outputs"][key][0],
                                  "contiguous", f"request {i} against path 2's",
                                  ("paged", "contiguous")) is None
    tick_ms = st["decode_seconds"] / st["decode_ticks"] * 1e3
    log(f"[contiguous] {len(requests)} concurrent requests in {wall:.3f}s wall, {n_tokens} "
        f"tokens; greedy tokens against path 2's paged engine: {same} of "
        f"{len(requests) - len(sampled)} identical; the {len(sampled)} sampled requests "
        f"repeat per seed (sent again one by one); K1 {k1} = {n_l} x {tiling} cold prefills "
        f"whose bucket tiles "
        f"(buckets {sorted(buckets)}), no paged kernel; decode {tick_ms / engine.decode_chunk:.2f} ms a step "
        f"(host clock); /health {sorted(health[1])}")

    # (2) register_prefix on the contiguous cache
    prefix = [tok.bos_id] + tok.encode(requests[0]["prompt"][:600])
    shared = [([tok.bos_id] + tok.encode(p["prompt"]), {"max_new_tokens": p["max_tokens"],
                                                         "temperature": 0.0})
              for p in requests[:4]]
    require(all(ids[:len(prefix)] == prefix for ids, _ in shared), "no shared prefix")
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.register_prefix(prefix)
    torch.cuda.synchronize()
    reg_ms = (time.perf_counter() - t) * 1e3
    row, last, n_prefix = engine._prefixes[tuple(prefix)]
    row_bytes = sum(x.numel() * x.element_size() for x in row.values())
    want_first = int(last.argmax())
    del row, last
    hit0 = engine.stats()["prefix_cache"]["hit_tokens"]
    got, launches = _run_counted(engine, flash, paged, shared)
    hit = engine.stats()["prefix_cache"]["hit_tokens"] - hit0
    require(hit == 4 * n_prefix and launches["flash_fwd"] == 0
            and _paged_silent(paged, launches), (hit, launches))
    same = sum(_resume_tie_check(gen, cfg, ids, r.tokens,
                                 threaded.outputs[(tuple(ids), kw["max_new_tokens"])][0],
                                 "contiguous-prefix", f"shared request {i}",
                                 ("cold", "prefix hit")) is None
               for i, ((ids, kw), r) in enumerate(zip(shared, got)))
    whole, launches = _run_counted(engine, flash, paged,
                                   [(prefix, {"max_new_tokens": 1, "temperature": 0.0})])
    require(whole[0].tokens == [want_first] and launches["flash_fwd"] == 0,
            (whole[0].tokens, want_first, launches))
    ttft = {"prefix hit": [], "cold": []}
    probes = [("prefix hit", prefix + tok.encode(" " + _text(150, 300))),
              ("cold", [tok.bos_id] + tok.encode(_text(151, 901)))]
    for label, ids in probes + probes[::-1]:  # in turns, there and back
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, launches = _run_counted(engine, flash, paged, [(ids, {"max_new_tokens": 1,
                                                                  "temperature": 0.0})])
        ttft[label].append((time.perf_counter() - t) * 1e3)
        add(launches)
        require(_paged_silent(paged, launches) and (launches["flash_fwd"] == 0)
                == (label == "prefix hit"), (label, launches))
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    engine.clear_prefixes()
    gc.collect()
    freed = m0 - torch.cuda.memory_allocated()
    require(engine._prefixes == {} and freed >= row_bytes, (freed, row_bytes))
    log(f"[contiguous-prefix] register_prefix of {n_prefix} tokens (bucket "
        f"{_next_pow2(n_prefix)}) {reg_ms:.1f} ms (host clock, synchronised); the 4 "
        f"shared-prefix requests hit {hit} tokens = 4 x {n_prefix}, no K1, {same} of 4 "
        f"the cold run's tokens; the prompt equal to the prefix took the stored logits' "
        f"token {want_first}; time to the first harvested token of a 902-token prompt "
        f"(one 16-step tick included; in turns, there and back): prefix hit "
        f"{ttft['prefix hit'][0]:.1f} / {ttft['prefix hit'][1]:.1f} ms, cold "
        f"{ttft['cold'][0]:.1f} / {ttft['cold'][1]:.1f} ms; clear_prefixes freed {freed / 2**20:.1f} MiB (the row "
        f"{row_bytes / 2**20:.1f} MiB; {SMI})")

    # (3) register_prefix on pages: a warm
    peng = _paged_engine(gen.params, cfg, tok)
    flash.reset_launches()
    paged.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    peng.register_prefix(prefix)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    k1 = flash.launches
    pst = peng.stats()
    require(k1 == n_l and peng.prefill_tokens_total == 512
            and pst["pages_cached_evictable"] == 2 and "prefill_tok_per_s" in pst,
            (k1, peng.prefill_tokens_total, pst))
    total["flash_fwd"] += k1
    got, launches = _run_counted(peng, flash, paged, shared)
    add(launches)
    pst = peng.stats()
    require(pst["prefix_cache"]["hit_tokens"] == 4 * 512 and launches["flash_fwd"] == 0
            and launches["launches_tail"] == n_l * pst["decode_steps"],
            (pst["prefix_cache"], launches))
    same_p = sum(_resume_tie_check(gen, cfg, ids, r.tokens,
                                   bf16["outputs"][(tuple(ids), kw["max_new_tokens"])][0],
                                   "paged-warm", f"shared request {i}",
                                   ("path 2", "warmed")) is None
                 for i, ((ids, kw), r) in enumerate(zip(shared, got)))
    small = _paged_engine(gen.params, cfg, tok, n_pages=2)
    free0 = small.stats()["pages_free"]
    small.register_prefix(prefix)
    sst = small.stats()
    require(sst["pages_free"] == free0 == 1 and "prefill_tok_per_s" not in sst, sst)
    del small
    log(f"[paged-warm] register_prefix on path 2's engine: 2 full pages (512 tokens) "
        f"prefilled and published in {warm_ms:.1f} ms (host clock, synchronised; K1 {k1} = "
        f"{n_l} x 1), prefill_tok_per_s {pst['prefill_tok_per_s']}; the 4 shared-prefix "
        f"requests then hit {pst['prefix_cache']['hit_tokens']} tokens at their first "
        f"admission, no K1, {same_p} of 4 path 2's tokens; a warm on a one-page pool left "
        f"pages_free at {sst['pages_free']}")

    # (4) ms per decode step, contiguous against paged, in turns
    prompts = [[tok.bos_id] + tok.encode(_text(160 + i, 200)) for i in range(8)]
    reqs = [(p, {"max_new_tokens": 48, "temperature": 0.0}) for p in prompts]
    legs = [("contiguous", engine), ("paged", peng)]
    step_ms = {label: [] for label, _ in legs}
    outs = {}
    for label, eng in legs + legs[::-1]:
        s0, n0 = eng.decode_seconds, eng.decode_steps
        got, launches = _run_counted(eng, flash, paged, reqs)
        add(launches)
        if label == "contiguous":
            require(_paged_silent(paged, launches), launches)
        step_ms[label].append((eng.decode_seconds - s0) / (eng.decode_steps - n0) * 1e3)
        outs.setdefault(label, [r.tokens for r in got])
    same_t = sum(_resume_tie_check(gen, cfg, p, a, b, "contiguous-timing", f"request {i}",
                                   ("paged", "contiguous")) is None for i, (p, a, b) in enumerate(zip(prompts, outs["contiguous"],
                                                          outs["paged"])))
    log(f"[contiguous-timing] a decode step of 8 slots at full width, 48 tokens each: "
        + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} ms" for k, v in step_ms.items())
        + f" (host clock, in turns, there and back); {same_t} of 8 the same tokens ({SMI})")
    del engine, peng, threaded, server
    gc.collect()
    torch.cuda.empty_cache()

    # (5) depth 2: the other tick kinds on the contiguous cache
    cfg2, params2 = _depth2_model(gen)
    gen2 = Generator(params2, cfg2, tok, device="cuda")
    span = [[tok.bos_id] + tok.encode(r["prompt"]) for r in _span_requests()]
    reqs2 = [(p, {"max_new_tokens": 48, "temperature": 0.0}) for p in span]

    def engine2(c=cfg2, w=params2, **kw):
        return ContinuousEngine(w, c, tok, n_slots=8, decode_chunk=16, max_cache_len=2048,
                                device="cuda", **kw)

    def check(tag, g, got, ref, c=cfg2, reqs_=reqs2, labels=None):
        return sum(_resume_tie_check(g, c, p, a.tokens, b.tokens, f"contiguous-{tag}",
                                     f"request {i}", labels or ("plain", tag)) is None
                   for i, ((p, _), a, b) in enumerate(zip(reqs_, got, ref)))

    plain, launches = _run_counted(engine2(), flash, paged, reqs2)
    require(_paged_silent(paged, launches), launches)
    add(launches)
    notes = []
    for tag, kw in (("chunked", dict(prefill_chunk=384, token_budget=640)),
                    ("lookup", dict(speculative=True, spec_threshold=0.0))):
        eng = engine2(**kw)
        got, launches = _run_counted(eng, flash, paged, reqs2)
        est = eng.stats()
        require(_paged_silent(paged, launches)
                and launches["flash_fwd"] == 2 * est["prefills_cold"]
                and (tag != "chunked" or (est["prefills_cold"] == 0
                                          and est["max_tick_prefill_tokens"] <= 640)),
                (tag, launches, est["prefills_cold"]))
        add(launches)
        extra = (f", {est['speculative']['tokens_per_row_forward']:.3f} tokens per row "
                 f"forward" if tag == "lookup" else
                 f", largest tick prefill {est['max_tick_prefill_tokens']} tokens, no K1")
        notes.append(f"{tag} {check(tag, gen2, got, plain)} of 4{extra}")
    record = G.compile_json_schema(GUIDED_SPECS["record"][1], tok)
    greqs = [(p, {**kw, "grammar": record if i == 0 else None})
             for i, (p, kw) in enumerate(reqs2)]
    got, launches = _run_counted(engine2(fsm_capacity=GUIDED_CAPACITY), flash, paged, greqs)
    require(_paged_silent(paged, launches), launches)
    add(launches)
    text = tok.decode(got[0].tokens)
    at_eos = len(got[0].tokens) < 48
    require(_walk_ok(record, text, at_eos), text)
    if at_eos:
        json.loads(text)
    notes.append(f"guided JSON {text!r} beside "
                 f"{check('guided', gen2, got[1:], plain[1:], reqs_=reqs2[1:])} of 3 "
                 f"unconstrained the plain tokens")
    got, launches = _run_counted(engine2(logprobs_k=5), flash, paged,
                                 [(p, {**kw, "logprobs": 5}) for p, kw in reqs2])
    require(_paged_silent(paged, launches), launches)
    add(launches)
    same = check("logprobs", gen2, got, plain)
    errs = []
    for (p, _), r in zip(reqs2, got):
        ref_out, ref_lp = gen2.generate_tokens_with_logprobs(
            [p], GenerateConfig(max_new_tokens=48, logprobs=5))
        n = next((j for j, (a, b) in enumerate(zip(r.tokens, ref_out[0])) if a != b),
                 min(len(r.tokens), len(ref_out[0])))
        require(n > 0 and [ids[0] for ids in r.lp_top_ids] == r.tokens, (n, r.tokens))
        errs.append(max(abs(a - b) for a, b in zip(r.lp_token[:n],
                                                   ref_lp[0]["token_logprobs"][:n])))
    require(max(errs) < LP_BF16_TOL, errs)
    notes.append(f"logprobs {same} of 4, chosen logprobs within {max(errs):.5f} of the "
                 f"lock-step Generator's (LP_BF16_TOL {LP_BF16_TOL})")
    cfg8, params8 = _depth2_model(gen, kv_int8=True)
    c8, launches = _run_counted(engine2(cfg8, params8), flash, paged, reqs2)
    require(_paged_silent(paged, launches), launches)
    add(launches)
    peng8 = engine2(cfg8, params8, cache_mode="paged", page_size=256)
    p8, launches = _run_counted(peng8, flash, paged, reqs2)
    require(launches["launches_tail_int8"] == 2 * peng8.stats()["decode_steps"], launches)
    add(launches)
    gen8 = Generator(params8, cfg8, tok, device="cuda")
    notes.append(f"int8 KV {check('int8', gen8, c8, p8, c=cfg8, labels=('paged', 'contiguous'))}"
                 f" of 4 the paged int8 engine's")
    log(f"[contiguous-depth2] against the plain contiguous ticks' greedy tokens: "
        + "; ".join(notes) + "; no paged kernel on any contiguous leg")
    del gen2, gen8, peng8
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[contiguous] path 23 launches {total} in {time.perf_counter() - t_path:.1f}s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return total


# Path 24: the requests that carry a client's traceparent (the even ones)
# and an X-Request-Id (every third); the others get a generated req- id.
TRACED_EVERY, ID_EVERY = 2, 3


def _http_full(method: str, url: str, payload: dict | None = None,
               headers: dict | None = None):
    """(status, lower-cased response headers, body): JSON parsed when the
    response is JSON, else text."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    hdrs = {k.lower(): v for k, v in hdrs.items()}
    if hdrs.get("content-type", "").startswith("application/json"):
        return status, hdrs, json.loads(raw or b"{}")
    return status, hdrs, raw.decode()


def _exposition_ok(body: str) -> dict:
    """The Prometheus text contract of ``tests/test_server_api.py``'s live
    check: every sample's family declares a TYPE, histogram buckets are
    cumulative and end in +Inf at the family's count, counters end in
    ``_total``. Returns the samples by name."""
    types, samples = {}, {}
    for line in body.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    for name in samples:
        base = name.split("{", 1)[0]
        fam = next((base[: -len(x)] for x in ("_bucket", "_sum", "_count")
                    if base.endswith(x) and types.get(base[: -len(x)]) == "histogram"), base)
        require(fam in types, f"sample {name} has no TYPE")
    for fam, kind in types.items():
        if kind == "histogram":
            counts = [v for n, v in samples.items() if n.startswith(fam + "_bucket")]
            require(counts == sorted(counts) and counts[-1] == samples[fam + "_count"]
                    and f'{fam}_bucket{{le="+Inf"}}' in samples, fam)
        elif kind == "counter":
            require(fam.endswith("_total") and fam in samples, fam)
    return samples


# The engine's telemetry calls, timed on the host clock by ``_engine_leg``
# (``_record_prefill`` with its token-budget debit, which is not telemetry).
TELEMETRY_CALLS = ("_note_admitted", "_note_prefix_cache", "_record_prefill", "_note_harvest",
                   "_attribute_interference", "_close_spans")


class _TimedRing:
    """A flight ring whose ``record`` adds its host seconds to ``acc[0]``."""

    def __init__(self, ring, acc):
        self._ring, self._acc = ring, acc

    def record(self, **row):
        t = time.perf_counter()
        self._ring.record(**row)
        self._acc[0] += time.perf_counter() - t


def _time_telemetry(engine) -> list:
    """Wrap ``engine``'s telemetry calls (``TELEMETRY_CALLS``, the tracer's
    instants, the tick ring's rows) on the instance so that each adds its
    host seconds to the returned one-element list."""
    acc = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[0] += time.perf_counter() - t
        return call

    for name in TELEMETRY_CALLS:
        setattr(engine, name, timed(getattr(engine, name)))
    if engine.tracer.armed:
        engine.tracer.instant = timed(engine.tracer.instant)
    ring, rings = engine.flight.ring, {}
    engine.flight.ring = lambda name, capacity=None: rings.setdefault(
        name, _TimedRing(ring(name, capacity), acc))
    return acc


def _engine_leg(gen, requests, tracer, tag: str):
    """Path 2's paged engine, driven by ``step()`` in this thread over the
    12 requests submitted at once in their order, under
    ``torch.cuda.set_sync_debug_mode("warn")``: (tokens by request,
    synchronising-op warnings by the Python line that raised them, stats,
    seconds between two synchronisations, K1 and K3 launches, host seconds
    in the engine's telemetry calls)."""
    import collections
    import warnings

    import torch

    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.ops import flash_attention as flash
    from ditl_tpu_torch.ops import paged_attention as paged

    tok = gen.tokenizer
    engine = ContinuousEngine(gen.params, gen.cfg, tok, n_slots=8, decode_chunk=16,
                              max_cache_len=2048, cache_mode="paged", page_size=256,
                              device="cuda", tracer=tracer)
    telemetry_s = _time_telemetry(engine)
    rids = [engine.submit([tok.bos_id] + tok.encode(p["prompt"]),
                          max_new_tokens=p["max_tokens"],
                          temperature=p.get("temperature", 0.0), top_p=p.get("top_p", 1.0),
                          seed=p.get("seed")) for p in requests]
    flash.reset_launches()
    paged.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            while engine.pending:
                engine.step()
                done.update({r.req_id: r.tokens for r in engine.take_finished()})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail}
    syncs = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    st = engine.stats()
    n_sync = sum(syncs.values())
    log(f"[{tag}] {len(rids)} requests by step() in {wall:.3f}s: {st['ticks']} ticks, "
        f"{st['decode_steps']} decode steps, {n_sync} synchronising-op warnings "
        f"({n_sync / st['ticks']:.2f} a tick), K1 {launches['flash_fwd']}, "
        f"K3 {launches['paged_tail']}; the telemetry calls "
        f"{telemetry_s[0] * 1e3 / st['ticks']:.3f} ms a tick (host clock)")
    del engine
    return [done[r] for r in rids], syncs, st, wall, launches, telemetry_s[0]


def phase_serve_telemetry(gen, flash, paged, bf16: dict) -> dict:
    """Main path 24, serving telemetry, over path 1's llama3-8b weights at
    full width and depth (bf16, 8 slots, context 2048) and path 2's 12
    requests. (1) HTTP: the engine as ``infer/server.py --engine continuous
    --trace-dir DIR`` builds it (the contiguous cache), half the requests
    with a client ``traceparent`` and every third with an ``X-Request-Id``:
    greedy tokens against path 23's contiguous run (path 2's paged one when
    path 23 did not run) by the ``RESUME_TIE_TOL`` rule; the ids echoed or
    generated (``req-``); ``/metrics`` keeps the Prometheus text contract
    and counts 12 requests, admissions and completions, the responses'
    completion tokens, 12 TTFT, queue-wait and end-to-end observations, and
    prefix hit plus miss tokens equal to the prompts'; ``/slo`` grades its
    three objectives over them; the journal holds one ``server.request`` a
    request, under it an ``engine.request`` with an ``engine.queue``, its
    ``engine.prefill``s (their tokens the uncached prompt's) and
    ``engine.decode``s (their tokens the completion's), on the client's
    trace where it sent one, and an ``engine.tick`` instant a tick; the
    flight ring's rows are min(ticks, capacity), the last counting 12
    completions; K1 on the cold prefills, no paged kernel. (2) Path 2's
    paged engine driven by ``step()`` in this thread on the same requests,
    unarmed then with a journal-backed tracer: the same tokens (greedy and
    sampled), the same count of synchronising-op warnings a tick under
    ``set_sync_debug_mode("warn")``, K1 and K3 in both. Logs ms per decode
    step armed against unarmed, TTFT/TPOT/queue-wait quantiles from the
    histograms, per-request span medians from the Chrome trace export and
    the largest interference. Returns the path's launch counts."""
    import gc
    import shutil
    import tempfile

    import torch

    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.telemetry import TICK_RING, Tracer
    from ditl_tpu_torch.telemetry.journal import EventJournal
    from ditl_tpu_torch.telemetry.trace_export import load_trace_records, to_chrome_trace

    t_path = time.perf_counter()
    cfg, tok = gen.cfg, gen.tokenizer
    n_l = cfg.num_layers
    trace_dir = tempfile.mkdtemp(prefix="ditl-trace-")
    requests, _ = _continuous_requests()
    rng = random.Random(24)
    traces = {i: (f"{rng.getrandbits(128):032x}", f"{rng.getrandbits(64):016x}")
              for i in range(0, len(requests), TRACED_EVERY)}
    headers = [{**({"traceparent": f"00-{traces[i][0]}-{traces[i][1]}-01"} if i in traces
                   else {}),
                **({"X-Request-Id": f"smoke-{i}"} if i % ID_EVERY == 0 else {})}
               for i in range(len(requests))]
    try:
        # (1) the server as --engine continuous --trace-dir DIR builds it
        args = server_mod._parser().parse_args(
            ["--engine", "continuous", "--max-cache-len", "2048", "--trace-dir", trace_dir])
        telemetry, tracer = server_mod.telemetry_from_args(args)
        require(args.cache_mode == "contiguous" and tracer is not None and tracer.armed, args)
        engine = ContinuousEngine(gen.params, cfg, tok, n_slots=args.slots,
                                  max_cache_len=args.max_cache_len, cache_mode=args.cache_mode,
                                  device="cuda", tracer=tracer)
        threaded = _recording_engine(engine)
        server = server_mod.make_server(gen, threaded_engine=threaded, host="127.0.0.1",
                                        port=0, model_name=cfg.name, telemetry=telemetry)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        results, echoed = {}, {}

        def one(i):
            t = time.perf_counter()
            status, hdrs, body = _http_full("POST", url + "/v1/completions", requests[i],
                                            headers[i])
            results[i], echoed[i] = (status, body, time.perf_counter() - t), hdrs

        try:
            flash.reset_launches()
            paged.reset_launches()
            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
            k1 = flash.launches
            others = sum(getattr(paged, c) for c in paged._COUNTERS.values())  # read right after
            m_status, m_hdrs, exposition = _http_full("GET", url + "/metrics")
            slo_status, _, slo = _http_full("GET", url + "/slo")
            h_status, _, health = _http_full("GET", url + "/health")
        finally:
            server.close(drain=True)  # every server.request span is written by now
            thread.join(timeout=30)
            tracer.journal.close()
        require(not thread.is_alive() and not threaded._thread.is_alive(), "server did not stop")
        st = engine.stats()
        want = bf16.get("contiguous_outputs")
        versus = "path 23's contiguous run"
        if want is None:
            want, versus = bf16["outputs"], "path 2's paged run (path 23 did not run)"
        same, n_greedy, completion, prompt_tokens = 0, 0, [], []
        for i, payload in enumerate(requests):
            require(i in results, f"request {i} did not answer")
            status, body, _ = results[i]
            require(status == 200, (i, status, body))
            completion.append(body["usage"]["completion_tokens"])
            prompt_tokens.append(body["usage"]["prompt_tokens"])
            rid = echoed[i].get("x-request-id", "")
            require(rid == f"smoke-{i}" if i % ID_EVERY == 0 else rid.startswith("req-"),
                    (i, rid))
            if payload.get("temperature"):
                continue
            ids = [tok.bos_id] + tok.encode(payload["prompt"])
            key = (tuple(ids), payload["max_tokens"])
            n_greedy += 1
            same += _resume_tie_check(gen, cfg, ids, threaded.outputs[key][0], want[key][0],
                                      "telemetry", f"request {i} against {versus}",
                                      ("reference", "traced")) is None
        require(m_status == slo_status == h_status == 200
                and m_hdrs["content-type"].startswith("text/plain"), (m_status, slo_status))
        samples = _exposition_ok(exposition)
        n = len(requests)
        for name in ("ditl_serving_requests_total", "ditl_serving_requests_admitted_total",
                     "ditl_serving_requests_completed_total",
                     "ditl_serving_request_ttft_seconds_count",
                     "ditl_serving_request_queue_wait_seconds_count",
                     "ditl_serving_request_e2e_seconds_count"):
            require(samples[name] == n, (name, samples[name]))
        require(samples["ditl_serving_tokens_generated_total"] == sum(completion),
                (samples["ditl_serving_tokens_generated_total"], completion))
        hit = samples["ditl_serving_prefix_cache_hit_tokens_total"]
        miss = samples["ditl_serving_prefix_cache_miss_tokens_total"]
        require(hit + miss == sum(prompt_tokens) and hit == 0, (hit, miss, prompt_tokens))
        require(set(slo["objectives"]) == {"ttft", "tpot", "availability"}
                and slo["objectives"]["ttft"]["total"] == n
                and slo["objectives"]["availability"]["total"] == n
                and slo["objectives"]["tpot"]["total"] > 0, slo)
        require(health["ttft_p95_s"] > 0 and health["tpot_p95_s"] > 0, health)
        tiling = st["prefills_cold"]
        require(others == 0 and k1 == n_l * tiling > 0, (k1, others, tiling))

        # the journal: one span tree a request, the ticks' instants
        records = load_trace_records(trace_dir)
        spans = [r for r in records if r.get("event") == "trace.span"]
        kids: dict[str, list] = {}
        for r in spans:
            kids.setdefault(r["parent"], []).append(r)
        roots = {r["request_id"]: r for r in spans if r["name"] == "server.request"}
        require(len(roots) == n == sum(r["name"] == "engine.request" for r in spans),
                (len(roots), [r["name"] for r in spans][:40]))
        for i in range(n):
            root = roots[echoed[i]["x-request-id"]]
            if i in traces:
                require(root["trace"] == traces[i][0] and root["parent"] == traces[i][1], root)
            (ereq,) = [r for r in kids.get(root["span"], []) if r["name"] == "engine.request"]
            under = kids.get(ereq["span"], [])
            by = {name: [r for r in under if r["name"] == name]
                  for name in ("engine.queue", "engine.prefill", "engine.decode")}
            require(len(by["engine.queue"]) == 1 and by["engine.prefill"]
                    and by["engine.decode"] and all(r["trace"] == root["trace"] for r in under),
                    (i, sorted(r["name"] for r in under)))
            require(sum(r["tokens"] for r in by["engine.decode"]) == completion[i]
                    == ereq["tokens"], (i, completion[i]))
            require(sum(r["tokens"] for r in by["engine.prefill"]) == prompt_tokens[i]
                    == ereq["prompt_tokens"], (i, prompt_tokens[i]))
        ticks = [r for r in records if r.get("event") == "trace.instant"
                 and r.get("name") == "engine.tick"]
        require(len(ticks) == st["ticks"] > 0, (len(ticks), st["ticks"]))
        ring = engine.flight.ring(TICK_RING)
        rows = ring.dump()
        require(len(rows) == min(st["ticks"], ring.capacity) and rows[-1]["completed"] == n,
                (len(rows), st["ticks"], rows[-1]))
        # per request (its engine id), each kind's summed span time, in ms
        xs = [e for e in to_chrome_trace(records)["traceEvents"] if e.get("ph") == "X"]
        require(len(xs) == len(spans), (len(xs), len(spans)))
        per_req: dict = {}
        for e in xs:
            if e["name"] in ("engine.queue", "engine.prefill", "engine.decode"):
                key = (e["args"]["req"], e["name"])
                per_req[key] = per_req.get(key, 0.0) + e["dur"] / 1e3
        med = {name: statistics.median(v for (_, k), v in per_req.items() if k == name)
               for name in ("engine.queue", "engine.prefill", "engine.decode")}
        require(all(sum(k == name for _, k in per_req) == n for name in med), per_req)
        m = engine.metrics
        q = {"ttft": (m.ttft.quantile(0.5), m.ttft.quantile(0.95)),
             "tpot": (m.decode_token.quantile(0.5), m.decode_token.quantile(0.95)),
             "queue": m.queue_wait.quantile(0.5)}
        log(f"[telemetry] {n} requests over HTTP in {wall:.3f}s wall, {sum(completion)} tokens; "
            f"greedy tokens against {versus}: {same} of {n_greedy} identical (the rest by "
            f"RESUME_TIE_TOL); X-Request-Id echoed on {len(range(0, n, ID_EVERY))}, "
            f"generated on the rest; {len(traces)} traceparents continued; K1 {k1} = {n_l} x "
            f"{tiling} cold prefills, no paged kernel; /metrics: {len(exposition.splitlines())} "
            f"lines, requests/admitted/completed {n}, tokens {sum(completion)}, prefix miss "
            f"tokens {int(miss)}; /slo ttft {slo['objectives']['ttft']['total']} / tpot "
            f"{slo['objectives']['tpot']['total']} / availability "
            f"{slo['objectives']['availability']['total']} observations; journal "
            f"{len(spans)} spans and {len(ticks)} tick instants over {st['ticks']} ticks; "
            f"flight ring {len(rows)} rows")
        log(f"[telemetry] from the histograms (bucket-interpolated): TTFT p50 "
            f"{q['ttft'][0] * 1e3:.1f} ms, p95 {q['ttft'][1] * 1e3:.1f} ms; TPOT p50 "
            f"{q['tpot'][0] * 1e3:.2f} ms, p95 {q['tpot'][1] * 1e3:.2f} ms; queue wait p50 "
            f"{q['queue'] * 1e3:.1f} ms; from the Chrome trace, per-request medians: queue "
            f"{med['engine.queue']:.1f} ms, prefill {med['engine.prefill']:.1f} ms (host "
            f"dispatch wall), decode {med['engine.decode']:.1f} ms; interference_max_s "
            f"{st['interference_max_s']:.4f} ({SMI})")
        interference = [st["interference_max_s"]]
        total = {"flash_fwd": k1, "paged_tail": 0}
        del engine, threaded, server
        gc.collect()
        torch.cuda.empty_cache()

        # (2) path 2's paged engine by step(): a warm-up leg (one-time
        # initialisations synchronise once), then unarmed and armed in turns
        legs = (("warm-up", False), ("unarmed", False), ("armed", True), ("armed", True),
                ("unarmed", False))
        outs, syncs, stats, walls, tele = [], [], [], [], []
        for i, (leg, armed) in enumerate(legs):
            tracer = (Tracer(EventJournal(os.path.join(trace_dir, f"events-engine-{i}.jsonl"),
                                          source="engine")) if armed else None)
            tag = "telemetry-engine-" + leg
            o, s_, st2, w, launches, t_s = _engine_leg(gen, requests, tracer, tag)
            if tracer is not None:
                tracer.journal.close()
            require(launches["flash_fwd"] >= n_l and launches["paged_tail"]
                    == n_l * st2["decode_steps"] > 0, (tag, launches))
            for k in total:
                total[k] += launches[k]
            outs.append(o)
            syncs.append(s_)
            stats.append(st2)
            walls.append(w)
            tele.append(t_s)
            interference.append(st2["interference_max_s"])
            gc.collect()
            torch.cuda.empty_cache()
        require(all(o == outs[0] for o in outs), "telemetry changed a token")
        require(len({(s_["ticks"], s_["decode_steps"]) for s_ in stats}) == 1, stats)
        if any(c != syncs[1] for c in syncs[1:]):
            log(f"[telemetry] synchronising ops by site, each leg against the first "
                f"unarmed: {[(dict(c - syncs[1]), dict(syncs[1] - c)) for c in syncs]}")
        n_sync = [sum(c.values()) for c in syncs]
        require(len(set(n_sync[1:])) == 1, ("synchronising ops a run, by leg", n_sync))
        ticks = stats[0]["ticks"]
        step_ms = [1e3 * s_["decode_seconds"] / s_["decode_steps"] for s_ in stats]
        wall_ms = [1e3 * w / s_["decode_steps"] for w, s_ in zip(walls, stats)]
        tick_ms = [1e3 * t_s / ticks for t_s in tele]

        def pair(xs, armed):
            return " / ".join(f"{x:.3f}" for x, (_, a) in zip(xs[1:], legs[1:]) if a == armed)

        log(f"[telemetry] paged engine by step(), unarmed against armed in turns (unarmed, "
            f"armed, armed, unarmed after a warm-up): the same tokens ({sum(map(len, outs[0]))}"
            f" over {len(outs[0])} requests, greedy and sampled), the same {ticks} ticks and "
            f"{n_sync[1]} synchronising-op warnings ({n_sync[1] / ticks:.2f} a tick) in every "
            f"leg (the warm-up {n_sync[0]}); ms per decode step unarmed {pair(step_ms, False)}, "
            f"armed {pair(step_ms, True)} (warm-up {step_ms[0]:.3f}; the ticks' host clock, "
            f"each tick ending in its device-to-host copy), over the whole run unarmed "
            f"{pair(wall_ms, False)}, armed {pair(wall_ms, True)} (synchronised at its ends, "
            f"prefills included); the telemetry calls' own host time a tick unarmed "
            f"{pair(tick_ms, False)} ms, armed {pair(tick_ms, True)} ms; largest "
            f"interference_max_s {max(interference):.4f} ({SMI})")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    log(f"[telemetry] path 24 launches {total} in {time.perf_counter() - t_path:.1f}s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return total


# Speculation at depth 2 over other pools: (server flags, the compute dtype,
# int8 pools, the log tag, what the pools hold). The verify kernel's name in
# the kernels line is "paged_verify" + ("_int8" with int8 pools) + the
# dtype's suffix, the single-query kernel's "paged_tail" + the same.
SPEC_DEPTH2 = {
    "int8": (["--kv-quant", "int8"], "bfloat16", True, "spec-int8", "int8 pools"),
    "f32": (["--override", "dtype=float32"], "float32", False, "f32-spec", "f32 pools"),
    "f32-int8": (["--override", "dtype=float32", "--kv-quant", "int8"], "float32", True,
                 "f32-int8-spec", "int8 pools under f32"),
    "f16": (["--override", "dtype=float16"], "float16", False, "f16-spec", "float16 pools"),
    "f16-int8": (["--override", "dtype=float16", "--kv-quant", "int8"], "float16", True,
                 "f16-int8-spec", "int8 pools under float16"),
}


def _serve_greedy(server, recording, flash, paged, requests, counter: str):
    """``requests`` over HTTP to ``server``, whose continuous engine is the
    recording ``ThreadedEngine`` ``recording``: the outputs by (prompt ids,
    max tokens), the paged launches of ``counter`` and of every other paged
    kernel, read right after, the engine's stats and the wall seconds. The
    server is closed after."""
    engine = recording._engine
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        flash.reset_launches()
        paged.reset_launches()
        results, wall = _send_continuous(url, requests, engine)
        n = getattr(paged, counter)
        other = sum(getattr(paged, c) for c in paged._COUNTERS.values()) - n
        st = engine.stats()
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(all(results[i][0] == 200 for i in range(len(requests))), results)
    return recording.outputs, n, other, st, wall


def phase_spec_depth2(flash, paged, kind: str) -> dict:
    """Speculation over other pools (``SPEC_DEPTH2``: ``--kv-quant int8``,
    ``--override dtype=float32`` or ``dtype=float16``, or both),
    ``--speculative on --engine continuous --cache-mode paged`` built by
    ``create_server`` at full width and depth 2 (a depth cut: the engine's
    pools and the verify kernel are per layer), the continuous traffic's
    greedy requests plus the span prompts over HTTP: the verify kernel of
    those pools and that dtype on every round of both layers, no other paged
    kernel; then the same requests through a plain (not speculative) engine
    of the same configuration over the same weights, served the same way:
    the single-query K3 of those pools on every decode step of both layers,
    no other paged kernel; the speculative greedy tokens against the plain
    engine's by the divergence rule. Returns the launch counts."""
    import torch

    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.models.llama import torch_dtype

    flags, dtype, int8, tag, pools = SPEC_DEPTH2[kind]
    name = ("_int8" if int8 else "") + DTYPE_SFX[dtype][0]
    verify, single = "paged_verify" + name, "paged_tail" + name
    server = server_mod.create_server([
        "--preset", "llama3-8b", "--override", "attention_impl=flash", "--override",
        "num_layers=2", "--device", "cuda", "--host", "127.0.0.1", "--port", "0",
        "--seed", "0", *flags, "--speculative", "on", "--engine",
        "continuous", "--cache-mode", "paged", "--slots", "8", "--page-size", "256",
        "--max-cache-len", "2048",
    ])
    gen = server.RequestHandlerClass.generator
    engine = server.engine._engine
    cfg, tok = gen.cfg, gen.tokenizer
    require((cfg.num_layers, cfg.hidden_size, engine.speculative, cfg.dtype)
            == (2, 4096, True, dtype), cfg)
    require(engine.cache["kp"].dtype == (torch.int8 if int8 else torch_dtype(dtype)),
            engine.cache["kp"].dtype)
    recording = _recording_engine(engine)
    server.engine.close()  # the server's own engine thread; the recording one takes over
    server.RequestHandlerClass.threaded_engine = recording
    server.engine = recording
    requests = [p for p in _continuous_requests()[0] + _span_requests()
                if not p.get("temperature")]
    outputs, n, other, st, wall = _serve_greedy(server, recording, flash, paged, requests,
                                                _counter(verify))
    st = st["speculative"]
    require(n == cfg.num_layers * st["verify_rounds"] > 0 and other == 0, (n, other, st))
    log(f"[{tag}] depth 2, {pools}: {verify} launches "
        f"{n} = {cfg.num_layers} layers x {st['verify_rounds']} "
        f"verify rounds; {st['tokens_per_row_forward']:.3f} tokens per verify forward per "
        f"row; {len(requests)} greedy requests in {wall:.3f}s ({SMI})")
    plain = _recording_engine(ContinuousEngine(
        gen.params, cfg, tok, n_slots=8, decode_chunk=16, max_cache_len=2048,
        cache_mode="paged", page_size=256, device="cuda"))
    plain_server = server_mod.make_server(gen, threaded_engine=plain, host="127.0.0.1",
                                          port=0, model_name=cfg.name)
    plain_out, n_single, other, pst, _ = _serve_greedy(plain_server, plain, flash, paged,
                                                      requests, _counter(single))
    require(n_single == cfg.num_layers * pst["decode_steps"] > 0 and other == 0,
            (n_single, other, pst["decode_steps"]))
    log(f"[{tag}] the same requests on the plain engine: {single} launches {n_single} = "
        f"{cfg.num_layers} layers x {pst['decode_steps']} decode steps, no other paged kernel")
    pairs = [(list(key[0]), spec_out, plain_out[key][0]) for key in sorted(plain_out)
             for spec_out in outputs[key]]  # one pair a greedy request
    _check_against(gen, cfg, pairs, tag)
    return {verify: n, single: n_single}


def _int8_pools(kp, vp):
    """bf16 pools -> int8 pools and their (P, K, 1, ps) f32 scales, by the
    engine's own quantization (``infer/cache._quantize``: absmax per
    position over D)."""
    from ditl_tpu_torch.infer.cache import _quantize

    (kq, ks), (vq, vs) = _quantize(kp), _quantize(vp)
    return kq, vq, ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()


def phase_paged_int8_kernels(paged) -> dict:
    """K3 over int8 pools (``ditl_paged_tail_i8``) against the plain
    version's int8 branch and the split twin, at ``O_TOL``: the decode
    tick's case (a dead slot, starts == lengths), a tail-only slot at
    head_dim 64, and the split-edge cases at head_dim 128 and 64; a second
    call must give the same bits. Returns the max abs error."""
    import torch

    main = PAGED_MAIN
    starts, lengths = _paged_main_case()
    cases = [  # (b, h, kv, d, ps, tail_len, lengths, starts)
        (main["b"], main["h"], main["kv"], main["d"], main["ps"], main["tail_len"],
         lengths, starts),
        (4, 8, 4, 64, 16, 8, [0, 5, 38, 50], [0, 0, 32, 45]),  # dead, tail only
        (4, 32, 8, 128, 16, 16, [257, 256, 513, 140], [257, 250, 500, 128]),
        (3, 16, 2, 64, 48, 8, [300, 1, 40], [297, 0, 33]),
    ]
    worst = 0.0
    paged.reset_launches()
    for i, (b, h, kv, d, ps, tl, lens, sts) in enumerate(cases):
        q, kp, vp, table, ln, st, tk, tv = _paged_inputs(b, h, kv, d, ps, tl, lens, sts,
                                                         seed=500 + i, n_pool=128)
        kq, vq, ks, vs = _int8_pools(kp, vp)
        kw = dict(tail_k=tk, tail_v=tv, starts=st, k_scale=ks, v_scale=vs)
        o = paged.paged_attention(q, kq, vq, table, ln, **kw)
        o2 = paged.paged_attention(q, kq, vq, table, ln, **kw)
        r = paged.paged_attention_plain(q, kq, vq, table, ln, **kw)
        sp = paged.paged_attention_split_plain(q, kq, vq, table, ln, **kw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(o.float()).all()), f"paged_tail_int8 case {i}: non-finite")
        torch.testing.assert_close(o.float(), r.float(), atol=O_TOL, rtol=O_TOL)
        torch.testing.assert_close(o.float(), sp.float(), atol=O_TOL, rtol=O_TOL)
        require(torch.equal(o, o2), f"paged_tail_int8 case {i}: a second call gave other bits")
        err = float((o.float() - r.float()).abs().max())
        err_split = float((o.float() - sp.float()).abs().max())
        worst = max(worst, err)
        dead = [j for j, n in enumerate(lens) if n == 0]
        require(all(bool((o[j] == 0).all()) for j in dead), "paged_tail_int8: dead slot")
        log(f"[kernels] paged_tail_int8 B={b} H={h} K={kv} D={d} ps={ps} T={tl} "
            f"lengths={lens} starts={sts}: max|o-plain|={err:.3e}, max|o-split plain|="
            f"{err_split:.3e} (tolerance {O_TOL}), a second call the same bits ok")
    require((paged.launches_tail_int8, paged.launches_tail, paged.launches)
            == (2 * len(cases), 0, 0),
            (paged.launches_tail_int8, paged.launches_tail, paged.launches))
    return {"paged_tail_int8": worst}


def _paged_int8_bound(q, kq, table, lengths, starts):
    """Least time on an H100 SXM for one K3 call over int8 pools: the live
    page keys' int8 K and V and their two f32 scales, the live tail keys' K
    and V in q's dtype, q and o, the table and the lengths over HBM
    bandwidth, against 4*D flops per (query head, live key) at the peak of
    q's dtype."""
    b, h, d = q.shape
    kv = kq.shape[1]
    es = q.element_size()
    pairs = list(zip(starts.tolist(), lengths.tolist()))
    page = sum(min(s, n) for s, n in pairs)
    tail = sum(max(0, n - s) for s, n in pairs)
    nbytes = (2 * page * kv * (d + 4) + 2 * tail * kv * d * es + 2 * (es * b * h * d)
              + 4 * (table.numel() + 2 * b))
    flops = 4 * d * h * (page + tail)
    return _bound(nbytes, flops, q.dtype)


def phase_paged_int8_timings(paged) -> dict:
    """K3 over int8 pools at the main path's decode-tick shape: kernel,
    plain, and as the library yardstick SDPA (``enable_gqa``, the length
    mask) over the same keys dequantized to bf16 beforehand, with that
    dequantization's own time beside it; the float K3 on the same bf16 keys
    in the same run; the bound from int8 bytes plus scales. Every call reads
    one of ``PAGED_COPIES`` input copies in turn (device times from CUDA-graph
    replays)."""
    import torch
    import torch.nn.functional as F

    m = PAGED_MAIN
    starts, lengths = _paged_main_case()
    copies = [_paged_inputs(m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"],
                            lengths, starts, seed=400 + c, share=False)
              for c in range(PAGED_COPIES)]
    q, kp, _, table, ln, st, _, _ = copies[0]
    b, h, d = q.shape
    kv, ps = kp.shape[1], kp.shape[2]
    maxp = table.shape[1]
    cols = torch.arange(maxp * ps, device="cuda")
    tail_cols = torch.arange(m["tail_len"], device="cuda")
    kernel, float_kernel, plain, library, dequant = [], [], [], [], []
    for q, kp, vp, table, ln, st, tk, tv in copies:
        kq, vq, ks, vs = _int8_pools(kp, vp)
        tail = dict(tail_k=tk, tail_v=tv, starts=st)

        def deq(kq=kq, vq=vq, ks=ks, vs=vs, table=table, tk=tk, tv=tv):
            """Every slot's page keys dequantized to bf16, then its tail: the
            (B, K, S, D) K and V that SDPA reads."""
            out = []
            for pool, sc, t in ((kq, ks, tk), (vq, vs, tv)):
                g = (pool[table.long()].float() * sc[table.long()][:, :, :, 0, :, None])
                g = g.to(torch.bfloat16).transpose(2, 3).reshape(b, maxp * ps, kv, d)
                out.append(torch.cat([g, t.transpose(1, 2)], dim=1).transpose(1, 2)
                           .contiguous())
            return out

        kt, vt = deq()
        valid = torch.cat([cols[None] < torch.minimum(st, ln)[:, None],
                           st[:, None] + tail_cols[None] < ln[:, None]], dim=1)
        kernel.append(functools.partial(paged.paged_attention, q, kq, vq, table, ln,
                                        **tail, k_scale=ks, v_scale=vs))
        float_kernel.append(functools.partial(paged.paged_attention, q, kp, vp, table, ln,
                                              **tail))
        plain.append(functools.partial(paged.paged_attention_plain, q, kq, vq, table, ln,
                                       tk, tv, st, ks, vs))
        library.append(functools.partial(F.scaled_dot_product_attention, q[:, :, None], kt,
                                         vt, attn_mask=valid[:, None, None, :],
                                         enable_gqa=True))
        dequant.append(deq)
    ms = _graph_ms(kernel)
    float_ms = _graph_ms(float_kernel)
    plain_ms = _graph_ms(plain, rounds=1)
    lib_ms = _graph_ms(library)
    deq_ms = _graph_ms(dequant, rounds=1)
    ms2 = _graph_ms(kernel)
    float_ms2 = _graph_ms(float_kernel)
    eager_ms = _time_ms(_cycle(kernel), iters=4 * PAGED_COPIES)
    by_kernel = _device_us_by_kernel(_cycle(kernel), 4 * PAGED_COPIES)
    log("[timing] paged_tail_int8 device time per call by kernel (torch.profiler, eager "
        "calls): " + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(by_kernel.items()))
        + f" ({SMI})")
    q, kq = copies[0][0], _int8_pools(copies[0][1], copies[0][2])[0]
    bound_ms, bound_by = _paged_int8_bound(q, kq, copies[0][3], copies[0][4], copies[0][5])
    float_bound, _ = _paged_bound(q, copies[0][1], copies[0][3], copies[0][4], copies[0][5],
                                  True)
    log(f"[timing] paged_tail_int8 B={b} H={h} K={kv} D={d} ps={ps} T={m['tail_len']} "
        f"lengths={lengths} starts={starts}, {PAGED_COPIES} input copies in turn: device "
        f"(CUDA graph) kernel {ms:.4f}/{ms2:.4f} ms, float K3 on the same keys in bf16 "
        f"{float_ms:.4f}/{float_ms2:.4f} ms (bound {float_bound:.4f} ms), plain "
        f"{plain_ms:.4f} ms, sdpa on K/V dequantized to bf16 beforehand {lib_ms:.4f} ms "
        f"(the dequantization itself {deq_ms:.4f} ms); eager, host launches included: "
        f"kernel {eager_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: int8 K/V and "
        f"their scales), {bound_ms / min(ms, ms2):.1%} of bound ({SMI})")
    return {"paged_tail_int8": {"ms": min(ms, ms2), "eager_ms": eager_ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": lib_ms,
                                "dequant_ms": deq_ms, "float_ms": min(float_ms, float_ms2)}}


def _det_int8(shape, salt: int):
    """int8 values in [-127, 127] made by integer arithmetic alone (as
    ``_det_bf16``)."""
    import torch

    n = 1
    for x in shape:
        n *= x
    i = torch.arange(n, device="cuda", dtype=torch.int64)
    h = (i * 2654435761 + salt * 40503) % 4294967296
    h = (h ^ (h >> 15)) * 1274126177 % 4294967296
    return (h % 255 - 127).to(torch.int8).reshape(shape)


def _det_paged_case(b, h, kv, d, ps, tail_len, lengths, starts, salt, nq=None):
    """A paged case from integer arithmetic alone: bf16 q, pools and tails
    (``_det_bf16``), int8 pools (``_det_int8``) with f32 scales of 1..1000
    times 2^-14, and the table ``_paged_inputs`` builds (128 pages, rows 1
    and 2 sharing their first page)."""
    import torch

    n_pool = 128
    q = _det_bf16((b, h, d) if nq is None else (b, nq, h, d), salt, 9)
    kp, vp = _det_bf16((n_pool, kv, ps, d), salt + 1, 9), _det_bf16((n_pool, kv, ps, d), salt + 2, 9)
    tk, tv = _det_bf16((b, kv, tail_len, d), salt + 3, 9), _det_bf16((b, kv, tail_len, d), salt + 4, 9)
    kq, vq = _det_int8((n_pool, kv, ps, d), salt + 5), _det_int8((n_pool, kv, ps, d), salt + 6)
    ks = ((_det_int8((n_pool, kv, 1, ps), salt + 7).float().abs() + 1) * 2.0**-14).contiguous()
    vs = ((_det_int8((n_pool, kv, 1, ps), salt + 8).float().abs() + 1) * 2.0**-14).contiguous()
    maxp = max(1, max(-(-max(x, y) // ps) for x, y in zip(lengths, starts)))
    table = torch.zeros((b, maxp), dtype=torch.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-max(lengths[row], starts[row]) // ps)):
            table[row, i] = pid
            pid += 1
    table[2, 0] = table[1, 0]

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    return dict(q=q, kp=kp, vp=vp, kq=kq, vq=vq, ks=ks, vs=vs, tk=tk, tv=tv,
                table=table.cuda(), lengths=ints(lengths), starts=ints(starts))


# K3, K3 over int8 pools (bf16 and float16 q) and K4 in their single-query
# form, on the cases of ``_k3_digests``: SHA-256 prefixes of their outputs as
# the build before the verify form joined their template gave them
# (``_k3_digests`` run on the card against that tree's ``ditl_tpu_torch``,
# first on ``sys.path``); K3-int8-f16 as the build before its page tiles were
# widened in registers gave them, which the registers' build gives too.
K3_DIGESTS: dict[str, str] = {
    "case 0 K3": "98a9aa9302a1d603",
    "case 0 K3-int8": "c79691c1cd7c338c",
    "case 0 K4": "cb41f6707f7ca237",
    "case 1 K3": "04400c3cdcae43aa",
    "case 1 K3-int8": "967e49b6502d8e9c",
    "case 1 K4": "5c8c224a80cc1d46",
    "case 2 K3": "54d18c07668f0118",
    "case 2 K3-int8": "bc0c39e8e161843b",
    "case 2 K4": "4f1fa201bc54b18a",
    "case 0 K3-int8-f16": "da1cc0bd3c46a2eb",
    "case 1 K3-int8-f16": "015caf020a7392fe",
    "case 2 K3-int8-f16": "bd4fb0abe7184a68",
}


def _k3_digests(paged) -> dict:
    """K3 (float and int8 pools; over int8 pools also with float16 q and
    tails) and K4 on fixed integer-made inputs: the decode tick's shape, head_dim 64 at page 16 (a dead slot, a tail-only
    slot), and the split edges; SHA-256 digests of the outputs' bytes. Uses
    only the wrapper's single-query signature, so it runs against an older
    tree's module too."""
    import hashlib

    import torch

    main = PAGED_MAIN
    starts, lengths = _paged_main_case()
    cases = [(main["b"], main["h"], main["kv"], main["d"], main["ps"], main["tail_len"],
              lengths, starts),
             (4, 8, 4, 64, 16, 8, [0, 5, 38, 50], [0, 0, 32, 45]),
             (4, 32, 8, 128, 16, 16, [257, 256, 513, 140], [257, 250, 500, 128])]
    out = {}
    for i, (b, h, kv, d, ps, tl, lens, sts) in enumerate(cases):
        c = _det_paged_case(b, h, kv, d, ps, tl, lens, sts, salt=700 + 10 * i)
        tail = dict(tail_k=c["tk"], tail_v=c["tv"], starts=c["starts"])
        outs = {
            "K3": paged.paged_attention(c["q"], c["kp"], c["vp"], c["table"], c["lengths"],
                                        **tail),
            "K3-int8": paged.paged_attention(c["q"], c["kq"], c["vq"], c["table"],
                                             c["lengths"], **tail, k_scale=c["ks"],
                                             v_scale=c["vs"]),
            "K4": paged.paged_attention(c["q"], c["kp"], c["vp"], c["table"], c["lengths"]),
            "K3-int8-f16": paged.paged_attention(
                c["q"].half(), c["kq"], c["vq"], c["table"], c["lengths"],
                tail_k=c["tk"].half(), tail_v=c["tv"].half(), starts=c["starts"],
                k_scale=c["ks"], v_scale=c["vs"]),
        }
        torch.cuda.synchronize()
        for name, t in outs.items():
            raw = t.contiguous().view(torch.int16).cpu().numpy().tobytes()
            out[f"case {i} {name}"] = hashlib.sha256(raw).hexdigest()[:16]
    return out


# The row-tile kernel's forms (``paged_rows_kernel``: the verify, and the
# single query past 8 rows a KV head) on the cases of ``_rows_digests``:
# SHA-256 prefixes of their outputs as the build that moved them onto it
# gave them on an H100 (the spec tick at splits of 256 keys, 144 rows at
# 256, head_dim 64 and G = 16 at 128).
ROWS_DIGESTS: dict[str, str] = {
    "spec tick K3-verify bf16": "f665ae6f9e7d3a53",
    "spec tick K3-int8-verify bf16": "513955bf7dcd2672",
    "spec tick K3-verify f16": "036f2a66c96d74f3",
    "spec tick K3-int8-verify f16": "7e9189e4f5ca4f7a",
    "head_dim 64 K3-verify bf16": "99dcd46b6f81db7e",
    "head_dim 64 K3-int8-verify bf16": "ad24890f26841140",
    "head_dim 64 K3-verify f16": "6d4dea3f0a4ebc01",
    "head_dim 64 K3-int8-verify f16": "f784073b22adc314",
    "144 rows K3-verify bf16": "83083b3adbaf9690",
    "144 rows K3-int8-verify bf16": "92d04aa834300515",
    "144 rows K3-verify f16": "1ed62a829f41341b",
    "144 rows K3-int8-verify f16": "dde74d20caa0f6bd",
    "G = 16 K3 bf16": "fe2fcb98f86fc2dd",
    "G = 16 K3-int8 bf16": "a29af00bb2b67d4a",
    "G = 16 K4 bf16": "edee20f786ee80a1",
    "G = 16 K3 f16": "48315790f83ca42f",
    "G = 16 K3-int8 f16": "b99cebda575fafa6",
    "G = 16 K4 f16": "b964d1f48eaa2fcb",
}


def _rows_digests(paged) -> dict:
    """K3-verify and K3-int8-verify in bf16 and float16 at the spec tick,
    at head_dim 64 (page 16, a dead slot, Q = 5) and at path 16's 144 rows
    (G = 16, Q = 9); K3, K3-int8 and K4 in both types at path 16's decode
    tick (G = 16, one query); each on ``_det_paged_case``'s integer-made
    inputs (float16: the same values, exact in float16). SHA-256 digests
    of the outputs' bytes."""
    import hashlib

    import torch

    spec_st, spec_ln = _spec_main_case()
    tick_st, tick_ln = _paged_main_case()
    m, p16 = SPEC_MAIN, SHAPE_SPEC_TICKS[16]
    cases = [("spec tick", (m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"], spec_ln,
                            spec_st), m["nq"]),
             ("head_dim 64", (4, 8, 4, 64, 16, 24, [0, 20, 40, 21], [0, 16, 33, 20]), 5),
             ("144 rows", (p16["b"], p16["h"], p16["kv"], p16["d"], p16["ps"], p16["tail_len"],
                           spec_ln, spec_st), p16["nq"]),
             ("G = 16", (8, 128, 8, 128, 256, 16, tick_ln, tick_st), None)]
    out = {}
    for i, (label, shape, nq) in enumerate(cases):
        c = _det_paged_case(*shape, salt=900 + 10 * i, nq=nq)
        for sfx, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16)):
            q, kp, vp, tk, tv = (c[k].to(dtype) for k in ("q", "kp", "vp", "tk", "tv"))
            tail = dict(tail_k=tk, tail_v=tv, starts=c["starts"])
            int8 = dict(k_scale=c["ks"], v_scale=c["vs"])
            name = "-verify" if nq else ""
            outs = {f"K3{name}": paged.paged_attention(q, kp, vp, c["table"], c["lengths"],
                                                       **tail),
                    f"K3-int8{name}": paged.paged_attention(q, c["kq"], c["vq"], c["table"],
                                                            c["lengths"], **tail, **int8)}
            if nq is None:
                outs["K4"] = paged.paged_attention(q, kp, vp, c["table"], c["lengths"])
            torch.cuda.synchronize()
            for key, t in outs.items():
                raw = t.contiguous().view(torch.int16).cpu().numpy().tobytes()
                out[f"{label} {key} {sfx}"] = hashlib.sha256(raw).hexdigest()[:16]
    return out


def _det_f32(shape, salt: int, shift: int):
    """f32 values made on the card by integer arithmetic alone (integers in
    [-2^20, 2^20] times 2**-shift, hashed as in ``_det_bf16``): 21 bits of
    mantissa, the same bits whatever card, CUDA version or torch makes them."""
    import torch

    n = 1
    for x in shape:
        n *= x
    i = torch.arange(n, device="cuda", dtype=torch.int64)
    h = (i * 2654435761 + salt * 40503) % 4294967296
    h = (h ^ (h >> 15)) * 1274126177 % 4294967296
    return ((h % 2097153 - 1048576).float() * 2.0**-shift).reshape(shape)


# ``_f32_digests`` on an H100: K5b-f32 and K6-f32 as they gave them before
# K3-int8-f32 and K5a-f32 were redesigned (run on the card against the tree
# of commit 1bdbc9f); the single-query K3-int8-f32 as its tensor-core kernel
# gave them when it came in (commit a7d5426); K3-f32, K3-int8-f32-verify,
# K3-f32-verify and K4-f32 as the tensor-core kernel gives them since they
# moved onto it (3xTF32 sums in place of FFMA's; the f32 verify at 144 rows
# at splits of 256 keys); K5a-f32 as the tree of commit a89f671 gave them.
# K6-f32 on the wgmma core gives its earlier core's bits (each k8 step's
# three products in the same order from the same zeroed partial), but for
# wk/wv's dw, which f32_proj_splits sums from 8 splits, not 16. Each must
# keep these bits.
F32_DIGESTS: dict[str, str] = {
    "decode tick K3-f32": "84d13dc45a836fe4",
    "decode tick K4-f32": "f01f41b5c90f8377",
    "decode tick K3-int8-f32": "f9d683fd87d27a1a",
    "head_dim 64 K3-f32": "c596d37787dfe96c",
    "head_dim 64 K4-f32": "acbce96c0421f372",
    "head_dim 64 K3-int8-f32": "7771de22d9feb078",
    "G = 16 K3-f32": "afe1ddb1f99ef867",
    "G = 16 K4-f32": "7cdb6f6183a4873b",
    "G = 16 K3-int8-f32": "17c4a0f89ca3b1ac",
    "D = 256 K3-f32": "07c52ec338a05aa6",
    "D = 256 K4-f32": "d5377d43d158fcca",
    "D = 256 K3-int8-f32": "eff2e56b47557f52",
    "spec tick K3-f32-verify": "bdea2bb6dc61adc9",
    "spec tick K3-int8-f32-verify": "d6f3f092af50c59e",
    "head_dim 64 K3-f32-verify": "1f80b7a28a9c7308",
    "head_dim 64 K3-int8-f32-verify": "53ecc44e861d0343",
    "144 rows K3-f32-verify": "57c31d457356e28a",
    "144 rows K3-int8-f32-verify": "c9deaf23cafe018e",
    "D = 256 K3-f32-verify": "274f52a5aabd1c4a",
    "D = 256 K3-int8-f32-verify": "0f87c775c820f4c3",
    "K5a-f32 N=8192 D=896 F=4864 dgu": "9ddad8f92f486427",
    "K5a-f32 N=8192 D=896 F=4864 d_w_down": "d37a095548985bd5",
    "K5a-f32 N=2064 D=384 F=384 dgu": "23e24e787e829478",
    "K5a-f32 N=2064 D=384 F=384 d_w_down": "666b841401785d14",
    "K5b-f32 N=8192 D=896 F=4864 dh": "1400a7112f362849",
    "K5b-f32 N=8192 D=896 F=4864 d_w_gu": "d23a7fe9806eb0cc",
    "K5b-f32 N=2064 D=384 F=384 dh": "40b1658e2f75f968",
    "K5b-f32 N=2064 D=384 F=384 d_w_gu": "2d7d2e65052ff8f5",
    "K6-f32 N=8192 D=896 F=896 dx": "5f9bea34234a7f36",
    "K6-f32 N=8192 D=896 F=896 dw": "012e923f56102cac",
    "K6-f32 N=8192 D=896 F=128 dx": "aa0b300c94911bd2",
    "K6-f32 N=8192 D=896 F=128 dw": "33b4a7ddfc55024d",
}


def _f32_digests(paged, mlp_bwd, proj) -> dict:
    """K3-f32, K4-f32 and K3-int8-f32 (the decode tick, head_dim 64 at page 16
    with a dead and a tail-only slot, path 16's G = 16, D = 256 at path 15's
    heads), K3-f32-verify and
    K3-int8-f32-verify (the spec tick, head_dim 64 at Q = 5, path 16's 144
    rows, D = 256), K5a-f32 and K5b-f32 (path 10's shapes, d_w_down split 4
    ways and d_w_gu unsplit; N = 2064, D = F = 384, d_w_down split 13 ways
    and d_w_gu split), K6-f32 (path 10's wq/wo and wk/wv, dw split 3 and 8
    ways) on fixed integer-made f32 inputs (``_det_f32``; int8 pools
    ``_det_int8`` with scales of 1..128 times 2^-14); SHA-256 prefixes of
    the outputs' bytes; with ``paged`` None, the K5 and K6 entries alone.
    Uses only the wrappers' signatures, so it runs against an older tree's
    module too."""
    import hashlib

    import torch

    def digest(t):
        raw = t.contiguous().view(torch.int32).cpu().numpy().tobytes()
        return hashlib.sha256(raw).hexdigest()[:16]

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    def case(b, h, kv, d, ps, tl, lens, sts, salt, nq=None, maxp=None):
        maxp = maxp or max(1, max(-(-max(x, y) // ps) for x, y in zip(lens, sts)))
        n_pool = b * maxp + 1
        table = torch.zeros((b, maxp), dtype=torch.int32)
        pid = 1
        for row in range(b):
            for i in range(min(maxp, -(-max(lens[row], sts[row]) // ps))):
                table[row, i] = pid
                pid += 1
        table[2 % b, 0] = table[1 % b, 0]
        pools = (n_pool, kv, ps, d)
        scale = ((n_pool, kv, 1, ps))
        return dict(
            q=_det_f32((b, h, d) if nq is None else (b, nq, h, d), salt, 20),
            kp=_det_f32(pools, salt + 1, 20), vp=_det_f32(pools, salt + 2, 20),
            kq=_det_int8(pools, salt + 3), vq=_det_int8(pools, salt + 4),
            ks=((_det_int8(scale, salt + 5).float().abs() + 1) * 2.0**-14).contiguous(),
            vs=((_det_int8(scale, salt + 6).float().abs() + 1) * 2.0**-14).contiguous(),
            tk=_det_f32((b, kv, tl, d), salt + 7, 20), tv=_det_f32((b, kv, tl, d), salt + 8, 20),
            table=table.cuda(), lengths=ints(lens), starts=ints(sts))

    out = {}
    if paged is not None:  # None: the matrix products alone
        starts, lengths = _paged_main_case()
        single = [("decode tick", 8, 32, 8, 128, 256, 16, lengths, starts),
                  ("head_dim 64", 4, 8, 4, 64, 16, 8, [0, 5, 38, 50], [0, 0, 32, 45]),
                  ("G = 16", 8, 128, 8, 128, 256, 16, lengths, starts),
                  ("D = 256", 8, 8, 1, 256, 256, 16, lengths, starts)]
        for i, (label, b, h, kv, d, ps, tl, lens, sts) in enumerate(single):
            c = case(b, h, kv, d, ps, tl, lens, sts, 3000 + 20 * i)
            low = torch.minimum(c["starts"], c["lengths"]).contiguous()
            tail = dict(tail_k=c["tk"], tail_v=c["tv"], starts=c["starts"])
            out[f"{label} K3-f32"] = digest(paged.paged_attention(
                c["q"], c["kp"], c["vp"], c["table"], c["lengths"], **tail))
            out[f"{label} K4-f32"] = digest(paged.paged_attention(c["q"], c["kp"], c["vp"],
                                                                  c["table"], low))
            out[f"{label} K3-int8-f32"] = digest(paged.paged_attention(
                c["q"], c["kq"], c["vq"], c["table"], c["lengths"], **tail, k_scale=c["ks"],
                v_scale=c["vs"]))
            del c
        sp_starts, sp_lengths = _spec_main_case()
        verify = [("spec tick", 8, 9, 32, 8, 128, 256, 54, sp_lengths, sp_starts, 8),
                  ("head_dim 64", 4, 5, 8, 4, 64, 16, 24, [0, 20, 40, 21], [0, 16, 33, 20], 4),
                  ("144 rows", 8, 9, 128, 8, 128, 256, 54, sp_lengths, sp_starts, 8),
                  ("D = 256", 8, 9, 8, 1, 256, 256, 54, sp_lengths, sp_starts, 8)]
        for i, (label, b, nq, h, kv, d, ps, tl, lens, sts, maxp) in enumerate(verify):
            c = case(b, h, kv, d, ps, tl, lens, sts, 3200 + 20 * i, nq=nq, maxp=maxp)
            tail = dict(tail_k=c["tk"], tail_v=c["tv"], starts=c["starts"])
            out[f"{label} K3-f32-verify"] = digest(paged.paged_attention(
                c["q"], c["kp"], c["vp"], c["table"], c["lengths"], **tail))
            out[f"{label} K3-int8-f32-verify"] = digest(paged.paged_attention(
                c["q"], c["kq"], c["vq"], c["table"], c["lengths"], **tail, k_scale=c["ks"],
                v_scale=c["vs"]))
            del c
    for n, d, f in ((8192, 896, 4864), (2064, 384, 384)):
        g, w_down = _det_f32((n, d), 3600, 24), _det_f32((f, d), 3601, 25)
        gate, up = _det_f32((n, 2 * f), 3602, 20).chunk(2, dim=-1)
        for name, t in zip(("dgu", "d_w_down"), mlp_bwd.dgu_dwdown(g, w_down, gate, up)):
            out[f"K5a-f32 N={n} D={d} F={f} {name}"] = digest(t)
        del g, w_down, gate, up
        h, dgu = _det_f32((n, d), 3400, 20), _det_f32((n, 2 * f), 3401, 24)
        w_gu = _det_f32((d, 2 * f), 3402, 25)
        for name, t in zip(("dh", "d_w_gu"), mlp_bwd.dh_dwgu(h, dgu, w_gu)):
            out[f"K5b-f32 N={n} D={d} F={f} {name}"] = digest(t)
        del h, dgu, w_gu
    for n, d, f in ((8192, 896, 896), (8192, 896, 128)):
        x, w = _det_f32((1, n, d), 3500, 20), _det_f32((d, f), 3501, 25)
        g = _det_f32((1, n, f), 3502, 24)
        for name, t in zip(("dx", "dw"), proj.projection_bwd(x, w, g, blocks=(0, 128))):
            out[f"K6-f32 N={n} D={d} F={f} {name}"] = digest(t)
        del x, w, g
    torch.cuda.synchronize()
    return out


# The speculative tick's verify shape on path 7: 8 slots, Q = spec_k + 1 = 9
# queries, 32 query / 8 KV heads, head_dim 128, page 256, 8 pages a slot
# (context 2048), a tail of spec_rounds * Q = 6 * 9 = 54 columns.
SPEC_MAIN = dict(b=8, nq=9, h=32, kv=8, d=128, ps=256, maxp=8, tail_len=54)


def _spec_main_case():
    """The verify's ragged state in a spec tick: each live slot's tokens
    [0, starts) in pages and [starts, lengths) in the tail (lengths = pos +
    1 > starts); the decode tick's slots (a dead one, a page boundary, a
    shared page), one tail reaching column 54 for its last query."""
    starts = [0, 700, 512, 1490, 9, 256, 1030, 300]
    lengths = [0, 710, 513, 1500, 10, 257, 1046, 346]
    return starts, lengths


def _verify_cases():
    """(label, b, nq, h, kv, d, ps, tail_len, lengths, starts, maxp) for
    K3-verify's kernels phase."""
    m = SPEC_MAIN
    starts, lengths = _spec_main_case()
    return [
        ("spec tick", m["b"], m["nq"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"],
         lengths, starts, m["maxp"]),
        # head_dim 64, page 16: a dead slot, a page-aligned and a mid-page
        # start, tail-straddling lengths (tests/test_paged.py's multi-query
        # inputs), Q = 5
        ("head_dim 64", 4, 5, 8, 4, 64, 16, 24, [0, 20, 40, 21], [0, 16, 33, 20], 4),
        # a tail longer than 128 columns: query 0's limit (125) ends before
        # the tail's 128-column split boundary, query 8's (133) crosses it;
        # a tail-only slot (no pages), and a short slot
        ("long tail", 3, 9, 32, 8, 128, 16, 200, [381, 60, 30], [256, 30, 0], 16),
        # G = 8: 9 x 8 = 72 query rows (five row tiles)
        ("G=8", 2, 9, 16, 2, 128, 64, 40, [300, 77], [290, 64], 5),
        # 8 query rows, one row tile with padding rows: Q = 2, G = 4
        ("Q=2", 3, 2, 16, 4, 128, 16, 16, [17, 40, 1], [16, 33, 0], 3),
        # G = 20 at Q = 3: 60 rows, the last row tile partial; the split edges
        ("G=20, 60 rows", 3, 3, 40, 2, 128, 16, 16, [258, 253, 140], [256, 250, 128], 17),
        # Q = 17 at G = 16: 272 rows, past a block's row tiles into a second
        # row group
        ("272 rows", 2, 17, 32, 2, 128, 64, 40, [300, 77], [290, 64], 5),
        # 144 rows at head_dim 256: the largest shared memory (int8 staged in
        # place)
        ("D=256, 144 rows", 2, 9, 32, 2, 256, 64, 40, [300, 77], [290, 64], 5),
        # page 16, five pages a slot: the tile at 64 mixes page rows (below
        # min(starts, lengths)), dead page rows and tail rows from 80; a
        # 100-column tail over a split boundary, a tail-only and a dead slot
        ("mixed tile", 5, 3, 8, 2, 64, 16, 100, [100, 80, 175, 3, 0], [80, 70, 80, 0, 0], 5),
    ]


def phase_paged_verify_kernels(paged) -> dict:
    """K3's multi-query verify over float and int8 pools against the plain
    version's 4-D branch and the split twin at ``O_TOL`` (``_verify_cases``:
    the spec tick, head_dim 64, a dead slot, a tail longer than 128 columns
    whose split is live for some queries and dead for others, a tail-only
    slot, G = 8 at 72 rows, Q = 2); a second call the same bits; a 4-D q with
    Q = 1 the 3-D call's bits; and K3, K3-int8 and K4 in their single-query
    form the digests of the build before the verify joined their template
    (``K3_DIGESTS``). Returns the max abs errors."""
    import torch

    worst = {"paged_verify": 0.0, "paged_verify_int8": 0.0}
    paged.reset_launches()
    n_calls = 0
    for i, (label, b, nq, h, kv, d, ps, tl, lens, sts, maxp) in enumerate(_verify_cases()):
        q, kp, vp, table, ln, st, tk, tv = _paged_inputs(b, h, kv, d, ps, tl, lens, sts,
                                                         seed=600 + i, n_pool=128, nq=nq,
                                                         maxp=maxp, share=b > 2)
        kq, vq, ks, vs = _int8_pools(kp, vp)
        tail = dict(tail_k=tk, tail_v=tv, starts=st)
        for name, kw in (("paged_verify", dict(k_pages=kp, v_pages=vp)),
                         ("paged_verify_int8", dict(k_pages=kq, v_pages=vq, k_scale=ks,
                                                    v_scale=vs))):
            pools = (kw["k_pages"], kw["v_pages"])
            scales = {k: v for k, v in kw.items() if k.endswith("scale")}
            o = paged.paged_attention(q, *pools, table, ln, **tail, **scales)
            o2 = paged.paged_attention(q, *pools, table, ln, **tail, **scales)
            n_calls += 2
            r = paged.paged_attention_plain(q, *pools, table, ln, tk, tv, st,
                                            scales.get("k_scale"), scales.get("v_scale"))
            sp = paged.paged_attention_split_plain(q, *pools, table, ln, tk, tv, st,
                                                   scales.get("k_scale"),
                                                   scales.get("v_scale"))
            # Q = 1: the 4-D call runs the single-query kernel, the 3-D call's bits
            o41 = paged.paged_attention(q[:, :1].contiguous(), *pools, table, ln, **tail,
                                        **scales)
            o3 = paged.paged_attention(q[:, 0].contiguous(), *pools, table, ln, **tail,
                                       **scales)
            torch.cuda.synchronize()
            require(o.shape == q.shape and bool(torch.isfinite(o.float()).all()),
                    f"{name} {label}: shape or non-finite")
            torch.testing.assert_close(o.float(), r.float(), atol=O_TOL, rtol=O_TOL)
            torch.testing.assert_close(o.float(), sp.float(), atol=O_TOL, rtol=O_TOL)
            require(torch.equal(o, o2), f"{name} {label}: a second call gave other bits")
            require(torch.equal(o41[:, 0], o3), f"{name} {label}: Q = 1 differs from 3-D")
            dead = [j for j, n in enumerate(lens) if n == 0]
            require(all(bool((o[j] == 0).all()) for j in dead), f"{name}: dead slot")
            err = float((o.float() - r.float()).abs().max())
            err_split = float((o.float() - sp.float()).abs().max())
            worst[name] = max(worst[name], err)
            log(f"[kernels] {name} {label}: B={b} Q={nq} H={h} K={kv} D={d} ps={ps} "
                f"T={tl} lengths={lens} starts={sts}: max|o-plain|={err:.3e}, "
                f"max|o-split plain|={err_split:.3e} (tolerance {O_TOL}), a second call "
                f"the same bits, Q = 1 the 3-D call's bits")
    require((paged.launches_verify, paged.launches_verify_int8) == (n_calls // 2, n_calls // 2),
            (paged.launches_verify, paged.launches_verify_int8, n_calls))
    digests = _k3_digests(paged)
    for key, value in digests.items():
        log(f"[kernels] single-query digest {key}: {value} (expected {K3_DIGESTS.get(key)})")
    require(digests == K3_DIGESTS, "K3/K3-int8/K4 differ from the earlier build's bits")
    rows = _rows_digests(paged)
    for key, value in rows.items():
        log(f"[kernels] row-tile digest {key}: {value} (expected {ROWS_DIGESTS.get(key)})")
    require(rows == ROWS_DIGESTS, "the row-tile kernel's forms differ from their recorded bits")
    return worst


def _verify_sdpa_inputs(q, kp, vp, table, ln, st, tk, tv, k_scale=None, v_scale=None):
    """SDPA's view of a verify call: every slot's page keys (int8 pools:
    dequantized to q's dtype), then its tail, as (B, K, S, D) K and V, q as
    (B, H, Q, D), and the (B, 1, Q, S) boolean mask of the plain version."""
    import torch

    b, nq, h, d = q.shape
    kv, ps = kp.shape[1], kp.shape[2]
    maxp = table.shape[1]
    out = []
    for pool, sc, t in ((kp, k_scale, tk), (vp, v_scale, tv)):
        g = pool[table.long()]
        if sc is not None:
            g = (g.float() * sc[table.long()][:, :, :, 0, :, None]).to(q.dtype)
        g = g.transpose(2, 3).reshape(b, maxp * ps, kv, d)
        out.append(torch.cat([g, t.transpose(1, 2)], dim=1).transpose(1, 2).contiguous())
    cols = torch.arange(maxp * ps, device="cuda")
    page = (cols[None] < torch.minimum(st, ln)[:, None])[:, None].expand(b, nq, -1)
    qi = torch.arange(nq, device="cuda")
    tcols = torch.arange(tk.shape[2], device="cuda")
    tail = ((st[:, None, None] + tcols[None, None] < (ln[:, None] + qi[None])[:, :, None])
            & (ln > st)[:, None, None])
    mask = torch.cat([page, tail], dim=2)[:, None]
    return q.transpose(1, 2).contiguous(), out[0], out[1], mask


def _verify_bound(q, kv, table, tail_len, lengths, starts, int8: bool):
    """Least time on an H100 SXM for one verify call: the live keys' K and V
    once (int8 pools: int8 values plus two f32 scales a page key; the tail
    in q's dtype), the tail keys any query reads, q and o, the table and
    lengths, over HBM bandwidth, against 4*D flops per (query row, key it
    sees) at the peak of q's dtype."""
    b, nq, h, d = q.shape
    es = q.element_size()
    pairs = list(zip(starts.tolist(), lengths.tolist()))
    page = sum(min(s, n) for s, n in pairs)
    tail_keys = sum(min(tail_len, n - s + nq - 1) for s, n in pairs if n > s)
    seen = sum(nq * min(s, n) + sum(min(tail_len, n - s + qi) for qi in range(nq))
               for s, n in pairs if n > 0)
    page_bytes = page * kv * (2 * d + 8) if int8 else page * kv * 2 * d * es
    nbytes = (page_bytes + tail_keys * kv * 2 * d * es + 2 * (es * b * nq * h * d)
              + 4 * (table.numel() + 2 * b))
    flops = 4 * d * h * seen
    return _bound(nbytes, flops, q.dtype)


def phase_paged_verify_timings(paged) -> dict:
    """K3-verify (float and int8 pools) at the spec tick's shape: kernel,
    the single-query K3 on the same keys (query 0 alone), plain, and the
    yardstick SDPA (``enable_gqa``) over the same keys gathered (int8:
    dequantized) beforehand with the same per-query boolean mask, the gather
    timed apart; the bound. Every call reads one of ``PAGED_COPIES`` input
    copies in turn (device times from CUDA-graph replays)."""
    import torch
    import torch.nn.functional as F

    m = SPEC_MAIN
    starts, lengths = _spec_main_case()
    copies = [_paged_inputs(m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"],
                            lengths, starts, seed=800 + c, share=False, nq=m["nq"],
                            maxp=m["maxp"]) for c in range(PAGED_COPIES)]
    out = {}
    for name, int8 in (("paged_verify", False), ("paged_verify_int8", True)):
        kernel, single, plain, library, gather = [], [], [], [], []
        for q, kp, vp, table, ln, st, tk, tv in copies:
            scales = {}
            if int8:
                kp, vp, ks, vs = _int8_pools(kp, vp)
                scales = dict(k_scale=ks, v_scale=vs)
            tail = dict(tail_k=tk, tail_v=tv, starts=st)
            qs, kt, vt, mask = _verify_sdpa_inputs(q, kp, vp, table, ln, st, tk, tv,
                                                   **scales)
            q0 = q[:, 0].contiguous()
            kernel.append(functools.partial(paged.paged_attention, q, kp, vp, table, ln,
                                            **tail, **scales))
            single.append(functools.partial(paged.paged_attention, q0, kp, vp, table, ln,
                                            **tail, **scales))
            plain.append(functools.partial(paged.paged_attention_plain, q, kp, vp, table,
                                           ln, tk, tv, st, scales.get("k_scale"),
                                           scales.get("v_scale")))
            library.append(functools.partial(F.scaled_dot_product_attention, qs, kt, vt,
                                             attn_mask=mask, enable_gqa=True))
            gather.append(functools.partial(_verify_sdpa_inputs, q, kp, vp, table, ln, st,
                                            tk, tv, **scales))
        ms = _graph_ms(kernel)
        single_ms = _graph_ms(single)
        plain_ms = _graph_ms(plain, rounds=1)
        lib_ms = _graph_ms(library)
        gather_ms = _graph_ms(gather, rounds=1)
        ms2 = _graph_ms(kernel)
        single_ms2 = _graph_ms(single)
        by_kernel = _device_us_by_kernel(_cycle(kernel), 4 * PAGED_COPIES)
        log(f"[timing] {name} device time per call by kernel (torch.profiler, eager "
            "calls): " + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(by_kernel.items()))
            + f" ({SMI})")
        q, kp, _, table, ln, st, _, _ = copies[0]
        bound_ms, bound_by = _verify_bound(q, kp.shape[1], table, m["tail_len"], ln, st, int8)
        single_bound = (_paged_int8_bound(q[:, 0], kp, table, ln, st) if int8
                        else _paged_bound(q[:, 0], kp, table, ln, st, True))[0]
        log(f"[timing] {name} B={m['b']} Q={m['nq']} H={m['h']} K={m['kv']} D={m['d']} "
            f"ps={m['ps']} T={m['tail_len']} lengths={lengths} starts={starts}, "
            f"{PAGED_COPIES} input copies in turn: device (CUDA graph) kernel "
            f"{ms:.4f}/{ms2:.4f} ms, the single-query K3 on the same keys (query 0) "
            f"{single_ms:.4f}/{single_ms2:.4f} ms (bound {single_bound:.4f} ms), verify / "
            f"single {min(ms, ms2) / min(single_ms, single_ms2):.2f}x; plain "
            f"{plain_ms:.4f} ms; sdpa (enable_gqa, per-query mask) over keys gathered "
            f"{'and dequantized ' if int8 else ''}beforehand {lib_ms:.4f} ms (the gather "
            f"itself {gather_ms:.4f} ms), kernel / sdpa {min(ms, ms2) / lib_ms:.2f}x; "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / min(ms, ms2):.1%} of bound "
            f"({SMI})")
        out[name] = {"ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms, "gather_ms": gather_ms,
                     "single_ms": min(single_ms, single_ms2)}
    return out


def _int8_weight_bytes(cfg) -> int:
    """Bytes of the int8 serving tree reckoned from the configuration: int8
    projection, MLP and head weights with one f32 scale per output column,
    the bf16 embedding, f32 norm scales (unfused layout, untied head)."""
    d, f, hd, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.num_layers
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
    mats = [(d, q_out), (d, kv_out), (d, kv_out), (q_out, d), (d, f), (d, f), (f, d)]
    layer = sum(i * o + 4 * o for i, o in mats) + 2 * 4 * d
    head = d * cfg.vocab_size + 4 * cfg.vocab_size
    return n_l * layer + head + 2 * cfg.vocab_size * d + 4 * d


def phase_serve_int8(flash, paged, bf16: dict) -> dict:
    """Main path 6, int8 serving: ``infer/server.py --quantize int8
    --kv-quant int8 --engine continuous --cache-mode paged`` built in
    process, ``llama3-8b`` at full width and depth. The continuous engine
    serves the continuous path's 12 requests over HTTP (K3 over int8 pools
    on every decode step, K1 on every cold prefill); then the lock-step
    ``Generator`` serves five logprob requests over the same server. ``bf16``
    is the float continuous path's summary. Returns the launch counts."""
    import torch

    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.ops.quant import is_quantized_leaf

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server = server_mod.create_server([
        "--preset", "llama3-8b", "--override", "attention_impl=flash", "--device", "cuda",
        "--host", "127.0.0.1", "--port", "0", "--seed", "0", "--quantize", "int8",
        "--kv-quant", "int8", "--engine", "continuous", "--cache-mode", "paged",
        "--slots", "8", "--page-size", "256", "--max-cache-len", "2048",
    ])
    gen = server.RequestHandlerClass.generator
    engine = server.engine._engine
    cfg = gen.cfg
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    require((cfg.name, cfg.num_layers, cfg.hidden_size, cfg.kv_cache_dtype,
             cfg.attention_impl) == ("llama3-8b", 32, 4096, "int8", "flash"), cfg)
    layers = gen.params["layers"]
    require(all(is_quantized_leaf(w) and w["q"].dtype == torch.int8
                for group in ("attn", "mlp") for w in layers[group].values()), "layers")
    require(is_quantized_leaf(gen.params["lm_head"]["kernel"]), "lm head")
    require(gen.params["embed"]["embedding"].dtype == torch.bfloat16, "embedding")
    pools = engine.cache
    require((pools["kp"].dtype, pools["vp"].dtype, pools["ks"].dtype, pools["vs"].dtype)
            == (torch.int8, torch.int8, torch.float32, torch.float32), pools.keys())
    pool_bytes = sum(t.numel() * t.element_size() for t in pools.values())
    value_bytes = pools["kp"].numel() + pools["vp"].numel()
    scale_bytes = pool_bytes - value_bytes
    require(engine.n_pages == bf16["n_pages"] and 2 * value_bytes == bf16["pool_bytes"],
            (engine.n_pages, value_bytes, bf16))
    tree_bytes = sum(t.numel() * t.element_size() for t in _tensors(gen.params))
    reckoned = _int8_weight_bytes(cfg)
    require(tree_bytes == reckoned, (tree_bytes, reckoned))
    weights_gib = (torch.cuda.memory_allocated() - base - pool_bytes) / 2**30
    require(abs(weights_gib - reckoned / 2**30) < 0.1, (weights_gib, reckoned))
    log(f"[int8] server built in {built_s:.1f}s (weights drawn, quantized to int8, "
        f"engines built); resident weights {weights_gib:.3f} GiB "
        f"(torch.cuda.memory_allocated, less the pools), reckoned from the config "
        f"{reckoned / 2**30:.3f} GiB, bf16 serving tree 16.0 GiB (path 1); pools: "
        f"{engine.n_pages} pages, int8 values {value_bytes / 1e9:.3f} GB + f32 scales "
        f"{scale_bytes / 1e6:.1f} MB = {pool_bytes / 1e9:.3f} GB against "
        f"{bf16['pool_bytes'] / 1e9:.3f} GB of bf16 pools at the same page count "
        f"({pool_bytes / bf16['pool_bytes']:.3f}x)")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    tok = gen.tokenizer
    requests, repeated = _continuous_requests()
    lock_prompt = _text(60, 400)
    lock_requests = [{"prompt": _text(61 + i, n), "max_tokens": 16, "logprobs": 1}
                     for i, n in enumerate((100, 300))]
    lock_requests += [{"prompt": lock_prompt, "max_tokens": 24, "logprobs": 1}] * 2
    lock_requests += [{"prompt": _text(63, 200), "max_tokens": 16, "logprobs": 1,
                       "temperature": 0.8, "seed": 5}]
    try:
        flash.reset_launches()  # the continuous half's counts start here
        paged.reset_launches()
        results, wall = _send_continuous(url, requests, engine)
        launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                    "paged_tail_int8": paged.launches_tail_int8,
                    "paged": paged.launches}  # read right after the run
        st = engine.stats()
        flash.reset_launches()  # the lock-step half's counts start here
        paged.reset_launches()
        lock_bodies = []
        for payload in lock_requests:
            status, body = _http("POST", url + "/v1/completions", payload)
            require(status == 200, (status, body))
            lock_bodies.append(body)
        lock_launches = {"flash_fwd": flash.launches, "paged_tail": paged.launches_tail,
                         "paged_tail_int8": paged.launches_tail_int8}
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")

    n_tokens = 0
    for i, payload in enumerate(requests):
        require(i in results, f"request {i} did not answer")
        status, body, w = results[i]
        require(status == 200, (i, status, body))
        n = body["usage"]["completion_tokens"]
        n_tokens += n
        require(n >= 1, body)
        if not payload.get("temperature"):
            require(n == payload["max_tokens"], (i, body))
    require(st["prefix_cache"]["hit_tokens"] >= 512 * 3, st["prefix_cache"])
    require(st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"], st)
    want_k3 = cfg.num_layers * st["decode_steps"]
    require(launches["paged_tail_int8"] == want_k3, (launches, st["decode_steps"]))
    require(launches["paged_tail"] == 0 and launches["paged"] == 0, launches)
    require(launches["flash_fwd"] == cfg.num_layers * st["prefills_cold"],
            (launches, st["prefills_cold"]))
    ms_step = st["decode_seconds"] / st["decode_steps"] * 1e3
    log(f"[int8] continuous: K3-int8 launches {launches['paged_tail_int8']} = "
        f"{cfg.num_layers} layers x {st['decode_steps']} decode steps "
        f"({st['decode_ticks']} ticks), float K3 launches {launches['paged_tail']}; K1 "
        f"launches {launches['flash_fwd']} = {cfg.num_layers} x {st['prefills_cold']} cold "
        f"prefills; prefix cache {st['prefix_cache']}")
    log(f"[int8] continuous: {len(requests)} concurrent requests in {wall:.3f}s wall: "
        f"{n_tokens} generated tokens, {n_tokens / wall:.1f} tokens/s aggregate; decode "
        f"{ms_step:.2f} ms per step against {bf16['ms_step']:.2f} ms on the bf16 path, "
        f"{bf16['tokens_s']:.1f} tokens/s there (host clock, each tick ends in a "
        f"device-to-host copy; {SMI})")
    require(lock_launches["flash_fwd"] == cfg.num_layers * len(lock_requests)
            and lock_launches["paged_tail"] == lock_launches["paged_tail_int8"] == 0,
            lock_launches)
    a, b = (body["choices"][0] for body in lock_bodies[2:4])
    require(a["logprobs"]["token_logprobs"] == b["logprobs"]["token_logprobs"]
            and a["logprobs"]["tokens"] == b["logprobs"]["tokens"], (a, b))
    for payload, body in zip(lock_requests, lock_bodies):
        lps = body["choices"][0]["logprobs"]["token_logprobs"]
        require(all(x == x and x <= 0 for x in lps), lps)  # finite log-probabilities
        if not payload.get("temperature"):
            require(body["usage"]["completion_tokens"] == payload["max_tokens"], body)
    log(f"[int8] lock-step Generator over the int8 cache: {len(lock_requests)} logprob "
        f"requests, K1 launches {lock_launches['flash_fwd']} = {cfg.num_layers} x "
        f"{len(lock_requests)} prefills, the repeated greedy request gave identical "
        f"tokens and logprobs")

    # Greedy output identical across two runs of the engine (the server has
    # stopped, so this thread owns it), and one decode tick's logits through
    # K3-int8 against the plain version's int8 branch.
    prompt = [tok.bos_id] + tok.encode(repeated)
    runs = []
    for _ in range(2):
        rid = engine.submit(prompt, max_new_tokens=24)
        runs.append(engine.run()[rid])
    require(len(runs[0]) == 24 and runs[0] == runs[1], runs)
    log("[int8] the same greedy request run twice on the engine: identical tokens")
    _check_decode_step(engine, paged, "int8", "K3-int8")
    log(f"[int8] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {"flash_fwd": launches["flash_fwd"] + lock_launches["flash_fwd"],
            "paged_tail_int8": launches["paged_tail_int8"]}


# ---------------------------------------------------------------------------
# The f32 kernels and paths 8 (f32 serving) and 9 (f32 training)
# ---------------------------------------------------------------------------


def _sdpa_backend(*args, **kw) -> str:
    """The backend PyTorch's dispatcher picks for these SDPA arguments."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(*args, **kw)).name


def phase_f32_kernels(flash, paged, train_seg) -> dict:
    """[f32-kernels]: K1-f32, K2a-f32 and K2b-f32 against the plain forward
    and backward in f32 (TF32 off, as ``main()`` sets it) at D = 64 and 128,
    causal and not, packed and right-padded ids, G = 4 and 7 (path 9's batch
    among them); K3-f32, K4-f32 and K3-f32-verify against the plain version
    and the split twin at the decode tick (``_paged_main_case``), the spec
    tick (``_spec_main_case``) and the verify's other cases. Each kernel
    called twice must give the same bits. Returns the max abs errors and
    K4-f32's direct-call launches."""
    import torch

    f32 = torch.float32
    cases = [  # (label, b, s_q, s_kv, h, kv, d, causal, ids)
        ("serving prefill, right-padded, G=4", 4, 512, 512, 32, 8, 128, True,
         [512, 401, 230, 97]),
        ("path 9's batch, packed rows, G=7", 4, 2048, 2048, 14, 2, 64, True, "train"),
        ("G=7, ids up and down", 2, 300, 300, 14, 2, 64, True, "nonmono"),
        ("boundary past a tile edge", 1, 257, 257, 4, 2, 128, True, "edge1"),
        ("packed, S % 64 != 0", 2, 333, 333, 8, 2, 128, True, "packed"),
        ("non-causal, Sq != Skv", 2, 200, 333, 8, 2, 64, False, None),
    ]
    worst = {"flash_fwd_f32": 0.0, "flash_dq_f32": 0.0, "flash_dkv_f32": 0.0}
    flash.reset_launches()
    for i, (label, b, sq, skv, h, kv, d, causal, spec) in enumerate(cases):
        seg = _bwd_segment_ids(spec, b, sq, train_seg)
        q, k, v, o, lse, do = _bwd_inputs(b, sq, skv, h, kv, d, causal, seg, seed=900 + i,
                                          flash=flash, dtype=f32)
        o2, lse2 = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
        o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal=causal, segment_ids=seg)
        got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
        again = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
        want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                               segment_ids=seg)
        torch.cuda.synchronize()
        require(o.dtype == f32 and bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
                f"flash_fwd_f32 {label}: dtype or non-finite")
        require(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"flash_fwd_f32 {label}: two calls differ")
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"flash_bwd_f32 {label}: two calls differ")
        o_err = float((o - o_ref).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        require(o_err <= F32_O_TOL and lse_err <= F32_O_TOL, (label, o_err, lse_err))
        worst["flash_fwd_f32"] = max(worst["flash_fwd_f32"], o_err)
        rel = {}
        for name, x, ref in zip(("dq", "dk", "dv"), got, want):
            require(x.dtype == f32 and bool(torch.isfinite(x).all()), (label, name))
            err = float((x - ref).abs().max())
            rel[name] = err / float(ref.abs().max())
            require(rel[name] <= F32_BWD_TOL, (label, name, rel[name]))
            key = "flash_dq_f32" if name == "dq" else "flash_dkv_f32"
            worst[key] = max(worst[key], err)
        log(f"[f32-kernels] flash {label}: B={b} Sq={sq} Skv={skv} H={h} K={kv} D={d} "
            f"causal={causal}: max|o-plain| {o_err:.3e}, max|lse-plain| {lse_err:.3e} "
            f"(tolerance {F32_O_TOL}); dq/dk/dv max error over the gradient's largest "
            f"magnitude {rel['dq']:.3e}/{rel['dk']:.3e}/{rel['dv']:.3e} (tolerance "
            f"{F32_BWD_TOL}); two calls the same bits")
        del q, k, v, o, lse, do, o2, lse2, o_ref, lse_ref, got, again, want
    n = len(cases)
    require((flash.launches_f32, flash.launches_dq_f32, flash.launches_dkv_f32,
             flash.launches, flash.launches_dq) == (2 * n, 2 * n, 2 * n, 0, 0),
            (flash.launches_f32, flash.launches_dq_f32, flash.launches_dkv_f32))

    # Paged: the decode tick, the K3 phase's other cases, and every verify
    # case (the spec tick first), all in f32.
    m = PAGED_MAIN
    starts, lengths = _paged_main_case()
    k3_cases = [
        ("decode tick", m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"], lengths,
         starts),
        ("head_dim 64, page 16", 4, 8, 4, 64, 16, 8, [0, 5, 38, 50], [0, 0, 32, 45]),
        ("split edges", 4, 32, 8, 128, 16, 16, [257, 256, 513, 140], [257, 250, 500, 128]),
    ]
    worst.update({"paged_tail_f32": 0.0, "paged_f32": 0.0, "paged_verify_f32": 0.0})
    paged.reset_launches()

    def check(name, label, o, o2, r, sp):
        require(o.dtype == f32 and bool(torch.isfinite(o).all()), (name, label))
        require(torch.equal(o, o2), f"{name} {label}: two calls differ")
        err = float((o - r).abs().max())
        err_split = float((o - sp).abs().max())
        require(err <= F32_PAGED_TOL and err_split <= F32_PAGED_TOL, (name, label, err,
                                                                      err_split))
        worst[name] = max(worst[name], err)
        return f"{name} max|o-plain| {err:.3e}, max|o-split plain| {err_split:.3e}"

    for i, (label, b, h, kv, d, ps, tl, lens, sts) in enumerate(k3_cases):
        q, kp, vp, table, ln, st, tk, tv = _paged_inputs(b, h, kv, d, ps, tl, lens, sts,
                                                         seed=950 + i, n_pool=128, dtype=f32)
        tail = dict(tail_k=tk, tail_v=tv, starts=st)
        low = torch.minimum(st, ln).contiguous()
        o3, o3b = (paged.paged_attention(q, kp, vp, table, ln, **tail) for _ in range(2))
        o4, o4b = (paged.paged_attention(q, kp, vp, table, low) for _ in range(2))
        r3 = paged.paged_attention_plain(q, kp, vp, table, ln, tk, tv, st)
        s3 = paged.paged_attention_split_plain(q, kp, vp, table, ln, tk, tv, st)
        r4 = paged.paged_attention_plain(q, kp, vp, table, low)
        s4 = paged.paged_attention_split_plain(q, kp, vp, table, low)
        torch.cuda.synchronize()
        dead = [j for j, n_ in enumerate(lens) if n_ == 0]
        require(all(bool((o3[j] == 0).all()) for j in dead), "paged_tail_f32: dead slot")
        log(f"[f32-kernels] paged {label}: B={b} H={h} K={kv} D={d} ps={ps} T={tl}: "
            f"{check('paged_tail_f32', label, o3, o3b, r3, s3)}; "
            f"{check('paged_f32', label, o4, o4b, r4, s4)} (tolerance {F32_PAGED_TOL}); "
            f"two calls the same bits")
    n_verify = 0
    for i, (label, b, nq, h, kv, d, ps, tl, lens, sts, maxp) in enumerate(_verify_cases()):
        q, kp, vp, table, ln, st, tk, tv = _paged_inputs(b, h, kv, d, ps, tl, lens, sts,
                                                         seed=970 + i, n_pool=128, nq=nq,
                                                         maxp=maxp, share=b > 2, dtype=f32)
        tail = dict(tail_k=tk, tail_v=tv, starts=st)
        o, o2 = (paged.paged_attention(q, kp, vp, table, ln, **tail) for _ in range(2))
        n_verify += 2
        r = paged.paged_attention_plain(q, kp, vp, table, ln, tk, tv, st)
        sp = paged.paged_attention_split_plain(q, kp, vp, table, ln, tk, tv, st)
        o41 = paged.paged_attention(q[:, :1].contiguous(), kp, vp, table, ln, **tail)
        o3 = paged.paged_attention(q[:, 0].contiguous(), kp, vp, table, ln, **tail)
        torch.cuda.synchronize()
        require(torch.equal(o41[:, 0], o3), f"paged_verify_f32 {label}: Q = 1 differs")
        log(f"[f32-kernels] paged verify {label}: B={b} Q={nq} H={h} K={kv} D={d} ps={ps} "
            f"T={tl}: {check('paged_verify_f32', label, o, o2, r, sp)} (tolerance "
            f"{F32_PAGED_TOL}); two calls the same bits, Q = 1 the 3-D call's bits")
    require(paged.launches_verify_f32 == n_verify and paged.launches_f32 == 2 * len(k3_cases)
            and paged.launches_tail == paged.launches_verify == paged.launches == 0,
            (paged.launches_verify_f32, paged.launches_f32))
    worst["paged_f32_direct_launches"] = paged.launches_f32
    return worst


def _ffma_ms(flops: float) -> float:
    return flops / H100_FFMA_FLOPS * 1e3


def phase_f32_timings(flash, paged, train_seg) -> dict:
    """[f32-timing]: each f32 kernel's time by CUDA events (the better of
    two runs), beside its bound (max of bytes at 4 B an element over 3.35
    TB/s and flops over 165 TFLOP/s, 3xTF32; the 67 TFLOP/s FFMA figure
    logged beside), its plain version and the library call on the same f32
    inputs, TF32 off: K1-f32, K2a-f32, K2b-f32 at path 9's batch (B=4,
    S=2048, 14/2 heads, D=64, the pipeline's packed rows) against SDPA given
    the same packed causal mask (forward, ``autograd.grad`` of it), K1-f32
    also at the serving prefill; K3-f32 and K4-f32 at the decode tick,
    K3-f32-verify at the spec tick (CUDA-graph device time over
    ``PAGED_COPIES`` input copies) against SDPA with ``enable_gqa`` over the
    keys gathered beforehand. The SDPA backend the dispatcher picks is
    named."""
    import torch
    import torch.nn.functional as F

    f32 = torch.float32
    out = {}
    # K1-f32 at the serving prefill (logged; the kernels line takes path 9's).
    q, k, v, seg = _attn_inputs(4, 512, 512, 32, 8, 128, seed=980,
                                lengths=[512, 401, 230, 97], dtype=f32)
    mask = torch.ones(512, 512, dtype=torch.bool, device="cuda").tril()[None]
    mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(4, dim=2).transpose(1, 2) for x in (k, v))

    def fwd():
        flash.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)

    ms = min(_time_ms(fwd), _time_ms(fwd))
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    plain_ms = _time_ms(lambda: flash.flash_attention_plain(q, k, v, causal=True,
                                                            segment_ids=seg), iters=5)
    bound_ms, bound_by = _flash_bound(q, k, seg, True)
    flops = 4 * 128 * 32 * _attended_pairs(4, 512, 512, True, seg)
    log(f"[f32-timing] flash_fwd_f32 serving prefill B=4 S=512 H=32 K=8 D=128 causal+seg: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (backend "
        f"{_sdpa_backend(qt, kt, vt, mask, 0.0, False)}), bound {bound_ms:.4f} ms "
        f"({bound_by}; at FFMA's 67 TFLOP/s {_ffma_ms(flops):.4f} ms), {bound_ms / ms:.1%} "
        f"of bound ({SMI})")
    del q, k, v, seg, mask, qt, kt, vt

    # K1-f32, K2a-f32, K2b-f32 at path 9's batch.
    s, causal, seg = 2048, True, train_seg
    q, k, v, o, lse, do = _bwd_inputs(4, s, s, 14, 2, 64, causal, seg, seed=990,
                                      flash=flash, dtype=f32)
    run_dq, run_dkv, keep = _bwd_launchers(flash, q, k, v, o, lse, do, seg, causal)
    mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()[None]
    mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(7, dim=2).transpose(1, 2).detach().requires_grad_()
              for x in (k, v))
    backend = _sdpa_backend(qt, kt, vt, mask, 0.0, False)
    out_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    do_t = do.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def sdpa_bwd():
        torch.autograd.grad(out_t, (qt, kt, vt), grad_outputs=do_t, retain_graph=True)

    def fwd():
        flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)

    plain_bwd_ms = _time_ms(lambda: flash.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal, segment_ids=seg), iters=3, warmup=1)
    plain_fwd_ms = _time_ms(lambda: flash.flash_attention_plain(
        q, k, v, causal=causal, segment_ids=seg), iters=3, warmup=1)
    lib_bwd_ms = min(_time_ms(sdpa_bwd, iters=10), _time_ms(sdpa_bwd, iters=10))
    lib_fwd_ms = min(_time_ms(sdpa_fwd, iters=10), _time_ms(sdpa_fwd, iters=10))
    pairs = _attended_pairs(4, s, s, causal, seg)
    for name, run, plain_ms, lib, kind, products in (
            ("flash_fwd_f32", fwd, plain_fwd_ms, lib_fwd_ms, None, 2),
            ("flash_dq_f32", run_dq, plain_bwd_ms, lib_bwd_ms, "dq", 3),
            ("flash_dkv_f32", run_dkv, plain_bwd_ms, lib_bwd_ms, "dkv", 4)):
        ms = min(_time_ms(run, iters=10), _time_ms(run, iters=10))
        bound_ms, bound_by = (_flash_bound(q, k, seg, causal) if kind is None
                              else _bwd_bound(q, k, seg, causal, kind))
        flops = products * 2 * 64 * 14 * pairs
        log(f"[f32-timing] {name} path 9's batch B=4 S={s} H=14 K=2 D=64 causal, packed "
            f"rows ({int(seg.max())} segments max): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms{'' if kind is None else ' (dq, dk, dv together)'}, sdpa "
            f"{'forward' if kind is None else 'backward, all three grads,'} with the same "
            f"packed causal mask {lib:.4f} ms (backend {backend}; {ms / lib:.2f}x), bound "
            f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, at FFMA's 67 TFLOP/s "
            f"{_ffma_ms(flops):.4f} ms), {bound_ms / ms:.1%} of bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s ({SMI})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib, "library": f"sdpa {backend}"}
    log("[f32-timing] " + _k2_f32_summary(flash, out["flash_dq_f32"]["ms"],
                                          out["flash_dkv_f32"]["ms"], lib_bwd_ms,
                                          plain_bwd_ms, 4, 2, 7, s, 64))
    del keep, q, k, v, o, lse, do, qt, kt, vt, out_t, do_t, mask

    # K3-f32 and K4-f32 at the decode tick.
    m = PAGED_MAIN
    starts, lengths = _paged_main_case()
    copies = [_paged_inputs(m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"],
                            lengths, starts, seed=1000 + c, share=False, dtype=f32)
              for c in range(PAGED_COPIES)]
    for name, tail in (("paged_tail_f32", True), ("paged_f32", False)):
        kernel, plain, library = [], [], []
        for q, kp, vp, table, ln, st, tk, tv in copies:
            if tail:
                qs, kt, vt, mask = _verify_sdpa_inputs(q[:, None], kp, vp, table, ln, st, tk,
                                                       tv)
                kw = dict(tail_k=tk, tail_v=tv, starts=st)
            else:
                b, maxp, ps = q.shape[0], table.shape[1], kp.shape[2]
                kt, vt = (p[table.long()].transpose(2, 3).reshape(b, maxp * ps, m["kv"], m["d"])
                          .transpose(1, 2).contiguous() for p in (kp, vp))
                cols = torch.arange(maxp * ps, device="cuda")
                mask = (cols[None] < ln[:, None])[:, None, None, :]
                qs = q[:, :, None]
                kw = {}
            kernel.append(functools.partial(paged.paged_attention, q, kp, vp, table, ln,
                                            **kw))
            plain.append(functools.partial(paged.paged_attention_plain, q, kp, vp, table,
                                           ln, *kw.values()))
            library.append(functools.partial(F.scaled_dot_product_attention, qs, kt, vt,
                                             attn_mask=mask, enable_gqa=True))
        backend = _sdpa_backend(qs, kt, vt, mask, 0.0, False, enable_gqa=True)
        ms = min(_graph_ms(kernel), _graph_ms(kernel))
        plain_ms = _graph_ms(plain, rounds=1)
        lib_ms = _graph_ms(library)
        q, kp, _, table, ln, st, _, _ = copies[0]
        bound_ms, bound_by = _paged_bound(q, kp, table, ln, st, tail)
        log(f"[f32-timing] {name} decode tick B={m['b']} H={m['h']} K={m['kv']} D={m['d']} "
            f"ps={m['ps']} T={m['tail_len']}, {PAGED_COPIES} input copies in turn: device "
            f"(CUDA graph) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (enable_gqa, "
            f"keys gathered beforehand; backend {backend}) {lib_ms:.4f} ms, kernel / sdpa "
            f"{ms / lib_ms:.2f}x; bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound ({SMI})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms, "library": f"sdpa {backend}"}
    del copies

    # K3-f32-verify at the spec tick.
    sm = SPEC_MAIN
    starts, lengths = _spec_main_case()
    copies = [_paged_inputs(sm["b"], sm["h"], sm["kv"], sm["d"], sm["ps"], sm["tail_len"],
                            lengths, starts, seed=1100 + c, share=False, nq=sm["nq"],
                            maxp=sm["maxp"], dtype=f32) for c in range(PAGED_COPIES)]
    kernel, plain, library = [], [], []
    for q, kp, vp, table, ln, st, tk, tv in copies:
        qs, kt, vt, mask = _verify_sdpa_inputs(q, kp, vp, table, ln, st, tk, tv)
        kernel.append(functools.partial(paged.paged_attention, q, kp, vp, table, ln,
                                        tail_k=tk, tail_v=tv, starts=st))
        plain.append(functools.partial(paged.paged_attention_plain, q, kp, vp, table, ln,
                                       tk, tv, st))
        library.append(functools.partial(F.scaled_dot_product_attention, qs, kt, vt,
                                         attn_mask=mask, enable_gqa=True))
    backend = _sdpa_backend(qs, kt, vt, mask, 0.0, False, enable_gqa=True)
    ms = min(_graph_ms(kernel), _graph_ms(kernel))
    plain_ms = _graph_ms(plain, rounds=1)
    lib_ms = _graph_ms(library)
    q, kp, _, table, ln, st, _, _ = copies[0]
    bound_ms, bound_by = _verify_bound(q, kp.shape[1], table, sm["tail_len"], ln, st, False)
    log(f"[f32-timing] paged_verify_f32 spec tick B={sm['b']} Q={sm['nq']} H={sm['h']} "
        f"K={sm['kv']} D={sm['d']} ps={sm['ps']} T={sm['tail_len']}, {PAGED_COPIES} input "
        f"copies in turn: device (CUDA graph) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa (enable_gqa, per-query mask, keys gathered beforehand; backend {backend}) "
        f"{lib_ms:.4f} ms, kernel / sdpa {ms / lib_ms:.2f}x; bound {bound_ms:.4f} ms "
        f"({bound_by}), {bound_ms / ms:.1%} of bound ({SMI})")
    out["paged_verify_f32"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": lib_ms,
                               "library": f"sdpa {backend}"}
    return out


# float16 kernels (K1-f16, K3-f16, its verify, K4-f16, K3-int8-f16 and its
# verify) and K3 over int8 pools with an f32 q (variant F) beside the other
# kernel phases. (name, dtype, int8 pools, form) of each paged entry point
# that path 11 or 12 runs or that is called directly (K4-f16).
NEW_PAGED = [
    ("paged_tail_f16", "float16", False, "tail"),
    ("paged_f16", "float16", False, "no_tail"),
    ("paged_verify_f16", "float16", False, "verify"),
    ("paged_tail_int8_f16", "float16", True, "tail"),
    ("paged_verify_int8_f16", "float16", True, "verify"),
    ("paged_tail_int8_f32", "float32", True, "tail"),
    ("paged_verify_int8_f32", "float32", True, "verify"),
]
# The single-query cases of the new paged kernels: (label, b, h, kv, d, ps,
# tail_len, lengths, starts); the decode tick, then a ragged head_dim 64
# case (a dead slot, a tail-only slot, an empty tail: starts == lengths) and
# the split edges.
NEW_PAGED_CASES = [
    ("decode tick", PAGED_MAIN["b"], PAGED_MAIN["h"], PAGED_MAIN["kv"], PAGED_MAIN["d"],
     PAGED_MAIN["ps"], PAGED_MAIN["tail_len"], _paged_main_case()[1], _paged_main_case()[0]),
    ("head_dim 64, page 16", 4, 8, 4, 64, 16, 8, [0, 5, 38, 50], [0, 0, 38, 45]),
    ("split edges", 4, 32, 8, 128, 16, 16, [257, 256, 513, 140], [257, 250, 500, 128]),
]
# The verify's cases: ``_verify_cases`` (the spec tick, 72 rows at G = 8,
# ...) and 80 query rows (Q = 10, G = 8), the most the kernels take.
VERIFY_80 = ("80 rows", 2, 10, 16, 2, 128, 64, 40, [300, 77], [290, 64], 5)


def _close(name: str, dtype, o, ref) -> float:
    """``o`` against ``ref``: float16 at ``O_TOL`` (bf16's), f32 within
    ``F32_PAGED_TOL`` of ``ref``'s largest magnitude; returns max|o - ref|."""
    import torch

    err = float((o.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        require(err <= F32_PAGED_TOL * float(ref.abs().max()), (name, err))
    else:
        torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=O_TOL)
    return err


def phase_f16_int8_kernels(flash, paged, train_seg) -> dict:
    """[f16-kernels]: K1-f16 (``ditl_flash_fwd_f16``) against the plain
    forward in float16 (``O_TOL``/``LSE_TOL``) at the serving prefill, the
    training batch's packed rows (forward only), head_dim 64 and 32, causal
    and not, ids up and down, a boundary past a tile edge; the bf16 K1 keeps
    ``K1_DIGESTS`` (the float16 backward has its own phase,
    ``phase_f16_bwd_kernels``). Then each entry point of ``NEW_PAGED`` against the plain
    version and the split twin (``_close``): the single-query forms on
    ``NEW_PAGED_CASES``, the verify forms on ``_verify_cases`` and 80 query
    rows, a 4-D q with Q = 1 the 3-D call's bits. Every kernel called twice
    gives the same bits. Returns the max abs errors and K4-f16's direct-call
    launches."""
    import torch

    f16 = torch.float16
    worst = {"flash_fwd_f16": 0.0}
    cases = [  # (label, b, s_q, s_kv, h, kv, d, causal, ids)
        ("serving prefill, right-padded", 4, 512, 512, 32, 8, 128, True,
         [512, 401, 230, 97]),
        ("training batch, packed rows", 4, 2048, 2048, 32, 8, 128, True, "train"),
        ("head_dim 64, ids up and down", 2, 300, 300, 8, 2, 64, True, "nonmono"),
        ("head_dim 64, packed, S % 64 != 0", 2, 333, 333, 8, 2, 64, True, "packed"),
        ("head_dim 32, non-causal, Sq != Skv", 2, 200, 333, 8, 4, 32, False, None),
        ("head_dim 32, boundary past a tile edge", 1, 257, 257, 4, 2, 32, True, "edge1"),
        ("head_dim 128, non-causal, ids up and down", 2, 300, 300, 8, 2, 128, False,
         "nonmono"),
    ]
    flash.reset_launches()
    for i, (label, b, sq, skv, h, kv, d, causal, spec) in enumerate(cases):
        q, k, v, _ = _attn_inputs(b, sq, skv, h, kv, d, seed=1300 + i, dtype=f16)
        seg = _bwd_segment_ids(spec, b, sq, train_seg)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
        o2, lse2 = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
        o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal=causal, segment_ids=seg)
        torch.cuda.synchronize()
        require(o.dtype == f16 and bool(torch.isfinite(o.float()).all()
                                        and torch.isfinite(lse).all()),
                f"flash_fwd_f16 {label}: dtype or non-finite")
        require(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"flash_fwd_f16 {label}: two calls differ")
        torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=LSE_TOL)
        err = float((o.float() - o_ref.float()).abs().max())
        worst["flash_fwd_f16"] = max(worst["flash_fwd_f16"], err)
        log(f"[f16-kernels] flash {label}: B={b} Sq={sq} Skv={skv} H={h} K={kv} D={d} "
            f"causal={causal}: max|o-plain| {err:.3e}, max|lse-plain| "
            f"{float((lse - lse_ref).abs().max()):.3e} (tolerance {O_TOL} / {LSE_TOL}); "
            f"two calls the same bits")
        del q, k, v, o, lse, o2, lse2, o_ref, lse_ref
    require((flash.launches_f16, flash.launches, flash.launches_dq, flash.launches_dkv)
            == (2 * len(cases), 0, 0, 0), (flash.launches_f16, flash.launches))
    digests = _k1_digests(flash)
    for key, value in digests.items():
        log(f"[f16-kernels] bf16 K1 digest {key}: {value} (expected {K1_DIGESTS.get(key)})")
    require(digests == K1_DIGESTS, "the bf16 K1 differs from the earlier build's bits")

    errors, counts = _check_paged_entries(
        paged, NEW_PAGED, NEW_PAGED_CASES, _verify_cases() + [VERIFY_80], 1400,
        lambda dtype: "f16-kernels" if dtype == f16 else "f32-int8-kernels")
    worst.update(errors)
    worst["paged_f16_direct_launches"] = counts["paged_f16"]
    return worst


def _counter(name: str) -> str:
    """The launch counter of a kernels-line paged name (``paged_tail_f16``
    -> ``launches_tail_f16``, ``paged_f16`` -> ``launches_f16``, ``paged`` ->
    ``launches``)."""
    return "launches" + name[len("paged"):]


def phase_f16_int8_timings(flash, paged, train_seg) -> dict:
    """[f16-timing] and [f32-int8-timing]: each new kernel's time (the better
    of two runs), its plain version's and the library call's on the same
    inputs, beside its bound from this run's inputs (bytes at their element
    sizes over 3.35 TB/s, flops over 989 TFLOP/s for float16 or 165 TFLOP/s
    3xTF32 for f32; FFMA's 67 TFLOP/s logged beside for F): K1-f16 at the
    serving prefill (B=4, S=512, 32/8 heads, D=128, right-padded) and on the
    training batch's packed rows, CUDA events, against SDPA in float16 with
    the same mask; the paged kernels of ``NEW_PAGED`` at the decode tick
    (single-query) or the spec tick (verify), CUDA-graph device time over
    ``PAGED_COPIES`` input copies, against SDPA (``enable_gqa``) over the
    keys gathered (int8: and dequantized to q's dtype) beforehand with the
    plain version's mask, the gather timed apart."""
    import torch
    import torch.nn.functional as F

    f16 = torch.float16
    out = {}
    for label, b, s, seg in (("serving prefill", 4, 512, [512, 401, 230, 97]),
                             ("training batch, packed rows", 4, 2048, "train")):
        q, k, v, _ = _attn_inputs(b, s, s, 32, 8, 128, seed=1500, dtype=f16)
        seg = _bwd_segment_ids(seg, b, s, train_seg)
        mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()[None]
        mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(4, dim=2).transpose(1, 2) for x in (k, v))

        def fwd():
            flash.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)

        def sdpa():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        ms = min(_time_ms(fwd), _time_ms(fwd))
        lib_ms = min(_time_ms(sdpa), _time_ms(sdpa))
        plain_ms = _time_ms(lambda: flash.flash_attention_plain(
            q, k, v, causal=True, segment_ids=seg), iters=3, warmup=1)
        bound_ms, bound_by = _flash_bound(q, k, seg, True)
        backend = _sdpa_backend(qt, kt, vt, mask, 0.0, False)
        log(f"[f16-timing] flash_fwd_f16 {label} B={b} S={s} H=32 K=8 D=128 causal+seg: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (float16, same mask; "
            f"backend {backend}) {lib_ms:.4f} ms, kernel / sdpa {ms / lib_ms:.2f}x, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound ({SMI})")
        out.setdefault("flash_fwd_f16", {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library": f"sdpa {backend}"})
        del q, k, v, seg, mask, qt, kt, vt

    for name, dtype_name, int8, form in NEW_PAGED:
        tag = "f16-timing" if dtype_name == "float16" else "f32-int8-timing"
        m = SPEC_MAIN if form == "verify" else PAGED_MAIN
        out[name] = _time_paged(paged, name, dtype_name, int8, form, m, tag)
    return out


def _time_paged(paged, name: str, dtype_name: str, int8: bool, form: str, m: dict,
                tag: str) -> dict:
    """One paged entry point's timing at the decode tick (``m``: b, h, kv, d,
    ps, tail_len) or, for the verify, the spec tick (also nq, maxp), with
    ``_paged_main_case``'s or ``_spec_main_case``'s ragged state: the kernel
    (CUDA-graph device time over ``PAGED_COPIES`` input copies, the better of
    two runs), the plain version, SDPA (``enable_gqa``) over the keys
    gathered (int8: and dequantized to q's dtype) beforehand with the plain
    version's mask, the gather timed apart, and the bound from the first
    copy's inputs."""
    import torch
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    starts, lengths = _spec_main_case() if form == "verify" else _paged_main_case()
    kernel, plain, library, gather = [], [], [], []
    for c in range(PAGED_COPIES):
        q, kp, vp, table, ln, st, tk, tv = _paged_inputs(
            m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"], lengths, starts,
            seed=1600 + c, share=False, nq=m.get("nq") if form == "verify" else None,
            maxp=m.get("maxp"), dtype=dtype)
        scales = {}
        if int8:
            kp, vp, ks, vs = _int8_pools(kp, vp)
            scales = dict(k_scale=ks, v_scale=vs)
        if form == "no_tail":
            ln = torch.minimum(st, ln).contiguous()
            kw, args = {}, (q, kp, vp, table, ln)
            b, maxp, ps = q.shape[0], table.shape[1], kp.shape[2]
            kt, vt = (p_[table.long()].transpose(2, 3).reshape(b, maxp * ps, m["kv"],
                                                               m["d"])
                      .transpose(1, 2).contiguous() for p_ in (kp, vp))
            cols = torch.arange(maxp * ps, device="cuda")
            qs, mask = q[:, :, None], (cols[None] < ln[:, None])[:, None, None, :]
            gather.append(lambda: None)
        else:
            kw = dict(tail_k=tk, tail_v=tv, starts=st, **scales)
            args = (q, kp, vp, table, ln, tk, tv, st, *scales.values())
            q4 = q if form == "verify" else q[:, None]
            qs, kt, vt, mask = _verify_sdpa_inputs(q4, kp, vp, table, ln, st, tk, tv,
                                                   **scales)
            gather.append(functools.partial(_verify_sdpa_inputs, q4, kp, vp, table, ln,
                                            st, tk, tv, **scales))
        if c == 0:  # the bound's inputs
            first = (q, kp, table, ln, st)
        kernel.append(functools.partial(paged.paged_attention, q, kp, vp, table, ln,
                                        **kw))
        plain.append(functools.partial(paged.paged_attention_plain, *args))
        library.append(functools.partial(F.scaled_dot_product_attention, qs, kt, vt,
                                         attn_mask=mask, enable_gqa=True))
    backend = _sdpa_backend(qs, kt, vt, mask, 0.0, False, enable_gqa=True)
    ms = min(_graph_ms(kernel), _graph_ms(kernel))
    plain_ms = _graph_ms(plain, rounds=1)
    lib_ms = _graph_ms(library)
    gather_ms = None if form == "no_tail" else _graph_ms(gather, rounds=1)
    q, kp, table, ln, st = first
    if form == "verify":
        bound_ms, bound_by = _verify_bound(q, kp.shape[1], table, m["tail_len"], ln, st,
                                           int8)
    elif int8:
        bound_ms, bound_by = _paged_int8_bound(q, kp, table, ln, st)
    else:
        bound_ms, bound_by = _paged_bound(q, kp, table, ln, st, form == "tail")
    shape = (f"spec tick B={m['b']} Q={m['nq']}" if form == "verify"
             else f"decode tick B={m['b']}")
    gathered = "" if gather_ms is None else (
        f", the gather{' and dequantization' if int8 else ''} itself {gather_ms:.4f} ms")
    log(f"[{tag}] {name} {shape} H={m['h']} K={m['kv']} D={m['d']} ps={m['ps']} "
        f"T={m['tail_len']}, {PAGED_COPIES} input copies in turn: device (CUDA graph) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa ({dtype_name}, enable_gqa, "
        f"the plain version's mask, keys gathered{' and dequantized' if int8 else ''} "
        f"beforehand; backend {backend}) {lib_ms:.4f} ms{gathered}, kernel / sdpa "
        f"{ms / lib_ms:.2f}x; bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.1%} of bound ({SMI})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library": f"sdpa {backend}", "gather_ms": gather_ms}


def phase_dtype_serve(flash, paged, dtype: str, kv_int8: bool = False,
                      f32_pools: float | None = None) -> dict:
    """Main path 8 (f32 serving: ``infer/server.py --preset llama3-8b
    --override attention_impl=flash --override dtype=float32``), path 11
    (the same plus ``--kv-quant int8``) or path 12 (``--override
    dtype=float16``) at full width and depth (weights seed-initialised):
    lock-step on path 1's five requests (K1-f32 or K1-f16 on every
    prefill), then the continuous engine on path 2's 12 requests (K1 on
    every cold prefill, K3-f32, K3-int8-f32 or K3-f16 on every decode step);
    decode ms a step, time to first token and tokens/s beside the
    weight-read bound, pool bytes (path 11: against path 8's ``f32_pools``),
    peak memory; one decode step's logits against the plain version's;
    greedy tokens of both engines against the same requests through the
    plain versions (identical, or a near-tie by ``_tie_check``). Returns the
    launch counts and the pool bytes."""
    import torch

    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.infer.engine import GenerateConfig

    sfx, prefix = DTYPE_SFX[dtype]
    tag = prefix + ("int8-serve" if kv_int8 else "serve")
    torch.cuda.reset_peak_memory_stats()
    gen, lockstep = phase_serve(flash, paged, dtype, kv_int8)
    cfg, tok = gen.cfg, gen.tokenizer
    weight_bytes = sum(t.numel() * t.element_size() for key, sub in gen.params.items()
                       if key != "embed" for t in _tensors(sub))
    continuous, summary = phase_serve_continuous(gen, flash, paged)
    pools = summary["pool_bytes"]
    against = ("" if f32_pools is None else
               f" ({pools / f32_pools:.3f}x path 8's f32 pools, {f32_pools / 1e9:.3f} GB)")
    log(f"[{tag}] continuous decode {summary['ms_step']:.2f} ms a step against the "
        f"{dtype} weight-read bound {weight_bytes / H100_BYTES_PER_S * 1e3:.2f} ms "
        f"({weight_bytes / 1e9:.2f} GB a step at 3.35 TB/s), {summary['tokens_s']:.1f} "
        f"tokens/s, time to first token {summary['ttft_s'] * 1e3:.1f} ms, pools "
        f"{pools / 1e9:.3f} GB{against}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({SMI})")

    # The same greedy requests through the plain versions (flash's forward
    # and paged attention rebound, looked up at call time): the continuous
    # engine's, then the lock-step Generator's.
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    keys = sorted({(tuple([tok.bos_id] + tok.encode(p["prompt"])), p["max_tokens"])
                   for p in _continuous_requests()[0] if not p.get("temperature")})
    fwd, wrapper = flash.flash_attention_fwd, paged.paged_attention
    flash.flash_attention_fwd = flash.flash_attention_plain
    paged.paged_attention = paged.paged_attention_plain
    try:
        plain_engine = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                                        max_cache_len=2048, cache_mode="paged",
                                        page_size=256, device="cuda")
        rid = {plain_engine.submit(list(ids), max_new_tokens=n): (ids, n) for ids, n in keys}
        plain_out = plain_engine.run()
        del plain_engine
        lock_prompts = [[tok.bos_id] + tok.encode(_text(0, 100)),
                        [tok.bos_id] + tok.encode(_text(3, 400))]
        lock_plain = [gen.generate_tokens([ids], GenerateConfig(max_new_tokens=16))[0]
                      for ids in lock_prompts]
    finally:
        flash.flash_attention_fwd, paged.paged_attention = fwd, wrapper
    flash.reset_launches()
    lock_kernel = [gen.generate_tokens([ids], GenerateConfig(max_new_tokens=16))[0]
                   for ids in lock_prompts]
    require(getattr(flash, "launches" + sfx) == cfg.num_layers * len(lock_prompts),
            getattr(flash, "launches" + sfx))
    plain_of = {rid[r]: toks for r, toks in plain_out.items()}
    pairs = [(list(ids), outs, plain_of[(ids, n)]) for (ids, n) in keys
             for outs in summary["outputs"][(ids, n)]]
    _check_against(gen, cfg, pairs, tag.replace("serve", "continuous"))
    _check_against(gen, cfg, list(zip(lock_prompts, lock_kernel, lock_plain)), tag)
    out = {k: lockstep.get(k, 0) + continuous.get(k, 0) for k in {**lockstep, **continuous}}
    out["pool_bytes"] = pools
    return out


def phase_dtype_train(flash, mlp_bwd, proj, args=F32_TRAIN_ARGS, tag: str = "f32-train"
                      ) -> dict:
    """Main path 9 (``F32_TRAIN_ARGS``), 10 (``F32_KERNEL_ARGS``) or 13
    (``F16_KERNEL_ARGS``): ``train()`` on qwen2-0.5b at its published size
    (24 layers, hidden 896, MLP 4864, 14/2 heads, D = 64, vocab 151936, tied
    embeddings, q/k/v biases; f32 masters, f32 or float16 compute, flash
    attention, full remat, adafactor, the fused loss), B=4, S=2048 packed
    rows of the synthetic corpus, ``F32_TRAIN_STEPS`` steps; path 9 at the
    "xla" MLP and projection backward, paths 10 and 13 under
    ``KERNEL_FLAGS`` with the block fields that take them. Finite, falling
    losses; per step, in the compute dtype's kernels, K1 2 x 24 (forward
    and recompute), K2a and K2b 24, and K5a and K5b 24 and K6 96 (wq, wk,
    wv, wo) under the flags, 0 on path 9; no kernel of another dtype; step
    p50, tokens/s, MFU over the dtype's peak (495 TFLOP/s TF32 for f32, the
    card's fastest f32-input rate; 989 TFLOP/s dense float16), peak memory.
    Returns the launch counts."""
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.ops import mlp as mlp_op
    from ditl_tpu_torch.train.trainer import train

    config, device = build_config(args)
    cfg = config.model
    sfx, prefix = DTYPE_SFX[cfg.dtype]
    kernels = cfg.mlp_bwd_impl == "pallas"
    impl = ("pallas", "pallas", True, 256, 128) if kernels else ("xla", "xla", False, 0, 0)
    require((cfg.name, cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
             cfg.vocab_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.tie_embeddings, cfg.attention_bias, cfg.param_dtype,
             cfg.attention_impl, cfg.remat, config.train.optimizer, device)
            == ("qwen2-0.5b", 24, 896, 4864, 151936, 14, 2, 64, True, True,
                "float32", "flash", "full", "adafactor", "cuda")
            and cfg.dtype in ("float32", "float16")
            and (cfg.mlp_bwd_impl, cfg.proj_bwd_impl, cfg.fused_gate_up,
                 cfg.mlp_bwd_block_f, cfg.proj_bwd_block_d) == impl, config)
    b, s = config.data.batch_size, config.data.seq_len
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    mlp_blocks = (cfg.mlp_bwd_block_n, cfg.mlp_bwd_block_f, cfg.mlp_bwd_block_d)
    proj_blocks = (cfg.proj_bwd_block_n, cfg.proj_bwd_block_d)
    require(mlp_op.effective_bwd_impl(cfg.mlp_bwd_impl, b, s, d, f, mlp_blocks)
            == cfg.mlp_bwd_impl and all(
                proj.effective_bwd_impl(cfg.proj_bwd_impl, b, s, i, o, proj_blocks)
                == cfg.proj_bwd_impl for i, o in ((d, cfg.num_heads * hd),
                                                  (d, cfg.num_kv_heads * hd),
                                                  (cfg.num_heads * hd, d))),
            f"{tag}: the MLP and projections take {cfg.mlp_bwd_impl}")
    names = {"flash_fwd": (flash, "launches"), "flash_dq": (flash, "launches_dq"),
             "flash_dkv": (flash, "launches_dkv"), "mlp_dgu_dwdown": (mlp_bwd, "launches_dgu"),
             "mlp_dh_dwgu": (mlp_bwd, "launches_dh"), "proj_bwd": (proj, "launches")}
    flash.reset_launches()  # this path's counts start here
    mlp_bwd.reset_launches()
    proj.reset_launches()
    summary = train(config, device=device)
    launches = {k + sfx: getattr(m, c + sfx) for k, (m, c) in names.items()}
    others = {k + o: getattr(m, c + o) for k, (m, c) in names.items()  # read right after
              for o in ("", "_f16", "_f32") if o != sfx}
    losses = summary["losses"]
    require(summary["steps"] == F32_TRAIN_STEPS and len(losses) == F32_TRAIN_STEPS, summary)
    require(all(x == x and abs(x) != float("inf") for x in losses), losses)
    require(losses[-1] < losses[0], losses)
    layers, steps = cfg.num_layers, F32_TRAIN_STEPS
    k5 = layers * steps if kernels else 0
    want = {"flash_fwd" + sfx: 2 * layers * steps, "flash_dq" + sfx: layers * steps,
            "flash_dkv" + sfx: layers * steps, "mlp_dgu_dwdown" + sfx: k5,
            "mlp_dh_dwgu" + sfx: k5, "proj_bwd" + sfx: 4 * k5}
    require(launches == want and set(others.values()) == {0}, (launches, want, others))
    step_s = summary["step_time_p50_s"]
    tps = summary["tokens_per_sec_per_chip_p50"]
    f32 = cfg.dtype == "float32"
    peak = H100_TF32_FLOPS if f32 else H100_BF16_FLOPS
    mfu = _model_flops_per_token(cfg, config.data.seq_len) * 3 * tps / peak
    flags = (" under fused_gate_up, mlp_bwd_impl=pallas, proj_bwd_impl=pallas, "
             "mlp_bwd_block_f=256, proj_bwd_block_d=128") if kernels else ""
    compute = "f32 masters and compute" if f32 else "f32 masters, float16 compute"
    peak_text = ("the 495 TFLOP/s TF32 peak, the card's fastest f32-input rate" if f32
                 else "989 TFLOP/s dense float16")
    log(f"[{tag}] qwen2-0.5b ({summary['params_m']:.1f}M parameters, {compute}, adafactor, "
        f"flash, fused loss, full remat){flags} B=4 S=2048, {steps} steps: losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[{tag}] step time p50 {step_s:.3f} s, {tps:.1f} tokens/s, MFU {mfu:.1%} "
        f"(bench.py's flops per token x 3 over {peak_text}; remat not counted), peak device "
        f"memory {summary['peak_device_memory_gib']:.2f} GiB, wall {summary['wall_s']:.1f} s "
        f"({SMI})")
    k = prefix.rstrip("-")
    log(f"[{tag}] launches: K1-{k} {launches['flash_fwd' + sfx]} = 2 x {layers} layers x "
        f"{steps} steps (forward + remat recompute), K2a-{k} {launches['flash_dq' + sfx]} and "
        f"K2b-{k} {launches['flash_dkv' + sfx]} = {layers} x {steps}, K5a-{k} "
        f"{launches['mlp_dgu_dwdown' + sfx]}, K5b-{k} {launches['mlp_dh_dwgu' + sfx]}, K6-{k} "
        f"{launches['proj_bwd' + sfx]} (4 a layer); other dtypes' kernels all 0")
    return launches


# ---------------------------------------------------------------------------
# K5a-f32, K5b-f32 and K6-f32 (csrc/gemm_f32.cu), path 10 (f32 training under
# the kernel flags)
# ---------------------------------------------------------------------------

# (label, N, D, F) of path 10's MLP (qwen2-0.5b, N = 4 x 2048) and ragged
# ones: N = 16 x 129 (d_w_down split over the tokens), the least N, D and F
# odd multiples of 128, and N = 2000 (no multiple of K5b-f32's 128-row tiles
# or 32-token k-tiles) with 2F = 1280.
F32_MLP_CASES = [("path 10", 8192, 896, 4864), ("ragged", 2064, 384, 384),
                 ("N = 16", 16, 384, 384), ("ragged N = 2000", 2000, 384, 640),
                 ("ragged N = 2000, F = 600", 2000, 384, 600)]
# (label, N, D, F, row stride of g or 0, the reference's blocks that admit
# N, or None for a shape ``supports`` refuses, which calls ``proj_bwd_rows``
# directly): path 10's wq/wo (dw split in 3) and wk/wv (dw split in 8), a
# ragged N with g a column slice of a wider gradient, and N = 2000 (no
# multiple of the 128-row tiles or the 32-token k-tiles) with F = 600 (dx's
# contraction and dw's columns end mid-tile).
F32_PROJ_CASES = [("wq/wo", 8192, 896, 896, 0, (0, 128)),
                  ("wk/wv", 8192, 896, 128, 0, (0, 128)),
                  ("ragged, strided g", 2064, 256, 384, 512, (16, 128)),
                  ("ragged N = 2000, F = 600", 2000, 384, 600, 0, None)]


def phase_f32_mm_kernels(mlp_bwd, proj) -> dict:
    """[f32-mm-kernels]: K5a-f32 and K5b-f32 (K5b-f32 fed the kernel's own
    dgu, and its plain version the same buffer) at ``F32_MLP_CASES`` and
    K6-f32 at ``F32_PROJ_CASES`` against their plain versions in f32, TF32
    off (``F32_MM_TOL``); at path 10's shapes each called twice, which must
    give the same bits; then the bf16 K5a/K5b against ``K5_DIGESTS`` again.
    Returns the largest absolute errors."""
    import torch

    tag = "f32-mm-kernels"
    worst = {"mlp_dgu_dwdown_f32": 0.0, "mlp_dh_dwgu_f32": 0.0, "proj_bwd_f32": 0.0}
    for i, (label, n, d, f) in enumerate(F32_MLP_CASES):
        h, w_gu, w_down, gu, g = _mlp_case(n, d, f, 1100 + 10 * i, torch.float32)
        gate, up = gu.chunk(2, dim=-1)  # views of gu, as the op saves them
        mlp_bwd.reset_launches()
        dgu, d_w_down = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
        dh, d_w_gu = mlp_bwd.dh_dwgu(h, dgu, w_gu)
        require((mlp_bwd.launches_dgu_f32, mlp_bwd.launches_dh_f32, mlp_bwd.launches_dgu,
                 mlp_bwd.launches_dh) == (1, 1, 0, 0), "K5 f32 launch counts")
        dgu_ref, d_w_down_ref = mlp_bwd.dgu_dwdown_plain(g, w_down, gate, up)
        dh_ref, d_w_gu_ref = mlp_bwd.dh_dwgu_plain(h, dgu, w_gu)
        torch.cuda.synchronize()
        splits = mlp_bwd.f32_dwdown_splits(f, d, n)[0], mlp_bwd.f32_weight_splits(d, 2 * f, n)[0]
        shape = f"N={n} D={d} F={f} ({label}; weight gradients split {splits[0]}, {splits[1]})"
        worst["mlp_dgu_dwdown_f32"] = max(worst["mlp_dgu_dwdown_f32"], _check_scaled(
            f"mlp_dgu_dwdown_f32 {shape}", [("dgu", dgu, dgu_ref),
                                            ("d_w_down", d_w_down, d_w_down_ref)],
            F32_MM_TOL, tag))
        worst["mlp_dh_dwgu_f32"] = max(worst["mlp_dh_dwgu_f32"], _check_scaled(
            f"mlp_dh_dwgu_f32 {shape}", [("dh", dh, dh_ref), ("d_w_gu", d_w_gu, d_w_gu_ref)],
            F32_MM_TOL, tag))
        if i == 0:  # a second call: the same bits
            dgu2, d_w_down2 = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
            dh2, d_w_gu2 = mlp_bwd.dh_dwgu(h, dgu2, w_gu)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in ((dgu, dgu2), (d_w_down, d_w_down2),
                                                   (dh, dh2), (d_w_gu, d_w_gu2))]
            require(all(same), f"K5 f32 {shape}: a second call gave other bits {same}")
            log(f"[{tag}] mlp_dgu_dwdown_f32, mlp_dh_dwgu_f32 {shape}: a second call gives "
                f"the same bits (dgu, d_w_down, dh, d_w_gu)")
            del dgu2, d_w_down2, dh2, d_w_gu2
        del h, w_gu, w_down, gu, g, gate, up, dgu, dgu_ref, dh, dh_ref, d_w_gu, d_w_gu_ref
    for i, (label, n, d, f, ld, blocks) in enumerate(F32_PROJ_CASES):
        x, w, g = _proj_case(n, d, f, ld, 1200 + 10 * i, torch.float32)
        proj.reset_launches()
        if blocks is None:  # a shape supports refuses: the rows entry
            def run():
                return proj.proj_bwd_rows(x.reshape(n, d), w, g.reshape(n, f))
        else:
            def run():
                return proj.projection_bwd(x, w, g, blocks=blocks)
        (dx, dw), again = run(), run()
        require((proj.launches_f32, proj.launches) == (2, 0), "K6 f32 launch counts")
        dx_ref, dw_ref = proj.projection_bwd_plain(x, w, g)
        torch.cuda.synchronize()
        shape = f"N={n} D={d} F={f} ({label}; dw split {_k6_f32_splits(mlp_bwd, n, d, f)[0]})"
        worst["proj_bwd_f32"] = max(worst["proj_bwd_f32"], _check_scaled(
            f"proj_bwd_f32 {shape}", [("dx", dx, dx_ref.reshape(dx.shape)), ("dw", dw, dw_ref)],
            F32_MM_TOL, tag))
        require(torch.equal(dx, again[0]) and torch.equal(dw, again[1]),
                f"proj_bwd_f32 {label}: a second call gave other bits")
        log(f"[{tag}] proj_bwd_f32 {shape}: a second call gives the same bits")
        del x, w, g, dx, dw, dx_ref, dw_ref, again
    digests = _k5_digests(mlp_bwd)
    require(digests == K5_DIGESTS, "K5a/K5b outputs differ from the earlier build's bits")
    log(f"[{tag}] the bf16 K5a and K5b still give K5_DIGESTS' bits")
    return worst


def phase_f32_mm_timings(mlp_bwd, proj) -> dict:
    """[f32-mm-timing]: K5a-f32, K5b-f32 and K6-f32 at path 10's shapes:
    CUDA events over 10 back-to-back calls, the better of two runs; the
    plain versions; cuBLAS's SGEMM (TF32 off) on each kernel's own two
    products; the library yardstick of the bf16 rows (the port never calls
    it): ``torch.autograd.grad`` of the plain MLP forward for K5a and K5b
    together, of ``x @ w`` for K6; the bounds from these shapes (4 bytes an
    element, 165 TFLOP/s) and the rates."""
    import torch
    import torch.nn.functional as F

    out = {}
    tag = "f32-mm-timing"
    _, n, d, f = F32_MLP_CASES[0]
    h, w_gu, w_down, gu, g = _mlp_case(n, d, f, 1300, torch.float32)
    gate, up = gu.chunk(2, dim=-1)
    dgu, _ = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
    leaves = [t.detach().clone().requires_grad_() for t in (h, w_gu, w_down)]
    gate_l, up_l = (leaves[0] @ leaves[1]).chunk(2, dim=-1)
    mlp_out = (F.silu(gate_l) * up_l) @ leaves[2]

    def library():
        torch.autograd.grad(mlp_out, leaves, grad_outputs=g, retain_graph=True)

    lib_ms = min(_time_ms(library, iters=10), _time_ms(library, iters=10))
    bounds = _mlp_bounds(n, d, f, es=4)
    flops = {"mlp_dgu_dwdown_f32": 4.0 * n * d * f, "mlp_dh_dwgu_f32": 8.0 * n * d * f}
    inner = gate * torch.sigmoid(gate) * up
    sgemm = {"mlp_dgu_dwdown_f32": lambda: (g @ w_down.T, inner.T @ g),
             "mlp_dh_dwgu_f32": lambda: (dgu @ w_gu.T, h.T @ dgu)}
    products = {"mlp_dgu_dwdown_f32": "g @ w_down.T, inner.T @ g",
                "mlp_dh_dwgu_f32": "dgu @ w_gu.T, h.T @ dgu"}
    for name, run, plain in (
            ("mlp_dgu_dwdown_f32", lambda: mlp_bwd.dgu_dwdown(g, w_down, gate, up),
             lambda: mlp_bwd.dgu_dwdown_plain(g, w_down, gate, up)),
            ("mlp_dh_dwgu_f32", lambda: mlp_bwd.dh_dwgu(h, dgu, w_gu),
             lambda: mlp_bwd.dh_dwgu_plain(h, dgu, w_gu))):
        ms = min(_time_ms(run, iters=10), _time_ms(run, iters=10))
        plain_ms = _time_ms(plain, iters=3, warmup=1)
        sgemm_ms = min(_time_ms(sgemm[name], iters=10), _time_ms(sgemm[name], iters=10))
        bound_ms, bound_by = bounds[name]
        fl = flops[name]
        split = (mlp_bwd.f32_dwdown_splits(f, d, n) if name == "mlp_dgu_dwdown_f32"
                 else mlp_bwd.f32_weight_splits(d, 2 * f, n))[0]
        log(f"[{tag}] {name} N={n} D={d} F={f} (weight gradient split {split}): kernel "
            f"{ms:.4f} ms ({fl / ms / 1e9:.1f} "
            f"TFLOP/s), plain {plain_ms:.4f} ms, cuBLAS SGEMM on its own two products "
            f"({products[name]}; TF32 off) {sgemm_ms:.4f} ms ({fl / sgemm_ms / 1e9:.1f} "
            f"TFLOP/s; kernel / SGEMM {ms / sgemm_ms:.2f}x), library (autograd of the plain "
            f"MLP forward, dh, d_w_gu and d_w_down together) {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {fl / 1e9:.1f} GFLOP, at FFMA's 67 TFLOP/s "
            f"{_ffma_ms(fl):.4f} ms), {bound_ms / ms:.1%} of bound ({SMI})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms, "sgemm_ms": sgemm_ms}
    # K5a-f32 with d_w_down as f32_dwdown_splits splits it and unsplit, in
    # turns (split, unsplit, unsplit, split).
    rule = mlp_bwd.f32_dwdown_splits
    times = {"split": [], "unsplit": []}
    try:
        for label in ("split", "unsplit", "unsplit", "split"):
            mlp_bwd.f32_dwdown_splits = rule if label == "split" else (lambda m_, n_, k_: (1, k_))
            times[label].append(_time_ms(lambda: mlp_bwd.dgu_dwdown(g, w_down, gate, up),
                                         iters=10))
    finally:
        mlp_bwd.f32_dwdown_splits = rule
    log(f"[{tag}] mlp_dgu_dwdown_f32 with d_w_down split {rule(f, d, n)[0]} ways "
        f"{min(times['split']):.4f} ms, unsplit {min(times['unsplit']):.4f} ms (each the better "
        f"of two runs of 10 calls, in turns; {SMI})")
    out["mlp_dgu_dwdown_f32"]["unsplit_ms"] = min(times["unsplit"])
    log(f"[{tag}] K5a-f32 + K5b-f32 "
        f"{out['mlp_dgu_dwdown_f32']['ms'] + out['mlp_dh_dwgu_f32']['ms']:.4f} ms against "
        f"the library call's {lib_ms:.4f} ms ({SMI})")
    del h, w_gu, w_down, gu, g, gate, up, dgu, leaves, gate_l, up_l, mlp_out, inner
    for label, n, d, f, ld, blocks in F32_PROJ_CASES[:2]:
        x, w, g = _proj_case(n, d, f, 0, 1400, torch.float32)
        xl, wl = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
        y = xl @ wl

        def run():
            proj.projection_bwd(x, w, g, blocks=blocks)

        ms = min(_time_ms(run, iters=10), _time_ms(run, iters=10))
        plain_ms = _time_ms(lambda: proj.projection_bwd_plain(x, w, g), iters=3, warmup=1)
        lib_ms = min(_time_ms(lambda: torch.autograd.grad(y, (xl, wl), grad_outputs=g,
                                                          retain_graph=True), iters=10)
                     for _ in range(2))
        g2, x2 = g.reshape(n, f), x.reshape(n, d)
        sgemm_ms = min(_time_ms(lambda: (g2 @ w.T, x2.T @ g2), iters=10) for _ in range(2))
        bound_ms, bound_by = _proj_bound(n, d, f, es=4)
        fl = 4.0 * n * d * f
        log(f"[{tag}] proj_bwd_f32 {label} N={n} D={d} F={f} (dw split "
            f"{_k6_f32_splits(mlp_bwd, n, d, f)[0]}): kernel {ms:.4f} ms "
            f"({fl / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuBLAS SGEMM on its "
            f"own two products (g @ w.T, x.T @ g; TF32 off) {sgemm_ms:.4f} ms "
            f"({fl / sgemm_ms / 1e9:.1f} TFLOP/s; kernel / SGEMM {ms / sgemm_ms:.2f}x), library "
            f"(autograd.grad of x @ w) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"at FFMA's 67 TFLOP/s {_ffma_ms(fl):.4f} ms), {bound_ms / ms:.1%} of bound "
            f"({SMI})")
        # The kernels line carries the wq/wo shape; wk/wv is logged beside it.
        out.setdefault("proj_bwd_f32", {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                        "bound_by": bound_by, "library_ms": lib_ms,
                                        "sgemm_ms": sgemm_ms})
        del x, w, g, xl, wl, y, g2, x2
    return out



# K6-f32's dw split counts that ``--f32-mm --sweep`` times: (label, N, D, F,
# counts) at path 10's two projection shapes, and at half and twice its
# tokens.
F32_PROJ_SWEEP = [("wq/wo", 8192, 896, 896, (1, 2, 3, 4, 6)),
                  ("wk/wv", 8192, 896, 128, (4, 6, 7, 8, 9, 10, 12, 16)),
                  ("wq/wo, N = 4096", 4096, 896, 896, (2, 3, 4, 6)),
                  ("wk/wv, N = 4096", 4096, 896, 128, (4, 6, 8, 10, 16)),
                  ("wk/wv, N = 16384", 16384, 896, 128, (4, 6, 8, 10, 16))]


def _k6_f32_splits(mlp_bwd, n: int, d: int, f: int) -> tuple[int, int]:
    """K6-f32's dw split as ``mlp_bwd``'s tree gives it: ``f32_proj_splits``,
    or ``f32_weight_splits`` in a tree from before K6-f32 had a rule of its
    own."""
    if hasattr(mlp_bwd, "f32_proj_splits"):
        return mlp_bwd.f32_proj_splits(n, d, f)
    return mlp_bwd.f32_weight_splits(d, f, n)


def phase_f32_split_sweep(mlp_bwd, proj) -> dict:
    """[f32-mm-sweep]: K6-f32 at ``F32_PROJ_SWEEP``'s shapes with dw split
    into each count (each split the least multiple of F32_BLOCK_K tokens
    that takes the tokens in that many, as the split rules round),
    called through the C entry point, which takes the count as an argument
    (the wrapper's count comes from shapes alone). Each count's dx and dw
    within ``F32_MM_TOL`` of the plain version; then two rounds of timings
    (10 calls each, the counts in order, then reversed), the better of the
    two. Returns {label: {count: ms}}."""
    import torch

    tag = "f32-mm-sweep"
    entry = mlp_bwd._kernel(*proj.kernel_route(torch.float32))
    cdiv, bk = mlp_bwd._cdiv, mlp_bwd.F32_BLOCK_K
    out = {}
    for label, n, d, f, counts in F32_PROJ_SWEEP:
        x, w, g = _proj_case(n, d, f, 0, 1400, torch.float32)
        x2, g2 = x.reshape(n, d), g.reshape(n, f)
        dx, dw = torch.empty_like(x2), torch.empty_like(w)
        split = {}
        for c in counts:
            chunk = cdiv(cdiv(n, c), bk) * bk
            split[c] = (cdiv(n, chunk), chunk)
        work = torch.empty((max(s for s, _ in split.values()), d, f), dtype=torch.float32,
                           device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(c):
            err = entry(x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                        dw.data_ptr(), work.data_ptr(), d, f, n, d, f, *split[c], stream)
            require(err == 0, f"proj_bwd_f32 {label}, dw split {c}: CUDA error {err}")

        dx_ref, dw_ref = proj.projection_bwd_plain(x, w, g)
        for c in counts:
            run(c)
            torch.cuda.synchronize()
            _check_scaled(f"proj_bwd_f32 {label} N={n} D={d} F={f}, dw split {split[c][0]} "
                          f"({split[c][1]} tokens)",
                          [("dx", dx, dx_ref.reshape(n, d)), ("dw", dw, dw_ref)], F32_MM_TOL,
                          tag)
        times = {c: [] for c in counts}
        for order in (counts, counts[::-1]):
            for c in order:
                times[c].append(_time_ms(lambda: run(c), iters=10))
        best = {c: min(v) for c, v in times.items()}
        log(f"[{tag}] proj_bwd_f32 {label} N={n} D={d} F={f}, ms by dw split (the better "
            f"of two runs of 10 calls, in turns; the module's rule gives "
            f"{_k6_f32_splits(mlp_bwd, n, d, f)[0]}, f32_weight_splits "
            f"{mlp_bwd.f32_weight_splits(d, f, n)[0]}): "
            + ", ".join(f"{c}: {best[c]:.4f}" for c in counts) + f" ({SMI})")
        out[label] = best
        del x, w, g, x2, g2, dx, dw, work, dx_ref, dw_ref
    return out


# ---------------------------------------------------------------------------
# The float16 backward (K2a-f16, K2b-f16, K5a-f16, K5b-f16, K6-f16), path 13
# (float16 training under the kernel flags) and the reference's flash
# dispatch (F1)
# ---------------------------------------------------------------------------

# (label, b, s_q, s_kv, h, kv, d, causal, ids, do scale) of K2a-f16 and
# K2b-f16: the llama3-8b training shape on packed rows and on one document a
# row, path 13's heads (qwen2-0.5b: 14/2, D = 64) on packed rows with unit
# gradients and with a training step's (2^-21: float16's subnormals, where
# path 13's flash backward finds them), D = 32, ragged S = 129 and 300, ids
# that go up and down.
F16_BWD_CASES = [
    ("training shape, packed rows", 4, 2048, 2048, 32, 8, 128, True, "train", 1.0),
    ("training shape, one document a row", 4, 2048, 2048, 32, 8, 128, True, None, 1.0),
    ("path 13, packed rows", 4, 2048, 2048, 14, 2, 64, True, "train", 1.0),
    ("path 13, a training step's gradients", 4, 2048, 2048, 14, 2, 64, True, "train",
     2.0**-21),
    ("head_dim 32", 2, 300, 300, 8, 2, 32, True, "packed", 1.0),
    ("ragged S = 129", 1, 129, 129, 4, 1, 128, True, None, 1.0),
    ("ragged S = 300, ids up and down", 2, 300, 300, 14, 2, 64, True, "nonmono", 1.0),
]
# (label, N, D, F) of K5a-f16 and K5b-f16: llama3-8b's training step, path
# 13's (qwen2-0.5b: D = 896 and F = 4864 overhang the 256-wide tiles), a
# ragged N.
F16_MLP_CASES = [("llama3-8b", 8192, 4096, 14336), ("path 13", 8192, 896, 4864),
                 ("ragged", 2064, 384, 384)]
# (label, N, D, F, blocks) of K6-f16: llama3-8b's wq/wo and wk/wv, path 13's
# (qwen2-0.5b's 896 x 896 and 896 x 128; the blocks of path 13's
# proj_bwd_block_d).
F16_PROJ_CASES = [("llama3-8b wq/wo", 8192, 4096, 4096, None),
                  ("llama3-8b wk/wv", 8192, 4096, 1024, None),
                  ("path 13 wq/wo", 8192, 896, 896, (0, 128)),
                  ("path 13 wk/wv", 8192, 896, 128, (0, 128))]


def phase_f16_bwd_kernels(flash, mlp_bwd, proj, paged, train_seg) -> dict:
    """[f16-bwd-kernels]: K2a-f16 and K2b-f16 against the plain backward in
    float16 at ``F16_BWD_CASES`` (each gradient within ``BWD_TOL`` of its
    largest magnitude; at a training step's gradient scale too, which the
    wrapper rescales around the kernels), K5a-f16 and K5b-f16 at ``F16_MLP_CASES`` and K6-f16
    at ``F16_PROJ_CASES`` against their plain versions (``MM_TOL``); every
    kernel called twice gives the same bits; then the bf16 K1, K2, K3 and K5
    keep ``K1_DIGESTS``, ``K2_DIGESTS``, ``K3_DIGESTS`` and ``K5_DIGESTS``,
    and the f32 paged kernels, K5a-f32, K5b-f32 and K6-f32 ``F32_DIGESTS``.
    Returns the largest absolute errors."""
    import torch

    f16, tag = torch.float16, "f16-bwd-kernels"
    worst = {k: 0.0 for k in ("flash_dq_f16", "flash_dkv_f16", "mlp_dgu_dwdown_f16",
                              "mlp_dh_dwgu_f16", "proj_bwd_f16")}
    for i, (label, b, sq, skv, h, kv, d, causal, spec, do_scale) in enumerate(F16_BWD_CASES):
        seg = _bwd_segment_ids(spec, b, sq, train_seg)
        q, k, v, o, lse, do = _bwd_inputs(b, sq, skv, h, kv, d, causal, seg, seed=1700 + i,
                                          flash=flash, dtype=f16, do_scale=do_scale)
        flash.reset_launches()
        got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
        again = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=seg)
        require((flash.launches_dq_f16, flash.launches_dkv_f16, flash.launches_dq,
                 flash.launches_dkv, flash.launches_dq_f32, flash.launches_dkv_f32)
                == (2, 2, 0, 0, 0, 0), f"flash f16 backward launches, {label}")
        want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                               segment_ids=seg)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"flash f16 backward {label}: two calls differ")
        # At a training step's scale the outputs are float16 subnormals: two
        # of their 2^-24 steps (the rescaled output's rounding, then the
        # unscaled one's) beside BWD_TOL.
        _check_scaled(f"flash_bwd_f16 {label}: B={b} Sq={sq} Skv={skv} H={h} K={kv} D={d} "
                      f"causal={causal}", list(zip(("dq", "dk", "dv"), got, want)), BWD_TOL,
                      tag, quantum=2.0**-23 if do_scale < 1 else 0.0)
        err = [float((x.float() - r.float()).abs().max()) for x, r in zip(got, want)]
        worst["flash_dq_f16"] = max(worst["flash_dq_f16"], err[0])
        worst["flash_dkv_f16"] = max(worst["flash_dkv_f16"], err[1], err[2])
        del q, k, v, o, lse, do, got, again, want
    log(f"[{tag}] K2a-f16 and K2b-f16: two calls the same bits in every case")
    for i, (label, n, d, f) in enumerate(F16_MLP_CASES):
        h, w_gu, w_down, gu, g = _mlp_case(n, d, f, 1800 + 10 * i, f16)
        gate, up = gu.chunk(2, dim=-1)  # views of gu, as the op saves them
        mlp_bwd.reset_launches()
        dgu, d_w_down = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
        dh, d_w_gu = mlp_bwd.dh_dwgu(h, dgu, w_gu)
        dgu2, d_w_down2 = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
        dh2, d_w_gu2 = mlp_bwd.dh_dwgu(h, dgu2, w_gu)
        require((mlp_bwd.launches_dgu_f16, mlp_bwd.launches_dh_f16, mlp_bwd.launches_dgu,
                 mlp_bwd.launches_dh) == (2, 2, 0, 0), "K5 f16 launch counts")
        dgu_ref, d_w_down_ref = mlp_bwd.dgu_dwdown_plain(g, w_down, gate, up)
        dh_ref, d_w_gu_ref = mlp_bwd.dh_dwgu_plain(h, dgu, w_gu)
        torch.cuda.synchronize()
        shape = f"N={n} D={d} F={f} ({label})"
        worst["mlp_dgu_dwdown_f16"] = max(worst["mlp_dgu_dwdown_f16"], _check_scaled(
            f"mlp_dgu_dwdown_f16 {shape}", [("dgu", dgu, dgu_ref),
                                            ("d_w_down", d_w_down, d_w_down_ref)], MM_TOL, tag))
        worst["mlp_dh_dwgu_f16"] = max(worst["mlp_dh_dwgu_f16"], _check_scaled(
            f"mlp_dh_dwgu_f16 {shape}", [("dh", dh, dh_ref), ("d_w_gu", d_w_gu, d_w_gu_ref)],
            MM_TOL, tag))
        same = [torch.equal(x, y) for x, y in ((dgu, dgu2), (d_w_down, d_w_down2), (dh, dh2),
                                               (d_w_gu, d_w_gu2))]
        require(all(same), f"K5 f16 {shape}: a second call gave other bits {same}")
        del h, w_gu, w_down, gu, g, gate, up, dgu, d_w_down, dh, d_w_gu, dgu2, d_w_down2
        del dh2, d_w_gu2, dgu_ref, d_w_down_ref, dh_ref, d_w_gu_ref
    log(f"[{tag}] K5a-f16 and K5b-f16: two calls the same bits in every case")
    for i, (label, n, d, f, blocks) in enumerate(F16_PROJ_CASES):
        x, w, g = _proj_case(n, d, f, 0, 1900 + 10 * i, f16)
        proj.reset_launches()
        runs = [proj.projection_bwd(x, w, g, blocks=blocks, dx_first=o)
                for o in (None, True, False)]
        require((proj.launches_f16, proj.launches) == (3, 0), "K6 f16 launch counts")
        dx_ref, dw_ref = proj.projection_bwd_plain(x, w, g)
        torch.cuda.synchronize()
        worst["proj_bwd_f16"] = max(worst["proj_bwd_f16"], _check_scaled(
            f"proj_bwd_f16 N={n} D={d} F={f} ({label})",
            [("dx", runs[0][0], dx_ref), ("dw", runs[0][1], dw_ref)], MM_TOL, tag))
        require(all(torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1])
                    for r in runs[1:]), f"proj_bwd_f16 {label}: another order gave other bits")
        del x, w, g, runs, dx_ref, dw_ref
    log(f"[{tag}] K6-f16: the default order, dx tiles first and dw tiles first give the "
        f"same bits in every case")
    for name, fn, want in (("bf16 K1", lambda: _k1_digests(flash), K1_DIGESTS),
                           ("bf16 K2", lambda: _k2_digests(flash), K2_DIGESTS),
                           ("bf16 K3", lambda: _k3_digests(paged), K3_DIGESTS),
                           ("bf16 K5", lambda: _k5_digests(mlp_bwd), K5_DIGESTS),
                           ("f32", lambda: _f32_digests(paged, mlp_bwd, proj), F32_DIGESTS)):
        got = fn()
        for key, value in got.items():
            log(f"[{tag}] {name} digest {key}: {value} (expected {want.get(key)})")
        require(got == want, f"the {name} kernels differ from the earlier build's bits")
    log(f"[{tag}] the bf16 K1, K2a/K2b, K3 and K5a/K5b keep their digests, and K3-f32, "
        f"K4-f32, K3-f32-verify, K3-int8-f32 and its verify, K5a-f32, K5b-f32 and K6-f32 "
        f"theirs (F32_DIGESTS)")
    return worst


def phase_f16_bwd_timings(flash, mlp_bwd, proj, train_seg) -> dict:
    """[f16-bwd-timing]: each new kernel at llama3-8b's shapes (its bf16
    twin's PERF.md row: the kernels line) and at path 13's: its time (CUDA
    events, the better of two runs), its plain version's, the library
    call's on the same float16 inputs (SDPA's backward with the same mask
    for K2; cuBLAS float16 on each kernel's own two products and
    ``autograd.grad`` of the plain forward for K5/K6), the bf16 twin's time
    on the same values in bf16, and the bound (each input read and each
    output written once over 3.35 TB/s, or the flops over 989 TFLOP/s dense
    float16, the larger)."""
    import torch
    import torch.nn.functional as F

    f16, bf16, tag = torch.float16, torch.bfloat16, "f16-bwd-timing"
    out: dict = {}

    def best(fn):
        return min(_time_ms(fn, iters=10), _time_ms(fn, iters=10))

    for label, h, kv, d, seg in (("llama3-8b, one document a row", 32, 8, 128, None),
                                 ("path 13, packed rows", 14, 2, 64, train_seg)):
        q, k, v, o, lse, do = _bwd_inputs(4, 2048, 2048, h, kv, d, True, seg, seed=2000,
                                          flash=flash, dtype=f16)
        run_dq, run_dkv, keep = _bwd_launchers(flash, q, k, v, o, lse, do, seg, True)
        twin = [x.to(bf16) for x in (q, k, v, o, do)]
        tq, tk, tv, to, tdo = twin
        b_dq, b_dkv, b_keep = _bwd_launchers(flash, tq, tk, tv, to, lse, tdo, seg, True)
        groups = h // kv
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (x.repeat_interleave(groups, dim=2).transpose(1, 2).detach().requires_grad_()
                  for x in (k, v))
        if seg is None:
            sdpa_kw = {"is_causal": True}
        else:
            mask = torch.ones(2048, 2048, dtype=torch.bool, device="cuda").tril()[None]
            sdpa_kw = {"attn_mask": (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]}
        out_t = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        do_t = do.transpose(1, 2)
        lib_ms = best(lambda: torch.autograd.grad(out_t, (qt, kt, vt), grad_outputs=do_t,
                                                  retain_graph=True))
        plain_ms = _time_ms(lambda: flash.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=True, segment_ids=seg), iters=3, warmup=1)
        for name, run, twin_run, kind in (("flash_dq_f16", run_dq, b_dq, "dq"),
                                          ("flash_dkv_f16", run_dkv, b_dkv, "dkv")):
            ms, twin_ms = best(run), best(twin_run)
            bound_ms, bound_by = _bwd_bound(q, k, seg, True, kind)
            log(f"[{tag}] {name} {label}: B=4 S=2048 H={h} K={kv} D={d} causal: kernel "
                f"{ms:.4f} ms, bf16 twin on the same values {twin_ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms (dq, dk, dv together), sdpa backward (float16, the same mask) "
                f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of "
                f"bound ({SMI})")
            out.setdefault(name, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by, "library_ms": lib_ms,
                                  "bf16_twin_ms": twin_ms})
        del q, k, v, o, lse, do, keep, twin, tq, tk, tv, to, tdo, b_keep, qt, kt, vt, out_t
    for label, n, d, f in F16_MLP_CASES[:2]:
        h, w_gu, w_down, gu, g = _mlp_case(n, d, f, 2100, f16)
        gate, up = gu.chunk(2, dim=-1)
        dgu, _ = mlp_bwd.dgu_dwdown(g, w_down, gate, up)
        th, tw_gu, tw_down, tgu, tg, tdgu = (x.to(bf16) for x in (h, w_gu, w_down, gu, g, dgu))
        tgate, tup = tgu.chunk(2, dim=-1)
        leaves = [t.detach().clone().requires_grad_() for t in (h, w_gu, w_down)]
        gate_l, up_l = (leaves[0] @ leaves[1]).chunk(2, dim=-1)
        mlp_out = (F.silu(gate_l) * up_l) @ leaves[2]
        lib_ms = best(lambda: torch.autograd.grad(mlp_out, leaves, grad_outputs=g,
                                                  retain_graph=True))
        gf = gate.float()
        inner = (gf * torch.sigmoid(gf) * up.float()).to(f16)
        bounds = _mlp_bounds(n, d, f)
        for name, run, twin_run, plain, cublas, fl, bkey in (
                ("mlp_dgu_dwdown_f16", lambda: mlp_bwd.dgu_dwdown(g, w_down, gate, up),
                 lambda: mlp_bwd.dgu_dwdown(tg, tw_down, tgate, tup),
                 lambda: mlp_bwd.dgu_dwdown_plain(g, w_down, gate, up),
                 lambda: (g @ w_down.T, inner.T @ g), 4.0 * n * d * f, "mlp_dgu_dwdown"),
                ("mlp_dh_dwgu_f16", lambda: mlp_bwd.dh_dwgu(h, dgu, w_gu),
                 lambda: mlp_bwd.dh_dwgu(th, tdgu, tw_gu),
                 lambda: mlp_bwd.dh_dwgu_plain(h, dgu, w_gu),
                 lambda: (dgu @ w_gu.T, h.T @ dgu), 8.0 * n * d * f, "mlp_dh_dwgu")):
            ms, twin_ms, cublas_ms = best(run), best(twin_run), best(cublas)
            plain_ms = _time_ms(plain, iters=3, warmup=1)
            bound_ms, bound_by = bounds[bkey]
            log(f"[{tag}] {name} {label} N={n} D={d} F={f}: kernel {ms:.4f} ms "
                f"({fl / ms / 1e9:.1f} TFLOP/s), bf16 twin {twin_ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, cuBLAS float16 on its own two products {cublas_ms:.4f} ms "
                f"({fl / cublas_ms / 1e9:.1f} TFLOP/s), library (autograd of the plain MLP "
                f"forward, dh, d_w_gu and d_w_down together) {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound ({SMI})")
            out.setdefault(name, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by, "library_ms": lib_ms,
                                  "bf16_twin_ms": twin_ms, "cublas_ms": cublas_ms})
        del h, w_gu, w_down, gu, g, gate, up, dgu, th, tw_gu, tw_down, tgu, tg, tdgu, tgate
        del tup, leaves, gate_l, up_l, mlp_out, gf, inner
    for label, n, d, f, blocks in F16_PROJ_CASES:
        x, w, g = _proj_case(n, d, f, 0, 2200, f16)
        tx, tw, tg = (t.to(bf16) for t in (x, w, g))
        xl, wl = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
        y = xl @ wl
        ms = best(lambda: proj.projection_bwd(x, w, g, blocks=blocks))
        twin_ms = best(lambda: proj.projection_bwd(tx, tw, tg, blocks=blocks))
        plain_ms = _time_ms(lambda: proj.projection_bwd_plain(x, w, g), iters=3, warmup=1)
        lib_ms = best(lambda: torch.autograd.grad(y, (xl, wl), grad_outputs=g,
                                                  retain_graph=True))
        g2, x2 = g.reshape(n, f), x.reshape(n, d)
        cublas_ms = best(lambda: (g2 @ w.T, x2.T @ g2))
        bound_ms, bound_by = _proj_bound(n, d, f)
        fl = 4.0 * n * d * f
        log(f"[{tag}] proj_bwd_f16 {label} N={n} D={d} F={f}: kernel {ms:.4f} ms "
            f"({fl / ms / 1e9:.1f} TFLOP/s), bf16 twin {twin_ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, cuBLAS float16 on its own two products {cublas_ms:.4f} ms, library "
            f"(autograd.grad of x @ w) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound ({SMI})")
        out.setdefault("proj_bwd_f16", {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                        "bound_by": bound_by, "library_ms": lib_ms,
                                        "bf16_twin_ms": twin_ms, "cublas_ms": cublas_ms})
        del x, w, g, tx, tw, tg, xl, wl, y, g2, x2
    return out


def phase_f1(flash) -> dict:
    """[f1]: ``tiny-llama`` (head_dim 32) at ``dtype=float32
    attention_impl=flash``, where the reference's dispatch takes plain
    attention: one ``train()`` step (B=4, S=2048) and one served prefill
    through the lock-step ``Generator`` (a 300-token prompt, bucket 512), on
    the card. Both finite; no flash kernel of any dtype launched (there is no
    f32 kernel at D = 32: both raised before the port followed the
    reference's dispatch). Returns the loss."""
    import torch

    from ditl_tpu_torch.data.tokenizer import ByteTokenizer
    from ditl_tpu_torch.infer.engine import GenerateConfig, Generator
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.train.trainer import train

    config, device = build_config([
        "--preset", "tiny-llama", "model.dtype=float32", "model.param_dtype=float32",
        "model.attention_impl=flash", "train.optimizer=adafactor", "train.total_steps=1",
        "train.log_every=1", "data.synthetic=true", "data.batch_size=4",
        "data.seq_len=2048"])
    cfg = config.model
    require((cfg.name, cfg.head_dim, cfg.dtype, cfg.attention_impl, device)
            == ("tiny-llama", 32, "float32", "flash", "cuda"), cfg)
    counters = [c for _, _, c in flash._ENTRIES.values()]
    flash.reset_launches()
    summary = train(config, device=device)
    train_counts = {c: getattr(flash, c) for c in counters}
    loss = summary["losses"][0]
    require(summary["steps"] == 1 and loss == loss and abs(loss) != float("inf"), summary)
    gen = Generator(llama.init_params(cfg, seed=3, device="cuda"), cfg, ByteTokenizer(),
                    device="cuda")
    ids = [gen.tokenizer.bos_id] + gen.tokenizer.encode(_text(80, 300))
    flash.reset_launches()
    logits = _prefill_logits(gen, cfg, ids)
    toks = gen.generate_tokens([ids], GenerateConfig(max_new_tokens=4))[0]
    torch.cuda.synchronize()
    serve_counts = {c: getattr(flash, c) for c in counters}
    require(bool(torch.isfinite(logits).all()) and len(toks) >= 1, (logits, toks))
    require(set(train_counts.values()) == set(serve_counts.values()) == {0},
            (train_counts, serve_counts))
    log(f"[f1] tiny-llama (head_dim 32) in f32 with attention_impl=flash, where the "
        f"reference takes plain attention: one train step B=4 S=2048, loss {loss:.4f}; a "
        f"{len(ids)}-token prefill, logits finite (max |logit| "
        f"{float(logits.abs().max()):.3f}), {len(toks)} tokens generated; flash launches "
        f"of every dtype 0 in both ({SMI})")
    return {"loss": loss}


# ---------------------------------------------------------------------------
# Head dims 32 and 256 (paths 14 and 15): the paged kernels at D = 32 and 256
# in every dtype and form, K1/K2a/K2b at D = 256 in bf16 and float16
# ---------------------------------------------------------------------------

# Every paged entry point: (kernels-line name, q's dtype, int8 pools, form).
HD_PAGED = [
    ("paged_tail", "bfloat16", False, "tail"), ("paged", "bfloat16", False, "no_tail"),
    ("paged_verify", "bfloat16", False, "verify"),
    ("paged_tail_int8", "bfloat16", True, "tail"),
    ("paged_verify_int8", "bfloat16", True, "verify"),
    ("paged_tail_f32", "float32", False, "tail"), ("paged_f32", "float32", False, "no_tail"),
    ("paged_verify_f32", "float32", False, "verify"),
] + NEW_PAGED
# Single-query cases at the new head dims: (label, b, h, kv, d, ps, tail_len,
# lengths, starts). Path 14's decode tick (tiny-llama: 8/4 heads, D = 32)
# and path 15's (8 heads on 1 KV head, D = 256) with the main path's ragged
# state; G = 1 and G = 8 at page 16 with keys ending one past a split and
# on a split boundary, a tile across the last page and the tail, a dead
# slot, a tail-only slot and starts == lengths.
HD_PAGED_CASES = [
    ("path 14 decode tick, G = 2", 8, 8, 4, 32, 256, 16, _paged_main_case()[1],
     _paged_main_case()[0]),
    ("D = 32, G = 1, split edges", 4, 4, 4, 32, 16, 16, [257, 256, 513, 140],
     [257, 250, 500, 128]),
    ("D = 32, G = 8, dead and tail-only slots", 4, 8, 1, 32, 16, 8, [0, 5, 38, 50],
     [0, 0, 38, 45]),
    ("path 15 decode tick, G = 8", 8, 8, 1, 256, 256, 16, _paged_main_case()[1],
     _paged_main_case()[0]),
    ("D = 256, G = 1, split edges", 4, 4, 4, 256, 16, 16, [257, 256, 513, 140],
     [257, 250, 500, 128]),
    ("D = 256, G = 8, dead and tail-only slots", 4, 8, 1, 256, 16, 8, [0, 5, 38, 50],
     [0, 0, 38, 45]),
]
# Verify cases at the new head dims: (label, b, nq, h, kv, d, ps, tail_len,
# lengths, starts, maxp). The spec tick of paths 14 and 15 (Q = 9: 18 and
# 72 query rows), 80 rows at G = 8 (Q = 10), G = 1 with a tail longer than
# 128 columns (query 0's limit before the split at tail column 128, query
# 8's past it) and a tail-only slot, and Q = 5 at G = 8 (40 rows: three row
# tiles).
HD_VERIFY_CASES = [
    ("path 14 spec tick", 8, 9, 8, 4, 32, 256, 54, _spec_main_case()[1],
     _spec_main_case()[0], 8),
    ("D = 32, G = 8, 80 rows", 2, 10, 8, 1, 32, 64, 40, [300, 77], [290, 64], 5),
    ("D = 32, G = 1, long tail", 3, 9, 4, 4, 32, 16, 200, [381, 60, 30], [256, 30, 0], 16),
    ("path 15 spec tick", 8, 9, 8, 1, 256, 256, 54, _spec_main_case()[1],
     _spec_main_case()[0], 8),
    ("D = 256, G = 8, 80 rows", 2, 10, 8, 1, 256, 64, 40, [300, 77], [290, 64], 5),
    ("D = 256, G = 1, long tail", 3, 9, 4, 4, 256, 16, 200, [381, 60, 30], [256, 30, 0],
     16),
    ("D = 256, G = 8, Q = 5", 4, 5, 8, 1, 256, 16, 24, [0, 20, 40, 21], [0, 16, 33, 20], 4),
]
# K1/K2a/K2b at D = 256: (label, b, s_q, s_kv, h, kv, causal, ids). Path 15's
# prefill (8 heads on 1 KV head, right-padded), its training batch's packed
# rows, ids up and down at G = 2, a boundary one row past a tile edge, and
# Sq != Skv without a mask.
HD_FLASH_CASES = [
    ("path 15 prefill, right-padded", 4, 512, 512, 8, 1, True, [512, 401, 230, 97]),
    ("training batch, packed rows", 4, 2048, 2048, 8, 1, True, "train"),
    ("ids up and down, G = 2", 2, 300, 300, 4, 2, True, "nonmono"),
    ("boundary past a tile edge", 1, 257, 257, 4, 2, True, "edge1"),
    ("non-causal, Sq != Skv", 2, 200, 333, 4, 4, False, None),
]
HD_FLASH = [("flash_fwd", "flash_dq", "flash_dkv", "bfloat16"),
            ("flash_fwd_f16", "flash_dq_f16", "flash_dkv_f16", "float16"),
            ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32", "float32")]


def _paged_case_inputs(case, form, dtype, int8, seed):
    """A single-query or verify case's inputs (``_paged_inputs``), int8
    pools and scales where ``int8``: the kernel's call, and the plain
    versions' positional arguments."""
    import torch

    if form == "verify":
        label, b, nq, h, kv, d, ps, tl, lens, sts, maxp = case
    else:
        (label, b, h, kv, d, ps, tl, lens, sts), nq, maxp = case, None, None
    q, kp, vp, table, ln, st, tk, tv = _paged_inputs(
        b, h, kv, d, ps, tl, lens, sts, seed=seed, n_pool=128, nq=nq, maxp=maxp,
        share=b > 2, dtype=dtype)
    scales = {}
    if int8:
        kp, vp, ks, vs = _int8_pools(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    if form == "no_tail":
        ln = torch.minimum(st, ln).contiguous()
        return (q, kp, vp, table, ln), {}, (q, kp, vp, table, ln), lens
    kw = dict(tail_k=tk, tail_v=tv, starts=st, **scales)
    return (q, kp, vp, table, ln), kw, (q, kp, vp, table, ln, tk, tv, st,
                                        scales.get("k_scale"), scales.get("v_scale")), lens


def _check_paged_entries(paged, entries, cases, verify_cases, seed: int, tag_of):
    """Each paged entry point of ``entries`` ((kernels-line name, q's dtype,
    int8 pools, form)) against the plain version and the split twin
    (``_close``) on ``cases`` (single-query forms) or ``verify_cases``: two
    calls the same bits, a 4-D q with Q = 1 the 3-D call's bits, a dead
    slot zeros; ``tag_of(dtype)`` tags the log lines. Every launch counts on
    its own counter and on no other. Returns the largest error and the
    launches, by name."""
    import torch

    worst, calls = {}, {}
    paged.reset_launches()
    for name, dtype_name, int8, form in entries:
        dtype = getattr(torch, dtype_name)
        for i, case in enumerate(verify_cases if form == "verify" else cases):
            args, kw, plain_args, lens = _paged_case_inputs(case, form, dtype, int8,
                                                            seed + 10 * i)
            q = args[0]
            o, o2 = (paged.paged_attention(*args, **kw) for _ in range(2))
            calls[name] = calls.get(name, 0) + 2
            r = paged.paged_attention_plain(*plain_args)
            sp = paged.paged_attention_split_plain(*plain_args)
            extra = ""
            if form == "verify":
                o41 = paged.paged_attention(q[:, :1].contiguous(), *args[1:], **kw)
                o3 = paged.paged_attention(q[:, 0].contiguous(), *args[1:], **kw)
                single = name.replace("verify", "tail")
                calls[single] = calls.get(single, 0) + 2
                extra = ", Q = 1 the 3-D call's bits"
            torch.cuda.synchronize()
            label = case[0]
            require(o.dtype == dtype and o.shape == q.shape
                    and bool(torch.isfinite(o.float()).all()), f"{name} {label}")
            require(torch.equal(o, o2), f"{name} {label}: two calls differ")
            if form == "verify":
                require(torch.equal(o41[:, 0], o3), f"{name} {label}: Q = 1 differs")
            dead = [j for j, n_ in enumerate(lens) if n_ == 0]
            require(all(bool((o[j] == 0).all()) for j in dead), f"{name}: dead slot")
            err = _close(name, dtype, o, r)
            err_split = _close(name, dtype, o, sp)
            worst[name] = max(worst.get(name, 0.0), err)
            tol = (f"{F32_PAGED_TOL} of the largest magnitude" if dtype == torch.float32
                   else O_TOL)
            log(f"[{tag_of(dtype)}] {name} D={q.shape[-1]} {label}: q {tuple(q.shape)}, "
                f"pools {tuple(args[1].shape)}: max|o-plain| {err:.3e}, max|o-split plain| "
                f"{err_split:.3e} (tolerance {tol}); two calls the same bits{extra}")
            del args, kw, plain_args, o, o2, r, sp
    counts = {name: getattr(paged, _counter(name)) for name in calls}
    require(counts == calls and sum(getattr(paged, c) for c in paged._COUNTERS.values())
            == sum(calls.values()), (counts, calls))
    return worst, counts


def phase_head_dim_kernels(flash, paged, train_seg) -> dict:
    """[hd-kernels]: the instances this slice added, each against its plain
    version. Every paged entry point (``HD_PAGED``: K3, K4, K3-verify and
    their int8 forms, in bf16, float16 and f32) at D = 32 and 256 against
    the plain version and the split twin (``_close``: bf16 and float16 at
    ``O_TOL``, f32 within ``F32_PAGED_TOL`` of the largest magnitude) on
    ``HD_PAGED_CASES`` or ``HD_VERIFY_CASES`` (G = 1 and 8, 80 query rows,
    split and tile edges), a 4-D q with Q = 1 the 3-D call's bits; K1, K2a
    and K2b at D = 256 in bf16, float16 and f32 on ``HD_FLASH_CASES`` (o and
    lse at ``O_TOL``/``LSE_TOL``, each gradient within ``BWD_TOL`` of its
    largest magnitude; f32 at ``F32_O_TOL`` and ``F32_BWD_TOL``). Every
    kernel called twice gives the same bits.
    Returns the largest errors by kernels-line name and K4's direct-call
    launches by name (``<name>_direct``)."""
    import torch

    worst, counts = _check_paged_entries(paged, HD_PAGED, HD_PAGED_CASES, HD_VERIFY_CASES,
                                         2000, lambda dtype: "hd-kernels")
    for name in ("paged", "paged_f16", "paged_f32"):
        worst[name + "_direct"] = counts[name]

    for fwd_name, dq_name, dkv_name, dtype_name in HD_FLASH:
        dtype = getattr(torch, dtype_name)
        f32 = dtype == torch.float32
        o_tol, lse_tol, bwd_tol = ((F32_O_TOL, F32_O_TOL, F32_BWD_TOL) if f32
                                   else (O_TOL, LSE_TOL, BWD_TOL))
        for name in (fwd_name, dq_name, dkv_name):
            worst[name] = 0.0
        for i, (label, b, sq, skv, h, kv, causal, spec) in enumerate(HD_FLASH_CASES):
            seg = _bwd_segment_ids(spec, b, sq, train_seg)
            flash.reset_launches()
            q, k, v, o, lse, do = _bwd_inputs(b, sq, skv, h, kv, 256, causal, seg,
                                              seed=2100 + i, flash=flash, dtype=dtype)
            o2, lse2 = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
            got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                            segment_ids=seg)
            again = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                              segment_ids=seg)
            sfx = DTYPE_SFX[dtype_name][0]
            require(tuple(getattr(flash, c + sfx) for c in
                          ("launches", "launches_dq", "launches_dkv")) == (2, 2, 2),
                    f"{fwd_name} {label}: launch counts")
            o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal=causal,
                                                         segment_ids=seg)
            want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                   segment_ids=seg)
            torch.cuda.synchronize()
            require(torch.equal(o, o2) and torch.equal(lse, lse2)
                    and all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"{fwd_name} {label}: two calls differ")
            require(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
                    f"{fwd_name} {label}: non-finite")
            torch.testing.assert_close(o.float(), o_ref.float(), atol=o_tol, rtol=o_tol)
            torch.testing.assert_close(lse, lse_ref, atol=lse_tol, rtol=lse_tol)
            err = float((o.float() - o_ref.float()).abs().max())
            worst[fwd_name] = max(worst[fwd_name], err)
            shape = f"B={b} Sq={sq} Skv={skv} H={h} K={kv} D=256 causal={causal}"
            log(f"[hd-kernels] {fwd_name} {label}: {shape}: max|o-plain| {err:.3e}, "
                f"max|lse-plain| {float((lse - lse_ref).abs().max()):.3e} (tolerance "
                f"{o_tol} / {lse_tol}); two calls the same bits")
            _check_scaled(f"{dq_name}/{dkv_name} {label}: {shape}",
                          list(zip(("dq", "dk", "dv"), got, want)), bwd_tol, "hd-kernels")
            errs = [float((x.float() - r.float()).abs().max()) for x, r in zip(got, want)]
            worst[dq_name] = max(worst[dq_name], errs[0])
            worst[dkv_name] = max(worst[dkv_name], errs[1], errs[2])
            del q, k, v, o, lse, do, o2, lse2, got, again, o_ref, lse_ref, want
    log(f"[hd-kernels] K1, K2a and K2b at D = 256 (bf16, float16, f32): two calls the same "
        f"bits in every case")
    return worst



# Path 14's decode tick (tiny-llama: 8 query on 4 KV heads, D = 32) and path
# 15's (8 on 1, D = 256), at the main path's slots, page and tail; their spec
# ticks (Q = 9, 8 pages a slot, a 54-column tail).
HD_TICKS = {32: dict(b=8, h=8, kv=4, d=32, ps=256, tail_len=16),
            256: dict(b=8, h=8, kv=1, d=256, ps=256, tail_len=16)}
HD_SPEC_TICKS = {d: dict(m, nq=9, maxp=8, tail_len=54) for d, m in HD_TICKS.items()}


def phase_head_dim_timings(flash, paged, train_seg) -> dict:
    """[hd-timing]: the new instances' times beside their plain versions,
    their library calls and their bounds (``_time_paged``'s and the flash
    timings' rules): every paged entry point of ``HD_PAGED`` at path 14's
    and path 15's decode tick (the verify forms at their spec tick); K1 at
    D = 256 in bf16, float16 and f32 at path 15's prefill (B=4, S=512, 8 heads on
    1 KV head, right-padded) and on one row of the training batch's packed
    documents (B=1, S=2048, path 15's training shape), against SDPA with
    the same mask; K2a and K2b at that training shape, each launch alone,
    against SDPA's backward with the same mask (all three gradients).
    Returns {kernels-line name: {head_dim: timing}}."""
    import torch
    import torch.nn.functional as F

    out: dict = {}
    for name, dtype_name, int8, form in HD_PAGED:
        for d in (32, 256):
            m = (HD_SPEC_TICKS if form == "verify" else HD_TICKS)[d]
            out.setdefault(name, {})[d] = _time_paged(paged, name, dtype_name, int8, form, m,
                                                      "hd-timing")

    def best(fn, iters=20):
        return min(_time_ms(fn, iters=iters), _time_ms(fn, iters=iters))

    for fwd_name, dq_name, dkv_name, dtype_name in HD_FLASH:
        dtype = getattr(torch, dtype_name)
        for label, b, s, seg in (("path 15 prefill", 4, 512, [512, 401, 230, 97]),
                                 ("path 15 training row, packed", 1, 2048, "train")):
            seg = (_bwd_segment_ids(seg, b, s, train_seg) if seg != "train"
                   else train_seg[:1].contiguous())
            q, k, v, o, lse, do = _bwd_inputs(b, s, s, 8, 1, 256, True, seg, seed=2300,
                                              flash=flash, dtype=dtype)
            mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()[None]
            mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
            qt = q.transpose(1, 2).detach().requires_grad_()
            kt, vt = (x.repeat_interleave(8, dim=2).transpose(1, 2).detach().requires_grad_()
                      for x in (k, v))
            backend = _sdpa_backend(qt, kt, vt, mask, 0.0, False)
            ms = best(lambda: flash.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg))
            lib_ms = best(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            plain_ms = _time_ms(lambda: flash.flash_attention_plain(
                q, k, v, causal=True, segment_ids=seg), iters=3, warmup=1)
            bound_ms, bound_by = _flash_bound(q, k, seg, True)
            shape = f"B={b} S={s} H=8 K=1 D=256 causal+seg"
            log(f"[hd-timing] {fwd_name} {label} {shape}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa ({dtype_name}, same mask; backend {backend}) "
                f"{lib_ms:.4f} ms, kernel / sdpa {ms / lib_ms:.2f}x, bound {bound_ms:.4f} ms "
                f"({bound_by}), {bound_ms / ms:.1%} of bound ({SMI})")
            out.setdefault(fwd_name, {}).setdefault(256, {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "library": f"sdpa {backend}", "shape": label})
            if s != 2048:
                del q, k, v, o, lse, do, qt, kt, vt, mask
                continue
            run_dq, run_dkv, keep = _bwd_launchers(flash, q, k, v, o, lse, do, seg, True)
            out_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            do_t = do.transpose(1, 2)
            lib_ms = best(lambda: torch.autograd.grad(out_t, (qt, kt, vt), grad_outputs=do_t,
                                                      retain_graph=True), iters=10)
            plain_ms = _time_ms(lambda: flash.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=True, segment_ids=seg), iters=3, warmup=1)
            for name, run, kind in ((dq_name, run_dq, "dq"), (dkv_name, run_dkv, "dkv")):
                ms = best(run, iters=10)
                bound_ms, bound_by = _bwd_bound(q, k, seg, True, kind)
                log(f"[hd-timing] {name} {label} {shape}: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms (dq, dk, dv together), sdpa backward ({dtype_name}, "
                    f"the same mask, all three gradients) {lib_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound ({SMI})")
                out.setdefault(name, {})[256] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "library": f"sdpa backward {backend}", "shape": label}
            if dtype == torch.float32:
                log("[hd-timing] " + _k2_f32_summary(flash, out[dq_name][256]["ms"],
                                                     out[dkv_name][256]["ms"], lib_ms,
                                                     plain_ms, b, 1, 8, s, 256))
            del q, k, v, o, lse, do, qt, kt, vt, mask, keep, out_t, do_t
    return out


def _k2_f32_summary(flash, dq_ms, dkv_ms, lib_ms, plain_ms, b, kv, groups, s, d) -> str:
    """K2a-f32 + K2b-f32 against SDPA's whole backward and the plain one,
    and K2b-f32's grid (``f32_dkv_splits``, as the wrapper takes it)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, chunk = flash.f32_dkv_splits(b, kv, groups, s, s, d)
    blocks = splits * kv * b * -(-s // flash.f32_bwd_block(d))
    return (f"K2a-f32 + K2b-f32 at B={b} S={s} H={kv * groups} K={kv} D={d}: "
            f"{dq_ms + dkv_ms:.4f} ms against the sdpa backward (all three grads) "
            f"{lib_ms:.4f} ms ({(dq_ms + dkv_ms) / lib_ms:.2f}x) and the plain backward "
            f"{plain_ms:.4f} ms; K2b-f32 {dkv_ms:.4f} ms, {dkv_ms / plain_ms:.2f}x the plain "
            f"backward; K2b-f32's grid {blocks} blocks on {sms} SMs ({splits} runs of "
            f"{chunk} items) ({SMI})")


# Path 15: google/gemma-2b's published attention and MLP widths (its
# config.json: vocab 256000, hidden 2048, intermediate 16384, 18 layers, 8
# heads on 1 KV head, head_dim 256, rope_theta 10000, rms_norm_eps 1e-6,
# tied embeddings, 8192 positions) as the repo's Llama architecture (SwiGLU
# without GeGLU, no embedding scale, no norm offset), through ModelConfig
# fields both packages have: server overrides, not a preset.
GEMMA_WIDTHS = ["name=gemma-2b-widths", "vocab_size=256000", "hidden_size=2048",
                "intermediate_size=16384", "num_layers=18", "num_heads=8", "num_kv_heads=1",
                "head_dim=256", "max_seq_len=8192", "rope_theta=10000.0", "rms_norm_eps=1e-6",
                "tie_embeddings=true"]
GEMMA_SERVE = [a for o in GEMMA_WIDTHS + ["attention_impl=flash"] for a in ("--override", o)]
# Path 15's training: 3 steps at depth 4, B=1, S=2048, as paths 3-5 (bf16
# masters, adafactor, flash, the fused loss, full remat).
GEMMA_TRAIN_ARGS = ["model." + o for o in GEMMA_WIDTHS] + [
    "model.num_layers=4", "model.param_dtype=bfloat16", "model.attention_impl=flash",
    "model.loss_impl=fused", "model.loss_block_tokens=4096", "model.remat=full",
    "train.optimizer=adafactor", "train.warmup_steps=1", "train.total_steps=3",
    "train.log_every=1", "data.synthetic=true", "data.batch_size=1", "data.seq_len=2048"]
# Its float16 leg: float16 compute over f32 masters (path 13's dtypes); its
# f32 leg: f32 masters and compute.
GEMMA_F16_ARGS = [a.replace("model.param_dtype=bfloat16", "model.param_dtype=float32")
                  for a in GEMMA_TRAIN_ARGS] + ["model.dtype=float16"]
GEMMA_F32_ARGS = [a.replace("model.param_dtype=bfloat16", "model.param_dtype=float32")
                  for a in GEMMA_TRAIN_ARGS] + ["model.dtype=float32"]
# The serving runs of paths 14 and 15: (tag, server flags, compute dtype, int8
# pools). Each runs plain, then with --speculative on.
HD_SERVE_RUNS = [
    ("bf16", [], "bfloat16", False),
    ("int8", ["--kv-quant", "int8"], "bfloat16", True),
    ("f16", ["--override", "dtype=float16"], "float16", False),
    ("f16-int8", ["--override", "dtype=float16", "--kv-quant", "int8"], "float16", True),
    ("f32", ["--override", "dtype=float32"], "float32", False),
    ("f32-int8", ["--override", "dtype=float32", "--kv-quant", "int8"], "float32", True),
]


def _hd_serve(flash, paged, base: list, tag: str, dtype: str, int8: bool, spec: bool,
              against: dict | None, max_total: int | None = None):
    """One serving run of paths 14-17: ``infer/server.py`` as ``create_server``
    builds it from ``base`` plus ``--engine continuous --cache-mode paged
    --slots 8 --page-size 256 --max-cache-len 2048`` (and ``--speculative
    on``), the continuous traffic over HTTP (speculative: its greedy
    requests plus the span prompts). The single-query K3 of the run's pools
    and dtype on every decode step of every layer (speculative: the verify
    on every round), no other paged kernel, K1 on every cold prefill where
    ``attention_impl=flash`` (none at D = 32, where the reference's dispatch
    and the port take plain attention). Without
    speculation one decode step's logits against the plain paged version
    (``_check_decode_step``); greedy tokens against ``against`` (a run's
    outputs by prompt) or, where None, the same requests through the plain
    versions on a plain engine over the same weights, each identical or a
    near-tie; a greedy request sent twice gives the same tokens twice. With
    ``max_total``, every request's prompt plus new tokens stays under it.
    Returns the launch counts and the greedy outputs."""
    from ditl_tpu_torch.infer import server as server_mod
    from ditl_tpu_torch.infer.continuous import ContinuousEngine

    server = server_mod.create_server([
        *base, "--device", "cuda", "--host", "127.0.0.1", "--port", "0", "--seed", "0",
        "--engine", "continuous", "--cache-mode", "paged", "--slots", "8", "--page-size",
        "256", "--max-cache-len", "2048", *(["--speculative", "on"] if spec else [])])
    gen = server.RequestHandlerClass.generator
    engine = server.engine._engine
    cfg, tok = gen.cfg, gen.tokenizer
    require((cfg.dtype, cfg.kv_cache_dtype == "int8", engine.speculative) == (dtype, int8, spec),
            cfg)
    recording = _recording_engine(engine)
    server.engine.close()  # the server's own engine thread; the recording one takes over
    server.RequestHandlerClass.threaded_engine = recording
    server.engine = recording
    sfx = DTYPE_SFX[dtype][0]
    kernel = ("paged_verify" if spec else "paged_tail") + ("_int8" if int8 else "") + sfx
    requests = _continuous_requests()[0]
    if spec:
        requests = [p for p in requests + _span_requests() if not p.get("temperature")]
    longest = max(1 + len(tok.encode(p["prompt"])) + p["max_tokens"] for p in requests)
    require(max_total is None or longest < max_total, (tag, longest, max_total))
    outputs, n, other, st, wall = _serve_greedy(server, recording, flash, paged, requests,
                                                _counter(kernel))
    k1 = getattr(flash, "launches" + sfx)  # read right after
    k1_others = sum(getattr(flash, c) for _, _, c in flash._ENTRIES.values()) - k1
    layers = cfg.num_layers
    steps = st["speculative"]["verify_rounds"] if spec else st["decode_steps"]
    require(n == layers * steps > 0 and other == 0, (tag, n, other, steps))
    # K1 runs where the reference's dispatch takes its kernel (D = 64 or a
    # multiple of 128, here at the engine's 2048-token buckets)
    flash_on = cfg.attention_impl == "flash" and flash.supports(2048, 2048, cfg.head_dim)
    want_k1 = layers * st["prefills_cold"] if flash_on else 0
    require(k1_others == 0 and (spec or k1 == want_k1), (tag, k1, want_k1, k1_others))
    log(f"[{tag}] {cfg.name} D={cfg.head_dim} {layers} layers, {dtype}"
        f"{' over int8 pools' if int8 else ''}{', --speculative on' if spec else ''}: "
        f"{len(requests)} requests in {wall:.3f}s; {kernel} launches {n} = {layers} layers x "
        f"{steps} {'verify rounds' if spec else 'decode steps'}, no other paged kernel; "
        f"K1{sfx} launches {k1} ({st['prefills_cold']} cold prefills"
        f"{'' if flash_on else ': plain attention, as the reference dispatches'}) ({SMI})")
    if not spec:
        _check_decode_step(engine, paged, tag, kernel)
    greedy_keys = {(tuple([tok.bos_id] + tok.encode(p["prompt"])), p["max_tokens"])
                   for p in requests if not p.get("temperature")}
    greedy = {key: outs for key, outs in outputs.items() if key in greedy_keys}
    require(any(len(outs) > 1 for outs in greedy.values())
            and all(o == outs[0] for outs in greedy.values() for o in outs), tag)
    if against is None:
        fwd, wrapper = flash.flash_attention_fwd, paged.paged_attention
        flash.flash_attention_fwd = flash.flash_attention_plain
        paged.paged_attention = paged.paged_attention_plain
        try:
            plain_engine = ContinuousEngine(gen.params, cfg, tok, n_slots=8, decode_chunk=16,
                                            max_cache_len=2048, cache_mode="paged",
                                            page_size=256, device="cuda")
            rid = {plain_engine.submit(list(ids), max_new_tokens=m): (ids, m)
                   for ids, m in sorted(greedy)}
            against = {rid[r]: [toks] for r, toks in plain_engine.run().items()}
            del plain_engine
        finally:
            flash.flash_attention_fwd, paged.paged_attention = fwd, wrapper
    pairs = [(list(key[0]), o, against[key][0]) for key in sorted(greedy) if key in against
             for o in greedy[key]]
    require(len(pairs) >= 8, (tag, len(pairs)))
    _check_against(gen, cfg, pairs, tag)
    del server, gen, engine, recording
    return {kernel: n, "flash_fwd" + sfx: k1}, greedy


def phase_head_dim_serve(flash, paged, path: int) -> dict:
    """Main path 14 (``infer/server.py --preset tiny-llama --engine continuous
    --cache-mode paged``, the README's quick start: D = 32, 8/4 heads, hidden
    256, vocab 32000, 4 layers, weights from seed 0), path 15
    (``GEMMA_SERVE``: D = 256, 8 heads on 1 KV head, ``attention_impl=flash``;
    full depth in bf16, then every run at depth 2), path 16
    (``LLAMA405_SERVE``: G = 16; bf16 at depth 4, plain and speculative,
    then every other run at depth 2) or path 17 (``PHI3_SERVE``: D = 96;
    as path 15, every request under the 2047-token sliding window): each of
    ``HD_SERVE_RUNS`` through ``_hd_serve``, plain (greedy tokens held to the
    plain versions') and then with ``--speculative on`` (held to the plain
    run's), so every single-query and verify form at that shape launches
    on a run. Returns the launch counts summed by kernels-line name."""
    import gc

    import torch

    depth2 = ["--override", "num_layers=2"]
    total: dict = {}
    for tag, flags, dtype, int8 in HD_SERVE_RUNS:
        if path == 14:
            base, depths = ["--preset", "tiny-llama", *flags], [([], (False, True))]
        elif path == 16:
            base = [*LLAMA405_SERVE, *flags]
            depths = [([] if tag == "bf16" else depth2, (False, True))]
        else:
            base = [*(GEMMA_SERVE if path == 15 else PHI3_SERVE), *flags]
            depths = ([([], (False,))] if tag == "bf16" else []) + [(depth2, (False, True))]
        for depth, specs in depths:
            plain_out = None
            for spec in specs:
                label = f"path{path}-{tag}" + ("-depth2" if depth else "") + (
                    "-spec" if spec else "")
                counts, outs = _hd_serve(flash, paged, base + depth, label, dtype, int8, spec,
                                         plain_out if spec else None,
                                         PHI3_WINDOW if path == 17 else None)
                plain_out = plain_out if spec else outs
                for key, value in counts.items():
                    total[key] = total.get(key, 0) + value
                gc.collect()
                torch.cuda.empty_cache()
    log(f"[path{path}] launches by kernel: {total}")
    return total


def phase_head_dim_train(flash) -> dict:
    """Main path 15's training: ``train()`` on ``GEMMA_TRAIN_ARGS`` (D = 256 at
    gemma-2b's widths, depth 4, B=1, S=2048, bf16 masters, adafactor, flash,
    the fused loss, full remat), 3 steps: finite, falling losses; K1 2 x 4 a
    step, K2a and K2b 4 a step (D = 256), no other dtype's kernel. Then one
    step at depth 4 through the kernels against the plain versions
    (``STEP_LOSS_TOL``/``STEP_GNORM_TOL``), one float16 step at depth 2
    (``GEMMA_F16_ARGS``: K1-f16, K2a-f16, K2b-f16 against the plain versions,
    bf16's tolerances, which §2 holds the float16 kernels to), and one f32
    step at depth 2 (``GEMMA_F32_ARGS``: K1-f32, K2a-f32, K2b-f32,
    ``F32_STEP_LOSS_TOL``/``F32_STEP_GNORM_TOL``). Returns the launch
    counts."""
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.train.trainer import train

    config, device = build_config(GEMMA_TRAIN_ARGS)
    cfg = config.model
    require((cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
             cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.tie_embeddings,
             cfg.param_dtype, cfg.attention_impl, device)
            == (256000, 2048, 16384, 4, 8, 1, 256, True, "bfloat16", "flash", "cuda"), cfg)
    counters = [c for _, _, c in flash._ENTRIES.values()]
    flash.reset_launches()  # this path's counts start here
    summary = train(config, device=device)
    counts = {c: getattr(flash, c) for c in counters}  # read right after the run
    losses = summary["losses"]
    steps, layers = config.train.total_steps, cfg.num_layers
    require(summary["steps"] == steps and all(x == x and abs(x) != float("inf")
                                              for x in losses) and losses[-1] < losses[0],
            losses)
    want = {c: 0 for c in counters}
    want.update(launches=2 * layers * steps, launches_dq=layers * steps,
                launches_dkv=layers * steps)
    require(counts == want, (counts, want))
    tps = summary["tokens_per_sec_per_chip_p50"]
    mfu = _model_flops_per_token(cfg, config.data.seq_len) * 3 * tps / H100_BF16_FLOPS
    log(f"[path15-train] {cfg.name} at depth {layers} ({summary['params_m']:.1f}M parameters, "
        f"D = 256, bf16 masters, adafactor, flash, fused loss, full remat) B=1 S=2048, "
        f"{steps} steps: losses {[round(x, 4) for x in losses]}; step p50 "
        f"{summary['step_time_p50_s']:.3f} s, {tps:.1f} tokens/s, MFU {mfu:.1%}, peak "
        f"{summary['peak_device_memory_gib']:.2f} GiB; K1 {counts['launches']} = 2 x {layers} "
        f"x {steps}, K2a {counts['launches_dq']} and K2b {counts['launches_dkv']} = {layers} x "
        f"{steps} ({SMI})")
    parity = phase_train_parity(flash, GEMMA_TRAIN_ARGS, num_layers=4, tag="path15-train")
    f16 = phase_train_parity(flash, GEMMA_F16_ARGS, num_layers=2, tag="path15-train-f16")
    f32 = phase_train_parity(flash, GEMMA_F32_ARGS, num_layers=2,
                             tols=(F32_STEP_LOSS_TOL, F32_STEP_GNORM_TOL), tag="path15-train-f32")
    launched = {"flash_fwd": counts["launches"], "flash_dq": counts["launches_dq"],
                "flash_dkv": counts["launches_dkv"]}
    return {k: sum(d.get(k, 0) for d in (launched, parity, f16, f32))
            for k in {**launched, **parity, **f16, **f32}}


# ---------------------------------------------------------------------------
# Any group count, any verify rows, any head dim up to 256 that is a multiple
# of 16 (paths 16 and 17)
# ---------------------------------------------------------------------------

# Path 16: Llama-3.1-405B's published widths (meta-llama/Llama-3.1-405B,
# config.json: vocab 128256, hidden 16384, intermediate 53248, 126 layers,
# 128 heads on 8 KV heads, head_dim 128, rope_theta 500000 with the llama3
# rope scaling of factor 8) from the ``llama31-70b`` preset, its family at
# smaller widths (vocab, rope and its scaling as published), by overrides:
# not a preset. G = 16. Depth 4 of 126 (34 GB of weights; the kernels are
# per layer).
LLAMA405_WIDTHS = ["name=llama31-405b-widths", "hidden_size=16384",
                   "intermediate_size=53248", "num_heads=128", "num_kv_heads=8",
                   "head_dim=128", "num_layers=4", "attention_impl=flash"]
LLAMA405_SERVE = ["--preset", "llama31-70b",
                  *[a for o in LLAMA405_WIDTHS for a in ("--override", o)]]
# Path 17: microsoft/Phi-3-mini-4k-instruct's published widths (config.json:
# vocab 32064, hidden 3072, intermediate 8192, 32 layers, 32 heads and 32 KV
# heads, head_dim 3072 / 32 = 96, rope_theta 10000, rms_norm_eps 1e-5,
# untied, 4096 positions; its fused qkv and gate_up are a weight layout of
# the same products) as the repo's Llama architecture, full depth (3.82B
# parameters). Its sliding_window of 2047 never binds while every request
# holds fewer than PHI3_WINDOW tokens, which the runs check.
PHI3_WIDTHS = ["name=phi-3-mini-4k-widths", "vocab_size=32064", "hidden_size=3072",
               "intermediate_size=8192", "num_layers=32", "num_heads=32", "num_kv_heads=32",
               "head_dim=96", "max_seq_len=4096", "rope_theta=10000.0", "rms_norm_eps=1e-5",
               "tie_embeddings=false", "attention_impl=flash"]
PHI3_SERVE = [a for o in PHI3_WIDTHS for a in ("--override", o)]
PHI3_WINDOW = 2047

# The decode tick of path 16 (128 query on 8 KV heads: 16 rows a KV head)
# and path 17 (32 on 32 at D = 96), at the main path's slots, page and tail;
# their spec ticks (Q = 9: 144 and 9 query rows a KV head); and path 16's
# widths at Q = 5 (80 rows: one row group), timed beside its 144 rows.
SHAPE_TICKS = {16: dict(b=8, h=128, kv=8, d=128, ps=256, tail_len=16),
               17: dict(b=8, h=32, kv=32, d=96, ps=256, tail_len=16)}
SHAPE_SPEC_TICKS = {p: dict(m, nq=9, maxp=8, tail_len=54) for p, m in SHAPE_TICKS.items()}
SHAPE_VERIFY_80 = dict(SHAPE_SPEC_TICKS[16], nq=5)
# Single-query cases: (label, b, h, kv, d, ps, tail_len, lengths, starts).
# The decode ticks of paths 16 and 17 with the main path's ragged state;
# Mistral-Large-2's G = 12 at D = 80 (the 128 instance, six of the 16
# chunks of its bf16 rows zero-filled) at the split edges; D = 16 (the 32
# instance) at G = 16 with dead and tail-only slots.
SHAPE_PAGED_CASES = [
    ("path 16 decode tick, G = 16", 8, 128, 8, 128, 256, 16, _paged_main_case()[1],
     _paged_main_case()[0]),
    ("path 17 decode tick, D = 96, G = 1", 8, 32, 32, 96, 256, 16, _paged_main_case()[1],
     _paged_main_case()[0]),
    ("G = 12, D = 80, split edges", 4, 12, 1, 80, 16, 16, [257, 256, 513, 140],
     [257, 250, 500, 128]),
    ("D = 16, G = 16, dead and tail-only slots", 4, 16, 1, 16, 16, 8, [0, 5, 38, 50],
     [0, 0, 38, 45]),
]
# Verify cases: (label, b, nq, h, kv, d, ps, tail_len, lengths, starts,
# maxp). The spec ticks of paths 16 (144 rows) and 17; G =
# 12 at D = 80 (108 rows); D = 16 at G = 16 with a tail longer than 128
# columns (query 0's limit before the split at tail column 128, query 8's
# past it) and a tail-only slot (144 rows).
SHAPE_VERIFY_CASES = [
    ("path 16 spec tick, 144 rows", 8, 9, 128, 8, 128, 256, 54, _spec_main_case()[1],
     _spec_main_case()[0], 8),
    ("path 17 spec tick, D = 96", 8, 9, 32, 32, 96, 256, 54, _spec_main_case()[1],
     _spec_main_case()[0], 8),
    ("G = 12, D = 80, 108 rows", 2, 9, 12, 1, 80, 64, 40, [300, 77], [290, 64], 5),
    ("D = 16, G = 16, long tail, 144 rows", 3, 9, 16, 1, 16, 16, 200, [381, 60, 30],
     [256, 30, 0], 16),
]


def phase_shape_kernels(paged) -> dict:
    """[shape-kernels]: every paged entry point (``HD_PAGED``: K3, K4,
    K3-verify and their int8 forms, in bf16, float16 and f32) at the shapes
    of paths 16 and 17 and one odd case per source (``SHAPE_PAGED_CASES``,
    ``SHAPE_VERIFY_CASES``) against the plain version and the split twin
    (``_close``: bf16 and float16 at ``O_TOL``, f32 within
    ``F32_PAGED_TOL`` of the largest magnitude), two calls the same bits, a
    4-D q with Q = 1 the 3-D call's bits, a dead slot zeros. Returns the
    largest errors by kernels-line name and K4's direct-call launches
    (``<name>_direct``)."""
    worst, counts = _check_paged_entries(paged, HD_PAGED, SHAPE_PAGED_CASES, SHAPE_VERIFY_CASES,
                                         2400, lambda dtype: "shape-kernels")
    for name in ("paged", "paged_f16", "paged_f32"):
        worst[name + "_direct"] = counts[name]
    log(f"[shape-kernels] every paged entry point at G = 12 and 16, 108 and 144 verify rows, "
        f"D = 16, 80 and 96 (on instances {paged.INSTANCE_DIMS}): within tolerance of the "
        f"plain version and the split twin, two calls the same bits ({SMI})")
    return worst


def phase_shape_timings(flash, paged) -> dict:
    """[shape-timing]: every paged entry point of ``HD_PAGED`` at path 16's
    and path 17's decode tick (the verify forms at their spec tick), by
    ``_time_paged``'s rules (CUDA-graph replays over ``PAGED_COPIES`` input
    copies, the plain version, SDPA on keys gathered or dequantized
    beforehand, the bound from bytes); the verify forms also at 80 rows of
    path 16's widths (``SHAPE_VERIFY_80``), so the second row group's cost
    shows beside the 144-row time; K1, K1-f16 and K1-f32 at path 16's
    prefill widths (128 heads on 8 KV heads, D = 128: G = 16) on the serving
    prefill's batch (B=4, S=512, right-padded) against SDPA with the same
    mask, the plain version and the bound, each first held to the plain
    version (``O_TOL``/``LSE_TOL``; f32 ``F32_O_TOL``). Returns
    {kernels-line name: {shape: timing}}."""
    import torch
    import torch.nn.functional as F

    out: dict = {}
    for fwd_name, _, _, dtype_name in HD_FLASH:
        q, k, v, seg = _attn_inputs(4, 512, 512, 128, 8, 128, seed=2500,
                                    lengths=[512, 401, 230, 97],
                                    dtype=getattr(torch, dtype_name))
        mask = torch.ones(512, 512, dtype=torch.bool, device="cuda").tril()[None]
        mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(16, dim=2).transpose(1, 2) for x in (k, v))

        def fwd():
            flash.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)

        def sdpa():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        # Held to the plain version first, as [kernels] and [f32-kernels]
        # hold each dtype's K1.
        o, lse = flash.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
        o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal=True, segment_ids=seg)
        o_err = float((o.float() - o_ref.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        if dtype_name == "float32":
            require(o_err <= F32_O_TOL and lse_err <= F32_O_TOL, (fwd_name, o_err, lse_err))
        else:
            torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
            torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=LSE_TOL)
        log(f"[shape-timing] {fwd_name} path 16 prefill, G = 16: max|o-plain| {o_err:.3e}, "
            f"max|lse-plain| {lse_err:.3e} ok")
        del o, lse, o_ref, lse_ref
        ms = min(_time_ms(fwd), _time_ms(fwd))
        lib_ms = min(_time_ms(sdpa), _time_ms(sdpa))
        plain_ms = _time_ms(lambda: flash.flash_attention_plain(q, k, v, causal=True,
                                                                segment_ids=seg),
                            iters=3, warmup=1)
        bound_ms, bound_by = _flash_bound(q, k, seg, True)
        backend = _sdpa_backend(qt, kt, vt, mask, 0.0, False)
        log(f"[shape-timing] {fwd_name} path 16 prefill, G = 16: B=4 S=512 H=128 K=8 D=128 "
            f"causal, right-padded ({dtype_name}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa (same mask; backend {backend}) {lib_ms:.4f} ms, kernel / sdpa "
            f"{ms / lib_ms:.2f}x, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} "
            f"of bound ({SMI})")
        out.setdefault(fwd_name, {})["path 16 prefill, G = 16"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library": f"sdpa {backend}"}
        del q, k, v, seg, mask, qt, kt, vt
    for name, dtype_name, int8, form in HD_PAGED:
        for path in (16, 17):
            m = (SHAPE_SPEC_TICKS if form == "verify" else SHAPE_TICKS)[path]
            out.setdefault(name, {})[f"path {path}"] = _time_paged(
                paged, name, dtype_name, int8, form, m, "shape-timing")
        if form == "verify":
            t80 = _time_paged(paged, name, dtype_name, int8, form, SHAPE_VERIFY_80,
                              "shape-timing")
            out[name]["path 16, 80 rows"] = t80
            t144 = out[name]["path 16"]
            log(f"[shape-timing] {name} at path 16's widths: 144 rows "
                f"{t144['ms']:.4f} ms against 80 rows {t80['ms']:.4f} ms, "
                f"{t144['ms'] / t80['ms']:.2f}x; bounds {t144['bound_ms']:.4f} / "
                f"{t80['bound_ms']:.4f} ms ({SMI})")
    return out


# The row-tile kernel's shapes for ``--paged-rows``: (label, form, tick):
# the spec ticks of paths 7 (36 rows), 16 (144 rows; its widths at 80
# rows too), 17 (9 rows, D = 96), 14 (D = 32) and 15 (D = 256), path 16's
# decode tick (one query at G = 16), and the main decode tick (G = 4: the
# single-query kernel, beside them).
ROWS_TIMING = [("spec tick, 36 rows", "verify", SPEC_MAIN),
               ("path 16, 144 rows", "verify", SHAPE_SPEC_TICKS[16]),
               ("path 16, 80 rows", "verify", SHAPE_VERIFY_80),
               ("path 17, 9 rows", "verify", SHAPE_SPEC_TICKS[17]),
               ("D = 32", "verify", HD_SPEC_TICKS[32]),
               ("D = 256", "verify", HD_SPEC_TICKS[256]),
               ("path 16, one query, G = 16", "tail", SHAPE_TICKS[16]),
               ("path 16, one query, G = 16", "no_tail", SHAPE_TICKS[16]),
               ("decode tick, G = 4", "tail", PAGED_MAIN),
               ("decode tick, G = 4", "no_tail", PAGED_MAIN)]


def _paged_kernel_ms(paged, dtype_name: str, int8: bool, form: str, m: dict):
    """One paged form's device time on ``_time_paged``'s inputs (the same
    seeds and ragged state): CUDA-graph ms over ``PAGED_COPIES`` input
    copies, the better of two runs, and torch.profiler's device us per call
    by kernel (eager calls)."""
    import torch

    dtype = getattr(torch, dtype_name)
    starts, lengths = _spec_main_case() if form == "verify" else _paged_main_case()
    calls = []
    for c in range(PAGED_COPIES):
        q, kp, vp, table, ln, st, tk, tv = _paged_inputs(
            m["b"], m["h"], m["kv"], m["d"], m["ps"], m["tail_len"], lengths, starts,
            seed=1600 + c, share=False, nq=m.get("nq") if form == "verify" else None,
            maxp=m.get("maxp"), dtype=dtype)
        kw = {}
        if int8:
            kp, vp, ks, vs = _int8_pools(kp, vp)
            kw = dict(k_scale=ks, v_scale=vs)
        if form == "no_tail":
            ln = torch.minimum(st, ln).contiguous()
        else:
            kw.update(tail_k=tk, tail_v=tv, starts=st)
        calls.append(functools.partial(paged.paged_attention, q, kp, vp, table, ln, **kw))
    ms = min(_graph_ms(calls), _graph_ms(calls))
    return ms, _device_us_by_kernel(_cycle(calls), 4 * PAGED_COPIES)


# The forms a later build moved, for ``--paged-rows`` beside ``ROWS_TIMING``:
# (label, form, tick, q dtype, int8 pools). K3-int8 in bf16 and float16 at
# the decode tick, paths 14 and 15 (D = 32 / 256) and path 17 (G = 1, D =
# 96); K3-f32-verify at the spec ticks of paths 11 (36 rows), 16 (144 rows;
# its widths at 80 rows), 17, 14 and 15; K4-f32 at the decode ticks of paths
# 8, 16 and 17.
MOVED_TIMING = (
    [(label, "tail", m, dtype, True)
     for label, m in (("decode tick, G = 4", PAGED_MAIN), ("D = 32", HD_TICKS[32]),
                      ("D = 256", HD_TICKS[256]), ("path 17, G = 1, D = 96", SHAPE_TICKS[17]))
     for dtype in ("bfloat16", "float16")]
    + [(label, "verify", m, "float32", False)
       for label, m in (("spec tick, 36 rows", SPEC_MAIN),
                        ("path 16, 144 rows", SHAPE_SPEC_TICKS[16]),
                        ("path 16, 80 rows", SHAPE_VERIFY_80),
                        ("path 17, 9 rows", SHAPE_SPEC_TICKS[17]),
                        ("D = 32", HD_SPEC_TICKS[32]), ("D = 256", HD_SPEC_TICKS[256]))]
    + [(label, "no_tail", m, "float32", False)
       for label, m in (("decode tick, G = 4", PAGED_MAIN), ("path 16, G = 16", SHAPE_TICKS[16]),
                        ("path 17, G = 1, D = 96", SHAPE_TICKS[17]))])


def phase_rows_timings(paged, tree: str, sweeps: bool) -> None:
    """[rows-timing], for ``python3 chip_smoke.py --paged-rows [TREE]``: the
    bf16 verify over float and int8 pools at each verify shape of
    ``ROWS_TIMING``, and the single query at G = 16 and 4 (K3, K3-int8, K4), by
    ``_paged_kernel_ms``: the whole call's device time and the split kernel
    and the merge apart. With ``sweeps``, where the module has
    ``split_keys`` (the row-tile kernel's split lengths), each also at
    splits of 128, 256 and 512 keys. Then each form of ``MOVED_TIMING``
    the same way; with ``sweeps`` the f32 verify also at splits of 128 and
    256 keys. Uses only the wrapper's signature, so it runs against an older
    tree's module (``TREE`` first on ``sys.path``)."""
    for label, form, m in ROWS_TIMING:
        for int8 in ((False, True) if form != "no_tail" else (False,)):
            name = {"verify": "paged_verify", "tail": "paged_tail", "no_tail": "paged"}[form]
            name += "_int8" if int8 else ""
            ms, by_kernel = _paged_kernel_ms(paged, "bfloat16", int8, form, m)
            log(f"[rows-timing] {tree} {name} {label}: {ms:.4f} ms; by kernel "
                + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(by_kernel.items()))
                + f" ({SMI})")
            if sweeps and hasattr(paged, "split_keys"):
                rule, sweep = paged.split_keys, []
                try:
                    for split in (128, 256, 512):
                        paged.split_keys = lambda *_, n=split: n
                        ms_s = _paged_kernel_ms(paged, "bfloat16", int8, form, m)[0]
                        sweep.append(f"split {split} {ms_s:.4f}")
                finally:
                    paged.split_keys = rule
                log(f"[rows-timing] {tree} {name} {label} split lengths, ms: "
                    f"{', '.join(sweep)} ({SMI})")
    for label, form, m, dtype_name, int8 in MOVED_TIMING:
        name = {"verify": "paged_verify", "tail": "paged_tail", "no_tail": "paged"}[form]
        name += ("_int8" if int8 else "") + DTYPE_SFX[dtype_name][0]
        ms, by_kernel = _paged_kernel_ms(paged, dtype_name, int8, form, m)
        log(f"[rows-timing] {tree} {name} {label}: {ms:.4f} ms; by kernel "
            + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(by_kernel.items()))
            + f" ({SMI})")
        if not (sweeps and form == "verify"):
            continue
        rule, sweep = paged.split_keys, []
        try:
            for split in (128, 256):
                paged.split_keys = lambda *_, n=split: n
                sweep.append(f"split {split} "
                             f"{_paged_kernel_ms(paged, dtype_name, int8, form, m)[0]:.4f}")
        finally:
            paged.split_keys = rule
        log(f"[rows-timing] {tree} {name} {label} sweep, ms: {', '.join(sweep)} ({SMI})")


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    from ditl_tpu_torch.ops import flash_attention as flash
    from ditl_tpu_torch.ops import mlp_bwd
    from ditl_tpu_torch.ops import paged_attention as paged
    from ditl_tpu_torch.ops import projection as proj

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    train_seg = _train_segments()
    errors = phase_kernels(flash, train_seg)
    errors.update(phase_bwd_kernels(flash, train_seg))
    errors.update(phase_paged_kernels(paged))
    errors.update(phase_paged_int8_kernels(paged))
    errors.update(phase_paged_verify_kernels(paged))
    errors.update(phase_f32_kernels(flash, paged, train_seg))
    errors.update(phase_f16_int8_kernels(flash, paged, train_seg))
    errors.update(phase_f16_bwd_kernels(flash, mlp_bwd, proj, paged, train_seg))
    hd_errors = phase_head_dim_kernels(flash, paged, train_seg)
    shape_errors = phase_shape_kernels(paged)
    timings = phase_timings(flash)
    train_timings = phase_train_timings(flash, train_seg)
    timings.update(train_timings)
    timings.update(phase_paged_timings(paged))
    timings.update(phase_paged_int8_timings(paged))
    timings.update(phase_paged_verify_timings(paged))
    timings.update(phase_f32_timings(flash, paged, train_seg))
    timings.update(phase_f16_int8_timings(flash, paged, train_seg))
    timings.update(phase_f16_bwd_timings(flash, mlp_bwd, proj, train_seg))
    hd_timings = phase_head_dim_timings(flash, paged, train_seg)
    shape_timings = phase_shape_timings(flash, paged)
    errors.update(phase_mm_kernels(mlp_bwd, proj))
    timings.update(phase_mm_timings(mlp_bwd, proj))
    errors.update(phase_f32_mm_kernels(mlp_bwd, proj))
    timings.update(phase_f32_mm_timings(mlp_bwd, proj))
    gc.collect()
    torch.cuda.empty_cache()
    gen, lockstep = phase_serve(flash, paged)
    continuous, bf16_summary = phase_serve_continuous(gen, flash, paged)
    spec_serve, spec_summary = phase_serve_spec(gen, flash, paged, bf16_summary)
    gc.collect()
    torch.cuda.empty_cache()
    path18 = phase_serve_draft(gen, flash, paged, bf16_summary, spec_summary)
    gc.collect()
    torch.cuda.empty_cache()
    path19 = phase_serve_chunked(gen, flash, paged, bf16_summary)
    lockstep_spec = phase_lockstep_spec(gen, flash, paged)
    gc.collect()
    torch.cuda.empty_cache()
    path20 = phase_serve_stream(gen, flash, paged, bf16_summary)
    gc.collect()
    torch.cuda.empty_cache()
    path21 = phase_serve_preempt(gen, flash, paged, bf16_summary)
    gc.collect()
    torch.cuda.empty_cache()
    path22 = phase_serve_guided(gen, flash, paged)
    gc.collect()
    torch.cuda.empty_cache()
    path23 = phase_serve_contiguous(gen, flash, paged, bf16_summary)
    gc.collect()
    torch.cuda.empty_cache()
    path24 = phase_serve_telemetry(gen, flash, paged, bf16_summary)
    # Free the bf16 serving weights and pools before path 6's int8 ones.
    del gen, bf16_summary["outputs"]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[int8] after freeing the bf16 serving state: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    int8_serve = phase_serve_int8(flash, paged, bf16_summary)
    gc.collect()
    torch.cuda.empty_cache()
    spec_int8 = phase_spec_depth2(flash, paged, "int8")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[f32-serve] after freeing the int8 serving state: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    f32_serve = phase_dtype_serve(flash, paged, "float32")
    gc.collect()
    torch.cuda.empty_cache()
    f32_spec = phase_spec_depth2(flash, paged, "f32")
    gc.collect()
    torch.cuda.empty_cache()
    f32_int8_serve = phase_dtype_serve(flash, paged, "float32", kv_int8=True,
                                       f32_pools=f32_serve["pool_bytes"])
    gc.collect()
    torch.cuda.empty_cache()
    f32_int8_spec = phase_spec_depth2(flash, paged, "f32-int8")
    gc.collect()
    torch.cuda.empty_cache()
    f16_serve = phase_dtype_serve(flash, paged, "float16")
    gc.collect()
    torch.cuda.empty_cache()
    f16_spec = phase_spec_depth2(flash, paged, "f16")
    gc.collect()
    torch.cuda.empty_cache()
    f16_int8_spec = phase_spec_depth2(flash, paged, "f16-int8")
    gc.collect()
    torch.cuda.empty_cache()
    f32_train = phase_dtype_train(flash, mlp_bwd, proj)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity(flash, F32_TRAIN_ARGS, num_layers=24, batch_size=4,
                       tols=(F32_STEP_LOSS_TOL, F32_STEP_GNORM_TOL), tag="f32-train")
    gc.collect()
    torch.cuda.empty_cache()
    f32_train4 = phase_dtype_train(flash, mlp_bwd, proj, F32_KERNEL_ARGS, "f32-train-kernels")
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity2(mlp_bwd, proj, F32_KERNEL_ARGS, num_layers=24, batch_size=4,
                        tols=(F32_STEP_LOSS_TOL, F32_STEP_GNORM_TOL, F32_STEP2_LEAF_TOL),
                        tag="f32-train-kernels")
    gc.collect()
    torch.cuda.empty_cache()
    f16_train = phase_dtype_train(flash, mlp_bwd, proj, F16_KERNEL_ARGS, "f16-train")
    gc.collect()
    torch.cuda.empty_cache()
    f16_zeros = phase_train_parity2(mlp_bwd, proj, F16_KERNEL_ARGS, num_layers=24, batch_size=4,
                                    tag="f16-train-parity", flash=flash, noise_leg=True)
    gc.collect()
    torch.cuda.empty_cache()
    f16_8b_zeros = phase_train_parity2(mlp_bwd, proj, F16_8B_ARGS, tag="f16-train-parity",
                                       flash=flash)
    gc.collect()
    torch.cuda.empty_cache()
    phase_f1(flash)
    gc.collect()
    torch.cuda.empty_cache()
    path14 = phase_head_dim_serve(flash, paged, 14)
    path15 = phase_head_dim_serve(flash, paged, 15)
    path15_train = phase_head_dim_train(flash)
    gc.collect()
    torch.cuda.empty_cache()
    path16 = phase_head_dim_serve(flash, paged, 16)
    gc.collect()
    torch.cuda.empty_cache()
    path17 = phase_head_dim_serve(flash, paged, 17)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] after freeing the serving state: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    training = phase_train(flash)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity(flash)
    gc.collect()
    torch.cuda.empty_cache()
    training4, summary4 = phase_train_kernels(flash, mlp_bwd, proj)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity2(mlp_bwd, proj)
    gc.collect()
    torch.cuda.empty_cache()
    recipe = phase_recipe(flash, mlp_bwd, proj, summary4["peak_device_memory_gib"])
    gc.collect()
    torch.cuda.empty_cache()
    phase_remat_parity(flash, mlp_bwd, proj)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_serve = phase_checkpoint_serve(flash, paged)
    # Launches per kernel: K1 on both serving paths and both training paths,
    # K2a/K2b on both training paths, K3 on the continuous path, K5a/K5b/K6
    # on training path 4; K4 has no serving path, so its count is the
    # kernels phase's direct calls.
    launches = {"flash_fwd": lockstep["flash_fwd"] + continuous["flash_fwd"]
                + spec_serve["flash_fwd"] + path18["flash_fwd"] + path19["flash_fwd"]
                + lockstep_spec["flash_fwd"]
                + int8_serve["flash_fwd"] + training["flash_fwd"] + training4["flash_fwd"]
                + recipe["flash_fwd"] + ckpt_serve["flash_fwd"],
                "flash_dq": training["flash_dq"] + training4["flash_dq"] + recipe["flash_dq"],
                "flash_dkv": (training["flash_dkv"] + training4["flash_dkv"]
                              + recipe["flash_dkv"]),
                "paged_tail": (continuous["paged_tail"] + path19["paged_tail"]
                               + ckpt_serve["paged_tail"]),
                "paged_tail_int8": int8_serve["paged_tail_int8"] + spec_int8["paged_tail_int8"],
                "paged_verify": spec_serve["paged_verify"] + path18["paged_verify"],
                "paged_verify_int8": spec_int8["paged_verify_int8"],
                "paged": errors.pop("paged_direct_launches"),
                **{k: f32_serve.get(k, 0) + f32_int8_serve.get(k, 0) + f32_train[k]
                   + f32_train4[k] for k in ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32")},
                **{k: f32_train4[k]
                   for k in ("mlp_dgu_dwdown_f32", "mlp_dh_dwgu_f32", "proj_bwd_f32")},
                "paged_tail_f32": f32_serve["paged_tail_f32"] + f32_spec["paged_tail_f32"],
                "paged_verify_f32": f32_spec["paged_verify_f32"],
                "paged_f32": errors.pop("paged_f32_direct_launches"),
                "paged_tail_int8_f32": (f32_int8_serve["paged_tail_int8_f32"]
                                        + f32_int8_spec["paged_tail_int8_f32"]),
                "paged_verify_int8_f32": f32_int8_spec["paged_verify_int8_f32"],
                "flash_fwd_f16": f16_serve["flash_fwd_f16"] + f16_train["flash_fwd_f16"],
                **{k: f16_train[k] for k in ("flash_dq_f16", "flash_dkv_f16",
                                             "mlp_dgu_dwdown_f16", "mlp_dh_dwgu_f16",
                                             "proj_bwd_f16")},
                "paged_tail_f16": f16_serve["paged_tail_f16"] + f16_spec["paged_tail_f16"],
                "paged_verify_f16": f16_spec["paged_verify_f16"],
                "paged_f16": errors.pop("paged_f16_direct_launches"),
                "paged_tail_int8_f16": f16_int8_spec["paged_tail_int8_f16"],
                "paged_verify_int8_f16": f16_int8_spec["paged_verify_int8_f16"],
                **{k: training4[k] + recipe[k]
                   for k in ("mlp_dgu_dwdown", "mlp_dh_dwgu", "proj_bwd")}}
    for name, n in path20.items():  # path 20: streaming, embeddings, API eval
        launches[name] += n
    for name, n in path21.items():  # path 21: preemption, logprobs, deadlines
        launches[name] += n
    for name, n in path22.items():  # path 22: grammar-constrained decoding
        launches[name] += n
    for name, n in path23.items():  # path 23: the contiguous cache, prefixes
        launches[name] += n
    for name, n in path24.items():  # path 24: serving telemetry
        launches[name] += n
    require(path24["flash_fwd"] >= 1 and path24["paged_tail"] >= 1, path24)
    require(min(path22[k] for k in ("flash_fwd", "paged_tail", "paged_verify")) >= 1, path22)
    require(path23["flash_fwd"] >= 1, path23)
    require(lockstep["flash_fwd"] >= 1 and continuous["flash_fwd"] >= 1,
            (lockstep, continuous))
    # Paths 14 (D = 32), 15 (D = 256), 16 (G = 16) and 17 (D = 96): their
    # launches join each kernel's, K4's direct calls at those shapes its
    # direct count, and each kernel's error is its worst at any shape.
    by_dim = {}
    for name in KERNELS:
        by_dim[name] = {"14": path14.get(name, 0), "15": path15.get(name, 0)
                        + path15_train.get(name, 0), "16": path16.get(name, 0),
                        "17": path17.get(name, 0)}
        launches[name] = (launches.get(name, 0) + hd_errors.pop(name + "_direct", 0)
                          + shape_errors.pop(name + "_direct", 0) + sum(by_dim[name].values()))
        for extra in (hd_errors, shape_errors):
            if name in extra:
                errors[name] = max(errors[name], extra[name])
    # Every single-query and verify form ran on paths 14 (D = 32), 15 (D =
    # 256), 16 (G = 16, 144-row verify) and 17 (D = 96); K1, K2a, K2b in
    # every dtype on path 15, and K1 in every dtype at G = 16 on path 16.
    for name in KERNELS:
        forms = name.startswith("paged_") and name not in ("paged_f16", "paged_f32")  # not K4
        d256 = forms or name.startswith("flash_")
        k1 = name.startswith("flash_fwd")
        require((not forms or min(by_dim[name][p] for p in ("14", "16", "17")) > 0)
                and (not d256 or by_dim[name]["15"] > 0) and (not k1 or by_dim[name]["16"] > 0),
                (name, by_dim[name]))
    kernels = []
    for name, meta in KERNELS.items():
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on its path")
        kernels.append({"name": name, **meta, "launches": launches[name],
                        "launches_paths_14_17": by_dim[name],
                        "launches_paths_18_19": {"18": path18.get(name, 0),
                                                 "19": path19.get(name, 0)},
                        "launches_path_20": path20.get(name, 0),
                        "launches_path_21": path21.get(name, 0),
                        "launches_path_22": path22.get(name, 0),
                        "launches_path_23": path23.get(name, 0),
                        "launches_path_24": path24.get(name, 0),
                        "max_abs_err": errors[name], **timings[name],
                        "at_head_dims": hd_timings.get(name, {}),
                        "at_shapes": shape_timings.get(name, {})})
    log(f"[done] launches by path: lock-step {lockstep}, continuous {continuous}, "
        f"speculative continuous {spec_serve}, draft-model speculation (path 18) {path18}, "
        f"chunked prefill under a budget (path 19) {path19}, "
        f"lock-step speculative {lockstep_spec}, streaming, embeddings and API eval "
        f"(path 20) {path20}, preemption, logprobs and deadlines (path 21) {path21}, "
        f"grammar-constrained decoding (path 22) {path22}, the contiguous cache and "
        f"registered prefixes (path 23; K3 from its paged legs only) {path23}, "
        f"serving telemetry (path 24; K3 from its paged engine leg) {path24}, "
        f"int8 serving {int8_serve}, speculative over int8 pools {spec_int8}, "
        f"f32 serving {f32_serve}, f32 speculative {f32_spec}, f32 over int8 pools "
        f"{f32_int8_serve}, its speculation {f32_int8_spec}, float16 serving {f16_serve}, "
        f"its speculation {f16_spec}, float16 over int8 pools with speculation "
        f"{f16_int8_spec}, f32 training {f32_train}, "
        f"f32 training under the kernel flags {f32_train4}, float16 training under the kernel "
        f"flags {f16_train} (zero gradient entries: qwen2-0.5b {f16_zeros}, llama3-8b at "
        f"depth 2 {f16_8b_zeros}), "
        f"training {training}, training with the MLP and projection kernels {training4}, "
        f"the recipe under its three policies {recipe}, the served checkpoint "
        f"{ckpt_serve}, path 14 (tiny-llama, D = 32) {path14}, path 15 (D = 256) {path15}, "
        f"its training {path15_train}, path 16 (G = 16) {path16}, path 17 (D = 96) {path17}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def tree_main(mode: str, tree: str | None, sweeps: bool) -> int:
    """``--paged-rows [--sweep] [TREE]`` and ``--f32-mm [--sweep] [TREE]``:
    the card's name and limit, then TREE's ``ditl_tpu_torch`` (default: this
    checkout's). ``--paged-rows``: ``phase_rows_timings``, with the
    split-length sweep under ``--sweep``. ``--f32-mm``: ptxas' lines of
    ``gemm_f32.cu``, ``phase_f32_mm_timings``, then ``_f32_digests``, each
    logged beside ``F32_DIGESTS``' value (an older tree's bits may differ
    by design, so nothing is required of them), and under ``--sweep``
    ``phase_f32_split_sweep``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ditl_tpu_torch.ops import paged_attention as paged

    if mode == "--paged-rows":
        log(f"[rows-timing] ditl_tpu_torch from {os.path.dirname(paged.__file__)}")
        phase_card()
        phase_rows_timings(paged, tree or ".", sweeps)
        return 0
    from ditl_tpu_torch.ops import mlp_bwd
    from ditl_tpu_torch.ops import projection as proj
    from ditl_tpu_torch.ops.cuda_build import build_library

    tag = "f32-mm-timing"
    log(f"[{tag}] ditl_tpu_torch from {os.path.dirname(mlp_bwd.__file__)}")
    phase_card()
    _log_ptxas("gemm_f32.cu", build_library("gemm_f32.cu"), tag)
    phase_f32_mm_timings(mlp_bwd, proj)
    for key, value in _f32_digests(None, mlp_bwd, proj).items():
        log(f"[{tag}] {tree or '.'} digest {key}: {value} (F32_DIGESTS: "
            f"{F32_DIGESTS.get(key)})")
    if sweeps:
        phase_f32_split_sweep(mlp_bwd, proj)
    return 0


def path20_main() -> int:
    """``--path20``: the card, the build, paths 1 and 2 (path 20's weights
    and its TTFT yardstick), then path 20 alone; no kernels line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from ditl_tpu_torch.ops import flash_attention as flash
    from ditl_tpu_torch.ops import paged_attention as paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    gen, _ = phase_serve(flash, paged)
    _, bf16_summary = phase_serve_continuous(gen, flash, paged)
    t0 = time.perf_counter()
    phase_serve_stream(gen, flash, paged, bf16_summary)
    log(f"[done] path 20 in {time.perf_counter() - t0:.1f}s, all in "
        f"{time.perf_counter() - t_start:.1f}s")
    return 0


def path21_main() -> int:
    """``--path21``: the card, the build, paths 1 and 2 (path 21's weights
    and its tokens/s yardstick), then path 21 alone; no kernels line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from ditl_tpu_torch.ops import flash_attention as flash
    from ditl_tpu_torch.ops import paged_attention as paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    gen, _ = phase_serve(flash, paged)
    _, bf16_summary = phase_serve_continuous(gen, flash, paged)
    t0 = time.perf_counter()
    phase_serve_preempt(gen, flash, paged, bf16_summary)
    log(f"[done] path 21 in {time.perf_counter() - t0:.1f}s, all in "
        f"{time.perf_counter() - t_start:.1f}s")
    return 0


def path22_main() -> int:
    """``--path22``: the card, the build, paths 1 and 2 (path 22's weights
    and engine shape), then path 22 alone; no kernels line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from ditl_tpu_torch.ops import flash_attention as flash
    from ditl_tpu_torch.ops import paged_attention as paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    gen, _ = phase_serve(flash, paged)
    phase_serve_continuous(gen, flash, paged)
    t0 = time.perf_counter()
    launches = phase_serve_guided(gen, flash, paged)
    require(min(launches[k] for k in ("flash_fwd", "paged_tail", "paged_verify")) >= 1,
            launches)
    log(f"[done] path 22 in {time.perf_counter() - t0:.1f}s, all in "
        f"{time.perf_counter() - t_start:.1f}s")
    return 0


def path23_main() -> int:
    """``--path23``: the card, the build, paths 1 and 2 (path 23's weights
    and path 2's tokens, its yardstick), then path 23 alone; no kernels
    line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from ditl_tpu_torch.ops import flash_attention as flash
    from ditl_tpu_torch.ops import paged_attention as paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    gen, _ = phase_serve(flash, paged)
    _, bf16_summary = phase_serve_continuous(gen, flash, paged)
    t0 = time.perf_counter()
    launches = phase_serve_contiguous(gen, flash, paged, bf16_summary)
    require(launches["flash_fwd"] >= 1, launches)
    log(f"[done] path 23 in {time.perf_counter() - t0:.1f}s, all in "
        f"{time.perf_counter() - t_start:.1f}s")
    return 0


def path24_main() -> int:
    """``--path24``: the card, the build, paths 1 and 2 (path 24's weights,
    engine shape and yardstick tokens), then path 24 alone; no kernels
    line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from ditl_tpu_torch.ops import flash_attention as flash
    from ditl_tpu_torch.ops import paged_attention as paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    gen, _ = phase_serve(flash, paged)
    _, bf16_summary = phase_serve_continuous(gen, flash, paged)
    t0 = time.perf_counter()
    launches = phase_serve_telemetry(gen, flash, paged, bf16_summary)
    require(launches["flash_fwd"] >= 1 and launches["paged_tail"] >= 1, launches)
    log(f"[done] path 24 in {time.perf_counter() - t0:.1f}s, all in "
        f"{time.perf_counter() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--path24"]:
        sys.exit(path24_main())
    if sys.argv[1:2] == ["--path23"]:
        sys.exit(path23_main())
    if sys.argv[1:2] == ["--path20"]:
        sys.exit(path20_main())
    if sys.argv[1:2] == ["--path21"]:
        sys.exit(path21_main())
    if sys.argv[1:2] == ["--path22"]:
        sys.exit(path22_main())
    if sys.argv[1:2] in (["--paged-rows"], ["--f32-mm"]):
        rest = sys.argv[2:]
        sys.exit(tree_main(sys.argv[1], next((a for a in rest if a != "--sweep"), None),
                           "--sweep" in rest))
    sys.exit(main())
