#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``--profile-second-slice``, ``--profile-lm``, ``--store-child``,
``--train-full``, ``--train-mesh`` and ``--serve-mesh`` are the child
processes that ``main`` starts.  ``python3 chip_smoke.py
--control-readings`` also takes the two one-off control readings beside
the limits of phases 12 and 16, ``k4_limit_reading`` and
``k5_lm_limit_reading``: what a known defect reads there.)

Phases, in order; any failure exits non-zero without the result line:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — compile kernels K1 (``bsr_spgemm``), K2 (``bsr_spmm``), K3
   (``block_sparse_attention``), K4 (``flash_attention``) and its backward
   (``flash_attention_bwd``), K5 (``moe_gemm``) and its backward
   (``moe_gemm_bwd``), K6 (``rwkv6_scan``) and its backward
   (``rwkv6_scan_bwd``),
   one nvcc each, all started together, and print ptxas's report;
3. kernel against plain — K1 against ``bsr_spgemm_plain`` on the card at
   the filter3D sync-plan shapes, on one bucketed chunk schedule with its
   dead trailing group (both bs = 128: 3xTF32 on ``wgmma``), and at
   bs = 32 (IEEE FMAs); limit 1e-5, TF32 off (``k1_cases``);
4. main path — ``ReapRuntime(device="cuda")`` at Table I sizes: filter3D
   A·A (auto → chunked block path, K1), again with fresh values (plan cache
   hit), cage12 A·A (auto → gather path), filter3D through the sync block
   path, and Pre_poisson Cholesky in float64, overlapped and sync.  Each
   SpGEMM is held against ``spgemm_ref_numpy`` (exact CSR structure, values
   to rtol = atol = 1e-4), each factor against ``cholesky_baseline_numpy``
   and by its residual ‖L·Lᵀ − A‖_F / ‖A‖_F ≤ 1e-10 from sparse products;
   warm SpGEMM calls must upload no K1 schedule;
5. times — wall time per call (and the numpy references' host time),
   device busy share of warm calls under ``torch.profiler``, K1 / plain /
   library yardstick (``torch.bmm`` + ``index_add_``) from CUDA events at
   the filter3D sync-plan shapes, K1 on one chunk with and without its
   bucketed dead tail, K1's bound in 3xTF32 (its design) beside one fp32
   FMA a product, the carry depth, the timed calls' schedule uploads
   (none), peak device memory;
6. kernel against plain — K2 against ``bsr_spmm_plain`` at the filter3D
   ``spmm`` shapes (T = 256), the same stacked on its negation (outputs
   that nearly cancel, so the absolute term of the limit decides) and the
   cant ``spmv`` shapes (T = 1), limit 1e-4, the two filter3D cases also,
   as a reading, with the plain version against float64; K3 against
   ``block_sparse_attention_plain`` at the Llama-3-8B attention shape
   (32 q heads, 8 kv heads, head dim 128, S = 8192, block 128, causal
   sliding window of 8 blocks plus global block 0) in float32
   with softcap 0 and 50 (limit 1e-4) and in bfloat16 (limit 2e-2), then
   at ``K3_SHAPES`` (head dims 256 and 16, blocks 16, 32 and 64) in both
   types;
7. main path, second slice — ``run("spmm")`` on filter3D with T = 256, cold
   and warm with fresh X and W values, against scipy's ``(Wᵀ·Xᵀ)ᵀ`` at
   1e-4; ``cg_solve`` on cant in float32 with the planned Cholesky
   preconditioner at tol 1e-5, cold and again on rescaled coefficients
   (zero ``spmv`` and ``cholesky`` misses), by its true residual
   ‖A·x − b‖/‖b‖ ≤ 1e-4; ``cg_solve`` on Pre_poisson in float64 (the plain
   executor) at tol 1e-10, residual ≤ 1e-8; ``run("block_attention")`` at
   the Llama-3-8B shape, cold and warm, against a float64 dense masked
   attention on the card on 4 of the 32 heads at 1e-4, and once more with
   ``ReapRuntime(device="cuda", block=16)`` at S = 2048.  K2 must launch
   once per spmm call and once per float32 CG iteration, K3 once per
   attention call, and the warm attention call must upload no schedule;
8. times — K2, K3, their plain versions and a library yardstick
   (``torch.sparse.mm`` on a sparse CSR tensor; ``scaled_dot_product_attention``
   with the dense boolean block mask) from CUDA events, each kernel's bound
   (K2's and K3's in 3xTF32, their design, beside one fp32 FMA a product);
   K3 through the plan's memoized schedule (``block_sparse_attention_plan``,
   ``block_attention_execute``'s route) in float32 and in bfloat16 beside
   its bf16 bound, with its carry depth and the timed calls' uploads; K2 per
   call (the wrapper, host included) and on the device (calls captured in
   a CUDA graph) at T = 256 and T = 1, with the schedule uploads of the
   warm calls (none: the ids stay on the card), the host parts of one CG
   matvec (fingerprint, value pass, upload), K2's outputs at phase 6's
   filter3D and cant inputs as SHA-256 digests, which must equal
   ``K2_DIGESTS`` (bit-identical to the kernel before its helpers moved to
   ``csrc/common.cuh``), and
   wall time and device busy share of one warm call of each op under
   ``torch.profiler``, in a child process (``--profile-second-slice``)
   that runs after phase 11;
9. kernel against plain — K5 against ``moe_gemm_plain`` on the bundles of
   one DBRX-132B MoE layer (d_model 6144, 16 experts, top-4, d_ff_expert
   10752, capacity factor 1.25; float32 weights from a seeded generator on
   the card, 12.7 GB): the gate and down products of a prefill of 2 × 2048
   tokens (cap 1280) and of a decode step of 64 tokens (cap 24), limit
   1e-3, and the bfloat16 gate products of both, limit 2e-2 (the TMA
   routes: tiles at cap 1280, decode at cap 24); K5's outputs as SHA-256
   digests, which must equal ``K5_DIGESTS`` (float32: bit-identical to the
   kernel before its helpers moved to ``csrc/common.cuh``; bfloat16: the
   ``mma.sync`` kernel's, which the TMA routes reproduce bit for bit);
10. main path, third slice — ``moe_ffn_host`` through
   ``ReapRuntime(device="cuda")`` cold and warm at both token counts, each
   against the same layer with the plain ``moe_gemm`` on the card at 1e-4;
   K5 must launch 3 times per call and the warm call must hit the
   ``moe_dispatch`` plan; then a plan store written by one runtime and read
   by a fresh one (a store hit, the same output);
11. times — the warm calls' split (router, routing on the host, dispatch,
   the three K5 launches, combine) and K5, its plain version and
   ``torch.bmm`` (TF32 off) at the four shapes, each beside its bound
   (3xTF32, the design's, and one fp32 FMA a product);
12. kernel against plain — K4 against ``flash_attention_plain`` in
   bfloat16 (the tensor-core kernel, limit 2e-2 and a relative norm
   ‖got − want‖/‖want‖ of 5e-3, beside a reading of what a dropped kv
   tile does to that norm) and float32 (the FMA kernel, 1e-4) at every
   head dim it takes: hymba-1.5b's prefill shapes
   (25 q / 5 kv heads of 64, window 1024, S = 2048, and a ragged S = 100),
   qwen3-1.7b's (16 / 8 heads of 128, causal, S = 2048), gemma2-2b's (8 / 4
   heads of 256, softcap 50, window 4096, S = 2048), reduced_config's head
   dim 16 and a head dim 32 (window 16, S = 300: q tiles whose first kv
   tiles are masked for most rows), and a softcap case; K6 against
   ``rwkv6_plain`` at hymba's SSM heads (H = 25, K = 16, V = 64, T = 2048,
   chunk 64, u = 0, bfloat16 r/k/v), at ``generate``'s batch of 2 and
   1024 tokens, with u ≠ 0 and at decays 1e-6 and 1 − 1e-6, output and
   state (limit 2e-4); K4's outputs as digests, which must equal
   ``K4_DIGESTS`` (as K5's);
13. in situ — hymba-1.5b at full width, 2 layers, float32 compute: a
   2048-token prefill and 4 decode steps on the card (K4, K6) against the
   same params on the host (plain versions), logits within 1e-3;
14. main path, fourth slice — hymba-1.5b as published (32 layers, float32
   params, bfloat16 compute) through ``generate`` (batch 2, prompt 1024,
   gen 16) and ``ServeScheduler.run`` on a seeded 8-request trace (prompt
   lengths 64-2048, gen 8-32, 4 slots of 4096): every request completes
   with in-vocabulary tokens, no slot stays occupied, K4 and K6 launch 32
   times per prefill; then request isolation in float32 compute (each
   request's tokens equal its solo generation's, a top-2 logit gap under
   1e-3 reported as a tie); prefill time per prompt length, TTFT and
   decode-step percentiles, tokens/s, peak memory;
15. times — K4 (with ``scaled_dot_product_attention`` as the yardstick)
   and K6 at the 2048-token prefill by CUDA events, beside their bounds and
   plain versions; K4 and SDPA also at qwen3-1.7b's and gemma2-2b's
   2048-token prefill shapes;
Phases 16-20 run model by model: rwkv6-1.6b's parts of 16, 17, 18 and 20,
then dbrx-132b's parts of 16, 17, 19 and 20.

16. kernel against plain — K6 against ``rwkv6_plain`` at rwkv6-1.6b's
   prefill (B = 2, H = 32, K = V = 64, T = 1024 and 2048, chunk 64,
   u != 0, bfloat16 r/k/v), output and state (limit 2e-4); K5 against
   ``moe_gemm_plain`` at the bundles the in-graph ``moe_ffn`` builds for
   dbrx-132b (a prefill of 2 x 1024: 32 bundles of cap 320; a decode step
   of batch 2: 16 bundles of cap 8), gate and down, bfloat16, each on the
   route ``bf16_route`` names for its shape and counted there
   (``wgmma_tiles`` at cap 320, ``wgmma_decode`` at cap 8; limit 2e-2,
   and 5e-4 on ||err|| / ||want||, beside a control reading: the plain
   version with its sums rounded to bfloat16 every 512-deep slice;
   labelled ``K5-LM``, outside ``K5_DIGESTS``); K4 against
   ``flash_attention_plain`` at dbrx-132b's prefill (B = 2, 48 / 8 heads of
   128, causal, S = 1024, bfloat16; K4's bfloat16 limits);
17. in situ — rwkv6-1.6b at full width, 2 layers (a 1024-token prefill, 4
   decode steps) and dbrx-132b at full width, 1 layer (a 64-token prompt, 1
   decode step), float32 compute, card against host, logits within 1e-3;
   K6 once per layer per prefill, K4 once and K5 three times per layer per
   prefill and K5 three times per decode step;
18. main path, eighth slice, rwkv6-1.6b as published (24 layers, float32
   params, bfloat16 compute): ``generate`` (batch 2, prompt 1024, gen 16) and
   ``ServeScheduler.run`` on a seeded 8-request trace (prompts 64-2048, gen
   8-32, 4 slots of 4096), K6 24 times per prefill, then request isolation
   in float32 compute, as phase 14; at every eviction the slot's K/V and
   recurrent state (``wkv``, ``shift``, ``shift_cm``) must read zero
   (``cache_slot_residue``; occupancy sees no recurrent-only cache), on
   every served model;
19. main path, eighth slice, dbrx-132b at full width, depth cut to 4 layers
   (bfloat16, 28.6 GB): ``generate`` (batch 2, prompt 1024, gen 16), K4 4
   times per prefill and K5 12 times per prefill and per decode step;
   ``ServeScheduler.run`` on a seeded 8-request trace; K5's launches of
   both, by route, on the two TMA routes only (``moe_gemm.routes``); then
   6 decode steps with a host-dispatch runtime installed, logits bit-equal
   to the in-graph run, ``moe_dispatch`` missing on the first step and a
   replay answered from warm plans at every step;
20. times — K6 at rwkv6-1.6b's two prefill shapes, K5 at the four
   in-graph DBRX shapes (prefill on the tile route, decode on the decode
   route, each named) and K4 at dbrx-132b's prefill by CUDA events, each
   beside its bound (bf16 peak; HBM for decode) and plain version, K5 also
   beside one ``torch.bmm`` over (E, rows x cap, d), K4 beside SDPA;
Phases 22 and 23 run after phase 20, then phases 27-31 (31's first runs
before 27, its resumed processes beside 27-29, 30 last), then phases
32-35, then 36-38, then 40-44, then 39, then phase 21.

22. paligemma-3b — K4 against ``flash_attention_plain`` at the image
   prefill's shape (B = 2, 8 q heads / 1 kv head of 256, causal, S = 256 +
   768, bfloat16; K4's bfloat16 limits); in situ, 2 layers at full width in
   float32, card against host within 1e-3: ``forward`` with 256 image tokens
   (prefix-LM, plain attention: no K4), ``prefill`` with the images (causal,
   as in the reference: K4 once a layer) and 4 decode steps; then as
   published (18 layers, float32 params, bfloat16 compute, 15.1 GB): an
   image prefill of batch 2 x (256 + 768) tokens and 16 greedy decode
   steps (K4 18 times, all in the prefill), text-only ``generate`` (batch 2,
   prompt 1024, gen 16) and ``ServeScheduler.run`` on a seeded 8-request
   trace shaped like hymba's (K4 18 times a prefill; no slot left occupied
   or holding K/V at its eviction); K4's time at the image prefill's shape
   beside its bound, plain version and SDPA (``is_causal``, kv repeated to
   8 heads);
23. whisper-small — K4 against ``flash_attention_plain`` at the encoder's
   shape (B = 4, 12 heads of 64, non-causal, S_enc = 1024, bfloat16); in
   situ, 2 + 2 layers at full width in float32: ``forward`` (K4 at each
   encoder layer and each decoder self-attention), ``encdec_prefill``
   (``enc_out``, ``xk``, ``xv``; K4 at each encoder layer) and 4 decode
   steps (no K4), card against host within 1e-3; then as published (12 +
   12 layers): ``generate`` with batch 4, S_enc 1024 (the published 1500
   is refused by both packages' block-size assertion), prompt 4, gen 32:
   K4 12 times, in its ``encdec_prefill``, and never in its 35 decode steps;
   in float32 compute each row's tokens equal its solo generation's (a
   top-2 gap under 1e-3 reported as a tie); K4's time at the encoder's
   shape beside its bound, plain version and SDPA with no mask;
27. kernel against plain — K4's backward (``flash_attention_bwd``: dq,
   dk, dv) against the autograd of ``flash_attention_plain`` at phase 12's
   shapes and at qwen3-1.7b's training shape (B 8, S 256, 16 / 8 heads of
   128, causal), float32 within 1e-4 and bfloat16 within a relative norm
   of 5e-3 for each of dq, dk and dv (max abs error a reading); each case
   run twice, the two bit-identical;
28. in situ — qwen3-1.7b at full width, 2 layers, float32 compute, batch
   1 x 256: the loss and every param leaf's gradient on the card (K4 and
   its backward) against the host (plain versions), each within 1e-3 in
   relative norm; K4 twice a layer (remat) and its backward once;
29. main path, twelfth slice — the train CLI (``repro_torch.launch.
   train.main``) on qwen3-1.7b at full width and depth (28 layers, 1.72 B
   float32 params, bfloat16 compute, remat; params, grads and AdamW m / v
   27.5 GB) for 20 steps of batch 8 x 256, in a child process
   (``--train-full qwen3-1.7b``): losses finite and falling, K4 56 and its
   backward 28 times a step, the plain versions never; step time p50 / p99
   after the first, tokens/s, peak memory; then the device busy share of
   one warm step under ``torch.profiler``;
30. times — K4's backward at qwen3-1.7b's training shape and at S = 2048
   (B 1) by CUDA events, beside its bound (five S x S x D products per head
   over the visible pairs at the bf16 peak, against q, k, v, out and dout
   read once and dq, dk, dv written once), its plain version
   (``flash_attention_plain``'s autograd) and the backward of
   ``scaled_dot_product_attention`` (``is_causal``, kv heads repeated);
31. the reduced train CLI on the card for qwen3-1.7b, gemma2-2b
   (softcap, window; head dim 16), rwkv6-1.6b, hymba-1.5b, dbrx-132b and
   kimi-k2 (a shared expert; both K5 and its backward in float32 at width
   64): 3 steps into
   a checkpoint through ``train.main`` in this process, then ``python -m
   repro_torch.launch.train`` in a process of its own resuming from it to
   step 6, against 6 uninterrupted steps through ``train.main``; every run
   launches K4 (where the layers attend) and K6 (where they scan) twice a
   layer a step and their backward kernels once, K5 six times an MoE layer
   a step and its backward three times, and the resumed losses
   equal the uninterrupted run's within 1e-4 (bit equality a reading);
32. kernel against plain — K6's backward (``rwkv6_bwd``: dr, dk, dv, dw,
   du) against its plain version (``rwkv6_plain``'s autograd, run on
   float64 copies of the inputs: in float32 its dw, a difference of two
   sums of order one divided by w, is about 1e-2 off, a reading) at
   hymba-1.5b's SSM heads (B 2, H 25, K 16, V 64, u = 0) and rwkv6-1.6b's
   (B 2, H 32, K = V = 64, learned u), at T 2048 (chunk 64) and T 2016
   (chunk 32), with and without a dstate, float32 within 1e-4 and bfloat16
   r, k, v within 5e-3 in relative norm for each gradient, each case run
   twice and the two bit-identical; extreme decays (1e-6, 1 - 1e-6); then
   K4's backward at hymba-1.5b's training shape (B 2, 25 / 5 heads of 64,
   window 1024, S 2048), as phase 27;
33. in situ — rwkv6-1.6b and hymba-1.5b at full width, 2 layers, float32
   compute, batch 1 x 256 (4 chunks of 64), as phase 28: every leaf's
   gradient within 1e-3 of the host's; K6 (and hymba's K4) twice a layer,
   their backward kernels once;
34. main path, thirteenth slice — the train CLI on rwkv6-1.6b (24 layers,
   1.68 B params) and hymba-1.5b (32 layers) at full width and depth, 10
   steps of batch 2 x 2048 each, each in a child process (``--train-full
   ARCH``), as phase 29: rwkv6 launches K6 48 and its backward 24 times a
   step, hymba K6 and K4 64 and their backward kernels 32 times a step;
35. times — K6's backward at the two training shapes (bfloat16 r, k, v,
   float32 w, no dstate) by CUDA events, beside its bound (the FLOP of
   ``k6_bwd_flop`` at the bf16 peak, against its inputs read once and its
   outputs written once: bytes-bound), the design's FLOP at the fp32 peak,
   its plain version and K6's forward;
36. kernel against plain — K5's backward (``moe_gemm_bwd``: dx, dw)
   against its plain version (``moe_gemm_bwd_plain``) at ``K5_BWD_CASES``:
   dbrx-132b's training bundles (32 of cap 320, 6144 -> 10752 and 10752 ->
   6144), cap 8, kimi-k2's widths (7168 -> 2048) at cap 24, width 64,
   widths 36 / 260 at cap 131, a map with an expert that no bundle meets
   (its dw must be zeros) and one of a single repeated expert; float32
   within 1e-5 and bfloat16 within 5e-3 in relative norm for each of dx and
   dw, each case run twice and the two bit-identical; then K5 under
   autograd at dbrx-132b's gate shape in bfloat16: its forward bit-equal to
   the no-grad call, its gradients equal to ``moe_gemm_bwd``'s, one K5
   launch and one backward call (dx and dw);
37. in situ — dbrx-132b at full width, 1 layer, float32 compute (bfloat16
   params, the config's), batch 1 x 256 (16 bundles of cap 80), as phase
   28: every leaf's gradient within 1e-3 of the host's; K5 six times, its
   backward three, K4 twice and its backward once;
38. main path, fourteenth slice — the train CLI's code (``train.train``,
   the loop of ``train.main``, on ``get_config("dbrx-132b", n_layers=1)``)
   at full width (d_model 6144, 16 experts top-4 of 10752, vocab 100352),
   depth cut 40 -> 1, bfloat16 params and compute, remat, 10 steps of
   batch 2 x 1024 (32 bundles of cap 320) at ``--lr 1e-4``, in a child
   process
   (``--train-full dbrx-132b``) with the card to itself (53.9 GB of
   params, grads and AdamW state), as phase 29: losses finite and falling,
   K5 six times and its backward three times a step, K4 twice and its
   backward once, the plain versions never, K5's expert map and its
   backward's CSR walk each uploaded once in the run; step p50 / p99, the
   first step, tokens/s, peak memory, the busy share and split of a warm
   step;
39. times — K5's backward at dbrx-132b's training bundles, both
   orientations, bfloat16, by CUDA events: the call (dx and dw) beside its
   bound (each entry 2 x 10240 x 6144 x 10752 FLOP at the bf16 peak), its
   plain version and ``torch.bmm`` on inputs grouped by expert beforehand;
   dx and dw each beside theirs;
40. main path, fifteenth slice — sharded training, in a child process
   (``--train-mesh``) with the card to itself: the train CLI's loop
   (``train.train(cfg, args, mesh=...)``) on qwen3-1.7b at full width and
   depth over a (2, 2) ("data", "model") mesh of ``cuda:0`` x 4 (distinct
   cards where four are visible), 3 steps of batch 8 x 256 at phase 29's
   seed and lr: the params, AdamW's m and v sharded storage on the mesh,
   each data shard gathering the params and taking its loss and gradients
   (K4 and its backward) on its half of the batch.  First the same 3 steps
   on one device, then on the mesh: every param leaf after each step
   within rtol 2e-2 / atol 2e-3 of the one-device step's and the losses
   within 1e-3 (``tests/test_distributed.py``'s tolerances: the first
   step's absolutely, later steps', taken on params that have drifted within
   the param tolerance, relatively); each mesh step's loss within 1e-3 of
   ``loss_fn`` on one device at the params that step took; K4 and its
   backward launch twice as often as on one device; step p50, peak memory
   and whether two runs are bit-identical;
41. the int8 error-feedback compressed step on a (2, 1, 1) ("pod",
   "data", "model") mesh at qwen3-1.7b's full width, 2 steps of 8 x 256
   at lr 1e-2: the params after each step within 5e-2 of the exact step's,
   the first loss within 1e-3, K4 and its backward once a pod; the error
   buffer's norm;
42. ``pipeline_apply`` over a (4, 1) ("pipe", "model") mesh: stages
   ``tanh(h @ w)`` at d 2048 in float32, 8 microbatches of 8 x 256 rows,
   forward and gradient against the stages in sequence within 1e-5;
43. elastic restore: the reference test's reduced gemma2-2b saved from a
   (4, 2) mesh, ``elastic_restore`` on 6 devices onto (3, 2), every leaf
   bit-equal;
44. reduced dbrx-132b, one sharded step on a (2, 2) mesh against one
   device: K5 and its backward (and K4 and its) once per data shard, the
   params within phase 40's tolerances;
45. main path, sixteenth slice — sharded serving, in a child process
   (``--serve-mesh``) after phase 44's: qwen3-1.7b at full width and depth
   (float32 params, bfloat16 compute) on a (2, 2) ("data", "model") mesh
   of ``cuda:0`` x 4, ``make_prefill_step`` over 8 x 1024 tokens, then 16
   ``make_decode_step`` steps on seeded tokens: the params sharded storage,
   each data shard gathering them and its rows of the cache
   (``cache_shardings``), K4 once a layer a data shard (56 a prefill); every
   step's logits and the final cache within 1e-3 of the same steps on one
   device; wall time, peak memory and, beside them, the dry run's
   per-device argument and temp bytes for the same shapes (a reading);
46. the same for rwkv6-1.6b: K6 48 times a prefill;
47. qwen3-1.7b at batch 1, a prompt of 8192 and 8 decode steps: one data
   shard on the mesh's first device, the cache stored with its sequence
   over ``data``, gathered and re-sharded around each step; held to one
   device, and a (1, 1) mesh bit-equal to it;
21. the serving CLI — ``python -m repro_torch.launch.serve --arch A --batch
   2 --prompt-len 64 --gen 4`` on the card for hymba-1.5b, qwen3-1.7b,
   gemma2-2b, rwkv6-1.6b, paligemma-3b (text), whisper-small (frames of
   64 from the seed) and gemma3-27b (the one config with tail layers and
   ``rope_theta_local``) (reduced configs, as the CLI forces: head dim 16),
   each exit 0 with its kernels launched (K4; K6 for hymba and rwkv6),
   and dbrx-132b with ``--routing host --plan-store build/serve_plan_store``
   twice, the second run answering its dispatch plans from the store;
   then phases 24-26 (below); then,
   in child processes, the second slice's profiles and a warm prefill and
   decode step of hymba-1.5b, rwkv6-1.6b and dbrx-132b (4 layers) under
   ``torch.profiler``; last the Pre_poisson Cholesky profile, the whole
   script's time and the kernels line (K1 to K6 and K4's, K5's and K6's
   backward, each with the launches of its main-path phases — K2's of 7
   and 24, K4's of 14, 19, 22, 23, 26, 29, 34, 38, 40, 41, 44, 45 and 47,
   K4's backward's of 29, 34, 38, 40, 41 and 44, K5's of 10, 19, 38 and
   44, K5's backward's of 38 and 44, K6's of
   14, 18, 26, 34 and 46, K6's backward's of 34;
   K4's backward's times at phase 30's shapes, K6's at phase 35's, K5's at
   phase 39's; K1's
   times at the filter3D sync plan, K2's at the spmm shape, K3's at softcap
   0 in float32, K5's at the prefill gate shape, K4's and K6's at the
   2048-token hymba prefill, nested beside them K4's at dbrx-132b's
   prefill, paligemma-3b's image prefill and whisper-small's encoder, K5's
   at the in-graph DBRX shapes and K6's at rwkv6-1.6b's;
   K1's, K2's, K3's and
   K5's bounds in 3xTF32, their design).

Phases 24-26 run after phase 21's CLI runs, before its profiles.

24. sharding — a mesh of 4 shards on the one card (``make_mesh((4,),
   ("data",), devices=["cuda:0"] * 4)``): ``run("spgemm_gather")`` on
   cage12 (exact structure, 1e-4 against ``spgemm_ref_numpy`` and phase
   4's single-host card call; phase 4's two calls are compared bit for bit
   as a reading: atomics merge the partial products), ``run("spmm")`` on
   filter3D at T = 256 and T = 16 (bit-equal to the single-host card call,
   K2 once a shard, at the whole call's regime; K2 on one shard's rows
   timed; a row's bits independent of its place in a row tile) and
   ``run("moe_dispatch")`` at dbrx-132b's prefill routing (4096 tokens, 16
   experts, top-4, capacity 1280, d 6144) on 4 shards and on 3 (the
   fallback), bit-equal; each call cold, warm and from a fresh runtime on
   the same plan store;
25. the kernel-library store — child processes over a fresh
   ``ExecStore``: the first builds every library of ``csrc/`` into it (K1-K6
   and K4's, K6's and K5's backward: 9 ``nvcc`` runs; started before phase
   9, it runs on the host while phases 9-23 run), then, at once, a second
   loads all nine with none, and a third, over a copy of the store with one
   entry's bytes corrupted, counts it corrupt, rebuilds it alone and loads
   eight; those two run every kernel once against its plain version at a
   small shape;
26. serving with the store — ``python -m repro_torch.launch.serve --arch
   hymba-1.5b --continuous --prewarm --exec-store DIR`` on a fresh store
   (its prewarm builds K4 and K6; it runs beside phase 21's CLIs), then
   again, beside phase 25's later children, with
   ``--expect-zero-compiles`` (no ``nvcc``, both loaded from the store,
   exit 0), each process's time and time to first token; then
   ``ServeScheduler.prewarm`` at full width on phase 14's trace: its
   buckets, scheduler state untouched, the first request's time to first
   token without and with it, the completions of both runs equal.

Last, after the profiles (before the script's time and the kernels line):

48. analysis on the card — a child runs ``python -m repro_torch.analysis
   --check src/repro_torch --purity --summary build/reaplint_summary.json``
   (the port's reaplint, then the purity replay with its default device
   ``cuda``: every registered op's plan rebuilt on perturbed values, bit-
   identical), which must exit 0 with no violation and every op PASS; its
   lines and the suppression counts are printed.  Beside it, for each op
   of ``analysis.op_examples.builtin_examples``: the plan built under
   ``device="cuda"`` and under ``"cpu"``, fingerprint and serialized
   payload bit-identical; the op run cold, then warm, through one
   ``ReapRuntime(device="cuda")`` (a miss, then a hit), each result within
   1e-4 of the same op on the host (the conformance battery's chunked-
   against-sync tolerance).

The last line is ``{"ok": true, "device": {...}}``.  Matrices are generated
from fixed seeds with the published (rows, nnz, pattern) of Table I; no
SuiteSparse file is read.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))

# Table I of the paper: (name, rows, nnz, structure of the stand-in)
FILTER3D = ("filter3D", 106_000, 2_700_000, "banded")
CAGE12 = ("cage12", 130_000, 2_000_000, "uniform")
PRE_POISSON = ("Pre_poisson", 12_000, 715_000, "banded")

CANT = ("cant", 62_000, 4_000_000, "blocky")
# Llama-3-8B attention (published config.json): 32 q heads, 8 kv heads,
# head dim 128; one sequence of 8192 tokens in blocks of 128
LLAMA = dict(batch=1, heads=32, kv_heads=8, head_dim=128, seq=8192,
             block=128, window_blocks=8)
SPMM_TOKENS = 256
# K3 at the shapes the Llama case leaves out: (label, H, Hkv, D, S, block,
# softcap); head dims 16 (reduced_config) and 256 (gemma2-2b, 8 q / 4 kv
# heads, softcap 50), and Llama's heads at blocks 16 (the runtime's
# smallest; K1 and K2 take it too) and 32
K3_SHAPES = (("gemma2-2b heads, D=256, S=2048, block 128", 8, 4, 256, 2048,
              128, 50.0),
             ("gemma2-2b heads, D=256, S=2048, block 64", 8, 4, 256, 2048, 64,
              0.0),
             ("reduced config, D=16, S=512, block 16", 4, 2, 16, 512, 16, 0.0),
             ("Llama-3-8B heads, D=128, S=1024, block 16", 32, 8, 128, 1024,
              16, 0.0),
             ("Llama-3-8B heads, D=128, S=1024, block 32", 32, 8, 128, 1024,
              32, 0.0))
# DBRX-132B's MoE layer (src/repro/configs/dbrx_132b.py, published
# databricks/dbrx-base): 16 experts, top-4, capacity factor 1.25 (the
# runtime's default); a prefill of 2 x 2048 tokens and a decode step of 64
DBRX = dict(d_model=6144, n_experts=16, top_k=4, d_ff_expert=10752,
            capacity_factor=1.25)
MOE_CALLS = {"prefill": (2, 2048), "decode": (64, 1)}

# hymba-1.5b (src/repro_torch/configs/hymba_1p5b.py, arXiv:2411.13676): 32
# layers, d_model 1600, 25 q / 5 kv heads of 64, window 1024, SSM state 16;
# float32 params, bfloat16 compute.  The serving trace: 8 requests, prompt
# lengths and generation lengths drawn from these sets, arrival gaps 0-2
HYMBA = "hymba-1.5b"
HYMBA_TRACE = dict(n_requests=8, seed=60, prompt_lens=(64, 256, 1024, 2048),
                   gen_lens=(8, 16, 32), max_gap=2)
HYMBA_SERVE = dict(max_batch=4, max_seq=4096)
HYMBA_GENERATE = dict(batch=2, prompt=1024, gen=16)
HYMBA_SITU = dict(n_layers=2, prompt=2048, decode=4)
# rwkv6-1.6b (src/repro_torch/configs/rwkv6_1p6b.py, arXiv:2404.05892) as
# published: 24 layers, d_model 2048, 32 heads of K = V = 64, d_ff 7168,
# vocab 65536, untied; float32 params, bfloat16 compute.  K6 at its prefill
# shapes: generate's batch of 2 at T = 1024 and 2048 (chunk 64, u != 0)
RWKV6 = "rwkv6-1.6b"
RWKV_K6_T = (1024, 2048)
RWKV_TRACE = dict(HYMBA_TRACE, seed=86)
RWKV_SERVE = dict(max_batch=4, max_seq=4096)
RWKV_GENERATE = dict(batch=2, prompt=1024, gen=16)
RWKV_SITU = dict(n_layers=2, prompt=1024, decode=4)
# dbrx-132b (src/repro_torch/configs/dbrx_132b.py, databricks/dbrx-base) at
# full width: d_model 6144, 48 q / 8 kv heads of 128, 16 experts top-4 of
# d_ff 10752, vocab 100352; bfloat16 params and compute.  Depth cut 40 -> 4
# layers (28.6 GB of params; 40 would be about 263 GB).  K5 at the bundles
# the in-graph moe_ffn builds: a prefill of 2 x 1024 (32 bundles of cap
# 320) and a decode step of batch 2 (16 bundles of cap 8)
DBRX_LM = "dbrx-132b"
DBRX_LAYERS = 4
DBRX_K5_CALLS = {"prefill": (2, 1024), "decode": (1, 2)}
DBRX_TRACE = dict(HYMBA_TRACE, seed=95)
DBRX_SERVE = dict(max_batch=4, max_seq=4096)
DBRX_GENERATE = dict(batch=2, prompt=1024, gen=16)
DBRX_HOST = dict(prompt=256, steps=6)
# in situ at 1 layer and one decode step: each host pass reads the layer's
# 16 experts in float32, the slowest part of the in-situ checks
DBRX_SITU = dict(n_layers=1, prompt=64, decode=1)
# paligemma-3b (src/repro_torch/configs/paligemma_3b.py, arXiv:2407.07726) as
# published: 18 layers, d_model 2048, 8 q heads / 1 kv head of 256, d_ff
# 16384, vocab 257216, tied; 256 image tokens of 1152 (the SigLIP front end
# is a stub in both packages: patch embeddings from a seed); float32 params,
# bfloat16 compute.  An image prefill of batch 2 x (256 + 768) tokens and 16
# decode steps; text-only serving on a trace shaped like hymba's
PALIGEMMA = "paligemma-3b"
PALI_IMAGE = dict(batch=2, text=768, decode=16)
PALI_TRACE = dict(HYMBA_TRACE, seed=101)
PALI_SERVE = dict(max_batch=4, max_seq=4096)
PALI_GENERATE = dict(batch=2, prompt=1024, gen=16)
PALI_SITU = dict(n_layers=2, text=256, decode=4)
# whisper-small (src/repro_torch/configs/whisper_small.py, arXiv:2212.04356)
# as published: 12 encoder + 12 decoder layers, d_model 768, 12 heads of 64,
# d_ff 3072, vocab 51865 (the conv front end is a stub in both packages:
# frame embeddings from a seed).  S_enc 1024, not the published 1500 (30 s
# of audio): both packages refuse 1500, which is no multiple of
# min(1024, S), the attention's block size
WHISPER = "whisper-small"
WHISPER_GENERATE = dict(batch=4, s_enc=1024, prompt=4, gen=32)
WHISPER_SITU = dict(n_layers=2, s_enc=1024, text=16, decode=4)
# the serving CLI on the card (reduced configs, head dim 16); dbrx-132b
# also twice with host routing and one plan store, the second run a restart
SERVE_CLI_ARCHS = ("hymba-1.5b", "qwen3-1.7b", "gemma2-2b", "rwkv6-1.6b",
                   "paligemma-3b", "whisper-small", "gemma3-27b")
SERVE_CLI_ARGS = ["--batch", "2", "--prompt-len", "64", "--gen", "4"]
SERVE_CLI_HOST_MOE = ["--arch", "dbrx-132b", "--routing", "host",
                      "--plan-store"]
# sharded execution (phase 24): 4 shards on the one card, and 3 for the
# MoE fallback (16 experts do not split 3 ways); spmm at phase 7's T and at
# a T whose shards (4 rows) would take K2's GEMV on their own; dbrx-132b's
# prefill routing of 2 x 2048 tokens (capacity 1280 at factor 1.25)
SHARDS, SHARDS_FALLBACK = 4, 3
SHARD_SPMM_TOKENS = (256, 16)
SHARD_MOE = dict(tokens=4096, capacity=1280)
# the kernel-library store (phase 25): the six kernels' libraries, the entry the
# third child finds corrupted (K2: the shortest rebuild), and the stores
# of phases 25 and 26
KERNEL_SOURCES = ("bsr_spgemm", "bsr_spmm", "block_sparse_attention",
                  "flash_attention", "moe_gemm", "rwkv6_scan")
# the backward kernels' libraries: K4's, K6's and K5's
BACKWARD_SOURCES = ("flash_attention_bwd", "rwkv6_scan_bwd", "moe_gemm_bwd")
# what the store children load: every library in csrc/
STORE_KERNELS = KERNEL_SOURCES + BACKWARD_SOURCES
STORE_CORRUPT = "bsr_spmm"
STORE_DIR = ROOT / "build" / "kernel_store"
STORE_DIR_CORRUPT = ROOT / "build" / "kernel_store_corrupt"
SERVE_STORE_DIR = ROOT / "build" / "serve_kernel_store"
SERVE_STORE_ARGS = ["--requests", "8", "--max-batch", "3", "--max-seq", "32",
                    "--expect-completions", "8"]

# qwen3-1.7b (src/repro_torch/configs/qwen3_1p7b.py, Qwen/Qwen3-1.7B) as
# published: 28 layers, d_model 2048, 16 q / 8 kv heads of 128, d_ff 6144,
# vocab 151936, tied, 1.72 B float32 params, bfloat16 compute, remat on.
# The training path: the train CLI at full width and depth, 20 steps of
# batch 8 x 256 (the reference CLI's batch and sequence); in situ, 2 layers
# in float32 compute at batch 1 x 256
QWEN3 = "qwen3-1.7b"
# the train CLI at full width and depth (phases 29 and 34): qwen3-1.7b 20
# steps of batch 8 x 256; rwkv6-1.6b and hymba-1.5b (both as published,
# f32 params, bf16 compute, remat) 10 steps of batch 2 x 2048, 32 chunks of
# 64 a sequence, so that hymba's 1024 window slides.  In situ (phases 28
# and 33): 2 layers at full width in float32, batch 1 x 256 (4 chunks of 64)
# dbrx-132b (phases 37-38) at full width with its depth cut 40 -> 1:
# bfloat16 params and grads and float32 AdamW m / v are 12 bytes a param,
# 53.9 GB for one layer with its embedding and head (4.49 B params), and a
# second layer adds 39.1 GB, past the card's 80 GB.  10 steps of batch
# 2 x 1024: 32 bundles of cap 320, the shapes phase 20 times K5 at.  At the
# CLI's default lr of 3e-3 its loss rose once the warm-up passed 6e-4
# (11.96 -> 14.90 over 10 steps); it trains at --lr 1e-4
TRAIN_FULL = {QWEN3: dict(steps=20, batch=8, seq=256),
              RWKV6: dict(steps=10, batch=2, seq=2048),
              HYMBA: dict(steps=10, batch=2, seq=2048),
              DBRX_LM: dict(steps=10, batch=2, seq=1024, n_layers=1,
                            lr=1e-4)}
TRAIN_SITU = dict(n_layers=2, batch=1, seq=256)
# dbrx-132b in situ (phase 37): 1 layer at full width, float32 compute,
# batch 1 x 256 (16 bundles of cap 80)
DBRX_TRAIN_SITU = dict(TRAIN_SITU, n_layers=1)
# K4's backward against its plain version (phase 27): phase 12's shapes and
# qwen3-1.7b's training shape, label -> (B, H, Hkv, D, S, masks)
K4_BWD_CASES = {
    "qwen3-1.7b training": (TRAIN_FULL[QWEN3]["batch"], 16, 8, 128,
                            TRAIN_FULL[QWEN3]["seq"], {}),
    "hymba S=2048": (1, 25, 5, 64, 2048, dict(window=1024)),
    "hymba S=100 (ragged)": (1, 25, 5, 64, 100, dict(window=1024)),
    "qwen3-1.7b causal S=2048": (1, 16, 8, 128, 2048, {}),
    "softcap 50, window 256, S=1000": (1, 8, 4, 128, 1000, dict(
        window=256, softcap=50.0)),
    "gemma2-2b S=2048": (1, 8, 4, 256, 2048, dict(window=4096,
                                                  softcap=50.0)),
    "reduced config S=300": (1, 4, 2, 16, 300, dict(window=32)),
    "D=32, window 16, S=300": (1, 4, 2, 32, 300, dict(window=16))}
# K4's backward timed (phase 30) at qwen3-1.7b's heads: (label, B, S)
K4_BWD_TIMED = (("qwen3-1.7b training", TRAIN_FULL[QWEN3]["batch"],
                 TRAIN_FULL[QWEN3]["seq"]), ("qwen3-1.7b S=2048", 1, 2048))
# K4's backward at hymba-1.5b's training shape (phase 32), as K4_BWD_CASES
K4_BWD_HYMBA = {"hymba-1.5b training": (TRAIN_FULL[HYMBA]["batch"], 25, 5,
                                        64, TRAIN_FULL[HYMBA]["seq"],
                                        dict(window=1024))}
# K6's backward against its plain version (phase 32) at the heads of the
# two training shapes, label -> (B, H, K, V, u = 0), at each (T, chunk):
# 2048 in chunks of 64, and 2016 (no multiple of 64) in chunks of 32
K6_BWD_HEADS = {"hymba-1.5b SSM heads": (2, 25, 16, 64, True),
                "rwkv6-1.6b": (2, 32, 64, 64, False)}
K6_BWD_T = ((2048, 64), (2016, 32))
# ||kernel - plain|| / ||plain|| of each of dr, dk, dv, dw, du, the plain
# version run on float64 copies of the inputs: its float32 dw divides a
# difference of two sums of order one by w (about 1e-2 off float64, a
# reading of phase 32), which the kernel does not; bfloat16 at K4's
# backward's limit (each gradient rounded to bfloat16 once)
K6_BWD_REL_NORM = 1e-4
K6_BWD_BF16_REL_NORM = 5e-3
# K5's backward against its plain version (phase 36): label -> (bundles,
# cap, d_in, d_out, experts, map): dbrx-132b's training bundles both ways
# round (the gate and up products, and down), a decode-sized cap of 8,
# kimi-k2's widths at a small cap, the reduced configs' width, widths not a
# multiple of 8 at a ragged cap, a map that leaves an expert without a
# bundle and one that meets one expert only.  Map "in_graph": bundle b
# meets expert b % E, as moe_ffn's; "random": seeded
K5_BWD_CASES = {
    "dbrx-132b training, gate and up": (32, 320, 6144, 10752, 16,
                                        "in_graph"),
    "dbrx-132b training, down": (32, 320, 10752, 6144, 16, "in_graph"),
    "dbrx-132b widths, cap 8": (16, 8, 6144, 10752, 16, "in_graph"),
    "kimi-k2 widths, cap 24": (16, 24, 7168, 2048, 8, "random"),
    "reduced configs, width 64, cap 40": (8, 40, 64, 64, 4, "in_graph"),
    "widths 36 / 260, cap 131": (3, 131, 36, 260, 4, "random"),
    "expert 4 without a bundle": (6, 64, 256, 512, 5, [0, 1, 2, 3, 0, 1]),
    "one expert, repeated": (8, 48, 512, 256, 4, [2] * 8)}
# ||kernel - plain|| / ||plain|| of dx and of dw: float32 sums in another
# order; bfloat16 at K4's backward's limit (each result rounded once)
K5_BWD_REL_NORM = {"float32": 1e-5, "bfloat16": 5e-3}
# the reduced train CLI on the card with a checkpoint resume (phase 31):
# qwen3-1.7b and gemma2-2b (softcap, window; head dim 256 reduced to 16),
# rwkv6-1.6b and hymba-1.5b (K6 and its backward; hymba with K4),
# dbrx-132b and kimi-k2 (K5 and its backward in float32 at width 64;
# kimi-k2 with a shared expert)
TRAIN_CLI_ARCHS = ("qwen3-1.7b", "gemma2-2b", "rwkv6-1.6b", "hymba-1.5b",
                   "dbrx-132b", "kimi-k2-1t-a32b")
TRAIN_CLI_ARGS = ["--reduced", "--batch", "4", "--seq", "64"]
# in situ: each gradient leaf of the card (K4 and its backward, cuBLAS)
# against the host's (plain versions), ||card - host|| / ||host||
TRAIN_GRAD_TOL = 1e-3
# the reduced CLI's resumed losses against the uninterrupted run's
TRAIN_RESUME_RTOL = 1e-4
# sharded training (phases 40-44), in a child (``--train-mesh``): meshes of
# MESH_DEVICE repeated (distinct cards where enough are visible).  Phase
# 40: qwen3-1.7b at full width and depth on a (2, 2) ("data", "model")
# mesh through train.train, at phase 29's seed and lr; 41: the int8
# compressed step on a (2, 1, 1) ("pod", "data", "model") mesh at
# qwen3-1.7b's full width, at the reference test's lr 1e-2 and no warmup;
# 42: pipeline_apply over a (4, 1) ("pipe", "model") mesh, stages
# tanh(h @ w) at d 2048, 8 microbatches of 8 x 256 rows; 43: elastic
# restore of the reference test's reduced gemma2-2b from (4, 2) onto
# (3, 2); 44: reduced dbrx-132b's sharded step on (2, 2), K5 on each data
# shard
MESH_DEVICE = "cuda:0"
MESH_TRAIN = dict(steps=3, batch=8, seq=256)
MESH_COMPRESSED = dict(steps=2, batch=8, seq=256, lr=1e-2)
MESH_PIPE = dict(n_stage=4, n_micro=8, rows=(8, 256), d=2048)
MESH_MOE = dict(batch=4, seq=64)
# tests/test_distributed.py's tolerances: the loss (absolute, on the same
# params: the first step's), the params after each step (rtol, atol), the
# compressed step's params against the exact step's (absolute),
# pipeline_apply against the sequential stages (the forward's max abs
# error; each gradient's ||err|| / ||want||)
MESH_LOSS_TOL, MESH_RTOL, MESH_ATOL = 1e-3, 2e-2, 2e-3
MESH_COMP_ATOL, MESH_PIPE_TOL = 5e-2, 1e-5
# sharded serving (phases 45-47), in a child (``--serve-mesh``): qwen3-1.7b
# and rwkv6-1.6b at full width and depth (float32 params, bfloat16
# compute) on a (2, 2) ("data", "model") mesh of MESH_DEVICE repeated,
# make_prefill_step over batch x prompt into a cache of prompt + n_dec
# positions, then n_dec make_decode_step steps on seeded tokens, every
# logit and the final cache held to the same steps on one device within
# LM_TOL; phase 47 at batch 1 (the cache's sequence sharded over "data"),
# and a (1, 1) mesh bit-equal to one device
SERVE_MESH = {QWEN3: dict(batch=8, prompt=1024, n_dec=16, seed=140),
              RWKV6: dict(batch=8, prompt=1024, n_dec=16, seed=141)}
SERVE_MESH_LONG = dict(batch=1, prompt=8192, n_dec=8, seed=142)

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, bf16
# and TF32 dense tensor cores, HBM3
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES_S = 3.35e12
K1_TOL = 1e-5
# the depths over which K1's and K3's float32 products are summed on the
# tensor cores before an IEEE carry: csrc/bsr_spgemm.cu's REPRO_K1_CARRY;
# K3 on wgmma at the Llama shape (block_sparse_attention.cu: Q K^T over all
# of D, P V over a 32-row sub-tile)
K1_CARRY_DEPTH = 32
K3_CARRY_DEPTH = {"qk": LLAMA["head_dim"], "pv": 32}
K2_TOL = K3_TOL = SPGEMM_TOL = 1e-4
K3_BF16_TOL = 2e-2
K5_TOL, K5_BF16_TOL, MOE_TOL = 1e-3, 2e-2, 1e-4
# bfloat16 K5 on the in-graph DBRX bundles as a whole: ||got - want|| /
# ||want|| against the plain version.  Both sum in float32 and round the
# result once, which reads 1.8e-4 to 2.8e-4 at phase 16's four shapes;
# sums rounded to bfloat16 every 512-deep slice read more
# (``k5_lm_limit_reading``)
K5_LM_REL_NORM = 5e-4
# what the kernels line says of K5's bfloat16 kernels (csrc/moe_gemm.cu)
K5_BF16_DESIGN = (
    "cap > 32: TMA-fed wgmma m64n256k16, 2 consumer warpgroups x 64 rows, "
    "1 producer warp, 4-stage ring of 64-deep slices, persistent blocks on an "
    "expert-grouped walk; cap <= 32: A and B swapped, wgmma m64n32k16 on "
    "two 64-column weight boxes a slice, 5 stages, 2 blocks an SM; widths "
    "not a multiple of 8: mma.sync m16n8k16")
K4_TOL, K4_BF16_TOL, K6_TOL = 1e-4, 2e-2, 2e-4
# SHA-256 of K2's float32 outputs at phase 6's inputs (numpy-seeded), read
# from the kernel before its helpers moved to csrc/common.cuh: the shared
# header must leave K2 bit-identical
K2_DIGESTS = {
    "filter3D spmm T=256":
        "6f230640ea52dc69cbb2d41e67b69a45da7196298abdef11e68c61223627c9f5",
    "cant spmv T=1":
        "65079b5cd91cfa5629a0ea1c051dbcb2b9150421852834a776bb7009ff05aa66"}
# SHA-256 of K4's and K5's outputs in phases 12 and 9 (``compare``'s
# ``got``; inputs from seeded generators on the card), read from the kernels
# before their mma.sync, ldmatrix and wgmma helpers moved to csrc/common.cuh:
# the shared header must leave both bit-identical.  K5's two bfloat16 entries
# are the mma.sync kernel's; its TMA routes, which now take these shapes, sum
# each output in the same 16-deep steps and reproduce them bit for bit
K4_DIGESTS = {
    "K4 hymba S=2048 bf16: H=25, Hkv=5, D=64, {'window': 1024}":
        "04a9b752dab6acb54335fce81cf26ba725fab053eb0c586e6a2257766a094e9d",
    "K4 hymba S=2048 f32: H=25, Hkv=5, D=64, {'window': 1024}":
        "410e6ee4ece957cb44b0a0a02cf6f6740782d51e18dae1b77ffd37e537e39102",
    "K4 hymba S=100 (ragged) f32: H=25, Hkv=5, D=64, {'window': 1024}":
        "6d3c9013d2ced5796006d297ba213aac0d707cf033212228d8b31827eeda3ce8",
    "K4 qwen3-1.7b causal S=2048 bf16: H=16, Hkv=8, D=128, {}":
        "1dde670c360aeb0c2340fc97f60ce4a0f818dcea4fdc348a0e1933185116d60b",
    "K4 qwen3-1.7b causal S=2048 f32: H=16, Hkv=8, D=128, {}":
        "13030cb9d6cff504de4aa8b29d00b31e7e0b5ce42f04c9376dac432785ac9130",
    "K4 softcap 50, window 256, S=1000 f32: H=8, Hkv=4, D=128, {'window': 256, 'softcap': 50.0}":
        "8fc2d606a973a43736bb824459fd4fd9426026ac3f82f7157e6f7d4b49661b03",
    "K4 gemma2-2b S=2048 bf16: H=8, Hkv=4, D=256, {'window': 4096, 'softcap': 50.0}":
        "6f16757240d0169b9d10debd25060e4529189fd6c98bdc8bf3a8f1e6dbccfb3b",
    "K4 gemma2-2b S=2048 f32: H=8, Hkv=4, D=256, {'window': 4096, 'softcap': 50.0}":
        "492ed6c9629b8c0146887c58630ddfba56e8384592b52e30ab98739e8a35f576",
    "K4 reduced config S=300 bf16: H=4, Hkv=2, D=16, {'window': 32}":
        "e2b8d752eb63bc4d7a3a02403c32e2225b3a394f3902c62b210fe1c6a29a5cab",
    "K4 reduced config S=300 f32: H=4, Hkv=2, D=16, {'window': 32}":
        "897757c7b464d394c0634ccbb480b8f23b56160114578a0e272e09cafafbd7ae",
    "K4 D=32, window 16, S=300 bf16: H=4, Hkv=2, D=32, {'window': 16}":
        "320a8c9d8780634af6fdc096efcf90ba03edf80b9626dc8c83b0170c156a5453",
    "K4 D=32, window 16, S=300 f32: H=4, Hkv=2, D=32, {'window': 16}":
        "dc02089b93f666d1aa9035690eef4fe50c38ff7508f132c0cd55f4c76b0c34cb"}
K5_DIGESTS = {
    "DBRX prefill gate: (16,1280,6144) x (16,6144,10752), row tile 128":
        "fbefb9875c0828db430f993d76490326ac7de59f131e7445d11c41cb9b0d0baa",
    "DBRX prefill down: (16,1280,10752) x (16,10752,6144), row tile 128":
        "650181d45f7034e8dafee676a5de9ecf79e50561dd4aaad5f4d2840eabd18970",
    "DBRX decode gate: (16,24,6144) x (16,6144,10752), row tile 32":
        "400562149c4df7f4de04ad4f384837e0b25a760c437bcfd15154a40f57ff1c79",
    "DBRX decode down: (16,24,10752) x (16,10752,6144), row tile 32":
        "f1dc8941bae16b3849bef1fd9c815b05f3939205ce5be22fb30a6948c48a0817",
    "DBRX decode gate, bfloat16":
        "ee1f9b97743162138a549157b02b4767237dc2206b13b3dd5355cf8a3fed53c6",
    "DBRX prefill gate, bfloat16":
        "ab895429eb34146ca083df4cdb626f94f147fac94ddca55354dac6ae66687532"}
# compare()'s kernel outputs of the kernels above, by "<kernel> <case>"
OUTPUT_DIGESTS: dict = {}
# the child processes phases 24-26 start (killed if a phase fails first)
CHILDREN: list = []
# phase 48: each example op on the card against the same op on the host, at
# the conformance battery's chunked-against-sync tolerance
ANALYSIS_TOL = 1e-4
# the one-off control readings beside two limits (``k4_limit_reading``,
# ``k5_lm_limit_reading``): what a known defect reads there; run with
# ``python3 chip_smoke.py --control-readings``
CONTROL_READINGS = False
# bfloat16 K4 also as a whole: ||got - want|| / ||want|| against the plain
# version.  P and the outputs rounded to bfloat16 give about 2e-3 at phase
# 12's shapes; dropping the 63 oldest keys of each window gives about 1e-1
# at hymba's prefill shape (phase 12's k4_limit_reading).
K4_BF16_REL_NORM = 5e-3
# the in-situ check: float32 logits of the same params on the card (K4,
# K6, cuBLAS) and on the host (plain versions); sums in another order
LM_TOL = 1e-3
# request isolation: a top-2 logit gap below this is a tie
TIE_GAP = 1e-3
CHOL_RESIDUAL = 1e-10
CG_F32_RESIDUAL, CG_F64_RESIDUAL = 1e-4, 1e-8
TIMED_LAUNCHES = 30
# the device kernels of K1-K6 and the backward kernels (csrc/*.cu), for the
# profiles' per-kernel sums
PORT_KERNEL_NAMES = {
    "K1": ("bsr_spgemm_",), "K2": ("spmm_tile_kernel", "spmm_gemv_kernel"),
    "K3": ("block_attn_",), "K4": ("flash_attn_",),
    "K4 backward": ("attn_bwd_",), "K5": ("moe_gemm_",),
    "K6": ("chunk_local_kernel", "state_scan_kernel", "inter_chunk_kernel"),
    "K6 backward": ("bwd_local_kernel", "bwd_scan_kernel", "bwd_inter_kernel",
                    "bwd_du_kernel"),
    "K5 backward": ("moe_bwd_dx_", "moe_bwd_dw_")}


def emit(**row) -> None:
    """One JSON row, with ``t``: this process's seconds since it started."""
    print(json.dumps({**row, "t": round(time.perf_counter() - T_START, 2)}),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def table1_csr(spec, seed: int):
    from repro_torch.core import random_csr
    _, rows, nnz, pattern = spec
    return random_csr(rows, rows, nnz / (rows * float(rows)),
                      np.random.default_rng(seed), pattern)


def cant_csr():
    """cant (Table I, C4): the SPD blocky stand-in, seed 5."""
    from repro_torch.core import random_spd_csr
    _, rows, nnz, pattern = CANT
    return random_spd_csr(rows, nnz / (rows * float(rows)),
                          np.random.default_rng(5), pattern)


def compare(name: str, got, want, tol: float, kernel: str = "K1",
            rel_norm_tol: float = None) -> float:
    """max |got - want| after asserting allclose(rtol=atol=tol) and, where
    ``rel_norm_tol`` is given, ||got - want|| / ||want|| <= rel_norm_tol."""
    import torch
    got_raw = got
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    max_abs = diff.max().item() if diff.numel() else 0.0
    max_rel = (diff / want.abs().clamp_min(1e-30)).max().item() \
        if diff.numel() else 0.0
    rel_norm = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol)) and (
        rel_norm_tol is None or rel_norm <= rel_norm_tol)
    emit(phase="kernel_vs_plain", kernel=kernel, case=name,
         shape=list(got.shape), max_abs_err=max_abs, max_rel_err=max_rel,
         rel_norm=rel_norm, tol=tol, rel_norm_tol=rel_norm_tol, ok=ok)
    check(ok, f"{kernel} disagrees with its plain version ({name})")
    if kernel in ("K4", "K5"):
        OUTPUT_DIGESTS[f"{kernel} {name}"] = digest(got_raw)
    return max_abs


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (any dtype, bfloat16 too)."""
    import hashlib

    import torch
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def check_digests(kernel: str, expected: dict, card: str) -> None:
    """``kernel``'s recorded output digests against ``expected``."""
    got = {k[len(kernel) + 1:]: v for k, v in OUTPUT_DIGESTS.items()
           if k.startswith(kernel + " ")}
    emit(phase="digests", kernel=kernel, digests=got, expected=expected,
         equal=got == expected, card=card)
    check(got == expected, f"{kernel}'s outputs are not bit-identical to "
          f"{kernel}_DIGESTS")


def cancelling_stack(w, eps: float, seed: int):
    """``w`` stacked on ``-w (1 + eps r)``, r standard normal: ``[x, x]``
    times it is ``-eps x (w r)``, a small difference of large sums."""
    from repro_torch.core import CSR
    r = np.random.default_rng(seed).standard_normal(w.nnz)
    return CSR(2 * w.n_rows, w.n_cols,
               np.concatenate([w.indptr, w.indptr[1:] + w.nnz]),
               np.concatenate([w.indices, w.indices]),
               np.concatenate([w.data, -w.data * (1 + eps * r)])
               .astype(np.float32))


def k1_cases(fa, dev):
    """Phase 3's K1 cases: filter3D's sync plan at bs = 128, its bucketed
    chunk 1 (with the dead trailing group) and a blocky 8192 at bs = 32, as
    label -> (schedule, A tiles, B tiles, n_out_blocks, the plain version's
    a_id, b_id, out_id on the card); with the plan and the chunk."""
    import torch
    from repro_torch.core import inspect_spgemm_block, random_csr
    from repro_torch.kernels.bsr_spgemm import prepare_schedule
    from repro_torch.runtime import bucket_block_schedule, build_block_chunkset

    def ids(*arrays):
        return [torch.from_numpy(np.asarray(x)).to(dev) for x in arrays]

    cases = {}
    plan = inspect_spgemm_block(fa, fa, 128)
    cases["filter3D sync plan, bs=128"] = (
        prepare_schedule(plan.schedule),
        torch.from_numpy(plan.a_pat.scatter(fa.data)).to(dev),
        torch.from_numpy(plan.b_pat.scatter(fa.data)).to(dev),
        plan.n_out_blocks, ids(plan.a_id, plan.b_id, plan.out_id))

    ch = build_block_chunkset(plan, 4).chunk(1)
    sched = bucket_block_schedule(ch)
    check(sched["pair_cap"] > ch.n_pairs, "chunk has no dead group")
    ca = np.zeros((sched["a_cap"], 128, 128), np.float32)
    ca[ch.a_eblk, ch.a_erow, ch.a_ecol] = fa.data[ch.a_sel]
    cb = np.zeros((sched["b_cap"], 128, 128), np.float32)
    cb[ch.b_eblk, ch.b_erow, ch.b_ecol] = fa.data[ch.b_sel]
    cases[f"filter3D bucketed chunk 1 (pairs {ch.n_pairs} -> "
          f"{sched['pair_cap']}, dead group -> tile {sched['out_cap']})"] = (
        sched, torch.from_numpy(ca).to(dev), torch.from_numpy(cb).to(dev),
        sched["out_cap"] + 1, ids(sched["a_id"], sched["b_id"],
                                  sched["out_id"]))

    small = random_csr(8192, 8192, 0.002, np.random.default_rng(3), "blocky")
    p32 = inspect_spgemm_block(small, small, 32)
    s_blocks = torch.from_numpy(p32.a_pat.scatter(small.data)).to(dev)
    cases["blocky 8192, bs=32"] = (
        p32.schedule, s_blocks, s_blocks, p32.n_out_blocks,
        ids(p32.a_id, p32.b_id, p32.out_id))
    return cases, plan, ch


def numpy_ref(a):
    """``spgemm_ref_numpy(a, a)`` and its host time (the CPU stand-in)."""
    from repro_torch.core import spgemm_ref_numpy
    t0 = time.perf_counter()
    ref = spgemm_ref_numpy(a, a)
    return ref, time.perf_counter() - t0


def check_spgemm(name: str, c, ref, ref_s: float) -> None:
    same = (np.array_equal(c.indptr, ref.indptr)
            and np.array_equal(c.indices, ref.indices))
    check(same, f"{name}: CSR structure differs from spgemm_ref_numpy")
    ok = np.allclose(c.data, ref.data, rtol=SPGEMM_TOL, atol=SPGEMM_TOL)
    err = float(np.abs(c.data.astype(np.float64) - ref.data).max()) \
        if c.nnz else 0.0
    emit(phase="check", case=name, nnz=int(c.nnz), max_abs_err=err,
         tol=SPGEMM_TOL, ok=bool(ok), numpy_ref_s=ref_s)
    check(ok, f"{name}: values differ from spgemm_ref_numpy")


def chol_residual(plan, vals, a) -> float:
    """‖L·Lᵀ − A‖_F / ‖A‖_F with sparse products (never a dense n² L)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import norm
    n = plan.n
    lo = sp.csc_matrix((vals, plan.row_idx, plan.col_ptr), shape=(n, n))
    am = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(n, n))
    return float(norm(lo @ lo.T - am) / norm(am))


def timed(fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_share(case: str, fn) -> None:
    """Wall time of ``fn`` against the device time the profiler records
    (kernels and copies), under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    # device-side events only: a CPU op's device total repeats its kernels
    events = [(e.key, e.self_device_time_total)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and "Activity Buffer" not in e.key]
    busy = sum(us for _, us in events) / 1e6
    top = sorted((ev for ev in events if ev[1] > 0), key=lambda ev: -ev[1])
    # each of the port's kernels, its launches summed over their kernel names
    port_us = {k: sum(us for key, us in events if any(n in key for n in names))
               for k, names in PORT_KERNEL_NAMES.items()}
    # and each of their launches alone (K6 backward: the share of its scan)
    by_name = {n: sum(us for key, us in events if n in key)
               for names in PORT_KERNEL_NAMES.values() for n in names}
    # a session that recorded no device event measured nothing: no share
    emit(phase="profile", case=case, wall_s=wall, device_events=len(top),
         device_busy_s=busy if top else None,
         device_busy_share=busy / wall if top else None,
         port_kernels_us={k: us for k, us in port_us.items() if us},
         port_kernel_names_us={n: us for n, us in by_name.items() if us},
         top_device_us=[[k[:60], us] for k, us in top[:6]])


def bound(flop: int, nbytes: int, peak: float = FP32_FLOPS):
    """(bound_ms, bound_by): the larger of FLOP / peak (fp32 unless the
    inputs' type has another) and bytes / HBM rate."""
    flop_ms, byte_ms = flop / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(flop_ms, byte_ms), \
        "operations" if flop_ms >= byte_ms else "bytes"


def event_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, n: int = TIMED_LAUNCHES, flush: bool = False) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in one CUDA
    graph, replayed under CUDA events, so no host time sits between the
    launches (``event_ms`` of the bare calls also counts the host's).  With
    ``flush``, each call follows a read of 128 MB (over twice the 50 MB
    L2; a read, so that no dirty line is left for the call to write back),
    whose own time is measured alone and subtracted: the call finds its
    inputs in device memory, as a caller with fresh inputs does."""
    import torch
    scratch = torch.zeros(32 << 20, device="cuda") if flush else None

    def graph_ms(body):
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                body()
        return event_ms(graph.replay, 5) / n

    if not flush:
        return graph_ms(fn)
    return graph_ms(lambda: (scratch.amax(), fn())) - graph_ms(scratch.amax)


def main_path_row(case: str, wall: float, stats, **extra) -> None:
    emit(phase="main_path", case=case, call_s=wall,
         **{k: stats.get(k) for k in ("method", "cache_hit", "inspect_s",
                                      "execute_s") if stats.get(k) is not None},
         **extra)


def spmm_solver_phases(fa, spd, card: str) -> dict:
    """Phases 6-8 for K2 (``spmm``, ``spmv`` and CG); returns K2's row of
    the kernels line."""
    import scipy.sparse as sp
    import torch
    from repro_torch.core import CSR, fingerprint_pattern
    from repro_torch.core.solver import (_block_diag_restrict, _ll_t_solve,
                                         cg_solve, inspect_spmv)
    from repro_torch.device import to_device
    from repro_torch.kernels.bsr_spmm import (bsr_spmm, bsr_spmm_plain,
                                              inspect_spmm,
                                              prepare_spmm_schedule)
    from repro_torch.runtime import ReapRuntime
    dev = torch.device("cuda")

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def scipy_csr(a, scale=1.0):
        return sp.csr_matrix((a.data.astype(np.float64) * scale, a.indices,
                              a.indptr), shape=(a.n_rows, a.n_cols))

    t0 = time.perf_counter()
    cant = cant_csr()
    splan = inspect_spmv(cant, 128)
    plan = inspect_spmm(fa, 128)
    emit(phase="generate", seconds=time.perf_counter() - t0,
         cant_nnz=cant.nnz, cant_spmv_tiles=splan.inner.n_jobs,
         filter3D_spmm_jobs=plan.n_jobs)

    # -- 6. K2 against plain: the filter3D spmm and cant spmv shapes --------
    t = SPMM_TOKENS
    rng = np.random.default_rng(20)

    def padded(x_np, p):
        xp = np.zeros((x_np.shape[0], p.pat.n_rows), np.float32)
        xp[:, :x_np.shape[1]] = x_np
        return xp

    x_np = rng.standard_normal((t, fa.n_rows)).astype(np.float32)
    x, tiles = on_card(padded(x_np, plan), plan.scatter(fa.data))
    n_j = plan.n_j_blocks
    k2s = prepare_spmm_schedule(plan.schedule, n_j)
    ids = on_card(plan.w_id, plan.k_blk, plan.j_blk)

    def k2_case(case, w, x_w, p, sched):
        """K2 against its plain version (the check) and both against
        float64 ``(Wᵀ·Xᵀ)ᵀ`` (a reading); returns the check's error."""
        xd, td = on_card(padded(x_w, p), p.scatter(w.data))
        got = bsr_spmm(xd, td, sched, n_j_blocks=p.n_j_blocks)
        want = bsr_spmm_plain(xd, td, *on_card(p.w_id, p.k_blk, p.j_blk),
                              n_j_blocks=p.n_j_blocks)
        err = compare(case, got, want, K2_TOL, "K2")
        truth = np.asarray((scipy_csr(w).T @ x_w.T.astype(np.float64)).T)
        n = w.n_cols
        emit(phase="kernel_vs_float64", kernel="K2", case=case,
             max_abs_out=float(np.abs(truth).max()),
             max_abs_err=float(np.abs(got[:, :n].cpu().numpy() - truth).max()),
             plain_max_abs_err=float(np.abs(want[:, :n].cpu().numpy()
                                            - truth).max()))
        return err

    errs = [k2_case(f"filter3D spmm, T={t}, bs=128, {plan.n_jobs} jobs", fa,
                    x_np, plan, k2s)]
    # outputs that nearly cancel: [X, X] @ [W; -W (1 + 1e-3 r)], sums as
    # large as the case above around outputs a thousandth of their size, so
    # the tolerance's absolute term alone holds the kernel
    fc = cancelling_stack(fa, 1e-3, 25)
    cp = inspect_spmm(fc, 128)
    errs.append(k2_case(
        f"filter3D stacked on its negation, T={t}, bs=128, {cp.n_jobs} jobs",
        fc, np.concatenate([x_np, x_np], 1), cp,
        prepare_spmm_schedule(cp.schedule, cp.n_j_blocks)))
    del fc, cp
    vp = splan.inner
    v_np = rng.standard_normal((1, cant.n_cols)).astype(np.float32)
    v, vtiles = on_card(padded(v_np, vp), vp.scatter(cant.data[splan.perm]))
    vs = prepare_spmm_schedule(vp.schedule, vp.n_j_blocks)
    vids = on_card(vp.w_id, vp.k_blk, vp.j_blk)
    errs.append(compare(
        f"cant spmv, T=1, bs=128, {vp.n_jobs} tiles",
        bsr_spmm(v, vtiles, vs, n_j_blocks=vp.n_j_blocks),
        bsr_spmm_plain(v, vtiles, *vids, n_j_blocks=vp.n_j_blocks),
        K2_TOL, "K2"))
    torch.cuda.synchronize()

    # -- 7. main path: spmm, CG (float32 through K2, float64 plain) ---------
    torch.cuda.reset_peak_memory_stats()
    bsr_spmm.launches = 0
    rt = ReapRuntime(device="cuda")

    def run_spmm(case, x_np, w):
        before = bsr_spmm.launches
        (y, st), wall = timed(lambda: rt.run("spmm", x_np, w))
        check(bsr_spmm.launches == before + 1, f"{case}: K2 did not launch")
        t0 = time.perf_counter()
        ref = np.asarray((scipy_csr(w).T @ x_np.T.astype(np.float64)).T)
        ref_s = time.perf_counter() - t0
        ok = bool(y.shape == ref.shape and np.isfinite(y).all()
                  and np.allclose(y, ref, rtol=SPGEMM_TOL, atol=SPGEMM_TOL))
        main_path_row(case, wall, st, k2_launches=1,
                      max_abs_err=float(np.abs(y - ref).max()),
                      tol=SPGEMM_TOL, ok=ok, scipy_s=ref_s)
        check(ok, f"{case}: differs from scipy's (W^T X^T)^T")
        return st

    st = run_spmm(f"filter3D spmm T={t}, cold", x_np, fa)
    check(st["cache_hit"] is False, "first spmm call hit the cache")
    x2_np = np.random.default_rng(22).standard_normal(x_np.shape).astype(
        np.float32)
    fa2 = CSR(fa.n_rows, fa.n_cols, fa.indptr, fa.indices,
              np.random.default_rng(23).standard_normal(fa.nnz)
              .astype(np.float32))
    st = run_spmm(f"filter3D spmm T={t}, fresh X and W (warm)", x2_np, fa2)
    check(st["cache_hit"] is True, "same W pattern missed the plan cache")

    rt_cg = ReapRuntime(device="cuda")

    def solve(case, a, b, a_sp, dtype, tol, limit):
        before = bsr_spmm.launches
        per_op = rt_cg.cache_stats()["per_op"]
        miss0 = [per_op[op]["misses"] for op in ("spmv", "cholesky")]
        (x_sol, info), wall = timed(lambda: cg_solve(
            a, b, rt_cg, tol=tol, dtype=dtype, precond="cholesky"))
        launches = bsr_spmm.launches - before
        per_op = rt_cg.cache_stats()["per_op"]
        misses = [per_op[op]["misses"] - m
                  for op, m in zip(("spmv", "cholesky"), miss0)]
        resid = float(np.linalg.norm(a_sp @ x_sol - b) / np.linalg.norm(b))
        ok = bool(info["converged"] and np.isfinite(x_sol).all()
                  and resid <= limit)
        emit(phase="main_path", case=case, call_s=wall,
             iterations=info["iterations"], relres=info["relres"],
             true_residual=resid, limit=limit, k2_launches=launches,
             spmv_cache_hits=info["spmv_cache_hits"],
             spmv_misses=misses[0], cholesky_misses=misses[1], ok=ok)
        check(ok, f"{case}: not solved (residual {resid})")
        check(info["spmv_cache_hits"] == info["iterations"] - misses[0],
              f"{case}: spmv cache accounting")
        return info, launches, misses

    b = np.random.default_rng(21).standard_normal(cant.n_rows)
    info, n_k2, _ = solve("cant CG f32, precond cholesky, tol 1e-5, cold",
                          cant, b, scipy_csr(cant), np.float32, 1e-5,
                          CG_F32_RESIDUAL)
    check(n_k2 == info["iterations"], "K2 not launched once per iteration")
    cant2 = CSR(cant.n_rows, cant.n_cols, cant.indptr, cant.indices,
                cant.data * 1.1)
    info, n_k2, misses = solve(
        "cant CG f32, rescaled coefficients (warm)", cant2, b,
        scipy_csr(cant, 1.1), np.float32, 1e-5, CG_F32_RESIDUAL)
    check(n_k2 == info["iterations"], "K2 not launched once per iteration")
    check(misses == [0, 0], f"warm solve missed the plan cache: {misses}")
    b64 = np.random.default_rng(24).standard_normal(spd.n_rows)
    _, n_k2, _ = solve("Pre_poisson CG f64 (plain executor), tol 1e-10",
                       spd, b64, scipy_csr(spd), np.float64, 1e-10,
                       CG_F64_RESIDUAL)
    check(n_k2 == 0, "float64 matvecs must take the plain executor")
    torch.cuda.synchronize()
    launches = bsr_spmm.launches
    emit(phase="main_path_done", slice="spmm/spmv/CG", k2_launches=launches,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())

    # -- 8. times -----------------------------------------------------------
    k2_ms = event_ms(lambda: bsr_spmm(x, tiles, k2s, n_j_blocks=n_j))
    plain_ms = event_ms(lambda: bsr_spmm_plain(x, tiles, *ids,
                                               n_j_blocks=n_j), 10)
    wt = scipy_csr(fa).T.tocsr().astype(np.float32)
    wt_t = torch.sparse_csr_tensor(
        *on_card(wt.indptr.astype(np.int64), wt.indices.astype(np.int64),
                 wt.data), size=wt.shape)
    xt = x[:, :fa.n_rows].T.contiguous()
    library_ms = event_ms(lambda: torch.sparse.mm(wt_t, xt))
    nbytes = (x.numel() + tiles.numel() + t * n_j * 128) * 4 + k2s.ids.nbytes
    # the design's bound, 3xTF32: three TF32 tensor-core products per
    # product; beside it the bound of one fp32 FMA per product
    bound_ms, bound_by = bound(3 * plan.flops(t), nbytes, TF32_FLOPS)
    fma_bound_ms, _ = bound(plan.flops(t), nbytes)
    emit(phase="times", kernel="K2", case=f"filter3D spmm T={t}",
         n_jobs=plan.n_jobs, flop=plan.flops(t), bytes=nbytes, k2_ms=k2_ms,
         k2_device_ms=device_ms(lambda: bsr_spmm(x, tiles, k2s,
                                                 n_j_blocks=n_j)),
         plain_ms=plain_ms, library_ms=library_ms, library="torch.sparse.mm",
         k2_tflops=plan.flops(t) / k2_ms / 1e9, bound_ms=bound_ms,
         bound_by=bound_by, bound_fp32_fma_ms=fma_bound_ms, card=card)

    a_t = torch.sparse_csr_tensor(
        *on_card(cant.indptr.astype(np.int64), cant.indices.astype(np.int64),
                 cant.data.astype(np.float32)), size=(cant.n_rows,
                                                      cant.n_cols))
    v_col = v[0, :cant.n_cols].reshape(-1, 1).contiguous()
    vbytes = (v.numel() + vtiles.numel() + vp.n_j_blocks * 128) * 4 \
        + vs.ids.nbytes
    v_bound_ms, v_bound_by = bound(vp.flops(1), vbytes)
    # the host parts of one warm matvec: the plan-cache key (A's pattern
    # digest), the value pass, and the tile upload
    t0 = time.perf_counter()
    fingerprint_pattern("spmv", (cant2,), block=128)
    fingerprint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_tiles = vp.scatter(cant.data[splan.perm])
    scatter_s = time.perf_counter() - t0
    _, upload_s = timed(lambda: to_device(host_tiles, dev))
    uploads = bsr_spmm.uploads
    emit(phase="times", kernel="K2", case="cant spmv T=1 (one CG matvec)",
         n_tiles=vp.n_jobs, flop=vp.flops(1), bytes=vbytes,
         k2_ms=event_ms(lambda: bsr_spmm(v, vtiles, vs,
                                         n_j_blocks=vp.n_j_blocks)),
         k2_device_ms=device_ms(lambda: bsr_spmm(v, vtiles, vs,
                                                 n_j_blocks=vp.n_j_blocks),
                                flush=True),
         schedule_uploads=bsr_spmm.uploads - uploads,
         plain_ms=event_ms(lambda: bsr_spmm_plain(
             v, vtiles, *vids, n_j_blocks=vp.n_j_blocks)),
         library_ms=event_ms(lambda: torch.sparse.mm(a_t, v_col)),
         library="torch.sparse.mm", bound_ms=v_bound_ms, bound_by=v_bound_by,
         fingerprint_s=fingerprint_s, host_value_pass_s=scatter_s,
         tile_upload_s=upload_s,
         tile_bytes=host_tiles.nbytes, card=card)
    digests = k2_digests(x, tiles, k2s, n_j, v, vtiles, vs, vp.n_j_blocks)
    emit(phase="times", kernel="K2", case="outputs' digests",
         digests=digests, expected=K2_DIGESTS, card=card)
    check(digests == K2_DIGESTS, "K2's outputs are not bit-identical to "
          "K2_DIGESTS")
    # the preconditioner's share of a warm solve: its planned factorization
    # (once per solve, a cache hit) and one application M⁻¹·r (once per
    # iteration, host triangular solves)
    m = _block_diag_restrict(cant2, 32)
    ((plan_l, vals_l), _), factor_s = timed(
        lambda: rt_cg.run("cholesky", m, dtype=torch.float32))
    t0 = time.perf_counter()
    _ll_t_solve(plan_l.col_ptr, plan_l.row_idx,
                np.asarray(vals_l, np.float64), b)
    emit(phase="times", case="cant CG preconditioner, block-Jacobi 32",
         nnz_l=plan_l.nnz, warm_factor_s=factor_s,
         apply_s=time.perf_counter() - t0)
    return {
        "name": "bsr_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bsr_spmm.cu",
        "replaces": "src/repro/kernels/bsr_spmm.py:119",
        "launches": launches, "max_abs_err": max(errs), "ms": k2_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}


def k2_digests(x, tiles, k2s, n_j, v, vtiles, vs, nv_j) -> dict:
    """SHA-256 of K2's outputs at phase 6's filter3D spmm (the tile path)
    and cant spmv (the GEMV) inputs."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    return {"filter3D spmm T=256": digest(bsr_spmm(x, tiles, k2s,
                                                   n_j_blocks=n_j)),
            "cant spmv T=1": digest(bsr_spmm(v, vtiles, vs,
                                             n_j_blocks=nv_j))}


def llama_mask():
    """The Llama-3-8B case's mask: ``window_mask`` at its sequence, block
    and window."""
    return window_mask(LLAMA["seq"], LLAMA["block"], LLAMA["window_blocks"])


def window_mask(s: int, bs: int, w: int):
    """Causal sliding-window mask at block granularity (the op's
    semantics): q block ``qi`` sees kv blocks ``qi-w+1..qi`` and global
    block 0, one stored entry per visible tile.  Returns the CSR mask and
    the (n_q_blocks, n_q_blocks) boolean block mask."""
    from repro_torch.core import COO, CSR
    nq = s // bs
    allowed = np.zeros((nq, nq), bool)
    for qi in range(nq):
        allowed[qi, max(0, qi - w + 1):qi + 1] = True
        allowed[qi, 0] = True
    qb, kb = np.nonzero(allowed)
    return CSR.from_coo(COO(s, s, qb * bs, kb * bs,
                            np.ones(qb.size, np.float32))), allowed


def llama_qkv(gen):
    """Fresh float32 q, k, v on the card at the Llama-3-8B shape."""
    import torch
    b, h, hkv, d, s = (LLAMA[k] for k in ("batch", "heads", "kv_heads",
                                          "head_dim", "seq"))
    return tuple(torch.randn((b, n, s, d), generator=gen, device=gen.device)
                 for n in (h, hkv, hkv))


def profile_second_slice() -> None:
    """Device busy share of one warm call each of ``spmm``, ``spmv`` and
    ``block_attention``.  ``main`` runs this in a child process: the first
    profiler sessions of a process record every kernel and copy, but
    sessions late in the full run recorded only some device events or none
    (after the Cholesky session none at all).  It starts early and waits
    (``wait_for_turn``)."""
    import torch
    from repro_torch.runtime import ReapRuntime
    wait_for_turn("bsr_spmm", "block_sparse_attention")
    fa, cant, (mask, _) = table1_csr(FILTER3D, 0), cant_csr(), llama_mask()
    rng = np.random.default_rng(40)
    x = rng.standard_normal((SPMM_TOKENS, fa.n_rows)).astype(np.float32)
    b = rng.standard_normal(cant.n_rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    q, k, v = llama_qkv(gen)
    rt = ReapRuntime(device="cuda", block=LLAMA["block"])
    for case, fn in (
            (f"filter3D spmm T={SPMM_TOKENS}, warm",
             lambda: rt.run("spmm", x, fa)),
            ("cant CG iteration: spmv f32, warm",
             lambda: rt.run("spmv", cant, b, dtype=np.float32)),
            ("Llama-3-8B block_attention, warm",
             lambda: rt.run("block_attention", q, k, v, mask))):
        timed(fn)                       # cold: builds and caches the plan
        device_share(case, fn)


def attention_phases(card: str) -> dict:
    """Phases 6-8 for K3 (``block_attention``); returns K3's row of the
    kernels line."""
    import torch
    from repro_torch.kernels.flash_attention import (
        block_sparse_attention, block_sparse_attention_plain,
        block_sparse_attention_plan, inspect_block_attention)
    from repro_torch.runtime import ReapRuntime
    dev = torch.device("cuda")
    b, h, hkv, d, s, bs = (LLAMA[k] for k in ("batch", "heads", "kv_heads",
                                                "head_dim", "seq", "block"))
    mask, allowed = llama_mask()
    plan = inspect_block_attention(mask, bs)
    emit(phase="generate", case="Llama-3-8B attention mask",
         n_visible=plan.n_visible, nk_cap=plan.nk_cap,
         n_q_blocks=plan.n_q_blocks)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)

    # -- 6. K3 against plain ------------------------------------------------
    q, k, v = llama_qkv(gen)
    ids = [torch.from_numpy(a).to(dev) for a in (plan.kv_ids, plan.n_kv)]
    errs = []
    # the Llama cases through the plan's memoized schedule (the main path's
    # route), the other shapes through raw ids
    for softcap in (0.0, 50.0):
        errs.append(compare(
            f"Llama-3-8B attention f32, softcap {softcap}",
            block_sparse_attention_plan(q, k, v, plan, softcap=softcap),
            block_sparse_attention_plain(q, k, v, *ids, softcap=softcap,
                                         scale=d ** -0.5, seq=s),
            K3_TOL, "K3"))
    qh, kh, vh = (x.to(torch.bfloat16) for x in (q, k, v))
    errs.append(compare(
        "Llama-3-8B attention bf16, softcap 0",
        block_sparse_attention_plan(qh, kh, vh, plan),
        block_sparse_attention_plain(qh, kh, vh, *ids, softcap=0.0,
                                     scale=d ** -0.5, seq=s),
        K3_BF16_TOL, "K3"))
    del qh, kh, vh
    # the head dims and block sizes the Llama case leaves out
    for label, hq, hk, dd, ss, bb, cap in K3_SHAPES:
        sp = inspect_block_attention(window_mask(ss, bb, 8)[0], bb)
        sids = [torch.from_numpy(a).to(dev) for a in (sp.kv_ids, sp.n_kv)]
        xs = [torch.randn((1, n, ss, dd), generator=gen, device=dev)
              for n in (hq, hk, hk)]
        for dtype, tol in ((torch.float32, K3_TOL),
                           (torch.bfloat16, K3_BF16_TOL)):
            xq, xk, xv = (x.to(dtype) for x in xs)
            errs.append(compare(
                f"K3 {label}, H={hq}, Hkv={hk}, softcap {cap}, {dtype}",
                block_sparse_attention(xq, xk, xv, sp.kv_ids, sp.n_kv,
                                       softcap=cap),
                block_sparse_attention_plain(xq, xk, xv, *sids, softcap=cap,
                                             scale=dd ** -0.5, seq=ss),
                tol, "K3"))
        del xs, xq, xk, xv
    torch.cuda.empty_cache()

    # -- 7. main path: block_attention through the runtime ------------------
    def token_mask(allowed, bs):
        return torch.from_numpy(allowed).to(dev).repeat_interleave(bs, 0) \
            .repeat_interleave(bs, 1)

    tok = token_mask(allowed, bs)

    def oracle(q, k, v, out, tok=tok):
        """float64 dense masked attention on the card, head by head, on 4
        heads spread over the kv groups (0, 9, 18, 27 of 32)."""
        worst, ok = 0.0, True
        h, hkv, d = q.shape[1], k.shape[1], q.shape[-1]
        for hh in (i * (h // 4) + i % (h // 4) for i in range(4)):
            kvh = hh // (h // hkv)
            sc = (q[0, hh].double() @ k[0, kvh].double().T) * d ** -0.5
            ref = torch.softmax(sc.masked_fill_(~tok, float("-inf")), -1) \
                @ v[0, kvh].double()
            got = out[0, hh].double()
            worst = max(worst, (got - ref).abs().max().item())
            ok &= bool(torch.isfinite(got).all()
                       and torch.allclose(got, ref, rtol=K3_TOL,
                                          atol=K3_TOL))
        return worst, ok

    torch.cuda.reset_peak_memory_stats()
    block_sparse_attention.launches = 0
    rt = ReapRuntime(device="cuda", block=bs)
    for label, ops in (("cold", (q, k, v)),
                       ("warm, fresh q/k/v", llama_qkv(gen))):
        before = block_sparse_attention.launches
        uploads = block_sparse_attention.uploads
        (out, st), wall = timed(lambda: rt.run("block_attention", *ops,
                                               mask))
        uploads = block_sparse_attention.uploads - uploads
        check(block_sparse_attention.launches == before + 1,
              f"K3 did not launch ({label})")
        check(label == "cold" or uploads == 0,
              "a warm block_attention call uploaded its schedule")
        check(st["cache_hit"] is (label != "cold"), "attention cache")
        check(tuple(out.shape) == (b, h, s, d) and out.dtype == q.dtype,
              "attention output shape or dtype")
        err, ok = oracle(*ops, out)
        main_path_row(f"Llama-3-8B block_attention, {label}", wall, st,
                      k3_launches=1, k3_schedule_uploads=uploads,
                      max_abs_err_4_heads=err, tol=K3_TOL, ok=ok)
        check(ok, f"attention ({label}) differs from the float64 oracle")
        del out
    # the runtime's block 16 (the field K1 and K2 take), Llama's heads
    s16, m16 = 2048, window_mask(2048, 16, 64)
    ops = [torch.randn((1, n, s16, d), generator=gen, device=dev)
           for n in (h, hkv, hkv)]
    rt16 = ReapRuntime(device="cuda", block=16)
    before = block_sparse_attention.launches
    (out, st), wall = timed(lambda: rt16.run("block_attention", *ops,
                                             m16[0]))
    check(block_sparse_attention.launches == before + 1,
          "K3 did not launch (block 16)")
    err, ok = oracle(*ops, out, tok=token_mask(m16[1], 16))
    main_path_row(f"Llama-3-8B heads block_attention, S={s16}, block 16, "
                  "window 64 blocks", wall, st, k3_launches=1,
                  max_abs_err_4_heads=err, tol=K3_TOL, ok=ok)
    check(ok, "attention (block 16) differs from the float64 oracle")
    del out, ops
    torch.cuda.synchronize()
    launches = block_sparse_attention.launches
    emit(phase="main_path_done", slice="block_attention",
         k3_launches=launches,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())

    # -- 8. times -----------------------------------------------------------
    # through the plan's memoized schedule, block_attention_execute's route
    uploads = block_sparse_attention.uploads
    k3_ms = event_ms(lambda: block_sparse_attention_plan(q, k, v, plan))
    qh, kh, vh = (x.to(torch.bfloat16) for x in (q, k, v))
    k3_bf16_ms = event_ms(lambda: block_sparse_attention_plan(qh, kh, vh,
                                                              plan))
    uploads = block_sparse_attention.uploads - uploads
    check(uploads == 0, "K3's timed calls uploaded their schedule")
    del qh, kh, vh
    plain_ms = event_ms(lambda: block_sparse_attention_plain(
        q, k, v, *ids, softcap=0.0, scale=d ** -0.5, seq=s), 5)
    k_full, v_full = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    library_ms = event_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              q, k_full, v_full, attn_mask=tok), 5)
    del k_full, v_full
    flop = plan.flops(b, h, d)
    elems = 2 * q.numel() + k.numel() + v.numel()
    ids_bytes = plan.kv_ids.nbytes + plan.n_kv.nbytes
    # the design's bound, 3xTF32: three TF32 tensor-core products per
    # product; beside it the bound of one fp32 FMA per product, and the
    # bfloat16 call's bound (bf16 tensor cores, 2-byte elements)
    bound_ms, bound_by = bound(3 * flop, elems * 4 + ids_bytes, TF32_FLOPS)
    fma_bound_ms, _ = bound(flop, elems * 4 + ids_bytes)
    bf16_bound_ms, bf16_bound_by = bound(flop, elems * 2 + ids_bytes,
                                         BF16_FLOPS)
    emit(phase="times", kernel="K3", case="Llama-3-8B attention",
         n_visible=plan.n_visible, flop=flop, bytes=elems * 4 + ids_bytes,
         k3_ms=k3_ms,
         k3_tflops=flop / k3_ms / 1e9, plain_ms=plain_ms,
         library_ms=library_ms,
         library="scaled_dot_product_attention, dense boolean block mask",
         bound_ms=bound_ms, bound_by=bound_by,
         bound_fp32_fma_ms=fma_bound_ms, carry_depth=K3_CARRY_DEPTH,
         k3_bf16_ms=k3_bf16_ms, k3_bf16_tflops=flop / k3_bf16_ms / 1e9,
         bf16_bound_ms=bf16_bound_ms, bf16_bound_by=bf16_bound_by,
         warm_schedule_uploads=uploads, card=card)
    return {
        "name": "block_sparse_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_sparse_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:274",
        "launches": launches, "max_abs_err": max(errs), "ms": k3_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}


def dbrx_moe_weights(gen):
    """One DBRX-132B MoE layer on the card, float32, from a seeded
    generator, with the reference's initializer scales (router 0.02,
    experts 1/sqrt(fan_in)): 16 experts, d_model 6144, d_ff_expert 10752."""
    import torch
    d, e, f = DBRX["d_model"], DBRX["n_experts"], DBRX["d_ff_expert"]

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device) \
            .mul_(scale)

    return dict(router=normal((d, e), 0.02),
                w_gate=normal((e, d, f), d ** -0.5),
                w_up=normal((e, d, f), d ** -0.5),
                w_down=normal((e, f, d), f ** -0.5))


def moe_ffn_plain(x, p):
    """The layer ``moe_ffn_host`` computes, with the plain ``moe_gemm`` and
    no runtime: the reference each main-path call is held against."""
    import torch
    from repro_torch.core import inspect_moe_dispatch, routing_csr
    from repro_torch.kernels.moe_gemm import moe_gemm_plain
    from repro_torch.models.moe import expert_capacity, host_route
    b, s, d = x.shape
    e, k = DBRX["n_experts"], DBRX["top_k"]
    tokens = x.reshape(b * s, d)
    ids, gates = host_route(tokens, p["router"], top_k=k)
    plan = inspect_moe_dispatch(routing_csr(ids, e), expert_capacity(
        b * s, e, k, DBRX["capacity_factor"]))
    be = torch.arange(e, device=x.device)
    xb = plan.bundle(tokens)
    h = torch.nn.functional.silu(moe_gemm_plain(xb, p["w_gate"], be)) \
        * moe_gemm_plain(xb, p["w_up"], be)
    y = moe_gemm_plain(h, p["w_down"], be)
    return plan.combine(y, gates).reshape(b, s, d), plan


def moe_phases(card: str) -> dict:
    """Phases 9-11 for K5 (``moe_dispatch`` and the DBRX expert FFN);
    returns K5's row of the kernels line."""
    import shutil

    import torch
    from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_plain,
                                              row_tile)
    from repro_torch.models.moe import (expert_capacity, expert_swiglu,
                                        host_route, moe_ffn_host)
    from repro_torch.runtime import ReapRuntime
    dev = torch.device("cuda")
    d, e, f, k = (DBRX[n] for n in ("d_model", "n_experts", "d_ff_expert",
                                    "top_k"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(50)
    t0 = time.perf_counter()
    p = dbrx_moe_weights(gen)
    torch.cuda.synchronize()
    emit(phase="generate", case="DBRX-132B MoE layer, float32",
         seconds=time.perf_counter() - t0,
         weight_bytes=sum(w.numel() * 4 for w in p.values()))
    xs = {name: torch.randn((b, s, d), generator=gen, device=dev)
          for name, (b, s) in MOE_CALLS.items()}

    # -- 9. K5 against plain: the dispatch plan's bundles, gate and down -----
    errs = []
    rt_check = ReapRuntime(device="cuda")
    bundles = {}
    for name, x in xs.items():
        tokens = x.reshape(-1, d)
        ids, _ = host_route(tokens, p["router"], top_k=k)
        cap = expert_capacity(tokens.shape[0], e, k,
                              DBRX["capacity_factor"])
        xb, plan, _ = rt_check.moe_dispatch(tokens, ids, n_experts=e,
                                            capacity=cap)
        be = plan.schedule      # keeps the expert map's device copy
        be_t = torch.from_numpy(be["bundle_expert"]).to(dev)
        h = torch.nn.functional.silu(moe_gemm(xb, p["w_gate"], be)) \
            * moe_gemm(xb, p["w_up"], be)
        bundles[name] = (xb, h, be)
        for label, a, w in (("gate", xb, p["w_gate"]),
                            ("down", h, p["w_down"])):
            errs.append(compare(
                f"DBRX {name} {label}: ({e},{cap},{a.shape[-1]}) x "
                f"({e},{w.shape[1]},{w.shape[2]}), row tile {row_tile(cap)}",
                moe_gemm(a, w, be), moe_gemm_plain(a, w, be_t), K5_TOL,
                "K5"))
    w16 = p["w_gate"].to(torch.bfloat16)
    for name in ("decode", "prefill"):
        xb, _, be = bundles[name]
        x16 = xb.to(torch.bfloat16)
        errs.append(compare(
            f"DBRX {name} gate, bfloat16", moe_gemm(x16, w16, be),
            moe_gemm_plain(x16, w16,
                           torch.from_numpy(be["bundle_expert"]).to(dev)),
            K5_BF16_TOL, "K5"))
    del w16, x16, rt_check
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 10. main path: moe_ffn_host cold and warm, then a store round trip -
    torch.cuda.reset_peak_memory_stats()
    moe_gemm.launches = 0
    rt = ReapRuntime(device="cuda")
    kw = dict(n_experts=e, top_k=k, capacity_factor=DBRX["capacity_factor"])
    walls = {}
    for name, x in xs.items():
        want, plan = moe_ffn_plain(x, p)
        for label in ("cold", "warm"):
            before = moe_gemm.launches
            per0 = dict(rt.cache_stats()["per_op"]["moe_dispatch"])
            (out, aux), wall = timed(lambda: moe_ffn_host(x, p, rt, **kw))
            per = rt.cache_stats()["per_op"]["moe_dispatch"]
            hit = per["hits"] - per0["hits"]
            diff = (out - want).abs().max().item()
            ok = bool(out.shape == x.shape and torch.isfinite(out).all()
                      and torch.allclose(out, want, rtol=MOE_TOL,
                                         atol=MOE_TOL) and float(aux) == 0)
            emit(phase="main_path",
                 case=f"DBRX moe_ffn_host {name}, T={x.shape[0] * x.shape[1]}"
                      f", {label}", call_s=wall,
                 k5_launches=moe_gemm.launches - before,
                 moe_dispatch_hits=hit,
                 moe_dispatch_misses=per["misses"] - per0["misses"],
                 capacity=plan.capacity, dropped_frac=plan.dropped_frac,
                 max_abs_err_vs_plain=diff, tol=MOE_TOL, ok=ok)
            check(ok, f"moe_ffn_host {name} ({label}) differs from the "
                      "plain layer")
            check(moe_gemm.launches == before + 3,
                  f"moe_ffn_host {name} ({label}): K5 not launched 3 times")
            check(hit == int(label == "warm"),
                  f"moe_ffn_host {name} ({label}): moe_dispatch cache")
            walls[name, label] = wall
        del want
    store = ROOT / "build" / "moe_plan_store"
    shutil.rmtree(store, ignore_errors=True)
    x = xs["decode"]
    outs = []
    for label in ("writes", "fresh runtime reads"):
        rt_s = ReapRuntime(device="cuda", store_dir=str(store))
        before = moe_gemm.launches
        out, _ = moe_ffn_host(x, p, rt_s, **kw)
        per = rt_s.cache_stats()["per_op"]["moe_dispatch"]
        outs.append(out)
        emit(phase="main_path", case=f"DBRX decode, plan store {label}",
             k5_launches=moe_gemm.launches - before, **per,
             store=rt_s.cache_stats()["store"])
        check(moe_gemm.launches == before + 3, "store call: K5 launches")
        check(per["store_hits"] == int(label != "writes"),
              f"plan store round trip ({label})")
    check(torch.equal(outs[0], outs[1]), "store round trip changed the "
          "result")
    torch.cuda.synchronize()
    launches = moe_gemm.launches
    emit(phase="main_path_done", slice="moe_dispatch", k5_launches=launches,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())

    # -- 11. times: the warm call's split, K5 against bound, plain, bmm ----
    for name, x in xs.items():
        tokens = x.reshape(-1, d)
        split = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = tokens @ p["router"]
        torch.cuda.synchronize()
        split["router_logits_s"] = time.perf_counter() - t0
        _, copy_s = timed(lambda: logits.cpu())
        split["logits_to_host_s"] = copy_s
        (ids, gates), split["route_s"] = timed(
            lambda: host_route(tokens, p["router"], top_k=k))
        (xb, plan, st), split["dispatch_s"] = timed(
            lambda: rt.moe_dispatch(tokens, ids, n_experts=e,
                                    capacity=expert_capacity(
                                        tokens.shape[0], e, k,
                                        DBRX["capacity_factor"])))
        check(st["cache_hit"] is True, "warm split: dispatch missed")
        split["dispatch_bundle_s"] = st["bundle_s"]
        be = plan.schedule
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        g = moe_gemm(xb, p["w_gate"], be)
        ev[1].record()
        u = moe_gemm(xb, p["w_up"], be)
        ev[2].record()
        y = moe_gemm(torch.nn.functional.silu(g) * u, p["w_down"], be)
        ev[3].record()
        torch.cuda.synchronize()
        split.update(k5_gate_ms=ev[0].elapsed_time(ev[1]),
                     k5_up_ms=ev[1].elapsed_time(ev[2]),
                     k5_down_and_silu_ms=ev[2].elapsed_time(ev[3]))
        _, split["expert_swiglu_s"] = timed(lambda: expert_swiglu(
            xb, p["w_gate"], p["w_up"], p["w_down"], be))
        _, split["combine_s"] = timed(lambda: plan.combine(y, gates))
        emit(phase="times", case=f"DBRX moe_ffn_host {name}, warm split",
             call_s=walls[name, "warm"], **split, card=card)
        del g, u, y
    rows = {}
    for name in MOE_CALLS:
        xb, h, be = bundles[name]
        be_t = torch.from_numpy(be["bundle_expert"]).to(dev)
        for label, a, w in (("gate", xb, p["w_gate"]),
                            ("down", h, p["w_down"])):
            nb, cap, d_in = a.shape
            d_out = w.shape[-1]
            flop = 2 * nb * cap * d_in * d_out
            nbytes = (a.numel() + w.numel() + nb * cap * d_out) * 4 \
                + be["bundle_expert"].nbytes
            # the design's bound, 3xTF32: three TF32 tensor-core products
            # per product; beside it the bound of one fp32 FMA a product
            bound_ms, bound_by = bound(3 * flop, nbytes, TF32_FLOPS)
            fma_bound_ms, _ = bound(flop, nbytes)
            n = TIMED_LAUNCHES if name == "decode" else 10
            uploads = moe_gemm.uploads
            row = dict(
                ms=event_ms(lambda: moe_gemm(a, w, be), n),
                plain_ms=event_ms(lambda: moe_gemm_plain(a, w, be_t), 5),
                library_ms=event_ms(lambda: torch.bmm(a, w), n),
                bound_ms=bound_ms, bound_by=bound_by)
            emit(phase="times", kernel="K5", case=f"DBRX {name} {label}",
                 shape=[nb, cap, d_in, d_out], flop=flop, bytes=nbytes,
                 k5_tflops=flop / row["ms"] / 1e9,
                 k5_bytes_per_s=nbytes / row["ms"] * 1e3,
                 bound_fp32_fma_ms=fma_bound_ms,
                 schedule_uploads=moe_gemm.uploads - uploads,
                 library="torch.bmm (TF32 off)", **row, card=card)
            rows[name, label] = row
    return {
        "name": "moe_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:43",
        "launches": launches, "max_abs_err": max(errs),
        **rows["prefill", "gate"]}


def hymba_config(**overrides):
    from repro_torch.configs import get_config
    return get_config(HYMBA, **overrides)


def to_host(tree):
    return {k: to_host(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def k4_k6_against_plain(dev) -> tuple:
    """Phase 12: K4 and K6 against their plain versions on the card at
    hymba-1.5b's prefill shapes, K4 also at qwen3-1.7b's (D = 128) and
    gemma2-2b's (D = 256, softcap 50) shapes, reduced_config's D = 16, a
    D = 32 case and a softcap case, in bfloat16 (the tensor-core kernel)
    and float32 (the FMA kernel); returns the worst error of each."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(70)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    k4_errs = []
    bf16, f32 = torch.bfloat16, torch.float32
    gemma2 = (8, 4, 256, 2048, dict(window=4096, softcap=50.0))
    reduced = (4, 2, 16, 300, dict(window=32))  # reduced_config: D 16
    for label, (h, hkv, d, s, kw, dtype) in {
            "hymba S=2048 bf16": (25, 5, 64, 2048, dict(window=1024), bf16),
            "hymba S=2048 f32": (25, 5, 64, 2048, dict(window=1024), f32),
            "hymba S=100 (ragged) f32": (25, 5, 64, 100, dict(window=1024),
                                         f32),
            "qwen3-1.7b causal S=2048 bf16": (16, 8, 128, 2048, {}, bf16),
            "qwen3-1.7b causal S=2048 f32": (16, 8, 128, 2048, {}, f32),
            "softcap 50, window 256, S=1000 f32": (
                8, 4, 128, 1000, dict(window=256, softcap=50.0), f32),
            "gemma2-2b S=2048 bf16": (*gemma2, bf16),
            "gemma2-2b S=2048 f32": (*gemma2, f32),
            "reduced config S=300 bf16": (*reduced, bf16),
            "reduced config S=300 f32": (*reduced, f32),
            "D=32, window 16, S=300 bf16": (4, 2, 32, 300, dict(window=16),
                                            bf16),
            "D=32, window 16, S=300 f32": (4, 2, 32, 300, dict(window=16),
                                           f32)}.items():
        q = randn(1, h, s, d, dtype=dtype)
        k, v = (randn(1, hkv, s, d, dtype=dtype) for _ in range(2))
        tol, rel = (K4_TOL, None) if dtype == f32 else (K4_BF16_TOL,
                                                       K4_BF16_REL_NORM)
        k4_errs.append(compare(
            f"K4 {label}: H={h}, Hkv={hkv}, D={d}, {kw}",
            flash_attention(q, k, v, **kw),
            flash_attention_plain(q, k, v, **kw), tol, "K4", rel))
    # beside the relative-norm limit, what it would catch: the plain version
    # at hymba's prefill without the 63 oldest keys of each window (a
    # control reading, with --control-readings; its inputs are drawn either
    # way, so the K6 cases below see the same generator)
    q = randn(1, 25, 2048, 64, dtype=bf16)
    k, v = (randn(1, 5, 2048, 64, dtype=bf16) for _ in range(2))
    if CONTROL_READINGS:
        want = flash_attention_plain(q, k, v, window=1024).float()
        cut = flash_attention_plain(q, k, v, window=1024 - 63).float()
        emit(phase="k4_limit_reading", case="hymba S=2048 bf16, plain "
             "version with window 961 against 1024",
             rel_norm=((cut - want).norm() / want.norm()).item(),
             rel_norm_tol=K4_BF16_REL_NORM)
    k6_errs = []
    h, kk, vv = 25, 16, 64
    g = HYMBA_GENERATE
    for label, b, t, dtype, u_zero, w_val in (
            ("hymba SSM, u=0, bf16 r/k/v", 1, 2048, torch.bfloat16, True,
             None),
            ("generate's batch, u=0, bf16 r/k/v", g["batch"], g["prompt"],
             torch.bfloat16, True, None),
            ("u != 0, f32", 1, 2048, torch.float32, False, None),
            ("w = 1e-6", 1, 2048, torch.float32, False, 1e-6),
            ("w = 1 - 1e-6", 1, 2048, torch.float32, False, 1 - 1e-6)):
        r, k = (randn(b, h, t, kk, dtype=dtype) for _ in range(2))
        v = randn(b, h, t, vv, dtype=dtype)
        w = torch.sigmoid(4 * randn(b, h, t, kk)).clamp(1e-6, 1 - 1e-6) \
            if w_val is None else torch.full((b, h, t, kk), w_val,
                                             device=dev)
        u = torch.zeros(h, kk, device=dev) if u_zero else randn(h, kk)
        (o, st), (o_p, st_p) = (fn(r, k, v, w, u, chunk=64)
                                for fn in (rwkv6, rwkv6_plain))
        case = f"K6 {label}: B={b}, H={h}, K={kk}, V={vv}, T={t}, chunk 64"
        k6_errs += [compare(case + ", o", o, o_p, K6_TOL, "K6"),
                    compare(case + ", state", st, st_p, K6_TOL, "K6")]
    torch.cuda.synchronize()
    return max(k4_errs), max(k6_errs)


def card_host_rows(name: str, steps, repeat=None) -> tuple:
    """Each ``(label, card, host)`` of ``steps`` within ``LM_TOL``, one check
    row each.  Where the step labelled ``prefill`` fails, ``repeat()`` gives
    a second (card, host) pair of it, to read whether the difference is
    reproducible.  Returns (all within, worst max abs error)."""
    import torch
    ok, worst = True, 0.0
    for label, d, h in steps:
        d = d.cpu()
        diff = (d - h).abs()
        err = diff.max().item()
        worst = max(worst, err)
        step_ok = bool(torch.isfinite(d).all()
                       and torch.allclose(d, h, rtol=LM_TOL, atol=LM_TOL))
        ok &= step_ok
        # where the step comes closest to its limit: (position, vocab id)
        ratio = diff / (LM_TOL + LM_TOL * h.abs())
        at = tuple(int(i) for i in np.unravel_index(int(ratio.argmax()),
                                                    tuple(ratio.shape)))
        row = dict(max_abs_err=err, logit_max=h.abs().max().item(),
                   worst_over_limit=ratio.max().item(),
                   n_over_limit=int((ratio > 1).sum()),
                   worst_at=list(at[1:]),
                   host_at=h[at].item(), card_at=d[at].item())
        if not step_ok and label == "prefill" and repeat is not None:
            d2, h2 = repeat()
            row.update(card_repeat_equal=bool(torch.equal(d2.cpu(), d)),
                       host_repeat_equal=bool(torch.equal(h2, h)))
        emit(phase="check", case=f"{name} f32 {label}, card vs host", **row,
             tol=LM_TOL, ok=step_ok)
    return ok, worst


def lm_in_situ(name: str, cfg, params, s: int, n_dec: int, seed: int,
               kernels: dict, per_prefill: dict, per_step: dict) -> None:
    """Card against host: ``cfg`` (float32 compute) with ``params`` on the
    card (the hand-written kernels) and a host copy (plain versions); a
    prefill of ``s`` tokens and ``n_dec`` decode steps, logits within
    ``LM_TOL``.  ``kernels`` maps a label to a wrapper whose launches during
    the prefill must be ``per_prefill[label]`` and during each decode step
    ``per_step.get(label, 0)``."""
    import torch
    from repro_torch.models import model as M
    host = to_host(params)
    dev = params["embed"].device
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32))
    before = {k: w.launches for k, w in kernels.items()}
    t0 = time.perf_counter()
    lg_d, c_d = M.prefill(cfg, params, toks.to(dev),
                          M.init_cache(cfg, 1, s + n_dec, device=dev))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: w.launches - before[k] for k, w in kernels.items()}
    t0 = time.perf_counter()
    lg_h, c_h = M.prefill(cfg, host, toks,
                          M.init_cache(cfg, 1, s + n_dec, device="cpu"))
    host_s = time.perf_counter() - t0
    steps = [("prefill", lg_d, lg_h)]
    tok = lg_h[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    dec_launches = dict.fromkeys(kernels, 0)
    for i in range(n_dec):
        before = {k: w.launches for k, w in kernels.items()}
        lg_d, c_d = M.decode_step(cfg, params, c_d, tok.to(dev), s + i)
        for k, w in kernels.items():
            dec_launches[k] += w.launches - before[k]
        lg_h, c_h = M.decode_step(cfg, host, c_h, tok, s + i)
        steps.append((f"decode {i}", lg_d, lg_h))
        tok = lg_h[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    def repeat():
        return (M.prefill(cfg, params, toks.to(dev),
                          M.init_cache(cfg, 1, s + n_dec, device=dev))[0],
                M.prefill(cfg, host, toks,
                          M.init_cache(cfg, 1, s + n_dec, device="cpu"))[0])
    ok, worst = card_host_rows(f"{name} {cfg.n_layers} layers", steps,
                               repeat)
    ok &= launches == per_prefill and dec_launches == {
        k: per_step.get(k, 0) * n_dec for k in kernels}
    emit(phase="check", case=f"{name} {cfg.n_layers} layers f32 in situ",
         prompt=s, decode_steps=n_dec, prefill_launches=launches,
         decode_launches=dec_launches, card_prefill_s=card_s,
         host_prefill_s=host_s, max_abs_err=worst, tol=LM_TOL, ok=ok)
    check(ok, f"{name} in situ: card and host logits differ, or a kernel "
          f"did not launch as the path needs ({launches}, {dec_launches})")


def hymba_in_situ(dev) -> None:
    """Phase 13: hymba-1.5b at full width, depth cut to 2 layers, float32
    compute: prefill (2048 tokens: the ring cache, 32 K6 chunks) and 4 decode
    steps on the card against the same params on the host."""
    import dataclasses

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6
    from repro_torch.models import model as M
    cfg = dataclasses.replace(hymba_config(),
                              n_layers=HYMBA_SITU["n_layers"],
                              compute_dtype="float32")
    n = cfg.n_layers
    lm_in_situ(HYMBA, cfg, M.init_params(cfg, 71, device=dev),
               HYMBA_SITU["prompt"], HYMBA_SITU["decode"], 72,
               {"K4": flash_attention, "K6": rwkv6}, {"K4": n, "K6": n}, {})


def serve_trace(cfg, spec=None):
    from repro_torch.launch.scheduler import synthetic_trace
    kw = dict(spec or HYMBA_TRACE)
    return synthetic_trace(kw.pop("n_requests"), vocab=cfg.vocab_size, **kw)


def solo_generate(cfg, params, prompt, gen, max_seq):
    """One request alone (batch 1): its tokens and each step's top-2 logit
    gap."""
    import torch
    from repro_torch.models import model as M
    dev = params["embed"].device
    cache = M.init_cache(cfg, 1, max_seq, device=dev)
    logits, cache = M.prefill(cfg, params, torch.from_numpy(
        prompt[None]).to(dev), cache)
    step = logits[:, len(prompt) - 1]
    toks, gaps = [], []
    for i in range(gen):
        if i:
            lg, cache = M.decode_step(cfg, params, cache, torch.tensor(
                [[toks[-1]]], device=dev), len(prompt) + i - 1)
            step = lg[:, -1]
        top = step[0].topk(2).values
        gaps.append(top[0] - top[1])
        toks.append(int(step[0].argmax().cpu()))
    return toks, torch.stack(gaps).cpu().numpy()


def init_model(name: str, cfg, seed: int, dev):
    """``cfg``'s parameters on the card from ``seed``; reports their count
    and the time."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    emit(phase="generate", case=f"{name} params, {cfg.n_layers} layers, "
         f"{cfg.param_dtype}", seconds=time.perf_counter() - t0,
         n_params=count_params(params))
    return params


def lm_serving(name: str, cfg, params, card: str, *, kernels: dict,
               per_prefill: dict, per_step: dict, gen_spec: dict,
               prompt_seed: int, trace, serve_spec: dict,
               isolation: bool) -> dict:
    """One model's main path: ``generate`` and ``ServeScheduler.run`` on the
    card, every count zeroed just before and read just after.  A prefill
    must launch each kernel of ``kernels`` ``per_prefill[label]`` times and
    a decode step ``per_step.get(label, 0)`` times.  Then, with
    ``isolation``, each request's tokens in float32 compute against its solo
    generation's.  Returns the main path's launches by label."""
    import dataclasses

    import torch
    from repro_torch.launch.scheduler import ServeScheduler
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    per_prefill_seen = []

    def counts():
        return {k: w.launches for k, w in kernels.items()}

    residue = []

    class Timed(ServeScheduler):
        def _retire(self, slot):
            super()._retire(slot)
            residue.append(int(M.cache_slot_residue(self.cache)[slot]))

        def _prefill_into(self, slot, req):
            c0 = counts()
            t0 = time.perf_counter()
            super()._prefill_into(slot, req)
            c1 = counts()
            per_prefill_seen.append((len(req.prompt),
                                     time.perf_counter() - t0,
                                     {k: c1[k] - c0[k] for k in c1}))

    g = gen_spec
    prompt = np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab_size, (g["batch"], g["prompt"])).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in kernels.values():
        w.launches = 0
    # -- the main path ------------------------------------------------------
    (seqs, lat), gen_s = timed(lambda: generate(
        cfg, params, prompt, gen=g["gen"], max_seq=g["prompt"] + g["gen"] + 1,
        device=params["embed"].device))
    gen_launches = counts()
    sch = Timed(cfg, params, device=params["embed"].device, **serve_spec)
    comps, run_s = timed(lambda: sch.run(trace))
    launches = counts()
    # ------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    new = seqs[:, g["prompt"]:].cpu().numpy()
    want_gen = {k: per_prefill[k] + per_step.get(k, 0) * (g["gen"] - 1)
                for k in kernels}
    ok = bool(tuple(seqs.shape) == (g["batch"], g["prompt"] + g["gen"])
              and new.min() >= 0 and new.max() < cfg.vocab_size
              and gen_launches == want_gen)
    emit(phase="main_path", case=f"{name} generate, batch {g['batch']}, "
         f"prompt {g['prompt']}, gen {g['gen']}", call_s=gen_s,
         launches=gen_launches, expected_launches=want_gen,
         decode_step_p50_s=float(np.percentile(lat, 50)),
         decode_step_p99_s=float(np.percentile(lat, 99)),
         tokens_per_s=g["batch"] * g["gen"] / gen_s, ok=ok, card=card)
    check(ok, f"{name} generate: wrong shape, out-of-vocabulary tokens, or "
          f"launches {gen_launches} where the path needs {want_gen}")
    by_rid = {c.rid: c for c in comps}
    occupancy = M.cache_slot_occupancy(sch.cache)
    run_launches = {k: launches[k] - gen_launches[k] for k in kernels}
    want_run = {k: per_prefill[k] * len(trace)
                + per_step.get(k, 0) * sch.stats["decode_steps"]
                for k in kernels}
    ok = bool(sorted(by_rid) == [r.rid for r in trace]
              and all(len(by_rid[r.rid].tokens) == r.gen for r in trace)
              and all(0 <= t < cfg.vocab_size for c in comps
                      for t in c.tokens)
              and not occupancy.any() and len(residue) == len(trace)
              and not any(residue)
              and all(n == per_prefill for *_, n in per_prefill_seen)
              and run_launches == want_run)
    lat = sch.latency_summary()
    n_tok = sum(len(c.tokens) for c in comps)
    prefill_s = {}
    for n, sec, _ in per_prefill_seen:
        prefill_s.setdefault(str(n), []).append(sec)
    emit(phase="main_path", case=f"{name} ServeScheduler.run, "
         f"{len(trace)} requests", call_s=run_s,
         steps=sch.stats["steps"], decode_steps=sch.stats["decode_steps"],
         tokens=n_tok, tokens_per_s=n_tok / run_s,
         prefill_s_by_prompt_len=prefill_s,
         launches_per_prefill=[n for *_, n in per_prefill_seen],
         launches=run_launches, expected_launches=want_run,
         ttft_p50_s=lat["ttft"]["p50_s"], ttft_p99_s=lat["ttft"]["p99_s"],
         decode_step_p50_s=lat["decode_step"]["p50_s"],
         decode_step_p99_s=lat["decode_step"]["p99_s"],
         occupancy_after_drain=occupancy.tolist(),
         state_nonzero_at_eviction=residue,
         max_memory_allocated_bytes=peak, ok=ok, card=card)
    check(ok, f"{name} ServeScheduler: a request did not complete, a token "
          "is out of the vocabulary, a slot was left occupied, an evicted "
          "slot kept K/V or state, or a kernel did not launch as the path "
          "needs")
    del sch, seqs
    torch.cuda.empty_cache()
    if not isolation:
        return launches

    # request isolation, float32 compute: each request's tokens are its
    # solo generation's, up to a reported tie
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    comps32 = {c.rid: c for c in ServeScheduler(
        cfg32, params, device=params["embed"].device,
        **serve_spec).run(trace)}
    params32 = M.compute_params(cfg32, params, params["embed"].device)
    ties, fails = [], []
    for r in trace:
        solo, gaps = solo_generate(cfg32, params32, r.prompt, r.gen,
                                   serve_spec["max_seq"])
        got = comps32[r.rid].tokens
        if got == solo:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, solo)) if a != b)
        row = dict(rid=r.rid, prompt_len=len(r.prompt), first_diff_step=i,
                   top2_gap=float(gaps[i]))
        (ties if gaps[i] < TIE_GAP else fails).append(row)
    emit(phase="check", case=f"{name} request isolation, float32 "
         "compute", requests=len(trace), identical=len(trace) - len(ties)
         - len(fails), ties=ties, failures=fails, tie_gap=TIE_GAP,
         ok=not fails)
    check(not fails, f"{name} request isolation: tokens differ beyond a "
          f"tie: {fails}")
    del params32
    torch.cuda.empty_cache()
    return launches


def hymba_serving(dev, card: str) -> tuple:
    """Phase 14, the main path: hymba-1.5b at full width through
    ``generate`` and ``ServeScheduler.run``; then request isolation in
    float32 compute.  Returns (K4 launches, K6 launches) of the main path."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6
    cfg = hymba_config()
    n = cfg.n_layers
    launches = lm_serving(
        HYMBA, cfg, init_model(HYMBA, cfg, 73, dev), card,
        kernels={"K4": flash_attention, "K6": rwkv6},
        per_prefill={"K4": n, "K6": n}, per_step={},
        gen_spec=HYMBA_GENERATE, prompt_seed=74, trace=serve_trace(cfg),
        serve_spec=HYMBA_SERVE, isolation=True)
    return launches["K4"], launches["K6"]


def time_k4(dev, card: str, name: str, h: int, hkv: int, d: int, s: int,
            kw: dict, b: int = 1, stage: str = "prefill") -> dict:
    """K4 on one bfloat16 shape by CUDA events, beside its bound, its plain
    version and ``scaled_dot_product_attention`` (the masks as an explicit
    boolean mask, kv heads repeated for GQA; and, where the mask is plainly
    causal or absent, with ``is_causal`` and no mask tensor).  SDPA has no
    softcap: with one, its time is of another function and is not the
    library time."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_mask,
                                                     flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(75)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v = randn(b, h, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
    window, causal = kw.get("window", 0), kw.get("causal", True)
    mask = attention_mask(s, causal=causal, window=window, device=dev)
    pairs = int(mask.sum())
    flop = 4 * b * h * pairs * d
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(flop, nbytes, BF16_FLOPS)
    k_rep, v_rep = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_mask_ms = event_ms(lambda: sdpa(q, k_rep, v_rep, attn_mask=mask))
    sdpa_plain_ms = event_ms(lambda: sdpa(q, k_rep, v_rep,
                                          is_causal=causal)) \
        if window == 0 or window >= s else None
    same = not kw.get("softcap")
    row = dict(ms=event_ms(lambda: flash_attention(q, k, v, **kw)),
               plain_ms=event_ms(lambda: flash_attention_plain(q, k, v,
                                                               **kw), 5),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=min(t for t in (sdpa_mask_ms, sdpa_plain_ms)
                              if t is not None) if same else None)
    plain_key = "sdpa_is_causal_ms" if causal else "sdpa_no_mask_ms"
    emit(phase="times", kernel="K4", case=f"{name} {stage} S={s} bf16, "
         f"B={b}, H={h}, Hkv={hkv}, D={d}, {kw}", visible_pairs=pairs,
         flop=flop,
         bytes=nbytes, k4_tflops=flop / row["ms"] / 1e9,
         sdpa_boolean_mask_ms=sdpa_mask_ms, **{plain_key: sdpa_plain_ms},
         sdpa_same_function=same, **row, card=card)
    return row


def hymba_kernel_times(dev, card: str) -> tuple:
    """Phase 15: K4 and K6 at the main path's largest prefill (2048 tokens,
    bfloat16 compute) by CUDA events, beside their bounds, their plain
    versions and, for K4, ``scaled_dot_product_attention``; K4 also at
    qwen3-1.7b's and gemma2-2b's 2048-token prefill shapes.  Returns the two
    hymba rows of the kernels line without launches and errors."""
    from repro_torch.configs import get_config
    cfg = hymba_config()
    s, b = max(HYMBA_TRACE["prompt_lens"]), 1
    h, d, st = cfg.n_heads, cfg.d_head, cfg.ssm_state
    k4 = time_k4(dev, card, HYMBA, h, cfg.n_kv_heads, d, s,
                 dict(window=cfg.window))
    for name in ("qwen3-1.7b", "gemma2-2b"):
        c = get_config(name)
        kw = dict(window=c.window) if c.window else {}
        if c.attn_softcap:
            kw["softcap"] = c.attn_softcap
        time_k4(dev, card, name, c.n_heads, c.n_kv_heads, c.d_head, s, kw)
    k6 = k6_times(dev, card, "hymba-1.5b SSM heads", b, h, s, st, d,
                  u_zero=True, seed=76)
    return k4, k6


def k6_times(dev, card: str, case: str, b: int, h: int, t: int, kk: int,
             vv: int, u_zero: bool, seed: int) -> dict:
    """K6 on one bfloat16 prefill shape (f32 w, chunk 64) by CUDA events,
    beside its bound and its plain version; no library call computes it."""
    import torch
    from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    chunk = min(64, t)
    r, kk_, vv_ = randn(b, h, t, kk), randn(b, h, t, kk), randn(b, h, t, vv)
    w = torch.sigmoid(4 * randn(b, h, t, kk, dtype=torch.float32)).clamp(
        1e-6, 1 - 1e-6)
    u = torch.zeros(h, kk, device=dev) if u_zero else randn(
        h, kk, dtype=torch.float32)
    flop = 2 * b * h * t * kk * vv + 2 * b * h * t * chunk * (kk + vv)
    nbytes = (r.numel() + kk_.numel() + vv_.numel()) * r.element_size() \
        + w.numel() * 4 + u.numel() * 4 + b * h * t * vv * 4 \
        + b * h * kk * vv * 4
    bound_ms, bound_by = bound(flop, nbytes, BF16_FLOPS)
    row = dict(ms=event_ms(lambda: rwkv6(r, kk_, vv_, w, u, chunk=chunk)),
               plain_ms=event_ms(lambda: rwkv6_plain(r, kk_, vv_, w, u,
                                                     chunk=chunk), 5),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    emit(phase="times", kernel="K6", case=f"{case} B={b}, H={h}, K={kk}, "
         f"V={vv}, T={t}, chunk {chunk}, bf16 r/k/v, f32 w", flop=flop,
         bytes=nbytes, library="none", **row, card=card)
    return row


# -- the eighth slice: rwkv6-1.6b (K6) and dbrx-132b's in-graph MoE (K5) -----

def rwkv_config(**overrides):
    from repro_torch.configs import get_config
    return get_config(RWKV6, **overrides)


def dbrx_config(**overrides):
    from repro_torch.configs import get_config
    return get_config(DBRX_LM, n_layers=DBRX_LAYERS, **overrides)


def rwkv_phases(dev, card: str) -> tuple:
    """Phases 16-18 and 20 for rwkv6-1.6b: K6 against its plain version at
    its prefill shapes, 2 layers at full width on the card against the host,
    the model as published through ``generate`` and ``ServeScheduler.run``
    (with request isolation), and K6's times.  Returns (the main path's K6
    launches, K6's worst error, K6's times at the 2048-token prefill)."""
    import dataclasses

    import torch
    from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_plain
    cfg = rwkv_config()
    h, kk = cfg.n_heads, cfg.d_head
    gen = torch.Generator(device=dev)
    gen.manual_seed(80)
    errs = []
    for t in RWKV_K6_T:
        b = RWKV_GENERATE["batch"]
        r, k, v = (torch.randn((b, h, t, kk), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        w = torch.sigmoid(4 * torch.randn((b, h, t, kk), generator=gen,
                                          device=dev)).clamp(1e-6, 1 - 1e-6)
        u = 0.5 * torch.randn((h, kk), generator=gen, device=dev)
        (o, st), (o_p, st_p) = (fn(r, k, v, w, u, chunk=64)
                                for fn in (rwkv6, rwkv6_plain))
        case = (f"K6 rwkv6-1.6b prefill, u != 0, bf16 r/k/v: B={b}, H={h}, "
                f"K=V={kk}, T={t}, chunk 64")
        errs += [compare(case + ", o", o, o_p, K6_TOL, "K6"),
                 compare(case + ", state", st, st_p, K6_TOL, "K6")]
    del r, k, v, w, o, st, o_p, st_p
    torch.cuda.empty_cache()

    n = cfg.n_layers
    situ = dataclasses.replace(cfg, n_layers=RWKV_SITU["n_layers"],
                               compute_dtype="float32")
    from repro_torch.models import model as M
    lm_in_situ(RWKV6, situ, M.init_params(situ, 81, device=dev),
               RWKV_SITU["prompt"], RWKV_SITU["decode"], 82, {"K6": rwkv6},
               {"K6": situ.n_layers}, {})
    torch.cuda.empty_cache()
    launches = lm_serving(
        RWKV6, cfg, init_model(RWKV6, cfg, 83, dev), card,
        kernels={"K6": rwkv6}, per_prefill={"K6": n}, per_step={},
        gen_spec=RWKV_GENERATE, prompt_seed=84,
        trace=serve_trace(cfg, RWKV_TRACE), serve_spec=RWKV_SERVE,
        isolation=True)["K6"]
    torch.cuda.empty_cache()
    times = {t: k6_times(dev, card, "rwkv6-1.6b heads, u != 0",
                         RWKV_GENERATE["batch"], h, t, kk, kk, u_zero=False,
                         seed=85)
             for t in RWKV_K6_T}
    return launches, max(errs), times[max(RWKV_K6_T)]


def in_graph_bundles(x, p, cfg):
    """The bundles ``moe_ffn`` hands K5 for ``x`` (B, S, d), built by its
    own ``_bundles``, and its expert map."""
    from repro_torch.models.moe import _bundle_map, _bundles, expert_capacity
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = expert_capacity(s, e, k, cfg.capacity_factor)
    return _bundles(x, p["router"], n_experts=e, top_k=k,
                    capacity=cap)[0], _bundle_map(b, e)


def sliced_bf16_sums(a, w, be_t, depth: int = 512):
    """``moe_gemm_plain`` with its float32 sums rounded to bfloat16 after
    every ``depth``-deep slice: a kernel that accumulates in bfloat16, the
    fault ``K5_LM_REL_NORM`` must catch."""
    import torch
    acc = None
    for j in range(0, a.shape[-1], depth):
        part = torch.bmm(a[..., j:j + depth].float(),
                         w[be_t.long(), j:j + depth].float())
        acc = (part if acc is None else acc + part).to(torch.bfloat16) \
            .float()
    return acc.to(a.dtype)


def dbrx_host_routing(cfg, params, card: str) -> None:
    """Host-routed decode: the same decode steps with the runtime installed
    (``set_host_dispatch_runtime``) give logits bit-equal to the in-graph
    run; the first pass misses ``moe_dispatch`` on its first step, and a
    replay of the same steps answers every step from warm plans."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.moe import set_host_dispatch_runtime
    from repro_torch.runtime import ReapRuntime
    dev = params["embed"].device
    b, s, n = DBRX_GENERATE["batch"], DBRX_HOST["prompt"], DBRX_HOST["steps"]
    toks = torch.from_numpy(np.random.default_rng(91).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
    cparams = M.compute_params(cfg, params, dev)

    def decode_run(rt):
        logits, cache = M.prefill(cfg, cparams, toks,
                                  M.init_cache(cfg, b, s + n, device=dev))
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        outs, per_step = [], []
        for i in range(n):
            before = dict(rt.cache_stats()["per_op"]["moe_dispatch"]) \
                if rt else None
            lg, cache = M.decode_step(cfg, cparams, cache, tok, s + i)
            outs.append(lg)
            if rt:
                after = rt.cache_stats()["per_op"]["moe_dispatch"]
                per_step.append({k: after[k] - before[k]
                                 for k in ("hits", "misses")})
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        return outs, per_step

    in_graph, _ = decode_run(None)
    rt = ReapRuntime(device="cuda")
    set_host_dispatch_runtime(rt)
    try:
        (first, first_steps), first_s = timed(lambda: decode_run(rt))
        (replay, replay_steps), replay_s = timed(lambda: decode_run(rt))
    finally:
        set_host_dispatch_runtime(None)
    equal = all(torch.equal(a, c) and torch.equal(a, r)
                for a, c, r in zip(in_graph, first, replay))
    ok = bool(equal and first_steps[0]["misses"] > 0
              and all(st["misses"] == 0 and st["hits"] > 0
                      for st in replay_steps))
    emit(phase="main_path", case=f"{DBRX_LM} {cfg.n_layers} layers, "
         f"host-routed decode, batch {b}, prompt {s}, {n} steps",
         bit_equal_to_in_graph=equal, first_pass_per_step=first_steps,
         replay_per_step=replay_steps, first_pass_s=first_s,
         replay_s=replay_s, ok=ok, card=card)
    check(ok, "host-routed DBRX decode: logits differ from the in-graph "
          "run, or moe_dispatch did not miss first and hit on the replay")


def dbrx_phases(dev, card: str) -> dict:
    """Phases 16, 17, 19 and 20 for dbrx-132b at full width, depth cut to 4
    layers (bfloat16 params, 28.6 GB): K5 against its plain version at the
    in-graph bundles and K4 at the model's prefill, 1 layer on the card
    against the host (float32 compute), the main path (``generate``,
    ``ServeScheduler.run``, host-routed decode) and K4's and K5's times.
    Returns the main path's launches by kernel, each kernel's worst error
    and the times (K4 at the prefill; K5 by bundle shape and product)."""
    import dataclasses

    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import (bf16_route, moe_gemm,
                                              moe_gemm_plain)
    from repro_torch.models import params as P
    cfg = dbrx_config()
    e, n = cfg.n_experts, cfg.n_layers
    params = init_model(DBRX_LM, cfg, 90, dev)
    layer0 = {k: w.to(cfg.cdtype) for k, w in P.tree_slice(
        params["layers"], 0)["pos0"]["ffn"].items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(92)

    # -- K5 against plain at the bundles moe_ffn builds -------------------
    errs, bundles = [], {}
    for name, (b, s) in DBRX_K5_CALLS.items():
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        xb, be = in_graph_bundles(x, layer0, cfg)
        be_t = torch.from_numpy(be["bundle_expert"]).to(dev)
        h = torch.nn.functional.silu(moe_gemm(xb, layer0["w_gate"], be)) \
            * moe_gemm(xb, layer0["w_up"], be)
        bundles[name] = (xb, h, be)
        for label, a, w in (("gate", xb, layer0["w_gate"]),
                            ("down", h, layer0["w_down"])):
            route = bf16_route(a.shape[1], a.shape[2], w.shape[2])
            taken = moe_gemm.routes.get(route, 0)
            got = moe_gemm(a, w, be)
            check(moe_gemm.routes.get(route, 0) == taken + 1,
                  f"K5 at the in-graph {name} {label} did not take {route}")
            errs.append(compare(
                f"in-graph DBRX {name} {label}, bf16, {route}: ({a.shape[0]},"
                f"{a.shape[1]},{a.shape[2]}) x ({e},{w.shape[1]},"
                f"{w.shape[2]})", got, moe_gemm_plain(a, w, be_t),
                K5_BF16_TOL, "K5-LM", K5_LM_REL_NORM))
            del got
    # beside the relative-norm limit, what it would catch: sums rounded to
    # bfloat16 every 512-deep slice, at the prefill's gate product (a
    # control reading, with --control-readings)
    if CONTROL_READINGS:
        xb, _, be = bundles["prefill"]
        be_t = torch.from_numpy(be["bundle_expert"]).to(dev)
        want = moe_gemm_plain(xb, layer0["w_gate"], be_t).float()
        cut = sliced_bf16_sums(xb, layer0["w_gate"], be_t).float()
        emit(phase="k5_lm_limit_reading", case="in-graph DBRX prefill gate, "
             "plain version with its sums rounded to bf16 every 512 deep",
             rel_norm=((cut - want).norm() / want.norm()).item(),
             rel_norm_tol=K5_LM_REL_NORM)
        del want, cut

    # -- K4 against plain at the model's prefill --------------------------
    b, s = DBRX_GENERATE["batch"], DBRX_GENERATE["prompt"]
    k4_err = k4_at_shape(dev, f"{DBRX_LM} prefill causal", b, cfg.n_heads,
                         cfg.n_kv_heads, cfg.d_head, s, {}, 96)

    # -- in situ: 1 layer, float32 compute, card against host -------------
    situ = dataclasses.replace(cfg, n_layers=DBRX_SITU["n_layers"],
                               compute_dtype="float32")
    one = dict(params, layers=P.tree_map(lambda v: v[:situ.n_layers],
                                         params["layers"]))
    lm_in_situ(DBRX_LM, situ, one, DBRX_SITU["prompt"], DBRX_SITU["decode"],
               93, {"K4": flash_attention, "K5": moe_gemm},
               {"K4": 1, "K5": 3}, {"K5": 3})
    del one
    torch.cuda.empty_cache()

    # -- the main path ------------------------------------------------------
    moe_gemm.routes.clear()
    launches = lm_serving(
        DBRX_LM, cfg, params, card,
        kernels={"K4": flash_attention, "K5": moe_gemm},
        per_prefill={"K4": n, "K5": 3 * n}, per_step={"K5": 3 * n},
        gen_spec=DBRX_GENERATE, prompt_seed=94,
        trace=serve_trace(cfg, DBRX_TRACE), serve_spec=DBRX_SERVE,
        isolation=False)
    # K5's routes on the main path: prefills of cap > 32 on the tiles, decode
    # steps and short prompts on the decode route, nothing on mma.sync
    routes = dict(moe_gemm.routes)
    emit(phase="main_path", case=f"{DBRX_LM} K5 routes", routes=routes,
         k5_launches=launches["K5"], card=card)
    check(set(routes) == {"wgmma_tiles", "wgmma_decode"}
          and sum(routes.values()) == launches["K5"],
          f"K5's main-path routes {routes}: expected both TMA routes only")
    dbrx_host_routing(cfg, params, card)

    # -- times: K4 at the prefill, K5 at the in-graph bundles --------------
    k4_times = time_k4(dev, card, DBRX_LM, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head, s, {}, b=b)
    k5_times = {}
    for name, (xb, h, be) in bundles.items():
        be_t = torch.from_numpy(be["bundle_expert"]).to(dev)
        for label, a, w in (("gate", xb, layer0["w_gate"]),
                            ("down", h, layer0["w_down"])):
            nb, cap, d_in = a.shape
            d_out = w.shape[-1]
            flop = 2 * nb * cap * d_in * d_out
            nbytes = (a.numel() + w.numel() + nb * cap * d_out) * 2 \
                + be["bundle_expert"].nbytes
            bound_ms, bound_by = bound(flop, nbytes, BF16_FLOPS)
            # the library call: one bmm over the experts, each taking the
            # bundles of every row that meet it
            rows = nb // e
            a_e = a.reshape(rows, e, cap, d_in).transpose(0, 1).reshape(
                e, rows * cap, d_in)
            n_t = TIMED_LAUNCHES if name == "decode" else 10
            row = dict(route=bf16_route(cap, d_in, d_out),
                       ms=event_ms(lambda: moe_gemm(a, w, be), n_t),
                       plain_ms=event_ms(lambda: moe_gemm_plain(a, w, be_t),
                                         5),
                       library_ms=event_ms(lambda: torch.bmm(a_e, w), n_t),
                       bound_ms=bound_ms, bound_by=bound_by)
            k5_times.setdefault(f"dbrx_in_graph_{name}", {})[label] = row
            emit(phase="times", kernel="K5",
                 case=f"in-graph DBRX {name} {label}, bf16",
                 shape=[nb, cap, d_in, d_out], flop=flop, bytes=nbytes,
                 k5_tflops=flop / row["ms"] / 1e9,
                 k5_bytes_per_s=nbytes / row["ms"] * 1e3,
                 library="torch.bmm over (E, rows x cap, d)", **row,
                 card=card)
    del params, bundles, layer0
    torch.cuda.empty_cache()
    return dict(launches=launches, k4_err=k4_err, k5_err=max(errs),
                k4_times=k4_times, k5_times=k5_times, k5_routes=routes)


# -- the tenth slice: paligemma-3b (image prefixes) and whisper-small -------

def k4_at_shape(dev, label: str, b: int, h: int, hkv: int, d: int, s: int,
                kw: dict, seed: int) -> float:
    """K4 against its plain version at one bfloat16 shape of an LM's path
    (K4's bfloat16 limits), inputs from ``seed``; returns the max abs
    error."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    err = compare(f"K4 {label} S={s} bf16: B={b}, H={h}, Hkv={hkv}, D={d}, "
                  f"{kw}", flash_attention(q, k, v, **kw),
                  flash_attention_plain(q, k, v, **kw), K4_BF16_TOL, "K4",
                  K4_BF16_REL_NORM)
    torch.cuda.synchronize()
    return err


def vlm_in_situ(dev) -> None:
    """Phase 22, in situ: paligemma-3b at full width, 2 layers, float32
    compute, card against host: ``forward`` with 256 image tokens
    (prefix-LM: plain attention, no K4), ``prefill`` with the images (causal:
    K4 once a layer) and 4 decode steps, logits within ``LM_TOL``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(PALIGEMMA),
                              n_layers=PALI_SITU["n_layers"],
                              compute_dtype="float32")
    params = M.init_params(cfg, 104, device=dev)
    host = to_host(params)
    rng = np.random.default_rng(105)
    text, n_dec = PALI_SITU["text"], PALI_SITU["decode"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, text)).astype(
        np.int32))
    images = torch.from_numpy(rng.standard_normal(
        (1, cfg.n_image_tokens, cfg.d_image)).astype(np.float32))
    s = cfg.n_image_tokens + text
    k4 = flash_attention.launches
    fwd_d, _ = M.forward(cfg, params, toks.to(dev), images=images.to(dev))
    torch.cuda.synchronize()
    fwd_launches = flash_attention.launches - k4
    fwd_h, _ = M.forward(cfg, host, toks, images=images)
    k4 = flash_attention.launches
    lg_d, c_d = M.prefill(cfg, params, toks.to(dev),
                          M.init_cache(cfg, 1, s + n_dec, device=dev),
                          images=images.to(dev))
    torch.cuda.synchronize()
    prefill_launches = flash_attention.launches - k4
    lg_h, c_h = M.prefill(cfg, host, toks,
                          M.init_cache(cfg, 1, s + n_dec, device="cpu"),
                          images=images)
    steps = [("forward, prefix-LM", fwd_d, fwd_h),
             ("prefill", lg_d, lg_h)]
    tok = lg_h[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    k4 = flash_attention.launches
    for i in range(n_dec):
        lg_d, c_d = M.decode_step(cfg, params, c_d, tok.to(dev), s + i)
        lg_h, c_h = M.decode_step(cfg, host, c_h, tok, s + i)
        steps.append((f"decode {i}", lg_d, lg_h))
        tok = lg_h[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    dec_launches = flash_attention.launches - k4
    ok, worst = card_host_rows(f"{PALIGEMMA} {cfg.n_layers} layers", steps)
    ok &= (fwd_launches, prefill_launches, dec_launches) == (
        0, cfg.n_layers, 0)
    emit(phase="check", case=f"{PALIGEMMA} {cfg.n_layers} layers f32 in "
         "situ", image_tokens=cfg.n_image_tokens, text=text,
         decode_steps=n_dec, k4_forward_launches=fwd_launches,
         k4_prefill_launches=prefill_launches,
         k4_decode_launches=dec_launches, max_abs_err=worst, tol=LM_TOL,
         ok=ok)
    check(ok, f"{PALIGEMMA} in situ: card and host logits differ, or K4 did "
          f"not launch as the path needs ({fwd_launches}, "
          f"{prefill_launches}, {dec_launches})")


def paligemma_image_prefill(cfg, params, card: str) -> int:
    """Phase 22, the main path's image half: an image prefill (batch 2,
    256 image + 768 text tokens) through ``prefill(images=)``, then 16
    greedy decode steps; K4 once a layer in the prefill and never in a
    decode step.  Returns K4's launches."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    dev = params["embed"].device
    g = PALI_IMAGE
    rng = np.random.default_rng(106)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (g["batch"], g["text"])).astype(np.int32)).to(dev)
    images = torch.from_numpy(rng.standard_normal(
        (g["batch"], cfg.n_image_tokens, cfg.d_image)).astype(
            np.float32)).to(dev)
    s = cfg.n_image_tokens + g["text"]
    cparams = M.compute_params(cfg, params, dev)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    # -- the main path ------------------------------------------------------
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, cparams, toks,
                              M.init_cache(cfg, g["batch"], s + g["decode"],
                                           device=dev), images=images)
    cur = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    out, lat = [cur], []
    for i in range(g["decode"]):
        t0 = time.perf_counter()
        lg, cache = M.decode_step(cfg, cparams, cache, cur, s + i)
        cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        out.append(cur)
    launches = flash_attention.launches
    # ------------------------------------------------------------------------
    new = torch.cat(out, dim=1).cpu().numpy()
    ok = bool(new.shape == (g["batch"], g["decode"] + 1)
              and new.min() >= 0 and new.max() < cfg.vocab_size
              and prefill_launches == launches == cfg.n_layers)
    emit(phase="main_path", case=f"{PALIGEMMA} image prefill, batch "
         f"{g['batch']}, {cfg.n_image_tokens} image + {g['text']} text "
         f"tokens, {g['decode']} decode steps", prefill_s=prefill_s,
         decode_step_p50_s=float(np.percentile(lat, 50)),
         decode_step_p99_s=float(np.percentile(lat, 99)),
         k4_prefill_launches=prefill_launches, k4_launches=launches,
         first_tokens=new[0, :8].tolist(), ok=ok, card=card)
    check(ok, f"{PALIGEMMA} image prefill: wrong shape, out-of-vocabulary "
          f"tokens, or K4 launches {prefill_launches} / {launches} where "
          f"the path needs {cfg.n_layers}")
    del cparams, cache, logits
    torch.cuda.empty_cache()
    return launches


def paligemma_phases(dev, card: str) -> dict:
    """Phase 22: paligemma-3b.  K4 against its plain version at the image
    prefill's shape (B 2, 8 q heads / 1 kv head of 256, causal, S = 1024),
    2 layers in situ, then as published (18 layers, float32 params,
    bfloat16 compute): the image prefill and its decode steps, text-only
    ``generate`` and ``ServeScheduler.run`` on a trace shaped like hymba's
    (K4 18 times a prefill; no slot left occupied or holding K/V), and K4's
    times at the image prefill's shape beside SDPA ``is_causal`` with kv
    repeated to 8 heads.  Returns the main path's K4 launches, K4's worst
    error and its times."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = get_config(PALIGEMMA)
    b, s = PALI_IMAGE["batch"], cfg.n_image_tokens + PALI_IMAGE["text"]
    shape = (b, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, s)
    k4_err = k4_at_shape(dev, f"{PALIGEMMA} image prefill causal", *shape,
                          {}, 107)
    vlm_in_situ(dev)
    torch.cuda.empty_cache()
    params = init_model(PALIGEMMA, cfg, 108, dev)
    image_launches = paligemma_image_prefill(cfg, params, card)
    n = cfg.n_layers
    launches = lm_serving(
        PALIGEMMA, cfg, params, card, kernels={"K4": flash_attention},
        per_prefill={"K4": n}, per_step={}, gen_spec=PALI_GENERATE,
        prompt_seed=109, trace=serve_trace(cfg, PALI_TRACE),
        serve_spec=PALI_SERVE, isolation=False)
    del params
    torch.cuda.empty_cache()
    k4_times = time_k4(dev, card, PALIGEMMA, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head, s, {}, b=b, stage="image prefill")
    return dict(launches=image_launches + launches["K4"], k4_err=k4_err,
                k4_times=k4_times)


def encdec_in_situ(dev) -> None:
    """Phase 23, in situ: whisper-small at full width, 2 encoder and 2
    decoder layers, float32 compute, card against host: ``forward`` (K4 at
    each encoder and each decoder self-attention), ``encdec_prefill``
    (``enc_out``, ``xk``, ``xv``; K4 at each encoder layer) and 4 decode
    steps (no K4), within ``LM_TOL``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    w = WHISPER_SITU
    cfg = dataclasses.replace(get_config(WHISPER), n_layers=w["n_layers"],
                              n_enc_layers=w["n_layers"],
                              compute_dtype="float32")
    params = M.init_params(cfg, 112, device=dev)
    host = to_host(params)
    rng = np.random.default_rng(113)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, w["text"])).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (1, w["s_enc"], cfg.d_frame)).astype(np.float32))
    n_dec, max_seq = w["decode"], w["decode"] + 1
    k4 = flash_attention.launches
    fwd_d, _ = M.forward(cfg, params, toks.to(dev), frames=frames.to(dev))
    torch.cuda.synchronize()
    fwd_launches = flash_attention.launches - k4
    fwd_h, _ = M.forward(cfg, host, toks, frames=frames)
    k4 = flash_attention.launches
    enc_d, c_d = M.encdec_prefill(
        cfg, params, frames.to(dev),
        M.init_cache(cfg, 1, max_seq, s_enc=w["s_enc"], device=dev))
    torch.cuda.synchronize()
    prefill_launches = flash_attention.launches - k4
    enc_h, c_h = M.encdec_prefill(
        cfg, host, frames,
        M.init_cache(cfg, 1, max_seq, s_enc=w["s_enc"], device="cpu"))
    steps = [("forward", fwd_d, fwd_h), ("encdec_prefill enc_out", enc_d,
                                         enc_h)]
    steps += [(f"encdec_prefill {key}", c_d["layers"][key],
               c_h["layers"][key]) for key in ("xk", "xv")]
    tok = toks[:, :1]
    k4 = flash_attention.launches
    for i in range(n_dec):
        lg_d, c_d = M.decode_step(cfg, params, c_d, tok.to(dev), i)
        lg_h, c_h = M.decode_step(cfg, host, c_h, tok, i)
        steps.append((f"decode {i}", lg_d, lg_h))
        tok = lg_h[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    dec_launches = flash_attention.launches - k4
    name = f"{WHISPER} {cfg.n_enc_layers} + {cfg.n_layers} layers"
    ok, worst = card_host_rows(name, steps)
    ok &= (fwd_launches, prefill_launches, dec_launches) == (
        cfg.n_enc_layers + cfg.n_layers, cfg.n_enc_layers, 0)
    emit(phase="check", case=f"{name} f32 in situ", s_enc=w["s_enc"],
         text=w["text"], decode_steps=n_dec,
         k4_forward_launches=fwd_launches,
         k4_prefill_launches=prefill_launches,
         k4_decode_launches=dec_launches, max_abs_err=worst, tol=LM_TOL,
         ok=ok)
    check(ok, f"{WHISPER} in situ: card and host differ, or K4 did not "
          f"launch as the path needs ({fwd_launches}, {prefill_launches}, "
          f"{dec_launches})")


def encdec_solo(cfg, params, toks, frames, gen: int, max_seq: int):
    """One row alone (batch 1) as ``generate`` serves it: its tokens and
    each step's top-2 logit gap."""
    import torch
    from repro_torch.models import model as M
    dev = params["embed"].device
    cache = M.init_cache(cfg, 1, max_seq, s_enc=frames.shape[1], device=dev)
    _, cache = M.encdec_prefill(cfg, params, frames.to(dev), cache)
    toks = toks.to(dev)
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(cfg, params, cache, toks[:, i:i + 1],
                                      i)
    step, out, gaps = logits[:, -1], [], []
    for i in range(gen):
        if i:
            lg, cache = M.decode_step(cfg, params, cache, torch.tensor(
                [[out[-1]]], dtype=torch.int32, device=dev),
                toks.shape[1] + i - 1)
            step = lg[:, -1]
        top = step[0].topk(2).values
        gaps.append(float(top[0] - top[1]))
        out.append(int(step[0].argmax()))
    return out, gaps


def whisper_phases(dev, card: str) -> dict:
    """Phase 23: whisper-small.  K4 against its plain version at the
    encoder's shape (B 4, 12 heads of 64, non-causal, S_enc = 1024), 2 + 2
    layers in situ, then as published (12 + 12 layers, float32 params,
    bfloat16 compute): ``generate`` (batch 4, S_enc 1024, prompt 4, gen 32),
    K4 12 times in its ``encdec_prefill`` and never in its 35 decode steps;
    then each row's tokens in float32 compute against its solo generation's,
    and K4's times at the encoder's shape beside SDPA with no mask.  Returns
    the main path's K4 launches, K4's worst error and its times."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = get_config(WHISPER)
    g = WHISPER_GENERATE
    shape = (g["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.d_head, g["s_enc"])
    k4_err = k4_at_shape(dev, f"{WHISPER} encoder", *shape,
                          dict(causal=False), 114)
    encdec_in_situ(dev)
    torch.cuda.empty_cache()
    params = init_model(WHISPER, cfg, 115, dev)
    rng = np.random.default_rng(116)
    toks = rng.integers(0, cfg.vocab_size, (g["batch"], g["prompt"])).astype(
        np.int32)
    frames = torch.from_numpy(rng.standard_normal(
        (g["batch"], g["s_enc"], cfg.d_frame)).astype(np.float32))
    max_seq = g["prompt"] + g["gen"] + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    # -- the main path ------------------------------------------------------
    (seqs, lat), gen_s = timed(lambda: generate(
        cfg, params, toks, gen=g["gen"], max_seq=max_seq, frames=frames,
        device=dev))
    launches = flash_attention.launches
    # ------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    new = seqs[:, g["prompt"]:].cpu().numpy()
    n_decode = g["prompt"] + g["gen"] - 1
    ok = bool(tuple(seqs.shape) == (g["batch"], g["prompt"] + g["gen"])
              and new.min() >= 0 and new.max() < cfg.vocab_size
              and launches == cfg.n_enc_layers)
    cparams = M.compute_params(cfg, params, dev)
    (_, _), prefill_s = timed(lambda: M.encdec_prefill(
        cfg, cparams, frames.to(dev), M.init_cache(
            cfg, g["batch"], max_seq, s_enc=g["s_enc"], device=dev)))
    emit(phase="main_path", case=f"{WHISPER} generate, batch {g['batch']}, "
         f"S_enc {g['s_enc']}, prompt {g['prompt']}, gen {g['gen']}",
         call_s=gen_s, encdec_prefill_s=prefill_s, decode_steps=n_decode,
         decode_step_p50_s=float(np.percentile(lat, 50)),
         decode_step_p99_s=float(np.percentile(lat, 99)),
         tokens_per_s=g["batch"] * g["gen"] / gen_s, k4_launches=launches,
         expected_k4_launches=cfg.n_enc_layers,
         max_memory_allocated_bytes=peak, ok=ok, card=card)
    check(ok, f"{WHISPER} generate: wrong shape, out-of-vocabulary tokens, "
          f"or K4 launches {launches} where the path needs "
          f"{cfg.n_enc_layers}")
    del cparams
    # each row against its solo generation, float32 compute
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    seqs32, _ = generate(cfg32, params, toks, gen=g["gen"], max_seq=max_seq,
                         frames=frames, device=dev)
    params32 = M.compute_params(cfg32, params, dev)
    ties, fails = [], []
    for r in range(g["batch"]):
        solo, gaps = encdec_solo(cfg32, params32, torch.from_numpy(
            toks[r:r + 1]), frames[r:r + 1], g["gen"], max_seq)
        got = seqs32[r, g["prompt"]:].tolist()
        if got == solo:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, solo)) if a != b)
        row = dict(row=r, first_diff_step=i, top2_gap=gaps[i])
        (ties if gaps[i] < TIE_GAP else fails).append(row)
    emit(phase="check", case=f"{WHISPER} rows against solo generation, "
         "float32 compute", rows=g["batch"],
         identical=g["batch"] - len(ties) - len(fails), ties=ties,
         failures=fails, tie_gap=TIE_GAP, ok=not fails)
    check(not fails, f"{WHISPER} batch rows differ from their solo "
          f"generation beyond a tie: {fails}")
    del params, params32
    torch.cuda.empty_cache()
    k4_times = time_k4(dev, card, WHISPER, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head, g["s_enc"], dict(causal=False),
                       b=g["batch"], stage="encoder")
    return dict(launches=launches, k4_err=k4_err, k4_times=k4_times)


def serve_cli(card: str) -> None:
    """Phase 21: the port's serving CLI on the card, one process per arch,
    all started together (``--reduced`` is forced, as in the reference:
    head dim 16; whisper-small encodes frames of ``--prompt-len`` from the
    seed); each must exit 0 having launched its kernels (K4 for attention,
    K6 for hymba and rwkv6).  dbrx-132b runs with ``--routing
    host --plan-store`` beside them and once more after them: a restart,
    which must answer its dispatch plans from the store; both launch K5."""
    import os
    import re
    import shutil
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    store = ROOT / "build" / "serve_plan_store"
    shutil.rmtree(store, ignore_errors=True)
    host_moe = [*SERVE_CLI_HOST_MOE, str(store)]
    t0 = time.perf_counter()

    def start(args):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *args,
             *SERVE_CLI_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    procs = {arch: start(["--arch", arch]) for arch in SERVE_CLI_ARCHS}
    procs["dbrx-132b host routing"] = start(host_moe)
    outs = {}
    try:
        for arch, proc in list(procs.items()):
            outs[arch] = proc.communicate(timeout=600)[0]
        procs["dbrx-132b host routing, restart"] = proc = start(host_moe)
        outs["dbrx-132b host routing, restart"] = proc.communicate(
            timeout=600)[0]
    finally:
        for proc in procs.values():
            proc.kill()
    for arch, proc in procs.items():
        out = outs[arch]
        found = re.search(r"kernel launches: flash_attention=(\d+) "
                          r"rwkv6=(\d+) moe_gemm=(\d+)", out)
        k4, k6, k5 = (int(x) for x in found.groups()) if found else (0, 0, 0)
        plans = re.search(r"moe_dispatch\[h=(\d+),s=(\d+),m=(\d+)", out)
        hits, store_hits, misses = (int(x) for x in plans.groups()) \
            if plans else (0, 0, 0)
        if arch.startswith("dbrx"):
            restart = arch.endswith("restart")
            ok = k4 > 0 and k5 > 0 and (
                store_hits > 0 and misses == 0 if restart else misses > 0)
        else:
            ok = (k4 > 0) == (arch != RWKV6) and \
                (k6 > 0) == (arch in (HYMBA, RWKV6))
        ok = ok and proc.returncode == 0
        emit(phase="serve_cli", arch=arch, args=SERVE_CLI_ARGS,
             rc=proc.returncode, k4_launches=k4, k6_launches=k6,
             k5_launches=k5, moe_dispatch=dict(hits=hits,
                                               store_hits=store_hits,
                                               misses=misses),
             seconds=time.perf_counter() - t0, ok=ok,
             tail=out.strip().splitlines()[-4:], card=card)
        check(ok, f"serve CLI {arch}: exit {proc.returncode}, K4 / K6 / K5 "
              f"launches {k4} / {k6} / {k5}, moe_dispatch hits {hits}, "
              f"store hits {store_hits}, misses {misses}")


def start_child(args, stdin=None):
    """A child process (this script, or ``-m`` a module of the port) from
    the checkout's root, its output piped; ``finish_child`` reads it."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdin=stdin, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    CHILDREN.append(proc)
    return proc, time.perf_counter()


def finish_child(started, what: str, timeout: float = 600) -> tuple:
    """(output, seconds from its start to its exit); fails the phase on a
    nonzero exit, and kills the child on a timeout."""
    proc, t0 = started
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        proc.kill()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}\n"
          + "\n".join(out.strip().splitlines()[-30:]))
    return out, wall


def wait_for_turn(*kernels) -> None:
    """In a child that ``main`` starts early: set up CUDA and load
    ``kernels`` now, then wait for the line that ``go_child`` sends on stdin
    when the child's phase comes, so that the child's start-up overlaps
    ``main``'s phases and not its own.  Run by hand, such a child takes its
    line from a pipe (``echo | python3 chip_smoke.py --train-full``)."""
    import torch
    from repro_torch.kernels import _build
    torch.zeros(1, device="cuda")
    _build.load_all(*kernels)
    sys.stdin.readline()


def go_child(started, what: str, timeout: float = 600) -> str:
    """Send a waiting child (``wait_for_turn``) its line, then
    ``finish_child``; returns its output."""
    started[0].stdin.write("go\n")
    started[0].stdin.flush()                # finish_child closes it
    return finish_child(started, what, timeout)[0]


def child_rows(out: str, phase: str) -> list:
    return [r for r in (json.loads(line) for line in out.splitlines()
                        if line.startswith("{"))
            if r.get("phase") == phase]


def sharding_phases(fa, cage, cage_ref, cage_runs, card: str) -> dict:
    """Phase 24: sharded execution over ``make_mesh((4,), ("data",),
    devices=["cuda:0"] * 4)`` (and 3 shards for the MoE fallback), each op
    cold, warm (a cache hit) and from a fresh runtime on the same plan
    store (a store hit), against the single-host card call (for cage12,
    phase 4's two calls).  Returns K2's launches on the sharded path and
    its per-shard times."""
    import shutil

    import torch
    from repro_torch.kernels.bsr_spmm import (_k2_schedule, bsr_spmm,
                                              inspect_spmm)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import ReapRuntime
    dev = torch.device("cuda")
    store = ROOT / "build" / "shard_plan_store"
    shutil.rmtree(store, ignore_errors=True)
    meshes = {n: make_mesh((n,), ("data",), devices=["cuda:0"] * n)
              for n in (SHARDS, SHARDS_FALLBACK)}
    out = dict(k2_launches=0, k2_shard_ms={})

    def three_calls(case, tag, operands, kw, n, agree):
        """cold, warm, store (a plan store of the case's own: spmm's plan
        is W's alone, so its two T share one); ``agree(result, stats, K2
        launches)`` gives (ok, readings)."""
        case_store = str(store / f"{case} {n}".replace(" ", "_"))
        rt = ReapRuntime(device="cuda", store_dir=case_store)
        for label in ("cold", "warm", "store"):
            if label == "store":
                rt = ReapRuntime(device="cuda", store_dir=case_store)
            k2 = bsr_spmm.launches
            (res, st), wall = timed(lambda: rt.run(
                tag, *operands, mesh=meshes[n], **kw))
            k2 = bsr_spmm.launches - k2
            ok, reading = agree(res, st, k2)
            ok = ok and st["n_shards"] == n and \
                bool(st["cache_hit"]) == (label != "cold") and \
                bool(st["store_hit"]) == (label == "store")
            emit(phase="sharding", case=case, call=label, n_shards=n,
                 call_s=wall, method=st["method"],
                 cache_hit=st["cache_hit"], store_hit=st["store_hit"],
                 sharded=st.get("sharded"), k2_launches=k2, ok=ok,
                 **reading, card=card)
            check(ok, f"{case} ({label}) on {n} shards")

    # gather SpGEMM on cage12: atomics merge on the card, so within 1e-4 of
    # spgemm_ref_numpy and of the single-host card call, exact structure;
    # phase 4's cold and warm calls, compared bit for bit, are the reading
    # of whether the atomics reorder anything here
    ref = cage_ref[0]
    c1, c2 = cage_runs["cold"], cage_runs["warm"]
    single_repeat = c1.data.tobytes() == c2.data.tobytes()
    emit(phase="sharding", case="cage12 gather, single-host (phase 4)",
         two_calls_bit_identical=single_repeat, card=card)
    out["gather_single_host_bit_identical"] = single_repeat

    def gather_agrees(c, st, k2):
        same = bool(np.array_equal(c.indptr, ref.indptr)
                    and np.array_equal(c.indices, ref.indices))
        ok = same and np.allclose(c.data, ref.data, rtol=SPGEMM_TOL,
                                  atol=SPGEMM_TOL) and \
            np.allclose(c.data, c2.data, rtol=SPGEMM_TOL, atol=SPGEMM_TOL)
        return bool(ok), dict(
            structure_exact=same,
            max_abs_err=float(np.abs(c.data.astype(np.float64)
                                     - ref.data).max()),
            max_abs_err_vs_single_host=float(np.abs(
                c.data.astype(np.float64) - c2.data).max()),
            bit_equal_single_host=c.data.tobytes() == c2.data.tobytes(),
            tol=SPGEMM_TOL, partial_products=st["n_pp"], nnz=int(c.nnz))

    three_calls("cage12 spgemm_gather", "spgemm_gather", (cage, cage), {},
                SHARDS, gather_agrees)

    # spmm on filter3D: bit-equal to the single-host card call, K2 once a
    # shard, every shard at the whole call's regime
    plan = inspect_spmm(fa, 128)
    tiles = torch.from_numpy(plan.scatter(fa.data)).to(dev)
    k2s = _k2_schedule(plan)
    for t in SHARD_SPMM_TOKENS:
        x = np.random.default_rng(240 + t).standard_normal(
            (t, fa.n_rows)).astype(np.float32)
        (y0, _), single = timed(lambda: ReapRuntime(device="cuda").run(
            "spmm", x, fa))

        def spmm_agrees(y, st, k2, y0=y0, single=single, t=t):
            same = y.shape == y0.shape and y.tobytes() == y0.tobytes()
            return same and k2 == SHARDS, dict(
                bit_equal_single_host=same, tokens=t, single_host_s=single)

        before = bsr_spmm.launches
        three_calls(f"filter3D spmm T={t}", "spmm", (x, fa), {}, SHARDS,
                    spmm_agrees)
        out["k2_launches"] += bsr_spmm.launches - before
        # K2 on one shard's rows (the first shard's T / 4, at the whole
        # call's regime) against the whole call's launch
        xs = torch.from_numpy(np.pad(x, ((0, 0), (0, plan.pat.n_rows
                                                  - fa.n_rows)))).to(dev)
        n = t // SHARDS
        shard_ms = event_ms(lambda: bsr_spmm(
            xs[:n], tiles, k2s, n_j_blocks=plan.n_j_blocks, regime_t=t))
        whole_ms = event_ms(lambda: bsr_spmm(
            xs, tiles, k2s, n_j_blocks=plan.n_j_blocks))
        # a row's result does not depend on its place in a row tile: the
        # same rows shifted down by 37 within one call
        shifted = torch.cat([xs.new_zeros((37, xs.shape[1])), xs])
        a = bsr_spmm(xs, tiles, k2s, n_j_blocks=plan.n_j_blocks)
        b = bsr_spmm(shifted, tiles, k2s, n_j_blocks=plan.n_j_blocks,
                     regime_t=t)
        same_rows = bool(torch.equal(a, b[37:]))
        emit(phase="times", kernel="K2", case=f"one shard of T={t}",
             shard_rows=n, shard_ms=shard_ms, whole_call_ms=whole_ms,
             rows_shifted_by_37_bit_equal=same_rows, card=card)
        check(same_rows, f"K2 at T={t}: a row's bits depend on its place "
              "in the row tile")
        out["k2_shard_ms"][f"T={t}"] = dict(rows=n, ms=shard_ms,
                                            whole_call_ms=whole_ms)
    del tiles

    # moe_dispatch at dbrx-132b's prefill routing: bit-equal on 4 shards
    # and on the fallback of 3 (16 experts do not split 3 ways)
    g = torch.Generator(device=dev)
    g.manual_seed(241)
    tokens = torch.randn((SHARD_MOE["tokens"], DBRX["d_model"]),
                         generator=g, device=dev)
    router = torch.randn((DBRX["d_model"], DBRX["n_experts"]), generator=g,
                         device=dev) / DBRX["d_model"] ** 0.5
    ids = (tokens @ router).topk(DBRX["top_k"], dim=-1).indices.cpu().numpy()
    kw = dict(n_experts=DBRX["n_experts"])
    ((b0, _), st0), single = timed(lambda: ReapRuntime(device="cuda").run(
        "moe_dispatch", tokens, ids, **kw))
    check(st0["capacity"] == SHARD_MOE["capacity"],
          f"moe capacity {st0['capacity']}")

    def moe_agrees(res, st, k2, n):
        same = bool(res[0].shape == b0.shape and torch.equal(res[0], b0))
        return same and st["sharded"] == (DBRX["n_experts"] % n == 0), \
            dict(bit_equal_single_host=same, capacity=st["capacity"],
                 single_host_s=single)

    for n in (SHARDS, SHARDS_FALLBACK):
        three_calls(f"dbrx-132b prefill moe_dispatch, {SHARD_MOE['tokens']}"
                    " tokens", "moe_dispatch", (tokens, ids), kw, n,
                    functools.partial(moe_agrees, n=n))
    return out


def kernels_against_plain_small(dev) -> None:
    """Each of K1-K6 and K4's, K6's and K5's backward once against its
    plain version at one small shape (a library from the store
    computes)."""
    import torch
    from repro_torch.core import COO, CSR, inspect_spgemm_block, random_csr
    from repro_torch.kernels.bsr_spgemm import (bsr_spgemm_plain,
                                                bsr_spgemm_schedule)
    from repro_torch.kernels.bsr_spmm import (bsr_spmm, bsr_spmm_plain,
                                              inspect_spmm)
    from repro_torch.kernels.flash_attention import (
        block_sparse_attention, block_sparse_attention_plain,
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain, inspect_block_attention)
    from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_bwd,
                                              moe_gemm_bwd_plain,
                                              moe_gemm_plain)
    from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_bwd, rwkv6_plain
    rng = np.random.default_rng(250)

    def on(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    a = random_csr(600, 600, 0.03, rng, "blocky")
    p1 = inspect_spgemm_block(a, a, 32)
    (t1,) = on(p1.a_pat.scatter(a.data))
    compare("store child, 600x600 bs=32", bsr_spgemm_schedule(
        p1.schedule, t1, t1, n_out_blocks=p1.n_out_blocks),
        bsr_spgemm_plain(t1, t1, *on(p1.a_id, p1.b_id, p1.out_id),
                         n_out_blocks=p1.n_out_blocks), K1_TOL, "K1")
    w = random_csr(700, 600, 0.02, rng, "blocky")
    p2 = inspect_spmm(w, 128)
    x, t2 = on(rng.standard_normal((33, p2.pat.n_rows)).astype(np.float32),
               p2.scatter(w.data))
    compare("store child, T=33 bs=128", bsr_spmm(
        x, t2, p2.schedule, n_j_blocks=p2.n_j_blocks),
        bsr_spmm_plain(x, t2, *on(p2.w_id, p2.k_blk, p2.j_blk),
                       n_j_blocks=p2.n_j_blocks), K2_TOL, "K2")
    s, bs, d = 256, 64, 64
    row, col = rng.integers(0, s - bs, 6 * s), rng.integers(0, s, 6 * s)
    p3 = inspect_block_attention(CSR.from_coo(COO(
        s, s, row, col, np.ones(row.size, np.float32))), bs)
    q, k, v = on(*(rng.standard_normal((2, n, s, d)).astype(np.float32)
                   for n in (4, 2, 2)))
    compare("store child, S=256 block 64", block_sparse_attention(
        q, k, v, p3.kv_ids, p3.n_kv, softcap=0.0, seq=s),
        block_sparse_attention_plain(q, k, v, *on(p3.kv_ids, p3.n_kv),
                                     softcap=0.0, scale=d ** -0.5, seq=s),
        K3_TOL, "K3")
    compare("store child, S=256 window 128", flash_attention(
        q, k, v, window=128), flash_attention_plain(q, k, v, window=128),
        K4_TOL, "K4")
    xb, wb = on(rng.standard_normal((4, 16, 128)).astype(np.float32),
                (rng.standard_normal((3, 128, 128)) / 128 ** 0.5)
                .astype(np.float32))
    be = rng.integers(0, 3, 4).astype(np.int32)
    compare("store child, 4 bundles of 16", moe_gemm(xb, wb, be, bk=4, bf=4),
            moe_gemm_plain(xb, wb, *on(be)), K5_TOL, "K5")
    r, kk, vv, wr = on(*(rng.standard_normal((1, 2, 128, n)).astype(
        np.float32) for n in (16, 16, 64, 16)))
    wd = torch.sigmoid(4 * wr).clamp(1e-6, 1 - 1e-6)
    (u,) = on(rng.standard_normal((2, 16)).astype(np.float32))
    o, st = rwkv6(r, kk, vv, wd, u, chunk=64)
    o_want, st_want = rwkv6_plain(r, kk, vv, wd, u, chunk=64)
    compare("store child, T=128 output", o, o_want, K6_TOL, "K6")
    compare("store child, T=128 state", st, st_want, K6_TOL, "K6")
    do, ds = on(*(rng.standard_normal(x.shape).astype(np.float32)
                  for x in (o, st)))
    compare_k6_grads("store child, T=128",
                     rwkv6_bwd(r, kk, vv, wd, u, do, ds, chunk=64),
                     k6_bwd_plain64(r, kk, vv, wd, u, do, ds, 64),
                     torch.float32)
    (dout,) = on(rng.standard_normal(q.shape).astype(np.float32))
    with torch.no_grad():
        out = flash_attention(q, k, v, window=128)
    compare_grads("store child, S=256 window 128",
                  flash_attention_bwd(q, k, v, out, dout, window=128),
                  flash_attention_bwd_plain(q, k, v, dout, window=128),
                  torch.float32)
    (dy,) = on(rng.standard_normal((4, 16, 128)).astype(np.float32))
    compare_k5_grads("store child, 4 bundles of 16",
                     moe_gemm_bwd(xb, wb, be, dy),
                     moe_gemm_bwd_plain(xb, wb, *on(be), dy), torch.float32)


def store_child(root: str, checks: bool) -> int:
    """One process over the kernel-library store at ``root``: load every
    library of ``csrc/`` through it (building what it misses), then, with
    ``checks``, each kernel once against its plain version; prints the
    counts as a ``store_child`` row."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.runtime.exec_store import (ExecCache, ExecStore,
                                               set_default_exec_cache)
    store = ExecStore(root)
    cache = ExecCache(store)
    set_default_exec_cache(cache)
    t0 = time.perf_counter()
    _build.load_all(*STORE_KERNELS)
    load_s = time.perf_counter() - t0
    if checks:
        kernels_against_plain_small(torch.device("cuda"))
        torch.cuda.synchronize()
    emit(phase="store_child", compiles=cache.stats.compiles,
         loads=cache.stats.loads, saves=cache.stats.saves,
         corrupt=store.stats.corrupt, env_miss=store.stats.env_miss,
         load_or_build_s=load_s, compile_s=cache.stats.compile_s,
         env=store.env, entries=store.summary()["entries"])
    return 0


def serve_store_args(*extra) -> list:
    return ["-m", "repro_torch.launch.serve", "--arch", HYMBA,
            "--continuous", "--prewarm", "--exec-store",
            str(SERVE_STORE_DIR), *SERVE_STORE_ARGS, *extra]


def store_phases(store_build, cold_cli, card: str) -> None:
    """Phases 25 and 26's CLI runs: the kernel-library store across
    processes.  Started by ``main``: a child that builds ``STORE_KERNELS``
    (every library of ``csrc/``: K1-K6 and K4's, K6's and K5's backward)
    into a fresh store (9 ``nvcc`` runs, 0 loads; started before phase 9)
    and the serving CLI on hymba-1.5b with ``--prewarm --exec-store`` on a
    fresh store of its own (its prewarm builds K4 and K6; beside phase 21's
    CLIs).  Then, at once: a child that loads all nine from the store with
    no ``nvcc``, a child over a copy of the store with one entry's bytes
    corrupted (it counts the entry corrupt, rebuilds it alone and loads the
    other eight),
    and the CLI again with ``--expect-zero-compiles`` (no ``nvcc``, both
    libraries from the store, exit 0).  The two later store children run
    each kernel once against its plain version."""
    import re
    import shutil

    def store_row(started, label, expect):
        out, wall = finish_child(started, f"store child ({label})")
        row = child_rows(out, "store_child")[-1]
        checks = child_rows(out, "kernel_vs_plain")
        ok = (row["compiles"], row["loads"], row["corrupt"]) == expect \
            and len(checks) == (0 if label == "build" else 12) \
            and all(c["ok"] for c in checks)
        emit(phase="kernel_store", child=label, process_s=wall,
             kernel_checks=len(checks),
             max_abs_err={c["kernel"]: max(
                 d["max_abs_err"] for d in checks
                 if d["kernel"] == c["kernel"]) for c in checks},
             ok=ok, card=card,
             **{k: v for k, v in row.items() if k != "phase"})
        check(ok, f"kernel store, {label}: {row}")

    nvcc_re = re.compile(r"exec cache: (\d+) nvcc runs, (\d+) loaded")
    prewarm_re = re.compile(r"prewarmed (\d+) prefill bucket\(s\) in "
                            r"([0-9.]+)s")
    ttft_re = re.compile(r"ttft p50=([0-9.]+)ms")

    def cli_row(started, label, expect):
        out, wall = finish_child(started, f"serve CLI with the store "
                                 f"({label})")
        found, prewarm, ttft = (r.search(out)
                                for r in (nvcc_re, prewarm_re, ttft_re))
        nvcc, loads = (int(x) for x in found.groups()) if found else (-1, -1)
        ok = (nvcc, loads) == expect and prewarm is not None and \
            "registered ops" in out and \
            (label == "cold store" or "warm-restart OK" in out)
        emit(phase="serve_store", run=label, process_s=wall,
             nvcc_runs=nvcc, loaded_from_store=loads,
             prewarm_buckets=int(prewarm.group(1)) if prewarm else None,
             prewarm_s=float(prewarm.group(2)) if prewarm else None,
             ttft_p50_ms=float(ttft.group(1)) if ttft else None, ok=ok,
             tail=out.strip().splitlines()[-6:], card=card)
        check(ok, f"serve CLI with the store ({label}): {nvcc} nvcc runs, "
              f"{loads} loads")

    n = len(STORE_KERNELS)
    store_row(store_build, "build", (n, 0, 0))
    shutil.copytree(STORE_DIR, STORE_DIR_CORRUPT)
    manifest = json.loads((STORE_DIR_CORRUPT / "manifest.json").read_text())
    key, ent = next((k, e) for k, e in manifest["entries"].items()
                    if e["label"] == STORE_CORRUPT)
    path = STORE_DIR_CORRUPT / "lib" / ent["payload"]
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    emit(phase="kernel_store", corrupted=STORE_CORRUPT, key=key,
         bytes=len(blob))
    cli_row(cold_cli, "cold store", (2, 0))
    script = str(Path(__file__).resolve())
    later = [(start_child([script, "--store-child", str(STORE_DIR)]),
              "restart", (0, n, 0)),
             (start_child([script, "--store-child", str(STORE_DIR_CORRUPT)]),
              "after corrupting one entry", (1, n - 1, 1))]
    restart_cli = start_child(serve_store_args("--expect-zero-compiles"))
    for started, label, expect in later:
        store_row(started, label, expect)
    cli_row(restart_cli, "restart, --expect-zero-compiles", (0, 2))


def serve_prewarm(dev, card: str) -> dict:
    """Phase 26's in-process part: ``ServeScheduler.prewarm`` at full width
    on phase 14's trace (hymba-1.5b as published): its buckets against
    ``prefill_buckets``, scheduler state untouched, the first request's
    time to first token without and with it, and both runs' completions
    equal.  Returns K4's and K6's launches in the prewarmed run (prewarm
    included)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6
    from repro_torch.launch.scheduler import ServeScheduler
    from repro_torch.models import model as M
    cfg = hymba_config()
    params = init_model(HYMBA, cfg, 73, dev)
    trace = serve_trace(cfg)
    lens = [len(r.prompt) for r in trace]
    runs, counts = {}, {}
    for label in ("without prewarm", "with prewarm"):
        first = {}

        def on_token(rid, token, step, first=first):
            first.setdefault(rid, time.perf_counter())

        sch = ServeScheduler(cfg, params, on_token=on_token, device=dev,
                             **HYMBA_SERVE)
        flash_attention.launches = rwkv6.launches = 0
        buckets, prewarm_s = None, None
        if label == "with prewarm":
            stats = dict(sch.stats)
            buckets, prewarm_s = timed(lambda: sch.prewarm(lens))
            check(buckets == len(sch.prefill_buckets(lens))
                  and sch.stats == stats and sch.drained()
                  and not M.cache_slot_occupancy(sch.cache).any(),
                  "prewarm left scheduler state behind")
        t0 = time.perf_counter()
        done, wall = timed(lambda: sch.run(trace))
        counts[label] = {"K4": flash_attention.launches,
                         "K6": rwkv6.launches}
        runs[label] = [(c.rid, c.tokens) for c in done]
        emit(phase="serve_store", run=f"hymba-1.5b ServeScheduler.run, "
             f"{label}", buckets=sch.prefill_buckets(lens),
             prewarmed=buckets, prewarm_s=prewarm_s, run_s=wall,
             first_request_ttft_s=first[min(first)] - t0,
             completions=len(done), launches=counts[label], card=card)
        check(len(done) == len(trace), f"hymba serving ({label})")
    same = runs["without prewarm"] == runs["with prewarm"]
    emit(phase="serve_store", case="completions with and without prewarm",
         equal=same, card=card)
    check(same, "prewarm changed the completions")
    return counts["with prewarm"]


def profile_lm(arch: str) -> None:
    """Device busy share of one warm prefill (1024 tokens) and one warm
    decode step (batch 4) of ``arch`` (hymba-1.5b and rwkv6-1.6b as
    published, dbrx-132b at 4 layers), in a child process of its own (see
    ``profile_second_slice``), started early as it is."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    wait_for_turn("flash_attention", "rwkv6_scan", "moe_gemm")
    dev = torch.device("cuda")
    cfg = dbrx_config() if arch == DBRX_LM else get_config(arch)
    params = M.compute_params(cfg, M.init_params(cfg, 76, device=dev), dev)
    toks = torch.from_numpy(np.random.default_rng(77).integers(
        0, cfg.vocab_size, (4, 1024)).astype(np.int32)).to(dev)
    _, cache = M.prefill(cfg, params, toks,
                         M.init_cache(cfg, 4, 1100, device=dev))

    def prefill():
        return M.prefill(cfg, params, toks[:1],
                         M.init_cache(cfg, 1, 1100, device=dev))

    def decode():
        return M.decode_step(cfg, params, cache, toks[:, :1],
                             torch.full((4,), 1024, device=dev))

    for case, fn in ((f"{arch} prefill 1024 tokens, warm", prefill),
                     (f"{arch} decode step, batch 4, warm", decode)):
        timed(fn)
        device_share(case, fn)


def compare_grads(name: str, got, want, dtype) -> float:
    """K4's backward against its plain version, each of dq, dk and dv:
    float32 within ``K4_TOL`` (rtol = atol); bfloat16 within
    ``K4_BF16_REL_NORM`` on ||got - want|| / ||want||, its max abs error a
    reading.  Returns the worst max abs error."""
    import torch
    worst = 0.0
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        max_abs = diff.max().item()
        rel_norm = (diff.norm() / w.norm().clamp_min(1e-30)).item()
        ok = bool(torch.allclose(g, w, rtol=K4_TOL, atol=K4_TOL)) \
            if dtype == torch.float32 else rel_norm <= K4_BF16_REL_NORM
        emit(phase="kernel_vs_plain", kernel="K4 backward",
             case=f"{name}, {label}", shape=list(g.shape),
             max_abs_err=max_abs, rel_norm=rel_norm,
             tol=K4_TOL if dtype == torch.float32 else None,
             rel_norm_tol=None if dtype == torch.float32
             else K4_BF16_REL_NORM, ok=ok)
        check(ok, f"K4's backward disagrees with its plain version ({name}, "
              f"{label})")
        worst = max(worst, max_abs)
    return worst


def k4_backward_cases(dev, cases: dict, seed: int) -> float:
    """K4's backward (``flash_attention_bwd``: dq, dk, dv) against the
    autograd of ``flash_attention_plain`` at ``cases`` (label -> (B, H, Hkv,
    D, S, masks)) in bfloat16 and float32, each case run twice and the two
    bit-identical (no atomics).  Returns the worst max abs error."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    worst = 0.0
    for label, (b, h, hkv, d, s, kw) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(b, h, s, d, dtype=dtype)
            k, v = (randn(b, hkv, s, d, dtype=dtype) for _ in range(2))
            dout = randn(b, h, s, d, dtype=dtype)
            with torch.no_grad():
                out = flash_attention(q, k, v, **kw)
            got = flash_attention_bwd(q, k, v, out, dout, **kw)
            again = flash_attention_bwd(q, k, v, out, dout, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            name = f"{label} {str(dtype)[6:]}: B={b}, H={h}, Hkv={hkv}, " \
                f"D={d}, {kw}"
            emit(phase="check", case=f"K4 backward {name}, two runs",
                 bit_identical=same, ok=same)
            check(same, f"K4's backward: two runs differ ({name})")
            worst = max(worst, compare_grads(
                name, got, flash_attention_bwd_plain(q, k, v, dout, **kw),
                dtype))
    return worst


def k4_backward_against_plain(dev) -> float:
    """Phase 27: K4's backward against its plain version at phase 12's
    shapes and at qwen3-1.7b's training shape (B 8, S 256).  Returns the
    worst max abs error."""
    return k4_backward_cases(dev, K4_BWD_CASES, 90)


K6_GRADS = ("dr", "dk", "dv", "dw", "du")


def k6_bwd_inputs(gen, dev, b: int, h: int, t: int, kk: int, vv: int,
                  dtype, u_zero: bool, w_val: float = None) -> tuple:
    """(r, k, v, w, u, do, dstate): r, k, v in ``dtype``; w float32 through
    the models' own map, exp(-exp(x - 0.5)) clamped to [1e-6, 1 - 1e-6] (or
    the constant ``w_val``); u zero or normal; do, dstate normal."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn(b, h, t, n).to(dtype) for n in (kk, kk, vv))
    w = torch.exp(-torch.exp(randn(b, h, t, kk) - 0.5)) if w_val is None \
        else torch.full((b, h, t, kk), w_val, device=dev)
    u = torch.zeros((h, kk), device=dev) if u_zero else randn(h, kk)
    return (r, k, v, w.clamp(1e-6, 1 - 1e-6), u, randn(b, h, t, vv),
            randn(b, h, kk, vv))


def k6_bwd_plain64(r, k, v, w, u, do, dstate, chunk: int,
                   group: int = 8) -> list:
    """K6's plain backward (``rwkv6_bwd_plain``) on float64 copies of the
    inputs, ``group`` heads at a time (autograd keeps a (C, C, K) array a
    chunk); du's rows are its heads'."""
    import torch
    from repro_torch.kernels.rwkv6_scan import rwkv6_bwd_plain
    parts = []
    for h0 in range(0, r.shape[1], group):
        hs = slice(h0, h0 + group)
        parts.append(rwkv6_bwd_plain(
            *(x[:, hs].double() for x in (r, k, v, w)), u[hs].double(),
            do[:, hs].double(),
            None if dstate is None else dstate[:, hs].double(), chunk=chunk))
    return [torch.cat(g, dim=0 if i == 4 else 1)
            for i, g in enumerate(zip(*parts))]


def compare_k6_grads(name: str, got, want, dtype) -> float:
    """K6's backward against its plain version in float64, one row: each of
    dr, dk, dv, dw and du within ``K6_BWD_REL_NORM`` on ||got - want|| /
    ||want|| (bfloat16 r, k, v: ``K6_BWD_BF16_REL_NORM``), its max abs error
    a reading.  Returns the worst max abs error."""
    import torch
    rel, max_abs = {}, {}
    for label, g, w in zip(K6_GRADS, got, want):
        diff = (g.double() - w).abs()
        max_abs[label] = diff.max().item()
        rel[label] = (diff.norm() / w.norm().clamp_min(1e-300)).item()
    tol = K6_BWD_REL_NORM if dtype == torch.float32 else K6_BWD_BF16_REL_NORM
    ok = all(x <= tol for x in rel.values())
    emit(phase="kernel_vs_plain", kernel="K6 backward", case=name,
         shape=list(got[0].shape), max_abs_err=max(max_abs.values()),
         max_abs_by_grad=max_abs, rel_norm=rel, rel_norm_tol=tol,
         reference="rwkv6_bwd_plain on float64 copies", ok=ok)
    check(ok, f"K6's backward disagrees with its plain version ({name}): "
          f"{rel}")
    return max(max_abs.values())


def k6_backward_against_plain(dev) -> tuple:
    """Phase 32: K6's backward (``rwkv6_bwd``) against its plain version
    (``rwkv6_bwd_plain`` on float64 copies) at ``K6_BWD_HEADS`` (hymba-1.5b's
    SSM heads with u = 0, rwkv6-1.6b's with a learned u; B 2) and
    ``K6_BWD_T`` (T 2048 in chunks of 64, T 2016 in chunks of 32), in
    float32 and bfloat16, with and without a dstate; each case run twice,
    the two bit-identical, each gradient in its input's dtype; the plain
    version's own float32 gradients against float64 as a reading; extreme
    decays (w = 1e-6 and 1 - 1e-6) at hymba's heads; then K4's backward at
    hymba-1.5b's training shape (``K4_BWD_HYMBA``).  Returns the worst max
    abs errors of K6's and of K4's backward."""
    import torch
    from repro_torch.kernels.rwkv6_scan import rwkv6_bwd, rwkv6_bwd_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(120)

    def run(name, args, chunk, dtype, reading=False):
        r, k, v, w, u, do, ds = args
        got = rwkv6_bwd(r, k, v, w, u, do, ds, chunk=chunk)
        again = rwkv6_bwd(r, k, v, w, u, do, ds, chunk=chunk)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = same and all(g.dtype == x.dtype
                          for g, x in zip(got, (r, k, v, w, u)))
        emit(phase="check", case=f"K6 backward {name}, two runs",
             bit_identical=same, dtypes=[str(g.dtype)[6:] for g in got],
             ok=ok)
        check(ok, f"K6's backward: two runs differ, or a gradient is not "
              f"in its input's dtype ({name})")
        want = k6_bwd_plain64(r, k, v, w, u, do, ds, chunk)
        err = compare_k6_grads(name, got, want, dtype)
        if reading:
            plain = rwkv6_bwd_plain(r, k, v, w, u, do, ds, chunk=chunk)
            emit(phase="reading", case="K6's plain backward in float32 "
                 f"against float64, {name}", rel_norm={
                     label: ((p.double() - x).norm()
                             / x.norm().clamp_min(1e-300)).item()
                     for label, p, x in zip(K6_GRADS, plain, want)})
        return err

    worst = 0.0
    for label, (b, h, kk, vv, u_zero) in K6_BWD_HEADS.items():
        for t, chunk in K6_BWD_T:
            for dtype in (torch.float32, torch.bfloat16):
                args = k6_bwd_inputs(gen, dev, b, h, t, kk, vv, dtype,
                                     u_zero)
                for with_ds in (True, False):
                    name = f"{label} {str(dtype)[6:]}: B={b}, H={h}, " \
                        f"K={kk}, V={vv}, T={t}, chunk {chunk}, " \
                        f"{'with' if with_ds else 'no'} dstate"
                    worst = max(worst, run(
                        name, args if with_ds else (*args[:6], None), chunk,
                        dtype, reading=with_ds and dtype == torch.float32))
                del args
                torch.cuda.empty_cache()
    for w_val in (1e-6, 1 - 1e-6):
        worst = max(worst, run(
            f"hymba-1.5b SSM heads float32: B=1, H=25, K=16, V=64, T=256, "
            f"chunk 64, w = {w_val}", k6_bwd_inputs(
                gen, dev, 1, 25, 256, 16, 64, torch.float32, False, w_val),
            64, torch.float32))
    return worst, k4_backward_cases(dev, K4_BWD_HYMBA, 121)


def train_counters() -> dict:
    """The launch counters of the kernels a training step runs: K4, K6, K5
    and their backward kernels, in the order of the train CLI's last
    line."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gemm as K5
    from repro_torch.kernels import rwkv6_scan as RK
    return {"flash_attention": FA.flash_attention,
            "flash_attention_bwd": FA.flash_attention_bwd,
            "rwkv6": RK.rwkv6, "rwkv6_bwd": RK.rwkv6_bwd,
            "moe_gemm": K5.moe_gemm, "moe_gemm_bwd": K5.moe_gemm_bwd}


def zero_train_counts() -> None:
    for fn in train_counters().values():
        fn.launches = 0


def read_train_counts() -> dict:
    return {name: fn.launches for name, fn in train_counters().items()}


def expected_train_counts(cfg, steps: int) -> dict:
    """Under remat each layer's forward runs twice a step and its backward
    once: K4 where the mixer attends, K6 where it scans (hymba: both), K5
    three times (gate, up, down) where the FFN is an MoE, and its backward
    once a product (dx and dw in one call)."""
    n = cfg.n_layers * steps
    att, ssm = cfg.mixer in ("attn", "hymba"), cfg.mixer in ("rwkv", "hymba")
    moe = 3 * (cfg.ffn == "moe")
    return {"flash_attention": 2 * n * att, "flash_attention_bwd": n * att,
            "rwkv6": 2 * n * ssm, "rwkv6_bwd": n * ssm,
            "moe_gemm": 2 * n * moe, "moe_gemm_bwd": n * moe}


def grads_of(cfg, params, batch) -> tuple:
    """(loss, {path: gradient}) of ``loss_fn`` by autograd."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import _walk
    leaves = list(_walk(params))
    for _, p in leaves:
        p.requires_grad_(True)
    loss, _ = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), {path: g for (path, _), g in zip(leaves, grads)}


def train_in_situ(dev, arch: str, st: dict = TRAIN_SITU) -> None:
    """Phases 28 (qwen3-1.7b), 33 (rwkv6-1.6b, hymba-1.5b) and 37
    (dbrx-132b, ``DBRX_TRAIN_SITU``): ``arch`` at full width, depth cut to
    ``st``'s layers (2, dbrx-132b 1), float32 compute (params in the
    config's dtype), batch ``st``: the loss and the gradient of every param
    leaf on the card (K4, K6, K5 and their backward kernels) against the
    same params on the host (plain versions), each leaf within
    ``TRAIN_GRAD_TOL`` in relative norm; under remat each kernel's forward
    runs twice a layer and its backward once."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), n_layers=st["n_layers"],
                              compute_dtype="float32")
    params = M.init_params(cfg, 80, device=dev)
    host = to_host(params)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=st["seq"],
                                   global_batch=st["batch"],
                                   seed=81)).get_batch(0)
    zero_train_counts()
    t0 = time.perf_counter()
    loss_d, g_d = grads_of(cfg, params, {k: torch.from_numpy(v).to(dev)
                                         for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_train_counts()
    t0 = time.perf_counter()
    loss_h, g_h = grads_of(cfg, host, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    host_s = time.perf_counter() - t0
    rel = {"/".join(path): ((g_d[path].cpu().float() - g.float()).norm()
                            / g.float().norm().clamp_min(1e-30)).item()
           for path, g in g_h.items()}
    worst = max(rel, key=rel.get)
    n = cfg.n_layers
    ok = bool(torch.isfinite(loss_d)) and abs(
        loss_d.item() - loss_h.item()) <= LM_TOL * abs(loss_h.item()) \
        and rel[worst] <= TRAIN_GRAD_TOL \
        and launches == expected_train_counts(cfg, 1)
    emit(phase="check", case=f"{arch} {n} layers f32 loss and gradients, "
         f"card vs host, B={st['batch']} x {st['seq']}",
         loss_card=loss_d.item(), loss_host=loss_h.item(),
         leaves=len(rel), worst_leaf=worst, worst_rel_norm=rel[worst],
         tol=TRAIN_GRAD_TOL, launches=launches, card_s=card_s,
         host_s=host_s, ok=ok)
    check(ok, f"{arch} in situ: card and host gradients differ ({worst}: "
          f"{rel[worst]}), or the kernels launched {launches}")


def train_full(arch: str = QWEN3) -> int:
    """Phases 29 (qwen3-1.7b), 34 (rwkv6-1.6b, hymba-1.5b) and 38
    (dbrx-132b), each in a child process of its own (``--train-full
    ARCH``): the train CLI's code on ``arch`` at full width,
    ``TRAIN_FULL[arch]``: ``repro_torch.launch.train.main`` (what ``python
    -m repro_torch.launch.train`` runs) at full depth, or, where
    ``TRAIN_FULL`` cuts the depth, ``train.train`` (the loop ``main`` runs
    once it has built the config) on the config with its depth cut.  Every
    count zeroed just before and read just after; its losses finite and
    falling, K4 (where the model attends) and K6 (where it scans) twice a
    layer a step and their backward kernels once, K5 six times a MoE layer
    a step and its backward three times, the plain versions never.  Then
    the device busy share of one warm step on a fresh state of the same
    size (the first freed), and the step's split.  It starts early and
    waits (``wait_for_turn``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import moe_gemm as K5
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import _set, _walk, count_params
    from repro_torch.optim import adamw
    wait_for_turn("flash_attention", "rwkv6_scan", "moe_gemm",
                  *BACKWARD_SOURCES)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    plain = count_plain_calls()
    t = TRAIN_FULL[arch]
    cut = {"n_layers": t["n_layers"]} if "n_layers" in t else {}
    cfg = get_config(arch, **cut)
    argv = ["--arch", arch, "--steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]),
            *(["--lr", str(t["lr"])] if "lr" in t else []),
            "--log-every", "5", "--metrics-out",
            str(ROOT / "build" / f"train_full_{arch}_metrics.json")]
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    for fn in (K5.moe_gemm, K5.moe_gemm_bwd):
        fn.routes.clear()
        fn.uploads = 0
    t0 = time.perf_counter()
    hist = train.train(cfg, train.parse_args(argv)) if cut \
        else train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_train_counts()
    routes = {"moe_gemm": dict(K5.moe_gemm.routes),
              "moe_gemm_bwd": dict(K5.moe_gemm_bwd.routes)}
    # the in-graph expert map is one object per shape: K5's schedule and
    # its backward's CSR walk are each uploaded once in the whole run
    uploads = {"moe_gemm": K5.moe_gemm.uploads,
               "moe_gemm_bwd": K5.moe_gemm_bwd.uploads}
    peak = torch.cuda.max_memory_allocated()
    leaves = [p for _, p in _walk(M.abstract_params(cfg))]
    n_params = count_params(M.abstract_params(cfg))
    # params and grads in the params' dtype, AdamW's m and v in float32
    state_bytes = sum(p.numel() * (2 * p.element_size() + 8) for p in leaves)
    losses = [h["loss"] for h in hist]
    dts = np.array([h["dt"] for h in hist[1:]])
    steps = len(hist)
    ok = steps == t["steps"] and bool(np.all(np.isfinite(losses))) \
        and losses[-1] < losses[0] \
        and launches == expected_train_counts(cfg, steps) \
        and not any(plain.values()) \
        and set(uploads.values()) == {int(cfg.ffn == "moe")}
    emit(phase="main_path", case=f"{arch} train CLI, full width, "
         + (f"depth cut to {cfg.n_layers}" if cut else "full depth"),
         arch=arch, argv=argv, steps=steps, n_layers=cfg.n_layers,
         n_params=n_params, training_state_bytes=state_bytes,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         k5_routes=routes, k5_schedule_uploads=uploads, losses=losses,
         first_step_s=hist[0]["dt"],
         step_s_p50=float(np.median(dts)),
         step_s_p99=float(np.percentile(dts, 99)),
         tokens_per_s=t["batch"] * t["seq"] / float(np.median(dts)),
         max_memory_allocated_bytes=peak, launches=launches,
         per_step={k: v / steps for k, v in launches.items()},
         plain_calls=plain, cli_s=wall, ok=ok, card=card)
    check(ok, f"{arch} training: losses {losses[0]} -> {losses[-1]}, "
          f"launches {launches}, plain {plain}, K5 uploads {uploads}")
    # the busy share of one warm step on a fresh state of the same size
    # (the CLI's state is freed: at dbrx-132b two would not fit)
    del hist
    torch.cuda.empty_cache()
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    params = M.init_params(cfg, 1, device=dev)
    opt = adamw.init(opt_cfg, params)
    step = make_train_step(cfg, opt_cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                   global_batch=t["batch"], seed=2)).get_batch(0).items()}
    for _ in range(2):
        timed(lambda: step(params, opt, batch))
    device_share(f"{arch} train step, B={t['batch']} x {t['seq']}, warm",
                 lambda: step(params, opt, batch))
    # the step's split: the loss and its gradients, then the AdamW update
    grads, fb_s = timed(lambda: grads_of(cfg, params, batch)[1])
    tree = {}
    for path, g in grads.items():
        _set(tree, path, g)
    _, opt_s = timed(lambda: adamw.update(opt_cfg, tree, opt, params))
    emit(phase="times", case=f"{arch} train step split, B={t['batch']} x "
         f"{t['seq']}, warm", loss_and_grads_s=fb_s, adamw_update_s=opt_s,
         card=card)
    return 0


def train_cli_args(arch: str, steps: int, label: str, ckpt: bool) -> list:
    """The reduced train CLI's arguments: ``steps`` steps, metrics to
    ``<label>.json``, with ``ckpt`` a checkpoint directory (written by the
    first run, resumed from by the second)."""
    root = ROOT / "build" / f"train_cli_{arch}"
    return ["--arch", arch, *TRAIN_CLI_ARGS, "--steps", str(steps),
            *(["--ckpt-dir", str(root / "ckpt")] if ckpt else []),
            "--metrics-out", str(root / f"{label}.json")]


def train_cli_in_process(arch: str, steps: int, label: str, ckpt: bool
                         ) -> dict:
    """The train CLI's entry point (``train.main``) in this process, every
    count zeroed just before and read just after."""
    from repro_torch.launch import train
    zero_train_counts()
    t0 = time.perf_counter()
    hist = train.main(train_cli_args(arch, steps, label, ckpt))
    return dict(seconds=time.perf_counter() - t0,
                steps=[h["step"] for h in hist],
                losses=[h["loss"] for h in hist],
                launches=read_train_counts())


def train_cli_phase(first: dict, resumed: dict, card: str) -> None:
    """Phase 31: the reduced train CLI on the card with a checkpoint
    resume: ``first`` holds each arch's first run (3 steps into a
    checkpoint, through ``train.main`` here), ``resumed`` its second, a
    process of its own (``python -m repro_torch.launch.train``) that
    resumes from the checkpoint to step 6.  Then 6
    uninterrupted steps through ``train.main`` here.  Each run launches K4
    and K6 (as the arch's layers have them) twice a layer a step (remat)
    and their backward kernels once; the resumed losses must equal the
    uninterrupted run's within ``TRAIN_RESUME_RTOL``."""
    import re
    from repro_torch.configs import get_config, reduced_config
    found_re = re.compile(r"kernel launches: " + " ".join(
        f"{name}=(\\d+)" for name in train_counters()))
    for arch in TRAIN_CLI_ARCHS:
        cfg = reduced_config(get_config(arch))
        out, wall = finish_child(resumed[arch], f"train CLI {arch} (resumed)")
        found = found_re.search(out)
        with open(train_cli_args(arch, 6, "resumed", True)[-1]) as f:
            hist = json.load(f)
        runs = {"first": first[arch],
                "resumed": dict(process_s=wall,
                                steps=[h["step"] for h in hist],
                                losses=[h["loss"] for h in hist],
                                launches=dict(zip(train_counters(), (
                                    int(x) for x in found.groups())))
                                if found else None),
                "whole": train_cli_in_process(arch, 6, "whole", False)}
        got = runs["first"]["losses"] + runs["resumed"]["losses"]
        want = runs["whole"]["losses"]
        ok = all(r["launches"] == expected_train_counts(cfg, len(r["steps"]))
                 for r in runs.values()) \
            and runs["resumed"]["steps"] == [3, 4, 5] and len(want) == 6 \
            and bool(np.allclose(got, want, rtol=TRAIN_RESUME_RTOL, atol=0)) \
            and want[-1] < want[0]
        emit(phase="train_cli", arch=arch, args=TRAIN_CLI_ARGS, runs=runs,
             resumed_bit_equal=got == want, rtol=TRAIN_RESUME_RTOL, ok=ok,
             card=card)
        check(ok, f"train CLI {arch}: {runs}")


def k4_backward_times(dev, card: str) -> dict:
    """Phase 30: K4's backward by CUDA events at qwen3-1.7b's training shape
    (B 8, S 256) and at S = 2048 (B 1), bfloat16, causal, beside its bound
    (five S x S x D products per head over the visible pairs, bf16 peak,
    against q, k, v, out and dout read once and dq, dk, dv written once),
    its plain version (``flash_attention_plain``'s autograd) and the
    backward of ``scaled_dot_product_attention`` (``is_causal``, kv heads
    repeated for GQA) on the same inputs.  Returns the training shape's row
    for the kernels line."""
    import torch
    from repro_torch.kernels.flash_attention import (
        attention_mask, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(91)
    rows = {}
    h, hkv, d = 16, 8, 128                       # qwen3-1.7b's heads
    for label, b, s in K4_BWD_TIMED:
        q, dout = (torch.randn((b, h, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        with torch.no_grad():
            out = flash_attention(q, k, v)
        pairs = int(attention_mask(s, causal=True, window=0,
                                   device=dev).sum())
        flop = 5 * 2 * b * h * pairs * d
        nbytes = (3 * q.numel() + 2 * k.numel()) * 2 \
            + (q.numel() + 2 * k.numel()) * 2
        bound_ms, bound_by = bound(flop, nbytes, BF16_FLOPS)
        qs, ks, vs = (x.detach().requires_grad_(True) for x in (
            q, k.repeat_interleave(h // hkv, 1),
            v.repeat_interleave(h // hkv, 1)))
        o = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)
        row = dict(
            ms=event_ms(lambda: flash_attention_bwd(q, k, v, out, dout)),
            plain_ms=event_ms(lambda: flash_attention_bwd_plain(q, k, v,
                                                                dout), 5),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=event_ms(lambda: torch.autograd.grad(
                o, (qs, ks, vs), dout, retain_graph=True)))
        emit(phase="times", kernel="K4 backward", case=f"{label} bf16, B={b}"
             f", H={h}, Hkv={hkv}, D={d}, S={s}, causal", visible_pairs=pairs,
             flop=flop, bytes=nbytes, tflops=flop / row["ms"] / 1e9,
             library="autograd of scaled_dot_product_attention(is_causal)",
             **row, card=card)
        rows[label] = row
    return rows


def k6_bwd_flop(b: int, h: int, t: int, kk: int, vv: int, chunk: int,
                design: bool = False) -> int:
    """FLOP of K6's backward (an FMA is two; the exponentials not counted,
    as in K6's bound): per chunk, the pairs s < t for A, dr and dk (2 + 2 +
    2 per channel), the pairs s <= t for dA and A^T do (2 + 2 per column),
    and 10 C K V for Q, U, do S^T, v G^T and (k e^{L - cum}) G.  dw then
    needs O(T K) from dr and dk.  ``design`` adds the 4 per pair and channel
    of the kernel's own dw recurrence (csrc/rwkv6_scan_bwd.cu, step d),
    which the function does not need."""
    c = chunk
    per_pair = (10 if design else 6) * kk
    per_chunk = c * (c - 1) // 2 * per_pair + c * (c + 1) * 2 * vv \
        + 10 * c * kk * vv
    return b * h * (t // c) * per_chunk


def k6_backward_times(dev, card: str) -> dict:
    """Phase 35: K6's backward by CUDA events at the two training shapes
    (``K6_BWD_HEADS`` at T 2048, chunk 64; bfloat16 r, k, v and float32 w,
    as the models pass them; no dstate, as the loss leaves the final state
    unused), beside its bound (``k6_bwd_flop`` at the peak of r, k, v's
    type, bf16's here, as K4's backward takes it, against r, k, v, w, u and
    do read once and dr, dk, dv, dw and du written once), its
    plain version (``rwkv6_plain``'s autograd) and K6's forward on the same
    inputs.  No library call computes it.  Returns the rows by label."""
    import torch
    from repro_torch.kernels.rwkv6_scan import (rwkv6, rwkv6_bwd,
                                                rwkv6_bwd_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(122)
    rows = {}
    t, chunk = TRAIN_FULL[RWKV6]["seq"], 64
    for label, (b, h, kk, vv, u_zero) in K6_BWD_HEADS.items():
        r, k, v, w, u, do, _ = k6_bwd_inputs(gen, dev, b, h, t, kk, vv,
                                             torch.bfloat16, u_zero)
        flop = k6_bwd_flop(b, h, t, kk, vv, chunk)
        nbytes = 2 * (sum(x.numel() * x.element_size()
                          for x in (r, k, v, w, u))) \
            + do.numel() * do.element_size()
        bound_ms, bound_by = bound(flop, nbytes, BF16_FLOPS
                                   if r.dtype == torch.bfloat16
                                   else FP32_FLOPS)
        design_flop = k6_bwd_flop(b, h, t, kk, vv, chunk, design=True)
        row = dict(
            ms=event_ms(lambda: rwkv6_bwd(r, k, v, w, u, do, chunk=chunk)),
            plain_ms=event_ms(lambda: rwkv6_bwd_plain(r, k, v, w, u, do,
                                                      chunk=chunk), 3),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        emit(phase="times", kernel="K6 backward", case=f"{label} training "
             f"shape B={b}, H={h}, K={kk}, V={vv}, T={t}, chunk {chunk}, bf16 "
             "r/k/v, f32 w, no dstate", flop=flop, design_flop=design_flop,
             bytes=nbytes, design_tflops=design_flop / row["ms"] / 1e9,
             fp32_flop_ms=design_flop / FP32_FLOPS * 1e3, library="none",
             forward_ms=event_ms(lambda: rwkv6(r, k, v, w, u, chunk=chunk)),
             **row, card=card)
        rows[label] = row
    return rows


def k5_map(kind, nb: int, n_experts: int, rng) -> np.ndarray:
    """A ``K5_BWD_CASES`` expert map: ``in_graph`` (bundle b meets expert
    b % E), ``random`` (seeded), or the ids given."""
    if kind == "in_graph":
        return np.arange(nb, dtype=np.int32) % n_experts
    if kind == "random":
        return rng.integers(0, n_experts, nb).astype(np.int32)
    return np.asarray(kind, np.int32)


def k5_bwd_inputs(gen, dev, nb: int, cap: int, d_in: int, d_out: int,
                  n_experts: int, dtype) -> tuple:
    """(x, w, dy) in ``dtype`` from normals on the card, w scaled by
    d_in^-1/2 as the models' init scales it."""
    import torch

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    return (randn(nb, cap, d_in), randn(n_experts, d_in, d_out,
                                        scale=d_in ** -0.5),
            randn(nb, cap, d_out))


def compare_k5_grads(name: str, got, want, dtype) -> float:
    """K5's backward against its plain version, one row: dx and dw each
    within ``K5_BWD_REL_NORM`` on ||got - want|| / ||want||, its max abs
    error a reading.  Returns the worst max abs error."""
    rel, max_abs = {}, {}
    for label, g, w in zip(("dx", "dw"), got, want):
        diff = (g.float() - w.float()).abs()
        max_abs[label] = diff.max().item()
        rel[label] = (diff.norm() / w.float().norm().clamp_min(1e-30)).item()
    tol = K5_BWD_REL_NORM[str(dtype)[6:]]
    ok = all(x <= tol for x in rel.values()) \
        and all(g.dtype == dtype for g in got)
    emit(phase="kernel_vs_plain", kernel="K5 backward", case=name,
         shape=[list(g.shape) for g in got],
         max_abs_err=max(max_abs.values()), max_abs_by_grad=max_abs,
         rel_norm=rel, rel_norm_tol=tol, ok=ok)
    check(ok, f"K5's backward disagrees with its plain version ({name}): "
          f"{rel}")
    return max(max_abs.values())


def k5_backward_against_plain(dev) -> float:
    """Phase 36: K5's backward (``moe_gemm_bwd``: dx, dw) against its plain
    version (``moe_gemm_bwd_plain``) at ``K5_BWD_CASES`` in float32 and
    bfloat16, each case run twice and the two bit-identical (no atomics),
    an expert no bundle meets getting zeros; then K5 under autograd at
    dbrx-132b's training gate shape in bfloat16: its forward's bits equal
    the no-grad call's, its gradients the backward entry's called directly,
    and the counts exact (one forward launch, one backward call of dx and
    dw).  Returns the worst max abs error."""
    import torch
    from repro_torch.kernels import moe_gemm as K5
    gen = torch.Generator(device=dev)
    gen.manual_seed(130)
    rng = np.random.default_rng(131)
    worst = 0.0
    for label, (nb, cap, d_in, d_out, n_exp, kind) in K5_BWD_CASES.items():
        be = k5_map(kind, nb, n_exp, rng)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = k5_bwd_inputs(gen, dev, nb, cap, d_in, d_out, n_exp,
                                     dtype)
            got = K5.moe_gemm_bwd(x, w, be, dy)
            again = K5.moe_gemm_bwd(x, w, be, dy)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            empty = sorted(set(range(n_exp)) - set(be.tolist()))
            zeros = all(not got[1][e].any() for e in empty)
            name = f"{label} {str(dtype)[6:]}: {nb} bundles of {cap}, " \
                f"{d_in} -> {d_out}, {n_exp} experts"
            emit(phase="check", case=f"K5 backward {name}, two runs",
                 bit_identical=same, experts_without_bundle=empty,
                 their_dw_zero=zeros, ok=same and zeros)
            check(same and zeros, f"K5's backward: two runs differ, or an "
                  f"expert with no bundle got a nonzero dw ({name})")
            del again
            worst = max(worst, compare_k5_grads(
                name, got, K5.moe_gemm_bwd_plain(
                    x, w, torch.from_numpy(be).to(dev), dy), dtype))
            del x, w, dy, got
            torch.cuda.empty_cache()
    nb, cap, d_in, d_out, n_exp, kind = K5_BWD_CASES[
        "dbrx-132b training, gate and up"]
    be = k5_map(kind, nb, n_exp, rng)
    x, w, dy = k5_bwd_inputs(gen, dev, nb, cap, d_in, d_out, n_exp,
                             torch.bfloat16)
    xl, wl = (t.detach().requires_grad_(True) for t in (x, w))
    with torch.no_grad():
        want_out = K5.moe_gemm(x, w, be)
    f0, b0 = K5.moe_gemm.launches, K5.moe_gemm_bwd.launches
    r0 = dict(K5.moe_gemm_bwd.routes)
    out = K5.moe_gemm(xl, wl, be)
    grads = torch.autograd.grad(out, (xl, wl), dy)
    counts = (K5.moe_gemm.launches - f0, K5.moe_gemm_bwd.launches - b0,
              {k: v - r0.get(k, 0) for k, v in K5.moe_gemm_bwd.routes.items()})
    direct = K5.moe_gemm_bwd(x, w, be, dy)
    torch.cuda.synchronize()
    fwd_same = torch.equal(out, want_out)
    grads_same = all(torch.equal(g, d) for g, d in zip(grads, direct))
    ok = fwd_same and grads_same and counts == (1, 1, {"dx": 1, "dw": 1})
    emit(phase="check", case=f"K5 under autograd, dbrx-132b training gate "
         f"bf16: {nb} bundles of {cap}, {d_in} -> {d_out}",
         forward_bit_equal_no_grad=fwd_same,
         grads_equal_backward_entry=grads_same,
         launches={"moe_gemm": counts[0], "moe_gemm_bwd": counts[1],
                   "moe_gemm_bwd_routes": counts[2]}, ok=ok)
    check(ok, f"K5 under autograd: forward {fwd_same}, grads {grads_same}, "
          f"launches {counts}")
    return worst


def k5_backward_times(dev, card: str) -> dict:
    """Phase 39: K5's backward by CUDA events at dbrx-132b's training
    bundles (32 of cap 320, the in-graph map), the gate and up products'
    widths (6144 -> 10752) and down's (10752 -> 6144), bfloat16: the whole
    call (dx and dw) and each entry, beside the bound (each entry 2 x rows
    x d_in x d_out FLOP at the bf16 peak, against x, w and dy read once and
    dx and dw written once), the plain version and the library's
    ``torch.bmm`` on inputs grouped by expert beforehand (dx: one
    ``bmm(dy_grouped, w.transpose(1, 2))`` over (E, rows x cap, .); dw: one
    ``bmm(x_grouped^T, dy_grouped)``), as phase 20 times K5.  Returns the
    rows by label."""
    import torch
    from repro_torch.kernels import moe_gemm as K5
    gen = torch.Generator(device=dev)
    gen.manual_seed(132)
    rows = {}
    for label in ("dbrx-132b training, gate and up",
                  "dbrx-132b training, down"):
        nb, cap, d_in, d_out, n_exp, kind = K5_BWD_CASES[label]
        be = k5_map(kind, nb, n_exp, None)
        x, w, dy = k5_bwd_inputs(gen, dev, nb, cap, d_in, d_out, n_exp,
                                 torch.bfloat16)
        rep = nb // n_exp                    # bundle r * E + e meets e

        def grouped(t):
            return t.reshape(rep, n_exp, cap, -1).transpose(0, 1).reshape(
                n_exp, rep * cap, -1).contiguous()

        xg, dyg = grouped(x), grouped(dy)
        flop = 2 * nb * cap * d_in * d_out             # an entry
        nbytes = 2 * (2 * x.numel() + 2 * w.numel() + dy.numel())
        bound_ms, bound_by = bound(2 * flop, nbytes, BF16_FLOPS)
        entry = {}
        for name, need in (("dx", (True, False)), ("dw", (False, True))):
            e_bytes = 2 * (dy.numel() + w.numel() + x.numel()) \
                if name == "dx" else 2 * (x.numel() + dy.numel() + w.numel())
            e_bound, e_by = bound(flop, e_bytes, BF16_FLOPS)
            ms = event_ms(lambda: K5._k5_bwd(x, w, be, be, dy, *need), 10)
            lib = event_ms((lambda: torch.bmm(dyg, w.transpose(1, 2)))
                           if name == "dx" else
                           (lambda: torch.bmm(xg.transpose(1, 2), dyg)), 10)
            entry[name] = dict(ms=ms, bound_ms=e_bound, bound_by=e_by,
                               library_ms=lib, tflops=flop / ms / 1e9)
        row = dict(
            ms=event_ms(lambda: K5.moe_gemm_bwd(x, w, be, dy), 10),
            plain_ms=event_ms(lambda: K5.moe_gemm_bwd_plain(
                x, w, torch.from_numpy(be).to(dev), dy), 3),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=entry["dx"]["library_ms"]
            + entry["dw"]["library_ms"])
        emit(phase="times", kernel="K5 backward", case=f"{label} bf16: {nb} "
             f"bundles of {cap}, {d_in} -> {d_out}, {n_exp} experts",
             flop=2 * flop, bytes=nbytes, tflops=2 * flop / row["ms"] / 1e9,
             library="torch.bmm on inputs grouped by expert: dx "
             "bmm(dy_g, w^T), dw bmm(x_g^T, dy_g)", entries=entry,
             forward_ms=event_ms(lambda: K5.moe_gemm(x, w, be), 10),
             **row, card=card)
        rows[label] = dict(row, entries=entry)
        del x, w, dy, xg, dyg
        torch.cuda.empty_cache()
    return rows


def mesh_devices(n: int) -> list:
    """``n`` distinct cards where that many are visible, else
    ``MESH_DEVICE`` repeated ``n`` times (one card runs every shard)."""
    import torch
    if MESH_DEVICE.startswith("cuda") and torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return [MESH_DEVICE] * n


def card_mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, mesh_devices(int(np.prod(shape))))


def count_plain_calls() -> dict:
    """Wrap the plain versions of K4, K6, K5 and their backward kernels so
    that each call counts: on the card's paths they must never run."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gemm as K5
    from repro_torch.kernels import rwkv6_scan as RK
    plain = {}

    def counted(module, name):
        fn = getattr(module, name)
        plain[name] = 0

        def wrapper(*args, **kw):
            plain[name] += 1
            return fn(*args, **kw)
        setattr(module, name, wrapper)

    for module, name in ((FA, "flash_attention_plain"),
                         (FA, "flash_attention_bwd_plain"),
                         (RK, "rwkv6_plain"), (RK, "rwkv6_bwd_plain"),
                         (K5, "moe_gemm_plain"), (K5, "moe_gemm_bwd_plain")):
        counted(module, name)
    return plain


def out_of_tol(got, want) -> tuple:
    """(max |got - want|, elements past MESH_ATOL + MESH_RTOL |want|)."""
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            int((diff > MESH_ATOL + MESH_RTOL * want.float().abs()).sum()))


def mesh_train_run(cfg, argv, mesh, after_step, same_params=None) -> dict:
    """``train.train(cfg, parse_args(argv), mesh=mesh)`` with
    ``after_step(params)`` called after each step (outside the step's
    timing in the history only where it is cheap), every count zeroed just
    before and read just after.  With a list ``same_params``, before each
    step ``M.loss_fn`` runs on one device at the params the step takes
    (gathered) and its batch, without grad; ``(the step's loss, that
    loss)`` is appended after the step."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.params import _set, _walk
    from repro_torch.parallel import sharding as S
    make = train.make_train_step
    dev = torch.device(mesh_devices(1)[0])

    def loss_at(params, batch) -> float:
        # a comparison, not the path: its launches are not counted
        counts = read_train_counts()
        whole: dict = {}
        for path, leaf in _walk(params):
            _set(whole, path, S.gather(leaf, dev))
        with torch.no_grad():
            loss = float(M.loss_fn(cfg, whole, {k: v.to(dev) for k, v in
                                                batch.items()})[0])
        for name, fn in train_counters().items():
            fn.launches = counts[name]
        return loss

    def wrapped(cfg_, opt_cfg, mesh_=None):
        step = make(cfg_, opt_cfg, mesh_)

        def run(params, opt, batch):
            want = None if same_params is None else loss_at(params, batch)
            out = step(params, opt, batch)
            if same_params is not None:
                same_params.append((float(out[2]["loss"]), want))
            after_step(out[0])
            return out
        return run

    train.make_train_step = wrapped
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_train_counts()
        t0 = time.perf_counter()
        hist = train.train(cfg, train.parse_args(argv), mesh=mesh)
        torch.cuda.synchronize()
        return dict(hist=hist, launches=read_train_counts(),
                    peak=torch.cuda.max_memory_allocated(),
                    seconds=time.perf_counter() - t0)
    finally:
        train.make_train_step = make


def mesh_qwen3(card: str) -> dict:
    """Phase 40: qwen3-1.7b at full width and depth (1.72 B float32
    params, bfloat16 compute, remat) through the train CLI's loop on a
    (2, 2) ("data", "model") mesh, ``MESH_TRAIN`` at phase 29's seed and
    lr: first on one device, a host copy of the params after each step;
    then on the mesh (run A), every param leaf after each step held
    against that copy (``MESH_RTOL``, ``MESH_ATOL``) and the losses
    within ``MESH_LOSS_TOL``; then again (run B, nothing in its steps but
    the step: its step times and peak), its final params bit-equal to run
    A's.  On the mesh K4 and its backward launch twice as often as on one
    device: once per data shard."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import _walk
    from repro_torch.parallel import sharding as S
    t = MESH_TRAIN
    cfg = get_config(QWEN3)
    dev = torch.device(mesh_devices(1)[0])
    argv = ["--arch", QWEN3, "--steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--log-every", "1",
            "--device", str(dev)]
    snaps = []
    one = mesh_train_run(cfg, argv, None, lambda p: snaps.append(
        {path: x.detach().to("cpu", copy=True) for path, x in _walk(p)}))
    torch.cuda.empty_cache()
    mesh = card_mesh((2, 2), ("data", "model"))
    errs, last = [], []

    def against_one(params):
        want = snaps[len(errs)]
        worst, bad = 0.0, 0
        for path, leaf in _walk(params):
            w, n = out_of_tol(S.gather(leaf, dev), want[path].to(dev))
            worst, bad = max(worst, w), bad + n
        errs.append(dict(max_abs_err=worst, out_of_tol=bad))
        last[:] = [params]

    same = []
    run_a = mesh_train_run(cfg, argv, mesh, against_one, same)
    final_a = {path: S.gather(x, "cpu") for path, x in _walk(last[0])}
    n_sharded = sum(isinstance(x, S.ShardedTensor)
                    for _, x in _walk(last[0]))
    last.clear()
    del snaps
    torch.cuda.empty_cache()
    run_b = mesh_train_run(cfg, argv, mesh, lambda p: last.__setitem__(
        slice(None), [p]))
    bit_equal = all(torch.equal(S.gather(x, "cpu"), final_a[path])
                    for path, x in _walk(last[0]))
    last.clear()
    torch.cuda.empty_cache()
    losses = {name: [h["loss"] for h in r["hist"]]
              for name, r in (("one_device", one), ("mesh_a", run_a),
                              ("mesh_b", run_b))}
    dts = np.array([h["dt"] for h in run_b["hist"][1:]])
    steps = t["steps"]
    want_counts = expected_train_counts(cfg, steps)
    # each mesh step's loss against M.loss_fn on one device at the params
    # that step took: the reference's absolute 1e-3 on every step
    same_err = [abs(a - b) for a, b in same]
    # against the one-device run: the first step's loss is taken on the same
    # params, the reference's absolute 1e-3; later steps' on params already
    # held to MESH_RTOL / MESH_ATOL, whose loss (of order 1e3 at full width)
    # moves with them: LM_TOL relative
    loss_err = [abs(a - b) / (1.0 if i == 0 else abs(b)) for i, (a, b) in
                enumerate(zip(losses["mesh_a"], losses["one_device"]))]
    ok = len(losses["mesh_b"]) == steps \
        and len(same_err) == steps and max(same_err) < MESH_LOSS_TOL \
        and bool(np.all(np.isfinite(losses["mesh_b"]))) \
        and loss_err[0] < MESH_LOSS_TOL and max(loss_err[1:]) < LM_TOL \
        and all(e["out_of_tol"] == 0 for e in errs) \
        and one["launches"] == want_counts \
        and run_a["launches"] == run_b["launches"] == {
            k: 2 * v for k, v in want_counts.items()}
    emit(phase="check", case=f"{QWEN3} on a (2, 2) mesh against one device, "
         "each step", mesh=[str(d) for d in mesh.devices.flat],
         sharded_leaves=n_sharded, per_step=errs, losses=losses,
         loss_at_same_params=[b for _, b in same],
         loss_err_at_same_params=same_err, same_params_tol=MESH_LOSS_TOL,
         loss_err=loss_err, loss_tol=[MESH_LOSS_TOL, LM_TOL],
         rtol=MESH_RTOL, atol=MESH_ATOL,
         runs_bit_equal=bit_equal, one_device_launches=one["launches"],
         ok=ok, card=card)
    check(ok, f"{QWEN3} on a mesh: {errs}, losses {losses}, launches "
          f"{one['launches']} / {run_a['launches']} / {run_b['launches']}")
    emit(phase="main_path", case=f"{QWEN3} train CLI loop on a (2, 2) mesh, "
         "full width and depth", arch=QWEN3, argv=argv, steps=steps,
         losses=losses["mesh_b"], first_step_s=run_b["hist"][0]["dt"],
         step_s_p50=float(np.median(dts)),
         tokens_per_s=t["batch"] * t["seq"] / float(np.median(dts)),
         max_memory_allocated_bytes=run_b["peak"],
         one_device_max_memory_allocated_bytes=one["peak"],
         launches=run_b["launches"],
         per_step={k: v / steps for k, v in run_b["launches"].items()},
         runs_bit_equal=bit_equal, seconds=run_b["seconds"], ok=ok,
         card=card)
    return run_b["launches"]


def mesh_compressed(card: str) -> dict:
    """Phase 41: ``make_compressed_train_step`` on a (2, 1, 1) ("pod",
    "data", "model") mesh at qwen3-1.7b's full width, ``MESH_COMPRESSED``
    steps: each pod's loss and gradients on its half of the batch (K4 and
    its backward on each), the int8 payloads summed in int32 and
    dequantized at the larger scale; the params after each step against
    the exact one-device step's within ``MESH_COMP_ATOL``, the first
    step's loss (the same params) within ``MESH_LOSS_TOL``, later losses
    a reading; the first pod's error buffer's norm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import _walk
    from repro_torch.optim import adamw
    from repro_torch.parallel.compression import (init_error_state,
                                                  make_compressed_train_step)
    t = MESH_COMPRESSED
    cfg = get_config(QWEN3)
    dev = torch.device(mesh_devices(1)[0])
    opt_cfg = adamw.AdamWConfig(lr=t["lr"], warmup_steps=0, total_steps=10)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=t["seq"], global_batch=t["batch"],
                                  seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.get_batch(i).items()}
               for i in range(t["steps"])]
    params = M.init_params(cfg, 0, device=dev)
    opt = adamw.init(opt_cfg, params)
    step = make_train_step(cfg, opt_cfg)
    exact_losses, exact = [], []
    for b in batches:
        params, opt, m = step(params, opt, b)
        exact_losses.append(float(m["loss"]))
        exact.append({path: x.detach().to("cpu", copy=True)
                      for path, x in _walk(params)})
    del params, opt, step, m
    torch.cuda.empty_cache()
    mesh = card_mesh((2, 1, 1), ("pod", "data", "model"))
    params = M.init_params(cfg, 0, device=dev)
    opt = adamw.init(opt_cfg, params)
    err = init_error_state(params)
    cstep = make_compressed_train_step(cfg, opt_cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    losses, dts, deltas = [], [], []
    for b, want in zip(batches, exact):
        t0 = time.perf_counter()
        params, opt, err, m = cstep(params, opt, err, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        deltas.append(max((x.detach().float() - want[path].to(dev).float())
                          .abs().max().item() for path, x in _walk(params)))
    launches = read_train_counts()
    peak = torch.cuda.max_memory_allocated()
    delta = max(deltas)
    err_norm = adamw.global_norm(err).item()
    want_counts = {k: 2 * v for k, v in
                   expected_train_counts(cfg, t["steps"]).items()}
    ok = delta < MESH_COMP_ATOL \
        and abs(losses[0] - exact_losses[0]) < MESH_LOSS_TOL \
        and np.isfinite(err_norm) and err_norm > 0 \
        and launches == want_counts
    emit(phase="main_path", case=f"{QWEN3} int8 compressed step on a "
         "(2, 1, 1) pod mesh, full width, against the exact step",
         mesh=[str(d) for d in mesh.devices.flat], steps=t["steps"],
         batch=[t["batch"], t["seq"]], lr=t["lr"], losses=losses,
         exact_losses=exact_losses, max_abs_param_delta=deltas,
         tol=MESH_COMP_ATOL, error_buffer_norm=err_norm, step_s=dts,
         max_memory_allocated_bytes=peak, launches=launches, ok=ok,
         card=card)
    check(ok, f"compressed step: delta {delta}, losses {losses} / "
          f"{exact_losses}, error norm {err_norm}, launches {launches}")
    return launches


def mesh_pipeline(card: str) -> None:
    """Phase 42: ``pipeline_apply`` over a (4, 1) ("pipe", "model") mesh,
    stage ``s`` computing ``tanh(h @ w[s])`` at ``MESH_PIPE``'s width in
    float32 (TF32 off): its output (max abs error) and the gradients of
    w and x (||err|| / ||want||) against the four stages run in sequence,
    each within ``MESH_PIPE_TOL``."""
    import torch
    from repro_torch.parallel.pipeline import pipeline_apply
    p = MESH_PIPE
    dev = torch.device(mesh_devices(1)[0])
    gen = torch.Generator(device=dev).manual_seed(42)
    d = p["d"]
    w = (torch.randn(p["n_stage"], d, d, generator=gen, device=dev)
         / d ** 0.5).requires_grad_(True)
    x = torch.randn(p["n_micro"], *p["rows"], d, generator=gen,
                    device=dev).requires_grad_(True)
    ct = torch.randn(x.shape, generator=gen, device=dev)
    mesh = card_mesh((p["n_stage"], 1), ("pipe", "model"))

    def piped():
        y = pipeline_apply(lambda q, h: torch.tanh(h @ q["w"]), {"w": w}, x,
                           mesh=mesh)
        return (y, *torch.autograd.grad((y * ct).sum(), [w, x]))

    def sequential():
        y = x
        for s in range(p["n_stage"]):
            y = torch.tanh(y @ w[s])
        return (y, *torch.autograd.grad((y * ct).sum(), [w, x]))

    got, pipe_s = timed(piped)
    want, seq_s = timed(sequential)
    fwd = (got[0] - want[0]).abs().max().item()
    rel = [((a - b).norm() / b.norm()).item()
           for a, b in zip(got[1:], want[1:])]
    ok = fwd <= MESH_PIPE_TOL and max(rel) <= MESH_PIPE_TOL
    emit(phase="check", case="pipeline_apply on a (4, 1) pipe mesh against "
         "the sequential stages, forward and gradient",
         mesh=[str(d) for d in mesh.devices.flat], n_micro=p["n_micro"],
         rows=list(p["rows"]), d=d, max_abs_err=fwd,
         grad_rel_norm={"w": rel[0], "x": rel[1]}, tol=MESH_PIPE_TOL,
         pipeline_s=pipe_s, sequential_s=seq_s, ok=ok, card=card)
    check(ok, f"pipeline_apply: forward {fwd}, gradients {rel}")


def mesh_elastic(card: str) -> None:
    """Phase 43: the reference test's reduced gemma2-2b (seed 1) saved from
    a (4, 2) mesh, then ``elastic_restore`` on 6 devices with a model axis
    of 2: the (3, 2) mesh, and every leaf bit-equal."""
    import shutil

    import torch
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.models.params import _walk
    from repro_torch.parallel import sharding as S
    from repro_torch.runtime.elastic import elastic_restore
    cfg = reduced_config(get_config("gemma2-2b"))
    dev = torch.device(mesh_devices(1)[0])
    params = M.init_params(cfg, 1, device=dev)
    d = ROOT / "build" / "mesh_elastic_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(str(d), 3, S.shard_tree(params, S.params_shardings(
        cfg, card_mesh((4, 2), ("data", "model")))))
    mesh, tree, manifest = elastic_restore(
        str(d), cfg, M.abstract_params(cfg), model_parallel=2,
        devices=mesh_devices(6))
    seconds = time.perf_counter() - t0
    want = dict(_walk(params))
    equal = all(torch.equal(S.gather(x, dev), want[path])
                for path, x in _walk(tree))
    n_sharded = sum(isinstance(x, S.ShardedTensor) for _, x in _walk(tree))
    ok = equal and tuple(mesh.devices.shape) == (3, 2) \
        and manifest["step"] == 3 and n_sharded > 0
    emit(phase="check", case="elastic restore of reduced gemma2-2b from a "
         "(4, 2) mesh onto (3, 2)", mesh=list(mesh.devices.shape),
         sharded_leaves=n_sharded, leaves=len(want), bit_equal=equal,
         seconds=seconds, ok=ok, card=card)
    check(ok, f"elastic restore: mesh {mesh.devices.shape}, equal {equal}")


def mesh_moe(card: str) -> dict:
    """Phase 44: reduced dbrx-132b (float32, width 64, 4 experts) one
    sharded step on a (2, 2) mesh against the one-device step from the
    same init: the loss within ``MESH_LOSS_TOL`` and the params within
    ``MESH_RTOL`` / ``MESH_ATOL``; K5 and its backward (and K4 and its)
    launch twice as often, once per data shard."""
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.params import _walk
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    cfg = reduced_config(get_config(DBRX_LM))
    dev = torch.device(mesh_devices(1)[0])
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_MOE["seq"],
                   global_batch=MESH_MOE["batch"], seed=4)
    ).get_batch(0).items()}
    mesh = card_mesh((2, 2), ("data", "model"))
    out = {}
    for name, m in (("one_device", None), ("mesh", mesh)):
        params = M.init_params(cfg, 5, device=dev)
        if m is not None:
            params = S.shard_tree(params, S.params_shardings(cfg, m))
        opt = adamw.init(opt_cfg, params)
        zero_train_counts()
        (params, _, metrics), wall = timed(lambda: make_train_step(
            cfg, opt_cfg, m)(params, opt, batch))
        out[name] = dict(loss=float(metrics["loss"]), step_s=wall,
                         launches=read_train_counts(),
                         params={path: S.gather(x, dev)
                                 for path, x in _walk(params)})
    worst, bad = 0.0, 0
    for path, x in out["mesh"]["params"].items():
        w, n = out_of_tol(x, out["one_device"]["params"][path])
        worst, bad = max(worst, w), bad + n
    one, sharded = out["one_device"], out["mesh"]
    ok = abs(one["loss"] - sharded["loss"]) < MESH_LOSS_TOL and bad == 0 \
        and sharded["launches"] == {k: 2 * v for k, v in
                                    one["launches"].items()} \
        and sharded["launches"]["moe_gemm"] > 0
    emit(phase="main_path", case=f"{DBRX_LM} reduced, one sharded step on "
         "a (2, 2) mesh against one device", loss=sharded["loss"],
         one_device_loss=one["loss"], max_abs_param_err=worst,
         out_of_tol=bad, launches=sharded["launches"],
         one_device_launches=one["launches"], step_s=sharded["step_s"],
         ok=ok, card=card)
    check(ok, f"{DBRX_LM} on a mesh: losses {one['loss']} / "
          f"{sharded['loss']}, {bad} params out of tolerance, launches "
          f"{one['launches']} / {sharded['launches']}")
    return sharded["launches"]


def train_mesh() -> int:
    """Phases 40-44 in a child process of their own (``--train-mesh``),
    which must have the card to itself (about 45 GB at phase 40); it
    starts early and waits (``wait_for_turn``).  The last row gathers the
    launches of phases 40, 41 and 44."""
    import torch
    wait_for_turn("flash_attention", "moe_gemm", *BACKWARD_SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    plain = count_plain_calls()
    launches = {f"{QWEN3} training on a (2, 2) mesh": mesh_qwen3(card)}
    torch.cuda.empty_cache()
    launches[f"{QWEN3} compressed step on a (2, 1, 1) pod mesh"] = \
        mesh_compressed(card)
    torch.cuda.empty_cache()
    mesh_pipeline(card)
    torch.cuda.empty_cache()
    mesh_elastic(card)
    launches[f"{DBRX_LM} reduced on a (2, 2) mesh"] = mesh_moe(card)
    check(not any(plain.values()), f"plain versions ran: {plain}")
    emit(phase="mesh_launches", launches=launches, plain_calls=plain)
    return 0


def serve_mesh_run(cfg, params, mesh, spec: dict, rows=None) -> dict:
    """``make_prefill_step`` over ``spec``'s batch and prompt into a cache
    of prompt + n_dec positions, then n_dec ``make_decode_step`` steps on
    seeded tokens, on ``mesh`` (None: one device; the params sharded by
    ``params_shardings`` otherwise), over the rows ``[lo, hi)`` of the
    seeded batch where ``rows`` is given: the logits of each step and the
    final cache gathered onto the first device, the kernels' launches
    (zeroed just before), wall seconds of the prefill (its first call, and
    a second whose outputs are kept: a first call at new shapes spends
    seconds on the card's first use of the products' kernels) and of each
    step, and the peak device memory."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.params import _walk
    from repro_torch.parallel import sharding as S
    dev = torch.device(mesh_devices(1)[0])
    b, s, n_dec = spec["batch"], spec["prompt"], spec["n_dec"]
    rng = np.random.default_rng(spec["seed"])
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
             for _ in range(n_dec)]
    lo, hi = rows or (0, b)
    toks = torch.from_numpy(toks[lo:hi]).to(dev)
    steps = [torch.from_numpy(t[lo:hi]).to(dev) for t in steps]
    if mesh is not None:
        params = S.shard_tree(params, S.params_shardings(cfg, mesh))
    prefill = make_prefill_step(cfg, hi - lo, s + n_dec, mesh)
    decode = make_decode_step(cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    t0 = time.perf_counter()
    prefill(params, toks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    seen, step_s = [S.gather(logits, dev)], []
    del logits
    for i, tok in enumerate(steps):
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, tok, s + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        seen.append(S.gather(lg, dev))
    launches = read_train_counts()
    return dict(logits=seen, cache={path: S.gather(x, dev)
                                    for path, x in _walk(cache)},
                launches=launches, first_prefill_s=first_s,
                prefill_s=prefill_s, step_s=step_s,
                peak=torch.cuda.max_memory_allocated(),
                n_sharded=sum(isinstance(x, S.ShardedTensor)
                              for _, x in _walk(cache)))


def serve_mesh_compare(got: dict, want: dict, rows=None) -> dict:
    """Each step's logits and each cache leaf of ``got``, its rows
    ``[lo, hi)`` where ``rows`` is given, against ``want``'s: the largest
    error, the largest ||got - want|| / ||want|| of the logits, the
    elements past LM_TOL + LM_TOL |want| (or not finite), and whether every
    one is bit-equal."""
    import torch
    from repro_torch.launch.steps import _cache_axis

    def cut(x, axis):
        return x if rows is None else x.narrow(axis, rows[0],
                                               rows[1] - rows[0])

    pairs = [("logits", cut(a, 0), b) for a, b in zip(got["logits"],
                                                      want["logits"])]
    pairs += [("cache", cut(a, _cache_axis(path)), want["cache"][path])
              for path, a in got["cache"].items()]
    worst, rel, bad, equal = {"logits": 0.0, "cache": 0.0}, 0.0, 0, True
    for kind, a, b in pairs:
        diff = (a.float() - b.float()).abs()
        worst[kind] = max(worst[kind], diff.max().item())
        if kind == "logits":
            rel = max(rel, (diff.norm() / b.float().norm()).item())
        bad += int((diff > LM_TOL + LM_TOL * b.float().abs()).sum())
        bad += int((~torch.isfinite(a.float())).sum())
        equal &= bool(torch.equal(a, b))
    return dict(max_abs_err=worst, logits_rel_norm=rel, out_of_tol=bad,
                bit_equal=equal)


def serve_mesh_phase(card: str, arch: str, cfg, params, spec: dict,
                     phase: str, per_shard: dict, one_by_one: bool = False
                     ) -> dict:
    """One of phases 45-47: ``serve_mesh_run`` on a (2, 2) ("data",
    "model") mesh, held to the same steps on one device over each data
    shard's rows (the same products, row for row) within LM_TOL, every
    kernel of ``per_shard`` launched that many times a data shard in the
    prefill and none in the decode steps; the same steps on one device
    over the whole batch beside it, as a reading (in bfloat16 a product
    over fewer rows may sum in another order); with ``one_by_one`` a
    (1, 1) mesh bit-equal to one device.  Returns the mesh run's
    launches."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import cost_cell
    from repro_torch.launch.steps import data_shards
    whole = serve_mesh_run(cfg, params, None, spec)
    torch.cuda.empty_cache()
    mesh = card_mesh((2, 2), ("data", "model"))
    run = serve_mesh_run(cfg, params, mesh, spec)
    torch.cuda.empty_cache()
    b, s, n_dec = spec["batch"], spec["prompt"], spec["n_dec"]
    shards = [(lo, hi) for _, lo, hi in data_shards(mesh, b)]
    cmp, ref_launches = [], []
    for lo, hi in shards:
        part = whole if (lo, hi) == (0, b) else serve_mesh_run(
            cfg, params, None, spec, (lo, hi))
        cmp.append(serve_mesh_compare(run, part, (lo, hi)))
        ref_launches.append(part["launches"])
        del part
        torch.cuda.empty_cache()
    held = dict(max_abs_err={k: max(c["max_abs_err"][k] for c in cmp)
                             for k in ("logits", "cache")},
                out_of_tol=sum(c["out_of_tol"] for c in cmp),
                bit_equal=all(c["bit_equal"] for c in cmp))
    reading = serve_mesh_compare(run, whole)
    # two prefills a run (serve_mesh_run), each once a data shard
    want = {k: 2 * len(shards) * v for k, v in per_shard.items()}
    ok = held["out_of_tol"] == 0 \
        and {k: run["launches"][k] for k in want} == want \
        and all({k: r[k] for k in per_shard} == {
            k: 2 * v for k, v in per_shard.items()} for r in ref_launches) \
        and not any(n for k, n in run["launches"].items() if k not in want)
    bit = None
    if one_by_one:
        unit = serve_mesh_run(cfg, params, card_mesh((1, 1),
                                                     ("data", "model")), spec)
        bit = serve_mesh_compare(unit, whole)
        ok &= bit["bit_equal"]
        del unit
    # the dry run's per-device bytes for the same shapes, as a reading
    dry = {kind: cost_cell(cfg, ShapeConfig(phase, kind, seq, b), mesh)[
        "memory"] for kind, seq in (("prefill", s), ("decode", s + n_dec))}
    emit(phase="main_path", case=f"{arch} sharded prefill and decode on a "
         f"(2, 2) mesh, batch {b} x {s}, {n_dec} steps, against one device",
         serve_phase=phase, arch=arch, mesh=[str(d) for d in
                                             mesh.devices.flat],
         data_shards=shards, sharded_cache_leaves=run["n_sharded"],
         against_same_rows=held, tol=LM_TOL,
         against_whole_batch_reading=reading, one_by_one=bit,
         launches=run["launches"], one_device_launches=whole["launches"],
         first_prefill_s=run["first_prefill_s"], prefill_s=run["prefill_s"],
         one_device_first_prefill_s=whole["first_prefill_s"],
         one_device_prefill_s=whole["prefill_s"],
         step_s_p50=float(np.median(run["step_s"])),
         one_device_step_s_p50=float(np.median(whole["step_s"])),
         max_memory_allocated_bytes=run["peak"],
         one_device_max_memory_allocated_bytes=whole["peak"],
         dryrun_per_device={k: {"argument_bytes": v["argument_bytes"],
                                "temp_bytes": v["temp_bytes"]}
                            for k, v in dry.items()}, ok=ok, card=card)
    check(ok, f"{arch} sharded serving ({phase}): {held}, launches "
          f"{run['launches']} / {ref_launches}, (1, 1) {bit}")
    return run["launches"]


def serve_mesh() -> int:
    """Phases 45-47 in a child process of their own (``--serve-mesh``),
    started early, waiting for its turn (``wait_for_turn``) after the
    ``--train-mesh`` child.  The last row gathers the launches of each
    phase."""
    import torch
    from repro_torch.configs import get_config
    wait_for_turn("flash_attention", "rwkv6_scan")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    plain = count_plain_calls()
    dev = torch.device(mesh_devices(1)[0])
    launches = {}
    for phase, arch, kernel in (("45", QWEN3, "flash_attention"),
                                ("46", RWKV6, "rwkv6")):
        cfg = get_config(arch)
        params = init_model(arch, cfg, SERVE_MESH[arch]["seed"], dev)
        launches[f"{arch} sharded serving on a (2, 2) mesh"] = \
            serve_mesh_phase(card, arch, cfg, params, SERVE_MESH[arch],
                             phase, {kernel: cfg.n_layers})
        if arch == QWEN3:
            launches[f"{QWEN3} batch-1 serving on a (2, 2) mesh"] = \
                serve_mesh_phase(card, QWEN3, cfg, params, SERVE_MESH_LONG,
                                 "47", {kernel: cfg.n_layers},
                                 one_by_one=True)
        del params
        torch.cuda.empty_cache()
    check(not any(plain.values()), f"plain versions ran: {plain}")
    emit(phase="serve_mesh_launches", launches=launches, plain_calls=plain)
    return 0


def result_arrays(result) -> list:
    """Every array an op's result holds (a CSR as dense, a tensor on the
    host), in order; plans are not values."""
    import torch
    from repro_torch.core import CSR
    if isinstance(result, CSR):
        return [result.to_dense()]
    if torch.is_tensor(result):
        return [result.detach().cpu().numpy()]
    if isinstance(result, np.ndarray):
        return [result]
    if isinstance(result, (tuple, list)):
        return [a for r in result for a in result_arrays(r)]
    return []


def analysis_phase(card: str) -> None:
    """48. analysis on the card: the port's reaplint and purity replay in a
    child (``python -m repro_torch.analysis --check src/repro_torch
    --purity``, device ``cuda``), then, for each op of ``builtin_examples``,
    its plan built under ``device="cuda"`` and ``"cpu"`` (fingerprint and
    serialized payload bit-identical) and the op run cold, then warm,
    through one ``ReapRuntime(device="cuda")`` against the same op on the
    host."""
    from repro_torch.analysis.op_examples import builtin_examples
    from repro_torch.analysis.purity_check import (_payload_diff,
                                                   _plan_payload)
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.flash_attention import block_sparse_attention
    from repro_torch.runtime import ReapRuntime, RuntimeConfig
    from repro_torch.runtime import ops as _ops
    t0 = time.perf_counter()
    summary = ROOT / "build" / "reaplint_summary.json"
    summary.parent.mkdir(parents=True, exist_ok=True)
    summary.unlink(missing_ok=True)
    lint = start_child(["-m", "repro_torch.analysis", "--check",
                        "src/repro_torch", "--purity", "--summary",
                        str(summary)])
    examples = builtin_examples()
    concrete = [t for t in _ops.list_ops() if _ops.get_op(t).route is None]
    check(sorted(examples) == sorted(concrete),
          f"op_examples covers {sorted(examples)}, the registry {concrete}")
    counters = {"K1": bsr_spgemm, "K2": bsr_spmm,
                "K3": block_sparse_attention}
    for tag in concrete:
        ex = examples[tag]
        spec = _ops.get_op(tag)
        plans = {dev: _plan_payload(spec, ex.operands(0), RuntimeConfig(
            n_chunks=1, overlap=False, device=dev, **ex.runtime_kw), ex.kw)
            for dev in ("cuda", "cpu")}
        same_fp = plans["cuda"][0] == plans["cpu"][0]
        diff = _payload_diff(plans["cuda"][1], plans["cpu"][1])
        operands = ex.operands(2)
        want, _ = ReapRuntime(device="cpu", **ex.runtime_kw).run(
            tag, *operands, **ex.kw)
        want = result_arrays(want)
        rt = ReapRuntime(device="cuda", **ex.runtime_kw)
        before = {k: c.launches for k, c in counters.items()}
        row = dict(phase="analysis", op=tag, fingerprint=plans["cpu"][0].digest,
                   payload_keys=len(plans["cpu"][1]),
                   card_plan_equals_host=same_fp and diff is None)
        for label in ("cold", "warm"):
            (got, st), wall = timed(lambda: rt.run(tag, *operands, **ex.kw))
            got = result_arrays(got)
            ok = len(got) == len(want) and len(got) > 0 and all(
                g.shape == w.shape and np.allclose(
                    g, w, rtol=ANALYSIS_TOL, atol=ANALYSIS_TOL)
                for g, w in zip(got, want))
            err = max(float(np.abs(np.asarray(g, np.float64) - w).max(
                initial=0.0)) for g, w in zip(got, want)) if ok else None
            row.update({f"{label}_s": wall, f"{label}_cache_hit":
                        bool(st["cache_hit"]), f"{label}_max_abs_err": err,
                        f"{label}_ok": ok})
        row["launches"] = {k: c.launches - before[k]
                           for k, c in counters.items()
                           if c.launches != before[k]}
        row["tol"] = ANALYSIS_TOL
        emit(**row)
        check(same_fp, f"{tag}: the card-built fingerprint differs")
        check(diff is None, f"{tag}: card-built plan differs: {diff}")
        check(not row["cold_cache_hit"] and row["warm_cache_hit"],
              f"{tag}: cold {row['cold_cache_hit']}, warm "
              f"{row['warm_cache_hit']} (want a miss, then a hit)")
        check(row["cold_ok"] and row["warm_ok"],
              f"{tag}: the card's result disagrees with the host's")
    out, lint_s = finish_child(lint, "python -m repro_torch.analysis "
                               "--purity", timeout=300)
    sys.stdout.write(out)
    result = json.loads(summary.read_text())
    passes = [line for line in out.splitlines()
              if line.startswith("reaplint purity:")]
    check(len(passes) == len(_ops.list_ops())
          and all(line.endswith(": PASS") for line in passes),
          "the purity replay on the card did not pass for every op")
    emit(phase="analysis_done", ops=concrete, lint_child_s=lint_s,
         total_violations=result["total_violations"],
         total_suppressions=result["total_suppressions"],
         per_rule=result["per_rule"], purity=result["purity"],
         seconds=time.perf_counter() - t0, card=card)
    check(result["ok"] and result["total_violations"] == 0,
          "reaplint reports violations in src/repro_torch")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.core import CSR, cholesky_baseline_numpy, random_spd_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spgemm import (bsr_spgemm,
                                                bsr_spgemm_plain,
                                                bsr_spgemm_schedule)
    from repro_torch.runtime import ReapRuntime

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    kernels = KERNEL_SOURCES + BACKWARD_SOURCES
    t0 = time.perf_counter()
    _build.build(*kernels)
    emit(phase="build", kernels=list(kernels),
         seconds=time.perf_counter() - t0)
    for name in kernels:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas [{name}]:", line.strip())

    # -- 3. kernel against plain -------------------------------------------
    t0 = time.perf_counter()
    fa = table1_csr(FILTER3D, 0)
    cage = table1_csr(CAGE12, 1)
    _, rows, nnz, _ = PRE_POISSON
    spd = random_spd_csr(rows, nnz / (rows * float(rows)),
                         np.random.default_rng(2), "banded")
    emit(phase="generate", seconds=time.perf_counter() - t0,
         filter3D_nnz=fa.nnz, cage12_nnz=cage.nnz, pre_poisson_nnz=spd.nnz)

    cases, plan, ch = k1_cases(fa, dev)
    errs = [compare(label, bsr_spgemm_schedule(sched, a, b, n_out_blocks=n),
                    bsr_spgemm_plain(a, b, *ids, n_out_blocks=n), K1_TOL)
            for label, (sched, a, b, n, ids) in cases.items()]
    (k1_sched, a_blocks, b_blocks, n_out, plan_ids), \
        (sched, ca, cb, n_cap, _), _ = cases.values()
    torch.cuda.synchronize()

    # -- 4. main path -------------------------------------------------------
    calls = []

    def call(case, fn, launches_before):
        uploads = bsr_spgemm.uploads
        out, wall = timed(fn)
        stats = out[-1]
        row = dict(phase="main_path", case=case, call_s=wall,
                   k1_launches=bsr_spgemm.launches - launches_before,
                   k1_schedule_uploads=bsr_spgemm.uploads - uploads,
                   **{k: stats.get(k) for k in (
                       "method", "cache_hit", "inspect_s", "plan_s",
                       "execute_s", "wall_s", "hidden_s", "n_chunks",
                       "overlap") if stats.get(k) is not None})
        emit(**row)
        calls.append(row)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bsr_spgemm.launches = 0
    rt = ReapRuntime(device="cuda")

    n0 = bsr_spgemm.launches
    c, st = call("filter3D A@A auto, cold", lambda: rt.spgemm(fa, fa), n0)
    check(st["method"] == "block_chunked", f"route {st['method']}")
    check(bsr_spgemm.launches > n0, "K1 did not launch on the chunked path")
    ref_fa, ref_fa_s = numpy_ref(fa)
    check_spgemm("filter3D block_chunked", c, ref_fa, ref_fa_s)

    fa2 = CSR(fa.n_rows, fa.n_cols, fa.indptr, fa.indices,
              np.random.default_rng(10).standard_normal(fa.nnz)
              .astype(np.float32))
    n0 = bsr_spgemm.launches
    c, st = call("filter3D A@A auto, fresh values (warm)",
                 lambda: rt.spgemm(fa2, fa2), n0)
    check(st["cache_hit"] is True, "same pattern missed the plan cache")
    check(calls[-1]["k1_schedule_uploads"] == 0,
          "a warm chunked call uploaded a K1 schedule")
    check_spgemm("filter3D block_chunked warm", c, *numpy_ref(fa2))

    cage_runs = {}
    for label in ("cold", "warm"):
        c, st = call(f"cage12 A@A auto, {label}",
                     lambda: rt.spgemm(cage, cage), bsr_spgemm.launches)
        check(st["method"] == "gather_chunked", f"route {st['method']}")
        cage_runs[label] = c
    cage_ref = numpy_ref(cage)
    check_spgemm("cage12 gather_chunked", c, *cage_ref)

    rt_sync = ReapRuntime(device="cuda", n_chunks=1, overlap=False)
    for label in ("cold", "warm"):
        n0 = bsr_spgemm.launches
        c, st = call(f"filter3D A@A sync block path, {label}",
                     lambda: rt_sync.spgemm(fa, fa), n0)
        check(st["method"] == "block", f"route {st['method']}")
        check(bsr_spgemm.launches > n0, "K1 did not launch on the sync path")
        check(label == "cold" or calls[-1]["k1_schedule_uploads"] == 0,
              "a warm sync call uploaded a K1 schedule")
    check_spgemm("filter3D block sync", c, ref_fa, ref_fa_s)

    for label, overlap in (("overlapped, cold", True), ("sync, warm", False)):
        chol_plan, vals, st = call(
            f"Pre_poisson Cholesky fp64 {label}",
            functools.partial(rt.cholesky, spd, dtype=torch.float64,
                              overlap=overlap), bsr_spgemm.launches)
        check(st["cache_hit"] is (not overlap), "Cholesky cache accounting")
        base, base_s = cholesky_baseline_numpy(chol_plan,
                                               chol_plan.a_values(spd))
        resid = chol_residual(chol_plan, vals, spd)
        ok = bool(np.allclose(vals, base, rtol=1e-10, atol=1e-12)
                  and resid <= CHOL_RESIDUAL)
        emit(phase="check", case=f"Pre_poisson Cholesky {label}",
             n_levels=chol_plan.n_levels, nnz_l=chol_plan.nnz,
             residual=resid,
             max_abs_err_vs_baseline=float(np.abs(vals - base).max()),
             numpy_baseline_s=base_s, ok=ok)
        check(ok, f"Cholesky ({label}) disagrees with the baseline")

    torch.cuda.synchronize()
    main_launches = bsr_spgemm.launches
    peak = torch.cuda.max_memory_allocated()
    emit(phase="main_path_done", k1_launches=main_launches,
         max_memory_allocated_bytes=peak)

    # device busy share of warm calls (after the count is read: the
    # profiled calls launch K1 again)
    device_share("filter3D A@A chunked, warm", lambda: rt.spgemm(fa2, fa2))
    device_share("filter3D A@A sync, warm", lambda: rt_sync.spgemm(fa, fa))
    device_share("cage12 A@A chunked, warm", lambda: rt.spgemm(cage, cage))

    # -- 5. times at the filter3D sync-plan shapes -------------------------
    uploads = bsr_spgemm.uploads
    k1_ms = event_ms(lambda: bsr_spgemm_schedule(
        k1_sched, a_blocks, b_blocks, n_out_blocks=n_out))
    uploads = bsr_spgemm.uploads - uploads
    plain_ms = event_ms(lambda: bsr_spgemm_plain(
        a_blocks, b_blocks, *plan_ids, n_out_blocks=n_out))

    def library():
        prods = torch.bmm(a_blocks[plan_ids[0]], b_blocks[plan_ids[1]])
        return a_blocks.new_zeros((n_out, 128, 128)).index_add_(
            0, plan_ids[2], prods)

    library_ms = event_ms(library)
    flop = 2 * plan.n_pairs * 128 ** 3
    nbytes = (a_blocks.numel() + b_blocks.numel() + n_out * 128 * 128) * 4 \
        + k1_sched.ids.nbytes
    # the design's bound, 3xTF32: three TF32 tensor-core products per
    # product; beside it the bound of one fp32 FMA per product
    bound_ms, bound_by = bound(3 * flop, nbytes, TF32_FLOPS)
    fma_bound_ms, _ = bound(flop, nbytes)
    emit(phase="times", kernel="K1", case="filter3D sync plan",
         n_pairs=plan.n_pairs, n_out_blocks=n_out, flop=flop, bytes=nbytes,
         k1_ms=k1_ms, plain_ms=plain_ms, library_ms=library_ms,
         library="torch.bmm + index_add_", k1_tflops=flop / k1_ms / 1e9,
         bound_ms=bound_ms, bound_by=bound_by,
         bound_fp32_fma_ms=fma_bound_ms, carry_depth=K1_CARRY_DEPTH,
         warm_schedule_uploads=uploads, card=card)
    check(uploads == 0, "K1's timed calls uploaded their schedule")
    # the chunk path hands K1 the live pairs only; the bucketed schedule's
    # dead tail is one group that a single thread block would run alone
    emit(phase="times", case=f"filter3D chunk 1, {ch.n_pairs} live pairs",
         k1_bucketed_ms=event_ms(lambda: bsr_spgemm_schedule(
             sched, ca, cb, n_out_blocks=n_cap)),
         k1_live_pairs_ms=event_ms(lambda: bsr_spgemm_schedule(
             sched["k1"], ca, cb, n_out_blocks=n_cap)),
         dead_pairs=sched["pair_cap"] - ch.n_pairs, card=card)
    k1_row = {
        "name": "bsr_spgemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bsr_spgemm.cu",
        "replaces": "src/repro/kernels/bsr_spgemm.py:41",
        "launches": main_launches, "max_abs_err": max(errs),
        "ms": k1_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}
    del a_blocks, b_blocks, ca, cb, cases
    torch.cuda.empty_cache()

    k2_row = spmm_solver_phases(fa, spd, card)
    k3_row = attention_phases(card)
    # phase 25's first child builds K1-K6 into a fresh kernel-library store
    # (nvcc on the host, no kernel on the card) while phases 9-23 run: their
    # times are CUDA events or the card's, their host work light
    import shutil
    for d in (STORE_DIR, STORE_DIR_CORRUPT, SERVE_STORE_DIR):
        shutil.rmtree(d, ignore_errors=True)
    store_build = start_child([str(Path(__file__).resolve()), "--store-child",
                               str(STORE_DIR), "--no-checks"])
    k5_row = moe_phases(card)
    check_digests("K5", K5_DIGESTS, card)
    torch.cuda.empty_cache()

    # -- 12.-15. the LM stack: hymba-1.5b, K4 and K6 -----------------------
    k4_err, k6_err = k4_k6_against_plain(dev)
    check_digests("K4", K4_DIGESTS, card)
    hymba_in_situ(dev)
    torch.cuda.empty_cache()
    k4_launches, k6_launches = hymba_serving(dev, card)
    torch.cuda.empty_cache()
    k4_times, k6_times = hymba_kernel_times(dev, card)
    torch.cuda.empty_cache()

    # -- 16.-20. rwkv6-1.6b (K6) and dbrx-132b's in-graph MoE (K5) ---------
    k6_rwkv_launches, k6_rwkv_err, k6_rwkv_times = rwkv_phases(dev, card)
    torch.cuda.empty_cache()
    dbrx = dbrx_phases(dev, card)
    torch.cuda.empty_cache()

    # -- 22.-23. paligemma-3b (image prefixes) and whisper-small (enc-dec) --
    pali = paligemma_phases(dev, card)
    torch.cuda.empty_cache()
    whisper = whisper_phases(dev, card)
    torch.cuda.empty_cache()

    # -- 27.-31. training: K4's backward, qwen3-1.7b on the card -----------
    # phase 31's first runs write a checkpoint here; the processes resuming
    # from it run beside phases 27 and 28 and the start of phase 29's child
    # (phase 30's timings wait until after that child)
    for arch in TRAIN_CLI_ARCHS:
        shutil.rmtree(ROOT / "build" / f"train_cli_{arch}",
                      ignore_errors=True)
    train_first = {arch: train_cli_in_process(arch, 3, "first", True)
                   for arch in TRAIN_CLI_ARCHS}
    train_resumed = {arch: start_child(["-m", "repro_torch.launch.train",
                                        *train_cli_args(arch, 6, "resumed",
                                                        True)])
                     for arch in TRAIN_CLI_ARCHS}
    # phases 29 and 34's full-width train CLIs and the profiles after phase
    # 26, each a child that sets up now and waits for its turn
    script = str(Path(__file__).resolve())
    train_children = {arch: start_child(
        [script, "--train-full", arch], stdin=subprocess.PIPE)
        for arch in TRAIN_FULL}
    mesh_child = start_child([script, "--train-mesh"], stdin=subprocess.PIPE)
    serve_child = start_child([script, "--serve-mesh"], stdin=subprocess.PIPE)
    profile_children = {args: start_child(
        [script, *args], stdin=subprocess.PIPE) for args in (
            ("--profile-second-slice",), ("--profile-lm", HYMBA),
            ("--profile-lm", RWKV6), ("--profile-lm", DBRX_LM))}
    k4_bwd_err = k4_backward_against_plain(dev)
    torch.cuda.empty_cache()
    train_in_situ(dev, QWEN3)
    torch.cuda.empty_cache()
    full = {}

    def train_full_child(arch):
        out = go_child(train_children[arch], f"train CLI {arch} at full "
                       "width", timeout=900)
        sys.stdout.write(out)
        full[arch] = child_rows(out, "main_path")[-1]

    train_full_child(QWEN3)
    train_cli_phase(train_first, train_resumed, card)
    k4_bwd_times = k4_backward_times(dev, card)
    torch.cuda.empty_cache()

    # -- 32.-35. training: K6's backward, rwkv6-1.6b and hymba-1.5b --------
    k6_bwd_err, k4_bwd_hymba_err = k6_backward_against_plain(dev)
    torch.cuda.empty_cache()
    for arch in (RWKV6, HYMBA):
        train_in_situ(dev, arch)
        torch.cuda.empty_cache()
    for arch in (RWKV6, HYMBA):
        train_full_child(arch)
    k6_bwd_times = k6_backward_times(dev, card)
    torch.cuda.empty_cache()

    # -- 36.-39. training: K5's backward, dbrx-132b on the card ------------
    k5_bwd_err = k5_backward_against_plain(dev)
    torch.cuda.empty_cache()
    train_in_situ(dev, DBRX_LM, DBRX_TRAIN_SITU)
    torch.cuda.empty_cache()
    # phase 38's child holds 54 GB of training state: the card is its alone
    emit(phase="check", case="main process's device memory before the "
         "dbrx-132b train child", allocated_bytes=torch.cuda.memory_allocated(),
         reserved_bytes=torch.cuda.memory_reserved())
    train_full_child(DBRX_LM)
    # -- 40.-44. sharded training, in a child with the card to itself ------
    out = go_child(mesh_child, "sharded training", timeout=900)
    sys.stdout.write(out)
    mesh_launches = child_rows(out, "mesh_launches")[-1]["launches"]
    # -- 45.-47. sharded serving, in a child with the card to itself -------
    out = go_child(serve_child, "sharded serving", timeout=600)
    sys.stdout.write(out)
    serve_launches = child_rows(out, "serve_mesh_launches")[-1]["launches"]
    k5_bwd_times = k5_backward_times(dev, card)
    torch.cuda.empty_cache()
    # phase 26's first CLI run (a cold store: its prewarm builds K4 and K6)
    # runs beside phase 21's CLIs
    cold_cli = start_child(serve_store_args())
    serve_cli(card)

    # -- 24.-26. sharding, the kernel-library store, serving with it --------
    shard = sharding_phases(fa, cage, cage_ref, cage_runs, card)
    del cage_runs
    torch.cuda.empty_cache()
    store_phases(store_build, cold_cli, card)
    prewarm = serve_prewarm(dev, card)
    torch.cuda.empty_cache()
    k2_row.update(launches=k2_row["launches"] + shard["k2_launches"],
                  launches_by_path={"spmm/spmv/CG": k2_row["launches"],
                                    "sharded spmm": shard["k2_launches"]},
                  sharded_one_shard=shard["k2_shard_ms"])
    k4_by_path = {HYMBA: k4_launches, DBRX_LM: dbrx["launches"]["K4"],
                  PALIGEMMA: pali["launches"], WHISPER: whisper["launches"],
                  "hymba-1.5b with prewarm": prewarm["K4"],
                  **{f"{arch} training": full[arch]["launches"][
                      "flash_attention"] for arch in (QWEN3, HYMBA,
                                                      DBRX_LM)},
                  **{path: n["flash_attention"]
                     for path, n in mesh_launches.items()},
                  **{path: n["flash_attention"]
                     for path, n in serve_launches.items()
                     if n["flash_attention"]}}
    k4_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:116",
        "launches": sum(k4_by_path.values()),
        "launches_by_path": k4_by_path,
        "max_abs_err": max(k4_err, dbrx["k4_err"], pali["k4_err"],
                           whisper["k4_err"]), **k4_times,
        "dbrx_132b_prefill": dbrx["k4_times"],
        "paligemma_3b_image_prefill": pali["k4_times"],
        "whisper_small_encoder": whisper["k4_times"]}
    # the training paths' launches (phases 29 and 34), kernel -> path -> N
    by_path = {name: {f"{arch} training": row["launches"][name]
                      for arch, row in full.items() if row["launches"][name]}
               for name in ("flash_attention_bwd", "rwkv6", "rwkv6_bwd",
                            "moe_gemm_bwd")}
    # and the sharded paths' (phases 40, 41 and 44)
    for path, counts in mesh_launches.items():
        for name, paths in by_path.items():
            if counts[name]:
                paths[path] = counts[name]
    k4_bwd_row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:67",
        "replaces_what": "the XLA autodiff of flash_attention_jnp (the "
                         "reference has no backward Pallas kernel)",
        "launches": sum(by_path["flash_attention_bwd"].values()),
        "launches_by_path": by_path["flash_attention_bwd"],
        "max_abs_err": max(k4_bwd_err, k4_bwd_hymba_err),
        **k4_bwd_times[f"{QWEN3} training"],
        "qwen3_1p7b_s2048": k4_bwd_times[f"{QWEN3} S=2048"]}
    k6_by_path = {HYMBA: k6_launches, RWKV6: k6_rwkv_launches,
                  "hymba-1.5b with prewarm": prewarm["K6"],
                  **by_path["rwkv6"],
                  **{path: n["rwkv6"] for path, n in serve_launches.items()
                     if n["rwkv6"]}}
    k6_row = {
        "name": "rwkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:67",
        "launches": sum(k6_by_path.values()),
        "launches_by_path": k6_by_path,
        "max_abs_err": max(k6_err, k6_rwkv_err), **k6_times,
        "rwkv6_1p6b_prefill": k6_rwkv_times}
    gate, down = k5_bwd_times
    k5_bwd_row = {
        "name": "moe_gemm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm_bwd.cu",
        "replaces": "src/repro/models/moe.py:313",
        "replaces_what": "the XLA autodiff of the in-graph expert einsums "
                         "(models/moe.py:313-317; expert_swiglu :203-212); "
                         "the reference has no backward Pallas kernel",
        "launches": sum(by_path["moe_gemm_bwd"].values()),
        "launches_by_path": by_path["moe_gemm_bwd"],
        "max_abs_err": k5_bwd_err, **k5_bwd_times[gate],
        "dbrx_132b_down": k5_bwd_times[down]}
    hymba_heads, rwkv_heads = K6_BWD_HEADS
    k6_bwd_row = {
        "name": "rwkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:17",
        "replaces_what": "the XLA autodiff of rwkv6_chunked_jnp (the "
                         "reference has no backward Pallas kernel)",
        "launches": sum(by_path["rwkv6_bwd"].values()),
        "launches_by_path": by_path["rwkv6_bwd"],
        "max_abs_err": k6_bwd_err, **k6_bwd_times[rwkv_heads],
        "hymba_1p5b_training": k6_bwd_times[hymba_heads]}
    k5_lm_launches = dbrx["launches"]["K5"]
    k5_train_launches = full[DBRX_LM]["launches"]["moe_gemm"]
    k5_mesh = {path: n["moe_gemm"] for path, n in mesh_launches.items()
               if n["moe_gemm"]}
    k5_row.update(launches=k5_row["launches"] + k5_lm_launches
                  + k5_train_launches + sum(k5_mesh.values()),
                  launches_by_path={"moe_ffn_host": k5_row["launches"],
                                    DBRX_LM: k5_lm_launches,
                                    f"{DBRX_LM} training": k5_train_launches,
                                    **k5_mesh},
                  bf16_design=K5_BF16_DESIGN,
                  bf16_routes_on_main_path=dbrx["k5_routes"],
                  max_abs_err=max(k5_row["max_abs_err"], dbrx["k5_err"]),
                  **dbrx["k5_times"])
    sys.stdout.flush()
    for args, started in profile_children.items():
        sys.stdout.write(go_child(started, " ".join(args)))
    # last: after this session (12,000 levels of small launches) later
    # profiler sessions in the same process recorded no device event
    device_share("Pre_poisson Cholesky overlapped, warm",
                 lambda: rt.cholesky(spd, dtype=torch.float64))
    # -- 48. the analysis package on the card ------------------------------
    analysis_phase(card)
    emit(phase="script", seconds=time.perf_counter() - T_START, card=card)
    print(json.dumps({"kernels": [k1_row, k2_row, k3_row, k4_row,
                                  k4_bwd_row, k5_row, k5_bwd_row, k6_row,
                                  k6_bwd_row]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    ARGS = sys.argv[1:]
    if ARGS == ["--profile-second-slice"]:
        sys.exit(profile_second_slice())
    if ARGS[:1] == ["--profile-lm"] and len(ARGS) == 2:
        sys.exit(profile_lm(ARGS[1]))
    if ARGS == ["--train-mesh"]:
        sys.exit(train_mesh())
    if ARGS == ["--serve-mesh"]:
        sys.exit(serve_mesh())
    if ARGS[:1] == ["--train-full"] and len(ARGS) in (1, 2):
        sys.exit(train_full(*ARGS[1:]))
    if sys.argv[1:2] == ["--store-child"] and len(sys.argv) in (3, 4):
        sys.exit(store_child(sys.argv[2], sys.argv[3:] != ["--no-checks"]))
    CONTROL_READINGS = ARGS == ["--control-readings"]
    try:
        sys.exit(main())
    finally:
        for proc in CHILDREN:       # stop every child a failed phase left
            proc.kill()
