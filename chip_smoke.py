#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

  1. the card's name and power limit (``nvidia-smi``);
  2. builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all at once);
  3. holds each kernel against its plain PyTorch version at the main
     path's shapes, with the stated tolerance, and times the kernel, the
     plain version and one PyTorch library call computing the same
     function (a yardstick only), beside the bound computed from the
     bytes and flops of these inputs: paged attention (T = 1, 4 and 32
     over 8 ragged rows, the last 64 query rows per KV head, T = 64 --
     a step of chunked prefill at width 64, its split scratch printed --
     and T = 1 over one 1000-token row; each call's split into chunks
     printed; the
     kernels each (dtype, mode) ran, by their names in a profiler trace:
     bf16 on the tensor cores in every mode, base2 and pwl after a row-max
     pre-pass; in every mode a row's output bitwise equal alone and beside
     a 1000-token row, at T = 1 and in every column of T = 8 with its
     position repeated, and every column of a T = 64 chunk window equal
     to its query at T = 1), head dim 192 (paged
     attention at T = 1 and 32 in every mode, flash attention over 512
     tokens), the argmax head (B 1, 8 and 64; the pass-1 kernel each
     dtype ran, by its name in a profiler trace: bf16 on the tensor-core
     tile), the top-k head
     (planted ties across vocabulary splits; its two passes timed apart
     from a profiler trace at k 8 and 64; k 64 bitwise equal to
     ``ref.topk_select`` on exact integer logits), the speculative verify
     head (ragged -1 padded drafts; B 8 at T 2, 8 and 32, B 1 at T 32), a
     row's head result bitwise equal alone, in B 8 and B 64 and in the
     verify head at T 8 and 32, the three heads at nemotron-4-340b's
     width (D 18432, V 256000), flash attention (prompts of 71 and
     512 tokens, g 2 and 8, causal and windowed) and the softmax unit's
     stats, softmax and cross-entropy kernels ((12, 151936) f32,
     (512, 151936) bf16 and, stats and cross-entropy, (4096, 151936)
     bf16 rows -- one 4k-token training sequence -- and 70,000 rows of
     1,000 -- more than grid.y's 65,535; each call's plan and route and
     the device kernels it ran, from a profiler trace: one for
     softmax_stats and fused_xent at every B; stats and loss against
     their split models; an empty launch timed on the same ruler; a
     row's stats and probabilities bitwise equal alone, in B 12 and in B
     64, across both routes, and its loss alone and in B 12, 64 and
     4,096; the cross-entropy's backward at 4,096 bf16 rows within 4.0
     GB beyond its inputs); then paged attention's four exp-free
     score modes (base2, pseudo, pwl, maxonly) at the main path's shapes
     (T = 1 and 4, window None and 128), each timed beside exact (at T = 1
     each launch apart, from a profiler trace), base2, pseudo and pwl
     again at those shapes with each query's best key in its first
     visible 32-key slice, in f32 at rounding level and each mode's gap to
     exact as large as the plain version's, and base2 and pwl in f32 at
     those shapes with nothing pinned, at rounding level (base2 plus the
     effect of the LUT bins a score's rounding may flip).  The kernel
     flash attention ran per (dtype, head dim), by its name in a
     profiler trace, is printed (bf16 on the tensor cores), and two
     calls of each redesigned kernel (paged and flash attention) must
     give the same bits;
  4. drives the main path -- ``LLM.from_arch("qwen3-0.6b", smoke=False)``
     then ``LLM.generate``, greedy, at the model's full width with random
     seeded weights -- once inside ``step_graph.eager_steps()`` and then
     graphed three times (the decode step as one CUDA graph per shape
     bucket: a bucket's first step runs eagerly, its second captures;
     the third run replays every bucket), the four runs' tokens equal,
     and checks in each run that every prompt prefill layer went
     through the flash-attention kernel, every decode layer through the
     paged-attention kernel and every head through the argmax kernel
     (a replay adds its capture's launches to the counters); it prints
     the graph cache's captures, replays, capture ms and pool MB;
  4b. a mixed sampled workload on the same engine (greedy, top-k at
     temperature 0.8, ``n_candidates``, Gumbel-max temperature), eager
     and graphed with equal tokens: every top-k head call went through
     the top-k kernel, candidate ids are well formed, and the greedy
     rows keep the greedy-only tokens;
  4c. speculation on the same engine (repetitive prompts, ``spec_k=4``,
     plus one request at ``spec_k=20``): the tokens of ``spec_k=0``, and
     every step with a draft row went through the verify kernel, each
     run eager and graphed with equal tokens; spec_k=4 graphed three
     times, the third replaying every bucket, whose step must be faster
     than the eager one; then a profile of pure decode steps, eager and
     graphed (wall and device-busy ms per step, the busy share, kernels
     per step; paged attention's, the argmax head's and the f64 norm
     mean's device ms per step), which launch no flash kernel -- the
     graphed step must be the faster, and in both the traced
     paged-attention and argmax-head kernels must be twice the launches
     the counters add up (2 x 28 and 2 a step);
  4g. chunked prefill (``chunk_size=64`` on engines sharing the main
     path's weights, prefix sharing off): phase 4's prompts once eager
     and three times graphed (the third all replays; tokens equal), then
     at ``chunk_size=16`` and at 64 with ``token_budget=128``, then phase
     4b's mixed samplers and phase 4c's prompts at ``spec_k=4``; every
     run's chunk rows at their count, flash launches 0, paged launches
     28 x steps, each head kernel's launches its ``head_calls``, one step
     an iteration; its streams against the one-shot ones measured in
     bf16 and held in f32 (see below); tok/s, ms a step, TTFT and ITL
     (from emit stamps) and the graph cache's work printed beside phase
     4's one-shot numbers;
  4g'. the reference's heavy-tailed trace (``bench_serve.chunked_sweep``:
     32 prompts, Zipf 1.5 lengths 16-1024, 4 slots, 8 new tokens),
     one-shot against chunk 16 and 64, each twice graphed: short-class
     TTFT and ITL p99; gated on tokens (each engine's two runs equal,
     the three paths in f32);
  4h. prefix sharing on the reference's ``prefix_sweep`` trace (64
     requests opening with one 512-token system prompt, 16 cold; chunk
     32, block 16, 4 slots): off against on, each engine warmed on the
     same trace with another system prompt (prefill tokens >= 2x fewer,
     hits; tokens in f32), then ``spec_k=4`` and a 9-block pool (a
     sharer preempted, trie runs evicted) on a small shared trace, in
     f32; every copy-on-write (one forced on the trie's blocks) bitwise
     in every layer, K and V, its source untouched;
  4f. the step as one program: in four buckets (greedy B 8 T 1; Greedy
     + TopK + Temperature groups; the verify group at T 8; six decode
     rows, a mid-prefill chunk row and a final chunk row at T 64 on the
     chunk-64 engine) a replay of the bucket's graph gives the eager
     step's hidden states and head outputs bit for bit on the same
     operands; the greedy and the chunk bucket's replays timed beside
     their eager bodies and the step's bound; the
     Temperature head's memory beyond its inputs (<= 64 MB) and device
     ms beside the f32 copy of W it replaced;
  4d. the unit path: the f32 logits of the 12 prompts' final hidden
     states at V = 151936 through ``ops.softmax_stats``,
     ``ops.online_softmax`` and ``ops.softmax_xent`` forward and backward
     (labels: phase 4's first tokens), each against its plain version,
     each kernel's launches equal to its calls (every ``online_softmax``
     call also runs ``softmax_stats``' fold and merge, and counts in
     both; the backward calls ``online_softmax``), and Theorem 1 through
     the full unit:
     ``argmax(online_softmax)`` is phase 4's first token;
  4p. the paper's own experiments, ``python -m repro_torch.paper``'s
     ``main`` on the card: Table I's three regimes, Figs 2-3's
     monotonicity and the 10-class classifier trained 200 steps on the
     cross-entropy kernel, deployed through both units; every CSV line's
     flag true and the agreement 1.000, the softmax-unit kernel launched
     205 times (3 regimes, 2 Fig 3 cases, 200 backward passes) and the
     cross-entropy kernel 200; Table I's card rows against its CPU rows
     (x bitwise, s(x) within the unit tolerance);
  4e. the divergence probe (``repro_torch.probe.run_probe``, eager) on
     the 12 prompts, 32 new tokens: all five score modes at window None,
     then
     pseudo and maxonly at window 128, every decode layer of each arm
     through the paged-attention kernel in that arm's mode, and per-layer
     score errors from the tap;
  4i. the device-resident loop (``host_stride``) on engines sharing the
     main path's weights (no eos): phase 4's prompts greedy at
     ``host_stride`` None, 1, 4 and 8, mixed seeded samplers (greedy,
     top-k 4 at 0.8, Gumbel-max at 0.7) at 1, 4 and 8, and those samplers
     with chunk 64 (prompts of 129-192 tokens) at 1 and 8, each engine
     graphed three times (the third all replays): tokens EQUAL across
     runs and strides, paged attention 28 launches a decode iteration (a
     replay is one), each head kernel once an iteration per group; tok/s,
     ms a token, host syncs, tokens a dispatch, captures and replays for
     each stride; a stop pair and an eos inside a stride-8 block (the
     rest trimmed, every block back in the pool); the keyed draw at (8,
     151936) against ``prng`` on the CPU (keys, bits, uniforms bitwise;
     the Gumbel gap in ulps printed) and timed; a graphed dispatch
     bitwise against the eager loop on the same operands, both timed
     beside the bound; a profile of one dispatch beside phase 4's step;
  5. Theorem 1 on the card, graphed: the softmax-baseline head gives the
     same token streams;
  6. the small-input reference, graphed: the smoke config's tokens on
     the card equal those of the plain versions on the CPU, from the
     same weights.
  4j. (once every earlier engine is dropped) the rest of the dense
     family: kernels 1-5 at starcoder2-7b's shapes against their plain
     versions, each timed beside its bound and library call (paged
     attention at B 8, T 1 and 64, 36 query heads over 4 KV heads; flash
     attention over 512 tokens at g 9; the argmax head at B 8, the top-k
     head at B 4, k 8 and the verify head at B 8, T 8 on the untied (V,
     D) = (49,152, 4,608) head); then starcoder2-7b in bf16 at full
     width with SC_LAYERS (8) of its 32 layers (``weights.seeded_params``
     drawn in bf16, as ``LLM.from_arch`` draws it; d 4,608, gelu MLP, 8
     slots of 1,024): phase 4's prompts greedy eager and graphed three
     times (tokens equal; a paged launch a layer a decode step, a flash
     launch a layer a one-shot prefill, an argmax head a step and a
     prefill), the
     replayed step's ms beside the bound of reading its weights once,
     Theorem 1 against the softmax baseline, phase 4b's mixed samplers,
     ``spec_k=4`` and ``host_stride=8`` (tokens equal to None's), and the
     phase's peak memory; then qwen3-0.6b at full width with the dense
     layout and the cohort scheduler (paged / dense x fused / cohort),
     each graphed twice: no paged launch on the dense layout, more steps
     than iterations under cohort, streams held to paged fused's under
     the near-tie rule in f32 and measured in bf16.
  4k. (after 4j) tensor parallelism: first, in this process, qwen3's
     (151,936, 1,024) bf16 head split 2, 4 and 8 ways into contiguous
     slices (75,968, 37,984 and 18,992 ids), each slice's argmax (B 8),
     top-k (B 4, k 8) and verify (B 8, T 8) kernel against its plain
     version, the slices' (val, idx) tables merged with no collective
     bitwise equal to the unsharded kernels', slice 0's kernels timed
     beside the slice's bound; paged attention at a rank's heads (B 8,
     T 1: 8 / 4 and 4 / 2); then qwen3-0.6b at full width at tp 2 (12
     prompts) and tp 4 (the first 8), 2 and 4 processes of this script
     (``--tp-rank R --tp-world W --tp-dir D``) sharing the card over
     gloo, each waited on with a timeout -- an f32 greedy engine built
     by ``LLM.from_arch(tp=W, dtype="float32")`` in each rank, all 28
     layers on 2 prompts, held to ``LLM.from_arch(dtype="float32")``
     here, whose tree is the host draw the ranks cut, leaf for leaf --,
     then at 4 of the 28 layers (TP_LAYERS): f32 greedy, mixed samplers,
     spec_k 4 (drafts accepted), host_stride 8 and chunk 64 with prefix
     sharing held to the unsharded engine's streams (near-tie rule),
     bf16 greedy measured against it and timed beside tp 1 (no claim:
     host-staged gloo on one card), every rank's tokens equal, each
     rank's launches at its steps, no graph captured, the collective
     bytes of an 8-row decode step and of each head at B 8 (the
     comparator's under a quarter of one f32 logit sweep); then the
     control plane, in the same rank processes, in f32: at world 4
     ``Router(replicas=2, tp=2)`` (replica r the ranks [2r, 2r + 2)) on
     the 8 prompts, its tokens on every rank held to the unsharded
     engine's, both replicas served, the fleet's emitted tokens the sum
     of the replicas'; at world 2 ``LLM(tp=2)`` behind the HTTP server on
     rank 0 (rank 1 following its pump), the 12 prompts posted at once
     and one streamed, held to the unsharded engine's, rank 1 back from
     its follow loop at ``shutdown``; each rank's launches at its steps;
     and at world 2 phi3.5-moe at full width with 2 of its 32 layers in
     f32, each rank 8 of the 16 experts (``parallel.moe_ep``), greedy on
     phase 4n's 8 prompts at 16 new tokens, held to the unsharded f32
     engine on the same host tree, every rank's tokens equal.  Then the
     recurrent and vlm families: the argmax (B 8) and top-k (B 4, k 8)
     heads on rwkv6-7b's (65,536, 4,096) head split 2 and 4 ways and on
     recurrentgemma-2b's (256,000, 2,560) head split 2 ways, and flash
     attention at a tp 2 rank's heads of recurrentgemma-2b (T 2,150, 5 q
     heads over a copy of the one KV head, hd 256, window 2,048), each
     against its plain version and timed beside its bound and library
     call; and in the same rank processes rwkv6-7b at full width with 2
     of its 32 layers at tp 2 and 4, recurrentgemma-2b with one (rec,
     rec, attn) unit of its 26 at tp 2, 4 prompts at 16 new tokens: f32
     (greedy rows and a TopK row) held to the unsharded engine on the
     same host tree (near-tie rule), bf16 greedy timed beside the
     unsharded engine (eager) with a decode step's collective bytes by
     kind, each rank's channels and launches on its slice; and
     internvl2-26b's smoke config at tp 2, its tokens and its image
     prefix through ``lm.prefill`` (within 1e-4 of the unsharded prefill,
     the sharded head's ids equal); seamless-m4t-large-v2 at full width,
     2 + 2 layers, f32, at tp 2 through ``lm.prefill`` and 16 greedy
     ``lm.decode_step``s, the head on each rank's V / 2 slice (the
     unsharded run's tokens on the card, near-tie rule).  Then training
     on a (data, model) mesh (``launch.steps.make_mesh``), MESH_MODELS at
     full width, B 4 x S 1,024, lr 1e-3, 2 steps, FSDP at D 2 (each
     rank holds 1/D of every leaf the reference cuts over data, gathers
     a unit's weights in the unit and reduce-scatters their gradients):
     qwen3-0.6b (4 of 28 layers) and phi3.5-moe (1 of 32: expert
     parallelism, the router loss over the data group) at 1x2, 2x1 and
     2x2, rwkv6-7b (2 of 32)
     and recurrentgemma-2b (3 of 26, its kv head copied) at 1x2,
     internvl2-26b (1 of 48, its 92,553-id vocabulary whole on both
     ranks) at 1x2, seamless-m4t-large-v2 (2 + 2 of 24 + 24: the
     encoder's and the cross-attention's split, the encoder's output
     summed once) at 1x2 and 2x2.  In this process the mesh steps'
     kernels at their shapes (flash at each model's rank heads, B 4, T
     1,024, seamless's non-causal encoder and cross-attention too; the
     stats and softmax kernels on each 1x2 rank's 4,096-row f32
     vocabulary slice; the cross-entropy kernel on 2x1 ranks' 2,048 rows
     and on internvl2's 4,096 rows of its whole vocabulary; two slices'
     merged stats against the row's logsumexp, bitwise on repeat) and
     each model's 1x1 f32 run, its first-step gradients saved; then in
     the same rank processes, once every 1x1 run has left the card, the
     meshes of world 2 and world 4:
     f32 each step's loss and grad_norm, the first step's gradients slice
     by slice and the moe layer's kept choices held to the 1x1 run's,
     each rank's state bytes equal to the dry-run's (``segment_cost.
     train_cell``), bf16 timed with each step's collective bytes by kind
     (checked exactly, ``mesh_bytes_want``, and rank 0's against the
     dry-run's walk, ``segment_cost.train_step_walk``), its kernel
     launches (``mesh_launches_want``) and each rank's peak, phi3.5-moe
     2x2's summed reserved peak beside the replicated layout's; qwen3's
     2x2 whole
     checkpoint resumed at 1x1 here, its next loss the uninterrupted 2x2
     step's; ``pipeline_apply`` over the 4 ranks against its stages in
     sequence.
  4l. the hybrid RG-LRU family: flash attention at
     recurrentgemma-2b's prefill (T 2,150, 10 query heads over 1 KV head,
     hd 256, window 2,048; the ``mma.sync`` kernel, from a profiler
     trace taken in phase 3; within two bf16 steps, on random inputs and on inputs where
     the window decides the answer) and the argmax head at B 8 on its
     tied (256,000, 2,560) embedding, each against its plain version and
     timed beside its bound and library call; then recurrentgemma-2b in
     bf16 at full width with 5 of its 26 layers ((rec, rec, attn) +
     (rec, rec); ``weights.seeded_params``), 8 slots of 2,304 on the
     dense per-slot store:
     8 prompts (six of 1-1,000 tokens, two of 2,100-2,200: the ring
     wraps in prefill and again in decode) greedy at 64 new tokens,
     eager and graphed twice (the second all replays; tokens equal;
     flash 1 launch a prefill, no paged attention, an argmax head a
     step and a prefill), Theorem 1 against the softmax head, mixed
     samplers, ``spec_k`` refused, ``chunk_size`` and ``host_stride``
     warned off on one engine with the same tokens; an f32 twin from the same seed
     (``weights.seeded_params``; its bf16 cast must be the engine's tree
     bitwise) whose graphed ragged tokens equal a scalar replay
     (``lm.prefill`` + ``lm.decode_step``) and ``argmax(lm.forward)`` on
     every stream; the bf16 streams' share equal to the f32 twin's, each
     parting's step, f32 top-2 gap and bf16 logit error (measured);
     peak memory, the eager and replayed step beside the
     bound of reading every weight once, tok/s, and the TTFT of a
     2,150-token prompt with the plain RG-LRU scan's share.
  4m. the RWKV6 family: the argmax head at B 8 and the top-k head
     at B 4, k 8 on rwkv6-7b's untied (V, D) = (65,536, 4,096) head
     against their plain versions, timed beside their bound and library
     call; then rwkv6-7b in bf16 at full width with 4 of its 32 layers
     (``weights.seeded_params``; d 4,096, 64 heads of 64, d_ff 14,336,
     relu_sq channel mix, 8 slots of 1,088 per-slot states): 8 prompts
     of 3-1,024 tokens greedy at 64 new tokens, eager and graphed twice
     (tokens equal; no attention kernel, an argmax head a step and a
     prefill), Theorem 1, mixed samplers, ``spec_k`` refused,
     ``chunk_size`` and ``host_stride`` warned off with the same tokens;
     an f32 twin from the same seed held to a scalar replay and
     ``argmax(lm.forward)``; the bf16 streams against it (measured); the
     replayed step beside the weight-read bound, tok/s, and the TTFT of
     a 1,024-token prompt with the plain wkv scan's share.
  4n. (last, once every earlier engine is dropped) the MoE family:
     kernels 1, 5, 2 and 3 at phi3.5-moe's shapes (paged attention at B
     8, T 1 and flash attention over 512 tokens, 32 query heads over 8
     KV heads of 128; the argmax head at B 8 and the top-k head at B 4,
     k 8 on the untied (V, D) = (32,064, 4,096) head) against their plain
     versions, timed beside their bound and library call; then
     phi3.5-moe in bf16 at full width with 2 of its 32 layers (16
     experts of 6,400, top-2, capacity factor 1.25; f32 masters from
     ``weights.seeded_params`` on the card, 8 paged slots of 1,024):
     phase 4's first 8 prompts (ids mod 32,064) greedy at 64 new tokens,
     eager and graphed three times (tokens equal; 6 paged launches a
     decode step, 6 flash a prefill, an argmax head a step and a
     prefill, no verify), Theorem 1, mixed samplers (greedy rows
     measured against the greedy run: behind dropping routing a row's
     tokens follow its batch-mates'), ``spec_k`` refused, ``chunk_size``
     and ``host_stride`` warned off with the same tokens, the choices
     dropped per decode step (an eager run; at least one), the MoE
     layers' share of a profiled eager step, an f32 twin at 1.25 (the
     bf16 streams measured against it; one decode step's MoE layer on
     the card and on the CPU: the same kept choices, outputs within
     1e-4) and one at capacity factor 16 = E, which drops nothing, held
     to its scalar replay and ``argmax(lm.forward)``; the replayed step
     beside the bound of reading every weight once (15.87 GB), tok/s and
     the peak memory; then llama4-maverick's smoke config ((attn, moe)
     units, a shared expert, top-1) graphed == eager.
  4o. (last, once every earlier engine is dropped) training: (c) flash
     attention at B 2, T 4,096, 16 / 8 heads of 128, bf16, causal, and
     the cross-entropy, stats and softmax kernels on (8,192, 151,936)
     f32 logits (the step's loss and its backward's two-launch softmax),
     each against its plain version and timed beside its bound and
     library call, and the plain-recompute attention backward of a layer
     beside SDPA's; (a) ``train_loss`` and every gradient leaf on the
     card against the CPU's plain path for the qwen3-0.6b, phi3.5-moe,
     recurrentgemma-2b, rwkv6-7b, internvl2-26b and seamless-m4t-large-v2
     smoke configs in f32 (no leaf None, none zero where the CPU's is not;
     seamless's through the non-causal flash Function), and qwen3-0.6b's
     in bf16 under
     ``remat="dots"`` against the CPU's f32 (within twice the CPU's own
     bf16 error); (b) qwen3-0.6b at full width and
     full depth in bf16 with its remat, 8 AdamW steps at B 2 x S 4,096
     on the synthetic corpus (finite losses and norms, the last 5 below
     the first, flash 2 x 28 launches a step, the cross-entropy and the
     backward's softmax once), ms a step, tokens/s, the peak memory, the
     model-FLOP share and a profiled step's split; (d) the trained
     masters served, the comparator's tokens == the softmax baseline's;
     (e) a run resumed from a checkpoint on the card == an uninterrupted
     one.
  4s. (after 4o, host seconds only, no run on the card) the dry-run
     (``launch.dryrun.run_cell``, a walk of one rank's step on the
     ``meta`` device) at 4o's cell: its param and AdamW-state bytes equal
     4o's train state's exactly, and its predicted bytes a rank over 4o's
     peak lie within DRYRUN_PEAK_RATIO (else the run fails);
     ``segment_cost.model_flops`` against the old hand formula, its
     roofline bound against 4o's ms a step.
  4q. (after 4o, every earlier engine dropped) the vlm family: kernels 1,
     5, 2, 3 and the verify head at internvl2-26b's shapes (paged at B 8,
     T 1 and flash over 768 positions, 48 query heads over 8 KV heads of
     128; the argmax head at B 8, the top-k head at B 4, k 8 and the
     verify head at B 8 x T 5 on the untied (92,553, 6,144) head), each
     against its plain version and timed beside its bound and library
     call; then internvl2-26b in bf16 at full width, 6 of its 48 layers
     (VLM_LAYERS; drawn on the host in bf16 as ``LLM.from_arch`` draws
     them, no f32 master), 8 paged slots of 1,024: phase 4's first 8
     prompts (ids mod 92,553) greedy at 32 new tokens, eager and graphed
     three times (tokens equal; a paged launch a layer a decode step, a
     flash a layer a prefill, an argmax head a step and a prefill),
     Theorem 1, mixed samplers,
     ``spec_k=4`` and ``chunk_size=64`` (bf16 streams measured, launches
     gated); 256 stub image embeddings ahead of a 64-token prompt through
     ``lm.prefill`` at B 4 with 16 greedy decode steps on the dense cache
     (the streams differ from the same tokens without them; the argmax
     head equals ``argmax(logits_fn)`` but at a near-tie); the replayed
     step against the bound of reading the weights once, tok/s,
     the TTFT of a 512-token prompt, the peak memory and the host draw's
     seconds.
  4r. the enc-dec family: flash attention at seamless-m4t-large-v2's
     shapes (16 heads of 64, bf16, B 8: the encoder non-causal over T =
     S = 1,024 frames, the cross-attention non-causal over T 64 queries
     and S 1,024 keys, the decoder's causal prefill at T 64) against its
     plain version and SDPA, and the argmax head on the untied (256,206,
     1,024) head; then seamless in bf16 at full width, 6 + 6 of its 24
     + 24 layers (ED_LAYERS; f32 masters from ``weights.seeded_params``
     on the card, cast) through ``lm.prefill`` / ``lm.decode_step`` (no
     engine, as in the reference): B 8, 1,024 stub source frames,
     64-token prompts, 32 greedy decode steps on the dense cache (a
     flash launch an encoder layer and two a decoder layer a prefill,
     none a step; an argmax head a step), Theorem 1, an f32
     twin held to ``argmax(lm.forward)`` (near-tie rule) with the bf16
     rows' partings from it measured, the smoke config's f32 hidden
     states card vs CPU; ms a decode step against reading the decoder,
     the head and the cross K/V once, ms of the encoder pass, the peak
     memory.

Token streams that should be equal may part only at a near-tie of the
two best f32 logits (gap within 1e-3 of the max): the batch composition
changes the order of the bf16 sums in the trunk's matrix products.
Paths that compute a prompt's K/V with other arithmetic -- one-shot and
chunked prefill, prefix sharing off and on -- differ in bf16 by far more
(their logits ~0.08 apart, as far as each from the f32 trunk's), so
their streams are held to that rule in f32 at full width
(``cross_path_f32``) and only measured in bf16.

It prints one JSON object with the kernels' numbers on the line before
the last, and ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero without either when CUDA is absent or ``src/repro_torch``
is not beside it.  It imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet: HBM bandwidth and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores

PA_TOL = 2e-2          # paged attention, bf16: atol = rtol
MAXONLY_BAND = 1e-3    # maxonly: a key within this of the best f32 score
PIN_TOL = 1e-5         # paged modes at a pinned max, f32: atol = rtol
PIN_GAP = 0.1          # ... kernel's gap to exact vs the plain one's
BF16_STEP = 2.0 ** -8  # one bf16 step, relative
FA_TOL = 2e-2          # flash attention, bf16 output: atol = rtol
HEAD_RTOL = 1e-3       # head value rtol; idx must match past this gap
UNIT_RTOL = 2e-5       # softmax unit kernels vs plain: split sum order
UNIT_ATOL = 1e-7       # stats, probabilities and gradient
XENT_ATOL = 1e-6       # cross-entropy (m + log l - x: cancellation)


def kernel_modules():
    """The kernels' wrappers by kernel name (each has a ``launches``
    count), as the port's step graphs count them."""
    from repro_torch.serve import step_graph

    return step_graph.kernel_wrappers()


def reset_launches():
    for fn in kernel_modules().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_mode"):
            fn.launches_by_mode = dict.fromkeys(fn.launches_by_mode, 0)
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_modules().items()}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def clocks_line() -> str:
    """SM clock now and its maximum, power draw and temperature: a card
    held below its clocks runs every kernel slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return "clocks.sm, clocks.max.sm, power.draw, temperature: " + \
        out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """CUDA-event time of one call, averaged over ``iters`` runs, with
    the 50 MB L2 flushed before each run (the decode step finds each
    layer's operands cold).  ``timer(fn)`` is the call's time; a timed
    kernel and its library call get three readings (``readings``):

    - ``ms``, the call's time: the events also catch the host's Python
      in front of the call's first launch where it outlasts the flush
      (the one reading this script took before it took all three);
    - ``device_ms``, the card's time: the card spins for HOLD_CYCLES
      while the host records the start event and enqueues the call, so
      the events bracket the card's work alone;
    - ``host_ms``, the host's time to enqueue the call (wall clock, in
      the held runs, where no launch waits for the card)."""

    HOLD_CYCLES = 1_000_000          # ~0.5 ms at the H100's 1,980 MHz

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def _run(self, fn, hold, iters=20, warmup=3):
        """(mean event ms, mean host ms) over ``iters`` calls."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = host = 0.0
        for _ in range(iters):
            self.flush.zero_()
            if hold:
                torch.cuda._sleep(self.HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host += time.perf_counter() - t0
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters, host * 1e3 / iters

    def __call__(self, fn) -> float:
        return self._run(fn, hold=False)[0]

    def readings(self, fn, prefix="") -> dict:
        """``fn``'s call, device and host ms under the keys ``prefix`` +
        ``ms``, ``device_ms`` and ``host_ms``."""
        device, host = self._run(fn, hold=True)
        return {f"{prefix}ms": self(fn), f"{prefix}device_ms": device,
                f"{prefix}host_ms": host}


NO_LIBRARY = dict.fromkeys(("library_ms", "library_device_ms",
                            "library_host_ms"))
# the timing keys of a kernel's row and of its entry in the kernels line
TIMES = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
         *NO_LIBRARY)


def shown(row, prefix="") -> str:
    """A row's three readings as printed."""
    if row[f"{prefix}ms"] is None:
        return "none"
    return (f"{row[f'{prefix}ms']:.4f} ms (device "
            f"{row[f'{prefix}device_ms']:.4f}, host "
            f"{row[f'{prefix}host_ms']:.4f})")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def paged_case(torch, rng, t, *, b=8, hq=16, hkv=8, hd=128, bs=16,
               dtype=None):
    """The main path's decode shapes: ragged contexts of 1..1000 tokens,
    permuted pool blocks, tables padded to a power of two with each row's
    own first block, bf16 (or ``dtype``).  One row (b = 1) holds 1000."""
    from repro_torch.serve.paged_kv import pow2

    ctx = rng.integers(1, 1001, size=b)
    ctx[:2] = (1, 1000) if b > 1 else 1000    # both ends of the range
    last = ctx - 1
    nbs = last // bs + 1
    nb = pow2(int(nbs.max()))
    nblocks = int(nbs.sum()) + 8
    perm = rng.permutation(nblocks)
    table, k0 = np.empty((b, nb), np.int32), 0
    for r, n in enumerate(nbs):
        table[r, :n] = perm[k0:k0 + n]
        table[r, n:] = perm[k0]
        k0 += n
    if t == 1:
        pos = last.astype(np.int32)
    else:
        pos = np.maximum(last[:, None] - np.arange(t - 1, -1, -1), 0
                         ).astype(np.int32)
    qshape = (b, hq, hd) if t == 1 else (b, t, hq, hd)
    dev, bf = "cuda", (torch.bfloat16 if dtype is None else dtype)
    q = torch.from_numpy(rng.standard_normal(qshape, np.float32)).to(dev, bf)
    kp = torch.from_numpy(rng.standard_normal(
        (nblocks, bs, hkv, hd), np.float32)).to(dev, bf)
    vp = torch.from_numpy(rng.standard_normal(
        (nblocks, bs, hkv, hd), np.float32)).to(dev, bf)
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev))


def paged_work(q, kp, bt, pos, window):
    """(bytes, flops) a paged-attention call must move and do on these
    inputs: q read and out written once, each row's K/V span read once
    (from its first visible position to its last query's), the table and
    positions; 4*hd flops per visible (query head, key) pair."""
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    pos2 = pos.reshape(b, tq).long()
    hi = pos2.max(dim=1).values
    lo = (pos2.min(dim=1).values - window + 1).clamp(min=0) \
        if window is not None else hi * 0
    el = q.element_size()
    nbytes = (2 * q.numel() * el + 2 * (hi - lo + 1).sum().item() * hkv * hd
              * el + bt.numel() * 4 + pos.numel() * 4)
    seen = pos2 + 1 if window is None else (pos2 + 1).clamp(max=window)
    return nbytes, 4 * hd * hq * seen.sum().item()


def sdpa_on_gathered_view(torch, q, kp, vp, bt, pos, window, scale):
    """The library yardstick of paged attention: SDPA at ``scale`` over the
    gathered (dense) K/V view with the causal (and window) mask, as a
    call to time."""
    import torch.nn.functional as F

    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    kd = kp[bt.long()].reshape(b, -1, hkv, hd).transpose(1, 2)
    vd = vp[bt.long()].reshape(b, -1, hkv, hd).transpose(1, 2)
    qd = q.reshape(b, tq, hq, hd).transpose(1, 2)
    pos2 = pos.reshape(b, tq).long()
    kv = torch.arange(kd.shape[2], device=q.device)
    mask = kv[None, None, :] <= pos2[:, :, None]
    if window is not None:
        mask &= kv[None, None, :] > pos2[:, :, None] - window
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None], scale=scale, enable_gqa=True)


def split_line(pa, q, kp, bt) -> str:
    """The split the paged-attention wrapper takes for these operands (the
    same in every score mode)."""
    n, ck = pa.split_for(q, kp, bt)
    return (f"{n} chunks of {ck} keys, combine in chunk order" if n > 1
            else f"1 chunk of {ck} keys, no combine")


def check_repeatable(torch, fn, what):
    """Two calls of a kernel on the same inputs give the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    print(f"{what}: two calls {'bitwise equal' if same else 'DIFFER'}",
          flush=True)
    check(same, f"{what}: two calls on the same inputs differ")


def check_paged_attention(torch, timer, rng):
    """Exact paged attention at T = 1, 4 and 32 over 8 ragged rows, at T
    = 64 (a step of chunked prefill at ``chunk_size=64``: each row a
    window of 64 consecutive positions), and at T = 1 over one
    1000-token row (B 1, the single-row latency case the split is for).
    Each call's split scratch (f32 partials, written by the fold and
    read by the combine) is printed."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    # T = 32 at g = 2: 64 query rows per head
    for key, t, b in ((1, 1, 8), (4, 4, 8), (32, 32, 8), ("B1", 1, 1),
                      (64, 64, 8)):
        # T 64 on its own generator: the later phases keep their inputs
        q, kp, vp, bt, pos = paged_case(
            torch, rng if t != 64 else np.random.default_rng(64), t, b=b)
        hd = q.shape[-1]
        tag = f"B={b} T={t}"
        out = pa.paged_attention(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        want = ref.paged_attention(q, kp, vp, bt, pos)
        check(bool(torch.isfinite(out).all()), f"paged {tag}: non-finite")
        err = (out.float() - want.float()).abs().max().item()
        ok = torch.allclose(out.float(), want.float(), atol=PA_TOL,
                            rtol=PA_TOL)
        print(f"paged_attention {tag}: {split_line(pa, q, kp, bt)}; "
              f"max_abs_err {err:.6g} vs plain (atol = rtol = {PA_TOL}): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"paged attention {tag} disagrees with its plain version")
        check_repeatable(torch, lambda: pa.paged_attention(
            q, kp, vp, bt, pos), f"paged_attention {tag}")

        kern = timer.readings(lambda: pa.paged_attention(
            q, kp, vp, bt, pos))
        plain_ms = timer(lambda: ref.paged_attention(q, kp, vp, bt, pos))
        lib = timer.readings(sdpa_on_gathered_view(
            torch, q, kp, vp, bt, pos, None, 1 / math.sqrt(hd)), "library_")
        nbytes, flops = paged_work(q, kp, bt, pos, None)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        n_chunks = pa.split_for(q, kp, bt)[0]
        scratch = (q.numel() // hd * n_chunks * (hd + 2) * 4
                   if n_chunks > 1 else 0)
        print(f"paged_attention {tag}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, sdpa(gathered view) "
              f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.3f} MB); split scratch "
              f"{scratch / 1e6:.3f} MB a call", flush=True)
        rows[key] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, **lib,
                         chunks=n_chunks, scratch_mb=scratch / 1e6)
    return rows


def visible_scores(torch, q, kp, bt, pos, window):
    """The f32 scores of every (row, query, head, key) of a paged-attention
    call, (b, t, hq, s), -inf where the key is not visible."""
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    k = kp.float()[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    qq = q.float().reshape(b, tq, hq, hd)
    scores = torch.einsum("bthd,bshd->bths", qq, k) / math.sqrt(hd)
    pos2 = pos.reshape(b, tq).long()
    kv = torch.arange(k.shape[1], device=q.device)
    vis = kv[None, None, :] <= pos2[:, :, None]
    if window is not None:
        vis &= kv[None, None, :] > pos2[:, :, None] - window
    return torch.where(vis[:, :, None, :], scores, -torch.inf)


def maxonly_rows(torch, out, q, kp, vp, bt, pos, window):
    """maxonly against its plain version on f32 copies of the inputs:
    (max abs error against that plain output, rows equal to it, rows
    that are instead the V row of another key scoring within
    MAXONLY_BAND * |best| of the best f32 score, rows that are
    neither)."""
    from repro_torch.kernels import ref

    qf, kf, vf = q.float(), kp.float(), vp.float()
    want = ref.paged_attention(qf, kf, vf, bt, pos, attn_approx="maxonly",
                               window=window)
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    v = vf[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    scores = visible_scores(torch, q, kp, bt, pos, window)
    best = scores.amax(dim=-1, keepdim=True)
    near = scores >= best - MAXONLY_BAND * best.abs()          # (b,t,h,s)
    got = out.float().reshape(b, tq, hq, hd)
    same = (got == want.float().reshape(b, tq, hq, hd)).all(-1)
    # (b, t, h, s): the output row is key s's V row
    is_row = (got[:, :, :, None] == v.permute(0, 2, 1, 3)[:, None]).all(-1)
    banded = (is_row & near).any(-1) & ~same
    err = (got - want.float().reshape(b, tq, hq, hd)).abs().max().item()
    return (err, int(same.sum()), int(banded.sum()),
            int((~same & ~banded).sum()))


def paged_passes(torch, fn) -> dict:
    """Device ms per call of each launch of a paged-attention call, from a
    profiler trace (``kernel_device_ms``): the row-max pre-pass (base2 and
    pwl), the fold and the combine."""
    times = kernel_device_ms(torch, fn)
    got = {key: sum(t for n, t in times.items() if name in n)
           for key, name in (("prepass_ms", "paged_rowmax"),
                             ("fold_ms", "paged_attention"),
                             ("combine_ms", "paged_combine"))}
    check(got["fold_ms"] > 0, f"paged passes: the trace shows no fold "
          f"kernel: {sorted(times)}")
    return got


def check_paged_modes(torch, timer, rng):
    """Paged attention's exp-free score modes at the main path's shapes
    (``paged_case``: T = 1 and 4; window None and 128), each against its
    plain version: base2, pseudo and pwl at PA_TOL, maxonly by
    ``maxonly_rows``.  Each is timed beside exact on the same inputs, with
    the same bound, and at T = 1 without a window its launches apart
    (``paged_passes``: base2 and pwl's row-max pre-pass, the fold, the
    combine); the library yardstick of pseudo is SDPA at scale ln 2 /
    sqrt(hd) on the gathered view (softmax(s ln 2) = 2^s / sum 2^s), and
    no one PyTorch call computes base2, pwl or maxonly."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    for t in (1, 4):
        for window in (None, 128):
            q, kp, vp, bt, pos = paged_case(torch, rng, t)
            nbytes, flops = paged_work(q, kp, bt, pos, window)
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
            tag = f"T={t} window={window}"
            for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
                out = pa.paged_attention(q, kp, vp, bt, pos,
                                         attn_approx=mode, window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      f"paged {mode} {tag}: non-finite")
                if mode == "maxonly":
                    err, same, banded, bad = maxonly_rows(
                        torch, out, q, kp, vp, bt, pos, window)
                    ok = bad == 0
                    verdict = (f"{same} rows equal to the plain version on "
                               f"f32 copies, {banded} the V row of a key "
                               f"within {MAXONLY_BAND}*|best| of the best "
                               f"f32 score, {bad} neither")
                else:
                    want = ref.paged_attention(q, kp, vp, bt, pos,
                                               attn_approx=mode,
                                               window=window)
                    err = (out.float() - want.float()).abs().max().item()
                    ok = torch.allclose(out.float(), want.float(),
                                        atol=PA_TOL, rtol=PA_TOL)
                    verdict = f"atol = rtol = {PA_TOL}"
                print(f"paged_attention {mode} {tag}: "
                      f"{split_line(pa, q, kp, bt)}; max_abs_err "
                      f"{err:.6g} vs plain ({verdict}): "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"paged attention {mode} {tag} disagrees with its "
                      "plain version")

                kern = timer.readings(lambda: pa.paged_attention(
                    q, kp, vp, bt, pos, attn_approx=mode, window=window))
                plain_ms = timer(lambda: ref.paged_attention(
                    q, kp, vp, bt, pos, attn_approx=mode, window=window))
                lib = NO_LIBRARY
                if mode in ("exact", "pseudo"):
                    scale = (math.log(2) if mode == "pseudo" else 1.0) \
                        / math.sqrt(q.shape[-1])
                    lib = timer.readings(sdpa_on_gathered_view(
                        torch, q, kp, vp, bt, pos, window, scale),
                        "library_")
                print(f"paged_attention {mode} {tag}: kernel {shown(kern)}, "
                      f"plain {plain_ms:.4f} ms, library "
                      f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
                      f"({bound_by}: {nbytes / 1e6:.3f} MB)", flush=True)
                rows[(mode, t, window)] = dict(
                    max_abs_err=err, **kern, plain_ms=plain_ms, **lib,
                    bound_ms=bound_ms, bound_by=bound_by)
                if (t, window) == (1, None):
                    passes = paged_passes(torch, lambda: pa.paged_attention(
                        q, kp, vp, bt, pos, attn_approx=mode))
                    print(f"paged_attention {mode} {tag} launches "
                          "(profiler, device): " + ", ".join(
                              f"{k} {v:.4f}" for k, v in passes.items()),
                          flush=True)
                    rows[(mode, t, window)]["passes"] = passes
    return rows


def pinned_case(torch, rng, t, window):
    """``paged_case`` in f32 with every value on a quarter step in [-4, 4],
    so that each score's dot product is exact in any order and kernel and
    plain version form the same f32 scores, and with each query's first
    visible key made its strict best: q[..., 0] = 4 and that key's K row
    20 * e_0 (19, 18, 17 for a later query's first key, which an earlier
    query of the row also sees), a score of 7.07 against ~N(0, 1.06) for
    the rest.  The kernel's running max then never moves after the first
    slice with a visible key, so it evaluates the score function at the
    max the plain version uses."""
    q, kp, vp, bt, pos = paged_case(torch, rng, t, dtype=torch.float32)
    for x in (q, kp, vp):
        x.copy_(torch.clamp(torch.round(x * 4), -16, 16) / 4)
    b, bs = q.shape[0], kp.shape[1]
    q[..., 0] = 4.0
    pos2, table = pos.reshape(b, -1).cpu().numpy(), bt.cpu().numpy()
    for r in range(b):
        first = pos2[r] * 0 if window is None else np.maximum(
            pos2[r] - window + 1, 0)
        for rank, p in enumerate(sorted(set(first.tolist()))):
            blk, off = int(table[r, p // bs]), p % bs
            kp[blk, off] = 0.0
            kp[blk, off, :, 0] = 20.0 - rank
    return q, kp, vp, bt, pos


def first_key_margin(torch, q, kp, bt, pos, window) -> float:
    """min over queries and heads of (the first visible key's f32 score -
    the best other visible key's)."""
    scores = visible_scores(torch, q, kp, bt, pos, window)
    kv = torch.arange(scores.shape[-1], device=q.device)
    first = (scores > -torch.inf).float().argmax(dim=-1, keepdim=True)
    own = scores.gather(-1, first)
    rest = torch.where(kv == first, -torch.inf, scores).amax(dim=-1,
                                                             keepdim=True)
    return (own - rest).min().item()


def check_paged_modes_pinned(torch, rng):
    """base2, pseudo and pwl (and exact) where kernel and plain version
    evaluate the score function at the same max (``pinned_case``; T = 1
    and 4, window None and 128).  In f32 the kernel agrees with its plain
    version within PIN_TOL (summation order only), and its gap to its own
    exact output is within PIN_GAP of the plain version's gap to exact --
    a kernel that ignored the mode would miss by the whole gap; on bf16
    copies of the same values it agrees with the plain version on the f32
    inputs within one bf16 step of the output."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    modes = ("exact", "base2", "pseudo", "pwl")
    rows = {}
    for t in (1, 4):
        for window in (None, 128):
            tag = f"T={t} window={window}"
            q, kp, vp, bt, pos = pinned_case(torch, rng, t, window)
            margin = first_key_margin(torch, q, kp, bt, pos, window)
            check(margin > 0.25, f"paged pinned {tag}: the first visible "
                  f"key leads by {margin}, not > 0.25")
            want = {m: ref.paged_attention(q, kp, vp, bt, pos, attn_approx=m,
                                           window=window) for m in modes}
            got = {m: pa.paged_attention(q, kp, vp, bt, pos, attn_approx=m,
                                         window=window) for m in modes}
            bf = [x.to(torch.bfloat16) for x in (q, kp, vp)]
            got_bf = {m: pa.paged_attention(*bf, bt, pos, attn_approx=m,
                                            window=window) for m in modes}
            torch.cuda.synchronize()
            for mode in modes:
                err = (got[mode] - want[mode]).abs().max().item()
                ok = torch.allclose(got[mode], want[mode], atol=PIN_TOL,
                                    rtol=PIN_TOL)
                err_bf = (got_bf[mode].float() - want[mode]).abs().max()
                ok_bf = torch.allclose(got_bf[mode].float(), want[mode],
                                       atol=PIN_TOL, rtol=BF16_STEP)
                line = (f"paged_attention {mode} pinned {tag}: f32 "
                        f"max_abs_err {err:.6g} (atol = rtol = {PIN_TOL}), "
                        f"bf16 {err_bf.item():.6g} vs plain on f32 (atol "
                        f"{PIN_TOL}, rtol {BF16_STEP})")
                gap = miss = None
                if mode != "exact":
                    want_gap = want[mode] - want["exact"]
                    gap = want_gap.abs().max().item()
                    miss = ((got[mode] - got["exact"]) - want_gap
                            ).abs().max().item()
                    ok = ok and miss <= PIN_GAP * gap
                    line += (f"; gap to exact {gap:.6g} plain, kernel's "
                             f"off by {miss:.6g} (<= {PIN_GAP} x gap)")
                print(f"{line}: {'ok' if ok and ok_bf else 'FAIL'}",
                      flush=True)
                check(ok and ok_bf, f"paged attention {mode} pinned {tag} "
                      "disagrees with its plain version")
                rows[(mode, t, window)] = dict(max_abs_err=err, gap=gap,
                                               miss=miss)
    return rows


LUT_STEP = 2.0 ** (1 / 256) - 1   # base2: a weight's jump at a LUT bin edge
FLIP_EPS = 2.0 ** -19             # base2: y's rounding, relative (below)


def base2_flip_allowance(torch, q, kp, vp, bt, pos, window, out):
    """How far each f32 base2 output element may move when a score's LUT
    bin flips, and the number of keys that may flip.  Kernel and plain
    version form each score in another order (an fmaf chain times 1 /
    sqrt(hd), against a batched product divided by sqrt(hd)), so they
    differ by an ulp or so; the plain version's y = (s - M) log2 e of a
    key within FLIP_EPS * (1 + |s| + |M|) of an edge of the rounding
    rint(frac(y) * 256) (a half step, or an integer y; the row's best key
    at y = 0 only if another key scores that close to it) may land in the
    neighbouring bin in the kernel, moving that key's weight by LUT_STEP
    relative and the output by at most p_key * LUT_STEP * (|v_key| +
    |out|).  pwl's chords meet at their ends, so its weight moves only by
    the rounding itself."""
    from repro_torch.core import attn_approx as approx
    from repro_torch.core.softmax_variants import LOG2E

    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    s = visible_scores(torch, q, kp, bt, pos, window)      # (b, t, hq, keys)
    vis = s > -torch.inf
    m = s.amax(dim=-1, keepdim=True)
    y = ((s - m) * LOG2E).double()
    frac = y - torch.floor(y)
    bins = frac * 256
    edge = torch.minimum((bins - torch.floor(bins) - 0.5).abs() / 256,
                         torch.minimum(frac, 1 - frac))
    top = s == m
    second = torch.where(top, -torch.inf, s).amax(dim=-1, keepdim=True)
    gap = torch.where(top.sum(-1, keepdim=True) > 1, 0.0,
                      (m - second) * LOG2E).double()
    edge = torch.where(top, gap, edge)
    near = vis & (edge <= FLIP_EPS * (1 + s.abs() + m.abs()).double())
    p = approx.attn_weights(torch.where(vis, s, -1e30), "base2")
    pn = torch.where(near, p, 0.0)
    v = vp.float()[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    o = out.float().reshape(b, tq, hq, hd)
    move = LUT_STEP * (torch.einsum("bths,bshd->bthd", pn, v.abs())
                       + o.abs() * pn.sum(-1, keepdim=True))
    return move.reshape(out.shape), int(near.sum())


def check_paged_modes_unpinned(torch, timer, rng):
    """base2 and pwl (and exact beside them) in f32 at the main path's
    shapes (``paged_case``, T = 1 and 4, window None and 128), on inputs
    with nothing pinned: the kernel weighs every score at its row's max,
    as the plain version does, so it agrees with the plain version within
    PIN_TOL -- base2 where no score's LUT bin may flip between the two
    roundings of the score, and within PIN_TOL plus the flips' own effect
    where one may (``base2_flip_allowance``).  A kernel that weighed at a
    chunk's or a slice's own max would miss by a LUT bin or a chord on
    every key.  Timed at T = 1 without a window."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    for t in (1, 4):
        for window in (None, 128):
            tag = f"T={t} window={window}"
            q, kp, vp, bt, pos = paged_case(torch, rng, t,
                                            dtype=torch.float32)
            for mode in ("exact", "base2", "pwl"):
                got = pa.paged_attention(q, kp, vp, bt, pos,
                                         attn_approx=mode, window=window)
                want = ref.paged_attention(q, kp, vp, bt, pos,
                                           attn_approx=mode, window=window)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                room = PIN_TOL + PIN_TOL * want.abs()
                err, over = diff.max().item(), int((diff > room).sum())
                line = (f"paged_attention {mode} f32 unpinned {tag}: "
                        f"max_abs_err {err:.6g}, {over} of {diff.numel()} "
                        f"elements over atol = rtol = {PIN_TOL}")
                if mode == "base2":
                    move, keys = base2_flip_allowance(
                        torch, q, kp, vp, bt, pos, window, want)
                    ok = bool((diff <= room + move).all())
                    line += (f"; {keys} keys within {FLIP_EPS:.3g} "
                             f"relative of a LUT bin edge, allowance up to "
                             f"{move.max().item():.6g}, all within it")
                else:
                    ok = over == 0
                print(f"{line}: {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"paged attention {mode} f32 unpinned {tag} "
                      "disagrees with its plain version")
                rows[(mode, t, window)] = dict(max_abs_err=err, over=over)
                if (t, window) == (1, None):
                    kern = timer.readings(lambda: pa.paged_attention(
                        q, kp, vp, bt, pos, attn_approx=mode))
                    print(f"paged_attention {mode} f32 {tag}: kernel "
                          f"{shown(kern)}", flush=True)
                    rows[(mode, t, window)].update(kern)
    return rows


def paged_routes(torch, rng) -> dict:
    """The kernels paged attention ran per (dtype, mode), read from a
    profiler trace of one call (T = 1 over 2 ragged rows): bf16 must run
    the tensor-core kernel (``paged_attention_mma_kernel``) in every mode,
    f32 the CUDA-core one (``paged_attention_kernel``); base2 and pwl run
    the row-max pre-pass of the same route first
    (``paged_rowmax_mma_kernel`` / ``paged_rowmax_kernel``), the other
    modes none."""
    from repro_torch.kernels import paged_attention as pa

    routes = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, bt, pos = paged_case(torch, rng, 1, b=2, dtype=dtype)
        for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
            names = [n for n in device_kernels(
                torch, lambda: pa.paged_attention(q, kp, vp, bt, pos,
                                                  attn_approx=mode),
                "paged_attention") if "paged_" in n]
            mma = [n for n in names if "paged_attention_mma_kernel" in n]
            core = [n for n in names if "paged_attention_kernel" in n]
            pre_mma = [n for n in names if "paged_rowmax_mma_kernel" in n]
            pre_core = [n for n in names if "paged_rowmax_kernel" in n]
            route = ("mma" if mma and not core else
                     "cuda-core" if core and not mma else f"? {names}")
            pre = ("mma" if pre_mma and not pre_core else
                   "cuda-core" if pre_core and not pre_mma else
                   None if not (pre_mma or pre_core) else f"? {names}")
            tag = f"{str(dtype).replace('torch.', '')} {mode}"
            routes[tag] = route if pre is None else \
                f"{route} after a row-max pre-pass ({pre})"
            want = "mma" if dtype == torch.bfloat16 else "cuda-core"
            want_pre = want if mode in pa.PREMAX_MODES else None
            print(f"paged_attention route {tag}: {routes[tag]} (ran "
                  f"{', '.join(n[:60] for n in names)})", flush=True)
            check(route == want and pre == want_pre,
                  f"paged attention {tag} ran {names}, not the {want} "
                  f"kernel with {want_pre} pre-pass")
    return routes


def check_paged_invariance(torch, rng):
    """A row's attention bits depend on its own inputs, dtype, head dim
    and mode only.  At the main path's shapes (bf16, 16/8 heads, hd 128),
    in every score mode: each of 8 ragged rows alone (B 1, a table of its
    own width, so fewer chunks) equals, bit for bit, the same row in the
    batch beside the 1,000-token row (B 8, a 1,024-position table, 16
    chunks); each row's T = 1 output equals every column of the same
    row at T = 8 whose padding queries repeat its position; and every
    column of a T = 64 chunk window (each row 64 consecutive positions)
    equals the same queries at T = 1."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve.paged_kv import pow2

    q, kp, vp, bt, pos = paged_case(torch, rng, 1)
    # its own generator: the later phases keep the inputs they had
    q64, kp64, vp64, bt64, pos64 = paged_case(
        torch, np.random.default_rng(64), 64)
    b, bs = q.shape[0], kp.shape[1]
    q8 = q[:, None].expand(b, 8, *q.shape[1:]).contiguous()
    pos8 = pos[:, None].expand(b, 8).contiguous()
    out = {}
    for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
        batch = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
        alone = []
        for r in range(b):
            nb = pow2(int(pos[r]) // bs + 1)
            alone.append(pa.paged_attention(
                q[r:r + 1].contiguous(), kp, vp,
                bt[r:r + 1, :nb].contiguous(), pos[r:r + 1],
                attn_approx=mode))
        wide = pa.paged_attention(q8, kp, vp, bt, pos8, attn_approx=mode)
        chunk = pa.paged_attention(q64, kp64, vp64, bt64, pos64,
                                   attn_approx=mode)
        ones = [pa.paged_attention(q64[:, c].contiguous(), kp64, vp64, bt64,
                                   pos64[:, c].contiguous(),
                                   attn_approx=mode) for c in range(64)]
        torch.cuda.synchronize()
        rows_ok = sum(bool(torch.equal(a[0], batch[r]))
                      for r, a in enumerate(alone))
        cols_ok = sum(bool(torch.equal(wide[:, t], batch))
                      for t in range(8))
        chunk_ok = sum(bool(torch.equal(chunk[:, c], one))
                       for c, one in enumerate(ones))
        chunks = sorted({pa.split_for(q[:1], kp, bt[:1, :pow2(
            int(pos[r]) // bs + 1)])[0] for r in range(b)})
        print(f"paged_attention {mode} invariance: {rows_ok}/{b} rows "
              f"alone (chunks {chunks}) bitwise equal to the same row at "
              f"B {b} ({pa.split_for(q, kp, bt)[0]} chunks); "
              f"{cols_ok}/8 columns of T 8 bitwise equal to T 1; "
              f"{chunk_ok}/64 columns of a T 64 chunk window bitwise equal "
              f"to T 1: {'ok' if rows_ok == b and cols_ok == 8 and chunk_ok == 64 else 'FAIL'}",
              flush=True)
        check(rows_ok == b, f"paged {mode}: a row alone differs from the "
              "same row beside a 1,000-token row")
        check(cols_ok == 8, f"paged {mode}: T 8 with repeated positions "
              "differs from T 1")
        check(chunk_ok == 64, f"paged {mode}: a column of a T 64 chunk "
              "window differs from its query at T 1")
        out[mode] = dict(rows_equal=rows_ok, columns_equal=cols_ok,
                         chunk_columns_equal=chunk_ok)
    return out


def check_head_dim_192(torch, timer, rng):
    """nemotron-4-340b's head dim 192 (96 query / 8 KV heads, g 12) in
    both attention kernels, bf16, against their plain versions at the
    existing tolerances: paged attention at T = 1 and 32 over 8 ragged
    rows in every score mode (maxonly by ``maxonly_rows``), and flash
    attention over a 512-token prompt, causal, at g 2 and 12; flash at g
    2 and paged exact at T 1 timed beside SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    for t in (1, 32):
        q, kp, vp, bt, pos = paged_case(torch, rng, t, hq=96, hkv=8,
                                        hd=192)
        for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
            out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"paged hd 192 {mode} T={t}: non-finite")
            if mode == "maxonly":
                err, _, _, bad = maxonly_rows(torch, out, q, kp, vp, bt, pos,
                                              None)
                ok = bad == 0
            else:
                want = ref.paged_attention(q, kp, vp, bt, pos,
                                           attn_approx=mode)
                err = (out.float() - want.float()).abs().max().item()
                ok = torch.allclose(out.float(), want.float(), atol=PA_TOL,
                                    rtol=PA_TOL)
            print(f"paged_attention hd 192 {mode} T={t}: max_abs_err "
                  f"{err:.6g} vs plain: {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"paged attention hd 192 {mode} T={t} disagrees with "
                  "its plain version")
            rows[f"paged_T{t}_{mode}"] = dict(max_abs_err=err)
            if mode in ("base2", "pwl") or (mode, t) == ("exact", 32):
                kern = timer.readings(lambda: pa.paged_attention(
                    q, kp, vp, bt, pos, attn_approx=mode))
                print(f"paged_attention hd 192 {mode} T={t}: kernel "
                      f"{shown(kern)}", flush=True)
                rows[f"paged_T{t}_{mode}"].update(kern)
        if t == 1:
            kern = timer.readings(lambda: pa.paged_attention(
                q, kp, vp, bt, pos))
            lib = timer.readings(sdpa_on_gathered_view(
                torch, q, kp, vp, bt, pos, None, 1 / math.sqrt(192)),
                "library_")
            nbytes, flops = paged_work(q, kp, bt, pos, None)
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
            print(f"paged_attention hd 192 T=1: kernel {shown(kern)}, "
                  f"sdpa(gathered view) {shown(lib, 'library_')}, bound "
                  f"{bound_ms:.4f} ms ({bound_by})", flush=True)
            rows["paged_T1_exact"].update(kern, bound_ms=bound_ms,
                                          bound_by=bound_by, **lib)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for hq, hkv in ((16, 8), (96, 8)):
        q, k, v = (torch.randn((1, 512, h, 192), generator=gen,
                               device="cuda").to(torch.bfloat16).transpose(
                                   1, 2) for h in (hq, hkv, hkv))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v)
        err = (out.float() - want.float()).abs().max().item()
        ok = torch.allclose(out.float(), want.float(), atol=FA_TOL,
                            rtol=FA_TOL)
        g = hq // hkv
        print(f"flash_attention hd 192 T512 g {g}: max_abs_err {err:.6g} "
              f"vs plain (atol = rtol = {FA_TOL}): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash attention hd 192 g {g} disagrees with its plain "
              "version")
        row = dict(max_abs_err=err)
        if g == 2:
            row.update(timer.readings(lambda: fa.flash_attention(q, k, v)))
            row.update(timer.readings(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), "library_"))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            flops = 4 * 192 * hq * 512 * 513 // 2
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOPS_PER_S)
            print(f"flash_attention hd 192 T512 g 2: kernel {shown(row)}, "
                  f"sdpa {shown(row, 'library_')}, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})",
                  flush=True)
        rows[f"flash_T512_g{g}"] = row
    return rows


def argmax_verdict(torch, h, w, idx, val):
    """The argmax head's (idx, val) against its plain version: (idx_ok,
    val_ok, max_abs_err, plain idx).  Indices must be equal where the
    plain top-2 f32 logit gap exceeds HEAD_RTOL * |max|; values within
    rtol HEAD_RTOL."""
    from repro_torch.kernels import ref

    ridx, rval = ref.fused_argmax_head_with_value(h, w)
    top2 = torch.matmul(h.float(), w.float()).topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > HEAD_RTOL * rval.abs()
    idx_ok = bool(((idx == ridx) | ~decided).all())
    val_ok = torch.allclose(val, rval, rtol=HEAD_RTOL, atol=0.0)
    return idx_ok, val_ok, (val - rval).abs().max().item(), ridx


def topk_verdict(torch, h, w, k, vals, idxs) -> dict:
    """The top-k head's (vals, idxs) against its plain version: indices
    equal where a value stands apart from both plain neighbours by more
    than HEAD_RTOL * |val|, equal values in increasing index order,
    values descending and within rtol HEAD_RTOL."""
    from repro_torch.kernels import ref

    rvals, ridxs = ref.fused_topk_head(h, w, k)
    full, _ = ref.fused_topk_head(h, w, k + 1)
    inf = torch.full_like(full[:, :1], float("inf"))
    to_next = full - torch.cat([full[:, 1:], -inf], dim=1)
    to_prev = torch.cat([inf, to_next[:, :-1]], dim=1)
    decided = (torch.minimum(to_next, to_prev)
               > HEAD_RTOL * full.abs())[:, :k]
    tied = vals[:, 1:] == vals[:, :-1]
    return dict(
        idx_ok=bool(((idxs == ridxs) | ~decided).all()),
        ties_ok=bool((~tied | (idxs[:, 1:] > idxs[:, :-1])).all()),
        desc_ok=bool((vals[:, 1:] <= vals[:, :-1]).all()),
        val_ok=torch.allclose(vals, rvals, rtol=HEAD_RTOL, atol=0.0),
        err=(vals - rvals).abs().max().item(), n_ties=int(tied.sum()))


def topk_line(tv: dict) -> str:
    ok = {k: "ok" if tv[k] else "FAIL"
          for k in ("idx_ok", "ties_ok", "desc_ok", "val_ok")}
    return (f"idx {ok['idx_ok']} (equal where the value stands apart by > "
            f"{HEAD_RTOL}*|val|), {tv['n_ties']} equal neighbours "
            f"{ok['ties_ok']} (lower index first), descending "
            f"{ok['desc_ok']}, val max_abs_err {tv['err']:.6g} (rtol "
            f"{HEAD_RTOL}): {ok['val_ok']}")


def head_routes(torch) -> dict:
    """The pass-1 kernel the argmax and verify heads ran per dtype, read
    from a profiler trace of one call at qwen3-0.6b's width (B 8; T 8):
    bf16 must run the tensor-core tile (``argmax_wgmma_partial_kernel``),
    f32 the CUDA-core one (``argmax_partial_kernel``)."""
    from repro_torch.kernels import fused_argmax_head as fah

    gen = torch.Generator(device="cuda").manual_seed(11)
    routes = {}
    for dt, want in ((torch.bfloat16, "wgmma"),
                     (torch.float32, "cuda-core")):
        w = torch.randn((151936, 1024), generator=gen, device="cuda").to(dt)
        h = torch.randn((8, 8, 1024), generator=gen, device="cuda").to(dt)
        h1 = h[:, 0].contiguous()
        cand = torch.full((8, 7), -1, dtype=torch.int32, device="cuda")
        for entry, shape, fn in (
                ("argmax", h1.shape,
                 lambda: fah.fused_argmax_head_with_value(h1, w.t())),
                ("verify", h.shape,
                 lambda: fah.fused_verify_head(h, w.t(), cand))):
            names = [n for n in device_kernels(torch, fn, "_partial_kernel")
                     if "_partial_kernel" in n]
            wg = [n for n in names if "argmax_wgmma_partial_kernel" in n]
            core = [n for n in names if "argmax_partial_kernel" in n]
            route = ("wgmma" if wg and not core else
                     "cuda-core" if core and not wg else f"? {names}")
            tag = f"{entry} {str(dt).replace('torch.', '')}"
            routes[tag] = route
            plan = fah.head_plan(tuple(shape), 151936, dt,
                                 *fah.device_limits(0))
            print(f"head route {tag}: {route} (ran "
                  f"{', '.join(n[:60] for n in names)}; plan {plan})",
                  flush=True)
            check(route == want and plan.route == want,
                  f"head {tag} ran {names}, not the {want} kernel")
        del w
    geometry = fah.tile_geometry()
    check(geometry == (fah.VOCAB_TILE, fah.K_SLAB, fah.ROW_GROUP,
                       fah.STAGES, fah.TILE_SMEM_BYTES),
          f"the head tile's geometry {geometry} differs from the wrapper's")
    return routes


def check_argmax_head(torch, timer):
    """The argmax head at qwen3-0.6b's width, bf16, B 1, 8 (the main
    path's) and 64, with cross-split ties planted."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import ref

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(1)
    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    rows = {}
    for b in (1, 8, 64):
        h = torch.randn((b, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        # plant cross-split ties: copy each row's winner to the vocab row
        # half the vocabulary away, so an exact tie spans two far splits
        win = ref.fused_argmax_head(h, emb.t()).tolist()
        pairs = [(a, a - v // 2 if a >= v // 2 else a + v // 2) for a in win]
        for a, j in pairs:
            emb[j] = emb[a]
        w = emb.t()                                         # (D, V) view
        idx, val = fah.fused_argmax_head_with_value(h, w)
        torch.cuda.synchronize()
        idx_ok, val_ok, err, ridx = argmax_verdict(torch, h, w, idx, val)
        # rows whose winner is still a planted pair of equal vocab rows:
        # the kernel sums both identically, so it must return the lower
        live = [(r, min(a, j)) for r, (a, j) in enumerate(pairs)
                if torch.equal(emb[a], emb[j]) and int(ridx[r]) in (a, j)]
        ties_ok = all(int(idx[r]) == lo for r, lo in live)
        print(f"fused_argmax_head B={b}: idx {'ok' if idx_ok else 'FAIL'} "
              f"(equal where the top-2 gap > {HEAD_RTOL}*|val|), "
              f"{len(live)} planted cross-split ties "
              f"{'ok' if ties_ok else 'FAIL'} (lowest index wins), val "
              f"max_abs_err {err:.6g} (rtol {HEAD_RTOL}): "
              f"{'ok' if val_ok else 'FAIL'}", flush=True)
        check(idx_ok and ties_ok and val_ok,
              f"fused argmax head B={b} disagrees with its plain version")
        check(len(live) > 0, "no planted tie reached the top")

        kern = timer.readings(lambda: fah.fused_argmax_head_with_value(
            h, w))
        plain_ms = timer(lambda: ref.fused_argmax_head_with_value(h, w))
        lib = timer.readings(lambda: torch.argmax(h @ w, dim=-1), "library_")
        nbytes = v * d * 2 + b * d * 2 + b * 8
        bound_ms, bound_by = bound(nbytes, 2.0 * b * d * v,
                                   BF16_FLOPS_PER_S)
        print(f"fused_argmax_head B={b}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, argmax(h @ W) {shown(lib, 'library_')}, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        rows[b] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows


def check_topk_head(torch, timer):
    """The top-k head at qwen3-0.6b's width, B in {1, 4, 8} (4 is the
    main path's top-k group), k in {1, 8, 64}, bf16, with planted ties:
    each row's plain winners copied half the vocabulary away, so equal
    values sit in far vocabulary splits.  Values at rtol 1e-3; indices
    equal to the plain version's where a value stands apart from both
    neighbours by more than that; among the kernel's equal values the
    lower index first."""
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(2)
    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    rows = {}
    for b in (1, 4, 8):
        h = torch.randn((b, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        _, win = ref.fused_topk_head(h, emb.t(), 4)
        for a in win.flatten().tolist():
            emb[(a + v // 2) % v] = emb[a]
        w = emb.t()
        for k in (1, 8, 64):
            vals, idxs = ftk.fused_topk_head(h, w, k)
            torch.cuda.synchronize()
            tv = topk_verdict(torch, h, w, k, vals, idxs)
            err, n_ties = tv["err"], tv["n_ties"]
            print(f"fused_topk_head B={b} k={k}: {topk_line(tv)}",
                  flush=True)
            check(tv["idx_ok"] and tv["ties_ok"] and tv["desc_ok"]
                  and tv["val_ok"],
                  f"top-k head B={b} k={k} disagrees with its plain version")
            if k > 1:
                check(n_ties > 0, f"no planted tie reached the top {k}")

            kern = timer.readings(lambda: ftk.fused_topk_head(h, w, k))
            plain_ms = timer(lambda: ref.fused_topk_head(h, w, k))
            lib = timer.readings(lambda: torch.topk(h @ w, k, dim=-1),
                                 "library_")
            nbytes = v * d * 2 + b * d * 2 + b * k * 8
            bound_ms, bound_by = bound(nbytes, 2.0 * b * d * v,
                                       BF16_FLOPS_PER_S)
            print(f"fused_topk_head B={b} k={k}: kernel {shown(kern)}, "
                  f"plain {plain_ms:.4f} ms, topk(h @ W) "
                  f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
            rows[(b, k)] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows


def kernel_device_ms(torch, fn, iters=20) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches, by name,
    from a profiler trace over ``iters`` calls, the L2 flushed before
    each (the flush's own kernel is listed too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
    return out


def check_topk_passes(torch):
    """The top-k head's two kernels timed apart (profiler, device ms) at
    the main path's B 4, k 8 and 64, qwen3-0.6b's width; then k 64 on
    integer-valued operands, whose sums are exact in any order and whose
    logits tie across every vocabulary split: values and indices equal to
    ``ref.topk_select`` of the logits bit for bit."""
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    v, d, b = 151936, 1024, 4
    gen = torch.Generator(device="cuda").manual_seed(9)
    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    h = torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
    passes = {}
    for k in (8, 64):
        times = kernel_device_ms(torch, lambda: ftk.fused_topk_head(
            h, emb.t(), k))
        part = sum(t for n, t in times.items() if "topk_partial_kernel" in n)
        merge = sum(t for n, t in times.items() if "topk_merge_kernel" in n)
        check(part > 0 and merge > 0, f"top-k k={k}: the trace shows no "
              f"pass 1 or pass 2 kernel: {sorted(times)}")
        print(f"fused_topk_head B={b} k={k} passes (profiler, device): pass "
              f"1 topk_partial_kernel {part:.4f} ms, pass 2 "
              f"topk_merge_kernel {merge:.4f} ms", flush=True)
        passes[k] = dict(partial_ms=part, merge_ms=merge)
    emb = torch.randint(-2, 3, (v, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    h = torch.randint(-1, 2, (b, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    vals, idxs = ftk.fused_topk_head(h, emb.t(), 64)
    torch.cuda.synchronize()
    rvals, ridxs = ref.topk_select(torch.matmul(h.float(), emb.float().t()),
                                   64)
    same = torch.equal(vals, rvals) and torch.equal(idxs, ridxs)
    ties = int((vals[:, 1:] == vals[:, :-1]).sum())
    print(f"fused_topk_head B={b} k=64 on integer operands ({ties} equal "
          f"neighbours): values and indices "
          f"{'bitwise equal to' if same else 'DIFFER from'} "
          f"ref.topk_select", flush=True)
    check(same and ties > 0, "top-k k=64 differs from ref.topk_select on "
          "exact integer logits")
    return passes


def check_verify_head(torch, timer):
    """The verify head at qwen3-0.6b's width, bf16: B 8 rows of T in {2,
    8, 32} positions, and B 1 at T 32 (the spec_k 20 request).
    Integer-valued operands make every sum exact in any order, so ids
    and accept must equal the plain version's exactly.  Drafts: a prefix
    of each row's ids of ragged width (-1 padded), some with a wrong
    token inside the run.  Yardstick: ``argmax(h @ W)`` over the B*T
    rows (no one PyTorch call verifies)."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import ref

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randint(-2, 3, (v, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = emb.t()
    rng = np.random.default_rng(3)
    rows = {}
    for b, t in ((8, 2), (8, 8), (1, 32), (8, 32)):
        h = torch.randint(-1, 2, (b, t, d), generator=gen,
                          device="cuda").to(torch.bfloat16)
        ids0, _ = ref.verify_draft(h, w, torch.full(
            (b, t - 1), -1, dtype=torch.int32, device="cuda"))
        cand = np.full((b, t - 1), -1, np.int32)
        for r in range(b):
            width = r % t                          # ragged: 0 .. T-1
            cand[r, :width] = ids0[r, :width].cpu().numpy()
            if width and r % 3 == 0:               # a wrong draft
                j = int(rng.integers(0, width))
                cand[r, j] = (cand[r, j] + 1) % v
        cand_t = torch.from_numpy(cand).to("cuda")
        ids, acc = fah.fused_verify_head(h, w, cand_t)
        torch.cuda.synchronize()
        rids, racc = ref.verify_draft(h, w, cand_t)
        ok = torch.equal(ids, rids) and torch.equal(acc, racc)
        print(f"fused_verify_head B={b} T={t}: ids and accept "
              f"{'equal' if ok else 'DIFFER'} (exact; accept "
              f"{acc.tolist()})", flush=True)
        check(ok, f"verify head T={t} disagrees with its plain version")

        h2 = h.view(b * t, d)
        kern = timer.readings(lambda: fah.fused_verify_head(h, w, cand_t))
        plain_ms = timer(lambda: ref.verify_draft(h, w, cand_t))
        lib = timer.readings(lambda: torch.argmax(h2 @ w, dim=-1),
                             "library_")
        nbytes = v * d * 2 + b * t * d * 2 + cand.size * 4 + b * t * 4 + b * 4
        bound_ms, bound_by = bound(nbytes, 2.0 * b * t * d * v,
                                   BF16_FLOPS_PER_S)
        print(f"fused_verify_head B={b} T={t}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, argmax(h @ W) over the {b * t} rows "
              f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        rows[(b, t)] = dict(max_abs_err=0.0, **kern, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows


def check_head_invariance(torch):
    """A row's head result depends on its own h, W and D only: at
    qwen3-0.6b's width, bf16, random h, each of 8 rows' (val, idx) from
    the argmax head alone (B 1) is bit-equal to the same row as row r of
    B 8 and of B 64, and its id equals position t of the verify head at
    T 8 and T 32 (rows in the same order)."""
    from repro_torch.kernels import fused_argmax_head as fah

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(12)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         / math.sqrt(d)).to(torch.bfloat16).t()
    h = torch.randn((256, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    alone = [fah.fused_argmax_head_with_value(h[r:r + 1].contiguous(), w)
             for r in range(8)]
    b8 = fah.fused_argmax_head_with_value(h[:8].contiguous(), w)
    b64 = fah.fused_argmax_head_with_value(h[:64].contiguous(), w)
    ids = {t: fah.fused_verify_head(
        h[:8 * t].reshape(8, t, d).contiguous(), w,
        torch.full((8, t - 1), -1, dtype=torch.int32,
                   device="cuda"))[0].view(-1) for t in (8, 32)}
    torch.cuda.synchronize()
    ok = {"B 8": 0, "B 64": 0, "verify T 8": 0, "verify T 32": 0}
    for r, (i1, v1) in enumerate(alone):
        ok["B 8"] += bool(torch.equal(i1[0], b8[0][r])
                          and torch.equal(v1[0], b8[1][r]))
        ok["B 64"] += bool(torch.equal(i1[0], b64[0][r])
                           and torch.equal(v1[0], b64[1][r]))
        ok["verify T 8"] += int(ids[8][r]) == int(i1[0])
        ok["verify T 32"] += int(ids[32][r]) == int(i1[0])
    same64 = {t: bool(torch.equal(ids[t][:64], b64[0])) for t in (8, 32)}
    print("head invariance: " + ", ".join(
        f"{k} {n}/8 rows bitwise" for k, n in ok.items())
        + f" (alone vs the same row there); the B 64 ids == verify T 8 "
        f"{same64[8]}, == verify T 32's first 64 {same64[32]}", flush=True)
    check(all(n == 8 for n in ok.values()) and all(same64.values()),
          f"a row's head result depends on its batch: {ok}, {same64}")
    return dict(ok, b64_is_verify_t8=same64[8],
                b64_is_verify_t32=same64[32])


def wide_weight(torch, gen, v, d):
    """(V, D) bf16 with rows N(0, 1/D), made in slices (no f32 copy of
    the whole)."""
    emb = torch.empty((v, d), dtype=torch.bfloat16, device="cuda")
    for a in range(0, v, 16384):
        emb[a:a + 16384] = (torch.randn((min(16384, v - a), d), generator=gen,
                                        device="cuda") / math.sqrt(d))
    return emb


def check_wide_heads(torch, timer):
    """nemotron-4-340b's head width: D 18432, V 256000, bf16 (W 9.44 GB;
    each plain version's f32 copy of W is 18.9 GB).  The argmax head at B
    1 and 8, the verify head at B 8, T 8 and the top-k head at B 8, k 8
    against their plain versions at the existing tolerances (the verify
    head's ids where the plain top-2 gap is decided, its accept where
    every drafted position is), each timed beside its library call and
    its bound."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    v, d = 256000, 18432
    gen = torch.Generator(device="cuda").manual_seed(13)
    emb = wide_weight(torch, gen, v, d)
    w = emb.t()
    rows = {}

    def timed(tag, kern_fn, lib_fn, nrows, out_bytes):
        kern = timer.readings(kern_fn)
        lib = timer.readings(lib_fn, "library_")
        bound_ms, bound_by = bound(v * d * 2 + nrows * d * 2 + out_bytes,
                                   2.0 * nrows * d * v, BF16_FLOPS_PER_S)
        print(f"wide head {tag}: kernel {shown(kern)}, library "
              f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        return dict(**kern, bound_ms=bound_ms, bound_by=bound_by, **lib)

    for b in (1, 8):
        h = torch.randn((b, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        idx, val = fah.fused_argmax_head_with_value(h, w)
        torch.cuda.synchronize()
        idx_ok, val_ok, err, _ = argmax_verdict(torch, h, w, idx, val)
        print(f"wide head argmax B={b} (D {d}, V {v}): idx "
              f"{'ok' if idx_ok else 'FAIL'}, val max_abs_err {err:.6g} "
              f"(rtol {HEAD_RTOL}): {'ok' if val_ok else 'FAIL'}",
              flush=True)
        check(idx_ok and val_ok, f"wide argmax head B={b} disagrees with "
              "its plain version")
        rows[f"argmax_B{b}"] = dict(max_abs_err=err, **timed(
            f"argmax B={b}", lambda: fah.fused_argmax_head_with_value(h, w),
            lambda: torch.argmax(h @ w, dim=-1), b, 8 * b))

    b, t = 8, 8
    h = torch.randn((b, t, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    rids, _ = ref.verify_draft(h, w, torch.full(
        (b, t - 1), -1, dtype=torch.int32, device="cuda"))
    cand = rids[:, :t - 1].clone()
    cand[::3, 2] = (cand[::3, 2] + 1) % v              # wrong drafts
    cand[1::4, 4:] = -1                                # ragged widths
    ids, acc = fah.fused_verify_head(h, w, cand)
    torch.cuda.synchronize()
    rids, racc = ref.verify_draft(h, w, cand)
    top2 = torch.matmul(h.view(b * t, d).float(), w.float()).topk(
        2, dim=-1).values
    decided = ((top2[:, 0] - top2[:, 1])
               > HEAD_RTOL * top2[:, 0].abs()).view(b, t)
    ids_ok = bool(((ids == rids) | ~decided).all())
    acc_ok = bool(((acc == racc) | ~decided.all(dim=1)).all())
    print(f"wide head verify B={b} T={t}: ids {'ok' if ids_ok else 'FAIL'} "
          f"({int(decided.sum())}/{b * t} decided), accept "
          f"{'ok' if acc_ok else 'FAIL'} ({acc.tolist()})", flush=True)
    check(ids_ok and acc_ok, "wide verify head disagrees with its plain "
          "version")
    h2 = h.view(b * t, d)
    rows["verify_B8_T8"] = dict(decided=int(decided.sum()), **timed(
        f"verify B={b} T={t}", lambda: fah.fused_verify_head(h, w, cand),
        lambda: torch.argmax(h2 @ w, dim=-1), b * t, 12 * b * t))

    h = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    plan = ftk.topk_plan(8, d, v, torch.bfloat16, *fah.device_limits(0))
    vals, idxs = ftk.fused_topk_head(h, w, 8)
    torch.cuda.synchronize()
    tv = topk_verdict(torch, h, w, 8, vals, idxs)
    print(f"wide head top-k B=8 k=8 ({plan.row_block} rows per block, "
          f"{plan.row_blocks} row chunks): {topk_line(tv)}", flush=True)
    check(tv["idx_ok"] and tv["ties_ok"] and tv["desc_ok"] and tv["val_ok"],
          "wide top-k head disagrees with its plain version")
    rows["topk_B8_k8"] = dict(max_abs_err=tv["err"], **timed(
        "top-k B=8 k=8", lambda: ftk.fused_topk_head(h, w, 8),
        lambda: torch.topk(h @ w, 8, dim=-1), 8, 64),
        row_block=plan.row_block)
    del emb, w
    torch.cuda.empty_cache()
    return rows


def device_kernels(torch, fn, seen, attempts=8) -> list:
    """Names of the device kernels a profiler trace saw ``fn`` launch.
    ``fn`` runs once first, so that its kernels' lazy loading happens
    outside the trace (a first launch can go unrecorded).  A trace can
    also lose its first kernel, so each trace launches a small add
    before ``fn``; a trace with no device event whose name holds ``seen``
    is the profiler's miss, not an answer: ``fn`` is traced again, up to
    ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad.add_(1)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if any(seen in n for n in names):
            break
    if attempt:
        print(f"  (the profiler missed {seen!r} in {attempt} of "
              f"{attempt + 1} traces)", flush=True)
    return names


def flash_routes(torch) -> dict:
    """The kernel flash attention ran per (dtype, head dim), read from a
    profiler trace of one call: bf16 must run the tensor-core kernel
    (``flash_attention_mma_kernel``) at every head dim, f32 the CUDA-core
    one (``flash_attention_kernel``)."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    routes = {}
    for dt, want in ((torch.bfloat16, "mma.sync"),
                     (torch.float32, "cuda-core")):
        for hd in (16, 32, 64, 128, 192, 256):
            q, k, v = (torch.randn((1, h, 64, hd), generator=gen,
                                   device="cuda").to(dt) for h in (2, 1, 1))
            names = [n for n in device_kernels(
                torch, lambda: fa.flash_attention(q, k, v),
                "flash_attention") if "flash_attention" in n]
            mma = [n for n in names if "flash_attention_mma_kernel" in n]
            core = [n for n in names if "flash_attention_kernel" in n]
            tag = f"{str(dt).replace('torch.', '')} hd {hd}"
            route = ("mma.sync" if mma and not core else
                     "cuda-core" if core and not mma else f"? {names}")
            routes[tag] = route
            print(f"flash_attention route {tag}: {route} (ran "
                  f"{', '.join(n[:60] for n in names)})", flush=True)
            check(route == want, f"flash attention {tag} ran {names}, not "
                  f"the {want} kernel")
    return routes


def check_flash_attention(torch, timer):
    """Flash attention at the prefill's shapes: one prompt (B 1) of T = S
    in {71, 512} tokens, qwen3-0.6b's 16 query / 8 KV heads of hd 128,
    bf16, causal; then g 8 (64 / 8 heads, qwen3-32b's) and a causal
    window of 128, both at 512.  Operands are the transposed (B, T, H,
    hd) views the layer passes.  Yardstick: SDPA on the same views.
    Returns the rows and ``flash_routes``' kernels per (dtype, hd)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    routes = flash_routes(torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, t, hq, hkv, window in (("T71", 71, 16, 8, None),
                                     ("T512", 512, 16, 8, None),
                                     ("T512_g8", 512, 64, 8, None),
                                     ("T512_w128", 512, 16, 8, 128)):
        hd = 128

        def rand(heads):
            return torch.randn((1, t, heads, hd), generator=gen,
                               device="cuda").to(torch.bfloat16).transpose(
                                   1, 2)

        q, k, v = rand(hq), rand(hkv), rand(hkv)
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, causal=True, window=window)
        check(bool(torch.isfinite(out).all()), f"flash {name}: non-finite")
        err = (out.float() - want.float()).abs().max().item()
        ok = torch.allclose(out.float(), want.float(), atol=FA_TOL,
                            rtol=FA_TOL)
        print(f"flash_attention {name}: max_abs_err {err:.6g} vs plain "
              f"(atol = rtol = {FA_TOL}): {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"flash attention {name} disagrees with its plain version")
        check_repeatable(torch, lambda: fa.flash_attention(
            q, k, v, causal=True, window=window), f"flash_attention {name}")

        idx = torch.arange(t, device="cuda")
        mask = idx[None, :] <= idx[:, None]
        if window is not None:
            mask &= idx[None, :] > idx[:, None] - window
        sdpa = (dict(is_causal=True) if window is None
                else dict(attn_mask=mask))
        kern = timer.readings(lambda: fa.flash_attention(
            q, k, v, causal=True, window=window))
        plain_ms = timer(lambda: ref.flash_attention(q, k, v, causal=True,
                                                     window=window))
        lib = timer.readings(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **sdpa), "library_")
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * hd * hq * int(mask.sum())
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        print(f"flash_attention {name}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, sdpa {shown(lib, 'library_')}, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.3f} GFLOP)", flush=True)
        rows[name] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows, routes


def unit_errors(torch, x, lab, m, l, p, loss):
    """Max abs errors of the unit kernels' outputs against their plain
    versions on (x, lab), after checking each within its tolerance
    (``p`` None: online_softmax not run)."""
    from repro_torch.kernels import ref

    rm, rl = ref.softmax_stats(x)
    checks = [("softmax_stats m", m, rm, UNIT_ATOL),
              ("softmax_stats l", l, rl, UNIT_ATOL),
              ("fused_xent", loss, ref.fused_xent(x, lab), XENT_ATOL)]
    if p is not None:
        checks.append(("online_softmax", p, ref.online_softmax(x),
                       UNIT_ATOL))
    errs = {}
    for what, got, want, atol in checks:
        ok = torch.allclose(got, want, rtol=UNIT_RTOL, atol=atol)
        errs[what] = (got - want).abs().max().item()
        print(f"  {what}: max_abs_err {errs[what]:.6g} (rtol {UNIT_RTOL}, "
              f"atol {atol}): {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{what} disagrees with its plain version")
    out = {"softmax_stats": max(errs["softmax_stats m"],
                                errs["softmax_stats l"]),
           "fused_xent": errs["fused_xent"]}
    if p is not None:
        sums = p.sum(-1)
        check(bool(((sums - 1).abs() <= 1e-5).all()),
              "online_softmax rows do not sum to 1 within 1e-5")
        out["online_softmax"] = errs["online_softmax"]
    return out


def split_errors(torch, x, lab, m, l, loss, rows) -> float:
    """The stats and the cross-entropy of the first ``rows`` rows against
    their split models (``softmax_stats_split``, ``fused_xent_split``:
    the kernels' own fold and merge order) at the unit tolerances; the
    max abs error."""
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ref

    xs, ls = x[:rows], lab[:rows]
    plan = osm.plan_of(x)
    sm, sl = ref.softmax_stats_split(xs, plan)
    sx = ref.fused_xent_split(xs, ls, plan)
    errs = {}
    for what, got, want, atol in (("m", m[:rows], sm, UNIT_ATOL),
                                  ("l", l[:rows], sl, UNIT_ATOL),
                                  ("loss", loss[:rows], sx, XENT_ATOL)):
        errs[what] = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=UNIT_RTOL, atol=atol),
              f"{what} of rows :{rows} disagrees with its split model")
    print(f"  softmax_stats / fused_xent vs softmax_stats_split / "
          f"fused_xent_split (rows :{rows}): max_abs_err m "
          f"{errs['m']:.6g}, l {errs['l']:.6g}, loss {errs['loss']:.6g}: ok",
          flush=True)
    return max(errs.values())


UNIT_KERNELS = ("unit_stats_kernel", "unit_xent_kernel",
                "unit_one_pass_kernel", "normalize_kernel")


def unit_kernels(torch, fn) -> list:
    """The softmax unit's device kernels one call of ``fn`` launched,
    from a profiler trace."""
    return [k for n in device_kernels(torch, fn, "unit_")
            for k in UNIT_KERNELS if k in n]


def unit_route(torch, x, lab, softmax=True) -> dict:
    """The plan of rows x, and the device kernels one call of each
    wrapper ran: softmax_stats and fused_xent (labels ``lab``) one at any
    B, online_softmax (unless ``softmax`` is False) one on the one-pass
    route and two on the other."""
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm

    plan = osm.plan_of(x)
    calls = [("softmax_stats", lambda: osm.softmax_stats(x)),
             ("fused_xent", lambda: fx.fused_xent(x, lab))]
    if softmax:
        calls.append(("online_softmax", lambda: osm.online_softmax(x)))
    kernels = {name: unit_kernels(torch, fn) for name, fn in calls}
    tag = (f"B={x.shape[0]} V={x.shape[1]} "
           f"{str(x.dtype).replace('torch.', '')}")
    print(f"softmax unit {tag}: plan chunk {plan.chunk}, nsplit "
          f"{plan.nsplit}, vec {plan.vec}; online_softmax route "
          f"{plan.route}; device kernels per call: " + "; ".join(
              f"{n} {len(k)} ({', '.join(k)})" for n, k in kernels.items()),
          flush=True)
    want = {"softmax_stats": ["unit_stats_kernel"],
            "fused_xent": ["unit_xent_kernel"]}
    if softmax:
        want["online_softmax"] = (
            ["unit_one_pass_kernel"] if plan.route == osm.ONE_PASS
            else ["unit_stats_kernel", "normalize_kernel"])
    check({n: sorted(k) for n, k in kernels.items()}
          == {n: sorted(k) for n, k in want.items()},
          f"softmax unit {tag}: device kernels {kernels}, want {want}")
    return dict(route=plan.route, chunk=plan.chunk, nsplit=plan.nsplit,
                vec=plan.vec, device_kernels_per_call={
                    n: len(k) for n, k in kernels.items()})


def check_softmax_units(torch, timer):
    """The softmax unit's kernels on (B, V = 151936) rows: B 12 in f32
    (the unit path's logits), B 512 in bf16 and B 4,096 in bf16 (one
    4k-token training sequence; softmax_stats and fused_xent only), each
    call's plan, route and device kernels, the stats and the
    cross-entropy against their split models too (all rows; the first 64
    at B 4,096), and two calls bitwise equal.  Yardsticks
    ``torch.logsumexp``, ``torch.softmax`` and ``F.cross_entropy``; an
    empty launch (``torch.cuda._sleep(1)``) on the same ruler is the floor
    of one launch."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ref

    v = 151936
    gen = torch.Generator(device="cuda").manual_seed(6)
    floor = timer.readings(lambda: torch.cuda._sleep(1))
    print(f"empty launch (torch.cuda._sleep(1)): {shown(floor)}; the card "
          f"holds {osm.device_resident_blocks(0, torch.float32)} one-pass "
          f"blocks (f32), {osm.device_resident_blocks(0, torch.bfloat16)} "
          f"(bf16) at once", flush=True)
    rows = {"floor": floor}
    for b, dtype in ((12, torch.float32), (512, torch.bfloat16),
                     (4096, torch.bfloat16)):
        softmax = b < 4096
        x = (torch.randn((b, v), generator=gen, device="cuda") * 4).to(dtype)
        lab = torch.randint(0, v, (b,), generator=gen, device="cuda")
        m, l = osm.softmax_stats(x)
        p = osm.online_softmax(x) if softmax else None
        loss = fx.fused_xent(x, lab)
        torch.cuda.synchronize()
        tag = f"B={b} {str(dtype).replace('torch.', '')}"
        print(f"softmax unit {tag}:", flush=True)
        errs = unit_errors(torch, x, lab, m, l, p, loss)
        split_err = split_errors(torch, x, lab, m, l, loss,
                                 b if softmax else 64)
        plan = unit_route(torch, x, lab, softmax)
        check_repeatable(torch, lambda: torch.stack(osm.softmax_stats(x)),
                         f"softmax_stats {tag}")
        check_repeatable(torch, lambda: fx.fused_xent(x, lab),
                         f"fused_xent {tag}")
        if softmax:
            check_repeatable(torch, lambda: osm.online_softmax(x),
                             f"online_softmax {tag} ({plan['route']})")
        del p
        el, n = x.element_size(), b * v
        cases = [
            ("softmax_stats", lambda: osm.softmax_stats(x),
             lambda: ref.softmax_stats(x),
             lambda: torch.logsumexp(x, dim=-1), n * el + 8 * b, 4 * n),
            ("fused_xent", lambda: fx.fused_xent(x, lab),
             lambda: ref.fused_xent(x, lab),
             lambda: F.cross_entropy(x, lab, reduction="none"),
             n * el + 12 * b, 4 * n)]
        if softmax:
            cases.append((
                "online_softmax", lambda: osm.online_softmax(x),
                lambda: ref.online_softmax(x),
                lambda: torch.softmax(x, dim=-1, dtype=torch.float32),
                n * el + 4 * n + 8 * b, 6 * n))
        for name, kern, plain, lib, nbytes, flops in cases:
            kern_t, plain_ms = timer.readings(kern), timer(plain)
            lib_t = timer.readings(lib, "library_")
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS_PER_S)
            print(f"{name} {tag}: kernel {shown(kern_t)}, plain "
                  f"{plain_ms:.4f} ms, library {shown(lib_t, 'library_')}, "
                  f"bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{nbytes / 1e6:.3f} MB)", flush=True)
            rows[(name, b)] = dict(max_abs_err=errs[name], **kern_t,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, **lib_t, plan=plan)
            if name != "online_softmax":
                rows[(name, b)]["split_max_abs_err"] = split_err
        del x, lab, m, l, loss
        torch.cuda.empty_cache()
    return rows


def check_xent_backward_memory(torch) -> dict:
    """``ops.softmax_xent``'s backward at 4,096 rows of 151,936 bf16: the
    bytes it allocates beyond what is live before it (at most the f32
    probabilities and the bf16 gradient, 3.73 GB; the 4.0 GB limit leaves
    room for the label indices), and its gradient against autograd
    through the plain version (bf16: a step of bf16, 1e-2, as the card
    tests take it)."""
    from repro_torch.kernels import ops, ref

    b, v = 4096, 151936
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = (torch.randn((b, v), generator=gen, device="cuda") * 4).to(
        torch.bfloat16)
    lab = torch.randint(0, v, (b,), generator=gen, device="cuda")
    xg = x.clone().requires_grad_(True)
    loss = ops.softmax_xent(xg, lab).mean()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loss.backward()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    xr = x.clone().requires_grad_(True)
    ref.fused_xent(xr, lab).mean().backward()
    err = (xg.grad.float() - xr.grad.float()).abs().max().item()
    ok = torch.allclose(xg.grad.float(), xr.grad.float(), rtol=1e-2,
                        atol=UNIT_ATOL)
    print(f"softmax_xent backward B={b} bf16: {extra / 1e9:.4f} GB "
          f"allocated beyond its inputs (limit 4.0; the f32 probabilities "
          f"{4 * b * v / 1e9:.4f} + the bf16 gradient {2 * b * v / 1e9:.4f});"
          f" gradient max_abs_err {err:.6g} vs the plain one (rtol 1e-2, "
          f"atol {UNIT_ATOL}): {'ok' if ok else 'FAIL'}", flush=True)
    check(extra <= 4.0e9, f"softmax_xent backward allocated {extra} bytes")
    check(ok, "softmax_xent backward disagrees with the plain gradient")
    del x, xg, xr, loss
    torch.cuda.empty_cache()
    return {"extra_bytes": extra, "grad_max_abs_err": err}


def check_unit_invariance(torch) -> dict:
    """A row's stats and probabilities are the same bits alone (B 1,
    one-pass), in B 12 (one-pass) and in B 64 (two-launch), and its
    cross-entropy loss alone and in B 12, 64 and 4,096, f32 at V 151936:
    the split follows V alone and every route folds and merges alike."""
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((4096, 151936), generator=gen, device="cuda") * 4
    lab = torch.randint(0, 151936, (4096,), generator=gen, device="cuda")
    runs, routes = {}, {}
    for b in (12, 64):
        routes[b] = osm.plan_of(x[:b]).route
        runs[b] = (*osm.softmax_stats(x[:b]), osm.online_softmax(x[:b]))
    losses = {b: fx.fused_xent(x[:b], lab[:b]) for b in (12, 64, 4096)}
    routes[1] = osm.plan_of(x[:1]).route
    same = {12: 0, 64: 0}
    same_loss = dict.fromkeys(losses, 0)
    for r in range(12):
        alone = (*osm.softmax_stats(x[r:r + 1]),
                 osm.online_softmax(x[r:r + 1]))
        for b in same:
            same[b] += all(torch.equal(a, got[r:r + 1])
                           for a, got in zip(alone, runs[b]))
        loss = fx.fused_xent(x[r:r + 1], lab[r:r + 1])
        for b in same_loss:
            same_loss[b] += torch.equal(loss, losses[b][r:r + 1])
    print(f"softmax unit rows (f32, V 151936): m, l and probabilities "
          f"of B 1 ({routes[1]}) bitwise equal in B 12 ({routes[12]}) for "
          f"{same[12]}/12 rows and in B 64 ({routes[64]}) for "
          f"{same[64]}/12; fused_xent's loss of B 1 bitwise equal in "
          + ", ".join(f"B {b} for {k}/12" for b, k in same_loss.items()),
          flush=True)
    check(routes == {1: osm.ONE_PASS, 12: osm.ONE_PASS,
                     64: osm.TWO_LAUNCH},
          f"softmax unit routes {routes}: want one-pass at B 1 and 12, "
          "two-launch at B 64")
    check(same == {12: 12, 64: 12},
          "softmax unit: a row's bits depend on its batch or route")
    check(all(k == 12 for k in same_loss.values()),
          "fused_xent: a row's loss depends on its batch")
    del x, lab, runs, losses
    torch.cuda.empty_cache()
    return {"routes": {str(b): r for b, r in routes.items()},
            "rows_equal_b12": same[12], "rows_equal_b64": same[64],
            "xent_rows_equal": {str(b): k for b, k in same_loss.items()}}


def check_many_rows(torch):
    """The softmax unit's three wrappers at B 70,000 rows of V 1,000
    (f32): more rows than grid.y holds, one wrapper call each and one
    device kernel each (online_softmax two, on its two-launch route),
    against their plain versions at the unit tolerances.  Logits of scale 1: where the label is the max, m + log
    l - x[label] cancels to about one f32 ulp of m, under XENT_ATOL
    while |m| < 8."""
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm

    b, v = 70000, 1000
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((b, v), generator=gen, device="cuda")
    lab = torch.randint(0, v, (b,), generator=gen, device="cuda")
    n0 = read_launches()
    m, l = osm.softmax_stats(x)
    p = osm.online_softmax(x)
    loss = fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    n1 = read_launches()
    print(f"softmax unit B={b} V={v} f32:", flush=True)
    errs = unit_errors(torch, x, lab, m, l, p, loss)
    check(all(n1[k] - n0[k] == want for k, want in (
        ("softmax_stats", 2), ("online_softmax", 1), ("fused_xent", 1))),
        "the 70,000-row unit calls did not launch once each")
    route = unit_route(torch, x, lab)
    check(osm.plan_of(x).route == osm.TWO_LAUNCH,
          "70,000 rows must take the two-launch route")
    return errs, route


# ---------------------------------------------------------------------------
# Phases 4-6: the main path
# ---------------------------------------------------------------------------
def top2_gap_at(torch, llm, prompt, generated, step):
    """f32 top-2 logit gap and max for the hidden state that chose token
    ``step`` (a one-shot prefill over the prompt and the tokens before
    it)."""
    from repro_torch.models import lm

    eng = llm.engine
    toks = np.concatenate([np.asarray(prompt, np.int64),
                           np.asarray(generated[:step], np.int64)])
    t = torch.as_tensor(toks, device=eng.device)[None]
    h, _ = lm.prefill(eng.params, eng.cfg, t, len(toks))
    logits = torch.matmul(h.float(), lm.lm_head_weight(eng.params,
                                                       eng.cfg).float())
    top2 = logits[0].topk(2).values
    return (top2[0] - top2[1]).item(), top2[0].item()


def stats_now(llm) -> dict:
    """A copy of the engine's counters (``head_calls`` copied too)."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in llm.engine.stats.items()}


def stats_delta(before: dict, after: dict) -> dict:
    """The counters' growth between two ``stats_now`` copies."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = {n: c - before[k].get(n, 0) for n, c in v.items()}
        elif k != "acceptance_rate":
            out[k] = v - before[k]
    if out.get("drafted"):
        out["acceptance_rate"] = out["accepted"] / out["drafted"]
    return out


def latency_ms(t0, stamps) -> dict:
    """TTFT p50 / p99 (first emission after ``t0``, the start of a
    ``generate`` that submits every request at once) and ITL p50 / p99
    (gaps between a request's consecutive emissions) in ms, from each
    request's emit stamps (a consumer's ``time.perf_counter()``)."""
    ttft = [(ts[0] - t0) * 1e3 for ts in stamps]
    itl = [(b - a) * 1e3 for ts in stamps for a, b in zip(ts, ts[1:])]
    return {"ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "itl_ms_p50": float(np.percentile(itl, 50)) if itl else None,
            "itl_ms_p99": float(np.percentile(itl, 99)) if itl else None}


def drive(torch, llm, prompts, plist):
    """One ``LLM.generate`` over ``prompts``: the launch counts are set
    to 0 just before it and read just after.  Returns (outputs, every
    streamed chunk's candidate ids by prompt, launches, stats delta,
    wall seconds); the stats delta also holds ``latency_ms`` of the
    emit stamps a consumer took."""
    cands, stamps = {}, {}

    def collect(chunk):
        stamps.setdefault(chunk.rid, []).append(time.perf_counter())
        cands.setdefault(chunk.rid, []).append(chunk.candidate_ids)

    llm.engine.add_consumer(collect)
    before = stats_now(llm)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        outs = llm.generate(prompts, plist)
        torch.cuda.synchronize()
    finally:
        llm.engine.remove_consumer(collect)
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = stats_delta(before, stats_now(llm))
    st.update(latency_ms(t0, [stamps[o.rid] for o in outs]))
    return outs, [cands[o.rid] for o in outs], launches, st, wall


def compare_streams(torch, llm, prompts, want, got, what,
                    gate=True) -> int:
    """``got`` must equal ``want`` stream by stream, or part from it only
    at a near-tie of the two best f32 logits (gap <= HEAD_RTOL * |max|),
    where the order of the trunk's bf16 sums can decide.  Returns the
    number of identical streams.  With ``gate=False`` it only measures
    and prints (each parting's step and gap): for two bf16 paths that
    compute a prompt's K/V with different arithmetic, whose tokens are
    held to each other in f32 instead (``cross_path_f32``)."""
    same = 0
    for p, o, s in zip(prompts, want, got):
        if o.token_ids == s.token_ids:
            same += 1
            continue
        k = next((i for i, (x, y) in enumerate(zip(o.token_ids,
                                                   s.token_ids)) if x != y),
                 min(len(o.token_ids), len(s.token_ids)))
        if k == min(len(o.token_ids), len(s.token_ids)):
            print(f"{what}: rid {s.rid} stopped at {len(s.token_ids)} "
                  f"tokens where the reference has {len(o.token_ids)}",
                  flush=True)
            check(not gate, f"{what}: rid {s.rid} stopped early or late")
            continue
        gap, top = top2_gap_at(torch, llm, p, o.token_ids, k)
        print(f"{what}: rid {s.rid} diverges at step {k}: top-2 f32 logit "
              f"gap {gap:.6g} (max {top:.6g}, {gap / abs(top):.3g} of it)",
              flush=True)
        check(not gate or gap <= HEAD_RTOL * abs(top),
              f"{what}: streams diverge at a decided step (gap {gap} > "
              f"{HEAD_RTOL}*|{top}|)")
    print(f"{what}: {same}/{len(want)} streams identical"
          + ("" if gate else " (measured, not a gate)"), flush=True)
    return same


def graph_line(llm) -> str:
    """The engine's graph cache: buckets seen and captured, replays,
    capture ms and the pool's reserved MB."""
    g = llm.engine.graphs
    return (f"{len(g.seen)} buckets seen, {g.captures} captures "
            f"({len(g)} buckets), {g.replays} replays, capture "
            f"{g.capture_ms:.1f} ms, pool {g.pool_bytes() / 2 ** 20:.1f} MB")


def drive_graphed(torch, llm, prompts, plist, what):
    """``drive``, graphed: returns its run plus (captures, replays, first
    steps) -- a bucket's first step runs eagerly, its second captures
    and replays -- which must add up to the run's steps."""
    g = llm.engine.graphs
    n0 = (g.captures, g.replays, len(g.seen))
    run = drive(torch, llm, prompts, plist)
    caps, reps, firsts = (b - a for a, b in zip(
        n0, (g.captures, g.replays, len(g.seen))))
    check(firsts + reps == run[3]["decode_steps"],
          f"{what}: the graphed run's steps are not its first steps + "
          "replays")
    return run + (caps, reps, firsts)


def run_counts(run) -> str:
    """A graphed run's first steps, captures and replays, as words."""
    caps, reps, firsts = run[5:8]
    return (f"ran {firsts} first steps eagerly, captured {caps} and "
            f"replayed {reps} steps of {run[3]['decode_steps']}")


def drive_both(torch, llm, prompts, plist, what, replays=True):
    """``drive`` once inside ``eager_steps()`` and once graphed, on the
    same prompts: the token streams must be EQUAL (the graph replays the
    eager step's bits).  Returns (eager run, graphed run), each as
    ``drive`` returns it, the graphed run with ``drive_graphed``'s
    counts (which must include a replay when ``replays``)."""
    from repro_torch.serve import step_graph

    with step_graph.eager_steps():
        eager = drive(torch, llm, prompts, plist)
    graphed = drive_graphed(torch, llm, prompts, plist, what)
    same = sum(a.token_ids == b.token_ids
               for a, b in zip(eager[0], graphed[0]))
    print(f"{what}: graphed vs eager, {same}/{len(prompts)} streams equal; "
          f"the graphed run {run_counts(graphed)}", flush=True)
    check(same == len(prompts),
          f"{what}: the graphed run's tokens differ from the eager run's")
    check(graphed[6] > 0 or not replays,
          f"{what}: the graphed run replayed no step")
    return eager, graphed


def drive_replays(torch, llm, prompts, plist, what, first, more=2):
    """``more`` graphed runs after ``first`` (``drive_both``'s graphed
    run) on the same prompts: the second captures the buckets that the
    first ran once, the last runs no first step and captures nothing,
    so it is every bucket's replay (with one more run, the buckets the
    first run captured must be all it ran).  Every run's tokens must
    equal ``first``'s.  Returns the runs, as ``drive_graphed`` returns
    them."""
    runs = []
    for n in range(2, 2 + more):
        run = drive_graphed(torch, llm, prompts, plist, what)
        print(f"{what}: graphed run {n} {run_counts(run)}", flush=True)
        check([o.token_ids for o in run[0]]
              == [o.token_ids for o in first[0]],
              f"{what}: graphed run {n}'s tokens differ from the first's")
        runs.append(run)
    check(runs[-1][5] == runs[-1][7] == 0, f"{what}: graphed run {n} "
          f"captured {runs[-1][5]} buckets and ran {runs[-1][7]} first "
          "steps")
    return tuple(runs)


def check_main_launches(launches, st, cfg, n_prompts, run):
    """Phase 4's launch checks on one run's counts."""
    from repro_torch.kernels import paged_attention as pa

    want_pa = cfg.n_layers * st["decode_steps"]
    want_fa = cfg.n_layers * st["prefills"]
    want_head = st["decode_steps"] + st["prefills"]
    print(f"main path launches ({run}): paged_attention "
          f"{launches['paged_attention']} (want {cfg.n_layers} x "
          f"{st['decode_steps']} = {want_pa}), flash_attention "
          f"{launches['flash_attention']} (want {cfg.n_layers} x "
          f"{st['prefills']} = {want_fa}), fused_argmax_head "
          f"{launches['fused_argmax_head']} (want {st['decode_steps']} + "
          f"{st['prefills']} = {want_head})", flush=True)
    check(launches["paged_attention"] == want_pa,
          f"{run}: paged attention launches != layers x decode steps")
    check(pa.paged_attention.launches_by_mode["exact"] == want_pa,
          f"{run}: the greedy path launched paged attention in a non-exact "
          "mode")
    check(launches["flash_attention"] == want_fa,
          f"{run}: flash attention launches != layers x prefills")
    check(launches["fused_argmax_head"] == want_head,
          f"{run}: head launches != decode steps + prefills")
    check(launches["fused_topk_head"] == launches["fused_verify_head"] == 0,
          f"{run}: a greedy run launched a top-k or verify kernel")
    check(all(launches[n] == 0 for n in ("softmax_stats", "online_softmax",
                                         "fused_xent")),
          f"{run}: a greedy run launched a softmax-unit kernel")
    check(st["decode_steps"] > 0 and st["prefills"] >= n_prompts,
          f"{run}: the main path ran no decode step or missed a prefill")


def main_line(what, outs, st, wall) -> dict:
    """Print and return one greedy run's end-to-end numbers."""
    n_tok = sum(len(o.token_ids) for o in outs)
    prefill_ms = st["prefill_ms"] / st["prefills"]
    print(f"{what}: {n_tok} tokens generated in {wall:.3f} s = "
          f"{n_tok / wall:.2f} tok/s; {st['decode_steps']} decode steps, "
          f"mean {st['decode_ms'] / st['decode_steps']:.3f} ms/step; "
          f"{st['prefills']} prefills, mean {prefill_ms:.3f} ms, "
          f"{st['prefill_ms']:.1f} ms in all; TTFT p50 "
          f"{st['ttft_ms_p50']:.2f} p99 {st['ttft_ms_p99']:.2f} ms, ITL "
          f"p99 {st['itl_ms_p99']:.2f} ms", flush=True)
    return dict(tok_s=n_tok / wall, tokens=n_tok,
                decode_steps=st["decode_steps"], prefills=st["prefills"],
                decode_ms=st["decode_ms"] / st["decode_steps"],
                prefill_ms=prefill_ms, wall_s=wall,
                **{k: st[k] for k in ("ttft_ms_p50", "ttft_ms_p99",
                                      "itl_ms_p99")})


def run_main_path(torch, prompts, max_new):
    """Phase 4: greedy, once inside ``eager_steps()``, then graphed twice
    on the same prompts (the first run captures its buckets, the second
    replays them all); the three runs' streams must be equal and each
    run's launches hold at layers x steps and steps + prefills."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    t0 = time.perf_counter()
    llm = LLM.from_arch("qwen3-0.6b", smoke=False, seed=0, n_slots=8,
                        max_len=1024)
    torch.cuda.synchronize()
    cfg = llm.cfg
    print(f"main path: qwen3-0.6b {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim}, "
          f"V={cfg.vocab_size}, {cfg.dtype}; weights "
          f"{sum(t.numel() * t.element_size() for t in _leaves(llm.engine.params)) / 1e9:.3f} GB, "
          f"KV pool {sum(p.numel() * p.element_size() for p in llm.engine.store.pools.values()) / 1e9:.3f} GB; "
          f"built in {time.perf_counter() - t0:.1f} s; {len(prompts)} "
          f"prompts of {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens", flush=True)
    params = SamplingParams(max_new_tokens=max_new)
    llm.generate([prompts[0][:16]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()                  # warm-up (cuBLAS, allocator)

    eager, graphed = drive_both(torch, llm, prompts, params, "main path")
    outs, _, launches, st, wall, caps, reps, firsts = graphed
    summary = {"eager": main_line("main path, eager", *(
        eager[i] for i in (0, 3, 4)))}
    check_main_launches(eager[2], eager[3], cfg, len(prompts), "eager")
    summary["graph_first_run"] = main_line("main path, graphed run 1",
                                           outs, st, wall)
    check_main_launches(launches, st, cfg, len(prompts), "graphed")
    print(f"main path graphs after graphed run 1: {graph_line(llm)}",
          flush=True)
    second, again = drive_replays(torch, llm, prompts, params, "main path",
                                  graphed)
    summary["graph_second_run"] = main_line(
        "main path, graphed run 2", second[0], second[3], second[4])
    check_main_launches(second[2], second[3], cfg, len(prompts),
                        "graphed run 2")
    summary["graph"] = main_line("main path, graphed run 3 (replays only)",
                                 again[0], again[3], again[4])
    check_main_launches(again[2], again[3], cfg, len(prompts),
                        "graphed run 3")
    print(f"main path graphs after graphed run 3: {graph_line(llm)}",
          flush=True)
    summary["graph_first_run"].update(captures=caps, replays=reps,
                                      first_steps=firsts)
    summary["graph_second_run"].update(captures=second[5],
                                       replays=second[6])
    summary["graph"].update(captures=again[5], replays=again[6])
    for o in outs:
        check(1 <= len(o.token_ids) <= max_new
              and o.finish_reason in ("length", "eos")
              and all(0 <= x < cfg.vocab_size for x in o.token_ids),
              f"bad output for rid {o.rid}: {o.finish_reason} "
              f"{o.token_ids}")
    return llm, outs, launches, summary


def sampled_params(max_new):
    """Phase 4b's request kinds and their params, one per prompt."""
    from repro_torch.serve.params import SamplingParams

    kinds = ["greedy", "topk", "greedy", "topk", "cands", "temp"] * 2
    plist = [SamplingParams(max_new_tokens=max_new) if kind == "greedy" else
             SamplingParams(max_new_tokens=max_new, top_k=8,
                            temperature=0.8, seed=r) if kind == "topk" else
             SamplingParams(max_new_tokens=max_new, n_candidates=4)
             if kind == "cands" else
             SamplingParams(max_new_tokens=max_new, head_mode="temperature",
                            seed=r)
             for r, kind in enumerate(kinds)]
    return kinds, plist


def attention_layers(llm) -> tuple:
    """(paged-attention launches a decode step, flash-attention launches
    a one-shot prefill) of ``llm``'s engine: its attention layers (an
    ``attn`` or ``moe`` layer's), each paged when the store pages (a
    windowed config's ring buffers are never paged: 0 a step)."""
    from repro_torch.models import lm

    n = lm.kv_layers(llm.cfg)
    return (n if llm.engine.store.any_paged else 0), n


def run_sampled_path(torch, llm, prompts, greedy_outs, max_new,
                     what="sampled path", gate=True):
    """Phase 4b: the same 12 prompts as a mixed sampled workload -- 4
    greedy, 4 top-k (k 8, temperature 0.8, seeded), 2 greedy with 4
    candidate ids (the top-k bus at sample_k 1), 2 Gumbel-max
    temperature -- through one engine, every kind sharing fused steps
    (fewer prompts take the first kinds of that list).  The greedy rows
    are held to the greedy-only run's streams, or with ``gate`` False
    only measured against them: behind a capacity-dropping MoE layer a
    row's tokens depend on its batch-mates', and the sampled rows' differ
    from the greedy run's."""
    kinds, plist = (x[:len(prompts)] for x in sampled_params(max_new))
    per_step, per_prefill = attention_layers(llm)
    eager, graphed = drive_both(torch, llm, prompts, plist, what)
    for run, (outs, cands, launches, st, wall, *_) in (("eager", eager),
                                                       ("graphed", graphed)):
        calls = st["head_calls"]
        n_tok = sum(len(o.token_ids) for o in outs)
        print(f"{what} ({run}): {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.2f} tok/s; {st['decode_steps']} decode "
              f"steps, mean {st['decode_ms'] / st['decode_steps']:.3f} "
              f"ms/step; head calls {calls}; launches {launches}",
              flush=True)
        want_pa = per_step * st["decode_steps"]
        check(launches["paged_attention"] == want_pa,
              f"{what} ({run}): paged attention launches != paged layers "
              "x steps")
        check(launches["fused_topk_head"] == calls.get("TopK", 0) > 0,
              f"{what} ({run}): top-k launches != top-k head calls "
              "(decode steps and prefills holding a top-k row)")
        check(launches["fused_argmax_head"] == calls.get("Greedy", 0) > 0,
              f"{what} ({run}): argmax launches != greedy head calls")
        check(launches["fused_verify_head"] == 0,
              f"{what} ({run}): a verify kernel ran without "
              "speculation")
        check(launches["flash_attention"] == per_prefill * st["prefills"],
              f"{what} ({run}): flash attention launches != attention "
              "layers x prefills")
        for o, c, kind in zip(outs, cands, kinds):
            check(1 <= len(o.token_ids) <= max_new
                  and all(0 <= x < llm.cfg.vocab_size for x in o.token_ids),
                  f"{what}: bad output for rid {o.rid}: "
                  f"{o.token_ids}")
            if kind == "cands":
                check(all(x is not None and len(x) == 4 and x[0] == t
                          and len(set(x)) == 4
                          for x, t in zip(c, o.token_ids)),
                      f"{what}: bad candidate ids for rid {o.rid}")
            else:
                check(all(x is None for x in c),
                      f"{what}: rid {o.rid} got candidate ids")
    greedy = [r for r, kind in enumerate(kinds) if kind == "greedy"]
    compare_streams(torch, llm, [prompts[r] for r in greedy],
                    [greedy_outs[r] for r in greedy],
                    [outs[r] for r in greedy],
                    f"{what}, greedy rows vs the greedy-only run", gate=gate)
    eager_st = eager[3]
    return launches, dict(tok_s=n_tok / wall, tokens=n_tok,
                          decode_steps=st["decode_steps"],
                          decode_ms=st["decode_ms"] / st["decode_steps"],
                          eager_decode_ms=eager_st["decode_ms"]
                          / eager_st["decode_steps"],
                          eager_tok_s=sum(len(o.token_ids) for o in eager[0])
                          / eager[4], captures=graphed[5],
                          first_steps=graphed[7],
                          head_calls=calls)


class ReplayDrafter:
    """Drafts the continuation of a known stream (prompt + its spec_k=0
    tokens) wherever the history follows it, so every step drafts its
    whole window; records the widest proposal."""

    def __init__(self, stream):
        self.stream, self.widest = list(stream), 0

    def propose(self, history, k):
        n = len(history)
        out = (self.stream[n:n + k] if list(history) == self.stream[:n]
               else [])
        self.widest = max(self.widest, len(out))
        return out


def run_spec_path(torch, llm, lengths, max_new):
    """Phase 4c: 12 repetitive prompts (a random 32-token phrase repeated
    to each of the main path's lengths), greedy, at spec_k = 0 and then
    spec_k = 4; then one request at spec_k = 20 whose drafter replays the
    spec_k = 0 stream, so its 21-token windows make T = 32 and so 64
    query rows per KV head in paged attention.  Returns the kernel
    launches, the summary and (the prompts, the spec_k = 0 outputs)."""
    from repro_torch.serve.params import SamplingParams

    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, llm.cfg.vocab_size, size=32),
                       n // 32 + 1)[:n].astype(np.int32) for n in lengths]
    beager, based = drive_both(torch, llm, prompts,
                               SamplingParams(max_new_tokens=max_new),
                               "spec path, spec_k=0")
    base = based[0]
    sp4 = SamplingParams(max_new_tokens=max_new, spec_k=4)
    seager, sgraph = drive_both(torch, llm, prompts, sp4,
                                "spec path, spec_k=4")
    _, sagain = drive_replays(torch, llm, prompts, sp4,
                              "spec path, spec_k=4", sgraph)
    n_base = sum(len(o.token_ids) for o in base)
    for run, spec0, spec4 in (("eager", beager, seager),
                              ("graphed run 1", based, sgraph),
                              ("graphed run 3, replays only", based,
                               sagain)):
        outs, _, launches, st, wall = spec4[:5]
        bst, bwall = spec0[3], spec0[4]
        calls = st["head_calls"]
        n_tok = sum(len(o.token_ids) for o in outs)
        print(f"spec path ({run}): spec_k=0 {n_base} tokens in {bwall:.3f} "
              f"s = {n_base / bwall:.2f} tok/s, {bst['decode_steps']} decode "
              f"steps at {bst['decode_ms'] / bst['decode_steps']:.3f} ms; "
              f"spec_k=4 {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.2f} tok/s, {st['decode_steps']} decode steps "
              f"at {st['decode_ms'] / st['decode_steps']:.3f} ms, drafted "
              f"{st['drafted']}, accepted {st['accepted']}, acceptance_rate "
              f"{st.get('acceptance_rate', 0.0):.4f}; head calls {calls}; "
              f"launches {launches}", flush=True)
        check(st["drafted"] > 0, f"spec path ({run}): nothing was drafted")
        check(launches["fused_verify_head"] == calls.get("verify", 0) > 0,
              f"spec path ({run}): verify launches != decode steps with a "
              "draft row")
        check(launches["fused_argmax_head"] == calls.get("Greedy", 0),
              f"spec path ({run}): argmax launches != greedy head calls")
        check(launches["paged_attention"] == llm.cfg.n_layers
              * st["decode_steps"], f"spec path ({run}): paged attention "
              "launches != layers x decode steps")
        check(launches["flash_attention"]
              == llm.cfg.n_layers * st["prefills"],
              f"spec path ({run}): flash attention launches != layers x "
              "prefills")
    ms = {run: r[3]["decode_ms"] / r[3]["decode_steps"]
          for run, r in (("eager", seager), ("first", sgraph),
                         ("replays", sagain))}
    print(f"spec path, spec_k=4 ms/step: graphed replays only "
          f"{ms['replays']:.3f}, graphed run 1 {ms['first']:.3f}, eager "
          f"{ms['eager']:.3f}", flush=True)
    check(ms["replays"] < ms["eager"], "spec path: the graphed spec_k=4 "
          "step (replays only) is not faster than the eager one")
    same = compare_streams(torch, llm, prompts, base, outs,
                           "spec path, spec_k=4 vs spec_k=0")

    drafter = llm.engine.drafter
    llm.engine.drafter = ReplayDrafter(
        [int(t) for t in prompts[0]] + list(base[0].token_ids))
    try:
        _, wide_run = drive_both(
            torch, llm, prompts[:1], SamplingParams(max_new_tokens=max_new,
                                                    spec_k=20),
            "spec path, spec_k=20", replays=False)
        wide, _, wl, wst = wide_run[:4]
        widest = llm.engine.drafter.widest
    finally:
        llm.engine.drafter = drafter
    print(f"spec path: spec_k=20, widest draft {widest} (T = 32 from 16), "
          f"drafted {wst['drafted']}, accepted {wst['accepted']}, verify "
          f"launches {wl['fused_verify_head']}", flush=True)
    check(widest >= 16, "spec path: the spec_k=20 request never drafted "
          "16 tokens, so no step had T * g > 32")
    check(wl["fused_verify_head"] == wst["head_calls"].get("verify", 0) > 0,
          "spec path: spec_k=20 verify launches != its draft steps")
    compare_streams(torch, llm, prompts[:1], base[:1], wide,
                    "spec path, spec_k=20 vs spec_k=0")
    outs, _, launches, st, wall = sgraph[:5]
    bst, bwall = based[3], based[4]
    n_tok = sum(len(o.token_ids) for o in outs)
    return launches, dict(
        tok_s=n_tok / wall, tok_s_spec0=n_base / bwall, tokens=n_tok,
        decode_steps=st["decode_steps"],
        decode_steps_spec0=bst["decode_steps"],
        decode_ms=ms["first"], decode_ms_spec0=bst["decode_ms"]
        / bst["decode_steps"], decode_ms_replays=ms["replays"],
        tok_s_replays=n_tok / sagain[4], captures=sgraph[5],
        first_steps=sgraph[7], drafted=st["drafted"],
        accepted=st["accepted"],
        acceptance_rate=st["accepted"] / st["drafted"],
        eager_decode_ms=ms["eager"], identical_streams=same,
        widest_draft_spec20=widest), (prompts, base)


def profile_decode(torch, llm, prompts, graphed, steps=5):
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    engine iterations of 8 rows in pure decode (every request admitted
    beforehand, and one more step run first, so a graphed window only
    replays), eager (inside ``eager_steps()``) or graphed.  Prints the
    host wall clock per step (profiler on), the device time its kernels
    took, their count, and the kernels that took the most."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import step_graph
    from repro_torch.serve.params import SamplingParams

    run = "graphed" if graphed else "eager"
    eng = llm.engine
    mode = contextlib.nullcontext() if graphed else step_graph.eager_steps()
    with mode:
        for p in prompts[:8]:
            llm.submit(p, SamplingParams(max_new_tokens=steps + 6))
        eng.step()                      # admit all 8, first decode step
        eng.step()                      # a graphed bucket's capture
        torch.cuda.synchronize()
        n_flash = fa.flash_attention.launches
        n_graph = (eng.graphs.captures, eng.graphs.replays)
        counted = (pa.paged_attention.launches,
                   fah.fused_argmax_head_with_value.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        check(fa.flash_attention.launches == n_flash,
              "a pure decode step launched the flash-attention kernel")
        counted = (pa.paged_attention.launches - counted[0],
                   fah.fused_argmax_head_with_value.launches - counted[1])
        replays = eng.graphs.replays - n_graph[1]
        check(eng.graphs.captures == n_graph[0]
              and replays == (steps if graphed else 0),
              f"decode profile ({run}): {replays} replays in {steps} steps")
        while eng.has_work:
            eng.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    busy_ms = sum(by_name.values()) / 1e3 / steps
    if not kernels:
        print(f"decode profile ({run}, 8 rows, {steps} steps, profiler on): "
              f"wall {wall_ms:.3f} ms/step; the profiler recorded no device "
              "time (device busy not measured)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=None, kernels_per_step=None)
    print(f"decode profile ({run}, 8 rows, {steps} steps, profiler on): wall "
          f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels) / steps:.0f} kernels/step", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step  "
              f"{count[name] / steps:5.0f}/step  {name[:80]}", flush=True)
    # paged attention's kernel and its split's combine kernel
    paged = [e for e in kernels if "paged_" in e.name]
    paged_ms = sum(e.time_range.elapsed_us() for e in paged) / 1e3 / steps
    print(f"  paged attention (kernel + combine): {paged_ms:.3f} ms/step in "
          f"{len(paged) / steps:.0f} launches/step", flush=True)
    # the argmax head's two passes
    head = [e for e in kernels if any(n in e.name for n in (
        "argmax_wgmma_partial_kernel", "argmax_partial_kernel",
        "argmax_reduce_kernel"))]
    head_ms = sum(e.time_range.elapsed_us() for e in head) / 1e3 / steps
    print(f"  argmax head (pass 1 + pass 2): {head_ms:.3f} ms/step in "
          f"{len(head) / steps:.0f} launches/step", flush=True)
    # the trace backs the counters (a replay's are its capture's delta):
    # an exact-mode paged call is a fold and a combine, a head call two
    # passes
    print(f"  counted launches in the window: paged_attention "
          f"{counted[0]}, fused_argmax_head {counted[1]}; traced kernels "
          f"{len(paged)} and {len(head)}", flush=True)
    check(len(paged) == 2 * counted[0] == 2 * llm.cfg.n_layers * steps,
          f"decode profile ({run}): {len(paged)} traced paged-attention "
          f"kernels for {counted[0]} counted launches in {steps} steps")
    check(len(head) == 2 * counted[1] == 2 * steps,
          f"decode profile ({run}): {len(head)} traced argmax-head kernels "
          f"for {counted[1]} counted launches in {steps} steps")
    # the RMSNorm's f64 mean (its reduction kernel reads double)
    norm = [e for e in kernels if "reduce_kernel" in e.name
            and "double" in e.name]
    norm_ms = sum(e.time_range.elapsed_us() for e in norm) / 1e3 / steps
    print(f"  f64 reductions (the RMSNorm mean): {norm_ms:.3f} ms/step in "
          f"{len(norm) / steps:.0f} launches/step", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms,
                kernels_per_step=len(kernels) / steps, paged_ms=paged_ms,
                paged_kernels_per_step=len(paged) / steps,
                argmax_head_ms=head_ms,
                argmax_head_kernels_per_step=len(head) / steps,
                f64_reduce_ms=norm_ms,
                f64_reduce_kernels_per_step=len(norm) / steps)


class FixedDrafter:
    """Proposes ``k`` copies of one token, so every step of a spec_k
    request drafts its whole window."""

    def propose(self, history, k):
        return [7] * k


def step_leaves(out) -> list:
    """A step body's (h, outputs) as a flat list of host copies."""
    h, outs = out
    flat = [h]
    for o in outs:
        flat += list(o) if isinstance(o, tuple) else [o]
    return [x.cpu().clone() for x in flat]


def step_bound(torch, eng, plan):
    """The least time one fused step could take on the card: every
    weight read once, each row's K/V history read once (its positions up
    to the step's last query, every layer), at 2 flops per weight and
    row plus 4 * hd per (query, key, head) -- bound(), bf16 peak."""
    cfg = eng.cfg
    b, t = plan.arrays[0].shape
    pos = plan.arrays[1].reshape(b, -1)[:, -1].astype(np.int64) + 1
    w_bytes = sum(x.numel() * x.element_size() for x in _leaves(eng.params))
    n_w = sum(x.numel() for x in _leaves(eng.params))
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2 * int(pos.sum())
    flops = 2 * n_w * b * t + 4 * cfg.head_dim * cfg.n_heads \
        * cfg.n_layers * t * int(pos.sum())
    return bound(w_bytes + kv, flops, BF16_FLOPS_PER_S)


def check_step_graph(torch, llm, prompts) -> dict:
    """Phase 4f: the step as one program.  In three buckets at full width
    -- greedy B 8 T 1; Greedy + TopK + Temperature groups at B 8; every
    row in the verify group at T 8 -- 8 requests are admitted (with one
    eager step), the engine's next step is planned, and its body runs
    eagerly and as a replay of its bucket's graph on the same operands:
    the hidden states and every head output must be equal bit for bit.
    The greedy bucket's replay and its eager body are timed on the same
    operands (call, device and host ms), beside the step's bound; the
    Temperature head's memory and device ms beside the f32 copy of W it
    replaced (the parent's head, ``h.float() @ W.float()``)."""
    import functools

    from repro_torch.models import lm
    from repro_torch.serve import step_graph
    from repro_torch.serve.params import SamplingParams as SP
    from repro_torch.serve.sampler import Temperature

    eng = llm.engine
    mixed = [SP(max_new_tokens=4),
             SP(max_new_tokens=4, top_k=8, temperature=0.8, seed=1),
             SP(max_new_tokens=4, head_mode="temperature", seed=2)]
    cases = {"greedy B8 T1": [SP(max_new_tokens=4)] * 8,
             "mixed B8 T1": (mixed * 3)[:8],
             "verify B8 T8": [SP(max_new_tokens=16, spec_k=7)] * 8}
    timer = Timer(torch)
    out, drafter = {"cases": {}}, eng.drafter
    try:
        for name, plist in cases.items():
            eng.drafter = FixedDrafter() if "verify" in name else drafter
            reqs = [llm.submit(p[:256], sp) for p, sp in zip(prompts, plist)]
            with step_graph.eager_steps():
                eng.step()            # admit all 8, one eager step
            active = [i for i, sl in enumerate(eng.slots) if sl is not None]
            check(len(active) == 8, f"step graph {name}: {len(active)} "
                  "active rows after admission, want 8")
            plan = eng._plan_step(active)
            body = functools.partial(eng._step_body, tuple(plan.order))
            operands = step_graph.to_device(plan.arrays, eng.device)
            want = step_leaves(body(*operands))
            if plan.key not in eng.graphs.graphs:
                eng.graphs.capture(plan.key, body, plan.arrays, eng.device)
            got = step_leaves(eng.graphs.replay(plan.key, plan.arrays))
            err = max((g.double() - w.double()).abs().max().item()
                      for g, w in zip(got, want))
            equal = len(got) == len(want) and all(
                g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got, want))
            print(f"step graph {name}: bucket {plan.key[:3]} samplers "
                  f"{[type(x).__name__ for x in plan.key[3]]} groups "
                  f"{plan.key[4]} verify {plan.key[5]}: hidden states and "
                  f"{len(got) - 1} head outputs replayed vs eager: "
                  f"{'bitwise equal' if equal else 'DIFFER'} (max abs "
                  f"{err:.3g})", flush=True)
            check(equal, f"step graph {name}: the replay's bits differ from "
                  "the eager step's")
            row = dict(bucket=list(plan.key[:3]), groups=list(plan.key[4]),
                       verify=plan.key[5], bitwise_equal=equal,
                       max_abs_err=err)
            if name == "greedy B8 T1":
                row.update(timer.readings(
                    lambda: eng.graphs.replay(plan.key, plan.arrays)))
                plain = timer.readings(lambda: body(*operands), "plain_")
                row.update(plain)
                row["bound_ms"], row["bound_by"] = step_bound(torch, eng,
                                                              plan)
                print(f"step graph {name}: replay {shown(row)}; eager body "
                      f"{shown(row, 'plain_')}; bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']})", flush=True)
            out["cases"][name] = row
            for r in reqs:
                eng.cancel(r)
    finally:
        eng.drafter = drafter

    gen = torch.Generator(device=eng.device).manual_seed(21)
    h = torch.randn(8, eng.cfg.d_model, generator=gen,
                    device=eng.device).to(torch.bfloat16)
    w = lm.lm_head_weight(eng.params, eng.cfg)
    heads = {"Temperature head": lambda: Temperature().head(eng.params,
                                                            eng.cfg, h),
             "f32 copy of W (the parent's head)":
                 lambda: torch.matmul(h.float(), w.float())}
    mem = {}
    for what, fn in heads.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits = fn()
        torch.cuda.synchronize()
        mem[what] = dict(mb=(torch.cuda.max_memory_allocated() - base)
                         / 2 ** 20, **timer.readings(fn), logits=logits)
    new, old = mem.values()
    err = (new["logits"] - old["logits"]).abs().max().item()
    print(f"temperature head at B 8, D {eng.cfg.d_model}, V "
          f"{eng.cfg.vocab_size}: {new['mb']:.2f} MB allocated beyond its "
          f"inputs (limit 64), {shown(new)}; the f32 copy of W: "
          f"{old['mb']:.2f} MB, {shown(old)}; max abs difference "
          f"{err:.3g} (max |logit| {old['logits'].abs().max().item():.4g})",
          flush=True)
    check(new["mb"] <= 64, f"the Temperature head allocated {new['mb']:.1f} "
          "MB: more than 64")
    out["temperature_head"] = {k: {n: v for n, v in m.items()
                                   if n != "logits"}
                               for k, m in (("change", new),
                                            ("f32_copy", old))}
    out["temperature_head"]["max_abs_err"] = err
    print(f"step graph: {graph_line(llm)}", flush=True)
    del timer
    return out


# ---------------------------------------------------------------------------
# Phases 4g-4h: chunked prefill and prefix sharing
# ---------------------------------------------------------------------------
def f32_twin(torch, llm):
    """The main path's weights and config in f32 (``cross_path_f32``)."""
    import dataclasses

    return (_tree_to(llm.engine.params, dtype=torch.float32),
            dataclasses.replace(llm.cfg, dtype="float32"))


def cross_path_f32(torch, twin, prompts, variants, what) -> dict:
    """Tokens of serving paths that compute a prompt's K/V with different
    arithmetic -- one-shot against chunked, at other chunk widths, prefix
    sharing off against on -- held to each other in f32 at full width
    (``twin``): each variant ``(name, engine kwargs, params)`` is served
    on a fresh graphed engine, the first the reference, and every other
    variant's streams must equal its streams or part only at a near-tie
    (``compare_streams``, the gap then the f32 trunk's).  In bf16 such
    paths part far above the near-tie rule (their logits ~0.08 apart,
    each as far from the f32 trunk's: PERF.md), so there the streams are
    only measured.  Returns each variant's identical streams and
    stats."""
    from repro_torch.serve.api import LLM

    params, cfg = twin
    out, ref = {}, None
    for name, kw, plist in variants:
        e = LLM(params, cfg, seed=0, **kw)
        outs = e.generate(prompts, plist)
        torch.cuda.synchronize()
        st = e.engine.snapshot()
        if ref is None:
            ref, same = (name, e, outs), len(outs)
        else:
            same = compare_streams(torch, ref[1], prompts, ref[2], outs,
                                   f"{what}, f32: {name} vs {ref[0]}")
            del e
        out[name] = dict(identical_streams=same, **{k: st[k] for k in (
            "prefill_chunks", "prefill_tokens", "prefix_hits",
            "preemptions", "decode_steps")})
    return out


def check_chunk_launches(launches, st, cfg, what):
    """A chunked run's launch checks: no flash kernel (a chunked engine
    runs no one-shot prefill), paged attention once a layer a step, each
    head kernel once a head call of its kind (``head_calls``; a
    mid-prefill chunk row joins no head group), no softmax-unit kernel,
    and one step an iteration."""
    calls = st["head_calls"]
    want = {"paged_attention": cfg.n_layers * st["decode_steps"],
            "flash_attention": 0,
            "fused_argmax_head": calls.get("Greedy", 0),
            "fused_topk_head": calls.get("TopK", 0),
            "fused_verify_head": calls.get("verify", 0),
            "softmax_stats": 0, "online_softmax": 0, "fused_xent": 0}
    got = {k: launches[k] for k in want}
    print(f"{what}: launches {got}; want {want}; decode_steps "
          f"{st['decode_steps']}, iterations {st['iterations']}", flush=True)
    check(got == want, f"{what}: launches {got} != {want}")
    check(st["decode_steps"] == st["iterations"] > 0,
          f"{what}: decode_steps {st['decode_steps']} != iterations "
          f"{st['iterations']}")


def chunk_line(what, run, llm) -> dict:
    """Print and return one chunked run's end-to-end numbers: tok/s, ms a
    step, TTFT and ITL from the emit stamps, chunk rows, and the graph
    cache's work in the run (``drive_graphed``'s counts)."""
    outs, _, _, st, wall = run[:5]
    n_tok = sum(len(o.token_ids) for o in outs)
    row = dict(tok_s=n_tok / wall, tokens=n_tok, wall_s=wall,
               decode_steps=st["decode_steps"],
               decode_ms=st["decode_ms"] / st["decode_steps"],
               prefill_chunks=st["prefill_chunks"],
               prefill_tokens=st["prefill_tokens"],
               **{k: st[k] for k in ("ttft_ms_p50", "ttft_ms_p99",
                                     "itl_ms_p99")})
    graph = ""
    if len(run) > 5:
        row.update(captures=run[5], replays=run[6], first_steps=run[7],
                   pool_mb=llm.engine.graphs.pool_bytes() / 2 ** 20)
        graph = (f"; {run_counts(run)}, graph pool "
                 f"{row['pool_mb']:.1f} MB")
    print(f"{what}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} "
          f"tok/s; {st['decode_steps']} steps, mean {row['decode_ms']:.3f} "
          f"ms/step; {st['prefill_chunks']} chunk rows, "
          f"{st['prefill_tokens']} prompt tokens; TTFT p50 "
          f"{row['ttft_ms_p50']:.2f} p99 {row['ttft_ms_p99']:.2f} ms, ITL "
          f"p99 {row['itl_ms_p99']:.2f} ms{graph}", flush=True)
    return row


def run_chunked_path(torch, llm, twin, prompts, oneshot, spec_base,
                     max_new):
    """Phase 4g: chunked prefill at full width, on engines that share the
    main path's weights (8 slots, max_len 1024, prefix sharing off so
    that every run computes every chunk).  Phase 4's 12 prompts at
    ``chunk_size=64``: once inside ``eager_steps()``, then graphed three
    times (the third replays every bucket); then at ``chunk_size=16``,
    and at 64 with ``token_budget=128``; then phase 4b's mixed samplers
    and phase 4c's prompts at ``spec_k=4`` on the chunk-64 engine.  The
    graphed runs' tokens equal the eager run's; chunk rows and launches
    at their numbers.  Each run's streams against the one-shot ones
    (phase 4, 4b's greedy rows, 4c's spec_k 0) are measured in bf16 and
    held in f32 (``cross_path_f32``: one-shot, chunk 64, 16, 64 with the
    budget, and spec_k 4 chunked against spec_k 0 one-shot).  Returns
    (the chunk-64 facade, the summary, its graphed run 1's
    launches)."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    cfg = llm.cfg
    sp = SamplingParams(max_new_tokens=max_new)

    def engine(**kw):
        return LLM(llm.engine.params, cfg, n_slots=8, max_len=1024, seed=0,
                   prefix_cache=False, **kw)

    def chunk_rows(c):
        return sum(-(-len(p) // c) for p in prompts)

    def checked(run, what, rows=None):
        outs, _, launches, st = run[:4]
        check_chunk_launches(launches, st, cfg, what)
        check(st["prefills"] == len(outs), f"{what}: {st['prefills']} "
              f"prefills for {len(outs)} prompts")
        check(rows is None or st["prefill_chunks"] == rows,
              f"{what}: {st['prefill_chunks']} chunk rows, want {rows}")

    out = {}
    cllm = engine(chunk_size=64)
    eager, first = drive_both(torch, cllm, prompts, sp, "chunked c64")
    second, third = drive_replays(torch, cllm, prompts, sp, "chunked c64",
                                  first)
    for name, run in (("eager", eager), ("graphed run 1", first),
                      ("graphed run 2", second),
                      ("graphed run 3, replays only", third)):
        checked(run, f"chunked c64 ({name})", chunk_rows(64))
        out[f"c64 {name}"] = chunk_line(f"chunked c64, {name}", run, cllm)
    out["c64 identical to one-shot"] = compare_streams(
        torch, llm, prompts, oneshot, third[0],
        "chunked c64 vs one-shot (phase 4), bf16", gate=False)
    for name, kw, rows in (
            ("c16", dict(chunk_size=16), chunk_rows(16)),
            ("c64 budget 128", dict(chunk_size=64, token_budget=128),
             None)):
        e = engine(**kw)
        run = drive_graphed(torch, e, prompts, sp, f"chunked {name}")
        checked(run, f"chunked {name}", rows)
        check(run[3]["prefill_chunks"] >= chunk_rows(64),
              f"chunked {name}: fewer chunk rows than at width 64")
        out[name] = chunk_line(f"chunked {name}, graphed run 1", run, e)
        out[name]["identical_to_one_shot"] = compare_streams(
            torch, llm, prompts, oneshot, run[0],
            f"chunked {name} vs one-shot (phase 4), bf16", gate=False)
        del e

    kinds, plist = sampled_params(max_new)
    run = drive_graphed(torch, cllm, prompts, plist, "chunked c64 mixed")
    checked(run, "chunked c64 mixed samplers", chunk_rows(64))
    check(run[2]["fused_topk_head"] > 0,
          "chunked c64 mixed samplers: no top-k launch")
    out["c64 mixed"] = chunk_line("chunked c64, mixed samplers", run, cllm)
    greedy = [r for r, kind in enumerate(kinds) if kind == "greedy"]
    compare_streams(torch, llm, [prompts[r] for r in greedy],
                    [oneshot[r] for r in greedy], [run[0][r] for r in greedy],
                    "chunked c64 mixed samplers, greedy rows vs one-shot, "
                    "bf16", gate=False)

    sprompts, sbase = spec_base
    run = drive_graphed(torch, cllm, sprompts,
                        SamplingParams(max_new_tokens=max_new, spec_k=4),
                        "chunked c64 spec_k=4")
    checked(run, "chunked c64 spec_k=4",
            sum(-(-len(p) // 64) for p in sprompts))
    check(run[2]["fused_verify_head"] > 0 and run[3]["drafted"] > 0,
          "chunked c64 spec_k=4: nothing was drafted or verified")
    out["c64 spec_k=4"] = chunk_line("chunked c64, spec_k=4", run, cllm)
    out["c64 spec_k=4"].update(drafted=run[3]["drafted"],
                               accepted=run[3]["accepted"])
    compare_streams(torch, llm, sprompts, sbase, run[0],
                    "chunked c64 spec_k=4 vs one-shot spec_k=0 (phase 4c), "
                    "bf16", gate=False)

    kw = dict(n_slots=8, max_len=1024, prefix_cache=False)
    out["f32"] = cross_path_f32(torch, twin, prompts, [
        ("one-shot", kw, sp), ("c64", dict(chunk_size=64, **kw), sp),
        ("c16", dict(chunk_size=16, **kw), sp),
        ("c64 budget 128", dict(chunk_size=64, token_budget=128, **kw), sp)],
        "chunked prefill")
    out["f32 spec"] = cross_path_f32(torch, twin, sprompts, [
        ("one-shot spec_k=0", kw, sp),
        ("c64 spec_k=4", dict(chunk_size=64, **kw),
         SamplingParams(max_new_tokens=max_new, spec_k=4))],
        "chunked prefill, speculative")
    return cllm, out, first[2]


def check_chunk_bucket(torch, cllm, prompts) -> dict:
    """Phase 4f's fourth bucket, on the chunk-64 engine: six decode rows
    (prompts of 17-64 tokens, each one final chunk, admitted with one
    eager step), a mid-prefill chunk row (the first 64 of a longer
    prompt) and a final chunk row (40 tokens) in one step at B 8, T 64.
    Its body eagerly and as a replay of its bucket's graph on the same
    operands must give the same bits; the replay is timed beside the
    eager body and the step's bound."""
    import functools

    from repro_torch.serve import step_graph
    from repro_torch.serve.params import SamplingParams as SP

    eng = cllm.engine
    sp = SP(max_new_tokens=4)
    longest = max(prompts, key=len)
    check(len(longest) > 64, "4f chunk bucket: no prompt over 64 tokens")
    reqs = [cllm.submit(p[:n], sp) for p, n in zip(
        prompts, (17, 29, 40, 51, 64, 23))]
    with step_graph.eager_steps():
        eng.step()                   # six final chunks: first tokens
    reqs += [cllm.submit(longest, sp), cllm.submit(prompts[6][:40], sp)]
    eng._admit()                     # both in the 64-wide bucket
    active = [i for i, sl in enumerate(eng.slots) if sl is not None]
    for i in active:
        check(eng._ensure_blocks(i, int(eng.slot_pos[i])),
              "4f chunk bucket: a row lost its slot")
    plan = eng._plan_step(active)
    kinds = [("mid-prefill chunk" if w == (None, None) else
              "final chunk" if i in plan.chunks else "decode")
             for i, w in zip(plan.padded, plan.where)]
    check(plan.key[:1] + plan.key[2:3] == (8, 64)
          and kinds.count("mid-prefill chunk") == 1
          and kinds.count("final chunk") == 1 and kinds.count("decode") == 6,
          f"4f chunk bucket: rows {kinds}, key {plan.key[:3]}")
    body = functools.partial(eng._step_body, tuple(plan.order))
    operands = step_graph.to_device(plan.arrays, eng.device)
    want = step_leaves(body(*operands))
    if plan.key not in eng.graphs.graphs:
        eng.graphs.capture(plan.key, body, plan.arrays, eng.device)
    got = step_leaves(eng.graphs.replay(plan.key, plan.arrays))
    err = max((g.double() - w.double()).abs().max().item()
              for g, w in zip(got, want))
    equal = len(got) == len(want) and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    timer = Timer(torch)
    row = dict(bucket=list(plan.key[:3]), groups=list(plan.key[4]),
               verify=plan.key[5], rows=kinds, bitwise_equal=equal,
               max_abs_err=err,
               **timer.readings(lambda: eng.graphs.replay(plan.key,
                                                           plan.arrays)),
               **timer.readings(lambda: body(*operands), "plain_"))
    row["bound_ms"], row["bound_by"] = step_bound(torch, eng, plan)
    del timer
    print(f"step graph chunk B8 T64: bucket {plan.key[:3]} rows {kinds}: "
          f"hidden states and {len(got) - 1} head outputs replayed vs "
          f"eager: {'bitwise equal' if equal else 'DIFFER'} (max abs "
          f"{err:.3g}); replay {shown(row)}; eager body "
          f"{shown(row, 'plain_')}; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    check(equal, "step graph chunk B8 T64: the replay's bits differ from "
          "the eager step's")
    for r in reqs:
        cllm.engine.cancel(r)
    return row


def run_heavy_tail(torch, llm, twin, max_new=8):
    """Phase 4g': the reference's ``chunked_sweep`` trace at full width:
    32 prompts, Zipf(1.5) lengths 16-1024 (numpy seed 13), 4 slots, 8 new
    tokens, one-shot against ``chunk_size`` 16 and 64 (fresh engines,
    prefix sharing off), each served twice graphed (the first run
    captures its buckets, the second mostly replays).  The interactive
    class is the prompts of at most 128 tokens.  Gates on tokens only:
    the two runs of an engine equal, and the three paths' streams held to
    each other in f32 (``cross_path_f32``); in bf16 measured."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    cfg = llm.cfg
    rng = np.random.default_rng(13)
    lens = np.minimum(16 * rng.zipf(1.5, 32), 1024).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    short = lens <= 8 * 16
    sp = SamplingParams(max_new_tokens=max_new)
    print(f"heavy tail: 32 prompts, lengths {sorted(lens.tolist())} "
          f"({int(short.sum())} of <= 128 tokens)", flush=True)
    out, base = {}, None
    for name, kw in (("one-shot", {}), ("c16", dict(chunk_size=16)),
                     ("c64", dict(chunk_size=64))):
        e = LLM(llm.engine.params, cfg, n_slots=4, max_len=1024 + max_new
                + 1, seed=0, prefix_cache=False, **kw)
        runs = [drive_graphed(torch, e, prompts, sp, f"heavy tail {name}")
                for _ in range(2)]
        check([o.token_ids for o in runs[0][0]]
              == [o.token_ids for o in runs[1][0]],
              f"heavy tail {name}: the two runs' tokens differ")
        out[name] = []
        for n, run in enumerate(runs, 1):
            outs, _, launches, st = run[:4]
            if kw:
                check_chunk_launches(launches, st, cfg,
                                     f"heavy tail {name} run {n}")
            else:
                check_main_launches(launches, st, cfg, len(prompts),
                                    f"heavy tail {name} run {n}")
            ttft = np.asarray([o.timing.ttft_ms for o in outs])
            row = chunk_line(f"heavy tail {name}, run {n}", run, e)
            row.update(ttft_short_ms_p50=float(np.percentile(ttft[short], 50)),
                       ttft_short_ms_p99=float(np.percentile(ttft[short], 99)))
            print(f"heavy tail {name}, run {n}: short-class TTFT p50 "
                  f"{row['ttft_short_ms_p50']:.2f} p99 "
                  f"{row['ttft_short_ms_p99']:.2f} ms, ITL p99 "
                  f"{row['itl_ms_p99']:.2f} ms", flush=True)
            out[name].append(row)
        if base is None:
            base = runs[1][0]
        else:
            compare_streams(torch, llm, prompts, base, runs[1][0],
                            f"heavy tail {name} vs one-shot, bf16",
                            gate=False)
        del e, runs
    kw = dict(n_slots=4, max_len=1024 + max_new + 1, prefix_cache=False)
    out["f32"] = cross_path_f32(torch, twin, prompts, [
        ("one-shot", kw, sp), ("c16", dict(chunk_size=16, **kw), sp),
        ("c64", dict(chunk_size=64, **kw), sp)], "heavy tail")
    return out


def prefix_trace(v, seed=21):
    """The reference's ``prefix_sweep`` trace (numpy seed 21): 64 prompts
    that open with one 512-token system prompt plus a suffix of 4-15
    tokens, shuffled among 16 cold prompts of 32-95 tokens.  Returns
    (prompts, shared mask)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, v, 512).astype(np.int32)
    kinds = ["shared"] * 64 + ["cold"] * 16
    rng.shuffle(kinds)
    prompts = [np.concatenate([system, rng.integers(
        0, v, int(rng.integers(4, 16))).astype(np.int32)])
        if kind == "shared" else
        rng.integers(0, v, int(rng.integers(32, 96))).astype(np.int32)
        for kind in kinds]
    return prompts, np.asarray([kind == "shared" for kind in kinds])


def watch_cows(torch, store, verdicts):
    """Check every copy-on-write of ``store`` as it happens: after the
    copy, the new block holds the source's K and V bits in every layer
    and the source (the sibling's, or the trie's) is untouched; one
    verdict per copy."""
    inner = store._cow

    def cow(slot, k):
        old = store.slot_blocks[slot][k]
        if store.allocator.refcount(old) <= 1:
            return inner(slot, k)
        src = {n: p[:, old].clone() for n, p in store.pools.items()}
        inner(slot, k)
        new = store.slot_blocks[slot][k]
        verdicts.append(new != old and all(
            torch.equal(p[:, new], src[n]) and torch.equal(p[:, old], src[n])
            for n, p in store.pools.items()))

    store._cow = cow


def run_prefix_path(torch, llm, twin, max_new=8):
    """Phase 4h: prefix sharing at full width on the reference's
    ``prefix_sweep`` trace -- 64 requests opening with one 512-token
    system prompt plus 4-15 suffix tokens, mixed with 16 cold prompts of
    32-95 tokens (numpy seed 21) -- at ``chunk_size=32``, block 16, 4
    slots, 8 new tokens, ``prefix_cache`` off against on: in bf16 for the
    numbers (fresh graphed engines, each first serving the same trace
    drawn from numpy seed 23 -- another system prompt -- so that the
    timed run finds its buckets captured and none of its prefixes
    cached), and in f32 for the tokens (``cross_path_f32``).  Then the
    reference's composition points on its small shared trace (numpy seed
    22, a 64-token system prompt, every fifth request cold, max_len 96),
    off against on, in f32: ``spec_k=4``, and a pool of 9 blocks that
    forces preemption of a sharer and trie eviction.  Gates: prefill
    tokens computed falling >= 2x, ``prefix_hits > 0``, tokens equal off
    and on (f32) or parting at a near-tie, the pressure point's
    preemptions and evictions, and every copy-on-write bitwise
    (``watch_cows``), including one forced on the trie's blocks after the
    main trace."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    cfg = llm.cfg
    verdicts = []

    def serve(params, cfg, trace, mask, prefix, ml, what, warm=None,
              spec_k=0, **kw):
        e = LLM(params, cfg, n_slots=4, max_len=ml, seed=0, chunk_size=32,
                block_size=16, prefix_cache=prefix, **kw)
        store = e.engine.store
        watch_cows(torch, store, verdicts)
        if warm is not None:
            e.generate(warm, SamplingParams(max_new_tokens=max_new))
        shared_hi = [0]

        def watch(_):
            shared_hi[0] = max(shared_hi[0], store.allocator.n_shared)

        e.engine.add_consumer(watch)
        run = drive_graphed(torch, e, trace, SamplingParams(
            max_new_tokens=max_new, spec_k=spec_k), what)
        e.engine.remove_consumer(watch)
        outs, _, launches, st = run[:4]
        check_chunk_launches(launches, st, cfg, what)
        snap = e.engine.snapshot()
        ttft = np.asarray([o.timing.ttft_ms for o in outs])
        row = chunk_line(what, run, e)
        row.update(ttft_shared_ms_p50=float(np.percentile(ttft[mask], 50)),
                   ttft_shared_ms_p99=float(np.percentile(ttft[mask], 99)),
                   prefix_hits=st["prefix_hits"],
                   prefix_hit_tokens=st["prefix_hit_tokens"],
                   cow_copies=snap["cow_copies"],
                   shared_blocks_max=shared_hi[0],
                   peak_in_use=snap["peak_in_use"],
                   preemptions=st["preemptions"],
                   prefix_evictions=store.prefix_evictions)
        return row, outs, e

    prompts, mask = prefix_trace(cfg.vocab_size)
    warm = prefix_trace(cfg.vocab_size, seed=23)[0]
    ml = 512 + 16 + max_new + 8
    params = llm.engine.params
    off, off_outs, e = serve(params, cfg, prompts, mask, False, ml,
                             "prefix off", warm)
    del e
    on, on_outs, e = serve(params, cfg, prompts, mask, True, ml,
                           "prefix on", warm)
    # one forced copy-on-write on the card's pools: a slot adopts the
    # cached system prompt and rewinds into its last shared block
    store = e.engine.store
    n0 = len(verdicts)
    hit = store.adopt_prefix(0, prompts[int(np.argmax(mask))])
    check(hit >= 512 - 16, f"4h: the trie held {hit} tokens of the system "
          "prompt after the trace")
    store.rewind(0, hit - 3)
    store.release(0)
    check(len(verdicts) == n0 + 1, "4h: the forced rewind made no copy")
    del e
    same = compare_streams(torch, llm, prompts, off_outs, on_outs,
                           "prefix on vs off, bf16", gate=False)
    savings = off["prefill_tokens"] / max(on["prefill_tokens"], 1)
    print(f"prefix trace: 64 x 512-token system prompt + 16 cold "
          f"(chunk 32, block 16, 4 slots): prefill tokens "
          f"{off['prefill_tokens']} off, {on['prefill_tokens']} on "
          f"({savings:.2f}x); shared-class TTFT p50 "
          f"{off['ttft_shared_ms_p50']:.2f} off, "
          f"{on['ttft_shared_ms_p50']:.2f} on ms; hits {on['prefix_hits']} "
          f"({on['prefix_hit_tokens']} tokens); cow_copies "
          f"{on['cow_copies']}; shared blocks at most "
          f"{on['shared_blocks_max']}; peak in use {off['peak_in_use']} "
          f"off, {on['peak_in_use']} on", flush=True)
    check(savings >= 2.0, f"prefix sharing saved only {savings:.2f}x "
          "prefill tokens (< 2x)")
    check(on["prefix_hits"] > 0, "prefix sharing: no hit")
    out = dict(off=off, on=on, savings=savings,
               identical_streams_bf16=same)
    kw = dict(n_slots=4, max_len=ml, chunk_size=32, block_size=16)
    sp = SamplingParams(max_new_tokens=max_new)
    out["f32"] = cross_path_f32(torch, twin, prompts, [
        ("off", dict(prefix_cache=False, **kw), sp),
        ("on", dict(prefix_cache=True, **kw), sp)], "prefix sharing")
    check(out["f32"]["on"]["prefix_hits"] > 0, "prefix sharing, f32: no hit")

    # the reference's small composition trace: every fifth request cold
    rng = np.random.default_rng(22)
    system = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    small = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
             if i % 5 == 4 else np.concatenate([system, rng.integers(
                 0, cfg.vocab_size, int(rng.integers(4, 12))).astype(
                     np.int32)]) for i in range(10)]
    small_mask = np.asarray([i % 5 != 4 for i in range(10)])
    params32, cfg32 = twin
    for name, kw in (("spec_k4", dict(spec_k=4)),
                     ("pressure", dict(num_blocks=9))):
        o, o_outs, e = serve(params32, cfg32, small, small_mask, False, 96,
                             f"prefix {name} off, f32", **kw)
        n, n_outs, e2 = serve(params32, cfg32, small, small_mask, True, 96,
                              f"prefix {name} on, f32", **kw)
        del e2
        compare_streams(torch, e, small, o_outs, n_outs,
                        f"prefix {name}, f32: on vs off")
        del e
        print(f"prefix {name}, f32: hits {n['prefix_hits']}, prefill "
              f"tokens {o['prefill_tokens']} off, {n['prefill_tokens']} on; "
              f"preemptions {n['preemptions']}, trie evictions "
              f"{n['prefix_evictions']}, cow_copies {n['cow_copies']}",
              flush=True)
        check(n["prefix_hits"] > 0, f"prefix {name}: no hit")
        if name == "pressure":
            check(n["preemptions"] >= 1 and n["prefix_evictions"] >= 1,
                  "prefix pressure point: no preemption or no eviction")
        out[name] = dict(off=o, on=n)
    print(f"prefix path: {len(verdicts)} copies-on-write, "
          f"{sum(verdicts)} bitwise (copy == source, source untouched, "
          f"every layer, K and V)", flush=True)
    check(all(verdicts) and len(verdicts) >= 1,
          "prefix path: a copy-on-write was not bitwise")
    out["cow_checked"] = len(verdicts)
    return out


# ---------------------------------------------------------------------------
# Phase 4i: the device-resident loop (host_stride) and keyed sampling
# ---------------------------------------------------------------------------
STRIDES = (None, 1, 4, 8)


def stride_params(max_new):
    """Phase 4i's mixed samplers, one per prompt, each request seeded:
    greedy, top-k 4 at temperature 0.8, Gumbel-max at temperature 0.7."""
    from repro_torch.serve.params import SamplingParams

    kinds = ({}, dict(top_k=4, temperature=0.8),
             dict(head_mode="temperature", temperature=0.7))
    return [SamplingParams(max_new_tokens=max_new, seed=r, **kinds[r % 3])
            for r in range(12)]


def stride_engine(llm, stride, **kw):
    """A facade on the main path's weights at ``host_stride=stride``
    (None: the per-token step), 8 slots, max_len 1024 and no eos: every
    request runs its 32 tokens, so every stride serves the same
    batches."""
    from repro_torch.serve.api import LLM

    return LLM(llm.engine.params, llm.cfg, n_slots=8, max_len=1024, seed=0,
               **{"eos_id": -1, **kw, "host_stride": stride})


def check_loop_launches(launches, st, cfg, what, flash=True):
    """Phase 4i's launch checks: paged attention 28 per decode iteration
    (a replay is one), each head kernel once per iteration per group of
    its kind (``head_calls``; prefills included), flash attention 28 per
    one-shot prefill (none when ``flash`` is False: chunked prefill)."""
    calls = st["head_calls"]
    want_pa = cfg.n_layers * st["decode_iterations"]
    want_fa = cfg.n_layers * st["prefills"] if flash else 0
    check(launches["paged_attention"] == want_pa,
          f"{what}: paged attention launches {launches['paged_attention']}"
          f" != {cfg.n_layers} x {st['decode_iterations']} decode "
          "iterations")
    check(launches["fused_argmax_head"] == calls.get("Greedy", 0),
          f"{what}: argmax launches != greedy head calls {calls}")
    check(launches["fused_topk_head"] == calls.get("TopK", 0),
          f"{what}: top-k launches != top-k head calls {calls}")
    check(launches["flash_attention"] == want_fa,
          f"{what}: flash attention launches {launches['flash_attention']}"
          f" != {want_fa}")
    check(all(launches[n] == 0 for n in ("fused_verify_head",
                                         "softmax_stats", "online_softmax",
                                         "fused_xent")),
          f"{what}: a verify or softmax-unit kernel ran")


def drive_strided(torch, llm, prompts, plist):
    """``drive`` on a graphed engine, with the graph cache's growth:
    (``drive``'s run..., captures, replays)."""
    g = llm.engine.graphs
    n0 = (g.captures, g.replays)
    run = drive(torch, llm, prompts, plist)
    return run + (g.captures - n0[0], g.replays - n0[1])


def stride_line(what, run) -> dict:
    """Print and return one run's numbers: tok/s, ms per generated
    token, host syncs, tokens a dispatch, dispatches, iterations,
    captures and replays."""
    outs, _, _, st, wall, caps, reps = run
    n_tok = sum(len(o.token_ids) for o in outs)
    row = dict(tokens=n_tok, wall_s=wall, tok_s=n_tok / wall,
               ms_per_token=wall * 1e3 / n_tok,
               host_syncs=st["host_syncs"],
               tokens_per_dispatch=st["emitted_tokens"] / st["host_syncs"],
               dispatches=st["decode_steps"],
               iterations=st["decode_iterations"],
               decode_ms_per_dispatch=st["decode_ms"] / st["decode_steps"],
               prefills=st["prefills"], captures=caps, replays=reps)
    print(f"{what}: {n_tok} tokens in {wall:.3f} s = {row['tok_s']:.2f} "
          f"tok/s, {row['ms_per_token']:.3f} ms a token; host_syncs "
          f"{row['host_syncs']}, tokens_per_dispatch "
          f"{row['tokens_per_dispatch']:.3f}; {row['dispatches']} decode "
          f"dispatches of {row['iterations']} iterations, "
          f"{row['decode_ms_per_dispatch']:.3f} ms a dispatch; "
          f"{caps} captures, {reps} replays", flush=True)
    return row


def run_strides(torch, llm, prompts, plist, strides, what, **kw):
    """Each stride's engine, graphed three times on the same prompts (the
    first run's buckets run eagerly at their first dispatch and capture
    at their second; the third run replays every dispatch): tokens equal
    across the three runs and across the strides, launches at their
    numbers.  Returns ({stride: {run 1, run 3}}, the strides' tokens,
    {stride: (engine, run 1)})."""
    cfg = llm.cfg
    out, tokens, kept = {}, {}, {}
    for stride in strides:
        e = stride_engine(llm, stride, **kw)
        name = f"{what}, host_stride={stride}"
        runs = [drive_strided(torch, e, prompts, plist) for _ in range(3)]
        for n, run in enumerate(runs, 1):
            check_loop_launches(run[2], run[3], cfg, f"{name} run {n}",
                                flash="chunk_size" not in kw)
            check([o.token_ids for o in run[0]]
                  == [o.token_ids for o in runs[0][0]],
                  f"{name}: run {n}'s tokens differ from run 1's")
            check(all(len(o.token_ids) == o.params.max_new_tokens
                      for o in run[0]),
                  f"{name} run {n}: a request stopped short")
            st = run[3]
            check(st["host_syncs"] == st["prefills"] + st["decode_steps"]
                  or "chunk_size" in kw,
                  f"{name} run {n}: host_syncs != prefills + dispatches")
        third = runs[2]
        check(third[5] == 0 and third[6] == third[3]["decode_iterations"],
              f"{name}: run 3 captured {third[5]} buckets or ran an "
              f"iteration eagerly ({third[6]} replays of "
              f"{third[3]['decode_iterations']} iterations)")
        out[str(stride)] = {"run1": stride_line(f"{name}, graphed run 1",
                                                runs[0]),
                            "run3": stride_line(
                                f"{name}, graphed run 3 (replays only)",
                                third)}
        tokens[stride] = [o.token_ids for o in runs[0][0]]
        kept[stride] = (e, runs[0])
    ref = tokens[strides[0]]
    for stride in strides[1:]:
        same = sum(a == b for a, b in zip(ref, tokens[stride]))
        print(f"{what}: host_stride={stride} vs {strides[0]}: "
              f"{same}/{len(ref)} streams equal", flush=True)
        check(same == len(ref), f"{what}: host_stride={stride}'s tokens "
              f"differ from host_stride={strides[0]}'s")
    return out, ref, kept


def expected_cut(stream, stop, eos):
    """A stream as the engine's per-token emission ends it: at the first
    match of the ``stop`` pair ('stop'), else at ``eos`` ('eos'), else
    whole ('length')."""
    for j, t in enumerate(stream):
        if stop and tuple(stream[max(0, j - 1):j + 1]) == stop:
            return list(stream[:j + 1]), "stop"
        if t == eos:
            return list(stream[:j + 1]), "eos"
    return list(stream), "length"


def alternate_rounds(torch, kept, prompts, plist, what, rounds=4) -> dict:
    """Replay-only runs of each stride's engine in turns (the strides in
    order, then reversed, ``rounds`` times) on the same prompts, in one
    call on one card: the first run's tokens every time, no capture;
    each stride's median tok/s, ms a token and host ms a decode iteration
    (``decode_ms`` over ``decode_iterations``), with the tok/s range."""
    strides = list(kept)
    runs = {s: [] for s in strides}
    for r in range(rounds):
        for stride in (strides if r % 2 == 0 else strides[::-1]):
            e, first = kept[stride]
            run = drive_strided(torch, e, prompts, plist)
            check(run[5] == 0, f"{what}, host_stride={stride}: a timed "
                  "round captured a bucket")
            check([o.token_ids for o in run[0]]
                  == [o.token_ids for o in first[0]],
                  f"{what}, host_stride={stride}: a timed round's tokens "
                  "differ from run 1's")
            st = run[3]
            runs[stride].append((run[4], st["decode_ms"]
                                 / st["decode_iterations"]))
    n_tok = sum(len(o.token_ids) for o in kept[strides[0]][1][0])
    out = {}
    for stride in strides:
        walls = sorted(w for w, _ in runs[stride])
        wall = float(np.median(walls))
        it_ms = float(np.median([m for _, m in runs[stride]]))
        out[str(stride)] = dict(
            runs=len(walls), tok_s_median=n_tok / wall,
            tok_s_min=n_tok / walls[-1], tok_s_max=n_tok / walls[0],
            ms_per_token_median=wall * 1e3 / n_tok,
            host_ms_per_iteration_median=it_ms)
    print(f"{what}, {rounds} replay-only runs each in turns, medians: "
          + "; ".join(f"host_stride={s}: {r['tok_s_median']:.2f} tok/s "
                      f"({r['tok_s_min']:.2f}-{r['tok_s_max']:.2f}), "
                      f"{r['ms_per_token_median']:.3f} ms a token, "
                      f"{r['host_ms_per_iteration_median']:.3f} ms a "
                      "decode iteration" for s, r in out.items()),
          flush=True)
    return out


def check_stop_and_eos(torch, llm, prompts, greedy, max_new) -> dict:
    """A stop sequence and an eos inside a stride-8 block: the first 8
    prompts greedy (no admission mid-run), request 0 with the stop pair
    at its tokens 10-11 and, as the engine's eos, the token request 1
    first emits inside a block (not as a block's last token) that the
    fewest other requests emit.  Each row must end where per-token emission
    would (``expected_cut``: the greedy stream of the stride runs, cut at
    the pair or the eos), the rest of its block trimmed, and every block
    must be back in the pool."""
    from repro_torch.serve.params import SamplingParams

    g = [list(t) for t in greedy[:8]]
    # the eos fires at a token's first emission: one first emitted by a
    # dispatch, not as a block's last token
    cands = [k for k in range(1, max_new)
             if k % 8 and g[1][k] not in g[1][:k]]
    check(bool(cands), "stride path: request 1 emits no token for the "
          "first time inside a block, so no eos can stop it there")
    k_eos = min(cands, key=lambda k: sum(g[1][k] in g[r]
                                         for r in range(8) if r != 1))
    eos, stop = g[1][k_eos], tuple(g[0][10:12])
    e = stride_engine(llm, 8, eos_id=eos)
    plist = [SamplingParams(max_new_tokens=max_new,
                            stop=[stop] if r == 0 else ())
             for r in range(8)]
    outs = e.generate(prompts[:8], plist)
    want = [expected_cut(t, stop if r == 0 else (), eos)
            for r, t in enumerate(g)]
    got = [(list(o.token_ids), o.finish_reason) for o in outs]
    kv = e.kv_usage()
    cut = sum(reason != "length" for _, reason in want)
    print(f"stride path, stop and eos at host_stride=8: request 0 ended "
          f"after {len(got[0][0])} of {max_new} tokens ({got[0][1]}, stop "
          f"pair {stop}), request 1 after {len(got[1][0])} ({got[1][1]}, "
          f"eos {eos} at its token {k_eos}); {cut} of 8 requests cut; "
          f"blocks free {kv['blocks_free']} of {kv['num_blocks']}",
          flush=True)
    check(got == want, "stride path: the stop / eos run's tokens or finish "
          "reasons are not the cut greedy streams")
    check(got[0][1] == "stop" and got[1][1] == "eos",
          f"stride path: finish reasons {[r for _, r in got]}")
    check(kv["blocks_free"] == kv["num_blocks"],
          "stride path: blocks left in use after the stop / eos run")
    return dict(stop_after=len(got[0][0]), eos_after=len(got[1][0]),
                rows_cut=cut, blocks_free=kv["blocks_free"],
                num_blocks=kv["num_blocks"])


def check_keyed_draw(torch, timer) -> dict:
    """The keyed draw on the card against ``prng``'s run on the CPU, at
    a Temperature row's size (8 keys x 151,936): keys, bits and uniforms
    bit for bit; the largest Gumbel gap in ulps at its scale (spacing of
    max(|g|, 1)) printed; the categorical indices compared; the draw's
    time (``Temperature._draw`` over (8, 151936) f32 logits)."""
    from repro_torch import prng
    from repro_torch.serve.sampler import Temperature

    v = 151936
    keys = prng.split(prng.key(7), 8)
    dev = keys.cuda()
    split = prng.split(dev).cpu()
    bits = prng.random_bits(dev, (v,)).cpu()
    uni = prng.uniform(dev, (v,)).cpu()
    check(torch.equal(split, prng.split(keys)),
          "keyed draw: split keys on the card != the CPU's")
    check(torch.equal(bits, prng.random_bits(keys, (v,))),
          "keyed draw: random bits on the card != the CPU's")
    check(torch.equal(uni, prng.uniform(keys, (v,))),
          "keyed draw: uniforms on the card != the CPU's")
    g, gc = prng.gumbel(dev, (v,)).cpu().double(), prng.gumbel(keys, (v,))
    scale = torch.clamp_min(gc.abs(), 1.0)
    ulp = (torch.nextafter(scale, torch.full_like(scale, math.inf))
           - scale).double()
    ulps = ((g - gc.double()).abs() / ulp).max().item()
    gen = torch.Generator().manual_seed(3)
    logits = 4 * torch.randn(8, v, generator=gen)
    same = (prng.categorical(dev, logits.cuda()).cpu()
            == prng.categorical(keys, logits)).sum().item()
    draw = Temperature(0.7)
    lg = logits.cuda()
    row = timer.readings(lambda: draw._draw(lg, dev))
    print(f"keyed draw on the card vs the CPU at (8, {v}): keys, bits and "
          f"uniforms bitwise equal; Gumbel noise within {ulps:.3g} ulp at "
          f"its scale; categorical {same}/8 indices equal; the Temperature "
          f"draw {shown(row)}", flush=True)
    return dict(gumbel_max_ulps=ulps, categorical_equal=same,
                draw=row)


def loop_bound(torch, eng, plan):
    """The least time one dispatch's ``plan.steps`` iterations could take
    on the card: every weight read once an iteration, each row's K/V
    history once an iteration (its positions up to that iteration's
    query, every layer), 2 flops per weight and row plus 4 * hd per
    (query, key, head) -- ``step_bound`` summed over the iterations."""
    cfg = eng.cfg
    b, n = plan.arrays[0].shape[0], plan.steps
    pos = plan.arrays[1].astype(np.int64) + 1
    keys = n * int(pos.sum()) + b * n * (n - 1) // 2
    w_bytes = sum(x.numel() * x.element_size() for x in _leaves(eng.params))
    n_w = sum(x.numel() for x in _leaves(eng.params))
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2 * keys
    flops = n * 2 * n_w * b + 4 * cfg.head_dim * cfg.n_heads \
        * cfg.n_layers * keys
    return bound(n * w_bytes + kv, flops, BF16_FLOPS_PER_S)


def check_loop_dispatch(torch, llm, prompts, timer) -> dict:
    """A graphed dispatch against the eager loop on the same operands, at
    stride 8: 8 mixed requests (phase 4i's samplers) admitted with one
    eager dispatch, the engine's next dispatch planned
    (``_plan_multi``), then ``api.serve_decode_multi`` eagerly and the
    bucket's graph replayed ``plan.steps`` times from the same carry:
    out, emitted and keys bitwise equal.  Both timed (call, device and
    host ms) beside the dispatch's bound."""
    import functools

    from repro_torch.models import api
    from repro_torch.serve import step_graph

    eng = llm.engine
    reqs = [llm.submit(p, sp) for p, sp in zip(prompts[:8],
                                                stride_params(32))]
    with step_graph.eager_steps():
        eng.step()                      # admit all 8, one eager dispatch
    active = [i for i, sl in enumerate(eng.slots) if sl is not None]
    check(len(active) == 8, f"loop dispatch: {len(active)} active rows")
    plan = eng._plan_multi(active)

    def eager():
        tok, pos, keys, _, _, _, _, caps, btab, *rows = \
            step_graph.to_device(plan.arrays, eng.device)
        return api.serve_decode_multi(
            eng.params, eng.cfg, tok, eng.store.cache(), pos, keys, caps,
            rows, steps=eng.host_stride, eos_id=eng._eos(),
            samplers=plan.order, block_tables=btab, layers=eng._layers)

    def replay():
        eng.graphs.replay(plan.key, plan.arrays, plan.steps)
        return eng.graphs.graphs[plan.key].static

    want = [x.cpu().clone() for x in eager()[:3]]
    if plan.key not in eng.graphs.graphs:
        eng.graphs.capture(plan.key, functools.partial(
            eng._loop_body, tuple(plan.order)), plan.arrays, eng.device)
    ops = replay()
    got = [ops[i].cpu().clone() for i in (5, 3, 2)]
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max((a.double() - b.double()).abs().max().item()
              for a, b in zip(got, want))
    print(f"loop dispatch: bucket {plan.key[1:4]} samplers "
          f"{[type(s).__name__ for s in plan.order]}, {plan.steps} "
          f"iterations: the replayed graph's out, emitted and keys vs the "
          f"eager loop's: {'bitwise equal' if equal else 'DIFFER'} (max "
          f"abs {err:.3g})", flush=True)
    check(equal, "loop dispatch: the graphed dispatch differs from the "
          "eager loop")
    row = dict(bitwise_equal=equal, max_abs_err=err, steps=plan.steps,
               **timer.readings(replay), **timer.readings(eager, "plain_"))
    row["bound_ms"], row["bound_by"] = loop_bound(torch, eng, plan)
    print(f"loop dispatch ({plan.steps} iterations): replayed {shown(row)}; "
          f"eager loop {shown(row, 'plain_')}; bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    for r in reqs:
        eng.cancel(r)
    return row


def profile_dispatch(torch, llm, prompts, steps=8) -> dict:
    """Where a stride-8 dispatch's time goes: ``torch.profiler`` over one
    dispatch of 8 rows in pure decode, every bucket already captured by
    the stride runs (the same prompts and positions), so it is 8 replays
    back to back: kernels an iteration, the device-busy share, the traced
    paged-attention kernels (2 x 28 an iteration)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.params import SamplingParams

    eng = llm.engine
    for p in prompts[:8]:
        llm.submit(p, SamplingParams(max_new_tokens=32))
    eng.step()                          # admit all 8, first dispatch
    eng.step()
    torch.cuda.synchronize()
    n0 = (eng.graphs.captures, eng.graphs.replays)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    replays = eng.graphs.replays - n0[1]
    check(eng.graphs.captures == n0[0] and replays == steps,
          f"dispatch profile: {replays} replays and "
          f"{eng.graphs.captures - n0[0]} captures in one dispatch")
    while eng.has_work:
        eng.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"dispatch profile (8 rows, {steps} iterations, profiler on): "
              f"wall {wall_ms:.3f} ms; the profiler recorded no device "
              "time (busy share not measured)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=None, kernels_per_iteration=None)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    paged = [e for e in kernels if "paged_" in e.name]
    check(len(paged) == 2 * llm.cfg.n_layers * steps,
          f"dispatch profile: {len(paged)} traced paged-attention kernels "
          f"in {steps} iterations")
    row = dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
               kernels_per_iteration=len(kernels) / steps,
               wall_ms_per_iteration=wall_ms / steps)
    print(f"dispatch profile (8 rows, {steps} iterations, profiler on): wall "
          f"{wall_ms:.3f} ms ({wall_ms / steps:.3f} an iteration), device "
          f"busy {busy_ms:.3f} ms ({100 * row['busy_share']:.1f}%), "
          f"{row['kernels_per_iteration']:.0f} kernels an iteration",
          flush=True)
    return row


def run_stride_path(torch, llm, prompts, max_new, step_profile):
    """Phase 4i: the device-resident loop at full width, on engines that
    share the main path's weights (8 slots, max_len 1024, no eos).
    Phase 4's 12 prompts greedy at ``host_stride`` None, 1, 4 and 8, then
    greedy / top-k 4 at 0.8 / Gumbel-max at 0.7, seeded, at 1, 4 and 8,
    then the mixed samplers with chunk 64 (the prompts cut or repeated to
    129-192 tokens, three chunks each, so every row prefills and ends
    with its batch) at 1 and 8: each engine graphed three times, tokens
    equal across runs and strides, launches at their numbers, then four
    replay-only runs a stride in turns (``alternate_rounds``); then a
    stop and an eos inside a block, the keyed draw against the CPU, a
    graphed dispatch against the eager loop, and a profile of one
    dispatch beside phase 4's graphed step.  Returns (summary, the
    loop's row for the kernels line, the stride-8 greedy run 1's
    launches)."""
    from repro_torch.serve.params import SamplingParams

    out = {}
    timer = Timer(torch)
    mixed = stride_params(max_new)
    greedy_sp = SamplingParams(max_new_tokens=max_new)
    out["greedy"], greedy, kept = run_strides(
        torch, llm, prompts, greedy_sp, STRIDES, "stride path greedy")
    out["greedy_rounds"] = alternate_rounds(torch, kept, prompts, greedy_sp,
                                            "stride path greedy")
    e8, run8 = kept[8]
    del kept
    out["mixed"], _, kept = run_strides(
        torch, llm, prompts, mixed, (1, 4, 8), "stride path mixed")
    out["mixed_rounds"] = alternate_rounds(torch, kept, prompts, mixed,
                                           "stride path mixed")
    short = [np.resize(p, 129 + len(p) % 64) for p in prompts]
    out["chunk64"], _, kept = run_strides(
        torch, llm, short, mixed, (1, 8), "stride path chunk 64",
        chunk_size=64, prefix_cache=False)
    out["chunk64_rounds"] = alternate_rounds(torch, kept, short, mixed,
                                             "stride path chunk 64")
    del kept
    out["stop_eos"] = check_stop_and_eos(torch, llm, prompts, greedy,
                                         max_new)
    out["keyed_draw"] = check_keyed_draw(torch, timer)
    out["dispatch"] = check_loop_dispatch(torch, e8, prompts, timer)
    out["profile"] = profile_dispatch(torch, e8, prompts)
    p4 = step_profile
    if out["profile"]["busy_ms"] is not None and p4.get("busy_ms"):
        print(f"stride 8 dispatch against phase 4's graphed step (profiler "
              f"on): {out['profile']['kernels_per_iteration']:.0f} against "
              f"{p4['kernels_per_step']:.0f} kernels an iteration, busy "
              f"{100 * out['profile']['busy_share']:.1f}% against "
              f"{100 * p4['busy_share']:.1f}%, wall "
              f"{out['profile']['wall_ms_per_iteration']:.3f} against "
              f"{p4['wall_ms']:.3f} ms an iteration", flush=True)
    del timer, e8
    return out, dict(launches=run8[6], **out["dispatch"]), run8[2]


def run_unit_path(torch, llm, prompts, outs):
    """Phase 4d: the full softmax unit on the main path's logits.  The
    final hidden states of the 12 prompts (one-shot prefills, not
    counted) times the head weight in f32 give (12, 151936) logits; then
    ``ops.softmax_stats``, ``ops.online_softmax`` and ``ops.softmax_xent``
    forward and backward run on them with the launch counts set to 0,
    labels = phase 4's first tokens.  The backward's softmax is a second
    ``online_softmax`` call; each one that takes the two-launch route
    runs ``softmax_stats``' kernel as its first launch."""
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm

    eng = llm.engine
    h = torch.cat([lm.prefill(eng.params, eng.cfg, torch.as_tensor(
        p, device=eng.device).long()[None], len(p))[0] for p in prompts])
    logits = torch.matmul(h.float(), lm.lm_head_weight(
        eng.params, eng.cfg).float())
    labels = torch.tensor([o.token_ids[0] for o in outs], device=eng.device)
    x = logits.clone().requires_grad_(True)
    torch.cuda.synchronize()
    reset_launches()
    m, l = ops.softmax_stats(logits)
    p = ops.online_softmax(logits)
    loss = ops.softmax_xent(x, labels)
    loss.mean().backward()
    torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(osm.online_softmax.launches_by_route)
    route = osm.plan_of(logits).route
    calls = {"softmax_stats": 1 + routes[osm.TWO_LAUNCH],
             "online_softmax": 1 + 1, "fused_xent": 1}
    print(f"unit path: logits {tuple(logits.shape)} f32; launches "
          f"{launches}; online_softmax by route {routes}; want {calls} "
          f"(online_softmax: 1 call + the backward's, both {route}; "
          f"softmax_stats: 1 call + each two-launch online_softmax's)",
          flush=True)
    check(routes[route] == sum(routes.values()) == 2,
          f"unit path: online_softmax's routes {routes}, want 2 x {route}")
    check(all(launches[n] == c for n, c in calls.items()),
          "unit path: a softmax-unit kernel's launches != its calls")
    check(all(c == 0 for n, c in launches.items() if n not in calls),
          "unit path: launched a kernel outside the softmax unit")
    errs = unit_errors(torch, logits, labels, m, l, p, loss.detach())
    xr = logits.clone().requires_grad_(True)
    ref.fused_xent(xr, labels).mean().backward()
    gerr = (x.grad - xr.grad).abs().max().item()
    ok = torch.allclose(x.grad, xr.grad, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    print(f"  softmax_xent backward: max_abs_err {gerr:.6g} vs autograd "
          f"through the plain version (rtol {UNIT_RTOL}, atol {UNIT_ATOL}):"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "softmax_xent backward disagrees with the plain gradient")

    # Theorem 1 through the full unit: argmax of the probabilities is
    # the comparator head's token, except at a near-tie of the top 2
    top2 = logits.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > HEAD_RTOL * top2[:, 0].abs()
    same = torch.argmax(p, dim=-1) == labels
    print(f"unit path: argmax(online_softmax) == phase 4's first token for "
          f"{int(same.sum())}/{len(prompts)} prompts ({int(decided.sum())} "
          f"decided by more than {HEAD_RTOL}*|max|)", flush=True)
    check(bool((same | ~decided).all()),
          "unit path: argmax(online_softmax) != the reduced head's token at "
          "a decided row")
    check(bool(torch.equal(m, top2[:, 0])),
          "unit path: the stats' max is not the row max")
    return launches, errs


def run_probe_path(torch, llm, prompts, max_new):
    """Phase 4e: ``repro_torch.probe.run_probe`` at full width over the
    12 prompts, ``max_new`` tokens: all five score modes at window None,
    then pseudo and maxonly at window 128, on the main path's weights and
    engine settings.  The launch counts are set to 0 before each probe
    and read after it; the report lists each engine run the probe made
    (one per arm, the exact baseline and the score run both in exact),
    so that every mode's paged-attention launches can be held to 28 x
    the decode steps of its runs and the flash launches to 28 x their
    prefills."""
    from repro_torch import probe
    from repro_torch.kernels import paged_attention as pa

    n_layers, out = llm.cfg.n_layers, {}
    for window, variants in ((None, ("base2", "pseudo", "pwl", "maxonly")),
                             (128, ("pseudo", "maxonly"))):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rep = probe.run_probe(llm.engine.params, llm.cfg, prompts,
                              variants=variants, window=window,
                              max_new_tokens=max_new, n_slots=8,
                              max_len=1024)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        by_mode = dict(pa.paged_attention.launches_by_mode)
        runs = [(r["attn_approx"], r["decode_steps"], r["prefills"])
                for r in rep["runs"]]
        steps = {m: sum(s for mode, s, _ in runs if mode == m)
                 for m in by_mode}
        prefills = sum(p for _, _, p in runs)
        print(f"probe window={window}: {len(runs)} engine runs in "
              f"{wall:.3f} s (arms + the score run) {runs}; paged launches "
              f"by mode {by_mode}, want {n_layers} x decode steps "
              f"{steps}; flash {launches['flash_attention']}, want "
              f"{n_layers} x {prefills} prefills", flush=True)
        check(len(runs) == len(variants) + 2,
              f"probe window={window}: {len(runs)} engine runs, want "
              f"{len(variants) + 2}")
        for mode in ("exact",) + variants:
            check(steps[mode] > 0 and by_mode[mode] == n_layers * steps[mode],
                  f"probe window={window}: {mode} paged launches "
                  f"{by_mode[mode]} != {n_layers} x {steps[mode]} steps")
        check(sum(by_mode.values()) == launches["paged_attention"],
              "probe: launches by mode do not add up to the launches")
        check(all(p >= len(prompts) for _, _, p in runs)
              and launches["flash_attention"] == n_layers * prefills,
              f"probe window={window}: flash launches != {n_layers} x "
              "prefills, or an arm missed a prompt")
        ex = rep["variants"]["exact"]
        check(ex["divergence"] == 0.0 and ex["first_divergence"]
              == [None] * len(prompts), "probe: the exact arm diverged")
        for v in variants:
            row = rep["variants"][v]
            errs = list(row["score_error"].values())
            check(len(errs) == n_layers
                  and all(math.isfinite(e) and 0.0 <= e <= 1.0
                          for e in errs),
                  f"probe window={window}: {v} score errors not finite in "
                  f"[0, 1]: {errs}")
            worst = max(range(n_layers), key=lambda i: errs[i])
            mfd = row["mean_first_divergence"]
            print(f"probe window={window} {v}: divergence "
                  f"{row['divergence']:.4f} ({row['diverged_requests']}/"
                  f"{row['n_requests']}), mean first divergence "
                  f"{'none' if mfd is None else f'{mfd:.3f}'}, "
                  f"first divergence {row['first_divergence']}, worst "
                  f"layer {worst} score error {errs[worst]:.6g}",
                  flush=True)
        out[window] = dict(report=rep, launches_by_mode=by_mode,
                           decode_steps=steps, wall_s=wall)
    return out


def check_theorem1(torch, llm, prompts, outs, max_new, what="theorem 1",
                   max_len=1024):
    """The softmax baseline (f32 logits, softmax, argmax) over the same
    weights must give the same streams; a divergence is allowed only at
    a near-tie of the top-2 f32 logits."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    base = LLM(llm.engine.params, llm.cfg, head_mode="softmax", n_slots=8,
               max_len=max_len, seed=0)
    t0 = time.perf_counter()
    souts = base.generate(prompts, SamplingParams(max_new_tokens=max_new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = base.engine.stats
    n_tok = sum(len(o.token_ids) for o in souts)
    print(f"{what}, softmax baseline head: {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.2f} tok/s; mean "
          f"{st['decode_ms'] / st['decode_steps']:.3f} ms/decode step "
          f"(first run of this engine, no warm-up); graphs: "
          f"{graph_line(base)}", flush=True)
    check(base.engine.graphs.replays > 0,
          f"{what}: the softmax-baseline engine replayed no graph")
    compare_streams(torch, llm, prompts, outs, souts,
                    f"{what}, the reduced head vs the softmax baseline")
    del base


# ---------------------------------------------------------------------------
# Phase 4j: starcoder2-7b at full width; the dense layout and the cohort
# scheduler
# ---------------------------------------------------------------------------
def kernel_row(timer, fn, plain, library, nbytes, flops, err) -> dict:
    """A kernel's readings, its plain version's call ms and its library
    call's readings on one set of inputs, beside the bound of ``nbytes``
    and bf16 ``flops``."""
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    return dict(max_abs_err=err, **timer.readings(fn), plain_ms=timer(plain),
                bound_ms=bound_ms, bound_by=bound_by,
                **timer.readings(library, "library_"))


def model_line(label, name, row, library):
    print(f"{label} shapes, {name}: kernel {shown(row)}, plain "
          f"{row['plain_ms']:.4f} ms, {library} {shown(row, 'library_')}, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"max_abs_err {row['max_abs_err']:.6g}", flush=True)


def check_model_kernels(torch, timer, label, *, hq, hkv, hd, d, v, seed,
                        paged_ts=(1, 64), verify=True, flash_t=512,
                        verify_t=8) -> dict:
    """Kernels 1-5 at one model's shapes (bf16: ``hq`` query heads over
    ``hkv`` KV heads of ``hd``; an untied (V, D) = (``v``, ``d``) head
    stored as the ``.T`` view of a row-major (V, D) tensor, as
    ``weights.cast_params`` stores it), each against its plain version
    with the tolerances of phase 3 and timed beside its bound and its
    library call: paged attention at B 8 and each T of ``paged_ts`` (ragged
    rows of 1-1,000 positions), flash attention over a ``flash_t``-token
    prompt, the argmax head at B 8, the top-k head at B 4, k 8 and, with
    ``verify``, the verify head at B 8, T ``verify_t`` (integer-valued
    operands: exact)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    g = hq // hkv
    rng = np.random.default_rng(seed)
    rows = {}
    for t in paged_ts:
        q, kp, vp, bt, pos = paged_case(torch, rng, t, b=8, hq=hq, hkv=hkv,
                                        hd=hd)
        out = pa.paged_attention(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        want = ref.paged_attention(q, kp, vp, bt, pos)
        err = (out.float() - want.float()).abs().max().item()
        check(torch.allclose(out.float(), want.float(), atol=PA_TOL,
                             rtol=PA_TOL),
              f"paged attention at {label}'s shapes, T={t}, disagrees "
              f"with its plain version ({err})")
        nbytes, flops = paged_work(q, kp, bt, pos, None)
        row = kernel_row(
            timer, lambda: pa.paged_attention(q, kp, vp, bt, pos),
            lambda: ref.paged_attention(q, kp, vp, bt, pos),
            sdpa_on_gathered_view(torch, q, kp, vp, bt, pos, None,
                                  1 / math.sqrt(hd)), nbytes, flops, err)
        row["chunks"] = pa.split_for(q, kp, bt)[0]
        model_line(label, f"paged_attention B=8 T={t} g={g} "
                   f"({split_line(pa, q, kp, bt)})", row,
                   "sdpa(gathered view)")
        rows[f"paged_t{t}"] = row

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(heads):
        return torch.randn((1, flash_t, heads, hd), generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    q, k, vv = rand(hq), rand(hkv), rand(hkv)
    out = fa.flash_attention(q, k, vv, causal=True)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, vv, causal=True)
    err = (out.float() - want.float()).abs().max().item()
    check(torch.allclose(out.float(), want.float(), atol=FA_TOL, rtol=FA_TOL),
          f"flash attention at g {g} disagrees with its plain version "
          f"({err})")
    key = f"flash_t{flash_t}_g{g}"
    rows[key] = kernel_row(
        timer, lambda: fa.flash_attention(q, k, vv, causal=True),
        lambda: ref.flash_attention(q, k, vv, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, vv, enable_gqa=True,
                                               is_causal=True),
        (2 * q.numel() + k.numel() + vv.numel()) * 2,
        4 * hd * hq * (flash_t * (flash_t + 1) // 2), err)
    model_line(label, f"flash_attention T={flash_t} g={g}", rows[key],
               "sdpa")

    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    w = emb.t()                               # the untied head's layout
    h = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    idx, val = fah.fused_argmax_head_with_value(h, w)
    torch.cuda.synchronize()
    idx_ok, val_ok, err, _ = argmax_verdict(torch, h, w, idx, val)
    check(idx_ok and val_ok, f"the argmax head on {label}'s untied head "
          "disagrees with its plain version")
    rows["argmax_b8"] = kernel_row(
        timer, lambda: fah.fused_argmax_head_with_value(h, w),
        lambda: ref.fused_argmax_head_with_value(h, w),
        lambda: torch.argmax(h @ w, dim=-1), v * d * 2 + 8 * d * 2 + 8 * 8,
        2.0 * 8 * d * v, err)
    model_line(label, f"fused_argmax_head B=8 (V, D) = ({v}, {d})",
               rows["argmax_b8"], "argmax(h @ W)")

    h4 = h[:4].contiguous()
    vals, idxs = ftk.fused_topk_head(h4, w, 8)
    torch.cuda.synchronize()
    tv = topk_verdict(torch, h4, w, 8, vals, idxs)
    print(f"{label} shapes, fused_topk_head B=4 k=8: {topk_line(tv)}",
          flush=True)
    check(tv["idx_ok"] and tv["ties_ok"] and tv["desc_ok"] and tv["val_ok"],
          f"the top-k head on {label}'s untied head disagrees with its "
          "plain version")
    rows["topk_b4_k8"] = kernel_row(
        timer, lambda: ftk.fused_topk_head(h4, w, 8),
        lambda: ref.fused_topk_head(h4, w, 8),
        lambda: torch.topk(h4 @ w, 8, dim=-1),
        v * d * 2 + 4 * d * 2 + 4 * 8 * 8, 2.0 * 4 * d * v, tv["err"])
    model_line(label, "fused_topk_head B=4 k=8", rows["topk_b4_k8"],
               "topk(h @ W)")
    del emb, w
    if not verify:
        return rows

    vt = verify_t
    wi = torch.randint(-2, 3, (v, d), generator=gen, device="cuda").to(
        torch.bfloat16).t()
    hi = torch.randint(-1, 2, (8, vt, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    ids0, _ = ref.verify_draft(hi, wi, torch.full((8, vt - 1), -1,
                                                  dtype=torch.int32,
                                                  device="cuda"))
    cand = torch.full((8, vt - 1), -1, dtype=torch.int32, device="cuda")
    for r in range(8):                        # ragged widths 0..T-1
        cand[r, :min(r, vt - 1)] = ids0[r, :min(r, vt - 1)]
    cand[3, 1] = (cand[3, 1] + 1) % v         # a wrong draft mid-run
    ids, acc = fah.fused_verify_head(hi, wi, cand)
    torch.cuda.synchronize()
    rids, racc = ref.verify_draft(hi, wi, cand)
    check(torch.equal(ids, rids) and torch.equal(acc, racc),
          f"the verify head at {label}'s shapes disagrees with its plain "
          "version")
    h2 = hi.view(8 * vt, d)
    rows[f"verify_b8_t{vt}"] = kernel_row(
        timer, lambda: fah.fused_verify_head(hi, wi, cand),
        lambda: ref.verify_draft(hi, wi, cand),
        lambda: torch.argmax(h2 @ wi, dim=-1),
        v * d * 2 + 8 * vt * d * 2 + cand.numel() * 4 + 8 * vt * 4 + 8 * 4,
        2.0 * 8 * vt * d * v, 0.0)
    model_line(label, f"fused_verify_head B=8 T={vt} (accept "
               f"{acc.tolist()}, exact)", rows[f"verify_b8_t{vt}"],
               f"argmax(h @ W) over the {8 * vt} rows")
    return rows


def step_weight_bytes(eng) -> int:
    """Bytes of the weights one decode step must read: every leaf but the
    embedding table, of which it reads B rows (left out)."""
    return sum(t.numel() * t.element_size() for t in _leaves(
        {k: v for k, v in eng.params.items() if k != "embed"}))


def run_starcoder2_spec(torch, llm, lengths, max_new) -> dict:
    """``spec_k=4`` once on starcoder2-7b, graphed, on phase 4c's kind of
    prompts (a random 32-token phrase repeated to each length), beside
    the same prompts at spec_k=0: every step with a draft row through the
    verify kernel.  A draft window's K/V comes from the trunk's GEMMs at
    B x T rows where a plain step's comes from B rows, and at this width
    their bf16 sums part the streams above the near-tie rule
    (``scripts/batch_bits_probe.py``), as one-shot and chunked prefill do
    at qwen3's: so the bf16
    streams are measured, and the two held to each other in f32 on an
    f32 twin of the weights (``cross_path_f32``)."""
    from repro_torch.serve.params import SamplingParams

    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, llm.cfg.vocab_size, size=32),
                       n // 32 + 1)[:n].astype(np.int32) for n in lengths]
    sp0 = SamplingParams(max_new_tokens=max_new)
    sp4 = SamplingParams(max_new_tokens=max_new, spec_k=4)
    base = drive_graphed(torch, llm, prompts, sp0, "starcoder2-7b spec_k=0")
    spec = drive_graphed(torch, llm, prompts, sp4, "starcoder2-7b spec_k=4")
    outs, _, launches, st, wall = spec[:5]
    calls, cfg = st["head_calls"], llm.cfg
    n_tok = sum(len(o.token_ids) for o in outs)
    print(f"starcoder2-7b spec_k=4 (graphed run 1): {n_tok} tokens in "
          f"{wall:.3f} s = {n_tok / wall:.2f} tok/s; {st['decode_steps']} "
          f"decode steps (spec_k=0: {base[3]['decode_steps']}), drafted "
          f"{st['drafted']}, accepted {st['accepted']}; head calls {calls}; "
          f"launches {launches}", flush=True)
    check(st["drafted"] > 0, "starcoder2-7b spec_k=4: nothing was drafted")
    check(launches["fused_verify_head"] == calls.get("verify", 0) > 0,
          "starcoder2-7b spec_k=4: verify launches != steps with a draft row")
    check(launches["fused_argmax_head"] == calls.get("Greedy", 0),
          "starcoder2-7b spec_k=4: argmax launches != greedy head calls")
    check(launches["paged_attention"] == cfg.n_layers * st["decode_steps"],
          "starcoder2-7b spec_k=4: paged launches != layers x decode steps")
    check(launches["flash_attention"] == cfg.n_layers * st["prefills"],
          "starcoder2-7b spec_k=4: flash launches != layers x prefills")
    same = compare_streams(torch, llm, prompts, base[0], outs,
                           "starcoder2-7b spec_k=4 vs spec_k=0, bf16",
                           gate=False)
    twin = f32_twin(torch, llm)
    engine = dict(n_slots=8, max_len=1024)
    f32 = cross_path_f32(torch, twin, prompts,
                         (("spec_k=0", engine, sp0),
                          ("spec_k=4", engine, sp4)), "starcoder2-7b")
    del twin
    return dict(tok_s=n_tok / wall, tokens=n_tok,
                decode_steps=st["decode_steps"],
                decode_steps_spec0=base[3]["decode_steps"],
                drafted=st["drafted"], accepted=st["accepted"],
                verify_launches=launches["fused_verify_head"],
                identical_streams_bf16=same,
                identical_streams_f32=f32["spec_k=4"]["identical_streams"])


def run_starcoder2_stride(torch, llm, prompts, max_new) -> dict:
    """``host_stride=8`` greedy once on starcoder2-7b against the per-token
    step (``host_stride=None``), each on a fresh engine sharing the
    weights (no eos), graphed: tokens EQUAL, paged attention 32 launches
    a decode iteration."""
    from repro_torch.serve.params import SamplingParams

    plist = SamplingParams(max_new_tokens=max_new)
    rows, tokens = {}, {}
    for stride in (None, 8):
        e = stride_engine(llm, stride)
        run = drive_strided(torch, e, prompts, plist)
        name = f"starcoder2-7b host_stride={stride}"
        check_loop_launches(run[2], run[3], llm.cfg, name)
        rows[str(stride)] = stride_line(f"{name}, graphed run 1", run)
        tokens[stride] = [o.token_ids for o in run[0]]
        del e, run
    same = sum(a == b for a, b in zip(tokens[None], tokens[8]))
    print(f"starcoder2-7b host_stride=8 vs None: {same}/{len(prompts)} "
          "streams equal", flush=True)
    check(same == len(prompts),
          "starcoder2-7b: host_stride=8's tokens differ from None's")
    return rows


# starcoder2-7b's depth in phase 4j (of 32; its width and its kernels'
# shapes are whole): cut to keep the script within its time
SC_LAYERS = 8                # of 32: cut to pay for phase 4k's meshes


def run_starcoder2_path(torch, max_new) -> tuple:
    """Phase 4j, part 1: starcoder2-7b at full width in bf16 (d 4,608, 36
    / 4 heads of 128, d_ff 18,432, gelu MLP, V 49,152 untied; SC_LAYERS
    of its 32 layers; random seeded weights drawn in bf16), 8 slots of
    max_len 1,024 in blocks of 16: phase 4's 12 prompts (ids below
    49,152) greedy, eager then graphed three times (tokens equal;
    launches a paged a layer a decode step, a flash a layer a one-shot
    prefill, one argmax head a step and a prefill), against the
    softmax-baseline head (Theorem 1, near-tie
    rule), phase 4b's mixed samplers, ``spec_k=4`` and ``host_stride=8``.
    Prints the replayed step's ms beside the bound of reading the
    weights once, tok/s and the phase's peak memory.  Returns (summary,
    the graphed run 1's launches)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import dtype_of, seeded_params

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = get_config("starcoder2-7b")
    cut = dataclasses.replace(full, n_layers=SC_LAYERS)
    llm = LLM(seeded_params(cut, 0, "cuda", dtype=dtype_of(cut)), cut,
              seed=0, n_slots=8, max_len=1024, block_size=16)
    torch.cuda.synchronize()
    cfg, eng = llm.cfg, llm.engine
    built_peak = torch.cuda.max_memory_allocated()
    check((full.n_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.activation, cfg.tie_embeddings, cfg.dtype)
          == (32, SC_LAYERS, 4608, 36, 4, 128, 18432, 49152, "gelu", False,
              "bfloat16"),
          f"starcoder2-7b is not served at its full width: {cfg}")
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    print(f"starcoder2-7b: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim}, "
          f"d_ff={cfg.d_ff} ({cfg.activation}), V={cfg.vocab_size} untied, "
          f"{cfg.dtype}; weights {wbytes / 1e9:.3f} GB, KV pool "
          f"{sum(p.numel() * p.element_size() for p in eng.store.pools.values()) / 1e9:.3f}"
          f" GB; built in {time.perf_counter() - t0:.1f} s, peak "
          f"{built_peak / 1e9:.3f} GB while the f32 masters were cast",
          flush=True)
    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in prng.integers(64, 513, size=12)]
    params = SamplingParams(max_new_tokens=max_new)
    llm.generate([prompts[0][:16]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()                  # warm-up (cuBLAS, allocator)

    eager, graphed = drive_both(torch, llm, prompts, params, "starcoder2-7b")
    check_main_launches(eager[2], eager[3], cfg, len(prompts),
                        "starcoder2-7b eager")
    check_main_launches(graphed[2], graphed[3], cfg, len(prompts),
                        "starcoder2-7b graphed")
    _, again = drive_replays(torch, llm, prompts, params, "starcoder2-7b",
                             graphed)
    check_main_launches(again[2], again[3], cfg, len(prompts),
                        "starcoder2-7b graphed run 3")
    outs = graphed[0]
    for o in outs:
        check(1 <= len(o.token_ids) <= max_new
              and o.finish_reason in ("length", "eos")
              and all(0 <= x < cfg.vocab_size for x in o.token_ids),
              f"starcoder2-7b: bad output for rid {o.rid}: "
              f"{o.finish_reason} {o.token_ids}")
    summary = {
        "eager": main_line("starcoder2-7b, eager", eager[0], eager[3],
                           eager[4]),
        "graph_first_run": main_line("starcoder2-7b, graphed run 1", outs,
                                     graphed[3], graphed[4]),
        "graph": main_line("starcoder2-7b, graphed run 3 (replays only)",
                           again[0], again[3], again[4])}
    step_bytes = step_weight_bytes(eng)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    step_ms = summary["graph"]["decode_ms"]
    print(f"starcoder2-7b replayed decode step: {step_ms:.3f} ms (host wall, "
          f"graphed run 3) against a bound of {bound_ms:.3f} ms (the "
          f"{step_bytes / 1e9:.3f} GB of weights a step reads, once, at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {step_ms / bound_ms:.2f}x",
          flush=True)
    summary.update(step_bound_ms=bound_ms, step_weight_gb=step_bytes / 1e9,
                   weights_gb=wbytes / 1e9, built_peak_gb=built_peak / 1e9,
                   graphs=graph_line(llm))
    check_theorem1(torch, llm, prompts, outs, max_new,
                   what="starcoder2-7b theorem 1")
    _, summary["sampled"] = run_sampled_path(
        torch, llm, prompts, outs, max_new, what="starcoder2-7b sampled")
    summary["spec"] = run_starcoder2_spec(torch, llm,
                                          [len(p) for p in prompts], max_new)
    summary["stride"] = run_starcoder2_stride(torch, llm, prompts, max_new)
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"starcoder2-7b phase peak memory: {summary['peak_memory_gb']:.3f}"
          f" GB allocated (torch.cuda.max_memory_allocated)", flush=True)
    return summary, graphed[2]


def dense_cohort_check(launches, st, cfg, name):
    """A dense or cohort run's launch and step checks: the dense layout
    launches no paged attention; the heads launch once a step and a
    prefill; flash once a layer a one-shot prefill; a cohort run has
    more steps than iterations, a fused run as many."""
    dense, cohort = "dense" in name, "cohort" in name
    want = {"paged_attention": 0 if dense else cfg.n_layers
            * st["decode_steps"],
            "flash_attention": cfg.n_layers * st["prefills"],
            "fused_argmax_head": st["decode_steps"] + st["prefills"]}
    got = {k: launches[k] for k in want}
    check(got == want, f"{name}: launches {got} != {want}")
    check(st["decode_steps"] > st["iterations"] if cohort
          else st["decode_steps"] == st["iterations"],
          f"{name}: decode_steps {st['decode_steps']} against iterations "
          f"{st['iterations']}")


def run_dense_cohort(torch, max_new) -> dict:
    """Phase 4j, part 2: the dense layout and the cohort scheduler on
    qwen3-0.6b at full width (seeded weights, 8 slots, max_len 1,024,
    phase 4's 12 prompts, greedy): paged fused, dense fused, paged cohort
    and dense cohort, each on a fresh engine, graphed twice (tokens
    equal; the second run's numbers kept).  In f32 every variant's
    streams equal paged fused's or part at a near-tie (the dense einsum
    is not the paged kernel, a cohort runs its GEMMs at another M); in
    bf16 they are only measured."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    base = get_config("qwen3-0.6b")
    master = seeded_params(base, 0, "cuda")
    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, base.vocab_size, size=int(n)).astype(
        np.int32) for n in prng.integers(64, 513, size=12)]
    plist = SamplingParams(max_new_tokens=max_new)
    variants = (("paged fused", {}), ("dense fused", dict(kv_layout="dense")),
                ("paged cohort", dict(scheduler="cohort")),
                ("dense cohort", dict(kv_layout="dense", scheduler="cohort")))
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        ref = None
        for name, kw in variants:
            what = f"qwen3-0.6b {name}, {dtype}"
            e = LLM(master, cfg, seed=0, n_slots=8, max_len=1024, **kw)
            runs = [drive_graphed(torch, e, prompts, plist, what)
                    for _ in range(2)]
            for n, run in enumerate(runs, 1):
                dense_cohort_check(run[2], run[3], cfg, f"{what} run {n}")
            check([o.token_ids for o in runs[1][0]]
                  == [o.token_ids for o in runs[0][0]],
                  f"{what}: run 2's tokens differ from run 1's")
            outs, _, _, st, wall = runs[1][:5]
            n_tok = sum(len(o.token_ids) for o in outs)
            row = dict(tok_s=n_tok / wall, tokens=n_tok,
                       decode_steps=st["decode_steps"],
                       iterations=st["iterations"],
                       decode_ms=st["decode_ms"] / st["decode_steps"],
                       layout=e.kv_usage()["layout"])
            print(f"{what} (graphed run 2): {n_tok} tokens in {wall:.3f} s "
                  f"= {row['tok_s']:.2f} tok/s; decode_steps "
                  f"{st['decode_steps']} / iterations {st['iterations']}, "
                  f"{row['decode_ms']:.3f} ms a step; {run_counts(runs[1])}",
                  flush=True)
            if ref is None:
                ref = (e, outs)
                row["identical_streams"] = len(outs)
            else:
                row["identical_streams"] = compare_streams(
                    torch, ref[0], prompts, ref[1], outs,
                    f"{what} vs paged fused", gate=dtype == "float32")
                del e
            out[f"{name}, {dtype}"] = row
        del ref
    return out


def check_small_reference(torch):
    """The smoke config (f32) on the card against the plain versions on
    the CPU, from one set of weights: the same tokens, or a divergence
    only at a near-tie."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("qwen3-0.6b"))
    cpu = seeded_params(cfg, 0, "cpu")
    gpu = _tree_to(cpu, "cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 33)]
    sp = SamplingParams(max_new_tokens=12)
    n0 = pa.paged_attention.launches
    a = LLM(cpu, cfg, n_slots=2, max_len=96).generate(prompts, sp)
    card = LLM(gpu, cfg, n_slots=2, max_len=96)
    b = card.generate(prompts, sp)
    check(pa.paged_attention.launches > n0, "smoke run launched no kernel")
    check(card.engine.graphs.replays > 0,
          "small reference: the card's engine replayed no graph")
    for x, y in zip(a, b):
        if x.token_ids == y.token_ids:
            continue
        llm = LLM(cpu, cfg, n_slots=1, max_len=96)
        k = next(i for i, (u, w) in enumerate(zip(x.token_ids, y.token_ids))
                 if u != w)
        gap, top = top2_gap_at(torch, llm, x.prompt_token_ids, x.token_ids,
                               k)
        print(f"small reference: rid {x.rid} diverges at step {k}, gap "
              f"{gap:.6g}", flush=True)
        check(gap <= HEAD_RTOL * abs(top), "card and CPU tokens diverge at "
              "a decided step on the smoke config")
    print(f"small reference: smoke config (f32, hd={cfg.head_dim}) tokens on "
          f"the card (graphed: {graph_line(card)}) match the plain versions "
          f"on the CPU for {len(prompts)} prompts", flush=True)


# ---------------------------------------------------------------------------
# Phase 4k: tensor parallelism (ranks that share the one card over gloo)
# ---------------------------------------------------------------------------
TP_SEED = 0                 # the host weights every rank draws
TP_WORLDS = (2, 4)
# qwen3-0.6b's depth in phase 4k's runs (of 28: each layer is two
# host-staged gloo all-reduces a step); the entry point's own run keeps
# all 28 on TP_ENTRY_PROMPTS prompts at TP_ENTRY_NEW tokens
TP_LAYERS = 4
TP_ENTRY_PROMPTS = 2
TP_ENTRY_NEW = 8
# new tokens of each of phase 4k's qwen3 runs (phase 4 serves 32; 16
# here, two host strides of 8, to pay for the moe, ssm and hybrid
# families' mesh training)
TP_MAX_NEW = 16
# each rank process, waited on by the parent (every collective of a
# rank's group times out sooner, at comm.DEFAULT_TIMEOUT_S)
TP_RANK_TIMEOUT_S = 600
TP_VOCAB_SPLITS = (2, 4, 8)
# prompts a world serves: tp 4's four processes time-slice the card and
# step at ~0.4 s on an H100 80GB HBM3, so it serves one batch of 8
# (each run against the unsharded engine on the same 8); tp 2's 12 on
# its 8 slots admit 4 waiting requests while other rows decode
TP_PROMPTS = {2: 12, 4: 8}


def check_tp_head_shards(torch, timer, v=151936, d=1024, device="cuda", *,
                         splits=TP_VOCAB_SPLITS, verify=True,
                         label="qwen3", seed=15) -> dict:
    """Phase 4k, the sharded heads alone, in this process: by default
    qwen3's (V, D) = (151,936, 1,024) bf16 head split 2, 4 and 8 ways
    into contiguous copies (slices of 75,968, 37,984 and 18,992 ids; the
    last two not multiples of the 64-id tile); ``label``'s (V, D) head
    split ``splits`` ways otherwise.  Each slice's argmax (B 8), top-k (B
    4, k 8) and, with ``verify``, verify (B 8, T 8) kernel is held
    against its plain version; the slices' (val, idx) tables, merged by
    ``core.reduced_softmax``'s merges with no collective, must equal the
    unsharded kernels' ids and values bitwise.  Slice 0's kernels are
    timed beside their bound (the slice's bytes over HBM) and the
    library call."""
    from repro_torch.core import reduced_softmax as rs
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)
    emb = (torch.randn((v, d), generator=gen, device=device)
           / math.sqrt(d)).to(torch.bfloat16)
    w = emb.t()
    h8 = torch.randn((8, d), generator=gen, device=device).to(torch.bfloat16)
    h4 = h8[:4].contiguous()
    idx, val = fah.fused_argmax_head_with_value(h8, w)
    tvals, tids = ftk.fused_topk_head(h4, w, 8)
    if verify:
        ht = torch.randn((8, 8, d), generator=gen, device=device).to(
            torch.bfloat16)
        ids0, _ = fah.fused_verify_head(ht, w, torch.full(
            (8, 7), -1, dtype=torch.int32, device=device))
        cand = torch.full((8, 7), -1, dtype=torch.int32, device=device)
        for r in range(8):                        # ragged widths 0..7
            cand[r, :r] = ids0[r, :r]
        cand[3, 1] = (cand[3, 1] + 1) % v         # a wrong draft mid-run
        vids, vacc = fah.fused_verify_head(ht, w, cand)
    rows = {}
    for n in splits:
        per = v // n
        slices = [emb[r * per:(r + 1) * per].contiguous().t()
                  for r in range(n)]
        a_tab, k_tab, v_tab = [], [], []
        for r, ws in enumerate(slices):
            lo = r * per
            a_tab.append(rs.shard_argmax_table(h8, ws, lo))
            k_tab.append(rs.shard_topk_table(h4, ws, 8, v_lo=lo, rank=r,
                                             ranks=n, vocab_size=v))
            if verify:
                v_tab.append(rs.shard_verify_table(ht, ws, cand, lo))
            torch.cuda.synchronize()
            ok = argmax_verdict(torch, h8, ws, a_tab[-1][1] - lo,
                                a_tab[-1][0])
            check(ok[0] and ok[1], f"the argmax head on V/{n} slice {r} "
                  "disagrees with its plain version")
            tv = topk_verdict(torch, h4, ws, 8, k_tab[-1][0],
                              k_tab[-1][1] - lo)
            check(tv["idx_ok"] and tv["ties_ok"] and tv["desc_ok"]
                  and tv["val_ok"], f"the top-k head on V/{n} slice {r} "
                  "disagrees with its plain version")
            if not verify:
                continue
            _, pv = ref.fused_argmax_head_with_value(
                ht.reshape(64, d), ws)
            check(torch.allclose(v_tab[-1][0].reshape(64), pv,
                                 rtol=HEAD_RTOL, atol=0.0),
                  f"the verify head's values on V/{n} slice {r} disagree "
                  "with the plain version")
        m_idx, m_val = rs.merge_argmax(torch.stack([t[0] for t in a_tab]),
                                       torch.stack([t[1] for t in a_tab]))
        m_vals, m_ids = rs.merge_topk(torch.stack([t[0] for t in k_tab]),
                                      torch.stack([t[1] for t in k_tab]), 8)
        check(torch.equal(m_idx, idx) and torch.equal(m_val, val),
              f"the argmax head merged over {n} slices != unsharded")
        check(torch.equal(m_ids, tids) and torch.equal(m_vals, tvals),
              f"the top-k head merged over {n} slices != unsharded")
        if verify:
            m_vid, _ = rs.merge_argmax(torch.stack([t[0] for t in v_tab]),
                                       torch.stack([t[1] for t in v_tab]))
            m_acc = rs.accepted_run(m_vid, cand)
            check(torch.equal(m_vid, vids) and torch.equal(m_acc, vacc),
                  f"the verify head merged over {n} slices != unsharded")
        ws = slices[0]
        sb = per * d * 2
        row = {
            "argmax_b8": kernel_row(
                timer, lambda: fah.fused_argmax_head_with_value(h8, ws),
                lambda: ref.fused_argmax_head_with_value(h8, ws),
                lambda: torch.argmax(h8 @ ws, dim=-1),
                sb + 8 * d * 2 + 8 * 8, 2.0 * 8 * d * per,
                float((m_val - val).abs().max())),
            "topk_b4_k8": kernel_row(
                timer, lambda: ftk.fused_topk_head(h4, ws, 8),
                lambda: ref.fused_topk_head(h4, ws, 8),
                lambda: torch.topk(h4 @ ws, 8, dim=-1),
                sb + 4 * d * 2 + 4 * 8 * 8, 2.0 * 4 * d * per,
                float((m_vals - tvals).abs().max()))}
        if verify:
            h2 = ht.reshape(64, d)
            row["verify_b8_t8"] = kernel_row(
                timer, lambda: fah.fused_verify_head(ht, ws, cand,
                                                     with_value=True),
                lambda: ref.verify_draft_with_value(ht, ws, cand),
                lambda: torch.argmax(h2 @ ws, dim=-1),
                sb + 64 * d * 2 + cand.numel() * 4 + 64 * 8 + 8 * 4,
                2.0 * 64 * d * per, 0.0)
        for name, r in row.items():
            print(f"phase 4k {label} head shard V/{n} = {per} ids, {name}: "
                  "kernel "
                  f"{shown(r)}, plain {r['plain_ms']:.4f} ms, library "
                  f"{shown(r, 'library_')}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); merged over {n} slices bitwise equal "
                  "to the unsharded kernel", flush=True)
        rows[per] = row
    return rows


def check_tp_family_kernels(torch, timer) -> dict:
    """Phase 4k, the kernels of the recurrent families' rank slices
    against their plain versions, timed beside bound and library call:
    the argmax (B 8) and top-k (B 4, k 8) heads on rwkv6-7b's untied
    (65,536, 4,096) head split 2 and 4 ways (rows 2h, 3f) and on
    recurrentgemma-2b's tied (256,000, 2,560) head split 2 ways (rows 2i,
    3g), each merge bitwise the unsharded kernel's
    (``check_tp_head_shards``); flash attention at a tp 2 rank's heads
    of recurrentgemma-2b, 5 q heads over a copy of the one KV head, T
    2,150, hd 256, window 2,048 (row 5i, ``rg_flash_row``)."""
    rows = {"rwkv6": check_tp_head_shards(
        torch, timer, v=65536, d=4096, splits=(2, 4), verify=False,
        label="rwkv6-7b", seed=29),
        "recurrentgemma": check_tp_head_shards(
        torch, timer, v=256000, d=2560, splits=(2,), verify=False,
        label="recurrentgemma-2b", seed=27)}
    gen = torch.Generator(device="cuda").manual_seed(32)
    label = "phase 4k recurrentgemma-2b at a tp 2 rank's heads"
    row = rows["flash_g5"] = rg_flash_row(torch, timer, gen,
                                          RG_FLASH[1] // 2, label)
    print(f"{label}, flash_attention T=2150 5 q / 1 kv hd=256 window=2048: "
          f"kernel {shown(row)}, plain {row['plain_ms']:.4f} ms, sdpa(mask) "
          f"{shown(row, 'library_')}, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); max_abs_err {row['max_abs_err']:.6g}",
          flush=True)
    return rows


def check_tp_paged_heads(torch, timer) -> dict:
    """Phase 4k, paged attention at a rank's heads (B 8, T 1, ragged rows
    of 1-1,000 positions): tp 2 8 q / 4 kv heads, tp 4 4 / 2 (g 2 kept),
    against the plain version, timed beside bound and library call."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(16)
    rows = {}
    for tp in TP_WORLDS:
        hq, hkv = 16 // tp, 8 // tp
        q, kp, vp, bt, pos = paged_case(torch, rng, 1, b=8, hq=hq, hkv=hkv)
        out = pa.paged_attention(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        want = ref.paged_attention(q, kp, vp, bt, pos)
        err = (out.float() - want.float()).abs().max().item()
        check(torch.allclose(out.float(), want.float(), atol=PA_TOL,
                             rtol=PA_TOL),
              f"paged attention at tp {tp}'s heads disagrees with its plain "
              f"version ({err})")
        nbytes, flops = paged_work(q, kp, bt, pos, None)
        row = kernel_row(
            timer, lambda: pa.paged_attention(q, kp, vp, bt, pos),
            lambda: ref.paged_attention(q, kp, vp, bt, pos),
            sdpa_on_gathered_view(torch, q, kp, vp, bt, pos, None,
                                  1 / math.sqrt(128)), nbytes, flops, err)
        row["chunks"] = pa.split_for(q, kp, bt)[0]
        print(f"phase 4k paged_attention B=8 T=1 at tp {tp}'s heads "
              f"({hq} q / {hkv} kv): kernel {shown(row)}, plain "
              f"{row['plain_ms']:.4f} ms, sdpa(gathered view) "
              f"{shown(row, 'library_')}, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); max_abs_err {err:.6g}", flush=True)
        rows[tp] = row
    return rows


def tp_runs(max_new):
    """Phase 4k's engine runs, at every tp: (name, dtype, engine kwargs,
    params kind, prompts kind).  f32 runs are held to the unsharded
    engine's tokens; the bf16 greedy run is measured (and timed)."""
    runs = (("greedy_f32", "float32", {}, "greedy", "main"),
            ("mixed_f32", "float32", {}, "mixed", "main"),
            ("spec4_f32", "float32", {}, "spec4", "spec"),
            ("stride8_f32", "float32", {"host_stride": 8}, "mixed", "main"),
            ("chunk64_f32", "float32", {"chunk_size": 64}, "greedy",
             "main"),
            ("greedy_bf16", "bfloat16", {}, "greedy", "main"))
    return runs


def tp_inputs(vocab, max_new, n=12):
    """The first ``n`` prompts (of phase 4's 12 of 64-512 tokens; phase
    4c's repetitive ones for spec_k) and each params kind, the same in
    every process."""
    from repro_torch.serve.params import SamplingParams

    prng = np.random.default_rng(0)
    main = [prng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in prng.integers(64, 513, size=12)]
    rng = np.random.default_rng(4)
    spec = [np.tile(rng.integers(0, vocab, size=32), len(p) // 32 + 1)
            [:len(p)].astype(np.int32) for p in main]
    params = {"greedy": SamplingParams(max_new_tokens=max_new),
              "mixed": stride_params(max_new)[:n],
              "spec4": SamplingParams(max_new_tokens=max_new, spec_k=4)}
    return {"main": main[:n], "spec": spec[:n]}, params


def tp_engine_kwargs(**kw) -> dict:
    """Every phase-4k engine: 8 slots of 1,024 positions, seed 0, no eos
    (every request runs its tokens, so every split serves the same
    batches)."""
    return dict(n_slots=8, max_len=1024, seed=0, eos_id=-1, **kw)


def check_tp_launches(launches, st, cfg, what, flash):
    """A run's kernel launches against its steps: paged attention 28 a
    decode iteration, flash attention 28 a one-shot prefill (0 when the
    prompts enter as chunks), each head kernel once a head call of its
    kind (the verify kernel once a step with drafts); no softmax unit."""
    calls = st["head_calls"]
    want = {"paged_attention": cfg.n_layers * st["decode_iterations"],
            "flash_attention": cfg.n_layers * st["prefills"] if flash
            else 0,
            "fused_argmax_head": calls.get("Greedy", 0),
            "fused_topk_head": calls.get("TopK", 0),
            "fused_verify_head": calls.get("verify", 0),
            "softmax_stats": 0, "online_softmax": 0, "fused_xent": 0}
    for name, n in want.items():
        check(launches[name] == n, f"{what}: {name} launched "
              f"{launches[name]} times, want {n} ({st['decode_iterations']}"
              f" decode iterations, {st['prefills']} prefills, head calls "
              f"{calls})")


def tp_rank_main(rank: int, world: int, d: str) -> int:
    """One rank of phase 4k (``chip_smoke.py --tp-rank R --tp-world W
    --tp-dir D``, torchrun's variables in its environment): an f32
    greedy engine through ``LLM.from_arch(tp=W, dtype="float32")`` at
    full depth on the first TP_ENTRY_PROMPTS prompts, whose group (over
    gloo on the shared card, from that environment) the other runs share
    -- the parent holds its tokens to the unsharded
    ``LLM.from_arch(dtype="float32")``'s: one seed, one tree --, then the
    host weights from TP_SEED of qwen3-0.6b cut to TP_LAYERS layers, each
    run of ``tp_runs`` through
    ``LLM.generate`` at ``tp=world`` (the launch counts set to 0 just
    before and read just after, and checked against the run's steps),
    the per-step collective bytes and the heads' bytes at B 8; the
    results go to ``<d>/out<W>_<R>.json``."""
    import dataclasses

    import torch

    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.serve import sampler as smp
    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "world": world}
    try:
        # the entry point a user calls under torchrun, at full depth;
        # from_arch draws the same host tree from TP_SEED as the parent
        first = LLM.from_arch("qwen3-0.6b", smoke=False, tp=world,
                              dtype="float32",
                              **dict(tp_engine_kwargs(), seed=TP_SEED))
        g = first.engine.group
        out.update(device=str(g.device), backend=g.backend,
                   card=torch.cuda.get_device_name(g.device))
        max_new = TP_MAX_NEW
        prompts, params = tp_inputs(first.cfg.vocab_size, max_new,
                                    TP_PROMPTS[world])
        torch.cuda.synchronize()
        reset_launches()
        st0 = stats_now(first)
        outs = first.generate(
            prompts["main"][:TP_ENTRY_PROMPTS],
            type(params["greedy"])(max_new_tokens=TP_ENTRY_NEW))
        torch.cuda.synchronize()
        check_tp_launches(read_launches(), stats_delta(st0, stats_now(first)),
                          first.engine.cfg, f"tp {world} rank {rank} "
                          "from_arch", flash=True)
        out["from_arch_f32"] = dict(tokens=[list(o.token_ids) for o in outs],
                                    rids=[o.rid for o in outs])
        del first, outs
        cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                                  n_layers=TP_LAYERS)
        host = seeded_params(cfg, TP_SEED, "cpu")
        for name, dtype, kw, pk, prk in tp_runs(max_new):
            llm = LLM(host, dataclasses.replace(cfg, dtype=dtype),
                      tp=world, group=g, **tp_engine_kwargs(**kw))
            eng = llm.engine
            steps = []
            if name == "greedy_bf16":
                # the collective bytes of each decode step
                inner = eng._decode_rows

                def rows_with_bytes(rows, inner=inner):
                    b0 = dict(g.bytes)
                    inner(rows)
                    steps.append((len(rows), {
                        k: n - b0.get(k, 0) for k, n in g.bytes.items()
                        if n - b0.get(k, 0)}))
                eng._decode_rows = rows_with_bytes
                llm.generate([prompts[prk][0][:16]],
                             type(params[pk])(max_new_tokens=2))
                steps.clear()
            torch.cuda.synchronize()
            reset_launches()
            st0 = stats_now(llm)
            t0 = time.perf_counter()
            outs = llm.generate(prompts[prk], params[pk])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            st = stats_delta(st0, stats_now(llm))
            check_tp_launches(launches, st, eng.cfg, f"tp {world} rank "
                              f"{rank} {name}", flash="chunk_size" not in kw)
            check(eng.graphs.captures == 0, f"{name}: a sharded engine "
                  "captured a graph")
            n_tok = sum(len(o.token_ids) for o in outs)
            out[name] = dict(
                tokens=[list(o.token_ids) for o in outs],
                rids=[o.rid for o in outs], launches=launches,
                decode_steps=st["decode_steps"],
                decode_iterations=st["decode_iterations"],
                prefills=st["prefills"], head_calls=st["head_calls"],
                accepted=st["accepted"], drafted=st["drafted"],
                prefix_hits=st["prefix_hits"],
                prefill_chunks=st["prefill_chunks"], wall_s=wall,
                tok_s=n_tok / wall,
                decode_ms=st["decode_ms"] / max(st["decode_steps"], 1),
                prefill_ms=st["prefill_ms"] / max(st["prefills"], 1),
                head_mode=eng.head_mode, local_heads=[
                    eng.cfg.n_heads, eng.cfg.n_kv_heads, eng.cfg.d_ff])
            if name == "greedy_bf16":
                full = [b for n, b in steps if n == 8]
                out[name]["step_bytes_b8"] = full[-1] if full else None
                # the heads' own traffic at B 8, one call each
                h = torch.randn((8, cfg.d_model), device=g.device,
                                dtype=torch.bfloat16)
                heads = {}
                for label, s in (("argmax", smp.Greedy("sharded")),
                                 ("topk_k8", smp.TopK(8, 1.0, "sharded")),
                                 ("temperature", smp.Temperature(0.7))):
                    g.bytes.clear()
                    s.head(eng.params, eng.cfg, h)
                    heads[label] = dict(g.bytes)
                out[name]["head_bytes_b8"] = heads
                out["weights_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in _leaves(eng.params))
            del llm, eng
            gc.collect()
            torch.cuda.empty_cache()
        f32 = dataclasses.replace(cfg, dtype="float32")
        if world == 4:
            out["router_f32"] = tp_router_run(torch, host, f32, g, rank,
                                              prompts["main"],
                                              params["greedy"])
        if world == 2:
            out["http_f32"] = tp_http_run(torch, host, f32, g, rank,
                                          prompts["main"], max_new)
            out["moe_f32"] = tp_moe_run(torch, g, rank)
        out["families"] = tp_family_runs(torch, g, rank, world)
        out["mesh_train"] = tp_train_runs(torch, g, rank, world, d)
        out["ok"] = True
        g.close()
    except Exception as e:                    # reported by the parent
        import traceback

        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
        out["trace"] = traceback.format_exc()[-4000:]
    with open(os.path.join(d, f"out{world}_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0 if out["ok"] else 1


MOE_TP_LAYERS = 2
MOE_TP_NEW = 16


def moe_tp_config():
    """Phase 4k's MoE model: phi3.5-moe at full width, 2 layers, f32."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TP_LAYERS,
                               dtype="float32")


def tp_moe_run(torch, g, rank) -> dict:
    """Phase 4k's MoE run (world 2, every rank): ``moe_tp_config``'s model
    from the host tree of TP_SEED, each rank holding 8 of the 16 experts
    and routing over all 16 (``parallel.moe_ep``), greedy on phase 4n's 8
    prompts at MOE_TP_NEW tokens; the launch counts set to 0 just before
    and read just after, checked against its steps."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    cfg = moe_tp_config()
    llm = LLM(seeded_params(cfg, TP_SEED, "cpu"), cfg, tp=2, group=g,
              **tp_engine_kwargs())
    eng = llm.engine
    prompts = moe_prompts(cfg.vocab_size)
    torch.cuda.synchronize()
    reset_launches()
    st0 = stats_now(llm)
    t0 = time.perf_counter()
    outs = llm.generate(prompts, SamplingParams(max_new_tokens=MOE_TP_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = stats_delta(st0, stats_now(llm))
    check_tp_launches(launches, st, eng.cfg, f"tp 2 rank {rank} moe_f32",
                      flash=True)
    res = dict(tokens=[list(o.token_ids) for o in outs],
               rids=[o.rid for o in outs], launches=launches,
               experts=list(eng.cfg.shard.experts),
               num_experts=eng.cfg.moe.num_experts,
               decode_steps=st["decode_steps"], prefills=st["prefills"],
               wall_s=wall, tok_s=sum(len(o.token_ids) for o in outs) / wall,
               weights_bytes=sum(t.numel() * t.element_size()
                                 for t in _leaves(eng.params)))
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_tp_moe(torch, res) -> dict:
    """Phase 4k's MoE run as the ranks wrote it, against the unsharded f32
    engine on the same tree (``seeded_params`` of TP_SEED, drawn here on
    the card after the ranks are done): every rank its half of the
    experts, the same tokens on both ranks, each stream the unsharded
    engine's (near-tie rule)."""
    import types

    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    r0 = res[0]["moe_f32"]
    for r, out in enumerate(res):
        run = out["moe_f32"]
        check(run["experts"] == [8 * r, 8 * r + 8] and run["num_experts"]
              == 16, f"tp 2 moe rank {r}: experts {run['experts']} of "
              f"{run['num_experts']}")
        check(run["tokens"] == r0["tokens"], f"tp 2 moe: rank {r}'s tokens "
              "differ from rank 0's")
    cfg = moe_tp_config()
    ref = LLM(seeded_params(cfg, TP_SEED, "cuda"), cfg, **tp_engine_kwargs())
    prompts = moe_prompts(cfg.vocab_size)
    want = ref.generate(prompts, SamplingParams(max_new_tokens=MOE_TP_NEW))
    got = [types.SimpleNamespace(token_ids=tuple(t), rid=i)
           for i, t in zip(r0["rids"], r0["tokens"])]
    what = (f"phase 4k tp 2 phi3.5-moe ({MOE_TP_LAYERS} layers, f32, 8 "
            "experts a rank)")
    same = compare_streams(torch, ref, prompts, want, got, what)
    print(f"{what}: {same}/{len(got)} streams equal to the unsharded f32 "
          f"engine's; {r0['tok_s']:.2f} tok/s ({r0['wall_s']:.2f} s, "
          f"{r0['decode_steps']} decode steps, eager over gloo), weights "
          f"{r0['weights_bytes'] / 1e9:.3f} GB a rank; launches "
          f"{r0['launches']}", flush=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return dict(same=same, streams=len(got), tok_s=r0["tok_s"],
                decode_steps=r0["decode_steps"], launches=r0["launches"],
                weights_bytes=r0["weights_bytes"])


def _run_stats(eng, st0) -> dict:
    """An engine's counters' growth since ``st0`` (``stats_now``'s copy)."""
    import types

    return stats_delta(st0, stats_now(types.SimpleNamespace(engine=eng)))


def tp_router_run(torch, host, f32, g, rank, prompts, params) -> dict:
    """Phase 4k's router run (world 4, every rank): ``Router(replicas=2,
    tp=2)`` over the world, replica r the ranks [2r, 2r + 2), each a tp 2
    engine of phase 4k's kwargs, serving ``prompts`` greedy through
    ``Router.generate`` (world rank 0 routes; every rank returns the
    outputs); the launch counts set to 0 just before and read just after,
    checked against this rank's engine's steps."""
    import types

    from repro_torch.serve.router import Router

    router = Router(host, f32, replicas=2, tp=2, group=g,
                    **tp_engine_kwargs())
    eng = router.engine
    router.generate([prompts[0][:16]], type(params)(max_new_tokens=2))
    torch.cuda.synchronize()
    reset_launches()
    st0 = stats_now(types.SimpleNamespace(engine=eng))
    c0 = g.bytes.get("control", 0)
    t0 = time.perf_counter()
    outs = router.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = _run_stats(eng, st0)
    check_tp_launches(launches, st, eng.cfg, f"router rank {rank}",
                      flash=True)
    control = g.bytes.get("control", 0) - c0
    pay = router.stats_payload()
    n_tok = sum(len(o.token_ids) for o in outs)
    return dict(tokens=[list(o.token_ids) for o in outs],
                rids=[o.rid for o in outs], replica=router.index,
                served=[r.served for r in router.replicas],
                launches=launches, decode_steps=st["decode_steps"],
                decode_ms=st["decode_ms"] / max(st["decode_steps"], 1),
                prefills=st["prefills"], wall_s=wall, tok_s=n_tok / wall,
                world_control_bytes=control,
                emitted=pay["engine"]["emitted_tokens"],
                per_replica=[r["engine"]["emitted_tokens"]
                             for r in pay["replicas"]])


def tp_http_run(torch, host, f32, g, rank, prompts, max_new) -> dict:
    """Phase 4k's HTTP run (world 2): ``LLM(tp=2)`` of phase 4k's kwargs
    behind ``serve.server.make_server`` on rank 0 (its pump ticks rank 1,
    which runs ``serve_forever``, the follow loop): every prompt posted
    at once from its own thread (greedy, JSON), then prompt 0 streamed;
    ``/v1/stats`` and ``/healthz``; then ``shutdown`` and ``stop_pump``,
    which returns rank 1 from its loop.  Launch counts set to 0 before
    the server starts and read after it stops, on each rank against its
    engine's steps."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.serve.server import make_server, serve_forever

    llm = LLM(host, f32, tp=2, group=g, **tp_engine_kwargs())
    llm.generate([prompts[0][:16]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()
    reset_launches()
    st0 = stats_now(llm)
    t0 = time.perf_counter()
    res = {}
    if rank != 0:
        serve_forever(llm)
        res["followed_s"] = time.perf_counter() - t0
    else:
        srv = make_server(llm, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def post(prompt, stream=False):
            body = json.dumps({"prompt": [int(t) for t in prompt],
                               "max_new_tokens": max_new,
                               "stream": stream}).encode()
            req = urllib.request.Request(
                f"{base}/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.read().decode()

        try:
            t1 = time.perf_counter()
            with ThreadPoolExecutor(len(prompts)) as pool:
                full = [json.loads(x) for x in pool.map(post, prompts)]
            wall = time.perf_counter() - t1
            raw = post(prompts[0], stream=True)
            lines = [x[6:] for x in raw.splitlines()
                     if x.startswith("data: ")]
            stats = json.loads(urllib.request.urlopen(
                f"{base}/v1/stats", timeout=60).read())
            health = json.loads(urllib.request.urlopen(
                f"{base}/healthz", timeout=60).read())
        finally:
            srv.shutdown()
            llm.stop_pump()
        n_tok = sum(len(f["token_ids"]) for f in full)
        res.update(tokens=[f["token_ids"] for f in full],
                   rids=[f["rid"] for f in full], wall_s=wall,
                   tok_s=n_tok / wall, done=lines[-1],
                   streamed=[json.loads(x)["token"] for x in lines[:-1]],
                   emitted=stats["engine"]["emitted_tokens"],
                   health_ok=health["ok"],
                   pump_error=repr(llm._pump_error))
    torch.cuda.synchronize()
    launches = read_launches()
    st = _run_stats(llm.engine, st0)
    check_tp_launches(launches, st, llm.engine.cfg, f"http rank {rank}",
                      flash=True)
    res.update(launches=launches, decode_steps=st["decode_steps"],
               decode_ms=st["decode_ms"] / max(st["decode_steps"], 1),
               prefills=st["prefills"])
    return res


def spawn_tp(world: int, d: str, beside=None) -> list:
    """Start and wait on phase 4k's ``world`` rank processes, each with a
    timeout of its own (the lot killed on one miss, or when ``beside``
    raises); returns each rank's results.  ``beside()``, where given,
    runs here once the ranks have started (work the ranks wait on
    later)."""
    import socket

    with socket.socket() as s:             # a free port for the store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        log = open(os.path.join(d, f"log{world}_{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
             "--tp-world", str(world), "--tp-dir", d],
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="2", RANK=str(r),
                     # ranks that share one card: segments that grow in
                     # place keep each one's cache close to what it holds
                     PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
                     WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))), log))
    try:
        if beside is not None:
            beside()
        for r, (p, _) in enumerate(procs):
            try:
                p.wait(timeout=TP_RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                check(False, f"tp {world} rank {r} ran past "
                      f"{TP_RANK_TIMEOUT_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    res = []
    for r in range(world):
        path = os.path.join(d, f"out{world}_{r}.json")
        if not os.path.exists(path):
            with open(os.path.join(d, f"log{world}_{r}.txt")) as f:
                tail = f.read()[-3000:]
            check(False, f"tp {world} rank {r} wrote no result "
                  f"(exit {procs[r][0].returncode}):\n{tail}")
        with open(path) as f:
            res.append(json.load(f))
        check(res[-1]["ok"], f"tp {world} rank {r} failed: "
              f"{res[-1].get('error')}\n{res[-1].get('trace', '')}")
    return res


def check_control_plane(torch, gap_llm, res, world, inputs, ref32,
                        n) -> dict:
    """Phase 4k's control-plane runs as the ranks wrote them: world 4's
    router and world 2's HTTP server, their f32 greedy tokens held to the
    unsharded engine's (near-tie rule), every rank's router outputs equal
    rank 0's, both replicas served, the fleet's emitted tokens the
    replicas' sum; the HTTP stream equal to its plain completion, the
    follower back from its loop.  Returns the summary's entries."""
    import types

    r0 = res[0]
    name = "router_f32" if world == 4 else "http_f32"
    run = r0[name]
    got = [types.SimpleNamespace(token_ids=tuple(t), rid=i)
           for i, t in zip(run["rids"], run["tokens"])]
    what = (f"phase 4k tp {world} " + ("Router(replicas=2, tp=2)"
                                       if world == 4 else "HTTP (tp 2)"))
    same = compare_streams(torch, gap_llm, inputs[0]["main"],
                           ref32[n, "greedy_f32"], got, what)
    if world == 4:
        for r in res[1:]:
            check(r[name]["tokens"] == run["tokens"],
                  f"{what}: rank {r['rank']}'s outputs differ from rank 0's")
        check(all(s > 0 for s in run["served"]),
              f"{what}: a replica served nothing ({run['served']})")
        check(run["emitted"] == sum(run["per_replica"]),
              f"{what}: emitted {run['emitted']} != the replicas' "
              f"{run['per_replica']}")
        for r in res:
            check(r[name]["launches"]["paged_attention"] > 0
                  and r[name]["launches"]["fused_argmax_head"] > 0,
                  f"{what}: rank {r['rank']} launched no paged or argmax "
                  "kernel")
        line = (f"routed {run['served']}, world control bytes "
                f"{run['world_control_bytes']} (rank 0)")
    else:
        check(run["streamed"] == list(run["tokens"][0]), f"{what}: the "
              "streamed tokens differ from the plain completion's")
        check(run["done"] == "[DONE]" and run["health_ok"]
              and run["pump_error"] == "None", f"{what}: the server "
              f"ended badly: {run['done']} {run['health_ok']} "
              f"{run['pump_error']}")
        check(res[1][name]["followed_s"] > 0, f"{what}: rank 1 never "
              "followed")
        line = (f"stream == plain; rank 1 back from its follow loop after "
                f"{res[1][name]['followed_s']:.1f} s")
    batch = r0["greedy_f32"]["tok_s"]
    print(f"{what}: {same}/{len(got)} streams equal to the unsharded f32 "
          f"engine's; {run['tok_s']:.2f} tok/s ({run['tok_s'] / batch:.2f}x "
          f"tp {world}'s batch greedy_f32, {batch:.2f}), "
          f"{run['wall_s']:.2f} s, {run['decode_steps']} decode steps on "
          f"rank 0's engine; launches {run['launches']}; {line}", flush=True)
    key = "router" if world == 4 else "http"
    return {key: dict(same=same, streams=len(got), tok_s=run["tok_s"],
                      vs_batch_greedy_f32=run["tok_s"] / batch,
                      decode_steps=run["decode_steps"],
                      launches=run["launches"],
                      **({"served": run["served"], "world_control_bytes":
                          run["world_control_bytes"]} if world == 4 else {})),
            "timing": {f"{key}_f32_tp2_{n}_prompts": dict(
                tok_s=run["tok_s"], wall_s=run["wall_s"],
                decode_ms=run["decode_ms"])}}


# ---------------------------------------------------------------------------
# Phase 4k, the recurrent and vlm families under tensor parallelism
# ---------------------------------------------------------------------------
FAM_TP_NEW = 16
# (arch, layers kept, the worlds it runs at): rwkv6-7b at 2 of its 32
# layers, recurrentgemma-2b at one (rec, rec, attn) unit of its 26 (its
# 10 heads are not whole at tp 4); full width both
FAM_TP = (("rwkv6-7b", 2, (2, 4)), ("recurrentgemma-2b", 3, (2,)))
VLM_TP_PREFIX = 16        # tokens after the stub image embeddings


def fam_tp_config(arch: str, layers: int, dtype: str):
    """``arch`` at full width with its depth cut to ``layers``."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=layers,
                               dtype=dtype)


def fam_samplers() -> tuple:
    """The 4 rows' samplers: greedy with row 1 TopK (k 8, temperature
    0.8), and greedy alone."""
    from repro_torch.serve.params import SamplingParams

    greedy = SamplingParams(max_new_tokens=FAM_TP_NEW)
    topk = SamplingParams(max_new_tokens=FAM_TP_NEW, top_k=8,
                          temperature=0.8, seed=5)
    return [greedy, topk, greedy, greedy], greedy


def fam_tp_inputs(arch: str, vocab: int) -> tuple:
    """4 prompts -- rwkv6-7b's phase-4m prompts 0 and 2-4 (3 and 4-399
    tokens), recurrentgemma-2b's phase-4l prompts 0-2 and 6 (up to 1,000
    tokens and one of 2,100-2,200, past the 2,048-token window) -- and
    ``fam_samplers``."""
    if arch == "rwkv6-7b":
        ps = rw_prompts(vocab)
        prompts = [ps[0], *ps[2:5]]
    else:
        ps = rg_prompts(vocab)
        prompts = [*ps[:3], ps[6]]
    return (prompts, *fam_samplers())


def fam_engine_kwargs(arch: str) -> dict:
    """4 slots, seed 0, no eos; rwkv6's state is O(1) in the length, the
    hybrid's ring buffers hold the 2,048-token window."""
    return dict(n_slots=4, max_len=RG_MAX_LEN if arch
                == "recurrentgemma-2b" else 512, seed=0, eos_id=-1)


def check_family_launches(launches, st, llm, what):
    """A run's launches against its steps: paged attention once an
    attention layer a decode step where the store pages (the vlm smoke
    config), flash attention once an attention layer a one-shot prefill
    (recurrentgemma-2b's windowed layer; none in rwkv6), each head kernel
    once a head call of its kind on the rank's vocabulary slice; no
    verify or softmax-unit kernel."""
    per_step, per_prefill = attention_layers(llm)
    calls = st["head_calls"]
    want = {"paged_attention": per_step * st["decode_iterations"],
            "flash_attention": per_prefill * st["prefills"],
            "fused_argmax_head": calls.get("Greedy", 0),
            "fused_topk_head": calls.get("TopK", 0),
            "fused_verify_head": 0, "softmax_stats": 0,
            "online_softmax": 0, "fused_xent": 0}
    for name, n in want.items():
        check(launches[name] == n, f"{what}: {name} launched "
              f"{launches[name]} times, want {n} ({st['decode_iterations']}"
              f" decode iterations, {st['prefills']} prefills, head calls "
              f"{calls})")


def fam_run(torch, llm, prompts, plist, what, bytes_of=None) -> dict:
    """One ``generate`` with the launch counts set to 0 just before and
    read just after, checked against its steps (``check_family_launches``);
    with ``bytes_of`` (the rank's group) the collective bytes of each
    decode step of all 4 rows, by kind."""
    eng = llm.engine
    steps = []
    if bytes_of is not None:
        inner = eng._decode_rows

        def rows_with_bytes(rows, inner=inner):
            b0 = dict(bytes_of.bytes)
            inner(rows)
            steps.append((len(rows), {
                k: n - b0.get(k, 0) for k, n in bytes_of.bytes.items()
                if n - b0.get(k, 0)}))
        eng._decode_rows = rows_with_bytes
    torch.cuda.synchronize()
    reset_launches()
    st0 = stats_now(llm)
    t0 = time.perf_counter()
    outs = llm.generate(prompts, plist)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = stats_delta(st0, stats_now(llm))
    check_family_launches(launches, st, llm, what)
    check(eng.graphs.captures == 0 or eng.cfg.shard is None,
          f"{what}: a sharded engine captured a graph")
    full = [b for n, b in steps if n == len(prompts)]
    return dict(tokens=[list(o.token_ids) for o in outs],
                rids=[o.rid for o in outs], launches=launches,
                decode_steps=st["decode_steps"], prefills=st["prefills"],
                head_calls=st["head_calls"], wall_s=wall,
                tok_s=sum(len(o.token_ids) for o in outs) / wall,
                decode_ms=st["decode_ms"] / max(st["decode_steps"], 1),
                prefill_ms=st["prefill_ms"] / max(st["prefills"], 1),
                step_bytes=full[-1] if full else None,
                head_mode=eng.head_mode)


def vlm_tp_inputs(torch, cfg, device) -> tuple:
    """The vlm smoke config's inputs (numpy seed 33): 4 token prompts of
    5-40 tokens, and the image-prefix prefill's (2, 16) token ids with
    (2, 8, D) stub image embeddings on ``device``."""
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(5, 41, size=4)]
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(2, VLM_TP_PREFIX))).to(device)
    img = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)).to(device)
    return prompts, toks, img


def vlm_prefix(torch, llm, toks, img) -> dict:
    """``lm.prefill`` of ``toks`` after the image embeddings ``img`` on
    ``llm``'s engine (a rank's slice under tp), then its head's argmax
    (``Greedy``: the sharded head on a rank), the launch counts set to 0
    just before and read just after."""
    from repro_torch.models import lm
    from repro_torch.serve import sampler as smp

    eng = llm.engine
    torch.cuda.synchronize()
    reset_launches()
    h, _ = lm.prefill(eng.params, eng.cfg, toks, 32, image_embeds=img)
    ids = smp.Greedy(eng.head_mode).head(eng.params, eng.cfg, h)
    torch.cuda.synchronize()
    return dict(h=h.cpu().tolist(), ids=ids.cpu().tolist(),
                launches=read_launches())


def tp_vlm_run(torch, g, rank) -> dict:
    """Phase 4k's vlm run (world 2, every rank): internvl2-26b's smoke
    config in f32 from the host tree of TP_SEED, ``LLM(tp=2)`` (paged,
    each rank 2 of the 4 query heads over 1 of the 2 KV heads) on
    ``vlm_tp_inputs``' 4 prompts, greedy with row 1 TopK, its launches
    checked against its steps; then the image prefix through
    ``lm.prefill`` on the rank's slice: the token embeddings summed over
    the ranks, the 8 image embeddings put in after the sum."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("internvl2-26b"))
    llm = LLM(seeded_params(cfg, TP_SEED, "cpu"), cfg, tp=2, group=g,
              n_slots=4, max_len=64, seed=0, eos_id=-1)
    prompts, toks, img = vlm_tp_inputs(torch, cfg, g.device)
    mixed, _ = fam_samplers()
    res = fam_run(torch, llm, prompts, mixed, f"tp 2 rank {rank} vlm smoke")
    res["prefix"] = vlm_prefix(torch, llm, toks, img)
    res["local_heads"] = [llm.engine.cfg.n_heads, llm.engine.cfg.n_kv_heads]
    res["paged"] = llm.engine.store.any_paged
    del llm
    gc.collect()
    return res


# seamless-m4t-large-v2 served at tp 2 through lm.prefill /
# lm.decode_step (the engine serves no encoder-decoder config): its
# MESH_MODELS depth (2 + 2 layers) at full width, f32, the first
# ED_TP_TOKENS tokens of 4 rows of a TokenPipeline batch over its
# ED_TP_SRC stub source frames, ED_TP_NEW greedy steps
ED_TP_ROWS, ED_TP_TOKENS, ED_TP_SRC, ED_TP_NEW = 4, 16, 64, 16


def ed_tp_inputs(torch, cfg, device) -> tuple:
    """(tokens (ED_TP_ROWS, ED_TP_TOKENS), source frames (ED_TP_ROWS,
    ED_TP_SRC, D)) on ``device``: a TokenPipeline batch of seed 0."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    b = TokenPipeline(DataConfig(seed=0, vocab_size=cfg.vocab_size), cfg,
                      ShapeSpec("ed", ED_TP_SRC, ED_TP_ROWS, "train"),
                      device).batch(0)
    return b["tokens"][:, :ED_TP_TOKENS].long(), b["src_embeds"]


def tp_encdec_run(torch, g, rank) -> dict:
    """Phase 4k's encdec run (world 2, every rank): seamless-m4t-large-v2
    at full width and its MESH_MODELS depth in f32 from the host tree of
    TP_SEED, the rank's slice (8 of 16 heads in the encoder, the
    decoder's self- and cross-attention; 4,096 MLP columns; V / 2 ids):
    ``lm.prefill`` over ``ed_tp_inputs`` then ED_TP_NEW greedy
    ``lm.decode_step``s, each token from the sharded argmax head on the
    rank's vocabulary slice (``encdec_decode``), the launches and the
    collective bytes."""
    from repro_torch.parallel import sharding
    from repro_torch.serve import sampler as smp
    from repro_torch.weights import cast_params, seeded_params, shard_params

    cfg = mesh_config(ED_ARCH, "float32")
    split = sharding.plan(cfg, rank, g.world, group=g)
    local = sharding.local_config(cfg, split)
    # cast_params: the head slice in the layout the head kernels read
    params = cast_params(_tree_to(shard_params(seeded_params(
        cfg, TP_SEED, "cpu"), cfg, split), g.device), local)
    toks, src = ed_tp_inputs(torch, cfg, g.device)
    b0 = dict(g.bytes)
    out, _, pre, dec = encdec_decode(torch, params, local, toks, src,
                                     smp.Greedy("sharded"), ED_TP_NEW)
    res = dict(tokens=out.cpu().tolist(), vocab=list(split.vocab),
               local=[local.n_heads, local.n_kv_heads, local.d_ff],
               prefill_launches=pre, step_launches=dec, bytes={
                   k: n - b0.get(k, 0) for k, n in g.bytes.items()
                   if n - b0.get(k, 0)})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_family_runs(torch, g, rank, world) -> dict:
    """Phase 4k's recurrent-family runs (every rank): each ``FAM_TP``
    model of this world from the host tree of TP_SEED -- an f32 engine
    (greedy rows and a TopK row) held by the parent to the unsharded
    engine's, then a bf16 greedy engine, warmed on one short prompt and
    timed, with the collective bytes of each 4-row decode step -- and at
    world 2 the vlm smoke config (``tp_vlm_run``) and seamless
    (``tp_encdec_run``)."""
    import dataclasses

    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    out = {}
    for arch, layers, worlds in FAM_TP:
        if world not in worlds:
            continue
        cfg32 = fam_tp_config(arch, layers, "float32")
        t0 = time.perf_counter()
        host = seeded_params(cfg32, TP_SEED, "cpu")
        res = {"draw_s": time.perf_counter() - t0}
        prompts, mixed, greedy = fam_tp_inputs(arch, cfg32.vocab_size)
        for name, dtype, plist in (("mixed_f32", "float32", mixed),
                                   ("greedy_bf16", "bfloat16", greedy)):
            llm = LLM(host, dataclasses.replace(cfg32, dtype=dtype),
                      tp=world, group=g, **fam_engine_kwargs(arch))
            what = f"tp {world} rank {rank} {arch} {name}"
            if dtype == "bfloat16":
                llm.generate([prompts[0][:16]], type(greedy)(
                    max_new_tokens=2))
            res[name] = fam_run(torch, llm, prompts, plist, what,
                                g if dtype == "bfloat16" else None)
            c = llm.engine.cfg
            res[name].update(chan=list(c.shard.chan), local=[
                c.n_heads, c.n_kv_heads, c.d_ff, c.lru_width])
            if dtype == "bfloat16":
                res["weights_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in _leaves(llm.engine.params))
            del llm
            gc.collect()
            torch.cuda.empty_cache()
        out[arch] = res
        del host
        gc.collect()
    if world == 2:
        out["vlm"] = tp_vlm_run(torch, g, rank)
        out["encdec"] = tp_encdec_run(torch, g, rank)
    return out


def fam_reference(torch, arch, layers) -> dict:
    """The unsharded engine on the card for ``arch`` cut to ``layers``,
    from the host tree of TP_SEED the ranks cut: the f32 engine's
    streams (its ``LLM`` kept as the near-tie ruler), and the bf16
    greedy engine's, eager (a sharded engine never captures), timed."""
    import dataclasses

    from repro_torch.serve import step_graph
    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    cfg32 = fam_tp_config(arch, layers, "float32")
    dev = _tree_to(seeded_params(cfg32, TP_SEED, "cpu"), "cuda")
    prompts, mixed, greedy = fam_tp_inputs(arch, cfg32.vocab_size)
    ruler = LLM(dev, cfg32, **fam_engine_kwargs(arch))
    want = ruler.generate(prompts, mixed)
    bf = LLM(dev, dataclasses.replace(cfg32, dtype="bfloat16"),
             **fam_engine_kwargs(arch))
    with step_graph.eager_steps():
        bf.generate([prompts[0][:16]], type(greedy)(max_new_tokens=2))
        run = fam_run(torch, bf, prompts, greedy, f"tp 1 {arch} bf16")
    del bf
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ruler=ruler, prompts=prompts, want=want, bf16=run)


def ruler_on(llm, device: str):
    """A near-tie ruler (``top2_gap_at`` reads its engine's params, cfg
    and device alone) with its tree on ``device``."""
    import types

    eng = llm.engine
    return types.SimpleNamespace(engine=types.SimpleNamespace(
        params=_tree_to(eng.params, device), cfg=eng.cfg, device=device))


def check_tp_families(torch, res, world, refs) -> dict:
    """Phase 4k's recurrent-family and vlm runs as the ranks of ``world``
    wrote them: every rank's tokens equal rank 0's; each rank its
    channels (rwkv6 its 64 / world heads of 64, recurrentgemma its 5 of
    10 gate blocks of 256 and 5 q heads over a copy of the KV head); the
    f32 streams the unsharded f32 engine's (near-tie rule), the bf16
    streams measured against the unsharded bf16 engine's, ms a step,
    tok/s and a decode step's collective bytes beside tp 1's; at world 2
    the vlm smoke config's tokens and image-prefix prefill against the
    unsharded engine's on the card.  ``refs`` caches the unsharded runs
    (``fam_reference``) across worlds."""
    import types

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    summary = {}
    fams = [r["families"] for r in res]
    for arch, layers, worlds in FAM_TP:
        if world not in worlds:
            continue
        if arch not in refs:
            refs[arch] = fam_reference(torch, arch, layers)
        ref = refs[arch]
        r0 = fams[0][arch]
        full = fam_tp_config(arch, layers, "float32")
        width = full.lru_width if arch == "recurrentgemma-2b" \
            else full.d_model
        for rank, f in enumerate(fams):
            for name in ("mixed_f32", "greedy_bf16"):
                check(f[arch][name]["tokens"] == r0[name]["tokens"],
                      f"tp {world} {arch} {name}: rank {rank}'s tokens "
                      "differ from rank 0's")
                per = width // world
                check(f[arch][name]["chan"] == [rank * per, (rank + 1) * per],
                      f"tp {world} {arch} rank {rank}: channels "
                      f"{f[arch][name]['chan']}")
                check(f[arch][name]["head_mode"] == "sharded",
                      f"tp {world} {arch}: head mode "
                      f"{f[arch][name]['head_mode']}")
            la = f[arch]["mixed_f32"]["launches"]
            check(la["fused_argmax_head"] > 0 and la["fused_topk_head"] > 0
                  and (la["flash_attention"] > 0) == (arch != "rwkv6-7b"),
                  f"tp {world} {arch} rank {rank}: launches {la}")
        what = f"phase 4k tp {world} {arch} ({layers} layers)"
        got = [types.SimpleNamespace(token_ids=tuple(t), rid=i) for i, t in
               zip(r0["mixed_f32"]["rids"], r0["mixed_f32"]["tokens"])]
        same = compare_streams(torch, ref["ruler"], ref["prompts"],
                               ref["want"], got, what + " f32")
        bgot = [types.SimpleNamespace(token_ids=tuple(t), rid=i) for i, t in
                zip(r0["greedy_bf16"]["rids"], r0["greedy_bf16"]["tokens"])]
        want_bf = [types.SimpleNamespace(token_ids=tuple(t), rid=i)
                   for i, t in zip(ref["bf16"]["rids"],
                                   ref["bf16"]["tokens"])]
        bsame = compare_streams(torch, ref["ruler"], ref["prompts"],
                                want_bf, bgot, what + " bf16 vs tp 1",
                                gate=False)
        gb, one = r0["greedy_bf16"], ref["bf16"]
        print(f"{what}: local heads/kv/d_ff/lru {gb['local']}, weights "
              f"{r0['weights_bytes'] / 1e9:.3f} GB a rank (bf16), host "
              f"draw {r0['draw_s']:.1f} s; f32 {same}/{len(got)} streams "
              f"equal the unsharded engine's, bf16 {bsame}/{len(bgot)}; "
              f"bf16 {gb['tok_s']:.2f} tok/s, {gb['decode_ms']:.3f} ms a "
              f"decode step, {gb['prefill_ms']:.3f} ms a prefill against "
              f"tp 1 eager {one['tok_s']:.2f} tok/s, {one['decode_ms']:.3f} "
              f"ms, {one['prefill_ms']:.3f} ms (gloo through the host on one "
              f"card: no claim); a 4-row decode step's collective bytes "
              f"{gb['step_bytes']}; rank 0 launches f32 "
              f"{r0['mixed_f32']['launches']}, bf16 {gb['launches']}",
              flush=True)
        check(gb["step_bytes"] is not None and gb["step_bytes"].get(
            "trunk", 0) > 0, f"{what}: no 4-row decode step moved trunk "
            "bytes")
        summary[arch] = dict(
            same_f32=same, same_bf16=bsame, streams=len(got),
            launches_f32=r0["mixed_f32"]["launches"],
            launches_bf16=gb["launches"], tok_s=gb["tok_s"],
            decode_ms=gb["decode_ms"], prefill_ms=gb["prefill_ms"],
            tp1_tok_s=one["tok_s"], tp1_decode_ms=one["decode_ms"],
            tp1_prefill_ms=one["prefill_ms"], step_bytes=gb["step_bytes"],
            weights_bytes=r0["weights_bytes"], local=gb["local"])
    if world == 2:
        cfg = smoke_config(get_config("internvl2-26b"))
        ref = LLM(_tree_to(seeded_params(cfg, TP_SEED, "cpu"), "cuda"),
                  cfg, n_slots=4, max_len=64, seed=0, eos_id=-1)
        prompts, toks, img = vlm_tp_inputs(torch, cfg, ref.engine.device)
        want = ref.generate(prompts, fam_samplers()[0])
        pre = vlm_prefix(torch, ref, toks, img)
        v0 = fams[0]["vlm"]
        for rank, f in enumerate(fams):
            v = f["vlm"]
            check(v["tokens"] == v0["tokens"] and v["prefix"]["ids"]
                  == v0["prefix"]["ids"], f"tp 2 vlm: rank {rank}'s outputs "
                  "differ from rank 0's")
            check(v["paged"] and v["local_heads"] == [2, 1],
                  f"tp 2 vlm rank {rank}: paged {v['paged']}, heads "
                  f"{v['local_heads']}")
            check(v["launches"]["paged_attention"] > 0 and v["prefix"][
                "launches"]["flash_attention"] == cfg.n_layers
                and v["prefix"]["launches"]["fused_argmax_head"] == 1,
                f"tp 2 vlm rank {rank}: launches {v['launches']}, prefix "
                f"{v['prefix']['launches']}")
        got = [types.SimpleNamespace(token_ids=tuple(t), rid=i)
               for i, t in zip(v0["rids"], v0["tokens"])]
        same = compare_streams(torch, ref, prompts, want, got,
                               "phase 4k tp 2 vlm smoke (f32)")
        h = torch.tensor(v0["prefix"]["h"])
        href = torch.tensor(pre["h"])
        err = (h - href).abs().max().item()
        check(torch.allclose(h, href, atol=1e-4, rtol=1e-4)
              and v0["prefix"]["ids"] == pre["ids"],
              f"phase 4k tp 2 vlm image prefix: the last hidden state is "
              f"{err} from the unsharded one, ids {v0['prefix']['ids']} "
              f"against {pre['ids']}")
        print(f"phase 4k tp 2 vlm smoke (f32, 2 / 1 heads a rank): "
              f"{same}/{len(got)} streams equal to the unsharded engine's; "
              f"the image prefix through lm.prefill: last hidden state "
              f"max_abs_err {err:.3g} against the unsharded prefill on the "
              f"card (atol 1e-4), ids {v0['prefix']['ids']} equal; launches "
              f"{v0['launches']}, prefix {v0['prefix']['launches']}",
              flush=True)
        summary["vlm"] = dict(same=same, streams=len(got), prefix_err=err,
                              launches=v0["launches"],
                              prefix_launches=v0["prefix"]["launches"])
        del ref
        summary["encdec"] = check_tp_encdec(torch, fams)
    return summary


def check_tp_encdec(torch, fams) -> dict:
    """Phase 4k's seamless run at tp 2 as the ranks wrote it: every rank's
    tokens rank 0's, each rank 8 / 8 heads, 4,096 MLP columns and its V
    / 2 slice; the prefill's flash launches one an attention (the
    encoder's, each decoder layer's self- and cross-attention), no flash
    in a decode step, an argmax head a pass; the tokens the unsharded
    run's on the card on the same host tree (``encdec_decode`` with the
    unsharded argmax head), parting only at a near-tie of the two best
    f32 logits (``encdec_partings``)."""
    from repro_torch.serve import sampler as smp
    from repro_torch.weights import cast_params, seeded_params

    cfg = mesh_config(ED_ARCH, "float32")
    params = cast_params(_tree_to(seeded_params(cfg, TP_SEED, "cpu"),
                                  "cuda"), cfg)
    toks, src = ed_tp_inputs(torch, cfg, "cuda")
    want, hs, _, _ = encdec_decode(torch, params, cfg, toks, src,
                                   smp.Greedy(), ED_TP_NEW)
    e0 = fams[0]["encdec"]
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    half = cfg.vocab_size // 2
    for rank, f in enumerate(fams):
        e = f["encdec"]
        what = f"phase 4k tp 2 seamless rank {rank}"
        check(e["tokens"] == e0["tokens"], f"{what}: tokens differ from "
              "rank 0's")
        check(e["vocab"] == [rank * half, (rank + 1) * half]
              and e["local"] == [8, 8, 4096], f"{what}: vocabulary "
              f"{e['vocab']}, local heads / kv / d_ff {e['local']}")
        check(e["prefill_launches"]["flash_attention"] == n_attn
              and e["step_launches"]["flash_attention"] == 0
              and e["prefill_launches"]["fused_argmax_head"] == 1
              and e["step_launches"]["fused_argmax_head"] == ED_TP_NEW,
              f"{what}: launches prefill {e['prefill_launches']}, steps "
              f"{e['step_launches']}")
        check(e["bytes"].get("trunk", 0) > 0 and e["bytes"].get("head", 0)
              > 0 and "cross" not in e["bytes"], f"{what}: bytes "
              f"{e['bytes']}")
    same, parts = encdec_partings(
        torch, params, cfg, want, torch.tensor(e0["tokens"], device="cuda"),
        hs, "phase 4k tp 2 seamless (f32, 2 + 2 layers) vs unsharded",
        gate=True)
    print(f"phase 4k tp 2 seamless: {same}/{ED_TP_ROWS} rows of "
          f"{ED_TP_NEW + 1} greedy tokens equal to the unsharded run's on "
          f"the card; the head on each rank's V / 2 = {half} ids; launches "
          f"prefill {e0['prefill_launches']}, decode steps "
          f"{e0['step_launches']}; bytes {e0['bytes']}", flush=True)
    del params, hs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(same=same, rows=ED_TP_ROWS, partings=parts,
                prefill_launches=e0["prefill_launches"],
                step_launches=e0["step_launches"], bytes=e0["bytes"])


# ---------------------------------------------------------------------------
# Phase 4k, training on a (data, model) mesh: qwen3-0.6b, phi3.5-moe,
# rwkv6-7b and recurrentgemma-2b at full width, cut in depth, their
# ranks the tp ranks' processes
# ---------------------------------------------------------------------------
# (arch, its layers here, the meshes each world runs): qwen3 (dense) at 4
# of 28 layers; phi3.5-moe at 1 of 32 (one layer is ~1.26 B expert
# parameters: 25 GB of f32 masters, moments and gradients at 1x1), where
# expert parallelism, the data group and the router loss meet; rwkv6-7b
# at 2 of 32 (its heads, the channel-mix's summed kv); recurrentgemma-2b
# at one (rec, rec, attn) unit, 3 of 26 (its gate blocks, its one kv
# head copied to both model ranks); internvl2-26b at 1 of 48 (its
# vocabulary, 92,553 ids, whole on both ranks: the embedding and the
# untied head, 1.137 B values, on each); seamless-m4t-large-v2 at 2 + 2
# of 24 + 24 (the encoder's and the cross-attention's split, the
# encoder's output summed once, V / 2 = 128,103 ids a model rank).  At D
# 2 every mesh runs FSDP
MESH_MODELS = (
    ("qwen3-0.6b", 4, {2: ((1, 2), (2, 1)), 4: ((2, 2),)}),
    ("phi3.5-moe-42b-a6.6b", 1, {2: ((1, 2), (2, 1)), 4: ((2, 2),)}),
    ("rwkv6-7b", 2, {2: ((1, 2),)}),
    ("recurrentgemma-2b", 3, {2: ((1, 2),)}),
    ("internvl2-26b", 1, {2: ((1, 2),)}),
    ("seamless-m4t-large-v2", 2, {2: ((1, 2),), 4: ((2, 2),)}),
)
MESH_CKPT_ARCH = "qwen3-0.6b"   # its 2x2 f32 run writes a whole state
MESH_B, MESH_S = 4, 1024    # the global batch
MESH_STEPS = 2              # cut from 3 to pay for the vlm / encdec meshes
MESH_SEED = 0               # the host tree every rank cuts its slice from
MESH_LR = 1e-3              # phase 4o's (TRAIN_LR)
MESH_CKPT_STEP = 1          # the 2x2 f32 run writes its whole state here
# f32 held to the 1x1 f32 run on the same seed: each step's loss and
# grad_norm within MESH_RTOL of it, the first step's gradients leaf by
# leaf within MESH_GRAD_TOL in norm (||g - g_1x1|| / ||g_1x1||); the
# split sums the same terms in other orders (a K cut of the row-parallel
# GEMMs, gloo's f32 sums, the merged softmax stats), a missing or
# doubled all-reduce is off by a whole part
MESH_RTOL = 1e-4
MESH_GRAD_TOL = 1e-4
# rwkv6-7b's gradients are held to 4e-4: its 1x1 f32 run's ``u``
# gradient is itself ~7e-4 of its norm from an f64 run of the same
# functions (the f32 gradient that reaches the wkv scan's output,
# scripts/rwkv_u_grad_precision.py), and a 1x2 split measured 1.29e-4 on
# ``u``, every other leaf below 7e-5, on an H100
# seamless-m4t-large-v2's gradients are held to 5e-3 and its grad_norms
# to 1e-3: its 1x1 f32 run's first-step gradients are themselves up to
# 1.49e-3 of a leaf's norm (median 5.3e-4) from an f64 run of the same
# function, the gradient at the head's input only 9.1e-6 (qwen3-0.6b:
# every leaf <= 8.7e-6), and the same 1x1 step taken as two
# half-batches' gradients summed moves the next step's grad_norm by
# 1.28e-4 (scripts/mesh_step_sensitivity.py --f64, on an H100); a 1x2 /
# 2x2 split measured leaves up to 1.04e-3 / 1.45e-3 and step-1 norms
# 1.1e-4 / 2.7e-4 off the 1x1 run's; its losses keep MESH_RTOL
MESH_GRAD_TOL_ARCH = {"rwkv6-7b": 4e-4, "seamless-m4t-large-v2": 5e-3}
MESH_NORM_RTOL_ARCH = {"seamless-m4t-large-v2": 1e-3}
MESH_PIPE = (4, 64, 1024)   # pipeline_apply: microbatches, rows, width
# phi3.5-moe 2x2's ranks' summed reserved f32 peak with the data group
# holding whole replicas of the masters and moments (this phase before
# the data cut, on an H100 80GB HBM3 at 700 W), which FSDP's 1/D cut is
# printed beside
MESH_REPLICA_RESERVED_GB = 63.7
MESH_PIPE_TOL = 1e-5        # f32: a (16, W) GEMM against a (64, W) one


def mesh_config(arch: str, dtype: str):
    """``arch`` at full width, its MESH_MODELS layers (an encoder's too),
    remat as configured (``"dots"``: each unit recomputed in the
    backward)."""
    import dataclasses

    from repro_torch.configs import get_config

    layers = next(n for a, n, _ in MESH_MODELS if a == arch)
    full = get_config(arch)
    return dataclasses.replace(
        full, n_layers=layers, dtype=dtype,
        n_encoder_layers=layers if full.n_encoder_layers else 0)


def mesh_runs(world: int) -> list:
    """(arch, D, M) of every mesh a world of ``world`` ranks trains."""
    return [(a, d, m) for a, _, meshes in MESH_MODELS
            for d, m in meshes.get(world, ())]


def mesh_opt():
    from repro_torch.optim import optimizer as opt_mod

    return opt_mod.AdamWConfig(lr=MESH_LR, warmup_steps=10, total_steps=10,
                               clip_norm=1.0)


def mesh_pipe(cfg, device):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    return TokenPipeline(DataConfig(seed=0, vocab_size=cfg.vocab_size), cfg,
                         ShapeSpec("mesh", MESH_S, MESH_B, "train"), device)


def mesh_batches(cfg, device, data=1, d=0) -> list:
    """Data shard ``d`` of ``data``'s rows of MESH_STEPS global batches,
    the stub image or frame embeddings of those rows included: the 1x1
    run's inputs, row for row (``TokenPipeline(data=D)`` draws a shard's
    stub embeddings afresh, as the reference's pipeline does)."""
    pipe, n = mesh_pipe(cfg, device), MESH_B // data
    return [{k: v[d * n:(d + 1) * n] for k, v in pipe.batch(s).items()}
            for s in range(MESH_STEPS)]


def mesh_bytes(mesh) -> dict:
    """The bytes a rank's data, model and kv-copy groups have moved, by
    kind."""
    out = {}
    for grp in (mesh.data, mesh.model, mesh.kv):
        for k, n in (grp.bytes if grp is not None else {}).items():
            out[k] = out.get(k, 0) + n
    return out


def mesh_bytes_want(cfg, D: int, M: int, rows: int) -> dict:
    """A mesh step's collective bytes by kind on a rank of ``rows`` tokens
    (``cfg`` the whole config in its compute dtype, remat on): ``act`` =
    rows x d_model x the dtype's bytes, one activation.  Under a model
    split the embedding's sum and the head input's gradient, one
    ``act`` each where the vocabulary is cut (0 where it is kept whole:
    the lookup and the head are each rank's whole ones), and the
    trunk's: the forward's sums, again in the recompute up to the unit's
    last saved tensor, and each column-parallel input's gradient
    backward --
      dense / moe / enc  5: attention and MLP (or experts) sum forward,
      layer              the attention's in the recompute, two inputs'
                         gradients
      xattn layer        8: the self-attention's, the cross-attention's
                         and the MLP's sums forward, the first two in the
                         recompute, three inputs' gradients
      rwkv layer         12: the time-mix's sum, kv's sum and the
                         product's gather forward, the first two again in
                         the recompute; kv's gradient summed, six
                         projections' inputs (r, k, v, g; the channel
                         mix's k and r), plus the decay LoRA's f32 input
                         (rows x 64 x 4) backward
      (rec, rec, attn)   17 a unit: six sums forward, five in the
                         recompute (not the last MLP's), six inputs'
                         gradients
    (an encoder's rows are its source frames, as many as the tokens
    here), and under an encoder the gradient of its output, which every
    xattn layer's kv heads read, summed once (``cross``, one ``act``);
    for a moe config the router's gradient (L x D x E f32, ``router``),
    for a copied kv head every attention's wk / wv gradients (``kv``),
    each the rank's 1/D rows of it under a data axis (FSDP);
    under a data axis every f32 leaf of the rank's slice (``grad``: a
    data-cut leaf's reduce-scatters count their f32 inputs, the rest
    all-reduces), every data-cut leaf of the rank's slice gathered in
    the compute dtype (``fsdp``: a unit's twice under remat, in the
    forward and the recompute, the embedding and an untied head once),
    and for a moe config each layer's routed counts and token count (E +
    1 f32) in the forward and the recompute (``aux``)."""
    from repro_torch import tree as tree_mod
    from repro_torch import weights
    from repro_torch.models import lm, rwkv6
    from repro_torch.parallel import sharding

    act = rows * cfg.d_model * (2 if cfg.dtype == "bfloat16" else 4)
    kinds = lm.layer_types(cfg)
    want = {}
    if M > 1:
        trunk = 5 * cfg.n_encoder_layers * act
        for unit, count in lm.segments(cfg):
            if unit == ("rwkv",):
                trunk += count * (12 * act + rows * rwkv6.LORA * 4)
            elif unit == ("rec", "rec", "attn"):
                trunk += count * 17 * act
            elif unit == ("xattn",):
                trunk += count * 8 * act
            else:
                trunk += count * 5 * len(unit) * act
        cut = cfg.vocab_size % M == 0
        want.update(trunk=trunk, embed=act * cut, head=act * cut)
        if cfg.n_encoder_layers:
            want["cross"] = act
        # the router and wk / wv cut over data too at D 2 (their D rows)
        if cfg.moe is not None:
            want["router"] = kinds.count("moe") * cfg.d_model \
                * cfg.moe.num_experts * 4 // D
        copies = sharding.kv_copies(cfg, M)
        if copies is not None:
            kv = sharding.train_plan(cfg, 0, 1, M).split.kv
            n_attn = cfg.n_encoder_layers + sum(
                k in lm.KV_KINDS for k in kinds) + kinds.count("xattn")
            want["kv"] = 2 * n_attn * cfg.d_model * (kv[1] - kv[0]) \
                * cfg.head_dim * 4 // D
    if D > 1:
        split = sharding.train_plan(cfg, 0, D, M).split or \
            sharding.plan(cfg, 0, 1)
        want["grad"] = 4 * sharding.rank_param_count(cfg, split)
        per = 2 if cfg.dtype == "bfloat16" else 4
        gathers = 1 if cfg.remat == "none" else 2
        want["fsdp"] = per * sum(
            math.prod(sharding.rank_shape(path, shape, cfg, split))
            * (1 if len(path) == 1 else gathers)
            for path, (shape, _) in tree_mod.items(weights.param_shapes(cfg))
            if sharding.data_axis(path, cfg, D) is not None)
        if cfg.moe is not None:
            want["aux"] = 2 * kinds.count("moe") \
                * (cfg.moe.num_experts + 1) * 4
    return want


def mesh_launches_want(torch, arch, D, M) -> dict:
    """A bf16 mesh step's kernel launches on a rank: flash twice an
    attention (remat: an encoder layer's, a decoder layer's
    self-attention and an xattn layer's cross-attention), and the loss:
    under a cut vocabulary the stats kernel on the rank's (rows, V / M)
    f32 slice once and the softmax kernel in its backward (whose
    two-launch route runs the stats kernel once more); at M 1 or with
    the vocabulary kept whole the cross-entropy kernel and its
    backward's softmax kernel."""
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.models import lm

    cfg = mesh_config(arch, "bfloat16")
    cut = M > 1 and cfg.vocab_size % M == 0
    rows, v = MESH_B // D * MESH_S, cfg.vocab_size // (M if cut else 1)
    two = osm.unit_plan(torch.float32, rows, v, osm.device_resident_blocks(
        0, torch.float32)).route == osm.TWO_LAUNCH
    kinds = lm.layer_types(cfg)
    attn = cfg.n_encoder_layers + sum(k in lm.KV_KINDS for k in kinds) \
        + kinds.count("xattn")
    return {"flash_attention": 2 * attn,
            "softmax_stats": int(cut) + int(two),
            "online_softmax": 1, "fused_xent": int(not cut),
            "paged_attention": 0, "fused_argmax_head": 0,
            "fused_topk_head": 0, "fused_verify_head": 0}


# phase 4k (mesh): flash attention at each mesh model's rank heads, B 4,
# T 1,024 (T = S: seamless's cross-attention reads as many source frames
# as the decoder has tokens), bf16 -- (row key, q heads, kv heads, head
# dim, window, causal, label) -- and the vocabulary slices a 1x2 rank's
# loss reads (4,096 f32 rows): qwen3 V / 2, phi3.5-moe, rwkv6-7b,
# recurrentgemma-2b, seamless-m4t-large-v2; the cross-entropy kernel on
# (rows, V): a 2x1 rank's qwen3 and phi3.5-moe, internvl2-26b's whole
# 92,553 ids on each rank at 1x2
MESH_FLASH = (
    ("flash_t1024_b4_h8", 8, 4, 128, None, True, "qwen3-0.6b, row 5j"),
    ("flash_t1024_b4_h16_phi", 16, 4, 128, None, True,
     "phi3.5-moe, row 5k"),
    ("flash_t1024_b4_h5_hd256_rg", 5, 1, 256, 2048, True,
     "recurrentgemma-2b (a copied kv head, window 2,048), row 5l"),
    ("flash_t1024_b4_h8_hd64_noncausal", 8, 8, 64, None, False,
     "seamless-m4t-large-v2's encoder and cross-attention, row 5m"),
    ("flash_t1024_b4_h8_hd64", 8, 8, 64, None, True,
     "seamless-m4t-large-v2's decoder, row 5n"),
    ("flash_t1024_b4_h24_vlm", 24, 4, 128, None, True,
     "internvl2-26b, row 5o"),
)
MESH_SLICES = {"slice_f32": 75968, "v16032": 16032, "v32768": 32768,
               "v128000": 128000, "v128103": 128103}
MESH_XENT = {"fused_xent_rows2048_f32": (2048, 151936),
             "fused_xent_rows2048_v32064_f32": (2048, 32064),
             "fused_xent_rows4096_v92553_f32": (4096, 92553)}


def check_mesh_kernels(torch, timer) -> dict:
    """Phase 4k (mesh): the mesh steps' kernels alone at their shapes, each
    against its plain version and timed beside its bound and one library
    call: flash attention at each model's rank heads (MESH_FLASH: B 4, T
    1,024, bf16, causal or not; rows 5j-5o; SDPA with the same mask --
    T is inside recurrentgemma's window), the stats and softmax kernels
    on a 1x2 rank's 4,096-row f32 vocabulary slices (MESH_SLICES:
    qwen3's 75,968, phi3.5-moe's 16,032, rwkv6-7b's 32,768,
    recurrentgemma-2b's 128,000, seamless's 128,103; rows 7c-7g / 8b-8f;
    ``torch.logsumexp``, ``torch.softmax``), the cross-entropy kernel on
    a 2x1 rank's 2,048 f32 rows of qwen3's and phi3.5-moe's whole
    vocabularies and on internvl2-26b's 4,096 rows of its whole 92,553
    ids (MESH_XENT; rows 6c-6e; ``F.cross_entropy``); then the
    vocabulary-parallel loss's forward composed by hand from two slices'
    stats (``api.merge_stats``) against the whole row's logsumexp,
    bitwise on repeat."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ref
    from repro_torch.models import api

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(41)
    b, t = MESH_B, MESH_S
    for key, hq, hkv, hd, window, causal, label in MESH_FLASH:
        def rand(heads):
            return torch.randn((b, t, heads, hd), generator=gen,
                               device="cuda").to(torch.bfloat16).transpose(
                                   1, 2)

        q, k, v = rand(hq), rand(hkv), rand(hkv)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        err = (out.float() - want.float()).abs().max().item()
        ok = torch.allclose(out.float(), want.float(), atol=FA_TOL,
                            rtol=FA_TOL)
        mask = "causal" if causal else "non-causal"
        print(f"phase 4k (mesh) flash_attention B {b} T {t} {hq} q / {hkv} "
              f"kv heads of {hd} bf16 {mask} (window {window}): "
              f"max_abs_err {err:.6g} vs plain (atol = rtol = {FA_TOL}): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash attention at {label}'s rank heads disagrees "
              "with its plain version")
        pairs = b * t * (t + 1) // 2 if causal else b * t * t
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        rows[key] = kernel_row(
            timer, lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window),
            lambda: ref.flash_attention(q, k, v, causal=causal,
                                        window=window),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                   enable_gqa=True),
            nbytes, 4 * hd * hq * pairs, err)
        model_line(f"phase 4k (mesh) {label}, a model rank's heads",
                   "flash_attention", rows[key], "sdpa")
        del q, k, v, out, want

    full_v = 151936
    x = torch.randn((MESH_B * MESH_S, full_v), generator=gen,
                    device="cuda") * 4
    for tag, width in MESH_SLICES.items():
        xs = x[:, :width].contiguous()          # a 1x2 rank's slice
        n, el = xs.numel(), xs.element_size()
        m, l = osm.softmax_stats(xs)
        rm, rl = ref.softmax_stats(xs)
        p, rp = osm.online_softmax(xs), ref.online_softmax(xs)
        errs = {"softmax_stats": max((m - rm).abs().max().item(),
                                     (l - rl).abs().max().item()),
                "online_softmax": (p - rp).abs().max().item()}
        ok = (torch.allclose(m, rm, rtol=UNIT_RTOL, atol=UNIT_ATOL)
              and torch.allclose(l, rl, rtol=UNIT_RTOL, atol=UNIT_ATOL)
              and torch.allclose(p, rp, rtol=UNIT_RTOL, atol=UNIT_ATOL))
        print(f"phase 4k (mesh) stats / softmax on a ({xs.shape[0]}, "
              f"{width}) f32 slice: max_abs_err "
              f"{errs['softmax_stats']:.6g} / {errs['online_softmax']:.6g} "
              f"(rtol {UNIT_RTOL}, atol {UNIT_ATOL}): "
              f"{'ok' if ok else 'FAIL'}; online_softmax route "
              f"{osm.plan_of(xs).route}", flush=True)
        check(ok, f"the stats or softmax kernel on a {width}-id vocabulary "
              "slice disagrees with its plain version")
        del p, rp, m, l, rm, rl
        for name, kern, plain_fn, lib_fn, nb, fl in (
                ("softmax_stats", lambda: osm.softmax_stats(xs),
                 lambda: ref.softmax_stats(xs),
                 lambda: torch.logsumexp(xs, dim=-1),
                 n * el + 8 * xs.shape[0], 4 * n),
                ("online_softmax", lambda: osm.online_softmax(xs),
                 lambda: ref.online_softmax(xs),
                 lambda: torch.softmax(xs, dim=-1), n * el + 4 * n, 6 * n)):
            kern_t, plain_ms = timer.readings(kern), timer(plain_fn)
            lib_t = timer.readings(lib_fn, "library_")
            bound_ms, bound_by = bound(nb, fl, F32_FLOPS_PER_S)
            rows[f"{name}_{tag}"] = dict(
                max_abs_err=errs[name], **kern_t, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, **lib_t)
            print(f"phase 4k (mesh) {name} ({xs.shape[0]}, {width}) f32: "
                  f"kernel {shown(kern_t)}, plain {plain_ms:.4f} ms, "
                  f"library {shown(lib_t, 'library_')}, bound "
                  f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        del xs

    # the vocabulary-parallel forward by hand: two slices' kernel stats,
    # merged, against the whole row's logsumexp; twice, bitwise
    halves = [x[:, :full_v // 2].contiguous(), x[:, full_v // 2:].contiguous()]
    lse = [api.merge_stats(torch.stack([torch.stack(osm.softmax_stats(h), 1)
                                        for h in halves])) for _ in range(2)]
    want = torch.logsumexp(x.double(), dim=-1).float()
    lse_err = (lse[0] - want).abs().max().item()
    same = torch.equal(lse[0], lse[1])
    print(f"phase 4k (mesh) merged stats of two slices vs the whole row's "
          f"logsumexp: max_abs_err {lse_err:.6g} (limit 1e-5 of ~12); "
          f"bitwise on repeat: {same}", flush=True)
    check(lse_err <= 1e-5 and same, "the merged slice stats disagree with "
          "the row's logsumexp, or differ on repeat")
    rows["merge_lse_err"] = lse_err
    del halves, lse, want

    # the cross-entropy kernel at a 2x1 rank's rows (M 1), and at a 1x2
    # rank's rows of a vocabulary kept whole
    for key, (n_rows, width) in MESH_XENT.items():
        xr = x[:n_rows, :width].contiguous()
        lab = torch.randint(0, width, (xr.shape[0],), generator=gen,
                            device="cuda")
        loss, rloss = fx.fused_xent(xr, lab), ref.fused_xent(xr, lab)
        xerr = (loss - rloss).abs().max().item()
        ok = torch.allclose(loss, rloss, rtol=UNIT_RTOL, atol=XENT_ATOL)
        check(ok, f"the cross-entropy kernel at {n_rows} rows of {width} "
              "ids disagrees with its plain version")
        n = xr.numel()
        kern_t, plain_ms = timer.readings(lambda: fx.fused_xent(xr, lab)), \
            timer(lambda: ref.fused_xent(xr, lab))
        lib_t = timer.readings(lambda: F.cross_entropy(xr, lab,
                                                       reduction="none"),
                               "library_")
        bound_ms, bound_by = bound(n * 4 + 12 * xr.shape[0], 4 * n,
                                   F32_FLOPS_PER_S)
        rows[key] = dict(
            max_abs_err=xerr, **kern_t, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, **lib_t)
        print(f"phase 4k (mesh) fused_xent ({xr.shape[0]}, {width}) f32: "
              f"kernel {shown(kern_t)}, plain {plain_ms:.4f} ms, library "
              f"{shown(lib_t, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by}); max_abs_err {xerr:.6g}", flush=True)
        del xr, lab, loss, rloss
    del x
    torch.cuda.empty_cache()
    return rows


def first_call(fn):
    """``fn`` on its first call alone (a step's ``on_grads``, which sees
    every step's gradients, kept to the first step's)."""
    done = []

    def call(*a):
        if not done:
            done.append(True)
            fn(*a)
    return call


def mesh_reference(torch, d, arch, device="cuda") -> dict:
    """Phase 4k (mesh), in the parent beside the first world's ranks:
    ``arch``'s 1x1 f32 run on the card on the same seed -- the first
    step's gradients, each leaf saved under ``<d>/mesh_ref/<arch>/`` (then
    a ``done`` marker) for the ranks to hold their slices to, a moe
    config's kept choices in that step's forward
    (``layers.count_kept``), MESH_STEPS AdamW steps' losses and
    grad_norms."""
    from repro_torch import tree as tree_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import layers, lm
    from repro_torch.optim import optimizer as opt_mod
    from repro_torch.weights import seeded_params

    t0 = time.perf_counter()
    cfg = mesh_config(arch, "float32")
    params = seeded_params(cfg, MESH_SEED, device)
    pipe = mesh_pipe(cfg, device)
    torch.cuda.reset_peak_memory_stats()
    ref_dir = os.path.join(d, "mesh_ref", arch)
    os.makedirs(ref_dir)

    def save(grads):
        for path, g in tree_mod.items(grads):
            np.save(os.path.join(ref_dir, tree_mod.key(path).replace(
                "/", ".") + ".npy"), g.cpu().numpy())
        open(os.path.join(ref_dir, "done"), "w").close()

    opt = mesh_opt()
    state = {"params": params, "opt": opt_mod.init_state(opt, params)}
    step = steps_mod.make_train_step(cfg, opt, on_grads=first_call(save))
    losses, norms = [], []
    with layers.count_kept() as calls:
        state, m = step(state, pipe.batch(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    n_moe = lm.layer_types(cfg).count("moe")
    kept = int(sum(c.item() for c in calls[:n_moe]))
    for s in range(1, MESH_STEPS):
        state, m = step(state, pipe.batch(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4k (mesh) 1x1 f32 reference, {arch} full width "
          f"{cfg.n_layers} layers, B {MESH_B} x S {MESH_S}: losses "
          + ", ".join(f"{x:.6f}" for x in losses) + "; grad_norm "
          + ", ".join(f"{x:.6f}" for x in norms)
          + (f"; kept choices {kept}" if n_moe else "")
          + f"; peak {peak / 1e9:.3f} GB; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"losses": losses, "norms": norms, "kept": kept,
            "peak_gb": peak / 1e9}


def wait_for_reference(ref_dir: str, marker: str = "done") -> None:
    """Block until the parent marked ``ref_dir`` done (its 1x1 reference
    runs beside the ranks; ``marker`` "all_done" under ``mesh_ref``: every
    reference has finished and left the card), at most
    TP_RANK_TIMEOUT_S."""
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(ref_dir, marker)):
        check(time.perf_counter() - t0 < TP_RANK_TIMEOUT_S,
              f"no 1x1 reference under {ref_dir} after "
              f"{TP_RANK_TIMEOUT_S} s")
        time.sleep(0.5)


def mesh_grad_errs(torch, grads, mesh, ref_dir) -> dict:
    """The rank's share of the first step's gradient check: for each leaf
    it counts -- its cut of a data-cut leaf (FSDP: every data index holds
    its 1/D), a data-replicated leaf on data index 0 only; of those its
    slice of a split leaf (a copied kv head on the copy's first rank), a
    replicated leaf on model index 0 -- ``[||g - ref||^2, ||ref||^2]``
    against the same cut of the 1x1 run's leaf (read through a memory
    map), so the parent's sums over the ranks are the whole leaf's."""
    from repro_torch import tree as tree_mod
    from repro_torch.parallel import sharding

    out = {}
    wait_for_reference(ref_dir)
    for path, g in tree_mod.items(grads):
        if mesh.data_axis(path) is None and mesh.plan.d != 0:
            continue
        split = mesh.split_leaf(path)
        if mesh.duplicate_leaf(path) or (not split and mesh.plan.m != 0):
            continue
        key = tree_mod.key(path)
        ref = np.load(os.path.join(ref_dir, key.replace("/", ".")
                                   + ".npy"), mmap_mode="r")
        ref = sharding.shard_leaf(path, ref, mesh.full, mesh.split,
                                  mesh.dcut)
        want = torch.from_numpy(np.array(ref)).to(g.device)
        check(tuple(want.shape) == tuple(g.shape),
              f"mesh: {key} {tuple(g.shape)} against the 1x1 run's slice "
              f"{tuple(want.shape)}")
        out[key] = [(g - want).norm().item() ** 2, want.norm().item() ** 2]
        del want
    return out


def tp_train_runs(torch, g, rank, world, d) -> dict:
    """Phase 4k (mesh), in a rank process: each mesh of
    ``mesh_runs(world)`` over the rank's group
    (``launch.steps.make_mesh``), the host tree of its arch drawn from
    MESH_SEED whole and cut to the rank's slice.  f32: the first step's
    gradients held slice by slice to the 1x1 run's (``mesh_grad_errs``)
    and a moe config's kept choices in that forward, then MESH_STEPS
    AdamW steps (at 2x2 MESH_CKPT_ARCH's whole state checkpointed after
    MESH_CKPT_STEP of them, by rank 0), the rank's peak.  bf16 (timed):
    MESH_STEPS steps, each one's ms, collective bytes by kind and kernel
    launches (the counts set to 0 just before the run), the rank's peak
    memory.  At world 4 then ``pipeline_apply`` over the 4 ranks against
    the stages in sequence."""
    import dataclasses

    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import layers, lm
    from repro_torch.optim import optimizer as opt_mod
    from repro_torch.parallel import sharding
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.weights import seeded_params

    t0 = time.perf_counter()
    opt = mesh_opt()
    out = {}

    def own(tree):
        # the rank's own copy on its device (a slice may be a view of the
        # host tree, which the in-place update must never reach)
        return tree_mod.map_tree(lambda _, t: t.to(g.device, copy=True),
                                 tree)

    if world == TP_WORLDS[0]:
        # the parent's 1x1 references share the card (internvl2-26b's
        # ~30 GB): no mesh run starts before the last has left it
        wait_for_reference(os.path.join(d, "mesh_ref"), "all_done")
    host_arch, host = None, None
    for arch, D, M in mesh_runs(world):
        tag = f"{D}x{M}"
        t1 = time.perf_counter()
        f32, bf = mesh_config(arch, "float32"), mesh_config(arch, "bfloat16")
        if arch != host_arch:
            host = None
            gc.collect()
            host_arch, host = arch, seeded_params(f32, MESH_SEED, "cpu")
        mesh = steps_mod.make_mesh(f32, g, D, M)
        batches = mesh_batches(f32, g.device, D, mesh.plan.d)
        res = {"d": mesh.plan.d, "m": mesh.plan.m,
               "data_ranks": list(mesh.data.ranks) if mesh.data else None,
               "model_ranks": list(mesh.model.ranks) if mesh.model
               else None,
               "kv_ranks": list(mesh.kv.ranks) if mesh.kv else None}
        p = own(mesh.shard(host))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_f32 = time.perf_counter()
        res["setup_s"] = t_f32 - t1
        state = {"params": p, "opt": opt_mod.init_state(opt, p)}
        res["state_bytes"] = [sum(t.numel() * t.element_size()
                                  for t in tree_mod.leaves(x))
                              for x in (state["params"], state["opt"])]

        def held(grads, mesh=mesh, arch=arch, res=res):
            # the first step's gradients, as the step completed them
            res["grad_errs"] = mesh_grad_errs(
                torch, grads, mesh, os.path.join(d, "mesh_ref", arch))
        step = steps_mod.make_train_step(mesh.cfg, opt, mesh,
                                         on_grads=first_call(held))
        losses, norms = [], []
        for s in range(MESH_STEPS):
            if arch == MESH_CKPT_ARCH and tag == "2x2" \
                    and s == MESH_CKPT_STEP:
                t2 = time.perf_counter()
                train_mod.save_state(CheckpointManager(
                    os.path.join(d, "mesh_ckpt")), s, state, mesh)
                g.agree(s, "the mesh checkpoint written")
                res["ckpt_s"] = time.perf_counter() - t2
            if s == 0:
                with layers.count_kept() as calls:
                    state, m = step(state, batches[0])
                n_moe = lm.layer_types(f32).count("moe")
                res["kept"] = int(sum(c.item() for c in calls[:n_moe]))
            else:
                state, m = step(state, batches[s])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        res.update(f32_losses=losses, f32_norms=norms,
                   f32_peak_bytes=torch.cuda.max_memory_allocated(),
                   f32_reserved_bytes=torch.cuda.max_memory_reserved(),
                   f32_s=time.perf_counter() - t_f32)
        del state, p, step
        gc.collect()
        torch.cuda.empty_cache()
        # bf16, timed: the same groups, the rank's bf16 view
        bmesh = dataclasses.replace(
            mesh, full=bf, cfg=bf if mesh.split is None
            else sharding.local_config(bf, mesh.split))
        p = own(mesh.shard(host))
        state = {"params": p, "opt": opt_mod.init_state(opt, p)}
        step = steps_mod.make_train_step(bmesh.cfg, opt, bmesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = {"losses": [], "norms": [], "ms": [], "bytes": [],
               "launches": []}
        reset_launches()
        for s in range(MESH_STEPS):
            b0, l0 = mesh_bytes(bmesh), read_launches()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            state, m = step(state, batches[s])
            loss = float(m["loss"])
            torch.cuda.synchronize()
            run["ms"].append(1e3 * (time.perf_counter() - t2))
            run["losses"].append(loss)
            run["norms"].append(float(m["grad_norm"]))
            after = mesh_bytes(bmesh)
            run["bytes"].append({k: n - b0.get(k, 0) for k, n in
                                 after.items() if n - b0.get(k, 0)})
            la = read_launches()
            run["launches"].append({k: la[k] - l0[k] for k in la})
        run["total_launches"] = read_launches()
        run["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["bf16"] = run
        res["seconds"] = time.perf_counter() - t1
        del state, p, step
        gc.collect()
        torch.cuda.empty_cache()
        out[f"{arch} {tag}"] = res
    del host
    if world == 4:
        micro, n_rows, w = MESH_PIPE
        gen = torch.Generator().manual_seed(23)
        ws = (torch.randn((world, w, w), generator=gen) / w ** 0.5).to(
            g.device)
        bs = (torch.randn((world, w), generator=gen) * 0.1).to(g.device)
        x = torch.randn((n_rows, w), generator=gen).to(g.device)
        y = pipeline_apply(lambda sp, h: torch.tanh(h @ sp[0] + sp[1]),
                           (ws[rank], bs[rank]), x, g, n_microbatches=micro)
        h = x
        for s in range(world):
            h = torch.tanh(h @ ws[s] + bs[s])
        out["pipeline_err"] = (y - h).abs().max().item()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_mesh_train(torch, res, world, refs, d, device="cuda") -> dict:
    """Phase 4k (mesh) as the ranks wrote it: each mesh's f32 losses and
    grad_norms within MESH_RTOL of its arch's 1x1 run's, its first-step
    gradients leaf by leaf within MESH_GRAD_TOL (the ranks' slices'
    sums), a moe config's kept choices the 1x1 run's, every rank's
    losses the same; the bf16 run's bytes by kind exactly as
    ``mesh_bytes_want`` predicts, its launches a step as
    ``mesh_launches_want`` says on every rank, its ms a step and each
    rank's peak printed; at 2x2 MESH_CKPT_ARCH's checkpoint restored
    into a 1x1 run here, whose next step's loss is the uninterrupted 2x2
    run's; at world 4 ``pipeline_apply`` within MESH_PIPE_TOL of the
    stages in sequence.  Each rank's f32 train state (masters, AdamW's
    moments) is the dry-run's ``memory`` for its cell, byte for byte, and
    rank 0's bf16 bytes a step by kind are the dry-run walk's
    (``segment_cost.train_step_walk`` of its step on ``meta``)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import segment_cost
    from repro_torch.launch import steps as steps_mod

    summary = {}
    shape = ShapeSpec("mesh", MESH_S, MESH_B, "train")
    for arch, D, M in mesh_runs(world):
        tag = f"{D}x{M}"
        key = f"{arch} {tag}"
        ref = refs[arch]
        f32, bf = mesh_config(arch, "float32"), mesh_config(arch,
                                                             "bfloat16")
        runs = [r["mesh_train"][key] for r in res]
        r0 = runs[0]
        what = f"phase 4k (mesh) {arch} {tag}"
        for r in runs[1:]:
            check(r["f32_losses"] == r0["f32_losses"]
                  and r["f32_norms"] == r0["f32_norms"],
                  f"{what}: rank losses or norms differ from rank 0's")
        for i, (a, b) in enumerate(zip(r0["f32_losses"], ref["losses"])):
            check(abs(a - b) <= MESH_RTOL * abs(b), f"{what} f32 step {i}: "
                  f"loss {a!r} vs the 1x1 run's {b!r}")
        norm_tol = MESH_NORM_RTOL_ARCH.get(arch, MESH_RTOL)
        for i, (a, b) in enumerate(zip(r0["f32_norms"], ref["norms"])):
            check(abs(a - b) <= norm_tol * abs(b), f"{what} f32 step {i}: "
                  f"grad_norm {a!r} vs the 1x1 run's {b!r} (limit "
                  f"{norm_tol:.3g})")
        sums = {}
        for r in runs:
            for k, (dd, rr) in r["grad_errs"].items():
                s = sums.setdefault(k, [0.0, 0.0])
                s[0] += dd
                s[1] += rr
        n_leaves = len(list(_leaves(steps_mod.train_state_struct(
            f32, mesh_opt())["params"])))
        check(len(sums) == n_leaves, f"{what}: {len(sums)} gradient leaves "
              f"checked of {n_leaves}")
        errs = {k: math.sqrt(dd) / max(math.sqrt(rr), 1e-30)
                for k, (dd, rr) in sums.items()}
        worst_key = max(errs, key=errs.get)
        worst = errs[worst_key]
        lim = MESH_GRAD_TOL_ARCH.get(arch, MESH_GRAD_TOL)
        for k, e in errs.items():
            check(e <= lim, f"{what}: gradient {k} off the 1x1 run's by "
                  f"{e:.3g} of its norm (limit {lim:.3g})")
        kept = sum(r["kept"] for r in runs if r["m"] == 0)
        check(kept == ref["kept"], f"{what}: {kept} kept choices, the 1x1 "
              f"run {ref['kept']}")
        gaps = [max(abs(a - b) / b for a, b in zip(r0[k], ref[r]))
                for k, r in (("f32_losses", "losses"), ("f32_norms",
                                                        "norms"))]
        print(f"{what} f32: losses " + ", ".join(
            f"{x:.6f}" for x in r0["f32_losses"]) + " (1x1 " + ", ".join(
            f"{x:.6f}" for x in ref["losses"]) + f"); largest relative "
            f"loss gap {gaps[0]:.3g}, grad_norm gap {gaps[1]:.3g}; "
            f"first-step gradients: worst leaf {worst_key} at {worst:.3g} "
            f"of its norm ({len(errs)} leaves, limit {lim:.3g})"
            + (f"; kept choices {kept} (1x1 {ref['kept']})"
               if f32.moe is not None else "")
            + "; f32 peak per rank " + ", ".join(
                f"{r['f32_peak_bytes'] / 1e9:.3f}" for r in runs) + " GB ("
            f"reserved {sum(r['f32_reserved_bytes'] for r in runs) / 1e9:.3f}"
            " GB over the ranks)", flush=True)
        # bf16: bytes a step by kind, exactly
        want = mesh_bytes_want(bf, D, M, MESH_B // D * MESH_S)
        lw = mesh_launches_want(torch, arch, D, M)
        for r in runs:
            got = r["bf16"]["bytes"][-1]
            for k, n in want.items():
                check(got.get(k, 0) == n, f"{what} bf16: {k} bytes a step "
                      f"{got.get(k)} on rank {r['d'] * M + r['m']}, "
                      f"predicted {n}")
            for s, la in enumerate(r["bf16"]["launches"]):
                for k, n in lw.items():
                    check(la[k] == n, f"{what} bf16 step {s}: {k} launched "
                          f"{la[k]} times, want {n}")
            check(all(math.isfinite(x) for x in r["bf16"]["losses"]),
                  f"{what} bf16: a loss is not finite")
        # the dry-run's state bytes a rank and rank 0's walked bytes
        for r in runs:
            rank = r["d"] * M + r["m"]
            mem = segment_cost.train_cell(f32, mesh_opt(), shape, D, M,
                                          rank, walk=False)["memory"]
            check(r["state_bytes"] == [mem["params"], mem["optimizer"]],
                  f"{what}: rank {rank}'s state {r['state_bytes']} B, the "
                  f"dry-run's {[mem['params'], mem['optimizer']]}")
        walked = segment_cost.train_step_walk(bf, mesh_opt(), shape, D, M,
                                              0)[0].coll_breakdown
        got = {k: n for k, n in r0["bf16"]["bytes"][-1].items()
               if k != "digest"}
        check(got == walked, f"{what} bf16: rank 0's bytes a step {got}, "
              f"the dry-run's walk {walked}")
        print(f"{what}: state bytes a rank (masters, AdamW) " + ", ".join(
            f"{r['state_bytes'][0]:,} + {r['state_bytes'][1]:,}"
            for r in runs) + " = the dry-run's; rank 0's bf16 bytes a step "
            "= the dry-run walk's", flush=True)
        if arch == "phi3.5-moe-42b-a6.6b" and tag == "2x2":
            reserved = sum(r["f32_reserved_bytes"] for r in runs) / 1e9
            print(f"{what} FSDP: the ranks' summed reserved f32 peak "
                  f"{reserved:.3f} GB against {MESH_REPLICA_RESERVED_GB} GB "
                  "with the data group's replicas", flush=True)
        b0 = r0["bf16"]
        step_ms = sum(b0["ms"][1:]) / (MESH_STEPS - 1)
        peaks = [r["bf16"]["peak_bytes"] / 1e9 for r in runs]
        print(f"{what} bf16: {step_ms:.1f} ms a step (mean of steps 1-"
              f"{MESH_STEPS - 1}; " + ", ".join(f"{x:.1f}" for x in b0["ms"])
              + f"), {MESH_B * MESH_S / (step_ms / 1e3):.1f} tokens/s over "
              f"{world} ranks on one card (gloo through the host); losses "
              + ", ".join(f"{x:.4f}" for x in b0["losses"])
              + f"; bytes a step {b0['bytes'][-1]} (predicted {want}); "
              f"launches a step {b0['launches'][-1]}; peak per rank "
              + ", ".join(f"{x:.3f}" for x in peaks) + " GB; "
              f"{r0['seconds']:.1f} s for the mesh on rank 0 (set-up "
              f"{r0['setup_s']:.1f}, f32 {r0['f32_s']:.1f}, the rest bf16)",
              flush=True)
        summary[key] = dict(
            f32_losses=r0["f32_losses"], f32_norms=r0["f32_norms"],
            grad_worst=[worst_key, worst], kept=kept, bf16_ms=b0["ms"],
            bf16_step_ms=step_ms, bf16_losses=b0["losses"],
            bytes=b0["bytes"][-1], launches=b0["launches"][-1],
            total_launches=b0["total_launches"], peak_gb=peaks,
            f32_peak_gb=[r["f32_peak_bytes"] / 1e9 for r in runs],
            f32_reserved_gb=sum(r["f32_reserved_bytes"] for r in runs) / 1e9,
            seconds=r0["seconds"])
        if arch == MESH_CKPT_ARCH and tag == "2x2":
            t0 = time.perf_counter()
            opt = mesh_opt()
            state = CheckpointManager(os.path.join(d, "mesh_ckpt")).restore(
                MESH_CKPT_STEP, steps_mod.train_state_struct(f32, opt),
                device=device)
            step = steps_mod.make_train_step(f32, opt)
            state, m = step(state, mesh_pipe(f32, device).batch(
                MESH_CKPT_STEP))
            resumed = float(m["loss"])
            want_loss = r0["f32_losses"][MESH_CKPT_STEP]
            print(f"{what}: its step-{MESH_CKPT_STEP} checkpoint (written "
                  f"in {r0['ckpt_s']:.1f} s) resumed at 1x1: next loss "
                  f"{resumed:.6f} vs the uninterrupted 2x2 step's "
                  f"{want_loss:.6f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            check(abs(resumed - want_loss) <= MESH_RTOL * abs(want_loss),
                  f"{what}: the checkpoint resumed at 1x1 gives loss "
                  f"{resumed!r}, the 2x2 run {want_loss!r}")
            summary[key]["resumed_loss"] = resumed
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
    if world == 4:
        errs = [r["mesh_train"]["pipeline_err"] for r in res]
        print(f"phase 4k (mesh) pipeline_apply over 4 ranks, "
              f"{MESH_PIPE[0]} microbatches of {MESH_PIPE[1] // MESH_PIPE[0]}"
              f" x {MESH_PIPE[2]}: max_abs_err vs the stages in sequence "
              + ", ".join(f"{e:.3g}" for e in errs), flush=True)
        check(max(errs) <= MESH_PIPE_TOL, "pipeline_apply disagrees with "
              "its stages in sequence")
        summary["pipeline_err"] = max(errs)
    summary["rank_seconds"] = res[0]["mesh_train"]["seconds"]
    return summary


def run_tp_path(torch, max_new=TP_MAX_NEW) -> dict:
    """Phase 4k: qwen3-0.6b at full width served by tp 2 and tp 4 ranks
    (``spawn_tp``) that share the one card over gloo.  The unsharded
    engine runs here on the same host weights -- its greedy f32 run
    through ``LLM.from_arch(dtype="float32")`` on the card, whose tree
    must be the host draw leaf for leaf, against the ranks' own
    ``LLM.from_arch(tp=W, dtype="float32")`` on TP_ENTRY_PROMPTS prompts;
    then the runs at TP_LAYERS of the 28 layers: every f32 run's streams
    (greedy, mixed samplers, spec_k 4 with drafts accepted, host_stride
    8, chunk 64 with prefix sharing on) must be its own, parting only at
    a near-tie of the two best f32 logits; the bf16 greedy streams are
    measured against the unsharded bf16 engine's; every rank's tokens
    equal rank 0's.  Prints tok/s and ms a decode step at tp 1, 2 and 4
    (gloo through the host on one card: no claim rides on them) and the
    collective bytes of a decode step.  The same rank processes then
    serve the recurrent and vlm families (``tp_family_runs``, checked by
    ``check_tp_families``): rwkv6-7b at tp 2 and 4, recurrentgemma-2b at
    tp 2, internvl2-26b's smoke config and its image prefix at tp 2."""
    import dataclasses
    import shutil
    import types

    from repro_torch.configs import get_config
    from repro_torch.serve import step_graph
    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    t0 = time.perf_counter()
    full = get_config("qwen3-0.6b")
    cfg = dataclasses.replace(full, n_layers=TP_LAYERS)
    inputs = {n: tp_inputs(cfg.vocab_size, max_new, n)
              for n in set(TP_PROMPTS.values())}
    prompts, params = inputs[max(TP_PROMPTS.values())]
    f32 = dataclasses.replace(cfg, dtype="float32")
    dev32 = _tree_to(seeded_params(cfg, TP_SEED, "cpu"), "cuda")
    # the unsharded entry point on the card: its tree is the host tree
    # every rank cuts its slice from (one seed, one tree)
    plain = LLM.from_arch("qwen3-0.6b", smoke=False, dtype="float32",
                          **dict(tp_engine_kwargs(), seed=TP_SEED))
    same_tree = all(torch.equal(a.cpu(), b) for a, b in zip(
        _leaves(plain.engine.params),
        _leaves(seeded_params(full, TP_SEED, "cpu"))))
    print(f"phase 4k: LLM.from_arch(seed={TP_SEED}, dtype='float32') on "
          f"the card holds the host tree the ranks cut: {same_tree}",
          flush=True)
    check(same_tree, "phase 4k: from_arch on the card drew another tree "
          "than the host draw of the same seed")
    entry = prompts["main"][:TP_ENTRY_PROMPTS]
    ref_entry = plain.generate(entry, type(params["greedy"])(
        max_new_tokens=TP_ENTRY_NEW))
    ref32 = {}                    # (prompt count, run) -> outputs
    gap_llm = LLM(dev32, f32, **tp_engine_kwargs())   # the near-tie ruler
    for n, (ps, pp) in inputs.items():
        for name, dtype, kw, pk, prk in tp_runs(max_new):
            if dtype == "float32":
                llm = gap_llm if name == "greedy_f32" else LLM(
                    dev32, f32, **tp_engine_kwargs(**kw))
                ref32[n, name] = llm.generate(ps[prk], pp[pk])
                del llm
    bf = LLM(dev32, cfg, **tp_engine_kwargs())
    bf.generate([prompts["main"][0][:16]], params["greedy"])
    timing = {}
    for label, ctx in (("tp1_graphed", None), ("tp1_eager", True)):
        st0 = stats_now(bf)
        t1 = time.perf_counter()
        if ctx:
            with step_graph.eager_steps():
                outs = bf.generate(prompts["main"], params["greedy"])
        else:
            outs = bf.generate(prompts["main"], params["greedy"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        st = stats_delta(st0, stats_now(bf))
        timing[label] = dict(tok_s=sum(len(o.token_ids) for o in outs)
                             / wall, decode_ms=st["decode_ms"]
                             / st["decode_steps"], wall_s=wall)
        if label == "tp1_graphed":
            ref_bf16 = outs
    del bf
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4k: unsharded references (f32: "
          f"{', '.join(sorted({k for _, k in ref32}))} at "
          f"{sorted(inputs)} prompts; bf16 greedy) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    d = os.path.join(ROOT, "build", "chip_smoke_tp")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    mesh_refs = {}
    summary = {"timing": timing, "mesh_ref": mesh_refs}

    def references():
        # each mesh model's 1x1 reference, while the first world's ranks
        # serve; they wait on each one's marker before their mesh runs
        t2 = time.perf_counter()
        for arch, _, _ in MESH_MODELS:
            mesh_refs[arch] = mesh_reference(torch, d, arch)
        open(os.path.join(d, "mesh_ref", "all_done"), "w").close()
        print(f"phase 4k (mesh) 1x1 references beside the tp "
              f"{TP_WORLDS[0]} ranks: {time.perf_counter() - t2:.1f} s",
              flush=True)
    refs = {}                     # the families' unsharded runs
    for world in TP_WORLDS:
        t1 = time.perf_counter()
        # the near-tie rulers' trees wait on the host while the ranks
        # (and at the first world the 1x1 references) fill the card
        plain = ruler_on(plain, "cpu")
        for ref in refs.values():
            ref["ruler"] = ruler_on(ref["ruler"], "cpu")
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 4k tp {world}: this process holds "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card "
              f"({torch.cuda.memory_reserved() / 1e9:.3f} GB reserved) as "
              "the ranks start", flush=True)
        res = spawn_tp(world, d, references if world == TP_WORLDS[0]
                       else None)
        plain = ruler_on(plain, "cuda")
        for ref in refs.values():
            ref["ruler"] = ruler_on(ref["ruler"], "cuda")
        r0 = res[0]
        print(f"phase 4k tp {world}: {world} ranks on {r0['device']} "
              f"({r0['card']}) over {r0['backend']}, weights "
              f"{r0['weights_bytes'] / 1e9:.3f} GB a rank (bf16), local "
              f"heads/kv/d_ff {r0['greedy_bf16']['local_heads']}; "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        check(r0["backend"] == "gloo", f"tp {world} on one card ran over "
              f"{r0['backend']}, not gloo")
        for r in res[1:]:
            for name in ["from_arch_f32"] + [x[0] for x in tp_runs(max_new)]:
                check(r[name]["tokens"] == r0[name]["tokens"],
                      f"tp {world} {name}: rank {r['rank']}'s tokens differ "
                      "from rank 0's")
        compare_streams(
            torch, plain, entry, ref_entry,
            [types.SimpleNamespace(token_ids=tuple(t), rid=i) for i, t in
             zip(r0["from_arch_f32"]["rids"], r0["from_arch_f32"]["tokens"])],
            f"phase 4k tp {world} LLM.from_arch(tp={world}, "
            f"dtype='float32'), all {full.n_layers} layers")
        n = TP_PROMPTS[world]
        for name, dtype, kw, pk, prk in tp_runs(max_new):
            got = [types.SimpleNamespace(token_ids=tuple(t), rid=i)
                   for i, t in
                   zip(r0[name]["rids"], r0[name]["tokens"])]
            what = f"phase 4k tp {world} {name} ({n} prompts)"
            if dtype == "float32":
                compare_streams(torch, gap_llm, inputs[n][0][prk],
                                ref32[n, name], got, what)
            else:
                r0[name]["same_as_tp1_bf16"] = compare_streams(
                    torch, gap_llm, prompts[prk], ref_bf16[:n], got,
                    what + " vs unsharded bf16", gate=False)
            check(r0[name]["head_mode"] == "sharded", f"{what}: head mode "
                  f"{r0[name]['head_mode']}")
        check(r0["spec4_f32"]["accepted"] > 0,
              f"tp {world} spec_k 4: no draft accepted")
        check(r0["spec4_f32"]["launches"]["fused_verify_head"] > 0
              and r0["mixed_f32"]["launches"]["fused_topk_head"] > 0,
              f"tp {world}: the verify or top-k kernel did not run")
        gb = r0["greedy_bf16"]
        heads, step = gb["head_bytes_b8"], gb["step_bytes_b8"]
        sweep = 8 * cfg.vocab_size * 4
        check(step is not None, f"tp {world}: no 8-row decode step")
        check(heads["topk_k8"]["head"] < sweep / 4
              and heads["argmax"]["head"] < sweep / 4,
              f"tp {world}: the comparator head moved "
              f"{heads} bytes, not under a quarter of {sweep}")
        print(f"phase 4k tp {world} collective bytes: a decode step of 8 "
              f"rows {step}; at B 8 the argmax head {heads['argmax']}, the "
              f"top-k head (k 8) {heads['topk_k8']}, the Temperature head "
              f"{heads['temperature']} against one f32 logit sweep B*V*4 = "
              f"{sweep} (comparator factor "
              f"{sweep / heads['argmax']['head']:.0f}x / "
              f"{sweep / heads['topk_k8']['head']:.0f}x under it)",
              flush=True)
        timing[f"tp{world}_eager_gloo_{n}_prompts"] = dict(
            tok_s=gb["tok_s"], decode_ms=gb["decode_ms"], wall_s=gb["wall_s"])
        plane = check_control_plane(torch, gap_llm, res, world, inputs[n],
                                    ref32, n)
        if world == 2:
            plane["moe"] = check_tp_moe(torch, res)
        t2 = time.perf_counter()
        plane["families"] = check_tp_families(torch, res, world, refs)
        print(f"phase 4k tp {world}: the families' checks and unsharded "
              f"runs {time.perf_counter() - t2:.1f} s", flush=True)
        # an unsharded ruler stays on the card only while a later world
        # serves its family (the tp 4 ranks' mesh runs fill the card)
        for arch, _, worlds in FAM_TP:
            if arch in refs and max(worlds) <= world:
                del refs[arch]
        gc.collect()
        torch.cuda.empty_cache()
        timing.update(plane.pop("timing"))
        t2 = time.perf_counter()
        plane["mesh"] = check_mesh_train(torch, res, world, mesh_refs, d)
        print(f"phase 4k tp {world}: the mesh training checks "
              f"{time.perf_counter() - t2:.1f} s here, "
              f"{plane['mesh']['rank_seconds']:.1f} s in each rank",
              flush=True)
        summary[f"tp{world}"] = dict(
            launches={n: r0[n]["launches"]
                      for n, *_ in tp_runs(max_new)},
            steps={n: r0[n]["decode_steps"]
                   for n, *_ in tp_runs(max_new)},
            accepted=r0["spec4_f32"]["accepted"],
            bf16_same=gb["same_as_tp1_bf16"], step_bytes_b8=step,
            head_bytes_b8=heads, weights_bytes=r0["weights_bytes"],
            **plane)
    print("phase 4k timing (tok/s, ms a decode step; tp 2 and 4 eager over "
          "gloo through the host on one card, no claim rides on them): "
          + "; ".join(f"{k} {v['tok_s']:.2f} tok/s, {v['decode_ms']:.3f} ms"
                      for k, v in timing.items()), flush=True)
    del gap_llm, dev32, plain, refs
    gc.collect()
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phase 4p: the paper's own experiments on the card
# ---------------------------------------------------------------------------
def run_paper_path(torch) -> tuple:
    """Phase 4p: ``python -m repro_torch.paper`` on the card -- its
    ``main`` in this process, the launch counts set to 0 just before and
    read just after: Table I over its three regimes, Figs 2-3, the
    10-class classifier trained 200 steps on the cross-entropy kernel and
    deployed through both units.  Every CSV line's flag must be true and
    the agreement 1.000; the softmax-unit kernel runs once a Table I
    regime, once a Fig 3 case and once a training step's backward (3 + 2
    + 200), the cross-entropy kernel once a step (200).  Table I's card
    rows are then held to its CPU rows (the plain versions): x bitwise,
    s(x) within UNIT_RTOL / UNIT_ATOL.  Returns (summary, launches)."""
    import contextlib
    import io

    import repro_torch.paper.__main__ as paper_main
    from repro_torch.paper import classifier, table1

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = paper_main.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    lines = buf.getvalue().splitlines()
    csv = [ln for ln in lines if ln.split(",")[0] in ("table1", "fig23",
                                                      "classifier")
           and ln.count(",") >= 2]
    for ln in lines:
        if ln.startswith(("train loss", "test accuracy", "softmax-unit vs",
                          "  softmax unit", "  reduced unit")) or ln in csv:
            print(f"phase 4p: {ln}", flush=True)
    print(f"phase 4p: python -m repro_torch.paper on the card in {wall:.2f}"
          f" s, exit {rc}; launches {launches}", flush=True)
    check(rc == 0, "phase 4p: a paper section failed")
    check("table1,0,all_regimes_argmax_preserved=True" in csv,
          f"phase 4p: Table I's line is not all true: {csv}")
    check("fig23,0,monotone_all=True" in csv,
          f"phase 4p: Figs 2-3's line is not all true: {csv}")
    check(any(ln.startswith("classifier,0,agreement=1.000_") for ln in csv),
          f"phase 4p: the classifier's units disagree: {csv}")
    want = {"online_softmax": 3 + 2 + 200, "fused_xent": 200}
    for name, n in want.items():
        check(launches[name] == n, f"phase 4p: {name} launched "
              f"{launches[name]} times, want {n}")
    with contextlib.redirect_stdout(io.StringIO()):
        card = table1.run(device="cuda", verbose=False)
    cpu = table1.run(device="cpu", verbose=False)
    err = 0.0
    for (name, x, _, sx, _), (_, cx, _, csx, _) in zip(card, cpu):
        check(np.array_equal(x, cx), f"phase 4p: Table I {name}: the card's"
              " inputs differ from the CPU's")
        check(np.allclose(sx, csx, rtol=UNIT_RTOL, atol=UNIT_ATOL),
              f"phase 4p: Table I {name}: the softmax-unit kernel's s(x) "
              "disagrees with its plain version")
        err = max(err, float(np.abs(sx - csx).max()))
    print(f"phase 4p: Table I on the card against the CPU: x bitwise, s(x) "
          f"max_abs_err {err:.3g}", flush=True)
    return dict(lines=csv, wall_s=wall, launches=launches,
                table1_max_abs_err=err,
                classifier_ops=classifier.op_count_lines()), launches


# ---------------------------------------------------------------------------
# Phase 4l: recurrentgemma-2b (the hybrid RG-LRU family) at full width
# ---------------------------------------------------------------------------
RG_MAX_LEN = 2304         # the longest prompt (2,200) + 64 new tokens fit
RG_MAX_NEW = 64
RG_LAYERS = 5             # of 26: (rec, rec, attn) + (rec, rec)


def rg_prompts(vocab: int) -> list:
    """Phase 4l's 8 prompts (numpy seed 27): six of 1-1,000 tokens and
    two of 2,100-2,200, past the 2,048-token window."""
    rng = np.random.default_rng(27)
    lens = [*rng.integers(1, 1001, size=6), *rng.integers(2100, 2201,
                                                          size=2)]
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def check_rg_launches(launches, st, llm, what):
    """A recurrentgemma run's launches against its steps: flash attention
    once an attention layer a prefill (1 a prompt at RG_LAYERS), no paged
    attention
    (the ring buffers are dense), each head kernel once a head call of
    its kind (greedy: decode steps + prefills), no verify or softmax-unit
    kernel."""
    per_step, per_prefill = attention_layers(llm)
    calls = st["head_calls"]
    want = {"paged_attention": 0, "flash_attention": per_prefill
            * st["prefills"], "fused_argmax_head": calls.get("Greedy", 0),
            "fused_topk_head": calls.get("TopK", 0),
            "fused_verify_head": 0, "softmax_stats": 0,
            "online_softmax": 0, "fused_xent": 0}
    print(f"{what} launches: {launches} (want {want}; {st['decode_steps']} "
          f"decode steps, {st['prefills']} prefills)", flush=True)
    check(per_step == 0 and per_prefill == (RG_LAYERS // 3),
          f"{what}: {per_step} paged / {per_prefill} attention layers")
    for name, n in want.items():
        check(launches[name] == n, f"{what}: {name} launched "
              f"{launches[name]} times, want {n}")


RG_FLASH = (2150, 10, 1, 256, 2048)     # T, q heads, KV heads, hd, window


def rg_flash_inputs(torch, gen, hq=RG_FLASH[1]) -> tuple:
    """Row 5b's q, k, v (row 5i's with ``hq`` 5, a tp 2 rank's): bf16 (1,
    H, T, hd) views of (1, T, H, hd) tensors, as recurrentgemma-2b's
    prefill passes them."""
    t, _, hkv, hd, _ = RG_FLASH

    def rand(heads):
        return torch.randn((1, t, heads, hd), generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    return rand(hq), rand(hkv), rand(hkv)


def rg_flash_route(torch) -> list:
    """The device kernels flash attention ran at row 5b's shapes, read
    from a profiler trace (``device_kernels``) in phase 3, beside the
    other route traces; ``check_rg_kernels`` holds them to the
    ``mma.sync`` route in phase 4l."""
    from repro_torch.kernels import flash_attention as fa

    q, k, vv = rg_flash_inputs(
        torch, torch.Generator(device="cuda").manual_seed(27))
    return [n for n in device_kernels(torch, lambda: fa.flash_attention(
        q, k, vv, causal=True, window=RG_FLASH[4]), "flash_attention")
        if "flash_attention" in n]


def rg_flash_row(torch, timer, gen, hq, label) -> dict:
    """Flash attention at recurrentgemma-2b's prefill with ``hq`` query
    heads over its one KV head (10: row 5b; 5, a tp 2 rank's: row 5i),
    T 2,150, hd 256, causal, window 2,048, bf16 on the (B, T, H, hd)
    views the layer passes (``gen`` draws the inputs): held to its plain
    version on random inputs and on inputs where the window decides
    (``check_rg_kernels`` says how), then timed beside its bound and SDPA
    with the window's mask.  Returns the kernel row."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t, _, hkv, hd, window = RG_FLASH
    q, k, vv = rg_flash_inputs(torch, gen, hq)
    idx = torch.arange(t, device="cuda")
    mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None]
                                             - window)

    def held(q, k, vv, what):
        """The kernel against its plain version on (q, k, vv): returns
        (max |err|, the plain output, the limit)."""
        out = fa.flash_attention(q, k, vv, causal=True, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, vv, causal=True,
                                   window=window).float()
        kf = k.float().repeat_interleave(hq // hkv, dim=1)
        vf = vv.float().repeat_interleave(hq // hkv, dim=1)
        p = torch.softmax(torch.einsum("bhtd,bhsd->bhts", q.float(), kf)
                          .div_(math.sqrt(hd)).masked_fill_(~mask,
                                                            float("-inf")),
                          dim=-1)
        spread = torch.einsum("bhts,bhsd->bhtd", p.square_(),
                              vf.square_()).sqrt_()
        del p, kf, vf
        diff = (out.float() - want).abs()
        limit = 4 * BF16_STEP * (want.abs() + spread)
        worst = (diff / limit).max().item()
        err = diff.max().item()
        print(f"{label}, flash_attention g {hq // hkv} {what}: "
              f"max_abs_err {err:.6g}, worst err / limit {worst:.4f} "
              f"(limit 4 * {BF16_STEP:.6g} * (|want| + sqrt(sum p^2 "
              f"v^2)); that spread {spread[:, :, 0].mean().item():.4g} at "
              f"row 0, {spread[:, :, -1].mean().item():.4g} at the last "
              "row)", flush=True)
        check(worst <= 1.0, f"flash attention at {label} g {hq // hkv} "
              f"({what}) disagrees with its plain version: err {err}, "
              f"{worst:.3f} of its limit")
        return err, want, limit

    err, want, _ = held(q, k, vv, "random q, k, v")
    # the window decides: row window + m's query and key m (the first key
    # past that row's window) are one vector of norm 16, so that key
    # would score 256 / 16 = 16 against about N(0, 1) for every other
    # key of the row; the far keys carry v = 4
    far = t - window
    u = torch.randn((far, hd), generator=gen, device="cuda")
    u = (16 * u / u.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    qh, kh, vh = q.clone(), k.clone(), vv.clone()
    qh[:, :, window:] = u
    kh[:, :, :far] = u
    vh[:, :, :far] = 4.0
    err_w, want_w, limit_w = held(qh, kh, vh, f"each of the last {far} "
                                  "rows' first key past the window hot")
    open_w = ref.flash_attention(qh, kh, vh, causal=True,
                                 window=None).float()
    moved = ((open_w - want_w).abs() / limit_w)[:, :, window:]
    print(f"{label}, flash_attention g {hq // hkv} without the window "
          f"would move each of the last {far} rows by at least "
          f"{moved.amax(dim=(0, 1, 3)).min().item():.1f} times its limit",
          flush=True)
    check(moved.amax(dim=(0, 1, 3)).min().item() > 10,
          "the hot-key case does not tell a windowed kernel from one that "
          "ignores the window")
    err = max(err, err_w)
    del qh, kh, vh, want_w, open_w, moved, limit_w
    row = kernel_row(
        timer, lambda: fa.flash_attention(q, k, vv, causal=True,
                                          window=window),
        lambda: ref.flash_attention(q, k, vv, causal=True, window=window),
        lambda: F.scaled_dot_product_attention(q, k, vv, attn_mask=mask,
                                               enable_gqa=True),
        (2 * q.numel() + k.numel() + vv.numel()) * 2,
        4 * hd * hq * int(mask.sum()), err)
    del q, k, vv, want, mask
    return row


def check_rg_kernels(torch, timer, names) -> dict:
    """Rows 5b and 2c: flash attention at recurrentgemma-2b's prefill
    (T 2,150, 10 query heads over 1 KV head -- g 10 --, hd 256, causal,
    window 2,048; bf16, the (B, T, H, hd) views the layer passes; its
    kernels ``names``, read from phase 3's profiler trace
    (``rg_flash_route``): the ``mma.sync`` route) against
    SDPA with the window's mask, and the argmax head at B 8 on the tied
    (V, D) = (256,000, 2,560) embedding (its ``.T`` view) against
    ``argmax(h @ W)``; each against its plain version and timed beside
    its bound.

    Flash attention's bf16 output is held to its plain version (f32
    scores, probabilities and sums, rounded once) element by element
    within ``4 * BF16_STEP * |want|`` (two bf16 steps: the two roundings
    to bf16 of nearly the same f32 value) plus ``4 * BF16_STEP *
    sqrt(sum_j p_j^2 v_j^2)`` (the scale of the kernel's rounding of the
    probabilities p to bf16 in P V: large in the first rows, which see
    few keys, small past them), then again on
    inputs where the window decides the answer: each of the last 102
    rows' first key past the window scores far above every key the row
    sees and carries v = 4, so a kernel that let it in would move that
    row by many times its limit (the plain version without the window
    shows by how much; more than 10 is required)."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import ref

    d, v = 2560, 256000
    gen = torch.Generator(device="cuda").manual_seed(27)
    check(names and all("flash_attention_mma_kernel" in n for n in names),
          f"flash attention at hd 256, g 10 ran {names}, not the mma.sync "
          "kernel")
    rows = {"flash_t2150_g10_hd256": rg_flash_row(
        torch, timer, gen, RG_FLASH[1], "recurrentgemma-2b shapes")}
    rows["flash_t2150_g10_hd256"]["route"] = "mma.sync"
    row = rows["flash_t2150_g10_hd256"]
    print(f"recurrentgemma-2b shapes, flash_attention T=2150 g=10 hd=256 "
          f"window=2048 (ran {names[0][:48]}): kernel {shown(row)}, plain "
          f"{row['plain_ms']:.4f} ms, sdpa(mask) {shown(row, 'library_')}, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"max_abs_err {row['max_abs_err']:.6g}", flush=True)

    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    w = emb.t()                             # the tied head's layout
    h = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    hidx, hval = fah.fused_argmax_head_with_value(h, w)
    torch.cuda.synchronize()
    idx_ok, val_ok, err, _ = argmax_verdict(torch, h, w, hidx, hval)
    check(idx_ok and val_ok, "the argmax head on recurrentgemma's tied head "
          "disagrees with its plain version")
    rows["argmax_b8"] = kernel_row(
        timer, lambda: fah.fused_argmax_head_with_value(h, w),
        lambda: ref.fused_argmax_head_with_value(h, w),
        lambda: torch.argmax(h @ w, dim=-1), v * d * 2 + 8 * d * 2 + 8 * 8,
        2.0 * 8 * d * v, err)
    row = rows["argmax_b8"]
    print(f"recurrentgemma-2b shapes, fused_argmax_head B=8 (V, D) = "
          f"(256000, 2560) tied: kernel {shown(row)}, plain "
          f"{row['plain_ms']:.4f} ms, argmax(h @ W) {shown(row, 'library_')}"
          f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"max_abs_err {err:.6g}", flush=True)
    return rows


def rg_prefill_profile(torch, llm, prompt, module=None,
                       scan="rglru_scan", name="recurrentgemma-2b") -> dict:
    """TTFT of one prompt alone on the idle engine (``LLM.generate`` of
    one token: submit to first emission), then the same prompt's
    ``lm.prefill`` with every plain scan (``module.scan``: the RG-LRU's
    by default, 18 of them; RWKV6's ``wkv_scan``, 32) timed apart (a
    sync before and after each): the plain scan's share of the
    prefill."""
    from repro_torch.models import lm, rglru
    from repro_torch.serve.params import SamplingParams

    module = rglru if module is None else module
    run = drive(torch, llm, [prompt], SamplingParams(max_new_tokens=1))
    ttft = run[3]["ttft_ms_p50"]
    eng, orig, spent = llm.engine, getattr(module, scan), []

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    setattr(module, scan, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(eng.params, eng.cfg, tokens, eng.max_len)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(module, scan, orig)
    ms = sum(spent) * 1e3
    print(f"{name} TTFT of a {len(prompt)}-token prompt: {ttft:.2f} ms "
          f"(alone on the engine); its lm.prefill with each scan synced "
          f"{total:.2f} ms, of which the {len(spent)} plain scans "
          f"({scan}) {ms:.2f} ms ({ms / total:.1%})", flush=True)
    return dict(prompt_tokens=len(prompt), ttft_ms=ttft,
                prefill_synced_ms=total, scan_ms=ms, scans=len(spent),
                scan_share=ms / total)


def rg_replay_f32(torch, twin, prompts, outs, max_new,
                  name="recurrentgemma-2b") -> dict:
    """The f32 twin's graphed ragged greedy tokens (``outs``) against a
    scalar replay -- ``lm.prefill`` then ``lm.decode_step`` one request
    at a time at its own positions -- and against ``argmax(lm.forward(
    prompt + generated))`` at every generated position: all equal
    (``tests/test_serve_paged.py:288``'s rule)."""
    from repro_torch.models import lm

    eng = twin.engine
    params, cfg = eng.params, eng.cfg
    w = lm.lm_head_weight(params, cfg)
    same_replay = same_forward = 0
    for prompt, o in zip(prompts, outs):
        gen = list(o.token_ids)
        toks = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
        h, cache = lm.prefill(params, cfg, toks, eng.max_len)
        replay = [int(torch.argmax(h @ w, -1)[0])]
        for i in range(len(gen) - 1):
            h, cache = lm.decode_step(
                params, cfg, torch.tensor([[replay[-1]]], device="cuda"),
                cache, torch.tensor(len(prompt) + i, dtype=torch.int32,
                                    device="cuda"))
            replay.append(int(torch.argmax(h @ w, -1)[0]))
        del cache
        seq = torch.as_tensor(np.concatenate([prompt, gen[:-1]]),
                              dtype=torch.long, device="cuda")[None]
        logits, _ = lm.forward(params, cfg, seq)
        fwd = logits[0, len(prompt) - 1:].argmax(-1).tolist()
        del logits
        same_replay += replay == gen
        same_forward += fwd == gen
        if replay != gen or fwd != gen:
            k = next(i for i, (a, b, c) in enumerate(zip(gen, replay, fwd))
                     if not a == b == c)
            print(f"{name} f32: rid {o.rid} ({len(prompt)} "
                  f"tokens) parts at step {k}: engine {gen[k]}, replay "
                  f"{replay[k]}, forward {fwd[k]}", flush=True)
    n = len(prompts)
    print(f"{name} f32 twin: engine (graphed, ragged) == scalar "
          f"replay on {same_replay}/{n} streams, == argmax(lm.forward) on "
          f"{same_forward}/{n}", flush=True)
    check(same_replay == same_forward == n, f"{name} f32: the "
          "engine's tokens differ from the scalar replay or lm.forward")
    return dict(replay=same_replay, forward=same_forward, streams=n)


def rg_bf16_partings(torch, llm, twin, prompts, want, got,
                     name="recurrentgemma-2b") -> dict:
    """The bf16 engine's streams (``got``) against the f32 twin's
    (``want``), measured, not a gate: for each stream that parts, the
    step, the f32 top-2 logit gap there against the near-tie rule
    (HEAD_RTOL * |max|, as phase 4j reports), and the bf16 model's
    logits at that prefix against the f32 twin's: their largest and
    RMS difference beside the f32 logits' RMS.  A parting where the f32
    gap lies under the bf16 logits' own error is bf16 rounding; a bf16
    logit error near the logits' own size would be a fault of the bf16
    path."""
    from repro_torch.models import lm

    def logits(eng, toks):
        t = torch.as_tensor(toks, dtype=torch.long, device="cuda")[None]
        h, _ = lm.prefill(eng.params, eng.cfg, t, len(toks))
        return (h @ lm.lm_head_weight(eng.params, eng.cfg))[0].float()

    rows, same = [], 0
    for p, w, g in zip(prompts, want, got):
        if w.token_ids == g.token_ids:
            same += 1
            continue
        k = next((i for i, (a, b) in enumerate(zip(w.token_ids,
                                                   g.token_ids)) if a != b),
                 min(len(w.token_ids), len(g.token_ids)))
        toks = np.concatenate([np.asarray(p, np.int64),
                               np.asarray(w.token_ids[:k], np.int64)])
        l32, l16 = logits(twin.engine, toks), logits(llm.engine, toks)
        top2 = l32.topk(2).values
        gap, top = (top2[0] - top2[1]).item(), top2[0].item()
        d = l16 - l32
        row = dict(rid=g.rid, prompt=len(p), step=k, gap=gap, max=top,
                   near_tie=gap <= HEAD_RTOL * abs(top),
                   bf16_max_err=d.abs().max().item(),
                   bf16_rms_err=d.pow(2).mean().sqrt().item(),
                   f32_rms=l32.pow(2).mean().sqrt().item())
        rows.append(row)
        print(f"{name} bf16 vs the f32 twin: rid {g.rid} "
              f"({len(p)} tokens) parts at step {k}: top-2 f32 logit gap "
              f"{gap:.6g} (max {top:.6g}, {gap / abs(top):.3g} of it; "
              f"{'a' if row['near_tie'] else 'not a'} near-tie at "
              f"{HEAD_RTOL}); bf16 logits there off the f32 twin's by max "
              f"{row['bf16_max_err']:.6g}, rms {row['bf16_rms_err']:.6g} "
              f"against an f32 rms of {row['f32_rms']:.6g}", flush=True)
        del l32, l16, d
    print(f"{name} bf16 vs the f32 twin: {same}/{len(prompts)} "
          "streams equal (measured, not a gate)", flush=True)
    return dict(equal=same, streams=len(prompts), partings=rows)


def run_recurrentgemma_path(torch, max_new=RG_MAX_NEW) -> tuple:
    """Phase 4l: recurrentgemma-2b (the hybrid RG-LRU family) at full
    width in bf16 with its depth cut to RG_LAYERS of 26 ((rec, rec,
    attn) + (rec, rec), d 2,560, 10 heads over 1 KV head of 256, d_ff
    7,680, V 256,000 tied, window 2,048, lru 2,560; random weights from
    seed 0, ``weights.seeded_params``), 8 slots of max_len 2,304 on the
    dense per-slot store (ring buffers and recurrent state): ``rg_prompts``
    greedy at 64 new tokens, eager then graphed twice (the second all
    replays; tokens equal; flash 4 a prefill, no paged attention, the
    argmax head a step
    and a prefill), Theorem 1 against the softmax head, mixed samplers
    (greedy, top-k, candidates, temperature), ``spec_k`` refused,
    ``chunk_size`` and ``host_stride`` warned off on one engine and
    serving the same tokens; an f32 twin
    of the same seed (``weights.seeded_params``, whose bf16 cast must be
    the bf16 engine's tree bitwise) held to its scalar replay and to
    ``lm.forward``; the bf16 streams against the f32 twin's
    (``rg_bf16_partings``, measured).  Prints peak memory, the eager and replayed step against
    the bound of reading every weight once, tok/s and the TTFT of a
    2,150-token prompt with the plain scan's share.  Returns (summary,
    the graphed run 1's launches)."""
    import dataclasses
    import warnings

    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = get_config("recurrentgemma-2b")
    cut = dataclasses.replace(full, n_layers=RG_LAYERS)
    llm = LLM(seeded_params(cut, 0, "cuda"), cut, seed=0, n_slots=8,
              max_len=RG_MAX_LEN)
    torch.cuda.synchronize()
    cfg, eng = llm.cfg, llm.engine
    built_s, built_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    check((full.n_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.attention_window, tuple(cfg.hybrid_pattern), cfg.lru_width,
           cfg.tie_embeddings, cfg.dtype)
          == (26, RG_LAYERS, 2560, 10, 1, 256, 7680, 256000, 2048,
              ("rec", "rec", "attn"), 2560, True, "bfloat16"),
          f"recurrentgemma-2b is not served at its full width: {cfg}")
    check(not eng.store.any_paged, "recurrentgemma-2b's store pages")
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    state = sum(t.numel() * t.element_size()
                for t in _leaves(eng.store.cache()))
    print(f"recurrentgemma-2b: {cfg.n_layers} of {full.n_layers} layers "
          f"({len(eng._layers)} segments), d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim}, "
          f"d_ff={cfg.d_ff}, V={cfg.vocab_size} tied, window "
          f"{cfg.attention_window}, {cfg.dtype}; weights {wbytes / 1e9:.3f} "
          f"GB, ring buffers + recurrent state {state / 1e6:.1f} MB "
          f"({state / 8 / 1e6:.2f} MB a slot); built in {built_s:.1f} s "
          f"(the host draw included), peak {built_peak / 1e9:.3f} GB",
          flush=True)
    prompts = rg_prompts(cfg.vocab_size)
    print(f"recurrentgemma-2b prompts: {[len(p) for p in prompts]} tokens",
          flush=True)
    params = SamplingParams(max_new_tokens=max_new)
    llm.generate([prompts[0][:16]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()

    eager, graphed = drive_both(torch, llm, prompts, params,
                                "recurrentgemma-2b")
    check_rg_launches(eager[2], eager[3], llm, "recurrentgemma-2b eager")
    check_rg_launches(graphed[2], graphed[3], llm,
                      "recurrentgemma-2b graphed")
    check(graphed[2]["fused_argmax_head"] == graphed[3]["decode_steps"]
          + graphed[3]["prefills"], "recurrentgemma-2b: argmax launches != "
          "decode steps + prefills")
    # all 8 rows run as one bucket, which graphed run 1 captured
    again, = drive_replays(torch, llm, prompts, params, "recurrentgemma-2b",
                           graphed, more=1)
    check_rg_launches(again[2], again[3], llm,
                      "recurrentgemma-2b graphed run 2")
    outs = graphed[0]
    for o in outs:
        check(1 <= len(o.token_ids) <= max_new
              and o.finish_reason in ("length", "eos")
              and all(0 <= x < cfg.vocab_size for x in o.token_ids),
              f"recurrentgemma-2b: bad output for rid {o.rid}: "
              f"{o.finish_reason} {o.token_ids}")
    summary = {
        "eager": main_line("recurrentgemma-2b, eager", eager[0], eager[3],
                           eager[4]),
        "graph_first_run": main_line("recurrentgemma-2b, graphed run 1",
                                     outs, graphed[3], graphed[4]),
        "graph": main_line("recurrentgemma-2b, graphed run 2 (replays "
                           "only)", again[0], again[3], again[4])}
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    for k in ("eager", "graph"):
        ms = summary[k]["decode_ms"]
        print(f"recurrentgemma-2b {k} decode step: {ms:.3f} ms against a "
              f"bound of {bound_ms:.3f} ms (every weight read once, the "
              f"tied embedding as the head: {wbytes / 1e9:.3f} GB at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {ms / bound_ms:.2f}x",
              flush=True)
    summary.update(step_bound_ms=bound_ms, weights_gb=wbytes / 1e9,
                   state_mb=state / 1e6, built_s=built_s,
                   built_peak_gb=built_peak / 1e9, graphs=graph_line(llm),
                   prompt_tokens=[len(p) for p in prompts])
    check_theorem1(torch, llm, prompts, outs, max_new,
                   what="recurrentgemma-2b theorem 1", max_len=RG_MAX_LEN)
    sampled_launches, summary["sampled"] = run_sampled_path(
        torch, llm, prompts, outs, max_new, what="recurrentgemma-2b sampled")
    summary["sampled"]["launches"] = sampled_launches

    try:
        llm.generate([prompts[0]], SamplingParams(max_new_tokens=4,
                                                  spec_k=4))
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"recurrentgemma-2b spec_k=4: refused: {refused}", flush=True)
    check(refused is not None and "rewound" in refused,
          "recurrentgemma-2b: spec_k was not refused")
    kw = {"chunk_size": 64, "host_stride": 8}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e = LLM(eng.params, cfg, n_slots=8, max_len=RG_MAX_LEN, seed=0,
                **kw)
    for what in ("chunk_size=64 ignored", "host_stride=8 ignored"):
        check(any(what in str(c.message) for c in caught),
              f"recurrentgemma-2b {kw}: no '{what}' warning")
    check(e.engine.chunk_size is None and e.engine.host_stride is None,
          f"recurrentgemma-2b {kw}: the modes were not dropped")
    run = drive_graphed(torch, e, prompts, params,
                        f"recurrentgemma-2b {kw}")
    check_rg_launches(run[2], run[3], e, f"recurrentgemma-2b {kw}")
    summary["fallback_identical"] = compare_streams(
        torch, llm, prompts, outs, run[0],
        f"recurrentgemma-2b {kw} (fallen back) vs the main run")
    del e, run
    long = np.random.default_rng(28).integers(0, cfg.vocab_size, size=2150)
    summary["ttft_long"] = rg_prefill_profile(torch, llm,
                                              long.astype(np.int32))

    # the f32 twin: one seed, one tree -- its bf16 cast is the engine's
    f32 = dataclasses.replace(cfg, dtype="float32")
    masters = seeded_params(f32, 0, "cuda")
    same_tree = all(torch.equal(m.to(torch.bfloat16), b) for m, b in zip(
        _leaves(masters), _leaves(eng.params)))
    print(f"recurrentgemma-2b: seeded_params(seed 0) on the card cast to "
          f"bf16 == the engine's tree: {same_tree}", flush=True)
    check(same_tree, "recurrentgemma-2b: the engine's tree is not the "
          "seed's")
    twin = LLM(masters, f32, n_slots=8, max_len=RG_MAX_LEN, seed=0)
    del masters
    trun = drive_graphed(torch, twin, prompts, params,
                         "recurrentgemma-2b f32 twin")
    check(trun[6] > 0, "recurrentgemma-2b f32 twin: no replay")
    summary["f32"] = rg_replay_f32(torch, twin, prompts, trun[0], max_new)
    summary["bf16_vs_f32"] = rg_bf16_partings(torch, llm, twin, prompts,
                                              trun[0], outs)
    del twin, trun
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"recurrentgemma-2b phase peak memory: "
          f"{summary['peak_memory_gb']:.3f} GB allocated "
          "(torch.cuda.max_memory_allocated)", flush=True)
    return summary, graphed[2]


# ---------------------------------------------------------------------------
# Phase 4m: rwkv6-7b (the RWKV6 family) at full width
# ---------------------------------------------------------------------------
RW_MAX_NEW = 64
RW_MAX_LEN = 1024 + RW_MAX_NEW     # the longest prompt + its new tokens
RW_LAYERS = 2        # of 32: the plain wkv scan is ~96% of a prefill


def rw_prompts(vocab: int) -> list:
    """Phase 4m's 8 prompts (numpy seed 29): 3 and 1,024 tokens, and six
    of 4-399 (the plain scan's prefill is most of each run's wall)."""
    rng = np.random.default_rng(29)
    lens = [3, 1024, *rng.integers(4, 400, size=6)]
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def check_rwkv_launches(launches, st, what):
    """An rwkv6 run's launches against its steps: no attention kernel
    (every layer is time-mix + channel-mix), each head kernel once a head
    call of its kind (greedy: decode steps + prefills), no verify or
    softmax-unit kernel."""
    calls = st["head_calls"]
    want = {"paged_attention": 0, "flash_attention": 0,
            "fused_argmax_head": calls.get("Greedy", 0),
            "fused_topk_head": calls.get("TopK", 0),
            "fused_verify_head": 0, "softmax_stats": 0,
            "online_softmax": 0, "fused_xent": 0}
    print(f"{what} launches: {launches} (want {want}; {st['decode_steps']} "
          f"decode steps, {st['prefills']} prefills)", flush=True)
    for name, n in want.items():
        check(launches[name] == n, f"{what}: {name} launched "
              f"{launches[name]} times, want {n}")


def check_rwkv_kernels(torch, timer) -> dict:
    """Rows 2d and 3c: the argmax head at B 8 and the top-k head at B 4, k
    8 on rwkv6-7b's untied head -- (D, V) = (4,096, 65,536) as the engine
    stores it, the ``.T`` view of a row-major (V, D) tensor -- against
    their plain versions, each timed beside its bound (the head's bf16
    bytes once) and ``argmax(h @ W)`` / ``topk(h @ W)``."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    d, v = 4096, 65536
    gen = torch.Generator(device="cuda").manual_seed(29)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         / math.sqrt(d)).to(torch.bfloat16).t()
    h8 = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    h4 = h8[:4].contiguous()
    idx, val = fah.fused_argmax_head_with_value(h8, w)
    vals, ids = ftk.fused_topk_head(h4, w, 8)
    torch.cuda.synchronize()
    idx_ok, val_ok, err, _ = argmax_verdict(torch, h8, w, idx, val)
    check(idx_ok and val_ok, "the argmax head on rwkv6-7b's untied head "
          "disagrees with its plain version")
    tv = topk_verdict(torch, h4, w, 8, vals, ids)
    check(tv["idx_ok"] and tv["ties_ok"] and tv["desc_ok"] and tv["val_ok"],
          f"the top-k head on rwkv6-7b's untied head disagrees with its "
          f"plain version: {tv}")
    wb = v * d * 2
    rows = {
        "argmax_b8": kernel_row(
            timer, lambda: fah.fused_argmax_head_with_value(h8, w),
            lambda: ref.fused_argmax_head_with_value(h8, w),
            lambda: torch.argmax(h8 @ w, dim=-1), wb + 8 * d * 2 + 8 * 8,
            2.0 * 8 * d * v, err),
        "topk_b4_k8": kernel_row(
            timer, lambda: ftk.fused_topk_head(h4, w, 8),
            lambda: ref.fused_topk_head(h4, w, 8),
            lambda: torch.topk(h4 @ w, 8, dim=-1),
            wb + 4 * d * 2 + 4 * 8 * 8, 2.0 * 4 * d * v,
            tv["err"])}
    for name, lib in (("argmax_b8", "argmax(h @ W)"),
                      ("topk_b4_k8", "topk(h @ W)")):
        row = rows[name]
        print(f"rwkv6-7b shapes, {name} on the untied (V, D) = (65536, "
              f"4096) head: kernel {shown(row)}, plain "
              f"{row['plain_ms']:.4f} ms, {lib} {shown(row, 'library_')}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
              f"max_abs_err {row['max_abs_err']:.6g}", flush=True)
    return rows


def run_rwkv_path(torch, max_new=RW_MAX_NEW) -> tuple:
    """Phase 4m: rwkv6-7b (the RWKV6 family) at full width in bf16 with
    its depth cut to RW_LAYERS of 32 (d 4,096, 64 wkv heads of 64, d_ff
    14,336 relu_sq, V 65,536 untied; random weights from seed 0,
    ``weights.seeded_params``), 8 slots of per-slot state (shifts and wkv): 8
    prompts of 3-1,024 tokens greedy at 64 new tokens, eager then graphed
    twice (the second all replays; tokens equal; no attention kernel, the
    argmax head a step and a prefill), Theorem 1 against the softmax
    head, mixed samplers, ``spec_k`` refused, ``chunk_size`` and
    ``host_stride`` warned off on one engine with the same tokens; an f32
    twin of the same seed (its bf16 cast the engine's tree bitwise) held
    to its scalar replay and to ``lm.forward``; the bf16 streams against
    the f32 twin's (measured).  Prints peak memory, the eager and
    replayed step against the bound of reading every weight once, tok/s
    and the TTFT of a 1,024-token prompt with the plain wkv scan's
    share.  Returns (summary, the graphed run 1's launches, the sampled
    run's)."""
    import dataclasses
    import warnings

    from repro_torch.models import rwkv6
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = get_config("rwkv6-7b")
    cut = dataclasses.replace(full, n_layers=RW_LAYERS)
    llm = LLM(seeded_params(cut, 0, "cuda"), cut, seed=0, n_slots=8,
              max_len=RW_MAX_LEN)
    torch.cuda.synchronize()
    cfg, eng = llm.cfg, llm.engine
    built_s, built_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    check((full.n_layers, cfg.n_layers, cfg.d_model, cfg.rwkv_head_size,
           cfg.d_ff, cfg.vocab_size, cfg.activation, cfg.tie_embeddings,
           cfg.dtype)
          == (32, RW_LAYERS, 4096, 64, 14336, 65536, "relu_sq", False,
              "bfloat16"),
          f"rwkv6-7b is not served at its full width: {cfg}")
    check(not eng.store.any_paged, "rwkv6-7b's store pages")
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    state = sum(t.numel() * t.element_size()
                for t in _leaves(eng.store.cache()))
    print(f"rwkv6-7b: {cfg.n_layers} of {full.n_layers} layers, "
          f"d={cfg.d_model}, "
          f"{cfg.d_model // cfg.rwkv_head_size} wkv heads of "
          f"{cfg.rwkv_head_size}, d_ff={cfg.d_ff} {cfg.activation}, "
          f"V={cfg.vocab_size} untied, {cfg.dtype}; weights "
          f"{wbytes / 1e9:.3f} GB, state {state / 1e6:.1f} MB "
          f"({state / 8 / 1e6:.2f} MB a slot); built in {built_s:.1f} s "
          f"(the host draw included), peak {built_peak / 1e9:.3f} GB",
          flush=True)
    prompts = rw_prompts(cfg.vocab_size)
    print(f"rwkv6-7b prompts: {[len(p) for p in prompts]} tokens",
          flush=True)
    params = SamplingParams(max_new_tokens=max_new)
    llm.generate([prompts[0]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()

    eager, graphed = drive_both(torch, llm, prompts, params, "rwkv6-7b")
    check_rwkv_launches(eager[2], eager[3], "rwkv6-7b eager")
    check_rwkv_launches(graphed[2], graphed[3], "rwkv6-7b graphed")
    check(graphed[2]["fused_argmax_head"] == graphed[3]["decode_steps"]
          + graphed[3]["prefills"] > 0, "rwkv6-7b: argmax launches != "
          "decode steps + prefills")
    again, = drive_replays(torch, llm, prompts, params, "rwkv6-7b", graphed,
                           more=1)
    check_rwkv_launches(again[2], again[3], "rwkv6-7b graphed run 2")
    outs = graphed[0]
    for o in outs:
        check(1 <= len(o.token_ids) <= max_new
              and o.finish_reason in ("length", "eos")
              and all(0 <= x < cfg.vocab_size for x in o.token_ids),
              f"rwkv6-7b: bad output for rid {o.rid}: {o.finish_reason} "
              f"{o.token_ids}")
    summary = {
        "eager": main_line("rwkv6-7b, eager", eager[0], eager[3], eager[4]),
        "graph_first_run": main_line("rwkv6-7b, graphed run 1", outs,
                                     graphed[3], graphed[4]),
        "graph": main_line("rwkv6-7b, graphed run 2 (replays only)",
                           again[0], again[3], again[4])}
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    for k in ("eager", "graph"):
        ms = summary[k]["decode_ms"]
        print(f"rwkv6-7b {k} decode step: {ms:.3f} ms against a bound of "
              f"{bound_ms:.3f} ms (every weight read once: "
              f"{wbytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} "
              f"TB/s): {ms / bound_ms:.2f}x", flush=True)
    summary.update(step_bound_ms=bound_ms, weights_gb=wbytes / 1e9,
                   state_mb=state / 1e6, built_s=built_s,
                   built_peak_gb=built_peak / 1e9, graphs=graph_line(llm),
                   prompt_tokens=[len(p) for p in prompts])
    check_theorem1(torch, llm, prompts, outs, max_new,
                   what="rwkv6-7b theorem 1", max_len=RW_MAX_LEN)
    sampled_launches, summary["sampled"] = run_sampled_path(
        torch, llm, prompts, outs, max_new, what="rwkv6-7b sampled")
    summary["sampled"]["launches"] = sampled_launches

    try:
        llm.generate([prompts[0]], SamplingParams(max_new_tokens=4,
                                                  spec_k=4))
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"rwkv6-7b spec_k=4: refused: {refused}", flush=True)
    check(refused is not None and "rewound" in refused,
          "rwkv6-7b: spec_k was not refused")
    kw = {"chunk_size": 64, "host_stride": 8}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e = LLM(eng.params, cfg, n_slots=8, max_len=RW_MAX_LEN, seed=0,
                **kw)
    for what in ("chunk_size=64 ignored", "host_stride=8 ignored"):
        check(any(what in str(c.message) for c in caught),
              f"rwkv6-7b {kw}: no '{what}' warning")
    check(e.engine.chunk_size is None and e.engine.host_stride is None
          and not e.engine.prefix_cache,
          f"rwkv6-7b {kw}: the modes were not dropped")
    run = drive_graphed(torch, e, prompts, params, f"rwkv6-7b {kw}")
    check_rwkv_launches(run[2], run[3], f"rwkv6-7b {kw}")
    summary["fallback_identical"] = compare_streams(
        torch, llm, prompts, outs, run[0],
        f"rwkv6-7b {kw} (fallen back) vs the main run")
    del e, run
    long = np.random.default_rng(30).integers(0, cfg.vocab_size, size=1024)
    summary["ttft_long"] = rg_prefill_profile(
        torch, llm, long.astype(np.int32), module=rwkv6, scan="wkv_scan",
        name="rwkv6-7b")

    f32 = dataclasses.replace(cfg, dtype="float32")
    masters = seeded_params(f32, 0, "cuda")
    same_tree = all(torch.equal(m.to(torch.bfloat16), b) for m, b in zip(
        _leaves(masters), _leaves(eng.params)))
    print(f"rwkv6-7b: seeded_params(seed 0) on the card cast to bf16 == "
          f"the engine's tree: {same_tree}", flush=True)
    check(same_tree, "rwkv6-7b: the engine's tree is not the seed's")
    twin = LLM(masters, f32, n_slots=8, max_len=RW_MAX_LEN, seed=0)
    del masters
    trun = drive_graphed(torch, twin, prompts, params, "rwkv6-7b f32 twin")
    check(trun[6] > 0, "rwkv6-7b f32 twin: no replay")
    check_rwkv_launches(trun[2], trun[3], "rwkv6-7b f32 twin")
    summary["f32"] = rg_replay_f32(torch, twin, prompts, trun[0], max_new,
                                   name="rwkv6-7b")
    summary["bf16_vs_f32"] = rg_bf16_partings(torch, llm, twin, prompts,
                                              trun[0], outs,
                                              name="rwkv6-7b")
    del twin, trun
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"rwkv6-7b phase peak memory: {summary['peak_memory_gb']:.3f} GB "
          "allocated (torch.cuda.max_memory_allocated)", flush=True)
    return summary, graphed[2], sampled_launches


# ---------------------------------------------------------------------------
# Phase 4n: the MoE family -- phi3.5-moe at full width, llama4's topology
# ---------------------------------------------------------------------------
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_SMOKE = "llama4-maverick-400b-a17b"
MOE_LAYERS = 2       # of 32: its 83.75 GB of bf16 weights exceed one card
MOE_MAX_NEW = 64
MOE_TOL = 1e-4       # one MoE layer, card vs CPU in f32: atol = rtol


def moe_prompts(vocab: int) -> list:
    """Phase 4n's 8 prompts: phase 4's first 8 (numpy seed 0, 64-512
    tokens), their ids taken modulo ``vocab``."""
    prng = np.random.default_rng(0)
    main = [prng.integers(0, 151936, size=int(n)).astype(np.int32)
            for n in prng.integers(64, 513, size=12)]
    return [(p % vocab).astype(np.int32) for p in main[:8]]


def count_drops(torch, llm, prompts, params) -> dict:
    """One eager run of ``llm`` with ``layers.moe_slots`` wrapped, so each
    MoE call reports the choices it dropped (a host sync a call: eager
    only; the graphed runs are not touched).  The calls come a forward
    pass at a time, one a MoE layer: a pass of at most 8 tokens is a
    decode step (its rows padded to a power of two), a longer one a
    prefill.  Returns the drops of each decode step and each prefill,
    summed over the layers, and the capacities seen."""
    from repro_torch.models import layers, lm
    from repro_torch.serve import step_graph

    calls = []
    inner = layers.moe_slots

    def counted(idx, spec, group):
        rank, keep, cap = inner(idx, spec, group)
        calls.append((idx.shape[0], cap, int((~keep).sum())))
        return rank, keep, cap

    n_moe = lm.layer_types(llm.cfg).count("moe")
    layers.moe_slots = counted
    try:
        with step_graph.eager_steps():
            outs = llm.generate(prompts, params)
    finally:
        layers.moe_slots = inner
    steps, prefills, caps = [], [], set()
    for i in range(0, len(calls), n_moe):
        passes = calls[i:i + n_moe]
        n_tok = passes[0][0]
        (steps if n_tok <= 8 else prefills).append(
            sum(c[2] for c in passes))
        if n_tok <= 8:
            caps.add((n_tok, passes[0][1]))
    return dict(outs=outs, step_drops=steps, prefill_drops=prefills,
                decode_capacity=sorted(caps))


def profile_moe_share(torch, llm, prompts, steps=3) -> dict:
    """``torch.profiler`` over ``steps`` eager decode iterations of 8 rows
    (every request admitted first): the device time of the kernels the
    MoE layers launched (a ``record_function`` range around each
    ``lm.moe_layer`` call) against all the step's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import lm
    from repro_torch.serve import step_graph
    from repro_torch.serve.params import SamplingParams

    eng = llm.engine
    inner = lm.moe_layer

    def ranged(*a, **kw):
        with record_function("moe_layer"):
            return inner(*a, **kw)

    with step_graph.eager_steps():
        for p in prompts[:8]:
            llm.submit(p, SamplingParams(max_new_tokens=steps + 4))
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        lm.moe_layer = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    eng.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        finally:
            lm.moe_layer = inner
        while eng.has_work:
            eng.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    moe_ms = sum(getattr(e, "device_time_total", 0)
                 for e in prof.key_averages()
                 if e.key == "moe_layer") / 1e3 / steps
    if not kernels or not moe_ms:
        print(f"phi3.5-moe eager step profile: wall {wall_ms:.3f} ms/step; "
              "the profiler attributed no device time (MoE share not "
              "measured)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=busy_ms or None, moe_ms=None,
                    moe_share=None)
    print(f"phi3.5-moe eager step profile (8 rows, {steps} steps, profiler "
          f"on): wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} "
          f"ms/step in {len(kernels) / steps:.0f} kernels, the MoE layers "
          f"{moe_ms:.3f} ms/step = {100 * moe_ms / busy_ms:.1f}% of it",
          flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, moe_ms=moe_ms,
                moe_share=moe_ms / busy_ms,
                kernels_per_step=len(kernels) / steps)


def check_moe_layer_card_vs_cpu(torch, twin, prompts) -> dict:
    """One decode step's MoE layer, its input taken from a real eager
    step of ``twin`` (f32, the published capacity factor; 8 rows, the
    middle layer), run on the card and, with the same f32 leaves copied
    over, on the CPU: the same experts, ranks and kept choices, and the
    outputs within MOE_TOL."""
    from repro_torch.models import layers, lm
    from repro_torch.serve import step_graph
    from repro_torch.serve.params import SamplingParams

    eng = twin.engine
    seen = []
    inner = lm.moe_layer

    def grab(p, x, cfg, **kw):
        if x.shape[1] == 1:
            seen.append((p, x.detach().clone()))
        return inner(p, x, cfg, **kw)

    with step_graph.eager_steps():
        for p in prompts[:8]:
            twin.submit(p, SamplingParams(max_new_tokens=2))
        lm.moe_layer = grab
        try:
            eng.step()                    # admit all 8, one decode step
        finally:
            lm.moe_layer = inner
        while eng.has_work:
            eng.step()
    check(len(seen) == eng.cfg.n_layers, f"phi3.5-moe layer check: "
          f"{len(seen)} decode MoE calls in one step")
    p, x = seen[len(seen) // 2]
    spec, res = eng.cfg.moe, {}
    for dev in ("cuda", "cpu"):
        pd = {k: v.to(dev) for k, v in p.items()}
        xd = x.to(dev)
        _, vals, idx = layers.moe_route(xd.reshape(-1, x.shape[-1]),
                                        pd["router"], spec)
        rank, keep, cap = layers.moe_slots(idx, spec, x.shape[0])
        y, aux = layers.moe_layer(pd, xd, eng.cfg, impl="scatter")
        res[dev] = [t.cpu() for t in (idx, rank, keep, vals, y, aux)]
        del pd
    c, h = res["cuda"], res["cpu"]
    same = all(torch.equal(a, b) for a, b in zip(c[:3], h[:3]))
    err = (c[4] - h[4]).abs().max().item()
    print(f"phi3.5-moe layer {len(seen) // 2} of a decode step (8 rows, f32, "
          f"capacity {cap} an expert): card vs CPU experts, ranks and kept "
          f"choices equal: {same} ({int((~c[2]).sum())} of "
          f"{c[2].numel()} choices dropped); output max abs err {err:.3g}, "
          f"routing weights {(c[3] - h[3]).abs().max().item():.3g}, aux "
          f"{c[5].item():.6g} / {h[5].item():.6g}", flush=True)
    check(same, "phi3.5-moe: the card and the CPU keep different choices")
    check(torch.allclose(c[4], h[4], atol=MOE_TOL, rtol=MOE_TOL),
          f"phi3.5-moe: the MoE layer on the card is {err} off the CPU's")
    return dict(same_kept=same, max_abs_err=err,
                dropped=int((~c[2]).sum()), capacity=cap)


def run_moe_path(torch, max_new=MOE_MAX_NEW) -> tuple:
    """Phase 4n: phi3.5-moe (the MoE family) at full width in bf16 with
    its depth cut to MOE_LAYERS (d 4,096, 32 q over 8 kv heads of 128, 16
    experts of 6,400 top-2 SiLU-GLU in every layer, V 32,064 untied;
    random weights from seed 0, ``weights.seeded_params``, f32 on the
    card and kept as the twins' masters), 8 paged slots of 1,024: 8
    prompts of 64-512 tokens greedy at ``max_new`` tokens, eager then
    graphed three times (the third all replays; tokens equal; paged
    attention once a layer a decode step, flash once a layer a prefill,
    the argmax head a step and a prefill, verify none), Theorem 1,
    mixed samplers, ``spec_k`` refused, ``chunk_size`` and
    ``host_stride`` warned off with the same tokens; the choices dropped
    per step at the published capacity factor (1.25; an eager run); the
    MoE layers' share of a profiled eager step; an f32 twin at 1.25 (the
    bf16 streams measured against it; one decode step's MoE layer on the
    card against the CPU) and one at capacity factor 16 = E, which drops
    nothing, held to its scalar replay and ``argmax(lm.forward)``;
    llama4-maverick's smoke config ((attn, moe) units, a shared expert,
    top-1) through the same engine, graphed == eager.  Prints the
    replayed step against the bound of reading every weight once, tok/s
    and the peak memory.  Returns (summary, the graphed run 1's launches,
    the sampled run's, the llama4 run's)."""
    import dataclasses
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    torch.cuda.reset_peak_memory_stats()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    masters = seeded_params(cfg, 0, "cuda")
    llm = LLM(masters, cfg, n_slots=8, max_len=1024, seed=0)
    torch.cuda.synchronize()
    eng = llm.engine
    built_s, built_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    m = cfg.moe
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           m.num_experts, m.top_k, m.d_ff_expert, m.capacity_factor,
           cfg.vocab_size, cfg.tie_embeddings, cfg.dtype)
          == (4096, 32, 8, 128, 16, 2, 6400, 1.25, 32064, False,
              "bfloat16") and full.n_layers == 32,
          f"phi3.5-moe is not served at its full width: {cfg}")
    check(eng.store.any_paged, "phi3.5-moe's store does not page")
    wbytes = step_weight_bytes(eng)
    print(f"phi3.5-moe: {cfg.n_layers} of {full.n_layers} layers, "
          f"d={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, {m.num_experts} experts of {m.d_ff_expert} "
          f"top-{m.top_k} {cfg.activation}, capacity factor "
          f"{m.capacity_factor}, V={cfg.vocab_size} untied, {cfg.dtype}; "
          f"weights a step reads {wbytes / 1e9:.3f} GB, KV pool "
          f"{sum(_nbytes(p) for p in eng.store.pools.values()) / 1e9:.3f} "
          f"GB; "
          f"built in {built_s:.1f} s (the host draw and the f32 masters "
          f"on the card included), peak {built_peak / 1e9:.3f} GB",
          flush=True)
    prompts = moe_prompts(cfg.vocab_size)
    print(f"phi3.5-moe prompts: {[len(p) for p in prompts]} tokens",
          flush=True)
    params = SamplingParams(max_new_tokens=max_new)
    llm.generate([prompts[0][:16]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()

    eager, graphed = drive_both(torch, llm, prompts, params, "phi3.5-moe")
    check_main_launches(eager[2], eager[3], cfg, len(prompts),
                        "phi3.5-moe eager")
    check_main_launches(graphed[2], graphed[3], cfg, len(prompts),
                        "phi3.5-moe graphed run 1")
    _, again = drive_replays(torch, llm, prompts, params, "phi3.5-moe",
                             graphed)
    check_main_launches(again[2], again[3], cfg, len(prompts),
                        "phi3.5-moe graphed run 3")
    outs = graphed[0]
    for o in outs:
        check(1 <= len(o.token_ids) <= max_new
              and o.finish_reason in ("length", "eos")
              and all(0 <= x < cfg.vocab_size for x in o.token_ids),
              f"phi3.5-moe: bad output for rid {o.rid}: {o.finish_reason} "
              f"{o.token_ids}")
    summary = {
        "eager": main_line("phi3.5-moe, eager", eager[0], eager[3],
                           eager[4]),
        "graph_first_run": main_line("phi3.5-moe, graphed run 1", outs,
                                     graphed[3], graphed[4]),
        "graph": main_line("phi3.5-moe, graphed run 3 (replays only)",
                           again[0], again[3], again[4])}
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    for k in ("eager", "graph"):
        ms = summary[k]["decode_ms"]
        print(f"phi3.5-moe {k} decode step: {ms:.3f} ms against a bound of "
              f"{bound_ms:.3f} ms (every weight but the embedding read once, "
              f"every expert's slots computed: {wbytes / 1e9:.3f} GB at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {ms / bound_ms:.2f}x",
              flush=True)
    summary.update(step_bound_ms=bound_ms, weights_gb=wbytes / 1e9,
                   built_s=built_s, built_peak_gb=built_peak / 1e9,
                   graphs=graph_line(llm),
                   prompt_tokens=[len(p) for p in prompts])
    check_theorem1(torch, llm, prompts, outs, max_new,
                   what="phi3.5-moe theorem 1")
    sampled_launches, summary["sampled"] = run_sampled_path(
        torch, llm, prompts, outs, max_new, what="phi3.5-moe sampled",
        gate=False)
    summary["sampled"]["launches"] = sampled_launches

    try:
        llm.generate([prompts[0]], SamplingParams(max_new_tokens=4,
                                                  spec_k=4))
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"phi3.5-moe spec_k=4: refused: {refused}", flush=True)
    check(refused is not None and "MoE" in refused,
          "phi3.5-moe: spec_k was not refused")
    kw = {"chunk_size": 64, "host_stride": 8}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e = LLM(eng.params, cfg, n_slots=8, max_len=1024, seed=0, **kw)
    for what in ("chunk_size=64 ignored", "host_stride=8 ignored"):
        check(any(what in str(c.message) for c in caught),
              f"phi3.5-moe {kw}: no '{what}' warning")
    check(e.engine.chunk_size is None and e.engine.host_stride is None
          and not e.engine.prefix_cache,
          f"phi3.5-moe {kw}: the modes were not dropped")
    run = drive_graphed(torch, e, prompts, params, f"phi3.5-moe {kw}")
    check_main_launches(run[2], run[3], cfg, len(prompts),
                        f"phi3.5-moe {kw}")
    summary["fallback_identical"] = compare_streams(
        torch, llm, prompts, outs, run[0],
        f"phi3.5-moe {kw} (fallen back) vs the main run")
    del e, run

    drops = count_drops(torch, llm, prompts, params)
    compare_streams(torch, llm, prompts, outs, drops.pop("outs"),
                    "phi3.5-moe eager run counting drops vs graphed run 1")
    per = drops["step_drops"]
    print(f"phi3.5-moe choices dropped at capacity factor "
          f"{m.capacity_factor} (eager run; capacities (rows, slots an "
          f"expert) {drops['decode_capacity']}): per decode step over its "
          f"{cfg.n_layers} layers {per}; {sum(per)} in {len(per)} steps, "
          f"{sum(d > 0 for d in per)} steps with a drop, max {max(per)}; "
          f"per prefill {drops['prefill_drops']}", flush=True)
    check(max(per) > 0, "phi3.5-moe: no decode step dropped a choice")
    summary["drops"] = dict(per_step=per, total=sum(per),
                            mean=sum(per) / len(per), max=max(per),
                            per_prefill=drops["prefill_drops"],
                            decode_capacity=drops["decode_capacity"])
    summary["profile"] = profile_moe_share(torch, llm, prompts)

    f32 = dataclasses.replace(cfg, dtype="float32")
    twin = LLM(masters, f32, n_slots=8, max_len=1024, seed=0)
    trun = drive_graphed(torch, twin, prompts, params,
                         "phi3.5-moe f32 twin")
    check(trun[6] > 0, "phi3.5-moe f32 twin: no replay")
    check_main_launches(trun[2], trun[3], f32, len(prompts),
                        "phi3.5-moe f32 twin")
    summary["bf16_vs_f32"] = rg_bf16_partings(torch, llm, twin, prompts,
                                              trun[0], outs,
                                              name="phi3.5-moe")
    summary["layer_card_vs_cpu"] = check_moe_layer_card_vs_cpu(
        torch, twin, prompts)
    del twin, trun
    gc.collect()
    torch.cuda.empty_cache()
    e_num = m.num_experts
    nodrop = dataclasses.replace(f32, moe=dataclasses.replace(
        m, capacity_factor=float(e_num)))
    twin = LLM(masters, nodrop, n_slots=8, max_len=1024, seed=0)
    trun = drive_graphed(torch, twin, prompts, params,
                         f"phi3.5-moe f32 twin at capacity factor {e_num}")
    check(trun[6] > 0, "phi3.5-moe f32 no-drop twin: no replay")
    summary["f32_no_drop"] = rg_replay_f32(
        torch, twin, prompts, trun[0], max_new,
        name=f"phi3.5-moe at capacity factor {e_num}")
    del twin, trun, masters
    gc.collect()
    torch.cuda.empty_cache()
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"phi3.5-moe phase peak memory: {summary['peak_memory_gb']:.3f} GB "
          "allocated (torch.cuda.max_memory_allocated)", flush=True)

    small = LLM.from_arch(MOE_SMOKE, smoke=True, seed=0, n_slots=8,
                          max_len=128)
    sc = small.cfg
    check(lm.segments(sc)[0][0] == ("attn", "moe") and sc.moe.shared_expert
          and sc.moe.top_k == 1, f"{MOE_SMOKE} smoke: not the interleaved "
          f"shared-expert topology: {sc}")
    sp = [(p[:24] % sc.vocab_size).astype(np.int32) for p in prompts]
    s_eager, s_graphed = drive_both(torch, small, sp,
                                    SamplingParams(max_new_tokens=16),
                                    f"{MOE_SMOKE} smoke")
    check_main_launches(s_graphed[2], s_graphed[3], sc, len(sp),
                        f"{MOE_SMOKE} smoke graphed")
    summary["llama4_smoke"] = dict(
        graphed_equal_eager=True, replays=s_graphed[6],
        decode_steps=s_graphed[3]["decode_steps"],
        launches=s_graphed[2])
    del small
    return summary, graphed[2], sampled_launches, s_graphed[2]


# ---------------------------------------------------------------------------
# Phase 4o: training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_B, TRAIN_S = 2, 4096   # train_4k's sequence; its batch cut 256 -> 2
TRAIN_STEPS = 8              # cut to pay for phase 4k's mesh runs
TRAIN_WARM = 3               # steps before the timed ones
# AdamW's peak lr at full width: the CLI's 3e-3 (sized for the smoke
# config) diverges here -- the training CLI at B 2 x S 4,096 on an H100
# logs loss 12.43 at step 0, 12.95 at step 10, 12.51 at step 19 (the
# head's cotangent in f32; 12.85 at step 10 with it rounded to bf16)
TRAIN_LR = 1e-3
TRAIN_GRAD_ARCHS = ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b",
                    "recurrentgemma-2b", "rwkv6-7b", "internvl2-26b",
                    "seamless-m4t-large-v2")
TRAIN_GRAD_TOL = 1e-3        # a leaf, card vs CPU, f32: of its max |value|
# bf16 under remat: the card's worst leaf (and loss) against the CPU's
# f32, at most this many times the CPU's own bf16 run's
TRAIN_BF16_RATIO = 2.0
TRAIN_SERVE = (4, 64, 16)    # prompts, their tokens, new tokens
TRAIN_RESUME_TOL = 1e-5
# phase 4s: the dry-run's predicted bytes a rank over 4o's measured peak.
# The prediction is an upper estimate (at least 1); its ratio read 1.120
# / 1.122 against the peaks of two runs on the card (18.963 / 18.929 GB),
# so 1.25 leaves room above them and fails a walk that overcounts
DRYRUN_PEAK_RATIO = (1.0, 1.25)


def check_train_grads(torch) -> dict:
    """Phase 4o (a): ``train_loss`` and every gradient leaf on the card
    against the port's plain path on the CPU, on the same f32 smoke
    weights (``weights.seeded_params``) and batch (B 2 x S 64, with the
    stub frontends' embeddings where the family takes them), for the
    dense, MoE, hybrid, RWKV6, vlm and enc-dec families (the last through
    the non-causal flash Function: the encoder, the cross-attention over
    S != T keys).  No leaf may be None, nor all zero where the CPU's is
    not; each within TRAIN_GRAD_TOL of its largest |value|; flash once a
    self- or cross-attention layer of the forward."""
    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import api, lm
    from repro_torch.weights import seeded_params

    out = {}
    for arch in TRAIN_GRAD_ARCHS:
        cfg = smoke_config(get_config(arch))
        params = seeded_params(cfg, 0, "cpu")
        batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size), cfg,
                              ShapeSpec("t", 64, 2, "train"), "cpu").batch(0)
        want_loss, want = steps_mod.loss_and_grads(params, cfg, batch)
        reset_launches()
        live = [p.detach().to("cuda").requires_grad_(True)
                for p in tree_mod.leaves(params)]
        loss = api.train_loss(tree_mod.unflatten(params, live), cfg,
                              {k: v.to("cuda") for k, v in batch.items()})
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        torch.cuda.synchronize()
        launches = read_launches()
        missing = [tree_mod.key(p) for (p, _), g in zip(
            tree_mod.items(params), grads) if g is None]
        worst, dead = 0.0, []
        for (p, w), g in zip(tree_mod.items(want), grads):
            if g is None:
                continue
            scale = float(w.abs().max())
            if scale > 0 and float(g.abs().max()) == 0:
                dead.append(tree_mod.key(p))
            err = float((g.cpu() - w).abs().max()) / max(scale, 1e-3)
            worst = max(worst, err)
        loss_err = abs(float(loss.detach()) - float(want_loss))
        ok = not missing and not dead and worst <= TRAIN_GRAD_TOL \
            and loss_err <= 1e-4
        print(f"phase 4o (a) {arch} smoke, f32: loss card "
              f"{float(loss.detach()):.6f}"
              f" / CPU {float(want_loss):.6f}; {len(grads)} gradient "
              f"leaves, {len(missing)} None, {len(dead)} zero where the "
              f"CPU's is not, worst leaf error {worst:.3g} of its max "
              f"|value| (limit {TRAIN_GRAD_TOL}); launches flash "
              f"{launches['flash_attention']}, fused_xent "
              f"{launches['fused_xent']}, online_softmax "
              f"{launches['online_softmax']}: {'ok' if ok else 'FAIL'}",
              flush=True)
        check(not missing, f"{arch}: gradient leaves with no gradient on "
              f"the card: {missing}")
        check(not dead, f"{arch}: gradient leaves zero on the card: {dead}")
        check(worst <= TRAIN_GRAD_TOL and loss_err <= 1e-4,
              f"{arch}: card gradients disagree with the CPU's")
        check(launches["fused_xent"] == 1 and launches["online_softmax"] == 1,
              f"{arch}: the loss did not run the cross-entropy kernels")
        n_flash = lm.kv_layers(cfg) + cfg.n_encoder_layers + sum(
            k == "xattn" for k in lm.layer_types(cfg))
        check(launches["flash_attention"] == n_flash,
              f"{arch}: flash launched {launches['flash_attention']} times, "
              f"not {n_flash}")
        out[arch] = dict(loss=float(loss.detach()),
                         loss_cpu=float(want_loss),
                         worst_leaf_error=worst, leaves=len(grads),
                         launches={k: v for k, v in launches.items() if v})
    out["qwen3-0.6b bf16 remat"] = check_train_grads_bf16(torch)
    return out


def check_train_grads_bf16(torch) -> dict:
    """Phase 4o (a) in bf16: qwen3-0.6b's smoke config in bf16 under
    ``remat="dots"`` (as the full-width run trains), ``train_loss`` and
    every gradient leaf on the card against the CPU's f32 on the same
    f32 masters and batch; the worst leaf's error over its max |value|
    and the loss's error at most TRAIN_BF16_RATIO times those of the
    CPU's own bf16 run under remat.  No leaf None or zero; flash twice a
    layer."""
    import dataclasses

    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import api, lm
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("qwen3-0.6b"))
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", remat="dots")
    params = seeded_params(cfg, 0, "cpu")
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size), cfg,
                          ShapeSpec("t", 64, 2, "train"), "cpu").batch(0)
    want_loss, want = steps_mod.loss_and_grads(params, cfg, batch)
    cpu_loss, cpu = steps_mod.loss_and_grads(params, cfg16, batch)
    reset_launches()
    live = [p.detach().to("cuda").requires_grad_(True)
            for p in tree_mod.leaves(params)]
    loss = api.train_loss(tree_mod.unflatten(params, live), cfg16,
                          {k: v.to("cuda") for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    torch.cuda.synchronize()
    launches = read_launches()

    def worst(got):
        return max(float((g.float().cpu() - w).abs().max())
                   / max(float(w.abs().max()), 1e-3)
                   for (_, w), g in zip(tree_mod.items(want), got))

    missing = sum(g is None for g in grads)
    dead = sum(g is not None and float(g.abs().max()) == 0
               and float(w.abs().max()) > 0
               for (_, w), g in zip(tree_mod.items(want), grads))
    card_gap = worst(grads) if not missing else math.inf
    cpu_gap = worst(tree_mod.leaves(cpu))
    loss, want_loss = float(loss.detach()), float(want_loss)
    card_loss_gap = abs(loss - want_loss)
    cpu_loss_gap = abs(float(cpu_loss) - want_loss)
    limit, loss_limit = TRAIN_BF16_RATIO * cpu_gap, max(
        TRAIN_BF16_RATIO * cpu_loss_gap, 2.0 ** -8 * abs(want_loss))
    ok = not missing and not dead and card_gap <= limit \
        and card_loss_gap <= loss_limit
    print(f"phase 4o (a) qwen3-0.6b smoke, bf16, remat 'dots': loss card "
          f"{loss:.6f} / CPU bf16 {float(cpu_loss):.6f} / CPU f32 "
          f"{want_loss:.6f} (limit {loss_limit:.3g} from f32); {len(grads)}"
          f" gradient leaves, {missing} None, {dead} zero where the CPU's "
          f"is not; worst leaf error against the CPU's f32 over its max "
          f"|value|: card {card_gap:.4g}, CPU bf16 {cpu_gap:.4g} (limit "
          f"{TRAIN_BF16_RATIO} x the CPU's); launches flash "
          f"{launches['flash_attention']}, fused_xent "
          f"{launches['fused_xent']}, online_softmax "
          f"{launches['online_softmax']}: {'ok' if ok else 'FAIL'}",
          flush=True)
    check(not missing and not dead, "bf16: gradient leaves None or zero "
          "on the card")
    check(card_gap <= limit and card_loss_gap <= loss_limit,
          "bf16 under remat: the card's gradients are further from the "
          "CPU's f32 than the CPU's own bf16 run allows")
    check(launches["flash_attention"] == 2 * lm.kv_layers(cfg)
          and launches["fused_xent"] == 1
          and launches["online_softmax"] == 1,
          f"bf16 under remat: launches {launches}")
    return dict(loss=loss, loss_cpu_bf16=float(cpu_loss),
                loss_cpu=want_loss, worst_leaf_error=card_gap,
                worst_leaf_error_cpu_bf16=cpu_gap, leaves=len(grads),
                launches={k: v for k, v in launches.items() if v})


def check_train_kernels(torch, timer) -> dict:
    """Phase 4o (c): the training path's kernels alone at its shapes,
    each against its plain version and timed beside its bound and one
    library call: flash attention at B 2, T 4,096, 16 / 8 heads of 128,
    bf16, causal (row 5d; SDPA), the cross-entropy, stats and softmax
    kernels on (8,192, 151,936) f32 logits -- the step's loss and its
    backward's two-launch softmax (rows 6b, 7b, 8a;
    ``F.cross_entropy``, ``torch.logsumexp``, ``torch.softmax``) -- and
    the plain-recompute attention backward of a layer
    (``ops.flash_attention_backward``) beside SDPA's backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ops, ref

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(40)
    b, t, hq, hkv, hd = TRAIN_B, TRAIN_S, 16, 8, 128

    def rand(heads):
        return torch.randn((b, t, heads, hd), generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    q, k, v = rand(hq), rand(hkv), rand(hkv)
    out = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q, k, v, causal=True)
    err = (out.float() - want.float()).abs().max().item()
    ok = torch.allclose(out.float(), want.float(), atol=FA_TOL, rtol=FA_TOL)
    print(f"phase 4o (c) flash_attention B {b} T {t} g 2 bf16 causal: "
          f"max_abs_err {err:.6g} vs plain (atol = rtol = {FA_TOL}): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "flash attention at the training shapes disagrees with its "
          "plain version")
    del out, want
    pairs = b * t * (t + 1) // 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rows["flash_t4096_b2_g2"] = kernel_row(
        timer, lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        nbytes, 4 * hd * hq * pairs, err)
    model_line("phase 4o (c) row 5d, train_4k B 2", "flash_attention",
               rows["flash_t4096_b2_g2"], "sdpa")

    # the attention backward of a layer: the plain recompute (sliced
    # over query rows) against SDPA's backward
    g = torch.randn(q.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dq, dk, dv = ops.flash_attention_backward(q, k, v, g, causal=True)
    torch.cuda.synchronize()
    bwd_extra = torch.cuda.max_memory_allocated() - before
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             enable_gqa=True)
    lib = torch.autograd.grad(lib_out, (qs, ks, vs), g, retain_graph=True)
    errs = [(a.float() - w.float()).abs().max().item() / max(
        w.float().abs().max().item(), 1e-6) for a, w in zip((dq, dk, dv),
                                                            lib)]
    print(f"phase 4o (c) attention backward B {b} T {t}: plain recompute "
          f"vs SDPA's backward, largest error of dq / dk / dv over their "
          f"max |value| {errs[0]:.3g} / {errs[1]:.3g} / {errs[2]:.3g} "
          f"(limit 0.05); {bwd_extra / 1e9:.3f} GB allocated beyond its "
          f"inputs", flush=True)
    check(max(errs) <= 0.05, "the plain attention backward disagrees with "
          "SDPA's")
    # q, k, v and the output gradient read, dq, dk, dv written;
    # recompute QK^T, then dV, dP, dQ, dK: 5 GEMMs of 2 * hd a pair
    bwd_bytes = (3 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
        * q.element_size()
    bound_ms, bound_by = bound(bwd_bytes, 10 * hd * hq * pairs,
                               BF16_FLOPS_PER_S)
    plain = timer.readings(lambda: ops.flash_attention_backward(
        q, k, v, g, causal=True))
    libr = timer.readings(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), g, retain_graph=True), "library_")
    rows["attention_backward"] = dict(
        max_rel_err=max(errs), extra_bytes=bwd_extra, **plain,
        bound_ms=bound_ms, bound_by=bound_by, **libr)
    print(f"phase 4o (c) attention backward a layer: plain recompute "
          f"{shown(plain)}, SDPA backward {shown(libr, 'library_')}, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    del q, k, v, g, dq, dk, dv, qs, ks, vs, lib_out, lib
    torch.cuda.empty_cache()

    n_rows, v_ = TRAIN_B * TRAIN_S, 151936
    x = torch.randn((n_rows, v_), generator=gen, device="cuda") * 4
    lab = torch.randint(0, v_, (n_rows,), generator=gen, device="cuda")
    m, l = osm.softmax_stats(x)
    p = osm.online_softmax(x)
    loss = fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    print(f"phase 4o (c) softmax unit B={n_rows} f32 (the step's logits):",
          flush=True)
    errs = unit_errors(torch, x, lab, m, l, p, loss)
    # the route from the shapes, as the wrappers pick it (late in a whole
    # run the profiler drops most kernels of a trace, so phase 3's
    # trace-based check is not repeated here)
    unit = osm.plan_of(x)
    plan = dict(route=unit.route, chunk=unit.chunk, nsplit=unit.nsplit,
                vec=unit.vec)
    print(f"phase 4o (c) softmax unit plan at {n_rows} f32 rows: chunk "
          f"{unit.chunk}, nsplit {unit.nsplit}; online_softmax route "
          f"{unit.route}", flush=True)
    del m, l, p, loss
    n, el = n_rows * v_, x.element_size()
    for name, kern, plain_fn, lib_fn, nb, fl in (
            ("fused_xent", lambda: fx.fused_xent(x, lab),
             lambda: ref.fused_xent(x, lab),
             lambda: F.cross_entropy(x, lab, reduction="none"),
             n * el + 12 * n_rows, 4 * n),
            ("softmax_stats", lambda: osm.softmax_stats(x),
             lambda: ref.softmax_stats(x),
             lambda: torch.logsumexp(x, dim=-1), n * el + 8 * n_rows, 4 * n),
            ("online_softmax", lambda: osm.online_softmax(x),
             lambda: ref.online_softmax(x),
             lambda: torch.softmax(x, dim=-1), n * el + 4 * n, 6 * n)):
        kern_t, plain_ms = timer.readings(kern), timer(plain_fn)
        lib_t = timer.readings(lib_fn, "library_")
        bound_ms, bound_by = bound(nb, fl, F32_FLOPS_PER_S)
        rows[f"{name}_b8192_f32"] = dict(
            max_abs_err=errs[name], **kern_t, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, **lib_t, plan=plan)
        print(f"phase 4o (c) {name} (8192, 151936) f32: kernel "
              f"{shown(kern_t)}, plain {plain_ms:.4f} ms, library "
              f"{shown(lib_t, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nb / 1e9:.3f} GB)", flush=True)
    del x, lab
    torch.cuda.empty_cache()
    return rows


def train_step_flops(cfg, b, s) -> float:
    """The hand formula phase 4o's model-FLOP share used before the
    dry-run's ``segment_cost.model_flops`` (printed beside it once): 6 N
    per token for the weights, plus causal attention's score and value
    products forward (4 hd a visible (query head, key) pair) and
    backward (twice that)."""
    from repro_torch.models import lm

    attn = 3 * 4 * cfg.head_dim * cfg.n_heads * b * s * (s + 1) // 2
    return 6 * cfg.param_count() * b * s + attn * lm.kv_layers(cfg)


def profile_train_step(torch, step_fn, state, batch) -> dict:
    """``torch.profiler`` over one more training step: the device time of
    the kernels launched by the loss's forward (``api.train_loss``), by
    the plain attention backward (``ops.flash_attention_backward``, a
    range around each call) and by ``optimizer.update``, against every
    kernel of the step; the rest is the backward (the remat recompute,
    the GEMMs' and the loss's backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import optimizer as opt_mod

    spans = {"forward": (steps_mod.api, "train_loss"),
             "attention_backward": (ops, "flash_attention_backward"),
             "optimizer": (opt_mod, "update")}
    inner = {name: getattr(mod, attr) for name, (mod, attr)
             in spans.items()}

    def ranged(name):
        def fn(*a, **kw):
            with record_function(name):
                return inner[name](*a, **kw)
        return fn

    torch.cuda.synchronize()
    for name, (mod, attr) in spans.items():
        setattr(mod, attr, ranged(name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, metrics = step_fn(state, batch)
            float(metrics["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, (mod, attr) in spans.items():
            setattr(mod, attr, inner[name])
    # the union of the device events' intervals: the events list can
    # hold a kernel more than once (a first reading summed 1,842 ms of
    # kernels in a 1,071 ms step)
    spans_us = sorted({(e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA})
    kernels, busy_us, end = len(spans_us), 0, None
    for a, b in spans_us:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    busy = busy_us / 1e3
    ms = {e.key: getattr(e, "device_time_total", 0) / 1e3
          for e in prof.key_averages() if e.key in spans}
    if not kernels or not all(ms.get(k) for k in spans) \
            or sum(ms.values()) > busy:
        # a trace that dropped kernels (it happens late in a whole run)
        print(f"phase 4o (b) profiled step: wall {wall_ms:.1f} ms; the "
              f"trace holds {kernels} kernels, busy {busy:.1f} ms, spans "
              f"{ms}: incomplete (split not measured)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=busy or None, split=None)
    split = dict(ms, backward_rest=busy - sum(ms.values()))
    print(f"phase 4o (b) profiled step (profiler on): wall {wall_ms:.1f} "
          f"ms, device busy {busy:.1f} ms in {kernels} kernels: "
          + ", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f} %)"
                      for k, v in split.items()), flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy, kernels=kernels,
                split=split)


def run_train_path(torch) -> tuple:
    """Phase 4o (b) and (d): qwen3-0.6b at full width and full depth in
    bf16 (28 layers, ``remat="dots"`` as configured: each layer
    recomputed in the backward), f32 masters from
    ``weights.seeded_params`` on the card, TRAIN_STEPS steps of
    ``launch.steps.make_train_step`` (AdamW lr TRAIN_LR, warmup 10,
    clip 1.0) on ``TokenPipeline``'s synthetic corpus at B 2 x S 4,096; every
    loss and grad_norm finite, the mean of the last 5 losses below the
    first, each step's launches (flash 28 x 2, fused_xent 1, the
    backward's softmax once, on its route), ms a step after TRAIN_WARM
    steps, tokens/s, the peak memory, the train state's bytes (phase 4s
    gates the dry-run's on them) and the model-FLOP share
    (``segment_cost.model_flops``, the old hand formula once beside it);
    one more step profiled (``profile_train_step``).
    Then (d): ``LLM`` on the trained masters
    serves 4 prompts x 16 new tokens with the comparator head and with
    the softmax baseline -- equal tokens.  Returns (summary, the
    training launches, the serving launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.data.pipeline import _hash_tokens
    from repro_torch import tree as tree_mod
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.launch import segment_cost
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import optimizer as opt_mod
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k_b2", TRAIN_S, TRAIN_B, "train")
    opt_cfg = opt_mod.AdamWConfig(lr=TRAIN_LR, warmup_steps=10,
                                  total_steps=TRAIN_STEPS, clip_norm=1.0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = seeded_params(cfg, 0, "cuda")
    state = {"params": params, "opt": opt_mod.init_state(opt_cfg, params)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = {k: sum(t.numel() * t.element_size()
                          for t in tree_mod.leaves(state[k]))
                   for k in ("params", "opt")}
    step_fn = steps_mod.make_train_step(cfg, opt_cfg)
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=cfg.vocab_size), cfg,
                         shape, "cuda")
    route = osm.unit_plan(torch.float32, TRAIN_B * TRAIN_S, cfg.vocab_size,
                          osm.device_resident_blocks(
                              0, torch.float32)).route
    flops = segment_cost.model_flops(cfg, shape)
    old_flops = train_step_flops(cfg, TRAIN_B, TRAIN_S)
    curve, norms, times, per_step = [], [], [], []
    reset_launches()
    for i in range(TRAIN_STEPS):
        batch = pipe.batch(i)
        before = read_launches()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(time.perf_counter() - t1)
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
        curve.append(loss)
        norms.append(gnorm)
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"training step {i}: loss {loss}, grad_norm {gnorm}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_attn = lm.kv_layers(cfg)
    want = {"flash_attention": 2 * n_attn, "fused_xent": 1,
            "online_softmax": 1,
            "softmax_stats": int(route == osm.TWO_LAUNCH),
            "paged_attention": 0, "fused_argmax_head": 0,
            "fused_verify_head": 0, "fused_topk_head": 0}
    step_ms = 1e3 * sum(times[TRAIN_WARM:]) / (TRAIN_STEPS - TRAIN_WARM)
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    share = flops / BF16_FLOPS_PER_S / (step_ms / 1e3)
    old_share = old_flops / BF16_FLOPS_PER_S / (step_ms / 1e3)
    last5 = sum(curve[-5:]) / 5
    print(f"phase 4o (b) {TRAIN_ARCH} at full width and depth ("
          f"{cfg.n_layers} layers, {cfg.param_count():,} parameters), bf16,"
          f" remat {cfg.remat!r}, B {TRAIN_B} x S {TRAIN_S}: masters + "
          f"AdamW state made in {init_s:.2f} s; loss curve "
          + ", ".join(f"{c:.4f}" for c in curve), flush=True)
    print("phase 4o (b) grad_norm " + ", ".join(f"{g:.4f}" for g in norms)
          + "; step ms " + ", ".join(f"{1e3 * t:.1f}" for t in times),
          flush=True)
    print(f"phase 4o (b) {step_ms:.3f} ms a step (mean of steps "
          f"{TRAIN_WARM}-{TRAIN_STEPS - 1}), {tok_s:.1f} tokens/s; peak "
          f"memory {peak / 1e9:.3f} GB (the dry-run's prediction: phase "
          f"4s); train state {state_bytes['params']:,} B of masters + "
          f"{state_bytes['opt']:,} B of AdamW state; model FLOPs "
          f"(segment_cost.model_flops) {flops / 1e12:.2f} TFLOP a step, "
          f"{1e3 * flops / BF16_FLOPS_PER_S:.2f} ms at 989 TFLOP/s: "
          f"{100 * share:.2f} % of the step (the old hand formula's "
          f"{old_flops / 1e12:.2f} TFLOP: {100 * old_share:.2f} %); the "
          f"backward's "
          f"softmax route at {TRAIN_B * TRAIN_S} f32 rows: {route}; "
          f"launches a step {per_step[-1]}", flush=True)
    check(last5 < curve[0], f"training did not learn: first loss "
          f"{curve[0]:.4f}, mean of the last 5 {last5:.4f}")
    for i, got in enumerate(per_step):
        check(all(got[k] == v for k, v in want.items()),
              f"training step {i}: launches {got}, want {want}")
    profiled = profile_train_step(torch, step_fn, state,
                                  pipe.batch(TRAIN_STEPS))

    # (d) serve what was trained
    n_p, n_tok, new = TRAIN_SERVE
    prompts = _hash_tokens(0, 10_000, np.arange(n_p), n_tok,
                           cfg.vocab_size).tolist()
    outs, serve_launches = {}, {}
    for mode in ("reduced", "softmax"):
        llm = LLM(state["params"], cfg, n_slots=n_p, max_len=n_tok + new,
                  eos_id=-1, head_mode=mode, seed=0)
        reset_launches()
        outs[mode] = [list(o.token_ids) for o in llm.generate(
            prompts, SamplingParams(max_new_tokens=new))]
        serve_launches[mode] = read_launches()
        del llm
    same = sum(a == b for a, b in zip(outs["reduced"], outs["softmax"]))
    print(f"phase 4o (d) the trained masters served: {n_p} prompts x {new} "
          f"new tokens, the comparator head == the softmax baseline for "
          f"{same}/{n_p} streams; launches (comparator) "
          f"{serve_launches['reduced']}", flush=True)
    check(same == n_p, "Theorem 1 on trained weights: the comparator's "
          "tokens differ from the softmax baseline's")
    check(serve_launches["reduced"]["fused_argmax_head"] > 0,
          "the trained model's comparator head launched no kernel")
    del state, params, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(arch=TRAIN_ARCH, layers=cfg.n_layers, batch=TRAIN_B,
                   seq=TRAIN_S, steps=TRAIN_STEPS, remat=cfg.remat,
                   loss=curve, grad_norm=norms,
                   step_ms_each=[1e3 * t for t in times], step_ms=step_ms,
                   tokens_per_s=tok_s, peak_bytes=peak,
                   state_bytes=state_bytes, opt_cfg=opt_cfg,
                   model_tflop=flops / 1e12, model_flop_share=share,
                   old_model_tflop=old_flops / 1e12,
                   old_model_flop_share=old_share,
                   softmax_route=route, launches_per_step=per_step[-1],
                   profile=profiled,
                   serve_equal=same, init_s=init_s)
    return summary, launches, serve_launches


def check_train_resume(torch) -> dict:
    """Phase 4o (e): ``launch.train.train`` on the card at qwen3-0.6b's
    smoke config (B 8 x S 64): 10 steps uninterrupted, against 5 steps,
    a checkpoint, and a fresh ``train`` restoring it for 5 more; losses
    6-10 within TRAIN_RESUME_TOL (bitwise or not, printed)."""
    import shutil

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.train import train
    from repro_torch.optim import optimizer as opt_mod

    cfg = smoke_config(get_config(TRAIN_ARCH))
    shape = ShapeSpec("t", 64, 8, "train")
    opt = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    d = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(d, ignore_errors=True)
    quiet = lambda *a, **k: None  # noqa: E731
    try:
        _, full = train(cfg, shape, opt, device="cuda", steps=10, log=quiet)
        _, first = train(cfg, shape, opt, device="cuda", steps=5,
                         ckpt_dir=d, ckpt_every=5, log=quiet)
        logs = []
        _, second = train(cfg, shape, opt, device="cuda", steps=10,
                          ckpt_dir=d, ckpt_every=5, log=logs.append)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gap = max(abs(a - b) for a, b in zip(full[5:], second))
    bitwise = full[5:] == second
    print(f"phase 4o (e) resume on the card ({cfg.name}, B 8 x S 64): "
          f"losses 6-10 uninterrupted "
          + ", ".join(f"{x:.7f}" for x in full[5:]) + "; resumed "
          + ", ".join(f"{x:.7f}" for x in second)
          + f"; largest gap {gap:.3g} (limit {TRAIN_RESUME_TOL}), "
          f"{'bitwise equal' if bitwise else 'not bitwise equal'}",
          flush=True)
    check("[restore] resumed from step 5" in logs,
          "the resumed run did not restore step 5")
    check(len(second) == 5 and gap <= TRAIN_RESUME_TOL,
          "the resumed run's losses differ from the uninterrupted run's")
    return dict(full=full, first=first, second=second, max_gap=gap,
                bitwise=bitwise)


def run_train_phase(torch) -> tuple:
    """Phase 4o: (c) the kernel rows, (a) gradient parity, (b) qwen3-0.6b
    training, (d) serving what was trained, (e) resume.  Returns
    (summary, rows, the training launches, the serving launches)."""
    t0 = time.perf_counter()
    timer = Timer(torch)
    rows = check_train_kernels(torch, timer)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"grads": check_train_grads(torch)}
    path, launches, serve_launches = run_train_path(torch)
    summary.update(path)
    summary["resume"] = check_train_resume(torch)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"phase 4o: {summary['phase_s']:.1f} s", flush=True)
    return summary, rows, launches, serve_launches


def run_dryrun_phase(train: dict) -> dict:
    """Phase 4s (host seconds only, after 4o): the dry-run
    (``launch.dryrun.run_cell``) on ``meta`` at phase 4o's cell --
    qwen3-0.6b, bf16, ``remat="dots"``, B 2 x S 4,096, 1x1, 4o's AdamW
    config -- held to what 4o measured on the card: its param and
    optimizer bytes equal, exactly, the bytes of the train state 4o
    held, and the predicted bytes a rank over 4o's
    ``max_memory_allocated`` lie within DRYRUN_PEAK_RATIO (an upper
    estimate, not far above; else the run fails); ``model_flops`` beside
    the old hand formula; the cell's ``t_bound`` against 4o's ms a step
    (the step's roofline share)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    shape = ShapeSpec("train_4k_b2", TRAIN_S, TRAIN_B, "train")
    cell = dryrun.run_cell(TRAIN_ARCH, shape, "1x1",
                           opt_cfg=train["opt_cfg"])
    mem, want = cell["memory"], train["state_bytes"]
    total, peak = mem["total"], train["peak_bytes"]
    mf, old = cell["model_flops"], train["old_model_tflop"] * 1e12
    t_bound = cell["totals"]["t_bound_s"]
    print(f"phase 4s dry-run of 4o's cell ({TRAIN_ARCH}, B {TRAIN_B} x S "
          f"{TRAIN_S}, 1x1, on meta): params {mem['params']:,} B, AdamW "
          f"state {mem['optimizer']:,} B (4o's train state: "
          f"{want['params']:,} / {want['opt']:,} B); predicted "
          f"{total / 1e9:.3f} GB a rank (gradients "
          f"{mem['gradients'] / 1e9:.3f}, activations "
          f"{mem['activations'] / 1e9:.3f}) against 4o's peak "
          f"{peak / 1e9:.3f} GB: ratio {total / peak:.3f}", flush=True)
    print(f"phase 4s model FLOPs a step: segment_cost.model_flops "
          f"{mf / 1e12:.3f} TFLOP, the old hand formula {old / 1e12:.3f} "
          f"TFLOP (gap {100 * (old - mf) / mf:+.2f} %); walked FLOPs "
          f"{cell['totals']['flops_per_dev'] / 1e12:.3f} TFLOP (useful "
          f"share {cell['useful_flops_ratio']:.3f})", flush=True)
    tot = cell["totals"]
    print(f"phase 4s roofline: t_compute {1e3 * tot['t_compute_s']:.2f} ms, "
          f"t_memory {1e3 * tot['t_memory_s']:.2f} ms, "
          f"bound {1e3 * t_bound:.2f} ms ({tot['bottleneck']}) "
          f"against 4o's {train['step_ms']:.3f} ms a step: roofline share "
          f"{100 * 1e3 * t_bound / train['step_ms']:.2f} %", flush=True)
    check(mem["params"] == want["params"]
          and mem["optimizer"] == want["opt"],
          f"the dry-run's state bytes {mem['params']} / "
          f"{mem['optimizer']} differ from 4o's train state "
          f"{want['params']} / {want['opt']}")
    lo, hi = DRYRUN_PEAK_RATIO
    check(lo <= total / peak <= hi,
          f"the dry-run's predicted {total:,} B a rank over 4o's peak "
          f"{peak:,} B is {total / peak:.4f}, outside [{lo}, {hi}]")
    out = dict(params=mem["params"], optimizer=mem["optimizer"],
               predicted_bytes=total, measured_peak=peak,
               peak_ratio=total / peak, model_flops=mf, old_flops=old,
               flop_gap=(old - mf) / mf, t_bound_s=t_bound,
               step_ms=train["step_ms"],
               roofline_share=1e3 * t_bound / train["step_ms"],
               memory=mem, totals=cell["totals"])
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 4s: {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4q: the vlm family (internvl2-26b at full width); phase 4r: the
# enc-dec family (seamless-m4t-large-v2 at full width, its depth cut)
# ---------------------------------------------------------------------------
VLM_ARCH = "internvl2-26b"
VLM_LAYERS = 6               # of 48: cut to pay for phase 4k's new meshes
VLM_PROMPTS = 8              # phase 4's first 8 prompts, ids mod V
VLM_IMAGE_B, VLM_IMAGE_T, VLM_IMAGE_NEW = 4, 64, 16
ED_ARCH = "seamless-m4t-large-v2"
ED_LAYERS = 6                # of 24 + 24: cut to pay for phase 4k's meshes
ED_B, ED_SRC, ED_T, ED_NEW = 8, 1024, 64, 32
ED_SMOKE_TOL = 1e-4          # f32 decode hidden states, card vs CPU


def check_vlm_kernels(torch, timer) -> dict:
    """Phase 4q (a): rows 1k / 5e / 2f / 3e / 4c -- kernels 1, 5, 2, 3 and
    the verify head at internvl2-26b's shapes (48 query heads over 8 KV
    heads of 128, g 6; flash over 768 positions, the image prefix and
    the longest prompt; the untied (92,553, 6,144) head, not a multiple
    of the 64-id tile; verify at B 8 x T 5, spec_k 4's window)."""
    return check_model_kernels(torch, timer, VLM_ARCH, hq=48, hkv=8,
                               hd=128, d=6144, v=92553, seed=31,
                               paged_ts=(1,), flash_t=768, verify_t=5)


def vlm_image_prefix(torch, llm) -> dict:
    """Phase 4q (c): ``lm.prefill`` with 256 stub image embeddings
    (``data.pipeline._stub_embeds``, seed 0, step 0) in the first
    positions of a 320-token input (then a 64-token prompt) at B 4, then
    VLM_IMAGE_NEW greedy ``lm.decode_step``s on the dense cache, the
    argmax head each step; the same tokens without the embeddings.  The
    streams with the prefix must differ from those without, and the
    argmax head equal ``argmax(logits_fn)`` at every step but at a
    near-tie."""
    from repro_torch.data.pipeline import _stub_embeds
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    eng = llm.engine
    params, cfg = eng.params, eng.cfg
    n, b, t = cfg.num_image_tokens, VLM_IMAGE_B, VLM_IMAGE_T
    rng = np.random.default_rng(9)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n + t)),
                           device="cuda")
    img = torch.as_tensor(_stub_embeds(0, 0, np.arange(b), n, cfg.d_model),
                          device="cuda").to(torch.bfloat16)
    w = lm.lm_head_weight(params, cfg)
    runs, worst_gap, flips = {}, 0.0, 0
    for name, embeds in (("prefix", img), ("tokens", None)):
        reset_launches()
        h, cache = lm.prefill(params, cfg, toks, n + t + VLM_IMAGE_NEW,
                              image_embeds=embeds)
        out = []
        for i in range(VLM_IMAGE_NEW):
            idx, _ = ops.fused_argmax_head_with_value(h, w)
            logits = lm.logits_fn(params, cfg, h)
            top2 = logits.topk(2, dim=-1).values
            plain = logits.argmax(dim=-1)
            near = (top2[:, 0] - top2[:, 1]) <= HEAD_RTOL * top2[:, 0].abs()
            bad = (idx.long() != plain) & ~near
            check(not bool(bad.any()), f"4q (c) {name}: the argmax head "
                  f"!= argmax(logits_fn) at a decided step {i}")
            flips += int((idx.long() != plain).sum())
            out.append(idx.long())
            if i + 1 < VLM_IMAGE_NEW:
                h, cache = lm.decode_step(params, cfg, idx.long()[:, None],
                                          cache, torch.tensor(
                                              n + t + i, device="cuda"))
        torch.cuda.synchronize()
        launches = read_launches()
        runs[name] = torch.stack(out, 1).tolist()
        check(launches["flash_attention"] == cfg.n_layers
              and launches["paged_attention"] == 0
              and launches["fused_argmax_head"] == VLM_IMAGE_NEW,
              f"4q (c) {name}: launches {launches}")
    differ = sum(a != b for a, b in zip(runs["prefix"], runs["tokens"]))
    print(f"phase 4q (c) image prefix: {n} stub image embeddings + {t} "
          f"tokens at B {b}, {VLM_IMAGE_NEW} greedy tokens on the dense "
          f"cache; {differ}/{b} streams differ from the same tokens without "
          f"the prefix; the argmax head == argmax(logits_fn) at every "
          f"decided step ({flips} near-tie flips); launches a run: flash "
          f"{cfg.n_layers}, argmax {VLM_IMAGE_NEW}, paged 0", flush=True)
    check(differ > 0, "4q (c): the image prefix changed no stream")
    return dict(streams_differing=differ, rows=b, near_tie_flips=flips,
                first_tokens={k: [r[:4] for r in v] for k, v in runs.items()})


def run_vlm_spec_chunk(torch, llm, prompts, greedy, max_new) -> dict:
    """Phase 4q (b): ``spec_k=4`` (phase 4c's kind of prompts: a random
    32-token phrase repeated to each length, against spec_k 0 on them)
    and ``chunk_size=64`` (a second engine on the same weights, against
    the one-shot greedy streams), each graphed once; their bf16 tokens
    measured, not gated, as starcoder2's are (their K/V come from GEMMs
    of other widths); their launches gated."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    cfg = llm.cfg
    rng = np.random.default_rng(4)
    reps = [np.tile(rng.integers(0, cfg.vocab_size, size=32),
                    len(p) // 32 + 1)[:len(p)].astype(np.int32)
            for p in prompts]
    sp0 = SamplingParams(max_new_tokens=max_new)
    sp4 = SamplingParams(max_new_tokens=max_new, spec_k=4)
    base = drive_graphed(torch, llm, reps, sp0, "internvl2 spec_k=0")
    spec = drive_graphed(torch, llm, reps, sp4, "internvl2 spec_k=4")
    outs, _, launches, st, wall = spec[:5]
    calls = st["head_calls"]
    check(st["drafted"] > 0, "internvl2 spec_k=4: nothing was drafted")
    check(launches["fused_verify_head"] == calls.get("verify", 0) > 0,
          "internvl2 spec_k=4: verify launches != steps with a draft row")
    check(launches["paged_attention"] == cfg.n_layers * st["decode_steps"]
          and launches["flash_attention"] == cfg.n_layers * st["prefills"],
          f"internvl2 spec_k=4: attention launches {launches}")
    same_spec = compare_streams(torch, llm, reps, base[0], outs,
                                "internvl2 spec_k=4 vs spec_k=0, bf16",
                                gate=False)
    n_tok = sum(len(o.token_ids) for o in outs)
    spec_row = dict(tok_s=n_tok / wall, decode_steps=st["decode_steps"],
                    decode_steps_spec0=base[3]["decode_steps"],
                    drafted=st["drafted"], accepted=st["accepted"],
                    verify_launches=launches["fused_verify_head"],
                    identical_streams_bf16=same_spec)
    print(f"internvl2 spec_k=4: {n_tok} tokens, {st['decode_steps']} steps "
          f"(spec_k 0: {base[3]['decode_steps']}), drafted {st['drafted']}, "
          f"accepted {st['accepted']}, verify launches "
          f"{launches['fused_verify_head']}", flush=True)
    cllm = LLM(llm.engine.params, cfg, n_slots=8, max_len=1024, seed=0,
               chunk_size=64)
    run = drive_graphed(torch, cllm, prompts, sp0, "internvl2 chunk 64")
    check_chunk_launches(run[2], run[3], cfg, "internvl2 chunk 64")
    chunk_row = chunk_line("internvl2 chunk 64, graphed run 1", run, cllm)
    chunk_row["identical_streams_bf16"] = compare_streams(
        torch, llm, prompts, greedy, run[0],
        "internvl2 chunk 64 vs one-shot, bf16", gate=False)
    del cllm
    return {"spec": spec_row, "chunked": chunk_row,
            "spec_launches": launches}


def run_vlm_path(torch, max_new=32) -> tuple:
    """Phase 4q (b)-(d): internvl2-26b (the vlm family) in bf16 at full
    width (d 6,144, 48 q over 8 kv heads of 128, d_ff 16,384 SiLU-GLU, V
    92,553 untied) with VLM_LAYERS of its 48 layers (drawn on the host in
    bf16, ``weights.seeded_params(dtype=...)`` as ``LLM.from_arch`` draws
    them: no f32 master), 8 paged slots of 1,024: phase 4's first 8
    prompts (ids mod V) greedy, eager then graphed three times (the
    third all replays; tokens equal; a paged launch a layer a decode
    step, a flash a layer a prefill, an argmax head a step and a
    prefill), Theorem 1, mixed samplers, ``spec_k=4`` and
    ``chunk_size=64`` (measured); the image prefix through ``lm.prefill``
    (4q (c)); the replayed step against the bound of reading the weights
    once, tok/s, the TTFT of a 512-token prompt, the peak memory and the
    host draw's seconds.  Returns (summary, graphed run 1's launches, the
    sampled run's, the spec run's)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import dtype_of, seeded_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cut = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    llm = LLM(seeded_params(cut, 0, "cuda", dtype=dtype_of(cut)), cut,
              seed=0, n_slots=8, max_len=1024, block_size=16)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0      # the host draw, moves, the pool
    cfg, eng = llm.cfg, llm.engine
    built_peak = torch.cuda.max_memory_allocated()
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.tie_embeddings, cfg.dtype, eng.store.any_paged)
          == ("vlm", VLM_LAYERS, 6144, 48, 8, 128, 16384, 92553, False,
              "bfloat16", True),
          f"internvl2-26b is not served at full width: {cfg}")
    check(all(t.dtype == torch.bfloat16 for t in _leaves(eng.params)),
          "internvl2-26b: a leaf is not bf16 (an f32 master was kept)")
    wbytes = sum(_nbytes(t) for t in _leaves(eng.params))
    print(f"internvl2-26b: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim}, "
          f"d_ff={cfg.d_ff}, V={cfg.vocab_size} untied, {cfg.dtype}; weights "
          f"{wbytes / 1e9:.3f} GB, KV pool "
          f"{sum(_nbytes(p) for p in eng.store.pools.values()) / 1e9:.3f} GB"
          f"; the host draw in bf16, each leaf moved as it is drawn, and "
          f"the engine {built_s:.1f} s; peak {built_peak / 1e9:.3f} GB",
          flush=True)
    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, 151936, size=int(n)).astype(np.int32)
               for n in prng.integers(64, 513, size=12)]
    prompts = [p % cfg.vocab_size for p in prompts[:VLM_PROMPTS]]
    params = SamplingParams(max_new_tokens=max_new)
    llm.generate([prompts[0][:16]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()                  # warm-up (cuBLAS, allocator)
    eager, graphed = drive_both(torch, llm, prompts, params, "internvl2-26b")
    check_main_launches(eager[2], eager[3], cfg, len(prompts),
                        "internvl2-26b eager")
    check_main_launches(graphed[2], graphed[3], cfg, len(prompts),
                        "internvl2-26b graphed")
    _, again = drive_replays(torch, llm, prompts, params, "internvl2-26b",
                             graphed)
    check_main_launches(again[2], again[3], cfg, len(prompts),
                        "internvl2-26b graphed run 3")
    outs = graphed[0]
    for o in outs:
        check(1 <= len(o.token_ids) <= max_new
              and all(0 <= x < cfg.vocab_size for x in o.token_ids),
              f"internvl2-26b: bad output for rid {o.rid}: {o.token_ids}")
    summary = {
        "eager": main_line("internvl2-26b, eager", eager[0], eager[3],
                           eager[4]),
        "graph": main_line("internvl2-26b, graphed run 3 (replays only)",
                           again[0], again[3], again[4])}
    step_bytes = step_weight_bytes(eng)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    step_ms = summary["graph"]["decode_ms"]
    print(f"internvl2-26b replayed decode step: {step_ms:.3f} ms (host "
          f"wall, graphed run 3) against a bound of {bound_ms:.3f} ms (the "
          f"{step_bytes / 1e9:.3f} GB of weights a step reads, once): "
          f"{step_ms / bound_ms:.2f}x", flush=True)
    check_theorem1(torch, llm, prompts, outs, max_new,
                   what="internvl2-26b theorem 1")
    sampled_launches, summary["sampled"] = run_sampled_path(
        torch, llm, prompts, outs, max_new, what="internvl2-26b sampled")
    sc = run_vlm_spec_chunk(torch, llm, prompts, outs, max_new)
    summary["spec"], summary["chunked"] = sc["spec"], sc["chunked"]
    summary["image_prefix"] = vlm_image_prefix(torch, llm)
    long = [np.resize(prompts[0], 512).astype(np.int32)]
    ttft = []
    for _ in range(2):                         # the second is warm
        run = drive(torch, llm, long, SamplingParams(max_new_tokens=1))
        ttft.append(run[3]["ttft_ms_p50"])
    summary.update(
        step_bound_ms=bound_ms, step_weight_gb=step_bytes / 1e9,
        weights_gb=wbytes / 1e9, built_s=built_s,
        built_peak_gb=built_peak / 1e9, ttft_512_ms=ttft[-1],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        graphs=graph_line(llm))
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"internvl2-26b: TTFT of a 512-token prompt {ttft[-1]:.2f} ms "
          f"(cold {ttft[0]:.2f}); tok/s {summary['graph']['tok_s']:.2f} "
          f"(graphed run 3); peak {summary['peak_memory_gb']:.3f} GB "
          f"allocated; phase 4q (b)-(d) {summary['phase_s']:.1f} s",
          flush=True)
    return summary, graphed[2], sampled_launches, sc["spec_launches"]


def check_encdec_kernels(torch, timer) -> dict:
    """Phase 4r (a): rows 5f / 5g / 5h and 2g -- flash attention at the
    enc-dec shapes (16 / 16 heads of 64, bf16, B 8): the encoder,
    non-causal over T = S = 1,024 source frames; the cross-attention,
    non-causal, T 64 queries over S 1,024 keys; the decoder's prefill,
    causal, T 64 -- each against its plain version and SDPA; then the
    argmax head at B 8 on seamless's untied (256,206, 1,024) head (not a
    multiple of the 64-id tile) against its plain version and
    ``argmax(h @ W)``.  The first run of the kernel's non-causal route
    and of T != S in this script."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(37)
    rows = {}

    def rand(length, heads=16):
        return torch.randn((ED_B, length, heads, 64), generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    for key, t, s, causal in (("flash_enc_t1024", ED_SRC, ED_SRC, False),
                              ("flash_cross_t64_s1024", ED_T, ED_SRC, False),
                              ("flash_dec_t64", ED_T, ED_T, True)):
        q, k, v = rand(t), rand(s), rand(s)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, causal=causal)
        err = (out.float() - want.float()).abs().max().item()
        check(torch.allclose(out.float(), want.float(), atol=FA_TOL,
                             rtol=FA_TOL),
              f"flash attention {key} (causal {causal}, T {t}, S {s}) "
              f"disagrees with its plain version ({err})")
        pairs = t * (t + 1) // 2 if causal else t * s
        rows[key] = kernel_row(
            timer, lambda: fa.flash_attention(q, k, v, causal=causal),
            lambda: ref.flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
            (2 * q.numel() + k.numel() + v.numel()) * 2,
            4.0 * 64 * 16 * ED_B * pairs, err)
        model_line(ED_ARCH, f"flash_attention B={ED_B} T={t} S={s} "
                   f"causal={causal} 16/16 heads hd 64", rows[key], "sdpa")
    v, d = 256206, 1024
    w = (torch.randn((v, d), generator=gen, device="cuda")
         / math.sqrt(d)).to(torch.bfloat16).t()
    h = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    idx, val = fah.fused_argmax_head_with_value(h, w)
    torch.cuda.synchronize()
    idx_ok, val_ok, err, _ = argmax_verdict(torch, h, w, idx, val)
    check(idx_ok and val_ok, "the argmax head on seamless's untied head "
          "disagrees with its plain version")
    rows["argmax_b8"] = kernel_row(
        timer, lambda: fah.fused_argmax_head_with_value(h, w),
        lambda: ref.fused_argmax_head_with_value(h, w),
        lambda: torch.argmax(h @ w, dim=-1), v * d * 2 + 8 * d * 2 + 8 * 8,
        2.0 * 8 * d * v, err)
    model_line(ED_ARCH, f"fused_argmax_head B=8 (V, D) = ({v}, {d})",
               rows["argmax_b8"], "argmax(h @ W)")
    return rows


def encdec_decode(torch, params, cfg, toks, src, sampler, steps):
    """``lm.prefill`` over ``toks`` (B, T) and the source embeddings, then
    ``steps`` greedy ``lm.decode_step``s on the dense cache, ``sampler``'s
    head after each pass.  Returns (tokens (B, steps + 1), the hidden
    states the heads read, the launches of the prefill, of the steps)."""
    from repro_torch.models import lm

    t = toks.shape[1]
    reset_launches()
    h, cache = lm.prefill(params, cfg, toks, t + steps, src_embeds=src)
    out, hs = [sampler.head(params, cfg, h).long()], [h]
    torch.cuda.synchronize()
    first = read_launches()
    reset_launches()
    for i in range(steps):
        h, cache = lm.decode_step(params, cfg, out[-1][:, None], cache,
                                  torch.tensor(t + i, device=toks.device))
        out.append(sampler.head(params, cfg, h).long())
        hs.append(h)
    torch.cuda.synchronize()
    return torch.stack(out, 1), hs, first, read_launches()


def encdec_partings(torch, params, cfg, want, got, hs, what, gate):
    """Rows of ``got`` against ``want`` (B, steps + 1) token tables: where a
    row parts, the f32 top-2 gap of the hidden state that chose the
    token (``hs``, the run that made ``want``); with ``gate`` a parting
    must sit at a near-tie (gap <= HEAD_RTOL * |max|).  Returns the
    number of identical rows and the partings (row, step, gap, max)."""
    from repro_torch.models import lm

    same, parts = 0, []
    for r in range(want.shape[0]):
        diff = (want[r] != got[r]).nonzero()
        if diff.numel() == 0:
            same += 1
            continue
        k = int(diff[0])
        logits = lm.logits_fn(params, cfg, hs[k][r:r + 1])
        top2 = logits[0].topk(2).values
        gap, top = float(top2[0] - top2[1]), float(top2[0])
        parts.append((r, k, gap, top))
        print(f"{what}: row {r} parts at step {k}: top-2 f32 logit gap "
              f"{gap:.6g} (max {top:.6g}, {gap / abs(top):.3g} of it)",
              flush=True)
        check(not gate or gap <= HEAD_RTOL * abs(top),
              f"{what}: row {r} parts at a decided step (gap {gap})")
    print(f"{what}: {same}/{want.shape[0]} rows identical"
          + ("" if gate else " (measured, not a gate)"), flush=True)
    return same, parts


def encdec_step_profile(torch, params, cfg, tok, cache, pos,
                        steps=3) -> dict:
    """``steps`` eager ``lm.decode_step``s (each rewriting position
    ``pos``) under ``torch.profiler``: wall ms a step, the device's busy
    ms (the traced kernels' sum) and kernels a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    p = torch.tensor(pos, device="cuda")
    lm.decode_step(params, cfg, tok, cache, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.decode_step(params, cfg, tok, cache, p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"seamless decode step profile: wall {wall_ms:.3f} ms; the "
              "profiler recorded no device time (not measured)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=None, kernels_per_step=None)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    row = dict(wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
               kernels_per_step=len(kernels) / steps)
    print(f"seamless decode step profile ({steps} eager steps, profiler "
          f"on): wall {wall_ms:.3f} ms a step, device busy {busy:.3f} ms "
          f"({100 * row['busy_share']:.1f}%), "
          f"{row['kernels_per_step']:.0f} kernels a step", flush=True)
    return row


def encdec_smoke_card_vs_cpu(torch) -> dict:
    """Phase 4r (b): the smoke config in f32 (``seeded_params`` seed 0),
    ``lm.prefill`` over 16 tokens and 24 stub source frames, then 4
    ``lm.decode_step``s: the card's hidden states against the CPU's plain
    path within ED_SMOKE_TOL."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import _stub_embeds
    from repro_torch.models import lm
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config(ED_ARCH))
    host = seeded_params(cfg, 0, "cpu")
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    src = torch.from_numpy(_stub_embeds(0, 0, np.arange(2), 24,
                                        cfg.d_model))
    hs = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(host, dev)
        t = toks.to(dev)
        h, cache = lm.prefill(p, cfg, t, 21, src_embeds=src.to(dev))
        out = [h]
        for i in range(4):
            nxt = (t[:, -1:] + i + 1) % cfg.vocab_size
            h, cache = lm.decode_step(p, cfg, nxt, cache,
                                      torch.tensor(16 + i, device=dev))
            out.append(h)
        hs[dev] = torch.stack(out).cpu()
    err = float((hs["cuda"] - hs["cpu"]).abs().max())
    print(f"phase 4r (b) {cfg.name} f32: prefill + 4 decode steps, hidden "
          f"states card vs CPU max abs err {err:.3g} (limit "
          f"{ED_SMOKE_TOL})", flush=True)
    check(err <= ED_SMOKE_TOL, f"4r: the card's f32 decode hidden states "
          f"are {err} from the CPU's")
    return dict(max_abs_err=err)


def run_encdec_path(torch) -> tuple:
    """Phase 4r (b)-(c): seamless-m4t-large-v2 (the enc-dec family) at full
    width (d 1,024, 16 heads of 64, ReLU d_ff 8,192, V 256,206 untied)
    with ED_LAYERS of its 24 encoder and 24 decoder layers (f32 masters
    from ``weights.seeded_params`` on the card, served cast to bf16), no
    engine (the reference's takes token prompts only): B 8, ED_SRC stub
    source frames (``_stub_embeds``) and ED_T-token prompts,
    ``lm.prefill`` (encoder, cross K/V, decoder; a flash launch an
    encoder layer, two a decoder layer), then ED_NEW greedy
    ``lm.decode_step``s on the dense cache (no flash, one argmax head a
    step); Theorem 1 (the softmax baseline head's tokens, near-tie rule);
    an f32 twin whose tokens equal ``argmax(lm.forward)`` over its own
    stream (near-tie rule), the bf16 rows' partings from it measured;
    the smoke config's f32 hidden states card vs CPU; ms a decode step
    against reading the decoder, the head and the cross K/V once, ms of
    the encoder pass, the peak memory.  Returns (summary, the bf16 run's
    prefill launches, its decode launches)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import _stub_embeds
    from repro_torch.models import lm
    from repro_torch.serve.sampler import Greedy, SoftmaxBaseline
    from repro_torch.weights import cast_params, seeded_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(ED_ARCH), n_layers=ED_LAYERS,
                              n_encoder_layers=ED_LAYERS)
    f32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    # the f32 twin: the masters in the head kernels' layout (an untied
    # head stored (V, D) row-major, ``cast_params``); the bf16 tree its
    # cast
    masters = cast_params(seeded_params(cfg, 0, "cuda"), f32)
    params = cast_params(masters, cfg)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    check((cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model,
           cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab_size, cfg.activation, cfg.dtype)
          == ("encdec", ED_LAYERS, ED_LAYERS, 1024, 16, 16, 64, 8192,
              256206, "relu", "bfloat16"),
          f"seamless is not at full width: {cfg}")
    wbytes = sum(_nbytes(t) for t in _leaves(params))
    rng = np.random.default_rng(12)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (ED_B, ED_T)),
                           device="cuda")
    src32 = torch.as_tensor(_stub_embeds(0, 0, np.arange(ED_B), ED_SRC,
                                         cfg.d_model), device="cuda")
    src = src32.to(torch.bfloat16)
    print(f"seamless-m4t-large-v2: {cfg.n_encoder_layers} + {cfg.n_layers} "
          f"layers, d={cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim},"
          f" d_ff={cfg.d_ff} relu, V={cfg.vocab_size} untied; bf16 weights "
          f"{wbytes / 1e9:.3f} GB; drawn and cast in {built_s:.1f} s; B "
          f"{ED_B}, {ED_SRC} source frames, {ED_T}-token prompts, "
          f"{ED_NEW} decode steps", flush=True)
    encdec_decode(torch, params, cfg, toks[:, :8], src[:, :64], Greedy(), 2)
    torch.cuda.synchronize()                  # warm-up (cuBLAS, allocator)
    greedy, hs, pre, dec = encdec_decode(torch, params, cfg, toks, src,
                                         Greedy(), ED_NEW)
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    print(f"seamless bf16 greedy: launches prefill {pre}, decode {dec}",
          flush=True)
    check(pre["flash_attention"] == n_attn
          and pre["fused_argmax_head"] == 1 and pre["paged_attention"] == 0,
          f"seamless prefill launches {pre}: want flash {n_attn}")
    check(dec["flash_attention"] == 0 and dec["paged_attention"] == 0
          and dec["fused_argmax_head"] == ED_NEW,
          f"seamless decode launches {dec}: want argmax {ED_NEW}, no "
          "attention kernel")
    check(bool(((greedy >= 0) & (greedy < cfg.vocab_size)).all()),
          "seamless: a token out of the vocabulary")
    soft, _, _, _ = encdec_decode(torch, params, cfg, toks, src,
                                  SoftmaxBaseline(), ED_NEW)
    theorem1 = encdec_partings(torch, params, cfg, greedy, soft, hs,
                               "seamless theorem 1, the comparator vs the "
                               "softmax baseline", gate=True)[0]
    twin, twin_hs, _, _ = encdec_decode(torch, masters, f32, toks, src32,
                                        Greedy(), ED_NEW)
    logits, _ = lm.forward(masters, f32, torch.cat([toks, twin[:, :-1]], 1),
                           src_embeds=src32)
    fwd = logits[:, ED_T - 1:].argmax(-1)
    f32_same = encdec_partings(torch, masters, f32, twin, fwd, twin_hs,
                               "seamless f32 twin, decode vs "
                               "argmax(lm.forward)", gate=True)[0]
    del logits
    bf16_same, partings = encdec_partings(
        torch, masters, f32, twin, greedy, twin_hs,
        "seamless bf16 vs the f32 twin", gate=False)
    smoke = encdec_smoke_card_vs_cpu(torch)
    # ms a decode step (events around the ED_NEW steps, eager) and of the
    # encoder pass
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h, cache = lm.prefill(params, cfg, toks, ED_T + ED_NEW, src_embeds=src)
    tok = greedy[:, :1]
    start.record()
    for i in range(ED_NEW):
        h, cache = lm.decode_step(params, cfg, tok, cache,
                                  torch.tensor(ED_T + i, device="cuda"))
        tok = Greedy().head(params, cfg, h).long()[:, None]
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / ED_NEW
    prof = encdec_step_profile(torch, params, cfg, tok, cache,
                               ED_T + ED_NEW - 1)
    start.record()
    for _ in range(3):
        lm.encode(params, cfg, src)
    end.record()
    end.synchronize()
    enc_ms = start.elapsed_time(end) / 3
    xkv = sum(_nbytes(cache[0]["slot0"][n]) for n in ("xk", "xv"))
    dec_bytes = sum(_nbytes(t) for t in _leaves(params["decoder"])) \
        + _nbytes(params["lm_head"]) + xkv
    bound_ms = dec_bytes / HBM_BYTES_PER_S * 1e3
    enc_bytes = sum(_nbytes(t) for t in _leaves(params["encoder"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"seamless decode step (eager, B {ED_B}): {step_ms:.3f} ms "
          f"against a bound of {bound_ms:.3f} ms (the decoder, the head and "
          f"the cross K/V, {dec_bytes / 1e9:.3f} GB, of which cross K/V "
          f"{xkv / 1e9:.3f} GB, once): {step_ms / bound_ms:.2f}x; encoder "
          f"pass over {ED_B} x {ED_SRC} frames {enc_ms:.3f} ms "
          f"({enc_bytes / 1e9:.3f} GB of weights); peak {peak:.3f} GB "
          "allocated", flush=True)
    summary = dict(
        weights_gb=wbytes / 1e9, built_s=built_s, decode_ms=step_ms,
        decode_bound_ms=bound_ms, decode_bytes_gb=dec_bytes / 1e9,
        cross_kv_gb=xkv / 1e9, encoder_ms=enc_ms, peak_memory_gb=peak,
        theorem1_identical_rows=theorem1, f32_forward_identical_rows=f32_same,
        bf16_vs_f32_identical_rows=bf16_same, step_profile=prof,
        bf16_partings=[dict(row=r, step=k, gap=g, max=m)
                       for r, k, g, m in partings],
        smoke_card_vs_cpu=smoke, prefill_launches=pre,
        decode_launches=dec)
    del masters, params, cache
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 4r (b)-(c): {summary['phase_s']:.1f} s", flush=True)
    return summary, pre, dec


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device=None, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.serve import step_graph

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False

    def mark(phase):
        print(f"chip_smoke: {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    try:
        card = card_line()
        print(card, flush=True)

        t0 = time.perf_counter()
        _build.build_all()
        print(f"kernel build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(_build.KERNELS)}, nvcc {_build.nvcc_path()})",
              flush=True)

        timer = Timer(torch)
        rng = np.random.default_rng(0)
        print(clocks_line(), flush=True)
        pa_rows = check_paged_attention(torch, timer, rng)
        mode_rows = check_paged_modes(torch, timer, rng)
        pinned_rows = check_paged_modes_pinned(torch, rng)
        unpinned_rows = check_paged_modes_unpinned(
            torch, timer, np.random.default_rng(1))
        pa_routes = paged_routes(torch, rng)
        invariance = check_paged_invariance(torch, rng)
        hd192_rows = check_head_dim_192(torch, timer, rng)
        head_rows = check_argmax_head(torch, timer)
        routes = head_routes(torch)
        topk_rows = check_topk_head(torch, timer)
        topk_passes = check_topk_passes(torch)
        verify_rows = check_verify_head(torch, timer)
        head_invariance = check_head_invariance(torch)
        wide_rows = check_wide_heads(torch, timer)
        flash_rows, fa_routes = check_flash_attention(torch, timer)
        rg_route = rg_flash_route(torch)
        unit_rows = check_softmax_units(torch, timer)
        unit_invariance = check_unit_invariance(torch)
        many_errs, many_route = check_many_rows(torch)
        xent_backward = check_xent_backward_memory(torch)
        print(clocks_line(), flush=True)
        del timer
        mark("phase 3")

        max_new = 32
        prng = np.random.default_rng(0)
        prompts = [prng.integers(0, 151936, size=int(n)).astype(np.int32)
                   for n in prng.integers(64, 513, size=12)]
        llm, outs, launches, summary = run_main_path(torch, prompts,
                                                     max_new)
        topk_launches, summary["sampled"] = run_sampled_path(
            torch, llm, prompts, outs, max_new)
        verify_launches, summary["spec"], spec_base = run_spec_path(
            torch, llm, [len(p) for p in prompts], max_new)
        twin = f32_twin(torch, llm)
        cllm, summary["chunked"], chunk_launches = run_chunked_path(
            torch, llm, twin, prompts, outs, spec_base, max_new)
        one, ch = summary["graph"], summary["chunked"][
            "c64 graphed run 3, replays only"]
        print("prefill, one-shot (phase 4) against chunked c64 (phase 4g), "
              "each its graphed run 3 (replays only): " + "; ".join(
                  f"{k} {one[k]:.3f} / {ch[k]:.3f}" for k in (
                      "tok_s", "decode_ms", "ttft_ms_p50", "ttft_ms_p99",
                      "itl_ms_p99", "wall_s")), flush=True)
        summary["heavy_tail"] = run_heavy_tail(torch, llm, twin)
        summary["prefix"] = run_prefix_path(torch, llm, twin)
        del twin
        mark("phases 4-4h")
        summary["profile_eager"] = profile_decode(torch, llm, prompts,
                                                  graphed=False)
        summary["profile"] = profile_decode(torch, llm, prompts,
                                            graphed=True)
        eager_ms = summary["profile_eager"]["wall_ms"]
        graph_ms = summary["profile"]["wall_ms"]
        print(f"decode step (8 rows, profiler on): graphed {graph_ms:.3f} "
              f"ms against eager {eager_ms:.3f} ms ({eager_ms / graph_ms:.2f}"
              f"x); main path decode_ms/step graphed "
              f"{summary['graph']['decode_ms']:.3f} against eager "
              f"{summary['eager']['decode_ms']:.3f}", flush=True)
        check(graph_ms < eager_ms, "the graphed decode step is not faster "
              "than the eager one")
        for k in ("paged_kernels_per_step", "argmax_head_kernels_per_step"):
            check(summary["profile"].get(k)
                  == summary["profile_eager"].get(k),
                  f"decode profile: {k} graphed != eager")
        summary["stride"], loop, stride_launches = run_stride_path(
            torch, llm, prompts, max_new, summary["profile"])
        step = check_step_graph(torch, llm, prompts)
        step["cases"]["chunk B8 T64"] = check_chunk_bucket(torch, cllm,
                                                           prompts)
        del cllm
        unit_launches, unit_errs = run_unit_path(torch, llm, prompts, outs)
        summary["paper"], paper_launches = run_paper_path(torch)
        mark("phases 4i, 4f, 4d, 4p")
        with step_graph.eager_steps():            # the probe stays eager
            probe_runs = run_probe_path(torch, llm, prompts, max_new)
        check_theorem1(torch, llm, prompts, outs, max_new)
        del llm
        check_small_reference(torch)
        mark("phases 4e, 5, 6")
        # phase 4j: every earlier engine is dropped first, so starcoder2's
        # f32 masters and their bf16 cast (~44 GB) find the card free
        gc.collect()
        torch.cuda.empty_cache()
        timer = Timer(torch)
        # kernels 1-5 at starcoder2's shapes: 36 / 4 heads (g 9), the
        # untied (49152, 4608) head
        sc2_rows = check_model_kernels(torch, timer, "starcoder2-7b",
                                       hq=36, hkv=4, hd=128, d=4608,
                                       v=49152, seed=72)
        del timer
        summary["starcoder2_7b"], sc2_launches = run_starcoder2_path(
            torch, max_new)
        gc.collect()
        torch.cuda.empty_cache()
        summary["dense_cohort"] = run_dense_cohort(torch, max_new)
        mark("phase 4j")
        # phase 4k: tensor parallelism, its ranks in processes of their own
        gc.collect()
        torch.cuda.empty_cache()
        timer = Timer(torch)
        tp_heads = check_tp_head_shards(torch, timer)
        tp_paged = check_tp_paged_heads(torch, timer)
        t_f = time.perf_counter()
        tp_fam = check_tp_family_kernels(torch, timer)
        summary["tp_family_kernels_s"] = time.perf_counter() - t_f
        mesh_rows = check_mesh_kernels(torch, timer)
        del timer
        summary["tp"] = run_tp_path(torch)
        mark("phase 4k")
        # phase 4l: recurrentgemma-2b, on a card every earlier engine left
        gc.collect()
        torch.cuda.empty_cache()
        timer = Timer(torch)
        rg_rows = check_rg_kernels(torch, timer, rg_route)
        del timer
        summary["recurrentgemma_2b"], rg_launches = \
            run_recurrentgemma_path(torch)
        mark("phase 4l")
        # phase 4m: rwkv6-7b, on a card every earlier engine left
        gc.collect()
        torch.cuda.empty_cache()
        timer = Timer(torch)
        rw_rows = check_rwkv_kernels(torch, timer)
        del timer
        summary["rwkv6_7b"], rw_launches, rw_sampled = run_rwkv_path(torch)
        mark("phase 4m")
        # phase 4n: phi3.5-moe, on a card every earlier engine left: rows
        # 1j / 5c / 2e / 3d at its shapes (32 / 8 heads, g 4; the untied
        # (32064, 4096) head), then the served path
        gc.collect()
        torch.cuda.empty_cache()
        timer = Timer(torch)
        moe_rows = check_model_kernels(torch, timer, "phi3.5-moe", hq=32,
                                       hkv=8, hd=128, d=4096, v=32064,
                                       seed=59, paged_ts=(1,), verify=False)
        del timer
        (summary["phi35_moe"], moe_launches, moe_sampled,
         l4_launches) = run_moe_path(torch)
        mark("phase 4n")
        # phase 4o: training, on a card every earlier engine left
        gc.collect()
        torch.cuda.empty_cache()
        (summary["train"], train_rows, train_launches,
         train_serve) = run_train_phase(torch)
        summary["train"]["attention_backward"] = train_rows[
            "attention_backward"]
        mark("phase 4o")
        # phase 4s: the dry-run held to what 4o measured (host only)
        summary["dryrun"] = run_dryrun_phase(summary["train"])
        summary["train"].pop("opt_cfg")
        mark("phase 4s")
        # phase 4q: internvl2-26b, on a card every earlier engine left
        gc.collect()
        torch.cuda.empty_cache()
        t_q = time.perf_counter()
        timer = Timer(torch)
        vlm_rows = check_vlm_kernels(torch, timer)
        del timer
        (summary["internvl2_26b"], vlm_launches, vlm_sampled,
         vlm_spec) = run_vlm_path(torch)
        mark("phase 4q")
        # phase 4r: seamless-m4t-large-v2, once internvl2's engines are gone
        gc.collect()
        torch.cuda.empty_cache()
        timer = Timer(torch)
        ed_rows = check_encdec_kernels(torch, timer)
        del timer
        summary["seamless"], ed_prefill, ed_decode = run_encdec_path(torch)
        summary["phases_4q_4r_s"] = time.perf_counter() - t_q
        print(f"phases 4q + 4r: {summary['phases_4q_4r_s']:.1f} s",
              flush=True)
        mark("phase 4r")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    fam2 = summary["tp"]["tp2"]["families"]
    fam4 = summary["tp"]["tp4"]["families"]

    def mesh_launches(kernel):
        """A kernel's launches in each mesh's bf16 run on rank 0."""
        return {key: summary["tp"][f"tp{w}"]["mesh"][key]["total_launches"][
            kernel] for w in TP_WORLDS for key in (
                f"{a} {d}x{m}" for a, d, m in mesh_runs(w))}

    def fam_shards(model, kernel):
        return {str(v): {k: r[kernel][k] for k in TIMES + ("max_abs_err",)}
                for v, r in tp_fam[model].items()}

    def fam_launches(kernel, key="launches_f32"):
        return {f"{arch}_tp{w}": f[arch][key][kernel]
                for w, f in ((2, fam2), (4, fam4))
                for arch in f if arch not in ("vlm", "encdec")}

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:172",
             launches=launches["paged_attention"],
             host_stride8_launches=stride_launches["paged_attention"],
             max_abs_err=max(r["max_abs_err"] for r in [
                 *pa_rows.values(), sc2_rows["paged_t1"],
                 sc2_rows["paged_t64"], moe_rows["paged_t1"],
                 vlm_rows["paged_t1"]]),
             **{k: pa_rows[1][k] for k in TIMES + ("chunks",)},
             single_row={k: pa_rows["B1"][k] for k in TIMES + ("chunks",)},
             t64={k: pa_rows[64][k] for k in TIMES + ("chunks",)},
             t4={k: pa_rows[4][k] for k in TIMES + ("chunks",)},
             t32={k: pa_rows[32][k] for k in TIMES + ("chunks",)},
             routes=pa_routes, invariance=invariance,
             starcoder2_launches=sc2_launches["paged_attention"],
             recurrentgemma_launches=rg_launches["paged_attention"],
             rwkv6_launches=rw_launches["paged_attention"],
             phi35_moe_launches=moe_launches["paged_attention"],
             llama4_smoke_launches=l4_launches["paged_attention"],
             tp_moe_launches=summary["tp"]["tp2"]["moe"]["launches"][
                 "paged_attention"],
             phi35_moe_t1_g4={k: moe_rows["paged_t1"][k]
                              for k in TIMES + ("chunks", "max_abs_err")},
             internvl2_launches=vlm_launches["paged_attention"],
             internvl2_t1_g6={k: vlm_rows["paged_t1"][k]
                              for k in TIMES + ("chunks", "max_abs_err")},
             tp_router_launches=summary["tp"]["tp4"]["router"]["launches"][
                 "paged_attention"],
             tp_http_launches=summary["tp"]["tp2"]["http"]["launches"][
                 "paged_attention"],
             train_serve_launches=train_serve["reduced"]["paged_attention"],
             starcoder2_t1={k: sc2_rows["paged_t1"][k]
                            for k in TIMES + ("chunks", "max_abs_err")},
             starcoder2_t64={k: sc2_rows["paged_t64"][k]
                             for k in TIMES + ("chunks", "max_abs_err")},
             hd192={k: v for k, v in hd192_rows.items()
                    if k.startswith("paged")},
             tp_rank_heads_t1={str(tp): {k: row[k] for k in TIMES + (
                 "chunks", "max_abs_err")} for tp, row in tp_paged.items()},
             tp_launches={str(w): summary["tp"][f"tp{w}"]["launches"][
                 "greedy_bf16"]["paged_attention"] for w in TP_WORLDS},
             tp_vlm_smoke_launches=fam2["vlm"]["launches"][
                 "paged_attention"],
             modes={mode: dict(
                 launches=probe_runs[None]["launches_by_mode"][mode],
                 max_abs_err=max(r["max_abs_err"] for (m, _, _), r
                                 in mode_rows.items() if m == mode),
                 pinned_max_abs_err=max(
                     (r["max_abs_err"] for (m, _, _), r
                      in pinned_rows.items() if m == mode), default=None),
                 **{k: mode_rows[(mode, 1, None)][k]
                    for k in TIMES + ("passes",)},
                 t4_window128={k: mode_rows[(mode, 4, 128)][k]
                               for k in TIMES},
                 **({} if mode not in ("exact", "base2", "pwl") else dict(
                     unpinned_f32_max_abs_err=max(
                         r["max_abs_err"] for (m, _, _), r
                         in unpinned_rows.items() if m == mode),
                     f32={k: unpinned_rows[(mode, 1, None)][k]
                          for k in ("ms", "device_ms", "host_ms")})))
                 for mode in ("exact", "base2", "pseudo", "pwl",
                              "maxonly")}),
        dict(name="paged_attention.chunk_t64", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:172",
             launches=chunk_launches["paged_attention"],
             max_abs_err=pa_rows[64]["max_abs_err"],
             **{k: pa_rows[64][k] for k in TIMES + ("chunks",
                                                    "scratch_mb")}),
        dict(name="fused_argmax_head", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_argmax_head.cu",
             replaces="src/repro/kernels/fused_argmax_head.py:75",
             launches=launches["fused_argmax_head"],
             host_stride8_launches=stride_launches["fused_argmax_head"],
             max_abs_err=max(r["max_abs_err"] for r in [
                 *head_rows.values(), wide_rows["argmax_B1"],
                 wide_rows["argmax_B8"], sc2_rows["argmax_b8"],
                 rg_rows["argmax_b8"], rw_rows["argmax_b8"],
                 moe_rows["argmax_b8"], vlm_rows["argmax_b8"],
                 ed_rows["argmax_b8"],
                 *(r["argmax_b8"] for m in ("rwkv6", "recurrentgemma")
                   for r in tp_fam[m].values())]),
             **{k: head_rows[8][k] for k in TIMES},
             b1={k: head_rows[1][k] for k in TIMES},
             b64={k: head_rows[64][k] for k in TIMES},
             routes={k: v for k, v in routes.items()
                     if k.startswith("argmax")},
             invariance=head_invariance,
             d18432={k: v for k, v in wide_rows.items()
                     if k.startswith("argmax")},
             starcoder2_launches=sc2_launches["fused_argmax_head"],
             tp_shards_b8={str(v): {k: r["argmax_b8"][k]
                                    for k in TIMES + ("max_abs_err",)}
                           for v, r in tp_heads.items()},
             tp_launches={str(w): summary["tp"][f"tp{w}"]["launches"][
                 "greedy_bf16"]["fused_argmax_head"] for w in TP_WORLDS},
             tp_rwkv6_shards_b8=fam_shards("rwkv6", "argmax_b8"),
             tp_recurrentgemma_shards_b8=fam_shards("recurrentgemma",
                                                    "argmax_b8"),
             tp_family_launches=fam_launches("fused_argmax_head",
                                             "launches_bf16"),
             tp_vlm_prefix_launches=fam2["vlm"]["prefix_launches"][
                 "fused_argmax_head"],
             starcoder2_untied_b8={k: sc2_rows["argmax_b8"][k]
                                   for k in TIMES + ("max_abs_err",)},
             recurrentgemma_launches=rg_launches["fused_argmax_head"],
             recurrentgemma_tied_b8={k: rg_rows["argmax_b8"][k]
                                     for k in TIMES + ("max_abs_err",)},
             rwkv6_launches=rw_launches["fused_argmax_head"],
             rwkv6_untied_b8={k: rw_rows["argmax_b8"][k]
                              for k in TIMES + ("max_abs_err",)},
             phi35_moe_launches=moe_launches["fused_argmax_head"],
             phi35_moe_untied_b8={k: moe_rows["argmax_b8"][k]
                                  for k in TIMES + ("max_abs_err",)},
             internvl2_launches=vlm_launches["fused_argmax_head"],
             internvl2_untied_b8={k: vlm_rows["argmax_b8"][k]
                                  for k in TIMES + ("max_abs_err",)},
             seamless_prefill_launches=ed_prefill["fused_argmax_head"],
             seamless_decode_launches=ed_decode["fused_argmax_head"],
             seamless_untied_b8={k: ed_rows["argmax_b8"][k]
                                 for k in TIMES + ("max_abs_err",)},
             tp_router_launches=summary["tp"]["tp4"]["router"]["launches"][
                 "fused_argmax_head"],
             tp_http_launches=summary["tp"]["tp2"]["http"]["launches"][
                 "fused_argmax_head"],
             train_serve_launches=train_serve["reduced"][
                 "fused_argmax_head"]),
        dict(name="fused_topk_head", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_topk_head.cu",
             replaces="src/repro/kernels/fused_topk_head.py:107",
             launches=topk_launches["fused_topk_head"],
             max_abs_err=max(r["max_abs_err"] for r in [
                 *topk_rows.values(), wide_rows["topk_B8_k8"],
                 sc2_rows["topk_b4_k8"], rw_rows["topk_b4_k8"],
                 moe_rows["topk_b4_k8"], vlm_rows["topk_b4_k8"],
                 *(r["topk_b4_k8"] for m in ("rwkv6", "recurrentgemma")
                   for r in tp_fam[m].values())]),
             **{k: topk_rows[(4, 8)][k] for k in TIMES},
             k64={k: topk_rows[(4, 64)][k] for k in TIMES},
             passes=topk_passes, d18432=wide_rows["topk_B8_k8"],
             tp_shards_b4_k8={str(v): {k: r["topk_b4_k8"][k]
                                       for k in TIMES + ("max_abs_err",)}
                              for v, r in tp_heads.items()},
             tp_launches={str(w): summary["tp"][f"tp{w}"]["launches"][
                 "mixed_f32"]["fused_topk_head"] for w in TP_WORLDS},
             tp_rwkv6_shards_b4_k8=fam_shards("rwkv6", "topk_b4_k8"),
             tp_recurrentgemma_shards_b4_k8=fam_shards("recurrentgemma",
                                                       "topk_b4_k8"),
             tp_family_launches=fam_launches("fused_topk_head"),
             starcoder2_untied_b4_k8={k: sc2_rows["topk_b4_k8"][k]
                                      for k in TIMES + ("max_abs_err",)},
             rwkv6_sampled_launches=rw_sampled["fused_topk_head"],
             rwkv6_untied_b4_k8={k: rw_rows["topk_b4_k8"][k]
                                 for k in TIMES + ("max_abs_err",)},
             phi35_moe_sampled_launches=moe_sampled["fused_topk_head"],
             phi35_moe_untied_b4_k8={k: moe_rows["topk_b4_k8"][k]
                                     for k in TIMES + ("max_abs_err",)},
             internvl2_sampled_launches=vlm_sampled["fused_topk_head"],
             internvl2_untied_b4_k8={k: vlm_rows["topk_b4_k8"][k]
                                     for k in TIMES + ("max_abs_err",)}),
        dict(name="fused_verify_head", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_argmax_head.cu",
             replaces="src/repro/kernels/fused_topk_head.py:170",
             launches=verify_launches["fused_verify_head"],
             max_abs_err=max(r["max_abs_err"] for r in verify_rows.values()),
             **{k: verify_rows[(8, 8)][k] for k in TIMES},
             t2={k: verify_rows[(8, 2)][k] for k in TIMES},
             t32_b1={k: verify_rows[(1, 32)][k] for k in TIMES},
             t32={k: verify_rows[(8, 32)][k] for k in TIMES},
             routes={k: v for k, v in routes.items()
                     if k.startswith("verify")},
             d18432=wide_rows["verify_B8_T8"],
             tp_shards_b8_t8={str(v): {k: r["verify_b8_t8"][k]
                                       for k in TIMES}
                              for v, r in tp_heads.items()},
             tp_launches={str(w): summary["tp"][f"tp{w}"]["launches"][
                 "spec4_f32"]["fused_verify_head"] for w in TP_WORLDS},
             starcoder2_untied_b8_t8={k: sc2_rows["verify_b8_t8"][k]
                                      for k in TIMES},
             rwkv6_launches=rw_launches["fused_verify_head"],
             phi35_moe_launches=moe_launches["fused_verify_head"],
             internvl2_spec_launches=vlm_spec["fused_verify_head"],
             internvl2_untied_b8_t5={k: vlm_rows["verify_b8_t5"][k]
                                     for k in TIMES}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:76",
             launches=launches["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in [
                 *flash_rows.values(), sc2_rows["flash_t512_g9"],
                 rg_rows["flash_t2150_g10_hd256"],
                 moe_rows["flash_t512_g4"],
                 train_rows["flash_t4096_b2_g2"],
                 *(mesh_rows[f[0]] for f in MESH_FLASH),
                 vlm_rows["flash_t768_g6"], tp_fam["flash_g5"],
                 *(ed_rows[k] for k in ("flash_enc_t1024",
                                        "flash_cross_t64_s1024",
                                        "flash_dec_t64"))]),
             train_launches=train_launches["flash_attention"],
             train_launches_per_step=summary["train"]["launches_per_step"][
                 "flash_attention"],
             train_t4096_b2_g2={k: train_rows["flash_t4096_b2_g2"][k]
                                for k in TIMES + ("max_abs_err",)},
             mesh_train_launches=mesh_launches("flash_attention"),
             **{f"mesh_{f[0][6:]}": {k: mesh_rows[f[0]][k]
                                     for k in TIMES + ("max_abs_err",)}
                for f in MESH_FLASH},
             **{k: flash_rows["T512"][k] for k in TIMES},
             g8={k: flash_rows["T512_g8"][k] for k in TIMES},
             hd192={k: v for k, v in hd192_rows.items()
                    if k.startswith("flash")},
             routes=fa_routes,
             tp_launches={str(w): summary["tp"][f"tp{w}"]["launches"][
                 "greedy_bf16"]["flash_attention"] for w in TP_WORLDS},
             tp_recurrentgemma_t2150_g5_hd256_w2048={
                 k: tp_fam["flash_g5"][k] for k in TIMES + ("max_abs_err",)},
             tp_family_launches=fam_launches("flash_attention",
                                             "launches_bf16"),
             tp_vlm_prefix_launches=fam2["vlm"]["prefix_launches"][
                 "flash_attention"],
             starcoder2_launches=sc2_launches["flash_attention"],
             starcoder2_t512_g9={k: sc2_rows["flash_t512_g9"][k]
                                 for k in TIMES + ("max_abs_err",)},
             recurrentgemma_launches=rg_launches["flash_attention"],
             rwkv6_launches=rw_launches["flash_attention"],
             phi35_moe_launches=moe_launches["flash_attention"],
             phi35_moe_t512_g4={k: moe_rows["flash_t512_g4"][k]
                                for k in TIMES + ("max_abs_err",)},
             recurrentgemma_t2150_g10_hd256_w2048={
                 k: rg_rows["flash_t2150_g10_hd256"][k]
                 for k in TIMES + ("max_abs_err", "route")},
             internvl2_launches=vlm_launches["flash_attention"],
             internvl2_t768_g6={k: vlm_rows["flash_t768_g6"][k]
                                for k in TIMES + ("max_abs_err",)},
             seamless_prefill_launches=ed_prefill["flash_attention"],
             seamless_decode_launches=ed_decode["flash_attention"],
             **{f"seamless_{k[6:]}": {n: ed_rows[k][n]
                                      for n in TIMES + ("max_abs_err",)}
                for k in ("flash_enc_t1024", "flash_cross_t64_s1024",
                          "flash_dec_t64")}),
        dict(name="step_graph", route="cuda",
             source="src/repro_torch/serve/step_graph.py",
             replaces="src/repro/serve/engine.py:164",
             launches=summary["graph_first_run"]["replays"],
             max_abs_err=max(c["max_abs_err"]
                             for c in step["cases"].values()),
             **{k: step["cases"]["greedy B8 T1"][k] for k in (
                 "ms", "device_ms", "host_ms", "plain_ms",
                 "plain_device_ms", "plain_host_ms", "bound_ms",
                 "bound_by")},
             **NO_LIBRARY, cases=step["cases"],
             captures_first_run=summary["graph_first_run"]["captures"],
             temperature_head=step["temperature_head"]),
        dict(name="decode_loop", route="cuda",
             source="src/repro_torch/serve/step_graph.py",
             replaces="src/repro/serve/engine.py:238",
             launches=loop["launches"], max_abs_err=loop["max_abs_err"],
             **{k: loop[k] for k in (
                 "ms", "device_ms", "host_ms", "plain_ms",
                 "plain_device_ms", "plain_host_ms", "bound_ms",
                 "bound_by", "steps")},
             **NO_LIBRARY,
             keyed_draw=summary["stride"]["keyed_draw"]),
    ]
    # each unit kernel's rows at the mesh steps' shapes
    mesh_keys = {"fused_xent": list(MESH_XENT),
                 **{n: [f"{n}_{t}" for t in MESH_SLICES]
                    for n in ("softmax_stats", "online_softmax")}}
    for name, replaces in (
            ("fused_xent", "src/repro/kernels/fused_xent.py:59"),
            ("softmax_stats", "src/repro/kernels/online_softmax.py:69"),
            ("online_softmax", "src/repro/kernels/online_softmax.py:106")):
        sizes = (12, 512) if name == "online_softmax" else (12, 512, 4096)
        plans = {b: unit_rows[(name, b)]["plan"] for b in sizes}
        entry = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/online_softmax.cu",
            replaces=replaces, launches=unit_launches[name],
            paper_launches=paper_launches[name],
            max_abs_err=max(unit_errs[name], many_errs[name],
                            train_rows[f"{name}_b8192_f32"]["max_abs_err"],
                            *(mesh_rows[k]["max_abs_err"]
                              for k in mesh_keys[name]),
                            *(unit_rows[(name, b)]["max_abs_err"]
                              for b in sizes)),
            train_launches=train_launches[name],
            mesh_train_launches=mesh_launches(name),
            **{f"mesh_{key}": {k: mesh_rows[key][k]
                               for k in TIMES + ("max_abs_err",)}
               for key in mesh_keys[name]},
            train_b8192_f32={k: train_rows[f"{name}_b8192_f32"][k]
                             for k in TIMES + ("max_abs_err",)},
            **{k: unit_rows[(name, 12)][k] for k in TIMES},
            b512_bf16={k: unit_rows[(name, 512)][k] for k in TIMES},
            plan=plans[12], b512_bf16_plan=plans[512],
            launch_floor=unit_rows["floor"], invariance=unit_invariance)
        if name != "online_softmax":
            entry["b4096_bf16"] = {k: unit_rows[(name, 4096)][k]
                                   for k in TIMES + ("split_max_abs_err",)}
            entry["device_kernels_per_call"] = {
                **{f"B{b}": plans[b]["device_kernels_per_call"][name]
                   for b in sizes},
                "B70000": many_route["device_kernels_per_call"][name]}
        if name == "fused_xent":
            entry["backward_b4096_bf16"] = xent_backward
        kernels.append(entry)
    summary["probe"] = {
        str(w): {v: {k: row[k] for k in ("divergence",
                                         "mean_first_divergence")}
                 | {"worst_score_error": max(row["score_error"].values())}
                 for v, row in r["report"]["variants"].items()
                 if v != "exact"}
        for w, r in probe_runs.items()}
    print("main path summary: " + json.dumps(summary), flush=True)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s (build "
          "included)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--tp-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        sys.exit(tp_rank_main(int(args["--tp-rank"]),
                              int(args["--tp-world"]), args["--tp-dir"]))
    sys.exit(main())
