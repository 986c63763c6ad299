#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA H100.

  python3 chip_smoke.py [--seed N]

Imports torch, numpy and ``repro_torch`` (from ``src/`` beside this file);
never jax, never the JAX package. Phases, each fatal on failure:

1. device: the card's name and power limit, torch/CUDA versions, the
   dry-run's ``HBM_BYTES`` beside the card's ``total_memory``, and the
   kernels built from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a,
   one nvcc per source or part of one, in parallel); the bf16 bodies of
   K5 and K4, at every exact and padded width (the
   tensor-core tile core ``attention_tc.cuh``) and of K6
   (``ssd_scan_tc_kernel``) must hold HMMA instructions in their SASS
   (``cuobjdump``) and spill nothing (``ptxas -v``);
2. kernels: K1/K2 (fused token log-prob forward and backward) at the
   learner's microbatch shape (T 8184 = 8 x 1023, V 152064, float32), at a
   ragged (77, 1001) in bfloat16 with out-of-range target ids, and K1 at
   T x V > 2^31 (T 16368, the sampler-logp recompute), K2 held element
   by element with controls that the bound must reject; K3 (paged decode)
   and K4 (paged prefill) at the serving slice's shapes (bf16, Hq 16, Hkv 8, D 128, page 16, 8 slots up to 2048
   tokens with a dead slot and a NaN scratch page, and K3 on one slot of
   8192 keys, also timed by its device time in a profiler trace, since
   its host call outlasts it; prefill C = 512, a ragged C = 77, and the
   spec engine's verify windows, 8 slots of C = 2, 3, 5 rows after
   300-1000 keys with NaN past each window; one window + softcap case
   each), each held against its plain
   PyTorch twin (float32 on the same inputs) and timed beside the twin, a
   library yardstick (SDPA over the gathered dense view, which the port
   never calls) and the card's bound, K4 at C = 512 also in float32 (its
   CUDA-core body); K5 (dense flash attention) at six cases: the static
   engine's prefill (B 16, S 832) and the recompute (S 1023) of
   qwen3-1.7b, a Gemma2-9B local (window 4096, softcap 50) and global
   layer (B 1, S 8192, D 256), a bidir float32 case at S 37 and a bf16
   case at D 64, S 160, each against its twin, with controls showing that
   the check sees a dropped window or softcap, the first four timed, the
   first also in float32 (the CUDA-core body, held at 2e-5);
   K6 (the Mamba2 SSD chunk scan; bf16 on the tensor cores, float32 in
   three chunk-parallel steps on the CUDA cores) at mamba2-1.3b's
   recompute shape (B 16, S 1024, H 64, P 64, N 128, chunk 256) in bf16
   and float32, at B 1, S 8192 in bf16, and a float32 case with two B/C
   groups, each against its twin element by element, with a control (the
   twin without the state carried across chunks) that the check must
   reject, the three mamba2 cases timed, the float32 one by step (no
   PyTorch call computes an SSD scan, so K6 has no library yardstick);
   draws: the threefry token draw (``sampling/prng.py``, plain torch) at
   8 and 40 rows of the padded vocab 152064 on the card against the CPU
   (keys, bits and uniforms bit for bit, Gumbel noise within NOISE_ULPS,
   tokens equal on every row), one 8-row draw timed and its launches
   counted;
3. engine: qwen3-1.7b at full width (28 layers, bf16, random weights from
   --seed) served through ``ContinuousEngine`` with
   ``paged_attn_impl="pallas"``: 24 requests, 4 sharing a 256-token
   prefix; every request finishes, the page pool balances, and the launch
   counters show both kernels on the path (28 per decode step and per
   prefill chunk), and the draw's share of a decode step; the
   launch-shape sentinel (``analysis.sentinel``) open over the rounds
   counts the new launch shapes, at most ``executable_bound`` of the
   engine's pages a slot; then a
   teacher-forced prefill + 8 decode steps through "pallas" and "ref" on
   copies of one pool, logits within a stated tolerance; last, a torch.profiler trace of 24 decode steps (device
   time by kernel, device busy share);
4. static: qwen3-1.7b at full width with ``attn_impl="pallas"`` through
   ``StaticEngine`` (the sampler node's default engine) at the learner's
   rollout shape, 16 requests of 832 tokens, 192 new, temperature 1.0:
   K5 launches once per layer for the prefill and nothing else; then
   ``token_logps`` over the 16 x 1024 result through K5 and through the
   chunked attention in turns, logps held against each other and
   against the sampler's;
5. gemma2: gemma2-9b at full width (42 layers, bf16, random weights):
   ``token_logps`` at 1 x 8192 through K5 (42 launches, 21 local and 21
   global) against the chunked attention, and a greedy static generation
   of 2 requests of 4608 prompt tokens (past the window) + 16 new, whose
   logps the teacher-forced forward must reproduce, and again with
   ``local_ring_kv`` (the local layers' cache a ring of the window's 4096
   rows, which ``fill_ring`` wraps), held to the non-ring run (tokens up
   to the first top-2 gap under TOL_GAP, logps within TOL_LOGP_RING)
   with the cache bytes and the peak memory printed; then the same weights
   in float32, K5 against the chunked attention at 1e-3 nats; the weights
   are freed;
6. mamba2: mamba2-1.3b at full width (48 Mamba2 layers, bf16, random
   weights) through ``StaticEngine`` at the learner's rollout shape (16 x
   832 + 192 new, temperature 1.0; no kernel on that path: the prefill
   fills a cache through the chunked SSD, decode is the recurrence), a
   profile of its decode steps, then ``token_logps`` over the 16 x 1024
   result through K6 (``ssd_impl="pallas"``, 48 launches) and through the
   chunked SSD in turns, held against each other and against the
   sampler's logps, a profile of one K6 recompute, K6 against the
   model's chunked SSD on the inputs the recompute hands K6 in its first
   and last layer (with a control, K6 launched chunk by chunk from a zero
   state, that the check must reject), and again with the same weights in
   float32 at 5e-3 nats (three runs of each route in turns, timed); the
   weights are freed;
7. learner: one GEPO iteration on qwen3-1.7b at full width (bf16, random
   weights from --seed): ``generate_continuous`` makes 2 prompts x group 8
   rows of 832 prompt + 192 new tokens (temperature 1.0), ``token_logps``
   recomputes the sampler log-probs (App. B.1, K1 over T 16368), the batch
   is assembled as hetero/nodes.py does, ``rl_loss_fn`` forward and
   backward runs once through K1/K2 and once through the twin on the same
   microbatch (loss, metrics, gradient norm and the lm_head gradient in
   float32 held to stated tolerances), for GEPO as trained and again with
   an entropy bonus (so K2's g_ent term is live), then 3 ``train_step``s
   (GEPO, grad_accum 2, AdamW) with finite metrics, the launch counters
   showing K1 2 per step
   + 1 for the recompute and K2 2 per step, and the rollout's K3/K4 28
   per decode step and per prefill chunk; last, a torch.profiler trace of
   a fourth step (device time by kernel, device busy share).
8. hetero: the HeteroRL loop on qwen3-1.7b at full width and
   LOOP_LAYERS of its 28 layers (bf16, random weights from --seed, the
   chunked attention with remat) through its
   entry points: ``sft_warmstart`` (2 steps of 8 x 840 tokens through
   K1/K2), then ``HeteroRuntime.run(4)`` with 2 sampler nodes serving
   ``ArithmeticTask`` prompts (832 wide, groups of 8, 2 prompts a batch,
   192 new tokens, temperature 1.0) through ``ContinuousEngine`` (K3/K4)
   and recomputing their log-probs through K1, a learner stepping GEPO
   (grad_accum 2) through K1/K2 and publishing every step through the
   chunked transport, at the paper's 60 s median sync delay, so samplers
   sync inside the run: each in-run sync gives the published version's
   params bit for bit, and every batch a node makes after a sync carries
   that version's stamp; staleness in (0, 64], finite metrics, the launch
   counts the run implies (K3/K4 a layer's launch per decode step and
   prefill chunk, K1 1 per sampler batch + 2 per learner step, K2 2 per learner step), each
   sampler's sync to the newest version equal to the learner's weights
   and a fresh subscriber's bit-exact; then ``run_online(2)`` through the
   static engine within tests/test_system.py's thresholds (staleness 0,
   kl < 0.3, |iw_mean - 1| < 0.5). It prints the host seconds of every
   publish, sync, sampler batch and learner step, one publish's D2H, hash
   and store times apart, the peak device memory and the host's peak RSS.
9. spec: speculative decoding through ``ContinuousEngine`` on qwen3-1.7b
   at full width and SPEC_LAYERS of its 28 layers (bf16, random weights
   from --seed, K3/K4 ``"pallas"``, 8
   slots, page 16, prefill chunk 512): (a) 16 greedy requests whose
   prompts repeat a short token pattern, 128 new, and (b) the engine
   phase's 24 requests, 64 new, temperature 0.6 / top-k 20 / top-p 0.95,
   each with spec_k 0 and spec_k 4 (the n-gram drafter). Every request
   finishes and the page pool balances, with the prefix cache's pages
   and after it is emptied; the folded K4 rescore equals the forward's
   attention exactly on every verify round; the launches are what the run
   implies (K4 a layer's per verify round + 1 per rescore + a layer's per
   prefill chunk, K3 a layer's per fallback decode step); (a) accepts
   drafts; every
   emitted logp equals the teacher-forced forward's within
   TOL_LOGP_PATHS; greedy spec tokens equal the non-spec tokens up to the
   first position where the non-spec sequence's top-2 logit gap is under
   TOL_GAP ((b) samples through top-k and top-p, whose cut-offs a bf16
   path moves, so (b) is held by the logp contract alone); then (a) again
   with the weights in float32 (TOL_LOGP_F32, its own TOL_GAP), greedy
   and sampled at temperature 1 with no top-k or top-p, where the rule
   takes the top-2 gap of logits + the draw's threefry Gumbel noise (key
   ``fold_in(fold_in(key, rid), g)``) and so holds the verify round's
   draw keys. The folded K4 launch of the rescore (one
   launch over every layer's pools, page ids up to layers x 1537) at the
   verify shape is held against each layer's twin in bf16 and float32 and
   against the per-layer launches bit for bit, and timed against them. It
   prints decode tokens/s, ms per decode step and the accept rate of
   every run;
10. threads: ``ThreadedHeteroRuntime.run(4)`` on the hetero phase's model,
   task and warm start, 2 sampler threads at spec_k 4 and the learner on
   one card, the clock scaled so that 60 simulated seconds are one of
   phase 8's learner steps: 4 steps, staleness <= 64, finite metrics, at
   least one sampler sync inside the run, every sampler thread ended
   within THREAD_JOIN_S, and the exact launch counts of all three
   threads; it prints the peak device memory;
11. door: ``repro_torch.serving.server.FrontDoor`` on 127.0.0.1 (port 0)
   over the serve cell's engine (qwen3-1.7b, bf16, K3/K4 ``"pallas"``, 8
   slots, page 16, prefill chunk 512): the serve cell's 24 prompts,
   DOOR_NEW new, temperature 0.6 / top-k 20 / top-p 0.95, sent at once as 12 POST
   /generate, 8 NDJSON streams and 4 requests on one websocket, plus an
   infeasible request (400) and one with a 1e-6 s deadline (408); a
   scrape of /healthz and /metrics while they decode; every request
   answered, each stream's events equal to its result, /metrics (JSON
   and Prometheus text) counting 24 completions and the two rejects, the
   pool balanced, the launches 28 per decode step and prefill chunk; the
   tokens equal ``engine.generate``'s on a fresh engine with the same key
   and the door's rids at every position both runs computed from the same
   bits (all before the first position whose token or logp differs, and
   that one when it is past the first or the prefix-cache hits are
   equal), every logp within
   TOL_LOGP_PATHS of the teacher-forced forward; it prints TTFT
   p50/p99 and tokens/s through the door against ``engine.generate``.
12. families: the decoder-only families left on one card, one model at a
   time (bf16, random weights from --seed, full width; depth cuts in
   DENSE_DEPTH, SCOUT_LAYERS, MAVERICK_LAYERS). First K3/K4 at each
   family's GQA group (rep 2, 7, 1 at Hkv 40, 5), K5 at rep 5 and K1/K2
   at the learners' vocabularies (202240, 50432), each against its twin
   and timed beside it, the bound and the library call. (a) internlm2-1.8b
   (12/24 layers), qwen2-7b (14/28) and qwen1.5-32b (16/64) through
   ``ContinuousEngine`` (K3/K4, 8 slots, page 16, prefill chunk 512): 8
   requests of 64-1024 tokens, 32 new, the serve profile; the launches the
   run implies; logps against the teacher-forced forward and through one
   ``token_logps`` recompute (K1), the mean within TOL_LOGP_MEAN_BF16, and
   again with float32 weights (qwen1.5-32b at 8 layers) every token
   within TOL_LOGP_F32. (b) llama4-scout (float32 at 2 layers; bf16 at
   4/48) and llama4-maverick (one period of 2, 128 experts) serving the
   serve cell's 24 requests, MOE_NEW new, through K3/K4 and through the
   twins
   with the same key: float32 tokens equal and logps within TOL_LOGP_F32,
   bf16 the mean |dlogp| before each request's first differing token
   within TOL_LOGP_MEAN_BF16; ``moe_drop_frac`` by forward kind and the
   gap between the sampler's logps and the App. B.1 recompute printed.
   (c) GEPO on scout at 1 layer (B 8 x S 512) and (d) on mamba2-1.3b
   (48 layers, B 8 x S 1024, the chunked SSD's autograd), ``grad_accum``
   2, AdamW: K1/K2 against the twin through one ``rl_loss_fn`` forward and
   backward (the learner phase's bars, the lm_head gradient in float32
   within 1e-4), then 3 ``train_step``s with finite metrics (``moe_*``
   present on scout) and the launches they imply; step ms and peak GiB.
13. memory: the modality-memory families, one model at a time (bf16,
   random weights from --seed, full width; depth cuts in VLM_F32_LAYERS
   and VLM_LEARN_LAYERS). (a) K5 non-causal at Sq != Sk, the shapes the
   cross-attention and the encoder give it (the VLM's rep 4, D 128 at Sq
   1 and 832 against 1601 memory rows; Whisper's rep 1, D 64 bidir at S
   1500 and at Sq 1 and 192 against 1500), bf16 and float32, each against
   its twin, with a control (the twin over Sk - 1 keys) the check must
   reject, timed beside the twin, SDPA and the bound; K1/K2 at the
   learners' vocabularies (128256, 51968). (b) llama-3.2-vision-11b at
   40/40 layers through ``build_engine(engine="static", memory=)`` under
   ``attn_impl="pallas"`` with launch/serve.py's 0.02 N(0, 1) stub memory
   (8, 1601, 4096): 8 requests of 64-832 tokens left-padded to 832, 64
   new, the serve profile; K5 launches held to what the run implies (every
   self- and cross-attention in the prefill, every cross-attention in each
   decode step); the App. B.1 recompute (``token_logps(memory=)``) through
   K5 and K1 against the chunked attention and against the sampler, the
   means within TOL_LOGP_MEAN_BF16; then a float32 pair at one period (5
   layers, an N(0, 1) memory): greedy engine logps and the K5 recompute
   within TOL_LOGP_F32 of the chunked recompute, and a control (the
   memory zeroed) that misses that bar. (c) whisper-small whole:
   ``encode`` over (8, 1500, 768) N(0, 1) frames through K5 (bidir)
   against the chunked attention, then the static engine and the
   recompute as in (b), in bf16 and as a float32 pair. (d) GEPO learners,
   ``grad_accum`` 2, 3 steps, ``attn_impl="chunked"``, K1/K2 against the
   twin (the learner phase's bars): Whisper whole with ``frames`` in the
   batch and the VLM at 5 layers with ``image_embeds`` (B 8 x S 512); step
   ms and peak GiB. (e) jamba's full-width pieces: K6 at its SSM layer (B
   1 x S 4096, 256 heads, P 64, N 128) against its twin, and one MoE
   layer (E 16 top-2, d 8192, f 24576) on the card against the CPU on the
   same inputs, drops equal.
14. sharded: the learner through ``repro_torch.parallel``. (a) A 1x1 mesh
   of a one-rank NCCL group (every collective runs): 3 steps of
   ``make_sharded_train_step`` on qwen3-1.7b (bf16, B 16 x S 1024,
   ``grad_accum`` 2, AdamW) against ``train_step`` from the same state and
   batch, bit for bit, both step times and K1/K2 launch counts printed and
   equal. (b) Two rank processes on the one card over gloo with CUDA
   tensors (NCCL refuses two ranks on one device; ``--rank``), the
   2x1 ``train_fsdp`` and 1x2 ``train`` plans: a float32 pair at
   SHARD_F32_LAYERS of 28 layers (B 8 x S 1024, ``grad_accum`` 2) held
   against the one-device step at the parity bars of
   tests/test_parallel_parity.py, a control (the wrong microbatch order)
   that must miss them, and one bf16 step at SHARD_BF16_LAYERS of 28
   layers (B 8 x S 1024) for
   its ms and peak GiB per rank. (c) One llama4-scout MoE layer at full
   width (E 16 top-1, d 5120, f 8192, shared expert; float32) through
   ``moe_ep="train"`` on the 1x2 mesh against ``models/moe.py`` on one
   rank, at a capacity that drops nothing, drop fractions printed.
15. serve plan: ``ContinuousEngine`` on ``serve`` ``ExecutionPlan``s
   (tensor-parallel over 'model', slots over 'data'), qwen3-1.7b at full
   width, the serve cell's traffic cut to 8 requests of 64-1024 tokens
   (the last, submitted a round later, shares request 0's first 48 tokens
   and hits its cached pages), 32 new, temperature 0.6 / top-k 20 / top-p
   0.95, page 16, prefill chunk 512. (a) A 1x1 plan of a one-rank NCCL
   group (the plan's code path; a size-1 axis runs no collective, so
   the lockstep broadcast is the one that runs), bf16 28/28 layers:
   tokens and logps bit-equal to the one-device engine, K3/K4 launches
   equal. (b) Two rank
   processes on the one card over gloo (``--rank``), 1x2: bf16 at
   PLAN_BF16_LAYERS of 28 layers (per-rank weight and pool bytes, which
   must be half the
   one-device engine's, on the card; decode ms a step, host-staged, not a
   speed figure; |Δ logp| against the one-device engine before each
   request's first differing token, the mean within TOL_LOGP_MEAN_BF16),
   a float32 pair at PLAN_F32_LAYERS layers (tokens equal, logps within
   TOL_PLAN_LP) and a control with the two ranks' q heads swapped that
   must miss that bar. (c) 2x1, float32 at PLAN_F32_LAYERS layers: the
   slots split over 'data', the shared-prefix request admitted on the
   other data rank than the one that cached it; the one-device tokens.
   Both ranks emit the same tokens in every run. (d) K3/K4 at one rank's
   heads (Hq 8, Hkv 4, D 128; K4 C 512 after 1024) against their twins,
   timed beside the twin, the bound and SDPA.
16. static plan: ``StaticEngine`` on ``serve`` and ``long`` plans (a
   context-parallel dense-cache decode: each rank its span of positions
   with every KV head, the ranks' partial softmaxes merged). (a)
   qwen3-1.7b bf16 28/28, 16 x 832 + SPLAN_ONE_NEW (the static phase's
   prompts, prefill through K5), on a 1x1 plan of a one-rank NCCL group:
   tokens
   and logps bit-equal to one device, K5 launches equal. Two rank
   processes on the one card over gloo (``--rank``): (b) 1x2, 16 x
   832 + SPLAN_NEW, bf16 at SPLAN_BF16_LAYERS of 28 (weight bytes a rank,
   dense-cache bytes a
   rank for 1024 positions, which must be half one device's; |Δ logp|
   against one device, the mean within TOL_LOGP_MEAN_BF16), a float32
   pair at SPLAN_F32_LAYERS layers with wq and wk x SPLAN_SHARP (tokens
   equal, logps within TOL_PLAN_LP) and the control, the ranks' partials
   merged without their max rescale, which must miss that bar; (c) a
   ``long`` 2x1 plan, bf16 at SPLAN_BF16_LAYERS, 1 x 8192 + 64 (half the
   cache's 8256 positions a rank); (d) on 1x2, mamba2-1.3b 16/48 (its
   tied embedding x SSM_EMBED_SCALE, so the layers and not the input
   token's own row decide the logits; its recompute through K6 at 32 of
   64 heads), whisper-small whole (its encoder through K5 at 6 of 12
   heads, 750 memory rows a rank) and llama-3.2-vision-11b 10/40 (1601
   memory rows on every rank) in bf16 against one device, each with a
   float32 pair at a cut depth; (e) the front door on 1x2 (float32,
   SPLAN_F32_LAYERS layers): 8 clients at once against rank 0, rank 1
   following its rounds, tokens equal to the plan engine's ``generate``
   under the same key. Both ranks emit the same tokens in every run. (f)
   K5 at one rank's heads (the static prefill at 8 of 16 q heads,
   Whisper's encoder and cross prefill at 6 of 12) and K6 at 32 of 64
   heads against their twins, timed beside the twin, the bound and SDPA.
17. MoE plan: the MoE family and jamba on serve plans, the continuous
   engine on a ``long`` plan, the threaded runtime on a live sampler
   plan (weights from ``draw_params``, slab by slab, so a rank draws only
   its shard). (a) llama4-scout 4/48 bf16 through ``ContinuousEngine``
   (8 requests of 64-1024 tokens, 32 new) on a 1x1 plan of a one-rank
   NCCL group: tokens, logps and every MoE forward's ``moe_drop_frac``
   bit-equal to one device. Two rank processes over gloo
   (``--rank``): (b) scout 4/48 bf16 on 1x2 through both engines
   (experts 0-7 / 8-15, half the weights a rank; bf16 mean |Δ logp|
   within TOL_LOGP_MEAN_BF16), a float32 pair at 2/48 (tokens, logps
   within TOL_PLAN_LP and every drop equal) and the control, each rank on
   the next rank's experts, which must miss it; (c) maverick 2/48 on 2x1
   (its experts' FFN columns over 'data', the decode slots over 'data':
   every prefill forward's drops equal one device's, and all of them
   where the tokens are equal), then with ``moe_ep="serve"`` on 1x2 at a
   capacity factor of E / k (no drops) against one device's
   ``moe_ffn``; (d) jamba 2/72 (attention + MoE, Mamba2 + MLP) on 1x2
   through ``StaticEngine`` 4 x 512 + 16 and ``token_logps`` (K5 at 32 of
   64 q heads, K6 at 128 of 256 SSM heads), bf16 and a float32 pair;
   for (b) and (d) the dry-run's parameter bytes a rank on 1x2
   (``launch.dryrun.rank_param_bytes``) equal the bytes each rank holds;
   (e) qwen3-1.7b at LONG17_LAYERS of 28 on a ``long`` 2x1 plan through
   ``ContinuousEngine``, 2 x 4096 + 32 (half the weights, the whole pools
   a rank); (f) ``ThreadedHeteroRuntime.run(2)`` on a 1x2 sampler plan, 2
   samplers at LOOP_LAYERS: both ranks' batches and staleness equal. Both
   ranks emit the same tokens in every run. (g) K3/K4 at one rank of
   scout's heads (Hq 20, Hkv 4) and K6 at one rank of jamba's recompute
   (128 of 256 heads) against their twins, timed beside the twin, the
   bound and SDPA (K6: none).
18. analysis: the port's static analysis (``python -m
   repro_torch.analysis``, RA001-RA005) in the process over its default
   paths with ``analysis_baseline_torch.json``: 0 new and 0 stale
   findings, then its self-test (all five rules fire on the fixture).
   Its host-sync twin runs at the end of phase 3 on the same engine,
   outside the timed window: SYNC_TWIN_PROMPTS of the phase's prompts
   resubmitted and stepped to the end under
   ``torch.cuda.set_sync_debug_mode("warn")``, every sync an aten op
   reports mapped to the innermost frame in ``src/repro_torch/``; the
   syncs per prefill and per decode round and each site are printed, and
   a site in a hot function (RA003's definition) with no static RA003
   finding at its line (noqa'd or baselined ones count) fails the run.
   Static sites the card did not hit are printed, not failed.
19. small models: the repo's own small models, whose head dims (24, 32)
   run the kernels' padded instantiations, served on the card in
   float32 (their configs copied from ``benchmarks/``, not imported):
   (a) ``bench-lm`` (2 layers, d_model 96, 4/2 heads, D 24) through
   ``ContinuousEngine`` with ``paged_attn_impl`` "pallas" and "ref" on
   the same keys; (b) ``serve-bench`` and ``spec-lm`` (D 32) with spec_k
   4, K4's verify windows at D 32; (c) ``StaticEngine`` on bench-lm with
   ``attn_impl`` "pallas" (K5 at D 24) and "chunked". Each pair: tokens
   equal, logps within TOL_PLAN_LP, the kernels' launches equal to layers
   x decode steps (K3), x prefill chunks and verify rounds (K4, plus the
   rescore), x prefills (K5), none on the twin's run.

Phase 2 also holds K3, K4 and K5 at D 12, 16, 20, 24, 32, 80 and 96 and
at the reference's own paged test cases (B 4, Hkv 2, rep 4, D 32, page
8), and K6 at the reference's SSD sweep and P 24 x N 48, each in bf16
and float32 against its twin at the bar its dtype has, and times one
float32 row a kernel at D 32 (K6: P 32, N 48) beside its twin, its bound
and the library call; phase 1's HMMA and spill check covers every padded
bf16 instantiation.

Prints a ``{"kernels": [...]}`` JSON line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the rest of the repository.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import gc
import io
import json
import resource
import statistics
import struct
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import hot_function_at  # noqa: E402
from repro_torch.analysis.core import (apply_baseline,  # noqa: E402
                                       collect_files, load_baseline,
                                       run_rules)
from repro_torch.analysis.sentinel import (RecompileSentinel,  # noqa: E402
                                           executable_bound)
from repro_torch.checkpoint import PolicyStore  # noqa: E402
from repro_torch.checkpoint.store import flatten_with_paths  # noqa: E402
from repro_torch.config import (ATTN, CROSS, MLP, MOE,  # noqa: E402
                                HeteroConfig, ModelConfig, RLConfig,
                                ServeConfig, TrainConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import ArithmeticTask, Tokenizer  # noqa: E402
from repro_torch.data.tasks import PAD  # noqa: E402
from repro_torch.hetero import (HeteroRuntime, SamplerNode,  # noqa: E402
                                ThreadedHeteroRuntime, run_online)
from repro_torch.hetero import nodes as nodes_mod  # noqa: E402
from repro_torch.hetero.nodes import copy_tree  # noqa: E402
from repro_torch.launch.dryrun import rank_param_bytes  # noqa: E402
from repro_torch.launch.train import sft_warmstart  # noqa: E402
from repro_torch.parallel.mesh import HBM_BYTES, abstract_mesh  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_logprob as fl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import (decode_step, encode,  # noqa: E402
                                forward, init_cache, init_params, ssm)
from repro_torch.models.moe import moe_ffn  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import training as training_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.optim import global_norm, tree_leaves  # noqa: E402
from repro_torch.sampling import (StaticEngine, build_engine,  # noqa: E402
                                  generate_continuous,
                                  init_paged_pool, mask_vocab,
                                  rollout_from_results, stacked_pools,
                                  token_logps)
from repro_torch.sampling import prng  # noqa: E402
from repro_torch.sampling.sample import (filter_logits,  # noqa: E402
                                         sample_token_rows)
from repro_torch.serving.api import Request, SamplingParams  # noqa: E402
from repro_torch.serving.telemetry import percentile  # noqa: E402
from repro_torch.training import (init_state, rl_loss_fn,  # noqa: E402
                                  train_step)
from repro_torch.transport import ChunkSubscriber, content_hash  # noqa: E402
from repro_torch.transport.chunks import chunk_host_leaf  # noqa: E402

HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS_S = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_S = 67e12          # H100 SXM float32 outside the tensor cores
TOL_BF16 = 2e-2              # one bf16 rounding of outputs of magnitude < 4
TOL_F32 = 1e-5               # float32 inputs: summation order only
TOL_LOGITS = 0.1             # bf16 model, 28 layers: a few bf16 ulps at |4-8|
HQ, HKV, D, PAGE, SLOTS = 16, 8, 128, 16, 8
# K1 against its twin: float32 sums over 152064 terms in another order,
# and expf against torch.exp
TOL_LP = 1e-4
# K2 against its twin given the same lse and mu, element by element
# (fl.dlogits_error_ratio): |K2 - twin| <= rtol * scale, where scale =
# |g_lp| (onehot + p) + |g_ent| p |x - mu| sums the magnitudes of the
# formula's terms; a few float32 ulps of it in float32, one bfloat16 ulp
# (2^-7 of |dlogits| <= scale) more in bfloat16
RTOL_DLOGITS = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7 + 1e-5}
CHUNK = 256                  # token rows per piece of the twin
# learner, K1/K2 against the twin through one full-width rl_loss_fn
# forward and backward: the logits are the same float32 tensor, so the
# loss and metrics differ only by the log-prob sums (relative 1e-4), and
# dlogits by a few float32 ulps; in the bf16 backward these flip the
# rounding of a few elements by one bf16 ulp, so the gradient norm moves by
# ~1e-6 relative. The lm_head gradient (dlogits' first consumer) is held
# in float32, x_f^T dlogits with x_f the final-norm output: the model's
# own bf16 head gradient differs by one bf16 ulp in ~0.1% of its entries
# (1.00 ulp at most on an H100), and one such flip (2^-8 of an entry) at
# an entry above 2.6% of the largest breaks 1e-4 of the largest (1.04e-3
# on an H100 with the entropy bonus), which says nothing of K1/K2; its
# size in ulps is printed, not held. All held to 1e-4
TOL_LOSS_REL = 1e-4
TOL_GNORM_REL = 1e-4
TOL_HEAD_REL = 1e-4
# the entropy bonus of the second full-width comparison: it makes g_ent
# nonzero, so K2's g_ent p (x - mu) term feeds the gradient
ENTROPY_BONUS = 0.01
PROMPTS, GROUP, PROMPT_LEN, NEW_TOKENS = 2, 8, 832, 192
# the hetero phase: learner steps of HeteroRuntime.run and run_online, SFT
# warm-start steps, prompts per sampler batch (x GROUP rows)
HETERO_STEPS, HETERO_ONLINE_STEPS, HETERO_SFT_STEPS = 4, 2, 2
# depth cuts that keep the script inside its 1200 s limit (PERF.md §4): the
# loop phases (8, 10) and the spec phase (9) run qwen3-1.7b at full width
# but LOOP_LAYERS / SPEC_LAYERS of its 28 layers (a publish of the loop's
# weights is 1.45 GB at 2 layers, 1.65 GB at 4, 4.06 GB at 28)
LOOP_LAYERS, SPEC_LAYERS = 2, 4
HETERO_PROMPTS = 2
# the threaded phase waits this long for each sampler thread after the run
# (a sampler batch in flight takes 2-6 s alone, longer beside a learner)
THREAD_JOIN_S = 120.0
# K5 against its float32 twin: the JAX package's own tolerances
# (tests/test_kernels.py), 2e-2 for bf16 outputs, 2e-5 for float32
TOL_FLASH = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# Gemma2 cases draw q at 40 N(0, 1), so that scores (N(0, 1600)) reach the
# softcap of 50: at N(0, 1) scores the cap changes the output by ~1e-4 and
# no check could see a kernel that drops it
Q_SCALE_CAPPED = 40.0
# logps of one bf16 model computed two ways (K5 or the chunked attention
# in the forward; the engine's dense-cache decode against the
# teacher-forced forward): bf16 roundings that flip differently through
# every layer; the continuous engine's sampler and the chunked recompute
# differ by ~0.03 nats at the learner phase's shape
TOL_LOGP_PATHS = 0.1
# ring against non-ring logps of the same greedy Gemma2 tokens: both runs
# take the same decode; only where the local layers' keys sit in the
# cache, and so the order of their sums, differs (4.4e-5 measured on the
# H100). Far under TOL_LOGP_PATHS, which spans two different forwards: a
# key of the window's edge taken or dropped in the local layers moves a
# logp further than this
TOL_LOGP_RING = 1e-3
# K5 against the chunked attention through a float32 model: only float32
# summation order differs in each layer's attention (2e-5 at the kernel)
TOL_LOGP_F32 = 1e-3
# mean over the tokens of |K5 - chunked| through the bf16 Gemma2 model:
# the max is set by a few tokens whose bf16 noise is large (0.217 nats),
# the mean by all 8192 (0.020); a kernel that drops a mask moves every
# token past the window
TOL_LOGP_MEAN_BF16 = 0.05
GEMMA_LEN, GEMMA_PROMPT, GEMMA_NEW = 8192, 4608, 16
# mean over the tokens of |K6 recompute - chunked recompute| and of |K6
# recompute - sampler| through the bf16 mamba2-1.3b model. With random
# weights the tied, scale-1 embeddings put a token's own logit ~1500 nats
# above the rest, where a bf16 logit moves in steps of 8: two bf16 paths
# whose residual streams differ by a few ulps round apart on a share of
# the tokens. Half a step is a garbage check, not a check of K6: it
# catches non-finite or misrouted logits, which move every token by tens
# of nats. The float32 pair (TOL_SSD_F32) and the layer check
# (SSD_LAYERS) are the checks that see an SSD fault
TOL_SSD_MEAN_BF16 = 4.0
# max |K6 - chunked| through the float32 mamba2-1.3b model: only float32
# summation order differs, but a token's own logit is ~1500 with random
# weights, where a float32 ulp is 1.2e-4; the two orders gave 1.221e-3
# (ten ulps) on the H100. 5e-3 is 40 ulps. With random weights the SSD is
# a small part of each layer (the D skip term dominates), so a K6 that
# drops the carried state moves these logps by only 3.5e-2 (max): that
# control must exceed TOL_SSD_F32, so the check is shown to reject it; the
# check with a wide margin is the layer check below
TOL_SSD_F32 = 5e-3
# layers whose SSD inputs, as the model hands them to K6 in a recompute,
# are replayed through K6 and the model's chunked SSD (ssd_scan's
# element-wise bound, as in the kernel phase), with the no-carry control
SSD_LAYERS = (0, 47)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    CUDA events, after ``warmup`` calls (L2 not flushed)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()  # noqa: RA003 — timing
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: the kernels' time in a torch.profiler
    trace of ``iters`` calls, over ``iters``. Beside ``time_ms`` where a
    call's host work (the wrapper, the ctypes call) outlasts its kernels,
    so back-to-back calls time the host."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()  # noqa: RA003 — timing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()  # noqa: RA003 — timing
    return sum(dev_us(e) for e in prof.key_averages()) / 1e3 / iters


def dev_us(e) -> float:
    """Device time of a profiler row, under either of torch's names."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_S) -> tuple:
    t_b, t_f = nbytes / HBM_BYTES_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# --------------------------------------------------------------------------
# phase 2: the kernels at the slice's shapes


def decode_case(gen, dev, lengths, width, hq=HQ, hkv=HKV, d=D, page=PAGE):
    b = len(lengths)
    pool = 1 + b * width
    kp = torch.randn((pool, page, hkv, d), generator=gen, device=dev)
    vp = torch.randn((pool, page, hkv, d), generator=gen, device=dev)
    kp[0] = vp[0] = float("nan")             # scratch page: garbage
    table = torch.zeros((b, width), dtype=torch.int32)
    perm = torch.randperm(pool - 1, generator=torch.Generator().manual_seed(  # noqa: RA002 — a seed per case
        0)) + 1
    for s, n in enumerate(lengths):
        live = min(-(-n // page), width)
        if n <= width * page:                # the dead slot keeps scratch
            table[s, :live] = perm[s * width:s * width + live]
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), table.to(dev),  # noqa: RA003 — case set-up
            lens.to(dev))  # noqa: RA003 — case set-up


def prefill_case(gen, dev, c, start, hq=HQ, hkv=HKV, d=D):
    width = -(-(start + c) // PAGE)
    pool = 1 + width + 4
    kp = torch.randn((pool, PAGE, hkv, d), generator=gen, device=dev)
    vp = torch.randn((pool, PAGE, hkv, d), generator=gen, device=dev)
    kp[0] = vp[0] = float("nan")
    table = torch.arange(1, width + 1, dtype=torch.int32, device=dev)[None]
    q = torch.randn((1, c, hq, d), generator=gen, device=dev)
    positions = (start + torch.arange(c, device=dev))[None]
    return q.bfloat16(), kp.bfloat16(), vp.bfloat16(), table, positions


def verify_case(gen, dev, c):
    """K4 at a verify round's shape: SLOTS slots, each a window of ``c``
    rows after 300 ... 1000 keys (slot s at 300 + 100 s), the table's
    pages past each window the NaN scratch page and NaN in the rows past
    the window on its last page."""
    starts = 300 + 100 * torch.arange(SLOTS)
    width = -(-(int(starts[-1]) + c) // PAGE)
    pool = 1 + SLOTS * width
    kp = torch.randn((pool, PAGE, HKV, D), generator=gen, device=dev)
    vp = torch.randn((pool, PAGE, HKV, D), generator=gen, device=dev)
    kp[0] = vp[0] = float("nan")
    table = torch.zeros((SLOTS, width), dtype=torch.int32)
    perm = torch.randperm(pool - 1, generator=torch.Generator().manual_seed(
        1)) + 1
    for s in range(SLOTS):
        n = int(starts[s]) + c
        live = -(-n // PAGE)
        table[s, :live] = perm[s * width:s * width + live]
        if n % PAGE:
            last = int(table[s, live - 1])
            kp[last, n % PAGE:] = vp[last, n % PAGE:] = float("nan")
    q = torch.randn((SLOTS, c, HQ, D), generator=gen, device=dev)
    positions = (starts[:, None] + torch.arange(c)).to(dev)
    return (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), table.to(dev),
            positions)


def sdpa_decode(q, kp, vp, table, lengths):
    """Library yardstick setup: the dense per-slot view and its mask; the
    timed call is only the SDPA itself."""
    b, width = table.shape
    hq, hkv, d = q.shape[1], kp.shape[2], kp.shape[3]
    idx = table.long()
    k = kp[idx].reshape(b, width * PAGE, hkv, d).transpose(1, 2)
    v = vp[idx].reshape(b, width * PAGE, hkv, d).transpose(1, 2)
    k = k.repeat_interleave(hq // hkv, dim=1).contiguous()
    v = v.repeat_interleave(hq // hkv, dim=1).contiguous()
    cols = torch.arange(width * PAGE, device=q.device)
    mask = (cols[None] < lengths.long()[:, None])[:, None, None]
    return q[:, :, None], k, v, mask


def sdpa_prefill(q, kp, vp, table, positions):
    width = table.shape[1]
    hq, hkv, d = q.shape[2], kp.shape[2], kp.shape[3]
    idx = table.long()
    k = kp[idx].reshape(1, width * PAGE, hkv, d).transpose(1, 2)
    v = vp[idx].reshape(1, width * PAGE, hkv, d).transpose(1, 2)
    k = k.repeat_interleave(hq // hkv, dim=1).contiguous()
    v = v.repeat_interleave(hq // hkv, dim=1).contiguous()
    cols = torch.arange(width * PAGE, device=q.device)
    mask = (cols[None, :] <= positions[0][:, None])[None, None]
    return q.transpose(1, 2).contiguous(), k, v, mask


def library_ms(q, k, v, attn_mask=None, iters=20, device=False, **kw):
    """Time of one SDPA call, the library yardstick (the port never
    calls it): CUDA events over back-to-back calls, or with ``device``
    the profiler's device time."""
    timer = device_ms if device else time_ms
    return timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, **kw), iters=iters)


def k4_f32_ms(q, kp, vp, table, pos, splits):
    """CUDA-event time of K4's float32 body on float32 inputs at a given
    key split, through the C entry point (no launch counted): beside the
    wrapper's own split (``pa.K4_F32_SPLITS``), what splitting buys."""
    lib = build.load()
    b, c, hq, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    table = table.to(torch.int32).contiguous()
    starts = pos[:, 0].to(torch.int32).contiguous()
    lens = (pos[:, -1] + 1).to(torch.int32).contiguous()
    out = torch.empty_like(q)

    def launch():  # noqa: RA004 — a yardstick beside the main path's split: counted nowhere
        pa._check(q, kp, vp, table, {"lengths": lens, "starts": starts})
        err = lib.paged_prefill_launch(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            lens.data_ptr(), starts.data_ptr(), out.data_ptr(), b, c, hq, hkv,
            d, page, table.shape[1], -1, 0.0, 0, splits,
            torch.cuda.current_stream(q.device).cuda_stream)
        pa._raise_on(err, "paged_prefill_kernel")
    return time_ms(launch)


def max_err(got, want, rows=slice(None)):
    return float((got[rows].float() - want[rows].float()).abs().max())


def decode_bound(q, table, lengths, width, hkv=HKV):
    """K3's bound: the live slots' K/V (the dead slot's block walks no
    page), q read and the output written once, the table and lengths."""
    keys = [n for n in lengths if n <= width * PAGE]
    kv_bytes = sum(-(-k // PAGE) * PAGE for k in keys) * hkv * D * 2 * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + table.numel() * 4 + 4 * len(
        lengths)
    return bound(nbytes, sum(4 * q.shape[1] * D * k for k in keys))


def decode_long(gen, dev):
    """K3 on one slot of 8192 keys (all 8 splits of each kv head busy):
    held against its twin and timed beside its bound and SDPA."""
    n = 8192
    width = n // PAGE
    q, kp, vp, table, lens = decode_case(gen, dev, [n], width)
    got = pa.paged_attention(q, kp, vp, table, lens)
    want = pa.paged_decode_ref(q.float(), kp.float(), vp.float(), table,
                               lens)
    torch.cuda.synchronize()  # noqa: RA003 — timing
    err = max_err(got, want)
    if not err <= TOL_BF16:  # noqa: RA003 — the check reads its error
        raise AssertionError(f"K3 at one slot of {n} keys disagrees with "
                             f"its twin: {err:.3e}")
    b_ms, b_by = decode_bound(q, table, [n], width)
    def k3():
        return pa.paged_attention(q, kp, vp, table, lens)

    sdpa = sdpa_decode(q, kp, vp, table, lens)
    row = dict(ms=time_ms(k3), device_ms=device_ms(k3), bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms(*sdpa),
               library_device_ms=library_ms(*sdpa, device=True),
               max_abs_err=err,
               shape=f"B=1 Hq={HQ} Hkv={HKV} D={D} page={PAGE} "
                     f"lengths=[{n}] bf16")
    log(f"[kernels] K3 one slot of {n} keys ({pa.DECODE_SPLITS * HKV} "
        f"blocks): max|err| {err:.3e}, {row['ms']:.4f} ms (device "
        f"{row['device_ms']:.4f}), bound {b_ms:.5f} ms ({b_by}), SDPA "
        f"{row['library_ms']:.4f} ms (device "
        f"{row['library_device_ms']:.4f})")
    return row


def kernel_phase(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    width = 2048 // PAGE
    lengths = [2048, 1537, 1024, 700, 333, 64, 1, width * PAGE + 1]
    live = slice(0, SLOTS - 1)               # the dead slot's row is junk
    q, kp, vp, table, lens = decode_case(gen, dev, lengths, width)
    f32 = [t.float() for t in (q, kp, vp)]
    out = {}

    # K3 ---------------------------------------------------------------
    got = pa.paged_attention(q, kp, vp, table, lens)
    want = pa.paged_decode_ref(*f32, table, lens)
    got32 = pa.paged_attention(*f32, table, lens)
    torch.cuda.synchronize()
    err, err32 = max_err(got, want, live), max_err(got32, want, live)
    if not torch.isfinite(got[live].float()).all():
        raise AssertionError("K3: non-finite output on a live slot")
    gw = pa.paged_attention(q, kp, vp, table, lens, window=256, softcap=50.0)
    ww = pa.paged_decode_ref(*f32, table, lens, window=256, softcap=50.0)
    err_w = max_err(gw, ww, live)
    log(f"[kernels] K3 paged_decode ({pa.DECODE_SPLITS} splits, one "
        f"cluster, x {pa.DECODE_WARPS} warps per (slot, kv head): "
        f"{pa.DECODE_SPLITS * HKV * SLOTS} blocks): max|err| bf16 "
        f"{err:.3e} (tol {TOL_BF16}), f32 {err32:.3e} (tol {TOL_F32}), "
        f"window+softcap {err_w:.3e}")
    if err > TOL_BF16 or err_w > TOL_BF16 or err32 > TOL_F32:
        raise AssertionError("K3 disagrees with its twin")
    b_ms, b_by = decode_bound(q, table, lengths, width)
    out["paged_decode"] = dict(
        name="paged_decode_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:85 (_kernel; "
                 "pallas_call at :177)",
        max_abs_err=err, max_abs_err_f32=err32, tol=TOL_BF16,
        ms=time_ms(lambda: pa.paged_attention(q, kp, vp, table, lens)),
        device_ms=device_ms(lambda: pa.paged_attention(q, kp, vp, table,
                                                       lens)),
        plain_ms=time_ms(lambda: pa.paged_decode_ref(q, kp, vp, table,
                                                     lens), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms(*sdpa_decode(q, kp, vp, table, lens)),
        library_device_ms=library_ms(*sdpa_decode(q, kp, vp, table, lens),
                                     device=True),
        splits=pa.DECODE_SPLITS, warps_per_split=pa.DECODE_WARPS,
        shape=f"B={SLOTS} Hq={HQ} Hkv={HKV} D={D} page={PAGE} "
              f"lengths={lengths} bf16")
    row = out["paged_decode"]
    log(f"[kernels] K3 {SLOTS} slots: {row['ms']:.4f} ms (device "
        f"{row['device_ms']:.4f}), bound {b_ms:.5f} ms ({b_by}), SDPA "
        f"{row['library_ms']:.4f} ms (device "
        f"{row['library_device_ms']:.4f})")
    row["long"] = decode_long(gen, dev)

    # K4 ---------------------------------------------------------------
    rows = {}
    for c, start in ((512, 1024), (77, 300)):
        q, kp, vp, table, pos = prefill_case(gen, dev, c, start)
        f32 = [t.float() for t in (q, kp, vp)]
        got = ops.paged_prefill(q, kp, vp, table, pos, impl="pallas")
        want = ops.paged_prefill(*f32, table, pos, impl="ref")
        got32 = ops.paged_prefill(*f32, table, pos, impl="pallas")
        gw = ops.paged_prefill(q, kp, vp, table, pos, kind="local",
                               window=256, softcap=50.0, impl="pallas")
        ww = ops.paged_prefill(*f32, table, pos, kind="local", window=256,
                               softcap=50.0, impl="ref")
        torch.cuda.synchronize()
        errs = (max_err(got, want), max_err(got32, want), max_err(gw, ww))
        log(f"[kernels] K4 paged_prefill C={c} start={start}: max|err| bf16 "
            f"{errs[0]:.3e}, f32 {errs[1]:.3e}, window+softcap "
            f"{errs[2]:.3e}")
        if errs[0] > TOL_BF16 or errs[2] > TOL_BF16 or errs[1] > TOL_F32:
            raise AssertionError(f"K4 (C={c}) disagrees with its twin")
        rows[c] = (q, kp, vp, table, pos, errs)
    # the spec engine's verify windows (2 ... spec_k + 1 rows a slot)
    verify = [0.0, 0.0, 0.0]
    for c in (2, 3, 5):
        q, kp, vp, table, pos = verify_case(gen, dev, c)
        f32 = [t.float() for t in (q, kp, vp)]
        got = ops.paged_prefill(q, kp, vp, table, pos, impl="pallas")
        want = ops.paged_prefill(*f32, table, pos, impl="ref")
        got32 = ops.paged_prefill(*f32, table, pos, impl="pallas")
        gw = ops.paged_prefill(q, kp, vp, table, pos, kind="local",
                               window=256, softcap=50.0, impl="pallas")
        ww = ops.paged_prefill(*f32, table, pos, kind="local", window=256,
                               softcap=50.0, impl="ref")
        torch.cuda.synchronize()
        errs = (max_err(got, want), max_err(got32, want), max_err(gw, ww))
        log(f"[kernels] K4 verify window B={SLOTS} C={c} after 300-1000 keys "
            f"(NaN past each window): max|err| bf16 {errs[0]:.3e}, f32 "
            f"{errs[1]:.3e}, window+softcap {errs[2]:.3e}")
        if not (errs[0] <= TOL_BF16 and errs[2] <= TOL_BF16
                and errs[1] <= TOL_F32):
            raise AssertionError(f"K4 (verify C={c}) disagrees with its twin")
        verify = [max(a, b) for a, b in zip(verify, errs)]
    q, kp, vp, table, pos, errs = rows[512]
    f32 = [t.float() for t in (q, kp, vp)]
    c, start = 512, 1024
    kv_elems = -(-(start + c) // PAGE) * PAGE * HKV * D * 2
    flops = sum(4 * HQ * D * (start + i + 1) for i in range(c))
    b_ms, b_by = bound(kv_elems * 2 + 2 * q.numel() * 2 + table.numel() * 4,
                       flops)
    b32_ms, b32_by = bound(kv_elems * 4 + 2 * q.numel() * 4
                           + table.numel() * 4, flops, F32_FLOPS_S)
    out["paged_prefill"] = dict(
        name="paged_prefill_tc_kernel", name_f32="paged_prefill_kernel",
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        sources=["src/repro_torch/kernels/csrc/paged_attention.cu",
                 "src/repro_torch/kernels/csrc/attention_tc.cuh"],
        replaces="src/repro/kernels/paged_attention.py:245 "
                 "(_prefill_kernel; pallas_call at :376): bf16 on the "
                 "tensor cores (attention_tc.cuh), float32 on the CUDA "
                 "cores",
        max_abs_err=max(errs[0], rows[77][5][0], verify[0]),
        max_abs_err_f32=max(errs[1], rows[77][5][1], verify[1]),
        max_abs_err_verify=verify[0], max_abs_err_verify_f32=verify[1],
        tol=TOL_BF16,
        ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                             impl="pallas")),
        plain_ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                                   impl="ref"), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms(*sdpa_prefill(q, kp, vp, table, pos)),
        ms_f32=time_ms(lambda: ops.paged_prefill(*f32, table, pos,
                                                 impl="pallas")),
        bound_ms_f32=b32_ms, bound_by_f32=b32_by,
        library_ms_f32=library_ms(*sdpa_prefill(*f32, table, pos)),
        device_ms_f32=device_ms(lambda: ops.paged_prefill(
            *f32, table, pos, impl="pallas")),
        splits_f32=pa.K4_F32_SPLITS,
        ms_f32_split=k4_f32_ms(*f32, table, pos, pa.K4_F32_SPLITS),
        ms_f32_unsplit=k4_f32_ms(*f32, table, pos, 1),
        shape=f"B=1 C={c} start={start} Hq={HQ} Hkv={HKV} D={D} "
              f"page={PAGE} bf16 (+ C=77 start=300 and the verify "
              f"windows B={SLOTS} C=2,3,5 after 300-1000 keys checked; "
              f"ms_f32: the float32 route at C=512)")
    log(f"[kernels] K4 C=512: bf16 {out['paged_prefill']['ms']:.4f} ms "
        f"(bound {b_ms:.5f} ms, {b_by}), float32 "
        f"{out['paged_prefill']['ms_f32']:.4f} ms (device "
        f"{out['paged_prefill']['device_ms_f32']:.4f}; bound {b32_ms:.5f} "
        f"ms, {b32_by}; the C entry at the plan's split of "
        f"{out['paged_prefill']['splits_f32']} "
        f"{out['paged_prefill']['ms_f32_split']:.4f} ms, unsplit "
        f"{out['paged_prefill']['ms_f32_unsplit']:.4f} ms), "
        f"SDPA {out['paged_prefill']['library_ms']:.4f} ms, SDPA float32 "
        f"{out['paged_prefill']['library_ms_f32']:.4f} ms")
    return out


# phase 2, draws: the threefry sampler (plain torch, no kernel) on the
# card against the CPU. Bits and uniforms are integer work and one exact
# float subtraction: equal bit for bit. The Gumbel noise -log(-log(u))
# takes two float32 logs, each within 1 ulp of the exact value on either
# device, so two devices' logs may sit 2 ulps apart: the inner one moves
# g by up to 2 ulps of 1 (d(-log x) = dx / x), the outer one by 2 ulps of
# |g|. Held to NOISE_ULPS = 4 ulps of max(|g|, 1), the sum
# (tests/test_torch_prng.py holds the CPU to jax's at the same bar)
NOISE_ULPS = 4
DRAW_ROWS = (8, 40)          # the decode slots; the verify width (8 x 5)
SERVE_PROFILE = dict(temperature=0.6, top_k=20, top_p=0.95)


def device_launches(fn) -> int:
    """Kernels (and memcpy/memset) one ``fn()`` puts on the card, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))


def draw_keys(seed, rows, dev):
    """Keys of draw ``g`` of request ``rid`` (``fold_in(fold_in(PRNGKey(
    seed), rid), g)``) for ``rows`` rows of distinct (rid, g), on ``dev``."""
    rids = torch.arange(rows, device=dev) * 7 + 3
    gens = torch.arange(rows, device=dev) % 5
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed, dev), rids), gens)


def hashed_gumbel(seed, rids, gens, vocab):
    """The draw this port used before threefry, kept here only to time it
    beside its replacement: (B, vocab) float32 Gumbel noise from murmur3's
    32-bit finalizer over (seed, rid, g, token index), on int64 tensors
    holding uint32 values, uniforms from the top 23 bits centred in
    their cell."""
    m32 = 0xFFFFFFFF

    def fmix(h):
        h = h ^ (h >> 16)
        h = (h * 0x85EBCA6B) & m32
        h = h ^ (h >> 13)
        h = (h * 0xC2B2AE35) & m32
        return h ^ (h >> 16)

    key = fmix(torch.full_like(rids, seed & m32, dtype=torch.int64)
               ^ 0x9E3779B9)
    key = fmix(fmix(key ^ (rids.long() & m32)) ^ (gens.long() & m32))
    idx = fmix(torch.arange(vocab, device=rids.device, dtype=torch.int64)
               + 0x632BE5AB)
    bits = fmix(key[:, None] ^ idx[None, :])
    u = ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def draw_phase(dev, seed, card):
    """The engines' token draw at the serve cell's vocab (152064 padded)
    for 8 and 40 rows on the card against the CPU: keys, bits and uniforms
    bit for bit, the noise within NOISE_ULPS, the tokens of
    ``sample_token_rows`` (serve profile, and temperature 1 unfiltered)
    equal on every row. Times one 8-row draw (``fold_in`` + the Gumbel
    argmax, and the whole ``sample_token_rows`` with its filters) and
    counts its launches. Returns those numbers."""
    v = get_config("qwen3-1.7b").padded_vocab
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cpu = torch.device("cpu")
    worst = 0.0
    for rows in DRAW_ROWS:
        kd, kc = draw_keys(seed, rows, dev), draw_keys(seed, rows, cpu)
        if not torch.equal(kd.cpu(), kc):
            raise AssertionError(f"draw keys ({rows} rows) differ on the "
                                 "card")
        if not torch.equal(prng.random_bits(kd, (v,)).cpu(),
                           prng.random_bits(kc, (v,))):
            raise AssertionError(f"threefry bits ({rows} x {v}) differ")
        ud = prng.uniform(kd, (v,), minval=prng.TINY_F32).cpu()
        uc = prng.uniform(kc, (v,), minval=prng.TINY_F32)
        if not torch.equal(ud.view(torch.int32), uc.view(torch.int32)):
            raise AssertionError(f"uniforms ({rows} x {v}) differ")
        gd, gc_ = prng.gumbel(kd, (v,)).cpu(), prng.gumbel(kc, (v,))
        mag = gc_.abs().clamp_min(1.0)
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        err = float(((gd - gc_).abs() / ulp).max())
        worst = max(worst, err)
        if not err <= NOISE_ULPS:
            raise AssertionError(f"Gumbel noise ({rows} rows) {err} ulps "
                                 f"from the CPU's > {NOISE_ULPS}")
        lg = torch.randn((rows, v), generator=gen).mul_(4.0)
        for prof in (SERVE_PROFILE, dict(temperature=1.0, top_k=0,
                                         top_p=1.0)):
            td = sample_token_rows(kd, lg.to(dev), **prof).cpu()
            tc = sample_token_rows(kc, lg, **prof)
            if not torch.equal(td, tc):
                raise AssertionError(f"tokens ({rows} rows, {prof}) differ "
                                     f"on the card: {td.tolist()} vs "
                                     f"{tc.tolist()}")
    keys = draw_keys(seed, DRAW_ROWS[0], dev)
    lg = torch.randn((DRAW_ROWS[0], v), generator=gen).mul_(4.0).to(dev)
    gens = torch.arange(DRAW_ROWS[0], device=dev)

    def draw():
        return prng.categorical(prng.fold_in(keys, gens), lg)

    def sample():
        return sample_token_rows(prng.fold_in(keys, gens), lg,
                                 **SERVE_PROFILE)

    rids = torch.arange(DRAW_ROWS[0], device=dev) * 7 + 3

    def hashed_draw():
        return torch.argmax(lg + hashed_gumbel(seed, rids, gens, v), dim=-1)

    def hashed_sample():
        filt = filter_logits(lg, **SERVE_PROFILE)
        return torch.argmax(filt + hashed_gumbel(seed, rids, gens, v),
                            dim=-1)

    out = {"draw_ms": time_ms(draw), "draw_launches": device_launches(draw),
           "sample_ms": time_ms(sample),
           "sample_launches": device_launches(sample),
           "hashed_draw_ms": time_ms(hashed_draw),
           "hashed_draw_launches": device_launches(hashed_draw),
           "hashed_sample_ms": time_ms(hashed_sample)}
    log(f"[draws] threefry on the card = the CPU's at {DRAW_ROWS} rows x "
        f"{v}: keys, bits and uniforms bit for bit, Gumbel noise within "
        f"{worst:.2f} ulps of max(|g|, 1) (<= {NOISE_ULPS}), tokens equal on "
        f"every row (serve profile and temperature 1); one {DRAW_ROWS[0]}-row"
        f" draw (fold_in + Gumbel argmax) {out['draw_ms']:.4f} ms, "
        f"{out['draw_launches']} launches; with the serve profile's filters "
        f"(sample_token_rows) {out['sample_ms']:.4f} ms, "
        f"{out['sample_launches']} launches | {card}")
    log(f"[draws] the parent's hashed Gumbel-max (murmur3 fmix32) at the "
        f"same {DRAW_ROWS[0]} x {v}, this call: draw "
        f"{out['hashed_draw_ms']:.4f} ms, {out['hashed_draw_launches']} "
        f"launches; with the filters {out['hashed_sample_ms']:.4f} ms | "
        f"{card}")
    return out


def logprob_case(gen, dev, t, v, dtype):
    """Logits of the scale a model's head gives (3 x N(0, 1)), targets with
    two dirty ids (-1 and V + 5, clamped by the wrapper), cotangents."""
    x = torch.randn((t, v), generator=gen, device=dev).mul_(3.0).to(dtype)
    tgt = torch.randint(0, v, (t,), generator=gen, device=dev)
    tgt[0], tgt[-1] = -1, v + 5
    g = torch.randn((2, t), generator=gen, device=dev)
    return x, tgt, g[0], g[1]


def logprob_check(x, tgt, g_lp, g_ent, label):
    """K1 and K2 against the twin on the same inputs (K2 given the twin's
    lse and mu, held element by element). Two controls show the bound has
    teeth: it must reject the twin's dlogits with the entries at x < 2.6
    zeroed (~80% of a row of 3 N(0, 1) logits, most far below any
    absolute tolerance) and the twin's dlogits without the g_ent term.
    Returns ((K1 err, K2 max|err|, K2 bound ratio), (lse, mu), targets)."""
    v = x.shape[1]
    tgt32 = fl.clamp_target_ids(tgt, v).contiguous()
    got = fl.logprob_fwd(x, tgt32)
    want = fl._chunked_fwd_pass(x, tgt32, CHUNK)
    lse, mu = want[2], want[2] - want[1]
    args = (x, tgt32, lse, mu, g_lp, g_ent)
    rtol = RTOL_DLOGITS[x.dtype]
    d = fl.logprob_bwd(*args)
    d_want = fl._chunked_bwd_pass(*args, CHUNK)
    torch.cuda.synchronize()
    err_f = max(max_err(a, b) for a, b in zip(got, want))
    err_b = max_err(d, d_want)
    ratio = fl.dlogits_error_ratio(d, d_want, *args, rtol=rtol)
    del d
    controls = {}
    broken = d_want.masked_fill(x < 2.6, 0)
    controls["zeroed x<2.6"] = fl.dlogits_error_ratio(broken, d_want, *args,
                                                      rtol=rtol)
    broken = fl._chunked_bwd_pass(x, tgt32, lse, mu, g_lp,
                                  torch.zeros_like(g_ent), CHUNK)
    controls["no g_ent term"] = fl.dlogits_error_ratio(broken, d_want, *args,
                                                       rtol=rtol)
    del broken, d_want
    log(f"[kernels] {label}: K1 max|err| {err_f:.3e} (tol {TOL_LP}); K2 "
        f"max|err| {err_b:.3e}, element-wise |err| / ({rtol:.3e} scale) "
        f"max {ratio:.3e} (tol 1); controls the bound must reject: "
        + ", ".join(f"{k} {r:.3e}" for k, r in controls.items()))
    finite = all(torch.isfinite(a).all() for a in got)
    if err_f > TOL_LP or not ratio <= 1.0 or not finite:
        raise AssertionError(f"K1/K2 disagree with their twin ({label})")
    if not all(r > 1.0 for r in controls.values()):
        raise AssertionError(f"the K2 bound passes a broken backward "
                             f"({label}): {controls}")
    return (err_f, err_b, ratio), (lse, mu), tgt32


def logprob_phase(dev, seed):
    """K1/K2 rows: timed at the learner's microbatch (T 8184, V 152064,
    float32); checked there, at a ragged bf16 (77, 1001) and, K1 only, at
    T x V > 2^31 (T 16368, the recompute's shape)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    v = 152064
    t = 8 * (PROMPT_LEN + NEW_TOKENS - 1)                  # 8184
    x, tgt, g_lp, g_ent = logprob_case(gen, dev, t, v, torch.float32)
    (ef, eb, rb), (lse, mu), tgt32 = logprob_check(x, tgt, g_lp, g_ent,
                                                   f"({t}, {v}) f32")
    ms_f = time_ms(lambda: fl.logprob_fwd(x, tgt32))
    ms_b = time_ms(lambda: fl.logprob_bwd(x, tgt32, lse, mu, g_lp, g_ent))
    plain_f = time_ms(lambda: fl._chunked_fwd_pass(x, tgt32, CHUNK),
                      iters=5)
    plain_b = time_ms(lambda: fl._chunked_bwd_pass(
        x, tgt32, lse, mu, g_lp, g_ent, CHUNK), iters=5)
    lib_f = time_ms(lambda: torch.logsumexp(x, -1))
    lib_b = time_ms(lambda: torch.softmax(x, -1))
    n = t * v
    bf = bound(n * 4 + t * 4 + 3 * t * 4, 6 * n, F32_FLOPS_S)
    bb = bound(2 * n * 4 + 5 * t * 4, 7 * n, F32_FLOPS_S)
    del x, lse, mu
    torch.cuda.empty_cache()

    xr, tr, gr_lp, gr_ent = logprob_case(gen, dev, 77, 1001, torch.bfloat16)
    (ef_r, eb_r, rb_r), _, _ = logprob_check(xr, tr, gr_lp, gr_ent,
                                             "(77, 1001) bf16, dirty ids")

    tb = 2 * t                                             # 16368
    xb = torch.randn((tb, v), generator=gen, device=dev).mul_(3.0)
    tgb = fl.clamp_target_ids(torch.randint(0, v, (tb,), generator=gen,
                                            device=dev), v)
    got = fl.logprob_fwd(xb, tgb)
    want = fl._chunked_fwd_pass(xb, tgb, CHUNK)
    torch.cuda.synchronize()
    ef_b = max(max_err(a, b) for a, b in zip(got, want))
    log(f"[kernels] ({tb}, {v}) f32, T x V = {tb * v} > 2^31: K1 max|err| "
        f"{ef_b:.3e} (tol {TOL_LP})")
    if ef_b > TOL_LP or not all(torch.isfinite(a).all() for a in got):
        raise AssertionError("K1 disagrees with its twin past 2^31 elements")
    del xb, got, want
    torch.cuda.empty_cache()
    shape = (f"T={t} V={v} float32 (+ (77, 1001) bf16 dirty ids; K1 at "
             f"({tb}, {v}) f32, T*V > 2^31)")
    src = "src/repro_torch/kernels/csrc/fused_logprob.cu"
    return {
        "logprob_fwd": dict(
            name="logprob_fwd_kernel", route="cuda", source=src,
            replaces="src/repro/kernels/fused_logprob.py:53 (_fwd_kernel; "
                     "pallas_call at :98)",
            max_abs_err=max(ef, ef_r, ef_b), tol=TOL_LP, ms=ms_f,
            plain_ms=plain_f, bound_ms=bf[0], bound_by=bf[1],
            library_ms=lib_f,
            library="torch.logsumexp(x, -1): a partial yardstick (lse only)",
            shape=shape),
        "logprob_bwd": dict(
            name="logprob_bwd_kernel", route="cuda", source=src,
            replaces="src/repro/kernels/fused_logprob.py:123 (_bwd_kernel; "
                     "pallas_call at :142)",
            max_abs_err=max(eb, eb_r), max_abs_err_bf16=eb_r,
            err_ratio=max(rb, rb_r),
            tol="element-wise |err| <= rtol * scale (err_ratio <= 1), rtol "
                "1e-5 f32, 2^-7 + 1e-5 bf16",
            ms=ms_b, plain_ms=plain_b,
            bound_ms=bb[0], bound_by=bb[1], library_ms=lib_b,
            library="torch.softmax(x, -1): a partial yardstick (p only)",
            shape=shape)}


# --------------------------------------------------------------------------
# phase 3: the engine at full width


def engine_prompts(cfg, seed):
    """The serve cell's 24 prompts of 64-1536 tokens, 4 sharing a
    256-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, cfg.vocab_size, 256)
    lens = rng.integers(64, 1537, 24)
    prompts = []
    for i, n in enumerate(lens):
        if i in (0, 9, 19):                  # share a 256-token prefix
            n = max(int(n), 320)
            tail = rng.integers(3, cfg.vocab_size, n - 256)
            prompts.append(np.concatenate([prefix, tail]))
        elif i == 14:
            # the prefix alone: the cache serves 255 tokens (the last
            # prompt token is always prefilled), so admission copies the
            # partial 16th page on write
            prompts.append(prefix.copy())
        else:
            prompts.append(rng.integers(3, cfg.vocab_size, int(n)))
    return [p.astype(np.int32) for p in prompts]


def engine_phase(dev, seed, card, draws):
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              paged_attn_impl="pallas")
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    log(f"[engine] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.param_count() / 1e9:.3f}B params bf16, "
        f"init {time.perf_counter() - t0:.1f}s")
    serve = ServeConfig(num_slots=SLOTS, page_size=PAGE, prefill_chunk=512,
                        sync_every=8, max_total_tokens=2048,
                        paged_attn_impl="pallas", seed=seed)
    rl = RLConfig()                          # temperature 0.6, top-k 20, top-p 0.95
    eng = build_engine(cfg, params, serve, rl=rl, vocab_limit=cfg.vocab_size,
                       key=prng.PRNGKey(seed))
    sp = SamplingParams.from_rl(rl, max_new=64)
    prompts = engine_prompts(cfg, seed)

    # warm-up: cuBLAS handles, allocator, first launches
    eng.generate([Request(rid=1000 + i, prompt=prompts[i][:64], params=sp)
                  for i in range(2)])
    torch.cuda.synchronize()
    st0 = eng.stats()

    pa.reset_launch_counts()
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.astype(np.int32), params=sp,
                           arrival_s=t_start))
    decode_round_ms = []
    results = {}
    with RecompileSentinel("engine rounds") as shapes:
        while len(results) < len(prompts):
            before = eng.stats()
            t1 = time.perf_counter()
            for ev in eng.step():
                if ev.finished:
                    results[ev.rid] = eng.pop_result(ev.rid)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            after = eng.stats()
            if after["prefill_chunks"] == before["prefill_chunks"] and \
                    after["decode_steps"] > before["decode_steps"]:
                decode_round_ms.append(dt * 1e3 / eng.sync_every)
            if not eng.has_work() and len(results) < len(prompts):
                raise AssertionError("engine drained with requests "
                                     "unfinished")
    wall = time.perf_counter() - t_start
    shape_bound = executable_bound(eng.pages_per_slot)
    kinds = {k: sum(e[0] == k for e in shapes.events)
             for k in ("paged_decode", "paged_prefill")}
    log(f"[engine] launch-shape sentinel over the rounds: "
        f"{shapes.compiles} new launch shapes ({kinds}) against "
        f"executable_bound({eng.pages_per_slot} pages a slot) = "
        f"{shape_bound}")
    shapes.assert_bound(shape_bound, "the engine phase's rounds")
    launches = dict(pa.LAUNCHES)
    st = eng.stats()
    d_steps = st["decode_steps"] - st0["decode_steps"]
    p_chunks = st["prefill_chunks"] - st0["prefill_chunks"]
    if launches["paged_decode"] != cfg.num_layers * d_steps or \
            launches["paged_prefill"] != cfg.num_layers * p_chunks:
        raise AssertionError(f"launch counts {launches} != {cfg.num_layers} "
                             f"x ({d_steps} decode steps, {p_chunks} "
                             "prefill chunks)")
    res = [results[i] for i in range(len(prompts))]
    for r in res:
        if r.finish_reason not in ("eos", "length"):
            raise AssertionError(f"request {r.rid}: {r.finish_reason}")
        if r.gen_count < 1 or not np.isfinite(r.logps).all() \
                or (r.logps > 1e-6).any():
            raise AssertionError(f"request {r.rid}: bad logps")
        if (r.tokens < 0).any() or (r.tokens >= cfg.vocab_size).any():
            raise AssertionError(f"request {r.rid}: token out of vocab")
    hits = sum(r.prefix_hit_tokens for r in res)
    cow = st["cow_copies"] - st0["cow_copies"]
    if hits == 0 or cow == 0:
        raise AssertionError(f"prefix reuse not exercised: {hits} hit "
                             f"tokens, {cow} copy-on-write copies")
    eng.prefix_cache.clear()
    if eng.free_pages != eng.num_pages - 1 or eng.sched.allocator.in_use:
        raise AssertionError("page pool does not balance after drain")
    n_tok = sum(r.gen_count for r in res)
    ttft = statistics.median(r.ttft_s for r in res) * 1e3
    dec_ms = statistics.median(decode_round_ms) if decode_round_ms \
        else float("nan")
    log(f"[engine] 24 requests, {n_tok} tokens in {wall:.2f}s: "
        f"{n_tok / wall:.1f} tokens/s, TTFT median {ttft:.1f} ms "
        f"(queueing included), decode {dec_ms:.2f} ms/step (median of "
        f"{len(decode_round_ms)} pure-decode rounds) | {card}")
    log(f"[engine] the token draw's share of a decode step (phase 2's "
        f"8-row timings, this call): fold_in + Gumbel argmax "
        f"{draws['draw_ms']:.4f} ms = "
        f"{100 * draws['draw_ms'] / dec_ms:.2f}%, sample_token_rows "
        f"{draws['sample_ms']:.4f} ms = "
        f"{100 * draws['sample_ms'] / dec_ms:.2f}% of {dec_ms:.2f} ms; the "
        f"parent's hashed draw {draws['hashed_draw_ms']:.4f} ms = "
        f"{100 * draws['hashed_draw_ms'] / dec_ms:.2f}%, with the filters "
        f"{draws['hashed_sample_ms']:.4f} ms = "
        f"{100 * draws['hashed_sample_ms'] / dec_ms:.2f}%: threefry adds "
        f"{draws['sample_ms'] - draws['hashed_sample_ms']:.4f} ms "
        f"({100 * (draws['sample_ms'] - draws['hashed_sample_ms']) / dec_ms:.2f}"
        f"% of the step) to each step with the serve profile")
    log(f"[engine] {d_steps} decode steps, {p_chunks} prefill chunks, "
        f"launches {launches} (= {cfg.num_layers} per step/chunk), prefix "
        f"hit tokens {hits}, CoW copies {cow}, slot util "
        f"{st['slot_utilization']:.3f}")
    teacher_forced(cfg, params, dev, seed)
    profile_decode(eng, prompts, sp)
    # phase 18's host-sync twin, outside the timed window and after the
    # sentinel's check; phase 18 holds its sites against the static rule
    t0 = time.perf_counter()
    twin = sync_twin(eng, prompts, sp)
    log(f"[analysis] host-sync twin: {SYNC_TWIN_PROMPTS} requests "
        f"resubmitted, {len(twin)} engine rounds under "
        f"set_sync_debug_mode('warn'), {time.perf_counter() - t0:.2f}s; "
        f"syncs per prefill round {round_syncs(twin, 'prefill')}, per "
        f"decode round {round_syncs(twin, 'decode')}")
    return launches, twin


def profile_decode(eng, prompts, sp):
    """Trace 3 pure-decode scheduler rounds (8 slots, 24 decode steps)
    with torch.profiler; print device time by kernel and the device's busy
    share of the window's wall time (where the decode step's time goes).
    Every torch.profiler trace here records the CUDA activity alone (the
    kernels, copies and runtime calls): the CPU ops of a trace of decode
    steps or a learner step took 30 s of host time to record and read."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(eng.num_slots):
        eng.submit(Request(rid=2000 + i, prompt=prompts[i][:512].astype(
            np.int32), params=sp))
    while any(r is None or r.state != "decode" for r in eng.sched.slots):
        eng.step()
    torch.cuda.synchronize()  # noqa: RA003 — trace window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()  # noqa: RA003 — trace window
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side entries only (kernels, memcpy/memset): the CPU op that
    # launched a kernel reports the same time again
    avg = prof.key_averages()
    rows = sorted((e for e in avg
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    log(f"[profile] 24 decode steps: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall; sum of "
        f"device-side time, profiler on), {len(rows)} kernel names")
    # host-side calls that wait for the device (the last one is the
    # window's own torch.cuda.synchronize)
    waits = {e.key: e.count for e in avg
             if any(w in e.key for w in ("Synchronize", "Memcpy"))}
    log(f"[profile] host waits in the window: {waits}")
    for e in rows[:12]:
        log(f"[profile] {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    while eng.has_work():
        eng.step()


PORT_PKG = Path(__file__).resolve().parent / "src" / "repro_torch"
SYNC_TWIN_PROMPTS = 2
SYNC_WARNING = "called a synchronizing CUDA operation"


def port_frames(frame):
    """The stack's frames in ``src/repro_torch/``, innermost first, as
    (repo-relative path, line, function)."""
    out = []
    while frame is not None:
        path = Path(frame.f_code.co_filename).resolve()
        if path.is_relative_to(PORT_PKG):
            out.append((path.relative_to(PORT_PKG.parent.parent).as_posix(),
                        frame.f_lineno, frame.f_code.co_name))
        frame = frame.f_back
    return tuple(out)


def sync_twin(eng, prompts, sp):
    """The host-sync twin of the static rule RA003: resubmit
    SYNC_TWIN_PROMPTS of the engine phase's prompts and step the engine
    until they finish under ``torch.cuda.set_sync_debug_mode("warn")``.
    Every synchronizing aten op warns; each warning is mapped to the port
    frames on the stack. Returns one (round kind, [frames of each sync])
    per ``step()``, the kind "prefill" when the round ran a prefill chunk,
    else "decode". Warnings of other kinds go on to the usual handler."""
    rounds = []
    syncs = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            show(message, category, filename, lineno, file, line)
            return
        syncs.append(port_frames(sys._getframe(1)))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        show = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rids = set()
            for i in range(SYNC_TWIN_PROMPTS):
                rids.add(3000 + i)
                eng.submit(Request(rid=3000 + i, prompt=prompts[i], params=sp))
            while rids:
                before = eng.stats()["prefill_chunks"]
                syncs.clear()
                for ev in eng.step():
                    if ev.finished and ev.rid in rids:
                        rids.discard(ev.rid)
                        eng.pop_result(ev.rid)
                kind = ("prefill" if eng.stats()["prefill_chunks"] > before
                        else "decode")
                rounds.append((kind, list(syncs)))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return rounds


def round_syncs(rounds, kind):
    """The syncs of each round of ``kind``, in order."""
    return [len(syncs) for k, syncs in rounds if k == kind]


def twin_sites(rounds):
    """The sites of ``rounds``: each sync's innermost port frame."""
    return {frames[0] for _, syncs in rounds for frames in syncs if frames}


def match_twin(rounds, files, findings):
    """Each card site (the innermost port frame of a sync) with its
    count by round kind, whether its function is hot, and whether a
    static RA003 finding (noqa'd and baselined ones included) sits at its
    line. Returns (rows, the hot sites no static finding covers, the
    static RA003 sites of the package the card did not hit)."""
    by_rel = {f.rel: f for f in files}
    static = {(fd.path, fd.line) for fd in findings if fd.rule == "RA003"}
    sites = {}
    for kind, syncs in rounds:
        for frames in syncs:
            site = frames[0] if frames else None
            sites.setdefault(site, collections.Counter())[kind] += 1
    rows, unmatched = [], []
    for site, by_kind in sites.items():
        if site is None:
            rows.append((None, by_kind, False, False))
            continue
        path, line, _ = site
        f = by_rel.get(path)
        hot = f is not None and hot_function_at(f, line) is not None
        covered = (path, line) in static
        rows.append((site, by_kind, hot, covered))
        if hot and not covered:
            unmatched.append(site)
    hit = {(s[0], s[1]) for s in sites if s is not None}
    unhit = sorted(s for s in static
                   if s not in hit and s[0].startswith("src/repro_torch/"))
    return rows, unmatched, unhit


def analysis_phase(twin):
    """Phase 18: the port's static analysis over its defaults with its
    baseline (0 new, 0 stale findings), its self-test, and the host-sync
    twin's card sites held against the static RA003 sites."""
    from repro_torch.analysis.__main__ import BASELINE, default_paths, \
        selftest
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    files = collect_files(default_paths(root), root=root)
    found = run_rules(files, keep_suppressed=True)
    by_rel = {f.rel: f for f in files}
    live = [fd for fd in found
            if not by_rel[fd.path].suppressed(fd.rule, fd.line)]
    new, stale = apply_baseline(live, load_baseline(root / BASELINE))
    noqa = collections.Counter(fd.rule for fd in found
                               if by_rel[fd.path].suppressed(fd.rule,
                                                             fd.line))
    log(f"[analysis] python -m repro_torch.analysis: {len(files)} files, "
        f"{len(new)} new findings, {len(stale)} stale baseline entries, "
        f"{len(live)} baselined, noqa'd sites {dict(sorted(noqa.items()))}"
        f", {time.perf_counter() - t0:.2f}s")
    for fd in new:
        log(f"[analysis]   {fd.render()}")
    if new or stale:
        raise AssertionError(f"static analysis: {len(new)} new findings, "
                             f"stale baseline entries {stale}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = selftest()
    log(f"[analysis] {out.getvalue().strip().splitlines()[-1]}")
    if rc != 0:
        raise AssertionError("the analysis self-test failed")
    rows, unmatched, unhit = match_twin(twin, files, found)
    unread = {s[0] for s in twin_sites(twin) if s[0] not in by_rel}
    if unread:
        raise AssertionError(f"the analysis did not read the twin's "
                             f"files {sorted(unread)}")
    for site, by_kind, hot, covered in sorted(
            rows, key=lambda r: -sum(r[1].values())):
        where = ("outside the port" if site is None
                 else f"{site[0]}:{site[1]} {site[2]}")
        verdict = ("not hot: printed, not held" if not hot
                   else "static RA003 site" if covered
                   else "NO static RA003 site")
        log(f"[analysis]   card sync site {where}: "
            f"{dict(sorted(by_kind.items()))} syncs ({verdict})")
    log(f"[analysis] static RA003 sites in src/repro_torch the card did "
        f"not hit (the rule is conservative): "
        + (", ".join(f"{p}:{n}" for p, n in unhit) or "none"))
    if unmatched:
        raise AssertionError(f"card sync sites in hot functions with no "
                             f"static RA003 finding: {unmatched}")


def teacher_forced(cfg, params, dev, seed):
    """One 512-token prefill chunk plus 8 forced decode steps through the
    kernels and through the twins, on copies of one pool."""
    rng = np.random.default_rng(seed + 1)
    c, steps = 512, 8
    width = -(-(c + steps) // PAGE)
    pool = init_paged_pool(cfg, width + 2, PAGE, device=dev)
    for layer in pool.values():
        for leaf in layer["self"].values():
            leaf[:, 0] = float("nan")
    pools = {"pallas": pool,
             "ref": {k: {"self": {n: t.clone() for n, t in v["self"].items()}}
                     for k, v in pool.items()}}
    table = torch.arange(1, width + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, c + steps)
                            ).to(dev)
    logits = {}
    for impl in ("pallas", "ref"):
        icfg = dataclasses.replace(cfg, paged_attn_impl=impl)
        with torch.no_grad():
            lg, _, _ = forward(icfg, params, toks[None, :c],
                               positions=torch.arange(c, device=dev)[None],
                               cache=pools[impl], page_table=table)
            rows = [lg[0, -1]]
            for i in range(steps):
                lg1, _ = decode_step(icfg, params, pools[impl],
                                     toks[c + i:c + i + 1],
                                     torch.tensor([c + i], device=dev),
                                     page_table=table)
                rows.append(lg1[0])
        logits[impl] = (lg[0], torch.stack(rows))
    torch.cuda.synchronize()
    err_p = float((logits["pallas"][0] - logits["ref"][0]).abs().max())
    err_d = float((logits["pallas"][1] - logits["ref"][1]).abs().max())
    scale = float(logits["ref"][0].abs().max())
    agree = float((logits["pallas"][1].argmax(-1)
                   == logits["ref"][1].argmax(-1)).float().mean())
    log(f"[teacher-forced] max|logit diff| prefill {err_p:.3e}, decode "
        f"{err_d:.3e} (tol {TOL_LOGITS}, max|logit| {scale:.2f}); greedy "
        f"agreement {agree:.3f} (information only)")
    for part in logits.values():
        if not all(torch.isfinite(t).all() for t in part):
            raise AssertionError("teacher-forced logits not finite")
    if max(err_p, err_d) > TOL_LOGITS:
        raise AssertionError("pallas and ref logits disagree")


# --------------------------------------------------------------------------
# phase 2, K5: dense flash attention at the slice's shapes

# (label, B, S, Hq, Hkv, D, causal, window, softcap, dtype, timed)
FLASH_CASES = (
    ("qwen3 static prefill", 16, PROMPT_LEN, 16, 8, 128, True, None, None,
     torch.bfloat16, True),
    ("qwen3 recompute", 16, PROMPT_LEN + NEW_TOKENS - 1, 16, 8, 128, True,
     None, None, torch.bfloat16, True),
    ("gemma2 local", 1, GEMMA_LEN, 16, 8, 256, True, 4096, 50.0,
     torch.bfloat16, True),
    ("gemma2 global", 1, GEMMA_LEN, 16, 8, 256, True, None, 50.0,
     torch.bfloat16, True),
    ("bidir f32", 2, 37, 16, 8, 128, False, None, None, torch.float32,
     False),
    ("D 64 bf16", 2, 160, 8, 2, 64, True, None, None, torch.bfloat16,
     False),
)


def flash_pairs(s, causal, window):
    """(row, column) pairs the mask keeps, summed over the rows of one
    head: what the kernel's reach-bounded loop must compute."""
    if not causal:
        return s * s
    w = s if window is None else window
    return sum(min(r + 1, w) for r in range(s))


def sdpa_flash(q, k, v, causal, window):
    """Library yardstick: SDPA with GQA, causal, or with a boolean band
    for the window (no softcap: partial where the case has one). Setup
    (layout) not timed."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = {}
    if causal and window is not None:
        r = torch.arange(q.shape[1], device=q.device)
        d = r[:, None] - r[None, :]
        kw["attn_mask"] = (d >= 0) & (d < window)
    elif causal:
        kw["is_causal"] = True
    return library_ms(qt, kt, vt, iters=5, enable_gqa=True, **kw)


def flash_f32_row(q, k, v, kw, flops):
    """K5's float32 route (the CUDA-core body) on float32 copies of a
    case's inputs: held to TOL_FLASH[float32] against the twin and timed
    beside its float32 bound."""
    f32 = [t.float() for t in (q, k, v)]
    err = max_err(fa.flash_attention(*f32, **kw),
                  fa.flash_attention_ref(*f32, **kw))
    if not err <= TOL_FLASH[torch.float32]:
        raise AssertionError(f"K5's float32 route disagrees with its twin: "
                             f"{err:.3e}")
    b_ms, b_by = bound(4 * (2 * q.numel() + k.numel() + v.numel()), flops,
                       F32_FLOPS_S)
    ms = time_ms(lambda: fa.flash_attention(*f32, **kw), iters=10)
    dev_ms = device_ms(lambda: fa.flash_attention(*f32, **kw), iters=10)
    lib_ms = sdpa_flash(*f32, kw["causal"], kw["window"])
    log(f"[kernels] K5 float32 route: {ms:.4f} ms (device {dev_ms:.4f}), "
        f"bound {b_ms:.4f} ms ({b_by}), SDPA float32 {lib_ms:.4f} ms, "
        f"max|err| {err:.3e} (tol {TOL_FLASH[torch.float32]})")
    return dict(ms_f32=ms, device_ms_f32=dev_ms, bound_ms_f32=b_ms,
                bound_by_f32=b_by, library_ms_f32=lib_ms,
                max_abs_err_f32_timed=err)


def flash_phase(dev, seed):
    """K5 against its twin at six cases (the static prefill, the
    recompute, Gemma2's local and global layers, a bidir float32 case, a
    bf16 case at D 64), with controls for the window and the softcap;
    the four main-path cases timed beside the twin, SDPA and the bound."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    rows = []
    for (label, b, s, hq, hkv, d, causal, window, cap, dtype,
         timed) in FLASH_CASES:
        q = torch.randn((b, s, hq, d), generator=gen, device=dev)
        if cap is not None:
            q = q * Q_SCALE_CAPPED
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
                for _ in range(2))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        f32 = [t.float() for t in (q, k, v)]
        kw = dict(causal=causal, window=window, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_ref(*f32, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = TOL_FLASH[dtype]
        controls = {}
        if window is not None:
            controls["no window"] = max_err(fa.flash_attention_ref(
                *f32, causal=causal, softcap=cap), want)
        if cap is not None:
            controls["no softcap"] = max_err(fa.flash_attention_ref(
                *f32, causal=causal, window=window), want)
        del want
        log(f"[kernels] K5 flash_attention {label} (B {b}, S {s}, Hq {hq}, "
            f"Hkv {hkv}, D {d}, causal {causal}, window {window}, softcap "
            f"{cap}, {str(dtype)[6:]}): max|err| {err:.3e} (tol {tol})"
            + "".join(f"; twin vs twin {c} {e:.3e} (must be > {10 * tol})"
                      for c, e in controls.items()))
        if not err <= tol or not torch.isfinite(got.float()).all():
            raise AssertionError(f"K5 disagrees with its twin ({label})")
        if not all(e > 10 * tol for e in controls.values()):
            raise AssertionError(f"K5's check cannot see a dropped mask "
                                 f"({label}): {controls}")
        row = dict(case=label, max_abs_err=err, tol=tol, controls=controls,
                   shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal="
                         f"{causal} window={window} softcap={cap} "
                         f"{str(dtype)[6:]}")
        if timed:
            nbytes = q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel())
            flops = 4 * d * hq * b * flash_pairs(s, causal, window)
            b_ms, b_by = bound(nbytes, flops)
            row.update(
                ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw),
                           iters=10),
                plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                                **kw),
                                 iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=sdpa_flash(q, k, v, causal, window))
            log(f"[kernels] K5 {label}: {row['ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), twin {row['plain_ms']:.3f} ms, "
                f"SDPA {row['library_ms']:.4f} ms"
                + (" (partial: no softcap)" if cap else ""))
            if not rows:             # the first case: the float32 route too
                row.update(flash_f32_row(q, k, v, kw, flops))
        rows.append(row)
        del q, k, v, f32, got
        torch.cuda.empty_cache()
    head = rows[0]
    return {"flash_attention": dict(
        name="flash_attention_tc_kernel", name_f32="flash_attention_kernel",
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        sources=["src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro_torch/kernels/csrc/attention_tc.cuh"],
        replaces="src/repro/kernels/flash_attention.py:39 (_kernel; "
                 "pallas_call at :119): bf16 on the tensor cores "
                 "(attention_tc.cuh), float32 on the CUDA cores",
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if r["tol"] == TOL_FLASH[torch.bfloat16]),
        max_abs_err_f32=max(r["max_abs_err"] for r in rows
                            if r["tol"] == TOL_FLASH[torch.float32]),
        tol=TOL_FLASH[torch.bfloat16], ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        ms_f32=head["ms_f32"], device_ms_f32=head["device_ms_f32"],
        bound_ms_f32=head["bound_ms_f32"], bound_by_f32=head["bound_by_f32"],
        library_ms_f32=head["library_ms_f32"],
        library="SDPA (GQA; causal, or a boolean band for the window; no "
                "softcap)", shape=head["shape"], cases=rows)}


# --------------------------------------------------------------------------
# phase 2, K6: the Mamba2 SSD chunk scan at mamba2-1.3b's layer shapes

# (label, B, S, H, P, G, N, chunk, dtype, timed)
SSD_CASES = (
    ("mamba2 recompute", 16, PROMPT_LEN + NEW_TOKENS, 64, 64, 1, 128, 256,
     torch.bfloat16, True),
    ("mamba2 long", 1, GEMMA_LEN, 64, 64, 1, 128, 256, torch.bfloat16, True),
    ("f32 G 2", 2, 512, 8, 64, 2, 64, 128, torch.float32, False),
    ("mamba2 recompute f32", 16, PROMPT_LEN + NEW_TOKENS, 64, 64, 1, 128,
     256, torch.float32, True),
)
# the float32 route's three kernels, by step (csrc/ssd_scan.cu)
SSD_F32_STEPS = {"A": "ssd_state_kernel", "B": "ssd_pass_kernel",
                 "C": "ssd_chunk_scan_kernel"}


def ssd_inputs(gen, dev, b, s, h, p, g, n, dtype):
    """x, b, c ~ N(0, 1) in ``dtype``; dt in [0.01, 0.1] and a in [-0.1,
    -0.01] in float32 (dt and a as mamba_block hands them to K6): slow
    decay, so the state carried across chunks is a large part of y."""
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = 0.01 + 0.09 * torch.rand((b, s, h), generator=gen, device=dev)
    a = -(0.01 + 0.09 * torch.rand((h,), generator=gen, device=dev))
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    return x, dt, a, bm, cm


def ssd_twin(args, chunk):
    x, dt, a, bm, cm = args
    return ss.ssd_scan_ref(x.float(), dt, a, bm.float(), cm.float(),
                           chunk=chunk)


def ssd_flops(b, s, h, p, g, n, lc):
    """2 pairs N per (batch, group, chunk), pairs = the L (L + 1) / 2 (t,
    s) pairs of the causal mask: the scores C_t B_s, which the heads of a
    B/C group share (only the decay exp(cum_t - cum_s) is per head); 2
    pairs P per (batch, head, chunk): the masked scores' product with u;
    and 2 L N P per (batch, head) for each of the carried state's term
    and the state update on all chunks but one (chunk 0 enters with a
    zero state, the last chunk's end state is never read)."""
    pairs, nc = lc * (lc + 1) // 2, s // lc
    return (2 * pairs * (n * g + p * h) * b * nc
            + 2 * 2 * lc * n * p * b * h * (nc - 1))


def ssd_steps_ms(fn, iters: int = 10, steps=SSD_F32_STEPS) -> dict:
    """Device ms of each step of K6's float32 route in one ``fn()`` call:
    the profiler's kernel time by name (``steps``: step -> a part of its
    kernel's name) over ``iters`` calls, over ``iters``. Steps B and C are
    launched while the step before them drains, so their spans include
    their wait for it: the spans overlap, and their sum is more than the
    call's time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()  # noqa: RA003 — timing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()  # noqa: RA003 — timing
    rows = prof.key_averages()
    return {step: sum(dev_us(e) for e in rows if name in e.key) / 1e3 / iters
            for step, name in steps.items()}


def ssd_row(gen, dev, label, b, s, h, p, g, n, chunk, dtype, timed):
    """K6 against its twin on ``ssd_inputs`` of one shape, element by
    element, with the control (the twin chunk by chunk, without the
    carried state) that the check must reject; timed beside the twin and
    the bound when ``timed``. Returns the row."""
    args = ssd_inputs(gen, dev, b, s, h, p, g, n, dtype)
    got = ss.ssd_scan(*args, chunk=chunk)
    want = ssd_twin(args, chunk)
    torch.cuda.synchronize()
    ratio = ss.error_ratio(got, want)
    err = max_err(got, want)
    cut = torch.cat([ssd_twin([t[:, c0:c0 + chunk] if t.dim() > 1 else t
                               for t in args], chunk)
                     for c0 in range(0, s, chunk)], 1)
    control = ss.error_ratio(cut.to(dtype), want)
    del cut
    splits = (ss.f32_plan(b, s, h, g, p, n, min(chunk, s)).nsplit
              if dtype == torch.float32 else
              ss.p_splits(b * h, p, torch.cuda.get_device_properties(
                  dev).multi_processor_count))
    log(f"[kernels] K6 ssd_scan {label} (B {b}, S {s}, H {h}, P {p}, G "
        f"{g}, N {n}, chunk {chunk}, {str(dtype)[6:]}, {splits} P "
        f"slice(s) per head): max|err| {err:.3e} (max|y| "
        f"{float(want.abs().max()):.3e}), error ratio {ratio:.3e} (must "
        f"be <= 1: |err| <= {ss.RTOL[dtype]:.3g} |y| + {ss.ATOL_REL} "
        f"max|y|); twin without the carried state {control:.3e} (must "
        f"be > 100)")
    if not ratio <= 1.0:
        raise AssertionError(f"K6 disagrees with its twin ({label})")
    if not control > 100.0:
        raise AssertionError(f"K6's check cannot see a dropped "
                             f"inter-chunk term ({label})")
    row = dict(case=label, max_abs_err=err, error_ratio=ratio,
               control_ratio=control, p_slices=splits,
               shape=f"B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk} "
                     f"{str(dtype)[6:]}")
    if timed:
        es = args[0].element_size()
        nbytes = (2 * args[0].numel() * es + args[1].numel() * 4
                  + args[2].numel() * 4 + 2 * args[3].numel() * es)
        b_ms, b_by = bound(nbytes, ssd_flops(b, s, h, p, g, n,
                                             min(chunk, s)),
                           F32_FLOPS_S if dtype == torch.float32
                           else BF16_FLOPS_S)
        row.update(
            ms=time_ms(lambda: ss.ssd_scan(*args, chunk=chunk),
                       iters=10),
            plain_ms=time_ms(lambda: ssd_twin(args, chunk), iters=3,
                             warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"[kernels] K6 {label}: {row['ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), twin {row['plain_ms']:.3f} ms, "
            f"library: none (no single PyTorch call computes an SSD "
            f"scan)")
        if dtype == torch.float32:
            row["steps_ms"] = ssd_steps_ms(
                lambda: ss.ssd_scan(*args, chunk=chunk))
            log(f"[kernels] K6 {label}: {100 * b_ms / row['ms']:.1f}% of "
                f"the bound; device spans " + ", ".join(
                    f"step {k} {v:.4f}" for k, v in row["steps_ms"].items())
                + " ms (B and C start while the step before them drains: "
                "their spans include that wait)")
    del args, got, want
    torch.cuda.empty_cache()
    return row


def ssd_phase(dev, seed):
    """K6 against its twin at mamba2-1.3b's recompute shape (B 16, S 1024)
    in bf16 and float32, at B 1, S 8192 in bf16, and at a float32 case
    with two B/C groups; a control (the twin chunk by chunk, i.e. without
    the carried state) that the check must reject; the mamba2 cases timed
    beside the twin and the bound, the float32 one by step too."""
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    rows = [ssd_row(gen, dev, *case) for case in SSD_CASES]
    head, f32 = rows[0], rows[-1]
    return {"ssd_scan": dict(
        name="ssd_scan_tc_kernel",
        name_f32="ssd_state_kernel + ssd_pass_kernel + ssd_chunk_scan_kernel",
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:21 (_kernel; pallas_call "
                 "at :87): bf16 on the tensor cores (hi + lo operands), "
                 "float32 on the CUDA cores in three chunk-parallel steps",
        ms_f32=f32["ms"], steps_ms_f32=f32["steps_ms"],
        plain_ms_f32=f32["plain_ms"],
        bound_ms_f32=f32["bound_ms"], bound_by_f32=f32["bound_by"],
        library_ms_f32=None, shape_f32=f32["shape"],
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if "bfloat16" in r["shape"]),
        max_abs_err_f32=max(r["max_abs_err"] for r in rows
                            if "float32" in r["shape"]),
        error_ratio=max(r["error_ratio"] for r in rows),
        tol="error ratio <= 1 (ssd_scan.error_ratio)", ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        library="none: no single PyTorch call computes an SSD scan",
        shape=head["shape"], cases=rows)}


# --------------------------------------------------------------------------
# phase 2, widths: K3-K6 at every shape their TPU kernels take. Each width
# runs a body instantiated at a padded width (kernels/csrc/*.cu); every row
# holds the kernel against its twin at the bar its dtype already has (K3
# and K4: TOL_BF16 / TOL_F32; K5: TOL_FLASH; K6: ss.error_ratio <= 1)

# the repo's own models' and tests' head dims (bench-lm 24, serve-bench and
# spec-lm 32, the tests' TINYs 16 and 12), bf16 rows that are not 16-byte
# aligned (D 12, 20: the element-load staging) and padded widths past 64
WIDTH_DS = (12, 16, 20, 24, 32, 80, 96)
# (B, S, H, P, G, N, chunk): the reference's K6 sweep (tests/test_kernels.py,
# chunk 32; its bf16 test takes the first) and P 24 x N 48
SSD_WIDTH_CASES = ((1, 64, 2, 16, 1, 8, 32), (2, 128, 4, 32, 2, 16, 32),
                   (1, 256, 8, 64, 1, 32, 32), (2, 256, 4, 24, 2, 48, 64))
# the timed rows: float32 (the repo's small models' dtype) at D 32 and
# serve-bench's heads (Hq 8, Hkv 4); K6 at P 32, N 48
W_HQ, W_HKV, W_D = 8, 4, 32
W_SSD = (8, 1024, 16, 32, 1, 48, 256)


def width_errs(rows, key="max_abs_err"):
    """(max over the bf16 rows, max over the float32 rows) of ``key``."""
    return tuple(max((r[key] for r in rows if r["dtype"] == dt),
                     default=0.0) for dt in ("bfloat16", "float32"))


def k3_width_rows(gen, dev):
    """K3 at every D of WIDTH_DS in both dtypes (plain and window 100 +
    softcap 30, a dead slot and the NaN scratch page), and at the
    reference's own case (tests/test_paged_attention.py::make_case: B 4,
    Hkv 2, rep 4, D 32, page 8, lengths in [1, 48])."""
    rows = []
    width = 512 // PAGE
    lengths = [512, 300, 17, 1, width * PAGE + 1]
    cases = [(d, dict(hq=8, hkv=2, d=d), lengths, width) for d in WIDTH_DS]
    ref_len = np.random.default_rng(0).integers(1, 49, 4).tolist()
    cases.append(("ref make_case", dict(hq=8, hkv=2, d=32, page=8), ref_len,
                  6))
    for label, kw, lens_, w in cases:
        case = decode_case(gen, dev, lens_, w, **kw)
        page = kw.get("page", PAGE)
        live = [i for i, n in enumerate(lens_) if n <= w * page]
        for dt in (torch.bfloat16, torch.float32):
            q, kp, vp = (t.to(dt) for t in case[:3])
            table, lens = case[3], case[4]
            f32 = [t.float() for t in (q, kp, vp)]
            err = 0.0
            for opt in ({}, dict(window=100, softcap=30.0)):
                got = pa.paged_attention(q, kp, vp, table, lens, **opt)
                want = pa.paged_decode_ref(*f32, table, lens, **opt)
                err = max(err, max_err(got, want, live))
            tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
            rows.append(dict(case=f"D {label}" if isinstance(label, int)
                             else label, d=kw["d"], dtype=str(dt)[6:],
                             max_abs_err=err, tol=tol))
            if not err <= tol:
                raise AssertionError(f"K3 at {label} {dt} disagrees with "
                                     f"its twin: {err:.3e}")
    return rows


def k4_width_rows(gen, dev):
    """K4 at every D of WIDTH_DS in both dtypes at the ragged C 77 after
    300 keys (plain and local window 100 + softcap 30), and at the
    reference's own case (make_prefill_case: B 3, C 8, Hkv 2, rep 4, D 32,
    page 8, starts in [0, 40])."""
    rows = []
    cases = []
    for d in WIDTH_DS:
        q, kp, vp, table, pos = prefill_case(gen, dev, 77, 300, 8, 2, d=d)
        cases.append((f"D {d} C 77", d, q, kp, vp, table, pos))
    rng = np.random.default_rng(1)
    q, kp, vp, table, _ = decode_case(gen, dev, [48] * 3, 6, 8, 2, d=32,
                                      page=8)
    starts = torch.tensor(rng.integers(0, 41, 3), device=dev)
    q = torch.randn((3, 8, 8, 32), generator=gen, device=dev)
    pos = starts[:, None] + torch.arange(8, device=dev)
    cases.append(("ref make_prefill_case", 32, q, kp, vp, table, pos))
    for label, d, q, kp, vp, table, pos in cases:
        for dt in (torch.bfloat16, torch.float32):
            qq, kk, vv = (t.to(dt) for t in (q, kp, vp))
            f32 = [t.float() for t in (qq, kk, vv)]
            err = 0.0
            for opt in ({}, dict(kind="local", window=100, softcap=30.0)):
                got = ops.paged_prefill(qq, kk, vv, table, pos,
                                        impl="pallas", **opt)
                want = ops.paged_prefill(*f32, table, pos, impl="ref",
                                         **opt)
                err = max(err, max_err(got, want))
            tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
            rows.append(dict(case=label, d=d, dtype=str(dt)[6:],
                             max_abs_err=err, tol=tol))
            if not err <= tol:
                raise AssertionError(f"K4 at {label} {dt} disagrees with "
                                     f"its twin: {err:.3e}")
    return rows


def k5_width_rows(gen, dev):
    """K5 at every D of WIDTH_DS in both dtypes at the ragged S 160 (B 2,
    Hq 8, Hkv 2; causal, and window 50 + softcap 30)."""
    rows = []
    for d in WIDTH_DS:
        base = [torch.randn((2, 160, h, d), generator=gen, device=dev)
                for h in (8, 2, 2)]
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in base)
            f32 = [t.float() for t in (q, k, v)]
            err = 0.0
            for kw in (dict(causal=True),
                       dict(causal=True, window=50, softcap=30.0)):
                err = max(err, max_err(fa.flash_attention(q, k, v, **kw),
                                       fa.flash_attention_ref(*f32, **kw)))
            tol = TOL_FLASH[dt]
            rows.append(dict(case=f"D {d} S 160", d=d, dtype=str(dt)[6:],
                             max_abs_err=err, tol=tol))
            if not err <= tol:
                raise AssertionError(f"K5 at D {d} {dt} disagrees with its "
                                     f"twin: {err:.3e}")
    return rows


def k6_width_rows(gen, dev):
    """K6 at the reference's sweep shapes and P 24 x N 48, both dtypes."""
    rows = []
    for b, s, h, p, g, n, chunk in SSD_WIDTH_CASES:
        for dt in (torch.bfloat16, torch.float32):
            args = ssd_inputs(gen, dev, b, s, h, p, g, n, dt)
            got = ss.ssd_scan(*args, chunk=chunk)
            want = ssd_twin(args, chunk)
            ratio = ss.error_ratio(got, want)
            rows.append(dict(case=f"B {b} S {s} H {h} P {p} G {g} N {n} "
                                  f"chunk {chunk}", d=p, dtype=str(dt)[6:],
                             max_abs_err=max_err(got, want),
                             error_ratio=ratio))
            if not ratio <= 1.0:
                raise AssertionError(f"K6 at {rows[-1]['case']} {dt} "
                                     f"disagrees with its twin: {ratio:.3e}")
    return rows


def width_timed(gen, dev):
    """One timed row per kernel at D 32 (K6: P 32, N 48), float32: the
    kernel, its twin, the card's bound and the library call."""
    f32b = 4
    out = {}
    width = 2048 // PAGE
    lengths = [2048, 1537, 1024, 700, 333, 64, 1, width * PAGE + 1]
    q, kp, vp, table, lens = (t.float() if t.is_floating_point() else t
                              for t in decode_case(gen, dev, lengths, width,
                                                   W_HQ, W_HKV, d=W_D))
    keys = [n for n in lengths if n <= width * PAGE]
    nbytes = (sum(-(-n // PAGE) * PAGE for n in keys) * W_HKV * W_D * 2
              * f32b + 2 * q.numel() * f32b + table.numel() * 4
              + 4 * len(lengths))
    b_ms, b_by = bound(nbytes, sum(4 * W_HQ * W_D * n for n in keys),
                       F32_FLOPS_S)
    out["paged_decode"] = dict(
        shape=f"B={len(lengths)} Hq={W_HQ} Hkv={W_HKV} D={W_D} page={PAGE} "
              f"lengths={lengths} float32",
        ms=time_ms(lambda: pa.paged_attention(q, kp, vp, table, lens)),
        plain_ms=time_ms(lambda: pa.paged_decode_ref(q, kp, vp, table,
                                                     lens), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms(*sdpa_decode(q, kp, vp, table, lens)))
    c, start = 512, 1024
    q, kp, vp, table, pos = (t.float() if t.is_floating_point() else t
                             for t in prefill_case(gen, dev, c, start, W_HQ,
                                                   W_HKV, d=W_D))
    kv = -(-(start + c) // PAGE) * PAGE * W_HKV * W_D * 2
    b_ms, b_by = bound(kv * f32b + 2 * q.numel() * f32b + table.numel() * 4,
                       sum(4 * W_HQ * W_D * (start + i + 1)
                           for i in range(c)), F32_FLOPS_S)
    splits = pa.K4_F32_SPLITS
    out["paged_prefill"] = dict(
        shape=f"B=1 C={c} start={start} Hq={W_HQ} Hkv={W_HKV} D={W_D} "
              f"page={PAGE} float32 (the C entry at the plan's split of "
              f"{splits} {k4_f32_ms(q, kp, vp, table, pos, splits):.4f} ms, "
              f"unsplit {k4_f32_ms(q, kp, vp, table, pos, 1):.4f} ms)",
        ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                             impl="pallas")),
        device_ms=device_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                                      impl="pallas")),
        plain_ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                                   impl="ref"), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms(*sdpa_prefill(q, kp, vp, table, pos)))
    b, s = 16, PROMPT_LEN
    q, k, v = (torch.randn((b, s, h, W_D), generator=gen, device=dev)
               for h in (W_HQ, W_HKV, W_HKV))
    b_ms, b_by = bound(f32b * (2 * q.numel() + k.numel() + v.numel()),
                       4 * W_D * W_HQ * b * flash_pairs(s, True, None),
                       F32_FLOPS_S)
    out["flash_attention"] = dict(
        shape=f"B={b} S={s} Hq={W_HQ} Hkv={W_HKV} D={W_D} causal float32",
        ms=time_ms(lambda: fa.flash_attention(q, k, v), iters=10),
        device_ms=device_ms(lambda: fa.flash_attention(q, k, v), iters=10),
        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), iters=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=sdpa_flash(q, k, v, True, None))
    b, s, h, p, g, n, chunk = W_SSD
    args = ssd_inputs(gen, dev, b, s, h, p, g, n, torch.float32)
    nbytes = (2 * args[0].numel() + args[1].numel() + args[2].numel()
              + 2 * args[3].numel()) * f32b
    b_ms, b_by = bound(nbytes, ssd_flops(b, s, h, p, g, n, chunk),
                       F32_FLOPS_S)
    steps = ssd_steps_ms(lambda: ss.ssd_scan(*args, chunk=chunk))
    out["ssd_scan"] = dict(
        shape=f"B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk} float32 "
              f"(steps A/B/C device spans " + "/".join(
                  f"{v:.4f}" for v in steps.values()) + " ms)",
        ms=time_ms(lambda: ss.ssd_scan(*args, chunk=chunk), iters=10),
        steps_ms=steps,
        plain_ms=time_ms(lambda: ssd_twin(args, chunk), iters=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def width_phase(dev, seed):
    """Phase 2's width rows: K3, K4, K5 at D 12 ... 96 and the reference's
    paged cases, K6 at the reference's sweep and P 24 x N 48, each in bf16
    and float32 against its twin, and one timed float32 row per kernel at
    D 32. Returns {kernel: {"rows": [...], "timed": {...}}}."""
    gen = torch.Generator(device=dev).manual_seed(seed + 28)
    rows = {"paged_decode": k3_width_rows(gen, dev),
            "paged_prefill": k4_width_rows(gen, dev),
            "flash_attention": k5_width_rows(gen, dev),
            "ssd_scan": k6_width_rows(gen, dev)}
    torch.cuda.synchronize()
    timed = width_timed(gen, dev)
    out = {}
    for name, rs in rows.items():
        t = timed[name]
        key = "error_ratio" if name == "ssd_scan" else "max_abs_err"
        e16, e32 = width_errs(rs, key)
        log(f"[widths] {name}: {len(rs)} rows (D or P "
            f"{sorted({r['d'] for r in rs})}, bf16 and float32) against the "
            f"twin, max {key} bf16 {e16:.3e}, float32 {e32:.3e}; timed "
            f"{t['shape']}: {t['ms']:.4f} ms"
            + (f" (device {t['device_ms']:.4f})" if "device_ms" in t else "")
            + f", bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), twin {t['plain_ms']:.3f} ms, library "
            + ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms"))
        out[name] = dict(rows=rs, timed=t)
    return out


# --------------------------------------------------------------------------
# phases 4 and 5: the static engine and the recompute through K5, qwen3 and
# gemma2 at full width


# the bf16 bodies of K5, K4 and K6 (tensor-core products, no spills) and
# their instantiations: D 64, 128, 256 and the 16 padded widths (multiples
# of 16) for K5 and K4; P slice 16, 32, 64 x N 16, 32, 64, 128 for K6,
# exact and padded
TC_KERNELS = {"flash_attention_tc_kernel": 19, "paged_prefill_tc_kernel": 19,
              "ssd_scan_tc_kernel": 24}


def ssd_f32_check(report) -> None:
    """K6's float32 route: every instantiation of its three kernels (P
    slice 16/32/64 x N 16/32/64/128, exact and padded, for steps A and C;
    one step B) built, and 0 spill bytes in the ptxas report."""
    for kern, count in {"ssd_state_kernel": 24, "ssd_pass_kernel": 1,
                        "ssd_chunk_scan_kernel": 24}.items():
        rs = [r for n, r in report.items() if kern in n]
        regs = sorted({r.get("registers") for r in rs}) or [None]
        spills = [r for r in rs if r.get("spill_stores") != 0
                  or r.get("spill_loads") != 0]
        log(f"[build] {kern}: {len(rs)} instantiations (want {count}), "
            f"registers {regs[0]}-{regs[-1]}, {len(spills)} spilling")
        if len(rs) != count or spills:
            raise AssertionError(f"{kern}: {len(rs)} instantiations or a "
                                 f"spill")


def tensor_core_check(built) -> None:
    """Every instantiation of the bf16 K5/K4/K6 bodies has HMMA (or HGMMA)
    instructions in its SASS and 0 spill bytes in the ptxas report; K6's
    float32 kernels spill nothing."""
    report = build.ptxas_report(built.log)
    ssd_f32_check(report)
    sass = build.sass_functions(built.path, [
        n for n in report if any(k in n for k in TC_KERNELS)])
    for kern, count in TC_KERNELS.items():
        names = [n for n in sass if kern in n]
        if len(names) != count:
            raise AssertionError(f"{kern}: {len(names)} instantiations, "
                                 f"want {count}")
        for n in names:
            r = report.get(n, {})
            mma = sass[n].count("HMMA") + sass[n].count("HGMMA")
            log(f"[build] {kern} {n[n.index(kern) + len(kern):][:15]}: "
                f"{mma} HMMA/HGMMA, {r.get('registers')} registers, spills "
                f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes")
            if not mma or r.get("spill_stores") != 0 \
                    or r.get("spill_loads") != 0:
                raise AssertionError(f"{n}: no tensor-core product or a "
                                     f"spill")


# the float32 bodies' launches (the wrappers' F32_LAUNCHES) over the
# windows whose launches the script reads through counts(): each read adds
# what the window launched since its last read, reset_counts() opens a new
# window. The rank processes' tallies are added to the main process's.
F32_BODIES = {"paged_prefill": pa, "flash_attention": fa, "ssd_scan": ss}
F32_TALLY = {k: 0 for k in F32_BODIES}
_F32_SEEN: dict = {}


def reset_counts():
    for mod in (fa, fl, pa, ss):
        mod.reset_launch_counts()
    _F32_SEEN.clear()


def counts():
    for k, mod in F32_BODIES.items():
        n, seen = mod.F32_LAUNCHES[k], _F32_SEEN.get(k, 0)
        F32_TALLY[k] += n - seen if n >= seen else n
        _F32_SEEN[k] = n
    return {**fa.LAUNCHES, **fl.LAUNCHES, **pa.LAUNCHES, **ss.LAUNCHES}


def recompute(cfg, params, tokens, impl, want, memory=None):
    """``token_logps`` through attention ``impl`` (cross-attending
    ``memory``, if given); checks the launch counts the run made and
    returns (logps, ms, K5 launches counted)."""
    icfg = dataclasses.replace(cfg, attn_impl=impl)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = token_logps(icfg, params, tokens, memory=memory)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    if got["flash_attention"] != want or got["logprob_fwd"] != 1:
        raise AssertionError(f"recompute ({impl}) launched {got}, want K5 "
                             f"{want} and K1 1")
    if not torch.isfinite(lp).all():
        raise AssertionError(f"recompute ({impl}): non-finite logps")
    return lp, ms, got["flash_attention"]


def profile_static_decode(cfg, params, cache, tok, steps=8):
    """torch.profiler over ``steps`` dense-cache decode steps of the
    static engine's batch (16 rows after the 832-token prefill): device
    busy share and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    decode_step(cfg, params, cache, tok, PROMPT_LEN)        # warm
    torch.cuda.synchronize()  # noqa: RA003 — trace window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            decode_step(cfg, params, cache, tok, PROMPT_LEN + t)
        torch.cuda.synchronize()  # noqa: RA003 — trace window
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    log(f"[profile] {steps} static decode steps (B {tok.shape[0]}): wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall; profiler on), "
        f"{sum(e.count for e in rows)} device launches")
    for e in rows[:8]:
        log(f"[profile] {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")


def static_phase(dev, seed, card):
    """The sampler node's default engine at the learner's rollout shape:
    16 requests of 832 tokens, 192 new, temperature 1.0, prefill through
    K5; then the App. B.1 recompute through K5 and through the chunked
    attention, in turns."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_impl="pallas")
    params = init_params(cfg, seed + 3, device=dev)
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0,
                  max_new_tokens=NEW_TOKENS)
    eng = build_engine(cfg, params, ServeConfig(engine="static", seed=seed),
                       rl=rl, vocab_limit=cfg.vocab_size,
                       key=prng.PRNGKey(seed))
    sp = SamplingParams.from_rl(rl)
    rng = np.random.default_rng(seed + 3)
    prompts = np.repeat(rng.integers(3, cfg.vocab_size, (PROMPTS, PROMPT_LEN)),
                        GROUP, axis=0).astype(np.int32)
    reqs = [Request(rid=i, prompt=p, params=sp) for i, p in enumerate(prompts)]
    # warm-up: cuBLAS handles, allocator, first launches
    eng.generate([Request(rid=100 + i, prompt=prompts[i, :64],
                          params=SamplingParams.from_rl(rl, max_new=4))
                  for i in range(2)])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    got = counts()
    k5 = got["flash_attention"]
    want = {k: 0 for k in got}
    want["flash_attention"] = cfg.num_layers
    if got != want:
        raise AssertionError(f"static rollout launched {got}, want {want} "
                             f"({cfg.num_layers} K5 for the prefill)")
    n_tok = sum(r.gen_count for r in res)
    for r in res:
        if not np.isfinite(r.logps).all() or (r.logps > 1e-6).any() or \
                (r.tokens < 0).any() or (r.tokens >= cfg.vocab_size).any():
            raise AssertionError(f"request {r.rid}: bad tokens or logps")
    # the prefill alone, to split the rollout's time
    toks = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    with torch.no_grad():
        cache = init_cache(cfg, params, toks.shape[0], PROMPT_LEN + NEW_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(cfg, params, toks, cache=cache)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        profile_static_decode(cfg, params, cache, toks[:, -1])
    del cache
    torch.cuda.empty_cache()
    dec_ms = (t_roll - t_pre) * 1e3 / NEW_TOKENS
    log(f"[static] {cfg.name} full width, attn_impl pallas: {len(res)} "
        f"requests x {PROMPT_LEN} prompt tokens, {n_tok} generated in "
        f"{t_roll:.2f}s ({n_tok / t_roll:.1f} tokens/s); prefill alone "
        f"{t_pre * 1e3:.1f} ms, decode {dec_ms:.2f} ms per step (rollout "
        f"minus prefill over {NEW_TOKENS} steps); launches {got} | {card}")

    roll = rollout_from_results(prompts, res, NEW_TOKENS, device=dev)
    tokens = roll["tokens"]
    lps, ms = {}, {"pallas": [], "chunked": []}
    for impl in ("pallas", "chunked", "chunked", "pallas"):
        lp, t, n = recompute(cfg, params, tokens, impl,
                             cfg.num_layers if impl == "pallas" else 0)
        k5 += n
        lps[impl] = lp
        ms[impl].append(t)
    d_paths = float((lps["pallas"] - lps["chunked"]).abs().max())
    mask = roll["comp_mask"]
    comp = lps["pallas"][:, PROMPT_LEN - 1:]
    d_sampler = float(((comp - roll["sampler_lp"]).abs() * mask).max())
    log(f"[static] recompute over {tokens.shape[0]} x {tokens.shape[1]}: "
        f"through K5 {' / '.join(f'{t:.1f}' for t in ms['pallas'])} ms, "
        f"through the chunked attention "
        f"{' / '.join(f'{t:.1f}' for t in ms['chunked'])} ms (run order "
        f"K5, chunked, chunked, K5; K5 {cfg.num_layers} and K1 1 launch "
        f"per K5 run); max|K5 - chunked| {d_paths:.3e}, max|K5 recompute "
        f"- sampler| {d_sampler:.3e} nats (tol {TOL_LOGP_PATHS}) | {card}")
    if d_paths > TOL_LOGP_PATHS or d_sampler > TOL_LOGP_PATHS:
        raise AssertionError("the recompute through K5 disagrees")
    return k5


def to_float32(tree):
    """Every leaf of a params tree cast to float32, in place, one leaf at
    a time (the bf16 leaf is freed as its float32 copy replaces it)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            to_float32(v)
        else:
            tree[k] = v.float()


def local_cache_bytes(cfg, batch, max_len):
    """Bytes of the local layers' dense K/V cache (``init_cache``'s
    shapes, without allocating it)."""
    rows = max_len
    if cfg.local_ring_kv:
        rows = min(max_len, cfg.sliding_window)
    n_local = sum(k == "local" for k in cfg.block_pattern) * cfg.num_blocks
    return (2 * n_local * batch * rows * cfg.num_kv_heads * cfg.head_dim
            * torch.finfo(getattr(torch, cfg.dtype)).bits // 8)


def ring_run(cfg, params, reqs, res, card):
    """The greedy requests of the gemma2 phase again with the local
    layers' cache as a ring of the window's rows (``local_ring_kv``; the
    prompts are past the window, so ``fill_ring`` wraps), held to the
    non-ring results ``res``: tokens equal up to the first teacher-forced
    top-2 gap under TOL_GAP, every logp of that prefix within
    TOL_LOGP_RING. Returns the K5 launches (the ring prefill and the
    teacher-forced forwards)."""
    rcfg = dataclasses.replace(cfg, local_ring_kv=True)
    greedy = dict(temperature=1.0, top_k=1, top_p=1.0)
    eng = build_engine(rcfg, params, ServeConfig(engine="static"),
                       rl=RLConfig(**greedy), vocab_limit=cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rres = eng.generate(reqs)
    torch.cuda.synchronize()
    t_ring = time.perf_counter() - t0
    peak_ring = torch.cuda.max_memory_allocated() / 2 ** 30
    got = counts()["flash_attention"]
    if got != cfg.num_layers:
        raise AssertionError(f"gemma2 ring generate launched K5 {got} times")
    reset_counts()
    worst, same_tie, same_end = 0.0, 0, 0
    for req, a, b in zip(reqs, res, rres):
        _, gap = teacher_forced_logps(cfg, params, req.prompt, a.tokens,
                                      cfg.vocab_size)
        near = np.flatnonzero(gap < TOL_GAP[torch.bfloat16])
        upto = int(near[0]) if near.size else a.gen_count
        n = min(upto, a.gen_count, b.gen_count)
        if not np.array_equal(a.tokens[:n], b.tokens[:n]) or (
                n < upto and a.gen_count != b.gen_count):
            raise AssertionError(f"gemma2 ring request {a.rid}: tokens "
                                 f"differ before the first near-tie "
                                 f"(position {upto})")
        m = min(a.gen_count, b.gen_count)
        diff = np.flatnonzero(a.tokens[:m] != b.tokens[:m])
        eq = int(diff[0]) if diff.size else m
        worst = max(worst, float(np.abs(a.logps[:eq] - b.logps[:eq]).max()))
        same_tie += 1
        same_end += int(np.array_equal(a.tokens, b.tokens))
    n_tf = counts()["flash_attention"]
    b_ring = local_cache_bytes(rcfg, len(reqs), GEMMA_PROMPT + GEMMA_NEW)
    b_full = local_cache_bytes(cfg, len(reqs), GEMMA_PROMPT + GEMMA_NEW)
    log(f"[gemma2] ring KV (local_ring_kv): greedy 2 x {GEMMA_PROMPT} + "
        f"{GEMMA_NEW} in {t_ring:.2f}s, K5 launches {got}; local layers' "
        f"cache {b_ring / 2 ** 30:.3f} GiB ({cfg.sliding_window} rows) "
        f"against {b_full / 2 ** 30:.3f} GiB ({GEMMA_PROMPT + GEMMA_NEW} "
        f"rows); generate peak {peak_ring:.2f} GiB; {same_tie}/{len(reqs)} "
        f"equal to the non-ring tokens up to the first top-2 gap < "
        f"{TOL_GAP[torch.bfloat16]}, {same_end}/{len(reqs)} to the end; "
        f"max |ring logp - non-ring logp| {worst:.3e} (tol {TOL_LOGP_RING})"
        f" | {card}")
    if not worst <= TOL_LOGP_RING:
        raise AssertionError("gemma2 ring logps disagree with the non-ring "
                             "run's")
    del eng
    return got + n_tf


def gemma2_phase(dev, seed, card):
    """Gemma2-9B at full width (42 layers, head_dim 256, window 4096,
    softcaps): the recompute at 1 x 8192 through K5 and through the chunked
    attention; a greedy static generation past the window whose logps the
    teacher-forced forward must reproduce, and again with the local
    layers' cache as a ring (``ring_run``); then the same weights in
    float32, where K5 and the chunked attention must agree to 1e-3 nats.
    Returns the K5 launches counted. Frees the weights."""
    cfg = dataclasses.replace(get_config("gemma2-9b"), attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed + 4, device=dev)
    torch.cuda.synchronize()
    log(f"[gemma2] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f}B params bf16, init "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed + 4)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                           (1, GEMMA_LEN + 1))).to(dev)
    lp_k, ms_k, k5 = recompute(cfg, params, tokens, "pallas", cfg.num_layers)
    lp_c, ms_c, _ = recompute(cfg, params, tokens, "chunked", 0)
    d_paths = (lp_k - lp_c).abs()
    d_mean = float(d_paths.mean())
    log(f"[gemma2] token_logps 1 x {GEMMA_LEN}: through K5 {ms_k:.1f} ms "
        f"(K5 launches {k5}, one per layer: {cfg.num_layers // 2} local, "
        f"{cfg.num_layers // 2} global), chunked {ms_c:.1f} ms; bf16 |K5 - "
        f"chunked| max {float(d_paths.max()):.3e}, mean {d_mean:.3e} nats "
        f"(mean held to {TOL_LOGP_MEAN_BF16}) | {card}")
    if d_mean > TOL_LOGP_MEAN_BF16:
        raise AssertionError("gemma2: bf16 logps through K5 disagree")
    greedy = dict(temperature=1.0, top_k=1, top_p=1.0)
    eng = build_engine(cfg, params, ServeConfig(engine="static", seed=seed),
                       rl=RLConfig(**greedy), vocab_limit=cfg.vocab_size,
                       key=prng.PRNGKey(seed))
    prompts = rng.integers(3, cfg.vocab_size, (2, GEMMA_PROMPT)
                           ).astype(np.int32)
    reqs = [Request(rid=i, prompt=p, params=SamplingParams(
        max_new_tokens=GEMMA_NEW, **greedy)) for i, p in enumerate(prompts)]
    peak_pre = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    peak_gen = torch.cuda.max_memory_allocated() / 2 ** 30
    got = counts()["flash_attention"]
    roll = rollout_from_results(prompts, res, GEMMA_NEW, device=dev)
    lp_tf, _, n_tf = recompute(cfg, params, roll["tokens"], "pallas",
                               cfg.num_layers)
    k5 += got + n_tf
    comp = lp_tf[:, GEMMA_PROMPT - 1:]
    d_tf = float(((comp - roll["sampler_lp"]).abs()
                  * roll["comp_mask"]).max())
    peak = max(peak_pre, torch.cuda.max_memory_allocated()) / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    log(f"[gemma2] greedy static generate 2 x {GEMMA_PROMPT} prompt (past "
        f"the {cfg.sliding_window} window) + {GEMMA_NEW} new: {t_gen:.2f}s, "
        f"K5 launches {got}; max|engine logp - teacher-forced logp| "
        f"{d_tf:.3e} nats (tol {TOL_LOGP_PATHS}); bf16 peak {peak:.2f} GiB "
        f"(the generate alone {peak_gen:.2f}) | {card}")
    if got != cfg.num_layers:
        raise AssertionError(f"gemma2 generate launched K5 {got} times")
    if d_tf > TOL_LOGP_PATHS:
        raise AssertionError("gemma2: engine and teacher-forced logps "
                             "disagree")
    del eng, roll, lp_tf
    k5 += ring_run(cfg, params, reqs, res, card)
    # the same weights (exactly) and tokens in float32, where bf16 rounding
    # no longer hides a kernel fault: K5 in float32 against the chunked
    # attention; each bf16 path's distance from this float32 model is
    # printed only, as a measure of the bf16 noise
    to_float32(params)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lp32_k, ms32_k, n32 = recompute(cfg32, params, tokens, "pallas",
                                    cfg.num_layers)
    lp32_c, ms32_c, _ = recompute(cfg32, params, tokens, "chunked", 0)
    k5 += n32
    d32 = float((lp32_k - lp32_c).abs().max())
    e_k = float((lp_k - lp32_c).abs().max())
    e_c = float((lp_c - lp32_c).abs().max())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[gemma2] float32 weights: token_logps through K5 {ms32_k:.1f} ms, "
        f"chunked {ms32_c:.1f} ms; max|K5 - chunked| {d32:.3e} nats (tol "
        f"{TOL_LOGP_F32}); distance of the bf16 paths from the float32 "
        f"model (not held): K5 {e_k:.3e}, chunked {e_c:.3e} nats; phase "
        f"peak {peak:.2f} GiB | {card}")
    if d32 > TOL_LOGP_F32:
        raise AssertionError("gemma2: float32 logps through K5 disagree")
    del params, lp32_k, lp32_c, lp_k, lp_c
    torch.cuda.empty_cache()
    return k5


# --------------------------------------------------------------------------
# phase 6: mamba2-1.3b through the static engine and the recompute via K6


def ssd_recompute(cfg, params, tokens, impl):
    """``token_logps`` through SSD route ``impl``; checks the launch counts
    of the run and returns (logps, ms, K6 launches counted)."""
    icfg = dataclasses.replace(cfg, ssd_impl=impl)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = token_logps(icfg, params, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    want = {k: 0 for k in got}
    want.update(logprob_fwd=1,
                ssd_scan=cfg.num_layers if impl == "pallas" else 0)
    if got != want:
        raise AssertionError(f"mamba2 recompute ({impl}) launched {got}, "
                             f"want {want}")
    if not torch.isfinite(lp).all():
        raise AssertionError(f"mamba2 recompute ({impl}): non-finite logps")
    return lp, ms, got["ssd_scan"]


def no_carry_recompute(cfg, params, tokens):
    """``token_logps`` through K6 launched chunk by chunk, each chunk from
    a zero state: what a K6 that dropped the inter-chunk term would give
    (the control of the float32 check). Not a main-path run."""
    real = ss.ssd_scan

    def cut(x, dt, a, b, c, *, chunk=128):
        lc = min(chunk, x.shape[1])
        return torch.cat([real(x[:, i:i + lc], dt[:, i:i + lc], a,
                               b[:, i:i + lc], c[:, i:i + lc], chunk=lc)
                          for i in range(0, x.shape[1], lc)], 1)

    ss.ssd_scan = cut
    try:
        return token_logps(dataclasses.replace(cfg, ssd_impl="pallas"),
                           params, tokens)
    finally:
        ss.ssd_scan = real


def ssd_layer_check(cfg, params, tokens):
    """K6 against the model's chunked SSD on the inputs the model hands K6
    in layers SSD_LAYERS of one recompute (x, dt, a, b, c after the
    padding to whole chunks), held by ``ssd_scan.error_ratio`` (K6's
    bf16 y against the chunked float32 y); the same inputs through K6
    chunk by chunk from a zero state (a K6 without the carried state)
    must miss by 100x. Not a main-path run."""
    real = ss.ssd_scan
    seen = []

    def record(*args, chunk=128):
        seen.append([t.clone() for t in args]
                    if len(seen) in SSD_LAYERS else None)
        return real(*args, chunk=chunk)

    ss.ssd_scan = record
    try:
        token_logps(dataclasses.replace(cfg, ssd_impl="pallas"), params,
                    tokens)
    finally:
        ss.ssd_scan = real
    chunk = cfg.ssm_chunk
    for layer in SSD_LAYERS:
        args, seen[layer] = seen[layer], None
        x, dt = args[0], args[1]
        got = ss.ssd_scan(*args, chunk=chunk)
        with torch.no_grad():
            want, _ = ssm.ssd_chunked(
                *args, chunk=chunk,
                head_slice=ssm._head_slice(cfg, x.shape[0], x.shape[1]))
        cut = torch.cat([ss.ssd_scan(*(t[:, i:i + chunk] if t.dim() > 1
                                       else t for t in args), chunk=chunk)
                         for i in range(0, x.shape[1], chunk)], 1)
        ratio, control = ss.error_ratio(got, want), ss.error_ratio(cut, want)
        log(f"[mamba2] layer {layer} SSD as the recompute calls K6 (x "
            f"{tuple(x.shape)} {str(x.dtype)[6:]}, dt in "
            f"[{float(dt.min()):.2e}, {float(dt.max()):.2e}]): K6 vs the "
            f"chunked SSD max|err| {max_err(got, want):.3e} (max|y| "
            f"{float(want.abs().max()):.3e}), error ratio {ratio:.3e} (must "
            f"be <= 1); K6 without the carried state {control:.3e} (must be "
            f"> 100)")
        if not ratio <= 1.0:
            raise AssertionError(f"mamba2 layer {layer}: K6 disagrees with "
                                 f"the chunked SSD")
        if not control > 100.0:
            raise AssertionError(f"mamba2 layer {layer}: the check cannot "
                                 f"see a K6 that drops the carried state")
        del args, x, dt, got, want, cut


def profile_recompute(cfg, params, tokens):
    """torch.profiler over one recompute through K6: device busy share
    and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    icfg = dataclasses.replace(cfg, ssd_impl="pallas")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        token_logps(icfg, params, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    log(f"[profile] mamba2 recompute through K6 ({tokens.shape[0]} x "
        f"{tokens.shape[1]}): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall; "
        f"profiler on), {sum(e.count for e in rows)} device launches")
    for e in rows[:10]:
        log(f"[profile] {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")


# the float32 recompute's runs, K6 ("pallas") and the chunked SSD in turns
F32_RECOMPUTE_ORDER = ("pallas", "chunked", "chunked", "pallas", "pallas",
                       "chunked")


def impl_ms(runs) -> str:
    """'median <m> (<min>-<max>, n <k>)' of host-clock ms."""
    return (f"median {statistics.median(runs):.1f} ({min(runs):.1f}-"
            f"{max(runs):.1f}, n {len(runs)})")


def mamba2_phase(dev, seed, card):
    """Mamba2-1.3B at full width (48 layers, d_model 2048, 64 SSM heads of
    64, state 128, bf16, random weights): the static engine at the
    learner's rollout shape (16 x 832 prompt + 192 new, temperature 1.0),
    then the App. B.1 recompute over its 16 x 1024 tokens through K6 and
    through the chunked SSD in turns, held against each other and against
    the sampler's logps, a profile of one K6 recompute and the layer check
    (``ssd_layer_check``); then the same weights in float32, the two routes
    three runs each in turns (F32_RECOMPUTE_ORDER), where they must agree
    to TOL_SSD_F32. Returns the K6 launches counted.
    Frees the weights."""
    cfg = get_config("mamba2-1.3b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed + 5, device=dev)
    torch.cuda.synchronize()
    log(f"[mamba2] {cfg.name}: {cfg.num_layers} Mamba2 layers, d_model "
        f"{cfg.d_model}, {cfg.ssm_heads} SSM heads of {cfg.ssm_headdim}, "
        f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f}B params bf16, "
        f"init {time.perf_counter() - t0:.1f}s")
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0,
                  max_new_tokens=NEW_TOKENS)
    eng = build_engine(cfg, params, ServeConfig(engine="static", seed=seed),
                       rl=rl, vocab_limit=cfg.vocab_size,
                       key=prng.PRNGKey(seed))
    sp = SamplingParams.from_rl(rl)
    rng = np.random.default_rng(seed + 5)
    prompts = np.repeat(rng.integers(3, cfg.vocab_size, (PROMPTS, PROMPT_LEN)),
                        GROUP, axis=0).astype(np.int32)
    reqs = [Request(rid=i, prompt=p, params=sp) for i, p in enumerate(prompts)]
    eng.generate([Request(rid=100 + i, prompt=prompts[i, :64],
                          params=SamplingParams.from_rl(rl, max_new=4))
                  for i in range(2)])                    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    got = counts()
    if any(got.values()):
        raise AssertionError(f"mamba2 rollout launched {got}: its prefill "
                             "fills a cache (chunked SSD) and decode is the "
                             "recurrence, so no kernel")
    n_tok = sum(r.gen_count for r in res)
    for r in res:
        if not np.isfinite(r.logps).all() or (r.logps > 1e-6).any() or \
                (r.tokens < 0).any() or (r.tokens >= cfg.vocab_size).any():
            raise AssertionError(f"request {r.rid}: bad tokens or logps")
    toks = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    with torch.no_grad():
        cache = init_cache(cfg, params, toks.shape[0], PROMPT_LEN + NEW_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(cfg, params, toks, cache=cache)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        profile_static_decode(cfg, params, cache, toks[:, -1])
    del cache
    torch.cuda.empty_cache()
    dec_ms = (t_roll - t_pre) * 1e3 / NEW_TOKENS
    log(f"[mamba2] static engine: {len(res)} requests x {PROMPT_LEN} prompt "
        f"tokens, {n_tok} generated in {t_roll:.2f}s ({n_tok / t_roll:.1f} "
        f"tokens/s); prefill alone {t_pre * 1e3:.1f} ms, decode "
        f"{dec_ms:.2f} ms per step (rollout minus prefill over {NEW_TOKENS} "
        f"steps) | {card}")

    roll = rollout_from_results(prompts, res, NEW_TOKENS, device=dev)
    tokens = roll["tokens"]
    del eng, res
    lps, ms, k6 = {}, {"pallas": [], "chunked": []}, 0
    for impl in ("pallas", "chunked", "chunked", "pallas"):
        lp, t, n = ssd_recompute(cfg, params, tokens, impl)
        k6 += n
        lps[impl] = lp
        ms[impl].append(t)
    d_paths = (lps["pallas"] - lps["chunked"]).abs()
    mask = roll["comp_mask"]
    comp = lps["pallas"][:, PROMPT_LEN - 1:]
    d_sampler = (comp - roll["sampler_lp"]).abs() * mask
    mean_s = float(d_sampler.sum() / mask.sum())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[mamba2] recompute over {tokens.shape[0]} x {tokens.shape[1]}: "
        f"through K6 {' / '.join(f'{t:.1f}' for t in ms['pallas'])} ms, "
        f"through the chunked SSD "
        f"{' / '.join(f'{t:.1f}' for t in ms['chunked'])} ms (run order K6, "
        f"chunked, chunked, K6; K6 {cfg.num_layers} and K1 1 launch per K6 "
        f"run); bf16 |K6 - chunked| mean {float(d_paths.mean()):.3e} (held "
        f"to {TOL_SSD_MEAN_BF16}), max {float(d_paths.max()):.3e}; |K6 "
        f"recompute - sampler| mean {mean_s:.3e} (held to "
        f"{TOL_SSD_MEAN_BF16}), max {float(d_sampler.max()):.3e} nats; "
        f"bf16 peak {peak:.2f} GiB | {card}")
    if float(d_paths.mean()) > TOL_SSD_MEAN_BF16 or \
            mean_s > TOL_SSD_MEAN_BF16:
        raise AssertionError("mamba2: bf16 logps through K6 disagree")
    profile_recompute(cfg, params, tokens)
    ssd_layer_check(cfg, params, tokens)
    # the same weights (exactly) and tokens in float32: K6 against the
    # chunked SSD with bf16 rounding out of the way
    to_float32(params)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lp32, ms32 = {}, {"pallas": [], "chunked": []}
    for impl in F32_RECOMPUTE_ORDER:
        lp, t, n = ssd_recompute(cfg32, params, tokens, impl)
        k6 += n
        lp32[impl] = lp
        ms32[impl].append(t)
    lp32_k, lp32_c = lp32["pallas"], lp32["chunked"]
    d32 = (lp32_k - lp32_c).abs()
    ctrl = (no_carry_recompute(cfg32, params, tokens) - lp32_c).abs()
    e_k = float((lps["pallas"] - lp32_c).abs().mean())
    e_c = float((lps["chunked"] - lp32_c).abs().mean())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[mamba2] float32 weights: token_logps through K6 "
        f"{impl_ms(ms32['pallas'])} ms, chunked {impl_ms(ms32['chunked'])} "
        f"ms (runs {' / '.join(f'{t:.1f}' for t in ms32['pallas'])} and "
        f"{' / '.join(f'{t:.1f}' for t in ms32['chunked'])}; order "
        f"{', '.join(F32_RECOMPUTE_ORDER)}); |K6 - chunked| max "
        f"{float(d32.max()):.3e} (tol {TOL_SSD_F32}), mean "
        f"{float(d32.mean()):.3e} nats; control, "
        f"K6 without the carried state: max (must be > {TOL_SSD_F32}) "
        f"{float(ctrl.max()):.3e}, mean {float(ctrl.mean()):.3e} nats; mean "
        f"distance of the bf16 paths from the float32 model (not held): K6 "
        f"{e_k:.3e}, chunked {e_c:.3e} nats; phase peak {peak:.2f} GiB | "
        f"{card}")
    if float(d32.max()) > TOL_SSD_F32:
        raise AssertionError("mamba2: float32 logps through K6 disagree")
    if not float(ctrl.max()) > TOL_SSD_F32:
        raise AssertionError("mamba2: the float32 check cannot see a K6 "
                             "that drops the carried state")
    del params, lp32, lp32_k, lp32_c, lps
    torch.cuda.empty_cache()
    return k6


# --------------------------------------------------------------------------
# phase 7: one GEPO learner iteration at full width


def learner_batch(cfg, params, dev, seed):
    """Generation (K3/K4), the App. B.1 recompute (K1) and the batch as
    hetero/nodes.py assembles it. Returns (batch, launches, info)."""
    rl_gen = RLConfig(temperature=1.0, top_k=0, top_p=1.0,
                      max_new_tokens=NEW_TOKENS)
    rng = np.random.default_rng(seed + 2)
    prompts = np.repeat(rng.integers(3, cfg.vocab_size, (PROMPTS, PROMPT_LEN)),
                        GROUP, axis=0).astype(np.int32)   # group-contiguous
    fl.reset_launch_counts()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    roll = generate_continuous(cfg, rl_gen, params, prompts,
                               key=prng.PRNGKey(seed),
                               vocab_limit=cfg.vocab_size,
                               num_slots=PROMPTS * GROUP, prefill_chunk=512)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp = token_logps(cfg, params, roll["tokens"])
    torch.cuda.synchronize()
    t_lp = time.perf_counter() - t0
    launches = {**fl.LAUNCHES, **pa.LAUNCHES}
    torch.cuda.empty_cache()
    b, tp = prompts.shape
    comp_lp = lp[:, tp - 1:]
    mask = roll["comp_mask"]
    drift = float(((comp_lp - roll["sampler_lp"]).abs() * mask).max())
    zeros = torch.zeros((b, tp - 1), dtype=torch.float32, device=dev)
    # a seeded Bernoulli(0.5) reward per row; a group drawn all-equal is
    # drawn again, so no group's advantages are all zero
    rewards = np.zeros(b, np.float32)
    for g in range(PROMPTS):
        r = rng.random(GROUP) < 0.5
        while r.all() or not r.any():
            r = rng.random(GROUP) < 0.5
        rewards[g * GROUP:(g + 1) * GROUP] = r
    rewards = torch.from_numpy(rewards)
    batch = {"tokens": roll["tokens"], "mask": torch.cat([zeros, mask], 1),
             "sampler_lp": torch.cat([zeros, comp_lp], 1),
             "rewards": rewards.to(dev)}
    n_gen = int(mask.sum())
    if roll["tokens"].shape != (b, PROMPT_LEN + NEW_TOKENS) or \
            not torch.isfinite(lp).all() or n_gen == 0:
        raise AssertionError("bad rollout or recompute")
    info = dict(gen_s=t_gen, gen_tokens=n_gen, logps_s=t_lp, drift=drift,
                stats=roll["stats"])
    return batch, launches, info


def head_grad_f32(cfg, rl, params, mb, impl, leaves):
    """rl_loss_fn forward and backward through log-prob ``impl``: (loss,
    metrics, gradients, the lm_head gradient in float32). The float32
    gradient is x_f^T dlogits, from the final-norm output x_f that
    ``_logits`` receives and the float32 gradient of the logits that
    ``fused_token_logprob`` receives, both captured on the way (the model
    rounds dlogits to bf16 before its head product)."""
    seen = {}
    real_logits, real_lp = model_mod._logits, training_mod.fused_token_logprob

    def logits(cfg_, params_, x):
        seen["x"] = x.detach()
        return real_logits(cfg_, params_, x)

    def token_logprob(lg, targets, **kw):
        lg.register_hook(lambda g: seen.__setitem__("dlogits", g.detach()))
        return real_lp(lg, targets, **kw)

    model_mod._logits, training_mod.fused_token_logprob = logits, token_logprob
    try:
        loss, m = rl_loss_fn(cfg, rl, params, mb, logprob_impl=impl)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        model_mod._logits, training_mod.fused_token_logprob = real_logits, \
            real_lp
    with torch.no_grad():
        xf = rmsnorm(seen.pop("x"), params["final_norm"], cfg.norm_eps)
        g32 = xf.reshape(-1, cfg.d_model).float().T @ seen.pop(
            "dlogits").reshape(xf.shape[0] * xf.shape[1], -1)
    return loss.detach(), {k: v.detach() for k, v in m.items()}, grads, g32


def fused_vs_twin(cfg, rl, params, batch, label):
    """One rl_loss_fn forward and backward through K1/K2 and one through
    the twin, on the same params and first microbatch."""
    mb = {k: v[:GROUP] for k, v in batch.items()}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    head_leaf = params.get("lm_head", params["embed"])      # tied: embed
    head = next(i for i, p in enumerate(leaves) if p is head_leaf)
    out = {}
    fl.reset_launch_counts()
    for impl in ("fused", "chunked"):
        loss, m, grads, g32 = head_grad_f32(cfg, rl, params, mb, impl, leaves)
        out[impl] = (loss, m, global_norm(grads), g32, grads[head])
        del grads
        torch.cuda.empty_cache()
    (lf, mf, nf, hf, bf), (lc, mc, nc, hc, bc) = out["fused"], out["chunked"]
    # |diff| beyond 1e-6 abs, relative to |twin|: metrics near 0
    # (adv_mean, est_error, kl) are held by the absolute floor
    mf["loss_value"], mc["loss_value"] = lf, lc
    rel = {k: max(0.0, abs(float(mf[k]) - float(mc[k])) - 1e-6)
           / max(abs(float(mc[k])), 1e-12) for k in mc}
    gn_rel = abs(float(nf) - float(nc)) / float(nc)
    head_rel = float((hf - hc).abs().max()) / float(hc.abs().max())
    # the model's bf16 lm_head gradient: its largest difference in bf16
    # ulps of the twin's entry there, and the share of entries that differ
    bd = (bf.float() - bc.float()).abs()
    at = int(bd.argmax())
    ref = abs(float(bc.view(-1)[at].float()))
    ulp = 2.0 ** (np.floor(np.log2(ref)) - 7) if ref > 0 else 2.0 ** -133
    bf_ulps, bf_share = float(bd.view(-1)[at]) / ulp, float((bd > 0).float()
                                                              .mean())
    worst = max(rel, key=rel.get)
    if fl.LAUNCHES != {"logprob_fwd": 1, "logprob_bwd": 1}:
        raise AssertionError(f"fused pass launched {fl.LAUNCHES}, not K1 and "
                             "K2 once each")
    log(f"[learner] K1/K2 vs twin ({label}), rl_loss_fn fwd+bwd at T={GROUP} "
        f"x {batch['tokens'].shape[1] - 1}: loss {float(lf):.6e} vs "
        f"{float(lc):.6e}; worst metric rel diff past 1e-6 abs "
        f"{rel[worst]:.2e} ({worst}, tol {TOL_LOSS_REL}); grad norm {float(nf):.6e} vs {float(nc):.6e} "
        f"(rel {gn_rel:.2e}, tol {TOL_GNORM_REL}); lm_head grad in float32 "
        f"(x_f^T dlogits) max|diff| / max|grad| {head_rel:.2e} (tol "
        f"{TOL_HEAD_REL}); the model's bf16 lm_head grad: max|diff| "
        f"{bf_ulps:.2f} bf16 ulps of its entry, {bf_share:.2e} of entries "
        f"differ (not held)")
    if rel[worst] > TOL_LOSS_REL or gn_rel > TOL_GNORM_REL or \
            head_rel > TOL_HEAD_REL:
        raise AssertionError(f"K1/K2 and the twin disagree at full width "
                             f"({label})")


def learner_phase(dev, seed, card):
    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, seed + 1, device=dev)
    log(f"[learner] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f}B params bf16, random "
        f"weights (seed {seed + 1}); attn_impl {cfg.attn_impl} chunk "
        f"{cfg.attn_chunk}, remat {cfg.remat}")
    batch, gen_launches, info = learner_batch(cfg, params, dev, seed)
    b, s = batch["tokens"].shape
    log(f"[learner] rollout: {b} rows x {s} tokens ({PROMPTS} prompts x "
        f"group {GROUP}, {PROMPT_LEN} prompt + {NEW_TOKENS} new, temperature "
        f"1.0), {info['gen_tokens']} generated in {info['gen_s']:.2f}s "
        f"({info['stats']['decode_steps']} decode steps, "
        f"{info['stats']['prefill_chunks']} prefill chunks); token_logps "
        f"recompute {info['logps_s'] * 1e3:.1f} ms; max|recompute - engine "
        f"logp| {info['drift']:.3e} (information only: bf16 model); rewards "
        f"are a seeded Bernoulli draw, the weights are random")
    rl = RLConfig(loss_type="gepo", group_size=GROUP, beta_kl=0.005)
    tc = TrainConfig(learning_rate=1e-6, grad_accum=2)
    fused_vs_twin(cfg, rl, params, batch, "GEPO, g_ent = 0")
    fused_vs_twin(cfg, dataclasses.replace(rl, entropy_bonus=ENTROPY_BONUS),
                  params, batch, f"GEPO + entropy bonus {ENTROPY_BONUS}")
    state = init_state(cfg, tc, params)
    fl.reset_launch_counts()
    tokens = b * (s - 1)
    step_ms = []
    for i in range(3):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(cfg, rl, tc, state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step_ms.append(dt * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[learner] step {i + 1}: loss {vals['loss']:.6e} kl "
            f"{vals['kl']:.6e} iw_mean {vals['iw_mean']:.6f} iw_var "
            f"{vals['iw_var']:.3e} iw_max {vals['iw_max']:.6f} grad_norm "
            f"{vals['grad_norm']:.4e} lr {vals['lr']:.3e} | "
            f"{dt * 1e3:.1f} ms, {tokens / dt:.0f} learner tokens/s, peak "
            f"{peak:.2f} GiB | {card}")
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i + 1}: non-finite metrics {bad}")
    launches = {k: gen_launches[k] + fl.LAUNCHES[k] for k in fl.LAUNCHES}
    launches.update({k: gen_launches[k] for k in pa.LAUNCHES})
    d_steps = info["stats"]["decode_steps"]
    p_chunks = info["stats"]["prefill_chunks"]
    want = {"logprob_fwd": 2 * 3 + 1, "logprob_bwd": 2 * 3,
            "paged_decode": cfg.num_layers * d_steps,
            "paged_prefill": cfg.num_layers * p_chunks}
    log(f"[learner] launches: K1 {launches['logprob_fwd']} (2 per step x 3 + "
        f"1 recompute), K2 {launches['logprob_bwd']} (2 per step x 3); "
        f"rollout K3 {launches['paged_decode']}, K4 "
        f"{launches['paged_prefill']} ({cfg.num_layers} x {d_steps} decode "
        f"steps, {cfg.num_layers} x {p_chunks} prefill chunks)")
    if launches != want:
        raise AssertionError(f"learner launches {launches} != {want}")
    profile_step(cfg, rl, tc, state, batch)
    # the kernels line reports K3/K4 from the serving path (engine phase)
    return {k: launches[k] for k in fl.LAUNCHES}


def profile_step(cfg, rl, tc, state, batch):
    """torch.profiler over a fourth step: device time by kernel and the
    device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(cfg, rl, tc, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    log(f"[profile] learner step: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall; profiler "
        f"on), {len(rows)} kernel names")
    # device time by kind, first match wins: the two log-prob kernels,
    # float32 GEMMs on the CUDA cores (the chunked attention's einsums),
    # the remaining GEMMs (bf16 projections and head), elementwise and
    # reduction kernels, the rest
    kinds = (("K1/K2", ("logprob_",)), ("f32 GEMM", ("sgemm", "f32f32")),
             ("other GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
             ("elementwise+reduce", ("elementwise", "reduce", "index",
                                     "copy", "scan", "fill")))
    by_kind = {}
    for e in rows:
        kind = next((k for k, subs in kinds
                     if any(x in e.key for x in subs)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + dev_us(e) / 1e3
    log("[profile] by kind: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / busy_ms:.1f}%)"
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    for e in rows[:14]:
        log(f"[profile] {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")


# --------------------------------------------------------------------------
# phase 8: the HeteroRL loop at full width


class HostTimer:
    """Host-clock seconds and peak device memory of every call of the
    functions it wraps, each call fenced by device synchronises. It keeps
    no reference to a call's arguments or result (they hold weights),
    only an int result (the bytes a sync moved)."""

    def __init__(self):
        self.calls = []           # (name, seconds, peak GiB, int result)

    def wrap(self, name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.calls.append((name, time.perf_counter() - t0,
                               torch.cuda.max_memory_allocated() / 2 ** 30,
                               out if isinstance(out, int) else None))
            return out
        return timed

    def seconds(self, name):
        return [dt for n, dt, _, _ in self.calls if n == name]

    def peak(self, name=None):
        return max((p for n, _, p, _ in self.calls
                    if name is None or n == name), default=0.0)


def timed_loop(timer):
    """Wrap the loop's publish, sync, sampler batch and learner step in
    ``timer`` (the step that ``jit_train_step`` builds for a learner node,
    so build the nodes after this call); returns the undo."""
    saved = [(nodes_mod, "publish_params"), (SamplerNode, "sync"),
             (SamplerNode, "generate_batch")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    for obj, name, fn in saved:
        setattr(obj, name, timer.wrap(name, fn))
    real_jit = nodes_mod.jit_train_step
    saved.append((nodes_mod, "jit_train_step", real_jit))
    nodes_mod.jit_train_step = lambda *a, **kw: timer.wrap(
        "train_step", real_jit(*a, **kw))

    def undo():
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return undo


def publish_breakdown(params):
    """The work of one publish, timed piece by piece on ``params``:
    ``chunk_host_leaf`` on every leaf (device-to-host copy into bytes,
    then blake2b), the hash alone again on the same bytes, and the
    store's chunk puts. Returns (d2h_s, hash_s, store_s, bytes), d2h_s
    being the chunking time less the hashing time."""
    leaves = [t for _, t in flatten_with_paths(params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = [c for t in leaves for c in chunk_host_leaf(t)]
    t1 = time.perf_counter()
    for ref, data in chunks:
        if content_hash(data) != ref.hash:
            raise AssertionError(f"chunk hash of {ref.shape} differs")
    t2 = time.perf_counter()
    store = PolicyStore()
    for ref, data in chunks:
        store.put_chunk(ref.hash, data)
    t3 = time.perf_counter()
    return ((t1 - t0) - (t2 - t1), t2 - t1, t3 - t2,
            sum(ref.nbytes for ref, _ in chunks))


def check_timed(timer, want):
    """Every wrapped function was timed as often as the run implies (a
    renamed function would leave its list empty)."""
    got = {name: len(timer.seconds(name)) for name in want}
    if got != want:
        raise AssertionError(f"timed calls (got, want): {got}, {want}")


def rss_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def stamp_loop(store, stamps):
    """Wrap ``SamplerNode.sync`` and ``generate_batch`` so that ``stamps``
    gets, in call order, ("sync", sid, version) after every sync that
    moved a version and ("batch", sid, version stamp) after every batch.
    A sync's params are held against a fresh assembly of the version it
    synced to, bit for bit, on the spot. Returns the undo."""
    sync, gen = SamplerNode.sync, SamplerNode.generate_batch

    def synced(node, *a, **kw):
        moved = sync(node, *a, **kw)
        if moved > 0:
            _, host, _ = ChunkSubscriber(store).sync(node.params,
                                                     version=node.version)
            same = all(torch.equal(h, p.detach().cpu()) for h, p in zip(
                tree_leaves(host), tree_leaves(node.params)))
            stamps.append(("sync", node.sid, node.version, same))
        return moved

    def generated(node, *a, **kw):
        batch = gen(node, *a, **kw)
        stamps.append(("batch", node.sid, batch.version, True))
        return batch

    SamplerNode.sync, SamplerNode.generate_batch = synced, generated

    def undo():
        SamplerNode.sync, SamplerNode.generate_batch = sync, gen
    return undo


def check_stamps(stamps):
    """Every in-run sync gave the published version's params bit for bit,
    and every batch a node made after a sync carries the version of its
    last sync. Returns (syncs, batches after a sync)."""
    last, syncs, after = {}, 0, 0
    for kind, sid, version, same in stamps:
        if kind == "sync":
            if not same:
                raise AssertionError(f"sampler {sid}: params after its sync "
                                     f"to version {version} differ from it")
            last[sid] = version
            syncs += 1
        elif sid in last:
            if version != last[sid]:
                raise AssertionError(f"sampler {sid}: batch stamped "
                                     f"{version} after a sync to {last[sid]}")
            after += 1
    return syncs, after


def hetero_phase(dev, seed, card):
    """SFT warm start, HeteroRuntime.run and run_online on qwen3-1.7b at
    full width; returns the K1-K4 launches of the three runs, the warm
    start (on the host) and the median learner step seconds."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=LOOP_LAYERS)
    tok = Tokenizer()
    task = ArithmeticTask(max_operand=99, ops="+-", prompt_width=PROMPT_LEN,
                          seed=seed)
    rl = RLConfig(loss_type="gepo", group_size=GROUP,
                  max_new_tokens=NEW_TOKENS, temperature=1.0, top_k=0,
                  top_p=1.0, beta_kl=0.005, engine="continuous")
    tc = TrainConfig(grad_accum=2, logprob_impl="fused")
    log(f"[hetero] {cfg.name}: {cfg.num_layers} layers bf16, random weights "
        f"(seed {seed + 3}); attn_impl {cfg.attn_impl}, remat {cfg.remat}; "
        f"ArithmeticTask(max_operand 99, ops '+-', prompt_width "
        f"{PROMPT_LEN}); GEPO, group {GROUP} x {HETERO_PROMPTS} prompts, "
        f"{NEW_TOKENS} new tokens, temperature 1.0, grad_accum 2")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed + 3, device=dev)
    total = {k: 0 for k in ("logprob_fwd", "logprob_bwd", "paged_decode",
                            "paged_prefill")}

    def take(label, want):
        got = counts()
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            raise AssertionError(f"{label} launches (got, want): {bad}")
        for k in total:
            total[k] += got[k]

    # 1. SFT warm start through K1/K2
    tc_sft = TrainConfig(total_steps=HETERO_SFT_STEPS, logprob_impl="fused")
    state = init_state(cfg, tc_sft, params)
    del params
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, sft_loss = sft_warmstart(cfg, tc_sft, task, tok, state,
                                    steps=HETERO_SFT_STEPS, batch=8)
    torch.cuda.synchronize()
    t_sft = time.perf_counter() - t0
    take("SFT", {"logprob_fwd": HETERO_SFT_STEPS,
                 "logprob_bwd": HETERO_SFT_STEPS, "paged_decode": 0,
                 "paged_prefill": 0, "flash_attention": 0, "ssd_scan": 0})
    log(f"[hetero] sft_warmstart: {HETERO_SFT_STEPS} steps of 8 x "
        f"{PROMPT_LEN + 8} tokens in {t_sft:.2f}s, last loss {sft_loss:.6e}; "
        f"K1 {HETERO_SFT_STEPS}, K2 {HETERO_SFT_STEPS} | {card}")
    if not np.isfinite(sft_loss):
        raise AssertionError(f"SFT loss {sft_loss} is not finite")
    # the warm start stays on the host, shared by both runs; each learner
    # node clones it onto the card
    warm = copy_tree(state, torch.device("cpu"))
    del state
    torch.cuda.empty_cache()

    # 2. HeteroRuntime: two samplers serving through ContinuousEngine, at
    # the paper's 60 s median sync delay: a sampler syncs inside the run
    timer = HostTimer()
    undo = timed_loop(timer)
    stamps = []
    try:
        hcfg = HeteroConfig(num_samplers=2, max_delay_steps=64,
                            delay_median_s=60.0, seed=seed)
        rt = HeteroRuntime(cfg, rl, tc, hcfg, task, tok, warm,
                           prompts_per_batch=HETERO_PROMPTS, device=dev)
        undo_stamps = stamp_loop(rt.store, stamps)
        reset_counts()
        t0 = time.perf_counter()
        try:
            hist = rt.run(HETERO_STEPS)
        finally:
            undo_stamps()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    finally:
        undo()
    in_run_syncs, after_sync = check_stamps(stamps)
    log(f"[hetero] in-run syncs (sampler, version): "
        f"{[(sid, v) for k, sid, v, _ in stamps if k == 'sync']}, each "
        f"bit-exact against its version; batch stamps in order "
        f"{[(sid, v) for k, sid, v, _ in stamps if k == 'batch']}; "
        f"{after_sync} batches made after a sync carry its version")
    if in_run_syncs == 0:
        raise AssertionError("no sampler synced inside the run")
    batches = sum(s.batches_generated for s in rt.samplers)
    d_steps = sum(s.engine_stats["decode_steps"] for s in rt.samplers)
    p_chunks = sum(s.engine_stats["prefill_chunks"] for s in rt.samplers)
    take("hetero", {"logprob_fwd": batches + 2 * HETERO_STEPS,
                    "logprob_bwd": 2 * HETERO_STEPS,
                    "paged_decode": cfg.num_layers * d_steps,
                    "paged_prefill": cfg.num_layers * p_chunks,
                    "flash_attention": 0, "ssd_scan": 0})
    peak_dev = torch.cuda.max_memory_allocated() / 2 ** 30
    stale = hist.get("staleness")
    for i in range(len(stale)):
        log(f"[hetero] learner step {i + 1}: staleness {stale[i]:.0f} loss "
            f"{hist.get('loss')[i]:.6e} kl {hist.get('kl')[i]:.6e} iw_mean "
            f"{hist.get('iw_mean')[i]:.6f} iw_max {hist.get('iw_max')[i]:.6f}"
            f" iw_var {hist.get('iw_var')[i]:.3e} reward_mean "
            f"{hist.get('reward_mean')[i]:.4f}")
    for row in rt.sync_telemetry():
        log(f"[hetero] sampler {row['sampler']:.0f}: syncs {row['syncs']:.0f}"
            f", bytes on the wire {row['bytes_on_wire']:.0f}, dedup ratio "
            f"{row['dedup_ratio']:.3f}, chunks fetched "
            f"{row['chunks_fetched']:.0f}")
    # publishes: version 0 at the learner's build, then one per step
    check_timed(timer, {"publish_params": HETERO_STEPS + 1,
                        "generate_batch": batches,
                        "train_step": HETERO_STEPS})
    pubs = timer.seconds("publish_params")
    syncs = [dt for n, dt, _, out in timer.calls if n == "sync" and out > 0]
    peak_dev = max(peak_dev, timer.peak())
    gens = timer.seconds("generate_batch")
    steps = timer.seconds("train_step")
    st = rt.learner.publish_stats
    log(f"[hetero] HeteroRuntime.run({HETERO_STEPS}): {t_run:.2f}s wall, "
        f"simulated {rt.sim.now:.3f}s; {batches} sampler batches, "
        f"{rt.learner.discarded} discarded; K1 {batches} + 2 x "
        f"{HETERO_STEPS}, K2 2 x {HETERO_STEPS}, K3 {cfg.num_layers} x "
        f"{d_steps} decode steps, K4 {cfg.num_layers} x {p_chunks} prefill "
        f"chunks; peak device memory {peak_dev:.2f} GiB, host peak RSS "
        f"{rss_gib():.2f} GiB | {card}")
    log(f"[hetero] host seconds: publish (D2H + hash + store, "
        f"{st.payload_bytes} bytes) " + ", ".join(f"{x:.3f}" for x in pubs)
        + "; sync in the run (fetch + assemble + copy to the card) "
        + (", ".join(f"{x:.3f}" for x in syncs) or "none")
        + "; sampler batch (generate + score + recompute) "
        + ", ".join(f"{x:.3f}" for x in gens) + "; learner train_step "
        + ", ".join(f"{x:.3f}" for x in steps) + "; peak device GiB: "
        f"sampler batch {timer.peak('generate_batch'):.2f}, learner step "
        f"{timer.peak('train_step'):.2f} | {card}")
    d2h, hsh, put, nbytes = publish_breakdown(rt.learner.state.params)
    log(f"[hetero] one publish's work apart, {nbytes} bytes: D2H into "
        f"bytes {d2h:.3f}s ({nbytes / d2h / 1e9:.2f} GB/s), blake2b "
        f"{hsh:.3f}s ({nbytes / hsh / 1e9:.2f} GB/s), store puts "
        f"{put:.3f}s | {card}")
    bad = [k for k in hist.keys() if not np.isfinite(hist.get(k)).all()]
    if rt.learner.step != HETERO_STEPS or bad:
        raise AssertionError(f"hetero run: {rt.learner.step} steps, "
                             f"non-finite {bad}")
    if not 0 < stale.max() <= hcfg.max_delay_steps:
        raise AssertionError(f"staleness {stale} not in (0, 64]")
    # each sampler syncs to the newest version through its own node path
    # (fetch, assemble, copy into its params on the card): its weights are
    # then the learner's, bit for bit
    lparams = tree_leaves(rt.learner.state.params)
    for smp in rt.samplers:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = smp.sync()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(smp.params), lparams))
        # the engine serves the synced tensors, and its prefix cache (KV
        # of the old weights) is empty
        eng = smp._gen_engine
        cached = len(eng.prefix_cache)
        log(f"[hetero] sampler {smp.sid} syncs to version {smp.version} "
            f"after the run: {moved} bytes on the wire in {dt:.3f}s (fetch "
            f"+ assemble + copy to the card), dedup ratio "
            f"{smp.link_stats()['dedup_ratio']:.3f}; weights equal to the "
            f"learner's: {same}; prefix-cache entries left {cached} | "
            f"{card}")
        if smp.version != HETERO_STEPS or not same or \
                eng.params is not smp.params or cached:
            raise AssertionError(f"sampler {smp.sid} sync is not exact")
    # a fresh subscriber synced to the newest version holds the
    # learner's params bit for bit
    v, host, _ = ChunkSubscriber(rt.store).sync(rt.learner.state.params)
    exact = all(torch.equal(h, p.detach().cpu())
                for h, p in zip(tree_leaves(host), lparams))
    log(f"[hetero] publish/sync round trip of version {v}: "
        f"{'bit-exact' if exact else 'DIFFERS'}")
    if v != HETERO_STEPS or not exact:
        raise AssertionError("publish/sync round trip is not bit-exact")
    del rt, smp, eng, host, hist, lparams
    gc.collect()
    torch.cuda.empty_cache()

    # 3. run_online with the static engine: the synchronous control
    timer = HostTimer()
    undo = timed_loop(timer)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist, _, learner = run_online(
            cfg, dataclasses.replace(rl, engine="static"), tc, task, tok,
            warm, num_steps=HETERO_ONLINE_STEPS,
            prompts_per_batch=HETERO_PROMPTS, seed=seed, device=dev)
        torch.cuda.synchronize()
        t_online = time.perf_counter() - t0
    finally:
        undo()
    check_timed(timer, {"publish_params": HETERO_ONLINE_STEPS + 1,
                        "generate_batch": HETERO_ONLINE_STEPS,
                        "train_step": HETERO_ONLINE_STEPS})
    take("online", {"logprob_fwd": 3 * HETERO_ONLINE_STEPS,
                    "logprob_bwd": 2 * HETERO_ONLINE_STEPS,
                    "paged_decode": 0, "paged_prefill": 0,
                    "flash_attention": 0, "ssd_scan": 0})
    kl, iw = hist.get("kl"), hist.get("iw_mean")
    log(f"[hetero] run_online({HETERO_ONLINE_STEPS}), static engine: "
        f"{t_online:.2f}s wall; staleness {hist.get('staleness').tolist()}, "
        f"kl {kl.tolist()} (< 0.3), iw_mean {iw.tolist()} (|.-1| < 0.5), "
        f"iw_var {hist.get('iw_var').tolist()}; host seconds: publish "
        + ", ".join(f"{x:.3f}" for x in timer.seconds("publish_params"))
        + "; sampler batch " + ", ".join(
            f"{x:.3f}" for x in timer.seconds("generate_batch"))
        + "; learner train_step " + ", ".join(
            f"{x:.3f}" for x in timer.seconds("train_step"))
        + f"; peak device GiB: sampler batch "
        f"{timer.peak('generate_batch'):.2f}, learner step "
        f"{timer.peak('train_step'):.2f}, run "
        f"{max(timer.peak(), torch.cuda.max_memory_allocated() / 2 ** 30):.2f}"
        f"; host peak RSS {rss_gib():.2f} GiB | {card}")
    bad = [k for k in hist.keys() if not np.isfinite(hist.get(k)).all()]
    if learner.step != HETERO_ONLINE_STEPS or bad or \
            hist.get("staleness").max() != 0 or kl.max() >= 0.3 or \
            np.abs(iw - 1.0).max() >= 0.5:
        raise AssertionError("online run outside tests/test_system.py's "
                             "thresholds")
    del learner
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[hetero] launches: {total}")
    return total, warm, statistics.median(steps)


# --------------------------------------------------------------------------
# phase 9: speculative decoding on the continuous engine at full width


def templated_prompts(vocab, seed):
    """Workload (a): 16 prompts of 96-384 tokens, each a short random
    pattern (3-8 tokens of ids 3..vocab-1) repeated."""
    rng = np.random.default_rng(seed + 9)
    out = []
    for _ in range(16):
        pat = rng.integers(3, vocab, int(rng.integers(3, 9)))
        n = int(rng.integers(96, 385))
        out.append(np.tile(pat, -(-n // len(pat)))[:n].astype(np.int32))
    return out


def spec_run(cfg, params, prompts, rl, max_new, vocab, spec_k, seed,
             rescore=True):
    """Serve ``prompts`` through a fresh ``ContinuousEngine`` (8 slots,
    page 16, prefill chunk 512, draws from ids below ``vocab``) at
    ``spec_k``; hold the pool, the launch counts (none through the twins,
    ``paged_attn_impl="ref"``) and (spec on, ``rescore``) the rescore.
    Returns (results, stats delta, launches, decode tokens/s, decode ms
    per step)."""
    serve = ServeConfig(num_slots=SLOTS, page_size=PAGE, prefill_chunk=512,
                        sync_every=8, max_total_tokens=2048,
                        paged_attn_impl=cfg.paged_attn_impl, spec_k=spec_k,
                        spec_rescore=rescore, seed=seed)
    eng = build_engine(cfg, params, serve, rl=rl, vocab_limit=vocab,
                       key=prng.PRNGKey(seed))
    sp = SamplingParams.from_rl(rl, max_new=max_new)
    # warm-up: cuBLAS handles, allocator, first launches (one prefill chunk
    # and one decode chunk each); then a cold cache
    eng.generate([Request(rid=1000 + i, prompt=prompts[i][:64],
                          params=SamplingParams.from_rl(rl, max_new=8))
                  for i in range(2)])
    eng.prefix_cache.clear()
    torch.cuda.synchronize()
    st0 = eng.stats()
    reset_counts()
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, params=sp, arrival_s=t_start))
    results, dec_s, dec_tok, dec_steps = {}, 0.0, 0, 0
    while len(results) < len(prompts):
        before = eng.stats()
        t1 = time.perf_counter()
        events = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        after = eng.stats()
        for ev in events:
            if ev.finished:
                results[ev.rid] = eng.pop_result(ev.rid)
        if after["prefill_chunks"] == before["prefill_chunks"]:
            dec_s += dt
            dec_tok += sum(1 for ev in events if not ev.finished)
            dec_steps += after["decode_steps"] - before["decode_steps"]
        if not eng.has_work() and len(results) < len(prompts):
            raise AssertionError("engine drained with requests unfinished")
    launches = {k: counts()[k] for k in ("paged_decode", "paged_prefill")}
    st = {k: v - st0[k] for k, v in eng.stats().items()
          if isinstance(v, int) and k in st0}
    st["accept_rate"] = (st["accepted_tokens_total"]
                         / max(st["drafted_tokens_total"], 1))
    st["spec_rescore_max_diff"] = eng.stats()["spec_rescore_max_diff"]
    lyr = cfg.num_layers if cfg.paged_attn_impl == "pallas" else 0
    want = {"paged_decode": lyr * (eng.sync_every * st["spec_fallback_chunks"]
                                   if spec_k else st["decode_steps"]),
            "paged_prefill": lyr * st["prefill_chunks"]
            + (lyr + (1 if lyr and rescore else 0)) * st["spec_rounds"]}
    if launches != want:
        raise AssertionError(f"spec_k={spec_k}: launches {launches} != "
                             f"{want} implied by {st}")
    res = [results[i] for i in range(len(prompts))]
    for r in res:
        if r.finish_reason not in ("eos", "length") or r.gen_count < 1 \
                or not np.isfinite(r.logps).all() or (r.logps > 1e-6).any() \
                or (r.tokens < 0).any() or (r.tokens >= vocab).any():
            raise AssertionError(f"spec_k={spec_k} request {r.rid}: "
                                 f"{r.finish_reason}, bad tokens or logps: "
                                 f"{r.tokens.tolist()} {r.logps.tolist()}")
    held = len({pg for ent in eng.prefix_cache._entries.values()
                for pg in ent.pages})
    if eng.free_pages + held != eng.num_pages - 1:
        raise AssertionError("page pool does not balance with the cache")
    eng.prefix_cache.clear()
    if eng.free_pages != eng.num_pages - 1 or eng.sched.allocator.in_use:
        raise AssertionError("page pool does not balance after the cache")
    if spec_k and rescore and st["spec_rescore_max_diff"] != 0.0:
        raise AssertionError(f"folded K4 rescore differs from the forward "
                             f"by {st['spec_rescore_max_diff']}")
    return res, st, launches, dec_tok / dec_s, dec_s * 1e3 / dec_steps


def teacher_forced_logps(cfg, params, prompt, tokens, vocab, draw=None):
    """The teacher-forced forward of prompt + tokens: the target model's
    logp of each token (log-softmax over the padded vocab, as the engine
    scores draws) and, at each completion position over the served ids
    (below ``vocab``), the top-2 gap of the logits, or, with ``draw`` the
    request's threefry key (``fold_in(engine key, rid)``), of the logits
    plus draw g's Gumbel noise (key ``fold_in(draw, g)``; temperature 1,
    no top-k or top-p)."""
    seq = np.concatenate([prompt, tokens]).astype(np.int64)
    x = torch.from_numpy(seq[None]).cuda()
    logits, _, _ = forward(cfg, params, x)
    lg = logits[0, len(prompt) - 1:len(seq) - 1].float()
    del logits
    tgt = torch.from_numpy(np.asarray(tokens, np.int64)).cuda()
    lp = torch.log_softmax(lg, -1).gather(-1, tgt[:, None])[:, 0]
    score = mask_vocab(lg, vocab)
    if draw is not None:
        keys = prng.fold_in(draw.to(lg.device),
                            torch.arange(len(tokens), device=lg.device))
        score = score + prng.gumbel(keys, lg.shape[-1:])
    top2 = score.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    return lp.cpu().numpy(), gap.cpu().numpy()


def spec_contracts(cfg, params, prompts, vocab, runs, tol_lp, tol_gap,
                   label, key=None):
    """The GEPO logp contract on every run of ``runs`` ({spec_k: results})
    and the spec/non-spec token rule: a spec run emits the non-spec run's
    tokens up to the first position where the non-spec run's top-2 gap is
    under ``tol_gap``: of the logits (greedy), or, with the engine's
    ``key``, of the logits plus the draw's Gumbel noise (temperature 1, no
    filter). Returns (max |logp - teacher|, identical to the end,
    identical up to the first near-tie)."""
    worst, gaps = 0.0, {}
    for k, res in runs.items():
        for p, r in zip(prompts, res):
            lp, gap = teacher_forced_logps(
                cfg, params, p, r.tokens, vocab,
                None if key is None else prng.fold_in(key, r.rid))
            worst = max(worst, float(np.abs(lp - r.logps).max()))
            if k == 0:
                gaps[r.rid] = gap
    if worst > tol_lp:
        raise AssertionError(f"{label}: emitted logps differ from the "
                             f"teacher-forced forward by {worst} > {tol_lp}")
    same_end = same_tie = 0
    for a, b in zip(runs[0], runs[SPEC_K]):
        near = np.flatnonzero(gaps[a.rid] < tol_gap)
        upto = int(near[0]) if near.size else a.gen_count
        n = min(upto, a.gen_count, b.gen_count)
        if not np.array_equal(a.tokens[:n], b.tokens[:n]) or (
                n < upto and a.gen_count != b.gen_count):
            raise AssertionError(
                f"{label} request {a.rid}: spec tokens differ before the "
                f"first near-tie (position {upto}, gap < {tol_gap})")
        same_tie += 1
        same_end += int(np.array_equal(a.tokens, b.tokens))
    return worst, same_end, same_tie


def folded_vs_twin(cfg, q, kp, vp, table, positions):
    """The rescore's folded K4 launch (``paged_prefill_layers``: one launch
    over every layer's pool, page ids up to L x P) against each layer's
    twin on float32 inputs, in bf16 (TOL_BF16) and on float32 copies
    (TOL_F32), and against the per-layer launches bit for bit. Returns the
    max errors (bf16, float32)."""
    errs = []
    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        qd, kd, vd = (t.to(dt) for t in (q, kp, vp))
        got = ops.paged_prefill_layers(qd, kd, vd, table, positions,
                                       impl="pallas")
        err = 0.0
        for li in range(cfg.num_layers):
            want = ops.paged_prefill(qd[li].float(), kd[li].float(),
                                     vd[li].float(), table, positions,
                                     impl="ref")
            one = ops.paged_prefill(qd[li], kd[li], vd[li], table, positions,
                                    impl="pallas")
            if not torch.equal(got[li], one):
                raise AssertionError(f"folded K4 ({dt}) layer {li} differs "
                                     f"from its per-layer launch")
            err = max(err, max_err(got[li], want))
        if not err <= tol:
            raise AssertionError(f"folded K4 ({dt}) disagrees with its twin: "
                                 f"{err:.3e} > {tol}")
        errs.append(err)
        del qd, kd, vd, got
    return errs


SPEC_K = 4
# logps of one bf16 model two ways (the engine's K3/K4 windows against the
# teacher-forced chunked forward): TOL_LOGP_PATHS; float32: TOL_LOGP_F32
# A greedy token flips between two bf16 paths only where a top-2 gap is
# within both paths' logit noise: each path's logits sit within
# TOL_LOGITS (0.1) of the teacher-forced ones, so the gap the teacher
# sees moves by up to 2 x 0.1 and the two engines' gaps by 4 x 0.1 apart.
# Float32: summation order only, ~1e-5 relative on logits of |.| < 10
TOL_GAP = {torch.bfloat16: 0.5, torch.float32: 1e-3}


def spec_phase(dev, seed, card):
    """Workloads (a) greedy templated and (b) the serve cell's mix, each
    with spec_k 0 and 4, through ContinuousEngine at full width; then (a)
    again in float32, greedy and sampled. Returns the K3/K4 launches of the
    runs and the folded rescore launch's max errors against its twin
    (bf16, float32)."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              paged_attn_impl="pallas",
                              num_layers=SPEC_LAYERS)
    params = init_params(cfg, seed, device=dev)
    greedy = RLConfig(temperature=1.0, top_k=1, top_p=1.0)
    # (a) draws from the ids a HeteroRL sampler serves (the arithmetic
    # task's tokenizer, as the hetero cell): greedy decoding over 152k ids
    # with random weights walks a random map that does not close a loop
    # within 128 tokens, over 18 it does, and the drafter finds it
    task_vocab = Tokenizer().vocab_size
    work = {"a": (templated_prompts(task_vocab, seed), greedy, 128,
                  task_vocab),
            "b": (engine_prompts(cfg, seed), RLConfig(), 64, cfg.vocab_size)}
    total = {"paged_decode": 0, "paged_prefill": 0}
    log(f"[spec] {cfg.name} bf16, {SLOTS} slots, page {PAGE}, prefill chunk "
        f"512, n-gram drafter (3..1), spec_k {SPEC_K}; (a) 16 templated "
        f"prompts of 96-384 tokens, 128 new, greedy over the task "
        f"tokenizer's {task_vocab} ids; (b) the serve cell's "
        f"24 prompts, 64 new, temperature 0.6 / top-k 20 / top-p 0.95")
    runs = {}
    for name, (prompts, rl, new, vocab) in work.items():
        for k in (0, SPEC_K):
            res, st, launches, tok_s, ms = spec_run(cfg, params, prompts, rl,
                                                    new, vocab, k, seed)
            for key in total:
                total[key] += launches[key]
            runs[(name, k)] = res
            log(f"[spec] ({name}) spec_k {k}: decode {tok_s:.1f} tokens/s, "
                f"{ms:.2f} ms per decode step (pure-decode rounds), "
                f"{sum(r.gen_count for r in res)} tokens; accept rate "
                f"{st['accept_rate']:.4f} ({st['accepted_tokens_total']}/"
                f"{st['drafted_tokens_total']} drafts, "
                f"{st['spec_rounds']} verify rounds, "
                f"{st['spec_fallback_chunks']} fallback chunks, "
                f"{st['prefill_chunks']} prefill chunks); launches "
                f"{launches}; rescore max diff "
                f"{st['spec_rescore_max_diff']} | {card}")
            if name == "a" and k and (st["accepted_tokens_total"] == 0
                                      or st["spec_rounds"] == 0):
                raise AssertionError("(a) accepted no draft")
    for name, (prompts, _, _, vocab) in work.items():
        worst, same_end, same_tie = spec_contracts(
            cfg, params, prompts, vocab,
            {k: runs[(name, k)] for k in (0, SPEC_K)},
            # (b): a top-k or top-p cut-off that the bf16 paths move apart
            # changes the draw with no near-tie of the gap; the float32
            # sampled run below holds the draw keys
            TOL_LOGP_PATHS, TOL_GAP[torch.bfloat16] if name == "a"
            else float("inf"), f"({name}) bf16")
        log(f"[spec] ({name}) bf16: max |emitted logp - teacher-forced| "
            f"{worst:.4f} (<= {TOL_LOGP_PATHS}); "
            + (f"{same_tie}/{len(prompts)} requests' spec tokens equal the "
               f"non-spec tokens up to the first top-2 gap < "
               f"{TOL_GAP[torch.bfloat16]}, " if name == "a" else "")
            + f"{same_end}/{len(prompts)} identical to the end")

    # the folded rescore launch against the per-layer launches at the
    # verify shape (8 slots, window 5, ~1000 keys a slot), on a pool of
    # the engine's size
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = init_paged_pool(cfg, 1537, PAGE, device=dev)
    kp, vp = stacked_pools(cfg, pool)
    for leaf in (kp, vp):
        for li in range(cfg.num_layers):
            leaf[li].copy_(torch.randn(leaf.shape[1:], generator=g,
                                       device=dev))
    w = SPEC_K + 1
    q = torch.randn((cfg.num_layers, SLOTS, w, HQ, D), generator=g,
                    device=dev).to(torch.bfloat16)
    table = (1 + torch.randperm(1536, generator=g, device=dev)[
        :SLOTS * 64]).reshape(SLOTS, 64).int()
    positions = torch.arange(SLOTS, device=dev)[:, None] * 100 + 300 \
        + torch.arange(w, device=dev)
    folded_errs = folded_vs_twin(cfg, q, kp, vp, table, positions)
    folded = time_ms(lambda: ops.paged_prefill_layers(
        q, kp, vp, table, positions, impl="pallas"))
    per_layer = time_ms(lambda: [ops.paged_prefill(
        q[li], kp[li], vp[li], table, positions, impl="pallas")
        for li in range(cfg.num_layers)])
    log(f"[spec] rescore at the verify shape (B {SLOTS}, C {w}, 300-1004 "
        f"keys, page ids up to {cfg.num_layers} x 1537): one folded K4 "
        f"launch over {cfg.num_layers} layers {folded:.4f} ms, "
        f"{cfg.num_layers} per-layer launches {per_layer:.4f} ms; folded "
        f"against each layer's twin max|err| bf16 {folded_errs[0]:.3e} "
        f"(tol {TOL_BF16}), f32 {folded_errs[1]:.3e} (tol {TOL_F32}), equal "
        f"to the per-layer launches bit for bit | {card}")
    del pool, kp, vp, q
    torch.cuda.empty_cache()

    # (a) again with the weights in float32
    to_float32(params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    prompts, rl, new, vocab = work["a"]
    runs32 = {}
    for k in (0, SPEC_K):
        res, st, launches, tok_s, ms = spec_run(cfg32, params, prompts, rl,
                                                new, vocab, k, seed)
        for key in total:
            total[key] += launches[key]
        runs32[k] = res
        log(f"[spec] (a) float32 spec_k {k}: decode {tok_s:.1f} tokens/s, "
            f"{ms:.2f} ms per decode step; accept rate "
            f"{st['accept_rate']:.4f} ({st['accepted_tokens_total']}/"
            f"{st['drafted_tokens_total']}), {st['spec_rounds']} verify "
            f"rounds, rescore max diff {st['spec_rescore_max_diff']} | {card}")
    worst, same_end, same_tie = spec_contracts(
        cfg32, params, prompts, vocab, runs32, TOL_LOGP_F32,
        TOL_GAP[torch.float32], "(a) float32")
    log(f"[spec] (a) float32: max |emitted logp - teacher-forced| "
        f"{worst:.2e} (<= {TOL_LOGP_F32}); {same_tie}/{len(prompts)} equal "
        f"up to the first top-2 gap < {TOL_GAP[torch.float32]}, "
        f"{same_end}/{len(prompts)} identical to the end")
    # (a) float32 once more, sampled at temperature 1 with no top-k or
    # top-p: the only near-ties are then those of logits + the draw's Gumbel
    # noise, so the token rule holds that a verify round draws with the
    # non-spec chunk's keys fold_in(fold_in(key, rid), g)
    sampled = RLConfig(temperature=1.0, top_k=0, top_p=1.0)
    runs_s = {}
    for k in (0, SPEC_K):
        res, st, launches, tok_s, ms = spec_run(cfg32, params, prompts,
                                                sampled, 64, vocab, k, seed)
        for key in total:
            total[key] += launches[key]
        runs_s[k] = res
        log(f"[spec] (a) float32 sampled spec_k {k}: decode {tok_s:.1f} "
            f"tokens/s; accept rate {st['accept_rate']:.4f} "
            f"({st['accepted_tokens_total']}/{st['drafted_tokens_total']}), "
            f"{st['spec_rounds']} verify rounds, {st['spec_fallback_chunks']} "
            f"fallback chunks | {card}")
        if k and st["spec_rounds"] == 0:
            raise AssertionError("(a) float32 sampled: no verify round")
    worst, same_end, same_tie = spec_contracts(
        cfg32, params, prompts, vocab, runs_s, TOL_LOGP_F32,
        TOL_GAP[torch.float32], "(a) float32 sampled",
        key=prng.PRNGKey(seed))
    log(f"[spec] (a) float32 sampled: max |emitted logp - teacher-forced| "
        f"{worst:.2e} (<= {TOL_LOGP_F32}); {same_tie}/{len(prompts)} equal "
        f"up to the first top-2 gap of logits + Gumbel noise < "
        f"{TOL_GAP[torch.float32]}, {same_end}/{len(prompts)} identical to "
        f"the end")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[spec] launches: {total}")
    return total, folded_errs


# --------------------------------------------------------------------------
# phase 10: the threaded HeteroRL runtime with spec samplers


def threads_phase(dev, seed, card, warm, step_s):
    """ThreadedHeteroRuntime.run(4) on the hetero phase's model, task and
    warm start: 2 sampler threads at spec_k 4 and the learner, on one
    card. Returns the K1-K4 launches of the run."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=LOOP_LAYERS)
    tok = Tokenizer()
    task = ArithmeticTask(max_operand=99, ops="+-", prompt_width=PROMPT_LEN,
                          seed=seed)
    rl = RLConfig(loss_type="gepo", group_size=GROUP,
                  max_new_tokens=NEW_TOKENS, temperature=1.0, top_k=0,
                  top_p=1.0, beta_kl=0.005, engine="continuous")
    tc = TrainConfig(grad_accum=2, logprob_impl="fused")
    hcfg = HeteroConfig(num_samplers=2, max_delay_steps=64,
                        delay_median_s=60.0, seed=seed, spec_k=SPEC_K)
    # one learner step of wall time per 60 simulated seconds: the paper's
    # median sync delay is then about one learner step
    time_scale = step_s / 60.0
    torch.cuda.reset_peak_memory_stats()
    rt = ThreadedHeteroRuntime(cfg, rl, tc, hcfg, task, tok, warm,
                               prompts_per_batch=HETERO_PROMPTS,
                               time_scale=time_scale, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    try:
        hist = rt.run(HETERO_STEPS)
    finally:
        # run() joins each thread for 10 s, less than a batch in flight may
        # take: wait for every one before reading counts or freeing memory
        for t in rt.threads:
            t.join(THREAD_JOIN_S)
        alive = [t.name for t in rt.threads if t.is_alive()]
        if alive:
            raise AssertionError(f"sampler threads {alive} still running "
                                 f"{THREAD_JOIN_S}s after the run")
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batches = sum(s.batches_generated for s in rt.samplers)
    est = [s.engine_stats for s in rt.samplers]
    lyr = cfg.num_layers
    want = {"logprob_fwd": batches + 2 * HETERO_STEPS,
            "logprob_bwd": 2 * HETERO_STEPS,
            "paged_decode": lyr * 8 * sum(e["spec_fallback_chunks"]
                                          for e in est),
            "paged_prefill": sum(lyr * e["prefill_chunks"]
                                 + (lyr + 1) * e["spec_rounds"]
                                 for e in est),
            "flash_attention": 0, "ssd_scan": 0}
    if launches != want:
        raise AssertionError(f"threaded run launches {launches} != {want}")
    stale = hist.get("staleness")
    syncs = sum(s.syncs for s in rt.samplers)
    bad = [k for k in hist.keys() if not np.isfinite(hist.get(k)).all()]
    log(f"[threads] ThreadedHeteroRuntime.run({HETERO_STEPS}), 2 samplers "
        f"at spec_k {SPEC_K}, time_scale {time_scale:.5f} (learner step "
        f"{step_s:.3f} s per 60 simulated s): {t_run:.2f}s wall; "
        f"{batches} sampler batches, {rt.learner.discarded} discarded, "
        f"{syncs} syncs in the run (versions "
        f"{[s.version for s in rt.samplers]}), {rt.skipped_syncs} skipped; "
        f"staleness {stale.tolist()}; loss {hist.get('loss').tolist()}; "
        f"peak device memory {peak:.2f} GiB, host peak RSS "
        f"{rss_gib():.2f} GiB | {card}")
    for s, e in zip(rt.samplers, est):
        log(f"[threads] sampler {s.sid}: {s.batches_generated} batches, "
            f"{s.tokens_per_s:.1f} tokens/s steady, accept rate "
            f"{e['accept_rate']:.4f} ({e['accepted_tokens_total']}/"
            f"{e['drafted_tokens_total']}), {e['spec_rounds']} verify "
            f"rounds, {e['spec_fallback_chunks']} fallback chunks, rescore "
            f"max diff {e['spec_rescore_max_diff']}")
    log(f"[threads] launches {launches} (K1 {batches} + 2 x {HETERO_STEPS}, "
        f"K2 2 x {HETERO_STEPS}, K3 {lyr} x 8 per fallback chunk, K4 "
        f"{lyr + 1} per verify round + {lyr} per prefill chunk)")
    if rt.learner.step != HETERO_STEPS or bad or \
            stale.max() > hcfg.max_delay_steps or syncs == 0 or \
            any(e["spec_rescore_max_diff"] != 0.0 for e in est):
        raise AssertionError(f"threaded run: {rt.learner.step} steps, "
                             f"non-finite {bad}, staleness {stale}, "
                             f"{syncs} syncs")
    del rt, hist
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 11: the serving front door over the serve cell's engine

# clients sent at once: plain POST /generate, NDJSON streams, requests on
# one websocket (the serve cell's 24 prompts, in this order)
DOOR_HTTP, DOOR_NDJSON, DOOR_WS = 12, 8, 4
DOOR_NEW = 32


async def door_http(port, method, path, payload=None, accept=""):
    """One HTTP request to the door -> (status, body): JSON, the list of
    NDJSON lines of a chunked stream, or text."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode() if payload is not None else b""
    extra = f"Accept: {accept}\r\n" if accept else ""
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n{extra}"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    hdrs = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        k, _, v = line.decode("latin1").partition(":")
        hdrs[k.strip().lower()] = v.strip()
    if hdrs.get("transfer-encoding") == "chunked":
        out = []
        while True:
            n = int((await reader.readline()).strip(), 16)
            if n == 0:
                break
            out.append(json.loads(await reader.readexactly(n)))
            await reader.readexactly(2)
    else:
        data = await reader.readexactly(int(hdrs.get("content-length", 0)))
        out = (data.decode() if "text/plain" in hdrs.get("content-type", "")
               else json.loads(data))
    writer.close()
    return status, out


def ws_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    """A client->server websocket frame (FIN, masked)."""
    mask = b"\x5a\xa5\x3c\xc3"
    n = len(payload)
    if n < 126:
        head = bytes([0x80 | opcode, 0x80 | n])
    elif n < 1 << 16:
        head = bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", n)
    else:
        head = bytes([0x80 | opcode, 0x80 | 127]) + struct.pack(">Q", n)
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


async def door_ws(port, payloads):
    """Send every payload on one websocket at once; returns ({id: token
    events}, {id: result})."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /ws HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\n"
                 b"Connection: Upgrade\r\n"
                 b"Sec-WebSocket-Key: dGVzdGtleTEyMzQ1Njc4\r\n\r\n")
    await writer.drain()
    if b"101" not in await reader.readline():
        raise AssertionError("websocket upgrade refused")
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    for p in payloads:
        writer.write(ws_frame(json.dumps(p).encode()))
    await writer.drain()
    events = {p["id"]: [] for p in payloads}
    done = {}
    while len(done) < len(payloads):
        hdr = await reader.readexactly(2)
        n = hdr[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", await reader.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", await reader.readexactly(8))[0]
        msg = json.loads(await reader.readexactly(n))
        if "error" in msg:
            raise AssertionError(f"websocket request rejected: {msg}")
        if "finish_reason" in msg:
            done[msg["id"]] = msg
        else:
            events[msg["id"]].append(msg)
    writer.write(ws_frame(b"", opcode=0x8))
    await writer.drain()
    writer.close()
    return events, done


async def door_clients(door, prompts):
    """Every client at once, a scrape while they are in flight, then the
    final /healthz and /metrics (JSON and Prometheus text). Returns
    (results by id, stream events by id, rejects, scrapes, wall s)."""
    await door.start()
    port = door.port

    def payload(i, **kw):
        return {"id": i, "tokens": prompts[i].tolist(),
                "max_new_tokens": DOOR_NEW, **kw}

    n_http = DOOR_HTTP + DOOR_NDJSON
    t0 = time.perf_counter()
    calls = [door_http(port, "POST", "/generate", payload(i))
             for i in range(DOOR_HTTP)]
    calls += [door_http(port, "POST", "/generate", payload(i, stream=True))
              for i in range(DOOR_HTTP, n_http)]
    calls.append(door_ws(port, [payload(i) for i in range(
        n_http, n_http + DOOR_WS)]))
    calls.append(door_http(port, "POST", "/generate", {
        "id": "infeasible",
        "tokens": [5] * (door.serve.max_total_tokens - DOOR_NEW + 1),
        "max_new_tokens": DOOR_NEW}))
    calls.append(door_http(port, "POST", "/generate", payload(
        0, id="expired", deadline_s=1e-6)))
    everything = asyncio.ensure_future(asyncio.gather(*calls))
    while not door.engine.has_work():
        await asyncio.sleep(0.005)
    # a scrape while requests decode: the loop thread answers from host
    # state while the executor thread runs the step
    t_s = time.perf_counter()
    st_h, health = await door_http(port, "GET", "/healthz")
    st_m, mid = await door_http(port, "GET", "/metrics")
    scrape_ms = (time.perf_counter() - t_s) * 1e3
    out = await everything
    wall = time.perf_counter() - t0
    final = {"healthz": await door_http(port, "GET", "/healthz"),
             "json": await door_http(port, "GET", "/metrics"),
             "prom": await door_http(port, "GET",
                                     "/metrics?format=prometheus",
                                     accept="text/plain")}
    await door.close()
    results, streams = {}, {}
    for i, (status, body) in enumerate(out[:n_http]):
        if status != 200:
            raise AssertionError(f"door request {i}: status {status} {body}")
        if i >= DOOR_HTTP:
            streams[i], body = body[:-1], body[-1]
        results[i] = body
    ws_events, ws_done = out[n_http]
    for i, res in ws_done.items():
        results[i], streams[i] = res, ws_events[i]
    rejects = {"infeasible": out[n_http + 1], "expired": out[n_http + 2]}
    scrapes = {"mid": (st_h, health, st_m, mid, scrape_ms), **final}
    return results, streams, rejects, scrapes, wall


def door_phase(dev, seed, card):
    """Phase 11: a ``FrontDoor`` on 127.0.0.1 (port 0) over the serve
    cell's engine; 24 clients at once and two that admission rejects;
    results held against ``engine.generate`` on a fresh engine with the
    same key and the rids the door assigned, and against the
    teacher-forced forward. Returns the K3/K4 launches of the door's
    run."""
    from repro_torch.serving.server import FrontDoor
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              paged_attn_impl="pallas")
    params = init_params(cfg, seed, device=dev)
    serve = ServeConfig(num_slots=SLOTS, page_size=PAGE, prefill_chunk=512,
                        sync_every=8, max_total_tokens=2048,
                        paged_attn_impl="pallas", port=0, seed=seed)
    rl = RLConfig()                          # temperature 0.6, top-k 20, top-p 0.95
    key = prng.PRNGKey(seed)
    sp = SamplingParams.from_rl(rl, max_new=DOOR_NEW)
    prompts = engine_prompts(cfg, seed)
    door = FrontDoor(cfg, params, serve, rl=rl, vocab_limit=cfg.vocab_size,
                     key=key)
    eng = door.engine
    assigned = {}
    build_request = door.build_request

    def build_and_record(payload, now_s):
        req = build_request(payload, now_s)
        assigned[payload["id"]] = req.rid
        return req

    door.build_request = build_and_record

    def warm(engine):
        """cuBLAS handles, allocator, first launches; then a cold cache."""
        engine.generate([Request(rid=10 ** 6 + i, prompt=prompts[i][:64],
                                 params=sp) for i in range(2)])
        engine.prefix_cache.clear()
        torch.cuda.synchronize()

    warm(eng)
    st0 = eng.stats()
    obs.configure(True, clear=True)
    reset_counts()
    try:
        results, streams, rejects, scrapes, wall = asyncio.run(
            door_clients(door, prompts))
        torch.cuda.synchronize()
        launches = {k: counts()[k] for k in ("paged_decode",
                                             "paged_prefill")}
    finally:
        obs.configure(False, clear=True)
    st = eng.stats()
    d_steps = st["decode_steps"] - st0["decode_steps"]
    p_chunks = st["prefill_chunks"] - st0["prefill_chunks"]
    lyr = cfg.num_layers
    if launches != {"paged_decode": lyr * d_steps,
                    "paged_prefill": lyr * p_chunks}:
        raise AssertionError(f"door launches {launches} != {lyr} x "
                             f"({d_steps} decode steps, {p_chunks} prefill "
                             "chunks)")
    eng.prefix_cache.clear()
    if eng.free_pages != eng.num_pages - 1 or eng.sched.allocator.in_use:
        raise AssertionError("door: page pool does not balance")
    # admission's two rejects
    (s_inf, b_inf), (s_exp, b_exp) = rejects["infeasible"], rejects["expired"]
    if (s_inf, b_inf.get("error"), s_exp, b_exp.get("error")) != \
            (400, "infeasible", 408, "expired"):
        raise AssertionError(f"door rejects: {rejects}")
    # the scrape in flight and the final ones
    st_h, health, st_m, mid, scrape_ms = scrapes["mid"]
    if (st_h, st_m) != (200, 200) or not health.get("ok") \
            or mid["slo"]["completed"] >= len(prompts):
        raise AssertionError(f"door: scrape in flight {st_h} {st_m}, "
                             f"{mid['slo']['completed']} completed")
    (fh, health), (fm, m) = scrapes["healthz"], scrapes["json"]
    fp, prom = scrapes["prom"]
    if (fh, fm, fp) != (200, 200, 200) or not health.get("ok"):
        raise AssertionError("door: final /healthz or /metrics failed")
    if m["slo"]["completed"] != len(prompts) or m["rejected"] != {
            "infeasible": 1, "expired": 1, "queue_full": 0,
            "overloaded": 0}:
        raise AssertionError(f"door /metrics: {m['slo']} {m['rejected']}")
    if "serve_ttft_seconds_bucket" not in prom or \
            "engine_free_pages" not in prom:
        raise AssertionError("door: Prometheus text lacks the serve and "
                             "engine series")
    # every admitted request: DOOR_NEW tokens or a finish reason; each
    # stream's events are its result
    for i in range(len(prompts)):
        r = results[i]
        if len(r["tokens"]) != DOOR_NEW and r["finish_reason"] != "eos":
            raise AssertionError(f"door request {i}: {len(r['tokens'])} "
                                 f"tokens, {r['finish_reason']}")
        if i in streams and [e["token"] for e in streams[i]] != r["tokens"]:
            raise AssertionError(f"door request {i}: stream events differ "
                                 "from its result")
    snap = m["slo"]
    n_tok = sum(len(r["tokens"]) for r in results.values())

    # the same requests through engine.generate on a fresh engine with the
    # same key and the door's rids
    fresh = build_engine(cfg, params, serve, rl=rl,
                         vocab_limit=cfg.vocab_size, key=key)
    warm(fresh)
    order = sorted(range(len(prompts)), key=lambda i: assigned[i])
    t1 = time.perf_counter()
    ref = fresh.generate([Request(rid=assigned[i], prompt=prompts[i],
                                  params=sp, arrival_s=t1) for i in order])
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t1
    ref = dict(zip(order, ref))
    n_ref = sum(r.gen_count for r in ref.values())
    del fresh
    worst, same_end, bitwise, cut = 0.0, 0, 0, []
    for i in range(len(prompts)):
        a, b = ref[i], results[i]
        toks = np.asarray(b["tokens"], np.int64)
        lps = np.asarray(b["logps"], np.float32)
        # positions the two runs computed from the same bits: up to the
        # first one whose token or logp differs, and that one too when
        # its context is bit-equal (the prompt's prefill, the same chunks
        # when the prefix-cache hits are equal; then every earlier
        # position): the same logits, and a draw keyed by the same rid,
        # give the same token
        both = min(a.gen_count, len(toks))
        diff = np.flatnonzero((a.tokens[:both] != toks[:both])
                              | (a.logps[:both] != lps[:both]))
        first = int(diff[0]) if diff.size else both
        upto = first + 1 if first > 0 or \
            a.prefix_hit_tokens == b["prefix_hit_tokens"] else 0
        n = min(upto, both)
        if not np.array_equal(a.tokens[:n], toks[:n]) or (
                n < upto and a.gen_count != len(toks)):
            raise AssertionError(
                f"door request {i} (rid {assigned[i]}): tokens differ from "
                f"engine.generate at a position both computed from the "
                f"same bits (position {n})")
        same = np.array_equal(a.tokens, toks)
        same_end += int(same)
        bitwise += int(same and np.array_equal(a.logps, lps))
        cut.append(n)
        lp, _ = teacher_forced_logps(cfg, params, prompts[i], toks,
                                     cfg.vocab_size)
        worst = max(worst, float(np.abs(lp - lps).max()))
    if worst > TOL_LOGP_PATHS:
        raise AssertionError(f"door logps differ from the teacher-forced "
                             f"forward by {worst} > {TOL_LOGP_PATHS}")
    ttft_ref = [r.ttft_s for r in ref.values()]
    log(f"[door] FrontDoor on 127.0.0.1 (a free port) over {cfg.name} bf16 "
        f"(K3/K4 pallas, {SLOTS} slots, page {PAGE}, prefill chunk 512): "
        f"{DOOR_HTTP} POST /generate + {DOOR_NDJSON} NDJSON streams + "
        f"{DOOR_WS} requests on one websocket at once, the serve cell's "
        f"prompts, {DOOR_NEW} new, temperature 0.6 / top-k 20 / top-p 0.95;"
        f" rejects: infeasible -> {s_inf}, deadline 1e-6 s -> {s_exp}")
    log(f"[door] through the door: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
        f"{snap['ttft_p50_s'] * 1e3:.1f} ms, p99 "
        f"{snap['ttft_p99_s'] * 1e3:.1f} ms (the door's telemetry); "
        f"engine.generate on a fresh engine: {n_ref} tokens in "
        f"{wall_ref:.3f}s = {n_ref / wall_ref:.1f} tokens/s, TTFT p50 "
        f"{percentile(ttft_ref, 50) * 1e3:.1f} ms, p99 "
        f"{percentile(ttft_ref, 99) * 1e3:.1f} ms; door / engine "
        f"{(n_tok / wall) / (n_ref / wall_ref):.3f} | {card}")
    log(f"[door] {len(prompts)}/{len(prompts)} requests equal "
        f"engine.generate at every position both computed from the same "
        f"bits (positions compared {sum(cut)} of {n_tok}), {same_end}/"
        f"{len(prompts)} to the end ({bitwise} with bit-equal logps); max "
        f"|door logp - "
        f"teacher-forced| {worst:.4f} (<= {TOL_LOGP_PATHS}); scrape in "
        f"flight {scrape_ms:.1f} ms with {mid['slo']['completed']} of "
        f"{len(prompts)} done; /metrics slo completed {snap['completed']}, "
        f"rejected {m['rejected']}; {d_steps} decode steps, {p_chunks} "
        f"prefill chunks, launches {launches}; pool balanced")
    del door, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 12: the decoder-only families left on one card

# depth cuts, width never cut: the dense configs serve half their layers
# (qwen1.5-32b 16 of 64: 70.4 GB of weights and 1.31 MB of KV a token at
# full depth do not fit beside the pool; the halves keep the script inside
# its 1200 s limit), llama4-scout 4 of 48 (216 GB at full depth),
# llama4-maverick one period of 2 (MoE + MLP, 128 experts), the scout
# float32 pair 2 layers, the scout learner 1 layer
DENSE_DEPTH = {"internlm2-1.8b": 12, "qwen2-7b": 14, "qwen1.5-32b": 16}
# the dense float32 pairs: qwen1.5-32b at 8 layers
DENSE_F32_DEPTH = {"internlm2-1.8b": 12, "qwen2-7b": 14, "qwen1.5-32b": 8}
# A dense config's engine (K3/K4) against its teacher-forced forward. bf16:
# the paged path and the dense chunked path round apart through every
# layer, and at qwen1.5-32b's width the max over 256 tokens reaches 0.156
# nats, the same on the engine through the twins (H100 80GB HBM3, 700 W),
# so the bf16 bar is the mean over the tokens, TOL_LOGP_MEAN_BF16 (the Gemma2
# phase's), with the max printed against TOL_LOGP_PATHS; the float32 pair
# is held token by token to TOL_LOGP_F32, which a kernel fault breaks
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
SCOUT_LAYERS, SCOUT_F32_LAYERS, MAVERICK_LAYERS = 4, 2, 2
SCOUT_LEARN_LAYERS = 1
DENSE_NEW, MOE_NEW = 32, 32
LEARN_ROWS, SCOUT_LEARN_S, MAMBA_LEARN_S = 8, 512, 1024
LEARN_GROUP = 4                      # a microbatch (grad_accum 2) = 1 group
# learner batches: completion targets at the end of each row, the
# sampler's logps the App. B.1 recompute's plus seeded noise of this scale
# (a stale sampler), so the importance weights are not all 1
LEARN_NEW, SAMPLER_NOISE = 128, 0.05
# K1/K2 rows at the learners' microbatches (grad_accum 2 of 8 rows) and
# padded vocabularies
FAMILY_LOGPROB = (("llama4", 4 * (SCOUT_LEARN_S - 1), 202240),
                  ("mamba2-1.3b", 4 * (MAMBA_LEARN_S - 1), 50432))
# an MoE engine through K3/K4 against the same engine through the twins,
# same key. float32 (2 layers): routing and sampling cut-offs move only by
# float32 summation order (~1e-6 on probabilities), so every token is
# equal and the logps within TOL_LOGP_F32. bf16: a router whose top-2
# probabilities are within bf16 noise of each other routes a token to
# another expert on the two paths, which moves its logps far more than
# the attention's rounding does (no teacher-forced forward can stand in
# either: its capacity differs); the bar is the mean over each request's
# positions before its first differing token, TOL_LOGP_MEAN_BF16, with
# the max and the share above TOL_LOGP_PATHS printed. A kernel fault at
# rep 5 moves every token: the kernel rows at the family shapes hold K3/K4
# against their twins element by element


class DropLog:
    """``moe_drop_frac`` of every MoE layer call while active (spec_run's
    two warm-up requests, 64 + 8 tokens, included), by forward kind (a
    decode step feeds one token a row, S 1; a prefill chunk more), kept on
    the card and read after the run. On a serve plan a layer's metrics
    are the global dispatch's (``moe_ffn``) or, under ``moe_ep``, the
    reference's mean over the ranks (``moe_ffn_ep``)."""

    def __init__(self):
        self.fracs = {"decode": [], "prefill": []}

    def __enter__(self):
        self._real = {n: getattr(model_mod, n)
                      for n in ("moe_ffn", "moe_ffn_ep")}
        for name, real in self._real.items():
            def observed(cfg, p, x, real=real):
                y, aux = real(cfg, p, x)
                kind = "prefill" if x.shape[1] > 1 else "decode"
                self.fracs[kind].append(aux["moe_drop_frac"].detach())
                return y, aux
            setattr(model_mod, name, observed)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(model_mod, name, real)

    def lists(self):
        return {k: (torch.stack(v).float().cpu().tolist() if v else [])
                for k, v in self.fracs.items()}

    def summary(self):
        out = {}
        for kind, fr in self.fracs.items():
            v = torch.stack(fr).float().cpu().numpy() if fr else np.zeros(1)
            out[kind] = (len(fr), float(v.mean()), float(v.max()))
        return out


def family_prompts(vocab, seed):
    """8 prompts of 64-1024 tokens (both ends present)."""
    rng = np.random.default_rng(seed + 12)
    lens = [64, 1024] + [int(n) for n in rng.integers(64, 1025, 6)]
    return [rng.integers(3, vocab, n).astype(np.int32) for n in lens]


def load_family(name, seed, dev, dtype=None, **over):
    """Random weights (seed) for ``name`` at full width, depth cut by
    ``over``; returns (cfg, params)."""
    cfg = dataclasses.replace(get_config(name), paged_attn_impl="pallas",
                              **over)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=str(dtype)[6:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n = cfg.param_count()
    gb = n * torch.finfo(getattr(torch, cfg.dtype)).bits / 8e9
    log(f"[families] {cfg.name}: {cfg.num_layers}/"
        f"{get_config(name).num_layers} layers, d_model {cfg.d_model}, Hq "
        f"{cfg.num_heads} Hkv {cfg.num_kv_heads} (rep "
        f"{cfg.num_heads // max(cfg.num_kv_heads, 1)}), vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}), {n / 1e9:.3f}B "
        f"params {cfg.dtype} ({gb:.1f} GB), init "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, params


def free():
    """Return the card memory of what the caller just deleted."""
    gc.collect()
    torch.cuda.empty_cache()


def padded_rows(prompts, results, dev):
    """prompt + completion of each request, right-padded with 0 (PAD) to
    the longest: (B, L) on ``dev``."""
    rows = [np.concatenate([p, r.tokens]) for p, r in zip(prompts, results)]
    out = np.zeros((len(rows), max(len(r) for r in rows)), np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return torch.from_numpy(out).to(dev)


def recompute_gap(cfg, params, prompts, results, dev, rows=SLOTS):
    """The App. B.1 recompute (``token_logps``, K1) of every request's
    completion, ``rows`` requests a call right-padded: |recompute -
    sampler| over the generated tokens -> (max, mean, K1 launches)."""
    gaps = []
    fl.reset_launch_counts()
    for i in range(0, len(prompts), rows):
        ps, rs = prompts[i:i + rows], results[i:i + rows]
        lp = token_logps(cfg, params, padded_rows(ps, rs, dev)).cpu().numpy()
        for j, (p, r) in enumerate(zip(ps, rs)):
            got = lp[j, len(p) - 1:len(p) - 1 + r.gen_count]
            gaps.append(np.abs(got - r.logps))
        del lp
    g = np.concatenate(gaps)
    if not np.isfinite(g).all():
        raise AssertionError(f"{cfg.name}: non-finite recompute")
    return float(g.max()), float(g.mean()), fl.LAUNCHES["logprob_fwd"]


def dense_family(dev, seed, card, name, dtype=torch.bfloat16):
    """One dense config through ContinuousEngine (K3/K4) at ``dtype``:
    its logps against the teacher-forced forward (bf16: the mean within
    TOL_LOGP_MEAN_BF16; float32: every token within TOL_LOGP_F32),
    launches as the run implies, then one token_logps recompute (K1) of
    the 8 requests held to the same bar. Returns the launches."""
    f32 = dtype == torch.float32
    depth = (DENSE_F32_DEPTH if f32 else DENSE_DEPTH)[name]
    cfg, params = load_family(name, seed, dev, dtype=dtype, num_layers=depth)
    prompts = family_prompts(cfg.vocab_size, seed)
    torch.cuda.reset_peak_memory_stats()
    res, st, launches, tok_s, ms = spec_run(
        cfg, params, prompts, RLConfig(**SERVE_PROFILE), DENSE_NEW,
        cfg.vocab_size, 0, seed)
    diffs = []
    for p, r in zip(prompts, res):
        lp, _ = teacher_forced_logps(cfg, params, p, r.tokens, cfg.vocab_size)
        diffs.append(np.abs(lp - r.logps))
    d = np.concatenate(diffs)
    rmax, rmean, k1 = recompute_gap(cfg, params, prompts, res, dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if f32:
        bar, got, rgot = f"max <= {TOL_LOGP_F32}", float(d.max()), rmax
        ok = got <= TOL_LOGP_F32 and rmax <= TOL_LOGP_F32
    else:
        bar, got, rgot = f"mean <= {TOL_LOGP_MEAN_BF16}", float(d.mean()), \
            rmean
        ok = got <= TOL_LOGP_MEAN_BF16 and rmean <= TOL_LOGP_MEAN_BF16
    log(f"[families] {cfg.name} {cfg.dtype} serve: {len(prompts)} requests "
        f"of {min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{DENSE_NEW} new, temperature 0.6 / top-k 20 / top-p 0.95: "
        f"{ms:.2f} ms per decode step, {tok_s:.1f} decode tokens/s, "
        f"{st['decode_steps']} decode steps, {st['prefill_chunks']} prefill "
        f"chunks; launches {launches}; |engine logp - teacher-forced| over "
        f"{d.size} tokens: max {float(d.max()):.4f}, mean "
        f"{float(d.mean()):.2e}, {float((d > TOL_LOGP_PATHS).mean()):.4f} "
        f"above {TOL_LOGP_PATHS} ({bar}: {got:.3e}); recompute (K1 x {k1}) "
        f"|recompute - engine| max {rmax:.4f}, mean {rmean:.2e} ({bar}: "
        f"{rgot:.3e}); peak {peak:.2f} GiB | {card}")
    if not ok or k1 != 1:
        raise AssertionError(f"{cfg.name} {cfg.dtype}: engine or recompute "
                             f"logps off the teacher-forced forward")
    del params
    free()
    return {**launches, "logprob_fwd": k1}


def moe_pair(cfg, params, prompts, seed, label):
    """The serve traffic through the engine on K3/K4 and on the twins,
    same key; returns ({impl: results}, launches of the K3/K4 run, stats,
    decode ms per step, drop fractions of the K3/K4 run)."""
    rl = RLConfig(**SERVE_PROFILE)
    out = {}
    for impl in ("pallas", "ref"):
        icfg = dataclasses.replace(cfg, paged_attn_impl=impl)
        with DropLog() as drops:
            res, st, launches, tok_s, ms = spec_run(
                icfg, params, prompts, rl, MOE_NEW, cfg.vocab_size, 0, seed)
        out[impl] = res
        if impl == "pallas":
            info = (launches, st, ms, tok_s, drops.summary())
        log(f"[families] {label} ({impl}): {ms:.2f} ms per decode step, "
            f"{tok_s:.1f} decode tokens/s, {st['decode_steps']} decode "
            f"steps, {st['prefill_chunks']} prefill chunks, "
            f"{sum(r.gen_count for r in res)} tokens")
    return (out,) + info


def moe_diff(a_res, b_res):
    """Per request, the positions before the first differing token:
    (requests equal to the end, |dlogp| over those positions, first
    difference per request)."""
    same, diffs, first = 0, [], []
    for a, b in zip(a_res, b_res):
        n = min(a.gen_count, b.gen_count)
        neq = np.flatnonzero(a.tokens[:n] != b.tokens[:n])
        upto = int(neq[0]) if neq.size else n
        same += int(np.array_equal(a.tokens, b.tokens))
        diffs.append(np.abs(a.logps[:upto] - b.logps[:upto]))
        first.append(upto)
    return same, np.concatenate(diffs), first


def drops_line(drops):
    return ", ".join(f"{k} {n} layer calls mean {m:.4f} max {x:.4f}"
                     for k, (n, m, x) in drops.items())


def moe_serve(dev, seed, card):
    """Scout's float32 pair at 2 layers, scout bf16 at 8 layers, maverick
    bf16 at one period, each on K3/K4 against the twins with the same key;
    drops per forward kind and the sampler-vs-recompute gap."""
    launches = {"paged_decode": 0, "paged_prefill": 0, "logprob_fwd": 0}

    def add(d):
        for k in d:
            launches[k] += d[k]

    cfg, params = load_family(SCOUT, seed, dev, dtype=torch.float32,
                              num_layers=SCOUT_F32_LAYERS)
    prompts = engine_prompts(cfg, seed)
    runs, lc, st, ms, tok_s, drops = moe_pair(cfg, params, prompts, seed,
                                              "scout float32")
    add(lc)
    worst = max(float(np.abs(a.logps - b.logps).max())
                for a, b in zip(runs["pallas"], runs["ref"]))
    equal = all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(runs["pallas"], runs["ref"]))
    log(f"[families] scout float32 pair ({SCOUT_F32_LAYERS} layers, "
        f"{len(prompts)} requests, {MOE_NEW} new): tokens equal {equal}, "
        f"max |K3/K4 logp - twin logp| {worst:.2e} (<= {TOL_LOGP_F32}); "
        f"drops: {drops_line(drops)} | {card}")
    if not equal or worst > TOL_LOGP_F32:
        raise AssertionError("scout float32: the engine on K3/K4 and on "
                             "the twins disagree")
    del params, runs
    free()

    for name, layers in ((SCOUT, SCOUT_LAYERS), (MAVERICK, MAVERICK_LAYERS)):
        cfg, params = load_family(name, seed, dev, num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        runs, lc, st, ms, tok_s, drops = moe_pair(cfg, params, prompts,
                                                  seed, f"{cfg.name} bf16")
        add(lc)
        same, diffs, first = moe_diff(runs["pallas"], runs["ref"])
        rmax, rmean, k1 = recompute_gap(cfg, params, prompts,
                                        runs["pallas"], dev)
        add({"logprob_fwd": k1})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mean = float(diffs.mean()) if diffs.size else 0.0
        log(f"[families] {cfg.name} bf16 ({layers} layers, E "
            f"{cfg.num_experts}, top-{cfg.experts_per_token} + shared): "
            f"{ms:.2f} ms per decode step, {tok_s:.1f} decode tokens/s; "
            f"K3/K4 against the twins: {same}/{len(prompts)} requests equal "
            f"to the end, first differing token at {first}; over the "
            f"{diffs.size} positions before it mean |dlogp| {mean:.2e} "
            f"(<= {TOL_LOGP_MEAN_BF16}), max {float(diffs.max()):.4f}, "
            f"{float((diffs > TOL_LOGP_PATHS).mean()):.4f} of them above "
            f"{TOL_LOGP_PATHS}; moe_drop_frac: {drops_line(drops)}; "
            f"sampler vs App. B.1 recompute (K1 x {k1}, 8 requests a call, "
            f"right-padded): max |gap| {rmax:.4f}, mean {rmean:.4f}; launches "
            f"{lc}; peak {peak:.2f} GiB | {card}")
        if not mean <= TOL_LOGP_MEAN_BF16:
            raise AssertionError(f"{cfg.name} bf16: the engine on K3/K4 and "
                                 f"on the twins disagree")
        del params, runs
        free()
    return launches


def learner_rows(cfg, params, dev, seed, s, stub=None):
    """LEARN_ROWS rows of ``s`` random tokens, the last LEARN_NEW targets
    the completion, the sampler's logps the recompute's (K1) plus
    SAMPLER_NOISE, a Bernoulli(0.5) reward per row (groups of LEARN_GROUP,
    none all equal). ``stub`` ("frames" or "image_embeds") adds a modality
    stub per row, made as ``stub_input`` makes it, which rides in the
    batch (the recompute cross-attends to it, through ``encode`` for
    frames)."""
    rng = np.random.default_rng(seed + 13)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                           (LEARN_ROWS, s))).to(dev)
    mask = torch.zeros((LEARN_ROWS, s - 1), device=dev)
    mask[:, -LEARN_NEW:] = 1.0
    extra, memory = {}, None
    if stub is not None:
        extra[stub] = stub_input(cfg, LEARN_ROWS, seed, dev)
        with torch.no_grad():
            memory = (encode(cfg, params, extra[stub]) if stub == "frames"
                      else extra[stub])
    lp = token_logps(cfg, params, tokens, memory=memory)
    noise = torch.from_numpy(rng.normal(0.0, SAMPLER_NOISE, lp.shape)).to(
        dev, torch.float32)
    r = np.zeros(LEARN_ROWS, bool)
    for g in range(0, LEARN_ROWS, LEARN_GROUP):
        while r[g:g + LEARN_GROUP].all() or not r[g:g + LEARN_GROUP].any():
            r[g:g + LEARN_GROUP] = rng.random(LEARN_GROUP) < 0.5
    return {"tokens": tokens, "mask": mask,
            "sampler_lp": ((lp + noise) * mask).float(),
            "rewards": torch.from_numpy(r.astype(np.float32)).to(dev),
            **extra}


def learner_family(dev, seed, card, name, s, stub=None, **over):
    """GEPO on ``name`` at full width: K1/K2 against the twin through one
    rl_loss_fn forward and backward (the learner phase's bars), then 3
    train_steps (grad_accum 2, AdamW) with finite metrics; step ms and
    peak memory printed. ``stub`` puts a modality stub in the batch
    (``learner_rows``). Returns the K1/K2 launches."""
    cfg, params = load_family(name, seed, dev, **over)
    fl.reset_launch_counts()
    batch = learner_rows(cfg, params, dev, seed, s, stub)
    rl = RLConfig(loss_type="gepo", group_size=LEARN_GROUP, beta_kl=0.005)
    tc = TrainConfig(learning_rate=1e-6, grad_accum=2)
    launches = dict(fl.LAUNCHES)
    fused_vs_twin(cfg, rl, params, batch, f"{cfg.name}, B {LEARN_ROWS} x S "
                  f"{s}, V {cfg.padded_vocab}")
    for k in launches:
        launches[k] += fl.LAUNCHES[k]
    free()
    state = init_state(cfg, tc, params)
    fl.reset_launch_counts()
    tokens = LEARN_ROWS * (s - 1)
    for i in range(3):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(cfg, rl, tc, state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vals = {k: float(v) for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        moe = "".join(f" {k} {v:.4e}" for k, v in vals.items()
                      if k.startswith("moe_"))
        log(f"[families] {cfg.name} learner step {i + 1}: loss "
            f"{vals['loss']:.6e} kl {vals['kl']:.3e} iw_mean "
            f"{vals['iw_mean']:.6f} iw_max {vals['iw_max']:.6f} grad_norm "
            f"{vals['grad_norm']:.4e}{moe} | {dt * 1e3:.1f} ms, "
            f"{tokens / dt:.0f} learner tokens/s, peak {peak:.2f} GiB | "
            f"{card}")
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{cfg.name} step {i + 1}: non-finite "
                                 f"metrics {bad}")
        if MOE in cfg.ffn_pattern and not {
                "moe_load_balance", "moe_z_loss", "moe_drop_frac"} <= set(m):
            raise AssertionError(f"{cfg.name}: moe_* metrics missing")
    for k in launches:
        launches[k] += fl.LAUNCHES[k]
    # 1 recompute + 1 fused pass + 2 microbatches x 3 steps
    want = {"logprob_fwd": 1 + 1 + 6, "logprob_bwd": 1 + 6}
    log(f"[families] {cfg.name} learner launches: {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"{cfg.name} learner launches {launches} != "
                             f"{want}")
    del state, params, batch
    free()
    return launches


def logprob_rows(gen, dev, cases, tag):
    """K1/K2 at each (label, T, V) of ``cases`` in float32: against the
    twin (``logprob_check``), timed beside the twin, the bound and the
    library call. Returns {"logprob_fwd": rows, "logprob_bwd": rows}."""
    rows = {"logprob_fwd": [], "logprob_bwd": []}
    for label, t, v in cases:
        x, tgt, g_lp, g_ent = logprob_case(gen, dev, t, v, torch.float32)
        (ef, eb, rb), (lse, mu), tgt32 = logprob_check(
            x, tgt, g_lp, g_ent, f"({t}, {v}) f32, {label} learner")
        n = t * v
        for key, fn, plain, lib, nb, fo in (
                ("logprob_fwd", lambda: fl.logprob_fwd(x, tgt32),
                 lambda: fl._chunked_fwd_pass(x, tgt32, CHUNK),
                 lambda: torch.logsumexp(x, -1), n * 4 + 4 * t * 4, 6 * n),
                ("logprob_bwd",
                 lambda: fl.logprob_bwd(x, tgt32, lse, mu, g_lp, g_ent),
                 lambda: fl._chunked_bwd_pass(x, tgt32, lse, mu, g_lp,
                                              g_ent, CHUNK),
                 lambda: torch.softmax(x, -1), 2 * n * 4 + 5 * t * 4,
                 7 * n)):
            b_ms, b_by = bound(nb, fo, F32_FLOPS_S)
            row = dict(family=label, max_abs_err=ef if key == "logprob_fwd"
                       else eb, bound_ms=b_ms, bound_by=b_by,
                       ms=time_ms(fn), plain_ms=time_ms(plain, iters=5),
                       library_ms=time_ms(lib), shape=f"T={t} V={v} float32")
            if key == "logprob_bwd":
                row["err_ratio"] = rb
            rows[key].append(row)
            log(f"[{tag}] {'K1' if key == 'logprob_fwd' else 'K2'} "
                f"{label} (T {t}, V {v}): {row['ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), twin {row['plain_ms']:.3f} ms, "
                f"{'logsumexp' if key == 'logprob_fwd' else 'softmax'} "
                f"{row['library_ms']:.4f} ms")
        del x, lse, mu
        torch.cuda.empty_cache()
    return rows


def family_kernel_rows(dev, seed):
    """K3/K4 at each family's GQA group (8 slots up to 2048 keys; one
    512-token chunk after 1024), K5 at rep 5, K1/K2 at the two learners'
    microbatches and padded vocabularies: each against its twin, timed
    beside the twin, the bound and the library call."""
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    rows = {"paged_decode": [], "paged_prefill": [], "flash_attention": [],
            "logprob_fwd": [], "logprob_bwd": []}
    width = 2048 // PAGE
    lengths = [2048, 1537, 1024, 700, 333, 64, 1, width * PAGE + 1]
    live = slice(0, SLOTS - 1)
    for label, hkv, rep in (("internlm2-1.8b", 8, 2), ("qwen2-7b", 4, 7),
                            ("qwen1.5-32b", 40, 1), ("llama4", 8, 5)):
        hq = hkv * rep
        q, kp, vp, table, lens = decode_case(gen, dev, lengths, width, hq,
                                             hkv)
        err = max_err(pa.paged_attention(q, kp, vp, table, lens),
                      pa.paged_decode_ref(q.float(), kp.float(), vp.float(),
                                          table, lens), live)
        b_ms, b_by = decode_bound(q, table, lengths, width, hkv)
        row = dict(family=label, max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by,
                   ms=time_ms(lambda: pa.paged_attention(q, kp, vp, table,
                                                         lens)),
                   plain_ms=time_ms(lambda: pa.paged_decode_ref(
                       q, kp, vp, table, lens), iters=5),
                   library_ms=library_ms(*sdpa_decode(q, kp, vp, table,
                                                      lens)),
                   shape=f"B={SLOTS} Hq={hq} Hkv={hkv} D={D} page={PAGE} "
                         f"lengths={lengths} bf16")
        rows["paged_decode"].append(row)
        log(f"[families] K3 {label} (Hq {hq}, Hkv {hkv}): max|err| "
            f"{err:.3e}, {row['ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"twin {row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} ms")
        if not err <= TOL_BF16:
            raise AssertionError(f"K3 at {label}'s GQA disagrees with its "
                                 f"twin")
        c, start = 512, 1024
        q, kp, vp, table, pos = prefill_case(gen, dev, c, start, hq, hkv)
        err = max_err(ops.paged_prefill(q, kp, vp, table, pos, impl="pallas"),
                      ops.paged_prefill(q.float(), kp.float(), vp.float(),
                                        table, pos, impl="ref"))
        kv_elems = -(-(start + c) // PAGE) * PAGE * hkv * D * 2
        b_ms, b_by = bound(kv_elems * 2 + 2 * q.numel() * 2
                           + table.numel() * 4,
                           sum(4 * hq * D * (start + i + 1)
                               for i in range(c)))
        row = dict(family=label, max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by,
                   ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                                        impl="pallas")),
                   plain_ms=time_ms(lambda: ops.paged_prefill(
                       q, kp, vp, table, pos, impl="ref"), iters=5),
                   library_ms=library_ms(*sdpa_prefill(q, kp, vp, table,
                                                       pos)),
                   shape=f"B=1 C={c} start={start} Hq={hq} Hkv={hkv} D={D} "
                         f"page={PAGE} bf16")
        rows["paged_prefill"].append(row)
        log(f"[families] K4 {label} (Hq {hq}, Hkv {hkv}, C {c} after "
            f"{start}): max|err| {err:.3e}, {row['ms']:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}), twin {row['plain_ms']:.3f} ms, SDPA "
            f"{row['library_ms']:.4f} ms")
        if not err <= TOL_BF16:
            raise AssertionError(f"K4 at {label}'s GQA disagrees with its "
                                 f"twin")
        del q, kp, vp, table
    # K5 at llama4's rep 5: the scout learner's microbatch
    b, s, hq, hkv = 4, SCOUT_LEARN_S - 1, 40, 8
    q = torch.randn((b, s, hq, D), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, hkv, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    err = max_err(fa.flash_attention(q, k, v, causal=True),
                  fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal=True))
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                       4 * D * hq * b * flash_pairs(s, True, None))
    row = dict(family="llama4", max_abs_err=err, bound_ms=b_ms,
               bound_by=b_by,
               ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                          iters=10),
               plain_ms=time_ms(lambda: fa.flash_attention_ref(
                   q, k, v, causal=True), iters=3, warmup=1),
               library_ms=sdpa_flash(q, k, v, True, None),
               shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={D} causal bf16")
    rows["flash_attention"].append(row)
    log(f"[families] K5 llama4 (rep 5, B {b}, S {s}): max|err| {err:.3e} "
        f"(tol {TOL_FLASH[torch.bfloat16]}), {row['ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), twin {row['plain_ms']:.3f} ms, SDPA "
        f"{row['library_ms']:.4f} ms")
    if not err <= TOL_FLASH[torch.bfloat16]:
        raise AssertionError("K5 at rep 5 disagrees with its twin")
    del q, k, v
    for key, got in logprob_rows(gen, dev, FAMILY_LOGPROB, "families"
                                 ).items():
        rows[key] += got
    return rows


def families_phase(dev, seed, card):
    """Phase 12. Returns (launches by kernel, kernel rows at the family
    shapes)."""
    t0 = time.perf_counter()
    rows = family_kernel_rows(dev, seed)
    log(f"[time] families: kernel rows {time.perf_counter() - t0:.1f}s")
    launches = {k: 0 for k in ("paged_decode", "paged_prefill",
                               "logprob_fwd", "logprob_bwd")}

    def add(d):
        for k, n in d.items():
            launches[k] += n
    for name in DENSE_DEPTH:
        t0 = time.perf_counter()
        for dtype in (torch.bfloat16, torch.float32):
            add(dense_family(dev, seed, card, name, dtype))
        log(f"[time] families: {name} {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    add(moe_serve(dev, seed, card))
    log(f"[time] families: MoE serve {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    add(learner_family(dev, seed, card, SCOUT, SCOUT_LEARN_S,
                       num_layers=SCOUT_LEARN_LAYERS))
    log(f"[time] families: scout learner {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    # mamba2's random tied embedding puts a token's own logit ~1500 nats up
    # (TOL_SSD_MEAN_BF16), where a bf16 logit moves in steps of 8: once a
    # step moves any weight, kl reads ~1e2 with random weights; the check
    # is finite metrics, as for every learner here
    add(learner_family(dev, seed, card, "mamba2-1.3b", MAMBA_LEARN_S))
    log(f"[time] families: mamba2 learner {time.perf_counter() - t0:.1f}s")
    log(f"[families] launches: {launches}")
    return launches, rows


# --------------------------------------------------------------------------
# phase 13: the modality-memory families and jamba's full-width pieces

VLM, WHISPER, JAMBA = ("llama-3.2-vision-11b", "whisper-small",
                       "jamba-1.5-large-398b")
# the serve traffic: MEM_ROWS requests of 64-832 tokens left-padded with
# PAD to 832 (the static engine's batch is rectangular; the sampler nodes
# left-pad their prompts the same way), MEM_NEW new, the serve profile;
# the memory has one row per request
MEM_ROWS, MEM_MIN_PROMPT, MEM_PROMPT, MEM_NEW = 8, 64, 832, 64
# the float32 pairs: greedy, MEM_F32_NEW new, N(0, 1) memory; the VLM at
# one period (4 self-attention layers + 1 CROSS; 8.6 GB in float32),
# Whisper whole
MEM_F32_NEW, VLM_F32_LAYERS = 16, 5
# depth cut, width never cut: the VLM learner at one period of 5 layers
# (2.14B params, ~26 GB of weights, AdamW moments and the float32
# gradient sum before activations; all 40 layers would take ~117 GB)
VLM_LEARN_LAYERS = 5
MEM_LEARN_S = 512                  # the learners' rows: B 8 x S 512
# launch/serve.py's VLM stub: 0.02 N(0, 1) patch embeddings
STUB_SCALE = 0.02
# Whisper's encoder output through K5 against the chunked attention,
# float32 (summation order through 12 layers of unit-RMS activations)
TOL_ENC_F32 = 1e-4
# K5 at the cross-attention and encoder shapes: (label, B, Sq, Sk, Hq, Hkv,
# D), non-causal; bf16 and float32 each
MEMORY_FLASH_CASES = (
    ("vlm decode cross", 8, 1, 1601, 32, 8, 128),
    ("vlm prefill cross", 8, 832, 1601, 32, 8, 128),
    ("whisper encoder", 8, 1500, 1500, 12, 12, 64),
    ("whisper decode cross", 8, 1, 1500, 12, 12, 64),
    ("whisper prefill cross", 8, 192, 1500, 12, 12, 64),
)
# K1/K2 at the two learners' microbatches and padded vocabularies
MEMORY_LOGPROB = (("llama-3.2-vision-11b", 4 * (MEM_LEARN_S - 1), 128256),
                  ("whisper-small", 4 * (MEM_LEARN_S - 1), 51968))
# one jamba MoE layer (E 16 top-2, d 8192, f 24576) on the card against
# the CPU on the same bf16 inputs: the router is float32 on both, so the
# drops must be equal; the expert products are bf16 sums in another order
# (|y| ~ 0.5, a bf16 ulp there 2e-3), held to this share of max|y_cpu|
JAMBA_MOE_TOKENS = 128
JAMBA_SSD_S = 4096                 # K6 at jamba's layer: B 1 x S 4096
TOL_MOE_CARD_CPU = 2e-2


def memory_flash_rows(dev, seed):
    """K5 at the new shapes, non-causal, in bf16 and float32: each against
    its twin, timed beside the twin, SDPA (GQA, no mask) and the bound.
    The last memory row has k 0 and v 1000, so it carries ~1000 / (Sk
    e^0.5) ~ 0.4 of every output: the control, the twin over Sk - 1 keys
    (a kernel that drops the last memory row), must be off by more than
    ten bars."""
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    rows = []
    for label, b, sq, sk, hq, hkv, d in MEMORY_FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
            k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=dev)
                    for _ in range(2))
            k[:, -1], v[:, -1] = 0.0, 1000.0
            q, k, v = (t.to(dtype) for t in (q, k, v))
            f32 = [t.float() for t in (q, k, v)]
            got = fa.flash_attention(q, k, v, causal=False)
            want = fa.flash_attention_ref(*f32, causal=False)
            torch.cuda.synchronize()
            err, tol = max_err(got, want), TOL_FLASH[dtype]
            drop = max_err(fa.flash_attention_ref(
                f32[0], f32[1][:, :-1], f32[2][:, :-1], causal=False), want)
            finite = bool(torch.isfinite(got.float()).all())
            del want, got, f32
            nbytes = q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel())
            b_ms, b_by = bound(nbytes, 4 * d * hq * b * sq * sk,
                               BF16_FLOPS_S if dtype == torch.bfloat16
                               else F32_FLOPS_S)
            row = dict(case=label, max_abs_err=err, tol=tol,
                       control_drop_last_row=drop, bound_ms=b_ms,
                       bound_by=b_by,
                       ms=time_ms(lambda: fa.flash_attention(
                           q, k, v, causal=False), iters=10),
                       plain_ms=time_ms(lambda: fa.flash_attention_ref(
                           q, k, v, causal=False), iters=3, warmup=1),
                       library_ms=sdpa_flash(q, k, v, False, None),
                       shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} "
                             f"D={d} non-causal {str(dtype)[6:]}")
            rows.append(row)
            log(f"[memory] K5 {label} (B {b}, Sq {sq}, Sk {sk}, Hq {hq}, "
                f"Hkv {hkv}, D {d}, {str(dtype)[6:]}): max|err| {err:.3e} "
                f"(tol {tol}); twin over Sk - 1 keys {drop:.3e} (must be > "
                f"{10 * tol}); {row['ms']:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), twin {row['plain_ms']:.3f} ms, SDPA "
                f"{row['library_ms']:.4f} ms")
            if not err <= tol or not finite:
                raise AssertionError(f"K5 disagrees with its twin ({label}, "
                                     f"{dtype})")
            if not drop > 10 * tol:
                raise AssertionError(f"K5's check cannot see a dropped "
                                     f"memory row ({label})")
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def memory_prompts(vocab, seed):
    """MEM_ROWS prompts of MEM_MIN_PROMPT-MEM_PROMPT tokens (both ends
    present), left-padded with PAD to MEM_PROMPT: (MEM_ROWS, MEM_PROMPT)
    int32."""
    rng = np.random.default_rng(seed + 13)
    lens = [MEM_MIN_PROMPT, MEM_PROMPT] + [int(n) for n in rng.integers(
        MEM_MIN_PROMPT, MEM_PROMPT + 1, MEM_ROWS - 2)]
    out = np.full((MEM_ROWS, MEM_PROMPT), PAD, np.int32)
    for i, n in enumerate(lens):
        out[i, MEM_PROMPT - n:] = rng.integers(3, vocab, n)
    return out


def stub_input(cfg, rows, seed, dev, scale=None):
    """A modality stub of ``rows`` rows in ``cfg.dtype`` from a generator
    seeded by ``seed``: N(0, 1) frame embeddings (rows, encoder_seq, d) for
    an encoder-decoder model, STUB_SCALE N(0, 1) patch embeddings (rows,
    memory_seq, d) for a CROSS model (``scale`` overrides), as
    ``launch/serve.py`` stubs them."""
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    n = cfg.encoder_seq if cfg.is_encdec else cfg.memory_seq
    if scale is None:
        scale = 1.0 if cfg.is_encdec else STUB_SCALE
    x = torch.randn((rows, n, cfg.d_model), generator=gen, device=dev)
    return (scale * x).to(getattr(torch, cfg.dtype))


def cross_layers(cfg):
    """(self-attention layers, cross-attention sub-layers) of a model."""
    if cfg.is_encdec:
        return cfg.num_layers, cfg.num_layers
    n = cfg.block_pattern.count(CROSS) * cfg.num_blocks
    return cfg.num_layers - n, n


def memory_encode(cfg, params, frames, card):
    """Whisper's encoder over ``frames`` through K5 (bidir, one launch a
    layer) and through the chunked attention, timed; the two memories
    must agree (bf16: the mean |diff| within TOL_BF16; float32: the max
    within TOL_ENC_F32). Returns (the K5 memory, K5 launches)."""
    out, ms = {}, {}
    for impl in ("pallas", "chunked"):
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out[impl] = encode(icfg, params, frames)
        torch.cuda.synchronize()
        ms[impl] = (time.perf_counter() - t0) * 1e3
        got = counts()["flash_attention"]
        want = cfg.encoder_layers if impl == "pallas" else 0
        if got != want:
            raise AssertionError(f"encode ({impl}) launched K5 {got} times, "
                                 f"want {want}")
    diff = (out["pallas"].float() - out["chunked"].float()).abs()
    f32 = cfg.dtype == "float32"
    got, bar = ((float(diff.max()), TOL_ENC_F32) if f32
                else (float(diff.mean()), TOL_BF16))
    log(f"[memory] {cfg.name} {cfg.dtype} encode over {tuple(frames.shape)}: "
        f"through K5 ({cfg.encoder_layers} launches, bidir S "
        f"{frames.shape[1]}) {ms['pallas']:.1f} ms, chunked "
        f"{ms['chunked']:.1f} ms; |K5 - chunked| max "
        f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e} "
        f"({'max' if f32 else 'mean'} <= {bar}) | {card}")
    if not got <= bar or not torch.isfinite(out["pallas"].float()).all():
        raise AssertionError(f"{cfg.name}: encode through K5 disagrees")
    return out["pallas"], cfg.encoder_layers


def memory_serve(cfg, params, memory, prompts, seed, card):
    """The static engine with ``memory`` (attn_impl "pallas"): the serve
    traffic, the K5 launches the run implies (prefill: every self- and
    cross-attention; each decode step: every cross-attention), the decode
    ms per step, then the App. B.1 recompute through K5 and through the
    chunked attention in turns: the mean |K5 - chunked| and the mean |K5
    recompute - sampler| within TOL_LOGP_MEAN_BF16 (bf16 noise through
    every layer; the max printed against TOL_LOGP_PATHS). Returns the K5
    and K1 launches (``recompute`` holds each run to one K1 launch)."""
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    rl = RLConfig(**SERVE_PROFILE)
    eng = build_engine(cfg, params, ServeConfig(engine="static", seed=seed),
                       rl=rl, vocab_limit=cfg.vocab_size, memory=memory,
                       key=prng.PRNGKey(seed))
    sp = SamplingParams.from_rl(rl, max_new=MEM_NEW)
    # warm-up: cuBLAS handles, allocator, first launches
    eng.generate([Request(rid=100 + i, prompt=prompts[i, -MEM_MIN_PROMPT:],
                          params=SamplingParams.from_rl(rl, max_new=4))
                  for i in range(MEM_ROWS)])
    reqs = [Request(rid=i, prompt=p, params=sp) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    got = counts()
    n_self, n_cross = cross_layers(cfg)
    want = {k: 0 for k in got}
    want["flash_attention"] = n_self + n_cross + n_cross * (MEM_NEW - 1)
    if got != want:
        raise AssertionError(f"{cfg.name} static rollout launched {got}, "
                             f"want {want}")
    k5 = got["flash_attention"]
    for r in res:
        if not np.isfinite(r.logps).all() or (r.logps > 1e-6).any() or \
                (r.tokens < 0).any() or (r.tokens >= cfg.vocab_size).any():
            raise AssertionError(f"{cfg.name} request {r.rid}: bad tokens or "
                                 f"logps")
    toks = torch.from_numpy(prompts.astype(np.int64)).to(
        params["embed"].device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = init_cache(cfg, params, MEM_ROWS, MEM_PROMPT + MEM_NEW,
                           memory=memory)
        forward(cfg, params, toks, cache=cache, memory=memory)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
    del cache
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = sum(r.gen_count for r in res)
    dec_ms = (t_roll - t_pre) * 1e3 / (MEM_NEW - 1)
    log(f"[memory] {cfg.name} {cfg.dtype} static engine, memory "
        f"{tuple(memory.shape)}: {MEM_ROWS} requests of "
        f"{MEM_MIN_PROMPT}-{MEM_PROMPT} "
        f"tokens (left-padded to {MEM_PROMPT}), {MEM_NEW} new, temperature "
        f"0.6 / top-k 20 / top-p 0.95: {n_tok} tokens in {t_roll:.2f}s; "
        f"prefill alone (cache + memory projections + forward) "
        f"{t_pre * 1e3:.1f} ms, decode {dec_ms:.2f} ms per step (rollout "
        f"minus prefill over {MEM_NEW - 1} decode steps); K5 launches {k5} "
        f"= {n_self} self + {n_cross} cross (prefill) + {n_cross} x "
        f"{MEM_NEW - 1} cross (decode); peak {peak:.2f} GiB | {card}")
    roll = rollout_from_results(prompts, res, MEM_NEW, device=toks.device)
    tokens = roll["tokens"]
    lps, ms = {}, {"pallas": [], "chunked": []}
    runs = ("pallas", "chunked", "chunked", "pallas")
    for impl in runs:
        lp, t, n = recompute(cfg, params, tokens, impl,
                             n_self + n_cross if impl == "pallas" else 0,
                             memory=memory)
        k5 += n
        lps[impl] = lp
        ms[impl].append(t)
    d = (lps["pallas"] - lps["chunked"]).abs()
    mask = roll["comp_mask"] > 0
    gap = (lps["pallas"][:, MEM_PROMPT - 1:] - roll["sampler_lp"]).abs()[mask]
    log(f"[memory] {cfg.name} recompute over {tuple(tokens.shape)}: through "
        f"K5 {' / '.join(f'{t:.1f}' for t in ms['pallas'])} ms, chunked "
        f"{' / '.join(f'{t:.1f}' for t in ms['chunked'])} ms (K5 "
        f"{n_self + n_cross} + K1 1 launches a K5 run); |K5 - chunked| mean "
        f"{float(d.mean()):.3e} max {float(d.max()):.4f}; |K5 recompute - "
        f"sampler| over {int(mask.sum())} generated tokens mean "
        f"{float(gap.mean()):.3e} max {float(gap.max()):.4f} (means <= "
        f"{TOL_LOGP_MEAN_BF16}; max against {TOL_LOGP_PATHS} printed) | "
        f"{card}")
    if not float(d.mean()) <= TOL_LOGP_MEAN_BF16 or \
            not float(gap.mean()) <= TOL_LOGP_MEAN_BF16:
        raise AssertionError(f"{cfg.name}: the recompute through K5 "
                             f"disagrees")
    return {"flash_attention": k5, "logprob_fwd": len(runs)}


def memory_f32_pair(cfg, params, memory, prompts, card):
    """The float32 check of one memory model, greedy through K5: the
    static engine's logps (its decode steps attend the cached memory
    through K5 at Sq 1) and the recompute through K5 against the recompute
    through the chunked attention, every token within TOL_LOGP_F32. The
    control: the recompute with the memory zeroed must miss that bar.
    Returns the K5 and K1 launches."""
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    rl = RLConfig(temperature=1.0, top_k=1, top_p=1.0)
    eng = build_engine(cfg, params, ServeConfig(engine="static"), rl=rl,
                       vocab_limit=cfg.vocab_size, memory=memory,
                       key=prng.PRNGKey(0))
    sp = SamplingParams.from_rl(rl, max_new=MEM_F32_NEW)
    reset_counts()
    res = eng.generate([Request(rid=i, prompt=p, params=sp)
                        for i, p in enumerate(prompts)])
    k5 = counts()["flash_attention"]
    roll = rollout_from_results(prompts, res, MEM_F32_NEW,
                                device=params["embed"].device)
    tokens, mask = roll["tokens"], roll["comp_mask"] > 0
    n_self, n_cross = cross_layers(cfg)
    lp_k5, _, n = recompute(cfg, params, tokens, "pallas", n_self + n_cross,
                            memory=memory)
    k5 += n
    lp_ch, _, _ = recompute(cfg, params, tokens, "chunked", 0, memory=memory)
    lp_0, _, n = recompute(cfg, params, tokens, "pallas", n_self + n_cross,
                           memory=torch.zeros_like(memory))
    k5 += n
    eng_d = float((lp_ch[:, MEM_PROMPT - 1:] - roll["sampler_lp"]).abs()[
        mask].max())
    rec_d = float((lp_k5 - lp_ch).abs().max())
    zero_d = float((lp_0 - lp_ch).abs().max())
    log(f"[memory] {cfg.name} float32 ({cfg.num_layers} layers, memory "
        f"{tuple(memory.shape)} at N(0, 1) scale), greedy, {MEM_F32_NEW} "
        f"new: max |engine logp (K5 decode) - chunked recompute| "
        f"{eng_d:.3e}, max |K5 recompute - chunked recompute| {rec_d:.3e} "
        f"(both <= {TOL_LOGP_F32}); control, the memory zeroed: "
        f"{zero_d:.3e} (must be > {TOL_LOGP_F32}) | {card}")
    if not eng_d <= TOL_LOGP_F32 or not rec_d <= TOL_LOGP_F32:
        raise AssertionError(f"{cfg.name} float32: K5 disagrees with the "
                             f"chunked attention")
    if not zero_d > TOL_LOGP_F32:
        raise AssertionError(f"{cfg.name} float32: the check cannot see a "
                             f"dropped memory")
    return {"flash_attention": k5, "logprob_fwd": 3}


def vlm_models(dev, seed, card):
    """The VLM at full depth in bf16 (serve + recompute), then its float32
    pair at one period. Returns the launches."""
    launches = {"flash_attention": 0, "logprob_fwd": 0}

    def add(d):
        for k, n in d.items():
            launches[k] += n
    cfg, params = load_family(VLM, seed, dev)
    prompts = memory_prompts(cfg.vocab_size, seed)
    memory = stub_input(cfg, MEM_ROWS, seed, dev)
    add(memory_serve(cfg, params, memory, prompts, seed, card))
    del params, memory
    free()
    cfg, params = load_family(VLM, seed, dev, dtype=torch.float32,
                              num_layers=VLM_F32_LAYERS)
    memory = stub_input(cfg, MEM_ROWS, seed + 1, dev, scale=1.0)
    add(memory_f32_pair(cfg, params, memory, prompts, card))
    del params, memory
    free()
    return launches


def whisper_models(dev, seed, card):
    """Whisper whole in bf16 (encode through K5, serve + recompute), then
    in float32 (encode, the float32 pair). Returns the launches."""
    launches = {"flash_attention": 0, "logprob_fwd": 0}

    def add(d):
        for k, n in d.items():
            launches[k] += n
    for dtype in (torch.bfloat16, torch.float32):
        cfg, params = load_family(WHISPER, seed, dev, dtype=dtype)
        prompts = memory_prompts(cfg.vocab_size, seed)
        frames = stub_input(cfg, MEM_ROWS, seed, dev)
        memory, n = memory_encode(cfg, params, frames, card)
        add({"flash_attention": n})
        if dtype == torch.bfloat16:
            add(memory_serve(cfg, params, memory, prompts, seed, card))
        else:
            add(memory_f32_pair(cfg, params, memory, prompts, card))
        del params, memory, frames
        free()
    return launches


def jamba_pieces(dev, seed, card):
    """Jamba's full-width pieces one at a time: K6 at its SSM layer (256
    heads, P 64, N 128, G 1, B 1 x S 4096) against its twin, timed; one
    MoE layer (E 16 top-2, d 8192, f 24576, 9.66B params, 19.3 GB bf16)
    through ``moe_ffn`` on the card against the CPU on the same inputs,
    drops equal. Returns the K6 row."""
    cfg = get_config(JAMBA)
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    row = ssd_row(gen, dev, "jamba layer", 1, JAMBA_SSD_S, cfg.ssm_heads,
                  cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state,
                  cfg.ssm_chunk, torch.bfloat16, True)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        for i in range(shape[0]):          # float32 one expert at a time
            out[i] = scale * torch.randn(shape[1:], generator=gen,
                                         device=dev)
        return out
    out_scale = 0.02 / np.sqrt(2 * cfg.num_layers)
    p = {"router": normal((d, e), 0.02), "w_gate": normal((e, d, f), 0.02),
         "w_up": normal((e, d, f), 0.02), "w_down": normal((e, f, d),
                                                           out_scale)}
    x = torch.randn((1, JAMBA_MOE_TOKENS, d), generator=gen,
                    device=dev).bfloat16()
    n = sum(t.numel() for t in p.values())
    with torch.no_grad():
        y, aux = moe_ffn(cfg, p, x)
        torch.cuda.synchronize()
        ms = time_ms(lambda: moe_ffn(cfg, p, x), iters=5, warmup=1)
        pc = {k: t.cpu() for k, t in p.items()}
        del p
        free()
        t0 = time.perf_counter()
        y_cpu, aux_cpu = moe_ffn(cfg, pc, x.cpu())
        cpu_s = time.perf_counter() - t0
    del pc
    rel = float((y.cpu().float() - y_cpu.float()).abs().max()) / float(
        y_cpu.float().abs().max())
    auxs = {k: (float(aux[k]), float(aux_cpu[k])) for k in aux}
    log(f"[memory] jamba MoE layer (E {e} top-{cfg.experts_per_token}, d "
        f"{d}, f {f}, {n / 1e9:.2f}B params bf16), x (1, "
        f"{JAMBA_MOE_TOKENS}, {d}): card {ms:.3f} ms, CPU {cpu_s:.1f} s; "
        f"max|card - CPU| / max|CPU| {rel:.3e} (<= {TOL_MOE_CARD_CPU}); "
        f"aux card / CPU "
        + ", ".join(f"{k} {a:.6g} / {b:.6g}" for k, (a, b) in auxs.items())
        + f" | {card}")
    if not rel <= TOL_MOE_CARD_CPU or not torch.isfinite(y.float()).all():
        raise AssertionError("jamba MoE layer: card and CPU disagree")
    if auxs["moe_drop_frac"][0] != auxs["moe_drop_frac"][1]:
        raise AssertionError("jamba MoE layer: drops differ on card and CPU")
    for k in ("moe_load_balance", "moe_z_loss"):
        a, b = auxs[k]
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"jamba MoE layer: {k} differs")
    del y, x
    free()
    return row


def memory_phase(dev, seed, card):
    """Phase 13. Returns (launches by kernel, kernel rows)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    rows = {"flash_attention": memory_flash_rows(dev, seed)}
    rows.update(logprob_rows(gen, dev, MEMORY_LOGPROB, "memory"))
    log(f"[time] memory: kernel rows {time.perf_counter() - t0:.1f}s")
    launches = {k: 0 for k in ("flash_attention", "logprob_fwd",
                               "logprob_bwd")}

    def add(d):
        for k, n in d.items():
            launches[k] += n
    for label, fn in (("VLM", vlm_models), ("whisper", whisper_models)):
        t0 = time.perf_counter()
        add(fn(dev, seed, card))
        log(f"[time] memory: {label} {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    add(learner_family(dev, seed, card, WHISPER, MEM_LEARN_S,
                       stub="frames"))
    log(f"[time] memory: whisper learner {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    add(learner_family(dev, seed, card, VLM, MEM_LEARN_S,
                       stub="image_embeds", num_layers=VLM_LEARN_LAYERS))
    log(f"[time] memory: VLM learner {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rows["ssd_scan"] = [jamba_pieces(dev, seed, card)]
    log(f"[time] memory: jamba pieces {time.perf_counter() - t0:.1f}s")
    log(f"[memory] launches: {launches}")
    return launches, rows


# --------------------------------------------------------------------------
# phase 14: the sharded learner (parallel/, ExecutionPlan)

# phases 14-17's two-rank parts run in one pair of rank processes on the
# one card (gloo with CUDA tensors: NCCL refuses two ranks on one device),
# started once: a process takes seconds to reach the card. Each part has a
# process group of its own, destroyed before the next part's
RANKS_TIMEOUT_S = 900


def ranks_main(rank, world, work, seed, card):
    """One of the two rank processes (``--rank``): phases 14-17's two-rank
    parts one after the other, each writing ``work/<part><r>.json``; then
    ``work/times<r>.json``, each part's seconds."""
    secs = {}
    for name, part in (("shard", shard_rank_main), ("serve", serve_rank_main),
                       ("static", static_rank_main), ("moe", moe_rank_main)):
        t0 = time.perf_counter()
        part(rank, world, work, seed, card)
        free()
        secs[name] = time.perf_counter() - t0
    with open(Path(work) / f"times{rank}.json", "w") as fh:
        json.dump({**secs, "f32_launches": F32_TALLY}, fh)
    return 0


def rank_pair(seed, card):
    """Start the two rank processes and wait for them: ``{part: [rank 0's
    record, rank 1's]}`` for the parts shard (14), serve (15), static (16)
    and moe (17), rank 0's seconds of each under ``t_part``. A rank's
    output goes to a file (a full pipe would stop it inside a
    collective); the ``[sharded]`` lines are printed here."""
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-ranks-"))
    files = [open(work / f"log{r}.txt", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--rank-work", str(work), "--seed", str(seed), "--rank-card", card],
        stdout=files[r], stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        for pr in procs:
            pr.wait(timeout=RANKS_TIMEOUT_S)
    finally:
        for pr in procs:
            pr.kill()
            pr.wait()
        for fh in files:
            fh.close()
    logs = [(work / f"log{r}.txt").read_text() for r in range(2)]
    for r, text in enumerate(logs):
        for line in text.splitlines():
            if line.startswith("[sharded]"):
                log(line + f" (rank {r})")
    if any(pr.returncode != 0 for pr in procs):
        raise AssertionError("the rank processes failed:\n" + "\n".join(
            t[-3000:] for t in logs))
    secs = json.loads((work / "times0.json").read_text())
    for r in range(2):
        tally = json.loads((work / f"times{r}.json").read_text())
        for k, n in tally["f32_launches"].items():
            F32_TALLY[k] += n
    out = {}
    for part, stem in (("shard", "rank"), ("serve", "serve"),
                       ("static", "static"), ("moe", "moe")):
        out[part] = [json.loads((work / f"{stem}{r}.json").read_text())
                     for r in range(2)]
        out[part][0]["t_part"] = secs[part]
    return out


SHARD_ROWS_A, SHARD_ROWS_B, SHARD_S = 16, 8, 1024
SHARD_F32_LAYERS = 4                  # the float32 pair: 4 of 28 layers
SHARD_BF16_LAYERS = 4                 # the timed bf16 steps: 4 of 28
# the parity bars of tests/test_parallel_parity.py
SHARD_RTOL_P, SHARD_ATOL_P, SHARD_RTOL_M, SHARD_ATOL_M = 5e-4, 1e-5, 2e-3, \
    1e-5
# one llama4-scout MoE layer at full width through moe_ep="train" on the
# two-rank mesh, float32, a capacity that drops nothing (cap = T k)
SHARD_MOE_ROWS, SHARD_MOE_S = 4, 512
TOL_SHARD_MOE = 1e-4                  # max|EP - moe_ffn| / max|moe_ffn|


def shard_batch(cfg, rows, s, seed, dev):
    """``rows`` rows of ``s`` random tokens, the last NEW_TOKENS targets
    the completion, the sampler's logps at the random policy's level
    (-log V) plus seeded noise, a Bernoulli(0.5) reward per row (groups
    of ``rows // 2``, none all equal: each microbatch of grad_accum 2 is
    one group). The same on every rank (numpy, ``seed``)."""
    rng = np.random.default_rng(seed + 40)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                           (rows, s))).to(dev)
    mask = torch.zeros((rows, s - 1), device=dev)
    mask[:, -NEW_TOKENS:] = 1.0
    lp = -np.log(cfg.padded_vocab) + rng.normal(0.0, SAMPLER_NOISE,
                                                (rows, s - 1))
    g = rows // 2
    r = np.zeros(rows, bool)
    for i in range(0, rows, g):
        while r[i:i + g].all() or not r[i:i + g].any():
            r[i:i + g] = rng.random(g) < 0.5
    return {"tokens": tokens, "mask": mask,
            "sampler_lp": torch.from_numpy(lp).to(dev, torch.float32) * mask,
            "rewards": torch.from_numpy(r.astype(np.float32)).to(dev)}


def shard_steps(step, state, batch, n, label, card, rank=0):
    """``n`` steps of ``step``; their ms, peak GiB and metrics. Prints a
    line per step (rank 0)."""
    out = []
    for i in range(n):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vals = {k: float(v) for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out.append((dt * 1e3, peak, vals))
        if rank == 0:
            log(f"[sharded] {label} step {i + 1}: loss {vals['loss']:.6e} "
                f"iw_mean {vals['iw_mean']:.6f} grad_norm "
                f"{vals['grad_norm']:.4e} | {dt * 1e3:.1f} ms, peak "
                f"{peak:.2f} GiB | {card}")
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{label} step {i + 1}: non-finite {bad}")
    return state, out


def one_rank_nccl(dev, seed, card, work):
    """Phase 14 (a): the sharded step on a 1x1 mesh of a one-rank NCCL
    group (every collective runs) against ``train_step`` from the same
    state and batch: qwen3-1.7b bf16, B 16 x S 1024, grad_accum 2, AdamW,
    3 steps. Returns the sharded run's K1/K2 launches."""
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel import (ExecutionPlan, make_debug_mesh,
                                      make_sharded_train_step)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        plan = ExecutionPlan(make_debug_mesh(1, 1, device=dev), "train")
        cfg = get_config("qwen3-1.7b")
        params = init_params(cfg, seed + 30, device=dev)
        batch = shard_batch(cfg, SHARD_ROWS_A, SHARD_S, seed, dev)
        rl = RLConfig(loss_type="gepo", group_size=SHARD_ROWS_A // 2,
                      beta_kl=0.005)
        tc = TrainConfig(learning_rate=1e-6, grad_accum=2)
        sharded = init_state(cfg, tc, params, plan=plan)     # a copy
        state = init_state(cfg, tc, params)                   # in place
        fl.reset_launch_counts()
        state, ref = shard_steps(
            lambda st, b: train_step(cfg, rl, tc, st, b), state, batch, 3,
            "train_step (one device)", card)
        ref_launch = dict(fl.LAUNCHES)
        ref_params = state.params
        del state, params
        free()
        step = make_sharded_train_step(cfg, rl, tc, plan)
        fl.reset_launch_counts()
        sharded, got = shard_steps(step, sharded, batch, 3,
                                   f"sharded step, {plan.describe()} NCCL "
                                   "one rank", card)
        launch = dict(fl.LAUNCHES)
        diff = max(float((a.detach().float() - b.detach().float()).abs()
                         .max())
                   for a, b in zip(tree_leaves(sharded.params),
                                   tree_leaves(ref_params)))
        mdiff = max(abs(g[2][k] - r[2][k]) for g, r in zip(got, ref)
                    for k in r[2])
        log(f"[sharded] (a) one-rank NCCL 1x1 against train_step, {cfg.name} "
            f"bf16 B {SHARD_ROWS_A} x S {SHARD_S}, grad_accum 2, AdamW, 3 "
            f"steps: max|params diff| {diff:.3e}, max|metrics diff| "
            f"{mdiff:.3e} ({'bit-equal' if diff == 0 and mdiff == 0 else 'NOT bit-equal'}); "
            f"step ms {[round(g[0], 1) for g in got]} sharded vs "
            f"{[round(r[0], 1) for r in ref]} train_step; peak "
            f"{max(g[1] for g in got):.2f} vs {max(r[1] for r in ref):.2f} "
            f"GiB; K1/K2 launches {launch['logprob_fwd']}/"
            f"{launch['logprob_bwd']} vs {ref_launch['logprob_fwd']}/"
            f"{ref_launch['logprob_bwd']} | {card}")
        if launch != ref_launch or launch["logprob_fwd"] != 6:
            raise AssertionError(f"(a) launches {launch} != {ref_launch}")
        if diff != 0 or mdiff != 0:
            # not bit-equal: hold the learner phase's bars, the metrics
            # (grad norm included) to TOL_LOSS_REL of each, every param
            # leaf's max|diff| to TOL_HEAD_REL of its max|param|
            rel = max(abs(g[2][k] - r[2][k]) / max(abs(r[2][k]), 1e-6)
                      for g, r in zip(got, ref) for k in r[2])
            prel = max(float((a.detach().float() - b.detach().float())
                             .abs().max())
                       / max(float(b.detach().float().abs().max()), 1e-12)
                       for a, b in zip(tree_leaves(sharded.params),
                                       tree_leaves(ref_params)))
            log(f"[sharded] (a) not bit-equal: metrics rel {rel:.3e} (tol "
                f"{TOL_LOSS_REL}), params max|diff| / max|param| per leaf "
                f"{prel:.3e} (tol {TOL_HEAD_REL}) | {card}")
            if rel > TOL_LOSS_REL or prel > TOL_HEAD_REL:
                raise AssertionError(f"(a) metrics rel diff {rel:.3e}, "
                                     f"params rel diff {prel:.3e}")
        del sharded, ref_params, batch
        free()
        return launch, [g[0] for g in got], [r[0] for r in ref]
    finally:
        dist.destroy_process_group()


def shard_rank_main(rank, world, work, seed, card, dev=None):
    """Phase 14 (b) and (c), one of two rank processes on the one card
    (gloo with CUDA tensors: NCCL refuses two ranks on one device).
    ``card`` is the parent's nvidia-smi name and power limit. Writes
    ``work/rank<r>.json``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.models.moe_ep import moe_ffn_ep
    from repro_torch.parallel import (ExecutionPlan, make_mesh,
                                      make_sharded_train_step)
    from repro_torch.runtime_context import mesh_context
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/gloo",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank, "plans": {}}
    cfg = get_config("qwen3-1.7b")
    rl = RLConfig(loss_type="gepo", group_size=SHARD_ROWS_B // 2,
                  beta_kl=0.005)
    tc = TrainConfig(learning_rate=1e-3, grad_accum=2)       # float32 pair
    tc_bf16 = TrainConfig(learning_rate=1e-6, grad_accum=2)
    meshes = {}
    for dims, mode in (((2, 1), "train_fsdp"), ((1, 2), "train")):
        meshes[dims] = make_mesh(dims, ("data", "model"), device=dev)
        plan = ExecutionPlan(meshes[dims], mode)
        rec = out["plans"][plan.describe()] = {}
        # the float32 pair at SHARD_F32_LAYERS layers against train_step
        # (it also warms the collectives and the GEMMs up)
        c4 = dataclasses.replace(cfg, num_layers=SHARD_F32_LAYERS,
                                 dtype="float32")
        p4 = init_params(c4, seed + 32, device=dev)
        b4 = shard_batch(c4, SHARD_ROWS_B, SHARD_S, seed + 1, dev)
        st = init_state(c4, tc, p4, plan=plan)
        ctl = init_state(c4, tc, p4, plan=plan) if dims[0] > 1 else None
        ref = None
        if rank == 0:                         # the one-device step
            ref, ref_m = train_step(c4, rl, tc, init_state(c4, tc, p4), b4)
        step = make_sharded_train_step(c4, rl, tc, plan)
        st, m = step(st, b4)
        runs = {"sharded": (plan.gather_params(c4, st.params), m)}
        if ctl is not None:
            # the control: the batch sharded first and cut into
            # microbatches on each rank (rows 4r + 2i, 4r + 2i + 1 make
            # microbatch i of rank r), fed as the permutation it amounts to
            perm = [0, 1, 4, 5, 2, 3, 6, 7]
            ctl, cm = step(ctl, {k: v[perm] for k, v in b4.items()})
            runs["control (wrong microbatch order)"] = (
                plan.gather_params(c4, ctl.params), cm)
        if rank == 0:
            for label, (fp, fm) in runs.items():
                worst_p, miss = 0.0, 0
                for a, b in zip(tree_leaves(fp), tree_leaves(ref.params)):
                    d = (a - b.detach()).abs()
                    worst_p = max(worst_p, float(d.max()))
                    miss += int((d > SHARD_ATOL_P + SHARD_RTOL_P
                                 * b.detach().abs()).sum())
                worst_m = max(abs(float(fm[k]) - float(ref_m[k]))
                              / max(abs(float(ref_m[k])), 1e-12)
                              for k in ref_m)
                mmiss = [k for k in ref_m if abs(float(fm[k])
                                                 - float(ref_m[k]))
                         > SHARD_ATOL_M + SHARD_RTOL_M
                         * abs(float(ref_m[k]))]
                rec[label] = {"max_param_diff": worst_p,
                              "params_past_bar": miss,
                              "max_metric_rel": worst_m,
                              "metrics_past_bar": mmiss}
        del st, ctl, ref, runs, p4, b4
        free()
        # bf16 at SHARD_BF16_LAYERS layers: a warm-up step, then the timed
        # step; ms and peak GiB per rank of each
        c14 = dataclasses.replace(cfg, num_layers=SHARD_BF16_LAYERS)
        params = init_params(c14, seed + 31, device=dev)
        batch = shard_batch(c14, SHARD_ROWS_B, SHARD_S, seed, dev)
        state = init_state(c14, tc_bf16, params, plan=plan)
        del params
        free()
        fl.reset_launch_counts()
        state, runs = shard_steps(
            make_sharded_train_step(c14, rl, tc_bf16, plan), state, batch,
            2, f"bf16 {plan.describe()}", card, rank=rank)
        rec["bf16_ms"] = [r[0] for r in runs]
        rec["bf16_peak_gib"] = [r[1] for r in runs]
        rec["bf16_launches"] = dict(fl.LAUNCHES)
        del state, batch
        free()
    # (c) one llama4-scout MoE layer at full width, float32, through
    # moe_ep="train" on the 1x2 mesh against models/moe.py on one rank
    scout = dataclasses.replace(get_config(SCOUT), capacity_factor=16.0,
                                dtype="float32")
    ep = dataclasses.replace(scout, moe_ep="train", ep_dp_axes=("data",))
    gen = torch.Generator(device=dev).manual_seed(seed + 33)
    e, d, f = scout.num_experts, scout.d_model, scout.d_ff

    def normal(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=dev)
    p = {"router": normal((d, e), 0.02), "w_gate": normal((e, d, f), 0.02),
         "w_up": normal((e, d, f), 0.02), "w_down": normal((e, f, d), 0.02),
         "shared": {"w_gate": normal((d, f), 0.02),
                    "w_up": normal((d, f), 0.02),
                    "w_down": normal((f, d), 0.02)}}
    x = normal((SHARD_MOE_ROWS, SHARD_MOE_S, d), 1.0)
    mesh = meshes[(1, 2)]
    with torch.no_grad(), mesh_context(mesh):
        y, aux = moe_ffn_ep(ep, p, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            moe_ffn_ep(ep, p, x)
        torch.cuda.synchronize()
        ep_ms = (time.perf_counter() - t0) / 3 * 1e3
    moe = {"ep_ms": ep_ms, "ep_drop": float(aux["moe_drop_frac"]),
           "ep_lb": float(aux["moe_load_balance"]), "shape": [
               e, scout.experts_per_token, d, f, scout.num_layers]}
    if rank == 0:
        with torch.no_grad():
            want, waux = moe_ffn(scout, p, x)
            torch.cuda.synchronize()
            moe["one_rank_ms"] = time_ms(lambda: moe_ffn(scout, p, x),
                                         iters=3, warmup=1)
        moe["rel_err"] = float((y - want).abs().max()) / float(
            want.abs().max())
        moe["one_rank_drop"] = float(waux["moe_drop_frac"])
        moe["one_rank_lb"] = float(waux["moe_load_balance"])
        moe["finite"] = bool(torch.isfinite(y).all())
    out["moe"] = moe
    del p, x, y
    free()
    dist.barrier()
    dist.destroy_process_group()
    with open(Path(work) / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    return 0


def sharded_phase(dev, seed, card, ranks):
    """Phase 14; ``ranks`` the two rank processes' records of (b) and (c)
    (``rank_pair``). Returns the K1/K2 launches of (a)'s sharded run."""
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-phase14-")
    t0 = time.perf_counter()
    launch, got_ms, ref_ms = one_rank_nccl(dev, seed, card, work)
    log(f"[time] sharded: (a) one-rank NCCL {time.perf_counter() - t0:.1f}s")
    r0 = ranks[0]
    log(f"[time] sharded: (b)+(c) on the ranks {r0['t_part']:.1f}s")
    for name, rec in r0["plans"].items():
        peaks = [max(r["plans"][name]["bf16_peak_gib"]) for r in ranks]
        log(f"[sharded] (b) {name} over gloo (CUDA tensors, 2 ranks on one "
            f"card), qwen3-1.7b bf16, {SHARD_BF16_LAYERS}/28 layers, B "
            f"{SHARD_ROWS_B} x S "
            f"{SHARD_S}, grad_accum 2, after the float32 pair: step "
            f"{rec['bf16_ms'][1]:.1f} ms (the second; the first, a warm-up, "
            f"{rec['bf16_ms'][0]:.1f} ms), peak GiB per rank "
            f"{[round(x, 2) for x in peaks]}, K1/K2 over both steps "
            f"{rec['bf16_launches']} | {card}")
        for label in [k for k in rec if k.startswith(("sharded", "control"))]:
            v = rec[label]
            log(f"[sharded] (b) {name} float32 {SHARD_F32_LAYERS}/28 layers, "
                f"{label} vs train_step: max|param diff| "
                f"{v['max_param_diff']:.3e} ({v['params_past_bar']} elements "
                f"past rtol {SHARD_RTOL_P} / atol {SHARD_ATOL_P}), max metric "
                f"rel {v['max_metric_rel']:.3e} (past rtol {SHARD_RTOL_M}: "
                f"{v['metrics_past_bar']}) | {card}")
            held = v["params_past_bar"] == 0 and not v["metrics_past_bar"]
            if label == "sharded" and not held:
                raise AssertionError(f"(b) {name} misses the parity bars")
            if label.startswith("control") and held:
                raise AssertionError(f"(b) {name}: the control holds the "
                                     "bars, which see nothing")
    moe = r0["moe"]
    e, k, d, f, _ = moe["shape"]
    log(f"[sharded] (c) llama4-scout MoE layer (E {e} top-{k}, d {d}, f {f}, "
        f"shared expert) float32, x ({SHARD_MOE_ROWS}, {SHARD_MOE_S}, {d}), "
        f"capacity factor 16: moe_ep='train' on 1x2 (gloo) {moe['ep_ms']:.2f}"
        f" ms vs models/moe.py on one rank {moe['one_rank_ms']:.2f} ms; "
        f"max|EP - moe_ffn| / max|moe_ffn| {moe['rel_err']:.3e} (<= "
        f"{TOL_SHARD_MOE}); drop fraction EP {moe['ep_drop']} (rank 1 "
        f"{ranks[1]['moe']['ep_drop']}), one rank {moe['one_rank_drop']}; "
        f"load balance EP {moe['ep_lb']:.6f}, one rank "
        f"{moe['one_rank_lb']:.6f} | {card}")
    if not moe["finite"] or not moe["rel_err"] <= TOL_SHARD_MOE or \
            moe["ep_drop"] != 0.0 or moe["one_rank_drop"] != 0.0:
        raise AssertionError("(c) the EP MoE layer disagrees or drops")
    return launch


# --------------------------------------------------------------------------
# phase 15: tensor-parallel serving on a serve ExecutionPlan

PLAN_NEW = 32
PLAN_F32_LAYERS = 4                  # the float32 pairs: 4 of 28 layers
# (b) bf16 over gloo: 8 of the 28 layers (the gloo runs' time grows with
# the layers' collectives; the 1200 s limit)
PLAN_BF16_LAYERS = 8
PLAN_PREFIX = 48                     # the shared prefix: 3 pages of 16
TOL_PLAN_LP = 1e-4                   # float32 plan against one device


def plan_prompts(vocab, seed):
    """The serve cell's traffic cut to 8 requests of 64-1024 tokens (the
    families' lengths); the last shares request 0's first PLAN_PREFIX
    tokens."""
    prompts = family_prompts(vocab, seed + 3)
    prompts[-1][:PLAN_PREFIX] = prompts[0][:PLAN_PREFIX]
    return prompts


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def plan_run(cfg, params, prompts, plan, seed):
    """Serve ``prompts`` through a ContinuousEngine on ``plan`` (None: one
    device): 8 slots, page 16, prefill chunk 512, the serve profile,
    PLAN_NEW new tokens. The last request is submitted after the first
    round, once request 0's prompt is cached: it is admitted into the
    last slot (on a 2x1 plan the other data rank's) and hits the cached
    prefix. Every request finishes, launches are what the run implies.
    Returns a dict: results, stats, launches, decode ms per step (the
    rounds without a prefill chunk), the slot of the last request, the
    engine's pool bytes."""
    serve = ServeConfig(num_slots=SLOTS, page_size=PAGE, prefill_chunk=512,
                        sync_every=8, max_total_tokens=2048,
                        paged_attn_impl=cfg.paged_attn_impl, seed=seed)
    rl = RLConfig(**SERVE_PROFILE)
    eng = build_engine(cfg, params, serve, rl=rl, vocab_limit=cfg.vocab_size,
                       key=prng.PRNGKey(seed), plan=plan)
    sp = SamplingParams.from_rl(rl, max_new=PLAN_NEW)
    reqs = [Request(rid=i, prompt=p, params=sp)
            for i, p in enumerate(prompts)]
    for r in reqs[:-1]:
        eng.submit(r)
    reset_counts()
    results, dec_s, dec_steps, rnd, last_slot = {}, 0.0, 0, 0, -1
    while len(results) < len(reqs):
        if rnd == 1:
            eng.submit(reqs[-1])
        before = eng.stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        events = eng.step(now_s=float(rnd))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        after = eng.stats()
        if rnd == 1:
            last_slot = next(s for s, r in enumerate(eng.sched.slots)
                             if r is not None and r.rid == len(reqs) - 1)
        for ev in events:
            if ev.finished:
                results[ev.rid] = eng.pop_result(ev.rid)
        if after["prefill_chunks"] == before["prefill_chunks"]:
            dec_s += dt
            dec_steps += after["decode_steps"] - before["decode_steps"]
        if not eng.has_work() and len(results) < len(reqs):
            raise AssertionError("engine drained with requests unfinished")
        rnd += 1
    st = eng.stats()
    launches = {k: counts()[k] for k in ("paged_decode", "paged_prefill")}
    lyr = cfg.num_layers if cfg.paged_attn_impl == "pallas" else 0
    want = {"paged_decode": lyr * st["decode_steps"],
            "paged_prefill": lyr * st["prefill_chunks"]}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} ({st})")
    res = [results[i] for i in range(len(reqs))]
    for r in res:
        if r.finish_reason not in ("eos", "length") or r.gen_count < 1 \
                or not np.isfinite(r.logps).all() or (r.logps > 1e-6).any():
            raise AssertionError(f"request {r.rid}: {r.finish_reason}, "
                                 f"bad logps {r.logps.tolist()}")
    if res[-1].prefix_hit_tokens < PLAN_PREFIX - PAGE:
        raise AssertionError(f"the last request hit "
                             f"{res[-1].prefix_hit_tokens} cached tokens, "
                             "not its shared prefix")
    return {"results": res, "stats": st, "launches": launches,
            "ms": dec_s * 1e3 / max(dec_steps, 1), "last_slot": last_slot,
            "pool_bytes": tree_bytes(eng.pool)}


def logp_gap(got, ref):
    """|Δ logp| of each request's tokens before its first token that
    differs from ``ref``'s: (mean, max, requests whose tokens all equal)."""
    gaps, same = [], 0
    for a, b in zip(got, ref):
        n = min(a.gen_count, b.gen_count)
        diff = np.nonzero(a.tokens[:n] != b.tokens[:n])[0]
        k = int(diff[0]) if diff.size else n
        same += int(not diff.size and a.gen_count == b.gen_count)
        gaps.append(np.abs(a.logps[:k] - b.logps[:k]))
    g = np.concatenate(gaps)
    return float(g.mean()), float(g.max()), same


def plan_held(got, ref):
    """Float32 plan against one device: every token equal and every logp
    within TOL_PLAN_LP."""
    return all(a.gen_count == b.gen_count
               and np.array_equal(a.tokens, b.tokens)
               and np.abs(a.logps - b.logps).max() <= TOL_PLAN_LP
               for a, b in zip(got, ref))


def serve_plan_one_rank(dev, seed, card, work):
    """Phase 15 (a): qwen3-1.7b bf16 at 28/28 layers served on a 1x1 serve
    plan of a one-rank NCCL group (the lockstep broadcast runs; axes of
    size 1 run no other collective) against the one-device engine on the
    same weights: tokens and logps bit-equal, K3/K4 launches equal.
    Returns the plan run's launches."""
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel import ExecutionPlan, make_debug_mesh
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl15",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        plan = ExecutionPlan(make_debug_mesh(1, 1, device=dev), "serve")
        cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                                  paged_attn_impl="pallas")
        params = init_params(cfg, seed + 50, device=dev)
        prompts = plan_prompts(cfg.vocab_size, seed)
        ref = plan_run(cfg, params, prompts, None, seed)
        got = plan_run(cfg, params, prompts, plan, seed)
        equal = all(np.array_equal(a.tokens, b.tokens)
                    and np.array_equal(a.logps, b.logps)
                    for a, b in zip(got["results"], ref["results"]))
        log(f"[serve-plan] (a) {plan.describe()} one-rank NCCL, {cfg.name} "
            f"bf16 28/28 layers, {len(prompts)} requests of "
            f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens "
            f"(the last hits {got['results'][-1].prefix_hit_tokens} cached "
            f"tokens), {PLAN_NEW} new, temperature 0.6 / top-k 20 / top-p "
            f"0.95: tokens and logps "
            f"{'bit-equal' if equal else 'NOT bit-equal'} to the one-device "
            f"engine; decode {got['ms']:.2f} ms a step on the plan vs "
            f"{ref['ms']:.2f}; K3/K4 launches {got['launches']} vs "
            f"{ref['launches']} | {card}")
        if not equal or got["launches"] != ref["launches"]:
            raise AssertionError("(a) the 1x1 serve plan differs from one "
                                 "device")
        del params
        free()
        return got["launches"]
    finally:
        dist.destroy_process_group()


def swap_q_heads(params):
    """The control: every layer's wq with its two column halves (the two
    ranks' q heads on a 1x2 plan) swapped."""
    out = {**params, "blocks": {k: dict(v) for k, v in
                                params["blocks"].items()}}
    for layer in out["blocks"].values():
        wq = layer["attn"]["wq"]
        half = wq.shape[-1] // 2
        layer["attn"] = {**layer["attn"], "wq": torch.cat(
            [wq[..., half:], wq[..., :half]], dim=-1)}
    return out


def serve_rank_main(rank, world, work, seed, card, dev=None):
    """Phase 15 (b) and (c), one of two rank processes on the one card
    (gloo with CUDA tensors). Writes ``work/serve<r>.json``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel import ExecutionPlan, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/gloo15",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    plans = {dims: ExecutionPlan(make_mesh(dims, ("data", "model"),
                                           device=dev), "serve")
             for dims in ((1, 2), (2, 1))}
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              paged_attn_impl="pallas")
    prompts = plan_prompts(cfg.vocab_size, seed)
    out = {"rank": rank, "launches": {"paged_decode": 0, "paged_prefill": 0}}

    def run(c, p, plan, tag):
        r = plan_run(c, p, prompts, plan, seed)
        for k, n in r["launches"].items():
            out["launches"][k] += n
        out[tag] = {"tokens": [x.tokens.tolist() for x in r["results"]],
                    "ms": r["ms"], "last_slot": r["last_slot"],
                    "hit": r["results"][-1].prefix_hit_tokens,
                    "pool_bytes": r["pool_bytes"]}
        return r

    # (b) bf16 at PLAN_BF16_LAYERS layers on 1x2: per-rank bytes, decode
    # ms a step
    plan = plans[(1, 2)]
    c8 = dataclasses.replace(cfg, num_layers=PLAN_BF16_LAYERS)
    params = plan.device_put_params(c8, init_params(c8, seed + 50,
                                                    device=dev))
    free()
    out["weight_bytes"] = tree_bytes(params)
    out["on_card"] = all(t.device == dev for t in tree_leaves(params))
    bf16 = run(c8, params, plan, "bf16")
    del params
    free()
    if rank == 0:                         # the one-device engine
        full = init_params(c8, seed + 50, device=dev)
        out["full_weight_bytes"] = tree_bytes(full)
        ref = plan_run(c8, full, prompts, None, seed)
        out["full_pool_bytes"] = ref["pool_bytes"]
        out["bf16_ref_ms"] = ref["ms"]
        out["bf16_gap"] = logp_gap(bf16["results"], ref["results"])
        del full, ref
        free()
    # (b) the float32 pair at PLAN_F32_LAYERS layers, and its control
    c4 = dataclasses.replace(cfg, num_layers=PLAN_F32_LAYERS,
                             dtype="float32")
    p4 = init_params(c4, seed + 51, device=dev)
    f32 = run(c4, plan.device_put_params(c4, p4), plan, "f32")
    ctl = run(c4, plan.device_put_params(c4, swap_q_heads(p4)), plan,
              "control")
    # (c) 2x1: the slots split over 'data'
    plan21 = plans[(2, 1)]
    data = run(c4, plan21.device_put_params(c4, p4), plan21, "data")
    if rank == 0:
        ref = plan_run(c4, p4, prompts, None, seed)["results"]
        for tag, r in (("f32", f32), ("control", ctl), ("data", data)):
            out[tag]["held"] = plan_held(r["results"], ref)
            out[tag]["gap"] = logp_gap(r["results"], ref)
    del p4
    free()
    dist.barrier()
    dist.destroy_process_group()
    with open(Path(work) / f"serve{rank}.json", "w") as fh:
        json.dump(out, fh)
    return 0


def plan_kernel_rows(dev, seed, hq=HQ // 2, hkv=HKV // 2,
                     label="serve plan 1x2, one rank",
                     tag="[serve-plan] (d)", salt=15):
    """Phase 15 (d): K3 and K4 at the heads one rank of qwen3-1.7b's 1x2
    serve plan launches them with (Hq 8, Hkv 4, D 128; 8 slots up to 2048
    keys, one chunk of 512 after 1024), against their twins at the
    existing bars, timed beside the twin, the bound and SDPA (phase 17
    (g): at another rank's heads, ``hq``/``hkv``)."""
    gen = torch.Generator(device=dev).manual_seed(seed + salt)
    width = 2048 // PAGE
    lengths = [2048, 1537, 1024, 700, 333, 64, 1, width * PAGE + 1]
    live = slice(0, SLOTS - 1)
    q, kp, vp, table, lens = decode_case(gen, dev, lengths, width, hq, hkv)
    err = max_err(pa.paged_attention(q, kp, vp, table, lens),
                  pa.paged_decode_ref(q.float(), kp.float(), vp.float(),
                                      table, lens), live)
    b_ms, b_by = decode_bound(q, table, lengths, width, hkv)
    shape = f"Hq={hq} Hkv={hkv} D={D} page={PAGE}"
    k3 = dict(case=label, max_abs_err=err,
              bound_ms=b_ms, bound_by=b_by,
              ms=time_ms(lambda: pa.paged_attention(q, kp, vp, table, lens)),
              plain_ms=time_ms(lambda: pa.paged_decode_ref(
                  q, kp, vp, table, lens), iters=5),
              library_ms=library_ms(*sdpa_decode(q, kp, vp, table, lens)),
              shape=f"B={SLOTS} {shape} lengths={lengths} bf16")
    if not err <= TOL_BF16:
        raise AssertionError("K3 at a rank's local heads disagrees with its "
                             "twin")
    c, start = 512, 1024
    q, kp, vp, table, pos = prefill_case(gen, dev, c, start, hq, hkv)
    err = max_err(ops.paged_prefill(q, kp, vp, table, pos, impl="pallas"),
                  ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                                    pos, impl="ref"))
    kv_elems = -(-(start + c) // PAGE) * PAGE * hkv * D * 2
    b_ms, b_by = bound(kv_elems * 2 + 2 * q.numel() * 2 + table.numel() * 4,
                       sum(4 * hq * D * (start + i + 1) for i in range(c)))
    k4 = dict(case=label, max_abs_err=err,
              bound_ms=b_ms, bound_by=b_by,
              ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                                   impl="pallas")),
              plain_ms=time_ms(lambda: ops.paged_prefill(
                  q, kp, vp, table, pos, impl="ref"), iters=5),
              library_ms=library_ms(*sdpa_prefill(q, kp, vp, table, pos)),
              shape=f"B=1 C={c} start={start} {shape} bf16")
    if not err <= TOL_BF16:
        raise AssertionError("K4 at a rank's local heads disagrees with its "
                             "twin")
    for name, row in (("K3", k3), ("K4", k4)):
        log(f"{tag} {name} at a 1x2 rank's heads ({row['shape']}):"
            f" max|err| {row['max_abs_err']:.3e} (tol {TOL_BF16}), "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), twin {row['plain_ms']:.3f} ms, SDPA "
            f"{row['library_ms']:.4f} ms")
    return {"paged_decode": k3, "paged_prefill": k4}


def serve_plan_phase(dev, seed, card, ranks):
    """Phase 15; ``ranks`` the two rank processes' records of (b) and (c)
    (``rank_pair``). Returns (the K3/K4 launches of its plan runs, the
    kernel rows of (d))."""
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-phase15-")
    t0 = time.perf_counter()
    launches = dict(serve_plan_one_rank(dev, seed, card, work))
    log(f"[time] serve plan: (a) one-rank NCCL "
        f"{time.perf_counter() - t0:.1f}s")
    r0, r1 = ranks
    log(f"[time] serve plan: (b)+(c) on the ranks {r0['t_part']:.1f}s")
    for k in launches:
        launches[k] += r0["launches"][k] + r1["launches"][k]
    for tag in ("bf16", "f32", "control", "data"):
        if r0[tag]["tokens"] != r1[tag]["tokens"]:
            raise AssertionError(f"({tag}) the two ranks emit different "
                                 "tokens")
    mean, worst, same = r0["bf16_gap"]
    log(f"[serve-plan] (b) 1x2 over gloo (CUDA tensors, 2 ranks on one card),"
        f" qwen3-1.7b bf16 {PLAN_BF16_LAYERS}/28 layers: weights "
        f"{r0['weight_bytes'] / 1e9:.3f} / {r1['weight_bytes'] / 1e9:.3f} GB "
        f"per rank (one device "
        f"{r0['full_weight_bytes'] / 1e9:.3f} GB), on the card "
        f"{r0['on_card'] and r1['on_card']}; page pools "
        f"{r0['bf16']['pool_bytes'] / 2 ** 30:.3f} GiB per rank (one device "
        f"{r0['full_pool_bytes'] / 2 ** 30:.3f} GiB); decode "
        f"{r0['bf16']['ms']:.2f} ms a step (gloo stages every all-reduce "
        f"through the host: not a speed figure; one device "
        f"{r0['bf16_ref_ms']:.2f} ms); |Δ logp| against the one-device "
        f"engine before each request's first differing token: mean "
        f"{mean:.3e}, max {worst:.3e}; {same}/{len(r0['bf16']['tokens'])} "
        f"requests token-equal | {card}")
    if r0["weight_bytes"] * 2 > r0["full_weight_bytes"] * 1.01 or \
            r0["bf16"]["pool_bytes"] * 2 != r0["full_pool_bytes"] or \
            not (r0["on_card"] and r1["on_card"]) or \
            not mean <= TOL_LOGP_MEAN_BF16:
        raise AssertionError("(b) bf16: a rank holds more than its half, or "
                             "the logps are off the one-device engine's")
    for tag, label in (("f32", "1x2 float32"),
                       ("control", "1x2 float32 control (q heads swapped)"),
                       ("data", "2x1 float32 (slots over 'data')")):
        v = r0[tag]
        log(f"[serve-plan] ({'c' if tag == 'data' else 'b'}) {label}, "
            f"{PLAN_F32_LAYERS}/28 layers: tokens equal and logps within "
            f"{TOL_PLAN_LP} of one device: {v['held']}; |Δ logp| mean "
            f"{v['gap'][0]:.3e}, max {v['gap'][1]:.3e}, "
            f"{v['gap'][2]}/{len(v['tokens'])} requests token-equal; decode "
            f"{v['ms']:.2f} ms a step; the last request in slot "
            f"{v['last_slot']}, {v['hit']} cached tokens | {card}")
        if v["held"] != (tag != "control"):
            raise AssertionError(f"({tag}) the bar is "
                                 f"{'missed' if tag != 'control' else 'held'}")
    if r0["data"]["last_slot"] < SLOTS // 2:
        raise AssertionError("(c) the shared-prefix request landed on data "
                             "rank 0, beside the request that cached it")
    t0 = time.perf_counter()
    rows = plan_kernel_rows(dev, seed)
    log(f"[time] serve plan: (d) kernel rows {time.perf_counter() - t0:.1f}s")
    return launches, rows


# --------------------------------------------------------------------------
# phase 16: the static engine on serve and long plans (context-parallel
# dense-cache decode), the SSM and memory families on a serve plan, and the
# front door on a mesh

SPLAN_NEW = 16                  # (b) new tokens over gloo
SPLAN_ONE_NEW = 32              # (a) new tokens on the one-rank NCCL plan
SPLAN_LONG, SPLAN_LONG_NEW = 8192, 64                # (c) 1 x 8192 + 64
# (b) and (c) in bf16: 8 of qwen3-1.7b's 28 layers (the gloo runs' time
# grows with the layers' collectives; the 1200 s limit)
SPLAN_BF16_LAYERS = 8
SPLAN_F32_LAYERS = 4            # the float32 pairs: 4 of 28 layers
SPLAN_SHARP = 4.0               # the pairs' wq, wk scale (scores x 16)
FAM_ROWS, FAM_PROMPT, FAM_NEW = 4, 256, 16          # (d) 4 x 256 + 16
# (d) the bf16 runs' depths: mamba2 16 of 48 layers, the VLM two periods
# (10 of 40), whisper whole (the gloo runs' time grows with the layers'
# collectives; the 1200 s limit)
FAM_LAYERS = {"mamba2": 16, "llama": 10}
VLM_PROMPT, VLM_NEW = 128, 8                        # (d) VLM 4 x 128 + 8
SPLAN_DOOR_CLIENTS, SPLAN_DOOR_NEW = 8, 16
SSM_EMBED_SCALE = 0.05          # (d) mamba2's embedding (family_params)
# (d) mamba2 bf16 on the plan against one device, mean |Δ logp|: with its
# embedding scaled, the 48 Mamba2 layers decide the logits, and the plan's
# sums (the gated RMSNorm's squares and out_proj over the ranks) round in
# another order than one device's through all of them: mean 9.88e-2 (the
# rollout) and 7.67e-2 (the recompute) on the H100, where the float32 pair
# agreed to 2e-6. A rank scanning another rank's heads moves the logps by
# nats (tests/test_torch_family_plan.py's control); the float32 pair is
# the check that sees a fault of the split
TOL_SSD_PLAN_MEAN_BF16 = 0.5


def static_prompts(vocab, seed, rows=PROMPTS * GROUP, length=PROMPT_LEN):
    rng = np.random.default_rng(seed + 16)
    return rng.integers(3, vocab, (rows, length)).astype(np.int32)


def static_run(cfg, params, prompts, plan, seed, new, memory=None):
    """``StaticEngine`` on ``plan`` (None: one device) over ``prompts``
    (temperature 1.0, ``new`` new tokens, every request rid i): the
    results, the launches of the run, its seconds, the decode ms a step
    (the run minus a prefill's time over new - 1 steps)."""
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=new)
    eng = StaticEngine(cfg, params, rl=rl, vocab_limit=cfg.vocab_size,
                       memory=memory, key=prng.PRNGKey(seed), plan=plan)
    sp = SamplingParams.from_rl(rl)
    reqs = [Request(rid=i, prompt=p, params=sp) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts()
    for r in res:
        if not np.isfinite(r.logps).all() or (r.logps > 1e-6).any() or \
                (r.tokens < 0).any() or (r.tokens >= cfg.vocab_size).any():
            raise AssertionError(f"{cfg.name} request {r.rid}: bad tokens "
                                 f"or logps")
    return {"results": res, "launches": launches, "s": secs, "engine": eng}


def results_equal(a, b):
    return all(x.gen_count == y.gen_count and np.array_equal(x.tokens, y.tokens)
               and np.array_equal(x.logps, y.logps) for x, y in zip(a, b))


def static_plan_one_rank(dev, seed, card, work):
    """Phase 16 (a): qwen3-1.7b bf16 at 28/28 layers, ``StaticEngine`` 16 x
    832 + 32 (the static phase's prompts, prefill through K5), on a 1x1
    serve plan of a one-rank NCCL group against one device on the same
    weights: tokens and logps bit-equal, K5 launches equal. Returns the
    plan run's launches."""
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel import ExecutionPlan, make_debug_mesh
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl16",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        plan = ExecutionPlan(make_debug_mesh(1, 1, device=dev), "serve")
        cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_impl="pallas")
        params = init_params(cfg, seed + 60, device=dev)
        prompts = static_prompts(cfg.vocab_size, seed)
        ref = static_run(cfg, params, prompts, None, seed, SPLAN_ONE_NEW)
        got = static_run(cfg, params, prompts, plan, seed, SPLAN_ONE_NEW)
        equal = results_equal(got["results"], ref["results"])
        k5 = (got["launches"]["flash_attention"],
              ref["launches"]["flash_attention"])
        log(f"[static-plan] (a) {plan.describe()} one-rank NCCL, {cfg.name} "
            f"bf16 28/28 layers, StaticEngine {len(prompts)} x {PROMPT_LEN} "
            f"+ {SPLAN_ONE_NEW}, temperature 1.0: tokens and logps "
            f"{'bit-equal' if equal else 'NOT bit-equal'} to one device; "
            f"{got['s']:.2f} s on the plan vs {ref['s']:.2f} s; K5 launches "
            f"{k5[0]} vs {k5[1]} | {card}")
        if not equal or got["launches"] != ref["launches"] or \
                k5[0] != cfg.num_layers:
            raise AssertionError("(a) the 1x1 serve plan differs from one "
                                 "device")
        del params, got, ref
        free()
        return {"flash_attention": k5[0]}
    finally:
        dist.destroy_process_group()


def sharpen(params, f=SPLAN_SHARP):
    """Every layer's wq and wk scaled by ``f`` (new leaves): sharper
    attention, so the ranks' running maxima differ and a merge that drops
    their rescale shows in the logps."""
    out = {**params, "blocks": {k: dict(v) for k, v in
                                params["blocks"].items()}}
    for layer in out["blocks"].values():
        layer["attn"] = {**layer["attn"], "wq": layer["attn"]["wq"] * f,
                         "wk": layer["attn"]["wk"] * f}
    return out


def unscaled_combine(self, o, m, l, axes_):
    """The control: each rank's partial weighted by its sum alone, without
    exp(m - max over ranks)."""
    if not axes_:
        return o
    parts = self.gather(torch.cat([o, l[..., None]], -1)[None], axes_, 0)
    o_r, l_r = parts[..., :-1], parts[..., -1]
    return (o_r * l_r[..., None]).sum(0) / l_r.sum(0)[..., None]


def cache_bytes(cfg, eng, rows, length, memory=None):
    """Bytes of the dense cache ``eng`` (a plan's StaticEngine) holds on
    this rank for ``rows`` requests of ``length`` positions: the rank's
    rows, its span of positions (and of the memory's rows)."""
    from repro_torch import runtime_context
    shard = eng.shard.with_cache(length, 0 if memory is None
                                 else memory.shape[1])
    _, r0, rn = shard.row_span(rows)
    with torch.no_grad(), runtime_context.serve_context(shard):
        cache = init_cache(cfg, eng.params, rn, length,
                           memory=None if memory is None
                           else memory[r0:r0 + rn])
    n = tree_bytes(cache)
    del cache
    return n


def full_cache_bytes(cfg, rows, length):
    """A dense KV cache's bytes on one device (self-attention layers)."""
    return (2 * cfg.num_layers * rows * length * cfg.num_kv_heads
            * cfg.head_dim * torch.finfo(getattr(torch, cfg.dtype)).bits // 8)


def add_launches(out, got):
    for k, n in got.items():
        out["launches"][k] = out["launches"].get(k, 0) + n


def bf16_pair(out, tag, got, ref):
    out[tag]["gap"] = logp_gap(got["results"], ref["results"])
    out[tag]["ref_s"] = ref["s"]


def family_params(cfg, seed, dev):
    """``init_params``, with mamba2's tied N(0, 1) embedding scaled by
    SSM_EMBED_SCALE: at init the residual carries the input token's row,
    whose logit ||e||^2 ~ d outweighs what the Mamba2 layers add, so every
    draw would be the argmax at logp 0 whatever the scan computes."""
    params = init_params(cfg, seed, device=dev)
    if cfg.family == "ssm":
        params["embed"].mul_(SSM_EMBED_SCALE)
    return params


def placed_params(cfg, plan, seed, dev):
    """This rank's shard of ``family_params(cfg, seed)`` on the card, the
    ranks one after the other, so that one full copy at a time is on the
    card beside the shards."""
    import torch.distributed as dist
    out = None
    for r in range(plan.mesh.size):
        if plan.mesh.rank == r:
            full = family_params(cfg, seed, dev)
            out = plan.device_put_params(cfg, full)
            del full
            free()
        dist.barrier()
    return out


def static_rank_main(rank, world, work, seed, card, dev=None):
    """Phase 16 (b)-(e), one of two rank processes on the one card (gloo
    with CUDA tensors). Writes ``work/static<r>.json``."""
    import datetime
    import torch.distributed as dist
    from repro_torch import runtime_context
    from repro_torch.parallel import ExecutionPlan, make_mesh
    from repro_torch.parallel import plan as plan_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/gloo16",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    meshes = {d: make_mesh(d, ("data", "model"), device=dev)
              for d in ((1, 2), (2, 1))}
    serve = ExecutionPlan(meshes[(1, 2)], "serve")
    long = ExecutionPlan(meshes[(2, 1)], "long")
    out = {"rank": rank, "launches": {}}
    t_all = time.perf_counter()

    def run(tag, cfg, params, prompts, plan, new, memory=None):
        r = static_run(cfg, params, prompts, plan, seed, new, memory)
        add_launches(out, r["launches"])
        out[tag] = {"tokens": [x.tokens.tolist() for x in r["results"]],
                    "s": r["s"], "launches": r["launches"]}
        return r

    # (b) qwen3-1.7b bf16 at SPLAN_BF16_LAYERS on 1x2: bytes a rank, the
    # bf16 gap
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_impl="pallas",
                              num_layers=SPLAN_BF16_LAYERS)
    prompts = static_prompts(cfg.vocab_size, seed)
    params = placed_params(cfg, serve, seed + 60, dev)
    out["weight_bytes"] = tree_bytes(params)
    out["on_card"] = all(t.device == dev for t in tree_leaves(params))
    b16 = run("bf16", cfg, params, prompts, serve, SPLAN_NEW)
    out["cache_bytes"] = cache_bytes(cfg, b16["engine"], len(prompts),
                                     PROMPT_LEN + NEW_TOKENS)
    out["cache_bytes_full"] = full_cache_bytes(cfg, len(prompts),
                                               PROMPT_LEN + NEW_TOKENS)
    del params, b16["engine"]
    free()
    if rank == 0:
        full = init_params(cfg, seed + 60, device=dev)
        out["full_weight_bytes"] = tree_bytes(full)
        ref = static_run(cfg, full, prompts, None, seed, SPLAN_NEW)
        bf16_pair(out, "bf16", b16, ref)
        del full, ref
        free()
    # (b) the float32 pair at SPLAN_F32_LAYERS, sharpened; the control
    c4 = dataclasses.replace(cfg, num_layers=SPLAN_F32_LAYERS,
                             dtype="float32")
    p4 = sharpen(init_params(c4, seed + 61, device=dev))
    f32 = run("f32", c4, serve.device_put_params(c4, p4), prompts, serve,
              SPLAN_NEW)
    combine = plan_mod.ServeShard.combine
    plan_mod.ServeShard.combine = unscaled_combine
    try:
        ctl = run("control", c4, serve.device_put_params(c4, p4), prompts,
                  serve, SPLAN_NEW)
    finally:
        plan_mod.ServeShard.combine = combine
    if rank == 0:
        ref = static_run(c4, p4, prompts, None, seed, SPLAN_NEW)["results"]
        for tag, r in (("f32", f32), ("control", ctl)):
            out[tag]["held"] = plan_held(r["results"], ref)
            out[tag]["gap"] = logp_gap(r["results"], ref)
    del p4, f32, ctl
    free()
    out["t_b"] = time.perf_counter() - t_all
    # (c) long 2x1: one request of 8192 + 64, the sequence over 'data'
    t0 = time.perf_counter()
    lp = static_prompts(cfg.vocab_size, seed + 1, 1, SPLAN_LONG)
    params = placed_params(cfg, long, seed + 60, dev)
    out["long_weight_bytes"] = tree_bytes(params)
    lng = run("long", cfg, params, lp, long, SPLAN_LONG_NEW)
    out["long_cache_bytes"] = cache_bytes(cfg, lng["engine"], 1,
                                          SPLAN_LONG + SPLAN_LONG_NEW)
    out["long_cache_full"] = full_cache_bytes(cfg, 1,
                                              SPLAN_LONG + SPLAN_LONG_NEW)
    del params, lng["engine"]
    free()
    if rank == 0:
        full = init_params(cfg, seed + 60, device=dev)
        bf16_pair(out, "long", lng, static_run(cfg, full, lp, None, seed,
                                               SPLAN_LONG_NEW))
        del full
        free()
    out["t_c"] = time.perf_counter() - t0
    # (d) the families on 1x2
    t0 = time.perf_counter()
    for name, new, plen in (("mamba2-1.3b", FAM_NEW, FAM_PROMPT),
                            ("whisper-small", FAM_NEW, FAM_PROMPT),
                            ("llama-3.2-vision-11b", VLM_NEW, VLM_PROMPT)):
        family_rank(out, run, name, new, plen, serve, seed, dev)
    out["t_d"] = time.perf_counter() - t0
    # (e) the door on 1x2: float32 qwen3 at SPLAN_F32_LAYERS
    t0 = time.perf_counter()
    door_rank(out, c4, init_params(c4, seed + 62, device=dev), serve, seed)
    out["t_e"] = time.perf_counter() - t0
    free()
    dist.barrier()
    dist.destroy_process_group()
    with open(Path(work) / f"static{rank}.json", "w") as fh:
        json.dump(out, fh)
    return 0


def family_rank(out, run, name, new, plen, serve, seed, dev):
    """Phase 16 (d), one family on a rank: the static engine on the 1x2
    plan in bf16 (rank 0 also on one device: the bf16 gap), the dense
    cache's bytes a rank, a recompute on the plan (mamba2: through K6 at
    the rank's SSM heads), and a float32 pair at a cut depth."""
    from repro_torch import runtime_context
    base = get_config(name)
    tag = name.split("-")[0]
    prompts = static_prompts(base.vocab_size, seed + 2, FAM_ROWS, plen)
    layers = {"mamba2": 4, "whisper": base.num_layers,
              "llama": VLM_F32_LAYERS}[tag]
    for cfg, sfx, pseed in (
            (dataclasses.replace(base, attn_impl="pallas", ssd_impl="pallas",
                                 num_layers=FAM_LAYERS.get(
                                     tag, base.num_layers)), "", seed + 63),
            (dataclasses.replace(base, attn_impl="pallas", ssd_impl="pallas",
                                 num_layers=layers, dtype="float32"),
             "_f32", seed + 64)):
        params = placed_params(cfg, serve, pseed, dev)
        out[tag + sfx + "_weight_bytes"] = tree_bytes(params)
        memory = x = None
        if cfg.is_encdec or cfg.memory_seq:
            x = stub_input(cfg, FAM_ROWS, seed, dev)
            memory = x
        if cfg.is_encdec:              # the plan's encoder: K5 at the
            reset_counts()             # rank's heads
            with torch.no_grad(), runtime_context.serve_context(
                    serve.serve_shard(cfg)):
                memory = encode(cfg, params, x)
            add_launches(out, counts())
            out[f"{tag}{sfx}_encode_k5"] = counts()["flash_attention"]
        r = run(tag + sfx, cfg, params, prompts, serve, new, memory)
        v = out[tag + sfx]
        v["cache_bytes"] = cache_bytes(cfg, r["engine"], FAM_ROWS,
                                       plen + new, memory)
        if memory is not None:
            v["mem_rows"] = r["engine"].shard.span(memory.shape[1])[2]
        lp = roll = None
        if not sfx:                    # the recompute on the plan
            roll = rollout_from_results(prompts, r["results"], new,
                                        device=dev)
            reset_counts()
            lp = token_logps(cfg, params, roll["tokens"], memory=memory,
                             plan=serve)
            torch.cuda.synchronize()
            add_launches(out, counts())
            v["recompute_launches"] = counts()
        del r["engine"], params
        free()
        if out["rank"] == 0:
            full = family_params(cfg, pseed, dev)
            fmem = memory
            if cfg.is_encdec:
                with torch.no_grad():
                    fmem = encode(cfg, full, x)
            ref = static_run(cfg, full, prompts, None, seed, new, fmem)
            if sfx:
                v["held"] = plan_held(r["results"], ref["results"])
                v["gap"] = logp_gap(r["results"], ref["results"])
            else:
                bf16_pair(out, tag, r, ref)
                want = token_logps(cfg, full, roll["tokens"], memory=fmem)
                mask = roll["comp_mask"] > 0
                d = (lp[:, plen - 1:] - want[:, plen - 1:]).abs()[mask]
                v["recompute_gap"] = [float(d.mean()), float(d.max())]
            del full, fmem, ref
        del memory, x, lp, roll, r
        free()


def door_rank(out, cfg, params, serve, seed):
    """Phase 16 (e): the front door on the 1x2 plan. Rank 0 serves
    SPLAN_DOOR_CLIENTS clients at once over HTTP and rank 1 follows its
    rounds; then every rank runs the plan engine's ``generate`` on the
    same (rid, prompt) pairs under the same key, whose tokens the door's
    must equal."""
    from repro_torch.parallel.collectives import broadcast_object
    from repro_torch.serving.server import FrontDoor
    sc = ServeConfig(num_slots=SLOTS, page_size=PAGE, prefill_chunk=512,
                     sync_every=8, max_total_tokens=1024 + SPLAN_DOOR_NEW,
                     seed=seed, port=0)
    rl = RLConfig(**SERVE_PROFILE)
    door = FrontDoor(cfg, params, sc, rl=rl, vocab_limit=cfg.vocab_size,
                     plan=serve, key=prng.PRNGKey(seed))
    prompts = family_prompts(cfg.vocab_size, seed + 16)
    pairs = []
    if door.leader:
        build = door.build_request

        def recorded(payload, now_s):
            req = build(payload, now_s)
            pairs.append((req.rid, payload["id"]))
            return req
        door.build_request = recorded

        async def clients():
            await door.start()
            t0 = time.perf_counter()
            got = await asyncio.gather(*(door_http(
                door.port, "POST", "/generate",
                {"id": i, "tokens": prompts[i].tolist(),
                 "max_new_tokens": SPLAN_DOOR_NEW})
                for i in range(SPLAN_DOOR_CLIENTS)))
            wall = time.perf_counter() - t0
            await door.close()
            return got, wall
        reset_counts()
        got, wall = asyncio.run(clients())
        add_launches(out, counts())
        if any(st != 200 for st, _ in got):
            raise AssertionError(f"(e) door statuses {[st for st, _ in got]}")
        door_tokens = {i: body["tokens"] for i, (_, body) in enumerate(got)}
        out["door"] = {"wall_s": wall}
    else:
        reset_counts()
        door.follow()
        add_launches(out, counts())
        out["door"] = {}
    pairs = broadcast_object(pairs, serve.mesh)
    eng = door.engine
    sp = SamplingParams.from_rl(rl, max_new=SPLAN_DOOR_NEW)
    reset_counts()
    res = eng.generate([Request(rid=rid, prompt=prompts[i], params=sp)
                        for rid, i in sorted(pairs)])
    add_launches(out, counts())
    want = {i: r.tokens.tolist() for (rid, i), r in zip(sorted(pairs), res)}
    if door.leader:
        out["door"]["equal"] = all(door_tokens[i] == want[i]
                                   for i in door_tokens)
        out["door"]["clients"] = len(door_tokens)
    del door, eng
    free()


def static_kernel_rows(dev, seed, card):
    """Phase 16 (f): K5 and K6 at the shapes one rank of a 1x2 plan
    launches them with, each against its twin, timed beside the twin, the
    bound and SDPA (K6: none): K5 at qwen3-1.7b's static prefill on 8 of
    16 q heads (4 of 8 KV heads), at Whisper's encoder (bidir, 1500
    frames) and cross prefill (Sq 256 x Sk 1500) on 6 of 12 heads; K6 at
    mamba2-1.3b's recompute (B 16, S 1024) on 32 of 64 heads."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    rows = {"flash_attention": [], "ssd_scan": []}
    cases = (("static prefill, 1x2 rank", 16, PROMPT_LEN, PROMPT_LEN, 8, 4,
              128, True),
             ("whisper encoder, 1x2 rank", FAM_ROWS, 1500, 1500, 6, 6, 64,
              False),
             ("whisper cross prefill, 1x2 rank", FAM_ROWS, FAM_PROMPT, 1500,
              6, 6, 64, False))
    for label, b, sq, sk, hq, hkv, d, causal in cases:
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=causal)
        err = max_err(got, want)
        del got, want
        pairs = flash_pairs(sq, True, None) if causal else sq * sk
        b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                           4 * d * hq * b * pairs)
        row = dict(case=label, max_abs_err=err, tol=TOL_FLASH[torch.bfloat16],
                   bound_ms=b_ms, bound_by=b_by,
                   ms=time_ms(lambda: fa.flash_attention(q, k, v,
                                                         causal=causal),
                              iters=10),
                   plain_ms=time_ms(lambda: fa.flash_attention_ref(
                       q, k, v, causal=causal), iters=3, warmup=1),
                   library_ms=sdpa_flash(q, k, v, causal, None),
                   shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
                         f"causal={causal} bf16")
        log(f"[static-plan] (f) K5 {label} ({row['shape']}): max|err| "
            f"{err:.3e} (tol {row['tol']}), {row['ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), twin {row['plain_ms']:.3f} ms, SDPA "
            f"{row['library_ms']:.4f} ms | {card}")
        if not err <= row["tol"]:
            raise AssertionError(f"K5 at a rank's heads disagrees with its "
                                 f"twin ({label})")
        rows["flash_attention"].append(row)
        del q, k, v
        torch.cuda.empty_cache()
    k6 = ssd_row(gen, dev, "mamba2 recompute, 1x2 rank (32 of 64 heads)",
                 16, PROMPT_LEN + NEW_TOKENS, 32, 64, 1, 128, 256,
                 torch.bfloat16, True)
    log(f"[static-plan] (f) K6 at 32 of 64 heads: {k6['ms']:.4f} ms, bound "
        f"{k6['bound_ms']:.4f} ms, twin {k6['plain_ms']:.3f} ms | {card}")
    rows["ssd_scan"].append(k6)
    return rows


def static_plan_phase(dev, seed, card, ranks):
    """Phase 16; ``ranks`` the two rank processes' records of (b)-(e)
    (``rank_pair``). Returns (its launches, the kernel rows of (f))."""
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-phase16-")
    t0 = time.perf_counter()
    launches = dict(static_plan_one_rank(dev, seed, card, work))
    log(f"[time] static plan: (a) one-rank NCCL "
        f"{time.perf_counter() - t0:.1f}s")
    r0, r1 = ranks
    log(f"[time] static plan: (b)-(e) on the ranks {r0['t_part']:.1f}s "
        f"((b) {r0['t_b']:.1f}, (c) {r0['t_c']:.1f}, (d) {r0['t_d']:.1f}, "
        f"(e) {r0['t_e']:.1f})")
    for r in (r0, r1):
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    tags = ["bf16", "f32", "control", "long", "mamba2", "whisper", "llama",
            "mamba2_f32", "whisper_f32", "llama_f32"]
    for tag in tags:
        if r0[tag]["tokens"] != r1[tag]["tokens"]:
            raise AssertionError(f"({tag}) the two ranks emit different "
                                 "tokens")
    mean, worst, same = r0["bf16"]["gap"]
    half = r0["cache_bytes"] * 2 == r0["cache_bytes_full"] and \
        r1["cache_bytes"] == r0["cache_bytes"]
    log(f"[static-plan] (b) 1x2 over gloo (CUDA tensors, 2 ranks on one "
        f"card), qwen3-1.7b bf16 {SPLAN_BF16_LAYERS}/28 layers, StaticEngine "
        f"{PROMPTS * GROUP} x {PROMPT_LEN} + {SPLAN_NEW}: weights "
        f"{r0['weight_bytes'] / 1e9:.3f} / {r1['weight_bytes'] / 1e9:.3f} GB "
        f"per rank (one device {r0['full_weight_bytes'] / 1e9:.3f} GB), on "
        f"the card {r0['on_card'] and r1['on_card']}; dense cache of "
        f"{PROMPT_LEN + NEW_TOKENS} positions {r0['cache_bytes'] / 1e9:.3f} "
        f"GB per rank (one device {r0['cache_bytes_full'] / 1e9:.3f} GB); "
        f"{r0['bf16']['s']:.2f} s on the plan (gloo stages every collective "
        f"through the host: not a speed figure; one device "
        f"{r0['bf16']['ref_s']:.2f} s); |Δ logp| against one device before "
        f"each request's first differing token: mean {mean:.3e}, max "
        f"{worst:.3e}; {same}/{len(r0['bf16']['tokens'])} requests "
        f"token-equal | {card}")
    if r0["weight_bytes"] * 2 > r0["full_weight_bytes"] * 1.01 or not half \
            or not (r0["on_card"] and r1["on_card"]) or \
            not mean <= TOL_LOGP_MEAN_BF16:
        raise AssertionError("(b) bf16: a rank holds more than its half, or "
                             "the logps are off one device's")
    for tag, label in (("f32", "1x2 float32"),
                       ("control", "1x2 float32 control (partials merged "
                                   "without their max rescale)")):
        v = r0[tag]
        log(f"[static-plan] (b) {label}, {SPLAN_F32_LAYERS}/28 layers, wq "
            f"and wk x {SPLAN_SHARP}: tokens equal and logps within "
            f"{TOL_PLAN_LP} of one device: {v['held']}; |Δ logp| mean "
            f"{v['gap'][0]:.3e}, max {v['gap'][1]:.3e}, "
            f"{v['gap'][2]}/{len(v['tokens'])} requests token-equal | {card}")
        if v["held"] != (tag == "f32"):
            raise AssertionError(f"({tag}) the bar is "
                                 f"{'missed' if tag == 'f32' else 'held'}")
    mean, worst, same = r0["long"]["gap"]
    log(f"[static-plan] (c) long 2x1 (the sequence and heads over 'data'), "
        f"qwen3-1.7b bf16 {SPLAN_BF16_LAYERS}/28, 1 x {SPLAN_LONG} + "
        f"{SPLAN_LONG_NEW}: "
        f"weights {r0['long_weight_bytes'] / 1e9:.3f} GB a rank; dense cache "
        f"{r0['long_cache_bytes'] / 1e9:.3f} GB a rank of "
        f"{r0['long_cache_full'] / 1e9:.3f} GB ({SPLAN_LONG + SPLAN_LONG_NEW} "
        f"positions, {(SPLAN_LONG + SPLAN_LONG_NEW) // 2} a rank); "
        f"{r0['long']['s']:.2f} s (one device {r0['long']['ref_s']:.2f} s); "
        f"|Δ logp| mean {mean:.3e}, max {worst:.3e}, {same}/1 token-equal "
        f"| {card}")
    if r0["long_cache_bytes"] * 2 != r0["long_cache_full"] or \
            not mean <= TOL_LOGP_MEAN_BF16:
        raise AssertionError("(c) long: a rank holds more than half the "
                             "cache, or the logps are off one device's")
    for tag in ("mamba2", "whisper", "llama"):
        v = r0[tag]
        mean, worst, same = v["gap"]
        bar = TOL_SSD_PLAN_MEAN_BF16 if tag == "mamba2" else \
            TOL_LOGP_MEAN_BF16
        extra = ""
        if tag == "whisper":
            extra = (f"; encoder through K5 at a rank's heads "
                     f"({r0['whisper_encode_k5']} launches), memory "
                     f"{v['mem_rows']} rows a rank")
        if tag == "llama":
            extra = f"; memory {v['mem_rows']} rows a rank"
        depth = FAM_LAYERS.get(tag, "all")
        log(f"[static-plan] (d) {tag} bf16 ({depth} layers) on 1x2: weights "
            f"{r0[tag + '_weight_bytes'] / 1e9:.3f} GB a rank; cache "
            f"{v['cache_bytes'] / 1e6:.1f} MB a rank; {v['s']:.2f} s (one "
            f"device {v['ref_s']:.2f} s); |Δ logp| mean {mean:.3e}, max "
            f"{worst:.3e}, {same}/{len(v['tokens'])} token-equal; recompute "
            f"on the plan launched {v['recompute_launches']}, |Δ| against "
            f"one device's mean {v['recompute_gap'][0]:.3e} max "
            f"{v['recompute_gap'][1]:.3e} (means <= {bar}){extra} | {card}")
        f = r0[tag + "_f32"]
        log(f"[static-plan] (d) {tag} float32 pair: tokens equal and logps "
            f"within {TOL_PLAN_LP}: {f['held']}; |Δ logp| mean "
            f"{f['gap'][0]:.3e}, max {f['gap'][1]:.3e} | {card}")
        if not mean <= bar or not f["held"] or \
                not v["recompute_gap"][0] <= bar:
            raise AssertionError(f"(d) {tag}: off one device's")
    whisper, vlm = (get_config(n) for n in ("whisper-small",
                                            "llama-3.2-vision-11b"))

    def half(n):
        return n // 2 if n % 2 == 0 else n
    if r0["mamba2"]["recompute_launches"]["ssd_scan"] != \
            FAM_LAYERS["mamba2"] \
            or r0["whisper_encode_k5"] != whisper.encoder_layers \
            or r0["whisper"]["mem_rows"] != half(whisper.encoder_seq) \
            or r0["llama"]["mem_rows"] != half(vlm.memory_seq):
        raise AssertionError("(d) K6 / K5 launches or memory rows off")
    d = r0["door"]
    log(f"[static-plan] (e) the door on 1x2 (float32, {SPLAN_F32_LAYERS} "
        f"layers): {d['clients']} clients at once against rank 0 in "
        f"{d['wall_s']:.2f} s; tokens equal to the plan engine's generate "
        f"under the same key: {d['equal']} | {card}")
    if not d["equal"] or d["clients"] != SPLAN_DOOR_CLIENTS:
        raise AssertionError("(e) the door's tokens differ from the plan "
                             "engine's")
    t0 = time.perf_counter()
    rows = static_kernel_rows(dev, seed, card)
    log(f"[time] static plan: (f) kernel rows {time.perf_counter() - t0:.1f}s")
    return launches, rows


# --------------------------------------------------------------------------
# phase 17: the MoE family and jamba on serve plans, the continuous engine
# on a long plan, the threaded runtime on a live sampler plan

# depth cuts (widths never cut): scout 4 of 48 layers (21.8 GB in bf16),
# its float32 pair 2; maverick one period, 2 of 48 (MoE + MLP, 37.2 GB);
# jamba 2 of 72 (attention + MoE, Mamba2 + MLP: 23.5 GB in bf16, 47.0 in
# float32), its float32 pair at the same depth
MPLAN_SCOUT_LAYERS, MPLAN_F32_LAYERS, MPLAN_MAV_LAYERS = 4, 2, 2
MPLAN_JAMBA_LAYERS = 2
MPLAN_NEW = 16                    # new tokens of the gloo runs
MPLAN_REQS = 2                    # requests of the gloo runs' traffic
MPLAN_ROWS, MPLAN_LEN = 4, 256    # the static engine's batch: 4 x 256
JAMBA_PLAN_ROWS, JAMBA_PLAN_LEN = 4, 512
LONG17_LEN, LONG17_NEW, LONG17_REQS = 4096, 32, 2
LONG17_LAYERS = 8                 # (e) qwen3-1.7b at 8 of its 28 layers
THREADS17_STEPS = 2
JAMBA = "jamba-1.5-large-398b"


def draw_params(cfg, seed, dev, plan=None):
    """Random weights for ``cfg`` drawn slab by slab: every (block[,
    expert]) slab of a leaf from its own generator, seeded by (seed, leaf,
    slab), so a rank of ``plan`` draws only the slabs its shard overlaps,
    cuts them, and never holds a whole leaf (maverick's expert leaves are
    10.7 GB each in bf16). ``plan`` None: the full tree, the same numbers.
    Normal leaves N(0, scale^2), drawn in float32 and cast; the SSM's
    A_log and dt_bias as ``init_params`` draws them."""
    from repro_torch.models.params import param_templates
    dt = getattr(torch, cfg.dtype)
    shardings = None if plan is None else plan.param_shardings(cfg)

    def slab(t, key, shape):
        gen = torch.Generator(device=dev).manual_seed(key)
        if t.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if t.init == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        u = torch.empty(shape, dtype=torch.float32, device=dev)
        if t.init == "ssm_a":
            return u.uniform_(1.0, 16.0, generator=gen).log_().to(dt)
        if t.init == "ssm_dt":
            return u.uniform_(1e-3, 1e-1, generator=gen).expm1_().log_().to(
                dt)
        return u.normal_(generator=gen).mul_(t.scale).to(dt)

    def leaf(t, sh, index):
        shape = tuple(t.shape)
        cut = (tuple(slice(0, n) for n in shape) if sh is None
               else sh.index(plan._rank, shape))
        lead = 0 if len(shape) <= 2 else (1 if len(shape) == 3 else 2)
        out = torch.empty(tuple(c.stop - c.start for c in cut), dtype=dt,
                          device=dev)
        for pos in np.ndindex(*(c.stop - c.start for c in cut[:lead])):
            at = tuple(c.start + i for c, i in zip(cut[:lead], pos))
            key = seed * 1_000_003 + index * 65_537 + int(
                np.ravel_multi_index(at, shape[:lead]) if lead else 0)
            out[pos] = slab(t, key, shape[lead:])[cut[lead:]]
        return out

    counter = iter(range(1 << 30))

    def walk(tmpl, sh):
        if isinstance(tmpl, dict):
            return {k: walk(tmpl[k], None if sh is None else sh[k])
                    for k in sorted(tmpl)}
        return leaf(tmpl, sh, next(counter))
    return walk(param_templates(cfg), shardings)


def wrong_experts(serve_shard):
    """The MoE control: each rank runs the next rank's experts (its own
    weights on the rows dispatched to other experts)."""
    def wrong(plan, cfg):
        shard = serve_shard(plan, cfg)
        e0, en = shard.experts
        return dataclasses.replace(
            shard, experts=((e0 + en) % cfg.num_experts, en))
    return wrong


def moe_cfg(name, layers, dtype="bfloat16", **over):
    """``name`` at full width, ``layers`` deep, through K3/K4 and K5/K6."""
    cfg = get_config(name)
    if cfg.period > layers:                 # jamba: its period cut
        over = dict(block_pattern=cfg.block_pattern[:layers], **over)
    return dataclasses.replace(cfg, num_layers=layers, dtype=dtype,
                               paged_attn_impl="pallas", attn_impl="pallas",
                               ssd_impl="pallas", **over)


def moe_plan_one_rank(dev, seed, card, work):
    """Phase 17 (a): scout 4 of 48 layers, bf16, on a 1x1 serve plan of a
    one-rank NCCL group against the one-device engine on the same
    weights: 8 requests of 64-1024 tokens, 32 new; tokens and logps
    bit-equal, K3/K4 launches and drops equal."""
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel import ExecutionPlan, make_debug_mesh
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl17",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        plan = ExecutionPlan(make_debug_mesh(1, 1, device=dev), "serve")
        cfg = moe_cfg(SCOUT, MPLAN_SCOUT_LAYERS)
        params = draw_params(cfg, seed + 70, dev)
        prompts = plan_prompts(cfg.vocab_size, seed)
        with DropLog() as d_ref:
            ref = plan_run(cfg, params, prompts, None, seed)
        with DropLog() as d_got:
            got = plan_run(cfg, params, prompts, plan, seed)
        equal = all(np.array_equal(a.tokens, b.tokens)
                    and np.array_equal(a.logps, b.logps)
                    for a, b in zip(got["results"], ref["results"]))
        drops = d_got.lists()
        log(f"[moe-plan] (a) {plan.describe()} one-rank NCCL, {cfg.name} "
            f"bf16 {cfg.num_layers}/48 layers (E {cfg.num_experts} top-"
            f"{cfg.experts_per_token} + shared), {len(prompts)} requests of "
            f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
            f"{PLAN_NEW} new: tokens and logps "
            f"{'bit-equal' if equal else 'NOT bit-equal'} to the one-device "
            f"engine; drops equal {drops == d_ref.lists()} (prefill mean "
            f"{np.mean(drops['prefill']):.4f}); decode {got['ms']:.2f} ms a "
            f"step on the plan vs {ref['ms']:.2f}; K3/K4 launches "
            f"{got['launches']} vs {ref['launches']} | {card}")
        if not equal or got["launches"] != ref["launches"] or \
                drops != d_ref.lists():
            raise AssertionError("(a) scout on the 1x1 serve plan differs "
                                 "from one device")
        del params
        free()
        return got["launches"]
    finally:
        dist.destroy_process_group()


def moe_rank_main(rank, world, work, seed, card, dev=None):
    """Phase 17 (b)-(f), one of two rank processes on the one card (gloo
    with CUDA tensors). Writes ``work/moe<r>.json``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel import ExecutionPlan, make_mesh
    from repro_torch.parallel import plan as plan_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/gloo17",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    meshes = {d: make_mesh(d, ("data", "model"), device=dev)
              for d in ((1, 2), (2, 1))}
    s12, s21 = (ExecutionPlan(meshes[d], "serve") for d in ((1, 2), (2, 1)))
    long21 = ExecutionPlan(meshes[(2, 1)], "long")
    out = {"rank": rank, "launches": {}}
    # the serve plan's traffic cut to MPLAN_REQS requests, the last still
    # sharing request 0's prefix
    prompts = plan_prompts(get_config(SCOUT).vocab_size, seed)
    prompts = prompts[:MPLAN_REQS - 1] + prompts[-1:]

    def params_on(cfg, plan, pseed):
        """This rank's shard, the ranks one after the other."""
        p = None
        for r in range(world):
            if rank == r:
                p = draw_params(cfg, pseed, dev, plan)
                free()
            dist.barrier()
        return p

    def cont(tag, cfg, params, plan, reqs=prompts):
        with DropLog() as drops:
            r = plan_run(cfg, params, reqs, plan, seed)
        add_launches(out, r["launches"])
        out[tag] = {"tokens": [x.tokens.tolist() for x in r["results"]],
                    "ms": r["ms"], "pool_bytes": r["pool_bytes"],
                    "drops": drops.lists(), "launches": r["launches"]}
        return r

    def static(tag, cfg, params, plan, sprompts, new):
        with DropLog() as drops:
            r = static_run(cfg, params, sprompts, plan, seed, new)
        del r["engine"]                    # it holds the params
        add_launches(out, r["launches"])
        out[tag] = {"tokens": [x.tokens.tolist() for x in r["results"]],
                    "s": r["s"], "drops": drops.lists(),
                    "launches": r["launches"]}
        return r

    def on_rank0(fn):
        """``fn()`` on rank 0 alone, the other rank waiting."""
        if rank == 0:
            fn()
            free()
        dist.barrier()

    def pair(tag, got, ref, kind="results"):
        out[tag]["gap"] = logp_gap(got[kind], ref[kind])
        out[tag]["held"] = plan_held(got[kind], ref[kind])

    # (b) scout 4/48 bf16 on 1x2, both engines
    t0 = time.perf_counter()
    cfg = moe_cfg(SCOUT, MPLAN_SCOUT_LAYERS)
    sprompts = static_prompts(cfg.vocab_size, seed + 3, MPLAN_ROWS,
                              MPLAN_LEN)
    params = params_on(cfg, s12, seed + 70)
    out["scout_bytes"] = tree_bytes(params)
    out["scout_experts"] = list(s12.serve_shard(cfg).experts)
    b_c = cont("scout_c", cfg, params, s12)
    b_s = static("scout_s", cfg, params, s12, sprompts, MPLAN_NEW)
    del params
    free()

    def ref_b():
        full = draw_params(cfg, seed + 70, dev)
        out["scout_full_bytes"] = tree_bytes(full)
        with DropLog() as drops:
            rc = plan_run(cfg, full, prompts, None, seed)
        out["scout_c"]["ref_drops"] = drops.lists()
        out["scout_c"]["ref_ms"] = rc["ms"]
        pair("scout_c", b_c, rc)
        with DropLog() as drops:
            rs = static_run(cfg, full, sprompts, None, seed, MPLAN_NEW)
        out["scout_s"]["ref_drops"] = drops.lists()
        out["scout_s"]["ref_s"] = rs["s"]
        pair("scout_s", b_s, rs)
    on_rank0(ref_b)
    # (b) the float32 pair at 2/48 and its control
    c2 = moe_cfg(SCOUT, MPLAN_F32_LAYERS, "float32")
    params = params_on(c2, s12, seed + 71)
    f32 = cont("scout_f32", c2, params, s12)
    serve_shard = plan_mod._serve_shard
    plan_mod._serve_shard = wrong_experts(serve_shard)
    try:
        ctl = cont("scout_ctl", c2, params, s12)
    finally:
        plan_mod._serve_shard = serve_shard
    del params
    free()

    def ref_f32():
        full = draw_params(c2, seed + 71, dev)
        with DropLog() as drops:
            rc = plan_run(c2, full, prompts, None, seed)
        out["scout_f32"]["ref_drops"] = drops.lists()
        pair("scout_f32", f32, rc)
        pair("scout_ctl", ctl, rc)
    on_rank0(ref_f32)
    out["t_b"] = time.perf_counter() - t0
    # (c) maverick's period on 2x1 (experts whole, FFN columns over
    # 'data', the decode slots over 'data'), then moe_ep="serve" on 1x2
    t0 = time.perf_counter()
    cm = moe_cfg(MAVERICK, MPLAN_MAV_LAYERS)
    params = params_on(cm, s21, seed + 72)
    out["mav_bytes"] = tree_bytes(params)
    out["mav_ffn"] = list(s21.serve_shard(cm).expert_ffn)
    mav = cont("mav", cm, params, s21)
    del params
    free()
    nodrop = float(cm.num_experts // cm.experts_per_token)
    cep = dataclasses.replace(cm, moe_ep="serve", ep_dp_axes=("data",),
                              capacity_factor=nodrop)
    params = params_on(cep, s12, seed + 72)
    out["mav_ep_bytes"] = tree_bytes(params)
    out["mav_ep_experts"] = list(s12.serve_shard(cep).experts)
    ep = cont("mav_ep", cep, params, s12)
    del params
    free()

    def ref_c():
        full = draw_params(cm, seed + 72, dev)
        out["mav_full_bytes"] = tree_bytes(full)
        with DropLog() as drops:
            rc = plan_run(cm, full, prompts, None, seed)
        out["mav"]["ref_drops"] = drops.lists()
        out["mav"]["ref_ms"] = rc["ms"]
        pair("mav", mav, rc)
        one = dataclasses.replace(cm, capacity_factor=nodrop)
        with DropLog() as drops:
            rc = plan_run(one, full, prompts, None, seed)
        out["mav_ep"]["ref_drops"] = drops.lists()
        out["mav_ep"]["ref_ms"] = rc["ms"]
        pair("mav_ep", ep, rc)
    on_rank0(ref_c)
    out["t_c"] = time.perf_counter() - t0
    # (d) jamba 2/72 on 1x2 through the static engine and the recompute
    t0 = time.perf_counter()
    for dtype, tag, pseed in (("bfloat16", "jamba", seed + 73),
                              ("float32", "jamba_f32", seed + 74)):
        cj = moe_cfg(JAMBA, MPLAN_JAMBA_LAYERS, dtype)
        jp = static_prompts(cj.vocab_size, seed + 4, JAMBA_PLAN_ROWS,
                            JAMBA_PLAN_LEN)
        params = params_on(cj, s12, pseed)
        out[tag + "_bytes"] = tree_bytes(params)
        r = static(tag, cj, params, s12, jp, MPLAN_NEW)
        roll = rollout_from_results(jp, r["results"], MPLAN_NEW, device=dev)
        reset_counts()
        lp = token_logps(cj, params, roll["tokens"], plan=s12)
        torch.cuda.synchronize()
        add_launches(out, counts())
        out[tag]["recompute_launches"] = counts()
        del params
        free()

        def ref_d(cj=cj, jp=jp, pseed=pseed, r=r, lp=lp, roll=roll, tag=tag):
            full = draw_params(cj, pseed, dev)
            out[tag + "_full_bytes"] = tree_bytes(full)
            rs = static_run(cj, full, jp, None, seed, MPLAN_NEW)
            out[tag]["ref_s"] = rs["s"]
            pair(tag, r, rs)
            want = token_logps(cj, full, roll["tokens"])
            mask = roll["comp_mask"] > 0
            d = (lp[:, JAMBA_PLAN_LEN - 1:]
                 - want[:, JAMBA_PLAN_LEN - 1:]).abs()[mask]
            out[tag]["recompute_gap"] = [float(d.mean()), float(d.max())]
        on_rank0(ref_d)
        del lp, roll, r
        free()
    out["t_d"] = time.perf_counter() - t0
    # (e) qwen3-1.7b at LONG17_LAYERS on a long 2x1 plan through
    # ContinuousEngine
    t0 = time.perf_counter()
    cq = moe_cfg("qwen3-1.7b", LONG17_LAYERS)
    lp_ = static_prompts(cq.vocab_size, seed + 5, LONG17_REQS, LONG17_LEN)
    lreqs = [p for p in lp_]
    params = params_on(cq, long21, seed + 75)
    out["long_bytes"] = tree_bytes(params)
    lng = long_run("long", cq, params, long21, lreqs, seed, out)
    del params
    free()

    def ref_e():
        full = draw_params(cq, seed + 75, dev)
        out["long_full_bytes"] = tree_bytes(full)
        rc = long_run(None, cq, full, None, lreqs, seed, out)
        out["long"]["ref_s"] = rc["s"]
        out["long_full_pool_bytes"] = rc["pool_bytes"]
        pair("long", lng, rc)
    on_rank0(ref_e)
    out["t_e"] = time.perf_counter() - t0
    # (f) ThreadedHeteroRuntime.run on the 1x2 sampler plan
    t0 = time.perf_counter()
    threads_rank(out, s12, seed, dev)
    out["t_f"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    with open(Path(work) / f"moe{rank}.json", "w") as fh:
        json.dump(out, fh)
    return 0


def long_run(tag, cfg, params, plan, prompts, seed, out):
    """``prompts`` through a ContinuousEngine on ``plan`` (None: one
    device): page 16, prefill chunk 512, LONG17_NEW new tokens at
    temperature 1.0; records the run under ``tag`` in ``out``."""
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0,
                  max_new_tokens=LONG17_NEW)
    serve = ServeConfig(num_slots=len(prompts), page_size=PAGE,
                        prefill_chunk=512, sync_every=8,
                        max_total_tokens=LONG17_LEN + LONG17_NEW,
                        paged_attn_impl="pallas", seed=seed)
    eng = build_engine(cfg, params, serve, rl=rl, vocab_limit=cfg.vocab_size,
                       key=prng.PRNGKey(seed), plan=plan)
    sp = SamplingParams.from_rl(rl)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = eng.generate([Request(rid=i, prompt=p, params=sp)
                        for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = eng.stats()
    launches = {k: counts()[k] for k in ("paged_decode", "paged_prefill")}
    want = {"paged_decode": cfg.num_layers * st["decode_steps"],
            "paged_prefill": cfg.num_layers * st["prefill_chunks"]}
    if launches != want:
        raise AssertionError(f"long run launches {launches} != {want}")
    r = {"results": res, "s": secs, "pool_bytes": tree_bytes(eng.pool),
         "launches": launches}
    if tag is not None:
        add_launches(out, launches)
        out[tag] = {"tokens": [x.tokens.tolist() for x in res], "s": secs,
                    "pool_bytes": r["pool_bytes"], "launches": launches}
    del eng
    return r


def threads_rank(out, plan, seed, dev):
    """Phase 17 (f) on a rank: ``ThreadedHeteroRuntime.run`` on the 1x2
    sampler plan, qwen3-1.7b at LOOP_LAYERS, 2 samplers (rank 0 runs the
    threads, rank 1 replays its sections): every batch the rank's samplers
    generated, in order, and the learner's history."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=LOOP_LAYERS)
    rl = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=MPLAN_NEW,
                  temperature=1.0, top_k=0, top_p=1.0, beta_kl=0.005,
                  engine="continuous")
    tc = TrainConfig(grad_accum=1, logprob_impl="fused")
    hcfg = HeteroConfig(num_samplers=2, max_delay_steps=64,
                        delay_median_s=60.0, seed=seed)
    task = ArithmeticTask(max_operand=99, ops="+-", prompt_width=64,
                          seed=seed)
    state = init_state(cfg, tc, draw_params(cfg, seed + 76, dev))
    rt = ThreadedHeteroRuntime(cfg, rl, tc, hcfg, task, Tokenizer(), state,
                               prompts_per_batch=1, time_scale=1e-3,
                               device=dev, sampler_plan=plan)
    seen = []
    for s in rt.samplers:
        def recorded(now_s, gen=s.generate_batch):
            b = gen(now_s)
            seen.append(b)
            return b
        s.generate_batch = recorded
    reset_counts()
    t0 = time.perf_counter()
    try:
        hist = rt.run(THREADS17_STEPS)
    finally:
        for t in rt.threads:
            t.join(THREAD_JOIN_S)
    torch.cuda.synchronize()
    add_launches(out, counts())
    out["threads"] = {
        "s": time.perf_counter() - t0, "leader": rt.leader,
        "steps": rt.learner.step,
        "alive": [t.name for t in rt.threads if t.is_alive()],
        "batches": [[b.sampler_id, b.version, b.tokens.tolist(),
                     np.round(b.sampler_lp, 6).tolist()] for b in seen],
        "staleness": hist.get("staleness").tolist(),
        "loss": hist.get("loss").tolist(), "launches": counts()}
    del rt, state
    free()


def dry_run_bytes(cfg, tag, r0, r1):
    """The dry-run's parameter bytes a rank of ``cfg`` on the 1x2 serve
    plan (``launch.dryrun.rank_param_bytes``, from the fitted shardings)
    beside the bytes the two ranks hold (``tree_bytes``); True when all
    three are equal."""
    from repro_torch.parallel import ExecutionPlan
    dry = rank_param_bytes(cfg, ExecutionPlan(abstract_mesh((1, 2)),
                                              "serve"))
    log(f"[moe-plan] {tag}: the dry-run's parameter bytes a rank on 1x2 "
        f"{dry} ({dry / 1e9:.3f} GB), held {r0[tag + '_bytes']} / "
        f"{r1[tag + '_bytes']} (one device {r0[tag + '_full_bytes']})")
    return dry == r0[tag + "_bytes"] == r1[tag + "_bytes"]


def moe_plan_phase(dev, seed, card, ranks):
    """Phase 17; ``ranks`` the two rank processes' records of (b)-(f)
    (``rank_pair``). Returns (its launches, the kernel rows of (g))."""
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-phase17-")
    t0 = time.perf_counter()
    launches = dict(moe_plan_one_rank(dev, seed, card, work))
    log(f"[time] moe plan: (a) one-rank NCCL {time.perf_counter() - t0:.1f}s")
    r0, r1 = ranks
    log(f"[time] moe plan: (b)-(f) on the ranks {r0['t_part']:.1f}s ((b) "
        f"{r0['t_b']:.1f}, (c) {r0['t_c']:.1f}, (d) {r0['t_d']:.1f}, (e) "
        f"{r0['t_e']:.1f}, (f) {r0['t_f']:.1f})")
    for r in (r0, r1):
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    tags = ["scout_c", "scout_s", "scout_f32", "scout_ctl", "mav", "mav_ep",
            "jamba", "jamba_f32", "long"]
    for tag in tags:
        if r0[tag]["tokens"] != r1[tag]["tokens"]:
            raise AssertionError(f"({tag}) the two ranks emit different "
                                 "tokens")
    gib = 2 ** 30
    # (b)
    bars = []
    for tag, label in (("scout_c", f"ContinuousEngine, {MPLAN_REQS} "
                                   f"requests of the serve plan's + "
                                   f"{PLAN_NEW}"),
                       ("scout_s", f"StaticEngine {MPLAN_ROWS} x "
                                   f"{MPLAN_LEN} + {MPLAN_NEW}")):
        v = r0[tag]
        mean, worst, same = v["gap"]
        drops_eq = v["drops"] == v["ref_drops"]
        log(f"[moe-plan] (b) 1x2 over gloo (2 ranks on one card), "
            f"{SCOUT} bf16 {MPLAN_SCOUT_LAYERS}/48, {label}: experts "
            f"{r0['scout_experts']} / {r1['scout_experts']} a rank, weights "
            f"{r0['scout_bytes'] / 1e9:.3f} / "
            f"{r1['scout_bytes'] / 1e9:.3f} GB "
            f"a rank (one device {r0['scout_full_bytes'] / 1e9:.3f} GB); "
            f"|Δ logp| against one device before each request's first "
            f"differing token: mean {mean:.3e}, max {worst:.3e}, "
            f"{same}/{len(v['tokens'])} requests token-equal; moe_drop_frac "
            f"prefill mean {np.mean(v['drops']['prefill']):.4f} (one device "
            f"{np.mean(v['ref_drops']['prefill']):.4f}), every forward equal "
            f"{drops_eq}; launches {v['launches']} | {card}")
        bars.append(mean <= TOL_LOGP_MEAN_BF16)
    half = get_config(SCOUT).num_experts // 2
    if not all(bars) or r0["scout_bytes"] * 2 > r0["scout_full_bytes"] * 1.01 \
            or r0["scout_experts"] != [0, half] or \
            r1["scout_experts"] != [half, half]:
        raise AssertionError("(b) scout bf16: a rank holds more than its "
                             "half, or the logps are off one device's")
    if not dry_run_bytes(moe_cfg(SCOUT, MPLAN_SCOUT_LAYERS), "scout", r0, r1):
        raise AssertionError("(b) scout bf16: the dry-run's bytes a rank "
                             "differ from the bytes the ranks hold")
    for tag, label in (("scout_f32", "float32 pair"),
                       ("scout_ctl", "float32 control (each rank on the "
                                     "next rank's experts)")):
        v = r0[tag]
        log(f"[moe-plan] (b) {SCOUT} {label}, {MPLAN_F32_LAYERS}/48 layers, "
            f"ContinuousEngine: tokens equal and logps within {TOL_PLAN_LP} "
            f"of one device: {v['held']}; |Δ logp| mean {v['gap'][0]:.3e}, "
            f"max {v['gap'][1]:.3e}, {v['gap'][2]}/{len(v['tokens'])} "
            f"token-equal; drops equal to one device's "
            f"{v['drops'] == r0['scout_f32']['ref_drops']} | {card}")
    if not r0["scout_f32"]["held"] or r0["scout_ctl"]["held"] or \
            r0["scout_f32"]["drops"] != r0["scout_f32"]["ref_drops"]:
        raise AssertionError("(b) the float32 pair misses its bar, or the "
                             "control holds it")
    # (c)
    for tag, label in (("mav", f"2x1 ({r0['mav_ffn']} / {r1['mav_ffn']} of "
                               f"each expert's FFN columns a rank)"),
                       ("mav_ep", f"1x2 moe_ep='serve' (experts "
                                  f"{r0['mav_ep_experts']} / "
                                  f"{r1['mav_ep_experts']}), capacity "
                                  f"factor {get_config(MAVERICK).num_experts}"
                                  f" (no drops)")):
        v = r0[tag]
        mean, worst, same = v["gap"]
        log(f"[moe-plan] (c) {MAVERICK} bf16 {MPLAN_MAV_LAYERS}/48 on {label}"
            f": weights {r0[tag + '_bytes'] / 1e9:.3f} GB a rank (one device "
            f"{r0['mav_full_bytes'] / 1e9:.3f} GB); |Δ logp| mean "
            f"{mean:.3e}, max {worst:.3e}, {same}/{len(v['tokens'])} "
            f"token-equal; moe_drop_frac prefill "
            f"{v['drops']['prefill']} decode mean "
            f"{np.mean(v['drops']['decode'] or [0]):.4f} (one device "
            f"{v['ref_drops']['prefill']}, "
            f"{np.mean(v['ref_drops']['decode'] or [0]):.4f}); decode "
            f"{v['ms']:.2f} ms a step (one device {v['ref_ms']:.2f}) | {card}")
        if not mean <= TOL_LOGP_MEAN_BF16:
            raise AssertionError(f"({tag}) maverick off one device's")
    v = r0["mav"]
    if v["drops"]["prefill"] != v["ref_drops"]["prefill"] or \
            (v["gap"][2] == len(v["tokens"])
             and v["drops"] != v["ref_drops"]) or \
            not any(v["drops"]["prefill"] + v["drops"]["decode"]) or \
            any(r0["mav_ep"]["drops"]["prefill"]):
        raise AssertionError("(c) maverick's drops differ from one device's")
    # (d)
    for tag in ("jamba", "jamba_f32"):
        v = r0[tag]
        mean, worst, same = v["gap"]
        log(f"[moe-plan] (d) {JAMBA} {tag[6:] or 'bf16'} "
            f"{MPLAN_JAMBA_LAYERS}/72 layers on 1x2, StaticEngine "
            f"{JAMBA_PLAN_ROWS} x {JAMBA_PLAN_LEN} + {MPLAN_NEW}: weights "
            f"{r0[tag + '_bytes'] / 1e9:.3f} GB a rank (one device "
            f"{r0[tag + '_full_bytes'] / 1e9:.3f} GB); tokens equal and "
            f"logps within {TOL_PLAN_LP}: {v['held']}; |Δ logp| mean "
            f"{mean:.3e}, max {worst:.3e}, {same}/{len(v['tokens'])} "
            f"token-equal; recompute on the plan launched "
            f"{v['recompute_launches']}, |Δ| against one device's mean "
            f"{v['recompute_gap'][0]:.3e} max {v['recompute_gap'][1]:.3e}; "
            f"{v['s']:.2f} s (one device {v['ref_s']:.2f} s) | {card}")
        rl = v["recompute_launches"]
        if rl["ssd_scan"] != 1 or rl["flash_attention"] != 1 or \
                rl["logprob_fwd"] != 1:
            raise AssertionError(f"({tag}) the recompute missed K5/K6/K1")
    held = [dry_run_bytes(moe_cfg(JAMBA, MPLAN_JAMBA_LAYERS, dtype), tag,
                          r0, r1)
            for tag, dtype in (("jamba", "bfloat16"),
                               ("jamba_f32", "float32"))]
    if not all(held):
        raise AssertionError("(d) jamba: the dry-run's bytes a rank differ "
                             "from the bytes the ranks hold")
    if not r0["jamba"]["gap"][0] <= TOL_LOGP_MEAN_BF16 or \
            not r0["jamba"]["recompute_gap"][0] <= TOL_LOGP_MEAN_BF16 or \
            not r0["jamba_f32"]["held"] or \
            not r0["jamba_f32"]["recompute_gap"][1] <= TOL_PLAN_LP:
        raise AssertionError("(d) jamba on the plan is off one device's")
    # (e)
    v = r0["long"]
    mean, worst, same = v["gap"]
    log(f"[moe-plan] (e) long 2x1, qwen3-1.7b bf16 {LONG17_LAYERS}/28, "
        f"ContinuousEngine "
        f"{LONG17_REQS} x {LONG17_LEN} + {LONG17_NEW}, page {PAGE}, prefill "
        f"chunk 512: weights {r0['long_bytes'] / 1e9:.3f} GB a rank (one "
        f"device {r0['long_full_bytes'] / 1e9:.3f} GB), page pools "
        f"{v['pool_bytes'] / gib:.3f} GiB a rank (one device "
        f"{r0['long_full_pool_bytes'] / gib:.3f} GiB, whole over 'data'); "
        f"|Δ logp| mean {mean:.3e}, max {worst:.3e}, {same}/{LONG17_REQS} "
        f"token-equal; {v['s']:.2f} s (one device {v['ref_s']:.2f} s); "
        f"launches {v['launches']} | {card}")
    if r0["long_bytes"] * 2 > r0["long_full_bytes"] * 1.01 or \
            v["pool_bytes"] != r0["long_full_pool_bytes"] or \
            not mean <= TOL_LOGP_MEAN_BF16:
        raise AssertionError("(e) long: a rank holds more than half the "
                             "weights, or not the whole pools, or the logps "
                             "are off one device's")
    # (f)
    a, b = r0["threads"], r1["threads"]
    log(f"[moe-plan] (f) ThreadedHeteroRuntime.run({THREADS17_STEPS}) on the "
        f"1x2 sampler plan, qwen3-1.7b {LOOP_LAYERS}/28, 2 samplers: rank 0 "
        f"led ({a['leader']}), rank 1 replayed; {a['s']:.2f} s; "
        f"{len(a['batches'])} batches on each rank, equal "
        f"{a['batches'] == b['batches']}; versions "
        f"{[x[1] for x in a['batches']]}; staleness {a['staleness']} (rank "
        f"1 {b['staleness']}); loss {a['loss']}; threads alive after the run "
        f"{a['alive']} | {card}")
    if a["batches"] != b["batches"] or a["staleness"] != b["staleness"] or \
            a["steps"] != THREADS17_STEPS or b["steps"] != THREADS17_STEPS \
            or not a["leader"] or b["leader"] or a["alive"] or \
            not np.isfinite(a["loss"]).all():
        raise AssertionError("(f) the threaded runtime's ranks disagree")
    t0 = time.perf_counter()
    cfg = get_config(SCOUT)
    rows = plan_kernel_rows(dev, seed, cfg.num_heads // 2,
                            cfg.num_kv_heads // 2,
                            label="scout serve plan 1x2, one rank",
                            tag="[moe-plan] (g)", salt=17)
    # K6 at jamba's recompute on one 1x2 rank: 4 x 527 tokens padded to
    # 3 chunks of 256, 128 of 256 SSM heads
    jamba = get_config(JAMBA)
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    rows["ssd_scan"] = ssd_row(
        gen, dev, f"jamba recompute, 1x2 rank ({jamba.ssm_heads // 2} of "
        f"{jamba.ssm_heads} heads)", JAMBA_PLAN_ROWS, 3 * jamba.ssm_chunk,
        jamba.ssm_heads // 2, jamba.ssm_headdim, jamba.ssm_ngroups,
        jamba.ssm_state, jamba.ssm_chunk, torch.bfloat16, True)
    log(f"[time] moe plan: (g) kernel rows {time.perf_counter() - t0:.1f}s")
    return launches, rows


# --------------------------------------------------------------------------
# phase 19: the repo's own small models served through the kernels. Their
# numbers are copied here (this script imports neither benchmarks/ nor the
# JAX package): bench-lm, the paper's CPU-scale experiment model
# (benchmarks/common.py:32-35; examples/quickstart.py, hetero_train.py),
# serve-bench (benchmarks/serve_throughput.py:44-48) and spec-lm
# (benchmarks/spec_bench.py:53), each at its only width and in float32
SMALL_MODELS = {
    "bench-lm": dict(num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
                     d_ff=192, vocab_size=32),
    "serve-bench": dict(num_layers=4, d_model=256, num_heads=8,
                        num_kv_heads=4, d_ff=512, vocab_size=32),
    "spec-lm": dict(num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
                    d_ff=512, vocab_size=64),
}
SMALL_NEW = 48                 # new tokens a request
SMALL_STATIC = (16, 128)       # the static engine's requests x prompt tokens


def small_cfg(name, **over):
    return ModelConfig(name=name, family="dense", block_pattern=(ATTN,),
                       ffn_pattern=(MLP,), dtype="float32",
                       attn_impl="naive", remat=False, rope_theta=1e4,
                       **SMALL_MODELS[name], **over)


def small_pair(tag, runs, tol):
    """The kernel run against the twin run on the same keys: tokens equal,
    logps within ``tol``. Returns the max |Δ logp|."""
    worst = 0.0
    for a, b in zip(runs["kernel"], runs["twin"]):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"[small] {tag} request {a.rid}: tokens "
                                 f"differ: {a.tokens.tolist()} vs "
                                 f"{b.tokens.tolist()}")
        worst = max(worst, float(np.abs(a.logps - b.logps).max()))
    if not worst <= tol:
        raise AssertionError(f"[small] {tag}: max |Δ logp| {worst:.3e} > "
                             f"{tol}")
    return worst


def small_models_phase(dev, seed, card):
    """(a) bench-lm through ContinuousEngine with paged_attn_impl "pallas"
    (K3 and K4 at D 24) and "ref" on the same keys; (b) serve-bench and
    spec-lm (D 32) with spec_k 4, K4's verify windows at D 32; (c) the
    static engine on bench-lm with attn_impl "pallas" (K5 at D 24) and
    "chunked". Each pair: tokens equal, logps within TOL_PLAN_LP (the
    float32 pair bar), the kernels' launches equal to layers x decode steps
    (K3), x prefill chunks and verify rounds (K4), x prefills (K5), and no
    launch on the twin's run. Returns the launches."""
    total = {"paged_decode": 0, "paged_prefill": 0, "flash_attention": 0}
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0)
    for name, spec_k in (("bench-lm", 0), ("serve-bench", SPEC_K),
                         ("spec-lm", SPEC_K)):
        t0 = time.perf_counter()
        cfg = small_cfg(name)
        params = init_params(cfg, seed, device=dev)
        prompts = templated_prompts(cfg.vocab_size, seed)[:SLOTS]
        runs, stats = {}, {}
        for tag, impl in (("kernel", "pallas"), ("twin", "ref")):
            # the rescore replays the kernel's windows through the folded
            # K4 launch; the twin's run has nothing to replay
            icfg = dataclasses.replace(cfg, paged_attn_impl=impl)
            res, st, launches, _, _ = spec_run(icfg, params, prompts, rl,
                                               SMALL_NEW, cfg.vocab_size,
                                               spec_k, seed,
                                               rescore=impl == "pallas")
            runs[tag], stats[tag] = res, (st, launches)
            for k in launches:
                total[k] += launches[k]
        worst = small_pair(name, runs, TOL_PLAN_LP)
        st, launches = stats["kernel"]
        if min(launches.values()) == 0 or any(stats["twin"][1].values()):
            raise AssertionError(f"[small] {name}: launches {launches}, "
                                 f"twin {stats['twin'][1]}")
        n_tok = sum(r.gen_count for r in runs["kernel"])
        log(f"[small] {name} (D {cfg.head_dim}, float32, {cfg.num_layers} "
            f"layers) through ContinuousEngine, spec_k {spec_k}: "
            f"{len(prompts)} requests, {n_tok} tokens equal through the "
            f"kernels and the twins, max |Δ logp| {worst:.3e} (<= "
            f"{TOL_PLAN_LP}); {st['decode_steps']} decode steps, "
            f"{st['prefill_chunks']} prefill chunks, {st['spec_rounds']} "
            f"verify rounds, {st.get('spec_fallback_chunks', 0)} fallback "
            f"chunks, accept rate {st['accept_rate']:.3f}; launches "
            f"{launches} (= {cfg.num_layers} x steps, chunks and rounds, "
            f"+1 a round for the rescore); {time.perf_counter() - t0:.1f}s "
            f"| {card}")
        del params
    # (c) the static engine through K5 at D 24
    t0 = time.perf_counter()
    cfg = small_cfg("bench-lm")
    params = init_params(cfg, seed, device=dev)
    rows, width = SMALL_STATIC
    rng = np.random.default_rng(seed + 19)
    prompts = rng.integers(3, cfg.vocab_size, (rows, width)).astype(np.int32)
    sp = SamplingParams.from_rl(rl, max_new=SMALL_NEW)
    runs, got = {}, {}
    for tag, impl in (("kernel", "pallas"), ("twin", "chunked")):
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        eng = build_engine(icfg, params, ServeConfig(engine="static",
                                                     seed=seed),
                           rl=rl, vocab_limit=cfg.vocab_size,
                           key=prng.PRNGKey(seed))
        reset_counts()
        runs[tag] = eng.generate([Request(rid=i, prompt=p, params=sp)
                                  for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        got[tag] = counts()
    want = {k: 0 for k in got["kernel"]}
    if got["twin"] != want:
        raise AssertionError(f"[small] static chunked run launched "
                             f"{got['twin']}")
    want["flash_attention"] = cfg.num_layers
    if got["kernel"] != want:
        raise AssertionError(f"[small] static run launched {got['kernel']}, "
                             f"want {want} ({cfg.num_layers} K5 for the "
                             "prefill)")
    total["flash_attention"] += got["kernel"]["flash_attention"]
    worst = small_pair("bench-lm static", runs, TOL_PLAN_LP)
    log(f"[small] bench-lm through StaticEngine, attn_impl pallas against "
        f"chunked: {rows} x {width} prompt tokens + {SMALL_NEW} new, tokens "
        f"equal, max |Δ logp| {worst:.3e} (<= {TOL_PLAN_LP}); K5 launches "
        f"{got['kernel']['flash_attention']} (= {cfg.num_layers} layers x 1 "
        f"prefill); {time.perf_counter() - t0:.1f}s | {card}")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PyTorch port smoke on one GPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # phases 14-17's rank processes
    ap.add_argument("--rank-work", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-card", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.rank is not None:
        return ranks_main(args.rank, 2, args.rank_work, args.seed,
                          args.rank_card)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[device] memory: the dry-run's HBM_BYTES {HBM_BYTES} "
        f"({HBM_BYTES / 2 ** 30:.2f} GiB), the card's total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} "
        f"({torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f}"
        f" GiB)")
    built = build.build()
    log(f"[build] {', '.join(s.name for s in build.sources())}: "
        f"{built.seconds:.1f}s nvcc (sm_90a, one process per source or "
        f"part of one: {sum(map(build.parts, build.sources()))} processes)")
    t0 = time.perf_counter()
    tensor_core_check(built)
    log(f"[time] tensor-core check {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kernels = logprob_phase(dev, args.seed)
    kernels.update(kernel_phase(dev, args.seed))
    log(f"[time] kernel phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    draws = draw_phase(dev, args.seed, card)
    log(f"[time] draw phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kernels.update(flash_phase(dev, args.seed))
    log(f"[time] K5 phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kernels.update(ssd_phase(dev, args.seed))
    log(f"[time] K6 phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for name, w in width_phase(dev, args.seed).items():
        row = kernels[name]
        row["widths"] = w
        if name == "ssd_scan":
            row["error_ratio"] = max(row["error_ratio"], *width_errs(
                w["rows"], "error_ratio"))
        e16, e32 = width_errs(w["rows"])
        row["max_abs_err"] = max(row["max_abs_err"], e16)
        row["max_abs_err_f32"] = max(row["max_abs_err_f32"], e32)
    log(f"[time] widths phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    F32_TALLY.update({k: 0 for k in F32_TALLY})    # the main path starts
    launches, twin = engine_phase(dev, args.seed, card, draws)
    log(f"[time] engine phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k5_static = static_phase(dev, args.seed, card)
    log(f"[time] static engine phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k5_gemma = gemma2_phase(dev, args.seed, card)
    log(f"[time] gemma2 phase {time.perf_counter() - t0:.1f}s")
    launches["flash_attention"] = k5_static + k5_gemma
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches["ssd_scan"] = mamba2_phase(dev, args.seed, card)
    log(f"[time] mamba2 phase {time.perf_counter() - t0:.1f}s")
    kernels["flash_attention"]["launches_by_phase"] = {
        "static (qwen3-1.7b prefill + 2 recomputes)": k5_static,
        "gemma2 (bf16 and float32 recomputes, generate, teacher-forced)":
            k5_gemma}
    t0 = time.perf_counter()
    launches.update(learner_phase(dev, args.seed, card))
    log(f"[time] learner phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hetero, warm, step_s = hetero_phase(dev, args.seed, card)
    for name, n in hetero.items():
        launches[name] += n
    log(f"[time] hetero phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    spec_launches, folded_errs = spec_phase(dev, args.seed, card)
    for name, n in spec_launches.items():
        launches[name] += n
    k4 = kernels["paged_prefill"]
    k4["max_abs_err_folded"], k4["max_abs_err_folded_f32"] = folded_errs
    k4["max_abs_err"] = max(k4["max_abs_err"], folded_errs[0])
    k4["max_abs_err_f32"] = max(k4["max_abs_err_f32"], folded_errs[1])
    log(f"[time] spec phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for name, n in threads_phase(dev, args.seed, card, warm, step_s).items():
        launches[name] += n
    del warm
    log(f"[time] threads phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for name, n in door_phase(dev, args.seed, card).items():
        launches[name] += n
    log(f"[time] door phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    fam_launches, fam_rows = families_phase(dev, args.seed, card)
    for name, n in fam_launches.items():
        launches[name] += n
    for name, rows in fam_rows.items():
        kernels[name]["families"] = rows
    log(f"[time] families phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mem_launches, mem_rows = memory_phase(dev, args.seed, card)
    for name, n in mem_launches.items():
        launches[name] += n
    for name, rows in mem_rows.items():
        kernels[name]["memory"] = rows
    kernels["flash_attention"]["launches_by_phase"][
        "memory (VLM and Whisper: encode, static engines, recomputes)"] = \
        mem_launches["flash_attention"]
    log(f"[time] memory phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pair = rank_pair(args.seed, card)
    log(f"[time] phases 14-17 on the two ranks {time.perf_counter() - t0:.1f}s"
        f" (" + ", ".join(f"{k} {v[0]['t_part']:.1f}" for k, v in
                          pair.items()) + ")")
    t0 = time.perf_counter()
    for name, n in sharded_phase(dev, args.seed, card,
                                 pair["shard"]).items():
        launches[name] += n
    log(f"[time] sharded phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plan_launches, plan_rows = serve_plan_phase(dev, args.seed, card,
                                                pair["serve"])
    for name, n in plan_launches.items():
        launches[name] += n
    for name, row in plan_rows.items():
        kernels[name]["serve_plan"] = [row]
    log(f"[time] serve plan phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    splan_launches, splan_rows = static_plan_phase(dev, args.seed, card,
                                                   pair["static"])
    for name, n in splan_launches.items():
        launches[name] += n
    for name, rows in splan_rows.items():
        kernels[name]["static_plan"] = rows
    kernels["flash_attention"]["launches_by_phase"][
        "static plan (16: 1x1 NCCL, 1x2 and long 2x1 over gloo, families, "
        "door)"] = splan_launches.get("flash_attention", 0)
    log(f"[time] static plan phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mplan_launches, mplan_rows = moe_plan_phase(dev, args.seed, card,
                                                pair["moe"])
    for name, n in mplan_launches.items():
        launches[name] += n
    for name, row in mplan_rows.items():
        kernels[name]["moe_plan"] = [row]
    kernels["flash_attention"]["launches_by_phase"][
        "moe plan (17: scout's and jamba's static engines and jamba's "
        "recompute on 1x2)"] = mplan_launches.get("flash_attention", 0)
    log(f"[moe-plan] phase 17 launches {mplan_launches}")
    log(f"[time] moe plan phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    analysis_phase(twin)
    log(f"[time] analysis phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    small = small_models_phase(dev, args.seed, card)
    for name, n in small.items():
        launches[name] += n
    kernels["flash_attention"]["launches_by_phase"][
        "small models (19: bench-lm's static prefills)"] = \
        small["flash_attention"]
    log(f"[small] phase 19 launches {small}")
    log(f"[time] small models phase {time.perf_counter() - t0:.1f}s")
    log("[launches] float32 bodies on the main path (the windows counts() "
        "reads, both rank processes included): " + ", ".join(
            f"{kernels[k]['name_f32']} {n} of {launches[k]} {k} launches"
            for k, n in F32_TALLY.items())
        + "; a wrapper call counts once, and a float32 ssd_scan call runs "
          "3 kernels (2 with one chunk: no step B)")
    for name, row in kernels.items():
        row["launches"] = launches[name]
        if name in F32_TALLY:
            row["launches_f32"] = F32_TALLY[name]
        row["kernel_ms"], row["twin_ms"] = row["ms"], row["plain_ms"]
        row["card"] = card
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
