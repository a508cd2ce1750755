#!/usr/bin/env python3
"""Drive the PyTorch port (``distkeras_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the hand-written kernels from ``distkeras_tpu_torch/csrc``;
3. the flash-attention forward kernel against its plain PyTorch
   version at the serving path's shapes and the training shapes (causal
   B4 H16 S2048 D64; B2 H8 S2048 D128) and, with no causal mask, ViT-S/16's
   (B32 H6 S196) and B1 H16 S2048, in bf16: a bitwise repeat, device
   times (CUDA-graph replays), TFLOP/s and the bound's share, with SDPA
   as yardstick;
4. the paged decode kernel against its plain version, with times from
   CUDA-graph replays, a bitwise repeat and SDPA over pre-gathered K/V
   (the page gather left out) as yardstick;
5. the serving path end to end: the 218M transformer LM (d_model 1024,
   16 heads, 12 layers, vocab 32768, bf16, random weights from a seed)
   behind a paged ``ServingEngine`` serving six requests (a shared
   512-token template, a 1500-token prompt, a sampled request, greedy
   ones), with both kernels' launch counts read around that run only;
   then one prompt's logits on the card against the plain path on the
   CPU in float32 at the same weights;
6. the flash-attention backward kernels (dq, dk/dv) against their plain
   version in bf16: the training shape (causal B4 H16 S2048 D64), a
   256-position window, grouped queries (4 kv heads x 4), a ragged
   S=1000 and the training length at head_dim 128 (causal B2 H8 S2048
   D128), and with no causal mask ViT-S/16's training shape (B32 H6
   S196) and B1 H16 S2048 (timed by CUDA-graph replay, SDPA's backward
   too); a bitwise repeat, times, TFLOP/s and the bound's share;
7. the training path end to end: the same 218M LM (12 layers, bf16
   compute over float32 weights, seed 0) trained by ``SingleTrainer``
   with adam for two epochs of 32 rows x 2048 tokens (16 steps of 4
   rows), with the three training kernels' launch counts read around
   that run only; then the steady step's time, tokens/s, peak memory
   and a ``torch.profiler`` list of its device time;
7b. the three flash kernels with packed-sequence segment ids against
   their plain versions: the training shape (causal B4 H16 S2048 D64
   bf16) on phase 7c's first batch of packed ids, float32 B1 S512, GQA
   4x4, a 256-position window over the ids, unsorted interleaved ids
   with a -1 tail (S1000) and all-equal ids (bitwise equal to no ids);
   kernel ms with and without ids, bounds from the admitted pairs, the
   plain versions' ms and ``scaled_dot_product_attention`` with the
   boolean ``[B, 1, S, S]`` mask (forward, forward+backward) as
   yardstick;
7c. packed-sequence training: on a fresh seed-0 218M LM, documents of
   seeded lengths 64-1536 (each tiles one of 16 seeded 64-token
   patterns) packed greedily into
   32 rows of 2048 (pad: token 0, id -1, label -1), one epoch at batch 4
   (8 steps) of the hand-written step (``module.apply(params, x,
   segment_ids=)``, the masked loss, adam): finite falling loss,
   exactly 12 launches of each flash kernel a step; step ms, real
   tokens/s, pad share, peak memory, the same rows without ids; one step
   with ``Remat(policy="nothing")`` bitwise equal to the bare one (24
   ``flash_fwd`` launches); then at 2 layers, B1 S512 (four documents and
   a pad tail) the card's gradients (bf16, float32) against the CPU
   float32 plain path and cross-segment isolation in float32 (later
   logits bitwise unchanged by the earlier segment's tokens, unless the
   ids are dropped);
8. one gradient on the card (bf16 and float32) against the plain path
   on the CPU in float32, at the same widths with 2 layers, B1 S512;
9. the slab decode-attention kernel (K2, float and int8 variants)
   against its plain version: generate's shape (B4 Hkv16 G1 D64,
   L=1152, t=1151, bf16), GQA 4x4, a 256-position window, a short cache
   (L=40), an int8 cache and an int4 cache (int8 bytes), with a bitwise
   repeat, the CUDA kernels one call launches (a captured graph's nodes),
   device times from CUDA-graph replays warm (one cache, in L2) and cold
   (replays walking copies of the cache that exceed the 50 MB L2, as
   generate()'s twelve layers do), GB/s, the bound's share, the eager
   call's time and the SDPA yardstick timed the same two ways;
10. ``generate()`` end to end on the same 218M LM (bf16, seed 0): B4 x
    1024-token prompts, 128 new greedy tokens, with the bf16 cache and
    the int8 cache; prefill ms, decode ms per step and tokens/s, the
    launch counts of each call (12 ``flash_fwd`` per prefill, 12 x 127
    K2 launches of the cache's variant), the call's peak memory; then
    one decode step's logits on the card (bf16 cache, int8 cache,
    float32) against the plain path on the CPU in float32 at the same
    weights and cache contents, and a ``torch.profiler`` list of a
    decode step's device time, CUDA kernel launches and K2's share;
11. the paged kernel's int8 and int4 variants against their plain
    version at phase 4's shapes (page_len 16), with graph-replay times,
    a bitwise repeat and bounds;
12. the paged ``ServingEngine`` with ``cache_dtype="int8"`` and
    ``"int4"`` on phase 5's workload: streams finish, the quantized
    paged kernel runs and the float one does not;
13. the paged kernel's tree ancestor mask (K3-anc) in its bf16, int8
    and int4 page variants against its plain version at phase 4's
    shapes with W=9 random trees (16 kv heads, GQA 4x4, a 256-position
    window), a lower-triangular mask against the window-causal launch
    (bitwise), a bitwise repeat, device times from CUDA-graph replays,
    SDPA over pre-gathered K/V with the tree mask (bf16) and bounds;
14. speculative serving on the same fresh 218M LM: a self-draft
    (``DraftModel(model)``) linear (``spec_k=4``) and with trees
    (``spec_width=2``) on phase 5's workload, an n-gram draft on prompts
    repeating a 64-token motif, and n-gram trees with int8 and int4
    pages (two requests each); every stream finishes, each equals the
    plain engine's stream of the same request in the same run or parts
    from it only at a near-tie of the CPU float32 scores (within the
    bf16 logit error phases 5 and 10 measured), the self-draft runs
    accept more than half their drafts (trees: their path over their
    depth) in fewer iterations than tokens, and each run's kernel
    launches are counted around it.

15. the quantized matmul (K5, int8 and packed int4) against its plain
    version (``reference_matmul``) at the LM's matrices (wq, wo in its
    ``[h, e, d]`` layout, w1, w2, the head) and a ragged 1000 x 1000,
    M in (1, 4, 8, 72), bf16 activations, with graph-replay times,
    bounds and ``torch.matmul`` against the bf16 weight as yardstick
    (int8 also ``torch._weight_int8pack_mm`` on the same bytes, where
    this torch runs it on CUDA), and a bitwise repeat;
16. the fused sampling epilogue (K4, one launch on the raw logits)
    against its plain version at S 8 and 4, V 32768, float32 and bf16
    logits, mixed rows (greedy, top-k, top-p, both, k = 1, k >= V,
    p <= 0, +-0.0 logits at the k-th value, ties at the k-th value):
    equal tokens, or a counted row at the nucleus boundary; a bitwise
    repeat, CUDA kernels a call, ``sample_epilogue`` by graph replay
    warm and cold (the replays walk copies of the logits and the Gumbel
    field past the L2) and eager, GB/s and the bound's share;
17. the engine with quantized weights on phase 5's workload (the same
    fresh model): int8 with fused sampling, the same unfused (the
    streams must match), int4 over int4 pages, an n-gram tree with
    int8; K5 launches per decode step, K4 in the fused run, resident
    weight bytes against the bf16 engine's, peak memory, TTFT and
    decode tok/s; then decode-step logits on the card against the CPU
    float32 path over the same quantized trees, and phase 5's profile of
    an int8-weight decode step (K5's device time, launches a step);
18. ``generate(weights_dtype="int8")``: B4 x 1024-token prompts and 32
    greedy tokens, prefill and decode ms per step, exact K5 and K2
    launch counts;
19. the MoE expert up-projection with the token gather fused in (K6a)
    against its plain version (``gather_gemm1_reference``) on real
    dispatch plans (8 experts, top-2, d 1024, H 2048): a decode step
    (N 4), an n-gram verify (N 20), an 8-slot tree (N 72), a 256-token
    prefill chunk (C 80), a 2048-token prefill (C 640) and the training
    shape (N 8192, C 2048), a routing that leaves experts empty, one
    that sends every first choice to one expert, a ragged d = H = 1000
    and widths and capacities off the tensor-core kernel's tiles, in
    bf16 (2e-2 max abs) and, for five of them, float32 (1e-4 relative);
    graph-replay times with the achieved TFLOP/s and the bound's share,
    bounds from the plan, the plain version's time, ``torch.baddbmm`` on
    a pre-gathered buffer as yardstick, and a bitwise repeat; in bf16
    also the launches the shapes did not choose (one or two warpgroups a
    block, the CUDA-core kernel), held and timed alike;
20. MoE serving end to end on the all-MoE LM of ``bench.py``
    ``bench_moe`` at ``LM_CFG`` widths (12 layers, 8 experts, top-2,
    expert hidden 2048, bf16, seed 0, dense dispatch; ~520M
    parameters) with phase 5's workload and pool: ``moe_decode=
    "dispatched"`` and ``"dense"``, then an n-gram tree on two motif
    prompts against a dense run of them; K6a launches exactly 12 per
    decode step and verify in the dispatched runs and never in the
    dense ones, every stream finishes, ``summary()["moe"]`` is set,
    with TTFT, decode tok/s, resident weights and peak memory from runs
    that carry no recorder; the MoE LM's prefill logits against the CPU
    float32 path; then each dispatched run teacher-forced along its
    dense run's streams: every ``decode_apply`` call against the dense
    layer on the same input and, wherever the expert sets match in
    every layer, each generated token's logits against the dense
    engine's, both at the bf16 tolerance; routing flips counted and
    printed, as are the free-running streams' partings;
21. the same weights with ``moe_dispatch="fused"``: one 256-token
    prefill launches K6a 12 times, its logits against the card's plain
    path; then one decode step's logits on the card (bf16 and float32,
    fused) against the CPU float32 dense path at 2 layers of the same
    widths; routing flips counted and printed;
22. the fused MoE block's backward kernels (K6b ``moe_bwd_dx``, K6c
    ``moe_bwd_dw1``) against their plain versions on real top-2 plans:
    the training shape (N 8192, C 2048, d 1024, H 2048), a 256-token
    batch, a routing that leaves six experts empty, one that sends every
    first choice to one expert, a ragged d = H = 1000 and widths and
    capacities off the kernels' tiles (``K6BC_CASES``), in bf16
    (dxr/dz/gy 2e-2, rowdot/dw1 1e-3, relative to the output's largest
    |value|) and, for five of them, float32 (1e-4); rows no slot won
    give exact zeros; a bitwise repeat; graph-replay times with the
    achieved TFLOP/s and the bound's share, plain times, bounds from the
    plan, ``torch.bmm`` on pre-gathered buffers as yardsticks;
23. MoE training end to end: ``SingleTrainer`` with adam on the 12-layer
    all-MoE LM in ``bench_moe``'s training configuration (fused
    dispatch, capacity factor 1.0, balance-loss weight 0.01, seed 0)
    over 16 rows of phase 7's data for two epochs (8 steps of 4 x 2048
    tokens): K6a, K6b, K6c, K1f, K1dq and K1dkv launch exactly 12 times
    per step, the loss is finite and falls; the balance-loss term; the
    steady step's time, tokens/s, peak memory, a ``torch.profiler`` list,
    each fused-block kernel's device time and that of the dispatch
    plan and of ``dw2`` (profiler ranges); then the same model's
    step with ``dispatch="tokens"`` (plain autograd and cuBLAS, no
    K6a/K6b/K6c launch) as a yardstick;
24. MoE gradients at 2 layers of the same widths (B1 S512, fused): the
    card's float32 gradients against the CPU float32 plain path (1e-3
    relative per leaf), the bf16 ones printed with both runs' routing
    flips; then the first MoE block's real bf16 input with its dispatch
    plan fixed: the fused block's forward and backward (K6a, K6b, K6c)
    against the card's plain versions on that plan (2e-2).

25. the zero-bubble loop: phase 5's workload and pool on the fresh
    218M LM through the synchronous loop (``overlap=False``), the
    pipelined one (``overlap=True``, the engine's default) and fused
    windows (``fuse_steps=4``): every stream finishes, a preemption and
    a prefix hit happen, the paged kernel launches exactly 12 times per
    decode step the engine launched (a window's steps and the step in
    flight past a stop included), the greedy streams equal the
    synchronous loop's or part at a near-tie of the CPU float32 scores
    (phase 14's rule), the sampled stream is equal; a steady-decode
    profile of each loop (wall, device busy and CUDA launches a step,
    ms blocked in the lagged fetch a step, the host's ms to issue a
    launch); one decode step and a 4-step window captured in a CUDA
    graph on static buffers, replay against the eager call bitwise in
    tokens and pages, with replay times; every launch of an engine with
    greedy and sampled requests over bf16, int8 and int4 pages, int8
    weights and fused sampling run under ``set_sync_debug_mode("error")``
    (no host sync); after phase 21 the same on phase 20's dispatched
    MoE engine (four greedy requests, K6a exactly 12 per decode step
    launched), and its launches free of host syncs.
26. JAX's threefry on the card: K7 (``csrc/prng.cu``) against its plain
    version at the serving sampler's Gumbel field (S8 V32768, a key a
    row), a decode step's split of 8 slot keys, a dropout mask (B4 S2048
    d1024 under one key) and raw bits (splits, bits and uniforms
    bitwise, the Gumbel field within ``prng.GUMBEL_ULPS``, the small
    cases against the CPU too), with graph-replay times and the bound;
    the CUDA kernels a sampled step's sampler launches (the per-row loop
    the port ran before K7 against the keyed samplers); a sampled
    workload through the synchronous and the pipelined loop with the
    unfused and the fused sampler (equal streams per sampler, K7 exactly
    two launches a sampled decode step and two a sampled first token),
    both samplers' launches free of host syncs; then the engine's
    synchronous API under the pipelined loop: a deadline and a
    ``cancel`` mid-decode, ``run(on_degraded=)`` both ways, an
    ``hbm_budget`` engine's pages and real bytes against the budget, and
    ``decode_kernel="off"`` (no paged kernel) against the default (12 a
    decode step).
27. the distributed-SGD family with its workers stacked on the card
    (``parallel.engine``): DOWNPOUR on the full 218M LM, 4 workers of
    batch 2, window 2 amortized, two epochs of phase 7's data (the loss
    falls, K1f/K1dq/K1dkv exactly 12 launches per worker step, K7 one
    per worker step plus the workers' key split, exactly ceil(S / K)
    commits an epoch, a finite center; worker steps/s, peak memory, one
    commit's device ms by CUDA events); at 2 layers of the same widths
    AEASGD on the per-step path, ADAG, DynSGD with per-worker windows,
    AveragingTrainer, a 2-member EnsembleTrainer and a 2-worker
    HostAsyncTrainer (DOWNPOUR over the in-process server), each with
    its launch counts and a falling loss; one engine epoch of each
    algorithm under ``set_sync_debug_mode("error")`` (no host sync).
28. the BASELINE vision models with BatchNorm state (``vision_phase``):
    ResNet-50 at full width (224x224x3, 1000 classes, bf16, 25,557,032
    parameters) built on the card (its K7 draws counted); a B8 forward
    against the CPU float32 path on the same weights and state (logits
    within 5e-2); ``ModelPredictor`` over 64 seeded images equal to
    ``Model.predict``; ``SingleTrainer`` for 8 steps of B32 over 256
    seeded images (the loss falls, the BN statistics move and stay
    finite; images/s, a warm step's ms, the device's busy share and where
    a step's device time goes by profiler, peak memory); AEASGD
    (BASELINE config 3) over 4 stacked workers of B8 for one epoch (the
    loss falls, the commit count is exact, the extracted state is the
    workers' mean); ADAG on LeNet-5 at 32x32x3 over 4 workers (config 2);
    one engine epoch of ``resnet18_thin`` under
    ``set_sync_debug_mode("error")`` (the in-place state write makes no
    host sync).
29. the rest of the zoo (``zoo_phase``): ViT-S/16 at its published
    width (``zoo.vit()``: 224x224x3, patch 16, d_model 384, 6 heads, 12
    layers, 1000 classes, bf16) built on the card (K7 launches equal to
    a meta-device rehearsal's draws), B8 eval logits against the CPU
    float32 path (5e-2), exactly 12 ``flash_fwd`` an eval forward,
    ``SingleTrainer`` with adam for 8 steps of B32 over phase 28's images
    (the loss falls; exactly 12 K1f, 12 K1dq and 12 K1dkv a step, the
    attention without the causal mask), a profiled warm step (images/s,
    launches, busy share, each flash kernel's device ms, peak memory);
    the trained ViT saved and loaded on the card (logits bitwise), saved
    quantized and loaded as a ``QuantizedModel`` (against the CPU float32
    path over the same dequantized weights, 5e-2); a 2-layer ViT's card
    gradients against the CPU's (float32 1e-3, bf16 5e-2); MobileNet-v1
    1.0 at 224x224x3 (B8 logits against the CPU, 4 ``SingleTrainer``
    steps of B32 with falling loss and moving BN statistics, a profiled
    step); BASELINE config 5, ``bilstm_classifier(64, 2)`` float32 over
    1,000 seeded rows of 200 x 300 through ``ModelPredictor`` at B128
    (bitwise ``Model.predict``, 1e-4 of the CPU path, rows/s, the CUDA
    launches of a batch, cuDNN's ``nn.LSTM`` as yardstick); a
    ``transformer_lm`` file written on the CPU loaded on the card with the
    writer's greedy tokens.
30. the engine's other layouts (``slab_phase``, ``offload_phase``,
    ``moe_wq_phase``): the slab pool, host KV offload, MoE experts under
    int8/int4 weights (the all-MoE LM at ``MOE_WQ_LAYERS`` layers).
31. the rest of the Trainer surface (``trainer_surface_phase``): on
    phase 28's LeNet-5, ``EarlyStopping(restore_best_weights=True)``,
    ``ModelCheckpoint`` (the file loads back on the card), ``CSVLogger``,
    ``TerminateOnNaN`` and ``profile_dir`` in one run, ``EMAWeights``,
    class weights, label smoothing, precision/recall/f1/auc card against
    CPU (1e-3), a class-weighted run card against CPU, and
    ``StreamingPredictor`` against ``ModelPredictor``; then on the 218M LM
    at ``LM_CFG`` widths with phase 7's data: 8 steps with
    ``fused_vocab_head=True`` and 8 without (losses and the head's
    gradient within 5e-2, each head's peak memory and warm step, the
    loss's device ms); at ``RESUME_LAYERS`` blocks, 2 epochs with
    ``checkpoint_dir`` against the same
    run preempted after epoch 0 and resumed by a fresh trainer (the final
    carry bitwise), and with ``checkpoint_async=True`` (save() ms against
    the writes' seconds, a checkpoint's bytes); the embedding and block 0
    frozen for 4 steps (bitwise unchanged, the rest moved); 4 npz shards
    through the prefetcher against the in-memory epoch (losses bitwise).
    Every LM run launches exactly one of each flash kernel a block and
    one K7 a step.
32. observability and resilience (``obs_phase``): the 218M LM at
    ``LM_CFG`` behind the default engine with the tracer, the flight
    recorder, ``[ttft_p99, tpot_p99, availability]`` SLOs and a time
    series on, 16 requests (8 greedy, 8 sampled with top-k/top-p, fused
    sampling), against the same workload under ``obs.disable()``,
    interleaved off/on/on/off: the same K1f, K3, K4 and K7 launches, the
    same streams, every timeline's phases partitioning its latency, the
    Chrome trace and the Prometheus text parsing, ``health()`` with its
    SLO and telemetry keys, and the wall per engine step with obs off and
    on; every launch and every obs hook of an obs-on engine under
    ``set_sync_debug_mode("error")``; ``serving.prefill`` armed nth=3:
    exactly that request ends CANCELLED with an ``InjectedFault``, every
    other stream equal to the unfaulted run's, the recorder's dump
    written; then ``SingleTrainer`` at ``LM_CFG`` widths cut to
    ``OBS_TRAIN_LAYERS`` layers under ``TrainingSupervisor`` with a
    ``TrainingTape``, ``train.epoch`` armed nth=2: the resumed run's
    final carry (params, adam state, key) bitwise the unfaulted run's,
    the restart's cost, and the tape's examples/s, data wait, goodput and
    MFU against the card's bf16 peak;
33. the serving tier (``router_phase``): engines as phase 32's, each
    with its own pool of ``ROUTER_PAGES`` pages, on the 218M LM. (a)
    phase 32's 16 requests through one engine and through a ``Router``
    with one prefill and two decode replicas (``prefix_affinity``):
    every stream the engine's apart from admitted near-ties, 16
    handoffs, K1f exactly twice the engine's 192; the handoff's host ms
    and the fleet step's host ms outside the engines; (b)
    ``Router.submit``, ``PrefixAffinity.rank``, both controllers'
    ``tick`` and a key replay under ``set_sync_debug_mode("error")``,
    and ``transfer_out`` + ``transfer_in`` of a live stream after the
    pipeline drain; (c) on the LM at ``ROUTER_REPLAY_LAYERS`` blocks,
    the JAX scenarios' traces at serving lengths
    (prompt median 128, max 480; output median 32, max 64; 128-token
    templates): the diurnal trace through a two-replica fleet and
    through one engine, and the flash-crowd trace with its scripted
    ``replica.die`` through an autoscaled fleet, twice: identical
    outcomes and reports, every failed-over sampled stream's replayed
    key its dead slot's key mirror byte for byte, the dead and the
    retired engines' memory freed; per-phase wall, steps, tokens/s,
    sheds and TTFT/TPOT percentiles.
34. the data plane and job deployment (``data_phase``): the host data
    library built (``native.native_status()``); (a) BASELINE config 4 at
    the Criteo schema (``CRITEO_ROWS`` seeded rows: the counts a
    tab-separated file read by ``Dataset.from_csv`` with the default
    ``sep=","``, 26 categorical columns joined from ``from_iterable``,
    ``log1p`` + ``MinMaxTransformer``, ``HashingTransformer(4096)``,
    ``VectorAssemblerTransformer``, the native shuffle), each stage's
    host seconds, the epoch permutation's GB/s through ``native.gather``
    against numpy's, DOWNPOUR over 4 stacked workers of
    ``zoo.wide_and_deep(4096, (256, 128))`` for 2 epochs (worker steps/s,
    rows/s, a warm stacked step's wall and busy share, peak memory),
    ``ModelPredictor`` rows/s, accuracy, macro-F1 and AUC; (b) the 218M
    LM trained by ``SingleTrainer`` on 16 of phase 7's rows taken by
    ``from_torch`` from a ``DataLoader``, losses bitwise the same rows'
    through ``Dataset.from_arrays`` (12 launches of each flash kernel
    and one K7 a step); (c) a ``Punchcard`` job of two processes on
    gloo, each training on the card (equal digests), a wrong secret
    refused, a job retried once; (d) the four ported examples.
35. the examples' head dims and the ten one-card examples
    (``examples_and_small_dims_phase``): (a) at head dims 8, 12 and 16,
    each at the shapes of the example whose model gives it
    (``SMALL_DIM_SHAPES``), K1f, K1dq and K1dkv (causal, the packed
    example's window and ids), K2 and K2-q8 over generate()'s cache, K3
    over float, int8 and int4 pages and K3-anc over a W=4 tree: each
    against its plain version, a bitwise repeat for the decode kernels,
    graph-replay times, the bound and SDPA as yardstick; (b) the ten
    examples (``EXAMPLES``) in this process on the card, each with its
    JAX test's checks and the launch counts of its run: exact for the
    backward kernels (two layers a training step) and for K2 (two
    layers a generated token past the first, each generate() call), at
    least one for the kernels whose count the schedule decides.
36. sequence parallelism over a world of four processes on the card
    (``seq_parallel_phase``): a ring hop's kernels, ring and Ulysses
    attention against single-process flash attention, the 218M LM over
    ``sp``, and ``long_context_serving``.
37. SPMD training over a world of four processes on the card
    (``spmd_phase``): (a) the 218M LM under ``SPMDTrainer`` over
    ``{"workers": 2, "tp": 2}`` (Megatron heads and hidden units over
    ``tp``), B8 x 512, 4 adam steps, against one process at
    ``SPMD_REL_TOL``, exactly 12 launches of each flash kernel a step on
    every rank, each rank's step ms and its staged gradient sum's ms; a
    sharded save after epoch 0 and a resume bitwise the uninterrupted
    run; (b) the same with FSDP over ``{"workers": 4}``; (c)
    ``large_model_spmd`` (8 processes) and ``imagenet_resnet_spmd`` (4)
    with their JAX tests' checks. Phase 25's loop profiles are halved
    (``LOOP_STEPS``) to keep the script inside its time limit.

Every serving phase runs the engine's default loop, ``overlap=True``;
phase 20's teacher-forced runs use the synchronous one. Weights are
JAX's ``Model.build`` draws from ``PRNGKey(0)``, made on the card (K7) and
moved where a phase needs them on the CPU. The line before the last is
one JSON object with every kernel's numbers (eighteen kernels); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_tpu_torch import kernels, obs
from distkeras_tpu_torch import data as port_data
from distkeras_tpu_torch.data import (Dataset, LabelIndexTransformer,
                                      ShardedDataset, native)
from distkeras_tpu_torch.deploy import (Job, JobSpec, Punchcard,
                                        PunchcardClient)
from distkeras_tpu_torch.inference import (AccuracyEvaluator, Evaluator,
                                           ModelPredictor,
                                           StreamingPredictor)
from distkeras_tpu_torch.models import (Model, Sequential,
                                        collect_aux_losses, zoo)
from distkeras_tpu_torch.models.attention import TransformerBlock
from distkeras_tpu_torch.models.blocks import Remat
from distkeras_tpu_torch.models.core import eval_mode
from distkeras_tpu_torch.models.moe import MoE, _dispatch_plan
from distkeras_tpu_torch.obs import recorder as obs_recorder
from distkeras_tpu_torch.obs.report import build_report
from distkeras_tpu_torch.obs.report import to_json as report_to_json
from distkeras_tpu_torch.obs.slo import availability, tpot_p99, ttft_p99
from distkeras_tpu_torch.obs.tape import BF16_PEAK_FLOPS, TrainingTape
from distkeras_tpu_torch.models.decoding import (CACHE_PLANES,
                                                 _decode_block_of,
                                                 _generate_params,
                                                 _masked_logits_vec,
                                                 _moe_params, _sample_vec,
                                                 _quantize_kv, decode_step,
                                                 decode_fused_slots,
                                                 decode_step_slots,
                                                 decode_step_slots_paged,
                                                 fuse_qkv_params, init_cache,
                                                 pack_int4, prefill,
                                                 serving_params)
from distkeras_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference, valid_range)
from distkeras_tpu_torch.ops.flash_attention import (
    attention_delta, flash_attention, flash_backward_reference,
    flash_forward, flash_forward_reference, launch_dkv, launch_dq)
from distkeras_tpu_torch.ops.moe_kernels import (
    bwd_dw1, bwd_dw1_reference, bwd_dx, bwd_dx_reference, fused_moe_apply,
    gather_gemm1, gather_gemm1_reference, gemm1_plan, row_gates,
    src_tokens)
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops import ring_attention as ring_module
from distkeras_tpu_torch.ops.losses import (
    fused_linear_cross_entropy, get_loss,
    sparse_categorical_crossentropy_from_logits, with_class_weight,
    with_label_smoothing)
from distkeras_tpu_torch.ops.metrics import auc, f1, precision, recall
from distkeras_tpu_torch.ops.optimizers import (adam, apply_updates,
                                                get_optimizer)
from distkeras_tpu_torch.ops.paged_attention import (
    gather_pages, paged_decode_attention, paged_decode_attention_reference,
    window_valid_mask)
from distkeras_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                  quantize_params_tree,
                                                  quantize_weight,
                                                  reference_matmul)
from distkeras_tpu_torch.ops.sampling import (MAX_BOUNDARY_PARTINGS,
                                              boundary_partings, gumbel_noise,
                                              sample_epilogue,
                                              sample_epilogue_reference,
                                              sample_tokens)
from distkeras_tpu_torch.parallel import (DOWNPOUR, SingleTrainer,
                                          TrainCarry,
                                          make_train_step, shard_epoch_data,
                                          value_and_grad)
from distkeras_tpu_torch.parallel.engine import (
    AdagAlgo, AveragingAlgo, DistributedEngine, DownpourAlgo, DynSGDAlgo,
    ElasticAlgo, EngineConfig, WorkerStack)
from distkeras_tpu_torch.parallel import collectives
from distkeras_tpu_torch.parallel.launch import World
from distkeras_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from distkeras_tpu_torch.parallel.worker import _fused_head_parts
from distkeras_tpu_torch.ops.ring_attention import EMPTY_LSE, ring_attention
from distkeras_tpu_torch.ops.ring_attention import merge as ring_merge
from distkeras_tpu_torch.ops.ulysses import ulysses_attention
from distkeras_tpu_torch.resilience import TrainingSupervisor, faults
from distkeras_tpu_torch.serving import (AutoscaleController, DraftModel,
                                         EngineReplica, KVPool, NgramDraft,
                                         PagedKVPool, RequestState, Router,
                                         ServingEngine, SLOBurnController,
                                         diurnal_burst_scenario,
                                         flash_crowd_chaos_scenario, replay,
                                         synthesize, tree_ancestors)
from distkeras_tpu_torch.serving.router.router import _replay_key
from distkeras_tpu_torch.utils.callbacks import (CSVLogger, EarlyStopping,
                                                 EMAWeights, LambdaCallback,
                                                 ModelCheckpoint,
                                                 TerminateOnNaN)
from distkeras_tpu_torch.utils.checkpoint import CheckpointManager
from distkeras_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)

#: the LM the JAX package benchmarks (bench.py LM_CFG), at full depth
LM_CFG = dict(vocab=32768, d_model=1024, num_heads=16, num_layers=12,
              mlp_ratio=4)
#: published H100 SXM peaks (NVIDIA data sheet, dense, 700 W); the bf16
#: one is the training tape's (``obs.tape.BF16_PEAK_FLOPS``)
PEAK_BF16_FLOPS = dict(BF16_PEAK_FLOPS)["h100"]
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
#: bf16 attention output against float32 math: output rounding (2^-8
#: relative) of O(1) values plus the bf16-rounded probabilities
KERNEL_BF16_TOL = 2e-2
#: the log-sum-exp is float32 math on both sides; only the order of the
#: row sums differs
LSE_TOL = 1e-3
#: int8/int4 caches: float32 math on both sides (dequantized values up
#: to ~4), only the summation order differs
KERNEL_Q_TOL = 2e-4

SEED = 0
NEW_TOKENS = 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events around the loop, after ``warmup`` calls)."""
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


def graph_ms(fn, iters: int = 50) -> float:
    """Device time of ``fn`` per call: ``iters`` calls captured in one
    CUDA graph and replayed between CUDA events, so the host's per-call
    cost (which exceeds a small decode kernel's device time) stays out
    of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def _admitted_pairs(sq: int, sk: int, causal: bool, window) -> int:
    if not causal:
        return sq * sk
    i = np.arange(sq)
    reach = i + 1 if window is None else np.minimum(i + 1, window)
    return int(reach.sum())


# --- phase 3: flash-attention forward --------------------------------------


def flash_cases(dev):
    """The serving path's shapes: a 1024-position causal prompt, a ragged one,
    a sliding window, and the chunked-prefill prefix pass (GQA folded
    into the rows: [B*Hkv, 1, G*256, 64] queries on a 1024-key prefix);
    then the training path's (B4 S2048), the training length at
    head_dim 128 (B2 H8), and square attention with no causal mask:
    ViT-S/16's (B32 H6 S196, ragged against the 64-row tiles) and a
    long one (B1 H16 S2048)."""
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, torch.bfloat16)

    h, d = 16, 64
    return [
        ("causal S=1024", dict(q=rnd(1, 1024, h, d), k=rnd(1, 1024, h, d),
                               v=rnd(1, 1024, h, d), causal=True,
                               window=None, layout="bshd")),
        ("causal ragged S=1000", dict(q=rnd(1, 1000, h, d),
                                      k=rnd(1, 1000, h, d),
                                      v=rnd(1, 1000, h, d), causal=True,
                                      window=None, layout="bshd")),
        ("window=256 S=1024", dict(q=rnd(1, 1024, h, d),
                                   k=rnd(1, 1024, h, d),
                                   v=rnd(1, 1024, h, d), causal=True,
                                   window=256, layout="bshd")),
        ("prefix [16,1,256,64] x 1024 keys",
         dict(q=rnd(16, 1, 256, d), k=rnd(16, 1, 1024, d),
              v=rnd(16, 1, 1024, d), causal=False, window=None,
              layout="bhsd")),
        ("causal B4 S=2048 (training)",
         dict(q=rnd(4, 2048, h, d), k=rnd(4, 2048, h, d),
              v=rnd(4, 2048, h, d), causal=True, window=None,
              layout="bshd")),
        ("causal B2 H8 S=2048 D128 (training)",
         dict(q=rnd(2, 2048, 8, 128), k=rnd(2, 2048, 8, 128),
              v=rnd(2, 2048, 8, 128), causal=True, window=None,
              layout="bshd")),
        ("non-causal B32 H6 S=196 (ViT-S/16)",
         dict(q=rnd(32, 196, 6, d), k=rnd(32, 196, 6, d),
              v=rnd(32, 196, 6, d), causal=False, window=None,
              layout="bshd")),
        ("non-causal B1 H16 S=2048",
         dict(q=rnd(1, 2048, h, d), k=rnd(1, 2048, h, d),
              v=rnd(1, 2048, h, d), causal=False, window=None,
              layout="bshd")),
    ]


def _sdpa(c):
    """One PyTorch call computing the same attention (yardstick only;
    the port never calls it)."""
    t = (lambda x: x.transpose(1, 2)) if c["layout"] == "bshd" \
        else (lambda x: x)
    q, k, v = t(c["q"]), t(c["k"]), t(c["v"])
    mask = None
    if c["window"] is not None:
        i = torch.arange(q.shape[2], device=q.device)
        mask = (i[None, :] <= i[:, None]) & \
            (i[None, :] > i[:, None] - c["window"])
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return F.scaled_dot_product_attention(q, k, v, is_causal=c["causal"])


def flash_phase(dev):
    """Each case of ``flash_cases``: the kernel against its plain version,
    a bitwise repeat, kernel and SDPA device times (CUDA-graph replays:
    the small serving shapes take less device time than a call's host
    work), achieved TFLOP/s and the bound's share."""
    rows = []
    for name, c in flash_cases(dev):
        kw = dict(scale=c["q"].shape[-1] ** -0.5, causal=c["causal"],
                  window=c["window"], layout=c["layout"])
        qkv = (c["q"], c["k"], c["v"])
        out, lse = flash_forward(*qkv, **kw)
        again, lse_again = flash_forward(*qkv, **kw)
        torch.cuda.synchronize()
        repeat = torch.equal(out, again) and torch.equal(lse, lse_again)
        ref, ref_lse = flash_forward_reference(*qkv, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ms = graph_ms(lambda: flash_forward(*qkv, **kw))
        plain_ms = time_ms(lambda: flash_forward_reference(*qkv, **kw),
                           iters=5)
        lib_ms = graph_ms(lambda: _sdpa(c))
        heads_major = [x if c["layout"] == "bhsd" else x.transpose(1, 2)
                       for x in qkv]
        b, h, sq, d = heads_major[0].shape
        sk = heads_major[1].shape[2]
        flops = 4.0 * b * h * _admitted_pairs(sq, sk, c["causal"],
                                              c["window"]) * d
        nbytes = 2 * (2 * c["q"].numel() + c["k"].numel()
                      + c["v"].numel()) + 4 * lse.numel()
        bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        ok = err <= KERNEL_BF16_TOL and lse_err <= LSE_TOL and repeat
        print(f"flash_fwd {name}: max_abs_err {err:.3e} (tol "
              f"{KERNEL_BF16_TOL}), lse err {lse_err:.3e} (tol {LSE_TOL}); "
              f"kernel {ms:.4f} ms ({flops / (ms * 1e9):.1f} TFLOP/s, "
              f"{bms / ms:.1%} of the bound {bms:.4f} ms, {by}), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; bitwise repeat "
              f"{repeat}", flush=True)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version on {name}, or with itself "
                                 f"(bitwise repeat {repeat})")
        rows.append(dict(name=name, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by))
    return rows


# --- phase 4: paged decode ----------------------------------------------------


#: phase 4's cases: (name, kv heads, query group, window rows W, SWA)
PAGED_SPECS = (("W=1 Hkv=16", 16, 1, 1, None), ("W=4 Hkv=16", 16, 1, 4, None),
               ("GQA Hkv=4 G=4", 4, 4, 1, None),
               ("window=256", 16, 1, 1, 256))
#: phase 13's: the tree verify window of spec_k=4, spec_width=2 (W=9)
ANC_SPECS = (("W=9 tree Hkv=16", 16, 1, 9, None),
             ("GQA Hkv=4 G=4 W=9 tree", 4, 4, 9, None),
             ("window=256 W=9 tree", 16, 1, 9, 256))


def random_trees(rs, s, w):
    """``[s, w]`` parent vectors of random trees, each with every node
    used (the engine's trees number their used nodes first)."""
    parents = np.full((s, w), -1, np.int64)
    for i in range(s):
        for j in range(1, w):
            parents[i, j] = rs.randint(0, j)
    return parents


def paged_cases(dev, bits=None, specs=PAGED_SPECS, tree=False):
    """Eight slots with contexts up to 2048 (page_len 16, D 64, bf16
    pages; with ``bits`` 8 or 4 the same pages quantized, int4 packed)
    in a scrambled physical order, sentinel entries past each slot's
    last page: W=1 and W=4 over 16 kv heads, a GQA case (4 kv heads x 4
    queries), and a 256-position sliding window; with ``tree`` the W=9
    cases of ``ANC_SPECS`` with a random tree (``anc``) per slot."""
    rs = np.random.RandomState(SEED)
    page_len, p_max, s = 16, 128, 8
    t = np.array([2040, 1800, 1500, 1024, 777, 512, 300, 64], np.int32)
    cases = []
    for name, hkv, g, w, window in specs:
        n_live = [min(p_max, -(-(int(ti) + w) // page_len)) for ti in t]
        n_pages = sum(n_live) + 16
        perm = rs.permutation(n_pages)
        table = np.full((s, p_max), n_pages, np.int32)
        used = 0
        for i, n in enumerate(n_live):
            table[i, :n] = perm[used:used + n]
            used += n
        kp = torch.from_numpy(rs.randn(n_pages, hkv, page_len, 64)
                              .astype(np.float32)).to(dev)
        vp = torch.from_numpy(rs.randn(n_pages, hkv, page_len, 64)
                              .astype(np.float32)).to(dev)
        q = torch.from_numpy(rs.randn(s, w, hkv, g, 64)
                             .astype(np.float32)).to(dev)
        c = dict(q=q, t=torch.from_numpy(t).to(dev),
                 table=torch.from_numpy(table).to(dev), window=window)
        if tree:
            c["anc"] = torch.from_numpy(
                tree_ancestors(random_trees(rs, s, w))[1]).to(dev)
        if bits is None:
            c.update(k=kp.to(torch.bfloat16), v=vp.to(torch.bfloat16))
        else:
            (kq, ks), (vq, vs) = (_quantize_kv(x, bits) for x in (kp, vp))
            if bits == 4:
                kq, vq = pack_int4(kq), pack_int4(vq)
            c.update(k=kq, v=vq, k_scale=ks, v_scale=vs)
        cases.append((name, c, t, w, page_len))
    return cases


def _paged_work(c, t, w, page_len, bits):
    """What one paged call must do on this run's data: the bytes of the
    live pages it reads (K and V, scale planes for quantized pages) plus
    q in and out, and the operations of the (query row, position) pairs
    its masks admit (a tree row: the prefix inside its window plus its
    ancestors)."""
    s, _, hkv, g, d = c["q"].shape
    row_pos = t[:, None].astype(np.int64) + np.arange(w)[None, :]
    lo = np.zeros_like(row_pos) if c["window"] is None else \
        np.maximum(0, row_pos - c["window"] + 1)
    p_max = c["table"].shape[1]
    pages = int((np.minimum(row_pos.max(1), p_max * page_len - 1)
                 // page_len - lo.min(1) // page_len + 1).sum())
    if "anc" in c:
        anc = c["anc"].cpu().numpy()
        n_anc = anc.sum(axis=2)                               # [S, W]
        own = t[:, None] + n_anc - 1                          # t + depth
        lo_t = np.zeros_like(own) if c["window"] is None else \
            np.maximum(0, own - c["window"] + 1)
        pairs = int((np.maximum(0, t[:, None] - lo_t) + n_anc).sum())
    else:
        pairs = int((row_pos - lo + 1).sum())
    if bits is None:
        page_bytes = hkv * page_len * d * c["k"].element_size()
    else:
        page_bytes = hkv * page_len * (d * bits // 8 + 4)     # + scale
    nbytes = 2 * pages * page_bytes + 2 * c["q"].numel() * 4  # q in, out
    return 4.0 * hkv * g * d * pairs, nbytes, pages


def paged_phase(dev, bits=None):
    """Phase 4 (float pages) or, with ``bits``, phase 11 (int8 / int4)."""
    rows = []
    label = "paged_decode" if bits is None else f"paged_decode_q{bits}"
    tol = KERNEL_BF16_TOL if bits is None else KERNEL_Q_TOL
    for name, c, t, w, page_len in paged_cases(dev, bits):
        args = (c["q"], c["k"], c["v"], c["t"], c["table"])
        kw = dict(scale=64 ** -0.5, window=c["window"])
        if bits is not None:
            kw.update(k_scale=c["k_scale"], v_scale=c["v_scale"])
        before = kernels.launch_counts()[label]
        out = paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        if kernels.launch_counts()[label] != before + 1:
            raise AssertionError(f"{name} did not launch {label}")
        ref = paged_decode_attention_reference(*args, **kw)
        err = (out - ref).abs().max().item()
        same = torch.equal(out, paged_decode_attention(*args, **kw))
        ms = graph_ms(lambda: paged_decode_attention(*args, **kw))
        plain_ms = time_ms(
            lambda: paged_decode_attention_reference(*args, **kw), iters=5)
        lib_ms = None if bits is not None else _sdpa_paged_ms(c)
        flops, nbytes, pages = _paged_work(c, t, w, page_len, bits)
        bms, by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        lib = "" if lib_ms is None else \
            f", SDPA on pre-gathered K/V {lib_ms:.4f} ms (graph replay)"
        print(f"{label} {name}: max_abs_err {err:.3e} (tol {tol}); bitwise "
              f"repeat {same}; kernel {ms:.4f} ms (graph replay), "
              f"{nbytes / ms / 1e6:.0f} GB/s, {100 * bms / ms:.1f}% of the "
              f"bound; plain {plain_ms:.4f} ms (eager){lib}; bound "
              f"{bms:.4f} ms ({by}), {pages} live pages", flush=True)
        if not err <= tol:
            raise AssertionError(f"{label} disagrees with its plain "
                                 f"version on {name}")
        if not same:
            raise AssertionError(f"{label} is not bitwise repeatable on "
                                 f"{name}")
        rows.append(dict(name=name, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by))
    return rows


def _sdpa_paged_ms(c):
    """The float-page yardstick (never called by the port): SDPA over the
    slots' K/V gathered into contiguous ``[S, Hkv, P * page_len, D]``
    outside the timing, the W*G rows of a kv head as its queries, with
    the kernel's mask (window rows or tree, sliding window, sentinel
    pages): the paged kernel's function minus the page gather. Graph
    replay."""
    q, table = c["q"], c["table"]
    s, w, hkv, g, d = q.shape
    k, v = gather_pages(c["k"], table), gather_pages(c["v"], table)
    length = k.shape[2]
    page_len = length // table.shape[1]
    live = (table.long() < c["k"].shape[0]).repeat_interleave(page_len,
                                                              dim=1)
    valid = window_valid_mask(c["t"], w, length, c["window"],
                              c.get("anc")) & live[:, None, :]
    mask = valid[:, :, None, :].expand(s, w, g, length) \
        .reshape(s, 1, w * g, length)
    qq = q.permute(0, 2, 1, 3, 4).reshape(s, hkv, w * g, d).to(k.dtype)
    return graph_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=d ** -0.5))


# --- phase 13: the tree ancestor mask (K3-anc) --------------------------------

ANC_KERNELS = {None: "paged_decode_anc", 8: "paged_decode_q8_anc",
               4: "paged_decode_q4_anc"}


def anc_phase(dev, bits=None):
    """K3-anc in one page variant (bf16, int8 or int4 pages) at phase 4's
    shapes with W=9 random trees: against its plain version, a
    lower-triangular ``anc`` against the window-causal launch (bitwise),
    device times from CUDA-graph replays, bound."""
    rows = []
    label = ANC_KERNELS[bits]
    tol = KERNEL_BF16_TOL if bits is None else KERNEL_Q_TOL
    for name, c, t, w, page_len in paged_cases(dev, bits, ANC_SPECS,
                                               tree=True):
        args = (c["q"], c["k"], c["v"], c["t"], c["table"])
        kw = dict(scale=64 ** -0.5, window=c["window"])
        if bits is not None:
            kw.update(k_scale=c["k_scale"], v_scale=c["v_scale"])
        tkw = dict(kw, anc=c["anc"])
        before = kernels.launch_counts()[label]
        out = paged_decode_attention(*args, **tkw)
        torch.cuda.synchronize()
        if kernels.launch_counts()[label] != before + 1:
            raise AssertionError(f"{name} did not launch {label}")
        ref = paged_decode_attention_reference(*args, **tkw)
        err = (out - ref).abs().max().item()
        chain = torch.tril(torch.ones(w, w, dtype=torch.bool, device=dev)) \
            .expand(c["q"].shape[0], w, w).contiguous()
        same = torch.equal(paged_decode_attention(*args, **kw),
                           paged_decode_attention(*args, **kw, anc=chain))
        repeat = torch.equal(out, paged_decode_attention(*args, **tkw))
        ms = graph_ms(lambda: paged_decode_attention(*args, **tkw))
        plain_ms = time_ms(
            lambda: paged_decode_attention_reference(*args, **tkw), iters=5)
        lib_ms = None if bits is not None else _sdpa_paged_ms(c)
        flops, nbytes, pages = _paged_work(c, t, w, page_len, bits)
        bms, by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        lib = "" if lib_ms is None else \
            f", SDPA on pre-gathered K/V {lib_ms:.4f} ms (graph replay)"
        print(f"{label} {name}: max_abs_err {err:.3e} (tol {tol}); "
              f"lower-triangular anc == window-causal bitwise: {same}; "
              f"bitwise repeat {repeat}; kernel {ms:.4f} ms (graph replay), "
              f"{nbytes / ms / 1e6:.0f} GB/s, {100 * bms / ms:.1f}% of the "
              f"bound; plain {plain_ms:.4f} ms (eager){lib}; "
              f"bound {bms:.4f} ms ({by}), {pages} live pages", flush=True)
        if not repeat:
            raise AssertionError(f"{label} is not bitwise repeatable on "
                                 f"{name}")
        if not err <= tol:
            raise AssertionError(f"{label} disagrees with its plain "
                                 f"version on {name}")
        if not same:
            raise AssertionError(f"{label}: a lower-triangular anc differs "
                                 f"from the window-causal launch on {name}")
        rows.append(dict(name=name, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by))
    return rows


# --- phase 5: the serving path end to end ------------------------------------


def built_on_card(spec, device) -> Model:
    """``Model.build(spec, seed=SEED)`` with the weights drawn on the card
    (K7: one launch a leaf), then moved to ``device``: the uniform draws
    are bitwise the CPU plain version's, which takes about a minute for
    the 218M LM."""
    model = Model.build(spec, (16,), seed=SEED, device="cuda")
    return model if torch.device(device).type == "cuda" else \
        model.to(device)


def build_lm(device, *, num_layers=LM_CFG["num_layers"],
             d_model=LM_CFG["d_model"], num_heads=LM_CFG["num_heads"],
             vocab=LM_CFG["vocab"], dtype="bfloat16", **lm_kw):
    return built_on_card(
        zoo.transformer_lm(vocab, d_model=d_model, num_heads=num_heads,
                           num_layers=num_layers,
                           mlp_ratio=LM_CFG["mlp_ratio"], dtype=dtype,
                           **lm_kw),
        device)


def workload(vocab: int):
    """Six requests: two on one 512-token template (the prefix cache
    must hit), a 1500-token prompt (chunked prefill with the prefix
    pass), one sampled request, and greedy ones of mixed length."""
    rs = np.random.RandomState(SEED)
    tpl = rs.randint(0, vocab, 512)
    return [
        (np.concatenate([tpl, rs.randint(0, vocab, 40)]), {}),
        (np.concatenate([tpl, rs.randint(0, vocab, 70)]), {}),
        (rs.randint(0, vocab, 1500), {}),
        (rs.randint(0, vocab, 300),
         dict(temperature=0.8, top_k=40, top_p=0.9, seed=11)),
        (rs.randint(0, vocab, 100), {}),
        (rs.randint(0, vocab, 900), {}),
    ]


#: the kernels phase 5's run must launch (its sampled request's draws
#: are K7's)
SERVING_KERNELS = ("flash_fwd", "paged_decode", "prng")

#: pages of the pool: enough to admit the first four requests, too few
#: for all of them to grow through their 32 new tokens (so at least one
#: stream is preempted and resumed)
NUM_PAGES = 160


def serve(model, device, *, num_pages=NUM_PAGES, cache_dtype=None,
          requests=None, setup=None, **engine_kw):
    """Run a workload (default: ``workload``) through a paged engine
    (``cache_dtype`` None: the model's bf16, or ``"int8"``/``"int4"``
    pages; ``engine_kw`` e.g. a draft source), draining it through
    ``step()``; returns the engine, the request ids with their prompts,
    the outputs, a count of non-finite live logits seen and the number
    of engine iterations. ``setup(engine)``, if given, runs before the
    first submit."""
    bad = torch.zeros((), dtype=torch.long, device=device)

    def check(kind, logits, slots):
        nonlocal bad
        bad = bad + (~torch.isfinite(logits[slots].float())).sum()

    eng = ServingEngine(model, num_slots=4, max_len=2048, page_len=16,
                        prefill_chunk=256, num_pages=num_pages,
                        device=device, on_logits=check,
                        cache_dtype=cache_dtype, **engine_kw)
    if setup is not None:
        setup(eng)
    if requests is None:
        requests = workload(model.module.layers[0].vocab_size)
    reqs = []
    for prompt, kw in requests:
        reqs.append((eng.submit(prompt, NEW_TOKENS, **kw), prompt))
    out, steps = {}, 0
    while eng.scheduler.pending:
        for r in eng.step():
            out[r.rid] = r.tokens
        steps += 1
        if steps > 5000:
            raise AssertionError("the engine did not drain in 5000 steps")
    return eng, reqs, out, int(bad.item()), steps


def warm_up(model, device):
    """One short greedy and one short sampled request, so the measured
    run does not pay first-call costs (library handles, allocator)."""
    eng = ServingEngine(model, num_slots=2, max_len=2048, page_len=16,
                        prefill_chunk=256, device=device)
    rs = np.random.RandomState(SEED + 1)
    vocab = model.module.layers[0].vocab_size
    eng.submit(rs.randint(0, vocab, 300), 4)
    eng.submit(rs.randint(0, vocab, 40), 4, temperature=0.8, top_k=40,
               top_p=0.9)
    eng.run(max_steps=100)


def profile_serving(model, device, label="bf16 weights", **engine_kw):
    """Where the time goes in steady decode: four slots decoding (their
    256-token prompts prefilled first, outside the window), the wall
    time of a decode step without the profiler, then
    ``torch.profiler`` over a few steps: device time per kernel, CUDA
    kernel launches per step and the device's busy share of the step.
    ``engine_kw`` (e.g. ``weight_quant``) goes to the engine."""
    from torch.profiler import ProfilerActivity, profile
    eng = ServingEngine(model, num_slots=4, max_len=2048, page_len=16,
                        prefill_chunk=256, device=device, **engine_kw)
    rs = np.random.RandomState(SEED + 2)
    vocab = model.module.layers[0].vocab_size
    for _ in range(4):
        eng.submit(rs.randint(0, vocab, 256), 40)
    for _ in range(6):            # the prefills, and two warm decode steps
        eng.step()
    torch.cuda.synchronize()
    n_plain, n_prof = 16, 8
    t0 = time.perf_counter()
    for _ in range(n_plain):
        eng.step()                # each step ends on the lagged fetch
    step_ms = (time.perf_counter() - t0) * 1e3 / n_plain
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
    kernels_ = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.self_device_time_total > 0]
    kernels_.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels_) / 1e3 / n_prof
    n_kernels = sum(e.count for e in kernels_) / n_prof
    print(f"profile ({label}): steady decode, 4 slots, contexts ~260-300: "
          f"{step_ms:.2f} ms/step wall (profiler off); device busy "
          f"{busy_ms:.2f} ms/step = {100 * busy_ms / step_ms:.1f}% of the "
          f"step; {n_kernels:.0f} CUDA kernel launches a step", flush=True)
    for e in kernels_[:10]:
        print(f"profile:   {e.self_device_time_total / 1e3 / n_prof:7.3f} "
              f"ms/step  x{e.count // n_prof:<4d} {e.key[:72]}", flush=True)


def check_finished(reqs, out, bad):
    for rid, prompt in reqs:
        toks = out.get(rid)
        if toks is None or len(toks) != len(prompt) + NEW_TOKENS:
            raise AssertionError(f"request {rid} did not finish with its "
                                 f"{NEW_TOKENS} tokens")
        if not np.array_equal(toks[:len(prompt)], prompt):
            raise AssertionError(f"request {rid} lost its prompt")
    if bad:
        raise AssertionError(f"{bad} non-finite logits on live rows")


def check_serving(eng, reqs, out, bad):
    check_finished(reqs, out, bad)
    s = eng.metrics.summary()
    if s["prefix_cache"]["hits"] < 1:
        raise AssertionError("the shared template never hit the prefix "
                             "cache")
    if s["requests_preempted"] < 1:
        raise AssertionError("no stream was preempted")
    return s


def _last_logits(m, params, dtype, device, prompt):
    """One prompt's last-position logits through ``prefill`` on
    ``device``, as float32 on the CPU."""
    tokens = torch.as_tensor(prompt[None], dtype=torch.long)
    cache = init_cache(m.module, 1, len(prompt), dtype, device)
    logits, _ = prefill(m.module, params, cache, tokens.to(device))
    return logits.float().cpu()


def _bf16_logits(model, prompt):
    """``_last_logits`` through the engine's bf16 serving weights."""
    return _last_logits(model, fuse_qkv_params(
        model.module, serving_params(model.params, torch.bfloat16)),
        torch.bfloat16, model.device, prompt)


def bf16_rel_err(model, f32, prompt) -> float:
    """One prompt's last-position logits through the engine's bf16
    serving weights on ``model``'s device against ``f32`` (a float32 CPU
    copy of its weights) on the CPU, relative to the CPU's max |logit|."""
    ref = _last_logits(f32, f32.params, torch.float32, "cpu", prompt)
    return (_bf16_logits(model, prompt) - ref).abs().max().item() / \
        ref.abs().max().item()


def logits_vs_cpu(model, prompt):
    """One prompt's last-position logits on the card (bf16 serving
    weights, as the engine runs them; and float32) against the plain
    path on the CPU in float32 at the same weights."""
    f32 = build_lm("cpu", dtype="float32")
    f32.module.load_state_dict(model.module.state_dict())
    ref = _last_logits(f32, f32.params, torch.float32, "cpu", prompt)
    f32_card = copy.deepcopy(f32).to(model.device)
    card_f32 = _last_logits(f32_card, f32_card.params, torch.float32,
                            model.device, prompt)
    scale = ref.abs().max().item()
    return ((_bf16_logits(model, prompt) - ref).abs().max().item() / scale,
            (card_f32 - ref).abs().max().item() / scale, scale)


# --- phase 6: flash-attention backward ----------------------------------------

#: bf16 gradients against the float32 math of the plain version, relative
#: to the reference's largest magnitude: bf16 output rounding (2^-8) plus
#: the bf16-rounded P and dS tiles the kernels multiply
BWD_BF16_REL_TOL = 2e-2


def backward_cases(dev):
    """The training shape (the 218M LM's attention at B4 S2048, BSHD as
    the layer calls it), a window, GQA and ragged case at B1, the
    training length at head_dim 128 (B2 H8), and square attention with
    no causal mask: ViT-S/16's training shape (B32 H6 S196) and B1 H16
    S2048."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, torch.bfloat16)

    def case(b, s, h, hkv, window, d=64, causal=True):
        return dict(q=rnd(b, s, h, d), k=rnd(b, s, hkv, d),
                    v=rnd(b, s, hkv, d), dout=rnd(b, s, h, d),
                    window=window, causal=causal)

    return [("causal B4 H16 S2048", case(4, 2048, 16, 16, None)),
            ("window=256 B1 H16 S2048", case(1, 2048, 16, 16, 256)),
            ("GQA Hkv=4 G=4 B1 S2048", case(1, 2048, 16, 4, None)),
            ("causal ragged B1 H16 S1000", case(1, 1000, 16, 16, None)),
            ("causal B2 H8 S2048 D128", case(2, 2048, 8, 8, None, 128)),
            ("non-causal B32 H6 S196 (ViT-S/16)",
             case(32, 196, 6, 6, None, causal=False)),
            ("non-causal B1 H16 S2048",
             case(1, 2048, 16, 16, None, causal=False))]


def _sdpa_backward_ms(c, timer=None):
    """SDPA forward+backward minus SDPA forward: a yardstick only (the
    port never calls SDPA). GQA repeats K/V first. ``timer`` (default
    ``time_ms``) times each of the two calls."""
    timer = time_ms if timer is None else timer
    g = c["q"].shape[2] // c["k"].shape[2]
    q, k, v = (x.transpose(1, 2).detach().clone().requires_grad_()
               for x in (c["q"], c["k"], c["v"]))
    kx, vx = (t.repeat_interleave(g, 1) if g > 1 else t for t in (k, v))
    dout = c["dout"].transpose(1, 2)
    mask = None
    if c["window"] is not None:
        i = torch.arange(q.shape[2], device=q.device)
        mask = (i[None, :] <= i[:, None]) & \
            (i[None, :] > i[:, None] - c["window"])

    def fwd():
        return F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask,
            is_causal=mask is None and c["causal"])

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), dout)

    with torch.no_grad():
        f_ms = timer(fwd)
    return timer(fwd_bwd) - f_ms


def backward_phase(dev):
    """Each case of ``backward_cases``: both kernels against the plain
    version, a bitwise repeat (two launches of each on the same inputs),
    times, achieved TFLOP/s and the bound's share. The causal cases are
    timed by CUDA events around back-to-back launches (how their kernel
    table rows were always timed); the non-causal ones by CUDA-graph
    replay (``graph_ms``), the SDPA yardstick too."""
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for name, c in backward_cases(dev):
        q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
        causal = c["causal"]
        kw = dict(scale=q.shape[-1] ** -0.5, causal=causal,
                  window=c["window"], layout="bshd")
        out, lse = flash_forward(q, k, v, **kw)
        delta = attention_delta(out, dout)
        args = (q, k, v, lse, dout, delta, kw["scale"], causal, c["window"],
                "bshd")
        got = launch_dq(*args) + launch_dkv(*args)
        again = launch_dq(*args) + launch_dkv(*args)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = flash_backward_reference(q, k, v, out, lse, dout, delta, **kw)
        errs, rel = {}, {}
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"non-finite {gname} on {name}")
            errs[gname] = (a.float() - r.float()).abs().max().item()
            rel[gname] = errs[gname] / r.float().abs().max().item()
        if causal:
            fwd_ms = time_ms(lambda: flash_forward(q, k, v, **kw))
            dq_ms = time_ms(lambda: launch_dq(*args), iters=10)
            dkv_ms = time_ms(lambda: launch_dkv(*args), iters=10)
            lib_ms = _sdpa_backward_ms(c)
        else:
            fwd_ms = graph_ms(lambda: flash_forward(q, k, v, **kw))
            dq_ms = graph_ms(lambda: launch_dq(*args), iters=20)
            dkv_ms = graph_ms(lambda: launch_dkv(*args), iters=20)
            lib_ms = _sdpa_backward_ms(c, functools.partial(graph_ms,
                                                            iters=20))
        plain_ms = time_ms(lambda: flash_backward_reference(
            q, k, v, out, lse, dout, delta, **kw), iters=3, warmup=1)
        b, s, h, d = q.shape
        work = b * h * _admitted_pairs(s, s, causal, c["window"]) * d
        qbytes = 2 * q.numel()                       # one bf16 q-shaped array
        kvbytes = 2 * k.numel()
        rowbytes = 4 * lse.numel()                   # one float32 row stat
        # each input read once, each output written once: q, k, v, dO,
        # lse, delta in; dq (dq kernel) or dk, dv (dk/dv kernel) out
        in_bytes = 2 * qbytes + 2 * kvbytes + 2 * rowbytes
        dq_bound, dq_by = bound_ms(6.0 * work, in_bytes + qbytes,
                                   PEAK_BF16_FLOPS)
        dkv_bound, dkv_by = bound_ms(8.0 * work, in_bytes + 2 * kvbytes,
                                     PEAK_BF16_FLOPS)
        print(f"flash_bwd {name}: max abs err dq {errs['dq']:.3e} dk "
              f"{errs['dk']:.3e} dv {errs['dv']:.3e}; relative to the "
              f"reference's max {rel['dq']:.3e} {rel['dk']:.3e} "
              f"{rel['dv']:.3e} (tol {BWD_BF16_REL_TOL}); dq kernel "
              f"{dq_ms:.4f} ms ({6.0 * work / (dq_ms * 1e9):.1f} TFLOP/s, "
              f"{dq_bound / dq_ms:.1%} of the bound {dq_bound:.4f}, "
              f"{dq_by}), dk/dv kernel {dkv_ms:.4f} ms "
              f"({8.0 * work / (dkv_ms * 1e9):.1f} TFLOP/s, "
              f"{dkv_bound / dkv_ms:.1%} of the bound {dkv_bound:.4f}, "
              f"{dkv_by}); plain backward {plain_ms:.4f} ms; sdpa backward "
              f"{lib_ms:.4f} ms; flash_fwd {fwd_ms:.4f} ms ("
              f"{'CUDA events' if causal else 'graph replay'}); bitwise "
              f"repeat {repeat}", flush=True)
        if max(rel.values()) > BWD_BF16_REL_TOL or not repeat:
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"their plain version on {name}, or with "
                                 f"themselves (bitwise repeat {repeat})")
        rows["flash_bwd_dq"].append(dict(
            name=name, err=errs["dq"], ms=dq_ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=dq_bound, bound_by=dq_by))
        rows["flash_bwd_dkv"].append(dict(
            name=name, err=max(errs["dk"], errs["dv"]), ms=dkv_ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=dkv_bound,
            bound_by=dkv_by))
    return rows


# --- phase 7: the training path end to end ----------------------------------

TRAIN_ROWS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_EPOCHS = 32, 2048, 4, 2
TRAIN_LR = 1e-3
TRAIN_LOSS = "sparse_categorical_crossentropy_from_logits"
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def training_data(vocab: int, rows=TRAIN_ROWS, seq=TRAIN_SEQ):
    """``rows`` rows of ``seq`` next-token pairs, each row its own random
    64-token pattern tiled, so the loss can fall within a few steps."""
    rs = np.random.RandomState(SEED)
    pats = rs.randint(0, vocab, (rows, 64))
    toks = np.tile(pats, (1, seq // 64 + 1))[:, :seq + 1]
    return Dataset.from_arrays(toks[:, :-1], toks[:, 1:])


def train(model, data=None, epochs=TRAIN_EPOCHS):
    """``epochs`` epochs of ``data`` (default: phase 7's) through
    ``SingleTrainer``; returns the trainer and the launch counts of this
    run."""
    if data is None:
        data = training_data(model.module.layers[0].vocab_size)
    trainer = SingleTrainer(model, worker_optimizer="adam",
                            learning_rate=TRAIN_LR, loss=TRAIN_LOSS,
                            batch_size=TRAIN_BATCH, num_epoch=epochs,
                            metrics=["accuracy"])
    return trainer, counted_train(trainer, data)


def counted_train(trainer, data):
    """``trainer.train(data)`` with the launch counts of this run only."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    trainer.train(data)
    torch.cuda.synchronize()
    return kernels.launch_counts()


def check_training(trainer, launches, num_layers,
                   steps=TRAIN_EPOCHS * TRAIN_ROWS // TRAIN_BATCH,
                   names=TRAINING_KERNELS):
    hist = trainer.get_history()
    losses = hist.losses()
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    last_mean = float(np.mean(hist.epochs[-1]["loss"]))
    if not last_mean < losses[0]:
        raise AssertionError(f"loss did not fall: first step {losses[0]}, "
                             f"last epoch mean {last_mean}")
    for name in names:
        if launches[name] != num_layers * steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {steps} steps "
                f"of a {num_layers}-layer model; expected "
                f"{num_layers * steps}")
    return losses, last_mean


def profile_training(model, card, label="training",
                     prefix="profile-train", groups=(), ranges=(),
                     fused=False):
    """The steady training step: wall time over a few steps (after one
    warm step), tokens/s, peak device memory, and (unless ``prefix`` is
    None) ``torch.profiler`` over one step: device time per kernel, the
    device's busy share, for each ``(label, key substrings)`` of
    ``groups`` the summed device time of the kernels it names and, for
    each function of ``ranges`` (``_Ranges``), the device time of the
    kernels its calls launched. ``fused`` trains through the fused vocab
    head (``make_train_step(fused_vocab_head=)``)."""
    from torch.profiler import ProfilerActivity, profile
    data = training_data(model.module.layers[0].vocab_size, rows=TRAIN_BATCH)
    xb, yb = (torch.from_numpy(a).to(model.device) for a in data.arrays())
    opt = adam(TRAIN_LR)
    step = make_train_step(model.module,
                           sparse_categorical_crossentropy_from_logits, opt,
                           fused_vocab_head=fused)
    carry = TrainCarry(model.params, opt.init(model.params))
    carry, _ = step(carry, (xb, yb))
    torch.cuda.synchronize()
    # earlier phases' models and engines sit in reference cycles until the
    # cycle collector runs: without this the base (and the peak) read
    # 0-4.4 GiB more, by when it last ran
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        carry, loss = step(carry, (xb, yb))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = xb.numel()
    busy = "not profiled"
    ops, busy_ms = [], None
    if prefix is not None:
        with _Ranges(ranges) as ranged, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            carry, loss = step(carry, (xb, yb))
            torch.cuda.synchronize()
        # kernels only: a range's device-side span is not a kernel
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
        ops.sort(key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
        busy = (f"device busy {busy_ms:.1f} ms in the profiled step "
                f"({100 * busy_ms / step_ms:.0f}% of a step's wall time), "
                f"{sum(e.count for e in ops)} CUDA kernels")
    print(f"{label} on {card}: {step_ms:.1f} ms/step (B{TRAIN_BATCH} "
          f"S{TRAIN_SEQ}, adam, profiler off), {tokens / step_ms * 1e3:.0f} "
          f"tokens/s, peak device memory {peak_gb:.2f} GiB ({base_gb:.2f} "
          f"GiB allocated before the steps); {busy}", flush=True)
    for e in ops[:12]:
        print(f"{prefix}:   {e.self_device_time_total / 1e3:8.3f} ms  "
              f"x{e.count:<5d} {e.key[:72]}", flush=True)
    for name, keys in groups:
        hit = [e for e in ops if any(k in e.key for k in keys)]
        print(f"{prefix}: {name}: "
              f"{sum(e.self_device_time_total for e in hit) / 1e3:.3f} ms "
              f"in {sum(e.count for e in hit)} launches", flush=True)
    if prefix is not None:
        found = {lab for lab, _, _ in ranged.found}
        for name, _, _ in ranges:
            # the host-side range: its device time sums its ops' kernels
            hit = [e for e in prof.key_averages() if e.key == name
                   and e.device_type == torch.autograd.DeviceType.CPU]
            print(f"{prefix}: {name}: " + (
                f"{sum(e.device_time_total for e in hit) / 1e3:.3f} ms in "
                f"{sum(e.count for e in hit)} calls" if name in found
                else "absent from this package"), flush=True)
    return step_ms, tokens / step_ms * 1e3, peak_gb, busy_ms


# --- phase 7b: the flash kernels with packed-sequence segment ids ------------

#: phase 7c's packed rows: 32 rows of 2048 tokens, batch 4, one epoch
PACK_ROWS, PACK_SEQ, PACK_BATCH = 32, 2048, 4
#: document lengths (tokens), drawn per document from the seed, and the
#: pool of 64-token patterns the documents tile: each pattern recurs in
#: later batches, so the loss can fall within one epoch (phase 7's rows
#: each carry their own pattern and teach nothing to the next batch)
PACK_DOC_LEN = (64, 1536)
PACK_PATTERNS = 16
MASKED_LOSS = "masked_sparse_categorical_crossentropy_from_logits"
#: phase 7b's unsorted-ids case: its length (ragged against the 64-row
#: tiles) and its -1 tail
UNSORTED_LEN, UNSORTED_TAIL = 1000, 100
#: float32 kernels against their plain versions: the forward's output
#: (max abs) and the backward's gradients (relative to the reference's
#: max) differ only by summation order
KERNEL_F32_TOL = 2e-4
BWD_F32_REL_TOL = 1e-4


def packed_data(vocab: int):
    """Documents of seeded lengths in ``PACK_DOC_LEN``, each one of
    ``PACK_PATTERNS`` random 64-token patterns tiled (as
    ``training_data``), packed greedily into
    ``PACK_ROWS`` rows of ``PACK_SEQ`` tokens: a document that does not
    fit starts the next row. Returns tokens, segment ids (the document's index in
    its row; -1 on the pad tail, whose tokens are 0) and labels (the
    next token inside the document; -1 on each document's last token and
    on the pad)."""
    rs = np.random.RandomState(SEED + 5)
    rows, seq = PACK_ROWS, PACK_SEQ
    pats = rs.randint(0, vocab, (PACK_PATTERNS, 64))
    toks = np.zeros((rows, seq), np.int64)
    seg = np.full((rows, seq), -1, np.int32)
    labels = np.full((rows, seq), -1, np.int64)
    r = col = doc = 0
    while True:
        n = rs.randint(PACK_DOC_LEN[0], PACK_DOC_LEN[1] + 1)
        if col + n > seq:
            r, col, doc = r + 1, 0, 0
        if r == rows:
            break
        d = np.tile(pats[rs.randint(PACK_PATTERNS)], n // 64 + 1)[:n]
        toks[r, col:col + n] = d
        seg[r, col:col + n] = doc
        labels[r, col:col + n - 1] = d[1:]
        col, doc = col + n, doc + 1
    return toks, seg, labels


def segment_pairs(seg, window=None) -> int:
    """The causal (query, key) pairs ``[B, S]`` ids admit: per query, the
    keys at or before it with its id (within the window): what the
    kernels' bounds count."""
    total = 0
    for row in np.asarray(seg):
        for sid in np.unique(row):
            pos = np.flatnonzero(row == sid)
            lo = 0 if window is None else np.searchsorted(
                pos, pos - window, side="right")
            total += int((np.arange(len(pos)) + 1 - lo).sum())
    return total


def segment_cases(dev):
    """Phase 7b's cases: (name, q/k/v/dout, ids, window, dtype). The
    training shape on phase 7c's first batch of packed rows, float32,
    grouped queries, a window over the same ids, unsorted interleaved ids
    with a -1 tail at a ragged length, and all-equal ids."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    rs = np.random.RandomState(SEED + 6)
    seg = packed_data(LM_CFG["vocab"])[1]
    h = LM_CFG["num_heads"]
    d = LM_CFG["d_model"] // h
    s, n = PACK_SEQ, UNSORTED_LEN

    def case(b, s, hkv, ids, window=None, dtype=torch.bfloat16):
        def rnd(*shape):
            return torch.randn(*shape, generator=g).to(dev, dtype)
        return dict(q=rnd(b, s, h, d), k=rnd(b, s, hkv, d),
                    v=rnd(b, s, hkv, d), dout=rnd(b, s, h, d),
                    seg=torch.from_numpy(np.ascontiguousarray(ids)).to(dev),
                    window=window)

    unsorted = rs.randint(0, 4, (1, n)).astype(np.int32)
    unsorted[:, n - UNSORTED_TAIL:] = -1
    return [
        (f"packed B{PACK_BATCH} H{h} S{s}",
         case(PACK_BATCH, s, h, seg[:PACK_BATCH])),
        (f"float32 packed B1 S{GRAD_SEQ}",
         case(1, GRAD_SEQ, h, seg[:1, :GRAD_SEQ], dtype=torch.float32)),
        (f"GQA Hkv={h // 4} G=4 packed B1 S{s}",
         case(1, s, h // 4, seg[:1])),
        (f"window=256 packed B1 S{s}", case(1, s, h, seg[:1], 256)),
        (f"unsorted ids, -1 tail, B1 S{n}", case(1, n, h, unsorted)),
        (f"all-equal ids B1 S{s}",
         case(1, s, h, np.full((1, s), 3, np.int32))),
    ]


def _sdpa_masked_ms(c):
    """``scaled_dot_product_attention`` with the boolean ``[B, 1, S, S]``
    mask (causal, same id, window), forward and forward+backward: a
    yardstick only (the port never calls it). GQA repeats K/V first."""
    g = c["q"].shape[2] // c["k"].shape[2]
    q, k, v = (x.transpose(1, 2).detach().clone().requires_grad_()
               for x in (c["q"], c["k"], c["v"]))
    kx, vx = (t.repeat_interleave(g, 1) if g > 1 else t for t in (k, v))
    dout = c["dout"].transpose(1, 2)
    i = torch.arange(q.shape[2], device=q.device)
    mask = (i[None, :] <= i[:, None])
    if c["window"] is not None:
        mask = mask & (i[None, :] > i[:, None] - c["window"])
    seg = c["seg"]
    mask = (mask[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]

    def fwd():
        return F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), dout)

    with torch.no_grad():
        f_ms = time_ms(fwd)
    return f_ms, time_ms(fwd_bwd)


def segment_phase(dev):
    """Phase 7b: K1f, K1dq and K1dkv with segment ids against their plain
    versions, kernel ms with and without ids, bounds from the admitted
    pairs, the plain versions' ms and the masked-SDPA yardstick."""
    rows = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    for name, c in segment_cases(dev):
        q, k, v, dout, seg = c["q"], c["k"], c["v"], c["dout"], c["seg"]
        f32 = q.dtype == torch.float32
        kw = dict(scale=q.shape[-1] ** -0.5, causal=True,
                  window=c["window"], layout="bshd")
        out, lse = flash_forward(q, k, v, segment_ids=seg, **kw)
        delta = attention_delta(out, dout)
        args = (q, k, v, lse, dout, delta, kw["scale"], True, c["window"],
                "bshd")
        got = launch_dq(*args, segment_ids=seg) + \
            launch_dkv(*args, segment_ids=seg)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_forward_reference(q, k, v, segment_ids=seg,
                                                   **kw)
        ref = flash_backward_reference(q, k, v, out, lse, dout, delta,
                                       segment_ids=seg, **kw)
        errs = {"out": (out.float() - ref_out.float()).abs().max().item(),
                "lse": (lse - ref_lse).abs().max().item()}
        rel = {}
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"non-finite {gname} on {name}")
            errs[gname] = (a.float() - r.float()).abs().max().item()
            rel[gname] = errs[gname] / r.float().abs().max().item()
        fwd_tol = KERNEL_F32_TOL if f32 else KERNEL_BF16_TOL
        bwd_tol = BWD_F32_REL_TOL if f32 else BWD_BF16_REL_TOL
        ok = (errs["out"] <= fwd_tol and errs["lse"] <= LSE_TOL
              and max(rel.values()) <= bwd_tol)
        bitwise = ""
        if name.startswith("all-equal"):
            out0, lse0 = flash_forward(q, k, v, **kw)
            plain = (out0, lse0) + launch_dq(*args) + launch_dkv(*args)
            same = all(torch.equal(a, b) for a, b in
                       zip((out, lse) + got, plain))
            bitwise = f"; bitwise equal to no ids: {same}"
            ok = ok and same
        ms = {"fwd": graph_ms(lambda: flash_forward(q, k, v,
                                                    segment_ids=seg, **kw)),
              "fwd0": graph_ms(lambda: flash_forward(q, k, v, **kw)),
              "dq": time_ms(lambda: launch_dq(*args, segment_ids=seg),
                            iters=10),
              "dq0": time_ms(lambda: launch_dq(*args), iters=10),
              "dkv": time_ms(lambda: launch_dkv(*args, segment_ids=seg),
                             iters=10),
              "dkv0": time_ms(lambda: launch_dkv(*args), iters=10)}
        plain_fwd = time_ms(lambda: flash_forward_reference(
            q, k, v, segment_ids=seg, **kw), iters=3, warmup=1)
        plain_bwd = time_ms(lambda: flash_backward_reference(
            q, k, v, out, lse, dout, delta, segment_ids=seg, **kw),
            iters=3, warmup=1)
        sdpa_f, sdpa_fb = _sdpa_masked_ms(c)
        b, s, h, d = q.shape
        work = h * segment_pairs(seg.cpu().numpy(), c["window"]) * d
        esz = q.element_size()
        qbytes, kvbytes = esz * q.numel(), esz * k.numel()
        rowbytes, segbytes = 4 * lse.numel(), 4 * seg.numel()
        peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
        fwd_bound = bound_ms(4.0 * work, 2 * qbytes + 2 * kvbytes + rowbytes
                             + segbytes, peak)
        in_bytes = 2 * qbytes + 2 * kvbytes + 2 * rowbytes + segbytes
        dq_bound = bound_ms(6.0 * work, in_bytes + qbytes, peak)
        dkv_bound = bound_ms(8.0 * work, in_bytes + 2 * kvbytes, peak)
        print(f"flash segments {name}: max abs err out {errs['out']:.3e} "
              f"(tol {fwd_tol}), lse {errs['lse']:.3e} (tol {LSE_TOL}); "
              f"dq/dk/dv relative {rel['dq']:.3e} {rel['dk']:.3e} "
              f"{rel['dv']:.3e} (tol {bwd_tol}){bitwise}; kernel ms with "
              f"ids / without: fwd {ms['fwd']:.4f} / {ms['fwd0']:.4f}, dq "
              f"{ms['dq']:.4f} / {ms['dq0']:.4f}, dk/dv {ms['dkv']:.4f} / "
              f"{ms['dkv0']:.4f}; bounds (admitted pairs {work // (h * d)}) "
              f"fwd {fwd_bound[0]:.4f} ({fwd_bound[1]}), dq "
              f"{dq_bound[0]:.4f} ({dq_bound[1]}), dk/dv {dkv_bound[0]:.4f} "
              f"({dkv_bound[1]}); plain fwd {plain_fwd:.4f} ms, plain "
              f"backward {plain_bwd:.4f} ms; masked sdpa fwd {sdpa_f:.4f} "
              f"ms, fwd+bwd {sdpa_fb:.4f} ms", flush=True)
        if not ok:
            raise AssertionError(f"the flash kernels with segment ids "
                                 f"disagree with their plain versions on "
                                 f"{name}")
        bwd_lib = sdpa_fb - sdpa_f
        for kname, err, kms, bnd, plain_ms, lib in (
                ("flash_fwd", errs["out"], ms["fwd"], fwd_bound, plain_fwd,
                 sdpa_f),
                ("flash_bwd_dq", errs["dq"], ms["dq"], dq_bound, plain_bwd,
                 bwd_lib),
                ("flash_bwd_dkv", max(errs["dk"], errs["dv"]), ms["dkv"],
                 dkv_bound, plain_bwd, bwd_lib)):
            rows[kname].append(dict(name=name, err=err, ms=kms,
                                    plain_ms=plain_ms, library_ms=lib,
                                    bound_ms=bnd[0], bound_by=bnd[1]))
    return rows


# --- phase 7c: packed-sequence training at full width -----------------------


def packed_step(model, opt, opt_state, x, seg, y, update=True):
    """The hand-written packed step (JAX ``tests/test_packed_sequences.py``
    :181-189): ``module.apply(params, x, segment_ids=seg)``, the masked
    loss, its gradients and (``update``) one optimizer update. Returns
    the optimizer state, the loss and the gradients."""
    params = model.params
    model.module.train()
    out = model.module.apply(params, x, segment_ids=seg)
    loss = get_loss(MASKED_LOSS)(y, out)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    model.module.eval()
    if update:
        with torch.no_grad():
            upd, opt_state = opt.update(tree_unflatten(params, grads),
                                        opt_state, params)
            apply_updates(params, upd)
    return opt_state, loss.detach(), grads


def _remat_view(model):
    """The same layers and parameters with every block wrapped in
    ``Remat(policy="nothing")``."""
    layers = [Remat(layer, policy="nothing")
              if isinstance(layer, TransformerBlock) else layer
              for layer in model.module.layers]
    return Model(Sequential(layers), model.input_shape, model.output_shape,
                 model.device)


def packed_training_phase(dev, card):
    """Phase 7c: one epoch of packed rows through the hand-written step
    on a fresh seed-0 218M LM, exactly 12 launches of each flash kernel
    a step; the step's time, real tokens/s, pad share and peak memory;
    the same rows without ids (the mask's cost); one step with
    ``Remat(policy="nothing")`` bitwise equal to the bare step."""
    model = build_lm(dev)
    toks, seg, labels = (torch.from_numpy(a).to(dev)
                         for a in packed_data(LM_CFG["vocab"]))
    pad_share = float((seg < 0).float().mean())
    n_docs = int(sum(len(np.unique(r[r >= 0])) for r in seg.cpu().numpy()))
    opt = get_optimizer("adam", learning_rate=TRAIN_LR)
    state = opt.init(model.params)
    steps = PACK_ROWS // PACK_BATCH
    batches = [tuple(a[i * PACK_BATCH:(i + 1) * PACK_BATCH]
                     for a in (toks, seg, labels)) for i in range(steps)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = []
    for x, sb, y in batches:
        state, loss, _ = packed_step(model, opt, state, x, sb, y)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    losses = torch.stack(losses).float().cpu().numpy()
    print(f"packed training: {steps} steps over {PACK_ROWS} rows x "
          f"{PACK_SEQ} ({n_docs} documents of {PACK_DOC_LEN[0]}-"
          f"{PACK_DOC_LEN[1]} tokens, pad share {pad_share:.4f}), loss "
          f"{np.array2string(losses, precision=3)}; launches "
          f"{ {n: launches[n] for n in TRAINING_KERNELS} }", flush=True)
    if not (np.isfinite(losses).all() and losses[-2:].mean() < losses[0]):
        raise AssertionError(f"packed training: losses {losses} are not "
                             "finite or did not fall")
    for name in TRAINING_KERNELS:
        if launches[name] != LM_CFG["num_layers"] * steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {steps} packed "
                f"steps; expected {LM_CFG['num_layers'] * steps}")

    x, sb, y = batches[0]
    real = int((sb >= 0).sum())

    def timed(ids, n=3):
        nonlocal state
        state, _, _ = packed_step(model, opt, state, x, ids, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _, _ = packed_step(model, opt, state, x, ids, y)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / n,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    step_ms, peak = timed(sb)
    nomask_ms, _ = timed(None)
    print(f"packed training on {card}: {step_ms:.1f} ms/step (B{PACK_BATCH} "
          f"S{PACK_SEQ}, adam), {real / step_ms * 1e3:.0f} real tokens/s "
          f"({x.numel() / step_ms * 1e3:.0f} with the pad), peak device "
          f"memory {peak:.2f} GiB; the same rows without segment_ids "
          f"{nomask_ms:.1f} ms/step", flush=True)

    remat = _remat_view(model)
    runs = {}
    for label, m in (("bare", model), ("remat", remat)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        _, loss, grads = packed_step(m, opt, state, x, sb, y, update=False)
        torch.cuda.synchronize()
        runs[label] = (loss, grads, kernels.launch_counts(),
                       torch.cuda.max_memory_allocated() / 2 ** 30)
    (l0, g0, c0, p0), (l1, g1, c1, p1) = runs["bare"], runs["remat"]
    same = torch.equal(l0, l1) and all(torch.equal(a, b)
                                       for a, b in zip(g0, g1))
    n = LM_CFG["num_layers"]
    print(f"packed step with Remat(policy='nothing'): loss and gradients "
          f"bitwise equal to the bare step: {same}; launches flash_fwd "
          f"{c1['flash_fwd']} (bare {c0['flash_fwd']}), dq "
          f"{c1['flash_bwd_dq']}, dk/dv {c1['flash_bwd_dkv']}; peak device "
          f"memory {p1:.2f} GiB (bare {p0:.2f} GiB)", flush=True)
    if not same:
        raise AssertionError("the remat packed step differs from the bare "
                             "one")
    if (c1["flash_fwd"], c1["flash_bwd_dq"], c1["flash_bwd_dkv"]) != \
            (2 * n, n, n):
        raise AssertionError(f"the remat step launched {c1}")
    del remat, model, state
    return launches


#: phase 7c's 2-layer copy: B1 S512, four documents and a pad tail
PACK_GRAD_CUTS = (0, 150, 290, 400, 470)


def _grad_rows(rs):
    toks = torch.from_numpy(rs.randint(0, LM_CFG["vocab"],
                                       (1, GRAD_SEQ))).long()
    seg = torch.full((1, GRAD_SEQ), -1, dtype=torch.int32)
    labels = torch.full((1, GRAD_SEQ), -1, dtype=torch.long)
    cuts = PACK_GRAD_CUTS
    for i in range(len(cuts) - 1):
        seg[:, cuts[i]:cuts[i + 1]] = i
        labels[:, cuts[i]:cuts[i + 1] - 1] = toks[:, cuts[i] + 1:cuts[i + 1]]
    return toks, seg, labels


def packed_gradients_phase(dev):
    """Phase 7c at 2 layers, B1 S512: the masked packed loss's gradients
    on the card (bf16, float32) against the CPU float32 plain path, then
    cross-segment isolation in float32 on the card (JAX
    ``tests/test_packed_sequences.py:66-117``)."""
    toks, seg, labels = _grad_rows(np.random.RandomState(SEED + 7))

    def grads(device, dtype):
        m = build_lm(device, num_layers=GRAD_LAYERS, dtype=dtype)
        _, loss, g = packed_step(m, None, None, toks.to(m.device),
                                 seg.to(m.device), labels.to(m.device),
                                 update=False)
        return float(loss), [t.float().cpu() for t in g]

    ref_loss, ref = grads("cpu", "float32")
    for dtype, tol in (("bfloat16", GRAD_BF16_REL_TOL),
                       ("float32", GRAD_F32_REL_TOL)):
        kernels.reset_launch_counts()
        loss, got = grads(dev, dtype)
        if kernels.launch_counts()["flash_bwd_dkv"] != GRAD_LAYERS:
            raise AssertionError("the packed card gradient did not run the "
                                 "backward kernels")
        worst = max((a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(got, ref))
        print(f"packed gradient vs CPU float32 ({GRAD_LAYERS} layers, B1 "
              f"S{GRAD_SEQ}, {len(PACK_GRAD_CUTS) - 1} documents and a pad "
              f"tail): card {dtype} loss {loss:.6f} (CPU {ref_loss:.6f}), "
              f"worst per-leaf rel err {worst:.3e} (tol {tol})", flush=True)
        if not (worst <= tol and abs(loss - ref_loss) <= tol * ref_loss):
            raise AssertionError(f"card {dtype} packed gradients disagree "
                                 "with the CPU")

    m = build_lm(dev, num_layers=GRAD_LAYERS, dtype="float32")
    cut = PACK_GRAD_CUTS[2]
    rs = np.random.RandomState(SEED + 8)
    x1 = toks.to(dev)
    x2 = x1.clone()
    x2[:, :cut] = torch.from_numpy(rs.randint(0, LM_CFG["vocab"],
                                              (1, cut))).to(dev)
    two = torch.from_numpy((np.arange(GRAD_SEQ) >= cut)
                           .astype(np.int32))[None].to(dev)

    def logits(x, ids):
        with torch.no_grad():
            return m.module.apply(m.params, x, segment_ids=ids)

    l1, l2 = logits(x1, two), logits(x2, two)
    u1, u2 = logits(x1, None), logits(x2, None)
    later_equal = torch.equal(l1[:, cut:], l2[:, cut:])
    moved = (u1[:, cut:] - u2[:, cut:]).abs().max().item()

    def later_grads(x):
        out = m.module.apply(m.params, x, segment_ids=two)
        loss = out[:, cut:].float().square().sum()
        return torch.autograd.grad(loss, tree_leaves(m.params))

    worst = 0.0
    for a, b in zip(later_grads(x1), later_grads(x2)):
        if a.shape == (LM_CFG["vocab"], LM_CFG["d_model"]):
            continue            # the embedding rows of the perturbed tokens
        worst = max(worst, (a - b).abs().max().item()
                    / max(b.abs().max().item(), 1e-30))
    print(f"cross-segment isolation (float32 card, earlier segment "
          f"perturbed): later-segment logits bitwise equal {later_equal}; "
          f"later-segment loss gradients rel diff {worst:.3e} (tol 1e-6); "
          f"without ids the later logits move by {moved:.3e}", flush=True)
    if not (later_equal and worst <= 1e-6 and moved > 0.0):
        raise AssertionError("packed sequences leak across segments on the "
                             "card")


# --- phase 8: gradients on the card against the CPU -------------------------

#: worst per-leaf gradient error relative to the leaf's largest CPU
#: value: float32 on the card differs from the CPU only in summation
#: order; bf16 carries activations, P and dS rounded to 2^-8 through two
#: blocks and the 32768-way head (1.3e-2 on the CPU's own bf16 path)
GRAD_F32_REL_TOL = 1e-3
GRAD_BF16_REL_TOL = 5e-2
GRAD_LAYERS, GRAD_SEQ = 2, 512


def gradients_vs_cpu(dev):
    rs = np.random.RandomState(SEED + 4)
    toks = torch.from_numpy(rs.randint(0, LM_CFG["vocab"],
                                       (1, GRAD_SEQ + 1)))
    x, y = toks[:, :-1], toks[:, 1:]
    loss_fn = sparse_categorical_crossentropy_from_logits

    def grads(device, dtype):
        m = build_lm(device, num_layers=GRAD_LAYERS, dtype=dtype)
        loss, g, _ = value_and_grad(m.module, loss_fn, m.params,
                                    x.to(m.device), y.to(m.device))
        return float(loss), [t.float().cpu() for t in tree_leaves(g)]

    ref_loss, ref = grads("cpu", "float32")
    out = {}
    for dtype, tol in (("bfloat16", GRAD_BF16_REL_TOL),
                       ("float32", GRAD_F32_REL_TOL)):
        kernels.reset_launch_counts()
        loss, got = grads(dev, dtype)
        if kernels.launch_counts()["flash_bwd_dkv"] != GRAD_LAYERS:
            raise AssertionError("the card gradient did not run the "
                                 "backward kernels")
        worst = max((a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(got, ref))
        print(f"gradient vs CPU float32 ({GRAD_LAYERS} layers, B1 "
              f"S{GRAD_SEQ}): card {dtype} loss {loss:.6f} (CPU "
              f"{ref_loss:.6f}), worst per-leaf rel err {worst:.3e} (tol "
              f"{tol})", flush=True)
        if not (worst <= tol and abs(loss - ref_loss) <= tol * ref_loss):
            raise AssertionError(f"card {dtype} gradients disagree with "
                                 f"the CPU")
        out[dtype] = worst
    return out


# --- phase 9: decode attention over the slab cache (K2) ---------------------


def decode_cases(dev):
    """generate()'s shape on the 218M LM (B4 x Hkv16 rows, G1, D64, a
    1152-position cache written through t=1151), GQA 4x4, a 256-position
    window, a short cache, and the int8 / int4 caches (int4: one int8
    byte per entry in [-7, 7])."""
    rs = np.random.RandomState(SEED + 5)

    def case(b, hkv, g, length, t, window=None, bits=None):
        q = torch.from_numpy(rs.randn(b * hkv, g, 64).astype(np.float32))
        k, v = (torch.from_numpy(rs.randn(b, hkv, length, 64)
                                 .astype(np.float32)).to(dev)
                for _ in range(2))
        c = dict(b=b, hkv=hkv, g=g, t=t, window=window, bits=bits)
        if bits is None:
            c.update(q=q.to(dev, torch.bfloat16),
                     k=k.to(torch.bfloat16).reshape(b * hkv, length, 64),
                     v=v.to(torch.bfloat16).reshape(b * hkv, length, 64))
        else:
            (kq, ks), (vq, vs) = (_quantize_kv(x, bits) for x in (k, v))
            c.update(q=q.to(dev), k=kq.reshape(b * hkv, length, 64),
                     v=vq.reshape(b * hkv, length, 64),
                     k_scale=ks.reshape(b * hkv, length),
                     v_scale=vs.reshape(b * hkv, length))
        return c

    return [("decode_attention", "B4 Hkv16 G1 L1152 t1151",
             case(4, 16, 1, 1152, 1151)),
            ("decode_attention", "GQA Hkv4 G4 L1152",
             case(4, 4, 4, 1152, 1151)),
            ("decode_attention", "window=256 L1152",
             case(4, 16, 1, 1152, 1151, window=256)),
            ("decode_attention", "short L40 t39", case(4, 16, 1, 40, 39)),
            ("decode_attention_q8", "int8 B4 Hkv16 G1 L1152",
             case(4, 16, 1, 1152, 1151, bits=8)),
            ("decode_attention_q8", "int4-in-int8 B4 Hkv16 G1 L1152",
             case(4, 16, 1, 1152, 1151, bits=4))]


def _sdpa_decode(c):
    """One SDPA call over the same cache (boolean mask of the valid
    positions; GQA through ``enable_gqa``): a yardstick only."""
    b, hkv, g = c["b"], c["hkv"], c["g"]
    length, d = c["k"].shape[1:]
    q = c["q"].reshape(b, hkv * g, 1, d)
    k = c["k"].reshape(b, hkv, length, d)
    v = c["v"].reshape(b, hkv, length, d)
    lo, hi = valid_range(c["t"], c["window"])
    pos = torch.arange(length, device=q.device)
    mask = ((pos >= lo) & (pos <= hi))[None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=g > 1)


def kernels_per_call(fn, calls: int = 4) -> float:
    """The CUDA kernels one call of ``fn`` launches: ``calls`` warm calls
    captured in a CUDA graph, whose kernel nodes the driver counts
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``). Exact, where a
    profiler session can miss the launches at its start."""
    import ctypes
    driver = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if driver.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    count = 0
    for node in nodes:
        if driver.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        count += kind.value == 0             # CU_GRAPH_NODE_TYPE_KERNEL
    return count / calls


#: bytes a cold timing's copies of a cache add up to at least: twice the
#: H100's 50 MB L2, so a replay walking them finds each copy evicted
COLD_BYTES = 100e6


def _cold_cases(c, cache_bytes):
    """Copies of a case's cache (K, V and the scale planes) for cold
    timings: enough to exceed ``COLD_BYTES`` together (4 to 64)."""
    n = min(64, max(4, -(-int(COLD_BYTES) // max(int(cache_bytes), 1))))
    keys = [key for key in ("k", "v", "k_scale", "v_scale") if key in c]
    return [c] + [dict(c, **{key: c[key].clone() for key in keys})
                  for _ in range(n - 1)]


def _walk(copies, call):
    """A function that calls ``call`` on the next copy each time."""
    state = {"i": 0}

    def fn():
        c = copies[state["i"] % len(copies)]
        state["i"] += 1
        return call(c)
    return fn


def decode_phase(dev):
    rows = {"decode_attention": [], "decode_attention_q8": []}
    for kname, name, c in decode_cases(dev):
        quant = c["bits"] is not None
        kw = dict(scale=64 ** -0.5, window=c["window"])

        def call(x):
            sc = dict(k_scale=x["k_scale"], v_scale=x["v_scale"]) \
                if quant else {}
            return decode_attention(x["q"], x["k"], x["v"], x["t"], **kw,
                                    **sc)

        def plain(x):
            sc = dict(k_scale=x["k_scale"], v_scale=x["v_scale"]) \
                if quant else {}
            return decode_attention_reference(x["q"], x["k"], x["v"],
                                              x["t"], **kw, **sc)

        before = kernels.launch_counts()[kname]
        out = call(c)
        torch.cuda.synchronize()
        if kernels.launch_counts()[kname] != before + 1:
            raise AssertionError(f"{name} did not launch {kname}")
        ref = plain(c)
        err = (out - ref).abs().max().item()
        same = torch.equal(out, call(c))
        tol = KERNEL_Q_TOL if quant else KERNEL_BF16_TOL
        # each input read once, each output written once: K and V over
        # the valid positions (payload, plus the scale planes for int8),
        # q in, the float32 out
        lo, hi = valid_range(c["t"], c["window"])
        n = hi - lo + 1
        rws, g = c["k"].shape[0], c["g"]
        length = c["k"].shape[1]
        esize = c["k"].element_size()
        nbytes = 2 * rws * n * 64 * esize + rws * g * 64 * (
            c["q"].element_size() + 4)
        cache_bytes = 2 * rws * length * 64 * esize
        if quant:
            nbytes += 2 * rws * n * 4
            cache_bytes += 2 * rws * length * 4
        flops = 4.0 * rws * g * n * 64
        bms, by = bound_ms(flops, nbytes, PEAK_INT8_OPS if quant
                           else PEAK_BF16_FLOPS)
        per_call = kernels_per_call(lambda: call(c))
        # device time per call from graph replays: warm (one cache, in
        # L2 after the first replay) and cold (replays walk copies of
        # the cache that exceed the L2); the eager call's time is the
        # host's (wrapper and launch), reported beside them
        copies = _cold_cases(c, cache_bytes)
        ms = graph_ms(lambda: call(c))
        cold_ms = graph_ms(_walk(copies, call))
        eager_ms = time_ms(lambda: call(c), iters=50)
        plain_ms = graph_ms(lambda: plain(c), iters=10)
        lib_ms = lib_cold = None
        if not quant:
            lib_ms = graph_ms(lambda: _sdpa_decode(c))
            lib_cold = graph_ms(_walk(copies, _sdpa_decode))
        walked = cache_bytes * len(copies)
        del copies
        lib = "none" if lib_ms is None else \
            f"{lib_ms:.4f} ms warm, {lib_cold:.4f} ms cold"
        print(f"{kname} {name}: max_abs_err {err:.3e} (tol {tol}); bitwise "
              f"repeat {same}; {per_call:g} CUDA kernels a call; kernel "
              f"{ms:.4f} ms warm, {nbytes / ms / 1e6:.0f} GB/s, "
              f"{100 * bms / ms:.1f}% of the bound; {cold_ms:.4f} ms cold "
              f"({walked / 1e6:.0f} MB walked), {nbytes / cold_ms / 1e6:.0f}"
              f" GB/s, "
              f"{100 * bms / cold_ms:.1f}% of the bound (graph replay; "
              f"eager call {eager_ms:.4f} ms); plain {plain_ms:.4f} ms; "
              f"sdpa {lib}; bound {bms:.4f} ms ({by})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{kname} disagrees with its plain version "
                                 f"on {name}")
        if not same:
            raise AssertionError(f"{kname} is not bitwise repeatable on "
                                 f"{name}")
        rows[kname].append(dict(name=name, err=err, ms=ms, cold_ms=cold_ms,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bms, bound_by=by,
                                kernels_per_call=per_call))
    return rows


# --- phase 10: generate() end to end -----------------------------------------

GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 1024, 128
GEN_KERNEL = {None: "decode_attention", "int8": "decode_attention_q8"}


def _timed_generate(model, prompts, n, cache_dtype):
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(prompts, n, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.launch_counts()


def generate_phase(model, card):
    """Greedy ``generate()`` with the bf16 and the int8 cache: a 1-token
    call times the prefill, the 128-token call the whole run; the
    launch counts of each call are checked."""
    vocab = model.module.layers[0].vocab_size
    num_layers = LM_CFG["num_layers"]
    prompts = np.random.RandomState(SEED + 6).randint(
        0, vocab, (GEN_BATCH, GEN_PROMPT))
    steps = GEN_NEW - 1
    out_rows = {}
    for cache_dtype, kname in GEN_KERNEL.items():
        other = [k for k in GEN_KERNEL.values() if k != kname][0]
        model.generate(prompts[:, :64], 4, cache_dtype=cache_dtype)  # warm
        _, t_prefill, c1 = _timed_generate(model, prompts, 1, cache_dtype)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, t_all, c = _timed_generate(model, prompts, GEN_NEW, cache_dtype)
        peak = torch.cuda.max_memory_allocated() - base
        for counts, want in ((c1, 0), (c, num_layers * steps)):
            if counts["flash_fwd"] != num_layers or counts[kname] != want \
                    or counts[other] != 0:
                raise AssertionError(
                    f"generate(cache_dtype={cache_dtype}) launched "
                    f"{counts}; expected flash_fwd {num_layers}, {kname} "
                    f"{want}, {other} 0")
        if out.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW) \
                or not np.array_equal(out[:, :GEN_PROMPT], prompts) \
                or not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"generate(cache_dtype={cache_dtype}) "
                                 "returned a malformed token array")
        decode_s = t_all - t_prefill
        label = "bf16" if cache_dtype is None else cache_dtype
        print(f"generate on {card}: cache {label}, B{GEN_BATCH} prompt "
              f"{GEN_PROMPT} + {GEN_NEW} greedy tokens: prefill (1-token "
              f"call) {t_prefill * 1e3:.1f} ms; whole call "
              f"{t_all * 1e3:.1f} ms; decode {decode_s * 1e3 / steps:.2f} "
              f"ms/step, {GEN_BATCH * steps / decode_s:.1f} tok/s; launches "
              f"flash_fwd {c['flash_fwd']}, {kname} {c[kname]}; peak "
              f"allocated {peak} bytes above the {base} allocated before the "
              f"call; K2 workspace {_k2_workspace_bytes()} bytes",
              flush=True)
        out_rows[kname] = c[kname]
        out_rows.setdefault("flash_fwd", c["flash_fwd"])
    return out_rows, prompts


def _k2_workspace_bytes() -> int:
    """The bytes of K2's per-device workspace (arrival counters and
    split partials), 0 where the package keeps none."""
    mod = sys.modules["distkeras_tpu_torch.ops.decode_attention"]
    return sum(x.numel() * x.element_size()
               for pair in getattr(mod, "_workspaces", {}).values()
               for x in pair)


#: what a decode-attention kernel's name holds in a profile (and a paged
#: one's does not)
K2_KEY = "decode"


def profile_generate(model, prompts):
    """Where the time goes in generate()'s decode step (bf16 cache, B4 at
    t ~ 1030): the step's wall time without the profiler, then
    ``torch.profiler`` over a few steps: device time per kernel and the
    device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    b, p_len = prompts.shape
    n_plain, n_prof = 16, 8
    with torch.inference_mode():
        params = _generate_params(model, "auto", torch.bfloat16)
        cache = init_cache(model.module, b, p_len + 2 + n_plain + n_prof,
                           torch.bfloat16, model.device)
        logits, cache = prefill(model.module, params, cache,
                                torch.as_tensor(prompts, device=model.device))
        tok = torch.argmax(logits, dim=-1)
        t = p_len
        for _ in range(2):
            logits, _ = decode_step(model.module, params, cache, tok, t)
            tok, t = torch.argmax(logits, dim=-1), t + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_plain):
            logits, _ = decode_step(model.module, params, cache, tok, t)
            tok, t = torch.argmax(logits, dim=-1), t + 1
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_plain
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                logits, _ = decode_step(model.module, params, cache, tok, t)
                tok, t = torch.argmax(logits, dim=-1), t + 1
            torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3 / n_prof
    n_kernels = sum(e.count for e in ops) / n_prof
    k2 = [e for e in ops if K2_KEY in e.key and "paged" not in e.key]
    k2_ms = sum(e.self_device_time_total for e in k2) / 1e3 / n_prof
    k2_n = sum(e.count for e in k2) / n_prof
    print(f"profile-generate: decode step, B{b}, t ~{p_len}: {step_ms:.2f} "
          f"ms/step wall (profiler off); device busy {busy_ms:.3f} ms/step "
          f"= {100 * busy_ms / step_ms:.1f}% of the step; {n_kernels:.0f} "
          f"CUDA kernel launches a step; decode-attention kernels "
          f"{k2_ms:.4f} ms/step in {k2_n:g} launches", flush=True)
    for e in ops[:10]:
        per_step = e.self_device_time_total / 1e3 / n_prof
        print(f"profile-generate:   {per_step:7.3f} ms/step  "
              f"x{e.count // n_prof:<4d} {e.key[:72]}", flush=True)


def decode_logits_vs_cpu(model, prompt):
    """One decode step's logits on the card against the port's plain
    path on the CPU in float32: the card prefills the prompt into its
    cache, the CPU takes a copy of that cache (float32 of the bf16
    values; int8 payloads and scales as they are), then both run the
    same decode step at position len(prompt). Cases: bf16 weights with
    the bf16 cache and with the int8 cache (as generate() runs them), and
    float32 throughout."""
    f32 = build_lm("cpu", dtype="float32")
    f32.module.load_state_dict(model.module.state_dict())
    f32_card = copy.deepcopy(f32).to(model.device)
    p_len = len(prompt)
    tokens = torch.as_tensor(prompt[None], dtype=torch.long)
    out = {}
    for label, m, cache_dtype in (("bf16", model, torch.bfloat16),
                                  ("int8", model, "int8"),
                                  ("float32", f32_card, torch.float32)):
        with torch.inference_mode():
            params = _generate_params(m, "auto", torch.bfloat16
                                      if m is model else torch.float32)
            cache = init_cache(m.module, 1, p_len + 1, cache_dtype, m.device)
            logits, cache = prefill(m.module, params, cache,
                                    tokens.to(m.device))
            tok = torch.argmax(logits, dim=-1)
            cpu_cache = [None if kv is None else {
                key: (a.float() if a.is_floating_point() else a).cpu()
                if torch.is_tensor(a) else a for key, a in kv.items()}
                for kv in cache]
            card, _ = decode_step(m.module, params, cache, tok, p_len)
            ref, _ = decode_step(f32.module, f32.params, cpu_cache,
                                 tok.cpu(), p_len)
        card = card.float().cpu()
        scale = ref.abs().max().item()
        out[label] = (card - ref).abs().max().item() / scale
    return out


# --- phase 14: speculative serving end to end --------------------------------

SPEC_K, SPEC_WIDTH = 4, 2
#: a speculative stream may part from the plain engine's stream only
#: at a near-tie of the plain path's CPU float32 scores, within the bf16
#: path's own error. The verify window's GEMMs round otherwise than the
#: one-token step's, and each bf16 path's logits lie within the error
#: phases 5 and 10 measure against the CPU float32 path (relative to
#: max |logit|; 1.2e-2 and 7.9e-3 on the H100, where a bf16 logit near
#: max |logit| has an ulp of up to 2^-7 of it); two bf16 paths can order
#: two logits differently only where the float32 gap is within twice
#: that error, so the tie bound is twice the larger of the two errors
#: measured in the same run
TIE_ERR_FACTOR = 2.0
SPEC_KERNELS = ("paged_decode", "paged_decode_anc", "paged_decode_q8_anc",
                "paged_decode_q4_anc")


def motif_workload(vocab: int, n: int):
    """``n`` greedy requests whose prompts repeat one random 64-token
    motif (what the n-gram draft can look up)."""
    rs = np.random.RandomState(SEED + 7)
    motif = rs.randint(0, vocab, 64)
    return [(np.tile(motif, 12)[:n_tok], {})
            for n_tok in (300, 520, 130, 700)[:n]]


def _cpu_choice(f32, context, kw, index, favour, eps_rel):
    """The plain path's choice of the token after ``context`` from the
    CPU float32 logits, pushed by ``eps_rel`` of max |logit| towards
    ``favour`` (its logit raised, every other lowered by that much):
    the argmax for a greedy request; for a sampled one the argmax of
    the temperature-scaled, top-k / nucleus-masked logits plus the
    Gumbel field of its ``index``-th draw (the request's key chain:
    ``PRNGKey(seed)``, one split per generated token, whatever the
    schedule). A sampled request also tries the other corner of the
    same box when the first does not pick ``favour``: the unpushed
    choice lowered and every other logit raised by that much, which
    takes a choice sitting at the top-k or nucleus edge out of the
    candidates (in bf16 neighbouring logits tie there, and one ulp moves
    a token across the edge). Returns ``(choice, top-2 gap of the
    unpushed scores relative to max |logit|)``."""
    with torch.inference_mode():
        cache = init_cache(f32.module, 1, len(context), torch.float32, "cpu")
        logits, _ = prefill(f32.module, f32.params, cache,
                            torch.as_tensor(context[None], dtype=torch.long))
    logits = logits[0].float()
    scale = float(logits.abs().max())
    push = torch.full_like(logits, -eps_rel * scale)
    push[favour] = eps_rel * scale
    if not kw.get("temperature"):
        top2 = torch.topk(logits, 2).values
        return (int(torch.argmax(logits + push)),
                float(top2[0] - top2[1]) / scale)
    rng = prng.key(kw.get("seed", 0))
    for _ in range(index + 1):
        rng, sub = prng.split(rng)
    noise = prng.gumbel(sub, logits.shape)
    one = torch.ones(1)

    def scores(lg):
        lf = _masked_logits_vec(lg[None], one * kw["temperature"],
                                torch.tensor([kw.get("top_k", 0) or 0]),
                                one * kw.get("top_p", 1.0))[0]
        return lf + noise

    top2 = torch.topk(scores(logits), 2).values
    choice = int(torch.argmax(scores(logits + push)))
    if choice != favour:
        edge = torch.full_like(logits, eps_rel * scale)
        edge[int(torch.argmax(scores(logits)))] = -eps_rel * scale
        choice = int(torch.argmax(scores(logits + edge)))
    return choice, float(top2[0] - top2[1]) / scale


def check_identity(f32, plain, spec, requests, label, tie_rel):
    """Each stream of a run (speculative, or another loop's) against the
    plain engine's stream of the same request: equal, or parting at a
    near-tie of the plain path's CPU float32 scores, compared up to
    there. A near-tie: logits moved by half the tie bound (each bf16
    path's own error) in the run's token's favour make the float32 path
    choose it (for a
    greedy request: a top-2 gap within the bound; for a sampled one
    this also covers a candidate at the top-k or nucleus edge).
    Returns the number of streams that parted."""
    parted = 0
    for (rid, prompt), (prid, _), (_, kw) in zip(spec[0], plain[0],
                                                 requests):
        a, b = plain[1][prid], spec[1][rid]
        diff = np.flatnonzero(a != b)
        if not diff.size:
            continue
        pos = int(diff[0])
        choice, gap = _cpu_choice(f32, a[:pos], kw, pos - len(prompt),
                                  int(b[pos]), tie_rel / 2)
        print(f"{label}: request {rid} parts from the plain "
              f"stream at generated token {pos - len(prompt)} (plain "
              f"{a[pos]}, this run {b[pos]}); CPU float32 top-2 gap "
              f"{gap:.2e} of max |logit|; pushed by {tie_rel / 2:.2e} "
              f"towards this run's token the float32 path picks "
              f"{choice}", flush=True)
        if choice != int(b[pos]):
            raise AssertionError(f"{label}: request {rid} "
                                 "parts from the plain stream away from a "
                                 "near-tie")
        parted += 1
    return parted


def _time_calls(obj, names):
    """Wrap the named methods of ``obj`` to add up their wall time (the
    card synchronised around each call) and count the calls; returns
    the ``[seconds, calls]`` box."""
    box = [0.0, 0]
    for name in names:
        fn = getattr(obj, name)

        def timed(*args, _fn=fn, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            box[0] += time.perf_counter() - t0
            box[1] += 1
            return out

        setattr(obj, name, timed)
    return box


def spec_phase(model, card, tie_rel):
    """Speculative serving on the 218M LM: (a) self-draft linear and (b)
    self-draft trees on phase 5's workload, (c) n-gram linear on motif
    prompts, (d) n-gram trees with int8 and int4 pages on two motif
    prompts; each against the plain engine on the same requests in this
    run, with launch counts read around each speculative run."""
    vocab = model.module.layers[0].vocab_size
    f32 = build_lm("cpu", dtype="float32")
    f32.module.load_state_dict(model.module.state_dict())
    runs = [
        ("self-draft linear", "serving_spec_linear", None, None,
         dict(draft=DraftModel(model), spec_k=SPEC_K)),
        ("self-draft tree", "serving_spec_tree", None, None,
         dict(draft=DraftModel(model), spec_k=SPEC_K, spec_tree=True,
              spec_width=SPEC_WIDTH)),
        ("n-gram linear", "serving_spec_ngram", 4, None,
         dict(draft=NgramDraft(), spec_k=SPEC_K)),
        ("n-gram tree int8", "serving_spec_tree_int8", 2, "int8",
         dict(draft=NgramDraft(), spec_k=SPEC_K, spec_tree=True,
              spec_width=SPEC_WIDTH)),
        ("n-gram tree int4", "serving_spec_tree_int4", 2, "int4",
         dict(draft=NgramDraft(), spec_k=SPEC_K, spec_tree=True,
              spec_width=SPEC_WIDTH)),
    ]
    # first calls of the verify shapes, the draft step and the sort of a
    # tree draft stay out of the measured runs
    rs = np.random.RandomState(SEED + 8)
    for _, _, _, cache_dtype, spec in runs:
        eng = ServingEngine(model, num_slots=2, max_len=2048, page_len=16,
                            prefill_chunk=256, cache_dtype=cache_dtype,
                            device=model.device, **spec)
        eng.submit(rs.randint(0, vocab, 40), 8)
        eng.run(max_steps=100)
    plains = {}
    launches = {}
    for label, path, n_motif, cache_dtype, spec in runs:
        requests = workload(vocab) if n_motif is None \
            else motif_workload(vocab, n_motif)
        key = (n_motif, cache_dtype)
        if key not in plains:
            eng, reqs, out, bad, steps = serve(model, model.device,
                                               cache_dtype=cache_dtype,
                                               requests=requests)
            check_finished(reqs, out, bad)
            plains[key] = (reqs, out, eng.metrics.summary())
        # where a speculative iteration's time goes: the draft's
        # proposals against the rest of the decode phase (verify, walk,
        # commit, page growth)
        drafting = _time_calls(spec["draft"], ("propose", "propose_tree"))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng, reqs, out, bad, steps = serve(model, model.device,
                                           cache_dtype=cache_dtype,
                                           requests=requests, **spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = kernels.launch_counts()
        for name in ("propose", "propose_tree"):
            del spec["draft"].__dict__[name]
        check_finished(reqs, out, bad)
        parted = check_identity(f32, plains[key], (reqs, out), requests,
                                f"speculation {label}", tie_rel)
        s = eng.metrics.summary()
        emitted = len(reqs) * NEW_TOKENS
        # a tree's acceptance counts every node offered (at most depth of
        # 2 x depth nodes can be accepted at width 2): its self-draft
        # check reads the longest-chain basis, accepted path / depth
        acc = s["speculation"]["path_acceptance_rate"] \
            if spec.get("spec_tree") else s["acceptance_rate"]
        print(f"speculation {label} on {card}: {len(reqs)} requests in "
              f"{wall:.2f} s, {steps} iterations for {emitted} tokens "
              f"({emitted / steps:.2f} tokens/iteration); acceptance "
              f"{s['acceptance_rate']} (path / depth "
              f"{s['speculation']['path_acceptance_rate']}; proposed "
              f"{s['speculation']['proposed']}, accepted "
              f"{s['speculation']['accepted']}, disabled streams "
              f"{s['speculation']['disabled_streams']}); decode "
              f"{s['decode_tokens_per_sec']:.1f} tok/s (plain engine "
              f"{plains[key][2]['decode_tokens_per_sec']:.1f}); TTFT p50 "
              f"{s['ttft_s']['p50'] * 1e3:.1f} ms p99 "
              f"{s['ttft_s']['p99'] * 1e3:.1f} ms; decode phase "
              f"{s['phases']['decode']:.3f} s (plain engine "
              f"{plains[key][2]['phases']['decode']:.3f} s), of which "
              f"drafting {drafting[0]:.3f} s in {drafting[1]} speculative "
              f"iterations; preemptions "
              f"{s['requests_preempted']}; streams parted from plain "
              f"{parted}/{len(reqs)}; launches "
              f"{ {k: c[k] for k in SPEC_KERNELS + ('flash_fwd',)} }",
              flush=True)
        want = {"serving_spec_linear": "paged_decode",
                "serving_spec_ngram": "paged_decode",
                "serving_spec_tree": "paged_decode_anc",
                "serving_spec_tree_int8": "paged_decode_q8_anc",
                "serving_spec_tree_int4": "paged_decode_q4_anc"}[path]
        if c[want] < 1:
            raise AssertionError(f"speculation {label} never launched "
                                 f"{want}: {c}")
        if spec.get("spec_tree") is None and any(
                c[k] for k in SPEC_KERNELS[1:]):
            raise AssertionError(f"the linear run {label} launched an anc "
                                 f"kernel: {c}")
        if isinstance(spec["draft"], DraftModel) and not (
                acc is not None and acc > 0.5 and steps < emitted):
            raise AssertionError(f"self-draft {label}: acceptance {acc}, "
                                 f"{steps} iterations for {emitted} tokens")
        launches[path] = c
    return launches


# --- phase 15: the quantized matmul (K5) ------------------------------------

#: float32 products and sums on both sides (bf16 activations are exact
#: in float32); only the summation order differs, over up to 4096 terms
QMM_TOL = 1e-4
QMM_M = (4, 1, 8, 72)           # the first: the engine's 4 decode slots
#: the 218M LM's matrices (name, shape, scale reduce axes); the first is
#: the row the kernels line reports
QMM_SHAPES = (("w1 1024->4096", (1024, 4096), None),
              ("wq 1024->16x64", (1024, 16, 64), (0,)),
              ("wo 16x64->1024", (16, 64, 1024), (0, 1)),
              ("w2 4096->1024", (4096, 1024), None),
              ("head 1024->32768", (1024, 32768), None),
              ("ragged 1000->1000", (1000, 1000), None))


def qmm_phase(dev, bits):
    """K5 (``bits`` 8 or 4) against ``reference_matmul`` at the LM's
    matrices and a ragged one, M in (1, 4, 8, 72), bf16 activations
    (what the engine's decode step gives it): device times from
    CUDA-graph replays; the library yardstick is ``torch.matmul``
    against the bf16 weight the quantization replaces."""
    rows = []
    name = f"quant_matmul_q{bits}"
    rs = np.random.RandomState(SEED + 9)
    for label, shape, reduce_axes in QMM_SHAPES:
        w = torch.from_numpy((rs.randn(*shape) * 0.02).astype(np.float32))
        wq = {k: v.to(dev) for k, v in
              quantize_weight(w, bits, reduce_axes).items()}
        k = int(np.prod(shape[:len(reduce_axes or (0,))]))
        n = w.numel() // k
        w_bf16 = w.reshape(k, n).to(dev, torch.bfloat16)
        for m in QMM_M:
            x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(
                dev, torch.bfloat16)
            before = kernels.launch_counts()[name]
            out = quant_matmul(x, wq)
            torch.cuda.synchronize()
            if kernels.launch_counts()[name] != before + 1:
                raise AssertionError(f"{label} did not launch {name}")
            ref = reference_matmul(x, wq)
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ms = graph_ms(lambda: quant_matmul(x, wq))
            plain_ms = graph_ms(lambda: reference_matmul(x, wq), iters=10)
            lib_ms = graph_ms(lambda: torch.matmul(x, w_bf16))
            pack = "" if bits == 4 else _int8pack_ms(x, wq, k, n)
            wbytes = k * n // (2 if bits == 4 else 1)
            nbytes = wbytes + 4 * n + 2 * m * k + 4 * m * n
            bms, by = bound_ms(2.0 * m * k * n, nbytes, PEAK_BF16_FLOPS)
            case = f"{label} M{m}"
            print(f"{name} {case}: max_abs_err {err:.3e}, rel {rel:.2e} "
                  f"(tol {QMM_TOL}); kernel {ms:.4f} ms (graph replay), "
                  f"{nbytes / ms / 1e6:.0f} GB/s, {100 * bms / ms:.1f}% of "
                  f"the bound; plain {plain_ms:.4f} ms, torch.matmul bf16 "
                  f"weight {lib_ms:.4f} ms{pack}, bound {bms:.4f} ms ({by})",
                  flush=True)
            if not rel <= QMM_TOL:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {case}")
            rows.append(dict(name=case, err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by))
    x = torch.from_numpy(rs.randn(72, k).astype(np.float32)).to(dev)
    if not torch.equal(quant_matmul(x, wq), quant_matmul(x, wq)):
        raise AssertionError(f"{name} is not bitwise repeatable")
    return rows


def _int8pack_ms(x, wq, k, n) -> str:
    """The int8 yardstick (never called by the port):
    ``torch._weight_int8pack_mm`` computes ``(x @ q) * scale`` from the
    same bytes, transposed to ``[N, K]`` outside the timing, where this
    card's torch runs it on CUDA; graph replay."""
    qt = wq["q"].reshape(k, n).t().contiguous()
    sc = wq["scale"].reshape(n).to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, qt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return (f", torch._weight_int8pack_mm does not run on CUDA here "
                f"({str(exc).splitlines()[0][:60]})")
    ms = graph_ms(lambda: torch._weight_int8pack_mm(x, qt, sc))
    return f", torch._weight_int8pack_mm {ms:.4f} ms"


# --- phase 16: the fused sampling epilogue (K4) -----------------------------

#: the rows' knobs: greedy, top-k + top-p, top-p only, top-k only, k = 1,
#: k >= V, both cuts, p <= 0, +-0.0 logits at the k-th value (K4_ZERO_ROW),
#: and last the top-k at a forced tie
K4_TEMP = (0.0, 0.7, 1.0, 1.3, 0.9, 1.1, 0.8, 1.2, 1.0, 1.0)
K4_TOPK = (0, 40, 0, 3, 1, 1 << 20, 7, 10, 6, 5)
K4_TOPP = (1.0, 0.9, 0.5, 1.0, 0.8, 1.0, 0.3, 0.0, 0.95, 1.0)
K4_ZERO_ROW = 8
#: phase 16's cases: rows, logits dtype (the vocab is the LM's)
K4_CASES = ((8, torch.float32), (4, torch.float32), (8, torch.bfloat16))


def k4_inputs(rs, s, v, dev, dtype=torch.float32):
    """``s`` rows of ``dtype`` logits with mixed knobs (the knob rows in
    turn from a seeded offset; with two rows or more the last is the tie
    row, its top 20 logits equal) and their Gumbel field from per-row
    keys (K7). The +-0.0 row is shifted so that its k-th largest value
    is 0, and its sorted ranks k-3 to k+2 hold +0.0 and -0.0 in turn."""
    n = len(K4_TEMP)
    logits = torch.from_numpy((rs.randn(s, v) * 3).astype(np.float32))
    off = rs.randint(n - 1)
    idx = [(off + i) % (n - 1) for i in range(s)]
    if s > 1:
        top = logits[s - 1].topk(min(20, v)).indices
        logits[s - 1, top] = logits[s - 1].max()
        idx[-1] = n - 1
    for row, i in enumerate(idx):
        k = K4_TOPK[i]
        if i == K4_ZERO_ROW and k + 3 <= v:
            x = logits[row]
            x -= x.topk(k).values[-1]
            ranks = x.topk(k + 3).indices[k - 3:]
            x[ranks] = torch.tensor([0.0, -0.0] * 3)
    temp = torch.tensor([K4_TEMP[i] for i in idx])
    keys = prng.split(prng.key(int(rs.randint(1 << 31))), s).to(dev)
    args = [a.to(dev) for a in (
        logits.to(dtype), temp, torch.tensor([K4_TOPK[i] for i in idx]),
        torch.tensor([K4_TOPP[i] for i in idx]))]
    return args + [gumbel_noise(keys, v)]


def k4_partings(out, ref, args, parted):
    """Add to ``parted`` the rows where K4 and its plain version part
    (``boundary_partings``: each must be a nucleus-boundary row) and
    fail past ``MAX_BOUNDARY_PARTINGS`` in one run."""
    parted += boundary_partings(out, ref, *args[:4])
    if len(parted) > MAX_BOUNDARY_PARTINGS:
        raise AssertionError(f"sample_epilogue parted from its plain version "
                             f"at {len(parted)} nucleus-boundary rows in one "
                             f"run (at most {MAX_BOUNDARY_PARTINGS}): "
                             f"{parted}")


def k4_margins(parted) -> str:
    return ", ".join(f"{mg:.1e} (tol {tol:.1e})"
                     for _, mg, tol in parted) or "none"


def k4_bound(args):
    """The least time for one call: the logits in their dtype and the
    float32 Gumbel rows the draw needs (a greedy row reads none) read
    once, the knobs read and the int64 tokens written once; a division,
    an exp, an add and a compare an entry at the float32 peak."""
    logits, temp = args[0], args[1]
    s, v = logits.shape
    sampled = int((temp > 0).sum())
    nbytes = s * v * logits.element_size() + sampled * v * 4 + s * 24
    return bound_ms(4.0 * s * v, nbytes, PEAK_F32_FLOPS) + (nbytes,)


def k4_phase(dev):
    """K4 against its plain version (``K4_CASES``, V = 32768), 8 draws a
    case: equal tokens, except rows at the nucleus boundary, which are
    counted; a bitwise repeat. The public ``sample_epilogue`` (one kernel
    a call) by graph replay, warm (one set of inputs, in L2) and cold
    (replays walking copies of the logits and the Gumbel field past the
    L2), and eager; its CUDA kernels a call (a captured graph's kernel
    nodes); the plain version eager. Only public calls are timed, so the
    phase also times an earlier checkout's sampler."""
    rows = []
    rs = np.random.RandomState(SEED + 10)
    v = LM_CFG["vocab"]
    for s, dtype in K4_CASES:
        name = f"S{s} V{v} {str(dtype).replace('torch.', '')}"
        parted, n_rows = [], 0
        for _ in range(8):
            args = k4_inputs(rs, s, v, dev, dtype)
            before = kernels.launch_counts()["sample_epilogue"]
            out = sample_epilogue(*args)
            torch.cuda.synchronize()
            if kernels.launch_counts()["sample_epilogue"] != before + 1:
                raise AssertionError("sample_epilogue did not launch")
            k4_partings(out, sample_epilogue_reference(*args), args, parted)
            n_rows += s
        same = torch.equal(out, sample_epilogue(*args))
        per_call = kernels_per_call(lambda: sample_epilogue(*args))
        copies = [args] + [[a.clone() if a.ndim == 2 else a for a in args]
                           for _ in range(int(COLD_BYTES) // (
                               args[0].nbytes + args[4].nbytes))]

        def call(a):
            return sample_epilogue(*a)
        ms = graph_ms(lambda: call(args))
        cold_ms = graph_ms(_walk(copies, call))
        del copies
        eager_ms = time_ms(lambda: sample_epilogue(*args), iters=20)
        plain_ms = time_ms(lambda: sample_epilogue_reference(*args),
                           iters=5)
        bms, by, nbytes = k4_bound(args)
        print(f"sample_epilogue {name}: {len(parted)} of {n_rows} rows "
              f"parted at the nucleus boundary (margins "
              f"{k4_margins(parted)}), all others equal; bitwise repeat "
              f"{same}; {per_call:g} CUDA kernels a call; sample_epilogue "
              f"{ms:.4f} ms warm, {nbytes / ms / 1e6:.0f} GB/s, "
              f"{100 * bms / ms:.1f}% of the bound, {cold_ms:.4f} ms cold, "
              f"{100 * bms / cold_ms:.1f}% (graph replay), {eager_ms:.4f} "
              f"ms eager; plain eager {plain_ms:.4f} ms; bound {bms:.4f} ms "
              f"({by})", flush=True)
        if not same:
            raise AssertionError(f"sample_epilogue is not bitwise "
                                 f"repeatable on {name}")
        # tokens are compared, not values: 0 off the boundary rows
        rows.append(dict(name=name, err=0.0, ms=ms, cold_ms=cold_ms,
                         eager_ms=eager_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bms, bound_by=by,
                         kernels_per_call=per_call))
    return rows


# --- phase 17: the quantized engine end to end ------------------------------

WQ_KERNEL = {"int8": "quant_matmul_q8", "int4": "quant_matmul_q4"}


class _Calls:
    """Count the calls of the named methods of a class, or functions of
    a module, while installed."""

    def __init__(self, owner, *names):
        self.owner, self.n = owner, 0
        self.orig = {name: getattr(owner, name) for name in names}

    def __enter__(self):
        for name, fn in self.orig.items():
            def counted(*args, _fn=fn, **kw):
                self.n += 1
                return _fn(*args, **kw)
            setattr(self.owner, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.owner, name, fn)


class _K4Watch:
    """While installed, every fused draw of the engine is also drawn by
    the plain version on the same inputs: the rows where they part are
    kept with their nucleus margins (each must be a boundary row, at
    most ``MAX_BOUNDARY_PARTINGS`` while installed)."""

    def __init__(self):
        self.mod = sys.modules["distkeras_tpu_torch.ops.sampling"]
        self.orig = self.mod.sample_epilogue
        self.parted = []

    def __enter__(self):
        def watched(*args):
            out = self.orig(*args)
            k4_partings(out, sample_epilogue_reference(*args), args,
                        self.parted)
            return out

        self.mod.sample_epilogue = watched
        return self

    def __exit__(self, *exc):
        self.mod.sample_epilogue = self.orig


def wq_logits_vs_cpu(model, qtree, prompt):
    """One decode step's logits on the card (bf16 compute over the
    engine's quantized tree, K5 in the step) against the plain path on
    the CPU in float32 over the same quantized bytes and scales, from a
    copy of the card's cache after the same prefill."""
    f32 = build_lm("cpu", dtype="float32")
    cpu_tree = [{k: _to_cpu(v) for k, v in p.items()} for p in qtree]
    p_len = len(prompt)
    tokens = torch.as_tensor(prompt[None], dtype=torch.long)
    with torch.inference_mode():
        cache = init_cache(model.module, 1, p_len + 1, torch.bfloat16,
                           model.device)
        logits, cache = prefill(model.module, qtree, cache,
                                tokens.to(model.device))
        tok = torch.argmax(logits, dim=-1)
        cpu_cache = [None if kv is None else {
            k: a.float().cpu() for k, a in kv.items()} for kv in cache]
        card, _ = decode_step(model.module, qtree, cache, tok, p_len)
        ref, _ = decode_step(f32.module, cpu_tree, cpu_cache, tok.cpu(),
                             p_len)
    scale = ref.abs().max().item()
    return (card.float().cpu() - ref).abs().max().item() / scale


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def wq_phase(model, card, bf16_summary):
    """The engine with quantized weights on phase 5's workload: int8 with
    fused sampling (and the same run unfused: the sampled stream must
    match, or part at a counted nucleus-boundary row), int4 over int4
    pages, and an n-gram tree run with int8; launch counts per run,
    resident weight bytes and peak memory, and decode-step logits
    against the CPU float32 path over the same quantized trees."""
    vocab = model.module.layers[0].vocab_size
    per_step = 6 * LM_CFG["num_layers"] + 1      # q, k, v, o, w1, w2; head
    runs = [("int8 fused sampling", "serving_wq_int8", "int8", None,
             dict(fused_sampling=True), None),
            ("int8 unfused", None, "int8", None, {}, None),
            ("int4 over int4 pages", "serving_wq_int4", "int4", "int4", {},
             None),
            ("int8 n-gram tree", "serving_wq_int8_spec_tree", "int8", None,
             dict(draft=NgramDraft(), spec_k=SPEC_K, spec_tree=True,
                  spec_width=SPEC_WIDTH), 2)]
    bf16_bytes = ServingEngine(model, num_slots=1, max_len=64,
                               device=model.device).param_bytes()
    launches, streams, trees = {}, {}, {}
    for label, path, wq, cache_dtype, kw, n_motif in runs:
        requests = workload(vocab) if n_motif is None \
            else motif_workload(vocab, n_motif)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        with _Calls(ServingEngine, "_advance_decode") as steps, \
                _K4Watch() as watch:
            eng, reqs, out, bad, _ = serve(model, model.device,
                                           cache_dtype=cache_dtype,
                                           requests=requests,
                                           weight_quant=wq, **kw)
            torch.cuda.synchronize()
        c = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        check_finished(reqs, out, bad)
        s = eng.metrics.summary()
        key = WQ_KERNEL[wq]
        other = WQ_KERNEL["int4" if wq == "int8" else "int8"]
        if c[key] < per_step * steps.n or c[other] != 0:
            raise AssertionError(f"serving {label}: {c[key]} {key} launches "
                                 f"for {steps.n} decode steps, {other} "
                                 f"{c[other]}")
        if kw.get("fused_sampling") and c["sample_epilogue"] < 1:
            raise AssertionError(f"serving {label} never launched "
                                 "sample_epilogue")
        if not kw.get("fused_sampling") and c["sample_epilogue"]:
            raise AssertionError(f"serving {label} launched sample_epilogue")
        print(f"serving weight_quant {label} on {card}: {len(reqs)} "
              f"requests, {steps.n} decode steps; launches {key} {c[key]}, "
              f"sample_epilogue {c['sample_epilogue']}, flash_fwd "
              f"{c['flash_fwd']}, paged {c['paged_decode']}/"
              f"{c['paged_decode_q4']}/{c['paged_decode_anc']}; resident "
              f"weights {eng.param_bytes()} bytes (bf16 engine "
              f"{bf16_bytes}); peak allocated during the run "
              f"{peak / 2**30:.3f} GiB above what was allocated before it; "
              f"TTFT p50 "
              f"{s['ttft_s']['p50'] * 1e3:.1f} ms p99 "
              f"{s['ttft_s']['p99'] * 1e3:.1f} ms; decode "
              f"{s['decode_tokens_per_sec']:.1f} tok/s (phase 5 bf16 "
              f"engine {bf16_summary['decode_tokens_per_sec']:.1f}); "
              f"fused draws parted at the nucleus boundary "
              f"{len(watch.parted)} (margins {k4_margins(watch.parted)})",
              flush=True)
        if path is not None:
            launches[path] = c
        if kw.get("fused_sampling"):
            fused_parted = len(watch.parted)
        streams[label] = [out[rid] for rid, _ in reqs]
        trees.setdefault(wq, eng._params)
        del eng
    fused, plain = streams["int8 fused sampling"], streams["int8 unfused"]
    for i, ((a, b), (_, kw)) in enumerate(zip(zip(fused, plain),
                                              workload(vocab))):
        if np.array_equal(a, b):
            continue
        if not (kw.get("temperature") and fused_parted):
            raise AssertionError(
                f"request {i}: the fused and unfused streams part, and no "
                "fused draw parted at a nucleus-boundary row")
        print(f"weight_quant int8: sampled request {i} parts from the "
              f"unfused stream after a counted nucleus-boundary draw",
              flush=True)
    prompt = workload(vocab)[0][0][:256]
    rels = {wq: wq_logits_vs_cpu(model, tree, prompt)
            for wq, tree in trees.items()}
    print(f"weight_quant decode-step logits vs CPU float32 over the same "
          f"quantized trees: int8 rel err {rels['int8']:.3e}, int4 "
          f"{rels['int4']:.3e} (tol {E2E_BF16_REL_TOL})", flush=True)
    if not all(r <= E2E_BF16_REL_TOL for r in rels.values()):
        raise AssertionError("quantized decode-step logits disagree with "
                             "the CPU plain path")
    return launches


# --- phase 18: generate() with int8 weights ---------------------------------


def generate_wq_phase(model, card, prompts):
    """``generate(weights_dtype="int8")``: B4 x 1024-token prompts and 32
    greedy tokens; prefill from a 1-token call; exact K5 and K2 launch
    counts."""
    steps = NEW_TOKENS - 1
    layers = LM_CFG["num_layers"]
    model.generate(prompts[:, :64], 4, weights_dtype="int8")      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate(prompts, 1, weights_dtype="int8")
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(prompts, NEW_TOKENS, weights_dtype="int8")
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    c = kernels.launch_counts()
    want = {"quant_matmul_q8": steps * (6 * layers + 1) + 1,
            "decode_attention": steps * layers, "flash_fwd": layers}
    if any(c[k] != n for k, n in want.items()):
        raise AssertionError(f"generate(weights_dtype='int8') launched {c}; "
                             f"expected {want}")
    if out.shape != (GEN_BATCH, GEN_PROMPT + NEW_TOKENS) \
            or not np.array_equal(out[:, :GEN_PROMPT], prompts) \
            or not ((out >= 0) & (out < LM_CFG["vocab"])).all():
        raise AssertionError("generate(weights_dtype='int8') returned a "
                             "malformed token array")
    decode_s = t_all - t_prefill
    print(f"generate int8 weights on {card}: B{GEN_BATCH} prompt "
          f"{GEN_PROMPT} + {NEW_TOKENS} greedy tokens: prefill (1-token "
          f"call) {t_prefill * 1e3:.1f} ms; decode "
          f"{decode_s * 1e3 / steps:.2f} ms/step, "
          f"{GEN_BATCH * steps / decode_s:.1f} tok/s; launches "
          f"{ {k: c[k] for k in want} }", flush=True)
    return c["quant_matmul_q8"]


# --- phase 19: the MoE expert up-projection with the gather fused (K6a) -----

MOE_EXPERTS, MOE_TOP_K = 8, 2
#: the MoE LM's expert widths: d_model 1024, expert hidden 2 x 1024
MOE_D, MOE_H = LM_CFG["d_model"], 2 * LM_CFG["d_model"]
#: bf16 outputs (|h| < 8 at these inputs) against the plain version's
#: float32 result before its cast (``k6a_reference``): the output's one
#: rounding (half a bf16 ulp, at most 2^-6 below 8) with the d-term sums
#: taken in another order. Two independently rounded bf16 values of
#: magnitude 4-8 can differ by a whole ulp (2^-5 = 0.03125: at the
#: training shape both the CUDA-core kernel and the tensor-core one do)
K6A_BF16_TOL = 2e-2
#: float32 on both sides: only the summation order over d = 1024 terms
K6A_F32_TOL = 1e-4
#: phase 19's cases: (label, tokens N, capacity C, d, H, routing). The
#: first six are the slice's shapes: a decode step of 4 slots (C = N,
#: decode_apply's drop-free capacity), an n-gram verify of 4 slots x 5,
#: an 8-slot tree of 9 nodes, a 256-token prefill chunk, a 2048-token
#: prefill (C = the layer's _capacity(N)) and phase 23's training batch
#: of 4 x 2048 tokens at capacity factor 1.0; then a routing that leaves
#: six experts empty, one that sends every token's first choice to one
#: expert, ragged widths, widths that are not multiples of 8 (70) or of
#: the tensor-core kernel's 128-wide tiles (136), and capacities that are
#: not multiples of its 64-row tiles (90, 33)
K6A_CASES = (("decode N4", 4, 4, MOE_D, MOE_H, "random"),
             ("verify N20", 20, 20, MOE_D, MOE_H, "random"),
             ("tree N72", 72, 72, MOE_D, MOE_H, "random"),
             ("prefill chunk N256", 256, 80, MOE_D, MOE_H, "random"),
             ("prefill N2048", 2048, 640, MOE_D, MOE_H, "random"),
             ("training N8192", 8192, 2048, MOE_D, MOE_H, "random"),
             ("empty experts N8", 8, 8, MOE_D, MOE_H, "two-experts"),
             ("one expert N64", 64, 64, MOE_D, MOE_H, "one-expert"),
             ("ragged d1000 H1000 N20", 20, 20, 1000, 1000, "random"),
             ("odd d70 H136 N300", 300, 90, 70, 136, "random"),
             ("odd d136 H70 N300", 300, 90, 136, 70, "random"),
             ("odd d70 H70 N300", 300, 90, 70, 70, "random"),
             ("odd d1000 H136 N256", 256, 33, 1000, 136, "random"))
#: the cases that also run in float32
K6A_F32_CASES = ("decode N4", "tree N72", "prefill chunk N256",
                 "ragged d1000 H1000 N20", "odd d70 H70 N300")
#: K6a's launches, by ``gemm1_plan``'s first field
K6A_LAUNCHES = {1: "tensor cores, one warpgroup a block",
                2: "tensor cores, two warpgroups a block",
                0: "CUDA cores"}


def moe_plan(rs, n, c, routing):
    """A real dispatch plan ``(dest, sg, keep)`` (on the CPU): top-2 of
    ``n`` tokens over 8 experts at capacity ``c``, by ``routing``."""
    if routing == "random":
        ex = np.argsort(rs.randn(n, MOE_EXPERTS), axis=1)[:, :MOE_TOP_K]
    elif routing == "two-experts":
        ex = np.tile([0, 1], (n, 1))
    else:                                    # every first choice on 3
        ex = np.stack([np.full(n, 3), (4 + rs.randint(0, 7, n)) % 8], 1)
    g = rs.rand(n, MOE_TOP_K).astype(np.float32)
    dest, _, sg, keep = _dispatch_plan(torch.from_numpy(ex),
                                       torch.from_numpy(g), MOE_EXPERTS, c)
    return dest, sg, keep


def _randn(rs, dtype, dev, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(
        np.float32)).to(dev, dtype)


def k6a_reference(xt, src, w1, b1, c, activation="gelu"):
    """What K6a is held against: the plain version on the same values in
    float32, before its cast to the input dtype (for float32 inputs, the
    plain version itself)."""
    return gather_gemm1_reference(xt.float(), src, w1.float(), b1.float(),
                                  c, activation)


def k6a_inputs(rs, n, c, d, h, routing, dtype, dev):
    """K6a's operands for one case: a real dispatch plan (top-2 of ``n``
    tokens over 8 experts, inverted to ``src_tok``), x ``[n, d]``, w1 and
    a non-zero b1 in ``dtype`` on ``dev``."""
    dest, _, _ = moe_plan(rs, n, c, routing)
    src = src_tokens(dest, n, MOE_EXPERTS, c).to(dev)
    return (_randn(rs, dtype, dev, n, d), src,
            _randn(rs, dtype, dev, MOE_EXPERTS, d, h, scale=0.03),
            _randn(rs, dtype, dev, MOE_EXPERTS, h, scale=0.1))


def k6a_phase(dev):
    """K6a against ``gather_gemm1_reference`` on the same plan at the
    slice's shapes and the edge cases, bf16 and float32: graph-replay
    times with the achieved TFLOP/s (on the filled rows' work) and the
    bound's share, the bound from this run's plan (only the experts a
    token reached stream w1, only filled rows are computed), the plain
    version's time and, as a yardstick, ``torch.baddbmm`` on a
    pre-gathered ``[E, C, d]`` buffer (no gather, no activation: no
    single PyTorch call computes K6a); a bitwise repeat."""
    rows = []
    rs = np.random.RandomState(SEED + 12)
    for dtype, tol, peak, cases in (
            (torch.bfloat16, K6A_BF16_TOL, PEAK_BF16_FLOPS, K6A_CASES),
            (torch.float32, K6A_F32_TOL, PEAK_F32_FLOPS,
             [c for c in K6A_CASES if c[0] in K6A_F32_CASES])):
        for label, n, c, d, h, routing in cases:
            xt, src, w1, b1 = k6a_inputs(rs, n, c, d, h, routing, dtype, dev)
            before = kernels.launch_counts()["moe_gather_gemm1"]
            out = gather_gemm1(xt, src, w1, b1, c)
            torch.cuda.synchronize()
            if kernels.launch_counts()["moe_gather_gemm1"] != before + 1:
                raise AssertionError(f"K6a {label} did not launch")
            ref = k6a_reference(xt, src, w1, b1, c)
            err = (out.float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ok = err <= tol if dtype == torch.bfloat16 else rel <= tol
            if not torch.equal(out, gather_gemm1(xt, src, w1, b1, c)):
                raise AssertionError(f"K6a {label} is not bitwise "
                                     "repeatable")
            heavy = n >= 256
            ms = graph_ms(lambda: gather_gemm1(xt, src, w1, b1, c),
                          iters=10 if heavy else 50)
            plain_ms = graph_ms(
                lambda: gather_gemm1_reference(xt, src, w1, b1, c), iters=10)
            tok = src.long().reshape(MOE_EXPERTS, c)
            xe = torch.where((tok >= 0)[..., None], xt[tok.clamp(min=0)],
                             torch.zeros((), dtype=dtype, device=dev))
            b1b = b1[:, None]
            lib_ms = graph_ms(lambda: torch.baddbmm(b1b, xe, w1),
                              iters=10 if heavy else 50)
            src_np = src.cpu().numpy().reshape(MOE_EXPERTS, c)
            filled = int((src_np >= 0).sum())
            active = int((src_np >= 0).any(axis=1).sum())
            es = xt.element_size()
            nbytes = (n * d + active * d * h + MOE_EXPERTS * h
                      + MOE_EXPERTS * c * h) * es + MOE_EXPERTS * c * 4
            flops = 2.0 * filled * d * h
            bms, by = bound_ms(flops, nbytes, peak)
            bf16 = es == 2
            case = f"{label} C{c} {'bf16' if bf16 else 'f32'}"
            plan = gemm1_plan(c, d, h, MOE_EXPERTS,
                              kernels.num_sms(dev.index), bf16)
            print(f"moe_gather_gemm1 {case} ({routing} routing, {active} "
                  f"experts reached, {filled} filled rows, launch "
                  f"{K6A_LAUNCHES[plan[0]]}): max_abs_err {err:.3e}, rel "
                  f"{rel:.2e} against the float32 plain result (tol {tol} "
                  f"{'max abs' if bf16 else 'relative'}"
                  f"); kernel {ms:.4f} ms (graph replay; "
                  f"{flops / (ms * 1e9):.1f} TFLOP/s, "
                  f"{nbytes / (ms * 1e6):.0f} GB/s, {bms / ms:.1%} of the "
                  f"bound), plain {plain_ms:.4f} ms, baddbmm on a "
                  f"pre-gathered buffer {lib_ms:.4f} ms, bound {bms:.4f} ms "
                  f"({by}); bitwise repeat ok", flush=True)
            if not ok:
                raise AssertionError(f"K6a disagrees with its plain version "
                                     f"on {case}")
            rows.append(dict(name=case, err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by))
            del xt, src, w1, b1, out, ref, xe
    return rows


# --- phase 20: MoE serving end to end ----------------------------------------


def build_moe_lm(device, *, num_layers=LM_CFG["num_layers"],
                 dtype="bfloat16", dispatch="dense", aux_loss_weight=0.0,
                 capacity_factor=1.25):
    """The all-MoE LM of ``bench.py`` ``bench_moe`` at ``LM_CFG`` widths
    (8 experts, top-2, expert hidden 2 x d_model; ~520M parameters at 12
    layers), built as ``_build_moe_serve_model`` builds it: dense
    dispatch, seed 0; ``bench_moe``'s training model passes
    ``MOE_TRAIN_KW``."""
    return built_on_card(
        zoo.transformer_lm(LM_CFG["vocab"], d_model=LM_CFG["d_model"],
                           num_heads=LM_CFG["num_heads"],
                           num_layers=num_layers, mlp_ratio=2, dtype=dtype,
                           moe_every=1, num_experts=MOE_EXPERTS,
                           moe_dispatch=dispatch,
                           moe_aux_loss_weight=aux_loss_weight,
                           moe_capacity_factor=capacity_factor),
        device)


class _RouteLog:
    """While installed, keep every ``MoE._route`` call's top-k expert
    ids (on the host) in call order: two runs of the same tokens through
    the same layers can then be compared expert choice by expert
    choice. Calls made while ``paused`` are not kept."""

    def __init__(self):
        self.orig = MoE._route
        self.topi = []
        self.paused = False

    def __enter__(self):
        orig = self.orig

        def logged(layer, x, gate):
            out = orig(layer, x, gate)
            if not self.paused:
                self.topi.append(out[1].cpu())
            return out

        MoE._route = logged
        return self

    def __exit__(self, *exc):
        MoE._route = self.orig


def routing_flips(a, b) -> int:
    """Token-layer pairs whose top-k expert SETS differ between two
    ``_RouteLog`` records of the same calls."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a.topi, b.topi))


class _Forced:
    """A teacher-forced engine run. Installed on an engine whose requests
    are submitted, it replaces every token the engine chooses (the
    prefill's first token, each decode step's, each verify walk's) by
    the next token of ``streams[i]`` (the generated tokens of an earlier
    run of the ``i``-th request), and keeps, for each generated token
    that a decode or verify step computed, the step's logits (on the
    card) and the top-k expert set, in every MoE layer, of the input
    token that produced them, keyed by ``(i, generated index)``. With
    ``layer_check`` each ``MoE.decode_apply`` call also runs the layer's
    dense path on the same input, and the largest difference relative to
    the dense output's max |value| is kept (the same input routes
    alike, so no flip can hide a difference there)."""

    STEPS = ("decode_step_slots_paged", "verify_step_slots_paged")

    def __init__(self, eng_mod, streams, layer_check=False):
        self.eng_mod, self.streams = eng_mod, streams
        self.layer_check = layer_check
        self.logits, self.routes = {}, {}
        self.layer_err, self.layer_calls = 0.0, 0
        self.index, self.eng = {}, None
        self._log = self._topi = None

    def attach(self, eng, rids):
        self.eng = eng
        self.index = {rid: i for i, rid in enumerate(rids)}
        eng._sample = self._sample
        eng._walk = self._walk

    def __enter__(self):
        self.orig = {n: getattr(self.eng_mod, n) for n in self.STEPS}
        self.orig_apply = MoE.decode_apply
        for name, fn in self.orig.items():
            setattr(self.eng_mod, name, self._wrap(fn))
        if self.layer_check:
            MoE.decode_apply = lambda layer, p, x, **kw: self._checked(
                layer, p, x, **kw)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.eng_mod, name, fn)
        MoE.decode_apply = self.orig_apply

    def _wrap(self, fn):
        def step(*args, **kw):
            with _RouteLog() as log:
                self._log = log
                out = fn(*args, **kw)
            self._log = None
            # [L, S, W, K], each token's expert set sorted
            self._topi = torch.stack([
                x.reshape(x.shape[0], -1, x.shape[-1]) for x in log.topi
            ]).sort(-1).values.numpy()
            return out
        return step

    def _checked(self, layer, p, x, *, return_routing=False):
        out = self.orig_apply(layer, p, x, return_routing=return_routing)
        y = out[0] if return_routing else out
        self._log.paused, prev = True, layer.dispatch
        layer.dispatch = "dense"
        try:
            ref = layer.apply(p, x).float()
        finally:
            self._log.paused, layer.dispatch = False, prev
        err = float((y.float() - ref).abs().max() / ref.abs().max())
        self.layer_err = max(self.layer_err, err)
        self.layer_calls += 1
        return out

    def _keep(self, i, g, logits, sets):
        self.logits[(i, g)] = logits.float().clone()
        self.routes[(i, g)] = sets.copy()

    def _next(self, req, g):
        stream = self.streams[self.index[req.rid]]
        return (int(stream[g]) if g < len(stream) else 0), g < len(stream)

    def _sample(self, logits, rows, reqs, fused=False, keys=None):
        topi, self._topi = self._topi, None     # None: a prefill's draw
        out = np.zeros(logits.shape[0], np.int64)
        for row, r in zip(rows, reqs):
            g = len(r.generated)
            out[row], known = self._next(r, g)
            if topi is not None and known:
                self._keep(self.index[r.rid], g, logits[row],
                           topi[:, row, 0])
        return torch.from_numpy(out).to(logits.device)

    def _walk(self, logits, toks, parents):
        """The verify walk down the forced stream: at each node emit the
        stream's next token and descend into the lowest-index child that
        drafted it, as ``tree_walk`` descends into the target's choice;
        idle slots emit nothing."""
        topi, self._topi = self._topi, None
        s_n, w_len = toks.shape
        emitted = np.full((s_n, w_len), -1, np.int64)
        n_emit = np.zeros(s_n, np.int64)
        path = np.zeros((s_n, w_len), np.int64)
        for slot, r in self.eng.scheduler.running.items():
            g0, cur = len(r.generated), 0
            for step in range(w_len):
                path[slot, step:] = cur
                want, known = self._next(r, g0 + step)
                if known:
                    self._keep(self.index[r.rid], g0 + step,
                               logits[slot, cur], topi[:, slot, cur])
                emitted[slot, step] = want
                n_emit[slot] += 1
                child = np.flatnonzero((parents[slot] == cur)
                                       & (toks[slot] == want))
                if not known or not child.size:
                    break
                cur = int(child[0])
        return emitted, n_emit, path


def forced_run(model, requests, streams, layer_check=False, **engine_kw):
    """``requests`` through a paged engine as ``serve`` builds it,
    teacher-forced to ``streams`` (``_Forced``); returns the record. The
    engine runs the synchronous loop: a forced token is the stream's
    next one after the tokens the host holds, which the pipelined loop
    reads one step late."""
    eng_mod = sys.modules["distkeras_tpu_torch.serving.engine"]
    eng = ServingEngine(model, num_slots=4, max_len=2048, page_len=16,
                        prefill_chunk=256, num_pages=NUM_PAGES,
                        device=model.device, overlap=False, **engine_kw)
    rids = [eng.submit(prompt, NEW_TOKENS, **kw) for prompt, kw in requests]
    with _Forced(eng_mod, streams, layer_check) as rec:
        rec.attach(eng, rids)
        eng.run(max_steps=5000)
    return rec


def moe_logits_vs_cpu(model, f32, prompt):
    """One prompt's logits at EVERY position through the MoE LM on the
    card (bf16 serving weights, as the engine runs them) against the
    plain path on the CPU in float32 at the same weights, with the
    routing flips between the two. Returns the per-position error
    relative to that position's max |logit| (a routing flip moves a
    position's logits far more than bf16 rounding does, so the error
    has a tail that one position does not show) and the flip count."""
    tokens = torch.as_tensor(prompt[None], dtype=torch.long)

    def run(m, params, device):
        with _RouteLog() as log, torch.inference_mode():
            logits = m.module.apply(params, tokens.to(device))
        return logits[0].float().cpu(), log

    ref, ref_log = run(f32, f32.params, "cpu")
    card, card_log = run(model, serving_params(model.params, torch.bfloat16),
                         model.device)
    err = (card - ref).abs().amax(-1) / ref.abs().amax(-1)
    return err.numpy(), routing_flips(card_log, ref_log)


MOE_LAYERS = LM_CFG["num_layers"]
def forced_compare(label, plain, spec, greedy):
    """Two teacher-forced records of the same streams (``_Forced``): the
    dispatched engine's logits for each generated token against the
    dense engine's, at the bf16 tolerance, at every token whose input
    has the same expert set in every MoE layer in both runs; the tokens
    where a set differs (a routing flip: a bf16 near-tie of the router
    scores, after which one expert's output replaces another's) are
    counted and their error printed, not held. Also holds the dispatched
    record's per-layer check at the same tolerance (the two paths round
    the hidden rows, the expert outputs and the gate products to bf16
    at different points, a few bf16 ulps of the largest output; a
    wrong expert, bias or activation moves it by its own size). Prints
    how often the plain record's argmax is the forced token at the
    ``greedy`` requests' positions (the forced plain run recomputes the
    run that made the streams). Returns ``{request index: generated index
    of its first flip}``."""
    if not plain.logits or set(plain.logits) != set(spec.logits):
        raise AssertionError(f"{label}: the forced runs computed different "
                             "tokens")
    groups = {"matched": [], "matched after a flip": [], "flipped": []}
    flips, first, choices = 0, {}, 0
    for i, g in sorted(plain.logits):
        ref = plain.logits[(i, g)]
        err = float((spec.logits[(i, g)] - ref).abs().max()
                    / ref.abs().max())
        n = int((plain.routes[(i, g)] != spec.routes[(i, g)]).any(-1).sum())
        flips += n
        choices += len(plain.routes[(i, g)])
        if n:
            first.setdefault(i, g)
            groups["flipped"].append(err)
        else:
            groups["matched after a flip" if i in first
                   else "matched"].append(err)
    again = [int(torch.argmax(lg)) == int(plain.streams[i][g])
             for (i, g), lg in plain.logits.items() if i in greedy]
    stats = "; ".join(
        f"{name} {len(e)} tokens" + (f", max {max(e):.3e} median "
                                     f"{np.median(e):.3e}" if e else "")
        for name, e in groups.items())
    print(f"MoE {label} teacher-forced on the dense run's streams: logits "
          f"vs the dense engine's, rel err (tol {E2E_BF16_REL_TOL} where "
          f"the expert sets match): {stats}; routing flips {flips} of "
          f"{choices} token-layer choices; the dense record's argmax is "
          f"the stream's token at {sum(again)} of {len(again)} greedy "
          f"positions; "
          f"decode_apply vs the dense layer on the same input over "
          f"{spec.layer_calls} calls: max rel err {spec.layer_err:.3e} (tol "
          f"{E2E_BF16_REL_TOL})", flush=True)
    if not spec.layer_calls or not spec.layer_err <= E2E_BF16_REL_TOL:
        raise AssertionError(f"MoE {label}: decode_apply disagrees with the "
                             "dense layer on the same input")
    matched = groups["matched"] + groups["matched after a flip"]
    if not matched or not max(matched) <= E2E_BF16_REL_TOL:
        raise AssertionError(f"MoE {label}: logits disagree with the dense "
                             "engine's where the expert sets match")
    return first


def moe_serve_phase(model, card):
    """MoE serving on the full-width all-MoE LM with phase 5's workload
    and pool: ``moe_decode="dispatched"`` (K6a in every decode step),
    ``"dense"`` (no K6a), then an n-gram tree run on two motif prompts
    against a dense run of the same prompts; each run's K6a launches
    against 12 x its decode steps and verifies, and every stream
    finished. The timed runs carry no recorder. Then each dispatched run
    is teacher-forced along its dense run's streams (``forced_compare``);
    the free-running streams' partings are printed beside the first
    routing flip the forced runs show for the same request."""
    vocab = model.module.layers[0].vocab_size
    eng_mod = sys.modules["distkeras_tpu_torch.serving.engine"]
    tree_kw = dict(draft=NgramDraft(), spec_k=SPEC_K, spec_tree=True,
                   spec_width=SPEC_WIDTH)
    runs = [("dispatched", "serving_moe", None, {}),
            ("dense", None, None, dict(moe_decode="dense")),
            ("dense motif", None, 2, dict(moe_decode="dense")),
            ("dispatched n-gram tree", "serving_moe_spec_tree", 2, tree_kw)]
    rs = np.random.RandomState(SEED + 13)
    for kw in ({}, dict(moe_decode="dense"), tree_kw):
        eng = ServingEngine(model, num_slots=2, max_len=2048, page_len=16,
                            prefill_chunk=256, device=model.device, **kw)
        eng.submit(rs.randint(0, vocab, 40), 6)
        eng.run(max_steps=100)
    results, launches = {}, {}
    for label, path, n_motif, kw in runs:
        requests = workload(vocab) if n_motif is None \
            else motif_workload(vocab, n_motif)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        with _Calls(eng_mod, *_Forced.STEPS) as steps:
            t0 = time.perf_counter()
            eng, reqs, out, bad, iters = serve(model, model.device,
                                               requests=requests, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        c = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        check_finished(reqs, out, bad)
        s = eng.metrics.summary()
        dispatched = kw.get("moe_decode", "dispatched") == "dispatched"
        want = MOE_LAYERS * steps.n if dispatched else 0
        if c["moe_gather_gemm1"] != want or (dispatched and want == 0):
            raise AssertionError(f"MoE serving {label}: {c['moe_gather_gemm1']}"
                                 f" K6a launches for {steps.n} decode steps "
                                 f"and verifies, expected {want}")
        if (s["moe"] is None) == dispatched:
            raise AssertionError(f"MoE serving {label}: summary()['moe'] is "
                                 f"{s['moe']}")
        moe = s["moe"] or {}
        print(f"MoE serving {label} on {card}: {len(reqs)} requests in "
              f"{wall:.2f} s, {iters} iterations, {steps.n} decode steps "
              f"and verifies; launches moe_gather_gemm1 "
              f"{c['moe_gather_gemm1']}, flash_fwd {c['flash_fwd']}, paged "
              f"{c['paged_decode']}/{c['paged_decode_anc']}; TTFT p50 "
              f"{s['ttft_s']['p50'] * 1e3:.1f} ms p99 "
              f"{s['ttft_s']['p99'] * 1e3:.1f} ms; decode "
              f"{s['decode_tokens_per_sec']:.1f} tok/s; preemptions "
              f"{s['requests_preempted']}; resident weights "
              f"{eng.param_bytes()} bytes; peak allocated during the run "
              f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
              f"allocated before it; expert load "
              f"{moe.get('expert_load')}, router entropy "
              f"{moe.get('router_entropy')}, concentration "
              f"{moe.get('concentration')}; acceptance "
              f"{s['acceptance_rate']}", flush=True)
        results[label] = (reqs, out, requests, kw)
        if path is not None:
            launches[path] = c
        del eng
    f32 = build_moe_lm("cpu", dtype="float32")
    f32.module.load_state_dict(model.module.state_dict())
    prompt = workload(vocab)[0][0]
    err, flips = moe_logits_vs_cpu(model, f32, prompt)
    rel = float(err[-1])
    print(f"MoE prefill logits vs CPU float32 (prompt {len(prompt)}): card "
          f"bf16 rel err at the last position {rel:.3e} (tol "
          f"{E2E_BF16_REL_TOL}); over all {len(err)} positions median "
          f"{np.median(err):.3e}, p99 {np.percentile(err, 99):.3e}, max "
          f"{err.max():.3e}, {int((err > E2E_BF16_REL_TOL).sum())} above "
          f"the tolerance; routing flips {flips} of "
          f"{MOE_LAYERS * len(prompt)} "
          f"token-layer choices", flush=True)
    if not rel <= E2E_BF16_REL_TOL:
        raise AssertionError("MoE card logits disagree with the CPU plain "
                             "path")
    parted = 0
    for spec, plain in (("dispatched", "dense"),
                        ("dispatched n-gram tree", "dense motif")):
        reqs, out, requests, spec_kw = results[spec]
        preqs, pout, _, plain_kw = results[plain]
        streams = [pout[prid][len(p):] for prid, p in preqs]
        greedy = {i for i, (_, kw) in enumerate(requests)
                  if not kw.get("temperature")}
        first = forced_compare(
            spec, forced_run(model, requests, streams, **plain_kw),
            forced_run(model, requests, streams, layer_check=True,
                       **spec_kw), greedy)
        for i, ((rid, p), (prid, _)) in enumerate(zip(reqs, preqs)):
            diff = np.flatnonzero(out[rid] != pout[prid])
            if diff.size:
                parted += 1
                print(f"MoE {spec}: request {i} parts from the dense stream "
                      f"at generated token {int(diff[0]) - len(p)}; the "
                      f"forced runs' first routing flip for it is at "
                      f"generated token {first.get(i)}", flush=True)
    print(f"MoE serving: streams parted from the dense run {parted}",
          flush=True)
    return launches


# --- phase 21: prefill through K6a, decode-step logits against the CPU ------


class _Dispatch:
    """Set every MoE layer of a module to one dispatch while installed."""

    def __init__(self, module, dispatch):
        self.layers = [m for m in module.modules() if isinstance(m, MoE)]
        self.dispatch = dispatch

    def __enter__(self):
        self.prev = [m.dispatch for m in self.layers]
        for m in self.layers:
            m.dispatch = self.dispatch
        return self

    def __exit__(self, *exc):
        for m, d in zip(self.layers, self.prev):
            m.dispatch = d


class _PlainMoE:
    """While installed, the fused MoE block runs the plain versions of
    K6a, K6b and K6c on the card (the comparison's other side)."""

    PLAIN = {"gather_gemm1": "gather_gemm1_reference",
             "bwd_dx": "bwd_dx_reference", "bwd_dw1": "bwd_dw1_reference"}

    def __init__(self):
        self.mod = sys.modules["distkeras_tpu_torch.ops.moe_kernels"]
        self.orig = {k: getattr(self.mod, k) for k in self.PLAIN}

    def __enter__(self):
        for k, plain in self.PLAIN.items():
            setattr(self.mod, k, getattr(self.mod, plain))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.mod, k, fn)


MOE_PREFILL = 256
MOE_LOGIT_LAYERS = 2


def moe_prefill_phase(model, card):
    """The same weights with ``moe_dispatch="fused"``: one 256-token
    prefill chunk launches K6a once per layer; its logits against the
    card's plain path (K6a's plain version in the same block), with the
    routing flips between the two. Then one decode step's logits on the
    card (bf16 and float32, fused dispatch: K6a once per layer) against
    the CPU float32 dense path at 2 layers of the same widths, from a
    copy of the card's cache."""
    vocab = model.module.layers[0].vocab_size
    prompt = np.random.RandomState(SEED + 14).randint(0, vocab, MOE_PREFILL)
    tokens = torch.as_tensor(prompt[None], dtype=torch.long,
                             device=model.device)
    params = fuse_qkv_params(model.module,
                             serving_params(model.params, torch.bfloat16))

    def run():
        with _RouteLog() as log, torch.inference_mode():
            cache = init_cache(model.module, 1, MOE_PREFILL, torch.bfloat16,
                               model.device)
            logits, _ = prefill(model.module, params, cache, tokens)
        return logits.float().cpu(), log

    with _Dispatch(model.module, "fused"):
        run()                                          # first calls
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got, log = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_k6a = kernels.launch_counts()["moe_gather_gemm1"]
        with _PlainMoE():
            kernels.reset_launch_counts()
            ref, ref_log = run()
            if kernels.launch_counts()["moe_gather_gemm1"]:
                raise AssertionError("the plain path launched K6a")
    rel = (got - ref).abs().max().item() / ref.abs().max().item()
    flips = routing_flips(log, ref_log)
    print(f"MoE fused prefill on {card}: {MOE_PREFILL}-token chunk in "
          f"{ms:.1f} ms, moe_gather_gemm1 launches {n_k6a}; logits vs the "
          f"card's plain path rel err {rel:.3e} (tol {E2E_BF16_REL_TOL}); "
          f"routing flips {flips} of {MOE_LAYERS * MOE_PREFILL}",
          flush=True)
    if n_k6a != MOE_LAYERS:
        raise AssertionError(f"the fused prefill launched K6a {n_k6a} times, "
                             f"expected {MOE_LAYERS}")
    if not rel <= E2E_BF16_REL_TOL:
        raise AssertionError("the fused prefill's logits disagree with the "
                             "card's plain path")

    f32 = build_moe_lm("cpu", num_layers=MOE_LOGIT_LAYERS, dtype="float32")
    out = {}
    for label, dtype in (("bf16", "bfloat16"), ("float32", "float32")):
        m = build_moe_lm(model.device, num_layers=MOE_LOGIT_LAYERS,
                         dtype=dtype, dispatch="fused")
        m.module.load_state_dict(f32.module.state_dict())
        cdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        with torch.inference_mode():
            p = _generate_params(m, "auto", cdt)
            cache = init_cache(m.module, 1, MOE_PREFILL + 1, cdt, m.device)
            logits, cache = prefill(m.module, p, cache, tokens)
            tok = torch.argmax(logits, dim=-1)
            cpu_cache = [None if kv is None else {
                key: a.float().cpu() for key, a in kv.items()}
                for kv in cache]
            kernels.reset_launch_counts()
            with _RouteLog() as log:
                card_logits, _ = decode_step(m.module, p, cache, tok,
                                             MOE_PREFILL)
            n_step = kernels.launch_counts()["moe_gather_gemm1"]
            with _RouteLog() as ref_log:
                ref, _ = decode_step(f32.module, f32.params, cpu_cache,
                                     tok.cpu(), MOE_PREFILL)
        rel = (card_logits.float().cpu() - ref).abs().max().item() \
            / ref.abs().max().item()
        tol = E2E_BF16_REL_TOL if label == "bf16" else E2E_F32_REL_TOL
        print(f"MoE decode-step logits vs CPU float32 ({MOE_LOGIT_LAYERS} "
              f"layers, t={MOE_PREFILL}): card {label} rel err {rel:.3e} "
              f"(tol {tol}); moe_gather_gemm1 launches {n_step}; routing "
              f"flips {routing_flips(log, ref_log)} of {MOE_LOGIT_LAYERS}",
              flush=True)
        if n_step != MOE_LOGIT_LAYERS:
            raise AssertionError(f"the {label} decode step launched K6a "
                                 f"{n_step} times")
        if not rel <= tol:
            raise AssertionError(f"card {label} MoE decode-step logits "
                                 "disagree with the CPU plain path")
        out[label] = rel
        del m
    return n_k6a


# --- phase 22: the fused MoE block's backward kernels (K6b, K6c) ------------

#: bf16 outputs (dxr, dz, gy) against float32 math: the output's rounding
#: (2^-8 relative) on both sides, with the d- or H-term sums in another
#: order; every tolerance is relative to the output's largest |value|
K6BC_BF16_TOL = 2e-2
#: float32 outputs of a bf16 run (rowdot, dw1): bf16 inputs on both
#: sides, float32 sums over up to 2048 terms in another order
K6BC_BF16_F32_OUT_TOL = 1e-3
#: float32 runs: only the summation order differs
K6BC_F32_TOL = 1e-4
#: phase 22's cases: (label, tokens N, capacity C, d, H, routing): the
#: training shape (phase 23's batch of 4 x 2048 tokens at capacity factor
#: 1.0), a 256-token batch, a routing that leaves six experts empty (and
#: drops past capacity on the other two), one that sends every first
#: choice to one expert (drops at capacity factor 1.0), ragged widths;
#: then widths that are not multiples of 8 (70) or of the bf16 kernels'
#: 128-wide tiles (136, 1000), and capacities that are not multiples of
#: their 64-row depth chunks (90, 33)
K6BC_CASES = (("training N8192", 8192, 2048, MOE_D, MOE_H, "random"),
              ("N256", 256, 64, MOE_D, MOE_H, "random"),
              ("empty experts N64", 64, 16, MOE_D, MOE_H, "two-experts"),
              ("one expert N256", 256, 64, MOE_D, MOE_H, "one-expert"),
              ("ragged d1000 H1000 N256", 256, 64, 1000, 1000, "random"),
              ("odd d70 H136 N300", 300, 90, 70, 136, "random"),
              ("odd d70 H70 N300", 300, 90, 70, 70, "random"),
              ("odd d136 H70 N300", 300, 90, 136, 70, "random"),
              ("odd d1000 H136 N256", 256, 33, 1000, 136, "random"),
              ("odd d72 H1000 N96", 96, 90, 72, 1000, "random"))
#: the cases that also run in float32
K6BC_F32_CASES = ("N256", "empty experts N64", "ragged d1000 H1000 N256",
                  "odd d70 H136 N300", "odd d70 H70 N300")
K6BC_OUTPUTS = ("dxr", "dz", "gy", "rowdot")


def k6bc_inputs(rs, n, c, d, h, routing, dtype, dev):
    """K6b's operands for one case, in ``bwd_dx``'s order: x and the
    output cotangent g ``[n, d]``, ``src_tok`` and ``row_gate`` from a
    real dispatch plan, w1, b1, w2, b2, and the forward's hidden rows
    ``h`` (K6a's plain version on the same plan)."""
    dest, sg, keep = moe_plan(rs, n, c, routing)
    e = MOE_EXPERTS
    src = src_tokens(dest, n, e, c).to(dev)
    rg = row_gates(dest, keep, sg, e, c).to(dev)
    xt, g = _randn(rs, dtype, dev, n, d), _randn(rs, dtype, dev, n, d)
    w1 = _randn(rs, dtype, dev, e, d, h, scale=0.03)
    b1 = _randn(rs, dtype, dev, e, h, scale=0.1)
    w2 = _randn(rs, dtype, dev, e, h, d, scale=0.03)
    b2 = _randn(rs, dtype, dev, e, d, scale=0.1)
    hid = gather_gemm1_reference(xt, src, w1, b1, c)
    return xt, g, src, rg, w1, b1, w2, b2, hid


def _rel(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() / max(
        b.float().abs().max().item(), 1e-30)


def _k6bc_bounds(src, n, c, d, h, es, peak):
    """The bounds of K6b and K6c from this plan: only filled capacity
    rows are computed and only the experts a token reached stream their
    weights; each input read once, each output written once."""
    src_np = src.cpu().numpy().reshape(MOE_EXPERTS, c)
    filled = int((src_np >= 0).sum())
    active = int((src_np >= 0).any(axis=1).sum())
    e = MOE_EXPERTS
    rows = e * c
    dx_bytes = (es * (2 * n * d + 2 * active * d * h + e * (h + d)
                      + filled * h + rows * (2 * d + h))
                + rows * 4 * 3)
    dw1_bytes = es * (n * d + rows * h) + rows * 4 + e * d * h * 4
    return (bound_ms(8.0 * filled * d * h, dx_bytes, peak),
            bound_ms(2.0 * filled * d * h, dw1_bytes, peak), filled, active)


def k6bc_phase(dev):
    """K6b against ``bwd_dx_reference`` and K6c against
    ``bwd_dw1_reference`` on the same plan (K6c on the plain version's
    dz, so both sides read the same inputs) at the training shape and
    the edge cases of ``K6BC_CASES``, bf16 and float32: rows no slot won
    give exact zeros, a bitwise repeat, graph-replay times, the plain
    versions' times, bounds from the plan and, as yardsticks,
    ``torch.bmm`` of the four products on pre-gathered ``[E, C, d]``
    buffers (K6b) and one ``torch.bmm`` of the gathered x^T and dz
    (K6c)."""
    rows = {"moe_bwd_dx": [], "moe_bwd_dw1": []}
    rs = np.random.RandomState(SEED + 22)
    for dtype, peak, cases in (
            (torch.bfloat16, PEAK_BF16_FLOPS, K6BC_CASES),
            (torch.float32, PEAK_F32_FLOPS,
             [c for c in K6BC_CASES if c[0] in K6BC_F32_CASES])):
        for label, n, c, d, h, routing in cases:
            args = k6bc_inputs(rs, n, c, d, h, routing, dtype, dev)
            xt, src = args[0], args[2]
            before = kernels.launch_counts()
            out = bwd_dx(*args, c)
            ref = bwd_dx_reference(*args, c)
            dz_ref = ref[1]
            dw1 = bwd_dw1(xt, dz_ref, src, c)
            dw1_ref = bwd_dw1_reference(xt, dz_ref, src, c)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            for name in ("moe_bwd_dx", "moe_bwd_dw1"):
                if after[name] != before[name] + 1:
                    raise AssertionError(f"{name} {label} did not launch")
            bf16 = dtype == torch.bfloat16
            tols = dict(zip(K6BC_OUTPUTS + ("dw1",), (
                (K6BC_BF16_TOL,) * 3 + (K6BC_BF16_F32_OUT_TOL,) * 2
                if bf16 else (K6BC_F32_TOL,) * 5)))
            errs = {name: _rel(a, b) for name, a, b in
                    zip(K6BC_OUTPUTS, out, ref)}
            errs["dw1"] = _rel(dw1, dw1_ref)
            abs_dx = max((a.float() - b.float()).abs().max().item()
                         for a, b in zip(out, ref))
            abs_dw1 = (dw1 - dw1_ref).abs().max().item()
            empty = (src < 0).reshape(MOE_EXPERTS, c)
            zeros = all(bool((t[empty] == 0).all()) for t in out)
            repeat = all(torch.equal(a, b) for a, b in
                         zip(out, bwd_dx(*args, c))) and torch.equal(
                dw1, bwd_dw1(xt, dz_ref, src, c))
            heavy = n >= 8192
            ms = graph_ms(lambda: bwd_dx(*args, c), iters=5 if heavy else 20)
            ms_dw1 = graph_ms(lambda: bwd_dw1(xt, dz_ref, src, c),
                              iters=5 if heavy else 20)
            plain_ms = time_ms(lambda: bwd_dx_reference(*args, c),
                               iters=3, warmup=1)
            plain_dw1 = time_ms(lambda: bwd_dw1_reference(xt, dz_ref, src,
                                                          c),
                                iters=3, warmup=1)
            tok = src.long().reshape(MOE_EXPERTS, c)
            zero = torch.zeros((), dtype=dtype, device=dev)
            xg = torch.where((tok >= 0)[..., None], xt[tok.clamp(min=0)],
                             zero)
            _, w1, _, w2, _, hid = args[3:]
            gyb, dzb = ref[2], ref[1]
            w1t, w2t = w1.transpose(1, 2), w2.transpose(1, 2)

            def four():
                torch.bmm(hid, w2)
                torch.bmm(gyb, w2t)
                torch.bmm(xg, w1)
                torch.bmm(dzb, w1t)

            xgt = xg.transpose(1, 2)
            lib_ms = graph_ms(four, iters=5 if heavy else 20)
            lib_dw1 = graph_ms(lambda: torch.bmm(xgt, dzb),
                               iters=5 if heavy else 20)
            es = xt.element_size()
            (bdx, bydx), (bdw, bydw), filled, active = _k6bc_bounds(
                src, n, c, d, h, es, peak)
            case = f"{label} C{c} {'bf16' if bf16 else 'f32'}"
            shown = {k: f"{v:.2e}" for k, v in errs.items() if k != "dw1"}
            # achieved rates on the filled rows' work, and the bound's share
            tf_dx = 8.0 * filled * d * h / (ms * 1e9)
            tf_dw1 = 2.0 * filled * d * h / (ms_dw1 * 1e9)
            print(f"moe_bwd_dx {case} ({routing} routing, {active} experts "
                  f"reached, {filled} filled rows): rel err {shown} (tol "
                  f"{tols['dxr']} dxr/dz/gy, {tols['rowdot']} rowdot), "
                  f"max abs {abs_dx:.3e}; kernel {ms:.4f} ms (graph "
                  f"replay; {tf_dx:.1f} TFLOP/s, {bdx / ms:.1%} of the "
                  f"bound), plain {plain_ms:.4f} ms, four torch.bmm on "
                  f"pre-gathered buffers {lib_ms:.4f} ms, bound {bdx:.4f} ms "
                  f"({bydx}); rows no slot won exact zeros {zeros}, bitwise "
                  f"repeat {repeat}", flush=True)
            print(f"moe_bwd_dw1 {case}: rel err {errs['dw1']:.2e} (tol "
                  f"{tols['dw1']}), max abs {abs_dw1:.3e}; kernel "
                  f"{ms_dw1:.4f} ms (graph replay; {tf_dw1:.1f} TFLOP/s, "
                  f"{bdw / ms_dw1:.1%} of the bound), plain {plain_dw1:.4f} "
                  f"ms, torch.bmm on the gathered x {lib_dw1:.4f} ms, bound "
                  f"{bdw:.4f} ms ({bydw})", flush=True)
            bad = [k for k, v in errs.items() if not v <= tols[k]]
            if bad or not zeros or not repeat:
                raise AssertionError(
                    f"K6b/K6c disagree with their plain versions on {case}: "
                    f"outputs {bad}, exact zeros {zeros}, bitwise repeat "
                    f"{repeat}")
            rows["moe_bwd_dx"].append(dict(
                name=case, err=abs_dx, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bdx, bound_by=bydx))
            rows["moe_bwd_dw1"].append(dict(
                name=case, err=abs_dw1, ms=ms_dw1, plain_ms=plain_dw1,
                library_ms=lib_dw1, bound_ms=bdw, bound_by=bydw))
            del args, out, ref, dw1, dw1_ref, xg
    return rows


# --- phase 23: MoE training end to end ---------------------------------------

#: ``bench.py`` ``bench_moe``'s training model: fused dispatch, capacity
#: factor 1.0 (slots past it drop), balance-loss weight 0.01
MOE_TRAIN_KW = dict(dispatch="fused", aux_loss_weight=0.01,
                    capacity_factor=1.0)
#: 16 rows of phase 7's data, two epochs: 8 steps of 4 x 2048 tokens
MOE_TRAIN_ROWS, MOE_TRAIN_EPOCHS = 16, 2
MOE_TRAINING_KERNELS = TRAINING_KERNELS + (
    "moe_gather_gemm1", "moe_bwd_dx", "moe_bwd_dw1")
#: the fused block's kernels in a profile, by their device functions
MOE_KERNEL_GROUPS = (
    ("K6a (moe_gather_gemm1)", ("gemm1_kernel", "gg1_kernel",
                                "gg1_combine")),
    ("K6b (moe_bwd_dx, four passes)",
     ("rowdot_gy_kernel", "rowdot_sum_kernel", "dz_kernel", "dxr_kernel")),
    ("K6c (moe_bwd_dw1)", ("dw1_kernel",)))
#: the step's named host functions whose device time phase 23's profile
#: reads through a profiler range around each call: (label, module,
#: function); a name the module lacks is reported as absent
MOE_RANGES = (
    ("the dispatch plan (models.moe._dispatch_plan)",
     "distkeras_tpu_torch.models.moe", "_dispatch_plan"),
    ("dw2 (ops.moe_kernels._dw2)", "distkeras_tpu_torch.ops.moe_kernels",
     "_dw2"))


class _Ranges:
    """While installed, each function of ``ranges`` (``MOE_RANGES``'s
    triples) runs inside a ``torch.profiler.record_function`` range of
    its label, so a trace attributes its kernels' device time."""

    def __init__(self, ranges):
        self.found = [(label, sys.modules[mod], name)
                      for label, mod, name in ranges
                      if hasattr(sys.modules[mod], name)]

    def __enter__(self):
        self.orig = [getattr(m, name) for _, m, name in self.found]
        for (label, m, name), fn in zip(self.found, self.orig):
            def ranged(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)
            setattr(m, name, ranged)
        return self

    def __exit__(self, *exc):
        for (_, m, name), fn in zip(self.found, self.orig):
            setattr(m, name, fn)


def moe_training_phase(dev, card):
    """``SingleTrainer`` with adam on the 12-layer all-MoE LM (~520M
    parameters, ``MOE_TRAIN_KW``) over phase 7's pattern data: 8 steps,
    with every training kernel's launches read around that run only
    (12 per step each); the loss is finite and falls; the balance-loss
    term of one batch; then the steady step (time, tokens/s, peak
    memory, a ``torch.profiler`` list) and, as a yardstick, the same
    model's step under ``dispatch="tokens"`` (plain autograd, cuBLAS; no
    K6a/K6b/K6c launch)."""
    model = build_moe_lm(dev, **MOE_TRAIN_KW)
    print(f"model: all-MoE transformer_lm {dict(LM_CFG, mlp_ratio=2)}, "
          f"{MOE_EXPERTS} experts top-{MOE_TOP_K}, bf16, {MOE_TRAIN_KW}, "
          f"{model.num_params() / 1e6:.1f}M parameters", flush=True)
    vocab = model.module.layers[0].vocab_size
    data = training_data(vocab, rows=MOE_TRAIN_ROWS)
    trainer, launches = train(model, data, MOE_TRAIN_EPOCHS)
    steps = MOE_TRAIN_EPOCHS * MOE_TRAIN_ROWS // TRAIN_BATCH
    losses, last_mean = check_training(trainer, launches, LM_CFG[
        "num_layers"], steps, MOE_TRAINING_KERNELS)
    xb = torch.from_numpy(data.arrays()[0][:TRAIN_BATCH]).to(dev)
    model.module.train()
    with torch.no_grad():
        model.module(xb)
    aux = float(collect_aux_losses(model.module))
    model.module.eval()
    print(f"MoE training: {len(losses)} steps, loss {losses[0]:.4f} -> last "
          f"epoch mean {last_mean:.4f} (per step: "
          f"{np.array2string(losses, precision=3)}); balance-loss term "
          f"(weight {MOE_TRAIN_KW['aux_loss_weight']} x "
          f"{LM_CFG['num_layers']} layers) {aux:.5f} after training; "
          f"launches { {k: launches[k] for k in MOE_TRAINING_KERNELS} }; "
          f"{trainer.get_training_time():.1f} s", flush=True)
    profile_training(model, card, "MoE training (fused)", "profile-moe",
                     MOE_KERNEL_GROUPS, MOE_RANGES)
    with _Dispatch(model.module, "tokens"):
        kernels.reset_launch_counts()
        profile_training(model, card, "MoE training (tokens dispatch, "
                         "yardstick)", None)
        c = kernels.launch_counts()
    if c["moe_gather_gemm1"] or c["moe_bwd_dx"] or c["moe_bwd_dw1"]:
        raise AssertionError(f"the tokens-dispatch yardstick launched the "
                             f"fused block's kernels: {c}")
    return launches


# --- phase 24: MoE gradients on the card against the CPU -------------------

MOE_GRAD_LAYERS, MOE_GRAD_SEQ = 2, 512


class _Input:
    """While installed, keep the input of one layer's every ``apply``."""

    def __init__(self, layer):
        self.layer, self.inputs = layer, []

    def __enter__(self):
        orig = type(self.layer).apply

        def kept(p, x):
            self.inputs.append(x.detach())
            return orig(self.layer, p, x)

        self.layer.apply = kept
        return self

    def __exit__(self, *exc):
        del self.layer.apply


def moe_gradients_vs_cpu(dev):
    """Whole-model gradients of the 2-layer all-MoE LM (the training
    configuration, B1 S512) on the card against the CPU float32 plain
    path: float32 held per leaf at ``GRAD_F32_REL_TOL``; bf16 printed
    (a bf16 router flips near-tied choices, and a flipped token's
    gradient belongs to other experts), with the routing flips of both.
    The bf16 kernels are held at the block: the first MoE block's real
    input from the bf16 model, its dispatch plan fixed, and the fused
    block's forward and backward (K6a, K6b, K6c) against the card's
    plain versions on that plan."""
    rs = np.random.RandomState(SEED + 24)
    toks = torch.from_numpy(rs.randint(0, LM_CFG["vocab"],
                                       (1, MOE_GRAD_SEQ + 1)))
    x, y = toks[:, :-1], toks[:, 1:]
    loss_fn = sparse_categorical_crossentropy_from_logits
    f32 = build_moe_lm("cpu", num_layers=MOE_GRAD_LAYERS, dtype="float32",
                       **MOE_TRAIN_KW)

    def grads(m):
        with _RouteLog() as log:
            loss, g, _ = value_and_grad(m.module, loss_fn, m.params,
                                        x.to(m.device), y.to(m.device))
        return float(loss), [t.float().cpu() for t in tree_leaves(g)], log

    ref_loss, ref, ref_log = grads(f32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        m = build_moe_lm(dev, num_layers=MOE_GRAD_LAYERS, dtype=dtype,
                         **MOE_TRAIN_KW)
        m.module.load_state_dict(f32.module.state_dict())
        kernels.reset_launch_counts()
        loss, got, log = grads(m)
        c = kernels.launch_counts()
        if any(c[k] != MOE_GRAD_LAYERS for k in
               ("moe_gather_gemm1", "moe_bwd_dx", "moe_bwd_dw1")):
            raise AssertionError(f"the card {dtype} gradient launched {c}")
        worst = max(_rel(a, b) for a, b in zip(got, ref))
        flips = routing_flips(log, ref_log)
        held = dtype == "float32"
        print(f"MoE gradient vs CPU float32 ({MOE_GRAD_LAYERS} layers, B1 "
              f"S{MOE_GRAD_SEQ}, fused, capacity factor 1.0): card {dtype} "
              f"loss {loss:.6f} (CPU {ref_loss:.6f}), worst per-leaf rel err "
              f"{worst:.3e} "
              f"({f'tol {GRAD_F32_REL_TOL}' if held else 'printed, not held'}"
              f"); routing flips {flips} of "
              f"{MOE_GRAD_LAYERS * MOE_GRAD_SEQ}", flush=True)
        if held and not (worst <= GRAD_F32_REL_TOL and abs(
                loss - ref_loss) <= GRAD_F32_REL_TOL * ref_loss):
            raise AssertionError("card float32 MoE gradients disagree with "
                                 "the CPU")
        out[dtype] = worst
    # the bf16 block: m is the bf16 model
    layer = next(mod for mod in m.module.modules() if isinstance(mod, MoE))
    with _Input(layer) as kept, torch.no_grad():
        m.module(x.to(dev))
    xin = kept.inputs[0]
    p = layer.param_tree()
    n, d = MOE_GRAD_SEQ, LM_CFG["d_model"]
    cap = layer._capacity(n)
    with torch.no_grad():
        _, topi, gates, _ = layer._route(xin, p["gate"])
        dest, _, sg, keep = _dispatch_plan(topi.reshape(n, MOE_TOP_K),
                                           gates.reshape(n, MOE_TOP_K),
                                           MOE_EXPERTS, cap)
    primals = [xin.reshape(n, d).to(torch.bfloat16)] + [
        p[k].detach().to(torch.bfloat16) for k in ("w1", "b1", "w2", "b2")
    ] + [sg]
    cot = _randn(rs, torch.bfloat16, dev, n, d)

    def block():
        leaves = [t.clone().requires_grad_(True) for t in primals]
        y = fused_moe_apply(*leaves, dest, keep, capacity=cap,
                            activation=layer.activation)
        return [y.detach()] + list(torch.autograd.grad(y, leaves, cot))

    kernels.reset_launch_counts()
    got = block()
    c = kernels.launch_counts()
    with _PlainMoE():
        kernels.reset_launch_counts()
        want = block()
        if any(kernels.launch_counts().values()):
            raise AssertionError("the plain block launched a kernel")
    if any(c[k] != 1 for k in ("moe_gather_gemm1", "moe_bwd_dx",
                               "moe_bwd_dw1")):
        raise AssertionError(f"the bf16 block launched {c}")
    names = ("out", "dx", "dw1", "db1", "dw2", "db2", "dsg")
    errs = {k: _rel(a, b) for k, a, b in zip(names, got, want)}
    print(f"MoE bf16 block (layer 1's input from the bf16 model, N{n} "
          f"C{cap}, {int(keep.sum())} of {keep.numel()} slots kept): K6a+"
          f"K6b+K6c vs the card's plain versions, rel err "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol "
          f"{K6BC_BF16_TOL})", flush=True)
    if not all(v <= K6BC_BF16_TOL for v in errs.values()):
        raise AssertionError("the bf16 fused block disagrees with its plain "
                             "versions")
    out["bf16_block"] = max(errs.values())
    return out


# --- phase 25: the zero-bubble loop ------------------------------------------

#: the loops phase 25 holds against each other: (label, engine keywords)
LOOPS = (("sync", dict(overlap=False)),
         ("overlap", dict(overlap=True)),
         ("overlap+fuse4", dict(overlap=True, fuse_steps=4)))
#: decode steps a loop profile times, then profiles (every loop the same;
#: short, to keep the whole script inside its time limit)
LOOP_STEPS, LOOP_PROF_STEPS = 16, 8


class _SyncErrors:
    """While entered, a CUDA host sync raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


class _LaunchWatch:
    """Wraps one engine's ``_launch_step``: counts its launches (units),
    the decode steps they hold (a fused window holds K) and the fused
    windows, adds up the host's time to issue them (from the call to its
    return: nothing waits for the card), and with ``strict`` runs each
    launch under ``_SyncErrors``, so a host sync inside one raises."""

    def __init__(self, eng, strict=False):
        self.units = self.steps = self.windows = 0
        #: decode steps launched with a sampled request in the batch
        self.sampled_steps = 0
        self.issue_s = 0.0
        orig = eng._launch_step

        def launch(greedy_only, fuse, prev, t0):
            t = time.perf_counter()
            if strict:
                with _SyncErrors():
                    out = orig(greedy_only, fuse, prev, t0)
            else:
                out = orig(greedy_only, fuse, prev, t0)
            self.issue_s += time.perf_counter() - t
            self.units += 1
            self.steps += max(fuse, 1)
            self.sampled_steps += 0 if greedy_only else max(fuse, 1)
            self.windows += bool(fuse)
            return out

        eng._launch_step = launch


def zero_bubble_phase(model, card, tie_rel, moe=False):
    """Phase 5's workload and pool through the three loops (``LOOPS``):
    every stream finishes, a preemption and a prefix hit happen, the
    paged kernel launches exactly once per layer in every decode step
    the engine launched (a fused window's steps and the step in flight
    past a stop included) and, with ``moe``, K6a too; the pipelined
    loops' greedy streams equal the synchronous loop's or part at a
    near-tie of the CPU float32 scores (``check_identity``), the sampled
    stream is equal. ``moe``: phase 20's dispatched all-MoE engine on
    the workload's first four greedy requests (no preemption asked)."""
    vocab = model.module.layers[0].vocab_size
    requests = workload(vocab)
    if moe:
        requests = [r for r in requests if not r[1]][:4]
    rs = np.random.RandomState(SEED + 21)
    for _, kw in LOOPS:               # the first calls of each loop's shapes
        eng = ServingEngine(model, num_slots=2, max_len=2048, page_len=16,
                            prefill_chunk=256, device=model.device, **kw)
        eng.submit(rs.randint(0, vocab, 40), 12)
        eng.submit(rs.randint(0, vocab, 30), 12, temperature=0.8, top_k=40,
                   top_p=0.9)
        eng.run(max_steps=200)
    tag = "MoE " if moe else ""
    runs, launches = {}, {}
    for label, kw in LOOPS:
        watches = []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng, reqs, out, bad, iters = serve(
            model, model.device, requests=requests,
            setup=lambda e: watches.append(_LaunchWatch(e)), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = kernels.launch_counts()
        w = watches[0]
        check_finished(reqs, out, bad)
        s = eng.metrics.summary()
        if not moe:
            check_serving(eng, reqs, out, bad)
        per_step = {"paged_decode": LM_CFG["num_layers"]}
        if moe:
            per_step["moe_gather_gemm1"] = MOE_LAYERS
        for name, n in per_step.items():
            if c[name] != n * w.steps:
                raise AssertionError(
                    f"zero-bubble {tag}{label}: {c[name]} {name} launches "
                    f"for {w.steps} decode steps launched, expected "
                    f"{n * w.steps}")
        if kw.get("fuse_steps") and not w.windows:
            raise AssertionError(f"zero-bubble {tag}{label}: no fused "
                                 "window ran")
        print(f"zero-bubble {tag}{label} on {card}: {len(reqs)} requests in "
              f"{wall:.2f} s, {iters} iterations, {w.units} launches "
              f"holding {w.steps} decode steps ({w.windows} fused windows); "
              f"launches { {k: c[k] for k in ('flash_fwd', *per_step)} }; "
              f"preemptions {s['requests_preempted']}; prefix hits "
              f"{s['prefix_cache']['hits']}; TTFT p50 "
              f"{s['ttft_s']['p50'] * 1e3:.1f} ms p99 "
              f"{s['ttft_s']['p99'] * 1e3:.1f} ms; decode "
              f"{s['decode_tokens_per_sec']:.1f} tok/s; blocked in the "
              f"fetch {eng.fetch_seconds * 1e3:.1f} ms; issuing launches "
              f"{w.issue_s * 1e3:.1f} ms", flush=True)
        runs[label] = (reqs, out)
        launches[label] = c
        del eng
    f32 = None
    for label, _ in LOOPS[1:]:
        for (rid, _), (srid, _), (_, kw) in zip(runs[label][0],
                                                runs["sync"][0], requests):
            same = np.array_equal(runs[label][1][rid], runs["sync"][1][srid])
            if kw.get("temperature") and not same:
                raise AssertionError(f"zero-bubble {tag}{label}: the sampled "
                                     "stream differs from the sync loop's")
            if not same and f32 is None:
                f32 = (build_moe_lm if moe else build_lm)(
                    "cpu", dtype="float32")
                f32.module.load_state_dict(model.module.state_dict())
        parted = 0 if f32 is None else check_identity(
            f32, runs["sync"], runs[label], requests,
            f"zero-bubble {tag}{label}", tie_rel)
        print(f"zero-bubble {tag}{label}: streams parted from the sync "
              f"loop's {parted}/{len(requests)} (at near-ties only)",
              flush=True)
    return launches


def profile_loop(model, device, card, label, **engine_kw):
    """Steady decode, four slots (256-token prompts, contexts ~260-340)
    under one loop: ``LOOP_STEPS`` decode steps timed without the
    profiler, then ``LOOP_PROF_STEPS`` under ``torch.profiler``. Per
    decode step: wall ms (a fused window counts K), device busy ms, CUDA
    kernel launches, ms blocked in the lagged fetch; per launch: the
    host's ms to issue it (no sync inside)."""
    from torch.profiler import ProfilerActivity, profile
    eng = ServingEngine(model, num_slots=4, max_len=2048, page_len=16,
                        prefill_chunk=256, device=device, **engine_kw)
    watch = _LaunchWatch(eng)
    rs = np.random.RandomState(SEED + 2)
    vocab = model.module.layers[0].vocab_size
    for _ in range(4):
        eng.submit(rs.randint(0, vocab, 256), 80)
    while eng.scheduler.prefilling or eng.scheduler.queue_depth \
            or watch.units < 3:
        eng.step()
    torch.cuda.synchronize()

    def run(n_steps):
        s0, u0, f0, i0 = watch.steps, watch.units, eng.fetch_seconds, \
            watch.issue_s
        t0 = time.perf_counter()
        while watch.steps - s0 < n_steps:
            eng.step()
        return (time.perf_counter() - t0, watch.steps - s0,
                watch.units - u0, eng.fetch_seconds - f0,
                watch.issue_s - i0)

    wall, steps, units, fetch, issue = run(LOOP_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        psteps = run(LOOP_PROF_STEPS)[1]
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / psteps
    n_kernels = sum(e.count for e in events) / psteps
    row = dict(wall_ms=wall * 1e3 / steps, busy_ms=busy,
               launches=n_kernels, fetch_ms=fetch * 1e3 / steps,
               issue_ms=issue * 1e3 / units, steps=steps, units=units)
    print(f"zero-bubble profile {label} on {card}: steady decode, 4 slots, "
          f"{steps} steps in {units} launches: {row['wall_ms']:.2f} ms a "
          f"step wall (profiler off); device busy {busy:.2f} ms a step = "
          f"{100 * busy / row['wall_ms']:.1f}%; {n_kernels:.0f} CUDA kernel "
          f"launches a step; blocked in the fetch {row['fetch_ms']:.3f} ms "
          f"a step; {row['issue_ms']:.2f} ms of host time to issue a "
          f"launch", flush=True)
    return row


#: the positions of the four slots in ``capture_check``
CAPTURE_CONTEXTS = (260, 275, 290, 300)


def capture_check(model, dev, num_steps: int, page_len: int = 16,
                  contexts=CAPTURE_CONTEXTS, layout: str = "paged"):
    """Capture readiness of the decode launch: one
    ``decode_step_slots_paged`` (``num_steps`` 1, greedy) or one greedy
    ``decode_fused_slots`` window of ``num_steps``, on static device
    buffers over a bf16 page pool (four slots at ``contexts``, random
    pages), captured in a CUDA graph after a warm call; with ``layout``
    ``"slab"`` the same over a slab pool's rows (``decode_step_slots``,
    the window with no tables). The graph's replay must equal the eager
    call bitwise in its tokens and in every visible page or row. Returns
    ``(tokens equal, pages equal, replay ms, eager ms)``; nothing on the
    main path uses a graph."""
    module = model.module
    params = fuse_qkv_params(module, serving_params(model.params,
                                                    torch.bfloat16))
    s_n = len(contexts)
    length = max(contexts) + num_steps + page_len
    if layout == "slab":
        pool, tables = KVPool(module, s_n, length, dtype=torch.bfloat16,
                              device=dev), None
    else:
        need = [-(-(c + num_steps) // page_len) for c in contexts]
        pool = PagedKVPool(module, s_n, length, page_len=page_len,
                           num_pages=sum(need), dtype=torch.bfloat16,
                           device=dev)
        table = np.full((s_n, pool.pages_per_slot), pool.num_pages,
                        np.int32)
        base = 0
        for i, n in enumerate(need):
            table[i, :n] = np.arange(base, base + n)
            base += n
        tables = torch.as_tensor(table, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    for kv in pool.cache:
        if kv is not None:
            for x in kv["sink"].values():
                x.copy_(torch.randn(x.shape, generator=gen, device=dev))
    vocab = module.layers[0].vocab_size
    rs = np.random.RandomState(SEED + 25)
    tok = torch.as_tensor(rs.randint(0, vocab, s_n), dtype=torch.long,
                          device=dev)
    t = torch.as_tensor(np.asarray(contexts, np.int32), device=dev)
    stop = torch.full((s_n,), -1, dtype=torch.long, device=dev)
    planes = [x for kv in pool.cache if kv is not None
              for x in kv["sink"].values()]
    init = [x.clone() for x in planes]

    def reset():
        for x, x0 in zip(planes, init):
            x.copy_(x0)

    def step():
        with torch.inference_mode():
            if num_steps == 1:
                logits, _ = decode_step_slots(
                    module, params, pool.cache, tok, t) if tables is None \
                    else decode_step_slots_paged(
                        module, params, pool.cache, tok, t, tables,
                        page_len)
                return torch.argmax(logits, dim=-1)[:, None]
            return decode_fused_slots(module, params, pool.cache, tok, t,
                                      stop, num_steps, tables, page_len)[0]

    def visible():
        return [x.clone() for kv in pool.cache if kv is not None
                for key, x in kv.items() if key in ("k", "v")]

    reset()
    eager = step().clone()
    eager_pages = visible()
    eager_ms = time_ms(step, iters=10, warmup=2)
    reset()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    reset()
    with torch.cuda.graph(graph):
        out = step()
    reset()
    graph.replay()
    torch.cuda.synchronize()
    same_tokens = torch.equal(out, eager)
    same_pages = all(torch.equal(a, b)
                     for a, b in zip(visible(), eager_pages))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 20
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return same_tokens, same_pages, start.elapsed_time(end) / reps, eager_ms


#: the engine configurations whose every launch must run free of host
#: syncs: (label, engine keywords, a sampled request in the batch)
SYNC_FREE_CASES = (("greedy bf16", {}, False),
                   ("sampled bf16", {}, True),
                   ("int8 pages", dict(cache_dtype="int8"), True),
                   ("int4 pages", dict(cache_dtype="int4"), True),
                   ("weight_quant int8", dict(weight_quant="int8"), True),
                   ("fused_sampling", dict(fused_sampling=True), True))


def sync_free_run(model, label, engine_kw, sampled, prompts=(64, 120, 200),
                  new_tokens=16, obs_hooks=False):
    """One engine (``overlap=True, fuse_steps=4``) whose every
    ``_launch_step`` runs under ``set_sync_debug_mode("error")``: three
    requests (one sampled with ``sampled``) admitted at once, so single
    steps run while prompts prefill and fused windows after. With
    ``obs_hooks`` the engine's obs hooks (``_ObsSyncWatch``) run so too,
    and the drained engine's read endpoints once. A host sync inside a
    launch or a hook raises; returns the watch (units, steps, windows)."""
    eng = ServingEngine(model, num_slots=4, max_len=512, page_len=16,
                        prefill_chunk=256, device=model.device,
                        overlap=True, fuse_steps=4, **engine_kw)
    watch = _LaunchWatch(eng, strict=True)
    hooks = _ObsSyncWatch(eng) if obs_hooks else None
    rs = np.random.RandomState(SEED + 26)
    vocab = model.module.layers[0].vocab_size
    for i, n in enumerate(prompts):
        kw = dict(temperature=0.8, top_k=40, top_p=0.9, seed=i) \
            if sampled and i == 1 else {}
        eng.submit(rs.randint(0, vocab, n), new_tokens, **kw)
    out = eng.run(max_steps=500)
    if len(out) != len(prompts) or not watch.windows \
            or watch.units == watch.windows:
        raise AssertionError(f"sync-free {label}: {len(out)} requests "
                             f"finished, {watch.units} launches, "
                             f"{watch.windows} fused windows")
    if hooks is not None:
        eng.health()
        eng._telemetry_summary()
        if eng.slo is not None:
            eng.slo.evaluate(eng.metrics)
        if not all(hooks.calls.values()):
            raise AssertionError(f"sync-free {label}: obs hook calls "
                                 f"{hooks.calls}")
    return watch


def sync_free_phase(model, card, moe_model=None):
    """Every ``SYNC_FREE_CASES`` configuration on ``model`` (or, with
    ``moe_model``, its dispatched MoE engine, greedy and sampled): each
    launch, single step or fused window, free of host syncs."""
    cases = SYNC_FREE_CASES if moe_model is None else (
        ("MoE dispatched greedy", {}, False),
        ("MoE dispatched sampled", {}, True))
    for label, kw, sampled in cases:
        w = sync_free_run(moe_model or model, label, kw, sampled)
        print(f"sync-free launches {label} on {card}: {w.units} launches "
              f"({w.windows} fused windows, {w.steps} decode steps) under "
              f"set_sync_debug_mode('error'): no host sync", flush=True)


# --- phase 26: JAX's threefry on the card (K7), sampled serving, the API ---

#: K7's cases: (label, keys R, counters n a key, epilogue): the serving
#: sampler's Gumbel field (8 slots, V 32768, a key a row), a decode
#: step's split of 8 slot keys, a dropout mask's uniforms (B4 S2048 d1024
#: under one key: phase 7's activations), raw bits
K7_CASES = (("gumbel S8 V32768", 8, LM_CFG["vocab"], prng.GUMBEL),
            ("split S8", 8, 2, prng.SPLIT),
            ("dropout mask B4 S2048 d1024", 1,
             4 * 2048 * LM_CFG["d_model"], prng.UNIFORM),
            ("bits 1M", 1, 1 << 20, prng.BITS))
#: 32-bit operations an element: the 20-round hash with its key
#: injections, then the epilogue (a Gumbel field's two logs counted as
#: 15 operations each)
K7_OPS = {prng.SPLIT: 80, prng.BITS: 81, prng.UNIFORM: 86,
          prng.GUMBEL: 116}


def _k7_range(mode):
    return ((float(np.finfo(np.float32).tiny), 1.0) if mode == prng.GUMBEL
            else (0.0, 1.0))


def k7_phase(dev):
    """K7 against its plain version on the card (``K7_CASES``): splits,
    bits and uniforms bitwise, the Gumbel field within
    ``prng.GUMBEL_ULPS``; the small cases bitwise against the CPU's plain
    version too (integer work and exactly rounded uniforms on both); a
    bitwise repeat; graph-replay times against the bound (bytes written,
    or 32-bit operations at the published non-tensor float32 rate: the
    table has no integer entry) and the plain version's eager time. No
    single PyTorch call computes JAX's threefry: no library time."""
    rows = []
    for i, (name, r, n, mode) in enumerate(K7_CASES):
        keys = prng.split(prng.key(SEED + 26 + i), r).to(dev)
        lo, hi = _k7_range(mode)
        out = prng._launch(keys, n, mode, lo, hi)
        ref = prng.draw_reference(keys, n, mode, lo, hi)
        again = prng._launch(keys, n, mode, lo, hi)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        if mode == prng.GUMBEL:
            ulp = float(prng.ulps(out, ref).max())
            ok = ulp <= prng.GUMBEL_ULPS
        else:
            ulp = 0.0
            ok = torch.equal(out, ref)
        if n * r <= 1 << 20:
            cpu = prng.draw_reference(keys.cpu(), n, mode, lo, hi)
            ok = ok and (torch.equal(out.cpu(), cpu) if mode != prng.GUMBEL
                         else float(prng.ulps(out.cpu(), cpu).max())
                         <= prng.GUMBEL_ULPS)
        err = float((out.double() - ref.double()).abs().max())
        ms = graph_ms(lambda: prng._launch(keys, n, mode, lo, hi))
        plain_ms = time_ms(lambda: prng.draw_reference(keys, n, mode, lo,
                                                       hi), iters=5)
        nbytes = out.numel() * out.element_size() + keys.numel() * 8
        bms, by = bound_ms(K7_OPS[mode] * r * n, nbytes, PEAK_F32_FLOPS)
        per_call = kernels_per_call(lambda: prng._launch(keys, n, mode, lo,
                                                         hi))
        print(f"prng (K7) {name}: matches the plain version "
              f"{'bitwise' if mode != prng.GUMBEL else f'within {ulp:g} ulps'}"
              f" {ok}; bitwise repeat {same}; max abs err {err:.3e}; "
              f"{per_call:g} CUDA kernels a call; {ms:.4f} ms (graph "
              f"replay), {nbytes / ms / 1e6:.0f} GB/s, "
              f"{100 * bms / ms:.1f}% of the bound {bms:.4f} ms ({by}); "
              f"plain eager {plain_ms:.4f} ms", flush=True)
        if not (ok and same):
            raise AssertionError(f"K7 disagrees with its plain version on "
                                 f"{name}")
        rows.append(dict(name=name, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bms, bound_by=by,
                         kernels_per_call=per_call))
    return rows


def _row_loop_sampler(logits, temp, top_k, top_p, rows):
    """The per-row sampler the port ran before K7 (a ``torch.rand`` field
    a sampled row, ``-log(-log(u))``, an argmax each), as a launch-count
    yardstick only."""
    greedy = torch.argmax(logits, dim=-1)
    lf = _masked_logits_vec(logits, temp, top_k, top_p)
    sampled = greedy.clone()
    tiny = float(np.finfo(np.float32).tiny)
    for row in rows:
        u = torch.rand(lf.shape[-1], device=lf.device)
        sampled[row] = torch.argmax(
            lf[row] - torch.log(-torch.log(u.clamp_min(tiny))))
    return torch.where(temp > 0.0, sampled, greedy)


def sampler_launches(dev, card):
    """CUDA kernels a sampled decode step's sampler launches (a captured
    graph's kernel nodes), 8 slots of which 6 sample, V 32768: the
    per-row loop before K7, the key split plus ``_sample_vec`` (one K7
    launch for the whole Gumbel field), and the fused sampler (K7 field
    then K4). Returns the counts."""
    rs = np.random.RandomState(SEED + 27)
    s, v = 8, LM_CFG["vocab"]
    logits = torch.from_numpy((rs.randn(s, v) * 3).astype(np.float32)) \
        .to(dev)
    temp = torch.tensor([0.8, 0.0, 1.0, 0.7, 0.0, 1.2, 0.9, 1.1],
                        device=dev)
    top_k = torch.tensor([40, 0, 0, 10, 0, 0, 50, 5], device=dev)
    top_p = torch.tensor([0.9, 1.0, 0.95, 1.0, 1.0, 0.8, 1.0, 1.0],
                         device=dev)
    keys = prng.split(prng.key(SEED), s).to(dev)
    sampled_rows = [i for i in range(s) if float(temp[i]) > 0]

    def keyed(fused):
        def call():
            pair = prng.split(keys)
            sampler = sample_tokens if fused else _sample_vec
            return sampler(logits, temp, top_k, top_p, pair[:, 1])
        return call

    counts = {
        "per-row loop": kernels_per_call(lambda: _row_loop_sampler(
            logits, temp, top_k, top_p, sampled_rows)),
        "K7 + _sample_vec": kernels_per_call(keyed(False)),
        "K7 + K4 (fused)": kernels_per_call(keyed(True))}
    print(f"sampled decode step's sampler on {card}: CUDA kernels a step, "
          f"8 slots (6 sampled), V {v}: {counts}", flush=True)
    if not counts["K7 + _sample_vec"] < counts["per-row loop"]:
        raise AssertionError("the keyed sampler launches no fewer kernels "
                             "than the per-row loop")
    return counts


def sampled_workload(vocab: int):
    """Four requests: three sampled with other knobs and seeds (one
    seed past 2^32), one greedy."""
    rs = np.random.RandomState(SEED + 28)
    return [(rs.randint(0, vocab, 200), dict(temperature=0.8, top_k=40,
                                             top_p=0.9, seed=3)),
            (rs.randint(0, vocab, 120), {}),
            (rs.randint(0, vocab, 300), dict(temperature=1.0, seed=7)),
            (rs.randint(0, vocab, 64), dict(temperature=0.7, top_p=0.8,
                                            seed=2 ** 32 + 5))]


def sampled_serving_phase(model, card):
    """The sampled workload through the synchronous and the pipelined
    loop (``overlap=True``, the default), with the unfused and the fused
    sampler: each pipelined run's streams equal the synchronous loop's
    with the same sampler, byte for byte; K7 launches exactly two per
    sampled decode step launched (the keys' split and the Gumbel field)
    and two per sampled first token; then both samplers' launches under
    ``set_sync_debug_mode("error")`` (no host sync). Returns the K7
    launches of the pipelined unfused run."""
    requests = sampled_workload(model.module.layers[0].vocab_size)
    n_sampled = sum(1 for _, kw in requests if kw)
    runs, launches = {}, {}
    for fused in (False, True):
        for label, kw in (("sync", dict(overlap=False)),
                          ("overlap", dict(overlap=True))):
            watches = []
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            eng, reqs, out, bad, _ = serve(
                model, model.device, requests=requests, num_pages=400,
                fused_sampling=fused,
                setup=lambda e: watches.append(_LaunchWatch(e)), **kw)
            torch.cuda.synchronize()
            c = kernels.launch_counts()
            check_finished(reqs, out, bad)
            w = watches[0]
            want = 2 * w.sampled_steps + 2 * n_sampled
            tag = f"{label}{' fused sampler' if fused else ''}"
            if c["prng"] != want:
                raise AssertionError(f"sampled serving {tag}: {c['prng']} "
                                     f"K7 launches, expected {want} (2 a "
                                     f"sampled step for {w.sampled_steps} "
                                     "steps, 2 a first token)")
            if fused and c["sample_epilogue"] != w.sampled_steps:
                raise AssertionError(f"sampled serving {tag}: "
                                     f"{c['sample_epilogue']} K4 launches "
                                     f"for {w.sampled_steps} sampled steps")
            runs[tag] = [out[rid] for rid, _ in reqs]
            launches[tag] = c
            tok_s = eng.metrics.summary()["decode_tokens_per_sec"]
            print(f"sampled serving {tag} on {card}: {len(reqs)} requests, "
                  f"{w.steps} decode steps ({w.sampled_steps} sampled), "
                  f"decode {tok_s:.1f} tok/s; K7 "
                  f"launches {c['prng']}, K4 "
                  f"{c['sample_epilogue']}, paged_decode "
                  f"{c['paged_decode']}", flush=True)
            del eng
        base = "sync" + (" fused sampler" if fused else "")
        other = "overlap" + (" fused sampler" if fused else "")
        for a, b in zip(runs[base], runs[other]):
            if not np.array_equal(a, b):
                raise AssertionError(f"sampled serving: the {other} "
                                     "streams differ from the sync loop's")
        print(f"sampled serving: the {other} streams equal the sync "
              f"loop's, byte for byte", flush=True)
    for label, kw in (("sampled bf16 (K7)", {}),
                      ("fused_sampling (K7 + K4)",
                       dict(fused_sampling=True))):
        w = sync_free_run(model, label, kw, True)
        print(f"sync-free launches {label} on {card}: {w.units} launches "
              f"({w.windows} fused windows) under set_sync_debug_mode"
              f"('error'): no host sync", flush=True)
    return launches["overlap"]["prng"]


def engine_api_phase(model, card, tie_rel):
    """The engine's synchronous API on the card, under the pipelined
    loop: a deadline and a ``cancel`` landing mid-decode (the partial
    tokens kept, the slot serving the next request), ``run()`` raising
    ``DegradedRequest`` or returning the partial tokens, an
    ``hbm_budget`` engine's pages and real bytes against its budget, and
    ``decode_kernel``: "off" launches no paged kernel, the default one
    per layer in every decode step launched, and the two readouts'
    streams equal or part at a near-tie of the CPU float32 scores
    (``check_identity``: the random LM's scores are flat)."""
    from distkeras_tpu_torch.serving import (DegradedRequest, RequestState,
                                             ServingMetrics)
    vocab = model.module.layers[0].vocab_size
    rs = np.random.RandomState(SEED + 29)
    box = [0.0]

    def engine(**kw):
        return ServingEngine(model, num_slots=2, max_len=2048, page_len=16,
                             prefill_chunk=256, device=model.device,
                             metrics=ServingMetrics(clock=lambda: box[0]),
                             **kw)

    eng = engine()
    late = eng.submit(rs.randint(0, vocab, 200), 32, deadline_s=5.0)
    gone = eng.submit(rs.randint(0, vocab, 150), 32)
    done = {}
    for _ in range(12):
        for r in eng.step():
            done[r.rid] = r
    cancelled = eng.cancel(gone)
    box[0] = 10.0
    nxt = eng.submit(rs.randint(0, vocab, 100), 32)
    while eng.scheduler.pending:
        for r in eng.step():
            done[r.rid] = r
    timed = done[late]
    if not (timed.state is RequestState.TIMED_OUT
            and 0 < len(timed.generated) < 32
            and cancelled.state is RequestState.CANCELLED
            and 0 < len(cancelled.generated) < 32
            and done[nxt].state is RequestState.FINISHED
            and len(done[nxt].generated) == 32):
        raise AssertionError("deadline / cancel under overlap went wrong")
    print(f"engine API on {card}: deadline mid-decode -> "
          f"{timed.state.value} with {len(timed.generated)} tokens; cancel "
          f"mid-decode -> {cancelled.state.value} with "
          f"{len(cancelled.generated)} tokens; the next request finished "
          f"its 32", flush=True)
    for how in ("raise", "return"):
        box[0] = 0.0
        eng = engine()
        rid = eng.submit(rs.randint(0, vocab, 80), 8, deadline_s=1.0)
        box[0] = 2.0
        try:
            out = eng.run(max_steps=50, on_degraded=how)
        except DegradedRequest as e:
            if how != "raise":
                raise
            print(f"engine API: run(on_degraded='raise') raised "
                  f"DegradedRequest ({e.request.state.value})", flush=True)
        else:
            if how != "return" or rid not in out:
                raise AssertionError("run(on_degraded=) went wrong")
            print(f"engine API: run(on_degraded='return') returned "
                  f"{len(out[rid])} tokens of request {rid}", flush=True)
    probe = engine()
    pool_pages = 120
    budget = probe.param_bytes() + pool_pages * probe.pool.page_bytes \
        + probe.pool.page_bytes // 2
    del probe
    eng = engine(hbm_budget=budget)
    for _ in range(3):
        eng.submit(rs.randint(0, vocab, 300), 32)
    eng.run(max_steps=500)
    real = eng.pool.allocated_bytes()
    print(f"hbm_budget engine on {card}: budget {budget} bytes = resident "
          f"weights {eng.param_bytes()} + {eng.pool.num_pages} pages of "
          f"{eng.pool.page_bytes} bytes (+ {budget - eng.param_bytes() - eng.pool.num_pages * eng.pool.page_bytes} "
          f"left over); the pool's planes hold {real} bytes on the card "
          f"(the pages and the sink page)", flush=True)
    if eng.pool.num_pages != pool_pages \
            or real != (pool_pages + 1) * eng.pool.page_bytes:
        raise AssertionError("hbm_budget sized the pool wrongly")
    counts = {}
    for dk in ("auto", "off"):
        watches = []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        e, reqs, out, bad, _ = serve(
            model, model.device, requests=workload(vocab)[:4],
            num_pages=400, decode_kernel=dk,
            setup=lambda x: watches.append(_LaunchWatch(x)))
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        check_finished(reqs, out, bad)
        steps = watches[0].steps
        want = LM_CFG["num_layers"] * steps if dk == "auto" else 0
        if c["paged_decode"] != want:
            raise AssertionError(f"decode_kernel={dk!r}: {c['paged_decode']}"
                                 f" paged_decode launches for {steps} decode"
                                 f" steps, expected {want}")
        counts[dk] = (c["paged_decode"], steps,
                      [out[rid] for rid, _ in reqs])
        print(f"decode_kernel={dk!r} on {card}: {c['paged_decode']} "
              f"paged_decode launches for {steps} decode steps", flush=True)
    requests = workload(vocab)[:4]
    f32 = None
    if any(not np.array_equal(a, b) for a, b in zip(counts["auto"][2],
                                                    counts["off"][2])):
        f32 = build_lm("cpu", dtype="float32")
        f32.module.load_state_dict(model.module.state_dict())
    runs = {dk: ([(i, p) for i, (p, _) in enumerate(requests)],
                 dict(enumerate(counts[dk][2]))) for dk in counts}
    parted = 0 if f32 is None else check_identity(
        f32, runs["auto"], runs["off"], requests, "decode_kernel 'off'",
        tie_rel)
    print(f"decode_kernel 'off' vs 'auto': {parted}/4 streams parted, each "
          f"at a near-tie of the CPU float32 scores", flush=True)


#: relative (to the largest |logit|) agreement with the CPU in float32:
#: bf16 weights and activations through 12 blocks; float32 on the card
#: differs from the CPU only in summation order
E2E_BF16_REL_TOL = 5e-2
E2E_F32_REL_TOL = 1e-3


# --- phase 27: the distributed-SGD family, workers stacked on the card -----

#: phase 27: four workers of two rows each over phase 7's 32 rows x 2048,
#: two epochs (4 global steps an epoch), amortized window 2
DIST_WORKERS, DIST_BATCH, DIST_WINDOW = 4, 2, 2
#: the depth of the other trainers' runs (full width)
DIST_SMALL_LAYERS = 2
#: DynSGD's per-worker windows
DIST_DYN_WINDOWS = [1, 2, 2, 4]
DIST_KERNELS = TRAINING_KERNELS + ("prng",)


def _dist_kw(optimizer_lr=True, **kw):
    out = dict(batch_size=DIST_BATCH, num_epoch=TRAIN_EPOCHS,
               worker_optimizer="adam", loss=TRAIN_LOSS, **kw)
    if optimizer_lr:
        out["learning_rate"] = TRAIN_LR
    else:  # EASGD's learning_rate is its elastic rate
        out["optimizer_kwargs"] = {"learning_rate": TRAIN_LR}
    return out


def check_distributed(label, trainer, launches, num_layers, worker_steps,
                      prng_extra):
    """Finite per-worker losses of ``worker_steps`` worker steps whose last
    epoch's mean is under the first step's; each flash kernel launched
    exactly once per layer in every worker step, K7 once per worker step
    (the carry's split) plus ``prng_extra`` (the workers' key split, an
    ensemble's member builds)."""
    losses = trainer.get_history().losses()
    if losses.ndim != 2 or losses.size != worker_steps \
            or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: expected {worker_steps} finite "
                             f"per-worker losses, got {losses}")
    first = float(losses[0].mean())
    last = float(np.mean(trainer.history.epochs[-1]["loss"]))
    if not last < first:
        raise AssertionError(f"{label}: loss did not fall: first step "
                             f"{first}, last epoch mean {last}")
    for name in TRAINING_KERNELS:
        if launches[name] != num_layers * worker_steps:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times in "
                f"{worker_steps} worker steps of a {num_layers}-layer "
                f"model; expected {num_layers * worker_steps}")
    if launches["prng"] != worker_steps + prng_extra:
        raise AssertionError(f"{label}: prng launched {launches['prng']} "
                             f"times; expected {worker_steps} + "
                             f"{prng_extra}")
    return first, last


def stacked_costs(model, dev, data, num_workers=DIST_WORKERS, n=8):
    """On a fresh DOWNPOUR engine state of ``model``: the device ms of one
    amortized commit of ``num_workers`` stacked workers (their
    snapshots, the center, the tail carry) by CUDA events, and the wall
    ms of a warm worker step of the stack against a warm step of the
    plain trainer's carry on the model's own tensors (host clock to a
    synchronize, ``n`` steps each, batch ``DIST_BATCH``)."""
    loss, opt = get_loss(TRAIN_LOSS), get_optimizer("adam",
                                                    learning_rate=TRAIN_LR)
    eng = DistributedEngine(model.module, loss, opt, DownpourAlgo(), None,
                            EngineConfig(num_workers=num_workers,
                                         window=DIST_WINDOW, amortized=True))
    state = eng.init_state(model.params, prng.key(SEED, dev))
    w = state["worker"]
    snap = tree_map(torch.clone, w["params"])
    rows = list(range(num_workers))
    commit = time_ms(lambda: eng._commit(state, rows, snap), iters=5,
                     warmup=1)
    X, Y = (torch.from_numpy(a[:DIST_BATCH]).to(dev) for a in data.arrays())
    stack = WorkerStack(eng.train_step, w["params"], w["opt"], w["rng"])
    carry = [TrainCarry(model.params, opt.init(model.params),
                        prng.key(SEED, dev))]

    def plain():
        carry[0], _ = eng.train_step(carry[0], (X, Y))

    def wall_ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    worker = wall_ms(lambda: [stack.step(i, X, Y) for i in rows][-1]) \
        / num_workers
    return commit, worker, wall_ms(plain)


def engine_sync_free(model, algo, window, amortized, num_workers=4,
                     steps=4, batch=2, seq=256):
    """One engine epoch of ``model`` with ``algo``'s commits, its data on
    the card, under ``set_sync_debug_mode("error")``: a host sync inside
    the epoch (a step, a commit) raises. Returns the engine."""
    eng = DistributedEngine(model.module, get_loss(TRAIN_LOSS),
                            get_optimizer("adam", learning_rate=TRAIN_LR),
                            algo, None,
                            EngineConfig(num_workers=num_workers,
                                         window=window, amortized=amortized))
    state = eng.init_state(model.params, prng.key(SEED, model.device))
    vocab = model.module.layers[0].vocab_size
    rs = np.random.RandomState(SEED + 27)
    toks = torch.from_numpy(rs.randint(0, vocab, (steps, num_workers, batch,
                                                  seq + 1))).to(model.device)
    torch.cuda.synchronize()
    with _SyncErrors():
        eng.run_epoch(state, toks[..., :-1], toks[..., 1:])
    torch.cuda.synchronize()
    return eng


#: the stacked-worker runs phase 27 holds at two layers: (label, trainer,
#: keywords, amortized); ``amortized`` False pins the engine to the
#: per-step program (None: the engine's auto rule)
DIST_SMALL_RUNS = (
    ("AEASGD per-step", "AEASGD", dict(
        communication_window=DIST_WINDOW, rho=5.0, learning_rate=0.01),
     False),
    # the server's step is adag_lr * delta / sqrt(acc): the first commit
    # moves every weight by ~adag_lr, so it is set to adam's rate
    ("ADAG", "ADAG", dict(communication_window=DIST_WINDOW,
                          adag_learning_rate=TRAIN_LR), None),
    ("DynSGD per-worker windows", "DynSGD",
     dict(communication_window=DIST_DYN_WINDOWS), None),
    ("AveragingTrainer", "AveragingTrainer", {}, None),
)


@contextlib.contextmanager
def engine_program(amortized):
    """Within the block, the family's trainers build their engines with
    ``EngineConfig(amortized=amortized)`` (None: the auto rule). The
    trainers, as JAX's, leave the epoch program to the engine."""
    import distkeras_tpu_torch.parallel.distributed as dist
    saved = dist.EngineConfig
    if amortized is not None:
        dist.EngineConfig = functools.partial(saved, amortized=amortized)
    try:
        yield
    finally:
        dist.EngineConfig = saved

#: sync-free engine epochs: (label, algorithm, window, amortized)
DIST_SYNC_FREE = (
    ("DOWNPOUR amortized, staggered", DownpourAlgo(), DIST_WINDOW, True),
    ("AEASGD per-step", ElasticAlgo(alpha=0.05), DIST_WINDOW, False),
    ("ADAG", AdagAlgo(), DIST_WINDOW, None),
    ("DynSGD per-worker windows", DynSGDAlgo(), DIST_DYN_WINDOWS, None),
    ("AveragingTrainer", AveragingAlgo(), 4, None),
)


def distributed_phase(dev, card):
    """Phase 27: the distributed-SGD family with its workers stacked on
    the card. DOWNPOUR on the full 218M LM (4 workers, window 2
    amortized, two epochs of phase 7's data at batch 2): the loss falls,
    K1f/K1dq/K1dkv launch exactly 12 times per worker step and K7 once
    (plus the workers' key split), the commits are exactly ceil(S / K)
    an epoch, the center is finite; worker steps/s, peak memory and one
    commit's device ms. Then at two layers of the same widths: AEASGD on
    the per-step path, ADAG, DynSGD with per-worker windows,
    AveragingTrainer, a 2-member EnsembleTrainer and a 2-worker
    HostAsyncTrainer (DOWNPOUR, in-process server), each with its launch
    counts and a falling loss; and one engine epoch of each algorithm
    under ``set_sync_debug_mode("error")``. Returns the runs' launch
    counts by path."""
    import distkeras_tpu_torch.parallel as par
    data = training_data(LM_CFG["vocab"])
    n_layers = LM_CFG["num_layers"]
    S = TRAIN_ROWS // (DIST_WORKERS * DIST_BATCH)
    steps = TRAIN_EPOCHS * S * DIST_WORKERS
    by_path = {}

    model = build_lm(dev)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = par.DOWNPOUR(model, num_workers=DIST_WORKERS,
                      communication_window=DIST_WINDOW, **_dist_kw())
    c = counted_train(tr, data)
    peak = torch.cuda.max_memory_allocated()
    first, last = check_distributed("DOWNPOUR", tr, c, n_layers, steps, 1)
    commits = TRAIN_EPOCHS * -(-S // DIST_WINDOW)
    if (tr.engine.server_updates, tr.engine.worker_commits) != \
            (commits, commits * DIST_WORKERS):
        raise AssertionError(
            f"DOWNPOUR: {tr.engine.server_updates} commits of "
            f"{tr.engine.worker_commits} workers; expected {commits} of "
            f"{commits * DIST_WORKERS}")
    if not all(bool(torch.isfinite(p).all()) for p in model.module.parameters()):
        raise AssertionError("DOWNPOUR: the center is not finite")
    secs = tr.get_training_time()
    by_path["distributed_downpour"] = c
    print(f"distributed DOWNPOUR on {card}: {DIST_WORKERS} stacked workers "
          f"x B{DIST_BATCH} S{TRAIN_SEQ}, window {DIST_WINDOW} amortized, "
          f"{steps} worker steps in {secs:.2f} s ({steps / secs:.2f} worker "
          f"steps/s); loss {first:.4f} -> last epoch mean {last:.4f}; "
          f"{tr.engine.server_updates} commits; launches "
          f"{ {k: c[k] for k in DIST_KERNELS} }; peak device memory "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB allocated "
          f"before the run)", flush=True)
    del tr
    gc.collect()
    commit, worker, plain = stacked_costs(model, dev, data)
    print(f"distributed commit on {card}: {commit:.3f} ms device time "
          f"(CUDA events) for one amortized DOWNPOUR commit of "
          f"{DIST_WORKERS} workers' snapshots "
          f"({model.num_params() / 1e6:.1f}M parameters a worker, float32); "
          f"a warm stacked worker step {worker:.1f} ms wall against "
          f"{plain:.1f} ms for the plain trainer's step (B{DIST_BATCH} "
          f"S{TRAIN_SEQ}, adam)", flush=True)
    del model
    gc.collect()

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    small = build_lm(dev, num_layers=DIST_SMALL_LAYERS)
    build_draws = kernels.launch_counts()["prng"]
    for label, name, kw, amortized in DIST_SMALL_RUNS:
        model = build_lm(dev, num_layers=DIST_SMALL_LAYERS)
        tr = getattr(par, name)(
            model, num_workers=DIST_WORKERS,
            **_dist_kw(optimizer_lr=not name.endswith("EASGD"), **kw))
        with engine_program(amortized):
            c = counted_train(tr, data)
        if amortized is not None and tr.engine.amortized != amortized:
            raise AssertionError(f"{label}: the engine ran amortized="
                                 f"{tr.engine.amortized}")
        first, last = check_distributed(label, tr, c, DIST_SMALL_LAYERS,
                                        steps, 1)
        by_path["distributed_" + name.lower()] = c
        secs = tr.get_training_time()
        print(f"distributed {label} ({DIST_SMALL_LAYERS} layers) on {card}: "
              f"{steps} worker steps in {secs:.2f} s ({steps / secs:.2f} "
              f"worker steps/s), {tr.engine.server_updates} commits "
              f"(amortized {tr.engine.amortized}); loss {first:.4f} -> "
              f"{last:.4f}; launches {dict((k, c[k]) for k in DIST_KERNELS)}",
              flush=True)
        del tr, model

    k = 2
    ens = par.EnsembleTrainer(small, num_models=k, **_dist_kw())
    c = counted_train(ens, data)
    ens_steps = TRAIN_EPOCHS * (TRAIN_ROWS // DIST_BATCH) * k
    first, last = check_distributed("EnsembleTrainer", ens, c,
                                    DIST_SMALL_LAYERS, ens_steps,
                                    1 + k * build_draws)
    by_path["ensemble"] = c
    secs = ens.get_training_time()
    print(f"EnsembleTrainer ({k} members, {DIST_SMALL_LAYERS} layers) on "
          f"{card}: {ens_steps} member steps in {secs:.2f} s "
          f"({ens_steps / secs:.2f} steps/s); loss {first:.4f} -> "
          f"{last:.4f}; launches {dict((n, c[n]) for n in DIST_KERNELS)} "
          f"({build_draws} K7 draws a member build)", flush=True)
    del ens

    host_workers = 2
    host = par.HostAsyncTrainer(small, algorithm="downpour",
                                num_workers=host_workers,
                                communication_window=DIST_WINDOW,
                                **_dist_kw())
    c = counted_train(host, data)
    host_steps = TRAIN_EPOCHS * TRAIN_ROWS // DIST_BATCH
    first, last = check_distributed("HostAsyncTrainer", host, c,
                                    DIST_SMALL_LAYERS, host_steps, 0)
    by_path["host_async"] = c
    secs = host.get_training_time()
    print(f"HostAsyncTrainer (downpour, {host_workers} worker threads, "
          f"in-process server, {DIST_SMALL_LAYERS} layers) on {card}: "
          f"{host_steps} worker steps in {secs:.2f} s "
          f"({host_steps / secs:.2f} worker steps/s), "
          f"{host.parameter_server.num_updates} server updates; loss "
          f"{first:.4f} -> {last:.4f}; launches "
          f"{dict((n, c[n]) for n in DIST_KERNELS)}", flush=True)
    del host

    for label, algo, window, amortized in DIST_SYNC_FREE:
        eng = engine_sync_free(small, algo, window, amortized)
        print(f"sync-free engine epoch {label} on {card}: "
              f"{eng.server_updates} commits under "
              f"set_sync_debug_mode('error'): no host sync", flush=True)
    del small
    gc.collect()
    return by_path


# --- phase 28: the BASELINE vision models with BatchNorm state -------------

#: ResNet-50 at its published width (BASELINE config 3): ImageNet's
#: 224x224x3 images and 1000 classes, bf16 compute
RESNET_SHAPE, RESNET_CLASSES, RESNET_PARAMS = (224, 224, 3), 1000, 25_557_032
#: seeded images a run trains on (the datasets are not in the repo), the
#: label classes used (a few of the head's 1000, each with its own image
#: pattern, so the loss can fall within a few steps), the SingleTrainer
#: batch and the stacked workers' count and batch
VISION_IMAGES, VISION_LABELS = 256, 10
VISION_BATCH = 32
VISION_WORKERS, VISION_WORKER_BATCH, VISION_WINDOW = 4, 8, 2
VISION_LR = 1e-3
#: LeNet-5's CIFAR-10 shape (BASELINE config 2)
LENET_SHAPE = (32, 32, 3)
#: the card's bf16 logits against the CPU float32 path, relative to the
#: largest CPU logit
VISION_LOGIT_TOL = 5e-2
#: a ResNet-50 step's device time by the operators that launched it
#: (``torch.profiler`` CPU ops, self device time): the convolutions
#: (cuDNN, forward and backward), the head's GEMMs, the max pool; the
#: adam update is profiled alone, and the rest (BatchNorm's passes, ReLU,
#: casts, residual adds, the loss) is the remainder
VISION_OP_GROUPS = (
    ("convolutions (aten::cudnn_convolution, convolution_backward)",
     ("aten::cudnn_convolution", "aten::convolution_backward")),
    ("head GEMMs (aten::mm, aten::addmm)", ("aten::mm", "aten::addmm")),
    ("max pool", ("aten::max_pool2d_with_indices",
                  "aten::max_pool2d_with_indices_backward")),
)


def vision_data(n=None, shape=None, seed=SEED):
    """``n`` seeded images of ``shape`` (default ``VISION_IMAGES`` of
    ``RESNET_SHAPE``) and their labels: unit noise plus the pattern of
    the label's class (one of ``VISION_LABELS``)."""
    n = VISION_IMAGES if n is None else n
    shape = RESNET_SHAPE if shape is None else shape
    rs = np.random.RandomState(seed + 28)
    patterns = rs.randn(VISION_LABELS, *shape).astype(np.float32)
    y = rs.randint(0, VISION_LABELS, n)
    X = rs.randn(n, *shape).astype(np.float32) + 0.5 * patterns[y]
    return Dataset.from_arrays(X, y)


def cpu_float32_copy(model, spec):
    """The model's weights and state in a CPU float32 build of ``spec``
    (sized on the ``meta`` device, so nothing is drawn twice)."""
    cpu = Model.build(spec, model.input_shape, device="meta")
    cpu.module.to_empty(device="cpu")
    cpu.device = torch.device("cpu")
    cpu.set_weights(model.get_weights())
    return cpu


def _state_leaves(model):
    return [t.detach().float().cpu().clone() for t in tree_leaves(model.state)]


def check_vision_training(label, losses, before, model, first_steps=1):
    """Finite losses whose last steps' mean is under the first steps';
    BN statistics that moved and stay finite. Returns (first, last)."""
    losses = np.asarray(losses, np.float64).reshape(len(losses), -1)
    first = float(losses[:first_steps].mean())
    last = float(losses[-max(first_steps, 3):].mean())
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    after = _state_leaves(model)
    if not all(bool(torch.isfinite(a).all()) for a in after):
        raise AssertionError(f"{label}: BN statistics not finite")
    if all(torch.equal(a, b) for a, b in zip(after, before)):
        raise AssertionError(f"{label}: BN statistics did not move")
    return first, last


def _device_ms(prof, names=None):
    """Self device ms of the profiled CPU ops named ``names`` (all: None)
    and their calls."""
    hit = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and (names is None or e.key in names)]
    return (sum(e.self_device_time_total for e in hit) / 1e3,
            sum(e.count for e in hit))


def profile_vision_step(model, card, xb, yb, label="ResNet-50",
                        groups=VISION_OP_GROUPS, kernel_groups=()):
    """Warm training steps of ``model`` on ``(xb, yb)`` (adam): ms a step
    (host clock to a synchronize, profiler off), images/s, peak device
    memory; ``torch.profiler`` over one step: kernel launches, the
    device's busy ms and its share of the unprofiled step, the device
    time by ``groups`` (profiled CPU ops) and by ``kernel_groups``
    (``(label, kernel name substrings)``: the port's own kernels, which
    no aten op launches), and the adam update profiled alone. Returns
    ``(step_ms, busy_share, peak_gb)``."""
    tag = "profile-" + "".join(ch for ch in label.lower() if ch.isalnum())
    from torch.profiler import ProfilerActivity, profile
    opt = adam(VISION_LR)
    loss_fn = sparse_categorical_crossentropy_from_logits
    step = make_train_step(model.module, loss_fn, opt)
    carry = TrainCarry(model.params, opt.init(model.params), None,
                       model.state)
    carry, _ = step(carry, (xb, yb))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        carry, _ = step(carry, (xb, yb))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        carry, _ = step(carry, (xb, yb))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    _, grads, _ = value_and_grad(model.module, loss_fn, carry.params, xb,
                                 yb, state=carry.state)
    torch.cuda.synchronize()
    with profile(activities=activities) as alone:
        with torch.no_grad():
            upd, _ = opt.update(grads, carry.opt_state, carry.params)
            apply_updates(carry.params, upd)
        torch.cuda.synchronize()
    adam_ms, adam_calls = _device_ms(alone)
    images = xb.shape[0]
    hwc = "x".join(str(d) for d in xb.shape[1:])
    print(f"{label} training step on {card}: {step_ms:.1f} ms/step (B"
          f"{images} {hwc}, bf16, adam, profiler off), "
          f"{images / step_ms * 1e3:.1f} images/s; peak device memory "
          f"{peak_gb:.2f} GiB ({base_gb:.2f} GiB allocated before the "
          f"steps); profiled step: {launches} kernel launches, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / step_ms:.0f}% of the "
          f"unprofiled step, {prof_ms:.1f} ms wall profiled)", flush=True)
    grouped = 0.0
    for name, names in groups:
        ms, calls = _device_ms(prof, names)
        grouped += ms
        print(f"{tag}: {name}: {ms:.3f} ms in {calls} calls", flush=True)
    for name, keys in kernel_groups:
        hit = [e for e in kern if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in hit) / 1e3
        grouped += ms
        print(f"{tag}: {name}: {ms:.3f} ms in "
              f"{sum(e.count for e in hit)} launches", flush=True)
    print(f"{tag}: adam update (profiled alone, "
          f"{len(tree_leaves(carry.params))} leaves): {adam_ms:.3f} ms in "
          f"{adam_calls} op calls", flush=True)
    print(f"{tag}: the rest (normalizations, activations, casts, residual "
          f"adds, the loss): {busy_ms - grouped - adam_ms:.3f} ms",
          flush=True)
    for e in kern[:12]:
        print(f"{tag}:   {e.self_device_time_total / 1e3:8.3f} "
              f"ms  x{e.count:<5d} {e.key[:100]}", flush=True)
    return step_ms, busy_ms / step_ms, peak_gb


class _StateWatch:
    """While entered, ``DistributedEngine.extract_model`` keeps the
    engine state it was given (the workers' ``[W, ...]`` rows)."""

    def __enter__(self):
        self.saved = DistributedEngine.extract_model
        watch = self

        def extract(eng, state):
            watch.rows = tree_map(lambda s: s.detach().clone(),
                                  state["worker"]["state"])
            return watch.saved(eng, state)

        DistributedEngine.extract_model = extract
        return self

    def __exit__(self, *exc):
        DistributedEngine.extract_model = self.saved


def perstep_commits(num_workers, window, steps):
    """The per-step path's (server updates, worker commits) over
    ``steps`` micro-steps: worker ``i`` (offset ``i * K // W``) commits
    where ``(t + 1 + offset_i) % K == 0``."""
    offsets = [(i * window // num_workers) % window
               for i in range(num_workers)]
    rows = [[i for i in range(num_workers)
             if (t + 1 + offsets[i]) % window == 0] for t in range(steps)]
    return sum(1 for r in rows if r), sum(len(r) for r in rows)


def vision_phase(dev, card):
    """Phase 28: ResNet-50 (BASELINE config 3) built, served and trained
    on the card with its BatchNorm state; AEASGD over stacked workers;
    ADAG on LeNet-5 (config 2); a sync-free engine epoch of
    ``resnet18_thin``. Returns the K7 launches of its runs by path."""
    import distkeras_tpu_torch.parallel as par
    by_path = {}
    spec = zoo.resnet50(RESNET_CLASSES, dtype="bfloat16")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = Model.build(spec, RESNET_SHAPE, seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    c = kernels.launch_counts()
    by_path["vision_build"] = c
    if model.num_params() != RESNET_PARAMS or c["prng"] < 1:
        raise AssertionError(f"ResNet-50: {model.num_params()} parameters, "
                             f"{c['prng']} K7 launches")
    print(f"ResNet-50 built on {card} in {build_s:.2f} s: "
          f"{model.num_params()} parameters, "
          f"{len(tree_leaves(model.state))} BN state tensors, "
          f"{c['prng']} K7 launches (draws and key splits)", flush=True)

    data = vision_data()
    X, y = data.arrays()
    cpu = cpu_float32_copy(model, zoo.resnet50(RESNET_CLASSES))
    xb8 = X[:8]
    card_logits = model.predict(xb8)
    cpu_logits = cpu.predict(xb8)
    scale = float(np.abs(cpu_logits).max())
    rel = float(np.abs(card_logits - cpu_logits).max()) / scale
    print(f"ResNet-50 B8 eval logits on {card} (bf16) vs the CPU float32 "
          f"path: rel err {rel:.3e} (tol {VISION_LOGIT_TOL}, max |logit| "
          f"{scale:.3f})", flush=True)
    if card_logits.shape != (8, RESNET_CLASSES) or \
            not np.isfinite(card_logits).all() or rel > VISION_LOGIT_TOL:
        raise AssertionError("ResNet-50 card logits disagree with the CPU")
    del cpu
    gc.collect()

    x64 = X[:64]
    t0 = time.perf_counter()
    pred = ModelPredictor(model, batch_size_per_device=16).predict(
        Dataset({"features": x64}))["prediction"]
    pred_s = time.perf_counter() - t0
    ref = model.predict(x64, batch_size=16)
    if not np.array_equal(pred, ref):
        raise AssertionError("ModelPredictor differs from Model.predict")
    print(f"ModelPredictor on {card}: 64 images in {pred_s:.2f} s (B16, "
          f"the first call included) equal to Model.predict bitwise",
          flush=True)

    before = _state_leaves(model)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = SingleTrainer(model, worker_optimizer="adam",
                       learning_rate=VISION_LR, loss=TRAIN_LOSS,
                       batch_size=VISION_BATCH, num_epoch=1)
    c = counted_train(tr, data)
    peak = torch.cuda.max_memory_allocated()
    by_path["vision_training"] = c
    losses = tr.get_history().losses()
    steps = VISION_IMAGES // VISION_BATCH
    if len(losses) != steps or c["prng"] != steps:
        raise AssertionError(f"SingleTrainer: {len(losses)} steps, "
                             f"{c['prng']} K7 launches; expected {steps}")
    first, last = check_vision_training("ResNet-50 SingleTrainer", losses,
                                        before, model)
    secs = tr.get_training_time()
    print(f"ResNet-50 SingleTrainer on {card}: {steps} steps of B"
          f"{VISION_BATCH} in {secs:.2f} s ({VISION_IMAGES / secs:.1f} "
          f"images/s, the first step's cuDNN set-up included); loss "
          f"{first:.4f} -> {last:.4f} (per step "
          f"{np.array2string(losses, precision=3)}); peak device memory "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB allocated before "
          f"the run); K7 launches {c['prng']}", flush=True)
    xb, yb = (torch.from_numpy(a[:VISION_BATCH]).to(dev) for a in (X, y))
    profile_vision_step(model, card, xb, yb)
    del tr, xb, yb
    gc.collect()

    # AEASGD (BASELINE config 3) over stacked workers, the auto program
    before = _state_leaves(model)
    tr = par.AEASGD(model, num_workers=VISION_WORKERS,
                    batch_size=VISION_WORKER_BATCH, num_epoch=1,
                    communication_window=VISION_WINDOW, rho=5.0,
                    learning_rate=0.01, worker_optimizer="adam",
                    optimizer_kwargs={"learning_rate": VISION_LR},
                    loss=TRAIN_LOSS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with _StateWatch() as watch:
            c = counted_train(tr, data)
    by_path["vision_aeasgd"] = c
    S = VISION_IMAGES // (VISION_WORKERS * VISION_WORKER_BATCH)
    eng = tr.engine
    expect = ((-(-S // VISION_WINDOW), VISION_WORKERS * -(-S // VISION_WINDOW))
              if eng.amortized else
              perstep_commits(VISION_WORKERS, VISION_WINDOW, S))
    if (eng.server_updates, eng.worker_commits) != expect:
        raise AssertionError(f"AEASGD: {eng.server_updates} commits of "
                             f"{eng.worker_commits} workers; expected "
                             f"{expect}")
    losses = tr.get_history().losses()
    first, last = check_vision_training("AEASGD", losses, before, model)
    mean = [r.float().mean(0).cpu() for r in tree_leaves(watch.rows)]
    got = _state_leaves(model)
    err = max(float((a - b).abs().max()) for a, b in zip(got, mean))
    if err != 0.0:
        raise AssertionError(f"AEASGD: the extracted state is not the "
                             f"workers' mean (max diff {err})")
    secs = tr.get_training_time()
    print(f"ResNet-50 AEASGD on {card}: {VISION_WORKERS} stacked workers x "
          f"B{VISION_WORKER_BATCH}, window {VISION_WINDOW} (amortized "
          f"{eng.amortized}), one epoch: {S * VISION_WORKERS} worker steps "
          f"in {secs:.2f} s ({VISION_IMAGES / secs:.1f} images/s); loss "
          f"{first:.4f} -> {last:.4f}; {eng.server_updates} commits of "
          f"{eng.worker_commits} workers (exact); extracted BN state = the "
          f"workers' mean over {len(mean)} tensors", flush=True)
    del tr, model, watch
    gc.collect()

    # ADAG on LeNet-5 (BASELINE config 2)
    lenet = Model.build(zoo.lenet5(VISION_LABELS), LENET_SHAPE, seed=SEED,
                        device=dev)
    ldata = vision_data(shape=LENET_SHAPE)
    tr = par.ADAG(lenet, num_workers=VISION_WORKERS,
                  batch_size=VISION_WORKER_BATCH, num_epoch=2,
                  communication_window=VISION_WINDOW,
                  adag_learning_rate=VISION_LR, worker_optimizer="adam",
                  learning_rate=VISION_LR, loss=TRAIN_LOSS)
    c = counted_train(tr, ldata)
    by_path["vision_adag"] = c
    expect = perstep_commits(VISION_WORKERS, VISION_WINDOW, 2 * S)
    if (tr.engine.server_updates, tr.engine.worker_commits) != expect:
        raise AssertionError(f"ADAG: {tr.engine.server_updates} commits of "
                             f"{tr.engine.worker_commits} workers; "
                             f"expected {expect}")
    losses = tr.get_history().losses()
    lfirst = float(losses[:S].mean())
    llast = float(losses[-S:].mean())
    if not (np.isfinite(losses).all() and llast < lfirst):
        raise AssertionError(f"ADAG: loss did not fall: {losses}")
    print(f"LeNet-5 ADAG on {card}: {VISION_WORKERS} workers x B"
          f"{VISION_WORKER_BATCH} over 32x32x3, 2 epochs, window "
          f"{VISION_WINDOW}: first epoch mean loss {lfirst:.4f} -> last "
          f"{llast:.4f}; {tr.engine.server_updates} commits of "
          f"{tr.engine.worker_commits} workers (exact)", flush=True)
    del tr, lenet

    # the in-place state write of an engine epoch makes no host sync
    thin = Model.build(zoo.resnet18_thin(VISION_LABELS), (32, 32, 3),
                       seed=SEED, device=dev)
    eng = DistributedEngine(thin.module, get_loss(TRAIN_LOSS),
                            get_optimizer("adam", learning_rate=VISION_LR),
                            ElasticAlgo(alpha=0.05), None,
                            EngineConfig(num_workers=VISION_WORKERS,
                                         window=VISION_WINDOW,
                                         amortized=False))
    state = eng.init_state(thin.params, prng.key(SEED, dev), thin.state)
    tdata = vision_data(n=4 * VISION_WORKERS * VISION_WORKER_BATCH,
                        shape=(32, 32, 3))
    Xs, Ys, _ = shard_epoch_data(*tdata.arrays(), VISION_WORKERS,
                                 VISION_WORKER_BATCH)
    Xs, Ys = torch.from_numpy(Xs).to(dev), torch.from_numpy(Ys).to(dev)
    rows0 = [t.clone() for t in tree_leaves(state["worker"]["state"])]
    torch.cuda.synchronize()
    with _SyncErrors():
        eng.run_epoch(state, Xs, Ys)
    torch.cuda.synchronize()
    moved = sum(not torch.equal(a, b) for a, b in
                zip(rows0, tree_leaves(state["worker"]["state"])))
    if not moved:
        raise AssertionError("sync-free epoch: the workers' BN state did "
                             "not move")
    print(f"sync-free engine epoch of resnet18_thin (AEASGD per-step, "
          f"{VISION_WORKERS} workers, BN state rows written in place) on "
          f"{card}: {eng.server_updates} commits under "
          f"set_sync_debug_mode('error'): no host sync; {moved} state "
          f"tensors moved", flush=True)
    del thin, eng, state
    gc.collect()
    return by_path


# --- phase 29: the rest of the zoo -------------------------------------------

#: ViT-S/16 (``zoo.vit()`` defaults: 224x224x3, patch 16, d_model 384, 6
#: heads, 12 layers, MLP x4, 1000 classes) and its training run: 8 steps
#: of B32 over phase 28's 256 seeded images
VIT_LAYERS, VIT_BATCH = 12, 32
#: the gradient check's depth and batch (card float32 / bf16 against the
#: CPU float32 path)
VIT_GRAD_LAYERS, VIT_GRAD_BATCH = 2, 4
VIT_GRAD_F32_TOL, VIT_GRAD_BF16_TOL = 1e-3, 5e-2
#: ViT's kernels in a step's profile, by their device functions
VIT_KERNEL_GROUPS = (("K1f (flash_fwd)", ("flash_fwd_kernel",)),
                     ("K1dq (flash_bwd_dq)", ("flash_bwd_dq_kernel",)),
                     ("K1dkv (flash_bwd_dkv)", ("flash_bwd_dkv_kernel",)))
VIT_OP_GROUPS = (("GEMMs (aten::mm, aten::bmm, aten::addmm)",
                  ("aten::mm", "aten::bmm", "aten::addmm")),
                 ("patchify convolution (cuDNN)",
                  ("aten::cudnn_convolution", "aten::convolution_backward")))
#: MobileNet-v1 1.0 at 224x224x3: 4 SingleTrainer steps of B32
MOBILENET_STEPS = 4
#: BASELINE config 5: ``bilstm_classifier(units=64, num_classes=2)``,
#: float32, over rows of 200 steps of 300 features (the width of the
#: word vectors the reference's text examples feed; seeded stand-ins:
#: no corpus is in the repo), 1,000 rows through ``ModelPredictor`` at
#: 128 a batch (a ragged last batch of 104)
BILSTM_UNITS, BILSTM_SEQ, BILSTM_FEATURES = 64, 200, 300
BILSTM_ROWS, BILSTM_BATCH = 1000, 128
BILSTM_TOL = 1e-4
#: the LM file written on the CPU: LM_CFG's widths at 2 layers, float32
ZOO_LM_LAYERS, ZOO_LM_PROMPT, ZOO_LM_NEW = 2, 64, 8


def meta_draws(spec, shape) -> int:
    """The K7 launches a build of ``spec`` makes on the card: the draws
    of a rehearsal of the same build on the ``meta`` device (the draws
    follow the control flow, not the device), counted around
    ``prng.draw``."""
    real, n = prng.draw, [0]

    def counted(*args, **kw):
        out = real(*args, **kw)
        n[0] += out.numel() > 0
        return out

    prng.draw = counted
    try:
        Model.build(spec, shape, device="meta")
    finally:
        prng.draw = real
    return n[0]


def counted_build(spec, shape, dev, label, card):
    """``Model.build(spec)`` on the card, its K7 launches held to the
    meta rehearsal's count. Returns ``(model, launch counts)``."""
    expect = meta_draws(copy.deepcopy(spec), shape)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = Model.build(spec, shape, seed=SEED, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = kernels.launch_counts()
    if c["prng"] != expect:
        raise AssertionError(f"{label}: the build launched K7 {c['prng']} "
                             f"times; its meta rehearsal draws {expect}")
    print(f"{label} built on {card} in {secs:.2f} s: "
          f"{model.num_params()} parameters, {c['prng']} K7 launches (the "
          f"meta rehearsal's {expect})", flush=True)
    return model, c


def logits_vs_cpu32(model, spec32, x, label, card, tol=VISION_LOGIT_TOL):
    """The card's eval logits on ``x`` against a CPU float32 build of
    ``spec32`` with the same weights and state; returns the CPU model."""
    cpu = cpu_float32_copy(model, spec32)
    got, ref = model.predict(x), cpu.predict(x)
    scale = float(np.abs(ref).max())
    rel = float(np.abs(got - ref).max()) / scale
    print(f"{label} B{len(x)} eval logits on {card} vs the CPU float32 "
          f"path: rel err {rel:.3e} (tol {tol}, max |logit| {scale:.3f})",
          flush=True)
    if got.shape != ref.shape or not np.isfinite(got).all() or rel > tol:
        raise AssertionError(f"{label}: card logits disagree with the CPU")
    return cpu


def falling(label, losses, first_steps=1):
    """Finite losses whose last three steps' mean is under the first
    steps'. Returns (first, last)."""
    losses = np.asarray(losses, np.float64).reshape(-1)
    first = float(losses[:first_steps].mean())
    last = float(losses[-3:].mean())
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    return first, last


def vit_gradients_vs_cpu(dev, card):
    """A ``VIT_GRAD_LAYERS``-layer ViT-S/16 training-mode gradient on the
    card, float32 and bf16, against the CPU float32 path on the same
    weights and batch: each leaf within its tolerance of that leaf's
    largest CPU value."""
    loss_fn = get_loss(TRAIN_LOSS)
    X, y = vision_data(n=VIT_GRAD_BATCH).arrays()
    cpu = Model.build(zoo.vit(num_layers=VIT_GRAD_LAYERS), RESNET_SHAPE,
                      seed=SEED, device=dev).to("cpu")
    _, ref, _ = value_and_grad(cpu.module, loss_fn, cpu.params,
                               torch.from_numpy(X), torch.from_numpy(y))
    ref = [g.float() for g in tree_leaves(ref)]
    xb, yb = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    for dtype, tol in (("float32", VIT_GRAD_F32_TOL),
                       ("bfloat16", VIT_GRAD_BF16_TOL)):
        m = Model.build(zoo.vit(num_layers=VIT_GRAD_LAYERS, dtype=dtype),
                        RESNET_SHAPE, device="meta")
        m.module.to_empty(device=dev)
        m.device = dev
        m.set_weights(cpu.get_weights())
        _, got, _ = value_and_grad(m.module, loss_fn, m.params, xb, yb)
        errs = [float((g.float().cpu() - r).abs().max()
                      / r.abs().max().clamp_min(1e-30))
                for g, r in zip(tree_leaves(got), ref)]
        print(f"ViT-S/16 at {VIT_GRAD_LAYERS} layers, card {dtype} "
              f"gradients vs the CPU float32 path on {card}: worst leaf "
              f"rel err {max(errs):.3e} over {len(errs)} leaves (tol {tol})",
              flush=True)
        if max(errs) > tol:
            raise AssertionError(f"ViT {dtype} card gradients disagree "
                                 f"with the CPU: {errs}")
        del m
    del cpu
    gc.collect()


def vit_files_phase(model, x8, dev, card):
    """The trained ViT saved and loaded back on the card (eval logits
    bitwise), saved with ``quantize=True`` and loaded as a
    ``QuantizedModel`` (logits against the CPU float32 path over the same
    dequantized weights, at the quantized path's bf16 limit)."""
    import tempfile
    from distkeras_tpu_torch.models import load_model
    ref = model.predict(x8)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/vit"
        t0 = time.perf_counter()
        model.save(path)
        loaded = Model.load(path, device=dev)
        secs = time.perf_counter() - t0
        same = np.array_equal(loaded.predict(x8), ref)
        print(f"ViT-S/16 saved and loaded on {card} in {secs:.2f} s: eval "
              f"logits bitwise equal {same}", flush=True)
        if not same:
            raise AssertionError("the reloaded ViT's logits differ")
        del loaded
        model.save(path + "_q", quantize=True)
        q = Model.load(path + "_q", keep_quantized=True, device=dev)
        got = q.predict(x8)
        cpu = cpu_float32_copy(load_model(path + "_q", device="cpu"),
                               zoo.vit())
        want = cpu.predict(x8)
        scale = float(np.abs(want).max())
        rel = float(np.abs(got - want).max()) / scale
        drift = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
        print(f"ViT-S/16 int8 file (keep_quantized) on {card}: "
              f"{q.num_bytes()} weight bytes; logits vs the CPU float32 "
              f"path over the same dequantized weights rel err {rel:.3e} "
              f"(tol {E2E_BF16_REL_TOL}); vs the float model "
              f"{drift:.3e} (quantization)", flush=True)
        if not np.isfinite(got).all() or rel > E2E_BF16_REL_TOL:
            raise AssertionError("the quantized ViT disagrees with the CPU")
        del q, cpu


def lm_file_phase(dev, card):
    """A ``transformer_lm`` file written on the CPU by the port (built on
    the card, moved to the CPU, saved there), loaded on the card:
    ``generate()`` gives the writer's greedy tokens."""
    import tempfile
    spec = zoo.transformer_lm(LM_CFG["vocab"], d_model=LM_CFG["d_model"],
                              num_heads=LM_CFG["num_heads"],
                              num_layers=ZOO_LM_LAYERS,
                              mlp_ratio=LM_CFG["mlp_ratio"])
    writer = Model.build(spec, (ZOO_LM_PROMPT,), seed=SEED,
                         device=dev).to("cpu")
    prompts = np.random.RandomState(SEED + 29).randint(
        0, LM_CFG["vocab"], (2, ZOO_LM_PROMPT)).astype(np.int32)
    want = writer.generate(prompts, ZOO_LM_NEW)
    with tempfile.TemporaryDirectory() as tmp:
        writer.save(f"{tmp}/lm")
        loaded = Model.load(f"{tmp}/lm", device=dev)
    got = loaded.generate(prompts, ZOO_LM_NEW)
    print(f"transformer_lm ({ZOO_LM_LAYERS} layers, float32) written on "
          f"the CPU, loaded on {card}: greedy tokens equal the writer's "
          f"{np.array_equal(got, want)} ({ZOO_LM_NEW} tokens x 2 rows)",
          flush=True)
    if not np.array_equal(got, want):
        raise AssertionError("the loaded LM's greedy tokens differ")
    del writer, loaded
    gc.collect()


def bilstm_phase(dev, card):
    """BASELINE config 5 on the card: the BiLSTM built from the seed,
    ``ModelPredictor`` over ``BILSTM_ROWS`` seeded rows equal to
    ``Model.predict`` bitwise and within ``BILSTM_TOL`` of the CPU path;
    rows/s, the CUDA kernels of one batch, and cuDNN's ``nn.LSTM`` over
    the same batch as yardstick. Returns the build's launch counts."""
    from torch.profiler import ProfilerActivity, profile
    shape = (BILSTM_SEQ, BILSTM_FEATURES)
    model, c = counted_build(zoo.bilstm_classifier(BILSTM_UNITS, 2), shape,
                             dev, "BiLSTM (config 5)", card)
    X = np.random.RandomState(SEED + 5).randn(
        BILSTM_ROWS, *shape).astype(np.float32)
    ds = Dataset({"features": X})
    pred = ModelPredictor(model, batch_size_per_device=BILSTM_BATCH)
    pred.predict(Dataset({"features": X[:BILSTM_BATCH]}))   # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pred.predict(ds)["prediction"]
    secs = time.perf_counter() - t0
    if sum(kernels.launch_counts().values()):
        raise AssertionError("the BiLSTM launched a hand-written kernel")
    same = np.array_equal(out, model.predict(X, batch_size=BILSTM_BATCH))
    cpu = cpu_float32_copy(model, zoo.bilstm_classifier(BILSTM_UNITS, 2))
    ref = cpu.predict(X, batch_size=BILSTM_BATCH)
    rel = float(np.abs(out - ref).max()) / float(np.abs(ref).max())
    print(f"BiLSTM ModelPredictor on {card}: {BILSTM_ROWS} rows of "
          f"{BILSTM_SEQ}x{BILSTM_FEATURES} float32 in {secs:.2f} s "
          f"({BILSTM_ROWS / secs:.1f} rows/s, B{BILSTM_BATCH}); bitwise "
          f"Model.predict {same}; vs the CPU float32 path rel err "
          f"{rel:.3e} (tol {BILSTM_TOL})", flush=True)
    if out.shape != (BILSTM_ROWS, 2) or not same or rel > BILSTM_TOL:
        raise AssertionError("config 5 predictions disagree")
    xb = torch.from_numpy(X[:BILSTM_BATCH]).to(dev)
    params = model.params
    with torch.no_grad():
        port_ms = time_ms(lambda: model.module.apply(params, xb), iters=3,
                          warmup=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.module.apply(params, xb)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.self_device_time_total > 0)
        lstm = torch.nn.LSTM(BILSTM_FEATURES, BILSTM_UNITS, num_layers=2,
                             bidirectional=True, batch_first=True).to(dev)
        lib_ms = time_ms(lambda: lstm(xb), iters=10)
    print(f"BiLSTM batch of {BILSTM_BATCH} on {card}: the port's forward "
          f"{port_ms:.2f} ms ({launches} CUDA kernel launches); "
          f"yardstick cuDNN nn.LSTM (2 layers, bidirectional, the same "
          f"shape, never called by the port) {lib_ms:.3f} ms", flush=True)
    del model, cpu, lstm
    gc.collect()
    return c


def zoo_phase(dev, card):
    """Phase 29: ViT-S/16 trained on the flash kernels without the causal
    mask, MobileNet-v1, BASELINE config 5 (the BiLSTM through
    ``ModelPredictor``) and model files on the card. Returns the launch
    counts of its runs by path."""
    by_path = {}
    data = vision_data()
    X, y = data.arrays()
    x8 = X[:8]

    model, by_path["zoo_vit_build"] = counted_build(
        zoo.vit(dtype="bfloat16"), RESNET_SHAPE, dev, "ViT-S/16", card)
    cpu = logits_vs_cpu32(model, zoo.vit(), x8, "ViT-S/16", card)
    del cpu
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    model.predict(x8)
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    by_path["zoo_vit_eval"] = c
    if c["flash_fwd"] != VIT_LAYERS or c["flash_bwd_dq"] or \
            c["flash_bwd_dkv"]:
        raise AssertionError(f"ViT eval forward launched {c}: expected "
                             f"{VIT_LAYERS} flash_fwd and no backward")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = SingleTrainer(model, worker_optimizer="adam",
                       learning_rate=VISION_LR, loss=TRAIN_LOSS,
                       batch_size=VIT_BATCH, num_epoch=1)
    c = counted_train(tr, data)
    peak = torch.cuda.max_memory_allocated()
    by_path["zoo_vit_training"] = c
    steps = VISION_IMAGES // VIT_BATCH
    losses = tr.get_history().losses()
    expect = {name: VIT_LAYERS * steps for name in TRAINING_KERNELS}
    expect["prng"] = steps
    if len(losses) != steps or any(c[k] != n for k, n in expect.items()):
        raise AssertionError(f"ViT SingleTrainer: {len(losses)} steps, "
                             f"launches {c}; expected {expect}")
    first, last = falling("ViT-S/16 SingleTrainer", losses)
    secs = tr.get_training_time()
    print(f"ViT-S/16 SingleTrainer on {card}: {steps} steps of B"
          f"{VIT_BATCH} in {secs:.2f} s ({VISION_IMAGES / secs:.1f} "
          f"images/s, the first step included); loss {first:.4f} -> "
          f"{last:.4f} (per step {np.array2string(losses, precision=3)}); "
          f"launches a step: K1f {c['flash_fwd'] // steps}, K1dq "
          f"{c['flash_bwd_dq'] // steps}, K1dkv {c['flash_bwd_dkv'] // steps}"
          f", K7 {c['prng'] // steps} (exact); peak device memory "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB allocated before "
          f"the run)", flush=True)
    xb, yb = (torch.from_numpy(a[:VIT_BATCH]).to(dev) for a in (X, y))
    profile_vision_step(model, card, xb, yb, label="ViT-S/16",
                        groups=VIT_OP_GROUPS,
                        kernel_groups=VIT_KERNEL_GROUPS)
    del tr, xb, yb
    gc.collect()
    vit_files_phase(model, x8, dev, card)
    del model
    gc.collect()
    vit_gradients_vs_cpu(dev, card)

    model, by_path["zoo_mobilenet_build"] = counted_build(
        zoo.mobilenet(dtype="bfloat16"), RESNET_SHAPE, dev,
        "MobileNet-v1 1.0", card)
    cpu = logits_vs_cpu32(model, zoo.mobilenet(), x8, "MobileNet-v1 1.0",
                          card)
    del cpu
    gc.collect()
    before = _state_leaves(model)
    n = MOBILENET_STEPS * VISION_BATCH
    tr = SingleTrainer(model, worker_optimizer="adam",
                       learning_rate=VISION_LR, loss=TRAIN_LOSS,
                       batch_size=VISION_BATCH, num_epoch=1)
    c = counted_train(tr, Dataset.from_arrays(X[:n], y[:n]))
    by_path["zoo_mobilenet_training"] = c
    losses = tr.get_history().losses()
    if len(losses) != MOBILENET_STEPS or c["prng"] != MOBILENET_STEPS:
        raise AssertionError(f"MobileNet SingleTrainer: {len(losses)} "
                             f"steps, launches {c}")
    first, last = check_vision_training("MobileNet SingleTrainer", losses,
                                        before, model)
    secs = tr.get_training_time()
    print(f"MobileNet-v1 1.0 SingleTrainer on {card}: {MOBILENET_STEPS} "
          f"steps of B{VISION_BATCH} in {secs:.2f} s ({n / secs:.1f} "
          f"images/s, the first step's cuDNN set-up included); loss "
          f"{first:.4f} -> {last:.4f} (per step "
          f"{np.array2string(losses, precision=3)}); BN statistics moved",
          flush=True)
    xb, yb = (torch.from_numpy(a[:VISION_BATCH]).to(dev) for a in (X, y))
    profile_vision_step(model, card, xb, yb, label="MobileNet-v1")
    del tr, xb, yb, model
    gc.collect()

    by_path["zoo_bilstm_build"] = bilstm_phase(dev, card)
    lm_file_phase(dev, card)
    return by_path


# --- phase 30: the engine's other layouts: the slab pool, host KV offload,
# --- MoE under int8/int4 weights ------------------------------------------

#: host pages of phase 30's offload run: the 160-page pool's swap-outs
#: and the prefix cache's spills fit with room
OFFLOAD_HOST_PAGES = 256
#: phase 30's unpressured pool: every stream's pages at once
UNPRESSURED_PAGES = 4 * 2048 // 16
#: phase 30's quantized MoE requests: B4 prompts of this many tokens
MOE_WQ_PROMPT = 128
#: the depth of phase 30's quantized MoE LM (``LM_CFG`` widths, 8
#: experts): 3 of the 12 layers, so the whole script stays well inside
#: its time limit (six engines quantize the tree and measure its error
#: on the host)
MOE_WQ_LAYERS = 3
#: the kernels a slab engine's decode never launches (its readout is
#: plain PyTorch, as JAX's slab engine keeps its einsum path)
ATTN_DECODE_KERNELS = ("decode_attention", "decode_attention_q8",
                       "paged_decode", "paged_decode_q8", "paged_decode_q4",
                       "paged_decode_anc", "paged_decode_q8_anc",
                       "paged_decode_q4_anc")


def _strict_watch(eng):
    """``_LaunchWatch(strict=True)`` on an engine built by ``serve``,
    whose ``on_logits`` hook (the script's own finiteness check, not the
    engine's) indexes the live rows and so runs with sync checks off."""
    watch = _LaunchWatch(eng, strict=True)
    hook = eng.on_logits

    def relaxed(kind, logits, slots):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            hook(kind, logits, slots)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    eng.on_logits = relaxed
    return watch


def slab_flash_launches(prompts, num_layers, chunk=256) -> int:
    """K1f launches of a slab engine's prefills: per layer, one causal
    pass a chunk and one prefix pass a chunk past the first."""
    return num_layers * sum(2 * -(-len(p) // chunk) - 1 for p in prompts)


def _parted(model, ref, run, requests, label, tie_rel):
    """``check_identity`` of ``run`` against ``ref``, building its float32
    CPU copy of ``model`` only when a stream parts."""
    if all(np.array_equal(ref[1][a], run[1][b])
           for (a, _), (b, _) in zip(ref[0], run[0])):
        return 0
    f32 = build_lm("cpu", dtype="float32")
    f32.module.load_state_dict(model.module.state_dict())
    return check_identity(f32, ref, run, requests, label, tie_rel)


def slab_phase(model, card, tie_rel, paged_run):
    """(a) The slab engine (``kv_layout="slab"``) on phase 5's workload:
    every stream finishes, no preemption and no pages; K1f launches
    exactly as the prefill chunks ask, no K2/K3 variant at all (the
    rows are read by plain PyTorch), K7 for the sampled request; every
    decode launch runs under ``set_sync_debug_mode("error")``; the
    streams equal phase 5's paged run (same weights) or part at a
    near-tie. Then int8 weights on the slab: K5 exactly 73 a decode step
    launched plus one head a prefill. Last, the slab engine's steady
    decode profiled. Returns ``{path: launches}``."""
    vocab = model.module.layers[0].vocab_size
    layers = LM_CFG["num_layers"]
    requests = workload(vocab)
    rs = np.random.RandomState(SEED + 30)
    for kw in ({}, dict(weight_quant="int8")):   # the slab shapes' first calls
        eng = ServingEngine(model, num_slots=2, max_len=2048,
                            prefill_chunk=256, kv_layout="slab",
                            device=model.device, **kw)
        eng.submit(rs.randint(0, vocab, 40), 6)
        eng.submit(rs.randint(0, vocab, 30), 6, temperature=0.8, top_k=40)
        eng.run(max_steps=100)
        del eng
    launches = {}
    for label, path, kw in (("bf16", "serving_slab", {}),
                            ("int8 weights", "serving_slab_wq_int8",
                             dict(weight_quant="int8"))):
        watches = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng, reqs, out, bad, iters = serve(
            model, model.device, kv_layout="slab",
            setup=lambda e: watches.append(_strict_watch(e)), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        w = watches[0]
        check_finished(reqs, out, bad)
        s = eng.metrics.summary()
        cache_bytes = sum(x.numel() * x.element_size()
                          for kv in eng.pool.cache if kv is not None
                          for x in kv["sink"].values())
        want_flash = slab_flash_launches([p for p, _ in requests], layers)
        wrong = {k: c[k] for k in ATTN_DECODE_KERNELS if c[k]}
        if c["flash_fwd"] != want_flash or wrong or c["prng"] < 1 \
                or s["pages"] is not None or s["requests_preempted"] \
                or "pages" in eng.health():
            raise AssertionError(
                f"slab {label}: flash_fwd {c['flash_fwd']} (expected "
                f"{want_flash}), decode attention kernels {wrong}, prng "
                f"{c['prng']}, pages {s['pages']}, preemptions "
                f"{s['requests_preempted']}")
        k5 = ""
        if kw:
            want_k5 = (6 * layers + 1) * w.steps + len(reqs)
            if c["quant_matmul_q8"] != want_k5:
                raise AssertionError(
                    f"slab {label}: {c['quant_matmul_q8']} K5 launches for "
                    f"{w.steps} decode steps and {len(reqs)} prefill heads, "
                    f"expected {want_k5}")
            k5 = f", quant_matmul_q8 {c['quant_matmul_q8']} (exact)"
        print(f"slab engine {label} on {card}: {len(reqs)} requests in "
              f"{wall:.2f} s, {iters} iterations, {w.units} decode launches "
              f"under set_sync_debug_mode('error') (no host sync); launches "
              f"flash_fwd {c['flash_fwd']} (exact), K2/K3 variants 0, prng "
              f"{c['prng']}{k5}; rows {cache_bytes / 2**30:.3f} GiB (with the "
              f"sink row); peak allocated during the run {peak / 2**30:.3f} "
              f"GiB above what was allocated before it; TTFT p50 "
              f"{s['ttft_s']['p50'] * 1e3:.1f} ms p99 "
              f"{s['ttft_s']['p99'] * 1e3:.1f} ms; decode "
              f"{s['decode_tokens_per_sec']:.1f} tok/s", flush=True)
        if not kw:
            parted = _parted(model, paged_run, (reqs, out), requests,
                             "slab engine", tie_rel)
            print(f"slab engine: streams parted from phase 5's paged run "
                  f"{parted}/{len(reqs)} (at near-ties only)", flush=True)
        launches[path] = c
        del eng
    # the paged engine's profile at the same settings is phase 5's
    profile_serving(model, model.device, "slab bf16", kv_layout="slab")
    return launches


def offload_phase(model, card, tie_rel, reprefill_summary):
    """(b) Host KV offload on phase 5's workload and pool with
    ``host_kv_pages``: at least two preemptions swap out, each swap-out
    (``ServingEngine._swap_out``) runs under
    ``set_sync_debug_mode("error")``, every restored page equals the
    device copy taken at its swap-out byte for byte, ``offload_bytes`` is
    pages x ``page_bytes``, and the streams equal an unpressured run's
    or part at a near-tie. Prints the swap-in resume p50 beside phase 5's
    re-prefill resume p50 (the same pool, ``host_kv_pages=0``)."""
    vocab = model.module.layers[0].vocab_size
    requests = workload(vocab)
    eng, reqs, out, bad, _ = serve(model, model.device,
                                   num_pages=UNPRESSURED_PAGES)
    check_finished(reqs, out, bad)
    if eng.metrics.requests_preempted:
        raise AssertionError("offload: the unpressured run preempted")
    unpressured = (reqs, out)
    del eng
    snaps, box = {}, {"swaps": 0, "checked": 0, "differ": 0}

    def setup(e):
        pool = e.pool
        off, rest, swap = pool.offload_pages, pool.restore_pages, e._swap_out

        def offload(page_ids):
            hids = off(page_ids)
            for h, pid in zip(hids or (), page_ids):
                snaps[h] = [None if kv is None else
                            {k: kv[k][int(pid)].clone() for k in CACHE_PLANES
                             if k in kv} for kv in pool.cache]
            return hids

        def restore(host_ids, dev_ids):
            rest(host_ids, dev_ids)
            for h, d in zip(host_ids, dev_ids):
                for kv, want in zip(pool.cache, snaps.pop(int(h))):
                    if kv is not None:
                        for k, x in want.items():
                            box["differ"] += not torch.equal(kv[k][int(d)],
                                                             x)
                box["checked"] += 1

        def swap_out(victim):
            with _SyncErrors():
                swap(victim)
            box["swaps"] += victim.swap is not None

        pool.offload_pages, pool.restore_pages = offload, restore
        e._swap_out = swap_out

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng, reqs, out, bad, iters = serve(model, model.device,
                                       host_kv_pages=OFFLOAD_HOST_PAGES,
                                       setup=setup)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_finished(reqs, out, bad)
    pool, s = eng.pool, eng.metrics.summary()
    off = s["offload"]
    if box["swaps"] < 2 or not box["checked"] or box["differ"] \
            or box["checked"] != pool.pages_restored \
            or pool.offload_bytes != pool.pages_offloaded * pool.page_bytes:
        raise AssertionError(
            f"offload: {box['swaps']} swap-outs, {box['checked']} restored "
            f"pages checked ({pool.pages_restored} restored), "
            f"{box['differ']} planes differ, offload_bytes "
            f"{pool.offload_bytes} for {pool.pages_offloaded} pages of "
            f"{pool.page_bytes}")
    swap_p50 = off["resume_swap_s"]["p50"] * 1e3
    re_p50 = reprefill_summary["offload"]["resume_reprefill_s"]
    re_p50 = "none" if re_p50 is None else f"{re_p50['p50'] * 1e3:.3f} ms"
    print(f"host offload on {card}: {len(reqs)} requests in {wall:.2f} s, "
          f"{iters} iterations; preemptions {s['requests_preempted']}, "
          f"{box['swaps']} swapped out (each swap-out under "
          f"set_sync_debug_mode('error'): no host sync); pages offloaded "
          f"{pool.pages_offloaded} (prefix spills included), restored "
          f"{pool.pages_restored}, each byte-identical to its swap-out; "
          f"offload_bytes {pool.offload_bytes} = pages x {pool.page_bytes};"
          f" fences {pool.host_fences}; reprefill tokens avoided "
          f"{off['reprefill_tokens_avoided']}; resume p50: swap-in "
          f"{swap_p50:.3f} ms (host clock: the copy is queued, not waited "
          f"for), re-prefill {re_p50} (phase 5, host_kv_pages=0); TTFT p50 "
          f"{s['ttft_s']['p50'] * 1e3:.1f} ms; decode "
          f"{s['decode_tokens_per_sec']:.1f} tok/s", flush=True)
    parted = _parted(model, unpressured, (reqs, out), requests,
                     "host offload", tie_rel)
    print(f"host offload: streams parted from the unpressured run "
          f"{parted}/{len(reqs)} (at near-ties only)", flush=True)
    return kernels.launch_counts()


def moe_wq_phase(dev, card):
    """(c) The all-MoE LM at ``MOE_WQ_LAYERS`` layers under int8 and int4
    weights: each
    ``generate(weights_dtype=)`` on B4 prompts (K5 exactly 4 x layers + 1
    a decode step, q/k/v/o and the head, plus one prefill head; no K6a:
    the experts are dequantized for the layer's own dense dispatch), then
    the dispatched engine (``weight_quant``, K6a) teacher-forced along
    those streams against a dense engine's forced run of the same
    streams (``forced_compare``, phase 20's rule); K5 and K6a exact per
    step. Prints the expert dequantization's transient bytes and device
    ms a step against its bound, steady decode profiled with int8 and
    int4 weights, and each forced dispatched run's peak memory against
    the bf16 engine's on the same streams."""
    layers = MOE_WQ_LAYERS
    model = build_moe_lm(dev, num_layers=layers)
    vocab = model.module.layers[0].vocab_size
    eng_mod = sys.modules["distkeras_tpu_torch.serving.engine"]
    rs = np.random.RandomState(SEED + 31)
    prompts = rs.randint(0, vocab, (4, MOE_WQ_PROMPT))
    requests = [(p, {}) for p in prompts]
    per_step = 4 * layers + 1                    # q, k, v, o a layer; head

    def peaked(run):
        """``run()``'s peak allocation above what was allocated before."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = run()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    float_bytes = ServingEngine(model, num_slots=1, max_len=64,
                                device=dev).param_bytes()
    launches, peaks = {}, {}
    for wq in ("int8", "int4"):
        # generate()'s tree holds a byte an entry at int4 too: K5-q8
        gname, kname = WQ_KERNEL["int8"], WQ_KERNEL[wq]
        model.generate(prompts[:, :32], 2, weights_dtype=wq)    # warm
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        gen = model.generate(prompts, NEW_TOKENS, weights_dtype=wq)
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        want = per_step * (NEW_TOKENS - 1) + 1
        if c[gname] != want or c["moe_gather_gemm1"]:
            raise AssertionError(f"MoE generate {wq}: {c[gname]} {gname} "
                                 f"(expected {want}), K6a "
                                 f"{c['moe_gather_gemm1']}")
        print(f"MoE generate(weights_dtype={wq!r}) on {card}: B4 x "
              f"{MOE_WQ_PROMPT} + {NEW_TOKENS}; launches {gname} "
              f"{c[gname]} (exact), moe_gather_gemm1 0", flush=True)
        launches[f"generate_moe_wq_{wq}"] = c
        streams = [g[MOE_WQ_PROMPT:] for g in gen]
        recs = {}
        for decode in ("dense", "dispatched"):
            kernels.reset_launch_counts()
            with _Calls(eng_mod, *_Forced.STEPS) as steps:
                recs[decode], peaks[wq, decode] = peaked(
                    lambda: forced_run(
                        model, requests, streams,
                        layer_check=decode == "dispatched",
                        weight_quant=wq, moe_decode=decode))
            c = kernels.launch_counts()
            want_k5 = per_step * steps.n + len(requests)
            want_k6a = layers * steps.n if decode == "dispatched" else 0
            if c[kname] != want_k5 or c["moe_gather_gemm1"] != want_k6a:
                raise AssertionError(
                    f"MoE {decode} engine {wq}: {c[kname]} {kname} "
                    f"(expected {want_k5}), K6a {c['moe_gather_gemm1']} "
                    f"(expected {want_k6a}) for {steps.n} decode steps")
            if decode == "dispatched":
                launches[f"serving_moe_wq_{wq}"] = c
            print(f"MoE {decode} engine weight_quant {wq} on {card}, "
                  f"teacher-forced along generate()'s streams: {steps.n} "
                  f"decode steps; launches {kname} {c[kname]} (exact), "
                  f"moe_gather_gemm1 {c['moe_gather_gemm1']} (exact)",
                  flush=True)
        forced_compare(f"weight_quant {wq}", recs["dense"],
                       recs["dispatched"], set(range(len(requests))))
        qtree = quantize_params_tree(model.params,
                                     bits=4 if wq == "int4" else 8)
        qbytes = sum(x.numel() * x.element_size()
                     for x in tree_leaves(qtree))
        moe = [(blk.mlp, p["mlp"]) for blk, p in zip(
            map(_decode_block_of, model.module.layers), qtree)
            if blk is not None]
        q_bytes = sum(x.numel() * x.element_size() for _, p in moe
                      for k in ("w1", "w2") for x in p[k].values())
        out_bytes = sum(2 * _expert_elements(p[k]) for _, p in moe
                        for k in ("w1", "w2"))
        ms = time_ms(lambda: [_moe_params(m, p) for m, p in moe], iters=10)
        bound = (q_bytes + out_bytes) / PEAK_BYTES * 1e3
        print(f"MoE weight_quant {wq}: the experts' dequantization a decode "
              f"step ({layers} layers, w1 + w2 to bf16, a transient of "
              f"{out_bytes / layers / 1e6:.1f} MB a layer): {ms:.3f} ms "
              f"device time, reading {q_bytes / 1e9:.3f} GB of {wq} and "
              f"scales and writing {out_bytes / 1e9:.3f} GB, bound "
              f"{bound:.3f} ms (bytes at 3.35 TB/s): {100 * bound / ms:.0f}% "
              f"of it; resident weights {qbytes} bytes against the float "
              f"engine's {float_bytes}", flush=True)
        profile_serving(model, dev, f"MoE {wq} weights", weight_quant=wq)
    _, float_peak = peaked(lambda: forced_run(model, requests, streams))
    print(f"MoE peak allocated during a forced 4-request dispatched run, "
          f"above what was allocated before it: int8 weights "
          f"{peaks['int8', 'dispatched'] / 2**30:.3f} GiB, int4 "
          f"{peaks['int4', 'dispatched'] / 2**30:.3f} GiB, bf16 weights "
          f"{float_peak / 2**30:.3f} GiB", flush=True)
    del model
    gc.collect()
    return launches


# --- phase 31: the rest of the Trainer surface --------------------------------

#: the fused head's per-step losses and head gradient against the unfused
#: ones: bf16 logits and log-softmax against float32-accumulated chunks
FUSED_HEAD_TOL = 5e-2
#: the free disk phase 31's checkpoints need: a 218M carry (float32
#: weights and two adam moments, ~2.6 GB) kept for the comparison while
#: another directory writes its step beside the one it replaces
CKPT_FREE_BYTES = 12 * 2 ** 30
#: the card against the CPU on the same LeNet-5 logits and weights: class
#: weights, label smoothing, the macro metrics and auc, a class-weighted
#: training run (float32 both sides, cuDNN's order of sums)
SURFACE_TOL = 1e-3
#: the columns the (auto) telemetry tape adds to every epoch's logs
TAPE_LOG_KEYS = ("checkpoint_s", "data_wait_s", "device_s",
                 "examples_per_sec", "goodput", "host_s", "validation_s")
#: the kernels a 218M training step launches: 12 of each flash kernel
#: and one key split (K7)
TRAINER_KERNELS = TRAINING_KERNELS + ("prng",)


class _TimedManager(CheckpointManager):
    """The trainers' manager with ``max_to_keep=1``, timing what
    ``save()`` holds the loop (the fenced snapshot, and the write unless
    it is queued) and what each disk write takes."""

    def __init__(self, directory, async_writes=False):
        super().__init__(directory, max_to_keep=1, async_writes=async_writes)
        self.save_s, self.write_s, self.nbytes = [], [], 0

    def save(self, step, tree, metadata=None):
        t0 = time.perf_counter()
        out = super().save(step, tree, metadata)
        self.save_s.append(time.perf_counter() - t0)
        return out

    def _write(self, step, flat, metadata, final):
        t0 = time.perf_counter()
        super()._write(step, flat, metadata, final)
        self.write_s.append(time.perf_counter() - t0)
        self.nbytes = sum(a.nbytes for a in flat.values())


class _TimedTrainer(SingleTrainer):
    """``SingleTrainer`` over a ``_TimedManager`` (kept on ``manager``)."""

    def _checkpoint_manager(self):
        self.manager = _TimedManager(self.checkpoint_dir,
                                     self.checkpoint_async)
        return self.manager


def lm_trainer(model, cls=SingleTrainer, epochs=1, **kw):
    """Phase 7's trainer (adam, B4, the plain cross-entropy) over
    ``epochs`` epochs, with ``kw``'s options."""
    return cls(model, worker_optimizer="adam", learning_rate=TRAIN_LR,
               loss=TRAIN_LOSS, batch_size=TRAIN_BATCH, num_epoch=epochs,
               **kw)


def check_trainer_launches(label, launches, steps,
                           num_layers=LM_CFG["num_layers"]):
    """Exactly 12 launches of each flash kernel and one K7 a step."""
    want = {name: num_layers * steps for name in TRAINING_KERNELS}
    want["prng"] = steps
    got = {name: launches[name] for name in TRAINER_KERNELS}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return got


def _within(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)))


def head_gradients(model, xb, yb):
    """The head kernel's gradient on ``(xb, yb)`` through the plain head
    (bf16 logits, then the cross-entropy) and through the fused one, on
    the same weights: ``(unfused, fused)`` as float32."""
    loss_fn = sparse_categorical_crossentropy_from_logits
    from distkeras_tpu_torch.parallel.worker import _fused_loss
    fused = _fused_loss(_fused_head_parts(model.module, loss_fn, None), 8)
    out = []
    for objective in (None, fused):
        _, g, _ = value_and_grad(model.module, loss_fn, model.params, xb, yb,
                                 objective=objective)
        out.append(g[-1]["kernel"].float())
        del g
    return out


def fused_loss_ms(model, xb, yb):
    """Device ms of the head's loss, forward and backward, on the
    trunk's real hidden state: fused (8 chunks) and the plain head."""
    loss_fn = sparse_categorical_crossentropy_from_logits
    trunk, _, cdt = _fused_head_parts(model.module, loss_fn, None)
    head = model.module.layers[-1]
    w = model.params[-1]["kernel"]
    with torch.no_grad():
        h = trunk.apply(model.params[:-1], xb)
    h.requires_grad_(True)

    def fused():
        loss = fused_linear_cross_entropy(h, w, yb, compute_dtype=cdt)
        torch.autograd.grad(loss, (h, w))

    def plain():
        loss = loss_fn(yb, head.apply(model.params[-1], h))
        torch.autograd.grad(loss, (h, w))

    return time_ms(fused, iters=5, warmup=2), time_ms(plain, iters=5,
                                                      warmup=2)


def fused_head_phase(dev, card):
    """(a) 8 steps with ``fused_vocab_head=True`` and 8 without, each
    from the seed-0 weights: per-step losses and the head's gradient
    within ``FUSED_HEAD_TOL``, exact launches, then each head's steady
    step (ms, peak memory) and the loss's device ms."""
    data = training_data(LM_CFG["vocab"])
    steps = TRAIN_ROWS // TRAIN_BATCH
    runs = {}
    for fused in (False, True):
        model = build_lm(dev)
        if not fused:
            xb, yb = (torch.from_numpy(a[:TRAIN_BATCH]).to(dev)
                      for a in data.arrays())
            gu, gf = head_gradients(model, xb, yb)
            grad_err = float((gf - gu).abs().max() / gu.abs().max())
            ms = fused_loss_ms(model, xb, yb)
            del gu, gf
        tr = lm_trainer(model, fused_vocab_head=fused)
        launches = check_trainer_launches(
            f"the {'fused' if fused else 'unfused'} head", counted_train(
                tr, data), steps)
        losses = tr.get_history().losses()
        name = "fused" if fused else "plain"
        step_ms, tok_s, peak_gb, _ = profile_training(
            model, card, label=f"phase 31 {name} vocab head",
            prefix=f"profile-{name}-head", fused=fused)
        runs[fused] = (losses, launches, step_ms, peak_gb)
        del tr, model
        gc.collect()
    loss_err = _within(runs[True][0], runs[False][0], FUSED_HEAD_TOL)
    print(f"phase 31 (a) fused vocab head on {card}: per-step losses "
          f"{np.array2string(runs[True][0], precision=4)} against "
          f"{np.array2string(runs[False][0], precision=4)} (max rel "
          f"{loss_err:.3e}); head gradient rel err {grad_err:.3e} (tol "
          f"{FUSED_HEAD_TOL}); peak {runs[True][3]:.2f} GiB fused against "
          f"{runs[False][3]:.2f} GiB plain; warm step {runs[True][2]:.1f} "
          f"ms fused against {runs[False][2]:.1f} ms; the head's loss "
          f"forward+backward {ms[0]:.3f} ms fused (8 chunks) against "
          f"{ms[1]:.3f} ms plain (CUDA events); launches "
          f"{runs[True][1]}", flush=True)
    if not (loss_err <= FUSED_HEAD_TOL and grad_err <= FUSED_HEAD_TOL):
        raise AssertionError("the fused vocab head disagrees with the plain "
                             "head")
    return runs[True][1]


def _final_carry(manager, step):
    return manager._read_verified(os.path.join(manager.directory,
                                               f"step_{step}"))


#: phase 31 (b)'s LM depth (``LM_CFG`` widths): four blocks (checkpoints
#: of ~1.4 GB against 2.62 GB at twelve), which keeps the script inside
#: its time limit on a slow host
RESUME_LAYERS = 4


def resume_phase(dev, card, tmp):
    """(b) 2 epochs uninterrupted with ``checkpoint_dir``; the same run
    stopped after epoch 0 by ``request_preempt()`` and finished by a
    fresh trainer with ``resume=True``; once more with
    ``checkpoint_async=True``: the final carries bitwise equal. The LM
    keeps ``LM_CFG`` widths at ``RESUME_LAYERS`` blocks: the checkpoint
    writes, not the depth, are what this checks."""
    free = shutil.disk_usage(tmp).free
    if free < CKPT_FREE_BYTES:
        raise AssertionError(f"phase 31 needs {CKPT_FREE_BYTES} free bytes "
                             f"under {tmp} for its checkpoints; {free} free")
    data = training_data(LM_CFG["vocab"])
    steps = TRAIN_ROWS // TRAIN_BATCH
    shallow = functools.partial(build_lm, dev, num_layers=RESUME_LAYERS)
    whole = lm_trainer(shallow(), _TimedTrainer, 2,
                       checkpoint_dir=os.path.join(tmp, "whole"))
    check_trainer_launches("the uninterrupted run", counted_train(
        whole, data), 2 * steps, num_layers=RESUME_LAYERS)
    holder = []
    stop = LambdaCallback(on_epoch_end=lambda e, logs: e == 0
                          and holder[0].request_preempt())
    first = lm_trainer(shallow(), _TimedTrainer, 2, callbacks=[stop],
                       checkpoint_dir=os.path.join(tmp, "stopped"))
    holder.append(first)
    counted_train(first, data)
    if not (first.preempted and len(first.get_history().epochs) == 1):
        raise AssertionError("request_preempt() did not stop the run "
                             "after epoch 0")
    del first
    gc.collect()
    resumed = lm_trainer(shallow(), _TimedTrainer, 2, resume=True,
                         checkpoint_dir=os.path.join(tmp, "stopped"))
    launches = check_trainer_launches("the resumed run", counted_train(
        resumed, data), steps, num_layers=RESUME_LAYERS)
    if len(resumed.get_history().epochs) != 1:
        raise AssertionError("the resumed run did not start at epoch 1")
    a, b = _final_carry(whole.manager, 1), _final_carry(resumed.manager, 1)
    parted = [k for k in a if a[k].tobytes() != b[k].tobytes()]
    live = sum(not torch.equal(x, y) for x, y in zip(
        tree_leaves(whole.master_model.params),
        tree_leaves(resumed.master_model.params)))
    del resumed
    gc.collect()
    shutil.rmtree(os.path.join(tmp, "stopped"))
    queued = lm_trainer(shallow(), _TimedTrainer, 2,
                        checkpoint_async=True,
                        checkpoint_dir=os.path.join(tmp, "async"))
    counted_train(queued, data)
    queued_live = sum(not torch.equal(x, y) for x, y in zip(
        tree_leaves(whole.master_model.params),
        tree_leaves(queued.master_model.params)))
    ws, qs = whole.manager, queued.manager
    print(f"phase 31 (b) checkpoint and resume on {card}: a checkpoint "
          f"holds {ws.nbytes} bytes in {len(a)} leaves (params, adam m and "
          f"v, the step, the key); resumed after a preemption at epoch 0: "
          f"{len(a) - len(parted)} of {len(a)} leaves of the final carry "
          f"bitwise the uninterrupted run's, {live} live parameters "
          f"differ; synchronous save() holds the loop "
          f"{np.array2string(np.asarray(ws.save_s) * 1e3, precision=1)} "
          f"ms (writes {np.array2string(np.asarray(ws.write_s), precision=2)}"
          f" s); with checkpoint_async save() holds it "
          f"{np.array2string(np.asarray(qs.save_s) * 1e3, precision=1)} ms "
          f"while the writes take "
          f"{np.array2string(np.asarray(qs.write_s), precision=2)} s; the "
          f"async run's parameters differ in {queued_live} tensors; "
          f"{free / 2 ** 30:.1f} GiB were free", flush=True)
    if parted or live or queued_live:
        raise AssertionError(f"resume is not bitwise: leaves {parted[:5]}, "
                             f"{live} live tensors, async {queued_live}")
    del whole, queued
    gc.collect()
    return launches


def frozen_phase(dev, card):
    """(c) the token embedding and the first block frozen: after 4 steps
    their leaves are bitwise unchanged and every other leaf moved."""
    model = build_lm(dev)
    for layer in model.module.layers[:2]:
        layer.trainable = False
    frozen = [t.detach().clone() for t in tree_leaves(model.params[:2])]
    rest = [t.detach().clone() for t in tree_leaves(model.params[2:])]
    steps = 4
    tr = lm_trainer(model)
    launches = check_trainer_launches("the frozen run", counted_train(
        tr, training_data(LM_CFG["vocab"], rows=steps * TRAIN_BATCH)),
        steps)
    kept = sum(torch.equal(a, b) for a, b in
               zip(frozen, tree_leaves(model.params[:2])))
    moved = sum(not torch.equal(a, b) for a, b in
                zip(rest, tree_leaves(model.params[2:])))
    print(f"phase 31 (c) frozen layers on {card}: embedding and block 0 "
          f"frozen, {steps} steps: {kept} of {len(frozen)} frozen leaves "
          f"bitwise unchanged, {moved} of {len(rest)} others moved; "
          f"launches {launches}", flush=True)
    if kept != len(frozen) or moved != len(rest):
        raise AssertionError("frozen layers moved, or trained ones did not")
    del tr, model
    gc.collect()
    return launches


def sharded_phase(dev, card, tmp):
    """(d) phase 7's 32 rows as 4 npz shards: an unshuffled sharded epoch
    (the Prefetcher, pinned staging) gives the in-memory run's losses
    bitwise."""
    data = training_data(LM_CFG["vocab"])
    sds = ShardedDataset.write(data, os.path.join(tmp, "shards"), 4)
    runs = []
    for source in (data, sds):
        tr = lm_trainer(build_lm(dev), shuffle_each_epoch=False)
        launches = check_trainer_launches("the sharded run", counted_train(
            tr, source), TRAIN_ROWS // TRAIN_BATCH)
        runs.append((tr.get_history().losses(), tr.loader.wait_s))
        del tr
        gc.collect()
    print(f"phase 31 (d) ShardedDataset on {card}: 4 npz shards, one "
          f"unshuffled epoch: losses bitwise the in-memory run's: "
          f"{np.array_equal(runs[0][0], runs[1][0])}; the loop waited "
          f"{runs[1][1] * 1e3:.1f} ms for shards ({runs[0][1] * 1e3:.1f} ms "
          f"for the in-memory epoch); launches {launches}", flush=True)
    if not np.array_equal(runs[0][0], runs[1][0]):
        raise AssertionError("the sharded run's losses differ from the "
                             "in-memory run's")
    return launches


def _card_cpu(label, fn, y, out):
    """``fn`` on the card's tensors against the same on CPU copies."""
    card = float(fn(y, out))
    cpu = float(fn(y.cpu(), out.cpu()))
    err = abs(card - cpu) / max(abs(cpu), 1.0)
    if not err <= SURFACE_TOL:
        raise AssertionError(f"{label}: card {card} against CPU {cpu}")
    return f"{label} {card:.5f} ({err:.1e})"


def lenet_surface_phase(dev, card, tmp):
    """(e) on phase 28's LeNet-5 and 256 images: early stopping with the
    best weights restored, model files, the CSV log, NaN termination and
    a profile in one run; the weight average; class weights, label
    smoothing and the macro metrics, card against CPU; a class-weighted
    run on the card against the CPU's; ``StreamingPredictor`` against
    ``ModelPredictor``."""
    spec = functools.partial(zoo.lenet5, VISION_LABELS)
    data = vision_data(shape=LENET_SHAPE)
    X, y = data.arrays()
    kw = dict(batch_size=VISION_BATCH, worker_optimizer="adam",
              learning_rate=VISION_LR, loss=TRAIN_LOSS)
    es = EarlyStopping(monitor="loss", min_delta=1e9, patience=1,
                       restore_best_weights=True)
    best = {}
    grab = LambdaCallback(on_epoch_end=lambda e, logs: best.setdefault(
        "w", es.trainer.get_weights()))
    log = os.path.join(tmp, "log.csv")
    tr = SingleTrainer(
        Model.build(spec(), LENET_SHAPE, seed=SEED, device=dev),
        num_epoch=10, metrics=["accuracy", "f1"],
        profile_dir=os.path.join(tmp, "prof"),
        callbacks=[es, grab, CSVLogger(log), TerminateOnNaN(),
                   ModelCheckpoint(os.path.join(tmp, "m-{epoch}.dkt"))],
        **kw)
    m = tr.train(data)
    restored = all(np.array_equal(a.detach().cpu().numpy(), b) for a, b in
                   zip(tree_leaves(m.params), tree_leaves(best["w"][0])))
    with open(log) as f:
        rows = f.read().splitlines()
    from distkeras_tpu_torch.models import load_model
    back = load_model(os.path.join(tmp, "m-0.dkt"), device=dev)
    file_err = float(np.max(np.abs(back.predict(X[:64]) - m.predict(X[:64]))))
    traces = os.listdir(os.path.join(tmp, "prof"))
    if not (len(tr.get_history().epochs) == 2 and restored
            and len(rows) == 3 and rows[0] == ",".join(
                ["epoch"] + sorted(("accuracy", "f1", "loss")
                                   + TAPE_LOG_KEYS))
            and file_err <= 1e-5 and traces):
        raise AssertionError(
            f"LeNet-5 callbacks: {len(tr.get_history().epochs)} epochs, "
            f"best weights restored {restored}, csv {rows}, model file "
            f"err {file_err}, traces {traces}")
    ema = EMAWeights(decay=0.5)
    em = SingleTrainer(Model.build(spec(), LENET_SHAPE, seed=SEED,
                                   device=dev), num_epoch=2,
                       callbacks=[ema], **kw).train(data)
    if not all(np.array_equal(a.detach().cpu().numpy(), b) for a, b in
               zip(tree_leaves(em.params), tree_leaves(ema.ema_weights[0]))):
        raise AssertionError("EMAWeights did not install the average")
    xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    with torch.no_grad(), eval_mode(m.module):
        out = m.module.apply(m.params, xd).float()
    yb = yd % 2
    checks = [
        _card_cpu("class-weighted CE", with_class_weight(
            TRAIN_LOSS, {0: 2.0, 3: 0.5}), yd, out),
        _card_cpu("label-smoothed CE", with_label_smoothing(TRAIN_LOSS, 0.1),
                  yd, out),
        _card_cpu("precision", precision, yd, out),
        _card_cpu("recall", recall, yd, out),
        _card_cpu("f1", f1, yd, out),
        _card_cpu("auc", auc, yb, out[:, :2])]
    cw = dict(kw, class_weight={0: 2.0, 3: 0.5}, num_epoch=1)
    on_card = SingleTrainer(Model.build(spec(), LENET_SHAPE, seed=SEED,
                                        device=dev), **cw)
    on_card.train(data)
    on_cpu = SingleTrainer(Model.build(spec(), LENET_SHAPE, seed=SEED,
                                       device="cpu"), **cw)
    on_cpu.train(data)
    cw_err = _within(on_card.get_history().losses(),
                     on_cpu.get_history().losses(), SURFACE_TOL)
    if not cw_err <= SURFACE_TOL:
        raise AssertionError(f"class-weighted LeNet-5 losses: card against "
                             f"CPU {cw_err}")
    ref = ModelPredictor(m, batch_size_per_device=64).predict(
        data)["prediction"]
    stream = np.concatenate(list(StreamingPredictor(
        m, batch_size=64).predict_stream(
            X[i:i + 50] for i in range(0, len(X), 50))))
    stream_err = float(np.max(np.abs(stream - ref)))
    if stream.shape != ref.shape or stream_err > 1e-5:
        raise AssertionError(f"StreamingPredictor rows differ from "
                             f"ModelPredictor's by {stream_err}")
    print(f"phase 31 (e) LeNet-5 on {card}: EarlyStopping stopped after "
          f"epoch 1 and restored epoch 0's weights bitwise; the CSV log "
          f"{rows[0]!r} + 2 rows; m-0.dkt loads on the card (max abs "
          f"{file_err:.1e}); a trace in profile_dir ({traces[0]}); "
          f"EMAWeights installed its average; card vs CPU: "
          f"{', '.join(checks)}; class-weighted training losses card vs "
          f"CPU max rel {cw_err:.1e}; StreamingPredictor over batches of 50 "
          f"(padded to 64) = ModelPredictor's {len(ref)} rows (max abs "
          f"{stream_err:.1e})", flush=True)


def trainer_surface_phase(dev, card):
    """Phase 31: the rest of the Trainer surface on the 218M LM at
    ``LM_CFG`` widths (fused head, checkpoint and resume, frozen layers,
    ``ShardedDataset``) and on LeNet-5 (callbacks, class weights, label
    smoothing, metrics, ``profile_dir``, ``StreamingPredictor``). Returns
    each LM path's launch counts."""
    tmp = tempfile.mkdtemp(prefix="dkt-phase31-")
    try:
        lenet_surface_phase(dev, card, tmp)
        return {"trainer_fused_head": fused_head_phase(dev, card),
                "trainer_resume": resume_phase(dev, card, tmp),
                "trainer_frozen": frozen_phase(dev, card),
                "trainer_sharded": sharded_phase(dev, card, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- phase 32: observability and resilience --------------------------------

#: phase 32's serving workload: requests, prompt lengths, new tokens
OBS_REQUESTS, OBS_NEW_TOKENS = 16, 32
#: the SLO objectives the obs-on engine evaluates (generous thresholds:
#: the check is that they are evaluated and reported, not met)
OBS_SLO_S = dict(ttft=5.0, tpot=0.5, availability=0.9)
#: phase 32's training depth: ``LM_CFG`` widths over this many blocks,
#: so the supervised run's checkpoint writes stay short
OBS_TRAIN_LAYERS = 4
#: the engine hooks that run the obs layer's host work; the strict check
#: runs each under ``set_sync_debug_mode("error")``
OBS_HOOKS = ("_launch_step", "_flush_host_window", "_record_iteration",
             "_trace_tick", "_telemetry_summary", "health")


def obs_workload(vocab: int):
    """Sixteen requests of 32 to 256 prompt tokens: the even ones greedy,
    the odd ones sampled with top-k and top-p under their own seeds."""
    rs = np.random.RandomState(SEED + 32)
    reqs = []
    for i in range(OBS_REQUESTS):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_k=40,
                                        top_p=0.9, seed=100 + i)
        reqs.append((rs.randint(0, vocab, int(rs.randint(32, 257))), kw))
    return reqs


def obs_engine_kw(on: bool):
    """The engine's obs options: the SLOs and a time series (the tracer
    and the flight recorder follow ``obs.enabled()``)."""
    if not on:
        return dict(slo=None, timeseries=False)
    return dict(slo=[ttft_p99(OBS_SLO_S["ttft"]), tpot_p99(OBS_SLO_S["tpot"]),
                     availability(OBS_SLO_S["availability"])],
                timeseries=None)


def obs_serve(model, on: bool, requests, setup=None):
    """The workload through the default loop (fused sampling: K4 draws
    the sampled steps) with obs on or off (``obs.disable()`` for the
    run). Returns the engine, the terminal requests by rid in submit
    order, the launch counts, the step count and the run's wall."""
    was = obs.enabled()
    (obs.enable if on else obs.disable)()
    try:
        eng = ServingEngine(model, num_slots=4, max_len=512, page_len=16,
                            prefill_chunk=256, num_pages=256,
                            device=model.device, fused_sampling=True,
                            **obs_engine_kw(on))
        if setup is not None:
            setup(eng)
        rids = [eng.submit(p, OBS_NEW_TOKENS, **kw) for p, kw in requests]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        done, steps = {}, 0
        t0 = time.perf_counter()
        while eng.scheduler.pending:
            for r in eng.step():
                done[r.rid] = r
            steps += 1
            if steps > 5000:
                raise AssertionError("phase 32: the engine did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        (obs.enable if was else obs.disable)()
    return eng, [done[r] for r in rids], launches, steps, wall


_PROM_VALUE = r'"(?:\\.|[^"\\])*"'
_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(?:\{[a-zA-Z_][a-zA-Z0-9_]*=" + _PROM_VALUE
    + r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=" + _PROM_VALUE + r")*\})?"
    r" \S+(?: -?\d+)?$")


def check_prometheus(text: str, label: str) -> int:
    """Every line of a Prometheus exposition is a ``# TYPE`` comment or
    ``name{labels} value [ms]`` with a float value; returns the samples."""
    n = 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            continue
        if not _PROM_LINE.match(line):
            raise AssertionError(f"{label}: unparsable Prometheus line "
                                 f"{line!r}")
        float(line.split()[1])
        n += 1
    return n


def check_obs_engine(eng, done, card):
    """The obs-on engine's records: timelines partition latencies, the
    Chrome trace and Prometheus text parse, ``health()`` reports SLO and
    telemetry; returns ``health()``."""
    sums = eng.tracer.summaries()
    worst = 0.0
    for r in done:
        s = sums[r.rid]
        d = s["durations"]
        parts = d["queued_s"] + d["prefill_s"] + d.get("decode_s", 0.0)
        worst = max(worst, abs(parts - d["total_s"]))
        if s["state"] != r.state.value or s["n_tokens"] != len(r.generated):
            raise AssertionError(f"phase 32: timeline of request {r.rid} "
                                 f"says {s['state']}/{s['n_tokens']}")
    if worst > 1e-9:
        raise AssertionError(f"phase 32: a timeline's phases miss its "
                             f"latency by {worst} s")
    trace = json.loads(json.dumps(eng.tracer.chrome_trace()))
    flows = sum(e["ph"] == "s" for e in trace["traceEvents"])
    if flows != len(done):
        raise AssertionError(f"phase 32: {flows} flows for {len(done)} "
                             "requests in the Chrome trace")
    health = eng.health()
    if health["slo"] is None or set(health["slo"]) != {
            "ttft_p99", "tpot_p99", "availability"}:
        raise AssertionError(f"phase 32: health()['slo'] = {health['slo']}")
    comp = health["telemetry"]["components"].get(eng._component_name)
    if comp is None or set(comp["requests"]) != {r.rid for r in done}:
        raise AssertionError("phase 32: the engine's telemetry component "
                             "lacks its requests")
    n_prom = check_prometheus(
        obs.exporters.prometheus_text(eng.metrics.registry.snapshot()),
        "registry") + check_prometheus(eng.timeseries.prometheus_text(),
                                       "time series")
    ts = eng.timeseries.summary()
    print(f"phase 32 (a) obs records on {card}: {len(sums)} timelines "
          f"(phases partition each latency within {worst:.1e} s), "
          f"{len(trace['traceEvents'])} Chrome-trace events, {n_prom} "
          f"Prometheus samples parsed, {ts['n_samples']} time-series "
          f"scrapes, SLO status "
          + ", ".join(f"{k} good {v['good_fraction']:.3f} burn "
                      f"{v['burn_rate']:.3f}"
                      for k, v in health["slo"].items())
          + f"; health {health['status']}", flush=True)
    return health


class _ObsSyncWatch:
    """Runs each of ``OBS_HOOKS`` on one engine (and its time series' and
    SLO engine's entry points) under ``set_sync_debug_mode("error")``, so
    a host sync inside one raises; counts the calls."""

    def __init__(self, eng):
        self.calls = {}
        targets = [(eng, name) for name in OBS_HOOKS]
        if eng.timeseries is not None:
            targets.append((eng.timeseries, "maybe_sample"))
        if eng.slo is not None:
            targets.append((eng.slo, "evaluate"))
        for obj, name in targets:
            self._wrap(obj, name)

    def _wrap(self, obj, name):
        orig = getattr(obj, name)
        self.calls[name] = 0

        def strict(*args, **kw):
            self.calls[name] += 1
            with _SyncErrors():
                return orig(*args, **kw)

        setattr(obj, name, strict)


#: the obs-on configurations of the strict sync check (phase 32 and the
#: card tests): the tracer and recorder follow obs, plus SLOs and a series
OBS_SYNC_FREE_CASES = (("obs greedy", False), ("obs sampled", True))


def obs_sync_free(model, card):
    """Obs-on engines whose launches and obs hooks run under
    ``set_sync_debug_mode("error")``: a host sync in any raises."""
    for label, sampled in OBS_SYNC_FREE_CASES:
        w = sync_free_run(model, label, obs_engine_kw(True), sampled,
                          obs_hooks=True)
        print(f"phase 32 (a) sync-free {label} on {card}: {w.units} "
              f"launches ({w.windows} fused windows), every launch and obs "
              f"hook ({', '.join(OBS_HOOKS)}, the time series' scrape, the "
              f"SLO evaluation) under set_sync_debug_mode('error'): no "
              f"host sync", flush=True)


def obs_serving_phase(model, card, tmp):
    """(a) and (b): the workload with obs off and on, interleaved; the
    strict sync check; the poisoned prefill. Returns the obs-on run's
    launch counts."""
    requests = obs_workload(model.module.layers[0].vocab_size)
    obs_serve(model, True, requests[:2])           # warm: libraries, caches
    runs = []
    for on in (False, True, True, False):
        gc.collect()
        runs.append((on,) + obs_serve(model, on, requests))
    names = ("flash_fwd", "paged_decode", "sample_epilogue", "prng")
    base = runs[0]
    for on, eng, done, launches, steps, wall in runs[1:]:
        got = {n: launches[n] for n in names}
        want = {n: base[3][n] for n in names}
        if got != want or steps != base[4]:
            raise AssertionError(f"phase 32: obs {'on' if on else 'off'} "
                                 f"launched {got} in {steps} steps; off "
                                 f"{want} in {base[4]}")
        for a, b in zip(done, base[2]):
            if not np.array_equal(a.tokens, b.tokens):
                raise AssertionError(f"phase 32: request {a.rid}'s stream "
                                     f"differs with obs "
                                     f"{'on' if on else 'off'}")
    if any(base[3][n] < 1 for n in names):
        raise AssertionError(f"phase 32: a kernel never launched: "
                             f"{base[3]}")
    on_runs = [r for r in runs if r[0]]
    health = check_obs_engine(on_runs[-1][1], on_runs[-1][2], card)
    for on in (False, True):
        walls = [r[5] / r[4] * 1e3 for r in runs if r[0] == on]
        decode = [r[1].metrics.phase_seconds["decode"] / r[4] * 1e3
                  for r in runs if r[0] == on]
        print(f"phase 32 (a) serving with obs {'on ' if on else 'off'} on "
              f"{card}: {OBS_REQUESTS} requests x {OBS_NEW_TOKENS} tokens "
              f"in {base[4]} steps; wall per step "
              + " / ".join(f"{w:.3f}" for w in walls) + " ms, its decode "
              "phase " + " / ".join(f"{w:.3f}" for w in decode)
              + " ms (runs " + ("2, 3" if on else "1, 4")
              + " of off/on/on/off)", flush=True)
    s = on_runs[-1][1].metrics.summary()
    print(f"phase 32 (a) launches (both): "
          f"{ {n: base[3][n] for n in names} }; greedy and sampled streams "
          f"equal with obs on; TTFT p50 {s['ttft_s']['p50'] * 1e3:.1f} ms "
          f"p99 {s['ttft_s']['p99'] * 1e3:.1f} ms (reservoir of "
          f"{s['requests_finished']} requests); health keys "
          f"{sorted(health)}", flush=True)
    obs_sync_free(model, card)
    # (b) the poisoned prefill
    obs_recorder.reset_recorder()
    rec = obs_recorder.get_recorder()
    rec.dump_dir = os.path.join(tmp, "flight")
    rec.min_auto_interval_s = 0.0
    faults.inject("serving.prefill", nth=3)
    try:
        _, done, _, _, _ = obs_serve(model, True, requests)
    finally:
        faults.reset()
    cancelled = [r for r in done if r.state is RequestState.CANCELLED]
    if len(cancelled) != 1 or not isinstance(cancelled[0].error,
                                             faults.InjectedFault):
        raise AssertionError(f"phase 32 (b): ended "
                             f"{[r.state.value for r in done]}")
    victim = cancelled[0]
    parted = [r.rid for r, ref in zip(done, base[2])
              if r is not victim and not np.array_equal(r.tokens,
                                                        ref.tokens)]
    if parted:
        raise AssertionError(f"phase 32 (b): streams {parted} differ from "
                             "the unfaulted run's")
    if len(rec.dumps) != 1:
        raise AssertionError(f"phase 32 (b): recorder dumps {rec.dumps}")
    header, records = obs_recorder.read_flight_dump(rec.dumps[0])
    kinds = sorted({r["kind"] for r in records})
    print(f"phase 32 (b) poisoned prefill on {card}: request {victim.rid} "
          f"({'sampled' if victim.temperature > 0 else 'greedy'}) ended "
          f"{victim.state.value} with {type(victim.error).__name__}; the "
          f"other {len(done) - 1} streams equal the unfaulted run's; the "
          f"flight dump ({header['reason']}) holds {len(records)} records "
          f"of kinds {kinds}", flush=True)
    obs_recorder.reset_recorder()
    return on_runs[-1][3]


def lm_train_flops(num_layers, seq, d=LM_CFG["d_model"],
                   vocab=LM_CFG["vocab"], mlp=LM_CFG["mlp_ratio"]):
    """Training FLOPs of one ``seq``-token row of the LM: 3x the forward
    (the backward twice it), the forward 2 x tokens x the matrix
    parameters (q/k/v/o ``4 d^2`` and the MLP ``2 mlp d^2`` a block, the
    head ``d V``) plus the causal attention's ``2 S^2 d`` a block (QK^T
    and PV over the lower triangle)."""
    matrix = num_layers * (4 + 2 * mlp) * d * d + d * vocab
    return 3.0 * (2.0 * seq * matrix + num_layers * 2.0 * seq * seq * d)


def obs_training_phase(dev, card, tmp):
    """(c): ``SingleTrainer`` at ``LM_CFG`` widths cut to
    ``OBS_TRAIN_LAYERS`` layers, with ``checkpoint_dir`` and a
    ``TrainingTape``: an unfaulted supervised run, then the same under
    ``train.epoch`` armed nth=2 (after epoch 0's checkpoint): the final
    carries bitwise equal, the restart's cost, the tape's numbers.
    Returns the unfaulted run's launch counts."""
    data = training_data(LM_CFG["vocab"])
    steps = TRAIN_ROWS // TRAIN_BATCH
    fpe = lm_train_flops(OBS_TRAIN_LAYERS, TRAIN_SEQ)
    out = {}
    for label, armed in (("unfaulted", False), ("faulted", True)):
        gc.collect()
        tape = TrainingTape(name=f"phase32_{label}", flops_per_example=fpe)
        tr = lm_trainer(build_lm(dev, num_layers=OBS_TRAIN_LAYERS), epochs=2,
                        checkpoint_dir=os.path.join(tmp, label),
                        telemetry=tape)
        sup = TrainingSupervisor(tr, max_restarts=1, handle_signals=())
        if armed:
            faults.inject("train.epoch", nth=2)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            result = sup.run(data)
        finally:
            faults.reset()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        if result.restarts != int(armed):
            raise AssertionError(f"phase 32 (c) {label}: "
                                 f"{result.restarts} restarts")
        manager = CheckpointManager(os.path.join(tmp, label))
        out[label] = (tr, tape, _final_carry(manager, 1), wall, launches)
    check_trainer_launches("phase 32 (c) the unfaulted run",
                           out["unfaulted"][4], 2 * steps,
                           num_layers=OBS_TRAIN_LAYERS)
    a, b = out["unfaulted"][2], out["faulted"][2]
    parted = [k for k in a if a[k].tobytes() != b[k].tobytes()]
    live = sum(not torch.equal(x, y) for x, y in zip(
        tree_leaves(out["unfaulted"][0].master_model.params),
        tree_leaves(out["faulted"][0].master_model.params)))
    if parted or live:
        raise AssertionError(f"phase 32 (c): the resumed carry parts from "
                             f"the unfaulted one at {parted[:5]}, {live} "
                             "live tensors")
    tape = out["unfaulted"][1]
    snap = tape.snapshot()
    logs = tape.registry.gauge(f"{tape.name}.goodput").value()
    peak = tape.peak_flops
    print(f"phase 32 (c) supervised training on {card}: LM_CFG widths at "
          f"{OBS_TRAIN_LAYERS} layers (depth cut from "
          f"{LM_CFG['num_layers']} to keep the checkpoint writes short), "
          f"2 epochs of {steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ}; "
          f"train.epoch armed nth=2: 1 restart, the resumed final carry "
          f"({len(a)} leaves: params, adam state, key) bitwise the "
          f"unfaulted run's; wall unfaulted {out['unfaulted'][3]:.2f} s, "
          f"faulted {out['faulted'][3]:.2f} s (restart cost "
          f"{out['faulted'][3] - out['unfaulted'][3]:.2f} s)", flush=True)
    print(f"phase 32 (c) tape (unfaulted run) on {card}: "
          f"{snap['examples'] / snap['wall_s']:.2f} rows/s over "
          f"{snap['wall_s']:.2f} s, phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in
                      sorted(snap["phases_s"].items()))
          + f", compile {snap['compile_s']:.3f} s, goodput "
          f"{snap['goodput']:.3f} (last epoch's gauge {logs:.3f}); MFU "
          + (f"{snap['mfu']:.4f} against {peak / 1e12:.0f} TFLOP/s bf16 "
             f"({fpe / TRAIN_SEQ / 1e9:.3f} GFLOP a token)"
             if "mfu" in snap else "absent (no peak for this card)"),
          flush=True)
    return out["unfaulted"][4]


def obs_phase(dev, card):
    """Phase 32: observability and resilience on the card. Returns each
    path's launch counts."""
    tmp = tempfile.mkdtemp(prefix="dkt-phase32-")
    try:
        model = build_lm(dev)
        serving = obs_serving_phase(model, card, tmp)
        del model
        gc.collect()
        return {"serving_obs": serving,
                "training_supervised": obs_training_phase(dev, card, tmp)}
    finally:
        faults.reset()
        shutil.rmtree(tmp, ignore_errors=True)


# --- phase 33: the serving tier ----------------------------------------------

#: phase 33's engines are phase 32's obs-on serving engine, each with its
#: own pool of this many pages
ROUTER_PAGES = 128
#: the bounded queue of (c)'s engines
ROUTER_QUEUE = 8
#: (c)'s traces: the JAX scenarios' phases and rates (times ``scale``) at
#: serving lengths
ROUTER_SCALE = 1.0
ROUTER_LENGTHS = dict(prompt_median=128.0, prompt_sigma=0.7,
                      output_median=32.0, template_len=128)
ROUTER_SPEC_KW = dict(prompt_max=480, output_max=64, length_quantum=16)
#: (c)'s engines hold the longest trace request (phase 32's 512 would
#: refuse a 480-token prompt with 64 new tokens)
ROUTER_MAX_LEN = ROUTER_SPEC_KW["prompt_max"] + ROUTER_SPEC_KW["output_max"]
#: virtual seconds per fleet step of the replays' iteration clock
ROUTER_DT = 1e-3
#: (c)'s replays build the LM at this depth (``LM_CFG`` widths): the
#: fleet's schedule (sheds, failovers, autoscaling) follows the traces'
#: lengths and the page counts, not the depth, and a host-bound decode
#: step issues its launches layer by layer
ROUTER_REPLAY_LAYERS = 4
#: the kernels phase 33 counts on each of its paths
ROUTER_KERNELS = ("flash_fwd", "paged_decode", "sample_epilogue", "prng")


def router_engine(model, eid, log, **kw):
    """One of phase 33's engines (phase 32's obs-on engine, its own pool
    of ``ROUTER_PAGES`` pages); the card's allocated bytes before and
    after the build are appended to ``log``."""
    kw.setdefault("num_pages", ROUTER_PAGES)
    kw.setdefault("max_len", 512)
    before = torch.cuda.memory_allocated()
    eng = ServingEngine(model, num_slots=4, page_len=16,
                        prefill_chunk=256, device=model.device,
                        fused_sampling=True, engine_id=eid,
                        **obs_engine_kw(True), **kw)
    log.append((eid, before, torch.cuda.memory_allocated(),
                eng.pool.allocated_bytes()))
    return eng


def replay_engine(model, eid, log):
    """One of (c)'s engines: ``router_engine`` with ``ROUTER_QUEUE`` and
    room for the longest trace request."""
    return router_engine(model, eid, log, max_queue=ROUTER_QUEUE,
                         max_len=ROUTER_MAX_LEN)


def _mem_lines(log):
    return "; ".join(f"{eid} {a / 2**30:.3f} -> {b / 2**30:.3f} GiB "
                     f"(+{(b - a) / 2**20:.1f} MiB, pool "
                     f"{pool / 2**20:.1f} MiB)" for eid, a, b, pool in log)


class _FleetTimes:
    """Host wall time of a router's steps, of its replicas' ``step()``
    inside them and of its migrations (``transfer_out`` + placement +
    ``transfer_in``), by wrapping the instances' methods; no sync is
    added."""

    def __init__(self, router):
        self.step_s, self.engine_s, self.steps = 0.0, 0.0, 0
        self.moves = []
        self._wrap(router, "step", "step_s")
        self._wrap(router, "_migrate", None, moves=True)
        for rep in router.replicas:
            self._wrap(rep, "step", "engine_s")

    def _wrap(self, obj, name, field, moves=False):
        fn = getattr(obj, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            dt = time.perf_counter() - t0
            if moves:
                # (host seconds, tokens the stream held when it moved)
                self.moves.append((dt, len(args[0].req.generated)))
            else:
                setattr(self, field, getattr(self, field) + dt)
                if field == "step_s":
                    self.steps += 1
            return out

        setattr(obj, name, timed)


def _drain(target, limit=20000):
    """Step a router or an engine until it is empty; ``{id: Request}``."""
    done, steps = {}, 0
    pending = ((lambda: target.pending) if hasattr(target, "replicas")
               else (lambda: target.scheduler.pending))
    while pending():
        out = target.step()
        for k, r in (out.items() if isinstance(out, dict)
                     else ((r.rid, r) for r in out)):
            done[k] = r
        steps += 1
        if steps > limit:
            raise AssertionError("phase 33: the target did not drain")
    return done, steps


def router_disagg(model, card, tie_rel, requests, mem):
    """(a) The 16-request workload through one engine, then through a
    prefix-affinity router with one prefill and two decode replicas:
    every stream the engine's (apart from admitted ties), 16 handoffs,
    K1f exactly twice the engine's. Returns the fleet and its launch
    counts."""
    layers = LM_CFG["num_layers"]
    eng = router_engine(model, "r33-one", mem)
    rids = [eng.submit(p, OBS_NEW_TOKENS, **kw) for p, kw in requests]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done, one_steps = _drain(eng)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one = kernels.launch_counts()
    one_sum = eng.metrics.summary()
    ref = ([(r, p) for r, (p, _) in zip(rids, requests)],
           {r: done[r].tokens for r in rids})
    del eng, done
    gc.collect()
    reps = [EngineReplica(router_engine(model, "r33-p0", mem),
                          role="prefill")]
    reps += [EngineReplica(router_engine(model, f"r33-d{i}", mem),
                           role="decode") for i in range(2)]
    router = Router(reps, policy="prefix_affinity")
    times = _FleetTimes(router)
    grids = [router.submit(p, OBS_NEW_TOKENS, **kw) for p, kw in requests]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done, steps = _drain(router)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    run = ([(g, p) for g, (p, _) in zip(grids, requests)],
           {g: done[g].tokens for g in grids})
    if any(done[g].state is not RequestState.FINISHED for g in grids):
        raise AssertionError("phase 33 (a): a routed request did not "
                             "finish")
    parted = _parted(model, ref, run, requests,
                     "phase 33 (a) disaggregated router", tie_rel)
    c = router.counters()
    pre = router.replica("r33-p0").engine.metrics.summary()
    if c["handoffs"] != len(requests) or \
            pre["requests_transferred"] != len(requests):
        raise AssertionError(f"phase 33 (a): {c['handoffs']} handoffs, "
                             f"{pre['requests_transferred']} transferred")
    want = layers * len(requests)
    if one["flash_fwd"] != want or launches["flash_fwd"] != 2 * want:
        raise AssertionError(f"phase 33 (a): K1f {launches['flash_fwd']} "
                             f"against the engine's {one['flash_fwd']}; "
                             f"expected {2 * want} and {want}")
    for name in ROUTER_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"phase 33 (a): {name} never launched")
    outside = (times.step_s - times.engine_s) / times.steps * 1e3
    moves = np.array([dt for dt, _ in times.moves]) * 1e3
    held = sorted({n for _, n in times.moves})
    print(f"phase 33 (a) disaggregated router on {card}: 16 requests "
          f"(8 greedy, 8 sampled) through r33-p0 (prefill) and r33-d0/d1 "
          f"(decode), prefix_affinity: {parted} of 16 streams part from "
          f"the one engine's, each at an admitted near-tie; handoffs "
          f"{c['handoffs']}, requests_transferred "
          f"{pre['requests_transferred']}; launches "
          f"{ {n: launches[n] for n in ROUTER_KERNELS} } against the one "
          f"engine's { {n: one[n] for n in ROUTER_KERNELS} }", flush=True)
    print(f"phase 33 (a) times on {card}: one engine {one_wall:.3f} s in "
          f"{one_steps} steps, TTFT p50 "
          f"{one_sum['ttft_s']['p50'] * 1e3:.1f} ms p99 "
          f"{one_sum['ttft_s']['p99'] * 1e3:.1f} ms; fleet {wall:.3f} s in "
          f"{steps} fleet steps, TTFT (prefill replica) p50 "
          f"{pre['ttft_s']['p50'] * 1e3:.1f} ms p99 "
          f"{pre['ttft_s']['p99'] * 1e3:.1f} ms; handoff host ms "
          f"(transfer_out + transfer_in, the pipeline drain included) "
          f"mean {moves.mean():.3f} p50 {np.median(moves):.3f} max "
          f"{moves.max():.3f} over {len(moves)} (the streams held {held} "
          f"tokens when they moved); fleet step host ms "
          f"outside the engines' step() {outside:.3f} (handoffs included), "
          f"{outside - moves.sum() / times.steps:.3f} without",
          flush=True)
    return router, ref, launches


def router_sync_free(router, model, card, tie_rel, requests, ref):
    """(b) Placement reads host state only: on two of (a)'s engines,
    ``Router.submit``, ``PrefixAffinity.rank``, both controllers'
    ``tick`` and a failover's key replay run under
    ``set_sync_debug_mode("error")``; then a live request's
    ``transfer_out`` + ``transfer_in`` after the pipeline drain."""
    engines = [router.replica(f"r33-d{i}").engine for i in range(2)]
    fleet = Router([EngineReplica(e) for e in engines],
                   policy="prefix_affinity")
    burn = SLOBurnController(fleet)

    def no_factory():
        raise AssertionError("phase 33 (b): the autoscaler scaled up")

    auto = AutoscaleController(fleet, no_factory)
    k7 = kernels.launch_counts()["prng"]
    picked = requests[:4]
    with _SyncErrors():
        ranks = [[r.name for r in fleet.policy.rank(fleet.replicas, p)]
                 for p, _ in picked]
        grids = [fleet.submit(p, OBS_NEW_TOKENS, **kw) for p, kw in picked]
        actions = [burn.tick(), auto.tick()]
        key = _replay_key(101, 64)
    if kernels.launch_counts()["prng"] != k7:
        raise AssertionError("phase 33 (b): the key replay launched K7")
    done, _ = _drain(fleet)
    run = ([(g, p) for g, (p, _) in zip(grids, picked)],
           {g: done[g].tokens for g in grids})
    sub = (ref[0][:4], ref[1])
    parted = _parted(model, sub, run, picked, "phase 33 (b) placement",
                     tie_rel)
    # a live stream between two engines, after the drain
    src, dst = engines
    p, kw = requests[1]
    rid = src.submit(p, OBS_NEW_TOKENS, **kw)
    while len(src[rid].generated) < 4:
        src.step()
    src._flush_pending()
    with _SyncErrors():
        req = src.transfer_out(rid)
        new = dst.transfer_in(req)
    done, _ = _drain(dst)
    moved = ([(new, p)], {new: done[new].tokens})
    parted += _parted(model, (ref[0][1:2], ref[1]), moved, [requests[1]],
                      "phase 33 (b) transfer", tie_rel)
    print(f"phase 33 (b) on {card}: Router.submit of 4 requests, "
          f"PrefixAffinity.rank ({ranks[0]} first), SLOBurnController "
          f"and AutoscaleController ticks ({actions}) and a 64-token key "
          f"replay ({key.tolist()}) under set_sync_debug_mode('error'): "
          f"no host sync, no K7 launch; transfer_out + transfer_in of a "
          f"sampled stream at 4 tokens after the pipeline drain: no host "
          f"sync; {parted} of 5 streams part at admitted near-ties",
          flush=True)


def router_trace(scenario, vocab):
    """A JAX reference scenario's phases and rates at serving lengths."""
    spec = scenario(vocab, scale=ROUTER_SCALE, **ROUTER_SPEC_KW)
    return synthesize(dataclasses.replace(spec, **ROUTER_LENGTHS), seed=SEED)


def router_objectives():
    return [ttft_p99(0.1), tpot_p99(0.01), availability(0.9)]


class _StepWalls:
    """Wall time of each step of a replay's target against the replay's
    virtual clock (read from an engine's metrics window)."""

    def __init__(self, target, clock_of):
        self.rows = []
        fn = target.step

        def timed():
            t = clock_of()
            t0 = time.perf_counter()
            out = fn()
            self.rows.append((t, time.perf_counter() - t0))
            return out

        target.step = timed

    def phase(self, ph):
        walls = [w for t, w in self.rows if ph.t0 <= t < ph.t1 - 1e-12]
        return sum(walls), len(walls)


def _pct(summaries, key, q):
    vals = [s[key][q] for s in summaries.values() if s[key] is not None]
    return "-" if not vals else f"{max(vals):.3f}"


def print_replay(label, res, walls, card, counters=None):
    """Per phase: wall s, steps, tokens/s by wall, shed, TTFT/TPOT
    p50/p99 (iteration-clock s, the worst engine's), prefix hits per
    engine."""
    for ph in res.phases:
        wall, steps = walls.phase(ph)
        toks = sum(s["tokens_generated"] for s in ph.summaries.values())
        hits = {e: s["prefix_cache"]["hits"] for e, s in
                ph.summaries.items()}
        print(f"phase 33 (c) {label} on {card}, phase {ph.name}: wall "
              f"{wall:.3f} s, {steps} steps, {toks} tokens "
              f"({toks / wall if wall else 0.0:.1f} tok/s by wall), "
              f"submitted {ph.submitted}, shed {ph.shed}; TTFT p50/p99 "
              f"{_pct(ph.summaries, 'ttft_s', 'p50')}/"
              f"{_pct(ph.summaries, 'ttft_s', 'p99')} s, TPOT p50/p99 "
              f"{_pct(ph.summaries, 'tpot_s', 'p50')}/"
              f"{_pct(ph.summaries, 'tpot_s', 'p99')} s (iteration clock, "
              f"{ROUTER_DT * 1e3:g} ms a step); prefix hits {hits}",
              flush=True)
    print(f"phase 33 (c) {label}: {res.iterations} iterations, totals "
          f"{res.totals}" + ("" if counters is None
                             else f", router {counters}"), flush=True)


def router_replay(model, card, trace, mem):
    """(c) trace one through a two-replica prefix-affinity fleet, then
    through one engine. Returns the fleet replay's launch counts."""
    fleet = Router([replay_engine(model, f"r33-a{i}", mem) for i in range(2)],
                   policy="prefix_affinity")
    walls = _StepWalls(fleet,
                       lambda: fleet.replicas[0].engine.metrics.clock())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = replay(trace, fleet, objectives=router_objectives(), dt=ROUTER_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if launches["flash_fwd"] < 1 or launches["paged_decode"] < 1:
        raise AssertionError(f"phase 33 (c): the replay launched "
                             f"{launches}")
    print(f"phase 33 (c) trace one ({len(trace)} requests, "
          f"{ROUTER_REPLAY_LAYERS}-layer LM, "
          f"diurnal_burst_scenario phases at scale {ROUTER_SCALE}) "
          f"through the fleet: {wall:.2f} s; launches "
          f"{ {n: launches[n] for n in ROUTER_KERNELS} }", flush=True)
    print_replay("trace one, fleet", res, walls, card, fleet.counters())
    del fleet, res, walls
    gc.collect()
    eng = replay_engine(model, "r33-one1", mem)
    walls = _StepWalls(eng, lambda: eng.metrics.clock())
    t0 = time.perf_counter()
    res = replay(trace, eng, objectives=router_objectives(), dt=ROUTER_DT)
    torch.cuda.synchronize()
    print(f"phase 33 (c) trace one through one engine: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print_replay("trace one, one engine", res, walls, card)
    return launches


def router_chaos(model, card, trace, mem, tag):
    """(c) trace two (its scripted ``replica.die``) through a fleet of two
    that an ``AutoscaleController`` may grow to three; every failed-over
    sampled stream's replayed key against its dead slot's key mirror;
    then idle ticks scale the fleet down and the retired engines' memory
    goes. Returns the comparables and the launch counts."""
    minted = []

    def factory():
        minted.append(f"{tag}-s{len(minted)}")
        return EngineReplica(replay_engine(model, minted[-1], mem))

    fleet = Router([replay_engine(model, f"{tag}-{i}", mem)
                    for i in range(2)], policy="prefix_affinity")
    ctl = AutoscaleController(fleet, factory, min_serving=1, max_replicas=3,
                              up_sustain=1, idle_sustain=4, cooldown=2)
    fleet.attach_controller(ctl)
    seeds = [weakref.ref(r.engine) for r in fleet.replicas]
    keys = []
    death = fleet._on_replica_death

    def watched(replica, error):
        eng = replica.engine
        mirrors = {tr.grid: (eng._keys[tr.req.slot].copy(),
                             len(tr.req.generated))
                   for tr in fleet._requests.values()
                   if tr.replica is replica and tr.req.temperature > 0
                   and tr.req.state is RequestState.DECODING}
        death(replica, error)
        for grid, (mirror, n) in mirrors.items():
            got = np.asarray(fleet._requests[grid].req.rng)
            keys.append((grid, n, mirror.tobytes() == got.tobytes()
                         and mirror.dtype == got.dtype))

    fleet._on_replica_death = watched
    walls = _StepWalls(fleet, lambda: next(
        r.engine.metrics.clock() for r in fleet.replicas))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = replay(trace, fleet, objectives=router_objectives(),
                     dt=ROUTER_DT)
    finally:
        faults.reset()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    out = copy.deepcopy({
        "outcomes": res.outcomes, "incidents": res.incidents,
        "fleet_timeline": res.fleet_timeline,
        "autoscale_events": res.autoscale_events,
        "report": report_to_json(build_report(res))})
    print_replay(f"trace two ({tag})", res, walls, card, fleet.counters())
    print(f"phase 33 (c) trace two ({tag}, {len(trace)} requests, "
          f"{ROUTER_REPLAY_LAYERS}-layer LM, "
          f"flash_crowd_chaos_scenario phases at scale {ROUTER_SCALE}): "
          f"{wall:.2f} s; launches "
          f"{ {n: launches[n] for n in ROUTER_KERNELS} }; incidents "
          f"{res.incidents}; failovers {fleet.counters()['failovers']}; "
          f"fleet_timeline {res.fleet_timeline}; autoscale "
          f"{ctl.counts()}", flush=True)
    if not keys or not all(ok for _, _, ok in keys):
        raise AssertionError(f"phase 33 (c): replayed keys against the dead "
                             f"slots' mirrors: {keys}")
    del res, walls
    gc.collect()
    dead = [ref() is None for ref in seeds]
    before = torch.cuda.memory_allocated()
    pools = {r.name: r.engine.pool.allocated_bytes() for r in fleet.replicas}
    gone = []
    for _ in range(32):
        for name, act in ctl.tick().items():
            if act == "remove":
                gone.append(name)
        if sum(r.state.value == "serving" for r in fleet.replicas) <= 1:
            break
    gc.collect()
    after = torch.cuda.memory_allocated()
    freed = sum(pools[n] for n in gone)
    print(f"phase 33 (c) {tag}: {len(keys)} failed-over sampled streams' "
          f"replayed keys equal their dead slots' key mirrors byte for "
          f"byte; the dead seed replica's engine collected: {any(dead)}; "
          f"scale-down retired {gone}: allocated {before / 2**30:.3f} -> "
          f"{after / 2**30:.3f} GiB (their pools {freed / 2**20:.1f} MiB)",
          flush=True)
    if not any(dead) or not gone or before - after < freed:
        raise AssertionError(f"phase 33 (c) {tag}: dead engine collected "
                             f"{dead}, retired {gone}, freed "
                             f"{before - after} of {freed} bytes")
    return out, launches


def router_phase(dev, card, tie_rel):
    """Phase 33: the serving tier on the card, (c)'s replays on the LM
    at ``ROUTER_REPLAY_LAYERS`` blocks. Returns each path's launch
    counts."""
    model = build_lm(dev)
    vocab = LM_CFG["vocab"]
    mem = []
    t0 = time.perf_counter()
    requests = obs_workload(vocab)
    router, ref, disagg = router_disagg(model, card, tie_rel, requests, mem)
    router_sync_free(router, model, card, tie_rel, requests, ref)
    del router, model
    gc.collect()
    model = build_lm(dev, num_layers=ROUTER_REPLAY_LAYERS)
    t1 = time.perf_counter()
    replay_launches = router_replay(
        model, card, router_trace(diurnal_burst_scenario, vocab), mem)
    t2 = time.perf_counter()
    chaos_trace = router_trace(flash_crowd_chaos_scenario, vocab)
    first, chaos_launches = router_chaos(model, card, chaos_trace, mem,
                                         "r33-c")
    gc.collect()
    second, _ = router_chaos(model, card, chaos_trace, mem, "r33-c")
    if first != second:
        diff = [k for k in first if first[k] != second[k]]
        raise AssertionError(f"phase 33 (c): the two chaos replays differ "
                             f"in {diff}")
    t3 = time.perf_counter()
    print(f"phase 33 (c) the two chaos replays: identical outcomes "
          f"({len(first['outcomes'])}), incidents, fleet timelines, "
          f"autoscale events and build_report JSON "
          f"({len(first['report'])} bytes)", flush=True)
    print(f"phase 33 engines built on {card}: " + _mem_lines(mem),
          flush=True)
    print(f"phase 33 took {t3 - t0:.1f} s: (a)+(b) {t1 - t0:.1f}, trace one "
          f"{t2 - t1:.1f}, trace two twice {t3 - t2:.1f}", flush=True)
    del model
    gc.collect()
    return {"serving_router_disagg": disagg,
            "serving_router_replay": replay_launches,
            "serving_router_chaos": chaos_launches}


# --- phase 34: the data plane and job deployment ------------------------------

#: BASELINE config 4's stand-in at the Criteo Display Advertising
#: Challenge schema (Kaggle 2014, ``train.txt``: a label, 13 integer
#: counts I1-I13 and 26 categorical columns C1-C26 of 8-hex-digit hashes,
#: tab separated, ~25.6% positives), cut to this many rows (a day of
#: Criteo holds ~45M)
CRITEO_ROWS = 65536
CRITEO_COUNTS, CRITEO_CATS = 13, 26
#: the smallest and largest vocabulary of a categorical column, and the
#: exponent of the Zipf law its values are drawn from
CRITEO_VOCAB = (4, 100_000)
CRITEO_ZIPF = 1.1
CRITEO_POSITIVE = 0.25
#: the wide half's hash buckets and the deep half's hidden widths
CRITEO_BUCKETS = 4096
CRITEO_DEEP = (256, 128)
CRITEO_WORKERS, CRITEO_BATCH, CRITEO_WINDOW, CRITEO_EPOCHS = 4, 512, 5, 2
CRITEO_LR = 1e-2
#: the trained model's AUC on its training rows must clear this (the CPU
#: rehearsal of the same seed at the full size: see PERF.md)
CRITEO_AUC_MIN = 0.8
#: phase 34 (b): the 218M LM through ``from_torch``: rows taken from a
#: DataLoader of phase 7's rows, and the loader's batch
FROM_TORCH_ROWS, FROM_TORCH_LOADER_BATCH = 16, 8
#: the argument lists of the four ported examples, as the JAX package's
#: tests/test_examples.py runs their JAX counterparts, and what each must
#: reach: (module, argv, check on (return value, printed text))
DATA_EXAMPLES = (
    ("mnist_workflow", ["--trainer", "aeasgd", "--epochs", "2",
                        "--n", "2048"], lambda acc, out: acc > 0.75),
    ("criteo_wide_deep", [], lambda acc, out: acc > 0.85),
    ("higgs_physics", ["--epochs", "4", "--n", "8192"],
     lambda acc, out: acc > 0.8 and "ROC-AUC" in out),
    ("streaming_inference", [],
     lambda acc, out: "streamed 10624 rows" in out),
)
#: the script each process of phase 34 (c)'s job runs: argv is the CSV
#: and the device. It joins the job's gloo group, all-reduces its rank +
#: 1 on the host, reads the CSV, trains one ``SingleTrainer`` epoch of an
#: MLP on ``log1p`` of the counts and prints a digest of its predictions
DEPLOY_SCRIPT = '''
import time
t_start = time.time()
import sys
import numpy as np
import torch
import torch.distributed as dist
from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.deploy import initialize_from_env
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.parallel import SingleTrainer

info = initialize_from_env()
rank = info["process_id"]
print(f"FIRST {rank} {t_start:.6f} {time.time():.6f}", flush=True)
total = torch.tensor([float(rank + 1)])
dist.all_reduce(total)
device = sys.argv[2]
assert device == "cpu" or torch.cuda.is_available(), "no card"
ds = Dataset.from_csv(sys.argv[1], label_col_index=0)
X = np.log1p(ds["features"])
ds = ds.with_column("features", X)
model = Model.build(zoo.mlp((64,), num_classes=2), (X.shape[1],), seed=0,
                    device=device)
kernels.reset_launch_counts()
tr = SingleTrainer(model, worker_optimizer="adam", learning_rate=1e-3,
                   loss="sparse_categorical_crossentropy_from_logits",
                   batch_size=512, num_epoch=1)
trained = tr.train(ds)
prng = kernels.launch_counts()["prng"]
digest = float(np.asarray(trained.predict(X[:1024]), np.float64).sum())
print(f"DIGEST {rank} {total.item()} {digest!r} {prng} "
      f"{info['num_processes']}", flush=True)
'''
#: phase 34 (c)'s retry job: both ranks fail on the first attempt (a
#: marker file tells the attempts apart, read between two barriers)
RETRY_SCRIPT = '''
import os, sys
import torch.distributed as dist
from distkeras_tpu_torch.deploy import initialize_from_env

info = initialize_from_env()
dist.barrier()
first = not os.path.exists(sys.argv[1])
dist.barrier()
if first:
    if info["process_id"] == 0:
        open(sys.argv[1], "w").close()
    sys.exit(1)
print(f"RECOVERED {info['process_id']}", flush=True)
'''


def criteo_standin(path, rows=CRITEO_ROWS, seed=SEED):
    """Config 4's rows from ``seed``: writes the numeric part (label, then
    I1-I13 as heavy-tailed log-normal counts, a missing count written as
    0) to ``path`` tab separated, and returns the categorical part as
    dict rows ``{"C1": "1f0e3dad", ...}`` (Zipf draws over vocabularies
    of 4 to 100,000 hashed values a column). The label thresholds a
    logistic model over both parts at ``CRITEO_POSITIVE`` positives."""
    rs = np.random.RandomState(seed)
    mu = rs.uniform(0.0, 3.0, CRITEO_COUNTS)
    sigma = rs.uniform(0.5, 2.0, CRITEO_COUNTS)
    counts = np.round(rs.lognormal(mu, sigma, (rows, CRITEO_COUNTS)))
    missing = rs.rand(rows, CRITEO_COUNTS) < rs.uniform(0.0, 0.5,
                                                        CRITEO_COUNTS)
    counts[missing] = 0
    vocab = np.round(np.geomspace(*CRITEO_VOCAB, CRITEO_CATS)).astype(int)
    rs.shuffle(vocab)
    score = np.log1p(counts) @ (0.3 * rs.randn(CRITEO_COUNTS))
    cats = []
    for v in vocab:
        p = np.arange(1, v + 1, dtype=np.float64) ** -CRITEO_ZIPF
        idx = rs.choice(v, rows, p=p / p.sum())
        names = np.char.mod("%08x", rs.randint(0, 2 ** 32, v,
                                               dtype=np.int64))
        cats.append(names[idx])
        score += 0.5 * rs.randn(v)[idx]
    score += rs.logistic(size=rows)
    label = score > np.quantile(score, 1.0 - CRITEO_POSITIVE)
    np.savetxt(path, np.column_stack([label, counts]), fmt="%d",
               delimiter="\t")
    keys = [f"C{j + 1}" for j in range(CRITEO_CATS)]
    return [dict(zip(keys, vals)) for vals in zip(*cats)]


def criteo_ingest(pkg, path, cat_rows, buckets=CRITEO_BUCKETS, seed=SEED,
                  times=None):
    """Config 4's ingest through the data package ``pkg`` (``data`` of
    the port, or a module with the same names): ``Dataset.from_csv`` of
    the tab-separated counts with the default ``sep=","``, the
    categorical columns joined from ``from_iterable``, ``log1p`` and
    ``MinMaxTransformer`` on the counts (the deep half),
    ``HashingTransformer`` over C1-C26 (the wide half),
    ``VectorAssemblerTransformer(["wide", "deep"])`` and the shuffle.
    Returns ``Dataset({"features": [rows, buckets + 13] float32,
    "label"})``; ``times`` gets each stage's host seconds."""
    times = {} if times is None else times

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
        return out

    ds = stage("parse", lambda: pkg.Dataset.from_csv(path,
                                                     label_col_index=0))

    def join():
        cats = pkg.from_iterable(cat_rows)
        out = ds
        for col in cats.columns:
            out = out.with_column(col, cats[col])
        return out

    ds = stage("join", join)
    ds = stage("log_minmax", lambda: pkg.MinMaxTransformer(
        input_col="deep_log", output_col="deep")(
            ds.map_column("features", np.log1p, "deep_log")))
    ds = stage("hashing", lambda: pkg.HashingTransformer(
        buckets, [f"C{j + 1}" for j in range(CRITEO_CATS)],
        output_col="wide")(ds))
    ds = stage("assembly", lambda: pkg.VectorAssemblerTransformer(
        ["wide", "deep"])(ds).select(["features", "label"]))
    return stage("shuffle", lambda: ds.shuffle(seed))


class _NativeGathers:
    """While entered, counts the host library's gathers (calls of its C
    ``dkt_gather``) and the ``native.gather`` calls that took numpy's
    path; ``bytes`` sums the C path's rows."""

    def __enter__(self):
        lib = native._load()
        if lib is None:
            raise AssertionError(f"no host library: "
                                 f"{native.native_status()}")
        self.lib, self.c_calls, self.numpy_calls, self.bytes = lib, 0, 0, 0
        self._c, self._gather = lib.dkt_gather, native.gather

        def c_gather(src, perm, out, n, row_bytes, threads):
            self.c_calls += 1
            self.bytes += n * row_bytes
            return self._c(src, perm, out, n, row_bytes, threads)

        def gather(src, perm, **kw):
            calls = self.c_calls
            out = self._gather(src, perm, **kw)
            self.numpy_calls += self.c_calls == calls
            return out

        lib.dkt_gather, native.gather = c_gather, gather
        return self

    def __exit__(self, *exc):
        self.lib.dkt_gather, native.gather = self._c, self._gather


def stacked_step_costs(model, dev, X, Y, loss, opt, workers, n=10):
    """A warm stacked step (each of ``workers`` stacked workers' train
    step on ``(X, Y)``) on a fresh engine state of ``model``: its wall
    ms (host clock to a synchronize, ``n`` steps), and from
    ``torch.profiler`` over one step the device's busy ms and the CUDA
    kernels it launched."""
    from torch.profiler import ProfilerActivity, profile
    eng = DistributedEngine(model.module, loss, opt, DownpourAlgo(), None,
                            EngineConfig(num_workers=workers,
                                         window=CRITEO_WINDOW,
                                         amortized=True))
    state = eng.init_state(model.params, prng.key(SEED, dev))
    w = state["worker"]
    stack = WorkerStack(eng.train_step, w["params"], w["opt"], w["rng"])
    X, Y = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)

    def step():
        return [stack.step(i, X, Y) for i in range(workers)]

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    return (wall, sum(e.self_device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern))


def criteo_phase(dev, card, tmp):
    """Phase 34 (a): BASELINE config 4 end to end. Returns the DOWNPOUR
    run's launch counts."""
    path = os.path.join(tmp, "criteo_standin.tsv")
    t0 = time.perf_counter()
    cat_rows = criteo_standin(path)
    made = time.perf_counter() - t0
    times = {}
    with _NativeGathers() as ingest_gathers:
        ds = criteo_ingest(port_data, path, cat_rows, times=times)
    del cat_rows
    gc.collect()
    X, y = ds["features"], ds["label"]
    mb = os.path.getsize(path) / 1e6
    print(f"phase 34 (a) config 4 ingest on the host ({CRITEO_ROWS} rows, "
          f"{mb:.1f} MB of counts made in {made:.2f} s): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; parse {mb / times['parse']:.1f} MB/s; features "
          f"{list(X.shape)} {X.dtype} ({X.nbytes / 1e9:.2f} GB), "
          f"{100 * y.mean():.1f}% positives; C gathers in the ingest "
          f"{ingest_gathers.c_calls} ({ingest_gathers.bytes / 1e9:.2f} GB), "
          f"numpy's path {ingest_gathers.numpy_calls}", flush=True)
    if X.shape != (CRITEO_ROWS, CRITEO_BUCKETS + CRITEO_COUNTS) \
            or ingest_gathers.c_calls < 1 or not np.isfinite(X).all():
        raise AssertionError("phase 34 (a): the ingest's features or its "
                             "native shuffle are wrong")
    perm = np.random.RandomState(SEED + 34).permutation(len(X))
    rates = {"native": [], "numpy": []}
    for _ in range(3):
        for which, fn in (("native", lambda: native.gather(X, perm)),
                          ("numpy", lambda: X[perm])):
            t0 = time.perf_counter()
            out = fn()
            rates[which].append(2 * X.nbytes / (time.perf_counter() - t0)
                                / 1e9)
            del out
    print(f"phase 34 (a) the epoch permutation of {X.nbytes / 1e9:.2f} GB "
          f"(read + write), interleaved: native.gather "
          + " / ".join(f"{r:.2f}" for r in rates["native"])
          + " GB/s; numpy src[perm] "
          + " / ".join(f"{r:.2f}" for r in rates["numpy"]) + " GB/s "
          f"({os.cpu_count()} host cores)", flush=True)

    model = Model.build(zoo.wide_and_deep(CRITEO_BUCKETS, CRITEO_DEEP, 2),
                        (CRITEO_BUCKETS + CRITEO_COUNTS,), seed=SEED,
                        device=dev)
    tr = DOWNPOUR(model, num_workers=CRITEO_WORKERS,
                  batch_size=CRITEO_BATCH,
                  communication_window=CRITEO_WINDOW,
                  commit_scale=1.0 / CRITEO_WORKERS, num_epoch=CRITEO_EPOCHS,
                  worker_optimizer="adam", learning_rate=CRITEO_LR,
                  loss=TRAIN_LOSS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _NativeGathers() as epoch_gathers, warnings.catch_warnings():
        # the engine's auto rule takes the amortized program (staggered
        # commits batch at block boundaries), as JAX's does
        warnings.filterwarnings("ignore", "amortized two-level scan")
        trained = tr.train(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    losses = tr.get_history().losses()
    steps = CRITEO_EPOCHS * CRITEO_ROWS // (CRITEO_WORKERS * CRITEO_BATCH)
    worker_steps = steps * CRITEO_WORKERS
    if losses.shape != (steps, CRITEO_WORKERS) \
            or not np.isfinite(losses).all():
        raise AssertionError(f"phase 34 (a): expected {steps} x "
                             f"{CRITEO_WORKERS} finite losses, got "
                             f"{losses.shape}")
    if epoch_gathers.c_calls < CRITEO_EPOCHS:
        raise AssertionError("phase 34 (a): the epoch shuffle did not run "
                             "the host library's gather")
    step_ms, busy_ms, step_kernels = stacked_step_costs(
        model, dev, X[:CRITEO_BATCH], y[:CRITEO_BATCH], get_loss(TRAIN_LOSS),
        get_optimizer("adam", learning_rate=CRITEO_LR), CRITEO_WORKERS)
    print(f"phase 34 (a) DOWNPOUR on {card}: {CRITEO_WORKERS} stacked "
          f"workers of zoo.wide_and_deep({CRITEO_BUCKETS}, {CRITEO_DEEP}) "
          f"float32 ({model.num_params():,} parameters), B{CRITEO_BATCH}, "
          f"window {CRITEO_WINDOW}, {steps} stacked steps "
          f"({worker_steps} worker steps) in {wall:.2f} s: "
          f"{worker_steps / wall:.1f} worker steps/s, "
          f"{worker_steps * CRITEO_BATCH / wall:,.0f} rows/s; loss "
          f"{losses[0].mean():.4f} -> {losses[-1].mean():.4f}; C gathers "
          f"{epoch_gathers.c_calls} ({epoch_gathers.bytes / 1e9:.2f} GB); "
          f"a warm stacked step {step_ms:.2f} ms wall, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}%), "
          f"{step_kernels} CUDA kernels; K7 {launches['prng']} "
          f"({launches['prng'] / worker_steps:.3f} a worker step); peak "
          f"device memory {peak / 2 ** 30:.2f} GiB above "
          f"{base / 2 ** 30:.2f}", flush=True)
    del tr
    gc.collect()
    t0 = time.perf_counter()
    scored = ModelPredictor(trained, output_col="prediction",
                            batch_size_per_device=2048).predict(ds)
    pred_s = time.perf_counter() - t0
    scored = LabelIndexTransformer(input_col="prediction",
                                   output_col="predicted_index")(scored)
    acc = AccuracyEvaluator(prediction_col="predicted_index").evaluate(
        scored)
    f1_ = Evaluator("f1", prediction_col="prediction").evaluate(scored)
    roc = Evaluator("auc", prediction_col="prediction").evaluate(scored)
    print(f"phase 34 (a) ModelPredictor: {CRITEO_ROWS} rows in {pred_s:.2f} "
          f"s ({CRITEO_ROWS / pred_s:,.0f} rows/s); accuracy {acc:.4f} "
          f"(all-negative {1 - y.mean():.4f}), macro-F1 {f1_:.4f}, AUC "
          f"{roc:.4f} (min {CRITEO_AUC_MIN})", flush=True)
    if not roc > CRITEO_AUC_MIN:
        raise AssertionError(f"phase 34 (a): AUC {roc} <= {CRITEO_AUC_MIN}")
    del model, trained, ds, scored, X, y
    gc.collect()
    return launches, path


def lm_from_torch_phase(dev, card):
    """Phase 34 (b): the 218M LM trained on rows that ``from_torch``
    took from a ``DataLoader``, against the same rows through
    ``Dataset.from_arrays``: exactly 12 launches of each flash kernel and
    one K7 a step, the losses bitwise equal. Returns the launch counts
    of the ``from_torch`` run."""
    from torch.utils.data import DataLoader, TensorDataset
    X, Y = training_data(LM_CFG["vocab"]).arrays()
    loader = DataLoader(TensorDataset(torch.from_numpy(X),
                                      torch.from_numpy(Y)),
                        batch_size=FROM_TORCH_LOADER_BATCH)
    t0 = time.perf_counter()
    adapted = port_data.from_torch(loader, limit=FROM_TORCH_ROWS)
    adapt_s = time.perf_counter() - t0
    n = FROM_TORCH_ROWS
    if not (np.array_equal(adapted["features"], X[:n])
            and np.array_equal(adapted["label"], Y[:n])
            and adapted["features"].dtype == np.int64):
        raise AssertionError("phase 34 (b): from_torch changed the rows")
    steps = n // TRAIN_BATCH
    runs = []
    for label, source in (("from_torch", adapted),
                          ("from_arrays", Dataset.from_arrays(
                              X[:n].copy(), Y[:n].copy()))):
        tr = lm_trainer(build_lm(dev))
        with _NativeGathers() as gathers:
            launches = check_trainer_launches(
                f"phase 34 (b) {label}", counted_train(tr, source), steps)
        runs.append((tr.get_history().losses(), launches,
                     gathers.numpy_calls, gathers.c_calls))
        del tr
        gc.collect()
    same = np.array_equal(runs[0][0], runs[1][0])
    print(f"phase 34 (b) the 218M LM on {card} through from_torch "
          f"(DataLoader batch {FROM_TORCH_LOADER_BATCH}, limit {n}: "
          f"{adapt_s * 1e3:.1f} ms): {steps} SingleTrainer steps of "
          f"B{TRAIN_BATCH}, losses {np.array2string(runs[0][0], precision=4)}"
          f" bitwise the from_arrays run's: {same}; launches "
          f"{runs[0][1]}; the shuffle's gathers: numpy's path "
          f"{runs[0][2]}, C {runs[0][3]} (below the 4 MiB threshold)",
          flush=True)
    if not same:
        raise AssertionError("phase 34 (b): the from_torch losses differ "
                             "from the from_arrays run's")
    return runs[0][1]


def _job_lines(logs, tag):
    return [line.split() for log in logs for line in log.splitlines()
            if line.startswith(tag)]


def deploy_phase(dev, card, tmp, csv_path):
    """Phase 34 (c): a ``Punchcard`` runs a job of two processes of
    ``DEPLOY_SCRIPT`` (gloo all-reduce, the CSV, a ``SingleTrainer`` epoch
    on ``dev``): equal digests; a wrong secret is refused; a job failing
    its first attempt succeeds with ``max_retries=1``. Returns the K7
    launches summed over the two processes."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "deploy_worker.py")
    with open(script, "w") as f:
        f.write(DEPLOY_SCRIPT)
    env = {"PYTHONPATH": repo}
    daemon = Punchcard(secret="phase34")
    port = daemon.start()
    try:
        client = PunchcardClient("127.0.0.1", port, "phase34")
        t_submit = time.time()
        job = client.submit(JobSpec(script=script,
                                    args=[csv_path, dev.type],
                                    num_processes=2, env=env, timeout=120,
                                    name="phase34"))
        st = client.wait(job, timeout=150, poll=0.05)
        done = time.time() - t_submit
        try:
            PunchcardClient("127.0.0.1", port, "wrong").list_jobs()
            refused = False
        except RuntimeError as e:
            refused = "authentication" in str(e)
    finally:
        daemon.stop()
    logs = (st.get("result") or {}).get("logs", [])
    if st["state"] != "done":
        raise AssertionError(f"phase 34 (c): the job ended {st['state']}: "
                             + "\n".join(logs))
    first = sorted(_job_lines(logs, "FIRST"))
    digests = sorted(_job_lines(logs, "DIGEST"))
    if len(digests) != 2 or digests[0][3] != digests[1][3] \
            or any(d[2] != "3.0" for d in digests) or not refused:
        raise AssertionError(f"phase 34 (c): digests {digests}, wrong "
                             f"secret refused {refused}")
    marker = os.path.join(tmp, "retry_marker")
    retry_script = os.path.join(tmp, "retry_worker.py")
    with open(retry_script, "w") as f:
        f.write(RETRY_SCRIPT)
    t0 = time.perf_counter()
    res = Job(JobSpec(script=retry_script, args=[marker], num_processes=2,
                      env=env, timeout=60, max_retries=1)).run()
    retry_total = time.perf_counter() - t0
    if not (res.ok and res.attempts == 2
            and len(_job_lines(res.logs, "RECOVERED")) == 2):
        raise AssertionError(f"phase 34 (c): the retried job: ok {res.ok}, "
                             f"attempts {res.attempts}: {res.logs}")
    prng_total = sum(int(d[4]) for d in digests)
    print(f"phase 34 (c) deploy on {card}: a Punchcard job of 2 processes "
          f"(gloo, all-reduce {digests[0][2]}), submit to done {done:.2f} "
          f"s; each process from the submit to its start / to its group "
          + ", ".join(f"{float(f[2]) - t_submit:.2f} / "
                      f"{float(f[3]) - t_submit:.2f} s" for f in first)
          + f"; digests equal ({digests[0][3]}); K7 {prng_total} in both; "
          f"a wrong secret refused; the retried job ok in 2 attempts, "
          f"{retry_total:.2f} s ({retry_total - res.wall_seconds:.2f} s "
          f"for the failed attempt)", flush=True)
    return {"prng": prng_total}


def examples_phase(dev, card):
    """Phase 34 (d): the four ported examples in this process on ``dev``
    at ``DATA_EXAMPLES``'s arguments, each above its threshold."""
    import importlib
    import io
    walls = []
    for name, argv, ok in DATA_EXAMPLES:
        mod = importlib.import_module(f"distkeras_tpu_torch.examples.{name}")
        saved = sys.argv
        sys.argv = [name, *argv, "--device", dev.type]
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                result = mod.main()
        finally:
            sys.argv = saved
        walls.append(f"{name} {time.perf_counter() - t0:.1f} s")
        out = buf.getvalue()
        last = out.strip().splitlines()[-1]
        print(f"phase 34 (d) {name}: {last}", flush=True)
        if not ok(result, out):
            raise AssertionError(f"phase 34 (d): {name} returned {result}:"
                                 f"\n{out}")
        gc.collect()
    print(f"phase 34 (d) examples on {card}: " + ", ".join(walls),
          flush=True)


def data_phase(dev, card):
    """Phase 34: the data plane and job deployment on the card. Returns
    each path's launch counts."""
    status = native.native_status()
    print(f"phase 34 host data library: {status}", flush=True)
    if not status.startswith("native:"):
        raise AssertionError(f"phase 34: the host library did not build: "
                             f"{status}")
    tmp = tempfile.mkdtemp(prefix="dkt-phase34-")
    try:
        t = [time.perf_counter()]
        criteo, csv_path = criteo_phase(dev, card, tmp)
        gc.collect()
        t.append(time.perf_counter())
        lm = lm_from_torch_phase(dev, card)
        gc.collect()
        t.append(time.perf_counter())
        deploy = deploy_phase(dev, card, tmp, csv_path)
        gc.collect()
        t.append(time.perf_counter())
        examples_phase(dev, card)
        gc.collect()
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    d = np.diff(t)
    print(f"phase 34 took {t[-1] - t[0]:.1f} s: (a) {d[0]:.1f}, (b) "
          f"{d[1]:.1f}, (c) {d[2]:.1f}, (d) {d[3]:.1f}", flush=True)
    return {"data_criteo_downpour": criteo, "data_lm_from_torch": lm,
            "data_deploy": deploy}


# --- phase 35: the ten one-card examples, and the attention kernels at ----
# --- their head dims (8, 12, 16) ---------------------------------------------

#: the head dims the examples' models give (d_model / heads), each at the
#: shapes of the example named: dtype; the training attention (B, S, H,
#: window, packed ids); generate()'s cache (B, L) for K2; the engine's
#: pool (slots, pages a slot, page_len) for K3, Hkv = H
SMALL_DIM_SHAPES = {
    8: ("continuous_batching", torch.float32, (64, 11, 4, None, False),
        (1, 22), (3, 3, 16)),
    12: ("packed_moe_serving", torch.bfloat16, (48, 24, 4, 8, True),
         (2, 12), (3, 3, 16)),
    16: ("lm_generate", torch.float32, (128, 11, 4, None, False),
         (64, 12), (2, 3, 16)),
}
#: float32 attention against the float32 plain version: two summation
#: orders over at most a few dozen keys
KERNEL_F32_SMALL_TOL = 2e-4


def _peak(dtype):
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS


def _attn_mask(sq, sk, causal, window, ids, dev):
    """``[B or 1, 1, Sq, Sk]`` bool: the pairs the kernels admit."""
    i = torch.arange(sq, device=dev)[:, None]
    j = torch.arange(sk, device=dev)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        m &= j <= i
    if window is not None:
        m &= j > i - window
    m = m[None, None]
    if ids is not None:
        m = m & (ids[:, None, :, None] == ids[:, None, None, :])
    return m


def small_flash_rows(dev, d):
    """K1f, K1dq and K1dkv at head dim ``d`` on its example's training
    attention: the plain version's values, device times by graph replay,
    the bound, and masked SDPA (forward; forward+backward minus forward)
    as the yardstick."""
    example, dtype, (b, s, h, window, packed), _, _ = SMALL_DIM_SHAPES[d]
    g = torch.Generator(device="cpu").manual_seed(SEED + d)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    q, k, v, dout = (rnd(b, s, h, d) for _ in range(4))
    ids = None
    if packed:
        ids = torch.from_numpy(np.sort(np.random.RandomState(SEED + d)
                                       .randint(0, 3, (b, s)), axis=1)
                               .astype(np.int32)).to(dev)
    kw = dict(scale=d ** -0.5, causal=True, window=window, layout="bshd")
    label = f"D{d} {example} B{b} S{s} H{h} causal" + \
        ("" if window is None else f" window={window}") + \
        (" ids" if packed else "") + f" {str(dtype)[6:]}"
    counts = kernels.launch_counts()
    out, lse = flash_forward(q, k, v, segment_ids=ids, **kw)
    delta = attention_delta(out, dout)
    args = (q, k, v, lse, dout, delta, kw["scale"], True, window, "bshd")
    got = launch_dq(*args, segment_ids=ids) + \
        launch_dkv(*args, segment_ids=ids)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in TRAINING_KERNELS:
        if after[name] != counts[name] + 1:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{after[name] - counts[name]} times")
    ref, ref_lse = flash_forward_reference(q, k, v, segment_ids=ids, **kw)
    tol = KERNEL_BF16_TOL if dtype == torch.bfloat16 else \
        KERNEL_F32_SMALL_TOL
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    gref = flash_backward_reference(q, k, v, out, lse, dout, delta,
                                    segment_ids=ids, **kw)
    rel = {n: (a.float() - r.float()).abs().max().item()
           / r.float().abs().max().item()
           for n, a, r in zip(("dq", "dk", "dv"), got, gref)}
    gerr = {n: (a.float() - r.float()).abs().max().item()
            for n, a, r in zip(("dq", "dk", "dv"), got, gref)}
    bwd_tol = BWD_BF16_REL_TOL if dtype == torch.bfloat16 else 1e-4
    mask = _attn_mask(s, s, True, window, ids, dev)
    pairs = int(mask.expand(b, 1, s, s).sum().item())    # per head
    esize = q.element_size()
    qb, kvb, rowb = esize * q.numel(), esize * k.numel(), 4 * lse.numel()
    peak = _peak(dtype)
    f_bound, f_by = bound_ms(4.0 * h * pairs * d, 2 * qb + 2 * kvb + rowb,
                             peak)
    in_bytes = 2 * qb + 2 * kvb + 2 * rowb
    dq_bound, dq_by = bound_ms(6.0 * h * pairs * d, in_bytes + qb, peak)
    dkv_bound, dkv_by = bound_ms(8.0 * h * pairs * d, in_bytes + 2 * kvb,
                                 peak)
    f_ms = graph_ms(lambda: flash_forward(q, k, v, segment_ids=ids, **kw))
    dq_ms = graph_ms(lambda: launch_dq(*args, segment_ids=ids))
    dkv_ms = graph_ms(lambda: launch_dkv(*args, segment_ids=ids))
    f_plain = time_ms(lambda: flash_forward_reference(
        q, k, v, segment_ids=ids, **kw), iters=5)
    b_plain = time_ms(lambda: flash_backward_reference(
        q, k, v, out, lse, dout, delta, segment_ids=ids, **kw), iters=5)
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                  for x in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    with torch.no_grad():
        lib_f = graph_ms(sdpa)
    lib_b = graph_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                 dt)) - lib_f
    ok = err <= tol and lse_err <= LSE_TOL and max(rel.values()) <= bwd_tol
    print(f"phase 35 {label}: flash_fwd max_abs_err {err:.3e} (tol {tol}),"
          f" lse {lse_err:.3e}; {f_ms:.4f} ms (bound {f_bound:.2e} ms, "
          f"{f_by}), plain {f_plain:.4f}, sdpa {lib_f:.4f}; flash_bwd_dq "
          f"{dq_ms:.4f} ms (bound {dq_bound:.2e}, {dq_by}), flash_bwd_dkv "
          f"{dkv_ms:.4f} ms (bound {dkv_bound:.2e}, {dkv_by}), plain "
          f"backward {b_plain:.4f}, sdpa backward {lib_b:.4f}; gradients "
          f"relative to the reference's max {rel['dq']:.2e} "
          f"{rel['dk']:.2e} {rel['dv']:.2e} (tol {bwd_tol}); graph replay",
          flush=True)
    if not ok:
        raise AssertionError(f"phase 35: the flash kernels disagree with "
                             f"their plain versions at {label}")

    def row(e, ms, plain, lib, bms, by):
        return dict(name=label, err=e, ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=bms, bound_by=by)

    return {"flash_fwd": row(err, f_ms, f_plain, lib_f, f_bound, f_by),
            "flash_bwd_dq": row(gerr["dq"], dq_ms, b_plain, lib_b, dq_bound,
                                dq_by),
            "flash_bwd_dkv": row(max(gerr["dk"], gerr["dv"]), dkv_ms,
                                 b_plain, lib_b, dkv_bound, dkv_by)}


def small_decode_rows(dev, d):
    """K2 and K2-q8 at head dim ``d`` on its example's generate() cache
    (Hkv 4, G 1, t the last position)."""
    example, dtype, (_, _, h, _, _), (b, length), _ = SMALL_DIM_SHAPES[d]
    rs = np.random.RandomState(SEED + 40 + d)
    rows = {}
    for kname, bits in (("decode_attention", None),
                        ("decode_attention_q8", 8)):
        q = torch.from_numpy(rs.randn(b * h, 1, d).astype(np.float32))
        k, v = (torch.from_numpy(rs.randn(b * h, length, d)
                                 .astype(np.float32)).to(dev)
                for _ in range(2))
        c = dict(b=b, hkv=h, g=1, t=length - 1, window=None)
        if bits is None:
            c.update(q=q.to(dev, dtype), k=k.to(dtype), v=v.to(dtype))
        else:
            (kq, ks), (vq, vs) = (_quantize_kv(x, bits) for x in (k, v))
            c.update(q=q.to(dev), k=kq, v=vq, k_scale=ks, v_scale=vs)
        sc = {} if bits is None else dict(k_scale=c["k_scale"],
                                          v_scale=c["v_scale"])

        def call():
            return decode_attention(c["q"], c["k"], c["v"], c["t"],
                                    scale=d ** -0.5, **sc)

        def plain():
            return decode_attention_reference(c["q"], c["k"], c["v"], c["t"],
                                              scale=d ** -0.5, **sc)

        before = kernels.launch_counts()[kname]
        out = call()
        torch.cuda.synchronize()
        if kernels.launch_counts()[kname] != before + 1:
            raise AssertionError(f"phase 35: D{d} did not launch {kname}")
        err = (out - plain()).abs().max().item()
        same = torch.equal(out, call())
        tol = KERNEL_BF16_TOL if dtype == torch.bfloat16 and bits is None \
            else KERNEL_Q_TOL
        esize = c["k"].element_size()
        nbytes = 2 * b * h * length * d * esize + b * h * d * (
            c["q"].element_size() + 4) + (0 if bits is None
                                          else 2 * b * h * length * 4)
        bms, by = bound_ms(4.0 * b * h * length * d, nbytes,
                           PEAK_INT8_OPS if bits else _peak(dtype))
        ms = graph_ms(call)
        plain_ms = graph_ms(plain, iters=10)
        lib_ms = None if bits else graph_ms(lambda: _sdpa_decode(c))
        label = (f"D{d} {example} B{b} Hkv{h} G1 L{length} "
                 f"{'int8' if bits else str(dtype)[6:]} cache")
        print(f"phase 35 {kname} {label}: max_abs_err {err:.3e} (tol "
              f"{tol}); bitwise repeat {same}; kernel {ms:.4f} ms (graph "
              f"replay), bound {bms:.2e} ms ({by}); plain {plain_ms:.4f} "
              f"ms; sdpa {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}",
              flush=True)
        if not (err <= tol and same):
            raise AssertionError(f"phase 35: {kname} disagrees with its "
                                 f"plain version at {label}")
        rows[kname] = dict(name=label, err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bms, bound_by=by)
    return rows


def small_paged_rows(dev, d):
    """K3 (float, int8, int4 pages) and K3-anc (a random tree over the
    W=4 verify window of ``spec_k=3``) at head dim ``d`` on its example's
    page pool: Hkv = the model's heads, G 1, contexts up to the pool's
    capacity, pages in a scrambled order."""
    example, dtype, (_, _, hkv, _, _), _, (s, p_max, page_len) = \
        SMALL_DIM_SHAPES[d]
    rs = np.random.RandomState(SEED + 80 + d)
    rows = {}
    cap = p_max * page_len
    for bits in (None, 8, 4):
        for w in (1, 4):
            t = np.array([cap - w - 3 * i for i in range(s)], np.int32)
            n_live = [-(-(int(ti) + w) // page_len) for ti in t]
            n_pages = sum(n_live) + 2
            perm = rs.permutation(n_pages)
            table = np.full((s, p_max), n_pages, np.int32)
            used = 0
            for i, n in enumerate(n_live):
                table[i, :n] = perm[used:used + n]
                used += n
            kp, vp = (torch.from_numpy(rs.randn(n_pages, hkv, page_len, d)
                                       .astype(np.float32)).to(dev)
                      for _ in range(2))
            c = dict(q=torch.from_numpy(rs.randn(s, w, hkv, 1, d)
                                        .astype(np.float32)).to(dev),
                     t=torch.from_numpy(t).to(dev),
                     table=torch.from_numpy(table).to(dev), window=None)
            if w > 1:
                c["anc"] = torch.from_numpy(
                    tree_ancestors(random_trees(rs, s, w))[1]).to(dev)
            if bits is None:
                c.update(k=kp.to(dtype), v=vp.to(dtype))
            else:
                (kq, ks), (vq, vs) = (_quantize_kv(x, bits)
                                      for x in (kp, vp))
                if bits == 4:
                    kq, vq = pack_int4(kq), pack_int4(vq)
                c.update(k=kq, v=vq, k_scale=ks, v_scale=vs)
            kname = ("paged_decode" if bits is None
                     else f"paged_decode_q{bits}") + ("_anc" if w > 1
                                                      else "")
            args = (c["q"], c["k"], c["v"], c["t"], c["table"])
            kw = dict(scale=d ** -0.5, window=None, anc=c.get("anc"))
            if bits is not None:
                kw.update(k_scale=c["k_scale"], v_scale=c["v_scale"])
            before = kernels.launch_counts()[kname]
            out = paged_decode_attention(*args, **kw)
            torch.cuda.synchronize()
            if kernels.launch_counts()[kname] != before + 1:
                raise AssertionError(f"phase 35: D{d} did not launch "
                                     f"{kname}")
            err = (out - paged_decode_attention_reference(*args, **kw)) \
                .abs().max().item()
            same = torch.equal(out, paged_decode_attention(*args, **kw))
            tol = KERNEL_BF16_TOL if dtype == torch.bfloat16 and bits is \
                None else KERNEL_Q_TOL
            flops, nbytes, pages = _paged_work(c, t, w, page_len, bits)
            bms, by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
            ms = graph_ms(lambda: paged_decode_attention(*args, **kw))
            plain_ms = time_ms(lambda: paged_decode_attention_reference(
                *args, **kw), iters=5)
            lib_ms = None if bits is not None else _sdpa_paged_ms(c)
            label = (f"D{d} {example} S{s} Hkv{hkv} W{w}"
                     f"{' tree' if w > 1 else ''} page_len {page_len} "
                     f"{str(dtype)[6:] if bits is None else f'int{bits}'} "
                     "pages")
            print(f"phase 35 {kname} {label}: max_abs_err {err:.3e} (tol "
                  f"{tol}); bitwise repeat {same}; kernel {ms:.4f} ms "
                  f"(graph replay), bound {bms:.2e} ms ({by}), {pages} live "
                  f"pages; plain {plain_ms:.4f} ms; sdpa "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}",
                  flush=True)
            if not (err <= tol and same):
                raise AssertionError(f"phase 35: {kname} disagrees with its "
                                     f"plain version at {label}")
            rows[kname] = dict(name=label, err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bms, bound_by=by)
    return rows


def small_dims_phase(dev):
    """Phase 35 (a): every attention kernel at the examples' head dims,
    against its plain version. Returns ``{kernel: [row, ...]}``."""
    rows = {}
    for d in SMALL_DIM_SHAPES:
        for part in (small_flash_rows(dev, d), small_decode_rows(dev, d),
                     small_paged_rows(dev, d)):
            for name, r in part.items():
                rows.setdefault(name, []).append(r)
    return rows


def _fit_steps(rows, batch, epochs):
    return epochs * -(-rows // batch)


#: phase 35 (b)'s examples, at the arguments ``tests/test_examples.py``
#: gives the JAX ones: (module, argv, check on (return value, printed text), the
#: kernels the path must launch: ``{name: exact count}``, a count of None
#: where the schedule decides it, then at least one). Exact counts: two
#: layers a training step of each backward kernel, and two layers a
#: generated token past the first of K2 in each generate() call
EXAMPLES = (
    ("continuous_batching", [],
     lambda r, out: r >= 3 and "token-identical to generate()" in out,
     {"flash_fwd": None, "paged_decode": None, "prng": None,
      "flash_bwd_dq": 2 * _fit_steps(256, 64, 30),
      "flash_bwd_dkv": 2 * _fit_steps(256, 64, 30),
      "decode_attention": 2 * (7 + 4 + 6)}),
    ("lm_generate", [],
     lambda r, out: r > 0.9 and "int8 vs f32" in out,
     {"flash_fwd": None, "flash_bwd_dq": 2 * _fit_steps(4096, 128, 15),
      "flash_bwd_dkv": 2 * _fit_steps(4096, 128, 15),
      "decode_attention": 2 * 2 * 7, "quant_matmul_q8": None}),
    ("speculative_serving", [],
     lambda r, out: r == 5 and "kicked back to plain decode" in out,
     {"flash_fwd": None, "paged_decode": None,
      "flash_bwd_dq": 2 * _fit_steps(256, 64, 30),
      "flash_bwd_dkv": 2 * _fit_steps(256, 64, 30),
      "decode_attention": 2 * (11 + 8 + 13 + 9 + 10 + 19)}),
    ("router_serving", [],
     lambda r, out: r == 11 and "OK" in out
     and "'slow': 'drain'" in out and "'slow': 'resume'" in out,
     {"flash_fwd": None, "paged_decode": None, "prng": None,
      "flash_bwd_dq": 2 * _fit_steps(256, 64, 30),
      "flash_bwd_dkv": 2 * _fit_steps(256, 64, 30),
      "decode_attention": 2 * (6 * 4 + 6 + 4 + 3 * 7)}),
    ("loadgen_scenario", [],
     lambda r, out: r["headline"]["min_attainment"] < 1.0
     and "trace JSONL round-trip OK" in out,
     {"flash_fwd": None, "paged_decode": None, "flash_bwd_dq": 0}),
    ("request_tracing", [],
     lambda r, out: r >= 5 and "flight recorder ring" in out,
     {"flash_fwd": None, "paged_decode": None, "flash_bwd_dq": 0}),
    ("moe_serving", [],
     lambda r, out: r == 4 and "OK" in out
     and "expert-parallel decode skipped (single-device backend)" in out,
     {"flash_fwd": None, "paged_decode": None, "moe_gather_gemm1": None,
      "flash_bwd_dq": 2 * _fit_steps(256, 64, 20),
      "flash_bwd_dkv": 2 * _fit_steps(256, 64, 20),
      "decode_attention": 2 * (7 + 5 + 8 + 6)}),
    ("packed_moe_serving", [],
     lambda r, out: "logit leak after perturbing doc A: 0.0" in out
     and "OK" in out,
     {"flash_fwd": None, "flash_bwd_dq": 2 * 150, "flash_bwd_dkv": 2 * 150,
      "decode_attention": 2 * 2 * 7, "quant_matmul_q8": None}),
    ("telemetry_tour", [],
     lambda r, out: r > 0.7 and "JSONL round-trip OK" in out,
     {"flash_fwd": None, "paged_decode": None,
      "flash_bwd_dq": 2 * _fit_steps(128, 64, 3),
      "flash_bwd_dkv": 2 * _fit_steps(128, 64, 3)}),
    ("vit_finetune_callbacks", [],
     lambda r, out: r > 0.85 and "epochs logged" in out,
     {"flash_fwd": None, "flash_bwd_dq": None, "flash_bwd_dkv": None}),
)
#: ViT trains 64 steps an epoch (4096 images, batch 64) until early
#: stopping: its backward counts are two layers times a multiple of that
VIT_EPOCH_STEPS = 64


def ported_examples_phase(dev, card):
    """Phase 35 (b): the ten examples in this process on ``dev``, each at
    its JAX test's arguments and above its threshold, with the launch
    counts of each run. Returns ``{"example_<name>": counts}``."""
    import importlib
    import io
    launches, walls = {}, []
    for name, argv, ok, want in EXAMPLES:
        mod = importlib.import_module(f"distkeras_tpu_torch.examples.{name}")
        saved = sys.argv
        sys.argv = [name, *argv, "--device", dev.type]
        buf = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                result = mod.main()
            torch.cuda.synchronize()
        finally:
            sys.argv = saved
        wall = time.perf_counter() - t0
        c = {k: n for k, n in kernels.launch_counts().items() if n}
        out = buf.getvalue()
        last = out.strip().splitlines()[-1]
        walls.append(f"{name} {wall:.1f} s")
        print(f"phase 35 (b) {name} on {card}: {wall:.1f} s; {last}; "
              f"launches {c}", flush=True)
        if not ok(result, out):
            raise AssertionError(f"phase 35 (b): {name} returned {result}:"
                                 f"\n{out}")
        for kname, n in want.items():
            got = c.get(kname, 0)
            if (n is None and got < 1) or (n is not None and got != n):
                raise AssertionError(
                    f"phase 35 (b): {name} launched {kname} {got} times; "
                    f"expected {'at least 1' if n is None else n}")
        if name == "vit_finetune_callbacks":
            steps = c["flash_bwd_dq"] // 2
            if c["flash_bwd_dq"] != c["flash_bwd_dkv"] or \
                    steps % VIT_EPOCH_STEPS or \
                    not 1 <= steps // VIT_EPOCH_STEPS <= 12:
                raise AssertionError(f"phase 35 (b): the ViT's backward "
                                     f"launches {c} are no whole number "
                                     f"of 2-layer epochs")
        launches["example_" + name] = c
        gc.collect()
    print(f"phase 35 (b) examples on {card}: " + ", ".join(walls),
          flush=True)
    return launches


def examples_and_small_dims_phase(dev, card):
    """Phase 35: (a) the attention kernels at head dims 8, 12 and 16,
    (b) the ten one-card examples."""
    t0 = time.perf_counter()
    rows = small_dims_phase(dev)
    gc.collect()
    t1 = time.perf_counter()
    launches = ported_examples_phase(dev, card)
    t2 = time.perf_counter()
    print(f"phase 35 took {t2 - t0:.1f} s: (a) {t1 - t0:.1f}, (b) "
          f"{t2 - t1:.1f}", flush=True)
    return rows, launches


# --- phase 36: sequence parallelism over a world of processes --------------

#: phase 36's world: four processes share the card (gloo, staged through
#: pinned host memory); the LM's widths at a global sequence of 8192
SP_RANKS = 4
SP_SEQ = 8192
#: lengths of the packed row's documents: they straddle the shard edges
SP_DOC_LEN = (300, 3000)
#: (c): adam steps a sequence-parallel LM takes, and its learning rate
SP_LM_STEPS = 3
SP_LM_LR = 1e-3
#: ring/Ulysses outputs and gradients against single-process flash
#: attention on the whole sequence, relative to each output's max: bf16
#: roundings of each hop's output and gradients before the float32 sums
SP_REL_TOL = 2e-2
#: (c): the first step's loss and each gradient leaf (norm-relative)
#: against a single-process run of the same weights
SP_LM_REL_TOL = 5e-2
#: (b)'s cases: (path, kind, causal, packed ids)
SP_CASES = (("ring_causal", "ring", True, False),
            ("ring_full", "ring", False, False),
            ("ring_causal_packed", "ring", True, True),
            ("ring_full_packed", "ring", False, True),
            ("ulysses_flash", "flash", True, True),
            ("ulysses_xla", "xla", True, True))


def sp_ids(total=None, seed=SEED + 36):
    """One packed row ``[1, total]`` (default ``SP_SEQ``) of sorted
    document ids."""
    total = SP_SEQ if total is None else total
    rs = np.random.RandomState(seed)
    lens = []
    while sum(lens) < total:
        lens.append(rs.randint(*SP_DOC_LEN))
    return np.repeat(np.arange(len(lens)), lens)[None, :total] \
        .astype(np.int32)


def _pairs(qseg, kseg, causal) -> int:
    """Admitted (query, key) pairs of one hop."""
    qs, ks = qseg[0], kseg[0]
    same = qs[:, None] == ks[None, :]
    if causal:
        same &= np.tri(len(qs), len(ks), dtype=bool)
    return int(same.sum())


def _rel(a, r) -> float:
    return float((a.detach().float() - r.detach().float()).abs().max()
                 / r.detach().float().abs().max())


def ring_hop_phase(dev):
    """Phase 36 (a): K1f, K1dq and K1dkv at a ring hop's shape (B1 H16
    S2048 D64 bf16) with q-side ids of shard 1 and the k-side ids of the
    shard the hop holds: shard 0 (full) and shard 1 again through its
    own pointer (causal). The two hops merge as the ring merges them and
    the backward takes the merged lse, as the ring's does. Against the
    plain versions: out on the rows the hop admits a key for (an empty
    row's lse at NEG_INF on both), lse, and dq/dk/dv relative."""
    h = LM_CFG["num_heads"]
    d = LM_CFG["d_model"] // h
    sl = SP_SEQ // SP_RANKS
    g = torch.Generator(device="cpu").manual_seed(SEED + 36)

    def rnd():
        return torch.randn(1, sl, h, d, generator=g).to(dev, torch.bfloat16)

    q, dout = rnd(), rnd()
    k, v = {0: rnd(), 1: rnd()}, {0: rnd(), 1: rnd()}
    ids = sp_ids()
    qseg = torch.from_numpy(ids[:, sl:2 * sl].copy()).to(dev)
    kseg = {0: torch.from_numpy(ids[:, :sl].copy()).to(dev),
            1: qseg.clone()}
    scale = d ** -0.5
    hops = (("causal", 1, True), ("full", 0, False))
    fwd, acc, lse = {}, None, None
    for name, j, causal in hops:
        kw = dict(scale=scale, causal=causal, segment_ids=qseg,
                  kv_segment_ids=kseg[j])
        o, l = flash_forward(q, k[j], v[j], **kw)
        fwd[name] = (o, l) + flash_forward_reference(q, k[j], v[j], **kw)
        acc, lse = ring_merge(acc, lse, o, l)
    out = acc.to(torch.bfloat16)
    delta = attention_delta(out, dout)
    rows = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    for name, j, causal in hops:
        o, l, ro, rl = fwd[name]
        kw = dict(scale=scale, causal=causal, segment_ids=qseg,
                  kv_segment_ids=kseg[j])
        live = rl > EMPTY_LSE
        if not torch.equal(live, l > EMPTY_LSE):
            raise AssertionError(f"phase 36 (a) {name}: the kernel's empty "
                                 "rows differ from the plain version's")
        mask = live.transpose(1, 2)[..., None]
        err_out = float(((o.float() - ro.float()).abs() * mask).max())
        err_lse = float((l - rl)[live].abs().max())
        args = (q, k[j], v[j], lse, dout, delta, scale, causal, None,
                "bshd")
        ids_kw = dict(segment_ids=qseg, kv_segment_ids=kseg[j])
        got = launch_dq(*args, **ids_kw) + launch_dkv(*args, **ids_kw)
        ref = flash_backward_reference(q, k[j], v[j], out, lse, dout, delta,
                                       **kw)
        rel = {gname: _rel(a, r) for gname, a, r in
               zip(("dq", "dk", "dv"), got, ref)}
        errs = {gname: float((a.float() - r.float()).abs().max())
                for gname, a, r in zip(("dq", "dk", "dv"), got, ref)}
        ok = (err_out <= KERNEL_BF16_TOL and err_lse <= LSE_TOL
              and max(rel.values()) <= BWD_BF16_REL_TOL)
        ms = {"fwd": graph_ms(lambda: flash_forward(q, k[j], v[j], **kw)),
              "dq": time_ms(lambda: launch_dq(*args, **ids_kw), iters=10),
              "dkv": time_ms(lambda: launch_dkv(*args, **ids_kw),
                             iters=10)}
        plain_fwd = time_ms(lambda: flash_forward_reference(
            q, k[j], v[j], **kw), iters=3, warmup=1)
        plain_bwd = time_ms(lambda: flash_backward_reference(
            q, k[j], v[j], out, lse, dout, delta, **kw), iters=3, warmup=1)
        sdpa_f, sdpa_fb = _sdpa_hop_ms(q, k[j], v[j], dout, qseg, kseg[j],
                                       causal)
        pairs = _pairs(qseg.cpu().numpy(), kseg[j].cpu().numpy(), causal)
        work = h * pairs * d
        esz = q.element_size()
        qbytes = esz * q.numel()
        rowbytes, segbytes = 4 * l.numel(), 4 * (qseg.numel() + sl)
        fwd_bound = bound_ms(4.0 * work, 4 * qbytes + rowbytes + segbytes,
                             PEAK_BF16_FLOPS)
        in_bytes = 4 * qbytes + 2 * rowbytes + segbytes
        dq_bound = bound_ms(6.0 * work, in_bytes + qbytes, PEAK_BF16_FLOPS)
        dkv_bound = bound_ms(8.0 * work, in_bytes + 2 * qbytes,
                             PEAK_BF16_FLOPS)
        print(f"phase 36 (a) ring hop {name} B1 H{h} S{sl} D{d} bf16, "
              f"q-side ids of shard 1, k-side of shard {j} (rows with no "
              f"key here: {int((~live).sum())} of {live.numel()}): max abs "
              f"err out {err_out:.3e} (tol {KERNEL_BF16_TOL}), lse "
              f"{err_lse:.3e} (tol {LSE_TOL}); dq/dk/dv relative "
              f"{rel['dq']:.3e} {rel['dk']:.3e} {rel['dv']:.3e} (tol "
              f"{BWD_BF16_REL_TOL}); kernel ms fwd {ms['fwd']:.4f}, dq "
              f"{ms['dq']:.4f}, dk/dv {ms['dkv']:.4f}; bounds (admitted "
              f"pairs {pairs}) fwd {fwd_bound[0]:.4f} ({fwd_bound[1]}), dq "
              f"{dq_bound[0]:.4f}, dk/dv {dkv_bound[0]:.4f}; plain fwd "
              f"{plain_fwd:.4f} ms, backward {plain_bwd:.4f} ms; masked sdpa "
              f"fwd {sdpa_f:.4f} ms, fwd+bwd {sdpa_fb:.4f} ms", flush=True)
        if not ok:
            raise AssertionError(f"phase 36 (a): the flash kernels disagree "
                                 f"with their plain versions on the {name} "
                                 "ring hop")
        for kname, err, kms, bnd, plain_ms, lib in (
                ("flash_fwd", err_out, ms["fwd"], fwd_bound, plain_fwd,
                 sdpa_f),
                ("flash_bwd_dq", errs["dq"], ms["dq"], dq_bound, plain_bwd,
                 sdpa_fb - sdpa_f),
                ("flash_bwd_dkv", max(errs["dk"], errs["dv"]), ms["dkv"],
                 dkv_bound, plain_bwd, sdpa_fb - sdpa_f)):
            rows[kname].append(dict(name=f"ring hop {name}", err=err,
                                    ms=kms, plain_ms=plain_ms,
                                    library_ms=lib, bound_ms=bnd[0],
                                    bound_by=bnd[1]))
    return rows


def _sdpa_hop_ms(q, k, v, dout, qseg, kseg, causal):
    """``scaled_dot_product_attention`` with the hop's boolean mask,
    forward and forward+backward: a yardstick only."""
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                  for x in (q, k, v))
    mask = (qseg[:, :, None] == kseg[:, None, :])[:, None]
    if causal:
        i = torch.arange(q.shape[1], device=q.device)
        mask = mask & (i[None, :] <= i[:, None])
    dt = dout.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dt)

    with torch.no_grad():
        f_ms = time_ms(fwd)
    return f_ms, time_ms(fwd_bwd)


_SP_MESH = {}


def _sp_mesh(device):
    """This rank's ``sp`` mesh (made once a process: its groups are made
    collectively)."""
    if device not in _SP_MESH:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
        _SP_MESH[device] = make_mesh(SP_RANKS, "sp", device=device)
    return _SP_MESH[device]


def _sp_attention(kind, q, k, v, seg, causal):
    if kind == "ring":
        return ring_attention(q, k, v, axis_name="sp", causal=causal,
                              segment_ids=seg)
    return ulysses_attention(q, k, v, axis_name="sp", causal=causal,
                             impl=kind, segment_ids=seg)


def _wall_ms(fn, n=2) -> float:
    """Mean wall ms of ``fn`` between card syncs (the other ranks run at
    the same time on the same card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _ring_hop_ms(fn, n=2) -> list:
    """Wall ms of each hop of the ring forward ``fn()``, mean of ``n``
    calls: a card sync and a clock reading where ``ops.ring_attention``
    posts each hop's shift (``_shift``, called once a hop) and after the
    call, so hop ``t`` spans its shift's posting, its ``flash_forward``
    if it launches one, its merge and the wait for the next shard. The
    staged shift syncs the card there anyway."""
    marks, orig = [], ring_module._shift

    def marked(*args):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return orig(*args)

    per = []
    ring_module._shift = marked
    try:
        for _ in range(n):
            marks.clear()
            fn()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            per.append(np.diff(marks) * 1e3)
    finally:
        ring_module._shift = orig
    return np.mean(per, axis=0).tolist()


def sp_attention_rank(ids_np, device):
    """Phase 36 (b), one rank: each ``SP_CASES`` case forward and
    backward over this rank's shard of the whole-sequence q/k/v (drawn
    from one seed on every rank), the launch counts of the call, the
    gathered output and gradients, then the forward's call ms and, for
    the ring, each hop's ms, K1f ms at the hop's shape and a staged
    shift's ms. Rank 0 holds every case
    against single-process ``flash_attention`` on the whole sequence."""
    dev = torch.device(device)
    mesh = _sp_mesh(device)
    i, n = mesh.axis_index("sp"), SP_RANKS
    h = LM_CFG["num_heads"]
    d = LM_CFG["d_model"] // h
    sl = SP_SEQ // n
    g = torch.Generator(device=dev).manual_seed(SEED + 360)
    q, k, v, dout = (torch.randn(1, SP_SEQ, h, d, generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    ids = torch.from_numpy(ids_np).to(dev)
    blk = slice(i * sl, (i + 1) * sl)
    out = {"rank": i, "launches": {}, "ms": {}, "rel": {}}
    with mesh:
        for path, kind, causal, packed in SP_CASES:
            seg = ids[:, blk].contiguous() if packed else None
            ql, kl, vl = (x[:, blk].clone().requires_grad_()
                          for x in (q, k, v))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            y = _sp_attention(kind, ql, kl, vl, seg, causal)
            y.backward(dout[:, blk])
            torch.cuda.synchronize()
            c = kernels.launch_counts()
            out["launches"][path] = {name: c[name]
                                     for name in TRAINING_KERNELS}
            got = [collectives.all_gather(t.detach(), "sp", axis=1,
                                          tiled=True)
                   for t in (y, ql.grad, kl.grad, vl.grad)]
            fwd = functools.partial(_sp_attention, kind, ql, kl, vl, seg,
                                    causal)
            with torch.no_grad():
                ms = {"call": _wall_ms(fwd)}
                if kind == "ring":
                    ms["hops"] = _ring_hop_ms(fwd)
                    ms["k1f"] = time_ms(lambda: flash_forward(
                        ql, kl, vl, scale=d ** -0.5, causal=False,
                        segment_ids=seg, kv_segment_ids=seg), iters=10)
                    parts = [kl.detach(), vl.detach()] + \
                        ([] if seg is None else [seg])
                    ms["staging"] = _wall_ms(
                        lambda: collectives.shift_start(parts, "sp").wait(),
                        n=3)
            out["ms"][path] = ms
            if i == 0:
                qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
                ref = flash_attention(qr, kr, vr, causal=causal,
                                      segment_ids=ids if packed else None)
                ref.backward(dout)
                out["rel"][path] = [_rel(a, r) for a, r in
                                    zip(got, (ref, qr.grad, kr.grad,
                                              vr.grad))]
                del qr, kr, vr, ref
            del got, y, ql, kl, vl
    return out


def _sp_loss_step(model, x, y, scale):
    """This rank's share of the global mean loss and its gradients,
    summed over ``sp`` (the global loss's gradients on every rank)."""
    params = model.params
    model.module.train()
    logits = model.module.apply(params, x)
    loss = get_loss(TRAIN_LOSS)(y, logits) * scale
    grads = torch.autograd.grad(loss, tree_leaves(params))
    model.module.eval()
    return (collectives.psum(loss.detach(), "sp"),
            collectives.psum(list(grads), "sp"))


def sp_lm_rank(impl, toks_np, device, steps=None):
    """Phase 36 (c), one rank: the full-width LM with ``attn_impl=impl``
    over ``sp``, B1 over the ``SP_SEQ`` tokens (this rank's block),
    ``steps`` adam steps on the global mean loss with gradients summed
    over ``sp``; launch counts, losses and step ms. Rank 0 first runs
    the dense twin (the same seed's weights, bitwise) on the whole
    sequence and holds the first step's loss and gradients to it."""
    dev = torch.device(device)
    steps = SP_LM_STEPS if steps is None else steps
    mesh = _sp_mesh(device)
    i, n = mesh.axis_index("sp"), SP_RANKS
    sl = SP_SEQ // n
    toks = torch.from_numpy(toks_np).to(dev)
    x, y = toks[:, :-1], toks[:, 1:]
    model = build_lm(dev, attn_impl=impl, seq_axis_name="sp")
    res = {"rank": i}
    twin = None
    if i == 0:
        dense = build_lm(dev)
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(dense.params), tree_leaves(model.params)))
        dense.module.train()
        logits = dense.module.apply(dense.params, x)
        loss = get_loss(TRAIN_LOSS)(y, logits)
        grads = torch.autograd.grad(loss, tree_leaves(dense.params))
        twin = (float(loss), grads, same)
        del dense, logits, loss
        gc.collect()
    opt = get_optimizer("adam", learning_rate=SP_LM_LR)
    state = opt.init(model.params)
    xl, yl = x[:, i * sl:(i + 1) * sl], y[:, i * sl:(i + 1) * sl]
    with mesh:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        losses, first, walls = [], None, []
        for step in range(steps):
            t0 = time.perf_counter()
            loss, grads = _sp_loss_step(model, xl, yl, sl / SP_SEQ)
            with torch.no_grad():
                upd, state = opt.update(tree_unflatten(model.params, grads),
                                        state, model.params)
                apply_updates(model.params, upd)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if step == 0:
                first = grads
        c = kernels.launch_counts()
    res["launches"] = {name: c[name] for name in TRAINING_KERNELS}
    res["losses"], res["step_ms"] = losses, walls
    if twin is not None:
        ref_loss, ref_grads, same = twin
        res["same_weights"] = same
        res["loss_rel"] = abs(losses[0] - ref_loss) / abs(ref_loss)
        res["grad_rel"] = max(
            float((a.float() - r.float()).norm() / r.float().norm())
            for a, r in zip(first, ref_grads))
    return res


def _check_sp_counts(path, counts, per_rank):
    """Each rank's exact launches of the three flash kernels."""
    for r, c in enumerate(counts):
        want = per_rank(r)
        if c != {name: want for name in TRAINING_KERNELS}:
            raise AssertionError(f"phase 36 {path}: rank {r} launched {c}; "
                                 f"expected {want} of each flash kernel")


def seq_parallel_phase(dev, card):
    """Phase 36: (a) the ring hop's kernels in this process; (b) ring
    and Ulysses attention in a world of four processes on the card
    against single-process flash attention; (c) the full-width LM with
    ring and with Ulysses-flash attention in the same world against a
    single-process run; then the ``long_context_serving`` example.
    Returns the (a) rows and ``{path: summed launches}``."""
    t0 = time.perf_counter()
    rows = ring_hop_phase(dev)
    gc.collect()
    t1 = time.perf_counter()
    launches = {}
    n, layers = SP_RANKS, LM_CFG["num_layers"]
    with World(SP_RANKS, threads=2, timeout=600) as world:
        t2 = time.perf_counter()
        results = world.run(sp_attention_rank, sp_ids(), dev.type)
        t3 = time.perf_counter()
        for path, kind, causal, packed in SP_CASES:
            counts = [r["launches"][path] for r in results]
            if kind == "ring":
                _check_sp_counts(path, counts,
                                 (lambda r: r + 1) if causal
                                 else (lambda r: n))
            else:
                _check_sp_counts(path, counts,
                                 lambda r: 1 if kind == "flash" else 0)
            rel = results[0]["rel"][path]
            ms = "; ".join(
                f"rank {r['rank']} call {r['ms'][path]['call']:.2f}"
                + (" hops "
                   + "/".join(f"{x:.2f}" for x in r["ms"][path]["hops"])
                   + f" K1f "
                   f"{r['ms'][path]['k1f']:.4f} staging "
                   f"{r['ms'][path]['staging']:.2f}"
                   if kind == "ring" else "") for r in results)
            print(f"phase 36 (b) {path} on {card}: B1 H{LM_CFG['num_heads']}"
                  f" S{SP_SEQ} D{LM_CFG['d_model'] // LM_CFG['num_heads']} "
                  f"bf16 over {n} ranks; launches by rank "
                  f"{[c['flash_fwd'] for c in counts]} (each flash kernel); "
                  f"out/dq/dk/dv relative to single-process flash "
                  f"{', '.join(f'{e:.3e}' for e in rel)} (tol "
                  f"{SP_REL_TOL}); ms: {ms}", flush=True)
            if max(rel) > SP_REL_TOL:
                raise AssertionError(f"phase 36 (b) {path}: the gathered "
                                     "output or gradients disagree with "
                                     "single-process flash attention")
            summed = {name: sum(c[name] for c in counts)
                      for name in TRAINING_KERNELS}
            if any(summed.values()):
                launches[path] = summed
        gc.collect()
        t4 = time.perf_counter()
        rs = np.random.RandomState(SEED + 37)
        pats = rs.randint(0, LM_CFG["vocab"], (1, 64))
        toks = np.tile(pats, (1, SP_SEQ // 64 + 1))[:, :SP_SEQ + 1]
        for impl, path in (("ring", "lm_ring"),
                           ("ulysses_flash", "lm_ulysses_flash")):
            t5 = time.perf_counter()
            res = world.run(sp_lm_rank, impl, toks, dev.type)
            counts = [r["launches"] for r in res]
            per = (lambda r: layers * (r + 1) * SP_LM_STEPS) \
                if impl == "ring" else (lambda r: layers * SP_LM_STEPS)
            _check_sp_counts(path, counts, per)
            head = res[0]
            losses = head["losses"]
            print(f"phase 36 (c) {path} on {card}: transformer_lm "
                  f"{LM_CFG} bf16 attn_impl={impl!r} over {n} ranks, B1 x "
                  f"{SP_SEQ} tokens; losses {np.round(losses, 4).tolist()}; "
                  f"first step vs single process: loss rel "
                  f"{head['loss_rel']:.3e}, gradient leaves norm-relative "
                  f"max {head['grad_rel']:.3e} (tol {SP_LM_REL_TOL}; weights "
                  f"bitwise the dense twin's: {head['same_weights']}); step "
                  f"ms by rank "
                  f"{[np.round(r['step_ms'], 1).tolist() for r in res]}; "
                  f"launches by rank {[c['flash_fwd'] for c in counts]} "
                  f"(each flash kernel); {time.perf_counter() - t5:.1f} s",
                  flush=True)
            if not (head["same_weights"] and np.isfinite(losses).all()
                    and head["loss_rel"] <= SP_LM_REL_TOL
                    and head["grad_rel"] <= SP_LM_REL_TOL
                    and losses[-1] < losses[0]):
                raise AssertionError(f"phase 36 (c) {path}: the first step "
                                     "disagrees with the single-process run "
                                     "or the loss did not fall")
            launches[path] = {name: sum(c[name] for c in counts)
                              for name in TRAINING_KERNELS}
    t6 = time.perf_counter()
    example = sp_example_phase(dev, card)
    launches["example_long_context_serving"] = example
    t7 = time.perf_counter()
    print(f"phase 36 took {t7 - t0:.1f} s: (a) {t1 - t0:.1f}, world start "
          f"{t2 - t1:.1f}, (b) {t3 - t2:.1f}, (c) {t6 - t4:.1f}, example "
          f"{t7 - t6:.1f}", flush=True)
    return rows, launches


def sp_example_phase(dev, card):
    """The ``long_context_serving`` example on ``dev``: its own checks,
    the launches of its one-process parts (the ring part runs in its own
    world)."""
    import io
    from distkeras_tpu_torch.examples import long_context_serving
    saved = sys.argv
    sys.argv = ["long_context_serving", "--device", dev.type]
    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            err = long_context_serving.main()
        torch.cuda.synchronize()
    finally:
        sys.argv = saved
    c = {k: n for k, n in kernels.launch_counts().items() if n}
    out = buf.getvalue()
    print(f"phase 36 long_context_serving on {card}: "
          f"{time.perf_counter() - t0:.1f} s; "
          + "; ".join(out.strip().splitlines()) + f"; launches {c}",
          flush=True)
    if not ("OK" in out and err < 1e-4 and c.get("flash_fwd", 0) >= 1
            and c.get("decode_attention", 0) >= 1):
        raise AssertionError(f"phase 36: long_context_serving: {out}")
    return c


# --- phase 37: SPMD training over a world of processes ---------------------

#: phase 37's world: four processes share the card (gloo, staged through
#: pinned host memory)
SPMD_RANKS = 4
#: (a)'s mesh: two data ranks, each with two tensor-parallel ranks (8 of
#: the LM's 16 heads, 2048 of its 4096 hidden units a rank); (b)'s: four
#: data ranks with every large leaf split over them (FSDP)
SPMD_MESH = {"workers": 2, "tp": 2}
SPMD_FSDP_MESH = {"workers": 4}
#: the LM's data: rows of phase 7's patterns at this length, the global
#: batch, and the epochs of (a): 2 steps an epoch, no shuffling
SPMD_ROWS, SPMD_SEQ, SPMD_BATCH, SPMD_EPOCHS = 16, 512, 8, 2
SPMD_LR = 1e-3
#: the SPMD runs' per-step losses and final parameters (each leaf
#: norm-relative) against a one-process SingleTrainer run of the same
#: weights and data order: bf16 activations, the tensor-parallel partial
#: sums added in float32 against one bf16 matmul, adam's steps over them
SPMD_REL_TOL = 5e-2


def _spmd_data():
    return training_data(LM_CFG["vocab"], rows=SPMD_ROWS, seq=SPMD_SEQ)


def _spmd_trainer(model, mesh, epochs, **kw):
    from distkeras_tpu_torch.parallel import SPMDTrainer
    return SPMDTrainer(model, mesh=mesh, worker_optimizer="adam",
                       learning_rate=SPMD_LR, loss=TRAIN_LOSS,
                       batch_size=SPMD_BATCH, num_epoch=epochs,
                       shuffle_each_epoch=False, **kw)


def _timed_run_epoch(step_ms):
    """``parallel.worker.run_epoch`` with a card sync and a clock reading
    around each step (the step's wall ms into ``step_ms``)."""
    from distkeras_tpu_torch.parallel.worker import run_epoch

    def timed(train_step, carry, Xs, Ys):
        def step(c, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(c, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run_epoch(step, carry, Xs, Ys)

    return timed


_SPMD_MESH = {}
#: rank 0's one-process run of the same weights and data (made once)
_SPMD_SINGLE = {}


def _spmd_mesh(shape):
    key = tuple(shape.items())
    if key not in _SPMD_MESH:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        _SPMD_MESH[key] = make_mesh_2d(dict(shape), device="cuda")
    return _SPMD_MESH[key]


def _norm_rel(a, r) -> float:
    a, r = a.detach().float(), r.detach().float()
    return float((a - r).norm() / r.norm().clamp_min(1e-30))


def spmd_lm_rank(tmp, shape, kw, runs):
    """Phase 37 (a)/(b), one rank: the full-width LM under
    ``SPMDTrainer`` over ``shape``: ``runs`` holds "whole" (``SPMD_EPOCHS``
    epochs, the launch counts and each step's ms), and for (a) "resume"
    (one epoch with a sharded save, then a fresh trainer resuming to
    ``SPMD_EPOCHS``: the final weights against the whole run's bitwise).
    Rank 0 then trains the same weights on the same order in one process
    (``SingleTrainer``) and holds the losses and weights to it. Also the
    staged all-reduce of this rank's gradient blocks over the data axis
    (the bytes each step moves there)."""
    import distkeras_tpu_torch.parallel.spmd as spmd_module
    mesh = _spmd_mesh(shape)
    rank = torch.distributed.get_rank()
    data = _spmd_data()
    out = {"rank": rank}
    step_ms = []
    orig = spmd_module.run_epoch
    spmd_module.run_epoch = _timed_run_epoch(step_ms)
    try:
        model = build_lm("cuda")
        init = [t.detach().clone() for t in tree_leaves(model.params)]
        trainer = _spmd_trainer(model, mesh, SPMD_EPOCHS, **kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        trainer.train(data)
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        out["launches"] = {k: n for k, n in c.items() if n}
        out["losses"] = trainer.get_history().losses().tolist()
        out["step_ms"] = list(step_ms)
        local = [t.detach() for t in tree_leaves(trainer.carry.params)]
        with mesh:
            out["staging_ms"] = _wall_ms(
                lambda: collectives.psum(local, "workers"), n=2)
        out["local_bytes"] = sum(t.numel() * t.element_size()
                                 for t in local)
        whole = [t.detach().clone() for t in tree_leaves(model.params)]
        del trainer, local
        gc.collect()
        if "resume" in runs:
            cdir = os.path.join(tmp, "spmd")
            part = _spmd_trainer(build_lm("cuda"), mesh, 1,
                                 checkpoint_dir=cdir, **kw)
            part.train(data)
            del part
            gc.collect()
            resumed = _spmd_trainer(build_lm("cuda"), mesh, SPMD_EPOCHS,
                                    checkpoint_dir=cdir, resume=True, **kw)
            resumed.train(data)
            out["resume_epochs"] = len(resumed.get_history().epochs)
            out["resume_parted"] = sum(
                not torch.equal(a, b) for a, b in
                zip(whole, tree_leaves(resumed.master_model.params)))
            out["files"] = sorted(os.listdir(os.path.join(cdir, "step_0")))
            del resumed
            gc.collect()
    finally:
        spmd_module.run_epoch = orig
    if rank == 0:
        if not _SPMD_SINGLE:
            single = SingleTrainer(build_lm("cuda"), worker_optimizer="adam",
                                   learning_rate=SPMD_LR, loss=TRAIN_LOSS,
                                   batch_size=SPMD_BATCH,
                                   num_epoch=SPMD_EPOCHS,
                                   shuffle_each_epoch=False)
            single.train(data)
            _SPMD_SINGLE.update(
                losses=single.get_history().losses(),
                params=[t.detach().clone() for t in
                        tree_leaves(single.master_model.params)])
            del single
        ref, final = _SPMD_SINGLE["losses"], _SPMD_SINGLE["params"]
        out["loss_rel"] = float(np.max(np.abs(
            np.asarray(out["losses"]) - ref) / np.abs(ref)))
        out["param_rel"] = max(_norm_rel(a, r) for a, r in zip(whole, final))
        out["update_rel"] = max(_norm_rel(a - i, r - i)
                                for a, r, i in zip(whole, final, init))
    del model, whole, init
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _check_spmd_counts(path, counts, per_rank):
    for r, c in enumerate(counts):
        got = {name: c.get(name, 0) for name in TRAINING_KERNELS}
        if got != {name: per_rank for name in TRAINING_KERNELS}:
            raise AssertionError(f"phase 37 {path}: rank {r} launched {got};"
                                 f" expected {per_rank} of each flash "
                                 "kernel")
        if c.get("prng", 0) < 1:
            raise AssertionError(f"phase 37 {path}: rank {r} never launched"
                                 " K7 for the carry's split")


def _spmd_print(path, card, res, steps):
    head = res[0]
    ms = "; ".join(
        f"rank {r['rank']} steps {np.round(r['step_ms'], 1).tolist()} ms, "
        f"gradient all-reduce staged {r['staging_ms']:.1f} ms for "
        f"{r['local_bytes'] / 2 ** 20:.0f} MiB" for r in res)
    print(f"phase 37 {path} on {card}: transformer_lm {LM_CFG} bf16 adam "
          f"under SPMDTrainer over {SPMD_RANKS} ranks, B{SPMD_BATCH} x "
          f"{SPMD_SEQ} tokens, {steps} steps; losses "
          f"{np.round(head['losses'], 4).tolist()}; against one process: "
          f"losses rel max {head['loss_rel']:.3e}, final weights "
          f"norm-relative max {head['param_rel']:.3e} (their change from "
          f"the start: {head['update_rel']:.3e}) (tol {SPMD_REL_TOL}); "
          f"launches by rank "
          f"{[r['launches'] for r in res]}; {ms}", flush=True)


def spmd_phase(dev, card):
    """Phase 37: (a) the full-width LM under ``SPMDTrainer`` in a world
    of four processes on the card over ``SPMD_MESH`` (Megatron tensor
    parallelism inside each pair, data parallelism across the pairs),
    against one process, with a sharded save after epoch 0 and a resume
    bitwise the uninterrupted run; (b) the same LM over
    ``SPMD_FSDP_MESH`` with FSDP; (c) the two SPMD examples. Returns
    ``{path: summed launches}``."""
    t0 = time.perf_counter()
    launches = {}
    layers = LM_CFG["num_layers"]
    steps = SPMD_EPOCHS * SPMD_ROWS // SPMD_BATCH
    tmp = tempfile.mkdtemp(prefix="dkt-phase37-")
    try:
        with World(SPMD_RANKS, threads=2, timeout=600) as world:
            t1 = time.perf_counter()
            res = world.run(spmd_lm_rank, tmp, SPMD_MESH,
                            dict(tp_axis="tp"), ("whole", "resume"))
            _check_spmd_counts("(a)", [r["launches"] for r in res],
                               layers * steps)
            _spmd_print("(a) dp x tp", card, res, steps)
            head = res[0]
            print(f"phase 37 (a) resume on {card}: a sharded save after "
                  f"epoch 0 ({head['files']}), a fresh trainer resumed "
                  f"for {head['resume_epochs']} epoch(s): "
                  f"{[r['resume_parted'] for r in res]} weight tensors "
                  "differ from the uninterrupted run's by rank", flush=True)
            if not (head["loss_rel"] <= SPMD_REL_TOL
                    and head["param_rel"] <= SPMD_REL_TOL
                    and np.isfinite(head["losses"]).all()
                    and all(r["resume_parted"] == 0 for r in res)
                    and head["resume_epochs"] == 1
                    and all(r["losses"] == head["losses"] for r in res)):
                raise AssertionError("phase 37 (a): the SPMD run disagrees "
                                     "with one process, or the resume is "
                                     "not bitwise")
            launches["spmd_dp_tp"] = {
                k: sum(r["launches"].get(k, 0) for r in res)
                for k in TRAINING_KERNELS + ("prng",)}
            t2 = time.perf_counter()
            res = world.run(spmd_lm_rank, tmp, SPMD_FSDP_MESH,
                            dict(tp_axis=None, fsdp_axis="workers"),
                            ("whole",))
            _check_spmd_counts("(b)", [r["launches"] for r in res],
                               layers * steps)
            _spmd_print("(b) FSDP", card, res, steps)
            head = res[0]
            if not (head["loss_rel"] <= SPMD_REL_TOL
                    and head["param_rel"] <= SPMD_REL_TOL):
                raise AssertionError("phase 37 (b): the FSDP run disagrees "
                                     "with one process")
            launches["spmd_fsdp"] = {
                k: sum(r["launches"].get(k, 0) for r in res)
                for k in TRAINING_KERNELS + ("prng",)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t3 = time.perf_counter()
    launches.update(spmd_examples_phase(card))
    t4 = time.perf_counter()
    print(f"phase 37 took {t4 - t0:.1f} s: world start {t1 - t0:.1f}, (a) "
          f"{t2 - t1:.1f}, (b) {t3 - t2:.1f}, (c) {t4 - t3:.1f}", flush=True)
    return launches


def spmd_examples_phase(card):
    """Phase 37 (c): ``large_model_spmd`` (8 processes over JAX's mesh)
    and ``imagenet_resnet_spmd`` (4 processes, JAX's test arguments) on
    the card, with their JAX tests' checks and their ranks' launches."""
    import io
    from distkeras_tpu_torch.examples import (imagenet_resnet_spmd,
                                              large_model_spmd)
    out = {}
    for name, mod, argv, check in (
            ("large_model_spmd", large_model_spmd, [],
             lambda acc, txt: "next-token accuracy: 1.000" in txt),
            ("imagenet_resnet_spmd", imagenet_resnet_spmd,
             ["--n", "2048", "--epochs", "4", "--batch", "32", "--fsdp"],
             lambda acc, txt: acc > 0.9)):
        saved = sys.argv
        sys.argv = [name, *argv]
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                acc = mod.main()
        finally:
            sys.argv = saved
        txt = buf.getvalue()
        c = {}
        for r in mod.RESULTS:
            for k, n in r["launches"].items():
                c[k] = c.get(k, 0) + n
        print(f"phase 37 (c) {name} on {card}: "
              f"{time.perf_counter() - t0:.1f} s; "
              + "; ".join(txt.strip().splitlines())
              + f"; launches summed over its ranks {c}", flush=True)
        if not check(acc, txt) or c.get("flash_fwd", 0) < 1 \
                and name == "large_model_spmd":
            raise AssertionError(f"phase 37 (c): {name}: {txt}")
        out["example_" + name] = c
    return out


def _expert_elements(wq) -> int:
    """Elements of a quantized stacked expert leaf, unpacked."""
    return wq["q"].numel() if "q" in wq else 2 * wq["q4"].numel()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    flash_rows = flash_phase(dev)
    paged_rows = paged_phase(dev)

    model = build_lm(dev)
    print(f"model: transformer_lm {LM_CFG}, bf16, "
          f"{model.num_params() / 1e6:.1f}M parameters", flush=True)
    warm_up(model, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng, reqs, out, bad, _ = serve(model, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    s = check_serving(eng, reqs, out, bad)
    for name in SERVING_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the serving run never launched {name}")
    print(f"serving: {len(reqs)} requests in {wall:.2f} s; launches "
          f"{launches}; prefix hits {s['prefix_cache']['hits']}; "
          f"preemptions {s['requests_preempted']}; prefill chunks "
          f"{s['prefill_chunks']}", flush=True)
    print(f"serving on {card}: TTFT p50 {s['ttft_s']['p50'] * 1e3:.1f} ms "
          f"p99 {s['ttft_s']['p99'] * 1e3:.1f} ms; decode "
          f"{s['decode_tokens_per_sec']:.1f} tok/s; end to end "
          f"{s['tokens_per_sec']:.1f} tok/s; resident weights "
          f"{eng.param_bytes()} bytes; peak allocated during the run "
          f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
          f"allocated before it", flush=True)
    serve_summary = s
    paged_run = (reqs, out)

    profile_serving(model, dev)
    rel_bf16, rel_f32, scale = logits_vs_cpu(model, reqs[0][1])
    print(f"prefill logits vs CPU float32 (max |logit| {scale:.3f}): card "
          f"bf16 rel err {rel_bf16:.3e} (tol {E2E_BF16_REL_TOL}), card "
          f"float32 rel err {rel_f32:.3e} (tol {E2E_F32_REL_TOL})",
          flush=True)
    if not (rel_bf16 <= E2E_BF16_REL_TOL and rel_f32 <= E2E_F32_REL_TOL):
        raise AssertionError("card logits disagree with the CPU plain path")

    bwd_rows = backward_phase(dev)
    num_layers = LM_CFG["num_layers"]
    trainer, train_launches = train(model)
    losses, last_mean = check_training(trainer, train_launches, num_layers)
    print(f"training: {len(losses)} steps, loss {losses[0]:.4f} -> last "
          f"epoch mean {last_mean:.4f} (per step: "
          f"{np.array2string(losses, precision=3)}); accuracy last epoch "
          f"{np.mean(trainer.get_history().epochs[-1]['accuracy']):.4f}; "
          f"launches {train_launches}; {trainer.get_training_time():.1f} s",
          flush=True)
    profile_training(model, card)
    seg_rows = segment_phase(dev)
    packed_launches = packed_training_phase(dev, card)
    packed_gradients_phase(dev)
    gradients_vs_cpu(dev)
    del trainer
    gc.collect()

    decode_rows = decode_phase(dev)
    # phase 7 trained `model` in place: generate() and the quantized
    # engine run a fresh copy of the seed-0 random weights
    gen_model = build_lm(dev)
    gen_launches, gen_prompts = generate_phase(gen_model, card)
    profile_generate(gen_model, gen_prompts)
    rel = decode_logits_vs_cpu(gen_model, gen_prompts[0])
    print(f"decode-step logits vs CPU float32 (prompt {GEN_PROMPT}, step "
          f"at t={GEN_PROMPT}): card bf16 cache rel err {rel['bf16']:.3e}, "
          f"int8 cache {rel['int8']:.3e} (tol {E2E_BF16_REL_TOL}); card "
          f"float32 {rel['float32']:.3e} (tol {E2E_F32_REL_TOL})",
          flush=True)
    if not (rel["bf16"] <= E2E_BF16_REL_TOL
            and rel["int8"] <= E2E_BF16_REL_TOL
            and rel["float32"] <= E2E_F32_REL_TOL):
        raise AssertionError("card decode-step logits disagree with the CPU "
                             "plain path")

    q_paged_rows = {bits: paged_phase(dev, bits) for bits in (8, 4)}
    quant_launches = {}
    for cache_dtype, kname in (("int8", "paged_decode_q8"),
                               ("int4", "paged_decode_q4")):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng, reqs, out, bad, _ = serve(gen_model, dev,
                                       cache_dtype=cache_dtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = kernels.launch_counts()
        s = check_serving(eng, reqs, out, bad)
        if c[kname] < 1 or c["paged_decode"] != 0 or c["flash_fwd"] < 1:
            raise AssertionError(f"the {cache_dtype} serving run launched "
                                 f"{c}: expected {kname} >= 1, paged_decode "
                                 "0, flash_fwd >= 1")
        print(f"serving {cache_dtype} pages on {card}: {len(reqs)} requests "
              f"in {wall:.2f} s; launches flash_fwd {c['flash_fwd']}, "
              f"{kname} {c[kname]}, paged_decode {c['paged_decode']}; "
              f"prefix hits {s['prefix_cache']['hits']}; preemptions "
              f"{s['requests_preempted']}; TTFT p50 "
              f"{s['ttft_s']['p50'] * 1e3:.1f} ms p99 "
              f"{s['ttft_s']['p99'] * 1e3:.1f} ms; decode "
              f"{s['decode_tokens_per_sec']:.1f} tok/s", flush=True)
        quant_launches[kname] = c[kname]

    anc_rows = {bits: anc_phase(dev, bits) for bits in (None, 8, 4)}
    tie_rel = TIE_ERR_FACTOR * max(rel_bf16, rel["bf16"])
    spec_launches = spec_phase(gen_model, card, tie_rel)

    qmm_rows = {bits: qmm_phase(dev, bits) for bits in (8, 4)}
    k4_rows = k4_phase(dev)
    k7_rows = k7_phase(dev)
    wq_launches = wq_phase(gen_model, card, serve_summary)
    profile_serving(gen_model, dev, "int8 weights", weight_quant="int8")
    gen_wq_launches = generate_wq_phase(gen_model, card, gen_prompts)
    zb_launches = zero_bubble_phase(gen_model, card, tie_rel)
    for label, kw in LOOPS:
        profile_loop(gen_model, dev, card, label, **kw)
    for k in (1, 4):
        same_tok, same_pages, replay, eager = capture_check(gen_model, dev,
                                                            k)
        what = "one decode step" if k == 1 else f"a {k}-step window"
        print(f"capture readiness, {what} on {card}: the graph's replay "
              f"equals the eager call bitwise: tokens {same_tok}, pages "
              f"{same_pages}; replay "
              f"{replay:.3f} ms ({replay / k:.3f} ms a step), eager "
              f"{eager:.3f} ms", flush=True)
        if not (same_tok and same_pages):
            raise AssertionError("a captured decode launch differs from "
                                 "the eager one")
    sync_free_phase(gen_model, card)
    sampler_launches(dev, card)
    sampled_launches = sampled_serving_phase(gen_model, card)
    engine_api_phase(gen_model, card, tie_rel)
    del gen_model, model
    gc.collect()

    k6a_rows = k6a_phase(dev)
    moe_model = build_moe_lm(dev)
    print(f"model: all-MoE transformer_lm {dict(LM_CFG, mlp_ratio=2)}, "
          f"{MOE_EXPERTS} experts top-{MOE_TOP_K}, bf16, "
          f"{moe_model.num_params() / 1e6:.1f}M parameters", flush=True)
    moe_launches = moe_serve_phase(moe_model, card)
    moe_prefill_launches = moe_prefill_phase(moe_model, card)
    zb_moe_launches = zero_bubble_phase(moe_model, card, tie_rel, moe=True)
    sync_free_phase(None, card, moe_model)
    del moe_model
    gc.collect()

    k6bc_rows = k6bc_phase(dev)
    moe_train_launches = moe_training_phase(dev, card)
    moe_gradients_vs_cpu(dev)
    gc.collect()

    dist_launches = distributed_phase(dev, card)
    vision_launches = vision_phase(dev, card)
    gc.collect()
    t0 = time.perf_counter()
    zoo_launches = zoo_phase(dev, card)
    print(f"phase 29 (the rest of the zoo) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    t0 = time.perf_counter()
    lm = build_lm(dev)              # phase 5's weights (seed 0, untrained)
    slab_launches = slab_phase(lm, card, tie_rel, paged_run)
    t1 = time.perf_counter()
    offload_launches = offload_phase(lm, card, tie_rel, serve_summary)
    t2 = time.perf_counter()
    del lm
    gc.collect()
    moe_wq_launches = moe_wq_phase(dev, card)
    t3 = time.perf_counter()
    print(f"phase 30 (the engine's other layouts) took {t3 - t0:.1f} s: "
          f"slab {t1 - t0:.1f}, offload {t2 - t1:.1f}, quantized MoE "
          f"{t3 - t2:.1f}", flush=True)
    gc.collect()
    t0 = time.perf_counter()
    surface_launches = trainer_surface_phase(dev, card)
    print(f"phase 31 (the rest of the Trainer surface) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    t0 = time.perf_counter()
    obs_launches = obs_phase(dev, card)
    print(f"phase 32 (observability and resilience) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    router_launches = router_phase(dev, card, tie_rel)
    gc.collect()
    data_launches = data_phase(dev, card)
    gc.collect()
    small_rows, example_launches = examples_and_small_dims_phase(dev, card)
    gc.collect()
    sp_rows, sp_launches = seq_parallel_phase(dev, card)
    gc.collect()
    spmd_launches = spmd_phase(dev, card)

    by_path = {name: {} for name in kernels.SOURCES}
    for path, c in {**slab_launches, **moe_wq_launches,
                    "serving_offload": offload_launches}.items():
        for name in ("flash_fwd", "paged_decode", "prng", "quant_matmul_q8",
                     "quant_matmul_q4", "moe_gather_gemm1"):
            if c[name]:
                by_path[name][path] = c[name]
    for name in SERVING_KERNELS:
        by_path[name]["serving"] = launches[name]
    for name in TRAINING_KERNELS:
        by_path[name]["training"] = train_launches[name]
        by_path[name]["training_packed"] = packed_launches[name]
    for name, n in gen_launches.items():
        by_path[name]["generate"] = n
    by_path["paged_decode_q8"]["serving_int8"] = quant_launches[
        "paged_decode_q8"]
    by_path["paged_decode_q4"]["serving_int4"] = quant_launches[
        "paged_decode_q4"]
    for path, c in spec_launches.items():
        for name in SPEC_KERNELS:
            if c[name]:
                by_path[name][path] = c[name]
    for path, c in wq_launches.items():
        for name in ("quant_matmul_q8", "quant_matmul_q4",
                     "sample_epilogue"):
            if c[name]:
                by_path[name][path] = c[name]
    by_path["quant_matmul_q8"]["generate_wq_int8"] = gen_wq_launches
    for path, c in moe_launches.items():
        by_path["moe_gather_gemm1"][path] = c["moe_gather_gemm1"]
    by_path["moe_gather_gemm1"]["moe_prefill_fused"] = moe_prefill_launches
    for label, path in (("overlap", "serving_overlap"),
                        ("overlap+fuse4", "serving_fused")):
        by_path["paged_decode"][path] = zb_launches[label]["paged_decode"]
        by_path["moe_gather_gemm1"]["moe_" + path] = \
            zb_moe_launches[label]["moe_gather_gemm1"]
    for name in MOE_TRAINING_KERNELS:
        by_path[name]["training_moe"] = moe_train_launches[name]
    by_path["prng"]["serving_sampled"] = sampled_launches
    for path, c in dist_launches.items():
        for name in DIST_KERNELS:
            by_path[name][path] = c[name]
    for path, c in vision_launches.items():
        by_path["prng"][path] = c["prng"]
    for path, c in zoo_launches.items():
        for name in ("prng",) + TRAINING_KERNELS:
            if c[name]:
                by_path[name][path] = c[name]
    for path, c in surface_launches.items():
        for name in TRAINER_KERNELS:
            by_path[name][path] = c[name]
    for name in ("flash_fwd", "paged_decode", "sample_epilogue", "prng"):
        by_path[name]["serving_obs"] = obs_launches["serving_obs"][name]
    for name in TRAINER_KERNELS:
        by_path[name]["training_supervised"] = \
            obs_launches["training_supervised"][name]
    for path, c in router_launches.items():
        for name in ROUTER_KERNELS:
            if c[name]:
                by_path[name][path] = c[name]
    for path, c in data_launches.items():
        for name in TRAINER_KERNELS:
            if c.get(name):
                by_path[name][path] = c[name]
    for path, c in example_launches.items():
        for name, n in c.items():
            by_path[name][path] = n
    for path, c in {**sp_launches, **spmd_launches}.items():
        for name, n in c.items():
            if n:
                by_path[name][path] = n

    def entry(name, source, replaces, rows, path):
        main_row = rows[0]
        rows = rows + small_rows.get(name, [])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": by_path[name][path],
                "launches_by_path": by_path[name],
                "max_abs_err": max(r["err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    print(json.dumps({"kernels": [
        entry("flash_fwd", "distkeras_tpu_torch/csrc/flash_fwd.cu",
              "distkeras_tpu/ops/flash_attention.py:321",
              flash_rows + seg_rows["flash_fwd"] + sp_rows["flash_fwd"],
              "serving"),
        entry("paged_decode", "distkeras_tpu_torch/csrc/paged_decode.cuh",
              "distkeras_tpu/ops/paged_attention.py:365", paged_rows,
              "serving"),
        entry("flash_bwd_dq", "distkeras_tpu_torch/csrc/flash_bwd.cu",
              "distkeras_tpu/ops/flash_attention.py:585",
              bwd_rows["flash_bwd_dq"] + seg_rows["flash_bwd_dq"]
              + sp_rows["flash_bwd_dq"], "training"),
        entry("flash_bwd_dkv", "distkeras_tpu_torch/csrc/flash_bwd.cu",
              "distkeras_tpu/ops/flash_attention.py:619",
              bwd_rows["flash_bwd_dkv"] + seg_rows["flash_bwd_dkv"]
              + sp_rows["flash_bwd_dkv"], "training"),
        entry("decode_attention",
              "distkeras_tpu_torch/csrc/decode_attention.cuh",
              "distkeras_tpu/ops/decode_attention.py:233",
              decode_rows["decode_attention"], "generate"),
        entry("decode_attention_q8",
              "distkeras_tpu_torch/csrc/decode_attention.cuh",
              "distkeras_tpu/ops/decode_attention.py:233",
              decode_rows["decode_attention_q8"], "generate"),
        entry("paged_decode_q8", "distkeras_tpu_torch/csrc/paged_decode.cuh",
              "distkeras_tpu/ops/paged_attention.py:365", q_paged_rows[8],
              "serving_int8"),
        entry("paged_decode_q4", "distkeras_tpu_torch/csrc/paged_decode.cuh",
              "distkeras_tpu/ops/paged_attention.py:365", q_paged_rows[4],
              "serving_int4"),
        entry("paged_decode_anc", "distkeras_tpu_torch/csrc/paged_decode.cuh",
              "distkeras_tpu/ops/paged_attention.py:177", anc_rows[None],
              "serving_spec_tree"),
        entry("paged_decode_q8_anc",
              "distkeras_tpu_torch/csrc/paged_decode.cuh",
              "distkeras_tpu/ops/paged_attention.py:177", anc_rows[8],
              "serving_spec_tree_int8"),
        entry("paged_decode_q4_anc",
              "distkeras_tpu_torch/csrc/paged_decode.cuh",
              "distkeras_tpu/ops/paged_attention.py:177", anc_rows[4],
              "serving_spec_tree_int4"),
        entry("quant_matmul_q8", "distkeras_tpu_torch/csrc/quant_matmul.cu",
              "distkeras_tpu/ops/quant_matmul.py:282", qmm_rows[8],
              "serving_wq_int8"),
        entry("quant_matmul_q4", "distkeras_tpu_torch/csrc/quant_matmul.cu",
              "distkeras_tpu/ops/quant_matmul.py:282", qmm_rows[4],
              "serving_wq_int4"),
        entry("sample_epilogue", "distkeras_tpu_torch/csrc/sampling.cu",
              "distkeras_tpu/ops/sampling.py:180", k4_rows,
              "serving_wq_int8"),
        entry("moe_gather_gemm1", "distkeras_tpu_torch/csrc/moe_gemm.cu",
              "distkeras_tpu/ops/moe_kernels.py:214", k6a_rows,
              "serving_moe"),
        entry("moe_bwd_dx", "distkeras_tpu_torch/csrc/moe_bwd.cu",
              "distkeras_tpu/ops/moe_kernels.py:297",
              k6bc_rows["moe_bwd_dx"], "training_moe"),
        entry("moe_bwd_dw1", "distkeras_tpu_torch/csrc/moe_bwd.cu",
              "distkeras_tpu/ops/moe_kernels.py:353",
              k6bc_rows["moe_bwd_dw1"], "training_moe"),
        entry("prng", "distkeras_tpu_torch/csrc/prng.cu",
              "none: XLA's threefry in JAX (jax.random, fused by XLA)",
              k7_rows, "serving"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
