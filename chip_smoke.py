#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing its lines (a failed check exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the seven CUDA sources (decode attention — contiguous and paged
   entry points — ``sr_cast``, ``fused_adamw``, ``fused_sgd``,
   ``qmatmul``, ``philox``, ``row_mean_sq``), built from this checkout
   with one ``nvcc`` per source at once; nvcc time, registers and spills;
3. kernel: the decode kernel against its plain PyTorch version (atol =
   rtol = 1e-2 and, lane by lane, 1% of the RMS of its output) at the
   serving path's shapes (B=8 lanes, 16/2 heads, D=128, bf16, Sc 256 and
   2048): mixed depths, two parked lanes (exact zeros), window 64 +
   softcap 30, and the cases the cluster kernel's range search must get
   right — a ring cache (q_pos >= Sc, cell pos % Sc; windows inside and
   across the ring's end), an active lane with no visible key (uniform
   p), window 64 at depth ~2000 (the range starts mid-view), uneven depths
   (one lane at the view's end, the rest under 32 keys); each case also
   through the paged kernel on a shuffled pool of the same view
   (``torch.equal`` to the contiguous kernel), and each kernel twice
   (``torch.equal``: the sums run in a fixed order); its time beside its
   bound, the plain version's time and ``scaled_dot_product_attention``'s
   (a yardstick the port never calls);
4. kernel-paged: the paged decode kernel on a shuffled page pool (P=16,
   views of 256, 1024, 4096 and 32768 keys; two lanes share prefix pages,
   null blocks trail, two lanes parked; one variant with window 64 +
   softcap 30): ``torch.equal`` to the contiguous kernel on the gathered
   view and to itself on a second call, within atol = rtol = 1e-2 of its
   plain version and, lane by lane, within 1% of the RMS of its output,
   parked lanes exactly zero; its time beside its bound,
   the plain version's and ``scaled_dot_product_attention``'s on the
   pre-gathered view;
4b. kernel-g10 (ROADMAP C14): the decode kernels at recurrentgemma's group,
   10 query heads on 1 kv head of D = 256, 8 lanes over 2048 keys, bf16
   and f32, with and without window 64, two lanes parked: within atol =
   rtol = 1e-2 and 1% of each lane's RMS of the plain version, paged ==
   contiguous on the gathered view, two calls equal, heads 5-9 == a call
   on those 5 heads alone, parked lanes zero; the bf16 kernel's time
   beside its bound, the plain version's and
   ``scaled_dot_product_attention``'s;
5. row probe (ROADMAP C10): each op of one full-width serve-step layer at
   8 rows and at 256 rows, ``torch.equal`` on the leading 8 rows — the
   row reduction ``row_mean_sq`` under RMSNorm, RoPE, silu·mul, the bias
   and residual adds, ``qmatmul`` and the dense layer on the kernel route,
   the decode and paged kernels with the rows of a 32-token chunk as
   lanes (each row also ``torch.equal`` to a single-token call at its
   position) — beside ``torch.mean``'s RMSNorm and cuBLAS's product,
   reported only; ``row_mean_sq`` ``torch.equal`` to its plain version,
   and its time;
6. serve (main path of contiguous serving): full-width qwen2.5-3b (12 of
   its 36 layers, random weights from a seed) served by the continuous-batching
   engine with the serve step's kernels (decode attention, ``qmatmul``
   for every dense product, ``row_mean_sq``) — 12 requests from the
   synthetic stream, first with the eager step (timed, its tokens kept),
   then with the engine's CUDA graphs (the first step of a width eager,
   every later one a replay); every request must finish, the graph must
   hold 12 decode, 84 ``qmatmul`` and 25 ``row_mean_sq`` launches and the
   run must have made that many per serve step (the launches of the eager
   first step plus the graph's per replay), and the tokens must equal the
   eager step's, and on the 4 shortest requests the port's ``generate``'s
   (same kernels, batched to the engine's 8 rows), bit for bit, and the
   run captures no logits graph
   (greedy traffic); then the same stream with
   ``prefill_chunk=32`` (graphs of widths 1 and 32): tokens equal to the
   chunk-1 run's on every request, 12 decode launches per step at both
   widths, ms per step of each width;
7. serve-paged (main path of paged serving): the same model served by
   the paged engine (8 slots, max_len 1024, pages of 16, 64 pages — below
   the 512 of byte parity, so it preempts — prefix cache on, fused paged
   kernel) on 16 requests whose prompts (32–256 tokens, 3 in 4 behind one
   128-token prefix) come from the synthetic stream; every request
   finishes with the tokens and steps of the eager step and the tokens of
   a contiguous fused engine on the same stream, at least one preemption
   and one prefix hit, pool invariants at drain and no live page after
   ``clear_prefix``, 12 paged-kernel launches per serve step; then the
   same stream with ``prefill_chunk=32`` (graphs of widths 1 and 32) in
   fewer steps, its tokens equal to the chunk-1 run's on every request,
   12 paged launches per step at both widths, ms per step of each width;
   then the chunk probe (ROADMAP C10): one 32-token chunk step against 32
   single-token steps from an empty cache, 8 lanes, K, V and positions of
   all 12 layers and the last-row logits ``torch.equal``; then a profile
   of steady-state serve steps of each engine, contiguous and paged, with
   the host wall time per step before, under and after the profiler, the
   device time and idle share per step, graph launches and the kernels
   inside them, the decode kernel's and ``qmatmul``'s device time and
   launches per step as the profiler counts them (the profiles come last:
   the profiler may slow the launches of later work);
7b. families (ROADMAP A4 items 1-4; after the sample phase and the serve
   profiles): yi-9b (6 of 48 layers), mistral-nemo-12b (2 of 40),
   command-r-35b (4 of 40), mixtral-8x22b (2 of 56), llama4-scout (2 of
   48), falcon-mamba-7b (8 of 64) and recurrentgemma-2b (12 of 26) at their published
   widths, random weights from seed 0 drawn on the card, each freed before
   the next: 12 greedy requests on 8 slots (max_len 256, prompts of 8-48
   tokens, 24 new tokens, 4 of them in recycled slots) through the fused
   serve step, eager then as CUDA graphs: graph tokens == the eager
   step's == ``generate``'s (8 rows through the same kernels), the graph's
   decode, ``qmatmul`` and ``row_mean_sq`` launches == the family's count
   per step; paged == contiguous tokens (yi with prefix hits, mixtral,
   recurrentgemma); yi chunk 32 == chunk 1; a row probe of the ops each
   family adds (8 vs 256 rows); a profile of one engine per family kind;
   init s, peak GiB, ms per replayed step and tok/s; then 3 fused-update
   steps (``bf16_sr_kahan``, lr 1e-6, one batch of 2 x 256) of 2-layer
   mixtral and falcon-mamba: finite, falling loss, one ``fused_adamw``
   launch per leaf per step, the f32 leaves bf16 after;
7c. slice 11 (ROADMAP A4 items 5-7; right after the families):
   kernel-d64: the contiguous decode kernel at whisper's shapes (G = 1, 8
   kv heads, D = 64, bf16 and f32), its decoder's self-attention (448
   cells at mixed depths) and its cross-attention (1500 keys, the query at
   1500): within atol = rtol = 1e-2 and 1% of each lane's RMS of the plain
   version, two calls equal, the time beside the bound and SDPA's;
   whisper: whisper-base at full width and depth (6 + 6 layers, 1500
   frames, 8 lanes, seed 0) encoded once, then 4 prompt and 28 new tokens
   in lock-step through the fused serve step (eager): last logits within
   0.05 of their scale of ``decoder_forward``, two runs' tokens equal, 12
   decode and 54 ``qmatmul`` launches per step, ms per step; then 3 fused
   AdamW steps (``bf16_sr_kahan``) on one audio batch (8 × 1500 frames, 448
   tokens): falling loss, one launch per leaf per step; qwen2-vl:
   qwen2-vl-7b at full width, 7 of 28 layers, served as the families are
   (eager == graphs == ``generate``, paged == contiguous, kernel counts,
   row probe, profile), a vlm lock-step decode at full depth of 8 lanes
   over 16 text
   embeddings, a 1 × 8 × 8 image grid and 16 more with their M-RoPE
   positions (last logits within 0.05 of ``forward_logits``; 28 decode,
   196 ``qmatmul``, 57 ``row_mean_sq`` launches per step), 3 fused AdamW
   steps of a 2-layer cut on a vlm batch (falling loss); resnet (run
   beside the paper sections, phase 13):
   ``RESNET_CIFAR_SMALL`` on ``image_batches`` (batch 128), 200 SGD-momentum
   steps under ``fp32``, ``bf16_standard``, ``bf16_sr`` and ``bf16_kahan``
   (``fused_sgd`` once per leaf per step): falling loss, final accuracy;
   one ``bf16_sr`` step non-fused (``philox`` + ``sr_cast``) ``torch.equal``
   to the fused one on every weight and momentum; cuDNN TF32 off;
8. update kernels: the Philox fill against its plain version, and
   ``fused_adamw`` with in-kernel Philox bits against its plain version
   on the same seed (SR × Kahan off or on), at a ragged n = 1,000,003
   (also at an element offset of 3: the scalar head and a misaligned
   Philox block) and at the embedding leaf's 151936×2048 elements;
   ``sr_cast`` (with ±inf, NaN and near-max lanes), ``fused_adamw`` and
   ``fused_sgd`` (nearest or SR × Kahan off or on) against their plain
   versions on one int32 bits tensor: every output ``torch.equal``;
   device time at the embedding size beside the bytes bound and the plain
   version's time (no single PyTorch call computes these updates, so
   there is no library time), and the time of ``fused_adamw``'s loads
   alone and loads and stores alone, which says what bounds it;
9. qmatmul (main path of the kernel op layer): ``ops.qmatmul_op``,
   nearest and SR, at full-width qwen2.5-3b products — MLP gate/up and
   down and one KV projection at the train phase's 2 × 2048 rows, one
   serve step's 8 lanes (all on the ``wgmma`` path) — and at odd shapes
   that take the ``mma.sync`` path and its scalar loads (N or K not a
   multiple of 8, x at a 2-byte offset); ``qmatmul`` launched once per op
   call; each output ``torch.equal`` to ``qmatmul`` on the generator's
   bits, within 1 bf16 ulp plus the f32 accumulation bound of the plain
   version on at most 0.5% of the outputs, and within that bound of the
   exact (f64) product; ±inf, NaN, overflow and near-max lanes
   ``torch.equal`` to the plain version (bits 0xFFFF carry bf16 max into
   inf); 1024 products of 0.01² within 1%; the plain version's f32
   product without TF32; each shape's path (the Python plan ≡ the
   library's); rows bitwise equal at 1, 8, 256 and 4096 rows (gate/up,
   down) and at 1, 8 and 129 rows (N = 77); device time at every shape,
   nearest, and SR at the model's shapes, beside TFLOP/s, the bound, the
   ``mma.sync`` kernel's time on the same inputs, the plain version's and
   ``torch.matmul``'s (nearest: no single call rounds by SR; the port
   never calls it); then the f32-result entry (``qmatmul_f32``, the
   row-parallel partials of the tp phase) at the row-parallel shapes of
   qwen2.5-3b at model 2 for 8 lanes, one training shape, and those of the
   tp-families phase (mixtral's per-expert down product at 16 rows, K =
   8192; falcon-mamba's ``x_proj``, N = 288, and ``out_proj``): rounded to
   bf16 ``torch.equal`` to the bf16 entry on both paths, rows bitwise at
   1, 8, 256 and 4096 rows, within the f32 accumulation bound of its plain
   version; device time beside its bound, the bf16 entry's, the plain
   version's and ``torch.mm(..., out_dtype=torch.float32)``'s; then
   ``sr_cast_op``, ``adamw_update_op`` and
   ``sgd_update_op`` once each at a ragged n, ``torch.equal`` to the
   plain version on the generator's bits and to themselves under a
   re-seeded generator;
10. train (main path of training): full-width qwen2.5-3b trained through
   the launcher's own functions, ``--policy bf16_sr_kahan --fused-update
   --batch 2 --seq 2048``, 8 steps at lr 1e-4: every loss finite, the
   last below step 0's, ``fused_adamw`` launched once per parameter leaf
   per step; ms per step, tokens per second, the optimizer's ms per step
   (CUDA events) beside its bound, peak device memory; then one more step
   under the profiler (device time, idle share, top kernels, the f32 SIMT
   GEMMs left: the logits backward's two, on the f32 cotangent); then
   the products the reference takes as 16-bit dots with an f32 result, at
   the train shapes, as upcast f32 GEMMs and on the tensor cores (CUDA
   events), each held within the f32 accumulation bound, summed per step;
11. update parity (main path of the non-fused optimizer, of fused SGD
    and of the Philox fill): from the trained state and one fresh
    gradient, one step of ``adamw`` against ``fused_adamw_optimizer`` and
    of ``sgd`` against ``fused_sgd_optimizer`` with the same ``StepKey``
    (the fill's bits against the bits fused AdamW draws itself), leaf by
    leaf: params, moments and Kahan buffers bitwise equal on every leaf,
    ``sr_cast`` launched by the non-fused path and ``philox`` once per leaf
    by each optimizer but fused AdamW; then whether the card's
    embedding backward (``index_put_`` with accumulation, bf16) equals the
    CPU's bf16 scatter-add;
12. sample (main path of sampled serving; it runs after the serving runs
    of phase 7 and before their profiles): the serve and serve-paged
    streams with every other request sampled (temperature 0.8, top-k 50,
    top-p 0.95, seed 1): graphs of width 1 with and without the logits
    (the greedy-only runs of phases 6 and 7 must capture none with them),
    a Philox fill per sampled token; (a) the greedy requests' tokens ==
    the greedy-only runs', request by request; (b) a second fresh engine
    draws the same tokens, seed 2 changes at least one request; (c) 64
    pages with ``prefill_chunk=32`` (≥ 1 preemption) == 512 pages with
    chunk 1 == 64 pages with chunk 1; (d) 20000 draws from one real
    logits row at positions 0–19999: the card's sampler == the CPU plain
    path on ≥ 99.9% of draws (mismatches printed), every kept token within
    5σ of the exact filtered softmax, none outside the support; (e) ms per
    replayed step of each (width, with_logits), the sampler's ms per step
    (CUDA events), tok/s beside the greedy stream's, device memory after
    capture;
13. paper (main path of the paper's experiments): the eight sections of
    ``repro_torch.benchmarks`` (fig2, table3, table4, fig5, fig9, fig10,
    fig11, fig12) at the reference's step counts, each in a process of its
    own, all at once (host-bound harnesses: one after another they took
    390-630 s; table4 in five: one per LM policy, one for its DLRM runs),
    their CSV rows after a line with the card's name and power limit; first
    one ``bf16_sr`` SGD step of the DLRM (13 leaves, the tables 8 × 1000 × 16)
    through ``sr_cast`` ``torch.equal`` to the same step through its plain
    version on the same Philox bits; ``sr_cast`` and ``philox`` counted
    over the sections; the reference's conclusions, with margins set from
    its CPU rows: fig2 nearest-on-updates MSE ≥ 5 × exact and
    nearest-on-fwd/bwd ≤ 1.5 × exact; table3 ablation gap < standard gap;
    table4 DLRM AUC of SR and Kahan within 0.01 of fp32, standard ≥ 0.03
    below; table4 LM SR and Kahan gaps to fp32 each under half the
    standard gap; fig9 0 < early < late < 1; fig12 fp16 range probe NaN or
    > 1e3 × bf16's, bf16's finite; every fig5, fig10, fig11 and fig12 row
    finite, fig11's DLRM AUC within 0.01 of table4's fp32; a second
    ``bf16_sr`` DLRM run bitwise equal to table4's (losses and AUC); beside
    them the runner's ``grad_wire_sweep`` and ``fsdp_memory`` (4 ranks, 2
    data x 2 fsdp: DP / FSDP state bytes per rank >= 1.9; its ``grad_wire``,
    8 ranks, runs in ``tools/port_tp_train.py``); µs per step of
    every run and the phase's wall time. The tp launches (phase 16), the
    ckpt phase and the resnet run beside the sections: all four are
    host-bound, and one after another they took ~380 s; their times are
    taken under that contention;
14. ckpt (main path of checkpointed training; beside the paper sections):
    the train cell cut to 2 layers (465 M parameters) through the launcher's
    ``build`` and ``train`` with ``--ckpt-every 2``, keep-N 2, under a
    temporary directory removed at the end (its free space printed first):
    (a) two uninterrupted 6-step runs, the second checkpointing
    asynchronously, agree bitwise on every leaf and loss; (b) SIGTERM at
    step 3 returns preempted with a checkpoint at step 4, and a fresh
    ``build`` resumes and finishes equal to the uninterrupted run, leaf for
    leaf and loss for loss; (c) a ``--sync-ckpt`` checkpoint restores to
    the async one's state; prints the checkpoint's bytes, the snapshot's
    ms, the commit's s, ms per step with a commit in flight against the
    same steps without checkpoints, and the restore's s;
15. dist (ROADMAP A5, data parallelism; it runs last): (a) in a 1-rank
    NCCL group the train cell with ``--grad-wire bf16`` (the one-replica
    wire: every leaf SR-rounded by the ``philox`` fill and ``sr_cast``),
    8 steps: falling loss, one launch of each per leaf per step, one
    leaf's q and residual ``torch.equal`` to the plain ``compress_leaf``
    (also with a nonzero residual), ms per step beside the train phase's,
    the wire's ms (CUDA events), residual and peak GiB; (b) 2 ranks on
    this card over gloo through ``repro_torch.launch.dist_launch``
    (``chip_smoke.py --dist-worker``), full width cut to 2 layers, batch 4
    x 512, ``--grad-accum 2``: the fp32 and bf16 wires 3 steps each (ranks
    bitwise equal; the fp32 step within 0.05 of a 1-process step), the
    bf16 wire preempted by a SIGTERM to rank 1 (checkpoint at step 2) and
    resumed by a fresh launch bitwise equal to the uninterrupted run
    (residual rows included), a 1-process resume zero-initializing the
    residuals; ms per
    step, host-copy ms, wire bytes by dtype (fp32 / bf16 = 2).
    FSDP (ROADMAP A9) rides the same launches: the ``philox`` shard entry
    ``torch.equal`` to the whole fill's slice and to its plain version,
    timed; then 2 ranks with ``--fsdp-parallel 2``: (a) non-fused FSDP-2
    == non-fused DP-2 on every gathered leaf after 3 steps (``philox`` and
    ``sr_cast`` on shards); (b) fused FSDP-2, one shard's ``fused_adamw``
    == its plain version with the folded seed, held to the fused fp32-wire
    DP-2 run: step 0's loss equal, losses within 0.05, each leaf's
    compensated weights w - c after step 1 off by at most 0.05 of that
    run's movement from init; (c) state bytes per rank FSDP / DP <= 0.53; (d)
    SIGTERM to rank 1, a fresh launch resumes bitwise, the checkpoint in
    one process == the gathered state; (e) a 4-rank launch beside the
    first, ``--pods 2 --fsdp-parallel 2 --grad-wire bf16``, 2 steps: the pods' shards
    bitwise equal, the wire's bytes by dtype as counted; ms per step,
    gather and reduce-scatter bytes, host-copy ms, peak GiB per rank. The
    first launch's runs share the card and the host with the 4-rank one,
    so their step walls are not the isolated metric; ``tools/port_fsdp.py``
    times DP-2 and FSDP-2 alone;
16. tp (ROADMAP A10's serving part; launched beside the paper sections,
    checked before the dist phase): ranks sharing this card over gloo
    through ``repro_torch.launch.dist_launch`` (``chip_smoke.py
    --tp-worker``): (a) 1 data x 2 model, full-width qwen2.5-3b (2 of its
    layers), the serve phase's 12 requests on 8 slots, eager steps (no
    graphs under a model group): both ranks' tokens bitwise equal, engine
    == lock-step ``generate`` under the same mesh on the shortest request,
    the first prefill step's logits within 0.05 of the 1-rank step's
    largest |logit|, 2 ``qmatmul_f32`` and 1 decode launch per layer and
    step;
    prints the token agreement with a 1-rank engine at the same depth,
    weight and KV bytes per rank against one rank's, ms per eager step and
    the model axis's collective and host-copy ms per step; (b) paged 1 x 2
    at 2 layers on the paged stream's first 10 requests (32 pages of 16,
    prefix cache): a preemption and a prefix hit, chunk 32 == chunk 1
    bitwise; (c) 2 data x 2 model on 4 ranks at 2 layers, beside (b):
    tokens == the 1 x 2 run's bitwise;
17. tp-train (ROADMAP A11, training on the model axis; launched on the tp
    phase's thread after its serving launches, checked after them): ranks
    sharing this card over gloo (``chip_smoke.py --tp-worker`` with a
    ``train-*`` scenario), every run through the launcher's
    ``parse_args``, ``build`` and ``train``: (a) 1 data x 2 model,
    full-width qwen2.5-3b cut to 2 layers, batch 2 x 512, ``bf16_sr_kahan
    --fused-update``, 3 steps: both ranks bitwise equal on every
    replicated leaf and on the losses, each step's loss within 0.05 of a
    1-process run of the same steps, one TP shard's ``fused_adamw`` ==
    its plain version with the folded seed, weight and state bytes per
    rank <= 0.53 of one process's, one ``fused_adamw`` launch per local
    leaf per step; (b) non-fused ``bf16_sr``: one update of the shards
    (the ``philox`` shard entry, then ``sr_cast``) == the 1-process
    update's slice given the same gradients (w, m, v of every sharded
    layer kernel);
    (c) 2 data x 2 model on 4 ranks through the bf16 wire, 2 steps,
    checkpointed (beside (a, b)): the model groups bitwise equal, the
    wire's bytes by dtype as counted, and the checkpoint restored in one
    process and under 1 x 2 equal to the 2 x 2 ranks' parts; prints ms per
    step, the model axis's collectives, their ms and host-copy ms per
    step, bytes and peak GiB per rank. ``tools/port_tp_train.py`` runs
    this phase alone, then 1 x 2 at the whole 36 layers;
18. tp-families (ROADMAP A12 item 1, the MoE and Mamba families on the
    model axis; launched on the tp phase's thread, its training beside
    phase 16's (a) and its serving beside (b) and (c), checked after phase
    17): 1 data x 2 model ranks sharing this card over
    gloo, at published widths, depth cut. Serving on the families' stream
    (12 requests of 24 tokens, 8 slots, eager steps): mixtral-8x22b at 2
    layers (and paged), llama4-scout-17b-a16e at 1 (its shared expert),
    falcon-mamba-7b at 8 (the sharded Mamba cache): both ranks' tokens
    bitwise equal, paged == contiguous, the counted collectives per step
    (MoE 2 per layer, 3 with the shared expert; Mamba 3: the ``in_proj``
    exchange, ``x_proj``, ``out_proj``; + the embedding and the logits),
    ``qmatmul_f32`` once per expert and ``wo`` (MoE) or twice (Mamba) per
    layer and step; prints the token agreement with a 1-rank engine at the
    same depth (C18). Training beside it (``bf16_sr_kahan --fused-update``,
    batch 1 x 512, 3 steps): mixtral at 1 layer, falcon-mamba at 2, each
    beside a 1-process run: ranks bitwise equal on every replicated leaf
    and the losses, each loss within 0.05 of one process's, one shard's
    ``fused_adamw`` == its plain version with the folded seed, bytes per
    rank <= 0.53 of one process's. Prints ms per step, collectives, their
    ms and host-copy ms, peak GiB per rank. ``tools/port_tp_families.py``
    runs this phase alone;
19. tp-hybrid (ROADMAP A12 items 1b and 2, RG-LRU and whisper on the model
    axis with head counts and a vocabulary it does not divide; after phase
    18's checks, its five launches side by side (beside the paper window
    and the tp thread they ran the card out of memory); the decode kernel at its per-rank shapes
    and cache sizes in kernel-hybrid, after kernel-g10, and ``qmatmul_f32`` at its partials
    beside the other f32 shapes): ranks sharing this card over gloo at
    published widths. Serving: recurrentgemma-2b at 6 of 26 layers on
    1 x 2 (its one kv head gathered, 5 query heads per rank) on the
    families' stream, and at 3 on 1 x 4 (10 query heads padded to 12) on 4
    requests of 8 tokens, each beside a 1-rank engine; whisper-base whole
    on 1 x 2 (vocabulary 51865 whole on every rank) in lock-step, 8 lanes
    x 24 tokens, its last logits within 0.05 of the largest |logit| of one
    process teacher-forced on the same tokens. Ranks bitwise, the counted
    collectives and launches per step, the token shares printed (C18).
    Training beside them: recurrentgemma-2b at 3 layers through the
    launcher (``bf16_sr_kahan --fused-update``, 1 x 512, lr 1e-4) and
    whisper-base on the whisper phase's batch through
    ``make_train_step(mesh=)``, 3 steps each beside one process: ranks
    bitwise on every replicated or whole leaf and the losses, losses
    within 0.05, a shard's ``fused_adamw`` == plain, bytes per rank <=
    0.53 of one process's for the leaves the specs shard (whisper's whole
    embedding counts in full). Prints ms per step, collectives, their ms
    and host-copy ms, peak GiB per rank. ``tools/port_tp_hybrid.py`` runs
    this phase alone.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# kernel vs plain version on the f32 output: both sum in f32 in different
# orders, and an f32-ulp difference can flip the bf16 rounding of one p —
# a bf16-ulp-level difference, far below this bound
ATOL = RTOL = 1e-2
# ... and, lane by lane, to REL_RMS of the RMS of the plain version's output
# in that lane: on long views an output is ~sqrt(e/keys), about ATOL itself,
# where ATOL alone would pass a kernel that drops a few percent of the keys
REL_RMS = 1e-2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # H100 SXM data sheet, dense bf16
B, HQ, HKV, D = 8, 16, 2, 128
MAIN_SC = 256               # the engine's max_len below
PAGE = 16                   # the paged engine's page size
PAGED_MAX_LEN = 1024        # the paged engine's max_len: its views are 64 pages
PAGED_N_PAGES = 64          # below byte parity (8 x 64 = 512), so the run preempts
LONG_VIEW = 32768           # qwen2.5-3b's max_position_embeddings: the longest view timed
CHUNK = 32                  # the chunked reruns' prefill chunk
# the serving phases' depth cut of full-width qwen2.5-3b (12 of its 36
# layers), also the tp phase's (a): the script's time within its limit
SERVE_LAYERS = 12
MAIN_GENERATE = 4           # serve: the requests (the shortest) lock-step generate re-derives
# the sample phase: every other request of the serve streams samples so
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95, seed=1)
SAMPLE_DRAWS = 20000        # draws on one logits row, card against the CPU
SOURCES = ("decode_attention", "sr_cast", "fused_adamw", "fused_sgd", "qmatmul", "philox",
           "row_mean_sq")
KERNELS = ("decode_attention", "paged_decode_attention", "sr_cast", "fused_adamw",
           "fused_sgd", "qmatmul", "qmatmul_f32", "philox", "row_mean_sq")
# (M, N, K) of the qmatmul phase: full-width qwen2.5-3b products (d_model
# 2048, d_ff 11008, 2 KV heads x 128) at the train phase's 2 x 2048 rows and
# at one serve step's 8 lanes, then odd shapes that take every edge path
QMATMUL_SHAPES = {
    "mlp gate/up": (4096, 11008, 2048),
    "mlp down": (4096, 2048, 11008),
    "kv proj": (4096, 256, 2048),
    "serve 8 lanes": (8, 11008, 2048),
    "odd, N=77": (129, 77, 200),           # y takes the scalar path
    "odd, K=77": (129, 200, 77),           # x takes the scalar path
    "odd, x unaligned": (64, 64, 64),      # x at a 2-byte offset: scalar path
}
QMATMUL_MODEL = ("mlp gate/up", "mlp down", "kv proj", "serve 8 lanes")
# row counts at which every row of a product must be the same bits
QMATMUL_ROWS = (1, 8, 256, 4096)
# kernel vs plain: at most 1 bf16 ulp plus the f32 accumulation bound on at
# most this fraction of the outputs (tests/test_kernels.py::assert_bf16_close)
QMATMUL_MAX_FRAC = 0.005
EMBED_N = 151936 * 2048     # the embedding leaf of qwen2.5-3b
# bytes per element each update kernel must move in its main-path variant
# (SR + Kahan): every bf16 input read once, bits read once, outputs written;
# fused AdamW draws its bits in the kernel (Philox) and reads none
UPDATE_BYTES = {"sr_cast": 4 + 4 + 2,                       # x f32, bits; out bf16
                "fused_adamw": 5 * 2 + 4 * 2,               # w m v g c; w m v c
                "fused_sgd": 4 * 2 + 4 + 3 * 2,             # w m g c, bits; w m c
                "philox": 4}                                # bits written
# fused AdamW's probe variants (seeded SR + Kahan): bytes per element moved
ADAMW_PROBE_BYTES = {"loads": 5 * 2, "loads+stores": 5 * 2 + 4 * 2}
# hyperparameters of the update-kernel checks (f32-exact betas)
HP_ADAMW = dict(lr=1e-3, b1=0.8984375, b2=0.99609375, eps=1e-8, wd=0.01,
                c1=0.8984375, c2=0.99609375)
HP_SGD = dict(lr=0.1, momentum=0.9, wd=1e-4)
# the train cell. lr 1e-4: the launcher warms up over one step at 8 steps,
# and Adam's first full step moves every weight by ~lr along its gradient's
# sign, a layer's output by ~lr * d_model; at 3e-3 the loss spiked ~2x at
# step 2 or 3 on both token streams the port has drawn (25.37 on numpy's
# uniforms, 20.73 on the reference's), and on the reference's it ended
# above its start
TRAIN_ARGV = ["--arch", "qwen2.5-3b", "--policy", "bf16_sr_kahan", "--fused-update",
              "--batch", "2", "--seq", "2048", "--steps", "8", "--lr", "1e-4",
              "--seed", "0", "--device", "cuda"]
# the ckpt phase: the train cell at full width, depth cut to CKPT_LAYERS
CKPT_ARGV = TRAIN_ARGV[:TRAIN_ARGV.index("--steps")] + [
    "--steps", "6", "--lr", "3e-3", "--seed", "0", "--device", "cuda", "--ckpt-every", "2"]
CKPT_LAYERS = 2
CKPT_KEEP = 2
CKPT_SIGTERM_AT = 3
# the dist phase: (a) the train cell with the one-replica bf16 wire in a
# 1-rank NCCL group; (b) 2 ranks on this card over gloo, full width cut to
# DIST_LAYERS, grad_accum 2 (f32 gradients: the wire leaves residuals)
DIST_FULL_ARGV = TRAIN_ARGV + ["--grad-wire", "bf16"]
DIST_CHECK_LEAF = "layers.b0.mixer.wk.kernel"
DIST_LAYERS = 2
DIST_STEPS = 3             # gloo over loopback: 2-6 s per 2-rank step at this width
DIST_SIGTERM_AT = 1        # the preemption's checkpoint: step 2
DIST_ARGV = ["--arch", "qwen2.5-3b", "--policy", "bf16_sr_kahan", "--fused-update",
             "--batch", "4", "--seq", "512", "--grad-accum", "2", "--steps", str(DIST_STEPS),
             "--lr", "3e-3", "--seed", "0", "--device", "cuda", "--preempt-poll", "1"]
DIST_TWO_RANKS = ["--data-parallel", "2", "--dist-backend", "gloo"]
# the FSDP runs (ROADMAP A9), folded into the dist phase's launches: 2 ranks
# sharding over an fsdp axis of 2 on this card, the same cut and batch
FSDP_TWO_RANKS = ["--fsdp-parallel", "2", "--dist-backend", "gloo"]
FSDP_PLAIN_STEPS = DIST_STEPS  # (a): non-fused FSDP-2 == DP-2 bitwise after these
FSDP_PLAIN_ARGV = [a for a in DIST_ARGV if a != "--fused-update"]
FSDP_PLAIN_ARGV[FSDP_PLAIN_ARGV.index("--steps") + 1] = str(FSDP_PLAIN_STEPS)
# (e): 4 ranks, pods 2 x fsdp 2 with the bf16 pod wire over the FSDP inner
FSDP_POD_STEPS = 2
FSDP_POD_ARGV = ["--arch", "qwen2.5-3b", "--policy", "bf16_sr_kahan", "--fused-update",
                 "--batch", "8", "--seq", "512", "--grad-accum", "2",
                 "--steps", str(FSDP_POD_STEPS), "--lr", "3e-3", "--seed", "0",
                 "--device", "cuda", "--pods", "2", "--fsdp-parallel", "2",
                 "--grad-wire", "bf16", "--dist-backend", "gloo"]
FSDP_BYTES_BAR = 0.53      # (c): FSDP / DP state bytes per rank at most this
# (b): per leaf after step 1, |fused FSDP-2 - fused DP-2| / |fused DP-2 -
# init| of the Kahan-compensated weights w - c at most this. Both runs take
# that step from the same weights and gradients and differ only in their
# SR bits, which w - c sees only through c's bf16 rounding (2^-9 of the
# step); an update that skips, doubles or misroutes a shard reaches 0.7
FSDP_FUSED_DRIFT_BAR = 0.05


def kernel_module(name: str):
    """A kernel's module: its wrapper, plain version and ``LAUNCHES`` count
    (the ``repro_torch.kernels`` attribute of the same name is the wrapper
    function, as in the reference's package)."""
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def fail(msg: str):
    print(f"[smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(fns, calls: int = 64) -> float:
    """Device time per call: ``calls`` calls cycling over ``fns`` (one per
    input copy, so the working set exceeds the 50 MB L2 as it does between
    a layer's uses on the serving path), captured in a CUDA graph so host
    overhead is not measured, replayed and timed with CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def host_us(fn, calls: int = 200) -> float:
    """Host time per call to enqueue ``fn`` (Python, checks, launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def phase_card() -> str:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load_all(SOURCES)
    print(f"[build] {len(SOURCES)} kernel sources built and loaded in "
          f"{time.perf_counter() - t0:.2f}s wall (one nvcc per source, in parallel)")
    for name in SOURCES:
        info = _build.builds[name]
        print(f"[build] {name}: nvcc {info.seconds:.2f}s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")


def _inputs(Sc: int, seed: int, *, parked=(), window=None, softcap=None, hq=HQ, hkv=HKV,
            d=D, dtype=None):
    """Decode inputs on the card (bf16 unless ``dtype``): lane depths mixed
    over the cache; cells 0..depth hold positions, the rest are empty (−1)."""
    import torch
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    q = torch.randn((B, 1, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sc, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sc, hkv, d), generator=g, device=dev).to(dtype)
    depth = torch.linspace(Sc // 8, Sc - 1, B, device=dev).to(torch.int32)
    cells = torch.arange(Sc, device=dev, dtype=torch.int32)[None, :]
    k_pos = torch.where(cells <= depth[:, None], cells, -1).to(torch.int32).contiguous()
    q_pos = depth.clone()
    for lane in parked:
        q_pos[lane] = -1
    return dict(q=q, k=k, v=v, k_pos=k_pos, q_pos=q_pos, window=window, softcap=softcap)


def rms_ratio(got, want, q_pos) -> float:
    """The largest ratio, over the active lanes, of a lane's max |got − want|
    to the RMS of want in that lane."""
    active = q_pos >= 0
    err = (got - want)[active].abs().flatten(1).amax(1)
    return float((err / want[active].pow(2).flatten(1).mean(1).sqrt()).max())


def _bound_ms(x) -> tuple[float, str]:
    """Least time for this input: bytes of q, k_pos, q_pos and the K/V rows
    of unmasked cells of active lanes read once plus out written, against
    HBM; 4·D flops per (query head, unmasked cell) against bf16 peak."""
    kp, qp = x["k_pos"], x["q_pos"][:, None]
    ok = (kp >= 0) & (kp <= qp) & (qp >= 0)
    if x["window"] is not None:
        ok &= qp - kp < x["window"]
    n_cells = int(ok.sum())
    n_active = int((x["q_pos"] >= 0).sum())
    Sc = kp.shape[1]
    _, _, hq, d = x["q"].shape
    hkv, esz = x["k"].shape[2], x["q"].element_size()
    nbytes = (n_active * hq * d * esz + n_active * Sc * 4 + B * 4
              + n_cells * hkv * d * esz * 2 + B * hq * d * 4)
    flops = n_cells * hq * 4 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _special_inputs(Sc: int, seed: int) -> dict:
    """The cases the cluster kernel's range search must get right, on the
    serving shapes: Sc = 256 gives a ring cache (every lane past Sc, cell
    ``pos % Sc`` holding the newest position of its residue), without a
    window and with window 64 on every lane (inside the ring for lanes
    whose q_pos % Sc >= 63, across its end for the others); Sc = 2048 gives an
    active lane with no visible key (lane 2: empty cells, q_pos 100),
    window 64 at depth ~2000 and uneven depths (lane 0 at the view's end,
    the rest under 32 keys)."""
    import torch
    dev = torch.device("cuda")
    x = _inputs(Sc, seed)
    cells = torch.arange(Sc, device=dev, dtype=torch.int32)[None, :]
    if Sc == MAIN_SC:
        depth = torch.tensor([300, 1000, 1030, 1279, 511, 777, 2047, 4095],
                             dtype=torch.int32, device=dev)
        k_pos = depth[:, None] - (depth[:, None] - cells) % Sc
        return {"ring": dict(x, k_pos=k_pos.to(torch.int32).contiguous(), q_pos=depth),
                "ring, window 64": dict(x, k_pos=k_pos.to(torch.int32).contiguous(),
                                        q_pos=depth, window=64)}
    empty = x["k_pos"].clone()
    empty[2] = -1
    no_key = dict(x, k_pos=empty.contiguous(), q_pos=x["q_pos"].clone())
    no_key["q_pos"][2] = 100
    deep = torch.linspace(1990, Sc - 1, B, device=dev).to(torch.int32)
    uneven = torch.tensor([Sc - 1, 0, 3, 7, 12, 20, 31, 16], dtype=torch.int32, device=dev)
    return {"no visible key in lane 2": no_key,
            "window 64 at depth ~2000": dict(
                x, k_pos=torch.where(cells <= deep[:, None], cells, -1).to(torch.int32)
                .contiguous(), q_pos=deep, window=64),
            "uneven depths": dict(
                x, k_pos=torch.where(cells <= uneven[:, None], cells, -1).to(torch.int32)
                .contiguous(), q_pos=uneven)}


def _as_pages(x, seed: int) -> dict:
    """The view of contiguous decode inputs as a paged pool: each lane's
    Sc/PAGE pages on rows of a shuffled (B·Sc/PAGE)-row pool, so that
    ``pages[table]`` is the contiguous cache again."""
    import torch
    Bn, Sc = x["k_pos"].shape
    n = Sc // PAGE
    perm = torch.randperm(Bn * n, generator=torch.Generator().manual_seed(seed)).to("cuda")

    def pool(t):
        out = torch.empty((Bn * n, PAGE, *t.shape[2:]), dtype=t.dtype, device=t.device)
        out[perm] = t.reshape(Bn * n, PAGE, *t.shape[2:])
        return out
    return dict(q=x["q"], k=pool(x["k"]), v=pool(x["v"]), pos=pool(x["k_pos"]),
                table=perm.reshape(Bn, n).to(torch.int32), q_pos=x["q_pos"],
                window=x["window"], softcap=x["softcap"])


def phase_kernel(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA

    def call(fn, x):
        return fn(x["q"], x["k"], x["v"], x["k_pos"], x["q_pos"], window=x["window"],
                  softcap=x["softcap"], p_dtype=torch.bfloat16)

    def paged(fn, x):
        return fn(x["q"], x["k"], x["v"], x["pos"], x["table"], x["q_pos"],
                  window=x["window"], softcap=x["softcap"], p_dtype=torch.bfloat16)

    max_err, row = 0.0, None
    for Sc in (MAIN_SC, 2048):
        cases = {"mixed": _inputs(Sc, 0),
                 "parked": _inputs(Sc, 1, parked=(1, 5)),
                 "window+softcap": _inputs(Sc, 2, window=64, softcap=30.0),
                 **_special_inputs(Sc, 3)}
        for name, x in cases.items():
            got = call(DA.fused_decode_attention, x)
            again = call(DA.fused_decode_attention, x)
            want = call(DA.decode_attention_ref, x)
            pool = _as_pages(x, 4)
            got_paged = paged(DA.fused_paged_decode_attention, pool)
            again_paged = paged(DA.fused_paged_decode_attention, pool)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and got.shape == (B, 1, HQ, D),
                  f"kernel output {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"Sc={Sc} {name}: non-finite output")
            check(torch.equal(got, again) and torch.equal(got_paged, again_paged),
                  f"Sc={Sc} {name}: two calls on the same inputs differ")
            check(torch.equal(got_paged, got),
                  f"Sc={Sc} {name}: paged kernel != contiguous kernel on the same view")
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            ratio = rms_ratio(got, want, x["q_pos"])
            check(torch.allclose(got, want, atol=ATOL, rtol=RTOL) and ratio <= REL_RMS,
                  f"Sc={Sc} {name}: kernel vs plain max |err| {err}, {ratio} of a lane's RMS")
            for lane in range(B):
                if int(x["q_pos"][lane]) < 0:
                    check(bool((got[lane] == 0).all()),
                          f"Sc={Sc} parked lane {lane} is not exactly zero")
            print(f"[kernel] Sc={Sc} {name}: max |kernel - plain| {err:.3e} "
                  f"(atol=rtol={ATOL}), {ratio:.3e} of a lane's RMS (<= {REL_RMS}); "
                  f"both entry points equal, two calls equal")
            del pool
        # timing: the mixed-depth case, copies rotated past the L2
        x = cases["mixed"]
        kv_bytes = 2 * x["k"].numel() * x["k"].element_size()
        copies = [x] + [{n: t.clone() if hasattr(t, "clone") else t for n, t in x.items()}
                        for _ in range(-(-64 * 2**20 // kv_bytes) - 1)]
        ms = time_ms([lambda c=c: call(DA.fused_decode_attention, c) for c in copies])
        plain_ms = time_ms([lambda c=c: call(DA.decode_attention_ref, c) for c in copies])

        def sdpa(c):
            allowed = ((c["k_pos"] >= 0) & (c["k_pos"] <= c["q_pos"][:, None]))[:, None, None, :]
            qt, kt, vt = c["q"].transpose(1, 2), c["k"].transpose(1, 2), c["v"].transpose(1, 2)
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                          enable_gqa=True)
        library_ms = time_ms([sdpa(c) for c in copies])
        enqueue_us = host_us(lambda: call(DA.fused_decode_attention, x))
        bound_ms, bound_by = _bound_ms(x)
        print(f"[kernel] Sc={Sc} mixed depths on {card}: kernel {ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {library_ms:.4f} ms (device time, "
              f"{len(copies)} input copies rotated); host enqueue {enqueue_us:.1f} us "
              f"per kernel call")
        if Sc == MAIN_SC:
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
    row["max_abs_err"] = max_err
    return row


# recurrentgemma's attention group: 10 query heads on 1 kv head of D = 256
# (the decode kernels split it over two clusters of 5 rows), on its local
# window's 2048-key view
G10, G10_SC = dict(hq=10, hkv=1, d=256), 2048


def phase_kernel_g10(card: str) -> float:
    """The decode kernels at G = 10, D = 256 (recurrentgemma's local
    attention; ROADMAP C14): contiguous and paged, bf16 and f32, with and
    without window 64, two lanes parked — within atol = rtol = 1e-2 and 1%
    of each lane's RMS of the plain version, paged == contiguous on the
    gathered view and each twice equal (``torch.equal``), parked lanes
    zero, each head's output the bits of a call on its 5-head part of the
    group alone; then the bf16 kernel's time beside its bound, the plain
    version's and ``scaled_dot_product_attention``'s on the same view.
    Returns the largest |kernel − plain|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA

    def call(fn, x, q=None):
        return fn(x["q"] if q is None else q, x["k"], x["v"], x["k_pos"], x["q_pos"],
                  window=x["window"], p_dtype=x["q"].dtype)

    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for window in (None, 64):
            x = _inputs(G10_SC, 40, window=window, parked=(1, 6), **G10, dtype=dtype)
            got, again = call(DA.fused_decode_attention, x), call(DA.fused_decode_attention, x)
            want = call(DA.decode_attention_ref, x)
            part = call(DA.fused_decode_attention, x, x["q"][:, :, 5:].contiguous())
            pool = _as_pages(x, 41)
            paged = DA.fused_paged_decode_attention(
                pool["q"], pool["k"], pool["v"], pool["pos"], pool["table"], pool["q_pos"],
                window=window, p_dtype=dtype)
            torch.cuda.synchronize()
            tag = f"G=10 D=256 {str(dtype).split('.')[-1]} window {window}"
            check(got.shape == (B, 1, G10["hq"], G10["d"]) and bool(torch.isfinite(got).all()),
                  f"{tag}: output {tuple(got.shape)} or non-finite")
            check(torch.equal(got, again) and torch.equal(paged, got),
                  f"{tag}: two calls differ or paged != contiguous on the gathered view")
            check(torch.equal(part, got[:, :, 5:]),
                  f"{tag}: a head's output depends on the rest of its group")
            check(all(bool((got[lane] == 0).all()) for lane in (1, 6)),
                  f"{tag}: a parked lane is not exactly zero")
            err = float((got - want).abs().max())
            ratio = rms_ratio(got, want, x["q_pos"])
            check(torch.allclose(got, want, atol=ATOL, rtol=RTOL) and ratio <= REL_RMS,
                  f"{tag}: kernel vs plain max |err| {err}, {ratio} of a lane's RMS")
            max_err = max(max_err, err)
            print(f"[kernel-g10] {tag}: max |kernel - plain| {err:.3e} (atol=rtol={ATOL}), "
                  f"{ratio:.3e} of a lane's RMS; paged == contiguous, two calls equal, heads "
                  f"5-9 == a 5-head call, parked lanes 1, 6 zero")
            del pool
    x = _inputs(G10_SC, 42, **G10)
    kv_bytes = 2 * x["k"].numel() * x["k"].element_size()
    copies = [x] + [{n: t.clone() if hasattr(t, "clone") else t for n, t in x.items()}
                    for _ in range(-(-64 * 2**20 // kv_bytes) - 1)]
    ms = time_ms([lambda c=c: call(DA.fused_decode_attention, c) for c in copies])
    plain_ms = time_ms([lambda c=c: call(DA.decode_attention_ref, c) for c in copies], calls=16)

    def sdpa(c):
        allowed = ((c["k_pos"] >= 0) & (c["k_pos"] <= c["q_pos"][:, None]))[:, None, None, :]
        qt, kt, vt = c["q"].transpose(1, 2), c["k"].transpose(1, 2), c["v"].transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                      enable_gqa=True)
    library_ms = time_ms([sdpa(c) for c in copies])
    bound_ms, bound_by = _bound_ms(x)
    print(f"[kernel-g10] G=10 D=256 bf16, {B} lanes over {G10_SC} keys at mixed depths on "
          f"{card}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms (device "
          f"time, {len(copies)} input copies rotated)")
    return max_err


def run_launches(eng, name: str, counted: int) -> int:
    """Launches of kernel ``name`` that a serve run really made: its
    wrapper's count over the run (each step variant's eager first step and
    its capture) less the captures, plus each graph's replays times the
    launches it holds."""
    per = {w: g.kernels.get(name, 0) for w, g in eng.graphs.items()}
    return counted - sum(per.values()) + sum(g.replays * per[w] for w, g in eng.graphs.items())


def width_steps(eng, width: int, with_logits: bool = False) -> int:
    """Serve steps of one step variant: the eager first step, then replays."""
    g = eng.graphs.get((width, with_logits))
    return 0 if g is None else 1 + g.replays


def variant(key) -> str:
    """A step variant's name: its token width, and whether it returns the
    logits (an engine of a tree before sampling keys its steps by width)."""
    if isinstance(key, tuple):
        return f"width {key[0]}" + (" + logits" if key[1] else "")
    return f"width {key}"


def step_times(eng) -> dict:
    """Record the host wall of each serve-step call of ``eng`` by step
    variant (the call ends in the read of its tokens, a sync, after the
    sampler): {key: [seconds, ...]}, the variant's eager first step first.
    The wrapper holds the engine weakly, so dropping the engine frees it
    (its pool, graphs and the weights it holds) without waiting for the
    cycle collector."""
    import weakref
    times, ref, serve = {}, weakref.ref(eng), type(eng)._serve

    def timed(key, *args):
        t0 = time.perf_counter()
        out = serve(ref(), key, *args)
        times.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    eng._serve = timed
    return times


def width_ms(times: dict) -> str:
    """Mean ms per replayed step of each step variant (the eager first
    step and the capture left out)."""
    return ", ".join(f"{variant(k)}: {1e3 * sum(t[1:]) / max(len(t) - 1, 1):.2f} ms per "
                     f"replayed step over {len(t) - 1}" for k, t in sorted(times.items()))


SERVE_KERNELS = {"qmatmul": 7, "row_mean_sq": 2}   # per layer; one more row_mean_sq: the final norm


def step_kernels(cfg, decode: str) -> dict:
    """The hand-written kernel launches of one serve step: the decode (or
    paged) kernel once per layer, ``qmatmul`` for the seven products of a
    layer (q, k, v, o, gate, up, down), ``row_mean_sq`` under each of its
    two norms and the final one."""
    return {decode: cfg.n_layers, "qmatmul": SERVE_KERNELS["qmatmul"] * cfg.n_layers,
            "row_mean_sq": SERVE_KERNELS["row_mean_sq"] * cfg.n_layers + 1}


def graph_summary(eng) -> str:
    return "; ".join(f"{variant(k)}: 1 eager step + {g.replays} graph replays, "
                     f"{sum(g.kernels.values())} hand-written kernel launches per replay "
                     f"{dict(g.kernels)}" for k, g in sorted(eng.graphs.items()))


def serve_model():
    """Full-width qwen2.5-3b cut to ``SERVE_LAYERS`` with random weights from
    seed 0, on the card, under ``bf16_standard``: what both serving phases
    serve."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.models import registry as R

    policy = get_policy("bf16_standard")
    full = R.get_config("qwen2.5-3b")
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init(cfg, 0, policy.param_dtype, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[main] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers (depth cut for the "
          f"script's time), d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({policy.name}) initialised on the card "
          f"in {time.perf_counter() - t0:.2f}s; peak device memory during init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return params, cfg, policy


def _lanes_case(seed: int, rows: int):
    """A 32-token chunk of 8 lanes at full width as the serve step holds it:
    a contiguous cache of MAIN_SC cells per lane holding positions 0 ..
    depth+31 (the chunk's own K/V written), chunk row i of lane b at
    position depth_b + i; only the first ``rows`` chunk rows (all 256, or
    lane 0's first 8) as queries."""
    import torch
    g = _gen(seed)
    dev = torch.device("cuda")
    q = torch.randn((8, CHUNK, HQ, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((8, MAIN_SC, HKV, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((8, MAIN_SC, HKV, D), generator=g, device=dev).to(torch.bfloat16)
    depth = torch.tensor([0, 5, 17, 40, 77, 100, 150, 200], dtype=torch.int32, device=dev)
    q_pos = depth[:, None] + torch.arange(CHUNK, dtype=torch.int32, device=dev)[None]
    q_pos[7, 20:] = -1                                  # chunk padding: zeros
    cells = torch.arange(MAIN_SC, dtype=torch.int32, device=dev)[None]
    k_pos = torch.where(cells <= q_pos.amax(1, keepdim=True), cells, -1).contiguous()
    if rows < 8 * CHUNK:
        q, q_pos = q[:1, :rows], q_pos[:1, :rows]
    return q.contiguous(), k, v, k_pos, q_pos.contiguous()


def phase_row_probe(card: str, params, cfg, policy) -> dict:
    """ROADMAP C10: every op of one serve-step layer on the kernel route at
    8 rows and at 256 rows (a chunk-32 step of 8 lanes), torch.equal on the
    leading 8 rows; ``torch.mean``'s RMSNorm and cuBLAS's product beside
    them, reported only. ``row_mean_sq`` against its plain version and its
    time."""
    import torch
    from repro_torch.core.qarith import QArith
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MO
    from repro_torch.models import transformer as T
    DA, QM, RM = (kernel_module(k) for k in ("decode_attention", "qmatmul", "row_mean_sq"))
    qa = QArith(policy)
    p = T._layer(params["layers"]["b0"], 0)
    Mx, dm, dff = 8 * CHUNK, cfg.d_model, cfg.d_ff
    g = _gen(20)

    def bf(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    x, y, gate, up = bf(Mx, dm), bf(Mx, dm), bf(Mx, dff, scale=3.0), bf(Mx, dff)
    h = bf(Mx, dff)
    pos = torch.arange(Mx, dtype=torch.int32, device="cuda")[None] * 3
    qh = bf(1, Mx, HQ, D)
    scale = p["ln1"]["scale"]
    bias = p["mixer"]["wq"]["bias"]

    def rows(fn, *args):
        """fn on the leading 8 rows alone == fn on all rows, cut to 8."""
        return torch.equal(fn(*(a[:8] for a in args)), fn(*args)[:8])

    with dispatch.fused_decode():
        checked = {
            "rmsnorm (row_mean_sq)": rows(lambda t: L.norm_apply(qa, "rms", p["ln1"], t), x),
            "rope": torch.equal(L.rope(qh[:, :8], pos[:, :8], cfg.rope_theta),
                                L.rope(qh, pos, cfg.rope_theta)[:, :8]),
            "silu * mul": rows(lambda a, b: qa.mul(qa.silu(a), b), gate, up),
            "bias add": rows(lambda t: qa.add(t, bias), y),
            "residual add": rows(lambda a, b: qa.add(a, b), x, y),
            "qmatmul (wq, gate, down)": all(
                rows(lambda t, w=w: QM.qmatmul(t, w), t) for t, w in
                ((x, p["mixer"]["wq"]["kernel"]), (x, p["ffn"]["w_gate"]),
                 (h, p["ffn"]["w_down"]))),
            "dense layer (wq, bias)": rows(lambda t: L.dense(qa, p["mixer"]["wq"], t), x),
            "mlp": rows(lambda t: MO.mlp_apply(qa, p["ffn"], t), x),
        }
        # the decode kernels with the chunk's rows as lanes
        full = _lanes_case(30, 8 * CHUNK)
        part = _lanes_case(30, 8)
        out_full = L.attention_as_lanes(*full, p_dtype=torch.bfloat16)
        out_part = L.attention_as_lanes(*part, p_dtype=torch.bfloat16)
        checked["decode kernel, rows as lanes"] = torch.equal(out_part[0], out_full[0, :8])
        q, k, v, k_pos, q_pos = full
        single = True
        for i in range(CHUNK):          # lane 0's rows == single-token calls at their depth
            kp_i = torch.where(k_pos[:1] <= q_pos[0, i], k_pos[:1], -1).contiguous()
            one = DA.fused_decode_attention(q[:1, i:i + 1].contiguous(), k[:1].contiguous(),
                                            v[:1].contiguous(), kp_i, q_pos[:1, i])
            single &= torch.equal(one[0, 0], out_full[0, i])
        checked["decode kernel rows == single-token calls"] = single
        checked["padding rows exactly zero"] = bool((out_full[7, 20:] == 0).all())
        pool = _as_pages(dict(q=q, k=k, v=v, k_pos=k_pos, q_pos=q_pos, window=None,
                              softcap=None), 31)
        paged = L.paged_attention_as_lanes(q, pool["k"], pool["v"], pool["pos"],
                                           pool["table"], q_pos, p_dtype=torch.bfloat16)
        checked["paged kernel, rows as lanes == contiguous"] = torch.equal(paged, out_full)
    # off the kernel route: torch.mean's RMSNorm and cuBLAS's products at
    # more row counts, each against the same rows of a 4096-row call
    xl, hl = bf(4096, dm), bf(4096, dff)
    counts = (1, 3, 8, 24, 64, 256, 1024)

    def same_rows(fn, t):
        full = fn(t)
        return [M for M in counts if not torch.equal(fn(t[:M]), full[:M])]
    reported = {"rmsnorm (torch.mean)": same_rows(lambda t: qa.rmsnorm(t, scale), xl)}
    for name, w, t in (("wq", p["mixer"]["wq"]["kernel"], xl),
                       ("wk", p["mixer"]["wk"]["kernel"], xl),
                       ("gate", p["ffn"]["w_gate"], xl), ("down", p["ffn"]["w_down"], hl)):
        reported[f"cuBLAS {name} (QArith.einsum)"] = same_rows(
            lambda a, w=w: qa.einsum("...d,df->...f", a, w), t)
    del xl, hl
    print(f"[probe] row independence at 8 vs {Mx} rows on {card} (torch.equal on the leading "
          f"8 rows): " + "; ".join(f"{k} {v}" for k, v in checked.items()))
    print(f"[probe] off the kernel route, reported only: the row counts of {counts} at "
          f"which the leading rows differ from a 4096-row call's: "
          + "; ".join(f"{k} {v or 'none'}" for k, v in reported.items()))
    bad = [k for k, v in checked.items() if not v]
    check(not bad, f"ops whose rows depend on the row count: {bad}")

    # row_mean_sq against its plain version, and its time
    for shape, dtype in (((8, dm), torch.bfloat16), ((Mx, dm), torch.bfloat16),
                         ((Mx, dm), torch.float32), ((5, 77), torch.bfloat16)):
        t = (torch.randn(shape, generator=g, device="cuda") * 4).to(dtype)
        check(torch.equal(RM.row_mean_sq(t), RM.row_mean_sq_ref(t)),
              f"row_mean_sq {shape} {dtype}: kernel != plain")
    print("[probe] row_mean_sq == plain (torch.equal) at 8 and 256 rows of 2048 (bf16, f32) "
          "and 5 rows of 77")
    row = None
    for M in (8, Mx):
        t = x[:M].contiguous()
        ms = time_ms([lambda t=t: RM.row_mean_sq(t)])
        plain_ms = time_ms([lambda t=t: RM.row_mean_sq_ref(t)], calls=16)
        torch_ms = time_ms([lambda t=t: torch.mean(torch.square(t.float()), -1, keepdim=True)])
        bound_ms = (t.numel() * 2 + M * 4) / HBM_BYTES_PER_S * 1e3
        print(f"[probe] row_mean_sq {M}x{dm} bf16 on {card}: kernel {ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms (bytes), plain {plain_ms:.4f} ms, torch.mean(square) "
              f"{torch_ms:.4f} ms (two calls, reported only; no single call computes it)")
        if M == 8:
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                   "library_ms": None, "max_abs_err": 0.0}
    return row


def main_stream(vocab: int):
    """12 requests from the synthetic stream (seed 0, Poisson 1.0 per step,
    prompts 16–64, generations 16–48): the contiguous serving cell."""
    import numpy as np
    from repro_torch.launch.serve import synthetic_stream
    return synthetic_stream(np.random.default_rng(0), 12, rate=1.0, prompt_lens=(16, 64),
                            gen_lens=(16, 48), vocab=vocab)


def phase_main_path(card: str, params, cfg, policy) -> tuple:
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_stream
    from repro_torch.serve.decode import generate
    from repro_torch.serve.engine import Engine

    n_slots, max_len = 8, MAIN_SC

    def engine():
        return Engine(params, cfg, policy, n_slots=n_slots, max_len=max_len,
                      fused_decode=True, device="cuda")

    warm = engine()                      # cuBLAS handles, kernel library load
    warm.submit(np.arange(4, dtype=np.int32), 2)
    warm.run()
    del warm

    stream = main_stream(cfg.vocab)
    # the eager step (no graphs) first: its time, and its tokens
    eager = engine()
    eager._use_graphs = False
    res = serve_stream(eager, stream)
    eager_tokens = {c.rid: c.tokens for c in res.completions}
    print(f"[main] eager step (no CUDA graph) on {card}: {res.calls} serve-step calls, "
          f"{eager.stats.tokens_generated} tokens in {res.seconds:.3f}s -> "
          f"{eager.stats.tokens_generated / res.seconds:.1f} tok/s, "
          f"{1e3 * res.seconds / res.calls:.2f} ms per serve step")
    del eager
    eng = engine()
    QM, RM = kernel_module("qmatmul"), kernel_module("row_mean_sq")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DA.LAUNCHES = QM.LAUNCHES = RM.LAUNCHES = 0
    times = step_times(eng)
    res = serve_stream(eng, stream)
    counted = {"decode_attention": DA.LAUNCHES, "qmatmul": QM.LAUNCHES,
               "row_mean_sq": RM.LAUNCHES}
    launches = {k: run_launches(eng, k, n) for k, n in counted.items()}
    st = eng.stats
    check(st.finished == len(stream) == len(res.completions),
          f"{st.finished}/{len(stream)} requests finished")
    check(set(eng.graphs) == {(1, False)} and width_steps(eng, 1) == res.calls,
          f"serve steps {res.calls}, graphs {eng.graphs} (greedy: no logits graph)")
    per_step = step_kernels(cfg, "decode_attention")
    check(eng.graphs[1, False].kernels == per_step,
          f"the step's graph holds {eng.graphs[1, False].kernels}, expected {per_step}")
    for k, n in per_step.items():
        check(launches[k] == n * res.calls,
              f"{k} launches {launches[k]} != {n} x {res.calls} serve-step calls")
    check(all(c.tokens.size == gen for c, (_, _, gen) in zip(
        sorted(res.completions, key=lambda c: c.rid), stream)),
          "a request stopped short of its max_new_tokens")
    for c in res.completions:
        check(np.array_equal(c.tokens, eager_tokens[c.rid]),
              f"rid {c.rid}: graph {c.tokens.tolist()} != eager step "
              f"{eager_tokens[c.rid].tolist()}")
    print(f"[main] on {card}: {len(stream)} requests, {st.steps} engine steps, "
          f"{res.calls} serve-step calls, {st.tokens_generated} tokens in "
          f"{res.seconds:.3f}s -> {st.tokens_generated / res.seconds:.1f} tok/s, "
          f"{1e3 * res.seconds / res.calls:.2f} ms per serve step ({width_ms(times)}), "
          f"kernel launches "
          f"{launches} ({ {k: n // res.calls for k, n in launches.items()} } per step); "
          f"{graph_summary(eng)}; tokens == the eager step's for all "
          f"{len(res.completions)} requests")

    # the reference: lock-step generate through the same kernel on the
    # MAIN_GENERATE shortest requests (each prompt token is an eager step),
    # each batch padded with dummy prompts to the engine's row count
    # (cuBLAS picks its GEMM by the row count, so rows agree bitwise only
    # at equal counts)
    groups = {}
    for c in sorted(res.completions,
                    key=lambda c: (c.prompt.size + c.tokens.size, c.rid))[:MAIN_GENERATE]:
        groups.setdefault((c.prompt.size, c.tokens.size), []).append(c)
    with dispatch.fused_decode():
        for (s0, gen), cs in groups.items():
            rows = [c.prompt for c in cs]
            rows += [np.zeros(s0, np.int32)] * (n_slots - len(rows))
            ref = generate(params, cfg, policy, np.stack(rows), max_new_tokens=gen,
                           cache_len=max_len, device="cuda").cpu().numpy()
            for i, c in enumerate(cs):
                check(np.array_equal(ref[i, s0:], c.tokens),
                      f"rid {c.rid}: engine {c.tokens.tolist()} != generate "
                      f"{ref[i, s0:].tolist()}")
    toks = np.concatenate([c.tokens for c in res.completions])
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of vocab")
    print(f"[main] engine tokens == generate tokens for the {MAIN_GENERATE} shortest of "
          f"{len(res.completions)} requests ({len(groups)} reference batches of {n_slots} "
          f"rows)")

    # ROADMAP C10: the same stream with chunked prefill gives the same tokens
    want = {c.rid: c.tokens for c in res.completions}
    greedy = {"tokens": want, "tok_s": st.tokens_generated / res.seconds,
              "ms": 1e3 * sum(times[1, False][1:]) / (len(times[1, False]) - 1)}
    chunked = Engine(params, cfg, policy, n_slots=n_slots, max_len=max_len,
                     fused_decode=True, prefill_chunk=CHUNK, device="cuda")
    times = step_times(chunked)
    DA.LAUNCHES = 0
    res32 = serve_stream(chunked, stream)
    check(set(chunked.graphs) == {(1, False), (CHUNK, False)}
          and width_steps(chunked, 1) + width_steps(chunked, CHUNK) == res32.calls,
          f"chunked run: {res32.calls} serve steps, graphs {chunked.graphs}")
    check(run_launches(chunked, "decode_attention", DA.LAUNCHES) == cfg.n_layers * res32.calls,
          f"chunked run: decode launches != {cfg.n_layers} x {res32.calls} serve steps")
    check(chunked.stats.steps < st.steps,
          f"chunked prefill took {chunked.stats.steps} steps, chunk 1 took {st.steps}")
    got = {c.rid: c.tokens for c in res32.completions}
    check(got.keys() == want.keys(), f"chunked run finished {sorted(got)}")
    for rid in want:
        check(np.array_equal(got[rid], want[rid]),
              f"rid {rid}: chunk {CHUNK} {got[rid].tolist()} != chunk 1 {want[rid].tolist()}")
    print(f"[main] contiguous + chunked prefill {CHUNK} on {card}: {chunked.stats.steps} "
          f"engine steps, {res32.calls} serve-step calls, {chunked.stats.tokens_generated} "
          f"tokens in {res32.seconds:.3f}s -> {chunked.stats.tokens_generated / res32.seconds:.1f} "
          f"tok/s, {1e3 * res32.seconds / res32.calls:.2f} ms per serve step "
          f"({width_ms(times)}); {graph_summary(chunked)}; tokens == the chunk-1 run's for "
          f"all {len(want)} requests")
    del chunked
    print(f"[main] peak device memory while serving and checking "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    return launches, eng, greedy


def _paged_inputs(n_blocks: int, seed: int, *, window=None, softcap=None):
    """A paged pool on the card for B lanes with views of n_blocks pages:
    lane depths mixed over the view, each lane's pages on shuffled rows,
    lanes 0 and 1 sharing their first two (full) pages, unmapped blocks
    trailing on the null row R−1 (positions −1), lanes 3 and 6 parked."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    Sc = n_blocks * PAGE
    R = B * n_blocks + 1
    q = torch.randn((B, 1, HQ, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((R, PAGE, HKV, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((R, PAGE, HKV, D), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((R, PAGE), -1, dtype=torch.int32, device=dev)
    depth = torch.linspace(max(Sc // 8, 2 * PAGE), Sc - 1, B).to(torch.int32).tolist()
    table = torch.full((B, n_blocks), R - 1, dtype=torch.int32)
    rows = torch.randperm(R - 1, generator=torch.Generator().manual_seed(seed)).tolist()
    cells = torch.arange(PAGE, dtype=torch.int32, device=dev)
    for lane in range(B):
        for blk in range(depth[lane] // PAGE + 1):
            if lane == 1 and blk < 2:
                table[1, blk] = table[0, blk]          # shared prefix page
                continue
            r = rows.pop()
            table[lane, blk] = r
            pos[r] = torch.where(blk * PAGE + cells <= depth[lane], blk * PAGE + cells, -1)
    q_pos = torch.tensor(depth, dtype=torch.int32, device=dev)
    q_pos[3] = q_pos[6] = -1
    return dict(q=q, k=k, v=v, pos=pos, table=table.to(dev), q_pos=q_pos, window=window,
                softcap=softcap)


def _paged_bound_ms(x) -> tuple[float, str]:
    """Least time for this input: q, the table rows and the positions of
    the views of active lanes, q_pos, the distinct K/V cells some active
    lane can see (a shared page is one input) read once, the f32 output
    written once, over HBM; 4·D flops per (query head, visible cell) of
    each lane against the bf16 peak. The shapes are the input's."""
    import torch
    B, _, HQ, D = x["q"].shape
    HKV = x["k"].shape[2]
    active = x["q_pos"] >= 0
    table = x["table"][active].long()
    kp = x["pos"][table].reshape(table.shape[0], -1)
    qp = x["q_pos"][active][:, None]
    ok = (kp >= 0) & (kp <= qp)
    if x["window"] is not None:
        ok &= qp - kp < x["window"]
    cell = (table[:, :, None] * PAGE + torch.arange(PAGE, device=table.device)).reshape(
        table.shape[0], -1)
    n_cells = int(cell[ok].unique().numel())
    n_active = int(active.sum())
    nbytes = (n_active * HQ * D * 2 + table.numel() * 4 + int(table.unique().numel()) * PAGE * 4
              + B * 4 + n_cells * HKV * D * 2 * 2 + B * HQ * D * 4)
    flops = int(ok.sum()) * HQ * 4 * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_paged(card: str) -> dict:
    """The paged kernel ≡ the contiguous kernel on the gathered view
    (bitwise), within 1e-2 of its plain version and within REL_RMS of each
    lane's RMS; its time beside its bound,
    the plain version's and SDPA's on the pre-gathered view."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA

    def paged(fn, x):
        return fn(x["q"], x["k"], x["v"], x["pos"], x["table"], x["q_pos"],
                  window=x["window"], softcap=x["softcap"], p_dtype=torch.bfloat16)

    def view(t, x):
        return DA._gather_view(t, x["table"]).contiguous()

    max_err, row = 0.0, None
    for n_blocks in (256 // PAGE, PAGED_MAX_LEN // PAGE, 4096 // PAGE, LONG_VIEW // PAGE):
        Sc = n_blocks * PAGE
        cases = {"shared+null+parked": _paged_inputs(n_blocks, 10),
                 "window+softcap": _paged_inputs(n_blocks, 11, window=64, softcap=30.0)}
        for name, x in cases.items():
            got = paged(DA.fused_paged_decode_attention, x)
            again = paged(DA.fused_paged_decode_attention, x)
            want = paged(DA.paged_decode_attention_ref, x)
            contiguous = DA.fused_decode_attention(
                x["q"], view(x["k"], x), view(x["v"], x), view(x["pos"], x), x["q_pos"],
                window=x["window"], softcap=x["softcap"], p_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and got.shape == (B, 1, HQ, D),
                  f"paged kernel output {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"view {Sc} {name}: non-finite output")
            check(torch.equal(got, contiguous),
                  f"view {Sc} {name}: paged kernel != contiguous kernel on the gathered view")
            check(torch.equal(got, again), f"view {Sc} {name}: two calls on the same inputs differ")
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            ratio = rms_ratio(got, want, x["q_pos"])
            check(torch.allclose(got, want, atol=ATOL, rtol=RTOL) and ratio <= REL_RMS,
                  f"view {Sc} {name}: paged kernel vs plain max |err| {err}, {ratio} of a "
                  f"lane's RMS")
            for lane in (3, 6):
                check(bool((got[lane] == 0).all()), f"view {Sc}: parked lane {lane} not zero")
            print(f"[kernel-paged] view {Sc} keys {name}: paged kernel == contiguous kernel "
                  f"on pages[block_table] and == itself on a second call (torch.equal); "
                  f"max |kernel - plain| {err:.3e} (atol=rtol={ATOL}), {ratio:.3e} of a "
                  f"lane's RMS (<= {REL_RMS}); parked lanes 3, 6 exactly zero")
        x = cases["shared+null+parked"]
        kv_bytes = 2 * x["k"].numel() * x["k"].element_size()
        copies = [x] + [{n: t.clone() if hasattr(t, "clone") else t for n, t in x.items()}
                        for _ in range(-(-64 * 2**20 // kv_bytes) - 1)]
        ms = time_ms([lambda c=c: paged(DA.fused_paged_decode_attention, c) for c in copies])
        plain_ms = time_ms([lambda c=c: paged(DA.paged_decode_attention_ref, c)
                            for c in copies])

        def sdpa(c):
            kv = view(c["pos"], c)
            allowed = ((kv >= 0) & (kv <= c["q_pos"][:, None]))[:, None, None, :]
            qt = c["q"].transpose(1, 2)
            kt, vt = view(c["k"], c).transpose(1, 2), view(c["v"], c).transpose(1, 2)
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                          enable_gqa=True)
        library_ms = time_ms([sdpa(c) for c in copies])
        enqueue_us = host_us(lambda: paged(DA.fused_paged_decode_attention, x))
        bound_ms, bound_by = _paged_bound_ms(x)
        print(f"[kernel-paged] view {Sc} keys on {card}: kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention on the pre-gathered view {library_ms:.4f} ms "
              f"(device time, {len(copies)} input copies rotated); host enqueue "
              f"{enqueue_us:.1f} us per kernel call")
        if Sc == PAGED_MAX_LEN:
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
        del copies, cases, x
    row["max_abs_err"] = max_err
    return row


def paged_stream(vocab: int):
    """16 requests from the synthetic stream (seed 0, Poisson 1.0 per step,
    prompts 32–256, generations 16–64); 3 in 4 prompts are cut to start
    with one common 128-token prefix (8 pages) and keep at least 8 tokens
    of their own."""
    import numpy as np
    from repro_torch.launch.serve import synthetic_stream
    draws = synthetic_stream(np.random.default_rng(0), 16, rate=1.0, prompt_lens=(32, 256),
                             gen_lens=(16, 64), vocab=vocab)
    common = np.random.default_rng(1).integers(0, vocab, 128).astype(np.int32)
    return [(t, np.concatenate([common, p[:max(p.size - 128, 8)]]) if i % 4 != 3 else p, g)
            for i, (t, p, g) in enumerate(draws)]


def phase_serve_paged(card: str, params, cfg, policy) -> tuple:
    """The paged engine at full width: launches, prefix hits, preemption,
    pool invariants, tokens == the contiguous engine's; then chunked."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.launch.serve import serve_stream
    from repro_torch.serve.engine import Engine

    n_slots = 8
    stream = paged_stream(cfg.vocab)
    print(f"[serve-paged] stream: {len(stream)} requests, prompts "
          f"{[p.size for _, p, _ in stream]}, generations {[g for _, _, g in stream]}, "
          f"arrival steps {[t for t, _, _ in stream]}")

    def engine(**kw):
        return Engine(params, cfg, policy, n_slots=n_slots, max_len=PAGED_MAX_LEN,
                      fused_decode=True, device="cuda", **kw)

    def report(tag, eng, res):
        st = eng.stats
        print(f"[serve-paged] {tag} on {card}: {st.finished}/{len(stream)} finished, "
              f"{st.steps} engine steps, {res.calls} serve-step calls, {st.tokens_generated} "
              f"tokens in {res.seconds:.3f}s -> {st.tokens_generated / res.seconds:.1f} tok/s, "
              f"{1e3 * res.seconds / res.calls:.2f} ms per serve step; pool "
              f"{eng.pool.nbytes() / 2**20:.1f} MiB, {st.kv_pages_live} pages live at drain, "
              f"{st.preemptions} preemptions, {st.prefix_hits} prefix hits, "
              f"{st.prefix_tokens_reused} prefix tokens skipped"
              + (f"; {graph_summary(eng)}" if eng.graphs else ""))

    def tokens(res):
        check(len(res.completions) == len(stream), f"{len(res.completions)} completions")
        out = {c.rid: c.tokens for c in res.completions}
        for rid, (_, _, gen) in enumerate(stream):
            check(out[rid].size == gen, f"rid {rid} stopped short of {gen} tokens")
        return out

    paged_kw = dict(paged=True, page_size=PAGE, n_pages=PAGED_N_PAGES)
    warm = engine(**paged_kw)
    warm.submit(np.arange(4, dtype=np.int32), 2)
    warm.run()
    del warm
    eager = engine(**paged_kw)
    eager._use_graphs = False
    res = serve_stream(eager, stream)
    report("paged, eager step (no CUDA graph)", eager, res)
    eager_tok = tokens(res)
    eager_steps = eager.stats.steps
    del eager
    eng = engine(**paged_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DA.PAGED_LAUNCHES = 0
    times = step_times(eng)
    res = serve_stream(eng, stream)
    launches = run_launches(eng, "paged_decode_attention", DA.PAGED_LAUNCHES)
    report(f"paged (page {PAGE}, {PAGED_N_PAGES} pages, prefix cache, chunk 1)", eng, res)
    paged_tok = tokens(res)
    st = eng.stats
    greedy = {"tokens": paged_tok, "tok_s": st.tokens_generated / res.seconds,
              "ms": 1e3 * sum(times[1, False][1:]) / (len(times[1, False]) - 1)}
    check(st.steps == eager_steps, f"{st.steps} steps, the eager step took {eager_steps}")
    for rid in paged_tok:
        check(np.array_equal(paged_tok[rid], eager_tok[rid]),
              f"rid {rid}: graph {paged_tok[rid].tolist()} != eager {eager_tok[rid].tolist()}")
    check(set(eng.graphs) == {(1, False)} and width_steps(eng, 1) == res.calls,
          f"serve steps {res.calls}, graphs {eng.graphs} (greedy: no logits graph)")
    check(launches == cfg.n_layers * res.calls,
          f"paged kernel launches {launches} != {cfg.n_layers} x {res.calls} serve steps")
    check(st.preemptions >= 1, "the paged run never preempted")
    check(st.prefix_hits >= 1, "the paged run had no prefix hit")
    eng.pool.check_invariants()
    cached = eng.pool.n_cached_pages
    check(st.kv_pages_live == cached, f"{st.kv_pages_live} pages live at drain, "
          f"{cached} held by the prefix index")
    eng.pool.clear_prefix()
    check(eng.pool.n_live_pages == 0, f"{eng.pool.n_live_pages} pages live after clear_prefix")
    eng.pool.check_invariants()
    print(f"[serve-paged] pool invariants hold at drain; {cached} index-held pages, none "
          f"live after clear_prefix; {launches} paged kernel launches ({cfg.n_layers} per "
          f"serve step); graph tokens and steps == the eager step's for all "
          f"{len(paged_tok)} requests; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    del eng

    contiguous = engine()
    DA.LAUNCHES = 0
    res = serve_stream(contiguous, stream)
    report("contiguous reference (max_len 1024, chunk 1)", contiguous, res)
    check(run_launches(contiguous, "decode_attention", DA.LAUNCHES) == cfg.n_layers * res.calls,
          "contiguous reference launches")
    want = tokens(res)
    for rid in want:
        check(np.array_equal(paged_tok[rid], want[rid]),
              f"rid {rid}: paged {paged_tok[rid].tolist()} != contiguous {want[rid].tolist()}")
    print(f"[serve-paged] paged tokens == contiguous tokens for all {len(want)} requests")
    del contiguous

    chunked = engine(prefill_chunk=CHUNK, **paged_kw)
    times = step_times(chunked)
    DA.PAGED_LAUNCHES = 0
    res = serve_stream(chunked, stream)
    report(f"paged + chunked prefill {CHUNK}", chunked, res)
    check(set(chunked.graphs) == {(1, False), (CHUNK, False)}
          and width_steps(chunked, 1) + width_steps(chunked, CHUNK) == res.calls,
          f"chunked run: {res.calls} serve steps, graphs {chunked.graphs}")
    chunk_launches = run_launches(chunked, "paged_decode_attention", DA.PAGED_LAUNCHES)
    check(chunk_launches == cfg.n_layers * res.calls,
          f"chunked run: {chunk_launches} paged launches != {cfg.n_layers} x {res.calls} "
          f"serve steps (both widths)")
    check(chunked.stats.steps < st.steps,
          f"chunked prefill took {chunked.stats.steps} steps, chunk 1 took {st.steps}")
    got = tokens(res)
    chunked.pool.check_invariants()
    del chunked
    for rid in want:
        check(np.array_equal(got[rid], want[rid]),
              f"rid {rid}: chunk {CHUNK} {got[rid].tolist()} != chunk 1 {want[rid].tolist()}")
    print(f"[serve-paged] chunked prefill {CHUNK} on {card}: {width_ms(times)}; "
          f"{chunk_launches} paged launches ({cfg.n_layers} per step at both widths); tokens "
          f"== the chunk-1 run's for all {len(want)} requests")
    chunk_probe(params, cfg, policy, stream)
    return launches, engine(**paged_kw), greedy


def sampler_events(eng) -> list:
    """Record CUDA events around each call of ``eng``'s device sampler
    (held weakly, as ``step_times`` holds the engine)."""
    import weakref
    import torch
    events, ref, sample = [], weakref.ref(eng), type(eng)._sample

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sample(ref(), *args)
        end.record()
        events.append((start, end))
        return out
    eng._sample = timed
    return events


def phase_sample(card: str, params, cfg, policy, greedy: dict) -> int:
    """Sampled serving at full width: every other request of the serve and
    serve-paged streams samples (``SAMPLING``), the rest stay greedy.
    (a) the greedy requests' tokens == the greedy-only runs'; (b) a fresh
    engine reproduces every sampled request, another seed changes one;
    (c) tight pages with ``prefill_chunk=32`` == roomy pages with chunk 1;
    (d) one real logits row, ``SAMPLE_DRAWS`` draws: the card's sampler ==
    the CPU plain path on ≥ 99.9%, frequencies within 5σ of the exact
    filtered softmax, nothing outside the support; (e) ms per replayed
    step of each (width, with_logits), the sampler's ms per step, tok/s
    beside the greedy stream's, device memory after capture. Returns the
    Philox fill's launches on the main path (the serve stream's mixed run)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve_stream
    from repro_torch.serve.engine import Engine
    PH = kernel_module("philox")

    def knobs(seed):
        return lambda i: dict(SAMPLING, seed=seed) if i % 2 else {}

    cells = {"serve": (dict(max_len=MAIN_SC), main_stream(cfg.vocab)),
             "serve-paged": (dict(max_len=PAGED_MAX_LEN, paged=True, page_size=PAGE,
                                  n_pages=PAGED_N_PAGES), paged_stream(cfg.vocab))}

    def run(cell, seed, **kw):
        base, stream = cells[cell]
        eng = Engine(params, cfg, policy, n_slots=8, fused_decode=True, device="cuda",
                     **{**base, **kw})
        times, sampler = step_times(eng), sampler_events(eng)
        res = serve_stream(eng, stream, knobs(seed))
        out = {c.rid: c.tokens for c in res.completions}
        check(len(out) == len(stream) and all(out[i].size == g for i, (_, _, g)
                                              in enumerate(stream)),
              f"[sample] {cell}: {len(out)}/{len(stream)} requests finished in full")
        return out, eng, res, times, sampler

    launches = 0
    main = {}
    for cell in cells:
        stream = cells[cell][1]
        sampled = [i for i in range(len(stream)) if i % 2]
        torch.cuda.synchronize()
        PH.LAUNCHES = 0
        out, eng, res, times, sampler = run(cell, SAMPLING["seed"])
        fills = PH.LAUNCHES
        if cell == "serve":
            launches = fills
        torch.cuda.synchronize()
        mem = (torch.cuda.memory_allocated() / 2**30, torch.cuda.memory_reserved() / 2**30)
        st = eng.stats
        keys = set(eng.graphs)
        check({(1, False), (1, True)} <= keys and all(w == 1 for w, _ in keys),
              f"[sample] {cell}: graphs {sorted(keys)}, expected width 1 with and without "
              f"the logits")
        check(fills >= sum(stream[i][2] for i in sampled),
              f"[sample] {cell}: {fills} Philox fills for "
              f"{sum(stream[i][2] for i in sampled)} sampled tokens")
        # (a) greedy requests keep the greedy-only run's tokens
        for rid in range(len(stream)):
            if rid % 2 == 0:
                check(np.array_equal(out[rid], greedy[cell]["tokens"][rid]),
                      f"[sample] {cell} rid {rid}: greedy tokens beside sampling lanes "
                      f"{out[rid].tolist()} != the greedy-only run's "
                      f"{greedy[cell]['tokens'][rid].tolist()}")
        check(any(not np.array_equal(out[r], greedy[cell]["tokens"][r]) for r in sampled),
              f"[sample] {cell}: every sampled request gave the greedy tokens")
        sampler_ms = [a.elapsed_time(b) for a, b in sampler]
        main[cell] = out
        print(f"[sample] {cell} on {card}: {len(stream)} requests, {len(sampled)} sampled "
              f"(temperature {SAMPLING['temperature']}, top_k {SAMPLING['top_k']}, top_p "
              f"{SAMPLING['top_p']}, seed {SAMPLING['seed']}); {st.steps} engine steps, "
              f"{res.calls} serve-step calls, {st.tokens_generated} tokens in "
              f"{res.seconds:.3f}s -> {st.tokens_generated / res.seconds:.1f} tok/s (greedy "
              f"stream: {greedy[cell]['tok_s']:.1f} tok/s, {greedy[cell]['ms']:.2f} ms per "
              f"replayed width-1 step); {width_ms(times)}; sampler "
              f"{sorted(sampler_ms)[len(sampler_ms) // 2]:.3f} ms per sampling step (median, "
              f"CUDA events; the first, {sampler_ms[0]:.3f} ms, loads its kernels; "
              f"{len(sampler_ms)} steps, {fills} Philox fills); {graph_summary(eng)}; "
              f"device memory after capture {mem[0]:.2f} GiB allocated, {mem[1]:.2f} GiB "
              f"reserved (the logits buffer: 8 x {cfg.vocab} x 4 B = "
              f"{8 * cfg.vocab * 4 / 2**20:.1f} MiB); (a) greedy tokens == the greedy-only "
              f"run's for all {len(stream) - len(sampled)} greedy requests")
        # (b) a fresh engine reproduces the sampled tokens
        again = run(cell, SAMPLING["seed"])[0]
        for rid in sampled:
            check(np.array_equal(again[rid], out[rid]),
                  f"[sample] {cell} rid {rid}: a second engine drew {again[rid].tolist()}, "
                  f"the first {out[rid].tolist()}")
        other = run(cell, SAMPLING["seed"] + 1)[0]
        changed = sum(not np.array_equal(other[r], out[r]) for r in sampled)
        check(changed >= 1, f"[sample] {cell}: seed {SAMPLING['seed'] + 1} changed no request")
        print(f"[sample] {cell}: (b) a fresh engine reproduces all {len(sampled)} sampled "
              f"requests; seed {SAMPLING['seed'] + 1} changes {changed} of them")
        del eng, times, sampler
        torch.cuda.empty_cache()
    # (c) preemption and chunking keep the sampled tokens
    tight, eng, res, times, _ = run("serve-paged", SAMPLING["seed"], prefill_chunk=CHUNK)
    preempted = eng.stats.preemptions
    check(preempted >= 1, "[sample] the tight chunk-32 run never preempted")
    del eng
    roomy, eng, _, _, _ = run("serve-paged", SAMPLING["seed"], n_pages=8 * PAGED_MAX_LEN // PAGE)
    check(eng.stats.preemptions == 0, "[sample] the roomy run preempted")
    del eng
    for rid in roomy:
        check(np.array_equal(tight[rid], roomy[rid]) and np.array_equal(roomy[rid],
                                                                        main["serve-paged"][rid]),
              f"[sample] rid {rid}: tight pages chunk {CHUNK} {tight[rid].tolist()}, roomy "
              f"chunk 1 {roomy[rid].tolist()}, tight chunk 1 "
              f"{main['serve-paged'][rid].tolist()}")
    print(f"[sample] serve-paged on {card}: (c) {PAGED_N_PAGES} pages with prefill_chunk "
          f"{CHUNK} ({preempted} preemptions; {width_ms(times)}) == "
          f"{8 * PAGED_MAX_LEN // PAGE} pages "
          f"with chunk 1 (no preemption) == {PAGED_N_PAGES} pages with chunk 1, all "
          f"{len(roomy)} requests' tokens")
    torch.cuda.empty_cache()
    sample_draws(card, params, cfg, policy)
    return launches


def sample_draws(card: str, params, cfg, policy):
    """(d) ``SAMPLE_DRAWS`` draws from one real logits row of the model at
    positions 0, 1, ...: the card's batched sampler against the CPU plain
    path (the row filtered once, the noise drawn on its support)."""
    import math
    import numpy as np
    import torch
    from repro_torch.core.qarith import QArith
    from repro_torch.models import registry as R
    from repro_torch.serve import sampling
    prompt = torch.from_numpy(main_stream(cfg.vocab)[0][1]).to("cuda")[None]
    with torch.no_grad():
        row = R.forward_logits(QArith(policy), params, cfg, {"tokens": prompt},
                               remat=False)[0, -1].float()
    knobs = ([SAMPLING["temperature"]], [SAMPLING["top_k"]], [SAMPLING["top_p"]])
    keys = [sampling.request_key(SAMPLING["seed"], 0, p) for p in range(SAMPLE_DRAWS)]
    batch = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_tok = torch.cat([
        sampling.sample(row[None].expand(batch, -1), *(k * batch for k in knobs),
                        keys[i:i + batch]).cpu() for i in range(0, SAMPLE_DRAWS, batch)])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    filtered = sampling.filter_logits(row.cpu()[None], *knobs)
    cpu_tok = torch.cat([sampling.draw(filtered.expand(batch, -1), keys[i:i + batch])
                         for i in range(0, SAMPLE_DRAWS, batch)])
    cpu_s = time.perf_counter() - t0
    card_support = torch.isfinite(sampling.filter_logits(row[None], *knobs)[0]).cpu()
    support = torch.isfinite(filtered[0])
    mismatch = torch.nonzero(card_tok != cpu_tok)[:, 0].tolist()
    agree = 1 - len(mismatch) / SAMPLE_DRAWS
    print(f"[sample] (d) {SAMPLE_DRAWS} draws on one logits row on {card}: card sampler "
          f"{card_s:.2f}s (batches of {batch}), CPU plain path {cpu_s:.2f}s; support "
          f"{int(support.sum())} tokens (card filter: {int(card_support.sum())}, equal "
          f"{torch.equal(card_support, support)}); same token on {agree:.4%} of draws; "
          f"mismatches at positions {mismatch[:20]}"
          + ("" if not mismatch else f" (card {card_tok[mismatch[:20]].tolist()}, CPU "
             f"{cpu_tok[mismatch[:20]].tolist()})"))
    check(agree >= 0.999, f"[sample] the card and the CPU agree on {agree:.4%} of draws")
    exact = filtered[0].double()
    probs = torch.where(support, torch.exp(exact - exact[support].max()), 0.0)
    probs = (probs / probs.sum()).numpy()
    worst = 0.0
    for name, toks in (("card", card_tok), ("CPU", cpu_tok)):
        counts = np.bincount(toks.numpy(), minlength=cfg.vocab)
        check(counts[~support.numpy()].sum() == 0,
              f"[sample] the {name} sampler drew a token outside the filter's support")
        small = probs * SAMPLE_DRAWS < 10
        buckets = [(counts[t], probs[t]) for t in np.nonzero(support.numpy() & ~small)[0]]
        if probs[small].sum() > 0:
            buckets.append((counts[small].sum(), probs[small].sum()))
        for c, p in buckets:
            z = abs(c / SAMPLE_DRAWS - p) / math.sqrt(p * (1 - p) / SAMPLE_DRAWS)
            worst = max(worst, z)
            check(z <= 5.0, f"[sample] {name}: a token's frequency {c / SAMPLE_DRAWS:.5f} is "
                            f"{z:.2f} sigma from its probability {p:.5f}")
    print(f"[sample] (d) every kept token's frequency within 5 sigma of the exact filtered "
          f"softmax (worst {worst:.2f} sigma; tokens expected under 10 times judged as one "
          f"bucket); no draw outside the support")


def chunk_probe(params, cfg, policy, stream):
    """ROADMAP C10: one 32-token chunk step against 32 single-token steps
    from the same empty cache, 8 lanes of prompt prefixes, inside
    ``fused_decode``: K, V and positions of every layer and the last row's
    logits must be the same bits."""
    import numpy as np
    import torch
    from repro_torch.core.qarith import QArith
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry as R
    qa = QArith(policy)
    toks = torch.from_numpy(np.stack([p[:CHUNK] for _, p, _ in stream[:8]])).to("cuda")
    caches, logits = [], []
    with dispatch.fused_decode():
        for chunk in (1, CHUNK):
            cache = R.make_cache(params, cfg, batch_size=8, max_len=PAGED_MAX_LEN,
                                 dtype=policy.compute_dtype)
            for t in range(0, CHUNK, chunk):
                pos = torch.arange(t, t + chunk, dtype=torch.int32, device="cuda")
                pos = pos[None].expand(8, chunk).contiguous()
                rows = torch.full((8,), chunk - 1, device="cuda")
                out, cache = R.decode(qa, params, cfg, toks[:, t:t + chunk], cache,
                                      pos if chunk > 1 else pos[:, 0], out_rows=rows)
            logits.append(out[:, 0].float())
            caches.append(cache["layers"]["b0"])
    for name, one, chunked in zip(("K", "V", "positions"), *caches):
        for layer in range(cfg.n_layers):
            check(torch.equal(one[layer], chunked[layer]),
                  f"chunk probe: layer {layer} {name} differs between a {CHUNK}-token chunk "
                  f"step and {CHUNK} single-token steps (max |diff| "
                  f"{float((one[layer].float() - chunked[layer].float()).abs().max()):.4g})")
    check(torch.equal(logits[0], logits[1]),
          f"chunk probe: last-row logits differ by up to "
          f"{float((logits[0] - logits[1]).abs().max()):.4g}")
    print(f"[serve-paged] chunk probe (ROADMAP C10): a {CHUNK}-token chunk step == {CHUNK} "
          f"single-token steps, 8 lanes, full width: K, V and positions of all "
          f"{cfg.n_layers} layers and the last-row logits torch.equal")


def phase_profile(eng, cfg, card: str, tag: str, steps: int = 3, strict: bool = True):
    """Where a serve step's time goes: 8 lanes decoding in steady state,
    host wall time per step before, under and after the profiler, against
    the device time the profiler records for its kernels, kernel launches
    per step and the top kernels. With ``strict`` the profiler's count of
    the decode, ``qmatmul`` and ``row_mean_sq`` kernels per step must equal
    what the step's graph holds. The families' engines pass ``strict=False``:
    their graphs' counts are held exactly where they are captured
    (``serve_family``), and the profiler missed one of falcon-mamba-7b's
    195 ``row_mean_sq`` records in every 3-step window of two calls (not in
    a third), so there the two counts are printed side by side."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    def wall_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rng = np.random.default_rng(1)
    for _ in range(eng.pool.n_slots):
        eng.submit(rng.integers(0, cfg.vocab, size=32).astype(np.int32), 64)
    for _ in range(40):                   # past the prompts: every lane decodes
        eng.step()
    before_ms = wall_ms()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_ms = wall_ms()
    after_ms = wall_ms()
    avgs = prof.key_averages()
    kernels = [e for e in avgs if str(getattr(e, "device_type", "")).endswith("CUDA")]
    held = eng.graphs[1, False].kernels
    n_kernels = sum(e.count for e in kernels if not e.key.startswith(("Memcpy", "Memset")))
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in avgs if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                                      "cudaLaunchKernelExC")) / steps
    graph_launches = sum(e.count for e in avgs if e.key.startswith("cudaGraphLaunch")) / steps
    print(f"[profile] {tag} on {card}: steady-state host wall per serve step {before_ms:.2f} "
          f"ms before the profiler, {host_ms:.2f} ms under it, {after_ms:.2f} ms after it; "
          f"{device_ms:.2f} ms device kernel time per step (device idle "
          f"{max(0.0, 1 - device_ms / host_ms):.1%} under the profiler, "
          f"{max(0.0, 1 - device_ms / before_ms):.1%} of the wall before it); "
          f"{graph_launches:.0f} graph launches per step holding "
          f"{n_kernels / steps:.0f} kernels; {launches:.0f} kernel "
          f"launches per step outside graphs")
    for name, key, graph_name in (("decode attention", "decode_attention_kernel",
                                   "paged_decode_attention" if eng.paged else
                                   "decode_attention"),
                                  ("qmatmul", "qmatmul", "qmatmul"),
                                  ("row_mean_sq", "row_mean_sq_kernel", "row_mean_sq")):
        found = [e for e in kernels if key in e.key]
        per_step = sum(e.count for e in found) / steps
        ms = sum(dev_us(e) for e in found) / 1e3 / steps
        print(f"[profile] {tag} on {card}: {name} kernel {ms:.3f} ms device time per step "
              f"({ms / device_ms:.1%} of the step's device time), {per_step:g} launches "
              f"per step (the profiler's count; the graph holds {held.get(graph_name, 0)})")
        check(not strict or per_step == held.get(graph_name, 0),
              f"the profiler counts {per_step} {name} kernels per step, the graph holds "
              f"{held.get(graph_name, 0)}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"[profile]   {dev_us(e) / 1e3 / steps:7.3f} ms/step  {e.count / steps:6.0f} "
              f"calls/step  {e.key[:90]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:5]:
        print(f"[profile]   host {e.self_cpu_time_total / 1e3 / steps:7.3f} ms/step  "
              f"{e.count / steps:6.0f} calls/step  {e.key[:90]}")


# the families phase: (arch, layers on the card — None for all — , what
# else it serves). Widths are the published ones; depth is cut only where
# one card's memory or the script's time forces it.
# depth cuts: memory (mistral-nemo 2 of 40) and the script's time within
# its 1200 s (yi-9b 6 of 48, command-r 4 of 40, mixtral 2 of 56,
# llama4-scout 2 of 48, falcon-mamba 8 of 64, recurrentgemma 12 of 26:
# four (rec, rec, attn) periods)
FAMILIES = (("yi-9b", 6, ("paged", "chunk")),
            ("mistral-nemo-12b", 2, ()),
            ("command-r-35b", 4, ()),
            ("mixtral-8x22b", 2, ("paged",)),
            ("llama4-scout-17b-a16e", 2, ()),
            ("falcon-mamba-7b", 8, ()),
            ("recurrentgemma-2b", 12, ("paged",)))
FAMILY_PROFILE = ("yi-9b", "mixtral-8x22b", "falcon-mamba-7b", "recurrentgemma-2b",
                  "qwen2-vl-7b")
FAMILY_GEN = 24
FAMILY_TRAIN = (("mixtral-8x22b", 2), ("falcon-mamba-7b", 2))
FAMILY_TRAIN_ARGV = ["--policy", "bf16_sr_kahan", "--fused-update", "--batch", "2",
                     "--seq", "256", "--steps", "3", "--lr", "1e-6", "--seed", "0",
                     "--device", "cuda"]


def family_stream(vocab: int):
    """12 greedy requests, all arriving at once (8 slots: 4 wait for a
    recycled slot): prompts of 8, 16, 32 and 48 tokens (three each; the 32-
    and 48-token ones behind one shared 16-token prefix, a full page), 24
    new tokens each."""
    import numpy as np
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, size=16).astype(np.int32)
    out = []
    for i in range(12):
        n = (8, 16, 32, 48)[i % 4]
        tail = rng.integers(0, vocab, size=n).astype(np.int32)
        prompt = np.concatenate([prefix, tail[16:]]) if n > 16 else tail
        out.append((0, prompt, FAMILY_GEN))
    return out


def family_step_kernels(cfg, paged: bool) -> dict:
    """The hand-written kernel launches of one serve step of ``cfg``:
    per attention layer (``attn``, ``local_attn``, ``moe``) one decode (or
    paged) launch; ``qmatmul`` for every dense product (attention q k v o,
    the MLP's three, three per expert and the shared expert's, Mamba's
    in/x/out projections, RG-LRU's in_gate, in_x, w_r, w_i and out);
    ``row_mean_sq`` under every RMSNorm and the final one."""
    from repro_torch.models import transformer as T
    kinds, n_groups, rem = T._layer_plan(cfg)
    layers = kinds * n_groups + rem
    ffn = 3 * cfg.n_experts + (3 if cfg.shared_expert else 0) if cfg.n_experts else 3
    per = {"attn": 4 + ffn, "local_attn": 4 + 3, "moe": 4 + ffn, "mamba": 3, "rec": 5 + 3}
    out = {"paged_decode_attention" if paged else "decode_attention":
           sum(k in ("attn", "local_attn", "moe") for k in layers),
           "qmatmul": sum(per[k] for k in layers),
           "row_mean_sq": (sum(1 if k == "mamba" else 2 for k in layers) + 1
                           if cfg.norm == "rms" else 0)}
    return {k: n for k, n in out.items() if n}


def _family_probe(card: str, arch: str, params, cfg, policy) -> list:
    """ROADMAP C10 for the ops this family adds to the serve step, at 8
    and at 256 rows inside ``fused_decode`` (torch.equal on the leading 8
    rows and on rows 3-10): checked for the ops of the kernel route — the
    expert products on ``qmatmul``, the f32 router and dt_proj products in
    fixed row blocks, Mamba's C·h tree sum, RG-LRU's gates, and the MoE,
    Mamba and RG-LRU decode steps whole; reported for what the route
    replaces or keeps (one cuBLAS call for the f32 products, command-r's
    LayerNorm on ``torch.mean``). Returns the reported ops that showed a
    row dependence."""
    import torch
    from repro_torch.core.qarith import QArith
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MO
    from repro_torch.models import rglru as RG
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    qa = QArith(policy)
    g = _gen(50)
    rows = 256

    def bf(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    def same(fn, *args):
        """fn on 8 rows == those rows of fn on all 256: the leading 8, and
        rows 3-10 (other positions in a block of 8)."""
        full = fn(*args)
        return all(torch.equal(fn(*(a[lo:lo + 8] for a in args)), full[lo:lo + 8])
                   for lo in (0, 3))

    checked, reported = {}, {}
    kinds = T._layer_plan(cfg)[0]
    with torch.no_grad(), dispatch.fused_decode():
        x = bf(rows, 1, cfg.d_model)
        if cfg.norm == "ln":
            p = T._layer(params["layers"]["b0"], 0)
            reported["LayerNorm (torch.mean)"] = same(
                lambda t: qa.layernorm(t, p["ln1"]["scale"], p["ln1"]["bias"]), x)
        if cfg.n_experts:
            p = T._layer(params["layers"]["b0"], 0)["ffn"]
            reported["router product (f32, one cuBLAS call)"] = same(
                lambda t: torch.matmul(t.float(), p["router"]), x[:, 0])
            checked["router product (f32, row blocks)"] = same(
                lambda t: L.f32_rows_product(t, p["router"]), x[:, 0])
            xe = bf(cfg.n_experts, rows, cfg.d_model)
            checked["expert products (qmatmul per expert)"] = torch.equal(
                MO._experts_ffn(qa, p, xe[:, :8], cfg.act_fn),
                MO._experts_ffn(qa, p, xe, cfg.act_fn)[:, :8])
            checked["moe_apply, decode"] = same(lambda t: MO.moe_apply(qa, p, t, cfg), x)
        if "mamba" in kinds:
            p = T._layer(params["layers"]["b0"], 0)["mixer"]
            dt_r = bf(rows, 1, cfg.dt_rank_eff).float()
            reported["Mamba dt_proj (f32, one cuBLAS call)"] = same(
                lambda t: torch.einsum("bsr,rd->bsd", t, p["dt_proj"]["kernel"].float()), dt_r)
            checked["Mamba dt_proj (f32, row blocks)"] = same(
                lambda t: L.f32_rows_product(t, p["dt_proj"]["kernel"]), dt_r)
            h = torch.randn((rows, cfg.d_inner, cfg.ssm_state), generator=g, device="cuda")
            c = torch.randn((rows, cfg.ssm_state), generator=g, device="cuda")
            checked["Mamba C·h (tree sum)"] = same(lambda a, b: SSM.tree_sum(a * b[:, None]),
                                                   h, c)
            state = {"conv": bf(rows, cfg.ssm_conv - 1, cfg.d_inner), "h": h}
            checked["mamba_decode_step"] = same(
                lambda t, cv, hh: SSM.mamba_decode_step(qa, p, t, cfg,
                                                        {"conv": cv, "h": hh})[0],
                x, state["conv"], state["h"])
        if "rec" in kinds:
            p = T._layer(params["layers"]["b0"], 0)["mixer"]
            w = cfg.lru_width or cfg.d_model
            xs = bf(rows, 1, w)
            checked["RG-LRU gates (qmatmul + elementwise)"] = same(
                lambda t: torch.cat(RG._gates(qa, p, t), -1), xs)
            conv, hh = bf(rows, cfg.ssm_conv - 1, w), torch.randn((rows, w), generator=g,
                                                                 device="cuda")
            checked["rglru_decode_step"] = same(
                lambda t, cv, s: RG.rglru_decode_step(qa, p, t, cfg, {"conv": cv, "h": s})[0],
                x, conv, hh)
    if checked or reported:
        print(f"[families] {arch} row probe at 8 vs {rows} rows on {card} (torch.equal on rows "
              f"0-7 and 3-10): checked " + ("; ".join(f"{k} {v}" for k, v in checked.items())
                                              or "none") + "; reported " +
              ("; ".join(f"{k} {v}" for k, v in reported.items()) or "none"))
    bad = [k for k, v in checked.items() if not v]
    check(not bad, f"{arch}: ops whose rows depend on the row count: {bad}")
    return [k for k, v in reported.items() if not v]


def serve_family(card: str, arch: str, n_layers, extra) -> dict:
    """One family at its published widths: random weights from seed 0
    under ``bf16_standard`` on the card, 12 requests on 8 slots (max_len
    256, fused decode, CUDA graphs): the eager step's tokens == the graph
    engine's == ``generate``'s (8 rows, through the same kernels), the
    requests in recycled slots included; the graph's kernel launches ==
    ``family_step_kernels``; then (``extra``) a paged engine (== the
    contiguous tokens; yi-9b also with prefix hits) and chunked prefill
    (chunk 32 == chunk 1). Returns the launches the runs made and the
    reported ops of the row probe that showed a row dependence."""
    import numpy as np
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_stream
    from repro_torch.models import registry as R
    from repro_torch.serve.decode import generate
    from repro_torch.serve.engine import Engine
    DA, QM, RM = (kernel_module(k) for k in ("decode_attention", "qmatmul", "row_mean_sq"))

    policy = get_policy("bf16_standard")
    cfg = R.get_config(arch)
    full = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init(cfg, 0, policy.param_dtype, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[families] {arch}: {cfg.n_layers} of {full} layers"
          + ("" if n_layers is None else " (depth cut to fit one card's memory and the "
             "script's time)") + f", d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B params initialised on the card in {init_s:.2f}s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    stream = family_stream(cfg.vocab)

    def engine(**kw):
        return Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC, fused_decode=True,
                      device="cuda", **kw)

    def tokens(res):
        return {c.rid: c.tokens for c in res.completions}

    eager = engine()
    eager._use_graphs = False
    t0 = time.perf_counter()
    res = serve_stream(eager, stream)
    eager_tokens, eager_s = tokens(res), time.perf_counter() - t0
    del eager
    launches = {}

    def served(eng, tag):
        """Serve the stream on ``eng`` with its launches counted; checks
        every request finished, its graph's kernels; returns the result."""
        counters = {"decode_attention": DA, "qmatmul": QM, "row_mean_sq": RM}
        DA.LAUNCHES = DA.PAGED_LAUNCHES = QM.LAUNCHES = RM.LAUNCHES = 0
        times = step_times(eng)
        res = serve_stream(eng, stream)
        counted = {k: m.LAUNCHES for k, m in counters.items()}
        counted["paged_decode_attention"] = DA.PAGED_LAUNCHES
        ran = {k: run_launches(eng, k, n) for k, n in counted.items() if n}
        check(eng.stats.finished == len(stream) and all(
            c.tokens.size == FAMILY_GEN for c in res.completions),
              f"{arch} {tag}: {eng.stats.finished}/{len(stream)} finished")
        want = family_step_kernels(cfg, eng.paged)
        for w in {k[0] for k in eng.graphs}:
            check(eng.graphs[w, False].kernels == want,
                  f"{arch} {tag}: the width-{w} graph holds {eng.graphs[w, False].kernels}, "
                  f"expected {want}")
        for k, n in ran.items():
            launches[k] = launches.get(k, 0) + n
        st = eng.stats
        print(f"[families] {arch} {tag} on {card}: {res.calls} serve steps, "
              f"{st.tokens_generated} tokens in {res.seconds:.3f}s -> "
              f"{st.tokens_generated / res.seconds:.1f} tok/s ({width_ms(times)}); kernel "
              f"launches {ran}, per replay {dict(eng.graphs[1, False].kernels)}"
              + (f"; prefix hits {st.prefix_hits}" if eng.prefix_cache else ""))
        return res, times

    eng = engine()
    res, times = served(eng, "contiguous, graphs")
    got = tokens(res)
    check(got.keys() == eager_tokens.keys(), f"{arch}: requests differ")
    for rid in got:
        check(np.array_equal(got[rid], eager_tokens[rid]),
              f"{arch} rid {rid}: graph {got[rid].tolist()} != eager {eager_tokens[rid].tolist()}")
    recycled = [c.rid for c in res.completions if c.admitted_step > 0]
    check(len(recycled) >= 4, f"{arch}: only {len(recycled)} requests ran in recycled slots")
    groups = {}
    for c in res.completions:
        groups.setdefault(c.prompt.size, []).append(c)
    with dispatch.fused_decode():
        for s0, cs in groups.items():
            rows = [c.prompt for c in cs] + [np.zeros(s0, np.int32)] * (8 - len(cs))
            ref = generate(params, cfg, policy, np.stack(rows), max_new_tokens=FAMILY_GEN,
                           cache_len=MAIN_SC, device="cuda").cpu().numpy()
            for i, c in enumerate(cs):
                check(np.array_equal(ref[i, s0:], c.tokens),
                      f"{arch} rid {c.rid}: engine {c.tokens.tolist()} != generate "
                      f"{ref[i, s0:].tolist()}")
    toks = np.concatenate(list(got.values()))
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"{arch}: token out of vocab")
    ms = 1e3 * sum(times[1, False][1:]) / max(len(times[1, False]) - 1, 1)
    print(f"[families] {arch}: graph tokens == the eager step's == generate's (8 rows) for "
          f"all {len(got)} requests, {len(recycled)} of them in recycled slots; eager run "
          f"{eager_s:.2f}s; {ms:.2f} ms per replayed width-1 step, "
          f"{8 * 1e3 / ms:.1f} tok/s at 8 lanes on {card}")
    if "paged" in extra:
        paged = engine(paged=True, page_size=PAGE)
        pres, _ = served(paged, "paged, graphs")
        for c in pres.completions:
            check(np.array_equal(c.tokens, got[c.rid]),
                  f"{arch} rid {c.rid}: paged {c.tokens.tolist()} != contiguous")
        if paged.prefix_cache:
            check(paged.stats.prefix_hits >= 1, f"{arch}: the paged run had no prefix hit")
        del paged
    if "chunk" in extra:
        chunked = engine(prefill_chunk=CHUNK)
        cres, _ = served(chunked, f"contiguous, chunk {CHUNK}")
        check(chunked.stats.steps < eng.stats.steps, f"{arch}: chunking saved no step")
        for c in cres.completions:
            check(np.array_equal(c.tokens, got[c.rid]),
                  f"{arch} rid {c.rid}: chunk {CHUNK} {c.tokens.tolist()} != chunk 1")
        print(f"[families] {arch}: chunk {CHUNK} tokens == chunk 1 tokens for all "
              f"{len(cres.completions)} requests (ROADMAP C10)")
        del chunked
    row_dependent = _family_probe(card, arch, params, cfg, policy)
    if arch in FAMILY_PROFILE:
        phase_profile(eng, cfg, card, f"families {arch}", strict=False)
    print(f"[families] {arch}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    del eng, params
    torch.cuda.empty_cache()
    return launches, row_dependent


def train_family(card: str, arch: str, n_layers: int) -> int:
    """A few full-width training steps of a family cut to ``n_layers``
    through the launcher (``bf16_sr_kahan --fused-update``, batch 2 × 256:
    two routing groups, so the grouped MoE runs), on the stream's first
    batch each step (the loss then falls by the updates alone, not by the
    batches). Adam's first step moves every weight by ~lr along its
    gradient's sign, a layer's outputs by ~lr · d_model: on 2-layer mixtral
    lr 3e-3 and 1e-4 raised the loss (11.04 → 11.67 on the next batch, →
    13.40 on the same one), so lr 1e-6 keeps the step in the regime where
    it descends. Checks: finite, falling loss, one
    ``fused_adamw`` launch per leaf per step (the f32 leaves, cast to bf16
    as the reference's wrapper casts them, bf16 after). Returns the
    launches."""
    import itertools

    import numpy as np
    import torch
    from repro_torch.launch import train as LT
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_leaves, tree_paths
    FA = kernel_module("fused_adamw")
    args = LT.parse_args(["--arch", arch] + FAMILY_TRAIN_ARGV)
    cfg = dataclasses.replace(R.get_config(arch), n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = LT.build(args, cfg=cfg)
    f32 = [p for p, t in zip(tree_paths(run.state.params), tree_leaves(run.state.params))
           if t.dtype == torch.float32]
    n_leaves = len(tree_leaves(run.state.params))
    step_s = []
    step_fn = run.step_fn

    def timed_step(state, batch, seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch, seed)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out
    first = next(run.batches(0))
    run = dataclasses.replace(run, step_fn=timed_step,
                              batches=lambda start: itertools.repeat(first))
    FA.LAUNCHES = 0
    state, info = LT.train(args, run, log=lambda line: None)
    losses = [row["loss"] for row in info["history"]]
    check(len(losses) == args.steps and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{arch} train: losses {losses} (one batch)")
    check(FA.LAUNCHES == n_leaves * args.steps,
          f"{arch} train: fused_adamw launched {FA.LAUNCHES}, expected {n_leaves} x {args.steps}")
    check(f32 and all(t.dtype == torch.bfloat16 for t in tree_leaves(state.params)),
          f"{arch} train: f32 leaves {f32}, not all bf16 after the updates")
    tokens = args.batch * args.seq
    print(f"[families] train {arch} ({n_layers} of {R.get_config(arch).n_layers} layers, "
          f"{args.policy}, fused update, lr {args.lr}, one batch of {args.batch} x "
          f"{args.seq}) on {card}: losses "
          f"{[round(x, 4) for x in losses]}; step times {[round(1e3 * x, 1) for x in step_s]} "
          f"ms ({tokens / step_s[-1]:.0f} tokens/s at the last); fused_adamw {FA.LAUNCHES} "
          f"launches ({n_leaves} leaves, the f32 {f32} among them); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del run, state
    torch.cuda.empty_cache()
    return FA.LAUNCHES


def phase_families(card: str) -> dict:
    """The other decoder-only families (ROADMAP A4 items 1-4), served and
    two of them trained; returns the kernel launches of the phase."""
    t0 = time.perf_counter()
    launches, row_dependent = {}, {}
    for arch, n_layers, extra in FAMILIES:
        ran, row_dependent[arch] = serve_family(card, arch, n_layers, extra)
        for k, n in ran.items():
            launches[k] = launches.get(k, 0) + n
    for arch, n_layers in FAMILY_TRAIN:
        launches["fused_adamw"] = launches.get("fused_adamw", 0) + train_family(
            card, arch, n_layers)
    for k in ("decode_attention", "paged_decode_attention", "qmatmul", "row_mean_sq",
              "fused_adamw"):
        check(launches.get(k, 0) > 0, f"families phase: no {k} launch")
    print(f"[families] row-dependent ops reported (off every chunked path): {row_dependent}")
    print(f"[families] phase done in {time.perf_counter() - t0:.1f}s on {card}; launches "
          f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# ROADMAP A4 items 5-7: whisper (encoder-decoder), qwen2-vl (M-RoPE), the
# CIFAR ResNet
# ---------------------------------------------------------------------------

D64 = dict(hq=8, hkv=8, d=64)     # whisper-base's attention: 8 heads of 64 on 8 kv heads
WHISPER_SELF_SC = 448             # the decoder's designed length (registry.TGT_LEN_ENCDEC)
WHISPER_PROMPT, WHISPER_NEW = 4, 28
WHISPER_TRAIN_STEPS = 3
WHISPER_LR = 1e-5                 # fused AdamW, bf16_sr_kahan, one audio batch repeated
VLM_TEXT, VLM_GRID = 16, 8        # the vlm decode: text, a 1 x 8 x 8 image, text
VLM_TRAIN_LAYERS, VLM_TRAIN_SEQ, VLM_TRAIN_BATCH, VLM_LR = 2, 256, 2, 1e-6
VLM_SERVE_LAYERS = 7              # the families-style serve checks' depth cut
RESNET_POLICIES = ("fp32", "bf16_standard", "bf16_sr", "bf16_kahan")
RESNET_STEPS, RESNET_BATCH = 200, 128
HP_RESNET = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)


def phase_kernel_d64(card: str) -> float:
    """The contiguous decode kernel at whisper-base's shapes (8 lanes, 8
    query heads on 8 kv heads, G = 1, D = 64), bf16 and f32: its decoder's
    self-attention (a 448-cell cache at mixed depths) and its
    cross-attention (1500 keys at positions 0-1499, the query at 1500:
    every key visible). Within atol = rtol = 1e-2 and 1% of each lane's
    RMS of the plain version, two calls ``torch.equal``; then the bf16
    cross-attention call's time beside its bound, the plain version's and
    ``scaled_dot_product_attention``'s. Returns the largest |kernel −
    plain|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models.registry import get_config
    src = get_config("whisper-base").max_source_len

    def call(fn, x):
        return fn(x["q"], x["k"], x["v"], x["k_pos"], x["q_pos"], p_dtype=x["q"].dtype)

    def cases(dtype, seed):
        cross = _inputs(src, seed + 1, **D64, dtype=dtype)
        cells = torch.arange(src, dtype=torch.int32, device="cuda")[None].expand(B, -1)
        return {f"self-attention, {WHISPER_SELF_SC} cells at mixed depths":
                _inputs(WHISPER_SELF_SC, seed, **D64, dtype=dtype),
                f"cross-attention, {src} keys, q_pos {src}":
                dict(cross, k_pos=cells.contiguous(),
                     q_pos=torch.full((B,), src, dtype=torch.int32, device="cuda"))}

    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for tag, x in cases(dtype, 60).items():
            got, again = call(DA.fused_decode_attention, x), call(DA.fused_decode_attention, x)
            want = call(DA.decode_attention_ref, x)
            torch.cuda.synchronize()
            tag = f"G=1 D=64 {str(dtype).split('.')[-1]} {tag}"
            check(got.shape == (B, 1, D64["hq"], D64["d"]) and bool(torch.isfinite(got).all()),
                  f"{tag}: output {tuple(got.shape)} or non-finite")
            check(torch.equal(got, again), f"{tag}: two calls differ")
            err = float((got - want).abs().max())
            ratio = rms_ratio(got, want, x["q_pos"])
            check(torch.allclose(got, want, atol=ATOL, rtol=RTOL) and ratio <= REL_RMS,
                  f"{tag}: kernel vs plain max |err| {err}, {ratio} of a lane's RMS")
            max_err = max(max_err, err)
            print(f"[kernel-d64] {tag}: max |kernel - plain| {err:.3e} (atol=rtol={ATOL}), "
                  f"{ratio:.3e} of a lane's RMS; two calls equal")
    x = cases(torch.bfloat16, 62)[f"cross-attention, {src} keys, q_pos {src}"]
    kv_bytes = 2 * x["k"].numel() * x["k"].element_size()
    copies = [x] + [{n: t.clone() if hasattr(t, "clone") else t for n, t in x.items()}
                    for _ in range(-(-64 * 2**20 // kv_bytes) - 1)]
    ms = time_ms([lambda c=c: call(DA.fused_decode_attention, c) for c in copies])
    plain_ms = time_ms([lambda c=c: call(DA.decode_attention_ref, c) for c in copies], calls=16)

    def sdpa(c):
        qt, kt, vt = c["q"].transpose(1, 2), c["k"].transpose(1, 2), c["v"].transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt)
    library_ms = time_ms([sdpa(c) for c in copies])
    bound_ms, bound_by = _bound_ms(x)
    print(f"[kernel-d64] G=1 D=64 bf16 cross-attention, {B} lanes over {src} keys on {card}: "
          f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} "
          f"ms, scaled_dot_product_attention {library_ms:.4f} ms (device time, "
          f"{len(copies)} input copies rotated)")
    return max_err


def phase_whisper(card: str) -> dict:
    """whisper-base at full width and depth (6 + 6 layers, d 512, vocab
    51865, 1500 source frames; random weights and frames from seed 0,
    ``bf16_standard``, 8 lanes): encode once (``make_cache(batch=)``), then
    decode 4 prompt tokens and 28 new ones in lock-step through
    ``make_serve_step(fused_decode=True)`` (eager, as the reference decodes
    it: its engine is decoder-only). The last step's logits within the
    reference's prefill ≡ decode bound (max error / max |logit| < 0.05) of
    ``decoder_forward`` over the fed tokens; a second run's tokens equal;
    per step 2 decode-kernel launches per layer (self and cross) and 9
    ``qmatmul`` (q, k, v, o, cross q and o, the MLP's three). Then 3 fused
    AdamW steps (``bf16_sr_kahan``) on one audio batch (8 × 1500 frames, 448
    target tokens): finite, falling loss, one ``fused_adamw`` launch per
    leaf per step. Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qarith import QArith
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import encdec as ED
    from repro_torch.models import registry as R
    from repro_torch.optim import constant, fused_adamw_optimizer
    from repro_torch.train.step import make_serve_step, make_train_step
    from repro_torch.train.train_state import make_train_state
    DA, QM, FA = (kernel_module(k) for k in ("decode_attention", "qmatmul", "fused_adamw"))
    policy = get_policy("bf16_standard")
    qa = QArith(policy)
    cfg = R.get_config("whisper-base")
    src_len = cfg.max_source_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init(cfg, 0, policy.param_dtype, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = _gen(70)
    src = torch.randn((B, src_len, cfg.d_model), generator=g, device="cuda")
    prompt = torch.randint(0, cfg.vocab, (B, WHISPER_PROMPT), generator=g, device="cuda",
                           dtype=torch.int32)
    n = WHISPER_PROMPT + WHISPER_NEW
    step = make_serve_step(cfg, policy, fused_decode=True, return_logits=True)

    def run():
        """(tokens fed, the last step's logits and token, encode s, step s)"""
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            cache = R.make_cache(params, cfg, batch_size=B, max_len=n, qa=qa,
                                 batch={"src_embeds": src})
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t
            fed, step_s = [prompt[:, :1]], []
            for i in range(n):
                t = time.perf_counter()
                out, logits, cache = step(params, cache, fed[-1],
                                          torch.full((B,), i, dtype=torch.int32, device="cuda"))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                if i + 1 < n:
                    fed.append(prompt[:, i + 1:i + 2] if i + 1 < WHISPER_PROMPT else out)
        return torch.cat(fed, 1), logits, out, enc_s, step_s

    DA.LAUNCHES = QM.LAUNCHES = 0
    fed, logits, last, enc_s, step_s = run()
    launches = {"decode_attention": DA.LAUNCHES, "qmatmul": QM.LAUNCHES}
    want = {"decode_attention": 2 * cfg.n_layers * n, "qmatmul": 9 * cfg.n_layers * n}
    check(launches == want, f"whisper: decode run launched {launches}, expected {want}")
    fed2, _, last2, enc2_s, _ = run()
    check(torch.equal(fed, fed2) and torch.equal(last, last2),
          "whisper: two fused decode runs gave different tokens")
    with torch.no_grad():
        enc = ED.encode(qa, params, cfg, src, remat=False, attn_chunk=src_len)
        full = ED.decoder_forward(qa, params, cfg, fed, enc, remat=False,
                                  attn_chunk=src_len)[:, -1]
    err, scale = float((logits - full).abs().max()), float(full.abs().max())
    check(bool(torch.isfinite(logits).all()) and err / scale < 0.05,
          f"whisper: last decode logits vs decoder_forward max err {err} of scale {scale}")
    toks = fed[:, WHISPER_PROMPT:].cpu().numpy()
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "whisper: token out of vocab")
    ms = 1e3 * float(np.mean(step_s[1:]))
    print(f"[whisper] {cfg.n_enc_layers} + {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M params "
          f"initialised in {init_s:.2f}s on {card}; {B} lanes x {src_len} frames encoded (cross "
          f"K/V of {cfg.n_layers} layers) in {enc_s:.3f}s, {enc2_s:.3f}s the second time; "
          f"{n} lock-step steps ({WHISPER_PROMPT} "
          f"prompt + {WHISPER_NEW} new), eager: {ms:.2f} ms per step after the first, "
          f"{B * 1e3 / ms:.1f} tok/s; per step {launches['decode_attention'] // n} decode and "
          f"{launches['qmatmul'] // n} qmatmul launches; last logits vs decoder_forward "
          f"{err / scale:.3e} of scale (bound 0.05); two runs' tokens equal")
    del enc, full, logits
    tpol = get_policy("bf16_sr_kahan")
    opt = fused_adamw_optimizer(tpol, b2=0.99609375, weight_decay=0.01)
    state = make_train_state(params, opt)
    n_leaves = len(list(_leaves(params)))
    step_fn = make_train_step(cfg, tpol, opt, constant(WHISPER_LR), attn_chunk=src_len)
    toks = next(lm_batches(cfg.vocab, B, R.TGT_LEN_ENCDEC, seed=0, device="cuda"))
    batch = {"src_embeds": src, **toks}
    FA.LAUNCHES = 0
    losses, train_s = [], []
    for _ in range(WHISPER_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batch, 0)
        losses.append(float(m["loss"]))
        train_s.append(time.perf_counter() - t)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"whisper train: losses {losses} (one batch)")
    check(FA.LAUNCHES == n_leaves * WHISPER_TRAIN_STEPS,
          f"whisper train: fused_adamw launched {FA.LAUNCHES}, expected {n_leaves} x "
          f"{WHISPER_TRAIN_STEPS}")
    launches["fused_adamw"] = FA.LAUNCHES
    print(f"[whisper] train ({tpol.name}, fused AdamW, lr {WHISPER_LR}, one batch of {B} x "
          f"{src_len} frames / {R.TGT_LEN_ENCDEC} tokens) on {card}: losses "
          f"{[round(x, 4) for x in losses]}; step times {[round(1e3 * x, 1) for x in train_s]} "
          f"ms; fused_adamw {FA.LAUNCHES} launches ({n_leaves} leaves); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, params, batch
    torch.cuda.empty_cache()
    return launches


def _vlm_decode(card: str) -> dict:
    """qwen2-vl's vlm path on the families' weights (full width and depth,
    seed 0, ``bf16_standard``), lock-step: 8 lanes decode an embeddings
    sequence (16 text, a 1 × 8 × 8 image grid, 16 text) one position per
    step through ``make_serve_step(fused_decode=True)`` with its 3-D
    positions; the last step's logits within 0.05 of their scale of
    ``forward_logits`` on the same batch; per step one decode launch per
    layer, 7 ``qmatmul`` and 2 ``row_mean_sq`` per layer plus the final
    norm's. Returns the launches."""
    import math

    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qarith import QArith
    from repro_torch.data.synthetic import vlm_positions
    from repro_torch.models import registry as R
    from repro_torch.train.step import make_serve_step
    DA, QM, RM = (kernel_module(k) for k in ("decode_attention", "qmatmul", "row_mean_sq"))
    policy = get_policy("bf16_standard")
    qa = QArith(policy)
    cfg = R.get_config("qwen2-vl-7b")
    params = R.init(cfg, 0, policy.param_dtype, device="cuda")
    mp = vlm_positions(B, VLM_TEXT, VLM_GRID, VLM_TEXT)
    S = mp.shape[2]
    embeds = torch.randn((B, S, cfg.d_model), generator=_gen(80), device="cuda") \
        / math.sqrt(cfg.d_model)
    step = make_serve_step(cfg, policy, fused_decode=True, return_logits=True)
    DA.LAUNCHES = QM.LAUNCHES = RM.LAUNCHES = 0
    step_s = []
    with torch.no_grad():
        cache = R.make_cache(params, cfg, batch_size=B, max_len=S)
        for t in range(S):
            t0 = time.perf_counter()
            _, logits, cache = step(params, cache, embeds[:, t:t + 1],
                                    torch.full((B,), t, dtype=torch.int32, device="cuda"),
                                    mrope_positions=mp[:, :, t:t + 1])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {"decode_attention": DA.LAUNCHES, "qmatmul": QM.LAUNCHES,
                    "row_mean_sq": RM.LAUNCHES}
        full = R.forward_logits(qa, params, cfg, {"embeds": embeds, "mrope_positions": mp},
                                remat=False, attn_chunk=S)[:, -1]
    L = cfg.n_layers
    want = {"decode_attention": L * S, "qmatmul": 7 * L * S, "row_mean_sq": (2 * L + 1) * S}
    check(launches == want, f"qwen2-vl vlm decode launched {launches}, expected {want}")
    err, scale = float((logits - full).abs().max()), float(full.abs().max())
    check(bool(torch.isfinite(logits).all()) and err / scale < 0.05,
          f"qwen2-vl vlm decode: last logits vs forward_logits max err {err} of scale {scale}")
    ms = 1e3 * sum(step_s[1:]) / (S - 1)
    print(f"[qwen2-vl] vlm lock-step decode on {card}: {B} lanes x {S} positions ({VLM_TEXT} "
          f"text, a 1 x {VLM_GRID} x {VLM_GRID} grid, {VLM_TEXT} text; M-RoPE positions up to "
          f"{int(mp.max())}), eager {ms:.2f} ms per step; last logits vs forward_logits "
          f"{err / scale:.3e} of scale (bound 0.05); per step {launches['decode_attention'] // S} "
          f"decode, {launches['qmatmul'] // S} qmatmul, {launches['row_mean_sq'] // S} "
          f"row_mean_sq launches")
    del params, cache, full, logits
    torch.cuda.empty_cache()
    return launches


def _train_vlm(card: str) -> int:
    """3 fused-AdamW steps (``bf16_sr_kahan``, lr 1e-6) of qwen2-vl cut to
    2 layers, at its published widths, on one vlm batch (2 × 256
    embeddings: 96 text, an 8 × 8 grid, 96 text, with their 3-D positions)
    repeated: finite, falling loss, one ``fused_adamw`` launch per leaf
    per step. Returns the launches."""
    import math

    import numpy as np
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.data.synthetic import vlm_positions
    from repro_torch.models import registry as R
    from repro_torch.optim import constant, fused_adamw_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import make_train_state
    FA = kernel_module("fused_adamw")
    cfg = dataclasses.replace(R.get_config("qwen2-vl-7b"), n_layers=VLM_TRAIN_LAYERS)
    pol = get_policy("bf16_sr_kahan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = R.init(cfg, 0, pol.param_dtype, device="cuda")
    n_leaves = len(list(_leaves(params)))
    opt = fused_adamw_optimizer(pol, b2=0.99609375, weight_decay=0.01)
    state = make_train_state(params, opt)
    step_fn = make_train_step(cfg, pol, opt, constant(VLM_LR), attn_chunk=VLM_TRAIN_SEQ)
    text = (VLM_TRAIN_SEQ - VLM_GRID * VLM_GRID) // 2
    g = _gen(81)
    batch = {"embeds": torch.randn((VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, cfg.d_model), generator=g,
                                   device="cuda") / math.sqrt(cfg.d_model),
             "mrope_positions": vlm_positions(VLM_TRAIN_BATCH, text, VLM_GRID, text),
             "labels": torch.randint(0, cfg.vocab, (VLM_TRAIN_BATCH, VLM_TRAIN_SEQ), generator=g,
                                     device="cuda", dtype=torch.int32)}
    FA.LAUNCHES = 0
    losses, step_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batch, 0)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"qwen2-vl train: losses {losses} (one batch)")
    check(FA.LAUNCHES == 3 * n_leaves,
          f"qwen2-vl train: fused_adamw launched {FA.LAUNCHES}, expected {n_leaves} x 3")
    print(f"[qwen2-vl] train ({VLM_TRAIN_LAYERS} of 28 layers, {pol.name}, fused AdamW, lr "
          f"{VLM_LR}, one vlm batch of {VLM_TRAIN_BATCH} x {VLM_TRAIN_SEQ}) on {card}: losses "
          f"{[round(x, 4) for x in losses]}; step times {[round(1e3 * x, 1) for x in step_s]} "
          f"ms; fused_adamw {FA.LAUNCHES} launches ({n_leaves} leaves); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, params
    torch.cuda.empty_cache()
    return FA.LAUNCHES


def phase_vlm(card: str) -> dict:
    """qwen2-vl-7b (ROADMAP A4 item 6): its text served as a family at full
    width, ``VLM_SERVE_LAYERS`` of its 28 layers (G = 7; the cut is the
    script's time) through ``serve_family`` — eager == graphs
    == ``generate``, paged == contiguous, kernel counts per step, the row
    probe, a profile — with then the vlm lock-step decode at full depth
    and the 2-layer train cut. Returns the launches."""
    launches, row_dependent = serve_family(card, "qwen2-vl-7b", VLM_SERVE_LAYERS, ("paged",))
    for k, n in _vlm_decode(card).items():
        launches[k] += n
    launches["fused_adamw"] = _train_vlm(card)
    print(f"[qwen2-vl] row-dependent ops reported: {row_dependent}; launches {launches}")
    return launches


def phase_resnet(card: str) -> dict:
    """``RESNET_CIFAR_SMALL`` on ``image_batches`` (batch 128 of 32 × 32,
    seed 0), 200 SGD-momentum steps (lr 0.05, momentum 0.9, wd 1e-4) from
    one f32 draw under ``fp32`` (the non-fused exact update) and under
    ``bf16_standard``, ``bf16_sr`` and ``bf16_kahan`` (``fused_sgd``, one
    launch per leaf per step): finite losses, the last 20 steps' mean
    below the first 20's; the final batch's accuracy printed. Then one
    ``bf16_sr`` step from the trained state through the non-fused ``sgd``
    (``philox`` + ``sr_cast``, once per leaf) ``torch.equal`` to the fused
    step on every float leaf, weights and momentum. cuDNN's TF32 must be
    off. Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qarith import QArith
    from repro_torch.data.synthetic import image_batches
    from repro_torch.models import resnet as RN
    from repro_torch.optim import SGDState, StepKey, fused_sgd_optimizer, sgd
    from repro_torch.optim.base import init_params_for_policy
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the f32 convolutions would not be f32")
    FS, SR, PH = (kernel_module(k) for k in ("fused_sgd", "sr_cast", "philox"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    floats0, strides = RN.split_strides(RN.resnet_init(gen, RN.RESNET_CIFAR_SMALL))
    n_leaves = len(tree_leaves(floats0))

    def gradients(qa, floats, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(floats)]
        with torch.enable_grad():
            logits = RN.resnet_apply(qa, RN.join_strides(tree_unflatten(floats, leaves), strides),
                                     batch["images"])
            loss = -torch.log_softmax(logits, -1).gather(
                1, batch["labels"].long()[:, None]).mean()
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), logits.detach(), tree_unflatten(floats, list(grads))

    kw = dict(momentum=HP_RESNET["momentum"], weight_decay=HP_RESNET["weight_decay"])
    FS.LAUNCHES = SR.LAUNCHES = PH.LAUNCHES = 0
    trained = {}
    for name in RESNET_POLICIES:
        pol = get_policy(name)
        qa = QArith(pol)
        floats = init_params_for_policy(tree_map(torch.clone, floats0), pol)
        opt = sgd(pol, **kw) if pol.update_rounding == "exact" else fused_sgd_optimizer(pol, **kw)
        state = opt.init(floats)
        data = image_batches(10, RESNET_BATCH, seed=0, device="cuda")
        fused_before = FS.LAUNCHES
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(RESNET_STEPS):
            batch = next(data)
            loss, logits, grads = gradients(qa, floats, batch)
            floats, state = opt.update(grads, state, floats, step=i, key=StepKey(0, i),
                                       lr=HP_RESNET["lr"])
            losses.append(loss)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / RESNET_STEPS
        losses = torch.stack(losses).float().cpu().numpy()
        acc = float((logits.argmax(-1) == batch["labels"]).float().mean())
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        check(bool(np.isfinite(losses).all()) and last < first,
              f"resnet {name}: mean loss of the first 20 steps {first}, of the last 20 {last}")
        fused = FS.LAUNCHES - fused_before
        want = 0 if pol.update_rounding == "exact" else n_leaves * RESNET_STEPS
        check(fused == want, f"resnet {name}: fused_sgd launched {fused}, expected {want}")
        print(f"[resnet] {name} on {card}: {RESNET_STEPS} steps of batch {RESNET_BATCH}, "
              f"{ms:.2f} ms per step (host wall, beside the paper sections: contended); "
              f"mean loss first 20 {first:.4f}, last 20 "
              f"{last:.4f}; final batch accuracy {acc:.3f}; "
              + (f"fused_sgd {fused} launches ({n_leaves} leaves)" if fused else
                 "non-fused exact SGD"))
        trained[name] = (floats, state)
    pol = get_policy("bf16_sr")
    floats, state = trained["bf16_sr"]
    qa = QArith(pol)
    _, _, grads = gradients(qa, floats, next(image_batches(10, RESNET_BATCH, seed=1,
                                                           device="cuda")))
    outs = {}
    for tag, opt in (("sgd", sgd(pol, **kw)), ("fused_sgd", fused_sgd_optimizer(pol, **kw))):
        w = tree_map(torch.clone, floats)
        s = SGDState(tree_map(torch.clone, state.momentum), None)
        sr0, ph0 = SR.LAUNCHES, PH.LAUNCHES
        w, s = opt.update(grads, s, w, step=RESNET_STEPS, key=StepKey(0, RESNET_STEPS),
                          lr=HP_RESNET["lr"])
        outs[tag] = tree_leaves(w) + tree_leaves(s.momentum)
        if tag == "sgd":
            check(SR.LAUNCHES - sr0 == PH.LAUNCHES - ph0 == n_leaves,
                  f"resnet: the non-fused SR step launched sr_cast {SR.LAUNCHES - sr0} and "
                  f"philox {PH.LAUNCHES - ph0} times for {n_leaves} leaves")
    bad = [i for i, (a, b) in enumerate(zip(outs["sgd"], outs["fused_sgd"]))
           if not torch.equal(a, b)]
    check(not bad, f"resnet: non-fused SR step != fused on leaves {bad}")
    print(f"[resnet] one bf16_sr step from the trained state: sgd (philox + sr_cast) == "
          f"fused_sgd on all {n_leaves} weights and momenta (torch.equal); cuDNN TF32 off")
    return {"fused_sgd": FS.LAUNCHES, "sr_cast": SR.LAUNCHES, "philox": PH.LAUNCHES}


def event_ms(fn, reps: int = 5) -> float:
    """Device time per call of ``fn`` by CUDA events over ``reps`` eager
    calls after one warm-up (inputs far larger than the 50 MB L2)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _equal(got, want) -> bool:
    """torch.equal on every lane, NaN lanes compared as NaN on both sides."""
    import torch
    nan = torch.isnan(want.float())
    return (torch.equal(torch.isnan(got.float()), nan)
            and torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16)))


def _update_inputs(n: int, seed: int) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(scale):
        return (torch.randn(n, generator=g, device="cuda") * scale).to(torch.bfloat16)
    return dict(w=r(1.0), m=r(0.1), v=r(0.1).abs(), g=r(1.0), c=r(2.0 ** -9),
                bits=torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device="cuda",
                                   dtype=torch.int32))


SEED = 0x1234_5678_9ABC_DEF0     # a leaf seed of the update-kernel checks (both words set)


def _offset_inputs(x: dict, off: int, g_off: int) -> dict:
    """Copies of the update inputs as views ``off`` elements into their
    storage (``g`` at ``g_off``): the kernel's scalar head, and with
    another offset for g, tensors of unequal alignment."""
    import torch

    def at(t, o):
        buf = torch.empty(t.numel() + o, dtype=t.dtype, device=t.device)
        out = buf[o:]
        out.copy_(t)
        return out
    return {k: at(t, g_off if k == "g" else off) for k, t in x.items() if k != "bits"}


def phase_update_kernels(card: str) -> dict:
    """Each update kernel ≡ its plain version (torch.equal, every variant,
    two sizes): the Philox fill and seeded fused AdamW on one seed, and
    every kernel on given bits; device time at the embedding leaf's size,
    and fused AdamW's loads and loads + stores alone."""
    import torch
    FA = kernel_module("fused_adamw")
    FS = kernel_module("fused_sgd")
    SC = kernel_module("sr_cast")
    PH = kernel_module("philox")

    variants = [(False, False), (True, False), (False, True), (True, True)]
    rows = {}
    for n in (1_000_003, EMBED_N):
        x = _update_inputs(n, n % 1000)
        check(torch.equal(PH.philox_bits(SEED, (n,), "cuda"), PH.philox_bits_ref(SEED, n, "cuda")),
              f"philox_bits n={n}: kernel != plain")
        print(f"[update] philox_bits n={n}: kernel == plain (torch.equal)")
        cases = {"": x}
        if n != EMBED_N:
            cases[", offset 3"] = _offset_inputs(x, 3, 3)
            cases[", g at another alignment"] = _offset_inputs(x, 3, 0)
        for where, y in cases.items():
            for kahan in (False, True):
                tag = f"seeded SR{'+Kahan' if kahan else ''}{where}"
                want = FA.fused_adamw_ref(y["w"], y["m"], y["v"], y["g"],
                                          c=y["c"] if kahan else None, seed=SEED, **HP_ADAMW)
                got = [t.clone() for t in (y["w"], y["m"], y["v"], y["c"])]
                FA.fused_adamw(got[0], got[1], got[2], y["g"], c=got[3] if kahan else None,
                               seed=SEED, **HP_ADAMW)
                for name, a, b in zip("wmvc", got, want):
                    if b is not None:
                        check(torch.equal(a, b),
                              f"fused_adamw {tag} n={n}: {name} kernel != plain")
                del want, got
            print(f"[update] fused_adamw seeded SR, Kahan off and on, n={n}{where}: kernel "
                  f"(Philox in the kernel) == plain on the seed's bits (torch.equal)")
        del cases
        # sr_cast: f32 input with ±inf, NaN and lanes near the top of the range
        xs = torch.randn(n, device="cuda") * 7
        xs[:6] = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.3961e38,
                               -3.3961e38, 3.3895e38])
        ok = _equal(SC.sr_cast(xs, x["bits"]), SC.sr_cast_ref(xs, x["bits"]))
        check(ok, f"sr_cast n={n}: kernel != plain")
        print(f"[update] sr_cast n={n}: kernel == plain (torch.equal; inf/NaN/near-max lanes)")
        for stochastic, kahan in variants:
            tag = f"{'SR' if stochastic else 'nearest'}{'+Kahan' if kahan else ''}"
            bits = x["bits"] if stochastic else None
            want = FA.fused_adamw_ref(x["w"], x["m"], x["v"], x["g"],
                                      c=x["c"] if kahan else None, bits=bits,
                                      stochastic=stochastic, **HP_ADAMW)
            got = [t.clone() for t in (x["w"], x["m"], x["v"], x["c"])]
            FA.fused_adamw(got[0], got[1], got[2], x["g"], c=got[3] if kahan else None,
                           bits=bits, stochastic=stochastic, **HP_ADAMW)
            for name, a, b in zip("wmvc", got, want):
                if b is not None:
                    check(torch.equal(a, b), f"fused_adamw {tag} n={n}: {name} kernel != plain")
            del want, got
            want = FS.fused_sgd_ref(x["w"], x["m"], x["g"], c=x["c"] if kahan else None,
                                    bits=bits, stochastic=stochastic, **HP_SGD)
            got = [t.clone() for t in (x["w"], x["m"], x["c"])]
            FS.fused_sgd(got[0], got[1], x["g"], c=got[2] if kahan else None, bits=bits,
                         stochastic=stochastic, **HP_SGD)
            for name, a, b in zip("wmc", got, want):
                if b is not None:
                    check(torch.equal(a, b), f"fused_sgd {tag} n={n}: {name} kernel != plain")
            del want, got
            print(f"[update] fused_adamw, fused_sgd {tag} on given bits, n={n}: kernel == "
                  f"plain on every output (torch.equal)")
        if n != EMBED_N:
            continue
        # timing at the embedding leaf, SR + Kahan (the main path's variant:
        # fused AdamW seeded, fused SGD and sr_cast on the fill's bits)
        w, m, v, c = (x[k].clone() for k in "wmvc")
        calls = {
            "philox": (lambda: PH.philox_bits(SEED, (n,), "cuda"),
                       lambda: PH.philox_bits_ref(SEED, n, "cuda")),
            "sr_cast": (lambda: SC.sr_cast(xs, x["bits"]),
                        lambda: SC.sr_cast_ref(xs, x["bits"])),
            "fused_adamw": (lambda: FA.fused_adamw(w, m, v, x["g"], c=c, seed=SEED,
                                                   **HP_ADAMW),
                            lambda: FA.fused_adamw_ref(x["w"], x["m"], x["v"], x["g"],
                                                       c=x["c"], seed=SEED, **HP_ADAMW)),
            "fused_sgd": (lambda: FS.fused_sgd(w, m, x["g"], c=c, bits=x["bits"], **HP_SGD),
                          lambda: FS.fused_sgd_ref(x["w"], x["m"], x["g"], c=x["c"],
                                                   bits=x["bits"], **HP_SGD)),
        }
        for name, (kernel, plain) in calls.items():
            ms = event_ms(kernel)
            plain_ms = event_ms(plain, reps=2)
            bound_ms = n * UPDATE_BYTES[name] / HBM_BYTES_PER_S * 1e3
            rows[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
            print(f"[update] {name} n={n} SR+Kahan on {card}: kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({UPDATE_BYTES[name]} B/element over 3.35 TB/s; "
                  f"{bound_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, library: none")
        # what bounds fused AdamW: the same kernel's loads alone, loads and
        # stores alone, the update on given bits, and the update (seeded)
        given_ms = event_ms(lambda: FA.fused_adamw(w, m, v, x["g"], c=c, bits=x["bits"],
                                                   **HP_ADAMW))
        parts = {variant: event_ms(lambda variant=variant: FA.probe(variant, w, m, v, x["g"], c))
                 for variant in ADAMW_PROBE_BYTES}
        parts_text = "; ".join(
            f"{variant} {ms:.4f} ms ({n * ADAMW_PROBE_BYTES[variant] / ms / 1e6:.0f} GB/s)"
            for variant, ms in parts.items())
        full_ms = rows["fused_adamw"]["ms"]
        print(f"[update] fused_adamw parts at n={n} on {card}: {parts_text}; full update "
              f"(seeded) {full_ms:.4f} ms ({n * UPDATE_BYTES['fused_adamw'] / full_ms / 1e6:.0f} "
              f"GB/s of its 18 B/element); on given bits (22 B/element) {given_ms:.4f} ms; the "
              f"arithmetic adds {full_ms - parts['loads+stores']:.4f} ms over the memory traffic "
              f"alone")
        del x, xs, w, m, v, c
        torch.cuda.empty_cache()
    return rows


def _accumulation_bound(x, y):
    """``K·2⁻²³·(|x|@|y|)`` in f64: how far an f32 accumulation of the bf16
    products may lie from the exact sum, and so from another such sum."""
    return x.shape[1] * 2.0 ** -23 * (x.double().abs() @ y.double().abs())


def _qmatmul_close(got, want, e) -> tuple[float, float]:
    """The fraction of outputs that differ and the largest share of its
    bound (1 bf16 ulp + ``e``) a difference uses; fails past the bound or
    past QMATMUL_MAX_FRAC."""
    import torch
    g, w = got.double(), want.double()
    nan = torch.isnan(w)
    check(torch.equal(torch.isnan(g), nan), "NaN lanes differ")
    neq = (g != w) & ~nan
    frac = float(neq.double().mean())
    bound = 2.0 ** -7 * w.abs().clamp_min(2.0 ** -126) + e
    used = float((torch.where(neq, (g - w).abs(), 0.0) / bound).max())
    check(used <= 1.0, f"an output differs by {used:.3f}x its bound (1 ulp + f32 bound)")
    check(frac <= QMATMUL_MAX_FRAC, f"{frac:.4%} of outputs differ")
    return frac, used


def _within_exact(got, exact, e) -> float:
    """``|out − exact| ≤ ulp_bf16(|exact| + e) + e``; the largest share of
    that bound used."""
    import torch
    mag = (exact.abs() + e).clamp_min(2.0 ** -126)
    bound = torch.exp2(torch.floor(torch.log2(mag)) - 7) + e
    used = float(((got.double() - exact).abs() / bound).max())
    check(used <= 1.0, f"an output lies {used:.3f}x its bound from the exact product")
    return used


def _gen(seed: int):
    """A CUDA generator seeded with ``seed``."""
    import torch
    return torch.Generator(device="cuda").manual_seed(seed)


def _qmatmul_edge_inputs():
    """x rows whose dot with a column of ones is exact in any order: ±inf,
    NaN, inf − inf, bf16 max + 2¹¹⁰ (SR with 0xFFFF carries it into inf),
    2·bf16 max (overflows f32), bf16 max, 1 + 2⁻⁹, 0."""
    import torch
    big = float(torch.finfo(torch.bfloat16).max)
    inf, nan = float("inf"), float("nan")
    rows = [[inf], [-inf], [nan], [inf, -inf], [big, 2.0 ** 110], [-big, -2.0 ** 110],
            [big, big], [big], [1.0, 2.0 ** -9], [0.0]]
    x = torch.zeros((len(rows), 40), dtype=torch.float32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = torch.tensor(r)
    return (x.to(torch.bfloat16).cuda(),
            torch.ones((40, 24), dtype=torch.bfloat16, device="cuda"))


def phase_qmatmul(card: str) -> tuple[dict, int]:
    """The op layer's qmatmul at full-width shapes (main path: launches
    counted), held against its plain version and the exact product; edge
    lanes bitwise; device time beside its bound, the plain version's and
    torch.matmul's."""
    import torch
    from repro_torch.core.formats import random_bits
    from repro_torch.kernels import ops
    QM = kernel_module("qmatmul")

    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "the plain version's f32 product must not run in TF32, nor bf16 GEMMs reduce "
          "in reduced precision")

    inputs = {}
    for i, (name, (M, N, K)) in enumerate(QMATMUL_SHAPES.items()):
        g = _gen(100 + i)
        off = 1 if "unaligned" in name else 0
        x = torch.randn(M * K + off, generator=g, device="cuda").to(torch.bfloat16)
        x = x[off:].view(M, K)
        check(x.data_ptr() % 16 == 2 * off, "the unaligned case must start 2 bytes off")
        inputs[name] = (x, torch.randn((K, N), generator=g, device="cuda").to(torch.bfloat16))

    # the main path: the op layer, every shape, nearest and SR
    outs = {}
    torch.cuda.synchronize()
    QM.LAUNCHES = 0
    for i, (name, (x, y)) in enumerate(inputs.items()):
        for sr in (False, True):
            outs[name, sr] = ops.qmatmul_op(x, y, _gen(200 + i), stochastic=sr)
    torch.cuda.synchronize()
    launches = QM.LAUNCHES
    check(launches == 2 * len(inputs), f"qmatmul launched {launches} times for "
          f"{2 * len(inputs)} qmatmul_op calls")
    max_err = 0.0
    for i, (name, (x, y)) in enumerate(inputs.items()):
        (M, N, K), e = QMATMUL_SHAPES[name], _accumulation_bound(x, y)
        exact = x.double() @ y.double()
        for sr in (False, True):
            got = outs.pop((name, sr))
            check(got.dtype == torch.bfloat16 and got.shape == (M, N),
                  f"{name}: output {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
            bits = random_bits((M, N), generator=_gen(200 + i)) if sr else None
            check(torch.equal(got, QM.qmatmul(x, y, bits=bits)),
                  f"{name}: qmatmul_op != qmatmul on the generator's bits")
            plain = QM.qmatmul_ref(x, y, bits=bits)
            frac, share = _qmatmul_close(got, plain, e)
            max_err = max(max_err, float((got.float() - plain.float()).abs().max()))
            used = _within_exact(got, exact, e)
            print(f"[qmatmul] {name} ({M}x{K} @ {K}x{N}) {'SR' if sr else 'nearest'}: "
                  f"{frac:.4%} of outputs differ from the plain version, using at most "
                  f"{share:.3f} of their bound (1 ulp + f32 bound, on <= "
                  f"{QMATMUL_MAX_FRAC:.1%}); at most {used:.3f} of the bound to the exact "
                  f"product")
        del exact, e
    del outs

    x, y = _qmatmul_edge_inputs()
    for b in (None, 0, 0xFFFF, 0x8000):
        bits = None if b is None else torch.full((x.shape[0], y.shape[1]), b,
                                                 dtype=torch.int32, device="cuda")
        got, want = QM.qmatmul(x, y, bits=bits), QM.qmatmul_ref(x, y, bits=bits)
        check(_equal(got, want), f"edge lanes, bits {b}: kernel != plain")
        check(bool(torch.isposinf(got[6].float()).all()), "2 x bf16 max did not overflow")
        carried = b == 0xFFFF
        check(bool(torch.isinf(got[4:6].float()).all()) == carried,
              f"bits {b}: bf16 max + 2^110 carried into inf: {not carried}")
    print("[qmatmul] ±inf, NaN, inf - inf, f32 overflow and near-max lanes (bits none, 0, "
          "0xFFFF, 0x8000): kernel == plain (torch.equal); 0xFFFF carries bf16 max into inf")
    K = 1024
    ones = torch.full((128, K), 0.01, dtype=torch.bfloat16, device="cuda")
    out = QM.qmatmul(ones, ones.T.contiguous()).float()
    expect = K * float(torch.tensor(0.01, dtype=torch.bfloat16)) ** 2
    check(abs(float(out[0, 0]) / expect - 1) < 0.01 and bool((out == out[0, 0]).all()),
          f"K accumulation: {float(out[0, 0])} for {expect}")
    print(f"[qmatmul] K accumulation: {K} products of 0.01^2 give {float(out[0, 0]):.6g} "
          f"(exact {expect:.6g}; within 1%)")

    # the path each shape takes, as the Python plan says and as the library does
    for name, (x, y) in inputs.items():
        for sr in (False, True):
            bits = torch.empty((x.shape[0], y.shape[1]), dtype=torch.int32,
                               device="cuda") if sr else None
            check(QM.plan(x, y, bits).path == QM.kernel_path(x, y, bits),
                  f"{name}: plan {QM.plan(x, y, bits)} != the library's path")
    print("[qmatmul] paths: " + "; ".join(f"{n} {QM.plan(x, y).path}"
                                           for n, (x, y) in inputs.items()))

    # rows do not depend on the row count M (bitwise), on both paths
    for name, Ms in (("mlp gate/up", QMATMUL_ROWS), ("mlp down", QMATMUL_ROWS),
                     ("odd, N=77", (1, 8, 129))):
        x, y = inputs[name]
        M_full = max(Ms)
        xs = x if x.shape[0] == M_full else torch.randn(
            (M_full, x.shape[1]), generator=_gen(7), device="cuda").to(torch.bfloat16)
        for sr in (False, True):
            bits = random_bits((M_full, y.shape[1]), generator=_gen(8)) if sr else None
            full = QM.qmatmul(xs, y, bits=bits)
            for M in Ms:
                got = QM.qmatmul(xs[:M], y, bits=None if bits is None else bits[:M])
                check(torch.equal(got, full[:M]), f"{name}: rows at M={M} != rows at "
                      f"M={M_full} ({'SR' if sr else 'nearest'})")
        print(f"[qmatmul] {name} ({QM.plan(xs, y).path}): rows bitwise equal at M in {Ms}, "
              f"nearest and SR")
    torch.cuda.empty_cache()

    row = None
    for name, (M, N, K) in QMATMUL_SHAPES.items():
        x, y = inputs[name]
        n_in = (M * K + K * N) * 2 + M * N * 4
        copies = [(x, y, random_bits((M, N), generator=_gen(1)))]
        copies += [tuple(t.clone() for t in copies[0]) for _ in range(-(-100 * 2**20 // n_in) - 1)]
        if x.data_ptr() % 16:     # keep the unaligned case unaligned in every copy
            copies = [(x,) + c[1:] for c in copies]
        library_ms = time_ms([lambda c=c: torch.matmul(c[0], c[1]) for c in copies])
        flop = 2 * M * N * K
        for sr in (False, True) if name in QMATMUL_MODEL else (False,):
            args = [(c[0], c[1], c[2] if sr else None) for c in copies]
            ms = time_ms([lambda a=a: QM.qmatmul(a[0], a[1], bits=a[2]) for a in args])
            sync_ms = time_ms([lambda a=a: QM._launch(a[0], a[1], a[2],
                                                      entry="repro_qmatmul_sync")
                               for a in args])
            plain_ms = time_ms([lambda a=a: QM.qmatmul_ref(a[0], a[1], bits=a[2])
                                for a in args], calls=16)
            nbytes = (M * K + K * N + M * N) * 2 + (M * N * 4 if sr else 0)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            lib = "nearest; no single call rounds by SR" if sr else "nearest"
            print(f"[qmatmul] {name} ({M}x{K} @ {K}x{N}) {'SR' if sr else 'nearest'} on "
                  f"{card}: {QM.plan(x, y).path} kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} "
                  f"TFLOP/s), bound {bound_ms:.4f} ms ({bound_by}; {bound_ms / ms:.1%} of "
                  f"it), the mma.sync kernel {sync_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.matmul {library_ms:.4f} ms ({flop / library_ms / 1e9:.1f} TFLOP/s, "
                  f"{lib}; kernel / torch.matmul {ms / library_ms:.2f}) (device time, "
                  f"{len(copies)} input copies rotated)")
            if name == "serve 8 lanes" and not sr:      # the serve step's shape
                row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms}
        del copies, args
    del inputs
    torch.cuda.empty_cache()
    row["max_abs_err"] = max_err
    return row, launches


def phase_update_ops():
    """The op layer's update entry points once each at a ragged n: each the
    kernel on the generator's bits (torch.equal to the plain version), and
    the same again under a re-seeded generator."""
    import torch
    from repro_torch.core.formats import random_bits
    from repro_torch.kernels import ops
    FA, FS, SC = (kernel_module(k) for k in ("fused_adamw", "fused_sgd", "sr_cast"))
    n = 1_000_003
    x = _update_inputs(n, 3)
    xs = torch.randn(n, device="cuda") * 7
    before = (SC.LAUNCHES, FA.LAUNCHES, FS.LAUNCHES)
    runs = [ops.sr_cast_op(xs, _gen(s)) for s in (1, 1)]
    check(_equal(runs[0], runs[1]), "sr_cast_op differs under a re-seeded generator")
    check(_equal(runs[0], SC.sr_cast_ref(xs, random_bits((n,), generator=_gen(1)))),
          "sr_cast_op != the plain version on the generator's bits")
    for _ in range(2):
        got = [t.clone() for t in (x["w"], x["m"], x["v"], x["c"])]
        ops.adamw_update_op(*got[:3], x["g"], got[3], _gen(2), HP_ADAMW, kahan=True)
        runs.append(got)
    want = FA.fused_adamw_ref(x["w"], x["m"], x["v"], x["g"], c=x["c"],
                              bits=random_bits((n,), generator=_gen(2)), **HP_ADAMW)
    for a, b, c in zip(runs[2], runs[3], want):
        check(torch.equal(a, b) and torch.equal(a, c), "adamw_update_op: re-seeded or plain")
    for _ in range(2):
        got = [t.clone() for t in (x["w"], x["m"], x["c"])]
        ops.sgd_update_op(got[0], got[1], x["g"], got[2], _gen(3), HP_SGD, kahan=True)
        runs.append(got)
    want = FS.fused_sgd_ref(x["w"], x["m"], x["g"], c=x["c"],
                            bits=random_bits((n,), generator=_gen(3)), **HP_SGD)
    for a, b, c in zip(runs[4], runs[5], want):
        check(torch.equal(a, b) and torch.equal(a, c), "sgd_update_op: re-seeded or plain")
    after = (SC.LAUNCHES, FA.LAUNCHES, FS.LAUNCHES)
    check(all(a - b == 2 for a, b in zip(after, before)), f"op launches {before} -> {after}")
    print(f"[ops] at n={n}: sr_cast_op, adamw_update_op and sgd_update_op "
          f"(SR + Kahan) each launched their kernel, equal the plain version on the "
          f"generator's bits and themselves under a re-seeded generator (torch.equal)")


def phase_train(card: str):
    """Full-width training through the launcher's functions."""
    import numpy as np
    import torch
    FA = kernel_module("fused_adamw")
    FS = kernel_module("fused_sgd")
    SC = kernel_module("sr_cast")
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import train as LT
    from repro_torch.tree import tree_leaves

    args = LT.parse_args(TRAIN_ARGV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt_events = []
    opt = LT.make_optimizer(args, get_policy(args.policy))

    def timed_update(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = opt.update(*a, **kw)
        end.record()
        opt_events.append((start, end))
        return out

    run = LT.build(args, optimizer=dataclasses.replace(opt, update=timed_update))
    torch.cuda.synchronize()
    n_leaves = len(tree_leaves(run.state.params))
    n_params = sum(t.numel() for t in tree_leaves(run.state.params))
    print(f"[train] {run.cfg.name}: {run.cfg.n_layers} layers, {n_params / 1e9:.3f} B params "
          f"in {n_leaves} leaves, {run.optimizer.name}, state built on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    step_s = []
    step_fn = run.step_fn

    def timed_step(state, batch, seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch, seed)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    run = dataclasses.replace(run, step_fn=timed_step)
    PH = kernel_module("philox")
    FA.LAUNCHES = SC.LAUNCHES = FS.LAUNCHES = PH.LAUNCHES = 0
    state, info = LT.train(args, run, log=lambda line: print(f"[train] {line}"))
    launches = FA.LAUNCHES
    check(SC.LAUNCHES == 0 and FS.LAUNCHES == 0 and PH.LAUNCHES == 0,
          "the fused path launched sr_cast, fused_sgd or the Philox fill (fused AdamW "
          "draws its bits itself)")
    losses = [row["loss"] for row in info["history"]]
    check(len(losses) == args.steps and all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == n_leaves * args.steps,
          f"fused_adamw launched {launches} times, expected {n_leaves} leaves x {args.steps}")
    opt_ms = [s.elapsed_time(e) for s, e in opt_events]
    steady = step_s[2:]
    ms_step = 1e3 * sum(steady) / len(steady)
    tokens = args.batch * args.seq
    bound_opt = n_params * UPDATE_BYTES["fused_adamw"] / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] losses {[round(x, 4) for x in losses]}")
    print(f"[train] on {card}: step times {[round(1e3 * x, 1) for x in step_s]} ms; "
          f"steady (steps 2-7) {ms_step:.1f} ms/step, {tokens / ms_step * 1e3:.0f} tokens/s; "
          f"optimizer update {sum(opt_ms[2:]) / len(opt_ms[2:]):.2f} ms/step (CUDA events, "
          f"bits drawn inside) against a bound of {bound_opt:.2f} ms "
          f"({UPDATE_BYTES['fused_adamw']} B x {n_params} elements over 3.35 TB/s: the bits "
          f"drawn in the kernel); "
          f"fused_adamw launched {launches} times ({n_leaves} per step); peak device memory "
          f"{peak:.2f} GiB")
    return run, state, launches, (ms_step, losses)


def phase_train_profile(run, state, card: str):
    """Where a training step's time goes: one more step under
    ``torch.profiler`` — host wall time against device kernel time, and
    the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = next(run.batches(state.step))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = run.step_fn(state, batch, 0)
        float(metrics["loss"])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in avgs if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile-train] on {card}: one step {host_ms:.1f} ms host wall under the "
          f"profiler, {device_ms:.1f} ms device kernel time (device idle "
          f"{max(0.0, 1 - device_ms / host_ms):.1%}), {n_kernels} kernels")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"[profile-train]   {dev_us(e) / 1e3:8.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    simt = [e for e in kernels if any(t in e.key for t in ("ffma", "sgemm", "f32f32_f32f32"))]
    print(f"[profile-train] f32 SIMT GEMM kernels (cuBLAS ffma/sgemm): "
          f"{sum(e.count for e in simt)} calls, {sum(dev_us(e) for e in simt) / 1e3:.2f} ms "
          f"(the logits backward's two GEMMs take the f32 cotangent): "
          + "; ".join(f"{e.count} x {e.key[:60]}" for e in simt))
    check(sum(e.count for e in simt) == 2, "a product of 16-bit operands with an f32 "
          "result ran as an f32 SIMT GEMM (only the logits backward's two may)")
    return state


def phase_f32_products(cfg, emb, card: str):
    """The products whose f32 result the reference asks of 16-bit operands
    (ROADMAP C12), at the train phase's shapes: device time per call of
    the upcast f32 GEMM the port ran before and of the tensor-core GEMM
    with an f32 result (``f32_product``) it runs now, and both summed over
    one train step (36 layers: flash attention's chunks forward, again
    under remat, and backward; the logits forward)."""
    import torch
    from repro_torch.core.qarith import f32_product
    Bt, S, H, Dh, C = 2, 2048, cfg.n_heads, cfg.head_dim, 1024
    g = _gen(11)

    def bhsd(s):          # (B,S,H,D) storage viewed as (B,H,S,D), as flash attention holds it
        return torch.randn((Bt, s, H, Dh), generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    def wide(r, c):       # a (B,H,r,c) bf16 tensor (p, ds)
        return torch.randn((Bt, H, r, c), generator=g, device="cuda").to(torch.bfloat16)

    q, kc, vc, dout = bhsd(S), bhsd(C), bhsd(C), bhsd(S)
    p = wide(S, C)
    # (name, a, b, calls per layer per step)
    products = [("scores q @ k^T", q, kc.transpose(-1, -2), 6),
                ("p @ v", p, vc, 4),
                ("dv = p^T @ dout", p.transpose(-1, -2), dout, 2),
                ("dp = dout @ v^T", dout, vc.transpose(-1, -2), 2),
                ("dq = ds @ k", p, kc, 2),
                ("dk = ds^T @ q", p.transpose(-1, -2), q, 2)]
    total_before = total_after = 0.0
    for name, a, b, calls in products:
        before = event_ms(lambda: torch.matmul(a.float(), b.float()))
        after = event_ms(lambda: f32_product(a, b))
        check(torch.allclose(f32_product(a, b), torch.matmul(a.float(), b.float()),
                             rtol=0, atol=float(a.shape[-1] * 2.0 ** -23 * (
                                 a.float().abs() @ b.float().abs()).max())),
              f"{name}: the tensor-core product is off the f32 product")
        n = calls * cfg.n_layers
        total_before += n * before
        total_after += n * after
        print(f"[f32-products] {name} {tuple(a.shape)} @ {tuple(b.shape)} on {card}: upcast "
              f"f32 GEMM {before:.4f} ms, tensor cores with an f32 result {after:.4f} ms; "
              f"{n} calls per train step")
    del q, kc, vc, dout, p
    h = torch.randn((Bt * S, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    before = event_ms(lambda: torch.matmul(h.float(), emb.T.float()), reps=3)
    after = event_ms(lambda: f32_product(h, emb.T), reps=3)
    total_before += before
    total_after += after
    print(f"[f32-products] logits {tuple(h.shape)} @ {tuple(emb.T.shape)} on {card}: upcast "
          f"f32 GEMM {before:.3f} ms, tensor cores with an f32 result {after:.3f} ms; once "
          f"per train step (its backward's two GEMMs take the f32 cotangent and stay f32)")
    print(f"[f32-products] per train step on {card}: {total_before:.1f} ms as upcast f32 GEMMs, "
          f"{total_after:.1f} ms on the tensor cores (device time, CUDA events)")
    del h
    torch.cuda.empty_cache()


def phase_parity(run, state, card: str) -> dict:
    """Non-fused ≡ fused AdamW and SGD at full width, leaf by leaf."""
    import torch
    from repro_torch.core.qarith import QArith
    FA = kernel_module("fused_adamw")
    FS = kernel_module("fused_sgd")
    SC = kernel_module("sr_cast")
    PH = kernel_module("philox")
    from repro_torch.models import registry as R
    from repro_torch.optim import (AdamWState, SGDState, StepKey, adamw,
                                   fused_adamw_optimizer, fused_sgd_optimizer, sgd)
    from repro_torch.train.train_state import softmax_xent
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    policy = run.policy
    params, opt_state = state.params, state.opt_state
    batch = next(run.batches(state.step))
    leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
    logits = R.forward_logits(QArith(policy), tree_unflatten(params, leaves), run.cfg, batch)
    loss = softmax_xent(logits, batch["labels"])
    del logits
    grads = list(torch.autograd.grad(loss, leaves))
    del leaves
    print(f"[parity] fresh gradient at step {state.step}: loss {float(loss.detach()):.4f}")
    pairs = {"adamw": (adamw(policy, b2=0.997, weight_decay=0.01),
                       fused_adamw_optimizer(policy, b2=0.997, weight_decay=0.01)),
             "sgd": (sgd(policy, momentum=0.9, weight_decay=1e-4),
                     fused_sgd_optimizer(policy, momentum=0.9, weight_decay=1e-4))}
    key = StepKey(0, state.step)
    lr = 1e-3
    paths = tree_paths(params)
    ms, vs, cs = (tree_leaves(t) for t in (opt_state.m, opt_state.v, opt_state.kahan_c))

    def one(t):
        return {"w": t}

    FA.LAUNCHES = SC.LAUNCHES = FS.LAUNCHES = PH.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i, (path, w) in enumerate(zip(paths, tree_leaves(params))):
            g, grads[i] = grads[i], None              # each gradient freed after its leaf
            # SGD first, on two copies (the AdamW first moment as momentum)
            plain, fused = pairs["sgd"]
            copies = [[t.clone() for t in (w, ms[i], cs[i])] for _ in range(2)]
            outs = []
            for opt, (cw, cm, cc) in zip((plain, fused), copies):
                p, s = opt.update(one(g), SGDState(one(cm), one(cc)), one(cw), step=state.step,
                                  key=key, lr=lr)
                outs.append((p["w"], s.momentum["w"], s.kahan_c["w"]))
            for name, a, b in zip(("w", "momentum", "c"), *outs):
                check(torch.equal(a, b), f"sgd vs fused_sgd: {path} {name} differs")
            del copies, outs
            # AdamW: the fused kernel on copies, the plain optimizer in place
            plain, fused = pairs["adamw"]
            cw, cm, cv, cc = (t.clone() for t in (w, ms[i], vs[i], cs[i]))
            pf, sf = fused.update(one(g), AdamWState(one(cm), one(cv), opt_state.c1,
                                                     opt_state.c2, one(cc)),
                                  one(cw), step=state.step, key=key, lr=lr)
            pp, sp = plain.update(one(g), AdamWState(one(ms[i]), one(vs[i]), opt_state.c1,
                                                     opt_state.c2, one(cs[i])),
                                  one(w), step=state.step, key=key, lr=lr)
            for name, a, b in (("w", pp["w"], pf["w"]), ("m", sp.m["w"], sf.m["w"]),
                               ("v", sp.v["w"], sf.v["w"]),
                               ("c", sp.kahan_c["w"], sf.kahan_c["w"])):
                check(torch.equal(a, b), f"adamw vs fused_adamw: {path} {name} differs")
            del cw, cm, cv, cc, pf, sf, pp, sp, g
    torch.cuda.synchronize()
    n = len(paths)
    launches = {"sr_cast": SC.LAUNCHES, "fused_sgd": FS.LAUNCHES, "fused_adamw": FA.LAUNCHES,
                "philox": PH.LAUNCHES}
    check(launches == {"sr_cast": 2 * n, "fused_sgd": n, "fused_adamw": n, "philox": 3 * n},
          f"parity launches {launches}, expected sr_cast {2 * n} (non-fused adamw and "
          f"sgd, one per leaf each), fused_sgd {n}, fused_adamw {n}, philox {3 * n} (the "
          f"bits of non-fused adamw, sgd and fused sgd; fused adamw draws its own)")
    print(f"[parity] {policy.name}, lr {lr}, one step from the trained state on {card}: adamw "
          f"== fused_adamw and sgd == fused_sgd (momentum 0.9, wd 1e-4) on w, moments and "
          f"Kahan c of all {n} leaves (torch.equal, full width, leaf by leaf) in "
          f"{time.perf_counter() - t0:.1f}s; launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del grads
    # the card's embedding backward: bf16 scatter-add with accumulation
    toks = batch["tokens"].reshape(-1).long()
    rows = torch.randn((toks.numel(), run.cfg.d_model), device="cuda").to(torch.bfloat16)
    table = (run.cfg.vocab, run.cfg.d_model)
    on_card = torch.zeros(table, dtype=torch.bfloat16, device="cuda").index_put_(
        (toks,), rows, accumulate=True)
    on_cpu = torch.zeros(table, dtype=torch.bfloat16).index_put_(
        (toks.cpu(),), rows.cpu(), accumulate=True)
    exact = torch.zeros(table, dtype=torch.float32, device="cuda").index_put_(
        (toks,), rows.float(), accumulate=True)
    diff = (on_card.cpu().float() - on_cpu.float()).abs().max()
    print(f"[parity] embedding backward on the card vs the CPU's bf16 scatter-add over "
          f"{toks.numel()} tokens ({int(toks.unique().numel())} distinct): equal="
          f"{torch.equal(on_card.cpu(), on_cpu)}, max |diff| {float(diff):.4g}; card vs "
          f"f32 sum rounded once: equal={torch.equal(on_card, exact.to(torch.bfloat16))}")
    return launches


def _hold_sr_update(tag: str, update, n_leaves: int) -> list:
    """``update()`` (one SR optimizer step on fresh copies, returning its
    output leaves) through the ``philox`` fill and ``sr_cast``, then again
    with both swapped for their plain versions in the optimizers: each
    kernel must launch once per leaf in the first run and never in the
    second, and every leaf must be ``torch.equal``. Returns the kernel's
    leaves."""
    import math
    import torch
    from repro_torch.optim import base as OB
    SC, PH = kernel_module("sr_cast"), kernel_module("philox")
    SC.LAUNCHES = PH.LAUNCHES = 0
    kernel = update()
    check(SC.LAUNCHES == PH.LAUNCHES == n_leaves,
          f"[paper] {tag}: sr_cast launched {SC.LAUNCHES} and philox {PH.LAUNCHES} times "
          f"for {n_leaves} leaves")
    real = OB.sr_cast, OB.philox_bits
    OB.sr_cast = SC.sr_cast_ref
    OB.philox_bits = lambda seed, shape, device: PH.philox_bits_ref(
        seed, math.prod(int(s) for s in shape), device).reshape(shape)
    try:
        plain = update()
    finally:
        OB.sr_cast, OB.philox_bits = real
    check(SC.LAUNCHES == PH.LAUNCHES == n_leaves,
          f"[paper] {tag}: a kernel launched in the plain run (sr_cast {SC.LAUNCHES}, "
          f"philox {PH.LAUNCHES} after {n_leaves} each)")
    check(len(kernel) == len(plain), f"[paper] {tag}: {len(kernel)} against {len(plain)} leaves")
    for i, (a, b) in enumerate(zip(kernel, plain)):
        check(torch.equal(a, b), f"[paper] {tag}: output leaf {i} {tuple(a.shape)} through "
                              f"philox + sr_cast differs from the plain versions")
    return kernel


def _paper_parity(card: str):
    """``philox`` + ``sr_cast`` against their plain versions on the paper
    path's own leaves: one ``bf16_sr`` SGD step of the DLRM (13 leaves, 1
    to 128,000 elements) and one ``bf16_sr`` AdamW step of the reduced
    qwen2.5-3b of ``train_tiny_lm`` (14 leaves), each from its first
    gradient."""
    import torch
    from repro_torch.benchmarks.common import dlrm_loss
    from repro_torch.core import jrandom
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qarith import QArith
    from repro_torch.data.synthetic import dlrm_batches, lm_batches
    from repro_torch.models import registry as R
    from repro_torch.models.dlrm import DLRM_KAGGLE_SMALL, dlrm_init
    from repro_torch.optim import StepKey, adamw, constant, sgd
    from repro_torch.optim.base import init_params_for_policy
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import make_train_state
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    policy = get_policy("bf16_sr")
    params = init_params_for_policy(dlrm_init(jrandom.PRNGKey(0), DLRM_KAGGLE_SMALL,
                                              device="cuda"), policy)
    leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
    batch = next(dlrm_batches(DLRM_KAGGLE_SMALL, 128, seed=1, device="cuda"))
    grads = tree_unflatten(params, list(torch.autograd.grad(
        dlrm_loss(QArith(policy), tree_unflatten(params, leaves), batch), leaves)))
    opt = sgd(policy, momentum=0.0)

    def dlrm_step():
        w = tree_map(torch.clone, params)
        out, _ = opt.update(grads, opt.init(w), w, step=0, key=StepKey(5, 0), lr=0.1)
        return tree_leaves(out)

    kernel = tree_unflatten(params, _hold_sr_update("DLRM SGD step", dlrm_step,
                                                    len(leaves)))
    moved = int((kernel["tables"] != params["tables"]).sum())
    sizes = sorted(w.numel() for w in leaves)
    print(f"[paper] one bf16_sr SGD step of the DLRM from its first gradient: every leaf "
          f"({len(leaves)}, {sizes[0]} to {sizes[-1]} elements) through philox + sr_cast "
          f"torch.equal to the plain versions (tables {tuple(params['tables'].shape)}: "
          f"{moved} of {params['tables'].numel()} weights moved)")
    del params, leaves, grads, kernel

    cfg = R.get_config("qwen2.5-3b").reduced()
    lm = init_params_for_policy(tree_map(lambda w: w.cuda(), R.init(
        cfg, 0, torch.float32, device="cpu")), policy)
    lm_opt = adamw(policy, b2=0.997)
    gradients, update = make_train_step(cfg, policy, lm_opt, constant(3e-3),
                                        attn_chunk=8).phases
    state = make_train_state(lm, lm_opt)
    g = gradients(state, next(lm_batches(cfg.vocab, 8, 32, seed=0, device="cuda")), 0)

    def lm_step():
        fresh = make_train_state(tree_map(torch.clone, lm), lm_opt)
        new, _ = update(fresh, g, 0)
        return tree_leaves(new.params) + [x for part in new.opt_state if part is not None
                                          for x in tree_leaves(part)]

    n = len(tree_leaves(lm))
    kernel = _hold_sr_update("reduced-qwen AdamW step", lm_step, n)
    sizes = sorted(w.numel() for w in tree_leaves(lm))
    print(f"[paper] one bf16_sr AdamW step of the reduced qwen2.5-3b from its first "
          f"gradient: every leaf ({n}, {sizes[0]} to {sizes[-1]} elements) and the "
          f"optimizer state ({len(kernel) - n} tensors) through philox + sr_cast "
          f"torch.equal to the plain versions on {card}")


# the paper phase's longest section in processes of its own, one per LM
# policy and one for its DLRM runs (``bench_accuracy.run_lm``,
# ``run_dlrm``): the phase lasts as long as its longest process. Unit:
# (part, function of the section's module, its keywords)
# runner sections the paper phase leaves out: grad_wire's 8 ranks (its 2-pod
# pair took 127 s of the window's host in PR 25's calls; tools/port_tp_train.py
# runs the section alone, and phase 17 drives the same training path)
PAPER_SKIP = ("grad_wire",)
PAPER_SPLIT = {"table4_accuracy": [
    *((f"lm-{pol}", "run_lm", {"policies": [pol]})
      for pol in ("fp32", "bf16_standard", "bf16_sr", "bf16_kahan")),
    ("dlrm", "run_dlrm", {})]}


def paper_section(name: str, out: str) -> None:
    """One paper section on the card in this process: its CSV rows on
    stdout; its numbers, its seconds and its ``sr_cast`` and ``philox``
    launches pickled to ``out``. ``phase_paper`` runs each section so, all
    at once: the harnesses are host-bound (the card idles 92-95% under
    one), and one after another they took 390-630 s. ``name`` may be
    ``section:part``, a part of a section in :data:`PAPER_SPLIT`."""
    import importlib
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.benchmarks import run as BR
    SC, PH = kernel_module("sr_cast"), kernel_module("philox")
    t = time.perf_counter()
    if ":" in name:
        section, part = name.split(":")
        _, fn, kw = next(u for u in PAPER_SPLIT[section] if u[0] == part)
        mod = importlib.import_module(f"repro_torch.benchmarks.{dict(BR.SECTIONS)[section]}")
        res = getattr(mod, fn)(device="cuda", **kw)
    else:
        res = BR.run_section(name, device="cuda")
    torch.cuda.synchronize()
    with open(out, "wb") as f:
        pickle.dump({"res": res, "s": time.perf_counter() - t,
                     "launches": {"sr_cast": SC.LAUNCHES, "philox": PH.LAUNCHES}}, f)


def _run_sections(sections, while_running) -> tuple[dict, dict, dict]:
    """Each section in a process of its own (:func:`paper_section`), all
    started at once; ``while_running()`` runs here meanwhile. Prints each
    section's output in section order; fails on a section that failed, and
    stops every process it started. Returns (numbers, seconds, launches
    summed)."""
    import pickle
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for name in sections:
                log = open(Path(tmp) / f"{name}.log", "w")
                code = (f"import chip_smoke; "
                        f"chip_smoke.paper_section({name!r}, {tmp + '/' + name!r})")
                procs[name] = (subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                                stdout=log, stderr=subprocess.STDOUT), log)
            while_running()
            for proc, _ in procs.values():
                proc.wait()
        finally:
            for proc, log in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        res, took, launches = {}, {}, {"sr_cast": 0, "philox": 0}
        for name in sections:
            text = (Path(tmp) / f"{name}.log").read_text()
            print(text, end="", flush=True)
            check(procs[name][0].returncode == 0,
                  f"[paper] section {name} failed (exit {procs[name][0].returncode})")
            with open(Path(tmp) / name, "rb") as f:
                got = pickle.load(f)
            res[name], took[name] = got["res"], got["s"]
            for k in launches:
                launches[k] += got["launches"][k]
    return res, took, launches


def phase_paper(card: str, beside=None) -> dict:
    """The paper's eight sections (``repro_torch.benchmarks``) and the
    runner's ``grad_wire_sweep`` (its training rows, ROADMAP A5) on the card
    at the reference's step counts, each in a process of its own, all at
    once: their CSV rows, the conclusions the reference draws (margins
    from its CPU rows, see PERF.md), ``sr_cast`` held bitwise to its plain
    version on one SR SGD step of the DLRM tables, and a rerun of table4's
    ``bf16_sr`` DLRM in this process (meanwhile) bitwise its run. The µs
    per step it prints are taken with the eight sections and the rerun
    sharing the card and the host: they are not the isolated per-step
    metric, which ``tools/port_paper_steps.py`` measures. ``beside()``,
    if given, runs here after the rerun while the sections still run.
    Returns the sections' ``sr_cast`` and ``philox`` launches."""
    import importlib
    import math
    from repro_torch.benchmarks import run as BR
    from repro_torch.benchmarks.common import train_dlrm

    _paper_parity(card)

    sections = [name for name, mod in BR.SECTIONS
                if not mod.startswith("ROADMAP") and name not in PAPER_SKIP]
    units = [f"{name}:{part}" if name in PAPER_SPLIT else name for name in sections
             for part, _, _ in PAPER_SPLIT.get(name, [(None, None, None)])]
    print(card)
    print(f"[paper] {len(sections)} sections and a DLRM rerun at once on one card and host: "
          "their us_per_call are taken under that contention, not the isolated per-step "
          "metric (tools/port_paper_steps.py)")
    print("name,us_per_call,derived", flush=True)
    rerun = {}

    def second_dlrm():
        rerun["losses"], rerun["auc"], _, rerun["us"] = train_dlrm("bf16_sr", steps=400,
                                                                    device="cuda")
        if beside is not None:
            beside()
    t0 = time.perf_counter()
    res, took, launches = _run_sections(units, second_dlrm)
    wall = time.perf_counter() - t0
    for name, parts in PAPER_SPLIT.items():
        merged = {}         # each part's dicts by policy, merged key by key
        for part, _, _ in parts:
            for k, v in res.pop(f"{name}:{part}").items():
                merged.setdefault(k, {}).update(v)
        mod = importlib.import_module(f"repro_torch.benchmarks.{dict(BR.SECTIONS)[name]}")
        res[name] = mod.gaps(merged)
    print(f"[paper] {len(sections)} sections in {wall:.1f}s on {card}, one process each "
          f"({', '.join(PAPER_SPLIT)} in parts), all at once ("
          + ", ".join(f"{n} {s:.1f}s" for n, s in took.items()) + f"); launches {launches}")

    f2, t3, t4 = res["fig2_theory"], res["table3_bottleneck"], res["table4_accuracy"]
    f9, f12 = res["fig9_cancellation"], res["fig12_fp16"]
    check(f2["updates"] >= 5 * f2["exact"] and f2["fwdbwd"] <= 1.5 * f2["exact"],
          f"[paper] fig2: MSE exact {f2['exact']:.4e}, nearest on updates "
          f"{f2['updates']:.4e} (needs >= 5x), on fwd/bwd {f2['fwdbwd']:.4e} (needs <= 1.5x)")
    check(t3["gap_ablation"] < t3["gap_standard"],
          f"[paper] table3: ablation gap {t3['gap_ablation']:+.4f} not below the standard "
          f"gap {t3['gap_standard']:+.4f}")
    dl = t4["dlrm"]
    check(abs(dl["bf16_sr"] - dl["fp32"]) <= 0.01 and abs(dl["bf16_kahan"] - dl["fp32"]) <= 0.01
          and dl["bf16_standard"] <= dl["fp32"] - 0.03,
          f"[paper] table4 DLRM AUC {dl}: SR and Kahan must lie within 0.01 of fp32, "
          f"standard at least 0.03 below")
    lm = t4["lm"]
    gap = {p: lm[p] - lm["fp32"] for p in ("bf16_sr", "bf16_kahan", "bf16_standard")}
    check(max(abs(gap["bf16_sr"]), abs(gap["bf16_kahan"])) < 0.5 * gap["bf16_standard"],
          f"[paper] table4 LM gaps to fp32 {gap}: SR and Kahan must be under half the "
          f"standard gap")
    check(0 < f9["early"] < f9["late"] < 1,
          f"[paper] fig9: cancellation early {f9['early']:.4f}, late {f9['late']:.4f}")
    check(math.isfinite(f12["probe_bf16"]) and (math.isnan(f12["probe_fp16"])
                                                or f12["probe_fp16"] > 1e3 * f12["probe_bf16"]),
          f"[paper] fig12 range probe: bf16 {f12['probe_bf16']:.4e}, fp16 "
          f"{f12['probe_fp16']:.4e}")
    finite = [res["fig5_tradeoff"][k]["auc"] for k in res["fig5_tradeoff"]]
    finite += [v for c in res["fig10_sub16"].values() for v in (c["auc"], c["final_loss"])]
    finite += [res["fig11_combined"]["lm"], res["fig11_combined"]["dlrm"]]
    finite += list(f12["lm"].values())
    check(all(math.isfinite(v) for v in finite), f"[paper] a fig5/10/11/12 row is not "
                                                  f"finite: {finite}")
    check(abs(res["fig11_combined"]["dlrm"] - dl["fp32"]) <= 0.01,
          f"[paper] fig11 DLRM AUC {res['fig11_combined']['dlrm']:.4f} is not within 0.01 "
          f"of table4's fp32 {dl['fp32']:.4f}")
    losses, auc, us = rerun["losses"], rerun["auc"], rerun["us"]
    check(losses == t4["dlrm_losses"]["bf16_sr"] and auc == dl["bf16_sr"],
          f"[paper] a second bf16_sr DLRM run differs: AUC {auc} against {dl['bf16_sr']}, "
          f"{sum(a != b for a, b in zip(losses, t4['dlrm_losses']['bf16_sr']))} of 400 "
          f"losses")
    print(f"[paper] conclusions hold on {card}: fig2 updates/exact "
          f"{f2['updates'] / f2['exact']:.2f}x, fwdbwd/exact {f2['fwdbwd'] / f2['exact']:.4f}x; "
          f"table3 gaps standard {t3['gap_standard']:+.4f}, ablation {t3['gap_ablation']:+.4f}; "
          f"table4 DLRM AUC {({k: round(v, 4) for k, v in dl.items()})}, LM gaps "
          f"{({k: round(v, 4) for k, v in gap.items()})}; fig9 {f9['early']:.4f} -> "
          f"{f9['late']:.4f}; fig12 probe bf16 {f12['probe_bf16']:.4e}, fp16 "
          f"{f12['probe_fp16']:.4e}; a second bf16_sr DLRM run is bitwise the first "
          f"({us:.1f} us per step)")
    fm = res["fsdp_memory"]
    check(fm["ratio"] >= 1.9, f"[paper] fsdp_memory: DP / FSDP state bytes {fm['ratio']:.4f}, "
                              f"needs >= 1.9")
    print(f"[paper] fsdp_memory on {card} (4 ranks over gloo, 2 data x 2 fsdp): state bytes "
          f"per rank DP {fm['dp']['bytes']}, FSDP {fm['fsdp']['bytes']} ({fm['ratio']:.4f}x); "
          f"{fm['dp']['us']:.1f} and {fm['fsdp']['us']:.1f} us per step under the sections' "
          f"contention")
    sweep = res["grad_wire_sweep"]
    check(all(math.isfinite(v["final_loss"]) for v in sweep.values()),
          f"[paper] grad_wire_sweep losses {sweep}")
    print(f"[paper] grad_wire_sweep on {card} (its asserts held: bf12 >= 2.6x, the keep "
          f"cells within tol of fp32): " + "; ".join(
              f"{k} {v['ratio_vs_fp32']:.3f}x {v['carrier']} loss {v['final_loss']:.4f} "
              f"{v['us']:.1f} us/step" for k, v in sweep.items()))
    print(f"[paper] us per step under the sections' contention, LM: table3 {t3['us']}, "
          f"table4 {t4['lm_us']}, fig11 {res['fig11_combined']['lm_us']:.1f}, fig12 "
          f"{f12['lm_us']}; DLRM: table4 "
          f"{t4['dlrm_us']}, fig5 {({k: v['us'] for k, v in res['fig5_tradeoff'].items()})}, "
          f"fig9 {f9['us']:.1f}, fig10 {({k: v['us'] for k, v in res['fig10_sub16'].items()})}, "
          f"fig11 {res['fig11_combined']['dlrm_us']:.1f}; fig2 {f2['us']:.1f} us per 50 steps")
    return launches


def phase_ckpt(card: str):
    """Checkpointed training through ``launch/train.py::build`` and
    ``run_training`` at full width, depth cut to ``CKPT_LAYERS``: (a) two
    uninterrupted runs (the second checkpointing asynchronously) agree
    bitwise; (b) a run that gets SIGTERM at step ``CKPT_SIGTERM_AT``
    returns preempted, and a fresh ``build`` resumes and finishes equal to
    the uninterrupted run, leaf for leaf and loss for loss; (c) a
    ``--sync-ckpt`` checkpoint restores to the async one's state. Prints
    the checkpoint's bytes, the snapshot's ms (what the step pays), the
    commit's s on the writer thread, ms per step with a commit in flight
    against the same steps without checkpoints, and the restore's s."""
    import shutil
    import signal
    import tempfile
    import torch
    from repro_torch.launch import train as LT
    from repro_torch.models import registry as R
    from repro_torch.train import checkpoint as CK
    from repro_torch.train.loop import run_training

    cfg = dataclasses.replace(R.get_config("qwen2.5-3b"), n_layers=CKPT_LAYERS)
    spans = {"snapshot": [], "commit": [], "restore": []}

    def timed(name, fn):
        def wrapper(*a, **kw):
            if name == "snapshot":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spans[name].append((t0, time.perf_counter()))
            return out
        return wrapper

    real = {name: getattr(CK, attr) for name, attr in
            (("snapshot", "snapshot"), ("commit", "_commit"), ("restore", "restore"))}
    CK.snapshot, CK._commit, CK.restore = (timed(n, real[n]) for n in
                                           ("snapshot", "commit", "restore"))

    def run(extra, *, fault_hook=None):
        """Build and train (keep-N ``CKPT_KEEP``); per-step (start, end)
        walls of the gradient and update phases (a sync ends each step),
        the loop's log lines."""
        args = LT.parse_args(CKPT_ARGV + extra)
        r = LT.build(args, cfg=cfg)
        grads, update = r.step_fn.phases
        steps = []

        def timed_grads(*a):
            torch.cuda.synchronize()
            steps.append([time.perf_counter()])
            return grads(*a)

        def timed_update(*a):
            out = update(*a)
            torch.cuda.synchronize()
            steps[-1].append(time.perf_counter())
            return out

        def step_fn(state, batch, seed):
            return timed_update(state, timed_grads(state, batch, seed), seed)
        step_fn.phases = (timed_grads, timed_update)
        logs = []
        state, info = run_training(r.state, step_fn, r.batches,
                                   dataclasses.replace(LT.loop_config(args), keep_n=CKPT_KEEP),
                                   log=logs.append, fault_hook=fault_hook)
        return state, info, steps, logs

    def same(a, b, what):
        la, lb = CK.flatten(a), CK.flatten(b)
        check(len(la) == len(lb) and la[0] == lb[0], f"[ckpt] {what}: steps {la[0]}, {lb[0]}")
        bad = [i for i, (x, y) in enumerate(zip(la[1:], lb[1:]), 1)
               if x.dtype != y.dtype or not torch.equal(x, y)]
        check(not bad, f"[ckpt] {what}: leaves {bad} of {len(la)} differ (max |diff| "
                       f"{[float((la[i].float() - lb[i].float()).abs().max()) for i in bad[:4]]})")

    root = Path(tempfile.mkdtemp(prefix="repro-ckpt-"))
    try:
        disk = shutil.disk_usage(root)
        print(f"[ckpt] {cfg.name} cut to {cfg.n_layers} layers, {' '.join(CKPT_ARGV)}; "
              f"checkpoints under {root}: {disk.free / 2**30:.1f} GiB free of "
              f"{disk.total / 2**30:.1f} GiB")
        ref, ref_info, ref_steps, _ = run([])
        n_params = sum(t.numel() for t in CK.flatten(ref.params))
        losses = [row["loss"] for row in ref_info["history"]]
        # (a) the determinism baseline, the second run checkpointing
        spans["snapshot"].clear()
        spans["commit"].clear()
        b_dir = root / "async"
        b, b_info, b_steps, _ = run(["--ckpt-dir", str(b_dir)])
        same(b, ref, "(a) a second uninterrupted run")
        kept = sorted(p.name for p in b_dir.glob("step_*"))
        check(kept == [f"step_{s:09d}" for s in (4, 6)] and CK.latest_step(b_dir) == 6,
              f"[ckpt] (a) keep-N {CKPT_KEEP} left {kept}, LATEST {CK.latest_step(b_dir)}")
        check([row["loss"] for row in b_info["history"]] == losses,
              f"[ckpt] (a) losses {b_info['history']} != {losses}")
        del b
        nbytes = sum(f.stat().st_size for f in (b_dir / f"step_{6:09d}").iterdir())
        snap_ms = [1e3 * (e - s) for s, e in spans["snapshot"]]
        commit_s = [e - s for s, e in spans["commit"]]
        busy = [(k, 1e3 * (e - s), 1e3 * (ref_steps[k][1] - ref_steps[k][0]))
                for k, (s, e) in enumerate(b_steps)
                if any(cs < e and ce > s for cs, ce in spans["commit"])]
        print(f"[ckpt] (a) on {card} (beside the paper sections and the tp launches: the "
              f"times are contended): two uninterrupted {len(losses)}-step runs agree "
              f"bitwise on all {len(CK.flatten(ref)) - 1} leaves and every loss, the second "
              f"keeping {kept} (keep-N {CKPT_KEEP}) "
              f"({[round(x, 4) for x in losses]}); {n_params / 1e6:.1f} M parameters, "
              f"checkpoint {nbytes / 2**30:.3f} GiB ({nbytes} bytes); snapshot "
              f"{[round(x, 1) for x in snap_ms]} ms (what the step pays); commit "
              f"{[round(x, 2) for x in commit_s]} s on the writer thread; steps with a "
              f"commit in flight {[(k, round(w, 1)) for k, w, _ in busy]} ms against "
              f"{[(k, round(wo, 1)) for k, _, wo in busy]} ms for the same steps without "
              f"checkpoints"
              + (f" (mean {sum(w for _, w, _ in busy) / len(busy):.1f} against "
                 f"{sum(wo for _, _, wo in busy) / len(busy):.1f} ms)" if busy else ""))
        # (b) SIGTERM, then a fresh build resumes
        c_dir = root / "preempted"

        def sigterm(step):
            if step == CKPT_SIGTERM_AT:
                os.kill(os.getpid(), signal.SIGTERM)
        c, c_info, _, _ = run(["--ckpt-dir", str(c_dir)], fault_hook=sigterm)
        check(c_info["preempted"] and c.step == CKPT_SIGTERM_AT + 1
              and CK.latest_step(c_dir) == CKPT_SIGTERM_AT + 1,
              f"[ckpt] (b) preempted={c_info['preempted']} at step {c.step}, LATEST "
              f"{CK.latest_step(c_dir)}")
        del c
        spans["restore"].clear()
        d, d_info, _, logs = run(["--ckpt-dir", str(c_dir)])
        check(f"[loop] resumed from checkpoint at step {CKPT_SIGTERM_AT + 1}" in logs,
              f"[ckpt] (b) no resume line in {logs}")
        same(d, ref, "(b) preempted and resumed against uninterrupted")
        got = [row["loss"] for row in c_info["history"] + d_info["history"]]
        check(got == losses, f"[ckpt] (b) losses {got} != {losses}")
        restore_s = [e - s for s, e in spans["restore"]]
        print(f"[ckpt] (b) on {card}: SIGTERM at step {CKPT_SIGTERM_AT} -> preempted, "
              f"checkpointed at step {CKPT_SIGTERM_AT + 1}; a fresh build restored it in "
              f"{restore_s[0]:.2f}s and finished: every leaf of params and optimizer state "
              f"torch.equal to the uninterrupted run's, losses equal")
        del d
        shutil.rmtree(c_dir)
        # (c) a synchronous checkpoint restores to the async one's state
        e_dir = root / "sync"
        e, _, _, _ = run(["--ckpt-dir", str(e_dir), "--sync-ckpt"])
        del e
        restored = []
        for where in (b_dir, e_dir):
            r = LT.build(LT.parse_args(CKPT_ARGV), cfg=cfg)
            restored.append(CK.restore(where, r.state)[0])
        same(restored[0], restored[1], "(c) sync against async checkpoint")
        same(restored[0], ref, "(c) the async checkpoint against the run's state")
        print(f"[ckpt] (c) a --sync-ckpt checkpoint restores to the async one's state and "
              f"to the run's own (torch.equal on every leaf)")
    finally:
        CK.snapshot, CK._commit, CK.restore = (real[n] for n in ("snapshot", "commit",
                                                                  "restore"))
        shutil.rmtree(root, ignore_errors=True)


def digest(t) -> str:
    """A fingerprint of a tensor's bits, computed on its device: two
    weighted sums of its raw 16- or 32-bit words (int64, wrapping), in
    chunks. Equal bits give equal digests; a single differing word always
    changes the first sum."""
    import torch
    v = t.detach().contiguous().view(-1)
    v = v.view(torch.int16 if v.element_size() == 2 else torch.int32)
    s1 = s2 = 0
    step = 1 << 26
    for start in range(0, v.numel(), step):
        x = v[start:start + step].to(torch.int64)
        i = torch.arange(start, start + x.numel(), device=x.device, dtype=torch.int64)
        s1 += int(((x + 40503) * (2 * i + 1)).sum())
        s2 += int(((x ^ (i * 40503)) * (x + 7)).sum())
    return f"{t.dtype}:{tuple(t.shape)}:{s1 & (2**64 - 1):x}:{s2 & (2**64 - 1):x}"


_KEPT = {}                 # a dist worker's compensated weights, kept across its runs


def _compensated(w, c):
    """A leaf's Kahan-compensated value: the kernels add ``-u - c`` to w and
    keep in c what the rounding added too much (``bf16_update.cuh``)."""
    return w.float() - c.float()


def dist_worker(spec_path: str) -> None:
    """One rank of the dist phase's runs (``python3 chip_smoke.py
    --dist-worker SPEC``, under ``repro_torch.launch.dist_launch`` or
    alone): each run of the spec through the launcher's ``build`` and
    ``train`` at full width cut to ``DIST_LAYERS``, with the spec's SIGTERM
    (rank 1 at a step) and the params after step 1 saved (rank 0); writes
    ``<out>.rank<r>.json``: the losses, every state leaf's digest, the
    step walls, what the wire moved and the kernel launches. A data-parallel
    run with ``keep`` leaves its init compensated weights and those after
    step 1 (rank 0, on the host) to a later FSDP run of the launch with
    ``against``, which writes each leaf's drift from them after its own
    step 1 (:data:`FSDP_FUSED_DRIFT_BAR`)."""
    sys.path.insert(0, str(ROOT / "src"))
    import signal
    import torch
    from repro_torch.dist import fsdp as F
    from repro_torch.dist import multihost as MH
    from repro_torch.launch import train as LT
    from repro_torch.train import checkpoint as CK
    spec = json.loads(Path(spec_path).read_text())
    card = torch.cuda.is_available()      # (False only in a CPU rehearsal of the phase)
    try:
        for job in spec["runs"]:
            args = LT.parse_args(job["argv"])
            run = LT.build(args, cfg=_dist_cfg(args, job.get("layers", DIST_LAYERS)))
            rank = MH.process_index()
            counts = {k: kernel_module(k) for k in ("sr_cast", "philox", "fused_adamw")}
            for m in counts.values():
                m.LAUNCHES = 0
            walls, paused, drift = [], [], {}

            def hook(step, job=job, run=run, rank=rank, walls=walls, paused=paused,
                     drift=drift):
                if card:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                walls.append(t)
                if rank == 1 and step == job.get("sigterm_at"):
                    os.kill(os.getpid(), signal.SIGTERM)
                if step == 1:
                    if rank == 0 and job.get("params_after_1"):
                        torch.save(CK.flatten(run.state.params), job["params_after_1"])
                    if rank == 0 and job.get("keep"):
                        _KEPT[job["keep"]] = (init, [_compensated(w, c).cpu() for w, c in zip(
                            CK.flatten(run.state.params),
                            CK.flatten(run.state.opt_state.kahan_c))])
                    if job.get("against"):
                        drift["after_1"] = _fsdp_drift(run, run.state,
                                                       _KEPT.pop(job["against"], None))
                    if card:
                        torch.cuda.synchronize()
                # the checks' own work is left out of the step walls
                paused.append(time.perf_counter() - t)

            init = ([t.detach().to("cpu", copy=True) for t in CK.flatten(run.state.params)]
                    if job.get("keep") and rank == 0 else None)
            if card:
                torch.cuda.reset_peak_memory_stats()
            state, info = LT.train(args, run, fault_hook=hook)
            if card:
                torch.cuda.synchronize()
            walls.append(time.perf_counter())
            stats = run.transport.stats
            n_res = len(CK.flatten(state.wire_residuals))
            leaves = CK.flatten(state)[1:]
            launched = {k: m.LAUNCHES for k, m in counts.items()}
            tr = run.transport
            fsdp = {"state_bytes": F.per_device_bytes((state.params, state.opt_state))}
            if tr.scatter_axis is not None:
                specs = F.flat_specs(F.train_state_specs(state, tr.pspecs, tr))[1:]
                params = CK.flatten(state.params)
                fsdp.update(coords=run.mesh.coords(rank),
                            gather_bytes=stats.gather_bytes_by_dtype,
                            scatter_bytes=stats.scatter_bytes,
                            numel_local=sum(t.numel() for t in params),
                            numel_full=sum(math.prod(F.full_shape(t.shape, sp, run.mesh))
                                           for t, sp in zip(params, F.flat_specs(tr.pspecs))))
                if job.get("gather"):
                    # every leaf whole on process 0 (collective), digested on
                    # the leaf's device
                    digests = []
                    for t, sp in zip(leaves, specs):
                        whole = F.gather_full(t, sp, run.mesh)
                        if whole is not None:
                            digests.append(digest(whole.to(t.device)))
                        del whole
                    fsdp["full_digests"] = digests if rank == 0 else None
                if job.get("plain_check") and rank == 0:
                    fsdp["plain_check"] = fsdp_shard_check(run, state, args)
                fsdp.update(drift)
            elif job.get("gather"):
                fsdp["full_digests"] = [digest(t) for t in leaves]
            del init
            out = {"rank": rank, "processes": MH.process_count(), "step": state.step,
                   "preempted": info["preempted"],
                   "losses": [row["loss"] for row in info["history"]],
                   "grad_norms": [row["grad_norm"] for row in info["history"]],
                   "digests": [digest(t) for t in leaves[:len(leaves) - n_res]],
                   "residual_digests": [digest(t) for t in leaves[len(leaves) - n_res:]],
                   "residual_abs_max": max((float(t.abs().max()) for t in
                                            leaves[len(leaves) - n_res:]), default=0.0),
                   "step_s": [b - a - p for a, b, p in zip(walls, walls[1:], paused)],
                   "wire_bytes": stats.bytes_by_dtype, "host_copy_s": stats.host_copy_s,
                   "wire": run.transport.name,
                   "replicas": run.transport.wire_replicas,
                   "launches": launched, "fsdp": fsdp,
                   "n_params": len(CK.flatten(state.params)),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if card else 0.0}
            Path(f"{job['out']}.rank{rank}.json").write_text(json.dumps(out))
            del run, state, leaves
            if card:
                torch.cuda.empty_cache()
    finally:
        MH.shutdown()


def _fsdp_drift(run, state, kept) -> list | None:
    """Per parameter leaf (collective; the list on rank 0, None elsewhere):
    ||this run's compensated weights - the kept run's|| / ||the kept run's
    - their init||, this run's gathered whole on rank 0."""
    import torch
    from repro_torch.dist import fsdp as F
    from repro_torch.dist import multihost as MH
    from repro_torch.train import checkpoint as CK
    drift = []
    specs = F.flat_specs(run.transport.pspecs)
    for i, (w, c, sp) in enumerate(zip(CK.flatten(state.params),
                                       CK.flatten(state.opt_state.kahan_c), specs)):
        w, c = F.gather_full(w, sp, run.mesh), F.gather_full(c, sp, run.mesh)
        if not MH.is_primary():
            continue
        mine = _compensated(w, c).cpu()
        init, final = kept[0][i].float(), kept[1][i]
        moved = float((final - init).norm())
        off = float((mine - final).norm())
        drift.append(off / moved if moved else (0.0 if off == 0 else math.inf))
    return drift if MH.is_primary() else None


def fsdp_shard_check(run, state, args, leaf: str = DIST_CHECK_LEAF) -> dict:
    """One shard's shard-local fused AdamW on the card against its plain
    version with the same folded seed: ``leaf``'s shard of this rank (w, m,
    v, c as the run left them; a seeded gradient), its seed ``_mix(leaf
    seed, shard index)`` as ``optim/fused.py`` folds it."""
    import torch
    from repro_torch.kernels.fused_adamw import fused_adamw, fused_adamw_ref
    from repro_torch.optim.base import StepKey, _mix
    from repro_torch.tree import tree_leaves, tree_paths
    i = tree_paths(state.params).index(leaf)
    spec = tree_leaves(run.transport.pspecs)[i]
    idx = 0
    for ax in spec.axes:
        idx = idx * run.mesh.shape[ax] + run.mesh.index(ax)
    seed = _mix(StepKey(args.seed, state.step).leaf(i).seed, idx)
    w = tree_leaves(state.params)[i]
    m, v, c = (tree_leaves(t)[i] for t in (state.opt_state.m, state.opt_state.v,
                                            state.opt_state.kahan_c))
    g = (torch.randn(w.shape, generator=torch.Generator(device=w.device).manual_seed(1),
                     device=w.device) * 1e-2).to(torch.bfloat16)
    card = [t.clone() for t in (w, m, v, c)]
    fused_adamw(card[0], card[1], card[2], g, c=card[3], seed=seed, stochastic=True,
                **HP_ADAMW)
    plain = fused_adamw_ref(*(t.cpu() for t in (w, m, v, g)), c=c.cpu(), seed=seed,
                            stochastic=True, **HP_ADAMW)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(card, plain))
    return {"leaf": leaf, "shape": list(w.shape), "spec": list(spec),
            "index": idx, "equal": equal}


def _dist_cfg(args, layers: int | None = DIST_LAYERS):
    """The dist runs' model: full-width qwen2.5-3b cut to ``layers`` (None:
    its whole depth, the launcher's own; also for ``--reduced``, a CPU
    rehearsal)."""
    from repro_torch.models import registry as R
    if args.reduced or layers is None:
        return None
    return dataclasses.replace(R.get_config(args.arch), n_layers=layers)


def _dist_start(spec: dict, root: Path, tag: str, n: int = 2) -> tuple:
    """Start the spec's runs on n ranks (gloo on this card) through the
    port's launcher; :func:`_dist_wait` ends it."""
    spec_path = root / f"{tag}.json"
    spec_path.write_text(json.dumps(spec))
    log_dir = root / f"{tag}-logs"
    cmd = [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", str(n), "--timeout",
           "400", "--log-dir", str(log_dir), "--", sys.executable, str(ROOT / "chip_smoke.py"),
           "--dist-worker", str(spec_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    return proc, time.perf_counter(), tag, log_dir, n


def _dist_wait(launch: tuple) -> float:
    """The launch's wall seconds; fails with the ranks' logs' tails if a
    rank failed (the launcher kills the others), and kills it at 450 s."""
    proc, t0, tag, log_dir, n = launch
    try:
        _, err = proc.communicate(timeout=450)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"[dist] {tag}: exit {proc.returncode}\n" + "\n".join(
        (log_dir / f"rank{i}.log").read_text()[-3000:] for i in range(n)) + err[-3000:])
    return time.perf_counter() - t0


def _dist_result(root: Path, out: str, rank: int) -> dict:
    return json.loads((root / f"{out}.rank{rank}.json").read_text())


def phase_dist(card: str, train_ms: float, train_losses: list | None) -> dict:
    """ROADMAP A5's data-parallel layer on the card; returns the launches of
    ``sr_cast``, ``philox`` and ``fused_adamw`` on its paths.

    (a) A 1-rank NCCL group, the train cell (full-width qwen2.5-3b,
    ``bf16_sr_kahan --fused-update``, batch 2 x 2048, 8 steps) with
    ``--grad-wire bf16`` (the one-replica wire: each leaf SR-rounded by the
    ``philox`` fill and ``sr_cast``, no collective): the loss falls, and
    equals the train phase's step for step (``train_losses``): a bf16
    gradient plus the zero residual rounds exactly, so this wire changes
    no bit of a pure-bf16 run at grad_accum 1; on one gradient leaf the
    wire's q and residual ``torch.equal`` to the plain ``compress_leaf`` on
    the CPU with the same bits, with the run's zero residual and with a
    nonzero one; ms per step beside the train phase's step without a
    transport (same call), wire ms per step (CUDA events around
    ``reduce``), residual GiB, peak GiB.

    (b) 2 ranks on this card over gloo, launched by
    ``repro_torch.launch.dist_launch``, full width cut to ``DIST_LAYERS``,
    ``DIST_ARGV`` (batch 4 x 512, ``--grad-accum 2`` so the bf16 wire's
    residuals are not zero): ``--grad-wire fp32`` and ``bf16``, 3 steps
    each: both ranks' parameters, optimizer state and losses bitwise equal;
    the fp32 wire's parameters after one step within 0.05 (the reference's
    bar) of a 1-process step on the whole batch; the bf16 wire with rank 1
    alone SIGTERMed at step 1 (both stop, checkpoint at step 2, the
    cadence's step), a fresh 2-rank launch resumes and ends equal to the
    uninterrupted run on every leaf, residual rows included; a 1-process
    resume of that checkpoint logs the replica-count zero-init and trains
    on. ms per step, the host-copy ms apart, the wire's bytes per step by
    dtype as the transport counts them. The FSDP runs (ROADMAP A9,
    :func:`_fsdp_checks`) ride the same two launches, and a launch of 4
    ranks beside the first: each launch costs its processes' start.
    """
    t_phase = time.perf_counter()
    # (b) first: its ranks need the card's memory, which (a) fills
    launches = _dist_two_ranks(card)
    for k, n in _dist_one_rank(card, train_ms, train_losses).items():
        launches[k] += n
    print(f"[dist] phase took {time.perf_counter() - t_phase:.1f}s; launches {launches}")
    return launches


def _dist_one_rank(card: str, train_ms: float, train_losses: list | None) -> dict:
    """(a) of :func:`phase_dist`; returns its launches."""
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as LT
    from repro_torch.optim import grad_compress as GC
    from repro_torch.tree import tree_leaves, tree_paths

    mods = {k: kernel_module(k) for k in ("sr_cast", "philox", "fused_adamw")}
    launches = dict.fromkeys(mods, 0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe)
        check(float(probe) == 1.0, "[dist] (a) the 1-rank NCCL group's all_reduce")
        args = LT.parse_args(DIST_FULL_ARGV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = LT.build(args)
        tr = run.transport
        check(tr.name == "compressed_wire" and tr.wire_replicas == 1,
              f"[dist] (a) transport {tr.name} x{tr.wire_replicas}")
        paths = tree_paths(run.state.params)
        leaf = paths.index(DIST_CHECK_LEAF)
        res_gib = sum(r.numel() * 4 for r in tree_leaves(run.state.wire_residuals)) / 2**30
        events, held = [], {}
        real_reduce = tr.reduce

        def timed_reduce(grads, residuals, key, **kw):
            if not held:      # the check leaf's inputs at the first step
                held["g"] = tree_leaves(grads)[leaf].detach().cpu()
                held["r"] = tree_leaves(residuals)[leaf][0].detach().cpu()
                held["key"] = key
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_reduce(grads, residuals, key, **kw)
            end.record()
            events.append((start, end))
            if "q" not in held:
                held["q"] = tree_leaves(out[0])[leaf].detach().cpu()
                held["nr"] = tree_leaves(out[1])[leaf][0].detach().cpu()
            return out
        tr.reduce = timed_reduce
        walls = []

        def hook(step):
            torch.cuda.synchronize()
            walls.append(time.perf_counter())
        for m in mods.values():
            m.LAUNCHES = 0
        state, info = LT.train(args, run, log=lambda line: print(f"[dist] (a) {line}"),
                               fault_hook=hook)
        torch.cuda.synchronize()
        walls.append(time.perf_counter())
        got = {k: m.LAUNCHES for k, m in mods.items()}
        n_leaves = len(paths)
        for k in mods:
            launches[k] += got[k]
            check(got[k] == n_leaves * args.steps,
                  f"[dist] (a) {k} launched {got[k]} times, expected {n_leaves} leaves x "
                  f"{args.steps} steps")
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [row["loss"] for row in info["history"]]
        check(len(losses) == args.steps and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"[dist] (a) losses {losses}")
        check(train_losses is None or losses == train_losses,
              f"[dist] (a) losses {losses} differ from the train phase's {train_losses}")
        wire_ms = [s.elapsed_time(e) for s, e in events]
        step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
        # the check leaf: the wire's outputs against the plain compress_leaf on
        # the CPU with the same Philox bits (philox_bits_ref, sr_cast_ref)
        noise = held["key"].leaf(leaf)
        q, nr = GC.compress_leaf(held["g"], held["r"], noise)
        check(torch.equal(q.float(), held["q"]) and torch.equal(nr, held["nr"]),
              f"[dist] (a) {DIST_CHECK_LEAF}: the wire's q/residual differ from the plain "
              f"compress_leaf")
        zero_res = float(held["nr"].abs().max()) == 0.0
        # ... and with a nonzero residual (the bf16 gradients of this policy
        # round exactly: a run's residual stays zero at grad_accum 1)
        r_syn = torch.randn(held["r"].shape, generator=torch.Generator().manual_seed(0)) \
            * float(held["g"].float().abs().max()) * 2.0**-9
        q_card, nr_card = GC.compress_leaf(held["g"].cuda(), r_syn.cuda(), noise)
        q_cpu, nr_cpu = GC.compress_leaf(held["g"], r_syn, noise)
        check(torch.equal(q_card.cpu(), q_cpu) and torch.equal(nr_card.cpu(), nr_cpu)
              and float(nr_cpu.abs().max()) > 0,
              f"[dist] (a) {DIST_CHECK_LEAF} with a nonzero residual: card != plain")
        print(f"[dist] (a) on {card}: 1-rank NCCL group, {run.cfg.name} "
              f"{run.cfg.n_layers} layers, {' '.join(DIST_FULL_ARGV)}: losses "
              f"{[round(x, 4) for x in losses]} (== the train phase's: "
              f"{losses == train_losses}); step walls {[round(x, 1) for x in step_ms]} "
              f"ms, steady (steps 2-7) {sum(step_ms[2:]) / len(step_ms[2:]):.1f} ms/step "
              f"against {train_ms:.1f} ms/step without a transport (train phase, same call); "
              f"wire (CUDA events around reduce) {[round(x, 2) for x in wire_ms]} ms/step; "
              f"residuals {res_gib:.3f} GiB f32; peak {peak:.2f} GiB; philox, sr_cast and "
              f"fused_adamw {got} launches ({n_leaves} leaves x {args.steps} steps); "
              f"{DIST_CHECK_LEAF}: the wire's q and residual torch.equal to the plain "
              f"compress_leaf (run residual zero: {zero_res}; also with a nonzero residual)")
        del run, state, held, q_card, nr_card, tr, real_reduce, timed_reduce
    finally:
        dist.destroy_process_group()
    import gc
    gc.collect()            # the wrapped reduce made reference cycles
    torch.cuda.empty_cache()
    return launches


def _dist_two_ranks(card: str) -> dict:
    """(b) of :func:`phase_dist`; returns the ranks' launches."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import train as LT
    from repro_torch.train import checkpoint as CK

    launches = {"sr_cast": 0, "philox": 0, "fused_adamw": 0}
    fsdp_philox_check(card)
    root = Path(tempfile.mkdtemp(prefix="repro-dist-"))
    try:
        ck = root / "ck"

        fck = root / "fsdp-ck"

        def job(name, wire, extra=(), **kw):
            return dict(argv=DIST_ARGV + DIST_TWO_RANKS + ["--grad-wire", wire, *extra],
                        out=str(root / name), **kw)

        def fjob(name, argv, **kw):
            return dict(argv=argv, out=str(root / name), **kw)
        # one launch for the uninterrupted runs and the preempted ones (each
        # launch costs its processes' start); a preemption checkpoints at
        # step 2, also the cadence's, and only the resume reads it. The fused
        # fp32 wire's run keeps its compensated weights for FSDP check (b)
        launch_1 = _dist_start({"runs": [
            job("fp32", "fp32", params_after_1=str(root / "fp32-step1.pt"), keep="fp32"),
            job("bf16", "bf16"),
            job("bf16-stop", "bf16", ["--ckpt-dir", str(ck), "--ckpt-every",
                                      str(DIST_SIGTERM_AT + 1)],
                sigterm_at=DIST_SIGTERM_AT),
            # FSDP (A9): (a) non-fused DP-2 and FSDP-2 from the same start,
            # every leaf gathered; (b) fused FSDP-2 with a shard's plain check,
            # held to the fused fp32 DP-2 run; (d) fused FSDP-2 preempted at
            # the DP run's step
            fjob("dp-plain", FSDP_PLAIN_ARGV + DIST_TWO_RANKS, gather=True),
            fjob("fsdp-plain", FSDP_PLAIN_ARGV + FSDP_TWO_RANKS, gather=True),
            fjob("fsdp", DIST_ARGV + FSDP_TWO_RANKS, plain_check=True, against="fp32"),
            fjob("fsdp-stop", DIST_ARGV + FSDP_TWO_RANKS + [
                "--ckpt-dir", str(fck), "--ckpt-every", str(DIST_SIGTERM_AT + 1)],
                sigterm_at=DIST_SIGTERM_AT, gather=True)]}, root,
            "uninterrupted-and-preempted")
        # (e) of FSDP beside it: 4 ranks, pods 2 x fsdp 2 (the card holds
        # both launches' ranks: ~29 + 38 GiB)
        launch_4 = _dist_start({"runs": [fjob("fsdp-pods", FSDP_POD_ARGV)]}, root, "pods", n=4)
        wall_1 = _dist_wait(launch_1)
        wall_4 = _dist_wait(launch_4)
        kept = CK.latest_step(ck)
        man = CK.manifest(ck, step=kept)
        fkept = CK.latest_step(fck)
        # the resume launch reads the checkpoint; this process reads it too
        # meanwhile (a 1-process resume, saving nothing) and takes the
        # 1-process step the fp32 wire is held to
        resume = _dist_start({"runs": [
            job("bf16-resume", "bf16", ["--ckpt-dir", str(ck)]),
            fjob("fsdp-resume", DIST_ARGV + FSDP_TWO_RANKS + ["--ckpt-dir", str(fck)])]},
            root, "resume")
        t0 = time.perf_counter()
        args = LT.parse_args(DIST_ARGV + ["--grad-wire", "bf16", "--ckpt-dir", str(ck),
                                          "--steps", str(kept + 1)])
        one = LT.build(args, cfg=_dist_cfg(args))
        mods = {k: kernel_module(k) for k in launches}
        for m in mods.values():
            m.LAUNCHES = 0
        one_log = []
        one_state, one_info = LT.train(args, one, log=one_log.append)
        for k, m in mods.items():
            launches[k] += m.LAUNCHES
        wall_3 = time.perf_counter() - t0
        one_done = (one_state.step, one.transport.wire_replicas,
                    [row["loss"] for row in one_info["history"]])
        del one, one_state
        args = LT.parse_args(DIST_ARGV)
        single = LT.build(args, cfg=_dist_cfg(args))
        state, _ = single.step_fn(single.state, next(single.batches(0)), 0)
        two = torch.load(root / "fp32-step1.pt")
        d = max(float((a.float() - b.float().to(a.device)).abs().max())
                for a, b in zip(CK.flatten(state.params), two))
        del single, state, two
        # the FSDP-2 checkpoint in one process (no mesh): its full leaves
        args = LT.parse_args(DIST_ARGV)
        one = LT.build(args, cfg=_dist_cfg(args))
        restored, fat = CK.restore(fck, one.state)
        one_fsdp = [digest(t) for t in CK.flatten(restored)[1:]]
        del one, restored
        torch.cuda.empty_cache()
        wall_2 = _dist_wait(resume)
        fres = {name: [_dist_result(root, name, r) for r in range(2)] for name in
                ("dp-plain", "fsdp-plain", "fsdp", "fsdp-stop", "fsdp-resume")}
        fres["fsdp-pods"] = [_dist_result(root, "fsdp-pods", r) for r in range(4)]
        for pair in fres.values():
            for r in pair:
                for k in launches:
                    launches[k] += r["launches"][k]
        res = {name: [_dist_result(root, name, r) for r in range(2)]
               for name in ("fp32", "bf16", "bf16-stop", "bf16-resume")}
        _fsdp_checks(card, fres, res["fp32"], fkept, fat, one_fsdp)
        for name, (a, b) in res.items():
            check(a["processes"] == b["processes"] == 2 and a["digests"] == b["digests"]
                  and a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"],
                  f"[dist] (b) {name}: the ranks' parameters, optimizer state or metrics "
                  f"differ ({sum(x != y for x, y in zip(a['digests'], b['digests']))} "
                  f"leaves)")
            for r in (a, b):
                for k in launches:
                    launches[k] += r["launches"][k]
        fp, bf = res["fp32"], res["bf16"]
        # (a few steps of a random 2-layer cut need not end below step 0: PR
        # 18's ckpt cell spiked to 20.27 at step 2; the loss falls in (a))
        check(len(fp[0]["losses"]) == len(bf[0]["losses"]) == DIST_STEPS
              and all(np.isfinite(fp[0]["losses"] + bf[0]["losses"])),
              f"[dist] (b) losses fp32 {fp[0]['losses']}, bf16 {bf[0]['losses']}")
        check(bf[0]["residual_digests"] != bf[1]["residual_digests"]
              and bf[0]["residual_abs_max"] > 0,
              "[dist] (b) the bf16 wire's residual rows should be nonzero and each rank's own")
        # the preempted run and its resume against the uninterrupted one
        stop, resume = res["bf16-stop"], res["bf16-resume"]
        check(stop[0]["preempted"] and stop[1]["preempted"]
              and stop[0]["step"] == stop[1]["step"] == DIST_SIGTERM_AT + 1
              and kept == DIST_SIGTERM_AT + 1,
              f"[dist] (b) SIGTERM to rank 1 at step {DIST_SIGTERM_AT}: preempted "
              f"{[r['preempted'] for r in stop]} at {[r['step'] for r in stop]}, LATEST {kept}")
        check(man["extra"] == {"wire_format": "bf16"}
              and all(s[0] == 2 for s in man["shapes"][-len(bf[0]["residual_digests"]):]),
              f"[dist] (b) the checkpoint's stamp {man['extra']} or residual stacks")
        for r in range(2):
            check(resume[r]["digests"] == bf[r]["digests"]
                  and resume[r]["residual_digests"] == bf[r]["residual_digests"]
                  and stop[r]["losses"] + resume[r]["losses"] == bf[r]["losses"],
                  f"[dist] (b) rank {r}: preempted + resumed != uninterrupted")
        check("[loop] wire replica count changed since checkpoint; zero-initialized "
              "error-feedback buffers" in one_log and one_done[:2] == (kept + 1, 1)
              and all(np.isfinite(one_done[2])),
              f"[dist] (b) the 1-process resume: {one_log}")
        # the fp32 wire's step 1 against a 1-process step on the whole batch
        check(d <= 0.05, f"[dist] (b) fp32 wire step 1 vs a 1-process step: max |diff| {d}")
        for name, pair in res.items():
            a = pair[0]
            steps = len(a["losses"])
            steady = a["step_s"][1:] or a["step_s"]
            per_step = {k: v // steps for k, v in a["wire_bytes"].items()}
            print(f"[dist] (b) {name} on {card}: 2 ranks over gloo on one card, "
                  f"{a['wire']} x{a['replicas']}, {steps} steps, losses "
                  f"{[round(x, 4) for x in a['losses']]}; step walls "
                  f"{[round(1e3 * x, 1) for x in a['step_s']]} ms (steady "
                  f"{1e3 * sum(steady) / len(steady):.1f}); host copies "
                  f"{1e3 * a['host_copy_s'] / steps:.1f} ms/step; wire "
                  f"{per_step} bytes/step/rank; peak {a['peak_gib']:.2f} GiB per rank")
        ratio = sum(fp[0]["wire_bytes"].values()) / sum(bf[0]["wire_bytes"].values())
        check(abs(ratio - 2.0) < 1e-9, f"[dist] (b) fp32 / bf16 wire bytes {ratio}")
        print(f"[dist] (b) on {card}: ranks bitwise equal in all 4 runs; fp32 wire step 1 "
              f"within {d:.3e} of a 1-process step (bar 0.05); SIGTERM to rank 1 at step "
              f"{DIST_SIGTERM_AT} stopped both with a checkpoint at step {kept}, a fresh 2-rank "
              f"launch resumed to step {DIST_STEPS} equal to the uninterrupted run on every "
              f"leaf and residual row; a 1-process resume zero-initialized the residuals "
              f"(2 -> 1 replicas) and trained on; wire bytes fp32 / bf16 = {ratio:.3f}; "
              f"launch walls {wall_1:.1f}, {wall_2:.1f} s and the 4-rank FSDP pod launch's "
              f"{wall_4:.1f} s beside the first (the 1-process resume, {wall_3:.1f} s, the "
              f"step and the FSDP restore ran here during the second); the step walls of "
              f"the first launch's runs (fp32, bf16, bf16-stop and FSDP's dp-plain, "
              f"fsdp-plain, fsdp, fsdp-stop) are taken with the 4-rank launch sharing the "
              f"card and the host cores for part of them, so they compare neither with "
              f"each other nor with a run alone (tools/port_fsdp.py times DP-2 and FSDP-2 "
              f"alone)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def fsdp_philox_check(card: str) -> None:
    """The Philox fill's shard entry (what a non-fused SR write on an FSDP
    shard draws): on the card ``torch.equal`` to the whole-leaf fill's
    slice at the embedding's and an MLP leaf's shard, and to the plain
    version at the attention key leaf's shard and at odd shapes whose runs
    start mid-block; its time beside the whole-leaf fill and a copy of its
    slice (the other way to get the same words), and its bytes bound."""
    import torch
    from repro_torch.kernels.philox import philox_bits
    PH = kernel_module("philox")
    before = PH.LAUNCHES
    seed = 0x5EED_F5D9
    cases = [((151936, 2048), 0, 75968, 75968), ((2, 2048, 11008), 2, 5504, 5504),
             ((2, 2048, 256), 1, 1024, 1024), ((3, 10, 7), 1, 5, 5), ((5, 9), 1, 3, 3)]
    for full_shape, dim, start, ext in cases:
        shape = list(full_shape)
        shape[dim] = ext
        got = philox_bits(seed, shape, "cuda", full_shape=full_shape, dim=dim, start=start)
        if math.prod(full_shape) > 2**22:
            want = philox_bits(seed, full_shape, "cuda").narrow(dim, start, ext)
            check(torch.equal(got, want), f"[fsdp] philox shard {shape} of {full_shape} "
                                          f"!= the whole fill's slice")
        if math.prod(shape) <= 2**20:
            plain = philox_bits(seed, shape, "cpu", full_shape=full_shape, dim=dim,
                                start=start)
            check(torch.equal(got.cpu(), plain), f"[fsdp] philox shard {shape} of "
                                                 f"{full_shape} != its plain version")
        del got
    full_shape, dim, start, ext = cases[0]
    shape = (ext, full_shape[1])
    shard_ms = event_ms(lambda: philox_bits(seed, shape, "cuda", full_shape=full_shape,
                                            dim=dim, start=start))
    whole_ms = event_ms(lambda: philox_bits(seed, full_shape, "cuda").narrow(
        dim, start, ext).contiguous())
    bound_ms = math.prod(shape) * 4 / HBM_BYTES_PER_S * 1e3
    PH.LAUNCHES = before                  # checks, not the main path
    torch.cuda.empty_cache()
    print(f"[fsdp] philox shard entry on {card}: torch.equal to the whole fill's slice and "
          f"to the plain version on {len(cases)} shards; embedding shard {shape} of "
          f"{full_shape}: {shard_ms:.4f} ms (bound {bound_ms:.4f} ms, 4 B written per word) "
          f"against {whole_ms:.4f} ms for the whole leaf's fill and a copy of its slice")


def _fsdp_checks(card: str, fres: dict, dp_fused: list, fkept: int, fat: int,
                 one_fsdp: list) -> None:
    """The FSDP runs' checks (ROADMAP A9) and their numbers: (a) non-fused
    FSDP-2 == DP-2 on every gathered leaf, ``philox`` (the shard entry) and
    ``sr_cast`` on shards; (b) a shard's fused AdamW == its plain version
    with the folded seed, and the fused FSDP-2 run held to the fused fp32
    DP-2 run ``dp_fused``: step 0's loss equal, every loss within 0.05,
    every leaf's compensated weights after step 1 within
    :data:`FSDP_FUSED_DRIFT_BAR` of the DP run's movement; (c) the state
    bytes per rank; (d) SIGTERM to rank 1 and a fresh launch resume
    bitwise, the checkpoint equal in one
    process to the gathered state; (e) the pod replicas' shards equal and
    the wire's bytes by dtype. Prints ms per step, the gather and
    reduce-scatter bytes, host-copy ms and peak GiB per rank."""
    plain, dp = fres["fsdp-plain"], fres["dp-plain"]
    n_leaves = len(plain[0]["digests"])
    # (a)
    check(plain[0]["fsdp"]["full_digests"] == dp[0]["fsdp"]["full_digests"]
          and plain[0]["losses"] == dp[0]["losses"] == plain[1]["losses"],
          f"[fsdp] (a) non-fused FSDP-2 != DP-2 after {FSDP_PLAIN_STEPS} steps "
          f"({sum(a != b for a, b in zip(plain[0]['fsdp']['full_digests'], dp[0]['fsdp']['full_digests']))}"
          f" leaves differ; losses {plain[0]['losses']} vs {dp[0]['losses']})")
    for r in plain:
        got, want = r["launches"], r["n_params"] * FSDP_PLAIN_STEPS
        check(got["philox"] == got["sr_cast"] == want and got["fused_adamw"] == 0,
              f"[fsdp] (a) rank {r['rank']}: launches {got}, expected {want} of philox and "
              f"sr_cast")
    # (b)
    fused = fres["fsdp"]
    pc = fused[0]["fsdp"]["plain_check"]
    check(pc["equal"], f"[fsdp] (b) {pc}: the card's fused_adamw != its plain version")
    check(all(r["launches"]["fused_adamw"] == r["n_params"] * DIST_STEPS for r in fused),
          f"[fsdp] (b) fused_adamw launches {[r['launches'] for r in fused]}")
    fl, dl = fused[0]["losses"], dp_fused[0]["losses"]
    loss_gap = max(abs(a - b) for a, b in zip(fl, dl))
    check(len(fl) == len(dl) == DIST_STEPS and fl[0] == dl[0] and loss_gap <= 0.05,
          f"[fsdp] (b) fused FSDP-2 losses {fl} vs the fused fp32 DP-2 run's {dl}")
    drift = fused[0]["fsdp"]["after_1"]
    worst = max(range(len(drift)), key=drift.__getitem__)
    check(len(drift) == fused[0]["n_params"] and drift[worst] <= FSDP_FUSED_DRIFT_BAR,
          f"[fsdp] (b) leaf {worst}: fused FSDP-2's compensated weights after step 1 are "
          f"off by {drift[worst]:.4f} of the fused DP-2 run's movement from init (bar "
          f"{FSDP_FUSED_DRIFT_BAR}); all {[round(x, 4) for x in drift]}")
    # (c)
    ratio = plain[0]["fsdp"]["state_bytes"] / dp[0]["fsdp"]["state_bytes"]
    check(ratio <= FSDP_BYTES_BAR, f"[fsdp] (c) FSDP / DP state bytes {ratio:.4f}")
    # (d)
    stop, resume = fres["fsdp-stop"], fres["fsdp-resume"]
    check(all(r["preempted"] and r["step"] == DIST_SIGTERM_AT + 1 for r in stop)
          and fkept == fat == DIST_SIGTERM_AT + 1,
          f"[fsdp] (d) preempted {[r['preempted'] for r in stop]} at "
          f"{[r['step'] for r in stop]}, LATEST {fkept}")
    for r in range(2):
        check(resume[r]["digests"] == fused[r]["digests"]
              and stop[r]["losses"] + resume[r]["losses"] == fused[r]["losses"],
              f"[fsdp] (d) rank {r}: preempted + resumed != uninterrupted")
    check(one_fsdp == stop[0]["fsdp"]["full_digests"],
          "[fsdp] (d) the checkpoint in one process != the gathered FSDP-2 state")
    # (e)
    pods = fres["fsdp-pods"]
    by = {(r["fsdp"]["coords"]["pod"], r["fsdp"]["coords"]["fsdp"]): r for r in pods}
    for f in range(2):
        a, b = by[(0, f)], by[(1, f)]
        check(a["digests"] == b["digests"] and a["residual_digests"] != b["residual_digests"],
              f"[fsdp] (e) fsdp shard {f}: the pods' shards differ, or their residual rows "
              f"agree")
    for r in pods:
        steps = len(r["losses"])
        want = {"float32": 4 * r["fsdp"]["numel_full"] * steps,
                "bfloat16": 2 * r["fsdp"]["numel_local"] * steps}
        check(r["wire_bytes"] == want, f"[fsdp] (e) rank {r['rank']}: wire bytes "
                                       f"{r['wire_bytes']} != {want}")
    for name, runs in fres.items():
        a = runs[0]
        steps = max(len(a["losses"]), 1)
        steady = a["step_s"][1:] or a["step_s"]
        per = lambda d: {k: v // steps for k, v in d.items()}  # noqa: E731
        print(f"[fsdp] {name} on {card}: {len(runs)} ranks over gloo on one card, "
              f"{a['wire']} x{a['replicas']}, {steps} steps, losses "
              f"{[round(x, 4) for x in a['losses']]}; step walls "
              f"{[round(1e3 * x, 1) for x in a['step_s']]} ms (steady "
              f"{1e3 * sum(steady) / len(steady):.1f}); gather "
              f"{per(a['fsdp'].get('gather_bytes', {}))} B/step, reduce-scatter "
              f"{a['fsdp'].get('scatter_bytes', 0) // steps} B/step, wire {per(a['wire_bytes'])}"
              f" B/step per rank; host copies {1e3 * a['host_copy_s'] / steps:.1f} ms/step; "
              f"state {a['fsdp'].get('state_bytes', 0) / 1e9:.3f} GB; peak "
              f"{max(r['peak_gib'] for r in runs):.2f} GiB per rank; launches {a['launches']}")
    print(f"[fsdp] on {card}: (a) non-fused FSDP-2 == DP-2 on all {n_leaves} gathered leaves "
          f"after {FSDP_PLAIN_STEPS} steps, philox and sr_cast on shards; (b) {pc['leaf']} "
          f"shard {pc['index']} {pc['shape']}: fused_adamw == plain with the folded seed; "
          f"fused FSDP-2 vs the fused fp32 DP-2 run: step 0's loss equal, losses within "
          f"{loss_gap:.2e} (bar 0.05), compensated weights after step 1 off by at most "
          f"{drift[worst]:.4f} of their movement from init (leaf {worst}; median "
          f"{sorted(drift)[len(drift) // 2]:.4f}; bar {FSDP_FUSED_DRIFT_BAR}); (c) state bytes "
          f"FSDP / DP = {ratio:.4f} "
          f"({plain[0]['fsdp']['state_bytes']} / {dp[0]['fsdp']['state_bytes']}; bar "
          f"{FSDP_BYTES_BAR}); (d) SIGTERM to rank 1 at step {DIST_SIGTERM_AT}: a fresh launch "
          f"resumed bitwise, the checkpoint in one process == the gathered state; (e) pods 2 x "
          f"fsdp 2: the pods' shards bitwise equal, wire bytes by dtype as counted")


# ROADMAP A10's serving part: tensor-parallel serving on (data, model) meshes
TP_SERVE_LAYERS = 2       # (a)'s depth cut of full-width qwen2.5-3b, for the script's time
TP_LAYERS = 2             # (b)'s and (c)'s depth cut of full-width qwen2.5-3b
TP_GENERATE = 1           # (a): requests (the shortest) lock-step generate re-derives
# (b): the serve-paged stream's first 10 requests on a pool of 32 pages of
# 16 (views of 512 tokens): 10 preemptions and 9 prefix hits at chunk 1
TP_PAGED_REQUESTS, TP_PAGED_MAX_LEN, TP_PAGED_PAGES = 10, 512, 32
# (a): the 1 x 2 step's first-prefill logits against the 1-rank step's, at
# most this share of the largest |logit| of the 1-rank step: the model axis
# reassociates the row-parallel f32 sums (ROADMAP C18) and a bf16 rounding
# that flips moves through the layers; the reference's own prefill ==
# decode bound, as the families' lock-step checks use
TP_LOGIT_BAR = 0.05
# (d): the f32 entry's shapes: the row-parallel products of qwen2.5-3b at
# model 2 for one serve step's 8 lanes (wo: 1024 -> 2048, w_down: 5504 ->
# 2048), and one training-size product
QMATMUL_F32_SHAPES = {"tp wo, 8 lanes": (8, 2048, 1024),
                      "tp w_down, 8 lanes": (8, 2048, 5504),
                      "mlp down, 4096 rows": (4096, 2048, 11008)}
QMATMUL_F32_ROW = "tp w_down, 8 lanes"     # the kernels line's shape
# ... and the MoE and Mamba families' row-parallel partials at model 2 for
# one serve step's 8 lanes (ROADMAP A12): mixtral's per-expert down product
# (decode routes with capacity T*k = 16 rows per expert; K = d_ff / 2),
# falcon-mamba's x_proj (N = dt_rank + 2 * ssm_state = 288) and out_proj
QMATMUL_F32_SHAPES.update({"mixtral we_down, 16 rows": (16, 6144, 8192),
                           "mamba x_proj, 8 lanes": (8, 288, 4096),
                           "mamba out_proj, 8 lanes": (8, 4096, 4096)})

# the tp-families phase (ROADMAP A12, item 1): the MoE and Mamba families on
# 1 data x 2 model ranks sharing the card over gloo, at published widths,
# depth cut. Serving: (arch, layers, paged rerun) on the families' stream
TP_FAM_SERVE = (("falcon-mamba-7b", 8, False), ("llama4-scout-17b-a16e", 1, False),
                ("mixtral-8x22b", 2, True))
# training: (arch, layers, the leaf whose shard's fused_adamw is held to its
# plain version), each beside a 1-process run of the same steps
TP_FAM_TRAIN = (("mixtral-8x22b", 1, "layers.b0.mixer.wk.kernel"),
                ("falcon-mamba-7b", 2, "layers.b0.mixer.x_proj.kernel"))
# (lr 1e-4: at 3e-3 both one-layer models' losses rise ~3x by step 2, in one
# process as on 1 x 2)
TP_FAM_TRAIN_ARGV = ["--policy", "bf16_sr_kahan", "--fused-update", "--batch", "1",
                     "--seq", "512", "--steps", "3", "--lr", "1e-4", "--seed", "0",
                     "--device", "cuda"]
TP_FAM_TRAIN_STEPS = 3


def _tp_model(spec: dict, layers: int | None, arch: str = "qwen2.5-3b"):
    """The tp runs' model: full-width ``arch`` (``layers`` cut), or the
    reduced config in a CPU rehearsal."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models import registry as R
    cfg = R.get_config(arch)
    if spec.get("reduced"):
        cfg = cfg.reduced()
    elif layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    policy = get_policy("bf16_standard")
    return R.init(cfg, 0, policy.param_dtype, device=spec["device"]), cfg, policy


def _tp_sync(dev: str) -> None:
    """Wait for the card (``dev`` "cuda"); nothing on the CPU."""
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def _tp_nbytes(tree) -> int:
    """The bytes of a tree's tensors."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _tp_tokens(res) -> dict:
    """A stream's completions as {request id: tokens}."""
    return {str(c.rid): c.tokens.tolist() for c in res.completions}


def _tp_shard(params, cfg, mesh, dev: str):
    """This rank's shards of whole ``params`` on ``mesh``
    (``partition.param_specs``), the card's cache emptied after."""
    import torch
    from repro_torch.dist import fsdp as F
    from repro_torch.dist import partition as PT
    local = F.shard_state(params, PT.param_specs(params, cfg, mesh), mesh)
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return local


def _tp_counts() -> dict:
    """Zero every serve-step kernel count; returns the modules."""
    mods = {k: kernel_module(k) for k in ("decode_attention", "qmatmul", "row_mean_sq")}
    for m in mods.values():
        m.LAUNCHES = 0
    mods["decode_attention"].PAGED_LAUNCHES = mods["qmatmul"].F32_LAUNCHES = 0
    return mods


def _tp_read(mods) -> dict:
    return {"decode_attention": mods["decode_attention"].LAUNCHES,
            "paged_decode_attention": mods["decode_attention"].PAGED_LAUNCHES,
            "qmatmul": mods["qmatmul"].LAUNCHES, "qmatmul_f32": mods["qmatmul"].F32_LAUNCHES,
            "row_mean_sq": mods["row_mean_sq"].LAUNCHES}


def tp_worker(spec_path: str) -> None:
    """One rank of the tp phase (``python3 chip_smoke.py --tp-worker SPEC``
    under ``repro_torch.launch.dist_launch``, gloo on the one card):
    scenario ``full`` (2 ranks: (a) at full depth), ``cut`` (2 ranks: (b)
    and (c)'s 1 x 2 at ``TP_LAYERS``) or ``quad`` (4 ranks: (c)'s 2 x 2).
    Writes ``<out>/<scenario>.rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.dist import axes
    from repro_torch.dist import multihost as MH
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve_stream
    from repro_torch.models import registry as R
    from repro_torch.serve.decode import generate
    from repro_torch.serve.engine import Engine
    from repro_torch.train.step import make_serve_step

    spec = json.loads(Path(spec_path).read_text())
    if spec["scenario"].startswith("train-"):
        try:
            out = tp_train_worker(spec)
        finally:
            MH.shutdown()
        Path(spec["out"], f"{spec['scenario']}.rank{out['rank']}.json").write_text(json.dumps(out))
        return
    dev = spec["device"]
    MH.initialize(device=dev, backend="gloo", timeout_secs=300)
    rank = MH.process_index()
    out = {"rank": rank}

    try:
        if spec["scenario"] in DP_PAGED:
            out.update(dp_paged_worker(spec))
        elif spec["scenario"].startswith("hyb-"):
            out.update(tp_hybrid_worker(spec))
        elif spec["scenario"] == "fam-serve":
            import torch.distributed as tdist
            mesh = make_local_mesh(1, 2)
            axis = axes.for_mesh(mesh)
            for arch, layers, paged in TP_FAM_SERVE:
                # rank 1 draws the whole model once rank 0 has sharded its
                # own: both at once would hold two whole models on the card
                if rank == 1:
                    tdist.barrier()
                params, cfg, policy = _tp_model(spec, layers, arch)
                stream = family_stream(cfg.vocab)
                res = {"n_layers": cfg.n_layers, "weights": [_tp_nbytes(params)]}
                if rank == 0:
                    # the 1-rank engine's tokens at this depth (CUDA graphs);
                    # rank 1 waits at the next collective
                    one = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC,
                                 fused_decode=True, device=dev)
                    res["one_tokens"] = _tp_tokens(serve_stream(one, stream))
                    del one
                params = _tp_shard(params, cfg, mesh, dev)
                if rank == 0:
                    tdist.barrier()
                res["weights"].append(_tp_nbytes(params))
                eng = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC,
                             fused_decode=True, device=dev, mesh=mesh)
                _tp_sync(dev)
                calls0, s0, h0 = axis.stats.calls, axis.stats.seconds, axis.stats.host_copy_s
                mods = _tp_counts()
                r = serve_stream(eng, stream)
                res.update(launches=_tp_read(mods), tokens=_tp_tokens(r), steps=r.calls,
                           seconds=r.seconds, finished=eng.stats.finished,
                           graphs=len(eng.graphs), collectives=axis.stats.calls - calls0,
                           collective_s=axis.stats.seconds - s0,
                           host_copy_s=axis.stats.host_copy_s - h0)
                del eng
                if paged:
                    eng = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC,
                                 fused_decode=True, device=dev, mesh=mesh, paged=True,
                                 page_size=PAGE)
                    mods = _tp_counts()
                    r = serve_stream(eng, stream)
                    res["paged"] = dict(tokens=_tp_tokens(r), steps=r.calls,
                                        seconds=r.seconds, launches=_tp_read(mods))
                    del eng
                _tp_sync(dev)
                res["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                                   if dev == "cuda" else 0.0)
                out[arch] = res
                del params
                if dev == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
        elif spec["scenario"] == "quad":
            mesh = make_local_mesh(2, 2)
            params, cfg, policy = _tp_model(spec, TP_LAYERS)
            params = _tp_shard(params, cfg, mesh, dev)
            eng = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC, fused_decode=True,
                         device=dev, mesh=mesh)
            res = serve_stream(eng, main_stream(cfg.vocab))
            out.update(tokens=_tp_tokens(res), coords=mesh.coords(rank), slots=eng.pool.slots,
                       steps=res.calls, seconds=res.seconds,
                       token_gather_s=eng.token_gather.seconds)
        elif spec["scenario"] == "cut":
            mesh = make_local_mesh(1, 2)
            params, cfg, policy = _tp_model(spec, TP_LAYERS)
            params = _tp_shard(params, cfg, mesh, dev)
            pstream = paged_stream(cfg.vocab)[:TP_PAGED_REQUESTS]
            out["paged"] = {"n_layers": cfg.n_layers}
            for chunk in (1, CHUNK):
                eng = Engine(params, cfg, policy, n_slots=8, max_len=TP_PAGED_MAX_LEN,
                             fused_decode=True, device=dev, mesh=mesh, paged=True,
                             page_size=PAGE, n_pages=TP_PAGED_PAGES, prefill_chunk=chunk)
                mods = _tp_counts()
                res = serve_stream(eng, pstream)
                eng.pool.check_invariants()
                out["paged"][str(chunk)] = dict(
                    tokens=_tp_tokens(res), steps=res.calls, seconds=res.seconds,
                    preemptions=eng.stats.preemptions, prefix_hits=eng.stats.prefix_hits,
                    launches=_tp_read(mods), finished=eng.stats.finished)
                del eng
            eng = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC, fused_decode=True,
                         device=dev, mesh=mesh)
            res = serve_stream(eng, main_stream(cfg.vocab))
            out["cut"] = dict(tokens=_tp_tokens(res), steps=res.calls, seconds=res.seconds)
        else:
            mesh = make_local_mesh(1, 2)
            # (a) the first prefill step, 1 rank against 1 x 2
            params, cfg, policy = _tp_model(spec, TP_SERVE_LAYERS)
            stream = main_stream(cfg.vocab)
            first = torch.tensor([[int(p[0])] for _, p, _ in stream[:8]], dtype=torch.int32,
                                 device=dev)
            pos0 = torch.zeros(8, dtype=torch.int32, device=dev)
            on = torch.ones(8, dtype=torch.bool, device=dev)

            def first_step(p, m):
                step = make_serve_step(cfg, policy, fused_decode=True, return_logits=True,
                                       mesh=m)
                cache = R.make_cache(p, cfg, batch_size=8, max_len=MAIN_SC,
                                     dtype=policy.compute_dtype, mesh=m)
                with torch.no_grad():
                    _, logits, _ = step(p, cache, first, pos0, on, on)
                kv = sum(t.numel() * t.element_size() for blk in cache["layers"].values()
                         for t in blk)
                return logits.float().cpu(), kv

            one_logits, one_kv = first_step(params, None)
            one_weights = _tp_nbytes(params)
            if rank == 0:
                # the 1-rank engine's tokens at this depth (CUDA graphs), for
                # the token agreement; rank 1 waits at the next collective
                one = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC,
                             fused_decode=True, device=dev)
                out["one_tokens"] = _tp_tokens(serve_stream(one, stream))
                del one
            params = _tp_shard(params, cfg, mesh, dev)
            tp_logits, tp_kv = first_step(params, mesh)
            out["first_logits_diff"] = float((tp_logits - one_logits).abs().max())
            out["first_logits_scale"] = float(one_logits.abs().max())
            out["first_logits_equal"] = bool(torch.equal(tp_logits, one_logits))
            out["weights"] = [one_weights, _tp_nbytes(params)]
            out["kv"] = [one_kv, tp_kv]
            # (a) the engine on the serve phase's traffic, eager steps
            axis = axes.for_mesh(mesh)
            eng = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC, fused_decode=True,
                         device=dev, mesh=mesh)
            warm = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC, fused_decode=True,
                          device=dev, mesh=mesh)
            warm.submit(np.arange(4, dtype=np.int32), 2)
            warm.run()
            del warm
            _tp_sync(dev)
            calls0, s0, h0 = axis.stats.calls, axis.stats.seconds, axis.stats.host_copy_s
            mods = _tp_counts()
            res = serve_stream(eng, stream)
            out["launches"] = _tp_read(mods)
            out.update(tokens=_tp_tokens(res), steps=res.calls, n_layers=cfg.n_layers, seconds=res.seconds,
                       graphs=len(eng.graphs), kv_pool=eng.pool.nbytes(),
                       collectives=axis.stats.calls - calls0,
                       collective_s=axis.stats.seconds - s0,
                       host_copy_s=axis.stats.host_copy_s - h0,
                       finished=eng.stats.finished)
            # engine == lock-step generate under the same mesh, the batch
            # padded to the engine's 8 rows
            gen = {}
            with dispatch.fused_decode():
                for c in sorted(res.completions,
                                key=lambda c: c.prompt.size + c.tokens.size)[:TP_GENERATE]:
                    rows = np.stack([c.prompt] + [np.zeros(c.prompt.size, np.int32)] * 7)
                    ref = generate(params, cfg, policy, rows, max_new_tokens=c.tokens.size,
                                   cache_len=MAIN_SC, device=dev, mesh=mesh)
                    gen[str(c.rid)] = ref[0, c.prompt.size:].tolist()
            out["generate"] = gen
        _tp_sync(dev)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else 0.0
        Path(spec["out"], f"{spec['scenario']}.rank{rank}.json").write_text(json.dumps(out))
    finally:
        MH.shutdown()


def _tp_start(root: Path, scenario: str, n: int, device: str = "cuda",
              reduced: bool = False) -> tuple:
    """Start ``scenario`` on n ranks through the port's launcher;
    :func:`_tp_wait` ends it."""
    spec = {"out": str(root), "scenario": scenario, "device": device, "reduced": reduced,
            "ck": str(root / "train-ck")}
    spec_path = root / f"tp-{scenario}.json"
    spec_path.write_text(json.dumps(spec))
    log_dir = root / f"tp-{scenario}-logs"
    cmd = [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", str(n), "--timeout",
           "560", "--log-dir", str(log_dir), "--", sys.executable, str(ROOT / "chip_smoke.py"),
           "--tp-worker", str(spec_path)]
    # a CPU rehearsal's ranks take one thread each: side by side, more
    # oversubscribe the host's cores and stall the gloo collectives
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **({"OMP_NUM_THREADS": "1"} if device == "cpu" else {}))
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    return proc, time.perf_counter(), root, scenario, n


def _tp_wait(launch: tuple) -> tuple[list, float]:
    """Every rank's result and the launch's wall seconds; fails with the
    ranks' log tails if a rank failed, and kills the launch at 600 s."""
    proc, t0, root, scenario, n = launch
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log_dir = root / f"tp-{scenario}-logs"
    check(proc.returncode == 0, f"[tp] {scenario}: exit {proc.returncode}\n" + "\n".join(
        (log_dir / f"rank{i}.log").read_text()[-3000:] for i in range(n)) + err[-3000:])
    wall = time.perf_counter() - t0
    return [json.loads((root / f"{scenario}.rank{r}.json").read_text()) for r in range(n)], wall


def tp_train_launches(run: dict, start) -> None:
    """Phase 17's launches, into ``run``: (a), (b) and (c)'s restores on 2
    ranks beside (c) on 4. ``start(scenario, n)`` starts one
    (:func:`_tp_start`)."""
    launches = [start("train-quad", 4), start("train-pair", 2)]
    run["train-quad"], run["train-pair"] = [_tp_wait(x) for x in launches]


def tp_families_launches(run: dict, start) -> None:
    """The tp-families phase's launches alone, into ``run``: training and
    serving on 2 ranks each, side by side (mixtral's one-process training
    state peaks at 38.55 GiB, the serving ranks at ~21 GiB: serving draws
    mixtral last, one rank at a time). ``start(scenario, n)`` starts one
    (:func:`_tp_start`); ``chip_smoke.py`` itself runs them beside the tp
    serving launches (:func:`tp_start`)."""
    launches = [start("train-fam", 2), start("fam-serve", 2)]
    run["train-fam"], run["fam-serve"] = [_tp_wait(x) for x in launches]


def tp_start(*, rehearsal: bool = False) -> dict:
    """Start the tp phase's launches on a thread of this process: (a)
    beside phase 18's training, then (b) and (c) beside its serving, then
    phase 17's; :func:`phase_tp` joins it. A launch still
    running when this process exits is ended (its launcher forwards the
    SIGTERM to its ranks)."""
    import atexit
    import tempfile
    import threading
    kw = dict(device="cpu", reduced=True) if rehearsal else {}
    run = {"root": Path(tempfile.mkdtemp(prefix="repro-tp-")), "t0": time.perf_counter(),
           "procs": []}

    def start(name, n):
        launch = _tp_start(run["root"], name, n, **kw)
        run["procs"].append(launch[0])
        return launch

    def go():
        try:
            # phase 18's launches ride beside phase 16's: its training (one
            # process of 1-layer mixtral peaks at 38.55 GiB) beside (a), its
            # serving (~21 GiB) beside (b) and (c)
            fam = start("train-fam", 2)
            run["full"] = _tp_wait(start("full", 2))
            run["train-fam"] = _tp_wait(fam)
            fam = start("fam-serve", 2)
            launches = [start(name, n) for name, n in (("cut", 2), ("quad", 4))]
            run["cut"], run["quad"] = [_tp_wait(x) for x in launches]
            run["fam-serve"] = _tp_wait(fam)
            tp_train_launches(run, start)
        except BaseException as e:      # check() exits: re-raised by phase_tp
            run["error"] = e

    def end():
        for p in run["procs"]:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
    atexit.register(end)
    run["thread"] = threading.Thread(target=go, daemon=True)
    run["thread"].start()
    return run


def phase_tp(card: str, run: dict | None = None, *, rehearsal: bool = False) -> dict:
    """ROADMAP A10's serving part on the card: ``Engine(mesh=)`` over ranks
    that share the card over gloo (``repro_torch.launch.dist_launch``).

    (a) 1 x 2 (model 2), full-width qwen2.5-3b (``TP_SERVE_LAYERS``, seed 0,
    ``bf16_standard``), the serve phase's traffic (8 slots, max_len 256, 12
    greedy requests, fused decode), eager steps: both ranks' tokens
    bitwise equal; engine == lock-step ``generate`` under the same mesh
    for ``TP_GENERATE`` requests; the first prefill step's logits within
    ``TP_LOGIT_BAR`` of the 1-rank step's largest |logit|; the token
    agreement with a 1-rank engine at the same depth (rank 0, graphs),
    weight and KV bytes per rank against one rank's, ms per eager step,
    the model axis's collective and host-copy ms per step, and the
    kernels' launches per step (``qmatmul_f32`` twice per layer).
    (b) paged 1 x 2 at ``TP_LAYERS`` on the paged phase's first
    ``TP_PAGED_REQUESTS`` requests (``TP_PAGED_PAGES`` pages of 16, prefix
    cache): at least one preemption and one prefix hit, and chunk 32 ==
    chunk 1 bitwise.
    (c) 2 x 2 on 4 ranks at ``TP_LAYERS``: tokens == the 1 x 2 run's at the
    same cut, bitwise. (b) and (c) run side by side. ``run`` is
    :func:`tp_start`'s (started here if None). Returns the (a) run's kernel
    launches. ``rehearsal`` runs the reduced config on the CPU, where no
    kernel launches."""
    import shutil
    import numpy as np
    run = run or tp_start(rehearsal=rehearsal)
    run["thread"].join()
    shutil.rmtree(run["root"], ignore_errors=True)
    if "error" in run:
        raise run["error"]
    (full, full_wall), (cut, cut_wall), (quad, quad_wall) = run["full"], run["cut"], run["quad"]
    r0, c0 = full[0], cut[0]
    for res in full[1:]:
        check((res["tokens"], res["generate"]) == (r0["tokens"], r0["generate"]),
              f"[tp] (a) rank {res['rank']}'s tokens != rank 0's")
        check(res["launches"] == r0["launches"] and res["steps"] == r0["steps"],
              f"[tp] (a) rank {res['rank']}: launches or steps differ from rank 0's")
    for res in cut[1:]:
        check(res["cut"]["tokens"] == c0["cut"]["tokens"] and all(
            res["paged"][c]["tokens"] == c0["paged"][c]["tokens"] for c in ("1", str(CHUNK))),
            f"[tp] (b) rank {res['rank']}'s tokens != rank 0's")
    # (a)
    check(r0["finished"] == 12 and r0["graphs"] == 0,
          f"[tp] (a) finished {r0['finished']}/12, graphs {r0['graphs']} (eager steps)")
    for rid, toks in r0["generate"].items():
        check(toks == r0["tokens"][rid], f"[tp] rid {rid}: engine {r0['tokens'][rid]} != "
              f"generate {toks}")
    share = r0["first_logits_diff"] / r0["first_logits_scale"]
    check(share <= TP_LOGIT_BAR, f"[tp] first prefill logits differ by {share:.4f} of the "
          f"largest |logit| (bar {TP_LOGIT_BAR})")
    one_rank_tokens = r0["one_tokens"]
    same = sum(int(np.sum(np.asarray(r0["tokens"][rid]) == np.asarray(t)))
               for rid, t in one_rank_tokens.items())
    total = sum(len(t) for t in one_rank_tokens.values())
    firsts = sum(r0["tokens"][rid][0] == t[0] for rid, t in one_rank_tokens.items())
    per = {k: n / r0["steps"] for k, n in r0["launches"].items() if n}
    n_layers = r0["n_layers"]
    check(rehearsal or (per.get("qmatmul_f32") == 2 * n_layers
                        and per.get("decode_attention") == n_layers),
          f"[tp] (a) launches per step {per}: expected 2 qmatmul_f32 and 1 decode per layer")
    step_ms = 1e3 * r0["seconds"] / r0["steps"]
    (w1, w2), (k1, k2) = r0["weights"], r0["kv"]
    print(f"[tp] (a) on {card}: 1 x 2 over gloo, qwen2.5-3b {n_layers} layers, "
          f"{r0['steps']} eager serve steps (no graphs) in {r0['seconds']:.2f}s -> "
          f"{step_ms:.2f} ms per step; model-axis collectives {r0['collectives'] / r0['steps']:.0f} "
          f"per step taking {1e3 * r0['collective_s'] / r0['steps']:.2f} ms per step, of which "
          f"host copies {1e3 * r0['host_copy_s'] / r0['steps']:.2f} ms; launches per step "
          f"{per}; weights {w2 / 2**30:.3f} GiB per rank ({w2 / w1:.4f} of one rank's "
          f"{w1 / 2**30:.3f}), KV {k2 / 2**20:.1f} MiB ({k2 / k1:.4f} of {k1 / 2**20:.1f}); "
          f"peak {r0['peak_gib']:.2f} GiB per rank; both ranks' tokens bitwise equal; "
          f"engine == generate on {len(r0['generate'])} requests; first prefill logits "
          f"within {share:.5f} of the largest |logit| {r0['first_logits_scale']:.3f} "
          f"(bar {TP_LOGIT_BAR}; bitwise equal: {r0['first_logits_equal']}); tokens equal "
          f"to the 1-rank engine's: {same}/{total}, first tokens {firsts}/{len(one_rank_tokens)}; "
          f"launch wall {full_wall:.1f}s (beside the paper sections and the ckpt phase: "
          f"the walls are contended)")
    # (b)
    p1, p32 = c0["paged"]["1"], c0["paged"][str(CHUNK)]
    check(p1["finished"] == p32["finished"] == TP_PAGED_REQUESTS,
          "[tp] (b) a paged run did not finish")
    check(p1["preemptions"] >= 1 and p1["prefix_hits"] >= 1,
          f"[tp] (b) chunk 1: {p1['preemptions']} preemptions, {p1['prefix_hits']} hits")
    check(p32["tokens"] == p1["tokens"], "[tp] (b) paged chunk 32 != chunk 1")
    check(rehearsal or p1["launches"]["paged_decode_attention"]
          == c0["paged"]["n_layers"] * p1["steps"],
          f"[tp] (b) paged launches {p1['launches']} for {p1['steps']} steps")
    print(f"[tp] (b) on {card}: paged 1 x 2 at {c0['paged']['n_layers']} layers, "
          f"{TP_PAGED_REQUESTS} requests, {TP_PAGED_PAGES} pages of {PAGE}: chunk 1 "
          f"{p1['steps']} steps ({1e3 * p1['seconds'] / p1['steps']:.2f} ms per step), "
          f"{p1['preemptions']} preemptions, {p1['prefix_hits']} prefix hits; chunk {CHUNK} "
          f"{p32['steps']} steps ({1e3 * p32['seconds'] / p32['steps']:.2f} ms per step), "
          f"{p32['preemptions']} preemptions; tokens == chunk 1's on all {TP_PAGED_REQUESTS} "
          f"(beside (c)'s launch: the walls are contended); launch wall {cut_wall:.1f}s")
    # (c)
    check(sorted((q["coords"]["data"], q["coords"]["model"]) for q in quad) ==
          [(0, 0), (0, 1), (1, 0), (1, 1)], "[tp] (c) mesh coordinates")
    for q in quad:
        check(q["tokens"] == c0["cut"]["tokens"],
              f"[tp] (c) rank {q['rank']}: 2 x 2 tokens != the 1 x 2 run's")
    print(f"[tp] (c) on {card}: 2 x 2 on 4 ranks at {c0['paged']['n_layers']} layers, slots "
          f"{[q['slots'] for q in quad]}: tokens == 1 x 2 on all 12 requests; "
          f"{1e3 * quad[0]['seconds'] / quad[0]['steps']:.2f} ms per step (1 x 2: "
          f"{1e3 * c0['cut']['seconds'] / c0['cut']['steps']:.2f}), token gather "
          f"{1e3 * quad[0]['token_gather_s'] / quad[0]['steps']:.2f} ms per step; launch "
          f"wall {quad_wall:.1f}s")
    print(f"[tp] phase took {time.perf_counter() - run['t0']:.1f}s from its first launch")
    return r0["launches"]


# ROADMAP A11: training on the model axis (phase 17), launched after the tp
# serving launches on the same thread, checked after them
TP_TRAIN_LAYERS = 2        # full-width qwen2.5-3b cut to this depth
TP_TRAIN_STEPS = 3
TP_TRAIN_ARGV = ["--arch", "qwen2.5-3b", "--policy", "bf16_sr_kahan", "--fused-update",
                 "--batch", "2", "--seq", "512", "--steps", str(TP_TRAIN_STEPS), "--lr", "3e-3",
                 "--seed", "0", "--device", "cuda"]
TP_TRAIN_PAIR = ["--model-parallel", "2", "--dist-backend", "gloo"]
# (b): the non-fused SR update (the philox shard entry, then sr_cast)
TP_TRAIN_SR_ARGV = [a for a in TP_TRAIN_ARGV if a != "--fused-update"]
TP_TRAIN_SR_ARGV[TP_TRAIN_SR_ARGV.index("--policy") + 1] = "bf16_sr"
# (c): 2 data x 2 model on 4 ranks through the bf16 wire, checkpointed at the end
TP_TRAIN_QUAD_STEPS = 2
TP_TRAIN_QUAD_ARGV = TP_TRAIN_ARGV[:TP_TRAIN_ARGV.index("--steps")] + [
    "--steps", str(TP_TRAIN_QUAD_STEPS)] + TP_TRAIN_ARGV[TP_TRAIN_ARGV.index("--steps") + 2:]
TP_TRAIN_QUAD = ["--data-parallel", "2", "--model-parallel", "2", "--grad-wire", "bf16",
                 "--dist-backend", "gloo"]
TP_TRAIN_LOSS_BAR = 0.05   # (a): each step's loss against the 1-process run's
TP_TRAIN_BYTES_BAR = 0.53  # (a): weight and state bytes per rank over one process's
# tools/port_tp_train.py: the whole 36 layers on 1 x 2, the train cell's batch
TP_WHOLE_ARGV = TRAIN_ARGV[:TRAIN_ARGV.index("--steps")] + [
    "--steps", "3"] + TRAIN_ARGV[TRAIN_ARGV.index("--steps") + 2:]


def _tp_argv(base: list, spec: dict) -> list:
    """``base`` on the card, or reduced on the CPU in a rehearsal (at most
    64 tokens per row)."""
    if spec["device"] == "cuda":
        return list(base)
    argv = list(base)
    argv[argv.index("--device") + 1] = "cpu"
    at = argv.index("--seq") + 1
    argv[at] = str(min(int(argv[at]), 64))
    return argv + ["--reduced"]


def _quiet(*_args, **_kwargs) -> None:
    """A run's log left out of the phase's output (the rank logs keep theirs)."""


def _model_slice(t, spec, m: int):
    """Model rank ``m``'s part of a full leaf under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry == "model":
            n = t.shape[dim] // 2
            t = t.narrow(dim, m * n, n)
    return t


class _OneLeaf:
    """The randomness of leaf ``i`` of a step key, as leaf 0 of a one-leaf
    tree."""

    def __init__(self, key, i: int):
        self.key, self.i = key, i

    def leaf(self, _j: int):
        return self.key.leaf(self.i)


def tp_train_worker(spec: dict) -> dict:
    """One rank of phase 17 (``python3 chip_smoke.py --tp-worker SPEC`` with
    a ``train-*`` scenario): ``pair`` (2 ranks: (a), then (b), then (c)'s
    checkpoint in one process on rank 0 and under 1 x 2), ``quad`` (4
    ranks, beside ``pair``: (c), checkpointed into ``spec["ck"]``),
    ``whole`` (2 ranks: 1 x 2 at the whole depth, ``tools/port_tp_train.py``),
    ``fam`` (phase 18), ``hyb-rg`` or ``hyb-whisper`` (phase 19).
    Every run goes through the launcher's ``parse_args``, ``build`` and
    ``train``; returns what the phase checks."""
    import torch
    from repro_torch.dist import axes
    from repro_torch.dist import fsdp as F
    from repro_torch.dist import partition as PT
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import registry as R
    from repro_torch.core.policy import get_policy
    from repro_torch.dist import transport as TR
    from repro_torch.optim import StepKey, constant
    from repro_torch.train import checkpoint as CK
    from repro_torch.train.train_state import make_train_state
    from repro_torch.train import loop as TL
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves, tree_paths

    scenario = spec["scenario"].removeprefix("train-")
    card = spec["device"] == "cuda"
    rank = int(os.environ.get("REPRO_PROCESS_ID", "0"))
    layers = None if scenario == "whole" else TP_TRAIN_LAYERS
    counts = {k: kernel_module(k) for k in ("fused_adamw", "sr_cast", "philox")}
    out = {"rank": rank}

    def sync():
        if card:
            torch.cuda.synchronize()

    def zero():
        for m in counts.values():
            m.LAUNCHES = 0

    def read():
        return {k: m.LAUNCHES for k, m in counts.items()}

    def build(base, extra, cut=layers):
        args = LT.parse_args(_tp_argv(base, spec) + extra)
        return args, LT.build(args, cfg=_dist_cfg(args, cut))

    def train(args, run):
        """The run's steps: losses, step walls (the last one up to the run's
        end, its checkpoint included), the model axis's collectives, their
        seconds and host copies per step from step 1 on (step 0 waits for
        the other ranks), launches, peak GiB."""
        axis = axes.for_mesh(run.mesh)
        walls, marks = [], []

        def mark():
            st = axis.stats if axis is not None else None
            return (st.calls, st.seconds, st.host_copy_s) if st is not None else (0, 0.0, 0.0)

        def hook(step):
            sync()
            walls.append(time.perf_counter())
            if step == 1:
                marks.append(mark())
        if card:
            torch.cuda.reset_peak_memory_stats()
        zero()
        state, info = LT.train(args, run, log=_quiet, fault_hook=hook)
        sync()
        walls.append(time.perf_counter())
        steps = len(info["history"]) - 1
        per = [(b - a) / steps for a, b in zip(marks[0], mark())]
        return state, {"losses": [h["loss"] for h in info["history"]], "launches": read(),
                       "step_s": [b - a for a, b in zip(walls, walls[1:])],
                       "collectives": per[0], "collective_s": per[1], "host_copy_s": per[2],
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if card else 0.0}

    def digests(state):
        leaves = CK.flatten(state)[1:]
        n_res = len(CK.flatten(state.wire_residuals))
        return [digest(t) for t in leaves[:len(leaves) - n_res]]

    if scenario == "fam":
        # the tp-families phase's training: on rank 0 a 1-process run per
        # arch before this rank joins the group (rank 1 waits), then 1 x 2
        for arch, cut, _ in TP_FAM_TRAIN:
            out[arch] = res = {}
            if rank == 0:
                args1, run1 = build(TP_FAM_TRAIN_ARGV + ["--arch", arch],
                                    ["--num-processes", "1"], cut)
                res["one_bytes"] = F.per_device_bytes((run1.state.params, run1.state.opt_state))
                _, res["one"] = train(args1, run1)
                del run1, _
                if card:
                    torch.cuda.empty_cache()
        for arch, cut, leaf in TP_FAM_TRAIN:
            res = out[arch]
            args, run = build(TP_FAM_TRAIN_ARGV + ["--arch", arch], TP_TRAIN_PAIR, cut)
            res["bytes"] = F.per_device_bytes((run.state.params, run.state.opt_state))
            res["n_layers"] = run.cfg.n_layers
            state, res["a"] = train(args, run)
            tr = run.transport
            specs = F.flat_specs(F.train_state_specs(state, tr.pspecs, tr))[1:]
            res["a"].update(digests=digests(state), specs=[list(s) for s in specs],
                            n_leaves=len(tree_leaves(state.params)),
                            plain_check=fsdp_shard_check(run, state, args, leaf=leaf))
            del run, state
            if card:
                torch.cuda.empty_cache()
    elif scenario == "hyb-whisper":
        # phase 19's whisper training, a launch of its own beside the others
        from repro_torch.dist import multihost as MH
        from repro_torch.launch.mesh import make_local_mesh
        MH.initialize(device=spec["device"], backend="gloo", timeout_secs=300)
        out["whisper-base"] = _whisper_train(spec, rank, make_local_mesh(1, 2))
    elif scenario == "hyb-rg":
        # phase 19's recurrentgemma training through the launcher, on rank 0
        # first one process before this rank joins the group (rank 1 waits)
        res = out["recurrentgemma-2b"] = {}
        if rank == 0:
            args1, run1 = build(TP_HYB_TRAIN_ARGV, ["--num-processes", "1"],
                                TP_HYB_TRAIN_LAYERS)
            nb = F.per_device_bytes((run1.state.params, run1.state.opt_state))
            _, res["one"] = train(args1, run1)
            res["one"]["bytes"] = nb
            del run1, _
            if card:
                torch.cuda.empty_cache()
        args, run = build(TP_HYB_TRAIN_ARGV, TP_TRAIN_PAIR, TP_HYB_TRAIN_LAYERS)
        nb = F.per_device_bytes((run.state.params, run.state.opt_state))
        res["n_layers"] = run.cfg.n_layers
        state, res["a"] = train(args, run)
        res["a"].update(bytes=nb, n_leaves=len(tree_leaves(state.params)),
                        plain_check=fsdp_shard_check(run, state, args, leaf=TP_HYB_TRAIN_LEAF),
                        **_state_digests(state, run.transport))
    elif scenario == "pair":
        if rank == 0:
            # (a)'s one-process run, before this rank joins the group
            args1, run1 = build(TP_TRAIN_ARGV, ["--num-processes", "1"])
            out["one_bytes"] = F.per_device_bytes((run1.state.params, run1.state.opt_state))
            _, res1 = train(args1, run1)
            out["one"] = res1
            del run1, _
            if card:
                torch.cuda.empty_cache()
        args, run = build(TP_TRAIN_ARGV, TP_TRAIN_PAIR)
        out["bytes"] = F.per_device_bytes((run.state.params, run.state.opt_state))
        state, out["a"] = train(args, run)
        tr = run.transport
        specs = F.flat_specs(F.train_state_specs(state, tr.pspecs, tr))[1:]
        out["a"].update(digests=digests(state), specs=[list(s) for s in specs],
                        coords=run.mesh.coords(rank),
                        n_leaves=len(tree_leaves(state.params)),
                        plain_check=fsdp_shard_check(run, state, args))
        del run, state
        if card:
            torch.cuda.empty_cache()
        # (b) one non-fused bf16_sr update of the shards (the main path),
        # then leaf by leaf the one-process update of the whole leaf given
        # the gathered gradient: every sharded layer kernel (the embedding's
        # whole-leaf update would need ~8 GiB of f32 temporaries beside the
        # window's other processes)
        argsb, runb = build(TP_TRAIN_SR_ARGV, TP_TRAIN_PAIR)
        step = make_train_step(runb.cfg, runb.policy, runb.optimizer, constant(argsb.lr),
                               attn_chunk=min(1024, argsb.seq), transport=runb.transport,
                               mesh=runb.mesh)
        g = step.phases[0](runb.state, next(runb.batches(0)), argsb.seed)
        zero()
        new, _ = step.phases[1](runb.state, g, argsb.seed)
        sync()
        launched = read()
        axis = axes.for_mesh(runb.mesh)
        full = R.init(runb.cfg, argsb.seed, runb.policy.param_dtype,
                      device=spec["device"])             # the draw build() sharded
        opt, key = runb.optimizer, StepKey(argsb.seed, 0)
        checked, bad = [], []
        for i, (path, s, gi, w, m, v, w1) in enumerate(zip(
                tree_paths(new.params), tree_leaves(runb.transport.pspecs),
                tree_leaves(g.grads), tree_leaves(new.params), tree_leaves(new.opt_state.m),
                tree_leaves(new.opt_state.v), tree_leaves(full))):
            dims = F.sharded_dims(s)
            if not dims or path.startswith("embed"):
                continue
            g1 = torch.cat(axes._gather(gi.contiguous(), axis), dim=dims[0][0])
            one = {"x": w1}
            w_new, st = opt.update({"x": g1}, opt.init(one), one, step=0,
                                   key=_OneLeaf(key, i), lr=argsb.lr)
            checked.append(path)
            if not all(torch.equal(a, F.local_slice(b, s, runb.mesh)) for a, b in
                       ((w, w_new["x"]), (m, st.m["x"]), (v, st.v["x"]))):
                bad.append(path)
            del g1, one, w_new, st
        out["b"] = {"launches": launched, "checked": checked, "unequal": bad}
        del runb, new, g, full, step
        if card:
            torch.cuda.empty_cache()
        # (c)'s checkpoint, once the 2 x 2 launch beside this one has
        # written it and ended: in one process (rank 0; rank 1 waits at the
        # next collective), each model rank's slice of every stored leaf
        # (params and optimizer state) digested, then restored under 1 x 2
        quad = [Path(spec["out"], f"train-quad.rank{r}.json") for r in range(4)]
        t0 = time.perf_counter()
        while not all(q.exists() for q in quad):
            check(time.perf_counter() - t0 < 600, "[tp-train] (c)'s 2 x 2 launch did not end")
            time.sleep(1.0)
        if rank == 0:
            args1 = LT.parse_args(_tp_argv(TP_TRAIN_QUAD_ARGV, spec))
            cfg1 = _dist_cfg(args1, layers) or R.get_config(args1.arch).reduced()
            policy1 = get_policy(args1.policy)
            tr1 = TR.make_transport(wire="bf16")
            one = make_train_state(R.init(cfg1, args1.seed, policy1.param_dtype,
                                          device=spec["device"]),
                                   LT.make_optimizer(args1, policy1), transport=tr1)
            one, at = TL._restore(CK.CheckpointManager(spec["ck"]), one, _quiet,
                                  wire_format=tr1.wire_format, transport=tr1)
            stand_in = Mesh(("data", "model"), (1, 2))
            specs = F.flat_specs(F.train_state_specs(
                one, PT.param_specs(one.params, cfg1, stand_in)))[1:]
            leaves = CK.flatten(one)[1:]
            digests_of = leaves[:len(leaves) - len(CK.flatten(one.wire_residuals))]
            out["one_restore"] = {"step": at, "slices": [
                [digest(_model_slice(t, sp, m)) for t, sp in zip(digests_of, specs)]
                for m in (0, 1)]}
            del one, leaves, digests_of
            if card:
                torch.cuda.empty_cache()
        args, run = build(TP_TRAIN_QUAD_ARGV, TP_TRAIN_PAIR + ["--grad-wire", "bf16"])
        tr = run.transport
        state, at = TL._restore(CK.CheckpointManager(spec["ck"], mesh=run.mesh), run.state,
                                _quiet, wire_format=tr.wire_format, transport=tr,
                                specs=F.train_state_specs(run.state, tr.pspecs, tr))
        out["restore"] = {"step": at, "digests": digests(state),
                          "residual_max": max(float(t.abs().max())
                                              for t in CK.flatten(state.wire_residuals))}
    elif scenario == "quad":
        args, run = build(TP_TRAIN_QUAD_ARGV, TP_TRAIN_QUAD + [
            "--ckpt-dir", spec["ck"], "--ckpt-every", str(TP_TRAIN_QUAD_STEPS), "--sync-ckpt"])
        state, out["c"] = train(args, run)
        params = tree_leaves(state.params)
        out["c"].update(digests=digests(state), coords=run.mesh.coords(rank),
                        wire_bytes=run.transport.stats.wire_bytes_by_dtype(),
                        numel_local=sum(t.numel() for t in params),
                        replicated=[not F.sharded_dims(s) for s in
                                    F.flat_specs(F.train_state_specs(
                                        state, run.transport.pspecs, run.transport))[1:]])
    else:
        args, run = build(TP_WHOLE_ARGV, TP_TRAIN_PAIR)
        out["bytes"] = F.per_device_bytes((run.state.params, run.state.opt_state))
        out["n_layers"] = run.cfg.n_layers
        _, out["whole"] = train(args, run)
    return out


def phase_tp_train(card: str, run: dict, *, rehearsal: bool = False) -> dict:
    """ROADMAP A11 on the card (phase 17): training on the model axis, ranks
    sharing the card over gloo, each run through the launcher's
    ``parse_args``, ``build`` and ``train`` (:func:`tp_train_worker`).

    (a) 1 data x 2 model, full-width qwen2.5-3b cut to ``TP_TRAIN_LAYERS``,
    batch 2 x 512, ``bf16_sr_kahan --fused-update``, ``TP_TRAIN_STEPS``
    steps: both ranks bitwise equal on every replicated leaf (params and
    optimizer state) and on every loss; each step's loss within
    ``TP_TRAIN_LOSS_BAR`` of a 1-process run of the same steps; one TP
    shard's ``fused_adamw`` == its plain version with the folded seed;
    weight and state bytes per rank at most ``TP_TRAIN_BYTES_BAR`` of one
    process's; one ``fused_adamw`` launch per local leaf per step.
    (b) non-fused ``bf16_sr``: one update of the shards (the ``philox``
    shard entry, then ``sr_cast``) == the 1-process update's slice given
    the same gradients, w, m and v of every sharded layer kernel.
    (c) 2 data x 2 model on 4 ranks through the bf16 wire,
    ``TP_TRAIN_QUAD_STEPS`` steps, checkpointed: the two model groups
    bitwise equal, the wire's bytes by dtype as counted (2 per local
    element per step); the checkpoint restores in one process and under
    1 x 2 to the 2 x 2 ranks' parts. Prints ms per step, the model axis's
    collectives, their ms and host-copy ms per step, peak GiB per rank,
    beside the card's name and power limit. Returns the path's launches of
    ``fused_adamw``, ``sr_cast`` and ``philox``, summed over the ranks."""
    pair, pair_wall = run["train-pair"]
    quad, quad_wall = run["train-quad"]
    a0, a1 = pair[0]["a"], pair[1]["a"]
    # (a)
    check(a0["losses"] == a1["losses"], f"[tp-train] (a) ranks' losses differ: "
          f"{a0['losses']} {a1['losses']}")
    n_rep = 0
    for i, spec in enumerate(a0["specs"]):
        if "model" not in spec:
            n_rep += 1
            check(a0["digests"][i] == a1["digests"][i],
                  f"[tp-train] (a) replicated leaf {i} differs between the ranks")
    one = pair[0]["one"]["losses"]
    gap = max(abs(x - y) for x, y in zip(a0["losses"], one))
    check(len(one) == len(a0["losses"]) == TP_TRAIN_STEPS and gap <= TP_TRAIN_LOSS_BAR,
          f"[tp-train] (a) losses {a0['losses']} against one process's {one} "
          f"(bar {TP_TRAIN_LOSS_BAR})")
    for res in pair:
        check(res["a"]["plain_check"]["equal"],
              f"[tp-train] (a) rank {res['rank']}: the shard's fused_adamw != its plain "
              f"version with the folded seed")
    ratio = max(res["bytes"] for res in pair) / pair[0]["one_bytes"]
    check(ratio <= TP_TRAIN_BYTES_BAR, f"[tp-train] (a) bytes per rank {ratio:.4f} of one "
          f"process's (bar {TP_TRAIN_BYTES_BAR})")
    for res in pair:
        n = res["a"]["n_leaves"] * TP_TRAIN_STEPS
        check(rehearsal or res["a"]["launches"]["fused_adamw"] == n,
              f"[tp-train] (a) rank {res['rank']}: {res['a']['launches']} for {n} leaf steps")
    # (b)
    for res in pair:
        b = res["b"]
        check(not b["unequal"] and len(b["checked"]) >= 7,
              f"[tp-train] (b) rank {res['rank']}: {b['unequal']} of {b['checked']} != the "
              f"1-process update's slice")
        check(rehearsal or (b["launches"]["sr_cast"] > 0 and b["launches"]["philox"] > 0),
              f"[tp-train] (b) rank {res['rank']}: launches {b['launches']}")
    # (c)
    by = {(q["c"]["coords"]["data"], q["c"]["coords"]["model"]): q["c"] for q in quad}
    check(sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)], "[tp-train] (c) mesh coordinates")
    for m in (0, 1):
        check(by[0, m]["digests"] == by[1, m]["digests"] and
              by[0, m]["losses"] == by[1, m]["losses"],
              f"[tp-train] (c) the data replicas of model rank {m} differ")
        want = {"bfloat16": 2 * by[0, m]["numel_local"] * TP_TRAIN_QUAD_STEPS}
        check(by[0, m]["wire_bytes"] == want and by[1, m]["wire_bytes"] == want,
              f"[tp-train] (c) wire bytes {by[0, m]['wire_bytes']}, expected {want}")
    check(all(d0 == d1 for d0, d1, rep in zip(by[0, 0]["digests"], by[0, 1]["digests"],
                                             by[0, 0]["replicated"]) if rep),
          "[tp-train] (c) the model groups' replicated leaves differ")
    whole = pair[0]["one_restore"]
    check(whole["step"] == TP_TRAIN_QUAD_STEPS, f"[tp-train] (c) restored step {whole['step']}")
    for res in pair:
        m, got = res["a"]["coords"]["model"], res["restore"]
        check(got["step"] == TP_TRAIN_QUAD_STEPS and
              got["digests"] == by[0, m]["digests"] == whole["slices"][m],
              f"[tp-train] (c) model rank {m}: the 1 x 2 restore, the 1-process restore's "
              f"slice and the 2 x 2 ranks' parts differ")
        check(got["residual_max"] == 0.0,
              "[tp-train] (c) the 1 x 2 restore kept the 2 replicas' residual rows")
    launches = {k: sum(res["a"]["launches"][k] + res["b"]["launches"][k] for res in pair)
                + sum(q["c"]["launches"][k] for q in quad)
                for k in ("fused_adamw", "sr_cast", "philox")}
    ms = [1e3 * sum(r["a"]["step_s"][1:]) / max(len(r["a"]["step_s"]) - 1, 1) for r in pair]
    one_ms = 1e3 * sum(pair[0]["one"]["step_s"][1:]) / max(len(pair[0]["one"]["step_s"]) - 1, 1)
    print(f"[tp-train] (a) on {card}: 1 x 2 over gloo, qwen2.5-3b {TP_TRAIN_LAYERS} layers, "
          f"batch 2 x 512, bf16_sr_kahan fused: losses {[round(x, 4) for x in a0['losses']]} "
          f"(1 process {[round(x, 4) for x in one]}, within {gap:.2e}, bar "
          f"{TP_TRAIN_LOSS_BAR}); ranks bitwise on {n_rep} replicated leaves and the losses; "
          f"the shard's fused_adamw == plain (folded seed); steps 1-{TP_TRAIN_STEPS - 1} "
          f"{ms[0]:.2f} ms per step (rank 1 {ms[1]:.2f}; 1 process {one_ms:.2f}); model-axis "
          f"collectives {a0['collectives']:.0f} per step taking {1e3 * a0['collective_s']:.2f} "
          f"ms, of which host copies {1e3 * a0['host_copy_s']:.2f} ms (steps 1-"
          f"{TP_TRAIN_STEPS - 1}); "
          f"weights and state {pair[0]['bytes'] / 2**30:.3f} GiB per rank, {ratio:.4f} of one "
          f"process's {pair[0]['one_bytes'] / 2**30:.3f}; peak {a0['peak_gib']:.2f} GiB per "
          f"rank (1 process {pair[0]['one']['peak_gib']:.2f}); launches {a0['launches']}")
    print(f"[tp-train] (b) on {card}: non-fused bf16_sr, one update of the shards == the "
          f"1-process update's slice (w, m, v) on every sharded layer kernel "
          f"({len(pair[0]['b']['checked'])} per rank); launches per rank "
          f"{pair[0]['b']['launches']}")
    c0 = by[0, 0]
    print(f"[tp-train] (c) on {card}: 2 x 2 on 4 ranks, bf16 wire, {TP_TRAIN_QUAD_STEPS} "
          f"steps: model groups bitwise, wire {c0['wire_bytes']} B per rank "
          f"({c0['numel_local']} local elements); step walls "
          f"{[round(x, 2) for x in c0['step_s']]} s (the last with its checkpoint; beside "
          f"(a, b)); "
          f"collectives {c0['collectives']:.0f} per step, {1e3 * c0['collective_s']:.2f} ms, "
          f"host copies {1e3 * c0['host_copy_s']:.2f} ms; peak {c0['peak_gib']:.2f} GiB; the "
          f"checkpoint restores in one process and under 1 x 2 to the 2 x 2 parts; launch "
          f"walls {quad_wall:.1f}s, (a, b) and the restores {pair_wall:.1f}s")
    return launches


def _fam_per_step(cfg) -> tuple[int, dict]:
    """One tp serve step's model-axis collectives and kernel launches of
    the MoE and Mamba families at model 2: per MoE layer the row-parallel
    sums of ``wo`` and the experts' down products (and the shared expert's
    ``w_down``), each expert's down product and ``wo`` on ``qmatmul_f32``,
    one decode launch; per Mamba layer the ``in_proj`` exchange and the
    ``x_proj`` and ``out_proj`` sums, both on ``qmatmul_f32``; then the
    embedding and the logits gathers."""
    if cfg.family == "ssm":
        return 3 * cfg.n_layers + 2, {"qmatmul_f32": 2 * cfg.n_layers}
    shared = 1 if cfg.shared_expert else 0
    return ((2 + shared) * cfg.n_layers + 2,
            {"qmatmul_f32": (1 + cfg.n_experts + shared) * cfg.n_layers,
             "decode_attention": cfg.n_layers})


def phase_tp_families(card: str, run: dict, *, rehearsal: bool = False) -> dict:
    """ROADMAP A12, item 1 on the card: the MoE and Mamba families on 1
    data x 2 model ranks sharing the card over gloo (``--tp-worker``
    scenarios ``train-fam`` and ``fam-serve``), at published
    widths, depth cut (``TP_FAM_SERVE``, ``TP_FAM_TRAIN``).

    Serving (the families' stream: 8 slots, max_len 256, 12 greedy
    requests of 24 tokens, fused decode, eager steps): both ranks' tokens
    bitwise equal; the share of tokens equal to a 1-rank engine's at the
    same depth (CUDA graphs; printed, ROADMAP C18); mixtral paged ≡
    contiguous; per step the counted collectives and ``qmatmul_f32`` and
    decode launches (:func:`_fam_per_step`); weights per rank against one
    rank's. Training (``bf16_sr_kahan --fused-update``, batch 1 x 512, 3
    steps, beside a 1-process run of the same steps): both ranks bitwise
    equal on every replicated leaf (the router, conv, ``A_log``,
    ``D_skip``, the norms) and on the losses; each loss within
    ``TP_TRAIN_LOSS_BAR`` of one process's; one shard's ``fused_adamw`` ==
    its plain version with the folded seed; weights and state per rank at
    most ``TP_TRAIN_BYTES_BAR`` of one process's; one ``fused_adamw``
    launch per local leaf per step. Prints ms per step, collectives, their
    ms and host-copy ms, peak GiB per rank. Returns the runs' launches
    (serving: rank 0's; ``fused_adamw``: both ranks')."""
    import numpy as np
    from repro_torch.models import registry as R
    serve, serve_wall = run["fam-serve"]
    train, train_wall = run["train-fam"]
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    for arch, _, paged in TP_FAM_SERVE:
        r0, r1 = serve[0][arch], serve[1][arch]
        check(r0["tokens"] == r1["tokens"] and r0["launches"] == r1["launches"],
              f"[tp-families] {arch}: the ranks' tokens or launches differ")
        check(r0["finished"] == 12 and r0["graphs"] == 0,
              f"[tp-families] {arch}: finished {r0['finished']}/12, graphs {r0['graphs']}")
        cfg = R.get_config(arch)
        cfg = cfg.reduced() if rehearsal else dataclasses.replace(cfg, n_layers=r0["n_layers"])
        coll, per_kernel = _fam_per_step(cfg)
        check(r0["collectives"] == coll * r0["steps"],
              f"[tp-families] {arch}: {r0['collectives']} collectives in {r0['steps']} steps, "
              f"expected {coll} per step")
        per = {k: n / r0["steps"] for k, n in r0["launches"].items() if n}
        check(rehearsal or all(per.get(k) == n for k, n in per_kernel.items()),
              f"[tp-families] {arch}: launches per step {per}, expected {per_kernel}")
        add(r0["launches"])
        one = r0["one_tokens"]
        same = sum(int(np.sum(np.asarray(r0["tokens"][rid]) == np.asarray(t)))
                   for rid, t in one.items())
        total = sum(len(t) for t in one.values())
        firsts = sum(r0["tokens"][rid][0] == t[0] for rid, t in one.items())
        if paged:
            check(r0["paged"]["tokens"] == r0["tokens"] == r1["paged"]["tokens"],
                  f"[tp-families] {arch}: paged 1 x 2 != contiguous 1 x 2")
            add(r0["paged"]["launches"])
        w1, w2 = r0["weights"]
        ms = 1e3 * r0["seconds"] / r0["steps"]
        print(f"[tp-families] serve {arch} on {card}: {r0['n_layers']} layers, 1 x 2 over "
              f"gloo, {r0['steps']} eager steps in {r0['seconds']:.2f}s -> {ms:.2f} ms per "
              f"step; collectives {coll} per step taking "
              f"{1e3 * r0['collective_s'] / r0['steps']:.2f} ms, of which host copies "
              f"{1e3 * r0['host_copy_s'] / r0['steps']:.2f} ms; launches per step {per}; "
              f"weights {w2 / 2**30:.3f} GiB per rank ({w2 / w1:.4f} of one rank's "
              f"{w1 / 2**30:.3f}); peak {r0['peak_gib']:.2f} GiB per rank; ranks bitwise; "
              f"tokens equal to the 1-rank engine's (graphs): {same}/{total}, first tokens "
              f"{firsts}/{len(one)} (C18)"
              + (f"; paged ({r0['paged']['steps']} steps, "
                 f"{1e3 * r0['paged']['seconds'] / r0['paged']['steps']:.2f} ms per step) == "
                 f"contiguous" if paged else ""))
    for arch, _, leaf in TP_FAM_TRAIN:
        t0, t1 = train[0][arch], train[1][arch]
        a0, a1 = t0["a"], t1["a"]
        check(a0["losses"] == a1["losses"], f"[tp-families] train {arch}: the ranks' "
              f"losses differ: {a0['losses']} {a1['losses']}")
        n_rep = 0
        for i, spec in enumerate(a0["specs"]):
            if "model" not in spec:
                n_rep += 1
                check(a0["digests"][i] == a1["digests"][i],
                      f"[tp-families] train {arch}: replicated leaf {i} differs between "
                      f"the ranks")
        one = t0["one"]["losses"]
        gap = max(abs(x - y) for x, y in zip(a0["losses"], one))
        check(len(one) == len(a0["losses"]) == TP_FAM_TRAIN_STEPS
              and gap <= TP_TRAIN_LOSS_BAR,
              f"[tp-families] train {arch}: losses {a0['losses']} against one process's "
              f"{one} (bar {TP_TRAIN_LOSS_BAR})")
        for res in (t0, t1):
            check(res["a"]["plain_check"]["equal"],
                  f"[tp-families] train {arch}: the {leaf} shard's fused_adamw != its plain "
                  f"version with the folded seed")
            n = res["a"]["n_leaves"] * TP_FAM_TRAIN_STEPS
            check(rehearsal or res["a"]["launches"]["fused_adamw"] == n,
                  f"[tp-families] train {arch}: launches {res['a']['launches']} for {n} "
                  f"leaf steps")
            add({"fused_adamw": res["a"]["launches"]["fused_adamw"]})
        ratio = max(t0["bytes"], t1["bytes"]) / t0["one_bytes"]
        check(ratio <= TP_TRAIN_BYTES_BAR, f"[tp-families] train {arch}: bytes per rank "
              f"{ratio:.4f} of one process's (bar {TP_TRAIN_BYTES_BAR})")
        ms = [1e3 * sum(r["a"]["step_s"][1:]) / max(len(r["a"]["step_s"]) - 1, 1)
              for r in (t0, t1)]
        one_ms = 1e3 * sum(t0["one"]["step_s"][1:]) / max(len(t0["one"]["step_s"]) - 1, 1)
        print(f"[tp-families] train {arch} on {card}: {t0['n_layers']} layers, 1 x 2 over "
              f"gloo, batch 1 x 512, bf16_sr_kahan fused: losses "
              f"{[round(x, 4) for x in a0['losses']]} (1 process "
              f"{[round(x, 4) for x in one]}, within {gap:.2e}, bar {TP_TRAIN_LOSS_BAR}); "
              f"ranks bitwise on {n_rep} replicated leaves and the losses; the {leaf} "
              f"shard's fused_adamw == plain (folded seed); steps 1-{TP_FAM_TRAIN_STEPS - 1} "
              f"{ms[0]:.2f} ms per step (rank 1 {ms[1]:.2f}; 1 process {one_ms:.2f}); "
              f"model-axis collectives {a0['collectives']:.0f} per step taking "
              f"{1e3 * a0['collective_s']:.2f} ms, of which host copies "
              f"{1e3 * a0['host_copy_s']:.2f} ms; weights and state "
              f"{t0['bytes'] / 2**30:.3f} GiB per rank, {ratio:.4f} of one process's "
              f"{t0['one_bytes'] / 2**30:.3f}; peak {a0['peak_gib']:.2f} GiB per rank (1 "
              f"process {t0['one']['peak_gib']:.2f}); launches {a0['launches']}")
    print(f"[tp-families] launch walls: training {train_wall:.1f}s, serving "
          f"{serve_wall:.1f}s (in the smoke beside the tp phase's (a) and (b, c), and the "
          f"paper window: contended)")
    return launches


# phase 19, tp-hybrid (ROADMAP A12 items 1b and 2): the RG-LRU hybrid and the
# encoder-decoder on the model axis, with head counts and a vocabulary the
# axis does not divide, ranks sharing the card over gloo. recurrentgemma-2b
# (10 query heads, 1 kv head of 256, vocab 256000) served on 1 x 2 at 6 of
# its 26 layers (two rec, rec, local_attn groups) on the families' stream,
# and on 1 x 4 at 3 (the query heads padded to 12); whisper-base (8 heads of
# 64, vocab 51865: the embedding and tied head whole) whole on 1 x 2
TP_HYB_SERVE_LAYERS = 6
TP_HYB_QUAD_LAYERS = 3
TP_HYB_QUAD_REQUESTS, TP_HYB_QUAD_GEN = 4, 8
TP_HYB_WHISPER_STEPS = 24          # 8 lanes x 24 tokens: 4 prompt, 20 greedy
# training: recurrentgemma-2b at 3 layers through the launcher, whisper-base
# 3 fused AdamW steps on the whisper phase's batch, each beside one process
TP_HYB_TRAIN_LAYERS = 3
TP_HYB_TRAIN_ARGV = ["--arch", "recurrentgemma-2b", "--policy", "bf16_sr_kahan",
                     "--fused-update", "--batch", "1", "--seq", "512", "--steps", "3", "--lr",
                     "1e-4", "--seed", "0", "--device", "cuda"]
TP_HYB_TRAIN_STEPS = 3
TP_HYB_TRAIN_LEAF = "layers.b0.mixer.w_r.kernel"       # RG-LRU's square gate, a shard
TP_HYB_WHISPER_LEAF = "dec_layers.cross_attn.wq.kernel"
# the decode kernel at this phase's per-rank shapes, at the cache sizes the
# phase runs: recurrentgemma's local attention (window 2048) in the
# engines' MAIN_SC-cell ring on 1 x 2 (5 query heads on its kv head) and on
# 1 x 4 (3; the last rank's heads 10 and 11 zero padding), and over the
# window's whole 2048-cell view; whisper-base's under 1 x 2 (4 heads of 64 on
# 4 kv heads): self-attention over its TP_HYB_WHISPER_STEPS-cell lock-step
# cache, cross-attention over the source frames' keys with the query after
# them ("cross": the cells are whisper's max_source_len)
HYB_KERNEL_CASES = {
    f"G=5 D=256, {MAIN_SC} cells": dict(hq=5, hkv=1, d=256, cells=MAIN_SC, window=G10_SC),
    f"G=3 D=256, {MAIN_SC} cells": dict(hq=3, hkv=1, d=256, cells=MAIN_SC, window=G10_SC,
                                        pad=True),
    f"G=5 D=256, {G10_SC} cells": dict(hq=5, hkv=1, d=256, cells=G10_SC, window=G10_SC),
    f"G=3 D=256, {G10_SC} cells": dict(hq=3, hkv=1, d=256, cells=G10_SC, window=G10_SC,
                                       pad=True),
    f"G=1 D=64, 4 heads, {TP_HYB_WHISPER_STEPS} cells": dict(hq=4, hkv=4, d=64,
                                                             cells=TP_HYB_WHISPER_STEPS),
    "G=1 D=64, 4 heads, cross-attention": dict(hq=4, hkv=4, d=64, cells="cross"),
}
# ... and qmatmul_f32 at the phase's row-parallel partials, 8 lanes: RG-LRU's
# out (K = 2560 / 2), recurrentgemma's w_down (7680 / 2), whisper's wo and
# w_down (N = 512)
QMATMUL_F32_SHAPES.update({"rglru out, 8 lanes": (8, 2560, 1280),
                           "recurrentgemma w_down, 8 lanes": (8, 2560, 3840),
                           "whisper wo, 8 lanes": (8, 512, 256),
                           "whisper w_down, 8 lanes": (8, 512, 1024)})


def _hyb_per_step(cfg, mp: int) -> tuple[int, dict]:
    """One tp serve step's model-axis collectives and kernel launches of
    recurrentgemma on ``mp`` ranks: per RG-LRU block the ``xs`` gather,
    ``out`` and ``w_down`` (6 bf16 ``qmatmul``: in_x, in_gate, w_r, w_i,
    the MLP's gate and up; 2 ``qmatmul_f32``); per local-attention block
    the k/v gather, ``wo`` and ``w_down``, with query heads the axis does
    not divide the q and output gathers too (5 bf16, 2 f32, one decode);
    then the embedding and the logits; two ``row_mean_sq`` per layer and
    the final norm's."""
    from repro_torch.models.transformer import _layer_plan
    kinds, n_groups, rem = _layer_plan(cfg)
    kinds = kinds * n_groups + rem
    n_rec = kinds.count("rec")
    n_attn = len(kinds) - n_rec
    padded = 2 if cfg.n_heads % mp else 0
    return (3 * n_rec + (3 + padded) * n_attn + 2,
            {"qmatmul": 6 * n_rec + 5 * n_attn, "qmatmul_f32": 2 * len(kinds),
             "decode_attention": n_attn, "row_mean_sq": 2 * len(kinds) + 1})


def _whisper_model(spec: dict):
    """whisper-base (reduced in a CPU rehearsal), ``bf16_standard``, and
    the whisper phase's source frames and prompt."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.models import registry as R
    cfg = R.get_config("whisper-base")
    if spec.get("reduced"):
        cfg = cfg.reduced()
    policy = get_policy("bf16_standard")
    dev = spec["device"]
    g = torch.Generator(device=dev).manual_seed(70)
    src_len = cfg.max_source_len if not spec.get("reduced") else 16
    src = torch.randn((B, src_len, cfg.d_model), generator=g, device=dev)
    prompt = torch.randint(0, cfg.vocab, (B, WHISPER_PROMPT), generator=g, device=dev,
                           dtype=torch.int32)
    return cfg, policy, src, prompt


def _whisper_lockstep(params, cfg, policy, src, prompt, mesh, *, feed=None) -> dict:
    """Lock-step decode of ``TP_HYB_WHISPER_STEPS`` tokens per lane through
    ``make_serve_step(fused_decode=True)`` under ``mesh``: the prompt, then
    greedy tokens (or ``feed``'s, teacher-forced). Returns the fed tokens,
    the last step's logits, the encode and per-step seconds."""
    import torch
    from repro_torch.core.qarith import QArith
    from repro_torch.models import registry as R
    from repro_torch.train.step import make_serve_step
    dev = src.device
    n = TP_HYB_WHISPER_STEPS
    step = make_serve_step(cfg, policy, fused_decode=True, return_logits=True, mesh=mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.no_grad():
        sync()
        t = time.perf_counter()
        cache = R.make_cache(params, cfg, batch_size=B, max_len=n, qa=QArith(policy),
                             batch={"src_embeds": src}, mesh=mesh)
        sync()
        enc_s = time.perf_counter() - t
        fed, step_s = [prompt[:, :1]], []
        for i in range(n):
            t = time.perf_counter()
            out, logits, cache = step(params, cache, fed[-1],
                                      torch.full((B,), i, dtype=torch.int32, device=dev))
            sync()
            step_s.append(time.perf_counter() - t)
            if i + 1 < n:
                fed.append(feed[:, i + 1:i + 2] if feed is not None else
                           prompt[:, i + 1:i + 2] if i + 1 < WHISPER_PROMPT else out)
    return {"fed": torch.cat(fed, 1), "logits": logits.float(), "enc_s": enc_s,
            "step_s": step_s}


def tp_hybrid_worker(spec: dict) -> dict:
    """One rank of phase 19's serving (``python3 chip_smoke.py --tp-worker
    SPEC``): ``hyb-serve`` (2 ranks: recurrentgemma at
    ``TP_HYB_SERVE_LAYERS`` on the families' stream beside rank 0's 1-rank
    engine), ``hyb-quad`` (4 ranks: recurrentgemma at
    ``TP_HYB_QUAD_LAYERS`` on 1 x 4, the padded query heads) or
    ``hyb-whisper`` (2 ranks: whisper-base's lock-step decode beside rank
    0's one process). Returns what the phase checks."""
    import torch
    import torch.distributed as tdist
    from repro_torch.dist import axes
    from repro_torch.dist import multihost as MH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve_stream
    from repro_torch.models import registry as R
    from repro_torch.serve.engine import Engine
    dev = spec["device"]
    card = dev == "cuda"
    rank = MH.process_index()
    out = {"rank": rank}

    def mark(axis):
        st = axis.stats
        return st.calls, st.seconds, st.host_copy_s

    quad = spec["scenario"] == "hyb-quad"
    mesh = make_local_mesh(1, 4 if quad else 2)
    axis = axes.for_mesh(mesh)
    layers = TP_HYB_QUAD_LAYERS if quad else TP_HYB_SERVE_LAYERS
    if card:
        torch.cuda.reset_peak_memory_stats()
    if spec["scenario"] == "hyb-whisper":
        # whisper-base whole: rank 0's one-process greedy run, then 1 x 2, then
        # rank 0's one process teacher-forced on the 1 x 2 run's tokens
        cfg, policy, src, prompt = _whisper_model(spec)
        params = R.init(cfg, 0, policy.param_dtype, device=dev)
        res = {"weights": [_tp_nbytes(params)]}
        if rank == 0:
            res["one"] = _whisper_lockstep(params, cfg, policy, src, prompt, None)
        whole = params if rank == 0 else None
        local = _tp_shard(params, cfg, mesh, dev)
        del params
        res["weights"].append(_tp_nbytes(local))
        c0 = mark(axis)
        mods = _tp_counts()
        tp = _whisper_lockstep(local, cfg, policy, src, prompt, mesh)
        c1 = mark(axis)
        res.update(launches=_tp_read(mods), collectives=c1[0] - c0[0],
                   collective_s=c1[1] - c0[1], host_copy_s=c1[2] - c0[2],
                   fed=tp["fed"].tolist(), enc_s=tp["enc_s"], step_s=tp["step_s"])
        if rank == 0:
            forced = _whisper_lockstep(whole, cfg, policy, src, prompt, None, feed=tp["fed"])
            err = float((tp["logits"] - forced["logits"]).abs().max())
            res["logits_err"], res["logits_scale"] = err, float(forced["logits"].abs().max())
            res["one_fed"] = res.pop("one")["fed"].tolist()
        res["last_digest"] = digest(tp["logits"])
        _tp_sync(dev)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
        out["whisper-base"] = res
        del local, whole
        return out
    # recurrentgemma: rank 1 (and on 1 x 4 ranks 1-3) draws the whole cut
    # model once rank 0 has sharded its own
    if rank:
        tdist.barrier()
    params, cfg, policy = _tp_model(spec, layers, "recurrentgemma-2b")
    stream = family_stream(cfg.vocab)
    if quad:
        stream = [(0, p, TP_HYB_QUAD_GEN) for _, p, _ in stream[:TP_HYB_QUAD_REQUESTS]]
    res = {"n_layers": cfg.n_layers, "weights": [_tp_nbytes(params)]}
    if rank == 0:
        one = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC, fused_decode=True,
                     device=dev)
        res["one_tokens"] = _tp_tokens(serve_stream(one, stream))
        del one
    params = _tp_shard(params, cfg, mesh, dev)
    if rank == 0:
        tdist.barrier()
    res["weights"].append(_tp_nbytes(params))
    eng = Engine(params, cfg, policy, n_slots=8, max_len=MAIN_SC, fused_decode=True,
                 device=dev, mesh=mesh)
    _tp_sync(dev)
    c0 = mark(axis)
    mods = _tp_counts()
    r = serve_stream(eng, stream)
    c1 = mark(axis)
    res.update(launches=_tp_read(mods), tokens=_tp_tokens(r), steps=r.calls,
               seconds=r.seconds, finished=eng.stats.finished, graphs=len(eng.graphs),
               collectives=c1[0] - c0[0], collective_s=c1[1] - c0[1],
               host_copy_s=c1[2] - c0[2], kv=eng.pool.nbytes())
    del eng, params
    _tp_sync(dev)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
    out["recurrentgemma-2b"] = res
    return out


def _state_digests(state, tr) -> dict:
    """Every leaf of a train state (params, then optimizer state; the
    wire's residuals left out) digested, whether its spec replicates it
    over the model axis, and the bytes of the replicated ones."""
    from repro_torch.dist import fsdp as F
    from repro_torch.train import checkpoint as CK
    leaves = CK.flatten(state)[1:]
    leaves = leaves[:len(leaves) - len(CK.flatten(state.wire_residuals))]
    specs = F.flat_specs(F.train_state_specs(state, tr.pspecs, tr))[1:]
    replicated = [not F.sharded_dims(s) for s in specs[:len(leaves)]]
    return {"digests": [digest(t) for t in leaves], "replicated": replicated,
            "whole_bytes": sum(t.numel() * t.element_size()
                               for t, rep in zip(leaves, replicated) if rep)}


def _whisper_train(spec: dict, rank: int, mesh) -> dict:
    """phase 19's whisper training: rank 0's one process, then 1 x 2 on
    ``mesh`` (``make_train_step(mesh=)``: the launcher trains on the token
    stream), 3 fused AdamW steps of ``bf16_sr_kahan`` on the whisper
    phase's batch (8 x 1500 frames, 448 target tokens) each."""
    import types
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.dist import axes
    from repro_torch.dist import fsdp as F
    from repro_torch.dist import partition as PT
    from repro_torch.dist import transport as TR
    from repro_torch.models import registry as R
    from repro_torch.optim import constant, fused_adamw_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import make_train_state
    from repro_torch.tree import tree_leaves
    card = spec["device"] == "cuda"
    FA = kernel_module("fused_adamw")
    cfg, _, src, _ = _whisper_model(spec)
    tpol = get_policy("bf16_sr_kahan")
    toks = next(lm_batches(cfg.vocab, B, 64 if spec.get("reduced") else R.TGT_LEN_ENCDEC,
                           seed=0, device=spec["device"]))
    batch = {"src_embeds": src, **toks}
    out = {}

    def run(m):
        params = R.init(cfg, 0, tpol.param_dtype, device=spec["device"])
        pspecs = PT.param_specs(params, cfg, m) if m is not None else None
        opt = fused_adamw_optimizer(tpol, b2=0.99609375, weight_decay=0.01, mesh=m,
                                    pspecs=pspecs)
        tr = (TR.make_transport(mesh=m, placement=PT.Placement(), pspecs=pspecs)
              if m is not None else None)
        if m is not None:
            params = F.shard_state(params, pspecs, m)
        state = make_train_state(params, opt, transport=tr)
        step = make_train_step(cfg, tpol, opt, constant(WHISPER_LR), attn_chunk=src.shape[1],
                               transport=tr, mesh=m)
        axis = axes.for_mesh(m)
        nb = F.per_device_bytes((state.params, state.opt_state))
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        FA.LAUNCHES = 0
        losses, walls, marks = [], [], []
        for i in range(TP_HYB_TRAIN_STEPS):
            t = time.perf_counter()
            if axis is not None and i == 1:
                marks.append((axis.stats.calls, axis.stats.seconds, axis.stats.host_copy_s))
            state, met = step(state, batch, 0)
            losses.append(float(met["loss"]))
            walls.append(time.perf_counter() - t)
        res = {"losses": losses, "step_s": walls, "bytes": nb,
               "launches": {"fused_adamw": FA.LAUNCHES},
               "n_leaves": len(tree_leaves(state.params)),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if card else 0.0}
        if axis is not None:
            st = axis.stats
            res.update({k: (b - a) / (TP_HYB_TRAIN_STEPS - 1) for k, a, b in zip(
                ("collectives", "collective_s", "host_copy_s"), marks[0],
                (st.calls, st.seconds, st.host_copy_s))})
            res.update(_state_digests(state, tr))
            fake = types.SimpleNamespace(transport=tr, mesh=m)
            res["plain_check"] = fsdp_shard_check(fake, state, types.SimpleNamespace(seed=0),
                                                  leaf=TP_HYB_WHISPER_LEAF)
        return res
    if rank == 0:
        out["one"] = run(None)
        if card:
            torch.cuda.empty_cache()
    out["a"] = run(mesh)
    return out


# phase 19's launches (scenario, ranks): each model's training and 1 x 2
# serving on 2 ranks each, recurrentgemma's 1 x 4 serving on 4 (~50 GiB of
# the card together)
HYB_LAUNCHES = (("train-hyb-rg", 2), ("train-hyb-whisper", 2), ("hyb-serve", 2),
                ("hyb-whisper", 2), ("hyb-quad", 4))


def tp_hybrid_launches(run: dict, start, names=HYB_LAUNCHES) -> None:
    """The launches ``names`` ((scenario, ranks) pairs; phase 19's five
    unless given) into ``run``, all side by side. A launch's rank 1 idles
    while its rank 0 runs the one-process comparisons, so more launches
    keep the cores busy. ``start(scenario, n)`` starts one
    (:func:`_tp_start`)."""
    launches = dict(zip((name for name, _ in names), (start(name, n) for name, n in names)))
    walls = {}
    while len(walls) < len(launches):          # each launch's own wall
        for name, (proc, t0, *_) in launches.items():
            if name not in walls and proc.poll() is not None:
                walls[name] = time.perf_counter() - t0
        if len(walls) < len(launches):
            check(min(t0 for _, t0, *_ in launches.values()) > time.perf_counter() - 600,
                  f"[tp-hybrid] launches {sorted(set(launches) - set(walls))} did not end")
            time.sleep(0.5)
    for name, launch in launches.items():
        run[name] = (_tp_wait(launch)[0], walls[name])


def hyb_runs(names=HYB_LAUNCHES, *, rehearsal: bool = False) -> dict:
    """The launches ``names`` side by side (:func:`tp_hybrid_launches`;
    phase 19's unless given) in a root of their own; a launch still running
    when another fails is ended. Returns what :func:`phase_tp_hybrid` and
    :func:`phase_dp_paged` check."""
    import tempfile
    kw = dict(device="cpu", reduced=True) if rehearsal else {}
    run = {"root": Path(tempfile.mkdtemp(prefix="repro-hyb-"))}
    procs = []

    def start(name, n):
        launch = _tp_start(run["root"], name, n, **kw)
        procs.append(launch[0])
        return launch
    try:
        tp_hybrid_launches(run, start, names)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
    return run


def phase_kernel_hybrid(card: str) -> float:
    """The contiguous decode kernel at phase 19's per-rank shapes and cache
    sizes (``HYB_KERNEL_CASES``): recurrentgemma's local attention on 1 x 2
    (G = 5, D = 256) and 1 x 4 (G = 3, the last two query heads zero, as
    the last rank's padding is), window 2048, over the engines' 256-cell
    ring and the window's 2048-cell view, lanes at mixed depths, two of
    them parked; whisper's under 1 x 2 (G = 1, D = 64, 4 heads): its
    self-attention over the 24-cell lock-step cache at mixed depths, two
    lanes parked, and its cross-attention over the 1500 source keys, the
    query at 1500. bf16 and f32: within atol = rtol = 1e-2 and 1% of each
    lane's RMS of the plain version, two calls equal, parked lanes zero;
    then each bf16 case's time beside its bound, the plain version's and
    ``scaled_dot_product_attention``'s. Returns the largest |kernel −
    plain|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models.registry import get_config
    src = get_config("whisper-base").max_source_len

    def call(fn, x):
        return fn(x["q"], x["k"], x["v"], x["k_pos"], x["q_pos"], window=x["window"],
                  p_dtype=x["q"].dtype)

    def case(shape, dtype, seed):
        heads = dict(hq=shape["hq"], hkv=shape["hkv"], d=shape["d"])
        if shape["cells"] == "cross":
            x = _inputs(src, seed, **heads, dtype=dtype)
            cells = torch.arange(src, dtype=torch.int32, device="cuda")[None].expand(B, -1)
            x.update(k_pos=cells.contiguous(),
                     q_pos=torch.full((B,), src, dtype=torch.int32, device="cuda"))
            return x, ()
        x = _inputs(shape["cells"], seed, window=shape.get("window"), parked=(1, 6), **heads,
                    dtype=dtype)
        if shape.get("pad"):
            x["q"][:, :, 1:] = 0                # the last rank's padded heads 10 and 11
        return x, (1, 6)

    max_err = 0.0
    for i, (tag, shape) in enumerate(HYB_KERNEL_CASES.items()):
        for dtype in (torch.bfloat16, torch.float32):
            x, parked = case(shape, dtype, 90 + i)
            got, again = call(DA.fused_decode_attention, x), call(DA.fused_decode_attention, x)
            want = call(DA.decode_attention_ref, x)
            torch.cuda.synchronize()
            name = f"{tag} {str(dtype).split('.')[-1]}"
            check(got.shape == (B, 1, shape["hq"], shape["d"])
                  and bool(torch.isfinite(got).all()), f"{name}: output or non-finite")
            check(torch.equal(got, again), f"{name}: two calls differ")
            check(all(bool((got[lane] == 0).all()) for lane in parked),
                  f"{name}: a parked lane is not exactly zero")
            err = float((got - want).abs().max())
            ratio = rms_ratio(got, want, x["q_pos"])
            check(torch.allclose(got, want, atol=ATOL, rtol=RTOL) and ratio <= REL_RMS,
                  f"{name}: kernel vs plain max |err| {err}, {ratio} of a lane's RMS")
            max_err = max(max_err, err)
            print(f"[kernel-hybrid] {name}: max |kernel - plain| {err:.3e} (atol=rtol={ATOL}), "
                  f"{ratio:.3e} of a lane's RMS; two calls equal"
                  + (f", parked lanes {parked[0]}, {parked[1]} zero" if parked else ""))
        x, _ = case(shape, torch.bfloat16, 95 + i)
        kv_bytes = 2 * x["k"].numel() * x["k"].element_size()
        # the timed graph cycles over at most 64 calls' copies
        copies = [x] + [{n: t.clone() if hasattr(t, "clone") else t for n, t in x.items()}
                        for _ in range(min(-(-64 * 2**20 // kv_bytes), 64) - 1)]
        ms = time_ms([lambda c=c: call(DA.fused_decode_attention, c) for c in copies])
        plain_ms = time_ms([lambda c=c: call(DA.decode_attention_ref, c) for c in copies],
                           calls=16)

        def sdpa(c):
            allowed = ((c["k_pos"] >= 0) & (c["k_pos"] <= c["q_pos"][:, None]))[:, None, None]
            qt, kt, vt = c["q"].transpose(1, 2), c["k"].transpose(1, 2), c["v"].transpose(1, 2)
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                          enable_gqa=True)
        library_ms = time_ms([sdpa(c) for c in copies])
        bound_ms, bound_by = _bound_ms(x)
        live = x["q_pos"][x["q_pos"] >= 0]
        print(f"[kernel-hybrid] {tag} bf16, {B} lanes over {x['k'].shape[1]} cells, q_pos "
              f"{int(live.min())}-{int(live.max())} on {card}: kernel {ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {library_ms:.4f} ms (device time, "
              f"{len(copies)} input copies rotated)")
    return max_err


def phase_tp_hybrid(card: str, run: dict, *, rehearsal: bool = False) -> dict:
    """ROADMAP A12 items 1b and 2 on the card (phase 19): the RG-LRU hybrid
    and the encoder-decoder on the model axis, ranks sharing the card over
    gloo (``--tp-worker`` scenarios ``hyb-serve``, ``hyb-quad``,
    ``hyb-whisper``, ``train-hyb-rg`` and ``train-hyb-whisper``), at
    published widths.

    Serving: recurrentgemma-2b at ``TP_HYB_SERVE_LAYERS`` on 1 x 2 (its kv
    head gathered, 5 query heads per rank) on the families' stream (12
    greedy requests of 24 tokens, 8 slots, eager), and at
    ``TP_HYB_QUAD_LAYERS`` on 1 x 4 (10 query heads padded to 12) on 4
    requests of 8 tokens: the ranks' tokens bitwise equal, the share equal
    to a 1-rank engine's at the same depth (CUDA graphs; printed, C18), per
    step the counted collectives and launches (:func:`_hyb_per_step`),
    weights per rank. whisper-base whole on 1 x 2 (its embedding and tied
    head whole), 8 lanes x ``TP_HYB_WHISPER_STEPS`` tokens in lock-step:
    the ranks' tokens and last logits bitwise equal, the last logits within
    0.05 of the largest |logit| of one process teacher-forced on the same
    tokens (the whisper phase's bound), the token share against one
    process's greedy run printed, 3 collectives per decoder layer per step
    and none at the whole embedding or logits. Training: recurrentgemma-2b
    at ``TP_HYB_TRAIN_LAYERS`` through the launcher (``bf16_sr_kahan
    --fused-update``, 1 x 512, lr 1e-4) and whisper-base on the whisper
    phase's batch (``make_train_step(mesh=)``), 3 steps each beside one
    process: ranks bitwise on the losses and every replicated or whole
    leaf, losses within ``TP_TRAIN_LOSS_BAR`` of one process's, a shard's
    ``fused_adamw`` == its plain version with the folded seed, the weights
    and state of the leaves the specs shard at most ``TP_TRAIN_BYTES_BAR``
    of one process's bytes of them per rank (whole leaves, whisper's
    embedding, count in full), one ``fused_adamw`` launch per local leaf
    per step. Prints ms per step,
    collectives (counted and predicted), their ms and host-copy ms, peak
    GiB per rank. ``run`` is :func:`hyb_runs`'s. Returns the runs'
    launches (serving: rank 0's; ``fused_adamw``: every rank's)."""
    import shutil
    import numpy as np
    from repro_torch.models import registry as R
    shutil.rmtree(run["root"], ignore_errors=True)
    (serve, serve_wall), (quad, quad_wall) = run["hyb-serve"], run["hyb-quad"]
    trains = {"recurrentgemma-2b": run["train-hyb-rg"],
              "whisper-base": run["train-hyb-whisper"]}
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def ms_of(seconds, steps):
        return 1e3 * seconds / max(steps, 1)

    for ranks, mp in ((serve, 2), (quad, 4)):
        tag = f"recurrentgemma-2b 1 x {mp}"
        r0 = ranks[0]["recurrentgemma-2b"]
        check(all(r["recurrentgemma-2b"]["tokens"] == r0["tokens"] for r in ranks),
              f"[tp-hybrid] {tag}: the ranks' tokens differ")
        n_req = TP_HYB_QUAD_REQUESTS if mp == 4 else 12
        check(r0["finished"] == n_req and r0["graphs"] == 0,
              f"[tp-hybrid] {tag}: finished {r0['finished']}/{n_req}, graphs {r0['graphs']}")
        cfg = R.get_config("recurrentgemma-2b")
        cfg = cfg.reduced() if rehearsal else dataclasses.replace(cfg, n_layers=r0["n_layers"])
        coll, per_kernel = _hyb_per_step(cfg, mp)
        check(r0["collectives"] == coll * r0["steps"],
              f"[tp-hybrid] {tag}: {r0['collectives']} collectives in {r0['steps']} steps, "
              f"expected {coll} per step")
        per = {k: n / r0["steps"] for k, n in r0["launches"].items() if n}
        check(rehearsal or per == per_kernel,
              f"[tp-hybrid] {tag}: launches per step {per}, expected {per_kernel}")
        add(r0["launches"])
        one = r0["one_tokens"]
        same = sum(int(np.sum(np.asarray(r0["tokens"][rid]) == np.asarray(t)))
                   for rid, t in one.items())
        total = sum(len(t) for t in one.values())
        firsts = sum(r0["tokens"][rid][0] == t[0] for rid, t in one.items())
        w1, w2 = r0["weights"]
        print(f"[tp-hybrid] serve {tag} on {card}: {r0['n_layers']} layers over gloo, "
              f"{r0['steps']} eager steps in {r0['seconds']:.2f}s -> "
              f"{ms_of(r0['seconds'], r0['steps']):.2f} ms per step; collectives {coll} per "
              f"step (counted {r0['collectives'] / r0['steps']:.0f}) taking "
              f"{ms_of(r0['collective_s'], r0['steps']):.2f} ms, of which host copies "
              f"{ms_of(r0['host_copy_s'], r0['steps']):.2f} ms; launches per step {per}; "
              f"weights {w2 / 2**30:.3f} GiB per rank ({w2 / w1:.4f} of one rank's "
              f"{w1 / 2**30:.3f}), KV and state {r0['kv'] / 2**20:.1f} MiB; peak "
              f"{max(r['recurrentgemma-2b']['peak_gib'] for r in ranks):.2f} GiB per rank; "
              f"ranks bitwise; tokens equal to the 1-rank engine's (graphs): {same}/{total}, "
              f"first tokens {firsts}/{len(one)} (C18)")
    (wserve, wserve_wall) = run["hyb-whisper"]
    w0, w1 = wserve[0]["whisper-base"], wserve[1]["whisper-base"]
    check(w0["fed"] == w1["fed"] and w0["last_digest"] == w1["last_digest"],
          "[tp-hybrid] whisper 1 x 2: the ranks' tokens or last logits differ")
    cfg = R.get_config("whisper-base")
    if rehearsal:
        cfg = cfg.reduced()
    n = TP_HYB_WHISPER_STEPS
    rel = w0["logits_err"] / w0["logits_scale"]
    check(rel < 0.05, f"[tp-hybrid] whisper 1 x 2: last logits {rel:.3e} of the largest "
          "|logit| from one process's on the same tokens (bound 0.05)")
    per_step = 3 * cfg.n_layers + (0 if cfg.vocab % 2 else 2)
    enc = 2 * cfg.n_enc_layers
    check(w0["collectives"] == enc + per_step * n,
          f"[tp-hybrid] whisper 1 x 2: {w0['collectives']} collectives, expected {enc} to "
          f"encode and {per_step} per step")
    want = {"decode_attention": 2 * cfg.n_layers, "qmatmul": 6 * cfg.n_layers,
            "qmatmul_f32": 3 * cfg.n_layers}
    per = {k: v / n for k, v in w0["launches"].items() if v}
    check(rehearsal or per == want,
          f"[tp-hybrid] whisper 1 x 2: launches per step {per}, expected {want}")
    add(w0["launches"])
    fed, one_fed = np.asarray(w0["fed"]), np.asarray(w0["one_fed"])
    same = int((fed[:, WHISPER_PROMPT:] == one_fed[:, WHISPER_PROMPT:]).sum())
    total = fed[:, WHISPER_PROMPT:].size
    step_ms = 1e3 * float(np.mean(w0["step_s"][1:]))
    print(f"[tp-hybrid] serve whisper-base 1 x 2 on {card}: {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, vocab {cfg.vocab} "
          f"{'whole on every rank' if cfg.vocab % 2 else 'vocab-parallel'}; {B} lanes encoded "
          f"in {w0['enc_s']:.3f}s, {n} lock-step steps at {step_ms:.2f} ms per step after the "
          f"first; collectives {per_step} per step (+ {enc} to encode), "
          f"{1e3 * w0['collective_s'] / n:.2f} ms per step, of which host copies "
          f"{1e3 * w0['host_copy_s'] / n:.2f} ms; launches per step {per}; weights "
          f"{w0['weights'][1] / 2**20:.1f} MiB per rank ({w0['weights'][1] / w0['weights'][0]:.4f} "
          f"of one process's); last logits {rel:.3e} of scale from one process's on the same "
          f"tokens (bound 0.05); ranks bitwise; greedy tokens equal to one process's: "
          f"{same}/{total} (C18); peak {w0['peak_gib']:.2f} GiB per rank")
    for name, (train, _) in trains.items():
        t0, t1 = train[0][name], train[1][name]
        a0, a1 = t0["a"], t1["a"]
        check(a0["losses"] == a1["losses"], f"[tp-hybrid] train {name}: the ranks' losses "
              f"differ: {a0['losses']} {a1['losses']}")
        n_rep = 0
        for i, rep in enumerate(a0["replicated"]):
            if rep:
                n_rep += 1
                check(a0["digests"][i] == a1["digests"][i],
                      f"[tp-hybrid] train {name}: replicated state leaf {i} differs between "
                      "the ranks")
        one = t0["one"]["losses"]
        gap = max(abs(x - y) for x, y in zip(a0["losses"], one))
        check(len(one) == len(a0["losses"]) == TP_HYB_TRAIN_STEPS
              and gap <= TP_TRAIN_LOSS_BAR,
              f"[tp-hybrid] train {name}: losses {a0['losses']} against one process's {one} "
              f"(bar {TP_TRAIN_LOSS_BAR})")
        for res in (t0, t1):
            check(res["a"]["plain_check"]["equal"],
                  f"[tp-hybrid] train {name}: the {res['a']['plain_check']['leaf']} shard's "
                  "fused_adamw != its plain version with the folded seed")
            k = res["a"]["n_leaves"] * TP_HYB_TRAIN_STEPS
            check(rehearsal or res["a"]["launches"]["fused_adamw"] == k,
                  f"[tp-hybrid] train {name}: launches {res['a']['launches']} for {k} leaf "
                  "steps")
            add({"fused_adamw": res["a"]["launches"]["fused_adamw"]})
        # the leaves the specs shard at most the bar's share of one
        # process's bytes of them; whole leaves (whisper's 51865-row
        # embedding: 36% of its parameters) count in full
        whole = a0["whole_bytes"]
        ratio = max(a0["bytes"], a1["bytes"]) / t0["one"]["bytes"]
        sharded = (max(a0["bytes"], a1["bytes"]) - whole) / (t0["one"]["bytes"] - whole)
        check(sharded <= TP_TRAIN_BYTES_BAR, f"[tp-hybrid] train {name}: the sharded "
              f"leaves' bytes per rank {sharded:.4f} of one process's (bar "
              f"{TP_TRAIN_BYTES_BAR}; {whole} bytes of whole leaves)")
        ms = [1e3 * sum(r["a"]["step_s"][1:]) / max(len(r["a"]["step_s"]) - 1, 1)
              for r in (t0, t1)]
        one_ms = 1e3 * sum(t0["one"]["step_s"][1:]) / max(len(t0["one"]["step_s"]) - 1, 1)
        print(f"[tp-hybrid] train {name} 1 x 2 on {card}: {t0.get('n_layers', 'all')} layers, "
              f"bf16_sr_kahan fused: losses {[round(x, 4) for x in a0['losses']]} (1 process "
              f"{[round(x, 4) for x in one]}, within {gap:.2e}, bar {TP_TRAIN_LOSS_BAR}); "
              f"ranks bitwise on {n_rep} replicated or whole leaves and the losses; the "
              f"{a0['plain_check']['leaf']} shard's fused_adamw == plain (folded seed); steps "
              f"1-{TP_HYB_TRAIN_STEPS - 1} {ms[0]:.2f} ms per step (rank 1 {ms[1]:.2f}; 1 "
              f"process {one_ms:.2f}); model-axis collectives {a0['collectives']:.0f} per "
              f"step taking {1e3 * a0['collective_s']:.2f} ms, of which host copies "
              f"{1e3 * a0['host_copy_s']:.2f} ms; weights and state "
              f"{a0['bytes'] / 2**30:.3f} GiB per rank, {ratio:.4f} of one process's "
              f"{t0['one']['bytes'] / 2**30:.3f} (its sharded leaves {sharded:.4f}, bar "
              f"{TP_TRAIN_BYTES_BAR}; whole leaves {whole / 2**30:.3f} GiB); peak "
              f"{a0['peak_gib']:.2f} GiB per rank (1 process {t0['one']['peak_gib']:.2f}); "
              f"launches {a0['launches']}")
    print(f"[tp-hybrid] launch walls, side by side: training recurrentgemma "
          f"{trains['recurrentgemma-2b'][1]:.1f}s and whisper {trains['whisper-base'][1]:.1f}s, "
          f"1 x 2 serving recurrentgemma {serve_wall:.1f}s and whisper {wserve_wall:.1f}s, "
          f"1 x 4 serving {quad_wall:.1f}s")
    return launches


# ROADMAP A12 item 3 (the dp-paged part): a paged pool whose page rows shard
# over the data ranks, its rows moved by the page exchange (dist/pages.py).
# tp (b)'s paged stream and pool (TP_PAGED_*) at TP_LAYERS, on 2 x 1 and on
# 2 x 2; its two launches run beside phase 19's
DP_PAGED = {"dp-paged": (2, 1), "dp-paged-quad": (2, 2)}   # scenario: (data, model)
DP_LAUNCHES = tuple((name, data * model) for name, (data, model) in DP_PAGED.items())


def _dp_paged_plans(eng) -> dict:
    """Watch ``eng``'s page exchange: the count of its single-token steps,
    and the single-token step whose working buffer was largest (this
    rank's remapped tables, their rows and its lanes' query positions),
    the shapes the paged kernel ran at there."""
    seen = {"single": 0, "largest": None}
    plan = eng.pages.plan

    def watch(table, page_reset, copies, positions, **kw):
        got = plan(table, page_reset, copies, positions, **kw)
        if positions.shape[1] == 1:
            seen["single"] += 1
            if seen["largest"] is None or len(got.work) + 1 > seen["largest"]["rows"]:
                lo, hi = eng.pool.slots
                seen["largest"] = {"rows": len(got.work) + 1, "table": got.table.tolist(),
                                   "q_pos": positions[lo:hi, 0].tolist()}
        return got
    eng.pages.plan = watch
    return seen


def _dp_paged_digests(pool, rows: range) -> dict:
    """Digests of rows ``rows`` of every paged leaf of ``pool``."""
    from repro_torch.dist import pages as PG
    return {f"{root}.{name}.{k}": digest(t.narrow(pdim, rows.start, len(rows)))
            for root, name, leaf, pdim in PG.paged_leaves(pool.cache) for k, t in leaf.items()}


def dp_paged_worker(spec: dict) -> dict:
    """One rank of the dp-paged part (``--tp-worker`` scenario ``dp-paged``:
    2 x 1, or ``dp-paged-quad``: 2 x 2): full-width qwen2.5-3b at
    ``TP_LAYERS``, tp (b)'s stream and pool at chunk 1 and ``CHUNK``, eager
    steps with the page exchange; on 2 x 1 rank 0 then serves both in one
    process (CUDA graphs). Returns tokens, stats, launches, the exchange's
    and the token gather's counts and times, pool bytes, digests of the
    rank's owned rows and the shapes of its largest single-token step."""
    import torch
    from repro_torch.dist import multihost as MH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve_stream
    from repro_torch.serve.engine import Engine
    dev = spec["device"]
    rank = MH.process_index()
    data, model = DP_PAGED[spec["scenario"]]
    mesh = make_local_mesh(data, model)
    params, cfg, policy = _tp_model(spec, TP_LAYERS)
    whole = params if model == 1 and rank == 0 else None
    local = _tp_shard(params, cfg, mesh, dev)
    del params
    stream = paged_stream(cfg.vocab)[:TP_PAGED_REQUESTS]
    kw = dict(n_slots=8, max_len=TP_PAGED_MAX_LEN, fused_decode=True, device=dev, paged=True,
              page_size=PAGE, n_pages=TP_PAGED_PAGES)
    out = {"coords": mesh.coords(rank), "n_layers": cfg.n_layers, "kv_heads": None}
    for chunk in (1, CHUNK):
        eng = Engine(local, cfg, policy, mesh=mesh, prefill_chunk=chunk, **kw)
        plans = _dp_paged_plans(eng)
        _tp_sync(dev)
        mods = _tp_counts()
        res = serve_stream(eng, stream)
        _tp_sync(dev)
        eng.pool.check_invariants()
        ex, tg, pool, st = eng.pages.stats, eng.token_gather, eng.pool, eng.stats
        lo, hi = pool.rows
        out["kv_heads"] = pool.cache["layers"]["b0"]["k_pages"].shape[-2]
        out[str(chunk)] = dict(
            tokens=_tp_tokens(res), steps=res.calls, seconds=res.seconds, finished=st.finished,
            stats=[st.steps, st.preemptions, st.prefix_hits, st.prefix_tokens_reused],
            launches=_tp_read(mods), graphs=len(eng.graphs), single_steps=plans["single"],
            largest=plans["largest"],
            exchange=dict(calls=ex.calls, planned_calls=ex.planned_calls, bytes=ex.bytes,
                          planned_bytes=ex.planned_bytes, seconds=ex.seconds,
                          host_copy_s=ex.host_copy_s, steps=ex.steps, rows_sent=ex.rows_sent,
                          cells_sent=ex.cells_sent, work_peak_bytes=ex.work_peak_bytes),
            token_gather=dict(calls=tg.calls, seconds=tg.seconds),
            pool_bytes=pool.nbytes(), page_bytes=pool.page_nbytes(), n_rows=pool.n_rows,
            rows=[lo, hi], digests=_dp_paged_digests(pool, range(0, min(hi, pool.n_pages) - lo)))
        del eng
    if whole is not None:
        # the one-process engine on the same stream, pool and chunk; its rows
        # digested by the data ranks' shares of the mesh's (padded) row count
        per = out["1"]["rows"][1] - out["1"]["rows"][0]
        for chunk in (1, CHUNK):
            one = Engine(whole, cfg, policy, prefill_chunk=chunk, **kw)
            res = serve_stream(one, stream)
            st = one.stats
            out[f"one_{chunk}"] = dict(
                tokens=_tp_tokens(res), seconds=res.seconds, graphs=len(one.graphs),
                stats=[st.steps, st.preemptions, st.prefix_hits, st.prefix_tokens_reused],
                page_bytes=one.pool.page_nbytes(), n_rows=one.pool.n_rows,
                digests=[_dp_paged_digests(one.pool, range(d * per, min((d + 1) * per,
                                                                        one.pool.n_pages)))
                         for d in range(data)])
            del one
    _tp_sync(dev)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else 0.0
    return out


def _dp_kernel_inputs(largest: dict, hkv: int, seed: int) -> dict:
    """The paged kernel's inputs at a dp-paged step's shapes: this rank's
    lanes (their query positions), its working buffer's rows and its
    remapped tables, ``hkv`` kv heads of ``D`` at G = HQ / HKV; K/V random,
    each mapped cell's position its logical one up to its lane's depth."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    table = torch.tensor(largest["table"], dtype=torch.int32)
    q_pos = torch.tensor(largest["q_pos"], dtype=torch.int32)
    lanes, rows = table.shape[0], largest["rows"]
    hq = hkv * (HQ // HKV)
    q = torch.randn((lanes, 1, hq, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((rows, PAGE, hkv, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((rows, PAGE, hkv, D), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((rows, PAGE), -1, dtype=torch.int32)
    cells = torch.arange(PAGE, dtype=torch.int32)
    for lane in range(lanes):
        for blk, r in enumerate(table[lane].tolist()):
            if r != rows - 1 and q_pos[lane] >= 0:
                logical = blk * PAGE + cells
                pos[r] = torch.where(logical <= q_pos[lane], logical, pos[r])
    return dict(q=q, k=k, v=v, pos=pos.to(dev), table=table.to(dev), q_pos=q_pos.to(dev),
                window=None, softcap=None)


def phase_kernel_dp_paged(card: str, shapes: dict) -> tuple[float, dict]:
    """The paged kernel at the dp-paged part's shapes (``shapes``: mesh
    name → its rank 0's largest single-token step at chunk 1), against
    ``decode_attention_ref`` on the gathered view at ATOL/RTOL and REL_RMS of
    a lane's RMS; its time beside its bound, the plain version's and SDPA's
    on the pre-gathered view. Returns the largest error and the times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    max_err, times = 0.0, {}
    for name, (largest, hkv) in shapes.items():
        x = _dp_kernel_inputs(largest, hkv, 30)

        def view(t, c):
            return DA._gather_view(t, c["table"]).contiguous()

        def kernel(c):
            return DA.fused_paged_decode_attention(c["q"], c["k"], c["v"], c["pos"], c["table"],
                                                   c["q_pos"], p_dtype=torch.bfloat16)

        def plain(c):
            return DA.decode_attention_ref(c["q"], view(c["k"], c), view(c["v"], c),
                                           view(c["pos"], c), c["q_pos"], p_dtype=torch.bfloat16)
        got, want = kernel(x), plain(x)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"[kernel-dp-paged] {name}: non-finite output")
        err = float((got - want).abs().max())
        ratio = rms_ratio(got, want, x["q_pos"])
        check(torch.allclose(got, want, atol=ATOL, rtol=RTOL) and ratio <= REL_RMS,
              f"[kernel-dp-paged] {name}: kernel vs plain max |err| {err}, {ratio} of a "
              f"lane's RMS")
        max_err = max(max_err, err)
        kv_bytes = 2 * x["k"].numel() * x["k"].element_size()
        copies = [x] + [{n: t.clone() if hasattr(t, "clone") else t for n, t in x.items()}
                        for _ in range(min(-(-64 * 2**20 // kv_bytes) - 1, 255))]
        ms = time_ms([lambda c=c: kernel(c) for c in copies])
        plain_ms = time_ms([lambda c=c: plain(c) for c in copies])

        def sdpa(c):
            kv = view(c["pos"], c)
            allowed = ((kv >= 0) & (kv <= c["q_pos"][:, None]))[:, None, None, :]
            qt = c["q"].transpose(1, 2)
            kt, vt = view(c["k"], c).transpose(1, 2), view(c["v"], c).transpose(1, 2)
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                          enable_gqa=True)
        library_ms = time_ms([sdpa(c) for c in copies])
        bound_ms, bound_by = _paged_bound_ms(x)
        lanes = len(largest["table"])
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, err=err)
        print(f"[kernel-dp-paged] {name} on {card}: {lanes} lanes (query positions "
              f"{largest['q_pos']}), a working buffer of {largest['rows']} rows of {PAGE}, "
              f"tables of {len(largest['table'][0])} blocks, {hkv} kv heads of {D}, G = "
              f"{HQ // HKV}: max |kernel - plain| {err:.3e} (atol=rtol={ATOL}), {ratio:.3e} of "
              f"a lane's RMS (<= {REL_RMS}); kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, scaled_dot_product_attention on the "
              f"pre-gathered view {library_ms:.4f} ms ({len(copies)} input copies rotated)")
        del copies, x
    return max_err, times


def phase_dp_paged(card: str, run: dict, tp_b: dict, *, rehearsal: bool = False) -> dict:
    """ROADMAP A12 item 3 on the card: ``Engine(paged=True, mesh=)`` on a
    data axis of 2 ranks sharing the card over gloo, the page rows sharded
    over them and moved by the page exchange; ``run`` holds the ``dp-paged``
    (2 x 1) and ``dp-paged-quad`` (2 x 2) launches, ``tp_b`` the tp phase's
    (b) results (1 x 2 paged at the same layers). Checks, at chunk 1 and
    ``CHUNK``: every rank finishes every request with the same tokens; chunk
    ``CHUNK`` == chunk 1; 2 x 1 == the one-process engine bitwise (tokens,
    steps, preemptions, prefix hits, prefix tokens skipped, and each rank's
    owned rows of every paged leaf by digest); 2 x 2 == tp (b)'s tokens; each
    rank's page leaves 1/D of the pool's padded rows (on 2 x 1: of the
    one-process engine's bytes scaled to the padded row count); one paged
    launch per layer per step, eager; the exchange's collectives and bytes
    equal its plans'. Then the paged kernel at the part's own shapes
    (:func:`phase_kernel_dp_paged`). Prints the part's walls and per mesh
    ms per eager step, the exchange's and token gather's collectives per step
    and their ms and host-copy ms, exchange bytes per step, pool MiB and
    peak GiB per rank. Returns rank 0's launches of both launches and the
    kernel check's largest error (0 in a rehearsal)."""
    import shutil
    shutil.rmtree(run["root"], ignore_errors=True)
    launches, shapes = {}, {}
    for name, (data, model) in DP_PAGED.items():
        ranks, wall = run[name]
        r0 = ranks[0]
        tag = f"[dp-paged] {data} x {model}"
        n_layers = r0["n_layers"]
        for chunk in ("1", str(CHUNK)):
            for r in ranks:
                got = r[chunk]
                check(got["finished"] == TP_PAGED_REQUESTS and got["graphs"] == 0,
                      f"{tag} chunk {chunk} rank {r['rank']}: finished {got['finished']}, "
                      f"graphs {got['graphs']}")
                check(got["tokens"] == r0[chunk]["tokens"] and got["stats"] == r0[chunk]["stats"],
                      f"{tag} chunk {chunk}: rank {r['rank']}'s tokens or stats != rank 0's")
                ex = got["exchange"]
                check(ex["calls"] == ex["planned_calls"] and ex["bytes"] == ex["planned_bytes"],
                      f"{tag} chunk {chunk} rank {r['rank']}: exchange {ex['calls']} calls, "
                      f"{ex['bytes']} bytes; planned {ex['planned_calls']}, "
                      f"{ex['planned_bytes']}")
                check(rehearsal or got["launches"]["paged_decode_attention"]
                      == n_layers * got["steps"],
                      f"{tag} chunk {chunk} rank {r['rank']}: paged launches "
                      f"{got['launches']} for {got['steps']} steps of {n_layers} layers")
                rows = got["rows"][1] - got["rows"][0]
                want = n_layers * rows * PAGE * (2 * r["kv_heads"] * D * 2 + 4)
                check(rows * data == got["n_rows"] and (rehearsal or got["page_bytes"] == want),
                      f"{tag} rank {r['rank']}: {rows} of {got['n_rows']} rows, page leaves "
                      f"{got['page_bytes']} bytes (want {want})")
            check(r0[chunk]["tokens"] == r0["1"]["tokens"],
                  f"{tag}: chunk {chunk} tokens != chunk 1's")
            check(chunk != "1" or (r0[chunk]["stats"][1] >= 1 and r0[chunk]["stats"][2] >= 1),
                  f"{tag} chunk 1: stats {r0[chunk]['stats']} (no preemption or prefix hit)")
            if model == 1:
                one = r0[f"one_{chunk}"]
                check(one["tokens"] == r0[chunk]["tokens"] and one["stats"] == r0[chunk]["stats"],
                      f"{tag} chunk {chunk}: tokens or stats {r0[chunk]['stats']} != the "
                      f"one-process engine's {one['stats']}")
                for r in ranks:
                    d = r["coords"]["data"]
                    check(r[chunk]["digests"] == one["digests"][d],
                          f"{tag} chunk {chunk}: data rank {d}'s owned rows != the one-process "
                          f"pool's rows")
                check(r0[chunk]["page_bytes"] * data * one["n_rows"]
                      == one["page_bytes"] * r0[chunk]["n_rows"],
                      f"{tag}: page leaves {r0[chunk]['page_bytes']} bytes per rank vs one "
                      f"process's {one['page_bytes']} at {one['n_rows']} rows")
            else:
                want = tp_b[chunk]["tokens"]
                check(r0[chunk]["tokens"] == want,
                      f"{tag} chunk {chunk}: tokens != the 1 x 2 paged run's (tp (b))")
        for k, n in r0["1"]["launches"].items():
            launches[k] = launches.get(k, 0) + n + r0[str(CHUNK)]["launches"][k]
        shapes[f"{data} x {model}"] = (r0["1"]["largest"], r0["kv_heads"])
        for chunk in ("1", str(CHUNK)):
            got, steps = r0[chunk], r0[chunk]["steps"]
            ex, tg = got["exchange"], got["token_gather"]
            peaks = [r["peak_gib"] for r in ranks]
            versus = ("== the one-process engine (bitwise: tokens, stats, owned rows)"
                      if model == 1 else "== tp (b)'s 1 x 2 tokens")
            print(f"{tag} on {card}: qwen2.5-3b {n_layers} layers, {TP_PAGED_REQUESTS} "
                  f"requests, {TP_PAGED_PAGES} pages of {PAGE}, chunk {chunk}: {steps} eager "
                  f"steps ({got['single_steps']} single-token) in {got['seconds']:.2f}s -> "
                  f"{1e3 * got['seconds'] / steps:.2f} ms per step; steps, preemptions, "
                  f"prefix hits, tokens skipped {got['stats']}; page exchange "
                  f"{ex['calls'] / steps:.2f} collectives per step ({ex['calls']} = planned) "
                  f"taking {1e3 * ex['seconds'] / steps:.2f} ms per step, host copies "
                  f"{1e3 * ex['host_copy_s'] / steps:.2f} ms; {ex['bytes'] / steps:.0f} bytes "
                  f"per step handed ({ex['rows_sent']} rows, {ex['cells_sent']} cells; = "
                  f"planned); token gather {tg['calls'] / steps:.2f} per step, "
                  f"{1e3 * tg['seconds'] / steps:.2f} ms; pool {got['pool_bytes'] / 2**20:.2f} "
                  f"MiB per rank (page leaves {got['page_bytes']} bytes, rows "
                  f"{got['rows'][0]}..{got['rows'][1] - 1} of {got['n_rows']}), working buffers "
                  f"peak {ex['work_peak_bytes'] / 2**20:.3f} MiB; paged launches "
                  f"{got['launches']['paged_decode_attention']} = {n_layers} x {steps}; peak "
                  f"{max(peaks):.2f} GiB per rank; tokens {versus}"
                  + (f" (one process, graphs: {r0[f'one_{chunk}']['seconds']:.2f}s)"
                     if model == 1 else ""))
        print(f"{tag}: launch wall {wall:.1f}s (beside phase 19's launches)")
    max_err = 0.0
    if not rehearsal:
        max_err, times = phase_kernel_dp_paged(card, shapes)
    return {"launches": launches, "max_abs_err": max_err}


def phase_qmatmul_f32(card: str) -> dict:
    """(d) The f32-result entry of ``qmatmul``: rounded to bf16 it is the
    bf16 entry bit for bit on both paths, its rows do not depend on the
    row count, it lies within the f32 accumulation bound of its plain
    version; its time beside its bound, the plain version's and
    ``torch.mm(..., out_dtype=torch.float32)``'s."""
    import torch
    QM = kernel_module("qmatmul")
    row, max_err = None, 0.0
    for i, (name, (M, N, K)) in enumerate(QMATMUL_F32_SHAPES.items()):
        g = _gen(300 + i)
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        y = torch.randn((K, N), generator=g, device="cuda").to(torch.bfloat16)
        f32 = QM.qmatmul_f32(x, y)
        check(f32.dtype == torch.float32 and f32.shape == (M, N), f"{name}: f32 entry output")
        check(_equal(f32.to(torch.bfloat16), QM.qmatmul(x, y)),
              f"{name}: the f32 entry rounded != the bf16 entry")
        sync = QM._launch(x, y, None, entry="repro_qmatmul_f32_sync")
        check(_equal(sync.to(torch.bfloat16), QM._launch(x, y, None,
                                                         entry="repro_qmatmul_sync")),
              f"{name}: the mma.sync f32 entry rounded != the mma.sync bf16 entry")
        plain = QM.qmatmul_ref(x, y, out_dtype=torch.float32)
        e = _accumulation_bound(x, y)
        used = float(((f32.double() - plain.double()).abs() / e.clamp_min(1e-30)).max())
        check(used <= 1.0, f"{name}: the f32 entry lies {used:.3f}x the f32 accumulation "
              "bound from its plain version")
        err = float((f32 - plain).abs().max())
        max_err = max(max_err, err)
        big = x if M >= 4096 else torch.randn((4096, K), generator=g,
                                              device="cuda").to(torch.bfloat16)
        full = QM.qmatmul_f32(big, y)
        for m in QMATMUL_ROWS[:-1]:
            check(torch.equal(QM.qmatmul_f32(big[:m], y), full[:m]),
                  f"{name}: f32 rows at M={m} != rows at M=4096")
        del big, full, e, plain, sync
        n_in = (M * K + K * N) * 2 + M * N * 4
        copies = [(x, y)] + [(x.clone(), y.clone())
                             for _ in range(-(-100 * 2**20 // n_in) - 1)]
        ms = time_ms([lambda c=c: QM.qmatmul_f32(c[0], c[1]) for c in copies])
        bf16_ms = time_ms([lambda c=c: QM.qmatmul(c[0], c[1]) for c in copies])
        library_ms = time_ms([lambda c=c: torch.mm(c[0], c[1], out_dtype=torch.float32)
                              for c in copies])
        plain_ms = time_ms([lambda c=c: QM.qmatmul_ref(c[0], c[1], out_dtype=torch.float32)
                            for c in copies], calls=16)
        flop = 2 * M * N * K
        t_bytes = ((M * K + K * N) * 2 + M * N * 4) / HBM_BYTES_PER_S
        t_ops = flop / BF16_FLOP_PER_S
        bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                                          else "operations")
        print(f"[qmatmul_f32] {name} ({M}x{K} @ {K}x{N}) on {card}: {QM.plan(x, y).path}; "
              f"rounded == the bf16 entry on both paths (torch.equal), rows bitwise at M in "
              f"{QMATMUL_ROWS}, within {used:.3f} of the f32 accumulation bound of the plain "
              f"version (max |diff| {err:.3e}); kernel {ms:.4f} ms (bound {bound_ms:.4f} ms, "
              f"{bound_by}; {bound_ms / ms:.1%} of it), the bf16 entry {bf16_ms:.4f} ms, "
              f"torch.mm(out_dtype=float32) {library_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(device time, {len(copies)} input copies rotated)")
        if name == QMATMUL_F32_ROW:
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
        del copies
    torch.cuda.empty_cache()
    row["max_abs_err"] = max_err
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    # fewer, larger cached blocks: the phases allocate at very different sizes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script checks the port on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")
    t0 = time.perf_counter()
    card = phase_card()

    def stamp(phase: str):
        print(f"[smoke] {phase} starts at {time.perf_counter() - t0:.1f}s", flush=True)
    phase_build()
    rows = {"decode_attention": phase_kernel(card),
            "paged_decode_attention": phase_kernel_paged(card)}
    g10_err = phase_kernel_g10(card)
    for name in ("decode_attention", "paged_decode_attention"):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], g10_err)
    rows["decode_attention"]["max_abs_err"] = max(rows["decode_attention"]["max_abs_err"],
                                                  phase_kernel_hybrid(card))
    stamp("serve")
    model = serve_model()
    rows["row_mean_sq"] = phase_row_probe(card, *model)
    engines, greedy = {}, {}
    launches, engines["contiguous"], greedy["serve"] = phase_main_path(card, *model)
    launches["paged_decode_attention"], engines["paged"], greedy["serve-paged"] = \
        phase_serve_paged(card, *model)
    sample_fills = phase_sample(card, *model, greedy)
    del greedy
    for tag, eng in engines.items():     # last: the profiler may slow later launches
        phase_profile(eng, model[1], card, tag)
    del model, engines, eng
    torch.cuda.empty_cache()
    stamp("families")
    families = phase_families(card)
    for k in ("decode_attention", "paged_decode_attention", "qmatmul", "row_mean_sq"):
        launches[k] += families[k]
    stamp("slice 11 (whisper, qwen2-vl; the resnet beside the paper sections)")
    rows["decode_attention"]["max_abs_err"] = max(rows["decode_attention"]["max_abs_err"],
                                                  phase_kernel_d64(card))
    slice11 = {}
    for ran in (phase_whisper(card), phase_vlm(card)):
        for k, n in ran.items():
            slice11[k] = slice11.get(k, 0) + n
    for k in ("decode_attention", "paged_decode_attention", "qmatmul", "row_mean_sq"):
        launches[k] += slice11[k]
    stamp("update kernels")
    rows.update(phase_update_kernels(card))
    rows["qmatmul"], op_launches = phase_qmatmul(card)
    rows["qmatmul_f32"] = phase_qmatmul_f32(card)
    phase_update_ops()
    stamp("train")
    run, state, launches["fused_adamw"], train_ref = phase_train(card)
    launches["fused_adamw"] += families["fused_adamw"] + slice11["fused_adamw"]
    state = phase_train_profile(run, state, card)
    phase_f32_products(run.cfg, state.params["embed"]["embedding"], card)
    parity = phase_parity(run, state, card)
    del run, state
    torch.cuda.empty_cache()
    # the paper sections, the tp launches, the ckpt phase and the resnet side
    # by side: host-bound all four, on ~45 GiB of the card together
    stamp("paper, the tp launches beside it")
    tp_run = tp_start()

    def beside():
        stamp("ckpt (beside the paper sections and the tp launches)")
        phase_ckpt(card)
        stamp("resnet (beside the paper sections and the tp launches)")
        for k, n in phase_resnet(card).items():
            slice11[k] = slice11.get(k, 0) + n
    paper = phase_paper(card, beside=beside)
    launches["fused_sgd"] = parity["fused_sgd"] + slice11["fused_sgd"]
    launches["sr_cast"] = parity["sr_cast"] + paper["sr_cast"] + slice11["sr_cast"]
    launches["philox"] = parity["philox"] + sample_fills + paper["philox"] + slice11["philox"]
    stamp("tp checks")
    tp = phase_tp(card, tp_run)
    launches["qmatmul_f32"] = tp.pop("qmatmul_f32")
    for k, n in tp.items():
        launches[k] += n
    for k, n in phase_tp_train(card, tp_run).items():
        launches[k] += n
    stamp("tp-families checks")
    for k, n in phase_tp_families(card, tp_run).items():
        launches[k] += n
    # phase 19 in series: beside the paper window and the tp thread (phase
    # 18's mixtral training, then phase 17's) its launches ran the card out
    # of memory; the dp-paged part's two launches ride beside its five
    stamp("tp-hybrid and dp-paged")
    hyb = hyb_runs(HYB_LAUNCHES + DP_LAUNCHES)
    for k, n in phase_tp_hybrid(card, hyb).items():
        launches[k] += n
    stamp("dp-paged checks")
    dp = phase_dp_paged(card, hyb, tp_run["cut"][0][0]["paged"])
    for k, n in dp["launches"].items():
        launches[k] += n
    rows["paged_decode_attention"]["max_abs_err"] = max(
        rows["paged_decode_attention"]["max_abs_err"], dp["max_abs_err"])
    stamp("dist")
    for k, n in phase_dist(card, *train_ref).items():
        launches[k] += n
    print(f"[smoke] qmatmul launches: {launches['qmatmul']} on the serve main path, "
          f"{op_launches} through the op layer")
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f}s on {card}")
    replaces = {
        "decode_attention": ("decode_attention", "src/repro/kernels/decode_attention.py:42"),
        "paged_decode_attention": ("decode_attention",
                                   "src/repro/kernels/decode_attention.py:102"),
        "sr_cast": ("sr_cast", "src/repro/kernels/sr_cast.py:26"),
        "fused_adamw": ("fused_adamw", "src/repro/kernels/fused_adamw.py:36"),
        "fused_sgd": ("fused_sgd", "src/repro/kernels/fused_sgd.py:18"),
        "qmatmul": ("qmatmul", "src/repro/kernels/qmatmul.py:22"),
        # the f32-result entry of the same kernel: the row-parallel partials
        # whose f32 sum the reference's all-reduce rounds once
        "qmatmul_f32": ("qmatmul", "src/repro/kernels/qmatmul.py:22"),
        # not TPU kernels: the reference's jax.random.bits draw of a leaf's SR
        # bits and its jax.random.gumbel draw of a sampled token, and its
        # jnp.mean under RMSNorm
        "philox": ("philox", "src/repro/optim/fused.py:124; "
                             "src/repro/serve/sampling.py:80"),
        "row_mean_sq": ("row_mean_sq", "src/repro/core/qarith.py:114"),
    }
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{replaces[name][0]}.cu",
        "replaces": replaces[name][1], "launches": launches[name], **rows[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(sys.argv[2])
    else:
        main()
